"""Foundation utilities the port needs, copied from the JAX package."""

from .space import Space
from .config import Config, Flags
from .path import Path
from .uuidlib import UUID
from .logger import (
    Logger, TerminalOutput, JSONLOutput, TensorBoardOutput, WandBOutput,
    ScoreOutput, timestamp)
from .metrics import Agg, Counter, FPS, Usage, RWLock
from .checkpoint import Checkpoint
from .printing import print_
from . import timer
from . import when
from . import treelib as tree
