"""Foundation utilities the port needs, copied from the JAX package."""

from .space import Space
from .config import Config, Flags
from . import treelib as tree
