from .base import Agent, Env, Stream
from .driver import Driver
from .replay import Replay
from .wrappers import Wrapper
from .clock import LocalClock
from . import chunk
from . import clock
from . import limiters
from . import selectors
from . import streams
from . import wrappers
