from .base import Agent, Env, Stream
from .driver import Driver
from .wrappers import Wrapper
from . import wrappers
