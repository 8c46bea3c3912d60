from .agent import Agent
from . import convert
