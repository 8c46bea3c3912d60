from .setup import setup
from .meshes import data_group, make_mesh, resolve_rules
from .agent import Agent
from . import convert
