"""Environment adapters, a copy of embodied_tpu/envs/__init__.py. Dummy and
PinPad are dependency-free; the suite adapters import lazily (PEP 562) so
`from embodied_tpu_torch.envs import Atari` works without paying for (or
requiring) the other suites' dependencies.
"""

from .dummy import Dummy
from .pinpad import PinPad

_LAZY = {
    'FromGym': ('from_gym', 'FromGym'),
    'FromDM': ('from_dm', 'FromDM'),
    'Atari': ('atari', 'Atari'),
    'Crafter': ('crafter', 'Crafter'),
    'DMC': ('dmc', 'DMC'),
    'DMLab': ('dmlab', 'DMLab'),
    'Minecraft': ('minecraft', 'Minecraft'),
    'LocoNav': ('loconav', 'LocoNav'),
    'ProcGen': ('procgen', 'ProcGen'),
    'BSuite': ('bsuite', 'BSuite'),
}


def __getattr__(name):
  try:
    module, attr = _LAZY[name]
  except KeyError:
    raise AttributeError(name) from None
  import importlib
  return getattr(importlib.import_module(f'.{module}', __name__), attr)


def __dir__():
  return sorted([*globals(), *_LAZY])
