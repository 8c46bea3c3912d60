"""Env construction by task prefix with the standard wrapper stack: the
part of embodied_tpu/models/common.py that builds envs (`ENV_CTORS`,
`make_env`, `wrap_env`), which models/common.py re-exports.

It imports no torch: a Driver's env processes get `make_env` with the
standard pickle and import this module, so each starts without loading
PyTorch (some seconds of CPU per process, for 16 or 20 processes at
once).
"""

import importlib

from .. import core
from ..utils import Path

ENV_CTORS = {
    'dummy': 'embodied_tpu_torch.envs.dummy:Dummy',
    'gym': 'embodied_tpu_torch.envs.from_gym:FromGym',
    'dm': 'embodied_tpu_torch.envs.from_dm:FromDM',
    'crafter': 'embodied_tpu_torch.envs.crafter:Crafter',
    'dmc': 'embodied_tpu_torch.envs.dmc:DMC',
    'atari': 'embodied_tpu_torch.envs.atari:Atari',
    'atari100k': 'embodied_tpu_torch.envs.atari:Atari',
    'dmlab': 'embodied_tpu_torch.envs.dmlab:DMLab',
    'minecraft': 'embodied_tpu_torch.envs.minecraft:Minecraft',
    'loconav': 'embodied_tpu_torch.envs.loconav:LocoNav',
    'pinpad': 'embodied_tpu_torch.envs.pinpad:PinPad',
    'procgen': 'embodied_tpu_torch.envs.procgen:ProcGen',
    'bsuite': 'embodied_tpu_torch.envs.bsuite:BSuite',
}


def make_env(config, index, **overrides):
  suite, task = config.task.split('_', 1)
  ctor = ENV_CTORS[suite]
  if isinstance(ctor, str):
    module, cls = ctor.split(':')
    module = importlib.import_module(module)
    ctor = getattr(module, cls)
  kwargs = dict(dict(config.env).get(suite, {}))
  kwargs.update(overrides)
  if kwargs.pop('use_seed', False):
    kwargs['seed'] = hash((config.seed, index)) % (2 ** 32 - 1)
  if kwargs.pop('use_logdir', False):
    kwargs['logdir'] = Path(config.logdir) / f'env{index}'
  env = ctor(task, **kwargs)
  return wrap_env(env, config)


def wrap_env(env, config):
  for name, space in env.act_space.items():
    if not space.discrete:
      env = core.wrappers.NormalizeAction(env, name)
  env = core.wrappers.UnifyDtypes(env)
  env = core.wrappers.CheckSpaces(env)
  for name, space in env.act_space.items():
    if not space.discrete:
      env = core.wrappers.ClipAction(env, name)
  return env
