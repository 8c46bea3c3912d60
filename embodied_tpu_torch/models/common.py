"""Entry-point wiring shared by agent packages: config assembly from
configs.yaml presets and CLI flags, env construction by task prefix with
the standard wrapper stack, and the agent's config view.

The acting-path subset of embodied_tpu/models/common.py. Only the Dummy
env is ported so far.
"""

import importlib

import yaml

from .. import core
from ..utils import Config, Flags

ENV_CTORS = {
    'dummy': 'embodied_tpu_torch.envs.dummy:Dummy',
}


def assemble_config(configs_path, argv=None):
  with open(configs_path) as f:
    configs = yaml.safe_load(f)
  parsed, other = Flags(Config(configs=('defaults',))).parse_known(argv)
  config = Config(configs['defaults'])
  for name in parsed.configs:
    config = config.update(configs[name])
  return Flags(config).parse(other)


def agent_config(config):
  return Config(
      agent=dict(config.agent),
      seed=config.seed,
      torch=dict(config.torch),
      batch_size=config.batch_size,
      batch_length=config.batch_length,
      replay_context=config.replay_context,
  )


def env_spaces(config):
  env = make_env(config, 0)
  notlog = lambda k: not k.startswith('log/')
  obs_space = {k: v for k, v in env.obs_space.items() if notlog(k)}
  act_space = {k: v for k, v in env.act_space.items() if k != 'reset'}
  env.close()
  return obs_space, act_space


def make_env(config, index, **overrides):
  suite, task = config.task.split('_', 1)
  if suite not in ENV_CTORS:
    raise NotImplementedError(f'Env suite {suite!r} is not ported yet')
  module, cls = ENV_CTORS[suite].split(':')
  ctor = getattr(importlib.import_module(module), cls)
  kwargs = dict(dict(config.env).get(suite, {}))
  kwargs.update(overrides)
  if kwargs.pop('use_seed', False):
    kwargs['seed'] = hash((config.seed, index)) % (2 ** 32 - 1)
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
