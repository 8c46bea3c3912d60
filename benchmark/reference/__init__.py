"""The benchmark's plain reference of DreamerV3: plain PyTorch in float32.

A frozen copy of the port's plain path (the layers, distributions, heads,
optimizer, normalizers and the DreamerV3 model, RSSM and actor-critic
objectives), taken when the benchmark was written, with every kernel, the
sharded store and the split over ranks left out. It imports nothing of the
program: it judges the program's outputs from the same inputs (weights,
batches and the seed's noise), which the benchmark hands to both sides.

Use:

    model = reference.build(obs_space, act_space, settings, device)
    draws = reference.Draws(reference.call_seed(seed, n, TRAIN_SALT), device)
    carry, outs, metrics = model.train_step(carry, batch, draws)

`settings` is a configuration file's flat `settings` ({'agent.opt.lr':
4e-5, 'batch_size': 16, ...}).
"""

import numpy as np
import torch

from . import nn
from .dreamerv3.model import Model
from .nn import dists
from .space import Space

# The salts the port's Agent folds into each kind of call's seed.
POLICY_SALT = 1_000_003
TRAIN_SALT = 2_000_003


class Config(dict):
  """A nested dict with attribute access, as the model reads its config."""

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    try:
      value = self[name]
    except KeyError:
      raise AttributeError(name)
    return Config(value) if isinstance(value, dict) else value


def nest(flat):
  """{'a.b': 1} -> {'a': {'b': 1}}."""
  out = {}
  for key, value in flat.items():
    node = out
    *parents, last = key.split('.')
    for part in parents:
      node = node.setdefault(part, {})
    node[last] = value
  return out


def model_config(settings):
  """The config view the model reads, from a configuration's settings."""
  tree = nest(settings)
  return Config(
      agent=tree['agent'], batch_size=settings['batch_size'],
      batch_length=settings['batch_length'],
      replay_context=settings['replay_context'],
      report_length=settings['report_length'])


def build(obs_space, act_space, settings, device=None):
  """The reference model in float32 (parameters empty until loaded)."""
  with torch.device(device or 'cpu'):
    return Model(obs_space, act_space, model_config(settings),
                 cdtype=torch.float32)


def call_seed(seed, counter, salt):
  """The seed of one call's generator, from the run's seed, the call's
  counter and the kind's salt (as the port's Agent makes it)."""
  entropy = [int(seed), int(counter), salt]
  state = np.random.SeedSequence(entropy)
  return int(state.generate_state(1, np.uint64)[0] & ((1 << 63) - 1))


def generator(seed, device):
  return torch.Generator(device).manual_seed(seed)


def Draws(seed, device):
  """A call's noise, drawn in call order from a generator seeded `seed`."""
  return dists.Draws(generator(seed, device), device)


__all__ = ['Model', 'Space', 'nn', 'build', 'call_seed', 'Draws',
           'model_config', 'nest', 'generator']
