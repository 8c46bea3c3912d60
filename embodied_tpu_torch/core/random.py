"""Agent that samples uniform random actions; used by tests and perf
harnesses.

A copy of embodied_tpu/core/random.py (capability parity with the
reference's embodied/core/random.py)."""

import numpy as np

from . import base


class RandomAgent(base.Agent):

  def __init__(self, obs_space, act_space, config=None):
    self.obs_space = obs_space
    self.act_space = act_space
    self._keys = [k for k in act_space if k != 'reset']

  # No recurrent state: every carry is an empty tuple regardless of role.
  def init_policy(self, batch_size):
    return ()

  init_train = init_policy
  init_report = init_policy

  def policy(self, carry, obs, mode='train'):
    n = len(obs['is_first'])
    acts = {}
    for key in self._keys:
      space = self.act_space[key]
      acts[key] = np.stack([space.sample() for _ in range(n)], 0)
    return carry, acts, {}

  def train(self, carry, data):
    return carry, {}, {}

  def report(self, carry, data):
    return carry, {}

  def stream(self, st):
    return st

  def save(self):
    return None

  def load(self, data=None):
    pass
