"""Synthetic test environment with image/vector/token/count observations.

A copy of embodied_tpu/envs/dummy.py: a deterministic counting env used
by tests and the chip smoke run to check step alignment.
"""

import numpy as np

from ..utils import Space


class Dummy:

  def __init__(self, task='disc', length=100, size=(64, 64), seed=0):
    assert task in ('disc', 'cont', 'bandit'), task
    self._task = task
    self._length = length
    self._size = tuple(size)
    self._random = np.random.default_rng(seed)
    self._step = 0
    self._done = True
    # 'bandit': reward 1 when the agent picks the target action, which is
    # visible in the observation. Trivially learnable; used by learning
    # tests to prove the end-to-end gradient path.
    self._target = 3

  @property
  def obs_space(self):
    return {
        'image': Space(np.uint8, (*self._size, 3)),
        'vector': Space(np.float32, (7,)),
        'token': Space(np.int32, (), 0, 256),
        'count': Space(np.int32, (), 0, self._length + 1),
        'reward': Space(np.float32),
        'is_first': Space(bool),
        'is_last': Space(bool),
        'is_terminal': Space(bool),
    }

  @property
  def act_space(self):
    if self._task in ('disc', 'bandit'):
      action = Space(np.int32, (), 0, 5)
    else:
      action = Space(np.float32, (6,), -1, 1)
    return {'action': action, 'reset': Space(bool)}

  def step(self, action):
    if action['reset'] or self._done:
      self._step = 0
      self._done = False
      return self._obs(0.0, is_first=True)
    self._step += 1
    self._done = self._step >= self._length
    if self._task == 'bandit':
      reward = float(int(action['action']) == self._target)
    else:
      reward = float(self._step % 2)
    return self._obs(reward, is_last=self._done, is_terminal=self._done)

  def _obs(self, reward, is_first=False, is_last=False, is_terminal=False):
    return {
        'image': np.full(
            (*self._size, 3), self._step % 255, np.uint8),
        'vector': np.full((7,), self._step, np.float32),
        'token': np.int32(self._step % 256),
        'count': np.int32(self._step),
        'reward': np.float32(reward),
        'is_first': is_first,
        'is_last': is_last,
        'is_terminal': is_terminal,
    }

  def close(self):
    pass
