"""Crafter adapter with achievement logging.

A copy of embodied_tpu/envs/crafter.py: image obs plus per-achievement
'log/' keys that bypass the agent.
"""

import numpy as np

from ..utils import Space


class Crafter:

  def __init__(self, task, size=(64, 64), logs=False, seed=None):
    assert task in ('reward', 'noreward'), task
    try:
      import crafter
    except ImportError:
      raise ImportError('The Crafter env requires the crafter package')
    self._env = crafter.Env(size=size, reward=(task == 'reward'), seed=seed)
    self._logs = logs
    self._size = tuple(size)
    self._done = True
    self._achievements = crafter.constants.achievements.copy()

  @property
  def obs_space(self):
    spaces = {
        'image': Space(np.uint8, (*self._size, 3)),
        'reward': Space(np.float32),
        'is_first': Space(bool),
        'is_last': Space(bool),
        'is_terminal': Space(bool),
        'log/reward': Space(np.float32),
    }
    if self._logs:
      spaces.update({
          f'log/achievement_{k}': Space(np.int32)
          for k in self._achievements})
    return spaces

  @property
  def act_space(self):
    return {
        'action': Space(np.int32, (), 0, self._env.action_space.n),
        'reset': Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._done:
      self._done = False
      image = self._env.reset()
      return self._obs(image, 0.0, {}, is_first=True)
    image, reward, self._done, info = self._env.step(int(action['action']))
    return self._obs(
        image, reward, info,
        is_last=self._done,
        is_terminal=info['discount'] == 0)

  def _obs(self, image, reward, info,
           is_first=False, is_last=False, is_terminal=False):
    obs = {
        'image': image,
        'reward': np.float32(reward),
        'is_first': is_first,
        'is_last': is_last,
        'is_terminal': is_terminal,
        'log/reward': np.float32(0.0 if is_first else reward),
    }
    if self._logs:
      achievements = info.get('achievements', {})
      obs.update({
          f'log/achievement_{k}': np.int32(achievements.get(k, 0))
          for k in self._achievements})
    return obs

  def close(self):
    pass
