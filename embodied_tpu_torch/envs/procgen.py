"""ProcGen adapter. A copy of embodied_tpu/envs/procgen.py."""

import numpy as np

from ..utils import Space


class ProcGen:

  def __init__(self, task, size=(96, 96), distribution='hard', seed=None):
    try:
      import procgen  # noqa: F401
      import gym
    except ImportError:
      raise ImportError('The ProcGen env requires procgen and gym')
    kwargs = dict(distribution_mode=distribution)
    if seed is not None:
      kwargs.update(start_level=int(seed), num_levels=0)
    self._env = gym.make(f'procgen:procgen-{task}-v0', **kwargs)
    self._size = tuple(size)
    self._done = True

  @property
  def obs_space(self):
    return {
        'image': Space(np.uint8, (*self._size, 3)),
        'reward': Space(np.float32),
        'is_first': Space(bool),
        'is_last': Space(bool),
        'is_terminal': Space(bool),
    }

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
      return self._obs(image, 0.0, is_first=True)
    image, reward, self._done, info = self._env.step(int(action['action']))
    return self._obs(image, reward, is_last=bool(self._done),
                     is_terminal=bool(self._done))

  def _obs(self, image, reward, **flags):
    if image.shape[:2] != self._size:
      from PIL import Image
      image = np.array(
          Image.fromarray(image).resize(self._size, Image.BILINEAR))
    return {
        'image': image,
        'reward': np.float32(reward),
        'is_first': flags.get('is_first', False),
        'is_last': flags.get('is_last', False),
        'is_terminal': flags.get('is_terminal', False),
    }

  def close(self):
    self._env.close()
