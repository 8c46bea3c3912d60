"""DeepMind Control Suite adapter.

A copy of embodied_tpu/envs/dmc.py: dm_control suite and manipulation
tasks, proprioceptive and/or image observations, camera selection with
task-specific defaults.
"""

import functools
import os

import numpy as np

from ..utils import Space
from . import from_dm

CAMERAS = {'quadruped': 2}


class DMC:

  def __init__(
      self, name, size=(64, 64), repeat=1, proprio=True, image=True,
      camera=-1, seed=None):
    assert proprio or image, 'Need at least one of proprio or image obs'
    os.environ.setdefault('MUJOCO_GL', 'egl')
    try:
      from dm_control import suite
      from dm_control import manipulation
    except ImportError:
      raise ImportError('The DMC env requires dm_control')
    domain, task = name.split('_', 1)
    if domain == 'cup':
      domain = 'ball_in_cup'
    if camera == -1:
      camera = CAMERAS.get(domain, 0)
    if name.endswith('_vision'):
      env = manipulation.load(name, seed=seed)
    else:
      env = suite.load(domain, task, task_kwargs={'random': seed})
    self._dmenv = env
    self._env = from_dm.FromDM(env)
    self._size = tuple(size)
    self._repeat = repeat
    self._proprio = proprio
    self._image = image
    self._camera = camera

  @functools.cached_property
  def obs_space(self):
    spaces = dict(self._env.obs_space)
    base = {k: spaces.pop(k) for k in
            ('reward', 'is_first', 'is_last', 'is_terminal')}
    out = {}
    if self._image:
      out['image'] = Space(np.uint8, (*self._size, 3))
    if self._proprio:
      out.update(spaces)
    out.update(base)
    return out

  @property
  def act_space(self):
    return self._env.act_space

  def step(self, action):
    reward = 0.0
    for _ in range(self._repeat if not action['reset'] else 1):
      obs = self._env.step(action)
      reward += obs['reward']
      if obs['is_last'] or action['reset']:
        break
    obs['reward'] = np.float32(reward)
    result = {}
    if self._image:
      result['image'] = self._render()
    if self._proprio:
      result.update({
          k: v for k, v in obs.items()
          if k not in ('reward', 'is_first', 'is_last', 'is_terminal')})
    for key in ('reward', 'is_first', 'is_last', 'is_terminal'):
      result[key] = obs[key]
    return result

  def _render(self):
    return self._dmenv.physics.render(
        *self._size, camera_id=self._camera)

  def close(self):
    self._env.close()
