"""dm_env adapter. A copy of embodied_tpu/envs/from_dm.py."""

import functools

import numpy as np

from ..utils import Space


class FromDM:

  def __init__(self, env, obs_key='observation', act_key='action'):
    self._env = env
    obs_spec = self._env.observation_spec()
    act_spec = self._env.action_spec()
    self._obs_dict = isinstance(obs_spec, dict)
    self._act_dict = isinstance(act_spec, dict)
    self._obs_key = obs_key
    self._act_key = act_key
    self._done = True

  @functools.cached_property
  def obs_space(self):
    spec = self._env.observation_spec()
    if not self._obs_dict:
      spec = {self._obs_key: spec}
    spaces = {k: self._convert(v) for k, v in spec.items()}
    return {
        **spaces,
        'reward': Space(np.float32),
        'is_first': Space(bool),
        'is_last': Space(bool),
        'is_terminal': Space(bool),
    }

  @functools.cached_property
  def act_space(self):
    spec = self._env.action_spec()
    if not self._act_dict:
      spec = {self._act_key: spec}
    spaces = {k: self._convert(v) for k, v in spec.items()}
    spaces['reset'] = Space(bool)
    return spaces

  def step(self, action):
    if action['reset'] or self._done:
      timestep = self._env.reset()
      self._done = False
      return self._obs(timestep, is_first=True)
    if self._act_dict:
      act = {k: v for k, v in action.items() if k != 'reset'}
    else:
      act = action[self._act_key]
    timestep = self._env.step(act)
    self._done = timestep.last()
    return self._obs(timestep)

  def _obs(self, timestep, is_first=False):
    obs = timestep.observation
    if not self._obs_dict:
      obs = {self._obs_key: obs}
    obs = {k: np.asarray(v) for k, v in obs.items()}
    is_terminal = False if is_first else (
        timestep.last() and timestep.discount == 0)
    obs.update(
        reward=np.float32(0.0 if timestep.reward is None
                          else timestep.reward),
        is_first=is_first,
        is_last=False if is_first else bool(timestep.last()),
        is_terminal=bool(is_terminal))
    return obs

  def close(self):
    try:
      self._env.close()
    except Exception:
      pass

  def _convert(self, spec):
    if hasattr(spec, 'num_values'):
      return Space(np.int32, spec.shape, 0, spec.num_values)
    if hasattr(spec, 'minimum'):
      return Space(spec.dtype, spec.shape, spec.minimum, spec.maximum)
    return Space(spec.dtype, spec.shape)
