"""Gym / Gymnasium adapter.

A copy of embodied_tpu/envs/from_gym.py: dict or flat observation/action
spaces with '/'-joined nested keys, old 4-tuple and new 5-tuple step APIs,
and a space translation table (Discrete, MultiDiscrete, MultiBinary, Box).
"""

import numpy as np

from ..utils import Space


def _load_gym():
  try:
    import gymnasium
    return gymnasium
  except ImportError:
    pass
  try:
    import gym
    return gym
  except ImportError:
    raise ImportError('FromGym requires gymnasium or gym to be installed')


def _flatten(nest):
  """Depth-first flatten of nested dict/space trees with '/'-joined keys."""
  flat = {}
  stack = [('', nest)]
  while stack:
    prefix, node = stack.pop()
    if hasattr(node, 'spaces'):
      node = node.spaces
    if isinstance(node, dict):
      for key, value in node.items():
        stack.append((f'{prefix}/{key}' if prefix else key, value))
    else:
      flat[prefix] = node
  return flat


def _nest(flat):
  """Inverse of _flatten for action dicts."""
  out = {}
  for path, value in flat.items():
    *parents, leaf = path.split('/')
    node = out
    for name in parents:
      node = node.setdefault(name, {})
    node[leaf] = value
  return out


def _to_space(gym_space):
  """Translate a gym space into a framework Space."""
  name = type(gym_space).__name__
  if name == 'Discrete':
    return Space(np.int32, (), 0, int(gym_space.n))
  if name == 'MultiDiscrete':
    nvec = np.asarray(gym_space.nvec)
    return Space(np.int32, nvec.shape, 0, nvec)
  if name == 'MultiBinary':
    return Space(bool, (int(gym_space.n),))
  if hasattr(gym_space, 'n'):  # Discrete-like from other gym versions.
    return Space(np.int32, (), 0, int(gym_space.n))
  return Space(
      gym_space.dtype, gym_space.shape, gym_space.low, gym_space.high)


class FromGym:

  def __init__(self, env, obs_key='image', act_key='action', **kwargs):
    gym = _load_gym()
    self._env = gym.make(env, **kwargs) if isinstance(env, str) else env
    if not isinstance(env, str):
      assert not kwargs, kwargs
    self._obs_nested = hasattr(self._env.observation_space, 'spaces')
    self._act_nested = hasattr(self._env.action_space, 'spaces')
    self._obs_key = obs_key
    self._act_key = act_key
    self._needs_reset = True
    self._info = None
    self._spaces = None

  @property
  def env(self):
    return self._env

  @property
  def info(self):
    return self._info

  @property
  def obs_space(self):
    if self._spaces is None:
      raw = (_flatten(self._env.observation_space) if self._obs_nested
             else {self._obs_key: self._env.observation_space})
      self._spaces = {k: _to_space(v) for k, v in raw.items()}
    return {
        **self._spaces,
        'reward': Space(np.float32),
        'is_first': Space(bool),
        'is_last': Space(bool),
        'is_terminal': Space(bool),
    }

  @property
  def act_space(self):
    raw = (_flatten(self._env.action_space) if self._act_nested
           else {self._act_key: self._env.action_space})
    spaces = {k: _to_space(v) for k, v in raw.items()}
    spaces['reset'] = Space(bool)
    return spaces

  def step(self, action):
    if action['reset'] or self._needs_reset:
      self._needs_reset = False
      result = self._env.reset()
      if isinstance(result, tuple):  # Gymnasium: (obs, info).
        result, self._info = result
      return self._pack(result, 0.0, first=True)
    raw = {k: v for k, v in action.items() if k != 'reset'}
    raw = _nest(raw) if self._act_nested else raw[self._act_key]
    result = self._env.step(raw)
    if len(result) == 5:  # Gymnasium: obs, rew, terminated, truncated, info.
      obs, reward, terminated, truncated, self._info = result
      self._needs_reset = bool(terminated or truncated)
      terminal = bool(terminated)
    else:  # Classic gym: obs, rew, done, info.
      obs, reward, done, self._info = result
      self._needs_reset = bool(done)
      terminal = bool(self._info.get('is_terminal', done))
    return self._pack(
        obs, reward, last=self._needs_reset, terminal=terminal)

  def _pack(self, obs, reward, first=False, last=False, terminal=False):
    if not self._obs_nested:
      obs = {self._obs_key: obs}
    packed = {k: np.asarray(v) for k, v in _flatten(obs).items()}
    packed['reward'] = np.float32(reward)
    packed['is_first'] = first
    packed['is_last'] = last
    packed['is_terminal'] = terminal
    return packed

  def render(self):
    return self._env.render()

  def close(self):
    try:
      self._env.close()
    except Exception:
      pass
