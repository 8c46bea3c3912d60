"""Environment middleware used by `models.common.wrap_env`.

The subset of embodied_tpu/core/wrappers.py that the acting path needs:
Wrapper, ClipAction, NormalizeAction, UnifyDtypes and CheckSpaces.
"""

import numpy as np

from ..utils import Space


class Wrapper:
  """Base: delegates everything to the wrapped env."""

  def __init__(self, env):
    self.env = env

  def __len__(self):
    return len(self.env)

  def __getattr__(self, name):
    if name.startswith('__'):
      raise AttributeError(name)
    try:
      return getattr(self.env, name)
    except AttributeError:
      raise ValueError(name)


class _KeyAction(Wrapper):
  """Shared machinery for wrappers that rewrite a single action key on its
  way into the env and advertise a different space for it."""

  def __init__(self, env, key):
    super().__init__(env)
    self.key = key
    self._space_cache = None

  @property
  def act_space(self):
    if self._space_cache is None:
      spaces = dict(self.env.act_space)
      replacement = self.outer_space(spaces.get(self.key))
      if replacement is not None:
        spaces[self.key] = replacement
      self._space_cache = spaces
    return self._space_cache

  def outer_space(self, inner):
    """Space shown to the agent; None keeps the env's own."""
    return None

  def to_env(self, value):
    """Map an agent-side value to the env-side value."""
    raise NotImplementedError

  def step(self, action):
    if self.key in action:
      action = {**action, self.key: self.to_env(action[self.key])}
    return self.env.step(action)


class ClipAction(_KeyAction):

  def __init__(self, env, key='action', low=-1, high=1):
    super().__init__(env, key)
    self.low, self.high = low, high

  def to_env(self, value):
    return np.clip(value, self.low, self.high)


class NormalizeAction(_KeyAction):
  """Presents bounded continuous dims as [-1, 1]; unbounded dims pass."""

  def __init__(self, env, key='action'):
    super().__init__(env, key)
    inner = env.act_space[key]
    bounded = np.isfinite(inner.low) & np.isfinite(inner.high)
    self._bounded = bounded
    self._center = np.where(bounded, (inner.low + inner.high) / 2, 0.0)
    self._halfspan = np.where(bounded, (inner.high - inner.low) / 2, 1.0)
    self._inner = inner

  def outer_space(self, inner):
    lo = np.where(self._bounded, -1.0, inner.low)
    hi = np.where(self._bounded, 1.0, inner.high)
    return Space(np.float32, inner.shape, lo, hi)

  def to_env(self, value):
    scaled = self._center + self._halfspan * value
    return np.where(self._bounded, scaled, value)


def _canonical(dtype):
  """The framework-canonical dtype for an env-provided dtype."""
  dtype = np.dtype(dtype)
  if dtype == bool or dtype == np.uint8:
    return dtype
  if np.issubdtype(dtype, np.floating):
    return np.dtype(np.float32)
  if np.issubdtype(dtype, np.integer):
    return np.dtype(np.int32)
  return dtype


class UnifyDtypes(Wrapper):
  """Canonicalizes dtypes at the env boundary: floats to f32, ints to i32,
  keeping bool and uint8 (images) as-is. Actions are cast back to the
  env's native dtypes on the way in."""

  def __init__(self, env):
    super().__init__(env)
    self._obs_space = {
        k: Space(_canonical(s.dtype), s.shape, s.low, s.high)
        for k, s in env.obs_space.items()}
    self._act_space = {
        k: Space(_canonical(s.dtype), s.shape, s.low, s.high)
        for k, s in env.act_space.items()}
    self._act_native = {
        k: s.dtype for k, s in env.act_space.items()
        if s.dtype != self._act_space[k].dtype}
    self._obs_cast = {
        k: s.dtype for k, s in self._obs_space.items()
        if s.dtype != env.obs_space[k].dtype}

  @property
  def obs_space(self):
    return self._obs_space

  @property
  def act_space(self):
    return self._act_space

  def step(self, action):
    for key, dtype in self._act_native.items():
      if key in action:
        action = {**action, key: np.asarray(action[key], dtype)}
    obs = self.env.step(action)
    for key, dtype in self._obs_cast.items():
      if key in obs:
        obs[key] = np.asarray(obs[key], dtype)
    return obs


class CheckSpaces(Wrapper):
  """Asserts every action/observation matches its declared space."""

  def __init__(self, env):
    overlap = env.obs_space.keys() & env.act_space.keys()
    assert not overlap, f'Keys in both obs and act spaces: {overlap}'
    super().__init__(env)

  def step(self, action):
    for key, value in action.items():
      self._validate('action', key, value, self.env.act_space[key])
    obs = self.env.step(action)
    for key, value in obs.items():
      if not key.startswith('log/'):
        self._validate('obs', key, value, self.env.obs_space[key])
    return obs

  @staticmethod
  def _validate(kind, key, value, space):
    ok_types = (np.ndarray, np.generic, list, tuple, int, float, bool)
    if not isinstance(value, ok_types):
      raise TypeError(f'Bad type {type(value)} for {kind} key {key!r}.')
    if not space.contains(value):
      arr = np.asarray(value)
      raise ValueError(
          f'{kind} {key!r}: dtype {arr.dtype}, shape {arr.shape}, range '
          f'[{arr.min()}, {arr.max()}] violates {space}.')
