"""Environment middleware, a copy of embodied_tpu/core/wrappers.py.

TimeLimit, ActionRepeat, ClipAction, NormalizeAction, UnifyDtypes,
CheckSpaces, DiscretizeAction, ResizeImage, BackwardReturn, AddObs and
RestartOnException: action-rewriting wrappers share one `_KeyAction`
mechanism, image resizing is integer-index numpy (no PIL dependency), and
crash restarts use a sliding failure window.
"""

import time
from collections import deque

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


class DiscretizeAction(_KeyAction):
  """Presents `bins` discrete choices per dim of a continuous action."""

  def __init__(self, env, key='action', bins=5):
    super().__init__(env, key)
    shape = env.act_space[key].shape
    self._ndim = int(shape[0]) if shape else 1
    self._grid = np.linspace(-1, 1, bins)

  def outer_space(self, inner):
    return Space(np.int32, self._ndim, 0, len(self._grid))

  def to_env(self, value):
    return self._grid[np.asarray(value)]


class TimeLimit(Wrapper):
  """Ends episodes after `duration` decision steps (0 disables)."""

  def __init__(self, env, duration, reset=True):
    super().__init__(env)
    self._budget = int(duration or 0)
    self._hard_reset = reset
    self._left = self._budget
    self._expired = False

  def step(self, action):
    if action['reset'] or self._expired:
      self._left = self._budget
      self._expired = False
      if self._hard_reset:
        return self.env.step({**action, 'reset': True})
      # Soft mode: keep the env state, only mark the boundary.
      obs = self.env.step({**action, 'reset': False})
      obs['is_first'] = True
      return obs
    obs = self.env.step(action)
    if self._budget:
      self._left -= 1
      if self._left <= 0:
        obs['is_last'] = True
    self._expired = bool(obs['is_last'])
    return obs


class ActionRepeat(Wrapper):
  """Applies each action `repeat` times, summing rewards."""

  def __init__(self, env, repeat):
    super().__init__(env)
    self._repeat = int(repeat)

  def step(self, action):
    if action['reset']:
      return self.env.step(action)
    total = 0.0
    for _ in range(self._repeat):
      obs = self.env.step(action)
      total += obs['reward']
      if obs['is_last'] or obs['is_terminal']:
        break
    obs['reward'] = np.float32(total)
    return obs


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


class ResizeImage(Wrapper):
  """Nearest-neighbor resize of image observations via integer indexing
  (no imaging-library dependency)."""

  def __init__(self, env, size=(64, 64)):
    super().__init__(env)
    self._size = tuple(size)
    self._index = {}
    for key, space in env.obs_space.items():
      if len(space.shape) > 1 and tuple(space.shape[:2]) != self._size:
        h, w = space.shape[:2]
        rows = (np.arange(self._size[0]) * h // self._size[0])
        cols = (np.arange(self._size[1]) * w // self._size[1])
        self._index[key] = (rows[:, None], cols[None, :])

  @property
  def obs_space(self):
    spaces = dict(self.env.obs_space)
    for key in self._index:
      spaces[key] = Space(np.uint8, self._size + spaces[key].shape[2:])
    return spaces

  def step(self, action):
    obs = self.env.step(action)
    for key, (rows, cols) in self._index.items():
      obs[key] = np.ascontiguousarray(obs[key][rows, cols])
    return obs


class BackwardReturn(Wrapper):
  """Adds the discounted backward-looking return as observation key
  'bwreturn' (resets with the episode)."""

  def __init__(self, env, horizon):
    super().__init__(env)
    self._decay = 1 - 1 / horizon
    self._acc = 0.0

  @property
  def obs_space(self):
    return {**self.env.obs_space, 'bwreturn': Space(np.float32)}

  def step(self, action):
    obs = self.env.step(action)
    if obs['is_first']:
      self._acc = 0.0
    self._acc = self._acc * self._decay + obs['reward']
    obs['bwreturn'] = np.float32(self._acc)
    return obs


class AddObs(Wrapper):
  """Injects a constant observation key."""

  def __init__(self, env, key, value, space):
    super().__init__(env)
    self._extra = {key: value}
    self._extra_space = {key: space}

  @property
  def obs_space(self):
    return {**self.env.obs_space, **self._extra_space}

  def step(self, action):
    obs = self.env.step(action)
    obs.update(self._extra)
    return obs


class RestartOnException(Wrapper):
  """Rebuilds a crashing env from its constructor, tolerating up to
  `maxfails` crashes inside any `window`-second sliding interval."""

  def __init__(
      self, ctor, exceptions=(Exception,), window=300, maxfails=2, wait=20):
    if not isinstance(exceptions, (tuple, list)):
      exceptions = (exceptions,)
    self._ctor = ctor
    self._catch = tuple(exceptions)
    self._window = window
    self._maxfails = maxfails
    self._wait = wait
    self._crashes = deque()
    super().__init__(ctor())

  def step(self, action):
    try:
      return self.env.step(action)
    except self._catch as e:
      now = time.time()
      self._crashes.append(now)
      while self._crashes and self._crashes[0] < now - self._window:
        self._crashes.popleft()
      if len(self._crashes) > self._maxfails:
        raise RuntimeError(
            f'Env crashed {len(self._crashes)} times within '
            f'{self._window}s; giving up.') from e
      print(f'Restarting env after {type(e).__name__}: {e}', flush=True)
      time.sleep(self._wait)
      self.env = self._ctor()
      return self.env.step(
          {**action, 'reset': np.ones_like(action['reset'])})
