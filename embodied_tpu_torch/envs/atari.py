"""Atari via the ALE interface.

A copy of embodied_tpu/envs/atari.py: sticky actions, frame pooling with
max/mean aggregate, grayscale or RGB, full or minimal action sets, noop
starts, lives modes, optional reward clipping and resizing. Requires
ale_py (gated import).
"""

import threading

import numpy as np

from ..utils import Space


class Atari:

  LOCK = threading.Lock()  # ALE ROM loading is not thread-safe.

  def __init__(
      self, name, size=(96, 96), repeat=4, sticky=True, gray=True,
      actions='all', lives='unused', noops=30, pooling=2, aggregate='max',
      resize='pillow', clip_reward=False, autostart=False, seed=None):
    try:
      import ale_py
    except ImportError:
      raise ImportError('The Atari env requires ale_py')
    assert lives in ('unused', 'discount', 'reset'), lives
    assert actions in ('all', 'needed'), actions
    assert aggregate in ('max', 'mean'), aggregate
    self._ale_py = ale_py
    with self.LOCK:
      self._ale = ale_py.ALEInterface()
      self._ale.setLoggerMode(ale_py.LoggerMode.Error)
      if seed is not None:
        self._ale.setInt('random_seed', int(seed))
      self._ale.setFloat('repeat_action_probability',
                         0.25 if sticky else 0.0)
      self._ale.loadROM(self._rom(name))
    if actions == 'all':
      self._actions = self._ale.getLegalActionSet()
    else:
      self._actions = self._ale.getMinimalActionSet()
    self._size = tuple(size)
    self._repeat = repeat
    self._gray = gray
    self._lives_mode = lives
    self._noops = noops
    self._pooling = pooling
    self._aggregate = aggregate
    self._clip_reward = clip_reward
    self._random = np.random.default_rng(seed)
    shape = self._ale.getScreenDims() + (3,)
    self._buffers = [np.zeros(shape, np.uint8) for _ in range(pooling)]
    self._done = True
    self._lives = 0

  def _rom(self, name):
    import ale_py.roms as roms
    name = ''.join(part.capitalize() for part in name.split('_'))
    return getattr(roms, name)

  @property
  def obs_space(self):
    channels = 1 if self._gray else 3
    return {
        'image': Space(np.uint8, (*self._size, channels)),
        'reward': Space(np.float32),
        'is_first': Space(bool),
        'is_last': Space(bool),
        'is_terminal': Space(bool),
    }

  @property
  def act_space(self):
    return {
        'action': Space(np.int32, (), 0, len(self._actions)),
        'reset': Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._done:
      with self.LOCK:
        self._ale.reset_game()
      for _ in range(int(self._random.integers(0, self._noops + 1))):
        self._ale.act(0)
        if self._ale.game_over():
          self._ale.reset_game()
      self._lives = self._ale.lives()
      self._done = False
      self._screen(self._buffers[0])
      for buffer in self._buffers[1:]:
        buffer[:] = self._buffers[0]
      return self._obs(0.0, is_first=True)

    total = 0.0
    dead = False
    for r in range(self._repeat):
      total += self._ale.act(self._actions[int(action['action'])])
      if self._lives_mode != 'unused' and self._ale.lives() < self._lives:
        dead = True
      if r >= self._repeat - self._pooling:
        self._screen(self._buffers[self._repeat - 1 - r])
      if self._ale.game_over() or dead:
        break
    over = self._ale.game_over()
    self._done = over or (self._lives_mode == 'reset' and dead)
    self._lives = self._ale.lives()
    if self._clip_reward:
      total = float(np.sign(total))
    return self._obs(
        total,
        is_last=self._done,
        is_terminal=over or (self._lives_mode == 'discount' and dead))

  def _screen(self, buffer):
    self._ale.getScreenRGB(buffer)

  def _obs(self, reward, is_first=False, is_last=False, is_terminal=False):
    if self._aggregate == 'max':
      image = np.maximum.reduce(self._buffers[:self._pooling])
    else:
      image = np.mean(self._buffers[:self._pooling], 0).astype(np.uint8)
    if image.shape[:2] != self._size:
      image = self._resize(image, self._size)
    if self._gray:
      weights = np.array([0.299, 0.587, 0.114])
      image = (image @ weights).astype(np.uint8)[..., None]
    return {
        'image': image,
        'reward': np.float32(reward),
        'is_first': is_first,
        'is_last': is_last,
        'is_terminal': is_terminal,
    }

  def _resize(self, image, size):
    from PIL import Image
    return np.array(
        Image.fromarray(image).resize(size, Image.BILINEAR))

  def close(self):
    pass
