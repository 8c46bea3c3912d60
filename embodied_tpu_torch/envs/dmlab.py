"""DeepMind Lab adapter.

A copy of embodied_tpu/envs/dmlab.py: discrete action-set projection (the
standard IMPALA / PopArt sets over the 7-dim native action space), action
repeat, train/eval level aliasing with holdout levels, and hashed-bucket
text-instruction embeddings for language levels. Requires deepmind_lab
(gated import).
"""

import functools
import re
import zlib

import numpy as np

from ..utils import Space

# Published discrete action sets over DMLab's native 7-dim action space
# (look_lr, look_ud, strafe, forward, fire, jump, crouch).
IMPALA_ACTIONS = (
    (0, 0, 0, 1, 0, 0, 0),
    (0, 0, 0, -1, 0, 0, 0),
    (0, 0, -1, 0, 0, 0, 0),
    (0, 0, 1, 0, 0, 0, 0),
    (-20, 0, 0, 0, 0, 0, 0),
    (20, 0, 0, 0, 0, 0, 0),
    (-20, 0, 0, 1, 0, 0, 0),
    (20, 0, 0, 1, 0, 0, 0),
    (0, 0, 0, 0, 1, 0, 0),
)

POPART_ACTIONS = (
    (0, 0, 0, 1, 0, 0, 0),
    (0, 0, 0, -1, 0, 0, 0),
    (0, 0, -1, 0, 0, 0, 0),
    (0, 0, 1, 0, 0, 0, 0),
    (-10, 0, 0, 0, 0, 0, 0),
    (10, 0, 0, 0, 0, 0, 0),
    (-60, 0, 0, 0, 0, 0, 0),
    (60, 0, 0, 0, 0, 0, 0),
    (0, 10, 0, 0, 0, 0, 0),
    (0, -10, 0, 0, 0, 0, 0),
    (-10, 0, 0, 1, 0, 0, 0),
    (10, 0, 0, 1, 0, 0, 0),
    (-60, 0, 0, 1, 0, 0, 0),
    (60, 0, 0, 1, 0, 0, 0),
    (0, 0, 0, 0, 1, 0, 0),
)


class DMLab:

  WORDS = re.compile(r'([A-Za-z_]+|[^A-Za-z_ ]+)')

  def __init__(
      self, level, repeat=4, size=(64, 64), mode='train', actions='popart',
      episodic=True, text=None, seed=None):
    try:
      import deepmind_lab
    except ImportError:
      raise ImportError('The DMLab env requires deepmind_lab')
    if level == 'goals':
      level = 'dmlab_explore_goal_locations_small'
    self._size = tuple(size)
    self._repeat = repeat
    self._actions = {
        'impala': IMPALA_ACTIONS, 'popart': POPART_ACTIONS}[actions]
    self._episodic = episodic
    self._text = bool(level.startswith('language')) if text is None else text
    self._rng = np.random.default_rng(seed)
    config = dict(height=size[0], width=size[1], logLevel='WARN')
    if mode == 'train':
      if level.endswith('_test'):
        level = level[:-len('_test')] + '_train'
    elif mode == 'eval':
      config.update(allowHoldOutLevels='true', mixerSeed=0x600D5EED)
    else:
      raise NotImplementedError(mode)
    observations = ['RGB_INTERLEAVED'] + (['INSTR'] if self._text else [])
    self._env = deepmind_lab.Lab(
        level='contributed/dmlab30/' + level,
        observations=observations,
        config={k: str(v) for k, v in config.items()})
    self._image = None
    if self._text:
      self._instr = None
      self._instr_length = 32
      self._embed_size = 32
      self._buckets = 64 * 1024
      self._table = np.random.default_rng(0).normal(
          0.0, 1.0, (self._buckets, self._embed_size)).astype(np.float32)
    self._done = True

  @property
  def obs_space(self):
    spaces = {
        'image': Space(np.uint8, (*self._size, 3)),
        'reward': Space(np.float32),
        'is_first': Space(bool),
        'is_last': Space(bool),
        'is_terminal': Space(bool),
    }
    if self._text:
      spaces['instr'] = Space(
          np.float32, self._instr_length * self._embed_size)
    return spaces

  @property
  def act_space(self):
    return {
        'action': Space(np.int32, (), 0, len(self._actions)),
        'reset': Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._done:
      self._env.reset(seed=int(self._rng.integers(0, 2 ** 31 - 1)))
      self._done = False
      return self._obs(0.0, is_first=True)
    raw = np.array(self._actions[int(action['action'])], np.intc)
    reward = self._env.step(raw, num_steps=self._repeat)
    self._done = not self._env.is_running()
    return self._obs(reward, is_last=self._done)

  def _obs(self, reward, is_first=False, is_last=False):
    if not self._done:
      frames = self._env.observations()
      self._image = frames['RGB_INTERLEAVED']
      if self._text:
        self._instr = self._embed(frames['INSTR'])
    obs = dict(
        image=self._image,
        reward=np.float32(reward),
        is_first=is_first,
        is_last=is_last,
        is_terminal=is_last if self._episodic else False,
    )
    if self._text:
      obs['instr'] = self._instr
    return obs

  def _embed(self, text):
    indices = [self._bucket(w) for w in self.WORDS.findall(text.lower())]
    indices = (indices + [0] * self._instr_length)[:self._instr_length]
    return self._table[indices].reshape(-1)

  @functools.lru_cache(maxsize=4096)
  def _bucket(self, word):
    return zlib.crc32(word.encode('utf-8')) % self._buckets

  def close(self):
    self._env.close()
