"""PinPad: built-in grid task testing long-horizon memory.

A copy of embodied_tpu/envs/pinpad.py: the agent walks a 16x14 grid
containing N colored pads and is rewarded for visiting all pads in a fixed
(per-task) order; the visit history is shown along the right edge. Pads
are placed around the perimeter of a walled arena, and the frame is
rendered through a vectorized color lookup table.
"""

import collections

import numpy as np

from ..utils import Space

COLORS = {
    1: (255, 0, 0), 2: (0, 255, 0), 3: (0, 0, 255), 4: (255, 255, 0),
    5: (255, 0, 255), 6: (0, 255, 255), 7: (128, 0, 128), 8: (0, 128, 128),
}

TASKS = {'three': 3, 'four': 4, 'five': 5, 'six': 6, 'seven': 7, 'eight': 8}

_WALL = (192, 192, 192)
_FLOOR = (255, 255, 255)
_FLOOR_WIN = (223, 255, 223)
_MOVES = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))
_CELEBRATE_TICKS = 10


def _make_layout(num_pads):
  """16x14 arena: border walls, pads as 3x3 regions along the perimeter."""
  width, height = 16, 14
  grid = np.zeros((width, height), np.int8)  # 0 floor, -1 wall, >0 pad id.
  grid[0, :] = grid[-1, :] = -1
  grid[:, 0] = grid[:, -1] = -1
  # Pad anchor positions around the perimeter (clockwise).
  anchors = [
      (1, 1), (6, 1), (11, 1), (12, 5), (12, 10),
      (6, 10), (1, 10), (1, 5)]
  for pad in range(1, num_pads + 1):
    ax, ay = anchors[(pad - 1) % len(anchors)]
    grid[ax:ax + 3, ay:ay + 3] = pad
  return grid


class PinPad:

  def __init__(self, task, length=10000, seed=None):
    assert task in TASKS, (task, sorted(TASKS))
    assert length > 0
    self.num_pads = TASKS[task]
    self.layout = _make_layout(self.num_pads)
    self.length = length
    self.random = np.random.default_rng(seed)
    self.target = tuple(range(1, self.num_pads + 1))
    self.spawns = np.argwhere(self.layout >= 0)
    self.sequence = collections.deque(maxlen=self.num_pads)
    self.player = None
    self.tick = 0
    self.finished = True
    self.celebrate = 0
    # Tile color tables for the renderer: pads are mostly washed out
    # (10% color) unless the player stands on them (full color).
    ids = np.arange(-1, self.num_pads + 1)
    dim = np.array(_FLOOR, np.float64)
    self._tile_dim = np.zeros((len(ids), 3), np.float64)
    self._tile_hot = np.zeros((len(ids), 3), np.float64)
    for offset, tile in enumerate(ids):
      if tile == -1:
        self._tile_dim[offset] = self._tile_hot[offset] = _WALL
      elif tile == 0:
        self._tile_dim[offset] = self._tile_hot[offset] = _FLOOR
      else:
        hot = np.array(COLORS[tile], np.float64)
        self._tile_hot[offset] = hot
        self._tile_dim[offset] = 0.1 * hot + 0.9 * dim

  @property
  def act_space(self):
    return {'action': Space(np.int32, (), 0, 5), 'reset': Space(bool)}

  @property
  def obs_space(self):
    return {
        'image': Space(np.uint8, (64, 64, 3)),
        'reward': Space(np.float32),
        'is_first': Space(bool),
        'is_last': Space(bool),
        'is_terminal': Space(bool),
    }

  def _respawn(self):
    spot = self.spawns[self.random.integers(len(self.spawns))]
    self.player = (int(spot[0]), int(spot[1]))
    self.sequence.clear()

  def step(self, action):
    if self.finished or action['reset']:
      self._respawn()
      self.tick = 0
      self.finished = False
      self.celebrate = 0
      return self._frame(0.0, first=True)
    if self.celebrate:
      self.celebrate -= 1
      if not self.celebrate:
        self._respawn()
    reward = self._move(int(action['action']))
    self.tick += 1
    self.finished = self.tick >= self.length
    return self._frame(reward, last=self.finished)

  def _move(self, direction):
    dx, dy = _MOVES[direction]
    x = min(max(self.player[0] + dx, 0), self.layout.shape[0] - 1)
    y = min(max(self.player[1] + dy, 0), self.layout.shape[1] - 1)
    tile = int(self.layout[x, y])
    if tile >= 0:
      self.player = (x, y)
    if tile > 0 and (not self.sequence or self.sequence[-1] != tile):
      self.sequence.append(tile)
    if not self.celebrate and tuple(self.sequence) == self.target:
      self.celebrate = _CELEBRATE_TICKS
      return 10.0
    return 0.0

  def _frame(self, reward, first=False, last=False):
    return {
        'image': self._render(),
        'reward': np.float32(reward),
        'is_first': first,
        'is_last': last,
        'is_terminal': False,
    }

  def _render(self):
    # Color every tile through the lookup tables in one gather.
    index = self.layout.astype(np.int32) + 1  # -1 wall -> row 0.
    canvas = self._tile_dim[index].copy()
    if self.celebrate:
      canvas[self.layout == 0] = _FLOOR_WIN
    px, py = self.player
    standing = int(self.layout[px, py])
    if standing > 0:
      canvas[self.layout == standing] = self._tile_hot[standing + 1]
    canvas[px, py] = (0, 0, 0)
    # History strip along the right edge.
    strip = np.full((canvas.shape[0], 2, 3), _WALL, np.float64)
    for slot, pad in enumerate(self.sequence):
      strip[2 * slot + 1, 0] = COLORS[pad]
    canvas = np.concatenate([canvas, strip], 1)
    frame = canvas.astype(np.uint8)
    return np.repeat(np.repeat(frame, 4, 0), 4, 1)

  def close(self):
    pass
