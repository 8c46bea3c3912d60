"""Fixed-capacity columnar step store used by the replay buffer.

A copy of embodied_tpu/core/chunk.py.

Capability parity: the reference's embodied/core/chunk.py. Steps are stored
as preallocated numpy columns (one array per key) for zero-copy slicing.
The filename encodes `time-uuid-successor-length` so that item counts can be
reconstructed from directory listings alone on load.
"""

import io

import numpy as np

from ..utils import UUID, Path, timestamp


class Chunk:

  __slots__ = ('size', 'uuid', 'succ', 'length', 'columns', 'time')

  def __init__(self, size=1024):
    self.size = int(size)
    self.uuid = UUID()
    self.succ = UUID(bytes(16))  # Zero UUID means no successor.
    self.length = 0
    self.columns = None
    self.time = timestamp(millis=True)

  def __repr__(self):
    return (
        f'Chunk(uuid={self.uuid}, succ={self.succ}, '
        f'length={self.length}/{self.size})')

  @property
  def filename(self):
    return f'{self.time}-{self.uuid}-{self.succ}-{self.length}.npz'

  @property
  def nbytes(self):
    if self.columns is None:
      return 0
    return sum(col.nbytes for col in self.columns.values())

  def append(self, step):
    assert self.length < self.size, 'Chunk is full'
    if self.columns is None:
      self.columns = {}
      for key, v in step.items():
        v = np.asarray(v)
        column = np.empty((self.size, *v.shape), v.dtype)
        # Prefault the pages now: sequential first-touch is far cheaper
        # than faulting one row per append (microVM page faults are slow).
        column.fill(0)
        self.columns[key] = column
    index = self.length
    for key, value in step.items():
      self.columns[key][index] = value
    self.length += 1

  def slice(self, index, length):
    assert 0 <= index and index + length <= self.length, (
        index, length, self.length)
    return {k: col[index: index + length] for k, col in self.columns.items()}

  def update(self, index, length, values):
    assert 0 <= index and index + length <= self.length, (
        index, length, self.length)
    for key, value in values.items():
      if key not in self.columns:
        # Lazily add columns for new keys (e.g. refreshed latents).
        self.columns[key] = np.zeros(
            (self.size, *value.shape[1:]), value.dtype)
      self.columns[key][index: index + length] = value

  def save(self, directory, log=False):
    filename = Path(directory) / self.filename
    data = {k: col[:self.length] for k, col in self.columns.items()}
    buffer = io.BytesIO()
    np.savez_compressed(buffer, **data)
    filename.write_bytes(buffer.getvalue())
    if log:
      print(f'Saved chunk: {self.filename}')

  @classmethod
  def load(cls, filename, error='raise'):
    try:
      filename = Path(filename)
      parts = filename.stem.split('-')
      time, uuid, succ, length = parts
      length = int(length)
      with io.BytesIO(filename.read_bytes()) as buffer:
        arrays = dict(np.load(buffer))
      chunk = cls(size=max(length, 1))
      chunk.time = time
      chunk.uuid = UUID(uuid)
      chunk.succ = UUID(succ)
      chunk.length = length
      # Stored arrays are exactly `length` long; use them directly as columns.
      chunk.size = length
      chunk.columns = arrays
      for key, col in arrays.items():
        assert len(col) == length, (key, col.shape, length)
      return chunk
    except Exception as e:
      if error == 'raise':
        raise
      print(f'Skipping corrupt chunk {filename}: {e}')
      return None
