"""Sharded on-disk datasets of dict-of-array records.

Counterpart of embodied_tpu/data/bag.py, with the same file format, so
either package reads the other's shards. Records are dicts of numpy arrays
appended to shard files; each shard is a compressed npz of columns, named
`<timestamp>-<uuid>-<rows>.npz`, so a directory's index comes from its
file names without opening a file. Access layers:

  BagWriter   append records -> sharded npz files
  Bag         random access: len(), [i], range(lo, hi) across shards
  BagReader   sequential resumable Stream (multi-host shardable)
  BagSampler  seeded random-window Stream over the Bag index, resumable

Unlike the JAX index, which takes every `*.npz` of the directory and reads
a row count from whatever its name ends in, the port takes only names of
the writer's pattern and raises, naming the stray files, on any other
`*.npz` there.
"""

import io
import json
import re

import numpy as np

from ..core import base
from ..utils import Path, UUID, timestamp

SHARD_NAME = re.compile(r'\d{8}T\d{6}F\d{6}-[0-9A-Za-z]{22}-(\d+)\.npz')


def shard_files(directory):
  """The shard files of `directory` in name order and their row counts.
  Raises on an empty directory or on an `*.npz` the writer did not name."""
  files = sorted(str(f) for f in Path(directory).glob('*.npz'))
  if not files:
    raise FileNotFoundError(f'No shards found in {directory}')
  matches = [SHARD_NAME.fullmatch(Path(f).name) for f in files]
  stray = [Path(f).name for f, m in zip(files, matches) if not m]
  if stray:
    raise ValueError(
        f'{directory} holds files that are not shards of a BagWriter '
        f'(<timestamp>-<uuid>-<rows>.npz): {stray}')
  return files, [int(m.group(1)) for m in matches]


def _read(filename):
  with io.BytesIO(Path(filename).read_bytes()) as f:
    return dict(np.load(f))


class BagWriter:
  """Appends records and writes shards of `shard_size` rows."""

  def __init__(self, directory, shard_size=1024):
    self.directory = Path(directory)
    self.directory.mkdir()
    self.shard_size = shard_size
    self.buffer = []

  def append(self, record):
    record = {k: np.asarray(v) for k, v in record.items()}
    self.buffer.append(record)
    if len(self.buffer) >= self.shard_size:
      self.flush()

  def flush(self):
    if not self.buffer:
      return
    columns = {
        k: np.stack([r[k] for r in self.buffer])
        for k in self.buffer[0].keys()}
    name = f'{timestamp(millis=True)}-{UUID()}-{len(self.buffer)}.npz'
    buffer = io.BytesIO()
    np.savez_compressed(buffer, **columns)
    (self.directory / name).write_bytes(buffer.getvalue())
    self.buffer = []

  def close(self):
    self.flush()


class Bag:
  """Per-record random access over a shard directory.

  Opening a Bag lists the directory and nothing more. Shards decompress on
  first touch and stay in a small LRU cache, so locally clustered access
  patterns (shuffled windows, epoch sweeps) pay one decompression per
  shard per pass."""

  def __init__(self, directory, cache_shards=4):
    self.directory = Path(directory)
    self.files, counts = shard_files(directory)
    self.starts = np.concatenate([[0], np.cumsum(counts)])
    self.cache_shards = cache_shards
    self._cache = {}  # file index -> columns dict (insertion-ordered LRU)

  def __len__(self):
    return int(self.starts[-1])

  @property
  def spaces(self):
    """{key: (shape, dtype)} of one record, from the first shard."""
    cols = self._shard(0)
    return {k: (v.shape[1:], v.dtype) for k, v in cols.items()}

  def _shard(self, fi):
    cols = self._cache.pop(fi, None)
    if cols is None:
      cols = _read(self.files[fi])
      rows = len(next(iter(cols.values())))
      want = int(self.starts[fi + 1] - self.starts[fi])
      assert rows == want, (self.files[fi], rows, want)
    self._cache[fi] = cols  # re-insert = most recently used
    while len(self._cache) > self.cache_shards:
      self._cache.pop(next(iter(self._cache)))
    return cols

  def _locate(self, index):
    """The shard holding record `index` and the record's row in it."""
    fi = int(np.searchsorted(self.starts, index, side='right')) - 1
    return fi, index - int(self.starts[fi])

  def __getitem__(self, index):
    if isinstance(index, slice):
      assert index.step in (None, 1), index
      return self.range(index.start or 0, index.stop)
    index = int(index)
    if index < 0:
      index += len(self)
    assert 0 <= index < len(self), (index, len(self))
    fi, row = self._locate(index)
    return {k: v[row] for k, v in self._shard(fi).items()}

  def range(self, lo, hi):
    """Columns for records [lo, hi), concatenated across shard bounds."""
    hi = len(self) if hi is None else hi
    assert 0 <= lo <= hi <= len(self), (lo, hi, len(self))
    parts = []
    index = lo
    while index < hi:
      fi, row = self._locate(index)
      take = min(hi - index, int(self.starts[fi + 1]) - index)
      parts.append({k: v[row:row + take] for k, v in self._shard(fi).items()})
      index += take
    if len(parts) == 1:
      return parts[0]
    return {k: np.concatenate([p[k] for p in parts])
            for k in parts[0].keys()}


class BagSampler(base.Stream):
  """Seeded random windows over a Bag; resumable mid-epoch.

  Each batch row is a length-`length` window starting at a uniformly
  drawn record (windows may span shard boundaries). The RNG state
  round-trips through save/load, so a restored sampler continues the
  exact sample stream."""

  def __init__(self, directory, batch, length=1, seed=0):
    self.bag = Bag(directory)
    assert len(self.bag) >= length, (len(self.bag), length)
    self.batch = batch
    self.length = length
    self.rng = np.random.default_rng(seed)

  def __next__(self):
    highest = len(self.bag) - self.length + 1
    starts = self.rng.integers(0, highest, self.batch)
    outs = [self.bag.range(int(s), int(s) + self.length) for s in starts]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0].keys()}

  def save(self):
    return {'rng': json.dumps(self.rng.bit_generator.state)}

  def load(self, state):
    self.rng.bit_generator.state = json.loads(state['rng'])


class BagReader(base.Stream):
  """Streams batches of consecutive records; resumable and shardable.

  `shard_id`/`num_shards` partition the files across replicas for
  multi-host offline training. Without `repeat` the stream ends after its
  files' last whole window.
  """

  def __init__(self, directory, batch, length=1, shard_id=0, num_shards=1,
               repeat=True):
    self.directory = Path(directory)
    self.batch = batch
    self.length = length
    self.files = shard_files(directory)[0][shard_id::num_shards]
    if not self.files:
      raise FileNotFoundError(
          f'No shards for shard {shard_id} of {num_shards} in {directory}')
    self.repeat = repeat
    self.file_index = 0
    self.row_index = 0
    self.columns = None
    self.rows = 0

  def _load(self):
    self.columns = _read(self.files[self.file_index])
    self.rows = len(next(iter(self.columns.values())))
    self.row_index = 0

  def __next__(self):
    outs = []
    while len(outs) < self.batch:
      if self.columns is None:
        self._load()
      if self.row_index + self.length > self.rows:
        self.columns = None
        self.file_index += 1
        if self.file_index >= len(self.files):
          if not self.repeat:
            raise StopIteration
          self.file_index = 0
        continue
      start = self.row_index
      outs.append({
          k: v[start:start + self.length]
          for k, v in self.columns.items()})
      self.row_index += self.length
    return {
        k: np.stack([o[k] for o in outs]) for k in outs[0].keys()}

  def save(self):
    return {'file_index': self.file_index, 'row_index': self.row_index}

  def load(self, state):
    self.file_index = state['file_index'] % len(self.files)
    # Re-seek within the file; the row bound is checked on the next read.
    self._load()
    self.row_index = min(state['row_index'], self.rows)
