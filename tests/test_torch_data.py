"""The port's dataset shards (embodied_tpu_torch/data/bag.py): the JAX
package's bag cases (tests/test_data.py) on the port, each held against
the JAX Bag, BagReader or BagSampler on the same directory, shards that
each package writes read by the other, and the name check that the port
adds."""

import numpy as np
import pytest

from embodied_tpu import data as jdata
from embodied_tpu_torch import data


def write(directory, n, shard, package=data, **cols):
  writer = package.BagWriter(directory, shard_size=shard)
  for i in range(n):
    writer.append({k: fn(i) for k, fn in cols.items()})
  writer.close()
  return directory


def records(tmp_path, n=25, shard=7, package=data):
  return write(tmp_path / 'bag', n, shard, package,
               x=lambda i: np.full((3,), i, np.int64),
               y=lambda i: np.float32(i))


def same(a, b):
  assert a.keys() == b.keys()
  for k in a:
    assert a[k].dtype == b[k].dtype, k
    np.testing.assert_array_equal(a[k], b[k])


def test_write_read_roundtrip(tmp_path):
  write(tmp_path, 30, 8, x=lambda i: np.full((4,), i, np.float32),
        i=lambda i: np.int32(i))
  reader = data.BagReader(str(tmp_path), batch=2, length=3)
  other = jdata.BagReader(str(tmp_path), batch=2, length=3)
  batch = next(reader)
  assert batch['x'].shape == (2, 3, 4)
  assert batch['i'].shape == (2, 3)
  assert (np.diff(batch['i'], axis=1) == 1).all()
  same(batch, next(other))
  for _ in range(6):  # Past the last window and round again.
    same(next(reader), next(other))


def test_resume(tmp_path):
  write(tmp_path, 16, 8, i=lambda i: np.int32(i))
  reader = data.BagReader(str(tmp_path), batch=1, length=1)
  first = [int(next(reader)['i'][0, 0]) for _ in range(5)]
  assert first == list(range(5))
  state = reader.save()
  next(reader)
  reader.load(state)
  resumed = int(next(reader)['i'][0, 0])
  fresh = data.BagReader(str(tmp_path), batch=1, length=1)
  fresh.load(state)
  assert int(next(fresh)['i'][0, 0]) == resumed == 5
  other = jdata.BagReader(str(tmp_path), batch=1, length=1)
  other.load(state)
  assert int(next(other)['i'][0, 0]) == resumed


def test_sharding(tmp_path):
  write(tmp_path, 16, 4, i=lambda i: np.int32(i))
  readers = [data.BagReader(str(tmp_path), batch=1, length=1, shard_id=k,
                            num_shards=2) for k in (0, 1)]
  assert len(readers[0].files) + len(readers[1].files) == 4
  assert not set(readers[0].files) & set(readers[1].files)
  for k, reader in enumerate(readers):
    other = jdata.BagReader(str(tmp_path), batch=1, length=1, shard_id=k,
                            num_shards=2)
    assert reader.files == other.files


def test_len_and_getitem_across_shards(tmp_path):
  d = records(tmp_path)
  bag, other = data.Bag(d), jdata.Bag(d)
  assert len(bag) == len(other) == 25
  for i in (0, 6, 7, 13, 24, -1):
    rec = bag[i]
    want = i % 25
    assert rec['x'].tolist() == [want] * 3, (i, rec)
    assert float(rec['y']) == want
    same(rec, other[i])
  assert bag.spaces['x'] == ((3,), np.dtype(np.int64))
  assert bag.spaces == other.spaces


def test_range_spans_shard_boundary(tmp_path):
  d = records(tmp_path)
  bag = data.Bag(d)
  cols = bag.range(5, 16)  # crosses the 7 and 14 boundaries
  assert cols['x'].shape == (11, 3)
  assert cols['x'][:, 0].tolist() == list(range(5, 16))
  sl = bag[5:16]
  assert sl['x'][:, 0].tolist() == list(range(5, 16))
  same(cols, jdata.Bag(d).range(5, 16))


def test_sampler_deterministic_and_resumable(tmp_path):
  d = records(tmp_path)
  a = data.BagSampler(d, batch=4, length=5, seed=3)
  b = data.BagSampler(d, batch=4, length=5, seed=3)
  other = jdata.BagSampler(d, batch=4, length=5, seed=3)
  for _ in range(3):
    got = next(a)
    np.testing.assert_array_equal(got['x'], next(b)['x'])
    same(got, next(other))
  state = a.save()
  after = [next(a)['x'] for _ in range(2)]
  c = data.BagSampler(d, batch=4, length=5, seed=999)
  c.load(state)
  for want in after:
    np.testing.assert_array_equal(next(c)['x'], want)
  other.load(state)  # The JAX sampler takes the port's state, and back.
  np.testing.assert_array_equal(next(other)['x'], after[0])


def test_windows_are_consecutive_records(tmp_path):
  d = records(tmp_path)
  sampler = data.BagSampler(d, batch=8, length=4, seed=0)
  batch = next(sampler)
  firsts = batch['x'][:, 0, 0]
  for row, first in enumerate(firsts):
    assert batch['x'][row, :, 0].tolist() == list(
        range(int(first), int(first) + 4))


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_each_package_reads_the_others_shards(tmp_path, writer):
  d = records(tmp_path, 19, 5, jdata if writer == 'jax' else data)
  same(data.Bag(d).range(0, 19), jdata.Bag(d).range(0, 19))
  assert [str(f) for f in data.Bag(d).files] == jdata.Bag(d).files


def test_stray_files_are_named(tmp_path):
  """The JAX index takes a stray `notes-v2.npz` as a shard of 'v2' rows
  (int() raises) and `backup-3.npz` as a shard of 3; the port names
  both and reads nothing."""
  d = records(tmp_path, 9, 4)
  np.savez(d / 'backup-3.npz', x=np.zeros((5, 3)))
  (d / 'notes-v2.npz').write_bytes(b'')
  for make in (data.Bag, lambda d: data.BagSampler(d, batch=1),
               lambda d: data.BagReader(d, batch=1)):
    with pytest.raises(ValueError, match=r"backup-3\.npz.*notes-v2\.npz"):
      make(d)
  with pytest.raises(ValueError):
    jdata.Bag(d)
  (d / 'notes-v2.npz').unlink()
  assert len(jdata.Bag(d)) == 12  # 9 records and 3 the JAX index invents.
  for make in (data.Bag, lambda d: data.BagReader(d, batch=1)):
    with pytest.raises(FileNotFoundError, match=r'No shards'):
      make(tmp_path / 'empty')
