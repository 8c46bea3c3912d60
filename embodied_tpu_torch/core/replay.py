"""Sequence replay over per-worker segment lanes.

A copy of embodied_tpu/core/replay.py.

Capability match (not a port) for the reference replay
(the reference's embodied/core/replay.py): streaming per-worker inserts,
fixed-length sequence sampling with pluggable selectors, in-place updates
(priorities and column patches), an online queue for fresh sequences,
bounded capacity with FIFO eviction, and resumable on-disk persistence
that tolerates corrupt shards.

The design is different from the reference's uuid-linked chunk store:

- Every insert worker owns a **lane**: an append-only stream of steps at
  monotonically increasing positions. A lane is stored as fixed-capacity
  columnar **segments** that are position-aligned (segment i covers
  positions [i*segcap, (i+1)*segcap)), so locating the segment holding a
  position is integer division — no uuid maps, no successor links.
- A sampleable item is just (lane, start). Sequences touch at most two
  adjacent segments (segcap >= length by construction) and are assembled
  with two bulk column copies.
- Eviction is a per-lane **frontier**: items leave FIFO, the frontier of
  their lane advances, and a segment is freed exactly when the frontier
  passes its end — no reference counting.
- Step ids are 12 bytes (lane u32 | position u64, big-endian), carried as
  a uint8 column so they round-trip through device memory; updates decode
  them right back into (lane, pos) array indices.
- Persistence writes one npz shard per segment, named
  ``{timestamp}-{lane}-{base}-{count}-{length}.npz``. Loading groups
  shards by lane, splits each lane into contiguous runs (a missing or
  corrupt shard simply splits the run), and rehydrates every run as a
  fresh lane — item counts follow from run lengths alone.
"""

import sys
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils import Path, RWLock, timer
from . import limiters
from . import selectors

STEPID_BYTES = 12


def packids(lane, positions):
  """Vectorized stepid encoding: (lane u32 | pos u64) as uint8[12] rows."""
  n = len(positions)
  out = np.empty((n, STEPID_BYTES), np.uint8)
  out[:, :4] = np.frombuffer(
      np.uint32(lane).byteswap().tobytes(), np.uint8)
  out[:, 4:] = (
      np.asarray(positions, np.uint64)
      .byteswap().view(np.uint8).reshape(n, 8))
  return out


def unpackid(stepid):
  """Decode one uint8[12] stepid row back to (lane, pos)."""
  raw = stepid.tobytes()
  return (int.from_bytes(raw[:4], 'big'), int.from_bytes(raw[4:12], 'big'))


class Segment:
  """Fixed-capacity columnar slab; columns materialize on first append.

  Materialization draws from `pool` when possible: on microVM kernels a
  page fault costs ~70us once the process RSS has grown, so faulting a
  fresh 13MB image column costs 100-300ms — reusing an evicted segment's
  columns makes steady-state inserts allocation- and fault-free. Stale
  contents are harmless: readers only reach rows < count."""

  __slots__ = ('base', 'capacity', 'count', 'cols', 'saved_count')

  def __init__(self, base, capacity):
    self.base = base
    self.capacity = capacity
    self.count = 0
    self.cols = None
    self.saved_count = -1  # Count at the time of the last shard write.

  @property
  def nbytes(self):
    if self.cols is None:
      return 0
    return sum(v.nbytes for v in self.cols.values())

  @staticmethod
  def signature(step):
    return tuple(sorted((k, v.shape, str(v.dtype)) for k, v in step.items()))

  def append(self, step, pool=None):
    if self.cols is None:
      reuse = pool.get(Segment.signature(step)) if pool is not None else None
      if reuse is not None:
        self.cols = reuse
      else:
        self.cols = {}
        for k, v in step.items():
          col = np.empty((self.capacity, *v.shape), v.dtype)
          # Prefault in one pass rather than row by row over the
          # segment's fill lifetime (first-touch dominates either way,
          # but batching keeps it off the per-insert path's tail).
          col.reshape(-1).view(np.uint8)[::4096] = 0
          self.cols[k] = col
    for k, v in step.items():
      self.cols[k][self.count] = v
    self.count += 1

  def recycle(self, pool):
    if self.cols is not None and self.count > 0:
      key = Segment.signature(
          {k: v[0] for k, v in self.cols.items()})
      pool.put(key, self.cols)
      self.cols = None

  def read(self, lo, hi, out, at, keys):
    for k in keys:
      out[k][at: at + (hi - lo)] = self.cols[k][lo:hi]

  def write(self, lo, values, offset, num):
    for k, v in values.items():
      if k in self.cols:
        self.cols[k][lo: lo + num] = v[offset: offset + num]


class SlabPool:
  """Bounded per-signature pool of retired segment column dicts."""

  def __init__(self, limit=8):
    self.limit = limit
    self.slabs = defaultdict(deque)

  def get(self, key):
    try:
      return self.slabs[key].popleft()
    except IndexError:
      return None

  def put(self, key, cols):
    q = self.slabs[key]
    if len(q) < self.limit:
      q.append(cols)


class Replay:
  """Sequence replay buffer. See module docstring for the design."""

  def __init__(
      self, length, capacity=None, directory=None, chunksize=1024,
      online=False, selector=None, save_wait=False, name='unnamed', seed=0):
    assert length >= 1, length
    self.length = int(length)
    self.capacity = int(capacity) if capacity else None
    # Position-aligned segments must cover a whole sequence so any sample
    # touches at most two of them.
    self.segcap = max(int(chunksize), self.length)
    self.name = name
    self.online = online
    self.sampler = selector if selector is not None else selectors.Uniform(
        seed)

    # lanes[lane] = {segment_index: Segment}; ends[lane] = next position.
    self.lanes = defaultdict(dict)
    self.ends = defaultdict(int)
    self.frontier = defaultdict(int)  # Oldest live item start per lane.
    self.workers = {}  # Insert-worker key -> lane id.
    self.nlanes = 0

    # FIFO item registry: itemid -> (lane, start) in ring arrays.
    self.item_head = 0  # Oldest live itemid.
    self.item_tail = 0  # Next itemid.
    self._ring = np.zeros((2, 1024), np.int64)  # [lane; start] per slot.
    self._slabs = SlabPool()
    # Next-segment slabs materialize ahead of need on this thread: the
    # pool's recycled slabs free ~capacity inserts AFTER the lane already
    # needed its next segment, and fresh faults cost 100-300ms inline.
    self._premaker = ThreadPoolExecutor(1, f'replay_premake_{name}')
    self._premake_margin = max(16, self.segcap // 8)

    self.rwlock = RWLock()
    if online:
      self.online_counts = defaultdict(int)
      self.queue = deque()

    if directory:
      self.directory = Path(directory)
      self.directory.mkdir()
      self.pool = ThreadPoolExecutor(16, f'replay_saver_{name}')
    else:
      self.directory = None
      self.pool = None
    self.save_wait = save_wait

    self.metrics = {'samples': 0, 'inserts': 0, 'updates': 0}

  # --- Introspection --------------------------------------------------------

  def __len__(self):
    return self.item_tail - self.item_head

  def stats(self):
    m = self.metrics
    nbytes = sum(
        seg.nbytes for lane in list(self.lanes.values())
        for seg in list(lane.values()))
    stats = {
        'items': len(self),
        'segments': sum(len(x) for x in self.lanes.values()),
        'lanes': len(self.lanes),
        'ram_gb': nbytes / (1024 ** 3),
        'inserts': m['inserts'],
        'samples': m['samples'],
        'updates': m['updates'],
        'replay_ratio': (
            self.length * m['samples'] / m['inserts']
            if m['inserts'] else np.nan),
    }
    for key in m:
      m[key] = 0
    return stats

  # --- Insert path ----------------------------------------------------------

  @timer.section('replay_add')
  def add(self, step, worker=0):
    step = {
        k: np.asarray(v) for k, v in step.items() if not k.startswith('log/')}
    with self.rwlock.reading:
      lane = self.workers.get(worker)
      if lane is None:
        lane = self.workers[worker] = self._new_lane()
      pos = self.ends[lane]
      step['stepid'] = packids(lane, [pos])[0]
      segs = self.lanes[lane]
      idx = pos // self.segcap
      seg = segs.get(idx)
      if seg is None:
        seg = segs[idx] = Segment(idx * self.segcap, self.segcap)
      seg.append(step, self._slabs)
      if seg.count == self.segcap - self._premake_margin:
        self._premaker.submit(self._premake, lane, idx + 1, dict(step))
      self.ends[lane] = pos + 1
      start = pos + 1 - self.length
      if start >= 0:
        self._insert(lane, start)
        # Queue a fresh window once per `length` added steps (the counter
        # ticks on every add, so the cadence matches the reference's:
        # first queued window starts one step after the stream fills).
        if self.online and self.online_counts[lane] % self.length == 0:
          self.queue.append((lane, start))
      if self.online:
        self.online_counts[lane] += 1

  def _premake(self, lane, idx, step):
    """Materialize segment `idx` of `lane` ahead of its first append.
    Runs on the premake thread; installing into the lane dict must be a
    single GIL-atomic setdefault — a separate membership check could
    interleave with the insert thread creating (and appending rows to)
    the same segment, and overwriting it would drop those rows."""
    seg = Segment(idx * self.segcap, self.segcap)
    seg.append(step, self._slabs)
    seg.count = 0  # The probe row only materialized the columns.
    segs = self.lanes.get(lane)
    if segs is None or segs.setdefault(idx, seg) is not seg:
      # Lost the race against an inline creation in add(); hand the
      # premade columns back to the pool rather than leaking them.
      self._slabs.put(Segment.signature(step), seg.cols)

  def _new_lane(self):
    lane = self.nlanes
    self.nlanes += 1
    return lane

  def _insert(self, lane, start):
    self.metrics['inserts'] += 1
    while self.capacity and len(self) >= self.capacity:
      self._evict()
    itemid = self.item_tail
    self.item_tail += 1
    cap = self._ring.shape[1]
    if self.item_tail - self.item_head > cap:
      self._grow_ring()
      cap = self._ring.shape[1]
    self._ring[:, itemid % cap] = (lane, start)
    stepids = packids(lane, range(start, start + self.length))
    self.sampler[itemid] = stepids

  def _grow_ring(self):
    old = self._ring
    cap = old.shape[1]
    new = np.zeros((2, cap * 2), np.int64)
    ids = np.arange(self.item_head, self.item_tail - 1)
    new[:, ids % (cap * 2)] = old[:, ids % cap]
    self._ring = new

  def _evict(self):
    itemid = self.item_head
    self.item_head += 1
    del self.sampler[itemid]
    lane, start = self._ring[:, itemid % self._ring.shape[1]]
    lane, start = int(lane), int(start)
    # Items leave in FIFO order per lane too, so this item's start IS the
    # lane frontier; everything before start+1 is now unreachable.
    self.frontier[lane] = start + 1
    # Free whole segments the frontier has passed: a live sequence starts
    # at >= frontier, so segment [base, base+cap) is unreachable once
    # frontier >= base + cap.
    segs = self.lanes[lane]
    while segs:
      idx = min(segs)
      seg = segs[idx]
      if self.frontier[lane] >= seg.base + seg.capacity:
        del segs[idx]
        # Recycle the slab only if nothing else holds the segment (a
        # sample snapshot or an async shard write would): with the dict
        # entry gone no new reference can appear, so an exclusive
        # refcount here proves reuse cannot tear a concurrent read.
        if sys.getrefcount(seg) == 2:  # `seg` local + getrefcount arg.
          seg.recycle(self._slabs)
      else:
        break

  # --- Sample path ----------------------------------------------------------

  @timer.section('replay_sample')
  def sample(self, batch, mode='train'):
    assert mode in ('train', 'report', 'eval'), mode
    limiters.wait(
        lambda: len(self), f'Replay buffer {self.name} is empty')
    with self.rwlock.reading:
      # Inserts (and with them evictions) also run under the read lock so
      # they never block sampling; safety instead comes from segments
      # being append-only: eviction merely unlinks them, so a pick
      # SNAPSHOTS its segment objects up front (keeping the arrays alive
      # via refcount) and is re-drawn if it went stale in between.
      picks = []
      fresh = 0
      if self.online and mode == 'train':
        while self.queue and len(picks) < batch:
          lane, start = self.queue.popleft()
          snap = self._snapshot(lane, int(start))
          if snap is not None:
            picks.append(snap)
        fresh = len(picks)
      tries = 0
      while len(picks) < batch:
        need = batch - len(picks)
        if hasattr(self.sampler, 'sample_batch'):
          itemids = self.sampler.sample_batch(need)
        else:
          itemids = [self.sampler() for _ in range(need)]
        for itemid in itemids:
          snap = self._resolve(itemid)
          if snap is not None:
            picks.append(snap)
        tries += 1
        assert tries < 100, 'replay sampling livelock: all picks stale'
      if mode == 'train':
        self.metrics['samples'] += batch
      data = self._gather(picks)
    return self._annotate(data, fresh)

  def _resolve(self, itemid):
    """Ring slot -> segment snapshot, or None if the item was evicted (or
    the ring was swapped by a concurrent grow) between sampling its id and
    reading its slot."""
    ring = self._ring  # Local snapshot: modulus must match the buffer.
    lane, start = ring[:, itemid % ring.shape[1]]
    if itemid < self.item_head or ring is not self._ring:
      return None
    return self._snapshot(int(lane), int(start))

  def _snapshot(self, lane, start):
    """Pin the (<=2) segments covering [start, start+length), verifying
    the window is still ahead of the lane's eviction frontier."""
    segs = self.lanes.get(lane)
    if segs is None or start < self.frontier.get(lane, 0):
      return None
    idx, off = divmod(start, self.segcap)
    n0 = min(self.length, self.segcap - off)
    a = segs.get(idx)
    b = segs.get(idx + 1) if n0 < self.length else None
    if a is None or (n0 < self.length and b is None):
      return None
    return (a, off, n0, b)

  def _gather(self, picks):
    """Assemble [B, length, ...] arrays; each pick copies <= 2 slices."""
    with timer.section('assemble_batch'):
      first = picks[0][0]
      out = {
          k: np.empty((len(picks), self.length, *v.shape[1:]), v.dtype)
          for k, v in first.cols.items()}
      keys = list(out.keys())
      L = self.length
      for n, (a, off, n0, b) in enumerate(picks):
        row = {k: out[k][n] for k in keys}
        a.read(off, off + n0, row, 0, keys)
        if n0 < L:
          b.read(0, L - n0, row, n0, keys)
      return out

  def _annotate(self, data, fresh):
    if 'is_first' in data:
      data['is_first'][:, 0] = True
      if 'is_last' in data:
        # Steps whose successor begins a new episode must close theirs,
        # even if the episode was abandoned mid-run.
        nxt = np.roll(data['is_first'], -1, axis=1)
        nxt[:, -1] = False
        data['is_last'] = data['is_last'] | nxt
    return data

  # --- Update path ----------------------------------------------------------

  @timer.section('replay_update')
  def update(self, data):
    data = dict(data)
    stepid = np.asarray(data.pop('stepid'))
    priority = data.pop('priority', None)
    assert stepid.ndim == 3, stepid.shape
    self.metrics['updates'] += int(np.prod(stepid.shape[:-1]))
    if priority is not None and hasattr(self.sampler, 'prioritize'):
      self.sampler.prioritize(
          stepid.reshape((-1, stepid.shape[-1])), np.ravel(priority))
    if not data:
      return
    with self.rwlock.reading:
      for i, row in enumerate(stepid):
        lane, start = unpackid(row[0])
        values = {k: v[i] for k, v in data.items()}
        self._patch(lane, start, values)

  def _patch(self, lane, start, values):
    num = len(next(iter(values.values())))
    segs = self.lanes.get(lane)
    if segs is None or start < self.frontier.get(lane, 0):
      return  # Evicted since it was sampled.
    idx, off = divmod(start, self.segcap)
    done = 0
    while done < num:
      seg = segs.get(idx)
      if seg is None:
        return
      take = min(num - done, seg.capacity - off)
      seg.write(off, values, done, take)
      done += take
      idx, off = idx + 1, 0

  # --- Persistence ----------------------------------------------------------

  @timer.section('replay_save')
  def save(self):
    if not self.directory:
      return None
    with self.rwlock.writing:
      stamp = time.strftime('%Y%m%dT%H%M%S')
      futures = []
      for lane, segs in self.lanes.items():
        for seg in segs.values():
          if seg.count > 0 and seg.count != seg.saved_count:
            futures.append(self.pool.submit(
                self._write_shard, stamp, lane, seg, seg.saved_count))
            seg.saved_count = seg.count
      if self.save_wait:
        [f.result() for f in futures]
    return None

  def _write_shard(self, stamp, lane, seg, prev_count):
    count = seg.count
    name = f'{stamp}-{lane}-{seg.base}-{count}-{self.length}.npz'
    cols = {k: v[:count] for k, v in seg.cols.items()}
    with timer.section('shard_write'):
      import io
      buf = io.BytesIO()
      np.savez_compressed(buf, **cols)
      # Torn writes surface as corrupt shards, which load() tolerates.
      (self.directory / name).write_bytes(buf.getvalue())
    if prev_count > 0:
      # A longer shard of the same segment supersedes the partial one.
      for old in self.directory.glob(f'*-{lane}-{seg.base}-{prev_count}-*'):
        try:
          old.remove()
        except OSError:
          pass

  @timer.section('replay_load')
  def load(self, data=None, directory=None, amount=None):
    directory = Path(directory) if directory else self.directory
    amount = amount or self.capacity or float('inf')
    if not directory or not directory.exists():
      return
    shards = []  # (lane_key, base, count, mtime_stamp, path)
    for path in directory.glob('*.npz'):
      try:
        stamp, lane, base, count, length = path.stem.split('-')
        shards.append((int(lane), int(base), int(count), stamp, path))
      except ValueError:
        continue
    if not shards:
      return
    # Group by original lane; keep the longest shard per segment base.
    bylane = defaultdict(dict)
    for lane, base, count, stamp, path in shards:
      cur = bylane[lane].get(base)
      if cur is None or count > cur[0]:
        bylane[lane][base] = (count, stamp, path)
    # Split each lane into contiguous runs; load newest runs first until
    # `amount` items are available, then rehydrate oldest-first so FIFO
    # eviction still drops the oldest data.
    runs = []  # (newest_stamp, [(path, count), ...])
    for lane, bases in bylane.items():
      run = []
      prev_end = None
      for base in sorted(bases):
        count, stamp, path = bases[base]
        if prev_end is not None and base != prev_end:
          runs.append(run)
          run = []
        run.append((stamp, path, count))
        prev_end = base + count
      if run:
        runs.append(run)
    runs.sort(key=lambda run: max(s for s, _, _ in run), reverse=True)
    chosen = []
    total = 0
    for run in runs:
      items = max(0, sum(c for _, _, c in run) - self.length + 1)
      if total + items > amount:
        # Trim the oldest shards of this run so only the newest ~amount
        # items rehydrate (suffixes of a run stay contiguous).
        keep, kept = [], 0
        for shard in reversed(run):
          keep.insert(0, shard)
          kept += shard[2]
          if kept - self.length + 1 >= amount - total:
            break
        run = keep
        items = max(0, kept - self.length + 1)
      chosen.append(run)
      total += items
      if total >= amount:
        break
    with ThreadPoolExecutor(16, 'replay_loader') as pool:
      loaded = list(pool.map(self._read_run, chosen))
    with self.rwlock.reading:
      for parts in reversed(loaded):  # Oldest runs first.
        self._rehydrate(parts)

  @staticmethod
  def _read_run(run):
    parts = []
    for _, path, count in run:
      try:
        with path.open('rb') as f:
          arrs = np.load(f)
          parts.append({k: arrs[k] for k in arrs.files})
      except Exception as e:
        print(f'Skipping corrupt replay shard {path.name} ({e})')
        parts.append(None)  # Splits the run on rehydrate.
    return parts

  def _rehydrate(self, parts):
    """Append loaded columns as fresh lanes; a corrupt shard splits the
    contiguous run into separate lanes so sequences never bridge a gap."""
    lane = None
    for cols in parts:
      if cols is None:
        lane = None
        continue
      if lane is None:
        lane = self._new_lane()
      n = len(next(iter(cols.values())))
      for t in range(n):
        step = {k: v[t] for k, v in cols.items() if k != 'stepid'}
        pos = self.ends[lane]
        step['stepid'] = packids(lane, [pos])[0]
        segs = self.lanes[lane]
        idx = pos // self.segcap
        seg = segs.get(idx)
        if seg is None:
          seg = segs[idx] = Segment(idx * self.segcap, self.segcap)
        seg.append(step, self._slabs)
        self.ends[lane] = pos + 1
        start = pos + 1 - self.length
        if start >= 0:
          self._insert(lane, start)
      # Freshly loaded data counts as persisted already.
      for seg in self.lanes[lane].values():
        seg.saved_count = seg.count
