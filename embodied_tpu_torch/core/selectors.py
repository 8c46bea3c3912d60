"""Replay sampling strategies over item ids.

A copy of embodied_tpu/core/selectors.py.

Capability parity: the reference's embodied/core/selectors.py (Fifo, Uniform,
Recency, Prioritized, Mixture, SampleTree). The weighted sampling tree here
is a from-scratch *vectorized* design: levels are flat numpy arrays with
branching factor 64, descended with batched cumsum+searchsorted, rather than
a pointer tree of Python node objects. Updates are O(log n); batched draws
amortize numpy call overhead across the whole batch.
"""

import threading
from collections import defaultdict, deque

import numpy as np


class Fifo:
  """Sample in insertion order (queue semantics)."""

  def __init__(self):
    self.queue = deque()
    self.items = set()

  def __len__(self):
    return len(self.queue)

  def __setitem__(self, itemid, stepids):
    self.queue.append(itemid)
    self.items.add(itemid)

  def __delitem__(self, itemid):
    self.items.discard(itemid)
    # Lazy deletion; popped when sampled.
    if self.queue and self.queue[0] == itemid:
      self.queue.popleft()

  def __call__(self):
    while self.queue:
      itemid = self.queue[0]
      if itemid in self.items:
        # Rotate so repeated sampling cycles through the queue.
        self.queue.rotate(-1)
        return itemid
      self.queue.popleft()
    raise IndexError('Cannot sample from empty Fifo')


class Uniform:
  """O(1) insert/remove/sample via swap-delete on a dense array."""

  def __init__(self, seed=0):
    self.ids = []
    self.positions = {}
    self.rng = np.random.default_rng(seed)
    self.lock = threading.Lock()

  def __len__(self):
    return len(self.ids)

  def __setitem__(self, itemid, stepids):
    with self.lock:
      self.positions[itemid] = len(self.ids)
      self.ids.append(itemid)

  def __delitem__(self, itemid):
    with self.lock:
      pos = self.positions.pop(itemid)
      last = self.ids.pop()
      if pos < len(self.ids):
        self.ids[pos] = last
        self.positions[last] = pos

  def __call__(self):
    with self.lock:
      assert self.ids, 'Cannot sample from empty Uniform selector'
      index = int(self.rng.integers(0, len(self.ids)))
      return self.ids[index]

  def sample_batch(self, n):
    with self.lock:
      assert self.ids, 'Cannot sample from empty Uniform selector'
      idx = self.rng.integers(0, len(self.ids), size=n)
      return [self.ids[i] for i in idx]


class SampleTree:
  """Weighted sampling with O(log n) updates and vectorized batched draws.

  Flat-array layered tree: leaves hold weights, each internal level holds
  block sums of the level below with branching factor `branching`. Sampling
  descends from the root using cumsum + searchsorted, vectorized across all
  requested samples at once.
  """

  def __init__(self, branching=64, seed=0):
    self.branching = int(branching)
    self.rng = np.random.default_rng(seed)
    self.capacity = self.branching
    self.leaves = np.zeros(self.capacity, np.float64)
    self.levels = self._build_levels()
    self.free = list(range(self.capacity - 1, -1, -1))
    self.slot_of = {}   # key -> leaf slot
    self.key_of = {}    # leaf slot -> key
    self.lock = threading.Lock()

  def _build_levels(self):
    levels = []
    size = self.capacity
    current = self.leaves
    while size > 1:
      size = -(-size // self.branching)
      parent = np.zeros(size, np.float64)
      # Recompute block sums.
      padded = np.zeros(size * self.branching, np.float64)
      padded[:len(current)] = current
      parent[:] = padded.reshape(size, self.branching).sum(1)
      levels.append(current)
      current = parent
    levels.append(current)
    return levels  # levels[0] = leaves ... levels[-1] = root

  def __len__(self):
    return len(self.slot_of)

  @property
  def total(self):
    return float(self.levels[-1][0])

  def _grow(self):
    old_leaves = self.leaves
    old_capacity = self.capacity
    self.capacity *= self.branching
    self.leaves = np.zeros(self.capacity, np.float64)
    self.leaves[:old_capacity] = old_leaves
    self.levels = self._build_levels()
    self.free.extend(range(self.capacity - 1, old_capacity - 1, -1))

  def insert(self, key, weight):
    with self.lock:
      if not self.free:
        self._grow()
      slot = self.free.pop()
      self.slot_of[key] = slot
      self.key_of[slot] = key
      self._set(slot, float(weight))

  def update(self, key, weight):
    with self.lock:
      slot = self.slot_of[key]
      self._set(slot, float(weight))

  def remove(self, key):
    with self.lock:
      slot = self.slot_of.pop(key)
      del self.key_of[slot]
      self._set(slot, 0.0)
      self.free.append(slot)

  def get(self, key):
    with self.lock:
      return float(self.leaves[self.slot_of[key]])

  def _set(self, slot, weight):
    delta = weight - self.leaves[slot]
    index = slot
    self.leaves[slot] = weight
    for level in self.levels[1:]:
      index //= self.branching
      level[index] += delta

  def sample(self, n=1):
    with self.lock:
      total = self.levels[-1][0]
      assert total > 0, 'Cannot sample from empty SampleTree'
      targets = self.rng.random(n) * total
      index = np.zeros(n, np.int64)
      # Descend from root to leaves, vectorized over all samples.
      for level in reversed(self.levels[:-1]):
        base = index * self.branching
        gather = base[:, None] + np.arange(self.branching)[None, :]
        valid = gather < len(level)
        blocks = np.where(valid, level[np.minimum(gather, len(level) - 1)], 0)
        cums = np.cumsum(blocks, 1)
        child = (targets[:, None] >= cums).sum(1)
        child = np.minimum(child, self.branching - 1)
        offset = np.where(
            child > 0, np.take_along_axis(cums, np.maximum(
                child[:, None] - 1, 0), 1)[:, 0], 0.0)
        targets = targets - offset
        index = base + child
      keys = []
      for slot in index:
        # Numerical edge: if we landed on a freed slot, fall back to a
        # uniform choice among live slots.
        key = self.key_of.get(int(slot))
        if key is None:
          key = next(iter(self.slot_of))
        keys.append(key)
      return keys


class Recency:
  """Sample recent items more often according to an age distribution.

  Capability parity with the reference's Recency selector: a power-law over
  item age (uncertainty exponent `exp`), implemented here over the
  vectorized SampleTree with periodic reweighting.
  """

  def __init__(self, uprobs_or_exp=1.0, seed=0, refresh=1024):
    if np.isscalar(uprobs_or_exp):
      self.exp = float(uprobs_or_exp)
      self.uprobs = None
    else:
      self.uprobs = np.asarray(uprobs_or_exp, np.float64)
      self.exp = None
    self.tree = SampleTree(seed=seed)
    self.order = deque()  # itemids oldest..newest
    self.present = set()
    self.counter = 0
    self.refresh = refresh

  def __len__(self):
    return len(self.tree)

  def _weight(self, age, count):
    # age: 0 = newest.
    if self.uprobs is not None:
      idx = min(age, len(self.uprobs) - 1)
      return float(self.uprobs[idx])
    return float((age + 1.0) ** (-self.exp))

  def __setitem__(self, itemid, stepids):
    self.order.append(itemid)
    self.present.add(itemid)
    self.tree.insert(itemid, 1.0)  # Newest weight; refreshed periodically.
    self.counter += 1
    if self.counter % self.refresh == 0:
      self._reweight()

  def __delitem__(self, itemid):
    self.present.discard(itemid)
    self.tree.remove(itemid)
    while self.order and self.order[0] not in self.present:
      self.order.popleft()

  def _reweight(self):
    live = [x for x in self.order if x in self.present]
    count = len(live)
    for age, itemid in enumerate(reversed(live)):
      self.tree.update(itemid, self._weight(age, count))

  def __call__(self):
    return self.tree.sample(1)[0]

  def sample_batch(self, n):
    return self.tree.sample(n)


class Prioritized:
  """Priority-weighted sampling with per-step priority aggregation.

  Capability parity: the reference's embodied/core/selectors.py:128-197.
  Each item covers `length` consecutive steps; the item weight is
  (maxfrac * max + (1 - maxfrac) * mean of its step priorities) ** exponent.
  """

  def __init__(
      self, exponent=1.0, initial=1.0, zero_on_sample=False,
      maxfrac=0.0, branching=64, seed=0):
    self.exponent = float(exponent)
    self.initial = float(initial)
    self.zero_on_sample = zero_on_sample
    self.maxfrac = float(maxfrac)
    self.tree = SampleTree(branching, seed)
    self.prios = {}            # stepid bytes -> priority
    self.stepitems = defaultdict(list)  # stepid bytes -> itemids
    self.items = {}            # itemid -> array of stepid bytes
    self.lock = threading.Lock()

  def __len__(self):
    return len(self.items)

  def __setitem__(self, itemid, stepids):
    stepids = [bytes(x) for x in np.asarray(stepids)]
    with self.lock:
      self.items[itemid] = stepids
      for stepid in stepids:
        self.stepitems[stepid].append(itemid)
        if stepid not in self.prios:
          self.prios[stepid] = self.initial
    self.tree.insert(itemid, self._aggregate(stepids))

  def __delitem__(self, itemid):
    with self.lock:
      stepids = self.items.pop(itemid)
      for stepid in stepids:
        owners = self.stepitems[stepid]
        owners.remove(itemid)
        if not owners:
          del self.stepitems[stepid]
          self.prios.pop(stepid, None)
    self.tree.remove(itemid)

  def prioritize(self, stepids, priorities):
    stepids = [bytes(x) for x in np.asarray(stepids)]
    touched = set()
    with self.lock:
      for stepid, prio in zip(stepids, priorities):
        if stepid in self.prios:
          self.prios[stepid] = float(prio)
          touched.update(self.stepitems[stepid])
      updates = {i: self._aggregate(self.items[i]) for i in touched
                 if i in self.items}
    for itemid, weight in updates.items():
      self.tree.update(itemid, weight)

  def _aggregate(self, stepids):
    prios = np.array([self.prios[s] for s in stepids], np.float64)
    finite = prios[np.isfinite(prios)]
    maxval = np.float64(np.inf) if len(finite) < len(prios) else finite.max(
        initial=0.0)
    mean = finite.mean() if len(finite) == len(prios) and len(finite) else (
        np.inf)
    value = self.maxfrac * maxval + (1 - self.maxfrac) * mean
    if not np.isfinite(value):
      value = 1e9  # Large but finite so the tree stays numeric.
    return float(value) ** self.exponent

  def __call__(self):
    itemid = self.tree.sample(1)[0]
    if self.zero_on_sample:
      stepids = self.items[itemid]
      self.prioritize(stepids, np.zeros(len(stepids)))
    return itemid

  def sample_batch(self, n):
    return [self() for _ in range(n)]


class Mixture:
  """Weighted mixture over sub-selectors; inserts into all of them."""

  def __init__(self, selectors, fractions, seed=0):
    assert set(selectors.keys()) == set(fractions.keys())
    fractions = {k: v for k, v in fractions.items() if v > 0}
    weights = np.array([fractions[k] for k in sorted(fractions)], np.float64)
    self.probs = weights / weights.sum()
    self.keys = sorted(fractions.keys())
    self.selectors = {k: selectors[k] for k in self.keys}
    self.all_selectors = selectors
    self.rng = np.random.default_rng(seed)

  def __len__(self):
    return min(len(s) for s in self.selectors.values())

  def __setitem__(self, itemid, stepids):
    for selector in self.all_selectors.values():
      selector[itemid] = stepids

  def __delitem__(self, itemid):
    for selector in self.all_selectors.values():
      del selector[itemid]

  def prioritize(self, stepids, priorities):
    for selector in self.all_selectors.values():
      if hasattr(selector, 'prioritize'):
        selector.prioritize(stepids, priorities)

  def __call__(self):
    index = self.rng.choice(len(self.keys), p=self.probs)
    return self.selectors[self.keys[index]]()
