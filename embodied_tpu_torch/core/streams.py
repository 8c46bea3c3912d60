"""Resumable data pipelines feeding the learner.

A copy of embodied_tpu/core/streams.py, with `Prefetch.close` and `close`
added: a finished run stops its prefetch threads.

Capability match for the reference's embodied/core/streams.py (Stateless,
Prefetch, Consec, Zip, Map, Mixer), rebuilt on a shared combinator base:
child streams are started together and their states compose with the
combinator's own cursor into one checkpointable blob. The prefetcher uses a
bounded queue plus an epoch tag (stale in-flight batches are discarded on
load) instead of semaphore bookkeeping.
"""

import functools
import queue
import threading

import numpy as np

from ..utils import timer, tree
from . import base


def _state_of(stream):
  return stream.save() if hasattr(stream, 'save') else None


def _restore(stream, state):
  if hasattr(stream, 'load'):
    stream.load(state)


class Stateless(base.Stream):
  """Wraps a sampling callable (or iterator) with no resumable state."""

  def __init__(self, nextfn, *args, **kwargs):
    if not callable(nextfn) and hasattr(nextfn, '__next__'):
      nextfn = nextfn.__next__
    self.nextfn = functools.partial(nextfn, *args, **kwargs)

  def __iter__(self):
    return self

  def __next__(self):
    return self.nextfn()

  def save(self):
    return None

  def load(self, data):
    pass


class Combinator(base.Stream):
  """Shared plumbing for streams built from child streams.

  Children are materialized as iterators on first use; `save()` composes
  every child's state with this stream's own `cursor()`, and `load()`
  restores both sides."""

  def __init__(self, *sources):
    self.sources = list(sources)
    self._its = None

  def children(self):
    if self._its is None:
      self._its = [iter(s) for s in self.sources]
      self.begin()
    return self._its

  def __iter__(self):
    self.children()
    return self

  def begin(self):
    pass

  def cursor(self):
    return None

  def seek(self, cursor):
    pass

  def save(self):
    streams = self._its if self._its is not None else self.sources
    return {
        'children': [_state_of(s) for s in streams],
        'cursor': self.cursor(),
    }

  def load(self, state):
    streams = self._its if self._its is not None else self.sources
    for stream, sub in zip(streams, state['children']):
      _restore(stream, sub)
    self.seek(state['cursor'])


class Prefetch(base.Stream):
  """Runs the source on a daemon thread, keeping up to `amount` batches
  ready. Backpressure comes from the queue bound itself. Each prefetched
  batch carries the source state at production time, so `save()` after
  consuming batch N resumes exactly after batch N — in-flight batches are
  re-produced, not lost. `load()` bumps an epoch counter; batches
  produced under an older epoch are discarded on arrival. `close()`
  stops the producer (unlike the JAX package's, which waits on its full
  queue for as long as the process lives)."""

  def __init__(self, source, transform=None, amount=1):
    self.source = iter(source) if hasattr(source, '__iter__') else source()
    self.transform = transform or (lambda x: x)
    self.buffer = queue.Queue(maxsize=amount)
    self.epoch = 0
    self.state = _state_of(self.source)
    self.lock = threading.Lock()  # Guards source access + epoch reads.
    self.thread = None
    self.stopped = threading.Event()
    self.sourcing = False  # The producer is inside next(source).

  def _ensure_started(self):
    if self.thread is None:
      self.thread = threading.Thread(
          target=self._produce, daemon=True, name='prefetch')
      self.thread.start()

  def __iter__(self):
    self._ensure_started()
    return self

  def __next__(self):
    self._ensure_started()
    while True:
      with timer.section('stream/wait'):
        item = self.buffer.get()
      if isinstance(item, BaseException):
        raise RuntimeError(str(item)) from item
      epoch, data, state = item
      if epoch != self.epoch:
        continue  # Produced before the last load(); stale.
      self.state = state
      return data

  def save(self):
    return self.state

  def load(self, state):
    with self.lock:
      self.epoch += 1
      # Drop anything buffered before restoring: everything in the buffer
      # (and anything the producer is blocked trying to enqueue) carries
      # the old epoch tag and would be discarded on arrival anyway.
      while True:
        try:
          self.buffer.get_nowait()
        except queue.Empty:
          break
      _restore(self.source, state)
      self.state = state

  def close(self):
    """Stop the producer. One that is making a batch ends once it has
    (its put rechecks the flag); one that waits inside its source, such
    as an empty replay, is not waited for: it is a daemon, holds nothing
    of the run's (agent.stream holds the agent weakly), and ends when its
    source returns."""
    self.stopped.set()
    while self.thread is not None and self.thread.is_alive():
      if self.sourcing:
        return
      self.thread.join(0.05)

  def _put(self, item):
    # A bounded put that rechecks the stop flag: a consumer that is gone
    # never takes from the full queue.
    while not self.stopped.is_set():
      try:
        self.buffer.put(item, timeout=0.1)
        return
      except queue.Full:
        pass

  def _produce(self):
    try:
      while not self.stopped.is_set():
        with self.lock:
          epoch = self.epoch
          self.sourcing = True
          try:
            data = next(self.source)
          finally:
            self.sourcing = False
          state = _state_of(self.source)
        self._put((epoch, self.transform(data), state))
    except BaseException as e:
      self._put(e)


def close(*streams):
  """Stop the producer threads of the streams that have one (Prefetch);
  other streams have nothing to stop."""
  for stream in streams:
    if hasattr(stream, 'close'):
      stream.close()


class Consec(Combinator):
  """Cuts sampled super-sequences into consecutive training chunks.

  The source yields [B, consec*length + prefix] windows; each call emits
  one [B, length + prefix] chunk whose first `prefix` steps overlap the
  previous chunk (replay context), plus a 'consec' column holding the
  chunk index — index 0 marks a fresh window, so the agent knows when a
  stored-latent resume is NOT applicable.
  """

  def __init__(
      self, source, length, consec, prefix=0, strict=True, contiguous=False):
    super().__init__(source)
    self.length = length
    self.consec = consec
    self.prefix = prefix
    self.strict = strict
    self.contiguous = contiguous
    self.window = None
    self.todo = []  # Pending chunk indices for the current window.

  def begin(self):
    self.window = None
    self.todo = []

  def __next__(self):
    (source,) = self.children()
    if not self.todo:
      self.window = next(source)
      steps = self.window['is_first'].shape[1]
      need = self.consec * self.length + self.prefix
      if self.strict:
        assert steps == need, (steps, self.length, self.consec, self.prefix)
      else:
        assert steps >= need, (steps, self.length, self.consec, self.prefix)
      self.todo = list(range(self.consec))
    index = self.todo.pop(0)
    lo = index * self.length
    hi = lo + self.length + self.prefix
    chunk = {k: v[:, lo:hi] for k, v in self.window.items()}
    chunk['consec'] = np.full(
        chunk['is_first'].shape, index, np.int32)
    if self.contiguous:
      chunk = {k: np.ascontiguousarray(v) for k, v in chunk.items()}
    return chunk

  def cursor(self):
    return {'todo': list(self.todo)}

  def seek(self, cursor):
    # The window itself is not checkpointed; if the run stopped mid-window
    # the remaining chunk indices are replayed against a freshly sampled
    # window, preserving the chunk cadence.
    self.todo = list(cursor['todo'])
    if self.todo:
      (source,) = self.children()
      self.window = next(source)


class Zip(Combinator):
  """Merges parallel sources by concatenating along the batch axis."""

  def __init__(self, sources):
    assert len(sources) > 1, len(sources)
    super().__init__(*sources)

  def __next__(self):
    parts = [next(it) for it in self.children()]
    return tree.tree_map(lambda *xs: np.concatenate(xs), *parts)


class Map(Combinator):
  """Applies a function to every batch."""

  def __init__(self, source, fn, *args, **kwargs):
    super().__init__(source)
    self.fn = lambda x: fn(x, *args, **kwargs)

  def __next__(self):
    (source,) = self.children()
    return self.fn(next(source))


class Mixer(Combinator):
  """Each batch comes from one source, drawn by normalized weight. The
  draw is a counter-seeded hash, so resuming from a checkpoint replays
  the identical source schedule."""

  def __init__(self, sources, weights, seed=0):
    assert sources.keys() == weights.keys(), (sources, weights)
    self.names = sorted(sources)
    super().__init__(*(sources[k] for k in self.names))
    w = np.array([weights[k] for k in self.names], np.float64)
    self.probs = w / w.sum()
    self.seed = seed
    self.count = 0

  def __next__(self):
    rng = np.random.default_rng([self.seed, self.count])
    self.count += 1
    pick = rng.choice(len(self.names), p=self.probs)
    return next(self.children()[pick])

  def cursor(self):
    return {'count': self.count, 'seed': self.seed}

  def seek(self, cursor):
    self.count = cursor['count']
    self.seed = cursor['seed']
