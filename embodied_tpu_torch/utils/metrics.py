"""Metric aggregation helpers: Agg, FPS, Counter, Usage, RWLock.

A copy of embodied_tpu/utils/metrics.py.

Capability parity: elements.{Agg,FPS,Counter,Usage,RWLock} as used in
the reference's embodied/run/train.py:19-24,33-54 and core/replay.py:37.
"""

import threading
import time

import numpy as np


class Counter:

  def __init__(self, initial=0):
    self.value = int(initial)
    self._lock = threading.Lock()

  def __int__(self):
    return self.value

  def __index__(self):
    return self.value

  def __eq__(self, other):
    return self.value == int(other)

  def __ne__(self, other):
    return self.value != int(other)

  def __lt__(self, other):
    return self.value < int(other)

  def __le__(self, other):
    return self.value <= int(other)

  def __gt__(self, other):
    return self.value > int(other)

  def __ge__(self, other):
    return self.value >= int(other)

  def __add__(self, other):
    return self.value + int(other)

  def __mod__(self, other):
    return self.value % int(other)

  def __repr__(self):
    return f'Counter({self.value})'

  def increment(self, amount=1):
    with self._lock:
      self.value += int(amount)
    return self.value

  def save(self):
    return self.value

  def load(self, value):
    self.value = int(value)


class Agg:
  """Aggregates named metrics between result() calls.

  Supported aggs: 'avg' (default), 'sum', 'max', 'min', 'last', 'stack',
  or a tuple of several, producing suffixed keys.
  """

  def __init__(self, maxlen=int(1e6)):
    self._lock = threading.Lock()
    self._aggs = {}
    self._state = {}
    self._maxlen = maxlen

  def __len__(self):
    return len(self._state)

  def reset(self):
    with self._lock:
      self._state.clear()
      self._aggs.clear()

  def add(self, key, value=None, agg='avg', prefix=None):
    if isinstance(key, dict):
      assert value is None
      for k, v in key.items():
        self.add(k, v, agg=agg, prefix=prefix)
      return
    if prefix:
      key = f'{prefix}/{key}'
    value = np.asarray(value)
    # Media (images/videos) pass through with 'last' semantics.
    if value.ndim >= 3 and agg == 'avg':
      agg = 'last'
    with self._lock:
      self._aggs[key] = agg
      aggs = agg if isinstance(agg, tuple) else (agg,)
      state = self._state.setdefault(key, {})
      for mode in aggs:
        if mode == 'avg':
          total, count = state.get('avg', (0.0, 0))
          state['avg'] = (total + np.float64(value.astype(np.float64).mean()
                          if value.ndim else value), count + 1)
        elif mode == 'sum':
          state['sum'] = state.get('sum', 0.0) + np.float64(
              value.astype(np.float64).sum() if value.ndim else value)
        elif mode == 'max':
          prev = state.get('max')
          state['max'] = value if prev is None else np.maximum(prev, value)
        elif mode == 'min':
          prev = state.get('min')
          state['min'] = value if prev is None else np.minimum(prev, value)
        elif mode == 'last':
          state['last'] = value
        elif mode == 'stack':
          stack = state.setdefault('stack', [])
          if len(stack) < self._maxlen:
            stack.append(value)
        else:
          raise NotImplementedError(mode)

  def result(self, reset=True):
    with self._lock:
      output = {}
      for key, state in self._state.items():
        agg = self._aggs[key]
        multi = isinstance(agg, tuple)
        for mode, value in state.items():
          name = f'{key}/{mode}' if multi else key
          if mode == 'avg':
            total, count = value
            output[name] = total / max(count, 1)
          elif mode == 'stack':
            output[name] = np.stack(value) if value else np.array([])
          else:
            output[name] = value
      if reset:
        self._state.clear()
        self._aggs.clear()
      return output


class FPS:
  """Rate counter: steps per second since the last result() call."""

  def __init__(self):
    self._lock = threading.Lock()
    self._count = 0
    self._start = time.perf_counter()

  def step(self, amount=1):
    with self._lock:
      self._count += amount

  def result(self, reset=True):
    with self._lock:
      now = time.perf_counter()
      elapsed = now - self._start
      value = self._count / elapsed if elapsed > 0 else 0.0
      if reset:
        self._count = 0
        self._start = now
      return value


class Usage:
  """Host resource statistics (psutil-gated)."""

  def __init__(self, psutil=True, nvsmi=False, gputil=False, malloc=False,
               gc=False, **kwargs):
    self._psutil = None
    if psutil:
      try:
        import psutil as _psutil
        self._psutil = _psutil
        self._proc = _psutil.Process()
      except ImportError:
        pass

  def stats(self):
    stats = {}
    if self._psutil:
      mem = self._psutil.virtual_memory()
      stats['ram_gb'] = (mem.total - mem.available) / (1024 ** 3)
      stats['ram_frac'] = mem.percent / 100
      stats['proc_ram_gb'] = self._proc.memory_info().rss / (1024 ** 3)
      stats['cpu_frac'] = self._psutil.cpu_percent() / 100
    return stats


class RWLock:
  """Reader-writer lock: many readers or one writer."""

  def __init__(self):
    self._cond = threading.Condition()
    self._readers = 0
    self._writer = False

  @property
  def reading(self):
    return _Reading(self)

  @property
  def writing(self):
    return _Writing(self)


class _Reading:

  def __init__(self, lock):
    self._lock = lock

  def __enter__(self):
    with self._lock._cond:
      while self._lock._writer:
        self._lock._cond.wait()
      self._lock._readers += 1

  def __exit__(self, *exc):
    with self._lock._cond:
      self._lock._readers -= 1
      if not self._lock._readers:
        self._lock._cond.notify_all()


class _Writing:

  def __init__(self, lock):
    self._lock = lock

  def __enter__(self):
    with self._lock._cond:
      while self._lock._writer or self._lock._readers:
        self._lock._cond.wait()
      self._lock._writer = True

  def __exit__(self, *exc):
    with self._lock._cond:
      self._lock._writer = False
      self._lock._cond.notify_all()
