"""Hierarchy-free section timer usable as decorator or context manager: the
port's one span API.

A copy of embodied_tpu/utils/timer.py, with spans on the device trace's
clock: while `torch.profiler` records on the calling thread, a section
also opens a profiler range of its name, so that the trace shows where
the host was when the card worked or waited. With the profiler off a
section costs its two clock reads and a check of the thread's profiler
flag, and enters no `record_function`.

- `section(name)`: host totals and counts (the operator's `timer/...`
  log through `stats()`), and the range while profiling;
- `range(name)`: the range alone, for the kernel wrappers and other
  places the host totals would not serve;
- `totals()`: every section's seconds and count since the process
  started, without the reset `stats()` makes, for readers that take the
  difference of two snapshots;
- `untraced()`: the same since the profiler last stopped recording a
  thread that enters sections: the untraced stretch after a traced one,
  whose host times the profiler's own recording did not slow.

Capability parity: elements.timer.section (57 call sites in the reference,
e.g. the reference's embodied/core/replay.py:76) and timer.stats()['summary']
(the reference's embodied/run/train.py:112).
"""

import contextlib
import functools
import threading
import time
from collections import defaultdict

import torch

_LOCK = threading.Lock()
_ENABLED = [True]
_TIMES = defaultdict(float)
_COUNTS = defaultdict(int)
# What `stats(reset=True)` last took away: its numbers start from here.
_BASE = [{}, {}]
# The totals when a thread first entered a section after the profiler
# stopped recording it (`untraced`), and whether each thread's last
# section was recorded.
_MARK = [None]
_LOCAL = threading.local()
_START = [time.perf_counter()]
_NULL = contextlib.nullcontext()

# True on a thread that torch.profiler records, including the autograd
# engine's device threads inside a backward that a recorded thread began.
profiling = torch._C._autograd._profiler_enabled


def enable(value=True):
  _ENABLED[0] = bool(value)


def section(name):
  """Use as `with timer.section('x'):` or `@timer.section('x')`."""
  return _Section(name)


def range(name):  # noqa: A001 (the module's API: timer.range)
  """A profiler range named `name` while the profiler records on this
  thread, else nothing: `with timer.range('x'):`."""
  if profiling():
    return torch.profiler.record_function(name)
  return _NULL


class _Section(contextlib.ContextDecorator):

  def __init__(self, name):
    self.name = name
    self._t0 = None
    self._range = None

  def __enter__(self):
    if _recording():
      self._range = torch.profiler.record_function(self.name)
      self._range.__enter__()
    if _ENABLED[0]:
      self._t0 = time.perf_counter()
    return self

  def __exit__(self, *exc):
    if self._t0 is not None:
      dt = time.perf_counter() - self._t0
      with _LOCK:
        _TIMES[self.name] += dt
        _COUNTS[self.name] += 1
    if self._range is not None:
      self._range.__exit__(*exc)
    return False

  def __call__(self, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
      with _Section(self.name):
        return fn(*args, **kwargs)
    return wrapper


def _recording():
  """Whether the profiler records this thread; where it just stopped,
  marks the totals that `untraced` starts from."""
  if profiling():
    _LOCAL.traced = True
    return True
  if getattr(_LOCAL, 'traced', False):
    _LOCAL.traced = False
    with _LOCK:
      _MARK[0] = (dict(_TIMES), dict(_COUNTS))
  return False


def untraced():
  """{name: (seconds, count)} of the sections since the profiler last
  stopped recording a thread that then entered a section, or None where
  it never did."""
  with _LOCK:
    if _MARK[0] is None:
      return None
    times, counts = _MARK[0]
    return {name: (_TIMES[name] - times.get(name, 0.0),
                   _COUNTS[name] - counts.get(name, 0))
            for name in _COUNTS if _COUNTS[name] != counts.get(name, 0)}


def totals():
  """{name: (seconds, count)} of every section since the process started;
  `stats()` resets none of it."""
  with _LOCK:
    return {name: (_TIMES[name], _COUNTS[name]) for name in _COUNTS}


def stats(reset=True, log=False):
  with _LOCK:
    total = time.perf_counter() - _START[0]
    base_times, base_counts = _BASE
    counts = {k: v - base_counts.get(k, 0) for k, v in _COUNTS.items()}
    counts = {k: v for k, v in counts.items() if v}
    times = {k: _TIMES[k] - base_times.get(k, 0.0) for k in counts}
    if reset:
      _BASE[:] = [dict(_TIMES), dict(_COUNTS)]
      _START[0] = time.perf_counter()
  metrics = {}
  lines = ['Timer:']
  for name in sorted(times, key=lambda k: -times[k]):
    frac = times[name] / max(total, 1e-8)
    avg = times[name] / max(counts[name], 1)
    metrics[f'{name}/frac'] = frac
    metrics[f'{name}/avg'] = avg
    metrics[f'{name}/total'] = times[name]
    lines.append(f'  {name}: {100 * frac:.1f}% avg {1000 * avg:.2f}ms '
                 f'x{counts[name]}')
  summary = '\n'.join(lines)
  metrics['summary'] = summary
  if log:
    print(summary)
  return metrics
