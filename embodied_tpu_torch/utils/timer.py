"""Hierarchy-free section timer usable as decorator or context manager.

A copy of embodied_tpu/utils/timer.py.

Capability parity: elements.timer.section (57 call sites in the reference,
e.g. the reference's embodied/core/replay.py:76) and timer.stats()['summary']
(the reference's embodied/run/train.py:112).
"""

import contextlib
import functools
import threading
import time
from collections import defaultdict

_LOCK = threading.Lock()
_ENABLED = [True]
_TIMES = defaultdict(float)
_COUNTS = defaultdict(int)
_START = [time.perf_counter()]


def enable(value=True):
  _ENABLED[0] = bool(value)


def section(name):
  """Use as `with timer.section('x'):` or `@timer.section('x')`."""
  return _Section(name)


class _Section(contextlib.ContextDecorator):

  def __init__(self, name):
    self.name = name
    self._t0 = None

  def __enter__(self):
    if _ENABLED[0]:
      self._t0 = time.perf_counter()
    return self

  def __exit__(self, *exc):
    if _ENABLED[0] and self._t0 is not None:
      dt = time.perf_counter() - self._t0
      with _LOCK:
        _TIMES[self.name] += dt
        _COUNTS[self.name] += 1
    return False

  def __call__(self, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
      with _Section(self.name):
        return fn(*args, **kwargs)
    return wrapper


def wrap(name, obj, methods):
  """Wrap methods of an object with sections named name.method."""
  for method in methods:
    fn = getattr(obj, method)
    setattr(obj, method, _Section(f'{name}.{method}')(fn))


def stats(reset=True, log=False):
  with _LOCK:
    total = time.perf_counter() - _START[0]
    times = dict(_TIMES)
    counts = dict(_COUNTS)
    if reset:
      _TIMES.clear()
      _COUNTS.clear()
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
