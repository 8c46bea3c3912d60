"""The program's own spans, as a traced run of a cell reads them.

The port opens its spans through its timer (`embodied_tpu_torch/utils/
timer.py`): sections with host totals, which while torch.profiler records
a thread also open profiler ranges of their names, and ranges alone
around the kernel wrappers and `train#<step>`.

- Host: `host_ms(record, driver, name, per)` reads the timer's sections
  over the untraced rest of a traced run's window (`timer.untraced()`,
  the totals since the tracer stopped), in the process that ran the cell:
  the mean ms of section `name` per call, or per call of section `per`.
  It reads None from a program whose timer has no such totals.
- Device: `SpanTracer`, the cells' Tracer (harness/trace.py) whose summary
  also reduces the trace by the program's spans (`reduce`). The cells'
  drivers (harness/learn.py, harness/script.py) make `trace.Tracer`;
  `benchmark/trace_spans.py` runs a cell with this one.
"""

import bisect
import re
import sys

from . import stats, trace

PORT_TIMER = 'embodied_tpu_torch.utils.timer'
# The CUDA runtime's and driver's calls on the host (cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, ...): the profiler gives each the
# correlation id of the device work it started.
RUNTIME = re.compile(r'cu(da)?[A-Z]')


def untraced():
  """{section: (seconds, count)} of the port's timer since the profiler
  last stopped, or None."""
  totals = getattr(sys.modules.get(PORT_TIMER), 'untraced', None)
  return totals() if totals else None


def host_ms(record, driver, name, per=None):
  """Mean host ms of the program's section `name` per call of it (or of
  section `per`) after the tracer stopped, in a traced run of `driver`."""
  if record.get('driver') != driver or not record.get('trace'):
    return None
  spans = untraced()
  if not spans or name not in spans:
    return None
  seconds, count = spans[name]
  if per is not None:
    count = spans.get(per, (0.0, 0))[1]
  return 1e3 * seconds / count if count else None


class SpanTracer(trace.Tracer):
  """The cells' Tracer, whose summary adds `reduce`'s fields and names
  each idle gap by the program's span too."""

  def summary(self, labels):
    out = super().summary(labels)
    if out is not None:
      out.update(reduce(self.prof.events(), labels))
    return out


def reduce(events, labels):
  """The trace by the program's spans: the profiler ranges on the host
  that the benchmark did not open, `train#<n>` counted as `train#`.

  - `spans`: for each, its calls and the device time (the union of the
    work's intervals) and the kernels of the work launched while one was
    open, on any host thread: each device operation counts at the host
    time of the runtime call that launched it, so the backward's kernels,
    which the autograd engine's thread launches while the calling thread
    waits in `train/backward`, count there;
  - `launches`: the kernels in the trace (copies and fills left out);
  - `unplaced_us`: the device time of work whose launching call the
    trace lacks;
  - `idle_gaps`: harness/trace.py's gaps, each label followed by the
    innermost program span open on the host when the gap began.
  """
  device, bench, program, launched = [], [], [], {}
  for ev in events:
    start, end = ev.time_range.start, ev.time_range.end
    if trace._on_device(ev):
      device.append((start, end, ev))
    elif ev.name.startswith('bench/'):
      bench.append((start, end, ev.name))
    elif getattr(ev, 'is_user_annotation', False):
      program.append((start, end, span_name(ev.name)))
    elif RUNTIME.match(ev.name):
      launched[ev.id] = start
  names = {ev.name for ev in events if not trace._on_device(ev) and
           getattr(ev, 'is_user_annotation', False)}
  work = [(s, e, ev) for s, e, ev in device
          if not (trace._annotation(ev) or ev.name in names)]
  if not work or not bench:
    return {}
  opened = _Opened(program)
  placed = {name: [] for name in opened.names}
  kernels = dict.fromkeys(opened.names, 0)
  unplaced = 0.0
  for start, end, ev in work:
    at = launched.get(ev.id)
    if at is None:
      unplaced += end - start
      continue
    for name, _ in opened.at(at):
      placed[name].append((start, end))
      kernels[name] += _kernel(ev.name)
  begin = min(s for s, _, _ in bench)
  end = max(max(e for _, e, _ in bench), max(e for _, e, _ in work))
  intervals = [(s, e) for s, e, _ in work]
  gaps = []
  for start, length in stats.gaps(intervals, begin, end)[:trace.TOP]:
    label = 'host outside the benchmark spans'
    inner = [(s, e, n) for s, e, n in bench if s <= start < e]
    if inner:
      label = labels.get(min(inner, key=lambda x: x[1] - x[0])[2], label)
    spans = opened.at(start)
    if spans:
      label += ' / ' + min(spans, key=lambda x: x[1])[0]
    gaps.append([label, length / 1e6])
  return {
      'spans': {name: {'calls': opened.calls[name],
                       'device_us': stats.busy(placed[name], begin, end),
                       'kernels': kernels[name]}
                for name in opened.names},
      'launches': sum(_kernel(ev.name) for _, _, ev in work),
      'unplaced_us': unplaced,
      'idle_gaps': gaps}


def span_name(name):
  """A program range's name with a step number taken off: `train#`."""
  return re.sub(r'#\d+$', '#', name)


def _kernel(name):
  return not name.startswith(('Memcpy', 'Memset'))


class _Opened:
  """Which program spans were open at a host time: per name, the union
  of its ranges."""

  def __init__(self, program):
    by_name = {}
    for start, end, name in program:
      by_name.setdefault(name, []).append((start, end))
    self.names = sorted(by_name)
    self.calls = {n: len(v) for n, v in by_name.items()}
    self.union = {n: stats.union(v) for n, v in by_name.items()}
    self.starts = {n: [s for s, _ in v] for n, v in self.union.items()}

  def at(self, t):
    """[(name, length of its range around t)] of the spans open at t."""
    out = []
    for name in self.names:
      i = bisect.bisect_right(self.starts[name], t) - 1
      if i >= 0:
        start, end = self.union[name][i]
        if t < end:
          out.append((name, end - start))
    return out
