"""The traced run's device trace: torch.profiler over the first steps of
the window, reduced to what the per-layer metrics and the breakdown read.

- `busy_us`, `window_us`: the union of the device's activity (kernels,
  copies, fills) within the traced stretch of the window, and the
  stretch's length (from its first host span to the end of its last
  step on the card);
- `ranges`: for each named profiler range of the port's kernel wrappers
  (`observe_seq`, `observe_seq_bwd`, `imagine_seq`), its calls and the
  device time of the work launched inside it: the profiler mirrors each
  range onto the device's timeline as a user annotation spanning the
  work it launched, and the kernels and fills within that span count;
- `device_ops`: the device operations (kernels, copies, fills) that took
  most time, by name;
- `idle_gaps`: the longest stretches with nothing on the device, each
  named by the benchmark span the host was in when it began.

The benchmark's own host spans run as profiler ranges named `bench/...`.
"""

import torch

from . import stats

KERNEL_RANGES = ('observe_seq', 'observe_seq_bwd', 'imagine_seq')
TOP = 10
NAME_CHARS = 160


class Tracer:

  def __init__(self, steps):
    self.steps = int(steps)
    self.prof = None
    self.done = False

  def start(self):
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    self.prof = torch.profiler.profile(activities=activities)
    self.prof.start()

  def stop(self):
    torch.cuda.synchronize()
    self.prof.stop()
    self.done = True

  def summary(self, labels):
    """The reduced trace; `labels` maps a bench span's name to the words
    that name an idle gap starting inside it."""
    device, kernels, ranges, spans = [], [], {}, []
    for ev in self.prof.events():
      start, end = ev.time_range.start, ev.time_range.end
      if _on_device(ev):
        if _annotation(ev):
          if ev.name in KERNEL_RANGES:
            ranges.setdefault(ev.name, []).append((start, end))
          continue
        device.append((start, end, ev.name))
        if not ev.name.startswith('Memcpy'):
          kernels.append((start, end))
      elif ev.name.startswith('bench/'):
        spans.append((start, end, ev.name))
    if not device or not spans:
      return None
    begin = min(s for s, _, _ in spans)
    end = max(max(e for _, e, _ in spans), max(e for _, e, _ in device))
    intervals = [(s, e) for s, e, _ in device]
    busy = stats.busy(intervals, begin, end)
    by_name = {}
    for s, e, name in device:
      by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:TOP]
    gaps = []
    for start, length in stats.gaps(intervals, begin, end)[:TOP]:
      label = 'host outside the benchmark spans'
      inner = [(s, e, n) for s, e, n in spans if s <= start < e]
      if inner:
        label = labels.get(min(inner, key=lambda x: x[1] - x[0])[2], label)
      gaps.append([label, length / 1e6])
    return {
        'busy_us': busy, 'window_us': end - begin,
        'ranges': {name: {'calls': len(spans_),
                          'device_us': sum(stats.busy(kernels, s, e)
                                           for s, e in spans_)}
                   for name, spans_ in ranges.items()},
        'device_ops': [[n[:NAME_CHARS], t / 1e6] for n, t in ops],
        'idle_gaps': gaps}


def _annotation(ev):
  """Whether a device event is a host range mirrored onto the device's
  timeline (the profiler's user annotations), not work."""
  return bool(getattr(ev, 'is_user_annotation', False)) or (
      ev.name in KERNEL_RANGES or ev.name.startswith(('bench/', 'train#')))


def _on_device(ev):
  kind = getattr(ev, 'device_type', None)
  return kind is not None and str(kind).endswith('CUDA')
