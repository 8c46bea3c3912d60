"""Kernels 5 and 6 together, the observe window's forward and backward
(`ops/observe_seq.py`, `csrc/observe_seq.cu`): the least time their calls
in the trace could take (per call the larger of bytes / 3.35 TB/s and
products / 989 TFLOP/s, from the benchmark's frozen count) over the
device time of the work launched inside their profiler ranges."""

from benchmark.harness import stats


def read(record):
  trace, work = record.get('trace'), record.get('work')
  if not trace or not work:
    return None
  least = device = 0.0
  for name in ('observe_seq', 'observe_seq_bwd'):
    entry = trace['ranges'].get(name)
    if not entry or not entry['calls'] or entry['device_us'] <= 0:
      return None
    least += entry['calls'] * stats.least_time(*work[name])
    device += entry['device_us'] / 1e6
  return 100.0 * least / device
