"""Kernel 8, the whole-horizon imagination rollout (`ops/imagine_seq.py`,
`csrc/imagine_seq.cu`): the least time its calls in the trace could take
(per call the larger of bytes / 3.35 TB/s and products / 989 TFLOP/s,
from the benchmark's frozen count) over the device time of the work
launched inside its profiler range."""

from benchmark.harness import stats


def read(record):
  trace, work = record.get('trace'), record.get('work')
  if not trace or not work:
    return None
  entry = trace['ranges'].get('imagine_seq')
  if not entry or not entry['calls'] or entry['device_us'] <= 0:
    return None
  least = entry['calls'] * stats.least_time(*work['imagine_seq'])
  return 100.0 * least / (entry['device_us'] / 1e6)
