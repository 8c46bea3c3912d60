"""Runs one cell once as `run.py --trace 1` does, with the device trace
also reduced by the program's own spans (harness/spans.py), and prints
the result line with those fields added as the last line of standard
output.

    python benchmark/trace_spans.py --workload dv3_200m.learn --seed 1 \
        --seconds 30

Added to `run.py`'s traced result: `spans` (each program span's calls,
device ms and kernels, over the traced stretch), `launches` and
`unplaced_us` (harness/spans.py), `traced_steps` (learner cells),
`device_ms_per_step` (each span's device ms per traced step, learner
cells) and `untraced` (each timer section's seconds and calls after the
tracer stopped). The gaps in `breakdown` carry the program's span.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import run as runmod  # noqa: E402
from benchmark.harness import device as devicelib  # noqa: E402
from benchmark.harness import learn, script, spans  # noqa: E402
from benchmark.harness import spec as speclib  # noqa: E402


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  args = parser.parse_args(argv)
  learn.Tracer = script.Tracer = spans.SpanTracer
  spec = speclib.Spec(args.workload, runmod.ROOT)
  devicelib.require(spec.chips)
  fields, record, readings = spec.driver().run(
      spec, args.seed, args.seconds, True, T_START)
  entry = devicelib.identity(spec.chips)
  entry['memory_peak_bytes'] = int(fields['peak'])
  entry['power_limit_w'] = devicelib.power_limit()
  out, _ = runmod.result(spec, True, fields, record, readings, entry)
  summary = record.get('trace') or {}
  steps = record.get('traced_steps')
  out.update(
      spans=summary.get('spans'), launches=summary.get('launches'),
      unplaced_us=summary.get('unplaced_us'), traced_steps=steps,
      untraced=spans.untraced())
  if steps and summary.get('spans'):
    out['device_ms_per_step'] = {
        name: entry['device_us'] / 1e3 / steps
        for name, entry in summary['spans'].items()}
  print(json.dumps(out), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
