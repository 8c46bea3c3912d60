"""Runs one cell of the benchmark of the PyTorch and CUDA port once and
prints its result as the last line of standard output.

    python benchmark/run.py --workload dv3_200m.learn --seed 1 \
        --seconds 10 --trace 0

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (a device trace of the window's first steps, host spans
around the calls into the program, the FLOP count) with the device's busy
time and a breakdown. Every run checks what its timed path produced
against the plain reference (harness/check.py) and prints each compared
number beside its limit, last on standard error and last in the result.
With no CUDA card, or fewer than the cell asks for, it exits with an
error and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import device as devicelib  # noqa: E402

devicelib.cache_env(ROOT)

from benchmark.harness import check, spec as speclib  # noqa: E402


def parse(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return parser.parse_args(argv)


def result(spec, trace, fields, record, readings, device_entry):
  """The result's line as a dict, its compared numbers last."""
  correct, rows = check.judge(readings, spec.limits)
  metrics = {}
  for entry in spec.metrics(trace):
    name = entry['name']
    if trace:
      value = speclib.reader(name, spec.root)(record)
    else:
      value = fields['end_to_end'].get(name)
    if value is not None:
      metrics[name] = {'value': float(value), 'unit': entry['unit']}
  out = {'correct': bool(correct), 'attempted': int(fields['attempted']),
         'failed': int(fields['failed']), 'metrics': metrics,
         'device': device_entry}
  summary = record.get('trace')
  if trace and summary:
    out['device']['busy_s'] = summary['busy_us'] / 1e6
    out['device']['window_s'] = summary['window_us'] / 1e6
    out['breakdown'] = {'device_ops': summary['device_ops'],
                        'idle_gaps': summary['idle_gaps']}
  out['checks'] = {name: {'value': value, 'limit': limit}
                   for name, value, limit in rows}
  return out, rows


def main(argv=None):
  args = parse(argv)
  spec = speclib.Spec(args.workload, ROOT)
  devicelib.require(spec.chips)
  fields, record, readings = spec.driver().run(
      spec, args.seed, args.seconds, bool(args.trace), T_START)
  found = devicelib.forbidden_modules()
  if found:
    print(f'The run loaded modules it may not: {found}', file=sys.stderr)
    return 3
  entry = devicelib.identity(spec.chips)
  entry['memory_peak_bytes'] = int(fields['peak'])
  entry['power_limit_w'] = devicelib.power_limit()
  out, rows = result(spec, bool(args.trace), fields, record, readings, entry)
  print(f'readings: {json.dumps(readings)}', file=sys.stderr)
  for name, value, limit in rows:
    print(f'check {name}: {value} limit {limit}', file=sys.stderr)
  print(json.dumps(out), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
