"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, the program's numbers against the float32
reference (the lower reading: a sound program) and the control's against
the same reference (the upper reading): the reference itself computing in
float8 e4m3, the precision below the configuration's bfloat16
(`reference.nn.core.fp8_compute`). With `--fault`, the program's numbers
with one of the checks' planted faults instead.

    python benchmark/control.py --workload dv3_200m.learn \
        --seeds 11 12 13 --out control.jsonl

Training's readings need no measured window: each seed runs the cell's
set-up and first steps, then the reference and the control on the same
rows. The train script's run a short window at the cell's own load
(`control_seconds` of its traffic), and the control acts from the same
carries, observations and noise as the program's first policy calls. One JSON
line a seed goes to `--out` and to standard output. The benchmark's own
runs do not run this.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import device as devicelib  # noqa: E402

devicelib.cache_env(ROOT)

from benchmark.harness import spec as speclib  # noqa: E402


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', type=int, nargs='+', required=True)
  parser.add_argument('--out', default=None)
  parser.add_argument('--fault', default=None,
                      choices=('unchanged', 'half_batch', 'action'))
  args = parser.parse_args(argv)
  spec = speclib.Spec(args.workload, ROOT)
  devicelib.require(spec.chips)
  for seed in args.seeds:
    line = json.dumps(dict(spec.driver().readings(spec, seed, args.fault),
                           fault=args.fault))
    print(line, flush=True)
    if args.out:
      with open(args.out, 'a') as f:
        f.write(line + '\n')
  return 0


if __name__ == '__main__':
  sys.exit(main())
