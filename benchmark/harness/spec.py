"""What a run reads: BENCHMARK.json, the cell's configuration and traffic
files, its limits, and the readers of its per-layer metrics, each found by
the name that BENCHMARK.json gives it.

- `configs[].file`: the configuration (`settings`, the flat keys of the
  program's config as the cell runs them).
- `traffic/<traffic>.json`: the traffic mix, parameters for the harness
  module `harness/<driver>.py` that its `driver` key names (`learn`,
  `script`). A driver has `run(spec, seed, seconds, trace, t_start)`, the
  run, and `readings(spec, seed, fault)`, the readings a limit is set
  from (benchmark/control.py).
- `limits/<workload>.json`: the limit of each number that `correct`
  compares, with the readings it was set from.
- `metrics/<metric>.py`: a per-layer metric's reader, a function
  `read(record)` that returns the metric's value or None.
"""

import importlib
import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / 'benchmark'


class Spec:
  """One cell of BENCHMARK.json with everything it names."""

  def __init__(self, workload, root=ROOT):
    self.root = pathlib.Path(root)
    bench = json.loads((self.root / 'BENCHMARK.json').read_text())
    cells = {c['name']: c for c in bench['workloads']}
    if workload not in cells:
      raise KeyError(f'No workload {workload!r} in BENCHMARK.json; it has '
                     f'{sorted(cells)}')
    self.bench = bench
    self.cell = cells[workload]
    self.name = workload
    configs = {c['name']: c for c in bench['configs']}
    self.config_entry = configs[self.cell['config']]
    self.config = json.loads(
        (self.root / self.config_entry['file']).read_text())
    self.traffic = load_json(self.root / 'benchmark' / 'traffic' /
                             f"{self.cell['traffic']}.json")
    limits = self.root / 'benchmark' / 'limits' / f'{workload}.json'
    self.limits = load_json(limits)['limits'] if limits.exists() else {}
    self.chips = int(self.cell['chips'])

  @classmethod
  def of(cls, name, cell, config, traffic, limits, bench):
    """A cell from its parts (the harness's tests build debug-size cells
    this way)."""
    self = cls.__new__(cls)
    self.root, self.bench, self.cell, self.name = ROOT, bench, cell, name
    self.config_entry, self.config = None, config
    self.traffic, self.limits = traffic, limits
    self.chips = int(cell['chips'])
    return self

  def driver(self):
    """The harness module that runs this cell's traffic."""
    name = self.traffic['driver']
    if not re.fullmatch(r'[a-z][a-z0-9_]*', name):
      raise ValueError(f'Bad traffic driver name {name!r}')
    return importlib.import_module(f'benchmark.harness.{name}')

  def metrics(self, trace):
    """The cell's metric entries: end-to-end with trace 0, per-layer with
    trace 1, each that lists this cell (or lists none)."""
    kind = 'per_layer' if trace else 'end_to_end'
    out = []
    for entry in self.bench[kind]:
      cells = entry.get('workloads')
      if cells is None or self.name in cells:
        out.append(entry)
    return out


def load_json(path):
  return json.loads(pathlib.Path(path).read_text())


def reader(name, root=ROOT):
  """The `read` function of metrics/<name>.py."""
  path = pathlib.Path(root) / 'benchmark' / 'metrics' / f'{name}.py'
  spec = importlib.util.spec_from_file_location(
      'benchmark_metric_' + name.replace('.', '_'), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.read
