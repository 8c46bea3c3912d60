"""The harness on the CPU: cells, configurations, traffic, limits and
metric readers found by name; the arithmetic of the metrics on synthetic
numbers; `run.py` failing without a card; and the checks' planted
faults, driven through the rest of a run at a debug size."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from benchmark.harness import check, learn, script, spec as speclib, stats

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())


@pytest.mark.parametrize('cell', [c['name'] for c in BENCH['workloads']])
def test_a_cell_finds_its_files_by_name(cell):
  spec = speclib.Spec(cell, ROOT)
  assert spec.config['name'] == spec.cell['config']
  driver = spec.driver()
  assert callable(driver.run) and callable(driver.readings)
  assert set(spec.limits) >= {"grad", "change", "grad_mean", "change_median"}
  for trace in (0, 1):
    for entry in spec.metrics(trace):
      if trace:
        assert callable(speclib.reader(entry['name'], ROOT))
  names = {m['name'] for m in spec.metrics(0)}
  assert 'setup_s' in names and len(names) >= 2
  assert spec.metrics(1)


def test_every_metric_has_its_reader_and_every_reader_a_metric():
  readers = {p.name[:-3] for p in (ROOT / 'benchmark' / 'metrics').glob(
      '*.py')}
  assert readers == {m['name'] for m in BENCH['per_layer']}


def test_a_configuration_file_states_its_cut():
  for entry in BENCH['configs']:
    config = json.loads((ROOT / entry['file']).read_text())
    assert config['reduced'] == entry['reduced'] == []
    assert config['source'] == entry['source']
    assert config['settings']['torch.compute_dtype'] == 'bfloat16'


def test_percentile_is_over_all_values():
  values = list(range(1, 101))
  assert stats.percentile(values, 90) == pytest.approx(90.1)
  assert stats.percentile([5.0], 90) == 5.0
  assert stats.percentile([3, 1, 2], 50) == 2


def test_busy_and_idle_on_a_synthetic_trace():
  intervals = [(0, 10), (5, 20), (30, 40), (45, 50)]
  assert stats.busy(intervals, 0, 60) == 35
  assert stats.busy(intervals, 10, 35) == 15
  gaps = stats.gaps(intervals, 0, 60)
  assert gaps[0] == (20, 10) and sorted(g[1] for g in gaps) == [5, 10, 10]
  read = speclib.reader('device_idle_share.learn', ROOT)
  record = {'driver': 'learn', 'traced_steps': 2,
            'intervals_ms': [190.0, 170.0, 400.0, 100.0, 100.0],
            'trace': {'busy_us': 160e3, 'window_us': 360e3}}
  assert read(record) == pytest.approx(20.0)
  read = speclib.reader('device_idle_share.script', ROOT)
  record = {'driver': 'script', 'traced_env_steps': 64,
            'untraced': {'env_steps': 1600, 'seconds': 10.0},
            'trace': {'busy_us': 0.2e6, 'window_us': 1e6}}
  assert read(record) == pytest.approx(50.0)


def test_mfu_and_roofline_arithmetic():
  assert stats.mfu(989e12, 10, 10.0) == pytest.approx(100.0)
  read = speclib.reader('train_mfu', ROOT)
  assert read({'flops_per_step': 1.305e13, 'steps': 100,
               'window_s': 13.2}) == pytest.approx(
                   100 * 1.305e13 * 100 / 13.2 / 989e12)
  assert stats.least_time(3.35e12, 1.0) == pytest.approx(1.0)
  assert stats.least_time(1.0, 989e12) == pytest.approx(1.0)
  read = speclib.reader('imagination_roofline', ROOT)
  record = {'work': {'imagine_seq': (3.35e9, 0.0)},
            'trace': {'ranges': {'imagine_seq': {'calls': 2,
                                                 'device_us': 4000.0}}}}
  assert read(record) == pytest.approx(50.0)
  record['trace']['ranges'] = {}
  assert read(record) is None


def test_the_first_gradient_comes_back_from_the_moments():
  torch.manual_seed(0)
  grads = [torch.randn(7), torch.zeros(3), torch.randn(5)]
  flat = torch.cat(grads)
  beta1, beta2 = 0.9, 0.999
  rms = (1 - beta2) * flat ** 2
  mom = (1 - beta1) * flat / (flat.abs() + 1e-20)
  sizes = [('a', 7), ('b', 3), ('c', 5)]
  back = check.first_grad(rms, mom, sizes, beta2)
  for want, got in zip(grads, back):
    torch.testing.assert_close(got, want)


def test_grad_vec_sees_a_gradient_that_points_elsewhere():
  # A clipped leaf's first gradient has the same norm on both sides
  # whatever its values: only the distance between the vectors sees one
  # that points elsewhere.
  torch.manual_seed(0)
  ref = [torch.randn(100) for _ in range(5)]
  prog = [g.clone() for g in ref]
  prog[2] = prog[2].flip(0)
  change = torch.ones(5)
  numbers = check.compare({'grad': prog, 'change': change, 'loss': [1.0]},
                          {'grad': ref, 'change': change, 'loss': [1.0]})
  assert numbers['grad'] < 1e-6 and numbers['change'] == 0
  assert numbers['grad_vec'] > 0.5


def test_run_fails_without_a_card():
  if torch.cuda.is_available():
    pytest.skip('A card is here: the run would measure it')
  proc = subprocess.run(
      [sys.executable, str(ROOT / 'benchmark' / 'run.py'), '--workload',
       'dv3_200m.learn', '--seed', '1', '--seconds', '1', '--trace', '0'],
      capture_output=True, text=True, timeout=300, cwd=ROOT)
  assert proc.returncode != 0
  assert '{' not in proc.stdout


def _debug_cell(driver):
  """A debug-size cell of `driver` on the CPU, in float32 so that the
  program's plain path and the reference agree to the bit."""
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main
  config = common.assemble_config(main.CONFIGS, [
      '--configs', 'debug', '--task', 'pinpad_four',
      '--torch.compute_dtype', 'float32'])
  flat = config.flat
  settings = {k: v for k, v in flat.items() if k.startswith('agent.')}
  for key in ('batch_size', 'batch_length', 'replay_context',
              'report_length', 'consec_train', 'consec_report', 'task',
              'torch.compute_dtype', 'torch.precompile', 'replay.size'):
    settings[key] = flat[key]
  traffic = json.loads((ROOT / 'benchmark' / 'traffic' /
                        f'{driver}.json').read_text())
  if driver == 'learn':
    traffic.update(fill_steps=128, envs=2, warm_calls=1)
    name = 'dv3_200m.learn'
  else:
    traffic['program'].update({'run.envs': 2, 'run.train_ratio': 8.0})
    name = 'dv3_200m.script'
  limits_path = ROOT / 'benchmark' / 'limits' / f'{name}.json'
  if not limits_path.exists():
    pytest.skip(f'No cell {name}')
  limits = json.loads(limits_path.read_text())['limits']
  program = {'package': 'embodied_tpu_torch.models.dreamerv3',
             'presets': []}
  return speclib.Spec.of(name, {'chips': 1},
                         {'settings': settings, 'program': program},
                         traffic, limits, BENCH)


@pytest.mark.parametrize('fault', [None, 'unchanged', 'half_batch'])
def test_learner_checks_see_the_planted_faults(fault):
  spec = _debug_cell('learn')
  _, _, readings = learn.run(spec, 2 ** 31 + 17, 0.5, False, 0.0,
                             device='cpu', fault=fault)
  correct, _ = check.judge(readings, spec.limits)
  assert correct == (fault is None), readings


# Half a batch left out is the learner test's: at the debug size the
# script's first batches can repeat one window in every row, and then
# leaving half of them out changes nothing.
@pytest.mark.parametrize('fault', [None, 'action', 'unchanged'])
def test_script_checks_see_the_planted_faults(fault):
  spec = _debug_cell('script')
  _, _, readings = script.run(spec, 2 ** 31 + 19, 1.0, False, 0.0,
                              device='cpu', fault=fault)
  correct, _ = check.judge(readings, spec.limits)
  assert correct == (fault is None), readings


@pytest.mark.parametrize('cell', [c['name'] for c in BENCH['workloads']])
def test_the_result_line_carries_the_cells_metrics(cell):
  import benchmark.run as runmod
  spec = speclib.Spec(cell, ROOT)
  fields = {'attempted': 10, 'failed': 0, 'peak': 1, 'end_to_end': {
      'train_frames_per_s': 1.0, 'train_step_ms_p90': 2.0,
      'env_steps_per_s': 3.0, 'setup_s': 4.0}}
  readings = {k: 0.0 for k in spec.limits}
  out, rows = runmod.result(spec, False, fields, {}, readings,
                            {'platform': 'gpu'})
  assert set(out['metrics']) == {m['name'] for m in spec.metrics(0)}
  assert out['correct'] and list(out)[-1] == 'checks'
  assert [name for name, _, _ in rows] == sorted(spec.limits)
