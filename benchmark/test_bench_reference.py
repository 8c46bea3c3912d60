"""The reference against the port on the CPU at the `debug` size: the same
store layout, the same train step and policy on the same weights and noise
(float32 on both sides), the frozen roofline counts against the port's
`work()`, the benchmark's FLOP count against `Agent.train_cost()`, and the
control, which the limits have to fail."""

import json
import pathlib

import pytest
import torch

from benchmark import reference
from benchmark.harness import check, learn, port, weights
from benchmark.reference import flops as refflops
from benchmark.reference import work
from benchmark.test_bench_harness import _debug_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_config(preset_args, logdir):
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main
  return common.assemble_config(main.CONFIGS, [
      *preset_args, '--task', 'pinpad_four', '--logdir', str(logdir)])


@pytest.mark.parametrize('name', ['dreamerv3_200m', 'dreamerv3_400m'])
def test_store_layout_matches_the_port_at_full_size(name, tmp_path):
  from embodied_tpu_torch.models.dreamerv3.model import Model
  config = json.loads((ROOT / 'benchmark' / 'configs' /
                       f'{name}.json').read_text())
  settings = config['settings']
  prog = port.Program(config['program'])
  program = prog.make_config(settings, 0, tmp_path, 'cpu')
  spaces = prog.spaces(program)
  with torch.device('meta'):
    theirs = Model(*spaces, _agent_view(program), cdtype=torch.bfloat16)
  ours = reference.build(*spaces, settings, device='meta')
  shape = lambda m: {k: tuple(v.shape) for k, v in m.state_dict().items()}
  assert shape(ours) == shape(theirs)
  params = sum(p.numel() for p in ours.parameters())
  assert params > {'dreamerv3_200m': 1.9e8, 'dreamerv3_400m': 4.4e8}[name]


def _agent_view(config):
  from embodied_tpu_torch.models import common
  return common.agent_config(config)


def test_train_step_and_policy_agree_with_the_port():
  spec = _debug_cell('learn')
  _, _, readings = learn.run(spec, 5, 0.5, False, 0.0, device='cpu')
  assert readings['loss'] < 1e-6 and readings['grad'] < 1e-5, readings
  assert readings['change'] < 1e-5, readings
  assert readings['leaves_compared'] > readings['leaves'] / 2


def test_weights_follow_the_initializers():
  spec = _debug_cell('learn')
  settings = spec.config['settings']
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main
  config = common.assemble_config(main.CONFIGS, ['--configs', 'debug',
                                                 '--task', 'pinpad_four'])
  model = reference.build(*common.env_spaces(config), settings, 'meta')
  store = weights.draw(model, 3, 'cpu')
  again = weights.draw(model, 3, 'cpu')
  other = weights.draw(model, 4, 'cpu')
  assert all(torch.equal(store[k], again[k]) for k in store)
  assert any(not torch.equal(store[k], other[k]) for k in store)
  for path, shape, std, const in weights.scheme(model):
    value = store[path]
    assert tuple(value.shape) == shape
    if std:
      assert float(value.abs().max()) <= 2 * std / weights.TRUNC_STD + 1e-6
    else:
      assert torch.all(value == const)
  for path in store:
    if path.startswith('slowval/'):
      assert torch.equal(store[path], store['val/' + path[8:]])


def test_window_and_rollout_counts_match_the_port():
  from embodied_tpu_torch.ops import imagine_seq, observe_seq
  window = (64, 16, 8192, 1024, 2048, 1024, 8192, 8)
  assert work.observe_window(*window) == observe_seq.work(*window)
  ours, theirs = work.observe_window_bwd(*window), observe_seq.work_bwd(
      *window)
  assert ours[0] == theirs[0] and 3 * ours[1] == 2 * theirs[1]
  rollout = (15, 1024, 8192, 1024, 2048, 1024, 1024, 5, 3, 8, True)
  assert work.imagination(*rollout) == imagine_seq.work(*rollout)
  config = json.loads((ROOT / 'benchmark' / 'configs' /
                       'dreamerv3_200m.json').read_text())
  assert work.dims(config['settings'], 8192, 5) == (window, rollout)


def test_flop_count_equals_the_ports_train_cost(tmp_path):
  spec = _debug_cell('learn')
  settings = dict(spec.config['settings'], **{'torch.precompile': False})
  prog = port.Program(spec.config['program'])
  config = prog.make_config(settings, 1, tmp_path, 'cpu')
  agent = prog.make_agent(config)
  theirs = agent.train_cost()['flops']
  spaces = prog.spaces(config)
  model = learn.meta_model(spaces, settings)
  B, T = config.batch_size, config.batch_length + config.replay_context
  batch = {}
  for key, space in {**spaces[0], **spaces[1], **model.ext_space}.items():
    dtype = reference.nn.torch_dtype(space.dtype)
    batch[key] = torch.zeros((B, T, *space.shape), dtype=dtype)
  # The port runs the five imagination heads' first layers as one product
  # on their joined kernels, and its backward takes the weight gradient of
  # every column: also of the reward, continue and slow value heads', which
  # no loss reaches there. The benchmark counts what the step needs.
  get = settings.__getitem__
  rows = B * min(get('agent.imag_last') or config.batch_length,
                 config.batch_length) * (get('agent.imag_length') + 1)
  feat = get('agent.dyn.rssm.deter') + (
      get('agent.dyn.rssm.stoch') * get('agent.dyn.rssm.classes'))
  unused = sum(2 * rows * feat * get(f'agent.{head}.units')
               for head in ('rewhead', 'conhead', 'value'))
  assert refflops.train_flops(model, batch) == theirs - unused > 0


@pytest.mark.parametrize('driver', ['learn', 'script'])
def test_the_control_fails_the_limits(driver):
  spec = _debug_cell(driver)
  spec.traffic['control_seconds'] = 2.0
  out = spec.driver().readings(spec, 9, device='cpu')
  assert check.judge(out['program'], spec.limits)[0], out
  assert not check.judge(out['control'], spec.limits)[0], out
