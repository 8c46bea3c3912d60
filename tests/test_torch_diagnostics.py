"""The Agent's diagnostics in the port, on the CPU at the debug preset's
widths: `train_cost` (held against a real train step, against a hand
count, against the JAX agent's), the `deterministic` and `debug` knobs of
`parallel.setup`, the sync guard's scopes, the profiler window, and the
segment profiler (tools/profile_train.py).

Counts are integers and compared exactly; the JAX comparison is a range,
stated where it is made.
"""

import importlib
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from embodied_tpu.models import common as jcommon
from embodied_tpu.models.dreamerv3 import main as jmain
from embodied_tpu_torch import nn, viewer
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.parallel import flops, guard
from embodied_tpu_torch.tools import profile_train
from embodied_tpu_torch.utils import Config

setuplib = importlib.import_module('embodied_tpu_torch.parallel.setup')
ROOT = pathlib.Path(__file__).resolve().parents[1]
DEBUG = ['--configs', 'debug', '--task', 'dummy_disc']


def debug_agent(tmp_path, *extra, torch_keys=None):
  config = common.assemble_config(
      main.CONFIGS, DEBUG + ['--logdir', str(tmp_path)] + list(extra))
  if torch_keys:  # Keys that configs.yaml does not have, as `profiler`.
    config = Config({**config, 'torch': {**config.torch, **torch_keys}})
  return main.make_agent(config)


def train_batch(agent, seed=0):
  """A (B, T + context) batch of the agent's replay keys, the observations
  drawn from `seed`."""
  rng = np.random.default_rng(seed)
  data = agent._example_batch(
      agent.batch_size, agent.batch_length + agent.replay_context)
  data['image'] = rng.integers(0, 256, data['image'].shape, np.uint8)
  data['vector'] = rng.normal(size=data['vector'].shape).astype(np.float32)
  data['reward'] = rng.normal(size=data['reward'].shape).astype(np.float32)
  return data


class _GlobalOnly:
  """FlopCounterMode's module tracker reduced to the global scope: its
  hooks fail where a module is called under no_grad on a leaf that
  requires grad (the rollout's first step)."""
  parents = {'Global'}

  def __enter__(self):
    return self

  def __exit__(self, *args):
    pass


def torch_count(fn):
  counter = FlopCounterMode(display=False)
  counter.mod_tracker = _GlobalOnly()
  with counter:
    fn()
  return counter.get_total_flops()


# --- train_cost --------------------------------------------------------------


@pytest.fixture(scope='module')
def debug_count(tmp_path_factory):
  """train_cost of a debug agent, counted once for the module."""
  return debug_agent(tmp_path_factory.mktemp('count')).train_cost()['flops']


def test_train_cost_equals_a_real_step_count(tmp_path, debug_count):
  """train_cost (on a meta copy) equals FlopCounterMode's count of one real
  train step on the CPU, made by another agent of the same config."""
  other = debug_agent(tmp_path)
  data = train_batch(other)
  want = torch_count(lambda: other.train(
      other.init_train(other.batch_size), data))
  assert debug_count == want and want > 0


@pytest.mark.parametrize('family', ['ppo', 'director'])
def test_train_cost_of_the_other_families(tmp_path, family):
  """PPO's and Director's train_cost against a real step's count, as
  DreamerV3's above."""
  fmain = importlib.import_module(f'embodied_tpu_torch.models.{family}.main')
  config = common.assemble_config(
      fmain.CONFIGS, DEBUG + ['--logdir', str(tmp_path)])
  agent = fmain.make_agent(config)
  got = agent.train_cost()['flops']
  data = agent._example_batch(
      agent.batch_size, agent.batch_length + agent.replay_context)
  want = torch_count(lambda: agent.train(
      agent.init_train(agent.batch_size), data))
  assert got == want and got > 0


def test_train_cost_leaves_the_agent_as_it_was(tmp_path, debug_count):
  """After train_cost, the next train step and policy call equal those of
  an agent that never called it, bit for bit; counters, the latent table
  and the fetch queue are untouched."""
  agents = [debug_agent(tmp_path / n) for n in ('a', 'b')]
  table = {k: v.clone() for k, v in agents[0]._latents.tables.items()}
  assert agents[0].train_cost()['flops'] == debug_count
  assert agents[0]._counters == {'policy': 0, 'train': 0, 'report': 0}
  assert not agents[0]._pending_train and agents[0]._fetched_train is None
  for key, value in agents[0]._latents.tables.items():
    assert torch.equal(value, table[key]), key
  data = train_batch(agents[0])
  results = []
  for agent in agents:
    _, outs, mets = agent.train(agent.init_train(agent.batch_size), data)
    obs = agent._example_obs(2)
    obs['is_first'][:] = True
    _, act, _ = agent.policy(agent.init_policy(2), obs)
    results.append((nn.store(agent.model), mets, outs, act))
  (store, mets, outs, act), (store2, mets2, outs2, act2) = results
  assert sorted(store) == sorted(store2)
  for key in store:
    assert torch.equal(store[key], store2[key]), key
  assert mets.keys() == mets2.keys()
  for key in mets:
    np.testing.assert_array_equal(mets[key], mets2[key], err_msg=key)
  np.testing.assert_array_equal(act['action'], act2['action'])


def test_precompile_prints_the_count(tmp_path, capsys, debug_count):
  debug_agent(tmp_path, '--torch.precompile', 'True')
  assert f'Train step FLOPs: {debug_count:.3e}' in capsys.readouterr().out


def test_mlp_head_count_is_the_hand_count():
  """Each linear layer of a head does 2 M K N forward and 4 M K N backward
  (the input's and the weight's gradients), so 6 M K N in all."""
  M, K, N, layers = 6, 12, 20, 2
  head = nn.MLPHead((), 'mse', 'head', K, layers=layers, units=N,
                    cdtype=torch.float32)
  nn.init_params(head, 0)
  x = torch.randn(2, M // 2, K, requires_grad=True)

  def step():
    loss = head(x).pred().sum()
    torch.autograd.grad(loss, [x, *head.parameters()])
  widths = [K] + [N] * layers + [1]
  want = sum(6 * M * a * b for a, b in zip(widths[:-1], widths[1:]))
  with flops.FlopCounter() as counter:
    step()
  assert counter.flops == want == torch_count(step)


def test_train_cost_against_jax(tmp_path):
  """On one config and batch, the JAX agent's train_cost()['flops'] (XLA's
  cost analysis on the CPU) lies between the port's count and 4 times
  it. XLA counts elementwise ops besides the products, which at the debug
  preset's widths (8 units) weigh as much as the products twice over: the
  ratio read 3.07 on CartPole. A vector task keeps convolutions out: XLA
  counts a convolution's taps inside the image only, where torch's
  formula counts every tap of the padded window, and on an image task
  XLA's count can fall below the port's."""
  argv = ['--configs', 'debug', '--task', 'gym_CartPole-v1']
  jconfig = jcommon.assemble_config(
      str(pathlib.Path(jmain.__file__).with_name('configs.yaml')),
      argv + ['--logdir', str(tmp_path / 'jax'), '--jax.mesh', '1,1,1'])
  want = jmain.make_agent(jconfig).train_cost()['flops']
  got = main.make_agent(common.assemble_config(
      main.CONFIGS, argv + ['--logdir', str(tmp_path / 'port')])
  ).train_cost()['flops']
  assert got > 0 and got <= want <= 4 * got, (want, got)


# --- Knobs ------------------------------------------------------------------


def child(script):
  proc = subprocess.run(
      [sys.executable, '-c', script], cwd=ROOT, capture_output=True,
      text=True, timeout=120)
  return proc


def test_deterministic_knob_in_a_child():
  """setup(deterministic=True) turns on torch's deterministic algorithms
  and sets CUBLAS_WORKSPACE_CONFIG, in a child interpreter: the settings
  hold for the whole process."""
  proc = child(
      'import os, torch\n'
      'from embodied_tpu_torch import parallel\n'
      "parallel.setup(device='cpu', deterministic=True)\n"
      'print(torch.are_deterministic_algorithms_enabled(),\n'
      "      os.environ['CUBLAS_WORKSPACE_CONFIG'],\n"
      '      torch.backends.cudnn.deterministic,\n'
      '      torch.backends.cudnn.benchmark)\n')
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.split() == ['True', ':4096:8', 'True', 'False']


@pytest.fixture
def fresh_setup(monkeypatch):
  """parallel.setup as if this process had not run it; the knobs and
  autograd's anomaly mode come back afterwards."""
  monkeypatch.setattr(setuplib, '_DONE', [False])
  monkeypatch.setattr(setuplib, '_DEVICES', [None])
  for key, value in list(guard.KNOBS.items()):
    monkeypatch.setitem(guard.KNOBS, key, value)
  anomaly = torch.is_anomaly_enabled()
  yield
  torch.autograd.set_detect_anomaly(anomaly)


def test_deterministic_after_setup_raises(fresh_setup):
  """A setup that asks for deterministic after one without it raises:
  cuBLAS may have read its workspace variable already."""
  setuplib.setup(device='cpu')
  with pytest.raises(RuntimeError, match='deterministic'):
    setuplib.setup(device='cpu', deterministic=True)
  assert not torch.are_deterministic_algorithms_enabled()


def test_debug_raises_on_a_planted_nan(tmp_path, fresh_setup):
  """Under debug, a NaN planted in a batch raises, naming the op; the same
  step runs without debug."""
  agent = debug_agent(tmp_path / 'plain')
  data = train_batch(agent)
  data['vector'][1, 2, 0] = np.nan
  _, _, mets = agent.train(agent.init_train(agent.batch_size), data)
  assert mets
  setuplib._DONE[0] = False
  agent = debug_agent(tmp_path / 'debug', '--torch.debug', 'True')
  assert guard.KNOBS['debug'] and not guard.KNOBS['transfer_guard']
  assert torch.is_anomaly_enabled()
  with pytest.raises(FloatingPointError, match=r'aten\.\w+'):
    agent.train(agent.init_train(agent.batch_size), data)
  # A clean batch passes every check.
  clean = train_batch(agent)
  agent.train(agent.init_train(agent.batch_size), clean)


class Modes:
  """A stand-in for torch.cuda's sync debug mode (a no-op on the CPU)."""

  NAMES = {'default': 0, 'warn': 1, 'error': 2}

  def __init__(self, monkeypatch, mode=0):
    self.mode = mode
    monkeypatch.setattr(torch.cuda, 'get_sync_debug_mode', lambda: self.mode)
    monkeypatch.setattr(torch.cuda, 'set_sync_debug_mode', self.set)

  def set(self, mode):
    self.mode = self.NAMES.get(mode, mode)


def test_sync_guard_scopes_nest_across_threads(monkeypatch):
  modes = Modes(monkeypatch, mode=1)  # A caller's own 'warn' before.
  syncs = guard.SyncGuard()
  entered, release = threading.Event(), threading.Event()
  seen = {}

  def learner():
    with syncs.guarded():
      entered.set()
      release.wait(10)
      seen['learner_end'] = modes.mode

  thread = threading.Thread(target=learner)
  thread.start()
  assert entered.wait(10)
  assert modes.mode == 2 and syncs.raising
  with syncs.allowed():          # Another thread's explicit crossing.
    assert modes.mode == 1
    with syncs.guarded():        # A nested guard does not override it.
      assert modes.mode == 1
  assert modes.mode == 2
  with syncs.guarded():          # This thread's own guard, nested.
    assert modes.mode == 2
  assert modes.mode == 2         # The learner still holds its guard.
  release.set()
  thread.join(10)
  assert not thread.is_alive()
  assert seen['learner_end'] == 2
  assert modes.mode == 1 and not syncs.raising


def test_sync_guard_under_contention(monkeypatch):
  """Many threads enter and leave nested scopes; the mode ends where it
  began and no holder is left."""
  modes = Modes(monkeypatch)
  syncs = guard.SyncGuard()
  errors = []

  def work(seed):
    rng = np.random.default_rng(seed)
    try:
      for _ in range(200):
        with syncs.guarded():
          if rng.random() < 0.5:
            with syncs.allowed():
              pass
    except Exception as e:  # Reported below, with the thread's seed.
      errors.append((seed, e))

  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for thread in threads:
      thread.start()
    for thread in threads:
      thread.join(30)
  finally:
    sys.setswitchinterval(interval)
  assert not any(thread.is_alive() for thread in threads)
  assert not errors
  assert modes.mode == 0 and not syncs.raising
  assert syncs._guards == syncs._allows == 0


def test_cpu_agent_holds_no_sync_guard(tmp_path, fresh_setup):
  agent = debug_agent(tmp_path)
  assert guard.KNOBS['transfer_guard'] and agent._syncs is None


# --- The profiler window ----------------------------------------------------


def test_profiler_window_writes_a_trace(tmp_path):
  agent = debug_agent(tmp_path, torch_keys={'profiler': True})
  agent._profiler.update(start=2, stop=4)
  data = train_batch(agent)
  carry = agent.init_train(agent.batch_size)
  for _ in range(5):
    carry, _, _ = agent.train(carry, data)
  paths = viewer.find_trace_files(str(tmp_path))
  assert len(paths) == 1
  assert pathlib.Path(paths[0]).parent == tmp_path / 'profile'
  assert paths[0].endswith('.pt.trace.json.gz')
  trace = viewer.load_trace(paths[0])
  assert trace['lanes'] == [] and trace['ops'] == []
  assert dict(trace['annotations'])['train'] == 2  # Updates 2 and 3.
  assert 'No device events' in viewer.render_trace(str(tmp_path))
  assert 'No device events' in viewer.render_trace_page(str(tmp_path))


# --- The segment profiler ---------------------------------------------------


def test_profile_train_on_the_cpu(tmp_path, debug_count):
  out = tmp_path / 'profile.json'
  result = profile_train.main([
      '--configs', 'debug', '--device', 'cpu', '--warmup', '0', '--iters',
      '1', '--out', str(out), '--logdir', str(tmp_path / 'logdir')])
  rows = result['segments']
  for name in profile_train.SEGMENTS:
    for kind in ('fwd', 'fwdbwd'):
      assert rows[f'{name}/{kind}/flops'] > 0, (name, kind)
      assert rows[f'{name}/{kind}/ms'] > 0, (name, kind)
      assert rows[f'{name}/{kind}/mfu'] is None  # No card.
  assert rows['train/flops'] == debug_count
  assert rows['full/fwdbwd/flops'] == rows['train/flops']
  assert out.exists() and result['timing'] == 'wall clock'
