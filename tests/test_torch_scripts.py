"""The port's `train_eval`, `eval_only` and `pretrain` scripts, the random
agent, and the Agent's fetch pipeline and prefetching stream, on the CPU.

Mirrors tests/test_train_eval.py and tests/test_pretrain.py: the counting
TestAgent of tests/utils.py proves the step accounting, the eval episodes
and eval replay, checkpoint seeding and resume, and that eval_only
restores without training. Then `main.main` runs `script=train_eval` and
`script=eval_only` on the `debug` preset with two envs, and the random
agent under `script=train`. Last, the DreamerV3 Agent at the debug
preset: with `torch.fetch_depth: 3`, call n returns step max(1, n - 3)'s
metrics, equal to those that `fetch_depth: 0` (no pipeline) returns at
call max(1, n - 3); and batches through `agent.stream` train to the same
store as numpy batches.
"""

import json
import pickle
from functools import partial as bind

import numpy as np
import pytest
import torch

from embodied_tpu_torch import core, remote, run
from embodied_tpu_torch.core import clock, streams
from embodied_tpu_torch.envs import Dummy
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.utils import Config, Counter, Logger, Path
from embodied_tpu_torch.utils import TerminalOutput

import utils


def _make_env(index):
  return Dummy('disc', size=(8, 8), length=100)


def _make_agent():
  env = _make_env(0)
  agent = utils.TestAgent(env.obs_space, env.act_space)
  return agent


def _make_replay(args):
  return core.Replay(length=args.batch_length, capacity=1e4, chunksize=64)


def _make_stream(args):
  def make_stream(replay, mode):
    return streams.Stateless(bind(replay.sample, args.batch_size, mode))
  return make_stream


def _make_logger():
  return Logger(Counter(), [TerminalOutput(limit=5)])


def _args(logdir, **kw):
  return Config(dict(
      logdir=str(logdir), steps=600, duration=0, train_ratio=8.0,
      log_every=0.05, report_every=0.05, save_every=0.05, batch_size=4,
      batch_length=8, report_batches=1, consec_report=1, from_checkpoint='',
      envs=2, eval_envs=2, eval_eps=2, debug=True, usage={'psutil': False},
  ), **kw)


class _CaptureLogger:
  """A logger facade that collects the eval episodes' scores."""

  def __init__(self, eval_episodes):
    self.step = Counter()
    self._eval = eval_episodes

  def add(self, mapping, prefix=None):
    for key, value in dict(mapping).items():
      name = f'{prefix}/{key}' if prefix else key
      if name == 'eval_episode/score':
        self._eval.append(float(np.asarray(value)))

  def write(self):
    pass

  def close(self):
    pass


def test_train_eval_protocol_and_eval_accounting(tmp_path):
  args = _args(tmp_path)
  agent = _make_agent()
  eval_episodes = []
  replay_eval = _make_replay(args)
  run.train_eval(
      lambda: agent, bind(_make_replay, args), lambda: replay_eval,
      _make_env, _make_env, _make_stream(args),
      lambda: _CaptureLogger(eval_episodes), args)
  stats = agent.stats()
  assert stats['env_steps'] >= args.steps
  assert stats['replay_steps'] > 0
  assert stats['reports'] >= 1 and stats['saves'] >= 1
  assert stats['loads'] == 0
  assert len(eval_episodes) >= args.eval_eps, eval_episodes
  assert len(replay_eval) > 0
  # Again on the same logdir: it resumes from the checkpoint.
  args = args.update(steps=2 * args.steps)
  run.train_eval(
      lambda: agent, bind(_make_replay, args), lambda: _make_replay(args),
      _make_env, _make_env, _make_stream(args), _make_logger, args)
  assert agent.stats()['loads'] == 1


def test_train_eval_from_checkpoint_seeds_the_agent(tmp_path):
  args = _args(tmp_path / 'first')
  run.train(
      _make_agent, bind(_make_replay, args), _make_env, _make_stream(args),
      _make_logger, args)
  args = _args(tmp_path / 'second',
               from_checkpoint=str(tmp_path / 'first' / 'checkpoint.pkl'))
  agent = _make_agent()
  run.train_eval(
      lambda: agent, bind(_make_replay, args), bind(_make_replay, args),
      _make_env, _make_env, _make_stream(args), _make_logger, args)
  assert agent.stats()['loads'] >= 1


def test_eval_only_restores_and_rolls_out(tmp_path):
  args = _args(tmp_path / 'train')
  run.train(
      _make_agent, bind(_make_replay, args), _make_env, _make_stream(args),
      _make_logger, args)
  ckpt = str(tmp_path / 'train' / 'checkpoint.pkl')
  saved = pickle.loads(Path(ckpt).read_bytes())['agent']
  agent = _make_agent()
  args = _args(tmp_path / 'eval', steps=300, from_checkpoint=ckpt)
  run.eval_only(lambda: agent, _make_env, _make_logger, args)
  stats = agent.stats()
  assert stats['loads'] == 1
  assert stats['env_steps'] - saved['env_steps'] >= args.steps
  # Policy only: no train steps and no saves after the restore.
  assert stats['replay_steps'] == saved['replay_steps']
  assert stats['saves'] == saved['saves']
  with pytest.raises(AssertionError):
    run.eval_only(_make_agent, _make_env, _make_logger,
                  _args(tmp_path, from_checkpoint=''))


def _pretrain_stream(batch_size, length):
  """Offline batches as the caller gives them: fresh sequences each."""
  def factory(_, mode):
    def batches():
      i = 0
      while True:
        i += 1
        is_first = np.zeros((batch_size, length), bool)
        is_first[:, 0] = True
        yield {
            'image': np.zeros((batch_size, length, 8, 8, 3), np.uint8),
            'vector': np.full((batch_size, length, 7), i, np.float32),
            'token': np.zeros((batch_size, length), np.int32),
            'count': np.tile(np.arange(length, dtype=np.int32),
                             (batch_size, 1)),
            'reward': np.zeros((batch_size, length), np.float32),
            'is_first': is_first,
            'is_last': np.zeros((batch_size, length), bool),
            'is_terminal': np.zeros((batch_size, length), bool),
            'action': np.zeros((batch_size, length), np.int32),
            'stepid': np.zeros((batch_size, length, 20), np.uint8),
        }
    return streams.Stateless(batches())
  return factory


def test_pretrain_trains_and_resumes(tmp_path):
  agents = []

  def make_model():
    agents.append(_make_agent())
    return agents[-1]

  def args(steps):
    return Config(
        steps=steps, batch_size=4, batch_length=8, log_every=-1,
        report_every=-1, save_every=-1, consec_report=1, report_batches=1,
        replica=0, from_checkpoint='', logdir=str(tmp_path), duration=0,
        usage={'psutil': False})
  run.pretrain(make_model, _pretrain_stream(4, 8), _make_logger, args(60))
  assert (tmp_path / 'checkpoint.pkl').exists()
  stats = agents[-1].stats()
  assert stats['replay_steps'] > 0 and stats['reports'] > 0
  assert stats['saves'] >= 1
  run.pretrain(make_model, _pretrain_stream(4, 8), _make_logger, args(120))
  assert agents[-1].stats()['loads'] == 1


def test_global_clock_is_local_for_one_replica(monkeypatch):
  clock.setup(True, 0, 1, 0, '')
  tick = clock.GlobalClock(-1)
  assert tick() and tick(skip=True) is False
  assert clock.GlobalClock(0)() is False
  # Two replicas: replica 0 serves the decisions and every clock polls it.
  monkeypatch.setattr(clock, '_CLIENT', None)
  monkeypatch.setattr(clock, '_REPLICA', None)
  monkeypatch.setattr(clock.GlobalClock, '_created', [0])
  port = remote.free_port()
  server = clock.setup(True, 0, 2, port, f'localhost:{port}')
  try:
    tick = clock.GlobalClock(-1)
    assert tick.local is None and tick.clockid == 0
    assert [tick(), tick(), tick(skip=True)] == [False, True, False]
    assert clock.GlobalClock(0)() is False
  finally:
    clock._CLIENT.close()
    server.close()


DEBUG = ['--configs', 'debug', '--task', 'dummy_disc', '--batch_size', '2',
         '--batch_length', '8', '--report_length', '4',
         '--run.train_ratio', '4', '--run.envs', '2', '--run.eval_envs', '2',
         '--run.log_every', '0.2', '--run.report_every', '0.5',
         '--run.save_every', '0.5', '--run.usage.psutil', 'False']


@pytest.fixture
def one_thread():
  """The debug model's ops are tiny: one intra-op thread runs them as
  fast alone and keeps the run from stalling beside other test workers."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def metrics(logdir):
  return [json.loads(line) for line in
          (logdir / 'metrics.jsonl').read_text().splitlines()]


def test_main_runs_train_eval_then_eval_only(tmp_path, capsys, one_thread):
  """train_eval with the latent table (the default): eval episodes and
  eval reports through the table's eval region; then eval_only from its
  checkpoint."""
  logdir = tmp_path / 'train_eval'
  main.main(DEBUG + ['--script', 'train_eval', '--logdir', str(logdir),
                     '--run.steps', '200', '--run.eval_eps', '1'])
  saved = pickle.loads((logdir / 'checkpoint.pkl').read_bytes())
  counters = saved['agent']['counters']
  assert counters['train'] > 0 and counters['report'] >= 2
  latents = saved['agent']['latents']['counters']
  assert latents['train'] > 0 and latents['eval'] > 0
  lines = metrics(logdir)
  assert any(k.startswith('eval/loss/') for line in lines for k in line)
  assert any('eval_episode/score' in line for line in lines)
  valid = [line['train/latents/valid'] for line in lines
           if 'train/latents/valid' in line]
  assert valid and all(0 <= v <= 1 for v in valid) and max(valid) > 0
  assert 'Loading checkpoint' not in capsys.readouterr().out
  evaldir = tmp_path / 'eval_only'
  main.main(DEBUG + ['--script', 'eval_only', '--logdir', str(evaldir),
                     '--run.steps', '220', '--run.from_checkpoint',
                     str(logdir / 'checkpoint.pkl')])
  assert 'Loading checkpoint' in capsys.readouterr().out
  assert any('episode/score' in line for line in metrics(evaldir))


def test_main_runs_the_random_agent(tmp_path, one_thread):
  logdir = tmp_path / 'random'
  config = common.assemble_config(main.CONFIGS, DEBUG + [
      '--random_agent', 'True', '--torch.device', 'cuda'])
  assert isinstance(main.make_agent(config), core.RandomAgent)
  main.main(DEBUG + ['--random_agent', 'True', '--logdir', str(logdir),
                     '--run.steps', '220'])
  saved = pickle.loads((logdir / 'checkpoint.pkl').read_bytes())
  assert saved['agent'] is None
  lines = metrics(logdir)
  assert any('episode/score' in line for line in lines)
  assert max(line['step'] for line in lines) >= 200


def test_script_pretrain_from_main_names_the_dataset_reader(tmp_path):
  with pytest.raises(NotImplementedError, match='data/bag.py'):
    main.main(DEBUG + ['--script', 'pretrain', '--logdir', str(tmp_path)])


def port_agent(*extra):
  config = common.assemble_config(main.CONFIGS, [
      '--configs', 'debug', '--task', 'dummy_disc',
      '--torch.compute_dtype', 'float32', *extra])
  return main.make_agent(config, device='cpu')


def batches(agent, n, seed=0):
  """n train batches on the table path with different observations."""
  rng = np.random.default_rng(seed)
  config = agent.config
  out = []
  for _ in range(n):
    data = agent._example_batch(
        config.batch_size, config.batch_length + config.replay_context)
    data['image'][:] = rng.integers(0, 256, data['image'].shape)
    data['is_first'][:, 0] = True
    out.append(data)
  return out


@pytest.mark.parametrize('depth,latent_slots', [
    (3, '-1'), (3, '0'), (1, '-1')])
def test_fetch_pipeline_returns_step_n_minus_depth(depth, latent_slots):
  """Call n of fetch_depth k returns step max(1, n - k)'s outputs: those
  that fetch_depth 0 (no pipeline) returns at call max(1, n - k)."""
  deep = port_agent('--torch.fetch_depth', str(depth),
                    '--torch.latent_slots', latent_slots)
  flat = port_agent('--torch.fetch_depth', '0',
                    '--torch.latent_slots', latent_slots)
  data = batches(deep, 6)
  carries = [deep.init_train(4), flat.init_train(4)]
  got, want = [], []
  for batch in data:
    carries[0], outs, mets = deep.train(carries[0], batch)
    got.append((outs, mets))
    carries[1], outs, mets = flat.train(carries[1], batch)
    want.append((outs, mets))
  assert len({m['opt/loss'] for _, m in want}) == len(want)
  for n, (outs, mets) in enumerate(got, 1):
    wouts, wmets = want[max(1, n - depth) - 1]
    assert mets == wmets, n
    assert sorted(outs) == sorted(wouts)
    for key, value in outs.get('replay', {}).items():
      np.testing.assert_array_equal(value, wouts['replay'][key])
  assert ('replay' in want[0][0]) == (latent_slots == '0')


def test_stream_batches_train_as_numpy_batches():
  """Batches prefetched through agent.stream give the same steps and the
  same store as the numpy batches given to train directly."""
  fed, direct = port_agent(), port_agent()
  data = batches(fed, 3, seed=1)
  stream = iter(fed.stream(streams.Stateless(iter(data))))
  carries = [fed.init_train(4), direct.init_train(4)]
  for batch in data:
    prefetched = next(stream)
    assert type(prefetched).__name__ == 'DeviceBatch'
    carries[0], _, got = fed.train(carries[0], prefetched)
    carries[1], _, want = direct.train(carries[1], batch)
    assert got == want
  store = direct.save()['store']
  for key, value in fed.save()['store'].items():
    np.testing.assert_array_equal(value, store[key], err_msg=key)
