"""The port's Driver transports and the RSSM's kernel widths, on the CPU.

- The process transport (`parallel=True` or 'process', the default, as in
  the JAX package) mirrors tests/test_driver.py's process cases with
  module-level constructors, and gives the same transitions as the inline
  transport; an unpicklable constructor raises before a process starts.
- The `train` script runs on the `debug` preset through the process
  driver and resumes.
- `_kernel_eligible` is false at the widths the CUDA kernels refuse and
  true at size12m and at the default dims.

Two envs at most: each worker is a spawned interpreter.
"""

import json
import pickle
from functools import partial as bind

import numpy as np
import pytest

from embodied_tpu_torch import core
from embodied_tpu_torch.envs import dummy
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main, rssm
from embodied_tpu_torch.utils import Space

import utils

DISC = bind(dummy.Dummy, 'disc', length=10, size=(8, 8))


class Actions:
  """A deterministic policy: the action of env i at tick t is (i + t) % 5."""

  def __init__(self):
    self.tick = 0

  def __call__(self, carry, obs, **kw):
    n = len(obs['is_first'])
    acts = {'action': ((np.arange(n) + self.tick) % 5).astype(np.int32)}
    self.tick += 1
    return carry, acts, {}


@pytest.mark.parametrize('parallel', [True, 'process'])
def test_parallel_processes(parallel):
  driver = core.Driver([DISC] * 2, parallel=parallel)
  assert driver.parallel == 'process'
  env = DISC()
  agent = utils.TestAgent(env.obs_space, env.act_space)
  driver.reset(agent.init_policy)
  driver(agent.policy, steps=30)
  assert agent.stats()['env_steps'] >= 30
  # After the first transition the payload rides shared memory.
  assert all(entry is not None for entry in driver.shm)
  driver.close()


def test_process_is_the_default():
  driver = core.Driver([DISC])
  assert driver.parallel == 'process'
  driver.close()


def test_parallel_processes_transition_integrity():
  # Counting observations prove step alignment and that the shared views
  # are not clobbered between callbacks.
  records = []
  driver = core.Driver(
      [bind(dummy.Dummy, 'disc', length=7, size=(8, 8))], parallel=True)
  driver.on_step(lambda tran, worker: records.append(
      {k: np.copy(v) for k, v in tran.items()}))
  driver.reset()
  driver(Actions(), episodes=3)
  driver.close()
  count = 0
  for tran in records:
    if tran['is_first']:
      count = 0
    assert int(tran['count']) == count, (tran['count'], count)
    count += 1


def run(parallel, ticks=25):
  rows = []
  driver = core.Driver([DISC] * 2, parallel=parallel)
  driver.on_step(lambda tran, worker: rows.append(
      (worker, {k: np.copy(v) for k, v in tran.items()})))
  driver.reset()
  driver(Actions(), steps=2 * ticks)
  driver.close()
  return rows


def test_process_transport_matches_inline():
  inline, process = run(False), run('process')
  assert len(inline) == len(process) == 50
  for (wa, a), (wb, b) in zip(inline, process):
    assert wa == wb and sorted(a) == sorted(b)
    for key in a:
      np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_unpicklable_ctor_raises():
  def nested():
    return dummy.Dummy('disc')
  for ctor in (lambda: dummy.Dummy('disc'), nested):
    with pytest.raises(TypeError, match='pickle'):
      core.Driver([DISC, ctor], parallel='process')
  # The inline and thread transports take any callable.
  for parallel in (False, 'thread'):
    core.Driver([lambda: dummy.Dummy('disc')], parallel=parallel).close()


def script(logdir, steps):
  main.main([
      '--configs', 'debug', '--task', 'dummy_disc', '--logdir', str(logdir),
      '--run.debug', 'False', '--run.driver', 'process',
      '--batch_size', '2', '--batch_length', '8', '--report_length', '4',
      '--run.steps', str(steps), '--run.train_ratio', '4',
      '--run.log_every', '0.2', '--run.report_every', '0.5',
      '--run.save_every', '0.5', '--run.usage.psutil', 'False'])
  saved = pickle.loads((logdir / 'checkpoint.pkl').read_bytes())
  lines = [json.loads(line) for line in
           (logdir / 'metrics.jsonl').read_text().splitlines()]
  return int(saved['step']), saved['agent']['counters'], lines


def test_train_script_on_the_process_driver(tmp_path, capsys, monkeypatch):
  made = []
  make_driver = main.common.run.loop.make_driver

  def recorded(*args):
    made.append(make_driver(*args))
    return made[-1]
  monkeypatch.setattr(main.common.run.loop, 'make_driver', recorded)
  step, counters, lines = script(tmp_path, 200)
  assert [d.parallel for d in made] == ['process']
  assert 0 < step <= 200 and counters['train'] > 0
  assert any(k.startswith('report/loss/') for line in lines for k in line)
  again, counters2, _ = script(tmp_path, 400)
  assert 'Loading checkpoint' in capsys.readouterr().out
  assert step < again <= 400 and counters2['train'] > counters['train']
  assert [d.parallel for d in made] == ['process', 'process']


def preset(*names):
  config = common.assemble_config(main.CONFIGS, ['--configs', *names])
  r = config.agent.dyn.rssm
  return config, (r.deter, r.blocks, r.hidden, r.stoch, r.classes)


def token_width(config):
  obs_space, _ = common.env_spaces(config)
  spaces = {k: v for k, v in obs_space.items()
            if k not in ('is_first', 'is_last', 'is_terminal', 'reward')}
  enc = config.agent.enc.simple
  return rssm.Encoder(spaces, **dict(enc)).token_dim


@pytest.mark.parametrize('names,eligible', [
    (('debug',), False),       # deter 8 in 4 blocks, hidden 3, stoch 2 x 4
    (('size1m',), True),       # D/g 64, H 64, L 128, K 576
    (('size12m',), True),      # D/g 256, H 256, L 512, K 2304
    (('defaults',), True),     # D/g 1024, H 1024, L 2048, K 9216
])
def test_kernel_widths_of_the_presets(names, eligible):
  config, dims = preset(*names)
  tokens = token_width(config)
  assert (rssm.kernel_widths(*dims) and
          tokens % rssm.KERNEL_TILE == 0) is eligible
  units = config.agent.policy.units
  assert (units % rssm.KERNEL_TILE == 0) is (names != ('debug',))
  if names == ('defaults',):
    assert dims == (8192, 8, 1024, 32, 64) and tokens == 9216


@pytest.mark.parametrize('deter,hidden,blocks,classes,eligible', [
    (8, 3, 4, 4, False),       # the debug widths
    (64, 16, 4, 4, True),
    (64, 24, 4, 4, False),     # hidden not a multiple of 16
    (96, 16, 4, 4, False),     # D/g = 24
    (64, 16, 4, 3, False),     # stoch 4 x 3 = 12
])
def test_kernel_eligible_follows_the_widths(deter, hidden, blocks, classes,
                                            eligible):
  act_space = {'action': Space(np.int32, (), 0, 5)}
  dyn = rssm.RSSM(act_space, token_dim=32, deter=deter, hidden=hidden,
                  stoch=4, classes=classes, blocks=blocks, act='silu')
  assert dyn._kernel_eligible() is eligible
  assert dyn._obs_kernel_eligible() is eligible
  assert dyn._obs_seq_eligible() is eligible
  if eligible:
    narrow = rssm.RSSM(act_space, token_dim=40, deter=deter, hidden=hidden,
                       stoch=4, classes=classes, blocks=blocks, act='silu')
    assert narrow._kernel_eligible() and not narrow._obs_kernel_eligible()
