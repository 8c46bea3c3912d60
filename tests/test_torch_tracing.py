"""The port's spans (utils/timer.py) on the CPU, at the debug preset.

- With the profiler off, a train call, a policy call and every kernel
  wrapper (forced onto its kernel path with the launch stubbed) enter no
  `record_function`, and the wrappers still count their launches.
- `timer.totals()` counts one of each `train/*` section per train call
  and one of each `policy/*` section per policy call; `stats()`'s reset
  leaves it alone.
- Under torch.profiler a train call's trace holds `train/loss`,
  `train/backward`, `train/update` and `train/fetch_wait` inside
  `train#<n>`, in that order, and each wrapper's range by its name.
- A Driver tick records `driver/envs` and `driver/callbacks`, a prefetching
  stream's `next` `stream/wait`; a thread the profiler does not record
  opens no range; `timer.untraced()` counts from the first section after
  a trace.
"""

import functools
import inspect
import threading

import numpy as np
import pytest
import torch

from embodied_tpu_torch import core
from embodied_tpu_torch.core import streams
from embodied_tpu_torch.envs import dummy
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.ops import (
    blockgru, imagine, imagine_seq, observe, observe_seq, qcore)
from embodied_tpu_torch.utils import timer

TRAIN = ('train/batch', 'train/loss', 'train/backward', 'train/update',
         'train/latents', 'train/fetch_wait')
POLICY = ('policy/step', 'policy/latents', 'policy/fetch_wait')
PHASES = ('train/loss', 'train/backward', 'train/update', 'train/fetch_wait')


@pytest.fixture
def entered(monkeypatch):
  """The names of the `record_function` ranges entered, on any thread."""
  names = []
  enter = torch.autograd.profiler.record_function.__enter__

  def counted(self):
    names.append(self.name)
    return enter(self)
  monkeypatch.setattr(torch.autograd.profiler.record_function, '__enter__',
                      counted)
  return names


def _profile():
  return torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU])


def _delta(before, after):
  return {k: after[k][1] - before.get(k, (0.0, 0))[1] for k in after
          if after[k][1] != before.get(k, (0.0, 0))[1]}


@pytest.fixture(scope='module')
def agent(tmp_path_factory):
  config = common.assemble_config(main.CONFIGS, [
      '--configs', 'debug', '--task', 'dummy_disc', '--logdir',
      str(tmp_path_factory.mktemp('tracing')), '--torch.precompile',
      'False'])
  agent = main.make_agent(config)
  assert agent._latents is not None and agent._fetch_depth == 3
  return agent


def _batch(agent):
  data = agent._example_batch(
      agent.batch_size, agent.batch_length + agent.replay_context)
  rng = np.random.default_rng(0)
  data['image'] = rng.integers(0, 256, data['image'].shape, np.uint8)
  return data


def _obs(agent):
  obs = agent._example_obs(2)
  obs['is_first'][:] = True
  return obs


def _steady(agent):
  """Train calls until each call waits for an earlier step's outputs."""
  carry = agent.init_train(agent.batch_size)
  while len(agent._pending_train) < agent._fetch_depth:
    carry, _, _ = agent.train(carry, _batch(agent))
  return carry


def test_profiler_off_enters_no_record_function(agent, entered):
  carry = _steady(agent)
  entered.clear()
  agent.train(carry, _batch(agent))
  agent.policy(agent.init_policy(2), _obs(agent))
  assert entered == []


def test_totals_count_each_span_once_a_call(agent):
  carry = _steady(agent)
  before = timer.totals()
  timer.stats(reset=True)
  for _ in range(2):
    carry, _, _ = agent.train(carry, _batch(agent))
    agent.policy(agent.init_policy(2), _obs(agent))
  counts = _delta(before, timer.totals())
  for name in TRAIN + POLICY:
    assert counts.get(name) == 2, (name, counts)
  assert timer.stats(reset=False)['train/loss/total'] > 0


def test_a_traced_train_call_nests_its_phases(agent):
  carry = _steady(agent)
  step = agent._counters['train'] + 1
  with _profile() as prof:
    agent.train(carry, _batch(agent))
  events = {}
  for ev in prof.events():
    events.setdefault(ev.name, []).append(ev.time_range)
  (outer,) = events[f'train#{step}']
  spans = []
  for name in PHASES:
    (span,) = events[name]
    assert outer.start <= span.start and span.end <= outer.end, name
    spans.append(span)
  for first, then in zip(spans, spans[1:]):
    assert first.end <= then.start
  assert 'train/batch' in events and 'train/latents' in events


# Each kernel wrapper, forced off its CPU path, with what it launches
# replaced by a stub: (module, wrapper, the names the stub replaces).
WRAPPERS = [
    (blockgru, 'core_step', ('launch',)),
    (blockgru, 'core_step_bwd', ('launch_bwd',)),
    (observe, 'obs_step', ('launch',)),
    (observe, 'obs_step_bwd', ('launch_bwd',)),
    (observe_seq, 'observe_seq', ('_ObserveSeq',)),
    (observe_seq, 'observe_seq_bwd', ('launch_bwd',)),
    (imagine, 'imag_step', ('launch',)),
    (imagine_seq, 'imagine_seq', ('_ImagineSeq',)),
    (qcore, 'qobs_window', ('launch',)),
]


class _Stub:
  calls = 0

  def __call__(self, *args, **kwargs):
    _Stub.calls += 1
    return 'out'

  apply = __call__


@pytest.mark.parametrize('module, name, stubs', WRAPPERS,
                         ids=[w[1] for w in WRAPPERS])
def test_a_kernel_wrapper_ranges_only_under_the_profiler(
    module, name, stubs, monkeypatch, entered):
  monkeypatch.setattr(blockgru, 'takes_plain', lambda x: False)
  monkeypatch.setattr(blockgru, 'needs_grad', lambda *xs: False)
  for stub in stubs:
    monkeypatch.setattr(module, stub, _Stub())
  wrapper = getattr(module, name)
  required = [p for p in inspect.signature(wrapper).parameters.values()
              if p.default is inspect.Parameter.empty]
  call = functools.partial(wrapper, *[torch.zeros(1)] * len(required))
  launches, calls = wrapper.launches, _Stub.calls
  assert call() == 'out'
  assert entered == []
  with _profile() as prof:
    assert call() == 'out'
  assert entered == [name]
  assert name in {ev.name for ev in prof.events()}
  assert wrapper.launches == launches + 2 and _Stub.calls == calls + 2


def test_a_driver_tick_records_its_sections():
  env = functools.partial(dummy.Dummy, 'disc', length=10, size=(8, 8))
  driver = core.Driver([env] * 2, parallel=False)
  rows = []
  driver.on_step(lambda row, i, **kw: rows.append(i))
  space = driver.act_space['action']

  def policy(carry, obs, **kw):
    n = len(obs['is_first'])
    return carry, {'action': np.zeros((n,), space.dtype)}, {}
  driver.reset()
  before = timer.totals()
  driver(policy, steps=6)
  counts = _delta(before, timer.totals())
  assert counts['driver/envs'] == counts['driver/callbacks'] == 3
  assert len(rows) == 6
  driver.close()


def test_a_stream_wait_is_a_section():
  stream = streams.Prefetch(iter(range(10)), amount=2)
  before = timer.totals()
  assert [next(stream) for _ in range(3)] == [0, 1, 2]
  assert _delta(before, timer.totals())['stream/wait'] == 3
  stream.close()


def test_a_section_ranges_only_where_the_profiler_records(entered):
  with timer.section('tracing/off'):
    pass
  assert entered == []
  seen = []

  def other():
    with timer.section('tracing/thread'):
      seen.append(timer.profiling())
  with _profile() as prof:
    with timer.section('tracing/on'), timer.range('tracing/range'):
      thread = threading.Thread(target=other)
      thread.start()
      thread.join(10)
  assert not thread.is_alive() and seen == [False]
  assert entered == ['tracing/on', 'tracing/range']
  names = {ev.name for ev in prof.events()}
  assert {'tracing/on', 'tracing/range'} <= names
  assert 'tracing/thread' not in names
  assert timer.totals()['tracing/thread'][1] >= 1
  # The first section after the trace marks where `untraced` counts from.
  for _ in range(3):
    with timer.section('tracing/after'):
      pass
  after = timer.untraced()
  assert after['tracing/after'][1] == 3 and 'tracing/on' not in after
