"""The train-script cell: the program's single-process `run.train.train`
on its envs, with acting, env stepping, replay inserts and train steps at
the script's replay ratio.

The script gets a proxy of the agent, which times each `policy` and
`train` call and opens the window once the script has made its first
`warm_train` train calls (set-up, with the agent, the benchmark's
weights, the envs' start and the replay's first fill). The window closes
at the first policy call after `--seconds`: the proxy raises, the script
closes its envs and streams as it ends on any error, and the harness
synchronizes the card.

What `correct` compares: the script's first train calls against the
reference, as in the learner cells (check.py), and every policy call made
while the program's parameters are those of the steps the reference
follows: before the first train call and after each of the first
`check.STEPS`. The reference acts from the same carry, observation and
noise with its own parameters after as many steps. `deter` is the widest
relative distance between the deterministic state that the program's
observe step (kernel 3) returned and the reference's; `act` is the widest
gap by which the score (log-probability plus the call's Gumbel noise) of
the program's action lies below the reference's best. The window's own
policy calls act on parameters that only the program's state holds after
its later train steps, which the reference does not follow.

The first train calls' windows carry context latents that the program's
acting wrote into its latent table; where the reference's own steps
wrote none, it takes the program's (check.replay). The policy calls that
wrote them are the ones compared above. A train call in the window whose
loss is not finite counts as failed.
"""

import functools
import math
import sys
import tempfile
import time

import numpy as np
import torch

from .. import reference
from . import check, learn, port, weights
from .trace import Tracer

LABELS = {'bench/policy': 'inside Agent.policy',
          'bench/train': 'inside Agent.train'}


class StopWindow(Exception):
  """Raised from a policy call once the window is over."""


class Proxy:
  """The agent as the script sees it: every call passes through, timed."""

  def __init__(self, agent, run):
    self._agent = agent
    self._run = run

  def __getattr__(self, name):
    return getattr(self._agent, name)

  def policy(self, carry, obs, mode='train'):
    return self._run.policy(self._agent, carry, obs, mode)

  def train(self, carry, data):
    return self._run.train(self._agent, carry, data)


class Run:
  """The state of one script run: spans, the window and the rows the
  checks need."""

  def __init__(self, spec, seed, seconds, trace, t_start, sizes, initial,
               cuda, fault):
    self.traffic = spec.traffic
    self.settings = spec.config['settings']
    self.seed, self.seconds, self.t_start = seed, seconds, t_start
    self.sizes, self.initial, self.cuda = sizes, initial, cuda
    self.fault = fault
    self.tracer = Tracer(0) if trace and cuda else None
    self.spans = {'policy': [], 'train': []}
    self.env_steps = 0
    self.policy_calls = 0
    self.train_calls = 0
    self.failed = 0
    self.t0 = self.t_end = None
    self.program = {}
    self.batches, self.contexts, self.losses = [], [], {}
    self.samples = []
    self.traced = None

  @property
  def open(self):
    return self.t0 is not None

  def start_window(self):
    if self.cuda:
      torch.cuda.synchronize()
    if self.tracer:
      self.tracer.start()
    self.t0 = time.perf_counter()
    self.setup_s = self.t0 - self.t_start
    print(f'window: open after {self.setup_s:.2f} s of set-up',
          file=sys.stderr)

  def policy(self, agent, carry, obs, mode):
    if self.open and time.perf_counter() - self.t0 >= self.seconds:
      raise StopWindow()
    self.policy_calls += 1
    # The calls made while the parameters are those of the first steps,
    # which the reference follows.
    sample = self.train_calls <= check.STEPS
    if sample:
      held = (reference.nn.core.tree_map(_clone, carry),
              {k: np.array(v) for k, v in obs.items()}, self.policy_calls,
              self.train_calls)
    start = time.perf_counter()
    with torch.profiler.record_function('bench/policy'):
      carry, act, out = agent.policy(carry, obs, mode)
    if self.open:
      self.spans['policy'].append(time.perf_counter() - start)
      self.env_steps += len(obs['is_first'])
      if self.tracer and not self.tracer.done and (
          time.perf_counter() - self.t0 >= self.traffic['trace_seconds']):
        self.tracer.stop()
        self.traced = (self.env_steps, time.perf_counter())
    act = self.fault.act(act)
    if sample:
      self.samples.append((*held, {k: np.array(v) for k, v in act.items()},
                           reference.nn.core.tree_map(_clone, carry[1])))
    return carry, act, out

  def train(self, agent, carry, data):
    self.train_calls += 1
    n = self.train_calls
    if n <= check.STEPS:
      self.batches.append(data)
      self.contexts.append(_contexts(agent, data, int(
          self.settings['replay_context'])))
    start = time.perf_counter()
    with torch.profiler.record_function('bench/train'):
      carry, outs, mets = agent.train(carry, self.fault.step.batch(data))
    if self.open:
      self.spans['train'].append(time.perf_counter() - start)
      if not math.isfinite(check.step_loss(mets)):
        self.failed += 1
    step = int(round(mets.get('opt/updates', 0)))
    if 1 <= step <= check.STEPS:
      self.losses[step] = check.step_loss(mets)
    beta2 = float(self.settings['agent.opt.beta2'])
    if n == 1:
      learn._sync(self.cuda)
      self.program['grad'] = check.first_grad(*check.moments(
          functools.partial(port.state, agent)), self.sizes, beta2)
    if n == check.STEPS:
      learn._sync(self.cuda)
      params = {p: port.state(agent, p) for p, _ in self.sizes}
      self.program['change'] = check.change_norms(
          params, self.initial, self.sizes)
    if not self.open and n >= int(self.traffic['warm_train']) and len(
        self.losses) >= check.STEPS:
      self.start_window()
    return carry, outs, mets


class Fault:
  """A planted fault beneath the timed path for the checks' own test:
  `action` moves every env's action to the next class where the policy
  produced it; `unchanged` and `half_batch` are the train step's faults
  of the learner cells (learn.Fault)."""

  def __init__(self, kind, classes=None):
    assert kind in (None, 'action', 'unchanged', 'half_batch'), kind
    self.kind = kind
    self.classes = classes
    self.step = learn.Fault(kind if kind != 'action' else None)

  def act(self, act):
    if self.kind != 'action':
      return act
    return {k: ((v + 1) % self.classes).astype(v.dtype)
            for k, v in act.items()}


def readings(spec, seed, fault=None, device='cuda'):
  """One seed's readings for the cell's limits (benchmark/control.py):
  a short window at the cell's load (`control_seconds` of its traffic),
  then the
  program's numbers and the control's (the reference computing in
  float8 on the same inputs and noise); with `fault`, the program's
  numbers with that fault planted, and no control."""
  _, _, numbers = run(
      spec, seed, float(spec.traffic['control_seconds']), False,
      time.perf_counter(), device, fault=fault, control=not fault)
  if fault:
    return {'seed': seed, 'program': numbers}
  return {'seed': seed, 'program': numbers[0], 'control': numbers[1]}


def _clone(x):
  return x.detach().clone() if isinstance(x, torch.Tensor) else np.array(x)


def _contexts(agent, data, K):
  """The program's latents at a batch's context steps as its table holds
  them before the call, and whether each is valid there."""
  if 'slot' not in data or not K:
    return None
  if getattr(data, 'ready', None) is not None:
    torch.cuda.current_stream().wait_event(data.ready)
  table = agent._latents
  slots = data['slot'][:, :K]
  gens = data['slotgen'][:, :K]
  if gens.dtype != torch.int32:
    gens = gens.view(torch.int32)
  latents = {k: v.to('cpu') for k, v in table.gather(slots).items()}
  return latents, table.valid(slots, gens).to('cpu')


def run(spec, seed, seconds, trace, t_start, device='cuda', fault=None,
        control=False):
  """One run of the script cell. Returns (result fields, record,
  readings); with `control`, the readings are a pair: the program's and
  the control's (benchmark/control.py)."""
  traffic = spec.traffic
  settings = spec.config['settings']
  cuda = device == 'cuda'
  prog = port.Program(spec.config['program'])
  common, runlib, Config = prog.common, prog.run, prog.utils.Config
  with tempfile.TemporaryDirectory(prefix='bench-') as logdir:
    config = prog.make_config(settings, seed, logdir, device,
                              traffic.get('program'))
    spaces = prog.spaces(config)
    meta = learn.meta_model(spaces, settings)
    sizes = check.leaves(meta)
    (action,) = spaces[1].values()
    state = Run(spec, seed, seconds, trace, t_start, sizes, None, cuda,
                Fault(fault, action.classes))

    def make_agent():
      agent = prog.make_agent(config)
      state.fault.step.plant(agent)
      store = weights.draw(meta, seed, device)
      port.load_weights(agent, store)
      state.initial = {k: v.to('cpu') for k, v in store.items()}
      return Proxy(agent, state)

    args = Config(
        **dict(config.run), replica=config.replica,
        replicas=config.replicas, logdir=config.logdir,
        batch_size=config.batch_size, batch_length=config.batch_length,
        report_length=config.report_length,
        consec_train=config.consec_train,
        consec_report=config.consec_report,
        replay_context=config.replay_context)
    holder = {}

    def make_agent_held():
      holder['agent'] = make_agent()
      return holder['agent']

    try:
      runlib.train(
          make_agent_held, functools.partial(common.make_replay, config,
                                             'replay'),
          functools.partial(prog.make_env, config),
          functools.partial(common.make_stream, config),
          functools.partial(common.make_logger, config), args)
    except StopWindow:
      pass
    learn._sync(cuda)
    state.t_end = time.perf_counter()
    if state.tracer and not state.tracer.done:
      state.tracer.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if not state.open:
      raise RuntimeError('The script ended before its window began')
    agent = holder.pop('agent')._agent
    samples = state.samples
    batches = [{k: v.to('cpu') for k, v in b.items()} for b in state.batches]
    obs_space, act_space = agent.obs_space, agent.act_space
    state.batches = None
    del agent
    learn._free(cuda)

  window_s = state.t_end - state.t0
  spans = state.spans
  busy_host = sum(spans['policy']) + sum(spans['train'])
  record = {'driver': 'script', 'window_s': window_s, 'spans': spans,
            'env_steps': state.env_steps,
            'ticks': len(spans['policy']),
            'env_loop_s': window_s - busy_host}
  if state.tracer:
    record['trace'] = state.tracer.summary(LABELS)
    if state.traced:
      steps, at = state.traced
      record['traced_env_steps'] = steps
      record['untraced'] = {'env_steps': state.env_steps - steps,
                            'seconds': state.t_end - at}
  fields = {
      'attempted': state.env_steps, 'failed': state.failed, 'peak': peak,
      'end_to_end': {'env_steps_per_s': state.env_steps / window_s,
                     'setup_s': state.setup_s}}
  program = dict(state.program, loss=[
      state.losses[n] for n in range(1, check.STEPS + 1)])
  spaces = (obs_space, act_space)
  acts = check.Acting(samples, seed, device)
  ref = check.replay(settings, spaces, state.initial, batches, seed, device,
                     contexts=state.contexts, acting=acts)
  readings = check.compare(program, ref)
  readings.update(check.policy_gaps(samples, acts.outputs))
  if not control:
    return fields, record, readings
  lows = check.Acting(samples, seed, device)
  low = check.replay(settings, spaces, state.initial, batches, seed, device,
                     fp8=True, contexts=state.contexts, acting=lows)
  lowered = check.compare(low, ref)
  lowered.update(check.policy_gaps(samples, acts.outputs, lows.outputs))
  return fields, record, (readings, lowered)
