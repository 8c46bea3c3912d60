"""The learner cells: `Agent.train` back to back on `Agent.stream` over a
replay filled at set-up, as the program's learner runs at a high replay
ratio.

Set-up, all counted in `setup_s`: the program's agent (its own weights
drawn and its FLOP count printed, as users pay them), the benchmark's
weights drawn on the card and loaded, the replay filled by inline envs
under uniform random actions, and the first train calls on the window's
own feed: the `check.STEPS` that the reference follows (see check.py)
and the warm-up calls after them, so that every shape the window runs
has run. Then the window: train calls until `--seconds` have passed on
the host's clock, a CUDA event recorded after each call on the stream
its work runs on, and a synchronize that ends the window.
"""

import contextlib
import functools
import math
import sys
import tempfile
import time

import torch

from .. import reference
from ..reference import flops as refflops
from ..reference import work
from . import check, port, stats, weights
from .trace import Tracer

LABELS = {'bench/next': 'waiting for the stream (batch)',
          'bench/train': 'inside Agent.train',
          'bench/step': 'the harness between calls'}


class Fault:
  """A planted fault, beneath the timed path, for the checks' own test:
  `unchanged` makes each train step leave the parameters and the
  optimizer's moments as they were (its metrics and step count go on);
  `half_batch` trains on the first half of each batch's rows, copied over
  the second half, so the loss is the mean over that half alone. The
  reference is handed the rows as the stream gave them."""

  def __init__(self, kind):
    assert kind in (None, 'unchanged', 'half_batch'), kind
    self.kind = kind

  def plant(self, agent):
    if self.kind != 'unchanged':
      return
    opt = agent.model.opt
    update = opt._update
    moments = [v for k, v in opt.named_buffers() if k != 'step']

    def unchanged(paths, params, vec, loss):
      state = [*params, *moments]
      held = [t.detach().clone() for t in state]
      metrics = update(paths, params, vec, loss)
      with torch.no_grad():
        for t, old in zip(state, held):
          t.copy_(old)
      return metrics
    opt._update = unchanged

  def batch(self, batch):
    if self.kind != 'half_batch':
      return batch
    out = type(batch)()
    for key, value in batch.items():
      half = value.shape[0] // 2
      value = value.clone()
      value[half:2 * half] = value[:half]
      out[key] = value
    if hasattr(batch, 'ready'):
      out.ready = batch.ready
    return out


class Phases:
  """Seconds of each stage of set-up, printed to standard error."""

  def __init__(self, cuda):
    self.cuda = cuda
    self.last = time.perf_counter()

  def __call__(self, name):
    _sync(self.cuda)
    now = time.perf_counter()
    print(f'setup {name}: {now - self.last:.2f} s', file=sys.stderr)
    self.last = now


def meta_model(spaces, settings):
  return reference.build(*spaces, settings, device='meta')


@contextlib.contextmanager
def program_run(spec, seed, device, fault=None):
  """Set-up up to the first train call: the program's agent with the
  benchmark's weights, its replay filled and its stream. Yields a dict of
  them; on leaving, the stream stops and the program's state is freed."""
  traffic = spec.traffic
  settings = spec.config['settings']
  cuda = device == 'cuda'
  phases = Phases(cuda)
  with tempfile.TemporaryDirectory(prefix='bench-') as logdir:
    program = port.Program(spec.config['program'])
    config = program.make_config(settings, seed, logdir, device,
                                 traffic.get('program'))
    spaces = program.spaces(config)
    meta = meta_model(spaces, settings)
    agent = program.make_agent(config)
    phases('agent')
    fault.plant(agent)
    store = weights.draw(meta, seed, device)
    port.load_weights(agent, store)
    initial = {k: v.to('cpu') for k, v in store.items()}
    del store
    phases('weights')
    replay = program.make_replay(config)
    program.fill(agent, config, replay, int(traffic['fill_steps']),
                 int(traffic['envs']), seed)
    stream = program.make_stream(agent, config, replay)
    phases('fill')
    state = dict(agent=agent, feed=iter(stream), replay=replay,
                 config=config, spaces=spaces, sizes=check.leaves(meta),
                 initial=initial, cuda=cuda, fault=fault, phases=phases)
    try:
      yield state
    finally:
      stream.close()
      state.clear()
      del agent, stream, replay
      _free(cuda)


def run(spec, seed, seconds, trace, t_start, device='cuda', fault=None):
  """One run of a learner cell. Returns (result fields, record, the
  numbers `correct` compares)."""
  settings = spec.config['settings']
  with program_run(spec, seed, device, Fault(fault)) as state:
    spaces, initial = state['spaces'], state['initial']
    carry, program, batches = first_steps(
        state, int(spec.traffic['warm_calls']))
    fields, record = window(state, carry, spec, seconds, trace, t_start)
    del carry
    batches = [{k: v.to('cpu') for k, v in b.items()} for b in batches]
  if trace:
    record['flops_per_step'] = _flops(spaces, settings, batches)
    record['work'] = _work(spaces, settings)
  ref = check.replay(settings, spaces, initial, batches, seed, device)
  return fields, record, check.compare(program, ref)


def readings(spec, seed, fault=None, device='cuda'):
  """One seed's readings for the cell's limits (benchmark/control.py):
  {'program': numbers, 'control': numbers}, the control being the
  reference computing in float8; with `fault`, the program's numbers with
  that fault planted, and no control. No window: set-up and the first
  steps, then the reference (and the control) on the same rows."""
  settings = spec.config['settings']
  with program_run(spec, seed, device, Fault(fault)) as state:
    spaces, initial = state['spaces'], state['initial']
    _, program, batches = first_steps(
        state, int(spec.traffic['warm_calls']))
    batches = [{k: v.to('cpu') for k, v in b.items()} for b in batches]
  ref = check.replay(settings, spaces, initial, batches, seed, device)
  out = {'seed': seed, 'program': check.compare(program, ref)}
  if not fault:
    low = check.replay(settings, spaces, initial, batches, seed, device,
                       fp8=True)
    out['control'] = check.compare(low, ref)
  return out


def _sync(cuda):
  if cuda:
    torch.cuda.synchronize()


def first_steps(state, warm_calls):
  """The first train calls on the window's feed: the `check.STEPS` that
  the reference follows, then `warm_calls` more, and as many as it takes
  for the fetch pipeline to hand back the first steps' losses. Returns
  (carry, the program's readings, the first steps' rows on the device)."""
  agent, feed, replay = state['agent'], state['feed'], state['replay']
  sizes, cuda, fault = state['sizes'], state['cuda'], state['fault']
  config = state['config']
  beta2 = float(config.agent.opt.beta2)
  carry = agent.init_train(int(config.batch_size))
  batches, losses, program = [], {}, {}

  def call(carry):
    batch = next(feed)
    carry, outs, mets = agent.train(carry, fault.batch(batch))
    if 'replay' in outs:
      replay.update(outs['replay'])
    step = int(round(mets.get('opt/updates', 0)))
    if 1 <= step <= check.STEPS:
      losses[step] = check.step_loss(mets)
    return carry, batch

  for n in range(1, check.STEPS + 1):
    carry, batch = call(carry)
    batches.append(batch)
    if n == 1:
      _sync(cuda)
      program['grad'] = check.first_grad(*check.moments(
          functools.partial(port.state, agent)), sizes, beta2)
  _sync(cuda)
  params = {p: port.state(agent, p) for p, _ in sizes}
  program['change'] = check.change_norms(params, state['initial'], sizes)
  del params
  calls = check.STEPS
  while calls < check.STEPS + warm_calls or len(losses) < check.STEPS:
    carry, _ = call(carry)
    calls += 1
    if calls > 100:
      raise RuntimeError('The first steps\' losses never came back')
  program['loss'] = [losses[n] for n in range(1, check.STEPS + 1)]
  _sync(cuda)
  state['phases']('first_steps')
  return carry, program, batches


def window(state, carry, spec, seconds, trace, t_start):
  """Train calls back to back for `seconds`. Returns (result fields,
  record)."""
  agent, feed, replay = state['agent'], state['feed'], state['replay']
  cuda, fault, config = state['cuda'], state['fault'], state['config']
  B, T = int(config.batch_size), int(config.batch_length)
  tracer = Tracer(spec.traffic['trace_steps']) if trace and cuda else None
  spans = {'next': [], 'train': []}
  ends, host_ends, failed = [], [], 0
  if tracer:
    tracer.start()
  begin = torch.cuda.Event(enable_timing=True) if cuda else None
  t0 = time.perf_counter()
  setup_s = t0 - t_start
  print(f'window: open after {setup_s:.2f} s of set-up', file=sys.stderr)
  if cuda:
    begin.record()
  steps = 0
  while time.perf_counter() - t0 < seconds:
    a = time.perf_counter()
    with torch.profiler.record_function('bench/next'):
      batch = fault.batch(next(feed))
    b = time.perf_counter()
    with torch.profiler.record_function('bench/train'):
      carry, outs, mets = agent.train(carry, batch)
    c = time.perf_counter()
    with torch.profiler.record_function('bench/step'):
      if cuda:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        ends.append(event)
      host_ends.append(c)
      if 'replay' in outs:
        replay.update(outs['replay'])
      if not math.isfinite(mets.get('opt/loss', 0.0)):
        failed += 1
    spans['next'].append(b - a)
    spans['train'].append(c - b)
    steps += 1
    if tracer and not tracer.done and steps == tracer.steps:
      tracer.stop()
  _sync(cuda)
  window_s = time.perf_counter() - t0
  if tracer and not tracer.done:
    tracer.stop()
  if cuda:
    marks = [begin] + ends
    intervals = [marks[i].elapsed_time(marks[i + 1])
                 for i in range(len(ends))]
  else:
    marks = [t0] + host_ends
    intervals = [1e3 * (marks[i + 1] - marks[i]) for i in range(steps)]
  peak = torch.cuda.max_memory_allocated() if cuda else 0
  record = {'driver': 'learn', 'steps': steps, 'window_s': window_s,
            'frames_per_step': B * T, 'spans': spans,
            'intervals_ms': intervals}
  if tracer:
    record['trace'] = tracer.summary(LABELS)
    record['traced_steps'] = tracer.steps
  fields = {
      'attempted': steps, 'failed': failed, 'peak': peak,
      'end_to_end': {
          'train_frames_per_s': steps * B * T / window_s,
          'train_step_ms_p90': stats.percentile(intervals, 90),
          'setup_s': setup_s}}
  return fields, record


def _free(cuda):
  import gc
  gc.collect()
  if cuda:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _flops(spaces, settings, batches):
  """The products of one train step of the reference at the cell's batch
  (the context's latents in the batch, as the step computes on them)."""
  model = meta_model(spaces, settings)
  batch = {k: v for k, v in batches[0].items()
           if k not in ('slot', 'slotgen')}
  B, L = batch['is_first'].shape
  for key in model.latent_keys:
    space = model.ext_space[key]
    batch[key] = torch.zeros(
        (B, L, *space.shape), dtype=reference.nn.torch_dtype(space.dtype))
  return refflops.train_flops(model, batch)


def _work(spaces, settings):
  token_dim = meta_model(spaces, settings).enc.token_dim
  (space,) = spaces[1].values()
  window, rollout = work.dims(settings, token_dim, space.classes)
  return {'observe_seq': work.observe_window(*window),
          'observe_seq_bwd': work.observe_window_bwd(*window),
          'imagine_seq': work.imagination(*rollout)}
