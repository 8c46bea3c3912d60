"""One gloo rank of tests/test_torch_distributed.py.

    python tests/torch_distributed_worker.py CASE RANK WORLD PORT DIR

Reads DIR/inputs.pkl, joins a gloo group of WORLD ranks at localhost:PORT
through the port's make_agent (RANK and WORLD_SIZE in the environment,
as a multi-host launcher sets them) and writes DIR/rank<RANK>.pkl. Imports
no JAX. Cases:

  step       for each of `runs`, a family's agent (family, argv, local
             rows, initial store, global batch, the one-rank step's
             recorded noise): one Agent.train step on the rank's rows with
             its rows of the noise; the metrics, the store after the step,
             a save in groups of `chunk_bytes`, the placements; with
             `shardmap`, the same step on an agent under torch.shardmap;
             with `learner`, the same step made by the parallel script's
             _Learner on a fresh agent, fed the rank's rows in process
             (its logged train metrics, the store after it and the
             replay updates it sent);
             with `values`, a perc and a meanstd Normalize updated on the
             rank's share of them.
  multihost  DreamerV3 at the debug size with the defaults (the latent
             table, the fetch pipeline), batch_size 4 per process: the
             global batch size and the loss of two train steps; and
             whether an agent under torch.shardmap has a latent table.
  sharded    tests/test_torch_sharded.py: for each of `placements`, a
             family's agent on a mesh that loads a whole store: its
             slices, coordinate, placements, store bytes and, with
             `flops`, its FLOP count; and the same under torch.shardmap.
             For each of `steps`, a step as in `step` on its mesh, with
             the collectives the step and the policy calls made, the
             store bytes between calls, the grouped save, and the
             outputs of the policy copy on one observation and noise.
  lockstep   tests/test_torch_parallel_group.py: run/parallel_impl.py's
             _Learner over in-process feeds (rank 1's train feed slow,
             its eval feed late) with a stub agent whose train step makes
             one all-reduce; rank 0's stop request fires after
             `request_s`. The train calls, the train-call indices of the
             reports (with or without an evaluation) and of the saves,
             the seconds from the request to the learner's end, and the
             threads that called a collective after set-up.
  threads    tests/test_torch_parallel_group.py: for each of `placements`
             (a mesh and a policy mesh), a DreamerV3 agent whose train
             steps and saves run on a thread named 'learner', with
             batches from agent.stream's prefetch thread, while this
             thread makes policy calls; the threads that called a
             collective, and the policy calls made.
  kept       tests/test_torch_parallel_group.py: a gloo group that the
             rank starts itself, as a launcher does for ranks that share
             one card; the devices of setup on it, and the errors of
             setup with another rank or world size than the group's.
  tensor_parallel
             tests/test_torch_tensor_parallel.py, on two ranks at '1,1,2':
             for each of `steps`, a step as in `sharded` of a family's
             agent; for each of `costs`, a family's train_cost; then for
             each layer of `split_layers`, its output and gradients
             (inputs' whole, kernels' and embeddings' this rank's and
             joined over 't' by nn.opt.join_parts) under split_over the
             two ranks, and the gradients joined by `planted_join`,
             which also sums the replicated entries over 't'; and the
             MLP's `optimizer_step` in each slot layout under it.
  ring       tests/test_torch_ring.py: a gloo group of its own (no
             agent); ring_attention_sharded on global q, k, v in float32
             (full and causal) and bfloat16 (causal), the gradients of a
             loss of its causal float32 output, and Attention(impl='ring')
             and a ring-mode Transformer on the rank's block of x, from
             stores that load their JAX parameters.
"""

import importlib
import os
import pickle
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def make(family, argv):
  from embodied_tpu_torch.models import common
  main = importlib.import_module(f'embodied_tpu_torch.models.{family}.main')
  config = common.assemble_config(main.CONFIGS, argv)
  return main.make_agent(config, device='cpu'), config


def step(agent, inputs):
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.tools.dryrun_multidevice import RankDraws, rows
  agent.load({'store': inputs['store']})
  local = inputs['local']
  index = agent.mesh.data_index
  draws = RankDraws(inputs['recorded'], index, agent.nbatch)
  agent._draws = lambda kind, salt: draws
  _, outs, mets = agent.train(
      agent.init_train(local), rows(inputs['batch'], index, local))
  assert draws.used_all(), (draws.calls, len(draws.recorded))
  store = {k: v.detach().numpy().copy()
           for k, v in nn.store(agent.model).items()}
  return dict(mets=mets, outs=outs, store=store)


def case_step(inputs, port):
  return [run_step(run, port) for run in inputs['runs']]


def run_step(inputs, port):
  from embodied_tpu_torch import nn
  argv = inputs['argv'] + [
      '--batch_size', str(inputs['local']),
      '--torch.coordinator_address', f'localhost:{port}']
  agent, _ = make(inputs['family'], argv)
  out = step(agent, inputs)
  out.update(
      batch_size=agent.batch_size, data_index=agent.mesh.data_index,
      use_shardmap=agent.use_shardmap, shardings=agent.shardings,
      save=agent.save(chunk_bytes=inputs['chunk_bytes'])['store'])
  if inputs.get('shardmap'):
    other, _ = make(inputs['family'], argv + ['--torch.shardmap', 'True'])
    out['shardmap'] = step(other, inputs)
    out['shardmap'].update(use_shardmap=other.use_shardmap,
                           shardings=other.shardings)
  if inputs.get('learner'):
    out['learner'] = learner_step(inputs, argv)
  if 'values' in inputs:
    half = np.split(inputs['values'], agent.nbatch)[agent.mesh.data_index]
    stats = {}
    for impl in ('perc', 'meanstd'):
      norm = nn.Normalize(impl, rate=0.5, name=impl)
      with nn.opt.reduce_over(agent.data_group):
        norm.update(torch.tensor(half))
      stats[impl] = {k: v.numpy().copy()
                     for k, v in norm.state_dict().items()}
    out['normalize'] = stats
  return out


class Feed:
  """An in-process sample feed of the parallel script's _Learner: the
  `batches`, each after `delay` seconds (the first after `first`), then
  it waits until closed; `count` is the batches it gave."""

  def __init__(self, batches, delay=0.0, first=None):
    self.batches, self.count = batches, 0
    self.delays = (delay if first is None else first, delay)
    self.closed = threading.Event()

  def __iter__(self):
    for batch in self.batches:
      if self.closed.wait(self.delays[bool(self.count)]):
        return
      self.count += 1
      yield batch
    self.closed.wait()

  def close(self):
    self.closed.set()


class Calls:
  """A stub RPC client that records its calls and runs `then` after each."""

  def __init__(self, then=None):
    self.calls, self.then = [], then

  def call(self, method, data):
    self.calls.append((method, data))
    if self.then:
      self.then()

  def close(self):
    pass


def learner_args(logdir, **kw):
  from embodied_tpu_torch.utils import Config
  return Config(dict(
      batch_size=2, batch_length=4, consec_report=1, report_batches=1,
      eval_envs=1, log_every=-1, report_every=0, save_every=0,
      logdir=str(logdir), from_checkpoint='', usage={'psutil': False}),
      **kw)


def learner_step(inputs, argv):
  """One train step of the parallel script's _Learner on the rank's rows
  (the `step` case's agent, store and noise); it stops once its step's
  replay update is sent."""
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.run import parallel_impl
  from embodied_tpu_torch.tools.dryrun_multidevice import RankDraws, rows
  agent, config = make(inputs['family'], argv)
  agent.load({'store': inputs['store']})
  index = agent.mesh.data_index
  draws = RankDraws(inputs['recorded'], index, agent.nbatch)
  agent._draws = lambda kind, salt: draws
  request = threading.Event()
  logger, updater = Calls(), Calls(then=request.set)
  feeds = {'train': Feed([rows(inputs['batch'], index, inputs['local'])]),
           'report': Feed([]), 'eval': Feed([])}
  folder = os.path.join(os.environ['WORKER_DIR'], f'learner{index}')
  learner = parallel_impl._Learner(
      agent, learner_args(folder, batch_size=inputs['local'],
                          batch_length=config.batch_length),
      request, feeds, logger, updater)
  try:
    learner.run()
  finally:
    learner.close()
  assert learner.steps == 1 and draws.used_all(), learner.steps
  mets = {k[len('train/'):]: v for _, data in logger.calls
          for k, v in data.items() if k.startswith('train/')}
  store = {k: v.detach().numpy().copy()
           for k, v in nn.store(agent.model).items()}
  return dict(mets=mets, store=store, data_index=index,
              outs={'replay': updater.calls[0][1]})


class LockstepAgent:
  """A stub agent whose train step makes one all-reduce."""

  def __init__(self):
    self.trains = 0

  def stream(self, source):
    from embodied_tpu_torch.core import streams
    return streams.Prefetch(source, amount=2)

  def init_train(self, batch_size):
    return None

  init_report = init_train

  def train(self, carry, batch):
    import torch.distributed as dist
    value = torch.ones(1)
    dist.all_reduce(value)
    self.trains += 1
    return carry, {}, {'ranks': float(value)}

  def report(self, carry, batch):
    return carry, {'score': 1.0}

  def save(self):
    return {'trains': self.trains}

  def load(self, data):
    self.trains = data['trains']


def recording(threads):
  """torch.distributed's collectives replaced by ones that add the name
  of their calling thread to `threads`; returns a function that puts the
  originals back."""
  import torch.distributed as dist
  names = COLLECTIVES + ('all_gather_object', 'barrier')
  originals = {name: getattr(dist, name) for name in names}

  def wrap(name):
    def fn(*args, **kw):
      threads.add(threading.current_thread().name)
      return originals[name](*args, **kw)
    return fn
  for name in names:
    setattr(dist, name, wrap(name))
  return lambda: [setattr(dist, k, v) for k, v in originals.items()]


def case_lockstep(inputs, port):
  import itertools
  import time
  import torch.distributed as dist
  from embodied_tpu_torch.run import parallel_impl
  rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
  dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                          rank=rank, world_size=world)

  class Learner(parallel_impl._Learner):
    reports, saves = [], []

    def _report(self, report, evals):
      self.reports.append((self.steps, evals is not None))
      super()._report(report, evals)

    def _save(self):
      self.saves.append(self.steps)
      super()._save()

  batch = {'x': np.zeros((2, 5), np.float32)}
  slow = inputs['slow'] if rank == 1 else 0.0
  feeds = {
      'train': Feed(itertools.repeat(batch), delay=slow),
      'report': Feed(itertools.repeat(batch)),
      'eval': Feed(itertools.repeat(batch), first=(
          inputs['late'] if rank == 1 else 0.0))}
  request = threading.Event()
  learner = Learner(
      LockstepAgent(), learner_args(
          os.path.join(os.environ['WORKER_DIR'], f'rank{rank}'),
          log_every=0.2, report_every=inputs['report_every'],
          save_every=inputs['save_every']),
      request, feeds, Calls(), Calls())
  threads = set()
  restore = recording(threads)
  ended = {}

  def learn():
    try:
      learner.run()
    finally:
      ended['at'] = time.time()
      learner.close()
  thread = threading.Thread(target=learn, name='learner')
  thread.start()
  if rank == 0:
    time.sleep(inputs['request_s'])
    request.set()
  requested = time.time()
  thread.join(inputs['join_s'])
  if thread.is_alive():
    print('the learner did not end', flush=True)
    os._exit(1)
  restore()
  return dict(trains=learner.steps, reports=Learner.reports,
              saves=Learner.saves, threads=sorted(threads),
              stop_s=ended['at'] - requested, agent_trains=learner.agent.trains)


def case_threads(inputs, port):
  import time
  coordinator = ['--torch.coordinator_address', f'localhost:{port}']
  out = []
  for mesh, policy_mesh in inputs['placements']:
    argv = inputs['argv'] + ['--torch.mesh', mesh] + coordinator
    if policy_mesh:
      argv += ['--torch.policy_mesh', policy_mesh]
    agent, config = make('dreamerv3', argv)
    rows = config.batch_size
    batches = [agent._example_batch(rows, config.batch_length + 1)
               for _ in range(inputs['steps'])]
    for data in batches:
      data['is_first'][:, 0] = True
    obs = agent._example_obs(rows)
    threads, calls, counts = set(), [0], {}
    restore = recording(threads)

    def learn():
      carry = agent.init_train(rows)
      stream = iter(agent.stream(iter(batches)))
      for _ in batches:
        carry, _, _ = agent.train(carry, next(stream))
        agent.save()
    thread = threading.Thread(target=learn, name='learner')
    thread.start()
    carry = agent.init_policy(rows)
    while thread.is_alive():
      carry, _, _ = agent.policy(carry, obs)
      calls[0] += 1
      time.sleep(0.001)
    thread.join()
    restore()
    counts.update(threads=sorted(threads), policy_calls=calls[0],
                  trains=agent._counters['train'],
                  sharded=bool(agent._shards), split=bool(agent._split),
                  policy_copy=agent._policy_copy is not None)
    out.append(counts)
  return out


def case_kept(inputs, port):
  import datetime
  import torch.distributed as dist
  # The module, which parallel/__init__ shadows with its function.
  setup = importlib.import_module('embodied_tpu_torch.parallel.setup')
  rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
  address = f'localhost:{port}'
  dist.init_process_group(
      'gloo', init_method=f'tcp://{address}', rank=rank, world_size=world,
      timeout=datetime.timedelta(seconds=60))
  devices = setup.setup(device='cpu', coordinator_address=address)
  errors = []
  for other in (dict(rank=world - 1 - rank), dict(world_size=world + 1)):
    setup._DONE[0] = False
    try:
      setup.setup(device='cpu', coordinator_address=address, **other)
    except RuntimeError as e:
      errors.append(str(e))
  return dict(devices=len(devices), errors=errors)


def case_multihost(inputs, port):
  agent, config = make('dreamerv3', [
      '--configs', 'debug', '--task', 'dummy_disc', '--batch_size', '4',
      '--batch_length', '8', '--logdir', inputs['logdir'],
      '--torch.coordinator_address', f'localhost:{port}'])
  local = config.batch_size
  data = agent._example_batch(local, config.batch_length + 1)
  data['is_first'][:, 0] = True
  carry = agent.init_train(local)
  for _ in range(2):
    carry, _, mets = agent.train(carry, data)
  shardmap, _ = make('dreamerv3', [
      '--configs', 'debug', '--task', 'dummy_disc',
      '--logdir', inputs['logdir'], '--torch.shardmap', 'True'])
  return dict(batch_size=agent.batch_size, loss=mets['opt/loss'],
              table=agent._latents is not None,
              shardmap_table=shardmap._latents is not None)


COLLECTIVES = ('all_reduce', 'all_gather', 'broadcast',
               'all_gather_into_tensor', 'reduce_scatter_tensor')


def counting(counts):
  """torch.distributed's collectives replaced by ones that count their
  calls into `counts` ({name: calls}); returns a function that puts the
  originals back."""
  import torch.distributed as dist
  originals = {name: getattr(dist, name) for name in COLLECTIVES}

  def wrap(name):
    def fn(*args, **kw):
      counts[name] = counts.get(name, 0) + 1
      return originals[name](*args, **kw)
    return fn
  for name in COLLECTIVES:
    setattr(dist, name, wrap(name))
  return lambda: [setattr(dist, k, v) for k, v in originals.items()]


def host(tensors):
  return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def case_sharded(inputs, port):
  from embodied_tpu_torch import nn
  coordinator = ['--torch.coordinator_address', f'localhost:{port}']
  out = {'placements': [], 'steps': {}}
  for run in inputs['placements']:
    argv = run['argv'] + ['--torch.mesh', run['spec']] + coordinator
    agent, _ = make(run['family'], argv)
    agent.load({'store': run['store']})
    other, _ = make(run['family'], argv + ['--torch.shardmap', 'True'])
    count = lambda a: a.train_cost()['flops'] if run['flops'] else None
    out['placements'].append(dict(
        family=run['family'], spec=run['spec'], coords=agent.mesh.coords,
        local=host(nn.store(agent.model)), shardings=agent.shardings,
        bytes=agent.store_bytes(), flops=count(agent),
        shardmap=dict(shardings=other.shardings, bytes=other.store_bytes(),
                      flops=count(other))))
  for run in inputs['steps']:
    out['steps'][run['label']] = mesh_step(run, coordinator)
  return out


def mesh_step(run, coordinator):
  """A step as in `step` of a family's agent (default DreamerV3) on the
  mesh `run['mesh']`: the collectives the step and the policy calls
  made, the store bytes between calls, the grouped save, and the
  outputs of the policy copy on one observation and noise."""
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.tools.dryrun_multidevice import RankDraws, rows
  argv = run['argv'] + [
      '--batch_size', str(run['local']), '--torch.mesh', run['mesh'],
      *coordinator]
  agent, _ = make(run.get('family', 'dreamerv3'), argv)
  agent.load({'store': run['store']})
  index = agent.mesh.data_index
  draws = RankDraws(run['recorded'], index, agent.nbatch)
  agent._draws = lambda kind, salt: draws
  counts = {}
  restore = counting(counts)
  try:
    _, outs, mets = agent.train(
        agent.init_train(run['local']),
        rows(run['batch'], index, run['local']))
  finally:
    restore()
  assert draws.used_all(), (draws.calls, len(draws.recorded))
  got = dict(
      mets=mets, outs=outs, store=host(nn.store(agent.model)),
      step_collectives=counts, bytes=agent.store_bytes(),
      data_index=index, coords=agent.mesh.coords,
      save=agent.save(chunk_bytes=run['chunk_bytes'])['store'])
  if 'obs' not in run:
    return got
  counts = {}
  restore = counting(counts)
  try:
    gen = torch.Generator().manual_seed(5)
    obs = {k: torch.as_tensor(v) for k, v in run['obs'].items()}
    count = len(obs['is_first'])
    with torch.inference_mode():
      _, act, pouts = agent._policy_model().policy(
          agent.init_policy(count), obs, 'train', gen)
    agent.policy(agent.init_policy(count), run['obs'])
  finally:
    restore()
  got.update(policy_collectives=counts, act=host(act),
             policy_outs=host(pouts))
  return got


def split_layers():
  """{name: (module, inputs)}: one module of each layer kind that splits
  over 't' (float32, seeded, every kernel and embedding's last dimension
  even) and numpy inputs for `apply_layer`."""
  from embodied_tpu_torch import nn
  f32 = dict(cdtype=torch.float32)
  rng = np.random.default_rng(0)
  x = lambda *shape: rng.standard_normal(shape).astype(np.float32)
  layers = {
      'linear': (nn.Linear(6, 8, 'linear', **f32), [x(3, 5, 6)]),
      'linear_tuple': (nn.Linear(6, (4, 2), 'linear', **f32), [x(3, 6)]),
      'blocklinear': (nn.BlockLinear(8, 8, 2, 'block', **f32), [x(3, 8)]),
      'conv2d': (nn.Conv2D(3, 4, 3, 'conv', stride=2, **f32),
                 [x(2, 6, 6, 3)]),
      'conv2d_transp': (nn.Conv2D(4, 3, 4, 'conv', stride=2, transp=True,
                                  **f32), [x(2, 3, 3, 4)]),
      'conv3d': (nn.Conv3D(2, 4, 3, 'conv', stride=1, **f32),
                 [x(2, 4, 4, 4, 2)]),
      'embed': (nn.Embed(5, 6, 'embed', **f32),
                [rng.integers(0, 5, (3, 4)).astype(np.int32)]),
      'gru': (nn.GRU(3, 4, 'gru', **f32),
              [x(2, 4), x(2, 3, 3), rng.random((2, 3)) < 0.3]),
      'attention': (nn.Attention(8, 8, 2, 'attn', kvheads=1, **f32),
                    [x(2, 5, 8)]),
      'mlp': (nn.MLP(6, 2, 8, 'mlp', **f32), [x(3, 6)]),
  }
  for seed, (module, _) in enumerate(layers.values()):
    nn.init_params(module, seed)
  return layers


def apply_layer(name, module, args):
  if name == 'gru':
    return module(*args)[1]
  return module(*args)


def split_entries(module):
  """The store paths of `module`'s kernels and embeddings."""
  from embodied_tpu_torch import nn
  return sorted(k for k in nn.store(module)
                if k.rsplit('/', 1)[-1] in ('kernel', 'embed'))


def layer_grads(name, module, arrays):
  """`module`'s output on `arrays` and the gradients of a seeded
  weighting of it: ({'y', 'inputs': [float inputs' gradients], 'paths':
  the parameters' store paths, sorted, 'params': {path: gradient},
  'flat': the gradients flat in path order}, the parameters in path
  order)."""
  from embodied_tpu_torch import nn
  args = [torch.tensor(a, requires_grad=a.dtype == np.float32)
          for a in arrays]
  y = apply_layer(name, module, args)
  weight = torch.tensor(np.random.default_rng(1).standard_normal(
      tuple(y.shape)).astype(np.float32))
  params = {nn.core.store_path(k): v for k, v in module.named_parameters()}
  paths = sorted(params)
  floats = [a for a in args if a.requires_grad]
  grads = torch.autograd.grad((y * weight).sum(), floats + [
      params[p] for p in paths])
  out = dict(y=y.detach().numpy(), paths=paths,
             inputs=[g.numpy() for g in grads[:len(floats)]],
             params={p: g.numpy() for p, g in zip(paths, grads[len(floats):])})
  out['flat'] = torch.cat([g.reshape(-1) for g in grads[len(floats):]])
  return out, [params[p] for p in paths]


def optimizer_step(module, arrays, fused):
  """`module`'s parameters and optimizer state after one Optimizer step
  (the flat moments, or with `fused` False the per-parameter slots) on
  a seeded weighting of its output on `arrays`, past the warm-up."""
  from embodied_tpu_torch import nn
  params = {nn.core.store_path(k): v for k, v in module.named_parameters()}
  opt = nn.Optimizer(params, lr=1e-3, warmup=0, fused=fused)
  x = torch.tensor(arrays[0])
  weight = torch.tensor(np.random.default_rng(2).standard_normal(
      tuple(module(x).shape)).astype(np.float32))
  opt(lambda: ((module(x) * weight).sum(), {}))
  store = {k: v.detach().numpy().copy() for k, v in params.items()}
  store.update({f'opt/{k}': v.numpy().copy()
                for k, v in nn.store(opt).items()})
  return store


def planted_join(vec, paths, params, split):
  """nn.opt.join_parts with a planted fault: the replicated entries are
  summed over 't' as well."""
  import torch.distributed as dist
  offset = 0
  for path, param in zip(paths, params):
    view = vec[offset:offset + param.numel()].view(param.shape)
    offset += param.numel()
    if path in split.paths:
      start, width = split.part(param.shape[-1])
      view[..., :start] = 0
      view[..., start + width:] = 0
  dist.all_reduce(vec, group=split.group)


def case_tensor_parallel(inputs, port):
  import torch.distributed as dist
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.parallel import tensor
  rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
  # The agents' setup keeps this group (as a launcher's).
  dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                          rank=rank, world_size=world)
  coordinator = ['--torch.coordinator_address', f'localhost:{port}']
  out = {'steps': {}, 'costs': {}, 'layers': {}, 'optimizer': {}}
  for run in inputs['steps']:
    out['steps'][run['label']] = mesh_step(run, coordinator)
  for family, argv in inputs['costs'].items():
    agent, _ = make(family, argv + ['--torch.mesh', '1,1,2'] + coordinator)
    out['costs'][family] = dict(agent.train_cost(), split=sorted(
        agent._split), t=agent.mesh.t_count)
  group = dist.group.WORLD
  for name, (module, arrays) in split_layers().items():
    with tensor.split_over(group, split_entries(module), module, rank,
                           world) as split:
      got, params = layer_grads(name, module, arrays)
      joined, planted = got['flat'].clone(), got.pop('flat')
      nn.opt.join_parts(joined, got['paths'], params, split)
      planted_join(planted, got['paths'], params, split)
    got.update(joined=joined.numpy(), planted=planted.numpy(),
               index=split.index, count=split.count)
    out['layers'][name] = got
  for fused in (True, False):
    module, arrays = split_layers()['mlp']
    with tensor.split_over(group, split_entries(module), module, rank,
                           world):
      out['optimizer'][fused] = optimizer_step(module, arrays, fused)
  return out


def case_ring(inputs, port):
  import torch.distributed as dist
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.ops import ring_attention as ra
  rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
  dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                          rank=rank, world_size=world)
  tensor = lambda x, dtype=torch.float32: torch.tensor(x).to(dtype)
  q, k, v = (tensor(inputs[n]) for n in 'qkv')
  out = {}
  for causal in (False, True):
    out[f'f32 causal={causal}'] = ra.ring_attention_sharded(
        q, k, v, causal=causal).numpy()
  bf16 = [x.to(torch.bfloat16) for x in (q, k, v)]
  out['bf16 causal=True'] = ra.ring_attention_sharded(
      *bf16, causal=True).float().numpy()
  leaves = [x.clone().requires_grad_() for x in (q, k, v)]
  ra.ring_attention_sharded(*leaves, causal=True).square().sum().backward()
  out['grads'] = [x.grad.numpy() for x in leaves]
  x = tensor(inputs['x']).chunk(world, 1)[rank]
  for name, module in (
      ('attn', nn.Attention(16, 16, 4, 'attn', kvheads=2, impl='ring',
                            causal=True, cdtype=torch.float32)),
      ('tf', nn.Transformer(2, 16, 4, 'tf', ffmult=2, kvheads=2,
                            impl='ring', causal=True,
                            cdtype=torch.float32))):
    root = torch.nn.Module()
    root.add_module(name, module)
    assert not nn.load_store(root, inputs[f'{name}_store'])
    y = module(x)
    parts = [torch.empty_like(y) for _ in range(world)]
    dist.all_gather(parts, y.detach().contiguous())
    out[name] = torch.cat(parts, 1).numpy()
  return out


def main():
  case, rank, world, port, folder = sys.argv[1:]
  os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
  from embodied_tpu_torch.parallel.setup import share_cores, shutdown
  share_cores(int(world))
  with open(os.path.join(folder, 'inputs.pkl'), 'rb') as f:
    inputs = pickle.load(f)
  os.environ['WORKER_DIR'] = folder
  out = {'step': case_step, 'multihost': case_multihost,
         'sharded': case_sharded, 'ring': case_ring,
         'lockstep': case_lockstep, 'kept': case_kept,
         'threads': case_threads,
         'tensor_parallel': case_tensor_parallel}[case](inputs, port)
  with open(os.path.join(folder, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)
  shutdown()


if __name__ == '__main__':
  main()
