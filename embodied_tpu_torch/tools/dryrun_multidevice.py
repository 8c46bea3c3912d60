"""The port's distributed stack on n gloo ranks of this host's CPU.

    python -m embodied_tpu_torch.tools.dryrun_multidevice [n] [d,f,t]

The counterpart of `dryrun_multichip` in the JAX package's
__graft_entry__.py. n is factored into a ('d','f','t') mesh as the JAX
dry run factors its devices: n/4,2,2, else n/2,2,1, else n,1,1; or the
spec given (such as 1,1,n) lays the n ranks out. A
DreamerV3 agent at the debug size (float32, the latent table on) makes
one train step here, on one rank, on a global batch of at least 4 rows
that divide over ('d','f'); then n spawned ranks, each on its data
index's rows, make the same step, a second step on the same window, a
policy step and a save and load round trip. Each rank's loss must equal
the one-rank loss (rtol 1e-5: the ranks take the one-rank step's noise,
their rows of it, so only the summation order differs), the ranks'
stores must be equal after the step and equal to the one-rank store
(rtol 1e-5, atol 1e-6), the second step must find the window's latents
in the table (latents/valid is T / (T + K) for windows of T steps after
K context steps, whose slots the first step did not write), and the
reloaded store must give the same policy output. On a mesh with 'f' or
't' above 1 the ranks hold their slices of the sharded entries: the
stores compared are the ranks' gathered saves, and each rank's resident
store bytes between calls must equal what the placements give it. On a
mesh with t > 1 the ranks split the products of the kernels and
embeddings that the placements shard over 't' (parallel/tensor.py): the
stores then agree with the one-rank store at the tolerances above, and
equal each other bit for bit. Prints each rank's store bytes (sharded,
replicated, the placements' sum, the policy copy's own), the same for
the default configuration on the same mesh and on '1,2,1', counted on
the meta device (no memory, no agent), where t > 1 the split paths,
their share of the step's product FLOPs and a rank's FLOPs
(Agent.train_cost), and one line of the checks; exits 0, or raises.

`RecordDraws` and `RankDraws` hand ranks their rows of one run's noise;
the tests use them too. `default_bytes(spec)` is the default
configuration's count alone.
"""

import multiprocessing
import os
import socket
import sys

import numpy as np
import torch

RTOL = 1e-5
ATOL = 1e-6
ARGV = ['--configs', 'debug', '--task', 'dummy_disc',
        '--torch.compute_dtype', 'float32', '--torch.fetch_depth', '0',
        '--batch_length', '8', '--logdir', '/nonexistent']


class RecordDraws:
  """A Draws that passes `draws` on and records each request: a list of
  (kind, array) in call order."""

  def __init__(self, draws):
    self.draws = draws
    self.recorded = []

  def gumbel(self, shape):
    return self._keep('gumbel', self.draws.gumbel(shape))

  def normal(self, shape):
    return self._keep('normal', self.draws.normal(shape))

  def _keep(self, kind, value):
    self.recorded.append((kind, value.detach().cpu().numpy().copy()))
    return value


class RankDraws:
  """A Draws that serves data index `index` of `n` its rows of recorded
  noise: request k takes recorded array k, cut on the one axis where it
  is n times the requested shape (whole where the shapes agree)."""

  def __init__(self, recorded, index, n, device='cpu'):
    self.recorded = list(recorded)
    self.index, self.n, self.device = index, n, device
    self.calls = 0

  def gumbel(self, shape):
    return self._take('gumbel', shape)

  def normal(self, shape):
    return self._take('normal', shape)

  def _take(self, kind, shape):
    want, value = self.recorded[self.calls]
    self.calls += 1
    assert want == kind, (self.calls, want, kind)
    shape = tuple(shape)
    if value.shape != shape:
      axes = [a for a, (g, l) in enumerate(zip(value.shape, shape))
              if g != l]
      assert len(value.shape) == len(shape) and len(axes) == 1 and (
          value.shape[axes[0]] == self.n * shape[axes[0]]), (
              value.shape, shape)
      value = np.split(value, self.n, axes[0])[self.index]
    return torch.tensor(np.ascontiguousarray(value), device=self.device)

  def used_all(self):
    return self.calls == len(self.recorded)


def mesh_spec(n):
  if n % 4 == 0:
    return f'{n // 4},2,2'
  if n % 2 == 0:
    return f'{n // 2},2,1'
  return f'{n},1,1'


def rows(data, index, count):
  """Data index `index`'s `count` rows of a global batch."""
  return {k: v[index * count:(index + 1) * count] for k, v in data.items()}


def build(argv):
  """A debug-size DreamerV3 agent on the CPU, and its config."""
  from ..models import common
  from ..models.dreamerv3 import main
  config = common.assemble_config(main.CONFIGS, ARGV + argv)
  return main.make_agent(config, device='cpu'), config


def reference(n, spec=None):
  """The one-rank step on the global batch: (initial store, batch,
  recorded noise, metrics, store after)."""
  from .. import nn
  from ..parallel.meshes import mesh_sizes
  spec = spec or mesh_spec(n)
  d, f, _ = mesh_sizes(spec, n)
  local = max(1, -(-max(4, d * f) // (d * f)))
  agent, config = build(['--batch_size', str(local * d * f)])
  store = agent.save()
  L = config.batch_length + config.replay_context
  data = agent._example_batch(agent.batch_size, L)
  data['is_first'][:, 0] = True
  rng = np.random.default_rng(0)
  data['image'][:] = rng.integers(0, 256, data['image'].shape)
  draws = RecordDraws(agent._draws('train', 2_000_003))
  agent._draws = lambda kind, salt: draws
  _, _, mets = agent.train(agent.init_train(agent.batch_size), data)
  after = {k: v.detach().numpy().copy()
           for k, v in nn.store(agent.model).items()}
  return dict(spec=spec, local=local, store=store, data=data,
              recorded=draws.recorded, mets=mets, after=after)


def run_rank(rank, n, port, ref, out):
  os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
  try:
    from .. import nn
    from ..parallel.setup import share_cores, shutdown
    share_cores(n)
    agent, config = build([
        '--batch_size', str(ref['local']), '--torch.mesh', ref['spec'],
        '--torch.coordinator_address', f'localhost:{port}'])
    agent.load(ref['store'])
    index = agent.mesh.data_index
    data = rows(ref['data'], index, ref['local'])
    # Slots of this rank's table: the batch's other columns as given.
    data['slot'] = agent._example_batch(
        ref['local'], data['slot'].shape[1])['slot']
    draws = RankDraws(ref['recorded'], index, agent.nbatch)
    agent._draws = lambda kind, salt: draws
    carry = agent.init_train(ref['local'])
    carry, _, mets = agent.train(carry, data)
    assert draws.used_all(), (draws.calls, len(draws.recorded))
    held = agent.store_bytes()
    cost = dict(agent.train_cost(), split=sorted(agent._split),
                t=agent.mesh.t_count)
    store = agent.save(chunk_bytes=4096)['store']
    agent._draws = lambda kind, salt: RankDraws(
        ref['recorded'], index, agent.nbatch)
    _, _, mets2 = agent.train(carry, data)
    obs = agent._example_obs(2)
    obs['is_first'][:] = True
    _, act, _ = agent.policy(agent.init_policy(2), obs)
    saved = agent.save(chunk_bytes=4096)
    agent.load(saved)
    agent._counters['policy'] -= 1
    _, again, _ = agent.policy(agent.init_policy(2), obs)
    shutdown()
    out.put((rank, dict(
        loss=mets['opt/loss'], store=store, act=act, again=again,
        valid=mets2['latents/valid'], bytes=held, cost=cost, window=(
            config.batch_length, config.replay_context))))
  except BaseException as e:
    out.put((rank, e))
    raise


def dryrun(n, spec=None):
  ref = reference(n, spec)
  with socket.socket() as sock:
    sock.bind(('localhost', 0))
    port = sock.getsockname()[1]
  context = multiprocessing.get_context('spawn')
  out = context.Queue()
  procs = [context.Process(target=run_rank, args=(r, n, port, ref, out))
           for r in range(n)]
  for proc in procs:
    proc.start()
  results = {}
  try:
    for _ in range(n):
      rank, result = out.get(timeout=300)
      if isinstance(result, BaseException):
        raise RuntimeError(f'rank {rank} failed') from result
      results[rank] = result
  finally:
    for proc in procs:
      proc.join(30)
      if proc.is_alive():
        proc.terminate()
        proc.join()
  want = ref['mets']['opt/loss']
  for rank, result in sorted(results.items()):
    np.testing.assert_allclose(result['loss'], want, RTOL, ATOL,
                               err_msg=f'rank {rank} loss')
    for key, value in result['store'].items():
      np.testing.assert_allclose(value, ref['after'][key], RTOL, ATOL,
                                 err_msg=f'rank {rank} {key}')
      np.testing.assert_array_equal(value, results[0]['store'][key])
    for key, value in result['act'].items():
      np.testing.assert_array_equal(value, result['again'][key])
    T, K = result['window']
    assert abs(result['valid'] - T / (T + K)) < 1e-6, result['valid']
    held = result['bytes']
    assert held['sharded'] + held['replicated'] == held['placements'], held
    print(f'rank {rank} store bytes: {bytes_line(held)}', flush=True)
  for spec in sorted({ref['spec'], '1,2,1'}):
    print(f'default configuration on mesh {spec}, per rank: '
          f'{bytes_line(default_bytes(spec))}', flush=True)
  cost = results[0]['cost']
  if cost['t'] > 1:
    print(split_line(cost), flush=True)
  print(f'dryrun_multidevice({n}): mesh {ref["spec"]}, gloo ranks, '
        f'train+policy+save/load ok, loss={want:.6f} on every rank and '
        f'on one rank, latents/valid={results[0]["valid"]:.4f}',
        flush=True)


def split_line(cost):
  """The split over 't' of a rank's train_cost (with its split paths and
  t): the paths, the split products' share of the one-rank step's
  product FLOPs, and the rank's FLOPs."""
  t, part = cost['t'], cost['split_flops']
  whole = cost['flops'] + (t - 1) * part
  return (f'split over t={t}: {len(cost["split"])} paths '
          f'({", ".join(cost["split"])}); split products '
          f'{t * part:,} of the one-rank {whole:,} FLOPs a step '
          f'({t * part / whole:.1%}); a rank counts {cost["flops"]:,}')


def bytes_line(held):
  return (f'{held["sharded"] + held["replicated"]:,} B held '
          f'({held["sharded"]:,} sharded, {held["replicated"]:,} '
          f'replicated; the placements give {held["placements"]:,}), '
          f'policy copy {held["policy_copy"]:,} B')


def default_bytes(spec):
  """The store bytes that one rank holds of the default DreamerV3
  configuration on `spec`'s mesh, as Agent.store_bytes gives them after
  a train step, counted from the shapes of a model built on the meta
  device: no memory, no process group."""
  import re
  from .. import nn
  from ..models import common
  from ..models.dreamerv3 import main
  from ..models.dreamerv3.model import Model
  from ..parallel import meshes
  config = common.assemble_config(main.CONFIGS, ['--task', 'dummy_disc'])
  obs_space, act_space = common.env_spaces(config)
  with torch.device('meta'):
    model = Model(obs_space, act_space, common.agent_config(config))
  store = nn.store(model)
  shapes = {k: v.shape for k, v in store.items()}
  sizes = [int(x) for x in spec.split(',')]
  mesh = meshes.make_mesh(spec, world=int(np.prod(sizes)))
  shards = meshes.Shards(shapes, meshes.resolve_rules(
      shapes, model.partition_rules, mesh), mesh)
  full = lambda k: store[k].numel() * store[k].element_size()
  local = lambda k: int(np.prod(shards.local_shape(k))) * (
      store[k].element_size())
  sharded = sum(local(k) for k in shards.paths)
  pattern = re.compile(model.policy_keys)
  return dict(
      sharded=sharded,
      replicated=sum(full(k) for k in store if k not in shards.dims),
      placements=shards.nbytes({k: v.dtype for k, v in store.items()}),
      policy_copy=sum(full(k) for k in store if pattern.search(k)))


def main():
  dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
         sys.argv[2] if len(sys.argv) > 2 else None)


if __name__ == '__main__':
  main()
