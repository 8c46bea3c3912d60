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
  from embodied_tpu_torch.tools.dryrun_multidevice import RankDraws, rows
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
    argv = run['argv'] + [
        '--batch_size', str(run['local']), '--torch.mesh', run['mesh'],
        *coordinator]
    agent, _ = make('dreamerv3', argv)
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
    out['steps'][run['label']] = got
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
  out = {'step': case_step, 'multihost': case_multihost,
         'sharded': case_sharded, 'ring': case_ring}[case](inputs, port)
  with open(os.path.join(folder, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)
  shutdown()


if __name__ == '__main__':
  main()
