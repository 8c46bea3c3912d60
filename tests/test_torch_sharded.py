"""The port's sharded store on gloo ranks of this host's CPU, against the
JAX package's placements and steps.

Every rank case runs in one launch of two child interpreters
(tests/torch_distributed_worker.py, case `sharded`, which imports no JAX),
each making several agents on one process group of two ranks. Held here:

- placements, exactly: DreamerV3, PPO and Director at '1,2,1' and
  '1,1,2' load a JAX store (through `convert`); each rank's tensor of
  every store path equals the JAX array's shard on the virtual CPU device
  at the rank's mesh coordinate, and the rank holds the placements' bytes;
  `train_cost` counts what the one-rank agent counts, and under
  torch.shardmap every placement is replicated;
- the step, bit for bit (DreamerV3 at small widths, float32, the host
  path, each rank on its rows of one recorded noise): two ranks at
  '1,2,1' against two at '2,1,1' (metrics, replay outputs, the gathered
  save, the slices); two at '1,1,2', which split the products over 't'
  (tests/test_torch_tensor_parallel.py), equal each other bit for bit
  and one rank on the same rows at tests/test_torch_slice.py's
  tolerances, since the split reorders float32 sums;
- the '1,2,1' step against the JAX model's step on a '1,2,1' mesh of the
  virtual devices, with its store under the rules' NamedShardings, at
  tests/test_torch_slice.py's tolerances;
- the grouped save under sharding equals the replicated one and loads
  into a one-rank agent that acts as the sharded agent's policy copy;
  policy calls make no collective;
- `main` on two mock devices at '1,2,1' runs `train` and `train_eval`,
  each rank reporting and saving;
- the slow value's mix gives the same bits on slices as on full tensors,
  and the shard groups order their ranks as JAX orders its devices.
"""

import json
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from embodied_tpu import nn as jnn
from embodied_tpu.models import common as jcommon
from embodied_tpu.nn import dists as jdists
from embodied_tpu.parallel import meshes as jmeshes
from embodied_tpu_torch.parallel import convert, meshes
from test_torch_distributed import (
    B, CHUNK, DREAMER, ENV, HOST_PATH, LOCAL, ROOT, T, TIMEOUT,
    assert_matches_jax_step, host_store, jax_fastinit, launch, one_rank_step,
    port_agent, random_batch)
from test_torch_slice import Recorder, jax_model, loop_scan, paired_pred

SPECS = ('1,2,1', '1,1,2')
FAMILY_ARGV = ['--configs', 'debug', '--task', 'dummy_disc',
               '--batch_size', '8', '--logdir', '/nonexistent']
STEP_MESHES = {'1,2,1': LOCAL, '2,1,1': LOCAL, '1,1,2': B}


def jax_store(family):
  """The JAX agent's debug-size store of a family, as numpy."""
  jmain = __import__(f'embodied_tpu.models.{family}.main', fromlist=['m'])
  config = jcommon.assemble_config(
      str(pathlib.Path(jmain.__file__).with_name('configs.yaml')),
      FAMILY_ARGV + ['--jax.mesh', '1,1,1', '--jax.precompile', 'False'])
  jagent = jmain.make_agent(config)
  return convert.from_jax(jagent.store), jagent.model.partition_rules


@pytest.fixture(scope='module')
def sharded(tmp_path_factory):
  """The JAX '1,2,1' mesh step, the one-rank port step, and the `sharded`
  launch: placements of three families on two meshes, the step on three
  meshes."""
  previous = jnn.core.COMPUTE_DTYPE
  jnn.set_compute_dtype(jnp.float32)
  rec = Recorder()
  with pytest.MonkeyPatch.context() as patch:

    def categorical(self, key, shape=()):
      return jnp.argmax(
          self.logprobs + rec.draw('gumbel', self.logprobs.shape), -1)

    def normal(self, key, shape=()):
      return self._mean + self._std * rec.draw('normal', self._mean.shape)
    patch.setattr(jdists.Categorical, 'sample', categorical)
    patch.setattr(jdists.Normal, 'sample', normal)
    patch.setattr(jnn, 'scan', loop_scan)
    patch.setattr(jdists.TwoHot, 'pred', paired_pred)
    try:
      result = sharded_runs(rec, tmp_path_factory.mktemp('sharded'))
    finally:
      jnn.set_compute_dtype(previous)
  return result


def sharded_runs(rec, folder):
  jm = jax_model(DREAMER + ['--batch_size', str(B)])
  agent = port_agent('dreamerv3', DREAMER + HOST_PATH + [
      '--batch_size', str(B)])
  data = random_batch(agent, B, T + 1, 8)
  data['consec'][1] = 1
  rec.start(99)
  cell = {}

  def trace(key, data):
    ctx = jnn.core.Ctx({}, create=True, key=key)
    jm.train(ctx, jm.init_train(ctx, 2), data)
    cell.update(meta=dict(ctx.meta))
    cell.update(recipes=dict(ctx.recipes))
    return {**ctx.store, **ctx.updates}
  jax.eval_shape(trace, jax.random.PRNGKey(0),
                 {k: v[:2] for k, v in data.items()})
  store, meta = jax_fastinit(cell['recipes']), cell['meta']
  # The JAX step on a '1,2,1' mesh, its store under the rules' shardings.
  rec.start(9)
  mesh = jmeshes.make_mesh('1,2,1')
  shardings = jmeshes.resolve_rules(
      {k: v.shape for k, v in store.items()}, jm.partition_rules, mesh)
  assert any(any(s.spec) for s in shardings.values())
  train = lambda ctx, data: jm.train(ctx, jm.init_train(ctx, B), data)
  step = jax.jit(jnn.pure(train, meta), in_shardings=(
      shardings, jmeshes.replicated(mesh), jmeshes.data_sharding(mesh)))
  placed = {k: jax.device_put(v, shardings[k]) for k, v in store.items()}
  updates, (_, jouts, jmets) = step(placed, jax.random.PRNGKey(2), data)
  jafter = {**store, **updates}
  start = convert.from_jax(store)
  agent.load({'store': start})
  # The one-rank step on one thread, as each rank runs: the '1,1,2' ranks
  # must give its bits.
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    mets, outs, after, recorded = one_rank_step(agent, data, rec.replay())
  finally:
    torch.set_num_threads(threads)
  obs = {k: v[:, 1] for k, v in data.items() if k in agent.obs_space}
  stores = {'dreamerv3': (start, jm.partition_rules, DREAMER + HOST_PATH + [
      '--batch_size', str(B)])}
  for family in ('ppo', 'director'):
    values, rules = jax_store(family)
    stores[family] = (values, rules, FAMILY_ARGV)
  placements = [
      dict(family=family, argv=argv, spec=spec, store=values,
           flops=spec == SPECS[0])
      for family, (values, _, argv) in stores.items() for spec in SPECS]
  steps = [dict(label=spec, argv=DREAMER + HOST_PATH, mesh=spec,
                local=local, store=start, batch=data, recorded=recorded,
                chunk_bytes=CHUNK, obs=obs)
           for spec, local in STEP_MESHES.items()]
  ranks = launch('sharded', {'placements': placements, 'steps': steps},
                 folder)
  return dict(
      ranks=ranks, stores=stores, mets=mets, outs=outs, after=after,
      agent=agent, obs=obs, meta=meta, jmets=jmets, jouts=jouts,
      jafter=jafter)


def placement_runs(sharded, family, spec):
  return [next(p for p in r['placements']
               if p['family'] == family and p['spec'] == spec)
          for r in sharded['ranks']]


@pytest.mark.parametrize('spec', SPECS)
@pytest.mark.parametrize('family', ['dreamerv3', 'ppo', 'director'])
def test_placements_equal_jax_shards(sharded, family, spec):
  values, rules, _ = sharded['stores'][family]
  mesh = jmeshes.make_mesh(spec)
  want = jmeshes.resolve_rules(
      {k: v.shape for k, v in values.items()}, rules, mesh)
  position = {d.id: tuple(int(c) for c in np.argwhere(mesh.devices == d)[0])
              for d in mesh.devices.reshape(-1)}
  sharded_paths = 0
  for rank, got in enumerate(placement_runs(sharded, family, spec)):
    assert got['coords'] == position[rank]
    assert sorted(got['local']) == sorted(want)
    for path, sharding in want.items():
      assert got['shardings'][path] == tuple(sharding.spec), path
      array = jax.device_put(values[path], NamedSharding(mesh, P(
          *sharding.spec)))
      shard = next(s for s in array.addressable_shards
                   if s.device.id == rank)
      np.testing.assert_array_equal(
          got['local'][path], np.asarray(shard.data), err_msg=path)
      sharded_paths += any(e is not None for e in sharding.spec)
    held = got['bytes']
    assert held['sharded'] + held['replicated'] == held['placements']
    whole = sum(v.nbytes for v in values.values())
    assert held['placements'] < whole
    assert held['policy_copy'] > 0
  assert sharded_paths, 'no entry is sharded on this mesh'


@pytest.mark.parametrize('family', ['dreamerv3', 'ppo', 'director'])
def test_train_cost_and_shardmap(sharded, family):
  """A sharded agent counts the one-rank agent's FLOPs (its meta copy has
  the full shapes; counted at '1,2,1'); under torch.shardmap every
  placement is replicated, every rank holds the whole store and counts
  the same."""
  values, _, argv = sharded['stores'][family]
  one = port_agent(family, argv).train_cost()['flops']
  whole = sum(v.nbytes for v in values.values())
  for spec in SPECS:
    for got in placement_runs(sharded, family, spec):
      shardmap = got['shardmap']
      assert all(s == () for s in shardmap['shardings'].values())
      assert shardmap['bytes']['sharded'] == 0
      assert shardmap['bytes']['replicated'] == whole
      if spec == SPECS[0]:
        assert got['flops'] == shardmap['flops'] == one


def steps_of(sharded, label):
  return [r['steps'][label] for r in sharded['ranks']]


def test_sharded_step_equals_replicated_step(sharded):
  """'1,2,1' against '2,1,1': the same data indices, draws and all-reduce,
  and exact all-gathers, so the same bits: metrics, replay outputs, the
  gathered save; each rank holds its slices of that store."""
  for got, want in zip(steps_of(sharded, '1,2,1'),
                       steps_of(sharded, '2,1,1')):
    assert got['data_index'] == want['data_index']
    assert sorted(got['mets']) == sorted(want['mets'])
    for key, value in want['mets'].items():
      np.testing.assert_array_equal(got['mets'][key], value, err_msg=key)
    for key, value in want['outs']['replay'].items():
      np.testing.assert_array_equal(got['outs']['replay'][key], value)
    assert sorted(got['save']) == sorted(want['save'])
    for key, value in want['save'].items():
      np.testing.assert_array_equal(got['save'][key], value, err_msg=key)
      np.testing.assert_array_equal(want['store'][key], value)
    index = got['coords'][1]
    for key, value in got['store'].items():
      if value.shape != want['save'][key].shape:
        part = np.split(want['save'][key], 2, axis=-1)[index]
        np.testing.assert_array_equal(value, part, err_msg=key)
      else:
        np.testing.assert_array_equal(value, want['save'][key])


def test_t_replicas_equal_one_rank(sharded):
  """'1,1,2': both ranks compute rank 0's rows and split the products
  over 't'; they equal each other bit for bit, and one rank on the same
  rows and noise at test_slice_train_step_matches_jax's tolerances (the
  split reorders float32 sums); the replica returns no replay
  updates."""
  ranks = steps_of(sharded, '1,1,2')
  one = dict(jmets=sharded['mets'], jafter=sharded['after'],
             meta=sharded['meta'], jouts=sharded['outs'])
  assert_matches_jax_step(dict(ranks[0], store=ranks[0]['save']), one,
                          rows=B)
  for key, value in ranks[0]['mets'].items():
    np.testing.assert_array_equal(ranks[1]['mets'][key], value, err_msg=key)
  for key, value in ranks[0]['save'].items():
    np.testing.assert_array_equal(ranks[1]['save'][key], value, err_msg=key)
  assert 'replay' not in ranks[1]['outs']


def test_sharded_step_matches_jax_mesh_step(sharded):
  """The gathered store after the '1,2,1' step against the JAX step on a
  '1,2,1' mesh with its store sharded by the same rules."""
  for got in steps_of(sharded, '1,2,1'):
    assert_matches_jax_step(dict(got, store=got['save']), sharded)


def test_step_collectives_and_bytes(sharded):
  """The sharded step makes the replicated step's collectives and one
  all-gather more (one shard group, float32); between calls each rank
  holds the placements' bytes, the replicated rank the whole store."""
  sharded_steps = steps_of(sharded, '1,2,1')
  for got, want in zip(sharded_steps, steps_of(sharded, '2,1,1')):
    more = dict(want['step_collectives'])
    more['all_gather'] = more.get('all_gather', 0) + 1
    assert got['step_collectives'] == more
    held = got['bytes']
    assert held['sharded'] + held['replicated'] == held['placements']
    assert held['sharded'] > 0
    whole = want['bytes']
    assert whole['sharded'] == 0
    assert held['placements'] < whole['replicated'] == whole['placements']


def test_sharded_save_loads_into_one_rank(sharded):
  """The sharded ranks' grouped saves load into a one-rank agent whose
  policy acts as the ranks' policy copies do on one observation and
  noise; the ranks' policy calls made no collective."""
  obs = {k: torch.as_tensor(v) for k, v in sharded['obs'].items()}
  for got in steps_of(sharded, '1,2,1'):
    assert got['policy_collectives'] == {}
    agent = port_agent('dreamerv3', DREAMER + HOST_PATH + [
        '--batch_size', str(B)])
    agent.load({'store': got['save']})
    for key, value in host_store(agent).items():
      np.testing.assert_array_equal(value, got['save'][key])
    gen = torch.Generator().manual_seed(5)
    with torch.inference_mode():
      _, act, outs = agent._policy_model().policy(
          agent.init_policy(len(obs['is_first'])), obs, 'train', gen)
    for key, value in act.items():
      np.testing.assert_array_equal(got['act'][key], value.numpy())
    for key, value in outs.items():
      np.testing.assert_allclose(got['policy_outs'][key], value.numpy(),
                                 1e-5, 1e-6, err_msg=key)


def test_slow_update_on_slices_equals_full():
  """SlowModel's mix is elementwise: on the slices of its source and
  shadow it gives the bits of the full tensors' slices."""
  gen = torch.Generator().manual_seed(0)
  src = torch.randn(6, 8, generator=gen)
  dst = torch.randn(6, 8, generator=gen)
  mix = torch.tensor(0.02)
  full = mix * src + (1 - mix) * dst
  for part in range(2):
    cut = slice(4 * part, 4 * part + 4)
    piece = mix * src[:, cut].contiguous() + (1 - mix) * dst[:, cut]
    assert torch.equal(piece, full[:, cut])


@pytest.mark.parametrize('spec', ['1,2,2', '2,2,2'])
def test_shard_members_match_jax_device_order(spec):
  """The ranks of a shard group over ('f','t') in shard order are the
  devices that P(('f','t')) lays a dimension's shards on, f-major."""
  jmesh = jmeshes.make_mesh(spec)
  mesh = meshes.make_mesh(spec, world=8)
  x = jnp.arange(16 * 4, dtype=jnp.float32).reshape(4, 16)
  array = jax.device_put(x, NamedSharding(jmesh, P(None, ('f', 't'))))
  width = 16 // (mesh.shape['f'] * mesh.shape['t'])
  for coords in np.ndindex(*mesh.sizes):
    members = mesh.members(('f', 't'), coords)
    rank = int(mesh.ranks[coords])
    index = members.index(rank)
    shard = next(s for s in array.addressable_shards if s.device.id == rank)
    np.testing.assert_array_equal(
        np.asarray(shard.data), np.asarray(x)[:, index * width:
                                               (index + 1) * width])


@pytest.mark.parametrize('script', ['train', 'train_eval'])
def test_main_sharded_on_two_mock_devices(tmp_path, script):
  """`main --torch.mock_devices 2 --torch.mesh 1,2,1` under `debug`: both
  ranks train, report and save (their reports and saves at rank 0's
  times), and the checkpoint each rank writes holds the whole store."""
  logdir = tmp_path / 'logdir'
  proc = subprocess.run(
      [sys.executable, '-m', 'embodied_tpu_torch.models.dreamerv3.main',
       '--configs', 'debug', '--task', 'dummy_disc', '--logdir',
       str(logdir), '--script', script, '--torch.mock_devices', '2',
       '--torch.mesh', '1,2,1', '--run.steps', '120', '--run.log_every',
       '0.001', '--run.report_every', '0.001', '--run.save_every', '0.001',
       '--batch_size', '4'],
      cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT, env=ENV)
  assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
  shapes = {k: v.shape for k, v in host_store(port_agent('dreamerv3', [
      '--configs', 'debug', '--task', 'dummy_disc'])).items()}
  for folder in (logdir, logdir / 'rank1'):
    lines = [json.loads(l) for l in
             (folder / 'metrics.jsonl').read_text().splitlines()]
    losses = [l['train/opt/loss'] for l in lines if 'train/opt/loss' in l]
    assert losses and all(np.isfinite(losses)), folder
    prefixes = ('report/',) if script == 'train' else ('report/', 'eval/')
    for prefix in prefixes:
      assert any(k.startswith(prefix) for l in lines for k in l), (
          folder, prefix)
    with open(folder / 'checkpoint.pkl', 'rb') as f:
      saved = pickle.load(f)['agent']['store']
    assert {k: v.shape for k, v in saved.items()} == shapes
