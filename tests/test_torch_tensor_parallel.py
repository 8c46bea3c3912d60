"""The split of the products over the mesh's 't' ranks (parallel/tensor.py,
the layers' split paths, nn/opt.py's join of the gradient parts) on two
gloo ranks of this host's CPU, against the whole computation and the JAX
package's '1,1,2' mesh.

One launch of two child interpreters (tests/torch_distributed_worker.py,
case `tensor_parallel`, which imports no JAX) computes what the ranks
give. Held here:

- each layer kind that splits (Linear with int and tuple units,
  BlockLinear, Conv2D, the transposed Conv2D, Conv3D, Embed, GRU,
  Attention, and an MLP with its norms) under `split_over` the two ranks
  against the whole layer in this process: the output, the inputs'
  gradients and, once joined over 't', every parameter's gradient, at
  float32 tolerance; before the join a kernel's gradient is non-zero only
  in the rank's part; a join that also sums the replicated entries
  (biases, norm scales) over 't' fails the same check; an Optimizer step
  of the MLP in both slot layouts (the flat moments and the
  per-parameter slots) against the whole MLP's;
- the DreamerV3 step at '1,1,2' (small widths, float32, the host path,
  the whole batch on each rank under one recorded noise) against the JAX
  model's step on a '1,1,2' mesh of the virtual CPU devices, its store
  under the rules' NamedShardings, at tests/test_torch_slice.py's
  tolerances, and the two ranks' metrics and saves equal bit for bit;
- the PPO and Director steps at '1,1,2' against one rank on the same
  rows and noise (no code of their own splits: their layers do), the
  two ranks equal bit for bit;
- train_cost at '1,1,2' for DreamerV3, PPO and Director: a rank counts
  the one-rank count less (1 - 1/t) of the split products, and the split
  paths are the kernels and embeddings that the rules shard over 't'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_distributed_worker as worker
from embodied_tpu import nn as jnn
from embodied_tpu.nn import dists as jdists
from embodied_tpu.parallel import meshes as jmeshes
from embodied_tpu_torch import nn
from embodied_tpu_torch.parallel import convert, meshes
from test_torch_distributed import (
    ATOL, B, CHUNK, DREAMER, FAMILY, HOST_PATH, RTOL, T,
    assert_matches_jax_step, jax_fastinit, launch, one_rank_step,
    port_agent, random_batch)
from test_torch_slice import Recorder, jax_model, loop_scan, paired_pred

SPEC = '1,1,2'
COST_ARGV = ['--configs', 'debug', '--task', 'dummy_disc', '--batch_size',
             '8', '--logdir', '/nonexistent']


@pytest.fixture(scope='module')
def split(tmp_path_factory):
  """The JAX '1,1,2' mesh step, the one-rank port steps, and the launch."""
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
      result = split_runs(rec, tmp_path_factory.mktemp('split'))
    finally:
      jnn.set_compute_dtype(previous)
  return result


def split_runs(rec, folder):
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
    cell.update(meta=dict(ctx.meta), recipes=dict(ctx.recipes))
    return {**ctx.store, **ctx.updates}
  jax.eval_shape(trace, jax.random.PRNGKey(0),
                 {k: v[:2] for k, v in data.items()})
  store, meta = jax_fastinit(cell['recipes']), cell['meta']
  # The JAX step on a '1,1,2' mesh: GSPMD splits the products of the
  # kernels that the rules shard over 't'.
  rec.start(9)
  mesh = jmeshes.make_mesh(SPEC)
  shardings = jmeshes.resolve_rules(
      {k: v.shape for k, v in store.items()}, jm.partition_rules, mesh)
  assert any('t' in str(s.spec) for s in shardings.values())
  train = lambda ctx, data: jm.train(ctx, jm.init_train(ctx, B), data)
  step = jax.jit(jnn.pure(train, meta), in_shardings=(
      shardings, jmeshes.replicated(mesh), jmeshes.data_sharding(mesh)))
  placed = {k: jax.device_put(v, shardings[k]) for k, v in store.items()}
  updates, (_, jouts, jmets) = step(placed, jax.random.PRNGKey(2), data)
  start = convert.from_jax(store)
  agent.load({'store': start})
  mets, outs, after, recorded = one_rank_step(agent, data, rec.replay())
  steps = [
      dict(label='dreamerv3', argv=DREAMER + HOST_PATH, mesh=SPEC, local=B,
           store=start, batch=data, recorded=recorded, chunk_bytes=CHUNK)]
  families = {}
  for family in ('ppo', 'director'):
    argv = FAMILY[family] + HOST_PATH
    other = port_agent(family, argv + ['--batch_size', str(B)])
    batch = random_batch(
        other, B, other.batch_length + other.replay_context, 5)
    initial = other.save()['store']
    gen = torch.Generator().manual_seed(11)
    fmets, _, fafter, frecorded = one_rank_step(
        other, batch, nn.dists.Draws(gen, 'cpu'))
    families[family] = dict(mets=fmets, after=fafter)
    steps.append(dict(label=family, family=family, argv=argv, mesh=SPEC,
                      local=B, store=initial, batch=batch,
                      recorded=frecorded, chunk_bytes=CHUNK))
  costs = {family: COST_ARGV for family in ('dreamerv3', 'ppo', 'director')}
  ranks = launch('tensor_parallel', dict(steps=steps, costs=costs), folder)
  return dict(
      ranks=ranks, jax=dict(jmets=jmets, jafter={**store, **updates},
                            meta=meta, jouts=jouts),
      one=dict(mets=mets, outs=outs, after=after, opt=agent.model.opt),
      families=families)


def layer_case(split, name):
  """The whole layer here, and each rank's split run."""
  module, arrays = worker.split_layers()[name]
  want, _ = worker.layer_grads(name, module, arrays)
  return want, [rank['layers'][name] for rank in split['ranks']]


def assert_close(got, want, name=''):
  """float32 agreement of sums taken in another order: rtol 1e-5, and an
  atol of 1e-6 times the largest magnitude of `want` (at least 1e-6)."""
  scale = max(1.0, float(np.abs(want).max(initial=0)))
  np.testing.assert_allclose(got, want, RTOL, ATOL * scale, err_msg=name)


def assert_grads_match(got, want, joined):
  """Every parameter's gradient in `joined` (flat, path order) against
  the whole layer's."""
  offset = 0
  for path in want['paths']:
    value = want['params'][path]
    part = joined[offset:offset + value.size].reshape(value.shape)
    offset += value.size
    assert_close(part, value, path)


@pytest.mark.parametrize('name', list(worker.split_layers()))
def test_split_layer_equals_whole_layer(split, name):
  want, ranks = layer_case(split, name)
  paths = worker.split_entries(worker.split_layers()[name][0])
  assert paths
  for got in ranks:
    assert got['count'] == 2 and got['paths'] == want['paths']
    assert_close(got['y'], want['y'])
    assert len(got['inputs']) == len(want['inputs'])
    for value, expected in zip(got['inputs'], want['inputs']):
      assert_close(value, expected)
    # Before the join, a kernel's gradient lies in the rank's part alone.
    for path in paths:
      raw = got['params'][path]
      width = raw.shape[-1] // 2
      keep = np.zeros(raw.shape[-1], bool)
      keep[got['index'] * width:(got['index'] + 1) * width] = True
      assert np.all(raw[..., ~keep] == 0), path
      assert_close(raw[..., keep], want['params'][path][..., keep], path)
    assert_grads_match(got, want, got['joined'])
  np.testing.assert_array_equal(ranks[0]['joined'], ranks[1]['joined'])


@pytest.mark.parametrize('name', ['linear', 'conv2d_transp', 'gru', 'mlp'])
def test_planted_double_sum_fails(split, name):
  """Summed over 't', a replicated entry's gradient (a bias, a norm's
  scale) counts twice: the join that does so fails the check that the
  real join passes."""
  want, ranks = layer_case(split, name)
  assert any(p not in worker.split_entries(worker.split_layers()[name][0])
             for p in want['paths'])
  for got in ranks:
    with pytest.raises(AssertionError, match='bias|scale'):
      assert_grads_match(got, want, got['planted'])


@pytest.mark.parametrize('fused', [True, False])
def test_optimizer_step_in_both_layouts(split, fused):
  """The MLP's parameters and optimizer state after one step under the
  split against the whole MLP's."""
  module, arrays = worker.split_layers()['mlp']
  want = worker.optimizer_step(module, arrays, fused)
  assert any(k.startswith('opt/rms') for k in want)
  for rank in split['ranks']:
    got = rank['optimizer'][fused]
    assert sorted(got) == sorted(want)
    for key, value in want.items():
      assert_close(got[key], value, key)


def test_dreamer_step_matches_jax_mesh_step(split):
  """The '1,1,2' step against the JAX '1,1,2' mesh step; the replica
  returns no replay updates and equals the first rank bit for bit."""
  first, second = (r['steps']['dreamerv3'] for r in split['ranks'])
  assert first['coords'] == (0, 0, 0) and second['coords'] == (0, 0, 1)
  assert first['data_index'] == second['data_index'] == 0
  assert_matches_jax_step(dict(first, store=first['save']), split['jax'],
                          rows=B)
  assert 'replay' not in second['outs']
  for key, value in first['mets'].items():
    np.testing.assert_array_equal(second['mets'][key], value, err_msg=key)
  for key, value in first['save'].items():
    np.testing.assert_array_equal(second['save'][key], value, err_msg=key)


def test_dreamer_step_gradients_per_entry(split):
  """Each trained entry's square moment after the first step, (1 - beta2)
  g^2, against the one-rank step's, entry by entry (1e-3 relative in
  norm): a replicated entry summed over 't' would be 4 times as large."""
  opt = split['one']['opt']
  want = split['one']['after']['opt/rms_flat']
  got = split['ranks'][0]['steps']['dreamerv3']['save']['opt/rms_flat']
  offset = 0
  for path, param in opt.params.items():
    a = got[offset:offset + param.numel()]
    b = want[offset:offset + param.numel()]
    offset += param.numel()
    if np.linalg.norm(b):
      assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3, path
  assert offset == len(want)


@pytest.mark.parametrize('family', ['ppo', 'director'])
def test_family_step_equals_one_rank(split, family):
  want = split['families'][family]
  for rank in split['ranks']:
    got = rank['steps'][family]
    assert sorted(got['mets']) == sorted(want['mets'])
    for key, value in want['mets'].items():
      np.testing.assert_allclose(got['mets'][key], value, RTOL, ATOL,
                                 err_msg=key)
    for key, value in want['after'].items():
      np.testing.assert_allclose(got['save'][key], value, RTOL, ATOL,
                                 err_msg=key)
  first, second = (r['steps'][family]['save'] for r in split['ranks'])
  for key, value in first.items():
    np.testing.assert_array_equal(second[key], value, err_msg=key)


@pytest.mark.parametrize('family', ['dreamerv3', 'ppo', 'director'])
def test_train_cost_counts_the_rank_part(split, family):
  """A rank's count is the one-rank count less (1 - 1/t) of the split
  products, which are t S where the rank's parts count S: the one-rank
  count less (t - 1) S. The split paths are the kernels and embeddings
  that the rules place over 't'."""
  one = port_agent(family, COST_ARGV)
  want = one.train_cost()
  assert want['split_flops'] == 0
  shapes = {k: v.shape for k, v in nn.store(one.model).items()}
  mesh = meshes.Mesh((1, 1, 2), 1)
  placements = meshes.resolve_rules(shapes, one.model.partition_rules, mesh)
  for rank in split['ranks']:
    got = rank['costs'][family]
    t, part = got['t'], got['split_flops']
    assert t == 2 and part > 0
    assert got['flops'] == want['flops'] - (t - 1) * part
    assert got['split'] == sorted(meshes.split_paths(placements, mesh))
    assert got['split'] and all(
        p.endswith(('/kernel', '/embed')) for p in got['split'])
