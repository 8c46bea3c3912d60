"""The port's multi-device part on gloo ranks of this host's CPU.

Each multi-rank case runs in child interpreters (tests/
torch_distributed_worker.py, which imports no JAX), joined through the
port's make_agent with a coordinator address and RANK/WORLD_SIZE, as a
multi-host launcher starts them; every child must end within TIMEOUT, and
the process group's own timeout is finite. Held here:

- data parallel equals one process: two ranks of 4 rows against one rank
  of 8, on the same store, batch and noise (each rank takes its rows of
  the one-rank step's recorded noise), for DreamerV3, PPO and Director in
  float32: losses, metrics, every updated parameter and normalizer state,
  at rtol 1e-5 and atol 1e-6, since only the summation order differs;
- the two-rank DreamerV3 step against the JAX model's step on a '2,1,1'
  mesh of the virtual CPU devices, on the JAX store and the JAX draws, at
  tests/test_torch_slice.py's tolerances, and so the step that the
  parallel script's learners make on the two ranks;
- shardmap mode: replicated placements, the default mode's numbers;
- the percentile over two ranks' halves equals the whole batch's exactly;
- two processes of batch_size 4 make a global batch of 8 and log the same
  loss (tests/test_multihost.py's check, through the port's make_agent);
- the policy/train split, the grouped save, the latent table's ranges
  against the JAX table's, `main` under torch.mock_devices and the
  dry run of tools/dryrun_multidevice.py.
"""

import json
import os
import pathlib
import pickle
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu.nn import dists as jdists
from embodied_tpu.parallel import latents as jlatents
from embodied_tpu.parallel import meshes as jmeshes
from embodied_tpu.utils import Space as JSpace
from embodied_tpu_torch import nn
from embodied_tpu_torch.models import common
from embodied_tpu_torch.parallel import convert
from embodied_tpu_torch.parallel import latents as latentslib
from embodied_tpu_torch.tools.dryrun_multidevice import RecordDraws
from embodied_tpu_torch.utils import Space
from test_torch_slice import (
    LR, TOL, Recorder, close, grad_close, jax_model, loop_scan, paired_pred)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).with_name('torch_distributed_worker.py')
TIMEOUT = 240
# One thread a rank: the test workers share the host's cores already.
ENV = dict(os.environ, OMP_NUM_THREADS='1')
RTOL, ATOL = 1e-5, 1e-6
B, LOCAL, T = 8, 4, 4
CHUNK = 4096  # bytes: the debug stores save in many groups
DREAMER = ['--task', 'dummy_disc', '--configs', 'debug',
           '--agent.dyn.rssm.deter', '64', '--agent.dyn.rssm.hidden', '32',
           '--agent.dyn.rssm.blocks', '4', '--agent.dyn.rssm.stoch', '4',
           '--agent.dyn.rssm.classes', '4', '--agent.enc.simple.depth', '4',
           '--agent.enc.simple.units', '16',
           '--agent.enc.simple.layers', '2',
           '--agent.policy.units', '16', '--agent.policy.layers', '2',
           '--batch_length', str(T), '--agent.opt.warmup', '0',
           '--agent.opt.lr', str(LR)]
HOST_PATH = ['--torch.compute_dtype', 'float32', '--torch.latent_slots', '0',
             '--torch.fetch_depth', '0']
FAMILY = {
    'ppo': ['--task', 'dummy_disc', '--configs', 'debug',
            '--batch_length', '6', '--agent.opt.warmup', '0'],
    'director': ['--task', 'dummy_disc', '--configs', 'debug',
                 '--batch_length', str(T), '--agent.opt.warmup', '0'],
}


def free_port():
  with socket.socket() as sock:
    sock.bind(('localhost', 0))
    return sock.getsockname()[1]


def launch(case, inputs, folder, world=2):
  """Run `case` on `world` gloo ranks in child interpreters; returns each
  rank's output."""
  folder = pathlib.Path(folder)
  folder.mkdir(parents=True, exist_ok=True)
  with open(folder / 'inputs.pkl', 'wb') as f:
    pickle.dump(inputs, f)
  port = free_port()
  procs = [subprocess.Popen(
      [sys.executable, str(WORKER), case, str(rank), str(world), str(port),
       str(folder)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
      text=True, env=ENV) for rank in range(world)]
  try:
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.communicate()
  for rank, (proc, out) in enumerate(zip(procs, outs)):
    assert proc.returncode == 0, (rank, out[-3000:])
  results = []
  for rank in range(world):
    with open(folder / f'rank{rank}.pkl', 'rb') as f:
      results.append(pickle.load(f))
  return results


def port_agent(family, argv):
  main = __import__(f'embodied_tpu_torch.models.{family}.main',
                    fromlist=['main'])
  config = common.assemble_config(main.CONFIGS, argv)
  return main.make_agent(config, device='cpu')


def host_store(agent):
  return {k: v.detach().numpy().copy()
          for k, v in nn.store(agent.model).items()}


def random_batch(agent, rows, length, seed):
  """Every replay key of `agent` at (rows, length), random within its
  space; each row starts an episode."""
  rng = np.random.default_rng(seed)
  data = agent._example_batch(rows, length)
  spaces = {**agent.obs_space, **agent.act_space, **agent.model.ext_space}
  for key, value in data.items():
    space = spaces[key]
    if key in ('is_first', 'is_last', 'is_terminal'):
      value[:] = rng.random(value.shape) < 0.2
    elif key.startswith('logp/'):
      value[:] = np.log(0.2) + 0.3 * rng.standard_normal(value.shape)
    elif key == 'memory':
      value[:] = np.tanh(rng.standard_normal(value.shape))
    elif value.dtype == np.float32:
      value[:] = 2 * rng.standard_normal(value.shape)
    elif key == 'dyn/deter':
      value[:] = rng.integers(-127, 128, value.shape)
    elif key == 'dyn/stoch':
      value[:] = rng.integers(0, agent.model.dyn.classes, value.shape)
    elif key not in ('consec', 'stepid'):
      low = 0 if space.dtype == np.uint8 else int(np.min(space.low))
      high = 256 if space.dtype == np.uint8 else int(np.max(space.high))
      value[:] = rng.integers(low, high, value.shape)
  data['is_first'][:, 0] = True
  return data


def one_rank_step(agent, data, draws):
  """One Agent.train step of `agent` on the whole batch with `draws`
  recorded: (metrics, outs, store after, recorded noise)."""
  record = RecordDraws(draws)
  agent._draws = lambda kind, salt: record
  _, outs, mets = agent.train(agent.init_train(len(data['is_first'])), data)
  return mets, outs, host_store(agent), record.recorded


def assert_same_step(got, mets, outs, store, rank):
  """A rank's step against the one-rank step on the whole batch."""
  assert sorted(got['mets']) == sorted(mets)
  for key, value in mets.items():
    np.testing.assert_allclose(got['mets'][key], value, RTOL, ATOL,
                               err_msg=f'rank {rank} {key}')
  for key, value in store.items():
    np.testing.assert_allclose(got['store'][key], value, RTOL, ATOL,
                               err_msg=f'rank {rank} {key}')
  index = got['data_index']
  for key, value in outs.get('replay', {}).items():
    mine = value[index * LOCAL:(index + 1) * LOCAL]
    theirs = got['outs']['replay'][key]
    assert theirs.shape == mine.shape, key
    if np.issubdtype(mine.dtype, np.floating):
      np.testing.assert_allclose(theirs, mine, RTOL, ATOL,
                                 err_msg=f'rank {rank} replay {key}')
    else:  # Quantized latents: a rounding may land one step over.
      assert np.abs(theirs.astype(int) - mine.astype(int)).max() <= (
          1 if key == 'dyn/deter' else 0), key


@pytest.fixture(scope='module')
def dreamer(tmp_path_factory):
  """The DreamerV3 step four ways, on one store, batch and noise: the JAX
  model's on a '2,1,1' mesh, the port's on one rank and on two gloo
  ranks (default and shardmap mode), with the Normalize check."""
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
      result = dreamer_steps(rec, tmp_path_factory.mktemp('dreamer'))
    finally:
      jnn.set_compute_dtype(previous)
  return result


def dreamer_steps(rec, folder):
  jm = jax_model(DREAMER + ['--batch_size', str(B)])
  agent = port_agent('dreamerv3', DREAMER + HOST_PATH + [
      '--batch_size', str(B)])
  data = random_batch(agent, B, T + 1, 8)
  data['consec'][1] = 1
  # The store's values do not depend on the batch: trace at 2 rows.
  rec.start(99)
  cell = {}

  def trace(key, data):
    ctx = jnn.core.Ctx({}, create=True, key=key)
    jm.train(ctx, jm.init_train(ctx, 2), data)
    cell.update(meta=dict(ctx.meta), recipes=dict(ctx.recipes))
    return {**ctx.store, **ctx.updates}
  jax.eval_shape(trace, jax.random.PRNGKey(0),
                 {k: v[:2] for k, v in data.items()})
  store = jax_fastinit(cell['recipes'])
  meta = cell['meta']
  rec.start(9)
  mesh = jmeshes.make_mesh('2,1,1')
  train = lambda ctx, data: jm.train(ctx, jm.init_train(ctx, B), data)
  step = jax.jit(jnn.pure(train, meta), in_shardings=(
      jmeshes.replicated(mesh), jmeshes.replicated(mesh),
      jmeshes.data_sharding(mesh)))
  updates, (_, jouts, jmets) = step(store, jax.random.PRNGKey(2), data)
  jafter = {**store, **updates}
  start = convert.from_jax(store)
  agent.load({'store': start})
  mets, outs, after, recorded = one_rank_step(agent, data, rec.replay())
  values = np.random.default_rng(3).standard_normal(64).astype(np.float32)
  ranks = launch('step', {'runs': [dict(
      family='dreamerv3', argv=DREAMER + HOST_PATH, local=LOCAL,
      store=start, batch=data, recorded=recorded, chunk_bytes=CHUNK,
      shardmap=True, learner=True, values=values)]}, folder)
  return dict(
      ranks=[r[0] for r in ranks], mets=mets, outs=outs, after=after,
      agent=agent, data=data, values=values, meta=meta, jmets=jmets,
      jouts=jouts, jafter=jafter, mesh_spec=mesh.devices.shape)


def jax_fastinit(recipes):
  """The JAX agent's initial store from its recipes
  (parallel/agent.py _init_store)."""
  import zlib
  key = jax.random.PRNGKey(0)
  store = {}
  for path, (kind, *recipe) in recipes.items():
    if kind == 'init':
      init, shape, dtype = recipe
      store[path] = (init(jax.random.fold_in(key, zlib.crc32(
          path.encode())), shape, dtype) if callable(init) else
                     jnp.full(shape, init, dtype))
  for path, (kind, *recipe) in recipes.items():
    if kind == 'copy':
      store[path] = store[recipe[0]]
  return store


@pytest.fixture(scope='module')
def families(tmp_path_factory):
  """PPO's and Director's step on one rank and on two gloo ranks."""
  runs, refs = [], {}
  for family, argv in FAMILY.items():
    argv = argv + HOST_PATH
    agent = port_agent(family, argv + ['--batch_size', str(B)])
    length = agent.batch_length + agent.replay_context
    data = random_batch(agent, B, length, 5)
    start = agent.save()['store']
    gen = torch.Generator().manual_seed(11)
    mets, outs, after, recorded = one_rank_step(
        agent, data, nn.dists.Draws(gen, 'cpu'))
    refs[family] = dict(mets=mets, outs=outs, after=after)
    runs.append(dict(family=family, argv=argv, local=LOCAL, store=start,
                     batch=data, recorded=recorded, chunk_bytes=CHUNK))
  ranks = launch('step', {'runs': runs}, tmp_path_factory.mktemp('families'))
  for i, family in enumerate(FAMILY):
    refs[family]['ranks'] = [r[i] for r in ranks]
  return refs


@pytest.mark.parametrize('family', ['dreamerv3', 'ppo', 'director'])
def test_data_parallel_equals_one_process(request, family):
  ref = (request.getfixturevalue('dreamer') if family == 'dreamerv3' else
         request.getfixturevalue('families')[family])
  for rank, got in enumerate(ref['ranks']):
    assert got['batch_size'] == B
    assert got['data_index'] == rank
    assert not got['use_shardmap']
    assert_same_step(got, ref['mets'], ref['outs'], ref['after'], rank)
  # The ranks hold the same store, bit for bit.
  for key, value in ref['ranks'][0]['store'].items():
    np.testing.assert_array_equal(ref['ranks'][1]['store'][key], value)


def test_two_ranks_match_the_jax_mesh_step(dreamer):
  assert dreamer['mesh_spec'] == (2, 1, 1)
  for got in dreamer['ranks']:
    assert_matches_jax_step(got, dreamer)


def test_two_learners_match_the_jax_mesh_step(dreamer):
  """The parallel script's _Learner on each rank, fed the rank's rows in
  process, makes the same step: its logged train metrics, the store
  after it and the replay updates it sent against the JAX mesh step."""
  for got in dreamer['ranks']:
    assert_matches_jax_step(got['learner'], dreamer)


def assert_matches_jax_step(got, ref, rows=LOCAL):
  """A rank's step (metrics, store after it, replay outputs of its
  `rows` rows) against the JAX mesh step in `ref` (jmets, jafter, meta,
  jouts) at test_slice_train_step_matches_jax's tolerances: values 1e-4;
  a first update of lr * sign(g) (2 lr apart where |g| is near zero, 99%
  within 1e-6); the square moments 1e-3 relative in norm."""
  jmets, jafter, meta = ref['jmets'], ref['jafter'], ref['meta']
  assert sorted(got['mets']) == sorted(jmets)
  for key, value in got['mets'].items():
    if not key.startswith('opt/update'):
      close(torch.as_tensor(value), jmets[key], key)
  assert sorted(got['store']) == sorted(jafter)
  for path, want in jafter.items():
    want = np.asarray(want, np.float32)
    value = got['store'][path].astype(np.float32)
    if meta.get(path) == 'param' and not path.startswith('slowval/'):
      np.testing.assert_allclose(value, want, atol=2 * LR + 1e-6, rtol=0,
                                 err_msg=path)
      assert np.mean(np.abs(value - want) <= 1e-6) >= 0.99, path
    elif path == 'opt/mom_flat':
      np.testing.assert_allclose(value, want, atol=2 * 0.1 + 1e-6, rtol=0)
      assert np.mean(np.abs(value - want) <= 1e-5) >= 0.99, path
    elif path == 'opt/rms_flat':
      grad_close(torch.tensor(value), want, path)
    else:
      close(value, want, path, tol=1e-3 if path.startswith('slowval/')
            else TOL)
  index = got['data_index']
  for key, value in got['outs']['replay'].items():
    want = np.asarray(ref['jouts']['replay'][key])[
        index * rows:(index + 1) * rows]
    assert value.shape == want.shape, key
    assert np.abs(value.astype(int) - want.astype(int)).max() <= (
        1 if key == 'dyn/deter' else 0), key


def test_shardmap_equals_default_mode(dreamer):
  for got in dreamer['ranks']:
    sm = got['shardmap']
    assert sm['use_shardmap']
    assert all(spec == () for spec in sm['shardings'].values())
    for key, value in got['mets'].items():
      np.testing.assert_array_equal(sm['mets'][key], value, err_msg=key)
    for key, value in got['store'].items():
      np.testing.assert_array_equal(sm['store'][key], value, err_msg=key)


def test_normalize_over_ranks_equals_whole_batch(dreamer):
  """The percentile over two ranks' halves equals the whole batch's, bit
  for bit; the mean and square mean to rounding."""
  whole = torch.tensor(dreamer['values'])
  for impl in ('perc', 'meanstd'):
    norm = nn.Normalize(impl, rate=0.5, name=impl)
    norm.update(whole)
    want = {k: v.numpy() for k, v in norm.state_dict().items()}
    for got in dreamer['ranks']:
      for key, value in want.items():
        if impl == 'perc':
          np.testing.assert_array_equal(got['normalize'][impl][key], value)
        else:
          np.testing.assert_allclose(got['normalize'][impl][key], value,
                                     RTOL, ATOL)


def test_grouped_save_equals_one_rank_save(dreamer):
  """The ranks' saves, made in groups of CHUNK bytes (many groups at this
  size), equal each other bit for bit and the one-rank agent's after the
  same step; each loads into a one-rank agent and acts as it does."""
  saves = [got['save'] for got in dreamer['ranks']]
  total = sum(v.nbytes for v in saves[0].values())
  assert total > 20 * CHUNK, total
  one = dreamer['agent'].save(chunk_bytes=CHUNK)['store']
  assert sorted(saves[0]) == sorted(saves[1]) == sorted(one)
  for key, value in one.items():
    np.testing.assert_array_equal(saves[1][key], saves[0][key])
    np.testing.assert_allclose(saves[0][key], value, RTOL, ATOL)
    assert saves[0][key].dtype == value.dtype, key
  agents = [port_agent('dreamerv3', DREAMER + HOST_PATH + [
      '--batch_size', str(B)]) for _ in saves]
  obs = {k: v[:, 0] for k, v in dreamer['data'].items()
         if k in dreamer['agent'].obs_space}
  outs = []
  for agent, save in zip(agents, saves):
    agent.load({'store': save})
    for key, value in host_store(agent).items():
      np.testing.assert_array_equal(value, save[key])
    _, act, out = agent.policy(agent.init_policy(B), obs)
    outs.append((act, out))
  ref = dreamer['agent']
  ref._counters['policy'] = 0
  _, act, out = ref.policy(ref.init_policy(B), obs)
  for key, value in act.items():
    np.testing.assert_array_equal(outs[0][0][key], outs[1][0][key])
    np.testing.assert_array_equal(outs[0][0][key], value)
  for key, value in out.items():
    np.testing.assert_allclose(outs[0][1][key], value, RTOL, ATOL)


def test_multihost_global_batch_and_same_loss(tmp_path):
  """tests/test_multihost.py through the port's make_agent: two processes
  of batch_size 4 each, the defaults (latent table, fetch pipeline)."""
  ranks = launch('multihost', {'logdir': str(tmp_path / 'logdir')},
                 tmp_path)
  assert [r['batch_size'] for r in ranks] == [8, 8]
  assert all(r['table'] for r in ranks)
  assert not any(r['shardmap_table'] for r in ranks)
  assert np.isfinite(ranks[0]['loss'])
  assert ranks[0]['loss'] == ranks[1]['loss']


def test_policy_split_acts_as_the_unsplit_agent():
  argv = DREAMER + ['--batch_size', str(B), '--torch.compute_dtype',
                    'float32', '--torch.fetch_depth', '0']
  split = port_agent('dreamerv3', argv + ['--torch.policy_mesh', '1,1,1'])
  plain = port_agent('dreamerv3', argv)
  assert split._latents is None and plain._latents is not None
  assert split.policy_copy_bytes > 0
  obs = split._example_obs(B)
  obs['is_first'][:] = True
  obs['image'][:] = np.random.default_rng(0).integers(
      0, 256, obs['image'].shape)
  _, act, out = split.policy(split.init_policy(B), obs)
  _, want, wout = plain.policy(plain.init_policy(B), obs)
  for key, value in want.items():
    np.testing.assert_array_equal(act[key], value)
  for key in out:
    if key in wout:
      np.testing.assert_array_equal(out[key], wout[key])
  # A train step marks the copy stale; it keeps the old weights until the
  # next policy call refreshes it.
  data = random_batch(split, B, T + 1, 4)
  paths = [k for k in nn.store(split.model)
           if re.search(split.model.policy_keys, k)]
  before = {k: v.clone() for k, v in nn.store(split._policy_copy).items()}
  split.train(split.init_train(B), data)
  assert split._policy_dirty
  trained = nn.store(split.model)
  copy = nn.store(split._policy_copy)
  moved = [k for k in paths if not torch.equal(trained[k], before[k])]
  assert moved
  for key in moved:
    assert torch.equal(copy[key], before[key]), key
  # Parameters outside policy_keys are the trained ones, not copies.
  assert all(torch.equal(copy[k], v) for k, v in trained.items()
             if k not in paths)
  split.policy(split.init_policy(B), obs)
  assert not split._policy_dirty
  for key in paths:
    assert torch.equal(nn.store(split._policy_copy)[key], trained[key])


# (capacity, eval slots): 1,001 + 100 slots are a multiple of the two
# processes but not of nshard (8) times them.
@pytest.mark.parametrize('capacity,eval_slots', [
    (1000, 100), (1001, 100), (4096, 0), (333, 33)])
@pytest.mark.parametrize('proc', [0, 1])
def test_latent_ranges_match_jax(capacity, eval_slots, proc):
  spaces = {'dyn/deter': Space(np.int8, (8,))}
  jspaces = {'dyn/deter': JSpace(np.int8, (8,))}
  mesh = jmeshes.make_mesh('4,2,1')
  want = jlatents.LatentTable(jspaces, capacity, mesh, nprocs=2, proc=proc,
                              eval_slots=eval_slots)
  got = latentslib.LatentTable(spaces, capacity, 'cpu', nprocs=2,
                               proc=proc, eval_slots=eval_slots, nshard=8)
  assert got.capacity == want.capacity
  assert got.bases == want.bases
  assert got.spans == want.spans
  assert len(got.tables['_gen']) == got.capacity // 2
  for region in got.spans:
    slots, gens = got.alloc(5, region)
    jslots, jgens = want.alloc(5, region)
    np.testing.assert_array_equal(slots, jslots)
    np.testing.assert_array_equal(gens, jgens)


def test_main_on_two_mock_devices(tmp_path):
  """`main --configs debug --torch.mock_devices 2 --torch.mesh 2,1,1`
  trains on two gloo ranks; rank 0 writes the logdir, rank 1 its
  subdirectory rank1, and each logs finite train losses."""
  logdir = tmp_path / 'logdir'
  proc = subprocess.run(
      [sys.executable, '-m', 'embodied_tpu_torch.models.dreamerv3.main',
       '--configs', 'debug', '--task', 'dummy_disc', '--logdir',
       str(logdir), '--torch.mock_devices', '2', '--torch.mesh', '2,1,1',
       '--run.steps', '120', '--run.log_every', '1', '--batch_size', '4'],
      cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT,
      env=ENV)
  assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
  for folder in (logdir, logdir / 'rank1'):
    lines = [json.loads(l) for l in
             (folder / 'metrics.jsonl').read_text().splitlines()]
    losses = [l['train/opt/loss'] for l in lines if 'train/opt/loss' in l]
    assert losses and all(np.isfinite(losses)), folder
    assert (folder / 'config.yaml').exists()
  assert not (logdir / 'rank0').exists()


def test_dryrun_multidevice_on_four_ranks():
  proc = subprocess.run(
      [sys.executable, '-m', 'embodied_tpu_torch.tools.dryrun_multidevice',
       '4'], cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT,
      env=ENV)
  assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
  assert 'dryrun_multidevice(4): mesh 1,2,2' in proc.stdout
  # Each rank's bytes between calls, sharded over ('f','t') = 4 ranks,
  # and the default configuration's store per rank (the dry run asserts
  # that the bytes held equal the placements').
  for rank in range(4):
    assert f'rank {rank} store bytes: ' in proc.stdout
  assert ('default configuration on mesh 1,2,1, per rank: 2,057,557,900 B '
          'held (429,631,488 sharded, 1,627,926,412 replicated') in (
              proc.stdout)
  assert 'mesh 1,2,2, per rank: 1,842,742,156 B held' in proc.stdout
