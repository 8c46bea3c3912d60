"""The port's device-resident latent table against the JAX package's.

Mirrors tests/test_latents.py on the CPU at the `debug` preset's sizes:
the slot allocator (the same calls give the same slots, generations and
counters), the table's gather, valid and scatter on the same contents,
the table's sizing, the Agent's replay keys, and the context logic
(`inject_latents`, with some stale generations) each against the JAX
package's on the same numpy inputs, bit for bit. Then the port's train
step on the table path against its host path (`torch.latent_slots: 0`)
on the same latents, within TOL (float32, summation order only), the
`latents_in_replay` fallback, and the allocator's checkpoints.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu.models import common as jcommon
from embodied_tpu.models.dreamerv3 import main as jmain
from embodied_tpu.parallel import latents as jlatents
from embodied_tpu.parallel import meshes
from embodied_tpu.utils import Space as JSpace
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.parallel import latents
from embodied_tpu_torch.utils import Space

TOL = 1e-4
PORT = ['--configs', 'debug', '--task', 'dummy_disc',
        '--torch.compute_dtype', 'float32', '--torch.fetch_depth', '0']


def jax_table(spaces, capacity, **kw):
  mesh = meshes.make_mesh('1,1,1', devices=jax.devices('cpu')[:1])
  spaces = {k: JSpace(s.dtype, s.shape) for k, s in spaces.items()}
  return jlatents.LatentTable(spaces, capacity, mesh, **kw)


SPACES = {'dyn/deter': Space(np.int8, 6), 'dyn/stoch': Space(np.uint8, 3)}


@pytest.mark.parametrize('capacity,kw', [
    (8, {}), (16, dict(eval_slots=4)), (17, dict(eval_slots=5, nprocs=2,
                                                 proc=1))])
def test_allocator_matches_jax(capacity, kw):
  port = latents.LatentTable(SPACES, capacity, 'cpu', **kw)
  ref = jax_table(SPACES, capacity, **kw)
  assert port.capacity == ref.capacity
  assert port.spans == ref.spans and port.bases == ref.bases
  calls = [('alloc', 6, 'train'), ('alloc', 6, 'eval'), ('alloc', 40, 'eval'),
           ('alloc', 3, 'report'), ('bump',), ('alloc', 5, 'train'),
           ('save',), ('alloc', 9, 'eval')]
  for call in calls:
    if call[0] == 'alloc':
      (s1, g1), (s2, g2) = port.alloc(*call[1:]), ref.alloc(*call[1:])
      assert s1.dtype == s2.dtype == np.int32
      assert g1.dtype == g2.dtype == np.uint32
      np.testing.assert_array_equal(s1, s2)
      np.testing.assert_array_equal(g1, g2)
    elif call[0] == 'bump':
      port.bump_generations()
      ref.bump_generations()
    else:
      state = port.save()
      assert state == ref.save()
      port = latents.LatentTable(SPACES, capacity, 'cpu', **kw)
      ref = jax_table(SPACES, capacity, **kw)
      port.load(state)
      ref.load(state)
    assert port.counters == ref.counters
  port.load({'counter': 7})
  ref.load({'counter': 7})
  assert port.counters == ref.counters and port.counter == 7


def test_gather_valid_scatter_match_jax():
  rng = np.random.default_rng(0)
  port = latents.LatentTable(SPACES, 32, 'cpu')
  ref = jax_table(SPACES, 32)
  contents = {
      'dyn/deter': rng.integers(-128, 128, (32, 6)).astype(np.int8),
      'dyn/stoch': rng.integers(0, 256, (32, 3)).astype(np.uint8),
      '_gen': rng.integers(0, 3, 32).astype(np.uint32)}
  contents['_gen'][:4] = jlatents.GEN_INVALID
  ref.tables = {k: jnp.asarray(v) for k, v in contents.items()}
  for key, value in contents.items():
    port.tables[key].copy_(torch.from_numpy(
        value.view(np.int32) if key == '_gen' else value))
  slots = rng.permutation(32)[:12].reshape(3, 4).astype(np.int32)
  gens = rng.integers(0, 3, (3, 4)).astype(np.uint32)
  got = port.gather(torch.from_numpy(slots))
  want = jlatents.LatentTable.gather(ref.tables, ref.keys, jnp.asarray(slots))
  for key in SPACES:
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
  got = port.valid(torch.from_numpy(slots), latents.device_gens(gens))
  want = jlatents.LatentTable.valid(ref.tables, jnp.asarray(slots),
                                    jnp.asarray(gens))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert 0 < got.sum() < got.numel()
  values = {'dyn/deter': rng.integers(-128, 128, (3, 4, 6)).astype(np.int8),
            'dyn/stoch': rng.integers(0, 256, (3, 4, 3)).astype(np.uint8)}
  port.scatter(torch.from_numpy(slots), latents.device_gens(gens),
               {k: torch.from_numpy(v) for k, v in values.items()})
  want = jlatents.LatentTable.scatter(
      ref.tables, ref.keys, jnp.asarray(slots), jnp.asarray(gens),
      {k: jnp.asarray(v) for k, v in values.items()})
  for key, value in want.items():
    got = port.tables[key].numpy()
    np.testing.assert_array_equal(
        got.view(np.uint32) if key == '_gen' else got, np.asarray(value))


def port_config(*extra):
  return common.assemble_config(main.CONFIGS, PORT + list(extra))


def port_agent(*extra):
  return main.make_agent(port_config(*extra), device='cpu')


@pytest.fixture(scope='module')
def jax_agent(tmp_path_factory):
  """The JAX Agent at the debug preset on one CPU device, with its latent
  table on (the JAX default)."""
  path = os.path.join(os.path.dirname(jmain.__file__), 'configs.yaml')
  config = jcommon.assemble_config(path, [
      '--configs', 'debug', '--task', 'dummy_disc', '--logdir',
      str(tmp_path_factory.mktemp('jax')), '--jax.platform', '',
      '--jax.mesh', '1,1,1'])
  return jmain.make_agent(config)


def test_sizing_and_ext_space_match_jax(jax_agent):
  agent = port_agent()
  ref = jax_agent._latents
  assert agent._latents.capacity == ref.capacity == 11_000
  assert agent._latents.spans == ref.spans
  assert agent._latents.bases == ref.bases
  assert agent._latents.keys == ref.keys == ('dyn/deter', 'dyn/stoch')
  assert agent._latents.nbytes == ref.nbytes
  want = jax_agent.ext_space
  got = agent.ext_space
  assert sorted(got) == sorted(want) and 'slot' in got and (
      'dyn/deter' not in got)
  for key, space in got.items():
    assert (space.dtype, space.shape) == (want[key].dtype, want[key].shape)
  # Off and latents_in_replay: the model's columns, then both.
  assert sorted(port_agent('--torch.latent_slots', '0').ext_space) == sorted(
      jax_agent.model.ext_space)
  both = port_agent('--torch.latents_in_replay', 'True').ext_space
  assert {'slot', 'slotgen', 'dyn/deter', 'dyn/stoch'} <= set(both)


@pytest.mark.parametrize('preset,slots,nbytes', [
    ([], 521_994, 4_294_966_632), (['size12m'], 2_060_924, None)])
def test_sizing_of_the_presets(preset, slots, nbytes):
  """The default dims' table (8,192 int8 deter and 32 stoch indices, 8,228
  B a slot with its generation) fills the 4 GiB budget; so does size12m's,
  as the JAX agent's printed on its own bench. Built on the meta device:
  shapes only."""
  config = common.assemble_config(
      main.CONFIGS, ['--task', 'dummy_disc'] + (
          ['--configs', *preset] if preset else []))
  D, S = config.agent.dyn.rssm.deter, config.agent.dyn.rssm.stoch
  spaces = {'dyn/deter': Space(np.int8, D), 'dyn/stoch': Space(np.uint8, S)}
  minimum = 4 * config.batch_size * (config.batch_length +
                                     config.replay_context)
  capacity, eval_slots = latents.plan(
      spaces, -1, config.torch.latent_budget_gb, config.replay.size, minimum)
  table = latents.LatentTable(spaces, capacity, 'meta', eval_slots=eval_slots)
  assert table.capacity == slots
  assert table.nbytes == slots * latents.LatentTable.bytes_per_slot(spaces)
  assert table.nbytes <= 4 << 30
  if nbytes:
    assert table.nbytes == nbytes
    assert table.spans == {'train': 260_997, 'eval': 260_997}


def jax_inject(jax_agent):
  """The JAX agent's inject_latents, as its train step calls it."""
  fn = jax_agent._train_table.__wrapped__
  cells = dict(zip(fn.__code__.co_freevars,
                   (c.cell_contents for c in fn.__closure__)))
  return cells['inject_latents']


def table_batch(agent, rng, stale=()):
  """A (B, T + 1) batch on the table path whose slots hold random latents
  written at generation 1, and the same latents as replay columns: fresh
  windows (consec 0) that graft the stored context. Windows in `stale`
  carry an older generation at their context step."""
  config = agent.config
  B, T = config.batch_size, config.batch_length + config.replay_context
  data = agent._example_batch(B, T)
  for key in agent.obs_space:
    space = agent.obs_space[key]
    if data[key].dtype == np.uint8:
      data[key][:] = rng.integers(0, 256, data[key].shape)
    elif data[key].dtype == np.float32:
      data[key][:] = rng.standard_normal(data[key].shape)
  data['is_first'][:, 0] = True
  data['action'][:] = rng.integers(0, 5, data['action'].shape)
  ids = np.arange(B * T, dtype=np.int64).reshape(B, T)
  data['stepid'][..., :8] = ids[..., None].view(np.uint8).reshape(B, T, 8)
  data['slot'] = rng.permutation(agent._latents.span)[:B * T].reshape(
      B, T).astype(np.int32)
  data['slotgen'] = np.ones((B, T), np.uint32)
  dyn = agent.model.dyn
  stored = {
      'dyn/deter': rng.integers(-127, 128, (B, T, dyn.deter)).astype(np.int8),
      'dyn/stoch': rng.integers(0, dyn.classes, (B, T, dyn.stoch)).astype(
          np.uint8)}
  agent._latents.scatter(
      torch.from_numpy(data['slot']), latents.device_gens(data['slotgen']),
      {k: torch.from_numpy(v) for k, v in stored.items()})
  for b in stale:
    data['slotgen'][b, config.replay_context - 1] = 0
  return data, stored


def test_inject_latents_matches_jax(jax_agent):
  agent = port_agent()
  rng = np.random.default_rng(1)
  data, _ = table_batch(agent, rng, stale=(1, 3))
  data['consec'][3] = 1  # a continuing window keeps its flowing carry
  data['is_first'][:, 1] = rng.random(data['is_first'].shape[0]) < 0.5
  for key, value in agent._latents.tables.items():
    values = value.numpy().view(np.uint32) if key == '_gen' else value.numpy()
    jax_agent._latents.tables[key] = jnp.asarray(values)
  with jax.transfer_guard('allow'):
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    want, *_, jvalid = jax_inject(jax_agent)(jax_agent._latents.tables, jdata)
  got, _, _, valid = agent.inject_latents(
      {k: agent._to_device(v) for k, v in data.items()})
  np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
  assert sorted(got) == sorted(want)
  for key, value in want.items():
    np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                  err_msg=key)
  # Window 1 starts fresh with a stale context: its window start is reset.
  assert got['is_first'][1, 1] and not data['is_first'][1, 1]
  assert not got['is_first'][3, 1] or data['is_first'][3, 1]


def host_batch(data, stored, K, reset=()):
  """The host path's batch: the same steps with the latents as columns."""
  host = {k: v for k, v in data.items() if k not in ('slot', 'slotgen')}
  host.update(stored)
  host['is_first'] = host['is_first'].copy()
  for b in reset:
    host['is_first'][b, K] = True
  return host


def close(got, want, name):
  assert abs(got - want) <= TOL * (1 + abs(want)), (name, got, want)


@pytest.mark.parametrize('stale', [(), (0, 2)], ids=['fresh', 'stale'])
def test_train_step_on_the_table_matches_the_host_path(stale):
  """The same store, latents and noise through the table path and the host
  path (latent_slots 0): the same losses within TOL; the table rows of
  the trained steps equal the host path's refreshed latents. With stale
  generations, latents/valid drops and the host path's windows reset."""
  table = port_agent()
  host = port_agent('--torch.latent_slots', '0')
  host.load(table.save())
  K = table.replay_context
  data, stored = table_batch(table, np.random.default_rng(2), stale)
  B, T = data['is_first'].shape
  _, outs, mets = table.train(table.init_train(B), data)
  _, houts, hmets = host.train(host.init_train(B), host_batch(
      data, stored, K, stale))
  assert 'replay' not in outs
  assert abs(mets['latents/valid'] - (1 - len(stale) / (B * T))) < 1e-6
  assert sorted(set(mets) - {'latents/valid'}) == sorted(hmets)
  for key, value in hmets.items():
    close(mets[key], value, key)
  rows = table._latents.gather(torch.from_numpy(data['slot'][:, K:]))
  for key in ('dyn/deter', 'dyn/stoch'):
    np.testing.assert_array_equal(rows[key].numpy(), houts['replay'][key])
  gens = table._latents.tables['_gen'].numpy()[data['slot'][:, K:]]
  np.testing.assert_array_equal(gens, data['slotgen'][:, K:].view(np.int32))


def test_policy_writes_the_host_paths_latents():
  """Policy calls on the table path put in the table, at the slots they
  return, the packed latents the host path returns, bit for bit."""
  table = port_agent()
  host = port_agent('--torch.latent_slots', '0')
  host.load(table.save())
  rng = np.random.default_rng(3)
  carries = table.init_policy(3), host.init_policy(3)
  for i, mode in enumerate(('train', 'eval', 'train')):
    obs = table._example_obs(3)
    obs['image'][:] = rng.integers(0, 256, obs['image'].shape)
    obs['is_first'][:] = i == 0
    tc, tact, tout = table.policy(carries[0], obs, mode)
    hc, hact, hout = host.policy(carries[1], obs, mode)
    carries = tc, hc
    np.testing.assert_array_equal(tact['action'], hact['action'])
    region = 'eval' if mode == 'eval' else 'train'
    base = table._latents.bases[region]
    assert base <= tout['slot'].min() and (
        tout['slot'].max() < base + table._latents.spans[region])
    rows = table._latents.gather(torch.from_numpy(tout['slot']))
    for key in ('dyn/deter', 'dyn/stoch'):
      assert key not in tout
      np.testing.assert_array_equal(rows[key].numpy(), hout[key])
    assert table._latents.valid(
        torch.from_numpy(tout['slot']),
        latents.device_gens(tout['slotgen'])).all()


def test_latents_in_replay_falls_back_to_the_batch():
  """With latents_in_replay, a restarted agent (all generations invalid)
  grafts the batch's own latents: the host path's step, and the refreshed
  latents flow back for the replay as well as into the table."""
  both = port_agent('--torch.latents_in_replay', 'True')
  host = port_agent('--torch.latent_slots', '0')
  host.load(both.save())
  data, stored = table_batch(both, np.random.default_rng(4))
  both._latents.reset()
  data.update(stored)
  B = data['is_first'].shape[0]
  _, outs, mets = both.train(both.init_train(B), data)
  _, houts, hmets = host.train(host.init_train(B), host_batch(
      data, stored, both.replay_context))
  assert mets['latents/valid'] == 0.0
  for key, value in hmets.items():
    close(mets[key], value, key)
  for key in ('dyn/deter', 'dyn/stoch'):
    np.testing.assert_array_equal(outs['replay'][key], houts['replay'][key])


def test_checkpoint_persists_the_allocator():
  agent = port_agent()
  agent._latents.alloc(7)
  agent._latents.alloc(2, 'eval')
  state = agent.save()
  assert state['latents'] == {'counters': {'train': 7, 'eval': 2}}
  other = port_agent()
  other.load(state)
  assert other._latents.counters == {'train': 7, 'eval': 2}
  # A checkpoint made without the table starts one generation up, so no
  # restored (slot, slotgen) pair can match a fresh allocation.
  del state['latents']
  other = port_agent()
  other.load(state)
  slots, gens = other._latents.alloc(4)
  np.testing.assert_array_equal(slots, [0, 1, 2, 3])
  assert (gens == 1).all()
