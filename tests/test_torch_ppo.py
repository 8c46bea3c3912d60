"""The port's PPO against the JAX PPO model, and its agent end to end.

The JAX Model's store (one trace of `init_train` + `train` in create mode,
values from the recipes, as `test_torch_slice.jax_store` makes it) goes
into the port unchanged through `nn.load_store`, and both run the same
numpy batch in float32, with `replay_context` 0 and 1: the policy's
distribution and the log-probability of a given action, the GAE
advantages, `ppo_loss`'s losses and metrics and their gradients, and one
`train` step's metrics, parameters, optimizer moments and normalizer
state. PPO's train step draws no noise, so the two agree up to summation
order. Tolerances are `test_torch_slice`'s: values 1e-4 relative and
absolute, gradients 1e-3 relative per tensor in norm, and a first update
of lr * sign(g) where two frameworks may round a near-zero gradient to
opposite signs (at most 2 lr apart, 99% of the entries within 1e-6).

The encoder's SAME max pool is held against the JAX encoder at an even
and an odd image size. The agent trains, saves and resumes through
`main` under `--configs debug`, and with the latent table on (the
default) the replay carries slot ids in place of the `memory` column.
Of tests/test_ppo_e2e.py, `test_policy_store_subset` has no counterpart
here: the policy's store subset serves the policy/train device split,
which comes with the port's distribution slice.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu.models import common as jcommon
from embodied_tpu.models.ppo import model as jmodel
from embodied_tpu.utils import Space as JSpace
from embodied_tpu_torch import nn
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.ppo import main, model as pmodel
from embodied_tpu_torch.parallel import convert
from embodied_tpu_torch.utils import Space
from test_torch_nn import jax_run, port
from test_torch_slice import (  # noqa: F401
    B, TOL, Recorder, close, grad_close, jax_f32, jax_store)

T = 6
UNITS = 8  # the debug preset's
LR = 3e-4
SIZE = ['--task', 'dummy_disc', '--configs', 'debug',
        '--batch_size', str(B), '--batch_length', str(T),
        '--agent.opt.warmup', '0', '--agent.opt.lr', str(LR),
        '--agent.enc.impala.depth', '4']
JAX_CONFIGS = pathlib.Path(jmodel.__file__).parent / 'configs.yaml'
CONTEXTS = [pytest.param(0, id='context0'), pytest.param(1, id='context1')]


def argv(context):
  return SIZE + ['--replay_context', str(context)]


def jax_model(args):
  config = jcommon.assemble_config(
      str(JAX_CONFIGS), args + ['--logdir', '/nonexistent'])
  obs_space, act_space = jcommon.env_spaces(config)
  return jmodel.Model(obs_space, act_space, jcommon.agent_config(config))


def port_agent(args, *extra):
  """The port's agent in float32 on the host path (the memory column
  rides the batch, as the JAX Model takes it), one step's results per
  train call."""
  config = common.assemble_config(main.CONFIGS, args + [
      '--torch.compute_dtype', 'float32', '--torch.latent_slots', '0',
      '--torch.fetch_depth', '0', *extra])
  return main.make_agent(config, device='cpu')


def make_batch(agent, context, seed):
  """A (B, T + context) batch of every replay key: random observations,
  actions, behaviour log-probabilities near the uniform policy's and GRU
  states in (-1, 1)."""
  rng = np.random.default_rng(seed)
  data = agent._example_batch(B, T + context)
  for key, value in data.items():
    if key in ('is_first', 'is_last', 'is_terminal'):
      value[:] = rng.random(value.shape) < 0.2
    elif key.startswith('logp/'):
      value[:] = np.log(0.2) + 0.3 * rng.standard_normal(value.shape)
    elif key == 'memory':
      value[:] = np.tanh(rng.standard_normal(value.shape))
    elif key == 'image':
      value[:] = rng.integers(0, 256, value.shape)
    elif value.dtype == np.float32:
      value[:] = 2 * rng.standard_normal(value.shape)
    elif key not in ('consec', 'stepid'):
      space = {**agent.obs_space, **agent.act_space}[key]
      value[:] = rng.integers(0, space.classes, value.shape)
  data['is_first'][:, 0] = True
  return data


def torch_data(data):
  return {k: torch.from_numpy(v.copy()) for k, v in data.items()}


def window(data, context, xp):
  """The train step's inputs to the loss, as both models slice the batch
  (`xp` is jnp or torch): (memory, data, prevact) from the initial carry,
  whose memory and previous action are zeros."""
  K = context
  if K:
    prevact = {'action': data['action'][:, K - 1:-1]}
    memory = data['memory'][:, K - 1]
    return memory, {k: v[:, K:] for k, v in data.items()
                    if k != 'memory'}, prevact
  cat = jnp.concatenate if xp is jnp else torch.cat
  first = xp.zeros((B, 1), dtype=data['action'].dtype)
  prevact = {'action': cat([first, data['action'][:, :-1]], 1)}
  return xp.zeros((B, UNITS)), data, prevact


STORES = {}


def setup(context, seed):
  """The JAX model and its store (made once per context: the store
  depends on the batch's shapes only), the port's agent on that store,
  and a batch from `seed`."""
  agent = port_agent(argv(context))
  data = make_batch(agent, context, seed)
  if context not in STORES:
    jm = jax_model(argv(context))
    STORES[context] = (jm, *jax_store(jm, data, Recorder()))
  jm, store, meta = STORES[context]
  agent.load({'store': convert.from_jax(store)})
  return jm, agent, data, store, meta


def test_store_carries_across(jax_f32):
  jm, agent, data, store, meta = setup(1, 0)
  store = convert.from_jax(store)
  assert {'opt/step', 'opt/rms_flat', 'opt/mom_flat', 'valnorm/mean',
          'advnorm/corr', 'rnn/core/kernel', 'actemb/embed_action/kernel',
          'enc/s0in/kernel', 'enc/outl/kernel', 'policy/out/head_action/'
          'logits/kernel', 'value/out/pred/kernel'} <= set(store)
  assert sorted(store) == sorted(nn.store(agent.model))
  assert not nn.load_store(agent.model, store)
  for path, value in nn.store(agent.model).items():
    np.testing.assert_array_equal(value.numpy(), store[path], err_msg=path)


@pytest.mark.parametrize('size', [8, 9], ids=['even', 'odd'])
def test_impala_encoder_same_pool(jax_f32, size):
  """XLA's SAME pads an even size by one pixel at the end only, an odd
  size by one on each side; the port's pool pads alike (8 -> 4 -> 2 and
  9 -> 5 -> 3)."""
  rng = np.random.default_rng(size)
  spaces = {'image': ((np.uint8, (size, size, 3)), {}),
            'depth': ((np.uint8, (size, size, 1)), {}),
            'vector': ((np.float32, (5,)), {}),
            'token': ((np.int32, ()), dict(low=0, high=7))}
  data = {'image': rng.integers(0, 256, (B, T, size, size, 3)),
          'depth': rng.integers(0, 256, (B, T, size, size, 1)),
          'vector': 2 * rng.standard_normal((B, T, 5)),
          'token': rng.integers(0, 7, (B, T))}
  data = {k: v.astype(spaces[k][0][0]) for k, v in data.items()}
  kw = dict(depth=3, mults=(1, 2), blocks=1, layers=2, units=8,
            outmult=4, norm='layer')
  jspaces = {k: JSpace(*a, **w) for k, (a, w) in spaces.items()}
  store, want = jax_run(
      lambda ctx, x: jmodel.ImpalaEncoder(jspaces, 'enc', **kw)(ctx, x),
      data)
  enc = port(pmodel.ImpalaEncoder(
      {k: Space(*a, **w) for k, (a, w) in spaces.items()}, 'enc',
      cdtype=torch.float32, **kw), store)
  got = enc(torch_data(data))
  assert got.shape == want.shape == (B, T, enc.width)
  close(got, want, 'encoder')
  # A pool with symmetric padding gives other numbers at the even size.
  x = torch.randn(2, size, size, 3)
  shifted = torch.nn.functional.max_pool2d(
      x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
  same = pmodel.same_max_pool(x)
  assert same.shape == shifted.shape
  assert torch.equal(same, shifted) == (size % 2 == 1)


@pytest.mark.parametrize('context', CONTEXTS)
def test_policy_matches_jax(jax_f32, context):
  jm, agent, data, store, meta = setup(context, 1)
  obs = {k: v[:, 0] for k, v in data.items()}
  obs['is_first'][:] = [False, True]
  rng = np.random.default_rng(2)
  memory = np.tanh(rng.standard_normal((B, 8))).astype(np.float32)
  prevact = {'action': rng.integers(0, 5, (B,)).astype(np.int32)}
  act = rng.integers(0, 5, (B,)).astype(np.int32)
  ctx = jnn.core.Ctx(store, key=jax.random.PRNGKey(0), meta=meta)
  want_mem, _, want_pol, _ = jm._forward(
      ctx, jnp.asarray(memory), obs, prevact, value=False, single=True)
  model = agent.model
  got_mem, _, got_pol, _ = model._forward(
      torch.from_numpy(memory), torch_data(obs), torch_data(prevact),
      value=False, single=True)
  close(got_mem, want_mem, 'memory')
  close(got_pol['action'].logprobs, want_pol['action'].logprobs, 'logprobs')
  close(got_pol['action'].logp(torch.from_numpy(act)),
        want_pol['action'].logp(act), 'logp')
  # The Agent's policy call: actions in range, their logp and the memory.
  carry, acts, out = agent.policy(agent.init_policy(B), obs)
  assert acts['action'].dtype == np.int32 and acts['action'].shape == (B,)
  assert sorted(out) == ['logp/action', 'memory']
  assert out['memory'].dtype == np.float32 and out['memory'].shape == (B, 8)
  assert (np.abs(out['memory']) <= 1).all()
  assert (out['logp/action'] <= 0).all()


def test_gae_advantages_match_jax():
  rng = np.random.default_rng(3)
  rew, val = rng.standard_normal((2, 4, 9)).astype(np.float32)
  live, cont = rng.random((2, 4, 8)).astype(np.float32)
  want = jmodel.gae_advantages(rew, live, cont, val)
  got = pmodel.gae_advantages(*(torch.from_numpy(x) for x in (
      rew, live, cont, val)))
  close(got, want, 'gae')


@pytest.mark.parametrize('context', CONTEXTS)
def test_loss_and_grads_match_jax(jax_f32, context):
  jm, agent, data, store, meta = setup(context, 4)
  params = {k: v for k, v in store.items() if meta.get(k) == 'param'}

  def wrt(params):
    ctx = jnn.core.Ctx({**store, **params}, key=jax.random.PRNGKey(1),
                       meta=meta)
    memory, window_data, prevact = window(
        {k: jnp.asarray(v) for k, v in data.items()}, context, jnp)
    loss, (memory, mets) = jm.loss(ctx, memory, window_data, prevact)
    return loss, (memory, mets, dict(ctx.updates))
  (total, (want_mem, mets, updates)), grads = jax.jit(
      jax.value_and_grad(wrt, has_aux=True))(params)
  model = agent.model
  memory, window_data, prevact = window(torch_data(data), context, torch)
  got_total, (got_mem, got) = model.loss(memory, window_data, prevact)
  assert sorted(got) == sorted(mets)
  for key in mets:
    close(got[key], mets[key], key)
  close(got_total, total, 'total loss')
  close(got_mem, want_mem, 'memory')
  # The normalizers updated once, inside the loss.
  for path, want in updates.items():
    close(nn.store(model)[path], want, path)
  paths = nn.scope_params(model, pmodel.Model.SCOPES)
  assert sorted(paths) == sorted(grads)
  values = torch.autograd.grad(got_total, list(paths.values()),
                               allow_unused=True)
  for (path, param), value in zip(paths.items(), values):
    value = torch.zeros_like(param) if value is None else value
    grad_close(value, grads[path], path)


@pytest.mark.parametrize('context', CONTEXTS)
def test_train_step_matches_jax(jax_f32, context):
  jm, agent, data, store, meta = setup(context, 5)
  train = lambda ctx, data: jm.train(ctx, jm.init_train(ctx, B), data)
  updates, (carry, _, mets) = jax.jit(jnn.pure(train, meta))(
      store, jax.random.PRNGKey(2), data)
  after = {**store, **updates}
  (got_mem, got_act), outs, got = agent.model.train_step(
      agent.model.init_train(B), torch_data(data))
  assert outs == {}
  assert sorted(got) == sorted(mets)
  for key in got:
    if not key.startswith('opt/update'):
      close(torch.as_tensor(got[key]), mets[key], key)
  close(got_mem, carry[0], 'memory')
  np.testing.assert_array_equal(got_act['action'].numpy(),
                                carry[1]['action'])
  now = {k: v.detach().numpy() for k, v in nn.store(agent.model).items()}
  assert sorted(now) == sorted(after)
  for path, want in after.items():
    want, value = np.asarray(want, np.float32), now[path].astype(np.float32)
    if meta.get(path) == 'param':
      np.testing.assert_allclose(value, want, atol=2 * LR + 1e-6, rtol=0,
                                 err_msg=path)
      assert np.mean(np.abs(value - want) <= 1e-6) >= 0.99, path
    elif path == 'opt/mom_flat':
      np.testing.assert_allclose(value, want, atol=2 * 0.1 + 1e-6, rtol=0)
      assert np.mean(np.abs(value - want) <= 1e-5) >= 0.99, path
    elif path == 'opt/rms_flat':
      grad_close(torch.tensor(value), want, path)
    else:
      close(value, want, path)


def test_latent_table_replaces_memory_column():
  """With the device-resident latent table on (the default), the GRU
  state never reaches the host: the replay stores slot ids and the policy
  outputs carry slot and slotgen in place of the memory."""
  config = common.assemble_config(main.CONFIGS, SIZE)
  agent = main.make_agent(config)
  assert agent._latents is not None
  ext = agent.ext_space
  assert 'slot' in ext and 'memory' not in ext
  assert 'logp/action' in ext  # Behaviour logp stays replay data.
  obs = agent._example_obs(3)
  obs['is_first'][:] = True
  carry, _, out = agent.policy(agent.init_policy(3), obs)
  assert 'slot' in out and 'memory' not in out
  data = agent._example_batch(B, T + config.replay_context)
  data['slot'][:, :] = out['slot'][:B, None]
  data['slotgen'][:, :] = out['slotgen'][:B, None]
  data['is_first'][:, 0] = True
  _, _, mets = agent.train(agent.init_train(B), data)
  assert np.isfinite(mets['opt/loss'])
  assert mets['latents/valid'] == 1.0


def test_make_agent_asks_for_cuda_by_default(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  config = common.assemble_config(main.CONFIGS, SIZE + [
      '--torch.device', 'cuda'])
  with pytest.raises(RuntimeError, match='CUDA'):
    main.make_agent(config)
  assert main.make_agent(config, device='cpu').device.type == 'cpu'


def test_presets_and_overrides():
  config = common.assemble_config(main.CONFIGS, SIZE + ['--batch_size', '8'])
  assert config.agent.enc.impala.depth == 4  # the CLI over the preset
  assert config.agent.rnn.units == 8  # the debug preset
  assert config.batch_size == 8
  assert config.torch.device == 'cpu'
  default = common.assemble_config(main.CONFIGS, [])
  assert default.torch.device == 'cuda'
  assert default.agent.rnn.units == 1024


def test_train_save_and_resume(tmp_path):
  """main.main under --configs debug trains and saves; a second run on
  the logdir loads the checkpoint and continues its step counter."""
  args = ['--configs', 'debug', '--task', 'dummy_disc', '--logdir',
          str(tmp_path), '--batch_size', '4', '--batch_length', '8',
          '--report_length', '8', '--run.train_ratio', '4',
          '--run.log_every', '0.2', '--run.report_every', '0.5',
          '--run.save_every', '0.3']
  main.main(args + ['--run.steps', '64'])
  assert (tmp_path / 'checkpoint.pkl').exists()
  first = [json.loads(x) for x in open(tmp_path / 'metrics.jsonl')]
  assert any('train/opt/loss' in x for x in first), first[-1].keys()
  main.main(args + ['--run.steps', '128'])
  lines = [json.loads(x) for x in open(tmp_path / 'metrics.jsonl')]
  steps = [x['step'] for x in lines]
  assert max(steps) > 64 and len(lines) > len(first)
  losses = [x['train/opt/loss'] for x in lines if 'train/opt/loss' in x]
  assert losses and all(np.isfinite(losses))
