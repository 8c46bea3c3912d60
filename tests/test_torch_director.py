"""The port's Director against the JAX Director model, and its agent end
to end.

The JAX Model's store (`test_torch_slice.jax_store`) goes into the port
unchanged, and both run in float32 on one batch and one store. JAX and
torch draw different random numbers, so the JAX draws are recorded by the
test (`test_torch_slice`'s recorder: the JAX samplers patched to take
numpy noise, `nn.scan` patched to a Python loop so that each step draws
its own) and replayed to the port in the same order. On the CPU the JAX
model takes its XLA path and the port its plain versions through the
kernel wrappers (`kernel: auto`, at widths the kernels take) or its
layer-by-layer path (`kernel: off`).

Held against JAX: the world-model loss and its posterior features; the
goal VAE's loss; the hierarchy loss, the worker's and the manager's
losses and metrics from one rollout; the disagreement ensemble's loss and
reward and the hierarchy loss with that reward; with a continuous
action, the hierarchy loss's gradients, which run through the rollout.
`test_torch_director_train` holds one train step. Tolerances are
`test_torch_slice`'s: values 1e-4 relative and absolute, gradients 1e-3
relative per tensor in norm.
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
from embodied_tpu.models.director import model as jmodel
from embodied_tpu_torch import nn
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.director import main
from embodied_tpu_torch.models.dreamerv3 import rssm
from embodied_tpu_torch.parallel import convert
from test_torch_slice import (  # noqa: F401
    B, T, TOL, close, counting, grad_close, jax_f32, jax_recorded,
    jax_store, make_batch)

LR = 1e-4  # the largest of the four optimizers' (opt: 4e-5)
STEP_TOL = 1e-3
H = 4  # imag_length, two skills of skill_duration 2
SIZE = ['--task', 'dummy_disc', '--configs', 'debug',
        '--agent.rssm.deter', '64', '--agent.rssm.hidden', '32',
        '--agent.rssm.blocks', '4', '--agent.rssm.stoch', '4',
        '--agent.rssm.classes', '4', '--agent.enc.depth', '4',
        '--agent.enc.units', '16', '--agent.enc.layers', '2',
        '--batch_size', str(B), '--batch_length', str(T),
        '--agent.opt.warmup', '0', '--agent.goal_opt.warmup', '0',
        '--agent.ac_opt.warmup', '0', '--agent.expl_opt.warmup', '0',
        '--agent.imag_length', str(H), '--agent.skill_duration', '2']
EXPLORE = ['--agent.expl_behavior', 'explore', '--agent.expl_rew', 'disag']
CONT = [x if x != 'dummy_disc' else 'dummy_cont' for x in SIZE]
JAX_CONFIGS = pathlib.Path(jmodel.__file__).parent / 'configs.yaml'


def jax_model(args):
  config = jcommon.assemble_config(
      str(JAX_CONFIGS), args + ['--logdir', '/nonexistent'])
  obs_space, act_space = jcommon.env_spaces(config)
  return jmodel.Model(obs_space, act_space, jcommon.agent_config(config))


def port_agent(args, kernel='auto'):
  config = common.assemble_config(main.CONFIGS, args + [
      '--torch.compute_dtype', 'float32', '--agent.rssm.kernel', kernel,
      '--torch.fetch_depth', '0'])
  return main.make_agent(config, device='cpu')


def torch_data(data):
  return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def numpy(xs):
  return nn.core.tree_map(lambda x: x.detach().numpy(), xs)


STORES = {}


def setup(rec, args, seed, kernel='auto'):
  """The JAX model and its store for `args` (made once per module: the
  store depends on the batch's shapes only), the port's agent on that
  store, and a batch from `seed`."""
  agent = port_agent(args, kernel)
  data = make_batch(agent, seed)
  if tuple(args) not in STORES:
    jm = jax_model(args)
    STORES[tuple(args)] = (jm, *jax_store(jm, data, rec))
  jm, store, meta = STORES[tuple(args)]
  agent.load({'store': convert.from_jax(store)})
  return jm, agent, data, store, meta


def jax_call(store, meta, fn, *args):
  """fn(ctx, *args) on the store, under jit."""
  def call(*args):
    ctx = jnn.core.Ctx(dict(store), key=jax.random.PRNGKey(1), meta=meta)
    return fn(ctx, *args)
  return jax.jit(call)(*args)


@pytest.mark.parametrize('kernel', ['auto', 'off'])
def test_losses_match_jax(jax_recorded, kernel):
  """The world-model, goal VAE and hierarchy losses on the same store,
  window and noise; each later loss takes the JAX world model's posterior
  features, so that each is held on its own."""
  rec = jax_recorded
  jm, agent, data, store, meta = setup(rec, SIZE, 6, kernel)
  model = agent.model
  carry, obs, prevact, _ = model._resume_window(
      model.init_train(B), torch_data(data))
  rec.start(7)
  want, (want_carry, want_entries, repfeat) = jax_call(
      store, meta, jm.wm_loss, *numpy((carry, obs, prevact)))
  draws = rec.replay()
  got, (got_carry, got_entries, got_feat) = model.wm_loss(
      carry, obs, prevact, draws)
  assert draws.used_all()
  close(got, want, 'wm_loss')
  for key in ('deter', 'stoch', 'logit'):
    close(got_feat[key], repfeat[key], f'repfeat/{key}')
  close(got_carry['deter'], want_carry['deter'], 'carry')
  close(got_entries['stoch'], want_entries['stoch'], 'entries')

  feat = torch_data(repfeat)
  rec.start(8)
  want = jax_call(store, meta, jm.vae_loss, repfeat)
  draws = rec.replay()
  got, _ = model.vae_loss(feat, draws)
  assert draws.used_all()
  close(got, want, 'vae_loss')

  rec.start(9)
  want, want_mets = jax_call(store, meta, jm.hier_loss, repfeat,
                             numpy(obs))
  draws = rec.replay()
  got, got_mets = model.hier_loss(feat, obs, draws)
  assert draws.used_all()
  close(got, want, 'hier_loss')
  assert sorted(got_mets) == sorted(want_mets)
  for key in ('worker', 'manager'):
    assert {f'loss/{key}_actor', f'loss/{key}_critic'} <= set(got_mets)
  for key, value in want_mets.items():
    close(got_mets[key], value, key)


def test_disag_loss_and_reward_match_jax(jax_recorded):
  rec = jax_recorded
  args = SIZE + ['--agent.expl_rew', 'disag', '--agent.worker_rews.expl',
                 '1.0']
  jm, agent, data, store, meta = setup(rec, args, 10)
  model = agent.model
  _, obs, prevact, _ = model._resume_window(
      model.init_train(B), torch_data(data))
  rng = np.random.default_rng(11)
  repfeat = {
      'deter': np.tanh(rng.standard_normal((B, T, 64))).astype(np.float32),
      'stoch': np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, T, 4))]}
  feat = torch_data(repfeat)
  want = jax_call(store, meta, jm.disag_loss, repfeat, numpy(prevact))
  got, _ = model.disag_loss(feat, prevact)
  close(got, want, 'disag_loss')
  traj = model._observed_traj(feat, prevact)
  want = jax_call(store, meta, lambda ctx, traj: jm.disag.reward(ctx, traj),
                  numpy(traj))
  close(model.disag.reward(traj), want, 'disag reward')
  # The hierarchy loss with the ensemble's reward in the worker's expl.
  rec.start(12)
  want, want_mets = jax_call(store, meta, jm.hier_loss, repfeat,
                             numpy(obs))
  draws = rec.replay()
  got, got_mets = model.hier_loss(feat, obs, draws)
  assert draws.used_all()
  close(got, want, 'hier_loss')
  for key, value in want_mets.items():
    close(got_mets[key], value, key)


def test_continuous_rollout_gradient_matches_jax(jax_recorded):
  """With a continuous action the worker's sample carries its gradient
  through the dynamics, in JAX and in the port: the hierarchy loss's
  gradients over the actor-critics agree."""
  rec = jax_recorded
  jm, agent, data, store, meta = setup(rec, CONT, 17)
  model = agent.model
  assert model.rollout_grad
  rng = np.random.default_rng(18)
  repfeat = {
      'deter': np.tanh(rng.standard_normal((B, T, 64))).astype(np.float32),
      'stoch': np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, T, 4))]}
  _, obs, _, _ = model._resume_window(model.init_train(B), torch_data(data))
  params = {k: v for k, v in store.items()
            if meta.get(k) == 'param' and k.startswith(('worker/',
                                                         'manager/'))}

  def loss(params, repfeat, obs):
    ctx = jnn.core.Ctx({**store, **params}, key=jax.random.PRNGKey(1),
                       meta=meta)
    return jm.hier_loss(ctx, repfeat, obs)
  rec.start(19)
  (want, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
      params, repfeat, numpy(obs))
  draws = rec.replay()
  got, _ = model.hier_loss(torch_data(repfeat), obs, draws)
  assert draws.used_all()
  close(got, want, 'hier_loss')
  paths = nn.scope_params(model, model.AC)
  assert sorted(paths) == sorted(grads)
  values = torch.autograd.grad(got, list(paths.values()), allow_unused=True)
  for (path, param), value in zip(paths.items(), values):
    value = torch.zeros_like(param) if value is None else value
    grad_close(value, grads[path], path)


def test_store_carries_across(jax_recorded):
  rec = jax_recorded
  jm, agent, data, store, meta = setup(rec, SIZE + EXPLORE, 15)
  store = convert.from_jax(store)
  assert {'opt/rms_flat', 'goal_opt/step', 'ac_opt/mom_flat',
          'disag_opt/rms_flat', 'expl_ac_opt/step',
          'worker/slow_extr_ema/count', 'retnorm_goal/hi',
          'manager/actor/out/head_skill/logits/kernel',
          'disag/ens/kernel0', 'disag/ens/norm0', 'expl/critic_disag/mlp/'
          'linear0/kernel', 'goal_dec/out/pred/kernel'} <= set(store)
  assert store['disag/ens/kernel0'].shape[0] == 8  # one slice per member
  assert sorted(store) == sorted(nn.store(agent.model))
  assert not nn.load_store(agent.model, store)
  for path, value in nn.store(agent.model).items():
    np.testing.assert_array_equal(value.numpy(), store[path], err_msg=path)


def test_make_agent_asks_for_cuda_by_default(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  config = common.assemble_config(main.CONFIGS, [
      '--task', 'dummy_disc', '--configs', 'debug', '--torch.device',
      'cuda'])
  with pytest.raises(RuntimeError, match='CUDA'):
    main.make_agent(config)
  default = common.assemble_config(main.CONFIGS, [])
  assert default.torch.device == 'cuda'
  assert main.make_agent(config, device='cpu').device.type == 'cpu'


def test_hierarchy_carry_and_goal():
  """Six policy calls: the hierarchy's step counts them, skills are
  one-hot codes and goals live in deter space."""
  config = common.assemble_config(main.CONFIGS, [
      '--configs', 'debug', '--task', 'dummy_disc'])
  agent = main.make_agent(config)
  obs = agent._example_obs(3)
  carry = agent.init_policy(3)
  goals = []
  for step in range(6):
    obs['is_first'][:] = step == 0
    carry, act, out = agent.policy(carry, obs)
    goals.append(carry[1]['goal'].clone())
    assert act['action'].dtype == np.int32 and act['action'].shape == (3,)
    assert out['dyn/deter'].dtype == np.int8
  _, hier, _ = carry
  assert (hier['step'].numpy() == 6).all()
  assert hier['skill'].shape == (3, 2, 4)
  np.testing.assert_allclose(hier['skill'].sum(-1).numpy(), 1.0)
  assert hier['goal'].shape == (3, 8)
  # A skill lasts env_skill_duration (4) calls: the goal holds from the
  # first call to the fourth and changes at the fifth.
  assert all(torch.equal(goals[0], g) for g in goals[1:4])
  # A reset starts the hierarchy afresh.
  obs['is_first'][:] = [True, False, False]
  carry, _, _ = agent.policy(carry, obs)
  assert carry[1]['step'].tolist() == [1, 7, 7]


@pytest.mark.parametrize('behavior', ['explore', 'random'])
def test_explore_modes(behavior):
  config = common.assemble_config(main.CONFIGS, [
      '--configs', 'debug', '--task', 'dummy_disc',
      '--agent.expl_behavior', behavior])
  agent = main.make_agent(config)
  assert agent.model.policy_modes == ('explore',)
  obs = agent._example_obs(4)
  carry = agent.init_policy(4)
  seen = set()
  for mode in ('train', 'explore', 'eval', 'explore', 'explore'):
    carry, act, _ = agent.policy(carry, obs, mode=mode)
    assert act['action'].dtype == np.int32
    assert ((0 <= act['action']) & (act['action'] < 5)).all()
    seen.update(act['action'].tolist())
  assert len(seen) > 1, seen
  data = agent._example_batch(2, T + config.replay_context)
  data['is_first'][:, 0] = True
  _, _, mets = agent.train(agent.init_train(2), data)
  if behavior == 'explore':
    assert 'disag_opt/loss' in mets and 'expl_ac_opt/loss' in mets
  assert all(np.isfinite(v) for v in mets.values())


# Calls per train step and whether they carry a graph, at SIZE (the
# kernels' widths): the observe window once with its backward, and the
# core step once per rollout step without (per hierarchy step, and under
# the Explore behaviour once more per explore step).
DISPATCH = [
    ('auto', SIZE, {('observe_seq', True): 1, ('core_step', False): H}),
    ('auto', SIZE + EXPLORE,
     {('observe_seq', True): 1, ('core_step', False): 2 * H}),
    ('off', SIZE, {}),
]


@pytest.mark.parametrize('kernel,args,want', DISPATCH,
                         ids=['auto', 'auto-explore', 'off'])
def test_kernel_modes_dispatch(monkeypatch, kernel, args, want):
  """Which kernel wrapper Director's policy call and train step reach:
  where the JAX model reaches its kernels, and nowhere under
  kernel: off."""
  agent = port_agent(args, kernel)
  calls = []
  for module, name in ((rssm.observe, 'obs_step'),
                       (rssm.blockgru, 'core_step'),
                       (rssm.observe_seq, 'observe_seq'),
                       (rssm.imagine, 'imag_step'),
                       (rssm.imagine_seq, 'imagine_seq')):
    monkeypatch.setattr(module, name, counting(module, name, calls))
  obs = agent._example_obs(B)
  agent.policy(agent.init_policy(B), obs)
  got = {}
  for call in calls:
    got[call] = got.get(call, 0) + 1
  assert got == ({('obs_step', False): 1} if kernel == 'auto' else {})
  del calls[:]
  model = agent.model
  data = torch_data(make_batch(agent, 16))
  draws = nn.dists.Draws(torch.Generator().manual_seed(0), 'cpu')
  model.train_step(model.init_train(B), data, draws)
  got = {}
  for call in calls:
    got[call] = got.get(call, 0) + 1
  assert got == want


def test_train_save_and_resume(tmp_path):
  """main.main under --configs debug trains and saves every optimizer's
  slots; a second run on the logdir loads them and continues."""
  args = ['--configs', 'debug', '--task', 'dummy_disc', '--logdir',
          str(tmp_path), '--batch_size', '4', '--batch_length', '8',
          '--run.train_ratio', '4', '--run.log_every', '0.2',
          '--run.report_every', '1e9', '--run.save_every', '0.5']
  main.main(args + ['--run.steps', '48'])
  assert (tmp_path / 'checkpoint.pkl').exists()
  first = [json.loads(x) for x in open(tmp_path / 'metrics.jsonl')]
  main.main(args + ['--run.steps', '96'])
  lines = [json.loads(x) for x in open(tmp_path / 'metrics.jsonl')]
  assert max(x['step'] for x in lines) > 48 and len(lines) > len(first)
  for key in ('opt', 'goal_opt', 'ac_opt'):
    losses = [x[f'train/{key}/loss'] for x in lines
              if f'train/{key}/loss' in x]
    assert losses and all(np.isfinite(losses)), key
