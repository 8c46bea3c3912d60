"""The port's acting path end to end against the JAX DreamerV3 model.

The JAX Model is built at a small size on dummy_disc with `nn.init` /
`nn.pure` over init_policy + policy (no JAX Agent, which would also
compile the train step), its store is carried into the port, and both run
several steps in float32 compute, including an `is_first` reset. JAX and
torch draw different random numbers, so the port is teacher-forced: each
step it gets the stoch sample and action JAX drew the step before, and
its policy head reads JAX's stoch sample of the same step. Tolerance 1e-4
(float32, summation order only); the packed int8 deter may differ by 1.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu.models import common as jcommon
from embodied_tpu.models.dreamerv3 import model as jmodel
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.parallel import convert

B, T = 3, 6
SIZE = ['--task', 'dummy_disc', '--configs', 'debug',
        '--agent.dyn.rssm.deter', '64', '--agent.dyn.rssm.hidden', '32',
        '--agent.dyn.rssm.blocks', '4', '--agent.dyn.rssm.stoch', '4',
        '--agent.dyn.rssm.classes', '4', '--agent.enc.simple.depth', '4',
        '--agent.enc.simple.units', '16', '--agent.enc.simple.layers', '2',
        '--agent.policy.units', '16', '--agent.policy.layers', '2']
TOL = 1e-4
JAX_CONFIGS = (pathlib.Path(jmodel.__file__).parent / 'configs.yaml')


@pytest.fixture
def jax_f32():
  previous = jnn.core.COMPUTE_DTYPE
  jnn.set_compute_dtype(jnp.float32)
  yield
  jnn.set_compute_dtype(previous)


def jax_model():
  config = jcommon.assemble_config(
      str(JAX_CONFIGS), SIZE + ['--logdir', '/nonexistent'])
  obs_space, act_space = jcommon.env_spaces(config)
  return jmodel.Model(obs_space, act_space, jcommon.agent_config(config))


def port_agent(kernel='auto'):
  config = common.assemble_config(main.CONFIGS, SIZE + [
      '--torch.compute_dtype', 'float32', '--agent.dyn.rssm.kernel', kernel,
      '--torch.latent_slots', '0'])
  return main.make_agent(config, device='cpu')


def observations(envs, acts, force_first=()):
  rows = [env.step({'action': np.int32(a), 'reset': False})
          for env, a in zip(envs, acts)]
  obs = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
  for i in force_first:
    obs['is_first'][i] = True
  return obs


def jax_step(model):
  def fn(ctx, carry, obs):
    enc_carry, dyn_carry, _, prevact = carry
    reset = obs['is_first']
    kw = dict(training=False, single=True)
    _, enc_entry, tokens = model.enc(ctx, enc_carry, obs, reset, **kw)
    dyn_carry, dyn_entry, feat = model.dyn.observe(
        ctx, dyn_carry, tokens, prevact, reset, **kw)
    pol = model.pol(ctx, model._feat2tensor(feat), bdims=1)['action']
    act = {'action': pol.sample(ctx.rng())}
    return dict(
        tokens=tokens, feat=feat, pol=pol.logprobs, act=act,
        carry=(enc_carry, dyn_carry, {}, act),
        entries=model._entry_flat((enc_entry, dyn_entry, {})))
  return fn


def to_t(x):
  return torch.tensor(np.asarray(x))


def close(got, want, name, tol=TOL):
  np.testing.assert_allclose(
      got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol,
      err_msg=name)


@pytest.mark.parametrize('kernel', ['auto', 'off'])
def test_policy_matches_jax_teacher_forced(jax_f32, kernel):
  from embodied_tpu_torch.envs import Dummy
  jm = jax_model()
  envs = [common.wrap_env(Dummy('disc', length=4), None) for _ in range(B)]
  obs = observations(envs, [0] * B)
  key = jax.random.PRNGKey(1)

  def init(ctx, obs):
    carry = jm.init_policy(ctx, B)
    jm.policy(ctx, carry, obs)
  store, meta = jnn.init(init)(key, obs)
  agent = port_agent(kernel)
  agent.load({'store': convert.from_jax(store)}, regex=POLICY_STORE)
  model = agent.model
  step = jax.jit(jnn.pure(jax_step(jm), meta))

  jcarry = jnn.pure(lambda ctx: jm.init_policy(ctx, B), meta)(store, key)[1]
  deter = torch.zeros((B, model.dyn.deter))
  for t in range(T):
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    _, out = step(store, jax.random.fold_in(key, t), jcarry, jobs)
    # Port: its own deter, JAX's previous stoch sample and action.
    tobs = {k: to_t(v) for k, v in obs.items()}
    carry = ({}, {'deter': deter, 'stoch': to_t(jcarry[1]['stoch'])}, {},
             {'action': to_t(jcarry[3]['action'])})
    with torch.inference_mode():
      _, _, tokens = model.enc({}, tobs, tobs['is_first'], single=True)
      _, entry, feat = model.dyn.observe(
          carry[1], tokens, carry[3], tobs['is_first'])
      jstoch = to_t(out['feat']['stoch'])
      pol = model.pol(model._feat2tensor(dict(feat, stoch=jstoch)), bdims=1)
      close(tokens, out['tokens'], f'tokens, step {t}')
      close(feat['deter'], out['feat']['deter'], f'deter, step {t}')
      close(feat['logit'], out['feat']['logit'], f'logit, step {t}')
      close(pol['action'].logprobs, out['pol'], f'policy, step {t}')
      packed = model.dyn.entry_pack(dict(feat, stoch=jstoch))
      jdeter = np.asarray(out['entries']['dyn/deter'], np.int32)
      assert np.abs(packed['deter'].numpy() - jdeter).max() <= 1
      np.testing.assert_array_equal(
          packed['stoch'].numpy(), np.asarray(out['entries']['dyn/stoch']))
    deter = feat['deter']
    jcarry = out['carry']
    acts = np.asarray(out['act']['action'])
    obs = observations(envs, acts, force_first=(1,) if t == 2 else ())


def test_agent_policy_outputs(jax_f32):
  """Agent.policy against JAX Model.policy on the first step, where the
  carry is zero and the outputs do not depend on samples except through
  the stoch entry and the action."""
  from embodied_tpu_torch.envs import Dummy
  jm = jax_model()
  envs = [common.wrap_env(Dummy('disc'), None) for _ in range(B)]
  obs = observations(envs, [0] * B)
  key = jax.random.PRNGKey(2)

  def run(ctx, obs):
    carry = jm.init_policy(ctx, B)
    return jm.policy(ctx, carry, obs)
  store, meta = jnn.init(run)(key, obs)
  _, (jcarry, jact, jout) = jnn.pure(run, meta)(store, key, obs)
  agent = port_agent()
  agent.load({'store': convert.from_jax(store)}, regex=POLICY_STORE)
  carry, act, out = agent.policy(agent.init_policy(B), obs)
  assert sorted(out) == sorted(jout)
  assert set(act) == set(jact) and act['action'].dtype == np.int32
  assert ((act['action'] >= 0) & (act['action'] < 5)).all()
  for k in ('log/finite/tokens', 'log/finite/act/action'):
    assert out[k].all() and out[k].shape == (B,)
  assert out['dyn/deter'].dtype == np.int8
  assert np.abs(out['dyn/deter'].astype(int) -
                np.asarray(jout['dyn/deter'], int)).max() <= 1
  assert out['dyn/stoch'].dtype == np.uint8
  assert out['dyn/stoch'].shape == jout['dyn/stoch'].shape
  close(carry[1]['deter'], jcarry[1]['deter'], 'deter')


# The modules a JAX store made by policy calls holds: the acting path's.
POLICY_STORE = r'^(enc|dyn|pol)/'


@pytest.mark.parametrize('case', ['missing', 'regex', 'extra'])
def test_load_requires_every_entry_unless_a_regex_selects(case, capsys):
  """As the reference's Agent.load: a store that lacks an entry raises
  unless a regex selects the entries to load; a regex load leaves the
  entries it does not match as they were; an entry the model lacks is
  reported and ignored."""
  agent = port_agent()
  data = agent.save()
  other = port_agent()
  for value in other.model.parameters():
    torch.nn.init.zeros_(value.data)
  before = other.save()['store']
  store = dict(data['store'])
  if case == 'missing':
    dropped = sorted(store)[0]
    del store[dropped]
    with pytest.raises(KeyError, match=dropped):
      other.load({'store': store})
    return
  if case == 'regex':
    other.load({'store': store}, regex='^dyn/')
    for path, value in other.save()['store'].items():
      want = store[path] if path.startswith('dyn/') else before[path]
      np.testing.assert_array_equal(value, want, err_msg=path)
    return
  store['extra/entry'] = np.zeros(3, np.float32)
  other.load({'store': store})
  assert 'Ignoring 1 unexpected checkpoint entries' in capsys.readouterr().out
  for path, value in other.save()['store'].items():
    np.testing.assert_array_equal(value, data['store'][path], err_msg=path)


def test_save_load_roundtrip():
  agent = port_agent()
  data = agent.save()
  other = port_agent()
  for value in other.model.parameters():
    torch.nn.init.zeros_(value.data)
  other.load(data)
  for path, value in other.save()['store'].items():
    np.testing.assert_array_equal(value, data['store'][path])
