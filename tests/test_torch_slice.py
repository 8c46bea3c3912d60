"""The port's train step end to end against the JAX DreamerV3 model.

The JAX Model's loss, its gradients and one `train` step, from the store
a JAX agent makes (`init_train` + `train` traced in create mode, values
from the recipes), against the port's Model on the same store and batch,
in float32. JAX and torch draw different random numbers, so the JAX draws
are made by the test (its Categorical and Normal samplers patched to take
numpy noise and record it) and replayed to the port in the same order.
On the CPU the JAX model takes its XLA path (its kernels need a TPU),
with `nn.scan` patched to a Python loop so that each step draws its own
noise; the port takes its plain versions through the kernel wrappers
(`kernel: auto`) or its step-by-step path (`kernel: off`). The JAX
package's files are not changed; the patches live in this process.

Tolerances, float32 (summation order only): values 1e-4 relative and
absolute; gradients 1e-3 relative per tensor in norm. The first update
is lr * sign(g) where |g| is large, so a parameter may differ by up to
2 lr where |g| is near zero and the two frameworks round it to opposite
signs; at least 99% of the entries agree within 1e-6.
"""

import pathlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu.models import common as jcommon
from embodied_tpu.models.dreamerv3 import model as jmodel
from embodied_tpu.nn import dists as jdists
from embodied_tpu_torch import nn
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.models.dreamerv3.model import OPT_SCOPES
from embodied_tpu_torch.parallel import convert

TOL = 1e-4
GRAD_REL = 1e-3
B, T = 2, 4
LR = 4e-5
SIZE = ['--task', 'dummy_disc', '--configs', 'debug',
        '--agent.dyn.rssm.deter', '64', '--agent.dyn.rssm.hidden', '32',
        '--agent.dyn.rssm.blocks', '4', '--agent.dyn.rssm.stoch', '4',
        '--agent.dyn.rssm.classes', '4', '--agent.enc.simple.depth', '4',
        '--agent.enc.simple.units', '16', '--agent.enc.simple.layers', '2',
        '--agent.policy.units', '16', '--agent.policy.layers', '2',
        '--batch_size', str(B), '--batch_length', str(T),
        '--agent.opt.warmup', '0', '--agent.opt.lr', str(LR)]
JAX_CONFIGS = pathlib.Path(jmodel.__file__).parent / 'configs.yaml'


@pytest.fixture
def jax_f32():
  previous = jnn.core.COMPUTE_DTYPE
  jnn.set_compute_dtype(jnp.float32)
  yield
  jnn.set_compute_dtype(previous)


def close(got, want, name, tol=TOL):
  np.testing.assert_allclose(
      np.asarray(got.detach().float() if hasattr(got, 'detach') else got,
                 np.float32),
      np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=name)


def grad_close(got, want, name):
  got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
  if np.linalg.norm(want) == 0:
    np.testing.assert_allclose(got, want, atol=1e-9, err_msg=name)
    return
  rel = np.linalg.norm(got - want) / np.linalg.norm(want)
  assert rel < GRAD_REL, (name, rel)


class Recorder:
  """Numpy noise for the JAX samplers, recorded in draw order per kind."""

  def __init__(self):
    self.start(0)

  def start(self, seed):
    self.rng = np.random.default_rng(seed)
    self.draws = {'gumbel': [], 'normal': []}

  def draw(self, kind, shape):
    if kind == 'gumbel':
      u = self.rng.uniform(1e-6, 1 - 1e-6, shape)
      value = -np.log(-np.log(u))
    else:
      value = self.rng.standard_normal(shape)
    value = value.astype(np.float32)
    self.draws[kind].append(value)
    return jnp.asarray(value)

  def replay(self):
    return ReplayDraws(self.draws)


class ReplayDraws:
  """The port's `dists.Draws` interface, serving recorded noise in order:
  a request of n numbers takes the next n of its kind."""

  def __init__(self, draws):
    self.flat = {k: np.concatenate([x.reshape(-1) for x in v]) if v else
                 np.zeros(0, np.float32) for k, v in draws.items()}
    self.pos = {k: 0 for k in draws}

  def _take(self, kind, shape):
    n = int(np.prod(shape))
    at = self.pos[kind]
    assert at + n <= len(self.flat[kind]), (kind, shape, at)
    self.pos[kind] = at + n
    return torch.tensor(self.flat[kind][at:at + n].reshape(shape))

  def gumbel(self, shape):
    return self._take('gumbel', shape)

  def normal(self, shape):
    return self._take('normal', shape)

  def used_all(self):
    return all(self.pos[k] == len(v) for k, v in self.flat.items())


def loop_scan(ctx, fn, carry, xs=(), length=None, axis=1, unroll=1):
  """nn.scan as a Python loop, so each step traces (and samples) anew."""
  leaves = jax.tree.leaves(xs)
  if length is None:
    length = leaves[0].shape[axis]
  index = lambda i: jax.tree.map(
      lambda x: jax.lax.index_in_dim(x, i, axis, keepdims=False), xs)
  if ctx.create:
    fn(ctx, carry, index(0))  # Creates params; outputs discarded.
  frozen = jnn.core.Ctx(ctx.store, False, ctx.key, ctx.scope, ctx.meta,
                        ctx.updates, ctx._counter, frozen=True)
  outs = []
  for i in range(length):
    carry, out = fn(frozen, carry, index(i))
    outs.append(out)
  return carry, jax.tree.map(lambda *x: jnp.stack(x, axis), *outs)


@pytest.fixture
def jax_recorded(jax_f32, monkeypatch):
  rec = Recorder()

  def categorical(self, key, shape=()):
    assert shape == ()
    return jnp.argmax(self.logprobs + rec.draw('gumbel', self.logprobs.shape),
                      -1)

  def normal(self, key, shape=()):
    assert shape == ()
    return self._mean + self._std * rec.draw('normal', self._mean.shape)
  monkeypatch.setattr(jdists.Categorical, 'sample', categorical)
  monkeypatch.setattr(jdists.Normal, 'sample', normal)
  monkeypatch.setattr(jnn, 'scan', loop_scan)
  monkeypatch.setattr(jdists.TwoHot, 'pred', paired_pred)
  return rec


def paired_pred(self):
  """TwoHot.pred's fold for symmetric bins (symexp_bins), sum (p_i - p_-i) b_i over the
  negative bins. Under jit XLA contracts the fold's p_i b_i + p_-i b_-i
  into a fused multiply-add, which keeps the rounding error of one product:
  with bins out to +-exp(20) in float32 that turns the exact zero of
  uniform probabilities into -4.78 (5 bins). The difference of the
  probabilities cancels before the multiply, as the fold does in eager JAX
  and in the port."""
  half = self.bins.shape[0] // 2
  probs = self.probs
  total = ((probs[..., :half] - probs[..., ::-1][..., :half]) *
           self.bins[:half]).sum(-1)
  return self._unsquash(total)


def jax_model(argv):
  config = jcommon.assemble_config(
      str(JAX_CONFIGS), argv + ['--logdir', '/nonexistent'])
  obs_space, act_space = jcommon.env_spaces(config)
  return jmodel.Model(obs_space, act_space, jcommon.agent_config(config))


def port_agent(argv, kernel='auto'):
  """The port's agent on the host path (the latents ride the batch, as
  the JAX Model takes them), one step's results per train call."""
  config = common.assemble_config(main.CONFIGS, argv + [
      '--torch.compute_dtype', 'float32', '--agent.dyn.rssm.kernel', kernel,
      '--torch.latent_slots', '0', '--torch.fetch_depth', '0'])
  return main.make_agent(config, device='cpu')


def make_batch(agent, seed):
  """A (B, T + 1) batch of every replay key: random observations, actions
  and stored latents; the first row starts fresh (consec 0, so it grafts
  the stored latents), the second continues the carry."""
  rng = np.random.default_rng(seed)
  data = agent._example_batch(B, T + 1)
  spaces = {**agent.obs_space, **agent.act_space, **agent.ext_space}
  for key, value in data.items():
    space = spaces[key]
    if key in ('is_first', 'is_last', 'is_terminal'):
      value[:] = rng.random(value.shape) < 0.2
    elif value.dtype == np.float32:
      value[:] = 3 * rng.standard_normal(value.shape)
    elif key == 'dyn/deter':
      value[:] = rng.integers(-127, 128, value.shape)
    elif key == 'dyn/stoch':
      value[:] = rng.integers(0, agent.model.dyn.classes, value.shape)
    elif key != 'consec':
      low = 0 if space.dtype == np.uint8 else int(np.min(space.low))
      high = (256 if space.dtype == np.uint8 else
              int(np.max(space.high)))
      value[:] = rng.integers(low, high, value.shape)
  data['is_first'][:, 0] = True
  data['consec'][1] = 1
  return data


def jax_store(jm, data, rec):
  """The JAX agent's initial store, as it makes it: one trace of
  init_train + train in create mode records each entry's recipe, and the
  values come from the recipes (parallel/agent.py _init_store)."""
  rec.start(99)
  cell = {}

  def trace(key, data):
    ctx = jnn.core.Ctx({}, create=True, key=key)
    jm.train(ctx, jm.init_train(ctx, B), data)
    cell.update(meta=dict(ctx.meta), recipes=dict(ctx.recipes))
    return {**ctx.store, **ctx.updates}
  key = jax.random.PRNGKey(0)
  jax.eval_shape(trace, key, data)
  recipes = cell['recipes']

  def fastinit(key):
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
  return jax.jit(fastinit)(key), cell['meta']


def jax_loss_and_grads(jm, store, meta, data, rec, seed):
  rec.start(seed)
  params = {k: v for k, v in store.items() if meta.get(k) == 'param'}

  def wrt(params):
    ctx = jnn.core.Ctx({**store, **params}, key=jax.random.PRNGKey(1),
                       meta=meta)
    carry, obs, prevact, _ = jm._resume_window(jm.init_train(ctx, B), data)
    total, (_, _, _, mets) = jm.loss(ctx, carry, obs, prevact, True)
    return total, mets
  (total, mets), grads = jax.jit(jax.value_and_grad(wrt, has_aux=True))(
      params)
  return total, mets, grads


def torch_data(data):
  return {k: torch.from_numpy(v.copy()) for k, v in data.items()}


# The RSSM's kernel modes, and flags for both models: auto (the window and
# rollout kernels), off (the plain path), fused (the per-step observe
# kernels), imag (the per-step imagination kernel) and a 2-layer posterior
# (the core-step kernel on the BPTT path).
MODES = [
    pytest.param('auto', [], id='auto'),
    pytest.param('off', [], id='off'),
    pytest.param('fused', [], id='fused'),
    pytest.param('imag', [], id='imag'),
    pytest.param('auto', ['--agent.dyn.rssm.obslayers', '2'],
                 id='obslayers2'),
]


@pytest.mark.parametrize('kernel,extra', MODES)
def test_slice_losses_and_grads_match_jax(jax_recorded, kernel, extra):
  rec = jax_recorded
  jm = jax_model(SIZE + extra)
  agent = port_agent(SIZE + extra, kernel)
  data = make_batch(agent, 6)
  store, meta = jax_store(jm, data, rec)
  total, mets, grads = jax_loss_and_grads(jm, store, meta, data, rec, 7)
  agent.load({'store': convert.from_jax(store)})
  model = agent.model
  tdata = torch_data(data)
  draws = rec.replay()
  carry, obs, prevact, _ = model._resume_window(model.init_train(B), tdata)
  got_total, (_, _, _, got) = model.loss(carry, obs, prevact, True, draws)
  assert draws.used_all()
  losses = sorted(k for k in mets if k.startswith('loss/'))
  assert losses == sorted(k for k in got if k.startswith('loss/'))
  for key in losses:
    close(got[key], mets[key], key)
  close(got_total, total, 'total loss')
  params = {f'{s}/{p.replace(".", "/")}': v for s in OPT_SCOPES
            for p, v in getattr(model, s).named_parameters()}
  assert sorted(params) == sorted(grads)
  values = torch.autograd.grad(got_total, list(params.values()),
                               allow_unused=True)
  for (path, param), value in zip(params.items(), values):
    value = torch.zeros_like(param) if value is None else value
    grad_close(value, grads[path], path)


def test_slice_train_step_matches_jax(jax_recorded):
  train_step_against_jax(jax_recorded, SIZE)


# The Encoder and Decoder's other modes at s2d 0 and mults (2, 3, 4, 4):
# the strided stack with the decoder's `space` Linear (bspace 0), and the
# outer (pooled) stack with the block-space projection.
def enc_dec(*flags):
  return [arg for part in ('enc', 'dec') for flag in flags + (
      ('s2d', '0'), ('mults', '[2,3,4,4]')) for arg in (
          f'--agent.{part}.simple.{flag[0]}', flag[1])]


ENCODER_MODES = {
    'strided bspace 0': enc_dec(('strided', 'True')) + [
        '--agent.dec.simple.bspace', '0'],
    'outer': enc_dec(('outer', 'True')),
}


@pytest.mark.parametrize('mode', list(ENCODER_MODES))
def test_encoder_modes_train_step_matches_jax(jax_recorded, mode):
  train_step_against_jax(jax_recorded, SIZE + ENCODER_MODES[mode])


def train_step_against_jax(rec, argv):
  """One train step of the JAX Model and of the port's from one store,
  batch and noise: metrics, the store after the step and the replay
  entries."""
  jm = jax_model(argv)
  agent = port_agent(argv)
  data = make_batch(agent, 8)
  store, meta = jax_store(jm, data, rec)
  rec.start(9)
  train = lambda ctx, data: jm.train(ctx, jm.init_train(ctx, B), data)
  updates, (_, outs, mets) = jax.jit(jnn.pure(train, meta))(
      store, jax.random.PRNGKey(2), data)
  after = {**store, **updates}
  agent.load({'store': convert.from_jax(store)})
  draws = rec.replay()
  _, got_outs, got = agent.model.train_step(
      agent.model.init_train(B), torch_data(data), draws)
  assert draws.used_all()
  assert sorted(got) == sorted(mets)
  for key in got:
    if not key.startswith('opt/update'):
      close(torch.as_tensor(got[key]), mets[key], key)
  now = {k: v.detach().numpy() for k, v in nn.store(agent.model).items()}
  assert sorted(now) == sorted(after)
  for path, want in after.items():
    want, value = np.asarray(want, np.float32), now[path].astype(np.float32)
    if meta.get(path) == 'param' and not path.startswith('slowval/'):
      # lr * sign(g): up to 2 lr apart where |g| is near zero.
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
  replay = {k: v.numpy() for k, v in got_outs['replay'].items()}
  assert sorted(replay) == sorted(outs['replay'])
  for key, value in replay.items():
    want = np.asarray(outs['replay'][key])
    assert value.shape == want.shape == want.shape[:2] + value.shape[2:]
    assert value.shape[:2] == (B, T), (key, value.shape)
    assert np.abs(value.astype(int) - want.astype(int)).max() <= (
        1 if key == 'dyn/deter' else 0), key


def test_agent_trains_saves_and_loads(jax_recorded):
  rec = jax_recorded
  agent = port_agent(SIZE)
  data = make_batch(agent, 10)
  carry = agent.init_train(B)
  for _ in range(2):
    carry, outs, mets = agent.train(carry, data)
    assert all(isinstance(v, float) and np.isfinite(v)
               for v in mets.values()), mets
    for key, value in outs['replay'].items():
      assert value.shape[:2] == (B, T), (key, value.shape)
  assert float(agent.model.opt.step) == 2
  assert np.abs(agent.model.opt.rms_flat.numpy()).sum() > 0
  saved = agent.save()
  other = port_agent(SIZE)
  other.load(saved)
  assert other._counters == agent._counters
  for path, value in other.save()['store'].items():
    np.testing.assert_array_equal(value, saved['store'][path], err_msg=path)
  # A JAX agent's store, optimizer slots and state included, carries over
  # with nothing missing and nothing ignored.
  jm = jax_model(SIZE)
  store, _ = jax_store(jm, data, rec)
  store = convert.from_jax(store)
  assert {'opt/step', 'opt/rms_flat', 'opt/mom_flat', 'retnorm/lo',
          'slowval_ema/count'} <= set(store)
  assert sorted(store) == sorted(nn.store(agent.model))
  assert not nn.load_store(agent.model, store)
  for path, value in nn.store(agent.model).items():
    np.testing.assert_array_equal(value.numpy(), store[path], err_msg=path)


def counting(module, name, calls):
  """A stand-in for module.name that records, per call, whether autograd
  will need its gradient."""
  fn = getattr(module, name)

  def wrapper(*args, **kw):
    flat = [y for x in args
            for y in (x if isinstance(x, (list, tuple)) else [x])]
    calls.append((name, torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in flat)))
    return fn(*args, **kw)
  return wrapper


# Calls per loss of a (B, T) window and an imag_length-step rollout, and
# how many of them carry a graph: (name, with gradient) -> count. The
# rollout's features are detached afterwards, so it keeps no graph.
H_IMAG = 5  # the debug preset's imag_length


@pytest.mark.parametrize('kernel,extra,want', [
    ('auto', [], {('observe_seq', True): 1, ('imagine_seq', False): 1}),
    ('fused', [], {('obs_step', True): T, ('core_step', False): H_IMAG}),
    ('imag', [], {('observe_seq', True): 1, ('imag_step', False): H_IMAG}),
    ('auto', ['--agent.dyn.rssm.obslayers', '2'],
     {('core_step', True): T, ('imagine_seq', False): 1}),
    ('off', [], {}),
], ids=['auto', 'fused', 'imag', 'obslayers2', 'off'])
def test_kernel_modes_dispatch(monkeypatch, kernel, extra, want):
  """Which kernel wrapper each mode's train loss calls, how often, and
  with a graph where the BPTT path needs one."""
  from embodied_tpu_torch.models.dreamerv3 import rssm
  agent = port_agent(SIZE + extra, kernel)
  calls = []
  for module, name in ((rssm.observe, 'obs_step'),
                       (rssm.blockgru, 'core_step'),
                       (rssm.observe_seq, 'observe_seq'),
                       (rssm.imagine, 'imag_step'),
                       (rssm.imagine_seq, 'imagine_seq')):
    monkeypatch.setattr(module, name, counting(module, name, calls))
  model = agent.model
  data = torch_data(make_batch(agent, 11))
  carry, obs, prevact, _ = model._resume_window(model.init_train(B), data)
  draws = nn.dists.Draws(torch.Generator().manual_seed(0), 'cpu')
  total, _ = model.loss(carry, obs, prevact, True, draws)
  got = {}
  for call in calls:
    got[call] = got.get(call, 0) + 1
  assert got == want
  total.backward()


def test_report_matches_jax(jax_recorded):
  """Model.report against the JAX model's: the loss metrics without
  updates, the gradient norm per loss key (JAX's gradient of each key's
  loss on the same store, batch and noise) and the open-loop video, uint8
  within 1."""
  rec = jax_recorded
  jm = jax_model(SIZE)
  agent = port_agent(SIZE + ['--agent.report_gradnorms', 'True'])
  data = make_batch(agent, 12)
  store, meta = jax_store(jm, data, rec)
  rec.start(13)
  report = lambda ctx, data: jm.report(ctx, jm.init_report(ctx, B), data)
  _, (_, want) = jax.jit(jnn.pure(report, meta))(
      store, jax.random.PRNGKey(3), data)
  draws = rec.replay()
  # Each loss key's gradient norm in JAX, from the loss on the same noise.
  params = {k: v for k, v in store.items() if meta.get(k) == 'param'}

  def losses(params):
    rec.start(13)
    ctx = jnn.core.Ctx({**store, **params}, key=jax.random.PRNGKey(3),
                       meta=meta)
    carry, obs, prevact, _ = jm._resume_window(jm.init_report(ctx, B), data)
    _, (_, _, outs, _) = jm.loss(ctx, carry, obs, prevact, False)
    return {k: v.astype(jnp.float32).mean()
            for k, v in outs['losses'].items()}

  @jax.jit
  def gradnorms(params):
    # One forward, then one backward per key (a one-hot cotangent).
    values, vjp = jax.vjp(losses, params)
    norms = {}
    for key in values:
      (grads,) = vjp({k: jnp.float32(k == key) for k in values})
      norms[f'gradnorm/{key}'] = jnp.sqrt(sum(
          jnp.square(g.astype(jnp.float32)).sum() for g in grads.values()))
    return norms
  norms = {k: float(v) for k, v in gradnorms(params).items()}
  agent.load({'store': convert.from_jax(store)})
  model = agent.model
  carry, got = model.report(model.init_report(B), torch_data(data), draws)
  assert draws.used_all()
  assert sorted(got) == sorted(list(want) + list(norms))
  for key, value in want.items():
    if key.startswith('openloop/'):
      value, mine = np.asarray(value), got[key].numpy()
      assert mine.dtype == value.dtype == np.uint8, key
      assert mine.shape == value.shape, (mine.shape, value.shape)
      assert np.abs(mine.astype(int) - value.astype(int)).max() <= 1, key
    else:
      close(torch.as_tensor(got[key]), value, key)
  for key, value in norms.items():
    grad_close(torch.as_tensor(got[key]).reshape(1),
               np.asarray([value], np.float32), key)
  assert carry[-1]['action'].shape == (B,)


def test_agent_report_gives_host_values():
  agent = port_agent(SIZE)
  data = make_batch(agent, 14)
  carry = agent.init_report(B)
  for _ in range(2):
    carry, mets = agent.report(carry, data)
  assert agent._counters['report'] == 2
  video = mets['openloop/image']
  assert isinstance(video, np.ndarray) and video.dtype == np.uint8
  # (T, H + 4, B (W + 4), C): the truth, prediction and error panels stacked
  # along the height of each of the B sequences.
  assert video.shape == (T, 3 * 64 + 4, B * (64 + 4), 3), video.shape
  scalars = {k: v for k, v in mets.items() if k != 'openloop/image'}
  assert all(isinstance(v, float) and np.isfinite(v)
             for v in scalars.values()), scalars
  batch = next(iter(agent.stream(iter([data]))))
  assert sorted(batch) == sorted(data)
  for key, value in batch.items():
    np.testing.assert_array_equal(value.numpy(), data[key], err_msg=key)
  assert float(agent.model.opt.step) == 0  # nothing updated


def test_imagine_takes_an_action_sequence():
  """RSSM.imagine replays a dict of action sequences step by step."""
  agent = port_agent(SIZE)
  dyn = agent.model.dyn
  draws = nn.dists.Draws(torch.Generator().manual_seed(1), 'cpu')
  acts = {'action': torch.tensor([[1, 2, 3], [4, 0, 1]], dtype=torch.int32)}
  carry = dyn.initial(B)
  _, feat, action = dyn.imagine(carry, acts, 3, draws=draws)
  assert torch.equal(action['action'], acts['action'])
  assert feat['deter'].shape == (B, 3, dyn.deter)
  # One step at a time gives the same rollout from the same noise.
  draws = nn.dists.Draws(torch.Generator().manual_seed(1), 'cpu')
  for t in range(3):
    carry, (step, _) = dyn.imagine_single(
        carry, {'action': acts['action'][:, t]}, draws)
    torch.testing.assert_close(step['deter'], feat['deter'][:, t])
    torch.testing.assert_close(step['stoch'], feat['stoch'][:, t])
