"""Pieces of the port's train step against the JAX package: the
distributions, the decoder's losses, the normalizer, the actor-critic
objectives and one optimizer step, each on the same inputs (made with
numpy from a seed) or the same store, in float32. The slice as a whole is
in tests/test_torch_slice.py.

Tolerances, float32 (summation order only): values 1e-4 relative and
absolute (1e-3 for the image loss, a sum over 64 x 64 x 3 pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu.models.dreamerv3 import ac as jac
from embodied_tpu.models.dreamerv3 import rssm as jrssm
from embodied_tpu.nn import dists as jdists
from embodied_tpu.utils import Space as JSpace
from embodied_tpu_torch import nn
from embodied_tpu_torch.models.dreamerv3 import ac, rssm
from embodied_tpu_torch.nn import dists
from embodied_tpu_torch.ops import blockgru, observe
from embodied_tpu_torch.parallel import convert
from embodied_tpu_torch.utils import Space

TOL = 1e-4
B, T = 2, 4


@pytest.fixture
def jax_f32():
  previous = jnn.core.COMPUTE_DTYPE
  jnn.set_compute_dtype(jnp.float32)
  yield
  jnn.set_compute_dtype(previous)


def t(x):
  return torch.tensor(np.asarray(x, np.float32))


def close(got, want, name, tol=TOL):
  np.testing.assert_allclose(
      np.asarray(got.detach().float() if hasattr(got, 'detach') else got,
                 np.float32),
      np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=name)


def jax_apply(fn, store, *args, key=0):
  """Run a ctx function on a given store; returns (updates, output)."""
  return jnn.pure(fn)(store, jax.random.PRNGKey(key), *args)


# --- Distributions -----------------------------------------------------------


def test_twohot_binary_normal_match_jax():
  rng = np.random.default_rng(0)
  bins = dists.symexp_bins(9)
  np.testing.assert_array_equal(bins, jdists.symexp_bins(9))
  logits = 2 * rng.standard_normal((5, 3, 9)).astype(np.float32)
  target = 30 * rng.standard_normal((5, 3)).astype(np.float32)
  two = dists.TwoHot(t(logits), bins, nn.symlog, nn.symexp)
  jtwo = jdists.TwoHot(jnp.asarray(logits), bins, jnn.symlog, jnn.symexp)
  close(two.pred(), jtwo.pred(), 'twohot pred')
  close(two.loss(t(target)), jtwo.loss(jnp.asarray(target)), 'twohot loss')
  # Uniform logits predict exactly zero.
  assert dists.TwoHot(torch.zeros(9), bins).pred().item() == 0.0
  logit = 3 * rng.standard_normal((5, 3)).astype(np.float32)
  value = rng.integers(0, 2, (5, 3)).astype(bool)
  binary, jbinary = dists.Binary(t(logit)), jdists.Binary(jnp.asarray(logit))
  close(binary.logp(torch.tensor(value)), jbinary.logp(jnp.asarray(value)),
        'binary logp')
  close(binary.entropy(), jbinary.entropy(), 'binary entropy')
  close(binary.prob(torch.tensor(value)), jbinary.prob(jnp.asarray(value)),
        'binary prob')
  # The bounded normal as the policy head builds it, aggregated over the
  # action vector.
  mean, std = [rng.standard_normal((5, 6)).astype(np.float32)
               for _ in range(2)]
  std = 0.9 * (1 / (1 + np.exp(-(std + 2)))) + 0.1
  act = rng.standard_normal((5, 6)).astype(np.float32)
  normal = dists.Agg(dists.Normal(t(np.tanh(mean)), t(std)), 1)
  jnormal = jdists.Agg(jdists.Normal(jnp.tanh(mean), jnp.asarray(std)), 1,
                       jnp.sum)
  close(normal.logp(t(act)), jnormal.logp(jnp.asarray(act)), 'normal logp')
  close(normal.entropy(), jnormal.entropy(), 'normal entropy')
  mse = dists.Agg(dists.MSE(t(mean), nn.symlog), 1)
  jmse = jdists.Agg(jdists.MSE(jnp.asarray(mean), jnn.symlog), 1, jnp.sum)
  close(mse.loss(t(act * 9)), jmse.loss(jnp.asarray(act * 9)), 'symlog mse')


def test_onehot_straight_through_kl_and_entropy():
  rng = np.random.default_rng(1)
  logits = 2 * rng.standard_normal((4, 3, 5)).astype(np.float32)
  noise = rng.gumbel(size=logits.shape).astype(np.float32)
  x = t(logits).requires_grad_()
  one = dists.OneHot(x, 0.01)
  sample = one.sample(noise=t(noise))
  # Value: the one-hot; gradient: that of the blended probabilities.
  np.testing.assert_array_equal(sample.detach().sum(-1).numpy(), 1.0)
  weights = t(rng.standard_normal(logits.shape))
  (sample * weights).sum().backward()
  probs = torch.exp(dists.OneHot(t(logits), 0.01).logits)
  want = torch.autograd.functional.vjp(
      lambda z: torch.exp(dists.OneHot(z, 0.01).logits), t(logits),
      weights)[1]
  close(x.grad, want, 'straight-through gradient')
  assert probs.shape == logits.shape
  other = 2 * rng.standard_normal((4, 3, 5)).astype(np.float32)
  jone = jdists.Agg(jdists.OneHot(jnp.asarray(logits), 0.01), 1, jnp.sum)
  jother = jdists.Agg(jdists.OneHot(jnp.asarray(other), 0.01), 1, jnp.sum)
  agg = dists.Agg(dists.OneHot(t(logits), 0.01), 1)
  close(agg.kl(dists.Agg(dists.OneHot(t(other), 0.01), 1)), jone.kl(jother),
        'kl')
  close(agg.entropy(), jone.entropy(), 'entropy')


def test_frozen_and_concat_match_jax():
  """Frozen gives the inner values with no gradient; Concat slices its
  arguments at the midpoints along the axis and concatenates the parts'
  results, as the JAX wrappers do."""
  rng = np.random.default_rng(4)
  mean = rng.standard_normal((3, 7)).astype(np.float32)
  std = np.exp(0.3 * rng.standard_normal((3, 7))).astype(np.float32)
  value = rng.standard_normal((3, 7)).astype(np.float32)
  x = t(mean).requires_grad_()
  frozen = dists.Frozen(dists.Normal(x, t(std)))
  jfrozen = jdists.Frozen(jdists.Normal(jnp.asarray(mean), jnp.asarray(std)))
  for name in ('logp', 'loss'):
    got = getattr(frozen, name)(t(value))
    assert not got.requires_grad, name
    close(got, getattr(jfrozen, name)(jnp.asarray(value)), name)
  close(frozen.entropy(), jfrozen.entropy(), 'entropy')
  assert not frozen.mean.requires_grad
  assert dists.Normal(x, t(std)).logp(t(value)).requires_grad
  parts = [dists.MSE(t(mean[:, :2])), dists.Huber(t(mean[:, 2:5]), eps=0.5),
           dists.Normal(t(mean[:, 5:]), t(std[:, 5:]))]
  jparts = [jdists.MSE(jnp.asarray(mean[:, :2])),
            jdists.Huber(jnp.asarray(mean[:, 2:5]), eps=0.5),
            jdists.Normal(jnp.asarray(mean[:, 5:]), jnp.asarray(std[:, 5:]))]
  concat = dists.Concat(parts, [2, 5], 1)
  jconcat = jdists.Concat(jparts, [2, 5], 1)
  close(concat.pred(), jconcat.pred(), 'pred')
  close(concat.loss(t(value)), jconcat.loss(jnp.asarray(value)), 'loss')
  close(concat.loss(target=t(value)),
        jconcat.loss(target=jnp.asarray(value)), 'keyword loss')


def test_pointwise_losses_unchanged():
  """MSE and Huber on the Pointwise base: bit for bit the squared error and
  the Charbonnier penalty, the target squashed first."""
  rng = np.random.default_rng(5)
  mean, target = t(rng.standard_normal((4, 3))), t(rng.standard_normal(
      (4, 3)))
  assert isinstance(dists.Huber(mean), dists.Pointwise)
  assert torch.equal(dists.MSE(mean, squash=nn.symlog).loss(target),
                     torch.square(mean - nn.symlog(target)))
  assert torch.equal(dists.Huber(mean, eps=0.5).loss(target), torch.sqrt(
      torch.square(mean - target) + 0.25) - 0.5)


# --- Decoder -----------------------------------------------------------------


def test_decoder_losses_match_jax(jax_f32):
  rng = np.random.default_rng(2)
  spaces = dict(image=(np.uint8, (64, 64, 3)), vector=(np.float32, (7,)),
                token=(np.int32, (), 0, 5))
  kw = dict(units=16, depth=4, mults=(6, 8), layers=2, s2d=4, bspace=8,
            act='silu', norm='rms')
  deter, stoch, classes = 64, 4, 4
  feat = dict(deter=rng.standard_normal((B, T, deter)).astype(np.float32),
              stoch=np.eye(classes, dtype=np.float32)[
                  rng.integers(0, classes, (B, T, stoch))])
  obs = dict(image=rng.integers(0, 256, (B, T, 64, 64, 3)).astype(np.uint8),
             vector=rng.standard_normal((B, T, 7)).astype(np.float32),
             token=rng.integers(0, 5, (B, T)).astype(np.int32))
  reset = np.zeros((B, T), bool)
  jdec = jrssm.Decoder({k: JSpace(*v) for k, v in spaces.items()}, 'dec',
                       **kw)

  def fn(ctx, feat, obs):
    _, _, recons = jdec(ctx, {}, feat, reset, True)
    return {k: recons[k].loss(obs[k].astype(jnp.float32) / 255
                              if k == 'image' else obs[k]) for k in recons}
  store, meta = jnn.init(fn)(jax.random.PRNGKey(0), feat, obs)
  _, want = jnn.pure(fn, meta)(store, jax.random.PRNGKey(0), feat, obs)
  dec = rssm.Decoder({k: Space(*v) for k, v in spaces.items()}, 'dec',
                     feat_dims=(deter, stoch * classes),
                     cdtype=torch.float32, **kw)
  root = torch.nn.Module()
  root.add_module('dec', dec)
  assert not nn.load_store(root, convert.from_jax(store))
  _, _, recons = dec({}, {k: t(v) for k, v in feat.items()},
                     torch.tensor(reset), True)
  assert sorted(recons) == sorted(want)
  for key, dist in recons.items():
    value = torch.tensor(obs[key])
    target = value.float() / 255 if key == 'image' else value
    got = dist.loss(target)
    assert tuple(got.shape) == (B, T), (key, got.shape)
    close(got, want[key], key, tol=1e-3 if key == 'image' else TOL)


MODES = {
    'outer': dict(outer=True),
    'strided': dict(strided=True),
    'outer strided': dict(outer=True, strided=True),
    'bspace 0': dict(bspace=0),
    'strided bspace 0': dict(strided=True, bspace=0),
}


@pytest.mark.parametrize('mode', list(MODES))
def test_encoder_and_decoder_modes_match_jax(jax_f32, mode):
  """The Encoder's tokens and the Decoder's losses in the JAX modules'
  other modes, at s2d 0 and mults (2, 3, 4, 4) on 64 x 64 images: the
  strided stack (no pools, transposed deconvs), the outer stack (the first
  layer at full resolution, imgout a stride-1 conv) and both, and the
  decoder's `space` Linear of stoch and deter (bspace 0)."""
  kw = MODES[mode]
  rng = np.random.default_rng(3)
  spaces = dict(image=(np.uint8, (64, 64, 3)), vector=(np.float32, (7,)))
  common = dict(units=16, depth=4, mults=(2, 3, 4, 4), layers=1, s2d=0,
                act='silu', norm='rms', outer=kw.get('outer', False),
                strided=kw.get('strided', False))
  deter, stoch, classes = 64, 4, 4
  feat = dict(deter=rng.standard_normal((B, T, deter)).astype(np.float32),
              stoch=np.eye(classes, dtype=np.float32)[
                  rng.integers(0, classes, (B, T, stoch))])
  obs = dict(image=rng.integers(0, 256, (B, T, 64, 64, 3)).astype(np.uint8),
             vector=rng.standard_normal((B, T, 7)).astype(np.float32))
  reset = np.zeros((B, T), bool)
  jspaces = {k: JSpace(*v) for k, v in spaces.items()}
  jenc = jrssm.Encoder(jspaces, 'enc', **common)
  jdec = jrssm.Decoder(jspaces, 'dec', bspace=kw.get('bspace', 8), **common)

  def fn(ctx, feat, obs):
    _, _, tokens = jenc(ctx, {}, obs, reset, True)
    _, _, recons = jdec(ctx, {}, feat, reset, True)
    return tokens, {k: recons[k].loss(
        obs[k].astype(jnp.float32) / 255 if k == 'image' else obs[k])
        for k in recons}
  store, meta = jnn.init(fn)(jax.random.PRNGKey(0), feat, obs)
  _, (tokens, want) = jnn.pure(fn, meta)(
      store, jax.random.PRNGKey(0), feat, obs)
  pspaces = {k: Space(*v) for k, v in spaces.items()}
  enc = rssm.Encoder(pspaces, 'enc', cdtype=torch.float32, **common)
  dec = rssm.Decoder(pspaces, 'dec', feat_dims=(deter, stoch * classes),
                     bspace=kw.get('bspace', 8), cdtype=torch.float32,
                     **common)
  grid = 8 if common['outer'] else 4
  assert enc.token_dim == tokens.shape[-1] == 16 + grid * grid * 16
  assert dec.minres == [grid, grid]
  if 'bspace' in kw:
    assert store['dec/space/kernel'].shape == (
        stoch * classes + deter, grid * grid * 16)
  root = torch.nn.Module()
  root.add_module('enc', enc)
  root.add_module('dec', dec)
  assert not nn.load_store(root, convert.from_jax(store))
  tobs = {k: torch.tensor(v) for k, v in obs.items()}
  _, _, got = enc({}, tobs, torch.tensor(reset), True)
  close(got, tokens, 'tokens')
  _, _, recons = dec({}, {k: t(v) for k, v in feat.items()},
                     torch.tensor(reset), True)
  assert sorted(recons) == sorted(want)
  for key, dist in recons.items():
    target = tobs[key].float() / 255 if key == 'image' else tobs[key]
    close(dist.loss(target), want[key], key,
          tol=1e-3 if key == 'image' else TOL)


def test_depth_to_space_inverts_space_to_depth():
  x = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(2, 8, 8, 3)
  y = rssm.space_to_depth(x, 4)
  assert y.shape == (2, 2, 2, 48)
  np.testing.assert_array_equal(
      y.numpy(), np.asarray(jrssm.space_to_depth(jnp.asarray(x.numpy()), 4)))
  np.testing.assert_array_equal(rssm.depth_to_space(y, 4).numpy(), x.numpy())


# --- Normalizer and the actor-critic objectives ------------------------------

NORMS = dict(
    perc=dict(impl='perc', rate=0.01, limit=1.0, perclo=5.0, perchi=95.0,
              debias=False),
    perc_debias=dict(impl='perc', rate=0.1, limit=1.0, debias=True),
    meanstd=dict(impl='meanstd', rate=0.1, limit=1e-8, debias=True),
    none=dict(impl='none'))


def norm_store(name, cfg):
  names = dict(perc=('lo', 'hi'), meanstd=('mean', 'sqrs'), none=())
  keys = names[cfg['impl']] + (('corr',) if cfg.get('debias', True) and
                               cfg['impl'] != 'none' else ())
  return {f'{name}/{k}': jnp.zeros((), jnp.float32) for k in keys}


@pytest.mark.parametrize('kind', list(NORMS))
def test_normalize_matches_jax_after_updates(kind):
  cfg = NORMS[kind]
  xs = [np.random.default_rng(i).standard_normal((6, 5)).astype(np.float32)
        * (i + 1) + i for i in range(4)]

  def fn(ctx, xs):
    norm = jnn.Normalize(**cfg, name='retnorm')
    return [norm(ctx, x, True) for x in xs]
  updates, want = jax_apply(fn, norm_store('retnorm', cfg), xs)
  norm = nn.Normalize(**cfg, name='retnorm')
  for i, x in enumerate(xs):
    got = norm(t(x), True)
    for a, b in zip(got, want[i]):
      close(torch.as_tensor(a), b, f'{kind} stats after {i + 1} updates')
  for path, value in updates.items():
    close(getattr(norm, path.split('/')[1]), value, path)


def test_lambda_return_matches_jax():
  rng = np.random.default_rng(3)
  last = rng.random((4, 7)) < 0.2
  term = rng.random((4, 7)) < 0.2
  rew, val, boot = [rng.standard_normal((4, 7)).astype(np.float32)
                    for _ in range(3)]
  want = jac.lambda_return(last, term, rew, val, boot, 0.997, 0.95)
  got = ac.lambda_return(torch.tensor(last), torch.tensor(term), t(rew),
                         t(val), t(boot), 0.997, 0.95)
  close(got, want, 'lambda return')


def ac_inputs(seed, N=6, H=5, A=5, bins=9):
  rng = np.random.default_rng(seed)
  return dict(
      act=rng.integers(0, A, (N, H)).astype(np.int32),
      rew=rng.standard_normal((N, H)).astype(np.float32),
      con=rng.uniform(0.5, 1.0, (N, H)).astype(np.float32),
      pol=rng.standard_normal((N, H, A)).astype(np.float32),
      val=rng.standard_normal((N, H, bins)).astype(np.float32),
      slow=rng.standard_normal((N, H, bins)).astype(np.float32),
      last=rng.random((N, H)) < 0.2, term=rng.random((N, H)) < 0.2,
      boot=rng.standard_normal((N, H)).astype(np.float32))


def value_dists(lib, xs, bins):
  if lib is jdists:
    make = lambda z: jdists.TwoHot(jnp.asarray(z), bins, jnn.symlog,
                                   jnn.symexp)
  else:
    make = lambda z: dists.TwoHot(t(z), bins, nn.symlog, nn.symexp)
  return make(xs['val']), make(xs['slow'])


@pytest.mark.parametrize('valnorm', ['none', 'meanstd'])
def test_imag_and_repl_losses_match_jax(valnorm):
  xs = ac_inputs(4)
  bins = dists.symexp_bins(9)
  cfgs = dict(retnorm=NORMS['perc'], valnorm=NORMS[valnorm],
              advnorm=NORMS['none'])
  kw = dict(contdisc=True, horizon=333, slowtar=False, lam=0.95,
            actent=3e-4, slowreg=1.0)

  def fn(ctx, xs):
    norms = {k: jnn.Normalize(**v, name=k) for k, v in cfgs.items()}
    value, slow = value_dists(jdists, xs, bins)
    policy = {'action': jdists.Categorical(jnp.asarray(xs['pol']))}
    losses, out, mets = jac.imag_loss(
        ctx, {'action': jnp.asarray(xs['act'])}, jnp.asarray(xs['rew']),
        jnp.asarray(xs['con']), policy, value, slow, norms['retnorm'],
        norms['valnorm'], norms['advnorm'], update=True, **kw)
    rlosses, rout, _ = jac.repl_loss(
        ctx, jnp.asarray(xs['last']), jnp.asarray(xs['term']),
        jnp.asarray(xs['rew']), jnp.asarray(xs['boot']), value, slow,
        norms['valnorm'], update=True, horizon=333, lam=0.95, slowreg=1.0)
    return losses, out, mets, rlosses, rout
  store = {}
  for name, cfg in cfgs.items():
    store.update(norm_store(name, cfg))
  updates, (wl, wo, wm, wrl, wro) = jax_apply(fn, store, xs)

  norms = {k: nn.Normalize(**v, name=k) for k, v in cfgs.items()}
  value, slow = value_dists(dists, xs, bins)
  policy = {'action': dists.Categorical(t(xs['pol']))}
  losses, out, mets = ac.imag_loss(
      {'action': torch.tensor(xs['act'])}, t(xs['rew']), t(xs['con']),
      policy, value, slow, norms['retnorm'], norms['valnorm'],
      norms['advnorm'], update=True, **kw)
  rlosses, rout, _ = ac.repl_loss(
      torch.tensor(xs['last']), torch.tensor(xs['term']), t(xs['rew']),
      t(xs['boot']), value, slow, norms['valnorm'], update=True,
      horizon=333, lam=0.95, slowreg=1.0)
  for key in ('policy', 'value'):
    close(losses[key], wl[key], key)
  close(out['ret'], wo['ret'], 'imagined return')
  assert sorted(mets) == sorted(wm)
  for key in mets:
    close(torch.as_tensor(mets[key]), wm[key], key)
  close(rlosses['repval'], wrl['repval'], 'repval')
  close(rout['ret'], wro['ret'], 'replay return')
  for path, value in updates.items():
    name, stat = path.split('/')
    close(getattr(norms[name], stat), value, path)


# --- Optimizer ---------------------------------------------------------------

OPT = dict(lr=1e-2, agc=0.3, eps=1e-20, beta1=0.9, beta2=0.999,
           momentum=True, wd=0.1, wdregex=r'/kernel$', schedule='linear',
           warmup=2, anneal=6)


def optimizer_steps(fused):
  """Three updates of the port's Optimizer against the JAX one's on the
  same parameters and gradients (the gradients growing tenfold a step, so
  AGC clips the later ones): parameters, metrics and moments."""
  rng = np.random.default_rng(5)
  shapes = {'m/lin/kernel': (4, 3), 'm/lin/bias': (3,), 'm/norm/scale': (5,)}
  init = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
  grads = [{k: (rng.standard_normal(s) * 10 ** i).astype(np.float32)
            for k, s in shapes.items()} for i in range(3)]

  def fn(ctx, g):
    def lossfn(ctx):
      total = 0.0
      for path, shape in shapes.items():
        scope, *mid, name = path.split('/')
        sub = ctx(scope)
        for part in mid:
          sub = sub(part)
        total += (sub.param(name, shape, 0.0) * g[path]).sum()
      return total
    return jnn.Optimizer(['m'], 'opt', fused=fused, **OPT)(ctx, lossfn)
  store, meta = jnn.init(fn)(jax.random.PRNGKey(0), grads[0])
  store.update({k: jnp.asarray(v) for k, v in init.items()})

  params = {k: torch.nn.Parameter(t(v)) for k, v in init.items()}
  opt = nn.Optimizer(params, 'opt', fused=fused, **OPT)
  slots = {f'opt/{k}': v for k, v in nn.store(opt).items()}
  assert sorted(slots) == sorted(k for k in store if k.startswith('opt/'))
  for path, value in slots.items():
    assert tuple(value.shape) == store[path].shape, path
  for g in grads:
    updates, want = jnn.pure(fn, meta)(store, jax.random.PRNGKey(0), g)
    store = {**store, **updates}
    lossfn = lambda: (sum((params[k] * t(v)).sum() for k, v in g.items()),
                      None)
    got, _ = opt(lossfn)
    assert sorted(got) == sorted(want)
    for key in got:
      close(got[key], want[key], key)
    for path in shapes:
      close(params[path], store[path], path, tol=1e-6)
    for path, value in nn.store(opt).items():
      close(value, store[f'opt/{path}'], path, tol=1e-6)
    assert int(opt.step) == int(store['opt/step'])
  return opt


def test_optimizer_steps_match_jax():
  opt = optimizer_steps(fused=True)
  assert sorted(nn.store(opt)) == ['mom_flat', 'rms_flat', 'step']


def test_perparam_optimizer_steps_match_jax():
  """fused=False: each parameter's own slots, rms.<path> and mom.<path>
  in the store as JAX names them, updated as JAX updates them."""
  opt = optimizer_steps(fused=False)
  assert sorted(nn.store(opt)) == [
      'mom.m.lin.bias', 'mom.m.lin.kernel', 'mom.m.norm.scale',
      'rms.m.lin.bias', 'rms.m.lin.kernel', 'rms.m.norm.scale', 'step']
  assert opt.slot('rms', 'm/lin/kernel').shape == (4, 3)


@pytest.mark.parametrize('op', ['core_step', 'obs_step'])
def test_step_wrappers_carry_a_graph(op):
  """On the CPU, core_step and obs_step return outputs with a graph whose
  gradient (every input and weight) is autograd's of the plain version,
  and count no launch. D 16, H 8, S 8, A 8, g 2; the head K 8, L 8."""
  rng = np.random.default_rng(6)
  D, H, S, A, G, K, L = 16, 8, 8, 8, 2, 8, 8
  dg = D // G
  mat = lambda *shape: t(0.3 * rng.standard_normal(shape))
  norm = lambda n: t(1 + 0.1 * rng.standard_normal(n))
  params = [mat(D, H), mat(H), norm(H), mat(S, H), mat(H), norm(H),
            mat(G, dg, dg), mat(D), mat(2 * H + A, D), norm(D),
            mat(G, dg, 3 * dg), mat(3 * D)]
  ins = [mat(4, D), mat(4, S), mat(4, A)]
  if op == 'core_step':
    wrapper, plain = blockgru.core_step, blockgru.reference_step
  else:
    wrapper, plain = observe.obs_step, observe.reference_obs_step
    params += [mat(D + K, H), mat(H), norm(H), mat(H, L), mat(L)]
    ins.append(mat(4, K))
  n = len(ins)

  def grads(fn):
    leaves = [x.clone().requires_grad_() for x in ins + params]
    outs = fn(*leaves[:n], leaves[n:])
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(out.grad_fn is not None for out in outs)
    total = sum((out * torch.linspace(-1, 1, out.numel()).reshape(
        out.shape)).sum() for out in outs)
    return torch.autograd.grad(total, leaves)

  before = wrapper.launches
  got, want = grads(wrapper), grads(plain)
  assert wrapper.launches == before
  names = ('deter', 'stoch', 'act', 'tok')[:n] + observe.FIELDS
  for name, a, b in zip(names, got, want):
    torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
