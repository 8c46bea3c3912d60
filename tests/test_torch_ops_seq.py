"""The port's observe window and imagination rollout against the JAX
package's Pallas kernels.

The same inputs and noise, made with numpy from a seed, go through the
JAX kernels (interpret mode on the CPU, as tests/test_ops_seq.py and
tests/test_ops_imagine_seq.py run them) and the port's plain versions,
which the port's wrappers take for CPU tensors. Shapes follow those
tests. Tolerances, float32: forward values 1e-4 (summation order only);
gradients 2e-3 absolute and relative, and 1e-3 relative per tensor in
norm, since the weight gradients sum over all T x B rows in another
order. The port's rollout takes its action width unpadded; JAX's pads it
to its AP lanes with zero weights and a -1e9 bias on padded classes.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu.ops import imagine_seq as jimagine
from embodied_tpu.ops import observe_seq as jobserve
from embodied_tpu_torch.ops import imagine_seq, observe_seq

T, B, D, G, H, S, C, A, K = 5, 4, 64, 2, 32, 4, 8, 32, 24
L = S * C
TOL = 1e-4
GRAD_TOL = 2e-3
GRAD_REL = 1e-3


def to_t(x):
  return torch.tensor(np.asarray(x, np.float32))


def close(got, want, name, tol=TOL):
  np.testing.assert_allclose(
      got.detach().float().numpy(), np.asarray(want, np.float32), rtol=tol,
      atol=tol, err_msg=name)


def grad_close(got, want, name):
  got = got.detach().float().numpy()
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL,
                             err_msg=name)
  rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
  assert rel < GRAD_REL, (name, rel)


def gumbel(rng, *shape):
  u = rng.uniform(1e-6, 1 - 1e-6, shape)
  return (-np.log(-np.log(u))).astype(np.float32)


# --- The observe window ------------------------------------------------------


def window_params(rng):
  dg = D // G
  shapes = dict(
      w0=(D, H), b0=(H,), s0=(H,), w1=(L, H), b1=(H,), s1=(H,),
      wblk=(G, dg, dg), bblk=(D,), win=(3 * H, D), sh=(D,),
      wg=(G, dg, 3 * dg), bg=(3 * D,),
      wo=(D + K, H), bo=(H,), so=(H,), wl=(H, L), bl=(L,))
  out = []
  for name in observe_seq.FIELDS:
    norm = name in ('s0', 's1', 'sh', 'so')
    value = (1.0 if norm else 0.0) + (1.0 if norm else 0.3) * (
        rng.standard_normal(shapes[name]))
    out.append(value.astype(np.float32))
  return out


def window_inputs(rng):
  deter0 = rng.standard_normal((B, D)).astype(np.float32)
  stoch0 = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, S))].reshape(
      B, L)
  act = rng.standard_normal((T, B, A)).astype(np.float32)
  tok = rng.standard_normal((T, B, K)).astype(np.float32)
  keep = np.ones((T, B), np.float32)
  keep[2, 1] = 0.0  # A reset inside the window.
  return deter0, stoch0, act, tok, keep


def jax_window(params, ins, gum):
  return jobserve.fused_observe_seq(
      *map(jnp.asarray, ins), jnp.asarray(gum), tuple(map(jnp.asarray, params)),
      g=G, S=S, C=C, interpret=True)


def test_window_fields_match():
  assert observe_seq.FIELDS == jobserve.FIELDS


def test_window_forward_matches_jax_kernel():
  rng = np.random.default_rng(0)
  params, ins = window_params(rng), window_inputs(rng)
  gum = gumbel(rng, T, B, L)
  jd, js, jl = jax_window(params, ins, gum)
  before = observe_seq.observe_seq.launches
  dseq, sseq, lseq = observe_seq.observe_seq(
      *map(to_t, ins), to_t(gum), list(map(to_t, params)), C)
  assert observe_seq.observe_seq.launches == before  # the plain version
  np.testing.assert_array_equal(sseq.numpy(), np.asarray(js))
  close(dseq, jd, 'deter')
  close(lseq, jl, 'logits')
  # The replay of JAX's one-hots is the same function.
  rd, rs, rl = observe_seq.reference_observe_seq(
      *map(to_t, ins), list(map(to_t, params)), C, hard=to_t(js))
  close(rd, jd, 'replayed deter')
  close(rl, jl, 'replayed logits')


def test_window_grads_match_jax_backward():
  rng = np.random.default_rng(1)
  params, ins = window_params(rng), window_inputs(rng)
  gum = gumbel(rng, T, B, L)
  jd, js, jl = jax_window(params, ins, gum)
  ups = [rng.standard_normal(x.shape).astype(np.float32)
         for x in (jd, js, jl)]
  deter0, stoch0, act, tok, keep = ins
  want = jobserve.fused_observe_seq_bwd(
      jnp.concatenate([jnp.asarray(deter0)[None], jd[:-1]]),
      jnp.concatenate([jnp.asarray(stoch0)[None], js[:-1]]),
      jnp.asarray(act), jnp.asarray(tok), jnp.asarray(keep),
      tuple(map(jnp.asarray, params)), *map(jnp.asarray, ups),
      g=G, S=S, C=C, interpret=True)
  # The port's gradient: autograd of its plain version through the
  # wrapper, which takes it for CPU tensors.
  leaves = [to_t(x).requires_grad_() for x in (deter0, stoch0, act, tok)]
  weights = [to_t(x).requires_grad_() for x in params]
  outs = observe_seq.observe_seq(*leaves, to_t(keep), to_t(gum), weights, C)
  np.testing.assert_array_equal(outs[1].detach().numpy(), np.asarray(js))
  torch.autograd.backward(outs, [to_t(u) for u in ups])
  for name, x, w in zip(('deter0', 'stoch0', 'act', 'tok'), leaves, want):
    grad_close(x.grad, w, name)
  for name, x, w in zip(observe_seq.FIELDS, weights, want[4]):
    grad_close(x.grad, w, name)
  # The backward wrapper on the CPU is the same autograd.
  got = observe_seq.observe_seq_bwd(
      *map(to_t, (deter0, stoch0)), outs[0].detach(), outs[1].detach(),
      *map(to_t, (act, tok, keep)), list(map(to_t, params)),
      *map(to_t, ups), C)
  for name, x, w in zip(('deter0', 'stoch0', 'act', 'tok'), got, want):
    grad_close(x, w, name)


# --- The imagination rollout -------------------------------------------------

NPOL, UNITS, AP = 2, 24, 16
MINSTD, MAXSTD = 0.1, 1.0


def rollout_params(rng, disc, ain):
  """JAX's padded parameters (AP action lanes) and the port's unpadded
  ones, from the same draws."""
  dg = D // G
  shapes = dict(
      w0=(D, H), b0=(H,), s0=(H,), w1=(L, H), b1=(H,), s1=(H,),
      wblk=(G, dg, dg), bblk=(D,), win=(3 * H, D), sh=(D,),
      wg=(G, dg, 3 * dg), bg=(3 * D,),
      wp0=(D, H), bp0=(H,), sp0=(H,), wp1=(H, H), bp1=(H,), sp1=(H,),
      wpl=(H, L), bpl=(L,), wa=(AP, H), ba=(H,), sa=(H,),
      wm0=(D + L, UNITS), bm0=(UNITS,), sm0=(UNITS,),
      wm1=(UNITS, UNITS), bm1=(UNITS,), sm1=(UNITS,),
      wh=(UNITS, AP), bh=(AP,), whm=(UNITS, AP), bhm=(AP,),
      whs=(UNITS, AP), bhs=(AP,))
  padded, plain = [], []
  for name in imagine_seq.fields(NPOL, disc):
    norm = name in ('s0', 's1', 'sh', 'sp0', 'sp1', 'sa', 'sm0', 'sm1')
    value = ((1.0 + 0.1 * rng.standard_normal(shapes[name])) if norm else
             0.3 * rng.standard_normal(shapes[name])).astype(np.float32)
    if name == 'wa':
      value[ain:] = 0.0
      plain.append(value[:ain])
    elif name in ('wh', 'whm', 'whs'):
      value[:, ain:] = 0.0
      plain.append(value[:, :ain])
    elif name in ('bh', 'bhm', 'bhs'):
      value[ain:] = -1e9 if name == 'bh' else 0.0
      plain.append(value[:ain])
    else:
      plain.append(value)
    padded.append(value)
  return padded, plain


def rollout_case(seed, disc, noise_scale=1.0):
  rng = np.random.default_rng(seed)
  ain = 5 if disc else 3
  padded, plain = rollout_params(rng, disc, ain)
  deter0 = rng.standard_normal((B, D)).astype(np.float32)
  stoch0 = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, S))].reshape(
      B, L)
  gum = gumbel(rng, T, B, L)
  noise = (gumbel(rng, T, B, AP) if disc else
           noise_scale * rng.standard_normal((T, B, AP)).astype(np.float32))
  return ain, padded, plain, deter0, stoch0, gum, noise


@pytest.mark.parametrize('disc', [True, False], ids=['categorical',
                                                     'bounded_normal'])
def test_rollout_forward_matches_jax_kernel(disc):
  ain, padded, plain, deter0, stoch0, gum, noise = rollout_case(2, disc)
  jd, js, jl, ja = jimagine.fused_imagine_seq(
      jnp.asarray(deter0), jnp.asarray(stoch0), jnp.asarray(gum),
      jnp.asarray(noise), tuple(map(jnp.asarray, padded)), g=G, S=S, C=C,
      npol=NPOL, disc=disc, minstd=MINSTD, maxstd=MAXSTD, interpret=True)
  before = imagine_seq.imagine_seq.launches
  dseq, sseq, lseq, aseq = imagine_seq.imagine_seq(
      to_t(deter0), to_t(stoch0), to_t(gum), to_t(noise[..., :ain]),
      list(map(to_t, plain)), NPOL, disc, C, 0.01, MINSTD, MAXSTD)
  assert imagine_seq.imagine_seq.launches == before  # the plain version
  assert aseq.shape == (T, B, ain)
  if disc:  # Padded classes never win.
    np.testing.assert_array_equal(np.asarray(ja)[..., ain:], 0.0)
  np.testing.assert_array_equal(sseq.numpy(), np.asarray(js))
  close(dseq, jd, 'deter')
  close(lseq, jl, 'logits')
  close(aseq, np.asarray(ja)[..., :ain], 'actions')


def jax_rollout_grads(padded, deter0, stoch0, gum, noise, disc, ups):
  """jax.grad through JAX's custom VJP, whose backward is autodiff of its
  reference replaying the kernel's samples."""
  fused = functools.partial(jimagine.fused_imagine_seq, interpret=True)

  def loss(d0, s0, pa):
    outs = jimagine.imagine_seq(d0, s0, jnp.asarray(gum), jnp.asarray(noise),
                                pa, G, S, C, NPOL, disc, MINSTD, MAXSTD)
    return sum(jnp.sum(o.astype(jnp.float32) * u) for o, u in zip(outs, ups))

  saved = jimagine.fused_imagine_seq
  jimagine.fused_imagine_seq = fused
  try:
    return jax.grad(loss, (0, 1, 2))(
        jnp.asarray(deter0), jnp.asarray(stoch0),
        tuple(map(jnp.asarray, padded)))
  finally:
    jimagine.fused_imagine_seq = saved


def port_rollout_grads(plain, deter0, stoch0, gum, noise, disc, ain, ups):
  """The port's backward: `_ImagineSeq.backward`, autograd of the plain
  version replaying the samples, run on the CPU from the forward's saved
  tensors (the plain draw stands in for the kernel's forward)."""
  params = list(map(to_t, plain))
  spec = (NPOL, disc, C, 0.01, MINSTD, MAXSTD, 1e-4)
  with torch.no_grad():
    outs = imagine_seq.reference_imagine_seq(
        to_t(deter0), to_t(stoch0), params, *spec, gumbel=to_t(gum),
        noise=to_t(noise[..., :ain]))
  ctx = types.SimpleNamespace(saved_tensors=(
      to_t(deter0), to_t(stoch0), to_t(gum), to_t(noise[..., :ain]),
      outs[1], outs[3], *params), spec=spec)
  grads = [to_t(u) for u in ups[:3]] + [to_t(ups[3][..., :ain])]
  got = imagine_seq._ImagineSeq.backward(ctx, *grads)
  return outs, got[0], got[1], got[5:]


def check_rollout_grads(seed, disc, noise_scale=1.0, patch_clip=None):
  ain, padded, plain, deter0, stoch0, gum, noise = rollout_case(
      seed, disc, noise_scale)
  rng = np.random.default_rng(seed + 100)
  ups = [rng.standard_normal(shape).astype(np.float32) for shape in (
      (T, B, D), (T, B, L), (T, B, L), (T, B, AP))]
  outs, dd0, ds0, dparams = port_rollout_grads(
      plain, deter0, stoch0, gum, noise, disc, ain, ups)
  want = jax_rollout_grads(padded, deter0, stoch0, gum, noise, disc, ups)
  return ain, outs, (dd0, ds0, dparams), want


def compare_rollout_grads(ain, got, want, disc):
  grad_close(got[0], want[0], 'deter0')
  grad_close(got[1], want[1], 'stoch0')
  for name, g, w in zip(imagine_seq.fields(NPOL, disc), got[2], want[2]):
    w = np.asarray(w)
    if name == 'wa':
      w = w[:ain]
    elif name in ('wh', 'whm', 'whs'):
      w = w[:, :ain]
    elif name in ('bh', 'bhm', 'bhs'):
      w = w[:ain]
    if g is None:
      np.testing.assert_array_equal(w, 0.0, err_msg=name)
    else:
      grad_close(g, w, name)


@pytest.mark.parametrize('disc', [True, False], ids=['categorical',
                                                     'bounded_normal'])
def test_rollout_backward_matches_jax(disc):
  # Small action noise keeps |a| <= 1, where the two clip forms agree.
  ain, outs, got, want = check_rollout_grads(3, disc, noise_scale=0.01)
  if not disc:
    assert outs[3].abs().max() <= 1.0
  compare_rollout_grads(ain, got, want, disc)


def stopgrad_policy_act(p, deter, stoch, noise, npol, disc, minstd, maxstd,
                        eps, original=jimagine._policy_act):
  """JAX's in-kernel policy with the clip of its XLA path (rssm.py's
  _action_feat): a / max(1, |a|) with the divisor's gradient stopped."""
  act, _ = original(p, deter, stoch, noise, npol, disc, minstd, maxstd, eps)
  if disc:
    return act, act.astype(deter.dtype)
  clipped = act / jax.lax.stop_gradient(jnp.maximum(1.0, jnp.abs(act)))
  return act, clipped.astype(deter.dtype)


def test_rollout_backward_clips_with_stopped_gradient(monkeypatch):
  """With |a| > 1 the JAX kernel's backward (a plain clip, its
  imagine_seq.py:106) and the XLA path's stop-gradient clip differ; the
  port takes the stop-gradient form."""
  ain, outs, got, plain_clip = check_rollout_grads(4, False, noise_scale=3.0)
  assert outs[3].abs().max() > 1.0
  monkeypatch.setattr(jimagine, '_policy_act', stopgrad_policy_act)
  _, _, _, want = check_rollout_grads(4, False, noise_scale=3.0)
  compare_rollout_grads(ain, got, want, False)
  # The policy weights' gradients show the difference between the forms.
  index = imagine_seq.fields(NPOL, False).index('wm0')
  assert not np.allclose(np.asarray(plain_clip[2][index]),
                         np.asarray(want[2][index]), rtol=GRAD_TOL,
                         atol=GRAD_TOL)


@pytest.mark.parametrize('disc', [True, False])
def test_rollout_work_counts_each_head_matrix_once(disc):
  # A categorical head has one (U, adim) matrix and f32 bias, a bounded
  # normal two (mean and stddev); the bound counts no more than that.
  steps, B, D, H, L, A, U, adim, npol, g = 3, 32, 64, 24, 48, 24, 32, 6, 2, 4
  dg = D // g
  nbytes, flops = imagine_seq.work(steps, B, D, H, L, A, U, adim, npol, g,
                                   disc)
  heads = 1 if disc else 2
  weights = (D * H + L * H + g * dg * dg + (2 * H + A) * D +
             g * dg * 3 * dg + D * H + H * H + H * L + adim * A +
             (D + L) * U + (npol - 1) * U * U + heads * U * adim)
  assert flops == 2 * steps * B * weights
  other, _ = imagine_seq.work(steps, B, D, H, L, A, U, adim, npol, g,
                              not disc)
  # The second head adds its bf16 matrix and its f32 bias, nothing else.
  assert abs(nbytes - other) == 2 * U * adim + 4 * adim


@pytest.mark.parametrize('disc', [True, False])
@pytest.mark.parametrize('dims', [
    # size12m and the default configuration: (D, H, L, A, U, adim, g)
    (2048, 256, 512, 256, 256, 5, 8),
    (8192, 1024, 2048, 1024, 1024, 5, 8)], ids=['size12m', 'default'])
def test_rollout_products_sum_to_its_work(dims, disc):
  # The products of one step, times the horizon, are the rollout's flops:
  # the stage rows of the smoke run and kernel 8's bound count one work.
  D, H, L, A, U, adim, g = dims
  steps, B, npol = 15, 1024, 3
  _, flops = imagine_seq.work(steps, B, D, H, L, A, U, adim, npol, g, disc)
  listed = imagine_seq.products(B, D, H, L, A, U, adim, npol, g, disc)
  assert sum(2 * r * k * n for r, k, n, _ in listed.values()) * steps == flops
  assert listed['gates'] == (B, D // g, 3 * D, g)
