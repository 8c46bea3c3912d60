"""The port's per-step backward and imagination-step ops against the JAX
package's kernels, and the autograd plumbing around the port's kernels.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernels fused_core_bwd, fused_obs_bwd and fused_imag_step (interpret mode
on the CPU) and the port's plain versions. Shapes follow
tests/test_torch_ops.py: D=64, H=24, S=16, g=4, K=32, L=48; B=192 spans
two of the JAX kernels' 128-row grid chunks (chunks of 96). Tolerance,
float32: every gradient and output within rtol 1e-4 and atol 1e-5
(summation order only); the samples equal.

The autograd Functions that wrap the CUDA kernels (forward kernel, and the
backward kernel or the plain replay as the gradient) run here with the
kernels' plain versions in their place, so that their saved tensors,
gradient order and None handling are held against autograd of the plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu.ops import blockgru as jblockgru
from embodied_tpu.ops import imagine as jimagine
from embodied_tpu.ops import observe as jobserve
from embodied_tpu_torch.ops import blockgru, imagine, observe

D, H, S, G, K, L = 64, 24, 16, 4, 32, 48
C = 4
RTOL, ATOL = 1e-4, 1e-5


def make_params(rng, head=False, prior=False, Sw=S):
  dg = D // G
  mat = lambda *shape: 0.1 * rng.standard_normal(shape)
  vec = lambda n: 0.01 + 0.01 * rng.standard_normal(n)
  norm = lambda n: 1 + 0.1 * rng.standard_normal(n)
  params = [mat(D, H), vec(H), norm(H), mat(Sw, H), vec(H), norm(H),
            mat(G, dg, dg), vec(D), mat(3 * H, D), norm(D),
            mat(G, dg, 3 * dg), vec(3 * D)]
  if head:
    params += [mat(D + K, H), vec(H), norm(H), mat(H, L), vec(L)]
  if prior:
    params += [mat(D, H), vec(H), norm(H), mat(H, H), vec(H), norm(H),
               mat(H, L), vec(L)]
  return [p.astype(np.float32) for p in params]


def inputs(rng, B, Sw=S):
  return [rng.standard_normal(shape).astype(np.float32)
          for shape in ((B, D), (B, Sw), (B, H), (B, K))]


def t(xs):
  return [torch.tensor(x) for x in xs]


def j(xs):
  return [jnp.asarray(x) for x in xs]


def close(got, want, name):
  np.testing.assert_allclose(
      np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                 np.float32),
      np.asarray(want, np.float32), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize('B', [8, 192])
def test_core_step_bwd_matches_jax(B):
  rng = np.random.default_rng(0)
  params = make_params(rng)
  ins = inputs(rng, B)[:3]
  dout = rng.standard_normal((B, D)).astype(np.float32)
  want = jblockgru.fused_core_bwd(*j(ins), tuple(j(params)), jnp.asarray(dout),
                                  interpret=True)
  got = blockgru.core_step_bwd(*t(ins), t(params), torch.tensor(dout))
  names = ('deter', 'stoch', 'act') + blockgru.FIELDS
  for name, a, b in zip(names, [*got[:3], *got[3]], [*want[:3], *want[3]]):
    close(a, b, name)


@pytest.mark.parametrize('B', [8, 192])
def test_obs_step_bwd_matches_jax(B):
  rng = np.random.default_rng(1)
  params = make_params(rng, head=True)
  ins = inputs(rng, B)
  dout = rng.standard_normal((B, D)).astype(np.float32)
  dlogit = rng.standard_normal((B, L)).astype(np.float32)
  want = jobserve.fused_obs_bwd(
      *j(ins), tuple(j(params)), jnp.asarray(dout), jnp.asarray(dlogit),
      interpret=True)
  got = observe.obs_step_bwd(*t(ins), t(params), torch.tensor(dout),
                             torch.tensor(dlogit))
  names = ('deter', 'stoch', 'act', 'tok') + observe.FIELDS
  for name, a, b in zip(names, [*got[:4], *got[4]], [*want[:4], *want[4]]):
    close(a, b, name)


def imag_case(rng, B):
  params = make_params(rng, prior=True, Sw=L)
  deter, _, act, _ = inputs(rng, B, Sw=L)
  stoch = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, L // C))]
  stoch = stoch.reshape(B, L)
  gum = -np.log(-np.log(rng.uniform(1e-6, 1 - 1e-6, (B, L))))
  return params, deter, stoch, act, gum.astype(np.float32)


@pytest.mark.parametrize('B', [8, 192])
def test_imag_step_matches_jax(B):
  rng = np.random.default_rng(2)
  params, deter, stoch, act, gum = imag_case(rng, B)
  want = jimagine.fused_imag_step(
      *j([deter, stoch, act, gum]), tuple(j(params)), g=G, S=L // C, C=C,
      interpret=True)
  got = imagine.imag_step(*t([deter, stoch, act, gum]), t(params), C)
  close(got[0], want[0], 'deter')
  np.testing.assert_array_equal(got[1].detach().numpy(), np.asarray(want[1]))
  close(got[2], want[2], 'logit')
  ref = jimagine.reference_imag_step(*j([deter, stoch, act, gum]),
                                     tuple(j(params)), C)
  for a, b, name in zip(got, ref, ('deter', 'sample', 'logit')):
    close(a, b, f'{name} vs reference_imag_step')
  # Replaying the sample gives the same outputs.
  again = imagine.reference_imag_step(*t([deter, stoch, act]), None,
                                      t(params), C, hard=got[1])
  for a, b in zip(again, got):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def grads_of(fn, ins, weights):
  """Gradients of sum(weights_i * output_i) with respect to `ins`."""
  ins = [x.detach().clone().requires_grad_() for x in ins]
  outs = fn(*ins)
  outs = outs if isinstance(outs, tuple) else (outs,)
  total = sum((o * w).sum() for o, w in zip(outs, weights))
  return outs, torch.autograd.grad(total, ins)


def test_kernel_autograd_functions_match_plain_autograd(monkeypatch):
  """The CUDA wrappers' autograd Functions, with the kernels' plain
  versions in their place: the forward keeps its inputs and the backward
  returns the gradients of autograd of the plain version, in input
  order."""
  rng = np.random.default_rng(3)
  params = t(make_params(rng, head=True))
  core = params[:len(blockgru.FIELDS)]
  ins = t(inputs(rng, 8))
  monkeypatch.setattr(blockgru, 'launch', blockgru.reference_step)
  monkeypatch.setattr(observe, 'launch', observe.reference_obs_step)
  w_out = torch.randn(8, D, generator=torch.Generator().manual_seed(0))
  w_logit = torch.randn(8, L, generator=torch.Generator().manual_seed(1))

  got = grads_of(lambda *x: blockgru._CoreStep.apply(*x[:3], 1e-4, *x[3:]),
                 ins[:3] + core, [w_out])
  want = grads_of(lambda *x: blockgru.reference_step(*x[:3], x[3:]),
                  ins[:3] + core, [w_out])
  torch.testing.assert_close(got[0][0], want[0][0])
  for name, a, b in zip(('deter', 'stoch', 'act') + blockgru.FIELDS,
                        got[1], want[1]):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)

  got = grads_of(lambda *x: observe._ObsStep.apply(*x[:4], 1e-4, *x[4:]),
                 ins + params, [w_out, w_logit])
  want = grads_of(lambda *x: observe.reference_obs_step(*x[:4], x[4:]),
                  ins + params, [w_out, w_logit])
  for name, a, b in zip(('deter', 'stoch', 'act', 'tok') + observe.FIELDS,
                        got[1], want[1]):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
  # An output that does not reach the loss gets a zero upstream gradient.
  got = grads_of(lambda *x: observe._ObsStep.apply(*x[:4], 1e-4, *x[4:])[1],
                 ins + params, [w_logit])
  want = grads_of(lambda *x: observe.reference_obs_step(*x[:4], x[4:])[1],
                  ins + params, [w_logit])
  for a, b in zip(got[1], want[1]):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_imag_step_function_replays_its_sample(monkeypatch):
  rng = np.random.default_rng(4)
  params, deter, stoch, act, gum = imag_case(rng, 8)
  params, (deter, stoch, act, gum) = t(params), t([deter, stoch, act, gum])
  monkeypatch.setattr(
      imagine, 'launch',
      lambda *a: tuple(x.detach() for x in imagine.reference_imag_step(*a)))
  weights = [torch.randn(8, n, generator=torch.Generator().manual_seed(n))
             for n in (D, L, L)]
  spec = (C, 0.01, 1e-4)
  got = grads_of(
      lambda *x: imagine._ImagStep.apply(*x[:3], gum, spec, *x[3:]),
      [deter, stoch, act] + params, weights)
  want = grads_of(
      lambda *x: imagine.reference_imag_step(*x[:3], gum, x[3:], C),
      [deter, stoch, act] + params, weights)
  for a, b in zip(got[0], want[0]):
    torch.testing.assert_close(a, b)
  for name, a, b in zip(('deter', 'stoch', 'act') + imagine.FIELDS, got[1],
                        want[1]):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


def test_kernel_launchers_refuse_cpu_tensors():
  rng = np.random.default_rng(6)
  params = t(make_params(rng, head=True))
  core = params[:len(blockgru.FIELDS)]
  ins = t(inputs(rng, 16))
  with pytest.raises(ValueError, match='CUDA'):
    blockgru.launch_bwd(*ins[:3], core, torch.zeros(16, D))
  with pytest.raises(ValueError, match='CUDA'):
    observe.launch_bwd(*ins, params, torch.zeros(16, D), torch.zeros(16, L))
  iparams, deter, stoch, act, gum = imag_case(rng, 16)
  with pytest.raises(ValueError, match='CUDA'):
    imagine.launch(*t([deter, stoch, act, gum]), t(iparams), C)


def test_work_of_the_new_kernels():
  # size12m: kernel 2 moves its weights twice (read, gradient written),
  # kernel 7 does 2 B flops per weight of the core and the prior.
  nbytes, flops = blockgru.work_bwd(16, 2048, 256, 512, 256, 8)
  weights = (2048 * 256 + 512 * 256 + 8 * 256 * 256 + 768 * 2048 +
             8 * 256 * 768)
  assert flops == 3 * 2 * 16 * weights
  assert 4 * weights < nbytes < 4 * weights + 600_000
  nbytes, flops = imagine.work(1024, 2048, 256, 512, 256, 8)
  prior = 2048 * 256 + 256 * 256 + 256 * 512
  assert flops == 2 * 1024 * (weights + prior)
  assert abs(flops / 1e9 - 10.33) < 0.01
