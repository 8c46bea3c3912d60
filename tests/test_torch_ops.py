"""The port's core and observe steps against the JAX package's kernels.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernels (interpret mode on the CPU), the JAX references and the port's
plain versions. Shapes follow tests/test_ops.py: D=64, H=24, S=16, g=4,
K=32, L=48. Tolerances: float32 1e-4 (summation order only); bfloat16
2e-2 (the frameworks round to bf16 at different places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu.ops import blockgru as jblockgru
from embodied_tpu.ops import observe as jobserve
from embodied_tpu_torch.ops import blockgru, observe

D, H, S, G, K, L = 64, 24, 16, 4, 32, 48
TOLS = {'float32': 1e-4, 'bfloat16': 2e-2}


def make_params(rng, head=False, D=D, H=H, S=S, G=G, K=K, L=L):
  dg = D // G
  mat = lambda *shape: 0.1 * rng.standard_normal(shape)
  vec = lambda n: 0.01 + 0.01 * rng.standard_normal(n)
  norm = lambda n: 1 + 0.1 * rng.standard_normal(n)
  params = [mat(D, H), vec(H), norm(H), mat(S, H), vec(H), norm(H),
            mat(G, dg, dg), vec(D), mat(3 * H, D), norm(D),
            mat(G, dg, 3 * dg), vec(3 * D)]
  if head:
    params += [mat(D + K, H), vec(H), norm(H), mat(H, L), vec(L)]
  return [p.astype(np.float32) for p in params]


def make_inputs(rng, B, D=D, H=H, S=S, K=K):
  return [rng.standard_normal(shape).astype(np.float32)
          for shape in ((B, D), (B, S), (B, H), (B, K))]


def to_jax(xs, fields, dtype):
  jdt = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}[dtype]
  out = []
  for name, x in zip(fields, xs):
    scale = name in ('s0', 's1', 'sh', 'so')
    out.append(jnp.asarray(x, jnp.float32 if scale else jdt))
  return out


def to_torch(xs, fields, dtype):
  tdt = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[dtype]
  out = []
  for name, x in zip(fields, xs):
    scale = name in ('s0', 's1', 'sh', 'so')
    out.append(torch.tensor(x, dtype=torch.float32 if scale else tdt))
  return out


def close(got, want, tol, name):
  np.testing.assert_allclose(
      np.asarray(got.float() if isinstance(got, torch.Tensor) else
                 jnp.asarray(got, jnp.float32)),
      np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B', [8, 192])
def test_core_step_matches_jax(B, dtype):
  rng = np.random.default_rng(0)
  params = make_params(rng)
  ins = make_inputs(rng, B)[:3]
  names = ('deter', 'stoch', 'act')
  jparams = to_jax(params, jblockgru.FIELDS, dtype)
  jins = to_jax(ins, names, dtype)
  want_kernel = jblockgru.fused_core_step(*jins, tuple(jparams),
                                          interpret=True)
  want_ref = jblockgru.reference_step(*jins, tuple(jparams))
  got = blockgru.reference_step(
      *to_torch(ins, names, dtype), to_torch(params, blockgru.FIELDS, dtype))
  assert got.dtype == {'float32': torch.float32,
                       'bfloat16': torch.bfloat16}[dtype]
  close(got, want_kernel, TOLS[dtype], 'vs fused_core_step')
  close(got, want_ref, TOLS[dtype], 'vs reference_step')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B', [8, 192])
def test_obs_step_matches_jax(B, dtype):
  rng = np.random.default_rng(1)
  params = make_params(rng, head=True)
  ins = make_inputs(rng, B)
  names = ('deter', 'stoch', 'act', 'tok')
  jparams = tuple(to_jax(params, jobserve.FIELDS, dtype))
  jins = to_jax(ins, names, dtype)
  want_kernel = jobserve.fused_obs_step(*jins, jparams, interpret=True)
  want_ref = jobserve.reference_obs_step(*jins, jparams)
  got = observe.reference_obs_step(
      *to_torch(ins, names, dtype), to_torch(params, observe.FIELDS, dtype))
  for i, name in enumerate(('deter', 'logit')):
    close(got[i], want_kernel[i], TOLS[dtype], f'{name} vs fused_obs_step')
    close(got[i], want_ref[i], TOLS[dtype], f'{name} vs reference_obs_step')


def test_cpu_wrappers_take_the_plain_version():
  rng = np.random.default_rng(2)
  params = make_params(rng, head=True)
  ins = to_torch(make_inputs(rng, 8), ('deter', 'stoch', 'act', 'tok'),
                 'float32')
  tparams = to_torch(params, observe.FIELDS, 'float32')
  core = tparams[:len(blockgru.FIELDS)]
  before = (blockgru.core_step.launches, observe.obs_step.launches)
  got = blockgru.core_step(*ins[:3], core)
  torch.testing.assert_close(
      got, blockgru.reference_step(*ins[:3], core), rtol=0, atol=0)
  got = observe.obs_step(*ins, tparams)
  want = observe.reference_obs_step(*ins, tparams)
  for a, b in zip(got, want):
    torch.testing.assert_close(a, b, rtol=0, atol=0)
  assert (blockgru.core_step.launches, observe.obs_step.launches) == before


def test_kernel_launch_refuses_cpu_tensors():
  # The launchers never fall back: a tensor that is not on the card raises.
  rng = np.random.default_rng(3)
  params = to_torch(make_params(rng, head=True), observe.FIELDS, 'bfloat16')
  ins = to_torch(make_inputs(rng, 16), ('deter', 'stoch', 'act', 'tok'),
                 'bfloat16')
  with pytest.raises(ValueError, match='CUDA'):
    blockgru.launch(*ins[:3], params[:len(blockgru.FIELDS)])
  with pytest.raises(ValueError, match='CUDA'):
    observe.launch(*ins, params)


def test_work_counts_weights_and_flops():
  nbytes, flops = observe.work(16, 2048, 256, 512, 256, 8, 2304, 512)
  weights = (2048 * 256 + 512 * 256 + 8 * 256 * 256 + 768 * 2048 +
             8 * 256 * 768 + 4352 * 256 + 256 * 512)
  assert flops == 2 * 16 * weights
  assert 2 * weights < nbytes < 2 * weights + 400_000

