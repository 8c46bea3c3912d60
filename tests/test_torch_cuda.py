"""The port's CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and nvcc; without one they skip. On a
machine with a card, from the root of a checkout (the JAX conftest is not
needed, and this file imports nothing of JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Widths are multiples of 16, as the kernels take them, and deep enough
that every matmul stage splits its contraction (2, 2 and 5 parts on a
132-SM card), with uneven parts; B = 40 spans three row tiles. Tolerance
3e-2 on bf16 outputs: the kernel and the plain version round to bf16 at
other places and sum in another order.
"""

import numpy as np
import pytest
import torch

from embodied_tpu_torch.ops import blockgru, observe

TOL = 3e-2
DIMS = dict(D=256, H=32, S=160, G=4, K=288, L=48)


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the kernels have no CPU mode')
  return torch.device('cuda')


def make(rng, card, B, D, H, S, G, K, L):
  dg = D // G
  mat = lambda *shape: 0.1 * rng.standard_normal(shape)
  vec = lambda n: 0.01 + 0.01 * rng.standard_normal(n)
  norm = lambda n: 1 + 0.1 * rng.standard_normal(n)
  params = [mat(D, H), vec(H), norm(H), mat(S, H), vec(H), norm(H),
            mat(G, dg, dg), vec(D), mat(3 * H, D), norm(D),
            mat(G, dg, 3 * dg), vec(3 * D),
            mat(D + K, H), vec(H), norm(H), mat(H, L), vec(L)]
  params = [
      torch.tensor(p, dtype=torch.float32 if name in blockgru.SCALES else
                   torch.bfloat16, device=card)
      for name, p in zip(observe.FIELDS, params)]
  ins = [torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                      device=card)
         for shape in ((B, D), (B, S), (B, H), (B, K))]
  return params, ins


def close(got, want, name):
  np.testing.assert_allclose(
      got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=TOL,
      atol=TOL, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize('B', [16, 40])
def test_kernels_match_plain(card, B):
  params, ins = make(np.random.default_rng(4), card, B, **DIMS)
  core = params[:len(blockgru.FIELDS)]
  before = blockgru.core_step.launches, observe.obs_step.launches
  got = blockgru.core_step(*ins[:3], core)
  close(got, blockgru.reference_step(*ins[:3], core), 'core_step')
  got = observe.obs_step(*ins, params)
  want = observe.reference_obs_step(*ins, params)
  for a, b, name in zip(got, want, ('deter', 'logit')):
    close(a, b, name)
  torch.cuda.synchronize()
  after = blockgru.core_step.launches, observe.obs_step.launches
  assert after == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_wrappers_raise_rather_than_fall_back(card):
  params, ins = make(np.random.default_rng(5), card, 16, **DIMS)
  core = params[:len(blockgru.FIELDS)]
  before = blockgru.core_step.launches
  with pytest.raises(TypeError):
    blockgru.core_step(*[x.float() for x in ins[:3]], core)
  with pytest.raises(ValueError, match='contiguous'):
    blockgru.core_step(ins[0].t().contiguous().t(), *ins[1:3], core)
  with pytest.raises(ValueError, match='CUDA'):
    blockgru.core_step(ins[0], ins[1].cpu(), ins[2], core)
  shifted = torch.empty(core[0].numel() + 1, dtype=torch.bfloat16,
                        device=card)[1:].view(core[0].shape)
  shifted.copy_(core[0])
  with pytest.raises(ValueError, match='aligned'):
    blockgru.core_step(*ins[:3], [shifted, *core[1:]])
  narrow = dict(DIMS, D=40, G=4)
  params, ins = make(np.random.default_rng(6), card, 16, **narrow)
  with pytest.raises(ValueError, match='multiple of 16'):
    observe.obs_step(*ins, params)
  assert blockgru.core_step.launches == before
