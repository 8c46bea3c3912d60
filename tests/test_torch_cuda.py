"""The port's CUDA kernels against their plain versions, on a card.

These tests need a CUDA card and nvcc; without one they skip. On a
machine with a card, from the root of a checkout (the JAX conftest is not
needed, and this file imports nothing of JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

The int8 window (kernel 9) is held against its plain version on the same
int8 weights, and the `debug` and `size1m` presets act and train under
`kernel: auto`: the first off the kernels (its widths are not multiples
of 16), the second on them.

The 16-row and the 128-row tensor-core products and the tensor-core
weight gradient that every kernel's stages share are also held on their
own against float32 matmul of the same bf16-rounded operands (the 16-row
stage also on int8 weights with column scales, kernel 9's products), and
the window's backward, the int8 window and the 128-row stage are run
twice for bit-equal results.

The Agent's data path runs on the card too: `agent.stream`'s pinned
copies on the agent's copy stream (a train step on them gives what the
numpy batch gives), the fetch pipeline's pinned copies behind an event,
and the latent table's rows against the host path's latents.

Widths are multiples of 16, as the kernels take them, and deep enough
that every matmul stage splits its contraction (2, 2 and 5 parts on a
132-SM card), with uneven parts; B = 40 spans three row tiles. Tolerance
3e-2 on bf16 outputs: the kernel and the plain version round to bf16 at
other places and sum in another order.
"""

import numpy as np
import pytest
import torch

from embodied_tpu_torch import core
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.ops import (
    blockgru, imagine, imagine_seq, observe, observe_seq, qcore)

TOL = 3e-2
# The window kernels' gradients against autograd of the plain replay in
# float32, by relative error ||got - want|| / ||want|| per tensor: bf16
# operands and rounded dY products put each element off by ~2^-9, and the
# sums over steps and rows average that down.
GRAD_RTOL = 1e-2
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
      got.detach().float().cpu().numpy(), want.float().cpu().numpy(), rtol=TOL,
      atol=TOL, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize('B', [16, 40, 1024])
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
@pytest.mark.parametrize('splits', [1, 3, 0])
@pytest.mark.parametrize('g', [1, 4])
@pytest.mark.parametrize('trans', [False, True])
@pytest.mark.parametrize('B', [1, 16, 40])
def test_tensor_core_stage(card, B, trans, g, splits):
  """The 16-row tensor-core product, forward and transposed, dense and
  block-diagonal, in one split, three (uneven over five 64-deep chunks) or
  the stage's own count, against float32 matmul of the same bf16-rounded
  operands; 80 columns per group leave a ragged 64-column tile, and
  B = 40 spans three row tiles."""
  rng = np.random.default_rng(13)
  K, gN = 320, 80
  x = torch.tensor(rng.standard_normal((B, g * K)), device=card,
                   dtype=torch.float32 if trans else torch.bfloat16)
  w = torch.tensor(0.1 * rng.standard_normal((g, gN, K) if trans else
                                             (g, K, gN)),
                   dtype=torch.bfloat16, device=card)
  parts = blockgru.stage_product(x, w, trans, splits)
  assert parts.shape == (splits or parts.shape[0], B, g * gN)
  if not splits:
    assert parts.shape[0] > 1
  close(parts.sum(0), blockgru.reference_stage_product(x, w, trans),
        'product')


# The int8 16-row stage's cases: (groups, depth K, columns per group, the
# dense second segment's depth K2). 80 columns leave a ragged 128-column
# tile, depths 320 and 192 ragged 128-deep chunks; the second segment has
# scales of its own, as the hidden layer's x against win beside wblk.
STAGE16_INT8 = dict(dense=(1, 320, 80, 0), grouped=(4, 320, 80, 0),
                    two_segments=(4, 192, 80, 320))


@pytest.mark.cuda
@pytest.mark.parametrize('splits', [1, 3, 0])
@pytest.mark.parametrize('case', sorted(STAGE16_INT8))
@pytest.mark.parametrize('B', [1, 16, 40])
def test_int8_tensor_core_stage(card, B, case, splits):
  """The 16-row tensor-core stage on int8 weights with float32 column
  scales (kernel 9's products) against float32 matmul of the same values,
  in one split, three (uneven over five 128-deep chunks, one crossing
  from the first segment into the second) or the stage's own count; and
  the bf16 stage on the same values, whose sums it must match before the
  scales."""
  rng = np.random.default_rng(18)
  g, K, gN, K2 = STAGE16_INT8[case]
  N = g * gN
  bf = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                               device=card)
  ints = lambda *s: torch.tensor(rng.integers(-127, 128, s),
                                 dtype=torch.int8, device=card)
  scales = lambda n: torch.tensor(1e-2 * rng.uniform(0.5, 1.5, n),
                                  dtype=torch.float32, device=card)
  x, w, scale = bf(B, g * K), ints(g, K, gN), scales(N)
  second = dict(x2=bf(B, K2), w2=ints(K2, N), scale2=scales(N)) if K2 else {}
  parts = blockgru.stage_product(x, w, False, splits, scale, **second)
  assert parts.shape == (splits or parts.shape[0], B, N)
  close(parts.sum(0), blockgru.reference_stage_product(x, w, False, scale,
                                                       **second), case)
  if not K2:
    plain = blockgru.stage_product(x, w.to(torch.bfloat16), False, splits)
    close(parts.sum(0), plain.sum(0) * scale, f'{case} against bf16')


@pytest.mark.cuda
def test_int8_tensor_core_stage_checks_its_operands(card):
  """Int8 weights take float32 column scales, one per column, and the
  forward product only; widths not multiples of 16 raise before any
  launch."""
  x = torch.zeros((16, 320), dtype=torch.bfloat16, device=card)
  w = torch.zeros((1, 320, 80), dtype=torch.int8, device=card)
  scale = torch.ones(80, device=card)
  with pytest.raises(ValueError, match='column scales'):
    blockgru.stage_product(x, w)
  with pytest.raises(ValueError, match='column scales'):
    blockgru.stage_product(x, w, scale=scale[:64])
  with pytest.raises(ValueError, match='transposed'):
    blockgru.stage_product(x.float(), w.reshape(1, 80, 320), True,
                           scale=scale)
  with pytest.raises(ValueError, match='columns width 72'):
    blockgru.stage_product(x, w[:, :, :72].contiguous(), scale=scale[:72])


# The 128-row stage's cases: (groups, depth K, columns per group, the
# dense second segment's depth K2, bias dtype). 320 and 80 columns leave
# ragged 256-column tiles, depths 200 and 136 ragged 64-deep chunks.
STAGE128 = dict(
    dense=(1, 200, 320, 0, torch.float32),
    grouped=(4, 136, 80, 0, torch.bfloat16),
    two_segments=(4, 64, 192, 136, torch.bfloat16))


def stage128_case(rng, card, B, g, K, gN, K2, bias_dtype):
  bf = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                               device=card)
  x, w = bf(B, g * K), bf(g, K, gN)
  x2, w2 = (bf(B, K2), bf(K2, g * gN)) if K2 else (None, None)
  bias = torch.tensor(rng.standard_normal(g * gN), dtype=bias_dtype,
                      device=card)
  return x, w, x2, w2, bias


@pytest.mark.cuda
@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', sorted(STAGE128))
@pytest.mark.parametrize('B', [128, 200, 1024])
def test_tensor_core_stage_128(card, B, case, out):
  """The 128-row tensor-core stage (wgmma from a TMA ring) against float32
  matmul of the same bf16 operands: dense, block-diagonal, and
  block-diagonal with a dense second segment (as the hidden layer); f32
  split partials (the stage's own count, and three uneven parts) or the
  finished bf16 product; 200 rows leave a partial row tile."""
  rng = np.random.default_rng(16)
  x, w, x2, w2, bias = stage128_case(rng, card, B, *STAGE128[case])
  want = blockgru.reference_stage_product128(x, w, x2, w2, bias, out)
  for splits in ((0, 3) if out == torch.float32 else (0,)):
    got = blockgru.stage_product128(x, w, x2, w2, bias, out, splits)
    assert got.dtype == out and got.shape[1:] == want.shape
    if splits:
      assert got.shape[0] == splits
    close(got.float().sum(0), want, f'{case}, {splits} splits')


@pytest.mark.cuda
def test_tensor_core_stage_128_is_deterministic_and_checks_widths(card):
  """Two calls give the same bits (split partials, no atomics); widths
  and depths that are not multiples of 8, and fewer than 128 rows, raise
  before any launch."""
  rng = np.random.default_rng(17)
  x, w, x2, w2, bias = stage128_case(rng, card, 1024,
                                     *STAGE128['two_segments'])
  first = blockgru.stage_product128(x, w, x2, w2, bias, splits=3)
  assert torch.equal(first, blockgru.stage_product128(x, w, x2, w2, bias,
                                                      splits=3))
  with pytest.raises(ValueError, match='columns 20 is not a multiple of 8'):
    blockgru.stage_product128(x, w[:, :, :20].contiguous())
  with pytest.raises(ValueError, match='depth 60 is not a multiple of 8'):
    blockgru.stage_product128(x[:, :4 * 60], w[:, :60].contiguous())
  with pytest.raises(ValueError, match='128 or more'):
    blockgru.stage_product128(x[:64], w)


@pytest.mark.cuda
@pytest.mark.parametrize('g', [1, 4])
@pytest.mark.parametrize('R', [16, 1024])
def test_tensor_core_weight_gradient(card, R, g):
  """The weight-gradient GEMM over R rows against float32 matmul of the
  same bf16-rounded operands; 80 x 48 outputs per group leave ragged
  64-wide tiles."""
  rng = np.random.default_rng(14)
  M, N = 80, 48
  x = torch.tensor(rng.standard_normal((R, g * M)), dtype=torch.bfloat16,
                   device=card)
  y = torch.tensor(rng.standard_normal((R, g * N)), dtype=torch.float32,
                   device=card)
  got = blockgru.stage_wgrad(x, y, g)
  assert got.shape == (g, M, N) and got.dtype == torch.bfloat16
  close(got, blockgru.reference_stage_wgrad(x, y, g), 'wgrad')


@pytest.mark.cuda
def test_window_backward_is_deterministic(card):
  """Kernel 6 gives bit-equal gradients in two calls on the same inputs:
  every split partial and every weight gradient is summed in a fixed
  order."""
  rng = np.random.default_rng(15)
  C = SEQ['C']
  params, deter0, stoch0, acts, toks, keep, gum = seq_case(rng, card, **SEQ)
  with torch.no_grad():
    dseq, sseq, lseq = observe_seq.observe_seq(
        deter0, stoch0, acts, toks, keep, gum, params, C)
  ups = [torch.tensor(rng.standard_normal(x.shape), device=card).float()
         for x in (dseq, sseq, lseq)]
  args = (deter0, stoch0, dseq, sseq, acts, toks, keep, params, *ups, C)
  first = observe_seq.observe_seq_bwd(*args)
  second = observe_seq.observe_seq_bwd(*args)
  flat = lambda out: [*out[:4], *out[4]]
  for a, b in zip(flat(first), flat(second)):
    assert torch.equal(a, b)


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


def relerr(got, want):
  got, want = got.float(), want.float()
  return float((got - want).norm() / want.norm().clamp(min=1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize('B', [16, 40])
def test_step_backward_kernels_match_autograd(card, B):
  """Kernels 2 and 4 against autograd of the plain versions in float32,
  every input and weight gradient, by relative error."""
  rng = np.random.default_rng(7)
  params, ins = make(rng, card, B, **DIMS)
  core = params[:len(blockgru.FIELDS)]
  dout = torch.tensor(rng.standard_normal((B, DIMS['D'])), device=card)
  dlogit = torch.tensor(rng.standard_normal((B, DIMS['L'])), device=card)
  f32 = lambda xs: [x.float() for x in xs]
  before = blockgru.core_step_bwd.launches, observe.obs_step_bwd.launches
  got = blockgru.core_step_bwd(*ins[:3], core, dout)
  want = blockgru.reference_step_bwd(*f32(ins[:3]), f32(core), dout)
  names = ('deter', 'stoch', 'act') + blockgru.FIELDS
  for name, a, b in zip(names, [*got[:3], *got[3]], [*want[:3], *want[3]]):
    assert a.dtype == (torch.float32 if name in blockgru.SCALES else
                       torch.bfloat16), name
    assert relerr(a, b) < GRAD_RTOL, (name, relerr(a, b))
  got = observe.obs_step_bwd(*ins, params, dout, dlogit)
  want = observe.reference_obs_step_bwd(*f32(ins), f32(params), dout, dlogit)
  names = ('deter', 'stoch', 'act', 'tok') + observe.FIELDS
  for name, a, b in zip(names, [*got[:4], *got[4]], [*want[:4], *want[4]]):
    assert relerr(a, b) < GRAD_RTOL, (name, relerr(a, b))
  torch.cuda.synchronize()
  after = blockgru.core_step_bwd.launches, observe.obs_step_bwd.launches
  assert after == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_core_and_obs_step_carry_gradients(card):
  """Where autograd needs a gradient, core_step and obs_step launch their
  forward kernels and, on backward, their backward kernels; under
  no_grad the forward runs alone."""
  params, ins = make(np.random.default_rng(7), card, 16, **DIMS)
  core = [p.clone().requires_grad_() for p in params[:len(blockgru.FIELDS)]]
  wrappers = (blockgru.core_step, blockgru.core_step_bwd, observe.obs_step,
              observe.obs_step_bwd)
  before = [w.launches for w in wrappers]
  deter = ins[0].clone().requires_grad_()
  out = blockgru.core_step(deter, *ins[1:3], core)
  assert out.grad_fn is not None
  out.float().square().sum().backward()
  want = blockgru.reference_step_bwd(
      *[x.float() for x in ins[:3]], [p.float() for p in core],
      2 * out.detach().float())
  assert relerr(deter.grad, want[0]) < GRAD_RTOL
  for name, p, w in zip(blockgru.FIELDS, core, want[3]):
    assert relerr(p.grad, w) < GRAD_RTOL, name
  new, logit = observe.obs_step(deter, *ins[1:], params)
  (new.float().sum() + logit.float().square().sum()).backward()
  with torch.no_grad():
    blockgru.core_step(deter, *ins[1:3], core)
  torch.cuda.synchronize()
  after = [w.launches for w in wrappers]
  assert [a - b for a, b in zip(after, before)] == [2, 1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize('B,H', [(6, 32), (200, 64), (1024, 64)])
def test_imagination_step(card, B, H):
  """Kernel 7 against the plain version replaying its sample, the sample
  against the plain draw from the same noise; 200 and 1,024 rows take the
  128-row stage, 200 with a partial row tile."""
  rng = np.random.default_rng(10)
  D, S, C, G = 256, 4, 16, 4
  L = S * C
  core, _ = make(rng, card, B, D=D, H=H, S=L, G=G, K=16, L=L)
  bf = lambda *s: torch.tensor(0.1 * rng.standard_normal(s),
                               dtype=torch.bfloat16, device=card)
  f32 = lambda *s: torch.tensor(1 + 0.1 * rng.standard_normal(s),
                                dtype=torch.float32, device=card)
  params = list(core[:len(blockgru.FIELDS)]) + [
      bf(D, H), bf(H), f32(H), bf(H, H), bf(H), f32(H), bf(H, L), bf(L)]
  deter = torch.tanh(bf(B, D).float()).to(torch.bfloat16)
  stoch = torch.nn.functional.one_hot(
      torch.tensor(rng.integers(0, C, (B, S)), device=card), C).reshape(
          B, L).to(torch.bfloat16)
  act = bf(B, H)
  gum = -torch.log(-torch.log(torch.tensor(
      rng.uniform(1e-6, 1 - 1e-6, (B, L)), dtype=torch.float32,
      device=card)))
  before = imagine.imag_step.launches
  with torch.no_grad():
    new, onehot, logit = imagine.imag_step(deter, stoch, act, gum, params, C)
    rd, _, rl = imagine.reference_imag_step(deter, stoch, act, gum, params,
                                            C, hard=onehot)
    _, drawn, _ = imagine.reference_imag_step(deter, stoch, act, gum, params,
                                              C)
  assert imagine.imag_step.launches == before + 1
  assert onehot.dtype == torch.bfloat16 and logit.dtype == torch.float32
  close(new, rd, 'deter')
  close(logit, rl, 'logit')
  s4 = onehot.float().reshape(B, S, C)
  assert torch.equal(s4.sum(-1), torch.ones_like(s4.sum(-1)))
  agree = (drawn.float().reshape(B, S, C).argmax(-1) == s4.argmax(-1))
  assert agree.float().mean() >= 0.95, agree.float().mean()


SEQ = dict(T=5, B=24, D=256, H=32, S=4, C=16, G=4, K=48)


def seq_case(rng, card, T, B, D, H, S, C, G, K):
  L = S * C
  params, _ = make(rng, card, B, D=D, H=H, S=L, G=G, K=K, L=L)
  bf = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                               device=card)
  deter0 = bf(B, D)
  stoch0 = torch.nn.functional.one_hot(
      torch.tensor(rng.integers(0, C, (B, S)), device=card), C).reshape(
          B, L).to(torch.bfloat16)
  keep = torch.ones((T, B), device=card)
  keep[2, 1] = 0
  gum = -torch.log(-torch.log(torch.tensor(
      rng.uniform(1e-6, 1 - 1e-6, (T, B, L)), dtype=torch.float32,
      device=card)))
  return params, deter0, stoch0, bf(T, B, H), bf(T, B, K), keep, gum


@pytest.mark.cuda
def test_observe_window_forward_and_backward(card):
  rng = np.random.default_rng(8)
  C = SEQ['C']
  params, deter0, stoch0, acts, toks, keep, gum = seq_case(rng, card, **SEQ)
  before = observe_seq.observe_seq.launches, observe_seq.observe_seq_bwd.launches
  ins = [x.clone().requires_grad_() for x in (deter0, stoch0, acts, toks)]
  dseq, sseq, lseq = observe_seq.observe_seq(*ins, keep, gum, params, C)
  s4 = sseq.float().reshape(*sseq.shape[:2], -1, C)
  assert torch.equal(s4.sum(-1), torch.ones_like(s4.sum(-1)))
  with torch.no_grad():
    rd, rs, rl = observe_seq.reference_observe_seq(
        deter0, stoch0, acts, toks, keep, params, C, hard=sseq)
    _, drawn, _ = observe_seq.reference_observe_seq(
        deter0, stoch0, acts, toks, keep, params, C, gumbel=gum)
  close(dseq, rd, 'deter')
  close(lseq, rl, 'logit')
  agree = (drawn.reshape(s4.shape).argmax(-1) == s4.argmax(-1)).float()
  assert agree.mean() >= 0.95, agree.mean()
  ups = [torch.tensor(rng.standard_normal(x.shape), device=card).to(x.dtype)
         for x in (dseq, sseq, lseq)]
  torch.autograd.backward((dseq, sseq, lseq), ups)
  f32 = lambda xs: [x.float() for x in xs]
  want = observe_seq.reference_observe_seq_bwd(
      *f32([deter0, stoch0]), sseq.float(), *f32([acts, toks]), keep,
      f32(params), *f32(ups), C)
  got = [x.grad for x in ins]
  for name, a, b in zip(('deter0', 'stoch0', 'acts', 'toks'), got, want):
    assert relerr(a, b) < GRAD_RTOL, (name, relerr(a, b))
  dparams = observe_seq.observe_seq_bwd(
      deter0, stoch0, dseq.detach(), sseq.detach(), acts, toks, keep, params,
      *ups, C)[4]
  for name, a, b in zip(observe_seq.FIELDS, dparams, want[4]):
    assert relerr(a, b) < GRAD_RTOL, (name, relerr(a, b))
  after = observe_seq.observe_seq.launches, observe_seq.observe_seq_bwd.launches
  assert after == (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize('disc,adim', [(True, 5), (False, 6)])
def test_imagination_rollout(card, disc, adim):
  check_rollout(card, disc, adim, B=40, H=32, U=32)


@pytest.mark.cuda
@pytest.mark.parametrize('disc,adim', [(True, 5), (False, 6)])
def test_imagination_rollout_on_tensor_cores(card, disc, adim):
  """From 128 rows on, the stage products whose widths are multiples of
  64 run on the tensor cores; 200 rows leave a partial row tile."""
  check_rollout(card, disc, adim, B=200, H=64, U=64)


def check_rollout(card, disc, adim, B, H, U):
  rng = np.random.default_rng(9)
  steps, D, S, C, G, npol = 4, 256, 4, 16, 4, 2
  L = S * C
  core, _ = make(rng, card, B, D=D, H=H, S=L, G=G, K=16, L=L)
  core = core[:len(blockgru.FIELDS)]
  # Weights of about unit gain, as the core's: the plain core rounds its
  # pre-activations to bf16 where the kernel keeps f32, and the prior
  # carries that into the f32 logits in proportion to its gain.
  bf = lambda *s: torch.tensor(0.1 * rng.standard_normal(s),
                               dtype=torch.bfloat16, device=card)
  f32 = lambda *s: torch.tensor(1 + 0.1 * rng.standard_normal(s),
                                dtype=torch.float32, device=card)
  extra = [bf(D, H), bf(H), f32(H), bf(H, H), bf(H), f32(H), bf(H, L),
           bf(L), bf(adim, H), bf(H), f32(H)]
  for i in range(npol):
    extra += [bf(D + L if i == 0 else U, U), bf(U), f32(U)]
  heads = 1 if disc else 2
  for _ in range(heads):
    extra += [bf(U, adim), bf(adim).float()]
  params = list(core) + extra
  deter0 = torch.tanh(bf(B, D).float()).to(torch.bfloat16)
  stoch0 = torch.nn.functional.one_hot(
      torch.tensor(rng.integers(0, C, (B, S)), device=card), C).reshape(
          B, L).to(torch.bfloat16)
  u = lambda *s: torch.tensor(rng.uniform(1e-6, 1 - 1e-6, s),
                              dtype=torch.float32, device=card)
  gum = -torch.log(-torch.log(u(steps, B, L)))
  noise = (-torch.log(-torch.log(u(steps, B, adim))) if disc else
           torch.tensor(rng.standard_normal((steps, B, adim)),
                        dtype=torch.float32, device=card))
  before = imagine_seq.imagine_seq.launches
  with torch.no_grad():
    dseq, sseq, lseq, aseq = imagine_seq.imagine_seq(
        deter0, stoch0, gum, noise, params, npol, disc, C)
    rd, rs, rl, ra = imagine_seq.reference_imagine_seq(
        deter0, stoch0, params, npol, disc, C, gumbel=gum, noise=noise,
        hard=sseq, acts=aseq)
  assert imagine_seq.imagine_seq.launches == before + 1
  assert aseq.shape == (steps, B, adim)
  close(dseq, rd, 'deter')
  close(lseq, rl, 'logit')
  close(aseq, ra, 'action')


@pytest.mark.cuda
def test_int8_window(card):
  """Kernel 9 against the plain version replaying its samples on the same
  int8 weights and column scales, the samples against the plain draw."""
  rng = np.random.default_rng(11)
  C = SEQ['C']
  params, deter0, stoch0, acts, toks, keep, gum = seq_case(rng, card, **SEQ)
  qparams, scales = qcore.quantize_params(params)
  before = qcore.qobs_window.launches
  with torch.no_grad():
    dseq, sseq, lseq = qcore.qobs_window(
        deter0, stoch0, acts, toks, keep, gum, qparams, scales, C)
    rd, _, rl = qcore.reference_qobs_window(
        deter0, stoch0, acts, toks, keep, qparams, scales, C, hard=sseq)
    _, drawn, _ = qcore.reference_qobs_window(
        deter0, stoch0, acts, toks, keep, qparams, scales, C, gumbel=gum)
  assert qcore.qobs_window.launches == before + 1
  assert lseq.dtype == torch.float32 and sseq.dtype == torch.bfloat16
  close(dseq, rd, 'deter')
  close(lseq, rl, 'logit')
  s4 = sseq.float().reshape(*sseq.shape[:2], -1, C)
  assert torch.equal(s4.sum(-1), torch.ones_like(s4.sum(-1)))
  agree = (drawn.float().reshape(s4.shape).argmax(-1) == s4.argmax(-1))
  assert agree.float().mean() >= 0.95, agree.float().mean()


@pytest.mark.cuda
def test_int8_window_is_deterministic(card):
  """Kernel 9 gives the same bits in two calls on the same inputs: split
  partials added in split order, no atomics."""
  rng = np.random.default_rng(19)
  C = SEQ['C']
  params, *ins = seq_case(rng, card, **SEQ)
  qparams, scales = qcore.quantize_params(params)
  with torch.no_grad():
    first = qcore.qobs_window(*ins, qparams, scales, C)
    again = qcore.qobs_window(*ins, qparams, scales, C)
  for a, b in zip(first, again):
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_int8_window_raises_rather_than_fall_back(card):
  rng = np.random.default_rng(12)
  C = SEQ['C']
  params, deter0, stoch0, acts, toks, keep, gum = seq_case(rng, card, **SEQ)
  qparams, scales = qcore.quantize_params(params)
  before = qcore.qobs_window.launches
  with pytest.raises(TypeError):
    qcore.qobs_window(deter0.float(), stoch0, acts, toks, keep, gum,
                      qparams, scales, C)
  with pytest.raises(TypeError):  # bf16 weights where int8 belong
    qcore.qobs_window(deter0, stoch0, acts, toks, keep, gum, params, scales,
                      C)
  with pytest.raises(ValueError, match='CUDA'):
    qcore.qobs_window(deter0, stoch0.cpu(), acts, toks, keep, gum, qparams,
                      scales, C)
  with pytest.raises(ValueError, match='CUDA'):
    qcore.qobs_window(deter0, stoch0, acts, toks, keep, gum, qparams,
                      dict(scales, wg=scales['wg'].cpu()), C)
  # Widths the 16-byte int8 loads do not take: the hidden width H and the
  # GRU block D / g (and so 3 D / g) not multiples of 16.
  for dims, message in ((dict(H=24), 'w0 width 24'),
                        (dict(G=32), 'wblk width 8')):
    bad, *bad_ins = seq_case(rng, card, **dict(SEQ, **dims))
    with pytest.raises(ValueError, match=message):
      qcore.qobs_window(*bad_ins, *qcore.quantize_params(bad), C)
  assert qcore.qobs_window.launches == before


def batch(agent, config):
  """A (batch_size, batch_length + replay_context) batch of zeros with
  every replay key, fresh windows (consec 0)."""
  return agent._example_batch(
      config.batch_size, config.batch_length + config.replay_context)


@pytest.mark.cuda
@pytest.mark.parametrize('preset,kernels', [('debug', False),
                                            ('size1m', True)])
def test_presets_act_and_train_under_auto(card, preset, kernels):
  """A preset acts and trains on the card under kernel: auto: the debug
  widths (deter 8, hidden 3) are not eligible and take the plain path;
  size1m's widths are multiples of 16 and take the kernels."""
  config = common.assemble_config(main.CONFIGS, [
      '--configs', preset, '--task', 'dummy_disc', '--torch.device', 'cuda',
      '--batch_size', '4', '--batch_length', '8'])
  agent = main.make_agent(config)
  assert agent.model.dyn._obs_seq_eligible() is kernels
  wrappers = (observe.obs_step, observe_seq.observe_seq,
              observe_seq.observe_seq_bwd, imagine_seq.imagine_seq)
  before = [w.launches for w in wrappers]
  driver = core.Driver(
      [lambda i=i: common.make_env(config, i) for i in range(2)],
      parallel=False)
  driver.reset(agent.init_policy)
  driver(agent.policy, steps=2 * 3)
  driver.close()
  _, _, mets = agent.train(agent.init_train(config.batch_size),
                           batch(agent, config))
  torch.cuda.synchronize()
  assert all(np.isfinite(v) for v in mets.values())
  got = [w.launches - b for w, b in zip(wrappers, before)]
  assert got == ([3, 1, 1, 1] if kernels else [0, 0, 0, 0]), got


def debug_agent(*extra):
  config = common.assemble_config(main.CONFIGS, [
      '--configs', 'debug', '--task', 'dummy_disc', '--torch.device', 'cuda',
      '--batch_size', '4', '--batch_length', '8',
      '--torch.compute_dtype', 'float32', *extra])
  return main.make_agent(config), config


@pytest.mark.cuda
def test_stream_copies_on_a_side_stream_and_trains_as_numpy(card):
  """agent.stream puts each batch in pinned memory and copies it to the
  card on the agent's copy stream, with an event the train step waits on;
  the step gives what the same numpy batch gives. The fetch pipeline's
  copies land in pinned memory behind an event."""
  fed, config = debug_agent('--torch.fetch_depth', '0')
  direct, _ = debug_agent('--torch.fetch_depth', '0')
  data = batch(fed, config)
  data['is_first'][:, 0] = True
  prefetched = next(iter(fed.stream(iter([data]))))
  assert prefetched.ready is not None
  assert fed._copy_stream != torch.cuda.current_stream()
  assert all(v.device.type == 'cuda' for v in prefetched.values())
  _, _, got = fed.train(fed.init_train(4), prefetched)
  _, _, want = direct.train(direct.init_train(4), data)
  assert got == want
  numbers, scalars, host, event = fed._start_fetch(
      {}, {'a': torch.ones((), device='cuda'), 'b': torch.zeros(3,
                                                                device='cuda')})
  assert scalars == ['a'] and not numbers and event is not None
  assert all(v.is_pinned() for v in host.values())
  outs, mets = fed._finish_fetch((numbers, scalars, host, event))
  assert mets['a'] == 1.0 and (mets['b'] == 0).all() and not outs


@pytest.mark.cuda
def test_table_on_the_card_holds_the_host_paths_latents(card):
  """Policy calls on the table path write, at the slots they return, the
  packed latents the host path returns."""
  table, config = debug_agent()
  host, _ = debug_agent('--torch.latent_slots', '0')
  host.load(table.save())
  obs = table._example_obs(3)
  obs['is_first'][:] = True
  _, _, tout = table.policy(table.init_policy(3), obs)
  _, _, hout = host.policy(host.init_policy(3), obs)
  rows = table._latents.gather(torch.from_numpy(tout['slot']).cuda())
  for key in ('dyn/deter', 'dyn/stoch'):
    np.testing.assert_array_equal(rows[key].cpu().numpy(), hout[key])


@pytest.mark.cuda
def test_train_step_on_the_defaults_never_waits_for_the_card(card):
  """The default data path (the latent table, batches through
  agent.stream, fetch_depth 3) makes no synchronizing CUDA call in a train
  step once the pipeline is full: the host queues the next step while the
  card runs."""
  agent, config = debug_agent()
  assert agent._fetch_depth == 3 and agent._latents is not None
  data = batch(agent, config)
  data['is_first'][:, 0] = True
  stream = iter(agent.stream(iter([data] * 6)))
  carry = agent.init_train(4)
  for _ in range(4):
    carry, _, _ = agent.train(carry, next(stream))
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    for _ in range(2):
      carry, _, mets = agent.train(carry, next(stream))
  finally:
    torch.cuda.set_sync_debug_mode('default')
  assert all(np.isfinite(v) for v in mets.values())
