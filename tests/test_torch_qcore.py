"""The port's int8 observe window (ops/qcore.py) against the JAX package's.

The same numpy parameters, inputs and Gumbel noise go through the JAX
Pallas kernel (interpret mode on the CPU, as tests/test_ops_qcore.py runs
it) and the port's plain version, which its wrapper takes for CPU
tensors. Shapes are those of tests/test_ops_seq.py. Tolerances, float32:
quantization bit for bit; the window 2e-4 on deter and 2e-3 on the
logits, as tests/test_ops_qcore.py holds the JAX kernel to its reference
(the logits sum over the hidden width in another order); samples equal.
The plain version of the int8 tensor-core stage (ops/blockgru.py
reference_stage_product on int8 weights with column scales) is held
against the JAX kernel's _qmm within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu.ops import observe_seq as jobserve
from embodied_tpu.ops import qcore as jqcore
from embodied_tpu_torch.ops import blockgru, observe_seq, qcore

from test_ops_seq import A, C, D, G, H, K, S, T, B, make_inputs, make_params

L = S * C
DETER_TOL = 2e-4
LOGIT_TOL = 2e-3
# The plain int8 stage against the JAX _qmm: float32 sums of the same
# exact products (int8 values are exact in bf16) in another order.
STAGE_TOL = 1e-5


def gumbel(seed):
  u = np.random.default_rng(seed).uniform(1e-6, 1 - 1e-6, (T, B, L))
  return (-np.log(-np.log(u))).astype(np.float32)


def to_t(xs):
  return [torch.tensor(np.asarray(x, np.float32)) for x in xs]


def port_quantized(params):
  return qcore.quantize_params(to_t(params))


@pytest.mark.parametrize('seed', [0, 3])
def test_quantize_matches_jax_bit_for_bit(seed):
  params = make_params(seed)
  jq, js = jqcore.quantize_params(params)
  tq, ts = port_quantized(params)
  assert sorted(ts) == sorted(js) == sorted(qcore.QUANT)
  for name, a, b in zip(qcore.FIELDS, tq, jq):
    if name in qcore.QUANT:
      assert a.dtype == torch.int8, name
      np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
      assert ts[name].dtype == torch.float32, name
      np.testing.assert_array_equal(ts[name].numpy(), np.asarray(js[name]),
                                    err_msg=name)
    else:
      np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_roundtrip_error_bounded():
  params = to_t(make_params())
  qparams, scales = qcore.quantize_params(params)
  deq = qcore.dequantize_params(qparams, scales, dtype=torch.float32)
  for name, orig, back in zip(qcore.FIELDS, params, deq):
    if name not in qcore.QUANT:
      assert torch.equal(orig, back), name
      continue
    colmax = orig.abs().amax(-2, keepdim=True)
    # Symmetric int8: error within half a quantization step per column.
    err = (orig - back).abs()
    bound = colmax / 127.0 * 0.51 + 1e-7
    assert bool((err <= bound).all()), (name, float(err.max()))


def port_window(params, gum, nch=4, hard=None):
  qparams, scales = port_quantized(params)
  ins = to_t(make_inputs())
  if hard is not None:
    return qcore.reference_qobs_window(*ins, qparams, scales, C, nch=nch,
                                       hard=hard)
  return qcore.qobs_window(*ins, torch.tensor(gum), qparams, scales, C,
                           nch=nch)


def close(got, want, tol, name):
  np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                             rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize('seed', [7, 9])
def test_window_matches_the_jax_kernel(seed):
  """The port on the CPU against JAX qobs_window in interpret mode, on the
  same quantized weights, inputs and Gumbels: the same samples, and
  deter and logits within the JAX test's tolerances."""
  params = make_params()
  gum = gumbel(seed)
  jq, js = jqcore.quantize_params(params)
  dseq, sseq, lseq = jqcore.qobs_window(
      *make_inputs(), jnp.asarray(gum), jq, js, g=G, S=S, C=C, nch=4,
      interpret=True)
  launches = qcore.qobs_window.launches
  got = port_window(params, gum)
  assert qcore.qobs_window.launches == launches  # the CPU runs no kernel
  assert [tuple(x.shape) for x in got] == [(T, B, D), (T, B, L), (T, B, L)]
  assert got[2].dtype == torch.float32
  np.testing.assert_array_equal(got[1].numpy(), np.asarray(sseq))
  close(got[0], dseq, DETER_TOL, 'deter')
  close(got[2], lseq, LOGIT_TOL, 'logit')
  # Replaying its own samples, the plain version gives the same window.
  again = port_window(params, None, hard=got[1])
  for a, b in zip(got, again):
    assert torch.equal(a, b)


def test_window_matches_the_jax_reference_on_dequantized_weights():
  """The parity contract of tests/test_ops_qcore.py: the int8 window equals
  the bf16 window's reference on the dequantized weights."""
  params = make_params()
  qparams, scales = port_quantized(params)
  deq = qcore.dequantize_params(qparams, scales, dtype=torch.float32)
  dseq, sseq, lseq = port_window(params, gumbel(11))
  s4 = sseq.reshape(T, B, S, C)
  assert torch.equal(s4.sum(-1), torch.ones(T, B, S))
  rd, _, rl = jobserve.reference_observe_seq(
      *make_inputs(), tuple(x.numpy() for x in deq), sseq.numpy(), C)
  close(dseq, rd, DETER_TOL, 'deter')
  close(lseq, rl, LOGIT_TOL, 'logit')
  # And so does the port's own bf16-window reference on those weights.
  pd, _, pl = observe_seq.reference_observe_seq(
      *to_t(make_inputs()), deq, C, hard=sseq)
  close(dseq, pd.numpy(), DETER_TOL, 'deter (port)')
  close(lseq, pl.numpy(), LOGIT_TOL, 'logit (port)')


def test_chunking_is_invisible():
  params = make_params()
  gum = gumbel(13)
  outs = [port_window(params, gum, nch=nch) for nch in (1, 4)]
  assert torch.equal(outs[0][1], outs[1][1])
  for a, b, name in zip(*outs, ('deter', 'stoch', 'logit')):
    close(a, b.numpy(), 1e-4, name)


def test_work_counts_each_int8_weight_once():
  dims = (T, B, D, H, L, A, K, G)
  w = observe_seq.weights(D, H, L, A, K, G)
  dg = D // G
  columns = 3 * H + G * dg + D + G * 3 * dg + L
  nbytes, flops = qcore.work(*dims)
  bf16_bytes, bf16_flops = observe_seq.work(*dims)
  assert nbytes == bf16_bytes - w + 4 * columns
  assert flops == bf16_flops
  assert qcore.weight_bytes(D, H, L, A, K, G) == w + 4 * columns
  # The scales' shapes cover every column of their matrix once.
  shapes = qcore.scale_shapes(D, H, L, G)
  assert sum(int(np.prod(s)) for s in shapes.values()) == columns


# The int8 stage's cases: (groups, depth, columns per group, the depth of a
# dense second segment with scales of its own, as the hidden layer's x
# against win beside wblk's blocks).
STAGE_CASES = dict(dense=(1, 96, 64, 0), grouped=(4, 48, 32, 0),
                   two_segments=(4, 48, 32, 80))


@pytest.mark.parametrize('nch', [1, 4])
@pytest.mark.parametrize('case', sorted(STAGE_CASES))
@pytest.mark.parametrize('seed', [0, 1])
def test_int8_stage_matches_the_jax_qmm(seed, case, nch):
  """The plain int8 stage, whose products the card's tensor-core stage
  forms, against JAX _qmm on the same bf16 rows, int8 weights and column
  scales: one _qmm per block for grouped weights, as _q_step runs wblk
  and wg, plus one for the dense segment, as it runs win."""
  g, K, gN, K2 = STAGE_CASES[case]
  rng = np.random.default_rng(seed)
  B, N = 16, g * gN
  rows = lambda *s: np.asarray(jnp.asarray(
      rng.standard_normal(s), jnp.bfloat16).astype(jnp.float32))
  ints = lambda *s: rng.integers(-127, 128, s).astype(np.int8)
  scales = lambda *s: (1e-2 * rng.uniform(0.5, 1.5, s)).astype(np.float32)
  x, q, scale = rows(B, g * K), ints(g, K, gN), scales(g, gN)
  jbf = lambda a: jnp.asarray(a, jnp.bfloat16)
  want = jnp.concatenate([
      jqcore._qmm(jbf(x[:, b * K:(b + 1) * K]), jnp.asarray(q[b]),
                  jnp.asarray(scale[b]), nch) for b in range(g)], -1)
  second = {}
  if K2:
    x2, q2, scale2 = rows(B, K2), ints(K2, N), scales(N)
    want = want + jqcore._qmm(jbf(x2), jnp.asarray(q2), jnp.asarray(scale2),
                              nch)
    second = dict(x2=torch.tensor(x2).to(torch.bfloat16),
                  w2=torch.tensor(q2), scale2=torch.tensor(scale2))
  got = blockgru.reference_stage_product(
      torch.tensor(x).to(torch.bfloat16), torch.tensor(q),
      scale=torch.tensor(scale), **second)
  assert got.shape == (B, N) and got.dtype == torch.float32
  close(got, want, STAGE_TOL, case)
