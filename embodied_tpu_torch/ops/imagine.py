"""One imagination step (core + prior + stochastic sample): a CUDA kernel
and its plain version.

Replaces the Pallas TPU kernel embodied_tpu/ops/imagine.py:fused_imag_step.
The kernel lives in csrc/imagine.cu; its stages are csrc/seq_common.cuh's
imag_step, which the whole-horizon rollout (ops/imagine_seq.py) runs once
per step after its policy. Their notes say what bounds it on an H100
(operations at the train step's B = 1024 rows) and what the design does
about that.

Per call: the block-GRU core on (deter, stoch) with the action embedding
`actfeat`, two silu(rms(.)) prior layers and the f32 prior logits, then
the stochastic sample per group of C classes by Gumbel-max over the unimix
blend (1 - unimix) softmax + unimix / C, with the Gumbel noise `gum`
(B, L) f32 an input. Returns (new deter, sample, logits f32). The sample's
value is the one-hot; in the plain version its gradient flows into the
blended probabilities (straight through).

`imag_step` is the wrapper: a CPU or meta tensor takes `reference_imag_step`; a
CUDA tensor launches the kernel or raises. The rollout runs without a
graph on the train step (DreamerV3 stops the gradient at the rolled-out
features), so the kernel then runs alone and keeps nothing; where a
gradient is asked for, the backward is autograd of the plain version
replaying the kernel's sample, as the JAX custom VJP does. It counts its
launches in `imag_step.launches`.

Weight layout: the 12 core FIELDS of ops/blockgru.py followed by
  wp0 (D, H), bp0 (H), sp0 (H)   prior0 + rms scale
  wp1 (H, H), bp1 (H), sp1 (H)   prior1 + rms scale
  wpl (H, L), bpl (L)            priorlogit   (L = stoch * classes)
"""

import ctypes
import functools

import torch

from . import blockgru, build
from ..utils import timer
from .blockgru import _rms, _silu
from .observe_seq import group_probs, gumbel_max, straight_through

PRIOR_FIELDS = ('wp0', 'bp0', 'sp0', 'wp1', 'bp1', 'sp1', 'wpl', 'bpl')
FIELDS = blockgru.FIELDS + PRIOR_FIELDS
SCALES = blockgru.SCALES + ('sp0', 'sp1')


def _mm(a, b):
  """bf16 operands, f32 products, as the kernel multiplies."""
  return a.float() @ b.float()


def _layer(x, w, b, s, eps):
  return _silu(_rms(_mm(x, w) + b.float(), s, eps)).to(x.dtype)


def reference_imag_step(deter, stoch_flat, actfeat, gum, params, C,
                        unimix=0.01, eps=1e-4, hard=None):
  """Plain version. Draws the sample from `gum` (B, L) or, given `hard`
  (B, L), replays it. Returns (deter, straight-through sample, logits
  f32)."""
  p = dict(zip(FIELDS, params))
  new = blockgru.reference_step(
      deter, stoch_flat, actfeat, params[:len(blockgru.FIELDS)], eps)
  x = _layer(new, p['wp0'], p['bp0'], p['sp0'], eps)
  x = _layer(x, p['wp1'], p['bp1'], p['sp1'], eps)
  logit = _mm(x, p['wpl']) + p['bpl'].float()
  probs = group_probs(logit, C, unimix)
  onehot = (gumbel_max(probs, gum) if hard is None else
            hard.float().reshape(probs.shape))
  return new, straight_through(probs, onehot, logit.shape, deter.dtype), logit


@functools.cache
def _lib():
  lib = build.library('imagine')
  build.bind(lib, 'imagine_step', 9,
             [ctypes.c_int] * 8 + [ctypes.c_float] * 2)
  return lib


def launch(deter, stoch_flat, actfeat, gum, params, C, unimix=0.01,
           eps=1e-4):
  """Run the CUDA kernel on CUDA tensors (no counting, no dispatch)."""
  p = dict(zip(FIELDS, params))
  g, dg, _ = p['wblk'].shape
  B, D = deter.shape
  H, L, A = p['w0'].shape[1], stoch_flat.shape[1], actfeat.shape[1]
  want = blockgru.shapes(B, D, H, L, A, g)
  want.update(gum=(B, L), wp0=(D, H), bp0=(H,), sp0=(H,), wp1=(H, H),
              bp1=(H,), sp1=(H,), wpl=(H, L), bpl=(L,))
  device = blockgru.check_inputs(
      dict(deter=deter, stoch=stoch_flat, act=actfeat, gum=gum, **p), want,
      floats=('gum',) + SCALES)
  blockgru.check_widths(stoch=L, action=A)
  if L % C:
    raise ValueError(f'stoch width {L} is not a multiple of {C} classes')
  out = torch.empty_like(deter)
  onehot = torch.empty_like(stoch_flat)
  logit = torch.empty((B, L), dtype=torch.float32, device=device)
  lib = _lib()
  sms = blockgru._sms(device)
  ws = blockgru.workspace(lib, 'imagine_step_workspace',
                          [B, D, H, L, A, g, sms], device)
  array, pp = blockgru._pointers(params)
  with torch.cuda.device(device):
    code = lib.imagine_step(
        *blockgru._ptrs([deter, stoch_flat, actfeat, gum]), pp,
        *blockgru._ptrs([out, onehot, logit, ws]), B, D, H, L, A, g, C, sms,
        eps, unimix, blockgru._stream(device))
  del array
  build.check(code, 'imagine_step')
  return out, onehot, logit


class _ImagStep(torch.autograd.Function):
  """The kernel forward; the backward is autograd of the plain replay."""

  @staticmethod
  def forward(ctx, deter, stoch_flat, actfeat, gum, spec, *params):
    out = launch(deter, stoch_flat, actfeat, gum, params, *spec)
    ctx.save_for_backward(deter, stoch_flat, actfeat, out[1], *params)
    ctx.spec = spec
    return out

  @staticmethod
  def backward(ctx, *grads):
    deter, stoch_flat, actfeat, onehot, *params = ctx.saved_tensors
    C, unimix, eps = ctx.spec
    with torch.enable_grad():
      ins = [x.detach().requires_grad_() for x in (
          deter, stoch_flat, actfeat, *params)]
      outs = reference_imag_step(ins[0], ins[1], ins[2], None, ins[3:], C,
                                 unimix, eps, hard=onehot)
      pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
      got = torch.autograd.grad([o for o, _ in pairs], ins,
                                [g.to(o.dtype) for o, g in pairs],
                                allow_unused=True)
    return (got[0], got[1], got[2], None, None, *got[3:])


def imag_step(deter, stoch_flat, actfeat, gum, params, C, unimix=0.01,
              eps=1e-4):
  """One imagination step (see the module note): (new deter, sample,
  logits f32). CPU tensors take the plain version; CUDA tensors launch the
  kernel (bf16 only) and raise on what it does not take."""
  if blockgru.takes_plain(deter):
    return reference_imag_step(deter, stoch_flat, actfeat, gum, params, C,
                               unimix, eps)
  with timer.range('imag_step'):
    if blockgru.needs_grad(deter, stoch_flat, actfeat, *params):
      out = _ImagStep.apply(deter, stoch_flat, actfeat, gum,
                            (C, unimix, eps), *params)
    else:
      out = launch(deter, stoch_flat, actfeat, gum, params, C, unimix, eps)
  imag_step.launches += 1
  return out


imag_step.launches = 0


def work(B, D, H, L, A, g):
  """Bytes the step must move (inputs read once, outputs written once) and
  its flops, for the bound on the card.
  This is the kernel's roofline count; `Agent.train_cost` counts the
  plain version's products instead (parallel/flops.py)."""
  dg = D // g
  core = D * H + L * H + g * dg * dg + (2 * H + A) * D + g * dg * 3 * dg
  weights = core + D * H + H * H + H * L
  vectors = 2 * H + 4 * D + 2 * H + L     # biases, bf16
  scales = 2 * H + D + 2 * H              # norm scales, f32
  ins = 2 * B * (D + L + A) + 4 * B * L   # deter, stoch, act; gum f32
  outs = 2 * B * (D + L) + 4 * B * L      # deter, one-hot; logits f32
  nbytes = 2 * (weights + vectors) + 4 * scales + ins + outs
  return nbytes, 2 * B * weights
