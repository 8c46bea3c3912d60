"""The observe window's forward on int8 weights: a CUDA kernel and its
plain version.

Replaces the Pallas TPU kernel embodied_tpu/ops/qcore.py: qobs_window
(_q_kernel, _q_step, _qmm). It computes the forward of the observe window
(ops/observe_seq.py) with the seven weight matrices w0, w1, wblk, win, wg,
wo and wl stored as int8, each with per-output-column symmetric float32
scales (per block for wblk and wg, shape (g, dg) and (g, 3 dg)); biases
and norm scales stay exact. Every product is (x @ q) * scale in float32:
the int8 values are exact in bf16 and float32 (|q| <= 127), and the scale
multiplies the small (B, cols) output, never the weight. wo applies one
scale to both of its parts, new @ wo[:D] and tok @ wo[D:]. Masks, unimix,
the Gumbel-max sample and the outputs are those of the bf16 window:
time-major deter (T, B, D), one-hot stoch (T, B, L) and f32 logits
(T, B, L). Forward only: no training path runs it.

The kernel lives in csrc/qcore.cu: the bf16 window's forward
(csrc/seq_common.cuh, window_fwd) on int8 weights, every product on the
16-row tensor-core stage of csrc/blockgru_common.cuh, which streams the
int8 tiles (16 weights per 16-byte load), forms exact bf16 fragments from
them in registers and applies the column scales to its float32 sums. At
the default configuration's dims (D 8192, H 1024, L 2048, K 9216) the
seven matrices hold 89 M weights: 178 MB in bf16, 89 MB in int8, both
beyond the H100's 50 MB L2, so every step streams them from device
memory; int8 halves those bytes. The `nch` argument, the TPU kernel's
column chunks (a bound on a VMEM temporary), changes nothing here: the
result is the same for every value.

`qobs_window` is the wrapper: a CPU or meta tensor takes the plain version
`reference_qobs_window`; a CUDA tensor launches the kernel or raises on a
wrong device, dtype, shape or contiguity, or on widths the 16-byte int8
loads do not take (H, D / g and so 3 D / g multiples of 16, checked with
the weights' shapes). It counts its launches in `.launches`.
"""

import ctypes
import functools

import torch

from . import blockgru, build, observe_seq
from ..utils import timer
from .blockgru import _rms, _silu

FIELDS = observe_seq.FIELDS  # core 12 + wo, bo, so, wl, bl
QUANT = ('w0', 'w1', 'wblk', 'win', 'wg', 'wo', 'wl')


def quantize_params(params):
  """Per-output-column symmetric int8, as the JAX quantize_params: the
  absmax over axis -2, scale = max(absmax, 1e-12) / 127, q = round half to
  even of w / scale, clipped to +-127. Returns (qparams, scales): the
  params with the QUANT entries replaced by int8 tensors, and a dict of
  float32 column scales keyed by field name."""
  p = dict(zip(FIELDS, params))
  scales, out = {}, []
  for name in FIELDS:
    w = p[name]
    if name not in QUANT:
      out.append(w)
      continue
    w = w.float()
    absmax = w.abs().amax(-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    out.append(torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8))
    scales[name] = scale.squeeze(-2)
  return tuple(out), scales


def dequantize_params(qparams, scales, dtype=torch.bfloat16):
  """The dequantized weights q * scale in `dtype`; the rest unchanged."""
  p = dict(zip(FIELDS, qparams))
  out = []
  for name in FIELDS:
    w = p[name]
    if name not in QUANT:
      out.append(w)
      continue
    scale = scales[name][..., None, :] if w.ndim == 3 else scales[name]
    out.append((w.float() * scale).to(dtype))
  return tuple(out)


def _qmm(x, wq, scale, nch):
  """x @ q * scale in float32, in nch column chunks (as the JAX _qmm)."""
  N = wq.shape[-1]
  ch = N // nch
  outs = [(x.float() @ wq[:, c * ch:(c + 1) * ch].float()) *
          scale[c * ch:(c + 1) * ch].float() for c in range(nch)]
  return torch.cat(outs, -1) if nch > 1 else outs[0]


def _q_step(deter, stoch, act, tok, p, s, eps, nch):
  """The core and the posterior head on int8 weights; mirrors the JAX
  _q_step. Returns (new deter, f32 logits)."""
  D = deter.shape[-1]
  g, dg, _ = p['wblk'].shape
  cdt = deter.dtype
  xd = _silu(_rms(_qmm(deter, p['w0'], s['w0'], nch) + p['b0'], p['s0'],
                  eps)).to(cdt)
  x0 = _silu(_rms(_qmm(stoch, p['w1'], s['w1'], nch) + p['b1'], p['s1'],
                  eps)).to(cdt)
  x = torch.cat([xd, x0, act], -1)
  hs = [_qmm(deter[:, b * dg:(b + 1) * dg], p['wblk'][b], s['wblk'][b], 1)
        for b in range(g)]
  h = torch.cat(hs, -1) + p['bblk']
  h = h + _qmm(x, p['win'], s['win'], nch)
  h = _silu(_rms(h, p['sh'], eps)).to(cdt)
  gs = [_qmm(h[:, b * dg:(b + 1) * dg], p['wg'][b], s['wg'][b], 1)
        for b in range(g)]
  gates = torch.cat(gs, -1) + p['bg'].float()
  outs = []
  for b in range(g):
    off = b * 3 * dg
    reset = torch.sigmoid(gates[:, off:off + dg])
    cand = torch.tanh(reset * gates[:, off + dg:off + 2 * dg])
    update = torch.sigmoid(gates[:, off + 2 * dg:off + 3 * dg] - 1)
    prev = deter[:, b * dg:(b + 1) * dg].float()
    outs.append(update * cand + (1 - update) * prev)
  new = torch.cat(outs, -1).to(cdt)
  pre = (_qmm(new, p['wo'][:D], s['wo'], nch) +
         _qmm(tok, p['wo'][D:], s['wo'], nch) + p['bo'])
  xo = _silu(_rms(pre, p['so'], eps)).to(cdt)
  logit = _qmm(xo, p['wl'], s['wl'], 1) + p['bl'].float()
  return new, logit


def reference_qobs_window(deter0, stoch0, acts, toks, keep, qparams, scales,
                          C, unimix=0.01, eps=1e-4, nch=4, gumbel=None,
                          hard=None):
  """Plain version. Draws each step's one-hots from `gumbel` (T, B, L) or,
  given `hard` (T, B, L), replays them. Returns time-major (deter_seq,
  stoch_seq one-hots, logit_seq f32)."""
  assert (gumbel is None) != (hard is None), 'pass gumbel or hard'
  p = dict(zip(FIELDS, qparams))
  cdt = deter0.dtype
  deter, stoch = deter0, stoch0
  deters, stochs, logits = [], [], []
  for t in range(acts.shape[0]):
    m = keep[t][:, None].float()
    deter = (deter.float() * m).to(cdt)
    stoch = (stoch.float() * m).to(cdt)
    act = (acts[t].float() * m).to(cdt)
    deter, logit = _q_step(deter, stoch, act, toks[t], p, scales, eps, nch)
    if hard is None:
      probs = observe_seq.group_probs(logit, C, unimix)
      onehot = observe_seq.gumbel_max(probs, gumbel[t])
    else:
      onehot = hard[t]
    stoch = onehot.reshape(stoch0.shape).to(cdt)
    deters.append(deter)
    stochs.append(stoch)
    logits.append(logit)
  return torch.stack(deters), torch.stack(stochs), torch.stack(logits)


def scale_shapes(D, H, L, g):
  """The column scales' shapes, by QUANT name."""
  dg = D // g
  return dict(w0=(H,), w1=(H,), wblk=(g, dg), win=(D,), wg=(g, 3 * dg),
              wo=(H,), wl=(L,))


@functools.cache
def _lib():
  lib = build.library('qcore')
  build.bind(lib, 'qobs_window_fwd', 12, [ctypes.c_int] * 10 +
             [ctypes.c_float] * 2)
  return lib


def launch(deter0, stoch0, acts, toks, keep, gumbel, qparams, scales, C,
           unimix=0.01, eps=1e-4):
  """Run the CUDA kernel on CUDA tensors (no counting, no dispatch)."""
  d = observe_seq.dims(deter0, stoch0, acts, toks, qparams, C)
  T, B, D, H, L, A, K, g = (d[k] for k in 'T B D H L A K g'.split())
  want = blockgru.shapes(B, D, H, L, A, g)
  want.update(wo=(D + K, H), bo=(H,), so=(H,), wl=(H, L), bl=(L,),
              deter0=(B, D), stoch0=(B, L), acts=(T, B, A), toks=(T, B, K),
              keep=(T, B), gumbel=(T, B, L))
  want.update({f'scale_{k}': v for k, v in scale_shapes(D, H, L, g).items()})
  named = dict(deter0=deter0, stoch0=stoch0, acts=acts, toks=toks, keep=keep,
               gumbel=gumbel, **dict(zip(FIELDS, qparams)))
  named.update({f'scale_{k}': scales[k] for k in QUANT})
  device = blockgru.check_inputs(
      named, want, floats=('keep', 'gumbel') + tuple(
          f'scale_{k}' for k in QUANT), int8s=QUANT)
  for name, width in dict(deter=D, stoch=L, tokens=K, action=A).items():
    if width % 16:
      raise ValueError(f'{name} width {width} is not a multiple of 16')
  if L % C:
    raise ValueError(f'stoch width {L} is not a multiple of {C} classes')
  lib = _lib()
  ints = [T, B, D, H, L, A, K, g, C, blockgru._sms(device)]
  ws = blockgru.workspace(lib, 'qobs_window_workspace', ints, device)
  dseq = torch.empty((T, B, D), dtype=torch.bfloat16, device=device)
  sseq = torch.empty((T, B, L), dtype=torch.bfloat16, device=device)
  lseq = torch.empty((T, B, L), dtype=torch.float32, device=device)
  array, pp = blockgru._pointers(qparams)
  sarray, sp = blockgru._pointers([scales[k] for k in QUANT])
  with torch.cuda.device(device):
    code = lib.qobs_window_fwd(
        *blockgru._ptrs([deter0, stoch0, acts, toks, keep, gumbel]), pp, sp,
        *blockgru._ptrs([dseq, sseq, lseq, ws]), *ints, eps, unimix,
        blockgru._stream(device))
  del array, sarray
  build.check(code, 'qobs_window_fwd')
  return dseq, sseq, lseq


def qobs_window(deter0, stoch0, acts, toks, keep, gumbel, qparams, scales, C,
                unimix=0.01, eps=1e-4, nch=4):
  """The int8 window (see the module note). CPU tensors take the plain
  version; CUDA tensors launch the kernel and raise on what it does not
  take. `nch` reaches only the plain version's column chunks."""
  if blockgru.takes_plain(deter0):
    return reference_qobs_window(deter0, stoch0, acts, toks, keep, qparams,
                                 scales, C, unimix, eps, nch, gumbel=gumbel)
  with timer.range('qobs_window'):
    out = launch(deter0, stoch0, acts, toks, keep, gumbel, qparams, scales,
                 C, unimix, eps)
  qobs_window.launches += 1
  return out


qobs_window.launches = 0


def weight_bytes(D, H, L, A, K, g):
  """Bytes of the seven int8 matrices and their f32 column scales."""
  dg = D // g
  cols = H + H + g * dg + D + g * 3 * dg + H + L
  return observe_seq.weights(D, H, L, A, K, g) + 4 * cols


def work(T, B, D, H, L, A, K, g):
  """Bytes the forward must move (inputs read once, outputs written once)
  and its flops, for the bound on the card: observe_seq.work with each
  weight one byte instead of two, plus the column scales.
  This is the kernel's roofline count; `Agent.train_cost` counts the
  plain version's products instead (parallel/flops.py)."""
  nbytes, flops = observe_seq.work(T, B, D, H, L, A, K, g)
  w = observe_seq.weights(D, H, L, A, K, g)
  return nbytes - 2 * w + weight_bytes(D, H, L, A, K, g), flops
