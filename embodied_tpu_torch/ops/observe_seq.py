"""The whole observe window: CUDA kernels for its forward and backward, and
their plain version.

Replaces the Pallas TPU kernels embodied_tpu/ops/observe_seq.py:
fused_observe_seq (forward) and fused_observe_seq_bwd (backward). The
kernels live in csrc/observe_seq.cu and csrc/seq_common.cuh, whose notes
give the stages, what bounds them on an H100 (the chain of 64 dependent
steps at T = 64, B = 16: latency) and what the design does about it.

Per step t of the window: mask the state and action by keep[t], run the
block-GRU core and the posterior head (ops/observe.py), then draw the
stochastic state per group of C classes by Gumbel-max over the unimix
blend (1 - unimix) softmax + unimix / C, with the Gumbel noise an input.
The sample carries straight-through gradients of the blended
probabilities.

Inputs are time-major: acts (T, B, A), toks (T, B, K), keep (T, B) f32,
gumbel (T, B, L) f32. Outputs deter (T, B, D), stoch one-hots (T, B, L)
and logits (T, B, L) f32.

`observe_seq` is the wrapper: a CPU or meta tensor takes the plain version
`reference_observe_seq`, which autograd differentiates; a CUDA tensor runs
the `torch.autograd.Function` whose forward launches the forward kernel and
whose backward calls `observe_seq_bwd`, which launches the backward
kernel. Each counts its launches in `.launches`.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import blockgru, build, observe
from .blockgru import _rms, _silu

FIELDS = observe.FIELDS


def group_probs(logit, C, unimix):
  """Unimix-blended class probabilities (..., S, C) of flat logits."""
  z = logit.float().reshape((*logit.shape[:-1], -1, C))
  return (1 - unimix) * torch.softmax(z, -1) + unimix / C


def gumbel_max(probs, gumbel):
  """One-hot argmax of log(probs) + gumbel per group (the first index on a
  tie); probs (..., S, C), gumbel flat (..., S * C)."""
  y = torch.log(probs) + gumbel.reshape(probs.shape)
  return F.one_hot(y.argmax(-1), probs.shape[-1]).to(probs.dtype)


def straight_through(probs, onehot, shape, dtype):
  """The sample's value is `onehot`; its gradient flows into `probs`."""
  return (probs + (onehot - probs).detach()).reshape(shape).to(dtype)


def posterior_logit(new, tok, p, eps):
  """The posterior head of ops/observe.py with f32 logits, as the window
  kernel writes them."""
  D = new.shape[-1]
  x = new @ p['wo'][:D] + tok @ p['wo'][D:] + p['bo']
  x = _silu(_rms(x, p['so'], eps)).to(new.dtype)
  return x.float() @ p['wl'].float() + p['bl'].float()


def reference_observe_seq(deter0, stoch0, acts, toks, keep, params, C,
                          unimix=0.01, eps=1e-4, gumbel=None, hard=None):
  """Plain version. Draws each step's one-hots from `gumbel` (T, B, L) or,
  given `hard` (T, B, L), replays them. Returns time-major (deter_seq,
  stoch_seq, logit_seq f32)."""
  assert (gumbel is None) != (hard is None), 'pass gumbel or hard'
  p = dict(zip(FIELDS, params))
  core = params[:len(blockgru.FIELDS)]
  cdt = deter0.dtype
  deter, stoch = deter0, stoch0
  deters, stochs, logits = [], [], []
  for t in range(acts.shape[0]):
    m = keep[t][:, None].float()
    deter = (deter.float() * m).to(cdt)
    stoch = (stoch.float() * m).to(cdt)
    act = (acts[t].float() * m).to(cdt)
    deter = blockgru.reference_step(deter, stoch, act, core, eps)
    logit = posterior_logit(deter, toks[t], p, eps)
    probs = group_probs(logit, C, unimix)
    onehot = (gumbel_max(probs, gumbel[t]) if hard is None else
              hard[t].float().reshape(probs.shape))
    stoch = straight_through(probs, onehot, stoch0.shape, cdt)
    deters.append(deter)
    stochs.append(stoch)
    logits.append(logit)
  return torch.stack(deters), torch.stack(stochs), torch.stack(logits)


def reference_observe_seq_bwd(deter0, stoch0, stoch_seq, acts, toks, keep,
                              params, ddeter, dstoch, dlogit, C, unimix=0.01,
                              eps=1e-4):
  """Plain version of the backward: autograd of the replay of `stoch_seq`.
  Returns (ddeter0, dstoch0, dacts, dtoks, dparams)."""
  with torch.enable_grad():
    ins = [x.detach().requires_grad_() for x in (
        deter0, stoch0, acts, toks, *params)]
    outs = reference_observe_seq(
        *ins[:4], keep, ins[4:], C, unimix, eps, hard=stoch_seq)
    grads = torch.autograd.grad(outs, ins, (ddeter, dstoch, dlogit))
  return grads[0], grads[1], grads[2], grads[3], tuple(grads[4:])


def dims(deter0, stoch0, acts, toks, params, C):
  p = dict(zip(FIELDS, params))
  T, B, A = acts.shape
  D, L, K = deter0.shape[1], stoch0.shape[1], toks.shape[2]
  H, g = p['w0'].shape[1], p['wblk'].shape[0]
  return dict(T=T, B=B, D=D, H=H, L=L, A=A, K=K, g=g, C=C)


def _check(named, params, d):
  """Shapes, dtypes, devices and widths the kernels take; raises."""
  T, B, D, H, L, A, K, g = (d[k] for k in 'T B D H L A K g'.split())
  want = blockgru.shapes(B, D, H, L, A, g)
  want.update(wo=(D + K, H), bo=(H,), so=(H,), wl=(H, L), bl=(L,))
  want.update({k: v for k, v in dict(
      deter0=(B, D), stoch0=(B, L), acts=(T, B, A), toks=(T, B, K),
      keep=(T, B), gumbel=(T, B, L), deter_prev=(T, B, D),
      stoch_prev=(T, B, L), ddeter=(T, B, D), dstoch=(T, B, L),
      dlogit=(T, B, L)).items() if k in named})
  device = blockgru.check_inputs(
      dict(named, **dict(zip(FIELDS, params))), want,
      floats=('keep', 'gumbel', 'ddeter', 'dstoch', 'dlogit'))
  for name, width in dict(deter=D, stoch=L, tokens=K, action=A).items():
    if width % 16:
      raise ValueError(f'{name} width {width} is not a multiple of 16')
  if L % d['C']:
    raise ValueError(f'stoch width {L} is not a multiple of {d["C"]} classes')
  return device


def _ints(d, device):
  return [d[k] for k in 'T B D H L A K g C'.split()] + [blockgru._sms(device)]


@functools.cache
def _lib():
  lib = build.library('observe_seq')
  build.bind(lib, 'observe_seq_fwd', 11, [ctypes.c_int] * 10 +
             [ctypes.c_float] * 2)
  build.bind(lib, 'observe_seq_bwd', 15, [ctypes.c_int] * 10 +
             [ctypes.c_float] * 2)
  return lib


def launch_fwd(deter0, stoch0, acts, toks, keep, gumbel, params, C,
               unimix=0.01, eps=1e-4):
  """Run the forward kernel on CUDA tensors (no counting, no dispatch)."""
  d = dims(deter0, stoch0, acts, toks, params, C)
  device = _check(dict(deter0=deter0, stoch0=stoch0, acts=acts, toks=toks,
                       keep=keep, gumbel=gumbel), params, d)
  T, B, D, L = d['T'], d['B'], d['D'], d['L']
  lib, ints = _lib(), _ints(d, device)
  ws = blockgru.workspace(lib, 'observe_seq_fwd_workspace', ints, device)
  dseq = torch.empty((T, B, D), dtype=torch.bfloat16, device=device)
  sseq = torch.empty((T, B, L), dtype=torch.bfloat16, device=device)
  lseq = torch.empty((T, B, L), dtype=torch.float32, device=device)
  array, pp = blockgru._pointers(params)
  with torch.cuda.device(device):
    code = lib.observe_seq_fwd(
        *blockgru._ptrs([deter0, stoch0, acts, toks, keep, gumbel]), pp,
        *blockgru._ptrs([dseq, sseq, lseq, ws]), *ints, eps, unimix,
        blockgru._stream(device))
  del array
  build.check(code, 'observe_seq_fwd')
  return dseq, sseq, lseq


def launch_bwd(deter0, stoch0, deter_seq, stoch_seq, acts, toks, keep,
               params, ddeter, dstoch, dlogit, C, unimix=0.01, eps=1e-4):
  """Run the backward kernel on CUDA tensors (no counting, no dispatch).
  The upstream gradients may come in any float dtype."""
  d = dims(deter0, stoch0, acts, toks, params, C)
  f32 = lambda x: x.float().contiguous()
  deter_prev = torch.cat([deter0[None], deter_seq[:-1]]).contiguous()
  stoch_prev = torch.cat([stoch0[None], stoch_seq[:-1]]).contiguous()
  named = dict(deter0=deter0, stoch0=stoch0, deter_prev=deter_prev,
               stoch_prev=stoch_prev, acts=acts, toks=toks, keep=keep,
               ddeter=f32(ddeter), dstoch=f32(dstoch), dlogit=f32(dlogit))
  device = _check(named, params, d)
  lib, ints = _lib(), _ints(d, device)
  ws = blockgru.workspace(lib, 'observe_seq_bwd_workspace', ints, device)
  ddeter0 = torch.empty_like(deter0)
  dstoch0 = torch.empty_like(stoch0)
  dacts = torch.empty_like(acts)
  dtoks = torch.empty_like(toks)
  dparams = [torch.empty_like(x) for x in params]
  array, pp = blockgru._pointers(params)
  garray, gp = blockgru._pointers(dparams)
  with torch.cuda.device(device):
    code = lib.observe_seq_bwd(
        *blockgru._ptrs([deter_prev, stoch_prev, acts, toks, keep]), pp,
        *blockgru._ptrs([named['ddeter'], named['dstoch'], named['dlogit'],
                         ddeter0, dstoch0, dacts, dtoks]), gp,
        *blockgru._ptrs([ws]), *ints, eps, unimix,
        blockgru._stream(device))
  del array, garray
  build.check(code, 'observe_seq_bwd')
  return ddeter0, dstoch0, dacts, dtoks, tuple(dparams)


def observe_seq_bwd(deter0, stoch0, deter_seq, stoch_seq, acts, toks, keep,
                    params, ddeter, dstoch, dlogit, C, unimix=0.01,
                    eps=1e-4):
  """The window's backward. CPU tensors take `reference_observe_seq_bwd`;
  CUDA tensors launch the kernel and raise on what it does not take."""
  if blockgru.takes_plain(deter0):
    return reference_observe_seq_bwd(
        deter0, stoch0, stoch_seq, acts, toks, keep, params, ddeter, dstoch,
        dlogit, C, unimix, eps)
  with torch.profiler.record_function('observe_seq_bwd'):
    out = launch_bwd(deter0, stoch0, deter_seq, stoch_seq, acts, toks, keep,
                     params, ddeter, dstoch, dlogit, C, unimix, eps)
  observe_seq_bwd.launches += 1
  return out


observe_seq_bwd.launches = 0


class _ObserveSeq(torch.autograd.Function):
  """Forward kernel, with the backward kernel as its gradient."""

  @staticmethod
  def forward(ctx, deter0, stoch0, acts, toks, keep, gumbel, C, unimix,
              eps, *params):
    dseq, sseq, lseq = launch_fwd(
        deter0, stoch0, acts, toks, keep, gumbel, params, C, unimix, eps)
    ctx.save_for_backward(deter0, stoch0, dseq, sseq, acts, toks, keep,
                          *params)
    ctx.spec = (C, unimix, eps)
    return dseq, sseq, lseq

  @staticmethod
  def backward(ctx, ddeter, dstoch, dlogit):
    deter0, stoch0, dseq, sseq, acts, toks, keep, *params = ctx.saved_tensors
    zero = lambda g, x: torch.zeros_like(x, dtype=torch.float32) if (
        g is None) else g
    dd0, ds0, dacts, dtoks, dparams = observe_seq_bwd(
        deter0, stoch0, dseq, sseq, acts, toks, keep, params,
        zero(ddeter, dseq), zero(dstoch, sseq), zero(dlogit, sseq), *ctx.spec)
    return (dd0, ds0, dacts, dtoks, None, None, None, None, None, *dparams)


def observe_seq(deter0, stoch0, acts, toks, keep, gumbel, params, C,
                unimix=0.01, eps=1e-4):
  """The window (see the module note). CPU tensors take the plain version;
  CUDA tensors launch the forward kernel, and the backward kernel when
  autograd asks for gradients. Raises on what the kernels do not take."""
  if blockgru.takes_plain(deter0):
    return reference_observe_seq(deter0, stoch0, acts, toks, keep, params,
                                 C, unimix, eps, gumbel=gumbel)
  with torch.profiler.record_function('observe_seq'):
    out = _ObserveSeq.apply(deter0, stoch0, acts, toks, keep, gumbel, C,
                            unimix, eps, *params)
  observe_seq.launches += 1
  return out


observe_seq.launches = 0


def weights(D, H, L, A, K, g):
  dg = D // g
  return (D * H + L * H + g * dg * dg + (2 * H + A) * D + g * dg * 3 * dg +
          (D + K) * H + H * L)


def work(T, B, D, H, L, A, K, g):
  """Bytes the forward must move (inputs read once, outputs written once)
  and its flops, for the bound on the card.
  This is the kernel's roofline count; `Agent.train_cost` counts the
  plain version's products instead (parallel/flops.py)."""
  w = weights(D, H, L, A, K, g)
  vectors = 2 * H + D + 3 * D + H + L    # biases, bf16
  scales = 2 * H + D + H                 # norm scales, f32
  ins = 2 * (B * D + B * L + T * B * (A + K)) + 4 * T * B * (1 + L)
  outs = 2 * T * B * (D + L) + 4 * T * B * L
  nbytes = 2 * (w + vectors) + 4 * scales + ins + outs
  return nbytes, 2 * T * B * w


def work_bwd(T, B, D, H, L, A, K, g):
  """Bytes and flops of the backward: it reads the forward's inputs, the
  states entering each step and f32 upstream gradients, writes the input
  and weight gradients, and does three times the forward's products (the
  recompute, the input gradients, the weight gradients).
  This is the kernel's roofline count, recompute included;
  `Agent.train_cost` counts the plain version's products instead,
  whose backward recomputes nothing (parallel/flops.py)."""
  w = weights(D, H, L, A, K, g)
  vectors = 2 * H + D + 3 * D + H + L
  scales = 2 * H + D + H
  params = 2 * (w + vectors) + 4 * scales
  ins = (2 * T * B * (D + L + A + K) + 4 * T * B +
         4 * T * B * (D + 2 * L))
  outs = 2 * (B * D + B * L + T * B * (A + K))
  nbytes = 2 * params + ins + outs
  return nbytes, 3 * 2 * T * B * w
