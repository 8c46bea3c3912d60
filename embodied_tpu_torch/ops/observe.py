"""One RSSM observe step (core + posterior head): CUDA kernels for its
forward and backward, and their plain versions.

Replaces the Pallas TPU kernels embodied_tpu/ops/observe.py:
fused_obs_step and fused_obs_bwd. The kernels live in csrc/observe.cu: the
core stages and the posterior head of csrc/blockgru_common.cuh, which the
window kernels share (the head's hidden layer is the split product
new @ wo[:D] + tokens @ wo[D:]; the concatenation is never materialised),
and the window's step backward of csrc/seq_common.cuh at one step with no
sample. Their notes say what bounds them on an H100 (weight bytes at
acting batch) and what the design does about that.

`obs_step` is the wrapper: a CPU or meta tensor takes the plain version
`reference_obs_step`; a CUDA tensor launches the forward kernel or raises,
inside a `torch.autograd.Function` whose backward calls `obs_step_bwd`
(the backward kernel; plain version `reference_obs_step_bwd`) where
autograd needs the gradient, and alone where it does not. There is no
sampling inside: the straight-through sample's gradient reaches the
logits in PyTorch. Each wrapper counts its launches in `.launches`.

Weight layout: the 12 core FIELDS of ops/blockgru.py followed by
  wo (D + K, H), bo (H), so (H)   obs0 + rms scale   (posterior hidden)
  wl (H, L),     bl (L)           obslogit           (L = stoch * classes)
"""

import ctypes
import functools

import torch

from . import blockgru, build
from .blockgru import _rms, _silu

FIELDS = blockgru.FIELDS + ('wo', 'bo', 'so', 'wl', 'bl')


def reference_obs_step(deter, stoch_flat, actfeat, tokens, params,
                       eps=1e-4):
  """Plain PyTorch version: core step plus the posterior obs head."""
  p = dict(zip(FIELDS, params))
  cdt = deter.dtype
  D = deter.shape[-1]
  out = blockgru.reference_step(
      deter, stoch_flat, actfeat, params[:len(blockgru.FIELDS)], eps)
  x = out @ p['wo'][:D] + tokens @ p['wo'][D:] + p['bo']
  x = _silu(_rms(x, p['so'], eps)).to(cdt)
  logit = (x @ p['wl'] + p['bl']).to(cdt)
  return out, logit


@functools.cache
def _lib():
  lib = build.library('observe')
  build.bind(lib, 'observe_obs_step', 8,
             [ctypes.c_int] * 9 + [ctypes.c_float])
  build.bind(lib, 'observe_obs_bwd', 13,
             [ctypes.c_int] * 9 + [ctypes.c_float])
  return lib


def _want(B, D, H, S, A, g, K, L):
  want = blockgru.shapes(B, D, H, S, A, g)
  want.update(tok=(B, K), wo=(D + K, H), bo=(H,), so=(H,), wl=(H, L),
              bl=(L,))
  return want


def launch(deter, stoch_flat, actfeat, tokens, params, eps=1e-4):
  """Run the CUDA kernel on CUDA tensors (no counting, no dispatch)."""
  p = dict(zip(FIELDS, params))
  g, dg, _ = p['wblk'].shape
  B, D = deter.shape
  H, S, A = p['w0'].shape[1], stoch_flat.shape[1], actfeat.shape[1]
  K, L = tokens.shape[1], p['wl'].shape[1]
  device = blockgru.check_inputs(
      dict(deter=deter, stoch=stoch_flat, act=actfeat, tok=tokens, **p),
      _want(B, D, H, S, A, g, K, L))
  blockgru.check_widths(stoch=S, action=A, tokens=K, logit=L)
  out = torch.empty((B, D), dtype=deter.dtype, device=device)
  logit = torch.empty((B, L), dtype=deter.dtype, device=device)
  lib = _lib()
  ws = blockgru.workspace(lib, 'observe_obs_workspace',
                          [B, D, H, S, A, K, g, blockgru._sms(device)], device)
  ints = [B, D, H, S, A, K, L, g, blockgru._sms(device)]
  array, pp = blockgru._pointers(params)
  with torch.cuda.device(device):
    code = lib.observe_obs_step(
        *blockgru._ptrs([deter, stoch_flat, actfeat, tokens]), pp,
        *blockgru._ptrs([out, logit, ws]), *ints, eps,
        blockgru._stream(device))
  del array
  build.check(code, 'observe_obs_step')
  return out, logit


def reference_obs_step_bwd(deter, stoch_flat, actfeat, tokens, params, dout,
                           dlogit, eps=1e-4):
  """Plain version of the backward: autograd of `reference_obs_step`.
  Returns (ddeter, dstoch, dact, dtok, dparams)."""
  with torch.enable_grad():
    ins = [x.detach().requires_grad_() for x in (
        deter, stoch_flat, actfeat, tokens, *params)]
    out, logit = reference_obs_step(*ins[:4], ins[4:], eps)
    grads = torch.autograd.grad(
        (out, logit), ins, (dout.to(out.dtype), dlogit.to(logit.dtype)))
  return grads[0], grads[1], grads[2], grads[3], tuple(grads[4:])


def launch_bwd(deter, stoch_flat, actfeat, tokens, params, dout, dlogit,
               eps=1e-4):
  """Run the backward kernel on CUDA tensors (no counting, no dispatch).
  The upstream gradients may come in any float dtype."""
  p = dict(zip(FIELDS, params))
  g, dg, _ = p['wblk'].shape
  B, D = deter.shape
  H, S, A = p['w0'].shape[1], stoch_flat.shape[1], actfeat.shape[1]
  K, L = tokens.shape[1], p['wl'].shape[1]
  dout, dlogit = dout.float().contiguous(), dlogit.float().contiguous()
  want = dict(_want(B, D, H, S, A, g, K, L), dout=(B, D), dlogit=(B, L))
  device = blockgru.check_inputs(
      dict(deter=deter, stoch=stoch_flat, act=actfeat, tok=tokens,
           dout=dout, dlogit=dlogit, **p), want, floats=('dout', 'dlogit'))
  blockgru.check_widths(stoch=S, action=A, block=dg, tokens=K, logit=L)
  grads = [torch.empty_like(x) for x in (deter, stoch_flat, actfeat, tokens)]
  dparams = [torch.empty_like(x) for x in params]
  lib = _lib()
  ints = [B, D, H, S, A, K, L, g, blockgru._sms(device)]
  ws = blockgru.workspace(lib, 'observe_obs_bwd_workspace', ints, device)
  array, pp = blockgru._pointers(params)
  garray, gp = blockgru._pointers(dparams)
  with torch.cuda.device(device):
    code = lib.observe_obs_bwd(
        *blockgru._ptrs([deter, stoch_flat, actfeat, tokens]), pp,
        *blockgru._ptrs([dout, dlogit, *grads]), gp, *blockgru._ptrs([ws]),
        *ints, eps, blockgru._stream(device))
  del array, garray
  build.check(code, 'observe_obs_bwd')
  return (*grads, tuple(dparams))


def obs_step_bwd(deter, stoch_flat, actfeat, tokens, params, dout, dlogit,
                 eps=1e-4):
  """The step's backward for the upstream gradients of (new deter,
  logits): (ddeter, dstoch, dact, dtok, dparams), weight gradients in the
  weight dtype and norm-scale gradients in float32. CPU tensors take
  `reference_obs_step_bwd`; CUDA tensors launch the kernel and raise on
  what it does not take."""
  if blockgru.takes_plain(deter):
    return reference_obs_step_bwd(
        deter, stoch_flat, actfeat, tokens, params, dout, dlogit, eps)
  with torch.profiler.record_function('obs_step_bwd'):
    out = launch_bwd(deter, stoch_flat, actfeat, tokens, params, dout,
                     dlogit, eps)
  obs_step_bwd.launches += 1
  return out


obs_step_bwd.launches = 0


class _ObsStep(torch.autograd.Function):
  """The forward kernel, with the backward kernel as its gradient."""

  @staticmethod
  def forward(ctx, deter, stoch_flat, actfeat, tokens, eps, *params):
    ctx.save_for_backward(deter, stoch_flat, actfeat, tokens, *params)
    ctx.eps = eps
    return launch(deter, stoch_flat, actfeat, tokens, params, eps)

  @staticmethod
  def backward(ctx, dout, dlogit):
    deter, stoch_flat, actfeat, tokens, *params = ctx.saved_tensors
    zero = lambda g, shape: g if g is not None else torch.zeros(
        shape, device=deter.device)
    L = params[FIELDS.index('wl')].shape[1]
    *grads, dparams = obs_step_bwd(
        deter, stoch_flat, actfeat, tokens, params, zero(dout, deter.shape),
        zero(dlogit, (deter.shape[0], L)), ctx.eps)
    return (*grads, None, *dparams)


def obs_step(deter, stoch_flat, actfeat, tokens, params, eps=1e-4):
  """One observe step, returning (new deter, posterior logits). CPU tensors
  take `reference_obs_step`; CUDA tensors launch the kernel (bf16 only),
  and the backward kernel when autograd asks for gradients, and raise on
  what the kernels do not take."""
  if blockgru.takes_plain(deter):
    return reference_obs_step(deter, stoch_flat, actfeat, tokens, params, eps)
  with torch.profiler.record_function('obs_step'):
    if blockgru.needs_grad(deter, stoch_flat, actfeat, tokens, *params):
      out = _ObsStep.apply(deter, stoch_flat, actfeat, tokens, eps, *params)
    else:
      out = launch(deter, stoch_flat, actfeat, tokens, params, eps)
  obs_step.launches += 1
  return out


obs_step.launches = 0


def work(B, D, H, S, A, g, K, L):
  """Bytes and flops of one observe step, for the bound on the card.
  This is the kernel's roofline count; `Agent.train_cost` counts the
  plain version's products instead (parallel/flops.py)."""
  return blockgru.work(B, D, H, S, A, g, L=L, K=K)


def work_bwd(B, D, H, S, A, g, K, L):
  """Bytes and flops of the backward, for the bound on the card.
  This is the kernel's roofline count, recompute included;
  `Agent.train_cost` counts the plain version's products instead,
  whose backward recomputes nothing (parallel/flops.py)."""
  return blockgru.work_bwd(B, D, H, S, A, g, L=L, K=K)
