"""One RSSM observe step (core + posterior head): a CUDA kernel and its
plain version.

Replaces the Pallas TPU kernel embodied_tpu/ops/observe.py:fused_obs_step
(forward only). The kernel lives in csrc/observe.cu: the core stages and
the posterior head of csrc/blockgru_common.cuh, which the window kernels
share; the head's hidden layer is the split product
new @ wo[:D] + tokens @ wo[D:] (the concatenation is never materialised).
Their notes say what bounds it on an H100 (weight bytes at acting batch)
and what the design does about that.

`obs_step` is the wrapper: a CPU tensor takes the plain version
`reference_obs_step`; a CUDA tensor launches the kernel or raises. It
counts its launches in `obs_step.launches`.

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
  return lib


def launch(deter, stoch_flat, actfeat, tokens, params, eps=1e-4):
  """Run the CUDA kernel on CUDA tensors (no counting, no dispatch)."""
  p = dict(zip(FIELDS, params))
  g, dg, _ = p['wblk'].shape
  B, D = deter.shape
  H, S, A = p['w0'].shape[1], stoch_flat.shape[1], actfeat.shape[1]
  K, L = tokens.shape[1], p['wl'].shape[1]
  want = blockgru.shapes(B, D, H, S, A, g)
  want.update(tok=(B, K), wo=(D + K, H), bo=(H,), so=(H,), wl=(H, L),
              bl=(L,))
  device = blockgru.check_inputs(
      dict(deter=deter, stoch=stoch_flat, act=actfeat, tok=tokens, **p), want)
  if L % 16:
    raise ValueError(f'logit width {L} is not a multiple of 16')
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


def obs_step(deter, stoch_flat, actfeat, tokens, params, eps=1e-4):
  """One observe step, returning (new deter, posterior logits). CPU tensors
  take `reference_obs_step`; CUDA tensors launch the kernel (bf16 only) and
  raise on what it does not take."""
  if deter.device.type == 'cpu':
    return reference_obs_step(deter, stoch_flat, actfeat, tokens, params, eps)
  blockgru.refuse_grad(
      dict(deter=deter, stoch=stoch_flat, act=actfeat, tok=tokens,
           **dict(zip(FIELDS, params))), 'observe.fused_obs_bwd')
  out = launch(deter, stoch_flat, actfeat, tokens, params, eps)
  obs_step.launches += 1
  return out


obs_step.launches = 0


def work(B, D, H, S, A, g, K, L):
  """Bytes and flops of one observe step, for the bound on the card."""
  return blockgru.work(B, D, H, S, A, g, L=L, K=K)
