"""One block-diagonal GRU core step: a CUDA kernel and its plain version.

Replaces the Pallas TPU kernel embodied_tpu/ops/blockgru.py:fused_core_step
(forward only; the backward comes with the train step). The kernel lives
in csrc/blockgru.cu and csrc/blockgru_common.cuh, whose notes give the
stages, what bounds it on an H100 (weight bytes at acting batch) and what
its design does about that.

`core_step` is the wrapper: a CPU tensor takes the plain version
`reference_step`; a CUDA tensor launches the kernel or raises. It counts
its launches in `core_step.launches`.

Weight layout (as rssm.RSSM's parameters; FIELDS order):
  w0 (D, H),  b0 (H),  s0 (H)    dynin0 + rms scale     (deter proj)
  w1 (S, H),  b1 (H),  s1 (H)    dynin1 + rms scale     (stoch proj)
  wblk (g, Dg, Dg), bblk (D)     dynhid0blk             (block hidden)
  win (3H, D)                    dynhid0in (no bias)    (dense hidden)
  sh (D)                         dynhid0norm rms scale
  wg (g, Dg, 3*Dg), bg (3D)      dyngru                 (gates)
Matrices and biases are in the compute dtype, norm scales in float32.
"""

import ctypes
import functools

import torch

from . import build

FIELDS = ('w0', 'b0', 's0', 'w1', 'b1', 's1',
          'wblk', 'bblk', 'win', 'sh', 'wg', 'bg')
SCALES = ('s0', 's1', 'sh', 'so')


def _rms(x, scale, eps):
  x = x.float()
  return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
      scale.float())


def _silu(x):
  return x * torch.sigmoid(x)


def reference_step(deter, stoch_flat, actfeat, params, eps=1e-4):
  """Plain PyTorch version, the same math as the JAX reference_step."""
  p = dict(zip(FIELDS, params))
  cdt = deter.dtype
  g, dg, _ = p['wblk'].shape
  B, D = deter.shape
  xd = _silu(_rms(deter @ p['w0'] + p['b0'], p['s0'], eps)).to(cdt)
  x0 = _silu(_rms(stoch_flat @ p['w1'] + p['b1'], p['s1'], eps)).to(cdt)
  x = torch.cat([xd, x0, actfeat], -1)
  h = torch.einsum(
      'bgd,gdu->bgu', deter.reshape(B, g, dg), p['wblk']).reshape(B, D)
  h = h + p['bblk'] + x @ p['win']
  h = _silu(_rms(h, p['sh'], eps)).to(cdt)
  gates = torch.einsum('bgd,gdu->bgu', h.reshape(B, g, dg), p['wg'])
  gates = gates.reshape(B, 3 * D) + p['bg']
  reset, cand, update = [
      y.reshape(B, D) for y in gates.reshape(B, g, 3 * dg).split(dg, -1)]
  reset = torch.sigmoid(reset)
  cand = torch.tanh(reset * cand)
  update = torch.sigmoid(update - 1)
  return (update * cand + (1 - update) * deter).to(cdt)


def shapes(B, D, H, S, A, g):
  """Expected shapes of the inputs and FIELDS."""
  dg = D // g
  return dict(
      deter=(B, D), stoch=(B, S), act=(B, A),
      w0=(D, H), b0=(H,), s0=(H,), w1=(S, H), b1=(H,), s1=(H,),
      wblk=(g, dg, dg), bblk=(D,), win=(2 * H + A, D), sh=(D,),
      wg=(g, dg, 3 * dg), bg=(3 * D,))


def check_inputs(named, want, tile=16):
  """Raise unless every tensor lies on one CUDA device, is contiguous and
  has the expected shape and dtype (float32 for the norm scales in SCALES,
  bf16 for the rest), and the widths fit the kernel's 16-column tiles."""
  device = next(iter(named.values())).device
  for name, x in named.items():
    if x.device != device or x.device.type != 'cuda':
      raise ValueError(f'{name} on {x.device}, expected one CUDA device')
    dtype = torch.float32 if name in SCALES else torch.bfloat16
    if x.dtype != dtype:
      raise TypeError(f'{name} has dtype {x.dtype}, the kernel takes {dtype}')
    if tuple(x.shape) != want[name]:
      raise ValueError(f'{name} has shape {tuple(x.shape)}, not {want[name]}')
    if not x.is_contiguous():
      raise ValueError(f'{name} is not contiguous')
    if x.data_ptr() % 16:
      raise ValueError(f'{name} is not 16-byte aligned (the kernel loads '
                       'weights 16 bytes at a time)')
  for name in ('w0', 'wblk', 'wg'):
    if want[name][-1] % tile:
      raise ValueError(f'{name} width {want[name][-1]} is not a multiple of '
                       f'{tile}')
  return device


def splits(cols, B, K, sms, tile=16, chunk=128):
  """How many parts a matmul stage with `cols` output columns splits its
  depth-K contraction into: enough blocks (16 x 16 output tiles times
  parts) for two per SM of a card with `sms` SMs, and at least one
  128-deep chunk per part. 1 when the batch alone gives enough tiles."""
  tiles = (cols // tile) * -(-B // tile)
  return max(1, min(-(-2 * sms // tiles), -(-K // chunk)))


def core_scratch(B, D, H, S, A, g, device):
  """Split counts of the input projection and the hidden stage, and the
  scratch the core stages write: f32 partial sums and bf16 activations."""
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  ns1 = splits(2 * H, B, max(D, S), sms)
  ns2 = splits(D, B, D // g + 2 * H + A, sms)
  f32 = dict(dtype=torch.float32, device=device)
  bf16 = dict(dtype=torch.bfloat16, device=device)
  scratch = (torch.empty((ns1, B, 2 * H), **f32),
             torch.empty((B, 2 * H), **bf16),
             torch.empty((ns2, B, D), **f32),
             torch.empty((B, D), **bf16))
  return (ns1, ns2), scratch


def _stream(device):
  return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptrs(tensors):
  return [ctypes.c_void_p(x.data_ptr()) for x in tensors]


@functools.cache
def _entry():
  return build.bind(
      build.library('blockgru'), 'blockgru_core_step', 20,
      [ctypes.c_int] * 8 + [ctypes.c_float])


def launch(deter, stoch_flat, actfeat, params, eps=1e-4):
  """Run the CUDA kernel on CUDA tensors (no counting, no dispatch)."""
  p = dict(zip(FIELDS, params))
  g, dg, _ = p['wblk'].shape
  B, D = deter.shape
  H, S, A = p['w0'].shape[1], stoch_flat.shape[1], actfeat.shape[1]
  device = check_inputs(
      dict(deter=deter, stoch=stoch_flat, act=actfeat, **p),
      shapes(B, D, H, S, A, g))
  out = torch.empty((B, D), dtype=deter.dtype, device=device)
  ns, scratch = core_scratch(B, D, H, S, A, g, device)
  with torch.cuda.device(device):
    code = _entry()(
        *_ptrs([deter, stoch_flat, actfeat, *params, out, *scratch]),
        B, D, H, S, A, g, *ns, eps, _stream(device))
  build.check(code, 'blockgru_core_step')
  return out


def core_step(deter, stoch_flat, actfeat, params, eps=1e-4):
  """One core step. CPU tensors take `reference_step`; CUDA tensors launch
  the kernel (bf16 only) and raise on what it does not take."""
  if deter.device.type == 'cpu':
    return reference_step(deter, stoch_flat, actfeat, params, eps)
  out = launch(deter, stoch_flat, actfeat, params, eps)
  core_step.launches += 1
  return out


core_step.launches = 0


def work(B, D, H, S, A, g, L=0, K=0):
  """Bytes the step must move (inputs read once, outputs written once) and
  its flops, for the bound on the card. L and K > 0 add the posterior
  head of ops/observe.py."""
  dg = D // g
  weights = D * H + S * H + g * dg * dg + (2 * H + A) * D + g * dg * 3 * dg
  vectors = 2 * H + D + 3 * D          # biases, bf16
  scales = 2 * H + D                   # norm scales, f32
  acts = B * (D + S + A) + B * D       # inputs and the new deter, bf16
  if L:
    weights += (D + K) * H + H * L
    vectors += H + L
    scales += H
    acts += B * K + B * L
  nbytes = 2 * (weights + vectors + acts) + 4 * scales
  flops = 2 * B * weights
  return nbytes, flops
