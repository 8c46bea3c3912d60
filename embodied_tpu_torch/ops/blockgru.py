"""One block-diagonal GRU core step: CUDA kernels for its forward and
backward, and their plain versions.

Replaces the Pallas TPU kernels embodied_tpu/ops/blockgru.py:
fused_core_step and fused_core_bwd. The kernels live in csrc/blockgru.cu
(the forward's stages in csrc/blockgru_common.cuh, the backward's in
csrc/seq_common.cuh, shared with the observe window), whose notes give
what bounds them on an H100 (weight bytes at acting batch) and what the
design does about that.

`core_step` is the wrapper: a CPU or meta tensor takes the plain version
`reference_step`, which autograd differentiates; a CUDA tensor launches
the forward kernel or raises. Where autograd needs the step's gradient,
the call runs a `torch.autograd.Function` that keeps the inputs and whose
backward calls `core_step_bwd`, which launches the backward kernel (plain
version `reference_step_bwd`, autograd of `reference_step`). Without a
gradient to take (under torch.no_grad, or on inputs that need none) the
kernel runs alone and keeps nothing. Each wrapper counts its launches in
`.launches`, and while the profiler records, each launch runs in a
profiler range named after its wrapper (`timer.range`), by which a trace
of the card counts them.

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
from ..utils import timer

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


def takes_plain(x):
  """Whether a wrapper called on `x` takes its plain version: `x` lies on
  the CPU, or on the meta device, where tensors have shapes only and
  `parallel.flops` counts the plain version's products. A CUDA tensor
  launches the kernel."""
  return x.device.type in ('cpu', 'meta')


def needs_grad(*tensors):
  """Whether autograd will ask for the gradient of a call on `tensors`."""
  return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def check_inputs(named, want, tile=16, floats=(), int8s=()):
  """Raise unless every tensor lies on one CUDA device, is contiguous and
  has the expected shape and dtype (float32 for the norm scales in SCALES
  and the names in `floats`, int8 for the names in `int8s`, bf16 for the
  rest), and the widths fit the kernel's 16-column tiles."""
  device = next(iter(named.values())).device
  for name, x in named.items():
    if x.device != device or x.device.type != 'cuda':
      raise ValueError(f'{name} on {x.device}, expected one CUDA device')
    dtype = (torch.float32 if name in SCALES or name in floats else
             torch.int8 if name in int8s else torch.bfloat16)
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


def _stream(device):
  return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptrs(tensors):
  return [ctypes.c_void_p(x.data_ptr()) for x in tensors]


def _pointers(tensors):
  """A C array of the tensors' device pointers, and a pointer to it; keep
  the array alive until the call returns."""
  array = (ctypes.c_void_p * len(tensors))(*[x.data_ptr() for x in tensors])
  return array, ctypes.cast(array, ctypes.c_void_p)


def _sms(device):
  return torch.cuda.get_device_properties(device).multi_processor_count


def workspace(lib, symbol, ints, device):
  """The byte workspace the C entry point carves its scratch from, sized
  by its `<symbol>` query on the same integer arguments."""
  fn = getattr(lib, symbol)
  fn.argtypes = [ctypes.c_int] * len(ints)
  fn.restype = ctypes.c_size_t
  return torch.empty(fn(*ints), dtype=torch.uint8, device=device)


@functools.cache
def _lib():
  lib = build.library('blockgru')
  build.bind(lib, 'blockgru_core_step', 6,
             [ctypes.c_int] * 7 + [ctypes.c_float])
  build.bind(lib, 'blockgru_core_bwd', 10,
             [ctypes.c_int] * 7 + [ctypes.c_float])
  build.bind(lib, 'blockgru_stage_product', 7, [ctypes.c_int] * 9)
  build.bind(lib, 'blockgru_stage_wgrad', 3, [ctypes.c_int] * 4)
  build.bind(lib, 'blockgru_stage_product128', 6, [ctypes.c_int] * 9)
  return lib


def check_widths(**widths):
  """Raise unless each width fits the kernels' 16-byte loads and 16-column
  tiles."""
  for name, width in widths.items():
    if width % 16:
      raise ValueError(f'{name} width {width} is not a multiple of 16')


def launch(deter, stoch_flat, actfeat, params, eps=1e-4):
  """Run the CUDA kernel on CUDA tensors (no counting, no dispatch)."""
  p = dict(zip(FIELDS, params))
  g, dg, _ = p['wblk'].shape
  B, D = deter.shape
  H, S, A = p['w0'].shape[1], stoch_flat.shape[1], actfeat.shape[1]
  device = check_inputs(
      dict(deter=deter, stoch=stoch_flat, act=actfeat, **p),
      shapes(B, D, H, S, A, g))
  check_widths(stoch=S, action=A)
  out = torch.empty((B, D), dtype=deter.dtype, device=device)
  lib = _lib()
  ints = [B, D, H, S, A, g, _sms(device)]
  ws = workspace(lib, 'blockgru_core_workspace', ints, device)
  array, pp = _pointers(params)
  with torch.cuda.device(device):
    code = lib.blockgru_core_step(
        *_ptrs([deter, stoch_flat, actfeat]), pp, *_ptrs([out, ws]), *ints,
        eps, _stream(device))
  del array
  build.check(code, 'blockgru_core_step')
  return out


def reference_step_bwd(deter, stoch_flat, actfeat, params, dout, eps=1e-4):
  """Plain version of the backward: autograd of `reference_step`. Returns
  (ddeter, dstoch, dact, dparams), each in its input's dtype."""
  with torch.enable_grad():
    ins = [x.detach().requires_grad_() for x in (
        deter, stoch_flat, actfeat, *params)]
    out = reference_step(ins[0], ins[1], ins[2], ins[3:], eps)
    grads = torch.autograd.grad(out, ins, dout.to(out.dtype))
  return grads[0], grads[1], grads[2], tuple(grads[3:])


def launch_bwd(deter, stoch_flat, actfeat, params, dout, eps=1e-4):
  """Run the backward kernel on CUDA tensors (no counting, no dispatch).
  `dout` may come in any float dtype."""
  p = dict(zip(FIELDS, params))
  g, dg, _ = p['wblk'].shape
  B, D = deter.shape
  H, S, A = p['w0'].shape[1], stoch_flat.shape[1], actfeat.shape[1]
  dout = dout.float().contiguous()
  want = dict(shapes(B, D, H, S, A, g), dout=(B, D))
  device = check_inputs(
      dict(deter=deter, stoch=stoch_flat, act=actfeat, dout=dout, **p), want,
      floats=('dout',))
  check_widths(stoch=S, action=A, block=dg)
  ddeter = torch.empty_like(deter)
  dstoch = torch.empty_like(stoch_flat)
  dact = torch.empty_like(actfeat)
  dparams = [torch.empty_like(x) for x in params]
  lib = _lib()
  ints = [B, D, H, S, A, g, _sms(device)]
  ws = workspace(lib, 'blockgru_core_bwd_workspace', ints, device)
  array, pp = _pointers(params)
  garray, gp = _pointers(dparams)
  with torch.cuda.device(device):
    code = lib.blockgru_core_bwd(
        *_ptrs([deter, stoch_flat, actfeat]), pp,
        *_ptrs([dout, ddeter, dstoch, dact]), gp, *_ptrs([ws]), *ints, eps,
        _stream(device))
  del array, garray
  build.check(code, 'blockgru_core_bwd')
  return ddeter, dstoch, dact, tuple(dparams)


def core_step_bwd(deter, stoch_flat, actfeat, params, dout, eps=1e-4):
  """The step's backward for the upstream gradient `dout` of the new
  deter: (ddeter, dstoch, dact, dparams), weight gradients in the weight
  dtype and norm-scale gradients in float32. CPU tensors take
  `reference_step_bwd`; CUDA tensors launch the kernel and raise on what
  it does not take."""
  if takes_plain(deter):
    return reference_step_bwd(deter, stoch_flat, actfeat, params, dout, eps)
  with timer.range('core_step_bwd'):
    out = launch_bwd(deter, stoch_flat, actfeat, params, dout, eps)
  core_step_bwd.launches += 1
  return out


core_step_bwd.launches = 0


class _CoreStep(torch.autograd.Function):
  """The forward kernel, with the backward kernel as its gradient."""

  @staticmethod
  def forward(ctx, deter, stoch_flat, actfeat, eps, *params):
    ctx.save_for_backward(deter, stoch_flat, actfeat, *params)
    ctx.eps = eps
    return launch(deter, stoch_flat, actfeat, params, eps)

  @staticmethod
  def backward(ctx, dout):
    deter, stoch_flat, actfeat, *params = ctx.saved_tensors
    ddeter, dstoch, dact, dparams = core_step_bwd(
        deter, stoch_flat, actfeat, params, dout, ctx.eps)
    return (ddeter, dstoch, dact, None, *dparams)


def core_step(deter, stoch_flat, actfeat, params, eps=1e-4):
  """One core step. CPU tensors take `reference_step`; CUDA tensors launch
  the kernel (bf16 only), and the backward kernel when autograd asks for
  gradients, and raise on what the kernels do not take."""
  if takes_plain(deter):
    return reference_step(deter, stoch_flat, actfeat, params, eps)
  with timer.range('core_step'):
    if needs_grad(deter, stoch_flat, actfeat, *params):
      out = _CoreStep.apply(deter, stoch_flat, actfeat, eps, *params)
    else:
      out = launch(deter, stoch_flat, actfeat, params, eps)
  core_step.launches += 1
  return out


core_step.launches = 0


def work(B, D, H, S, A, g, L=0, K=0):
  """Bytes the step must move (inputs read once, outputs written once) and
  its flops, for the bound on the card. L and K > 0 add the posterior
  head of ops/observe.py.
  This is the kernel's roofline count; `Agent.train_cost` counts the
  plain version's products instead (parallel/flops.py)."""
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


def work_bwd(B, D, H, S, A, g, L=0, K=0):
  """Bytes and flops of the backward: it reads the forward's inputs, the
  weights and the f32 upstream gradients, writes the input and weight
  gradients (norm scales in f32), and does three times the forward's
  products (the recompute, the input and the weight gradients). L and
  K > 0 add the posterior head.
  This is the kernel's roofline count, recompute included;
  `Agent.train_cost` counts the plain version's products instead,
  whose backward recomputes nothing (parallel/flops.py)."""
  nbytes, flops = work(B, D, H, S, A, g, L, K)
  outs = B * D + B * L                     # the forward's outputs, bf16
  weights = nbytes - 2 * (B * (D + S + A + K) + outs)
  ins = 2 * B * (D + S + A + K) + 4 * (B * D + B * L)
  return 2 * weights + ins + 2 * B * (D + S + A + K), 3 * flops


def reference_stage_product(x, w, trans=False, scale=None, x2=None,
                            w2=None, scale2=None):
  """Plain version of `stage_product`, in float32 on the bf16-rounded
  operands (int8 weights are exact in bf16): (B, N)."""
  g = w.shape[0]
  B = x.shape[0]
  x = x.to(torch.bfloat16).float().reshape(B, g, -1)
  w = w.float().transpose(1, 2) if trans else w.float()
  out = torch.einsum('bgk,gkn->bgn', x, w).reshape(B, -1)
  if scale is not None:
    out = out * scale.reshape(-1).float()
  if x2 is not None:
    out2 = x2.to(torch.bfloat16).float() @ w2.float()
    out = out + (out2 if scale2 is None else out2 * scale2.float())
  return out


def stage_product(x, w, trans=False, splits=0, scale=None, x2=None, w2=None,
                  scale2=None):
  """The 16-row tensor-core product of csrc/blockgru_common.cuh on its own,
  for the card tests and the smoke run. Block-diagonal in g = w.shape[0]
  groups: x (B, g K) bf16 against w (g, K, N / g), plus x2 (B, K2) bf16
  dense against w2 (K2, N) where given (as the hidden layer's x against
  win). w and w2 are bf16, or int8 with their float32 column scales
  `scale` ((N,) or (g, N / g), by flat column) and `scale2` (N,). With
  `trans`, x is float32 (rounded to bf16 as the backward stages it)
  against bf16 w (g, N / g, K) transposed, and no second segment. Returns
  the split partials (ns, B, N) in float32; `splits` <= 0 takes the
  stage's own split count."""
  g = w.shape[0]
  B, gK = x.shape
  K = w.shape[2] if trans else w.shape[1]
  N = g * (w.shape[1] if trans else w.shape[2])
  K2 = 0 if x2 is None else x2.shape[1]
  int8 = w.dtype == torch.int8
  if x.dtype != (torch.float32 if trans else torch.bfloat16):
    raise TypeError(f'x has dtype {x.dtype}')
  if w.dtype not in (torch.bfloat16, torch.int8) or gK != g * K:
    raise ValueError(f'x {tuple(x.shape)} does not fit w {tuple(w.shape)} '
                     f'{w.dtype}')
  if trans and (int8 or x2 is not None):
    raise ValueError('the transposed product takes bf16 w, one segment')
  if x2 is not None and (x2.dtype != torch.bfloat16 or x2.shape[0] != B or
                         w2.dtype != w.dtype or w2.shape != (K2, N)):
    raise ValueError(f'x2 {tuple(x2.shape)} does not fit w2 '
                     f'{tuple(w2.shape)} {w2.dtype}')
  for name, t in dict(x=x, w=w, scale=scale, x2=x2, w2=w2,
                      scale2=scale2).items():
    if t is not None and (t.device != x.device or x.device.type != 'cuda'):
      raise ValueError(f'{name} on {t.device}, expected one CUDA device')
  scales = [s for s in (scale, scale2) if s is not None]
  if len(scales) != int8 * (1 + (x2 is not None)) or any(
      s.dtype != torch.float32 or s.numel() != N for s in scales):
    raise ValueError('int8 weights take float32 column scales, one for '
                     'each of their N columns; bf16 weights none')
  check_widths(depth=K, columns=N // g, depth2=K2)
  device = x.device
  lib = _lib()
  sms = _sms(device)
  # Every split writes its part (an empty one zeros).
  most = max(splits, -(-(K + K2) // 64))
  out = torch.empty((most, B, N), dtype=torch.float32, device=device)
  tensors = [t if t is None else t.contiguous()
             for t in (x, w, scale, x2, w2, scale2)]
  ptrs = [ctypes.c_void_p(None if t is None else t.data_ptr())
          for t in tensors]
  with torch.cuda.device(device):
    ns = lib.blockgru_stage_product(
        *ptrs, ctypes.c_void_p(out.data_ptr()), int(trans), int(int8), B, N,
        K, K2, g, splits, sms, _stream(device))
  build.check(max(-ns, 0), 'blockgru_stage_product')
  return out[:ns]


def reference_stage_product128(x, w, x2=None, w2=None, bias=None,
                               out_dtype=torch.float32):
  """Plain version of `stage_product128`: float32 sums of the bf16
  operands' products, plus the bias, in `out_dtype`: (B, N)."""
  g = w.shape[0]
  B = x.shape[0]
  out = torch.einsum('bgk,gkn->bgn', x.float().reshape(B, g, -1),
                     w.float()).reshape(B, -1)
  if x2 is not None:
    out = out + x2.float() @ w2.float()
  if bias is not None:
    out = out + bias.float()
  return out.to(out_dtype)


def stage_product128(x, w, x2=None, w2=None, bias=None,
                     out_dtype=torch.float32, splits=0):
  """The 128-row tensor-core product of csrc/blockgru_common.cuh
  (tc128_kernel) on its own, for the card tests and the smoke run: x
  (B, g K) block-diagonal against w (g, K, N / g), plus x2 (B, K2) dense
  against w2 (K2, N) where given, plus bias (N) (bf16 or float32) where
  given; all bf16 but the bias, on one CUDA device. Returns the split
  partials (ns, B, N) in float32 (`splits` <= 0 takes the stage's own
  count), or with `out_dtype` bf16 the finished product (1, B, N). Raises
  on what the stage does not take: fewer than 128 rows, widths and depths
  not multiples of 8."""
  g, K, gN = w.shape
  B = x.shape[0]
  N = g * gN
  K2 = 0 if x2 is None else x2.shape[1]
  named = dict(x=x, w=w) if x2 is None else dict(x=x, w=w, x2=x2, w2=w2)
  for name, t in dict(named, bias=bias).items():
    if t is not None and (t.device != x.device or x.device.type != 'cuda'):
      raise ValueError(f'{name} on {t.device}, expected one CUDA device')
  for name, t in named.items():
    if t.dtype != torch.bfloat16:
      raise TypeError(f'{name} has dtype {t.dtype}, the stage takes bf16')
  if x.shape != (B, g * K) or (x2 is not None and (
      x2.shape[0] != B or w2.shape != (K2, N))):
    raise ValueError(f'x {tuple(x.shape)} does not fit w {tuple(w.shape)}')
  if B < 128:
    raise ValueError(f'{B} rows: the 128-row stage takes 128 or more')
  for name, width in dict(depth=K, depth2=K2, columns=gN).items():
    if width % 8:
      raise ValueError(f'{name} {width} is not a multiple of 8')
  if bias is not None and (bias.shape != (N,) or bias.dtype not in (
      torch.bfloat16, torch.float32)):
    raise ValueError(f'bias {tuple(bias.shape)} {bias.dtype} does not fit')
  if out_dtype == torch.bfloat16 and splits > 1:
    raise ValueError('a bf16 output is the finished product: one split')
  bf16_out = out_dtype == torch.bfloat16
  device = x.device
  sms = _sms(device)
  most = 1 if bf16_out else max(splits, -(-(K + K2) // 256), 1)
  out = torch.empty((most, B, N), dtype=out_dtype, device=device)
  tensors = [t.contiguous() if t is not None else None
             for t in (x, w, x2, w2, bias)]
  ptrs = [ctypes.c_void_p(t.data_ptr() if t is not None else None)
          for t in tensors]
  with torch.cuda.device(device):
    ns = _lib().blockgru_stage_product128(
        *ptrs, ctypes.c_void_p(out.data_ptr()),
        int(bias is not None and bias.dtype == torch.float32), int(bf16_out),
        B, N, K, K2, g, 1 if bf16_out else splits, sms, _stream(device))
  build.check(max(-ns, 0), 'blockgru_stage_product128')
  return out[:ns]


def reference_stage_wgrad(x, y, g=1):
  """Plain version of `stage_wgrad`: float32 sums of bf16 products."""
  R = x.shape[0]
  x = x.float().reshape(R, g, -1)
  y = y.to(torch.bfloat16).float().reshape(R, g, -1)
  return torch.einsum('rgm,rgn->gmn', x, y)


def stage_wgrad(x, y, g=1):
  """The weight-gradient GEMM of csrc/seq_common.cuh on its own, for the
  card tests: out[q] = x[:, q]^T bf16(y[:, q]) over all R rows, x (R, g M)
  bf16, y (R, g N) float32; returns (g, M, N) bf16."""
  R, gM = x.shape
  M, N = gM // g, y.shape[1] // g
  check_widths(rows=M, columns=N)
  out = torch.empty((g, M, N), dtype=torch.bfloat16, device=x.device)
  x, y = x.contiguous(), y.float().contiguous()
  with torch.cuda.device(x.device):
    code = _lib().blockgru_stage_wgrad(*_ptrs([x, y, out]), R, M, N, g,
                                       _stream(x.device))
  build.check(code, 'blockgru_stage_wgrad')
  return out
