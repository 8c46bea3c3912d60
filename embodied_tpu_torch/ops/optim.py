"""The optimizer's update once the flat gradient exists: a CUDA kernel pair
and its plain version.

Replaces no TPU kernel: the JAX package leaves the update
(embodied_tpu/nn/opt.py) to XLA, which fuses it. Run eagerly, the plain
version below is some 760 launches a DreamerV3 step and some 65 passes
over the parameters. On an H100 the update is bound by bytes: AGC's
per-leaf norms read the gradient and the parameters once (8 bytes a
parameter), and the update reads the gradient, the parameter and both
moments and writes the parameter and both moments once (28 bytes). The
kernels (csrc/optim.cu) move those 36 bytes a parameter, in float32, in
two launches over a segment table of the leaves:

- `norms`: each block sums g^2 and p^2 over one chunk of one leaf into
  float32 partials; the last block to finish adds each leaf's partials in
  chunk order (so repeated calls give the same bits), then forms AGC's
  factor per leaf, the totals, the loss scale's finite flag and new
  scale, the bias corrections at step + 1, and the step;
- `apply`: one pass over the elements: the clipped gradient, the RMS and
  momentum moments, weight decay where the leaf's flag says so, -lr, the
  parameter (only where the gradient is finite), and the update's squares
  in chunk partials that its last block adds in order.

The step, the learning rate, the loss scale and the finite flag stay on
the card: nothing here waits for it. The elementwise arithmetic rounds as
the plain version's operations do, one at a time; the norms and the
metrics' sums are taken in another order.

The table (`segments`) has one entry a leaf: its parameter, its RMS and
momentum slots, its offset into the flat gradient, its size, its first
chunk and its weight-decay flag. In the fused layout the slots are
offsets into `opt/rms_flat` and `opt/mom_flat`; with fused=False each
leaf's entry points at its own `opt/rms.<path>` and `opt/mom.<path>`.
It is built and copied to the card at every call (a sharded store
gathers its parameters anew each step). What lasts between calls is the
kernels' zeroed workspace, one an optimizer (`WORKSPACES`), which its
copies (a meta copy, the policy copy) do not share.

`update` is the wrapper: CPU and meta tensors take `reference_update`; a
CUDA tensor launches the kernels or raises on what they do not take. It
counts its calls in `update.launches`.
"""

import ctypes
import functools
import weakref

import numpy as np
import torch

from . import blockgru, build
from ..utils import timer

CHUNK = 8192  # elements a block takes (csrc/optim.cu CHUNK)
WORKSPACES = weakref.WeakKeyDictionary()  # {optimizer: its workspace}
FIELDS = ('p', 'nu', 'mu', 'offset', 'numel', 'chunk0', 'wd')  # a row
# The float32 outputs of the kernels beside the metrics they give.
OUTS = ('grad_norm', 'grad_rms', 'update_rms', 'param_rms', 'updates',
        'param_count', 'grad_scale', 'grad_overflow')


def _full(x, device):
  """A float32 scalar on `device`: a fill, not a copy from the host, which
  would wait for the card."""
  return torch.full((), x, dtype=torch.float32, device=device)


@torch.no_grad()
def reference_update(opt, paths, params, vec, loss):
  """Update `params` from their flat gradient `vec` (changed in place)."""
  metrics = {}
  finite = torch.ones((), dtype=torch.bool, device=loss.device)
  if opt.scaling:
    scale = opt.grad_scale.clone()
    loss = loss / scale
    vec.div_(scale)
    finite = torch.isfinite(vec.square().sum())
    good = opt.good_steps
    keep = finite & (good < 1000)
    incr = finite & (good >= 1000)
    opt.good_steps.copy_(torch.where(finite, good + 1, 0))
    opt.grad_scale.copy_(torch.clamp(torch.where(
        incr, scale * 2, torch.where(keep, scale, scale / 2)), 1e-4, 1e5))
    vec = torch.where(finite, vec, torch.zeros_like(vec))
    metrics['grad_scale'] = scale
    metrics['grad_overflow'] = (~finite).float()
  step = opt.step.float()
  lr = opt._lr(step)
  gsq = vec.square().sum()
  if opt.agc:
    offset = 0
    for param in params:
      update = vec[offset:offset + param.numel()]
      offset += param.numel()
      unorm = torch.linalg.vector_norm(update)
      pnorm = torch.linalg.vector_norm(param)
      upper = opt.agc * torch.clamp(pnorm, min=opt.pmin)
      update.mul_(1 / torch.clamp(unorm / upper, min=1.0))
  if opt.fused:
    pvec = torch.cat([p.reshape(-1) for p in params])
    vec = _moments(
        opt, opt.rms_flat, opt.mom_flat if opt.momentum else None, vec, step)
    if opt.wd:
      mask = torch.cat([
          torch.full((p.numel(),), float(bool(opt.wdpattern.search(k))),
                     device=vec.device) for k, p in zip(paths, params)])
      vec = vec + opt.wd * mask * pvec
    vec = -lr * vec
    new = torch.where(finite, pvec + vec, pvec)
    offset = 0
    for param in params:
      param.copy_(new[offset:offset + param.numel()].reshape(param.shape))
      offset += param.numel()
    usq, psq = vec.square().sum(), pvec.square().sum()
  else:
    usq = psq = 0.0
    offset = 0
    for path, param in zip(paths, params):
      update = vec[offset:offset + param.numel()].reshape(param.shape)
      offset += param.numel()
      update = _moments(
          opt, opt.slot('rms', path),
          opt.slot('mom', path) if opt.momentum else None, update, step)
      if opt.wd and opt.wdpattern.search(path):
        update = update + opt.wd * param
      update = -lr * update
      usq = usq + update.square().sum()
      psq = psq + param.square().sum()
      param.copy_(torch.where(finite, param + update, param))
  opt.step.add_(finite.int())
  count = vec.numel()
  metrics.update(
      loss=loss, updates=step + 1, grad_norm=torch.sqrt(gsq),
      grad_rms=torch.sqrt(gsq / count),
      update_rms=torch.sqrt(usq / count),
      param_rms=torch.sqrt(psq / count),
      param_count=_full(count, vec.device), lr=lr)
  return metrics


def _moments(opt, nu, mu, update, step):
  """The RMS moment `nu` and the momentum `mu` (or None) updated in place
  from `update`, and the update they give, bias-corrected."""
  nu.copy_(opt.beta2 * nu + (1 - opt.beta2) * update.square())
  nu_hat = nu / (1 - _full(opt.beta2, nu.device) ** (step + 1))
  update = update / (torch.sqrt(nu_hat) + opt.eps)
  if mu is None:
    return update
  mu.copy_(opt.beta1 * mu + (1 - opt.beta1) * update)
  if opt.nesterov:
    mu = opt.beta1 * mu + (1 - opt.beta1) * update
  return mu / (1 - _full(opt.beta1, nu.device) ** (step + 1))


class Segments:
  """The segment table of one call: `rows`, one a leaf in FIELDS order
  (the addresses of the parameter, its RMS slot and its momentum slot, 0
  without momentum; the leaf's offset into the flat gradient, its size,
  its first chunk and its weight-decay flag), and `chunks`, the blocks of
  each kernel. A block finds its leaf in the rows."""

  def __init__(self, rows, chunks):
    self.rows, self.chunks = rows, chunks

  def packed(self):
    """The int64 array the kernels read: the rows padded to 8 fields
    (csrc/optim.cu Leaf)."""
    host = np.zeros((len(self.rows), 8), np.int64)
    host[:, :len(FIELDS)] = self.rows
    return host.reshape(-1)


def slots(opt, paths, params):
  """Each leaf's (RMS slot, momentum slot or None, the leaf's element
  offset in them): the flat moments at the leaf's offset in the fused
  layout, the leaf's own slots at 0 with fused=False."""
  if not opt.fused:
    return [(opt.slot('rms', path),
             opt.slot('mom', path) if opt.momentum else None, 0)
            for path in paths]
  rms, mom = opt.rms_flat, opt.mom_flat if opt.momentum else None
  out, offset = [], 0
  for param in params:
    out.append((rms, mom, offset))
    offset += param.numel()
  return out


def segments(opt, paths, params, vec):
  """The segment table of `params` (at `paths`, the optimizer's sorted
  leaves) over the flat gradient `vec`, after checking every tensor the
  kernels read: float32 (the step and good steps int32), contiguous, on
  vec's device, and of the sizes the layout gives. Raises on any other."""
  device = vec.device
  named = [('vec', vec), ('step', opt.step)]
  if opt.scaling:
    named += [('grad_scale', opt.grad_scale), ('good_steps', opt.good_steps)]
  for name, x in named:
    dtype = torch.int32 if name in ('step', 'good_steps') else torch.float32
    _check(name, x, device, dtype)
  if vec.dim() != 1:
    raise ValueError(f'vec has shape {tuple(vec.shape)}, not flat')
  leaves = slots(opt, paths, params)
  checked = set()
  rows, offset, chunk = [], 0, 0
  for path, param, (nu, mu, at) in zip(paths, params, leaves):
    n = param.numel()
    _check(path, param, device)
    for kind, slot in (('rms', nu), ('mom', mu)):
      if slot is None or id(slot) in checked:
        continue
      _check(f'{kind} slot of {path}', slot, device)
      want = vec.numel() if opt.fused else n
      if slot.numel() != want:
        raise ValueError(f'the {kind} slot of {path} holds {slot.numel()} '
                         f'elements, not {want}')
      if opt.fused:
        checked.add(id(slot))
    wd = bool(opt.wd) and bool(opt.wdpattern.search(path))
    rows.append((param.data_ptr(), nu.data_ptr() + 4 * at,
                 0 if mu is None else mu.data_ptr() + 4 * at, offset, n,
                 chunk, int(wd)))
    offset += n
    chunk += -(-n // CHUNK)
  if vec.numel() != offset:
    raise ValueError(f'vec holds {vec.numel()} elements, the parameters '
                     f'{offset}')
  return Segments(rows, chunk)


def _check(name, x, device, dtype=torch.float32):
  if x.device != device:
    raise ValueError(f'{name} on {x.device}, expected {device}')
  if x.dtype != dtype:
    raise TypeError(f'{name} has dtype {x.dtype}, the kernels take {dtype}')
  if not x.is_contiguous():
    raise ValueError(f'{name} is not contiguous')


@functools.cache
def _lib():
  lib = build.library('optim')
  build.bind(lib, 'optim_update', 8,
             [ctypes.c_int] * 6 + [ctypes.c_longlong] + [ctypes.c_float] * 8)
  fn = lib.optim_workspace
  fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_size_t
  return lib


def _workspace(opt, table, device):
  """The kernels' workspace for `table` on the optimizer `opt`: zeros
  when made, and the kernels leave their counters at 0."""
  size = _lib().optim_workspace(len(table.rows), table.chunks)
  ws = WORKSPACES.get(opt)
  if ws is None or ws.device != device or ws.numel() != size:
    ws = WORKSPACES[opt] = torch.zeros(size, dtype=torch.uint8, device=device)
  return ws


def launch(opt, paths, params, vec, loss):
  """Run the kernel pair on CUDA tensors (no counting, no dispatch).
  Returns the metrics `reference_update` returns."""
  device = vec.device
  if device.type != 'cuda':
    raise ValueError(f'vec on {device}, expected a CUDA device')
  table = segments(opt, paths, params, vec)
  workspace = _workspace(opt, table, device)
  lib = _lib()
  lr = opt._lr(opt.step.float())
  out = torch.empty(len(OUTS), dtype=torch.float32, device=device)
  # From pinned memory: no wait for the card.
  rows = torch.from_numpy(table.packed()).pin_memory().to(
      device, non_blocking=True)
  scale = (opt.grad_scale, opt.good_steps) if opt.scaling else (None, None)
  null = ctypes.c_void_p(0)
  ptr = lambda x: null if x is None else ctypes.c_void_p(x.data_ptr())
  with torch.cuda.device(device):
    code = lib.optim_update(
        ptr(rows), ptr(vec), ptr(lr), ptr(opt.step),
        ptr(scale[0]), ptr(scale[1]), ptr(workspace), ptr(out),
        len(table.rows), table.chunks, int(bool(opt.momentum)),
        int(bool(opt.nesterov)), int(bool(opt.scaling)), int(bool(opt.agc)),
        vec.numel(),
        opt.agc, opt.pmin, opt.beta1, opt.beta2, 1 - opt.beta1,
        1 - opt.beta2, opt.eps, opt.wd, blockgru._stream(device))
  build.check(code, 'optim_update')
  got = dict(zip(OUTS, out))
  metrics = {}
  if opt.scaling:
    metrics.update(grad_scale=got['grad_scale'],
                   grad_overflow=got['grad_overflow'])
    loss = loss / got['grad_scale']
  metrics.update(loss=loss, updates=got['updates'],
                 **{k: got[k] for k in OUTS[:4]},
                 param_count=got['param_count'], lr=lr)
  return metrics


@torch.no_grad()
def update(opt, paths, params, vec, loss):
  """The optimizer `opt`'s update of `params` (at `paths`) from their flat
  float32 gradient `vec`, which it may change. Returns the metrics. CPU
  and meta tensors take the plain version; CUDA tensors launch the kernel
  pair and raise on what it does not take."""
  if blockgru.takes_plain(vec):
    return reference_update(opt, paths, params, vec, loss)
  with timer.range('opt_update'):
    metrics = launch(opt, paths, params, vec, loss)
  update.launches += 1
  return metrics


update.launches = 0


def work(count):
  """Bytes the update must move for `count` float32 parameters and the
  bound's operations (none on the tensor cores): the norms read the
  gradient and the parameters, the update reads the gradient, the
  parameters and both moments and writes the three back."""
  return 36 * count, 0
