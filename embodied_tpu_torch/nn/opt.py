"""Optimizer with adaptive gradient clipping, RMS scaling and momentum.

Counterpart of embodied_tpu/nn/opt.py in both its slot layouts. In the
default (fused) one the two moments are flat float32 vectors,
`opt/rms_flat` and `opt/mom_flat`, over the trained parameters in sorted
path order, beside `opt/step`. With `fused=False` each parameter has its
own slots of its shape, `opt/rms.<path>` and `opt/mom.<path>` (the path's
'/' as '.'), as in JAX. The port keeps them as buffers in the same layout,
so a JAX checkpoint resumes with its moments. Per step, as JAX: AGC per
parameter, the RMS and momentum updates with bias correction over the
flat vectors or per parameter, weight decay on paths
matching a regex, the warmup and const/linear/cosine schedules, and, when
the compute dtype is float16, dynamic loss scaling that skips steps whose
gradients overflow. Parameters are updated in place under no_grad, after
the loss's own state updates (normalizers), which happen in place during
the loss. The update after the flat gradient is ops/optim.py's: a kernel
pair on the card, its plain version on the CPU.

Under a data group (`reduce_over`, which the Agent sets around a train
step on a mesh; JAX's `DATA_AXES` under shard_map), each rank's gradients
are averaged over the group as one flat float32 buffer, before the loss
scale's finite check and AGC's per-parameter norms, as in JAX.
`group_mean`, `group_min`, `group_max` and `group_cat` reduce other
values over the same group (the normalizers, the batch diagnostics). The
data group spans ('d','f') only: ranks along 't' compute the same rows
and are never averaged with each other, which would divide their
gradient twice.

In both layouts the gradients cross the data group as that one flat
buffer, which the per-parameter update then reads in slices.

Under a split over the mesh's 't' ranks (parallel/tensor.py), a split
entry's gradient is right only in the rank's part of its last dimension:
the part's product ran on this rank alone, and a whole use of the same
weight (a kernel's wrapper, which reads it in full) gave the same
gradient on every 't' rank. Every other entry's gradient is whole and
the same on every 't' rank. Before the data group's all-reduce, the loss
scale's check and AGC's norms, each rank keeps its parts and, at 't'
index 0 only, the other entries, zeroes the rest of the flat buffer, and
one all-reduce over 't' joins it: the parts side by side, the other
entries as the first 't' rank has them (summed over 't' they would count
t times).

On a sharded store (parallel/agent.py) the update sees the full
parameters, which the Agent gathers before the step: the flat moments stay
replicated, as in the JAX fused layout, and the per-parameter slots take
their parameter's placement (meshes.resolve_rules, as JAX's rules place
them) and are gathered whole with it, so every rank updates whole slots
and every parameter, and AGC's norms are taken on full tensors, as in
JAX; the Agent then keeps each rank's slices.
"""

import contextlib
import math
import re

import torch
import torch.distributed as dist

from . import core
from ..ops import optim
from ..utils import timer

# The process group that a train step's batch rows are split over, or
# None: parallel.meshes.data_group, set by the Agent through reduce_over.
DATA_GROUP = [None]


@contextlib.contextmanager
def reduce_over(group):
  """Reduce gradients, normalizer statistics and batch diagnostics over
  `group` (None: no reduction) within the block."""
  previous, DATA_GROUP[0] = DATA_GROUP[0], group
  try:
    yield
  finally:
    DATA_GROUP[0] = previous


def _reduce(x, op):
  x = x.detach().clone()
  dist.all_reduce(x, op, group=DATA_GROUP[0])
  return x


def group_mean(x):
  """The mean of `x` over the data group's ranks (`x` itself without
  one); ranks hold equal numbers of rows."""
  if DATA_GROUP[0] is None:
    return x
  return _reduce(x, dist.ReduceOp.SUM) / dist.get_world_size(DATA_GROUP[0])


def group_min(x):
  return x if DATA_GROUP[0] is None else _reduce(x, dist.ReduceOp.MIN)


def group_max(x):
  return x if DATA_GROUP[0] is None else _reduce(x, dist.ReduceOp.MAX)


def group_cat(x):
  """Every rank's `x` (equal shapes) concatenated on the first axis in
  rank order (`x` itself without a data group)."""
  group = DATA_GROUP[0]
  if group is None:
    return x
  x = x.detach().contiguous()
  parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
  dist.all_gather(parts, x, group=group)
  return torch.cat(parts, 0)


def join_parts(vec, paths, params, split):
  """The flat gradient `vec` of `params` (at `paths`) joined over the
  split's 't' group in place (see the module's docstring)."""
  if not split.paths.intersection(paths):
    return
  offset = 0
  for path, param in zip(paths, params):
    view = vec[offset:offset + param.numel()].view(param.shape)
    offset += param.numel()
    if path in split.paths:
      start, width = split.part(param.shape[-1])
      view[..., :start] = 0
      view[..., start + width:] = 0
    elif split.index:
      view.zero_()
  if vec.device.type != 'meta':
    dist.all_reduce(vec, group=split.group)


def scope_params(root, scopes):
  """The trained parameters of `root` under the store scopes `scopes`
  (paths such as 'worker/actor'), as {path: parameter}: what the JAX
  Optimizer's scope list selects."""
  out = {}
  for name, param in root.named_parameters():
    path = name.replace('.', '/')
    if param.requires_grad and any(
        path == s or path.startswith(s + '/') for s in scopes):
      out[path] = param
  return out


class Optimizer(core.Module):

  def __init__(
      self, params, name='opt', lr=4e-5, agc=0.3, eps=1e-20, beta1=0.9,
      beta2=0.999, momentum=True, nesterov=False, wd=0.0, wdregex=r'/kernel$',
      schedule='const', warmup=1000, anneal=0, pmin=1e-3, fused=True,
      scaling=False, **unused):
    """`params` maps store paths to the trained parameters."""
    super().__init__(name)
    assert params, 'no trainable parameters'
    self.fused = fused
    # Plain references: the model registers the parameters.
    self.__dict__['params'] = dict(sorted(params.items()))
    self.lr = lr
    self.agc = agc
    self.eps = eps
    self.beta1 = beta1
    self.beta2 = beta2
    self.momentum = momentum
    self.nesterov = nesterov
    self.wd = wd
    self.wdpattern = re.compile(wdregex) if wd else None
    self.schedule = schedule
    self.warmup = warmup
    self.anneal = anneal
    self.pmin = pmin
    self.scaling = scaling
    self.state('step', (), 0, torch.int32)
    if scaling:
      self.state('grad_scale', (), 1e4)
      self.state('good_steps', (), 0, torch.int32)
    if fused:
      total = sum(p.numel() for p in self.params.values())
      self.state('rms_flat', (total,), 0.0)
      if momentum:
        self.state('mom_flat', (total,), 0.0)
      return
    for path, param in self.params.items():
      self.state(self._slot('rms', path), param.shape, 0.0)
      if momentum:
        self.state(self._slot('mom', path), param.shape, 0.0)

  @staticmethod
  def _slot(kind, path):
    """A parameter's slot name under JAX's per-parameter layout."""
    return f'{kind}.{path.replace("/", ".")}'

  def slot(self, kind, path):
    """The `kind` ('rms' or 'mom') slot buffer of the parameter at `path`
    (fused=False)."""
    return getattr(self, self._slot(kind, path).replace('.', core.NAME_DOT))

  def forward(self, lossfn, *args, **kwargs):
    """Runs `lossfn(*args, **kwargs) -> (loss, aux)`, differentiates the
    float32 scalar loss with respect to the parameters, and updates them.
    Returns (metrics, aux). The three phases run in the timer's sections
    `train/loss`, `train/backward` (the gradients, their flat buffer and
    its joins over 't' and the data group) and `train/update`."""
    with timer.section('train/loss'):
      loss, aux = lossfn(*args, **kwargs)
    assert loss.dtype == torch.float32 and loss.shape == (), (
        loss.dtype, loss.shape)
    paths = list(self.params)
    params = [self.params[k] for k in paths]
    with timer.section('train/backward'):
      scaled = loss * self.grad_scale if self.scaling else loss
      grads = torch.autograd.grad(scaled, params, allow_unused=True)
      # One flat float32 buffer: the data group's all-reduce, the loss
      # scale's check and AGC work on it in place.
      vec = torch.cat([
          torch.zeros(p.numel(), device=p.device) if g is None
          else g.reshape(-1).float() for p, g in zip(params, grads)])
      del grads
      split = core.SPLIT.active
      if split is not None:
        join_parts(vec, paths, params, split)
      group = DATA_GROUP[0]
      if group is not None:
        dist.all_reduce(vec, group=group)
        vec.div_(dist.get_world_size(group))
    with timer.section('train/update'):
      metrics = self._update(paths, params, vec, loss.detach())
    return {f'{self.name}/{k}': v for k, v in metrics.items()}, aux

  def _update(self, paths, params, vec, loss):
    """Update `params` from their flat gradient `vec` (which it may change)
    and return the metrics: ops/optim.py, its kernel pair on the card."""
    return optim.update(self, paths, params, vec, loss)

  def _lr(self, step):
    lr = self.lr
    if self.schedule == 'const':
      sched = torch.full_like(step, lr)
    elif self.schedule in ('linear', 'cosine'):
      frac = torch.clamp(
          (step - self.warmup) / max(1, self.anneal - self.warmup), 0, 1)
      if self.schedule == 'linear':
        sched = lr * (1 - 0.9 * frac)
      else:
        sched = 0.1 * lr + 0.45 * lr * (1 + torch.cos(math.pi * frac))
    else:
      raise NotImplementedError(self.schedule)
    if self.warmup:
      ramp = torch.clamp(step / self.warmup, 0, 1)
      sched = torch.where(step < self.warmup, lr * ramp, sched)
    return sched
