"""Tensor parallelism over the mesh's 't' ranks: what GSPMD does inside XLA
for the JAX package, which has no counterpart module.

The models' partition_rules shard the last dimension of every `kernel`
and `embed` over ('f','t'), and the JAX mesh keeps every 't' device on
the same rows, so GSPMD splits each product whose weight is sharded over
't' and joins the parts. Within `split_over(group, paths, root, ...)` (the
Agent's `train` and `report` on a mesh with t > 1), each layer of `root`
whose entry is in `paths` does the same (nn/layers.py): it takes its
rank's `1/t` of the full weight's last dimension, contiguous by the
rank's 't' index, computes its part of the product, and joins the parts
over `group` with one of three autograd functions:

- `enter(x)`: forward the identity; backward the input's gradient summed
  over the group, since each rank's part saw all of `x`;
- `gather(y)`: forward the ranks' parts all-gathered along the last
  dimension in 't' order; backward this rank's part of the gradient;
- `total(y)`: forward the ranks' partial outputs summed (an all-reduce);
  backward the identity, as every rank holds the whole output's
  gradient.

The context is thread-local: the actor thread's policy calls beside a
learner thread in the context never see it. The kernels' wrappers read
the full weights and split nothing, as the JAX package's pallas_calls
take gathered operands. On the meta device (parallel/flops.py) the
functions communicate nothing: `gather` repeats the part, so the shapes
are those of the real step, and a FlopCounter's `split` counts the
products of the rank's parts, forward and backward.
"""

import contextlib

import torch
import torch.distributed as dist

from ..nn import core
from . import flops as flopslib


class Split:
  """The active split: the 't' `group`, this rank's `index` along 't'
  and the `count` of ranks there, the store `paths` that split and the
  same as {id(module): entry names}."""

  def __init__(self, group, index, count, paths, entries):
    self.group, self.index, self.count = group, index, count
    self.paths, self.entries = paths, entries

  def part(self, size):
    """(start, width) of this rank's part of a dimension of `size`."""
    width = size // self.count
    return self.index * width, width


@contextlib.contextmanager
def split_over(group, paths, root, index, count):
  """Within, on this thread, each entry of `root`'s store at one of
  `paths` (kernels and embeddings) computes split over `group`, of
  `count` ranks in 't' order, as its rank `index` (see the module's
  docstring); nn/opt.py reads the Split too."""
  entries = {}
  for name, module in root.named_modules():
    for entry in ('kernel', 'embed'):
      path = core.store_path(f'{name}.{entry}' if name else entry)
      if path in paths:
        entries.setdefault(id(module), set()).add(entry)
  previous = core.SPLIT.active
  core.SPLIT.active = Split(
      group, int(index), int(count), frozenset(paths), entries)
  try:
    yield core.SPLIT.active
  finally:
    core.SPLIT.active = previous


class _Enter(torch.autograd.Function):
  """Forward: the identity. Backward: the gradient summed over the
  group (an all-reduce)."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return x.view_as(x)

  @staticmethod
  def backward(ctx, grad):
    if grad.device.type == 'meta':
      return grad, None
    grad = grad.contiguous().clone()
    dist.all_reduce(grad, group=ctx.group)
    return grad, None


class _Gather(torch.autograd.Function):
  """Forward: every rank's part all-gathered and joined along the last
  dimension in 't' order. Backward: this rank's part of the gradient."""

  @staticmethod
  def forward(ctx, y, group, index, count):
    ctx.index, ctx.width = index, y.shape[-1]
    if y.device.type == 'meta':
      return torch.cat([y] * count, -1)
    parts = [torch.empty_like(y) for _ in range(count)]
    dist.all_gather(parts, y.contiguous(), group=group)
    return torch.cat(parts, -1)

  @staticmethod
  def backward(ctx, grad):
    part = grad.narrow(-1, ctx.index * ctx.width, ctx.width)
    return part.contiguous(), None, None, None


class _Total(torch.autograd.Function):
  """Forward: the ranks' partial outputs summed (an all-reduce).
  Backward: the identity."""

  @staticmethod
  def forward(ctx, y, group):
    y = y.contiguous().clone()
    if y.device.type != 'meta':
      dist.all_reduce(y, group=group)
    return y

  @staticmethod
  def backward(ctx, grad):
    return grad, None


def enter(x, split):
  if not x.requires_grad:
    return x
  return _Enter.apply(x, split.group)


def gather(y, split):
  return _Gather.apply(y, split.group, split.index, split.count)


def total(y, split):
  return _Total.apply(y, split.group)


def columns(split, product, x, weight):
  """`product(x, weight)` computed on this rank's part of the last
  dimension of `weight` (output columns or channels) and gathered."""
  start, width = split.part(weight.shape[-1])
  x = enter(x, split)
  with flopslib.split_region():
    y = product(x, weight.narrow(-1, start, width))
  flopslib.mark_split(y, x)
  return gather(y, split)


def inputs(split, product, x, weight):
  """`product(x, weight)` where the last dimension of `weight` is the
  input channels that `x` holds in its own last dimension: this rank's
  part of both, and the partial outputs summed."""
  start, width = split.part(weight.shape[-1])
  x = enter(x, split)
  with flopslib.split_region():
    y = product(x.narrow(-1, start, width), weight.narrow(-1, start, width))
  flopslib.mark_split(y, x)
  return total(y, split)
