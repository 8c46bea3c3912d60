"""FLOP counts of the port's computations, for `Agent.train_cost` and the
segment profiler (tools/profile_train.py).

`FlopCounter` is a dispatch mode that adds up the products that
torch.utils.flop_counter has formulas for: matrix products, batched
products, convolutions and attention, forward and backward, at 2 M N K a
product. It counts products only; elementwise ops, reductions and the
optimizer's arithmetic count nothing. torch's own `FlopCounterMode`
applies the same formulas and also attributes each count to a module
through hooks, and those hooks fail where a module is called under
no_grad on a leaf that requires grad, as the imagination rollout's first
step is; this mode keeps the formulas and leaves out the attribution.

`meta_copy` copies a module with every parameter and buffer on the meta
device: tensors with shapes and no memory, on which no op computes or
launches. The kernel wrappers take their plain versions for a meta
tensor (ops.blockgru.takes_plain), so a count on meta is the plain
path's whatever implements the call on the card, and it leaves the
counted module's state as it was. The wrappers' `work()` and
`work_bwd()` are the kernels' roofline counts instead, whose backward
includes the recompute.
"""

import copy
import itertools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..nn.core import store_path

META = torch.device('meta')


class FlopCounter(TorchDispatchMode):
  """Counts the products of the ops it sees: `flops` in all and `by_op`
  ({op name: flops})."""

  def __init__(self):
    super().__init__()
    self.flops = 0
    self.by_op = {}

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    formula = flop_registry.get(func._overloadpacket)
    if formula is not None:
      flops = int(formula(*args, **kwargs, out_val=out))
      self.flops += flops
      name = func._overloadpacket.__name__
      self.by_op[name] = self.by_op.get(name, 0) + flops
    return out


def meta_copy(module, shapes=None):
  """A deep copy of `module` whose parameters and buffers are meta tensors
  of the same dtypes and grad flags, and of the shapes they have or,
  where `shapes` ({store path: shape}) names them, of those: the full
  shapes of a sharded store's slices. Every reference to one of them
  inside the copy (an optimizer's list of parameters, say) points to its
  meta counterpart. Raises if the copy holds another tensor that is not
  on meta."""
  shapes = shapes or {}
  memo = {}
  named = itertools.chain(module.named_parameters(), module.named_buffers())
  for name, value in named:
    shape = shapes.get(store_path(name), value.shape)
    meta = torch.empty(shape, dtype=value.dtype, device=META)
    if isinstance(value, torch.nn.Parameter):
      meta = torch.nn.Parameter(meta, requires_grad=value.requires_grad)
    memo[id(value)] = meta
  copied = copy.deepcopy(module, memo)
  for name, sub in copied.named_modules():
    for key, value in vars(sub).items():
      if isinstance(value, torch.Tensor) and value.device != META:
        raise RuntimeError(f'{name}.{key} is a {value.device} tensor that '
                           'is neither a parameter nor a buffer')
  return copied


def to_meta(tree):
  """The tensors of a nested dict/list/tuple as meta tensors (host arrays
  through torch.as_tensor)."""
  if isinstance(tree, dict):
    return {k: to_meta(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(to_meta(v) for v in tree)
  return torch.empty_like(torch.as_tensor(tree), device=META)
