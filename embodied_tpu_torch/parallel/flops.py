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

Under a split over 't' (parallel/tensor.py) a counter also counts, as
`split`, the products of the split layers' parts: forward within
`split_region`, and backward in the autograd nodes between a part's
output and its inputs, which `mark_split` hooks (on the thread that
counts, where the backward of CPU and meta tensors runs).

`meta_copy` copies a module with every parameter and buffer on the meta
device: tensors with shapes and no memory, on which no op computes or
launches. The kernel wrappers take their plain versions for a meta
tensor (ops.blockgru.takes_plain), so a count on meta is the plain
path's whatever implements the call on the card, and it leaves the
counted module's state as it was. The wrappers' `work()` and
`work_bwd()` are the kernels' roofline counts instead, whose backward
includes the recompute.
"""

import contextlib
import copy
import itertools
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..nn.core import store_path

META = torch.device('meta')


class _Counting(threading.local):
  counter = None


_COUNTING = _Counting()


class FlopCounter(TorchDispatchMode):
  """Counts the products of the ops it sees: `flops` in all, `by_op`
  ({op name: flops}) and `split`, those of split layers' parts."""

  def __init__(self):
    super().__init__()
    self.flops = 0
    self.by_op = {}
    self.split = 0
    self.inside = 0  # split regions and hooked nodes now running
    self._outer = None

  def __enter__(self):
    self._outer, _COUNTING.counter = _COUNTING.counter, self
    return super().__enter__()

  def __exit__(self, *exc):
    _COUNTING.counter = self._outer
    return super().__exit__(*exc)

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    formula = flop_registry.get(func._overloadpacket)
    if formula is not None:
      flops = int(formula(*args, **kwargs, out_val=out))
      self.flops += flops
      if self.inside:
        self.split += flops
      name = func._overloadpacket.__name__
      self.by_op[name] = self.by_op.get(name, 0) + flops
    return out


@contextlib.contextmanager
def split_region():
  """Within: the products that the active counter sees are a split
  layer's part's (nothing without a counter on this thread)."""
  counter = _COUNTING.counter
  if counter is None:
    yield
    return
  counter.inside += 1
  try:
    yield
  finally:
    counter.inside -= 1


def mark_split(y, x):
  """Where a counter is active: the autograd nodes from the part `y`
  back to its input `x` (whose own node is not) and to the parameters
  count their backward products as split."""
  counter = _COUNTING.counter
  if counter is None or y.grad_fn is None:
    return

  def enter(grads):
    counter.inside += 1

  def leave(grads_in, grads_out):
    counter.inside -= 1
  stack, seen = [y.grad_fn], set()
  while stack:
    node = stack.pop()
    if (node is None or node is x.grad_fn or node in seen or
        type(node).__name__ == 'AccumulateGrad'):
      continue
    seen.add(node)
    node.register_prehook(enter)
    node.register_hook(leave)
    stack.extend(n for n, _ in node.next_functions)


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
