"""The benchmark's FLOP count of one train step.

`FlopCounter` is a dispatch mode that adds up the products that
torch.utils.flop_counter has formulas for: matrix products, batched
products and convolutions, forward and backward, at 2 M N K a product.
It counts products only; elementwise ops, reductions and the optimizer's
arithmetic count nothing. (torch's own `FlopCounterMode` applies the same
formulas and attributes each count to a module through hooks, which fail
where a module runs under no_grad on a leaf that requires grad, as the
imagination rollout's first step does; this mode keeps the formulas.)

`train_flops` counts one train step of the reference model built on the
meta device (shapes, no memory, no computation) at the cell's batch: the plain path's products, which is what the step has to compute
whatever kernels the program runs it on.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

META = torch.device('meta')


class FlopCounter(TorchDispatchMode):
  """Counts the products of the ops it sees in `flops`."""

  def __init__(self):
    super().__init__()
    self.flops = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    formula = flop_registry.get(func._overloadpacket)
    if formula is not None:
      self.flops += int(formula(*args, **kwargs, out_val=out))
    return out


def train_flops(model, batch):
  """The products of one train step of the reference `model`, built on
  the meta device, on `batch` ({key: tensor} of the replay's shapes)."""
  from .nn import dists
  data = {k: torch.empty(tuple(v.shape), dtype=torch.as_tensor(v[:0]).dtype,
                         device=META) for k, v in batch.items()}
  carry = model.init_train(next(iter(data.values())).shape[0])
  with FlopCounter() as counter:
    model.train_step(carry, data, dists.Draws(None, META))
  return counter.flops
