"""A stack of identical layers with separate weights, one layer's module.

Counterpart of embodied_tpu/nn/stacked.py (StackedLayers, a lax.scan over
a leading layer dimension): each parameter and buffer of the wrapped layer
gets a leading `(count, ...)` dimension under the store path the JAX stack
gives it (`<stack>/<layer>/...`), and the forward runs the one layer
`count` times, each on its slice of every entry (torch.func.functional_call),
so gradients reach every slice. The wrapped layer must map x to x (same
shapes in and out, e.g. a pre-norm transformer block).

Each slice is initialised as the layer's own parameter would be, with its
own draws: the JAX stack splits one key per layer, the port draws the
slices in order from the parameter's generator.
"""

import torch

from .core import Module


class _Slices:
  """An initializer that draws `count` slices of the per-layer shape in
  order from one generator."""

  def __init__(self, init, count):
    self.init = init
    self.count = count

  def __call__(self, gen, shape):
    assert shape[0] == self.count, (shape, self.count)
    return torch.stack([self.init(gen, shape[1:]) for _ in range(self.count)])


class StackedLayers(Module):

  def __init__(self, layer, count, name):
    super().__init__(name, layer.cdtype)
    self.count = count
    # Registered under its own name alone, as the JAX paths have it.
    self.__dict__['layer'] = self.child(layer)
    for module in layer.modules():
      for pname, param in list(module.named_parameters(recurse=False)):
        module.register_parameter(pname, torch.nn.Parameter(
            param.detach()[None].repeat(count, *[1] * param.ndim)))
        init = module._inits[pname]
        module._inits[pname] = _Slices(init, count) if callable(init) else (
            init)
      for bname, buf in list(module.named_buffers(recurse=False)):
        module.register_buffer(bname, buf[None].repeat(count, *[1] * buf.ndim))

  def forward(self, x):
    entries = {**dict(self.layer.named_parameters()),
               **dict(self.layer.named_buffers())}
    for i in range(self.count):
      x = torch.func.functional_call(
          self.layer, {k: v[i] for k, v in entries.items()}, (x,))
    return x
