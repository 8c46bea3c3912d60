"""Output heads producing distribution objects: MLPHead, DictHead, Head.

Counterparts of embodied_tpu/nn/heads.py with the same parameter paths.
The acting path needs the categorical and onehot outputs; the regression,
binary, two-hot and normal outputs come with the train step.
"""

import numpy as np

from ..utils import Space
from . import core, dists
from .layers import MLP, Linear


class MLPHead(core.Module):

  def __init__(self, space, output, name, din, layers=3, units=1024,
               act='silu', norm='rms', bias=True, winit='trunc_normal_in',
               binit='zeros', cdtype=core.COMPUTE_DTYPE, **hkw):
    super().__init__(name, cdtype)
    shared = dict(bias=bias, winit=winit, binit=binit, cdtype=cdtype)
    self.mlp = MLP(din, layers, units, 'mlp', act=act, norm=norm, **shared)
    cls = DictHead if isinstance(space, dict) else Head
    self.out = cls(space, output, 'out', self.mlp.units, **shared, **hkw)

  def forward(self, x, bdims=2):
    x = x.reshape((*x.shape[:bdims], -1))
    return self.out(self.mlp(x))


class DictHead(core.Module):

  def __init__(self, spaces, outputs, name, din, cdtype=core.COMPUTE_DTYPE,
               **kw):
    super().__init__(name, cdtype)
    assert spaces, spaces
    if not isinstance(outputs, dict):
      outputs = {k: outputs for k in spaces}
    assert spaces.keys() == outputs.keys(), (spaces, outputs)
    self.heads = {
        key: self.child(Head(
            spaces[key], outputs[key], f'head_{key}', din, cdtype=cdtype,
            **kw))
        for key in sorted(spaces.keys())}

  def forward(self, x):
    return {key: head(x) for key, head in self.heads.items()}


class Head(core.Module):

  def __init__(self, space, output, name, din, minstd=1.0, maxstd=1.0,
               unimix=0.0, bins=255, outscale=1.0, cdtype=core.COMPUTE_DTYPE,
               **kw):
    super().__init__(name, cdtype)
    if isinstance(space, tuple):
      space = Space(np.float32, space)
    if output == 'onehot':
      # Discrete space modeled as straight-through one-hot vectors.
      space = Space(np.float32, (*space.shape, space.classes), 0.0, 1.0)
    self.space = space
    self.impl = output
    self.unimix = unimix
    kw = dict(kw, outscale=outscale, cdtype=cdtype)
    if output == 'categorical':
      self.logits = Linear(din, (*space.shape, space.classes), 'logits', **kw)
    elif output == 'onehot':
      self.logits = Linear(din, space.shape, 'logits', **kw)
    else:
      raise NotImplementedError(
          f'Head output {output!r} is not ported yet')

  def forward(self, x):
    logits = self.logits(x)
    if self.impl == 'categorical':
      # Like the JAX head, the categorical output ignores unimix.
      output = dists.Categorical(logits)
    else:
      output = dists.OneHot(logits, self.unimix)
    # OneHot distributions already consume the trailing class axis, so one
    # fewer event dim remains to aggregate.
    dims = len(self.space.shape) - (1 if self.impl == 'onehot' else 0)
    if dims > 0:
      output = dists.Agg(output, dims)
    assert tuple(output.pred().shape[x.ndim - 1:]) == self.space.shape, (
        self.space, self.impl, x.shape, output.pred().shape)
    return output
