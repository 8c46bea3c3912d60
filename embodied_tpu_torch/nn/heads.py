"""Output heads producing distribution objects: MLPHead, DictHead, Head.

Counterparts of embodied_tpu/nn/heads.py with the same parameter paths and
every output of the JAX Head: binary, categorical, onehot, mse, huber,
symlog_mse, symexp_twohot (zero-initialised with outscale 0),
bounded_normal and normal_logstd.
"""

import math

import numpy as np
import torch

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
    self.minstd = minstd
    self.maxstd = maxstd
    self.unimix = unimix
    kw = dict(kw, outscale=outscale, cdtype=cdtype)
    shape = space.shape
    if output == 'binary':
      self.logit = Linear(din, shape or 1, 'logit', **kw)
    elif output == 'categorical':
      self.logits = Linear(din, (*shape, space.classes), 'logits', **kw)
    elif output == 'onehot':
      self.logits = Linear(din, shape, 'logits', **kw)
    elif output in ('mse', 'huber', 'symlog_mse'):
      self.pred = Linear(din, shape or 1, 'pred', **kw)
    elif output == 'symexp_twohot':
      self.logits = Linear(din, (*shape, bins), 'logits', **kw)
      # A constant on the module's device, outside the store: a copy from
      # the host at each call would make the host wait for the card.
      self.register_buffer('binvals', torch.from_numpy(
          dists.symexp_bins(bins)), persistent=False)
    elif output in ('bounded_normal', 'normal_logstd'):
      self.mean = Linear(din, shape or 1, 'mean', **kw)
      self.stddev = Linear(din, shape or 1, 'stddev', **kw)
    else:
      raise NotImplementedError(output)

  def forward(self, x):
    output = getattr(self, '_' + self.impl)(x)
    # OneHot distributions already consume the trailing class axis, so one
    # fewer event dim remains to aggregate.
    dims = len(self.space.shape) - (1 if self.impl == 'onehot' else 0)
    if dims > 0:
      output = dists.Agg(output, dims)
    assert tuple(output.pred().shape[x.ndim - 1:]) == self.space.shape, (
        self.space, self.impl, x.shape, output.pred().shape)
    return output

  def _squeeze(self, y):
    return y[..., 0] if not self.space.shape else y

  def _binary(self, x):
    assert self.space.classes == 2, self.space
    return dists.Binary(self._squeeze(self.logit(x)))

  def _categorical(self, x):
    # Like the JAX head, the categorical output ignores unimix.
    logits = self.logits(x)
    output = dists.Categorical(logits)
    output.minent = 0.0
    output.maxent = float(np.log(logits.shape[-1]))
    return output

  def _onehot(self, x):
    return dists.OneHot(self.logits(x), self.unimix)

  def _mse(self, x):
    return dists.MSE(self._squeeze(self.pred(x)))

  def _huber(self, x):
    return dists.Huber(self._squeeze(self.pred(x)))

  def _symlog_mse(self, x):
    return dists.MSE(self._squeeze(self.pred(x)), core.symlog)

  def _symexp_twohot(self, x):
    return dists.TwoHot(self.logits(x), self.binvals, core.symlog,
                        core.symexp)

  def _bounded_normal(self, x):
    mean = self._squeeze(self.mean(x)).float()
    stddev = self._squeeze(self.stddev(x)).float()
    lo, hi = self.minstd, self.maxstd
    stddev = (hi - lo) * (stddev + 2.0).sigmoid() + lo
    output = dists.Normal(mean.tanh(), stddev)
    entropy = lambda s: 0.5 * math.log(2 * math.pi * s * s) + 0.5
    output.minent = entropy(lo)
    output.maxent = entropy(hi)
    return output

  def _normal_logstd(self, x):
    mean = self._squeeze(self.mean(x)).float()
    stddev = self._squeeze(self.stddev(x)).float()
    return dists.Normal(mean, stddev.exp())
