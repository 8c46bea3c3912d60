"""Layers of the reference: Linear, BlockLinear, Norm, Conv2D,
DictConcat, MLP.

A frozen copy of the port's nn/layers.py (the layers DreamerV3 uses),
with no sharding over ranks. Parameter names, shapes and layouts are the
port's: Linear kernels (in, out), BlockLinear kernels (groups, in/groups,
out/groups), Conv2D kernels HWIO on NHWC inputs (HWOI when transposed).
Every product takes its operands through `core.operands`, which rounds
them under the control's `fp8_compute`.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import core
from .core import Initializer, Module


def _winit(spec, scale=1.0):
  return Initializer.parse(spec, scale)

class Linear(Module):

  def __init__(self, din, units, name, bias=True, winit='trunc_normal_in',
               binit='zeros', outscale=1.0, cdtype=core.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    # Tuple output shapes are flattened for the matmul then reshaped.
    self.shape = (units,) if isinstance(units, int) else tuple(units)
    self.din = int(din)
    self.units = int(np.prod(self.shape))
    self.use_bias = bias
    self.param('kernel', (self.din, self.units), _winit(winit, outscale))
    if bias:
      self.param('bias', (self.units,), _winit(binit))

  def forward(self, x):
    x, kernel = core.operands(self.cast(x), self.cast(self.kernel))
    y = x @ kernel
    if self.use_bias:
      y = y + self.cast(self.bias)
    if len(self.shape) > 1:
      y = y.reshape((*y.shape[:-1], *self.shape))
    return y


class BlockLinear(Module):
  """Block-diagonal linear map with g groups: block i of the output only
  sees block i of the input."""

  def __init__(self, din, units, groups, name, bias=True,
               winit='trunc_normal_in', binit='zeros', outscale=1.0,
               cdtype=core.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    assert units % groups == 0, (units, groups)
    assert din % groups == 0, (din, groups)
    self.units = units
    self.groups = groups
    self.use_bias = bias
    self.param('kernel', (groups, din // groups, units // groups),
               _winit(winit, outscale))
    if bias:
      self.param('bias', (units,), _winit(binit))

  def forward(self, x):
    x = self.cast(x)
    g = self.groups
    lead = x.shape[:-1]
    xg = x.reshape((-1, g, x.shape[-1] // g))
    xg, kernel = core.operands(xg, self.cast(self.kernel))
    y = torch.einsum('bgd,gdu->bgu', xg, kernel)
    y = y.reshape((*lead, self.units))
    if self.use_bias:
      y = y + self.cast(self.bias)
    return y


def parse_norm(impl):
  """'rms1e-4' -> ('rms', 1e-4); no suffix means eps 1e-4."""
  if impl and impl[-1].isdigit():
    for i, char in enumerate(impl):
      if char.isdigit() or char == '.':
        break
    return impl[:i], float(impl[i:])
  return impl, 1e-4


class Norm(Module):
  """Normalization 'none' | 'rms' | 'layer', optionally suffixed with an
  epsilon like 'rms1e-4'. Computes in float32, returns the input dtype."""

  def __init__(self, impl, name, dim, scale=True, shift=True,
               cdtype=core.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    self.impl, self.eps = parse_norm(impl)
    self.use_scale = scale
    self.use_shift = shift
    if self.impl not in ('none', 'rms', 'layer'):
      raise NotImplementedError(self.impl)
    if self.impl != 'none' and scale:
      self.param('scale', (dim,), 1.0)
    if self.impl == 'layer' and shift:
      self.param('shift', (dim,), 0.0)

  def forward(self, x):
    if self.impl == 'none':
      return x
    dtype = x.dtype
    x = x.float()
    if self.impl == 'rms':
      mult = torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
      if self.use_scale:
        mult = mult * self.scale
      return (x * mult).to(dtype)
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + self.eps)
    if self.use_scale:
      y = y * self.scale
    if self.use_shift:
      y = y + self.shift
    return y.to(dtype)


def same_pads(sizes, kernel, stride):
  """F.pad's list for TensorFlow-style SAME padding of the trailing
  spatial dims `sizes`: the extra pixel of odd padding goes last."""
  pads = []
  for size in reversed(sizes):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    pads += [total // 2, total - total // 2]
  return pads


class Conv2D(Module):
  """NHWC convolution with SAME padding. The kernel is HWIO and re-laid
  out to OIHW for F.conv2d inside the call. With `transp`, the kernel is
  HWOI (K, K, depth, din) and the layer is JAX's
  lax.conv_transpose(..., 'SAME', ('NHWC', 'HWOI', 'NHWC')): a correlation
  of the unflipped kernel with the input dilated by `stride` and padded by
  (a, b) = (ceil((K + s - 2) / 2), the rest) per dim (K - 1 before where
  s > K - 1), giving `stride` times the input's size. It runs as
  F.conv_transpose2d (the gradient of a convolution, which flips the
  kernel) on the flipped kernel with padding K - 1 - a, and the output
  cropped or padded at the end to that size."""

  def __init__(self, din, depth, kernel, name, stride=1, transp=False,
               bias=True, winit='trunc_normal_in', binit='zeros',
               outscale=1.0, cdtype=core.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    self.depth = depth
    self.ksize = kernel
    self.stride = stride
    self.transp = transp
    self.use_bias = bias
    shape = (depth, din) if transp else (din, depth)
    self.param('kernel', (kernel, kernel, *shape), _winit(winit, outscale))
    if bias:
      self.param('bias', (depth,), _winit(binit))

  def forward(self, x):
    x, kernel = core.operands(self.cast(x), self.cast(self.kernel))
    product = self._transposed if self.transp else self._conv
    y = product(x, kernel)
    if self.use_bias:
      y = y + self.cast(self.bias)
    return y

  def _conv(self, x, kernel):
    """NHWC x, HWIO kernel -> NHWC."""
    x = x.permute(0, 3, 1, 2)
    x = F.pad(x, same_pads(x.shape[2:], self.ksize, self.stride))
    y = F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=self.stride)
    return y.permute(0, 2, 3, 1)

  def _transposed(self, x, kernel):
    """NHWC x, HWOI kernel -> NHWC."""
    x = x.permute(0, 3, 1, 2)
    k, s = self.ksize, self.stride
    before = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
    crop = k - 1 - before
    size = (x.shape[2] - 1) * s + k - 2 * crop
    extra = max(x.shape[2] * s - size, 0)
    w = kernel.permute(3, 2, 0, 1).flip(2, 3)
    y = F.conv_transpose2d(x, w, stride=s, padding=crop,
                           output_padding=extra)
    return y[:, :, :x.shape[2] * s, :x.shape[3] * s].permute(0, 2, 3, 1)


def _flat_width(space):
  """The width of a space's entry flattened, one-hot where discrete."""
  size = int(np.prod(space.shape))
  return size * space.classes if space.discrete else size


class DictConcat(Module):
  """Concatenates dict values (sorted by key) into one flat feature axis;
  discrete entries are one-hot encoded, continuous optionally squished."""

  def __init__(self, spaces, name='dictconcat', squish=None,
               cdtype=core.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    self.spaces = spaces
    self.squish = squish or (lambda x: x)

  @property
  def width(self):
    return sum(_flat_width(space) for space in self.spaces.values())

  def forward(self, xs):
    outs = []
    for key in sorted(self.spaces.keys()):
      space = self.spaces[key]
      x = xs[key]
      bdims = x.ndim - len(space.shape)
      assert tuple(x.shape[bdims:]) == space.shape, (key, space.shape, x.shape)
      if space.discrete:
        x = F.one_hot(x.long(), space.classes).float()
      else:
        x = self.cast(self.squish(x.float()))
      x = x.reshape((*x.shape[:bdims], -1))
      outs.append(self.cast(x))
    return torch.cat(outs, -1)


class MLP(Module):

  def __init__(self, din, layers, units, name, act='silu', norm='rms',
               cdtype=core.COMPUTE_DTYPE, **kw):
    super().__init__(name, cdtype)
    self.layers = []
    for i in range(layers):
      linear = self.child(Linear(
          units if i else din, units, f'linear{i}', cdtype=cdtype, **kw))
      norm_ = self.child(Norm(norm, f'norm{i}', units, cdtype=cdtype))
      self.layers.append((linear, norm_))
    self.act = core.act(act)
    self.units = units if layers else din

  def forward(self, x):
    for linear, norm in self.layers:
      x = self.act(norm(linear(x)))
    return x
