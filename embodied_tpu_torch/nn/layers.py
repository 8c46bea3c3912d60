"""Layers of the port: Linear, BlockLinear, Embed, Norm, Conv2D, DictConcat,
DictEmbed, MLP, GRU.

Counterparts of embodied_tpu/nn/layers.py with the same parameter names,
shapes and layouts: Linear kernels (in, out), BlockLinear kernels
(groups, in/groups, out/groups), Conv2D kernels HWIO on NHWC inputs. Input
widths are given at construction (JAX infers them at the first call).
Matmuls run in the module's compute dtype on weights cast from float32.
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
    x = self.cast(x)
    y = x @ self.cast(self.kernel)
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
    y = torch.einsum('bgd,gdu->bgu', xg, self.cast(self.kernel))
    y = y.reshape((*lead, self.units))
    if self.use_bias:
      y = y + self.cast(self.bias)
    return y


class Embed(Module):
  """Lookup table of `classes` rows of width `units` (path `embed`)."""

  def __init__(self, classes, units, name, winit='trunc_normal_in',
               outscale=1.0, cdtype=core.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    self.classes = classes
    self.units = units
    self.param('embed', (classes, units), _winit(winit, outscale))

  def forward(self, x):
    return self.cast(self.embed)[x.long()]


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


class Conv2D(Module):
  """NHWC convolution with an HWIO kernel and SAME padding. The kernel is
  re-laid out to OIHW for F.conv2d inside the call."""

  def __init__(self, din, depth, kernel, name, stride=1, bias=True,
               winit='trunc_normal_in', binit='zeros', outscale=1.0,
               cdtype=core.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    self.depth = depth
    self.ksize = kernel
    self.stride = stride
    self.use_bias = bias
    self.param('kernel', (kernel, kernel, din, depth), _winit(winit, outscale))
    if bias:
      self.param('bias', (depth,), _winit(binit))

  def forward(self, x):
    x = self.cast(x).permute(0, 3, 1, 2)
    # TensorFlow-style SAME: the extra pixel of odd padding goes last.
    pads = []
    for size in reversed(x.shape[2:]):
      out = -(-size // self.stride)
      total = max((out - 1) * self.stride + self.ksize - size, 0)
      pads += [total // 2, total - total // 2]
    x = F.pad(x, pads)
    w = self.cast(self.kernel).permute(3, 2, 0, 1)
    y = F.conv2d(x, w, stride=self.stride).permute(0, 2, 3, 1)
    if self.use_bias:
      y = y + self.cast(self.bias)
    return y


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


class DictEmbed(Module):
  """Embeds each dict entry (sorted by key) with its own Linear
  (`embed_<key>`) and sums the embeddings; discrete entries are one-hot
  encoded, continuous ones optionally squished first."""

  def __init__(self, spaces, units, name, squish=None,
               cdtype=core.COMPUTE_DTYPE, **kw):
    super().__init__(name, cdtype)
    self.spaces = spaces
    self.units = units
    self.squish = squish or (lambda x: x)
    self.heads = {
        key: self.child(Linear(
            _flat_width(spaces[key]), units, f'embed_{key}', cdtype=cdtype,
            **kw))
        for key in sorted(spaces.keys())}

  def forward(self, xs, bshape):
    total = 0
    for key, head in self.heads.items():
      space = self.spaces[key]
      x = xs[key]
      if space.discrete:
        x = F.one_hot(x.long(), space.classes).float()
      else:
        x = self.cast(self.squish(x.float()))
      total = total + head(self.cast(x.reshape((*bshape, -1))))
    return total


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


class GRU(Module):
  """GRU over time with carry resets, as the JAX GRU: the carry is zeroed
  where `resets`, then one Linear (`core`) on [carry, x] and the norm
  give the reset, candidate and update gates; the update gate is
  sigmoid(u - 1). A window of T steps runs as a loop of single steps."""

  def __init__(self, din, units, name, norm='rms', cdtype=core.COMPUTE_DTYPE,
               **kw):
    super().__init__(name, cdtype)
    self.units = units
    self.core = Linear(units + din, 3 * units, 'core', cdtype=cdtype, **kw)
    self.norm = Norm(norm, 'norm', 3 * units, cdtype=cdtype)

  def initial(self, batch_size, device=None):
    return torch.zeros((batch_size, self.units), dtype=self.cdtype,
                       device=device)

  def forward(self, carry, inputs, resets, single=False):
    """(B, units), (B, din), (B,) -> (carry, carry) if `single`, else
    (B, units), (B, T, din), (B, T) -> (carry, (B, T, units))."""
    if single:
      carry = self._step(carry, inputs, resets)
      return carry, carry
    outs = []
    for t in range(inputs.shape[1]):
      carry = self._step(carry, inputs[:, t], resets[:, t])
      outs.append(carry)
    return carry, torch.stack(outs, 1)

  def _step(self, carry, x, reset):
    carry = core.mask(carry, ~reset)
    x = torch.cat([self.cast(carry), self.cast(x)], -1)
    x = self.norm(self.core(x))
    reset_gate, cand, update = torch.chunk(x, 3, -1)
    reset_gate = torch.sigmoid(reset_gate)
    cand = torch.tanh(reset_gate * cand)
    update = torch.sigmoid(update - 1)
    return update * cand + (1 - update) * carry
