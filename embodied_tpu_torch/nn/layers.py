"""Layers of the port: Linear, BlockLinear, Embed, Norm, Conv2D, Conv3D,
rope, Attention, DictConcat, DictEmbed, MLP, Transformer, GRU.

Counterparts of embodied_tpu/nn/layers.py with the same parameter names,
shapes and layouts: Linear kernels (in, out), BlockLinear kernels
(groups, in/groups, out/groups), Conv2D kernels HWIO on NHWC inputs (HWOI
when transposed), Conv3D kernels DHWIO on NDHWC inputs. Input widths are
given at construction (JAX infers them at the first call). Matmuls run in
the module's compute dtype on weights cast from float32.

Under a split over the mesh's 't' ranks (parallel/tensor.py: the Agent's
train and report where the placements shard a kernel or embedding over
't'), a layer whose entry splits takes the rank's part of the weight's
last dimension, as GSPMD partitions the JAX layer: Linear, BlockLinear
(the part of every group's columns), Conv2D, Conv3D and Embed compute
their output columns or channels and gather them; the transposed Conv2D
(HWOI, whose last dimension is the input channels) convolves the rank's
input channels and sums the partial outputs. Biases are whole and are
added once, to the joined output. GRU and Attention split through their
Linears.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import tensor
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
    kernel = self.cast(self.kernel)
    split = self.split('kernel')
    if split is None:
      y = x @ kernel
    else:
      y = tensor.columns(split, torch.matmul, x, kernel)
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
    kernel = self.cast(self.kernel)
    product = lambda x, w: torch.einsum('bgd,gdu->bgu', x, w)
    split = self.split('kernel')
    if split is None:
      y = product(xg, kernel)
    else:  # Each group's part of its columns, gathered group by group.
      y = tensor.columns(split, product, xg, kernel)
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
    table = self.cast(self.embed)
    split = self.split('embed')
    if split is None:
      return table[x.long()]
    return tensor.columns(split, lambda x, t: t[x.long()], x, table)


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
    x, kernel = self.cast(x), self.cast(self.kernel)
    product = self._transposed if self.transp else self._conv
    split = self.split('kernel')
    if split is None:
      y = product(x, kernel)
    elif self.transp:  # HWOI: the rank's input channels, partial sums.
      y = tensor.inputs(split, product, x, kernel)
    else:
      y = tensor.columns(split, product, x, kernel)
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


class Conv3D(Module):
  """NDHWC convolution with a DHWIO kernel, SAME padding and a stride in
  each of the three dims."""

  def __init__(self, din, depth, kernel, name, stride=1, bias=True,
               winit='trunc_normal_in', binit='zeros', outscale=1.0,
               cdtype=core.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    self.depth = depth
    self.ksize = kernel
    self.stride = stride
    self.use_bias = bias
    self.param('kernel', (kernel, kernel, kernel, din, depth),
               _winit(winit, outscale))
    if bias:
      self.param('bias', (depth,), _winit(binit))

  def forward(self, x):
    x, kernel = self.cast(x), self.cast(self.kernel)
    split = self.split('kernel')
    if split is None:
      y = self._conv(x, kernel)
    else:
      y = tensor.columns(split, self._conv, x, kernel)
    if self.use_bias:
      y = y + self.cast(self.bias)
    return y

  def _conv(self, x, kernel):
    """NDHWC x, DHWIO kernel -> NDHWC."""
    x = x.permute(0, 4, 1, 2, 3)
    x = F.pad(x, same_pads(x.shape[2:], self.ksize, self.stride))
    y = F.conv3d(x, kernel.permute(4, 3, 0, 1, 2), stride=self.stride)
    return y.permute(0, 2, 3, 4, 1)


def rope(x, positions, maxlen=10000):
  """Rotary position embedding over the last axis, computed in float32:
  the halves (x1, x2) turn by angles positions * maxlen^(-2i/D)."""
  D = x.shape[-1]
  assert D % 2 == 0, D
  freqs = torch.exp(-math.log(maxlen) * torch.arange(
      0, D, 2, dtype=torch.float32, device=x.device) / D)
  angles = positions[..., None].float() * freqs
  sin, cos = torch.sin(angles), torch.cos(angles)
  x1, x2 = x.float().chunk(2, -1)
  y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
  return y.to(x.dtype)


class Attention(Module):
  """Multi-head attention with grouped queries (`kvheads` key and value
  heads), RoPE over positions and qk-norm (an rms Norm without scale over
  each head's D). The logits come out of the product in the compute dtype,
  are divided by sqrt(D), then masked (-1e30 where `mask` is False) and
  softmaxed in float32, and the weights cast to the input's dtype, as the
  JAX layer rounds. Plain products, no fused attention kernel.

  impl='ring' is sequence-parallel ring attention over the process group
  `ring_group` (None: the default group): each rank holds T_local of the
  sequence, its RoPE positions start at rank * T_local, and key and value
  blocks rotate around the ranks (ops/ring_attention.py). Only a causal
  or a full mask is taken there."""

  def __init__(self, din, units, heads, name, kvheads=0, qknorm=True,
               pos='rope', bias=False, winit='trunc_normal_in',
               outscale=1.0, dropout=0.0, impl='dense', ring_group=None,
               causal=False, cdtype=core.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    assert impl in ('dense', 'ring'), impl
    assert units % heads == 0
    self.impl = impl
    self.ring_group = ring_group
    self.causal = causal
    self.units = units
    self.heads = heads
    self.kvheads = kvheads or heads
    assert heads % self.kvheads == 0
    self.qknorm = qknorm
    self.pos = pos
    kv = units // heads * self.kvheads
    kw = dict(bias=bias, winit=winit, cdtype=cdtype)
    self.q = Linear(din, units, 'q', **kw)
    self.k = Linear(din, kv, 'k', **kw)
    self.v = Linear(din, kv, 'v', **kw)
    self.out = Linear(units, units, 'out', outscale=outscale, **kw)
    self.qn = Norm('rms', 'qnorm', units // heads, scale=False, cdtype=cdtype)
    self.kn = Norm('rms', 'knorm', units // heads, scale=False, cdtype=cdtype)

  def forward(self, x, mask=None, positions=None):
    B, T, _ = x.shape
    D = self.units // self.heads
    q = self.q(x).reshape((B, T, self.heads, D))
    k = self.k(x).reshape((B, T, self.kvheads, D))
    v = self.v(x).reshape((B, T, self.kvheads, D))
    if self.qknorm:
      q, k = self.qn(q), self.kn(k)
    if self.pos == 'rope':
      if positions is None:
        offset = 0
        if self.impl == 'ring':
          # T is the rank's shard: offset it so rotary phases are global.
          offset = torch.distributed.get_rank(self.ring_group) * T
        positions = (offset + torch.arange(T, device=x.device))[None].expand(
            B, T)
      q = rope(q.transpose(1, 2), positions[:, None]).transpose(1, 2)
      k = rope(k.transpose(1, 2), positions[:, None]).transpose(1, 2)
    repeat = self.heads // self.kvheads
    if repeat > 1:
      k = k.repeat_interleave(repeat, 2)
      v = v.repeat_interleave(repeat, 2)
    if self.impl == 'ring':
      assert mask is None, 'ring attention takes causal or full masks only'
      from ..ops import ring_attention
      y = ring_attention.ring_attention(
          q, k, v, self.ring_group, causal=self.causal)
      return self.out(y.reshape((B, T, self.units)))
    logits = torch.einsum('bthd,bshd->bhts', q, k) / math.sqrt(D)
    logits = logits.float()
    if mask is not None:
      logits = torch.where(mask, logits, -1e30)
    weights = torch.softmax(logits, -1).to(x.dtype)
    dtype = torch.promote_types(weights.dtype, v.dtype)
    y = torch.einsum('bhts,bshd->bthd', weights.to(dtype), v.to(dtype))
    return self.out(y.reshape((B, T, self.units)))


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


class Transformer(Module):
  """Pre-norm transformer blocks with an optional GLU feedforward and a
  final norm (`outnorm`); the width stays `units` throughout. The
  attention-only options (impl, ring_group, causal, kvheads, qknorm, pos,
  dropout) go to the Attention alone, the rest to every Linear."""

  def __init__(self, layers, units, heads, name, ffmult=4, glu=True,
               act='silu', norm='rms', cdtype=core.COMPUTE_DTYPE, **kw):
    super().__init__(name, cdtype)
    akw = {k: kw.pop(k) for k in (
        'impl', 'ring_group', 'causal', 'kvheads', 'qknorm', 'pos',
        'dropout') if k in kw}
    kw = dict(kw, cdtype=cdtype)
    child = self.child
    self.blocks = []
    for i in range(layers):
      self.blocks.append((
          child(Attention(units, units, heads, f'attn{i}', **kw, **akw)),
          child(Norm(norm, f'norm{i}a', units, cdtype=cdtype)),
          child(Norm(norm, f'norm{i}b', units, cdtype=cdtype)),
          child(Linear(units, ffmult * units, f'ff{i}a', **kw)),
          child(Linear(units, ffmult * units, f'ff{i}gate', **kw))
          if glu else None,
          child(Linear(ffmult * units, units, f'ff{i}b', **kw))))
    self.outnorm = Norm(norm, 'outnorm', units, cdtype=cdtype)
    self.act = core.act(act)
    self.glu = glu

  def forward(self, x, mask=None, positions=None):
    for attn, n1, n2, ff1, ffg, ff2 in self.blocks:
      x = x + attn(n1(x), mask, positions)
      h = n2(x)
      y = self.act(ff1(h))
      if self.glu:
        y = y * ffg(h)
      x = x + ff2(y)
    return self.outnorm(x)


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
