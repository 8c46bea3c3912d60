"""Module base, parameter store and tensor helpers of the reference.

A frozen copy of the port's nn/core.py at the time the benchmark was
written, without the sharded store and the split over ranks. A parameter's
`state_dict` key is its store path with '/' replaced by '.', so the paths,
shapes and layouts are the port's, and one store of weights loads into
both. Parameters are float32; the reference computes in float32 (its
modules are built with `cdtype=torch.float32`).

`fp8_compute()` is the control's switch: within it the reference
computes in float8 e4m3, the precision below the configuration's
bfloat16 that a later change could be tempted to take: every matrix
product and convolution rounds both operands, and every cast to the
compute dtype (the activations, carries and states the program holds in
bfloat16) rounds its values, with one scale per tensor (a
straight-through rounding, so the backward's products take the rounded
operands too).
"""

import contextlib
import threading

import numpy as np
import torch

COMPUTE_DTYPE = torch.float32
PARAM_DTYPE = torch.float32

_NUMPY_DTYPES = {
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(bool): torch.bool,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8}

# Torch keeps '.' for its module scopes, so an entry whose store name holds
# a '.' is registered with NAME_DOT in its place; `store_path` puts it back.
NAME_DOT = '·'


def torch_dtype(dtype):
  """The torch dtype of a numpy dtype (a space's)."""
  return _NUMPY_DTYPES[np.dtype(dtype)]


def store_path(key):
  """The store path of a `state_dict` key."""
  return key.replace('.', '/').replace(NAME_DOT, '.')


class _Precision(threading.local):
  fp8 = False


PRECISION = _Precision()
FP8_MAX = 448.0


@contextlib.contextmanager
def fp8_compute():
  """Within: the reference computes in float8 e4m3 (see above)."""
  previous, PRECISION.fp8 = PRECISION.fp8, True
  try:
    yield
  finally:
    PRECISION.fp8 = previous


def _round_fp8(x):
  scale = torch.clamp(x.detach().abs().amax().float(), min=1e-30) / FP8_MAX
  low = (x.detach().float() / scale).to(torch.float8_e4m3fn)
  rounded = (low.float() * scale).to(x.dtype)
  return x + (rounded - x).detach()


def operands(*xs):
  """The operands of one product, rounded under `fp8_compute`."""
  if not PRECISION.fp8:
    return xs
  return tuple(_round_fp8(x) for x in xs)


class Module(torch.nn.Module):
  """Base for layers. `name` is the module's scope in the store."""

  def __init__(self, name, cdtype=COMPUTE_DTYPE):
    super().__init__()
    assert isinstance(name, str) and name, name
    self.name = name
    self.cdtype = cdtype
    self._inits = {}

  def child(self, module):
    """Register `module` under its scope name and return it."""
    self.add_module(module.name, module)
    return module

  def param(self, name, shape, init):
    """Create a float32 parameter; `init` is an Initializer or a constant.
    The benchmark draws the values (harness/weights.py), not this."""
    shape = tuple(int(x) for x in shape)
    self.register_parameter(
        name, torch.nn.Parameter(torch.empty(shape, dtype=PARAM_DTYPE)))
    self._inits[name] = init
    return getattr(self, name)

  def state(self, name, shape, init, dtype=torch.float32):
    """Create a buffer filled with `init`: state kept in the store but not
    trained."""
    shape = tuple(int(x) for x in shape)
    name = name.replace('.', NAME_DOT)
    self.register_buffer(name, torch.full(shape, init, dtype=dtype))
    return getattr(self, name)

  def cast(self, xs, force=False):
    return cast(xs, self.cdtype, force)


def inits(root):
  """{store path: initializer or constant} of every parameter of `root`."""
  out = {}
  for mname, module in root.named_modules():
    for pname, init in getattr(module, '_inits', {}).items():
      out['/'.join(x for x in mname.split('.') + [pname] if x)] = init
  return out


def post_init(root):
  """Run each module's `post_init` (the slow value copies the value)."""
  for module in root.modules():
    if hasattr(module, 'post_init'):
      module.post_init()


def store(root):
  """The module tree as a flat store {path: tensor}."""
  return {store_path(k): v for k, v in root.state_dict().items()}


@torch.no_grad()
def load_store(root, values):
  """Copy {path: tensor} into the module tree; every parameter must be
  present. Buffers the store lacks keep their initial values."""
  held = dict(root.state_dict())
  paths = {store_path(k): k for k in held}
  params = {store_path(k) for k, _ in root.named_parameters()}
  missing = sorted(params - set(values))
  if missing:
    raise KeyError(f'Store lacks {len(missing)} parameters: {missing[:5]}')
  for path, key in paths.items():
    if path not in values:
      continue
    value = torch.as_tensor(values[path])
    if tuple(value.shape) != tuple(held[key].shape):
      raise ValueError(
          f'{path}: shape {tuple(value.shape)} != {tuple(held[key].shape)}')
    held[key].copy_(value.to(held[key].device, held[key].dtype))


def tree_map(fn, xs):
  if isinstance(xs, dict):
    return {k: tree_map(fn, v) for k, v in xs.items()}
  if isinstance(xs, (list, tuple)):
    return type(xs)(tree_map(fn, x) for x in xs)
  return fn(xs)


def cast(xs, dtype=COMPUTE_DTYPE, force=False):
  """Cast floating tensors to `dtype`; integers only when `force`. Under
  `fp8_compute` the cast values are rounded to float8 too, as a program
  that computes in it would hold every activation and state."""
  def fn(x):
    if x is None:
      return x
    if x.is_floating_point() or (force and x.dtype != torch.bool):
      x = x.to(dtype)
      return _round_fp8(x) if PRECISION.fp8 else x
    return x
  return tree_map(fn, xs)


def f32(xs):
  return tree_map(lambda x: x.float(), xs)


def act(name):
  if name == 'none':
    return lambda x: x
  if name == 'mish':
    return lambda x: x * torch.tanh(torch.nn.functional.softplus(x))
  return {
      'silu': torch.nn.functional.silu,
      'gelu': lambda x: torch.nn.functional.gelu(x, approximate='tanh'),
      'relu': torch.relu, 'tanh': torch.tanh, 'sigmoid': torch.sigmoid,
      'elu': torch.nn.functional.elu}[name]


def symlog(x):
  return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
  return torch.sign(x) * torch.expm1(torch.abs(x))


def where(condition, xs, ys):
  """Per-row select between two trees; condition (B,) bool."""
  assert condition.ndim == 1, condition.shape
  def fn(x, y):
    c = condition
    while c.ndim < x.ndim:
      c = c[..., None]
    return torch.where(c, x, y)
  if isinstance(xs, dict):
    return {k: where(condition, xs[k], ys[k]) for k in xs}
  if isinstance(xs, (list, tuple)):
    return type(xs)(where(condition, x, y) for x, y in zip(xs, ys))
  return fn(xs, ys)


def mask(xs, m):
  def fn(x):
    mm = m
    while mm.ndim < x.ndim:
      mm = mm[..., None]
    return x * mm.to(x.dtype)
  return tree_map(fn, xs)


class Initializer:
  """Weight initializers with fan modes, as the port's: trunc_normal
  (rescaled to keep the requested std), normal, uniform and zeros, with
  fan in, out or avg. `std(shape)` is what the benchmark draws with."""

  def __init__(self, dist='trunc_normal', fan='in', scale=1.0):
    self.dist = dist
    self.fan = fan
    self.scale = scale

  @classmethod
  def parse(cls, spec, scale=1.0):
    # e.g. 'trunc_normal_in', 'normal_avg', 'uniform_out', 'zeros'
    if isinstance(spec, cls):
      return cls(spec.dist, spec.fan, spec.scale * scale)
    parts = spec.split('_')
    if parts[-1] in ('in', 'out', 'avg'):
      fan = parts[-1]
      dist = '_'.join(parts[:-1])
    else:
      fan = 'in'
      dist = spec
    return cls(dist, fan, scale)

  def std(self, shape):
    """The standard deviation of the values at `shape` (0 for zeros)."""
    if self.dist == 'zeros' or self.scale == 0.0:
      return 0.0
    fan_in, fan_out = self._fans(tuple(shape))
    fan = {'in': fan_in, 'out': fan_out,
           'avg': (fan_in + fan_out) / 2}[self.fan]
    return float(np.sqrt(self.scale / max(1.0, fan)))

  def _fans(self, shape):
    if len(shape) == 0:
      return 1, 1
    if len(shape) == 1:
      return shape[0], shape[0]
    if len(shape) == 2:
      return shape[0], shape[1]
    # Conv kernels: (..., spatial, in, out)
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive
