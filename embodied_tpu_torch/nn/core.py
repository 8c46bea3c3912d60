"""Module base, parameter store and tensor helpers of the port.

The JAX package keeps every parameter in one flat store {path: array}
(embodied_tpu/nn/core.py). Here the store is the module tree itself: a
parameter's `state_dict` key is its JAX path with '/' replaced by '.', so
`dyn.dynin0.kernel` is `dyn/dynin0/kernel`, and shapes and layouts are the
JAX ones. `store(module)` and `load_store(module, store)` convert between
the two forms, so a JAX store loads unchanged.

A store that is sharded over ranks (parallel/agent.py) keeps each entry's
Parameter or buffer object and swaps what it holds: `entries` gives the
objects themselves and `assign` points them at other tensors, of another
shape too. Between the Agent's calls a sharded entry holds the rank's
slice, so `store` gives slices and `load_store` takes them; during a
call that reads parameters it holds the full tensor. Within such a call
on a mesh with t > 1, `Module.split` says whether a layer's kernel or
embedding computes only the rank's part of its product
(parallel/tensor.py).

Parameters are float32. State that is not trained (normaliser statistics,
the optimizer's step and moments, counters) is kept as buffers under the
JAX paths, so it travels with the store too. Layers compute in a compute
dtype (bfloat16 by default) that every module takes at construction, so
tests can build the same network in float32. Random draws come from explicit
`torch.Generator`s: initial weights from one generator per parameter,
seeded from (seed, crc32(path)) so that the values do not depend on the
order in which modules are built.
"""

import math
import threading
import zlib

import numpy as np
import torch

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32

DTYPES = {
    'bfloat16': torch.bfloat16, 'float16': torch.float16,
    'float32': torch.float32}
_NUMPY_DTYPES = {
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(bool): torch.bool,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8}


def torch_dtype(dtype):
  """The torch dtype of a numpy dtype (a space's)."""
  return _NUMPY_DTYPES[np.dtype(dtype)]


# Torch keeps '.' for its module scopes, so an entry whose JAX name holds a
# '.' (the optimizer's per-parameter slots, 'rms.enc.cnn0.kernel') is
# registered with NAME_DOT in its place; `store_path` puts it back.
NAME_DOT = '\u00b7'


def store_path(key):
  """The store path of a `state_dict` key."""
  return key.replace('.', '/').replace(NAME_DOT, '.')


class _Split(threading.local):
  active = None  # parallel.tensor.Split, set by parallel.tensor.split_over


SPLIT = _Split()


class Module(torch.nn.Module):
  """Base for layers. `name` is the module's scope in the JAX store."""

  def __init__(self, name, cdtype=COMPUTE_DTYPE):
    super().__init__()
    assert isinstance(name, str) and name, name
    self.name = name
    self.cdtype = cdtype
    self._inits = {}

  def child(self, module):
    """Register `module` under its JAX scope name and return it. Keep the
    result in a list or dict, or in an attribute of the same name: a
    module assigned to an attribute is registered under that name too."""
    self.add_module(module.name, module)
    return module

  def param(self, name, shape, init):
    """Create a float32 parameter; `init` is an Initializer or a constant.
    Values are drawn by `init_params`, not here."""
    shape = tuple(int(x) for x in shape)
    self.register_parameter(
        name, torch.nn.Parameter(torch.empty(shape, dtype=PARAM_DTYPE)))
    self._inits[name] = init
    return getattr(self, name)

  def state(self, name, shape, init, dtype=torch.float32):
    """Create a buffer filled with `init`: state kept in the store but not
    trained (`p.state` in JAX). `name` may hold '.' (NAME_DOT)."""
    shape = tuple(int(x) for x in shape)
    name = name.replace('.', NAME_DOT)
    self.register_buffer(name, torch.full(shape, init, dtype=dtype))
    return getattr(self, name)

  def cast(self, xs, force=False):
    return cast(xs, self.cdtype, force)

  def split(self, entry):
    """The Split (parallel/tensor.py) under which this module's `entry`
    ('kernel' or 'embed') computes split on this thread, else None."""
    split = SPLIT.active
    if split is not None and entry in split.entries.get(id(self), ()):
      return split
    return None


def path_seed(seed, path):
  state = np.random.SeedSequence([int(seed), zlib.crc32(path.encode())])
  return int(state.generate_state(1, np.uint64)[0] & ((1 << 63) - 1))


@torch.no_grad()
def init_params(root, seed):
  """Draw every parameter of `root` from its initializer."""
  for mname, module in root.named_modules():
    for pname, init in getattr(module, '_inits', {}).items():
      path = '/'.join(x for x in mname.split('.') + [pname] if x)
      param = getattr(module, pname)
      if callable(init):
        gen = torch.Generator().manual_seed(path_seed(seed, path))
        value = init(gen, tuple(param.shape))
      else:
        value = torch.full(tuple(param.shape), float(init))
      param.copy_(value)
  for module in root.modules():
    if hasattr(module, 'post_init'):
      module.post_init()


def store(root):
  """The module tree as a flat JAX-style store {path: tensor}."""
  return {store_path(k): v for k, v in root.state_dict().items()}


def entries(root):
  """The module tree's parameters and buffers themselves (not detached
  views) by store path."""
  return {store_path(k): v
          for k, v in root.state_dict(keep_vars=True).items()}


@torch.no_grad()
def assign(root, values):
  """Point each entry of `values` ({path: tensor}) at that tensor, whatever
  its shape: the entry's object stays (an optimizer's reference to a
  parameter still holds), what it holds changes, and its earlier storage
  is freed unless something else holds it."""
  held = entries(root)
  for path, value in values.items():
    held[path].data = value


@torch.no_grad()
def load_store(root, values, strict=True):
  """Copy {path: array} into the module tree; returns unused paths.
  Every entry of the tree must be present, unless not `strict`: then the
  entries the store lacks keep their values."""
  params = dict(root.state_dict())
  paths = {store_path(k): k for k in params}
  missing = sorted(set(paths) - set(values))
  if missing and strict:
    raise KeyError(f'Store lacks {len(missing)} entries: {missing[:5]}')
  for path, key in paths.items():
    if path in missing:
      continue
    value = np.asarray(values[path])
    if value.dtype.kind == 'V' or value.dtype.name == 'bfloat16':
      value = value.astype(np.float32)
    value = torch.tensor(value)
    if tuple(value.shape) != tuple(params[key].shape):
      raise ValueError(
          f'{path}: shape {tuple(value.shape)} != {tuple(params[key].shape)}')
    params[key].copy_(value.to(params[key].dtype))
  return sorted(set(values) - set(paths))


def tree_map(fn, xs):
  if isinstance(xs, dict):
    return {k: tree_map(fn, v) for k, v in xs.items()}
  if isinstance(xs, (list, tuple)):
    return type(xs)(tree_map(fn, x) for x in xs)
  return fn(xs)


def cast(xs, dtype=COMPUTE_DTYPE, force=False):
  """Cast floating tensors to `dtype`; integers only when `force`."""
  def fn(x):
    if x is None:
      return x
    if x.is_floating_point() or (force and x.dtype != torch.bool):
      return x.to(dtype)
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
  """Weight initializers with fan modes, as embodied_tpu.nn.Initializer:
  trunc_normal (rescaled to keep the requested std), normal, uniform,
  normed and zeros, with fan in, out or avg."""

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

  def __call__(self, gen, shape):
    shape = tuple(shape)
    if self.dist == 'zeros' or self.scale == 0.0:
      return torch.zeros(shape)
    fan_in, fan_out = self._fans(shape)
    fan = {'in': fan_in, 'out': fan_out,
           'avg': (fan_in + fan_out) / 2}[self.fan]
    std = math.sqrt(self.scale / max(1.0, fan))
    value = torch.empty(shape)
    if self.dist == 'trunc_normal':
      # Compensate truncation to keep the requested std.
      torch.nn.init.trunc_normal_(value, 0.0, 1.0, -2.0, 2.0, generator=gen)
      value *= std / 0.87962566
    elif self.dist == 'normal':
      value.normal_(0.0, std, generator=gen)
    elif self.dist == 'uniform':
      limit = math.sqrt(3.0) * std
      value.uniform_(-limit, limit, generator=gen)
    elif self.dist == 'normed':
      value.uniform_(-1, 1, generator=gen)
      value *= self.scale / torch.linalg.norm(
          value.reshape((-1, shape[-1])), 2, 0)
    else:
      raise NotImplementedError(self.dist)
    return value

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
