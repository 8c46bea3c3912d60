"""The weights of a run, drawn by the benchmark from the seed.

Every parameter of the reference model is drawn by its initializer's
scheme (truncated normal at +-2 standard deviations scaled to the fan, as
the configuration's `winit`; zeros and constants as given), on the device,
in one generator's few large calls: one uniform draw for all the random
entries, turned into truncated normals through the inverse CDF, then cut
into the entries. The slow value starts as a copy of the value, as the
program's does. The same store loads into the program and the reference.
"""

import math

import torch

from ..reference import nn as refnn

# The standard deviation of a unit normal truncated at +-2.
TRUNC_STD = 0.87962566
SALT = 4_000_037


def scheme(model):
  """[(path, shape, std or None, constant)] of every parameter of the
  reference `model`, in sorted path order: std for a random entry,
  constant for a filled one."""
  out = []
  shapes = {refnn.core.store_path(k): tuple(v.shape)
            for k, v in model.named_parameters()}
  for path, init in sorted(refnn.core.inits(model).items()):
    shape = shapes[path]
    if isinstance(init, refnn.Initializer):
      std = init.std(shape)
      if std and init.dist != 'trunc_normal':
        raise NotImplementedError(f'{path}: initializer {init.dist}')
      out.append((path, shape, std or None, 0.0))
    else:
      out.append((path, shape, None, float(init)))
  return out


@torch.no_grad()
def draw(model, seed, device):
  """{path: float32 tensor on `device`} for every parameter of `model`."""
  entries = scheme(model)
  gen = torch.Generator(device).manual_seed(int(seed) * 1_000_003 + SALT)
  total = sum(math.prod(shape) for _, shape, std, _ in entries if std)
  lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
  u = torch.rand(total, generator=gen, device=device)
  u.mul_(1 - 2 * lo).add_(lo)
  z = torch.erfinv(u.mul_(2).sub_(1)).mul_(math.sqrt(2)).clamp_(-2, 2)
  store, offset = {}, 0
  for path, shape, std, const in entries:
    if std:
      n = math.prod(shape)
      store[path] = z[offset:offset + n].view(shape).mul_(std / TRUNC_STD)
      offset += n
    else:
      store[path] = torch.full(shape, const, device=device)
  for path in list(store):
    if path.startswith('val/'):
      store['slowval/' + path[4:]] = store[path].clone()
  return store
