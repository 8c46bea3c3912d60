"""The port's transposed Conv2D, Conv3D, rope, Attention, Transformer and
StackedLayers against the JAX package's (embodied_tpu/nn/layers.py,
nn/stacked.py) on the same seeded numpy inputs, with the JAX store
loaded into the port. Float32 at TOL (summation order only); one
bfloat16 attention case at 2e-2, where the logits round to bf16 before
the float32 softmax as in the JAX layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu_torch import nn
from embodied_tpu_torch.parallel import convert

TOL = 1e-4


@pytest.fixture
def jax_f32():
  previous = jnn.core.COMPUTE_DTYPE
  jnn.set_compute_dtype(jnp.float32)
  yield
  jnn.set_compute_dtype(previous)


def jax_run(fn, *args):
  key = jax.random.PRNGKey(0)
  store, meta = jnn.init(fn)(key, *args)
  _, out = jnn.pure(fn, meta)(store, key, *args)
  return store, meta, out


def port(module, store):
  root = torch.nn.Module()
  root.add_module(module.name, module)
  assert not nn.load_store(root, convert.from_jax(store))
  return module


def t(x, dtype=torch.float32):
  return torch.tensor(np.asarray(x, np.float32), dtype=dtype)


def check(got, want, tol=TOL):
  np.testing.assert_allclose(
      got.float().detach().numpy(), np.asarray(want, np.float32),
      rtol=tol, atol=tol)


def normal(seed, *shape):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


@pytest.mark.parametrize('kernel,stride,shape', [
    (3, 2, (2, 4, 4, 5)), (5, 2, (2, 4, 4, 5)),
    (5, 2, (1, 3, 6, 4)),  # ragged: height 3, width 6
    (4, 2, (1, 3, 5, 2)), (5, 1, (2, 4, 4, 3)), (1, 2, (1, 3, 3, 2))])
def test_transposed_conv2d(jax_f32, kernel, stride, shape):
  """lax.conv_transpose(..., 'SAME', ('NHWC', 'HWOI', 'NHWC')): the
  kernel unflipped, the stride-2 input padded asymmetrically (3, 2) at
  K = 5, the output `stride` times the input's size."""
  x = normal(kernel, *shape)
  store, _, want = jax_run(lambda ctx, x: jnn.Conv2D(
      6, kernel, 'up', stride=stride, transp=True)(ctx, x), x)
  assert store['up/kernel'].shape == (kernel, kernel, 6, shape[-1])
  mod = port(nn.Conv2D(shape[-1], 6, kernel, 'up', stride=stride,
                       transp=True, cdtype=torch.float32), store)
  got = mod(t(x))
  assert got.shape == (shape[0], shape[1] * stride, shape[2] * stride, 6)
  check(got, want)


@pytest.mark.parametrize('stride,shape', [
    (1, (2, 4, 5, 6, 3)), (2, (1, 5, 4, 6, 2))])
def test_conv3d(jax_f32, stride, shape):
  x = normal(stride, *shape)
  store, _, want = jax_run(
      lambda ctx, x: jnn.Conv3D(4, 3, 'c3', stride=stride)(ctx, x), x)
  mod = port(nn.Conv3D(shape[-1], 4, 3, 'c3', stride=stride,
                       cdtype=torch.float32), store)
  assert mod.kernel.shape == (3, 3, 3, shape[-1], 4)
  check(mod(t(x)), want)


def test_rope():
  x = normal(3, 2, 3, 7, 8)
  positions = np.stack([np.arange(7), np.arange(7) + 5]).astype(np.int32)
  want = jnn.rope(jnp.asarray(x), jnp.asarray(positions)[:, None])
  got = nn.rope(t(x), torch.tensor(positions)[:, None])
  check(got, want, 1e-5)
  # Rotations keep each pair's norm.
  check(got.square().sum(-1), (x ** 2).sum(-1), 1e-4)


ATTENTION = {
    'dense': dict(),
    'gqa': dict(kvheads=2),
    'masked': dict(kvheads=1),
    'no qknorm': dict(qknorm=False, bias=True),
}


@pytest.mark.parametrize('case', list(ATTENTION))
def test_attention(jax_f32, case):
  kw = ATTENTION[case]
  x = normal(4, 2, 6, 16)
  mask = np.tril(np.ones((6, 6), bool))
  mask[:, 0] = True
  mask = mask if case == 'masked' else None

  def fn(ctx, x):
    return jnn.Attention(16, 4, 'attn', **kw)(ctx, x, mask)
  store, _, want = jax_run(fn, x)
  mod = port(nn.Attention(16, 16, 4, 'attn', cdtype=torch.float32, **kw),
             store)
  got = mod(t(x), None if mask is None else torch.tensor(mask))
  check(got, want)


def test_attention_bf16_rounds_as_jax():
  x = normal(5, 2, 8, 32)
  positions = np.tile(np.arange(3, 11, dtype=np.int32), (2, 1))
  fn = lambda ctx, x: jnn.Attention(32, 4, 'attn', kvheads=2)(
      ctx, x, None, jnp.asarray(positions))
  store, _, want = jax_run(fn, x)
  mod = port(nn.Attention(32, 32, 4, 'attn', kvheads=2), store)
  got = mod(t(x), None, torch.tensor(positions))
  assert got.dtype == torch.bfloat16
  check(got, want, 2e-2)


@pytest.mark.parametrize('glu', [True, False])
def test_transformer(jax_f32, glu):
  x = normal(6, 2, 5, 16)
  mask = np.tril(np.ones((5, 5), bool))
  fn = lambda ctx, x: jnn.Transformer(
      2, 16, 4, 'tf', ffmult=2, glu=glu, kvheads=2, causal=True)(ctx, x, mask)
  store, _, want = jax_run(fn, x)
  mod = port(nn.Transformer(2, 16, 4, 'tf', ffmult=2, glu=glu, kvheads=2,
                            causal=True, cdtype=torch.float32), store)
  assert ('tf/ff0gate/kernel' in store) == glu
  check(mod(t(x), torch.tensor(mask)), want)


class JBlock(jnn.Module):

  def __init__(self, name):
    super().__init__(name)
    self.norm = jnn.Norm('rms', 'norm')
    self.attn = jnn.Attention(16, 4, 'attn', kvheads=2)
    self.ff = jnn.Linear(16, 'ff')

  def __call__(self, ctx, x):
    p = self.sub(ctx)
    x = x + self.attn(p, self.norm(p, x))
    return x + jnp.tanh(self.ff(p, x))


class Block(nn.Module):

  def __init__(self, name, cdtype=torch.float32):
    super().__init__(name, cdtype)
    self.norm = nn.Norm('rms', 'norm', 16, cdtype=cdtype)
    self.attn = nn.Attention(16, 16, 4, 'attn', kvheads=2, cdtype=cdtype)
    self.ff = nn.Linear(16, 16, 'ff', cdtype=cdtype)

  def forward(self, x):
    x = x + self.attn(self.norm(x))
    return x + torch.tanh(self.ff(x))


def test_stacked_layers_forward_and_gradients(jax_f32):
  """JAX's stacked store (3 layers under 'stack/block/...') loaded into
  the port: the outputs and the gradients of every slice agree."""
  x = normal(7, 2, 5, 16)
  w = normal(8, 2, 5, 16)
  stack = jnn.StackedLayers(JBlock('block'), 3, 'stack')
  store, meta, want = jax_run(lambda ctx, x: stack(ctx, x), x)
  assert store['stack/block/attn/q/kernel'].shape == (3, 16, 16)

  def loss(params):
    _, y = jnn.pure(lambda ctx, x: stack(ctx, x), meta)(
        {**store, **params}, jax.random.PRNGKey(0), x)
    return (y * w).sum()
  params = {k: v for k, v in store.items() if meta[k] == 'param'}
  jgrads = jax.grad(loss)(params)

  mod = port(nn.StackedLayers(Block('block'), 3, 'stack'), store)
  got = mod(t(x))
  check(got, want)
  (got * t(w)).sum().backward()
  named = dict(mod.named_parameters())
  assert len(named) == len(jgrads)
  for name, param in named.items():
    path = 'stack/' + name.replace('.', '/')
    assert param.grad is not None and param.grad.abs().sum() > 0, path
    check(param.grad, jgrads[path])
  # Three layers unrolled on the same slices give the same output.
  block = Block('block')
  y = t(x)
  for i in range(3):
    for name, param in block.named_parameters():
      param.data = dict(mod.layer.named_parameters())[name][i].detach()
    y = block(y)
  check(y, got.detach(), 1e-6)


def test_stacked_layers_own_init():
  """The port's own init (torch and JAX streams differ): every entry
  stacked under the JAX paths and shapes, each slice drawn as the layer's
  own parameter would be, the slices different."""
  stack = nn.StackedLayers(nn.Linear(64, 48, 'lin'), 4, 'stack')
  root = torch.nn.Module()
  root.add_module('stack', stack)
  nn.init_params(root, seed=0)
  store = nn.store(root)
  assert {k: tuple(v.shape) for k, v in store.items()} == {
      'stack/lin/kernel': (4, 64, 48), 'stack/lin/bias': (4, 48)}
  kernel = store['stack/lin/kernel']
  for i in range(3):
    assert not torch.allclose(kernel[i], kernel[i + 1])
  std = kernel.std(dim=(1, 2))
  assert (abs(std / 64 ** -0.5 - 1) < 0.05).all(), std
  assert not store['stack/lin/bias'].any()
