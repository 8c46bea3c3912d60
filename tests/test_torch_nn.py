"""The port's layers, heads and distributions against the JAX modules.

Each JAX module is initialized with `nn.init`, its store is carried into
the port with `parallel.convert.from_jax`, and both run on the same numpy
inputs in float32 (tolerance 1e-5: summation order only) or, for one case
per layer kind, bfloat16 (tolerance 2e-2: rounding at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu.utils import Space as JSpace
from embodied_tpu_torch import nn
from embodied_tpu_torch.models.dreamerv3 import rssm
from embodied_tpu_torch.nn import dists
from embodied_tpu_torch.parallel import convert
from embodied_tpu_torch.utils import Space

F32 = 1e-5


@pytest.fixture
def jax_f32():
  previous = jnn.core.COMPUTE_DTYPE
  jnn.set_compute_dtype(jnp.float32)
  yield
  jnn.set_compute_dtype(previous)


def jax_run(fn, *args):
  """Initialize and apply a JAX ctx function; returns (store, output)."""
  key = jax.random.PRNGKey(0)
  store, meta = jnn.init(fn)(key, *args)
  _, out = jnn.pure(fn, meta)(store, key, *args)
  return store, out


def port(module, store):
  """Wrap `module` under its scope name and load the JAX store into it."""
  root = torch.nn.Module()
  root.add_module(module.name, module)
  assert not nn.load_store(root, convert.from_jax(store))
  return module


def t(x, dtype=torch.float32):
  return torch.tensor(np.asarray(x, np.float32), dtype=dtype)


def check(got, want, tol=F32):
  np.testing.assert_allclose(
      got.float().detach().numpy(), np.asarray(want, np.float32),
      rtol=tol, atol=tol)


def test_linear_and_block_linear(jax_f32):
  x = np.random.default_rng(0).standard_normal((5, 12)).astype(np.float32)
  store, want = jax_run(
      lambda ctx, x: jnn.Linear((3, 4), 'lin', outscale=0.5)(ctx, x), x)
  mod = port(nn.Linear(12, (3, 4), 'lin', outscale=0.5,
                       cdtype=torch.float32), store)
  check(mod(t(x)), want)
  store, want = jax_run(
      lambda ctx, x: jnn.BlockLinear(8, 4, 'blk')(ctx, x), x)
  mod = port(nn.BlockLinear(12, 8, 4, 'blk', cdtype=torch.float32), store)
  check(mod(t(x)), want)


def test_linear_bf16():
  x = np.random.default_rng(1).standard_normal((5, 12)).astype(np.float32)
  store, want = jax_run(lambda ctx, x: jnn.Linear(7, 'lin')(ctx, x), x)
  mod = port(nn.Linear(12, 7, 'lin'), store)
  got = mod(t(x))
  assert got.dtype == torch.bfloat16
  check(got, want, 2e-2)


@pytest.mark.parametrize('impl', ['rms', 'layer', 'rms1e-3', 'none'])
def test_norm(jax_f32, impl):
  x = 3 * np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
  def fn(ctx, x):
    norm = jnn.Norm(impl, 'norm')
    ctx('norm').param('scale', (6,), jnp.linspace(0.5, 1.5, 6))
    if impl == 'layer':
      ctx('norm').param('shift', (6,), jnp.linspace(-1, 1, 6))
    return norm(ctx, x)
  store, want = jax_run(fn, x)
  mod = nn.Norm(impl, 'norm', 6, cdtype=torch.float32)
  if impl == 'none':
    store = {}
  check(port(mod, store)(t(x)), want)


def test_conv_and_pool(jax_f32):
  x = np.random.default_rng(3).standard_normal((2, 8, 8, 5)).astype(
      np.float32)
  def fn(ctx, x):
    y = jnn.Conv2D(6, 5, 'conv')(ctx, x)
    return jax.lax.reduce_window(
        y, -float('inf'), jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), 'VALID')
  store, want = jax_run(fn, x)
  mod = port(nn.Conv2D(5, 6, 5, 'conv', cdtype=torch.float32), store)
  got = rssm.max_pool(mod(t(x)))
  check(got, want, 1e-4)
  store, want = jax_run(
      lambda ctx, x: jnn.Conv2D(4, 3, 'conv', stride=2)(ctx, x), x)
  mod = port(nn.Conv2D(5, 4, 3, 'conv', stride=2, cdtype=torch.float32),
             store)
  check(mod(t(x)), want, 1e-4)


def test_dict_concat_and_mlp(jax_f32):
  rng = np.random.default_rng(4)
  spaces = dict(vec=(np.float32, (3,)), tok=(np.int32, (), 0, 7))
  jspaces = {k: JSpace(*v) for k, v in spaces.items()}
  tspaces = {k: Space(*v) for k, v in spaces.items()}
  xs = dict(vec=5 * rng.standard_normal((4, 3)).astype(np.float32),
            tok=rng.integers(0, 7, (4,)).astype(np.int32))
  def fn(ctx, xs):
    x = jnn.DictConcat(jspaces, 1, squish=jnn.symlog)(ctx, xs)
    return x, jnn.MLP(2, 9, 'mlp')(ctx, x)
  store, (want_x, want_y) = jax_run(fn, xs)
  concat = nn.DictConcat(tspaces, squish=nn.symlog, cdtype=torch.float32)
  assert concat.width == 10
  x = concat({'vec': t(xs['vec']), 'tok': torch.tensor(xs['tok'])})
  check(x, want_x)
  mlp = port(nn.MLP(10, 2, 9, 'mlp', cdtype=torch.float32), store)
  check(mlp(x), want_y)


def test_mlp_head_categorical(jax_f32):
  x = np.random.default_rng(5).standard_normal((3, 11)).astype(np.float32)
  jspace = {'action': JSpace(np.int32, (), 0, 5)}
  tspace = {'action': Space(np.int32, (), 0, 5)}
  kw = dict(layers=2, units=16, outscale=0.5, unimix=0.01, minstd=0.1)
  store, want = jax_run(
      lambda ctx, x: jnn.MLPHead(jspace, 'categorical', 'pol', **kw)(
          ctx, x, 1)['action'].logprobs, x)
  head = port(nn.MLPHead(tspace, 'categorical', 'pol', 11,
                         cdtype=torch.float32, **kw), store)
  dist = head(t(x), bdims=1)['action']
  check(dist.logprobs, want)


def test_onehot_head_with_unimix(jax_f32):
  x = np.random.default_rng(6).standard_normal((3, 11)).astype(np.float32)
  jspace = JSpace(np.int32, (2,), 0, 4)
  tspace = Space(np.int32, (2,), 0, 4)
  store, want = jax_run(
      lambda ctx, x: jnn.Head(jspace, 'onehot', 'head', unimix=0.1)(
          ctx, x).logp(jnp.eye(4)[jnp.array([[0, 3]] * 3)]), x)
  head = port(nn.Head(tspace, 'onehot', 'head', 11, unimix=0.1,
                      cdtype=torch.float32), store)
  value = torch.eye(4)[torch.tensor([[0, 3]] * 3)]
  check(head(t(x)).logp(value), want)


@pytest.mark.parametrize('unimix', [0.0, 0.01, 0.3])
def test_categorical_and_onehot_logprobs(unimix):
  logits = 4 * np.random.default_rng(7).standard_normal((6, 3, 5)).astype(
      np.float32)
  from embodied_tpu.nn import dists as jdists
  jcat = jdists.Categorical(jnp.asarray(logits), unimix)
  cat = dists.Categorical(t(logits), unimix)
  check(cat.logprobs, jcat.logprobs)
  check(cat.entropy(), jcat.entropy())
  value = np.random.default_rng(8).integers(0, 5, (6, 3))
  check(cat.logp(torch.tensor(value)), jcat.logp(jnp.asarray(value)))
  jone = jdists.Agg(jdists.OneHot(jnp.asarray(logits), unimix), 1)
  one = dists.Agg(dists.OneHot(t(logits), unimix), 1)
  onehot = np.eye(5, dtype=np.float32)[value]
  check(one.logp(t(onehot)), jone.logp(jnp.asarray(onehot)))
  check(one.entropy(), jone.entropy())
  check(one.kl(dists.Agg(dists.OneHot(t(logits[::-1].copy()), unimix), 1)),
        jone.kl(jdists.Agg(jdists.OneHot(
            jnp.asarray(logits[::-1].copy()), unimix), 1)))


def test_injected_noise_gives_the_gumbel_max_sample():
  logits = np.random.default_rng(9).standard_normal((4, 3, 6)).astype(
      np.float32)
  noise = np.random.default_rng(10).gumbel(size=logits.shape).astype(
      np.float32)
  one = dists.OneHot(t(logits), 0.01)
  got = one.sample(noise=t(noise))
  want = np.argmax(np.asarray(one.logits) + noise, -1)
  np.testing.assert_array_equal(got.argmax(-1).numpy(), want)
  np.testing.assert_array_equal(got.sum(-1).numpy(), 1.0)


@pytest.mark.parametrize('unimix', [0.0, 0.1])
def test_sampler_frequencies_match_probabilities(unimix):
  # 40000 draws per row: the standard error of a frequency is below 0.0025,
  # so 0.01 is four standard errors.
  logits = torch.tensor([[2.0, 0.0, -1.0, 0.5], [0.0, 0.0, 0.0, 3.0]])
  n = 40000
  gen = torch.Generator().manual_seed(0)
  one = dists.OneHot(logits[None].expand(n, 2, 4), unimix)
  freq = one.sample(gen).mean(0)
  probs = torch.exp(dists.OneHot(logits, unimix).logits)
  torch.testing.assert_close(freq, probs, atol=0.01, rtol=0)
  cat = dists.Categorical(logits[None].expand(n, 2, 4), unimix)
  draws = cat.sample(gen)
  freq = torch.nn.functional.one_hot(draws, 4).float().mean(0)
  torch.testing.assert_close(freq, probs, atol=0.01, rtol=0)
  # Fresh generators with different seeds give different draws.
  other = cat.sample(torch.Generator().manual_seed(1))
  assert (other != draws).any()
