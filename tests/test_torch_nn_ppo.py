"""The port's layers and heads that PPO adds, against the JAX modules:
Embed, DictEmbed, GRU (one step and a window, with resets), the Huber
penalty, and the huber and normal_logstd heads.

Each JAX module is initialized with `nn.init`, its store is carried into
the port with `parallel.convert.from_jax`, and both run on the same numpy
inputs in float32. Tolerance 1e-5 relative and absolute: summation order
only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu.nn import dists as jdists
from embodied_tpu.utils import Space as JSpace
from embodied_tpu_torch import nn
from embodied_tpu_torch.nn import dists
from embodied_tpu_torch.utils import Space
from test_torch_nn import check, jax_f32, jax_run, port, t  # noqa: F401

B, T = 3, 5


def test_embed(jax_f32):
  x = np.random.default_rng(0).integers(0, 7, (B, T)).astype(np.int32)
  store, want = jax_run(lambda ctx, x: jnn.Embed(7, 6, 'emb')(ctx, x), x)
  mod = port(nn.Embed(7, 6, 'emb', cdtype=torch.float32), store)
  check(mod(torch.from_numpy(x)), want)


SPACES = {
    'vec': ((np.float32, (3,)), {}),
    'tok': ((np.int32, ()), dict(low=0, high=4)),
    'grid': ((np.int32, (2,)), dict(low=0, high=3)),
}


@pytest.mark.parametrize('squish', [False, True], ids=['plain', 'symlog'])
def test_dict_embed(jax_f32, squish):
  rng = np.random.default_rng(1)
  xs = {'vec': 3 * rng.standard_normal((B, T, 3)).astype(np.float32),
        'tok': rng.integers(0, 4, (B, T)).astype(np.int32),
        'grid': rng.integers(0, 3, (B, T, 2)).astype(np.int32)}
  jspaces = {k: JSpace(*a, **kw) for k, (a, kw) in SPACES.items()}
  spaces = {k: Space(*a, **kw) for k, (a, kw) in SPACES.items()}
  jsq, sq = (jnn.symlog, nn.symlog) if squish else (None, None)
  store, want = jax_run(lambda ctx, xs: jnn.DictEmbed(
      jspaces, 8, 'emb', squish=jsq)(ctx, xs, (B, T)), xs)
  assert sorted(store) == sorted(
      f'emb/embed_{k}/{p}' for k in SPACES for p in ('kernel', 'bias'))
  mod = port(nn.DictEmbed(spaces, 8, 'emb', squish=sq,
                          cdtype=torch.float32), store)
  check(mod({k: torch.from_numpy(v) for k, v in xs.items()}, (B, T)), want)


@pytest.mark.parametrize('norm', ['layer', 'rms'])
def test_gru_step_and_window(jax_f32, norm):
  rng = np.random.default_rng(2)
  carry = np.tanh(rng.standard_normal((B, 6))).astype(np.float32)
  inputs = rng.standard_normal((B, T, 4)).astype(np.float32)
  resets = rng.random((B, T)) < 0.3
  resets[0, 2] = True

  def fn(ctx, carry, inputs, resets):
    gru = jnn.GRU(6, 'rnn', norm=norm)
    return (gru(ctx, carry, inputs, resets),
            gru(ctx, carry, inputs[:, 0], resets[:, 0], single=True))
  store, ((want_carry, want_feats), (want_one, _)) = jax_run(
      fn, carry, inputs, resets)
  mod = port(nn.GRU(4, 6, 'rnn', norm=norm, cdtype=torch.float32), store)
  got_carry, got_feats = mod(t(carry), t(inputs), torch.from_numpy(resets))
  check(got_carry, want_carry)
  check(got_feats, want_feats)
  got_one, same = mod(t(carry), t(inputs[:, 0]),
                      torch.from_numpy(resets[:, 0]), single=True)
  check(got_one, want_one)
  assert got_one is same
  # The window is the single step, T times.
  step = t(carry)
  for i in range(T):
    step, _ = mod(step, t(inputs[:, i]), torch.from_numpy(resets[:, i]),
                  single=True)
    torch.testing.assert_close(step, got_feats[:, i], rtol=0, atol=0)
  assert mod.initial(B).shape == (B, 6) and not mod.initial(B).any()


def test_huber(jax_f32):
  rng = np.random.default_rng(3)
  mean = 2 * rng.standard_normal((B, T)).astype(np.float32)
  target = 2 * rng.standard_normal((B, T)).astype(np.float32)
  for eps in (1.0, 0.3):
    want = jdists.Huber(jnp.asarray(mean), eps).loss(jnp.asarray(target))
    check(dists.Huber(t(mean), eps).loss(t(target)), want)
  want = jdists.Huber(jnp.asarray(mean), squash=jnn.symlog).loss(
      jnp.asarray(target))
  check(dists.Huber(t(mean), squash=nn.symlog).loss(t(target)), want)


@pytest.mark.parametrize('output,shape', [
    ('huber', ()), ('huber', (3,)), ('normal_logstd', ()),
    ('normal_logstd', (3,))])
def test_heads(jax_f32, output, shape):
  rng = np.random.default_rng(4)
  x = rng.standard_normal((B, T, 5)).astype(np.float32)
  target = rng.standard_normal((B, T, *shape)).astype(np.float32)

  def fn(ctx, x, target):
    dist = jnn.Head(JSpace(np.float32, shape), output, 'head')(ctx, x)
    out = dict(pred=dist.pred(), loss=dist.loss(target))
    if output == 'normal_logstd':
      out.update(logp=dist.logp(target), entropy=dist.entropy())
    return out
  store, want = jax_run(fn, x, target)
  assert sorted(store) == sorted(
      f'head/{layer}/{p}' for layer in (
          ('pred',) if output == 'huber' else ('mean', 'stddev'))
      for p in ('kernel', 'bias'))
  head = port(nn.Head(Space(np.float32, shape), output, 'head', 5,
                      cdtype=torch.float32), store)
  dist = head(t(x))
  check(dist.pred(), want['pred'])
  check(dist.loss(t(target)), want['loss'])
  if output == 'normal_logstd':
    check(dist.logp(t(target)), want['logp'])
    check(dist.entropy(), want['entropy'])
