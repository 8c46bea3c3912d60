"""The port's ring attention (embodied_tpu_torch/ops/ring_attention.py) on
four gloo ranks against the JAX package's ring_attention_sharded on a
4-device virtual CPU mesh, on the same seeded numpy q, k and v (B 2, T 32,
H 2, D 16): float32 at 1e-5 (full and causal), bfloat16 at 2e-2
(causal), and the gradients of a loss of the causal float32 output at
1e-5, each rank's block of them. Attention(impl='ring') and a ring-mode
Transformer, on the ranks' blocks of x, against the JAX layers run dense
with a causal mask on the whole x, at 1e-4. The four ranks are one spawn
of child interpreters that import no JAX (tests/torch_distributed_worker.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from embodied_tpu import nn as jnn
from embodied_tpu.ops import ring_attention as jra
from embodied_tpu_torch.parallel import convert
from test_torch_distributed import launch

RANKS = 4
B, T, H, D = 2, 32, 2, 16


@pytest.fixture
def jax_f32():
  previous = jnn.core.COMPUTE_DTYPE
  jnn.set_compute_dtype(jnp.float32)
  yield
  jnn.set_compute_dtype(previous)


def jax_layer(fn, x):
  key = jax.random.PRNGKey(0)
  store, meta = jnn.init(fn)(key, x)
  return convert.from_jax(store), jnn.pure(fn, meta)(store, key, x)[1]


def test_ring_attention_on_four_gloo_ranks(tmp_path, jax_f32):
  rng = np.random.default_rng(0)
  q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
             for _ in range(3))
  x = rng.standard_normal((B, T, 16)).astype(np.float32)
  mesh = Mesh(np.array(jax.devices()[:RANKS]), ('t',))
  want = {}
  for causal in (False, True):
    want[f'f32 causal={causal}'] = jra.ring_attention_sharded(
        q, k, v, mesh, 't', causal=causal)
  want['bf16 causal=True'] = jra.ring_attention_sharded(
      *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), mesh, 't',
      causal=True).astype(jnp.float32)
  loss = lambda *qkv: jnp.square(jra.ring_attention_sharded(
      *qkv, mesh, 't', causal=True)).sum()
  grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
  mask = np.tril(np.ones((T, T), bool))
  attn_store, want['attn'] = jax_layer(lambda ctx, x: jnn.Attention(
      16, 4, 'attn', kvheads=2)(ctx, x, mask), x)
  tf_store, want['tf'] = jax_layer(lambda ctx, x: jnn.Transformer(
      2, 16, 4, 'tf', ffmult=2, kvheads=2)(ctx, x, mask), x)
  # The dense layers agree with JAX's ring-mode layers' definition.
  full = jra.full_attention(q, k, v, causal=True)
  np.testing.assert_allclose(want['f32 causal=True'], full, 1e-5, 1e-5)

  results = launch('ring', dict(q=q, k=k, v=v, x=x, attn_store=attn_store,
                                tf_store=tf_store), tmp_path, world=RANKS)
  blocks = lambda a: np.split(np.asarray(a), RANKS, 1)
  for rank, got in enumerate(results):
    for key, tol in (('f32 causal=False', 1e-5), ('f32 causal=True', 1e-5),
                     ('bf16 causal=True', 2e-2), ('attn', 1e-4),
                     ('tf', 1e-4)):
      np.testing.assert_allclose(got[key], np.asarray(want[key]), tol, tol,
                                 err_msg=f'rank {rank}: {key}')
    for name, value, ref in zip('qkv', got['grads'], grads):
      # Each rank's gradient reaches its own block alone.
      for block, (mine, theirs) in enumerate(zip(blocks(value),
                                                 blocks(ref))):
        np.testing.assert_allclose(
            mine, theirs if block == rank else 0 * theirs, 1e-5, 1e-5,
            err_msg=f'rank {rank}: d{name} block {block}')
