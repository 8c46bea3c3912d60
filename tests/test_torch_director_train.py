"""One Director train step in the port against the JAX model's.

`test_torch_director`'s setup: the JAX store loaded unchanged, one batch,
the JAX draws recorded and replayed, float32. Held against JAX: the
step's metrics, every parameter, the four optimizers' moments, the
normalizers' and slow critics' state and the replay outputs, with and
without the Explore behaviour and with a continuous action (whose
rollout carries the worker's gradient through the dynamics). Tolerances
are `test_torch_slice`'s: a first update of lr * sign(g), at most 2 lr
apart where two frameworks round a near-zero gradient to opposite signs,
99% of the entries within 1e-6; the square moments 1e-3 relative in
norm. The later optimizers of a step see the parameters the earlier ones
updated, so the step's metrics and state are held at 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu_torch import nn
from test_torch_director import (  # noqa: F401
    B, CONT, EXPLORE, LR, SIZE, STEP_TOL, T, close, grad_close,
    jax_f32, jax_recorded, setup, torch_data)


@pytest.mark.parametrize('args', [
    pytest.param(SIZE, id='default'),
    pytest.param(SIZE + EXPLORE, id='explore'),
    pytest.param(CONT, id='continuous')])
def test_train_step_matches_jax(jax_recorded, args):
  rec = jax_recorded
  jm, agent, data, store, meta = setup(rec, args, 13)
  rec.start(14)
  train = lambda ctx, data: jm.train(ctx, jm.init_train(ctx, B), data)
  updates, (carry, outs, mets) = jax.jit(jnn.pure(train, meta))(
      store, jax.random.PRNGKey(2), data)
  after = {**store, **updates}
  draws = rec.replay()
  model = agent.model
  got_carry, got_outs, got = model.train_step(
      model.init_train(B), torch_data(data), draws)
  assert draws.used_all()
  assert sorted(got) == sorted(mets)
  for key in got:
    if not key.endswith('/update_rms'):
      close(torch.as_tensor(got[key]), mets[key], key, tol=STEP_TOL)
  close(got_carry[0]['deter'], carry[0]['deter'], 'carry')
  now = {k: v.detach().numpy() for k, v in nn.store(model).items()}
  assert sorted(now) == sorted(after)
  for path, want in after.items():
    want, value = np.asarray(want, np.float32), now[path].astype(np.float32)
    if meta.get(path) == 'param' and '/slow_' not in path:
      np.testing.assert_allclose(value, want, atol=2 * LR + 1e-6, rtol=0,
                                 err_msg=path)
      assert np.mean(np.abs(value - want) <= 1e-6) >= 0.99, path
    elif path.endswith('/mom_flat'):
      np.testing.assert_allclose(value, want, atol=2 * 0.1 + 1e-6, rtol=0)
      assert np.mean(np.abs(value - want) <= 1e-5) >= 0.99, path
    elif path.endswith('/rms_flat'):
      grad_close(torch.tensor(value), want, path)
    else:
      close(value, want, path, tol=STEP_TOL)
  replay = {k: v.numpy() for k, v in got_outs['replay'].items()}
  assert sorted(replay) == sorted(outs['replay'])
  for key, value in replay.items():
    want = np.asarray(outs['replay'][key])
    assert value.shape == want.shape and value.shape[:2] == (B, T), key
    assert np.abs(value.astype(int) - want.astype(int)).max() <= (
        1 if key == 'dyn/deter' else 0), key
