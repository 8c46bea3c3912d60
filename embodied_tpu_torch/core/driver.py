"""Synchronous vectorized environment loop.

The inline and thread transports of embodied_tpu/core/driver.py: lockstep
batch stepping of N envs, the 'log/' key split, action masking at episode
boundaries and per-env transition callbacks.

- `inline` (parallel=False): envs stepped in the caller's thread.
- `thread` (parallel='thread'): a thread pool steps all envs each tick.
"""

import multiprocessing as mp

import numpy as np

from ..utils import tree


class _Inline:
  """Envs owned and stepped by the calling thread."""

  def __init__(self, ctors):
    self.envs = [ctor() for ctor in ctors]
    self.act_space = self.envs[0].act_space

  def step(self, row_acts):
    return [env.step(act) for env, act in zip(self.envs, row_acts)]

  def close(self):
    for env in self.envs:
      env.close()


class _Threads(_Inline):
  """Envs stepped concurrently by a pool; relies on GIL-releasing envs."""

  def __init__(self, ctors):
    super().__init__(ctors)
    from concurrent.futures import ThreadPoolExecutor
    workers = min(len(self.envs), 4 * (mp.cpu_count() or 1))
    self.pool = ThreadPoolExecutor(workers, thread_name_prefix='driver-env')

  def step(self, row_acts):
    futures = [
        self.pool.submit(env.step, act)
        for env, act in zip(self.envs, row_acts)]
    return [f.result() for f in futures]

  def close(self):
    self.pool.shutdown(wait=True)
    super().close()


_TRANSPORTS = {False: _Inline, 'thread': _Threads}


class Driver:

  def __init__(self, make_env_fns, parallel=False, **kwargs):
    assert make_env_fns, 'need at least one env ctor'
    if parallel not in _TRANSPORTS:
      raise ValueError(f'Unsupported transport {parallel!r}')
    self.parallel = parallel
    self.length = len(make_env_fns)
    self.kwargs = kwargs
    self.transport = _TRANSPORTS[parallel](make_env_fns)
    self.act_space = self.transport.act_space
    self.callbacks = []
    self.acts = None
    self.carry = None
    self.reset()

  def reset(self, init_policy=None):
    null = lambda space: np.zeros((self.length,) + space.shape, space.dtype)
    self.acts = {key: null(space) for key, space in self.act_space.items()}
    self.acts['reset'] = np.ones(self.length, bool)
    self.carry = init_policy(self.length) if init_policy else None

  def on_step(self, callback):
    self.callbacks.append(callback)

  def __call__(self, policy, steps=0, episodes=0):
    done_steps, done_episodes = 0, 0
    while done_steps < steps or done_episodes < episodes:
      finished = self._tick(policy)
      done_steps += self.length
      done_episodes += finished

  def _tick(self, policy):
    """One lockstep round: step envs, run the policy, fire callbacks."""
    rows = self.transport.step([
        {key: col[i] for key, col in self.acts.items()}
        for i in range(self.length)])
    batch = {
        key: np.stack([row[key] for row in rows])
        for key in rows[0].keys()}
    logs = {k: batch.pop(k) for k in list(batch) if k.startswith('log/')}
    self.carry, acts, extras = policy(self.carry, batch, **self.kwargs)
    overlap = set(acts) & set(extras)
    assert not overlap, f'policy outs shadow acts: {sorted(overlap)}'
    ending = batch['is_last']
    if ending.any():
      # Null out actions of envs whose episode just ended, so the stored
      # prevact at the next episode start is the zero action.
      keep = ~ending
      acts = {
          key: value * _fit(keep, value).astype(value.dtype)
          for key, value in acts.items()}
    self.acts = dict(acts, reset=ending.copy())
    merged = {**batch, **acts, **extras, **logs}
    for i in range(self.length):
      row = tree.tree_map(lambda col: col[i], merged)
      for callback in self.callbacks:
        callback(row, i, **self.kwargs)
    return int(ending.sum())

  def close(self):
    self.transport.close()


def _fit(mask, value):
  """Right-pad mask dims until it broadcasts against value."""
  return mask.reshape(mask.shape + (1,) * (value.ndim - mask.ndim))
