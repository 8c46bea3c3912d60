"""Framework contracts: Agent, Env, Stream.

A copy of embodied_tpu/core/base.py, so run protocols written against
either package see the same API.

Conventions shared by every implementation:
- Observations are dicts of arrays and must include the boolean episode
  markers ``is_first``, ``is_last``, ``is_terminal``; most envs also emit
  ``reward`` and an ``image``. Keys prefixed ``log/`` carry diagnostics
  that flow to the logger but never reach the agent.
- Action dicts always include a boolean ``reset`` key next to the actual
  action keys.
- Carries are opaque recurrent state threaded through policy/train/report;
  each has its own ``init_*`` because batch sizes differ per role.
"""


def _abstract(signature):
  """Build a method that documents its contract when left unimplemented."""
  def method(self, *args, **kwargs):
    raise NotImplementedError(signature)
  method.__doc__ = signature
  return method


class Agent:
  """Trainable policy: the object every run protocol drives."""

  def __init__(self, obs_space, act_space, config):
    pass

  init_policy = _abstract('init_policy(batch_size) -> carry')
  init_train = _abstract('init_train(batch_size) -> carry')
  init_report = _abstract('init_report(batch_size) -> carry')

  policy = _abstract('policy(carry, obs, mode) -> carry, act, out')
  train = _abstract('train(carry, data) -> carry, out, metrics')
  report = _abstract('report(carry, data) -> carry, metrics')

  # Wrap a data stream with agent-side transforms (device placement,
  # seeding); identity for host-only agents.
  stream = _abstract('stream(st) -> st')

  save = _abstract('save() -> data')
  load = _abstract('load(data) -> None')


class Env:
  """Batched-dict environment with explicit episode-boundary markers."""

  obs_space = property(_abstract('obs_space -> {name: Space}'))
  act_space = property(_abstract('act_space -> {name: Space}'))

  step = _abstract('step(action) -> obs')

  def close(self):
    pass

  def __repr__(self):
    name = type(self).__name__
    return f'{name}(obs_space={self.obs_space}, act_space={self.act_space})'


class Stream:
  """Resumable iterator: a data pipeline whose cursor can be checkpointed."""

  def __iter__(self):
    return self

  __next__ = _abstract('__next__() -> batch')
  save = _abstract('save() -> state')
  load = _abstract('load(state) -> None')
