"""Synchronous vectorized environment loop.

A copy of embodied_tpu/core/driver.py: lockstep batch stepping of N envs,
the 'log/' key split, action masking at episode boundaries, per-env
transition callbacks, and a child env-server loop with error propagation.

- `inline` (parallel=False): envs stepped in the caller's thread.
- `thread` (parallel='thread'): a thread pool steps all envs each tick.
- `process` (parallel=True/'process', the default): one subprocess per env
  with a shared-memory payload path: after the first transition reveals
  the observation layout, each worker gets a SharedMemory block holding its
  obs and act columns. Steps then exchange only a tiny token over the pipe
  while the payload rides shared memory (lockstep stepping guarantees the
  child is idle while the parent reads the views). Workers whose
  observation layout changes mid-run fall back to the pickled pipe payload.

Unlike the JAX package, the process transport sends each env constructor
with the standard `pickle` (not `cloudpickle`) into a `spawn` context,
which a parent with CUDA live needs. Constructors must therefore be
picklable: a `functools.partial` of a module-level function is, a lambda
is not, and the Driver raises on one before it starts a process.
"""

import multiprocessing as mp
import pickle
from multiprocessing import shared_memory

import numpy as np

from ..utils import timer, tree

_SHM_TOKEN = '__shm__'


def _shm_layout(arrays):
  """(offset, shape, dtype) per key plus total size, 64-byte aligned."""
  layout, cursor = {}, 0
  for key in sorted(arrays.keys()):
    value = np.asarray(arrays[key])
    if value.dtype == object:
      return None, 0
    layout[key] = (cursor, value.shape, value.dtype.str)
    cursor += int(-(-value.nbytes // 64) * 64) or 64
  return layout, max(cursor, 64)


def _shm_views(block, layout):
  views = {}
  for key, (offset, shape, dtype) in layout.items():
    count = int(np.prod(shape)) if shape else 1
    views[key] = np.frombuffer(
        block.buf, np.dtype(dtype), count, offset).reshape(shape)
  return views


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


def _pickled(ctor):
  """The standard pickle of an env constructor; raises a clear error for
  one that does not pickle (a lambda, a local function)."""
  try:
    return pickle.dumps(ctor)
  except (pickle.PicklingError, AttributeError, TypeError) as e:
    raise TypeError(
        f'The process transport sends each env constructor to its worker '
        f'with pickle, and {ctor!r} does not pickle ({e}). Pass a '
        f'functools.partial of a module-level function, or choose '
        f"parallel=False or 'thread'.") from e


class _Fleet:
  """One spawned subprocess per env, lockstep, with shm fast path."""

  def __init__(self, ctors):
    payloads = [_pickled(ctor) for ctor in ctors]
    context = mp.get_context('spawn')
    self.pipes = []
    self.procs = []
    self.shm = []
    for index, payload in enumerate(payloads):
      parent, child = context.Pipe()
      proc = context.Process(
          target=_env_server, daemon=True, args=(index, child, payload))
      proc.start()
      self.pipes.append(parent)
      self.procs.append(proc)
    self.pipes[0].send(('act_space',))
    self.act_space = self._recv(self.pipes[0])
    # One shm record per worker, attached lazily once the first transition
    # reveals that worker's observation layout.
    self.shm = [None] * len(ctors)

  def step(self, row_acts):
    for pipe, record, act in zip(self.pipes, self.shm, row_acts):
      if record is None:
        pipe.send(('step', act))
      else:
        for key, value in act.items():
          record['act_views'][key][...] = value
        pipe.send(('step_shm',))
    rows = []
    for index, pipe in enumerate(self.pipes):
      payload = self._recv(pipe)
      if payload == _SHM_TOKEN:
        # Lockstep: the child idles until our next send, so its views can
        # be read (and stacked by the caller) without copying.
        rows.append(self.shm[index]['views'])
        continue
      rows.append(payload)
      if self.shm[index] is None:
        self._attach(index, payload)
    return rows

  def _attach(self, index, obs):
    """Carve the worker's shared block from its first observation."""
    obs_layout, obs_bytes = _shm_layout(obs)
    acts = {k: np.zeros(s.shape, s.dtype) for k, s in self.act_space.items()}
    act_layout, act_bytes = _shm_layout(acts)
    if obs_layout is None or act_layout is None:
      return  # Non-numeric payloads stay on the pickled pipe path.
    try:
      block = shared_memory.SharedMemory(
          create=True, size=obs_bytes + act_bytes)
    except Exception:
      return
    act_layout = {
        key: (offset + obs_bytes, shape, dtype)
        for key, (offset, shape, dtype) in act_layout.items()}
    self.shm[index] = dict(
        block=block,
        views=_shm_views(block, obs_layout),
        act_views=_shm_views(block, act_layout))
    self.pipes[index].send(('attach_shm', block.name, obs_layout, act_layout))

  def _recv(self, pipe):
    try:
      kind, payload = pipe.recv()
    except BaseException:
      print('Terminating env workers due to an exception.')
      self.close()
      raise
    if kind == 'error':
      self.close()
      raise RuntimeError(payload)
    assert kind == 'result', kind
    return payload

  def close(self):
    for proc in self.procs:
      proc.terminate()
      proc.join(timeout=5)
    for record in self.shm:
      if record is None:
        continue
      record['views'] = record['act_views'] = None
      try:
        record['block'].close()
        record['block'].unlink()
      except Exception:
        pass


_TRANSPORTS = {
    False: _Inline,
    'thread': _Threads,
    True: _Fleet,
    'process': _Fleet,
}


class Driver:

  def __init__(self, make_env_fns, parallel=True, **kwargs):
    assert make_env_fns, 'need at least one env ctor'
    if parallel not in _TRANSPORTS:
      raise ValueError(f'Unsupported transport {parallel!r}')
    self.parallel = 'process' if parallel is True else parallel
    self.length = len(make_env_fns)
    self.kwargs = kwargs
    self.transport = _TRANSPORTS[parallel](make_env_fns)
    self.act_space = self.transport.act_space
    self.callbacks = []
    self.acts = None
    self.carry = None
    self.reset()

  @property
  def shm(self):
    return getattr(self.transport, 'shm', [])

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
    """One lockstep round: step envs, run the policy, fire callbacks (the
    first and the last in the timer's sections `driver/envs` and
    `driver/callbacks`)."""
    with timer.section('driver/envs'):
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
    with timer.section('driver/callbacks'):
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


def _env_server(envid, pipe, payload):
  env = None
  block, obs_views, act_views = None, None, None
  try:
    env = pickle.loads(payload)()
    while True:
      if not pipe.poll(0.1):
        continue
      try:
        message, *args = pipe.recv()
      except EOFError:
        return
      if message == 'step':
        pipe.send(('result', env.step(args[0])))
      elif message == 'step_shm':
        obs = env.step({k: v.copy() for k, v in act_views.items()})
        if _write_views(obs, obs_views):
          pipe.send(('result', _SHM_TOKEN))
        else:
          # Layout changed (new/missing keys or reshaped values): fall
          # back to the pickled payload for this step.
          pipe.send(('result', obs))
      elif message == 'attach_shm':
        name, obs_layout, act_layout = args
        block = shared_memory.SharedMemory(name=name)
        obs_views = _shm_views(block, obs_layout)
        act_views = _shm_views(block, act_layout)
        # No reply: the parent continues immediately.
      elif message == 'obs_space':
        pipe.send(('result', env.obs_space))
      elif message == 'act_space':
        pipe.send(('result', env.act_space))
      elif message == 'close':
        return
      else:
        raise ValueError(f'Invalid message {message}')
  except (ConnectionResetError, BrokenPipeError, KeyboardInterrupt):
    pass
  except Exception as e:
    try:
      pipe.send(('error', repr(e)))
    except Exception:
      pass
    raise
  finally:
    try:
      env and env.close()
    except Exception:
      pass
    if block is not None:
      obs_views = act_views = None
      try:
        block.close()
      except Exception:
        pass
    pipe.close()


def _write_views(obs, views):
  """Copy obs into the shared views; False if the layout does not match."""
  if set(obs.keys()) != set(views.keys()):
    return False
  staged = []
  for key, value in obs.items():
    value = np.asarray(value)
    view = views[key]
    if value.shape != view.shape or value.dtype != view.dtype:
      return False
    staged.append((view, value))
  for view, value in staged:
    view[...] = value
  return True
