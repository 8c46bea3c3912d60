"""Supervised processes and threads.

The port of embodied_tpu/remote/proc.py: workers that propagate failures,
a supervision loop that tears everything down when one worker dies, and
crash files for external supervisors.

Five differences from the JAX package:
- `Process` sends its target and arguments with the standard `pickle`
  into a `spawn` context, as the Driver's process transport does (not
  with `cloudpickle`): a parent with CUDA live needs `spawn`, and the
  target must pickle, so it is a module-level function or a partial of
  one. A lambda raises TypeError when the Process is made, before any
  process starts.
- `Thread` takes a `stop` callable: `kill()` calls it and joins the
  thread, so a supervised thread that watches what `stop` signals ends
  with the run instead of outliving it.
- `run` raises for a thread that failed while the run was ending, where
  the JAX one returns.
- `run` also ends when an `until` event is set (the parallel script's
  agent has left), and joins each thread it stops before it kills the
  next worker.
- A `Process` ignores interrupts: its supervisor ends it. A terminal's
  interrupt reaches every process of its group, and a role that died of
  it would end its learner's feed before the learners' agreed stop on a
  process group.
"""

import multiprocessing as mp
import pickle
import signal
import sys
import threading
import time
import traceback

_SETTINGS = {'errfile': None}
_JOIN_S = 120.0  # a thread may be in a checkpoint save when it is stopped


def setup(errfile=None, **kwargs):
  _SETTINGS['errfile'] = str(errfile) if errfile else None


def _record_error(name, exc):
  message = f'Worker {name} crashed:\n{traceback.format_exc()}'
  print(message, file=sys.stderr, flush=True)
  errfile = _SETTINGS['errfile']
  if errfile:
    try:
      with open(errfile, 'w') as f:
        f.write(message)
    except OSError:
      pass


class Thread:
  """Daemon thread that records exceptions for the supervisor; `stop`,
  if given, is called by kill() before it joins the thread."""

  def __init__(self, fn, *args, name=None, start=False, stop=None):
    self.fn = fn
    self.name = name or getattr(fn, '__name__', 'thread')
    self.stop = stop
    self.exception = None
    self.thread = threading.Thread(
        target=self._run, args=args, daemon=True, name=self.name)
    if start:
      self.start()

  def _run(self, *args):
    try:
      self.fn(*args)
    except SystemExit:
      pass
    except BaseException as e:  # noqa: B036
      self.exception = e
      _record_error(self.name, e)

  def start(self):
    self.thread.start()
    return self

  @property
  def running(self):
    return self.thread.is_alive()

  def check(self):
    if self.exception is not None:
      raise RuntimeError(
          f'Worker {self.name} failed: {self.exception!r}')

  def kill(self):
    if self.stop is not None:
      self.stop()
    if self.thread.ident is not None and (
        self.thread is not threading.current_thread()):
      self.thread.join(_JOIN_S)

  def join(self, timeout=None):
    self.thread.join(timeout)


def _pickled(fn, args, name):
  try:
    return pickle.dumps((fn, args))
  except (pickle.PicklingError, AttributeError, TypeError) as e:
    raise TypeError(
        f'Process {name} sends its target and arguments with pickle, and '
        f'{fn!r} does not pickle ({e}). Pass a module-level function or a '
        'functools.partial of one.') from e


def _proc_main(payload):
  signal.signal(signal.SIGINT, signal.SIG_IGN)
  fn, args = pickle.loads(payload)
  fn(*args)


class Process:
  """Supervised subprocess in a `spawn` context; the target and its
  arguments are pickled when the Process is made."""

  def __init__(self, fn, *args, name=None, start=False):
    self.name = name or getattr(fn, '__name__', 'process')
    payload = _pickled(fn, args, self.name)
    context = mp.get_context('spawn')
    self.proc = context.Process(
        target=_proc_main, args=(payload,), name=self.name, daemon=True)
    if start:
      self.start()

  def start(self):
    self.proc.start()
    return self

  @property
  def running(self):
    return self.proc.is_alive()

  @property
  def pid(self):
    return self.proc.pid

  def check(self):
    if self.proc.exitcode not in (None, 0):
      raise RuntimeError(
          f'Worker {self.name} exited with code {self.proc.exitcode}')

  def kill(self):
    if self.proc.is_alive():
      self.proc.terminate()
      self.proc.join(timeout=3)
      if self.proc.is_alive():
        self.proc.kill()
        self.proc.join(timeout=3)

  def join(self, timeout=None):
    self.proc.join(timeout)


def run(workers, duration=None, until=None):
  """Start workers and supervise: if one fails, kill all and raise. The
  run ends when every worker has ended, when `duration` seconds have
  passed, or when the event `until` is set; the workers are then killed
  in their order, each thread joined before the next worker. A thread
  that failed as the run ended (after the last poll, or while it was
  being stopped) fails the run too."""
  for worker in workers:
    if not worker.running:
      try:
        worker.start()
      except (AssertionError, RuntimeError):
        pass
  start = time.time()
  try:
    while True:
      for worker in workers:
        worker.check()
      if all(not w.running for w in workers):
        break
      if duration and time.time() - start > duration:
        break
      if until is not None and until.is_set():
        break
      time.sleep(0.3)
  finally:
    for worker in workers:
      try:
        worker.kill()
      except Exception:
        traceback.print_exc()
  for worker in workers:
    if isinstance(worker, Thread):
      worker.check()
