"""The port's actor-learner roles (run/parallel_impl.py) on the CPU, held
against the JAX package's where they are deterministic.

- The carry cache gathers and scatters torch carries as the JAX cache
  does the same numpy arrays.
- The replay service's `_ingest` and `_serve_train` (and the eval
  source), called directly with no server started, give the JAX
  service's batches on the same transitions: both replays sample with
  the Uniform selector seeded 0 (offline, so no fresh-item queue), and
  the limiter lets every call through, so the draws match; the step ids
  (uuids) are left out.
- `script=parallel` runs DreamerV3 at the `debug` size in a child
  interpreter with the latent table on: it writes agent.pkl, replay.pkl
  and logger.pkl, trains, sends replay updates, and leaves no child
  process, no thread and no prefetch thread behind when it returns (an
  interrupt ends it once its log holds what the test reads, within a
  cap, so that a busy host only makes it take longer); so
  do the `train` and `train_eval` scripts with their prefetch threads.
  `Prefetch.close` ends a producer that waits on its full queue, and
  does not wait for one inside its source.
- Marked `slow` (a minute or more each, like their JAX twins in
  tests/test_parallel.py): PPO and Director through `script=parallel`,
  and the split deployment, `script=parallel_replay` in one process
  beside `script=parallel` with `run.remote_replay: True` in another.
"""

import json
import pathlib
import subprocess
import sys
import threading
import time
from functools import partial as bind

import numpy as np
import pytest
import torch

from embodied_tpu import core as jcore
from embodied_tpu.core import streams as jstreams
from embodied_tpu.run import parallel_impl as jimpl
from embodied_tpu_torch import core, remote
from embodied_tpu_torch.core import streams
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.run import parallel_impl
from embodied_tpu_torch.utils import Config

ROOT = pathlib.Path(__file__).resolve().parents[1]


def carry_tree(rng, batch):
  """A DreamerV3-shaped policy carry: (encoder, dynamics, {}, prevact)."""
  return ({}, {'deter': rng.normal(size=(batch, 8)).astype(np.float32),
               'stoch': rng.normal(size=(batch, 2, 4)).astype(np.float32)},
          {}, {'action': rng.normal(size=(batch, 5)).astype(np.float32)})


def to_torch(tree):
  return parallel_impl.tree.tree_map(torch.from_numpy, tree)


def test_carry_cache_matches_jax():
  rng = np.random.default_rng(0)
  template = carry_tree(rng, 3)
  port = parallel_impl._CarryCache(to_torch(template))
  ref = jimpl._CarryCache(template)
  for step in range(6):
    envids = rng.choice(7, 3, replace=False)
    got = port.gather(envids)
    want = ref.gather(envids)
    parallel_impl.tree.tree_map(
        lambda g, w: np.testing.assert_array_equal(g.numpy(), w), got, want)
    batch = carry_tree(rng, 3)
    port.scatter(envids, to_torch(batch))
    ref.scatter(envids, batch)
    assert len(port) == len(ref)


def service_args(logdir):
  return Config(
      logdir=str(logdir), train_ratio=1.0, batch_size=2, batch_length=8,
      logger_addr=f'localhost:{remote.free_port()}',
      replay_addr=f'localhost:{remote.free_port()}',
      usage={'psutil': False}, save_every=-1, log_every=-1)


def make_service(pkg, logdir):
  corelib, streamlib, impl = pkg
  args = service_args(logdir)
  replays = [corelib.Replay(length=8, capacity=1e3, chunksize=32)
             for _ in range(2)]

  def make_stream(replay, mode):
    return streamlib.Stateless(bind(replay.sample, args.batch_size, mode))
  service = impl._ReplayService(*replays, make_stream, args)
  service.server.close()
  service.logger.close()
  return service


def transitions(rng, steps, envs=3):
  """Rows of `envs` envs, the last one an eval env."""
  for t in range(steps):
    yield {
        'envid': np.arange(envs),
        'is_eval': np.arange(envs) == envs - 1,
        'image': rng.integers(0, 255, (envs, 4, 4, 3), np.uint8),
        'reward': rng.normal(size=envs).astype(np.float32),
        'action': rng.integers(0, 5, envs).astype(np.int32),
        'is_first': np.full(envs, t == 0), 'is_last': np.zeros(envs, bool),
        'is_terminal': np.zeros(envs, bool),
        'slot': rng.integers(0, 100, envs).astype(np.int32),
        'slotgen': rng.integers(0, 3, envs).astype(np.uint32)}


def test_replay_service_matches_jax(tmp_path):
  port = make_service((core, streams, parallel_impl), tmp_path / 'port')
  ref = make_service((jcore, jstreams, jimpl), tmp_path / 'jax')
  rng = np.random.default_rng(1)
  rows = list(transitions(rng, 24))
  served = []
  for t, row in enumerate(rows):
    for service in (port, ref):
      assert service._ingest(dict(row)) == {}
    if t >= 8 and t % 4 == 0:
      served.append([s._serve_train() for s in (port, ref)])
      served.append([s._serve('eval')() for s in (port, ref)])
  assert len(served) == 8
  for got, want in served:
    assert got.keys() == want.keys()
    for key in got:
      if key != 'stepid':
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
  assert port.limiter.save() == ref.limiter.save()
  assert len(port.train) == len(ref.train) and len(port.eval) == len(
      ref.eval)


def prefetchers(before):
  """Prefetch threads started since `before` and still alive (the
  replay's saver thread may still be writing a chunk: it ends alone)."""
  return [t.name for t in threading.enumerate()
          if t.ident not in before and t.is_alive() and t.name == 'prefetch']


def test_prefetch_close_stops_its_producer():
  # A producer on a full queue ends at close(); one that waits inside
  # its source (an empty replay) is not waited for, and ends once the
  # source returns.
  full = streams.Prefetch(iter(range(100)), amount=1)
  assert next(iter(full)) == 0
  full.close()
  assert not full.thread.is_alive()
  release = threading.Event()

  def source():
    while True:
      release.wait()
      yield 1

  waiting = streams.Prefetch(source(), amount=1)
  iter(waiting)
  while not waiting.sourcing:
    time.sleep(0.01)
  began = time.time()
  waiting.close()
  assert time.time() - began < 1 and waiting.thread.is_alive()
  release.set()
  waiting.thread.join(5)
  assert not waiting.thread.is_alive()


@pytest.mark.parametrize('script', ['train', 'train_eval'])
def test_scripts_stop_their_prefetch_threads(tmp_path, script):
  before = {t.ident for t in threading.enumerate()}
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    main.main(['--configs', 'debug', '--task', 'dummy_disc', '--script',
               script, '--logdir', str(tmp_path), '--run.steps', '300',
               '--run.eval_envs', '1', '--run.usage.psutil', 'False'])
  finally:
    torch.set_num_threads(threads)
  assert not prefetchers(before)


CHILD = '''
import json, os, sys, threading, time
sys.path.insert(0, {root!r})
from embodied_tpu_torch import parallel
from embodied_tpu_torch.models.{family} import main

calls = []
train = parallel.Agent.train

def counted(self, *args):
  calls.append(time.time())
  return train(self, *args)

def children():
  pids = []
  for pid in filter(str.isdigit, os.listdir('/proc')):
    try:
      with open(f'/proc/{{pid}}/stat') as f:
        ppid = int(f.read().rsplit(')', 1)[1].split()[1])
      with open(f'/proc/{{pid}}/cmdline') as f:
        tracker = 'resource_tracker' in f.read()
    except OSError:
      continue
    if ppid == os.getpid() and not tracker:
      pids.append(int(pid))
  return pids

def seen(logdir, events):
  """Whether the run has written its checkpoint files and metric lines
  that hold each of `events` (a key, or a key whose value must be > 0)."""
  names = ('agent.pkl', 'replay.pkl', 'logger.pkl')
  if not all(os.path.exists(os.path.join(logdir, n)) for n in names):
    return False
  try:
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
      lines = [json.loads(l) for l in f if l.endswith('\\n')]
  except OSError:
    return False
  for key, positive in events:
    values = [v for l in lines for k, v in l.items()
              if k == key or (key.endswith('/') and k.startswith(key))]
    if not values or (positive and not max(values) > 0):
      return False
  return True

if __name__ == '__main__':
  parallel.Agent.train = counted
  events = {events!r}
  ender, finished = None, threading.Event()
  if events:
    # End the run once the events are logged, as a user does: with an
    # interrupt, which main's supervisor answers by stopping every role.
    import _thread

    def end_run():
      while not finished.is_set():
        if seen({logdir!r}, events):
          _thread.interrupt_main()
          return
        time.sleep(0.3)
    ender = threading.Thread(target=end_run, daemon=True)
    ender.start()
  start = time.time()
  try:
    main.main({argv!r})
  except KeyboardInterrupt:
    pass
  finished.set()
  if ender is not None:
    ender.join()
  print(json.dumps(dict(
      threads=[t.name for t in threading.enumerate()
               if t is not threading.main_thread()],
      children=children(), train_calls=len(calls),
      first_train_s=calls[0] - start if calls else None)))
'''


def run_child(family, argv, timeout, logdir=None, events=()):
  """`main.main(argv)` of a model family in a child interpreter; returns
  its Agent.train calls, and the threads and child processes still alive
  after it returned. With `events` ((metric key, whether its value must be
  > 0) pairs; a key ending in '/' is a prefix), an interrupt ends the run
  once `logdir` holds its checkpoint files and metric lines with each of
  them, else it ends on its budget."""
  code = CHILD.format(root=str(ROOT), family=family, argv=argv,
                      logdir=str(logdir), events=list(events))
  proc = subprocess.run(
      [sys.executable, '-c', code], cwd=ROOT, capture_output=True,
      text=True, timeout=timeout)
  assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
  return json.loads(proc.stdout.strip().splitlines()[-1])


def read_metrics(logdir):
  with open(logdir / 'metrics.jsonl') as f:
    return [json.loads(line) for line in f]


def parallel_argv(logdir, *extra):
  return ['--configs', 'debug', '--script', 'parallel', '--task',
          'dummy_disc', '--logdir', str(logdir), '--run.envs', '2',
          '--run.eval_envs', '1', '--run.log_every', '2',
          '--run.report_every', '4', '--run.save_every', '5',
          '--run.usage.psutil', 'False', *extra]


def check_run(logdir, left, table=True):
  assert left['threads'] == [] and left['children'] == [], left
  assert left['train_calls'] > 0, left
  files = {p.name for p in logdir.iterdir()}
  assert {'agent.pkl', 'replay.pkl', 'logger.pkl'} <= files, files
  lines = read_metrics(logdir)
  trained = [l['fps/train'] for l in lines if 'fps/train' in l]
  assert trained and max(trained) > 0, (left, lines[:3])
  if table:
    valid = [l['train/latents/valid'] for l in lines
             if 'train/latents/valid' in l]
    assert valid and all(0 <= v <= 1 for v in valid), valid
  return lines


def test_parallel_script_dreamer_debug(tmp_path):
  # The latent table on, its latents also riding the replay
  # (torch.latents_in_replay), so that the learner sends replay updates.
  # The run ends once it has logged what the asserts read (a busy host
  # takes longer to get there), within a cap of 150 s.
  events = [('fps/train', True), ('train/latents/valid', False),
            ('replay/updates', True), ('report/', False),
            ('timer/agent/policy_lock_wait/avg', False)]
  left = run_child('dreamerv3', parallel_argv(
      tmp_path, '--run.duration', '150', '--torch.latents_in_replay',
      'True'), timeout=300, logdir=tmp_path, events=events)
  lines = check_run(tmp_path, left)
  updates = [l['replay/updates'] for l in lines if 'replay/updates' in l]
  assert updates and max(updates) > 0, updates
  assert any(k.startswith('report/') for l in lines for k in l), lines[-1]
  waits = [l for l in lines if 'timer/agent/policy_lock_wait/avg' in l]
  assert waits, 'the actor lock wait was not reported'


@pytest.mark.slow
@pytest.mark.parametrize('family', ['ppo', 'director'])
def test_parallel_script_other_families(tmp_path, family):
  left = run_child(family, parallel_argv(tmp_path, '--run.duration', '40'),
                   timeout=300)
  check_run(tmp_path, left, table=family == 'ppo')


@pytest.mark.slow
def test_parallel_replay_beside_remote_replay(tmp_path):
  # The replay service in its own process (script=parallel_replay); the
  # rest with run.remote_replay. Slot ids cross the process boundary and
  # the first training visit of every step finds its latents valid.
  addrs = {k: f'localhost:{remote.free_port()}'
           for k in ('actor', 'replay', 'logger')}
  flags = ['--run.remote_replay', 'True', '--run.actor_addr',
           addrs['actor'], '--run.replay_addr', addrs['replay'],
           '--run.logger_addr', addrs['logger']]
  argv = parallel_argv(tmp_path, '--run.duration', '40', *flags)
  replay_argv = [a if a != 'parallel' else 'parallel_replay' for a in argv]
  code = CHILD.format(root=str(ROOT), family='dreamerv3', argv=replay_argv,
                      logdir=None, events=[])
  replay = subprocess.Popen(
      [sys.executable, '-c', code], cwd=ROOT, stdout=subprocess.DEVNULL,
      stderr=subprocess.DEVNULL)
  try:
    left = run_child('dreamerv3', argv, timeout=300)
  finally:
    replay.kill()
    replay.wait(10)
  lines = check_run(tmp_path, left)
  valid = [l['train/latents/valid'] for l in lines
           if 'train/latents/valid' in l]
  assert min(valid) >= 0.99, valid
