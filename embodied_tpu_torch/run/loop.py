"""Shared building blocks for the run protocols.

A copy of embodied_tpu/run/loop.py.

The reference implements each protocol (train / train_eval / eval_only /
pretrain, the reference's embodied/run/) as a standalone script with
duplicated episode accounting, ratio pacing, and logging. Here those
concerns are components and each protocol is a short composition:

- EpisodeLog   per-worker episode aggregation into the logger
- Learner      train stream + carry + replay-ratio pacing + latent updates
- Reporter     report stream + carry, aggregated over N batches
- Schedule     named wall-clock tasks polled from the main loop, those
               that make collectives taken alike on every rank
- Deadline     optional run.duration wall-clock budget
- make_driver  env fleet construction honoring args.driver
"""

from functools import partial as bind

import numpy as np

from .. import core
from ..parallel.setup import agree
from ..utils import Agg, FPS, timer, when


class EpisodeLog:
  """Aggregates per-worker transitions into episode metrics.

  Scores/lengths go to the logger under `prefix` as episodes finish;
  richer stats (log/ keys, reward rate) accumulate in an Agg retrieved
  via stats(). Worker `video_worker`'s image observations are stacked
  into a policy video."""

  def __init__(self, logger, prefix='episode', video_worker=0):
    self.logger = logger
    self.prefix = prefix
    self.video_worker = video_worker
    self.open = {}
    self.agg = Agg()

  @timer.section('episode_log')
  def __call__(self, tran, worker):
    ep = self.open.get(worker)
    if ep is None or tran['is_first']:
      ep = self.open[worker] = Agg()
    ep.add('score', tran['reward'], agg='sum')
    ep.add('length', 1, agg='sum')
    ep.add('rewards', tran['reward'], agg='stack')
    for key, value in tran.items():
      if key.startswith('log/'):
        ep.add(key, value, agg=('avg', 'max', 'sum'))
      elif (value.dtype == np.uint8 and value.ndim == 3
            and worker == self.video_worker):
        ep.add(f'policy_{key}', value, agg='stack')
    if tran['is_last']:
      result = ep.result()
      self.logger.add({
          'score': result.pop('score'),
          'length': result.pop('length'),
      }, prefix=self.prefix)
      rewards = result.pop('rewards')
      if len(rewards) > 1:
        deltas = np.abs(np.diff(rewards))
        result['reward_rate'] = (deltas >= 0.01).mean()
      self.agg.add(result)

  def stats(self):
    return self.agg.result()


class Learner:
  """Drives ratio-paced train steps against a replay-backed stream and
  routes replay updates (priorities / refreshed latents) back."""

  def __init__(self, agent, replay, stream, args):
    self.agent = agent
    self.replay = replay
    self.stream = iter(stream)
    self.batch_steps = args.batch_size * args.batch_length
    self.ratio = when.Ratio(args.train_ratio / self.batch_steps)
    self.minimum = self.batch_steps
    self.carry = agent.init_train(args.batch_size)
    self.agg = Agg()
    self.fps = FPS()

  @timer.section('learner_tick')
  def tick(self, step):
    if len(self.replay) < self.minimum:
      return
    for _ in range(self.ratio(step)):
      with timer.section('stream_next'):
        batch = next(self.stream)
      self.carry, outs, mets = self.agent.train(self.carry, batch)
      self.fps.step(self.batch_steps)
      if 'replay' in outs:
        self.replay.update(outs['replay'])
      self.agg.add(mets, prefix='train')

  def stats(self):
    return self.agg.result()


class Reporter:
  """Aggregated agent.report over a stream; one callable per stream."""

  def __init__(self, agent, stream, args, batches=None):
    self.agent = agent
    self.stream = iter(stream)
    self.batches = batches or (args.consec_report * args.report_batches)
    self.carry = agent.init_report(args.batch_size)

  @timer.section('reporter')
  def __call__(self):
    agg = Agg()
    for _ in range(self.batches):
      self.carry, mets = self.agent.report(self.carry, next(self.stream))
      agg.add(mets)
    return agg.result()


def timer_metrics():
  """One timer.stats() pass split for logging: the human-readable summary
  under 'timer' plus numeric per-section series under 'timer/<sec>/...'
  (frac/avg/total), which the viewer's profile view charts over time."""
  stats = timer.stats()
  out = {'timer': stats.pop('summary')}
  out.update({f'timer/{k}': v for k, v in stats.items()})
  return out


class Schedule:
  """Named wall-clock tasks; poll() runs whichever are due. A task made
  with `together` fires on a process group where rank 0's clock says it
  is due, on every rank at the same poll: a task that makes a collective
  (a report or a save of a sharded agent) must. Other tasks (logging)
  follow each rank's own clock."""

  def __init__(self, clock=core.LocalClock):
    self._tasks = []
    self._clock = clock

  def every(self, seconds, fn, first=False, together=False):
    self._tasks.append((self._clock(seconds, first), fn, together))
    return self

  def poll(self, step):
    for clock, fn, together in self._tasks:
      due = clock(step)
      if together:
        due = agree(due)
      if due:
        fn()


class Deadline:
  """True once the wall-clock budget (seconds; 0 = unlimited) is spent.
  On a process group every rank takes rank 0's answer, so that no rank
  stops while another waits for it in a train step."""

  def __init__(self, seconds):
    import time
    self._time = time
    self.until = time.time() + seconds if seconds else None

  def __call__(self):
    if self.until is None:
      return False
    return agree(self._time.time() >= self.until)


def make_driver(make_env, n, args):
  ctors = [bind(make_env, i) for i in range(n)]
  parallel = False if args.debug else args.driver
  return core.Driver(ctors, parallel=parallel)
