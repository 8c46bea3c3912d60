"""Single-process training protocol.

A copy of embodied_tpu/run/train.py; the run stops the prefetch threads of
its streams when it ends, and on a process group every rank reports and
saves at rank 0's times.

Capability match for the reference's embodied/run/train.py, composed from
the shared harness in run/loop.py: env driver feeding replay and episode
logs, ratio-paced learner ticks interleaved with env stepping, periodic
report/log/save tasks, checkpoint resume, and an optional run.duration
wall-clock budget.
"""

import pickle

from ..core import streams
from ..utils import Agg, Checkpoint, FPS, Path, Usage, timer
from . import loop


def train(make_agent, make_replay, make_env, make_stream, make_logger, args):
  agent = make_agent()
  replay = make_replay()
  logger = make_logger()
  step = logger.step
  usage = Usage(**dict(args.usage))
  policy_fps = FPS()

  episodes = loop.EpisodeLog(logger)
  learner = loop.Learner(
      agent, replay, agent.stream(make_stream(replay, 'train')), args)
  reporter = loop.Reporter(
      agent, agent.stream(make_stream(replay, 'report')), args,
      batches=args.consec_report * args.report_batches)

  driver = loop.make_driver(make_env, args.envs, args)
  driver.on_step(lambda tran, _: step.increment())
  driver.on_step(lambda tran, _: policy_fps.step())
  driver.on_step(replay.add)
  driver.on_step(episodes)
  driver.on_step(lambda tran, _: learner.tick(step))

  # save_every < 0 disables checkpointing entirely (matches the bsuite
  # preset's save_every: -1 intent).
  checkpointing = args.save_every >= 0
  cp = Checkpoint(Path(args.logdir) / 'checkpoint.pkl')
  if checkpointing:
    cp.step = step
    cp.agent = agent
    cp.replay = replay
  if args.from_checkpoint:
    seed = pickle.loads(Path(args.from_checkpoint).read_bytes())
    agent.load(seed['agent'])
  if checkpointing:
    cp.load_or_save()

  def report():
    if len(replay):
      logger.add(reporter(), prefix='report')

  def log():
    logger.add(learner.stats())
    logger.add(episodes.stats(), prefix='epstats')
    logger.add(replay.stats(), prefix='replay')
    logger.add(usage.stats(), prefix='usage')
    logger.add({'fps/policy': policy_fps.result(),
                'fps/train': learner.fps.result(),
                **loop.timer_metrics()})
    logger.write()

  # Reports and saves gather a sharded agent's store: every rank of a
  # process group takes them at the same poll.
  tasks = (loop.Schedule()
           .every(args.report_every, report, together=True)
           .every(args.log_every, log))
  if checkpointing:
    tasks.every(args.save_every, cp.save, together=True)
  out_of_time = loop.Deadline(args.duration)

  print('Start training loop')
  policy = lambda *a: agent.policy(*a, mode='train')
  driver.reset(agent.init_policy)
  try:
    while step < args.steps and not out_of_time():
      driver(policy, steps=10)
      tasks.poll(step)
  finally:
    driver.close()
    streams.close(learner.stream, reporter.stream)
    logger.close()
