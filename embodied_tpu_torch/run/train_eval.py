"""Training protocol with a separate eval env fleet and eval replay.

A copy of embodied_tpu/run/train_eval.py; the run stops the prefetch
threads of its streams when it ends, and makes the eval replay's stream
at the first evaluation that has eval data. On a process group every
rank evaluates and saves at rank 0's times, and the eval report waits
until every rank has eval data.

Capability match for the reference's embodied/run/train_eval.py on the
run/loop.py harness: adds to train() a second driver running eval-mode
policy episodes on report cadence, an eval replay, and eval reports.
"""

import pickle

from ..core import streams
from ..parallel.setup import everyone
from ..utils import Checkpoint, FPS, Path, Usage, timer
from . import loop


def train_eval(
    make_agent, make_replay_train, make_replay_eval, make_env_train,
    make_env_eval, make_stream, make_logger, args):
  agent = make_agent()
  replay_train = make_replay_train()
  replay_eval = make_replay_eval()
  logger = make_logger()
  step = logger.step
  usage = Usage(**dict(args.usage))
  policy_fps = FPS()

  train_episodes = loop.EpisodeLog(logger, 'episode')
  eval_episodes = loop.EpisodeLog(logger, 'eval_episode')
  learner = loop.Learner(
      agent, replay_train,
      agent.stream(make_stream(replay_train, 'train')), args)
  report_train = loop.Reporter(
      agent, agent.stream(make_stream(replay_train, 'report')), args,
      batches=args.report_batches)
  # The eval replay's reporter is made at the first evaluation that has
  # eval data: its stream's producer would wait in the empty replay.
  report_eval = None

  driver = loop.make_driver(make_env_train, args.envs, args)
  driver.on_step(lambda tran, _: step.increment())
  driver.on_step(lambda tran, _: policy_fps.step())
  driver.on_step(replay_train.add)
  driver.on_step(train_episodes)
  driver.on_step(lambda tran, _: learner.tick(step))

  evaler = loop.make_driver(make_env_eval, args.eval_envs, args)
  evaler.on_step(lambda tran, _: policy_fps.step())
  evaler.on_step(replay_eval.add)
  evaler.on_step(eval_episodes)

  cp = Checkpoint(Path(args.logdir) / 'checkpoint.pkl')
  cp.step = step
  cp.agent = agent
  cp.replay_train = replay_train
  cp.replay_eval = replay_eval
  if args.from_checkpoint:
    seed = pickle.loads(Path(args.from_checkpoint).read_bytes())
    agent.load(seed['agent'])
  cp.load_or_save()

  eval_policy = lambda *a: agent.policy(*a, mode='eval')

  def evaluate():
    nonlocal report_eval
    print('Evaluation')
    evaler.reset(agent.init_policy)
    evaler(eval_policy, episodes=args.eval_eps)
    logger.add(eval_episodes.stats(), prefix='epstats')
    if len(replay_train):
      logger.add(report_train(), prefix='report')
    # Each rank's evaluation ran its own episodes: the eval report, a
    # collective on a sharded agent, waits until every rank has eval data.
    if everyone(len(replay_eval)):
      if report_eval is None:
        report_eval = loop.Reporter(
            agent, agent.stream(make_stream(replay_eval, 'eval')), args,
            batches=args.report_batches)
      logger.add(report_eval(), prefix='eval')

  def log():
    logger.add(learner.stats())
    logger.add(train_episodes.stats(), prefix='epstats')
    logger.add(replay_train.stats(), prefix='replay')
    logger.add(usage.stats(), prefix='usage')
    logger.add({'fps/policy': policy_fps.result(),
                'fps/train': learner.fps.result(),
                **loop.timer_metrics()})
    logger.write()

  tasks = (loop.Schedule()
           .every(args.report_every, evaluate, together=True)
           .every(args.log_every, log)
           .every(args.save_every, cp.save, together=True))
  out_of_time = loop.Deadline(args.duration)

  print('Start training loop')
  train_policy = lambda *a: agent.policy(*a, mode='train')
  driver.reset(agent.init_policy)
  try:
    while step < args.steps and not out_of_time():
      tasks.poll(step)
      driver(train_policy, steps=10)
  finally:
    driver.close()
    evaler.close()
    streams.close(learner.stream, report_train.stream,
                  *([report_eval.stream] if report_eval else []))
    logger.close()
