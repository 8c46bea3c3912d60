"""Checkpoint-restore + policy-only rollouts.

A copy of embodied_tpu/run/eval_only.py.

Capability match for the reference's embodied/run/eval_only.py on the
run/loop.py harness.
"""

from ..utils import Checkpoint, FPS, Usage, timer
from . import loop


def eval_only(make_agent, make_env, make_logger, args):
  assert args.from_checkpoint, 'eval_only requires run.from_checkpoint'
  agent = make_agent()
  logger = make_logger()
  step = logger.step
  usage = Usage(**dict(args.usage))
  policy_fps = FPS()
  episodes = loop.EpisodeLog(logger)

  driver = loop.make_driver(make_env, args.envs, args)
  driver.on_step(lambda tran, _: step.increment())
  driver.on_step(lambda tran, _: policy_fps.step())
  driver.on_step(episodes)

  cp = Checkpoint()
  cp.agent = agent
  cp.load(args.from_checkpoint, keys=['agent'])

  def log():
    logger.add(episodes.stats(), prefix='epstats')
    logger.add(usage.stats(), prefix='usage')
    logger.add({'fps/policy': policy_fps.result(),
                **loop.timer_metrics()})
    logger.write()

  tasks = loop.Schedule().every(args.log_every, log)
  out_of_time = loop.Deadline(args.duration)

  print('Start evaluation')
  policy = lambda *a: agent.policy(*a, mode='eval')
  driver.reset(agent.init_policy)
  try:
    while step < args.steps and not out_of_time():
      driver(policy, steps=10)
      tasks.poll(step)
  finally:
    driver.close()
    logger.close()
