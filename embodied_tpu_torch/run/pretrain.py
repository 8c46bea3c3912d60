"""Offline model training from streams only; multi-replica aware.

A copy of embodied_tpu/run/pretrain.py; the run stops the prefetch threads
of its streams when it ends.

Capability match for the reference's embodied/run/pretrain.py on the
run/loop.py harness: no envs or replay service; report/log/save cadence
comes from GlobalClock so every replica makes identical decisions, and
only replica 0 writes checkpoints (core.clock.setup connects the replicas'
clocks to replica 0's decision server).
"""

import pickle
import time

from .. import core
from ..core import streams
from ..utils import Agg, Checkpoint, FPS, Path, Usage, timer
from . import loop


def pretrain(make_model, make_stream, make_logger, args):
  model = make_model()
  logger = make_logger()
  step = logger.step
  usage = Usage(**dict(args.usage))
  fps = FPS()
  train_agg = Agg()

  dataset = iter(model.stream(make_stream(None, 'train')))
  report = loop.Reporter(model, model.stream(make_stream(None, 'report')),
                         args)
  evaluate = loop.Reporter(model, model.stream(make_stream(None, 'eval')),
                           args)
  carry = model.init_train(args.batch_size)

  is_writer = args.replica == 0
  cp = Checkpoint(Path(args.logdir) / 'checkpoint.pkl')
  cp.step = step
  cp.model = model
  cp.dataset_train = dataset
  cp.dataset_report = report.stream
  cp.dataset_eval = evaluate.stream
  if cp.exists():
    cp.load()
  else:
    if args.from_checkpoint:
      seed = pickle.loads(Path(args.from_checkpoint).read_bytes())
      model.load(seed['model'])
    if is_writer:
      cp.save()

  def do_report():
    logger.write()
    with timer.section('report'):
      logger.add(report(), prefix='report')
    with timer.section('eval'):
      logger.add(evaluate(), prefix='eval')
    logger.add(loop.timer_metrics())
    logger.write()

  def do_log():
    logger.add(train_agg.result(), prefix='train')
    logger.add(usage.stats(), prefix='usage')
    rate = fps.result()
    logger.add({'fps': rate, 'spf': 1 / max(rate, 1e-8)})

  def do_save():
    if is_writer:
      with timer.section('saving'):
        cp.save()

  # GlobalClock keeps the cadence identical on every replica.
  tasks = (loop.Schedule(clock=core.GlobalClock)
           .every(args.report_every, do_report)
           .every(args.log_every, do_log)
           .every(args.save_every, do_save))
  out_of_time = loop.Deadline(args.duration)

  print('Starting training')
  try:
    while step < args.steps and not out_of_time():
      with timer.section('stream'):
        batch = next(dataset)
      with timer.section('train'):
        began = time.time()
        carry, outs, mets = model.train(carry, batch)
        logger.add({'dur/train': time.time() - began})
      train_agg.add(mets)
      step.increment()
      fps.step(args.batch_size * args.batch_length)
      tasks.poll(step)
  finally:
    streams.close(dataset, report.stream, evaluate.stream)
  logger.close()
