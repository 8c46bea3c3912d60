"""Metrics logger with pluggable outputs.

A copy of embodied_tpu/utils/logger.py.

Capability parity: elements.Logger plus Terminal/JSONL/TensorBoard/WandB
outputs as wired in the reference's dreamerv3/main.py:152-180.
"""

import concurrent.futures
import datetime
import json
import re

import numpy as np

from . import metrics as metricslib
from . import path as pathlib


def timestamp(now=None, millis=False):
  now = datetime.datetime.now() if now is None else now
  string = now.strftime('%Y%m%dT%H%M%S')
  if millis:
    string += f'F{now.microsecond:06d}'
  return string


class Logger:

  def __init__(self, step, outputs, multiplier=1):
    assert outputs, 'Provide at least one logger output'
    self.step = step
    self.outputs = outputs
    self.multiplier = multiplier
    self._buffer = []
    self._pool = concurrent.futures.ThreadPoolExecutor(1, 'logger')
    self._promise = None

  def add(self, mapping, prefix=None):
    step = int(self.step) * self.multiplier
    for name, value in dict(mapping).items():
      name = f'{prefix}/{name}' if prefix else name
      value = np.asarray(value) if not isinstance(value, str) else value
      self._buffer.append((step, name, value))

  def scalar(self, name, value):
    self.add({name: np.float64(value)})

  def image(self, name, value):
    self.add({name: np.asarray(value)})

  def video(self, name, value):
    self.add({name: np.asarray(value)})

  def text(self, name, value):
    self.add({name: value})

  def write(self, wait=False):
    if not self._buffer:
      return
    buffer, self._buffer = self._buffer, []
    if self._promise:
      self._promise.result()
    self._promise = self._pool.submit(self._write, buffer)
    if wait:
      self._promise.result()
      self._promise = None

  def _write(self, buffer):
    for output in self.outputs:
      try:
        output(buffer)
      except Exception as e:
        print(f'Logger output {type(output).__name__} failed: {e}')

  def close(self):
    self.write(wait=True)
    self._pool.shutdown()


class TerminalOutput:

  def __init__(self, pattern=r'.*', name=None, limit=20):
    self._pattern = re.compile(pattern)
    self._name = name
    self._limit = limit

  def __call__(self, buffer):
    entries = {}
    step = 0
    for s, name, value in buffer:
      step = max(step, s)
      if isinstance(value, str) or np.asarray(value).ndim > 0:
        continue
      if self._pattern.search(name):
        entries[name] = value
    if not entries:
      return
    header = f'--- Step {step}' + (f' [{self._name}]' if self._name else '')
    formatted = [f'{k} {_format(v)}' for k, v in list(entries.items())[:self._limit]]
    print(header + ' --- ' + ' / '.join(formatted))


def _format(value):
  value = float(value)
  if abs(value) < 1e-5 or abs(value) >= 1e6:
    return f'{value:.1e}'
  if float(value).is_integer():
    return str(int(value))
  return f'{value:.2f}'.rstrip('0')


class JSONLOutput:

  def __init__(self, logdir, filename='metrics.jsonl', pattern=r'.*'):
    self._path = pathlib.Path(logdir) / filename
    pathlib.Path(logdir).mkdir()
    self._pattern = re.compile(pattern)

  def __call__(self, buffer):
    bystep = {}
    for step, name, value in buffer:
      arr = np.asarray(value) if not isinstance(value, str) else None
      if arr is None or arr.ndim > 0:
        continue
      if self._pattern.search(name):
        bystep.setdefault(step, {})[name] = float(arr)
    lines = ''.join(
        json.dumps({'step': step, **scalars}) + '\n'
        for step, scalars in sorted(bystep.items()))
    if not lines:
      return
    with open(str(self._path), 'a') as f:
      f.write(lines)


class ScoreOutput:
  """Writes episode score/length to scores.jsonl for the plotter."""

  def __init__(self, logdir, task=None, method=None, seed=None):
    self._path = pathlib.Path(logdir) / 'scores.jsonl'
    pathlib.Path(logdir).mkdir()
    self._meta = dict(task=task, method=method, seed=seed)

  def __call__(self, buffer):
    lines = []
    for step, name, value in buffer:
      if name == 'episode/score':
        record = {'step': step, 'score': float(np.asarray(value))}
        record.update({k: v for k, v in self._meta.items() if v is not None})
        lines.append(json.dumps(record) + '\n')
    if lines:
      with open(str(self._path), 'a') as f:
        f.writelines(lines)


class TensorBoardOutput:

  def __init__(self, logdir, fps=15):
    self._logdir = str(pathlib.Path(logdir))
    self._fps = fps
    self._writer = None

  def __call__(self, buffer):
    if self._writer is None:
      try:
        from torch.utils import tensorboard
        self._writer = tensorboard.SummaryWriter(self._logdir)
      except ImportError:
        self._writer = False
        print('TensorBoard output unavailable (no torch/tensorboard)')
    if not self._writer:
      return
    for step, name, value in buffer:
      if isinstance(value, str):
        self._writer.add_text(name, value, step)
        continue
      value = np.asarray(value)
      if value.ndim == 0:
        self._writer.add_scalar(name, float(value), step)
      elif value.ndim == 3:
        self._writer.add_image(name, value, step, dataformats='HWC')
      elif value.ndim == 4:
        video = np.transpose(value, (0, 3, 1, 2))[None]
        self._writer.add_video(name, video, step, fps=self._fps)
    self._writer.flush()


class WandBOutput:

  def __init__(self, logdir, project=None, name=None, **kwargs):
    self._run = None
    self._kwargs = dict(project=project, name=name, dir=str(logdir), **kwargs)

  def __call__(self, buffer):
    if self._run is None:
      try:
        import wandb
        self._run = wandb.init(**self._kwargs)
        self._wandb = wandb
      except ImportError:
        self._run = False
        print('WandB output unavailable')
    if not self._run:
      return
    bystep = {}
    for step, name, value in buffer:
      if not isinstance(value, str) and np.asarray(value).ndim == 0:
        bystep.setdefault(step, {})[name] = float(np.asarray(value))
    for step, scalars in sorted(bystep.items()):
      self._run.log(scalars, step=step)
