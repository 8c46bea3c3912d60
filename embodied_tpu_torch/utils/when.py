"""Schedules for deciding when to run periodic work.

A copy of embodied_tpu/utils/when.py.

Capability parity: elements.when.{Clock,Ratio,Every,Once,Until} as used in
the reference's embodied/run/train.py:26-29.
"""

import time


class Every:
  """True every `every` increments of the step counter."""

  def __init__(self, every, initial=True):
    self.every = every
    self.initial = initial
    self.prev = None

  def __call__(self, step):
    step = int(step)
    if self.every < 0:
      return True
    if self.every == 0:
      return False
    if self.prev is None:
      self.prev = (step // self.every) * self.every
      return self.initial
    if step >= self.prev + self.every:
      self.prev += self.every
      return True
    return False


class Ratio:
  """Returns how many times to run to maintain `ratio` runs per step."""

  def __init__(self, ratio):
    assert ratio >= 0, ratio
    self.ratio = ratio
    self.prev = None

  def __call__(self, step):
    step = int(step)
    if self.ratio == 0:
      return 0
    if self.prev is None:
      self.prev = step
      return 1
    repeats = int((step - self.prev) * self.ratio)
    self.prev += repeats / self.ratio
    return repeats

  def save(self):
    return {'prev': self.prev}

  def load(self, data):
    self.prev = data['prev']


class Clock:
  """True when at least `every` seconds have elapsed since the last True."""

  def __init__(self, every, first=True):
    self.every = every
    self.prev = None
    self.first = first

  def __call__(self, step=None):
    if self.every < 0:
      return True
    if self.every == 0:
      return False
    now = time.time()
    if self.prev is None:
      self.prev = now
      return self.first
    if now >= self.prev + self.every:
      # Advance in whole periods to avoid drift under long stalls.
      self.prev += self.every * ((now - self.prev) // self.every)
      return True
    return False


class Once:

  def __init__(self):
    self.done = False

  def __call__(self):
    if not self.done:
      self.done = True
      return True
    return False


class Until:

  def __init__(self, until):
    self.until = until

  def __call__(self, step):
    if not self.until:
      return True
    return int(step) < self.until
