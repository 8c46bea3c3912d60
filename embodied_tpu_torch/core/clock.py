"""Wall-clock schedules.

The LocalClock of embodied_tpu/core/clock.py (every=0 disables, negative
fires always). The cluster-wide GlobalClock serves the multi-replica
scripts, which come in a later slice.
"""

import time


class LocalClock:
  """Fires at most every `every` seconds; `first` controls the initial
  call's result. every=0 never fires, negative always fires."""

  def __init__(self, every, first=False):
    self.every = every
    self.first = first
    self.armed_at = None

  def __call__(self, step=None, skip=None):
    if skip or self.every == 0:
      return False
    if self.every < 0:
      return True
    now = time.time()
    if self.armed_at is None:
      self.armed_at = now
      return self.first
    if now - self.armed_at >= self.every:
      self.armed_at = now
      return True
    return False
