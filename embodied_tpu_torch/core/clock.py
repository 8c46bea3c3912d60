"""Wall-clock schedules.

The LocalClock of embodied_tpu/core/clock.py (every=0 disables, negative
fires always), and its GlobalClock in the single-process form: without a
decision server it is a LocalClock. The decision server that keeps
replicas' decisions identical comes with the distribution slice
(ROADMAP.md §1, item 9); `setup` raises for more than one replica.
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


def setup(is_server, replica, replicas, port, addr):
  """Connect the replicas to one decision server: nothing to do for one
  replica; more than one raises."""
  if replicas > 1:
    raise NotImplementedError(
        f'GlobalClock across {replicas} replicas needs the decision server, '
        'which comes with the distribution slice (ROADMAP.md §1, item 9).')


class GlobalClock:
  """Cluster-consistent clock. With one replica, the only form so far, it
  decides as a LocalClock."""

  def __init__(self, every, first=False):
    self.local = LocalClock(every, first)

  def __call__(self, step=None, skip=None):
    return self.local(step, skip)
