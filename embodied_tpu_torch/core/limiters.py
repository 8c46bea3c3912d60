"""Replay-ratio enforcement between inserts and samples.

A copy of embodied_tpu/core/limiters.py.

Capability parity: the reference's embodied/core/limiters.py (wait helper and
the SamplesPerInsert token bucket with tolerance and minimum size).
"""

import threading
import time


def wait(predicate, message=None, sleep=0.01, notify=10.0):
  start = time.time()
  notified = False
  while True:
    outcome = predicate()
    if isinstance(outcome, tuple):
      done, reason = outcome
    else:
      done, reason = outcome, None
    if done:
      return
    if message and not notified and time.time() - start >= notify:
      print(f'{message}' + (f' ({reason})' if reason else ''))
      notified = True
    time.sleep(sleep)


class SamplesPerInsert:
  """Token bucket keeping samples/inserts near a target ratio.

  Each insert grants `samples_per_insert` sample tokens; sampling consumes
  one token. `tolerance` bounds how far ahead either side may run, and
  `minsize` blocks sampling until enough items exist.
  """

  def __init__(self, samples_per_insert, tolerance, minsize=1):
    assert samples_per_insert > 0, samples_per_insert
    assert tolerance >= 1, tolerance
    assert minsize >= 1, minsize
    self.samples_per_insert = samples_per_insert
    self.tolerance = tolerance
    self.minsize = minsize
    self.size = 0
    self.balance = 0.0  # Available sample tokens.
    self.lock = threading.Lock()

  def want_insert(self):
    with self.lock:
      if self.size < self.minsize:
        return True, 'filling'
      if self.balance >= self.tolerance:
        return False, 'too many unsampled inserts'
      return True, 'ok'

  def want_sample(self):
    with self.lock:
      if self.size < self.minsize:
        return False, f'too few items ({self.size} < {self.minsize})'
      if self.balance <= -self.tolerance:
        return False, 'sampling ahead of inserts'
      return True, 'ok'

  def insert(self):
    with self.lock:
      self.size += 1
      self.balance += self.samples_per_insert

  def sample(self):
    with self.lock:
      self.balance -= 1.0

  def save(self):
    with self.lock:
      return {'size': self.size, 'balance': self.balance}

  def load(self, data):
    with self.lock:
      self.size = data['size']
      self.balance = data['balance']
