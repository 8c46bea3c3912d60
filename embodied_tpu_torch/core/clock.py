"""Wall-clock schedules, consistent across replicas.

The port of embodied_tpu/core/clock.py: LocalClock (every=0 disables,
negative fires always) and GlobalClock, which returns the identical
decision on every replica for the same tick.

Replicas never block on each other. Each replica numbers its calls to a
given clock with a local tick counter; replica 0 serves `poll(clock,
tick)` requests by deciding each tick ONCE (on first ask, from its own
wall clock) and memoizing the answer until every replica has read it. A
lagging replica therefore gets the historical decision for its tick
instead of stalling the whole cluster at a barrier, and the decision
sequence is identical everywhere by construction.

Unlike the JAX package, a GlobalClock keeps the client and replica index
that `setup` set when it was made, and `serve` returns its server, so
that a caller can close it.
"""

import threading
import time

_CLIENT = None
_REPLICA = None


def setup(is_server, replica, replicas, port, addr):
  """Start the decision server on replica 0 and connect every replica.
  Returns the server on the replica that runs it, else None."""
  global _CLIENT, _REPLICA
  assert _CLIENT is None
  if replicas <= 1:
    return None
  from .. import remote
  server = serve(port, replicas) if is_server else None
  client = remote.Client(addr, 'ClockClient')
  client.connect()
  _CLIENT = client
  _REPLICA = replica
  return server


def serve(port, replicas):
  """The decision server for `replicas` replicas, started on `port`."""
  from .. import remote

  lock = threading.Lock()
  clocks = {}  # clockid -> [every, last_fire_time]
  memo = {}  # (clockid, tick) -> [decision, reads_left]

  def create(replica, clockid, every):
    # Replicas create clocks in the same program order, so the caller
    # supplies the id (its local creation index); first creation wins.
    with lock:
      if clockid not in clocks:
        clocks[clockid] = [float(every), time.time()]
      elif clocks[clockid][0] != float(every):
        raise ValueError(
            f'Clock {clockid} made with every={every} by replica '
            f'{replica}, with {clocks[clockid][0]} before')
    return clockid

  def poll(replica, clockid, tick, skip):
    with lock:
      key = (clockid, tick)
      entry = memo.get(key)
      if entry is None:
        every, last = clocks[clockid]
        now = time.time()
        if every == 0:
          decision = False
        elif every < 0:
          decision = True
        elif now >= last + every:
          decision = True
          clocks[clockid][1] = now
        else:
          decision = False
        # The first asker's skip flag decides; flags are replica-uniform
        # (they encode "suppress the first firing", set at construction).
        decision = decision and not skip
        entry = memo[key] = [decision, replicas]
      entry[1] -= 1
      if entry[1] <= 0:
        del memo[key]
      return entry[0]

  server = remote.Server(port, 'ClockServer')
  server.bind('create', create, workers=replicas)
  server.bind('poll', poll, workers=replicas)
  server.start(block=False)
  return server


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


class GlobalClock:
  """Cluster-consistent clock. Without `setup` (one replica) it is a
  LocalClock; with it, it polls the replica-0 decision server with a
  local tick counter (see the module docstring)."""

  _created = [0]  # Per-process creation index = cluster-wide clock id.

  def __init__(self, every, first=False):
    self.client, self.replica = _CLIENT, _REPLICA
    if self.client is None:
      self.local = LocalClock(every, first)
      return
    self.local = None
    self.clockid = GlobalClock._created[0]
    GlobalClock._created[0] += 1
    self.client.call('create', self.replica, self.clockid, every).result()
    self.tick = 0
    self.suppress_first = not first

  def __call__(self, step=None, skip=None):
    if self.local is not None:
      return self.local(step, skip)
    skip = bool(skip) or (self.suppress_first and self.tick == 0)
    decision = self.client.call(
        'poll', self.replica, self.clockid, self.tick, skip).result()
    self.tick += 1
    return decision
