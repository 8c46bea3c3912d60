"""Distributed actor-learner protocol over the remote RPC layer.

The port of embodied_tpu/run/parallel_impl.py: combined() runs the agent
(actor and learner threads) in this process and spawns a logger process,
N env processes and a replay process; roles can also run on separate
machines through the parallel_env / parallel_envs / parallel_replay entry
scripts and the remote_envs / remote_replay flags.

Each role owns its RPC endpoints, its clocks and its periodic stats; the
entry points hand factories to a role. The actor is a batching RPC
server that grafts per-env policy carries in and out of a carry cache,
runs the batched policy, and forwards transitions to the replay and
logger services; the learner trains from prefetched sample futures and
pushes latent updates back to replay, which enforces the
SamplesPerInsert limiter on both sides.

Differences from the JAX package:
- Factories cross into the worker processes with the standard `pickle`
  (remote.Process), not `cloudpickle`: module-level functions or partials
  of them; a lambda raises before any process starts.
- Only the agent process touches the card. The env, replay and logger
  roles are children that see numpy only; the learner's `agent.stream`
  moves each sampled batch to the device.
- The carry cache fetches the policy carries with an explicit `.cpu()`
  and keeps them as host tensors (the carries may be bfloat16, which
  numpy lacks); `Agent.policy` puts them back on the device.
- The actor and the learner stop when the run ends: the supervisor's
  request stops the learner, which then closes its prefetching streams
  and sets the stop that ends the actor, and every RPC endpoint of the
  agent process is closed; the supervisor ends the other roles only
  after that.
- On a process group (models/common.py) each rank runs this script with
  its own envs, replay and logger, and its learner thread makes every
  collective of the rank once make_agent has returned (the actor's
  policy calls make none): the train steps', a sharded store's, the
  saves' and one decision a learner iteration (setup.decide) that stops
  every rank once some rank asks and fires reports, evaluations and
  saves at rank 0's times. So every rank makes the same train calls and
  stops at the same train-call index, and a rank's envs and replay keep
  serving its learner until then. A fixed actor, replay or logger
  address raises on a rank with LOCAL_RANK > 0 (rank 0 of its host binds
  it). The latent table's slots stay in each rank's range, as in `train`.
"""

import collections
import os
import pickle
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import core, native, remote
from ..core import limiters as limiterlib
from ..core import streams as streamlib
from ..parallel.guard import SYNCS
from ..parallel.setup import decide
from ..utils import Agg, Checkpoint, Counter, FPS, Path, Usage, timer, tree


def _tag(stats, label):
  return {f'{label}/{key}': value for key, value in stats.items()}


def _rows(batch):
  """Iterate a dict of stacked columns as (index, row-dict) pairs."""
  length = len(next(iter(batch.values())))
  for i in range(length):
    yield i, {key: column[i] for key, column in batch.items()}


def _split_logs(mapping):
  logs = {k: v for k, v in mapping.items() if k.startswith('log/')}
  rest = {k: v for k, v in mapping.items() if not k.startswith('log/')}
  return rest, logs


def _host(value):
  """A carry leaf as a host tensor. The copy off the card is an explicit
  crossing (JAX's device_get): the actor makes it outside the Agent's
  calls, while the learner's train step may hold the sync guard."""
  if isinstance(value, torch.Tensor):
    with SYNCS.allowed():
      return value.detach().cpu()
  return torch.as_tensor(np.asarray(value))


def _wait(event, stop, poll=0.5):
  """Wait for `event`; False if `stop` is set first."""
  while not event.wait(poll):
    if stop.is_set():
      return False
  return True


def _connected(clients, until):
  """Connect each RPC client that is not connected yet, waiting for its
  server for as long as the run lasts; False if `until` is set first.
  The roles of a run start together, each in a process of its own, and
  on a loaded host a role may take longer to start serving than a
  client's connect deadline (60 s)."""
  for client in clients:
    while client.sock is None:
      if until.is_set():
        return False
      try:
        client.connect(timeout=1)
      except remote.Disconnected:
        pass
  return True


class _CarryCache:
  """Per-env policy carries, gathered into batches by env id."""

  def __init__(self, template):
    template = tree.tree_map(_host, template)
    self._blank = tree.tree_map(lambda x: x[0], template)
    self._entries = {}

  def __len__(self):
    return len(self._entries)

  def gather(self, envids):
    rows = [self._entries.get(int(e), self._blank) for e in envids]
    return tree.tree_map(lambda *xs: torch.stack(xs), *rows)

  def scatter(self, envids, batch):
    batch = tree.tree_map(_host, batch)
    for i, envid in enumerate(envids):
      self._entries[int(envid)] = tree.tree_map(lambda x: x[i], batch)


class _Actor:
  """Batching policy server; feeds transitions to replay and logger until
  `stop` is set."""

  def __init__(self, agent, args, stop):
    self.agent = agent
    self.args = args
    self.stop = stop
    self.cache = _CarryCache(agent.init_policy(args.actor_batch))
    self.fps = FPS()
    self.log_clock = core.LocalClock(args.log_every)
    inflight = 8 * args.actor_threads
    self.logger = remote.Client(
        args.logger_addr, 'ActorLogger', maxinflight=inflight)
    self.replay = remote.Client(
        args.replay_addr, 'ActorReplay', maxinflight=inflight)
    self.server = remote.BatchServer(args.actor_addr, name='Actor')
    self.server.bind(
        'act', self._infer, self._forward,
        args.actor_batch, args.actor_threads)

  @timer.section('actor_workfn')
  def _infer(self, request):
    envid = request.pop('envid')
    assert envid.shape == (self.args.actor_batch,), envid.shape
    is_eval = request.pop('is_eval')
    self.fps.step(request['is_first'].size)
    obs, logs = _split_logs(request)
    # Eval envs act in the default mode, as in the JAX package.
    carry, acts, outs = self.agent.policy(self.cache.gather(envid), obs)
    self.cache.scatter(envid, carry)
    tran = {'envid': envid, 'is_eval': is_eval, **obs, **acts, **outs, **logs}
    tran = {k: np.asarray(v) for k, v in tran.items()}
    reply = dict(acts, reset=obs['is_last'].copy())
    return reply, tran

  @timer.section('actor_postfn')
  def _forward(self, tran):
    stripped, logs = _split_logs(tran)
    try:
      self.replay.call('add_batch', stripped)
      self.logger.call('tran', {**stripped, **logs})
      if self.log_clock():
        report = {
            'fps/policy': self.fps.result(),
            'parallel/ep_states': len(self.cache),
            **_tag(self.server.stats(), 'server/actor'),
            **_tag(self.logger.stats(), 'client/actor_logger'),
            **_tag(self.replay.stats(), 'client/actor_replay'),
        }
        self.logger.call('add', report)
    except remote.Disconnected:
      if not self.stop.is_set():
        raise  # else the run is ending and close() shut the clients

  def serve(self):
    self.server.start(block=False)
    self.stop.wait()

  def close(self):
    # The clients first: a batch worker blocked on a full client (a
    # replay that stopped taking inserts) then fails its call and ends.
    self.logger.close()
    self.replay.close()
    self.server.close()


class _SampleFeed:
  """Prefetched sample_batch_* futures exposed as an iterator; raises
  Disconnected once `until` is set."""

  def __init__(self, addr, source, until, depth=2):
    self.client = remote.Client(addr, f'LearnerReplay{source}')
    self.method = f'sample_batch_{source}'
    self.until = until
    self.depth = depth
    self.count = 0
    self._queue = None

  def __iter__(self):
    if self._queue is None:
      self._queue = collections.deque(
          self.client.call(self.method) for _ in range(self.depth))
    while True:
      self._queue.append(self.client.call(self.method))
      future = self._queue.popleft()
      while True:
        try:
          batch = future.result(timeout=0.5)
          break
        except TimeoutError:
          if self.until.is_set():
            raise remote.Disconnected('Disconnected: the run is stopping')
      self.count += 1
      yield batch

  def close(self):
    self.client.close()


class _Learner:
  """Owns the train loop, checkpointing, and report cadence.

  `request` is this rank's wish to stop (the run's duration, an
  interrupt, a failed role). On a process group the learner makes every
  collective of its rank after make_agent: the train step's, a sharded
  store's gathers, the saves and one decision at the top of each
  iteration (setup.decide), which stops every rank once some rank asks
  and fires reports, evaluations and saves where rank 0's clocks say, so
  that all ranks make the same calls at the same train-call index. The
  `feeds` ({'train', 'report', 'eval'}: iterables that count the batches
  they gave), `logger` and `updater` are the replay's and the logger's
  RPC clients in the run (`_Learner.connect`)."""

  def __init__(self, agent, args, request, feeds, logger, updater):
    self.agent = agent
    self.args = args
    self.request = request
    self.agg = Agg()
    self.usage = Usage(**dict(args.usage))
    self.fps = FPS()
    self.clocks = {
        'log': core.GlobalClock(args.log_every),
        'report': core.GlobalClock(args.report_every),
        'save': core.GlobalClock(args.save_every),
    }
    self.ckpt = Checkpoint(Path(args.logdir) / 'agent.pkl')
    self.ckpt.agent = agent
    if args.from_checkpoint:
      snapshot = pickle.loads(Path(args.from_checkpoint).read_bytes())
      agent.load(snapshot['agent'])
    self.ckpt.load_or_save()
    self.logger = logger
    self.updater = updater
    self.feeds = feeds
    self.streams = {}
    self.steps = 0  # train calls made
    self._ready = False  # every rank's report feed has given a batch

  @classmethod
  def connect(cls, agent, args, request, until):
    """The learner of the run, on RPC clients of its replay and logger,
    once both serve (see _connected); its feeds end at `until`. None if
    `until` is set before they serve."""
    logger = remote.Client(args.logger_addr, 'LearnerLogger', maxinflight=1)
    updater = remote.Client(
        args.replay_addr, 'LearnerReplayUpdater', maxinflight=8)
    feeds = {source: _SampleFeed(args.replay_addr, source, until)
             for source in ('train', 'report', 'eval')}
    clients = [logger, updater, *(feed.client for feed in feeds.values())]
    if not _connected(clients, until):
      for client in clients:
        client.close()
      return None
    return cls(agent, args, request, feeds, logger, updater)

  def _stream(self, source):
    feed = self.feeds[source]
    stream = self.agent.stream(streamlib.Stateless(iter(feed)))
    self.streams[source] = stream
    return iter(stream)

  def _evaluate(self, stream):
    carry = self.agent.init_report(self.args.batch_size)
    scores = Agg()
    rounds = self.args.consec_report * self.args.report_batches
    for _ in range(rounds):
      carry, metrics = self.agent.report(carry, next(stream))
      scores.add(metrics)
    return scores.result()

  def _decide(self):
    """(stop, report, evaluate, save) alike on every rank. The report
    clock skips while some rank's report feed has given nothing (known
    as of the last decision: the counts only grow)."""
    (report, save), (ready, evals), (stop,) = decide(
        first=[self.clocks['report'](skip=not self._ready),
               self.clocks['save']()],
        every=[self.feeds['report'].count, self.feeds['eval'].count],
        some=[self.request.is_set()])
    self._ready = ready
    report = report and ready
    return stop, report, report and evals and self.args.eval_envs, save

  def run(self):
    args = self.args
    batch_steps = args.batch_size * args.batch_length
    train = self._stream('train')
    report = self._stream('report')
    evals = self._stream('eval')
    carry = self.agent.init_train(args.batch_size)
    try:
      while True:
        stop, due_report, due_eval, due_save = self._decide()
        if stop:
          return
        with timer.section('learner_next'):
          batch = next(train)
        with timer.section('learner_train'):
          carry, outs, mets = self.agent.train(carry, batch)
        self.steps += 1
        if 'replay' in outs:
          self.updater.call('update', outs['replay'])
        self.agg.add(mets)
        self.fps.step(batch_steps)
        if due_report:
          self._report(report, evals if due_eval else None)
        self._maybe_log()
        if due_save:
          self._save()
    except (remote.Disconnected, RuntimeError) as e:
      # Replay/logger going away, or a feed ending at the stop, means the
      # run is shutting down.
      if 'connection closed' in str(e) or 'Disconnected' in str(e):
        print('Learner shutting down: services disconnected')
        return
      raise

  def _report(self, report, evals):
    with timer.section('learner_report'):
      self.logger.call('add', _tag(self._evaluate(report), 'report'))
      if evals is not None:
        self.logger.call('add', _tag(self._evaluate(evals), 'eval'))

  def _save(self):
    self.ckpt.save()

  def _maybe_log(self):
    if not self.clocks['log']():
      return
    stats = timer.stats()
    report = {
        'fps/train': self.fps.result(),
        'timer/agent': stats.pop('summary'),
        **_tag(stats, 'timer/agent'),
        **_tag(self.agg.result(), 'train'),
        **_tag(self.usage.stats(), 'usage/agent'),
    }
    self.logger.call('add', report)

  def close(self):
    """Stop the prefetch threads and close the RPC clients."""
    for feed in self.feeds.values():
      feed.close()
    streamlib.close(*self.streams.values())
    self.logger.close()
    self.updater.close()


class _ReplayService:
  """Serves add/sample/update with a SamplesPerInsert limiter."""

  def __init__(self, replay_train, replay_eval, make_stream, args):
    self.args = args
    self.train = replay_train
    self.eval = replay_eval
    self.streams = {
        'train': iter(make_stream(replay_train, 'train')),
        'report': iter(make_stream(replay_train, 'report')),
        'eval': iter(make_stream(replay_eval, 'eval')),
    }
    self.limiter = limiterlib.SamplesPerInsert(
        args.train_ratio / args.batch_length,
        tolerance=4 * args.batch_size,
        minsize=args.batch_size * replay_train.length)
    self.activity = Counter()
    self.ckpt = Checkpoint(Path(args.logdir) / 'replay.pkl')
    self.ckpt.replay_train = replay_train
    self.ckpt.replay_eval = replay_eval
    self.ckpt.limiter = self.limiter
    self.ckpt.load_or_save()
    self.logger = remote.Client(args.logger_addr, 'ReplayLogger', maxinflight=1)
    self.usage = Usage(**dict(args.usage))
    self.server = remote.Server(args.replay_addr, name='Replay')
    for name, fn in {
        'add_batch': self._ingest,
        'sample_batch_train': self._serve_train,
        'sample_batch_report': self._serve('report'),
        'sample_batch_eval': self._serve('eval'),
        'update': self._patch,
    }.items():
      self.server.bind(name, fn, workers=1)

  def _ingest(self, batch):
    self.activity.increment()
    envids = batch.pop('envid')
    for i, row in _rows(batch):
      if row.pop('is_eval', False):
        self.eval.add(row, int(envids[i]))
        continue
      limiterlib.wait(self.limiter.want_insert, 'Replay insert waiting')
      self.limiter.insert()
      self.train.add(row, int(envids[i]))
    return {}

  def _serve_train(self):
    self.activity.increment()
    for _ in range(self.args.batch_size):
      limiterlib.wait(self.limiter.want_sample, 'Replay sample waiting')
      self.limiter.sample()
    return next(self.streams['train'])

  def _serve(self, source):
    def fn():
      self.activity.increment()
      return next(self.streams[source])
    return fn

  def _patch(self, data):
    self.train.update(data)
    return {}

  def run(self):
    save_clock = core.LocalClock(self.args.save_every)
    log_clock = core.LocalClock(self.args.log_every)
    self.server.start(block=False)
    # The logger starts beside this role (see _connected); the
    # supervisor ends this process with the run.
    if self.logger.sock is None:
      self.logger.connect(timeout=None)
    while True:
      if save_clock() and self.activity > 0:
        self.activity.load(0)
        self.ckpt.save()
      if log_clock():
        report = {
            'timer/replay': timer.stats()['summary'],
            **_tag(self.train.stats(), 'replay'),
            **_tag(self.eval.stats(), 'replay_eval'),
            **_tag(self.usage.stats(), 'usage/replay'),
            **_tag(self.server.stats(), 'server/replay'),
        }
        self.logger.call('add', report)
      time.sleep(1)


class _EpisodeBook:
  """Reassembles per-env episodes from interleaved transition batches."""

  def __init__(self, logger, timeout):
    self.logger = logger
    self.timeout = timeout
    self.tally = Agg()
    self.epstats = Agg()
    self.open = collections.defaultdict(Agg)
    self.touched = {}
    self.closed = collections.defaultdict(lambda: True)

  def feed(self, batch):
    now = time.time()
    envids = batch.pop('envid')
    self.logger.step.increment(int((~batch['is_eval']).sum()))
    self.tally.add('ep_starts', batch['is_first'].sum(), agg='sum')
    self.tally.add('ep_ends', batch['is_last'].sum(), agg='sum')
    for i, row in _rows(batch):
      self._feed_row(int(envids[i]), row, now)
    self._evict(now)

  def _feed_row(self, addr, row, now):
    self.touched[addr] = now
    episode = self.open[addr]
    if row['is_first']:
      episode.reset()
      self.tally.add('ep_abandoned', int(not self.closed[addr]), agg='sum')
    self.closed[addr] = bool(row['is_last'])
    episode.add('score', row['reward'], agg='sum')
    episode.add('length', 1, agg='sum')
    episode.add('rewards', row['reward'], agg='stack')
    video_addr = next(iter(self.open.keys()))
    for key, value in row.items():
      is_image = (
          hasattr(value, 'dtype') and value.dtype == np.uint8 and
          value.ndim == 3)
      if is_image:
        if addr == video_addr:
          episode.add(f'policy_{key}', value, agg='stack')
      elif key.startswith('log/'):
        episode.add(key, value, agg=('avg', 'max', 'sum'))
    if row['is_last']:
      self._close(episode)

  def _close(self, episode):
    result = episode.result()
    self.logger.add({
        'score': result.pop('score'),
        'length': result.pop('length') - 1,
    }, prefix='episode')
    rewards = result.pop('rewards')
    if len(rewards) > 1:
      deltas = np.abs(rewards[1:] - rewards[:-1])
      result['reward_rate'] = (deltas >= 0.01).mean()
    self.epstats.add(result)

  def _evict(self, now):
    for addr, last in list(self.touched.items()):
      if now - last >= self.timeout:
        print('Dropping episode statistics due to timeout.')
        self.open.pop(addr, None)
        self.touched.pop(addr, None)


class _Monitor:
  """The logger role: owns the global step and aggregates everything."""

  def __init__(self, logger, args):
    self.args = args
    self.logger = logger
    self.usage = Usage(**dict(args.usage))
    self.activity = Counter()
    self.book = _EpisodeBook(logger, args.episode_timeout)
    self.ckpt = Checkpoint(Path(args.logdir) / 'logger.pkl')
    self.ckpt.step = logger.step
    self.ckpt.load_or_save()
    self.server = remote.Server(args.logger_addr, 'Logger')
    self.server.bind('add', self._absorb)
    self.server.bind('tran', self._transitions)

  def _absorb(self, metrics):
    self.activity.increment()
    self.logger.add(metrics)
    return {}

  def _transitions(self, batch):
    self.activity.increment()
    self.book.feed(batch)
    return {}

  def run(self):
    log_clock = core.LocalClock(self.args.log_every)
    save_clock = core.LocalClock(self.args.save_every)
    self.server.start(block=False)
    written_at = int(self.logger.step)
    while True:
      time.sleep(1)
      if log_clock() and self.activity > 0:
        self.activity.load(0)
        self.logger.add({'timer/logger': timer.stats()['summary']})
        self.logger.add(self.book.tally.result(), prefix='parallel')
        self.logger.add(self.book.epstats.result(), prefix='epstats')
        self.logger.add(self.usage.stats(), prefix='usage/logger')
        self.logger.add(self.server.stats(), prefix='server/logger')
        if self.logger.step != written_at:
          self.logger.write()
          written_at = int(self.logger.step)
      if save_clock():
        self.ckpt.save()


class _EnvPump:
  """Steps one env against the actor service, reconnecting on failure."""

  def __init__(self, env, envid, args, is_eval):
    self.env = env
    self.envid = envid
    self.args = args
    self.is_eval = is_eval
    self.name = f'Env{envid:05}'
    self.fps = FPS()
    self.log_clock = core.LocalClock(args.log_every)
    self.chatty = envid == 0
    if self.chatty:
      self.logger = remote.Client(
          args.logger_addr, f'{self.name}Logger', maxinflight=1)
      self.usage = Usage(**dict(args.usage))
    self.actor = remote.Client(args.actor_addr, self.name, autoconn=False)
    # The actor serves once the agent is built and its learner reaches
    # the replay, which may take longer than the client's deadline on a
    # loaded host; the env's supervisor ends it with the run.
    self.actor.connect(timeout=None)

  def _null_action(self):
    action = {k: v.sample() for k, v in self.env.act_space.items()}
    action['reset'] = True
    return action

  def run(self):
    fresh = True
    action = None
    score, length = 0.0, 0
    while True:
      if fresh:
        action = self._null_action()
        score, length = 0.0, 0
        fresh = False
      obs = self.env.step(action)
      obs = {k: np.asarray(v, order='C') for k, v in obs.items()}
      obs['is_eval'] = self.is_eval
      score += float(obs['reward'])
      length += 1
      self.fps.step(1)
      if obs['is_last']:
        fresh = True
        if self.chatty:
          print(f'[{self.name}] Episode of length {length} '
                f'with score {score:.2f}')
      try:
        action = self.actor.call('act', {'envid': self.envid, **obs}).result()
      except remote.Disconnected:
        print(f'[{self.name}] Env lost connection to agent')
        self.actor.connect()
        fresh = True
      if self.chatty and self.log_clock():
        self.logger.call('add', {
            'fps/env': self.fps.result(),
            'timer/env': timer.stats()['summary'],
            **_tag(self.usage.stats(), 'usage/env'),
            **_tag(self.actor.stats(), 'client/env_actor'),
        })


# --- Entry points (role scripts) ---------------------------------------


def combined(
    make_agent, make_replay_train, make_replay_eval, make_env_train,
    make_env_eval, make_stream, make_logger, args):
  if args.actor_batch <= 0:
    args = args.update(actor_batch=max(1, args.envs // 2))
  assert args.actor_batch <= args.envs, (args.actor_batch, args.envs)
  local = int(os.environ.get('LOCAL_RANK', 0))
  for key in ('actor_addr', 'replay_addr', 'logger_addr'):
    if '{auto}' in args[key]:
      args = args.update({key: args[key].format(auto=remote.free_port())})
    elif local:
      # Each rank of a host runs its own roles: a fixed address would be
      # bound, or served, by rank 0's as well.
      raise ValueError(
          f'run.{key} is fixed ({args[key]}) on a rank with LOCAL_RANK '
          f'{local}, which shares its host with rank 0\'s roles: give '
          f"'host:{{auto}}' so that each rank binds its own port")
  native.codec()  # built once, here, before the workers that use it start

  # `request` asks the agent to stop (the duration, an interrupt, a failed
  # role); `stop` is set once its learner has left, and only then do the
  # processes go, which its learner may wait on until every rank stops.
  request, stop = threading.Event(), threading.Event()
  fleet = [remote.Thread(
      parallel_agent, make_agent, args, request, stop, name='agent',
      stop=request.set)]
  fleet.append(remote.Process(
      parallel_logger, make_logger, args, name='logger'))
  if not args.remote_envs:
    ctors = [make_env_train] * args.envs + [make_env_eval] * args.eval_envs
    for i, ctor in enumerate(ctors):
      fleet.append(remote.Process(
          parallel_env, ctor, i, args, i >= args.envs, name=f'env{i}'))
  if not args.remote_replay:
    fleet.append(remote.Process(
        parallel_replay, make_replay_train, make_replay_eval, make_stream,
        args, name='replay'))
  remote.run(fleet, duration=args.duration or None, until=stop)


def parallel_agent(make_agent, args, request=None, stop=None):
  """The agent role: the actor and learner threads share one agent on
  one device. The actor starts serving only after the learner finished
  restoring the checkpoint. `request` (the caller's, the run's duration,
  or a failed thread) asks the learner to stop; once it has left, it
  sets `stop` and the actor ends. Without a process group the learner
  leaves at the request; on one, at the first decision after some rank
  asked (see _Learner), and its sample feeds wait for batches until then,
  so the actor serves this rank's envs until its learner has left."""
  request = request or threading.Event()
  stop = stop or threading.Event()
  agent = make_agent()
  group = dist.is_initialized() and dist.get_world_size() > 1
  if request.is_set() and not group:
    stop.set()
    return
  ready = threading.Event()

  def actor_thread():
    actor = _Actor(agent, args, stop)
    try:
      if _wait(ready, stop):
        with timer.section('actor'):
          actor.serve()
    finally:
      actor.close()

  def learner_thread():
    try:
      learner = _Learner.connect(
          agent, args, request, stop if group else request)
      if learner is None:  # The run ended before its replay served.
        return
      try:
        ready.set()
        with timer.section('learner'):
          learner.run()
      finally:
        learner.close()
    finally:
      stop.set()

  remote.run([
      remote.Thread(learner_thread, name='learner', stop=request.set),
      remote.Thread(actor_thread, name='actor', stop=request.set),
  ], duration=args.duration or None)


def parallel_replay(make_replay_train, make_replay_eval, make_stream, args):
  service = _ReplayService(
      make_replay_train(), make_replay_eval(), make_stream, args)
  service.run()


def parallel_logger(make_logger, args):
  _Monitor(make_logger(), args).run()


def parallel_env(make_env, envid, args, is_eval=False):
  assert envid >= 0, envid
  env = make_env(envid)
  _EnvPump(env, envid, args, is_eval).run()


def parallel_envs(make_env, make_env_eval, args):
  ctors = [make_env] * args.envs + [make_env_eval] * args.eval_envs
  fleet = [
      remote.Process(parallel_env, ctor, i, args, i >= args.envs,
                     name=f'env{i}')
      for i, ctor in enumerate(ctors)]
  remote.run(fleet)
