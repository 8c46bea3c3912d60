"""The port's RPC layer, codec, supervised workers and decision server,
held against the JAX package's own modules on the CPU.

- Codec: the port's codec and the JAX codec decode each other's frames
  and give the same meta bytes for the same payload (every dtype of
  tests/test_native.py, numpy scalars, zero-copy large arrays,
  non-contiguous and empty arrays, pickled objects).
- RPC: a port Client against a JAX Server and a JAX Client against a
  port Server, in the native and the pickle wire format; a port
  BatchServer batching the requests of several clients; a closed server
  fails the client's calls with Disconnected and its threads end.
- Processes: `run` tears every worker down when a child raises; a
  Process of a lambda raises before any process starts.
- Clock: two replicas, against the port's decision server and against
  the JAX one under the same scripted time, give the same decisions; a
  lagging replica gets the historical decision for its tick.
"""

import socket
import threading
import time

import numpy as np
import pytest

from embodied_tpu import native as jnative
from embodied_tpu.core import clock as jclock
from embodied_tpu.remote import rpc as jrpc
from embodied_tpu_torch import native, remote
from embodied_tpu_torch.core import clock
from embodied_tpu_torch.remote import rpc
from embodied_tpu_torch.run import parallel_impl


class _Custom:

  def __init__(self, v):
    self.v = v

  def __eq__(self, other):
    return self.v == other.v


DTYPES = ('uint8', 'int8', 'int32', 'int64', 'float16', 'float32',
          'float64', 'bool')


def payloads():
  rng = np.random.default_rng(0)
  cases = {f'array_{d}': {'x': rng.normal(0, 100, (3, 7)).astype(d)}
           for d in DTYPES}
  cases.update(
      scalars={'a': np.float32(1.5), 'b': np.int64(-3), 'c': np.bool_(True),
               'd': np.uint8(7)},
      containers=(1, -2**40, 3.5, 'text', None, True, False, b'bytes',
                  [1, [2, (3,)]], {'k': {'n': 7}}),
      large={'x': rng.normal(size=(64, 1024)).astype(np.float32),
             'img': rng.integers(0, 255, (16, 64, 64, 3), np.uint8)},
      noncontiguous={'x': np.arange(100).reshape(10, 10)[::2, ::3],
                     'y': np.arange(24.0).reshape(2, 3, 4).transpose(2, 0, 1)},
      empty={'e': np.zeros((0, 4), np.float32), 'd': {}, 'l': [], 's': ''},
      pickled={'custom': _Custom(5), 'set': {1, 2}, 'big': 2**100,
               'cplx': 1 + 2j},
  )
  return cases


def equal(a, b, scalars=True):
  """Equal values, dtypes and shapes; a numpy scalar may come back as a
  0-d array (the codec's form) unless `scalars` is False."""
  if isinstance(a, np.generic) and scalars:
    a = np.asarray(a)
  if isinstance(a, np.ndarray) or isinstance(a, np.generic):
    b = np.asarray(b) if scalars else b
    return (type(a) is type(b) and a.dtype == b.dtype and
            np.shape(a) == np.shape(b) and np.array_equal(a, b))
  if isinstance(a, dict):
    return a.keys() == b.keys() and all(
        equal(a[k], b[k], scalars) for k in a)
  if isinstance(a, (list, tuple)):
    return (type(a) is type(b) and len(a) == len(b) and
            all(equal(x, y, scalars) for x, y in zip(a, b)))
  return type(a) is type(b) and a == b


def frame(codec, obj, align=64):
  meta, buffers, region = codec.encode(obj)
  pad = (-len(meta)) % align
  out = bytearray(len(meta) + pad + region)
  out[:len(meta)] = meta
  offset = len(meta) + pad
  for buf in buffers:
    view = memoryview(buf).cast('B')
    out[offset:offset + view.nbytes] = view
    offset += view.nbytes
  return bytes(meta), out, len(meta) + pad


@pytest.fixture
def codecs():
  port = native.codec()
  assert port is not None, native.codec_status()
  assert native.codec_status() == 'native'
  if jnative.codec is None:
    pytest.skip('the JAX package could not build its codec')
  return port, jnative.codec


@pytest.mark.parametrize('name', sorted(payloads()))
def test_codecs_cross_decode(codecs, name):
  port, jax_codec = codecs
  obj = payloads()[name]
  meta_p, frame_p, off_p = frame(port, obj)
  meta_j, frame_j, off_j = frame(jax_codec, obj)
  assert meta_p == meta_j
  by_jax = jax_codec.decode(frame_p, 0, len(meta_p), off_p)
  by_port = port.decode(frame_j, 0, len(meta_j), off_j)
  assert equal(obj, by_jax) and equal(obj, by_port), name
  assert equal(by_jax, by_port, scalars=False), name
  if name == 'large':
    assert by_port['x'].base is not None  # aliases the frame: no copy


def test_codec_builds_outside_the_source_tree():
  path, _ = native.target()
  assert path.exists() and path.parent.name == 'native'
  assert path.parent.parent.name == 'build'
  assert not list(native.SOURCE.parent.glob('*.so'))


def _double(x):
  return {k: v * 2 for k, v in x.items()}


REQUEST = {'obs': np.arange(4 * 8 * 8 * 3, dtype=np.uint8).reshape(4, 8, 8, 3),
           'deter': np.linspace(-1, 1, 4 * 32).astype(np.float16).reshape(4, 32),
           'reward': np.float32(2.0)}


def set_format(monkeypatch, fmt):
  port = native.codec() if fmt == 'native' else None
  monkeypatch.setattr(rpc, '_encoder', lambda: port)
  monkeypatch.setattr(jrpc, '_codec', jnative.codec if fmt == 'native'
                      else None)


@pytest.mark.parametrize('fmt', ['native', 'pickle'])
@pytest.mark.parametrize('client_pkg,server_pkg', [('port', 'jax'),
                                                   ('jax', 'port')])
def test_client_and_server_across_packages(
    monkeypatch, codecs, fmt, client_pkg, server_pkg):
  set_format(monkeypatch, fmt)
  mods = {'port': remote, 'jax': jrpc}
  port = remote.free_port()
  server = mods[server_pkg].Server(port, 'Server')
  server.bind('double', _double)
  server.start(block=False)
  try:
    client = mods[client_pkg].Client(port, 'Client', connect=True)
    out = client.call('double', REQUEST).result(timeout=10)
    assert equal(out, _double(REQUEST))
    with pytest.raises(RuntimeError):
      client.call('nosuch').result(timeout=10)
    client.close()
  finally:
    server.close()


def test_frames_carry_their_format(monkeypatch, codecs):
  # A pickle sender is understood whatever the receiver sends; a native
  # frame is decoded whatever this end would send.
  for sender, receiver in [(None, native.codec()), (native.codec(), None)]:
    a, b = socket.socketpair()
    try:
      monkeypatch.setattr(rpc, '_encoder', lambda: sender)
      rpc._send(a, threading.Lock(), REQUEST)
      monkeypatch.setattr(rpc, '_encoder', lambda: receiver)
      assert equal(rpc._recv(b), REQUEST)
    finally:
      a.close(), b.close()


@pytest.mark.parametrize('client_pkg', ['port', 'jax'])
def test_batch_server_batches_several_clients(client_pkg):
  mods = {'port': remote, 'jax': jrpc}
  port = remote.free_port()
  server = remote.BatchServer(port, 'Batch')
  seen = []

  def workfn(obs):
    assert obs['v'].shape == (3,)
    return {'out': obs['v'] * 10}, {'sum': obs['v'].sum()}

  server.bind('act', workfn, seen.append, batch=3, workers=1)
  server.start(block=False)
  clients = []
  try:
    clients = [mods[client_pkg].Client(port, f'C{i}', connect=True)
               for i in range(3)]
    futures = [c.call('act', {'v': np.int64(i)})
               for i, c in enumerate(clients)]
    outs = sorted(int(f.result(timeout=15)['out']) for f in futures)
    assert outs == [0, 10, 20]
    deadline = time.time() + 5
    while not seen and time.time() < deadline:
      time.sleep(0.05)
    assert [int(s['sum']) for s in seen] == [3]
  finally:
    for c in clients:
      c.close()
    server.close()
  assert not any(t.is_alive() for t in server.threads)


def test_closed_server_disconnects_the_client():
  port = remote.free_port()
  server = remote.Server(port, 'Slow')
  release = threading.Event()
  server.bind('wait', lambda: release.wait(10) and {})
  server.bind('echo', lambda x: x)
  server.start(block=False)
  client = remote.Client(port, 'Client', connect=True, autoconn=False)
  assert client.call('echo', 5).result(timeout=10) == 5
  pending = client.call('wait')
  closer = threading.Thread(target=server.close)
  closer.start()
  with pytest.raises(remote.Disconnected):
    pending.result(timeout=10)
  release.set()
  closer.join(15)
  with pytest.raises(remote.Disconnected):
    client.call('echo', 6).result(timeout=10)
  assert client.stats()['inflight'] == 0
  client.close()
  assert not closer.is_alive() and not server.listener.is_alive()
  assert not any(t.is_alive() for t in server.threads)
  assert not client.reader.is_alive()


def _raise_soon():
  time.sleep(0.5)
  raise ValueError('planted')


def _sleep_long():
  time.sleep(60)


def test_run_tears_everything_down_when_a_child_raises():
  stop = threading.Event()
  workers = [
      remote.Process(_raise_soon, name='raiser'),
      remote.Process(_sleep_long, name='sleeper'),
      remote.Thread(stop.wait, name='waiter', stop=stop.set)]
  start = time.time()
  with pytest.raises(RuntimeError, match='raiser'):
    remote.run(workers, duration=30)
  assert time.time() - start < 20
  assert not any(w.running for w in workers)
  assert workers[0].proc.exitcode not in (None, 0)


def test_run_raises_for_a_thread_that_fails_while_it_is_stopped():
  # The run ends on its duration; the thread raises as it stops, after
  # the last poll: the run fails all the same.
  stop = threading.Event()

  def fails_at_stop():
    stop.wait()
    raise ValueError('planted')

  worker = remote.Thread(fails_at_stop, name='stopper', stop=stop.set)
  with pytest.raises(RuntimeError, match='stopper'):
    remote.run([worker], duration=0.5)
  assert not worker.running


def test_process_raises_on_a_lambda_before_starting_one(tmp_path):
  import multiprocessing as mp
  with pytest.raises(TypeError, match='pickle'):
    remote.Process(lambda: None)
  # combined() makes every worker before it starts any.
  from embodied_tpu_torch.utils import Config
  args = Config(actor_batch=1, envs=2, eval_envs=0, remote_envs=False,
                remote_replay=False, duration=5, actor_addr='localhost:1',
                replay_addr='localhost:2', logger_addr='localhost:3')
  with pytest.raises(TypeError, match='pickle'):
    parallel_impl.combined(
        _never, _never, _never, lambda i: None, _never, _never, _never,
        args)
  assert not mp.active_children()


def _never(*args):
  raise AssertionError('no worker may start')


class _Servers:
  """Records the JAX package's servers, so a test can close them."""

  def __init__(self, monkeypatch):
    self.made = []
    base = jrpc.Server
    made = self.made

    class Server(base):
      def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        made.append(self)
    monkeypatch.setattr(jrpc, 'Server', Server)
    import embodied_tpu.remote as jremote
    monkeypatch.setattr(jremote, 'Server', Server)


class _Time:

  def __init__(self, now):
    self.now = now

  def time(self):
    return self.now


# (seconds to advance, replica, clock) in order; each poll's decision is
# recorded. Replica 1 lags: it reads ticks that replica 0 decided long
# before, at times when its own wall clock would say otherwise.
SCRIPT = [(0, 0, 'log'), (0, 1, 'log'), (4, 0, 'log'), (7, 0, 'log'),
          (0, 0, 'save'), (1, 1, 'log'), (1, 1, 'save'), (30, 0, 'log'),
          (0, 1, 'log'), (0, 1, 'log'), (2, 0, 'save'), (0, 0, 'log'),
          (0, 1, 'save'), (0, 1, 'log')]
EVERY = {'log': 10, 'save': 20}


def run_script(module, monkeypatch, port_clocks):
  """The SCRIPT's decisions, by clocks of the port (port_clocks) or of
  `module`'s package, against `module`'s decision server."""
  fake = _Time(1000.0)
  monkeypatch.setattr(module, 'time', fake)
  port = remote.free_port()
  if module is clock:
    server = clock.serve(port, 2)
  else:
    module._serve(port, 2)
    server = None
  make = clock.GlobalClock if port_clocks else jclock.GlobalClock
  owner = clock if port_clocks else jclock
  clients = [remote.Client(port, f'R{i}', connect=True) for i in range(2)]
  clocks = []
  for replica, client in enumerate(clients):
    monkeypatch.setattr(owner, '_CLIENT', client)
    monkeypatch.setattr(owner, '_REPLICA', replica)
    monkeypatch.setattr(make, '_created', [0])
    clocks.append({name: make(EVERY[name]) for name in ('log', 'save')})
  decisions = []
  try:
    for advance, replica, name in SCRIPT:
      fake.now += advance
      monkeypatch.setattr(owner, '_CLIENT', clients[replica])
      monkeypatch.setattr(owner, '_REPLICA', replica)
      decisions.append(bool(clocks[replica][name]()))
  finally:
    for client in clients:
      client.close()
    if server:
      server.close()
  return decisions


def test_two_replicas_get_the_same_decisions(monkeypatch):
  servers = _Servers(monkeypatch)
  try:
    port = run_script(clock, monkeypatch, True)
    reference = run_script(jclock, monkeypatch, False)
    mixed = run_script(jclock, monkeypatch, True)
  finally:
    for server in servers.made:
      server.close()
  assert port == reference == mixed
  # Replica 0 decides each tick at its own time; replica 1 reads the
  # same tick's decision later, whatever its clock says.
  assert port == [False, False, False, True, False, False, False, True,
                  True, True, True, False, True, False]
