"""TCP RPC: clients with futures, method servers, and batching servers.

The port of embodied_tpu/remote/rpc.py, on the same wire: Client(addr,
name, maxinflight, autoconn) with attribute-style calls returning futures
and .stats(); Server.bind(method, fn, workers=N); BatchServer batching
requests from many clients into one call of workfn(batched) -> (results,
extra) with postfn(extra); free_port(); the Disconnected exception.

Wire format per frame:
  8-byte total length | 1-byte format | format-specific payload.
Format 1 (native): 4-byte meta length | codec meta | pad to 64 | buffer
region, encoded and decoded by the C++ codec (embodied_tpu_torch/native),
one C call per message, arrays scatter-gather sent and rebuilt as
aliasing views (zero copy).
Format 0 (pickle): 4-byte meta length | pickle-5 meta | buffer-size table
| raw out-of-band buffers, sent when the codec did not build. The format
byte lets mixed endpoints talk: a native frame is decoded whenever this
end has the codec, whatever it sends.

Unlike the JAX package, closing an endpoint ends its threads: a closed
Client fails its pending futures with Disconnected, and Server.close
shuts its sockets down (on Linux a socket closed under a blocked accept
or recv does not wake it) and joins its workers. A method that raises
prints its trace on the server's side too.
"""

import pickle
import queue
import socket
import struct
import sys
import threading
import time
import traceback

import numpy as np

from .. import native

_HEADER = struct.Struct('>Q')
_META = struct.Struct('>I')
_ALIGN = 64
_JOIN_S = 10.0

# The codec frames are sent with; None sends pickle. Receiving does not
# depend on it.
_encoder = native.codec


class Disconnected(Exception):
  pass


def free_port():
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
    sock.bind(('', 0))
    return sock.getsockname()[1]


def _send(sock, lock, payload):
  codec = _encoder()
  if codec is not None:
    meta, buffers, region = codec.encode(payload)
    pre = 1 + _META.size + len(meta)
    pad = (-pre) % _ALIGN
    total = pre + pad + region
    parts = [
        _HEADER.pack(total) + b'\x01' + _META.pack(len(meta)),
        meta, b'\x00' * pad, *buffers]
  else:
    buffers = []
    meta = pickle.dumps(payload, protocol=5, buffer_callback=buffers.append)
    views = []
    for buf in buffers:
      view = buf.raw()
      views.append(view if view.c_contiguous else bytes(view))
    sizes = struct.pack(
        f'>I{len(views)}Q', len(views),
        *[memoryview(v).nbytes for v in views])
    total = 1 + _META.size + len(meta) + len(sizes) + sum(
        memoryview(v).nbytes for v in views)
    parts = [
        _HEADER.pack(total) + b'\x00' + _META.pack(len(meta)),
        meta, sizes, *views]
  with lock:
    try:
      _sendall_parts(sock, parts)
    except OSError as e:
      raise Disconnected(str(e))


def _sendall_parts(sock, parts):
  # Scatter/gather send in IOV_MAX-safe groups; falls back to sequential
  # sendall on partial sends.
  remaining = [p if isinstance(p, bytes) else memoryview(p).cast('B')
               for p in parts]
  for lo in range(0, len(remaining), 512):
    group = remaining[lo:lo + 512]
    total = sum(len(p) if isinstance(p, bytes) else p.nbytes for p in group)
    sent = sock.sendmsg(group)
    if sent != total:
      flat = b''.join(bytes(p) for p in group)
      sock.sendall(flat[sent:])


def _recv(sock):
  header = _recv_exact(sock, _HEADER.size)
  (total,) = _HEADER.unpack(header)
  frame = _recv_exact(sock, total)
  view = memoryview(frame)
  fmt = view[0]
  (meta_len,) = _META.unpack(view[1:1 + _META.size])
  offset = 1 + _META.size
  if fmt == 1:
    codec = native.codec()
    if codec is None:
      raise RuntimeError(
          'The peer sent a native frame and this end has no codec: '
          f'{native.codec_status()}')
    region_off = offset + meta_len
    region_off += (-region_off) % _ALIGN
    return codec.decode(frame, offset, meta_len, region_off)
  meta = view[offset:offset + meta_len]
  offset += meta_len
  (nbufs,) = struct.unpack_from('>I', view, offset)
  offset += 4
  sizes = struct.unpack_from(f'>{nbufs}Q', view, offset)
  offset += 8 * nbufs
  buffers = []
  for size in sizes:
    buffers.append(view[offset:offset + size])
    offset += size
  return pickle.loads(meta, buffers=buffers)


def _recv_exact(sock, amount):
  # recv_into a preallocated buffer: no per-chunk allocations or joins.
  buf = bytearray(amount)
  view = memoryview(buf)
  pos = 0
  while pos < amount:
    try:
      n = sock.recv_into(view[pos:], min(amount - pos, 1 << 22))
    except OSError as e:
      raise Disconnected(str(e))
    if not n:
      raise Disconnected('connection closed')
    pos += n
  return buf


def _shut(sock):
  """Wake whatever thread blocks on `sock`, then close it."""
  try:
    sock.shutdown(socket.SHUT_RDWR)
  except OSError:
    pass
  try:
    sock.close()
  except OSError:
    pass


def _parse_addr(addr):
  if isinstance(addr, int):
    return ('localhost', addr)
  host, _, port = str(addr).rpartition(':')
  return (host or 'localhost', int(port))


class Future:

  def __init__(self):
    self._event = threading.Event()
    self._value = None
    self._error = None

  def done(self):
    return self._event.is_set()

  def result(self, timeout=None):
    if not self._event.wait(timeout):
      raise TimeoutError('RPC result timed out')
    if self._error is not None:
      raise self._error
    return self._value

  def set_result(self, value):
    self._value = value
    self._event.set()

  def set_error(self, error):
    self._error = error
    self._event.set()


class Client:
  """RPC client; `client.method(*args)` returns a Future."""

  def __init__(self, addr, name='Client', maxinflight=16, autoconn=True,
               connect=False):
    self.addr = _parse_addr(addr)
    self.name = name
    self.maxinflight = maxinflight
    self.autoconn = autoconn
    self.sock = None
    self.sendlock = threading.Lock()
    self.futures = {}
    self.futlock = threading.Lock()
    self.inflight = threading.Semaphore(maxinflight)
    self.reqid = 0
    self.reader = None
    self.metrics = {'sent': 0, 'received': 0, 'errors': 0}
    self.closed = False
    if connect or autoconn:
      try:
        self.connect(timeout=None if connect else 0.1, retry=connect)
      except (Disconnected, OSError):
        if connect:
          raise

  def connect(self, timeout=60, retry=True):
    deadline = time.time() + timeout if timeout else None
    while True:
      if self.closed:
        raise Disconnected(f'{self.name} is closed')
      try:
        sock = socket.create_connection(self.addr, timeout=10)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        self.sock = sock
        self.reader = threading.Thread(
            target=self._reader, args=(sock,), daemon=True,
            name=f'{self.name}-reader')
        self.reader.start()
        return
      except OSError as e:
        if not retry or (deadline and time.time() > deadline):
          raise Disconnected(f'{self.name}: cannot connect to {self.addr}: '
                             f'{e}')
        time.sleep(0.2)

  def call(self, method, *args):
    if self.closed:
      raise Disconnected(f'{self.name} is closed')
    if self.sock is None:
      if self.autoconn:
        self.connect()
      else:
        raise Disconnected(f'{self.name} is not connected')
    self.inflight.acquire()
    sock = self.sock
    if self.closed or sock is None:  # while this call waited for a slot
      self.inflight.release()
      raise Disconnected(f'{self.name} is closed or disconnected')
    future = Future()
    with self.futlock:
      self.reqid += 1
      reqid = self.reqid
      self.futures[reqid] = future
    try:
      _send(sock, self.sendlock, (reqid, method, args))
      self.metrics['sent'] += 1
    except Disconnected:
      with self.futlock:
        self.futures.pop(reqid, None)
      self.inflight.release()
      self.sock = None
      raise
    return future

  def __getattr__(self, name):
    if name.startswith('_') or name in self.__dict__:
      raise AttributeError(name)
    return lambda *args: self.call(name, *args)

  def stats(self):
    return {
        'sent': self.metrics['sent'],
        'received': self.metrics['received'],
        'inflight': self.maxinflight - self.inflight._value,
    }

  def close(self):
    """Disconnect: pending futures fail with Disconnected, and the reader
    thread ends."""
    self.closed = True
    sock, reader = self.sock, self.reader
    self.sock = None
    if sock is not None:
      _shut(sock)
    if reader is not None and reader is not threading.current_thread():
      reader.join(_JOIN_S)
    self._fail_pending(f'{self.name} was closed')

  def _fail_pending(self, reason):
    with self.futlock:
      futures, self.futures = dict(self.futures), {}
    for future in futures.values():
      self.inflight.release()
      future.set_error(Disconnected(reason))

  def _reader(self, sock):
    try:
      while True:
        reqid, status, payload = _recv(sock)
        self.inflight.release()
        self.metrics['received'] += 1
        with self.futlock:
          future = self.futures.pop(reqid, None)
        if future is None:
          continue
        if status == 'ok':
          future.set_result(payload)
        else:
          self.metrics['errors'] += 1
          future.set_error(RuntimeError(payload))
    except Disconnected as e:
      if self.sock is sock:
        self.sock = None
      self._fail_pending(str(e))


class Server:
  """RPC server with per-method worker pools."""

  def __init__(self, addr, name='Server'):
    self.addr = _parse_addr(addr)
    self.name = name
    self.methods = {}
    self.queues = {}
    self.threads = []
    self.listener = None
    self.lsock = None
    self.running = False
    self.conns = set()
    self.metrics = {'requests': 0, 'errors': 0}

  def bind(self, method, fn, workers=1, batch=0, postfn=None):
    assert not self.running, 'bind() before start()'
    self.methods[method] = (fn, workers, batch, postfn)
    self.queues[method] = queue.Queue()

  def start(self, block=True):
    self.running = True
    self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    self.lsock.bind(self.addr)
    self.lsock.listen(128)
    self.listener = threading.Thread(
        target=self._accept, daemon=True, name=f'{self.name}-accept')
    self.listener.start()
    for method, (fn, workers, batch, postfn) in self.methods.items():
      q = self.queues[method]
      if batch:
        thread = threading.Thread(
            target=self._batch_worker, args=(method, fn, batch, postfn, q),
            daemon=True, name=f'{self.name}-{method}-batch')
        thread.start()
        self.threads.append(thread)
      else:
        for i in range(workers):
          thread = threading.Thread(
              target=self._worker, args=(method, fn, q), daemon=True,
              name=f'{self.name}-{method}-{i}')
          thread.start()
          self.threads.append(thread)
    if block:
      while self.running:
        time.sleep(0.2)

  def stats(self):
    return dict(self.metrics, conns=len(self.conns))

  def close(self):
    """Stop serving: close the listener and every connection, and join
    the accept, connection and worker threads (a worker finishes the call
    it is in)."""
    self.running = False
    if self.lsock:
      _shut(self.lsock)
    for conn, _ in list(self.conns):
      _shut(conn)
    current = threading.current_thread()
    if self.listener is not None and self.listener is not current:
      self.listener.join(_JOIN_S)  # no connection thread starts after it
    for thread in list(self.threads):
      if thread is not current:
        thread.join(_JOIN_S)

  def _accept(self):
    while self.running:
      try:
        conn, _ = self.lsock.accept()
      except OSError:
        return
      conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
      sendlock = threading.Lock()
      self.conns.add((conn, sendlock))
      if not self.running:  # close() may have missed this connection
        _shut(conn)
      reader = threading.Thread(
          target=self._reader, args=(conn, sendlock), daemon=True,
          name=f'{self.name}-conn')
      reader.start()
      self.threads.append(reader)

  def _reader(self, conn, sendlock):
    try:
      while True:
        reqid, method, args = _recv(conn)
        self.metrics['requests'] += 1
        q = self.queues.get(method)
        if q is None:
          _send(conn, sendlock, (reqid, 'err', f'no method {method}'))
          continue
        q.put((conn, sendlock, reqid, args))
    except Disconnected:
      self.conns.discard((conn, sendlock))
      _shut(conn)

  def _worker(self, method, fn, q):
    while self.running:
      try:
        item = q.get(timeout=0.2)
      except queue.Empty:
        continue
      conn, sendlock, reqid, args = item
      try:
        result = fn(*args)
        _send(conn, sendlock, (reqid, 'ok', result))
      except Disconnected:
        pass
      except Exception as e:
        self._failed(method)
        try:
          _send(conn, sendlock, (reqid, 'err', repr(e)))
        except Disconnected:
          pass

  def _failed(self, method):
    # The caller gets the error's repr; the server's log gets its trace.
    self.metrics['errors'] += 1
    print(f'[{self.name}] {method} failed:\n{traceback.format_exc()}',
          file=sys.stderr, flush=True)

  def _batch_worker(self, method, fn, batch, postfn, q):
    """Collect `batch` requests, call fn(stacked) -> (results, extra),
    scatter per-caller rows of `results`, then run postfn(extra)."""
    while self.running:
      items = []
      while len(items) < batch and self.running:
        try:
          items.append(q.get(timeout=0.2))
        except queue.Empty:
          continue
      if len(items) < batch:
        return
      arglists = [item[3] for item in items]
      nargs = len(arglists[0])
      stacked = []
      for j in range(nargs):
        values = [a[j] for a in arglists]
        if isinstance(values[0], dict):
          keys = values[0].keys()
          stacked.append({
              k: np.stack([np.asarray(v[k]) for v in values]) for k in keys})
        else:
          stacked.append(np.stack([np.asarray(v) for v in values]))
      try:
        out = fn(*stacked)
        results, extra = out if isinstance(out, tuple) else (out, None)
        for i, (conn, sendlock, reqid, _) in enumerate(items):
          row = {k: v[i] for k, v in results.items()}
          try:
            _send(conn, sendlock, (reqid, 'ok', row))
          except Disconnected:
            pass
        if postfn and extra is not None:
          postfn(extra)
      except Exception as e:
        self._failed(method)
        for conn, sendlock, reqid, _ in items:
          try:
            _send(conn, sendlock, (reqid, 'err', repr(e)))
          except Disconnected:
            pass


class BatchServer(Server):
  """Server whose bind() batches requests before invoking the work fn.

  bind(method, workfn, postfn, batch, workers): collects `batch` requests
  (typically one per env process), stacks their payloads along a new batch
  axis, calls workfn(batched_obs) -> (acts, trans), replies row i of acts
  to caller i, and forwards `trans` to postfn.
  """

  def bind(self, method, workfn, postfn=None, batch=1, workers=1):
    super().bind(method, workfn, workers=workers, batch=batch, postfn=postfn)
