"""The guards behind two of `parallel.setup`'s knobs: the sync guard
(`transfer_guard`) and the NaN check (`debug`).

The sync guard is the counterpart of JAX's transfer guard, under which an
implicit host<->device transfer raises. In torch every transfer is
explicit by API; the implicit crossings are the host waits hidden in
`float(t)`, `t.item()`, `bool(t)`, `t.tolist()` or a blocking `.cpu()`
of a CUDA tensor. `torch.cuda.set_sync_debug_mode('error')` makes those
raise. The Agent holds a `guarded()` scope around the bodies of `train`,
`policy` and `report`, and an `allowed()` scope around each crossing that
the JAX package makes through an explicit transfer (the policy's outputs,
the train step's fetch pipeline, `save`, and the parallel script's carry
cache, run/parallel_impl.py). The mode is process-wide, not
per thread, while the actor and learner threads of `script=parallel` and
the prefetch thread of `Agent.stream` share one process: so the scopes
count their holders under a lock. The mode is 'error' while some thread
holds a guarded scope and no thread an allowed one, and otherwise what it
was before the first guarded scope began. Code outside the Agent's calls
(a test's or a script's own `.item()`) runs under that earlier mode. A
copy that another thread makes while the guard is up does not wait for
the card (`Agent._to_device` copies from pinned memory without blocking),
so no scope is widened to hide it.

The NaN check is the counterpart of JAX's `jax_debug_nans`: a dispatch
mode, held inside the Agent's `train`, `policy` and `report` under
`debug`, that raises on the first op whose floating output is not finite,
naming the op. A custom kernel's outputs are written by the kernel, not
by an op the mode sees; the next op that reads them is checked.
"""

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class SyncGuard:
  """The process's sync debug mode, held at 'error' while some thread is
  inside a `guarded()` scope and no thread is inside an `allowed()` one
  (see the module note). Scopes nest and may overlap across threads."""

  def __init__(self):
    self._lock = threading.Lock()
    self._guards = 0
    self._allows = 0
    self._outer = None  # The mode before the guard went up, while it is.

  @contextlib.contextmanager
  def guarded(self):
    """Host waits raise inside (unless an `allowed()` scope is held)."""
    with self._lock:
      self._guards += 1
      self._apply()
    try:
      yield
    finally:
      with self._lock:
        self._guards -= 1
        self._apply()

  @contextlib.contextmanager
  def allowed(self):
    """An explicit crossing: host waits run under the earlier mode."""
    with self._lock:
      self._allows += 1
      self._apply()
    try:
      yield
    finally:
      with self._lock:
        self._allows -= 1
        self._apply()

  @property
  def raising(self):
    """Whether host waits raise now."""
    return self._outer is not None

  def _apply(self):
    want = self._guards > 0 and self._allows == 0
    if want and self._outer is None:
      self._outer = torch.cuda.get_sync_debug_mode()
      torch.cuda.set_sync_debug_mode('error')
    elif not want and self._outer is not None:
      torch.cuda.set_sync_debug_mode(self._outer)
      self._outer = None


# What the process's first parallel.setup call set.
KNOBS = dict(debug=False, deterministic=False, transfer_guard=False)
SYNCS = SyncGuard()  # The process's one sync debug mode.

# Ops whose outputs hold whatever memory they were given.
_UNINITIALISED = frozenset((
    'empty', 'empty_like', 'empty_strided', 'new_empty',
    'new_empty_strided', 'empty_permuted'))


class NanCheck(TorchDispatchMode):
  """Raises FloatingPointError on the first op whose floating output holds
  a NaN or an infinity, naming the op (each check waits for the device)."""

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    if func._overloadpacket.__name__ in _UNINITIALISED:
      return out
    for value in tree_leaves(out):
      if (isinstance(value, torch.Tensor) and value.is_floating_point()
          and value.device.type != 'meta' and value.numel()
          and not bool(torch.isfinite(value).all())):
        raise FloatingPointError(
            f'{func} gave a non-finite value (debug: the first such op)')
    return out
