"""Device layer: wraps a model (an nn.Module tree) into the Agent API.

The one-device part of embodied_tpu/parallel/agent.py: `init_policy`,
`policy`, `init_train`, `train`, `init_report`, `report`, `stream`, `save`
and `load`. Parameters live on one device, chosen at construction: 'cuda'
unless the caller asks for 'cpu', and construction raises when CUDA is
asked for and there is no card. `policy`, `train` and `report` take host
numpy arrays (or tensors, or the device batches of `stream`) and return
host numpy arrays and, for metrics, host floats (arrays, such as the
report's videos, as numpy); carries stay on the device. Each call samples
from a fresh generator seeded from (seed, call counter, kind), as the JAX
agent folds the counter into its key. The store (`save`/`load`) holds
parameters and state by flat JAX path: the optimizer's step and flat
moments, the normalizers, the slow value and its counter.

As in the JAX agent:
- the replay-context latents live on the device in a `LatentTable`
  (torch.latent_slots, on by default): the replay carries a 4-byte slot id
  and generation per step, the policy writes its latents into the table
  and the train step gathers the context from it and writes back the
  refreshed latents; `torch.latent_slots: 0` keeps the latents in the
  replay (the reference's host path);
- `train` fetches its outputs through a depth-k pipeline
  (torch.fetch_depth): each step's outputs start a non-blocking copy into
  pinned host memory, and call n returns step max(1, n - k)'s results, so
  the host queues the next steps while the card runs (depth 0, which the
  JAX agent lacks, returns each step's own results);
- `stream` prefetches batches to the device on a side CUDA stream.

`policy` and `train` may run on two threads that share the agent (the
actor and the learner of the parallel script): one lock serialises them,
and `policy` times its wait for it (timer section `policy_lock_wait`).

Meshes, the policy/train device split, shard_map mode and the grouped
multi-host save come with the multi-device part of distribution.
"""

import collections
import re
import threading
import weakref

import numpy as np
import torch

from .. import core as corelib
from .. import nn
from ..core import streams as streamlib
from ..utils import Space, timer
from . import latents as latentslib


def resolve_device(device):
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'No CUDA device is available. Pass device="cpu" to run on the CPU.')
  return device


def call_seed(seed, counter, salt=1_000_003):
  state = np.random.SeedSequence([int(seed), int(counter), salt])
  return int(state.generate_state(1, np.uint64)[0] & ((1 << 63) - 1))


class DeviceBatch(dict):
  """A batch already copied (or being copied) to the device by `stream`:
  `ready` is the CUDA event that the copies recorded on the copy stream,
  or None on the CPU."""

  ready = None


class Agent(corelib.Agent):

  def __init__(self, model, obs_space, act_space, config, device='cuda'):
    self.device = resolve_device(device)
    self.model = model
    self.obs_space = obs_space
    self.act_space = {k: v for k, v in act_space.items() if k != 'reset'}
    self.config = config
    tcfg = dict(config.torch)
    self.batch_size = config.batch_size
    self.batch_length = config.batch_length
    self.replay_context = config.replay_context
    self.seed = int(config.seed)
    self._counters = {'policy': 0, 'train': 0, 'report': 0}
    nn.init_params(model, self.seed)
    model.to(self.device)
    model.eval()
    total = sum(p.numel() for p in model.parameters())
    print(f'Initialized agent store: {len(nn.store(model))} entries, '
          f'{total:,} parameters on {self.device}')

    # Device-resident replay-latent table (see parallel/latents.py):
    # torch.latent_slots 0 = off (the latents ride the replay), -1 = cover
    # the replay capacity within torch.latent_budget_gb, > 0 = that many.
    self._latents = None
    self._latent_keys = tuple(getattr(model, 'latent_keys', ()) or ())
    self._latents_in_replay = bool(tcfg.get('latents_in_replay', False))
    slots = int(float(tcfg.get('latent_slots', 0)))
    if self._latent_keys and slots != 0:
      spaces = {k: model.ext_space[k] for k in self._latent_keys}
      capacity, eval_slots = latentslib.plan(
          spaces, slots, tcfg.get('latent_budget_gb', 4.0),
          float(getattr(config, 'replay_size', 1e6)),
          4 * self.batch_size * (self.batch_length + self.replay_context))
      self._latents = latentslib.LatentTable(
          spaces, capacity, self.device, eval_slots=eval_slots)
      print(f'Latent table: {self._latents.capacity:,} device-resident '
            f'slots ({self._latents.nbytes / (1 << 20):.0f} MB HBM)')

    # Depth of the train-output fetch pipeline (see train()).
    self._fetch_depth = max(0, int(tcfg.get('fetch_depth', 3)))
    self._pending_train = collections.deque()
    self._fetched_train = None
    # Batches of `stream` are copied on this stream, beside the compute.
    self._copy_stream = (torch.cuda.Stream(self.device)
                         if self.device.type == 'cuda' else None)
    # Serializes device use across the actor and learner threads of the
    # parallel script: train updates in place the weights policy reads.
    self._device_lock = threading.Lock()

  @property
  def ext_space(self):
    """Replay keys as the host sees them: with the latent table the latent
    columns are replaced by a slot id and its generation; under
    torch.latents_in_replay they ride the replay as well, as the fallback
    context where a generation no longer matches."""
    ext = dict(self.model.ext_space)
    if self._latents is not None:
      if not self._latents_in_replay:
        for key in self._latent_keys:
          ext.pop(key, None)
      ext['slot'] = Space(np.int32)
      ext['slotgen'] = Space(np.uint32)
    return ext

  def init_policy(self, batch_size):
    return self.model.init_policy(batch_size)

  def init_train(self, batch_size):
    return self.model.init_train(batch_size)

  def init_report(self, batch_size):
    return self.model.init_report(batch_size)

  def policy(self, carry, obs, mode='train'):
    obs = {k: self._to_device(v) for k, v in obs.items()
           if not k.startswith('log/')}
    # The lock covers a whole train step of another thread (its host
    # time, not only its dispatch): the actor's wait is timed per call.
    with timer.section('policy_lock_wait'):
      self._device_lock.acquire()
    try:
      carry = nn.core.tree_map(self._to_device, carry)
      self._counters['policy'] += 1
      gen = torch.Generator(self.device).manual_seed(
          call_seed(self.seed, self._counters['policy']))
      with torch.inference_mode():
        carry, act, out = self.model.policy(carry, obs, mode, gen)
        out = dict(out)
        if self._latents is not None:
          # Slots are allocated on the host; the packed latents go into
          # the table and only the slot ids come back.
          slots, gens = self._latents.alloc(
              len(obs['is_first']), 'eval' if mode == 'eval' else 'train')
          values = {k: out[k] if self._latents_in_replay else out.pop(k)
                    for k in self._latent_keys}
          self._latents.scatter(
              self._to_device(slots),
              self._to_device(latentslib.device_gens(gens)), values)
        act = {k: v.cpu().numpy() for k, v in act.items()}
        out = {k: v.cpu().numpy() for k, v in out.items()}
      if self._latents is not None:
        out['slot'], out['slotgen'] = slots, gens
    finally:
      self._device_lock.release()
    return carry, act, out

  def train(self, carry, data):
    """One train step on a (B, T + replay_context) batch. Returns (carry,
    outs, metrics) with the outputs and metrics of an earlier step (see
    below): outs['replay'] holds the refreshed packed latents and stepid
    as numpy where the latents ride the replay, metrics are host floats.

    The outputs come back through a depth-k pipeline (torch.fetch_depth):
    each step starts a non-blocking copy of its outputs into pinned host
    memory, and call n returns step max(1, n - k)'s results, so the host
    queues steps while the card runs. During warm-up the first step's
    results repeat (replay updates are keyed by stepid and idempotent).
    Depth 0 waits for each step's own results (the JAX agent's depths
    start at 1)."""
    with self._device_lock:
      data = self._take_batch(data)
      carry = nn.core.tree_map(self._to_device, carry)
      self._counters['train'] += 1
      use_table = self._latents is not None and 'slot' in data
      if use_table:
        data, slots, gens, valid = self.inject_latents(data)
      carry, outs, mets = self.model.train_step(
          carry, data, self._draws('train', 2_000_003))
      carry = nn.core.tree_map(lambda x: x.detach(), carry)
      outs, mets = dict(outs), dict(mets)
      if use_table:
        K = self.replay_context
        if self._latents_in_replay:
          upd = outs.get('replay')
        else:
          upd = outs.pop('replay', None)
        if upd is not None:
          self._latents.scatter(slots[:, K:], gens[:, K:], upd)
        mets['latents/valid'] = valid.float().mean()
      queue = self._pending_train
      queue.append(self._start_fetch(outs, mets))
      if len(queue) > self._fetch_depth:
        self._fetched_train = self._finish_fetch(queue.popleft())
      elif self._fetched_train is None:
        self._fetched_train = self._finish_fetch(queue[0])
      outs, mets = self._fetched_train
    return carry, outs, mets

  def inject_latents(self, data):
    """Pop slot and slotgen and gather the latents from the table into the
    data dict. Where the generation no longer matches, take the packed
    latents the batch carries (torch.latents_in_replay), else mark the
    window start as a first step so no stale context is grafted. Returns
    (data, slots, gens, valid)."""
    data = dict(data)
    slots = data.pop('slot')
    gens = latentslib.device_gens(data.pop('slotgen'))
    fresh = self._latents.gather(slots)
    valid = self._latents.valid(slots, gens)
    if self._latents_in_replay:
      for k in self._latent_keys:
        stored = data[k]
        mask = valid.reshape(valid.shape + (1,) * (stored.ndim - 2))
        data[k] = torch.where(mask, fresh[k], stored)
    else:
      data.update(fresh)
      K = self.replay_context
      if K:
        bad = (data['consec'][:, 0] == 0) & ~valid[:, K - 1]
        isf = data['is_first'].clone()
        isf[:, K] |= bad
        data['is_first'] = isf
    return data, slots, gens, valid

  def report(self, carry, data):
    """Metrics of a (B, T + replay_context) batch without updates (see
    Model.report): scalars as host floats, videos as uint8 numpy arrays."""
    with self._device_lock:
      data = self._take_batch(data)
      carry = nn.core.tree_map(self._to_device, carry)
      self._counters['report'] += 1
      if self._latents is not None and 'slot' in data:
        data = self.inject_latents(data)[0]
      carry, mets = self.model.report(
          carry, data, self._draws('report', 3_000_003))
      carry = nn.core.tree_map(lambda x: x.detach(), carry)
      return carry, self._fetch(mets)

  def stream(self, source):
    """Prefetches up to two batches of `source` to the device (see
    `_device_batch`). The run that made the stream closes it when it
    ends; the prefetch thread holds the agent weakly, so a stream left
    open does not keep the agent's device memory."""
    agent = weakref.ref(self)

    def transform(data):
      if agent() is None:
        raise RuntimeError('The agent of this stream is gone')
      return agent()._device_batch(data)
    return streamlib.Prefetch(source, transform=transform, amount=2)

  def _device_batch(self, data):
    """A host batch on its way to the device. On the card: each array goes
    into pinned host memory and then, without blocking, to the card on the
    agent's copy stream, and an event marks the copies' end; the call that
    takes the batch waits for that event on its own stream. On the CPU:
    the arrays as tensors."""
    data = {k: v for k, v in data.items() if not k.startswith('log/')}
    out = DeviceBatch()
    if self._copy_stream is None:
      out.update({k: self._to_device(v) for k, v in data.items()})
      return out
    with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
      for key, value in data.items():
        host = self._host_tensor(value)
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        out[key] = pinned.to(self.device, non_blocking=True)
      out.ready = torch.cuda.Event()
      out.ready.record(self._copy_stream)
    return out

  def _take_batch(self, data):
    """The batch's tensors on the device, ready for this thread's stream."""
    if isinstance(data, DeviceBatch):
      if data.ready is not None:
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(data.ready)
        for value in data.values():
          # The copy stream allocated these; keep the allocator from
          # handing their memory out again before this stream is done.
          value.record_stream(stream)
      return dict(data)
    return {k: self._to_device(v) for k, v in data.items()
            if not k.startswith('log/')}

  def _start_fetch(self, outs, mets):
    """Start the copies of one step's outputs to the host: the scalar
    metrics stacked into one tensor, every other tensor as it is; into
    pinned memory without blocking on the card. Returns what
    `_finish_fetch` reads."""
    # Host numbers stay on the host: a copy to the card would block.
    numbers = {k: float(v) for k, v in mets.items()
               if not isinstance(v, torch.Tensor)}
    mets = {k: v.detach() for k, v in mets.items() if k not in numbers}
    scalars = sorted(k for k, v in mets.items() if v.ndim == 0)
    tensors = {('mets', k): v for k, v in mets.items() if v.ndim}
    tensors.update({(key, k): v.detach() for key, value in outs.items()
                    for k, v in value.items()})
    if scalars:
      tensors[('scalars', None)] = torch.stack(
          [mets[k].float() for k in scalars])
    if self.device.type != 'cuda':
      return numbers, scalars, {k: v.clone() for k, v in tensors.items()}, None
    host = {}
    for key, value in tensors.items():
      host[key] = torch.empty(
          value.shape, dtype=value.dtype, pin_memory=True)
      host[key].copy_(value, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return numbers, scalars, host, event

  def _finish_fetch(self, pending):
    """Wait for one step's copies and return (outs, metrics) on the host."""
    numbers, scalars, host, event = pending
    if event is not None:
      event.synchronize()
    outs, mets = {}, dict(numbers)
    for (key, k), value in host.items():
      if key == 'scalars':
        mets.update(zip(scalars, value.tolist()))
      elif key == 'mets':
        mets[k] = value.numpy()
      else:
        outs.setdefault(key, {})[k] = value.numpy()
    return outs, mets

  def _draws(self, kind, salt):
    gen = torch.Generator(self.device).manual_seed(
        call_seed(self.seed, self._counters[kind], salt=salt))
    return nn.dists.Draws(gen, self.device)

  def _fetch(self, mets):
    """Device metrics to the host in one transfer for the scalars: floats,
    and numpy arrays for the rest."""
    mets = {k: torch.as_tensor(v, device=self.device).detach()
            for k, v in mets.items()}
    keys = sorted(k for k, v in mets.items() if v.ndim == 0)
    out = {k: v.cpu().numpy() for k, v in mets.items() if v.ndim}
    if keys:
      values = torch.stack([mets[k].float() for k in keys])
      out.update(zip(keys, values.cpu().tolist()))
    return out

  def _example_batch(self, batch_size, length, spaces=None):
    """Zeros of every replay key at (batch_size, length), as numpy; with
    the latent table, distinct slots."""
    if spaces is None:
      spaces = self.ext_space
    spaces = {**self.obs_space, **self.act_space, **spaces}
    data = {}
    for key, space in spaces.items():
      if key.startswith('log/'):
        continue
      shape = (batch_size, length, *space.shape)
      if key == 'slot' and self._latents is not None:
        idx = np.arange(batch_size * length, dtype=np.int64)
        data[key] = (idx % self._latents.capacity).astype(
            np.int32).reshape(shape)
      else:
        data[key] = np.zeros(shape, space.dtype)
    return data

  def _example_obs(self, batch_size):
    return {key: np.zeros((batch_size, *space.shape), space.dtype)
            for key, space in self.obs_space.items()
            if not key.startswith('log/')}

  @staticmethod
  def _host_tensor(value):
    if isinstance(value, torch.Tensor):
      return value
    value = np.ascontiguousarray(value)
    if value.dtype == np.uint32:  # slotgen: the same bits as int32
      value = value.view(np.int32)
    return torch.from_numpy(value)

  def _to_device(self, value):
    return self._host_tensor(value).to(self.device)

  def save(self):
    with self._device_lock:
      # Copies: on the CPU, .numpy() would share memory with live tensors.
      store = {k: v.detach().cpu().numpy().copy() for k, v in nn.store(
          self.model).items()}
      state = {'store': store, 'counters': dict(self._counters)}
      if self._latents is not None:
        # Only the slot allocator persists; the table's contents heal
        # themselves (invalid generations reset the carry until the first
        # revisit).
        state['latents'] = self._latents.save()
      return state

  def load(self, data, regex=None):
    """Load a store {path: array} by flat path, such as `save()` or
    `convert.from_jax` return: parameters and state. Without `regex` the
    store must hold every entry of the model, or this raises naming the
    first five it lacks; with `regex`, only the store's entries that match
    it load and the rest keep their values. Entries the port lacks are
    reported and ignored. A checkpoint without the latent allocator's
    state (made without the table) moves the allocator one generation up,
    so no restored (slot, slotgen) pair validates against a new one."""
    store = data['store']
    if regex:
      pattern = re.compile(regex)
      store = {k: v for k, v in store.items() if pattern.search(k)}
    missing = sorted(set(nn.store(self.model)) - set(store))
    if missing and not regex:
      raise KeyError(f'Checkpoint missing entries: {missing[:5]}')
    with self._device_lock:
      unused = nn.load_store(self.model, store, strict=False)
    if unused:
      print(f'Ignoring {len(unused)} unexpected checkpoint entries: '
            f'{unused[:5]}')
    self._counters.update(data.get('counters', {}))
    if self._latents is not None:
      if 'latents' in data:
        self._latents.load(data['latents'])
      else:
        self._latents.bump_generations()
