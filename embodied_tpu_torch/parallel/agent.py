"""Device layer: wraps a model (an nn.Module tree) into the Agent API.

The counterpart of embodied_tpu/parallel/agent.py: `init_policy`,
`policy`, `init_train`, `train`, `init_report`, `report`, `stream`, `save`
and `load`. Parameters live on the rank's device, chosen at construction:
'cuda' unless the caller asks for 'cpu', and construction raises when
CUDA is asked for and there is no card. `policy`, `train` and `report` take host
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

Diagnostics, as in the JAX agent:
- the knobs of `parallel.setup` (parallel/guard.py): under
  `transfer_guard` (the default) a host wait inside `train`, `policy` or
  `report` on the card raises, except in the explicit crossings (the
  policy's outputs, the fetch pipeline, `save`); under `debug` the first
  op of those calls whose output is not finite raises;
- `train_cost()` counts the products of one train step on a meta copy
  (parallel/flops.py), and `torch.precompile` prints it at construction;
- `torch.profiler` turns on the profiler window: train updates 100 to 119
  are traced into `<logdir>/profile/*.pt.trace.json.gz` (read it with
  `python -m embodied_tpu_torch.viewer <logdir> --serve PORT`, page
  `/trace`); each train step runs in the profiler range `train#<step>`
  and each kernel launch in one named after its wrapper.

On a process group (parallel.setup) every rank is one process with its
own agent, laid out on the ('d','f','t') mesh of `torch.mesh`
(parallel/meshes.py):
- each rank feeds its own rows; the global batch `batch_size` is the
  config's times the number of data indices, ('d','f'): as in the JAX
  agent, whose processes each hold their 't' replicas. The agent splits
  no batch: where JAX replicates a batch that does not divide over the
  data axes (the policy's env rows), each rank here acts on its own;
- a train step averages the gradients (one flat all-reduce in the
  optimizer), the normalizers' statistics and the scalar metrics over the
  data group, and folds the rank's data index into its draws; ranks along
  't' train on the rows of their data index's first rank, which the step
  broadcasts to them;
- every rank holds the whole store, starts from rank 0's and keeps it in
  step through the reduced gradients; `shardings` holds the placements
  that the model's `partition_rules` give on the mesh. `torch.shardmap`
  makes every placement replicated (`use_shardmap`, as the JAX shard_map
  mode); with a replicated store the two modes run the same reduction,
  and they differ only once the store is sharded;
- policy and report calls take the rank's rows alone, with no collective,
  so that the run loop may call them on each rank's own clock;
- `torch.policy_mesh` (the policy/train split) gives the policy its own
  copy of the `policy_keys` parameters on the rank's device: each train
  step marks it dirty and the next policy call refreshes it; the device
  lock stays. The latent table is off under the split and under shardmap,
  as in the JAX agent; on a mesh each process's table holds the slot
  range that it allocates from.
"""

import collections
import contextlib
import copy
import gzip
import os
import re
import shutil
import socket
import tempfile
import threading
import time
import weakref

import numpy as np
import torch
import torch.distributed as dist

from .. import core as corelib
from .. import nn
from ..core import streams as streamlib
from ..utils import Path, Space, timer
from . import flops as flopslib
from . import guard as guardlib
from . import latents as latentslib
from . import meshes


def resolve_device(device):
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'No CUDA device is available. Pass device="cpu" to run on the CPU.')
  return device


def call_seed(seed, counter, salt=1_000_003, index=None):
  """A generator seed from (seed, call counter, salt) and, where given, a
  rank's index."""
  entropy = [int(seed), int(counter), salt]
  if index is not None:
    entropy.append(int(index))
  state = np.random.SeedSequence(entropy)
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

    # Multi-process: every rank feeds config.batch_size rows, and the
    # global batch holds those of each data index (agent.py:55-68 of the
    # JAX package, whose processes hold the 't' replicas' devices).
    self.nprocs = meshes.world_size()
    self.rank = dist.get_rank() if dist.is_initialized() else 0
    self.mesh = meshes.make_mesh(tcfg.get('mesh', '-1,1,1'))
    self.data_group = meshes.data_group(self.mesh)
    if dist.is_initialized() and self.data_group is None:
      raise ValueError(f'Rank {self.rank} lies outside the mesh '
                       f'{self.mesh.sizes} of torch.mesh')
    self.nbatch = self.mesh.nbatch
    if self.nprocs > 1:
      self.batch_size = self.batch_size * self.nbatch
      print(f'Global batch size: {self.batch_size} ({self.nprocs} ranks, '
            f'mesh {self.mesh.sizes})')
    if self.batch_size % self.nbatch:
      raise ValueError(f'Batch size {self.batch_size} does not divide over '
                       f"the mesh {self.mesh.sizes}'s ('d','f') axes")
    policy_mesh = str(tcfg.get('policy_mesh', '') or '')
    # The split's sizes; the policy runs on each rank's own device.
    self.policy_mesh = meshes.mesh_sizes(policy_mesh) if policy_mesh else None
    self.use_shardmap = bool(tcfg.get('shardmap', False)) and (
        self.mesh.size > 1)

    nn.init_params(model, self.seed)
    model.to(self.device)
    model.eval()
    total = sum(p.numel() for p in model.parameters())
    print(f'Initialized agent store: {len(nn.store(model))} entries, '
          f'{total:,} parameters on {self.device}')
    rules = [] if self.use_shardmap else getattr(
        model, 'partition_rules', [])
    self.shardings = meshes.resolve_rules(
        {k: v.shape for k, v in nn.store(model).items()}, rules, self.mesh)
    self._sync_store()
    self._policy_copy = None
    if self.policy_mesh is not None:
      self._make_policy_copy()

    # Device-resident replay-latent table (see parallel/latents.py):
    # torch.latent_slots 0 = off (the latents ride the replay), -1 = cover
    # the replay capacity within torch.latent_budget_gb, > 0 = that many.
    self._latents = None
    self._latent_keys = tuple(getattr(model, 'latent_keys', ()) or ())
    self._latents_in_replay = bool(tcfg.get('latents_in_replay', False))
    slots = int(float(tcfg.get('latent_slots', 0)))
    if (self._latent_keys and slots != 0 and self.policy_mesh is None
        and not self.use_shardmap):
      spaces = {k: model.ext_space[k] for k in self._latent_keys}
      capacity, eval_slots = latentslib.plan(
          spaces, slots, tcfg.get('latent_budget_gb', 4.0),
          float(getattr(config, 'replay_size', 1e6)),
          4 * self.batch_size * (self.batch_length + self.replay_context))
      self._latents = latentslib.LatentTable(
          spaces, capacity, self.device, self.nprocs, self.rank,
          eval_slots=eval_slots, nshard=self.nbatch)
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

    # The knobs of parallel.setup: the sync guard on the card, the NaN
    # check under debug (parallel/guard.py).
    knobs = guardlib.KNOBS
    self._syncs = guardlib.SYNCS if (
        knobs['transfer_guard'] and self.device.type == 'cuda') else None
    self._nan_check = knobs['debug']
    # Built-in profiler window: traces train updates [start, stop) into
    # logdir/profile (agent.py:131-136 of the JAX package).
    self._profiler = dict(
        enabled=bool(tcfg.get('profiler', False)), start=100, stop=120,
        active=False, outdir=str(config.logdir) + '/profile')
    self._trace = None
    if tcfg.get('precompile', False):
      self._precompile()

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
    """The carry of `batch_size` rows, the per-process batch that the
    caller feeds: the rank's rows (JAX's carry spans the global batch as
    one sharded array)."""
    return self.model.init_train(batch_size)

  def init_report(self, batch_size):
    """As init_train: the rank's rows."""
    return self.model.init_report(batch_size)

  def train_cost(self):
    """{'flops': F}, the products of one train step, forward and backward,
    at the rows this process feeds (config.batch_size: the whole batch on
    one process) and batch_length + replay_context steps. They are counted
    on a meta copy of the model (parallel/flops.py): the plain path's
    products whatever runs the step (`kernel: auto` and `off` give one
    number), alike on the CPU and on the card, and the agent is left as
    it was (store, optimizer state, normalizers, counters and so the
    draws, the latent table and the fetch queue). The batch carries its
    latents (the host path): the table's gather and scatter do no
    products. F counts products only (2 M N K a product), where XLA's
    cost analysis of the JAX step also counts elementwise ops and, on the
    TPU, counts a Pallas call as zero. JAX's 'bytes accessed' has no
    counterpart here."""
    rows = self.config.batch_size
    length = self.batch_length + self.replay_context
    data = self._example_batch(rows, length, spaces=self.model.ext_space)
    data = {k: flopslib.to_meta(self._host_tensor(v))
            for k, v in data.items()}
    model = flopslib.meta_copy(self.model)
    carry = model.init_train(rows)
    with flopslib.FlopCounter() as counter:
      model.train_step(carry, data, nn.dists.Draws(None, flopslib.META))
    return {'flops': counter.flops}

  def _precompile(self):
    """Print the train step's FLOPs (torch.precompile; JAX's AOT compile
    of the train step, which the eager port does not need)."""
    with timer.section('precompile_train'):
      flops = self.train_cost()['flops']
    print(f'Train step FLOPs: {flops:.3e}')

  # --- The policy/train split ---------------------------------------------

  def _make_policy_copy(self):
    """A copy of the model that owns copies of the `policy_keys`
    parameters and buffers and shares every other tensor."""
    pattern = re.compile(self.model.policy_keys)
    tensors = dict(self.model.named_parameters())
    tensors.update(self.model.named_buffers())
    copied = {k for k in tensors if pattern.search(k.replace('.', '/'))}
    memo = {id(v): v for k, v in tensors.items() if k not in copied}
    self._policy_copy = copy.deepcopy(self.model, memo)
    mine = dict(self._policy_copy.named_parameters())
    mine.update(self._policy_copy.named_buffers())
    self._policy_pairs = [(tensors[k], mine[k]) for k in sorted(copied)]
    self._policy_dirty = False

  @property
  def policy_copy_bytes(self):
    """Bytes of the split's policy parameters (0 without the split)."""
    if self._policy_copy is None:
      return 0
    return sum(d.numel() * d.element_size() for _, d in self._policy_pairs)

  @torch.no_grad()
  def _policy_model(self):
    """The model the policy runs: the split's copy, refreshed from the
    trained parameters if a train step changed them since."""
    if self._policy_copy is None:
      return self.model
    if self._policy_dirty:
      for src, dst in self._policy_pairs:
        dst.copy_(src)
      self._policy_dirty = False
    return self._policy_copy

  def policy(self, carry, obs, mode='train'):
    obs = {k: self._to_device(v) for k, v in obs.items()
           if not k.startswith('log/')}
    # The lock covers a whole train step of another thread (its host
    # time, not only its dispatch): the actor's wait is timed per call.
    with timer.section('policy_lock_wait'):
      self._device_lock.acquire()
    try:
      with self._checked():
        carry = nn.core.tree_map(self._to_device, carry)
        self._counters['policy'] += 1
        # Each process acts on its own envs with its own noise.
        gen = torch.Generator(self.device).manual_seed(call_seed(
            self.seed, self._counters['policy'],
            index=self.rank if self.nprocs > 1 else None))
        model = self._policy_model()
        with torch.inference_mode():
          carry, act, out = model.policy(carry, obs, mode, gen)
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
          with self._allowed():
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
    start at 1).

    On a mesh, `data` holds the rank's rows and the step reduces over the
    data group (see the module's docstring); a rank along 't' trains on
    the rows of its data index's first rank and returns no replay
    updates, since its own replay did not give them."""
    with self._device_lock, self._checked():
      data = self._take_batch(data)
      carry = nn.core.tree_map(self._to_device, carry)
      self._counters['train'] += 1
      step = self._counters['train']
      self._maybe_profile(step)
      use_table = self._latents is not None and 'slot' in data
      with torch.profiler.record_function(f'train#{step}'):
        if use_table:
          data, slots, gens, valid = self.inject_latents(data)
          data['latents/valid'] = valid
        replica = self._replicate(data)
        if use_table:
          valid = data.pop('latents/valid')
        with nn.opt.reduce_over(self.data_group):
          carry, outs, mets = self.model.train_step(
              carry, data, self._draws('train', 2_000_003))
          carry = nn.core.tree_map(lambda x: x.detach(), carry)
          outs, mets = dict(outs), dict(mets)
          if use_table:
            mets['latents/valid'] = valid.float().mean()
          mets = self._group_mean_scalars(mets)
        if replica:
          outs.pop('replay', None)
        elif use_table:
          K = self.replay_context
          if self._latents_in_replay:
            upd = outs.get('replay')
          else:
            upd = outs.pop('replay', None)
          if upd is not None:
            self._latents.scatter(slots[:, K:], gens[:, K:], upd)
      if self._policy_copy is not None:
        self._policy_dirty = True
      queue = self._pending_train
      with self._allowed():
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

  def _replicate(self, data):
    """Where t > 1: the tensors of `data` replaced in place by those of
    the first rank along 't' that shares this rank's data index. Returns
    whether this rank is such a replica (not the first)."""
    group = self.mesh.replica_group
    if group is None:
      return False
    members = dist.get_process_group_ranks(group)
    for key in sorted(data):
      value = data[key].contiguous()
      dist.broadcast(value, members[0], group=group)
      data[key] = value
    return self.rank != members[0]

  def _group_mean_scalars(self, mets):
    """The scalar tensor metrics averaged over the data group in one
    all-reduce (agent.py:322-327 of the JAX package)."""
    keys = sorted(k for k, v in mets.items()
                  if isinstance(v, torch.Tensor) and v.ndim == 0)
    if self.data_group is None or not keys:
      return mets
    values = nn.opt.group_mean(torch.stack(
        [mets[k].detach().float() for k in keys]))
    return {**mets, **dict(zip(keys, values.unbind(0)))}

  def report(self, carry, data):
    """Metrics of a (B, T + replay_context) batch without updates (see
    Model.report): scalars as host floats, videos as uint8 numpy arrays.
    On a mesh, the rank's own rows' metrics."""
    with self._device_lock, self._checked():
      data = self._take_batch(data)
      carry = nn.core.tree_map(self._to_device, carry)
      self._counters['report'] += 1
      if self._latents is not None and 'slot' in data:
        data = self.inject_latents(data)[0]
      carry, mets = self.model.report(
          carry, data, self._draws('report', 3_000_003))
      carry = nn.core.tree_map(lambda x: x.detach(), carry)
      with self._allowed():
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
    """The call's noise; on a mesh of more than one data index, the
    rank's data index folds into the seed, so each rank draws its own
    (the JAX shard_map step's fold_in of the axis index)."""
    index = self.mesh.data_index if self.nbatch > 1 else None
    gen = torch.Generator(self.device).manual_seed(
        call_seed(self.seed, self._counters[kind], salt, index))
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
        # Slots of this process's range (all of them on one process).
        table = self._latents
        idx = np.arange(batch_size * length, dtype=np.int64)
        data[key] = (table.offset + idx % len(table.tables['_gen'])).astype(
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
    """`value` on the agent's device. Host data goes to the card through
    pinned memory without blocking: the copy makes no host wait, so none
    that the sync guard of another thread's call would flag."""
    value = self._host_tensor(value)
    if self.device.type != 'cuda' or value.device.type != 'cpu':
      return value.to(self.device)
    return value.pin_memory().to(self.device, non_blocking=True)

  @contextlib.contextmanager
  def _checked(self):
    """The body of a `train`, `policy` or `report` call: under the sync
    guard and, under debug, the NaN check (see parallel/guard.py)."""
    with contextlib.ExitStack() as stack:
      if self._syncs is not None:
        stack.enter_context(self._syncs.guarded())
      if self._nan_check:
        stack.enter_context(guardlib.NanCheck())
      yield

  def _allowed(self):
    """An explicit crossing between host and card, where host waits run
    under the mode from before the guard."""
    if self._syncs is None:
      return contextlib.nullcontext()
    return self._syncs.allowed()

  def _maybe_profile(self, update):
    """The profiler window (agent.py:691-722 of the JAX package): at
    train update `start` a torch.profiler trace begins (CPU and CUDA
    activities on the card, the CPU's alone on the CPU), at `stop` it ends
    and goes to `outdir` as a Chrome trace, `*.pt.trace.json.gz`. A
    remote logdir gets the trace written to the temporary directory and
    copied through Path."""
    prof = self._profiler
    if not prof['enabled']:
      return
    outdir, copyto = prof['outdir'], None
    if str(outdir).startswith(('gs://', '/gcs/', '/cns/')):
      copyto, outdir = outdir, os.path.join(tempfile.gettempdir(), 'profiler')
    if update == prof['start'] and not prof['active']:
      print(f'Writing profiler trace to {outdir}')
      activities = [torch.profiler.ProfilerActivity.CPU]
      if self.device.type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
      self._trace = torch.profiler.profile(activities=activities)
      self._trace.start()
      prof['active'] = True
    elif update >= prof['stop'] and prof['active']:
      if self.device.type == 'cuda':
        with self._allowed():  # The traced steps' kernels end first.
          torch.cuda.synchronize(self.device)
      self._trace.stop()
      prof['active'] = False
      os.makedirs(outdir, exist_ok=True)
      name = (f'{socket.gethostname()}_{os.getpid()}.'
              f'{time.time_ns() // 1_000_000}.pt.trace.json.gz')
      # Gzip at its fastest level: torch's own export compresses at the
      # slowest, several times longer for some 30% fewer bytes.
      with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, 'trace.json')
        self._trace.export_chrome_trace(raw)
        with open(raw, 'rb') as src, gzip.open(
            os.path.join(outdir, name), 'wb', compresslevel=1) as dst:
          shutil.copyfileobj(src, dst)
      self._trace = None
      if copyto:
        for dirpath, _, files in os.walk(outdir):
          for fname in files:
            full = os.path.join(dirpath, fname)
            target = Path(copyto)
            for part in os.path.relpath(full, outdir).split(os.sep):
              target = target / part
            target.parent.mkdir()
            target.write_bytes(Path(full).read_bytes())
        print(f'Copied profiler trace {outdir} to {copyto}')

  def save(self, chunk_bytes=1 << 30):
    """The state {'store', 'counters'[, 'latents']} on the host. The store
    comes to the host in groups of at most `chunk_bytes` (or one larger
    entry), each packed into one device buffer and copied in one transfer,
    so a save never needs much more device memory than the model (JAX's
    grouped gather, agent.py:724-755). Every rank holds the same store,
    so every rank returns the same state."""
    with timer.section('agent_save'), self._device_lock, self._allowed():
      store = nn.store(self.model)
      result, group, size = {}, [], 0
      for key in sorted(store) + [None]:
        nbytes = 0 if key is None else (
            store[key].numel() * store[key].element_size())
        if group and (key is None or size + nbytes > chunk_bytes):
          result.update(_to_host({k: store[k] for k in group}))
          group, size = [], 0
        if key is not None:
          group.append(key)
          size += nbytes
      state = {'store': result, 'counters': dict(self._counters)}
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
    so no restored (slot, slotgen) pair validates against a new one. On
    a process group every rank calls `load`, and every rank ends with
    rank 0's store."""
    store = data['store']
    if regex:
      pattern = re.compile(regex)
      store = {k: v for k, v in store.items() if pattern.search(k)}
    missing = sorted(set(nn.store(self.model)) - set(store))
    if missing and not regex:
      raise KeyError(f'Checkpoint missing entries: {missing[:5]}')
    with self._device_lock:
      unused = nn.load_store(self.model, store, strict=False)
      self._sync_store()
      if self._policy_copy is not None:
        self._policy_dirty = True
    if unused:
      print(f'Ignoring {len(unused)} unexpected checkpoint entries: '
            f'{unused[:5]}')
    self._counters.update(data.get('counters', {}))
    if self._latents is not None:
      if 'latents' in data:
        self._latents.load(data['latents'])
      else:
        self._latents.bump_generations()

  @torch.no_grad()
  def _sync_store(self):
    """Every rank takes rank 0's store (on more than one process)."""
    if self.nprocs > 1:
      for _, value in sorted(nn.store(self.model).items()):
        dist.broadcast(value, 0)


def _to_host(tensors):
  """{key: numpy array} of device tensors, through one packed buffer: the
  tensors' bytes concatenated on the device and copied to the host at
  once."""
  tensors = {k: v.detach().contiguous() for k, v in tensors.items()}
  packed = torch.cat([v.reshape(-1).view(torch.uint8)
                      for v in tensors.values()]).cpu().numpy()
  out, offset = {}, 0
  for key, value in tensors.items():
    nbytes = value.numel() * value.element_size()
    dtype = torch.empty(0, dtype=value.dtype).numpy().dtype
    out[key] = packed[offset:offset + nbytes].view(dtype).reshape(
        tuple(value.shape))
    offset += nbytes
  return out
