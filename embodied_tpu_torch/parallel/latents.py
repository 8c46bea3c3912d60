"""Device-resident replay-latent table.

The counterpart of embodied_tpu/parallel/latents.py. The packed
replay-context latents stay on the device in a ring table keyed by a
4-byte slot id; the replay stores only (slot, slotgen) per step. The
policy writes fresh latents into the table, and the train step gathers
the context latents and writes back the refreshed ones, in place on the
device, so the latents never cross between host and card.

Correctness under eviction and overwrite is by generation tags: every slot
write records its allocation generation, and a sampled step whose stored
generation no longer matches gathers an invalid latent; the train step
then resets the carry at the window start, as at an episode boundary.

The JAX table holds its generations as uint32 with the sentinel
0xFFFFFFFF. This table holds the same 32 bits as int32 (the sentinel
reads -1): the host-side allocator still hands out uint32 generations,
and `device_gens` views them as int32 for the card, so equality is bit
for bit the same.
"""

import numpy as np
import torch

GEN_INVALID = np.uint32(0xFFFFFFFF)


def torch_dtype(dtype):
  return torch.from_numpy(np.zeros(0, dtype)).dtype


def device_gens(gens):
  """Host uint32 generations as the int32 tensor with the same bits."""
  if isinstance(gens, torch.Tensor):
    return gens if gens.dtype == torch.int32 else gens.view(torch.int32)
  return torch.from_numpy(
      np.ascontiguousarray(gens, np.uint32).view(np.int32))


def plan(spaces, slots, budget_gb, replay_size, minimum):
  """(train capacity, eval slots) of the table, as the JAX Agent sizes it:
  `slots` > 0 asks for that many (at least `minimum`), -1 covers the
  replay within `budget_gb`; eval envs get their own region sized for the
  eval replay (a tenth of the replay)."""
  if slots > 0:
    capacity = max(slots, minimum)
    return capacity, max(minimum, capacity // 10)
  budget = float(budget_gb) * (1 << 30)
  eval_slots = max(minimum, int(replay_size) // 10)
  per = LatentTable.bytes_per_slot(spaces)
  capacity = max(minimum, min(int(replay_size),
                              int(budget // per) - eval_slots))
  return capacity, eval_slots


class LatentTable:
  """One device tensor per latent key plus `_gen`, and a host-side slot
  allocator. Slot ids are allocated round-robin per region. With `nprocs`
  > 1 processes every process owns a disjoint range of the `capacity`
  slot ids, as in the JAX table, whose capacity is a multiple of `nshard`
  (the mesh's ('d','f') size) times `nprocs`; a process's table holds its
  own range only (`offset` is its first slot id), since its replay holds
  only the slots that it allocated."""

  def __init__(self, spaces, capacity, device, nprocs=1, proc=0,
               eval_slots=0, nshard=1):
    assert spaces, 'LatentTable needs at least one latent key'
    self.spaces = dict(spaces)
    self.keys = tuple(self.spaces)
    self.device = torch.device(device)
    quantum = max(1, nshard * nprocs)
    capacity = int(-(-(int(capacity) + int(eval_slots)) // quantum) * quantum)
    self.capacity = capacity
    per = capacity // nprocs
    self.offset = proc * per
    # Eval-mode policy calls and eval-replay steps allocate from their own
    # region so they never churn the train ring.
    eval_span = min(per // 2, -(-int(eval_slots) // nprocs)) if eval_slots \
        else 0
    self.spans = {'train': per - eval_span}
    self.bases = {'train': proc * per}
    if eval_span:
      self.spans['eval'] = eval_span
      self.bases['eval'] = proc * per + (per - eval_span)
    self.counters = {k: 0 for k in self.spans}
    self.tables = {
        k: torch.zeros((per, *s.shape), dtype=torch_dtype(s.dtype),
                       device=self.device)
        for k, s in self.spaces.items()}
    self.tables['_gen'] = torch.full(
        (per,), -1, dtype=torch.int32, device=self.device)

  def reset(self):
    """Every generation tag back to the sentinel, the latents to zero and
    the allocator counters to zero."""
    for key, table in self.tables.items():
      table.fill_(-1 if key == '_gen' else 0)
    self.counters = {k: 0 for k in self.counters}

  @property
  def nbytes(self):
    return sum(v.numel() * v.element_size() for v in self.tables.values())

  @staticmethod
  def bytes_per_slot(spaces):
    return 4 + sum(
        int(np.prod(s.shape)) * np.dtype(s.dtype).itemsize
        for s in spaces.values())

  @property
  def counter(self):
    return self.counters['train']

  @property
  def span(self):
    return self.spans['train']

  def alloc(self, n, region='train'):
    """Allocate n slots; returns (slots int32, gens uint32) numpy arrays."""
    if region not in self.spans:
      region = 'train'
    span = self.spans[region]
    idx = self.counters[region] + np.arange(n, dtype=np.int64)
    self.counters[region] += n
    slots = (self.bases[region] + idx % span).astype(np.int32)
    # Generations cycle below GEN_INVALID so an allocated tag can never
    # equal the table's never-written sentinel.
    gens = ((idx // span) % int(GEN_INVALID)).astype(np.uint32)
    return slots, gens

  def bump_generations(self):
    """Advance every region's allocator to the next generation boundary.

    Called when the agent state was restored without allocator state (a
    pre-table checkpoint): restored replay may hold (slot, gen) pairs from
    the previous run, and fresh allocations restarting at gen 0 would mint
    identical pairs. Starting one generation up makes every restored pair
    mismatch until its first refresh."""
    for region, span in self.spans.items():
      self.counters[region] = (self.counters[region] // span + 1) * span

  def save(self):
    return {'counters': dict(self.counters)}

  def load(self, state):
    if 'counters' in state:
      for k, v in state['counters'].items():
        if k in self.counters:
          self.counters[k] = int(v)
    else:  # Old single-counter checkpoints.
      self.counters['train'] = int(state.get('counter', 0))

  # --- Tensor helpers on the table ----------------------------------------

  def _rows(self, slots):
    return slots.reshape(-1).long() - self.offset

  def gather(self, slots):
    """The latents at integer slots of any batch shape."""
    flat = self._rows(slots)
    return {k: self.tables[k].index_select(0, flat).reshape(
        (*slots.shape, *self.tables[k].shape[1:])) for k in self.keys}

  def valid(self, slots, gens):
    """Whether each slot still holds the generation `gens` (int32 bits)."""
    flat = self._rows(slots)
    return (self.tables['_gen'].index_select(0, flat) ==
            gens.reshape(-1)).reshape(slots.shape)

  @torch.no_grad()
  def scatter(self, slots, gens, values):
    """Write latents and generations in place. Where two positions share a
    slot, either written value may land (as in the JAX table)."""
    flat = self._rows(slots)
    for k in self.keys:
      v = values[k].reshape((-1, *self.tables[k].shape[1:]))
      self.tables[k].index_copy_(0, flat, v.to(self.tables[k].dtype))
    self.tables['_gen'].index_copy_(0, flat, gens.reshape(-1))
