"""Ring attention: attention over a sequence split across the ranks of a
process group.

Counterpart of embodied_tpu/ops/ring_attention.py, where the sequence is
sharded over a mesh axis under shard_map and key and value blocks rotate
with jax.lax.ppermute. Here each rank of a torch.distributed group holds
its T_local slice of the sequence, and each rotation is a
dist.batch_isend_irecv shift to the next rank (group order), whose
backward shifts the gradient back. Every rank accumulates its queries'
attention with a flash-style online softmax in float32, in the JAX block
order (its own block first), with the same -1e30 causal bias and 1e-30
floor on the normalizer, so the (T, T) score matrix never exists and
memory per rank stays O(T_local). Plain products: no kernel.

Gloo's point-to-point calls take CPU tensors only, so the ring runs on
gloo on the CPU and on NCCL across cards.

  ring_attention(q, k, v, group, causal)   the rank's (B, T_local, H, D)
  ring_attention_sharded(q, k, v, group, causal)
                                           global (B, T, H, D) split on T
  full_attention(q, k, v, causal)          the dense reference
"""

import torch
import torch.distributed as dist

f32 = torch.float32


def _peer(group, offset):
  """The global rank `offset` places after this one in `group`."""
  size = dist.get_world_size(group)
  peer = (dist.get_rank(group) + offset) % size
  return peer if group is None else dist.get_global_rank(group, peer)


def _shift(x, group, offset):
  """Send `x` to the rank `offset` after this one and return what the rank
  `offset` before it sent."""
  x = x.contiguous()
  out = torch.empty_like(x)
  ops = [dist.P2POp(dist.isend, x, _peer(group, offset), group),
         dist.P2POp(dist.irecv, out, _peer(group, -offset), group)]
  for request in dist.batch_isend_irecv(ops):
    request.wait()
  return out


class _Rotate(torch.autograd.Function):
  """One ring step forward; the gradient goes one step back."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return _shift(x, group, 1)

  @staticmethod
  def backward(ctx, grad):
    return _shift(grad, ctx.group, -1), None


class _Gather(torch.autograd.Function):
  """Every rank's (B, T_local, ...) concatenated along T in rank order.
  Every rank computes the same function of the result, so the gradient of
  the rank's block is its slice of the result's gradient."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group)
    return torch.cat(parts, 1)

  @staticmethod
  def backward(ctx, grad):
    n = dist.get_world_size(ctx.group)
    return grad.chunk(n, 1)[dist.get_rank(ctx.group)].contiguous(), None


def _block_attn(q, k, v, bias):
  """Scores and value sum of one (query block, key block) pair: scores in
  float32 (bf16 products are exact there), the value product in v's
  dtype. q: (B, Tq, H, D), k and v: (B, Tk, H, D), bias: (Tq, Tk)."""
  scale = q.shape[-1] ** -0.5
  scores = torch.einsum('bqhd,bkhd->bhqk', q.to(f32), k.to(f32))
  scores = scores * scale + bias
  m = scores.amax(-1)                                   # (B, H, Tq)
  p = torch.exp(scores - m[..., None])
  l = p.sum(-1)                                         # (B, H, Tq)
  o = torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype), v)
  return m, l, o.to(f32)


def ring_attention(q, k, v, group=None, causal=False):
  """Attention of the rank's queries over the whole sequence of `group`.
  q, k, v: (B, T_local, H, D), this rank's block of the sequence (blocks in
  rank order). Returns (B, T_local, H, D) in q's dtype."""
  n = dist.get_world_size(group)
  idx = dist.get_rank(group)
  B, Tl, H, D = q.shape
  pos = torch.arange(Tl, device=q.device)

  def bias_for(kblock):
    if not causal:
      return torch.zeros((Tl, Tl), dtype=f32, device=q.device)
    qpos = idx * Tl + pos[:, None]
    kpos = kblock * Tl + pos[None, :]
    return torch.where(qpos >= kpos, 0.0, -1e30).to(f32)

  m = torch.full((B, H, Tl), -torch.inf, dtype=f32, device=q.device)
  l = torch.zeros((B, H, Tl), dtype=f32, device=q.device)
  o = torch.zeros((B, Tl, H, D), dtype=f32, device=q.device)
  for r in range(n):
    kblock = (idx - r) % n  # The global block this rank's k and v hold now.
    bm, bl, bo = _block_attn(q, k, v, bias_for(kblock))
    new_m = torch.maximum(m, bm)
    # Both accumulators onto the new max; exp(-inf - finite) = 0 takes
    # care of the empty initial state.
    c_old = torch.exp(m - new_m)
    c_new = torch.exp(bm - new_m)
    l = l * c_old + bl * c_new
    o = (o * c_old.transpose(1, 2)[..., None] +
         bo * c_new.transpose(1, 2)[..., None])
    m = new_m
    if r + 1 < n:
      k = _Rotate.apply(k, group)
      v = _Rotate.apply(v, group)
  l = torch.clamp(l, min=1e-30)
  return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention_sharded(q, k, v, group=None, causal=False):
  """Ring attention over global (B, T, H, D) tensors that every rank of
  `group` holds: each rank takes its block of T, and the result is every
  rank's block gathered back to (B, T, H, D). Gradients reach each rank's
  own block of q, k and v."""
  n, idx = dist.get_world_size(group), dist.get_rank(group)
  assert q.shape[1] % n == 0, (q.shape, n)
  local = [x.chunk(n, 1)[idx] for x in (q, k, v)]
  return _Gather.apply(ring_attention(*local, group, causal), group)


def full_attention(q, k, v, causal=False):
  """The dense reference: float32 scores, -1e30 where causal masks, a
  softmax, and the value product in v's dtype."""
  scale = q.shape[-1] ** -0.5
  scores = torch.einsum('bqhd,bkhd->bhqk', q.to(f32), k.to(f32)) * scale
  if causal:
    T = q.shape[1]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    scores = torch.where(mask, scores, -1e30)
  probs = torch.softmax(scores, -1)
  out = torch.einsum('bhqk,bkhd->bqhd', probs.to(v.dtype), v)
  return out.to(q.dtype)
