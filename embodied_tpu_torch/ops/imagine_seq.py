"""The whole imagination rollout with the policy inside: a CUDA kernel and
its plain version.

Replaces the Pallas TPU kernel embodied_tpu/ops/imagine_seq.py:
fused_imagine_seq (forward). The kernel lives in csrc/imagine_seq.cu (its
stages in csrc/blockgru_common.cuh and csrc/seq_common.cuh; the core, the
prior and the sample are the per-step kernel's, ops/imagine.py). On an
H100 it is bound by operations: at B = 1024 rows a step does some 1,000
flops per weight byte (`products` lists them, `work` gives the bound). So
every product of 64 columns or more runs on the 128-row tensor-core stage
(wgmma on 128 x 256 tiles fed by TMA through a ring of shared memory), and
the narrow products (1,024 columns) split their contraction to fill the
card. Left for later: one persistent launch for the step's row stages and
launches, and the GRU update fused into the gates' epilogue.

Per step t: the policy MLP on the carried (deter, stoch), the action
sample (a categorical head's Gumbel-max one-hot, or a bounded normal's
tanh(mean) + std * noise with std = (maxstd - minstd) sigmoid(x + 2) +
minstd), the action embedding of the clipped action a / max(1, |a|), the
block-GRU core, the 2-layer prior and its logits, and the stochastic
sample by Gumbel-max over the unimix blend. The noise is an input:
gumbel (H, B, L) f32 for the state, and (H, B, A) f32 for the action
(Gumbel for a categorical head, standard normal for a bounded normal).

DreamerV3 trains the actor-critic on the rolled-out features with the
gradient stopped, so the rollout runs without a graph on the train step.
Where a gradient is asked for, the backward is autograd of the plain
version replaying the forward's samples, as the JAX custom VJP does:
continuous actions are recomputed from the noise (reparameterised),
discrete actions enter as constants, and the stochastic samples carry
straight-through gradients. The clip divides by max(1, |a|) with the
gradient stopped, as the XLA path of rssm.py does.

`imagine_seq` is the wrapper: a CPU or meta tensor takes
`reference_imagine_seq`; a CUDA tensor launches the kernel or raises. It
counts its launches in `imagine_seq.launches`.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import blockgru, build, imagine
from ..utils import timer
from .blockgru import _rms, _silu
from .imagine import PRIOR_FIELDS, _layer, _mm

EMBED_FIELDS = ('wa', 'ba', 'sa')
HEAD_BIASES = ('bh', 'bhm', 'bhs')  # f32, as the JAX kernel takes them
TILE = 16


def fields(npol, disc):
  """Parameter order for a rollout with an npol-layer policy MLP: the core,
  the prior, the action embedding (wa (A, hidden)), the MLP, the head."""
  mlp = tuple(f'{k}{i}' for i in range(npol) for k in ('wm', 'bm', 'sm'))
  head = ('wh', 'bh') if disc else ('whm', 'bhm', 'whs', 'bhs')
  return blockgru.FIELDS + PRIOR_FIELDS + EMBED_FIELDS + mlp + head


def scales(npol):
  return blockgru.SCALES + ('sp0', 'sp1', 'sa') + tuple(
      f'sm{i}' for i in range(npol))


def policy_action(p, deter, stoch, noise, npol, disc, minstd, maxstd,
                  eps=1e-4):
  """The policy MLP and the action sample. Returns (the action record f32:
  the one-hot or the raw continuous action, the embedding's input)."""
  cdt = deter.dtype
  D = deter.shape[-1]
  x = _mm(deter, p['wm0'][:D]) + _mm(stoch, p['wm0'][D:]) + p['bm0'].float()
  x = _silu(_rms(x, p['sm0'], eps)).to(cdt)
  for i in range(1, npol):
    x = _layer(x, p[f'wm{i}'], p[f'bm{i}'], p[f'sm{i}'], eps)
  if disc:
    logits = _mm(x, p['wh']) + p['bh'].float()
    hard = F.one_hot((logits + noise).argmax(-1), logits.shape[-1]).float()
    return hard, hard.to(cdt)
  mean = torch.tanh(_mm(x, p['whm']) + p['bhm'].float())
  std = (maxstd - minstd) * torch.sigmoid(
      _mm(x, p['whs']) + p['bhs'].float() + 2.0) + minstd
  act = mean + std * noise
  return act, (act / act.abs().clamp(min=1).detach()).to(cdt)


def reference_imagine_seq(deter0, stoch0, params, npol, disc, C,
                          unimix=0.01, minstd=0.1, maxstd=1.0, eps=1e-4,
                          gumbel=None, noise=None, hard=None, acts=None):
  """Plain version. Draws from `gumbel` (H, B, L) and `noise` (H, B, A), or
  replays the one-hots `hard` (H, B, L) and, for a categorical head, the
  one-hot actions `acts` (H, B, A); continuous actions are recomputed from
  `noise`. Returns time-major (deter, stoch, logits f32, actions f32)."""
  p = dict(zip(fields(npol, disc), params))
  step = params[:len(imagine.FIELDS)]
  cdt = deter0.dtype
  deter, stoch = deter0, stoch0
  outs = [], [], [], []
  for t in range(gumbel.shape[0]):
    if hard is not None and disc:
      act_rec = acts[t].float()
      act_in = act_rec.to(cdt)
    else:
      act_rec, act_in = policy_action(
          p, deter.detach(), stoch.detach(), noise[t], npol, disc, minstd,
          maxstd, eps)
    actfeat = _layer(act_in, p['wa'], p['ba'], p['sa'], eps)
    deter, stoch, logit = imagine.reference_imag_step(
        deter, stoch, actfeat, gumbel[t], step, C, unimix, eps,
        hard=None if hard is None else hard[t])
    for out, value in zip(outs, (deter, stoch, logit, act_rec)):
      out.append(value)
  return tuple(torch.stack(x) for x in outs)


def pad_head(params, npol, disc):
  """The action embedding and head padded from A to the kernel's tile AP:
  zero rows of wa, zero head columns, and for a categorical head a -1e9
  bias on the padded classes. Returns (wa, whead (U, NH), bhead (NH) f32)
  with NH = AP, or 2 AP for the bounded normal's [mean | stddev]."""
  p = dict(zip(fields(npol, disc), params))
  A, Hd = p['wa'].shape
  AP = -(-A // TILE) * TILE
  wa = p['wa'].new_zeros((AP, Hd))
  wa[:A] = p['wa']
  heads = (('wh', 'bh'),) if disc else (('whm', 'bhm'), ('whs', 'bhs'))
  U = p[heads[0][0]].shape[0]
  whead = p['wa'].new_zeros((U, AP * len(heads)))
  bhead = torch.full((AP * len(heads),), -1e9 if disc else 0.0,
                     dtype=torch.float32, device=wa.device)
  for i, (w, b) in enumerate(heads):
    whead[:, i * AP:i * AP + A] = p[w]
    bhead[i * AP:i * AP + A] = p[b].float()
  return wa, whead, bhead


@functools.cache
def _lib():
  lib = build.library('imagine_seq')
  build.bind(lib, 'imagine_seq_fwd', 10,
             [ctypes.c_int] * 15 + [ctypes.c_float] * 4)
  return lib


def launch(deter0, stoch0, gumbel, noise, params, npol, disc, C, unimix=0.01,
           minstd=0.1, maxstd=1.0, eps=1e-4):
  """Run the CUDA kernel on CUDA tensors (no counting, no dispatch)."""
  names = fields(npol, disc)
  p = dict(zip(names, params))
  steps, B, L = gumbel.shape
  D, adim = deter0.shape[1], noise.shape[2]
  H, g = p['w0'].shape[1], p['wblk'].shape[0]
  U = p['wm0'].shape[1]
  A = p['wa'].shape[1]
  want = blockgru.shapes(B, D, H, L, A, g)
  want.update(
      deter0=(B, D), stoch0=(B, L), gumbel=(steps, B, L),
      noise=(steps, B, adim), wp0=(D, H), bp0=(H,), sp0=(H,), wp1=(H, H),
      bp1=(H,), sp1=(H,), wpl=(H, L), bpl=(L,), wa=(adim, A), ba=(A,),
      sa=(A,), wm0=(D + L, U), bm0=(U,), sm0=(U,))
  for i in range(1, npol):
    want.update({f'wm{i}': (U, U), f'bm{i}': (U,), f'sm{i}': (U,)})
  for w, b in (('wh', 'bh'), ('whm', 'bhm'), ('whs', 'bhs')):
    want.update({w: (U, adim), b: (adim,)})
  named = dict(deter0=deter0, stoch0=stoch0, gumbel=gumbel, noise=noise)
  named.update(zip(names, params))
  # The action width is unpadded here, so its weights are loaded by the
  # padded copies below, not by the kernel's 16-byte loads.
  device = blockgru.check_inputs(
      {k: v for k, v in named.items() if k not in ('wa', 'wh', 'whm', 'whs')},
      want, floats=('gumbel', 'noise') + HEAD_BIASES + scales(npol))
  for name, width in dict(stoch=L, policy=U, embedding=A).items():
    if width % TILE:
      raise ValueError(f'{name} width {width} is not a multiple of {TILE}')
  if L % C:
    raise ValueError(f'stoch width {L} is not a multiple of {C} classes')
  wa, whead, bhead = pad_head(params, npol, disc)
  AP = wa.shape[0]
  noise_p = noise.new_zeros((steps, B, AP))
  noise_p[..., :adim] = noise
  mlp = params[23:23 + 3 * npol]
  kparams = (*params[:20], wa, p['ba'], p['sa'], *mlp, whead, bhead)
  lib = _lib()
  ints = [steps, B, D, H, L, A, U, AP, whead.shape[1], npol, g, C,
          blockgru._sms(device)]
  ws = blockgru.workspace(lib, 'imagine_seq_workspace', ints, device)
  bf = dict(dtype=torch.bfloat16, device=device)
  dseq = torch.empty((steps, B, D), **bf)
  sseq = torch.empty((steps, B, L), **bf)
  lseq = torch.empty((steps, B, L), dtype=torch.float32, device=device)
  aseq = torch.empty((steps, B, AP), dtype=torch.float32, device=device)
  array, pp = blockgru._pointers(kparams)
  with torch.cuda.device(device):
    code = lib.imagine_seq_fwd(
        *blockgru._ptrs([deter0, stoch0, gumbel, noise_p]), pp,
        *blockgru._ptrs([dseq, sseq, lseq, aseq, ws]), *ints, adim,
        int(disc), minstd, maxstd, eps, unimix, blockgru._stream(device))
  del array
  build.check(code, 'imagine_seq_fwd')
  return dseq, sseq, lseq, aseq[..., :adim]


class _ImagineSeq(torch.autograd.Function):
  """The kernel forward; the backward is autograd of the plain replay."""

  @staticmethod
  def forward(ctx, deter0, stoch0, gumbel, noise, spec, *params):
    out = launch(deter0, stoch0, gumbel, noise, params, *spec)
    ctx.save_for_backward(deter0, stoch0, gumbel, noise, out[1], out[3],
                          *params)
    ctx.spec = spec
    return out

  @staticmethod
  def backward(ctx, *grads):
    deter0, stoch0, gumbel, noise, sseq, aseq, *params = ctx.saved_tensors
    npol, disc, C, unimix, minstd, maxstd, eps = ctx.spec
    with torch.enable_grad():
      ins = [x.detach().requires_grad_() for x in (deter0, stoch0, *params)]
      outs = reference_imagine_seq(
          ins[0], ins[1], ins[2:], npol, disc, C, unimix, minstd, maxstd,
          eps, gumbel=gumbel, noise=noise, hard=sseq, acts=aseq)
      pairs = [(o, g) for o, g in zip(outs, grads)
               if g is not None and o.requires_grad]
      got = torch.autograd.grad([o for o, _ in pairs], ins,
                                [g for _, g in pairs], allow_unused=True)
    return (got[0], got[1], None, None, None, *got[2:])


def imagine_seq(deter0, stoch0, gumbel, noise, params, npol, disc, C,
                unimix=0.01, minstd=0.1, maxstd=1.0, eps=1e-4):
  """The rollout (see the module note). Returns time-major (deter, stoch,
  logits f32, actions f32 (H, B, A)). CPU tensors take the plain version;
  CUDA tensors launch the kernel and raise on what it does not take."""
  if blockgru.takes_plain(deter0):
    return reference_imagine_seq(
        deter0, stoch0, params, npol, disc, C, unimix, minstd, maxstd, eps,
        gumbel=gumbel, noise=noise)
  spec = (npol, disc, C, unimix, minstd, maxstd, eps)
  with timer.range('imagine_seq'):
    out = _ImagineSeq.apply(deter0, stoch0, gumbel, noise, spec, *params)
  imagine_seq.launches += 1
  return out


imagine_seq.launches = 0


def products(B, D, H, L, A, U, adim, npol, g, disc):
  """Each matrix product of one rollout step as name: (rows, K, N,
  groups): B rows against a K-deep contraction into N columns, in `groups`
  block-diagonal groups of N / groups columns (K is then the depth of one
  group's block); 2 rows K N flops each. The hidden layer adds x (2H + A
  wide) against win to the block-diagonal deter product, so its K is the
  two depths together."""
  dg = D // g
  out = dict(
      policy0=(B, D + L, U, 1),
      **{f'policy{i}': (B, U, U, 1) for i in range(1, npol)},
      head=(B, U, adim * (1 if disc else 2), 1),
      embed=(B, adim, A, 1),
      in_proj_deter=(B, D, H, 1),
      in_proj_stoch=(B, L, H, 1),
      hidden=(B, dg + 2 * H + A, D, g),
      gates=(B, dg, 3 * D, g),
      prior0=(B, D, H, 1),
      prior1=(B, H, H, 1),
      prior_logits=(B, H, L, 1))
  return out


def work(steps, B, D, H, L, A, U, adim, npol, g, disc):
  """Bytes the rollout must move (inputs read once, outputs written once)
  and its flops, for the bound on the card. A is the embedding width; the
  head has one (U, adim) matrix and f32 bias for a categorical policy, two
  (mean and stddev) for a bounded normal.
  This is the kernel's roofline count; `Agent.train_cost` counts the
  plain version's products instead (parallel/flops.py)."""
  dg = D // g
  heads = 1 if disc else 2
  core = D * H + L * H + g * dg * dg + (2 * H + A) * D + g * dg * 3 * dg
  prior = D * H + H * H + H * L
  policy = (D + L) * U + (npol - 1) * U * U + U * adim * heads
  w = core + prior + adim * A + policy
  vectors = 2 * H + 4 * D + 2 * H + L + A + npol * U  # bf16 biases
  scale = 2 * H + D + 2 * H + A + npol * U + adim * heads  # f32
  ins = 2 * B * (D + L) + 4 * steps * B * (L + adim)
  outs = 2 * steps * B * (D + L) + 4 * steps * B * (L + adim)
  nbytes = 2 * (w + vectors) + 4 * scale + ins + outs
  return nbytes, 2 * steps * B * w
