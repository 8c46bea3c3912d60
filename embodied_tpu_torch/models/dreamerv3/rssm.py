"""Recurrent State-Space Model with a block-diagonal GRU core: acting path.

The part of embodied_tpu/models/dreamerv3/rssm.py that acting needs: the
RSSM's single-step observe (action embedding, core step, posterior head,
categorical sample), its carries and packed replay entries, and the CNN +
MLP Encoder. Parameter paths, shapes and math are the JAX ones. The prior,
imagination, the KL losses and the Decoder come with the train step.

Where the structure allows (`kernel` in auto/imag/fused, one dyn layer,
one obs layer, rms/silu, not `absolute`), the observe step runs through
`ops.observe.obs_step`, and a core step alone through
`ops.blockgru.core_step`. Those wrappers take the plain version for CPU
tensors and launch the Hopper kernels for CUDA tensors. `kernel: off`
keeps the plain layer-by-layer path.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ... import nn
from ...nn import dists
from ...ops import blockgru, observe
from ...utils import Space


def space_to_depth(x, s):
  """(B, H, W, C) -> (B, H/s, W/s, s*s*C) by folding s x s pixel patches
  into channels."""
  B, H, W, C = x.shape
  x = x.reshape(B, H // s, s, W // s, s, C)
  x = x.permute(0, 1, 3, 2, 4, 5)
  return x.reshape(B, H // s, W // s, s * s * C)


def max_pool(x):
  """2x2 max pool with stride 2 on NHWC."""
  return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class RSSM(nn.Module):

  def __init__(
      self, act_space, name='dyn', token_dim=None, deter=4096, hidden=2048,
      stoch=32, classes=32, norm='rms', act='gelu', unroll=False,
      unimix=0.01, outscale=1.0, imglayers=2, obslayers=1, dynlayers=1,
      absolute=False, blocks=8, free_nats=1.0, latents='i8', kernel='auto',
      cdtype=nn.COMPUTE_DTYPE, **kw):
    super().__init__(name, cdtype)
    assert token_dim, 'token_dim: the encoder output width'
    assert deter % blocks == 0, (deter, blocks)
    assert latents in ('i8', 'f16', 'f32'), latents
    assert classes <= 256, (classes, 'uint8 stoch indices')
    assert kernel in ('auto', 'imag', 'fused', 'off'), kernel
    self.latents = latents
    self.kernel = kernel
    self.act_space = act_space
    self.deter = deter
    self.hidden = hidden
    self.stoch = stoch
    self.classes = classes
    self.unimix = unimix
    self.absolute = absolute
    self.blocks = blocks
    self.norm = norm
    self.act = act
    self.dynlayers = dynlayers
    self.actfn = nn.act(act)
    kw = dict(kw, cdtype=cdtype)

    self.actconcat = nn.DictConcat(act_space, cdtype=cdtype)
    g = blocks
    obsin = token_dim if absolute else deter + token_dim
    self.obs_layers = []
    for i in range(obslayers):
      self.obs_layers.append((
          self.child(nn.Linear(obsin if i == 0 else hidden, hidden,
                               f'obs{i}', **kw)),
          self.child(nn.Norm(norm, f'obs{i}norm', hidden, cdtype=cdtype))))
    self.obslogit = nn.Linear(
        hidden, stoch * classes, 'obslogit', outscale=outscale, **kw)
    widths = (deter, stoch * classes, self.actconcat.width)
    self.dynin = [
        (self.child(nn.Linear(widths[i], hidden, f'dynin{i}', **kw)),
         self.child(nn.Norm(norm, f'dynin{i}norm', hidden, cdtype=cdtype)))
        for i in range(3)]
    # The first hidden layer sees [deter_block, shared_features] per block;
    # it runs as a block-diagonal matmul on deter plus one dense matmul on
    # the shared features, summed.
    self.dynhid0blk = nn.BlockLinear(deter, deter, g, 'dynhid0blk', **kw)
    self.dynhid0in = nn.Linear(
        3 * hidden, deter, 'dynhid0in', bias=False, **kw)
    self.dynhid0norm = nn.Norm(norm, 'dynhid0norm', deter, cdtype=cdtype)
    self.dynhid = [
        (self.child(nn.BlockLinear(deter, deter, g, f'dynhid{i}', **kw)),
         self.child(nn.Norm(norm, f'dynhid{i}norm', deter, cdtype=cdtype)))
        for i in range(1, dynlayers)]
    self.dyngru = nn.BlockLinear(deter, 3 * deter, g, 'dyngru', **kw)

  @property
  def entry_space(self):
    """Storage format of the replay latents: the stoch sample as uint8
    class indices and deter quantized to int8 with a fixed 1/127 scale."""
    dtype = dict(i8=np.int8, f16=np.float16, f32=np.float32)[self.latents]
    return dict(
        deter=Space(dtype, self.deter),
        stoch=Space(np.uint8, (self.stoch,)))

  def entry_pack(self, entries):
    """Packing of fresh float entries into the storage format."""
    deter, stoch = entries['deter'], entries['stoch']
    if self.latents == 'i8':
      deter = torch.clamp(
          torch.round(deter.float() * 127), -127, 127).to(torch.int8)
    else:
      deter = deter.to(dict(f16=torch.float16, f32=torch.float32)[
          self.latents])
    stoch = torch.argmax(stoch, -1).to(torch.uint8)
    return dict(deter=deter, stoch=stoch)

  def initial(self, bsize, device=None):
    return self.cast(dict(
        deter=torch.zeros([bsize, self.deter], device=device),
        stoch=torch.zeros([bsize, self.stoch, self.classes], device=device)))

  # --- Observation path ---------------------------------------------------

  def observe(self, carry, tokens, action, reset, training=False,
              single=True, gen=None, noise=None):
    """One observe step (`single` only, the acting path). `noise` is the
    Gumbel noise of the stoch sample, (B, stoch, classes); without it the
    sample draws from `gen`."""
    if not single:
      raise NotImplementedError('the observe window comes with training')
    carry, tokens, action = self.cast((carry, tokens, action))
    actfeat = self._action_feat(nn.mask(action, ~reset), ~reset)
    carry, (entry, feat) = self._observe(
        carry, tokens, actfeat, reset, gen, noise, kernel=True)
    return carry, entry, feat

  def _action_feat(self, action, available_mask=None):
    """Embed the action dict: concat -> clip -> linear+norm+act."""
    action = self.actconcat(action)
    if available_mask is not None:
      action = nn.mask(action, available_mask)
    action = action / torch.clamp(action.abs(), min=1).detach()
    linear, norm = self.dynin[2]
    return self.actfn(norm(linear(action)))

  def _observe(self, carry, tokens, actfeat, reset, gen=None, noise=None,
               kernel=False):
    deter, stoch, actfeat = nn.mask(
        (carry['deter'], carry['stoch'], actfeat), ~reset)
    B = deter.shape[0]
    if kernel and self._obs_kernel_eligible():
      toks = self.cast(tokens.reshape((B, -1))).contiguous()
      stoch_flat = self.cast(stoch.reshape((B, -1))).contiguous()
      deter, logitflat = observe.obs_step(
          self.cast(deter).contiguous(), stoch_flat,
          self.cast(actfeat).contiguous(), toks,
          self._obs_params(toks.shape[-1]))
      logit = logitflat.reshape((B, self.stoch, self.classes))
    else:
      deter = self._core(deter, stoch, actfeat, kernel=kernel)
      tokens = tokens.reshape((B, -1))
      x = tokens if self.absolute else torch.cat([deter, tokens], -1)
      for linear, norm in self.obs_layers:
        x = self.actfn(norm(linear(x)))
      logit = self._logit(self.obslogit, x)
    stoch = self.cast(self._dist(logit).sample(gen, noise))
    carry = dict(deter=deter, stoch=stoch)
    feat = dict(deter=deter, stoch=stoch, logit=logit)
    entry = dict(deter=deter, stoch=stoch)
    return carry, (entry, feat)

  # --- Internals ----------------------------------------------------------

  def _kernel_eligible(self):
    """Whether the fused core step applies: a kernel mode and the default
    layer stack with rms/silu math. Shapes the kernel cannot take make the
    CUDA wrapper raise."""
    return (self.kernel in ('auto', 'imag', 'fused') and
            self.dynlayers == 1 and self.norm == 'rms' and
            self.act == 'silu')

  def _obs_kernel_eligible(self):
    """Whether the fused observe step (core + posterior head) applies."""
    return (self._kernel_eligible() and not self.absolute and
            len(self.obs_layers) == 1)

  def _obs_params(self, token_dim):
    (obs0, obs0norm), = self.obs_layers
    assert obs0.kernel.shape[0] == self.deter + token_dim, token_dim
    return self._core_params() + (
        self.cast(obs0.kernel), self.cast(obs0.bias), obs0norm.scale,
        self.cast(self.obslogit.kernel), self.cast(self.obslogit.bias))

  def _core_params(self):
    """The core weights (compute dtype, norm scales float32) in the
    ops.blockgru.FIELDS order."""
    (dynin0, dynin0norm), (dynin1, dynin1norm), _ = self.dynin
    return (
        self.cast(dynin0.kernel), self.cast(dynin0.bias), dynin0norm.scale,
        self.cast(dynin1.kernel), self.cast(dynin1.bias), dynin1norm.scale,
        self.cast(self.dynhid0blk.kernel), self.cast(self.dynhid0blk.bias),
        self.cast(self.dynhid0in.kernel), self.dynhid0norm.scale,
        self.cast(self.dyngru.kernel), self.cast(self.dyngru.bias))

  def _core(self, deter, stoch, actfeat, kernel=False):
    """Block-diagonal GRU core. `actfeat` is the action embedding."""
    g = self.blocks
    stoch = stoch.reshape((stoch.shape[0], -1))
    if kernel and self._kernel_eligible():
      return blockgru.core_step(
          self.cast(deter).contiguous(), self.cast(stoch).contiguous(),
          self.cast(actfeat).contiguous(), self._core_params())
    parts = []
    for (linear, norm), value in zip(self.dynin[:2], (deter, stoch)):
      parts.append(self.actfn(norm(linear(value))))
    parts.append(actfeat)
    x = torch.cat(parts, -1)
    x = self.dynhid0blk(deter) + self.dynhid0in(x)
    x = self.actfn(self.dynhid0norm(x))
    for blocklinear, norm in self.dynhid:
      x = self.actfn(norm(blocklinear(x)))
    x = self.dyngru(x)
    B = x.shape[0]
    gates = x.reshape((B, g, -1)).chunk(3, -1)
    reset, cand, update = [y.reshape((B, -1)) for y in gates]
    reset = torch.sigmoid(reset)
    cand = torch.tanh(reset * cand)
    update = torch.sigmoid(update - 1)
    return update * cand + (1 - update) * deter

  def _logit(self, layer, x):
    x = layer(x)
    return x.reshape((*x.shape[:-1], self.stoch, self.classes))

  def _dist(self, logits):
    return dists.Agg(dists.OneHot(logits, self.unimix), 1)


class Encoder(nn.Module):
  """CNN + MLP encoder; `token_dim` is the width of its output. Each conv
  layer is a stride-1 SAME convolution followed by a 2x2 max pool; the
  JAX encoder's `outer` and `strided` modes, which no preset sets, are not
  ported."""

  def __init__(
      self, obs_space, name='enc', units=1024, norm='rms', act='gelu',
      depth=64, mults=(2, 3, 4, 4), layers=3, kernel=5, symlog=True,
      outer=False, strided=False, s2d=0, cdtype=nn.COMPUTE_DTYPE, **kw):
    super().__init__(name, cdtype)
    assert all(len(s.shape) <= 3 for s in obs_space.values()), obs_space
    self.obs_space = obs_space
    self.veckeys = [k for k, s in obs_space.items() if len(s.shape) <= 2]
    self.imgkeys = [k for k, s in obs_space.items() if len(s.shape) == 3]
    self.depths = tuple(depth * m for m in mults)
    if outer or strided:
      raise NotImplementedError('The outer and strided encoder modes')
    self.s2d = int(s2d)
    if self.s2d:
      for k in self.imgkeys:
        res = obs_space[k].shape[:-1]
        assert all(r % self.s2d == 0 for r in res), (res, self.s2d)
    self.actfn = nn.act(act)
    kw = dict(kw, cdtype=cdtype)
    self.token_dim = 0
    if self.veckeys:
      vspace = {k: obs_space[k] for k in self.veckeys}
      squish = nn.symlog if symlog else None
      self.vecconcat = nn.DictConcat(vspace, squish=squish, cdtype=cdtype)
      width = self.vecconcat.width
      self.mlp_layers = []
      for i in range(layers):
        self.mlp_layers.append((
            self.child(nn.Linear(width, units, f'mlp{i}', **kw)),
            self.child(nn.Norm(norm, f'mlp{i}norm', units, cdtype=cdtype))))
        width = units
      self.token_dim += width
    if self.imgkeys:
      shape = obs_space[sorted(self.imgkeys)[0]].shape
      res = shape[0] // max(1, self.s2d)
      din = sum(obs_space[k].shape[-1] for k in self.imgkeys)
      din *= max(1, self.s2d) ** 2
      self.convs = []
      for i, d in enumerate(self.depths):
        self.convs.append((
            self.child(nn.Conv2D(din, d, kernel, f'cnn{i}', **kw)),
            self.child(nn.Norm(norm, f'cnn{i}norm', d, cdtype=cdtype))))
        res //= 2
        din = d
      assert 3 <= res <= 16, res
      self.token_dim += res * res * din

  @property
  def entry_space(self):
    return {}

  def initial(self, batch_size, device=None):
    return {}

  def entry_pack(self, entries):
    return {}

  def forward(self, carry, obs, reset, training=False, single=False):
    bdims = 1 if single else 2
    bshape = reset.shape[:bdims]
    outs = []
    if self.veckeys:
      x = self.vecconcat({k: obs[k] for k in self.veckeys})
      x = x.reshape((-1, *x.shape[bdims:]))
      for linear, norm in self.mlp_layers:
        x = self.actfn(norm(linear(x)))
      outs.append(x)
    if self.imgkeys:
      imgs = [obs[k] for k in sorted(self.imgkeys)]
      assert all(x.dtype == torch.uint8 for x in imgs), [
          x.dtype for x in imgs]
      x = self.cast(torch.cat(imgs, -1), force=True) / 255 - 0.5
      x = x.reshape((-1, *x.shape[bdims:]))
      if self.s2d:
        x = space_to_depth(x, self.s2d)
      for conv, norm in self.convs:
        x = self.actfn(norm(max_pool(conv(x))))
      assert 3 <= x.shape[-3] <= 16, x.shape
      outs.append(x.reshape((x.shape[0], -1)))
    x = torch.cat(outs, -1)
    tokens = x.reshape((*bshape, *x.shape[1:]))
    return carry, {}, tokens
