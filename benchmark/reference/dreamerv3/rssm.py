"""Recurrent State-Space Model with a block-diagonal GRU core, and the CNN +
MLP Encoder and Decoder, as the reference computes them.

A frozen copy of the port's models/dreamerv3/rssm.py on its plain path
(`kernel: off`): the observe step and the observe window step by step,
layer by layer; the prior; imagination a step at a time; the KL losses
with free nats; the packed replay entries and their unpacking. The
`kernel` option is taken and ignored: no path here calls a kernel.
Parameter paths, shapes and math are the port's. Random numbers come from
a `dists.Draws` (or, for a single step, a generator or the noise itself),
drawn in the order of the port's plain path.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..nn import dists
from ..space import Space

def space_to_depth(x, s):
  """(B, H, W, C) -> (B, H/s, W/s, s*s*C) by folding s x s pixel patches
  into channels."""
  B, H, W, C = x.shape
  x = x.reshape(B, H // s, s, W // s, s, C)
  x = x.permute(0, 1, 3, 2, 4, 5)
  return x.reshape(B, H // s, W // s, s * s * C)


def depth_to_space(x, s):
  """Inverse of space_to_depth."""
  B, H, W, C = x.shape
  x = x.reshape(B, H, W, s, s, C // (s * s))
  x = x.permute(0, 1, 3, 2, 4, 5)
  return x.reshape(B, H * s, W * s, C // (s * s))


def upsample(x):
  """2x nearest-neighbour upsampling of NHWC, as JAX's repeat(2) twice."""
  return x.repeat_interleave(2, -2).repeat_interleave(2, -3)


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
    self.token_dim = token_dim
    self.act_space = act_space
    self.deter = deter
    self.hidden = hidden
    self.stoch = stoch
    self.classes = classes
    self.unimix = unimix
    self.absolute = absolute
    self.blocks = blocks
    self.free_nats = free_nats
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
    self.img_layers = []
    for i in range(imglayers):
      self.img_layers.append((
          self.child(nn.Linear(deter if i == 0 else hidden, hidden,
                               f'prior{i}', **kw)),
          self.child(nn.Norm(norm, f'prior{i}norm', hidden, cdtype=cdtype))))
    self.priorlogit = nn.Linear(
        hidden, stoch * classes, 'priorlogit', outscale=outscale, **kw)
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

  def entry_unpack(self, entries):
    deter, stoch = entries['deter'], entries['stoch']
    deter = deter.float() / 127 if self.latents == 'i8' else deter.float()
    stoch = F.one_hot(stoch.long(), self.classes).float()
    return self.cast(dict(deter=deter, stoch=stoch))

  def initial(self, bsize, device=None):
    return self.cast(dict(
        deter=torch.zeros([bsize, self.deter], device=device),
        stoch=torch.zeros([bsize, self.stoch, self.classes], device=device)))

  def truncate(self, entries, carry=None):
    """Resume a carry from the last stored (packed) latent of a context."""
    assert entries['deter'].ndim == 3, entries['deter'].shape
    return {k: v[:, -1] for k, v in self.entry_unpack(entries).items()}

  def starts(self, entries, carry, nlast):
    B = carry['deter'].shape[0]
    return {k: v[:, -nlast:].reshape((B * nlast, *v.shape[2:]))
            for k, v in entries.items()}

  # --- Observation path ---------------------------------------------------

  def observe(self, carry, tokens, action, reset, training=False,
              single=False, gen=None, noise=None, draws=None):
    """One observe step (`single`, the acting path; also taken for a
    (B,) `reset`), or a window of T steps with (B, T, ...) inputs. A single
    step samples with `noise`, the Gumbel noise (B, stoch, classes), or
    from `gen`; a window draws its noise from `draws`."""
    carry, tokens, action = self.cast((carry, tokens, action))
    actfeat = self._action_feat(nn.mask(action, ~reset), ~reset)
    if single or reset.ndim == 1:
      carry, (entry, feat) = self._observe(
          carry, tokens, actfeat, reset, gen, noise)
      return carry, entry, feat
    B, T = reset.shape
    S, C = self.stoch, self.classes
    gum = draws.gumbel((T, B, S * C))
    steps = []
    for t in range(T):
      carry, (entry, feat) = self._observe(
          carry, tokens[:, t], actfeat[:, t], reset[:, t],
          noise=gum[t].reshape((B, S, C)))
      steps.append((entry, feat))
    stack = lambda xs: {k: torch.stack([x[k] for x in xs], 1) for k in xs[0]}
    return (carry, stack([e for e, _ in steps]),
            stack([f for _, f in steps]))

  def _action_feat(self, action, available_mask=None):
    """Embed the action dict: concat -> clip -> linear+norm+act."""
    action = self.actconcat(action)
    if available_mask is not None:
      action = nn.mask(action, available_mask)
    action = action / torch.clamp(action.abs(), min=1).detach()
    linear, norm = self.dynin[2]
    return self.actfn(norm(linear(action)))

  def _observe(self, carry, tokens, actfeat, reset, gen=None, noise=None):
    deter, stoch, actfeat = nn.mask(
        (carry['deter'], carry['stoch'], actfeat), ~reset)
    B = deter.shape[0]
    deter = self._core(deter, stoch, actfeat)
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

  # --- Imagination path ---------------------------------------------------

  def imagine_single(self, carry, policy, draws):
    """One rollout step: the action from `policy(carry, draws)` (its
    gradient stopped at the carry) or, where `policy` is not callable, the
    given action dict; then the core, the prior and a sample. The noise is
    drawn in that order (the policy's, then the state's)."""
    if callable(policy):
      action = policy({k: v.detach() for k, v in carry.items()}, draws)
    else:
      action = policy
    actfeat = self._action_feat(self.cast(action))
    B = actfeat.shape[0]
    S, C = self.stoch, self.classes
    gum = draws.gumbel((B, S * C))
    deter = self._core(carry['deter'], carry['stoch'], actfeat)
    logit = self._prior(deter)
    stoch = self._dist(logit).sample(noise=gum.reshape((B, S, C)))
    carry = self.cast(dict(deter=deter, stoch=stoch))
    feat = self.cast(dict(deter=deter, stoch=stoch, logit=logit))
    return carry, (feat, action)

  def imagine(self, carry, policy, length, training=False, draws=None):
    """Roll out `length` steps from the carry with `policy`: a callable
    that samples each step's action, or a dict of action sequences
    (B, length, ...), as the report's open loop replays the recorded
    actions; a step at a time."""
    carry = self.cast(carry)
    feats, acts = [], []
    for t in range(length):
      step = policy if callable(policy) else {
          k: v[:, t] for k, v in policy.items()}
      carry, (feat, action) = self.imagine_single(carry, step, draws)
      feats.append(feat)
      acts.append(action)
    stack = lambda xs: {k: torch.stack([x[k] for x in xs], 1) for k in xs[0]}
    return carry, stack(feats), stack(acts)

  # --- Loss ---------------------------------------------------------------

  def loss(self, carry, tokens, acts, reset, training, draws):
    metrics = {}
    carry, entries, feat = self.observe(
        carry, tokens, acts, reset, training, draws=draws)
    prior = self._prior(feat['deter'])
    post = feat['logit']
    dyn = self._dist(post.detach()).kl(self._dist(prior))
    rep = self._dist(post).kl(self._dist(prior.detach()))
    if self.free_nats:
      dyn = torch.clamp(dyn, min=self.free_nats)
      rep = torch.clamp(rep, min=self.free_nats)
    losses = {'dyn': dyn, 'rep': rep}
    metrics['dyn_ent'] = self._dist(prior).entropy().mean()
    metrics['rep_ent'] = self._dist(post).entropy().mean()
    return carry, entries, losses, feat, metrics

  # --- Internals ----------------------------------------------------------

  def _core(self, deter, stoch, actfeat):
    """Block-diagonal GRU core. `actfeat` is the action embedding."""
    g = self.blocks
    stoch = stoch.reshape((stoch.shape[0], -1))
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

  def _prior(self, feat):
    x = feat
    for linear, norm in self.img_layers:
      x = self.actfn(norm(linear(x)))
    return self._logit(self.priorlogit, x)

  def _logit(self, layer, x):
    x = layer(x)
    return x.reshape((*x.shape[:-1], self.stoch, self.classes))

  def _dist(self, logits):
    return dists.Agg(dists.OneHot(logits, self.unimix), 1)


class Encoder(nn.Module):
  """CNN + MLP encoder; `token_dim` is the width of its output. By default
  each conv layer is a stride-1 SAME convolution followed by a 2x2 max
  pool; `strided` makes each a stride-2 convolution with no pool, and
  `outer` keeps the first layer at full resolution (stride 1, no pool).
  `s2d` folds pixel patches into channels first and takes neither mode."""

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
    self.s2d = int(s2d)
    if self.s2d:
      assert not outer and not strided, 's2d replaces the outer/strided modes'
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
      self.convs = []  # (conv, norm, whether a max pool follows the conv)
      for i, d in enumerate(self.depths):
        full = outer and i == 0
        stride = 2 if strided and not full else 1
        self.convs.append((
            self.child(nn.Conv2D(din, d, kernel, f'cnn{i}', stride=stride,
                                 **kw)),
            self.child(nn.Norm(norm, f'cnn{i}norm', d, cdtype=cdtype)),
            not strided and not full))
        if not full:
          res = -(-res // 2) if strided else res // 2
        din = d
      assert 3 <= res <= 16, res
      self.token_dim += res * res * din

  @property
  def entry_space(self):
    return {}

  def initial(self, batch_size, device=None):
    return {}

  def truncate(self, entries, carry=None):
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
      for conv, norm, pool in self.convs:
        x = conv(x)
        x = self.actfn(norm(max_pool(x) if pool else x))
      assert 3 <= x.shape[-3] <= 16, x.shape
      outs.append(x.reshape((x.shape[0], -1)))
    x = torch.cat(outs, -1)
    tokens = x.reshape((*bshape, *x.shape[1:]))
    return carry, {}, tokens


class Decoder(nn.Module):
  """CNN + MLP decoder, as the JAX Decoder: the vector keys through an MLP
  and a DictHead (categorical for discrete spaces, symlog_mse or mse for
  the rest); the image keys from a block-space projection (`bspace` groups
  of deter through a BlockLinear into the conv grid, plus the stoch
  through two dense layers), or with `bspace: 0` from one Linear
  (`space`) of the stoch and deter concatenated; then by default 2x
  nearest-neighbour upsampling before each stride-1 convolution and
  before `imgout`, and `s2d` depth-to-space at the end. `strided` makes
  each convolution a stride-2 transposed one with no upsampling, `outer`
  leaves the last doubling out (`imgout` a stride-1 convolution on the
  full grid), so the grid starts 2^(len(depths) - outer) times smaller
  than the image."""

  def __init__(
      self, obs_space, name='dec', feat_dims=None, units=1024, norm='rms',
      act='gelu', outscale=1.0, depth=64, mults=(2, 3, 4, 4), layers=3,
      kernel=5, symlog=True, bspace=8, outer=False, strided=False, s2d=0,
      cdtype=nn.COMPUTE_DTYPE, **kw):
    super().__init__(name, cdtype)
    deter, stochflat = feat_dims
    self.obs_space = obs_space
    self.veckeys = [k for k, s in obs_space.items() if len(s.shape) <= 2]
    self.imgkeys = [k for k, s in obs_space.items() if len(s.shape) == 3]
    self.depths = tuple(depth * m for m in mults)
    self.imgdep = sum(obs_space[k].shape[-1] for k in self.imgkeys)
    self.bspace = bspace
    self.outer = outer
    self.strided = strided
    self.s2d = int(s2d)
    assert not self.s2d or not (outer or strided), (
        's2d replaces the outer/strided modes')
    self.actfn = nn.act(act)
    kw = dict(kw, cdtype=cdtype)
    if self.veckeys:
      spaces = {k: obs_space[k] for k in self.veckeys}
      o2 = 'symlog_mse' if symlog else 'mse'
      outputs = {k: 'categorical' if v.discrete else o2
                 for k, v in spaces.items()}
      self.mlp = nn.MLP(stochflat + deter, layers, units, 'mlp', act=act,
                        norm=norm, **kw)
      self.vec = nn.DictHead(spaces, outputs, 'vec', units,
                             outscale=outscale, **kw)
    if self.imgkeys:
      imgres = obs_space[self.imgkeys[0]].shape[:-1]
      factor = 2 ** (len(self.depths) - int(bool(outer))) * max(1, self.s2d)
      self.minres = [int(x // factor) for x in imgres]
      assert 3 <= self.minres[0] <= 16, (self.minres, imgres)
      shape = (*self.minres, self.depths[-1])
      self.space_shape = shape
      if bspace:
        u = math.prod(shape)
        self.sp0 = nn.BlockLinear(deter, u, bspace, 'sp0', **kw)
        self.sp1 = nn.Linear(stochflat, 2 * units, 'sp1', **kw)
        self.sp1norm = nn.Norm(norm, 'sp1norm', 2 * units, cdtype=cdtype)
        self.sp2 = nn.Linear(2 * units, shape, 'sp2', **kw)
        self.spnorm = nn.Norm(norm, 'spnorm', shape[-1], cdtype=cdtype)
      else:
        self.space = nn.Linear(stochflat + deter, shape, 'space', **kw)
        self.spacenorm = nn.Norm(norm, 'spacenorm', shape[-1], cdtype=cdtype)
      up = dict(stride=2, transp=True) if strided else {}
      self.deconvs = []
      din = shape[-1]
      for i, d in reversed(list(enumerate(self.depths[:-1]))):
        self.deconvs.append((
            self.child(nn.Conv2D(din, d, kernel, f'conv{i}', **up, **kw)),
            self.child(nn.Norm(norm, f'conv{i}norm', d, cdtype=cdtype))))
        din = d
      outdep = self.imgdep * max(1, self.s2d) ** 2
      self.imgout = nn.Conv2D(din, outdep, kernel, 'imgout',
                              outscale=outscale, **({} if outer else up), **kw)

  @property
  def entry_space(self):
    return {}

  def initial(self, batch_size, device=None):
    return {}

  def truncate(self, entries, carry=None):
    return {}

  def entry_pack(self, entries):
    return {}

  def forward(self, carry, feat, reset, training=False, single=False):
    recons = {}
    bshape = reset.shape[:(1 if single else 2)]
    n = math.prod(bshape)
    stoch = self.cast(feat['stoch']).reshape((n, -1))
    deter = self.cast(feat['deter']).reshape((n, -1))
    if self.veckeys:
      x = self.mlp(torch.cat([stoch, deter], -1))
      recons.update(self.vec(x.reshape((*bshape, *x.shape[1:]))))
    if self.imgkeys:
      if self.bspace:
        g = self.bspace
        h, w = self.minres
        c = self.space_shape[-1] // g
        # (g h w c) -> (h, w, g * c)
        x0 = self.sp0(deter).reshape((-1, g, h, w, c))
        x0 = x0.permute(0, 2, 3, 1, 4).reshape((-1, h, w, g * c))
        x1 = self.actfn(self.sp1norm(self.sp1(stoch)))
        x = self.actfn(self.spnorm(x0 + self.sp2(x1)))
      else:
        x = self.actfn(self.spacenorm(self.space(
            torch.cat([stoch, deter], -1))))
      for conv, norm in self.deconvs:
        x = self.actfn(norm(conv(x if self.strided else upsample(x))))
      if not self.outer and not self.strided:
        x = upsample(x)
      x = self.imgout(x)
      if self.s2d:
        x = depth_to_space(x, self.s2d)
      x = torch.sigmoid(x)
      x = x.reshape((*bshape, *x.shape[1:]))
      sizes = [self.obs_space[k].shape[-1] for k in self.imgkeys]
      for k, out in zip(self.imgkeys, torch.split(x, sizes, -1)):
        recons[k] = dists.Agg(dists.MSE(out), 3)
    return carry, {}, recons
