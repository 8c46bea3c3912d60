"""DreamerV3 model: acting and the train step.

Counterpart of embodied_tpu/models/dreamerv3/model.py: the encoder, RSSM
and decoder (the world-model trio), the reward, continue, policy and value
heads, the EMA slow value, the return/value/advantage normalizers and the
optimizer, with the JAX store's parameter and state paths. `policy` acts;
`train_step` resumes the window's carry from stored latents, computes the
world-model, imagination and replay-value losses, differentiates them and
updates parameters, slots, normalizers and the slow value in place. (It is
not called `train`, which torch.nn.Module already defines.) `report`
computes the losses without updates, optionally a gradient norm per loss,
and the open-loop video: the posterior over the first half of the window,
imagination over the second half driven by the recorded actions, both
decoded.
"""

import numpy as np
import torch

from ... import nn
from ...utils import Space, tree
from . import ac, rssm

OPT_SCOPES = ('enc', 'dyn', 'dec', 'rew', 'con', 'pol', 'val')
isimage = lambda s: s.dtype == np.uint8 and len(s.shape) == 3


def _strip(cfg):
  cfg = dict(cfg)
  cfg.pop('output', None)
  return cfg


def _detach(xs, skip=False):
  return xs if skip else nn.core.tree_map(lambda x: x.detach(), xs)


def _concat(xs, axis):
  return {k: torch.cat([x[k] for x in xs], axis) for k in xs[0]}


class Model(nn.Module):
  """DreamerV3 under the Agent contract."""

  WM = ('enc', 'dyn', 'dec')

  def __init__(self, obs_space, act_space, config, cdtype=nn.COMPUTE_DTYPE):
    super().__init__('model', cdtype)
    self.obs_space = obs_space
    self.act_space = {k: v for k, v in act_space.items() if k != 'reset'}
    self.config = config
    acfg = config.agent
    self.acfg = acfg

    exclude = ('is_first', 'is_last', 'is_terminal', 'reward')
    spaces = {k: v for k, v in obs_space.items()
              if k not in exclude and not k.startswith('log/')}
    self.enc = {'simple': rssm.Encoder}[acfg.enc.typ](
        spaces, 'enc', cdtype=cdtype, **dict(acfg.enc[acfg.enc.typ]))
    self.dyn = {'rssm': rssm.RSSM}[acfg.dyn.typ](
        self.act_space, 'dyn', token_dim=self.enc.token_dim, cdtype=cdtype,
        **dict(acfg.dyn[acfg.dyn.typ]))
    featdim = self.dyn.deter + self.dyn.stoch * self.dyn.classes
    self.dec = {'simple': rssm.Decoder}[acfg.dec.typ](
        spaces, 'dec', cdtype=cdtype,
        feat_dims=(self.dyn.deter, self.dyn.stoch * self.dyn.classes),
        **dict(acfg.dec[acfg.dec.typ]))

    scalar = Space(np.float32, ())
    binary = Space(bool, (), 0, 2)
    head = lambda space, cfg, name: nn.MLPHead(
        space, cfg.output, name, featdim, cdtype=cdtype, **_strip(cfg))
    self.rew = head(scalar, acfg.rewhead, 'rew')
    self.con = head(binary, acfg.conhead, 'con')
    d1, d2 = acfg.policy_dist_disc, acfg.policy_dist_cont
    pouts = {k: d1 if v.discrete else d2 for k, v in self.act_space.items()}
    self.pol = nn.MLPHead(
        self.act_space, pouts, 'pol', featdim, cdtype=cdtype,
        **dict(acfg.policy))
    self.val = head(scalar, acfg.value, 'val')
    self.slowval = head(scalar, acfg.value, 'slowval')
    self.slowval_ema = nn.SlowModel(
        self.slowval, self.val, **dict(acfg.slowvalue))

    self.retnorm = nn.Normalize(**dict(acfg.retnorm), name='retnorm')
    self.valnorm = nn.Normalize(**dict(acfg.valnorm), name='valnorm')
    self.advnorm = nn.Normalize(**dict(acfg.advnorm), name='advnorm')

    self.opt = nn.Optimizer(
        nn.scope_params(self, OPT_SCOPES), 'opt',
        scaling=cdtype == torch.float16, **dict(acfg.opt))

    scales = dict(acfg.loss_scales)
    rec = scales.pop('rec')
    scales.update({k: rec for k in spaces})
    self.scales = scales

  @property
  def device(self):
    return next(self.parameters()).device

  # --- World-model trio plumbing ------------------------------------------

  def _entry_flat(self, entry_trio):
    """Flatten per-module entries into replay-column format (packed)."""
    packed = {name: getattr(self, name).entry_pack(entry)
              for name, entry in zip(self.WM, entry_trio)}
    return tree.flatdict(packed)

  @property
  def policy_keys(self):
    return r'^(enc|dyn|dec|pol)/'

  @property
  def latent_keys(self):
    """Replay keys the device-resident latent table holds (the packed
    replay-context latents; see parallel/latents.py)."""
    if not self.config.replay_context:
      return ()
    return tuple(self._entry_space_flat())

  def _entry_space_flat(self):
    return tree.flatdict({
        name: getattr(self, name).entry_space for name in self.WM})

  @property
  def ext_space(self):
    spaces = {'consec': Space(np.int32), 'stepid': Space(np.uint8, 20)}
    if self.config.replay_context:
      spaces.update(self._entry_space_flat())
    return spaces

  # --- Carries ------------------------------------------------------------

  def init_policy(self, batch_size):
    device = self.device
    zeros = lambda s: torch.zeros(
        (batch_size, *s.shape), dtype=nn.torch_dtype(s.dtype), device=device)
    return (self.enc.initial(batch_size, device),
            self.dyn.initial(batch_size, device), {},
            {k: zeros(v) for k, v in self.act_space.items()})

  def init_train(self, batch_size):
    return self.init_policy(batch_size)

  def init_report(self, batch_size):
    return self.init_policy(batch_size)

  # --- Policy -------------------------------------------------------------

  def policy(self, carry, obs, mode='train', gen=None):
    enc_carry, dyn_carry, dec_carry, prevact = carry
    kw = dict(training=False, single=True)
    reset = obs['is_first']
    enc_carry, enc_entry, tokens = self.enc(enc_carry, obs, reset, **kw)
    dyn_carry, dyn_entry, feat = self.dyn.observe(
        dyn_carry, tokens, prevact, reset, gen=gen, **kw)
    policy = self.pol(self._feat2tensor(feat), bdims=1)
    act = {k: v.sample(gen).to(nn.torch_dtype(self.act_space[k].dtype))
           for k, v in policy.items()}
    # Finite-ness screening, logged per episode (log/ keys bypass replay).
    screen = lambda x: (
        torch.isfinite(x.float()).reshape((x.shape[0], -1)).all(-1)
        if x.ndim > 1 else torch.isfinite(x.float()))
    finite = tree.flatdict(dict(
        tokens=screen(tokens), act={k: screen(v) for k, v in act.items()}))
    out = {f'log/finite/{k}': v for k, v in finite.items()}
    if self.config.replay_context:
      out.update(self._entry_flat((enc_entry, dyn_entry, {})))
    return (enc_carry, dyn_carry, dec_carry, act), act, out

  def _feat2tensor(self, feat):
    stoch = self.cast(feat['stoch'])
    return torch.cat([
        self.cast(feat['deter']),
        stoch.reshape((*stoch.shape[:-2], -1))], -1)

  def _sample(self, policy, draws):
    """Actions from the policy's distributions with noise from `draws`."""
    out = {}
    for key, dist in policy.items():
      space = self.act_space[key]
      if space.discrete:
        value = dist.sample(noise=draws.gumbel(dist.logits.shape))
      else:
        value = dist.sample(noise=draws.normal(dist.pred().shape))
      out[key] = value.to(nn.torch_dtype(space.dtype))
    return out

  def _fused_policy_spec(self):
    """Policy weights and distribution for the whole-horizon rollout
    kernel (ops/imagine_seq.py), or None where the kernel does not take
    the policy: it needs one action key with a categorical (scalar
    discrete) or bounded_normal (vector continuous) head, a biased
    rms/silu MLP trunk of at least one layer, whose width fits the
    kernel's column tile. Head biases stay float32,
    as the JAX kernel takes them."""
    if len(self.act_space) != 1:
      return None
    (key, space), = self.act_space.items()
    pcfg = dict(self.acfg.policy)
    if pcfg.get('norm', 'rms') != 'rms' or pcfg.get('act', 'silu') != 'silu':
      return None
    if not pcfg.get('bias', True):
      return None
    disc = space.discrete
    impl = self.acfg.policy_dist_disc if disc else self.acfg.policy_dist_cont
    if disc and (impl != 'categorical' or space.shape != ()):
      return None
    if not disc and (impl != 'bounded_normal' or len(space.shape) != 1):
      return None
    npol = int(pcfg['layers'])
    if npol < 1 or int(pcfg['units']) % rssm.KERNEL_TILE:
      return None
    params = []
    for linear, norm in self.pol.mlp.layers:
      params += [self.cast(linear.kernel), self.cast(linear.bias), norm.scale]
    head = self.pol.out.heads[key]
    layers = (head.logits,) if disc else (head.mean, head.stddev)
    for layer in layers:
      params += [self.cast(layer.kernel), layer.bias]
    return dict(
        key=key, disc=disc, npol=npol,
        ain=int(space.classes) if disc else int(space.shape[0]),
        minstd=float(pcfg.get('minstd', 1.0)),
        maxstd=float(pcfg.get('maxstd', 1.0)), params=tuple(params))

  def _fused_imag_heads(self, inp):
    """The five imagination heads (rew, con, pol, val, slowval) read the
    same rolled-out features, so their first layers run as one matmul on
    the concatenated kernels (the same function: weight columns are
    independent); each trunk then finishes through its own modules.
    Returns {name: dist}, or None when a trunk is not a biased rms/silu
    stack."""
    specs = [
        ('rew', self.rew, dict(self.acfg.rewhead)),
        ('con', self.con, dict(self.acfg.conhead)),
        ('pol', self.pol, dict(self.acfg.policy)),
        ('val', self.val, dict(self.acfg.value)),
        ('slowval', self.slowval, dict(self.acfg.value))]
    for _, _, cfg in specs:
      if cfg.get('norm', 'rms') != 'rms' or cfg.get('act', 'silu') != 'silu':
        return None
      if not cfg.get('bias', True) or int(cfg.get('layers', 3)) < 1:
        return None
    bshape = inp.shape[:2]
    x = self.cast(inp).reshape((-1, inp.shape[-1]))
    firsts = [mod.mlp.layers[0][0] for _, mod, _ in specs]
    wcat = torch.cat([self.cast(layer.kernel) for layer in firsts], -1)
    bcat = torch.cat([self.cast(layer.bias) for layer in firsts], -1)
    parts = torch.split(x @ wcat + bcat, [l.units for l in firsts], -1)
    outs = {}
    for (name, mod, _), h in zip(specs, parts):
      for i, (linear, norm) in enumerate(mod.mlp.layers):
        if i:  # Layer 0 came out of the shared matmul above.
          h = linear(h)
        h = mod.mlp.act(norm(h))
      outs[name] = mod.out(h.reshape((*bshape, h.shape[-1])))
    return outs

  # --- Training -----------------------------------------------------------

  def train_step(self, carry, data, draws):
    """One train step on a (B, T + replay_context) batch of device tensors.
    Returns (carry, outs, metrics); outs['replay'] holds the refreshed
    packed latents and stepid, metrics are device scalars."""
    carry, obs, prevact, stepid = self._resume_window(carry, data)
    mets, (carry, entries, _, extra) = self.opt(
        self.loss, carry, obs, prevact, True, draws)
    metrics = dict(mets, **extra)
    self.slowval_ema.update()
    outs = {}
    if self.config.replay_context:
      updates = dict(self._entry_flat(entries), stepid=stepid)
      shape = tuple(obs['is_first'].shape[:2])
      mismatched = {k: tuple(v.shape) for k, v in updates.items()
                    if tuple(v.shape[:2]) != shape}
      assert not mismatched, (shape, mismatched)
      outs['replay'] = updates
    lastact = {k: data[k][:, -1] for k in self.act_space}
    return (*carry, lastact), outs, metrics

  def loss(self, carry, obs, prevact, training, draws):
    losses, metrics, carry, entries, tokens, repfeat = (
        self._world_model_objectives(carry, obs, prevact, training, draws))
    B, T = obs['is_first'].shape
    badshape = {k: tuple(v.shape) for k, v in losses.items()
                if tuple(v.shape) != (B, T)}
    assert not badshape, ((B, T), badshape)
    imag_losses, img_out, imag_mets = self._imagination_objectives(
        obs, repfeat, entries[1], carry[1], training, draws)
    losses.update(imag_losses)
    metrics.update(imag_mets)
    if self.acfg.repval_loss:
      rv_losses, rv_mets = self._replay_value_objective(
          obs, repfeat, img_out, training)
      losses.update(rv_losses)
      metrics.update({f'reploss/{k}': v for k, v in rv_mets.items()})
    assert set(losses) == set(self.scales), (sorted(losses),
                                             sorted(self.scales))
    metrics.update({f'loss/{k}': v.mean() for k, v in losses.items()})
    total = sum(v.float().mean() * self.scales[k] for k, v in losses.items())
    outs = {'tokens': tokens, 'repfeat': repfeat, 'losses': losses}
    return total, (carry, entries, outs, metrics)

  def _world_model_objectives(self, carry, obs, prevact, training, draws):
    enc_carry, dyn_carry, dec_carry = carry
    reset = obs['is_first']
    losses, metrics = {}, {}
    enc_carry, enc_entries, tokens = self.enc(
        enc_carry, obs, reset, training)
    dyn_carry, dyn_entries, dyn_losses, repfeat, dyn_mets = self.dyn.loss(
        dyn_carry, tokens, prevact, reset, training, draws)
    losses.update(dyn_losses)
    metrics.update(dyn_mets)
    dec_carry, dec_entries, recons = self.dec(
        dec_carry, repfeat, reset, training)
    inp = _detach(self._feat2tensor(repfeat), skip=self.acfg.reward_grad)
    losses['rew'] = self.rew(inp, 2).loss(obs['reward'])
    con = (~obs['is_terminal']).float()
    if self.acfg.contdisc:
      con = con * (1 - 1 / self.acfg.horizon)
    losses['con'] = self.con(self._feat2tensor(repfeat), 2).loss(con)
    for key, recon in recons.items():
      space = self.obs_space[key]
      value = obs[key]
      target = value.float() / 255 if isimage(space) else value
      losses[key] = recon.loss(target.detach())
    carry = (enc_carry, dyn_carry, dec_carry)
    entries = (enc_entries, dyn_entries, dec_entries)
    return losses, metrics, carry, entries, tokens, repfeat

  def _imagination_objectives(
      self, obs, repfeat, dyn_entries, dyn_carry, training, draws):
    B, T = obs['is_first'].shape
    K = min(self.acfg.imag_last or T, T)
    H = self.acfg.imag_length
    # Roll imagination forward from the last K posterior states.
    starts = self.dyn.starts(dyn_entries, dyn_carry, K)
    policyfn = lambda feat, draws: self._sample(
        self.pol(self._feat2tensor(feat), 1), draws)
    # Offer the rollout kernel the policy weights; the RSSM takes the
    # one-call path when both sides are eligible.
    policyfn.fused_spec = self._fused_policy_spec
    # The rollout's outputs carry no gradient unless ac_grads.
    with torch.set_grad_enabled(
        torch.is_grad_enabled() and bool(self.acfg.ac_grads)):
      _, imgfeat, imgprevact = self.dyn.imagine(
          starts, policyfn, H, training, draws=draws)
    first = {k: v[:, -K:].reshape((B * K, 1, *v.shape[2:]))
             for k, v in repfeat.items()}
    imgfeat = _concat(
        [_detach(first, skip=self.acfg.ac_grads), _detach(imgfeat)], 1)
    lastact = policyfn({k: v[:, -1] for k, v in imgfeat.items()}, draws)
    imgact = _concat([imgprevact, {k: v[:, None] for k, v in
                                   lastact.items()}], 1)
    assert all(tuple(v.shape[:2]) == (B * K, H + 1)
               for v in imgfeat.values())
    inp = self._feat2tensor(imgfeat)
    heads = self._fused_imag_heads(inp)
    if heads is None:
      heads = dict(
          rew=self.rew(inp, 2), con=self.con(inp, 2), pol=self.pol(inp, 2),
          val=self.val(inp, 2), slowval=self.slowval(inp, 2))
    losses, img_out, metrics = ac.imag_loss(
        imgact, heads['rew'].pred(), heads['con'].prob(1), heads['pol'],
        heads['val'], heads['slowval'], self.retnorm, self.valnorm,
        self.advnorm, update=training, contdisc=self.acfg.contdisc,
        horizon=self.acfg.horizon, **dict(self.acfg.imag_loss))
    losses = {k: v.mean(1).reshape((B, K)) for k, v in losses.items()}
    img_out['K'] = K
    return losses, img_out, metrics

  def _replay_value_objective(self, obs, repfeat, img_out, training):
    B, T = obs['is_first'].shape
    K = img_out['K']
    feat = _detach(repfeat, skip=self.acfg.repval_grad)
    last, term, rew = obs['is_last'], obs['is_terminal'], obs['reward']
    boot = img_out['ret'][:, 0].reshape((B, K))
    feat = {k: v[:, -K:] for k, v in feat.items()}
    last, term, rew, boot = (x[:, -K:] for x in (last, term, rew, boot))
    inp = self._feat2tensor(feat)
    losses, _, metrics = ac.repl_loss(
        last, term, rew, boot, self.val(inp, 2), self.slowval(inp, 2),
        self.valnorm, update=training, horizon=self.acfg.horizon,
        **dict(self.acfg.repl_loss))
    return losses, metrics

  # --- Report -------------------------------------------------------------

  def report(self, carry, data, draws):
    """Metrics of a (B, T + replay_context) batch without updates: the
    losses and their metrics, under `report_gradnorms` the norm of each
    loss key's gradient over the trained parameters, and for each image
    key the open-loop video of the first min(6, B) sequences. Returns
    (carry, metrics)."""
    if not self.acfg.report:
      return carry, {}
    carry, obs, prevact, _ = self._resume_window(carry, data)
    _, dyn_carry, dec_carry = carry
    B, T = obs['is_first'].shape
    RB = min(6, B)
    gradnorms = bool(self.acfg.report_gradnorms)
    with torch.set_grad_enabled(gradnorms):
      _, (new_carry, _, outs, mets) = self.loss(
          carry, obs, prevact, False, draws)
    metrics = dict(mets)
    if gradnorms:
      # One backward per key through the graph of one loss computation:
      # the JAX model recomputes the loss per key with the same draws.
      params = [p for p in self.parameters() if p.requires_grad]
      for key in self.scales:
        grads = torch.autograd.grad(
            outs['losses'][key].float().mean(), params, retain_graph=True,
            allow_unused=True)
        metrics[f'gradnorm/{key}'] = torch.sqrt(sum(
            (g.float().square().sum() for g in grads if g is not None),
            torch.zeros((), device=self.device)))
    observed = lambda xs: {k: v[:RB, :T // 2] for k, v in xs.items()}
    imagined = lambda xs: {k: v[:RB, T // 2:] for k, v in xs.items()}
    with torch.no_grad():
      dyn_carry = {k: v[:RB] for k, v in dyn_carry.items()}
      dec_carry = {k: v[:RB] for k, v in dec_carry.items()}
      reset = obs['is_first'][:RB]
      dyn_carry, _, obsfeat = self.dyn.observe(
          dyn_carry, outs['tokens'][:RB, :T // 2], observed(prevact),
          reset[:, :T // 2], training=False, draws=draws)
      _, imgfeat, _ = self.dyn.imagine(
          dyn_carry, imagined(prevact), T - T // 2, training=False,
          draws=draws)
      _, _, obsrecons = self.dec(dec_carry, obsfeat, reset[:, :T // 2])
      _, _, imgrecons = self.dec(
          dec_carry, imgfeat, torch.zeros_like(reset[:, T // 2:]))
      for key in self.dec.imgkeys:
        metrics[f'openloop/{key}'] = ac.openloop_video(
            obs[key][:RB], obsrecons[key].pred(), imgrecons[key].pred(),
            split=T // 2)
    lastact = {k: data[k][:, -1] for k in self.act_space}
    return (*new_carry, lastact), metrics

  # --- Replay context -----------------------------------------------------

  def _resume_window(self, carry, data):
    """Split data into (carry, obs, prevact, stepid), resuming the carry
    from stored latents on windows that start mid-episode."""
    *wm_carry, prevact = carry
    stepid = data['stepid']
    obs = {k: data[k] for k in self.obs_space if k in data}
    shift = lambda head, rest: torch.cat([head[:, None], rest[:, :-1]], 1)
    prevact = {k: shift(prevact[k], data[k]) for k in self.act_space}
    K = self.config.replay_context
    if not K:
      return tuple(wm_carry), obs, prevact, stepid
    # The first K steps of each sampled window carry stored latents; use
    # them to rebuild a mid-episode carry instead of burning in.
    nested = tree.nestdict(data)
    context = lambda xs: {k: v[:, :K] for k, v in xs.items()}
    window = lambda xs: {k: v[:, K:] for k, v in xs.items()}
    resumed_carry = tuple(
        getattr(self, name).truncate(context(nested.get(name, {})), prior)
        for name, prior in zip(self.WM, wm_carry))
    resumed = (
        resumed_carry,
        window({k: data[k] for k in self.obs_space if k in data}),
        {k: data[k][:, K - 1:-1] for k in self.act_space},
        stepid[:, K:])
    flowing = (tuple(wm_carry), window(obs), window(prevact), stepid[:, K:])
    # Windows that continue the previous sample keep the flowing carry;
    # fresh windows graft the stored-latent carry.
    fresh = data['consec'][:, 0] == 0
    return nn.where(fresh, resumed, flowing)
