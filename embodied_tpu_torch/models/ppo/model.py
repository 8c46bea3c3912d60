"""PPO model: Impala CNN encoder, an optional GRU over the embedded
previous action, and the clipped surrogate loss.

Counterpart of embodied_tpu/models/ppo/model.py, with its store paths:
a recurrent policy that embeds the previous action, stored behaviour
log-probabilities, GAE advantages (a reverse loop over time where JAX
scans), the trust-region clip mask, value target clipping, and running
advantage and value normalizers. The products and convolutions are
plain PyTorch (`F.linear`, `F.conv2d`): the JAX model reaches no Pallas
kernel either. Under `replay_context` the GRU resumes from the stored
`memory` of the window's last context step, which the device-resident
latent table holds by default (`latent_keys`).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ... import nn
from ...utils import Space


def same_max_pool(x):
  """3 x 3 max pool with stride 2 and TensorFlow-style SAME padding on
  NHWC, as the JAX encoder's reduce_window: the padding is -inf, and of
  an odd total the extra row and column go last (at an even size one
  pixel at the end, none at the start)."""
  pads = []
  for size in reversed(x.shape[1:3]):
    total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
    pads += [total // 2, total - total // 2]
  x = F.pad(x.permute(0, 3, 1, 2), pads, value=float('-inf'))
  return F.max_pool2d(x, 3, 2).permute(0, 2, 3, 1)


class ImpalaEncoder(nn.Module):
  """Residual conv stacks for images plus an MLP for vector inputs;
  `width` is the output's."""

  def __init__(self, spaces, name='enc', depth=32, mults=(1, 2, 2),
               outmult=16, blocks=2, norm='none', act='relu', symlog=True,
               layers=5, units=512, winit='trunc_normal_in',
               cdtype=nn.COMPUTE_DTYPE, **kw):
    super().__init__(name, cdtype)
    assert all(len(s.shape) <= 3 for s in spaces.values()), spaces
    self.vecspaces = {k: v for k, v in spaces.items() if len(v.shape) <= 2}
    self.imgspaces = {k: v for k, v in spaces.items() if len(v.shape) == 3}
    self.depths = tuple(depth * m for m in mults)
    self.actfn = nn.act(act)
    kw = dict(winit=winit, cdtype=cdtype, **kw)
    self.width = 0
    if self.vecspaces:
      squish = nn.symlog if symlog else None
      self.emb = nn.DictEmbed(self.vecspaces, units, 'emb', squish=squish,
                              **kw)
      self.mlp = nn.MLP(units, layers - 1, units, 'mlp', act=act, norm=norm,
                        **kw)
      self.width += units
    if self.imgspaces:
      keys = sorted(self.imgspaces)
      height, width = self.imgspaces[keys[0]].shape[:2]
      din = sum(self.imgspaces[k].shape[-1] for k in keys)
      norm_ = lambda name, dim: self.child(
          nn.Norm(norm, name, dim, cdtype=cdtype))
      conv = lambda din, d, name: self.child(nn.Conv2D(din, d, 3, name, **kw))
      self.stages = []
      for s, d in enumerate(self.depths):
        stage = (conv(din, d, f's{s}in'), [
            (norm_(f's{s}b{b}n1', d), conv(d, d, f's{s}b{b}c1'),
             norm_(f's{s}b{b}n2', d), conv(d, d, f's{s}b{b}c2'))
            for b in range(blocks)])
        self.stages.append(stage)
        height, width, din = -(-height // 2), -(-width // 2), d
      flat = height * width * din
      self.outn1 = nn.Norm(norm, 'outn1', flat, cdtype=cdtype)
      self.outl = nn.Linear(flat, outmult * depth, 'outl', **kw)
      self.outn2 = nn.Norm(norm, 'outn2', outmult * depth, cdtype=cdtype)
      self.width += outmult * depth

  def forward(self, data, bdims=2):
    bshape = next(iter(data.values())).shape[:bdims]
    outs = []
    if self.vecspaces:
      x = self.emb({k: data[k] for k in self.vecspaces}, bshape)
      outs.append(self.mlp(x.reshape((-1, x.shape[-1]))))
    if self.imgspaces:
      x = torch.cat([data[k] for k in sorted(self.imgspaces)], -1)
      assert x.dtype == torch.uint8, x.dtype
      x = self.cast(x, force=True) / 255 - 0.5
      x = x.reshape((-1, *x.shape[-3:]))
      for conv_in, blocks in self.stages:
        x = same_max_pool(conv_in(x))
        for n1, c1, n2, c2 in blocks:
          skip = x
          x = c1(self.actfn(n1(x)))
          x = c2(self.actfn(n2(x)))
          x = x + skip
      # NHWC flattens as (h, w, c), the JAX `outl/kernel`'s row order.
      x = x.reshape((x.shape[0], -1))
      x = self.actfn(self.outn1(x))
      x = self.actfn(self.outn2(self.outl(x)))
      outs.append(x)
    x = torch.cat(outs, -1)
    return x.reshape((*bshape, -1))


def clip_action(x):
  """x / max(1, |x|), the denominator without gradient."""
  return x / torch.clamp(x.abs(), min=1).detach()


class Model(nn.Module):
  """PPO under the Agent contract."""

  SCOPES = ('enc', 'actemb', 'rnn', 'policy', 'value')

  def __init__(self, obs_space, act_space, config, cdtype=nn.COMPUTE_DTYPE):
    super().__init__('model', cdtype)
    exclude = ('is_first', 'is_last', 'is_terminal', 'reward')
    self.obs_space = obs_space
    self.act_space = {k: v for k, v in act_space.items() if k != 'reset'}
    self.enc_space = {
        k: v for k, v in obs_space.items()
        if k not in exclude and not k.startswith('log/')}
    self.config = config
    acfg = config.agent
    self.acfg = acfg
    self.recurrent = acfg.recurrent
    self.rnnact = acfg.rnnact

    self.enc = {'impala': ImpalaEncoder}[acfg.enc.typ](
        self.enc_space, 'enc', cdtype=cdtype, **dict(acfg.enc[acfg.enc.typ]))
    featdim = self.enc.width
    if self.recurrent:
      inputs = featdim
      if self.rnnact:
        self.actemb = nn.DictEmbed(
            self.act_space, acfg.actemb.units, 'actemb', squish=clip_action,
            cdtype=cdtype)
        inputs += acfg.actemb.units
      self.rnn = nn.GRU(inputs, acfg.rnn.units, 'rnn', norm=acfg.rnn.norm,
                        winit=acfg.rnn.winit, cdtype=cdtype)
      featdim = acfg.rnn.units
    d1, d2 = acfg.policy_dist_disc, acfg.policy_dist_cont
    outputs = {k: d1 if v.discrete else d2 for k, v in self.act_space.items()}
    policy = nn.MLPHead(
        self.act_space, outputs, 'policy', featdim, cdtype=cdtype,
        **dict(acfg.policy))
    # The head's store scope is `policy`, the name of the Agent's entry
    # point on this class: it is registered under that name directly and
    # called as `policy_head`.
    self._modules['policy'] = policy
    self.__dict__['policy_head'] = policy
    vcfg = {k: v for k, v in dict(acfg.value).items() if k != 'output'}
    self.value = nn.MLPHead(
        Space(np.float32, ()), acfg.value.output, 'value', featdim,
        cdtype=cdtype, **vcfg)
    self.advnorm = nn.Normalize(**dict(acfg.advnorm), name='advnorm')
    self.valnorm = nn.Normalize(**dict(acfg.valnorm), name='valnorm')
    ocfg = dict(acfg.opt)
    self.opt = nn.Optimizer(
        nn.scope_params(self, self.SCOPES), 'opt',
        lr=ocfg.get('lr', 3e-4), eps=ocfg.get('eps', 1e-7),
        agc=ocfg.get('agc', 0.3), wd=ocfg.get('wd', 0.0),
        warmup=ocfg.get('warmup', 1000), scaling=cdtype == torch.float16)

  @property
  def device(self):
    return next(self.parameters()).device

  @property
  def policy_keys(self):
    return r'^(enc|actemb|rnn|policy)/'

  @property
  def partition_rules(self):
    """Placements of the store over the mesh (parallel/meshes.py), as in
    the JAX model."""
    return [
        (r'/(kernel|embed)$', (None, ('f', 't'))),
    ]

  @property
  def ext_space(self):
    spaces = {'consec': Space(np.int32), 'stepid': Space(np.uint8, 20)}
    for key in self.act_space:
      spaces[f'logp/{key}'] = Space(np.float32)
    if self.recurrent and self.config.replay_context:
      spaces['memory'] = Space(np.float32, self.acfg.rnn.units)
    return spaces

  @property
  def latent_keys(self):
    """The GRU state is table-eligible (device-resident, see
    parallel/latents.py); the behaviour logp columns are training data
    and stay in the replay."""
    if self.recurrent and self.config.replay_context:
      return ('memory',)
    return ()

  # --- Carries ------------------------------------------------------------

  def init_policy(self, batch_size):
    device = self.device
    prevact = {k: torch.zeros((batch_size, *v.shape),
                              dtype=nn.torch_dtype(v.dtype), device=device)
               for k, v in self.act_space.items()}
    memory = self.rnn.initial(batch_size, device) if self.recurrent else ()
    return memory, prevact

  def init_train(self, batch_size):
    return self.init_policy(batch_size)

  def init_report(self, batch_size):
    return ()

  # --- Forward ------------------------------------------------------------

  def _forward(self, carry, obs, prevact, value=True, single=False):
    bdims = 1 if single else 2
    bshape = obs['is_first'].shape[:bdims]
    embed = self.enc(obs, bdims=bdims)
    if self.recurrent:
      inputs = embed
      if self.rnnact:
        prevact = nn.mask(prevact, ~obs['is_first'])
        inputs = torch.cat([embed, self.actemb(prevact, bshape)], -1)
      carry, feat = self.rnn(carry, inputs, obs['is_first'], single=single)
    else:
      feat = embed
    policy = self.policy_head(feat, bdims=bdims)
    val = self.value(feat, bdims=bdims) if value else None
    return carry, feat, policy, val

  def policy(self, carry, obs, mode='train', gen=None):
    memory, prevact = carry
    memory, _, policy, _ = self._forward(
        memory, obs, prevact, value=False, single=True)
    act = {k: v.sample(gen).to(nn.torch_dtype(self.act_space[k].dtype))
           for k, v in policy.items()}
    out = {f'logp/{k}': policy[k].logp(act[k]) for k in act}
    if self.recurrent:
      out['memory'] = memory.float()
    return (memory, act), act, out

  # --- Training -----------------------------------------------------------

  def train_step(self, carry, data, draws=None):
    """One train step on a (B, T + replay_context) batch of device
    tensors; PPO draws no noise. Returns (carry, {}, metrics)."""
    memory, prevact = carry
    K = self.config.replay_context
    if K:
      prevact = {k: data[k][:, K - 1:-1] for k in self.act_space}
      if self.recurrent:
        # The state stored after the last context step, index K - 1 of
        # the whole window (the first trained step is K).
        memory = self.cast(data['memory'][:, K - 1])
      data = {k: v[:, K:] for k, v in data.items() if k != 'memory'}
    else:
      prepend = lambda x, y: torch.cat([x[:, None], y[:, :-1]], 1)
      prevact = {k: prepend(prevact[k], data[k]) for k in self.act_space}
    mets, (memory, extra) = self.opt(self.loss, memory, data, prevact)
    mets.update(extra)
    prevact = {k: data[k][:, -1] for k in self.act_space}
    return (memory, prevact), {}, mets

  def loss(self, memory, data, prevact):
    memory, _, policy, value = self._forward(memory, data, prevact)
    losses, metrics = ppo_loss(
        data, policy, value, self.advnorm, self.valnorm, self.act_space,
        update=True, **dict(self.acfg.ppo_loss))
    for k, v in losses.items():
      metrics[f'{k}_loss'] = v.mean()
    scales = self.acfg.loss_scales
    loss = sum(v.mean() * scales[k] for k, v in losses.items())
    return loss.float(), (memory, metrics)

  def report(self, carry, data, draws=None):
    return carry, {}


def gae_advantages(rew, live, cont, val):
  """GAE as a reverse loop over time: adv_t = delta_t + live_t cont_t
  adv_{t+1}, from zero after the last step."""
  delta = rew[:, 1:] + live * val[:, 1:] - val[:, :-1]
  decay = live * cont
  adv = torch.zeros_like(delta[:, 0])
  advs = []
  for t in reversed(range(delta.shape[1])):
    adv = delta[:, t] + decay[:, t] * adv
    advs.append(adv)
  return torch.stack(advs[::-1], 1)


def ppo_loss(
    data, policy, value, advnorm, valnorm, act_space, update,
    actent=1e-2, hor=200, lam=0.8, trclip=0.2, tarclip=10.0):
  metrics = {}
  losses = {}

  logpi = sum(policy[k].logp(data[k]) for k in act_space)
  logdata = sum(data['logp/' + k] for k in act_space)

  rew, last, term = data['reward'], data['is_last'], data['is_terminal']
  mask = (~last & ~term).float()
  ratio = torch.exp(logpi - logdata.detach())
  voffset, vscale = valnorm.stats()
  val = value.pred() * vscale + voffset

  live = (~term).float()[:, 1:] * (1 - 1 / hor)
  cont = (~last & ~term).float()[:, 1:] * lam
  adv = gae_advantages(rew, live, cont, val)
  tar = adv + val[:, :-1]

  voffset, vscale = valnorm(tar, update)
  tarnormed = (tar - voffset) / vscale
  if tarclip:
    tarnormed = torch.clamp(tarnormed, -tarclip, tarclip)
  padded = torch.cat([tarnormed, 0 * tarnormed[:, :1]], 1)
  losses['value'] = value.loss(padded.detach()) * mask

  aoffset, ascale = advnorm(adv, update)
  advnormed = (adv - aoffset) / ascale
  reinforce = ratio[:, :-1] * advnormed.detach()
  ents = {k: policy[k].entropy() for k in act_space}
  maxent = actent * sum(ents.values())[:, :-1]

  upper = (ratio[:, :-1] < 1 + trclip) | (advnormed < 0)
  lower = (ratio[:, :-1] > 1 - trclip) | (advnormed > 0)
  tr = (upper & lower).float()
  losses['policy'] = -(reinforce + maxent) * mask[:, :-1] * tr

  for k in act_space:
    metrics[f'ent/{k}'] = ents[k].mean()
    if hasattr(policy[k], 'minent'):
      lo, hi = policy[k].minent, policy[k].maxent
      metrics[f'rand/{k}'] = (ents[k].mean() - lo) / max(hi - lo, 1e-8)

  metrics['rew'] = rew.mean()
  metrics['val'] = val.mean()
  metrics['tar'] = tar.mean()
  metrics['adv'] = adv.mean()
  metrics['advmag'] = adv.abs().mean()
  metrics['ratio'] = ratio.mean()
  metrics['clipfrac'] = (1 - tr).mean()
  metrics['td'] = (value.pred()[:, :-1] - tarnormed).abs().mean()
  return losses, metrics
