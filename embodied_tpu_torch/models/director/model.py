"""Director: a hierarchical agent with a goal VAE, a manager and a worker.

Counterpart of embodied_tpu/models/director/model.py, with its store
paths: a goal autoencoder compresses deter states into discrete skill
codes; the manager picks a skill every `skill_duration` steps and is
trained on the imagined trajectory at the skill's timescale; the worker
acts towards the decoded goal and is trained on extrinsic, exploration
and goal-similarity rewards. The world model is DreamerV3's RSSM,
Encoder and Decoder, so Director runs the same kernels: its policy calls
take the observe step (kernel 3), its world-model loss the observe
window forward and backward (kernels 5 and 6), and each step of its
hierarchy rollout a core step (kernel 1), where the RSSM's structure and
widths allow (see rssm.py).

The rollouts are Python loops over `imag_length` (nn.scan in JAX). They
run without autograd where every action is discrete, since nothing in
the rollout then carries a gradient: the starts, skills and goals are
stopped and a categorical sample has none. With a continuous action the
worker's reparameterized sample carries its gradient through the
dynamics, as in JAX. Noise is drawn in the JAX order: per rollout step
the manager's, the worker's, then the state's.
"""

import numpy as np
import torch

from ... import nn
from ...nn import dists
from ...utils import Space, tree
from ..dreamerv3 import rssm
from ..dreamerv3.ac import lambda_return
from . import expl

isimage = lambda s: s.dtype == np.uint8 and len(s.shape) == 3


def sample(dist, draws):
  """A sample of `dist` (a categorical family or a normal, optionally
  aggregated) with its noise from `draws`."""
  inner = dist._inner if isinstance(dist, dists.Agg) else dist
  if isinstance(inner, (dists.Categorical, dists.OneHot)):
    return dist.sample(noise=draws.gumbel(inner.logits.shape))
  return dist.sample(noise=draws.normal(inner.pred().shape))


class ActorCritic(nn.Module):
  """Imagination actor-critic with one critic per reward stream, each
  with an EMA target; the actor is trained on the weighted sum of
  advantages, each normalized by its stream's return normalizer in
  `retnorms`. As in the JAX model those normalizers are the Model's
  (`retnorm_<stream>` at the store's root), shared by every actor-critic
  that has the stream."""

  def __init__(self, name, act_space, rewards, scales, config, inputs, din,
               retnorms, cdtype=nn.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    self.act_space = act_space
    self.rewards = tuple(rewards)
    self.scales = dict(scales)
    self.inputs = tuple(inputs)
    self.horizon = config['horizon']
    self.lam = config['lam']
    self.actent = config['actent']
    self.slowreg = config['slowreg']
    d1, d2 = config['dist_disc'], config['dist_cont']
    outs = {k: d1 if v.discrete else d2 for k, v in act_space.items()}
    hkw = dict(layers=config['layers'], units=config['units'],
               act=config['act'], norm=config['norm'], cdtype=cdtype)
    self.actor = nn.MLPHead(
        act_space, outs, 'actor', din, unimix=config['unimix'],
        outscale=config['outscale'], minstd=config.get('minstd', 0.1),
        maxstd=config.get('maxstd', 1.0), **hkw)
    critic = lambda name: self.child(nn.MLPHead(
        Space(np.float32, ()), 'symexp_twohot', name, din,
        bins=config['bins'], outscale=0.0, **hkw))
    self.critics = {k: critic(f'critic_{k}') for k in self.rewards}
    self.slow = {
        k: self.child(nn.SlowModel(
            critic(f'slow_{k}'), self.critics[k], rate=config['slowrate']))
        for k in self.rewards}
    self.retnorms = {k: retnorms[k] for k in self.rewards}

  def feat(self, traj, bdims=2):
    return torch.cat([
        self.cast(traj[k]).reshape((*traj[k].shape[:bdims], -1))
        for k in self.inputs], -1)

  def policy_dist(self, feat, bdims=1):
    return self.actor(feat, bdims=bdims)

  def loss(self, traj, cont):
    """traj: the `inputs` keys, `act_<key>` and `rew_<name>`, each
    (B, H, ...). Returns (losses, metrics)."""
    metrics = {}
    feat = self.feat(traj)
    disc = 1 - 1 / self.horizon
    weight = (torch.cumprod(disc * cont, 1) / disc).detach()
    last = torch.zeros_like(cont)
    term = 1 - cont
    advs, vlosses = [], []
    for key in self.rewards:
      rew = traj[f'rew_{key}'].float()
      value = self.critics[key](feat, 2)
      slowvalue = self.slow[key](feat, 2)
      val = value.pred()
      ret = lambda_return(last, term, rew, val, val, disc, self.lam)
      _, scale = self.retnorms[key](ret, update=True)
      adv = (ret - val[:, :-1]) / scale
      advs.append(adv * self.scales.get(key, 1.0))
      tar = torch.cat([ret, 0 * ret[:, -1:]], 1)
      vloss = weight[:, :-1] * (
          value.loss(tar.detach()) +
          self.slowreg * value.loss(slowvalue.pred().detach()))[:, :-1]
      vlosses.append(vloss)
      metrics[f'ret_{key}'] = ret.mean()
      metrics[f'val_{key}'] = val.mean()
    adv = sum(advs).detach()
    policy = self.policy_dist(feat, bdims=2)
    acts = {k: traj[f'act_{k}'] for k in self.act_space}
    logpi = sum(v.logp(acts[k].detach())[:, :-1] for k, v in policy.items())
    ents = {k: v.entropy()[:, :-1] for k, v in policy.items()}
    actor_loss = weight[:, :-1] * -(
        logpi * adv + self.actent * sum(ents.values()))
    metrics['actor_ent'] = sum(e.mean() for e in ents.values())
    losses = {'actor': actor_loss, 'critic': sum(vlosses)}
    return losses, metrics

  def update_slow(self):
    for slow in self.slow.values():
      slow.update()


class Model(nn.Module):
  """Director under the Agent contract."""

  WM = ('enc', 'dyn', 'dec', 'rew', 'con')
  AC = ('worker/actor', 'worker/critic_extr', 'worker/critic_expl',
        'worker/critic_goal', 'manager/actor', 'manager/critic_extr',
        'manager/critic_expl', 'manager/critic_goal')

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
    self.enc = rssm.Encoder(spaces, 'enc', cdtype=cdtype, **dict(acfg.enc))
    self.dyn = rssm.RSSM(self.act_space, 'dyn', token_dim=self.enc.token_dim,
                         cdtype=cdtype, **dict(acfg.rssm))
    deter, S, C = self.dyn.deter, self.dyn.stoch, self.dyn.classes
    self.dec = rssm.Decoder(spaces, 'dec', feat_dims=(deter, S * C),
                            cdtype=cdtype, **dict(acfg.dec))
    featdim = deter + S * C

    scalar = Space(np.float32, ())
    binary = Space(bool, (), 0, 2)
    hkw = dict(layers=acfg.headlayers, units=acfg.units, act=acfg.act,
               norm=acfg.norm, cdtype=cdtype)
    self.rew = nn.MLPHead(scalar, 'symexp_twohot', 'rew', featdim,
                          bins=acfg.bins, outscale=0.0, **hkw)
    self.con = nn.MLPHead(binary, 'binary', 'con', featdim, **hkw)

    self.skill_shape = tuple(acfg.skill_shape)  # (codes, classes)
    codes, classes = self.skill_shape
    # Discrete skills; onehot heads give (codes, classes) one-hot samples
    # with straight-through gradients.
    self.skill_space = Space(np.int32, (codes,), 0, classes)
    self.deter = deter
    self.goal_enc = nn.MLPHead(
        self.skill_space, 'onehot', 'goal_enc', deter, unimix=0.0, **hkw)
    self.goal_dec = nn.MLPHead(
        Space(np.float32, (deter,)), 'mse', 'goal_dec', codes * classes,
        **hkw)

    streams = ('extr', 'expl', 'goal') + (
        ('disag',) if acfg.expl_behavior == 'explore' else ())
    retnorms = {k: self.child(nn.Normalize(
        'perc', f'retnorm_{k}', rate=0.01, limit=1.0)) for k in streams}
    accfg = dict(
        horizon=acfg.horizon, lam=acfg.lam, slowreg=1.0, slowrate=0.02,
        layers=acfg.aclayers, units=acfg.units, act=acfg.act,
        norm=acfg.norm, bins=acfg.bins, unimix=0.01, outscale=0.01,
        dist_disc='categorical', dist_cont='bounded_normal')
    self.worker = ActorCritic(
        'worker', self.act_space, ('extr', 'expl', 'goal'),
        dict(acfg.worker_rews), dict(accfg, actent=acfg.worker_actent),
        ('deter', 'stoch_flat', 'goal'), featdim + deter, retnorms,
        cdtype=cdtype)
    self.manager = ActorCritic(
        'manager', {'skill': self.skill_space}, ('extr', 'expl', 'goal'),
        dict(acfg.manager_rews),
        dict(accfg, actent=acfg.manager_actent, dist_disc='onehot'),
        ('deter', 'stoch_flat'), featdim, retnorms, cdtype=cdtype)

    self.skill_duration = acfg.skill_duration
    self.imag_length = acfg.imag_length
    scales = dict(acfg.loss_scales)
    rec = scales.pop('rec')
    scales.update({k: rec for k in spaces})
    self.scales = scales

    # Exploration: the disagreement ensemble feeds the worker's expl
    # reward or a flat Explore behaviour; or a Random behaviour.
    self.expl_behavior = acfg.expl_behavior
    self.expl_rew = acfg.expl_rew
    assert self.expl_behavior in ('none', 'explore', 'random'), (
        self.expl_behavior)
    assert self.expl_rew in ('vae', 'disag'), self.expl_rew
    self.disag = None
    if self.expl_rew == 'disag' or self.expl_behavior == 'explore':
      self.disag = expl.Disag('disag', self.act_space, deter, S * C,
                              cdtype=cdtype, **dict(acfg.disag))
    if self.expl_behavior == 'explore':
      self.expl = ActorCritic(
          'expl', self.act_space, ('extr', 'disag'),
          dict(acfg.expl_rewards), dict(accfg, actent=acfg.worker_actent),
          ('deter', 'stoch_flat'), featdim, retnorms, cdtype=cdtype)
    elif self.expl_behavior == 'random':
      self.random_behavior = expl.RandomBehavior(self.act_space)

    scaling = cdtype == torch.float16
    opt = lambda scopes, name, cfg: nn.Optimizer(
        nn.scope_params(self, scopes), name, scaling=scaling, **dict(cfg))
    self.opt = opt(self.WM, 'opt', acfg.opt)
    self.goal_opt = opt(('goal_enc', 'goal_dec'), 'goal_opt', acfg.goal_opt)
    self.ac_opt = opt(self.AC, 'ac_opt', acfg.ac_opt)
    if self.disag is not None:
      self.disag_opt = opt(('disag',), 'disag_opt', acfg.expl_opt)
    if self.expl_behavior == 'explore':
      self.expl_ac_opt = opt(
          ('expl/actor', 'expl/critic_extr', 'expl/critic_disag'),
          'expl_ac_opt', acfg.ac_opt)
    # Whether a rollout step carries a gradient: only through a
    # continuous action's reparameterized sample.
    self.rollout_grad = not all(
        s.discrete for s in self.act_space.values())

  @property
  def device(self):
    return next(self.parameters()).device

  @property
  def policy_modes(self):
    return ('explore',) if self.expl_behavior != 'none' else ()

  @property
  def policy_keys(self):
    return r'^(enc|dyn|goal_dec|manager|worker|expl)/'

  @property
  def ext_space(self):
    spaces = {'consec': Space(np.int32), 'stepid': Space(np.uint8, 20)}
    if self.config.replay_context:
      spaces.update(tree.flatdict(dict(dyn=self.dyn.entry_space)))
    return spaces

  # --- Carries ------------------------------------------------------------

  def _hier_initial(self, batch_size, device):
    return {
        'step': torch.zeros((batch_size,), dtype=torch.int32, device=device),
        'skill': torch.zeros((batch_size, *self.skill_shape), device=device),
        'goal': torch.zeros((batch_size, self.deter), device=device)}

  def init_policy(self, batch_size):
    device = self.device
    zeros = lambda s: torch.zeros(
        (batch_size, *s.shape), dtype=nn.torch_dtype(s.dtype), device=device)
    return (self.dyn.initial(batch_size, device),
            self._hier_initial(batch_size, device),
            {k: zeros(v) for k, v in self.act_space.items()})

  def init_train(self, batch_size):
    return self.init_policy(batch_size)

  def init_report(self, batch_size):
    return self.init_policy(batch_size)

  # --- Hierarchical policy ------------------------------------------------

  def _stoch_flat(self, feat):
    stoch = self.cast(feat['stoch'])
    return stoch.reshape((*stoch.shape[:-2], -1))

  def _feat2tensor(self, feat):
    return torch.cat([self.cast(feat['deter']), self._stoch_flat(feat)], -1)

  def _hier_step(self, feat, hier, draws, duration):
    """One hierarchy step on flat (B, ...) features. Returns the action,
    the skill and goal in effect, and the new hierarchy carry. The manager
    samples every step (its noise is drawn whether or not the skill is
    due), then the worker."""
    fresh = (hier['step'] % duration) == 0
    deter = self.cast(feat['deter'])
    stoch_flat = self._stoch_flat(feat)
    mdist = self.manager.policy_dist(torch.cat([deter, stoch_flat], -1))
    new_skill = sample(mdist['skill'], draws).float().detach()
    skill = nn.where(fresh, new_skill, hier['skill'])
    flat_skill = skill.reshape((skill.shape[0], -1))
    new_goal = self.goal_dec(
        self.cast(flat_skill), bdims=1).pred().float().detach()
    goal = nn.where(fresh, new_goal, hier['goal'])
    wdist = self.worker.policy_dist(
        torch.cat([deter, stoch_flat, self.cast(goal)], -1))
    act = {k: sample(v, draws) for k, v in wdist.items()}
    act = {k: v.to(nn.torch_dtype(self.act_space[k].dtype))
           if self.act_space[k].discrete else v for k, v in act.items()}
    hier = {'step': hier['step'] + 1, 'skill': skill, 'goal': goal}
    return act, skill, goal, hier

  def policy(self, carry, obs, mode='train', gen=None):
    dyn_carry, hier, prevact = carry
    draws = dists.Draws(gen, obs['is_first'].device)
    reset = obs['is_first']
    _, _, tokens = self.enc({}, obs, reset, training=False, single=True)
    dyn_carry, _, feat = self.dyn.observe(
        dyn_carry, tokens, prevact, reset, training=False, single=True,
        gen=gen)
    hier = nn.where(reset, {k: torch.zeros_like(v) for k, v in hier.items()},
                    hier)
    if mode == 'explore' and self.expl_behavior == 'explore':
      dist = self.expl.policy_dist(self._feat2tensor(feat))
      act = {k: sample(v, draws) for k, v in dist.items()}
      act = {k: v.to(nn.torch_dtype(self.act_space[k].dtype))
             if self.act_space[k].discrete else v for k, v in act.items()}
    elif mode == 'explore' and self.expl_behavior == 'random':
      act = self.random_behavior.policy(feat, gen)
    else:
      act, _, _, hier = self._hier_step(
          feat, hier, draws, self.acfg.env_skill_duration)
    out = {}
    if self.config.replay_context:
      out.update(tree.flatdict(dict(dyn=self.dyn.entry_pack(
          {'deter': feat['deter'], 'stoch': feat['stoch']}))))
    return (dyn_carry, hier, act), act, out

  # --- Training -----------------------------------------------------------

  def train_step(self, carry, data, draws):
    """One train step on a (B, T + replay_context) batch of device
    tensors: the world model, the goal VAE, the manager and worker, then
    the slow critics, then the disagreement ensemble and the Explore
    behaviour where configured. Returns (carry, outs, metrics); outs
    ['replay'] holds the refreshed packed latents and stepid."""
    dyn_carry, obs, prevact, stepid = self._resume_window(carry, data)
    metrics, (dyn_carry, dyn_entries, repfeat) = self.opt(
        self.wm_loss, dyn_carry, obs, prevact, draws)
    repfeat = {k: v.detach() for k, v in repfeat.items()}
    metrics.update(self.goal_opt(self.vae_loss, repfeat, draws)[0])
    mets, extra = self.ac_opt(self.hier_loss, repfeat, obs, draws)
    metrics.update(mets)
    metrics.update(extra)
    self.worker.update_slow()
    self.manager.update_slow()
    if self.disag is not None:
      metrics.update(self.disag_opt(self.disag_loss, repfeat, prevact)[0])
    if self.expl_behavior == 'explore':
      mets, extra = self.expl_ac_opt(self.expl_loss, repfeat, draws)
      self.expl.update_slow()
      metrics.update(mets)
      metrics.update({f'expl_{k}': v for k, v in extra.items()})
    outs = {}
    if self.config.replay_context:
      updates = tree.flatdict(dict(dyn=self.dyn.entry_pack(dyn_entries)))
      updates['stepid'] = stepid
      outs['replay'] = updates
    lastact = {k: data[k][:, -1] for k in self.act_space}
    dyn_carry = {k: v.detach() for k, v in dyn_carry.items()}
    return (dyn_carry, carry[1], lastact), outs, metrics

  def _resume_window(self, carry, data):
    """Split data into (dyn_carry, obs, prevact, stepid) of the trained
    window; a window that starts an episode's sample afresh (consec 0)
    resumes its carry from the stored latents of its context steps."""
    dyn_carry, _, prevact = carry
    stepid = data['stepid']
    obs = {k: data[k] for k in self.obs_space if k in data}
    shift = lambda head, rest: torch.cat([head[:, None], rest[:, :-1]], 1)
    prevact = {k: shift(prevact[k], data[k]) for k in self.act_space}
    K = self.config.replay_context
    if not K:
      return dyn_carry, obs, prevact, stepid
    window = lambda xs: {k: v[:, K:] for k, v in xs.items()}
    entries = tree.nestdict(data).get('dyn', {})
    resumed = self.dyn.truncate({k: v[:, :K] for k, v in entries.items()})
    fresh = data['consec'][:, 0] == 0
    dyn_carry, prevact = nn.where(
        fresh, (resumed, {k: data[k][:, K - 1:-1] for k in self.act_space}),
        (dyn_carry, window(prevact)))
    return dyn_carry, window(obs), prevact, stepid[:, K:]

  def wm_loss(self, dyn_carry, obs, prevact, draws):
    losses = {}
    reset = obs['is_first']
    _, _, tokens = self.enc({}, obs, reset, training=True)
    dyn_carry, entries, dyn_losses, repfeat, _ = self.dyn.loss(
        dyn_carry, tokens, prevact, reset, True, draws)
    losses.update(dyn_losses)
    _, _, recons = self.dec({}, repfeat, reset, training=True)
    inp = self._feat2tensor(repfeat)
    losses['rew'] = self.rew(inp, 2).loss(obs['reward'])
    con = (~obs['is_terminal']).float() * (1 - 1 / self.acfg.horizon)
    losses['con'] = self.con(inp, 2).loss(con)
    for key, recon in recons.items():
      space, value = self.obs_space[key], obs[key]
      target = value.float() / 255 if isimage(space) else value
      losses[key] = recon.loss(target.detach())
    loss = sum(v.float().mean() * self.scales.get(k, 1.0)
               for k, v in losses.items())
    return loss.float(), (dyn_carry, entries, repfeat)

  def vae_loss(self, repfeat, draws):
    codes, classes = self.skill_shape
    goal = repfeat['deter'].float().detach()
    B, T = goal.shape[:2]
    flat = goal.reshape((B * T, -1))
    enc = self.goal_enc(self.cast(flat), bdims=1)
    skill = sample(enc, draws)
    dec = self.goal_dec(self.cast(skill.reshape((B * T, -1))), bdims=1)
    rec = dec.loss(flat).float()
    prior = dists.Agg(dists.OneHot(
        torch.zeros((B * T, codes, classes), device=goal.device)), 1)
    kl = torch.clamp(enc.kl(prior).float(), min=self.acfg.goal_kl_free)
    return (rec + self.acfg.goal_kl_scale * kl).mean().float(), {}

  def _observed_traj(self, repfeat, prevact):
    """A replay batch as a trajectory for the ensemble: act_<key> is the
    action taken at each step (prevact shifted left)."""
    acts = {f'act_{k}': torch.cat([v[:, 1:], v[:, -1:]], 1)
            for k, v in prevact.items()}
    return {'deter': repfeat['deter'],
            'stoch_flat': self._stoch_flat(repfeat), **acts}

  def disag_loss(self, repfeat, prevact):
    return self.disag.loss(self._observed_traj(repfeat, prevact)).float(), {}

  def _starts(self, repfeat):
    B, T = repfeat['deter'].shape[:2]
    return {k: self.cast(v.reshape((B * T, *v.shape[2:]))).detach()
            for k, v in repfeat.items() if k in ('deter', 'stoch')}

  def _rollout(self, step, carry):
    """`imag_length` steps of `step(carry) -> (carry, out)`, with the
    outputs stacked on axis 1; without autograd unless a continuous
    action carries a gradient through the dynamics."""
    outs = []
    with torch.set_grad_enabled(
        torch.is_grad_enabled() and self.rollout_grad):
      for _ in range(self.imag_length):
        carry, out = step(carry)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}

  def expl_loss(self, repfeat, draws):
    """The flat Explore behaviour: the imagination actor-critic on the
    extrinsic and disagreement rewards."""
    def step(latent):
      dist = self.expl.policy_dist(self._feat2tensor(latent))
      act = {k: sample(v, draws).detach() for k, v in dist.items()}
      act = {k: v.to(nn.torch_dtype(self.act_space[k].dtype))
             if self.act_space[k].discrete else v for k, v in act.items()}
      latent, (feat, _) = self.dyn.imagine_single(latent, act, draws)
      return latent, {'deter': feat['deter'], 'stoch': feat['stoch'],
                      **{f'act_{k}': v for k, v in act.items()}}
    with torch.no_grad():
      traj = self._rollout(step, self._starts(repfeat))
      traj['stoch_flat'] = self._stoch_flat(traj)
      inp = self._feat2tensor(traj)
      traj['rew_extr'] = self.rew(inp, 2).pred().float()
      traj['rew_disag'] = self.disag.reward(traj)
      cont = self.con(inp, 2).prob(1).float()
    losses, metrics = self.expl.loss(traj, cont)
    loss = sum(v.float().mean() for v in losses.values())
    metrics.update({f'loss/expl_{k}': v.mean() for k, v in losses.items()})
    return loss.float(), metrics

  def hier_loss(self, repfeat, obs, draws):
    """The imagination rollout under the hierarchy; the worker's and the
    manager's losses."""
    H, K = self.imag_length, self.skill_duration
    starts = self._starts(repfeat)
    nstart = starts['deter'].shape[0]

    def step(carry):
      latent, hier = carry
      act, skill, goal, hier = self._hier_step(latent, hier, draws, K)
      latent, (feat, _) = self.dyn.imagine_single(latent, act, draws)
      return (latent, hier), {
          'deter': feat['deter'], 'stoch': feat['stoch'],
          'act_skill': skill, 'goal': goal,
          **{f'act_{k}': v for k, v in act.items()}}
    traj = self._rollout(
        step, (starts, self._hier_initial(nstart, starts['deter'].device)))
    traj['stoch_flat'] = self._stoch_flat(traj)
    traj['goal'] = traj['goal'].float()
    # The rewards and the continuation carry no gradient into the loss:
    # they reach it only through stopped returns and weights.
    with torch.no_grad():
      inp = self._feat2tensor(traj)
      rew_extr = self.rew(inp, 2).pred().float()
      cont = self.con(inp, 2).prob(1).float()
      feat_deter = traj['deter'].float()
      goal = traj['goal']
      gnorm = torch.linalg.norm(goal, dim=-1, keepdim=True) + 1e-12
      fnorm = torch.linalg.norm(feat_deter, dim=-1, keepdim=True) + 1e-12
      norm = torch.maximum(gnorm, fnorm)
      rew_goal = ((goal / norm) * (feat_deter / norm)).sum(-1)
      if self.expl_rew == 'disag':
        # Plan2Explore: the disagreement of the one-step ensemble.
        rew_expl = self.disag.reward(traj)
      else:
        # The goal VAE's reconstruction error (a novelty signal).
        flat = feat_deter.reshape((nstart * H, -1))
        enc = self.goal_enc(self.cast(flat), bdims=1)
        dec = self.goal_dec(self.cast(sample(enc, draws).reshape(
            (nstart * H, -1))), bdims=1)
        rew_expl = (dec.pred() - flat).square().mean(-1).float().reshape(
            (nstart, H))
    traj.update(rew_extr=rew_extr, rew_expl=rew_expl, rew_goal=rew_goal)

    losses, metrics = {}, {}
    wl, wm = self.worker.loss(traj, cont)
    losses.update({f'worker_{k}': v for k, v in wl.items()})
    metrics.update({f'worker_{k}': v for k, v in wm.items()})

    # The manager acts at the skill's timescale: every K-th step.
    HH = (H // K) * K

    def down(x, how):
      x = x[:, :HH].reshape((x.shape[0], HH // K, K, *x.shape[2:]))
      return {'first': lambda: x[:, :, 0], 'sum': lambda: x.sum(2),
              'prod': lambda: x.prod(2)}[how]()
    mtraj = {
        'deter': down(traj['deter'], 'first'),
        'stoch_flat': down(traj['stoch_flat'], 'first'),
        'act_skill': down(traj['act_skill'], 'first'),
        'rew_extr': down(traj['rew_extr'], 'sum'),
        'rew_expl': down(traj['rew_expl'], 'sum'),
        'rew_goal': down(traj['rew_goal'], 'sum')}
    ml, mm = self.manager.loss(mtraj, down(cont, 'prod'))
    losses.update({f'manager_{k}': v for k, v in ml.items()})
    metrics.update({f'manager_{k}': v for k, v in mm.items()})
    loss = sum(v.float().mean() for v in losses.values())
    metrics.update({f'loss/{k}': v.mean() for k, v in losses.items()})
    return loss.float(), metrics

  def report(self, carry, data, draws=None):
    return carry, {}
