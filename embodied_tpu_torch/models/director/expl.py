"""Exploration stack for Director: the disagreement ensemble and the
random behaviour.

Counterpart of embodied_tpu/models/director/expl.py, with its store
layout: the ensemble of `models` MLPs is one set of parameters with a
leading member axis, one (E, d, u) kernel per layer, so each layer is one
batched product 'end,edu->enu' over all members.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ... import nn


class EnsembleMLP(nn.Module):
  """E independent MLPs evaluated jointly: `kernel<i>` (E, d, u),
  `bias<i>` and, on hidden layers, the rms scale `norm<i>`, both
  (E, 1, u)."""

  def __init__(self, name, din, models, layers, units, outdim, act='silu',
               cdtype=nn.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    self.models = models
    self.layers = layers
    self.act = nn.act(act)
    winit = nn.Initializer.parse('trunc_normal_in')
    # Each member draws its own fan-in init over (d, u).
    init = lambda gen, shape: torch.stack(
        [winit(gen, shape[1:]) for _ in range(shape[0])])
    widths = [din] + [units] * layers + [outdim]
    for i in range(layers + 1):
      self.param(f'kernel{i}', (models, widths[i], widths[i + 1]), init)
      self.param(f'bias{i}', (models, 1, widths[i + 1]), 0.0)
      if i < layers:
        self.param(f'norm{i}', (models, 1, widths[i + 1]), 1.0)

  def _layer(self, x, i):
    kernel, bias = getattr(self, f'kernel{i}'), getattr(self, f'bias{i}')
    return torch.einsum('end,edu->enu', x, self.cast(kernel)) + self.cast(
        bias)

  def forward(self, x):
    """x: (N, D) -> member predictions (E, N, outdim)."""
    x = self.cast(x)[None].expand(self.models, *x.shape)
    for i in range(self.layers):
      x = self._layer(x, i).float()
      x = x / torch.sqrt(x.square().mean(-1, keepdim=True) + 1e-6)
      x = self.act(self.cast(x) * self.cast(getattr(self, f'norm{i}')))
    return self._layer(x, self.layers)


class Disag(nn.Module):
  """One-step latent-prediction ensemble; the reward is the members'
  disagreement. Predicts the next flat stoch state from (deter, stoch,
  action) on (B, T, ...) trajectories."""

  def __init__(self, name, act_space, deter, target_dim, models=8,
               layers=2, units=256, act='silu', cdtype=nn.COMPUTE_DTYPE):
    super().__init__(name, cdtype)
    self.act_space = act_space
    self.target_dim = target_dim
    din = deter + target_dim + sum(
        int(np.prod(s.shape)) * (s.classes if s.discrete else 1)
        for s in act_space.values())
    self.ens = EnsembleMLP(
        'ens', din, models, layers, units, target_dim, act, cdtype=cdtype)

  def _inputs(self, traj, prefix='act_'):
    feats = [self.cast(traj['deter']), self.cast(traj['stoch_flat'])]
    for key, space in self.act_space.items():
      act = traj[f'{prefix}{key}']
      if space.discrete and not act.is_floating_point():
        act = F.one_hot(act.long(), space.classes)
      act = self.cast(act.float())
      feats.append(act.reshape((*act.shape[:2], -1)))
    return torch.cat(feats, -1)

  def _predict(self, inputs):
    B, T, D = inputs.shape
    preds = self.ens(inputs.reshape((B * T, D)))
    return preds.reshape((preds.shape[0], B, T, self.target_dim))

  def reward(self, traj, prefix='act_'):
    """The disagreement reward, (B, T): the members' standard deviation
    (population, as jnp.std), averaged over the features."""
    preds = self._predict(self._inputs(traj, prefix).detach())
    return preds.float().std(0, correction=0).mean(-1)

  def loss(self, traj, prefix='act_'):
    """Ensemble regression (state_t, act_t) -> stoch_{t+1}."""
    inputs = self._inputs(traj, prefix)[:, :-1].detach()
    target = traj['stoch_flat'][:, 1:].float().detach()
    preds = self._predict(inputs).float()
    return (preds - target[None]).square().mean((-1, -2, -3)).sum()


class RandomBehavior:
  """Uniform actions, for `expl_behavior: random`."""

  def __init__(self, act_space):
    self.act_space = act_space

  def policy(self, feat, gen=None):
    batch = feat['deter'].shape[0]
    device = feat['deter'].device
    acts = {}
    for name, space in sorted(self.act_space.items()):
      shape = (batch, *space.shape)
      if space.discrete:
        acts[name] = torch.randint(
            0, space.classes, shape, generator=gen, device=device,
            dtype=nn.torch_dtype(space.dtype))
      else:
        lo = np.where(np.isfinite(space.low), space.low, -1.0)
        hi = np.where(np.isfinite(space.high), space.high, 1.0)
        lo, hi = (torch.as_tensor(x, dtype=torch.float32, device=device)
                  for x in (lo, hi))
        u = torch.rand(shape, generator=gen, device=device)
        acts[name] = lo + (hi - lo) * u
    return acts
