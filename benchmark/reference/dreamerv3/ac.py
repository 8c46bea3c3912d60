"""Actor-critic objectives for imagination training.

A frozen copy of the port's models/dreamerv3/ac.py: TD(lambda) returns,
the imagination policy and value losses, the replay value loss and their
diagnostics, and the report's open-loop video. The return recurrence runs
as a reverse loop over time, where JAX solves it with an associative scan:
the same affine recurrence, summed in another order.
"""

import torch
import torch.nn.functional as F

from ..nn import opt as optlib


def lambda_return(last, term, rew, val, boot, disc, lam):
  """TD(lambda) returns R_t = a_t + b_t R_{t+1} with
    a_t = r_{t+1} + (1 - lam keep_{t+1}) disc alive_{t+1} boot_{t+1}
    b_t = disc alive_{t+1} lam keep_{t+1}
  and R at the horizon equal to boot[:, -1]. Inputs (B, T); returns
  (B, T - 1)."""
  shapes = {tuple(x.shape) for x in (last, term, rew, val, boot)}
  assert len(shapes) == 1, shapes
  alive = disc * (1.0 - term.float())[:, 1:]
  keep = lam * (1.0 - last.float())[:, 1:]
  offs = rew[:, 1:] + (1.0 - keep) * alive * boot[:, 1:]
  gains = alive * keep
  ret = boot[:, -1]
  rets = []
  for t in reversed(range(offs.shape[1])):
    ret = offs[:, t] + gains[:, t] * ret
    rets.append(ret)
  return torch.stack(rets[::-1], 1)


class Targets:
  """Denormalized value/target views shared by both objectives."""

  def __init__(self, value, slowvalue, valnorm, slowtar):
    shift, spread = valnorm.stats()
    self.val = value.pred() * spread + shift
    self.slowval = slowvalue.pred() * spread + shift
    self.tarval = self.slowval if slowtar else self.val


def _value_objective(value, slowvalue, normed_target, weight, slowreg):
  """Twohot regression onto the normalized return + EMA regularizer."""
  padded = torch.cat([normed_target, 0 * normed_target[:, -1:]], 1)
  regularizer = slowreg * value.loss(slowvalue.pred().detach())
  return weight[:, :-1] * (value.loss(padded.detach()) + regularizer)[:, :-1]


def imag_loss(
    act, rew, con, policy, value, slowvalue, retnorm, valnorm, advnorm,
    update, contdisc=True, slowtar=False, horizon=333, lam=0.95,
    actent=3e-4, slowreg=1.0):
  """Policy + value objectives on imagined trajectories."""
  tg = Targets(value, slowvalue, valnorm, slowtar)
  disc = 1.0 if contdisc else 1.0 - 1.0 / horizon
  # Trajectory weight: survival probability accumulated along imagination.
  weight = torch.cumprod(disc * con, 1) / disc
  ret = lambda_return(
      torch.zeros_like(con), 1.0 - con, rew, tg.tarval, tg.tarval, disc, lam)

  ret_shift, ret_spread = retnorm(ret, update)
  adv = (ret - tg.tarval[:, :-1]) / ret_spread
  adv_shift, adv_spread = advnorm(adv, update)
  adv_normed = (adv - adv_shift) / adv_spread
  logpi = sum(dist.logp(act[key].detach())[:, :-1]
              for key, dist in policy.items())
  ents = {key: dist.entropy()[:, :-1] for key, dist in policy.items()}
  surrogate = logpi * adv_normed.detach() + actent * sum(ents.values())

  val_shift, val_spread = valnorm(ret, update)
  tar_normed = (ret - val_shift) / val_spread
  losses = {
      'policy': weight[:, :-1].detach() * -surrogate,
      'value': _value_objective(
          value, slowvalue, tar_normed, weight.detach(), slowreg),
  }

  ret_normed = (ret - ret_shift) / ret_spread
  metrics = _diagnostics(
      adv=adv, rew=rew, con=con, weight=weight, ret=ret_normed,
      val=tg.val, slowval=tg.slowval, tar=tar_normed)
  for key, ent in ents.items():
    metrics[f'ent/{key}'] = ent.mean()
    dist = policy[key]
    if hasattr(dist, 'minent'):
      span = max(dist.maxent - dist.minent, 1e-8)
      metrics[f'rand/{key}'] = (ent.mean() - dist.minent) / span
  return losses, {'ret': ret}, metrics


def repl_loss(
    last, term, rew, boot, value, slowvalue, valnorm, update=True,
    slowreg=1.0, slowtar=False, horizon=333, lam=0.95):
  """Value regression on replayed steps, bootstrapped from imagination."""
  tg = Targets(value, slowvalue, valnorm, slowtar)
  disc = 1.0 - 1.0 / horizon
  ret = lambda_return(last, term, rew, tg.tarval, boot, disc, lam)
  shift, spread = valnorm(ret, update)
  loss = _value_objective(
      value, slowvalue, (ret - shift) / spread, (~last).float(), slowreg)
  return {'repval': loss}, {'ret': ret}, {}


def _diagnostics(adv, rew, con, weight, ret, val, slowval, tar):
  """The standard scalar summary suite for the imagination objectives."""
  metrics = {
      key: value.mean()
      for key, value in dict(
          adv=adv, rew=rew, con=con, weight=weight, ret=ret, val=val,
          slowval=slowval, tar=tar).items()}
  # Not means: taken over the data group's rows, so that the Agent's mean
  # of its ranks' metrics leaves them as they are.
  adv_mean = optlib.group_mean(adv.mean())
  metrics['adv_std'] = torch.sqrt(optlib.group_mean(
      (adv - adv_mean).square().mean()))
  metrics['adv_mag'] = adv.abs().mean()
  metrics['ret_min'] = optlib.group_min(ret.min())
  metrics['ret_max'] = optlib.group_max(ret.max())
  metrics['ret_rate'] = (ret.abs() >= 1.0).float().mean()
  return metrics


def openloop_video(true, obs_recon, img_recon, split):
  """Side-by-side truth/prediction/error video with phase-colored borders,
  (T, H + 4, B (W + 4), C) uint8 from (B, T, H, W, C) frames: truth uint8,
  reconstructions in [0, 1]. The first `split` frames (green border) are
  posterior reconstructions; the rest (red border) are open-loop
  imagination."""
  pred = torch.cat([obs_recon, img_recon], 1)
  pred = torch.clamp(pred * 255, 0, 255).to(torch.uint8)
  error = ((pred.int() - true.int() + 255) // 2).to(torch.uint8)
  panel = torch.cat([true, pred, error], 2)
  frames = panel.shape[1]
  panel = F.pad(panel, (0, 0, 2, 2, 2, 2))
  interior = torch.zeros(panel.shape, dtype=torch.bool, device=panel.device)
  interior[:, :, 2:-2, 2:-2, :].fill_(True)
  # Colors made on the device: a copy from host memory would wait for it.
  green = torch.zeros(3, dtype=torch.uint8, device=panel.device)
  green[1].fill_(255)
  first = (torch.arange(frames, device=panel.device) < split)[:, None]
  edge = torch.where(first, green, green.roll(-1))
  panel = torch.where(interior, panel, edge[None, :, None, None, :])
  B, T, H, W, C = panel.shape
  return panel.permute(1, 2, 0, 3, 4).reshape(T, H, B * W, C)
