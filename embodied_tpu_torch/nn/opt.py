"""Optimizer with adaptive gradient clipping, RMS scaling and momentum.

Counterpart of embodied_tpu/nn/opt.py in its default (fused) layout: the
two moments are flat float32 vectors, `opt/rms_flat` and `opt/mom_flat`,
over the trained parameters in sorted path order, beside `opt/step`. The
port keeps them as buffers in that layout, so a JAX checkpoint resumes with
its moments. Per step, as JAX: AGC per parameter, the RMS and momentum
updates with bias correction over the flat vectors, weight decay on paths
matching a regex, the warmup and const/linear/cosine schedules, and, when
the compute dtype is float16, dynamic loss scaling that skips steps whose
gradients overflow. Parameters are updated in place under no_grad, after
the loss's own state updates (normalizers), which happen in place during
the loss.
"""

import math
import re

import torch

from . import core


def scope_params(root, scopes):
  """The trained parameters of `root` under the store scopes `scopes`
  (paths such as 'worker/actor'), as {path: parameter}: what the JAX
  Optimizer's scope list selects."""
  out = {}
  for name, param in root.named_parameters():
    path = name.replace('.', '/')
    if param.requires_grad and any(
        path == s or path.startswith(s + '/') for s in scopes):
      out[path] = param
  return out


class Optimizer(core.Module):

  def __init__(
      self, params, name='opt', lr=4e-5, agc=0.3, eps=1e-20, beta1=0.9,
      beta2=0.999, momentum=True, nesterov=False, wd=0.0, wdregex=r'/kernel$',
      schedule='const', warmup=1000, anneal=0, pmin=1e-3, fused=True,
      scaling=False, **unused):
    """`params` maps store paths to the trained parameters."""
    super().__init__(name)
    assert fused, 'the port keeps the flat (fused) slot layout only'
    assert params, 'no trainable parameters'
    # Plain references: the model registers the parameters.
    self.__dict__['params'] = dict(sorted(params.items()))
    self.lr = lr
    self.agc = agc
    self.eps = eps
    self.beta1 = beta1
    self.beta2 = beta2
    self.momentum = momentum
    self.nesterov = nesterov
    self.wd = wd
    self.wdpattern = re.compile(wdregex) if wd else None
    self.schedule = schedule
    self.warmup = warmup
    self.anneal = anneal
    self.pmin = pmin
    self.scaling = scaling
    total = sum(p.numel() for p in self.params.values())
    self.state('step', (), 0, torch.int32)
    if scaling:
      self.state('grad_scale', (), 1e4)
      self.state('good_steps', (), 0, torch.int32)
    self.state('rms_flat', (total,), 0.0)
    if momentum:
      self.state('mom_flat', (total,), 0.0)

  def forward(self, lossfn, *args, **kwargs):
    """Runs `lossfn(*args, **kwargs) -> (loss, aux)`, differentiates the
    float32 scalar loss with respect to the parameters, and updates them.
    Returns (metrics, aux)."""
    loss, aux = lossfn(*args, **kwargs)
    assert loss.dtype == torch.float32 and loss.shape == (), (
        loss.dtype, loss.shape)
    paths = list(self.params)
    params = [self.params[k] for k in paths]
    scaled = loss * self.grad_scale if self.scaling else loss
    grads = torch.autograd.grad(scaled, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.float()
             for p, g in zip(params, grads)]
    metrics = self._update(paths, params, grads, loss.detach())
    return {f'{self.name}/{k}': v for k, v in metrics.items()}, aux

  @torch.no_grad()
  def _update(self, paths, params, grads, loss):
    metrics = {}
    finite = torch.ones((), dtype=torch.bool, device=loss.device)
    if self.scaling:
      scale = self.grad_scale.clone()
      loss = loss / scale
      grads = [g / scale for g in grads]
      finite = torch.isfinite(sum(g.square().sum() for g in grads))
      good = self.good_steps
      keep = finite & (good < 1000)
      incr = finite & (good >= 1000)
      self.good_steps.copy_(torch.where(finite, good + 1, 0))
      self.grad_scale.copy_(torch.clamp(torch.where(
          incr, scale * 2, torch.where(keep, scale, scale / 2)), 1e-4, 1e5))
      grads = [torch.where(finite, g, torch.zeros_like(g)) for g in grads]
      metrics['grad_scale'] = scale
      metrics['grad_overflow'] = (~finite).float()
    step = self.step.float()
    lr = self._lr(step)
    pieces = []
    for grad, param in zip(grads, params):
      update = grad
      if self.agc:
        unorm = torch.linalg.vector_norm(update)
        pnorm = torch.linalg.vector_norm(param)
        upper = self.agc * torch.clamp(pnorm, min=self.pmin)
        update = update * (1 / torch.clamp(unorm / upper, min=1.0))
      pieces.append(update.reshape(-1))
    vec = torch.cat(pieces)
    pvec = torch.cat([p.reshape(-1) for p in params])
    # A fill, not a copy from the host, which would wait for the card.
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=vec.device)
    self.rms_flat.copy_(
        self.beta2 * self.rms_flat + (1 - self.beta2) * vec.square())
    nu_hat = self.rms_flat / (1 - f32(self.beta2) ** (step + 1))
    vec = vec / (torch.sqrt(nu_hat) + self.eps)
    if self.momentum:
      self.mom_flat.copy_(self.beta1 * self.mom_flat + (1 - self.beta1) * vec)
      mu = self.mom_flat
      if self.nesterov:
        mu = self.beta1 * mu + (1 - self.beta1) * vec
      vec = mu / (1 - f32(self.beta1) ** (step + 1))
    if self.wd:
      mask = torch.cat([
          torch.full((p.numel(),), float(bool(self.wdpattern.search(k))),
                     device=vec.device) for k, p in zip(paths, params)])
      vec = vec + self.wd * mask * pvec
    vec = -lr * vec
    new = torch.where(finite, pvec + vec, pvec)
    offset = 0
    for param in params:
      param.copy_(new[offset:offset + param.numel()].reshape(param.shape))
      offset += param.numel()
    self.step.add_(finite.int())
    gsq = sum(g.square().sum() for g in grads)
    count = pvec.numel()
    metrics.update(
        loss=loss, updates=step + 1, grad_norm=torch.sqrt(gsq),
        grad_rms=torch.sqrt(gsq / count),
        update_rms=torch.sqrt(vec.square().sum() / count),
        param_rms=torch.sqrt(pvec.square().sum() / count),
        param_count=f32(count), lr=lr)
    return metrics

  def _lr(self, step):
    lr = self.lr
    if self.schedule == 'const':
      sched = torch.full_like(step, lr)
    elif self.schedule in ('linear', 'cosine'):
      frac = torch.clamp(
          (step - self.warmup) / max(1, self.anneal - self.warmup), 0, 1)
      if self.schedule == 'linear':
        sched = lr * (1 - 0.9 * frac)
      else:
        sched = 0.1 * lr + 0.45 * lr * (1 + torch.cos(math.pi * frac))
    else:
      raise NotImplementedError(self.schedule)
    if self.warmup:
      ramp = torch.clamp(step / self.warmup, 0, 1)
      sched = torch.where(step < self.warmup, lr * ramp, sched)
    return sched
