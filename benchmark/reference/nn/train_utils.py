"""Training utilities: running normalizers and EMA target networks.

A frozen copy of the port's nn/train_utils.py on one process. The
statistics are buffers (`retnorm/lo`, `slowval_ema/count`, ...) updated in
place under `torch.no_grad()`.
"""

import torch

from . import core
from . import opt


class Normalize(core.Module):
  """Running normalizer returning (offset, scale) statistics: `perc`
  (percentile range), `meanstd`, or `none`."""

  def __init__(self, impl='meanstd', name='norm', rate=0.01, limit=1e-8,
               perclo=5.0, perchi=95.0, debias=True):
    super().__init__(name)
    assert impl in ('none', 'meanstd', 'perc'), impl
    self.impl = impl
    self.rate = rate
    self.limit = limit
    self.perclo = perclo
    self.perchi = perchi
    self.debias = debias
    if impl == 'none':
      return
    names = dict(meanstd=('mean', 'sqrs'), perc=('lo', 'hi'))[impl]
    for key in names + (('corr',) if debias else ()):
      self.state(key, (), 0.0)

  def forward(self, x, update=True):
    if update:
      self.update(x)
    return self.stats()

  @torch.no_grad()
  def update(self, x):
    if self.impl == 'none':
      return
    x = x.detach().float()
    if self.impl == 'meanstd':
      self._ema('mean', opt.group_mean(x.mean()))
      self._ema('sqrs', opt.group_mean(x.square().mean()))
    else:
      self._ema('lo', self._perc(x, self.perclo))
      self._ema('hi', self._perc(x, self.perchi))
    if self.debias:
      self._ema('corr', torch.ones_like(self.corr))

  def stats(self):
    if self.impl == 'none':
      return 0.0, 1.0
    corr = 1.0
    if self.debias:
      corr = 1.0 / torch.clamp(self.corr, min=self.rate)
    if self.impl == 'meanstd':
      mean = self.mean * corr
      std = torch.sqrt(torch.relu(self.sqrs * corr - mean.square()))
      return mean, torch.clamp(std, min=self.limit)
    lo, hi = self.lo * corr, self.hi * corr
    return lo.detach(), torch.clamp(hi - lo, min=self.limit).detach()

  def _ema(self, name, value):
    buf = getattr(self, name)
    buf.copy_((1 - self.rate) * buf + self.rate * value)

  def _perc(self, x, q):
    return torch.quantile(opt.group_cat(x.reshape(-1)), q / 100.0)


class SlowModel(core.Module):
  """EMA shadow of a source module. The shadow has the source's
  architecture under its own name; its values start as copies of the
  source's and are pulled toward them by `update()` at `rate` every
  `every` calls. They are not trained. `count` is the update counter,
  kept as `<shadow>_ema/count`."""

  def __init__(self, model, source, rate=0.02, every=1):
    super().__init__(model.name + '_ema')
    assert rate == 1 or rate < 0.5, rate
    self.rate = rate
    self.every = every
    self.state('count', (), 0, torch.int32)
    # Plain references, so the modules are registered once, by the model.
    self.__dict__['model'] = model
    self.__dict__['source'] = source
    for param in model.parameters():
      param.requires_grad_(False)

  def forward(self, *args, **kwargs):
    return self.model(*args, **kwargs)

  def _pairs(self):
    src = dict(self.source.named_parameters())
    for name, dst in self.model.named_parameters():
      yield src[name], dst

  @torch.no_grad()
  def post_init(self):
    for src, dst in self._pairs():
      dst.copy_(src)

  @torch.no_grad()
  def update(self):
    mix = self.rate * (self.count % self.every == 0).float()
    for src, dst in self._pairs():
      dst.copy_(mix * src + (1 - mix) * dst)
    self.count += 1
