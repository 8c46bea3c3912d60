"""Output distributions with pred/sample/logp/entropy/kl/loss.

A frozen copy of the port's nn/dists.py: the Pointwise regressions MSE and
Huber, Normal, Binary, Categorical, OneHot (straight-through samples),
TwoHot (symexp bins, an exactly-zero prediction at uniform logits), Agg,
and the wrappers Frozen (no gradient through any result) and Concat
(distributions side by side along an axis). Categorical families
keep normalized log-probabilities (optionally mixed with the uniform
distribution) as their parameter. Sampling takes an explicit
`torch.Generator`, or the noise itself as a tensor (Gumbel noise for the
categorical families, standard normal noise for Normal), so tests can hand
both frameworks the same noise.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import core

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def gumbel(shape, gen=None, device=None):
  """Standard Gumbel noise from `gen` (float32)."""
  tiny = torch.finfo(torch.float32).tiny
  u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
  return -torch.log(-torch.log(u.clamp(min=tiny)))


def _as_float(value):
  assert value.is_floating_point(), value.dtype
  return value.float()


class Dist:
  """Common interface: `loss` is the negative log-likelihood of a target
  that carries no gradient, `prob` the exponentiated log-probability."""

  def prob(self, value):
    return torch.exp(self.logp(value))

  def loss(self, target):
    return -self.logp(target.detach())


class Pointwise(Dist):
  """Deterministic regression: the loss is a pointwise penalty of the
  error against the target, the target optionally squashed (symlog)
  first."""

  def __init__(self, mean, squash=None):
    self.mean = mean.float()
    self._squash = squash or (lambda x: x)

  def pred(self):
    return self.mean

  def loss(self, target):
    target = self._squash(_as_float(target)).detach()
    assert target.shape == self.mean.shape, (target.shape, self.mean.shape)
    return self._penalty(self.mean - target)

  def _penalty(self, err):
    raise NotImplementedError


class MSE(Pointwise):

  def _penalty(self, err):
    return torch.square(err)


class Huber(Pointwise):
  """Regression with the Charbonnier (smooth Huber) penalty
  sqrt(err^2 + eps^2) - eps."""

  def __init__(self, mean, eps=1.0, squash=None):
    super().__init__(mean, squash)
    self._eps = eps

  def _penalty(self, err):
    return torch.sqrt(torch.square(err) + self._eps ** 2) - self._eps


class Frozen:
  """Detaches every method result (and attribute) of the wrapped
  distribution."""

  def __init__(self, inner):
    self._inner = inner

  def __getattr__(self, name):
    if name.startswith('__'):
      raise AttributeError(name)
    member = getattr(self._inner, name)
    if not callable(member):
      return _detach(member)
    return lambda *args, **kwargs: _detach(member(*args, **kwargs))


def _detach(tree):
  return core.tree_map(
      lambda x: x.detach() if isinstance(x, torch.Tensor) else x, tree)


class Concat:
  """Several distributions side by side along one event axis: a method
  call slices its tensor arguments at the `midpoints` along `axis`, calls
  each part on its slice and concatenates the results along `axis`."""

  def __init__(self, outputs, midpoints, axis):
    assert len(midpoints) + 1 == len(outputs), (len(outputs), len(midpoints))
    self._parts = tuple(outputs)
    self._edges = (None,) + tuple(midpoints) + (None,)
    self._axis = axis

  def _segment(self, i, tree):
    index = (slice(None),) * self._axis + (
        slice(self._edges[i], self._edges[i + 1]),)
    return core.tree_map(
        lambda x: x[index] if isinstance(x, torch.Tensor) else x, tree)

  def __getattr__(self, name):
    if name.startswith('__'):
      raise AttributeError(name)
    members = tuple(getattr(part, name) for part in self._parts)
    def call(*args, **kwargs):
      results = [
          fn(*self._segment(i, args), **self._segment(i, kwargs))
          for i, fn in enumerate(members)]
      return _concat(results, self._axis)
    return call


def _concat(results, axis):
  first = results[0]
  if isinstance(first, dict):
    return {k: _concat([r[k] for r in results], axis) for k in first}
  if isinstance(first, (list, tuple)):
    return type(first)(
        _concat([r[i] for r in results], axis) for i in range(len(first)))
  return torch.cat(results, axis)


class Normal(Dist):

  def __init__(self, mean, stddev=1.0):
    self.mean = mean.float()
    self.stddev = torch.broadcast_to(
        torch.as_tensor(stddev, device=self.mean.device).float(),
        self.mean.shape)
    self._logstd = torch.log(self.stddev)

  def pred(self):
    return self.mean

  def sample(self, gen=None, noise=None):
    if noise is None:
      noise = torch.randn(self.mean.shape, generator=gen,
                          device=self.mean.device)
    return self.mean + self.stddev * noise

  def logp(self, value):
    z = (_as_float(value) - self.mean) / self.stddev
    return -(0.5 * torch.square(z) + self._logstd + _HALF_LOG_2PI)

  def entropy(self):
    return self._logstd + _HALF_LOG_2PI + 0.5


class Binary(Dist):

  def __init__(self, logit):
    self.logit = logit.float()
    self._lp1 = F.logsigmoid(self.logit)
    self._lp0 = F.logsigmoid(-self.logit)

  def pred(self):
    return self.logit > 0

  def logp(self, value):
    # A host number stays a scalar: copying it to the card would make the
    # host wait for the card.
    on = (float(value) if isinstance(value, (bool, int, float)) else
          torch.as_tensor(value, device=self.logit.device).float())
    return on * self._lp1 + (1.0 - on) * self._lp0

  def entropy(self):
    p1 = torch.exp(self._lp1)
    return -(p1 * self._lp1 + (1.0 - p1) * self._lp0)


def _mix_uniform(logprobs, amount):
  """Blend a categorical (given as logprobs) with the uniform distribution."""
  if not amount:
    return logprobs
  count = logprobs.shape[-1]
  return torch.log((1.0 - amount) * torch.exp(logprobs) + amount / count)


class Categorical(Dist):
  """Integer-event categorical, parameterized by normalized logprobs."""

  def __init__(self, logits, unimix=0.0):
    self.logprobs = _mix_uniform(F.log_softmax(logits.float(), -1), unimix)

  @property
  def logits(self):
    return self.logprobs

  def pred(self):
    return torch.argmax(self.logprobs, -1)

  def sample(self, gen=None, noise=None):
    if noise is None:
      noise = gumbel(self.logprobs.shape, gen, self.logprobs.device)
    assert noise.shape == self.logprobs.shape, (noise.shape,
                                                self.logprobs.shape)
    return torch.argmax(self.logprobs + noise, -1)

  def logp(self, value):
    picked = torch.gather(self.logprobs, -1, value[..., None].long())
    return picked[..., 0]

  def entropy(self):
    return -(torch.exp(self.logprobs) * self.logprobs).sum(-1)

  def kl(self, other):
    gap = self.logprobs - other.logprobs
    return (torch.exp(self.logprobs) * gap).sum(-1)


class OneHot(Dist):
  """Categorical over one-hot events; samples carry straight-through
  gradients of the class probabilities."""

  def __init__(self, logits, unimix=0.0):
    self.dist = Categorical(logits, unimix)

  @property
  def logits(self):
    return self.dist.logprobs

  def _attach_probs(self, index):
    hard = F.one_hot(index, self.logits.shape[-1]).float()
    soft = torch.exp(self.logits)
    return soft + (hard - soft).detach()

  def pred(self):
    return self._attach_probs(self.dist.pred())

  def sample(self, gen=None, noise=None):
    return self._attach_probs(self.dist.sample(gen, noise))

  def logp(self, value):
    return (self.logits * value).sum(-1)

  def entropy(self):
    return self.dist.entropy()

  def kl(self, other):
    return self.dist.kl(other.dist)


class TwoHot(Dist):
  """Distributional regression over two-hot encoded bin targets. pred()
  folds symmetric bin pairs before summing, so symmetric bins with uniform
  probabilities give exactly zero."""

  def __init__(self, logits, bins, squash=None, unsquash=None):
    self.logits = logits.float()
    self.bins = torch.as_tensor(bins, dtype=torch.float32,
                                device=self.logits.device)
    assert self.logits.shape[-1] == len(bins), (self.logits.shape, len(bins))
    self.probs = torch.softmax(self.logits, -1)
    self._squash = squash or (lambda x: x)
    self._unsquash = unsquash or (lambda x: x)

  def pred(self):
    weighted = self.probs * self.bins
    folded = 0.5 * (weighted + weighted.flip(-1))
    return self._unsquash(folded.sum(-1))

  def loss(self, target):
    encoded = self._encode(target)
    return -(encoded * F.log_softmax(self.logits, -1)).sum(-1)

  def _encode(self, target):
    """Split unit mass between the bracketing bins; a target past either
    end puts all its mass on the end bin."""
    target = self._squash(_as_float(target)).detach()
    count = len(self.bins)
    right = torch.searchsorted(self.bins, target.contiguous(), right=True)
    below = torch.clamp(right - 1, 0, count - 1)
    above = torch.clamp(right, 0, count - 1)
    degenerate = below == above
    one = torch.ones_like(target)
    dist_below = torch.where(degenerate, one, (self.bins[below] - target).abs())
    dist_above = torch.where(degenerate, one, (self.bins[above] - target).abs())
    total = dist_below + dist_above
    return (F.one_hot(below, count) * (dist_above / total)[..., None] +
            F.one_hot(above, count) * (dist_below / total)[..., None])


def symexp_bins(num):
  """Symmetric exponentially-spaced bins used by symexp_twohot heads."""
  expand = lambda x: np.sign(x) * np.expm1(np.abs(x))
  if num % 2:
    neg = expand(np.linspace(-20, 0, (num - 1) // 2 + 1, dtype=np.float32))
    return np.concatenate([neg, -neg[:-1][::-1]], 0).astype(np.float32)
  neg = expand(np.linspace(-20, 0, num // 2, dtype=np.float32))
  return np.concatenate([neg, -neg[::-1]], 0).astype(np.float32)


class Agg(Dist):
  """Reduces an elementwise distribution over trailing event dims."""

  def __init__(self, inner, dims):
    self._inner = inner
    self._axes = tuple(range(-dims, 0))

  def pred(self):
    return self._inner.pred()

  def sample(self, gen=None, noise=None):
    return self._inner.sample(gen, noise)

  def logp(self, value):
    return self._inner.logp(value).sum(self._axes)

  def prob(self, value):
    return self._inner.prob(value).sum(self._axes)

  def loss(self, target):
    return self._inner.loss(target).sum(self._axes)

  def entropy(self):
    return self._inner.entropy().sum(self._axes)

  def kl(self, other):
    assert isinstance(other, Agg), other
    return self._inner.kl(other._inner).sum(self._axes)


class Draws:
  """The random numbers of one call, drawn in call order from `gen`:
  Gumbel noise for categorical samples, standard normal noise for
  continuous ones. A test hands both frameworks the same noise by passing
  an object with the same two methods."""

  def __init__(self, gen, device):
    self.gen = gen
    self.device = device

  def gumbel(self, shape):
    return gumbel(shape, self.gen, self.device)

  def normal(self, shape):
    return torch.randn(shape, generator=self.gen, device=self.device)
