"""Output distributions the acting path needs: Categorical, OneHot, Agg.

Counterparts of embodied_tpu/nn/dists.py. Categorical families keep
normalized log-probabilities (optionally mixed with the uniform
distribution) as their parameter. Sampling is Gumbel-max: `sample` takes
an explicit `torch.Generator`, or the Gumbel noise itself as a tensor of
the shape of the log-probabilities, so tests can hand both frameworks the
same noise.
"""

import torch
import torch.nn.functional as F


def gumbel(shape, gen=None, device=None):
  """Standard Gumbel noise from `gen` (float32)."""
  tiny = torch.finfo(torch.float32).tiny
  u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
  return -torch.log(-torch.log(u.clamp(min=tiny)))


def _mix_uniform(logprobs, amount):
  """Blend a categorical (given as logprobs) with the uniform distribution."""
  if not amount:
    return logprobs
  count = logprobs.shape[-1]
  return torch.log((1.0 - amount) * torch.exp(logprobs) + amount / count)


class Categorical:
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


class OneHot:
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


class Agg:
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

  def entropy(self):
    return self._inner.entropy().sum(self._axes)

  def kl(self, other):
    assert isinstance(other, Agg), other
    return self._inner.kl(other._inner).sum(self._axes)
