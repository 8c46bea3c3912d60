"""Observation/action space descriptor (dtype, shape, bounds).

A copy of embodied_tpu/utils/space.py: the port imports nothing of the
JAX package.
"""

import numpy as np


class Space:

  def __init__(self, dtype, shape=(), low=None, high=None):
    # Allow a single int as shorthand for a vector shape.
    if isinstance(shape, (int, np.integer)):
      shape = (int(shape),)
    self._dtype = np.dtype(dtype)
    assert self._dtype is not object, self._dtype
    self._shape = tuple(int(x) for x in shape)
    self._low = self._infer_low(low)
    self._high = self._infer_high(high)
    self._discrete = (
        np.issubdtype(self._dtype, np.integer) or self._dtype == bool)
    self._random = np.random.default_rng()

  @property
  def dtype(self):
    return self._dtype

  @property
  def shape(self):
    return self._shape

  @property
  def low(self):
    return self._low

  @property
  def high(self):
    return self._high

  @property
  def discrete(self):
    return self._discrete

  @property
  def classes(self):
    # Number of categories for discrete spaces (exclusive upper bound).
    assert self.discrete, self
    return int(self._high.max())

  def sample(self):
    if self.discrete:
      return self._random.integers(
          self._low, self._high, self._shape).astype(self._dtype)
    low = np.where(np.isfinite(self._low), self._low, -1.0)
    high = np.where(np.isfinite(self._high), self._high, 1.0)
    value = self._random.uniform(low, high, self._shape)
    return value.astype(self._dtype)

  def contains(self, value):
    value = np.asarray(value)
    if value.shape != self._shape:
      return False
    if value.dtype != self._dtype:
      return False
    if self.discrete:
      return bool((value >= self._low).all() and (value < self._high).all())
    return bool(
        (value >= self._low).all() and (value <= self._high).all())

  def _infer_low(self, low):
    if low is not None:
      return np.broadcast_to(np.asarray(low), self._shape).copy()
    if self._dtype == bool:
      return np.zeros(self._shape, np.int64)
    if np.issubdtype(self._dtype, np.integer):
      return np.broadcast_to(np.iinfo(self._dtype).min, self._shape).copy()
    return np.full(self._shape, -np.inf)

  def _infer_high(self, high):
    if high is not None:
      return np.broadcast_to(np.asarray(high), self._shape).copy()
    if self._dtype == bool:
      return np.full(self._shape, 2, np.int64)
    if np.issubdtype(self._dtype, np.integer):
      # Discrete highs are exclusive, so the inferred full-dtype range
      # must be max+1 — otherwise a saturated uint8 image pixel (255)
      # fails validation. Stored as int64 (may not fit the dtype itself);
      # 64-bit dtypes stay at max to avoid overflowing the bound.
      hi = np.iinfo(self._dtype).max
      if hi < np.iinfo(np.int64).max:
        hi += 1
      return np.broadcast_to(hi, self._shape).copy()
    return np.full(self._shape, np.inf)

  def __repr__(self):
    low = None if self._low is None else self._low.min()
    high = None if self._high is None else self._high.max()
    return (
        f'Space({self._dtype.name}, shape={self._shape}, '
        f'low={low}, high={high})')

  def __eq__(self, other):
    return (
        isinstance(other, Space) and
        self._dtype == other._dtype and
        self._shape == other._shape and
        np.array_equal(self._low, other._low) and
        np.array_equal(self._high, other._high))
