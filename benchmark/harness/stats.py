"""The arithmetic of the metrics: percentiles, shares of a peak, and the
device's busy time and idle gaps from a trace's intervals."""

import math

# NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def percentile(values, q):
  """The q-th percentile (0-100) of all `values`, linear between ranks
  (numpy's default)."""
  xs = sorted(float(v) for v in values)
  if not xs:
    raise ValueError('percentile of no values')
  pos = (len(xs) - 1) * q / 100.0
  lo, hi = math.floor(pos), math.ceil(pos)
  return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mfu(flops_per_step, steps, seconds, peak=PEAK_BF16_FLOPS):
  """The share (%) of the peak that `steps` steps of `flops_per_step`
  products in `seconds` reach."""
  return 100.0 * flops_per_step * steps / seconds / peak


def least_time(nbytes, flops, peak_bytes=PEAK_HBM_BYTES,
               peak_flops=PEAK_BF16_FLOPS):
  """The least seconds the chip could take: the larger of the bytes over
  the memory's rate and the products over the peak."""
  return max(nbytes / peak_bytes, flops / peak_flops)


def union(intervals):
  """Disjoint sorted intervals covering the (start, end) pairs."""
  out = []
  for start, end in sorted(intervals):
    if out and start <= out[-1][1]:
      out[-1][1] = max(out[-1][1], end)
    else:
      out.append([start, end])
  return [tuple(x) for x in out]


def busy(intervals, start, end):
  """The length of the union of `intervals` clipped to [start, end]."""
  total = 0.0
  for a, b in union(intervals):
    a, b = max(a, start), min(b, end)
    if b > a:
      total += b - a
  return total


def gaps(intervals, start, end):
  """The (start, length) of each stretch of [start, end] that no
  interval covers, longest first."""
  out, cursor = [], start
  for a, b in union(intervals):
    a, b = max(a, start), min(b, end)
    if b <= a:
      continue
    if a > cursor:
      out.append((cursor, a - cursor))
    cursor = max(cursor, b)
  if end > cursor:
    out.append((cursor, end - cursor))
  return sorted(out, key=lambda x: -x[1])
