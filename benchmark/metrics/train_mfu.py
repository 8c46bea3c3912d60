"""The window's share (%) of the card's bf16 dense peak (989 TFLOP/s):
the products of one train step, counted by the benchmark on the frozen
reference at the cell's shapes (forward and backward, 2 M N K each), times
the steps the window completed, over the window's seconds."""

from benchmark.harness import stats


def read(record):
  flops = record.get('flops_per_step')
  if not flops or not record.get('steps'):
    return None
  return stats.mfu(flops, record['steps'], record['window_s'])
