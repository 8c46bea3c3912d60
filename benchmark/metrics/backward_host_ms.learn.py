"""Mean host ms of the program's `train/backward` section (nn/opt.py: the
gradients, on the autograd engine's thread while the caller waits, their
flat buffer and its joins) per call, over the steps after the traced ones
(harness/spans.py)."""

from benchmark.harness import spans


def read(record):
  return spans.host_ms(record, 'learn', 'train/backward')
