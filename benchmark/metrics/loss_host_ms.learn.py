"""Mean host ms of the program's `train/loss` section (nn/opt.py: the
loss function's forward, as the host enqueues it) per call, over the
steps after the traced ones (harness/spans.py)."""

from benchmark.harness import spans


def read(record):
  return spans.host_ms(record, 'learn', 'train/loss')
