"""Mean host ms of the program's `train/update` section (nn/opt.py: the
optimizer's clip, moments and parameter writes) per call, over the steps
after the traced ones (harness/spans.py)."""

from benchmark.harness import spans


def read(record):
  return spans.host_ms(record, 'learn', 'train/update')
