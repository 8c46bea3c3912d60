"""Mean host ms of the program's `train/fetch_wait` section
(parallel/agent.py `_finish_fetch`: the host blocked until an earlier
step's outputs reached it) per call, over the steps after the traced ones
(harness/spans.py)."""

from benchmark.harness import spans


def read(record):
  return spans.host_ms(record, 'learn', 'train/fetch_wait')
