"""Mean host ms of the program's `driver/envs` section (core/driver.py:
the transport's step of every env and the stacking of their rows) per
driver step, over the script's window after its traced stretch
(harness/spans.py)."""

from benchmark.harness import spans


def read(record):
  return spans.host_ms(record, 'script', 'driver/envs')
