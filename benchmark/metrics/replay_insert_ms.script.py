"""Host ms of the program's `replay_add` sections (core/replay.py: one
insert per env and step) summed per driver step (per `driver/callbacks`
section, core/driver.py), over the script's window after its traced
stretch (harness/spans.py)."""

from benchmark.harness import spans


def read(record):
  return spans.host_ms(record, 'script', 'replay_add', per='driver/callbacks')
