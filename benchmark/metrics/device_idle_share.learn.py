"""The share (%) of a learner step in which no operation ran on the card:
one minus the device's busy time per step in the traced steps (the union
of kernels, copies and fills in torch.profiler's trace) over the mean
step time of the window's untraced steps (CUDA events). The profiler's
host-side recording slows the host, and with it a host-paced step, so
the traced steps' own length would overstate the idle time; the device's
work per step does not change under it."""


def read(record):
  trace = record.get('trace')
  steps = record.get('traced_steps')
  if record.get('driver') != 'learn' or not trace or not steps:
    return None
  untraced = record['intervals_ms'][steps + 1:]
  if not untraced:
    return None
  step_ms = sum(untraced) / len(untraced)
  return 100.0 * (1 - trace['busy_us'] / 1e3 / steps / step_ms)
