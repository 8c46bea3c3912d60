"""The share (%) of the train script's window in which no operation ran
on the card: one minus the device's busy time per env step in the traced
stretch (the union of kernels, copies and fills in torch.profiler's
trace) times the env steps per second of the window's untraced rest. The
profiler's host-side recording slows the host-paced loop, so the traced
stretch's own length would overstate the idle time."""


def read(record):
  trace = record.get('trace')
  if record.get('driver') != 'script' or not trace:
    return None
  traced, rest = record.get('traced_env_steps'), record.get('untraced')
  if not traced or not rest or not rest['env_steps']:
    return None
  busy_per_step = trace['busy_us'] / 1e6 / traced
  rate = rest['env_steps'] / rest['seconds']
  return 100.0 * (1 - busy_per_step * rate)
