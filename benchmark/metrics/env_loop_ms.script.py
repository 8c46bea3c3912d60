"""The train script's window time outside the agent's `policy` and
`train` calls, per driver step (one step of all envs): env stepping, the
driver, replay inserts, the stream's sampling on the script's thread and
the run loop. (The script's first report and log come 300 s and 120 s
after its start, past the end of a run.)"""


def read(record):
  if record.get('driver') != 'script' or not record.get('ticks'):
    return None
  return 1e3 * record['env_loop_s'] / record['ticks']
