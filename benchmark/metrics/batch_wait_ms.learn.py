"""Mean host time of `next()` on the agent's stream, a train step's wait
for its batch (the data path: `Agent.stream` and its prefetch, the
replay's sampling, the latent table's rows), over all steps of the
window."""


def read(record):
  spans = record.get('spans', {}).get('next')
  if record.get('driver') != 'learn' or not spans:
    return None
  return 1e3 * sum(spans) / len(spans)
