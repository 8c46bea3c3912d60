"""Mean host time of an `Agent.train` call (its enqueue of the step's
work and any wait inside it, such as the fetch pipeline's for an earlier
step's outputs), over all steps of the window."""


def read(record):
  spans = record.get('spans', {}).get('train')
  if record.get('driver') != 'learn' or not spans:
    return None
  return 1e3 * sum(spans) / len(spans)
