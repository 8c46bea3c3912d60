"""Mean host time of an `Agent.policy` call in the train script's window
(the observe step on kernel 3, the policy head, the sample, the latents'
write into the table and the copy of the actions back), through the
benchmark's proxy of the agent."""


def read(record):
  spans = record.get('spans', {}).get('policy')
  if record.get('driver') != 'script' or not spans:
    return None
  return 1e3 * sum(spans) / len(spans)
