"""Mean host ms of the program's `policy/fetch_wait` section
(parallel/agent.py `Agent.policy`: the host blocked until the actions and
outputs reached it) per policy call, over the script's window after its
traced stretch (harness/spans.py)."""

from benchmark.harness import spans


def read(record):
  return spans.host_ms(record, 'script', 'policy/fetch_wait')
