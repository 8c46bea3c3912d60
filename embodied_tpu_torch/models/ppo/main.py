"""PPO entry point of the port: builds the agent for a config and runs a
script.

    python -m embodied_tpu_torch.models.ppo.main \
        --task pinpad_three --logdir DIR         # the defaults, on the card
    python -m embodied_tpu_torch.models.ppo.main --configs debug \
        --task dummy_disc --logdir DIR           # on the CPU

Or from Python:

    config = common.assemble_config(CONFIGS, ['--task', 'pinpad_three'])
    agent = make_agent(config)               # on the card
    agent = make_agent(config, device='cpu')  # on the CPU
"""

import os
import pathlib
import sys

if __name__ == '__main__' and __package__ is None:
  sys.path.insert(0, os.path.abspath(
      os.path.join(os.path.dirname(__file__), '..', '..', '..')))
  __package__ = 'embodied_tpu_torch.models.ppo'

from .. import common

CONFIGS = pathlib.Path(__file__).with_name('configs.yaml')


def make_agent(config, device=None):
  """The torch Agent for `config` (common.make_agent with this package's
  Model)."""
  from .model import Model
  return common.make_agent(config, Model, device)


def main(argv=None):
  config = common.assemble_config(CONFIGS, argv)
  common.run_script(config, make_agent)


if __name__ == '__main__':
  main()
