"""DreamerV3 entry point of the port: builds the agent for a config and
runs a script.

    python -m embodied_tpu_torch.models.dreamerv3.main \
        --task dummy_disc --logdir DIR           # the defaults, on the card
    python -m embodied_tpu_torch.models.dreamerv3.main --configs size12m \
        --task dummy_disc --logdir DIR           # a smaller model
    python -m embodied_tpu_torch.models.dreamerv3.main --configs debug \
        --task dummy_disc --logdir DIR           # on the CPU

Or from Python:

    config = common.assemble_config(CONFIGS, ['--configs', 'size12m'])
    agent = make_agent(config)               # on the card
    agent = make_agent(config, device='cpu')  # on the CPU
"""

import os
import pathlib
import sys

if __name__ == '__main__' and __package__ is None:
  sys.path.insert(0, os.path.abspath(
      os.path.join(os.path.dirname(__file__), '..', '..', '..')))
  __package__ = 'embodied_tpu_torch.models.dreamerv3'

from ... import nn
from ... import parallel
from .. import common

CONFIGS = pathlib.Path(__file__).with_name('configs.yaml')


def make_agent(config, device=None):
  """The torch Agent for `config`, on `device` (default: the config's
  torch.device, 'cuda'). Raises without a card unless the device is the
  CPU."""
  if config.random_agent:
    raise NotImplementedError('The random agent is not ported yet')
  device = parallel.agent.resolve_device(device or config.torch.device)
  obs_space, act_space = common.env_spaces(config)
  from .model import Model
  acfg = common.agent_config(config)
  model = Model(obs_space, act_space, acfg,
                cdtype=nn.DTYPES[config.torch.compute_dtype])
  return parallel.Agent(model, obs_space, act_space, acfg, device)


def main(argv=None):
  config = common.assemble_config(CONFIGS, argv)
  common.run_script(config, make_agent)


if __name__ == '__main__':
  main()
