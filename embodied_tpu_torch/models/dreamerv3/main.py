"""DreamerV3 entry point of the port: builds the agent for a config.

    config = common.assemble_config(CONFIGS, ['--configs', 'size12m'])
    agent = make_agent(config)               # on the card
    agent = make_agent(config, device='cpu')  # on the CPU
"""

import pathlib

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
