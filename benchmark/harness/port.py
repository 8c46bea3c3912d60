"""What the benchmark takes from the program under test, the PyTorch and
CUDA port `embodied_tpu_torch`: the agent of the model package that a
cell's configuration names, built from the configuration, and the
program's replay, stream and env factories.
Nothing here imports the program until a `Program` is made, so that the
harness's tests on the CPU can import this module alone.

The program's own weights are replaced by the benchmark's (harness/
weights.py), drawn on the card from the seed, and its envs are seeded
from the run's seed, so that one seed gives one run's inputs.
"""

import functools
import importlib

import numpy as np
import torch

from ..reference.nn.core import store_path

ENV_SALT = 5_000_011
ACT_SALT = 6_000_011


class Program:
  """The program's entry points for one configuration: its model package
  (`program.package` of the configuration file, such as
  `embodied_tpu_torch.models.dreamerv3`, whose `main` module has the
  model's CONFIGS and make_agent), the presets its config starts from
  (`program.presets`), and the shared wiring beside the package."""

  def __init__(self, entry):
    package = entry['package']
    self.main = importlib.import_module(f'{package}.main')
    self.common = importlib.import_module(
        f"{package.rsplit('.', 1)[0]}.common")
    top = package.split('.')[0]
    self.core = importlib.import_module(f'{top}.core')
    self.run = importlib.import_module(f'{top}.run')
    self.utils = importlib.import_module(f'{top}.utils')
    self.presets = list(entry.get('presets', ()))

  def make_config(self, settings, seed, logdir, device='cuda',
                  overrides=None):
    """The program's config: its presets, then the cell's `settings` and
    the traffic's `overrides` (flat keys of the program's config)."""
    argv = ['--logdir', str(logdir), '--seed', str(int(seed))]
    if self.presets:
      argv += ['--configs', *self.presets]
    config = self.common.assemble_config(self.main.CONFIGS, argv)
    config = config.update(dict(settings))
    if overrides:
      config = config.update(dict(overrides))
    return config.update({'torch.device': device})

  def make_env(self, config, index):
    """The program's env `index` for `config`, seeded from the run's
    seed."""
    return self.common.make_env(config, index,
                                seed=env_seed(config.seed, index))

  def spaces(self, config):
    return self.common.env_spaces(config)

  def make_agent(self, config):
    return self.main.make_agent(config)

  def make_replay(self, config):
    return self.common.make_replay(config, 'replay')

  def make_stream(self, agent, config, replay):
    return agent.stream(self.common.make_stream(config, replay, 'train'))

  def fill(self, agent, config, replay, steps, envs, seed):
    """`steps` env steps into `replay` from `envs` inline envs under
    uniform random actions drawn from the seed. Where the agent keeps the
    replay's latents in its device table, each step gets a slot of the
    table's allocator that no latent was written to yet, so a window's
    context starts invalid until a train step refreshes it, as after a
    random-action prefill of the program's own run."""
    ctors = [functools.partial(self.make_env, config, i)
             for i in range(envs)]
    driver = self.core.Driver(ctors, parallel=False)
    rng = np.random.default_rng([int(seed), ACT_SALT])
    spaces_ = {k: v for k, v in driver.act_space.items() if k != 'reset'}
    for key, space in spaces_.items():
      if not space.discrete or space.shape:
        raise NotImplementedError(f'Random fill of action {key} {space}')
    table = 'slot' in agent.ext_space

    def policy(carry, obs):
      acts = {k: rng.integers(0, s.classes, envs).astype(s.dtype)
              for k, s in spaces_.items()}
      outs = {}
      if table:
        outs['slot'], outs['slotgen'] = agent._latents.alloc(envs, 'train')
      return carry, acts, outs

    driver.on_step(replay.add)
    try:
      driver(policy, steps=steps)
    finally:
      driver.close()


def env_seed(seed, index):
  state = np.random.SeedSequence([int(seed), int(index), ENV_SALT])
  return int(state.generate_state(1, np.uint32)[0])


@torch.no_grad()
def load_weights(agent, store):
  """Copy the benchmark's weights into every parameter of the program's
  model (its own draws are overwritten)."""
  params = {store_path(k): v for k, v in agent.model.named_parameters()}
  missing = sorted(set(params) - set(store))
  extra = sorted(set(store) - set(params))
  if missing or extra:
    raise KeyError(f'Weights and program differ: the program has '
                   f'{missing[:5]} beyond them, they have {extra[:5]}')
  for path, param in params.items():
    param.copy_(store[path])


def state(agent, path):
  """The program's store entry at `path` (a parameter or state buffer)."""
  entries = {store_path(k): v for k, v in agent.model.state_dict().items()}
  return entries[path]
