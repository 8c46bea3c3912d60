"""Device layer: wraps a model (an nn.Module tree) into the Agent API.

The acting half of embodied_tpu/parallel/agent.py: `init_policy`,
`policy`, `save` and `load`. Parameters live on one device, chosen at
construction: 'cuda' unless the caller asks for 'cpu', and construction
raises when CUDA is asked for and there is no card. `policy` takes and
returns host numpy arrays for observations, actions and outputs; carries
stay on the device. Each call samples from a fresh generator seeded from
(seed, call counter), as the JAX agent folds the counter into its key.
Train, report, meshes and the latent table come in later slices.
"""

import numpy as np
import torch

from .. import core as corelib
from .. import nn


def resolve_device(device):
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'No CUDA device is available. Pass device="cpu" to run on the CPU.')
  return device


def call_seed(seed, counter, salt=1_000_003):
  state = np.random.SeedSequence([int(seed), int(counter), salt])
  return int(state.generate_state(1, np.uint64)[0] & ((1 << 63) - 1))


class Agent(corelib.Agent):

  def __init__(self, model, obs_space, act_space, config, device='cuda'):
    self.device = resolve_device(device)
    self.model = model
    self.obs_space = obs_space
    self.act_space = {k: v for k, v in act_space.items() if k != 'reset'}
    self.config = config
    self.seed = int(config.seed)
    self._counters = {'policy': 0}
    nn.init_params(model, self.seed)
    model.to(self.device)
    model.eval()
    total = sum(p.numel() for p in model.parameters())
    print(f'Initialized agent store: {len(nn.store(model))} entries, '
          f'{total:,} parameters on {self.device}')

  def init_policy(self, batch_size):
    return self.model.init_policy(batch_size)

  def policy(self, carry, obs, mode='train'):
    obs = {k: self._to_device(v) for k, v in obs.items()
           if not k.startswith('log/')}
    carry = nn.core.tree_map(self._to_device, carry)
    self._counters['policy'] += 1
    gen = torch.Generator(self.device).manual_seed(
        call_seed(self.seed, self._counters['policy']))
    with torch.inference_mode():
      carry, act, out = self.model.policy(carry, obs, mode, gen)
      act = {k: v.cpu().numpy() for k, v in act.items()}
      out = {k: v.cpu().numpy() for k, v in out.items()}
    return carry, act, out

  def _to_device(self, value):
    if isinstance(value, torch.Tensor):
      return value.to(self.device)
    return torch.from_numpy(np.ascontiguousarray(value)).to(self.device)

  def save(self):
    store = {k: v.detach().cpu().numpy() for k, v in nn.store(
        self.model).items()}
    return {'store': store, 'counters': dict(self._counters)}

  def load(self, data):
    """Load a store {path: array} by flat path, such as `save()` or
    `convert.from_jax` return. Entries the port does not hold yet (the
    decoder, value heads and optimizer slots of a JAX store) are ignored."""
    unused = nn.load_store(self.model, data['store'])
    if unused:
      print(f'Ignoring {len(unused)} checkpoint entries the port lacks')
    self._counters.update(data.get('counters', {}))
