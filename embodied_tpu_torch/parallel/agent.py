"""Device layer: wraps a model (an nn.Module tree) into the Agent API.

The one-device part of embodied_tpu/parallel/agent.py: `init_policy`,
`policy`, `init_train`, `train`, `init_report`, `report`, `stream`, `save`
and `load`. Parameters live on one device, chosen at construction: 'cuda'
unless the caller asks for 'cpu', and construction raises when CUDA is
asked for and there is no card. `policy`, `train` and `report` take host
numpy arrays (or tensors) and return host numpy arrays and, for metrics,
host floats (arrays, such as the report's videos, as numpy); carries stay
on the device. Each call samples from a fresh generator seeded from
(seed, call counter, kind), as the JAX agent folds the counter into its
key. The store (`save`/`load`) holds parameters and state by flat JAX
path: the optimizer's step and flat moments, the normalizers, the slow
value and its counter. Prefetching streams to the device, meshes, the
latent table, torch.compile and CUDA graphs come in later slices.
"""

import re

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
    self._counters = {'policy': 0, 'train': 0, 'report': 0}
    nn.init_params(model, self.seed)
    model.to(self.device)
    model.eval()
    total = sum(p.numel() for p in model.parameters())
    print(f'Initialized agent store: {len(nn.store(model))} entries, '
          f'{total:,} parameters on {self.device}')

  @property
  def ext_space(self):
    return dict(self.model.ext_space)

  def init_policy(self, batch_size):
    return self.model.init_policy(batch_size)

  def init_train(self, batch_size):
    return self.model.init_train(batch_size)

  def init_report(self, batch_size):
    return self.model.init_report(batch_size)

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

  def train(self, carry, data):
    """One train step on a (B, T + replay_context) batch. Returns (carry,
    outs, metrics): outs['replay'] holds the refreshed packed latents and
    stepid as numpy, metrics are host floats."""
    data = {k: self._to_device(v) for k, v in data.items()
            if not k.startswith('log/')}
    carry = nn.core.tree_map(self._to_device, carry)
    self._counters['train'] += 1
    carry, outs, mets = self.model.train_step(
        carry, data, self._draws('train', 2_000_003))
    carry = nn.core.tree_map(lambda x: x.detach(), carry)
    outs = {k: {kk: vv.detach().cpu().numpy() for kk, vv in v.items()}
            for k, v in outs.items()}
    return carry, outs, self._fetch(mets)

  def report(self, carry, data):
    """Metrics of a (B, T + replay_context) batch without updates (see
    Model.report): scalars as host floats, videos as uint8 numpy arrays."""
    data = {k: self._to_device(v) for k, v in data.items()
            if not k.startswith('log/')}
    carry = nn.core.tree_map(self._to_device, carry)
    self._counters['report'] += 1
    carry, mets = self.model.report(
        carry, data, self._draws('report', 3_000_003))
    carry = nn.core.tree_map(lambda x: x.detach(), carry)
    return carry, self._fetch(mets)

  def stream(self, source):
    """The stream that train and report read. The JAX agent prefetches
    batches to its devices here; the port hands each batch over in
    `train` and `report`, and prefetching is later work."""
    return source

  def _draws(self, kind, salt):
    gen = torch.Generator(self.device).manual_seed(
        call_seed(self.seed, self._counters[kind], salt=salt))
    return nn.dists.Draws(gen, self.device)

  def _fetch(self, mets):
    """Device metrics to the host in one transfer for the scalars: floats,
    and numpy arrays for the rest."""
    mets = {k: torch.as_tensor(v, device=self.device).detach()
            for k, v in mets.items()}
    keys = sorted(k for k, v in mets.items() if v.ndim == 0)
    out = {k: v.cpu().numpy() for k, v in mets.items() if v.ndim}
    if keys:
      values = torch.stack([mets[k].float() for k in keys])
      out.update(zip(keys, values.cpu().tolist()))
    return out

  def _example_batch(self, batch_size, length, spaces=None):
    """Zeros of every replay key at (batch_size, length), as numpy."""
    if spaces is None:
      spaces = self.ext_space
    spaces = {**self.obs_space, **self.act_space, **spaces}
    return {key: np.zeros((batch_size, length, *space.shape), space.dtype)
            for key, space in spaces.items() if not key.startswith('log/')}

  def _to_device(self, value):
    if isinstance(value, torch.Tensor):
      return value.to(self.device)
    return torch.from_numpy(np.ascontiguousarray(value)).to(self.device)

  def save(self):
    # Copies: on the CPU, .numpy() would share memory with live tensors.
    store = {k: v.detach().cpu().numpy().copy() for k, v in nn.store(
        self.model).items()}
    return {'store': store, 'counters': dict(self._counters)}

  def load(self, data, regex=None):
    """Load a store {path: array} by flat path, such as `save()` or
    `convert.from_jax` return: parameters and state. Without `regex` the
    store must hold every entry of the model, or this raises naming the
    first five it lacks; with `regex`, only the store's entries that match
    it load and the rest keep their values. Entries the port lacks are
    reported and ignored."""
    store = data['store']
    if regex:
      pattern = re.compile(regex)
      store = {k: v for k, v in store.items() if pattern.search(k)}
    missing = sorted(set(nn.store(self.model)) - set(store))
    if missing and not regex:
      raise KeyError(f'Checkpoint missing entries: {missing[:5]}')
    unused = nn.load_store(self.model, store, strict=False)
    if unused:
      print(f'Ignoring {len(unused)} unexpected checkpoint entries: '
            f'{unused[:5]}')
    self._counters.update(data.get('counters', {}))
