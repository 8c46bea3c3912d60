"""DreamerV3 model: the acting path.

The part of embodied_tpu/models/dreamerv3/model.py that `policy` needs:
the encoder, the RSSM and the policy head, their carries, and the packed
replay entries of each step. The module tree's parameter paths are the JAX
store's. The decoder, the reward, continue and value heads, the optimizer
and the train and report paths come with the train step.
"""

import numpy as np
import torch

from ... import nn
from ...utils import tree
from . import rssm

_TORCH_DTYPES = {
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(bool): torch.bool,
    np.dtype(np.uint8): torch.uint8}


class Model(nn.Module):
  """DreamerV3's acting path under the Agent contract."""

  WM = ('enc', 'dyn', 'dec')

  def __init__(self, obs_space, act_space, config, cdtype=nn.COMPUTE_DTYPE):
    super().__init__('model', cdtype)
    self.obs_space = obs_space
    self.act_space = {k: v for k, v in act_space.items() if k != 'reset'}
    self.config = config
    acfg = config.agent
    self.acfg = acfg

    exclude = ('is_first', 'is_last', 'is_terminal', 'reward')
    spaces = {k: v for k, v in obs_space.items()
              if k not in exclude and not k.startswith('log/')}
    self.enc = {'simple': rssm.Encoder}[acfg.enc.typ](
        spaces, 'enc', cdtype=cdtype, **dict(acfg.enc[acfg.enc.typ]))
    self.dyn = {'rssm': rssm.RSSM}[acfg.dyn.typ](
        self.act_space, 'dyn', token_dim=self.enc.token_dim, cdtype=cdtype,
        **dict(acfg.dyn[acfg.dyn.typ]))
    d1, d2 = acfg.policy_dist_disc, acfg.policy_dist_cont
    pouts = {k: d1 if v.discrete else d2 for k, v in self.act_space.items()}
    featdim = self.dyn.deter + self.dyn.stoch * self.dyn.classes
    self.pol = nn.MLPHead(
        self.act_space, pouts, 'pol', featdim, cdtype=cdtype,
        **dict(acfg.policy))

  @property
  def device(self):
    return next(self.parameters()).device

  # --- World-model trio plumbing ------------------------------------------

  def _entry_flat(self, entry_trio):
    """Flatten per-module entries into replay-column format (packed)."""
    packed = {'enc': self.enc.entry_pack(entry_trio[0]),
              'dyn': self.dyn.entry_pack(entry_trio[1]),
              'dec': {}}
    return tree.flatdict(packed)

  @property
  def policy_keys(self):
    return r'^(enc|dyn|dec|pol)/'

  # --- Carries ------------------------------------------------------------

  def init_policy(self, batch_size):
    device = self.device
    zeros = lambda s: torch.zeros(
        (batch_size, *s.shape), dtype=_TORCH_DTYPES[s.dtype], device=device)
    return (self.enc.initial(batch_size, device),
            self.dyn.initial(batch_size, device), {},
            {k: zeros(v) for k, v in self.act_space.items()})

  # --- Policy -------------------------------------------------------------

  def policy(self, carry, obs, mode='train', gen=None):
    enc_carry, dyn_carry, dec_carry, prevact = carry
    kw = dict(training=False, single=True)
    reset = obs['is_first']
    enc_carry, enc_entry, tokens = self.enc(enc_carry, obs, reset, **kw)
    dyn_carry, dyn_entry, feat = self.dyn.observe(
        dyn_carry, tokens, prevact, reset, gen=gen, **kw)
    policy = self.pol(self._feat2tensor(feat), bdims=1)
    act = {k: v.sample(gen).to(_TORCH_DTYPES[self.act_space[k].dtype])
           for k, v in policy.items()}
    # Finite-ness screening, logged per episode (log/ keys bypass replay).
    screen = lambda x: (
        torch.isfinite(x.float()).reshape((x.shape[0], -1)).all(-1)
        if x.ndim > 1 else torch.isfinite(x.float()))
    finite = tree.flatdict(dict(
        tokens=screen(tokens), act={k: screen(v) for k, v in act.items()}))
    out = {f'log/finite/{k}': v for k, v in finite.items()}
    if self.config.replay_context:
      out.update(self._entry_flat((enc_entry, dyn_entry, {})))
    return (enc_carry, dyn_carry, dec_carry, act), act, out

  def _feat2tensor(self, feat):
    stoch = self.cast(feat['stoch'])
    return torch.cat([
        self.cast(feat['deter']),
        stoch.reshape((*stoch.shape[:-2], -1))], -1)
