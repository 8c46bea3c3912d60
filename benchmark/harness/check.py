"""How `correct` is decided for the train step: the program's first steps
against the plain reference's on the same weights, rows and noise.

Set-up drives the program's agent through its first `STEPS` train calls,
on the window's own call and feed (`Agent.train` on `Agent.stream`), and
keeps what the reference needs to follow them: the rows each call took,
each leaf's first gradient as the optimizer got it (worked out from its
moments after the first call) and each leaf's change after the last. After the window the reference replays those steps in
float32 and the numbers below are compared with their limits:

- `grad`: the worst leaf's gap between the norms of its first gradient,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger;
- `grad_vec`: the worst leaf's distance between the two first gradients
  themselves, over the same norm. The optimizer clips most leaves' first
  gradients to a share of the leaf's norm (its AGC), alike on both
  sides, so their norms agree whatever the gradient's values; the
  distance sees a gradient that points elsewhere;
- `change`: the gap of each leaf's change over the steps, as `grad`,
  leaving out the leaves whose first gradient in the reference is under
  a thousandth of the median leaf's (they move by round-off alone);
- `grad_mean`, `change_median`: the mean leaf's first-gradient gap and
  the median leaf's change gap, steadier from seed to seed than the
  worst leaf's. The first updates are nearly the sign of the gradient,
  so a change's norm moves little with its values.

The total loss's gap (`loss`) is read and printed, not compared.

The reference works out its own contexts: a window whose first steps
carry latents that an earlier step wrote (by the slot and generation of
the replay, as the program's latent table keeps them) resumes from the
reference's own refreshed latents, and any other starts afresh.
"""

import contextlib
import math

import torch

from .. import reference

STEPS = 3
# Leaves whose first gradient in the reference is under this share of the
# median leaf's move by round-off alone: their change is not compared.
IGNORE_BELOW = 1e-3


def leaves(model):
  """[(path, numel)] of the trained parameters in the optimizer's order."""
  return [(path, p.numel()) for path, p in model.opt.params.items()]


def first_grad(rms, mom, sizes, beta2):
  """Each leaf's first gradient, as the optimizer got it (after its
  clip), from the moments after one step: the RMS moment holds
  (1 - beta2) g**2 and the momentum (1 - beta1) g / |g|. Host float32
  tensors, one a leaf in the optimizer's order."""
  counts = [n for _, n in sizes]
  out = []
  for r, m in zip(torch.split(rms.detach(), counts),
                  torch.split(mom.detach(), counts)):
    out.append((torch.sign(m.float()) *
                torch.sqrt(r.float() / (1 - beta2))).cpu())
  return out


def moments(entry):
  """(RMS moment, momentum) from a store lookup `entry(path)`."""
  return entry('opt/rms_flat'), entry('opt/mom_flat')


def change_norms(params, initial, sizes):
  """Each trained leaf's change from `initial` ({path: tensor})."""
  out = []
  for path, _ in sizes:
    now = params[path].detach().float()
    out.append(torch.linalg.vector_norm(
        now - initial[path].to(now.device, torch.float32)))
  return torch.stack(out).cpu()


class Table:
  """The reference's own record of the latents that its steps wrote, by
  slot, with the program's generation rule."""

  def __init__(self, spaces):
    self.spaces = spaces
    self.rows = {}

  def gather(self, slots, gens, device):
    flat_slots = slots.reshape(-1).tolist()
    flat_gens = gens.reshape(-1).tolist()
    valid = torch.tensor([self.rows.get(s, (None,))[0] == g
                          for s, g in zip(flat_slots, flat_gens)],
                         dtype=torch.bool).reshape(slots.shape)
    out = {}
    for key, space in self.spaces.items():
      zero = torch.zeros(space.shape, dtype=reference.nn.torch_dtype(
          space.dtype))
      rows = [self.rows[s][1][key] if s in self.rows else zero
              for s in flat_slots]
      out[key] = torch.stack(rows).reshape(
          (*slots.shape, *space.shape)).to(device)
    return out, valid.to(device)

  def scatter(self, slots, gens, values):
    values = {k: v.detach().cpu() for k, v in values.items()
              if k in self.spaces}
    flat = {k: v.reshape((-1, *v.shape[slots.ndim:])) for k, v in
            values.items()}
    for i, (s, g) in enumerate(zip(slots.reshape(-1).tolist(),
                                   gens.reshape(-1).tolist())):
      self.rows[s] = (g, {k: v[i] for k, v in flat.items()})


def model(settings, spaces, store, device):
  """The reference model in float32 with TF32 off, holding `store`."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  out = reference.build(*spaces, settings, device)
  reference.nn.core.load_store(out, store)
  reference.nn.core.post_init(out)
  out.train(False)
  return out


def replay(settings, spaces, store, batches, seed, device, fp8=False,
           contexts=None, acting=None):
  """The reference's first steps on `batches` (host tensors of the rows
  the program took) from the weights `store`. Returns its readings:
  {'loss': [per step], 'grad': leaf gradients, 'change': leaf norms}.

  `contexts`, where given, holds for each batch the latents that the
  program's table held at its context steps before the call, and their
  validity, as (latents, valid) on the host: a context that no step of
  the reference wrote takes them (the program's acting wrote them; the
  policy's check covers that stage). `acting`, where given, is called as
  `acting(k, model)` after the reference's first k steps, k = 0 to the
  number of batches, within the same precision."""
  model_ = model(settings, spaces, store, device)
  sizes = leaves(model_)
  K = int(settings['replay_context'])
  table = Table({k: model_.ext_space[k] for k in model_.latent_keys})
  carry = model_.init_train(int(settings['batch_size']))
  beta2 = float(settings['agent.opt.beta2'])
  losses, grads = [], None
  context = reference.nn.core.fp8_compute() if fp8 else (
      contextlib.nullcontext())
  with context:
    for n, batch in enumerate(batches, 1):
      if acting:
        acting(n - 1, model_)
      data = {k: v.to(device) for k, v in batch.items()}
      if 'slot' in data:
        slots, gens = data.pop('slot'), data.pop('slotgen').to(torch.int32)
        fresh, valid = table.gather(slots, gens, device)
        if contexts and contexts[n - 1] is not None:
          _merge(fresh, valid, contexts[n - 1], K, device)
        data.update(fresh)
        if K:
          bad = (data['consec'][:, 0] == 0) & ~valid[:, K - 1]
          first = data['is_first'].clone()
          first[:, K] |= bad
          data['is_first'] = first
      draws = reference.Draws(
          reference.call_seed(seed, n, reference.TRAIN_SALT), device)
      carry, outs, mets = model_.train_step(carry, data, draws)
      carry = reference.nn.core.tree_map(lambda x: x.detach(), carry)
      losses.append(step_loss(mets))
      if 'slot' in batch and 'replay' in outs:
        table.scatter(batch['slot'][:, K:], batch['slotgen'][:, K:].to(
            torch.int32), outs['replay'])
      if n == 1:
        grads = first_grad(*moments(reference.nn.core.store(model_).get),
                           sizes, beta2)
    if acting:
      acting(len(batches), model_)
  params = dict(reference.nn.core.store(model_))
  change = change_norms(params, store, sizes)
  return {'loss': losses, 'grad': grads, 'change': change}


def step_loss(mets):
  """A step's total loss from its metrics."""
  loss = mets['opt/loss']
  return float(loss.detach() if hasattr(loss, 'detach') else loss)


def _merge(fresh, valid, context, K, device):
  """Where the reference's own table has no latent for a context step and
  the program's had a valid one, take the program's."""
  latents, theirs = context
  theirs = theirs.to(device)
  take = theirs & ~valid[:, :K]
  for key, value in latents.items():
    mask = take.reshape(take.shape + (1,) * (value.ndim - 2))
    fresh[key][:, :K] = torch.where(mask, value.to(device), fresh[key][:, :K])
  valid[:, :K] |= take


class Acting:
  """The reference's acting at the policy calls that the program made
  after k of the first train calls, taken by `replay` after its own k
  steps: `outputs[i]` holds (scores, new dynamics carry) of sample i.
  `samples` are (carry, obs, policy call number, k, action, the
  program's new dynamics carry)."""

  def __init__(self, samples, seed, device):
    self.samples, self.seed, self.device = samples, seed, device
    self.outputs = {}

  def __call__(self, k, model_):
    for i, (carry, obs, n, steps, *_) in enumerate(self.samples):
      if steps == k:
        self.outputs[i] = _policy_scores(
            model_, carry, obs, self.seed, n, self.device)


def policy_gaps(samples, ref, other=None):
  """The sampled policy calls against the reference's `Acting.outputs`:

  - `deter`: the widest distance, over the calls and their envs, between
    the deterministic state that the program's observe step returned and
    the reference's, over the reference's norm;
  - `act`: the widest gap by which the score (the reference's
    log-probability plus the call's Gumbel noise) of the program's
    action lies below the best score.

  With `other`, the control's outputs (the reference computing in float8
  on the same inputs and noise) take the program's place."""
  deter, act_gap, count = 0.0, 0.0, 0
  for i, (_, _, _, _, act, dyn) in enumerate(samples):
    scores, ref_dyn = ref[i]
    if other is not None:
      low, dyn = other[i]
      act = {k: v.argmax(-1) for k, v in low.items()}
    want = ref_dyn['deter'].float()
    got = torch.as_tensor(dyn['deter']).to(want.device).float()
    deter = max(deter, float((
        torch.linalg.vector_norm(got - want, dim=-1) /
        torch.linalg.vector_norm(want, dim=-1)).max()))
    for key, score in scores.items():
      chosen = torch.as_tensor(act[key]).to(score.device).long()[:, None]
      picked = torch.gather(score, -1, chosen)[:, 0]
      act_gap = max(act_gap, float((score.max(-1).values - picked).max()))
      count += len(picked)
  return {'deter': deter, 'act': act_gap, 'acts_compared': count}


@torch.no_grad()
def _policy_scores(ref, carry, obs, seed, n, device):
  """({action key: log-probability plus the call's Gumbel noise}, the new
  dynamics carry) of the reference acting from `carry` on `obs` with
  policy call n's noise."""
  from ..reference.nn import dists
  to = lambda x: torch.as_tensor(x).to(device)
  gen = reference.generator(
      reference.call_seed(seed, n, reference.POLICY_SALT), device)
  enc_carry, dyn_carry, _, prevact = reference.nn.core.tree_map(to, carry)
  obs = {k: to(v) for k, v in obs.items() if not k.startswith('log/')}
  reset = obs['is_first']
  kw = dict(training=False, single=True)
  _, _, tokens = ref.enc(enc_carry, obs, reset, **kw)
  dyn_carry, _, feat = ref.dyn.observe(dyn_carry, tokens, prevact, reset,
                                       gen=gen, **kw)
  policy = ref.pol(ref._feat2tensor(feat), bdims=1)
  out = {}
  for key, dist in policy.items():
    noise = dists.gumbel(dist.logprobs.shape, gen, device)
    out[key] = dist.logprobs + noise
  return out, dyn_carry


def gaps(program, ref):
  """Each trained leaf's gaps, over the reference's norm of that leaf or
  of the median leaf, whichever is larger: between the program's and the
  reference's first-gradient norms, the distance between the two first
  gradients, and the gap of the change norms; the change's only for the
  leaves whose first gradient in the reference is at least a thousandth
  of the median leaf's."""
  norm = lambda xs: torch.stack([torch.linalg.vector_norm(x) for x in xs])
  gref, gprog = norm(ref['grad']), norm(program['grad'])
  floor = torch.clamp(gref, min=float(gref.median()))
  grad = (gprog - gref).abs() / floor
  vec = norm([p - r for p, r in zip(program['grad'], ref['grad'])]) / floor
  keep = gref >= IGNORE_BELOW * float(gref.median())
  cref, cprog = ref['change'][keep], program['change'][keep]
  change = (cprog - cref).abs() / torch.clamp(cref, min=float(cref.median()))
  return grad, vec, change, keep


def compare(program, ref):
  """The numbers `correct` compares (see the module's docstring), with
  the worst step's loss gap beside them."""
  losses = [abs(p - r) / max(abs(r), 1e-12)
            for p, r in zip(program['loss'], ref['loss'])]
  grad, vec, change, keep = gaps(program, ref)
  return {'loss': max(losses), 'grad': float(grad.max()),
          'grad_vec': float(vec.max()),
          'grad_vec_median': float(vec.median()),
          'change': float(change.max()), 'grad_mean': float(grad.mean()),
          'change_median': float(change.median()),
          'leaves_compared': int(keep.sum()), 'leaves': int(len(keep))}


def judge(readings, limits):
  """(correct, [(name, reading, limit)]) for each number that the cell's
  limits name; no limits, a missing reading or one that is not finite
  fails."""
  rows, ok = [], bool(limits)
  for name in sorted(limits):
    value = readings.get(name)
    limit = limits.get(name)
    if limit is None or value is None or not math.isfinite(value):
      ok = False
    elif value > limit:
      ok = False
    rows.append((name, value, limit))
  return ok, rows
