"""The bytes and products each of the port's window kernels has to move and
compute, for their rooflines: a frozen copy of the formulas of the port's
ops/observe_seq.py and ops/imagine_seq.py (`work`), at the time the
benchmark was written.

Each input byte counts once and each output byte once (weights and biases
in bfloat16, norm scales and logits in float32), at 2 M N K a product.
The backward of the observe window counts the products it has to do, two
for each of the forward's (the input and the weight gradients), where the
port's `work_bwd` also counts its recompute of the forward: a kernel that
stores the forward's states instead of recomputing them does less work,
and its share must stay under the roofline.
"""


def window_weights(D, H, L, A, K, g):
  """Weight elements of the observe window's step: the core (dynin0,
  dynin1, the block-diagonal and dense hidden layer, the gates) and the
  posterior head."""
  dg = D // g
  return (D * H + L * H + g * dg * dg + (2 * H + A) * D + g * dg * 3 * dg +
          (D + K) * H + H * L)


def observe_window(T, B, D, H, L, A, K, g):
  """(bytes, flops) of the window's forward (kernel 5)."""
  w = window_weights(D, H, L, A, K, g)
  vectors = 2 * H + D + 3 * D + H + L    # biases, bf16
  scales = 2 * H + D + H                 # norm scales, f32
  ins = 2 * (B * D + B * L + T * B * (A + K)) + 4 * T * B * (1 + L)
  outs = 2 * T * B * (D + L) + 4 * T * B * L
  nbytes = 2 * (w + vectors) + 4 * scales + ins + outs
  return nbytes, 2 * T * B * w


def observe_window_bwd(T, B, D, H, L, A, K, g):
  """(bytes, flops) of the window's backward (kernel 6): it reads the
  forward's inputs, the states entering each step and f32 upstream
  gradients, writes the input and weight gradients, and does two products
  for each of the forward's."""
  w = window_weights(D, H, L, A, K, g)
  vectors = 2 * H + D + 3 * D + H + L
  scales = 2 * H + D + H
  params = 2 * (w + vectors) + 4 * scales
  ins = (2 * T * B * (D + L + A + K) + 4 * T * B +
         4 * T * B * (D + 2 * L))
  outs = 2 * (B * D + B * L + T * B * (A + K))
  nbytes = 2 * params + ins + outs
  return nbytes, 2 * 2 * T * B * w


def imagination(steps, B, D, H, L, A, U, adim, npol, g, disc):
  """(bytes, flops) of the whole-horizon rollout (kernel 8): core, prior,
  sample, the action embedding and the policy, `steps` steps from B
  starts."""
  dg = D // g
  heads = 1 if disc else 2
  core = D * H + L * H + g * dg * dg + (2 * H + A) * D + g * dg * 3 * dg
  prior = D * H + H * H + H * L
  policy = (D + L) * U + (npol - 1) * U * U + U * adim * heads
  w = core + prior + adim * A + policy
  vectors = 2 * H + 4 * D + 2 * H + L + A + npol * U  # bf16 biases
  scale = 2 * H + D + 2 * H + A + npol * U + adim * heads  # f32
  ins = 2 * B * (D + L) + 4 * steps * B * (L + adim)
  outs = 2 * steps * B * (D + L) + 4 * steps * B * (L + adim)
  nbytes = 2 * (w + vectors) + 4 * scale + ins + outs
  return nbytes, 2 * steps * B * w


def dims(settings, token_dim, actions):
  """The kernels' dimensions at a configuration's settings: the window's
  (T, B, D, H, L, A, K, g) and the rollout's (steps, B, D, H, L, A, U,
  adim, npol, g, disc), for a discrete action of `actions` classes."""
  get = lambda key: settings[key]
  D = int(get('agent.dyn.rssm.deter'))
  H = int(get('agent.dyn.rssm.hidden'))
  L = int(get('agent.dyn.rssm.stoch')) * int(get('agent.dyn.rssm.classes'))
  g = int(get('agent.dyn.rssm.blocks'))
  B, T = int(get('batch_size')), int(get('batch_length'))
  K = int(token_dim)
  last = int(get('agent.imag_last')) or T
  window = (T, B, D, H, L, H, K, g)
  rollout = (int(get('agent.imag_length')), B * min(last, T), D, H, L, H,
             int(get('agent.policy.units')), int(actions),
             int(get('agent.policy.layers')), g, True)
  return window, rollout
