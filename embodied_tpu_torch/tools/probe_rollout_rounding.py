"""Where the rollout kernel and its plain bf16 version part, on one card.

    python -m embodied_tpu_torch.tools.probe_rollout_rounding [--out FILE]

Runs the imagination rollout kernel at the small shapes of
tests/test_torch_cuda.py (4 steps, D=256, 4 blocks, stoch 4 x 16, a
2-layer policy; B=40 on the FMA stages and B=200 on the tensor cores),
for both action heads, with the policy, prior and embedding weights drawn
at two gains: std 0.1 (as the core's) and 0.3. Beside the kernel it
replays the plain version on the kernel's own samples twice: in bf16, as
the card test compares, and in float32 (the same bf16 weights and
inputs, widened), which rounds nowhere. For the f32 logits it prints the
largest distance of each pair and how many logits the bf16 comparison
puts outside 3e-2 + 3e-2 |plain|. If the kernel sits closer to the
float32 replay than the plain bf16 version does, the disagreement comes
from the plain version's roundings (its core rounds each product and the
GRU update to bf16, where the kernel sums and updates in f32), not from
the kernel.

Prints one JSON line per case (and writes them to `--out`). Needs a card.
"""

import argparse
import json
import pathlib

import numpy as np
import torch

from ..ops import imagine_seq

TOL = 3e-2
STEPS, D, S, C, G, NPOL = 4, 256, 4, 16, 4, 2


def case(card, disc, B, H, U, gain, seed=9):
  rng = np.random.default_rng(seed)
  L, adim, dg = S * C, 5 if disc else 6, D // G
  bf = lambda scale, *s: torch.tensor(scale * rng.standard_normal(s),
                                      dtype=torch.bfloat16, device=card)
  f32 = lambda *s: torch.tensor(1 + 0.1 * rng.standard_normal(s),
                                dtype=torch.float32, device=card)
  small = lambda n: torch.tensor(0.01 + 0.01 * rng.standard_normal(n),
                                 dtype=torch.bfloat16, device=card)
  core = [bf(0.1, D, H), small(H), f32(H), bf(0.1, L, H), small(H), f32(H),
          bf(0.1, G, dg, dg), small(D), bf(0.1, 3 * H, D), f32(D),
          bf(0.1, G, dg, 3 * dg), small(3 * D)]
  w = lambda *s: bf(gain, *s)
  params = core + [w(D, H), w(H), f32(H), w(H, H), w(H), f32(H), w(H, L),
                   w(L), w(adim, H), w(H), f32(H)]
  for i in range(NPOL):
    params += [w(D + L if i == 0 else U, U), w(U), f32(U)]
  for _ in range(1 if disc else 2):
    params += [w(U, adim), w(adim).float()]
  deter0 = torch.tanh(bf(0.1, B, D).float()).to(torch.bfloat16)
  stoch0 = torch.nn.functional.one_hot(
      torch.tensor(rng.integers(0, C, (B, S)), device=card), C).reshape(
          B, L).to(torch.bfloat16)
  u = lambda *s: torch.tensor(rng.uniform(1e-6, 1 - 1e-6, s),
                              dtype=torch.float32, device=card)
  gum = -torch.log(-torch.log(u(STEPS, B, L)))
  noise = (-torch.log(-torch.log(u(STEPS, B, adim))) if disc else
           torch.tensor(rng.standard_normal((STEPS, B, adim)),
                        dtype=torch.float32, device=card))
  return params, deter0, stoch0, gum, noise


def probe(card, disc, B, H, U, gain):
  params, deter0, stoch0, gum, noise = case(card, disc, B, H, U, gain)
  spec = (NPOL, disc, C)
  with torch.no_grad():
    _, sseq, lseq, aseq = imagine_seq.imagine_seq(
        deter0, stoch0, gum, noise, params, *spec)
    replay = lambda d0, s0, ps: imagine_seq.reference_imagine_seq(
        d0, s0, ps, *spec, gumbel=gum, noise=noise, hard=sseq, acts=aseq)[2]
    plain = replay(deter0, stoch0, params)
    wide = replay(deter0.float(), stoch0.float(), [p.float() for p in params])
  dist = lambda a, b: float((a.float() - b.float()).abs().max())
  outside = (lseq - plain).abs() > TOL + TOL * plain.abs()
  return dict(head='categorical' if disc else 'bounded_normal', rows=B,
              tensor_cores=B >= 128, gain=gain, logits=lseq.numel(),
              kernel_vs_plain=dist(lseq, plain),
              kernel_vs_f32=dist(lseq, wide), plain_vs_f32=dist(plain, wide),
              outside_tol=int(outside.sum()))


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--out', default='')
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('probe_rollout_rounding: needs a CUDA card')
  card = torch.device('cuda')
  rows = []
  for gain in (0.1, 0.3):
    for B, H, U in ((40, 32, 32), (200, 64, 64)):
      for disc in (True, False):
        rows.append(probe(card, disc, B, H, U, gain))
        print(json.dumps(rows[-1]), flush=True)
  if args.out:
    pathlib.Path(args.out).write_text(
        ''.join(json.dumps(r) + '\n' for r in rows))


if __name__ == '__main__':
  main()
