"""Segment profile of the port's DreamerV3 train step: the counterpart of
the root tools/profile_train.py.

Times each stage of the train step as its own call, forward (under
no_grad) and forward plus backward (autograd of the segment's scalar to
the trained parameters), so the step's time splits into buckets:

  enc        the encoder
  observe    the observe window
  dyn        the dynamics loss (the window, the prior, the KL terms)
  dec_heads  the decoder with the reward and continuation heads
  imag       the imagination rollout and the actor-critic losses
  full       the whole loss forward
  train      the whole train step through Agent.train (optimizer included)

On the card a segment's time is the median of CUDA-event times of single
calls after a warm-up; on the CPU the median of wall-clock times. Each
segment's FLOPs are the products of its plain path, counted on a meta
copy of the model (parallel/flops.py); the train step's are
`Agent.train_cost()`'s. TFLOP/s is FLOPs over time, and MFU is TFLOP/s
over the card's dense bf16 peak from PEAKS, keyed on the device's name
(none for a card the table lacks, or on the CPU).

Usage:
  python -m embodied_tpu_torch.tools.profile_train --out prof.json
  python -m embodied_tpu_torch.tools.profile_train --configs size12m
  python -m embodied_tpu_torch.tools.profile_train --configs debug \\
      --device cpu --iters 2
"""

import argparse
import json
import statistics
import subprocess
import time

import torch

from embodied_tpu_torch import nn
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main as dmain
from embodied_tpu_torch.parallel import flops as flopslib

# Dense bf16 peaks by a piece of the device's name (NVIDIA's data sheets,
# without sparsity), for MFU.
PEAKS = {
    'H100 80GB HBM3': 989e12,  # H100 SXM
    'H100 PCIe': 756e12,
}

SEGMENTS = ('enc', 'observe', 'dyn', 'dec_heads', 'imag', 'full')


def peak_flops(device):
  """The dense bf16 peak of `device` (a torch.device) or None."""
  if device.type != 'cuda':
    return None
  name = torch.cuda.get_device_name(device)
  for kind, peak in PEAKS.items():
    if kind.lower() in name.lower():
      return peak
  return None


def scalar(tree):
  """The sum of the floating tensors of a nested structure, in float32."""
  leaves = []

  def visit(x):
    if isinstance(x, dict):
      for v in x.values():
        visit(v)
    elif isinstance(x, (list, tuple)):
      for v in x:
        visit(v)
    elif isinstance(x, torch.Tensor) and x.is_floating_point():
      leaves.append(x.float().sum())
    elif hasattr(x, 'pred'):  # A distribution.
      visit(x.pred())
  visit(tree)
  return sum(leaves)


def prepare(model, carry, data, draws):
  """The intermediates the segments start from, detached: one forward
  pass of the world model."""
  with torch.no_grad():
    carry3, obs, prevact, _ = model._resume_window(carry, data)
    _, _, out_carry, entries, tokens, repfeat = (
        model._world_model_objectives(carry3, obs, prevact, True, draws))
  return dict(carry3=carry3, obs=obs, prevact=prevact, tokens=tokens,
              repfeat=repfeat, dyn_entries=entries[1],
              dyn_carry=out_carry[1])


def segments(model, x, draws):
  """{name: a function of no arguments that returns the segment's
  scalar} over the intermediates `x`."""
  obs, prevact = x['obs'], x['prevact']
  reset = obs['is_first']

  def enc():
    return scalar(model.enc(x['carry3'][0], obs, reset, True)[2])

  def observe():
    return scalar(model.dyn.observe(
        x['carry3'][1], x['tokens'], prevact, reset, True,
        draws=draws)[2])

  def dyn():
    _, _, losses, feat, _ = model.dyn.loss(
        x['carry3'][1], x['tokens'], prevact, reset, True, draws)
    return scalar(losses) + 0 * scalar(feat)

  def dec_heads():
    repfeat = x['repfeat']
    _, _, recons = model.dec(x['carry3'][2], repfeat, reset, True)
    total = sum(d.loss(torch.zeros_like(d.pred())).sum()
                for d in recons.values())
    inp = model._feat2tensor(repfeat)
    total = total + model.rew(inp, 2).loss(obs['reward']).sum()
    return total + model.con(inp, 2).loss(
        torch.zeros_like(obs['reward'])).sum()

  def imag():
    losses, _, _ = model._imagination_objectives(
        obs, x['repfeat'], x['dyn_entries'], x['dyn_carry'], True, draws)
    return scalar(losses)

  def full():
    return model.loss(x['carry3'], obs, prevact, True, draws)[0]

  return dict(enc=enc, observe=observe, dyn=dyn, dec_heads=dec_heads,
              imag=imag, full=full)


def fwdbwd(fn, params):
  """`fn` forward and the gradient of its scalar to `params`."""
  def run():
    grads = torch.autograd.grad(fn(), params, allow_unused=True)
    return sum(g.float().sum() for g in grads if g is not None)
  return run


def timed(fn, device, warmup, iters):
  """Median ms of single calls of `fn` after `warmup` calls: CUDA events on
  the card, the wall clock on the CPU."""
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(iters):
    if device.type == 'cuda':
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn()
      end.record()
      end.synchronize()
      times.append(start.elapsed_time(end))
    else:
      begin = time.perf_counter()
      fn()
      times.append((time.perf_counter() - begin) * 1e3)
  return statistics.median(times)


def counted(fn):
  with flopslib.FlopCounter() as counter:
    fn()
  return counter.flops


def card_line():
  """nvidia-smi's name and power limit of the card, or None."""
  try:
    query = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
  except OSError:
    return None
  return query.stdout.strip().splitlines()[0] if query.returncode == 0 else None


def profile(argv, device, warmup, iters):
  """The profile of the DreamerV3 agent of `argv` (configs.yaml flags) on
  `device`, as a dict."""
  config = common.assemble_config(dmain.CONFIGS, argv + [
      '--torch.precompile', 'False'])
  agent = dmain.make_agent(config, device=str(device))
  model = agent.model
  B, T = agent.batch_size, agent.batch_length + agent.replay_context
  host = agent._example_batch(B, T, spaces=model.ext_space)
  host['is_first'][:, 0] = True
  data = {k: agent._to_device(v) for k, v in host.items()}
  draws = nn.dists.Draws(
      torch.Generator(agent.device).manual_seed(0), agent.device)
  params = list(model.opt.params.values())
  fns = segments(model, prepare(model, model.init_train(B), data, draws),
                 draws)
  meta = flopslib.meta_copy(model)
  meta_draws = nn.dists.Draws(None, flopslib.META)
  meta_fns = segments(meta, prepare(
      meta, meta.init_train(B), flopslib.to_meta(data), meta_draws),
      meta_draws)
  meta_params = list(meta.opt.params.values())
  peak = peak_flops(agent.device)
  rows = {}

  def row(name, ms, flops):
    rows[f'{name}/ms'] = ms
    rows[f'{name}/flops'] = flops
    rows[f'{name}/tflops'] = flops / ms / 1e9
    rows[f'{name}/mfu'] = flops / ms / 1e-3 / peak if peak else None

  # The train step first, before the segments' graphs exist.
  batch = agent._example_batch(B, T)
  carry = agent.init_train(B)

  def step():
    nonlocal carry
    carry, _, _ = agent.train(carry, batch)
  row('train', timed(step, agent.device, warmup, iters),
      agent.train_cost()['flops'])
  for name in SEGMENTS:
    with torch.no_grad():
      row(f'{name}/fwd', timed(fns[name], agent.device, warmup, iters),
          counted(meta_fns[name]))
    row(f'{name}/fwdbwd', timed(
        fwdbwd(fns[name], params), agent.device, warmup, iters),
        counted(fwdbwd(meta_fns[name], meta_params)))
  return dict(
      argv=argv, batch=B, length=agent.batch_length,
      replay_context=agent.replay_context, device=str(agent.device),
      device_name=(torch.cuda.get_device_name(agent.device)
                   if agent.device.type == 'cuda' else 'cpu'),
      card=card_line() if agent.device.type == 'cuda' else None,
      parameters=sum(p.numel() for p in model.parameters()),
      peak_flops=peak, timing='cuda events' if agent.device.type == 'cuda'
      else 'wall clock', warmup=warmup, iters=iters, segments=rows)


def main(args=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--configs', nargs='*', default=[],
                      help='configs.yaml presets (none: the defaults)')
  parser.add_argument('--task', default='dummy_disc')
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--warmup', type=int, default=3)
  parser.add_argument('--iters', type=int, default=10)
  parser.add_argument('--out', default='')
  args, rest = parser.parse_known_args(args)
  argv = ['--task', args.task] + rest
  if args.configs:
    argv = ['--configs', *args.configs] + argv
  if args.device == 'cuda' and not torch.cuda.is_available():
    raise SystemExit('No CUDA device: pass --device cpu to run on the CPU')
  result = profile(argv, torch.device(args.device), args.warmup, args.iters)
  text = json.dumps(result, indent=2)
  print(text)
  if args.out:
    with open(args.out, 'w') as f:
      f.write(text + '\n')
  return result


if __name__ == '__main__':
  main()
