"""Where the time of one policy call goes, on one CUDA card.

    python -m embodied_tpu_torch.tools.profile_policy [--configs size12m]
        [--envs 16] [--calls 100] [--out profile_policy.json]

Builds the DreamerV3 agent through `make_agent` on the card and drives it
with the `Driver` over `--envs` dummy_disc envs for `--calls` policy calls
(after as many for warm-up). Then, on the last carry and observations:

- stages: CUDA-event time of each stage of `Model.policy` run on its own
  (observations to the card, encoder, observe step, policy head and
  sample, outputs to the host), median over `--calls` repeats;
- steady: host ms per Driver tick and per policy call over `--calls`
  ticks without the profiler;
- trace: `torch.profiler` (CUDA activity only, to keep the host's cost
  low) over `--calls` more ticks: host ms per tick under the profiler,
  device-busy ms per call (the union of kernel intervals), kernels per
  call, and the kernels with the most device time. The card's idle share
  is 1 - busy / steady tick time.

Prints one JSON line (and writes it to `--out`). Needs a card; it does not
fall back to the CPU.
"""

import argparse
import json
import pathlib
import statistics
import sys
import time

import torch

from .. import core, nn
from ..models import common
from ..models.dreamerv3 import main as dreamer


def event_ms(fn, repeats):
  """Median CUDA-event time of `fn()` over `repeats` calls, after one."""
  fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(repeats):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def stage_ms(agent, carry, obs, repeats):
  """Each stage of Model.policy on its own, in the order policy runs them."""
  model = agent.model
  obs = {k: v for k, v in obs.items() if not k.startswith('log/')}
  dev = {k: agent._to_device(v) for k, v in obs.items()}
  carry = nn.core.tree_map(agent._to_device, carry)
  reset = dev['is_first']
  gen = torch.Generator(agent.device).manual_seed(0)
  out = {}
  with torch.inference_mode():
    _, _, tokens = model.enc({}, dev, reset, single=True)
    _, _, feat = model.dyn.observe(carry[1], tokens, carry[3], reset, gen=gen)
    feat2 = model._feat2tensor(feat)
    act, outs = model.policy(carry, dev, 'train', gen)[1:]
    stages = dict(
        to_device=lambda: {k: agent._to_device(v) for k, v in obs.items()},
        encoder=lambda: model.enc({}, dev, reset, single=True),
        observe=lambda: model.dyn.observe(
            carry[1], tokens, carry[3], reset, gen=gen),
        policy_head=lambda: {
            k: v.sample(gen) for k, v in model.pol(feat2, bdims=1).items()},
        to_host=lambda: {k: v.cpu().numpy() for k, v in {
            **act, **outs}.items()},
        whole=lambda: model.policy(carry, dev, 'train', gen))
    for name, fn in stages.items():
      out[name] = event_ms(fn, repeats)
  return out


def busy_ms(intervals):
  """Length of the union of (start, end) intervals, in the input's unit."""
  total, reach = 0.0, None
  for start, end in sorted(intervals):
    if reach is None or start > reach:
      total += end - start
      reach = end
    elif end > reach:
      total += end - reach
      reach = end
  return total


def steady(driver, policy, stats, calls):
  """Host ms per Driver tick and per policy call, without the profiler."""
  stats.update(policy_s=0.0)
  torch.cuda.synchronize()
  start = time.perf_counter()
  driver(policy, steps=calls * driver.length)
  torch.cuda.synchronize()
  tick_ms = (time.perf_counter() - start) * 1e3 / calls
  return dict(tick_ms=tick_ms, policy_ms=stats['policy_s'] * 1e3 / calls)


def trace(driver, policy, calls, top=12):
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  start = time.perf_counter()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    driver(policy, steps=calls * driver.length)
    torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - start) * 1e3
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
  busy = busy_ms(intervals) / 1e3
  span = ((max(e for _, e in intervals) - min(s for s, _ in intervals)) /
          1e3 if intervals else 0.0)
  rows = {}
  for e in kernels:
    row = rows.setdefault(e.name, [0, 0.0])
    row[0] += 1
    row[1] += (e.time_range.end - e.time_range.start) / 1e3
  ranked = sorted(rows.items(), key=lambda kv: -kv[1][1])[:top]
  return dict(
      tick_ms_profiled=wall_ms / calls,
      device_busy_ms_per_call=busy / calls,
      device_kernels_per_call=len(kernels) / calls,
      device_span_ms_per_call=span / calls,
      top_kernels=[dict(name=name[:120], launches_per_call=n / calls,
                        ms_per_call=ms / calls)
                   for name, (n, ms) in ranked])


def profile_policy(argv, envs, calls):
  config = common.assemble_config(dreamer.CONFIGS, argv)
  agent = dreamer.make_agent(config)
  if agent.device.type != 'cuda':
    raise RuntimeError('profile_policy measures the card: no CUDA device')
  driver = core.Driver(
      [lambda i=i: common.make_env(config, i) for i in range(envs)],
      parallel=False, mode='train')
  last, stats = {}, {}

  def policy(carry, obs, mode='train'):
    start = time.perf_counter()
    carry, act, out = agent.policy(carry, obs, mode)
    stats['policy_s'] += time.perf_counter() - start
    last.update(carry=carry, obs=obs)
    return carry, act, out

  driver.reset(agent.init_policy)
  stats.update(policy_s=0.0)
  driver(policy, steps=calls * envs)
  result = dict(
      argv=argv, envs=envs, calls=calls,
      card=torch.cuda.get_device_name(0),
      steady=steady(driver, policy, stats, calls),
      stages_ms=stage_ms(agent, last['carry'], last['obs'], calls),
      trace=trace(driver, policy, calls))
  result['idle_share'] = 1 - (result['trace']['device_busy_ms_per_call'] /
                              result['steady']['tick_ms'])
  driver.close()
  return result


def main(args=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--configs', default='size12m')
  parser.add_argument('--task', default='dummy_disc')
  parser.add_argument('--envs', type=int, default=16)
  parser.add_argument('--calls', type=int, default=100)
  parser.add_argument('--out', default='')
  parsed, rest = parser.parse_known_args(args)
  if not torch.cuda.is_available():
    print('profile_policy: no CUDA device', file=sys.stderr)
    sys.exit(2)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  argv = ['--configs', parsed.configs, '--task', parsed.task] + rest
  result = profile_policy(argv, parsed.envs, parsed.calls)
  line = json.dumps(result)
  print(line, flush=True)
  if parsed.out:
    path = pathlib.Path(parsed.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(line + '\n')


if __name__ == '__main__':
  main()
