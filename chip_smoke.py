"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each printing one JSON line:

  device   the card's name and power limit (nvidia-smi); TF32 off.
  build    nvcc builds every kernel of the port from csrc/, in parallel.
  kernels  each kernel, at the shapes of DreamerV3 size12m, is held against
           its plain PyTorch version on the same bf16 inputs, and timed
           beside the plain version and its bound on the card: `ms` is
           device time (profiler), `call_ms` the CUDA-event time of a
           whole wrapper call (host launch cost included when it
           dominates), `ms_cold` the same with the L2 flushed first.
  slice    the acting path of size12m on dummy_disc with 16 envs, through
           make_agent -> init_policy -> Driver(agent.policy), in train and
           eval mode. The launch counts show that it ran on the kernels;
           its outputs are checked against the plain path on the card.

The line before the last lists every kernel; the last line is
{"ok": true, "device": {...}}. Any failed phase exits non-zero before it.
The script imports nothing of JAX or of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (dense): HBM bytes/s and bf16 flop/s.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
SEED = 0
ENVS = 16
WARMUP = 10  # policy calls left out of the per-call times (set-up, cuDNN)
TOL = 3e-2  # |kernel - plain| <= TOL + TOL |plain|: bf16 rounds elsewhere.


def emit(**fields):
  print(json.dumps(fields), flush=True)


def fail(phase, message):
  emit(phase=phase, ok=False, error=message)
  sys.exit(1)


def phase_device(torch):
  query = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
  if query.returncode:
    fail('device', f'nvidia-smi failed: {query.stderr.strip()}')
  card = query.stdout.strip().splitlines()[0]
  print(card, flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  emit(phase='device', ok=True, nvidia_smi=card,
       name=torch.cuda.get_device_name(0),
       count=torch.cuda.device_count(), torch=torch.__version__,
       cuda=torch.version.cuda, matmul_allow_tf32=False,
       cudnn_allow_tf32=False)


def phase_build():
  from embodied_tpu_torch.ops import build
  start = time.perf_counter()
  seconds = build.build(['blockgru', 'observe'])
  regs = {}
  for name in ('blockgru', 'observe'):
    log = build.target(name).with_suffix('.so.log')
    if log.exists():
      regs[name] = [line.strip() for line in log.read_text().splitlines()
                    if 'registers' in line or 'spill' in line]
  emit(phase='build', ok=True, seconds=time.perf_counter() - start,
       per_source=seconds, ptxas=regs)


def size12m_params(torch, gen, D=2048, H=256, S=512, g=8, K=2304, L=512):
  """Core and posterior weights of size12m from a seed, in the FIELDS
  order: matrices with std 1/sqrt(fan_in), small biases, unit-ish norm
  scales; bf16 except the float32 scales."""
  dg = D // g
  dev = 'cuda'

  def mat(*shape):
    fan = shape[-2]
    w = torch.randn(shape, generator=gen, device=dev) / fan ** 0.5
    return w.to(torch.bfloat16)

  def vec(n, scale=0.1):
    v = scale * torch.randn((n,), generator=gen, device=dev)
    return v.to(torch.bfloat16)

  def norm(n):
    return 1 + 0.1 * torch.randn((n,), generator=gen, device=dev)

  core = (mat(D, H), vec(H), norm(H), mat(S, H), vec(H), norm(H),
          mat(g, dg, dg), vec(D), mat(3 * H, D), norm(D),
          mat(g, dg, 3 * dg), vec(3 * D))
  head = (mat(D + K, H), vec(H), norm(H), mat(H, L), vec(L))
  return core, head


def step_inputs(torch, gen, B, D=2048, H=256, S=32, C=16, K=2304):
  dev = 'cuda'
  deter = torch.tanh(torch.randn((B, D), generator=gen, device=dev))
  index = torch.randint(0, C, (B, S), generator=gen, device=dev)
  stoch = torch.nn.functional.one_hot(index, C).reshape(B, S * C)
  act = torch.nn.functional.silu(
      torch.randn((B, H), generator=gen, device=dev))
  tokens = torch.randn((B, K), generator=gen, device=dev)
  bf = lambda x: x.to(torch.bfloat16).contiguous()
  return bf(deter), bf(stoch), bf(act), bf(tokens)


def cuda_ms(torch, fn, warmup=10, iters=50, flush=None):
  """Median of per-call CUDA-event timings after warm-up. With `flush`, a
  buffer larger than the 50 MB L2 is overwritten before each call, so the
  weights come from device memory (the `_cold` times)."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(iters):
    if flush is not None:
      flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def device_ms(torch, fn, iters=20):
  """Device time of one call of `fn`: the durations of the kernels it
  launched, from torch.profiler, averaged over `iters` calls. Unlike the
  CUDA-event times, it leaves out the host's time to launch them."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  spans = [e.time_range for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
  if not spans:
    raise RuntimeError('the profiler saw no device activity')
  return sum(t.end - t.start for t in spans) / 1e3 / iters


def compare(torch, got, want):
  got, want = got.float(), want.float()
  if not torch.isfinite(got).all():
    return float('inf'), False
  err = (got - want).abs()
  ok = bool((err <= TOL + TOL * want.abs()).all())
  return float(err.max()), ok


def bound(nbytes, flops):
  t_bytes = nbytes / PEAK_BYTES * 1e3
  t_ops = flops / PEAK_BF16 * 1e3
  return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def phase_kernels(torch):
  from embodied_tpu_torch.ops import blockgru, observe
  gen = torch.Generator('cuda').manual_seed(SEED)
  core, head = size12m_params(torch, gen)
  flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device='cuda')
  results = []
  cases = [('core_step', 16), ('core_step', 1024), ('obs_step', 16)]
  for name, B in cases:
    deter, stoch, act, tokens = step_inputs(torch, gen, B)
    if name == 'core_step':
      args = (deter, stoch, act, core)
      kernel = lambda: blockgru.core_step(*args)
      plain = lambda: blockgru.reference_step(*args)
      nbytes, flops = blockgru.work(B, 2048, 256, 512, 256, 8)
    else:
      args = (deter, stoch, act, tokens, core + head)
      kernel = lambda: observe.obs_step(*args)
      plain = lambda: observe.reference_obs_step(*args)
      nbytes, flops = observe.work(B, 2048, 256, 512, 256, 8, 2304, 512)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [compare(torch, a, b) for a, b in zip(got, want)]
    err = max(e for e, _ in errs)
    ok = all(o for _, o in errs)
    bound_ms, bound_by = bound(nbytes, flops)
    row = dict(name=name, batch=B, max_abs_err=err, tol=TOL, ok=ok,
               ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
               call_ms=cuda_ms(torch, kernel),
               plain_call_ms=cuda_ms(torch, plain),
               ms_cold=cuda_ms(torch, kernel, flush=flush),
               plain_ms_cold=cuda_ms(torch, plain, flush=flush),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops)
    emit(phase='kernel', **row)
    results.append(row)
    if not ok:
      fail('kernels', f'{name} at B={B} disagrees with its plain version: '
                      f'max abs err {err}')
  emit(phase='kernels', ok=True)
  return results


def drive(argv, calls, modes):
  """Build the agent for `argv` (on the card unless `--torch.device cpu`)
  and drive it over ENVS dummy envs for `calls` policy calls per mode.
  Returns the agent, timings and the last carry and observations."""
  from embodied_tpu_torch import core
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main
  config = common.assemble_config(main.CONFIGS, argv)
  agent = main.make_agent(config)
  driver = core.Driver(
      [lambda i=i: common.make_env(config, i) for i in range(ENVS)])
  stats = dict(policy_ms=[], bad_actions=0, nonfinite=0)
  space = agent.act_space['action']
  last = {}

  def policy(carry, obs, mode='train'):
    start = time.perf_counter()
    carry, act, out = agent.policy(carry, obs, mode)
    stats['policy_ms'].append((time.perf_counter() - start) * 1e3)
    a = act['action']
    stats['bad_actions'] += int(((a < space.low) | (a >= space.high)).sum())
    stats['nonfinite'] += sum(
        int((~v).sum()) for k, v in out.items() if k.startswith('log/finite'))
    for key in ('dyn/deter', 'dyn/stoch'):
      assert key in out and out[key].shape[0] == ENVS, key
    last.update(carry=carry, obs=obs)
    return carry, act, out

  wall = 0.0
  for mode in modes:
    driver.kwargs = dict(mode=mode)
    driver.reset(agent.init_policy)
    start = time.perf_counter()
    driver(policy, steps=calls * ENVS)
    wall += time.perf_counter() - start
  driver.close()
  stats.update(wall_s=wall)
  return agent, stats, last


def check_against_plain(torch, agent, last):
  """One observe step on the card through the kernel path and through the
  plain path (kernel: off), with the same carry, inputs and Gumbel noise."""
  from embodied_tpu_torch.nn import dists
  model = agent.model
  carry, obs = last['carry'], {
      k: agent._to_device(v) for k, v in last['obs'].items()}
  dyn = model.dyn
  gen = torch.Generator(agent.device).manual_seed(SEED + 1)
  noise = dists.gumbel((ENVS, dyn.stoch, dyn.classes), gen, agent.device)
  outs = {}
  with torch.inference_mode():
    _, _, tokens = model.enc({}, obs, obs['is_first'], single=True)
    for mode in ('auto', 'off'):
      dyn.kernel = mode
      _, _, feat = dyn.observe(
          carry[1], tokens, carry[3], obs['is_first'], noise=noise)
      outs[mode] = feat
    dyn.kernel = 'auto'
  errs = {k: compare(torch, outs['auto'][k], outs['off'][k])
          for k in ('deter', 'logit')}
  same = (outs['auto']['stoch'].argmax(-1) == outs['off']['stoch'].argmax(
      -1)).float().mean().item()
  return errs, same


SLICE_PATHS = (
    ('acting size12m', ['--configs', 'size12m', '--task', 'dummy_disc'],
     200, ('train', 'eval'), 'obs_step'),
    ('acting size12m, 2-layer posterior',
     ['--configs', 'size12m', '--task', 'dummy_disc',
      '--agent.dyn.rssm.obslayers', '2'], 50, ('train',), 'core_step'),
)


def phase_slice(torch, paths=SLICE_PATHS):
  """Drives each path with the launch counts set to 0 just before and read
  just after; `name` is the kernel whose count must equal the number of
  policy calls on that path."""
  from embodied_tpu_torch.ops import blockgru, observe
  wrappers = dict(core_step=blockgru.core_step, obs_step=observe.obs_step)
  launches = {}
  for label, argv, calls, modes, name in paths:
    for wrapper in wrappers.values():
      wrapper.launches = 0
    agent, stats, last = drive(argv, calls, modes)
    counts = {k: w.launches for k, w in wrappers.items()}
    launches[name] = counts[name]
    errs, same = check_against_plain(torch, agent, last)
    times = stats['policy_ms']
    n = len(times)
    steady = sorted(times[WARMUP:])
    row = dict(
        phase='slice', path=label, argv=argv, envs=ENVS, launches=counts,
        policy_calls=n, first_call_ms=times[0],
        ms_per_policy_call=statistics.median(steady),
        ms_per_policy_call_p97_5=steady[int(0.975 * len(steady))],
        steady_calls=len(steady),
        policy_steps_per_s=len(steady) * ENVS / sum(steady) * 1e3,
        env_steps_per_s=n * ENVS / stats['wall_s'],
        bad_actions=stats['bad_actions'], nonfinite=stats['nonfinite'],
        plain_max_abs_err={k: e for k, (e, _) in errs.items()},
        sample_agreement=same,
        peak_mem_mb=(torch.cuda.max_memory_allocated() / 2 ** 20
                     if agent.device.type == 'cuda' else None))
    problems = []
    if counts[name] != n:
      problems.append(f'{name} launched {counts[name]} times in {n} calls')
    if stats['bad_actions'] or stats['nonfinite']:
      problems.append('actions out of range or non-finite outputs')
    if not all(ok for _, ok in errs.values()):
      problems.append(f'kernel path disagrees with the plain path: {errs}')
    row['ok'] = not problems
    emit(**row)
    if problems:
      fail('slice', '; '.join(problems))
    del agent
    if torch.cuda.is_available():
      torch.cuda.empty_cache()
  return launches


def main():
  try:
    import torch
  except ImportError:
    print('chip_smoke: PyTorch is not installed', file=sys.stderr)
    sys.exit(2)
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this script measures the card',
          file=sys.stderr)
    sys.exit(2)
  sys.path.insert(0, ROOT)
  try:
    import embodied_tpu_torch  # noqa: F401
  except ImportError as e:
    print(f'chip_smoke: run from a checkout of the repository ({e})',
          file=sys.stderr)
    sys.exit(2)
  phase_device(torch)
  phase_build()
  rows = phase_kernels(torch)
  launches = phase_slice(torch)
  sources = dict(
      core_step=('embodied_tpu_torch/csrc/blockgru.cu',
                 'embodied_tpu/ops/blockgru.py:126'),
      obs_step=('embodied_tpu_torch/csrc/observe.cu',
                'embodied_tpu/ops/observe.py:99'))
  kernels = []
  for row in rows:
    if row['batch'] != ENVS:
      continue  # The list holds the main path's shapes.
    source, replaces = sources[row['name']]
    kernels.append(dict(
        name=row['name'], route='cuda', source=source,
        replaces=replaces, launches=launches[row['name']],
        max_abs_err=row['max_abs_err'], ms=row['ms'],
        plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
        bound_by=row['bound_by'], library_ms=None))
  print(json.dumps({'kernels': kernels}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
  main()
