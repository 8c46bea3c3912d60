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
           dominates), `ms_cold` the same with the L2 flushed first. The
           window, rollout and imagination-step kernels are held against
           the plain version replaying their own samples, their samples
           against the plain draw from the same noise, and the backward
           kernels (the window's, the core step's and the observe
           step's) against autograd of the plain version in float32;
           the window's backward runs twice on the same inputs and must
           give the same bits.
           Then kernels 3, 5, 6 and 8 and the int8 window (kernel 9) at
           the default configuration's dims, the same way; the rows of
           the windows and the rollout add the streamed floor, the time
           to read their weights once per step, which at these dims
           exceed the L2. The rollout runs twice on the same inputs and
           must give the same bits, and so must the int8 window. Last,
           `stage` rows: the 128-row tensor-core stage alone on each shape
           class of the default rollout's products, its TFLOP/s beside
           one torch.matmul or torch.bmm on the same operands
           (`library_ms`); and `stage16` rows: the 16-row stage alone on
           each shape class of the default window's products, in int8
           with column scales and in bf16 on the same values, its weight
           bytes' rate as a share of the memory rate.
  optim    the optimizer's update (ops/optim.py) on the leaves of
           DreamerV3's 200M and 400M optimizers (79 each), random
           parameters and gradients at lr 1e-2: the kernel pair against
           its plain version over 3 steps in the fused layout, with
           weight decay and nesterov, without momentum, and under the
           loss scale, and in the per-parameter layout under the loss
           scale with weight decay; both loss-scale cases with an inf
           planted in the second step's gradient (per leaf, the
           parameters, their change, the RMS and the momentum within
           1e-5 by norm; the step and the loss scale equal; the
           parameters unmoved on the overflow); each kernel step run
           twice from the same state under the sync guard, bit for bit;
           one launch a call; the kernels' device ms and a call's ms
           beside the plain version's and the bound (36 bytes a
           parameter). The train phases count one launch a train step
           on the main path.
  slice    the acting path of size12m on dummy_disc with 16 envs, through
           make_agent -> init_policy -> Driver(agent.policy), in train and
           eval mode. The launch counts show that it ran on the kernels;
           its outputs are checked against the plain path on the card.
  train    the train step of size12m: a 16 x 65 batch collected by the
           acting path, then Agent.train for a few warm-up and 10 timed
           steps on dummy_disc (each launching the window's forward and
           backward kernels and the rollout kernel once), the first step's
           losses against the plain path (kernel: off), and a profile of
           two steps; then a short dummy_cont run (bounded normal head).
  modes    the other kernel paths of the train step and the report, each
           with the launch counts set to 0 before and read after: 3 train
           steps and one Agent.report under `kernel: fused` (the per-step
           observe kernels, forward and backward), `kernel: imag` (the
           imagination-step kernel) and `obslayers: 2` (the core step's
           kernels, forward and backward), each first step's losses
           against `kernel: off`.
  qcore    the int8 window's validation at the default dims (the port of
           runs/validate_qcore_tpu.py): weight MB in int8 and bf16, the
           int8 window against the window on the dequantized weights, its
           deter against the bf16 window's (the quantization error), and
           the int8 and bf16 window kernels timed in turns (CUDA events),
           and the device kernels of one int8 window by name (profiler).
  default  the default configuration (no preset, 202,982,304 parameters):
           policy calls on dummy_disc and on PinPad (pinpad_three, 16
           envs), Agent.train steps with the losses against kernel: off
           and a profile, and main.main with the process driver, script
           train_eval on dummy_disc and on PinPad with its episodes cut
           to 300 steps, to budgets of 35 and 50 s (train steps, reports,
           train and eval episodes with their scores, and a save); env
           steps/s of the two runs side by side.
  parallel script=parallel at the default configuration on PinPad
           (300-step episodes) in-process, to a budget of 40 s from its
           first train step: 16 train and 4 eval env processes, a replay
           and a logger process, the actor (8 envs a policy call, kernel
           3, held against its plain version on the actor's last
           request) and the learner (kernels 5, 6 and 8 each train step,
           5 and 8 in its reports) in this process, which alone may hold
           the card; the native codec, env steps/s beside the PinPad
           train_eval run's, train frames/s, the replayed-to-env ratio,
           the actor's ms per call and lock wait, the RPC servers' stats,
           a logged report and finite train losses, no failed actor call
           or role, and no child process or thread left when it returns.
  parallel_group
           script=parallel at the default configuration on PinPad on a
           process group of two ranks (two NCCL ranks on two cards, else
           two gloo ranks on one), as a multi-host launcher starts them,
           8 rows a rank on the '2,1,1' mesh, 4 train and 1 eval env a
           rank, to a budget of 40 s from the first train step, when
           rank 0 is interrupted: equal train calls on the ranks, each
           launching kernels 5, 6 and 8 once, kernel 3 once an actor
           call on each rank and against its plain version on rank 1's
           last request, kernels 5, 6 and 8 against theirs at a rank's
           shapes (8 rows, 512 rollout starts), reports and saves at the
           same train-call
           indices, saved stores equal bit for bit, no child on the card
           and nothing left behind; per rank env steps/s, the replay
           ratio, the actor's ms and lock wait, peak MB; the global train
           frames/s and the collectives a train step makes.
  latents  the device-resident latent table at the default configuration
           and at size12m: the table's slots, bytes and regions; policy
           calls on the table path and on the host path (latents in the
           batch) from one store, the table's rows at the returned slots
           equal to the host path's latents bit for bit; the first train
           step from those slots against the host path (losses,
           latents/valid, the refreshed rows), and with stale generations;
           then train steps in turns, (a) the host path (the phases
           above), (b) the defaults (the table, fetch_depth 3, batches
           through agent.stream) and (c) the defaults on numpy batches:
           ms per step, the card's busy time and idle share, the bytes
           that cross per step, and where the host waited for the card.
           It runs after qcore and before default.
  script   the port's `train` and `train_eval` scripts, main.main([...])
           in-process, on size12m with 16 dummy_disc envs and the default
           process driver: each trains, reports, logs and saves, then runs
           again on the same logdir and must resume from the checkpoint;
           train_eval also runs eval episodes and eval reports. Then
           eval_only from the train_eval checkpoint, with the DreamerV3
           agent and with the random agent.
  ppo      PPO's default configuration (models/ppo/configs.yaml) on
           PinPad (pinpad_three, 300-step episodes): its parameter count,
           20 policy calls of 16 envs, 1 warm-up and 3 timed train steps
           on a 16 x 65 batch that those calls collected, with finite
           losses and a profile, main.main `train` on a 20 s budget with
           the process driver (env steps/s, episodes), and the JAX
           package's bandit learning check (tests/test_learning.py) on
           the card with its thresholds, run in a child interpreter
           (this script with --bandit) beside phase script. PPO launches
           no kernel.
  director Director's default configuration on PinPad: 20 policy calls
           of 16 envs, one launch of kernel 3 each, held against the plain
           path; 1 warm-up and 3 timed train steps, each one launch of
           kernels 5 and 6 and one of kernel 1 per step of the
           hierarchy's 16-step rollout, the first step's losses against
           kernel: off, and a profile; main.main `train_eval` on a 25 s
           budget.
  distributed
           the default configuration on a process group: parallel.setup
           starts one NCCL rank at a localhost coordinator, with the
           policy/train split (torch.policy_mesh '1,1,1'). 20 policy
           calls on the split's copy (kernel 3 once each), its observe
           step against the trained model's; one train step from one
           store, batch and noise with and without the group (losses at
           LOSS_RTOL, every trained tensor's update at GRAD_RTOL) with the
           collectives it makes and their bytes; 1 + 3 timed steps in
           turns with, without, without and with the group (kernels 5, 6
           and 8 once a step); the copy stale after a
           train step until the next policy call refreshes it (its bytes,
           the refresh's ms). On a machine with two cards, two NCCL ranks
           of 8 rows against the one-rank step; else "ranks_2": "not run:
           1 card". Then the sharded store ("sharded"): two ranks of 8
           rows at torch.mesh '1,2,1', each holding half of every kernel
           and embedding, against the same two ranks at '2,1,1'
           (replicated): NCCL on two cards, else gloo on one card with
           torch.transfer_guard off (gloo waits on its copies of CUDA
           tensors through the host); each rank's store bytes between
           calls against the placements', the policy copy's bytes, the
           collectives of a step and their bytes, ms per step, the
           metrics of 3 steps and the saved store equal bit for bit, and
           kernel 3 on the copy in policy calls that make no collective.
  diagnostics
           the default configuration's diagnostics on dummy_disc, with the
           defaults (the latent table, fetch_depth 3, the sync guard,
           precompile): the train step's FLOPs (train_cost, printed at
           construction) equal under kernel: auto and off and above the
           products of kernels 5, 6 and 8 alone, the first step after the
           count equal bit for bit to an agent's that never counted; 120
           train steps on a batch the policy collected, the profiler
           window tracing updates 100-119, ms per train step (CUDA events,
           updates 20-99), TFLOP/s and MFU beside the card's name and
           power limit, the trace read by the port's viewer (device
           events, the largest ops, 20 launches each of kernels 5, 6 and
           8); a planted .item() that the sync guard must refuse; and in a
           child interpreter (this script with --deterministic),
           torch.deterministic at size1m: two train steps from one store
           and batch equal bit for bit, and a step on the latent table.
  encoder_modes
           the Encoder and Decoder's other modes at the default RSSM
           widths on dummy_disc, each set by the JAX package's config keys
           (s2d 0, mults [2,3,4,4]): `strided` (stride-2 convolutions,
           transposed ones in the decoder, bspace 0; tokens 4,096 wide)
           and `outer` (the pooled stack with its first layer unpooled;
           tokens 16,384 wide): the parameter count and token width, 10
           policy calls (kernel 3, the last against the plain path) and 3
           train steps (kernels 5, 6 and 8, the first step's losses
           against kernel: off), ms per train step and peak MB.
  nn_modules
           a Transformer (4 layers, units 1024, 16 heads, 4 key-value
           heads, causal) at B 8 and T 1024 in bf16: forward and
           forward+backward ms, its output and gradients on 2 rows against
           the same module in float32 on the CPU; StackedLayers of one
           block against the blocks unrolled, bit for bit; run.pretrain
           at the default configuration on a data.BagSampler over a bag
           written from a short dummy_disc run's replay, 20 s and then
           resumed from its checkpoint, the sampler's stream continued
           exactly (train steps, frames/s); ring attention on two NCCL
           ranks where the machine has two cards, else `ring_ranks: 1`.

The phases slice, train, modes, default, ppo, director and distributed
run the host path (HOST_PATH: torch.latent_slots 0, fetch_depth 0), on
which each train call returns its own step and can be held against the
plain path; the latents phase, the scripts, the parallel phase and the
diagnostics phase run the defaults. Every phase runs under the sync
guard (torch.transfer_guard, on by default).

Every row carries `seconds`, the time since its phase began (or its
own), and the `timing` row each phase's seconds. The line before the
last lists every kernel; the last line is {"ok": true, "device": {...}}.
Any failed phase exits non-zero before it.
The script imports nothing of JAX or of the JAX package.
"""

import gc
import json
import math
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
DEV = 'cuda'
ENVS = 16
WARMUP = 10  # policy calls left out of the per-call times (set-up, cuDNN)
TOL = 3e-2  # |kernel - plain| <= TOL + TOL |plain|: bf16 rounds elsewhere.
# The window backward's gradients against autograd of the plain replay in
# float32, as ||kernel - plain|| / ||plain|| per tensor: the kernel rounds
# its operands to bf16 (about 2^-9 relative each) and the weight gradients
# sum 1,024 rows, which averages the rounding down. Sound kernels read
# 0.0017 to 0.0049 at size12m; a weight gradient that leaves out the rows
# of one step of 64 reads far above this limit.
GRAD_RTOL = 1e-2
# Share of categorical samples that must equal the plain draw from the
# same logits and noise: a near-tie can round the other way in bf16.
SAMPLE_AGREEMENT = 0.99
# size12m's train step: a window of 64 steps of 16 sequences, and the
# rollout of 15 steps from all 16 x 64 of its states.
WINDOW = 64
IMAG_LENGTH = 15
IMAG_STARTS = 16 * 64
CLASSES = 16
UNIMIX = 0.01
MINSTD, MAXSTD = 0.1, 1.0
# Per-key losses of the first train step through the kernels against the
# same step on the plain path (kernel: off), same store, batch and noise,
# as |kernel - plain| <= LOSS_RTOL (1 + |plain|): bf16 rounds elsewhere,
# and a near-tie sample that flips moves the rest of its sequence. Sound
# kernels read within 0.05%.
LOSS_RTOL = 5e-3
# The phases slice, train, modes and default run the host path: the
# latents ride the batch (no latent table), and each train call returns
# its own step's results (no fetch pipeline), so a step can be held
# against the plain path on the same batch. Phase latents and the
# script runs take the defaults (the table, fetch_depth 3, prefetching).
HOST_PATH = ['--torch.latent_slots', '0', '--torch.fetch_depth', '0']
# Every phase but diagnostics builds its DreamerV3 agents without the FLOP
# count at construction (torch.precompile, on by default), which takes
# some 3 s of host time a default agent; phase diagnostics holds it.
NO_COUNT = ['--torch.precompile', 'False']


# The phase that runs and when it began, and each finished phase's
# seconds: main times every phase (timed), and each row that a phase
# prints carries `seconds` since the phase began, unless it gives its own.
PHASES = {'start': None, 'seconds': {}}


def timed(fn, *args):
  """fn(*args), a phase, with its seconds kept under its name."""
  PHASES['start'] = time.perf_counter()
  try:
    return fn(*args)
  finally:
    PHASES['seconds'][fn.__name__[len('phase_'):]] = (
        time.perf_counter() - PHASES['start'])
    PHASES['start'] = None


def emit(**fields):
  if PHASES['start'] is not None and 'seconds' not in fields:
    fields['seconds'] = time.perf_counter() - PHASES['start']
  print(json.dumps(fields), flush=True)


def fail(phase, message):
  emit(phase=phase, ok=False, error=message)
  sys.exit(1)


def card_line(phase='device'):
  """nvidia-smi's name and power limit of the card."""
  query = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
  if query.returncode:
    fail(phase, f'nvidia-smi failed: {query.stderr.strip()}')
  return query.stdout.strip().splitlines()[0]


def phase_device(torch):
  card = card_line()
  print(card, flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  emit(phase='device', ok=True, nvidia_smi=card,
       name=torch.cuda.get_device_name(0),
       count=torch.cuda.device_count(), torch=torch.__version__,
       cuda=torch.version.cuda, matmul_allow_tf32=False,
       cudnn_allow_tf32=False)


SOURCES = dict(  # kernel: (its source, the TPU kernel it replaces)
    core_step=('embodied_tpu_torch/csrc/blockgru.cu',
               'embodied_tpu/ops/blockgru.py:126'),
    core_step_bwd=('embodied_tpu_torch/csrc/blockgru.cu',
                   'embodied_tpu/ops/blockgru.py:308'),
    obs_step=('embodied_tpu_torch/csrc/observe.cu',
              'embodied_tpu/ops/observe.py:99'),
    obs_step_bwd=('embodied_tpu_torch/csrc/observe.cu',
                  'embodied_tpu/ops/observe.py:304'),
    imag_step=('embodied_tpu_torch/csrc/imagine.cu',
               'embodied_tpu/ops/imagine.py:129'),
    observe_seq=('embodied_tpu_torch/csrc/observe_seq.cu',
                 'embodied_tpu/ops/observe_seq.py:225'),
    observe_seq_bwd=('embodied_tpu_torch/csrc/observe_seq.cu',
                     'embodied_tpu/ops/observe_seq.py:437'),
    imagine_seq=('embodied_tpu_torch/csrc/imagine_seq.cu',
                 'embodied_tpu/ops/imagine_seq.py:196'),
    qobs_window=('embodied_tpu_torch/csrc/qcore.cu',
                 'embodied_tpu/ops/qcore.py:174'))
LIBRARIES = ('blockgru', 'observe', 'observe_seq', 'imagine_seq', 'imagine',
             'qcore', 'optim')


def phase_build():
  from embodied_tpu_torch.ops import build
  start = time.perf_counter()
  seconds = build.build(LIBRARIES)
  regs = {}
  for name in LIBRARIES:
    log = build.target(name).with_suffix('.so.log')
    if log.exists():
      regs[name] = [line.strip() for line in log.read_text().splitlines()
                    if 'registers' in line or 'spill' in line]
  emit(phase='build', ok=True, seconds=time.perf_counter() - start,
       per_source=seconds, ptxas=regs)


def makers(torch, gen, dev=None):
  """Weight makers from `gen`: matrices with std 1/sqrt(fan_in) and small
  biases in bf16, unit-ish norm scales in float32."""
  dev = dev or DEV

  def mat(*shape):
    fan = shape[-2]
    w = torch.randn(shape, generator=gen, device=dev) / fan ** 0.5
    return w.to(torch.bfloat16)

  def vec(n, scale=0.1):
    v = scale * torch.randn((n,), generator=gen, device=dev)
    return v.to(torch.bfloat16)

  def norm(n):
    return 1 + 0.1 * torch.randn((n,), generator=gen, device=dev)

  return mat, vec, norm


def size12m_params(torch, gen, D=2048, H=256, S=512, g=8, K=2304, L=512):
  """Core and posterior weights from a seed, in the FIELDS order; size12m's
  by default."""
  dg = D // g
  mat, vec, norm = makers(torch, gen)
  core = (mat(D, H), vec(H), norm(H), mat(S, H), vec(H), norm(H),
          mat(g, dg, dg), vec(D), mat(3 * H, D), norm(D),
          mat(g, dg, 3 * dg), vec(3 * D))
  head = (mat(D + K, H), vec(H), norm(H), mat(H, L), vec(L))
  return core, head


def step_inputs(torch, gen, B, D=2048, H=256, S=32, C=16, K=2304):
  dev = DEV
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


def device_ms(torch, fn, iters=20, attempts=3):
  """Device time of one call of `fn`: the durations of the kernels it
  launched, from torch.profiler, averaged over `iters` calls. Unlike the
  CUDA-event times, it leaves out the host's time to launch them. A
  profile that now and then returns no device events is taken again."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  for _ in range(attempts):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(iters):
        fn()
      torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if spans:
      return sum(t.end - t.start for t in spans) / 1e3 / iters
  raise RuntimeError(f'the profiler saw no device activity in {attempts} '
                     'profiles')


def graph_ms(torch, fn, calls=10, replays=10):
  """Device time of one call of `fn`, a call of one short kernel: a CUDA
  graph of `calls` calls, replayed and timed with CUDA events (median),
  which leaves out the host's launch cost. Late in a long run of this
  script on an H100 the profiler dropped events of such calls and read
  them 1.0-3.4x too fast; a graph's replay loses none."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(calls):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  times = []
  for _ in range(replays):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / calls)
  return statistics.median(times)


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
  gen = torch.Generator(DEV).manual_seed(SEED)
  core, head = size12m_params(torch, gen)
  flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=DEV)
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
  results += window_kernels(torch, gen, core + head, flush)
  for disc in (True, False):
    results.append(rollout_kernel(torch, gen, core, disc, flush))
  # Checks added later draw their inputs after the earlier ones, which
  # keep theirs.
  results += step_backward_kernels(torch, gen, core, head, flush)
  for B in (IMAG_STARTS, 6):
    results.append(imag_step_kernel(torch, gen, core, B, flush))
  results += default_kernels(torch, gen, flush)
  stage_rows(torch)
  stage16_rows(torch)
  emit(phase='kernels', ok=True)
  return results


def timings(torch, kernel, plain, flush, nbytes, flops, streamed=None):
  """Device, call and cold times of the kernel and its plain version, the
  bound, and with `streamed` (bytes) the streamed floor: the time to read
  those bytes once at the peak rate, for a kernel whose weights do not stay
  in the L2 and are read again at every step. The plain version is timed
  on fewer calls: its thousands of launches a call make each profile and
  call long, and its device times from 2 profiled calls came within 2.7%
  of those from 5 (PERF.md, section 6)."""
  bound_ms, bound_by = bound(nbytes, flops)
  row = dict(ms=device_ms(torch, kernel, iters=5),
             plain_ms=device_ms(torch, plain, iters=2),
             call_ms=cuda_ms(torch, kernel, warmup=2, iters=10),
             plain_call_ms=cuda_ms(torch, plain, warmup=1, iters=5),
             ms_cold=cuda_ms(torch, kernel, warmup=1, iters=5, flush=flush),
             bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
  if streamed is not None:
    row.update(streamed_bytes=streamed,
               streamed_floor_ms=streamed / PEAK_BYTES * 1e3)
  return row


def tensor_bytes(tensors):
  return sum(x.numel() * x.element_size() for x in tensors)


def relerr(got, want):
  got, want = got.float(), want.float()
  return float((got - want).norm() / want.norm().clamp(min=1e-12))


def agreement(onehot, logit, gumbel, C=CLASSES):
  """Share of (row, group) samples of the kernel that equal the plain
  draw from the plain logits of the same step, with the same noise."""
  from embodied_tpu_torch.ops import observe_seq
  drawn = observe_seq.gumbel_max(
      observe_seq.group_probs(logit, C, UNIMIX), gumbel)
  hard = onehot.float().reshape(drawn.shape)
  return float((drawn.argmax(-1) == hard.argmax(-1)).float().mean())


def check_row(name, row, problems, printed=True):
  """The row of a kernel's check, printed, failing the phase kernels on a
  problem; or, with `printed` false, returned with its problems for the
  caller to report."""
  row['ok'] = not problems
  if not printed:
    return dict(row, name=name, problems=problems)
  emit(phase='kernel', name=name, **row)
  if problems:
    fail('kernels', f'{name}: ' + '; '.join(problems))
  return dict(row, name=name)


def grad_check(names, got, want):
  """Per-tensor relative errors of kernel gradients against float32
  autograd of the plain version, the largest absolute error, and the
  tensors off by more than GRAD_RTOL."""
  pairs = list(zip(names, got, want))
  rel = {n: relerr(a, b) for n, a, b in pairs}
  err = max(float((a.float() - b.float()).abs().max()) for _, a, b in pairs)
  problems = [f'{n} relative error {e:.4f} > {GRAD_RTOL}'
              for n, e in rel.items() if not e <= GRAD_RTOL]
  return rel, err, problems


def step_backward_kernels(torch, gen, core, head, flush, B=ENVS, D=2048,
                          H=256, S=512, K=2304, L=512, g=8):
  """The core step's and the observe step's backward kernels at the train
  step's per-step shapes (B = 16, under obslayers: 2 and kernel: fused),
  against autograd of the plain versions in float32, with random upstream
  gradients."""
  from embodied_tpu_torch.ops import blockgru, observe
  deter, stoch, act, tokens = step_inputs(torch, gen, B)
  dout = torch.randn((B, D), generator=gen, device=DEV)
  dlogit = torch.randn((B, L), generator=gen, device=DEV)
  f32 = lambda xs: [x.float() for x in xs]
  rows = []
  cases = (
      ('core_step_bwd', blockgru.core_step_bwd, blockgru.reference_step_bwd,
       (deter, stoch, act), core, (dout,), blockgru.FIELDS,
       blockgru.work_bwd(B, D, H, S, H, g)),
      ('obs_step_bwd', observe.obs_step_bwd, observe.reference_obs_step_bwd,
       (deter, stoch, act, tokens), core + head, (dout, dlogit),
       observe.FIELDS, observe.work_bwd(B, D, H, S, H, g, K, L)))
  for name, kernel_fn, plain_fn, ins, params, ups, fields, work in cases:
    got = kernel_fn(*ins, params, *ups)
    want = plain_fn(*f32(ins), f32(params), *ups)
    names = ('deter', 'stoch', 'act', 'tok')[:len(ins)] + fields
    rel, err, problems = grad_check(
        names, [*got[:-1], *got[-1]], [*want[:-1], *want[-1]])
    kernel = lambda: kernel_fn(*ins, params, *ups)
    ups_bf = [u.to(torch.bfloat16) for u in ups]
    plain = lambda: plain_fn(*ins, params, *ups_bf)
    row = dict(batch=B, max_abs_err=err, relative_errors=rel,
               rtol=GRAD_RTOL, **timings(torch, kernel, plain, flush, *work))
    rows.append(check_row(name, row, problems))
  return rows


def imag_step_kernel(torch, gen, core, B, flush, D=2048, H=256, S=32):
  """The imagination-step kernel at the train step's rollout (B = 1024,
  under kernel: imag) and the report's open loop (B = 6), against the
  plain version replaying its sample."""
  from embodied_tpu_torch.nn import dists
  from embodied_tpu_torch.ops import imagine as ops
  C, L = CLASSES, S * CLASSES
  mat, vec, norm = makers(torch, gen)
  params = list(core) + [mat(D, H), vec(H), norm(H), mat(H, H), vec(H),
                         norm(H), mat(H, L), vec(L)]
  deter, stoch, act, _ = step_inputs(torch, gen, B, D, H, S, C)
  gum = dists.gumbel((B, L), gen, DEV)
  with torch.no_grad():
    new, onehot, logit = ops.imag_step(deter, stoch, act, gum, params, C,
                                       UNIMIX)
    torch.cuda.synchronize()
    rd, _, rl = ops.reference_imag_step(deter, stoch, act, gum, params, C,
                                        UNIMIX, hard=onehot)
  errs = [compare(torch, a, b) for a, b in ((new, rd), (logit, rl))]
  share = agreement(onehot, rl, gum)
  problems = []
  if not all(ok for _, ok in errs):
    problems.append(f'outputs off the replay: {errs}')
  if share < SAMPLE_AGREEMENT:
    problems.append(f'samples agree for {share:.4f} of the groups')
  kernel = lambda: ops.imag_step(deter, stoch, act, gum, params, C, UNIMIX)
  plain = lambda: ops.reference_imag_step(deter, stoch, act, gum, params, C,
                                          UNIMIX)
  with torch.no_grad():
    row = dict(batch=B, max_abs_err=max(e for e, _ in errs), tol=TOL,
               sample_agreement=share, min_agreement=SAMPLE_AGREEMENT,
               **timings(torch, kernel, plain, flush,
                         *ops.work(B, D, H, L, H, 8)))
  return check_row('imag_step', row, problems)


def window_kernels(torch, gen, params, flush, T=WINDOW, B=ENVS, D=2048,
                   H=256, S=32, K=2304, C=CLASSES, config='size12m',
                   timed=True):
  """The observe window's forward and backward kernels at a train step's
  shapes, against the plain version replaying the kernel's samples; with
  `timed` false, checked only, and returned unprinted (check_row)."""
  from embodied_tpu_torch.nn import dists
  from embodied_tpu_torch.ops import observe_seq as ops
  L = S * C
  deter0, stoch0, _, _ = step_inputs(torch, gen, B, D, H, S, C, K)
  bf = lambda x: x.to(torch.bfloat16).contiguous()
  acts = bf(torch.nn.functional.silu(
      torch.randn((T, B, H), generator=gen, device=DEV)))
  toks = bf(torch.randn((T, B, K), generator=gen, device=DEV))
  keep = torch.ones((T, B), device=DEV)
  keep[T // 2, ::4] = 0  # episodes that start inside the window
  gum = dists.gumbel((T, B, L), gen, DEV)
  ins = (deter0, stoch0, acts, toks, keep)
  with torch.no_grad():
    dseq, sseq, lseq = ops.observe_seq(*ins, gum, params, C, UNIMIX)
    torch.cuda.synchronize()
    rd, rs, rl = ops.reference_observe_seq(*ins, params, C, UNIMIX,
                                           hard=sseq)
  errs = [compare(torch, a, b) for a, b in ((dseq, rd), (lseq, rl))]
  share = agreement(sseq, rl, gum, C)
  problems = []
  if not all(ok for _, ok in errs):
    problems.append(f'outputs off the replay: {errs}')
  if share < SAMPLE_AGREEMENT:
    problems.append(f'samples agree for {share:.4f} of the groups')
  kernel = lambda: ops.observe_seq(*ins, gum, params, C, UNIMIX)
  plain = lambda: ops.reference_observe_seq(*ins, params, C, UNIMIX,
                                            gumbel=gum)
  dims = (T, B, D, H, L, H, K, 8)
  with torch.no_grad():
    fwd = dict(config=config, batch=B, steps=T,
               max_abs_err=max(e for e, _ in errs),
               tol=TOL, sample_agreement=share, min_agreement=SAMPLE_AGREEMENT,
               **(timings(torch, kernel, plain, flush, *ops.work(*dims),
                          streamed=T * tensor_bytes(params)) if timed else {}))
  rows = [check_row('observe_seq', fwd, problems, timed)]

  # The backward, with random upstream gradients of all three outputs.
  ups = [torch.randn(x.shape, generator=gen, device=DEV)
         for x in (dseq, sseq, lseq)]
  args = (deter0, stoch0, dseq, sseq, acts, toks, keep, params, *ups, C,
          UNIMIX)
  got = ops.observe_seq_bwd(*args)
  f32 = lambda xs: [x.float() for x in xs]
  want = ops.reference_observe_seq_bwd(
      *f32([deter0, stoch0, sseq, acts, toks]), keep, f32(params), *ups, C,
      UNIMIX)
  names = ('deter0', 'stoch0', 'acts', 'toks') + ops.FIELDS
  rel, err, problems = grad_check(
      names, [*got[:4], *got[4]], [*want[:4], *want[4]])
  # A second call on the same inputs gives the same bits: every sum runs
  # in a fixed order (split partials in split order, no atomics).
  again = ops.observe_seq_bwd(*args)
  bit_equal = all(torch.equal(a, b) for a, b in zip(
      [*got[:4], *got[4]], [*again[:4], *again[4]]))
  if not bit_equal:
    problems.append('two calls on the same inputs differ')
  kernel = lambda: ops.observe_seq_bwd(*args)
  ups_bf = [u.to(x.dtype) for u, x in zip(ups, (dseq, sseq, lseq))]
  plain = lambda: ops.reference_observe_seq_bwd(
      deter0, stoch0, sseq, acts, toks, keep, params, *ups_bf, C, UNIMIX)
  bwd = dict(config=config, batch=B, steps=T, max_abs_err=err,
             relative_errors=rel, rtol=GRAD_RTOL, bit_equal_calls=bit_equal,
             **(timings(torch, kernel, plain, flush, *ops.work_bwd(*dims),
                        streamed=2 * T * tensor_bytes(params)) if timed
                else {}))
  rows.append(check_row('observe_seq_bwd', bwd, problems, timed))
  return rows


def rollout_kernel(torch, gen, core, disc, flush, steps=IMAG_LENGTH,
                   B=IMAG_STARTS, D=2048, H=256, S=32, U=256, npol=3,
                   C=CLASSES, config='size12m', timed=True):
  """The imagination rollout at a train step's shapes (15 steps from
  16 x 64 starts) for a categorical (5 actions) or bounded normal (6)
  head, against the plain version replaying the kernel's samples; with
  `timed` false, checked only, and returned unprinted (check_row)."""
  from embodied_tpu_torch.nn import dists
  from embodied_tpu_torch.ops import imagine_seq as ops
  L = S * C
  adim = 5 if disc else 6
  mat, vec, norm = makers(torch, gen)
  f32vec = lambda n: vec(n).float()
  params = list(core) + [mat(D, H), vec(H), norm(H), mat(H, H), vec(H),
                         norm(H), mat(H, L), vec(L), mat(adim, H), vec(H),
                         norm(H)]
  for i in range(npol):
    params += [mat(D + L if i == 0 else U, U), vec(U), norm(U)]
  for _ in range(1 if disc else 2):
    params += [mat(U, adim), f32vec(adim)]
  deter0, stoch0, _, _ = step_inputs(torch, gen, B, D, H, S, C)
  gum = dists.gumbel((steps, B, L), gen, DEV)
  noise = (dists.gumbel((steps, B, adim), gen, DEV) if disc else
           torch.randn((steps, B, adim), generator=gen, device=DEV))
  spec = (npol, disc, C, UNIMIX, MINSTD, MAXSTD)
  with torch.no_grad():
    dseq, sseq, lseq, aseq = ops.imagine_seq(
        deter0, stoch0, gum, noise, params, *spec)
    torch.cuda.synchronize()
    rd, rs, rl, ra = ops.reference_imagine_seq(
        deter0, stoch0, params, *spec, gumbel=gum, noise=noise, hard=sseq,
        acts=aseq)
    outs = [(dseq, rd), (lseq, rl)] + ([] if disc else [(aseq, ra)])
    errs = [compare(torch, a, b) for a, b in outs]
    share = agreement(sseq, rl, gum, C)
    # The same replay in float32 (the bf16 weights and inputs widened),
    # which rounds nowhere: how far the kernel and the plain bf16 version
    # each sit from it, on the logits.
    wide = ops.reference_imagine_seq(
        deter0.float(), stoch0.float(), [x.float() for x in params], *spec,
        gumbel=gum, noise=noise, hard=sseq, acts=aseq)[2]
    f32_replay = dict(
        kernel=float((lseq - wide).abs().max()),
        plain=float((rl - wide).abs().max()))
    act_share = None  # a continuous head's actions are held by `errs`
    if disc:
      # The kernel's actions against the plain policy's draw from the
      # kernel's own states entering each step.
      prev = lambda x0, xs: torch.cat([x0[None], xs[:-1]]).reshape(
          steps * B, -1)
      p = dict(zip(ops.fields(npol, disc), params))
      hard, _ = ops.policy_action(
          p, prev(deter0, dseq), prev(stoch0, sseq),
          noise.reshape(steps * B, adim), npol, disc, MINSTD, MAXSTD)
      act_share = float((hard.argmax(-1) == aseq.reshape(
          steps * B, adim).argmax(-1)).float().mean())
    # A second call on the same inputs gives the same bits: every sum runs
    # in a fixed order (split partials in split order, no atomics).
    again = ops.imagine_seq(deter0, stoch0, gum, noise, params, *spec)
    bit_equal = all(torch.equal(a, b) for a, b in zip(
        (dseq, sseq, lseq, aseq), again))
  problems = []
  if not all(ok for _, ok in errs):
    problems.append(f'outputs off the replay: {errs}')
  if share < SAMPLE_AGREEMENT:
    problems.append(f'samples agree for {share:.4f} of the groups')
  if act_share is not None and act_share < SAMPLE_AGREEMENT:
    problems.append(f'actions agree for {act_share:.4f} of the rows')
  if not bit_equal:
    problems.append('two calls on the same inputs differ')
  kernel = lambda: ops.imagine_seq(deter0, stoch0, gum, noise, params, *spec)
  plain = lambda: ops.reference_imagine_seq(
      deter0, stoch0, params, *spec, gumbel=gum, noise=noise)
  work = ops.work(steps, B, D, H, L, H, U, adim, npol, 8, disc)
  with torch.no_grad():
    row = dict(config=config, batch=B, steps=steps,
               head='categorical' if disc else
               'bounded_normal', max_abs_err=max(e for e, _ in errs),
               tol=TOL, sample_agreement=share, action_agreement=act_share,
               min_agreement=SAMPLE_AGREEMENT, logit_err_vs_f32=f32_replay,
               bit_equal_calls=bit_equal,
               **(timings(torch, kernel, plain, flush, *work,
                          streamed=steps * tensor_bytes(params)) if timed
                  else {}))
  return check_row('imagine_seq', row, problems, timed)


# The default configuration's dims (configs.yaml `defaults`, no preset):
# deter 8192 in 8 blocks, hidden 1024, stoch 32 x 64, the dummy_disc
# encoder's 4 x 4 x 512 + 1024 tokens, a 3-layer policy of 1024 units.
DEFAULT = dict(D=8192, H=1024, S=32, C=64, K=9216, U=1024)


DEFAULT_KERNELS = ('obs_step', 'observe_seq', 'observe_seq_bwd',
                   'imagine_seq', 'qobs_window')


def default_kernels(torch, gen, flush, D=DEFAULT['D'], H=DEFAULT['H'],
                    S=DEFAULT['S'], C=DEFAULT['C'], K=DEFAULT['K'],
                    U=DEFAULT['U']):
  """Kernels 3, 5, 6, 8 and 9 at the default configuration's dims, each
  against its plain version as at size12m."""
  from embodied_tpu_torch.ops import observe
  L = S * C
  core, head = size12m_params(torch, gen, D=D, H=H, S=L, K=K, L=L)
  deter, stoch, act, tokens = step_inputs(torch, gen, ENVS, D, H, S, C, K)
  args = (deter, stoch, act, tokens, core + head)
  kernel = lambda: observe.obs_step(*args)
  plain = lambda: observe.reference_obs_step(*args)
  got, want = kernel(), plain()
  torch.cuda.synchronize()
  errs = [compare(torch, a, b) for a, b in zip(got, want)]
  problems = [] if all(ok for _, ok in errs) else [f'off the plain: {errs}']
  row = dict(config='default', batch=ENVS, max_abs_err=max(e for e, _ in errs),
             tol=TOL, **timings(torch, kernel, plain, flush, *observe.work(
                 ENVS, D, H, L, H, 8, K, L)))
  rows = [check_row('obs_step', row, problems)]
  rows += window_kernels(torch, gen, core + head, flush, D=D, H=H, S=S, K=K,
                         C=C, config='default')
  rows.append(rollout_kernel(torch, gen, core, True, flush, D=D, H=H, S=S,
                             U=U, C=C, config='default'))
  rows.append(qobs_kernel(torch, gen, core + head, flush, D=D, H=H, S=S, K=K,
                          C=C))
  return rows


# The rollout's products at the default dims that the 128-row stage
# carries, one per shape class (ops/imagine_seq.products), and the split
# count the rollout gives each (0: the stage's own rule; the logits are
# written whole).
STAGE_CLASSES = dict(gates=0, hidden=0, policy0=0, in_proj_deter=0,
                     prior_logits=1, policy1=0)


def stage_rows(torch, B=IMAG_STARTS, D=DEFAULT['D'], H=DEFAULT['H'],
               S=DEFAULT['S'], C=DEFAULT['C'], U=DEFAULT['U'], g=8):
  """The 128-row tensor-core stage alone (ops/blockgru.stage_product128)
  on each shape class of the default rollout's products, from its own
  seed: device ms (graph_ms) and TFLOP/s, held against one PyTorch call
  on the same operands as its yardstick (`library_ms`: torch.matmul for a
  dense product, torch.bmm for a block-diagonal one, with the hidden
  layer's two segments concatenated per group), which the port never
  calls."""
  from embodied_tpu_torch.ops import blockgru, imagine_seq
  gen = torch.Generator(DEV).manual_seed(SEED + 3)
  products = imagine_seq.products(B, D, H, S * C, H, U, 5, 3, g, True)
  # Rows of unit scale, weights of std 1 / sqrt(depth), in bf16.
  bf = lambda *shape, fan=1: (torch.randn(
      shape, generator=gen, device=DEV) / fan ** 0.5).to(torch.bfloat16)
  rows = []
  for name, splits in STAGE_CLASSES.items():
    rows_, K, N, groups = products[name]
    gN = N // groups
    # The hidden layer: the deter's block (D / g deep) and x (the rest).
    K1 = D // g if name == 'hidden' else K
    K2 = K - K1
    x, w = bf(B, groups * K1), bf(groups, K1, gN, fan=K)
    x2, w2 = (bf(B, K2), bf(K2, N, fan=K)) if K2 else (None, None)
    stage = lambda: blockgru.stage_product128(x, w, x2, w2, splits=splits)
    if groups == 1:
      xl = x if x2 is None else torch.cat([x, x2], 1)
      wl = w[0] if w2 is None else torch.cat([w[0], w2])
      library = lambda: torch.matmul(xl, wl)
    else:
      xl = x.reshape(B, groups, K1).transpose(0, 1)
      wl = w
      if K2:
        xl = torch.cat([xl, x2.expand(groups, B, K2)], 2)
        wl = torch.cat([w, w2.reshape(K2, groups, gN).transpose(0, 1)], 1)
      xl, wl = xl.contiguous(), wl.contiguous()
      library = lambda: torch.bmm(xl, wl).transpose(0, 1).reshape(B, N)
    got = stage()
    want = library()
    torch.cuda.synchronize()
    err, ok = compare(torch, got.sum(0), want)
    flops = 2 * rows_ * K * N
    ms = graph_ms(torch, stage)
    library_ms = graph_ms(torch, lambda: torch.bmm(xl, wl) if groups > 1
                          else library())
    row = dict(phase='stage', name=name, rows=rows_, K=K, N=N, groups=groups,
               splits=got.shape[0], max_abs_err=err, tol=TOL, ms=ms,
               tflops=flops / ms / 1e9, library_ms=library_ms,
               library_tflops=flops / library_ms / 1e9, ok=ok)
    emit(**row)
    rows.append(row)
    if not ok:
      fail('kernels', f'the 128-row stage on {name} disagrees with '
                      f'torch.matmul: max abs err {err}')
  return rows


# The default window's products that the 16-row stage carries, one per
# shape class: (groups, depth, columns per group, the depth of a dense
# second segment). The hidden layer's x is [xd, x0, act], 2 H + A deep,
# with the action width A = H that the qcore phase feeds it; wo's two
# parts (new, tokens) share one scale and run as one segment here.
STAGE16_CLASSES = dict(w0=(1, 8192, 1024, 0), hidden=(8, 1024, 1024, 3072),
                       wg=(8, 1024, 3072, 0), wo=(1, 17408, 1024, 0),
                       wl=(1, 1024, 2048, 0))
# Bytes of weight copies one timed pass walks through: more than twice the
# 50 MB L2, so each product reads its weights from device memory, as in
# the window, whose seven matrices (89 MB in int8) stream at every step.
STREAM_BYTES = 200e6


def stage16_rows(torch, B=ENVS):
  """The 16-row tensor-core stage alone (ops/blockgru.stage_product) on
  each shape class of the default window's products, from its own seed:
  int8 weights with column scales, and the same values in bf16, each held
  against its plain version. `ms` is device time per product (graph_ms
  over copies of the weights that exceed the L2), `weight_share` the
  weight bytes over that time as a share of the 3.35 TB/s memory rate.
  Dense bf16 classes add one torch.matmul on the same operands
  (`library_ms`), which the port never calls."""
  from embodied_tpu_torch.ops import blockgru
  gen = torch.Generator(DEV).manual_seed(SEED + 4)
  rows = []
  for name, (g, K, gN, K2) in STAGE16_CLASSES.items():
    N = g * gN
    rows_ = lambda k: torch.randn((B, k), generator=gen,
                                  device=DEV).to(torch.bfloat16)
    ints = lambda *shape: torch.randint(-127, 128, shape, generator=gen,
                                        device=DEV, dtype=torch.int8)
    scales = lambda: (0.5 + torch.rand((N,), generator=gen, device=DEV)) / (
        127 * (K + K2) ** 0.5)
    x, q, scale = rows_(g * K), ints(g, K, gN), scales()
    x2, q2, scale2 = (rows_(K2), ints(K2, N), scales()) if K2 else (
        None, None, None)
    ms = {}
    for kind in ('int8', 'bf16'):
      int8 = kind == 'int8'
      w, w2 = (q, q2) if int8 else (q.to(torch.bfloat16), None if q2 is None
                                    else q2.to(torch.bfloat16))
      sc, sc2 = (scale, scale2) if int8 else (None, None)
      got = blockgru.stage_product(x, w, False, 0, sc, x2, w2, sc2)
      want = blockgru.reference_stage_product(x, w, False, sc, x2, w2, sc2)
      torch.cuda.synchronize()
      err, ok = compare(torch, got.sum(0), want)
      nbytes = tensor_bytes([t for t in (w, w2) if t is not None])
      copies = [(w.clone(), None if w2 is None else w2.clone())
                for _ in range(math.ceil(STREAM_BYTES / nbytes))]
      walk = lambda: [blockgru.stage_product(x, a, False, 0, sc, x2, b, sc2)
                      for a, b in copies]
      ms[kind] = graph_ms(torch, walk, calls=1) / len(copies)
      library_ms = None
      if not int8 and g == 1 and not K2:
        walk = lambda: [torch.matmul(x, a[0]) for a, _ in copies]
        library_ms = graph_ms(torch, walk, calls=1) / len(copies)
      row = dict(phase='stage16', name=name, weights=kind, rows=B, K=K + K2,
                 N=N, groups=g, splits=got.shape[0], copies=len(copies),
                 max_abs_err=err, tol=TOL, ms=ms[kind], weight_bytes=nbytes,
                 weight_gb_per_s=nbytes / ms[kind] / 1e6,
                 weight_share=nbytes / ms[kind] * 1e3 / PEAK_BYTES,
                 library_ms=library_ms, ok=ok)
      if not int8:
        row['int8_speedup'] = ms['bf16'] / ms['int8']
      emit(**row)
      rows.append(row)
      if not ok:
        fail('kernels', f'the 16-row stage on {name} ({kind}) disagrees '
                        f'with its plain version: max abs err {err}')
  return rows


def qobs_kernel(torch, gen, params, flush, T=WINDOW, B=ENVS, D=2048, H=256,
                S=32, K=2304, C=CLASSES):
  """Kernel 9, the int8 window, on the quantized `params`: against its
  plain version replaying the kernel's samples, the samples against the
  plain draw from the same noise."""
  from embodied_tpu_torch.nn import dists
  from embodied_tpu_torch.ops import qcore
  L = S * C
  qparams, scales = qcore.quantize_params(params)
  deter0, stoch0, _, _ = step_inputs(torch, gen, B, D, H, S, C, K)
  bf = lambda x: x.to(torch.bfloat16).contiguous()
  acts = bf(torch.nn.functional.silu(
      torch.randn((T, B, H), generator=gen, device=DEV)))
  toks = bf(torch.randn((T, B, K), generator=gen, device=DEV))
  keep = torch.ones((T, B), device=DEV)
  keep[T // 2, ::4] = 0
  gum = dists.gumbel((T, B, L), gen, DEV)
  ins = (deter0, stoch0, acts, toks, keep)
  with torch.no_grad():
    dseq, sseq, lseq = qcore.qobs_window(*ins, gum, qparams, scales, C,
                                         UNIMIX)
    torch.cuda.synchronize()
    rd, _, rl = qcore.reference_qobs_window(*ins, qparams, scales, C, UNIMIX,
                                            hard=sseq)
  errs = [compare(torch, a, b) for a, b in ((dseq, rd), (lseq, rl))]
  share = agreement(sseq, rl, gum, C)
  problems = []
  if not all(ok for _, ok in errs):
    problems.append(f'outputs off the replay: {errs}')
  if share < SAMPLE_AGREEMENT:
    problems.append(f'samples agree for {share:.4f} of the groups')
  kernel = lambda: qcore.qobs_window(*ins, gum, qparams, scales, C, UNIMIX)
  # A second call on the same inputs gives the same bits (split partials
  # in split order, no atomics).
  with torch.no_grad():
    bit_equal = all(torch.equal(a, b) for a, b in zip(
        (dseq, sseq, lseq), kernel()))
  if not bit_equal:
    problems.append('two calls on the same inputs differ')
  plain = lambda: qcore.reference_qobs_window(*ins, qparams, scales, C,
                                              UNIMIX, gumbel=gum)
  streamed = T * qcore.weight_bytes(D, H, L, H, K, 8)
  with torch.no_grad():
    row = dict(config='default', batch=B, steps=T,
               max_abs_err=max(e for e, _ in errs), tol=TOL,
               sample_agreement=share, min_agreement=SAMPLE_AGREEMENT,
               bit_equal_calls=bit_equal,
               **timings(torch, kernel, plain, flush,
                         *qcore.work(T, B, D, H, L, H, K, 8),
                         streamed=streamed))
  return check_row('qobs_window', row, problems)


def phase_qcore(torch, T=WINDOW, B=ENVS, D=DEFAULT['D'], H=DEFAULT['H'],
                S=DEFAULT['S'], C=DEFAULT['C'], K=DEFAULT['K'], g=8):
  """The int8 window's validation (runs/validate_qcore_tpu.py on the TPU)
  at the default dims: weights and inputs from the seed as that script
  makes them, the int8 window (kernel 9) against the dequantized
  reference, its deter against the bf16 window's replay of its samples
  (the quantization error), and the two kernels timed in turns with CUDA
  events on the same inputs. The launch counts are set to 0 before and
  read after."""
  from embodied_tpu_torch.nn import dists
  from embodied_tpu_torch.ops import observe_seq, qcore
  gen = torch.Generator(DEV).manual_seed(SEED + 2)
  dg, L = D // g, S * C
  randn = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
  bf = lambda x: x.to(torch.bfloat16).contiguous()
  init = lambda *shape: bf(0.05 * randn(*shape))
  zeros = lambda n: torch.zeros(n, dtype=torch.bfloat16, device=DEV)
  ones = lambda n: torch.ones(n, device=DEV)
  params = (init(D, H), zeros(H), ones(H), init(L, H), zeros(H), ones(H),
            init(g, dg, dg), zeros(D), init(3 * H, D), ones(D),
            init(g, dg, 3 * dg), zeros(3 * D),
            init(D + K, H), zeros(H), ones(H), init(H, L), zeros(L))
  deter0 = bf(0.5 * randn(B, D))
  index = torch.randint(0, C, (B, S), generator=gen, device=DEV)
  stoch0 = bf(torch.nn.functional.one_hot(index, C).reshape(B, L))
  ins = (deter0, stoch0, bf(0.5 * randn(T, B, H)), bf(0.5 * randn(T, B, K)),
         torch.ones((T, B), device=DEV))
  gum = dists.gumbel((T, B, L), gen, DEV)
  wrappers = (qcore.qobs_window, observe_seq.observe_seq)
  for wrapper in wrappers:
    wrapper.launches = 0
  qparams, scales = qcore.quantize_params(params)
  mb = lambda xs: tensor_bytes(xs) / 1e6
  with torch.no_grad():
    qfn = lambda: qcore.qobs_window(*ins, gum, qparams, scales, C, UNIMIX,
                                    nch=8)
    bfn = lambda: observe_seq.observe_seq(*ins, gum, params, C, UNIMIX)
    dseq, sseq, _ = qfn()
    bseq, bsto, _ = bfn()
    torch.cuda.synchronize()
    deq = qcore.dequantize_params(qparams, scales)
    rd = observe_seq.reference_observe_seq(*ins, deq, C, UNIMIX, hard=sseq)[0]
    qd = observe_seq.reference_observe_seq(*ins, params, C, UNIMIX,
                                           hard=sseq)[0]
    diff = lambda a, b: float((a.float() - b.float()).abs().max())
    same = float((sseq.reshape(T, B, S, C).argmax(-1) ==
                  bsto.reshape(T, B, S, C).argmax(-1)).float().mean())
    # In turns, int8 then bf16 then bf16 then int8, 10 timed calls each.
    turns = [(name, cuda_ms(torch, fn, warmup=2, iters=10))
             for name, fn in (('int8', qfn), ('bf16', bfn), ('bf16', bfn),
                              ('int8', qfn))]
    kernels = kernels_by_name(torch, qfn)
  q_ms = statistics.mean(t for n, t in turns if n == 'int8')
  b_ms = statistics.mean(t for n, t in turns if n == 'bf16')
  w = observe_seq.weights(D, H, L, H, K, g)
  row = dict(
      phase='qcore', dims=dict(T=T, B=B, D=D, H=H, L=L, K=K, g=g),
      weight_mb_bf16=mb(params), weight_mb_int8=mb(qparams),
      scale_mb=mb(scales.values()),
      matrices_mb=dict(bf16=2 * w / 1e6, int8=w / 1e6),
      deter_maxdiff_vs_dequantized=diff(dseq, rd),
      deter_maxdiff_vs_bf16_window=diff(dseq, qd),
      deter_maxdiff_vs_bf16_kernel=diff(dseq, bseq),
      sample_agreement_with_bf16_kernel=same,
      int8_window_ms=q_ms, bf16_window_ms=b_ms, speedup=b_ms / q_ms,
      turns_ms=turns,
      streamed_floor_ms=dict(
          bf16=T * 2 * w / PEAK_BYTES * 1e3,
          int8=T * qcore.weight_bytes(D, H, L, H, K, g) / PEAK_BYTES * 1e3),
      launches={fn.__name__: fn.launches for fn in wrappers},
      kernels_ms=kernels)
  # As the TPU script: the int8 window sits near the window on the
  # dequantized weights (bf16 rounds elsewhere).
  problems = []
  if not row['deter_maxdiff_vs_dequantized'] < 0.15:
    problems.append('the int8 window is off the dequantized reference')
  # Every product of the int8 window runs on the 16-row tensor-core stage:
  # no FMA stage (mm_kernel) runs in it.
  if any('mm_kernel' in k for k in kernels) or not any(
      'tc16_kernel' in k for k in kernels):
    problems.append(f'the int8 window ran {sorted(kernels)}')
  if not all(math.isfinite(v) for v in (q_ms, b_ms)):
    problems.append('no timing')
  row['ok'] = not problems
  emit(**row)
  if problems:
    fail('qcore', '; '.join(problems))
  return row['launches']['qobs_window']


def kernels_by_name(torch, fn, attempts=3):
  """Device ms of one call of `fn` per kernel name (template arguments
  kept, parameter lists dropped), from torch.profiler; taken again where
  a profile returns no device events, as device_ms does."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  by_name = {}
  for _ in range(attempts):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    for e in prof.events():
      if e.device_type == torch.autograd.DeviceType.CUDA:
        name = e.name.split('(')[0].removeprefix('void ')
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    if by_name:
      break
  return by_name


# The optimizer's update (ops/optim.py) at DreamerV3's published sizes:
# each case's label, slot layout, settings over the model's own, and the
# steps whose gradient gets an inf planted. Every case takes OPTIM_LR at
# once (the model's 4e-5 after a warmup of 1,000 steps): a change of 4e-5
# on parameters of 0.05 is some 1e4 ulps, so the change read back as the
# difference of two float32 parameters would carry 1e-4 of rounding.
OPTIM_PRESETS = ('size200m', 'size400m')
OPTIM_CASES = (
    ('fused', True, {}, ()),
    ('fused wd nesterov', True, dict(wd=0.1, nesterov=True), ()),
    ('fused no momentum', True, dict(momentum=False), ()),
    ('fused scaling', True, dict(scaling=True), (1,)),
    ('perparam scaling wd', False, dict(scaling=True, wd=0.1), (1,)),
)
OPTIM_STEPS = 3
OPTIM_LR = 1e-2
# Per leaf, relative error by norm of the parameters, their change, the
# RMS and the momentum against the plain version: the elementwise arithmetic
# rounds as the plain version's does, AGC's norms sum in another order.
OPTIM_RTOL = 1e-5
# The metrics: sums over every parameter, in another order.
OPTIM_METRIC_RTOL = 1e-4


def optimizer_leaves(torch, preset):
  """The paths and shapes of DreamerV3's optimizer leaves at `preset` on
  PinPad (as the learner cells), from a model built on the meta device,
  and the optimizer's settings."""
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main
  from embodied_tpu_torch.models.dreamerv3.model import Model
  config = common.assemble_config(
      main.CONFIGS, ['--configs', preset, '--task', 'pinpad_four'])
  acfg = common.agent_config(config)
  with torch.device('meta'):
    model = Model(*common.env_spaces(config), acfg)
  shapes = {k: tuple(p.shape) for k, p in model.opt.params.items()}
  return shapes, dict(acfg.agent.opt)


def optim_case(torch, shapes, settings, fused, planted, seed):
  """OPTIM_STEPS updates through the wrapper (the kernels) and through
  the plain version from the same state and gradients. Each kernel step
  runs twice from the same state under the sync guard and must give the
  same bits. Returns ({worst error by kind}, problems, the kernel's
  optimizer, its leaves, one step's gradient, the plain optimizer)."""
  import numpy as np
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.ops import optim
  from embodied_tpu_torch.parallel.guard import SYNCS
  rng = np.random.default_rng(seed)
  gen = torch.Generator(DEV).manual_seed(seed)
  init = {k: 0.05 * torch.randn(s, generator=gen, device=DEV)
          for k, s in shapes.items()}
  # Gradients 1e-3 to 3 times the leaf's parameters' scale: AGC clips some
  # leaves and not others.
  scales = {k: 0.05 * 10 ** rng.uniform(-3, 0.5) for k in shapes}

  def make():
    params = {k: torch.nn.Parameter(v.clone()) for k, v in init.items()}
    with torch.device(DEV):
      return nn.Optimizer(params, 'opt', fused=fused, **settings)

  kern, plain = make(), make()
  paths = list(kern.params)
  kleaves = [kern.params[k] for k in paths]
  pleaves = [plain.params[k] for k in paths]
  state = lambda opt: [*[opt.params[k] for k in paths], *opt.buffers()]
  loss = torch.ones((), device=DEV)
  worst = dict(param=0.0, change=0.0, rms=0.0, mom=0.0, metric=0.0)
  problems = []
  for step in range(OPTIM_STEPS):
    step_gen = torch.Generator(DEV).manual_seed(seed + 1 + step)
    vec = torch.cat([
        scales[k] * torch.randn(kern.params[k].numel(), generator=step_gen,
                                device=DEV) for k in paths])
    if settings.get('scaling'):
      vec *= kern.grad_scale
    if step in planted:
      vec[vec.numel() // 2] = float('inf')
    held = [t.detach().clone() for t in state(kern)]
    with SYNCS.guarded():
      got = kern._update(paths, kleaves, vec.clone(), loss)
    first = [t.detach().clone() for t in state(kern)]
    with torch.no_grad():
      for t, h in zip(state(kern), held):
        t.copy_(h)
    with SYNCS.guarded():
      again = kern._update(paths, kleaves, vec.clone(), loss)
    if not all(torch.equal(a, b) for a, b in zip(first, state(kern))) or (
        not all(torch.equal(got[k], again[k]) for k in got)):
      problems.append(f'step {step}: two calls gave other bits')
    del first
    pheld = [p.detach().clone() for p in pleaves]
    want = optim.reference_update(plain, paths, pleaves, vec.clone(), loss)
    pslots, kslots = optim.slots(plain, paths, pleaves), optim.slots(
        kern, paths, kleaves)
    for i, path in enumerate(paths):
      n = kleaves[i].numel()
      # Each side's change from its own state before the step.
      dk = kleaves[i].detach() - held[i]
      dp = pleaves[i].detach() - pheld[i]
      worst['param'] = max(worst['param'], relerr(kleaves[i], pleaves[i]))
      if step in planted:
        if dk.abs().max() or dp.abs().max():
          problems.append(f'step {step}: {path} moved on an overflow')
      else:
        worst['change'] = max(worst['change'], relerr(dk, dp))
      for j, kind in enumerate(('rms', 'mom')):
        if pslots[i][j] is None:
          continue
        at = pslots[i][2]
        leaf = lambda slot: slot.view(-1)[at:at + n]
        worst[kind] = max(worst[kind], relerr(
            leaf(kslots[i][j]), leaf(pslots[i][j])))
    if sorted(got) != sorted(want):
      problems.append(f'metrics {sorted(got)} against {sorted(want)}')
    for key in want:
      a, b = float(got[key]), float(want[key])
      worst['metric'] = max(worst['metric'], abs(a - b) / max(abs(b), 1e-30))
    exact = ['step'] + (['grad_scale', 'good_steps'] if settings.get(
        'scaling') else [])
    for name in exact:
      if not torch.equal(getattr(kern, name), getattr(plain, name)):
        problems.append(f'step {step}: {name} {getattr(kern, name)} against '
                        f'{getattr(plain, name)}')
  for kind in ('param', 'change', 'rms', 'mom'):
    if not worst[kind] <= OPTIM_RTOL:
      problems.append(f'{kind} relative error {worst[kind]:.3g}')
  if not worst['metric'] <= OPTIM_METRIC_RTOL:
    problems.append(f'metric relative error {worst["metric"]:.3g}')
  return worst, problems, kern, kleaves, vec, plain


def phase_optim(torch):
  """The optimizer's kernel pair (ops/optim.py) against its plain version
  on the leaves of DreamerV3's 200M and 400M optimizers (OPTIM_CASES),
  its launches (one a call), and its time beside the plain version's and
  the bound of 36 bytes a parameter. Returns the first preset's row for
  the kernel list, with the worst relative error of every case."""
  from embodied_tpu_torch.ops import optim
  problems, rows = [], []
  for p, preset in enumerate(OPTIM_PRESETS):
    shapes, settings = optimizer_leaves(torch, preset)
    count = sum(math.prod(s) for s in shapes.values())
    row = dict(phase='optim', preset=preset, leaves=len(shapes),
               params=count, cases={})
    for c, (label, fused, extra, planted) in enumerate(OPTIM_CASES):
      before = optim.update.launches
      worst, bad, kern, leaves, vec, plain = optim_case(
          torch, shapes, {**settings, 'warmup': 0, 'lr': OPTIM_LR, **extra},
          fused, planted,
          SEED + 100 * p + 10 * c)
      launches = optim.update.launches - before
      if launches != 2 * OPTIM_STEPS:
        bad.append(f'{launches} launches in {2 * OPTIM_STEPS} calls')
      row['cases'][label] = dict(worst, launches=launches)
      problems += [f'{preset} {label}: {x}' for x in bad]
      if c == 0:
        paths = list(kern.params)
        loss = torch.ones((), device=DEV)
        call = lambda: kern._update(paths, leaves, vec, loss)
        plain_leaves = [plain.params[k] for k in paths]
        plain_call = lambda: optim.reference_update(
            plain, paths, plain_leaves, vec.clone(), loss)
        row.update(
            kernel_ms=device_ms(torch, call, iters=10),
            call_ms=cuda_ms(torch, call, warmup=3, iters=10),
            by_kernel=kernels_by_name(torch, call),
            plain_ms=device_ms(torch, plain_call, iters=2),
            plain_call_ms=cuda_ms(torch, plain_call, warmup=1, iters=3))
        row['bound_ms'], row['bound_by'] = bound(*optim.work(count))
      del kern, leaves, vec, plain
      gc.collect()
      torch.cuda.empty_cache()
    emit(**row)
    rows.append(row)
  if problems:
    fail('optim', '; '.join(problems))
  return dict(rows[0], max_rel_err=max(
      case[kind] for row in rows for case in row['cases'].values()
      for kind in ('param', 'change', 'rms', 'mom')))


def drive(argv, calls, modes):
  """Build the agent for `argv` (on the card unless `--torch.device cpu`)
  and drive it over ENVS envs of its task for `calls` policy calls per
  mode.
  Returns the agent, timings and the last carry and observations."""
  from embodied_tpu_torch import core
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main
  config = common.assemble_config(main.CONFIGS, argv + HOST_PATH + NO_COUNT)
  agent = main.make_agent(config)
  driver = core.Driver(
      [lambda i=i: common.make_env(config, i) for i in range(ENVS)],
      parallel=False)
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


def check_against_plain(torch, agent, last, dyn_carry=1, prevact=3):
  """One observe step on the card through the kernel path and through the
  plain path (kernel: off), with the same carry, inputs and Gumbel noise,
  at the batch of `last` (its observations, and the policy carry they
  were acted on with).
  `dyn_carry` and `prevact` index the RSSM's carry and the previous
  action in the policy's carry (DreamerV3's by default)."""
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.nn import dists
  model = agent.model
  carry, obs = last['carry'], {
      k: agent._to_device(v) for k, v in last['obs'].items()}
  carry = nn.core.tree_map(
      agent._to_device, {1: carry[dyn_carry], 3: carry[prevact]})
  dyn = model.dyn
  gen = torch.Generator(agent.device).manual_seed(SEED + 1)
  noise = dists.gumbel((len(obs['is_first']), dyn.stoch, dyn.classes), gen,
                       agent.device)
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
     100, ('train', 'eval'), 'obs_step'),
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
    if torch.cuda.is_available():
      torch.cuda.reset_peak_memory_stats()
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


def collect_batch(agent, config, policy=None, init_policy=None):
  """One (batch_size, batch_length + replay_context) train batch collected
  by the acting path: a Driver over batch_size dummy envs with the agent's
  policy (or `policy`, from `init_policy`'s carry), each env's steps in
  order as the replay stores them (observation, action, the policy's
  latents or slots), plus a `consec` of 0 (every window starts fresh and
  grafts its stored latents) and unique stepids. Returns the batch and the
  rows it was cut from."""
  from embodied_tpu_torch import core
  from embodied_tpu_torch.models import common
  B = config.batch_size
  T = config.batch_length + config.replay_context
  driver = core.Driver(
      [lambda i=i: common.make_env(config, i) for i in range(B)],
      parallel=False)
  rows = [[] for _ in range(B)]
  driver.on_step(lambda row, i, **kw: rows[i].append(row))
  driver.reset(init_policy or agent.init_policy)
  driver(policy or agent.policy, steps=B * T)
  driver.close()
  return batch_from_rows(agent, rows, T), rows


def batch_from_rows(agent, rows, T):
  """The train batch of `agent`'s replay keys from per-env rows."""
  import numpy as np
  B = len(rows)
  data = agent._example_batch(B, T)
  filled = set()
  for key in data:
    if key in rows[0][0]:
      data[key] = np.stack([np.stack([r[key] for r in env[:T]])
                            for env in rows]).astype(data[key].dtype)
      filled.add(key)
  data['consec'][:] = 0
  ids = np.arange(B * T, dtype=np.int64).reshape(B, T)
  data['stepid'][..., :8] = ids[..., None].view(np.uint8).reshape(B, T, 8)
  missing = sorted(set(data) - filled - {'consec', 'stepid'})
  if missing:
    fail('train', f'the acting path did not give {missing}')
  return data


TRAIN_PATHS = (
    # (label, argv, warm-up steps, timed steps, check against kernel: off)
    ('train size12m', ['--configs', 'size12m', '--task', 'dummy_disc'],
     3, 10, True),
    ('train size12m, dummy_cont',
     ['--configs', 'size12m', '--task', 'dummy_cont'], 1, 2, False),
)
TRAIN_KERNELS = ('observe_seq', 'observe_seq_bwd', 'imagine_seq')
# The optimizer's update pair (ops/optim.py), counted in the train phases:
# it runs on every train step on the card, kernel: off included.
UPDATE = 'update'
TRAINED = ('enc', 'dyn', 'dec', 'rew', 'con', 'pol', 'val')
# Every trained parameter must have moved by the end of this step (0-based):
# the first step's learning rate is 0 (warm-up), and the reward and value
# trunks get gradients only once their zero-initialised outputs have moved.
CHANGED_AFTER = 2


def train_wrappers():
  from embodied_tpu_torch.ops import (
      blockgru, imagine, imagine_seq, observe, observe_seq)
  return dict(core_step=blockgru.core_step,
              core_step_bwd=blockgru.core_step_bwd,
              obs_step=observe.obs_step, obs_step_bwd=observe.obs_step_bwd,
              observe_seq=observe_seq.observe_seq,
              observe_seq_bwd=observe_seq.observe_seq_bwd,
              imagine_seq=imagine_seq.imagine_seq,
              imag_step=imagine.imag_step)


def is_loss(key):
  """DreamerV3's per-term losses."""
  return key.startswith('loss/')


def check_losses(kernel, plain, is_loss=is_loss):
  """Per-key losses through the kernels against the plain path."""
  keys = sorted(k for k in kernel if is_loss(k))
  off = {k: abs(kernel[k] - plain[k]) for k in keys}
  bad = [k for k in keys if not off[k] <= LOSS_RTOL * (1 + abs(plain[k]))]
  return {k: (kernel[k], plain[k]) for k in keys}, bad


def profile_train(torch, agent, carry, data, step_ms, steps=2):
  """Device time of train steps from torch.profiler (`data` a batch, or a
  function that returns the next one): busy time (the union
  of kernel intervals), the port's kernels (namespaces seq:: and
  blockgru::) and the largest other kernels. The idle share is taken
  against `step_ms`, the step time without the profiler, whose own host
  work lengthens the profiled steps."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  start = time.perf_counter()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(steps):
      carry, _, _ = agent.train(carry, data() if callable(data) else data)
    torch.cuda.synchronize()
  wall = (time.perf_counter() - start) * 1e3 / steps
  spans = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
  busy, end = 0.0, float('-inf')
  for lo, hi, _ in spans:
    if hi > end:
      busy += hi - max(lo, end)
      end = hi
  by_name = {}
  for lo, hi, name in spans:
    by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e3 / steps
  port = sum(v for k, v in by_name.items() if 'seq::' in k or
             'blockgru::' in k)
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
  return carry, dict(
      profiled_ms_per_step=wall, busy_ms_per_step=busy / 1e3 / steps,
      kernels_per_step=len(spans) / steps, port_kernels_ms=port,
      idle_share=1 - busy / 1e3 / steps / step_ms,
      top_kernels_ms=[(k[:120], v) for k, v in top])


def train_steps(torch, agent, data, wrappers, warmup, steps, per_step,
                plain=None, losses=is_loss, trained=(), at_floor=None,
                changed_after=CHANGED_AFTER, replay=True):
  """`warmup` + `steps` Agent.train calls on one batch, each call's
  launches counted: each must launch `per_step` ({wrapper: count}; the
  others are not checked) and give finite metrics, and with `replay` give
  outs['replay'] entries of the batch's shape. With `plain(agent, data)`
  (the metrics of one train step on the plain path, which must launch
  nothing but the optimizer's update, once where `wrappers` holds it
  under UPDATE), the first step's `losses` against it from the same
  parameters and draws. Every parameter under the `trained` scopes must have changed
  by the end of step `changed_after`; where `at_floor(row)` says that
  every KL sat at the free-nats floor, the prior gets no gradient (as in
  the JAX model), which is noted, not a fault. Returns the last carry, the
  row (times, frames/s, peak memory, each call's launches, the last
  metrics) and the problems found."""
  B = data['is_first'].shape[0]
  T = data['is_first'].shape[1] - agent.replay_context
  carry = agent.init_train(B)
  before = agent.save()
  problems, times, row, calls = [], [], {}, []
  for i in range(warmup + steps):
    if i == warmup:
      torch.cuda.reset_peak_memory_stats()
    counts = {k: w.launches for k, w in wrappers.items()}
    start = time.perf_counter()
    carry, outs, mets = agent.train(carry, data)
    times.append((time.perf_counter() - start) * 1e3)
    step = {k: w.launches - counts[k] for k, w in wrappers.items()}
    calls.append(step)
    if any(step[k] != n for k, n in per_step.items()):
      problems.append(f'step {i} launched {step}, not {per_step}')
    bad = sorted(k for k, v in mets.items() if not math.isfinite(v))
    if bad:
      problems.append(f'step {i}: non-finite {bad[:5]}')
    if replay:
      shapes = {k: v.shape[:2] for k, v in outs['replay'].items()}
      if any(s != (B, T) for s in shapes.values()):
        problems.append(f'replay entries of shapes {shapes}')
    if i == 0:
      row['first_losses'] = {k: v for k, v in mets.items() if losses(k)}
      if plain is not None:
        after = agent.save()
        counts = {k: w.launches for k, w in wrappers.items()}
        agent.load(before)
        other = plain(agent, data)
        agent.load(after)
        if any(w.launches != counts[k] + (k == UPDATE)
               for k, w in wrappers.items()):
          problems.append('the plain path launched a kernel')
        row['losses_kernel_vs_plain'], bad = check_losses(
            mets, other, losses)
        if bad:
          problems.append(f'losses off the plain path: {bad}')
    if trained and i == changed_after:
      now = agent.save()['store']
      under = lambda k: any(k == t or k.startswith(t + '/') for t in trained)
      same = sorted(k for k, v in before['store'].items()
                    if under(k) and (v == now[k]).all())
      if at_floor and at_floor(row):
        row['prior_at_free_nats'] = [k for k in same
                                     if k.startswith('dyn/prior')]
        same = [k for k in same if not k.startswith('dyn/prior')]
      if same:
        problems.append(f'{len(same)} parameters unchanged: {same[:5]}')
  timed = times[warmup:]
  ms = statistics.median(timed)
  row.update(
      batch=[B, T], train_steps=len(times), first_step_ms=times[0],
      ms_per_train_step=ms, ms_per_train_step_max=max(timed),
      timed_steps=len(timed), train_frames_per_s=B * T / ms * 1e3,
      peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
      launches_per_call=calls, metrics={k: mets[k] for k in sorted(mets)})
  return carry, row, problems


def plain_train(agent, data):
  """One train step's metrics on the plain path (kernel: off)."""
  agent.model.dyn.kernel = 'off'
  _, _, mets = agent.train(agent.init_train(data['is_first'].shape[0]),
                           data)
  agent.model.dyn.kernel = 'auto'
  return mets


def phase_train(torch, paths=TRAIN_PATHS):
  """Drives each train path: a batch from the acting path, then train
  steps through Agent.train with the launch counts set to 0 just before
  and read just after (train_steps). Each step must launch each train
  kernel and the optimizer's update once, give finite metrics, and (after
  the warm-up, whose first step has a zero learning rate) have changed
  every trained parameter."""
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  from embodied_tpu_torch.ops import optim
  wrappers = dict(train_wrappers(), **{UPDATE: optim.update})
  launches = {}
  for label, argv, warmup, steps, against_plain in paths:
    argv = argv + HOST_PATH + NO_COUNT
    config = common.assemble_config(dmain.CONFIGS, argv)
    agent = dmain.make_agent(config)
    data, _ = collect_batch(agent, config)
    for wrapper in wrappers.values():
      wrapper.launches = 0
    floor = config.agent.dyn.rssm.free_nats
    carry, row, problems = train_steps(
        torch, agent, data, wrappers, warmup, steps,
        {k: 1 for k in TRAIN_KERNELS + (UPDATE,)},
        plain=plain_train if against_plain else None, trained=TRAINED,
        at_floor=lambda row: row['first_losses']['loss/dyn'] <= floor)
    counts = {k: w.launches for k, w in wrappers.items()}
    launches[label] = counts
    del row['launches_per_call']
    row.update(path=label, argv=argv, launches=counts, metrics={
        k: v for k, v in row['metrics'].items()
        if k.startswith(('loss/', 'opt/'))})
    if against_plain:
      carry, row['profile'] = profile_train(
          torch, agent, carry, data, row['ms_per_train_step'])
    row['ok'] = not problems
    emit(phase='train', **row)
    if problems:
      fail('train', '; '.join(problems))
    del agent
    torch.cuda.empty_cache()
  return launches


# The other kernel paths of the train step: (label, flags on size12m,
# launches per train step, launches per report of a 16 x 32 batch). Each
# report runs the loss window (T = 32) and the open loop: the posterior
# over 16 steps and imagination over 16 from the recorded actions, at
# B = 6. A kernel not named launches 0 times.
REPORT_LENGTH = 32
OPEN_LOOP = REPORT_LENGTH // 2
MODES = (
    ('kernel: fused', ['--agent.dyn.rssm.kernel', 'fused'],
     dict(obs_step=WINDOW, obs_step_bwd=WINDOW, core_step=IMAG_LENGTH),
     dict(obs_step=REPORT_LENGTH + OPEN_LOOP,
          core_step=IMAG_LENGTH + OPEN_LOOP)),
    ('kernel: imag', ['--agent.dyn.rssm.kernel', 'imag'],
     dict(observe_seq=1, observe_seq_bwd=1, imag_step=IMAG_LENGTH),
     dict(observe_seq=2, imag_step=IMAG_LENGTH + OPEN_LOOP)),
    ('obslayers: 2', ['--agent.dyn.rssm.obslayers', '2'],
     dict(core_step=WINDOW, core_step_bwd=WINDOW, imagine_seq=1),
     dict(core_step=REPORT_LENGTH + 2 * OPEN_LOOP, imagine_seq=1)),
)
MODE_STEPS = 3


def phase_modes(torch, modes=MODES):
  """Drives each mode: a batch from the acting path, then MODE_STEPS train
  steps and one report, with the launch counts set to 0 just before each
  and read just after; the first step's losses against the plain path
  (kernel: off) on the same store, batch and noise."""
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  wrappers = train_wrappers()
  counts = lambda: {k: w.launches for k, w in wrappers.items()}
  launches = {}
  for label, flags, per_step, per_report in modes:
    argv = ['--configs', 'size12m', '--task', 'dummy_disc'] + flags + (
        HOST_PATH + NO_COUNT)
    config = common.assemble_config(dmain.CONFIGS, argv)
    agent = dmain.make_agent(config)
    data, _ = collect_batch(agent, config)
    B = config.batch_size
    carry = agent.init_train(B)
    before = agent.save()
    torch.cuda.reset_peak_memory_stats()
    problems, times, steps = [], [], []
    for wrapper in wrappers.values():
      wrapper.launches = 0
    for i in range(MODE_STEPS):
      start_counts = counts()
      start = time.perf_counter()
      carry, _, mets = agent.train(carry, data)
      times.append((time.perf_counter() - start) * 1e3)
      steps.append({k: v - start_counts[k] for k, v in counts().items()})
      bad = sorted(k for k, v in mets.items() if not math.isfinite(v))
      if bad:
        problems.append(f'step {i}: non-finite {bad[:5]}')
      if i == 0:
        first = mets
    after_train = counts()
    want = {k: per_step.get(k, 0) for k in wrappers}
    for i, step in enumerate(steps):
      if step != want:
        problems.append(f'step {i} launched {step}, expected {want}')
    # One report on a report-length window of the same batch.
    report_data = {k: v[:, :REPORT_LENGTH + config.replay_context]
                   for k, v in data.items()}
    for wrapper in wrappers.values():
      wrapper.launches = 0
    start = time.perf_counter()
    _, report = agent.report(agent.init_report(B), report_data)
    report_ms = (time.perf_counter() - start) * 1e3
    report_counts = counts()
    want = {k: per_report.get(k, 0) for k in wrappers}
    if report_counts != want:
      problems.append(f'the report launched {report_counts}, expected {want}')
    video = report.get('openloop/image')
    if video is None or video.dtype.name != 'uint8':
      problems.append(f'no uint8 open-loop video: {sorted(report)[:10]}')
    bad = sorted(k for k, v in report.items()
                 if isinstance(v, float) and not math.isfinite(v))
    if bad:
      problems.append(f'report: non-finite {bad[:5]}')
    # The first step again on the plain path, from the same store.
    now = agent.save()
    agent.load(before)
    agent.model.dyn.kernel = 'off'
    plain_counts = counts()
    _, _, plain = agent.train(agent.init_train(B), data)
    if counts() != plain_counts:
      problems.append('the plain path launched a kernel')
    agent.load(now)
    losses, bad = check_losses(first, plain)
    if bad:
      problems.append(f'losses off the plain path: {bad}')
    launches[label] = dict(after_train)
    row = dict(
        phase='modes', mode=label, argv=argv, batch=[B, config.batch_length],
        launches_per_step=steps[-1], launches_train=after_train,
        launches_report=report_counts, train_steps=MODE_STEPS,
        ms_per_train_step=times, first_step_ms=times[0],
        report_ms=report_ms, report_video_shape=(
            list(video.shape) if video is not None else None),
        losses_kernel_vs_plain=losses, loss_rtol=LOSS_RTOL,
        peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
        ok=not problems)
    emit(**row)
    if problems:
      fail('modes', '; '.join(problems))
    del agent
    torch.cuda.empty_cache()
  return launches


# The train script's runs: (label, flags, the wall-clock budget in seconds
# of each run on one logdir, the log and report interval and the save
# interval in seconds). Each run goes through the default process driver
# with ENVS envs and ends on its budget (run.duration), not on a step
# count: the intervals are wall-clock and fire first one interval into
# the loop, and a faster host took 3,000 size12m steps in under 6 s and
# ended its train_eval run before the first evaluation. A budget makes
# each task fire whatever the host's speed; the env steps a run takes are
# counted (STEP_CAP is not reached) and are the measurement. On a slower
# host (PR 10's second run of this script) train steps began after some
# 8 s of the first run, so each first run's budget leaves a log after
# that.
SIZE12M = ['--configs', 'size12m', '--run.envs', str(ENVS)]
STEP_CAP = 10 ** 6
SCRIPTS = (
    # size12m, then again on the same logdir: the second run resumes.
    # Then train_eval the same way, with its 4 eval envs and eval replay;
    # an evaluation (an eval episode and two reports) takes some 2 s, so
    # it comes every 6 s. Each pair's budgets were (15, 10) until the
    # parallel phase came; the script runs' budgets sum to 210 s (these,
    # DEFAULT_SCRIPTS, PARALLEL_BUDGET and the PPO and Director runs).
    ('size12m', SIZE12M, (12, 8), 2, 2),
    ('size12m train_eval', SIZE12M + ['--script', 'train_eval'], (12, 8),
     6, 2),
)
# The default configuration (no preset), once each: train steps begin
# after some 2,100 env steps fill the replay. Its `train` script run (35 s
# and a 2.4 GB save) went for the parallel phase's budget: train_eval at
# this width, and size12m's `train`, still run that script's loop. A
# save writes its 2.4 GB of parameters and optimizer slots (5-9 s), and
# the next save's interval starts when one starts, so an interval near a
# save's time saves again at almost every poll (10 s took 114 s for 4,500 steps); at 20 s one
# save fires in a run's loop and rarely a second. Reports (some 2 s each)
# and evaluations come at the same interval. Each budget leaves room
# after the 20 s mark for an evaluation (PinPad's: 300 policy calls and
# two reports, some 4 s) and a save.
# PinPad (pinpad_three: 64 x 64 x 3 frames, 5 actions, the train step's
# shapes those of dummy_disc) renders on the host in the env processes.
# Its episodes last 10,000 steps by default; cut to 300 steps, each of the
# 16 train envs ends one by env step 4,816, which took 18 s on a slower
# host; its 50 s budget holds some 34 s of stepping beside two
# evaluations and two saves.
PINPAD = ['--task', 'pinpad_three', '--env.pinpad.length', '300']
DEFAULT_SCRIPTS = (
    ('default train_eval', ['--script', 'train_eval'], (35,), 20, 20),
    ('default pinpad train_eval', PINPAD + ['--script', 'train_eval'],
     (50,), 20, 20),
)
# eval_only from the size12m train_eval run's checkpoint: (label, flags),
# on EVAL_ONLY_ENVS envs; EVAL_ONLY_STEPS env steps over them end each
# env's first 100-step episode.
EVAL_ONLY_ENVS = 4
EVAL_ONLY = (
    ('size12m eval_only', SIZE12M + ['--run.envs', str(EVAL_ONLY_ENVS)]),
    ('size12m eval_only, random agent', SIZE12M + [
        '--run.envs', str(EVAL_ONLY_ENVS), '--random_agent', 'True']),
)
EVAL_ONLY_STEPS = 106 * EVAL_ONLY_ENVS


def count_drivers():
  """Patches loop.make_driver so that each driver a script makes records
  its transport and counts its env steps. Returns the lists of both, one
  entry per driver in the order made, and the function that undoes the
  patch. Neither list holds the driver: a driver holds its callbacks, and
  with them the agent, which must go when its run ends."""
  from embodied_tpu_torch.run import loop
  transports, ticks = [], []
  make_driver = loop.make_driver

  def made(*args):
    driver = make_driver(*args)
    transports.append(driver.parallel)
    ticks.append(0)
    index = len(ticks) - 1

    def tick(tran, worker):
      ticks[index] += 1
    driver.on_step(tick)
    return driver

  def restore():
    loop.make_driver = make_driver
  loop.make_driver = made
  return transports, ticks, restore


def read_log(logdir, losses=is_loss):
  """A script's metrics log: its lines, the scores and lengths of its
  train and eval episodes as (score, length) lists and as a row's
  summary, and the last logged value of each train loss."""
  lines = []
  if os.path.exists(os.path.join(logdir, 'metrics.jsonl')):
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
      lines = [json.loads(line) for line in f]
  episodes = {prefix: [(l[f'{prefix}/score'], l[f'{prefix}/length'])
                       for l in lines if f'{prefix}/score' in l]
              for prefix in ('episode', 'eval_episode')}
  summary = {k: dict(count=len(v), scores=[s for s, _ in v],
                     lengths=sorted({n for _, n in v}))
             for k, v in episodes.items()}
  last = {k: v for l in lines for k, v in l.items()
          if k.startswith('train/') and losses(k[len('train/'):])}
  return lines, episodes, summary, {k: last[k] for k in sorted(last)}


def phase_script(torch, scripts=SCRIPTS):
  """The train and train_eval scripts in-process on each configuration
  (dummy_disc unless its flags name a task), with the launch counts set
  to 0 before each run and read after, on a logdir under build/; where a
  configuration runs twice, the second run must load the checkpoint and
  continue the step counter. The log, report and save intervals are short
  enough that each fires in each run, which ends on a wall-clock budget
  that outlasts them and counts its env steps; the report's results are read as
  the script computes them, and the transport of every driver the script
  makes is recorded. Each Agent.train call must launch kernels 5, 6 and 8
  once each, and every logged loss must be finite. Each run keeps its
  latents on the card (the default latent table): the checkpoint holds
  the slot allocator, and the logged latents/valid lies in [0, 1]. A
  train_eval run must log eval episodes and eval reports, and allocate
  eval slots; a PinPad run must log ENVS train episodes and an eval
  episode, each with its score and length. After the size12m
  train_eval runs, eval_only runs from their checkpoint
  (phase_eval_only). Returns each configuration's launches."""
  import pickle
  import shutil
  from embodied_tpu_torch import parallel
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  from embodied_tpu_torch.run import loop
  wrappers = train_wrappers()
  reports, train_calls = [], []
  reporter_call = loop.Reporter.__call__
  agent_train = parallel.Agent.train

  def trained(self, *args):
    # Each train call's own launches: the policy calls and reports between
    # them launch kernels 3, 5 and 8 too.
    counts = {k: wrappers[k].launches for k in TRAIN_KERNELS}
    result = agent_train(self, *args)
    train_calls.append(
        {k: wrappers[k].launches - counts[k] for k in TRAIN_KERNELS})
    return result

  def recorded(self):
    mets = reporter_call(self)
    reports.append({k: list(getattr(v, 'shape', ())) for k, v in
                    mets.items()})
    return mets

  loop.Reporter.__call__ = recorded
  drivers, ticks, restore = count_drivers()
  parallel.Agent.train = trained
  launches, speeds = {}, {}
  for label, flags, runs, every, save_every in scripts:
    logdir = os.path.join(ROOT, 'build', f'chip_smoke_{label}')
    shutil.rmtree(logdir, ignore_errors=True)
    rows, problems = [], []
    previous = None
    for budget in runs:
      for wrapper in wrappers.values():
        wrapper.launches = 0
      nreports = len(reports)
      del train_calls[:]
      gc.collect()  # the agents of earlier runs
      torch.cuda.empty_cache()
      task = [] if '--task' in flags else ['--task', 'dummy_disc']
      argv = [*task, *flags, *NO_COUNT, '--logdir', logdir,
              '--run.steps', str(STEP_CAP), '--run.duration', str(budget),
              '--run.log_every', str(every), '--run.report_every',
              str(every), '--run.save_every', str(save_every)]
      ndrivers = len(ticks)
      torch.cuda.reset_peak_memory_stats()
      start = time.perf_counter()
      dmain.main(argv)
      wall = time.perf_counter() - start
      with open(os.path.join(logdir, 'checkpoint.pkl'), 'rb') as f:
        saved = pickle.load(f)
      lines, episodes, summary, losses = read_log(logdir)
      # The checkpoint holds the step of the last save, which the loop
      # polls between ticks, at most the step the run ended on; the train
      # driver is the run's first.
      first = previous['step'] if previous else 0
      end = first + ticks[ndrivers]
      step, counters = int(saved['step']), saved['agent']['counters']
      slots = saved['agent'].get('latents', {}).get('counters')
      del saved
      valid = [l['train/latents/valid'] for l in lines
               if 'train/latents/valid' in l]
      row = dict(
          phase='script', config=label, argv=argv, wall_s=wall,
          driver=drivers[-1], checkpoint_step=step,
          resumed_from_step=previous and previous['step'],
          budget_s=budget, env_steps=end - first,
          env_steps_per_s=(end - first) / wall,
          train_steps=counters['train'] - (
              previous['train'] if previous else 0),
          agent_counters=counters,
          launches={k: w.launches for k, w in wrappers.items()},
          reports=len(reports) - nreports,
          report_keys=reports[-1] if len(reports) > nreports else None,
          logged_report_keys=len({k for l in lines for k in l
                                  if k.startswith('report/')}),
          latent_slot_counters=slots, latents_valid=valid,
          train_calls=len(train_calls),
          train_call_launches=sorted({tuple(c.values())
                                      for c in train_calls}),
          last_losses=losses, episodes=summary,
          peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20)
      if '--script' in flags:
        row.update(
            eval_episodes=sum('eval_episode/score' in l for l in lines),
            logged_eval_keys=len({k for l in lines for k in l
                                  if k.startswith('eval/')}))
        if not row['eval_episodes'] or not row['logged_eval_keys']:
          problems.append('no eval episodes or eval reports were logged')
        if not (slots or {}).get('eval'):
          problems.append(f'no eval slots were allocated: {slots}')
      if not train_calls or any(
          c[k] != 1 for c in train_calls for k in TRAIN_KERNELS):
        problems.append(
            f'train calls launched {row["train_call_launches"]}, not one '
            f'of each of {TRAIN_KERNELS}')
      if not losses or not all(math.isfinite(v) for v in losses.values()):
        problems.append(f'logged losses {losses}')
      if 'pinpad_three' in flags and (
          len(episodes['episode']) < ENVS or
          not episodes['eval_episode']):
        problems.append(
            f'{len(episodes["episode"])} train and '
            f'{len(episodes["eval_episode"])} eval episodes logged')
      if not slots or not valid or not all(0 <= v <= 1 for v in valid):
        problems.append(f'the latent table: slots {slots}, valid {valid}')
      if row['driver'] != 'process':
        problems.append(f'the script stepped its envs by {row["driver"]}')
      if not first < step <= end:
        problems.append(f'saved at step {step}, resumed from {first}, '
                        f'ended at {end}')
      if row['reports'] < 1 or not row['logged_report_keys']:
        problems.append('the report did not run')
      if row['train_steps'] < 1 or not all(
          row['launches'][k] for k in TRAIN_KERNELS + ('obs_step',)):
        problems.append(f'no train steps on the kernels: {row["launches"]}')
      if previous and not (step >= previous['step'] and
                           counters['train'] > previous['train']):
        problems.append(f'did not resume: {previous} -> {counters}, {step}')
      if previous and row['train_steps'] > (end - first) * 2:
        problems.append('the resumed run retrained from the start')
      rows.append(row)
      emit(**row, ok=not problems)
      previous = dict(step=step, train=counters['train'])
    video = (rows[-1]['report_keys'] or {}).get('openloop/image')
    emit(phase='script', config=label, ok=not problems,
         open_loop_video_shape=video)
    if problems:
      fail('script', f'{label}: ' + '; '.join(problems))
    launches[label] = rows[-1]['launches']
    speeds[label] = rows[-1]['env_steps_per_s']
    if label == 'size12m train_eval':
      phase_eval_only(torch, os.path.join(logdir, 'checkpoint.pkl'))
    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()
  loop.Reporter.__call__ = reporter_call
  restore()
  parallel.Agent.train = agent_train
  if 'default pinpad train_eval' in speeds:
    # PinPad's host rendering beside the dummy env, on one configuration.
    emit(phase='script', ok=True, env_steps_per_s={
        k: speeds[k] for k in ('default train_eval',
                               'default pinpad train_eval')})
  return launches, speeds


def phase_eval_only(torch, checkpoint, runs=EVAL_ONLY):
  """eval_only in-process from `checkpoint`, with the launch counts set to
  0 before each run and read after: it must load the checkpoint, log
  episodes, launch no train kernel and save nothing; the DreamerV3 agent
  acts through the observe-step kernel, the random agent through none."""
  import contextlib
  import io
  import shutil
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  wrappers = train_wrappers()
  for label, flags in runs:
    logdir = os.path.join(ROOT, 'build', 'chip_smoke_eval_only')
    shutil.rmtree(logdir, ignore_errors=True)
    for wrapper in wrappers.values():
      wrapper.launches = 0
    argv = ['--task', 'dummy_disc', *flags, *NO_COUNT, '--script',
            'eval_only', '--run.from_checkpoint', checkpoint, '--logdir',
            logdir, '--run.steps', str(EVAL_ONLY_STEPS), '--run.log_every',
            '2']
    out = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
      dmain.main(argv)
    wall = time.perf_counter() - start
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
      lines = [json.loads(line) for line in f]
    random = '--random_agent' in flags
    launches = {k: w.launches for k, w in wrappers.items()}
    row = dict(
        phase='script', config=label, argv=argv, wall_s=wall,
        env_steps_per_s=EVAL_ONLY_STEPS / wall, launches=launches,
        loaded='Loading checkpoint' in out.getvalue(),
        episodes=sum('episode/score' in l for l in lines),
        saved=os.path.exists(os.path.join(logdir, 'checkpoint.pkl')))
    problems = []
    if not row['loaded'] or row['saved'] or not row['episodes']:
      problems.append(f'loaded {row["loaded"]}, saved {row["saved"]}, '
                      f'{row["episodes"]} episodes')
    acted = launches['obs_step']
    if any(launches[k] for k in TRAIN_KERNELS) or bool(acted) == random:
      problems.append(f'launches {launches}')
    emit(**row, ok=not problems)
    if problems:
      fail('script', f'{label}: ' + '; '.join(problems))
    shutil.rmtree(logdir, ignore_errors=True)


# The latent table's path (phase latents): (label, argv, timed steps in
# each turn). Each runs the defaults (the table, torch.fetch_depth 3, the
# prefetching `agent.stream`) beside the host path (HOST_PATH, the path of
# the phases before it) on the same store, observations and noise.
LATENT_PATHS = (
    ('default', ['--task', 'dummy_disc'], 5),
    ('size12m', ['--configs', 'size12m', '--task', 'dummy_disc'], 8),
)
# (a), (b), (a), (b), ...: host path, then table path. The host's clock
# drifts by 10% and more between turns on a shared host, so each (b) is
# compared with the (a) just before it.
TURNS = 4
TURN_WARMUP = 2
SYNC_STEPS = 3
STALE = (1, 5)  # windows whose context step carries an older generation


def set_fetch_depth(agent, depth):
  """A fresh fetch pipeline of `depth`: 0 while the table path is held
  against the host path step by step, the configured depth for timing."""
  agent._pending_train.clear()
  agent._fetched_train = None
  agent._fetch_depth = depth


def nbytes_in(data):
  return sum(v.nbytes for v in data.values())


def nbytes_out(outs, mets):
  """Bytes a train call brought back: its outputs and metrics (scalars
  cross as float32)."""
  return sum(v.nbytes for value in outs.values() for v in value.values()) + (
      sum(4 if isinstance(v, float) else v.nbytes for v in mets.values()))


def sync_sites(torch, fn):
  """Where `fn` made the host wait for the card, by
  torch.cuda.set_sync_debug_mode('warn'): {file:line: count}."""
  import warnings
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('warn')
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter('always')
      fn()
  finally:
    torch.cuda.set_sync_debug_mode('default')
  sites = {}
  for w in caught:
    if 'synchroniz' in str(w.message):
      site = f'{os.path.relpath(w.filename, ROOT)}:{w.lineno}'
      sites[site] = sites.get(site, 0) + 1
  return sites


def phase_latents(torch, paths=LATENT_PATHS):
  """The latent table at each configuration, through the entry points a
  user calls. Two agents on one store: the table path (the defaults) and
  the host path. They act together on the same observations of ENVS dummy
  envs for batch_length + replay_context calls; after each call the
  table's rows at the returned slots must equal the host path's packed
  latents bit for bit. The first train step on a batch of those steps
  (slots on the table path, the latents as columns on the host path) must
  give the same losses within LOSS_RTOL, latents/valid 1, and table rows
  at the trained steps equal to the host path's refreshed latents; a
  batch with stale generations at the context step of windows STALE must
  give latents/valid below 1 and the host path's losses with
  is_first[:, K] set there. Then train steps in TURNS turns, each turn a
  path's steps ended by one synchronize: (a) the host path on numpy
  batches, (b) the defaults, batches through agent.stream, (c) the
  defaults on numpy batches; each with the card's busy time from a
  profile, the bytes that cross per step, and where the host waited for
  the card. Returns the launches of the default configuration's table
  path: the policy calls' and the train steps' of mode (b)."""
  import numpy as np
  from embodied_tpu_torch.core import streams
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  wrappers = train_wrappers()
  counts = lambda: {k: w.launches for k, w in wrappers.items()}
  launches = {}
  for label, argv, steps in paths:
    problems = []
    began = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    config = common.assemble_config(dmain.CONFIGS, argv + NO_COUNT)
    table = dmain.make_agent(config)
    host = dmain.make_agent(
        common.assemble_config(dmain.CONFIGS, argv + HOST_PATH + NO_COUNT))
    host.load(table.save())
    depth = int(config.torch.fetch_depth)
    set_fetch_depth(table, 0)
    lat = table._latents
    keys = table._latent_keys
    row = dict(phase='latents', config=label, argv=argv,
               slots=lat.capacity, table_bytes=lat.nbytes,
               bytes_per_slot=lat.bytes_per_slot(lat.spaces),
               regions={k: [lat.bases[k], lat.spans[k]] for k in lat.spans})
    stats = dict(calls=0, differ=0, act_differ=0, launches=0)

    def both(carry, obs, mode='train'):
      tcarry, hcarry = carry
      before = wrappers['obs_step'].launches
      tcarry, act, out = table.policy(tcarry, obs, mode)
      stats['launches'] += wrappers['obs_step'].launches - before
      hcarry, hact, hout = host.policy(hcarry, obs, mode)
      got = lat.gather(torch.from_numpy(out['slot']).to(table.device))
      stats['calls'] += 1
      stats['differ'] += any(
          not np.array_equal(got[k].cpu().numpy(), hout[k]) for k in keys)
      stats['act_differ'] += any(
          not np.array_equal(act[k], hact[k]) for k in act)
      return (tcarry, hcarry), act, dict(out, **{k: hout[k] for k in keys})

    tdata, rows = collect_batch(
        table, config, both,
        lambda B: (table.init_policy(B), host.init_policy(B)))
    B, T = tdata['is_first'].shape
    K = config.replay_context
    hdata = batch_from_rows(host, rows, T)
    row.update(policy_calls=stats['calls'], rows_differ=stats['differ'],
               actions_differ=stats['act_differ'])
    if stats['differ'] or stats['act_differ']:
      problems.append(f'{stats["differ"]} calls wrote rows and '
                      f'{stats["act_differ"]} chose actions off the host path')
    if stats['launches'] != stats['calls']:
      problems.append(f'obs_step launched {stats["launches"]} times in '
                      f'{stats["calls"]} table-path calls')
    if len(np.unique(tdata['slot'])) != B * T:
      problems.append('the batch repeats a slot')
    # The first step on both paths, same store and noise.
    before = table.save()
    _, touts, tmets = table.train(table.init_train(B), tdata)
    _, houts, hmets = host.train(host.init_train(B), hdata)
    losses, bad = check_losses(tmets, hmets)
    refreshed = lat.gather(torch.from_numpy(tdata['slot'][:, K:]).to(
        table.device))
    off = {k: int((refreshed[k].cpu().numpy() != houts['replay'][k]).sum())
           for k in keys}
    row.update(losses_table_vs_host=losses, latents_valid=tmets[
        'latents/valid'], refreshed_rows_differ=off, loss_rtol=LOSS_RTOL)
    if bad:
      problems.append(f'losses off the host path: {bad}')
    if tmets['latents/valid'] != 1.0:
      problems.append(f'latents/valid {tmets["latents/valid"]} on fresh slots')
    if any(off.values()) or 'replay' in touts:
      problems.append(f'refreshed latents off the host path: {off}')
    # Stale generations at the context step of windows STALE.
    table.load(before)
    host.load(before)
    stale = dict(tdata, slotgen=tdata['slotgen'].copy())
    stale['slotgen'][list(STALE), K - 1] += 1
    reset = dict(hdata, is_first=hdata['is_first'].copy())
    reset['is_first'][list(STALE), K] = True
    _, _, smets = table.train(table.init_train(B), stale)
    _, _, rmets = host.train(host.init_train(B), reset)
    losses, bad = check_losses(smets, rmets)
    row.update(stale_windows=list(STALE), stale_latents_valid=smets[
        'latents/valid'], stale_losses_table_vs_host=losses)
    if not smets['latents/valid'] < 1 or bad:
      problems.append(f'stale slots: valid {smets["latents/valid"]}, '
                      f'losses off the host path {bad}')
    # Turns: (a) the host path on numpy batches, (b) the defaults.
    set_fetch_depth(table, depth)
    # A finite source: its prefetch thread ends with it, and lets go of
    # the agent.
    total = TURN_WARMUP + TURNS * steps + 2 + SYNC_STEPS
    stream = iter(table.stream(streams.Stateless(iter([tdata] * total))))
    # (c): the table and the fetch pipeline on numpy batches, which parts
    # the prefetch thread's share from the rest of (b).
    paths = dict(a=(host, lambda: hdata), b=(table, lambda: next(stream)),
                 c=(table, lambda: tdata))
    state = {mode: dict(carry=paths[mode][0].init_train(B), steps=0,
                        launches={k: 0 for k in TRAIN_KERNELS})
             for mode in paths}

    def run(mode, n=0, fn=None):
      """n train steps of `mode`, or `fn` on it, counting its steps and
      its launches of the train kernels."""
      agent, data = paths[mode]
      st = state[mode]
      before = counts()
      if fn is None:
        for _ in range(n):
          st['carry'], outs, mets = agent.train(st['carry'], data())
        st['out_bytes'] = nbytes_out(outs, mets)
      else:
        st['carry'], result = fn(agent, st['carry'], data)
      st['steps'] += n
      for k in TRAIN_KERNELS:
        st['launches'][k] += wrappers[k].launches - before[k]
      return None if fn is None else result

    for mode in paths:
      run(mode, TURN_WARMUP)
    times = {mode: [] for mode in paths}
    for _ in range(TURNS):
      for mode in paths:
        torch.cuda.synchronize()
        start = time.perf_counter()
        run(mode, steps)
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - start) * 1e3 / steps)
    modes = {}
    for mode, name in (
        ('a', 'host path, fetch_depth 0, numpy batches'),
        ('b', f'latent table, fetch_depth {depth}, agent.stream'),
        ('c', f'latent table, fetch_depth {depth}, numpy batches')):
      ms = statistics.median(times[mode])
      profile = run(mode, 2, lambda agent, carry, data: profile_train(
          torch, agent, carry, data, ms, steps=2))
      sites = sync_sites(torch, lambda: run(mode, SYNC_STEPS))
      st = state[mode]
      modes[mode] = dict(
          path=name, ms_per_train_step=ms, turns_ms=times[mode],
          busy_ms_per_step=profile['busy_ms_per_step'],
          idle_share=profile['idle_share'],
          kernels_per_step=profile['kernels_per_step'],
          host_to_card_bytes=nbytes_in(hdata if mode == 'a' else tdata),
          card_to_host_bytes=st['out_bytes'],
          syncs_per_step=sum(sites.values()) / SYNC_STEPS, sync_sites=sites,
          train_steps=st['steps'], launches=st['launches'])
      if any(v != st['steps'] for v in st['launches'].values()):
        problems.append(f'mode {mode}: {st["steps"]} steps launched '
                        f'{st["launches"]}')
    row.update(modes=modes, step_ratio_b_over_a=(
        modes['b']['ms_per_train_step'] / modes['a']['ms_per_train_step']),
        step_ratio_b_over_a_by_turn=[
            b / a for a, b in zip(times['a'], times['b'])],
        step_ratio_c_over_a_by_turn=[
            c / a for a, c in zip(times['a'], times['c'])],
        peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
        seconds=time.perf_counter() - began)
    if label == 'default':
      launches = dict(obs_step=stats['launches'], **state['b']['launches'])
    row['ok'] = not problems
    emit(**row)
    if problems:
      fail('latents', f'{label}: ' + '; '.join(problems))
    del table, host, stream, paths
    torch.cuda.empty_cache()
  return launches


# The default configuration's acting and train paths: (label, argv, policy
# calls, modes, kernel) as SLICE_PATHS, and (label, argv, warm-up steps,
# timed steps, against kernel: off) as TRAIN_PATHS.
DEFAULT_ARGV = ['--task', 'dummy_disc']
DEFAULT_SLICE = (
    ('acting default', DEFAULT_ARGV, 20, ('train',), 'obs_step'),
    ('acting default pinpad', PINPAD, 20, ('train',), 'obs_step'),
)
DEFAULT_TRAIN = (('train default', DEFAULT_ARGV, 1, 3, True),)


def phase_default(torch):
  """The default configuration (configs.yaml `defaults`, 202,982,304
  parameters) through the entry points a user calls: policy calls on
  dummy_disc and on PinPad (kernel 3 once each) against the plain path,
  Agent.train steps (kernels 5, 6 and 8 and the optimizer's update once
  each) with the first step's losses against kernel: off and a profile, and main.main with the
  process driver on dummy_disc and PinPad. Each path runs with the launch
  counts set to 0 before it and read after.
  Returns the launches of the policy calls and of the train steps."""
  launches = phase_slice(torch, DEFAULT_SLICE)
  trained = phase_train(torch, DEFAULT_TRAIN)[DEFAULT_TRAIN[0][0]]
  launches.update({k: trained[k] for k in TRAIN_KERNELS + (UPDATE,)})
  _, speeds = phase_script(torch, DEFAULT_SCRIPTS)
  emit(phase='default', ok=True, launches=launches)
  return launches, speeds['default pinpad train_eval']


# The actor-learner script at the default configuration on PinPad: 16
# train and 4 eval envs in their own processes, the actor batching
# actor_batch = 16 // 2 = 8 of them per policy call, the replay and the
# logger in their own processes. The smoke runs main.main in its own
# process, which alone may hold the card. The budget counts from the
# first train step, as the train scripts' budgets count after their
# set-up: the agent's set-up and its first 2.4 GB save came before the
# first train step, at 30-36 s on one host, and a budget of 50 s from the
# start of the roles (run.duration) held no report, no save and no line
# of the metrics log. The smoke ends the run as a user does, with an
# interrupt; run.duration stays as a cap that it never reaches. Reports
# and saves come every 20 s (for the reasons given at DEFAULT_SCRIPTS),
# logs every 10 s: the logger writes on its own clock, and a log every
# 10 s puts a write of the first report's results and of the train
# losses inside the budget.
PARALLEL = PINPAD + ['--script', 'parallel']
PARALLEL_BUDGET = 40
PARALLEL_SETUP = 75  # seconds within which the first train step must come
PARALLEL_EVERY = 20
PARALLEL_LOG_EVERY = 10
PARALLEL_KERNELS = ('obs_step',) + TRAIN_KERNELS
PARALLEL_FILES = ('agent.pkl', 'replay.pkl', 'logger.pkl')


def child_pids():
  """This process's live children, without multiprocessing's resource
  tracker (a helper that lives as long as the process)."""
  pids = set()
  for pid in filter(str.isdigit, os.listdir('/proc')):
    try:
      with open(f'/proc/{pid}/stat') as f:
        ppid = int(f.read().rsplit(')', 1)[1].split()[1])
      with open(f'/proc/{pid}/cmdline') as f:
        tracker = 'resource_tracker' in f.read()
    except OSError:
      continue
    if ppid == os.getpid() and not tracker:
      pids.add(int(pid))
  return pids


def holds_card(pid):
  """Whether process `pid` has a device node of a card open (a CUDA
  context opens /dev/nvidia<N>; cuInit alone opens only nvidiactl)."""
  try:
    fds = os.listdir(f'/proc/{pid}/fd')
  except OSError:
    return False
  for fd in fds:
    try:
      target = os.readlink(f'/proc/{pid}/fd/{fd}')
    except OSError:
      continue
    if target.startswith('/dev/nvidia') and target[11:].isdigit():
      return True
  return False


def card_pids():
  query = subprocess.run(
      ['nvidia-smi', '--query-compute-apps=pid', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=30)
  return {int(line) for line in query.stdout.split() if line.isdigit()}


def card_watcher(done, before, seen):
  """A thread that reads every 2 s, until the event `done`, which
  processes hold the card (nvidia-smi's compute apps) into
  seen['card_pids'], this process's children other than `before` into
  seen['children'], and those of them with a card's device node open into
  seen['touched']."""
  import threading

  def watch():
    while not done.wait(2.0):
      seen['card_pids'] |= card_pids()
      children = child_pids() - before
      seen['children'] |= children
      seen['touched'] |= {pid for pid in children if holds_card(pid)}
  return threading.Thread(target=watch, name='card-watcher')


class RunProbe:
  """The instruments of one script=parallel run in this process (phases
  parallel and parallel_group), a context manager around main.main. It
  sets the launch counts to 0 and wraps Agent.policy (each call's ms and
  kernel 3 launches), Agent.train (kernels 5, 6 and 8's launches each
  call, its losses and, with `counts` from counted_collectives, the
  collectives it made), the actor's requests (the env steps and episodes
  it sees, its last request with the carry it was acted on with, failed
  calls), the learner's reports and saves (the train-call index of each),
  the timer's stats and the workers' crashes, and runs card_watcher. With
  `budget`, it interrupts the main thread, as a user ends a run, `budget`
  seconds after the first train step, if one came within PARALLEL_SETUP.
  On leaving it puts everything back and reads the launches and what the
  run left behind; `summary` gives the figures that both phases print."""

  def __init__(self, budget=None, counts=None):
    import threading
    self.budget, self.counts = budget, counts
    self.wrappers = train_wrappers()
    self.policy_ms, self.policy_span, self.policy_launches = [], [], []
    self.train_calls, self.train_span, self.collectives = [], [], []
    self.losses, self.nonfinite = [], []
    self.steps = {'train': 0, 'eval': 0}
    self.running, self.episodes = {}, {'train': [], 'eval': []}
    self.timed, self.last, self.failures, self.crashes = [], {}, [], []
    self.actors, self.marks = [], {'report': [], 'save': []}
    self.seen = {'card_pids': set(), 'children': set(), 'touched': set()}
    self.first_train, self.interrupted, self.done = (
        threading.Event(), threading.Event(), threading.Event())

  def _patches(self):
    """(owner, attribute, wrapper) of every wrapped function."""
    import _thread
    from embodied_tpu_torch import parallel
    from embodied_tpu_torch.remote import proc
    from embodied_tpu_torch.run import parallel_impl
    from embodied_tpu_torch.utils import timer
    probe, wrappers = self, self.wrappers
    agent_policy, agent_train = parallel.Agent.policy, parallel.Agent.train
    infer, forward = parallel_impl._Actor._infer, parallel_impl._Actor._forward
    report, save = parallel_impl._Learner._report, parallel_impl._Learner._save
    stats, record_error = timer.stats, proc._record_error

    def policy(self, *args, **kwargs):
      before = wrappers['obs_step'].launches
      begin = time.perf_counter()
      result = agent_policy(self, *args, **kwargs)
      probe.policy_ms.append((time.perf_counter() - begin) * 1e3)
      probe.policy_span.append(begin)
      probe.policy_launches.append(wrappers['obs_step'].launches - before)
      return result

    def train(self, *args):
      launched = {k: wrappers[k].launches for k in TRAIN_KERNELS}
      counts = probe.counts or {}
      made = {k: list(v) for k, v in counts.items()}
      begin = time.perf_counter()
      result = agent_train(self, *args)
      probe.train_span.append((begin, time.perf_counter()))
      probe.train_calls.append(
          {k: wrappers[k].launches - launched[k] for k in TRAIN_KERNELS})
      probe.collectives.append(
          {k: [counts[k][i] - made[k][i] for i in (0, 1)]
           for k in counts if counts[k] != made[k]})
      probe.first_train.set()
      probe.losses.append(sum(is_loss(k) for k in result[2]))
      probe.nonfinite.extend(k for k, v in result[2].items()
                             if is_loss(k) and not math.isfinite(v))
      return result

    def actor_infer(self, request):
      # The actor's view of each env's episodes and steps, and its last
      # request with the carry it is acted on with.
      if not probe.actors:
        probe.actors.append(self)
      probe.last.update(carry=self.cache.gather(request['envid']), obs={
          k: v for k, v in request.items()
          if k not in ('envid', 'is_eval') and not k.startswith('log/')})
      for i, envid in enumerate(request['envid']):
        kind = 'eval' if request['is_eval'][i] else 'train'
        probe.steps[kind] += 1
        if request['is_first'][i]:
          probe.running[int(envid)] = [0.0, 0]
        score = probe.running.setdefault(int(envid), [0.0, 0])
        score[0] += float(request['reward'][i])
        score[1] += 1
        if request['is_last'][i]:
          probe.episodes[kind].append(tuple(probe.running.pop(int(envid))))
      return recorded(infer, self, request)

    def actor_forward(self, tran):
      return recorded(forward, self, tran)

    def recorded(fn, actor, *args):
      try:
        return fn(actor, *args)
      except Exception as e:
        probe.failures.append(dict(call=fn.__name__, error=repr(e),
                                   after_stop=actor.stop.is_set()))
        raise

    def learner_report(self, *args):
      probe.marks['report'].append(self.steps)
      return report(self, *args)

    def learner_save(self):
      probe.marks['save'].append(self.steps)
      return save(self)

    def crashed(name, exc):
      probe.crashes.append(f'{name}: {exc!r}')
      record_error(name, exc)

    def tee(reset=True, log=False):
      result = stats(reset, log)
      if reset:
        probe.timed.append(result)
      return result

    def end_run():
      if probe.first_train.wait(PARALLEL_SETUP) and not probe.done.wait(
          probe.budget):
        probe.interrupted.set()
        _thread.interrupt_main()
    self._end_run = end_run
    return [(parallel.Agent, 'policy', policy),
            (parallel.Agent, 'train', train),
            (parallel_impl._Actor, '_infer', actor_infer),
            (parallel_impl._Actor, '_forward', actor_forward),
            (parallel_impl._Learner, '_report', learner_report),
            (parallel_impl._Learner, '_save', learner_save),
            (timer, 'stats', tee), (proc, '_record_error', crashed)]

  def __enter__(self):
    import threading
    for wrapper in self.wrappers.values():
      wrapper.launches = 0
    self.before_threads = {t.ident for t in threading.enumerate()}
    self.before_children = child_pids()
    patches = self._patches()
    self.originals = [(owner, name, getattr(owner, name))
                      for owner, name, _ in patches]
    for owner, name, fn in patches:
      setattr(owner, name, fn)
    self.helpers = [card_watcher(self.done, self.before_children, self.seen)]
    if self.budget is not None:
      self.helpers.append(threading.Thread(target=self._end_run,
                                           name='run-ender'))
    for helper in self.helpers:
      helper.start()
    self.start = time.perf_counter()
    return self

  def __exit__(self, *exc):
    import threading
    from embodied_tpu_torch.utils import timer
    self.wall = time.perf_counter() - self.start
    for owner, name, fn in self.originals:
      setattr(owner, name, fn)
    self.done.set()
    for helper in self.helpers:
      helper.join()
    self.timed.append(timer.stats(reset=True))  # the last stats' window
    self.launches = {k: self.wrappers[k].launches for k in PARALLEL_KERNELS}
    self.left_threads = [t.name for t in threading.enumerate()
                         if t.ident not in self.before_threads and
                         t.is_alive()]
    self.left_children = sorted(child_pids() - self.before_children)
    return False

  def summary(self):
    """The run's figures, from the run's start (main.main's call)."""
    waited = sum(t.get('policy_lock_wait/total', 0) for t in self.timed)
    waits = sum(t['policy_lock_wait/total'] / t['policy_lock_wait/avg']
                for t in self.timed if t.get('policy_lock_wait/avg'))
    ordered, spans = sorted(self.policy_ms), self.train_span
    return dict(
        wall_s=self.wall, env_steps=self.steps,
        env_steps_per_s=sum(self.steps.values()) / self.wall,
        first_policy_s=(self.policy_span[0] - self.start
                        if self.policy_span else None),
        first_train_s=spans[0][0] - self.start if spans else None,
        last_train_s=spans[-1][1] - self.start if spans else None,
        train_steps=len(self.train_calls),
        train_call_launches=sorted(
            {tuple(c.values()) for c in self.train_calls}),
        actor_calls=len(self.policy_ms),
        policy_call_launches=sorted(set(self.policy_launches)),
        policy_ms_median=statistics.median(ordered) if ordered else None,
        policy_ms_p90=(ordered[int(0.9 * (len(ordered) - 1))]
                       if ordered else None),
        lock_wait_ms_per_call=waited / waits * 1e3 if waits else None,
        lock_waits=round(waits), launches=self.launches,
        losses_per_call=sorted(set(self.losses)),
        nonfinite_train_losses=sorted(set(self.nonfinite)),
        reports=self.marks['report'], saves=self.marks['save'],
        actor_failures=self.failures, crashes=self.crashes,
        card_pids=sorted(self.seen['card_pids']),
        children_seen=len(self.seen['children']),
        children_on_card=sorted(self.seen['touched']),
        left_threads=self.left_threads, left_children=self.left_children)


def phase_parallel(torch, pinpad_speed):
  """script=parallel in-process at the default configuration on PinPad
  (PARALLEL), instrumented by RunProbe (the launch counts set to 0 before
  the run and read after; the card watcher; the run ended
  PARALLEL_BUDGET seconds after its first train step). The run must
  launch kernels 3, 5, 6 and 8, train (each Agent.train call one launch
  of kernels 5, 6 and 8, its losses finite), report and log finite train
  losses into its metrics log, write its three checkpoints, send RPC
  frames through the native codec, and leave no child process and no
  thread behind; no child may touch the card, no role may fail (a role
  that fails while the run goes on raises out of main.main; the smoke
  also records every worker crash) and no actor call may raise. Kernel 3
  is then held against its plain version on the actor's last request
  (batch actor_batch, the carry it was acted on with). Prints env steps
  and env steps/s (train and eval envs), train steps and train frames/s,
  the replayed-to-env step ratio against run.train_ratio, the actor's
  calls with their ms (median, p90) and its lock wait per call (timer
  section policy_lock_wait), the episodes the actor saw end and those
  logged, the RPC servers' stats, the peak memory, and `pinpad_speed`,
  the default PinPad train_eval run's env steps/s in this call."""
  import shutil
  from embodied_tpu_torch import native
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  from embodied_tpu_torch.utils import timer
  logdir = os.path.join(ROOT, 'build', 'chip_smoke_parallel')
  shutil.rmtree(logdir, ignore_errors=True)
  probe = RunProbe(budget=PARALLEL_BUDGET)
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  timer.stats(reset=True)
  cap = PARALLEL_SETUP + PARALLEL_BUDGET + 30
  argv = [*PARALLEL, *NO_COUNT, '--logdir', logdir,
          '--run.steps', str(STEP_CAP),
          '--run.duration', str(cap),
          '--run.log_every', str(PARALLEL_LOG_EVERY),
          '--run.report_every', str(PARALLEL_EVERY),
          '--run.save_every', str(PARALLEL_EVERY)]
  with probe:
    try:
      dmain.main(argv)
    except KeyboardInterrupt:
      if not probe.interrupted.is_set():
        raise
  run = probe.summary()
  lines, _, logged_episodes, losses = read_log(logdir)
  reports = sum(any(k.startswith('report/') for k in l) for l in lines)
  actor = probe.actors[0] if probe.actors else None
  last, steps = probe.last, probe.steps
  servers = {k: v for l in lines for k, v in l.items()
             if k.startswith(('server/', 'replay/', 'replay_eval/'))}
  plain_errs, same = None, None
  if actor is not None:
    for name, stats_of in (('actor', actor.server), ('actor_replay',
                                                      actor.replay),
                           ('actor_logger', actor.logger)):
      servers.update({f'{name}/{k}': v
                      for k, v in stats_of.stats().items()})
    # After the launches were read: this call is no launch of the run's.
    plain_errs, same = check_against_plain(torch, actor.agent, last)
  config = dmain.common.assemble_config(dmain.CONFIGS, argv)
  batch_steps = config.batch_size * config.batch_length
  ntrain = run['train_steps']
  spans = probe.train_span
  span = spans[-1][1] - spans[0][0] if spans else 0.0
  row = dict(
      phase='parallel', argv=argv, budget_s=PARALLEL_BUDGET,
      budget_from='the first train step', codec=native.codec_status(),
      envs=config.run.envs, eval_envs=config.run.eval_envs,
      actor_batch=len(last['obs']['is_first']) if last else None,
      **run, train_env_steps_per_s=steps['train'] / run['wall_s'],
      pinpad_train_eval_env_steps_per_s=pinpad_speed,
      train_frames_per_s=ntrain * batch_steps / span if span else 0.0,
      replay_ratio=ntrain * batch_steps / max(steps['train'], 1),
      train_ratio=config.run.train_ratio,
      obs_step_plain_max_abs_err=(
          {k: e for k, (e, _) in plain_errs.items()} if plain_errs else None),
      obs_step_sample_agreement=same,
      episodes={k: dict(count=len(v), scores=sorted({s for s, _ in v}),
                        lengths=sorted({n for _, n in v}))
                for k, v in probe.episodes.items()},
      logged_episodes=logged_episodes, log_lines=len(lines),
      logged_reports=reports, logged_losses=losses, rpc=servers,
      files={f: os.path.exists(os.path.join(logdir, f))
             for f in PARALLEL_FILES},
      peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
      own_pid=os.getpid())
  launches, seen = probe.launches, probe.seen
  interrupted = probe.interrupted.is_set()
  del actor, probe
  problems = []
  if row['codec'] != 'native':
    problems.append(f'the codec did not build: {row["codec"]}')
  if not interrupted:
    problems.append(f'no train step within {PARALLEL_SETUP} s')
  if not all(launches.values()):
    problems.append(f'kernels not launched: {launches}')
  if min(launches['observe_seq'], launches['imagine_seq']) <= ntrain:
    problems.append(f'no report launched kernels 5 and 8: {launches} in '
                    f'{ntrain} train steps')
  if not ntrain or row['train_call_launches'] != [(1, 1, 1)]:
    problems.append(f'{ntrain} train steps, launches per call '
                    f'{row["train_call_launches"]}')
  if row['nonfinite_train_losses']:
    problems.append(f'non-finite train losses {row["nonfinite_train_losses"]}')
  if not reports or not losses or not all(
      math.isfinite(v) for v in losses.values()):
    problems.append(f'{reports} reports logged, train losses logged '
                    f'{losses}')
  if plain_errs is None or not all(ok for _, ok in plain_errs.values()):
    problems.append(f'kernel 3 at the actor batch disagrees with the plain '
                    f'path: {plain_errs}')
  if not all(row['files'].values()):
    problems.append(f'checkpoints {row["files"]}')
  # nvidia-smi's PIDs are not this container's (it listed PID 1 for this
  # process): the child check rests on holds_card; nvidia-smi must list
  # one process.
  if seen['touched'] or len(seen['card_pids']) > 1:
    problems.append(f'a child touched the card: nvidia-smi listed '
                    f'{sorted(seen["card_pids"])}, children holding a '
                    f'device node {sorted(seen["touched"])}')
  if len(seen['children']) < config.run.envs + config.run.eval_envs + 2:
    problems.append(f'{len(seen["children"])} child processes ran')
  if row['left_threads'] or row['left_children']:
    problems.append(f'left behind: threads {row["left_threads"]}, '
                    f'processes {row["left_children"]}')
  if not row['actor_calls'] or row['actor_failures'] or row['crashes'] or (
      servers.get('actor/errors')):
    problems.append(f'the actor did not serve, or a call or a role failed: '
                    f'{row["actor_failures"]} {row["crashes"]}')
  if not steps['train'] or not steps['eval']:
    problems.append(f'env steps {steps}')
  emit(**row, ok=not problems)
  if problems:
    fail('parallel', '; '.join(problems))
  shutil.rmtree(logdir, ignore_errors=True)
  gc.collect()
  torch.cuda.empty_cache()
  return launches


# script=parallel on a process group of two ranks: the default
# configuration on PinPad, each rank with its own envs (GROUP_CUTS, the
# only cuts), replay and logger, 8 rows a rank on the '2,1,1' mesh.
GROUP_RANKS = 2
GROUP_ROWS = 8
GROUP_CUTS = {'run.envs': 4, 'run.eval_envs': 1}  # a rank's; widths kept
GROUP_ARGV = PARALLEL + NO_COUNT + [
    '--batch_size', str(GROUP_ROWS), '--torch.mesh', '2,1,1',
    *(x for k, v in GROUP_CUTS.items() for x in (f'--{k}', str(v)))]
GROUP_JOIN = 240  # seconds a rank may take beyond its set-up and budget


def group_kernels(torch, K, B=GROUP_ROWS, D=DEFAULT['D'], H=DEFAULT['H'],
                  S=DEFAULT['S'], C=DEFAULT['C'], U=DEFAULT['U']):
  """Kernels 5, 6 and 8 at the shapes that a rank of B rows gives them
  (GROUP_ROWS: phase_parallel_group's), each against its plain version
  as in phase kernels (random weights and inputs from their own seed,
  checked, untimed): the window of WINDOW steps of B rows with the
  encoder's token width `K`, and the rollout of IMAG_LENGTH steps from B
  x WINDOW starts with a categorical head of 5 actions. Returns the rows
  with their problems."""
  gen = torch.Generator(DEV).manual_seed(SEED + 2)
  L = S * C
  core, head = size12m_params(torch, gen, D=D, H=H, S=L, K=K, L=L)
  rows = window_kernels(torch, gen, core + head, None, B=B, D=D,
                        H=H, S=S, K=K, C=C, config='default', timed=False)
  rows.append(rollout_kernel(
      torch, gen, core, True, None, B=B * WINDOW, D=D, H=H, S=S,
      U=U, C=C, config='default', timed=False))
  return rows


def group_rank_main(rank, port, folder, backend):
  """One rank of phase_parallel_group (a spawned process): main.main on
  GROUP_ARGV as a multi-host launcher starts a rank (RANK, WORLD_SIZE,
  LOCAL_RANK, torch.coordinator_address), instrumented by RunProbe with
  the collectives counted, and ended by an interrupt of rank 0
  PARALLEL_BUDGET seconds after its first train step (every rank's learner
  stops at rank 0's request). On one card the rank starts a gloo group
  itself, which parallel.setup keeps (NCCL refuses two ranks on one
  card), and runs without the sync guard (gloo waits on host copies of
  CUDA tensors). Writes what it saw to folder/rank<rank>.pkl: the probe's
  summary (the launch counts of kernels 3, 5, 6 and 8, set to 0 before
  the run and read after it, the train-call indices of its reports and
  saves, its env steps, the actor's times), the collectives, its saved
  store's digests, the encoder's token width and, on rank 1, kernel 3
  against its plain version on the actor's last request."""
  import datetime
  import hashlib
  import pickle
  import torch
  import torch.distributed as dist
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  began = time.perf_counter()
  local = rank if backend == 'nccl' else 0
  os.environ.update(RANK=str(rank), WORLD_SIZE=str(GROUP_RANKS),
                    LOCAL_RANK=str(local))
  logdir = os.path.join(folder, 'logdir')
  cap = PARALLEL_SETUP + PARALLEL_BUDGET + 60
  argv = [*GROUP_ARGV, '--logdir', logdir, '--run.steps', str(STEP_CAP),
          '--run.duration', str(cap),
          '--run.log_every', str(PARALLEL_LOG_EVERY),
          '--run.report_every', str(PARALLEL_EVERY),
          '--run.save_every', str(PARALLEL_EVERY),
          '--torch.coordinator_address', f'localhost:{port}']
  if backend == 'gloo':
    torch.cuda.set_device(local)
    dist.init_process_group(
        'gloo', init_method=f'tcp://localhost:{port}', rank=rank,
        world_size=GROUP_RANKS, timeout=datetime.timedelta(seconds=600))
    argv += ['--torch.transfer_guard', 'False']
  counts, restore = counted_collectives(dist)
  # Rank 0 alone is interrupted, as a user ends a run on one host: its
  # learner asks, and every rank's learner stops at the next decision.
  probe = RunProbe(budget=PARALLEL_BUDGET if rank == 0 else None,
                   counts=counts)
  error = None
  try:
    with probe:
      dmain.main(argv)
  except KeyboardInterrupt:
    if not probe.interrupted.is_set():
      error = 'an interrupt before the budget ended'
  except Exception as e:  # written to the rank's file, failing the phase
    error = repr(e)
  finally:
    restore()
  mine = logdir if rank == 0 else os.path.join(logdir, f'rank{rank}')
  digests, counters = {}, None
  if os.path.exists(os.path.join(mine, 'agent.pkl')):
    with open(os.path.join(mine, 'agent.pkl'), 'rb') as f:
      saved = pickle.load(f)['agent']
    counters = saved['counters']
    digests = {k: hashlib.sha256(v.tobytes()).hexdigest() + str(v.dtype)
               for k, v in saved['store'].items()}
    del saved
  lines, _, _, logged = read_log(mine)
  plain_errs, same, token_dim = None, None, None
  if probe.actors:
    token_dim = probe.actors[0].agent.model.dyn.token_dim
    if rank == 1 and probe.last:
      plain_errs, same = check_against_plain(
          torch, probe.actors[0].agent, probe.last)
  spans, made = probe.train_span, probe.collectives
  out = dict(
      rank=rank, error=error, seconds=time.perf_counter() - began,
      device=torch.cuda.get_device_name(local), **probe.summary(),
      train_span=(spans[0][0], spans[-1][1]) if spans else None,
      step_collectives=made[-1] if made else None,
      step_collectives_differ=len({json.dumps(c, sort_keys=True)
                                   for c in made[1:]}) > 1,
      collectives={k: v for k, v in counts.items() if v[0]},
      log_lines=len(lines), logged_losses=logged, counters=counters,
      digests=digests, token_dim=token_dim,
      plain_errs=({k: e for k, (e, _) in plain_errs.items()}
                  if plain_errs else None),
      plain_ok=(all(ok for _, ok in plain_errs.values())
                if plain_errs else None), sample_agreement=same,
      peak_mem_mb=torch.cuda.max_memory_allocated(local) / 2 ** 20)
  with open(os.path.join(folder, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)


def phase_parallel_group(torch):
  """script=parallel on two ranks (group_rank_main): two NCCL ranks where
  the machine has two cards, else two gloo ranks on one card. Both must
  exit 0 with nothing left behind and no child on the card; make the same
  number of train calls, each launching kernels 5, 6 and 8 once with
  finite losses, and every actor call kernel 3 once; report and save at
  the same train-call indices; and end with saved stores equal bit for
  bit (the step is data parallel). Kernel 3 is held against its plain
  version on rank 1's actor's last request, and kernels 5, 6 and 8
  against theirs at a rank's shapes (group_kernels), after the ranks have
  ended, so that no launch of theirs counts. Prints per rank its env
  steps/s, the replayed-to-env ratio, the actor's ms per call (median,
  p90), its lock wait per call and peak MB; the global train frames/s
  (GROUP_RANKS x GROUP_ROWS x batch_length frames a train step); the
  collectives a train step makes and their bytes. Returns each kernel's
  launches on each rank."""
  import multiprocessing
  import pickle
  import shutil
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  backend = 'nccl' if torch.cuda.device_count() >= GROUP_RANKS else 'gloo'
  folder = os.path.join(ROOT, 'build', 'chip_smoke_parallel_group')
  shutil.rmtree(folder, ignore_errors=True)
  os.makedirs(folder)
  port = free_port()
  context = multiprocessing.get_context('spawn')
  procs = [context.Process(target=group_rank_main,
                           args=(r, port, folder, backend))
           for r in range(GROUP_RANKS)]
  began = time.perf_counter()
  for proc in procs:
    proc.start()
  deadline = time.time() + PARALLEL_SETUP + PARALLEL_BUDGET + GROUP_JOIN
  for proc in procs:
    proc.join(max(1.0, deadline - time.time()))
  for proc in procs:
    if proc.is_alive():
      proc.kill()
      proc.join()
  joined = time.perf_counter() - began
  codes = [p.exitcode for p in procs]
  ranks = []
  for r in range(GROUP_RANKS):
    path = os.path.join(folder, f'rank{r}.pkl')
    if os.path.exists(path):
      with open(path, 'rb') as f:
        ranks.append(pickle.load(f))
  shutil.rmtree(folder, ignore_errors=True)
  if any(codes) or len(ranks) != GROUP_RANKS:
    fail('parallel_group', f'ranks exited with {codes}, '
         f'{len(ranks)} wrote their results')
  config = dmain.common.assemble_config(dmain.CONFIGS, GROUP_ARGV)
  frames = GROUP_RANKS * GROUP_ROWS * config.batch_length
  ntrain = ranks[0]['train_steps']
  span = ranks[0]['train_span']
  span = span[1] - span[0] if span else 0.0
  per_rank = ('error', 'wall_s', 'seconds', 'device', 'first_train_s',
              'train_steps', 'train_call_launches', 'launches',
              'actor_calls', 'policy_call_launches', 'env_steps',
              'env_steps_per_s', 'policy_ms_median', 'policy_ms_p90',
              'lock_wait_ms_per_call', 'reports', 'saves', 'counters',
              'log_lines', 'logged_losses', 'losses_per_call',
              'nonfinite_train_losses', 'actor_failures', 'crashes',
              'peak_mem_mb', 'children_seen', 'children_on_card',
              'card_pids', 'left_threads', 'left_children')
  row = dict(
      phase='parallel_group', backend=backend, ranks=GROUP_RANKS,
      exit_codes=codes, ranks_ended_s=joined, argv=GROUP_ARGV,
      cuts=GROUP_CUTS,
      rows_per_rank=GROUP_ROWS, budget_s=PARALLEL_BUDGET,
      budget_from='the first train step',
      transfer_guard=backend == 'nccl',
      train_frames_per_s=ntrain * frames / span if span else 0.0,
      replay_ratio=[r['train_steps'] * GROUP_ROWS * config.batch_length /
                    max(r['env_steps']['train'], 1) for r in ranks],
      train_ratio=config.run.train_ratio,
      collectives_per_train_step=ranks[0]['step_collectives'],
      collectives_per_run=[r['collectives'] for r in ranks],
      stores_equal=bool(ranks[0]['digests']) and (
          ranks[0]['digests'] == ranks[1]['digests']),
      obs_step_plain_max_abs_err=ranks[1]['plain_errs'],
      obs_step_sample_agreement=ranks[1]['sample_agreement'],
      per_rank=[{k: r[k] for k in per_rank} for r in ranks])
  problems = []
  for r in ranks:
    name = f'rank {r["rank"]}'
    if r['error']:
      problems.append(f'{name}: {r["error"]}')
    if not r['train_steps'] or r['train_call_launches'] != [(1, 1, 1)]:
      problems.append(f'{name}: {r["train_steps"]} train calls, launches '
                      f'per call {r["train_call_launches"]}')
    if not r['actor_calls'] or r['policy_call_launches'] != [1]:
      problems.append(f'{name}: {r["actor_calls"]} actor calls, kernel 3 '
                      f'launches per call {r["policy_call_launches"]}')
    # The train calls' own losses: the logger writes a line only when
    # the env step moved, and the limiter holds the envs back while the
    # learner samples the tokens that the replay banked while it filled
    # (PERF.md, PR 17), so the log may hold no train line yet.
    if r['nonfinite_train_losses'] or not r['losses_per_call'] or not min(
        r['losses_per_call']):
      problems.append(f'{name}: train calls with no or non-finite losses: '
                      f'{r["losses_per_call"]} '
                      f'{r["nonfinite_train_losses"]}')
    if r['actor_failures'] or r['crashes']:
      problems.append(f'{name}: failed {r["actor_failures"]} '
                      f'{r["crashes"]}')
    if r['children_on_card'] or r['left_threads'] or r['left_children']:
      problems.append(f'{name}: children on the card '
                      f'{r["children_on_card"]}, left threads '
                      f'{r["left_threads"]}, processes {r["left_children"]}')
    if r['step_collectives_differ']:
      problems.append(f'{name}: train steps made different collectives')
  if len({r['train_steps'] for r in ranks}) != 1:
    problems.append(f'train calls {[r["train_steps"] for r in ranks]}')
  for mark in ('reports', 'saves'):
    if not ranks[0][mark] or any(r[mark] != ranks[0][mark] for r in ranks):
      problems.append(f'{mark} at {[r[mark] for r in ranks]}')
  if not row['stores_equal'] or len(
      {r['counters']['train'] for r in ranks if r['counters']}) != 1:
    problems.append(f'the saved stores differ: counters '
                    f'{[r["counters"] for r in ranks]}')
  if len(set().union(*(r['card_pids'] for r in ranks))) > GROUP_RANKS + 1:
    problems.append(f'nvidia-smi listed {[r["card_pids"] for r in ranks]}')
  if not ranks[1]['plain_ok']:
    problems.append(f'kernel 3 at the actor batch disagrees with the plain '
                    f'path: {ranks[1]["plain_errs"]}')
  checked = (group_kernels(torch, ranks[1]['token_dim'])
             if ranks[1]['token_dim'] else [])
  row['kernels_at_rank_shapes'] = [
      {k: c[k] for k in ('name', 'batch', 'steps', 'max_abs_err', 'ok',
                         'sample_agreement', 'relative_errors',
                         'bit_equal_calls') if k in c} for c in checked]
  if len(checked) != 3 or not all(c['ok'] for c in checked):
    problems.append('kernels 5, 6 and 8 at a rank\'s shapes: ' + '; '.join(
        f'{c["name"]} at batch {c["batch"]}: {c["problems"]}'
        for c in checked) if checked else 'no token width from rank 1')
  emit(**row, ok=not problems)
  if problems:
    fail('parallel_group', '; '.join(problems))
  gc.collect()
  torch.cuda.empty_cache()
  return {k: [r['launches'][k] for r in ranks] for k in PARALLEL_KERNELS}


# The PPO and Director agents at their default configurations (each
# configs.yaml's `defaults`, no preset) on PinPad with 300-step episodes.
FAMILY_CALLS = 20  # policy calls of ENVS envs
FAMILY_STEPS = (1, 3)  # warm-up and timed train steps
# The JAX package's PPO learning check (tests/test_learning.py), on the
# card: 'dummy_bandit' rewards one fixed action of five; a random policy
# scores some 20 per 100-step episode, the best 99.
BANDIT = ['--configs', 'debug', '--torch.device', 'cuda',
          '--task', 'dummy_bandit', '--batch_size', '8',
          '--batch_length', '16', '--replay_context', '0',
          '--run.steps', '3000', '--run.train_ratio', '64',
          '--run.log_every', '2', '--run.report_every', '1e9',
          '--run.save_every', '1e9', '--run.envs', '4',
          '--replay.size', '4e3', '--agent.opt.lr', '3e-3',
          '--agent.opt.warmup', '20', '--agent.enc.impala.depth', '4',
          '--agent..*\\.units', '32']
BANDIT_SEED = 0
# The bandit run (some 100 s of small train steps, bound by the host)
# runs in a child interpreter (this script with --bandit) beside phase
# script, whose runs end on wall-clock budgets; phase ppo reads it.
BANDIT_TIMEOUT = 900


def start_bandit():
  """The bandit check's child interpreter, started now; its output (the
  run's log, then one JSON line with its episodes' scores) goes to a
  temporary file, which no pipe's buffer bounds. A run that fails before
  reading it still ends it. Returns (child, its output file, the time it
  started)."""
  import atexit
  import tempfile
  out = tempfile.TemporaryFile(mode='w+')
  child = subprocess.Popen(
      [sys.executable, os.path.join(ROOT, 'chip_smoke.py'), '--bandit'],
      stdout=out, stderr=subprocess.STDOUT, text=True)
  atexit.register(lambda: child.poll() is None and (
      child.kill(), child.wait()))
  return child, out, time.perf_counter()


def bandit_main():
  """The child of start_bandit (`chip_smoke.py --bandit`): PPO on
  dummy_bandit with the JAX test's settings, on the card."""
  import shutil
  import tempfile
  sys.path.insert(0, ROOT)
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.ppo import main as pmain
  logdir = tempfile.mkdtemp(prefix='smoke_bandit_')
  bandit = common.assemble_config(pmain.CONFIGS, BANDIT + [
      '--logdir', logdir, '--seed', str(BANDIT_SEED)])
  common.run_script(bandit, pmain.make_agent)
  scores = scores_of(logdir)
  shutil.rmtree(logdir, ignore_errors=True)
  print(json.dumps({'scores': scores}), flush=True)


def act_timed(agent, config, calls):
  """`calls` policy calls over ENVS envs of the config's task through a
  Driver; returns ms per call, the last carry and observations, and the
  count of actions out of their space."""
  import numpy as np
  from embodied_tpu_torch import core
  from embodied_tpu_torch.models import common
  driver = core.Driver(
      [lambda i=i: common.make_env(config, i) for i in range(ENVS)],
      parallel=False)
  times, last, bad = [], {}, [0]

  def policy(carry, obs, mode='train'):
    start = time.perf_counter()
    carry, act, out = agent.policy(carry, obs, mode)
    times.append((time.perf_counter() - start) * 1e3)
    for key, space in agent.act_space.items():
      a = act[key]
      bad[0] += int(((a < space.low) | (a >= space.high)).sum()
                    if space.discrete else (~np.isfinite(a)).sum())
    last.update(carry=carry, obs=obs)
    return carry, act, out
  driver.reset(agent.init_policy)
  driver(policy, steps=calls * ENVS)
  driver.close()
  return times, last, bad[0]


def family_loss(key):
  """The losses PPO and Director log: per term and per optimizer."""
  return key.startswith('loss/') or key.endswith(('/loss', '_loss'))


def run_main(torch, module, label, argv, budget, every):
  """main.main(argv) in-process on a wall-clock budget, with its env
  steps counted and its log read back. Returns the run's row and its
  problems."""
  import shutil
  logdir = os.path.join(ROOT, 'build', f'chip_smoke_{label}')
  shutil.rmtree(logdir, ignore_errors=True)
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  argv = [*argv, '--logdir', logdir, '--run.steps', str(STEP_CAP),
          '--run.duration', str(budget), '--run.log_every', str(every),
          '--run.report_every', str(every), '--run.save_every', str(every)]
  transports, ticks, restore = count_drivers()
  start = time.perf_counter()
  try:
    module.main(argv)
  finally:
    restore()
  wall = time.perf_counter() - start
  _, _, summary, losses = read_log(logdir, family_loss)
  row = dict(
      config=label, argv=argv, wall_s=wall, budget_s=budget,
      driver=transports[0], env_steps=ticks[0],
      env_steps_per_s=ticks[0] / wall,
      saved=os.path.exists(os.path.join(logdir, 'checkpoint.pkl')),
      last_losses=losses, episodes=summary,
      peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20)
  problems = []
  if not losses or not all(math.isfinite(v) for v in losses.values()):
    problems.append(f'logged losses {losses}')
  if not row['saved'] or row['driver'] != 'process':
    problems.append(f'saved {row["saved"]}, driver {row["driver"]}')
  shutil.rmtree(logdir, ignore_errors=True)
  return row, problems


def scores_of(logdir):
  with open(os.path.join(logdir, 'scores.jsonl')) as f:
    return [json.loads(line)['score'] for line in f if line.strip()]


def phase_ppo(torch, bandit):
  """PPO's default configuration (models/ppo/configs.yaml) on PinPad:
  its parameter count; FAMILY_CALLS policy calls of ENVS envs; train
  steps on a 16 x 65 batch collected by those policy calls; main.main
  `train` on a wall-clock budget with the process driver; and the JAX
  package's bandit learning check with its thresholds, from `bandit`
  (start_bandit's child, its output and the time it started). PPO
  reaches no kernel in this process: every count must stay 0."""
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.ppo import main as pmain
  wrappers = train_wrappers()
  for wrapper in wrappers.values():
    wrapper.launches = 0
  config = common.assemble_config(pmain.CONFIGS, PINPAD + HOST_PATH)
  agent = pmain.make_agent(config)
  params = sum(p.numel() for p in agent.model.parameters())
  times, _, bad = act_timed(agent, config, FAMILY_CALLS)
  steady = sorted(times[len(times) // 2:])
  problems = [f'{bad} actions out of their space'] if bad else []
  data, _ = collect_batch(agent, config)
  warmup, steps = FAMILY_STEPS
  carry, row, more = train_steps(
      torch, agent, data, wrappers, warmup, steps,
      {k: 0 for k in wrappers}, losses=family_loss, replay=False)
  problems += more
  _, row['profile'] = profile_train(torch, agent, carry, data,
                                    row['ms_per_train_step'])
  row.update(
      phase='ppo', path='ppo default pinpad', argv=PINPAD + HOST_PATH,
      parameters=params, envs=ENVS, policy_calls=len(times),
      first_call_ms=times[0], ms_per_policy_call=statistics.median(steady),
      ms_per_policy_call_max=steady[-1])
  del agent
  script, more = run_main(torch, pmain, 'ppo_pinpad', PINPAD, 20, 8)
  problems += more
  row['script'] = script
  # The bandit check: the JAX test's settings, on the card, in the child.
  child, log, start = bandit
  try:
    child.wait(timeout=max(1, BANDIT_TIMEOUT - (time.perf_counter() - start)))
  except subprocess.TimeoutExpired:
    child.kill()
    child.wait()
    fail('ppo', 'the bandit child timed out')
  log.seek(0)
  out = log.read()
  if child.returncode:
    fail('ppo', f'the bandit child failed ({child.returncode}): '
                f'{out[-2000:]}')
  scores = json.loads(out.strip().splitlines()[-1])['scores']
  quarter = max(3, len(scores) // 2 // 2)
  early = statistics.mean(scores[:quarter])
  late = statistics.mean(scores[-quarter:])
  row['bandit'] = dict(
      seed=BANDIT_SEED, episodes=len(scores), early=early, late=late,
      wall_s_since_start=time.perf_counter() - start)
  if not (len(scores) >= 10 and late > early + 10 and late > 40):
    problems.append(f'the bandit check: {row["bandit"]}')
  row['launches'] = {k: w.launches for k, w in wrappers.items()}
  if any(row['launches'].values()):
    problems.append(f'PPO launched a kernel: {row["launches"]}')
  row['ok'] = not problems
  emit(**row)
  if problems:
    fail('ppo', '; '.join(problems))


WM_ROOTS = ('enc', 'dyn', 'dec', 'rew', 'con')


def wm_grads(torch, agent, data):
  """Director's world-model gradients on `data` (its first window, from
  the agent's initial carry) through the kernels (kernel: auto) and the
  plain path (kernel: off), with the same draws: per store root, the
  relative error in norm and the plain norm; and whether the prior got no
  gradient on the plain path (every KL at the free-nats floor)."""
  from embodied_tpu_torch import nn
  model = agent.model
  B = data['is_first'].shape[0]
  batch = agent._take_batch(data)
  carry = nn.core.tree_map(agent._to_device, agent.init_train(B))
  dyn_carry, obs, prevact, _ = model._resume_window(carry, batch)
  params = nn.scope_params(model, model.WM)
  grads = {}
  for mode in ('auto', 'off'):
    model.dyn.kernel = mode
    gen = torch.Generator(agent.device).manual_seed(SEED + 2)
    loss, _ = model.wm_loss(dyn_carry, obs, prevact,
                            nn.dists.Draws(gen, agent.device))
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads[mode] = {k: torch.zeros_like(p) if g is None else g.float()
                   for (k, p), g in zip(params.items(), got)}
  model.dyn.kernel = 'auto'
  flat = lambda mode, root: torch.cat([
      g.reshape(-1) for k, g in grads[mode].items()
      if k.split('/')[0] == root])
  rel = {root: relerr(flat('auto', root), flat('off', root))
         for root in WM_ROOTS}
  norms = {root: float(flat('off', root).norm()) for root in WM_ROOTS}
  prior_zero = not any(bool(g.any()) for k, g in grads['off'].items()
                       if k.startswith('dyn/prior'))
  return rel, norms, prior_zero


def phase_director(torch):
  """Director's default configuration (models/director/configs.yaml) on
  PinPad, each path with the launch counts set to 0 just before and read
  just after: FAMILY_CALLS policy calls of ENVS envs, each launching
  kernel 3 once, held against the plain path; train steps on a 16 x 65
  batch collected by those calls (train_steps), each launching kernels 5
  and 6 once and kernel 1 once per step of the hierarchy's rollout
  (imag_length), the first step's losses against kernel: off, every
  trained parameter changed by the last step; and main.main `train_eval`
  on a wall-clock budget. Before the train steps, kernels 5 and 6 are held
  against their plain versions at Director's shapes (its token width, at
  GRAD_RTOL for the backward), and the world model's gradients through
  the kernels against kernel: off on the collected batch, per store root
  at GRAD_RTOL. Returns the launches."""
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.director import main as dmain
  wrappers = train_wrappers()
  config = common.assemble_config(dmain.CONFIGS, PINPAD + HOST_PATH)
  agent = dmain.make_agent(config)
  model = agent.model
  params = sum(p.numel() for p in model.parameters())
  for wrapper in wrappers.values():
    wrapper.launches = 0
  torch.cuda.reset_peak_memory_stats()
  times, last, bad = act_timed(agent, config, FAMILY_CALLS)
  acting = {k: w.launches for k, w in wrappers.items()}
  acting_peak = torch.cuda.max_memory_allocated() / 2 ** 20
  problems = [f'{bad} actions out of their space'] if bad else []
  if acting != dict({k: 0 for k in wrappers}, obs_step=len(times)):
    problems.append(f'{len(times)} policy calls launched {acting}')
  errs, same = check_against_plain(torch, agent, last, 0, 2)
  if not all(ok for _, ok in errs.values()):
    problems.append(f'kernel 3 disagrees with the plain path: {errs}')
  data, _ = collect_batch(agent, config)
  # Kernels 5 and 6 at the shapes of Director's window: its RSSM is
  # size12m's, its tokens PinPad's at Director's encoder width.
  dyn = model.dyn
  dims = dict(D=dyn.deter, H=dyn.hidden, S=dyn.stoch, K=dyn.token_dim)
  gen = torch.Generator(DEV).manual_seed(SEED + 3)
  flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device=DEV)
  core, head = size12m_params(torch, gen, dims['D'], dims['H'],
                              dims['S'] * dyn.classes, dyn.blocks,
                              dims['K'], dims['S'] * dyn.classes)
  window = window_kernels(torch, gen, core + head, flush,
                          T=config.batch_length, B=config.batch_size,
                          C=dyn.classes, config='director', **dims)
  del flush
  grad_rel, grad_norms, prior_zero = wm_grads(torch, agent, data)
  off = [k for k, e in grad_rel.items() if not e <= GRAD_RTOL]
  if off:
    problems.append(f'world-model gradients off the plain path: {grad_rel}')
  warmup, steps = FAMILY_STEPS
  per_step = dict({k: 0 for k in wrappers}, observe_seq=1,
                  observe_seq_bwd=1, core_step=config.agent.imag_length)
  for wrapper in wrappers.values():
    wrapper.launches = 0
  carry, row, more = train_steps(
      torch, agent, data, wrappers, warmup, steps, per_step,
      plain=plain_train, losses=family_loss,
      trained=model.WM + ('goal_enc', 'goal_dec') + model.AC,
      at_floor=lambda row: prior_zero, changed_after=warmup + steps - 1)
  problems += more
  train_launches = {k: w.launches for k, w in wrappers.items()}
  _, row['profile'] = profile_train(torch, agent, carry, data,
                                    row['ms_per_train_step'])
  steady = sorted(times[len(times) // 2:])
  row.update(
      phase='director', path='director default pinpad',
      argv=PINPAD + HOST_PATH, parameters=params, envs=ENVS,
      policy_calls=len(times), first_call_ms=times[0],
      ms_per_policy_call=statistics.median(steady),
      ms_per_policy_call_max=steady[-1], acting_launches=acting,
      acting_peak_mem_mb=acting_peak,
      plain_max_abs_err={k: e for k, (e, _) in errs.items()},
      sample_agreement=same, train_launches=train_launches,
      window_kernels={r['name']: dict(
          dims, max_abs_err=r['max_abs_err'], ms=r['ms'],
          plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
          **({'relative_errors': r['relative_errors']}
             if 'relative_errors' in r else {})) for r in window},
      wm_grad_relative_errors=grad_rel, wm_grad_norms=grad_norms,
      grad_rtol=GRAD_RTOL)
  dyn_classes = dyn.classes
  del agent, model, dyn
  script, more = run_main(torch, dmain, 'director_pinpad',
                          PINPAD + ['--script', 'train_eval'], 25, 10)
  problems += more
  row['script'] = script
  row['ok'] = not problems
  emit(**row)
  if problems:
    fail('director', '; '.join(problems))
  # Each kernel's launches on Director's path, with the shape it ran at
  # there (the `kernels` line's rows are measured at other shapes).
  size = f'D={dims["D"]}, H={dims["H"]}, {dims["S"]}x{dyn_classes} stoch'
  window = f'T={config.batch_length}, B={config.batch_size}, {size}, ' \
           f'K={dims["K"]} tokens'
  return dict(
      obs_step=(acting['obs_step'], f'B={ENVS}, {size}, K={dims["K"]} '
                                    'tokens'),
      observe_seq=(train_launches['observe_seq'], window),
      observe_seq_bwd=(train_launches['observe_seq_bwd'], window),
      core_step=(train_launches['core_step'],
                 f'B={config.batch_size * config.batch_length}, {size}'))


# The distributed phase: the default configuration on a process group of
# one NCCL rank (localhost coordinator), with the policy/train split.
DIST_ARGV = DEFAULT_ARGV + HOST_PATH + NO_COUNT + [
    '--torch.policy_mesh', '1,1,1']
DIST_STEPS = (1, 3)  # warm-up and timed train steps, with and without
DIST_CALLS = 20  # policy calls of ENVS envs on the split's copy
DIST_SEED = SEED + 5  # the noise of the steps held against each other
COLLECTIVES = ('all_reduce', 'all_gather', 'broadcast')


def free_port():
  import socket
  with socket.socket() as sock:
    sock.bind(('localhost', 0))
    return sock.getsockname()[1]


def counted_collectives(dist):
  """Replaces the collectives of torch.distributed with counting ones;
  returns the counts {name: [calls, bytes]} and a function that puts the
  originals back."""
  counts = {name: [0, 0] for name in COLLECTIVES}
  originals = {name: getattr(dist, name) for name in COLLECTIVES}

  def counting(name):
    def fn(tensor, *args, **kw):
      target = tensor if name != 'all_gather' else args[0]
      counts[name][0] += 1
      counts[name][1] += target.numel() * target.element_size()
      return originals[name](tensor, *args, **kw)
    return fn
  for name in COLLECTIVES:
    setattr(dist, name, counting(name))

  def restore():
    for name, fn in originals.items():
      setattr(dist, name, fn)
  return counts, restore


class AllowedDraws:
  """Draws from `draws` inside the agent's explicit host crossing: the
  recorded noise goes to the host, and recorded noise comes back to the
  card, which the sync guard refuses elsewhere in a train call."""

  def __init__(self, agent, draws):
    self.agent, self.draws = agent, draws

  def gumbel(self, shape):
    with self.agent._allowed():
      return self.draws.gumbel(shape)

  def normal(self, shape):
    with self.agent._allowed():
      return self.draws.normal(shape)


def fixed_draws(torch, agent, record=None):
  """Every train call of `agent` draws its noise from one generator seeded
  with DIST_SEED (recorded into `record`, a list, where given)."""
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.tools.dryrun_multidevice import RecordDraws

  def draws(kind, salt):
    gen = torch.Generator(agent.device).manual_seed(DIST_SEED)
    inner = nn.dists.Draws(gen, agent.device)
    if record is None:
      return inner
    recorder = RecordDraws(inner)
    recorder.recorded = record
    return AllowedDraws(agent, recorder)
  agent._draws = draws


def dist_step(torch, agent, data, state, group, record=None):
  """One train step from `state` on `data` with the fixed noise, on the
  data group `group` (None: without a process group). Returns the
  metrics, the trained parameters and the square moments (`opt/rms_flat`)
  after it on the card, and the collectives it made."""
  import torch.distributed as dist
  from embodied_tpu_torch import nn
  agent.load(state)
  agent.data_group = group
  fixed_draws(torch, agent, record)
  counts, restore = counted_collectives(dist)
  try:
    _, _, mets = agent.train(agent.init_train(len(data['is_first'])), data)
  finally:
    restore()
  params = {k: v.detach().clone() for k, v in nn.store(agent.model).items()
            if k.split('/')[0] in TRAINED or k == 'opt/rms_flat'}
  return mets, params, counts


def update_errors(torch, before, got, want):
  """Per trained tensor, the relative error in norm of the update (after
  - before) of `got` against `want`."""
  return {k: relerr(got[k] - before[k], want[k] - before[k])
          for k in before if bool((want[k] != before[k]).any())}


# Another summation order (two ranks' halves, the kernels at 8 rows): the
# first step past the warm-up from zero moments moves each entry by
# 2.5 lr times the sign of its gradient, so an entry whose gradient sits
# near zero may take the other sign, as tests/test_torch_slice.py finds
# between JAX and the port. Each tensor's updates must agree within 1% in
# this share of its entries, and the gradients' magnitudes, read from the
# square moments ((1 - beta2) g^2 after that step), within GRAD_RTOL.
UPDATE_AGREEMENT = 0.99


def opt_layout(agent):
  """{path: size} of the optimizer's parameters in its flat order."""
  return {k: v.numel() for k, v in agent.model.opt.params.items()}


def two_rank_errors(torch, layout, before, got, want):
  """(per trained tensor: the share of entries whose update agrees, the
  relative error of |gradient|) of `got` against `want`; `layout` is
  opt_layout's."""
  agree, grads, offset = {}, {}, 0
  for path, n in layout.items():
    if path in before:
      mine, theirs = got[path] - before[path], want[path] - before[path]
      agree[path] = float(((mine - theirs).abs() <= 1e-2 * theirs.abs())
                          .float().mean())
    grads[path] = relerr(got['opt/rms_flat'][offset:offset + n].sqrt(),
                         want['opt/rms_flat'][offset:offset + n].sqrt())
    offset += n
  return agree, grads


def split_check(torch, agent, last):
  """The split's copy and the trained model, each through kernel 3, on
  one observe step with the same carry, inputs and noise: the copy's
  launches and each of deter and logit against the model's."""
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.nn import dists
  from embodied_tpu_torch.ops import observe
  carry = nn.core.tree_map(agent._to_device, last['carry'])
  obs = {k: agent._to_device(v) for k, v in last['obs'].items()}
  dyn = agent.model.dyn
  gen = torch.Generator(agent.device).manual_seed(SEED + 1)
  noise = dists.gumbel((len(obs['is_first']), dyn.stoch, dyn.classes), gen,
                       agent.device)
  outs, launches = {}, {}
  with torch.inference_mode():
    for label, model in (('copy', agent._policy_model()),
                         ('model', agent.model)):
      start = observe.obs_step.launches
      _, _, tokens = model.enc({}, obs, obs['is_first'], single=True)
      _, _, outs[label] = model.dyn.observe(
          carry[1], tokens, carry[3], obs['is_first'], noise=noise)
      launches[label] = observe.obs_step.launches - start
  errs = {k: compare(torch, outs['copy'][k], outs['model'][k])
          for k in ('deter', 'logit')}
  return errs, launches


def ranks_2(torch, agent, data, record, reference, mets, before_path):
  """Two NCCL ranks on two cards, each on half of the batch's rows with its
  rows of the recorded noise, against the one-rank step (`reference`:
  its trained parameters and square moments; `mets`: its metrics): the
  losses at LOSS_RTOL, two_rank_errors, and the two ranks' stores equal.
  Returns (row, problems)."""
  import multiprocessing
  import pickle
  import shutil
  import tempfile
  folder = tempfile.mkdtemp(prefix='smoke_ranks2_')
  rows = len(data['is_first']) // 2
  with open(os.path.join(folder, 'inputs.pkl'), 'wb') as f:
    pickle.dump(dict(argv=DIST_ARGV, rows=rows, data=data, record=record,
                     before=before_path), f)
  port = free_port()
  context = multiprocessing.get_context('spawn')
  procs = [context.Process(target=rank_2_main, args=(r, port, folder))
           for r in range(2)]
  for proc in procs:
    proc.start()
  for proc in procs:
    proc.join(600)
  failed = [p.exitcode for p in procs if p.exitcode]
  for proc in procs:
    if proc.is_alive():
      proc.kill()
      proc.join()
  if failed or any(p.exitcode is None for p in procs):
    return None, [f'ranks exited with {[p.exitcode for p in procs]}']
  before = torch.load(before_path)
  got = [torch.load(os.path.join(folder, f'rank{r}.pt')) for r in range(2)]
  shutil.rmtree(folder, ignore_errors=True)
  shutil.rmtree(os.path.dirname(before_path), ignore_errors=True)
  agree, grads = two_rank_errors(
      torch, opt_layout(agent), before, got[0]['params'],
      {k: v.cpu() for k, v in reference.items()})
  losses, bad = check_losses(got[0]['mets'], mets)
  row = dict(losses=losses, update_agreement_min=min(agree.values()),
             grad_relerr_max=max(grads.values()),
             same_store=got[0]['sums'] == got[1]['sums'])
  problems = [f'two ranks\' losses off one\'s: {bad}'] if bad else []
  low = sorted(k for k, a in agree.items() if not a >= UPDATE_AGREEMENT)
  off = sorted(k for k, e in grads.items() if not e <= GRAD_RTOL)
  if low or off:
    problems.append(f'two ranks off one: updates {low[:5]}, grads {off[:5]}')
  if not row['same_store']:
    problems.append('the two ranks hold different stores')
  return row, problems


def rank_2_main(rank, port, folder):
  """One of ranks_2's two ranks (a spawned process)."""
  import importlib
  import pickle
  import torch
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  from embodied_tpu_torch.tools.dryrun_multidevice import RankDraws, rows
  os.environ.update(RANK=str(rank), WORLD_SIZE='2', LOCAL_RANK=str(rank))
  with open(os.path.join(folder, 'inputs.pkl'), 'rb') as f:
    inputs = pickle.load(f)
  count = inputs['rows']
  config = common.assemble_config(dmain.CONFIGS, inputs['argv'] + [
      '--batch_size', str(count),
      '--torch.coordinator_address', f'localhost:{port}'])
  agent = dmain.make_agent(config)
  # (a)'s store: the same seed's, past the warm-up.
  agent.model.opt.step.fill_(int(config.agent.opt.warmup))
  before = torch.load(inputs['before'])
  index = agent.mesh.data_index
  draws = AllowedDraws(
      agent, RankDraws(inputs['record'], index, 2, agent.device))
  agent._draws = lambda kind, salt: draws
  _, _, mets = agent.train(
      agent.init_train(count), rows(inputs['data'], index, count))
  store = nn.store(agent.model)
  out = {'mets': mets, 'sums': [float(store[k].double().sum())
                                for k in sorted(store)]}
  if rank == 0:
    out['params'] = {k: store[k].detach().cpu() for k in before}
    out['params']['opt/rms_flat'] = store['opt/rms_flat'].detach().cpu()
  torch.save(out, os.path.join(folder, f'rank{rank}.pt'))
  importlib.import_module('embodied_tpu_torch.parallel.setup').shutdown()


# The sharded check of the distributed phase: the default configuration on
# two ranks of 8 rows, torch.mesh '1,2,1' (each rank holds half of every
# kernel and embedding) against '2,1,1' (replicated), from one seed's
# store past the warm-up, on one batch: SHARD_STEPS train steps each, then
# SHARD_CALLS policy calls and a save. Then '1,1,2': both ranks on all 16
# rows, splitting the products of the kernels and embeddings that the
# placements shard over 't' (parallel/tensor.py), under (a)'s noise. Two
# NCCL ranks on two cards where the machine has them, else two gloo ranks
# on one card: gloo stages a CUDA tensor through host memory and waits for
# it, which the sync guard refuses, so those ranks run with
# torch.transfer_guard False.
SHARD_ARGV = DEFAULT_ARGV + HOST_PATH + NO_COUNT
SHARD_MESHES = ('1,2,1', '2,1,1', '1,1,2')
SHARD_STEPS = 3  # the first is the warm-up, each is held against the other
SHARD_CALLS = 5
SHARD_ROWS = 8  # a rank's at '1,2,1' and '2,1,1'
SPLIT_MESH = '1,1,2'
SPLIT_ROWS = 2 * SHARD_ROWS  # (a)'s batch, on each rank at '1,1,2'


def sharded_check(torch, data, reference):
  """Runs sharded_rank_main on two ranks; returns (row, problems, the
  launches of kernels 3, 5, 6 and 8 in the '1,2,1' and '1,1,2' runs).
  `reference` is (a)'s one-rank step: its metrics (`mets`), the trained
  tensors before it (`before`) and after it with the square moments
  (`params`), and the optimizer's layout (`layout`)."""
  import multiprocessing
  import pickle
  import shutil
  import tempfile
  from embodied_tpu_torch.tools.dryrun_multidevice import default_bytes
  backend = 'nccl' if torch.cuda.device_count() >= 2 else 'gloo'
  folder = tempfile.mkdtemp(prefix='smoke_sharded_')
  with open(os.path.join(folder, 'inputs.pkl'), 'wb') as f:
    pickle.dump(dict(data=data), f)
  port = free_port()
  context = multiprocessing.get_context('spawn')
  procs = [context.Process(target=sharded_rank_main,
                           args=(r, port, folder, backend))
           for r in range(2)]
  for proc in procs:
    proc.start()
  for proc in procs:
    proc.join(600)
  for proc in procs:
    if proc.is_alive():
      proc.kill()
      proc.join()
  codes = [p.exitcode for p in procs]
  if any(codes):
    shutil.rmtree(folder, ignore_errors=True)
    return dict(backend=backend, exit_codes=codes), [
        f'sharded ranks exited with {codes}'], {}
  ranks = []
  for r in range(2):
    with open(os.path.join(folder, f'rank{r}.pkl'), 'rb') as f:
      ranks.append(pickle.load(f))
  first = torch.load(os.path.join(folder, 'split_first_step.pt'))
  shutil.rmtree(folder, ignore_errors=True)
  want = {mesh: default_bytes(mesh) for mesh in SHARD_MESHES}
  per_rank = lambda key: {m: [r[m][key] for r in ranks]
                          for m in SHARD_MESHES}
  row = dict(
      backend=backend, devices=[r['device'] for r in ranks],
      transfer_guard=backend == 'nccl',
      seconds_ranks=max(r['seconds'] for r in ranks),
      store_bytes=per_rank('bytes'),
      store_bytes_expected={m: want[m]['placements'] for m in SHARD_MESHES},
      collectives_per_step=per_rank('collectives'),
      collective_bytes_per_step=per_rank('collective_bytes'),
      ms_per_train_step=per_rank('ms'),
      ms_per_train_step_median={m: statistics.median(
          t for r in ranks for t in r[m]['ms']) for m in SHARD_MESHES},
      peak_mem_mb=per_rank('peak_mem_mb'),
      losses={m: ranks[0][m]['losses'] for m in SHARD_MESHES},
      launches=per_rank('launches'),
      policy_launches=per_rank('policy_launches'),
      policy_collectives=per_rank('policy_collectives'),
      mets_differ=[r['mets_differ'] for r in ranks],
      store_differ=[r['store_differ'] for r in ranks],
      store_max_abs_diff=[r['store_max_abs_diff'] for r in ranks])
  problems = []
  for mesh in SHARD_MESHES:
    for rank, held in enumerate(row['store_bytes'][mesh]):
      total = held['sharded'] + held['replicated']
      if total != held['placements'] or total != want[mesh]['placements']:
        problems.append(f'rank {rank} at {mesh} holds {held}, the '
                        f'placements give {want[mesh]["placements"]}')
      copy = want[mesh]['policy_copy'] if mesh != '2,1,1' else 0
      if held['policy_copy'] != copy:
        problems.append(f'rank {rank} at {mesh}: a policy copy of '
                        f'{held["policy_copy"]} B, not {copy}')
  extra = dict(row['collectives_per_step']['2,1,1'][0])
  extra['all_gather'] += 1
  if row['collectives_per_step']['1,2,1'][0] != extra:
    problems.append(f'the sharded step made {row["collectives_per_step"]}')
  for rank in range(2):
    if row['mets_differ'][rank] or row['store_differ'][rank]:
      problems.append(
          f'rank {rank}: the sharded step off the replicated one: metrics '
          f'{row["mets_differ"][rank][:5]}, store '
          f'{row["store_differ"][rank][:5]}')
  for mesh in SHARD_MESHES:
    if row['launches'][mesh] != [{k: SHARD_STEPS for k in TRAIN_KERNELS}] * 2:
      problems.append(f'{mesh}: launches {row["launches"][mesh]}')
  for mesh in ('1,2,1', SPLIT_MESH):
    if row['policy_launches'][mesh] != [SHARD_CALLS] * 2 or any(
        row['policy_collectives'][mesh]):
      problems.append(f'{mesh}: policy calls on the copy: kernel 3 '
                      f'{row["policy_launches"][mesh]}, collectives '
                      f'{row["policy_collectives"][mesh]}')
  row['split'], more = split_rows(torch, ranks, first, reference)
  problems += more
  launches = {mesh: dict(ranks[0][mesh]['launches'],
                         obs_step=ranks[0][mesh]['policy_launches'])
              for mesh in ('1,2,1', SPLIT_MESH)}
  return row, problems, launches


def split_rows(torch, ranks, first, reference):
  """The '1,1,2' run's rows and checks: each rank's FLOPs, split entries
  and their share of the products; the ranks' metrics and saves equal
  bit for bit; the first step against (a)'s one-rank step (losses at
  LOSS_RTOL, updates and gradients as two_rank_errors says); kernels 5,
  6 and 8 at a rank's shapes against their plain versions."""
  got = [r[SPLIT_MESH] for r in ranks]
  row = {key: [g[key] for g in got] for key in (
      'train_flops', 'train_flops_one_rank', 'split_flops',
      'split_entries', 'split_share')}
  problems = []
  for rank, g in enumerate(got):
    t = len(ranks)
    if g['train_flops'] != g['train_flops_one_rank'] - (
        t - 1) * g['split_flops'] // t:
      problems.append(f'rank {rank} counts {g["train_flops"]} FLOPs, one '
                      f'rank {g["train_flops_one_rank"]}, the split '
                      f'products {g["split_flops"]}')
    if not g['split_entries'] or not 0 < g['split_share'] < 1:
      problems.append(f'rank {rank}: {g["split_entries"]} split entries, '
                      f'a share of {g["split_share"]}')
  row['mets_equal'] = got[0]['mets'] == got[1]['mets']
  row['saves_equal'] = got[0]['digests'] == got[1]['digests']
  if not row['mets_equal'] or not row['saves_equal']:
    problems.append(f'the {SPLIT_MESH} ranks differ: metrics equal '
                    f'{row["mets_equal"]}, saves equal {row["saves_equal"]}')
  row['losses_vs_one_rank'], bad = check_losses(
      first['mets'], reference['mets'])
  agree, grads = two_rank_errors(
      torch, reference['layout'], reference['before'], first['params'],
      reference['params'])
  row.update(update_agreement_min=min(agree.values()),
             grad_relerr_max=max(grads.values()))
  low = sorted(k for k, a in agree.items() if not a >= UPDATE_AGREEMENT)
  off = sorted(k for k, e in grads.items() if not e <= GRAD_RTOL)
  if bad or low or off:
    problems.append(f'{SPLIT_MESH} off one rank: losses {bad}, updates '
                    f'{low[:5]}, grads {off[:5]}')
  checked = group_kernels(torch, got[0]['token_dim'], B=SPLIT_ROWS)
  row['kernels_at_rank_shapes'] = [
      {k: c[k] for k in ('name', 'batch', 'steps', 'max_abs_err', 'ok',
                         'sample_agreement', 'relative_errors',
                         'bit_equal_calls') if k in c} for c in checked]
  if len(checked) != 3 or not all(c['ok'] for c in checked):
    problems.append(f'kernels 5, 6 and 8 at a {SPLIT_MESH} rank\'s shapes: '
                    + '; '.join(f'{c["name"]} at batch {c["batch"]}: '
                                f'{c["problems"]}' for c in checked))
  return row, problems


def digests(store):
  """{key: crc32 of the array's bytes} of a saved store."""
  import zlib
  import numpy as np
  return {k: zlib.crc32(np.ascontiguousarray(v).view(np.uint8))
          for k, v in store.items()}


def sharded_rank_main(rank, port, folder, backend):
  """One rank of sharded_check (a spawned process): the default
  configuration at each of SHARD_MESHES, one agent after the other on
  one process group."""
  import importlib
  import pickle
  import numpy as np
  import torch
  import torch.distributed as dist
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  from embodied_tpu_torch.ops import observe
  from embodied_tpu_torch.tools.dryrun_multidevice import rows
  began = time.perf_counter()
  local = rank if backend == 'nccl' else 0
  os.environ.update(RANK=str(rank), WORLD_SIZE='2', LOCAL_RANK=str(local))
  with open(os.path.join(folder, 'inputs.pkl'), 'rb') as f:
    data = pickle.load(f)['data']
  if backend == 'gloo':
    import datetime
    torch.cuda.set_device(local)
    dist.init_process_group(
        'gloo', init_method=f'tcp://localhost:{port}', rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=600))
    extra = ['--torch.transfer_guard', 'False']
  else:
    extra = ['--torch.coordinator_address', f'localhost:{port}']
  wrappers = train_wrappers()
  out = {'device': torch.cuda.get_device_name(local)}
  saves, mets_all = {}, {}
  for mesh in SHARD_MESHES:
    split = mesh == SPLIT_MESH
    count = SPLIT_ROWS if split else SHARD_ROWS
    config = common.assemble_config(dmain.CONFIGS, SHARD_ARGV + extra + [
        '--batch_size', str(count), '--torch.mesh', mesh])
    agent = dmain.make_agent(config)
    agent.model.opt.step.fill_(int(config.agent.opt.warmup))
    batch = rows(data, agent.mesh.data_index, count)
    row = {}
    if split:
      # (a)'s noise in every step, so that the first is (a)'s step.
      fixed_draws(torch, agent)
      cost = agent.train_cost()
      held, agent._split = agent._split, frozenset()
      whole = agent.train_cost()['flops']
      agent._split = held
      # The split products: t times the rank's parts.
      split_flops = agent.mesh.t_count * cost['split_flops']
      row.update(
          train_flops=cost['flops'], train_flops_one_rank=whole,
          split_flops=split_flops, split_entries=len(agent._split),
          split_share=split_flops / whole,
          token_dim=agent.model.dyn.token_dim)
    for wrapper in wrappers.values():
      wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats(agent.device)
    carry, times, mets_all[mesh] = agent.init_train(count), [], []
    for step in range(SHARD_STEPS):
      torch.cuda.synchronize(agent.device)
      start = time.perf_counter()
      if step == 0:
        counts, restore = counted_collectives(dist)
      carry, _, mets = agent.train(carry, batch)
      torch.cuda.synchronize(agent.device)
      if step == 0:
        restore()
      else:
        times.append((time.perf_counter() - start) * 1e3)
      mets_all[mesh].append(mets)
      if split and step == 0:
        store = agent.save()['store']  # a collective: both ranks save
        if rank == 0:
          # Copies: the saved arrays are views of larger buffers.
          torch.save(dict(mets={
              k: float(v) for k, v in mets.items() if is_loss(k)}, params={
              k: torch.from_numpy(v).clone() for k, v in store.items()
              if k.split('/')[0] in TRAINED or k == 'opt/rms_flat'}),
                     os.path.join(folder, 'split_first_step.pt'))
        del store
        dist.barrier()  # rank 1's next timed step waits for no write
    row.update(
        ms=times, collectives={k: v[0] for k, v in counts.items()},
        collective_bytes={k: v[1] for k, v in counts.items()},
        bytes=agent.store_bytes(),
        peak_mem_mb=torch.cuda.max_memory_allocated(agent.device) / 2**20,
        losses={k: v for k, v in mets_all[mesh][0].items() if is_loss(k)},
        launches={k: wrappers[k].launches for k in TRAIN_KERNELS})
    obs = {k: batch[k][:, 0] for k in agent.obs_space}
    observe.obs_step.launches = 0
    counts, restore = counted_collectives(dist)
    try:
      policy = agent.init_policy(count)
      for _ in range(SHARD_CALLS):
        policy, _, _ = agent.policy(policy, obs)
    finally:
      restore()
    row.update(policy_launches=observe.obs_step.launches,
               policy_collectives={k: v[0] for k, v in counts.items()
                                   if v[0]})
    saves[mesh] = agent.save()['store']
    if split:
      row.update(mets=mets_all[mesh], digests=digests(saves[mesh]))
      del saves[mesh]
    out[mesh] = row
    del agent, carry, policy
    gc.collect()
    torch.cuda.empty_cache()
  got, want = saves['1,2,1'], saves['2,1,1']
  out['store_differ'] = sorted(
      k for k in want if not np.array_equal(got[k], want[k]))
  out['store_max_abs_diff'] = max(
      [float(np.abs(got[k].astype(np.float64) - want[k]).max())
       for k in out['store_differ']] or [0.0])
  out['mets_differ'] = sorted(
      f'{i}:{k}' for i, (a, b) in enumerate(zip(
          mets_all['1,2,1'], mets_all['2,1,1']))
      for k in b if not np.array_equal(a[k], b[k]))
  out['seconds'] = time.perf_counter() - began
  with open(os.path.join(folder, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)
  importlib.import_module('embodied_tpu_torch.parallel.setup').shutdown()


def phase_distributed(torch):
  """The default configuration (202,982,304 parameters) on a process
  group: parallel.setup starts one NCCL rank at a localhost coordinator
  (torch.mesh '-1,1,1'), with the policy/train split (torch.policy_mesh
  '1,1,1') on the card.
  (a) one step from one store (past the warm-up, so that it moves the
      parameters), batch and noise with and without the group: losses at
      LOSS_RTOL, every trained tensor's update at GRAD_RTOL; the
      collectives of a step and the bytes they move; then 1 + 3 train
      steps in each of four turns, with the group, without, without, with
      (each step launching kernels 5, 6 and 8 once): ms per step, the
      mean of each side's two turns' medians.
  (b) policy calls on the split's copy (kernel 3 once each); the copy's
      deter and logit against the trained model's on one observe step;
      after a train step the copy is stale until the next policy call,
      which refreshes it to the trained weights: its bytes and the
      refresh's ms.
  (c) where the machine has two cards, two NCCL ranks of 8 rows each
      against (a)'s one-rank step (losses at LOSS_RTOL, updates and
      gradients as two_rank_errors says, the ranks' stores equal); else
      "not run: 1 card".
  (d) the sharded store (sharded_check): two ranks of 8 rows of (a)'s
      batch at torch.mesh '1,2,1' and then at '2,1,1', NCCL on two cards
      or gloo on one (the row's `backend`): each rank's store bytes
      between calls against the placements' (counted on the meta
      device), the policy copy's bytes, the collectives of a step and
      their bytes, ms per step; the metrics of every step and the saved
      (gathered) store at '1,2,1' equal to those at '2,1,1' bit for bit;
      kernels 5, 6 and 8 once a step, kernel 3 once a policy call on the
      copy, which makes no collective. Then '1,1,2' (row key `split`):
      both ranks on all 16 rows, splitting the products over 't'
      (parallel/tensor.py) under (a)'s noise: the same rows per rank,
      and each rank's train FLOPs against the one-rank count, its split
      entries and their share of the products; the two ranks' metrics
      and saves equal bit for bit; the first step against (a)'s
      one-rank step (losses at LOSS_RTOL, updates and gradients as
      two_rank_errors says); kernels 5, 6 and 8 once a step and, at a
      rank's shapes, against their plain versions; kernel 3 once a
      policy call on the copy, with no collective.
  Returns the launches of kernels 3, 5, 6 and 8, and those of (d)'s
  '1,2,1' and '1,1,2' runs."""
  import importlib
  import numpy as np
  import torch.distributed as dist
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  from embodied_tpu_torch.ops import observe
  setuplib = importlib.import_module('embodied_tpu_torch.parallel.setup')
  # The phases before ran parallel.setup without a group.
  setuplib._DONE[0] = False
  os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0')
  argv = DIST_ARGV + ['--torch.coordinator_address',
                      f'localhost:{free_port()}']
  config = common.assemble_config(dmain.CONFIGS, argv)
  start = time.perf_counter()
  agent = dmain.make_agent(config)
  row = dict(phase='distributed', argv=argv, setup_s=time.perf_counter() -
             start, backend=dist.get_backend(), world=dist.get_world_size(),
             mesh=agent.mesh.sizes, parameters=sum(
                 p.numel() for p in agent.model.parameters()))
  problems = []
  if row['backend'] != 'nccl' or row['world'] != 1 or (
      agent.data_group is None):
    fail('distributed', f'no one-rank NCCL data group: {row}')
  group = agent.data_group
  wrappers = train_wrappers()
  for wrapper in wrappers.values():
    wrapper.launches = 0
  times, last, bad = act_timed(agent, config, DIST_CALLS)
  split_launches = observe.obs_step.launches
  if split_launches != len(times) or bad:
    problems.append(f'{len(times)} policy calls on the copy launched '
                    f'{split_launches} of kernel 3, {bad} bad actions')
  data, _ = collect_batch(agent, config)
  state = agent.save()
  state['store']['opt/step'] = np.int32(config.agent.opt.warmup)
  before = {k: torch.tensor(v, device=agent.device)
            for k, v in state['store'].items()
            if k.split('/')[0] in TRAINED}
  # The one-rank step's noise, for the two-rank check.
  record = [] if torch.cuda.device_count() >= 2 else None
  mets_g, params_g, counts = dist_step(torch, agent, data, state, group,
                                       record)
  mets_n, params_n, none_counts = dist_step(torch, agent, data, state, None)
  row['losses_group_vs_none'], bad = check_losses(mets_g, mets_n)
  if bad:
    problems.append(f'losses with the group off those without: {bad}')
  upd = update_errors(torch, before, params_g, params_n)
  row['update_relerr_max'] = max(upd.values())
  row['updated_tensors'] = len(upd)
  off = sorted(k for k, e in upd.items() if not e <= GRAD_RTOL)
  if off or len(upd) < len(before) // 2:
    problems.append(f'updates with the group off: {off[:5]}, '
                    f'{len(upd)} of {len(before)} tensors moved')
  row['collectives_per_step'] = {k: v[0] for k, v in counts.items()}
  row['collective_bytes_per_step'] = {k: v[1] for k, v in counts.items()}
  if any(v[0] for v in none_counts.values()):
    problems.append(f'collectives without the group: {none_counts}')
  if not counts['all_reduce'][0]:
    problems.append('the step with the group made no all-reduce')
  # Timed steps through Agent.train in turns (group, none, none, group),
  # each turn with the launch counts set to 0 before it and read after.
  del agent._draws  # The agent's own noise again.
  per_step = {k: 1 for k in TRAIN_KERNELS}
  turns = []
  for label in ('group', 'none', 'none', 'group'):
    agent.load(state)
    agent.data_group = group if label == 'group' else None
    for wrapper in wrappers.values():
      wrapper.launches = 0
    _, timed, more = train_steps(
        torch, agent, data, wrappers, *DIST_STEPS, per_step)
    problems += [f'{label}: {m}' for m in more]
    turns.append((label, timed['ms_per_train_step']))
    if label == 'group':
      dp_launches = {k: w.launches for k, w in wrappers.items()}
      row['peak_mem_mb_group'] = timed['peak_mem_mb']
  ms = lambda side: statistics.mean(t for l, t in turns if l == side)
  row.update(
      ms_per_train_step_group=ms('group'), ms_per_train_step_none=ms('none'),
      ms_per_train_step_turns=turns, dp_launches=dp_launches,
      launches_per_step=per_step)
  # (b) The split: stale after a train step, refreshed by the next call.
  agent.data_group = group
  if not agent._policy_dirty:
    problems.append('a train step left the policy copy clean')
  torch.cuda.synchronize()
  start = time.perf_counter()
  agent._policy_model()
  torch.cuda.synchronize()
  row['policy_copy_refresh_ms'] = (time.perf_counter() - start) * 1e3
  row['policy_copy_bytes'] = agent.policy_copy_bytes
  stale = [k for k, (src, dst) in enumerate(agent._policy_pairs)
           if not torch.equal(src, dst)]
  if stale:
    problems.append(f'{len(stale)} copied tensors differ after a refresh')
  errs, launches = split_check(torch, agent, last)
  row.update(split_vs_model_max_abs_err={k: e for k, (e, _) in
                                         errs.items()},
             split_check_launches=launches,
             split_policy_calls=len(times),
             ms_per_split_policy_call=statistics.median(
                 sorted(times[len(times) // 2:])))
  if not all(ok for _, ok in errs.values()) or launches != dict(
      copy=1, model=1):
    problems.append(f'the copy off the model: {errs}, launches {launches}')
  # (c) Two ranks, on a machine with two cards.
  if torch.cuda.device_count() >= 2:
    import tempfile
    path = os.path.join(tempfile.mkdtemp(prefix='smoke_before_'), 'b.pt')
    torch.save({k: v.cpu() for k, v in before.items()}, path)
    row['ranks_2'], more = ranks_2(torch, agent, data, record, params_g,
                                   mets_g, path)
    problems += more
  else:
    row['ranks_2'] = 'not run: 1 card'
  setuplib.shutdown()
  reference = dict(
      mets=mets_g, layout=opt_layout(agent),
      before={k: v.cpu() for k, v in before.items()},
      params={k: v.cpu() for k, v in params_g.items()})
  del agent, before, params_g
  gc.collect()
  torch.cuda.empty_cache()
  # (d) The sharded store: two ranks at '1,2,1' against '2,1,1', then the
  # split at '1,1,2' against (a)'s one-rank step.
  row['sharded'], more, sharded = sharded_check(torch, data, reference)
  del reference
  problems += more
  row['ok'] = not problems
  emit(**row)
  if problems:
    fail('distributed', '; '.join(problems))
  return dict(obs_step=split_launches, **{
      k: dp_launches[k] for k in TRAIN_KERNELS}), sharded


# The diagnostics phase: the default configuration as it runs by default
# (the latent table, fetch_depth 3, the sync guard, precompile) with the
# profiler window on. DIAG_STEPS train calls: the first on a host-path
# batch, held against an agent that never counted its FLOPs; the window
# traces updates 100-119 and the 120th call ends it.
DIAG_STEPS = 120
DIAG_TIMED = (20, 100)  # train updates whose CUDA-event times are read
DIAG_WINDOW = 20  # updates the profiler window traces
# The products of kernels 5, 6 and 8 alone, from their bounds in the
# kernel table at 989 TFLOP/s: 1.83e11 + 3.65e11 (the backward, without
# its recompute) + 2.87e12.
FLOPS_FLOOR = 3.4e12
DET_ARGV = ['--configs', 'size1m', '--task', 'dummy_disc',
            '--torch.fetch_depth', '0', '--torch.deterministic', 'True',
            '--torch.precompile', 'False']
DET_TIMEOUT = 600


def diag_batch(agent, seed):
  """A host-path batch (the latents ride it, no slots) of the agent's
  keys, its observations drawn from `seed`."""
  import numpy as np
  rng = np.random.default_rng(seed)
  data = agent._example_batch(
      agent.config.batch_size, agent.batch_length + agent.replay_context,
      spaces=agent.model.ext_space)
  for key, value in data.items():
    if key in agent.obs_space and value.dtype == np.uint8:
      data[key] = rng.integers(0, 256, value.shape, np.uint8)
    elif key in agent.obs_space and value.dtype == np.float32:
      data[key] = rng.normal(size=value.shape).astype(np.float32)
  return data


def same_stores(torch, got, want):
  """Keys of the two {key: tensor} stores whose values differ in a bit."""
  return sorted(k for k in want if k not in got or not torch.equal(
      got[k], want[k]))


def planted_sync(torch, agent):
  """A `.item()` inside the Agent's guard scope on the card must raise,
  and inside its explicit crossing must not."""
  value = torch.ones((), device=agent.device)
  raised = None
  with agent._checked():
    try:
      value.item()
    except RuntimeError as e:
      raised = str(e).splitlines()[0][:120]
    with agent._allowed():
      allowed = value.item()
  return dict(guard_raised=raised, allowed_value=allowed,
              guard_on=agent._syncs is not None)


def deterministic_main():
  """The child of phase diagnostics (`chip_smoke.py --deterministic`):
  size1m under torch.deterministic, two train steps from one store and
  one batch, and a step on the latent table; prints one JSON line."""
  import torch
  sys.path.insert(0, ROOT)
  from embodied_tpu_torch import nn
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  import tempfile
  config = common.assemble_config(dmain.CONFIGS, DET_ARGV + [
      '--logdir', tempfile.mkdtemp(prefix='smoke_det_')])
  agent = dmain.make_agent(config)
  row = dict(enabled=torch.are_deterministic_algorithms_enabled(),
             cublas=os.environ.get('CUBLAS_WORKSPACE_CONFIG'))
  data = diag_batch(agent, SEED + 7)
  state = agent.save()
  stores, metrics = [], []
  for _ in range(2):
    agent.load(state)
    _, _, mets = agent.train(agent.init_train(agent.config.batch_size), data)
    stores.append({k: v.clone() for k, v in nn.store(agent.model).items()})
    metrics.append(mets)
  row['store_entries'] = len(stores[0])
  row['differing_entries'] = same_stores(torch, stores[1], stores[0])
  row['differing_metrics'] = sorted(
      k for k in metrics[0] if not metrics[0][k] == metrics[1][k])
  table, _ = collect_batch(agent, config)
  _, _, mets = agent.train(agent.init_train(agent.config.batch_size), table)
  row['table_step_finite'] = all(math.isfinite(v) for v in mets.values())
  print(json.dumps(row), flush=True)


def phase_diagnostics(torch):
  """The Agent's diagnostics at the default configuration (202,982,304
  parameters) on dummy_disc, through make_agent with the defaults:
  (a) the FLOP count: an agent built with precompile on prints its
      train step's FLOPs; train_cost under kernel: auto equals it under
      kernel: off and exceeds FLOPS_FLOOR; the first train step after it
      equals that of an agent that never counted, bit for bit;
  (b) the profiler window: DIAG_STEPS train calls on a batch collected by
      the policy (kernel 3), each launching kernels 5, 6 and 8 once, with
      the launch counts set to 0 before and read after; ms_per_train_step
      is the median CUDA-event time of updates DIAG_TIMED, untraced, and
      with train_cost's FLOPs gives TFLOP/s and MFU against the card's
      dense bf16 peak; the port's viewer reads the window's trace, which
      must hold DIAG_WINDOW launches of each of kernels 5, 6 and 8;
  (c) transfer_guard, on by default under every phase: a planted .item()
      in the Agent's guard scope raises, in its explicit crossing not;
  (d) deterministic, in a child interpreter (CUBLAS_WORKSPACE_CONFIG must
      precede the process's first cuBLAS handle) that runs beside the end
      of (b): two size1m train steps from one store and batch give the
      same store bit for bit.
  Returns the launches of kernels 3, 5, 6 and 8."""
  import atexit
  import contextlib
  import io
  import tempfile
  from embodied_tpu_torch import nn, viewer
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  from embodied_tpu_torch.utils import Config
  card = card_line('diagnostics')
  problems = []
  folder = tempfile.mkdtemp(prefix='smoke_diag_')
  row = dict(phase='diagnostics', card=card)
  # (a) An agent that never counts, one step on the host-path batch.
  config = common.assemble_config(dmain.CONFIGS, DEFAULT_ARGV + [
      '--torch.precompile', 'False', '--logdir', f'{folder}/plain'])
  agent = dmain.make_agent(config)
  data = diag_batch(agent, SEED + 6)
  rows = config.batch_size
  _, _, want_mets = agent.train(agent.init_train(rows), data)
  want = {k: v.clone() for k, v in nn.store(agent.model).items()}
  del agent
  gc.collect()
  torch.cuda.empty_cache()
  config = common.assemble_config(dmain.CONFIGS, DEFAULT_ARGV + [
      '--logdir', f'{folder}/window'])
  config = Config({**config, 'torch': {**config.torch, 'profiler': True}})
  printed = io.StringIO()
  start = time.perf_counter()
  with contextlib.redirect_stdout(printed):
    agent = dmain.make_agent(config)
  row['setup_s'] = time.perf_counter() - start
  print(printed.getvalue(), end='', flush=True)
  start = time.perf_counter()
  flops = agent.train_cost()['flops']
  row['train_cost_s'] = time.perf_counter() - start
  agent.model.dyn.kernel = 'off'
  row['train_flops_kernel_off'] = agent.train_cost()['flops']
  agent.model.dyn.kernel = 'auto'
  row.update(train_flops=flops, precompile_line=[
      line for line in printed.getvalue().splitlines()
      if line.startswith('Train step FLOPs')])
  if row['precompile_line'] != [f'Train step FLOPs: {flops:.3e}']:
    problems.append(f'precompile printed {row["precompile_line"]}')
  if row['train_flops_kernel_off'] != flops:
    problems.append('train_cost differs between kernel: auto and off')
  if not flops > FLOPS_FLOOR:
    problems.append(f'train_cost {flops:.4e} <= {FLOPS_FLOOR:.1e}')
  # The main path: launch counts from 0 before its first train call.
  wrappers = train_wrappers()
  for wrapper in wrappers.values():
    wrapper.launches = 0
  carry, _, mets = agent.train(agent.init_train(rows), data)
  got = {k: v for k, v in nn.store(agent.model).items()}
  row['first_step_differing_entries'] = same_stores(torch, got, want)
  row['first_step_differing_metrics'] = sorted(
      k for k in want_mets if not mets.get(k) == want_mets[k])
  if row['first_step_differing_entries'] or row[
      'first_step_differing_metrics']:
    problems.append('the first step after train_cost differs from that of '
                    'an agent that never called it')
  del got, want
  # (b) The window.
  batch, _ = collect_batch(agent, config)
  events = []
  child = None
  for _ in range(DIAG_STEPS - 1):
    if agent._counters['train'] == DIAG_STEPS - 1:
      # (d) starts in a child interpreter beside the call that ends the
      # window (its export) and the trace's reading; no timed update runs
      # beside it.
      child_start = time.perf_counter()
      child = subprocess.Popen(
          [sys.executable, os.path.join(ROOT, 'chip_smoke.py'),
           '--deterministic'], stdout=subprocess.PIPE,
          stderr=subprocess.PIPE, text=True)
      # A phase that fails before reading it still ends it.
      atexit.register(lambda: child.poll() is None and (
          child.kill(), child.wait()))
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    carry, _, mets = agent.train(carry, batch)
    end.record()
    events.append((agent._counters['train'], begin, end))
  torch.cuda.synchronize()
  launches = {k: w.launches for k, w in wrappers.items()}
  row['launches'] = launches
  for name in TRAIN_KERNELS:
    if launches[name] != DIAG_STEPS:
      problems.append(f'{launches[name]} launches of {name} in '
                      f'{DIAG_STEPS} train calls')
  if not launches['obs_step']:
    problems.append('the policy calls launched no kernel 3')
  times = [b.elapsed_time(e) for n, b, e in events
           if DIAG_TIMED[0] <= n < DIAG_TIMED[1]]
  ms = statistics.median(times)
  row.update(
      timed_updates=list(DIAG_TIMED), ms_per_train_step=ms,
      ms_per_train_step_p90=sorted(times)[int(0.9 * len(times))],
      window_call_ms=[b.elapsed_time(e) for n, b, e in events
                      if n >= DIAG_TIMED[1]],
      tflops=flops / ms / 1e9, mfu=flops / (ms / 1e3) / PEAK_BF16,
      peak_flops=PEAK_BF16,
      bad_metrics=sorted(k for k, v in mets.items()
                         if not math.isfinite(v)))
  paths = viewer.find_trace_files(config.logdir)
  if len(paths) != 1:
    fail('diagnostics', f'the window wrote {paths}')
  start = time.perf_counter()
  trace = viewer.load_trace(paths[0])
  annotations = dict(trace['annotations'])
  row.update(
      trace_file=os.path.relpath(paths[0], folder),
      trace_mb=os.path.getsize(paths[0]) / 2 ** 20,
      trace_load_s=time.perf_counter() - start,
      device_events=sum(len(evs) for _, evs in trace['lanes']),
      lanes=[lane for lane, _ in trace['lanes']],
      top_ops_us=[(k[:80], t, n) for k, t, n in trace['ops'][:10]],
      trace_launches={k: annotations.get(k, 0)
                      for k in TRAIN_KERNELS + ('train',)})
  for name in TRAIN_KERNELS + ('train',):
    if annotations.get(name) != DIAG_WINDOW:
      problems.append(f'the trace holds {annotations.get(name)} of {name}, '
                      f'not {DIAG_WINDOW}')
  if not row['device_events']:
    problems.append('the trace holds no device event')
  if row['bad_metrics']:
    problems.append(f'non-finite metrics {row["bad_metrics"][:5]}')
  # (c) The sync guard.
  row['transfer_guard'] = planted_sync(torch, agent)
  if not (row['transfer_guard']['guard_on'] and
          row['transfer_guard']['guard_raised']):
    problems.append(f'no sync guard: {row["transfer_guard"]}')
  del agent, carry, batch
  gc.collect()
  torch.cuda.empty_cache()
  # (d) deterministic: the child's result.
  try:
    out, err = child.communicate(timeout=DET_TIMEOUT)
  except subprocess.TimeoutExpired:
    child.kill()
    child.communicate()
    fail('diagnostics', 'the deterministic child timed out')
  lines = out.strip().splitlines()
  if child.returncode or not lines:
    fail('diagnostics', f'the deterministic child failed '
                        f'({child.returncode}): {err[-2000:]}')
  det = json.loads(lines[-1])
  det['seconds'] = time.perf_counter() - child_start
  row['deterministic'] = det
  if not (det['enabled'] and det['cublas'] == ':4096:8' and
          not det['differing_entries'] and not det['differing_metrics']
          and det['table_step_finite']):
    problems.append(f'deterministic: {det}')
  row['ok'] = not problems
  emit(**row)
  if problems:
    fail('diagnostics', '; '.join(problems))
  return {k: launches[k] for k in ('obs_step',) + TRAIN_KERNELS}


# The Encoder and Decoder's other modes at the default RSSM widths, each
# set by the JAX package's own config keys alone (configs.yaml enc.simple
# and dec.simple): (label, argv, the image's token width). s2d 0 and mults
# [2,3,4,4] give the upstream DreamerV3 conv stacks on 64 x 64 images: the
# strided one (stride-2 convolutions, transposed ones in the decoder,
# whose grid comes from one `space` Linear under bspace 0) down to 4 x 4 x
# 256, and the pooled one whose first layer is unpooled (`outer`) down to
# 8 x 8 x 256, with the block-space projection (bspace 8). dummy_disc's
# vector keys add the MLP's 1024 to the token.
def mode_flags(*flags):
  return [arg for part in ('enc', 'dec') for key, value in (
      ('s2d', '0'), ('mults', '[2,3,4,4]')) + flags
      for arg in (f'--agent.{part}.simple.{key}', value)]


ENCODER_MODES = (
    ('strided', DEFAULT_ARGV + mode_flags(('strided', 'True')) + [
        '--agent.dec.simple.bspace', '0'], 4096),
    ('outer', DEFAULT_ARGV + mode_flags(('outer', 'True')), 16384),
)
MODE_CALLS = 10  # policy calls of ENVS envs on each variant
MODE_TRAIN_STEPS = 3


def phase_encoder_modes(torch, modes=ENCODER_MODES):
  """Each variant of ENCODER_MODES at the default RSSM widths (deter 8192,
  hidden 1024, 32 x 64 stoch) on the host path with dummy_disc's 64 x 64
  images, through make_agent: its parameter count and token width; then,
  with the launch counts set to 0 before and read after, MODE_CALLS
  policy calls of ENVS envs (kernel 3 once each, the last batch held
  against the plain path on the card), and MODE_TRAIN_STEPS Agent.train
  steps on a batch that the policy collected (kernels 5, 6 and 8 once
  each, the first step's losses against kernel: off with check_losses,
  every trained parameter changed by the last): ms per train step and
  peak MB.
  Returns each variant's launches of kernels 3, 5, 6 and 8."""
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  wrappers = train_wrappers()
  out = {}
  for label, argv, width in modes:
    for wrapper in wrappers.values():
      wrapper.launches = 0
    agent, stats, last = drive(argv, MODE_CALLS, ('train',))
    calls = {k: w.launches for k, w in wrappers.items()}
    errs, same = check_against_plain(torch, agent, last)
    model = agent.model
    row = dict(
        phase='encoder_modes', mode=label, argv=argv,
        params=sum(p.numel() for p in model.parameters()),
        token_width=model.enc.token_dim, launches_policy=calls,
        ms_per_policy_call=statistics.median(stats['policy_ms'][1:]),
        plain_max_abs_err={k: e for k, (e, _) in errs.items()},
        sample_agreement=same)
    problems = []
    image = model.enc.token_dim - (
        model.enc.mlp_layers[-1][0].units if model.enc.veckeys else 0)
    row['image_token_width'] = image
    if image != width or not model.dyn._obs_seq_eligible():
      problems.append(f'image token width {image}, not {width} on the '
                      f'kernels')
    if calls['obs_step'] != MODE_CALLS or stats['bad_actions'] or (
        stats['nonfinite']):
      problems.append(f'policy calls: {calls}, {stats}')
    if not all(ok for _, ok in errs.values()):
      problems.append(f'kernel path disagrees with the plain path: {errs}')
    config = common.assemble_config(dmain.CONFIGS, argv + HOST_PATH + NO_COUNT)
    data, _ = collect_batch(agent, config)
    for wrapper in wrappers.values():
      wrapper.launches = 0
    floor = config.agent.dyn.rssm.free_nats
    _, trained, bad = train_steps(
        torch, agent, data, wrappers, 0, MODE_TRAIN_STEPS,
        {k: 1 for k in TRAIN_KERNELS}, plain=plain_train, trained=TRAINED,
        at_floor=lambda row: row['first_losses']['loss/dyn'] <= floor)
    problems += bad
    steps = {k: w.launches for k, w in wrappers.items()}
    row.update(
        launches_train=steps, ms_per_train_step=trained['ms_per_train_step'],
        first_step_ms=trained['first_step_ms'],
        train_frames_per_s=trained['train_frames_per_s'],
        peak_mem_mb=trained['peak_mem_mb'],
        losses_kernel_vs_plain=trained.get('losses_kernel_vs_plain'),
        ok=not problems)
    emit(**row)
    if problems:
      fail('encoder_modes', '; '.join(problems))
    out[label] = dict(obs_step=calls['obs_step'],
                      **{k: steps[k] for k in TRAIN_KERNELS})
    del agent, model, data, last
    gc.collect()
    torch.cuda.empty_cache()
  return out


# The nn modules that no model uses, on the card: a Transformer of
# NN_LAYERS pre-norm blocks (units 1024, 16 heads, 4 key-value heads,
# GLU feedforward) under a causal mask at B 8 and T 1024 in bf16, timed;
# its output and gradients at NN_CHECK_ROWS rows against the same module
# in float32 on the CPU (relative errors in norm: bf16 rounds every
# product and activation, some 2^-8 each, and four residual blocks add
# them up); StackedLayers of one block against the blocks unrolled on the
# same slices; then run.pretrain at the default configuration.
NN_LAYERS, NN_UNITS, NN_HEADS, NN_KV = 4, 1024, 16, 4
NN_BATCH, NN_T = 8, 1024
NN_CHECK_ROWS = 2
NN_OUT_RTOL = 3e-2
NN_GRAD_RTOL = 6e-2
PRETRAIN_STEPS = 80  # env steps of each of ENVS envs that fill the bag
PRETRAIN_BUDGET = (20, 8)  # seconds of the first run and of the resumed one
PRETRAIN_SAVE_EVERY = 10  # one save inside the first run's budget


def relnorm(torch, got, want):
  got, want = got.float().cpu(), want.float().cpu()
  return float(torch.linalg.vector_norm(got - want) /
               torch.linalg.vector_norm(want).clamp(min=1e-30))


def nn_module(torch, make, dtype, seed=SEED):
  """`make(cdtype)`, a module of the port, under its scope with weights
  drawn from `seed` (the same values in any dtype)."""
  from embodied_tpu_torch import nn
  module = make(dtype)
  root = torch.nn.Module()
  root.add_module(module.name, module)
  nn.init_params(root, seed)
  return module


def transformer_check(torch):
  """The Transformer on the card, timed, against float32 on the CPU;
  StackedLayers against the unrolled blocks. Returns the row's fields and
  the problems."""
  from embodied_tpu_torch import nn
  make = lambda layers, name: lambda dtype: nn.Transformer(
      layers, NN_UNITS, NN_HEADS, name, kvheads=NN_KV, causal=True,
      cdtype=dtype)
  card = nn_module(torch, make(NN_LAYERS, 'tf'), torch.bfloat16).to(DEV)
  gen = torch.Generator().manual_seed(SEED + 7)
  x = torch.randn((NN_BATCH, NN_T, NN_UNITS), generator=gen)
  w = torch.randn((NN_BATCH, NN_T, NN_UNITS), generator=gen)
  mask = torch.tril(torch.ones((NN_T, NN_T), dtype=torch.bool))
  xd, wd, maskd = x.to(DEV), w.to(DEV), mask.to(DEV)
  loss = lambda module, x, w, mask: (
      module(x, mask).float() * w).sum() / w.numel()

  def forward():
    with torch.no_grad():
      card(xd, maskd)

  def forward_backward():
    card.zero_grad(set_to_none=True)
    loss(card, xd, wd, maskd).backward()
  torch.cuda.reset_peak_memory_stats()
  fields = dict(
      transformer=dict(layers=NN_LAYERS, units=NN_UNITS, heads=NN_HEADS,
                       kvheads=NN_KV, batch=NN_BATCH, T=NN_T, dtype='bf16',
                       params=sum(p.numel() for p in card.parameters())),
      forward_ms=cuda_ms(torch, forward, warmup=3, iters=10),
      forward_backward_ms=cuda_ms(torch, forward_backward, warmup=3,
                                  iters=10),
      peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20)
  rows = slice(0, NN_CHECK_ROWS)
  card.zero_grad(set_to_none=True)
  got = loss(card, xd[rows], wd[rows], maskd)
  got.backward()
  with torch.no_grad():
    out = card(xd[rows], maskd)
  cpu = nn_module(torch, make(NN_LAYERS, 'tf'), torch.float32)
  want = loss(cpu, x[rows], w[rows], mask)
  want.backward()
  with torch.no_grad():
    want_out = cpu(x[rows], mask)
  reference = dict(cpu.named_parameters())
  grads = {k: relnorm(torch, p.grad, reference[k].grad)
           for k, p in card.named_parameters()}
  worst = max(grads, key=grads.get)
  fields.update(
      check_rows=NN_CHECK_ROWS, out_rtol=NN_OUT_RTOL, grad_rtol=NN_GRAD_RTOL,
      out_relerr=relnorm(torch, out, want_out),
      grad_relerr_max=grads[worst], grad_relerr_worst=worst)
  problems = []
  if not (fields['out_relerr'] <= NN_OUT_RTOL):
    problems.append(f'transformer output off by {fields["out_relerr"]}')
  if not (grads[worst] <= NN_GRAD_RTOL):
    problems.append(f'transformer gradients off: {grads}')
  del card, cpu, reference
  # One block stacked NN_LAYERS times against the blocks unrolled (no mask:
  # a stacked layer takes x alone).
  stack = nn_module(torch, lambda dtype: nn.StackedLayers(
      make(1, 'block')(dtype), NN_LAYERS, 'stack'), torch.bfloat16).to(DEV)
  block = make(1, 'block')(torch.bfloat16).to(DEV)
  slices = dict(stack.layer.named_parameters())
  with torch.no_grad():
    got = stack(xd[rows])
    want = xd[rows]
    for i in range(NN_LAYERS):
      for name, param in block.named_parameters():
        param.copy_(slices[name][i])
      want = block(want)
  fields['stacked'] = dict(
      layers=NN_LAYERS, shapes=tuple(slices['attn0.q.kernel'].shape),
      max_abs_err=float((got.float() - want.float()).abs().max()))
  if fields['stacked']['max_abs_err'] != 0:
    problems.append(f'stacked layers off the unrolled ones: '
                    f'{fields["stacked"]}')
  return fields, problems


def bag_from_replay(torch, folder):
  """A short dummy_disc run of the default configuration on the host path
  fills a replay, whose chunks BagWriter writes to `folder`/bag, each
  record with `consec` 0 (each window starts fresh from its stored
  latents). The latent table stays off: its latents live on the device,
  and a bag's records carry the latents themselves. Returns the agent,
  its config and the bag's row."""
  import numpy as np
  from embodied_tpu_torch import core, data
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.models.dreamerv3 import main as dmain
  config = common.assemble_config(dmain.CONFIGS, DEFAULT_ARGV + HOST_PATH + [
      '--torch.precompile', 'False', '--logdir', f'{folder}/run',
      '--run.save_every', str(PRETRAIN_SAVE_EVERY), '--run.log_every', '5',
      '--run.report_every', str(10 ** 9)])
  agent = dmain.make_agent(config)
  replay = common.make_replay(config, f'{folder}/replay')
  driver = core.Driver(
      [lambda i=i: common.make_env(config, i) for i in range(ENVS)],
      parallel=False)
  driver.on_step(replay.add)
  driver.reset(agent.init_policy)
  driver(agent.policy, steps=ENVS * PRETRAIN_STEPS)
  driver.close()
  writer = data.BagWriter(f'{folder}/bag', shard_size=512)
  records = 0
  for lane in sorted(replay.lanes):
    for index in sorted(replay.lanes[lane]):
      segment = replay.lanes[lane][index]
      for i in range(segment.count):
        writer.append({**{k: v[i] for k, v in segment.cols.items()},
                       'consec': np.int32(0)})
        records += 1
  writer.close()
  bag = data.Bag(f'{folder}/bag')
  keys = set(agent._example_batch(1, 1))
  return agent, config, dict(
      records=records, shards=len(bag.files), keys=sorted(bag.spaces),
      missing=sorted(keys - set(bag.spaces)))


def pretrain_check(torch):
  """run.pretrain at the default configuration (on the host path) on a
  data.BagSampler over a bag written from a replay (bag_from_replay),
  through PRETRAIN_BUDGET[0] seconds, then resumed from its checkpoint for
  PRETRAIN_BUDGET[1]: train steps and frames/s of each run, and the
  sampler's stream against one sampler of the same seed drawn alone: the
  first run's draws are its first ones, and the resumed run's continue
  it from the draw its checkpoint saved. Returns the row's fields and the
  problems."""
  import shutil
  from embodied_tpu_torch import data, run
  from embodied_tpu_torch.models import common
  from embodied_tpu_torch.utils import Config
  folder = os.path.join(ROOT, 'build', 'chip_smoke_pretrain')
  shutil.rmtree(folder, ignore_errors=True)
  agent, config, fields = bag_from_replay(torch, folder)
  problems = []
  if fields['missing']:
    problems.append(f'the bag lacks the train keys {fields["missing"]}')
  B, T = config.batch_size, config.batch_length + config.replay_context

  class Sampler(data.BagSampler):
    """Logs each draw: the generator's state before it, and the stepids
    of its windows' first records; and each load, with the state loaded
    (a prefetch that began before the load drew before it, and its
    batches are dropped)."""

    def __init__(self, log, *args, **kw):
      super().__init__(*args, **kw)
      self.log = log

    def __next__(self):
      state = json.dumps(self.rng.bit_generator.state)
      batch = super().__next__()
      self.log.append((state, batch['stepid'][:, 0].tobytes()))
      return batch

    def load(self, state):
      self.log.append(('load', state['rng']))
      super().load(state)

  logs = []

  def make_stream(_, mode):
    log = []
    if mode == 'train':
      logs.append(log)
      return Sampler(log, f'{folder}/bag', B, T, seed=SEED)
    length = config.report_length + config.replay_context
    return Sampler(log, f'{folder}/bag', B, length, seed=SEED + 1)

  fields['runs'] = []
  for budget in PRETRAIN_BUDGET:
    args = Config(
        **{**dict(config.run), 'duration': budget}, replica=0, replicas=1,
        logdir=config.logdir, batch_size=B,
        batch_length=config.batch_length, report_length=config.report_length,
        consec_train=config.consec_train, consec_report=config.consec_report,
        replay_context=config.replay_context)
    before = agent._counters['train']
    start = time.perf_counter()
    run.pretrain(lambda: agent, make_stream,
                 lambda: common.make_logger(config), args)
    wall = time.perf_counter() - start
    steps = agent._counters['train'] - before
    fields['runs'].append(dict(
        budget_s=budget, wall_s=wall, train_steps=steps,
        frames_per_s=steps * B * config.batch_length / budget,
        draws=len(logs[-1])))
  reference = Sampler([], f'{folder}/bag', B, T, seed=SEED)
  for _ in range(sum(len(log) for log in logs) + 4):
    next(reference)
  first, resumed = logs
  states = [state for state, _ in reference.log]
  loads = [i for i, (kind, _) in enumerate(resumed) if kind == 'load']
  loaded = resumed[loads[-1]][1] if loads else None
  at = states.index(loaded) if loaded in states else None
  resumed = resumed[loads[-1] + 1:] if loads else resumed
  fields['stream'] = dict(first_draws=len(first), loads=len(loads),
                          resumed_at=at, resumed_draws=len(resumed))
  if first != reference.log[:len(first)]:
    problems.append('the first run drew off the seeded stream')
  if at is None or not 0 < at <= len(first) or not resumed or (
      resumed != reference.log[at:at + len(resumed)]):
    problems.append(f'the resumed run does not continue the stream: '
                    f'{fields["stream"]}')
  if not all(r['train_steps'] for r in fields['runs']):
    problems.append(f'a run trained no step: {fields["runs"]}')
  del agent
  shutil.rmtree(folder, ignore_errors=True)
  return fields, problems


RING_SHAPE = (2, 2048, 16, 64)  # B, T (over all ranks), H, D
RING_TOL = 2e-2  # bf16 against bf16: the block order rounds differently


def ring_check(torch, world, backend='nccl', device='cuda'):
  """Ring attention on `world` ranks (spawned processes; NCCL on one card
  each, or gloo on the CPU), causal and full, in bf16 on the card (float32
  on the CPU), against full_attention on the same global q, k and v on
  each rank. Returns (row, problems)."""
  import multiprocessing
  import pickle
  import shutil
  import tempfile
  folder = tempfile.mkdtemp(prefix='smoke_ring_')
  port = free_port()
  context = multiprocessing.get_context('spawn')
  procs = [context.Process(target=ring_rank_main,
                           args=(r, world, port, folder, backend, device))
           for r in range(world)]
  for proc in procs:
    proc.start()
  for proc in procs:
    proc.join(300)
  for proc in procs:
    if proc.is_alive():
      proc.kill()
      proc.join()
  codes = [p.exitcode for p in procs]
  if any(codes):
    shutil.rmtree(folder, ignore_errors=True)
    return None, [f'ring ranks exited with {codes}']
  got = []
  for r in range(world):
    with open(os.path.join(folder, f'rank{r}.pkl'), 'rb') as f:
      got.append(pickle.load(f))
  shutil.rmtree(folder, ignore_errors=True)
  row = dict(ring_ranks=world, backend=backend, shape=RING_SHAPE,
             tol=RING_TOL, max_abs_err={
                 k: max(g[k] for g in got) for k in got[0]})
  bad = {k: e for k, e in row['max_abs_err'].items() if not e <= RING_TOL}
  return row, [f'ring attention off full attention: {bad}'] if bad else []


def ring_rank_main(rank, world, port, folder, backend, device):
  """One rank of ring_check (a spawned process)."""
  import pickle
  import torch
  import torch.distributed as dist
  from embodied_tpu_torch.ops import ring_attention as ra
  device = torch.device(device, rank) if device == 'cuda' else (
      torch.device(device))
  if device.type == 'cuda':
    torch.cuda.set_device(device)
  dist.init_process_group(backend, init_method=f'tcp://localhost:{port}',
                          rank=rank, world_size=world)
  dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
  gen = torch.Generator().manual_seed(SEED + 8)
  q, k, v = (torch.randn(RING_SHAPE, generator=gen).to(device, dtype)
             for _ in range(3))
  out = {}
  for causal in (False, True):
    got = ra.ring_attention_sharded(q, k, v, causal=causal)
    want = ra.full_attention(q, k, v, causal=causal)
    out[f'causal={causal}'] = float((got.float() - want.float()).abs().max())
  with open(os.path.join(folder, f'rank{rank}.pkl'), 'wb') as f:
    pickle.dump(out, f)
  dist.barrier()
  dist.destroy_process_group()


def phase_nn_modules(torch):
  """The nn modules and the dataset reader on the card: transformer_check
  and pretrain_check; ring attention (ring_check) only where two or more
  cards are, on two NCCL ranks, else `ring_ranks: 1`."""
  row = dict(phase='nn_modules')
  fields, problems = transformer_check(torch)
  row.update(fields)
  gc.collect()
  torch.cuda.empty_cache()
  fields, bad = pretrain_check(torch)
  row.update(pretrain=fields)
  problems += bad
  if torch.cuda.device_count() < 2:
    row['ring_ranks'] = 1
  else:
    row['ring'], bad = ring_check(torch, 2)
    problems += bad
  row['ok'] = not problems
  emit(**row)
  if problems:
    fail('nn_modules', '; '.join(problems))
  gc.collect()
  torch.cuda.empty_cache()


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
  if sys.argv[1:] == ['--deterministic']:
    return deterministic_main()
  if sys.argv[1:] == ['--bandit']:
    return bandit_main()
  start = time.perf_counter()
  timed(phase_device, torch)
  timed(phase_build)
  rows = timed(phase_kernels, torch)
  update = timed(phase_optim, torch)
  launches = timed(phase_slice, torch)
  trained = timed(phase_train, torch)
  launches.update({k: trained[TRAIN_PATHS[0][0]][k]
                   for k in TRAIN_KERNELS + (UPDATE,)})
  modes = timed(phase_modes, torch)
  # Each kernel's launches on its own path: the core step's backward under
  # obslayers: 2, the observe step's under kernel: fused, the imagination
  # step under kernel: imag.
  launches.update(
      core_step_bwd=modes['obslayers: 2']['core_step_bwd'],
      obs_step_bwd=modes['kernel: fused']['obs_step_bwd'],
      imag_step=modes['kernel: imag']['imag_step'])
  # This slice's paths: kernel 9 on the int8 window's validation, kernels
  # 3, 5, 6 and 8 on the default configuration.
  launches['qobs_window'] = timed(phase_qcore, torch)
  # The default configuration as it runs by default: its policy calls and
  # train steps on the latent table (their launches, in place of those of
  # the default phase's host path).
  table_launches = timed(phase_latents, torch)
  default_launches, pinpad_speed = timed(phase_default, torch)
  launches.update(default_launches)
  launches.update(table_launches)
  # The actor-learner script: kernel 3 in the actor's policy calls,
  # kernels 5, 6 and 8 in the learner's train steps.
  parallel_launches = timed(phase_parallel, torch, pinpad_speed)
  # The same script on a process group of two ranks: kernel 3 in each
  # rank's actor, kernels 5, 6 and 8 in each rank's learner.
  group_launches = timed(phase_parallel_group, torch)
  bandit = start_bandit()  # beside phase script, read by phase ppo
  timed(phase_script, torch)
  timed(phase_ppo, torch, bandit)
  director = timed(phase_director, torch)
  # The default configuration on a one-rank NCCL group: kernels 5, 6 and 8
  # in its data-parallel steps, kernel 3 on the policy/train split's copy.
  distributed, sharded = timed(phase_distributed, torch)
  # The default configuration's diagnostics: kernels 5, 6 and 8 in the
  # train steps of the profiler window, kernel 3 in the policy calls.
  diagnostics = timed(phase_diagnostics, torch)
  # The Encoder and Decoder's strided and outer modes at the default RSSM
  # widths: kernel 3 in their policy calls, kernels 5, 6 and 8 in their
  # train steps. Then the nn modules that no model uses, and run.pretrain
  # on the dataset reader.
  encoder_modes = timed(phase_encoder_modes, torch)
  timed(phase_nn_modules, torch)
  kernels = []
  for row in rows:
    # The list holds each kernel once: at the default configuration's dims
    # where this slice runs it there, else at size12m's main-path shapes.
    name = row['name']
    if name in DEFAULT_KERNELS and row.get('config') != 'default':
      continue
    if name in ('core_step', 'obs_step') and row['batch'] != ENVS:
      continue
    if name == 'imag_step' and row['batch'] != IMAG_STARTS:
      continue
    if row.get('head', 'categorical') != 'categorical':
      continue
    source, replaces = SOURCES[name]
    kernels.append(dict(
        name=name, route='cuda', source=source, replaces=replaces,
        launches=launches[name], max_abs_err=row['max_abs_err'],
        ms=row['ms'], plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
        bound_by=row['bound_by'], library_ms=None,
        config=row.get('config', 'size12m')))
    if name in director:
      kernels[-1]['director_launches'], kernels[-1]['director_shape'] = (
          director[name])
    if name in parallel_launches:
      kernels[-1]['parallel_launches'] = parallel_launches[name]
    if name in group_launches:
      kernels[-1]['parallel_group_launches'] = group_launches[name]
    if name in distributed:
      kernels[-1]['distributed_launches'] = distributed[name]
    if name in sharded['1,2,1']:
      kernels[-1]['sharded_launches'] = sharded['1,2,1'][name]
      kernels[-1]['split_launches'] = sharded[SPLIT_MESH][name]
    if name in diagnostics:
      kernels[-1]['diagnostics_launches'] = diagnostics[name]
    if name in encoder_modes[ENCODER_MODES[0][0]]:
      kernels[-1]['encoder_modes_launches'] = {
          label: counts[name] for label, counts in encoder_modes.items()}
  # The optimizer's pair: its launches on the default configuration's
  # train steps (phase default), its times at the 200M optimizer's leaves.
  kernels.append(dict(
      name='optim', route='cuda', source='embodied_tpu_torch/csrc/optim.cu',
      replaces=None, launches=launches[UPDATE], max_abs_err=None,
      max_rel_err=update['max_rel_err'], ms=update['kernel_ms'],
      plain_ms=update['plain_ms'], bound_ms=update['bound_ms'],
      bound_by=update['bound_by'], library_ms=None,
      config=update['preset']))
  if sorted(k['name'] for k in kernels) != sorted([*SOURCES, 'optim']):
    fail('kernels', f'the list holds {[k["name"] for k in kernels]}')
  emit(phase='timing', ok=True, phase_seconds=PHASES['seconds'])
  emit(phase='total', ok=True, seconds=time.perf_counter() - start)
  print(json.dumps({'kernels': kernels}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
  main()
