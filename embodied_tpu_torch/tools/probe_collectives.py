"""Which torch.distributed collectives a backend takes on CUDA tensors,
and what they cost at the default configuration's sizes.

    python -m embodied_tpu_torch.tools.probe_collectives [--backend gloo]

Two ranks, spawned processes on a localhost coordinator. With gloo both
ranks run on cuda:0 (what the sharded check of chip_smoke.py does on a
machine with one card); with nccl, on cuda:0 and cuda:1. Each rank runs
on CUDA tensors: all_reduce, broadcast, all_gather and
all_gather_into_tensor on 1,000 floats, with their results; then three
timed calls each of an all-gather of 429,631,488 B a rank (the sharded
entries of the default DreamerV3 store at torch.mesh '1,2,1') and an
all-reduce of 811,929,376 B (its flat gradient); then an all_gather and
an all_reduce under torch.cuda.set_sync_debug_mode('error'), the sync
guard's mode (parallel/guard.py). Prints one JSON line per rank and the
card's name and power limit; exits 0 when every rank ended.
"""

import argparse
import datetime
import json
import multiprocessing
import socket
import subprocess
import time

GATHER_BYTES = 429_631_488
REDUCE_BYTES = 811_929_376


def attempt(fn):
  try:
    return fn()
  except Exception as e:  # The result names what the backend refused.
    return f'failed: {e!r}'[:300]


def rank_main(rank, port, backend, out):
  import torch
  import torch.distributed as dist
  device = torch.device('cuda', rank if backend == 'nccl' else 0)
  torch.cuda.set_device(device)
  dist.init_process_group(
      backend, init_method=f'tcp://localhost:{port}', rank=rank,
      world_size=2, timeout=datetime.timedelta(seconds=60))
  x = torch.full((1000,), float(rank + 1), device=device)

  def all_reduce():
    y = x.clone()
    dist.all_reduce(y)
    return float(y[0])

  def broadcast():
    y = x.clone()
    dist.broadcast(y, 0)
    return float(y[0])

  def all_gather():
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    return [float(p[0]) for p in parts]

  def all_gather_into_tensor():
    y = torch.empty(2 * len(x), device=device)
    dist.all_gather_into_tensor(y, x)
    return [float(y[0]), float(y[len(x)])]

  row = dict(rank=rank, backend=backend, device=str(device))
  for fn in (all_reduce, broadcast, all_gather, all_gather_into_tensor):
    row[fn.__name__] = attempt(fn)
  timings = {}
  for name, nbytes in (('all_gather', GATHER_BYTES),
                       ('all_reduce', REDUCE_BYTES)):
    value = torch.ones(nbytes // 4, device=device)
    parts = [torch.empty_like(value) for _ in range(2)]
    times = []
    for _ in range(3):
      torch.cuda.synchronize(device)
      start = time.perf_counter()
      if name == 'all_gather':
        dist.all_gather(parts, value)
      else:
        dist.all_reduce(value)
      torch.cuda.synchronize(device)
      times.append(time.perf_counter() - start)
    timings[f'{name}_{nbytes}_bytes_s'] = times
    del value, parts
  row['timings'] = timings
  for name, fn in (('all_gather', all_gather), ('all_reduce', all_reduce)):
    torch.cuda.set_sync_debug_mode('error')
    try:
      row[f'{name}_under_sync_guard'] = attempt(fn)
    finally:
      torch.cuda.set_sync_debug_mode('default')
  dist.barrier()
  dist.destroy_process_group()
  out.put(row)


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument('--backend', default='gloo', choices=('gloo', 'nccl'))
  backend = parser.parse_args().backend
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True).stdout.strip().splitlines()
  print(json.dumps({'card': card[0] if card else None}), flush=True)
  with socket.socket() as sock:
    sock.bind(('localhost', 0))
    port = sock.getsockname()[1]
  context = multiprocessing.get_context('spawn')
  out = context.Queue()
  procs = [context.Process(target=rank_main, args=(r, port, backend, out))
           for r in range(2)]
  for proc in procs:
    proc.start()
  rows = [out.get(timeout=300) for _ in procs]
  for proc in procs:
    proc.join(60)
    if proc.is_alive():
      proc.kill()
  for row in sorted(rows, key=lambda r: r['rank']):
    print(json.dumps(row), flush=True)
  if any(proc.exitcode for proc in procs):
    raise SystemExit(f'ranks exited with {[p.exitcode for p in procs]}')


if __name__ == '__main__':
  main()
