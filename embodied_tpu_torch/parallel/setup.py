"""Process groups of the port: the counterpart of
embodied_tpu/parallel/setup.py's device setup and multi-host init.

A rank is one process with one device: `cuda:{LOCAL_RANK}` on the card,
the CPU when the caller asks for it. `setup` runs once per process. With
a `coordinator_address` (host:port) it starts the default process group
there, with `nccl` for a CUDA device and `gloo` for the CPU; the rank and
world size come from its arguments, else from the RANK and WORLD_SIZE
variables, as `jax.distributed.initialize` reads its cluster's. A failed
start raises: there is no second try on another backend, and the group's
timeout is finite, so a lost rank fails the run rather than hanging it.

`mock_devices: N` is the counterpart of the JAX package's N virtual CPU
devices in one process: N gloo ranks on this host, which
`models.common.run_script` starts (each rank then calls `setup` with the
coordinator it was given). A process that asks for N mock devices and is
not one of N ranks raises.

Three knobs of JAX's setup carry over; `KNOBS` holds what the first call
set (parallel/guard.py), and the Agent reads it at construction:
- `deterministic`: torch.use_deterministic_algorithms(True), cuDNN's
  deterministic algorithms without benchmarking, and CUBLAS_WORKSPACE_CONFIG
  `:4096:8`, which must be set before the process's first cuBLAS handle:
  `setup` runs before any model is built, and a later call that asks for
  it when the first did not raises (JAX's
  `--xla_gpu_deterministic_ops=true`);
- `debug`: autograd's anomaly detection for the backward, and the NaN
  check (parallel/guard.py) inside the Agent's `train`, `policy` and
  `report` (JAX's `jax_debug_nans`; `jax_disable_most_optimizations` has
  no counterpart);
- `transfer_guard` (the default): the sync guard (parallel/guard.py)
  inside the same calls, on a CUDA device and not under `debug`, as JAX's
  guard is on with `jit` and not `debug`.
JAX's `jit`, `prealloc`, `cache_dir`, `xla_flags` and `platform` have no
counterpart: the port runs eagerly, on PyTorch's caching allocator, with
its kernels built once into `build/kernels/`, on the device it is given.
"""

import datetime
import os

import torch
import torch.distributed as dist

from .guard import KNOBS

_DONE = [False]
_DEVICES = [None]  # What the first call returned.
# Seconds a collective or the rendezvous may wait for another rank.
TIMEOUT = 600


def setup(device='cuda', compute_dtype='bfloat16', mock_devices=0,
          expect_devices=0, coordinator_address='', rank=None,
          world_size=None, timeout=TIMEOUT, debug=False,
          deterministic=False, transfer_guard=True):
  """Start this process's rank (once) and return the world's devices, one
  torch.device per rank in rank order. `compute_dtype` must name a dtype
  the port computes in; the models take it at construction. The knobs
  `debug`, `deterministic` and `transfer_guard` are the module note's."""
  from .. import nn
  if _DONE[0]:
    if deterministic and not KNOBS['deterministic']:
      raise RuntimeError(
          'setup(deterministic=True) after a setup without it: cuBLAS reads '
          'CUBLAS_WORKSPACE_CONFIG at its first handle; ask for it in the '
          "process's first setup")
    return _DEVICES[0]
  _DONE[0] = True
  KNOBS.update(debug=bool(debug), deterministic=bool(deterministic),
               transfer_guard=bool(transfer_guard) and not debug)
  if deterministic:
    os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
  if debug:
    torch.autograd.set_detect_anomaly(True)
  if compute_dtype not in nn.DTYPES:
    raise ValueError(f'Unknown compute dtype {compute_dtype!r}')
  device = torch.device(device)
  if mock_devices and device.type != 'cpu':
    raise ValueError('mock_devices runs gloo ranks on the CPU: set '
                     f'torch.device to cpu, not {device}')
  if coordinator_address:
    init_group(device, coordinator_address, rank, world_size, timeout)
  devices = world_devices(device)
  if mock_devices and len(devices) != mock_devices:
    raise RuntimeError(
        f'mock_devices {mock_devices} runs as {mock_devices} gloo ranks, '
        f'and this process is one of {len(devices)}: start the ranks with '
        'models.common.run_script (main), or give each its coordinator '
        'address, RANK and WORLD_SIZE')
  if expect_devices and len(devices) != expect_devices:
    raise RuntimeError(
        f'Expected {expect_devices} devices, the world has {len(devices)}')
  _DEVICES[0] = devices
  return devices


def init_group(device, address, rank=None, world_size=None,
               timeout=TIMEOUT):
  """The default process group at `address` (host:port): nccl for a CUDA
  device, gloo for the CPU. Raises if it cannot start."""
  rank = int(os.environ['RANK'] if rank is None else rank)
  world_size = int(
      os.environ['WORLD_SIZE'] if world_size is None else world_size)
  device = torch.device(device)
  if device.type == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError(
          'No CUDA device is available. Pass device="cpu" to run on the CPU.')
    torch.cuda.set_device(rank_device(device))
  backend = 'nccl' if device.type == 'cuda' else 'gloo'
  dist.init_process_group(
      backend, init_method=f'tcp://{address}', rank=rank,
      world_size=world_size, timeout=datetime.timedelta(seconds=timeout))


def shutdown():
  """Leave the process group, if any, once every rank has come here:
  rank 0 hosts the rendezvous store, and a process that exits with its
  group alive may abort in the group's destructor."""
  if dist.is_initialized():
    dist.barrier()
    dist.destroy_process_group()


def rank_device(device):
  """This rank's device: cuda:{LOCAL_RANK} for a CUDA device named
  without an index (LOCAL_RANK 0 outside a group), else `device`."""
  device = torch.device(device)
  if device.type == 'cuda' and device.index is None:
    return torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
  return device


def world_devices(device):
  """Every rank's device, in rank order: this rank's alone without a
  process group."""
  mine = rank_device(device)
  if not dist.is_initialized():
    return [mine]
  devices = [None] * dist.get_world_size()
  dist.all_gather_object(devices, str(mine))
  return [torch.device(d) for d in devices]


def agree(flag):
  """Rank 0's boolean `flag` on every rank (the flag itself without a
  process group): for decisions taken from a wall clock that every rank
  must take alike."""
  return _decide(flag, lambda value: dist.broadcast(value, 0))


def everyone(flag):
  """Whether every rank's boolean `flag` is true (the flag itself without
  a process group): for a collective that needs each rank's own data."""
  return _decide(flag, lambda value: dist.all_reduce(
      value, dist.ReduceOp.MIN))


def _decide(flag, collective):
  if not dist.is_initialized() or dist.get_world_size() == 1:
    return bool(flag)
  nccl = dist.get_backend() == 'nccl'
  value = torch.tensor([int(bool(flag))],
                       device=rank_device('cuda' if nccl else 'cpu'))
  collective(value)
  return bool(value.item())


def share_cores(ranks):
  """Give this rank its share of the host's cores when `ranks` ranks share
  the host's CPU, unless OMP_NUM_THREADS sets the threads: PyTorch's
  intra-op threads of several ranks oversubscribe the cores otherwise,
  and each collective then waits on the slowest rank's threads."""
  if 'OMP_NUM_THREADS' not in os.environ:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
