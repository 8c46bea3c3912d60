"""The card a run measures: the check that it is there, its identity, the
fixed cache directories inside the checkout, and the look at the modules
the run has loaded."""

import os
import pathlib
import subprocess
import sys

# Top-level module names the run may not load: JAX, its libraries, and the
# JAX package that the port was made from. Compared whole, so that the
# port's own name, which begins with the JAX package's, does not match.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'embodied_tpu')


def cache_env(root):
  """The build and kernel caches at fixed paths inside the checkout (the
  port builds its kernels into build/kernels and build/native itself),
  and no JAX backend for any library that would load one."""
  root = pathlib.Path(root)
  env = {
      'TRITON_CACHE_DIR': str(root / 'build' / 'triton'),
      'TORCH_EXTENSIONS_DIR': str(root / 'build' / 'torch_extensions'),
      'USE_FLAX': '0', 'USE_JAX': '0', 'USE_TF': '0',
  }
  os.environ.update(env)
  return env


def require(count):
  """Raises unless torch sees at least `count` CUDA cards."""
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('No CUDA card: the benchmark measures the port on an '
                     'NVIDIA GPU and has no CPU fallback.')
  if torch.cuda.device_count() < count:
    raise SystemExit(f'The cell needs {count} CUDA cards; torch sees '
                     f'{torch.cuda.device_count()}.')


def identity(count):
  """The result's `device` entry, without the peak."""
  import torch
  return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
          'count': int(count)}


def power_limit():
  """The card's power limit as nvidia-smi reports it, or None."""
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        timeout=20)
  except (OSError, subprocess.TimeoutExpired):
    return None
  try:
    return float(out.stdout.split()[0])
  except (IndexError, ValueError):
    return None


def forbidden_modules(modules=None):
  """The loaded modules whose top-level name is a forbidden one."""
  modules = sys.modules if modules is None else modules
  return sorted({name for name in modules
                 if name.split('.')[0] in FORBIDDEN})
