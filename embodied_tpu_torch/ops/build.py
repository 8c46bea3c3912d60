"""Builds the CUDA sources in `csrc/` into shared libraries for ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles with nvcc, for
Hopper (`sm_90a`), into `build/kernels/<name>-<digest>.so` at the root of
the checkout, where the digest covers the sources and flags. The build runs
at the first use of a kernel, or up front through `build()`, which starts
one nvcc per source in parallel. Nothing is built at import.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'kernels'
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs = {}


def nvcc():
  path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found: the CUDA kernels need the toolkit')
  return path


def target(name):
  digest = hashlib.sha256(' '.join(FLAGS).encode())
  for path in sorted(CSRC.glob('*.cuh')) + [CSRC / f'{name}.cu']:
    digest.update(path.name.encode())
    digest.update(path.read_bytes())
  return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def build(names):
  """Compile the sources `names` that are not built yet, all at once.
  Returns {name: seconds} and writes nvcc's report (registers, shared
  memory, spills) beside each library as `<lib>.log`."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  jobs = {}
  for name in names:
    out = target(name)
    if out.exists():
      continue
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc(), *FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    jobs[name] = (proc, tmp, out, time.perf_counter())
  seconds, failed = {}, []
  for name, (proc, tmp, out, start) in jobs.items():
    log, _ = proc.communicate()
    seconds[name] = time.perf_counter() - start
    out.with_suffix('.so.log').write_text(log)
    if proc.returncode:
      failed.append(f'{name}: nvcc exit {proc.returncode}\n{log}')
    else:
      os.replace(tmp, out)
  if failed:
    raise RuntimeError('Kernel build failed:\n' + '\n'.join(failed))
  return seconds


def library(name):
  """The loaded library of `csrc/<name>.cu`, built on first use."""
  with _lock:
    if name not in _libs:
      build([name])
      _libs[name] = ctypes.CDLL(str(target(name)))
    return _libs[name]


def bind(lib, symbol, npointers, tail):
  """Declare a C entry point that takes `npointers` pointers followed by
  `tail` (ctypes types) and a stream, and returns a CUDA error code."""
  fn = getattr(lib, symbol)
  fn.argtypes = [ctypes.c_void_p] * npointers + list(tail) + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn


def check(code, symbol):
  if code:
    raise RuntimeError(f'{symbol} failed to launch: CUDA error {code}')
