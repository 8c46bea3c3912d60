"""Native (C++) runtime components, compiled with g++ at first use.

The port of embodied_tpu/native/__init__.py. `dataplane.cpp` (a copy of
the JAX package's) is the zero-copy binary codec for RPC payloads (dicts
of numpy arrays): one C call per message, large arrays never copied on
either side (scatter-gather send, aliasing views on receive).

Unlike the JAX package, nothing is built when this module is imported and
nothing is written next to the source: `codec()` builds the extension at
its first call, against the Python and numpy headers, into
`build/native/_dataplane-<digest><suffix>` at the root of the checkout,
where the digest covers the source and the flags. The build goes to a
temporary file renamed into place, so processes that start together may
all build and load. When the build or the load fails, `codec()` returns
None and the RPC layer sends the pickle wire format (format 0), as the
reference does; `codec_status()` says which and why.
"""

import hashlib
import importlib.util
import os
import pathlib
import subprocess
import sysconfig
import threading

SOURCE = pathlib.Path(__file__).resolve().with_name('dataplane.cpp')
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'native'
FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')

_lock = threading.Lock()
_state = {}


def target():
  import numpy as np
  include = (sysconfig.get_path('include'), np.get_include())
  digest = hashlib.sha256(' '.join(FLAGS + include).encode())
  digest.update(np.__version__.encode())  # the numpy ABI built against
  digest.update(SOURCE.read_bytes())
  suffix = sysconfig.get_config_var('EXT_SUFFIX') or '.so'
  return BUILD_DIR / f'_dataplane-{digest.hexdigest()[:16]}{suffix}', include


def _build():
  """The path of the built extension, or raises RuntimeError saying why
  the build failed."""
  out, include = target()
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
  cmd = ['g++', *FLAGS, *(f'-I{path}' for path in include), str(SOURCE),
         '-o', str(tmp)]
  try:
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
  except (OSError, subprocess.SubprocessError) as e:
    stderr = (getattr(e, 'stderr', b'') or b'').decode(errors='replace')
    raise RuntimeError(
        f'g++ failed ({type(e).__name__}): {stderr[:500] or e}') from e
  os.replace(tmp, out)
  return out


def _load():
  path = _build()
  spec = importlib.util.spec_from_file_location('_dataplane', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def codec():
  """The codec extension (encode, decode), built at the first call; None
  when it could not be built or loaded (see codec_status)."""
  with _lock:
    if not _state:
      try:
        _state['codec'], _state['status'] = _load(), 'native'
      except (RuntimeError, ImportError, OSError) as e:
        _state['codec'], _state['status'] = None, f'pickle: {e}'
        print(f'native: the codec is unavailable, RPC sends pickle ({e})')
    return _state['codec']


def codec_status():
  """'native' when RPC frames go through the codec, else 'pickle: <why>'."""
  codec()
  return _state['status']
