"""Carries weights from the JAX package to the port.

A JAX store ({path: array}, as `embodied_tpu` Agent.save()['store'] gives
it, or as `nn.init` returns it) already has the port's paths, shapes and
layouts, so carrying it over is a dtype conversion: floating arrays become
float32 numpy arrays (bfloat16 included), other arrays pass unchanged.
"""

import numpy as np


def from_jax(store):
  """{path: array-like} -> {path: np.ndarray}, floats as float32."""
  out = {}
  for path, value in store.items():
    value = np.asarray(value)
    if value.dtype.kind in 'fV' or value.dtype.name == 'bfloat16':
      value = value.astype(np.float32)
    out[path] = value
  return out
