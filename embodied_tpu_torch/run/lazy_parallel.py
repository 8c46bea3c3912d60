"""Lazy loader for the distributed actor-learner protocol (the port of
embodied_tpu/run/lazy_parallel.py)."""


def __getattr__(name):
  from . import parallel_impl
  return getattr(parallel_impl, name)
