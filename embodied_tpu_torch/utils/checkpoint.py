"""Checkpoint orchestrator: attach objects as attributes, load_or_save().

A copy of embodied_tpu/utils/checkpoint.py.

Capability parity: elements.Checkpoint as used in
the reference's embodied/run/train.py:82-89. Each attached object must
provide save() -> data and load(data). Writes are atomic (tmp + rename).
"""

import pickle
import time

from . import path as pathlib
from . import printing


class Checkpoint:

  def __init__(self, filename=None, log=True, parallel=True):
    self._filename = pathlib.Path(filename) if filename else None
    self._log = log
    self._values = {}
    self._loaded = False

  def __setattr__(self, name, value):
    if name.startswith('_'):
      super().__setattr__(name, value)
      return
    has_save = hasattr(value, 'save') and callable(value.save)
    has_load = hasattr(value, 'load') and callable(value.load)
    assert has_save and has_load, (
        f'Checkpoint attribute {name!r} must define save() and load()')
    self._values[name] = value

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    try:
      return self._values[name]
    except KeyError:
      raise AttributeError(name)

  def exists(self, filename=None):
    filename = pathlib.Path(filename) if filename else self._filename
    return bool(filename) and filename.exists()

  def save(self, filename=None, keys=None):
    filename = pathlib.Path(filename) if filename else self._filename
    assert filename, 'Checkpoint needs a filename to save'
    keys = tuple(self._values.keys()) if keys is None else tuple(keys)
    if self._log:
      printing.print_(f'Saving checkpoint: {filename}')
    start = time.time()
    data = {'_timestamp': time.time()}
    for key in keys:
      data[key] = self._values[key].save()
    filename.parent.mkdir()
    filename.write_bytes(pickle.dumps(data))
    if self._log:
      printing.print_(f'Saved checkpoint in {time.time() - start:.2f}s')

  def load(self, filename=None, keys=None):
    filename = pathlib.Path(filename) if filename else self._filename
    assert filename, 'Checkpoint needs a filename to load'
    if self._log:
      printing.print_(f'Loading checkpoint: {filename}')
    start = time.time()
    data = pickle.loads(filename.read_bytes())
    keys = [k for k in (keys or self._values.keys()) if not k.startswith('_')]
    for key in keys:
      if key in data:
        self._values[key].load(data[key])
      else:
        printing.print_(f'Checkpoint misses key {key!r}; skipping')
    self._loaded = True
    if self._log:
      printing.print_(f'Loaded checkpoint in {time.time() - start:.2f}s')

  def load_or_save(self):
    if self.exists():
      self.load()
      return True
    self.save()
    return False
