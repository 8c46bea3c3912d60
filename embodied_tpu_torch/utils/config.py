"""Immutable nested config with dotted access and regex bulk updates.

A copy of embodied_tpu/utils/config.py (size presets in configs.yaml use
regex keys), with pathlib in place of the JAX package's path helper.
"""

import io
import json
import pathlib
import re

import numpy as np


class Config(dict):
  """Immutable nested dict. Access via config['a']['b'], config['a.b'], or
  config.a.b. Updates return new configs; regex keys fan out over matching
  dotted paths; update values must match existing types."""

  SEP = '.'
  IS_PATTERN = re.compile(r'.*[^A-Za-z0-9_.-].*')

  def __init__(self, *args, **kwargs):
    mapping = dict(*args, **kwargs)
    mapping = self._flatten(mapping)
    mapping = self._ensure_values(mapping)
    super().__init__(self._nest(mapping))

  @property
  def flat(self):
    return self._flatten(dict(self))

  def save(self, path):
    path = pathlib.Path(path)
    if str(path).endswith('.json'):
      path.write_text(json.dumps(dict(self), indent=2, default=_jsonable))
    elif str(path).endswith(('.yml', '.yaml')):
      import yaml
      path.write_text(yaml.safe_dump(_plain(dict(self))))
    else:
      raise NotImplementedError(str(path))

  @classmethod
  def load(cls, path):
    path = pathlib.Path(path)
    text = path.read_text()
    if str(path).endswith('.json'):
      return cls(json.loads(text))
    if str(path).endswith(('.yml', '.yaml')):
      import yaml
      return cls(yaml.safe_load(io.StringIO(text)))
    raise NotImplementedError(str(path))

  def __getattr__(self, name):
    if name.startswith('_'):
      raise AttributeError(name)
    try:
      return self[name]
    except KeyError:
      raise AttributeError(name)

  def __getitem__(self, name):
    node = dict(self)
    for part in str(name).split(self.SEP):
      if not isinstance(node, dict) or part not in node:
        raise KeyError(f'Key {name!r} not found in config')
      node = node[part]
    if isinstance(node, dict) and not isinstance(node, Config):
      return type(self)(node)
    return node

  def __contains__(self, name):
    try:
      self[name]
      return True
    except KeyError:
      return False

  def __reduce__(self):
    # dict subclasses pickle via item insertion by default, which our
    # immutability guard blocks; rebuild through the constructor instead.
    return (type(self), (dict(self),))

  def __setitem__(self, key, value):
    raise TypeError('Config is immutable; use update()')

  def __delitem__(self, key):
    raise TypeError('Config is immutable; use update()')

  def update(self, *args, **kwargs):
    inputs = self._flatten(dict(*args, **kwargs))
    flat = self.flat
    for key, new in inputs.items():
      if self.IS_PATTERN.match(key):
        pattern = re.compile(key)
        keys = [k for k in flat if pattern.fullmatch(k) or pattern.match(k)]
        if not keys:
          raise KeyError(f'Pattern {key!r} matched no config keys')
      elif key in flat:
        keys = [key]
      else:
        # Allow assigning a subtree with a dict value.
        prefix = key + self.SEP
        keys = [k for k in flat if k.startswith(prefix)]
        if not keys:
          raise KeyError(f'Key {key!r} not found in config')
        raise KeyError(
            f'Key {key!r} refers to a subtree; assign its leaves instead')
      for k in keys:
        flat[k] = self._cast_like(flat[k], new, k)
    return type(self)(flat)

  @classmethod
  def _cast_like(cls, old, new, key):
    if isinstance(old, bool):
      if isinstance(new, str):
        if new.lower() in ('true', '1', 'yes'):
          return True
        if new.lower() in ('false', '0', 'no'):
          return False
        raise TypeError(f'Cannot parse {new!r} as bool for key {key!r}')
      return bool(new)
    if isinstance(old, int) and not isinstance(old, bool):
      value = float(new) if isinstance(new, str) else new
      if float(value) != int(float(value)):
        raise TypeError(f'Cannot assign {new!r} to int key {key!r}')
      return int(float(value))
    if isinstance(old, float):
      return float(new)
    if isinstance(old, str):
      return str(new)
    if isinstance(old, (tuple, list)):
      if isinstance(new, str):
        new = [x for x in re.split(r'[,\s]+', new.strip('[]() ')) if x]
      if old and len(new):
        new = [cls._cast_like(old[0], x, key) for x in new]
      else:
        new = list(new)
      return tuple(new)
    if old is None:
      return new
    return new

  @classmethod
  def _flatten(cls, mapping, prefix=''):
    result = {}
    for key, value in mapping.items():
      path = f'{prefix}{cls.SEP}{key}' if prefix else str(key)
      if isinstance(value, dict) and value:
        result.update(cls._flatten(value, path))
      else:
        result[path] = value
    return result

  @classmethod
  def _nest(cls, flat):
    result = {}
    for path, value in flat.items():
      parts = path.split(cls.SEP)
      node = result
      for part in parts[:-1]:
        node = node.setdefault(part, {})
      node[parts[-1]] = value
    return result

  SCI_NOTATION = re.compile(r'^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$')

  @classmethod
  def _ensure_values(cls, flat):
    result = {}
    for key, value in flat.items():
      if isinstance(value, list):
        value = tuple(value)
      if isinstance(value, str) and cls.SCI_NOTATION.match(value):
        # YAML parses '1e-8' as a string; treat it as the float it means.
        value = float(value)
      result[key] = value
    return result

  def __repr__(self):
    lines = ['Config:']
    for key, value in sorted(self.flat.items()):
      lines.append(f'  {key}: {value}')
    return '\n'.join(lines)


def _plain(obj):
  if isinstance(obj, dict):
    return {k: _plain(v) for k, v in obj.items()}
  if isinstance(obj, tuple):
    return [_plain(v) for v in obj]
  if isinstance(obj, (np.integer,)):
    return int(obj)
  if isinstance(obj, (np.floating,)):
    return float(obj)
  return obj


def _jsonable(obj):
  if isinstance(obj, (np.integer,)):
    return int(obj)
  if isinstance(obj, (np.floating,)):
    return float(obj)
  if isinstance(obj, tuple):
    return list(obj)
  raise TypeError(type(obj))


class Flags:
  """CLI parser over a Config schema: --key value overrides, with support for
  nested keys, regex keys, and lists. parse_known returns leftover args."""

  def __init__(self, config):
    assert isinstance(config, Config)
    self._config = config

  def parse(self, argv=None):
    parsed, remaining = self.parse_known(argv)
    if remaining:
      raise ValueError(f'Unknown flags: {remaining}')
    return parsed

  def parse_known(self, argv=None):
    import sys
    if argv is None:
      argv = sys.argv[1:]
    updates = {}
    remaining = []
    key = None
    vals = None
    def flush():
      if key is None:
        return
      if not vals:
        updates[key] = 'True'
      elif len(vals) == 1:
        updates[key] = vals[0]
      else:
        updates[key] = tuple(vals)
    for arg in argv:
      if arg.startswith('--'):
        flush()
        key = arg[2:]
        vals = []
        if '=' in key:
          key, value = key.split('=', 1)
          updates[key] = value
          key, vals = None, None
      elif key is not None:
        vals.append(arg)
      else:
        remaining.append(arg)
    flush()
    config = self._config
    for k, v in updates.items():
      try:
        config = config.update({k: v})
      except KeyError:
        # Unknown keys flow through to the caller (e.g. later parse stages).
        remaining.append(f'--{k}')
        if isinstance(v, tuple):
          remaining.extend(str(x) for x in v)
        elif v != 'True':
          remaining.append(str(v))
    return config, remaining
