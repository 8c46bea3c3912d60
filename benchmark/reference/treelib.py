"""Nested dict/tuple tree utilities (map, flatdict, nestdict, leaves).

A frozen copy of the port's utils/treelib.py.
"""


def tree_map(fn, *trees, isleaf=None):
  assert trees, 'Provide one or more nested structures'
  first = trees[0]
  if isleaf and isleaf(first):
    return fn(*trees)
  if isinstance(first, dict):
    keys = first.keys()
    assert all(set(t.keys()) == set(keys) for t in trees[1:]), trees
    return {k: tree_map(fn, *(t[k] for t in trees), isleaf=isleaf)
            for k in keys}
  if isinstance(first, (list, tuple)):
    assert all(len(t) == len(first) for t in trees[1:]), trees
    mapped = [tree_map(fn, *xs, isleaf=isleaf) for xs in zip(*trees)]
    return type(first)(mapped)
  return fn(*trees)


def flatdict(tree, sep='/', prefix=''):
  """Flatten a nested dict into {'a/b/c': leaf}."""
  result = {}
  if isinstance(tree, dict):
    for key, value in tree.items():
      path = f'{prefix}{sep}{key}' if prefix else str(key)
      if isinstance(value, dict):
        result.update(flatdict(value, sep, path))
      else:
        result[path] = value
  else:
    result[prefix] = tree
  return result


def nestdict(flat, sep='/'):
  """Unflatten {'a/b/c': leaf} into nested dicts."""
  result = {}
  for path, value in flat.items():
    parts = path.split(sep)
    node = result
    for part in parts[:-1]:
      node = node.setdefault(part, {})
    node[parts[-1]] = value
  return result


def leaves(tree):
  if isinstance(tree, dict):
    out = []
    for key in sorted(tree.keys()):
      out.extend(leaves(tree[key]))
    return out
  if isinstance(tree, (list, tuple)):
    out = []
    for value in tree:
      out.extend(leaves(value))
    return out
  return [tree]
