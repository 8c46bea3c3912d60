"""The ('d','f','t') mesh and regex partition rules: the counterpart of
embodied_tpu/parallel/meshes.py.

A spec 'd,f,t' lays the world's ranks out as the JAX package lays out its
devices: -1 takes the remainder, and a fixed spec may take the first
d * f * t ranks only. Batches are split over ('d','f'): `data_group` is
the process group of the ranks that share this rank's 't' coordinate, and
`nbatch` its size. Ranks that share a ('d','f') coordinate (along 't')
are replicas that compute the same rows.

`resolve_rules` gives each store path its placement as the JAX package's
`PartitionSpec` entries: a tuple of axis names (or tuples of them) and
None, () where replicated. In this slice every rank holds the whole
store, so the placements say where a sharded store would put each entry;
they do not change what a step computes.
"""

import re

import numpy as np
import torch.distributed as dist

AXES = ('d', 'f', 't')


class Mesh:
  """The mesh's axis sizes over the world's ranks.

  shape: {'d': d, 'f': f, 't': t}.
  ranks: int array (d, f, t), the rank at each coordinate.
  device_mesh: a torch DeviceMesh with dims ('d','f','t') where the world
    has more than one rank, else None.
  data_group: the ('d','f') group of this rank's 't' (the default group
    on a world of one); None without a process group or where this rank
    lies outside the mesh.
  replica_group: the ranks along 't' that share this rank's ('d','f'),
    where t > 1.
  data_index: this rank's index over ('d','f') (0 without a group)."""

  def __init__(self, sizes, world):
    self.shape = dict(zip(AXES, sizes))
    self.ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
    self.nbatch = sizes[0] * sizes[1]
    self.device_mesh = None
    self.data_group = None
    self.replica_group = None
    self.data_index = 0
    if not dist.is_initialized():
      return
    if world == 1:
      self.data_group = dist.group.WORLD
      return
    from torch.distributed.device_mesh import DeviceMesh
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    self.device_mesh = DeviceMesh(
        device_type, self.ranks, mesh_dim_names=AXES)
    rank = dist.get_rank()
    # Every rank makes every group, in the same order.
    for t in range(sizes[2]):
      group = dist.new_group(self.ranks[:, :, t].reshape(-1).tolist())
      if rank in self.ranks[:, :, t]:
        self.data_group = group
    if sizes[2] > 1:
      for members in self.ranks.reshape(self.nbatch, sizes[2]).tolist():
        group = dist.new_group(members)
        if rank in members:
          self.replica_group = group
    where = np.argwhere(self.ranks == rank)
    self.data_index = (int(where[0][0] * sizes[1] + where[0][1])
                       if len(where) else None)

  @property
  def size(self):
    return self.ranks.size

  @property
  def sizes(self):
    return tuple(self.shape[a] for a in AXES)


def world_size():
  return dist.get_world_size() if dist.is_initialized() else 1


def mesh_sizes(spec='-1,1,1', world=None):
  """The (d, f, t) sizes of a 'd,f,t' spec over `world` ranks (default:
  the process group's, else 1); -1 is the remainder."""
  world = world_size() if world is None else int(world)
  sizes = [int(x) for x in str(spec).split(',')]
  assert len(sizes) == 3, spec
  known = int(np.prod([x for x in sizes if x > 0]))
  sizes = tuple(world // known if x == -1 else x for x in sizes)
  assert int(np.prod(sizes)) <= world, (spec, world, sizes)
  return sizes


def make_mesh(spec='-1,1,1', world=None):
  """The ('d','f','t') mesh of a 'd,f,t' spec (see mesh_sizes). A mesh
  over a world of more than one rank makes process groups, so every rank
  of the world must make it, in the same order."""
  world = world_size() if world is None else int(world)
  return Mesh(mesh_sizes(spec, world), world)


def data_group(mesh):
  """The process group over the mesh's ('d','f') axes that holds this
  rank, or None without a process group."""
  return mesh.data_group


def resolve_rules(shapes, rules, mesh):
  """Each store path's placement from first-match regex rules, as
  embodied_tpu/parallel/meshes.py resolves them.

  `shapes` maps path -> shape (or anything with a `.shape`). `rules` is a
  sequence of (pattern, spec), spec a tuple of axis names, None or tuples
  of names. Specs shorter than the rank are right-aligned; an axis whose
  extent does not divide the dimension is dropped (replicated); paths that
  match no rule are replicated (); optimizer slots named
  '<opt>/rms.<dotted-param-path>' or '<opt>/mom.<...>' take their
  parameter's rule."""
  compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
  placements = {}
  for path, shape in shapes.items():
    shape = tuple(getattr(shape, 'shape', shape))
    lookup = path
    m = re.match(r'^.*/(?:rms|mom)\.(.+)$', path)
    if m:
      lookup = m.group(1).replace('.', '/')
    spec = None
    for pattern, pspec in compiled:
      if pattern.search(lookup):
        spec = pspec
        break
    placements[path] = _fit_spec(spec, shape, mesh.shape)
  return placements


def _fit_spec(spec, shape, axis_sizes):
  if not spec or not shape:
    return ()
  spec = tuple(spec)[-len(shape):]
  spec = (None,) * (len(shape) - len(spec)) + spec  # Right-align.
  fitted = []
  for dim, entry in zip(shape, spec):
    if entry is None:
      fitted.append(None)
      continue
    axes = entry if isinstance(entry, (tuple, list)) else (entry,)
    extent = int(np.prod([axis_sizes[a] for a in axes]))
    if extent > 1 and dim % extent == 0:
      fitted.append(tuple(axes) if len(axes) > 1 else axes[0])
    else:
      fitted.append(None)
  return tuple(fitted)
