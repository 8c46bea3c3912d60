"""The ('d','f','t') mesh and regex partition rules: the counterpart of
embodied_tpu/parallel/meshes.py.

A spec 'd,f,t' lays the world's ranks out as the JAX package lays out its
devices: -1 takes the remainder, and a fixed spec may take the first
d * f * t ranks only. Batches are split over ('d','f'): `data_group` is
the process group of the ranks that share this rank's 't' coordinate, and
`nbatch` its size. Ranks that share a ('d','f') coordinate (along 't')
compute the same rows, and split the products whose weights the
placements shard over 't' (`split_paths`, parallel/tensor.py) over their
`t_group`, as GSPMD splits them on the JAX mesh.

`resolve_rules` gives each store path its placement as the JAX package's
`PartitionSpec` entries: a tuple of axis names (or tuples of them) and
None, () where replicated. The Agent applies them: between calls each rank
holds only its slice of every sharded entry, as the JAX mesh places the
array's shards on its devices. `Shards` is the geometry of one store's
placements on this rank: for each sharded entry the shard group (the
ranks along the placement's axes that share this rank's other
coordinates), this rank's index in it (axes listed together, such as
('f','t'), count first-axis-major: f-major, t-minor, as `P(('f','t'))`
lays the devices out), the local shape and slice; and the gather that
puts the slices back into full tensors, one all-gather per shard group.
"""

import re

import numpy as np
import torch
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
  t_group: the group of the ranks along 't' that share this rank's
    ('d','f'), in 't' order, where t > 1 (else None): the rows'
    broadcast and the split products' collectives go over it.
  t_index, t_count: this rank's index along 't' and the ranks there.
  data_index: this rank's index over ('d','f') (0 without a group).
  coords: this rank's (d, f, t) coordinate (None outside the mesh)."""

  def __init__(self, sizes, world):
    self.shape = dict(zip(AXES, sizes))
    self.ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
    self.nbatch = sizes[0] * sizes[1]
    self.device_mesh = None
    self.data_group = None
    self.t_group = None
    self.t_count = sizes[2]
    self.t_index = 0
    self.data_index = 0
    self.coords = (0, 0, 0)
    self._groups = {}
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
          self.t_group = group
    where = np.argwhere(self.ranks == rank)
    self.data_index = (int(where[0][0] * sizes[1] + where[0][1])
                       if len(where) else None)
    self.coords = tuple(int(x) for x in where[0]) if len(where) else None
    self.t_index = self.coords[2] if self.coords else 0
    self._groups = {}

  def members(self, axes, coords=None):
    """The ranks along `axes` (a tuple of axis names) that share the other
    coordinates of `coords` (default: this rank's), first axis major."""
    coords = self.coords if coords is None else coords
    index = tuple(slice(None) if a in axes else coords[i]
                  for i, a in enumerate(AXES))
    sub = self.ranks[index]  # The axes in AXES order.
    order = [a for a in AXES if a in axes]
    sub = np.transpose(sub, [order.index(a) for a in axes])
    return sub.reshape(-1).tolist()

  def group(self, axes):
    """The process group of `members(axes)` (None without a process
    group). The first call for `axes` makes every such group of the mesh,
    so every rank must make the same calls in the same order (as Shards
    does from the placements)."""
    axes = tuple(axes)
    if not dist.is_initialized():
      return None
    if axes not in self._groups:
      rest = [i for i, a in enumerate(AXES) if a not in axes]
      mine = None
      for other in np.ndindex(*[self.sizes[i] for i in rest]):
        coords = [0, 0, 0]
        for i, c in zip(rest, other):
          coords[i] = c
        members = self.members(axes, coords)
        group = dist.new_group(members)
        if self.rank in members:
          mine = group
      self._groups[axes] = mine
    return self._groups[axes]

  @property
  def rank(self):
    return dist.get_rank() if dist.is_initialized() else 0

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


def split_paths(placements, mesh):
  """The store paths whose products split over 't' (parallel/tensor.py):
  the kernels and embeddings whose placement shards their last dimension
  over axes that name 't', on a mesh with t > 1. An axis that the
  placement dropped (it does not divide the dimension) leaves the entry
  whole, as in JAX."""
  if mesh.shape['t'] < 2:
    return frozenset()
  paths = set()
  for path, spec in placements.items():
    dim = sharded_dim(spec)
    if (path.rsplit('/', 1)[-1] in ('kernel', 'embed') and
        dim == len(spec) - 1 and 't' in spec_axes(spec[dim])):
      paths.add(path)
  return frozenset(paths)


def sharded_dim(spec):
  """The one dimension that `spec` (a resolved placement) shards, or None
  where it is replicated."""
  dims = [i for i, entry in enumerate(spec) if entry is not None]
  assert len(dims) <= 1, f'more than one sharded dimension: {spec}'
  return dims[0] if dims else None


def spec_axes(entry):
  """A placement entry ('f' or ('f','t')) as a tuple of axis names."""
  return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Shards:
  """This rank's slices of the entries that `placements` shard on `mesh`.

  shapes: {path: full shape} of the store. For each sharded path:
  `dims[path]` the sharded dimension, `axes[path]` its mesh axes, and
  `index[path]`, `count[path]` this rank's position among the shard
  group's members and their number. The groups are made in sorted order
  of their axes, by every rank alike."""

  def __init__(self, shapes, placements, mesh):
    self.mesh = mesh
    self.shapes = {k: tuple(v) for k, v in shapes.items()}
    self.dims, self.axes, self.index, self.count = {}, {}, {}, {}
    for path in sorted(placements):
      dim = sharded_dim(placements[path])
      if dim is None:
        continue
      axes = spec_axes(placements[path][dim])
      members = mesh.members(axes)
      self.dims[path] = dim
      self.axes[path] = axes
      self.count[path] = len(members)
      self.index[path] = members.index(mesh.rank)
    self.groups = {axes: mesh.group(axes)
                   for axes in sorted(set(self.axes.values()))}

  @property
  def paths(self):
    return sorted(self.dims)

  def __bool__(self):
    return bool(self.dims)

  def local_shape(self, path):
    shape = list(self.shapes[path])
    if path in self.dims:
      shape[self.dims[path]] //= self.count[path]
    return tuple(shape)

  def local(self, path, full):
    """This rank's slice of the full tensor `full`, in storage of its
    own (so that the full tensor's is freed with it)."""
    if path not in self.dims:
      return full
    dim, n = self.dims[path], self.shapes[path][self.dims[path]]
    size = n // self.count[path]
    part = full.narrow(dim, self.index[path] * size, size)
    return part.clone(memory_format=torch.contiguous_format)

  def gather(self, slices):
    """{path: full tensor} of {path: this rank's slice} (sharded paths):
    per shard group and dtype one all-gather of the slices packed flat in
    sorted path order, then each entry's slices joined along its
    dimension in shard order. Every rank of a group gathers the same
    paths."""
    buckets = {}
    for path in sorted(slices):
      key = (self.axes[path], str(slices[path].dtype))
      buckets.setdefault(key, []).append(path)
    out = {}
    for (axes, _), paths in sorted(buckets.items()):
      parts = [slices[p].contiguous().reshape(-1) for p in paths]
      packed = torch.cat(parts) if len(parts) > 1 else parts[0]
      gathered = [torch.empty_like(packed)
                  for _ in range(self.count[paths[0]])]
      dist.all_gather(gathered, packed, group=self.groups[axes])
      offset = 0
      for path, part in zip(paths, parts):
        shape = slices[path].shape
        out[path] = torch.cat(
            [chunk[offset:offset + part.numel()].view(shape)
             for chunk in gathered], self.dims[path])
        offset += part.numel()
      del gathered
    return out

  def nbytes(self, dtypes):
    """The bytes one rank holds of a store with entries of `dtypes`
    ({path: torch dtype}) under these placements."""
    total = 0
    for path, shape in self.shapes.items():
      size = torch.empty((), dtype=dtypes[path]).element_size()
      total += int(np.prod(self.local_shape(path), dtype=np.int64)) * size
    return total
