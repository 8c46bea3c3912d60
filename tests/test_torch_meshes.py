"""The port's ('d','f','t') mesh and partition rules against the JAX
package's (embodied_tpu/parallel/meshes.py).

- `make_mesh` lays 8 ranks out as JAX lays out the conftest's 8 virtual
  CPU devices: the same axis sizes and the same rank (device id) at each
  coordinate, for the remainder (-1), full and subset specs.
- `resolve_rules` gives every store path of the debug-size DreamerV3, PPO
  and Director the placement that JAX's NamedSharding has, entry for
  entry, on the '4,2,1' and '2,2,2' meshes: the JAX store's shapes under
  the JAX model's rules against the port's store under the port's.
"""

import importlib
import pathlib

import numpy as np
import pytest

from embodied_tpu.models import common as jcommon
from embodied_tpu.parallel import meshes as jmeshes
from embodied_tpu_torch import nn
from embodied_tpu_torch.models import common
from embodied_tpu_torch.parallel import meshes

WORLD = 8
SPECS = ['-1,1,1', '4,2,1', '2,2,2', '1,-1,2', '2,1,1']
ARGV = ['--configs', 'debug', '--task', 'dummy_disc', '--batch_size', '8',
        '--logdir', '/nonexistent']
STORES = {}


def stores(family):
  """(JAX store shapes, JAX rules, port store shapes, port rules) of the
  family's debug configuration, made once."""
  if family not in STORES:
    jmain = importlib.import_module(f'embodied_tpu.models.{family}.main')
    config = jcommon.assemble_config(
        str(pathlib.Path(jmain.__file__).with_name('configs.yaml')),
        ARGV + ['--jax.mesh', '1,1,1', '--jax.precompile', 'False'])
    jagent = jmain.make_agent(config)
    main = importlib.import_module(
        f'embodied_tpu_torch.models.{family}.main')
    agent = main.make_agent(
        common.assemble_config(main.CONFIGS, ARGV), device='cpu')
    STORES[family] = (
        {k: v.shape for k, v in jagent.store.items()},
        jagent.model.partition_rules,
        {k: tuple(v.shape) for k, v in nn.store(agent.model).items()},
        agent.model.partition_rules)
  return STORES[family]


@pytest.mark.parametrize('spec', SPECS)
def test_mesh_matches_jax(spec):
  want = jmeshes.make_mesh(spec)
  assert len(want.devices.reshape(-1)) <= WORLD
  got = meshes.make_mesh(spec, world=WORLD)
  assert got.sizes == want.devices.shape
  assert got.shape == dict(want.shape)
  assert got.nbatch == want.devices.shape[0] * want.devices.shape[1]
  np.testing.assert_array_equal(
      got.ranks, np.vectorize(lambda d: d.id)(want.devices))


@pytest.mark.parametrize('family', ['dreamerv3', 'ppo', 'director'])
@pytest.mark.parametrize('spec', ['4,2,1', '2,2,2'])
def test_placements_match_jax(family, spec):
  jshapes, jrules, shapes, rules = stores(family)
  assert rules == jrules
  assert sorted(shapes) == sorted(jshapes)
  want = jmeshes.resolve_rules(jshapes, jrules, jmeshes.make_mesh(spec))
  got = meshes.resolve_rules(
      shapes, rules, meshes.make_mesh(spec, world=WORLD))
  assert sorted(got) == sorted(want)
  sharded = 0
  for path, sharding in want.items():
    assert got[path] == tuple(sharding.spec), path
    sharded += any(entry is not None for entry in got[path])
  assert sharded, 'no entry is sharded on this mesh'
