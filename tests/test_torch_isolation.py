"""The port stands alone, runs on the card by default, and reads no TPU knob.

- Importing every module of `embodied_tpu_torch` in a fresh interpreter
  loads neither `jax` nor `embodied_tpu` nor `cloudpickle` nor
  `tensorflow` (the card's machine has none; workers get the standard
  pickle; the viewer reads traces with json); an AST scan of the package
  and of `chip_smoke.py` finds no import of any of them.
- No module of the port reads a TPU-specific condition: no `on_tpu`, no
  VMEM budget, no 128-lane alignment. The RSSM takes the kernel path at
  block widths and weight sizes the TPU gates refused.
- `make_agent` without a device asks for CUDA and raises without a card;
  with `device='cpu'` it acts, also through the `Driver`.
- The initializers keep JAX's fan and truncation semantics.
"""

import ast
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from embodied_tpu_torch import core, nn
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main, rssm
from embodied_tpu_torch.ops import blockgru, observe
from embodied_tpu_torch.utils import Space

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / 'embodied_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'embodied_tpu', 'cloudpickle', 'tensorflow')
SMALL = ['--task', 'dummy_disc',
         '--agent.dyn.rssm.deter', '64', '--agent.dyn.rssm.hidden', '32',
         '--agent.dyn.rssm.blocks', '4', '--agent.dyn.rssm.stoch', '4',
         '--agent.dyn.rssm.classes', '4', '--agent.enc.simple.depth', '4',
         '--agent.enc.simple.units', '16', '--agent.enc.simple.layers', '1',
         '--agent.policy.units', '16', '--agent.policy.layers', '1']


def sources():
  return sorted(PACKAGE.rglob('*.py')) + [ROOT / 'chip_smoke.py']


def module_names():
  names = []
  for path in sorted(PACKAGE.rglob('*.py')):
    parts = path.relative_to(ROOT).with_suffix('').parts
    names.append('.'.join(parts[:-1] if parts[-1] == '__init__' else parts))
  return names


def test_the_scans_cover_every_module_of_the_jax_package():
  """Each module of the JAX package has its counterpart in the port, and
  the import and AST scans below take each one (data/, nn/stacked.py and
  ops/ring_attention.py among them)."""
  jax_package = ROOT / 'embodied_tpu'
  ported = {p.relative_to(PACKAGE) for p in PACKAGE.rglob('*.py')}
  missing = sorted(str(p.relative_to(jax_package))
                   for p in jax_package.rglob('*.py')
                   if p.relative_to(jax_package) not in ported)
  assert not missing, missing
  names = module_names()
  for name in ('embodied_tpu_torch.data', 'embodied_tpu_torch.data.bag',
               'embodied_tpu_torch.nn.stacked',
               'embodied_tpu_torch.ops.ring_attention'):
    assert name in names, name
  assert {PACKAGE / 'data' / 'bag.py',
          PACKAGE / 'ops' / 'ring_attention.py'} <= set(sources())


def test_importing_the_port_loads_no_jax():
  script = (
      'import importlib, sys\n'
      f'for name in {module_names()!r}:\n'
      '  importlib.import_module(name)\n'
      f'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
      f'{FORBIDDEN!r})\n'
      'print(len(sys.modules), bad)\n'
      'sys.exit(1 if bad else 0)\n')
  proc = subprocess.run(
      [sys.executable, '-c', script], cwd=ROOT, capture_output=True,
      text=True, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize('path', sources(), ids=lambda p: p.name)
def test_no_source_imports_jax(path):
  tree = ast.parse(path.read_text(), str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names = [alias.name for alias in node.names]
    elif isinstance(node, ast.ImportFrom) and not node.level:
      names = [node.module or '']
    else:
      continue
    for name in names:
      assert name.split('.')[0] not in FORBIDDEN, (path, node.lineno, name)


def test_no_tpu_knobs():
  for path in sorted(PACKAGE.rglob('*.py')):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
      ident = (node.id if isinstance(node, ast.Name) else
               node.attr if isinstance(node, ast.Attribute) else
               node.name if isinstance(node, ast.FunctionDef) else '')
      assert ident != 'on_tpu' and 'vmem' not in ident.lower(), (
          path, node.lineno, ident)
      if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        assert not (isinstance(node.right, ast.Constant) and
                    node.right.value == 128), (path, node.lineno)


@pytest.mark.parametrize('deter,hidden,blocks', [
    (512, 64, 8),      # D/g = 64: the TPU gate's 128-lane condition refused
    (2048, 512, 2),    # 24 MB of bf16 core weights: over its 12 MB budget
])
def test_kernel_eligibility_is_structural(deter, hidden, blocks):
  act_space = {'action': Space(np.int32, (), 0, 5)}
  dyn = rssm.RSSM(act_space, token_dim=16, deter=deter, hidden=hidden,
                  stoch=4, classes=4, blocks=blocks, act='silu')
  assert dyn._kernel_eligible() and dyn._obs_kernel_eligible()
  for kw in (dict(kernel='off'), dict(absolute=True), dict(obslayers=2),
             dict(dynlayers=2), dict(act='gelu'), dict(norm='layer')):
    other = rssm.RSSM(act_space, token_dim=16, deter=64, hidden=16,
                      stoch=4, classes=4, blocks=4, **{'act': 'silu', **kw})
    assert not other._obs_kernel_eligible(), kw


def small_config(*extra):
  """SMALL on the host path: the policy returns its packed latents."""
  return common.assemble_config(
      main.CONFIGS, SMALL + ['--torch.latent_slots', '0'] + list(extra))


def test_make_agent_asks_for_cuda_by_default(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  config = small_config()
  assert config.torch.device == 'cuda'
  with pytest.raises(RuntimeError, match='CUDA'):
    main.make_agent(config)
  with pytest.raises(RuntimeError, match='CUDA'):
    main.make_agent(config, device='cuda')


def test_make_agent_on_the_cpu_acts():
  agent = main.make_agent(small_config(), device='cpu')
  assert agent.device == torch.device('cpu')
  assert all(p.device.type == 'cpu' for p in agent.model.parameters())
  launches = blockgru.core_step.launches, observe.obs_step.launches
  envs = [common.make_env(small_config(), i) for i in range(3)]
  rows = [env.step({'action': np.int32(0), 'reset': True}) for env in envs]
  obs = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
  carry, act, out = agent.policy(agent.init_policy(3), obs, 'eval')
  assert act['action'].dtype == np.int32 and act['action'].shape == (3,)
  assert out['dyn/deter'].dtype == np.int8
  assert out['dyn/deter'].shape == (3, 64)
  assert out['dyn/stoch'].dtype == np.uint8 and out['dyn/stoch'].shape == (
      3, 4)
  assert all(out[k].all() for k in out if k.startswith('log/finite/'))
  assert carry[1]['deter'].dtype == torch.bfloat16
  assert (blockgru.core_step.launches, observe.obs_step.launches) == launches


@pytest.mark.parametrize('parallel', [False, 'thread'])
def test_driver_runs_the_agent(parallel):
  config = small_config('--torch.compute_dtype', 'float32')
  agent = main.make_agent(config, device='cpu')
  envs = 4
  driver = core.Driver(
      [lambda i=i: common.make_env(config, i) for i in range(envs)],
      parallel=parallel, mode='train')
  driver.reset(agent.init_policy)
  seen = []
  driver.on_step(lambda row, i, **kw: seen.append((i, row, kw['mode'])))
  driver(agent.policy, steps=6 * envs)
  driver.close()
  assert len(seen) == 6 * envs
  assert agent._counters['policy'] == 6
  for i, row, mode in seen:
    assert mode == 'train' and 0 <= row['action'] < 5
    assert row['log/finite/tokens'] and row['log/finite/act/action']
    assert row['dyn/deter'].shape == (64,)
  # Fresh generators per call: the same carry and inputs, two draws.
  obs = {k: np.stack([r[k] for _, r, _ in seen[-envs:]]) for k in (
      'image', 'vector', 'token', 'count', 'reward', 'is_first', 'is_last',
      'is_terminal')}
  carry = agent.init_policy(envs)
  draws = [agent.policy(carry, obs)[2]['dyn/stoch'] for _ in range(3)]
  assert any((draws[0] != d).any() for d in draws[1:])


@pytest.mark.parametrize('spec,shape', [
    ('trunc_normal_in', (512, 256)), ('normal_out', (256, 512)),
    ('uniform_avg', (3, 3, 16, 32)), ('trunc_normal_in', (4, 64, 48))])
def test_initializer_fans_and_truncation(spec, shape):
  init = nn.Initializer.parse(spec, 0.5)
  value = init(torch.Generator().manual_seed(0), shape)
  fan_in, fan_out = init._fans(shape)
  fan = {'in': fan_in, 'out': fan_out,
         'avg': (fan_in + fan_out) / 2}[init.fan]
  std = math.sqrt(0.5 / fan)
  # 131072 draws or more: the sample std is within 1% of its expectation.
  assert abs(float(value.std()) / std - 1) < 0.01, (float(value.std()), std)
  if init.dist == 'trunc_normal':
    assert float(value.abs().max()) <= 2 * std / 0.87962566 + 1e-6
  if init.dist == 'uniform':
    assert float(value.abs().max()) <= math.sqrt(3) * std + 1e-6
  assert torch.equal(init(torch.Generator().manual_seed(0), shape), value)
  assert not nn.Initializer.parse('zeros')(None, shape).any()


def test_init_params_depends_on_path_not_order():
  a = nn.Linear(6, 5, 'a', cdtype=torch.float32)
  b = nn.Linear(6, 5, 'b', cdtype=torch.float32)
  roots = []
  for order in ((a, b), (b, a)):
    root = torch.nn.Module()
    for m in order:
      root.add_module(m.name, type(m)(6, 5, m.name))
    nn.init_params(root, seed=3)
    roots.append(nn.store(root))
  assert roots[0].keys() == roots[1].keys()
  for path in roots[0]:
    assert torch.equal(roots[0][path], roots[1][path]), path
  assert not torch.equal(roots[0]['a/kernel'], roots[0]['b/kernel'])
