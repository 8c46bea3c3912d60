"""What the benchmark may import: nothing whose top-level name is `jax`,
`jaxlib`, `flax` or `embodied_tpu` (the JAX package; compared as a whole
name, since the port's name begins with it), and, in the reference,
nothing of the program either. Checked on the sources, and on the
modules that a process holds once it has imported the harness; the card
test runs a short cell and reads the modules its run held."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from benchmark.harness import device as devicelib

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / 'benchmark'
SOURCES = sorted(p for p in BENCH.rglob('*.py') if '__pycache__' not in
                 p.parts)


def imports(path):
  """The top-level names that a file imports (absolute imports)."""
  tree = ast.parse(path.read_text())
  out = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      out.update(alias.name.split('.')[0] for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and not node.level:
      out.add(node.module.split('.')[0])
  return out


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
  assert not imports(path) & set(devicelib.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
  for path in (BENCH / 'reference').rglob('*.py'):
    names = imports(path)
    assert 'embodied_tpu_torch' not in names, path
    assert names <= {'torch', 'numpy', 'math', 're', 'threading',
                     'contextlib'}, (
        path, names)


def test_the_names_compare_whole():
  found = devicelib.forbidden_modules({
      'embodied_tpu_torch': 1, 'embodied_tpu_torch.nn': 1, 'jaxtyping': 1,
      'jax': 1, 'embodied_tpu.nn': 1, 'flax.linen': 1})
  assert found == ['embodied_tpu.nn', 'flax.linen', 'jax']


def test_a_process_with_the_harness_holds_no_jax():
  code = ('import sys; sys.path.insert(0, %r);'
          'import benchmark.run, benchmark.control;'
          'from benchmark.harness import learn, script, port;'
          'port.Program({"package": "embodied_tpu_torch.models.dreamerv3"});'
          'from benchmark.harness import device;'
          'print(device.forbidden_modules())') % str(ROOT)
  proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                        text=True, timeout=300, cwd=ROOT)
  assert proc.returncode == 0, proc.stderr[-2000:]
  assert proc.stdout.strip().splitlines()[-1] == '[]'


@pytest.mark.cuda
def test_a_short_run_on_the_card_holds_no_jax():
  if not torch.cuda.is_available():
    pytest.skip('Needs a CUDA card: the run measures the port there')
  proc = subprocess.run(
      [sys.executable, str(BENCH / 'run.py'), '--workload', 'dv3_200m.learn',
       '--seed', '77', '--seconds', '2', '--trace', '0'],
      capture_output=True, text=True, timeout=900, cwd=ROOT)
  assert proc.returncode == 0, proc.stderr[-4000:]
  result = json.loads(proc.stdout.strip().splitlines()[-1])
  assert result['device']['platform'] == 'gpu'
