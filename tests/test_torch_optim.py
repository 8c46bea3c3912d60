"""The optimizer's update (ops/optim.py) on the CPU: its plain version
against a statement of the same update in numpy, in both slot layouts,
and the segment table that the kernel pair reads, built from CPU tensors
without a launch. The kernels themselves run on the card only
(chip_smoke.py, phase optim).

The numpy statement computes in float64 on the float32 values of the
settings, so the plain version (float32) agrees with it to RTOL by norm
over each leaf (each float32 operation rounds at 6e-8).
"""

import functools
import re

import numpy as np
import pytest
import torch

from embodied_tpu_torch import nn
from embodied_tpu_torch.ops import optim

SHAPES = {'m/lin/bias': (3,), 'm/lin/kernel': (4, 3), 'm/norm/scale': (5,),
          'm/out/kernel': (6, 2)}
BASE = dict(lr=1e-2, agc=0.3, eps=1e-20, beta1=0.9, beta2=0.999,
            momentum=True, nesterov=False, wd=0.0, wdregex=r'/kernel$',
            schedule='const', warmup=0, pmin=1e-3, scaling=False)
CASES = {
    'plain': {},
    'wd': dict(wd=0.1),
    'nesterov': dict(nesterov=True),
    'no_momentum': dict(momentum=False),
    'scaling': dict(scaling=True),
    'overflow': dict(scaling=True, wd=0.1),
}
STEPS = 3
RTOL = 1e-5
OVERFLOW_STEP = 1  # the overflow case plants an inf in this step's gradient


def make(fused, settings, seed=0):
  rng = np.random.default_rng(seed)
  init = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
  params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
  return nn.Optimizer(params, 'opt', fused=fused, **settings), init, rng


def slots(opt, kind):
  """{path: the leaf's `kind` moment as numpy} in either layout."""
  out, offset = {}, 0
  for path, param in opt.params.items():
    n = param.numel()
    if opt.fused:
      flat = getattr(opt, f'{kind}_flat')
      out[path] = flat[offset:offset + n].reshape(param.shape).numpy()
    else:
      out[path] = opt.slot(kind, path).numpy()
    offset += n
  return out


class Numpy:
  """The update stated leaf by leaf in float64: the loss scale's check,
  AGC, the RMS and momentum moments with bias correction, weight decay
  on the leaves whose path matches, and the constant learning rate."""

  def __init__(self, settings, init):
    # The constants as the float32 the plain version computes with.
    self.s = {k: float(np.float32(v)) if isinstance(v, float) else v
              for k, v in settings.items()}
    for k in ('beta1', 'beta2'):
      self.s[f'1-{k}'] = float(np.float32(1 - settings[k]))
    self.params = {k: v.astype(np.float64) for k, v in init.items()}
    self.nu = {k: np.zeros_like(v) for k, v in self.params.items()}
    self.mu = {k: np.zeros_like(v) for k, v in self.params.items()}
    self.step, self.scale, self.good = 0, 1e4, 0

  def __call__(self, grads):
    s, t = self.s, self.step
    metrics = {}
    if s['scaling']:
      grads = {k: g / self.scale for k, g in grads.items()}
      finite = all(np.isfinite(g).all() for g in grads.values())
      metrics.update(grad_scale=self.scale, grad_overflow=float(not finite))
      if finite and self.good >= 1000:
        self.scale *= 2
      elif not finite:
        self.scale /= 2
      self.good = self.good + 1 if finite else 0
      if not finite:
        grads = {k: np.zeros_like(g) for k, g in grads.items()}
    else:
      finite = True
    gsq = sum((g ** 2).sum() for g in grads.values())
    usq = psq = 0.0
    for path, g in grads.items():
      p = self.params[path]
      upper = s['agc'] * max(np.linalg.norm(p), s['pmin'])
      g = g / max(np.linalg.norm(g) / upper, 1.0)
      self.nu[path] = s['beta2'] * self.nu[path] + s['1-beta2'] * g ** 2
      nu_hat = self.nu[path] / (1 - s['beta2'] ** (t + 1))
      u = g / (np.sqrt(nu_hat) + s['eps'])
      if s['momentum']:
        self.mu[path] = s['beta1'] * self.mu[path] + s['1-beta1'] * u
        m = self.mu[path]
        if s['nesterov']:
          m = s['beta1'] * m + s['1-beta1'] * u
        u = m / (1 - s['beta1'] ** (t + 1))
      if s['wd'] and re.search(s['wdregex'], path):
        u = u + s['wd'] * p
      d = -s['lr'] * u
      usq += (d ** 2).sum()
      psq += (p ** 2).sum()
      if finite:
        self.params[path] = p + d
    self.step += int(finite)
    n = sum(p.size for p in self.params.values())
    metrics.update(
        updates=t + 1, grad_norm=np.sqrt(gsq), grad_rms=np.sqrt(gsq / n),
        update_rms=np.sqrt(usq / n), param_rms=np.sqrt(psq / n),
        param_count=n, lr=s['lr'])
    return metrics


def close(got, want, name):
  """Relative error by norm, ||got - want|| / ||want||, over a whole leaf
  (the momentum's elements cancel: 0.9 mu + 0.1 u of either sign)."""
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
  assert err <= RTOL, (name, err, got, want)


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'perparam'])
@pytest.mark.parametrize('case', list(CASES))
def test_reference_update_matches_numpy(fused, case):
  """Three updates through `Optimizer._update` on the CPU (the plain
  version, no launch), the gradients growing tenfold a step so that AGC
  clips the later ones: parameters, moments, step, loss scale and every
  metric against the numpy statement."""
  settings = {**BASE, **CASES[case]}
  opt, init, rng = make(fused, settings)
  want = Numpy(settings, init)
  paths = list(opt.params)
  params = [opt.params[k] for k in paths]
  launches = optim.update.launches
  for i in range(STEPS):
    grads = {k: (rng.standard_normal(s) * 10 ** i).astype(np.float32)
             for k, s in SHAPES.items()}
    if settings['scaling']:
      scale = float(opt.grad_scale)
      assert scale == want.scale
      grads = {k: (g * scale).astype(np.float32) for k, g in grads.items()}
    if case == 'overflow' and i == OVERFLOW_STEP:
      grads['m/lin/kernel'][1, 2] = np.inf
    vec = torch.cat([torch.tensor(grads[k]).reshape(-1) for k in paths])
    got = opt._update(paths, params, vec, torch.tensor(2.0))
    expect = want({k: g.astype(np.float64) for k, g in grads.items()})
    scale = expect.get('grad_scale', 1.0)
    assert sorted(got) == sorted([*expect, 'loss'])
    close(got['loss'], 2.0 / scale, 'loss')
    for key, value in expect.items():
      close(got[key], value, key)
    for path in paths:
      close(opt.params[path].detach(), want.params[path], path)
      close(slots(opt, 'rms')[path], want.nu[path], f'rms {path}')
      if settings['momentum']:
        close(slots(opt, 'mom')[path], want.mu[path], f'mom {path}')
    assert int(opt.step) == want.step
    if settings['scaling']:
      assert float(opt.grad_scale) == want.scale
      assert int(opt.good_steps) == want.good
  assert optim.update.launches == launches


def test_overflow_keeps_parameters_and_step_and_decays_the_moments():
  """Under the loss scale, an overflowing gradient leaves the parameters
  and the step as they were, halves the scale, and still steps the
  moments on a zero gradient: the RMS moment and the momentum decay by
  beta2 and beta1 exactly (the kernels copy this)."""
  for fused in (True, False):
    opt, _, rng = make(fused, {**BASE, 'scaling': True, 'wd': 0.1})
    paths = list(opt.params)
    params = [opt.params[k] for k in paths]

    def step(planted):
      vec = torch.tensor(rng.standard_normal(sum(
          p.numel() for p in params)).astype(np.float32)) * opt.grad_scale
      if planted:
        vec[7] = float('inf')
      return opt._update(paths, params, vec, torch.tensor(1.0))

    step(False)
    before = {k: v.detach().clone() for k, v in nn.store(opt).items()}
    held = [p.detach().clone() for p in params]
    mets = step(True)
    after = nn.store(opt)
    for p, old in zip(params, held):
      assert torch.equal(p.detach(), old)
    assert int(after['step']) == int(before['step']) == 1
    assert float(after['grad_scale']) == float(before['grad_scale']) / 2
    assert int(after['good_steps']) == 0
    for path, value in after.items():
      if path.startswith('rms'):
        assert torch.equal(value, 0.999 * before[path]), path
      elif path.startswith('mom'):
        assert torch.equal(value, 0.9 * before[path]), path
    assert float(mets['grad_overflow']) == 1.0
    assert float(mets['grad_norm']) == 0.0
    assert float(mets['updates']) == 2.0


@pytest.mark.parametrize('fused,momentum', [
    (True, True), (False, True), (True, False)],
    ids=['fused', 'perparam', 'fused_no_momentum'])
def test_segment_table(fused, momentum):
  """The table the wrapper builds from CPU tensors (no launch): each
  leaf's offset into the flat gradient, size, first chunk and weight-
  decay flag, its slots (the flat moments at the leaf's offset, or its
  own slots), for a leaf of three chunks too."""
  shapes = dict(SHAPES, **{'m/big/kernel': (2 * optim.CHUNK + 5,)})
  params = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in shapes.items()}
  opt = nn.Optimizer(params, 'opt', fused=fused, momentum=momentum,
                     wd=0.1, wdregex=r'/kernel$')
  paths = list(opt.params)
  leaves = [opt.params[k] for k in paths]
  vec = torch.zeros(sum(p.numel() for p in leaves))
  table = optim.segments(opt, paths, leaves, vec)
  offset = chunk = 0
  for path, param, row in zip(paths, leaves, table.rows):
    got = dict(zip(optim.FIELDS, row))
    n = param.numel()
    assert got['p'] == param.data_ptr()
    if fused:
      assert got['nu'] == opt.rms_flat.data_ptr() + 4 * offset
      mom = opt.mom_flat.data_ptr() + 4 * offset if momentum else 0
    else:
      assert got['nu'] == opt.slot('rms', path).data_ptr()
      mom = opt.slot('mom', path).data_ptr()
    assert got['mu'] == mom
    assert (got['offset'], got['numel'], got['chunk0']) == (offset, n, chunk)
    assert got['wd'] == int(path.endswith('/kernel'))
    offset += n
    chunk += -(-n // optim.CHUNK)
  assert table.chunks == chunk
  big = dict(zip(optim.FIELDS, table.rows[paths.index('m/big/kernel')]))
  following = [row[5] for row in table.rows if row[5] > big['chunk0']]
  assert min(following, default=table.chunks) - big['chunk0'] == 3


def test_segment_table_refuses_what_the_kernels_do_not_take():
  opt, _, _ = make(True, BASE)
  paths = list(opt.params)
  params = [opt.params[k] for k in paths]
  vec = torch.zeros(sum(p.numel() for p in params))
  with pytest.raises(ValueError, match='elements'):
    optim.segments(opt, paths, params, vec[:-1])
  with pytest.raises(TypeError, match='float64'):
    optim.segments(opt, paths, [params[0].double(), *params[1:]], vec)
  strided = params[1].detach().t()
  with pytest.raises(ValueError, match='contiguous'):
    optim.segments(opt, paths, [params[0], strided, *params[2:]], vec)
  with pytest.raises(ValueError, match='expected a CUDA device'):
    optim.launch(opt, paths, params, vec, torch.tensor(0.0))


def test_packed_table_is_what_the_kernels_read():
  """The int64 array copied to the card: a row of 8 a leaf, FIELDS then
  a zero pad (csrc/optim.cu Leaf)."""
  shapes = dict(SHAPES, **{'m/big/kernel': (optim.CHUNK + 1,)})
  params = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in shapes.items()}
  opt = nn.Optimizer(params, 'opt', fused=True, wd=0.1)
  paths = list(opt.params)
  leaves = [opt.params[k] for k in paths]
  table = optim.segments(
      opt, paths, leaves, torch.zeros(sum(p.numel() for p in leaves)))
  packed = table.packed()
  assert packed.dtype == np.int64 and packed.flags.c_contiguous
  rows = packed.reshape(len(paths), 8)
  np.testing.assert_array_equal(rows[:, :len(optim.FIELDS)], table.rows)
  assert not rows[:, len(optim.FIELDS):].any()
  assert table.chunks == len(paths) + 1


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'perparam'])
def test_meta_tensors_take_the_plain_version(fused):
  """On the meta device (the FLOP count's copy) the update runs the plain
  version: no launch, no table, every metric a meta tensor."""
  with torch.device('meta'):
    params = {k: torch.nn.Parameter(torch.empty(s))
              for k, s in SHAPES.items()}
    opt = nn.Optimizer(params, 'opt', fused=fused, wd=0.1, scaling=True)
  paths = list(opt.params)
  leaves = [opt.params[k] for k in paths]
  vec = torch.empty(sum(p.numel() for p in leaves), device='meta')
  launches = optim.update.launches
  got = opt._update(paths, leaves, vec, torch.empty((), device='meta'))
  assert optim.update.launches == launches
  assert opt not in optim.WORKSPACES
  assert sorted(got) == sorted([
      'loss', 'updates', 'grad_norm', 'grad_rms', 'update_rms', 'param_rms',
      'param_count', 'lr', 'grad_scale', 'grad_overflow'])
  assert all(v.device.type == 'meta' for v in got.values())


def test_the_wrapper_ranges_opt_update_under_the_profiler(monkeypatch):
  """Forced onto its kernel path with the launch stubbed, the wrapper
  counts a launch a call and opens its `opt_update` range only while the
  profiler records."""
  entered = []
  enter = torch.autograd.profiler.record_function.__enter__

  def counted(self):
    entered.append(self.name)
    return enter(self)
  monkeypatch.setattr(torch.autograd.profiler.record_function, '__enter__',
                      counted)
  monkeypatch.setattr(optim.blockgru, 'takes_plain', lambda x: False)
  monkeypatch.setattr(optim, 'launch', lambda *args: 'metrics')
  launches = optim.update.launches
  call = functools.partial(optim.update, None, [], [], torch.zeros(1), None)
  assert call() == 'metrics'
  assert entered == []
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    assert call() == 'metrics'
  assert entered == ['opt_update']
  assert 'opt_update' in {ev.name for ev in prof.events()}
  assert optim.update.launches == launches + 2
