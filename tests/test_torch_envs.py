"""The port's env suites and wrappers against the JAX package's, on the CPU.

- Each wrapper of `core/wrappers.py` (the checks of tests/test_core_units.py
  on the port's classes), and each against its JAX twin on `Dummy` over
  one seeded action sequence: equal spaces, observations and the actions
  that reach the env.
- The adapters against their JAX twins, with the same seed and actions:
  PinPad (all six tasks, 300 steps), DMC walker_walk (proprio and a 64x64
  image, 20 steps), gymnasium CartPole and LocoNav ant_maze_m. Tolerance
  0: two JAX adapters built alike give the same bits (checked first for
  DMC), and so does the port's. dm_control's maze arenas draw their
  textures from the global NumPy generator, so the LocoNav rollouts seed
  it before each env.
- The suites whose packages are absent raise the JAX adapter's
  ImportError; `ENV_CTORS` has the JAX keys; `import
  embodied_tpu_torch.envs` loads no suite package.
- The slice: `make_env` of both packages gives equal wrapped observations
  on pinpad_three and dmc_walker_walk (proprio and image, continuous
  actions), and on those observations the port's policy, with the JAX
  Model's store carried over by `convert.from_jax`, matches the JAX
  Model's policy in float32, teacher-forced as in
  tests/test_torch_policy.py (tolerance 1e-4). Then `main.main` trains on
  the debug preset on pinpad_three, dmc_walker_walk, gym_CartPole-v1 and
  dmc_proprio with two envs and logs episode scores.
"""

import importlib
import importlib.util
import json
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_tpu import nn as jnn
from embodied_tpu import utils as jutils
from embodied_tpu.core import wrappers as jwrappers
from embodied_tpu.envs import Dummy as JDummy
from embodied_tpu.models import common as jcommon
from embodied_tpu.models.dreamerv3 import model as jmodel
from embodied_tpu_torch import utils
from embodied_tpu_torch.core import wrappers
from embodied_tpu_torch.envs import Dummy
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.parallel import convert

ROOT = pathlib.Path(__file__).resolve().parents[1]
has = lambda mod: importlib.util.find_spec(mod) is not None
TOL = 1e-4
PACKAGES = {  # each package's wrappers, Dummy and Space
    'jax': (jwrappers, JDummy, jutils.Space),
    'port': (wrappers, Dummy, utils.Space),
}


def obs_equal(got, want, where=''):
  assert sorted(got) == sorted(want), where
  for key in want:
    g, w = np.asarray(got[key]), np.asarray(want[key])
    assert g.dtype == w.dtype, (where, key, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=f'{where} {key}')


def spaces(space_dict):
  return {k: (np.dtype(s.dtype), s.shape, np.asarray(s.low).tolist(),
              np.asarray(s.high).tolist()) for k, s in space_dict.items()}


# The wrappers of tests/test_core_units.py, on the port.

class TestWrappers:

  def test_time_limit(self):
    env = wrappers.TimeLimit(Dummy('disc', length=100, size=(8, 8)), 5)
    env.step({'action': np.int32(0), 'reset': True})
    steps = 0
    while True:
      obs = env.step({'action': np.int32(0), 'reset': False})
      steps += 1
      if obs['is_last']:
        break
    assert steps == 5

  def test_action_repeat_sums_reward(self):
    env = wrappers.ActionRepeat(Dummy('disc', length=100, size=(8, 8)), 4)
    env.step({'action': np.int32(0), 'reset': True})
    obs = env.step({'action': np.int32(0), 'reset': False})
    assert obs['reward'] == 2.0

  def test_normalize_action_roundtrip(self):
    class ScaledEnv(Dummy):
      @property
      def act_space(self):
        return {
            'action': utils.Space(np.float32, (2,), 0.0, 10.0),
            'reset': utils.Space(bool),
        }
      def step(self, action):
        if not action['reset']:
          assert (np.asarray(action['action']) >= -1e-5).all()
          assert (np.asarray(action['action']) <= 10.0 + 1e-5).all()
        return super().step({'action': np.int32(0), 'reset': action['reset']})

    env = wrappers.NormalizeAction(ScaledEnv('disc', size=(8, 8)))
    space = env.act_space['action']
    assert (space.low == -1).all() and (space.high == 1).all()
    env.step({'action': np.zeros(2, np.float32), 'reset': True})
    env.step({'action': np.ones(2, np.float32), 'reset': False})

  def test_unify_dtypes(self):
    env = wrappers.UnifyDtypes(Dummy('disc', size=(8, 8)))
    obs = env.step({'action': np.int32(0), 'reset': True})
    assert obs['reward'].dtype == np.float32
    assert obs['image'].dtype == np.uint8
    assert env.obs_space['count'].dtype == np.int32

  def test_check_spaces_rejects_bad_action(self):
    env = wrappers.CheckSpaces(Dummy('disc', size=(8, 8)))
    env.step({'action': np.int32(0), 'reset': True})
    with pytest.raises(ValueError):
      env.step({'action': np.int32(99), 'reset': False})

  def test_restart_on_exception(self):
    calls = {'n': 0}

    class Crashy(Dummy):
      def step(self, action):
        calls['n'] += 1
        if calls['n'] == 3:
          raise RuntimeError('boom')
        return super().step(action)

    env = wrappers.RestartOnException(
        lambda: Crashy('disc', size=(8, 8)), wait=0)
    env.step({'action': np.int32(0), 'reset': True})
    env.step({'action': np.int32(0), 'reset': False})
    obs = env.step({'action': np.int32(0), 'reset': False})
    assert obs['is_first']


class TestMoreWrappers:

  def test_resize_image_nearest(self):
    env = wrappers.ResizeImage(Dummy('disc', size=(16, 16)), size=(8, 8))
    assert env.obs_space['image'].shape == (8, 8, 3)
    obs = env.step({'action': np.int32(0), 'reset': True})
    assert obs['image'].shape == (8, 8, 3)
    assert obs['image'].dtype == np.uint8
    full = Dummy('disc', size=(16, 16)).step(
        {'action': np.int32(0), 'reset': True})['image']
    assert (obs['image'] == full[0, 0]).all()

  def test_discretize_action(self):
    received = []

    class Recorder(Dummy):
      def step(self, action):
        received.append(action['action'])
        return super().step({**action, 'action': np.int32(0)})

    base = Recorder('cont', size=(8, 8))
    env = wrappers.DiscretizeAction(base, 'action', bins=5)
    assert env.act_space['action'].dtype == np.int32
    dims = base.act_space['action'].shape[0]
    env.step({'action': np.zeros(dims, np.int32), 'reset': True})
    np.testing.assert_allclose(received[-1], -np.ones(dims))
    env.step({'action': np.full(dims, 4, np.int32), 'reset': False})
    np.testing.assert_allclose(received[-1], np.ones(dims))
    env.step({'action': np.full(dims, 2, np.int32), 'reset': False})
    np.testing.assert_allclose(received[-1], np.zeros(dims))

  def test_backward_return(self):
    env = wrappers.BackwardReturn(Dummy('disc', size=(8, 8)), horizon=2)
    assert 'bwreturn' in env.obs_space
    obs = env.step({'action': np.int32(0), 'reset': True})
    acc = obs['reward']
    assert obs['bwreturn'] == np.float32(acc)
    for _ in range(5):
      obs = env.step({'action': np.int32(0), 'reset': False})
      acc = acc * 0.5 + obs['reward']
      np.testing.assert_allclose(obs['bwreturn'], acc, rtol=1e-6)

  def test_add_obs(self):
    env = wrappers.AddObs(
        Dummy('disc', size=(8, 8)), 'tag', np.float32(7),
        utils.Space(np.float32))
    assert 'tag' in env.obs_space
    obs = env.step({'action': np.int32(0), 'reset': True})
    assert obs['tag'] == np.float32(7)

  def test_clip_action(self):
    received = []

    class Recorder(Dummy):
      def step(self, action):
        received.append(action['action'])
        return super().step({**action, 'action': np.int32(0)})

    base = Recorder('cont', size=(8, 8))
    env = wrappers.ClipAction(base, 'action')
    dims = base.act_space['action'].shape[0]
    env.step({'action': np.full(dims, 5.0, np.float32), 'reset': True})
    np.testing.assert_allclose(received[-1], np.ones(dims))


# Each wrapper against its JAX twin.

def recorder(Dummy, Space, bounds=None, crash_at=None):
  """A Dummy that records the actions it receives, optionally with a
  continuous action space of other bounds, or raising at one call."""

  class Recorder(Dummy):
    calls = 0

    def __init__(self, *args, **kwargs):
      super().__init__(*args, **kwargs)
      self.received = []

    @property
    def act_space(self):
      spaces = dict(super().act_space)
      if bounds:
        spaces['action'] = Space(np.float32, (2,), *bounds)
      return spaces

    def step(self, action):
      Recorder.calls += 1
      if Recorder.calls == crash_at:
        raise RuntimeError('boom')
      self.received.append(np.asarray(action['action']).copy())
      return super().step(action)

  return Recorder


def base_env(env):
  while hasattr(env, 'env'):
    env = env.env
  return env


WRAPPER_CASES = {
    'time_limit': lambda w, D, S: w.TimeLimit(
        recorder(D, S)('disc', length=100, size=(8, 8)), 5),
    'time_limit_soft': lambda w, D, S: w.TimeLimit(
        recorder(D, S)('disc', length=100, size=(8, 8)), 5, reset=False),
    'action_repeat': lambda w, D, S: w.ActionRepeat(
        recorder(D, S)('disc', length=9, size=(8, 8)), 4),
    'normalize_action': lambda w, D, S: w.NormalizeAction(
        recorder(D, S, (0.0, 10.0))('cont', size=(8, 8))),
    'clip_action': lambda w, D, S: w.ClipAction(
        recorder(D, S)('cont', size=(8, 8)), 'action'),
    'unify_dtypes': lambda w, D, S: w.UnifyDtypes(
        recorder(D, S)('disc', length=12, size=(8, 8))),
    'check_spaces': lambda w, D, S: w.CheckSpaces(
        recorder(D, S)('disc', length=12, size=(8, 8))),
    'discretize_action': lambda w, D, S: w.DiscretizeAction(
        recorder(D, S)('cont', size=(8, 8)), 'action', bins=5),
    'resize_image': lambda w, D, S: w.ResizeImage(
        recorder(D, S)('disc', length=12, size=(16, 12)), size=(8, 8)),
    'backward_return': lambda w, D, S: w.BackwardReturn(
        recorder(D, S)('disc', length=12, size=(8, 8)), horizon=3),
    'add_obs': lambda w, D, S: w.AddObs(
        recorder(D, S)('disc', size=(8, 8)), 'tag', np.float32(7),
        S(np.float32)),
    'restart_on_exception': lambda w, D, S: w.RestartOnException(
        lambda R=recorder(D, S, crash_at=7): R('disc', size=(8, 8)),
        wait=0),
}


def sample_action(space, rng):
  if np.issubdtype(space.dtype, np.integer):
    return rng.integers(space.low, space.high, space.shape).astype(
        space.dtype)
  # Past the bounds, so that the clipping wrappers have work to do.
  return rng.uniform(-1.5, 1.5, space.shape).astype(space.dtype)


@pytest.mark.parametrize('case', sorted(WRAPPER_CASES))
def test_wrapper_matches_jax(case):
  envs = {name: WRAPPER_CASES[case](*pkg) for name, pkg in PACKAGES.items()}
  assert spaces(envs['port'].obs_space) == spaces(envs['jax'].obs_space)
  assert spaces(envs['port'].act_space) == spaces(envs['jax'].act_space)
  rng = np.random.default_rng(0)
  space = envs['jax'].act_space['action']
  for t in range(40):
    action = {'action': sample_action(space, rng),
              'reset': t == 0 or rng.random() < 0.05}
    obs = {name: env.step(dict(action)) for name, env in envs.items()}
    obs_equal(obs['port'], obs['jax'], f'{case}, step {t}')
  received = {name: base_env(env).received for name, env in envs.items()}
  assert len(received['port']) == len(received['jax']) > 0
  for got, want in zip(received['port'], received['jax']):
    np.testing.assert_array_equal(got, want)


# The adapters against their JAX twins.

def rollout(env, actions):
  return [env.step({**act, 'reset': t == 0 or bool(act.get('reset'))})
          for t, act in enumerate(actions)]


def random_actions(env, steps, seed=0, resets=0.0):
  rng = np.random.default_rng(seed)
  space = env.act_space['action']
  acts = []
  for _ in range(steps):
    if np.issubdtype(space.dtype, np.integer):
      value = rng.integers(space.low, space.high, space.shape).astype(
          space.dtype)
    else:
      value = rng.uniform(space.low, space.high).astype(space.dtype)
    acts.append({'action': value, 'reset': rng.random() < resets})
  return acts


def same_rollouts(got, want, where):
  assert len(got) == len(want)
  for t, (g, w) in enumerate(zip(got, want)):
    obs_equal(g, w, f'{where}, step {t}')


@pytest.mark.parametrize(
    'task', ['three', 'four', 'five', 'six', 'seven', 'eight'])
def test_pinpad_matches_jax(task):
  from embodied_tpu.envs.pinpad import PinPad as JPinPad
  from embodied_tpu_torch.envs.pinpad import PinPad
  envs = [cls(task, length=120, seed=3) for cls in (JPinPad, PinPad)]
  assert spaces(envs[1].obs_space) == spaces(envs[0].obs_space)
  assert spaces(envs[1].act_space) == spaces(envs[0].act_space)
  acts = random_actions(envs[0], 300, seed=4, resets=0.01)
  want, got = (rollout(env, acts) for env in envs)
  same_rollouts(got, want, f'pinpad {task}')
  assert sum(o['is_first'] for o in got) >= 3  # episode ends and resets


@pytest.mark.skipif(not has('dm_control'), reason='no dm_control')
@pytest.mark.parametrize('twin', ['jax', 'port'])
def test_dmc_walker_matches_jax(twin):
  """The JAX adapter against itself (the two renders agree to the bit),
  then the port's against it."""
  from embodied_tpu.envs.dmc import DMC as JDMC
  from embodied_tpu_torch.envs.dmc import DMC
  other = JDMC if twin == 'jax' else DMC
  envs = [cls('walker_walk', size=(64, 64), seed=5) for cls in (JDMC, other)]
  assert spaces(envs[1].obs_space) == spaces(envs[0].obs_space)
  assert spaces(envs[1].act_space) == spaces(envs[0].act_space)
  acts = random_actions(envs[0], 20, seed=6)
  want, got = (rollout(env, acts) for env in envs)
  same_rollouts(got, want, f'dmc against {twin}')
  assert got[-1]['image'].shape == (64, 64, 3)
  assert got[-1]['image'].std() > 0 and 'orientations' in got[-1]
  for env in envs:
    env.close()


@pytest.mark.skipif(not has('gymnasium'), reason='no gymnasium')
def test_gym_cartpole_matches_jax():
  from embodied_tpu.envs.from_gym import FromGym as JFromGym
  from embodied_tpu_torch.envs.from_gym import FromGym
  envs = [cls('CartPole-v1') for cls in (JFromGym, FromGym)]
  for env in envs:
    env.env.reset(seed=7)  # seeds the generator later resets draw from
  assert spaces(envs[1].obs_space) == spaces(envs[0].obs_space)
  assert spaces(envs[1].act_space) == spaces(envs[0].act_space)
  assert envs[1].obs_space['image'].shape == (4,)
  acts = random_actions(envs[0], 80, seed=8)
  want, got = (rollout(env, acts) for env in envs)
  same_rollouts(got, want, 'cartpole')
  assert sum(o['is_last'] for o in got) >= 1
  for env in envs:
    env.close()


@pytest.mark.skipif(not has('dm_control'), reason='no dm_control')
def test_loconav_ant_maze_matches_jax():
  from embodied_tpu.envs.loconav import LocoNav as JLocoNav
  from embodied_tpu_torch.envs.loconav import LocoNav
  rollouts = []
  for cls in (JLocoNav, LocoNav):
    np.random.seed(0)  # the maze textures' draws
    env = cls('ant_maze_m', size=(48, 48), seed=5)
    acts = random_actions(env, 6, seed=9)
    rollouts.append((spaces(env.obs_space), rollout(env, acts)))
    env.close()
  (wspace, want), (gspace, got) = rollouts
  assert gspace == wspace
  same_rollouts(got, want, 'loconav')
  assert got[-1]['image'].shape == (48, 48, 3) and got[-1]['image'].std() > 0


ABSENT = {  # suite: (package it needs, constructor, its task)
    'crafter': ('crafter', 'crafter:Crafter', 'reward'),
    'atari': ('ale_py', 'atari:Atari', 'pong'),
    'procgen': ('procgen', 'procgen:ProcGen', 'coinrun'),
    'dmlab': ('deepmind_lab', 'dmlab:DMLab', 'rooms_collect_good_objects'),
    'minecraft': ('minerl', 'minecraft:Minecraft', 'wood'),
    'bsuite': ('bsuite', 'bsuite:BSuite', 'catch/0'),
}


@pytest.mark.parametrize('suite', sorted(ABSENT))
def test_absent_suite_raises_the_jax_import_error(suite):
  package, ctor, task = ABSENT[suite]
  if has(package):
    pytest.skip(f'{package} is installed here')
  messages = []
  for root in ('embodied_tpu', 'embodied_tpu_torch'):
    module, name = ctor.split(':')
    cls = getattr(importlib.import_module(f'{root}.envs.{module}'), name)
    with pytest.raises(ImportError) as info:
      cls(task)
    messages.append(str(info.value))
  assert messages[1] == messages[0]


def test_env_ctors_have_the_jax_keys():
  """Each entry names the port's module and class where the JAX table names
  the JAX package's; the modules import without their suites' packages."""
  assert sorted(common.ENV_CTORS) == sorted(jcommon.ENV_CTORS)
  assert len(common.ENV_CTORS) == 13
  for suite, ctor in common.ENV_CTORS.items():
    assert ctor == jcommon.ENV_CTORS[suite].replace(
        'embodied_tpu.', 'embodied_tpu_torch.', 1)
    module, name = ctor.split(':')
    cls = getattr(importlib.import_module(module), name)
    assert cls.__module__ == module, (suite, cls.__module__)


def test_importing_the_envs_loads_no_suite_package():
  suites = ('dm_control', 'mujoco', 'labmaze', 'dm_env', 'gymnasium', 'gym',
            'crafter', 'ale_py', 'procgen', 'deepmind_lab', 'minerl',
            'bsuite', 'jax', 'embodied_tpu')
  script = (
      'import sys\n'
      'import embodied_tpu_torch.envs as envs\n'
      'from embodied_tpu_torch.envs import Dummy, PinPad\n'
      f'bad = sorted(m for m in sys.modules if m.split(".")[0] in {suites!r})\n'
      'names = [n for n in dir(envs) if n[0].isupper()]\n'
      'print(bad, names)\n'
      'sys.exit(1 if bad or len(names) != 12 else 0)\n')
  proc = subprocess.run(
      [sys.executable, '-c', script], cwd=ROOT, capture_output=True,
      text=True, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  from embodied_tpu_torch import envs
  if has('dm_control'):
    assert envs.DMC.__module__ == 'embodied_tpu_torch.envs.dmc'
  with pytest.raises(AttributeError):
    envs.NoSuchEnv  # noqa: B018


@pytest.mark.parametrize('flag', ['use_seed', 'use_logdir'])
def test_make_env_seed_and_logdir_as_jax(flag, tmp_path, monkeypatch):
  """`use_seed` and `use_logdir` (bsuite's) give the constructor what the
  JAX make_env gives it."""
  calls = []

  def ctor(task, **kwargs):
    calls.append((task, {k: str(v) for k, v in kwargs.items()}))
    return Dummy('disc', size=(8, 8))

  for module in (common, jcommon):
    monkeypatch.setitem(module.ENV_CTORS, 'bsuite', ctor)
  argv = ['--task', 'bsuite_catch/0', '--logdir', str(tmp_path)]
  configs = [common.assemble_config(main.CONFIGS, argv),
             jcommon.assemble_config(str(JAX_CONFIGS), argv)]
  for config, module in zip(configs, (common, jcommon)):
    module.make_env(config, 3, **{flag: True})
  assert calls[0] == calls[1], calls
  want = ('seed', str(hash((configs[0].seed, 3)) % (2 ** 32 - 1))) if (
      flag == 'use_seed') else ('logdir', str(tmp_path / 'env3'))
  assert calls[0] == ('catch/0', dict([want]))


# The slice: both packages' make_env, then the policy on those observations.

JAX_CONFIGS = pathlib.Path(jmodel.__file__).parent / 'configs.yaml'
B, T = 2, 6
SMALL = ['--configs', 'debug',
         '--agent.dyn.rssm.deter', '64', '--agent.dyn.rssm.hidden', '32',
         '--agent.dyn.rssm.blocks', '4', '--agent.dyn.rssm.stoch', '4',
         '--agent.dyn.rssm.classes', '4', '--agent.enc.simple.depth', '4',
         '--agent.enc.simple.units', '16', '--agent.enc.simple.layers', '2',
         '--agent.policy.units', '16', '--agent.policy.layers', '2']
SLICE_TASKS = {
    'pinpad_three': ['--env.pinpad.length', '50'],
    'dmc_walker_walk': [],  # proprio and image, continuous actions
}


@pytest.fixture
def jax_f32():
  previous = jnn.core.COMPUTE_DTYPE
  jnn.set_compute_dtype(jnp.float32)
  yield
  jnn.set_compute_dtype(previous)


def slice_configs(task):
  if task.startswith('dmc') and not has('dm_control'):
    pytest.skip('no dm_control')
  argv = SMALL + ['--task', task, *SLICE_TASKS[task], '--logdir',
                  '/nonexistent']
  config = common.assemble_config(main.CONFIGS, argv + [
      '--torch.compute_dtype', 'float32', '--torch.latent_slots', '0'])
  return config, jcommon.assemble_config(str(JAX_CONFIGS), argv)


def slice_envs(config, jconfig):
  """B envs from each package's make_env with the same seeds."""
  return ([jcommon.make_env(jconfig, i, seed=10 + i) for i in range(B)],
          [common.make_env(config, i, seed=10 + i) for i in range(B)])


def step_all(envs, acts, reset=False):
  rows = [env.step({'action': a, 'reset': reset}) for env, a in
          zip(envs, acts)]
  return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.mark.parametrize('task', sorted(SLICE_TASKS))
def test_slice_make_env_matches_jax(task):
  config, jconfig = slice_configs(task)
  jenvs, envs = slice_envs(config, jconfig)
  assert spaces(envs[0].obs_space) == spaces(jenvs[0].obs_space)
  assert spaces(envs[0].act_space) == spaces(jenvs[0].act_space)
  space = envs[0].act_space['action']
  rng = np.random.default_rng(11)
  for t in range(60 if task.startswith('pinpad') else 12):
    if np.issubdtype(space.dtype, np.integer):
      acts = rng.integers(space.low, space.high, (B, *space.shape))
      acts = acts.astype(space.dtype)
    else:  # past the bounds: the wrapped env clips
      acts = rng.uniform(-1.5, 1.5, (B, *space.shape)).astype(space.dtype)
    obs_equal(step_all(envs, acts, t == 0), step_all(jenvs, acts, t == 0),
              f'{task}, step {t}')
  for env in (*envs, *jenvs):
    env.close()


def jax_step(model):
  def fn(ctx, carry, obs):
    enc_carry, dyn_carry, _, prevact = carry
    reset = obs['is_first']
    kw = dict(training=False, single=True)
    _, _, tokens = model.enc(ctx, enc_carry, obs, reset, **kw)
    dyn_carry, _, feat = model.dyn.observe(
        ctx, dyn_carry, tokens, prevact, reset, **kw)
    pol = model.pol(ctx, model._feat2tensor(feat), bdims=1)['action']
    act = {'action': pol.sample(ctx.rng())}
    return dict(tokens=tokens, feat=feat, logp=pol.logp(act['action']),
                act=act, carry=(enc_carry, dyn_carry, {}, act))
  return fn


def to_t(x):
  return torch.tensor(np.asarray(x))


def close(got, want, name):
  np.testing.assert_allclose(
      got.float().numpy(), np.asarray(want, np.float32), rtol=TOL, atol=TOL,
      err_msg=name)


@pytest.mark.parametrize('task', sorted(SLICE_TASKS))
def test_slice_policy_matches_jax(task, jax_f32):
  """The port's Agent.policy and its model's stages on the observations of
  the port's envs, against the JAX Model, which steps the envs with its
  own actions; the port gets JAX's stoch sample and action of the step
  before (teacher-forced)."""
  config, jconfig = slice_configs(task)
  jenvs, envs = slice_envs(config, jconfig)
  obs_space, act_space = jcommon.env_spaces(jconfig)
  jm = jmodel.Model(obs_space, act_space, jcommon.agent_config(jconfig))
  space = envs[0].act_space['action']
  zeros = np.zeros((B, *space.shape), space.dtype)
  jobs0 = step_all(jenvs, zeros, reset=True)
  obs = step_all(envs, zeros, reset=True)
  key = jax.random.PRNGKey(1)

  def init(ctx, obs):
    jm.policy(ctx, jm.init_policy(ctx, B), obs)
  store, meta = jnn.init(init)(key, jobs0)
  agent = main.make_agent(config, device='cpu')
  agent.load({'store': convert.from_jax(store)}, regex=r'^(enc|dyn|pol)/')
  model = agent.model
  step = jax.jit(jnn.pure(jax_step(jm), meta))
  jcarry = jnn.pure(lambda ctx: jm.init_policy(ctx, B), meta)(store, key)[1]
  deter = torch.zeros((B, model.dyn.deter))
  for t in range(T):
    obs_equal(obs, jobs0, f'{task} observations, step {t}')
    _, out = step(store, jax.random.fold_in(key, t), jcarry,
                  {k: jnp.asarray(v) for k, v in jobs0.items()})
    tobs = {k: to_t(v) for k, v in obs.items()}
    carry = ({}, {'deter': deter, 'stoch': to_t(jcarry[1]['stoch'])}, {},
             {'action': to_t(jcarry[3]['action'])})
    with torch.inference_mode():
      _, _, tokens = model.enc({}, tobs, tobs['is_first'], single=True)
      _, _, feat = model.dyn.observe(
          carry[1], tokens, carry[3], tobs['is_first'])
      jstoch = to_t(out['feat']['stoch'])
      pol = model.pol(model._feat2tensor(dict(feat, stoch=jstoch)), bdims=1)
      logp = pol['action'].logp(to_t(out['act']['action']))
    close(tokens, out['tokens'], f'tokens, step {t}')
    close(feat['deter'], out['feat']['deter'], f'deter, step {t}')
    close(feat['logit'], out['feat']['logit'], f'logit, step {t}')
    close(logp, out['logp'], f'policy logp, step {t}')
    # Agent.policy on the same carry and observations gives the same deter.
    acarry, act, aout = agent.policy(carry, obs)
    close(acarry[1]['deter'], out['feat']['deter'], f'Agent deter, step {t}')
    assert act['action'].shape == (B, *space.shape)
    assert all(aout[k].all() for k in aout if k.startswith('log/finite'))
    deter = feat['deter']
    jcarry = out['carry']
    acts = np.asarray(out['act']['action']).astype(space.dtype)
    jobs0, obs = step_all(jenvs, acts), step_all(envs, acts)
  for env in (*envs, *jenvs):
    env.close()


# main.main on the debug preset, two envs, a few hundred steps. DMC
# episodes last 1,000 steps over the action repeat, so the DMC runs repeat
# each action 8 times (125-step episodes); PinPad's are cut to 100 steps.
MAIN_RUNS = {
    'pinpad_three': ['--task', 'pinpad_three', '--env.pinpad.length', '100'],
    'dmc_walker_walk': ['--task', 'dmc_walker_walk', '--env.dmc.repeat', '8'],
    'gym_CartPole-v1': ['--task', 'gym_CartPole-v1'],
    'dmc_proprio': ['--configs', 'dmc_proprio', 'debug',
                    '--env.dmc.repeat', '8'],
}
DEBUG = ['--batch_size', '2', '--batch_length', '8', '--report_length', '4',
         '--run.train_ratio', '4', '--run.envs', '2',
         '--run.log_every', '0.2', '--run.report_every', '0.5',
         '--run.save_every', '0.5', '--run.usage.psutil', 'False',
         '--run.steps', '270']


@pytest.fixture
def one_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.mark.parametrize('run', sorted(MAIN_RUNS))
def test_main_trains_on_the_suite(run, tmp_path, one_thread):
  if run.startswith('dmc') and not has('dm_control'):
    pytest.skip('no dm_control')
  if run.startswith('gym') and not has('gymnasium'):
    pytest.skip('no gymnasium')
  flags = MAIN_RUNS[run]
  if flags[0] != '--configs':
    flags = ['--configs', 'debug', *flags]
  main.main(flags + DEBUG + ['--logdir', str(tmp_path)])
  saved = pickle.loads((tmp_path / 'checkpoint.pkl').read_bytes())
  assert saved['agent']['counters']['train'] >= 1
  lines = [json.loads(line) for line in
           (tmp_path / 'metrics.jsonl').read_text().splitlines()]
  scores = [line['episode/score'] for line in lines
            if 'episode/score' in line]
  assert scores and all(np.isfinite(scores))
  losses = [v for line in lines for k, v in line.items()
            if k.startswith('train/loss/')]
  assert losses and all(np.isfinite(losses))
