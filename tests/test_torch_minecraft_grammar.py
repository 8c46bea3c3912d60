"""The port's Minecraft action grammars against the JAX package's.

The tests of tests/test_minecraft_grammar.py, run on
`embodied_tpu_torch.envs.minecraft` (the cardinality checks as cases of
one parametrised test), then the port's tables and translations held
equal to those of `embodied_tpu.envs.minecraft`. They exercise the pure
grammar tables and translation logic only, so they run without the minerl
package.
"""

import itertools

import numpy as np
import pytest

from embodied_tpu.envs import minecraft as jmc
from embodied_tpu_torch.envs import minecraft as mc

# (act space, key, classes): flat basic 12 / diamond 25, factor1 main 11 x
# other 15, factor2 6/5/2/4/9/4.
CARDINALITIES = {
    'flat_wood': (lambda: mc.flat_act_space('wood'), {'action': 12}),
    'flat_diamond': (lambda: mc.flat_act_space('diamond'), {'action': 25}),
    'factor1': (lambda: mc.factor_act_space('factor1'),
                {'main': 11, 'other': 15}),
    'factor2': (lambda: mc.factor_act_space('factor2'), {
        'move': 6, 'look': 5, 'attack': 2, 'place': 4, 'make': 9,
        'equip': 4}),
}


@pytest.mark.parametrize('name', sorted(CARDINALITIES))
def test_act_space_cardinality(name):
  make, want = CARDINALITIES[name]
  space = make()
  assert {k: v.classes for k, v in space.items() if k != 'reset'} == want
  if name == 'flat_wood':
    assert len(mc.BASIC_ACTIONS) == 12
  if name == 'flat_diamond':
    assert len(mc.DIAMOND_ACTIONS) == 25


class TestFlatGrammar:

  def test_diamond_actions_superset(self):
    for name in mc.BASIC_ACTIONS:
      assert name in mc.DIAMOND_ACTIONS

  def test_translate_fills_noop_defaults(self):
    raw = mc.translate_flat({'action': 0}, 'wood')
    assert set(raw) == set(mc.NOOP)
    assert raw['camera'] == (0, 0)
    raw = mc.translate_flat(
        {'action': list(mc.DIAMOND_ACTIONS).index('smelt_iron_ingot')},
        'diamond')
    assert raw['nearbySmelt'] == 'iron_ingot'

  def test_jump_also_moves_forward(self):
    raw = mc.translate_flat(
        {'action': list(mc.BASIC_ACTIONS).index('jump')}, 'wood')
    assert raw['jump'] == 1 and raw['forward'] == 1


class TestFactorGrammar:

  def test_factor_merge_simultaneous(self):
    act = {'move': 1, 'look': 1, 'attack': 1, 'place': 0, 'make': 0,
           'equip': 0}
    raw = mc.translate_factor(act, 'factor2')
    assert raw['forward'] == 1
    assert raw['attack'] == 1
    assert raw['camera'] == (-15, 0)

  def test_factor_camera_accumulates(self):
    act = {'main': 2, 'other': 0}
    raw = mc.translate_factor(act, 'factor1')
    assert raw['camera'] == (-15, 0)


class TestKeyboardGrammar:

  def test_key_table(self):
    assert len(mc.KEYBOARD_KEYS) == 23
    commands = [command for _, command, _ in mc.KEYBOARD_KEYS]
    assert len(set(commands)) == 23
    space = mc.keyboard_act_space()
    assert space['keys'].shape == (23,)
    assert space['mouse'].classes == 121

  def test_mouse_roundtrip(self):
    for xy in ([0.0, 0.0], [15.0, -15.0], [66.0, 66.0], [-66.0, 3.0]):
      idx = mc.mouse_discretize(np.array(xy, np.float32))
      back = mc.mouse_undiscretize(idx)
      again = mc.mouse_discretize(np.array(back, np.float32))
      assert (idx == again).all(), (xy, idx, back, again)

  def test_mouse_center_is_noop(self):
    center = mc.MOUSE_BINS // 2
    back = mc.mouse_undiscretize(np.array([center, center], np.int32))
    assert np.allclose(back, 0.0), back

  def test_translate_keyboard(self):
    keys = np.zeros(23, np.int32)
    keys[[i for i, (n, _, _) in enumerate(mc.KEYBOARD_KEYS)
          if n == 'forward']] = 1
    center = mc.MOUSE_BINS // 2
    raw = mc.translate_keyboard(
        {'mouse': center * mc.MOUSE_BINS + center, 'keys': keys})
    assert raw['forward'] == 1
    assert raw['attack'] == 0
    assert np.allclose(raw['camera'], (0.0, 0.0))
    assert set(raw) == set(mc.KEYBOARD_NOOP)

  def test_diamond_reward_table(self):
    rewards = mc.task_rewards('diamond', 'keyboard')
    assert len(rewards) == len(mc.KEYBOARD_DIAMOND_REWARDS)


class TestRewardMachinery:

  def test_collect_once(self):
    fn = mc.CollectReward('log', once=1)
    assert fn({'is_first': True}, {'log': 0}) == 0
    assert fn({'is_first': False}, {'log': 1}) == 1
    assert fn({'is_first': False}, {'log': 2}) == 0

  def test_collect_repeated_capped(self):
    fn = mc.CollectReward('log', repeated=0.5, times=3)
    fn({'is_first': True}, {'log': 0})
    assert fn({'is_first': False}, {'log': 2}) == 1.0
    assert fn({'is_first': False}, {'log': 5}) == 0.5
    assert fn({'is_first': False}, {'log': 9}) == 0.0

  def test_collect_item_group(self):
    fn = mc.CollectReward(mc.LOG_ITEMS, repeated=1)
    fn({'is_first': True}, {})
    assert fn({'is_first': False}, {'oak_log': 1, 'birch_log': 1}) == 2

  def test_health_reward(self):
    fn = mc.HealthReward(scale=0.01)
    assert fn({'is_first': True, 'health': 1.0}) == 0
    assert abs(fn({'is_first': False, 'health': 0.5}) + 0.005) < 1e-9

  def test_sticky_attack_and_jump(self):
    ctl = mc.StickyController(sticky_attack=3, sticky_jump=2)
    raw = ctl(dict(mc.NOOP, attack=1))
    assert raw['attack'] == 1
    raw = ctl(dict(mc.NOOP))
    assert raw['attack'] == 1 and raw['jump'] == 0
    ctl2 = mc.StickyController(sticky_attack=0, sticky_jump=2)
    raw = ctl2(dict(mc.NOOP, jump=1))
    raw = ctl2(dict(mc.NOOP))
    assert raw['jump'] == 1 and raw['forward'] == 1

  def test_pitch_limit(self):
    ctl = mc.StickyController(
        sticky_attack=0, sticky_jump=0, pitch_limit=(-30, 30))
    for _ in range(2):
      raw = ctl(dict(mc.NOOP, camera=(15, 0)))
      assert raw['camera'] == (15, 0)
    raw = ctl(dict(mc.NOOP, camera=(15, 0)))
    assert raw['camera'] == (0, 0)
    raw = ctl(dict(mc.NOOP, camera=(-15, 5)))
    assert raw['camera'] == (-15, 5)


class _FakeActSpace:

  def noop(self):
    return dict(mc.NOOP)


class _FakeMineRL:
  """Minimal MineRLObtainDiamondShovel stand-in for step-path tests."""

  def __init__(self):
    self.action_space = _FakeActSpace()
    self.inventory = {}

  def _obs(self):
    return {
        'pov': np.zeros((64, 64, 3), np.uint8),
        'inventory': dict(self.inventory),
        'life_stats': {'life': 20.0},
    }

  def reset(self):
    self.inventory = {}
    return self._obs()

  def step(self, action):
    return self._obs(), 0.0, False, {}


def _fake_minecraft(module, task='diamond', actions='flat'):
  env = module.Minecraft.__new__(module.Minecraft)
  env._task = task
  env._mode = actions
  env._env = _FakeMineRL()
  env._size = (64, 64)
  env._length = 100
  env._logs = False
  env._rewards = module.task_rewards(task, actions)
  env._sticky = module.StickyController(sticky_attack=0)
  env._inventory = {}
  env._max_y = None
  env._step_count = 0
  env._done = True
  return env


class TestEpisodeRewardReset:
  """Reward-fn state resets on every episode boundary: milestone 'once'
  rewards fire again in later episodes."""

  def test_once_milestones_fire_each_episode(self):
    env = _fake_minecraft(mc, 'diamond', 'flat')
    noop = {'reset': False, 'action': 0}

    def run_episode():
      env.step({'reset': True, 'action': 0})
      env._env.inventory = {'log': 1}
      obs = env.step(noop)
      return float(obs['reward'])

    first = run_episode()
    second = run_episode()
    assert first >= 1.0, first
    assert second == first, (first, second)

  def test_keyboard_times_cap_resets_each_episode(self):
    env = _fake_minecraft(mc, 'diamond', 'keyboard')
    noop = {k: np.zeros_like(v.sample())
            for k, v in mc.keyboard_act_space().items()}
    noop['reset'] = False

    def collect_logs(n):
      env.step({**noop, 'reset': True})
      total = 0.0
      for i in range(n):
        env._env.inventory = {'oak_log': i + 1}
        total += float(env.step(noop)['reward'])
      return total

    first = collect_logs(10)
    second = collect_logs(10)
    assert first > 0, first
    assert second == first, (first, second)


# Against the JAX package's module.

TABLES = sorted(name for name in vars(jmc) if name.isupper())


def test_the_port_has_the_same_tables():
  assert sorted(name for name in vars(mc) if name.isupper()) == TABLES
  assert len(TABLES) >= 14


@pytest.mark.parametrize('name', TABLES)
def test_table_equals_the_jax_one(name):
  assert getattr(mc, name) == getattr(jmc, name), name


def space_tuple(space):
  return (space.dtype, space.shape, np.asarray(space.low).tolist(),
          np.asarray(space.high).tolist())


@pytest.mark.parametrize('make', [
    lambda m: m.flat_act_space('wood'), lambda m: m.flat_act_space('diamond'),
    lambda m: m.factor_act_space('factor1'),
    lambda m: m.factor_act_space('factor2'),
    lambda m: m.keyboard_act_space()],
    ids=['flat_wood', 'flat_diamond', 'factor1', 'factor2', 'keyboard'])
def test_act_space_equals_the_jax_one(make):
  got, want = make(mc), make(jmc)
  assert {k: space_tuple(v) for k, v in got.items()} == {
      k: space_tuple(v) for k, v in want.items()}


def test_translations_equal_the_jax_ones():
  for task in ('wood', 'diamond'):
    for index in range(len(jmc.flat_actions(task))):
      act = {'action': index}
      assert mc.translate_flat(act, task) == jmc.translate_flat(act, task)
  for variant in ('factor1', 'factor2'):
    groups = jmc.factor_groups(variant)
    for combo in itertools.product(*(range(len(v)) for v in groups.values())):
      act = dict(zip(groups, combo))
      assert (mc.translate_factor(act, variant) ==
              jmc.translate_factor(act, variant)), act
  rng = np.random.default_rng(0)
  for _ in range(200):
    act = {'mouse': int(rng.integers(mc.MOUSE_BINS ** 2)),
           'keys': rng.integers(0, 2, len(mc.KEYBOARD_KEYS)).astype(np.int32)}
    assert mc.translate_keyboard(act) == jmc.translate_keyboard(act)
  xy = rng.uniform(-80, 80, (500, 2)).astype(np.float32)
  np.testing.assert_array_equal(
      mc.mouse_discretize(xy), jmc.mouse_discretize(xy))
  idx = rng.integers(0, mc.MOUSE_BINS, (500, 2)).astype(np.int32)
  np.testing.assert_array_equal(
      mc.mouse_undiscretize(idx), jmc.mouse_undiscretize(idx))


@pytest.mark.parametrize('task,mode', [
    ('wood', 'flat'), ('climb', 'flat'), ('diamond', 'flat'),
    ('diamond', 'keyboard')])
def test_rewards_equal_the_jax_ones(task, mode):
  """The reward stacks give the same rewards over one seeded inventory
  and health sequence, with an episode boundary in the middle."""
  ours, theirs = mc.task_rewards(task, mode), jmc.task_rewards(task, mode)
  assert [type(f).__name__ for f in ours] == [
      type(f).__name__ for f in theirs]
  items = sorted({*jmc.LOG_ITEMS, *jmc.PLANK_ITEMS, *jmc.DIAMOND_MILESTONES})
  rng = np.random.default_rng(1)
  counts = dict.fromkeys(items, 0)
  for t in range(60):
    first = t in (0, 30)
    if first:
      counts = dict.fromkeys(items, 0)
    for item in rng.choice(items, 3):
      counts[item] += int(rng.integers(0, 3))
    obs = {'is_first': first, 'health': float(rng.uniform(0, 1))}
    for ours_fn, theirs_fn in zip(ours, theirs):
      args = (obs,) if type(ours_fn).__name__ == 'HealthReward' else (
          obs, dict(counts))
      assert ours_fn(*args) == theirs_fn(*args), (t, type(ours_fn))
