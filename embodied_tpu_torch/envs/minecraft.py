"""Minecraft (MineRL) adapter with milestone-reward tasks.

A copy of embodied_tpu/envs/minecraft.py, with the full action grammars
of the three reference modules:

- flat (minecraft_flat.py:108-121,64-92): one discrete action over
  composite primitives — 12 basic actions for Wood/Climb, 25 for Diamond
  (basic + craft/place/equip/smelt chain).
- factor (minecraft_factor.py:22-52,85-126): independent discrete
  subaction groups merged into one simultaneous MineRL action; both
  reference layouts — 'factor1' (main 11 x other 15) and 'factor2'
  (move 6 x look 5 x attack 2 x place 4 x make 9 x equip 4).
- keyboard (minecraft_keyboard.py:180-238): the raw humanlike interface —
  a 23-key multi-hot vector plus an 11x11 mu-law-binned mouse action.

Reward machinery mirrors the reference: CollectReward (once/repeated),
HealthReward, the keyboard Diamond reward table with per-item caps
(minecraft_keyboard.py:22-38), sticky attack/jump and pitch limiting
(minecraft_flat.py:325-345).

The grammar tables and action translation are pure functions/values so
they are unit-testable without the `minerl` package (which needs a patched
wheel and a JDK; see the reference Dockerfile); only the env class itself
is import-gated.
"""

import numpy as np

from ..utils import Space

# --- Full MineRL noop (minecraft_flat.py:286-289) -------------------------

NOOP = dict(
    camera=(0, 0), forward=0, back=0, left=0, right=0, attack=0, sprint=0,
    jump=0, sneak=0, craft='none', nearbyCraft='none', nearbySmelt='none',
    place='none', equip='none')

# --- Flat grammar (minecraft_flat.py:108-121 + Diamond :64-92) ------------

BASIC_ACTIONS = {
    'noop': dict(),
    'attack': dict(attack=1),
    'turn_up': dict(camera=(-15, 0)),
    'turn_down': dict(camera=(15, 0)),
    'turn_left': dict(camera=(0, -15)),
    'turn_right': dict(camera=(0, 15)),
    'forward': dict(forward=1),
    'back': dict(back=1),
    'left': dict(left=1),
    'right': dict(right=1),
    'jump': dict(jump=1, forward=1),
    'place_dirt': dict(place='dirt'),
}

DIAMOND_ACTIONS = {
    **BASIC_ACTIONS,
    'craft_planks': dict(craft='planks'),
    'craft_stick': dict(craft='stick'),
    'craft_crafting_table': dict(craft='crafting_table'),
    'place_crafting_table': dict(place='crafting_table'),
    'craft_wooden_pickaxe': dict(nearbyCraft='wooden_pickaxe'),
    'craft_stone_pickaxe': dict(nearbyCraft='stone_pickaxe'),
    'craft_iron_pickaxe': dict(nearbyCraft='iron_pickaxe'),
    'equip_stone_pickaxe': dict(equip='stone_pickaxe'),
    'equip_wooden_pickaxe': dict(equip='wooden_pickaxe'),
    'equip_iron_pickaxe': dict(equip='iron_pickaxe'),
    'craft_furnace': dict(nearbyCraft='furnace'),
    'place_furnace': dict(place='furnace'),
    'smelt_iron_ingot': dict(nearbySmelt='iron_ingot'),
}

# --- Factor grammars (minecraft_factor.py:22-52 Diamond1, :85-126 D2) -----

FACTOR1_GROUPS = dict(
    main=(
        dict(),
        dict(attack=1),
        dict(camera=(-15, 0)),
        dict(camera=(15, 0)),
        dict(camera=(0, -15)),
        dict(camera=(0, 15)),
        dict(forward=1),
        dict(back=1),
        dict(left=1),
        dict(right=1),
        dict(jump=1, forward=1),
    ),
    other=(
        dict(),
        dict(place='dirt'),
        dict(place='crafting_table'),
        dict(place='furnace'),
        dict(craft='planks'),
        dict(craft='stick'),
        dict(craft='crafting_table'),
        dict(nearbyCraft='wooden_pickaxe'),
        dict(nearbyCraft='stone_pickaxe'),
        dict(nearbyCraft='iron_pickaxe'),
        dict(nearbyCraft='furnace'),
        dict(nearbySmelt='iron_ingot'),
        dict(equip='stone_pickaxe'),
        dict(equip='wooden_pickaxe'),
        dict(equip='iron_pickaxe'),
    ),
)

FACTOR2_GROUPS = dict(
    move=(
        dict(),
        dict(forward=1),
        dict(back=1),
        dict(left=1),
        dict(right=1),
        dict(jump=1, forward=1),
    ),
    look=(
        dict(),
        dict(camera=(-15, 0)),
        dict(camera=(15, 0)),
        dict(camera=(0, -15)),
        dict(camera=(0, 15)),
    ),
    attack=(
        dict(),
        dict(attack=1),
    ),
    place=(
        dict(),
        dict(place='dirt'),
        dict(place='crafting_table'),
        dict(place='furnace'),
    ),
    make=(
        dict(),
        dict(craft='planks'),
        dict(craft='stick'),
        dict(craft='crafting_table'),
        dict(nearbyCraft='wooden_pickaxe'),
        dict(nearbyCraft='stone_pickaxe'),
        dict(nearbyCraft='iron_pickaxe'),
        dict(nearbyCraft='furnace'),
        dict(nearbySmelt='iron_ingot'),
    ),
    equip=(
        dict(),
        dict(equip='stone_pickaxe'),
        dict(equip='wooden_pickaxe'),
        dict(equip='iron_pickaxe'),
    ),
)

# --- Keyboard grammar (minecraft_keyboard.py:180-238) ---------------------

KEYBOARD_NOOP = {
    'ESC': 0, 'back': 0, 'drop': 0, 'forward': 0, 'hotbar.1': 0,
    'hotbar.2': 0, 'hotbar.3': 0, 'hotbar.4': 0, 'hotbar.5': 0,
    'hotbar.6': 0, 'hotbar.7': 0, 'hotbar.8': 0, 'hotbar.9': 0,
    'inventory': 0, 'jump': 0, 'left': 0, 'right': 0, 'sneak': 0,
    'sprint': 0, 'swapHands': 0, 'camera': (0, 0), 'attack': 0, 'use': 0,
    'pickItem': 0}

# (name, MineRL command, VPT recording key)
KEYBOARD_KEYS = (
    ('attack', 'attack', 'mouse.button.0'),
    ('back', 'back', 'key.keyboard.s'),
    ('drop', 'drop', 'key.keyboard.q'),
    ('escape', 'ESC', 'key.keyboard.escape'),
    ('forward', 'forward', 'key.keyboard.w'),
    ('hotbar1', 'hotbar.1', 'key.keyboard.1'),
    ('hotbar2', 'hotbar.2', 'key.keyboard.2'),
    ('hotbar3', 'hotbar.3', 'key.keyboard.3'),
    ('hotbar4', 'hotbar.4', 'key.keyboard.4'),
    ('hotbar5', 'hotbar.5', 'key.keyboard.5'),
    ('hotbar6', 'hotbar.6', 'key.keyboard.6'),
    ('hotbar7', 'hotbar.7', 'key.keyboard.7'),
    ('hotbar8', 'hotbar.8', 'key.keyboard.8'),
    ('hotbar9', 'hotbar.9', 'key.keyboard.9'),
    ('inventory', 'inventory', 'key.keyboard.e'),
    ('jump', 'jump', 'key.keyboard.space'),
    ('left', 'left', 'key.keyboard.a'),
    ('pick', 'pickItem', 'mouse.button.2'),
    ('right', 'right', 'key.keyboard.d'),
    ('sneak', 'sneak', 'key.keyboard.left.shift'),
    ('sprint', 'sprint', 'key.keyboard.left.control'),
    ('swaphands', 'swapHands', 'key.keyboard.f'),
    ('use', 'use', 'mouse.button.1'),
)

MOUSE_BINS = 11
MOUSE_LIMIT = 66.6667
MOUSE_MU = 10

LOG_ITEMS = (
    'oak_log', 'birch_log', 'dark_oak_log', 'jungle_log', 'acacia_log',
    'spruce_log')
PLANK_ITEMS = (
    'oak_planks', 'birch_planks', 'dark_oak_planks', 'jungle_planks',
    'acacia_planks', 'spruce_planks')

# Keyboard Diamond reward table: item -> (times, reward each)
# (minecraft_keyboard.py:22-38).
KEYBOARD_DIAMOND_REWARDS = {
    LOG_ITEMS:         (8, 1 / 8),
    PLANK_ITEMS:       (20, 1 / 20),
    'stick':           (16, 1 / 16),
    'crafting_table':  (1, 1),
    'wooden_pickaxe':  (1, 1),
    'cobblestone':     (11, 1 / 11),
    'stone_pickaxe':   (1, 1),
    'furnace':         (1, 1),
    'coal':            (5, 2 / 5),
    'torch':           (16, 1 / 8),
    'iron_ore':        (3, 4 / 3),
    'iron_ingot':      (3, 4 / 3),
    'iron_pickaxe':    (1, 4),
    'diamond':         (None, 8 / 3),
    'diamond_pickaxe': (None, 8),
}

# Flat/factor Diamond milestone items (one-time rewards,
# minecraft_flat.py:82-96).
DIAMOND_MILESTONES = (
    'log', 'planks', 'stick', 'crafting_table', 'wooden_pickaxe',
    'cobblestone', 'stone_pickaxe', 'iron_ore', 'furnace', 'iron_ingot',
    'iron_pickaxe', 'diamond')


def mouse_discretize(xy, limit=MOUSE_LIMIT, bins=MOUSE_BINS, mu=MOUSE_MU):
  """mu-law compand a camera delta into bin indices (keyboard mode)."""
  x = np.clip(np.asarray(xy, np.float32) / limit, -1, 1)
  x = np.sign(x) * (np.log1p(mu * np.abs(x)) / np.log1p(mu))
  return np.round((x + 1) / 2 * (bins - 1)).astype(np.int32)


def mouse_undiscretize(idx, limit=MOUSE_LIMIT, bins=MOUSE_BINS, mu=MOUSE_MU):
  """Inverse of mouse_discretize."""
  idx = np.asarray(idx, np.int32)
  assert ((0 <= idx) & (idx < bins)).all(), idx
  x = idx / (bins - 1) * 2 - 1
  x = np.sign(x) * (1 / mu) * ((1 + mu) ** np.abs(x) - 1)
  return x * limit


def flat_actions(task):
  return DIAMOND_ACTIONS if task == 'diamond' else BASIC_ACTIONS


def factor_groups(variant):
  return {'factor1': FACTOR1_GROUPS, 'factor2': FACTOR2_GROUPS}[variant]


def flat_act_space(task):
  return {
      'action': Space(np.int32, (), 0, len(flat_actions(task))),
      'reset': Space(bool),
  }


def factor_act_space(variant):
  groups = factor_groups(variant)
  spaces = {
      name: Space(np.int32, (), 0, len(entries))
      for name, entries in groups.items()}
  return {**spaces, 'reset': Space(bool)}


def keyboard_act_space():
  return {
      'mouse': Space(np.int32, (), 0, MOUSE_BINS * MOUSE_BINS),
      'keys': Space(np.int32, (len(KEYBOARD_KEYS),), 0, 2),
      'reset': Space(bool),
  }


def _merge(base, update):
  for key, value in update.items():
    if key == 'camera':
      prev = base.get('camera', (0, 0))
      base['camera'] = (prev[0] + value[0], prev[1] + value[1])
    else:
      base[key] = value
  return base


def translate_flat(action, task):
  """Flat index -> full MineRL action dict."""
  entries = tuple(flat_actions(task).values())
  return _merge(dict(NOOP), entries[int(action['action'])])


def translate_factor(action, variant):
  """Factor group indices -> one merged simultaneous MineRL action."""
  base = dict(NOOP)
  for name, entries in factor_groups(variant).items():
    _merge(base, entries[int(action[name])])
  return base


def translate_keyboard(action):
  """Multi-hot keys + binned mouse -> raw HumanSurvival action dict."""
  result = dict(KEYBOARD_NOOP)
  mouse = int(action['mouse'])
  bx, by = divmod(mouse, MOUSE_BINS)
  cam = mouse_undiscretize(np.array([bx, by], np.int32))
  result['camera'] = (float(cam[0]), float(cam[1]))
  for (name, command, rec), pressed in zip(
      KEYBOARD_KEYS, np.asarray(action['keys'])):
    result[command] = int(pressed)
  return result


class StickyController:
  """Sticky attack/jump and pitch limiting (minecraft_flat.py:325-345)."""

  def __init__(self, sticky_attack=30, sticky_jump=10,
               pitch_limit=(-60, 60)):
    self.sticky_attack = sticky_attack
    self.sticky_jump = sticky_jump
    self.pitch_limit = pitch_limit
    self.reset()

  def reset(self):
    self._attack_left = 0
    self._jump_left = 0
    self._pitch = 0

  def __call__(self, action):
    if self.sticky_attack:
      if action.get('attack'):
        self._attack_left = self.sticky_attack
      if self._attack_left > 0:
        action['attack'] = 1
        action['jump'] = 0
        self._attack_left -= 1
    if self.sticky_jump:
      if action.get('jump'):
        self._jump_left = self.sticky_jump
      if self._jump_left > 0:
        action['jump'] = 1
        action['forward'] = 1
        self._jump_left -= 1
    if self.pitch_limit and action.get('camera', (0, 0))[0]:
      lo, hi = self.pitch_limit
      pitch_delta = action['camera'][0]
      if not (lo <= self._pitch + pitch_delta <= hi):
        action['camera'] = (0, action['camera'][1])
        pitch_delta = 0
      self._pitch += pitch_delta
    return action


class CollectReward:
  """Inventory milestone reward with once/repeated modes and an optional
  cap on repeated collections (unifies minecraft_flat.py CollectReward and
  the keyboard variant with `times`)."""

  def __init__(self, items, once=0, repeated=0, times=None):
    self.items = (items,) if isinstance(items, str) else tuple(items)
    self.once = once
    self.repeated = repeated
    self.times = times if times is not None else float('inf')
    self.previous = 0
    self.maximum = 0
    self.total = 0

  def __call__(self, obs, inventory):
    current = sum(inventory.get(item, 0) for item in self.items)
    if obs['is_first']:
      self.previous = current
      self.maximum = current
      self.total = 0
      return 0.0
    obtained = max(0, current - self.previous)
    rewarded = min(obtained, max(0, self.times - self.total))
    reward = self.repeated * rewarded
    if self.maximum == 0 and current > 0:
      reward += self.once
    self.previous = current
    self.total += obtained
    self.maximum = max(self.maximum, current)
    return reward


class HealthReward:

  def __init__(self, scale=0.01):
    self.scale = scale
    self.previous = None

  def __call__(self, obs, inventory=None):
    health = float(obs.get('health', 1.0))
    if obs['is_first'] or self.previous is None:
      self.previous = health
      return 0.0
    reward = self.scale * (health - self.previous)
    self.previous = health
    return float(reward)


def task_rewards(task, mode):
  """Reward stack per task, matching the per-module wrappers."""
  if task == 'wood':
    return [CollectReward('log', repeated=1), HealthReward()]
  if task == 'climb':
    return []  # Height delta handled by the env (needs position obs).
  if task == 'diamond' and mode == 'keyboard':
    return [CollectReward(items, repeated=rew, times=times)
            for items, (times, rew) in KEYBOARD_DIAMOND_REWARDS.items()]
  if task == 'diamond':
    return [CollectReward(item, once=1) for item in DIAMOND_MILESTONES] + [
        HealthReward()]
  raise KeyError(task)


class Minecraft:
  """MineRL env with the selected grammar. Requires the minerl package."""

  def __init__(self, task, size=(64, 64), break_speed=100.0, logs=False,
               length=36000, actions='flat', seed=None):
    try:
      import minerl  # noqa: F401
      import gym
    except ImportError:
      raise ImportError('The Minecraft env requires minerl (and a JDK)')
    if actions == 'factor':
      actions = 'factor1'
    assert actions in ('flat', 'factor1', 'factor2', 'keyboard'), actions
    assert task in ('wood', 'climb', 'diamond'), task
    self._task = task
    self._mode = actions
    self._env = gym.make('MineRLObtainDiamondShovel-v0')
    self._size = tuple(size)
    self._length = length
    self._logs = logs
    self._rewards = task_rewards(task, actions)
    # Sticky attack disabled when break_speed is boosted (reference:
    # minecraft_flat.py:306-307).
    sticky_attack = 0 if break_speed != 1.0 else 30
    self._sticky = StickyController(sticky_attack=sticky_attack)
    self._inventory = {}
    self._max_y = None
    self._step_count = 0
    self._done = True

  @property
  def obs_space(self):
    spaces = {
        'image': Space(np.uint8, (*self._size, 3)),
        'inventory': Space(np.float32, len(DIAMOND_MILESTONES)),
        'inventory_max': Space(np.float32, len(DIAMOND_MILESTONES)),
        'health': Space(np.float32),
        'reward': Space(np.float32),
        'is_first': Space(bool),
        'is_last': Space(bool),
        'is_terminal': Space(bool),
    }
    if self._logs:
      spaces.update({
          f'log/{item}': Space(np.int32) for item in DIAMOND_MILESTONES})
    return spaces

  @property
  def act_space(self):
    if self._mode in ('factor1', 'factor2'):
      return factor_act_space(self._mode)
    if self._mode == 'keyboard':
      return keyboard_act_space()
    return flat_act_space(self._task)

  def _translate(self, action):
    if self._mode in ('factor1', 'factor2'):
      raw = translate_factor(action, self._mode)
    elif self._mode == 'keyboard':
      raw = translate_keyboard(action)
    else:
      raw = translate_flat(action, self._task)
    return self._sticky(raw)

  def step(self, action):
    if action['reset'] or self._done:
      obs = self._env.reset()
      self._sticky.reset()
      self._max_y = None
      self._step_count = 0
      self._done = False
      self._inventory = {
          k: int(np.asarray(v)) for k, v in obs.get('inventory', {}).items()}
      # Reset per-episode reward-fn state (milestone maxima, repeat caps,
      # health baseline) against the post-respawn inventory/health, since
      # later per-step views always carry is_first=False.
      view = {'is_first': True, 'health': self._health_of(obs)}
      for fn in self._rewards:
        fn(view, self._inventory)
      return self._obs(obs, 0.0, is_first=True)
    raw = self._translate(action)
    obs, _, done, _ = self._env.step(self._to_gym_action(raw))
    self._step_count += 1
    self._inventory = {
        k: int(np.asarray(v)) for k, v in obs.get('inventory', {}).items()}
    view = {'is_first': False, 'health': self._health_of(obs)}
    reward = sum(fn(view, self._inventory) for fn in self._rewards)
    if self._task == 'climb':
      y = float(obs.get('location_stats', {}).get('ypos', 0.0))
      if self._max_y is None:
        self._max_y = y
      reward += max(0.0, y - self._max_y)
      self._max_y = max(self._max_y, y)
    self._done = done or self._step_count >= self._length
    return self._obs(obs, reward, is_last=self._done, is_terminal=done)

  def _to_gym_action(self, raw):
    act = self._env.action_space.noop()
    for key, value in raw.items():
      if key in act:
        act[key] = value
    return act

  def _health_of(self, obs):
    stats = obs.get('life_stats', {})
    return float(np.asarray(stats.get('life', 20.0))) / 20.0

  @property
  def inventory(self):
    return self._inventory

  def _obs(self, obs, reward, is_first=False, is_last=False,
           is_terminal=False):
    image = np.asarray(obs['pov'], np.uint8)
    if image.shape[:2] != self._size:
      from PIL import Image
      image = np.array(
          Image.fromarray(image).resize(self._size, Image.BILINEAR))
    inv = np.array([
        np.log1p(float(self._inventory.get(item, 0)))
        for item in DIAMOND_MILESTONES], np.float32)
    if is_first or not hasattr(self, '_inv_max'):
      self._inv_max = inv
    self._inv_max = np.maximum(self._inv_max, inv)
    result = {
        'image': image,
        'inventory': inv,
        'inventory_max': self._inv_max.copy(),
        'health': np.float32(self._health_of(obs)),
        'reward': np.float32(reward),
        'is_first': is_first,
        'is_last': is_last,
        'is_terminal': is_terminal,
    }
    if self._logs:
      result.update({
          f'log/{item}': np.int32(self._inventory.get(item, 0))
          for item in DIAMOND_MILESTONES})
    return result

  def close(self):
    try:
      self._env.close()
    except Exception:
      pass
