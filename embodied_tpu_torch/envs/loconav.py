"""Locomotion navigation mazes over dm_control.

A copy of embodied_tpu/envs/loconav.py: ant/quadruped walkers navigating
procedurally-built mazes with image + proprio obs. Gated on dm_control
(locomotion soccer/mazes submodules).
"""

import functools
import os

import numpy as np

from ..utils import Space
from . import from_dm

MAZES = {
    's': '*****\n*PG *\n*****',
    'm': ('*******\n*P    *\n* *** *\n*   G *\n*******'),
    'l': ('*********\n*P      *\n* ***** *\n*       *\n* ***** *\n'
          '*     G *\n*********'),
}


class LocoNav:

  def __init__(self, task, size=(64, 64), repeat=1, camera=-1, again=False,
               seed=None):
    os.environ.setdefault('MUJOCO_GL', 'egl')  # Headless rendering.
    try:
      from dm_control import composer
      from dm_control.locomotion.arenas import labmaze_textures, mazes
      from dm_control.locomotion.props import target_sphere
      from dm_control.locomotion.tasks import random_goal_maze
      from dm_control.locomotion.walkers import ant
    except ImportError:
      raise ImportError('The LocoNav env requires dm_control[locomotion]')
    # Tasks look like 'ant_maze_m': walker, arena style, maze size.
    parts = task.split('_')
    walker_name, maze_name = parts[0], parts[-1]
    assert walker_name in ('ant', 'quadruped'), walker_name
    maze = MAZES.get(maze_name, MAZES['m'])
    if walker_name == 'quadruped':
      from . import loconav_quadruped
      walker = loconav_quadruped.make_walker_class()()
    else:
      walker = ant.Ant()
    skybox = labmaze_textures.SkyBox(style='sky_03')
    wall = labmaze_textures.WallTextures(style='style_01')
    floor = labmaze_textures.FloorTextures(style='style_01')
    arena = mazes.MazeWithTargets(
        maze=_FixedMaze(maze), xy_scale=2.0, z_height=2.0,
        skybox_texture=skybox, wall_textures=wall, floor_textures=floor)
    task_obj = random_goal_maze.RepeatSingleGoalMaze(
        walker=walker, maze_arena=arena,
        target=target_sphere.TargetSphere(),
        max_repeats=0 if not again else 100,
        target_reward_scale=50.0,
        physics_timestep=0.005, control_timestep=0.03)
    env = composer.Environment(
        time_limit=30, task=task_obj, random_state=seed,
        strip_singleton_obs_buffer_dim=True)
    self._dmenv = env
    self._env = from_dm.FromDM(env)
    self._size = tuple(size)
    self._repeat = repeat
    # Default to the last fixed camera (the walker's egocentric one).
    ncam = env.physics.model.ncam
    self._camera = camera if camera >= 0 else ncam - 1

  @functools.cached_property
  def obs_space(self):
    spaces = {
        k: v for k, v in self._env.obs_space.items()
        if k in ('reward', 'is_first', 'is_last', 'is_terminal')
        or not k.startswith('walker/egocentric_camera')}
    spaces['image'] = Space(np.uint8, (*self._size, 3))
    return spaces

  @property
  def act_space(self):
    return self._env.act_space

  def step(self, action):
    reward = 0.0
    for _ in range(self._repeat if not action['reset'] else 1):
      obs = self._env.step(action)
      reward += obs['reward']
      if obs['is_last'] or action['reset']:
        break
    obs['reward'] = np.float32(reward)
    obs = {k: v for k, v in obs.items()
           if not k.startswith('walker/egocentric_camera')}
    obs['image'] = self._dmenv.physics.render(
        *self._size, camera_id=self._camera)
    return obs

  def close(self):
    self._env.close()


class _FixedMaze:
  """Minimal labmaze-compatible wrapper around an ASCII maze string."""

  def __init__(self, text):
    import labmaze
    self._maze = labmaze.FixedMazeWithRandomGoals(
        entity_layer=text + '\n')

  def __getattr__(self, name):
    return getattr(self._maze, name)
