"""A quadruped walker for the LocoNav mazes, built programmatically.

A copy of embodied_tpu/envs/loconav_quadruped.py. It builds the MJCF model
in code: a box torso with four two-joint legs (hip swing + knee), position
actuators, IMU sensors (gyro / accelerometer / velocimeter), and an
egocentric camera, implementing the dm_control `legacy_base.Walker`
interface (root_body, observable_joints, actuators, end_effectors,
ground_contact_geoms, egocentric_camera).
"""

import numpy as np


def _build_model(name, size=0.2):
  from dm_control import mjcf
  s = size
  root = mjcf.RootElement(model=name)
  root.compiler.angle = 'radian'  # Locomotion arenas attach in radians.
  root.default.joint.damping = 1.0
  root.default.joint.armature = 0.01
  root.default.geom.friction = (1.0, 0.5, 0.5)
  root.default.geom.condim = 3

  torso = root.worldbody.add('body', name='torso')
  torso.add(
      'geom', name='torso_geom', type='box', size=(1.5 * s, s, 0.4 * s),
      mass=8.0, rgba=(0.55, 0.3, 0.15, 1.0))
  torso.add('site', name='imu', pos=(0, 0, 0), size=(0.01,))
  torso.add(
      'camera', name='egocentric', pos=(1.5 * s, 0, 0.2 * s),
      xyaxes=(0, -1, 0, 0.2, 0, 1), fovy=60)

  legs = {
      'front_left': (1.1 * s, 0.9 * s),
      'front_right': (1.1 * s, -0.9 * s),
      'back_left': (-1.1 * s, 0.9 * s),
      'back_right': (-1.1 * s, -0.9 * s),
  }
  feet = []
  for leg, (x, y) in legs.items():
    upper = torso.add('body', name=f'{leg}_upper', pos=(x, y, -0.2 * s))
    upper.add(
        'joint', name=f'{leg}_hip', type='hinge', axis=(0, 1, 0),
        range=np.deg2rad((-45, 45)))
    upper.add(
        'joint', name=f'{leg}_abduct', type='hinge', axis=(1, 0, 0),
        range=np.deg2rad((-30, 30)))
    upper.add(
        'geom', name=f'{leg}_upper_geom', type='capsule',
        fromto=(0, 0, 0, 0, 0, -s), size=(0.3 * s,), mass=0.6)
    lower = upper.add('body', name=f'{leg}_lower', pos=(0, 0, -s))
    lower.add(
        'joint', name=f'{leg}_knee', type='hinge', axis=(0, 1, 0),
        range=np.deg2rad((-70, 70)))
    lower.add(
        'geom', name=f'{leg}_foot_geom', type='capsule',
        fromto=(0, 0, 0, 0, 0, -s), size=(0.25 * s,), mass=0.4)
    feet.append(lower)

  for joint in root.find_all('joint'):
    root.actuator.add(
        'position', name=f'{joint.name}_act', joint=joint, kp=60,
        ctrlrange=list(joint.range), forcerange=(-40, 40))

  root.sensor.add('gyro', name='gyro', site='imu')
  root.sensor.add('accelerometer', name='accelerometer', site='imu')
  root.sensor.add('velocimeter', name='velocimeter', site='imu')
  return root, feet


def make_walker_class():
  """Returns the Quadruped walker class (constructed lazily so importing
  this module does not require dm_control)."""
  from dm_control import composer
  from dm_control.locomotion.walkers import base
  from dm_control.locomotion.walkers import legacy_base

  class Quadruped(legacy_base.Walker):
    """Box-torso quadruped with hip/abduct/knee legs."""

    def _build(self, name='walker', size=0.2, initializer=None):
      super()._build(initializer=initializer)
      self._size = size
      self._mjcf_root, self._feet = _build_model(name or 'quadruped', size)

    @property
    def mjcf_model(self):
      return self._mjcf_root

    @property
    def upright_pose(self):
      return base.WalkerPose(xpos=(0, 0, 1.6 * self._size))

    @composer.cached_property
    def root_body(self):
      return self._mjcf_root.find('body', 'torso')

    @composer.cached_property
    def actuators(self):
      return self._mjcf_root.find_all('actuator')

    @composer.cached_property
    def observable_joints(self):
      return self._mjcf_root.find_all('joint')

    @composer.cached_property
    def end_effectors(self):
      return tuple(self._feet)

    @composer.cached_property
    def ground_contact_geoms(self):
      return tuple(
          foot.find('geom', f'{foot.name.replace("_lower", "")}_foot_geom')
          for foot in self._feet)

    @composer.cached_property
    def egocentric_camera(self):
      return self._mjcf_root.find('camera', 'egocentric')

    def aliveness(self, physics):
      # Torso z-axis alignment with world up: 0 when upright, -1 flipped.
      zz = physics.bind(self.root_body).xmat[8]
      return min(0.0, float(zz) - 1.0) / 2

  return Quadruped
