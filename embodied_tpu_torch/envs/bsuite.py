"""BSuite adapter. A copy of embodied_tpu/envs/bsuite.py.

Note: bsuite environments log internally and assume a single sequential
agent loop per environment id.
"""

from . import from_dm


class BSuite(from_dm.FromDM):

  def __init__(self, task, logdir=None):
    try:
      import bsuite
    except ImportError:
      raise ImportError('The BSuite env requires bsuite')
    if logdir:
      env = bsuite.load_and_record(
          task, save_path=str(logdir), overwrite=True)
    else:
      env = bsuite.load_from_id(task)
    super().__init__(env)
