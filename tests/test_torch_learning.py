"""Learning checks of the port: its agents improve on trivially learnable
tasks, with the JAX package's settings and thresholds
(tests/test_learning.py), on the CPU.

- PPO on 'dummy_bandit', which rewards one fixed action out of five (a
  random policy scores some 20 per 100-step episode, the best 99): the
  late episodes' mean score beats the early ones' by 10 and exceeds 40.
- DreamerV3 on 'dummy_disc', whose rewards are a function of the
  observable step counter: the logged reward loss starts above 1.0 and
  falls below 0.5 within 400 env steps.
"""

import json

import numpy as np
import pytest

from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main as dmain
from embodied_tpu_torch.models.ppo import main as pmain

pytestmark = pytest.mark.slow


def test_ppo_learns_bandit(tmp_path):
  config = common.assemble_config(pmain.CONFIGS, [
      '--configs', 'debug',
      '--task', 'dummy_bandit',
      '--logdir', str(tmp_path),
      '--batch_size', '8',
      '--batch_length', '16',
      '--replay_context', '0',
      '--run.steps', '3000',
      '--run.train_ratio', '64',
      '--run.log_every', '2',
      '--run.report_every', '1e9',
      '--run.save_every', '1e9',
      '--run.envs', '4',
      '--replay.size', '4e3',
      '--agent.opt.lr', '3e-3',
      '--agent.opt.warmup', '20',
      '--agent.enc.impala.depth', '4',
      '--agent..*\\.units', '32',
  ])
  common.run_script(config, pmain.make_agent)
  scores = [json.loads(line) for line in open(tmp_path / 'scores.jsonl')
            if line.strip()]
  assert len(scores) >= 10, len(scores)
  half = len(scores) // 2
  early = np.mean([s['score'] for s in scores[:max(3, half // 2)]])
  late = np.mean([s['score'] for s in scores[-max(3, half // 2):]])
  assert late > early + 10, (early, late)
  assert late > 40, (early, late)


def test_reward_loss_decreases(tmp_path):
  config = common.assemble_config(dmain.CONFIGS, [
      '--configs', 'debug',
      '--task', 'dummy_disc',
      '--logdir', str(tmp_path),
      '--run.steps', '400',
      '--run.train_ratio', '32',
      '--run.log_every', '2',
      '--run.save_every', '9999',
      '--agent.opt.lr', '1e-3',
      '--agent.opt.warmup', '50',
  ])
  common.run_script(config, dmain.make_agent)
  records = [json.loads(line) for line in open(tmp_path / 'metrics.jsonl')]
  records = [r['train/loss/rew'] for r in records if 'train/loss/rew' in r]
  assert len(records) >= 3, records
  assert records[0] > 1.0, records
  assert min(records) < 0.5, records
