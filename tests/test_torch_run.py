"""The port's single-host run against the JAX package: its replay and
training stream draw the same batches from the same inserts and seed, and
its `train` script trains, reports, saves and resumes on the CPU
(`--configs debug`), as tests/test_train.py and tests/test_dreamer_e2e.py
run the JAX package's.
"""

import json
import pathlib
import pickle

import numpy as np
import pytest
import torch

from embodied_tpu.models import common as jcommon
from embodied_tpu.models.dreamerv3 import main as jmain
from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main

# A replay small enough to evict: 3 workers insert 40 steps each into room
# for 60 sequences of 4 x 5 + 1 steps.
REPLAY = ['--configs', 'debug', '--task', 'dummy_disc', '--batch_size', '4',
          '--batch_length', '5', '--report_length', '3', '--replay.size',
          '60']
MIXTURE = ['--replay.fracs.uniform', '0.5', '--replay.fracs.priority',
           '0.25', '--replay.fracs.recency', '0.25']


def steps(seed, workers=3, length=40):
  """(step, worker) pairs, interleaved across workers; episodes of 7."""
  rng = np.random.default_rng(seed)
  for t in range(length):
    for worker in range(workers):
      yield dict(
          image=rng.integers(0, 255, (8, 8, 3), dtype=np.uint8),
          reward=np.float32(rng.standard_normal()),
          action=np.int32(rng.integers(0, 4)),
          is_first=t % 7 == 0, is_last=t % 7 == 6, is_terminal=False,
      ), worker


@pytest.mark.parametrize('fracs', [[], MIXTURE], ids=['uniform', 'mixture'])
def test_replay_and_stream_match_jax(tmp_path, fracs):
  """The same inserts, then batches from the train and report streams of
  both packages' make_replay and make_stream, interleaved: equal arrays
  (step ids, the consec column and every key)."""
  argv = REPLAY + fracs
  streams = []
  for package, path, name in (
      (jcommon, jmain.__file__, 'jax'), (common, main.__file__, 'torch')):
    config = package.assemble_config(
        pathlib.Path(path).with_name('configs.yaml'),
        argv + ['--logdir', str(tmp_path / name)])
    replay = package.make_replay(config, 'replay')
    for step, worker in steps(0):
      replay.add(step, worker)
    streams.append([iter(package.make_stream(config, replay, mode))
                    for mode in ('train', 'report')])
  for mode in (0, 0, 1, 0, 1, 0):
    want, got = next(streams[0][mode]), next(streams[1][mode])
    assert sorted(got) == sorted(want)
    for key in want:
      np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def script(logdir, steps):
  main.main([
      '--configs', 'debug', '--task', 'dummy_disc', '--logdir', str(logdir),
      '--batch_size', '2', '--batch_length', '8', '--report_length', '4',
      '--run.steps', str(steps), '--run.train_ratio', '4',
      '--run.log_every', '0.2', '--run.report_every', '0.5',
      '--run.save_every', '0.5', '--run.usage.psutil', 'False'])
  saved = pickle.loads((logdir / 'checkpoint.pkl').read_bytes())
  lines = [json.loads(line) for line in
           (logdir / 'metrics.jsonl').read_text().splitlines()]
  return int(saved['step']), saved['agent']['counters'], lines


@pytest.fixture
def one_thread():
  """The debug model's ops are tiny: one intra-op thread runs them as
  fast alone and keeps the run from stalling beside other test workers."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def test_train_script_trains_reports_and_resumes(tmp_path, capsys,
                                                 one_thread):
  step, counters, lines = script(tmp_path, 300)
  assert 0 < step <= 300 and counters['train'] > 0
  assert counters['report'] >= 1
  assert any(k.startswith('report/loss/') for line in lines for k in line)
  assert all(np.isfinite(line['train/loss/image']) for line in lines
             if 'train/loss/image' in line)
  assert 'Loading checkpoint' not in capsys.readouterr().out
  # Again on the same logdir with more steps: it loads the checkpoint and
  # continues the step and the agent's counters.
  again, counters2, lines = script(tmp_path, 600)
  assert 'Loading checkpoint' in capsys.readouterr().out
  assert step < again <= 600
  assert counters2['train'] > counters['train']
  assert counters2['report'] > counters['report']
  assert max(line['step'] for line in lines) > step
