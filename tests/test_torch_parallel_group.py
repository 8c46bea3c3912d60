"""The port's `script=parallel` on a process group, on gloo ranks of this
host's CPU (run/parallel_impl.py, models/common.py).

- `main --script parallel --torch.mock_devices 2 --torch.mesh 2,1,1`
  runs on two spawned gloo ranks, each with its own envs, replay and
  logger, and ends on an interrupt once both ranks' logs hold what the
  test reads (on the parent, or on every process as a terminal's Ctrl-C
  reaches them): both exit and no process prints a traceback (no role
  dies of the interrupt, no rank's ending is cut short), rank 0's logdir and `rank1/` each hold finite
  train losses, a report and valid latent-table reads (the actor's
  scatters and the learner's reads inside the rank's slot range), and
  the two agent checkpoints hold the same train steps and the same store
  bit for bit (the step is data parallel).
- The lockstep of the learners: two gloo ranks drive `_Learner` over
  in-process feeds with a stub agent whose train step makes one
  all-reduce. Rank 1's train feed is slow and its eval feed late, and
  only rank 0 asks to stop: both make the same train calls, report
  (with or without an evaluation) and save at the same train-call
  indices, end soon after the request, and no thread but the learner's
  calls a collective.
- The Agent's other threads make no collective: policy calls (on the
  replicated store, on a '1,2,1' sharded store's copy, under the
  policy/train split) and the prefetch thread of `Agent.stream` run
  beside a learner thread's train steps and saves, and only that thread
  calls one.
- A rank whose launcher started the default group itself (gloo ranks
  that share one card) keeps it, and setup raises where the group's rank
  or size is not the one given.
- The role scripts under `torch.mock_devices 2` (and with a coordinator
  address) run once, in this process, with no group, as in the JAX
  package; a fixed role address on a rank with LOCAL_RANK > 0 raises.

The JAX package's own `script=parallel` on a mesh is one process that
acts once and trains on the whole batch; what the port's two ranks hold
against JAX (one learner step against the '2,1,1' mesh step) is in
tests/test_torch_distributed.py.
"""

import os
import pickle

import numpy as np
import pytest
import torch.distributed as dist

from embodied_tpu_torch.models import common
from embodied_tpu_torch.models.dreamerv3 import main
from embodied_tpu_torch.run import parallel_impl
from test_torch_distributed import DREAMER, HOST_PATH, launch
from test_torch_parallel import check_run, parallel_argv, run_child


@pytest.mark.parametrize('terminal', [False, True])
def test_parallel_script_on_two_mock_ranks(tmp_path, terminal):
  """The interrupt reaches the parent, which sends it on to the ranks,
  or (`terminal`) every process of the run, as a terminal's Ctrl-C."""
  dirs = [tmp_path, tmp_path / 'rank1']
  events = [('fps/train', True), ('train/latents/valid', True),
            ('report/', False)]
  argv = parallel_argv(
      tmp_path, '--run.duration', '150', '--torch.mock_devices', '2',
      '--torch.mesh', '2,1,1', '--batch_size', '4')
  left = run_child('dreamerv3', argv, timeout=300, logdir=dirs,
                   events=events, saved=True, terminal=terminal,
                   clean=True)
  saves = [pickle.loads((d / 'agent.pkl').read_bytes())['agent']
           for d in dirs]
  trained = [save['counters']['train'] for save in saves]
  assert trained[0] == trained[1] > 0, trained
  for folder, steps in zip(dirs, trained):
    lines = check_run(folder, dict(left, train_calls=steps))
    losses = [v for l in lines for k, v in l.items()
              if k.startswith('train/loss/')]
    assert losses and np.all(np.isfinite(losses)), folder
    assert any(k.startswith('report/') for l in lines for k in l), folder
    assert (folder / 'config.yaml').exists()
  assert not (tmp_path / 'rank0').exists()
  assert sorted(saves[0]['store']) == sorted(saves[1]['store'])
  for key, value in saves[0]['store'].items():
    np.testing.assert_array_equal(saves[1]['store'][key], value,
                                  err_msg=key)


def test_learners_keep_lockstep(tmp_path):
  ranks = launch('lockstep', dict(
      slow=0.05, late=1.5, request_s=3.5, report_every=0.3,
      save_every=0.5, join_s=60), tmp_path)
  one, two = ranks
  assert one['trains'] == two['trains'] == one['agent_trains'] > 10, ranks
  assert one['reports'] == two['reports'], ranks
  assert one['saves'] == two['saves'], ranks
  assert len(one['reports']) >= 2 and one['saves'], ranks
  # Rank 1's eval feed gave nothing before the first report: the
  # evaluation waits for every rank's, and then comes with the reports.
  assert not one['reports'][0][1] and one['reports'][-1][1], ranks
  assert all(rank['threads'] == ['learner'] for rank in ranks), ranks
  assert one['stop_s'] < 5, ranks  # from rank 0's request to its end


def test_only_the_learner_thread_makes_collectives(tmp_path):
  placements = [('2,1,1', ''), ('1,2,1', ''), ('2,1,1', '1,1,1')]
  ranks = launch('threads', dict(
      argv=DREAMER + HOST_PATH + ['--batch_size', '4'],
      placements=placements, steps=3), tmp_path)
  for rank in ranks:
    for (mesh, split), got in zip(placements, rank):
      assert got['threads'] == ['learner'], (mesh, split, got)
      assert got['trains'] == 3 and got['policy_calls'] > 0, got
      assert got['sharded'] == (mesh == '1,2,1'), got
      assert got['policy_copy'] == (mesh == '1,2,1' or bool(split)), got


def test_setup_keeps_a_group_of_its_rank(tmp_path):
  ranks = launch('kept', {}, tmp_path)
  for rank, got in enumerate(ranks):
    assert got['devices'] == 2, got
    assert got['errors'] == [
        f'The process group already started is rank {rank} of 2, not '
        f'rank {1 - rank} of 2',
        f'The process group already started is rank {rank} of 2, not '
        f'rank {rank} of 3'], got


@pytest.mark.parametrize('coordinator', [False, True])
@pytest.mark.parametrize('script', common.ROLE_SCRIPTS)
def test_role_scripts_run_once_without_a_group(
    tmp_path, monkeypatch, script, coordinator):
  calls = []

  def role(*args, **kwargs):
    calls.append((os.getpid(), dist.is_initialized()))

  def spawn(*args):
    raise AssertionError('a role script spawned ranks')
  monkeypatch.setattr(parallel_impl, script, role)
  monkeypatch.setattr(common, 'spawn_ranks', spawn)
  argv = ['--configs', 'debug', '--task', 'dummy_disc', '--script', script,
          '--logdir', str(tmp_path), '--torch.mock_devices', '2']
  if coordinator:
    argv += ['--torch.coordinator_address', 'localhost:1']
  main.main(argv)
  assert calls == [(os.getpid(), False)]
  assert not (tmp_path / 'rank1').exists()


@pytest.mark.parametrize('key', ['actor_addr', 'replay_addr', 'logger_addr'])
def test_fixed_address_raises_beside_rank_zero(monkeypatch, key):
  """A rank with LOCAL_RANK > 0 runs its own roles on rank 0's host: a
  fixed address would be rank 0's too, so combined raises naming it
  before any role starts."""
  from embodied_tpu_torch.utils import Config
  monkeypatch.setenv('LOCAL_RANK', '1')
  args = Config(actor_batch=1, envs=2, **{
      k: 'localhost:{auto}' for k in (
          'actor_addr', 'replay_addr', 'logger_addr')}).update(
              {key: 'localhost:5555'})
  with pytest.raises(ValueError, match=f'run.{key}'):
    parallel_impl.combined(*[None] * 7, args)
