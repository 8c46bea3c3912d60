"""The program's spans as the benchmark reads them (harness/spans.py), on
the CPU: a synthetic trace reduced by the program's spans, with an idle
gap named by the innermost one; the host readers on the port's own timer
after a profiled stretch; and every reader of this module's metrics
reading None where its fields are missing."""

import json
import pathlib
import types

import pytest
import torch

from benchmark.harness import spans, spec as speclib
from embodied_tpu_torch.utils import timer

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
READERS = [m['name'] for m in BENCH['per_layer']
           if m['source'] == 'program_span']
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _event(name, start, end, device=CPU, annotation=False, corr=0):
  return types.SimpleNamespace(
      name=name, time_range=types.SimpleNamespace(start=start, end=end),
      device_type=device, id=corr, is_user_annotation=annotation)


def test_a_gap_is_named_by_the_innermost_program_span():
  events = [
      _event('bench/train', 0, 100, annotation=True),
      _event('train#7', 0, 100, annotation=True),
      _event('train/backward', 10, 60, annotation=True),
      # An op on the host whose id is a launch's correlation id.
      _event('aten::add_', 70, 72, corr=2),
      # The autograd thread's launch while the caller waits in backward,
      # and the main thread's after it.
      _event('cudaLaunchKernel', 20, 21, corr=1),
      _event('cuLaunchKernel', 71, 71.5, corr=2),
      _event('cudaMemcpyAsync', 72, 73, corr=3),
      _event('tc16_kernel', 25, 40, CUDA, corr=1),
      _event('finish_kernel', 75, 85, CUDA, corr=2),
      _event('Memcpy DtoH (Device -> Pinned)', 85, 90, CUDA, corr=3),
      # Mirrored annotations, no work.
      _event('train/backward', 25, 40, CUDA, annotation=True),
      _event('train#7', 25, 90, CUDA),
      # Work launched by a call the trace lacks.
      _event('orphan_kernel', 95, 96, CUDA, corr=9),
  ]
  out = spans.reduce(events, {'bench/train': 'inside Agent.train'})
  assert out['spans']['train/backward'] == {
      'calls': 1, 'device_us': 15, 'kernels': 1}
  assert out['spans']['train#'] == {'calls': 1, 'device_us': 30,
                                    'kernels': 2}
  assert out['launches'] == 3 and out['unplaced_us'] == 1
  assert out['idle_gaps'] == [
      ['inside Agent.train / train/backward', 35e-6],
      ['inside Agent.train / train#', 25e-6],
      ['inside Agent.train / train#', 5e-6],
      ['inside Agent.train / train#', 4e-6]]


def test_the_host_readers_read_the_timer_after_the_trace():
  record = {'driver': 'learn', 'trace': {'busy_us': 1.0}}
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]):
    with timer.section('train/loss'):
      pass
  for _ in range(4):
    with timer.section('train/loss'):
      pass
  seconds, count = timer.untraced()['train/loss']
  assert count == 4
  read = speclib.reader('loss_host_ms.learn', ROOT)
  assert read(record) == pytest.approx(1e3 * seconds / 4)
  assert speclib.reader('backward_host_ms.learn', ROOT)(record) is None
  assert read({**record, 'driver': 'script'}) is None


@pytest.mark.parametrize('name', READERS)
def test_a_reader_reads_none_without_its_fields(name, monkeypatch):
  read = speclib.reader(name, ROOT)
  driver = name.rsplit('.', 1)[1]
  assert read({}) is None
  assert read({'driver': driver}) is None
  monkeypatch.setattr(spans, 'untraced', lambda: None)
  assert read({'driver': driver, 'trace': {'busy_us': 1.0}}) is None
