"""The port's viewer (embodied_tpu_torch/viewer.py) against the JAX
package's on one logdir written by the port's logger: run discovery,
series, the terminal and the page equal. Then the port's trace loader on
a synthetic Chrome trace, and its HTTP server.

The JAX viewer's trace functions are not called: they import TensorFlow,
which crashes a worker that has loaded MuJoCo.
"""

import gzip
import json
import threading
import urllib.request

import numpy as np
import pytest

from embodied_tpu import viewer as jviewer
from embodied_tpu_torch import viewer
from embodied_tpu_torch.utils import (
    Counter, JSONLOutput, Logger, ScoreOutput)


def write_run(logdir, gain):
  """A run logged by the port's Logger: losses, scores, timer fractions."""
  step = Counter()
  logger = Logger(step, [JSONLOutput(logdir, 'metrics.jsonl'),
                         ScoreOutput(logdir, task='dummy_disc')])
  rng = np.random.default_rng(int(gain))
  for i in range(12):
    step.increment(100)
    logger.add({'loss/rec': 10.0 - gain * i + rng.normal(),
                'episode/score': gain * i, 'episode/length': 100,
                'timer/agent_train/frac': 0.6 - 0.01 * i,
                'timer/agent_policy/frac': 0.2 + 0.01 * i,
                'timer/agent_train/total': 3.0 * i})
    logger.write()
  logger.close()


@pytest.fixture
def logdir(tmp_path):
  for name, gain in (('runA', 1.0), ('runB', 2.0)):
    write_run(tmp_path / name, gain)
  return str(tmp_path)


@pytest.mark.parametrize('pattern', ['.*', 'loss|score', 'timer'])
def test_viewers_agree_on_a_port_logdir(logdir, pattern):
  runs = viewer.scan_runs(logdir)
  assert runs == jviewer.scan_runs(logdir) and len(runs) == 2
  for run in runs:
    assert viewer.load_series(run, pattern) == jviewer.load_series(
        run, pattern)
  assert viewer.render_terminal(runs, pattern) == jviewer.render_terminal(
      runs, pattern)
  page = viewer.render_page(logdir, pattern)
  want = jviewer.render_page(logdir, pattern)
  # The pages differ in their title alone.
  assert page.replace('embodied_tpu_torch viewer', 'embodied_tpu viewer') == (
      want)
  assert 'profile · runA' in page


def kernel(name, ts, dur, stream, device=0):
  return dict(ph='X', cat='kernel', name=name, pid=device, tid=stream,
              ts=ts, dur=dur, args={'stream': stream})


def test_load_trace_of_a_chrome_trace(tmp_path):
  """Two streams, four kernels, a copy, a host op and host annotations:
  one lane per stream, totals by kernel name, host events left out."""
  events = [
      dict(ph='M', name='process_name', pid=0, args={'name': 'GPU 0'}),
      dict(ph='X', cat='cpu_op', name='aten::mm', pid=1, tid=1, ts=99.0,
           dur=5.0),
      dict(ph='X', cat='user_annotation', name='train#7', pid=1, tid=1,
           ts=98.0, dur=40.0),
      dict(ph='X', cat='user_annotation', name='observe_seq', pid=1, tid=1,
           ts=99.0, dur=10.0),
      dict(ph='X', cat='user_annotation', name='train#8', pid=1, tid=1,
           ts=140.0, dur=40.0),
      kernel('void seq::wgrad_kernel<128>(float const*, int)', 100.0, 4.0,
             7),
      kernel('sm90_xmma_gemm_bf16bf16', 105.0, 6.0, 7),
      kernel('void seq::wgrad_kernel<128>(float const*, int)', 112.0, 2.0,
             7),
      kernel('sample_kernel(float const*)', 101.0, 1.5, 13),
      kernel('void at::native::(anonymous namespace)::fill<2>(int, float)',
             108.0, 1.0, 13),
      dict(ph='X', cat='gpu_memcpy', name='Memcpy HtoD (Pinned -> Device)',
           pid=0, tid=13, ts=103.0, dur=0.5),
  ]
  path = tmp_path / 'host_1.1.pt.trace.json.gz'
  with gzip.open(path, 'wt') as f:
    json.dump({'traceEvents': events}, f)
  assert viewer.find_trace_files(str(tmp_path)) == [str(path)]
  trace = viewer.load_trace(str(path))
  assert trace['lanes'] == [
      ('device 0/stream 13', [
          ('sample_kernel', 1.0, 1.5),
          ('Memcpy HtoD (Pinned -> Device)', 3.0, 0.5),
          ('at::native::(anonymous namespace)::fill<2>', 8.0, 1.0)]),
      ('device 0/stream 7', [('seq::wgrad_kernel<128>', 0.0, 4.0),
                             ('sm90_xmma_gemm_bf16bf16', 5.0, 6.0),
                             ('seq::wgrad_kernel<128>', 12.0, 2.0)]),
  ]
  assert trace['ops'] == [
      ('seq::wgrad_kernel<128>', 6.0, 2), ('sm90_xmma_gemm_bf16bf16', 6.0, 1),
      ('sample_kernel', 1.5, 1),
      ('at::native::(anonymous namespace)::fill<2>', 1.0, 1),
      ('Memcpy HtoD (Pinned -> Device)', 0.5, 1)]
  assert trace['annotations'] == [('train', 2), ('observe_seq', 1)]
  assert len(viewer.load_trace(str(path), max_events=2)['ops']) == 2
  html = viewer.render_trace(str(tmp_path))
  assert 'seq::wgrad_kernel&lt;128&gt;' in html  # Names are escaped.
  assert '<svg' in html


def test_server_answers_the_page_and_the_trace(logdir):
  server = viewer.make_server(logdir, 0)
  port = server.server_address[1]
  thread = threading.Thread(target=server.serve_forever)
  thread.start()
  try:
    for path, text in (('/', 'loss/rec'), ('/?filter=score', 'episode/'),
                       ('/trace', 'No profiler traces')):
      with urllib.request.urlopen(
          f'http://localhost:{port}{path}', timeout=30) as response:
        assert response.status == 200
        assert text in response.read().decode()
  finally:
    server.shutdown()
    server.server_close()
    thread.join(10)
  assert not thread.is_alive()
