"""Metrics viewer for metrics.jsonl / scores.jsonl logs and the Agent's
profiler traces: the counterpart of embodied_tpu/viewer.py.

It inspects run metrics and timer/profile summaries across several runs.
Two frontends over one loader:

- Terminal: latest values + sparkline histories, multi-run side by side,
  timer-summary section, optional watch mode (`--watch N` re-renders).
- Web (`--serve PORT`): a zero-dependency stdlib HTTP server with a
  single-page dashboard — run selector, metric regex filter, SVG line
  charts with shared axes across runs, the timer profile chart,
  auto-refresh — and `/trace`, the latest profiler trace of each run.

The loaders and renderers keep the JAX viewer's names and return shapes.
The trace view reads the Chrome traces (`*.pt.trace.json[.gz]`) that the
Agent's profiler window writes (parallel/agent.py `_maybe_profile`), with
json and gzip alone.

Usage:
  python -m embodied_tpu_torch.viewer ~/logdir       # all runs below root
  python -m embodied_tpu_torch.viewer ~/logdir --filter 'score|loss' \
      --watch 5
  python -m embodied_tpu_torch.viewer ~/logdir --serve 6006
"""

import argparse
import html
import json
import os
import re
import time

BARS = ' .:-=+*#%@'
_FILES = ('metrics.jsonl', 'scores.jsonl')


# --- Loading --------------------------------------------------------------


def scan_runs(root):
  """Find run directories (anything holding a metrics/scores jsonl)."""
  root = os.path.expanduser(root)
  runs = []
  for dirpath, _, files in os.walk(root):
    if any(f in files for f in _FILES):
      runs.append(dirpath)
  if not runs and any(
      os.path.exists(os.path.join(root, f)) for f in _FILES):
    runs = [root]
  return sorted(runs)


def load_series(rundir, pattern='.*'):
  """{metric: (steps, values)} across all jsonl files of a run."""
  regex = re.compile(pattern)
  series = {}
  for fname in _FILES:
    path = os.path.join(rundir, fname)
    if not os.path.exists(path):
      continue
    with open(path) as f:
      for line in f:
        line = line.strip()
        if not line:
          continue
        try:
          record = json.loads(line)
        except json.JSONDecodeError:
          continue
        step = record.pop('step', None)
        if step is None:
          step = record.pop('xs', 0)
        for key, value in record.items():
          if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
          if not regex.search(key):
            continue
          xs, ys = series.setdefault(key, ([], []))
          xs.append(float(step))
          ys.append(float(value))
  return series


def downsample(xs, ys, limit=400):
  """Bucket-average long series so charts stay light."""
  if len(xs) <= limit:
    return xs, ys
  size = len(xs) / limit
  oxs, oys = [], []
  for i in range(limit):
    lo, hi = int(i * size), max(int((i + 1) * size), int(i * size) + 1)
    oxs.append(sum(xs[lo:hi]) / (hi - lo))
    oys.append(sum(ys[lo:hi]) / (hi - lo))
  return oxs, oys


# --- Terminal frontend ----------------------------------------------------


def sparkline(values, width=40):
  if not values:
    return ''
  values = values[-width:]
  lo, hi = min(values), max(values)
  span = (hi - lo) or 1.0
  return ''.join(
      BARS[int((v - lo) / span * (len(BARS) - 1))] for v in values)


def render_terminal(runs, pattern, width=40):
  lines = []
  for rundir in runs:
    series = load_series(rundir, pattern)
    if not series:
      continue
    lines.append(f'== {rundir}')
    timers = {k: v for k, v in series.items() if k.startswith('timer/')}
    plain = {k: v for k, v in series.items() if not k.startswith('timer/')}
    namelen = max(len(k) for k in series)
    for key in sorted(plain):
      xs, ys = plain[key]
      lines.append(
          f'{key:<{namelen}}  {ys[-1]:>12.4g}  '
          f'{sparkline(ys, width)}  (n={len(ys)}, step={int(xs[-1])})')
    if timers:
      lines.append('-- timers (latest summary value)')
      for key in sorted(timers):
        xs, ys = timers[key]
        lines.append(f'{key:<{namelen}}  {ys[-1]:>12.4g}')
  return '\n'.join(lines) if lines else 'No matching metrics.'


# --- Web frontend ---------------------------------------------------------


def svg_path(xs, ys, w=560, h=120, pad=4):
  """Polyline path for one series scaled into a w x h viewbox."""
  if not xs:
    return ''
  lo_x, hi_x = min(xs), max(xs)
  lo_y, hi_y = min(ys), max(ys)
  sx = (w - 2 * pad) / ((hi_x - lo_x) or 1.0)
  sy = (h - 2 * pad) / ((hi_y - lo_y) or 1.0)
  points = []
  for x, y in zip(xs, ys):
    px = pad + (x - lo_x) * sx
    py = h - pad - (y - lo_y) * sy
    points.append(f'{px:.1f},{py:.1f}')
  return 'M' + ' L'.join(points)


_COLORS = ('#0022ff', '#33aa00', '#ff0011', '#ddaa00', '#cc44dd',
           '#0088aa', '#001177', '#117700')

_PROFILE_KEY = re.compile(r'^timer/(.+)/frac$')


def profile_series(series):
  """{section: (steps, fracs)} from a run's 'timer/<sec>/frac' series."""
  out = {}
  for key, (xs, ys) in series.items():
    m = _PROFILE_KEY.match(key)
    if m:
      out[m.group(1)] = (xs, ys)
  return out


def svg_stack(layers, w=560, h=120, pad=4):
  """Stacked-area polygons for [(name, xs, ys), ...].

  Sections only appear in log windows where they ran, so per-section
  step axes differ; series are aligned on the union of steps with 0 for
  windows a section did not run in (its true wall-clock fraction there).
  The y-axis spans [0, max stacked total] so band heights read directly
  as fractions."""
  if not layers:
    return []
  xs = sorted({x for _, lxs, _ in layers for x in lxs})
  if not xs:
    return []
  lo_x, hi_x = min(xs), max(xs)
  sx = (w - 2 * pad) / ((hi_x - lo_x) or 1.0)
  totals = [0.0] * len(xs)
  stacked = []
  for name, lxs, lys in layers:
    by_x = dict(zip(lxs, lys))
    ys = [by_x.get(x, 0.0) for x in xs]
    lower = list(totals)
    totals = [t + y for t, y in zip(totals, ys)]
    stacked.append((name, lower, list(totals)))
  top = max(totals) or 1.0
  sy = (h - 2 * pad) / top
  polys = []
  for name, lower, upper in stacked:
    pts = []
    for x, y in zip(xs, upper):
      pts.append(f'{pad + (x - lo_x) * sx:.1f},{h - pad - y * sy:.1f}')
    for x, y in reversed(list(zip(xs, lower))):
      pts.append(f'{pad + (x - lo_x) * sx:.1f},{h - pad - y * sy:.1f}')
    polys.append((name, ' '.join(pts)))
  return polys


def render_profile(byrun, limit=8):
  """Stacked per-section timer breakdown over time, one chart per run."""
  charts = []
  for i, (rundir, series) in enumerate(byrun):
    prof = profile_series(series)
    if not prof:
      continue
    # Largest sections first so the heavy bands sit at the bottom.
    order = sorted(
        prof, key=lambda k: -(sum(prof[k][1]) / max(len(prof[k][1]), 1)))
    layers = [(k, *prof[k]) for k in order[:limit]]
    polys = svg_stack(layers)
    body = ''.join(
        f'<polygon points="{pts}" fill="{_COLORS[j % len(_COLORS)]}" '
        f'fill-opacity="0.7" stroke="none"><title>{html.escape(name)}</title>'
        f'</polygon>'
        for j, (name, pts) in enumerate(polys))
    legend = ''.join(
        f'<span style="color:{_COLORS[j % len(_COLORS)]}">{html.escape(name)} '
        f'{100 * prof[name][1][-1]:.0f}%</span>'
        for j, name in enumerate(order[:limit]))
    run = html.escape(os.path.basename(rundir) or rundir)
    charts.append(
        f'<div class="chart"><h4>profile · {run}</h4>'
        f'<svg width="560" height="120">{body}</svg>'
        f'<div class="legend">{legend}</div></div>')
  return charts

# --- Trace view (torch profiler traces) -----------------------------------
# The Agent's profiler window (parallel/agent.py _maybe_profile) writes a
# Chrome trace, <logdir>/profile/*.pt.trace.json.gz. Device events are those
# of the categories in DEVICE_CATEGORIES (kernels, copies and fills), one
# lane per device and stream; host events (Python, aten ops, the CUDA
# runtime) are left out, as the JAX viewer leaves out the /host planes.

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


def find_trace_files(rundir):
  import glob as globlib
  return sorted(
      path for pattern in ('*.pt.trace.json', '*.pt.trace.json.gz')
      for path in globlib.glob(
          os.path.join(rundir, '**', pattern), recursive=True))


def _short_op(name):
  """A kernel's name without 'void ' and its parameter list:
  'void a::(anonymous namespace)::k<2>(float const*, int)' ->
  'a::(anonymous namespace)::k<2>'. The template arguments stay: they
  tell apart kernels of one template."""
  name = name.strip().removeprefix('void ')
  if name.endswith(')'):
    depth = 0
    for i in range(len(name) - 1, -1, -1):
      depth += {')': 1, '(': -1}.get(name[i], 0)
      if depth == 0:
        return name[:i].strip()
  return name


def _read_events(path):
  import gzip
  opener = gzip.open if path.endswith('.gz') else open
  with opener(path, 'rt') as f:
    return json.load(f).get('traceEvents', [])


def load_trace(path, max_events=200000):
  """Parse a Chrome trace into {'lanes': [(lane, [(op, start_us,
  dur_us)])], 'ops': [(op, total_us, count)]} for the device events (at
  most `max_events`), with starts relative to the first of them, and
  'annotations': [(name, count)] of the host's profiler ranges (the train
  steps, `train#<step>` counted as `train`, and the kernel wrappers'
  launches), most frequent first."""
  lanes, totals, annotations = {}, {}, {}
  count = 0
  events = _read_events(path)
  for ev in events:
    if ev.get('ph') != 'X':
      continue
    cat = ev.get('cat', '')
    if cat == 'user_annotation':
      name = re.sub(r'#\d+$', '', ev.get('name', '?'))
      annotations[name] = annotations.get(name, 0) + 1
      continue
    if cat not in DEVICE_CATEGORIES or count >= max_events:
      continue
    name = ev.get('name', '?')
    name = _short_op(name) if cat == 'kernel' else name
    dur = float(ev.get('dur', 0.0))
    lane = f"device {ev.get('pid', '?')}/stream {ev.get('tid', '?')}"
    lanes.setdefault(lane, []).append((name, float(ev['ts']), dur))
    total, n = totals.get(name, (0.0, 0))
    totals[name] = (total + dur, n + 1)
    count += 1
  t0 = min((s for evs in lanes.values() for _, s, _ in evs), default=0.0)
  lanes = [(lane, sorted(((n, s - t0, d) for n, s, d in evs),
                         key=lambda e: e[1]))
           for lane, evs in sorted(lanes.items())]
  ops = sorted(((k, t, n) for k, (t, n) in totals.items()),
               key=lambda kv: -kv[1])
  return dict(lanes=lanes, ops=ops, annotations=sorted(
      annotations.items(), key=lambda kv: -kv[1]))


def render_trace(rundir, window_us=50000.0, toplanes=6, minfrac=1e-3):
  """HTML for one run's latest trace: per-op totals table + an SVG
  timeline of the busiest window of the busiest lanes."""
  paths = find_trace_files(rundir)
  if not paths:
    return '<p>No profiler trace (*.pt.trace.json.gz) under this run.</p>'
  trace = load_trace(paths[-1])
  rows = ''.join(
      f'<tr><td>{html.escape(name)}</td><td align=right>{total:,.0f}</td>'
      f'<td align=right>{n}</td>'
      f'<td align=right>{total / max(n, 1):,.1f}</td></tr>'
      for name, total, n in trace['ops'][:25])
  table = (
      '<table border=0 cellpadding=2 style="font-size:11px">'
      '<tr><th align=left>op</th><th>total us</th><th>count</th>'
      '<th>mean us</th></tr>' + rows + '</table>')
  # Timeline: the busiest lanes, clipped to a window starting at the
  # first device event so one train step's structure is visible.
  lanes = sorted(
      trace['lanes'],
      key=lambda le: -sum(d for _, _, d in le[1]))[:toplanes]
  if not lanes:
    return ('<p>No device events in this trace: it holds host events '
            'alone (a run on the CPU).</p>' + table)
  t0 = min(s for _, evs in lanes for _, s, _ in evs)
  W, LH = 900, 22
  H = LH * len(lanes) + 18
  parts = []
  palette = {}
  for li, (lane, evs) in enumerate(lanes):
    y = 14 + li * LH
    parts.append(
        f'<text x="2" y="{y + 12}" font-size="9" fill="#555">'
        f'{html.escape(lane.split("/")[-1][:28])}</text>')
    for name, start, dur in evs:
      x = (start - t0) / window_us * W
      w = dur / window_us * W
      if x > W or x + w < 0 or w < minfrac * W / 100:
        continue
      color = palette.setdefault(
          name, _COLORS[len(palette) % len(_COLORS)])
      parts.append(
          f'<rect x="{max(x, 0):.1f}" y="{y}" width="{max(w, 0.6):.1f}" '
          f'height="{LH - 4}" fill="{color}" fill-opacity="0.8">'
          f'<title>{html.escape(name)} · {dur:.1f}us</title></rect>')
  svg = (f'<svg width="{W}" height="{H}" '
         f'style="background:#fff;border:1px solid #ddd">'
         + ''.join(parts) + '</svg>')
  src = html.escape(os.path.relpath(paths[-1], rundir))
  return (f'<h4>trace · {src} · first {window_us / 1e3:.0f} ms</h4>'
          f'{svg}<div style="margin-top:8px">{table}</div>')


def render_trace_page(root):
  runs = scan_runs(root) or [root]
  sections = []
  for rundir in runs:
    if not find_trace_files(rundir):
      continue
    run = html.escape(os.path.basename(rundir) or rundir)
    sections.append(f'<div class="chart"><h4>{run}</h4>'
                    f'{render_trace(rundir)}</div>')
  if not sections:
    sections = ['<p>No profiler traces under any run. Enable the '
                'profiler window (--torch.profiler True) to record one.</p>']
  return _PAGE.format(
      filter='', nruns=len(runs), legend='<a href="/">metrics</a>',
      charts=''.join(sections))


_PAGE = """<!doctype html><html><head><title>embodied_tpu_torch viewer</title>
<style>
body {{ font-family: monospace; margin: 16px; background: #fafafa; }}
.chart {{ display: inline-block; margin: 8px; padding: 8px;
         background: #fff; border: 1px solid #ddd; }}
.chart h4 {{ margin: 2px 0 6px 0; font-size: 12px; }}
.legend span {{ margin-right: 10px; font-size: 11px; }}
form {{ margin-bottom: 12px; }}
</style></head>
<body>
<form method="get">
  filter <input name="filter" value="{filter}">
  <input type="submit" value="apply">
  <span>runs: {nruns} · auto-refresh 10s · <a href="/trace">trace</a></span>
</form>
<div class="legend">{legend}</div>
{charts}
<script>setTimeout(() => location.reload(), 10000);</script>
</body></html>"""


def render_page(root, pattern):
  runs = scan_runs(root)
  # Timer sections are loaded regardless of the metric filter (they feed
  # the profile view, not the per-metric charts).
  byrun = [(r, load_series(r, f'(?:{pattern})|^timer/')) for r in runs]
  keys = sorted({k for _, s in byrun for k in s
                 if not k.startswith('timer/') and re.search(pattern, k)})
  legend = ''.join(
      f'<span style="color:{_COLORS[i % len(_COLORS)]}">'
      f'{html.escape(os.path.basename(r) or r)}</span>'
      for i, (r, _) in enumerate(byrun))
  charts = []
  for key in keys:
    paths = []
    latest = ''
    for i, (r, series) in enumerate(byrun):
      if key not in series:
        continue
      xs, ys = downsample(*series[key])
      color = _COLORS[i % len(_COLORS)]
      paths.append(
          f'<path d="{svg_path(xs, ys)}" fill="none" '
          f'stroke="{color}" stroke-width="1.5"/>')
      latest = f'{ys[-1]:.4g}'
    charts.append(
        f'<div class="chart"><h4>{html.escape(key)} · {latest}</h4>'
        f'<svg width="560" height="120">{"".join(paths)}</svg></div>')
  charts.extend(render_profile(byrun))
  return _PAGE.format(
      filter=html.escape(pattern), nruns=len(runs), legend=legend,
      charts=''.join(charts))


def serve(root, port, pattern='.*'):
  server = make_server(root, port, pattern)
  print(f'Serving viewer on http://localhost:{port} (root: {root})')
  server.serve_forever()


def make_server(root, port, pattern='.*'):
  """The viewer's HTTP server on `port` (0: any free port), not yet
  serving."""
  import http.server
  import urllib.parse

  class Handler(http.server.BaseHTTPRequestHandler):

    def do_GET(self):
      parsed = urllib.parse.urlparse(self.path)
      params = urllib.parse.parse_qs(parsed.query)
      flt = params.get('filter', [pattern])[0] or '.*'
      try:
        if parsed.path.rstrip('/') == '/trace':
          body = render_trace_page(root).encode()
        else:
          body = render_page(root, flt).encode()
        self.send_response(200)
        self.send_header('Content-Type', 'text/html; charset=utf-8')
      except Exception as e:
        body = f'viewer error: {e}'.encode()
        self.send_response(500)
      self.send_header('Content-Length', str(len(body)))
      self.end_headers()
      self.wfile.write(body)

    def log_message(self, *args):
      pass

  return http.server.ThreadingHTTPServer(('', port), Handler)


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument('logdir')
  parser.add_argument('--filter', default='.*')
  parser.add_argument('--width', type=int, default=40)
  parser.add_argument('--watch', type=float, default=0,
                      help='re-render every N seconds')
  parser.add_argument('--serve', type=int, default=0,
                      help='serve the web dashboard on this port')
  args = parser.parse_args()

  if args.serve:
    serve(args.logdir, args.serve, args.filter)
    return
  while True:
    runs = scan_runs(args.logdir)
    if not runs:
      print(f'No metrics found under {args.logdir}')
    else:
      print(render_terminal(runs, args.filter, args.width))
    if not args.watch:
      break
    time.sleep(args.watch)
    print('\033[2J\033[H', end='')


if __name__ == '__main__':
  main()
