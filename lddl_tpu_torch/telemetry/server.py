"""In-run metrics endpoint: per-process HTTP server gated by LDDL_MONITOR.

A copy of :mod:`lddl_tpu.telemetry.server` (the port keeps its own copy
and imports nothing of :mod:`lddl_tpu`), with the same spec forms,
endpoints and announce files. With the gate unset (default) everything
here collapses to a shared immutable no-op singleton: zero threads, zero
sockets. With it set, the process runs exactly ONE extra daemon thread:
a single-threaded ``http.server`` loop on a loopback TCP port or unix
socket. There is no sampler thread — each ``/snapshot`` or ``/metrics``
request samples the registry into the rolling
:class:`~.live.SnapshotWindow`, so the scraper's cadence IS the
windowing cadence and an unwatched process does no periodic work at all.

The HTTP thread makes no CUDA call: ``/snapshot`` reads the caching
allocator's host-side counters only (:func:`~.roofline.sample_hbm`),
and ``/profile`` only arms the step profiler, which the train loop's
thread starts at its next step boundary. So a scrape cannot break a CUDA
graph the loop is capturing.

``LDDL_MONITOR`` spec forms:

  - ``1`` / ``true`` / ``on`` / ``yes`` — loopback TCP on an ephemeral
    port (the announce file tells ``python -m
    lddl_tpu_torch.telemetry.monitor`` where);
  - ``<port>`` — loopback TCP on that port (port 0 = ephemeral); ranks
    beyond 0 offset by their rank so one spec serves a local fleet;
  - ``<host>:<port>`` — explicit bind (same rank offset);
  - anything containing ``/`` — a unix-domain socket path, suffixed
    ``.rank<R>`` per rank.

Each server announces itself by writing
``monitor.rank<R>.pid<P>.json`` (url/rank/pid, plus the pid's
namespace and /proc starttime so discovery can tell a dead announcer
from a live one — the same positive-death identity the comm backend's
beacons use) into ``LDDL_MONITOR_DIR`` (falling back to
``LDDL_TELEMETRY_DIR``), and removes it on stop.

Endpoints:

  - ``GET /snapshot`` — :func:`~.live.live_status` as JSON: windowed
    rates, the live bottleneck verdict, straggler signals, goodput
    meters, HBM gauges, the sentinel block (present only when
    ``LDDL_SENTINEL`` is armed), plus the cumulative registry dump;
  - ``GET /metrics``  — Prometheus text exposition of the cumulative
    registry (counters/gauges/histograms with cumulative ``le`` buckets
    derived from the power-of-two log buckets);
  - ``GET /healthz``  — liveness probe;
  - ``GET /profile?steps=N`` — arm the ``torch.profiler`` step capture
    (:class:`~.profiling.StepProfiler`) for the next N train steps
    (trace written under ``LDDL_TELEMETRY_DIR/profiles/``).
"""

import atexit
import http.server
import json
import math
import os
import socketserver
import threading
import time

from . import metrics as _metrics
from .live import SnapshotWindow, live_status

_ENV = 'LDDL_MONITOR'
_DIR_ENV = 'LDDL_MONITOR_DIR'


class NoopMonitor:
  """The disabled monitor: every method empty, no state, no thread."""

  __slots__ = ()
  enabled = False
  url = None

  def start(self, rank=0):
    return self

  def stop(self):
    pass


NOOP_MONITOR = NoopMonitor()


def _sanitize(name):
  """Metric name -> Prometheus-legal: ``lddl_`` prefix, [a-zA-Z0-9_]."""
  return 'lddl_' + ''.join(
      c if c.isalnum() or c == '_' else '_' for c in name)


def prometheus_lines(snapshot_lines):
  """Render ``Telemetry.snapshot_lines()`` as Prometheus text exposition.

  Log buckets (power-of-two exponents) become cumulative ``le`` buckets
  — coarse, but honest: every ``le`` boundary is a real bucket edge the
  histogram actually tracked.
  """
  out = []
  for line in snapshot_lines:
    kind = line.get('kind')
    if kind == 'meta':
      out.append('# lddl meta rank=%s pid=%s' %
                 (line.get('rank'), line.get('pid')))
      continue
    name = _sanitize(line['name'])
    if kind == 'counter':
      out.append(f'# TYPE {name}_total counter')
      out.append(f'{name}_total {line.get("total", 0)}')
    elif kind == 'gauge':
      v = line.get('value')
      if v is None:
        continue
      out.append(f'# TYPE {name} gauge')
      out.append(f'{name} {v}')
    elif kind == 'histogram':
      out.append(f'# TYPE {name} histogram')
      buckets = line.get('buckets') or {}
      zero = buckets.get('zero', 0)
      numeric = sorted(int(k) for k in buckets if k != 'zero')
      cum = zero
      if zero:
        out.append(f'{name}_bucket{{le="0.0"}} {cum}')
      for e in numeric:
        cum += buckets[str(e)] if str(e) in buckets else buckets.get(e, 0)
        out.append(f'{name}_bucket{{le="{float(2.0 ** (e + 1))}"}} {cum}')
      out.append(f'{name}_bucket{{le="+Inf"}} {line.get("count", 0)}')
      out.append(f'{name}_sum {line.get("sum", 0.0)}')
      out.append(f'{name}_count {line.get("count", 0)}')
  return '\n'.join(out) + '\n'


class _Handler(http.server.BaseHTTPRequestHandler):
  # The monitor must never write request logs into the job's stdout.
  def log_message(self, fmt, *args):  # noqa: A002 - base class signature
    pass

  def _send(self, body, content_type):
    data = body.encode('utf-8')
    self.send_response(200)
    self.send_header('Content-Type', content_type)
    self.send_header('Content-Length', str(len(data)))
    self.end_headers()
    self.wfile.write(data)

  def do_GET(self):  # noqa: N802 - http.server API
    mon = self.server.monitor
    path = self.path.split('?', 1)[0]
    try:
      if path == '/healthz':
        self._send('ok\n', 'text/plain; charset=utf-8')
      elif path == '/metrics':
        tele = _metrics.get_telemetry()
        self._send(prometheus_lines(tele.snapshot_lines(rank=mon.rank)),
                   'text/plain; version=0.0.4; charset=utf-8')
      elif path == '/snapshot':
        with mon.window_lock:
          status = live_status(mon.window, rank=mon.rank)
        self._send(json.dumps(status, default=_json_default),
                   'application/json')
      elif path == '/profile':
        from urllib.parse import parse_qs
        from .profiling import get_step_profiler
        query = parse_qs(self.path.partition('?')[2])
        try:
          steps = int(query.get('steps', ['1'])[0])
        except (ValueError, IndexError):
          steps = 0
        if steps < 1:
          self.send_error(400, 'bad steps= value (want a positive int)')
          return
        trace_dir = get_step_profiler().arm(steps)
        self._send(json.dumps({'armed_steps': steps,
                               'trace_dir': trace_dir,
                               'rank': mon.rank}),
                   'application/json')
      else:
        self.send_error(404, 'unknown endpoint (try /snapshot, /metrics, '
                             '/healthz, /profile)')
    except BrokenPipeError:
      pass  # scraper went away mid-response; nothing to clean up


def _json_default(o):
  if isinstance(o, float) and not math.isfinite(o):
    return str(o)
  return str(o)


class _TcpServer(socketserver.TCPServer):
  allow_reuse_address = True
  daemon_threads = True


class _UnixServer(socketserver.UnixStreamServer):
  daemon_threads = True

  def server_bind(self):
    try:
      os.unlink(self.server_address)
    except FileNotFoundError:
      pass
    super().server_bind()


def _parse_spec(spec, rank):
  """LDDL_MONITOR value -> ('tcp', (host, port)) | ('unix', path)."""
  s = spec.strip()
  low = s.lower()
  if '/' in s:
    return 'unix', f'{s}.rank{rank}'
  if low in ('1', 'true', 'on', 'yes'):
    return 'tcp', ('127.0.0.1', 0)
  if ':' in s:
    host, _, port = s.rpartition(':')
    p = int(port)
    return 'tcp', (host, p + rank if p else 0)
  p = int(s)
  return 'tcp', ('127.0.0.1', p + rank if p else 0)


class MonitorServer:
  """One daemon thread serving this process's registry over HTTP."""

  enabled = True

  def __init__(self, spec, rank=0):
    self._spec = spec
    self.rank = rank
    self.window = SnapshotWindow()
    self.window_lock = threading.Lock()
    self._httpd = None
    self._thread = None
    self._announce_path = None
    self.url = None

  def start(self, rank=None):
    if self._thread is not None:
      return self
    if rank is not None:
      self.rank = rank
    kind, addr = _parse_spec(self._spec, self.rank)
    if kind == 'unix':
      self._httpd = _UnixServer(addr, _Handler, bind_and_activate=True)
      self.url = f'unix:{addr}'
    else:
      self._httpd = _TcpServer(addr, _Handler, bind_and_activate=True)
      host, port = self._httpd.server_address[:2]
      self.url = f'http://{host}:{port}'
    self._httpd.monitor = self
    self._thread = threading.Thread(
        target=self._httpd.serve_forever, kwargs={'poll_interval': 0.25},
        name=f'lddl-monitor-rank{self.rank}', daemon=True)
    self._thread.start()
    self._announce()
    # Clean exits must not leave stale announce files / unix sockets
    # behind for lddl-monitor to trip over. stop() is idempotent, so a
    # prior explicit stop makes this a no-op.
    atexit.register(self.stop)
    return self

  def _announce(self):
    directory = (os.environ.get(_DIR_ENV, '').strip() or
                 os.environ.get('LDDL_TELEMETRY_DIR', '').strip())
    if not directory:
      return
    os.makedirs(directory, exist_ok=True)
    self._announce_path = os.path.join(
        directory, f'monitor.rank{self.rank}.pid{os.getpid()}.json')
    # Ship the announcer's full pid identity (namespace + /proc
    # starttime, the comm beacons' positive-death triple) so discovery
    # can prove a SIGKILLed announcer dead instead of timing out on its
    # stale endpoint.
    from ..comm.backend import FileBackend
    payload = json.dumps({'url': self.url, 'rank': self.rank,
                          'pid': os.getpid(),
                          'pidns': FileBackend._pid_namespace(),
                          'pid_starttime':
                              FileBackend._pid_starttime(os.getpid()),
                          'started_unix': time.time()})
    tmp = self._announce_path + '.tmp'
    with open(tmp, 'w') as f:
      f.write(payload)
    os.replace(tmp, self._announce_path)

  def stop(self):
    if self._httpd is None:
      return
    self._httpd.shutdown()
    self._thread.join(timeout=5.0)
    self._httpd.server_close()
    if isinstance(self._httpd, _UnixServer):
      try:
        os.unlink(self._httpd.server_address)
      except OSError:
        pass
    if self._announce_path:
      try:
        os.unlink(self._announce_path)
      except OSError:
        pass
      self._announce_path = None
    self._httpd = None
    self._thread = None
    self.url = None


_active = None  # None: not yet resolved from the environment


def get_monitor():
  """The process-global monitor: a started :class:`MonitorServer` when
  ``LDDL_MONITOR`` is set (or :func:`maybe_start_monitor` forced one),
  else the shared :data:`NOOP_MONITOR` singleton. Resolution is lazy
  and cached, mirroring :func:`~.metrics.get_telemetry`."""
  global _active
  if _active is None:
    spec = os.environ.get(_ENV, '').strip()
    if spec and spec.lower() not in ('0', 'false', 'off', 'no'):
      _active = MonitorServer(spec)
    else:
      _active = NOOP_MONITOR
  return _active


def maybe_start_monitor(rank=0):
  """Start the monitor server for this process if (and only if) the
  gate is set. Idempotent — entry points (executor construction, the
  train loop, the loader builder) all call it; the first one wins and
  later calls return the same instance. With the gate unset this is a
  single dict lookup returning the no-op singleton."""
  mon = get_monitor()
  if mon.enabled:
    mon.start(rank=rank)
  return mon


def stop_monitor():
  """Stop and forget the active server (tests; atexit-ish cleanup).
  The next :func:`get_monitor` re-resolves from the environment."""
  global _active
  if _active is not None and _active.enabled:
    _active.stop()
  _active = None
