"""``lddl-monitor``: terminal dashboard over live monitor endpoints.

A copy of :mod:`lddl_tpu.telemetry.monitor` (the port keeps its own copy
and imports nothing of :mod:`lddl_tpu`); run it as ``python -m
lddl_tpu_torch.telemetry.monitor``. It attaches to a running job —
either explicit ``--url`` endpoints or a ``--dir`` of
``monitor.rank*.json`` announce files (what each ``LDDL_MONITOR`` server
writes into ``LDDL_MONITOR_DIR`` / ``LDDL_TELEMETRY_DIR``) — polls every
rank's ``/snapshot``, and repaints a plain-text dashboard (ANSI clear +
home; deliberately no curses): per-stage rates, the live bottleneck
verdict, the fleet straggler table (computed client-side from every
rank's windowed signals, same arithmetic the in-run aggregation uses),
and goodput meters. Live data servers (``serve.pid*.json``) are listed
in the frame's header; a dead one's announce becomes a fleet error.
``--once`` renders a single frame; ``--once --json`` emits the full
merged payload for scripting/CI.

Unix-socket endpoints (``unix:/path``) are reached through a raw
``http.client`` connection bound to ``AF_UNIX`` — no extra deps.
"""

import argparse
import glob
import http.client
import json
import os
import socket
import sys
import time
import urllib.request

from .ledger import compare_signals
from .live import straggler_scores


class _UnixHTTPConnection(http.client.HTTPConnection):

  def __init__(self, path, timeout):
    super().__init__('localhost', timeout=timeout)
    self._path = path

  def connect(self):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(self.timeout)
    sock.connect(self._path)
    self.sock = sock


def _fetch_json(url, request_path, timeout=5.0):
  """GET ``<url><request_path>`` -> parsed JSON dict. ``url`` is either
  an ``http://host:port`` endpoint or ``unix:/path/to.sock``."""
  if url.startswith('unix:'):
    conn = _UnixHTTPConnection(url[len('unix:'):], timeout)
    try:
      conn.request('GET', request_path)
      resp = conn.getresponse()
      if resp.status != 200:
        raise RuntimeError(f'{url}{request_path} -> HTTP {resp.status}')
      return json.loads(resp.read().decode('utf-8'))
    finally:
      conn.close()
  with urllib.request.urlopen(url.rstrip('/') + request_path,
                              timeout=timeout) as resp:
    return json.loads(resp.read().decode('utf-8'))


def fetch_snapshot(url, timeout=5.0):
  """GET ``<url>/snapshot`` -> parsed JSON dict."""
  return _fetch_json(url, '/snapshot', timeout=timeout)


def fetch_profile(url, steps, timeout=5.0):
  """Arm the endpoint's profiler: GET ``<url>/profile?steps=N``."""
  return _fetch_json(url, f'/profile?steps={int(steps)}', timeout=timeout)


def _announced_dead(info):
  """True when an announce file names a pid we can *prove* died (same
  pid namespace + positive /proc probe — the comm beacons' discipline).
  Old-format announces without the identity fields are never flagged."""
  pid = info.get('pid')
  pidns = info.get('pidns')
  if not isinstance(pid, int) or not pidns:
    return False
  from ..comm.backend import FileBackend
  ours = FileBackend._pid_namespace()
  if not ours or pidns != ours:
    return False
  return FileBackend._pid_dead(pid, info.get('pid_starttime') or '')


def discover_announcements(directory):
  """Parsed announce files under ``directory`` (rank order), each with a
  ``dead`` flag from the pid probe."""
  paths = sorted(glob.glob(os.path.join(directory, 'monitor.rank*.json')))
  out = []
  for p in paths:
    try:
      with open(p) as f:
        info = json.load(f)
    except (OSError, ValueError):
      continue  # being rewritten or already torn down; next poll catches up
    if info.get('url'):
      info['dead'] = _announced_dead(info)
      out.append(info)
  return out


def discover_serve_announcements(directory):
  """Parsed ``serve.pid*.json`` data-server announces under
  ``directory``, each with a ``dead`` flag from the same positive-death
  pid probe the monitor announces use. Lets the dashboard list live
  ``lddl-data-server`` endpoints next to rank endpoints and fold a
  SIGKILLed server into the error list instead of connection noise."""
  from ..loader.service import discover_data_servers
  return discover_data_servers(directory)


def discover_endpoints(directory, include_dead=False):
  """Endpoint URLs from announce files under ``directory``, rank order.

  A SIGKILLed rank cannot remove its announce file; its pid probe proves
  it dead, and the stale endpoint is skipped (flagged upstream by
  :func:`discover_announcements`) instead of being polled into a
  timeout.
  """
  return [info['url'] for info in discover_announcements(directory)
          if include_dead or not info['dead']]


def poll_fleet(urls, timeout=5.0):
  """One round: every reachable rank's snapshot + the fleet view.

  Returns ``{'ranks': {rank: snapshot}, 'errors': {url: str},
  'straggler': straggler_scores(...), 'verdict': <rank verdicts>}``.
  The straggler table is recomputed here from each rank's windowed
  signals — identical arithmetic to the in-run
  :func:`~.live.straggler_over_comm` path, so dashboard and stealer
  agree.
  """
  ranks, errors = {}, {}
  for url in urls:
    try:
      snap = fetch_snapshot(url, timeout=timeout)
      ranks[snap.get('rank', len(ranks))] = snap
    except (OSError, RuntimeError, ValueError) as e:
      errors[url] = str(e)
  fleet = {
      'ranks': ranks,
      'errors': errors,
      'straggler': straggler_scores(
          {r: s.get('signals', {}) for r, s in ranks.items()})
      if len(ranks) > 1 else None,
      'verdicts': {r: s.get('verdict', {}).get('bottleneck', 'unknown')
                   for r, s in ranks.items()},
  }
  # Cross-rank determinism: compare the ledger stream heads every rank
  # exports in its snapshot — identical arithmetic to the in-run
  # divergence_over_comm path, so dashboard and run agree. None when no
  # rank runs with LDDL_LEDGER (the ledger key is absent).
  ledgers = {r: s.get('ledger') for r, s in ranks.items() if s.get('ledger')}
  fleet['determinism'] = (compare_signals(ledgers)
                          if len(ledgers) > 1 else None)
  # Sentinel triggers + incidents per rank (live_status only exports
  # the key when LDDL_SENTINEL is on). None when no rank runs armed.
  sentinels = {r: s.get('sentinel') for r, s in ranks.items()
               if s.get('sentinel')}
  fleet['sentinel'] = sentinels or None
  return fleet


def _fmt_rate(v):
  if v is None:
    return '-'
  if v >= 100:
    return f'{v:,.0f}'
  return f'{v:.2f}'


def render_frame(fleet, clear=True):
  """The plain-text dashboard for one poll round."""
  out = []
  if clear:
    out.append('\x1b[2J\x1b[H')
  out.append('lddl-monitor · %d rank(s) · %s' %
             (len(fleet['ranks']), time.strftime('%H:%M:%S')))
  for info in fleet.get('data_servers') or []:
    if not info.get('dead'):
      out.append(f'  data-server {info.get("url")} '
                 f'(pid {info.get("pid")})')
  for url, err in sorted(fleet['errors'].items()):
    out.append(f'  !! {url}: {err}')
  for rank in sorted(fleet['ranks']):
    snap = fleet['ranks'][rank]
    verdict = snap.get('verdict', {})
    out.append('')
    out.append(f'rank {rank} (pid {snap.get("pid")}) · window '
               f'{snap.get("window_sec", 0.0):.1f}s '
               f'({snap.get("window_samples", 0)} samples)')
    out.append(f'  verdict: {verdict.get("bottleneck", "unknown")}')
    if verdict.get('detail'):
      out.append(f'    {verdict["detail"]}')
    roof = verdict.get('roofline') or {}
    bound = roof.get('bound')
    if bound and not str(bound).startswith('unknown'):
      line = f'  roofline: {bound}'
      if roof.get('flops_per_sec'):
        line += f' · {roof["flops_per_sec"] / 1e12:.2f} TFLOP/s'
        if roof.get('flops_frac') is not None:
          line += f' ({roof["flops_frac"]:.1%} of peak)'
      if roof.get('bytes_per_sec'):
        line += f' · {roof["bytes_per_sec"] / 1e9:.1f} GB/s'
        if roof.get('bw_frac') is not None:
          line += f' ({roof["bw_frac"]:.1%} of peak)'
      if roof.get('arithmetic_intensity') is not None and \
          roof.get('machine_balance') is not None:
        line += (f' · AI {roof["arithmetic_intensity"]:.0f} vs balance '
                 f'{roof["machine_balance"]:.0f} FLOPs/byte')
      out.append(line)
      if roof.get('detail'):
        out.append(f'    {roof["detail"]}')
    hbm = snap.get('hbm')
    if hbm:
      line = (f'  hbm: {hbm.get("bytes_in_use", 0) / 2**30:.2f} GiB in '
              f'use · peak {hbm.get("peak_bytes_in_use", 0) / 2**30:.2f} '
              'GiB')
      if hbm.get('bytes_limit'):
        line += f' · limit {hbm["bytes_limit"] / 2**30:.2f} GiB'
      if hbm.get('headroom_frac') is not None:
        line += f' · headroom {hbm["headroom_frac"]:.1%}'
      out.append(line)
    rates = snap.get('rates', {})
    shown = sorted(n for n in rates if not n.endswith('.mean'))[:12]
    for name in shown:
      unit = '/s' if not name.endswith('.rate') else ' spans/s'
      out.append(f'  {name:<44s} {_fmt_rate(rates[name]):>12s}{unit}')
    good = snap.get('goodput', {})
    meters = []
    if good.get('padding_efficiency') is not None:
      meters.append(f'padding-eff {good["padding_efficiency"]:.1%}')
    if good.get('step_cache_hit_rate') is not None:
      meters.append(f'step-cache {good["step_cache_hit_rate"]:.1%}')
    if good.get('h2d_overlap_fraction') is not None:
      meters.append(f'h2d-overlap {good["h2d_overlap_fraction"]:.1%}')
    if good.get('attn_tile_skip_fraction') is not None:
      meters.append(f'attn-tiles-skipped {good["attn_tile_skip_fraction"]:.1%}')
    if good.get('mfu'):
      meters.append(f'mfu {good["mfu"]["mean"]:.1%}')
    if good.get('grad_norm'):
      meters.append(f'grad-norm {good["grad_norm"]["mean"]:.3g}')
    if good.get('device_live_batches'):
      meters.append(f'device-live {good["device_live_batches"]["mean"]:.1f}'
                    ' batches')
    for g in ('queue_depth', 'shm_slot_occupancy', 'ckpt_backlog'):
      if good.get(g):
        meters.append(f'{g} {good[g]["mean"]:.1f}')
    if meters:
      out.append('  goodput: ' + ' · '.join(meters))
    ft = good.get('fault_tolerance')
    if ft:
      parts = [f'{k.replace("_", "-")} {v}' for k, v in ft.items() if v]
      out.append('  fault-tolerance: ' + ' · '.join(parts))
    srv = verdict.get('serve')
    if srv:
      line = '  serve:'
      if srv.get('clients') is not None:
        line += f' {srv["clients"]["mean"]:.0f} client(s)'
      if srv.get('batches_per_sec') is not None:
        line += f' · {_fmt_rate(srv["batches_per_sec"])} batches/s'
      for label, key in (('re-serves', 'reserves'),
                         ('lease-revokes', 'lease_revokes'),
                         ('fallbacks', 'fallbacks'),
                         ('re-attaches', 'reattaches')):
        if srv.get(key):
          line += f' · {label} {srv[key]}'
      if srv.get('backlog') is not None:
        line += f' · backlog {srv["backlog"]["mean"]:.1f}'
      out.append(line)
  strag = fleet.get('straggler')
  if strag:
    out.append('')
    out.append('straggler scores (fleet-median / own rate; >1 = slow):')
    for rank in sorted(strag['scores']):
      mark = '  <-- slowest' if rank == strag['slowest'] else ''
      out.append(f'  rank {rank}: {strag["scores"][rank]:.3f}{mark}')
  det = fleet.get('determinism')
  if det and det.get('status') == 'diverged':
    out.append('')
    out.append('!! DIVERGED — ranks no longer byte-identical:')
    first = det.get('first') or {}
    line = f'  first divergence: boundary {first.get("boundary", "?")}'
    if first.get('key'):
      line += ' at ' + ', '.join(str(k) for k in first['key'])
    digests = first.get('digests') or {}
    if digests:
      line += ' — rank ' + ' vs rank '.join(
          f'{r} {d}' for r, d in sorted(digests.items()))
    if not first.get('key'):
      line += ' (first differing batch predates the retained window; ' \
              'run lddl-audit on the ledgers for the exact coordinate)'
    out.append(line)
    for b, entry in sorted((det.get('boundaries') or {}).items()):
      out.append(f'  {b}: {entry.get("status")} · counts '
                 f'{entry.get("counts")}')
  elif det and det.get('status') == 'ok':
    out.append('')
    out.append('determinism: ok (replicated ledger streams agree)')
  fired = {r: s for r, s in (fleet.get('sentinel') or {}).items()
           if s.get('triggers') or s.get('incidents')}
  if fired:
    out.append('')
    out.append('!! INCIDENT — sentinel trigger(s):')
    for rank in sorted(fired):
      s = fired[rank]
      last = s.get('last') or {}
      line = f'  rank {rank}: {s.get("triggers", 0)} trigger(s)'
      if last:
        line += (f' · last {last.get("detector", "?")} at step '
                 f'{last.get("step")}')
      out.append(line)
      if last.get('reason'):
        out.append(f'    {last["reason"]}')
      for inc in (s.get('incidents') or [])[-3:]:
        out.append(f'    incident {inc.get("dir")} — triage with: '
                   'python -m lddl_tpu_torch.training.flight show '
                   f'{inc.get("dir")}')
  return '\n'.join(out)


def attach_args(parser):
  parser.add_argument('--url', action='append', default=[],
                      help='monitor endpoint (http://host:port or '
                           'unix:/path); repeatable')
  parser.add_argument('--dir', default=None,
                      help='directory of monitor.rank*.json announce files '
                           '(LDDL_MONITOR_DIR / LDDL_TELEMETRY_DIR)')
  parser.add_argument('--interval', type=float, default=2.0,
                      help='seconds between repaints (default 2)')
  parser.add_argument('--timeout', type=float, default=5.0,
                      help='per-endpoint HTTP timeout')
  parser.add_argument('--once', action='store_true',
                      help='render a single frame and exit')
  parser.add_argument('--json', action='store_true',
                      help='with --once: emit the merged fleet payload '
                           'as JSON instead of the dashboard')
  parser.add_argument('--profile', type=int, default=None, metavar='STEPS',
                      help='arm every live endpoint\'s torch.profiler '
                           'for the next STEPS train steps and exit')
  return parser


def main(args=None):
  parser = attach_args(argparse.ArgumentParser(
      description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter))
  args = parser.parse_args(args)
  if not args.url and not args.dir:
    print('lddl-monitor: provide --url and/or --dir', file=sys.stderr)
    return 2

  def _endpoints():
    """(live urls, {stale url: why}) — explicit --url endpoints are
    trusted; discovered ones are pid-probed and provably-dead announcers
    are reported instead of polled into a timeout."""
    urls = list(args.url)
    dead = {}
    if args.dir:
      for info in discover_announcements(args.dir):
        if info['dead']:
          dead[info['url']] = (f'announcer pid {info.get("pid")} is dead '
                               '(stale announce file); skipped')
        elif info['url'] not in urls:
          urls.append(info['url'])
      # Data-server announces: live ones are listed in the frame header
      # (their own monitor endpoint, if any, rides the monitor.rank*
      # announce above); a SIGKILLed server's stale announce becomes a
      # fleet error instead of every client's connection noise.
      for info in discover_serve_announcements(args.dir):
        if info['dead']:
          dead[f'data-server {info["url"]}'] = (
              f'data server pid {info.get("pid")} is dead '
              '(stale serve announce); clients will degrade to their '
              'local loaders')
    return urls, dead

  if args.profile is not None:
    if args.profile < 1:
      print('lddl-monitor: --profile wants a positive step count',
            file=sys.stderr)
      return 2
    urls, dead = _endpoints()
    for url, why in sorted(dead.items()):
      print(f'lddl-monitor: {url}: {why}', file=sys.stderr)
    if not urls:
      print('lddl-monitor: no live endpoints to profile', file=sys.stderr)
      return 2
    rc = 0
    for url in urls:
      try:
        resp = fetch_profile(url, args.profile, timeout=args.timeout)
        print(f'{url}: armed {resp.get("armed_steps")} step(s) -> '
              f'{resp.get("trace_dir")}')
      except (OSError, RuntimeError, ValueError) as e:
        print(f'{url}: {e}', file=sys.stderr)
        rc = 1
    return rc

  while True:
    urls, dead = _endpoints()
    if not urls and not dead:
      print(f'lddl-monitor: no endpoints found '
            f'(no monitor.rank*.json in {args.dir})', file=sys.stderr)
      return 2
    fleet = poll_fleet(urls, timeout=args.timeout)
    fleet['errors'].update(dead)
    if args.dir:
      fleet['data_servers'] = discover_serve_announcements(args.dir)
    if args.once:
      if args.json:
        print(json.dumps(fleet, default=str, indent=2))
      else:
        print(render_frame(fleet, clear=False))
      return 0 if fleet['ranks'] else 1
    print(render_frame(fleet, clear=True), flush=True)
    time.sleep(args.interval)


if __name__ == '__main__':
  sys.exit(main())
