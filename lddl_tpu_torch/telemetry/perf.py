"""``python -m lddl_tpu_torch.telemetry.perf``: robust perf-regression
detection over bench history, the port's copy of
:mod:`lddl_tpu.telemetry.perf` (the JAX package's ``lddl-perf``).

For each metric series it asks whether the *latest* point is a cliff
relative to the prior points, using median ± MAD robust statistics (a
cliff in the history must not poison the baseline that judges it, and
real trajectories are noisy). The series come from ``BENCH_r*.json``
rounds, ``MULTICHIP_r*.json`` pass/fail and a bench-history JSONL
(:func:`append_history` appends to it; ``chip_smoke.py`` writes one).

Decision rule, per series (latest point x, baseline = prior points):

  scale = max(1.4826 * MAD, min_rel_drop * |median|)
  regression iff  (median - x) * direction > 0            (got worse)
             and |x - median| / scale > threshold          (far outside
                                                            usual noise)
             and |x - median| / |median| > min_rel_drop    (and by a
                                                            margin anyone
                                                            cares about)

``direction`` is inferred from the metric name (latency/seconds/ms →
lower-is-better; everything else higher-is-better). The MAD floor keeps
a near-constant series (MAD ≈ 0) from flagging measurement jitter. The
sentinel's spike detectors judge the live loss and grad-norm streams
with :func:`robust_stats`.

``--gate`` folds in the port's legs: ``--audit`` over the port's
auditor (:mod:`~lddl_tpu_torch.telemetry.audit`), ``--replay-smoke``
over its batch replay (:func:`~lddl_tpu_torch.replay.rematerialize.
replay_smoke`; default factory the port's synthetic loader) and
``--incidents`` over its flight recorder's tree
(:func:`~lddl_tpu_torch.training.flight.scan_incidents`). The JAX gate's
concurrency leg lints the package with ``lddl_tpu.analysis``, which the
port may not import: here it reports the lint unavailable and passes,
as the JAX gate does when its analyzer cannot load.
"""

import argparse
import glob
import json
import os
import sys

DEFAULT_THRESHOLD = 4.0
DEFAULT_MIN_REL_DROP = 0.05
MIN_POINTS = 4

_HIGHER_IS_BETTER_HINTS = ('per_sec', 'per_s', 'throughput', 'goodput',
                           'mfu', 'rate', '_ok', 'samples', 'frac')
_LOWER_IS_BETTER_HINTS = ('latency', 'seconds', '_ms', '_sec', 'wait',
                          'stall', 'overhead', 'bytes_in_use')


def metric_direction(name):
  """+1 when higher is better, -1 when lower is better. Throughput-ish
  hints are checked first: '_sec' must not claim 'mb_per_sec'."""
  low = name.lower()
  if any(h in low for h in _HIGHER_IS_BETTER_HINTS):
    return 1
  return -1 if any(h in low for h in _LOWER_IS_BETTER_HINTS) else 1


def _median(values):
  s = sorted(values)
  n = len(s)
  mid = n // 2
  return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_stats(values):
  """(median, MAD) of a series."""
  med = _median(values)
  return med, _median([abs(v - med) for v in values])


def judge_series(name, values, threshold=DEFAULT_THRESHOLD,
                 min_rel_drop=DEFAULT_MIN_REL_DROP, min_points=MIN_POINTS):
  """Judge the last point of ``values`` against the rest.

  Returns a verdict dict (``status``: ``ok`` / ``regression`` /
  ``insufficient-data``) with the statistics that justified it.
  """
  out = {'metric': name, 'points': len(values),
         'latest': values[-1] if values else None}
  if len(values) < min_points:
    out['status'] = 'insufficient-data'
    return out
  baseline = values[:-1]
  latest = values[-1]
  med, mad = robust_stats(baseline)
  scale = max(1.4826 * mad, min_rel_drop * abs(med), 1e-12)
  z = (latest - med) / scale
  direction = metric_direction(name)
  rel_change = (latest - med) / abs(med) if med else 0.0
  worse = direction * z < 0
  out.update(baseline_median=round(med, 6), baseline_mad=round(mad, 6),
             robust_z=round(z, 3), rel_change=round(rel_change, 4),
             direction='higher-is-better' if direction > 0
             else 'lower-is-better')
  if worse and abs(z) > threshold and abs(rel_change) > min_rel_drop:
    out['status'] = 'regression'
  else:
    out['status'] = 'ok'
  return out


# ---------------------------------------------------------------------------
# history loaders: BENCH_r*.json, MULTICHIP_r*.json, bench-history JSONL


def _numeric_items(d, prefix=''):
  for k, v in d.items():
    if isinstance(v, bool):
      yield prefix + k, 1.0 if v else 0.0
    elif isinstance(v, (int, float)):
      yield prefix + k, float(v)


def load_bench_rounds(root):
  """Series from ``BENCH_r*.json`` benchmark rounds: the headline metric by
  its own name, plus any extra numeric keys in ``parsed``."""
  series = {}
  for path in sorted(glob.glob(os.path.join(root, 'BENCH_r*.json'))):
    try:
      with open(path) as f:
        rec = json.load(f)
    except (OSError, ValueError):
      continue
    parsed = rec.get('parsed') or {}
    metric = parsed.get('metric')
    if metric and isinstance(parsed.get('value'), (int, float)):
      series.setdefault(metric, []).append(float(parsed['value']))
    for k, v in _numeric_items(parsed):
      if k in ('value', 'vs_baseline') or k == 'metric':
        continue
      series.setdefault(k, []).append(v)
  return series


def load_multichip_rounds(root):
  """``MULTICHIP_r*.json`` pass/fail as a 1.0/0.0 series (skipped rounds
  are excluded rather than counted as failures)."""
  values = []
  for path in sorted(glob.glob(os.path.join(root, 'MULTICHIP_r*.json'))):
    try:
      with open(path) as f:
        rec = json.load(f)
    except (OSError, ValueError):
      continue
    if rec.get('skipped'):
      continue
    values.append(1.0 if rec.get('ok') else 0.0)
  return {'multichip_smoke_ok': values} if values else {}


def load_history_jsonl(path):
  """Series from a bench-history JSONL (:func:`append_history`): every
  numeric field of each record, keyed by field name (nested ``parsed``
  dicts flattened one level)."""
  series = {}
  try:
    with open(path) as f:
      lines = f.read().splitlines()
  except OSError:
    return series
  for line in lines:
    line = line.strip()
    if not line:
      continue
    try:
      rec = json.loads(line)
    except ValueError:
      continue
    if not isinstance(rec, dict):
      continue
    flat = dict(_numeric_items(rec))
    parsed = rec.get('parsed')
    if isinstance(parsed, dict):
      flat.update(_numeric_items(parsed))
    metric = rec.get('metric')
    if not metric and isinstance(parsed, dict):
      metric = parsed.get('metric')
    if isinstance(metric, str) and 'value' in flat:
      flat[metric] = flat.pop('value')
    for k, v in flat.items():
      if k in ('n', 'rc', 'vs_baseline'):
        continue
      series.setdefault(k, []).append(v)
  return series


def append_history(path, record):
  """Append one bench record to the history JSONL (``chip_smoke.py``
  appends its scan-window timings)."""
  parent = os.path.dirname(path)
  if parent:
    os.makedirs(parent, exist_ok=True)
  with open(path, 'a') as f:
    f.write(json.dumps(record, sort_keys=True) + '\n')


# ---------------------------------------------------------------------------
# CLI


def gather_series(root, history=None):
  series = load_bench_rounds(root)
  for name, values in load_multichip_rounds(root).items():
    series.setdefault(name, []).extend(values)
  if history is None:
    candidate = os.path.join(root, 'bench_history.jsonl')
    history = candidate if os.path.exists(candidate) else None
  if history:
    for name, values in load_history_jsonl(history).items():
      series.setdefault(name, []).extend(values)
  return series


def attach_args(parser):
  parser.add_argument('--root', default='.',
                      help='directory holding BENCH_r*.json / '
                           'MULTICHIP_r*.json (default: cwd)')
  parser.add_argument('--history', default=None,
                      help='bench-history JSONL (default: '
                           '<root>/bench_history.jsonl when present)')
  parser.add_argument('--threshold', type=float, default=DEFAULT_THRESHOLD,
                      help='robust-z threshold (default %(default)s)')
  parser.add_argument('--min-rel-drop', type=float,
                      default=DEFAULT_MIN_REL_DROP,
                      help='ignore changes smaller than this fraction of '
                           'the baseline median (default %(default)s)')
  parser.add_argument('--min-points', type=int, default=MIN_POINTS,
                      help='series shorter than this are not judged '
                           '(default %(default)s)')
  parser.add_argument('--gate', action='store_true',
                      help='exit 1 when any series regressed (CI mode); '
                           'the JAX gate\'s concurrency lint is reported '
                           'unavailable here')
  parser.add_argument('--audit', nargs='+', metavar='LEDGER',
                      help='also run the determinism auditor over these '
                           'ledger paths: one path self-checks the run '
                           '(replay conflicts, wire damage), two paths '
                           'verify the first against the second '
                           '(lddl-audit verify). Under --gate the audit '
                           'exit code folds into the return code, so one '
                           'command gates perf and determinism.')
  parser.add_argument('--replay-smoke', action='store_true',
                      help='with --audit: also replay one random '
                           'recorded coordinate per ledger boundary '
                           '(lddl-replay smoke) and fold the verdict '
                           'into the gate exit code — the audit proves '
                           'the lineage is consistent, the smoke proves '
                           'it is still *executable*')
  parser.add_argument('--replay-factory', default=None,
                      metavar='MODULE:ATTR',
                      help='loader factory the smoke rebuilds batches '
                           'with (default: the synthetic loader)')
  parser.add_argument('--replay-kwargs-json', default='{}',
                      help='JSON kwargs for --replay-factory')
  parser.add_argument('--incidents', default=None, metavar='DIR',
                      help='also scan this flight-recorder incident tree '
                           '(training/flight.py): any incident manifest '
                           'present fails --gate with its trigger and '
                           'one-command replay printed — a run that '
                           'tripped a sentinel must not pass CI')
  parser.add_argument('--json', action='store_true', dest='as_json',
                      help='emit the full verdict list as JSON')
  return parser


def run_audit(paths):
  """Run the determinism auditor for ``--audit`` and return its exit code.

  One path self-diffs the run (catches intra-run replay conflicts and
  serve.tx/serve.rx wire damage with no reference needed); two paths
  verify the first against the second. More than two is a usage error
  (exit 2) — verify compares exactly one run against one reference.
  """
  from .audit import main as audit_main
  if len(paths) == 1:
    return audit_main(['diff', paths[0], paths[0]])
  if len(paths) == 2:
    return audit_main(['verify', paths[0], paths[1]])
  print('lddl-perf: --audit takes one ledger path (self-check) or two '
        '(run, reference)', file=sys.stderr)
  return 2


def check_incidents(root):
  """``--incidents``: scan a flight-recorder tree and report every
  incident manifest. Returns ``(rc, count)`` — rc 1 when any incident
  (or unreadable manifest) exists, each printed with its trigger and
  the one-command replay so the CI log IS the triage entry point."""
  from ..training.flight import replay_command, scan_incidents
  incidents = scan_incidents(root)
  for inc in incidents:
    man = inc.get('manifest')
    if man is None:
      print(f'lddl-perf: incident {inc["dir"]}: unreadable manifest '
            f'({inc.get("error")})', file=sys.stderr)
      continue
    trig = man.get('trigger') or {}
    print(f'lddl-perf: incident {inc["dir"]}: '
          f'{trig.get("detector", "?")} at step {man.get("step")} — '
          f'{trig.get("reason", "")}', file=sys.stderr)
    cmd = replay_command(inc['dir'], man)
    if cmd:
      print(f'lddl-perf:   replay: {cmd}', file=sys.stderr)
  if incidents:
    print(f'lddl-perf: {len(incidents)} incident(s) under {root}',
          file=sys.stderr)
    return 1, len(incidents)
  return 0, 0


def check_concurrency():
  """``--gate``'s concurrency leg. The JAX gate runs
  ``lddl_tpu.analysis``'s thread-graph rules over its package; the port
  may not import that package, so the leg reports the lint unavailable
  and passes (``(0, 0)``), as the JAX gate does when its analyzer cannot
  load. ``tests/test_torch_analysis.py`` holds the port at zero
  findings instead."""
  print('lddl-perf: concurrency lint unavailable: the analyzer is '
        'lddl_tpu.analysis, which lddl_tpu_torch does not import',
        file=sys.stderr)
  return 0, 0


def run_replay_smoke(ledger_path, factory_spec=None, kwargs_json='{}'):
  """``--replay-smoke``: one random recorded coordinate per boundary,
  rematerialized and verified against its ledger line (skips
  boundaries with no batch position). Returns the smoke exit code —
  0 all replayed coordinates matched, 1 on any mismatch/error."""
  from ..replay.rematerialize import replay_smoke
  if factory_spec:
    module, _, attr = factory_spec.partition(':')
    factory, kwargs = (module, attr), json.loads(kwargs_json)
  else:
    factory = ('lddl_tpu_torch.testing', 'get_synthetic_batch_loader')
    kwargs = json.loads(kwargs_json)
  try:
    results, rc = replay_smoke(ledger_path, factory, kwargs)
  except (FileNotFoundError, ValueError, LookupError) as e:
    print(f'lddl-perf: replay smoke failed: {e}', file=sys.stderr)
    return 2
  for bd, r in sorted(results.items()):
    extra = ''
    if 'coordinate' in r:
      extra = f' at {r["coordinate"]}'
    if r['status'] not in ('ok', 'skipped'):
      extra += f' — {r.get("error", "digest mismatch")}'
    print(f'lddl-perf: replay-smoke {bd}: {r["status"]}{extra}')
  return rc


def main(argv=None):
  args = attach_args(argparse.ArgumentParser(
      prog='python -m lddl_tpu_torch.telemetry.perf',
      description='robust perf-regression check over bench history')) \
      .parse_args(argv)
  # Determinism leg first: its findings print even when the perf leg
  # later bails on missing history, so CI logs always show both verdicts.
  audit_rc = run_audit(args.audit) if args.audit else 0
  if args.replay_smoke:
    if not args.audit:
      print('lddl-perf: --replay-smoke requires --audit (the smoke '
            'replays that ledger)', file=sys.stderr)
      return 2
    smoke_rc = run_replay_smoke(args.audit[0], args.replay_factory,
                                args.replay_kwargs_json)
    audit_rc = audit_rc or smoke_rc
  incident_rc, incident_count = 0, 0
  if args.incidents:
    incident_rc, incident_count = check_incidents(args.incidents)
  # Concurrency leg only under --gate, as in the JAX gate.
  conc_rc, conc_count = check_concurrency() if args.gate else (0, 0)
  series = gather_series(args.root, args.history)
  if not series:
    if args.incidents:
      # The incident leg can verdict without bench history: a clean
      # training run may predate any bench rounds, and a tripped
      # sentinel must fail the gate either way.
      print(f'lddl-perf: no bench history under {args.root!r}; '
            'judging incidents only', file=sys.stderr)
      return (incident_rc or audit_rc or conc_rc) if args.gate else 0
    print(f'lddl-perf: no bench history under {args.root!r} '
          '(expected BENCH_r*.json / MULTICHIP_r*.json / '
          'bench_history.jsonl)', file=sys.stderr)
    return 2
  verdicts = [judge_series(name, values, threshold=args.threshold,
                           min_rel_drop=args.min_rel_drop,
                           min_points=args.min_points)
              for name, values in sorted(series.items())]
  regressions = [v for v in verdicts if v['status'] == 'regression']
  if args.as_json:
    out = {'verdicts': verdicts, 'regressions': len(regressions)}
    if args.audit:
      out['audit_exit'] = audit_rc
    if args.incidents:
      out['incidents'] = incident_count
    if args.gate:
      out['concurrency_findings'] = conc_count
    print(json.dumps(out, indent=2))
  else:
    for v in verdicts:
      line = f'{v["status"]:>18}  {v["metric"]}  n={v["points"]}'
      if 'robust_z' in v:
        line += (f'  latest={v["latest"]:g}  median={v["baseline_median"]:g}'
                 f'  z={v["robust_z"]:+.2f}  rel={v["rel_change"]:+.1%}'
                 f'  [{v["direction"]}]')
      print(line)
    if regressions:
      names = ', '.join(v['metric'] for v in regressions)
      print(f'lddl-perf: {len(regressions)} regression(s): {names}',
            file=sys.stderr)
    if args.audit and audit_rc == 0:
      print('lddl-perf: determinism audit ok')
    if args.incidents and incident_rc == 0:
      print(f'lddl-perf: no incidents under {args.incidents}')
  # One command, one verdict: under --gate a determinism failure or a
  # captured incident is a gate failure exactly like a perf regression
  # (perf's code wins when several fired, so CI triage starts from the
  # regression list).
  rc = 1 if (args.gate and regressions) else 0
  if args.gate and incident_rc and not rc:
    rc = incident_rc
  if args.gate and audit_rc and not rc:
    rc = audit_rc
  if args.gate and conc_rc and not rc:
    rc = conc_rc
  return rc


if __name__ == '__main__':
  sys.exit(main())
