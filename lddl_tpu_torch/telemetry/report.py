"""Cross-rank aggregation + the ``telemetry-report`` CLI: a copy of
:mod:`lddl_tpu.telemetry.report` (stdlib only), run as ``python -m
lddl_tpu_torch.telemetry.report --dir <dir>``.

Per-rank JSONL snapshots (written by :meth:`Telemetry.write_jsonl`)
merge into one view: counters and histograms add exactly across ranks,
gauges keep mean/min/max. The renderer groups metrics into the pipeline
stages they instrument (``preprocess`` executor phases, ``loader``,
``comm``, ``train``) and names the bottleneck stage — per-stage
throughput plus cross-rank stall attribution (per-rank data-wait and
collective-latency totals expose stragglers that rank-merged means
hide).

Aggregation has two transports:

  - offline: ``python -m lddl_tpu_torch.telemetry.report --dir <dir>``
    globs ``telemetry.rank*.jsonl`` (any rank count, no live job
    needed);
  - live: :func:`aggregate_over_comm` rides the job's own
    ``CommBackend.allgather_object`` so rank 0 can print the merged
    report at the end of a run.
"""

import argparse
import glob
import json
import math
import os
import sys


def load_rank_files(directory):
  """Parse every ``telemetry.rank*.jsonl`` under ``directory``; returns
  a list of metric-line lists (one per file)."""
  paths = sorted(glob.glob(os.path.join(directory, 'telemetry.rank*.jsonl')))
  if not paths:
    raise FileNotFoundError(
        f'no telemetry.rank*.jsonl files under {directory} '
        '(run with LDDL_TELEMETRY=1 and LDDL_TELEMETRY_DIR set)')
  out = []
  for p in paths:
    lines = []
    with open(p) as f:
      for ln, line in enumerate(f, start=1):
        if not line.strip():
          continue
        try:
          lines.append(json.loads(line))
        except ValueError:
          # A SIGKILLed exporter can leave a torn trailing line; keep
          # the readable prefix instead of failing the whole report.
          print(f'telemetry-report: skipping unparseable line {ln} of '
                f'{p} (truncated write?)', file=sys.stderr)
    out.append(lines)
  return out


def _merge_histogram(agg, line):
  agg['count'] += line.get('count', 0)
  agg['sum'] += line.get('sum', 0.0)
  if line.get('count'):
    agg['min'] = min(agg['min'], line['min'])
    agg['max'] = max(agg['max'], line['max'])
  for k, v in (line.get('buckets') or {}).items():
    agg['buckets'][k] = agg['buckets'].get(k, 0) + v


def merge_metric_lines(rank_lines):
  """Merge per-rank metric-line lists into ``{name: merged}``.

  Counters/histograms sum; gauges combine mean/min/max over ranks.
  Every merged entry carries ``per_rank`` (rank -> that rank's fields)
  for stall attribution.
  """
  merged = {'ranks': [], 'metrics': {}}
  for lines in rank_lines:
    for line in lines:
      if line.get('kind') == 'meta':
        merged['ranks'].append(line.get('rank', 0))
        continue
      name, kind = line['name'], line['kind']
      m = merged['metrics'].get(name)
      if m is None:
        if kind == 'counter':
          m = {'kind': kind, 'total': 0, 'per_rank': {}}
        elif kind == 'gauge':
          m = {'kind': kind, 'sum': 0.0, 'count': 0, 'min': math.inf,
               'max': -math.inf, 'per_rank': {}}
        else:
          m = {'kind': kind, 'count': 0, 'sum': 0.0, 'min': math.inf,
               'max': -math.inf, 'buckets': {}, 'per_rank': {}}
        merged['metrics'][name] = m
      rank = line.get('rank', 0)
      m['per_rank'][rank] = {
          k: v for k, v in line.items() if k not in ('kind', 'rank', 'name')}
      if kind == 'counter':
        m['total'] += line.get('total', 0)
      elif kind == 'gauge':
        if line.get('count'):
          m['sum'] += line.get('mean', line.get('value', 0.0)) * line['count']
          m['count'] += line['count']
          m['min'] = min(m['min'], line.get('min', line['value']))
          m['max'] = max(m['max'], line.get('max', line['value']))
      else:
        _merge_histogram(m, line)
  for m in merged['metrics'].values():
    if m['kind'] == 'gauge' and m['count']:
      m['mean'] = m['sum'] / m['count']
  merged['ranks'] = sorted(set(merged['ranks'])) or sorted(
      {r for m in merged['metrics'].values() for r in m['per_rank']})
  return merged


def aggregate_over_comm(comm, telemetry=None, rank=None):
  """Allgather every rank's live snapshot and return the merged view
  (identical structure to merging the JSONL files offline)."""
  from .metrics import get_telemetry
  telemetry = telemetry or get_telemetry()
  rank = comm.rank if rank is None else rank
  snapshots = comm.allgather_object(telemetry.snapshot_lines(rank=rank))
  return merge_metric_lines(snapshots)


def _fmt_secs(s):
  if s is None or s != s:
    return '--'
  if s < 1e-3:
    return f'{s * 1e6:.0f}us'
  if s < 1.0:
    return f'{s * 1e3:.1f}ms'
  return f'{s:.2f}s'


def _hist_line(name, m):
  mean = m['sum'] / m['count'] if m['count'] else None
  return (f'  {name}: n={m["count"]} total={_fmt_secs(m["sum"])} '
          f'mean={_fmt_secs(mean)} max={_fmt_secs(m["max"] if m["count"] else None)}')


def _stage_of(name):
  head = name.split('.', 1)[0]
  return {'pipeline': 'preprocess', 'loader': 'loader', 'comm': 'comm',
          'train': 'train'}.get(head, head)


def summarize_stages(merged):
  """Per-stage totals + the bottleneck verdict. Returns a dict:
  ``{'stages': {stage: seconds}, 'bottleneck': str, 'detail': str}``."""
  metrics = merged['metrics']
  stages = {}

  def _hsum(name):
    m = metrics.get(name)
    return m['sum'] if m and m['kind'] == 'histogram' else 0.0

  for name, m in metrics.items():
    if m['kind'] != 'histogram':
      continue
    # Stage cost model: time actually spent inside that stage's spans.
    # map_seconds wraps task_seconds; count only the inner task time so
    # preprocess isn't double-billed.
    if name.startswith('pipeline.') and name.endswith('.task_seconds'):
      stages['preprocess'] = stages.get('preprocess', 0.0) + m['sum']
    elif name.startswith('loader.') and 'stall' not in name:
      stages['loader'] = stages.get('loader', 0.0) + m['sum']
    elif name.startswith('comm.'):
      stages['comm'] = stages.get('comm', 0.0) + m['sum']

  data_wait = _hsum('train.data_wait_seconds')
  compute = _hsum('train.compute_seconds')
  if data_wait or compute:
    stages['train.data_wait'] = data_wait
    stages['train.compute'] = compute
    frac = data_wait / max(data_wait + compute, 1e-12)
    if frac > 0.3:
      bottleneck = 'loader (training steps wait on input data)'
      detail = (f'{100 * frac:.0f}% of step time is data wait '
                f'({_fmt_secs(data_wait)} of '
                f'{_fmt_secs(data_wait + compute)})')
    else:
      bottleneck = 'compute (input pipeline keeps the chips busy)'
      detail = (f'data wait is {100 * frac:.0f}% of step time '
                f'({_fmt_secs(data_wait)} of '
                f'{_fmt_secs(data_wait + compute)})')
    return {'stages': stages, 'bottleneck': bottleneck, 'detail': detail}
  if not stages:
    return {'stages': stages, 'bottleneck': 'unknown (no stage timings)',
            'detail': ''}
  worst = max(stages, key=stages.get)
  return {'stages': stages,
          'bottleneck': worst,
          'detail': f'{worst} holds the largest total span time '
                    f'({_fmt_secs(stages[worst])})'}


def render_report(merged):
  """Human-readable per-stage summary of a merged snapshot."""
  metrics = merged['metrics']
  ranks = merged['ranks']
  out = [f'telemetry report — {len(ranks)} rank(s): {ranks}']

  by_stage = {}
  for name in sorted(metrics):
    by_stage.setdefault(_stage_of(name), []).append(name)

  # -- preprocess stages: per-stage task latency + throughput --
  if 'preprocess' in by_stage:
    out.append('\n[preprocess pipeline]')
    labels = sorted({n.split('.')[1] for n in by_stage['preprocess']})
    for label in labels:
      tasks = metrics.get(f'pipeline.{label}.tasks', {}).get('total', 0)
      th = metrics.get(f'pipeline.{label}.task_seconds')
      wall = metrics.get(f'pipeline.{label}.map_seconds')
      rate = None
      if wall and wall['count'] and wall['sum'] > 0:
        # map_seconds is per-rank wall time; ranks overlap, so the rate
        # uses the slowest rank's wall (the stage's critical path).
        slowest = max(
            (pr.get('sum', 0.0) for pr in wall['per_rank'].values()),
            default=wall['sum'])
        rate = tasks / slowest if slowest > 0 else None
      out.append(f'  stage {label}: {tasks} tasks'
                 + (f', {rate:.2f} tasks/s' if rate else ''))
      if th and th['count']:
        out.append(_hist_line(f'{label}.task_seconds', th))

  # -- loader --
  if 'loader' in by_stage:
    out.append('\n[loader]')
    rows = metrics.get('loader.rows', {}).get('total', 0)
    batches = metrics.get('loader.batches', {}).get('total', 0)
    out.append(f'  rows={rows} batches={batches}')
    for name in by_stage['loader']:
      m = metrics[name]
      if m['kind'] != 'histogram' or not m['count']:
        continue
      out.append(_hist_line(name, m))
    stall = metrics.get('loader.pull_stall_seconds')
    if stall and stall['count']:
      per_rank = {r: _fmt_secs(pr.get('sum', 0.0))
                  for r, pr in sorted(stall['per_rank'].items())}
      out.append(f'  stall by rank: {per_rank}')

  # -- comm --
  if 'comm' in by_stage:
    out.append('\n[comm]')
    for name in by_stage['comm']:
      m = metrics[name]
      if m['kind'] == 'histogram' and m['count']:
        out.append(_hist_line(name, m))
        per_rank = {r: _fmt_secs(pr.get('sum', 0.0))
                    for r, pr in sorted(m['per_rank'].items())}
        out.append(f'    by rank: {per_rank}')

  # -- train --
  if 'train' in by_stage:
    out.append('\n[train]')
    steps = metrics.get('train.steps', {}).get('total', 0)
    samples = metrics.get('train.samples', {}).get('total', 0)
    step_h = metrics.get('train.step_seconds')
    if step_h and step_h['count']:
      mean = step_h['sum'] / step_h['count']
      out.append(f'  steps={steps} samples={samples} '
                 f'mean step={_fmt_secs(mean)}')
    for name in ('train.data_wait_seconds', 'train.compute_seconds'):
      m = metrics.get(name)
      if m and m['count']:
        out.append(_hist_line(name, m))
    wait = metrics.get('train.data_wait_seconds')
    if wait and wait['count']:
      per_rank = {r: _fmt_secs(pr.get('sum', 0.0))
                  for r, pr in sorted(wait['per_rank'].items())}
      out.append(f'  data wait by rank: {per_rank}')
    mfu = metrics.get('train.mfu')
    if mfu and mfu.get('count'):
      out.append(f'  MFU: mean={100 * mfu["mean"]:.2f}% '
                 f'min={100 * mfu["min"]:.2f}% max={100 * mfu["max"]:.2f}%')
    tput = metrics.get('train.samples_per_sec')
    if tput and tput.get('count'):
      out.append(f'  throughput: {tput["mean"]:.1f} samples/s '
                 f'(max {tput["max"]:.1f})')
    tiles = metrics.get('train.attn_tiles_total', {}).get('total', 0)
    if tiles:
      skipped = metrics.get('train.attn_tiles_skipped',
                            {}).get('total', 0)
      out.append(f'  attention tiles: {tiles} total, {skipped} skipped '
                 f'({100 * skipped / tiles:.1f}% block-diagonal skip)')

  ft_counters = {
      'partitions claimed': 'pipeline.elastic.claims',
      'partitions re-executed': 'pipeline.elastic.reexecutions',
      'leases revoked': 'pipeline.elastic.revokes',
      'resume-skipped': 'pipeline.elastic.resume_skipped',
      'pool workers respawned': 'pipeline.pool.respawns',
      'comm IO retries': 'comm.io_retries',
      'train preemptions': 'train.elastic.preemptions',
      'train dead ranks': 'train.elastic.dead_ranks',
      'train ranks shed': 'train.elastic.sheds',
      'train rank rejoins': 'train.elastic.rejoins',
      'async ckpt writes': 'train.ckpt_writes',
  }
  ft_lines = []
  for title, name in ft_counters.items():
    total = metrics.get(name, {}).get('total', 0)
    if total:
      ft_lines.append(f'  {title}: {total}')
  if ft_lines:
    out.append('\n[fault tolerance]')
    out.extend(ft_lines)

  verdict = summarize_stages(merged)
  out.append('\n[bottleneck]')
  out.append(f'  {verdict["bottleneck"]}')
  if verdict['detail']:
    out.append(f'  {verdict["detail"]}')
  return '\n'.join(out)


def attach_args(parser):
  parser.add_argument('--dir', required=True,
                      help='directory holding telemetry.rank*.jsonl files')
  parser.add_argument('--json', action='store_true',
                      help='print the merged snapshot as JSON instead of '
                           'the human-readable report')
  return parser


def main(args=None):
  parser = attach_args(argparse.ArgumentParser(
      description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter))
  args = parser.parse_args(args)
  try:
    rank_lines = load_rank_files(args.dir)
  except FileNotFoundError as e:
    # An operator pointing at the wrong dir should get one clear line
    # and a distinct exit code, not a traceback or an empty report.
    print(f'telemetry-report: {e}', file=sys.stderr)
    return 2
  merged = merge_metric_lines(rank_lines)
  if args.json:
    print(json.dumps(merged, default=str, indent=2))
  else:
    print(render_report(merged))
  return 0


if __name__ == '__main__':
  sys.exit(main())
