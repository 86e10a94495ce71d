"""Streaming verdict engine: windowed rates, straggler scores, goodput.

A copy of :mod:`lddl_tpu.telemetry.live` (the port keeps its own copy
and imports nothing of :mod:`lddl_tpu`). Every signal is derived from
the :class:`~lddl_tpu_torch.telemetry.metrics.Telemetry` registry while
the run goes, with no lock and no sampler thread of its own: whoever
polls (the ``LDDL_MONITOR`` HTTP server, a test, rank 0's aggregation
round) drives the sampling cadence.

Three layers, each a pure function of registry snapshots:

  - :class:`SnapshotWindow` — a bounded deque of ``snapshot_lines()``
    captures; ``delta()`` subtracts oldest from newest
    (:func:`~.metrics.diff_snapshot_lines`), so every rate is over the
    window's *monotonic* span, never wall clock;
  - :func:`live_verdict` / :func:`stage_rates` — the windowed delta
    merged through the offline report machinery
    (:func:`~.report.merge_metric_lines` + ``summarize_stages``), with
    the roofline, data-service (:func:`serve_verdict`) and determinism
    sub-verdicts;
  - :func:`rank_signals` / :func:`straggler_scores` — per-rank progress
    rates vs the fleet median, aggregated over the run's own comm backend
    (:func:`straggler_over_comm`), which
    :class:`~lddl_tpu_torch.training.elastic.RankMembership` judges
    with, and :func:`goodput_meters` — padding efficiency, step-cache hit
    rate, h2d/compute overlap, queue/slot backpressure, HBM.

:func:`live_status` is the ``/snapshot`` payload. Its HBM block reads
only the CUDA caching allocator's host-side counters
(:func:`~.roofline.sample_hbm`), so a scrape makes no CUDA runtime call
and cannot disturb a graph capture on the train loop's thread.
"""

import collections
import math
import os
import time

from .metrics import diff_snapshot_lines, get_telemetry
from .report import merge_metric_lines, summarize_stages


class SnapshotWindow:
  """Rolling registry captures; rates/percentiles over the last N.

  ``sample()`` appends the live registry's ``snapshot_lines()`` (each
  capture carries its own ``(unix, monotonic)`` anchor pair);
  ``push()`` accepts pre-built lines for synthetic/offline use.
  ``delta()`` diffs the oldest retained capture against the newest, so
  the window span grows until the deque is full and then slides.
  """

  def __init__(self, capacity=12):
    if capacity < 2:
      raise ValueError(f'window capacity must be >= 2, got {capacity}')
    self._snaps = collections.deque(maxlen=capacity)

  def __len__(self):
    return len(self._snaps)

  def sample(self, telemetry=None, rank=0):
    """Capture the live registry (or ``telemetry``) into the window."""
    tele = telemetry if telemetry is not None else get_telemetry()
    lines = tele.snapshot_lines(rank=rank)
    if lines:
      self._snaps.append(lines)
    return lines

  def push(self, lines):
    """Append pre-built snapshot lines (tests, replayed JSONL)."""
    self._snaps.append(lines)

  def delta(self):
    """Windowed delta lines (oldest -> newest), or None if < 2 samples."""
    if len(self._snaps) < 2:
      return None
    return diff_snapshot_lines(self._snaps[0], self._snaps[-1])

  def window_sec(self):
    """Monotonic span the current delta covers (0.0 if < 2 samples)."""
    d = self.delta()
    if d is None:
      return 0.0
    for line in d:
      if line.get('kind') == 'meta':
        return line.get('window_sec', 0.0)
    return 0.0


def _merged_delta(window):
  d = window.delta()
  if d is None:
    return None, 0.0
  merged = merge_metric_lines([d])
  sec = window.window_sec()
  return merged, sec


def stage_rates(window):
  """Per-counter events/sec over the window: ``{name: rate}``.

  Histogram names get ``<name>.rate`` (occurrences/sec) plus
  ``<name>.mean`` (mean seconds within the window) so per-stage span
  costs read online the way the report prints them post-hoc.
  """
  merged, sec = _merged_delta(window)
  if merged is None or sec <= 0:
    return {}
  rates = {}
  for name, m in merged['metrics'].items():
    if m['kind'] == 'counter':
      if m['total']:
        rates[name] = m['total'] / sec
    elif m['kind'] == 'histogram' and m['count']:
      rates[name + '.rate'] = m['count'] / sec
      rates[name + '.mean'] = m['sum'] / m['count']
  return rates


def live_verdict(window):
  """The post-hoc bottleneck verdict, computed over the live window.

  Returns ``summarize_stages``' dict plus ``window_sec``, the
  ``serve`` and ``determinism`` sub-verdicts and a ``roofline`` one
  (achieved vs peak FLOP/s and bytes/s, bound class; "unknown" in the
  port, whose step cache feeds no compiler cost counters). Falls back to
  ``{'bottleneck': 'unknown (window warming up)'}`` until the window
  holds two samples.
  """
  from .ledger import determinism_verdict
  merged, sec = _merged_delta(window)
  if merged is None:
    return {'stages': {}, 'bottleneck': 'unknown (window warming up)',
            'detail': '', 'window_sec': 0.0, 'roofline': None,
            'serve': None, 'determinism': determinism_verdict()}
  verdict = summarize_stages(merged)
  verdict['window_sec'] = sec
  from .roofline import roofline_verdict
  verdict['roofline'] = roofline_verdict(merged, sec)
  verdict['serve'] = serve_verdict(merged, sec)
  # None whenever LDDL_LEDGER is off: determinism checking is opt-in
  # and a quiet dashboard must stay quiet.
  verdict['determinism'] = determinism_verdict()
  return verdict


def serve_verdict(merged, sec):
  """Data-service sub-verdict over a windowed delta: delivery rate plus
  the fault-churn counters (re-serves to recovering clients, lease
  revocations of dead ones, degrade/re-attach transitions). None when
  the window saw no ``serve.*`` activity — quiet dashboards for the
  overwhelming majority of runs that never serve over the wire."""
  metrics = merged['metrics']
  served = _counter_total(metrics, 'serve.batches_served')
  pulls = _counter_total(metrics, 'serve.client_pulls')
  meters = {
      'batches_served': served,
      'batches_per_sec': served / sec if sec > 0 else None,
      'client_pulls': pulls,
      'reserves': _counter_total(metrics, 'serve.reserves'),
      'lease_revokes': _counter_total(metrics, 'serve.lease_revokes'),
      'fallbacks': _counter_total(metrics, 'serve.fallbacks'),
      'reattaches': _counter_total(metrics, 'serve.reattaches'),
      'clients': _gauge(metrics, 'serve.clients'),
      'backlog': _gauge(metrics, 'serve.backlog'),
  }
  active = (served or pulls or meters['reserves'] or
            meters['lease_revokes'] or meters['fallbacks'] or
            meters['reattaches'] or meters['clients'] is not None or
            meters['backlog'] is not None)
  return meters if active else None


# ---------------------------------------------------------------------------
# goodput / padding-efficiency meters


def _counter_total(metrics, name):
  m = metrics.get(name)
  return m.get('total', 0) if m and m['kind'] == 'counter' else 0


def _hist_sum(metrics, name):
  m = metrics.get(name)
  return m.get('sum', 0.0) if m and m['kind'] == 'histogram' else 0.0


def _gauge(metrics, name):
  m = metrics.get(name)
  if not m or m['kind'] != 'gauge':
    return None
  if 'mean' in m:
    return {'mean': m['mean'], 'min': m['min'], 'max': m['max']}
  v = m.get('value')
  return None if v is None else {'mean': v, 'min': v, 'max': v}


def goodput_meters(merged):
  """Efficiency meters from a merged metrics dict (cumulative snapshot
  or windowed delta — both work; pass the delta for \"right now\").

  Returns a dict of named meters, each ``None`` when its inputs are not
  instrumented in this process:

    - ``padding_efficiency``: real tokens / padded token slots across
      the binned collates (per-bin breakdown under ``per_bin``) — the
      live accounting for the waste binning exists to eliminate;
    - ``step_cache_hit_rate``: warm-executable fraction of train steps;
    - ``h2d_overlap_fraction``: 1 - data_wait/h2d — how much of the
      host-to-device transfer hides behind compute;
    - ``attn_tile_skip_fraction``: fraction of attention-grid tiles the
      block-diagonal packed path skipped outright (cross-document
      tiles the flash/ring kernels never compute) — 0 under full
      attention, approaches (k-1)/k at k docs per packed row;
    - ``queue_depth`` / ``shm_slot_occupancy`` / ``writer_backlog`` /
      ``ckpt_backlog``: backpressure gauges (mean/min/max) from the
      loader transport, the async shard writer, and the async
      checkpoint writer.
  """
  metrics = merged['metrics']
  out = {}

  real_total, padded_total, per_bin = 0, 0, {}
  for name, m in metrics.items():
    if m['kind'] != 'counter' or not name.startswith('loader.tokens_real.s'):
      continue
    seq = name[len('loader.tokens_real.s'):]
    real = m['total']
    padded = _counter_total(metrics, f'loader.tokens_padded.s{seq}')
    real_total += real
    padded_total += padded
    if padded:
      per_bin[f's{seq}'] = real / padded
  if padded_total:
    out['padding_efficiency'] = real_total / padded_total
    out['padding_efficiency_per_bin'] = per_bin
    out['tokens_real'] = real_total
    out['tokens_padded'] = padded_total
  else:
    out['padding_efficiency'] = None

  hits = _counter_total(metrics, 'train.step_cache_hits')
  misses = _counter_total(metrics, 'train.step_cache_misses')
  out['step_cache_hit_rate'] = (
      hits / (hits + misses) if hits + misses else None)

  h2d = _hist_sum(metrics, 'train.h2d_seconds')
  wait = _hist_sum(metrics, 'train.data_wait_seconds')
  if h2d > 0:
    # The producer thread transfers batch k+1 while the main thread
    # computes batch k; the part that did NOT hide behind compute is
    # exactly what the main thread then waits out as data_wait.
    out['h2d_overlap_fraction'] = max(0.0, min(1.0, 1.0 - wait / h2d))
  else:
    out['h2d_overlap_fraction'] = None

  tiles = _counter_total(metrics, 'train.attn_tiles_total')
  skipped = _counter_total(metrics, 'train.attn_tiles_skipped')
  out['attn_tile_skip_fraction'] = skipped / tiles if tiles else None

  out['queue_depth'] = _gauge(metrics, 'loader.queue_depth')
  out['shm_slot_occupancy'] = _gauge(metrics, 'loader.shm_slot_occupancy')
  out['writer_backlog'] = _gauge(metrics, 'pipeline.pool.writer_backlog')
  out['ckpt_backlog'] = _gauge(metrics, 'train.ckpt_backlog')

  out['mfu'] = _gauge(metrics, 'train.mfu')
  # Global gradient norm (the train loop exports it each step): the live
  # training-health meter the sentinel's grad_spike
  # detector watches, surfaced here for the monitor's per-rank line.
  out['grad_norm'] = _gauge(metrics, 'train.grad_norm')
  # Device-memory meters: the prefetcher's live-array accounting (the
  # measured form of the "steady-state HBM = 2 batches" donation claim)
  # and the allocator's own view (roofline.sample_hbm).
  out['device_live_bytes'] = _gauge(metrics, 'loader.device_live_bytes')
  out['device_live_batches'] = _gauge(metrics, 'loader.device_live_batches')
  hbm = {
      'bytes_in_use': _gauge(metrics, 'hbm.bytes_in_use'),
      'peak_bytes_in_use': _gauge(metrics, 'hbm.peak_bytes_in_use'),
      'bytes_limit': _gauge(metrics, 'hbm.bytes_limit'),
      'headroom_frac': _gauge(metrics, 'hbm.headroom_frac'),
  }
  out['hbm'] = hbm if any(v is not None for v in hbm.values()) else None

  # Fault-tolerance meters: lease churn of the elastic executor plus the
  # local recovery counters (pool respawns, retried comm IO). All-zero
  # (the healthy fast path) reports None so dashboards stay quiet.
  ft = {
      'claims': _counter_total(metrics, 'pipeline.elastic.claims'),
      'reexecutions': _counter_total(metrics,
                                     'pipeline.elastic.reexecutions'),
      'revokes': _counter_total(metrics, 'pipeline.elastic.revokes'),
      'resume_skipped': _counter_total(metrics,
                                       'pipeline.elastic.resume_skipped'),
      'pool_respawns': _counter_total(metrics, 'pipeline.pool.respawns'),
      'io_retries': _counter_total(metrics, 'comm.io_retries'),
      'train_preemptions': _counter_total(metrics,
                                          'train.elastic.preemptions'),
      'train_dead_ranks': _counter_total(metrics,
                                         'train.elastic.dead_ranks'),
      'train_sheds': _counter_total(metrics, 'train.elastic.sheds'),
      'train_rejoins': _counter_total(metrics, 'train.elastic.rejoins'),
      'async_ckpt_writes': _counter_total(metrics, 'train.ckpt_writes'),
  }
  out['fault_tolerance'] = ft if any(ft.values()) else None

  # Data-service meters (lddl-data-server / network transport clients):
  # delivery volume, the re-serve/revoke churn dead consumers cause, and
  # the degraded-mode transitions. None when this process neither serves
  # nor pulls batches over the wire.
  serve = {
      'batches_served': _counter_total(metrics, 'serve.batches_served'),
      'reserves': _counter_total(metrics, 'serve.reserves'),
      'lease_claims': _counter_total(metrics, 'serve.lease_claims'),
      'lease_revokes': _counter_total(metrics, 'serve.lease_revokes'),
      'client_pulls': _counter_total(metrics, 'serve.client_pulls'),
      'fallbacks': _counter_total(metrics, 'serve.fallbacks'),
      'reattaches': _counter_total(metrics, 'serve.reattaches'),
      'clients': _gauge(metrics, 'serve.clients'),
      'backlog': _gauge(metrics, 'serve.backlog'),
  }
  instrumented = (serve['clients'] is not None or
                  serve['backlog'] is not None or
                  any(isinstance(v, int) and v for v in serve.values()))
  out['serve'] = serve if instrumented else None
  return out


# ---------------------------------------------------------------------------
# straggler scores


# Counter families whose windowed rate is a per-rank progress signal.
# Executor task completion and background write-back lead (the work-
# stealing consumer's signals); loader rows and train steps cover runs
# without a preprocess phase.
_SIGNAL_STEPS = 'steps_per_sec'


def rank_signals(window):
  """This rank's progress rates over its window: the straggler inputs.

  ``{'tasks_per_sec', 'writes_per_sec', 'rows_per_sec',
  'steps_per_sec'}`` — each None when that subsystem produced no events
  in the window, so the fleet comparison only weighs signals a rank
  actually runs.
  """
  merged, sec = _merged_delta(window)
  out = {'tasks_per_sec': None, 'writes_per_sec': None,
         'rows_per_sec': None, _SIGNAL_STEPS: None}
  if merged is None or sec <= 0:
    return out
  metrics = merged['metrics']
  tasks = sum(m['total'] for name, m in metrics.items()
              if m['kind'] == 'counter' and name.startswith('pipeline.') and
              name.endswith('.tasks'))
  if tasks:
    out['tasks_per_sec'] = tasks / sec
  writes = _counter_total(metrics, 'pipeline.pool.writes')
  if writes:
    out['writes_per_sec'] = writes / sec
  rows = _counter_total(metrics, 'loader.rows')
  if rows:
    out['rows_per_sec'] = rows / sec
  steps = _counter_total(metrics, 'train.steps')
  if steps:
    out[_SIGNAL_STEPS] = steps / sec
  return out


def straggler_scores(per_rank_signals):
  """Deterministic per-rank slowness scores vs the fleet median.

  ``per_rank_signals``: ``{rank: rank_signals()-dict}``. For every
  signal at least two ranks report, each rank scores
  ``median_rate / own_rate`` (> 1 means slower than the fleet median;
  a rank reporting zero progress on a signal others advance scores
  ``inf``). A rank's overall score is its worst signal. Pure arithmetic
  over the gathered rates — every rank computes the identical table.

  Returns ``{'scores': {rank: score}, 'signals': {rank: {signal:
  per-signal score}}, 'slowest': rank_or_None}``; ``slowest`` is only
  named when some rank scores > 1 (ties break to the lowest rank).
  """
  signal_names = set()
  for sig in per_rank_signals.values():
    signal_names.update(k for k, v in sig.items() if v is not None)
  per_signal = {}  # signal -> {rank: score}
  for name in sorted(signal_names):
    rates = {r: s.get(name) for r, s in per_rank_signals.items()
             if s.get(name) is not None}
    # A signal only one rank runs (e.g. only rank 0 trains) carries no
    # fleet comparison; require a quorum of two.
    if len(rates) < 2:
      continue
    ordered = sorted(rates.values())
    mid = len(ordered) // 2
    median = (ordered[mid] if len(ordered) % 2 else
              (ordered[mid - 1] + ordered[mid]) / 2.0)
    if median <= 0:
      continue
    per_signal[name] = {
        r: (median / rate if rate > 0 else math.inf)
        for r, rate in rates.items()
    }
  scores = {}
  for rank in per_rank_signals:
    mine = [tbl[rank] for tbl in per_signal.values() if rank in tbl]
    scores[rank] = max(mine) if mine else 1.0
  slowest = None
  flagged = [r for r in sorted(scores) if scores[r] > 1.0]
  if flagged:
    slowest = max(flagged, key=lambda r: (scores[r], -r))
  by_rank = {r: {name: tbl[r] for name, tbl in per_signal.items()
                 if r in tbl} for r in per_rank_signals}
  return {'scores': scores, 'signals': by_rank, 'slowest': slowest}


def straggler_over_comm(comm, window, telemetry=None):
  """Fleet straggler table over the run's own comm backend.

  Every rank contributes its windowed :func:`rank_signals`; the
  allgather rides the backend's normal collective stream, and each
  entry is tagged with the backend's collective sequence number (the
  same seq-keying trace alignment uses) so a consumer merging tables
  from different rounds can reject mismatched ones. All ranks compute
  the identical score table; the result is also exported into the
  registry as ``straggler.rank<R>.score`` gauges so the future
  cross-rank stealer (and the JSONL export) can consume it without
  re-gathering.
  """
  signals = rank_signals(window)
  seq = getattr(comm, 'collective_seq', None)
  gathered = comm.allgather_object(
      {'rank': comm.rank, 'seq': seq, 'signals': signals})
  seqs = {e['seq'] for e in gathered if e.get('seq') is not None}
  result = straggler_scores({e['rank']: e['signals'] for e in gathered})
  result['seq'] = max(seqs) if seqs else None
  if len(seqs) > 1:
    # Backends bump seq per collective, and this allgather IS one
    # collective all ranks issue together, so the tags agree by
    # construction; disagreement means a caller mixed backends/rounds.
    result['seq_mismatch'] = sorted(seqs)
  tele = telemetry if telemetry is not None else get_telemetry()
  if tele.enabled:
    for rank, score in result['scores'].items():
      if math.isfinite(score):
        tele.gauge(f'straggler.rank{rank}.score').set(score)
  return result


# ---------------------------------------------------------------------------
# the one-call status payload the monitor server serves


def live_status(window, rank=0, telemetry=None, include_metrics=True):
  """Everything the ``/snapshot`` endpoint serves, as one JSON-able dict.

  Samples the registry into ``window`` first (the poller's cadence IS
  the window cadence), then derives rates/verdict/goodput from the
  windowed delta and this rank's straggler signals from the same
  window. HBM gauges are refreshed from the caching allocator's
  statistics immediately before the capture, so device-memory telemetry
  runs at exactly the scrape cadence — an unwatched process never polls
  the allocator. ``include_metrics=False`` drops the full cumulative dump for
  lightweight dashboards.
  """
  from .roofline import sample_hbm
  tele = telemetry if telemetry is not None else get_telemetry()
  hbm = sample_hbm(tele)
  lines = window.sample(telemetry=tele, rank=rank)
  status = {
      'rank': rank,
      'pid': os.getpid(),
      'unix_time': time.time(),
      'monotonic': time.monotonic(),
      'window_sec': window.window_sec(),
      'window_samples': len(window),
      'rates': stage_rates(window),
      'verdict': live_verdict(window),
      'signals': rank_signals(window),
  }
  status['hbm'] = hbm
  merged_cum = merge_metric_lines([lines]) if lines else {'metrics': {}}
  status['goodput'] = goodput_meters(merged_cum)
  from .ledger import get_ledger
  ledger = get_ledger()
  if ledger.enabled:
    # Raw per-boundary stream heads for the monitor's client-side
    # cross-rank comparison (compare_signals over every polled rank) —
    # the same payload divergence_over_comm allgathers in-run.
    status['ledger'] = ledger.signals()
  from .sentinel import sentinel_status
  sent = sentinel_status()
  if sent is not None:
    # Trigger counts + registered incident dirs for the monitor's
    # INCIDENT panel; absent entirely when LDDL_SENTINEL is off.
    status['sentinel'] = sent
  if include_metrics:
    status['metrics'] = lines
  return status
