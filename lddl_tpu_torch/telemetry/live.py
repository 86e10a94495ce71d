"""Fleet straggler scores: :func:`straggler_scores` of
:mod:`lddl_tpu.telemetry.live`, which
:class:`~lddl_tpu_torch.training.elastic.RankMembership` judges with. The
live HTTP monitor is not ported yet."""

import math


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
