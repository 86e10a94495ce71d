"""Robust statistics of the ``lddl-perf`` decision rule.

Only :func:`robust_stats` of :mod:`lddl_tpu.telemetry.perf` is copied
here: the sentinel's spike detectors judge the live loss and grad-norm
streams with it. The bench-history gate itself is not ported.
"""


def _median(values):
  s = sorted(values)
  n = len(s)
  mid = n // 2
  return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_stats(values):
  """(median, MAD) of a series."""
  med = _median(values)
  return med, _median([abs(v - med) for v in values])
