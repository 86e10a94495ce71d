"""Roofline-aware device accounting: chip peaks, the verdict, HBM.

The port's counterpart of :mod:`lddl_tpu.telemetry.roofline`:

  - :func:`resolve_peaks`: the card's peak FLOP/s and memory bandwidth
    from the port's :mod:`~lddl_tpu_torch.models.flops` table
    (``LDDL_PEAK_TFLOPS`` / ``LDDL_PEAK_HBM_GBPS`` override it), and the
    machine balance between them;
  - :func:`roofline_verdict` / :func:`bound_class`: host copies of the
    JAX package's windowed verdict over the ``train.xla_flops`` /
    ``train.xla_bytes`` counters and the data-wait/compute split;
  - :func:`sample_hbm`: ``hbm.*`` gauges from the CUDA caching
    allocator's statistics, with the JAX package's keys.

``compiled_step_costs`` has no counterpart: PyTorch has no compiler cost
model for an eager or captured step, so the port's step cache never
bills ``train.xla_flops`` / ``train.xla_bytes`` and the verdict reads
"unknown" for want of them; MFU takes the analytic FLOP count instead.
"""

import math

import torch


# ---------------------------------------------------------------------------
# card peaks (table + env overrides), cached per process

_peaks_cache = None


def resolve_peaks(refresh=False):
  """Per-process peak table for the roofline axes, resolved once.

  Returns ``{'flops_per_sec', 'hbm_bytes_per_sec', 'balance',
  'device_kind', 'local_devices'}``: the peaks of the one card the port's
  train loop drives (CUDA device 0), ``balance`` the ridge point in
  FLOPs/byte. ``LDDL_PEAK_TFLOPS`` / ``LDDL_PEAK_HBM_GBPS`` override the
  table; on a host it cannot identify (the CPU, an unlisted card) an axis
  without an override is None and the verdict says so.
  """
  global _peaks_cache
  if _peaks_cache is not None and not refresh:
    return _peaks_cache
  from ..models.flops import peak_flops_per_device, peak_hbm_bytes_per_device
  on_card = torch.cuda.is_available()
  kind = torch.cuda.get_device_name(0) if on_card else 'cpu'
  flops = peak_flops_per_device(kind)
  bw = peak_hbm_bytes_per_device(kind)
  _peaks_cache = {
      'flops_per_sec': flops,
      'hbm_bytes_per_sec': bw,
      'balance': flops / bw if flops and bw else None,
      'device_kind': kind,
      'local_devices': 1,
  }
  return _peaks_cache


# ---------------------------------------------------------------------------
# the windowed verdict (host arithmetic, as the JAX package's)


def _counter_total(metrics, name):
  m = metrics.get(name)
  return m.get('total', 0) if m and m.get('kind') == 'counter' else 0


def _hist_sum(metrics, name):
  m = metrics.get(name)
  return m.get('sum', 0.0) if m and m.get('kind') == 'histogram' else 0.0


# An input-starved device is neither compute- nor memory-bound no matter
# what its arithmetic intensity says; same threshold the stage verdict
# uses for its loader-vs-compute call.
_INPUT_BOUND_WAIT_FRAC = 0.3


def roofline_verdict(merged, window_sec, peaks=None):
  """Bound-class verdict over a merged (windowed) metrics dict.

  ``merged`` is :func:`~.report.merge_metric_lines` output — pass the
  monitor window's delta for "right now", or a cumulative snapshot for
  run-mean. Reads the ``train.xla_flops`` / ``train.xla_bytes`` counters
  the compiled-step cache feeds and the data-wait/compute split, and
  compares against ``peaks`` (default: :func:`resolve_peaks`).

  Returns ``{'bound', 'detail', 'flops', 'bytes', 'flops_per_sec',
  'bytes_per_sec', 'flops_frac', 'bw_frac', 'arithmetic_intensity',
  'machine_balance', 'wait_frac', 'window_sec'}`` — fractions None when
  the corresponding peak is unknown; ``bound`` is ``'compute-bound'``,
  ``'memory-bound'``, ``'input-bound'``, or an ``'unknown (...)'``
  explanation when the window carries no cost deltas.
  """
  metrics = merged.get('metrics', {})
  flops = _counter_total(metrics, 'train.xla_flops')
  nbytes = _counter_total(metrics, 'train.xla_bytes')
  wait = _hist_sum(metrics, 'train.data_wait_seconds')
  compute = _hist_sum(metrics, 'train.compute_seconds')
  out = {
      'flops': flops, 'bytes': nbytes,
      'flops_per_sec': None, 'bytes_per_sec': None,
      'flops_frac': None, 'bw_frac': None,
      'arithmetic_intensity': None, 'machine_balance': None,
      'wait_frac': None, 'window_sec': window_sec,
  }
  if not flops or window_sec <= 0:
    out['bound'] = ('unknown (no compiled-step cost deltas in the window: '
                    "the port's step cache has no cost model)")
    out['detail'] = ''
    return out
  if peaks is None:
    peaks = resolve_peaks()
  peak_flops = peaks.get('flops_per_sec')
  peak_bw = peaks.get('hbm_bytes_per_sec')
  out['machine_balance'] = peaks.get('balance')
  out['flops_per_sec'] = flops / window_sec
  out['bytes_per_sec'] = nbytes / window_sec
  if nbytes:
    out['arithmetic_intensity'] = flops / nbytes
  if peak_flops:
    out['flops_frac'] = out['flops_per_sec'] / peak_flops
  if peak_bw:
    out['bw_frac'] = out['bytes_per_sec'] / peak_bw
  if wait or compute:
    out['wait_frac'] = wait / max(wait + compute, 1e-12)

  if out['wait_frac'] is not None and \
      out['wait_frac'] > _INPUT_BOUND_WAIT_FRAC:
    out['bound'] = 'input-bound'
    out['detail'] = (f'{100 * out["wait_frac"]:.0f}% of step time is data '
                     'wait; the device ceiling is not the limiter')
    return out
  ai, balance = out['arithmetic_intensity'], out['machine_balance']
  if ai is not None and balance is not None:
    if ai >= balance:
      out['bound'] = 'compute-bound'
      out['detail'] = (f'arithmetic intensity {ai:.0f} FLOPs/byte >= '
                       f'machine balance {balance:.0f}'
                       + (f'; {100 * out["flops_frac"]:.0f}% of peak FLOPs'
                          if out['flops_frac'] is not None else ''))
    else:
      out['bound'] = 'memory-bound'
      out['detail'] = (f'arithmetic intensity {ai:.0f} FLOPs/byte < '
                       f'machine balance {balance:.0f}'
                       + (f'; {100 * out["bw_frac"]:.0f}% of peak HBM '
                          'bandwidth'
                          if out['bw_frac'] is not None else ''))
    return out
  out['bound'] = ('unknown (chip peaks unresolved — set LDDL_PEAK_TFLOPS '
                  'and LDDL_PEAK_HBM_GBPS)')
  out['detail'] = ''
  return out


def bound_class(merged, window_sec, peaks=None):
  """Just the bound-class string (bench stamps, dashboards)."""
  return roofline_verdict(merged, window_sec, peaks=peaks)['bound']


# ---------------------------------------------------------------------------
# HBM telemetry (the CUDA caching allocator's statistics)

_hbm_supported = None  # None: not yet probed this process


def sample_hbm(telemetry=None):
  """Sample the card's memory into ``hbm.*`` gauges; returns the summary
  dict, or None without a CUDA card (probed once, then free).

  PyTorch's caching allocator takes device memory in segments and keeps
  them (CUDA graph pools included), so what limits the next allocation is
  the memory it *reserves*, not the bytes its live tensors hold. The keys
  are the JAX package's, summed over the visible cards:

    - ``bytes_in_use``: reserved now (``reserved_bytes.all.current``);
    - ``peak_bytes_in_use``: the high-water mark of the reserve
      (``reserved_bytes.all.peak``);
    - ``bytes_limit``: the card's total memory (``mem_get_info``);
    - ``headroom_frac``: the OOM-headroom meter, the least over the cards
      of ``1 - peak_bytes_in_use / bytes_limit``.

  Gauges are set only when telemetry is enabled.
  """
  global _hbm_supported
  if _hbm_supported is False:
    return None
  if not torch.cuda.is_available():
    _hbm_supported = False
    return None
  _hbm_supported = True
  totals = {'bytes_in_use': 0, 'peak_bytes_in_use': 0, 'bytes_limit': 0}
  headroom = math.inf
  n = torch.cuda.device_count()
  for i in range(n):
    stats = torch.cuda.memory_stats(i)
    peak = int(stats.get('reserved_bytes.all.peak', 0))
    limit = int(torch.cuda.mem_get_info(i)[1])
    totals['bytes_in_use'] += int(stats.get('reserved_bytes.all.current', 0))
    totals['peak_bytes_in_use'] += peak
    totals['bytes_limit'] += limit
    if limit:
      headroom = min(headroom, 1.0 - peak / limit)
  summary = dict(totals,
                 headroom_frac=headroom if math.isfinite(headroom) else None,
                 devices=n)
  if telemetry is None:
    from .metrics import get_telemetry
    telemetry = get_telemetry()
  if telemetry.enabled:
    telemetry.gauge('hbm.bytes_in_use').set(summary['bytes_in_use'])
    telemetry.gauge('hbm.peak_bytes_in_use').set(
        summary['peak_bytes_in_use'])
    telemetry.gauge('hbm.bytes_limit').set(summary['bytes_limit'])
    if summary['headroom_frac'] is not None:
      telemetry.gauge('hbm.headroom_frac').set(summary['headroom_frac'])
  return summary


def _reset_for_tests():
  """Clear the cached peak table and HBM support probe."""
  global _peaks_cache, _hbm_supported
  _peaks_cache = None
  _hbm_supported = None
