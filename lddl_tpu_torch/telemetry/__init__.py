"""Telemetry of the port: metrics, trace, ledger, roofline, profiler,
sentinels.

Copies of the parts of :mod:`lddl_tpu.telemetry` that the train loop
and the loaders use, with the same names, environment switches and file
formats:

  - :mod:`.metrics` (``LDDL_TELEMETRY``): counters, gauges, histograms;
    ``telemetry.rank<R>.jsonl`` snapshots;
  - :mod:`.trace` (``LDDL_TRACE``): the bounded event ring buffer,
    ``trace.rank<R>.jsonl`` and the Chrome-trace merge;
  - :mod:`.ledger` (``LDDL_LEDGER``): the determinism ledger's
    ``collate``, ``device``, ``serve.*`` and ``step`` records,
    ``ledger.rank<R>.jsonl`` (replayed by :mod:`lddl_tpu_torch.replay`);
  - :mod:`.audit`: its offline auditor, ``python -m
    lddl_tpu_torch.telemetry.audit``;
  - :mod:`.roofline`: step costs, card peaks, the roofline verdict,
    ``hbm.*`` gauges from the CUDA caching allocator;
  - :mod:`.step_costs`: the step cost model, the FLOPs and operand bytes
    of a step counted op by op (the counterpart of XLA's cost analysis);
  - :mod:`.profiling`: ``torch.profiler`` captures of N train steps;
  - :mod:`.sentinel` (``LDDL_SENTINEL``): streaming anomaly detectors;
  - :mod:`.perf`: the robust statistics the sentinel judges with;
  - :mod:`.live` + :mod:`.server` (``LDDL_MONITOR``): windowed deltas,
    the live verdict, straggler and goodput signals, and the per-process
    HTTP endpoint (``/snapshot``, ``/metrics``, ``/healthz``,
    ``/profile``); :mod:`.monitor` is its terminal dashboard, ``python
    -m lddl_tpu_torch.telemetry.monitor``;
  - :mod:`.report`: the cross-rank merge and its CLI.

Everything is a no-op singleton when its switch is off. The roofline and
profiler exports import torch, so they load lazily on first access (as
the JAX package keeps its device exports lazy): the loader's worker
processes import this package for metrics, trace and ledger only, and
never pay for torch. The live plane's exports load lazily as well, so a
worker never imports the HTTP server.
"""

from .ledger import (
    NOOP_LEDGER,
    Ledger,
    NoopLedger,
    compare_signals,
    determinism_verdict,
    disable_ledger,
    divergence_over_comm,
    enable_ledger,
    fingerprint_batch,
    fingerprint_bytes,
    fingerprint_file,
    fingerprint_packed,
    get_ledger,
    ledger_file_name,
)
from .metrics import (
    NOOP,
    NoopTelemetry,
    Telemetry,
    diff_snapshot_lines,
    disable,
    enable,
    get_telemetry,
    rank_file_name,
)
from .trace import (
    NOOP_TRACER,
    NoopTracer,
    Tracer,
    disable_trace,
    enable_trace,
    get_tracer,
    load_trace_files,
    merge_trace_files,
    trace_file_name,
)

_LAZY = {
    'SnapshotWindow': 'live',
    'goodput_meters': 'live',
    'live_status': 'live',
    'live_verdict': 'live',
    'rank_signals': 'live',
    'stage_rates': 'live',
    'straggler_over_comm': 'live',
    'straggler_scores': 'live',
    'NOOP_MONITOR': 'server',
    'MonitorServer': 'server',
    'NoopMonitor': 'server',
    'get_monitor': 'server',
    'maybe_start_monitor': 'server',
    'prometheus_lines': 'server',
    'stop_monitor': 'server',
    'aggregate_over_comm': 'report',
    'load_rank_files': 'report',
    'merge_metric_lines': 'report',
    'render_report': 'report',
    'compiled_step_costs': 'roofline',
    'resolve_peaks': 'roofline',
    'roofline_verdict': 'roofline',
    'sample_hbm': 'roofline',
    'StepProfiler': 'profiling',
    'get_step_profiler': 'profiling',
    'trace_capture': 'profiling',
}


def __getattr__(name):
  module = _LAZY.get(name)
  if module is None:
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
  import importlib
  return getattr(importlib.import_module(f'.{module}', __name__), name)
