"""Telemetry of the port: metrics, trace, roofline, profiler, sentinels.

Copies of the parts of :mod:`lddl_tpu.telemetry` that the train loop
uses, with the same names, environment switches and file formats:

  - :mod:`.metrics` (``LDDL_TELEMETRY``): counters, gauges, histograms;
    ``telemetry.rank<R>.jsonl`` snapshots;
  - :mod:`.trace` (``LDDL_TRACE``): the bounded event ring buffer,
    ``trace.rank<R>.jsonl`` and the Chrome-trace merge;
  - :mod:`.roofline`: card peaks, the roofline verdict, ``hbm.*`` gauges
    from the CUDA caching allocator;
  - :mod:`.profiling`: ``torch.profiler`` captures of N train steps;
  - :mod:`.sentinel` (``LDDL_SENTINEL``): streaming anomaly detectors;
  - :mod:`.perf`: the robust statistics the sentinel judges with.

Everything is a no-op singleton when its switch is off. The JAX package's
live monitor, report, ledger and audit are not ported yet.
"""

from .metrics import (
    NOOP,
    NoopTelemetry,
    Telemetry,
    disable,
    enable,
    get_telemetry,
    rank_file_name,
)
from .roofline import (
    resolve_peaks,
    roofline_verdict,
    sample_hbm,
)
from .profiling import (
    StepProfiler,
    get_step_profiler,
    trace_capture,
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
