"""On-demand ``torch.profiler`` capture of train steps.

The port's counterpart of :mod:`lddl_tpu.telemetry.profiling`, over
``torch.profiler`` instead of ``jax.profiler``:

  - :func:`trace_capture`: a context manager around one profiled region;
    no-op when the directory is falsy, so callers never branch;
  - :class:`StepProfiler`: :meth:`~StepProfiler.arm` requests a capture
    of the next N train steps, and the train loop's per-step
    :meth:`~StepProfiler.on_step` starts the profiler at the next step
    boundary and stops it N steps later. Each capture writes one Chrome
    trace, ``capture<NNNN>/trace.json`` under :func:`default_profile_dir`
    (load it in https://ui.perfetto.dev or ``chrome://tracing``).

The JAX package arms its profiler from the monitor's ``/profile``
endpoint; the port has no HTTP monitor yet, so a caller arms it through
the API (``get_step_profiler().arm(steps)``). Unarmed, ``on_step`` reads
two attributes and returns.

Both record the CPU and, where there is a card, CUDA activity; kernels
launched by a CUDA graph replay show in the trace as the graph's
kernels.
"""

import contextlib
import os
import threading

_TRACE_FILE = 'trace.json'


def _activities():
  import torch
  from torch.profiler import ProfilerActivity
  acts = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(ProfilerActivity.CUDA)
  return acts


def _start():
  from torch.profiler import profile
  prof = profile(activities=_activities())
  prof.start()
  return prof


def _stop(prof, trace_dir):
  """Stop ``prof`` and write its Chrome trace into ``trace_dir``."""
  import torch
  if torch.cuda.is_available():
    torch.cuda.synchronize()
  prof.stop()
  os.makedirs(trace_dir, exist_ok=True)
  prof.export_chrome_trace(os.path.join(trace_dir, _TRACE_FILE))


@contextlib.contextmanager
def trace_capture(trace_dir):
  """Profile the enclosed region into ``trace_dir/trace.json``. Falsy
  ``trace_dir`` -> no-op, zero overhead."""
  if not trace_dir:
    yield None
    return
  prof = _start()
  try:
    yield trace_dir
  finally:
    _stop(prof, trace_dir)


def default_profile_dir():
  """Where step captures go: ``$LDDL_TELEMETRY_DIR/profiles`` (cwd-
  relative ``lddl_profiles/`` when the telemetry dir is unset)."""
  base = os.environ.get('LDDL_TELEMETRY_DIR')
  return os.path.join(base, 'profiles') if base else 'lddl_profiles'


class StepProfiler:
  """Arms ``torch.profiler`` for the next N train steps.

  The unarmed hot path reads two attributes and returns, with no lock;
  the armed transitions take ``_lock`` so an arm from another thread
  racing a step boundary cannot start two profilers.
  """

  def __init__(self):
    self._lock = threading.Lock()
    self._armed_steps = 0      # steps requested, not yet started
    self._active_steps = 0     # steps remaining in a running capture
    self._out_dir = None
    self._capture_index = 0
    self._prof = None
    self.last_trace_dir = None

  def arm(self, steps, out_dir=None):
    """Request a capture of the next ``steps`` train steps; returns the
    directory the capture directories land in. Re-arming while armed or
    active replaces the pending request (it does not extend a running
    capture)."""
    steps = max(1, int(steps))
    with self._lock:
      self._out_dir = out_dir or default_profile_dir()
      self._armed_steps = steps
      return self._out_dir

  def on_step(self):
    """Call once per train step, at the step boundary. Returns the trace
    directory when this call *finished* a capture, else None."""
    if not self._armed_steps and not self._active_steps:
      return None
    with self._lock:
      if self._armed_steps and not self._active_steps:
        n = self._capture_index
        self._capture_index += 1
        self.last_trace_dir = os.path.join(
            self._out_dir or default_profile_dir(), f'capture{n:04d}')
        self._prof = _start()
        self._active_steps = self._armed_steps
        self._armed_steps = 0
        return None
      if self._active_steps:
        self._active_steps -= 1
        if self._active_steps == 0:
          prof, self._prof = self._prof, None
          _stop(prof, self.last_trace_dir)
          return self.last_trace_dir
      return None

  def close(self):
    """Stop any capture in flight (train-loop teardown) and write what it
    recorded; idempotent."""
    with self._lock:
      self._armed_steps = 0
      self._active_steps = 0
      prof, self._prof = self._prof, None
      if prof is not None:
        _stop(prof, self.last_trace_dir)

  @property
  def armed(self):
    return bool(self._armed_steps or self._active_steps)


_profiler = None
_profiler_lock = threading.Lock()


def get_step_profiler():
  """The process-wide :class:`StepProfiler` (created on first use; plain
  state, no threads)."""
  global _profiler
  if _profiler is None:
    with _profiler_lock:
      if _profiler is None:
        _profiler = StepProfiler()
  return _profiler


def _reset_for_tests():
  global _profiler
  if _profiler is not None:
    _profiler.close()
  _profiler = None
