"""Counters, gauges, histograms and spans: the port's metric registry.

A copy of :mod:`lddl_tpu.telemetry.metrics` (stdlib only; the port keeps
its own copy and imports nothing of :mod:`lddl_tpu`), without the live
plane's ``diff_snapshot_lines``, which has no consumer in the port yet.

Disabled must cost ~nothing: with ``LDDL_TELEMETRY`` unset every metric
handle is a shared immutable singleton whose methods are empty. Enabled,
updates are plain attribute writes; histograms keep count / sum / min /
max plus power-of-two log buckets. A process exports its snapshot as
JSONL (``telemetry.rank<R>.jsonl``), in the JAX package's wire format.
:func:`enable` / :func:`disable` flip the registry for everything that
fetches its handles after the flip.
"""

import json
import math
import os
import tempfile
import threading
import time


class _NoopTimer:
  """Reusable no-op context manager (one shared instance, never mutated)."""

  __slots__ = ()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False


class _NoopMetric:
  """Counter/gauge/histogram stand-in whose every method is empty."""

  __slots__ = ()

  def add(self, n=1):
    pass

  def set(self, value):
    pass

  def observe(self, value):
    pass

  def time(self):
    return _NOOP_TIMER


_NOOP_TIMER = _NoopTimer()
_NOOP_METRIC = _NoopMetric()


class NoopTelemetry:
  """The disabled registry: hands out the shared no-op singletons."""

  __slots__ = ()
  enabled = False

  def counter(self, name):
    return _NOOP_METRIC

  def gauge(self, name):
    return _NOOP_METRIC

  def histogram(self, name):
    return _NOOP_METRIC

  def span(self, name):
    return _NOOP_TIMER

  def snapshot_lines(self, rank=0):
    return []

  def write_jsonl(self, path, rank=0):
    return None


NOOP = NoopTelemetry()


class Counter:
  """Monotonic event/volume counter."""

  __slots__ = ('total',)

  def __init__(self):
    self.total = 0

  def add(self, n=1):
    self.total += n

  def to_dict(self):
    return {'total': self.total}


class Gauge:
  """Last-value metric with min/max/sum/count for cross-rank merging."""

  __slots__ = ('value', 'min', 'max', 'sum', 'count')

  def __init__(self):
    self.value = None
    self.min = math.inf
    self.max = -math.inf
    self.sum = 0.0
    self.count = 0

  def set(self, value):
    v = float(value)
    self.value = v
    if v < self.min:
      self.min = v
    if v > self.max:
      self.max = v
    self.sum += v
    self.count += 1

  def to_dict(self):
    if self.count == 0:
      return {'value': None, 'count': 0}
    return {'value': self.value, 'min': self.min, 'max': self.max,
            'mean': self.sum / self.count, 'count': self.count}


class _SpanTimer:
  """Context manager that observes its monotonic wall time into ``hist``."""

  __slots__ = ('_hist', '_t0')

  def __init__(self, hist):
    self._hist = hist
    self._t0 = 0.0

  def __enter__(self):
    self._t0 = time.monotonic()
    return self

  def __exit__(self, *exc):
    self._hist.observe(time.monotonic() - self._t0)
    return False


class Histogram:
  """count/sum/min/max + power-of-two log buckets.

  Bucket ``e`` counts observations in ``[2**e, 2**(e+1))`` (e.g. for
  seconds, bucket -10 is ~1-2 ms). Exact zero / negative values land in
  a dedicated ``zero`` bucket so timing jitter can't produce a math
  domain error. Buckets merge across ranks by key-wise addition, so the
  merged percentile estimate is as good as any single rank's.
  """

  __slots__ = ('count', 'sum', 'min', 'max', 'buckets')

  def __init__(self):
    self.count = 0
    self.sum = 0.0
    self.min = math.inf
    self.max = -math.inf
    self.buckets = {}

  def observe(self, value):
    v = float(value)
    self.count += 1
    self.sum += v
    if v < self.min:
      self.min = v
    if v > self.max:
      self.max = v
    e = math.frexp(v)[1] - 1 if v > 0.0 else 'zero'
    b = self.buckets
    b[e] = b.get(e, 0) + 1

  def time(self):
    """A fresh span context manager feeding this histogram."""
    return _SpanTimer(self)

  def percentile(self, q):
    """Upper-bound estimate of the ``q``-quantile (0..1) from buckets."""
    if self.count == 0:
      return None
    target = q * self.count
    seen = 0
    numeric = sorted(k for k in self.buckets if k != 'zero')
    if 'zero' in self.buckets:
      seen += self.buckets['zero']
      if seen >= target:
        return 0.0
    for e in numeric:
      seen += self.buckets[e]
      if seen >= target:
        # The bucket upper bound can exceed every observed value (a
        # single 1.1s observation lands in [1, 2) but max is 1.1), so
        # never report a quantile above the observed max.
        return min(float(2.0 ** (e + 1)), self.max)
    return self.max

  def to_dict(self):
    if self.count == 0:
      return {'count': 0, 'sum': 0.0, 'buckets': {}}
    return {'count': self.count, 'sum': self.sum, 'min': self.min,
            'max': self.max,
            'buckets': {str(k): v for k, v in self.buckets.items()}}


_KINDS = {'counter': Counter, 'gauge': Gauge, 'histogram': Histogram}


class Telemetry:
  """An enabled metric registry (one per process)."""

  enabled = True

  def __init__(self):
    self._metrics = {}  # name -> (kind, metric)

  def _get(self, kind, name):
    entry = self._metrics.get(name)
    if entry is None:
      entry = (kind, _KINDS[kind]())
      self._metrics[name] = entry
    elif entry[0] != kind:
      raise ValueError(
          f'metric {name!r} already registered as {entry[0]}, not {kind}')
    return entry[1]

  def counter(self, name):
    return self._get('counter', name)

  def gauge(self, name):
    return self._get('gauge', name)

  def histogram(self, name):
    return self._get('histogram', name)

  def span(self, name):
    """Context manager timing one occurrence into histogram ``name``."""
    return self._get('histogram', name).time()

  def snapshot_lines(self, rank=0):
    """One JSON-able dict per metric (the JSONL wire format)."""
    # unix_time and monotonic are sampled together: the pair anchors
    # this process's monotonic clock on the unix timeline so trace and
    # metric snapshots from different ranks can be cross-aligned.
    lines = [{'kind': 'meta', 'rank': rank, 'pid': os.getpid(),
              'unix_time': time.time(), 'monotonic': time.monotonic()}]
    for name in sorted(self._metrics):
      kind, metric = self._metrics[name]
      line = {'kind': kind, 'rank': rank, 'name': name}
      line.update(metric.to_dict())
      lines.append(line)
    return lines

  def write_jsonl(self, path, rank=0):
    """Atomically write this process's snapshot as JSONL to ``path``."""
    payload = '\n'.join(
        json.dumps(line) for line in self.snapshot_lines(rank)) + '\n'
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    # mkstemp (not a pid-suffixed name): two threads of one process
    # exporting concurrently must not clobber each other's tmp file.
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + '.tmp.')
    with os.fdopen(fd, 'w') as f:
      f.write(payload)
      # fsync before the rename: os.replace is atomic for the *name*,
      # but a machine crash between rename and writeback can land the
      # new name on truncated content. Durable-then-visible instead.
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def rank_file_name(directory, rank):
  """Canonical per-rank export path (what ``telemetry-report`` globs)."""
  return os.path.join(directory, f'telemetry.rank{rank}.jsonl')


_ENV = 'LDDL_TELEMETRY'
_active = None  # None: not yet resolved from the environment
# First resolution can race: writer threads fetch counters lazily while
# the main loop resolves the registry. The lock makes install atomic.
_active_lock = threading.Lock()


def get_telemetry():
  """The process-global registry: :class:`Telemetry` when enabled (env
  ``LDDL_TELEMETRY`` truthy or :func:`enable` called), else the shared
  :data:`NOOP` singleton."""
  global _active
  with _active_lock:
    if _active is None:
      spec = os.environ.get(_ENV, '').strip().lower()
      _active = Telemetry() if spec in ('1', 'true', 'on', 'yes') else NOOP
    return _active


def enable():
  """Switch telemetry on (fresh registry unless already enabled)."""
  global _active
  with _active_lock:
    if _active is None or not _active.enabled:
      _active = Telemetry()
    return _active


def disable():
  """Switch telemetry off (instrument sites see :data:`NOOP` again)."""
  global _active
  with _active_lock:
    _active = NOOP
    return _active
