"""Event-level execution tracing: a bounded ring buffer -> Perfetto.

A copy of :mod:`lddl_tpu.telemetry.trace` (stdlib only), with its
``telemetry-trace`` command line: ``python -m
lddl_tpu_torch.telemetry.trace --dir <dir> [-o out.json]`` merges every
``trace.rank*.jsonl`` under ``dir`` (:func:`load_trace_files` +
:func:`merge_trace_files`, with the stage verdict of the
``telemetry.rank*.jsonl`` files beside them when there are any) into one
Chrome-trace JSON for Perfetto; a directory without trace files exits 2.

With ``LDDL_TRACE`` unset :func:`get_tracer` hands out the shared
:data:`NOOP_TRACER`, whose every method is empty. Enabled, events append
to a ``deque(maxlen=LDDL_TRACE_BUFFER)`` (default 65536) and, when
``LDDL_TELEMETRY_DIR`` is set, flush every ``LDDL_TRACE_FLUSH_SEC``
seconds to ``trace.rank<R>[.pid<P>].jsonl``, so a killed process leaves
a readable tail. Timestamps are ``time.monotonic()`` seconds; each file's
meta line carries a ``(anchor_unix, anchor_monotonic)`` pair that places
it on the unix timeline, and the merge refines per-rank offsets from
matched collective events (``comm.allgather``/``comm.barrier`` with a
``seq``), as the JAX package's does.
"""

import collections
import glob
import json
import os
import statistics
import sys
import tempfile
import threading
import time


class _NoopSpan:
  """Reusable no-op context manager (one shared instance, never mutated)."""

  __slots__ = ()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
  """The disabled recorder: every method is empty, every handle shared."""

  __slots__ = ()
  enabled = False

  def set_identity(self, rank=None, per_pid=None):
    pass

  def reset(self, rank=None, per_pid=None):
    pass

  def span(self, name, args=None):
    return _NOOP_SPAN

  def complete(self, name, start, duration, tid=None, args=None):
    pass

  def instant(self, name, args=None):
    pass

  def counter(self, name, value):
    pass

  def event_dicts(self):
    return []

  def flush(self, directory=None):
    return None

  def write_jsonl(self, path, rank=None):
    return None


NOOP_TRACER = NoopTracer()


class _Span:
  """Context manager recording one complete ('X') event into ``tracer``."""

  __slots__ = ('_tracer', '_name', '_args', '_t0')

  def __init__(self, tracer, name, args):
    self._tracer = tracer
    self._name = name
    self._args = args
    self._t0 = 0.0

  def __enter__(self):
    self._t0 = time.monotonic()
    return self

  def __exit__(self, *exc):
    self._tracer.complete(self._name, self._t0,
                          time.monotonic() - self._t0, args=self._args)
    return False


_DEFAULT_MAX_EVENTS = 65536
# Auto-flush clock check is amortized over this many events so the
# per-event record cost stays one deque append + one int increment.
_FLUSH_CHECK_EVERY = 64


class Tracer:
  """An enabled trace recorder (one per process).

  Events are stored as tuples ``(ph, name, ts, dur, tid, args)`` with
  ``ts``/``dur`` in monotonic seconds; ``tid`` is the recording thread's
  ident unless the caller supplies one (the pipeline executor passes the
  pool worker's pid so pooled task spans land on per-worker lanes).
  """

  enabled = True

  def __init__(self, max_events=None, rank=None, flush_interval=None):
    if max_events is None:
      max_events = int(os.environ.get('LDDL_TRACE_BUFFER',
                                      _DEFAULT_MAX_EVENTS))
    self._events = collections.deque(maxlen=max_events)
    self.anchor_unix = time.time()
    self.anchor_monotonic = time.monotonic()
    self.main_thread = threading.get_ident()
    self.rank = (rank if rank is not None
                 else int(os.environ.get('LDDL_RANK', '0') or 0))
    self.per_pid = False
    if flush_interval is None:
      flush_interval = float(os.environ.get('LDDL_TRACE_FLUSH_SEC', '5'))
    self._flush_interval = flush_interval
    self._last_flush = time.monotonic()
    self._since_check = 0

  def set_identity(self, rank=None, per_pid=None):
    """Set the rank (and per-pid file suffixing) used by auto-flush."""
    if rank is not None:
      self.rank = rank
    if per_pid is not None:
      self.per_pid = per_pid

  def reset(self, rank=None, per_pid=None):
    """Fresh buffer + anchor: called by child processes (loader
    workers) that inherited the parent's recorder, so the child's file
    holds only its own events under its own anchor."""
    self._events.clear()
    self.anchor_unix = time.time()
    self.anchor_monotonic = time.monotonic()
    self.main_thread = threading.get_ident()
    self._last_flush = time.monotonic()
    self._since_check = 0
    self.set_identity(rank=rank, per_pid=per_pid)

  # ---- recording ----

  def span(self, name, args=None):
    """Context manager recording one complete event for its wall time."""
    return _Span(self, name, args)

  def complete(self, name, start, duration, tid=None, args=None):
    """A 'X' event with explicit monotonic ``start`` and ``duration``."""
    self._record(('X', name, start, duration,
                  threading.get_ident() if tid is None else tid, args))

  def instant(self, name, args=None):
    self._record(('i', name, time.monotonic(), None,
                  threading.get_ident(), args))

  def counter(self, name, value):
    """A counter-track sample ('C'): queue depth, samples/s, ..."""
    self._record(('C', name, time.monotonic(), None, 0, float(value)))

  def _record(self, ev):
    self._events.append(ev)  # GIL-atomic; maxlen bounds memory
    self._since_check += 1
    if self._since_check >= _FLUSH_CHECK_EVERY:
      self._since_check = 0
      if time.monotonic() - self._last_flush >= self._flush_interval:
        self.flush()

  # ---- export ----

  def event_dicts(self):
    """The buffer as JSON-able dicts (the JSONL wire format)."""
    # deque appends from other threads (the prefetch producer records
    # h2d spans) can race iteration; retry on the rare mid-mutation.
    for _ in range(8):
      try:
        events = list(self._events)
        break
      except RuntimeError:
        continue
    else:
      events = []
    out = []
    for ph, name, ts, dur, tid, args in events:
      d = {'ph': ph, 'name': name, 'ts': ts, 'tid': tid}
      if dur is not None:
        d['dur'] = dur
      if ph == 'C':
        d['value'] = args
      elif args:
        d['args'] = args
      out.append(d)
    return out

  def meta_line(self, rank=None):
    return {'kind': 'meta', 'rank': self.rank if rank is None else rank,
            'pid': os.getpid(), 'main_thread': self.main_thread,
            'unix_time': time.time(), 'monotonic': time.monotonic(),
            'anchor_unix': self.anchor_unix,
            'anchor_monotonic': self.anchor_monotonic,
            'clock': 'monotonic_seconds'}

  def flush(self, directory=None):
    """Write the current buffer under ``LDDL_TELEMETRY_DIR`` (or
    ``directory``) at this process's canonical path; no-op without a
    destination. Called opportunistically from the record path so
    crashed processes leave a usable tail."""
    self._last_flush = time.monotonic()
    directory = directory or os.environ.get('LDDL_TELEMETRY_DIR')
    if not directory:
      return None
    return self.write_jsonl(trace_file_name(
        directory, self.rank, pid=os.getpid() if self.per_pid else None))

  def write_jsonl(self, path, rank=None):
    """Atomically write meta line + events as JSONL to ``path``."""
    lines = [self.meta_line(rank)] + self.event_dicts()
    payload = '\n'.join(json.dumps(line) for line in lines) + '\n'
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + '.tmp.')
    with os.fdopen(fd, 'w') as f:
      f.write(payload)
      # Durable-then-visible (same as MetricsRegistry.write_jsonl): the
      # rename must never make a name point at unwritten-back content.
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, path)
    self._last_flush = time.monotonic()
    return path


def trace_file_name(directory, rank, pid=None):
  """Canonical per-process export path (what ``telemetry-trace`` globs):
  ``trace.rank<R>.jsonl`` for the rank's main process,
  ``trace.rank<R>.pid<P>.jsonl`` for its loader workers."""
  if pid is None:
    return os.path.join(directory, f'trace.rank{rank}.jsonl')
  return os.path.join(directory, f'trace.rank{rank}.pid{pid}.jsonl')


_ENV = 'LDDL_TRACE'
_active = None  # None: not yet resolved from the environment


def get_tracer():
  """The process-global recorder: :class:`Tracer` when enabled (env
  ``LDDL_TRACE`` truthy or :func:`enable_trace` called), else the shared
  :data:`NOOP_TRACER` singleton."""
  global _active
  if _active is None:
    spec = os.environ.get(_ENV, '').strip().lower()
    _active = Tracer() if spec in ('1', 'true', 'on', 'yes') else NOOP_TRACER
  return _active


def enable_trace(**kwargs):
  """Switch tracing on (fresh recorder unless already enabled)."""
  global _active
  if _active is None or not _active.enabled:
    _active = Tracer(**kwargs)
  return _active


def disable_trace():
  """Switch tracing off (instrument sites see :data:`NOOP_TRACER`)."""
  global _active
  _active = NOOP_TRACER
  return _active


# ---- cross-rank merge -> Chrome trace format ----

# Collective completions used for clock refinement: every rank finishes
# collective #seq within one collective latency of the others.
_ALIGN_NAMES = ('comm.allgather', 'comm.barrier')


def load_trace_files(directory):
  """Parse every ``trace.rank*.jsonl`` under ``directory``; returns a
  list of ``(meta, events)`` pairs (one per file)."""
  paths = sorted(glob.glob(os.path.join(directory, 'trace.rank*.jsonl')))
  if not paths:
    raise FileNotFoundError(
        f'no trace.rank*.jsonl files under {directory} '
        '(run with LDDL_TRACE=1 and LDDL_TELEMETRY_DIR set)')
  out = []
  for p in paths:
    meta, events = None, []
    with open(p) as f:
      for ln, line in enumerate(f, start=1):
        if not line.strip():
          continue
        try:
          d = json.loads(line)
        except ValueError:
          # A SIGKILLed writer can leave a torn trailing line; the rest
          # of the file is intact and far more useful than an abort.
          print(f'telemetry-trace: skipping unparseable line {ln} of '
                f'{p} (truncated write?)', file=sys.stderr)
          continue
        if d.get('kind') == 'meta':
          meta = d
        else:
          events.append(d)
    if meta is None:  # tolerate a truncated crash tail with no meta
      meta = {'rank': 0, 'pid': 0, 'anchor_unix': 0.0,
              'anchor_monotonic': 0.0}
    out.append((meta, events))
  return out


def _anchor_offset(meta):
  """Seconds to add to a file's monotonic timestamps to land on its own
  host's unix timeline."""
  return meta.get('anchor_unix', 0.0) - meta.get('anchor_monotonic', 0.0)


def compute_rank_offsets(files):
  """Per-rank clock corrections (seconds) refined from matched
  collective events.

  Anchors place every file on its host's unix timeline, but hosts'
  unix clocks can disagree by far more than a collective latency. All
  ranks complete collective ``#seq`` within one collective latency of
  each other, so for each non-reference rank the median of
  ``t_ref(seq) - t_rank(seq)`` over matched completions estimates that
  rank's residual clock skew. Returns ``{rank: correction}`` to *add*
  to anchor-aligned times (reference rank = lowest rank; missing or
  unmatched ranks get no correction).
  """
  by_rank = {}
  for meta, events in files:
    r = meta.get('rank', 0)
    off = _anchor_offset(meta)
    for ev in events:
      args = ev.get('args') or {}
      if ev.get('name') in _ALIGN_NAMES and args.get('seq') is not None:
        key = (ev['name'], args['seq'])
        by_rank.setdefault(r, {})[key] = (
            ev.get('ts', 0.0) + (ev.get('dur') or 0.0) + off)
  ranks = sorted(by_rank)
  if not ranks:
    return {}
  ref = by_rank[ranks[0]]
  corrections = {}
  for r in ranks[1:]:
    deltas = [ref[k] - t for k, t in by_rank[r].items() if k in ref]
    if deltas:
      corrections[r] = statistics.median(deltas)
  return corrections


def merge_trace_files(files, verdict=None):
  """Merge per-process trace files into one Chrome-trace JSON object.

  Lanes: rank -> Chrome ``pid`` (one process row per rank), each
  recording (process, thread) pair -> a compact ``tid`` lane within it.
  Counter events ('C') render as per-rank counter tracks. ``verdict``
  (a :func:`lddl_tpu.telemetry.report.summarize_stages` dict) is
  embedded under ``metadata.lddl.bottleneck``.
  """
  corrections = compute_rank_offsets(files)
  aligned = []  # (rank, file_pid, main_thread, event, unix_time)
  for meta, events in files:
    r = meta.get('rank', 0)
    off = _anchor_offset(meta) + corrections.get(r, 0.0)
    mt = meta.get('main_thread')
    fpid = meta.get('pid', 0)
    for ev in events:
      aligned.append((r, fpid, mt, ev, ev.get('ts', 0.0) + off))
  t0 = min((t for *_, t in aligned), default=0.0)
  ranks = sorted({meta.get('rank', 0) for meta, _ in files})

  out = []
  for r in ranks:
    out.append({'ph': 'M', 'name': 'process_name', 'pid': r, 'tid': 0,
                'ts': 0, 'args': {'name': f'rank {r}'}})
    out.append({'ph': 'M', 'name': 'process_sort_index', 'pid': r, 'tid': 0,
                'ts': 0, 'args': {'sort_index': r}})

  lanes = {}  # (rank, file_pid, raw_tid) -> (compact tid, label)

  def lane(r, fpid, mt, raw_tid):
    key = (r, fpid, raw_tid)
    entry = lanes.get(key)
    if entry is None:
      label = (f'pid {fpid}' if raw_tid == mt
               else f'pid {fpid} t{raw_tid}')
      entry = (len(lanes) + 1, label)
      lanes[key] = entry
    return entry[0]

  for r, fpid, mt, ev, t in aligned:
    ph = ev.get('ph')
    ts_us = (t - t0) * 1e6
    if ph == 'C':
      out.append({'ph': 'C', 'name': ev['name'], 'pid': r, 'tid': 0,
                  'ts': ts_us, 'args': {'value': ev.get('value', 0.0)}})
      continue
    d = {'ph': ph, 'name': ev['name'],
         'cat': ev['name'].split('.', 1)[0], 'pid': r,
         'tid': lane(r, fpid, mt, ev.get('tid', 0)), 'ts': ts_us}
    if ph == 'X':
      d['dur'] = (ev.get('dur') or 0.0) * 1e6
    elif ph == 'i':
      d['s'] = 't'  # thread-scoped instant
    if ev.get('args'):
      d['args'] = ev['args']
    out.append(d)

  for (r, fpid, _raw), (tid, label) in lanes.items():
    out.append({'ph': 'M', 'name': 'thread_name', 'pid': r, 'tid': tid,
                'ts': 0, 'args': {'name': label}})
  out.sort(key=lambda e: (e.get('ts', 0), e['pid'], e['tid']))

  meta_out = {'ranks': ranks,
              'clock_corrections': {str(k): v
                                    for k, v in corrections.items()},
              'trace_time_origin_unix': t0}
  if verdict is not None:
    meta_out['bottleneck'] = verdict
  return {'traceEvents': out, 'displayTimeUnit': 'ms',
          'metadata': {'lddl': meta_out}}


def attach_args(parser):
  parser.add_argument('--dir', required=True,
                      help='directory holding trace.rank*.jsonl files '
                           '(and optionally telemetry.rank*.jsonl for '
                           'the embedded bottleneck verdict)')
  parser.add_argument('--output', '-o', default=None,
                      help='output path for the merged Chrome-trace '
                           'JSON (default <dir>/trace.merged.json)')
  return parser


def main(args=None):
  import argparse
  parser = attach_args(argparse.ArgumentParser(
      prog='python -m lddl_tpu_torch.telemetry.trace',
      description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter))
  args = parser.parse_args(args)
  try:
    files = load_trace_files(args.dir)
  except FileNotFoundError as e:
    # Same contract as the report: one clear line, exit code 2.
    print(f'telemetry-trace: {e}', file=sys.stderr)
    return 2
  verdict = None
  try:  # metrics snapshots are optional company for the trace files
    from .report import load_rank_files, merge_metric_lines, summarize_stages
    verdict = summarize_stages(merge_metric_lines(load_rank_files(args.dir)))
  except FileNotFoundError:
    pass
  doc = merge_trace_files(files, verdict=verdict)
  out = args.output or os.path.join(args.dir, 'trace.merged.json')
  with open(out, 'w') as f:
    json.dump(doc, f)
  print(f'wrote {out}: {len(doc["traceEvents"])} events from '
        f'{len(files)} process file(s), ranks '
        f'{doc["metadata"]["lddl"]["ranks"]} — load in '
        'https://ui.perfetto.dev or chrome://tracing')
  return 0


if __name__ == '__main__':
  sys.exit(main())
