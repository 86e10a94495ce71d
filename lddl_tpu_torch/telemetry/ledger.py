"""Streaming determinism ledger: content fingerprints at pipeline
boundaries.

A copy of :mod:`lddl_tpu.telemetry.ledger` (numpy and the stdlib; the
port keeps its own copy and imports nothing of :mod:`lddl_tpu`). The
loaders promise batches byte-identical to the serial ones whatever the
worker count, transport or resume point; this module turns the promise
into a runtime fact: cheap content fingerprints computed at each
pipeline boundary and appended to a per-rank, crash-durable
``ledger.rank<R>.jsonl`` under ``LDDL_TELEMETRY_DIR``, so any two runs
(or any two ranks) can be diffed after the fact
(``python -m lddl_tpu_torch.telemetry.audit``, :mod:`.audit`). The file
format is the JAX package's, line for line, and either package's
auditor reads the other's files.

Instrumented boundaries in the port and their coordinate keys:

  ``collate``    loader batch, consumption
                 order (parent side)           key: ``(epoch, index)``
  ``device``     host batch entering the
                 device feed, before the       key: ``(epoch, index)``
                 pinned copy                   (the train loop, the step
                                               replay), else ``index``
  ``serve.tx`` / data-service frames, sent
  ``serve.rx``   and received                  key: ``(epoch, gi)``
  ``step``       full train state at every
                 checkpoint (:func:`~lddl_tpu_torch.training.pretrain.
                 state_fingerprint`)           key: ``step``

The JAX package's ``shard`` boundary (its preprocessing) is not recorded
by the port, which reads shards ``lddl_tpu`` wrote. ``step`` digests do
not compare across the frameworks (the arithmetic differs); the lines'
keys and fields do.
:func:`divergence_over_comm`, the live cross-rank exchange, computes
:func:`compare_signals`' verdict over the port's comm backend.

Fingerprints are representation-independent: :func:`fingerprint_batch`
walks a live batch object (dicts / sequences / ndarrays) and
:func:`fingerprint_packed` walks a packed ``_pack_into`` spec over its
buffer, feeding the hash identical bytes (structure tags, dtype, shape,
raw C-order array bytes) — so the worker's shm slot and a plain
in-process batch of equal content produce the same digest. The hash is
xxh64 when the ``xxhash`` wheel is importable, else stdlib ``blake2b``
(8-byte digest); the ledger meta line records which, and the auditor
refuses to compare mixed-algorithm ledgers. :func:`fingerprint_batch`
and :func:`fingerprint_packed` also take the algorithm by name
(``algo=``), so the replay verifies a ledger in the algorithm its meta
line names: blake2b-8 on any host, xxh64 where the wheel is installed.
Never builtin ``hash()``: it is salted per interpreter
(``PYTHONHASHSEED``).

Discipline mirrors :mod:`.metrics` / :mod:`.trace`:

1. **Disabled must cost ~nothing.** With ``LDDL_LEDGER`` unset
   (default) :func:`get_ledger` hands out the shared
   :data:`NOOP_LEDGER` singleton — zero threads, zero files, empty
   methods; instrument sites guard fingerprint computation behind
   ``ledger.enabled`` so disabled runs never hash a byte.
2. **Enabled stays cheap.** One lock, one hand-assembled JSON line,
   one ``os.write`` to an ``O_APPEND`` fd per record.
3. **Crash-durable.** Every record reaches the kernel before
   ``record()`` returns (a SIGKILLed process loses nothing already
   recorded); ``LDDL_LEDGER_FSYNC=N`` additionally fsyncs every N
   records for machine-crash durability, and :meth:`Ledger.flush`
   always fsyncs.

Per boundary the ledger also maintains a rolling digest
(``roll_n = H(roll_{n-1} || digest_n)``) plus a bounded window of
recent ``(key, digest)`` pairs (``LDDL_LEDGER_WINDOW``, default 64).
Cross-rank comparison only applies to boundaries that are replicated
across ranks by contract (``LDDL_LEDGER_REPLICATED``, default ``step``).
"""

import collections
import hashlib
import json
import os
import threading
import time

import numpy as np

from .metrics import get_telemetry

try:
  import xxhash as _xxhash
except ImportError:  # no new deps: blake2b is stdlib and always present
  _xxhash = None

#: Name of the digest algorithm in use, recorded in every ledger meta
#: line; the auditor refuses to diff ledgers with mismatched algorithms.
ALGO = 'xxh64' if _xxhash is not None else 'blake2b8'

#: Coordinate fields that key a record for cross-run alignment, in
#: significance order; any other keyword to ``record()`` (``samples``,
#: ``loss``…) rides along as context without affecting alignment.
KEY_FIELDS = ('epoch', 'index', 'gi', 'step', 'path')


#: The digest algorithms a ledger's meta line may name.
ALGOS = ('xxh64', 'blake2b8')


def algo_available(algo):
  """Whether this process can hash in ``algo`` (a name in :data:`ALGOS`)."""
  return algo == 'blake2b8' or (algo == 'xxh64' and _xxhash is not None)


def _hasher(algo=None):
  """A fresh hasher in ``algo``; None is this process's own (:data:`ALGO`).
  Raises ``ValueError`` for an algorithm this process cannot compute."""
  if algo is None:
    algo = 'xxh64' if _xxhash is not None else 'blake2b8'
  if not algo_available(algo):
    raise ValueError(
        f'cannot hash in {algo!r} here (known: {", ".join(ALGOS)}; xxh64 '
        'needs the xxhash wheel)')
  if algo == 'xxh64':
    return _xxhash.xxh64()
  return hashlib.blake2b(digest_size=8)


def fingerprint_bytes(*chunks):
  """Hex digest over raw byte chunks (buffer-protocol objects)."""
  h = _hasher()
  for c in chunks:
    h.update(c)
  return h.hexdigest()


def fingerprint_file(path, chunk_bytes=1 << 20):
  """Streaming hex digest of a file's exact bytes (the shard boundary:
  what a resumed run would re-read from disk)."""
  h = _hasher()
  with open(path, 'rb') as f:
    for chunk in iter(lambda: f.read(chunk_bytes), b''):
      h.update(chunk)
  return h.hexdigest()


def _feed_batch(h, obj):
  """Feed ``obj`` to hasher ``h`` in the canonical structure walk.

  Must stay in lockstep with :func:`_feed_packed`: both reduce a batch
  to the same byte stream, whichever representation it arrives in.
  """
  if isinstance(obj, np.ndarray):
    h.update(f'nd{obj.dtype.str}{tuple(obj.shape)!r}'.encode())
    h.update(np.ascontiguousarray(obj).data)
    return
  if isinstance(obj, dict):
    h.update(b'map')
    for k, v in obj.items():
      h.update(f'k{k!r}'.encode())
      _feed_batch(h, v)
    return
  if isinstance(obj, (list, tuple)):
    h.update(f'seq{isinstance(obj, tuple)}'.encode())
    for v in obj:
      _feed_batch(h, v)
    return
  h.update(f'py{obj!r}'.encode())


def _feed_packed(h, spec, buf):
  """Feed a packed ``_pack_into`` spec over ``buf`` to hasher ``h``.

  Hashes only array content at the spec's offsets (never slot padding),
  so the digest is independent of slot base offsets and alignment — a
  shm slot and a wire frame of the same batch hash identically.
  """
  kind = spec[0]
  if kind == 'nd':
    _, dtype, shape, offset = spec
    nbytes = int(np.dtype(dtype).itemsize * int(np.prod(shape, dtype=np.int64)))
    h.update(f'nd{dtype}{tuple(shape)!r}'.encode())
    h.update(memoryview(buf)[offset:offset + nbytes])
    return
  if kind == 'map':
    h.update(b'map')
    for k, s in spec[1]:
      h.update(f'k{k!r}'.encode())
      _feed_packed(h, s, buf)
    return
  if kind == 'seq':
    _, is_tuple, specs = spec
    h.update(f'seq{bool(is_tuple)}'.encode())
    for s in specs:
      _feed_packed(h, s, buf)
    return
  h.update(f'py{spec[1]!r}'.encode())  # 'py'


def fingerprint_batch(obj, algo=None):
  """Digest of a live batch (dicts / sequences / ndarrays / leaves), in
  ``algo`` (None: this process's :data:`ALGO`)."""
  h = _hasher(algo)
  _feed_batch(h, obj)
  return h.hexdigest()


def fingerprint_packed(spec, buf, algo=None):
  """Digest of a packed batch from its ``_pack_into`` spec + buffer;
  equal to :func:`fingerprint_batch` of the original object."""
  h = _hasher(algo)
  _feed_packed(h, spec, buf)
  return h.hexdigest()


def first_ndarray(obj):
  """The first ndarray leaf of a live batch in canonical walk order
  (None when there is none) — the live-batch twin of
  :func:`first_array_span`, for aiming the ``ledger.corrupt`` fault at
  unpacked batches."""
  if isinstance(obj, np.ndarray):
    return obj
  if isinstance(obj, dict):
    values = obj.values()
  elif isinstance(obj, (list, tuple)):
    values = obj
  else:
    return None
  for v in values:
    arr = first_ndarray(v)
    if arr is not None:
      return arr
  return None


def first_array_span(spec):
  """``(offset, nbytes)`` of the first ndarray leaf in a packed spec
  (None when the batch carries no arrays). This is where the
  ``ledger.corrupt`` fault flips its byte: aiming at real array content
  rather than byte 0 of the slot, which may be padding the fingerprint
  deliberately ignores."""
  kind = spec[0]
  if kind == 'nd':
    _, dtype, shape, offset = spec
    return offset, int(
        np.dtype(dtype).itemsize * int(np.prod(shape, dtype=np.int64)))
  if kind == 'map':
    for _, s in spec[1]:
      span = first_array_span(s)
      if span is not None:
        return span
  elif kind == 'seq':
    for s in spec[2]:
      span = first_array_span(s)
      if span is not None:
        return span
  return None


def record_key(rec):
  """The alignment key of a ledger record: the :data:`KEY_FIELDS`
  values it carries, in canonical order (None when it carries none —
  the auditor then falls back to per-boundary sequence position)."""
  key = tuple((f, rec[f]) for f in KEY_FIELDS if f in rec)
  return key or None


def ledger_file_name(directory, rank):
  """Canonical per-rank ledger path (what the auditor globs)."""
  return os.path.join(directory, f'ledger.rank{rank}.jsonl')


def replicated_boundaries():
  """Boundaries whose streams are rank-identical by contract, i.e. the
  only ones the cross-rank divergence verdict may compare (env
  ``LDDL_LEDGER_REPLICATED``, comma-separated; default ``step``)."""
  spec = os.environ.get('LDDL_LEDGER_REPLICATED', 'step')
  return tuple(b.strip() for b in spec.split(',') if b.strip())


class NoopLedger:
  """The disabled ledger: zero files, zero state, empty methods."""

  __slots__ = ()
  enabled = False

  def record(self, boundary, digest, **coords):
    return None

  def signals(self):
    return {}

  def set_fleet_verdict(self, verdict):
    pass

  def fleet_verdict(self):
    return None

  def flush(self):
    pass

  def close(self):
    pass


NOOP_LEDGER = NoopLedger()

_DEFAULT_WINDOW = 64


class _Stream:
  """Per-boundary rolling state."""

  __slots__ = ('count', 'rolling', 'recent')

  def __init__(self, window):
    self.count = 0
    self.rolling = ''
    self.recent = collections.deque(maxlen=window)  # (key-list, digest)


class Ledger:
  """An enabled determinism ledger (one per process).

  Appends one JSON line per record to ``ledger.rank<R>.jsonl`` via a
  single ``os.write`` on an ``O_APPEND`` fd — atomic at line
  granularity, so another process of the rank reopening the same path
  interleaves cleanly with this one.
  Rolling digests and record counts are per-process per-boundary; the
  auditor aligns multi-process boundaries (``shard``) by key, not by
  rolling chain.
  """

  enabled = True

  def __init__(self, directory=None, rank=None, window=None):
    if directory is None:
      directory = os.environ.get('LDDL_TELEMETRY_DIR') or '.'
    if rank is None:
      # A launcher's RANK where LDDL_RANK is unset: each rank of a
      # torch.distributed world writes its own file (step replay reads it).
      rank = int(os.environ.get('LDDL_RANK') or
                 os.environ.get('RANK') or 0)
    if window is None:
      try:
        window = int(os.environ.get('LDDL_LEDGER_WINDOW', _DEFAULT_WINDOW))
      except ValueError:
        window = _DEFAULT_WINDOW
    self.rank = rank
    self.window = max(2, window)
    self.path = ledger_file_name(directory, rank)
    os.makedirs(directory, exist_ok=True)
    # The fd lives as long as the ledger singleton; close() releases it
    # on disable()/interpreter exit.
    self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                       0o644)
    try:
      fsync_every = int(os.environ.get('LDDL_LEDGER_FSYNC', '0'))
    except ValueError:
      fsync_every = 0
    self._fsync_every = fsync_every
    self._since_fsync = 0
    self._lock = threading.Lock()
    self._streams = {}
    self._fleet_verdict = None
    self._records_c = get_telemetry().counter('ledger.records')
    os.write(self._fd, (json.dumps(
        {'kind': 'meta', 'rank': rank, 'pid': os.getpid(), 'algo': ALGO,
         'window': self.window, 'unix_time': time.time()},
        sort_keys=True) + '\n').encode())

  def record(self, boundary, digest, **coords):
    """Append one fingerprint record; returns the stream's new rolling
    digest. ``coords`` key fields (:data:`KEY_FIELDS`) align the record
    across runs/ranks; other keywords are carried as context."""
    with self._lock:
      st = self._streams.get(boundary)
      if st is None:
        st = self._streams[boundary] = _Stream(self.window)
      st.count += 1
      st.rolling = fingerprint_bytes(st.rolling.encode(), digest.encode())
      st.recent.append(([coords[f] for f in KEY_FIELDS if f in coords],
                        digest))
      # Hand-assembled JSON: boundary/digest/rolling are safe token/hex
      # strings, so only coordinate values need real escaping. Saves a
      # json.dumps per batch on the hot path.
      line = (f'{{"boundary":"{boundary}","digest":"{digest}",'
              f'"n":{st.count},"rolling":"{st.rolling}"')
      for k, v in coords.items():
        if v is True or v is False:
          line += f',"{k}":{"true" if v else "false"}'
        elif isinstance(v, (int, float)):
          line += f',"{k}":{v}'
        else:
          line += f',"{k}":{json.dumps(str(v))}'
      os.write(self._fd, (line + '}\n').encode())
      if self._fsync_every:
        self._since_fsync += 1
        if self._since_fsync >= self._fsync_every:
          self._since_fsync = 0
          os.fsync(self._fd)
      self._records_c.add(1)
      return st.rolling

  def signals(self):
    """Per-boundary live state, the payload a cross-rank exchange
    compares (:func:`compare_signals`): ``{boundary: {count, rolling,
    recent}}``."""
    with self._lock:
      return {
          b: {'count': st.count, 'rolling': st.rolling,
              'recent': [[k, d] for k, d in st.recent]}
          for b, st in self._streams.items()
      }

  def set_fleet_verdict(self, verdict):
    """Stash the latest cross-rank divergence verdict so local
    consumers (:func:`determinism_verdict`) can surface it without a
    collective of their own."""
    with self._lock:
      self._fleet_verdict = verdict

  def fleet_verdict(self):
    with self._lock:
      return self._fleet_verdict

  def flush(self):
    """fsync the ledger fd (machine-crash durability point)."""
    with self._lock:
      if self._fd is not None:
        os.fsync(self._fd)

  def close(self):
    with self._lock:
      if self._fd is not None:
        try:
          os.fsync(self._fd)
        except OSError:
          pass
        os.close(self._fd)
        self._fd = None


# ---------------------------------------------------------------------------
# divergence verdicts


def compare_signals(per_rank, replicated=None):
  """Cross-rank divergence verdict from gathered :meth:`Ledger.signals`.

  ``per_rank``: ``{rank: signals dict}``. Only boundaries in
  ``replicated`` (default :func:`replicated_boundaries`) are compared —
  everything else legitimately differs across data-parallel ranks.
  Pure arithmetic over the gathered state: every rank computes the
  identical verdict.

  Per compared boundary:

    - ranks at different counts are ``lagging`` (progress skew, not
      divergence — the straggler table's job);
    - equal counts with equal rolling digests are ``ok``;
    - equal counts with different rolling digests are ``diverged``, and
      the earliest key in the recent-window overlap whose digests
      differ names the first divergent batch (``first`` is None when
      the divergence predates the retained window).

  Returns ``{'status': 'ok'|'diverged'|None, 'boundaries': {...},
  'first': {...}|None}``; status None when no boundary was comparable.
  """
  if replicated is None:
    replicated = replicated_boundaries()
  boundaries = {}
  first_overall = None
  status = None
  for b in replicated:
    ranks = {r: s[b] for r, s in per_rank.items() if s and b in s}
    if len(ranks) < 2:
      continue
    counts = {r: st['count'] for r, st in ranks.items()}
    entry = {'counts': counts, 'first': None}
    if len(set(counts.values())) > 1:
      entry['status'] = 'lagging'
    elif len({st['rolling'] for st in ranks.values()}) == 1:
      entry['status'] = 'ok'
    else:
      entry['status'] = 'diverged'
      # Earliest key (by key order) seen by >= 2 ranks with differing
      # digests inside the retained windows.
      by_key = {}
      for r, st in ranks.items():
        for key, digest in st.get('recent') or []:
          by_key.setdefault(tuple(key), {})[r] = digest
      divergent = sorted(
          k for k, ds in by_key.items()
          if len(ds) > 1 and len(set(ds.values())) > 1)
      if divergent:
        k = divergent[0]
        entry['first'] = {'key': list(k),
                          'digests': {r: d
                                      for r, d in sorted(
                                          by_key[k].items())}}
    boundaries[b] = entry
    if entry['status'] == 'diverged':
      status = 'diverged'
      if first_overall is None:
        first_overall = {'boundary': b, **(entry['first'] or {'key': None})}
    elif status is None:
      status = 'ok'
  return {'status': status, 'boundaries': boundaries,
          'first': first_overall}



def divergence_over_comm(comm, ledger=None, telemetry=None):
  """Fleet divergence verdict over the run's own comm backend (as
  :func:`lddl_tpu.telemetry.ledger.divergence_over_comm`).

  Every rank contributes its ledger signals; the allgather rides the
  backend's normal collective stream tagged with the collective seq, all
  ranks compute the identical verdict, and the result is stashed on the
  ledger (:meth:`Ledger.set_fleet_verdict`) plus counted into
  ``ledger.divergences`` when it names a divergence. No-op (returns
  None) when the ledger is disabled.
  """
  led = ledger if ledger is not None else get_ledger()
  if not led.enabled:
    return None
  seq = getattr(comm, 'collective_seq', None)
  gathered = comm.allgather_object(
      {'rank': comm.rank, 'seq': seq, 'ledger': led.signals()})
  verdict = compare_signals({e['rank']: e['ledger'] for e in gathered})
  seqs = {e['seq'] for e in gathered if e.get('seq') is not None}
  verdict['seq'] = max(seqs) if seqs else None
  if len(seqs) > 1:
    verdict['seq_mismatch'] = sorted(seqs)
  led.set_fleet_verdict(verdict)
  tele = telemetry if telemetry is not None else get_telemetry()
  if tele.enabled and verdict['status'] == 'diverged':
    tele.counter('ledger.divergences').add(1)
  return verdict

def determinism_verdict(ledger=None):
  """The ``verdict.determinism`` block of the JAX package's live
  verdict: this process's per-boundary stream heads plus the latest
  fleet verdict (if one was stored with :meth:`Ledger.set_fleet_verdict`).
  None when the ledger is disabled."""
  led = ledger if ledger is not None else get_ledger()
  if not led.enabled:
    return None
  signals = led.signals()
  fleet = led.fleet_verdict()
  status = (fleet or {}).get('status') or ('ok' if signals else 'idle')
  return {
      'status': status,
      'streams': {
          b: {'count': st['count'], 'rolling': st['rolling'],
              'last': st['recent'][-1] if st['recent'] else None}
          for b, st in signals.items()
      },
      'fleet': fleet,
  }


# ---------------------------------------------------------------------------
# process-global gate (the metrics.py / trace.py discipline)


_ENV = 'LDDL_LEDGER'
_active = None  # None: not yet resolved from the environment
# First resolution can race: producer/writer threads and the main loop
# all call get_ledger() lazily. The lock makes the install atomic.
_active_lock = threading.Lock()


def get_ledger():
  """The process-global ledger: :class:`Ledger` when enabled (env
  ``LDDL_LEDGER`` truthy or :func:`enable_ledger` called), else the
  shared :data:`NOOP_LEDGER` singleton."""
  global _active
  with _active_lock:
    if _active is None:
      spec = os.environ.get(_ENV, '').strip().lower()
      _active = (Ledger() if spec in ('1', 'true', 'on', 'yes')
                 else NOOP_LEDGER)
    return _active


def enable_ledger(**kwargs):
  """Switch the ledger on (fresh instance unless already enabled)."""
  global _active
  with _active_lock:
    if _active is None or not _active.enabled:
      _active = Ledger(**kwargs)
    return _active


def disable_ledger():
  """Switch the ledger off (instrument sites see :data:`NOOP_LEDGER`);
  closes the active file first."""
  global _active
  with _active_lock:
    if _active is not None and _active.enabled:
      _active.close()
    _active = NOOP_LEDGER
    return _active
