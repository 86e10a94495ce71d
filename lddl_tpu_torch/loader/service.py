"""Fault-tolerant network data service: the shm batch spec over TCP.

A copy of :mod:`lddl_tpu.loader.service` (numpy and the stdlib; the port
keeps its own copy and imports nothing of :mod:`lddl_tpu`). It speaks the
reference's protocol frame for frame, so either package's client drains
either package's server. One warm, balanced corpus feeds many training
jobs: a :class:`DataServer` packs each batch once with
:func:`~.shm._pack_into` and streams ``(spec, payload)`` frames over a
pure-stdlib length-prefixed TCP protocol; a :class:`NetworkBatchSource`
client unpacks with :func:`~.shm._unpack_from`. The wire format IS the
slot format on a contiguous buffer.

The server process imports no torch and never touches the card: it
collates on the host, as the loader's worker processes do.

Robustness is the design, not a bolt-on:

  - **deterministic drain leases** — with a comm backend, each client
    CAS-claims ``claim.<epoch>.<gi>.g<gen>`` through a
    ``lease_store('serve')`` namespace and heartbeats while draining.
    The server retains every batch until its ``done.<epoch>.<gi>``
    manifest (or a storeless ``ack``) lands, so a dead client's
    claimed-but-unmanifested batches are revoked by the survivors
    (positive pid death or heartbeat silence past
    ``LDDL_LEASE_TIMEOUT``) and re-served: the union of delivered
    batches is byte-identical to a single-consumer run.
  - **bounded everything** — every socket carries a deadline
    (``LDDL_DATA_TIMEOUT``), the client retries with
    :func:`~..comm.backend.backoff_delay` exponential backoff and
    deterministic jitter (``LDDL_DATA_RETRIES`` budget), and the
    server's in-memory batch window (``LDDL_DATA_WINDOW``) is the
    producer's only backpressure — a slow consumer bounds server
    memory, it never grows it.
  - **graceful degradation** — past the retry budget the client logs a
    :func:`~..core.log.warn_once` and falls back to the local loader
    mid-epoch *at its exact deterministic position*, keeps claiming
    through the lease store so multi-client fleets never duplicate a
    batch, and re-attaches when the server answers again (probed every
    ``LDDL_DATA_REATTACH_EVERY`` batches).
  - **observable** — the server writes a ``serve.pid<P>.json`` announce
    file (same positive-death pid identity as the monitor announces,
    and a new server removes the announces of provably dead ones),
    exports ``serve.*`` telemetry (clients, batches_served, reserves,
    lease_revokes, backlog, fallbacks, reattaches), and
    ``python -m lddl_tpu_torch.telemetry.monitor`` folds dead
    data-server endpoints into fleet errors instead of connection noise.

Run a server::

  python -m lddl_tpu_torch.loader.service --path /data/balanced \\
      --vocab-file vocab.txt --batch-size 64 --bin-size 64 --port 7077

and point clients at it with ``LDDL_LOADER_TRANSPORT=network`` plus
``LDDL_DATA_SERVER=host:7077`` (or let them discover the announce file
under ``LDDL_MONITOR_DIR``).
"""

import argparse
import glob
import json
import os
import pickle
import signal
import socket
import struct
import threading
import time

from ..comm.backend import (HeartbeatPump, backoff_delay,
                            comm_heartbeat_interval, jitter_source)
from ..core import faults
from ..core.log import warn_once
from ..telemetry import get_telemetry
from ..telemetry.ledger import (first_array_span, fingerprint_packed,
                                get_ledger)
from .shm import SlotOverflow, _pack_into, _unpack_from

_MAGIC = b'LDS1'
_HEAD = struct.Struct('!IQ')  # header length, body length

_ENDPOINT_ENV = 'LDDL_DATA_SERVER'
_TIMEOUT_ENV = 'LDDL_DATA_TIMEOUT'
_RETRIES_ENV = 'LDDL_DATA_RETRIES'
_WINDOW_ENV = 'LDDL_DATA_WINDOW'
_REATTACH_ENV = 'LDDL_DATA_REATTACH_EVERY'

#: How far past the lowest unresolved batch a claiming client scans for
#: claimable work before waiting on manifests/revocations. Bounds the
#: foreign-claim cache; any value >= 1 yields the same union of batches.
_CLAIM_SCAN = 64

#: Client-side poll cadence while waiting on a pending batch, a foreign
#: lease, or peers' manifests. Changes only latency, never any result.
_POLL = 0.05


def data_timeout(default=30.0):
  """Connect/read/write deadline in seconds (env ``LDDL_DATA_TIMEOUT``)."""
  try:
    return max(0.1, float(os.environ.get(_TIMEOUT_ENV, default)))
  except ValueError:
    return default


def data_retries(default=3):
  """Client retry budget per pull before degrading (``LDDL_DATA_RETRIES``)."""
  try:
    return max(0, int(os.environ.get(_RETRIES_ENV, default)))
  except ValueError:
    return default


def data_window(default=8):
  """Server in-memory batch window (env ``LDDL_DATA_WINDOW``): the
  producer blocks when this many batches await delivery/acks — the
  slow-consumer backpressure bound."""
  try:
    return max(1, int(os.environ.get(_WINDOW_ENV, default)))
  except ValueError:
    return default


def reattach_every(default=32):
  """Degraded-mode server probe cadence in batches (0 disables)."""
  try:
    return max(0, int(os.environ.get(_REATTACH_ENV, default)))
  except ValueError:
    return default


def serve_lease_timeout():
  """Heartbeat-silence bound before a client lease is revocable — the
  same ``LDDL_LEASE_TIMEOUT`` knob (and semantics) as
  :func:`~..pipeline.executor.lease_timeout`; duplicated here so the
  loader layer does not import the pipeline executor."""
  try:
    return max(0.2, float(os.environ.get('LDDL_LEASE_TIMEOUT', '60')))
  except ValueError:
    return 60.0


class ProtocolError(RuntimeError):
  """A frame that is not ours (bad magic / truncated / bad header)."""


class ServerLost(RuntimeError):
  """The retry budget is spent: the server is unreachable."""


# ---------------------------------------------------------------------------
# framing: MAGIC | u32 header_len | u64 body_len | pickled header | body


def _send_frame(sock, header, body=b''):
  """One length-prefixed frame. The fault site lets tests break the wire
  mid-write on either end."""
  faults.inject('wire.write')
  raw = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
  # One sendall for the small parts: split writes on a Nagle socket
  # stall ~40ms each against the peer's delayed ACK, and this protocol
  # is request-response ping-pong (see TCP_NODELAY at both endpoints).
  sock.sendall(_MAGIC + _HEAD.pack(len(raw), len(body)) + raw)
  if body:
    sock.sendall(body)


def _recv_exact(sock, n):
  buf = bytearray(n)
  view = memoryview(buf)
  got = 0
  while got < n:
    k = sock.recv_into(view[got:], n - got)
    if k == 0:
      raise ConnectionError('peer closed mid-frame')
    got += k
  return buf


def _recv_frame(sock):
  head = _recv_exact(sock, len(_MAGIC) + _HEAD.size)
  if bytes(head[:len(_MAGIC)]) != _MAGIC:
    raise ProtocolError(f'bad frame magic {bytes(head[:4])!r}')
  hlen, blen = _HEAD.unpack_from(head, len(_MAGIC))
  try:
    header = pickle.loads(bytes(_recv_exact(sock, hlen)))
  except (pickle.UnpicklingError, EOFError, ValueError) as e:
    raise ProtocolError(f'undecodable frame header: {e}')
  body = _recv_exact(sock, blen) if blen else bytearray()
  return header, body


# ---------------------------------------------------------------------------
# batch <-> bytes, via the shm transport's spec machinery


def _size_hint(obj):
  import numpy as np
  if isinstance(obj, np.ndarray):
    return obj.nbytes + 64  # per-array alignment slack
  if isinstance(obj, dict):
    return sum(_size_hint(v) for v in obj.values())
  if isinstance(obj, (list, tuple)):
    return sum(_size_hint(v) for v in obj)
  return 0


def pack_batch(batch):
  """``batch -> (spec, payload bytes)`` — :func:`~.shm._pack_into` on a
  contiguous buffer instead of a shm slot, so the wire carries exactly
  the spec the slot rings carry (byte-identical arrays on unpack)."""
  size = _size_hint(batch) + 1024
  while True:
    buf = bytearray(size)
    try:
      spec, end = _pack_into(batch, buf, 0, size)
      return spec, bytes(memoryview(buf)[:end])
    except SlotOverflow:
      size *= 2  # non-array leaves ride in the spec; retry with headroom


def unpack_batch(spec, payload):
  """Materialize a served batch (always a detached copy)."""
  return _unpack_from(spec, payload, copy=True)


# ---------------------------------------------------------------------------
# announce files + discovery (the monitor-announce discipline)


def _announce_dir(explicit=None):
  return (explicit or os.environ.get('LDDL_MONITOR_DIR', '').strip() or
          os.environ.get('LDDL_TELEMETRY_DIR', '').strip() or None)


def announce_dead(info):
  """True when an announce names a pid provably dead in our pid
  namespace — the comm beacons' positive-death discipline; uncertainty
  is never death."""
  pid = info.get('pid')
  pidns = info.get('pidns')
  if not isinstance(pid, int) or not pidns:
    return False
  from ..comm.backend import FileBackend
  ours = FileBackend._pid_namespace()
  if not ours or pidns != ours:
    return False
  return FileBackend._pid_dead(pid, info.get('pid_starttime') or '')


def discover_data_servers(directory):
  """Parsed ``serve.pid*.json`` announces under ``directory``, each with
  a ``dead`` flag from the pid probe. A SIGKILLed server cannot remove
  its announce file; the probe proves it dead so consumers report it
  instead of polling a corpse into a timeout."""
  paths = sorted(glob.glob(os.path.join(directory, 'serve.pid*.json')))
  out = []
  for p in paths:
    try:
      with open(p) as f:
        info = json.load(f)
    except (OSError, ValueError):
      continue  # mid-rewrite or torn down; the next poll catches up
    if info.get('url'):
      info['dead'] = announce_dead(info)
      out.append(info)
  return out


def _parse_endpoint(spec):
  host, _, port = str(spec).strip().rpartition(':')
  return (host or '127.0.0.1'), int(port)


def resolve_endpoint(endpoint=None, announce_dir=None):
  """``(host, port)`` of the data server, or None when nothing answers
  the question: explicit arg > ``LDDL_DATA_SERVER`` env > the newest
  live announce file."""
  spec = endpoint or os.environ.get(_ENDPOINT_ENV, '').strip()
  if spec:
    return _parse_endpoint(spec)
  directory = _announce_dir(announce_dir)
  if not directory:
    return None
  live = [i for i in discover_data_servers(directory) if not i['dead']]
  if not live:
    return None
  newest = max(live, key=lambda i: i.get('started_unix') or 0)
  return _parse_endpoint(newest['url'])


# ---------------------------------------------------------------------------
# server


class DataServer:
  """Serve one loader's deterministic batch stream to N clients.

  A producer thread drains ``loader.iter_steps((0, 1))`` epoch after
  epoch, packs each batch once, and parks it in a bounded window; the
  accept loop hands each connection to a daemon thread answering
  ``get``/``ack``/``stat`` requests. A batch leaves the window only
  when its delivery is durable — a ``done.<epoch>.<gi>`` manifest in
  the serve lease store, or a storeless client ``ack`` — so an
  unmanifested batch from a dead client is still here to re-serve.
  """

  def __init__(self, loader, host='127.0.0.1', port=0, window=None,
               lease_store=None, announce_dir=None, epochs=None):
    self._loader = loader
    self._host = host
    self._port = int(port)
    self._window = data_window() if window is None else max(1, int(window))
    self._store = lease_store
    self._epochs = epochs  # None: serve until stop()
    self._announce_to = announce_dir
    self._lock = threading.Condition()
    self._buf = {}        # (epoch, gi) -> (spec, payload)
    self._gone = set()    # (epoch, gi) delivered and trimmed
    self._served = set()  # (epoch, gi) sent at least once
    self._epoch_end = {}  # epoch -> batch count, once the epoch drains
    self._stop = threading.Event()
    self._threads = []
    self._sock = None
    self._announce_path = None
    self._clients = 0
    tele = get_telemetry()
    self._served_c = tele.counter('serve.batches_served')
    self._reserves_c = tele.counter('serve.reserves')
    self._backlog_g = tele.gauge('serve.backlog')
    self._clients_g = tele.gauge('serve.clients')
    # Streaming sentinel (LDDL_SENTINEL): watches the producer's
    # backlog for runaway growth; no-op singleton when the gate is off.
    from ..telemetry.sentinel import get_sentinel
    self._sentinel = get_sentinel()
    self.url = None

  # -- lifecycle

  def start(self):
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.settimeout(0.5)  # the accept loop's stop-flag poll cadence
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((self._host, self._port))
    srv.listen(64)
    self._sock = srv
    self._port = srv.getsockname()[1]
    self.url = f'{self._host}:{self._port}'
    # Spawn targets are named explicitly (not through a loop variable)
    # so the lddl-analyze thread graph sees both spawn edges; the
    # listener travels as an argument so the accept loop never reads
    # self._sock, which stop() tears down from the main thread.
    produce = threading.Thread(target=self._produce,
                               name='lddl-serve-produce', daemon=True)
    accept = threading.Thread(target=self._accept, args=(srv,),
                              name='lddl-serve-accept', daemon=True)
    produce.start()
    accept.start()
    with self._lock:  # _accept appends per-conn threads concurrently
      self._threads.extend((produce, accept))
    self._announce()
    return self

  def stop(self):
    """Idempotent teardown: no thread, socket, or announce file survives."""
    self._stop.set()
    with self._lock:
      self._lock.notify_all()
      pending = list(self._threads)
      self._threads = []
    for t in pending:  # join outside the lock: workers still need it
      t.join(timeout=10.0)
    if self._sock is not None:
      try:
        self._sock.close()
      except OSError:
        pass
      self._sock = None
    if self._announce_path:
      try:
        os.unlink(self._announce_path)
      except OSError:
        pass
      self._announce_path = None
    self.url = None

  def _announce(self):
    directory = _announce_dir(self._announce_to)
    if not directory:
      return
    os.makedirs(directory, exist_ok=True)
    # A SIGKILLed predecessor could not remove its announce; once it is
    # provably dead (discovery already skips it), the server that takes
    # its place in the directory does.
    for path in sorted(glob.glob(os.path.join(directory, 'serve.pid*.json'))):
      try:
        with open(path) as f:
          stale = announce_dead(json.load(f))
      except (OSError, ValueError):
        continue
      if stale:
        try:
          os.unlink(path)
        except OSError:
          pass  # another successor got there first
    from ..comm.backend import FileBackend
    payload = json.dumps({
        'url': self.url,
        'kind': 'data-server',
        'pid': os.getpid(),
        'pidns': FileBackend._pid_namespace(),
        'pid_starttime': FileBackend._pid_starttime(os.getpid()),
        'started_unix': time.time(),
    })
    self._announce_path = os.path.join(directory,
                                       f'serve.pid{os.getpid()}.json')
    tmp = self._announce_path + '.tmp'
    with open(tmp, 'w') as f:
      f.write(payload)
    os.replace(tmp, self._announce_path)

  # -- producer

  def _produce(self):
    try:
      ledger = get_ledger()
      epoch = int(getattr(self._loader, 'epoch', 0))
      remaining = self._epochs
      while not self._stop.is_set():
        if remaining is not None and remaining <= 0:
          return
        count = 0
        self._loader.epoch = epoch
        for step, batch in self._loader.iter_steps((0, 1)):
          faults.inject('serve.batch', gi=step)
          spec, payload = pack_batch(batch)
          if ledger.enabled:
            # serve.tx: what the server *intends* to send, hashed once
            # at pack time (re-serves repeat the same payload). The
            # corrupt drill below fires only after this record, so a
            # damaged frame shows up as tx != rx — exactly the
            # silent-corruption signature the auditor looks for.
            ledger.record('serve.tx', fingerprint_packed(spec, payload),
                          epoch=epoch, gi=step)
          if 'corrupt:' in os.environ.get('LDDL_FAULTS', ''):
            span = first_array_span(spec)
            if span is not None:
              damaged = bytearray(payload)
              if faults.corrupt_bytes(
                  'ledger.corrupt',
                  memoryview(damaged)[span[0]:span[0] + span[1]],
                  gi=step, epoch=epoch):
                payload = bytes(damaged)
          with self._lock:
            while (len(self._buf) >= self._window and
                   not self._stop.is_set()):
              self._trim_locked()
              if len(self._buf) < self._window:
                break
              self._lock.wait(timeout=0.2)  # re-sweep manifests, re-check
            if self._stop.is_set():
              return
            self._buf[(epoch, step)] = (spec, payload)
            backlog = len(self._buf)
            self._backlog_g.set(backlog)
            self._lock.notify_all()
          # Outside the lock: one trigger per excursion past the
          # runaway threshold (the sentinel mutes refires itself).
          trig = self._sentinel.observe_backlog(backlog)
          if trig is not None:
            # The port has no flight recorder: the warning and the
            # sentinel's status (the monitor's /snapshot) carry it.
            warn_once(f'sentinel: serve backlog runaway ({trig["reason"]})')
          count = step + 1
        with self._lock:
          self._epoch_end[epoch] = count
          self._lock.notify_all()
        epoch += 1
        if remaining is not None:
          remaining -= 1
    except BaseException:
      # A dying producer must not strand clients in 'wait' forever:
      # closing the listener makes every client fail fast into its
      # retry/degrade path instead of polling a wedged server.
      self._stop.set()
      with self._lock:
        self._lock.notify_all()
      raise

  def _trim_locked(self):
    """Drop buffered batches whose delivery manifests have landed."""
    if self._store is None or not self._buf:
      return
    try:
      manifests = set(self._store.list('done.'))
    except OSError:
      return  # transient substrate flap; the next sweep retries
    for key in sorted(self._buf):
      if f'done.{key[0]}.{key[1]}' in manifests:
        del self._buf[key]
        self._gone.add(key)
    self._backlog_g.set(len(self._buf))
    self._lock.notify_all()

  # -- connections

  def _accept(self, srv):
    while not self._stop.is_set():
      try:
        conn, addr = srv.accept()
      except socket.timeout:
        continue
      except OSError:
        return  # listener closed under us: stop() is in progress
      faults.inject('serve.accept')
      t = threading.Thread(target=self._serve_conn, args=(conn,),
                           name='lddl-serve-conn', daemon=True)
      t.start()
      with self._lock:  # stop() drains this list from the main thread
        self._threads.append(t)

  def _serve_conn(self, conn):
    conn.settimeout(0.5)  # recv poll so the loop can observe stop()
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    with self._lock:
      self._clients += 1
      self._clients_g.set(self._clients)
    try:
      while not self._stop.is_set():
        try:
          header, _ = _recv_frame(conn)
        except socket.timeout:
          continue  # idle client (mid-consume); keep the session
        except (OSError, ProtocolError):
          return  # client gone or not speaking our protocol
        try:
          if not self._answer(conn, header):
            return
        except OSError:
          return  # client vanished mid-reply
    finally:
      with self._lock:
        self._clients -= 1
        self._clients_g.set(self._clients)
      try:
        conn.close()
      except OSError:
        pass

  def _answer(self, conn, header):
    """Handle one request; False ends the session."""
    op = header.get('op')
    if op == 'hello':
      _send_frame(conn, {'op': 'ok', 'pid': os.getpid()})
      return True
    if op == 'bye':
      _send_frame(conn, {'op': 'ok'})
      return False
    if op == 'ack':
      key = (int(header['epoch']), int(header['gi']))
      with self._lock:
        if key in self._buf:
          del self._buf[key]
          self._gone.add(key)
          self._backlog_g.set(len(self._buf))
          self._lock.notify_all()
      _send_frame(conn, {'op': 'ok'})
      return True
    if op == 'stat':
      with self._lock:
        stat = {
            'op': 'stat', 'backlog': len(self._buf),
            'window': self._window, 'clients': self._clients,
            'epoch_end': dict(self._epoch_end), 'pid': os.getpid(),
        }
      _send_frame(conn, stat)
      return True
    if op == 'get':
      return self._answer_get(conn, int(header['epoch']),
                              int(header['gi']))
    _send_frame(conn, {'op': 'error', 'detail': f'unknown op {op!r}'})
    return True

  def _answer_get(self, conn, epoch, gi):
    key = (epoch, gi)
    with self._lock:
      # Brief bounded wait for a pending batch saves a round trip; the
      # client polls again on 'wait', so the bound is latency, not
      # correctness.
      self._lock.wait_for(
          lambda: (self._stop.is_set() or key in self._buf or
                   key in self._gone or epoch in self._epoch_end),
          timeout=0.5)
      entry = self._buf.get(key)
      if entry is not None:
        reserve = key in self._served
        self._served.add(key)
      elif key in self._gone:
        _send_frame(conn, {'op': 'gone', 'epoch': epoch, 'gi': gi})
        return True
      else:
        end = self._epoch_end.get(epoch)
        if end is not None and gi >= end:
          _send_frame(conn, {'op': 'end', 'epoch': epoch, 'count': end})
        else:
          _send_frame(conn, {'op': 'wait', 'epoch': epoch, 'gi': gi})
        return True
    spec, payload = entry
    _send_frame(conn, {'op': 'batch', 'epoch': epoch, 'gi': gi,
                       'spec': spec}, payload)
    self._served_c.add(1)
    if reserve:
      self._reserves_c.add(1)
    return True


# ---------------------------------------------------------------------------
# client-side drain leases


class _ServeClaimer:
  """The executor's CAS/revoke/generation discipline over the serve
  namespace: keys carry ``(epoch, gi)`` and the drain is open-ended
  (epoch size is learned from the server), but the invariants are
  identical — one owner per (key, generation), one revoke winner, and
  manifests as the only completion truth."""

  def __init__(self, store, timeout=None):
    from ..comm.backend import LeaseStaleness
    self._store = store
    self._staleness = LeaseStaleness(
        store, serve_lease_timeout() if timeout is None else timeout)
    self._done = {}     # epoch -> manifested gi set
    self._mine = {}     # epoch -> gi set delivered by this client
    self._gen = {}      # (epoch, gi) -> live claim generation
    self._foreign = {}  # (epoch, gi, gen) -> owning rank
    tele = get_telemetry()
    self._claims_c = tele.counter('serve.lease_claims')
    self._revokes_c = tele.counter('serve.lease_revokes')

  def refresh(self, epoch):
    prefix = f'done.{epoch}.'
    try:
      keys = self._store.list(prefix)
    except OSError:
      return
    done = self._done.setdefault(epoch, set())
    for key in keys:
      suffix = key[len(prefix):]
      if suffix.isdigit():
        done.add(int(suffix))

  def is_resolved(self, epoch, gi):
    return (gi in self._done.get(epoch, ()) or
            gi in self._mine.get(epoch, ()))

  def claim(self, epoch, gi):
    """True when (epoch, gi) is ours to deliver — a fresh CAS win or a
    leftover claim from this rank's previous incarnation (re-delivery
    is idempotent under the manifest check)."""
    gen = self._gen.get((epoch, gi), 0)
    if (epoch, gi, gen) in self._foreign:
      return False
    owner = self._store.try_claim(f'claim.{epoch}.{gi}.g{gen}')
    if owner is None or owner == self._store.rank:
      self._mine.setdefault(epoch, set())  # delivery marks it later
      self._claims_c.add(1)
      return True
    if owner >= 0:
      self._foreign[(epoch, gi, gen)] = owner
    return False

  def observe(self, epoch, gis):
    """Revoke stale foreign leases among ``gis`` (positive pid death or
    heartbeat silence); True when any partition reopened."""
    progressed = False
    for gi in gis:
      if self.is_resolved(epoch, gi):
        continue
      gen = self._gen.get((epoch, gi), 0)
      owner = self._foreign.get((epoch, gi, gen))
      if owner is None or not self._staleness.stale(owner):
        continue
      if self._store.try_claim(f'revoke.{epoch}.{gi}.g{gen}') is None:
        self._revokes_c.add(1)
      self._gen[(epoch, gi)] = gen + 1
      progressed = True
    return progressed

  def publish_done(self, epoch, gi):
    self._store.publish(f'done.{epoch}.{gi}', b'1')
    self._mine.setdefault(epoch, set()).add(gi)


class _EpochState:
  """One epoch's drain bookkeeping, shared by the network and local
  phases so a mid-epoch degrade/re-attach never loses position."""

  __slots__ = ('frontier', 'end', 'local_done')

  def __init__(self, first_step):
    self.frontier = int(first_step)  # lowest gi not yet resolved
    self.end = None                  # epoch batch count, once known
    self.local_done = set()          # resolved gis when no lease store


# ---------------------------------------------------------------------------
# client


class NetworkBatchSource:
  """Drain a :class:`DataServer`'s deterministic batch stream.

  ``build_kwargs``/``factory`` reconstruct the local loader (the
  :class:`~.workers.MultiprocessLoader` worker contract) for the
  degraded-mode fallback; ``comm`` supplies the serve lease store for
  multi-client drains (None / :class:`~..comm.NullBackend`: this client
  owns the whole stream and the server trims on its acks).
  """

  def __init__(self, build_kwargs=None, factory=None, endpoint=None,
               comm=None, timeout=None, retries=None, announce_dir=None):
    self._kwargs = dict(build_kwargs or {})
    self._factory = tuple(factory) if factory else None
    self._endpoint = endpoint
    self._announce_from = announce_dir
    self._comm = comm
    self._timeout = data_timeout() if timeout is None else float(timeout)
    self._retries = data_retries() if retries is None else int(retries)
    self._jitter = jitter_source()
    self._sock = None
    self._local = None
    tele = get_telemetry()
    self._pulls_c = tele.counter('serve.client_pulls')
    self._fallbacks_c = tele.counter('serve.fallbacks')
    self._reattaches_c = tele.counter('serve.reattaches')

  # -- the drain

  def iter_steps(self, epoch, first_step=0):
    """Yield ``(gi, batch)`` for this client's share of ``epoch``.

    Single client: the exact serial sequence ``first_step..end-1``.
    With a lease store: a claim-won subset whose union across clients
    is byte-identical to the single-consumer run, dead clients
    included. Network first; degrades to the local loader and
    re-attaches without losing deterministic position.
    """
    store = self._comm.lease_store('serve') if self._comm is not None \
        else None
    claimer = _ServeClaimer(store) if store is not None else None
    pump = HeartbeatPump(store, comm_heartbeat_interval()) \
        if store is not None else None
    state = _EpochState(first_step)
    try:
      networked = True
      while True:
        if networked:
          outcome = yield from self._net_phase(epoch, state, claimer)
        else:
          outcome = yield from self._local_phase(epoch, state, claimer)
        if outcome == 'done':
          return
        networked = outcome == 'reattached'
    finally:
      if pump is not None:
        pump.stop()
      self._close(say_bye=True)

  def __iter__(self):
    for _, batch in self.iter_steps(0):
      yield batch

  # -- network phase

  def _degrade(self, why):
    self._fallbacks_c.add(1)
    warn_once(
        f'lddl data service: {why}; degrading to the local loader at the '
        'current deterministic position (will re-attach when it announces '
        'again)')
    return 'lost'

  def _net_phase(self, epoch, state, claimer):
    ledger = get_ledger()
    waits = 0  # consecutive 'wait' replies (counted, not clocked)
    while True:
      gi = self._next_target(epoch, state, claimer)
      if gi is None:
        return 'done'
      try:
        op, header, body = self._request(
            {'op': 'get', 'epoch': epoch, 'gi': gi}, pull=True)
      except ServerLost:
        return self._degrade('server unreachable past the retry budget')
      if op == 'wait':
        # The reference polls a server that answers 'wait' forever; the
        # port bounds it by the data timeout (each reply takes at least
        # one poll), so a wedged producer, or a restarted server whose
        # window is full of batches this client already took elsewhere,
        # costs a degrade, not a hang.
        waits += 1
        if waits * _POLL >= self._timeout:
          return self._degrade(
              f'server answered wait for ({epoch}, {gi}) past the data '
              'timeout')
        time.sleep(_POLL)
        continue
      waits = 0
      if op == 'batch':
        if ledger.enabled:
          # serve.rx: the same frame the server hashed pre-send, hashed
          # again post-receive on the client — a tx/rx digest mismatch
          # at the same (epoch, gi) is wire-or-server corruption, not a
          # pipeline divergence.
          ledger.record('serve.rx', fingerprint_packed(header['spec'], body),
                        epoch=epoch, gi=gi)
        batch = unpack_batch(header['spec'], body)
        yield gi, batch
        self._mark_delivered(epoch, gi, state, claimer, ack=True)
      elif op == 'end':
        state.end = int(header['count'])
      elif op == 'gone':
        # Manifested by a peer (or a previous incarnation of us):
        # resolved, never re-delivered.
        if claimer is not None:
          claimer.refresh(epoch)
          claimer._done.setdefault(epoch, set()).add(gi)
        else:
          state.local_done.add(gi)
      else:
        raise ProtocolError(f'unexpected server reply {op!r}')

  def _next_target(self, epoch, state, claimer):
    """The next gi this client should pull, or None when the epoch's
    union is complete. May wait on peers' manifests/leases."""
    if claimer is None:
      while state.frontier in state.local_done:
        state.frontier += 1
      if state.end is not None and state.frontier >= state.end:
        return None
      return state.frontier
    while True:
      claimer.refresh(epoch)
      while ((state.end is None or state.frontier < state.end) and
             claimer.is_resolved(epoch, state.frontier)):
        state.frontier += 1
      if state.end is not None and state.frontier >= state.end:
        return None
      hi = state.frontier + _CLAIM_SCAN
      if state.end is not None:
        hi = min(hi, state.end)
      for gi in range(state.frontier, hi):
        if claimer.is_resolved(epoch, gi):
          continue
        if claimer.claim(epoch, gi):
          return gi
      # Everything in view is foreign-held: revoke the stale, then wait
      # for manifests or lease expiry to move the frontier.
      claimer.observe(epoch, range(state.frontier, hi))
      time.sleep(_POLL)

  def _mark_delivered(self, epoch, gi, state, claimer, ack):
    """Delivery became durable the moment the consumer got the batch:
    manifest first (the cross-client truth), then the server-side ack
    (best effort — the manifest sweep covers a lost ack)."""
    if claimer is not None:
      claimer.publish_done(epoch, gi)
    else:
      state.local_done.add(gi)
    if ack:
      try:
        self._request({'op': 'ack', 'epoch': epoch, 'gi': gi},
                      retries=0)
      except (ServerLost, OSError):
        pass  # trimmed via the manifest sweep; ack is an optimization

  # -- wire plumbing

  def _request(self, header, pull=False, retries=None):
    """One request/reply with reconnect + bounded jittered backoff."""
    if pull:
      faults.inject('client.pull', gi=header.get('gi'))
      self._pulls_c.add(1)
    budget = self._retries if retries is None else retries
    for attempt in range(budget + 1):
      try:
        sock = self._ensure_sock()
        _send_frame(sock, header)
        reply, body = _recv_frame(sock)
        return reply.get('op'), reply, body
      except (OSError, ProtocolError):
        self._close()
        if attempt < budget:
          time.sleep(backoff_delay(attempt, jitter=self._jitter))
    raise ServerLost(f'no data server answered after {budget + 1} '
                     f'attempt(s)')

  def _ensure_sock(self):
    if self._sock is not None:
      return self._sock
    addr = resolve_endpoint(self._endpoint, self._announce_from)
    if addr is None:
      raise ServerLost('no data-server endpoint: set LDDL_DATA_SERVER '
                       'or provide a live serve.pid*.json announce')
    sock = socket.create_connection(addr, timeout=self._timeout)
    sock.settimeout(self._timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
      _send_frame(sock, {'op': 'hello', 'pid': os.getpid()})
      reply, _ = _recv_frame(sock)
      if reply.get('op') != 'ok':
        raise ProtocolError(f'bad hello reply {reply!r}')
    except BaseException:
      sock.close()
      raise
    self._sock = sock
    return sock

  def _close(self, say_bye=False):
    if self._sock is None:
      return
    try:
      if say_bye:
        _send_frame(self._sock, {'op': 'bye'})
    except OSError:
      pass  # session teardown is best-effort by definition
    try:
      self._sock.close()
    except OSError:
      pass
    self._sock = None

  def _server_back(self):
    """Cheap liveness probe for degraded mode: can we complete a hello?"""
    try:
      self._ensure_sock()
      return True
    except (ServerLost, OSError, ProtocolError):
      self._close()
      return False

  # -- degraded mode

  def _local_loader(self):
    if self._factory is None:
      raise ServerLost(
          'data server lost and no local fallback factory configured')
    if self._local is None:
      from .workers import _resolve_factory
      self._local = _resolve_factory(self._factory)(**self._kwargs)
    return self._local

  def _local_phase(self, epoch, state, claimer):
    """Serve this client's share from the local loader, preserving the
    deterministic position, until the epoch completes or the server
    answers again."""
    loader = self._local_loader()
    # Byte-exact from the frontier: a plain mid-epoch seek has resume
    # semantics in the binned loaders (their shuffle buffer restarts
    # fresh), so its batches would differ from the server's
    # uninterrupted stream.
    loader.seek(epoch, state.frontier, exact=True)
    probe_every = reattach_every()
    n = 0
    last = state.frontier - 1
    for step, batch in loader.iter_steps((0, 1)):
      last = step
      if claimer is not None and not self._win_locally(epoch, step,
                                                       claimer):
        continue
      if claimer is None and step in state.local_done:
        continue
      yield step, batch
      self._mark_delivered(epoch, step, state, claimer, ack=False)
      n += 1
      if probe_every and n % probe_every == 0 and self._server_back():
        self._reattaches_c.add(1)
        state.frontier = step + 1
        return 'reattached'
    state.end = last + 1 if state.end is None else state.end
    if claimer is not None:
      yield from self._residual_local(epoch, state, claimer)
    return 'done'

  def _win_locally(self, epoch, step, claimer):
    """Claim ``step`` for local delivery; a live foreign lease blocks
    (bounded by the owner's heartbeat staleness) so the sequential
    local replay never has to rewind past a batch a peer still owns."""
    while True:
      claimer.refresh(epoch)
      if claimer.is_resolved(epoch, step):
        return False
      if claimer.claim(epoch, step):
        return True
      if not claimer.observe(epoch, (step,)):
        time.sleep(_POLL)

  def _residual_local(self, epoch, state, claimer):
    """After the sequential local pass: pick up partitions a dead peer
    claimed but never manifested (the local-mode analog of the
    server-side re-serve)."""
    while True:
      claimer.refresh(epoch)
      missing = [gi for gi in range(state.end)
                 if not claimer.is_resolved(epoch, gi)]
      if not missing:
        return
      opened = claimer.observe(epoch, missing)
      won = [gi for gi in missing if claimer.claim(epoch, gi)]
      if won:
        for gi, batch in self._local_batches(epoch, won):
          yield gi, batch
          self._mark_delivered(epoch, gi, state, claimer, ack=False)
      elif not opened:
        time.sleep(_POLL)

  def _local_batches(self, epoch, gis):
    """Replay exactly ``gis`` from a fresh local loader (deterministic
    ``f(epoch, gi)`` like every re-execution in this codebase)."""
    from .workers import _resolve_factory
    wanted = set(gis)
    loader = _resolve_factory(self._factory)(**self._kwargs)
    loader.seek(epoch, min(wanted), exact=True)
    for step, batch in loader.iter_steps((0, 1)):
      if step in wanted:
        yield step, batch
        wanted.discard(step)
        if not wanted:
          return


# ---------------------------------------------------------------------------
# the data-server CLI (python -m lddl_tpu_torch.loader.service)


def attach_args(parser):
  parser.add_argument('--path', default=None,
                      help='balanced shard directory to serve (BERT '
                           'pretrain loader)')
  parser.add_argument('--vocab-file', default=None)
  parser.add_argument('--batch-size', type=int, default=64)
  parser.add_argument('--bin-size', type=int, default=None)
  parser.add_argument('--max-seq-length', type=int, default=512)
  parser.add_argument('--base-seed', type=int, default=12345)
  parser.add_argument('--masking', default='static',
                      choices=('static', 'dynamic'))
  parser.add_argument('--synthetic', action='store_true',
                      help='serve the SyntheticBatchLoader stream '
                           '(transport tests / benches)')
  parser.add_argument('--steps', type=int, default=256,
                      help='steps per epoch in --synthetic mode')
  parser.add_argument('--factory', default=None, metavar='MODULE:ATTR',
                      help='serve an arbitrary loader factory')
  parser.add_argument('--kwargs-json', default='{}',
                      help='JSON kwargs for --factory')
  parser.add_argument('--host', default='127.0.0.1')
  parser.add_argument('--port', type=int, default=0,
                      help='0 = ephemeral (announce file tells clients)')
  parser.add_argument('--window', type=int, default=None,
                      help=f'batch window (default env {_WINDOW_ENV} '
                           'or 8)')
  parser.add_argument('--epochs', type=int, default=None,
                      help='serve this many epochs then exit '
                           '(default: until signalled)')
  parser.add_argument('--lease-dir', default=None,
                      help='rendezvous dir of the clients\' comm '
                           'backend: enables manifest-driven trimming '
                           'and dead-client re-serve')
  parser.add_argument('--run-id', default=None,
                      help='comm run id the clients use (default '
                           'LDDL_COMM_RUN_ID or run0)')
  parser.add_argument('--announce-dir', default=None,
                      help='where serve.pid<P>.json lands (default '
                           'LDDL_MONITOR_DIR / LDDL_TELEMETRY_DIR)')
  return parser


def _build_loader(args):
  if args.synthetic:
    from ..testing import SyntheticBatchLoader
    return SyntheticBatchLoader(batch_size=args.batch_size,
                                seq_len=args.max_seq_length,
                                steps=args.steps)
  if args.factory:
    import importlib
    module, _, attr = args.factory.partition(':')
    fn = getattr(importlib.import_module(module), attr)
    return fn(**json.loads(args.kwargs_json))
  if not args.path:
    raise SystemExit('data server: need --path, --synthetic, or --factory')
  from ..comm import NullBackend
  from .bert import get_bert_pretrain_data_loader
  return get_bert_pretrain_data_loader(
      args.path, batch_size_per_rank=args.batch_size,
      vocab_file=args.vocab_file, bin_size=args.bin_size,
      max_seq_length=args.max_seq_length, base_seed=args.base_seed,
      masking=args.masking, comm=NullBackend())


def _build_store(args):
  if not args.lease_dir:
    return None
  from ..comm.backend import FileLeaseStore
  run_id = args.run_id or os.environ.get('LDDL_COMM_RUN_ID', 'run0')
  root = os.path.join(args.lease_dir, f'{run_id}.elastic.serve')
  # The server only lists/reads manifests; rank -1 can never win a CAS
  # against a real client.
  return FileLeaseStore(root, rank=-1)


def main(args=None):
  """Serve a loader's batch stream until the epoch budget runs out or
  SIGTERM/SIGINT lands (clean announce teardown either way)."""
  parser = attach_args(argparse.ArgumentParser(
      description=__doc__.split('\n\n')[0],
      formatter_class=argparse.RawDescriptionHelpFormatter))
  args = parser.parse_args(args)
  from ..telemetry.server import maybe_start_monitor
  maybe_start_monitor(0)
  server = DataServer(_build_loader(args), host=args.host, port=args.port,
                      window=args.window, lease_store=_build_store(args),
                      announce_dir=args.announce_dir, epochs=args.epochs)
  stop = threading.Event()
  for sig in (signal.SIGTERM, signal.SIGINT):
    signal.signal(sig, lambda *_: stop.set())
  server.start()
  print(f'lddl-data-server: serving on {server.url} '
        f'(pid {os.getpid()})', flush=True)
  try:
    while not stop.is_set():
      if args.epochs is not None:
        with server._lock:
          done = len(server._epoch_end) >= args.epochs and \
              not server._buf
        if done:
          break
      stop.wait(0.5)
  finally:
    server.stop()
  return 0


if __name__ == '__main__':
  import sys
  sys.exit(main())
