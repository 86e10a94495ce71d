"""Host-level collective communication backends.

A copy of :mod:`lddl_tpu.comm.backend` with its JAX runtime replaced by
``torch.distributed``. The collectives carry *control and metadata*
(rank topology, telemetry snapshots, ledger signals, checkpoint
barriers), never bulk data: the train step's gradient all-reduce runs on
the mesh's data group (:mod:`lddl_tpu_torch.parallel.train`).

  - :class:`NullBackend`: a single-process world;
  - :class:`FileBackend`: a dependency-free shared-filesystem rendezvous
    (pid-beacon death probe, garbage-collected op files), copied as it
    is; its ranks are independent single-process worlds;
  - :class:`TorchDistBackend`: the counterpart of ``JaxProcessBackend``,
    collectives over a ``torch.distributed`` process group
    (:func:`ensure_torch_distributed`) and leases over the group's
    ``TCPStore`` (:class:`StoreLeaseStore`, the counterpart of
    ``KVLeaseStore``).
"""

import os
import pickle
import random
import tempfile
import threading
import time

import numpy as np

from ..core import faults
from ..telemetry import get_telemetry
from ..telemetry.trace import get_tracer


def comm_timeout(default=120.0):
  """Collective timeout in seconds (env ``LDDL_COMM_TIMEOUT``)."""
  try:
    return float(os.environ.get('LDDL_COMM_TIMEOUT', default))
  except ValueError:
    return default


def comm_heartbeat_interval(default=1.0):
  """Liveness cadence in seconds (env ``LDDL_COMM_HEARTBEAT``): how often
  FileBackend probes a silent peer's death beacon while waiting, and how
  often the executor's lease heartbeat pump republishes its counter.
  Probing more or less often changes only failure-detection latency,
  never any result."""
  try:
    return max(0.05, float(os.environ.get('LDDL_COMM_HEARTBEAT', default)))
  except ValueError:
    return default


def _retry_io(fn, what, retries=3, base_delay=0.01):
  """Run ``fn()`` retrying transient ``OSError`` with bounded backoff.

  Shared filesystems (the FileBackend's whole substrate) throw spurious
  EIO/ESTALE/ENOENT during rename races and NFS attribute-cache misses;
  one failed stat must not abort a run the lease protocol could finish.
  Bounded: a persistent error still surfaces, with the original
  traceback, after ``retries`` attempts.
  """
  for attempt in range(retries + 1):
    try:
      return fn()
    except OSError:
      if attempt == retries:
        raise
      get_telemetry().counter('comm.io_retries').add(1)
      time.sleep(base_delay * (2 ** attempt))


def jitter_source(seed=None):
  """A dedicated, seeded ``random.Random`` for retry jitter.

  Backoff jitter must never touch the global RNG (data order is
  deterministic by contract) and must still differ across processes so
  a thundering herd decorrelates — seeding from the pid gives both.
  """
  return random.Random(os.getpid() if seed is None else seed)


def backoff_delay(attempt, base=0.05, cap=2.0, jitter=None):
  """Exponential backoff delay for retry ``attempt`` (0-based), capped,
  with optional multiplicative jitter in [0.5, 1.5) drawn from a
  :func:`jitter_source`. Jitter changes only retry *timing* — every
  delay stays within [0.5 * base, 1.5 * cap] — never any result."""
  delay = min(cap, base * (2 ** attempt))
  if jitter is not None:
    delay *= 0.5 + jitter.random()
  return delay


class LeaseStaleness:
  """The fleet-wide lease-revocation verdict, factored for every lease
  consumer (the elastic executor's ``_LeaseClaimer``, the data
  service's ``_ServeClaimer``).

  An owner is stale when the substrate proves it dead (pid beacon) or
  its heartbeat *counter* has not moved for the lease timeout measured
  on the observer's own monotonic clock — counters, not timestamps, so
  cross-host clock skew can never manufacture a revocation.
  """

  def __init__(self, store, timeout):
    self._store = store
    self._timeout = timeout
    self._hb_seen = {}  # owner -> (counter value, monotonic when it changed)

  def stale(self, owner):
    if self._store.owner_dead(owner):
      return True  # positive death signal: no need to wait out the lease
    hb = self._store.read_heartbeat(owner)
    now = time.monotonic()
    prev = self._hb_seen.get(owner)
    if prev is None or prev[0] != hb:
      self._hb_seen[owner] = (hb, now)
      return False
    # Lease staleness: survivors revoke only on a heartbeat counter silent
    # past the lease timeout (or the positive death probe above). Racing
    # observers converge on the same verdict via the revoke CAS, and
    # re-execution is idempotent — outputs are f(task, global_index)
    # behind atomic renames — so clock skew can cost duplicated work,
    # never divergent bytes.
    return now - prev[1] > self._timeout


class CommBackend:
  """Protocol: rank/world_size + tiny-metadata collectives."""

  #: Whether the elastic lease-claimed executor path should use this
  #: backend's lease store by default (LDDL_ELASTIC=auto). True only
  #: where the claim/heartbeat substrate is first-class (FileBackend).
  elastic_default = False

  @property
  def has_lease_store(self):
    """Whether :meth:`lease_store` gives a store (without making one)."""
    return False

  def lease_store(self, namespace):
    """A :class:`LeaseStore` over this backend's substrate for one map
    phase (``namespace`` must be identical across ranks), or None when
    the backend has no CAS/KV substrate — the executor then falls back
    to the static stride."""
    return None

  @property
  def rank(self):
    raise NotImplementedError

  @property
  def world_size(self):
    raise NotImplementedError

  def allgather_object(self, obj):
    """Gather one picklable object per rank; returns list ordered by rank."""
    raise NotImplementedError

  @property
  def collective_seq(self):
    """Monotonic count of collectives issued so far, or None if the
    backend does not sequence them. The same counter trace alignment
    keys on — consumers tagging gathered payloads with it can reject
    entries from mismatched rounds."""
    return None

  def allreduce_sum(self, array):
    """Element-wise sum of a small numpy array across ranks."""
    arrays = self.allgather_object(np.asarray(array))
    out = arrays[0].copy()
    for a in arrays[1:]:
      out += a
    return out

  def broadcast_object(self, obj, root=0):
    return self.allgather_object(obj)[root]

  def barrier(self):
    self.allgather_object(None)


class NullBackend(CommBackend):
  """Single-process world."""

  @property
  def rank(self):
    return 0

  @property
  def world_size(self):
    return 1

  def allgather_object(self, obj):
    return [obj]

  def barrier(self):
    pass


class FileBackend(CommBackend):
  """Shared-filesystem rendezvous collectives.

  Each collective op gets a monotonically increasing sequence number; rank r
  writes ``op<seq>.rank<r>`` and spin-waits for all peers. Files are written
  atomically (tmp + rename) so partially-written payloads are never read.
  The wait for a peer counts its poll sleeps against the timeout and the
  liveness cadence (the JAX backend reads the clock there): no branch
  here depends on a clock reading.
  Intended for local multi-process tests and small CPU clusters with a
  shared FS — a torch.distributed world uses :class:`TorchDistBackend`.
  """

  elastic_default = True

  def __init__(self, rendezvous_dir, rank, world_size, timeout=None,
               poll_interval=0.005, run_id=None):
    self._dir = rendezvous_dir
    os.makedirs(rendezvous_dir, exist_ok=True)
    self._rank = rank
    self._world_size = world_size
    # Explicit ctor args win; otherwise env-tunable (LDDL_COMM_TIMEOUT /
    # LDDL_COMM_HEARTBEAT) so a slow shared mount can stretch both the
    # collective deadline and the liveness cadence without code changes.
    self._timeout = comm_timeout() if timeout is None else timeout
    self._liveness_interval = comm_heartbeat_interval()
    self._poll = poll_interval
    self._seq = 0
    self._gc_upto = 0  # own op files below this seq have been deleted
    # Namespace op files by run id so a reused rendezvous dir (e.g. after a
    # crash/restart) never reads a previous run's stale payloads. All ranks
    # of one run must agree on run_id (env LDDL_COMM_RUN_ID, or a job id).
    self._run_id = run_id if run_id is not None else os.environ.get(
        'LDDL_COMM_RUN_ID', 'run0')
    # Liveness beacon: pid@pidns@starttime, written once. Peers in the
    # SAME pid namespace use it to fail fast (naming the dead rank) when
    # a rank is SIGKILLed mid-run instead of stalling until the
    # collective timeout. The pid-namespace token (readlink of
    # /proc/self/ns/pid) — not the hostname — gates the probe: two
    # containers or cloned VMs sharing a rendezvous mount can share a
    # hostname while their pids are mutually meaningless, which would
    # make a hostname-gated probe kill healthy runs. The process start
    # time (field 22 of /proc/<pid>/stat) detects pid reuse. Cross-
    # namespace peers rely on the timeout, as before.
    self._pidns = self._pid_namespace()
    self._starttime = self._pid_starttime(os.getpid())
    self._write_atomic(
        f'{os.getpid()}@{self._pidns}@{self._starttime}'.encode(),
        self._alive_path(self._rank))

  @property
  def rank(self):
    return self._rank

  @property
  def world_size(self):
    return self._world_size

  @property
  def collective_seq(self):
    return self._seq

  def _path(self, seq, rank):
    return os.path.join(self._dir, f'{self._run_id}.op{seq}.rank{rank}')

  def _progress_path(self, rank):
    return os.path.join(self._dir, f'{self._run_id}.progress.rank{rank}')

  def _alive_path(self, rank):
    return os.path.join(self._dir, f'{self._run_id}.alive.rank{rank}')

  @staticmethod
  def _pid_namespace():
    """Identity of this process's pid namespace ('' when unavailable —
    then the beacon never gates a probe and the timeout rules)."""
    try:
      return os.readlink('/proc/self/ns/pid')
    except OSError:
      return ''

  @staticmethod
  def _pid_starttime(pid):
    """Kernel start time of ``pid`` (clock ticks since boot; field 22 of
    /proc/<pid>/stat), or '' when unreadable. Distinguishes a reused pid
    from the original process."""
    try:
      with open(f'/proc/{pid}/stat', 'rb') as f:
        data = f.read()
      return data[data.rfind(b')') + 2:].split()[19].decode()
    except (OSError, IndexError):
      return ''

  @classmethod
  def _pid_dead(cls, pid, starttime):
    """Positive death signal for a pid in our namespace: process gone,
    a zombie (SIGKILLed but not yet reaped by its launcher —
    ``kill(pid, 0)`` still succeeds on zombies, so read the /proc state
    instead), or a different process now wearing the pid (start-time
    mismatch). Any probe uncertainty returns False (timeout backstops).
    """
    try:
      with open(f'/proc/{pid}/stat', 'rb') as f:
        data = f.read()
    except FileNotFoundError:
      return True
    except OSError:
      return False
    tail = data[data.rfind(b')') + 2:].split()
    if tail and tail[0] == b'Z':
      return True
    return bool(starttime) and cls._pid_starttime(pid) not in ('', starttime)

  def peer_positively_dead(self, r):
    """Positive death probe for rank ``r`` via its liveness beacon: True
    only when the beacon names a same-pid-namespace process that is
    provably gone (or a zombie, or a reused pid). Missing beacon,
    foreign namespace, or any probe error all return False — absence of
    proof is never treated as death. Shared by the collective fail-fast
    path and the lease stores' stale-owner revocation."""
    try:
      with open(self._alive_path(r), 'rb') as f:
        pid_s, pidns, starttime = f.read().decode().split('@', 2)
      if not self._pidns or pidns != self._pidns or not pid_s.isdigit():
        return False
      return self._pid_dead(int(pid_s), starttime)
    except Exception:
      return False  # beacon unreadable / not started yet: timeout rules

  def _check_peer_alive(self, r, seq):
    """Raise (naming the rank) when a same-pid-namespace peer's process
    is dead. Only a *positive* death signal raises: a missing or
    foreign-namespace beacon, or any probe error, keeps the normal
    timeout path.
    """
    if self.peer_positively_dead(r):
      pid_s = self._beacon_pid(r)
      # Death is only an error if the peer died *without* publishing
      # this collective. A peer whose last act was writing its payload
      # for #seq and exiting cleanly (e.g. last rank of a finishing job)
      # races this probe: its file may have appeared between our stat
      # poll and this liveness check, so re-check before raising.
      if os.path.exists(self._path(seq, r)):
        return
      raise RuntimeError(
          f'rank {self._rank}: rank {r} (pid {pid_s}) died before '
          f'collective #{seq}; failing fast instead of waiting out the '
          f'{self._timeout:.0f}s timeout (dir={self._dir})')

  def _beacon_pid(self, r):
    """Rank ``r``'s beacon pid string, for error messages only ('?'
    when the beacon is unreadable)."""
    try:
      with open(self._alive_path(r), 'rb') as f:
        return f.read().decode().split('@', 2)[0]
    except (OSError, UnicodeDecodeError):
      return '?'

  def _write_atomic(self, payload, dst):

    def _attempt():
      # Inside the retry closure: an injected transient write error must
      # exercise the same bounded-backoff path a real EIO flap would.
      faults.inject('comm.write', rank=self._rank)
      fd, tmp = tempfile.mkstemp(dir=self._dir)
      with os.fdopen(fd, 'wb') as f:
        f.write(payload)
      os.rename(tmp, dst)

    _retry_io(_attempt, f'atomic write {os.path.basename(dst)}')

  def _read_payload(self, path):
    """Read a published payload file, retrying transient filesystem
    errors. The file provably exists (we stat-polled it into view), so
    even a mid-rename ENOENT flap on NFS is transient, not absence."""

    def _attempt():
      with open(path, 'rb') as f:
        return f.read()

    return pickle.loads(
        _retry_io(_attempt, f'payload read {os.path.basename(path)}'))

  def _collect_garbage(self, seq):
    """Delete this rank's op files that no peer can still need.

    A peer whose progress marker reads ``s`` has *completed* every
    collective below ``s`` (it writes the marker before publishing its
    payload for ``s``), so it will never re-read files of seq < s. Each
    rank deletes only its own files, so deletion races cannot occur.
    Without this, a long run grows one file per rank per collective
    forever.
    """
    min_seq = seq
    for r in range(self._world_size):
      if r == self._rank:
        continue
      try:
        with open(self._progress_path(r), 'rb') as f:
          min_seq = min(min_seq, int(f.read()))
      except (OSError, ValueError):
        return  # peer not started yet (or marker mid-rename): nothing safe
    for s in range(self._gc_upto, min_seq):
      try:
        os.remove(self._path(s, self._rank))
      except OSError:
        pass
    self._gc_upto = max(self._gc_upto, min_seq)

  def allgather_object(self, obj):
    tele = get_telemetry()
    tracer = get_tracer()
    t_start = time.monotonic() if (tele.enabled or tracer.enabled) else 0.0
    seq = self._seq
    self._seq += 1
    # Publish progress (highest collective this rank has *entered* — all
    # below are fully read) before the payload, then reap dead files.
    self._write_atomic(str(seq).encode(), self._progress_path(self._rank))
    self._collect_garbage(seq)
    self._write_atomic(pickle.dumps(obj), self._path(seq, self._rank))
    results = []
    waited = 0.0  # seconds slept waiting, against the timeout
    for r in range(self._world_size):
      p = self._path(seq, r)
      # Exponential backoff from the base poll up to 50 ms: N waiting
      # ranks each stat-polling every 5 ms measurably steals CPU from the
      # ranks still working when cores are scarce (an 8-process run on
      # one core spent most of its wall-clock here); long waits back off,
      # short waits stay snappy.
      delay = self._poll
      since_probe = 0.0
      while not os.path.exists(p):
        # Timeout detection only aborts a stuck collective (raises); it
        # never silently diverges ranks.
        if waited > self._timeout:
          raise TimeoutError(
              f'rank {self._rank}: timed out waiting for rank {r} at '
              f'collective #{seq} (dir={self._dir})')
        # Probing more or less often changes only failure latency.
        if since_probe >= self._liveness_interval:
          self._check_peer_alive(r, seq)  # cheap: one stat + /proc read
          since_probe = 0.0
        time.sleep(delay)
        waited += delay
        since_probe += delay
        # Never poll faster than the configured interval: backoff only
        # coarsens waits, it must not override a deliberately slow poll
        # (e.g. a rendezvous dir on NFS).
        delay = min(delay * 2, max(self._poll, 0.05))
      results.append(self._read_payload(p))
    if tele.enabled:
      # Collective latency includes peer wait, so cross-rank spread here
      # is the straggler signal the report surfaces per rank.
      tele.histogram('comm.allgather_seconds').observe(
          time.monotonic() - t_start)
      tele.counter('comm.allgathers').add(1)
    if tracer.enabled:
      # The seq number keys cross-rank event matching: all ranks finish
      # collective #seq within one collective latency, so the trace
      # merger refines per-rank clock offsets from these events.
      tracer.complete('comm.allgather', t_start,
                      time.monotonic() - t_start, args={'seq': seq})
    return results

  has_lease_store = True

  def lease_store(self, namespace):
    """Lease/claim substrate for one elastic map phase, rooted at
    ``<rendezvous>/<run_id>.elastic.<namespace>/``. Keyed on run_id like
    the op files: restarting with the same run_id *resumes* (completion
    manifests from the previous incarnation are honored), a fresh run_id
    starts clean."""
    root = os.path.join(self._dir, f'{self._run_id}.elastic.{namespace}')
    return FileLeaseStore(root, self._rank,
                          dead_probe=self.peer_positively_dead)


class LeaseStore:
  """Claim/heartbeat/manifest primitives for one elastic map phase.

  Key grammar (shared by both implementations; ``gi`` = global task
  index, ``gen`` = revocation generation)::

    claim.<gi>.g<gen>   ascii owner rank       CAS: first writer wins
    revoke.<gi>.g<gen>  ascii revoker rank     CAS: invalidates <gen>
    done.<gi>           pickled task result    idempotent atomic publish
    hb.rank<r>          ascii counter          mutable heartbeat

  Claims and revokes are write-once (CAS) so every rank agrees on one
  owner per (gi, gen) and one revocation winner; ``done`` manifests and
  heartbeats are idempotent overwrites. Values never need deletion
  within a phase — a namespace is cheap and garbage-collects with its
  rendezvous directory / coordination service.
  """

  rank = 0
  #: Directory workers can publish ``done.<gi>`` manifests into via the
  #: write-back-ordered path (None: only the parent process can publish).
  manifest_root = None

  def try_claim(self, key):
    """Atomically create ``key`` owned by this rank. Returns None on
    success (we own it) or the owning rank (>= 0; -1 when the owner is
    momentarily unreadable)."""
    raise NotImplementedError

  def publish(self, key, payload):
    """Idempotent atomic write of ``payload`` (bytes) at ``key``."""
    raise NotImplementedError

  def read(self, key):
    """Payload bytes at ``key``, or None when absent."""
    raise NotImplementedError

  def list(self, prefix):
    """Sorted keys in this namespace starting with ``prefix``."""
    raise NotImplementedError

  def heartbeat(self, value):
    self.publish(f'hb.rank{self.rank}', str(int(value)).encode())

  def read_heartbeat(self, r):
    raw = self.read(f'hb.rank{r}')
    try:
      return None if raw is None else int(raw)
    except ValueError:
      return None

  def owner_dead(self, r):
    """Positive-signal death probe for rank ``r`` (False when the
    substrate cannot prove death — staleness timeouts then rule)."""
    return False


class HeartbeatPump:
  """Background lease heartbeat for one elastic phase or train fleet.

  Republishes a monotonically increasing counter every interval while
  the rank executes — the main thread may block for minutes inside pool
  waits or compiled train steps, so liveness cannot ride the claim or
  collective traffic itself. The value is a counter, not a timestamp:
  observers measure staleness of an *unchanging* counter on their own
  clock, so cross-host clock skew can never manufacture a revocation.

  ``fault_site``: optional :mod:`lddl_tpu_torch.core.faults` site injected
  inside the republish attempt (the train membership pump passes
  ``train.heartbeat``), so kill-style specs can silence a rank's
  liveness and raise-style specs exercise the absorbed-transient path
  a flaky substrate would.
  """

  def __init__(self, store, interval, fault_site=None):
    self._store = store
    self._interval = interval
    self._fault_site = fault_site
    self._stop = threading.Event()
    self._beats = 0
    self._beats_lock = threading.Lock()
    # First beat lands before any claim this rank makes: a peer that
    # sees our claim can always already see a heartbeat to age.
    self._store.heartbeat(0)
    self._thread = threading.Thread(
        target=self._run, name='lddl-lease-hb', daemon=True)
    self._thread.start()

  @property
  def beats(self):
    """Beats published since the first: the pump's logical clock."""
    with self._beats_lock:
      return self._beats

  def _run(self):
    while not self._stop.wait(self._interval):
      with self._beats_lock:
        self._beats += 1
        beat = self._beats
      try:
        if self._fault_site:
          faults.inject(self._fault_site,
                        rank=getattr(self._store, 'rank', 0))
        self._store.heartbeat(beat)
      except OSError:
        continue  # transient substrate flap: the next beat retries

  def stop(self):
    self._stop.set()
    self._thread.join(timeout=5.0)


class FileLeaseStore(LeaseStore):
  """Shared-filesystem lease store: one flat directory per phase.

  CAS is ``os.link(tmp, dst)`` — atomic create-*with*-content, so a
  reader that wins the EEXIST race never observes an empty claim file
  (an O_EXCL-create-then-write scheme would have that window). All
  writes ride the same bounded transient-error retry as the collective
  substrate.
  """

  def __init__(self, root, rank, dead_probe=None):
    self.root = root
    self.rank = rank
    self.manifest_root = root
    self._dead_probe = dead_probe
    os.makedirs(root, exist_ok=True)

  def _p(self, key):
    return os.path.join(self.root, key)

  def try_claim(self, key):
    dst = self._p(key)

    def _attempt():
      fd, tmp = tempfile.mkstemp(dir=self.root)
      try:
        with os.fdopen(fd, 'wb') as f:
          f.write(str(self.rank).encode())
        try:
          os.link(tmp, dst)
          return None
        except FileExistsError:
          return self._read_owner(dst)
      finally:
        os.unlink(tmp)

    return _retry_io(_attempt, f'claim {key}')

  def _read_owner(self, dst):
    def _attempt():
      with open(dst, 'rb') as f:
        return f.read()
    try:
      return int(_retry_io(_attempt, 'claim owner read').decode())
    except (OSError, ValueError, UnicodeDecodeError):
      return -1  # owner momentarily unreadable: foreign, identity unknown

  def publish(self, key, payload):
    dst = self._p(key)

    def _attempt():
      fd, tmp = tempfile.mkstemp(dir=self.root)
      with os.fdopen(fd, 'wb') as f:
        f.write(payload)
      os.rename(tmp, dst)

    _retry_io(_attempt, f'publish {key}')

  def read(self, key):
    path = self._p(key)

    def _attempt():
      try:
        with open(path, 'rb') as f:
          return f.read()
      except FileNotFoundError:
        return None  # absence is an answer, not a transient error

    return _retry_io(_attempt, f'read {key}')

  def list(self, prefix):
    return _retry_io(
        lambda: sorted(
            n for n in os.listdir(self.root) if n.startswith(prefix)),
        f'list {prefix}')

  def owner_dead(self, r):
    return bool(self._dead_probe and self._dead_probe(r))




class StoreLeaseStore(LeaseStore):
  """Lease store over a ``torch.distributed`` key-value store (the
  process group's ``TCPStore``): the counterpart of the JAX package's
  ``KVLeaseStore`` over the coordination service.

  :meth:`try_claim` is ``compare_set(key, '', rank)``, which writes only
  when the key is absent and returns the value the key holds after the
  call. A key the store already held returns its owner, so a repeated
  claim by the winner reads as a foreign owner, as in
  :class:`FileLeaseStore`: the store is checked first, and a value equal
  to this rank's counts as a win only when the key was absent then. No
  cross-host pid probe exists, so :meth:`owner_dead` defers to heartbeat
  staleness.

  The store cannot list keys by prefix. The index: every key is appended,
  with a newline, to the namespace's one ``.index`` key (``Store.append``,
  atomic on the store's server) before its value is first written, so
  :meth:`list` sees every key that holds a value; each process appends a
  key once, and the listing drops repeats.
  """

  def __init__(self, store, namespace, rank):
    self._store = store
    self._pfx = f'lddl/el/{namespace}/'
    self._index = self._pfx + '.index'
    self._indexed = set()
    self.rank = rank

  def _note(self, key):
    if key not in self._indexed:
      self._store.append(self._index, (key + '\n').encode())
      self._indexed.add(key)

  def _has(self, key):
    return self._store.check([self._pfx + key])

  def try_claim(self, key):
    if not self._has(key):
      self._note(key)
      mine = str(self.rank).encode()
      got = bytes(self._store.compare_set(self._pfx + key, b'', mine))
      if got == mine:
        return None
    return self._owner(key)

  def _owner(self, key):
    raw = self.read(key)
    try:
      return -1 if raw is None else int(raw)
    except ValueError:
      return -1

  def publish(self, key, payload):
    self._note(key)
    self._store.set(self._pfx + key, bytes(payload))

  def read(self, key):
    # get() blocks until a key exists; keys are never deleted, so a key
    # that check() saw stays readable.
    if not self._has(key):
      return None
    return bytes(self._store.get(self._pfx + key))

  def list(self, prefix):
    if not self._store.check([self._index]):
      return []
    keys = bytes(self._store.get(self._index)).decode().split('\n')
    return sorted({k for k in keys if k and k.startswith(prefix)})


def cuda_backend_default():
  """The process group's backend for CUDA tensors: ``nccl`` unless env
  ``LDDL_DIST_CUDA_BACKEND`` names another (``gloo``: ranks that share
  one card, which NCCL refuses; its collectives stage through host
  memory and cannot be captured into a CUDA graph)."""
  return os.environ.get('LDDL_DIST_CUDA_BACKEND', '').strip() or 'nccl'


def _rendezvous_env():
  """``(init_method, world_size, rank)`` from the environment, or None.

  ``torch.distributed.run`` sets ``MASTER_ADDR``/``MASTER_PORT``/
  ``RANK``/``WORLD_SIZE``; the JAX package's explicit config,
  ``LDDL_COORDINATOR_ADDRESS`` (host:port) / ``LDDL_NUM_PROCESSES`` /
  ``LDDL_PROCESS_ID``, is honoured too and wins when both are set.
  """
  addr = os.environ.get('LDDL_COORDINATOR_ADDRESS')
  if addr:
    return (f'tcp://{addr}', int(os.environ['LDDL_NUM_PROCESSES']),
            int(os.environ['LDDL_PROCESS_ID']))
  if 'MASTER_ADDR' in os.environ and 'RANK' in os.environ:
    return ('env://', int(os.environ['WORLD_SIZE']),
            int(os.environ['RANK']))
  return None


def ensure_torch_distributed():
  """Initialize the default ``torch.distributed`` process group once
  (idempotent), the counterpart of ``ensure_jax_distributed``.

  Resolution order:
    1. already initialized: no-op;
    2. the launcher's or the explicit environment
       (:func:`_rendezvous_env`): a failure here raises;
    3. neither: the process continues single-process with a warning,
       as a JAX process does when no cluster is detected.

  The group is ``cpu:gloo,cuda:<cuda_backend_default()>``, so CPU
  tensors, object collectives and barriers ride gloo and CUDA tensors
  NCCL; a build without CUDA makes a gloo group. Its collectives time
  out after :func:`comm_timeout`. Returns True when the multi-process
  runtime is up.
  """
  import torch
  import torch.distributed as dist
  if dist.is_initialized():
    return True
  found = _rendezvous_env()
  if found is None:
    import warnings
    warnings.warn('torch.distributed: no MASTER_ADDR/RANK or '
                  'LDDL_COORDINATOR_ADDRESS in the environment; continuing '
                  'single-process')
    return False
  init_method, world, rank = found
  backend = 'gloo'
  if torch.cuda.is_available():
    backend = f'cpu:gloo,cuda:{cuda_backend_default()}'
  import datetime
  dist.init_process_group(backend, init_method=init_method,
                          world_size=world, rank=rank,
                          timeout=datetime.timedelta(seconds=comm_timeout()))
  return True


class TorchDistBackend(CommBackend):
  """Host-level collectives over a ``torch.distributed`` process group.

  Construction initializes the default group through
  :func:`ensure_torch_distributed` (idempotent), so ``--comm torch`` in
  the CLI is enough: no separate bootstrap call. Objects and numpy
  arrays travel as CPU tensors, so every collective here rides gloo,
  whatever the group uses for CUDA tensors. Without a launcher's
  environment the backend is a single-process world, as
  ``JaxProcessBackend`` is on a lone host.
  """

  def __init__(self):
    import torch.distributed as dist
    self._dist = dist
    # Collective sequence number, for trace-event matching across ranks
    # (every rank issues the same collective sequence by construction).
    self._seq = 0
    self.group = dist.group.WORLD if ensure_torch_distributed() else None

  @property
  def rank(self):
    return 0 if self.group is None else self._dist.get_rank(self.group)

  @property
  def world_size(self):
    return 1 if self.group is None else self._dist.get_world_size(self.group)

  @property
  def collective_seq(self):
    return self._seq

  @property
  def has_lease_store(self):
    return self.group is not None and self.world_size > 1

  def lease_store(self, namespace):
    """A :class:`StoreLeaseStore` over the default group's store, or
    None in a single-process world (nothing to lease)."""
    if not self.has_lease_store:
      return None
    from torch.distributed import distributed_c10d
    return StoreLeaseStore(distributed_c10d._get_default_store(), namespace,
                           self.rank)

  def _timed(self, what, fn):
    tele = get_telemetry()
    tracer = get_tracer()
    t_start = time.monotonic() if (tele.enabled or tracer.enabled) else 0.0
    seq = self._seq
    self._seq += 1
    out = fn()
    if tele.enabled:
      tele.histogram(f'comm.{what}_seconds').observe(
          time.monotonic() - t_start)
      tele.counter(f'comm.{what}s').add(1)
    if tracer.enabled:
      tracer.complete(f'comm.{what}', t_start, time.monotonic() - t_start,
                      args={'seq': seq})
    return out

  def allgather_object(self, obj):
    if self.group is None:
      return [obj]

    def gather():
      out = [None] * self.world_size
      self._dist.all_gather_object(out, obj, group=self.group)
      return out

    return self._timed('allgather', gather)

  def allreduce_sum(self, array):
    """Element-wise sum through the group's all-reduce, on a CPU tensor
    (gloo); dtypes torch has no tensor for (unsigned above 8 bits) sum
    over an all-gather instead."""
    import torch
    array = np.asarray(array)
    if self.group is None:
      return array.copy()
    try:
      t = torch.from_numpy(np.ascontiguousarray(array).copy())
    except TypeError:
      return super().allreduce_sum(array)
    if t.dtype in (torch.uint16, torch.uint32, torch.uint64):
      return super().allreduce_sum(array)
    self._timed('allreduce',
                lambda: self._dist.all_reduce(t, group=self.group))
    return t.numpy()

  def broadcast_object(self, obj, root=0):
    if self.group is None:
      return obj
    box = [obj]
    self._timed('broadcast', lambda: self._dist.broadcast_object_list(
        box, src=root, group=self.group))
    return box[0]

  def barrier(self):
    if self.group is None:
      return
    # Through the group's CPU backend (gloo): the group serves barriers
    # on the CPU whenever it has one.
    self._timed('barrier', lambda: self._dist.barrier(group=self.group))


def get_backend(name=None, **kwargs):
  """Construct a backend by name (default from ``LDDL_COMM`` env, else
  null).

  Names: ``null`` | ``file`` | ``torch`` (the JAX package's ``jax``).
  """
  name = name or os.environ.get('LDDL_COMM', 'null')
  if name == 'null':
    return NullBackend()
  if name == 'file':
    return FileBackend(
        kwargs.get('rendezvous_dir') or os.environ['LDDL_COMM_DIR'],
        kwargs.get('rank', int(os.environ.get('LDDL_RANK', '0'))),
        kwargs.get('world_size', int(os.environ.get('LDDL_WORLD_SIZE', '1'))),
        run_id=kwargs.get('run_id'),
    )
  if name == 'torch':
    return TorchDistBackend()
  raise ValueError(f'unknown comm backend {name!r}')
