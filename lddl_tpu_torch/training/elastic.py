"""Preemption-tolerant elastic training: the port of
:mod:`lddl_tpu.training.elastic`.

- :class:`AsyncCheckpointWriter`: checkpoint writes overlapped with
  compute on :class:`~lddl_tpu_torch.pipeline.pool.AsyncShardWriter`'s
  bounded-depth, first-error-wins write-back (``LDDL_ASYNC_CKPT``). The
  step loop only blocks at backpressure, and a lost background write
  surfaces as an exception on the next step.
- :class:`PreemptionGuard`: SIGTERM (or a maintenance-notice file,
  ``LDDL_PREEMPTION_FILE``) sets a flag the step loop checks at every
  step boundary; the loop then flushes the writer and lands one final
  synchronous checkpoint.
- :class:`RankMembership`: lease-store train-fleet membership on the
  comm layer's :class:`~lddl_tpu_torch.comm.HeartbeatPump` and its
  positive death probe. It detects a dead rank within a heartbeat
  interval (pid beacon on same-host worlds, counter staleness across
  hosts) and feeds the fleet's published progress signals through
  :func:`~lddl_tpu_torch.telemetry.live.straggler_scores` to a
  CAS-arbitrated verdict that sheds a sick rank instead of hanging on it.
- :func:`reseek_loader`: positions a loader at a restored
  ``samples_seen`` through its ``seek(epoch, batch_index)`` contract
  (the serial loaders and the worker-process
  :class:`~lddl_tpu_torch.loader.workers.MultiprocessLoader` alike).

The recovery policy is checkpoint-and-reform: a membership event or a
preemption stops every surviving rank at the next step boundary behind a
complete checkpoint, and the supervisor relaunches the fleet at any
world size; each rank rejoins by restoring that checkpoint, whose
``samples_seen`` is global and whose state is replicated.
"""

import json
import os
import signal
import threading
import time

from ..comm.backend import HeartbeatPump, comm_heartbeat_interval
from ..pipeline.pool import AsyncShardWriter, WriteBackError  # noqa: F401
from ..telemetry import get_telemetry


def elastic_train_enabled(comm):
  """Whether the train loop should run lease-based rank membership
  (env ``LDDL_ELASTIC_TRAIN``): '0'/'1' force it, unset/auto enables it
  only where the claim substrate is first-class (the backend's
  ``elastic_default``, today the FileBackend)."""
  v = os.environ.get('LDDL_ELASTIC_TRAIN', '').strip().lower()
  if v in ('0', 'false', 'off', 'no'):
    return False
  if v in ('1', 'true', 'on', 'yes'):
    return True
  return getattr(comm, 'elastic_default', False)


def shed_threshold():
  """Straggler score (fleet-median rate / own rate) at or above which
  the fleet sheds the slowest rank (env ``LDDL_SHED_SCORE``; 0/unset
  disables shedding — death detection alone never needs it)."""
  try:
    return max(0.0, float(os.environ.get('LDDL_SHED_SCORE', '0')))
  except ValueError:
    return 0.0


def reseek_loader(loader, samples_seen, dp_world=1):
  """Position ``loader`` at the global ``samples_seen`` counter via the
  public ``seek(epoch, batch_index)`` contract (copied from
  ``lddl_tpu/training/elastic.py:89-113``).

  A checkpoint's ``samples_seen`` is world-size-independent; each rank's
  loader continues from the matching ``(epoch, batch_index)``, the same
  arithmetic as :meth:`~lddl_tpu_torch.loader.binned.BinnedIterator.
  epoch_and_offset_of`. Returns the ``(epoch, batch_index)`` it seeked
  to, or None for a loader that carries no positioning contract (a raw
  iterable).
  """
  if loader is None or not hasattr(loader, 'seek'):
    return None
  global_batch = loader.batch_size * max(int(dp_world), 1)
  samples_per_epoch = loader.batches_per_epoch * global_batch
  if samples_per_epoch <= 0:
    return None
  epoch = samples_seen // samples_per_epoch
  index = (samples_seen % samples_per_epoch) // global_batch
  loader.seek(epoch, index)
  return epoch, index


def async_ckpt_enabled():
  """Background checkpoint write-back (env ``LDDL_ASYNC_CKPT``, default
  off: synchronous saves are the conservative baseline)."""
  return os.environ.get('LDDL_ASYNC_CKPT', '').strip().lower() in (
      '1', 'true', 'on', 'yes')


def _async_ckpt_depth():
  """Bounded queue depth for in-flight checkpoints (env
  ``LDDL_ASYNC_CKPT_DEPTH``, default 1: each queued save holds a full
  state snapshot in host memory, so depth is deliberately tiny)."""
  try:
    return max(1, int(os.environ.get('LDDL_ASYNC_CKPT_DEPTH', '1')))
  except ValueError:
    return 1


class AsyncCheckpointWriter(AsyncShardWriter):
  """Background checkpoint lane: the shard writer's overlap-and-flush
  discipline pointed at checkpoints.

  Jobs are whole checkpoint writes over a CPU snapshot of the state
  taken synchronously at submit time: the step (a replayed CUDA graph
  too) updates the parameters and moments in place, so the write cannot
  read them later. Completions bill ``train.ckpt_writes``; the submitter
  exports the queue depth as the ``train.ckpt_backlog`` gauge.
  """

  def __init__(self, max_pending=None):
    super().__init__(max_pending or _async_ckpt_depth(),
                     counter='train.ckpt_writes',
                     thread_name='lddl-ckpt-write')


class PreemptionGuard:
  """Turn a preemption notice into a flag the step loop can act on.

  SIGTERM is the spot-instance contract (a grace window before the host
  dies); ``LDDL_PREEMPTION_FILE`` covers schedulers that signal
  maintenance by touching a file instead. The signal handler only sets
  an event; the writer flush and the emergency checkpoint happen on the
  main thread at the next step boundary. Install/uninstall are no-ops
  off the main thread (Python restricts handler registration to it); the
  notice-file path still works there.
  """

  def __init__(self, signum=signal.SIGTERM, notice_file=None):
    self._signum = signum
    self._notice = (notice_file if notice_file is not None
                    else os.environ.get('LDDL_PREEMPTION_FILE') or None)
    self._flag = threading.Event()
    self._prev = None
    self._installed = False
    self._counted = False
    self._preempt_c = get_telemetry().counter('train.elastic.preemptions')

  def install(self):
    if threading.current_thread() is threading.main_thread():
      self._prev = signal.signal(self._signum, self._on_signal)
      self._installed = True
    return self

  def uninstall(self):
    if self._installed:
      signal.signal(self._signum,
                    self._prev if self._prev is not None else signal.SIG_DFL)
      self._installed = False

  def _on_signal(self, signum, frame):
    self._flag.set()

  @property
  def requested(self):
    """Whether a preemption notice has arrived (signal or notice file).
    Counted once into ``train.elastic.preemptions`` on first
    observation."""
    if not self._flag.is_set() and self._notice and \
        os.path.exists(self._notice):
      self._flag.set()
    if self._flag.is_set() and not self._counted:
      self._counted = True
      self._preempt_c.add(1)
    return self._flag.is_set()


class RankMembership:
  """Lease-store view of which train ranks are alive, slow, or shed.

  Key grammar (one namespace per run, ``train.membership``; rides the
  comm backend's :meth:`~lddl_tpu_torch.comm.CommBackend.lease_store`)::

    member.rank<r>  json {'pid', 'joined_step'}   idempotent publish
    hb.rank<r>      ascii beat counter            HeartbeatPump
    sig.rank<r>     json windowed progress rates  idempotent publish
    shed.rank<r>    ascii proposer rank           CAS: one verdict winner

  Death detection reuses the lease substrate's two-tier discipline: the
  positive death probe (pid beacon, same-host worlds) fires within one
  poll; the heartbeat-counter staleness timeout (observer's own clock,
  skew-immune) backstops cross-host worlds. Shedding is deterministic
  fleet-wide because the inputs are *published* signals every rank
  reads identically, the score arithmetic
  (:func:`~lddl_tpu_torch.telemetry.live.straggler_scores`) is pure, and
  the ``shed`` CAS picks exactly one verdict writer — ranks obey the CAS
  record, never their transient local computation.

  Membership only ever *observes*: no collectives, no unbounded waits
  (LDA009 root — survivors must make progress while a peer is dead).
  A restarted rank rejoins by republishing its member record and
  heartbeat (the changed counter un-ages it); records of ranks beyond
  the current world size are ignored, so a reformed smaller fleet is
  not haunted by the old incarnation's keys.
  """

  def __init__(self, store, rank, world, interval=None, timeout=None,
               shed_score=None, telemetry=None):
    from ..pipeline.executor import lease_timeout
    self._store = store
    self._rank = rank
    self._world = world
    self.interval = (comm_heartbeat_interval() if interval is None
                     else interval)
    self._timeout = lease_timeout() if timeout is None else timeout
    self._shed_score = shed_threshold() if shed_score is None else shed_score
    self._hb_seen = {}  # rank -> (counter value, monotonic when it changed)
    self._counted_dead = set()
    self._pump = None
    tele = telemetry if telemetry is not None else get_telemetry()
    self._dead_c = tele.counter('train.elastic.dead_ranks')
    self._sheds_c = tele.counter('train.elastic.sheds')
    self._rejoins_c = tele.counter('train.elastic.rejoins')

  def start(self, step=0):
    """Join the fleet: publish the member record and start the
    heartbeat pump. ``step > 0`` marks a rejoin (a restarted rank
    re-entering at the last checkpointed step)."""
    self._store.publish(
        f'member.rank{self._rank}',
        json.dumps({'pid': os.getpid(), 'joined_step': int(step)}).encode())
    if step > 0:
      self._rejoins_c.add(1)
    self._pump = HeartbeatPump(self._store, self.interval,
                               fault_site='train.heartbeat')
    return self

  def stop(self):
    if self._pump is not None:
      self._pump.stop()
      self._pump = None

  @property
  def beats(self):
    """This rank's heartbeats so far: the train loop polls once per beat,
    at the heartbeat cadence, without reading a clock."""
    return 0 if self._pump is None else self._pump.beats

  def members(self):
    """Ranks with a member record, restricted to the current world size
    (stale records from a larger previous incarnation are ignored)."""
    out = []
    for key in self._store.list('member.rank'):
      suffix = key[len('member.rank'):]
      if suffix.isdigit() and int(suffix) < self._world:
        out.append(int(suffix))
    return sorted(out)

  def _peer_stale(self, r):
    if self._store.owner_dead(r):
      return True  # positive death signal: no need to wait out the lease
    hb = self._store.read_heartbeat(r)
    now = time.monotonic()
    prev = self._hb_seen.get(r)
    if prev is None or prev[0] != hb:
      self._hb_seen[r] = (hb, now)
      return False
    # Staleness verdict: a peer is declared dead only on a heartbeat
    # counter silent past the lease timeout (or the positive death probe
    # above), measured on this observer's own clock. The consequence is
    # a checkpoint-and-stop every survivor reaches independently — clock
    # skew can cost an early reform, never divergent training state.
    return now - prev[1] > self._timeout

  def dead_ranks(self):
    """Peers that are positively dead or heartbeat-silent past the
    timeout (sorted; never includes this rank)."""
    return sorted(r for r in self.members()
                  if r != self._rank and self._peer_stale(r))

  def publish_signals(self, signals):
    """Publish this rank's windowed progress rates (the straggler
    inputs — e.g. ``{'steps_per_sec': 3.2}``)."""
    self._store.publish(f'sig.rank{self._rank}',
                        json.dumps(signals).encode())

  def read_signals(self):
    """All ranks' published signal dicts, ``{rank: signals}``."""
    out = {}
    for key in self._store.list('sig.rank'):
      suffix = key[len('sig.rank'):]
      if not suffix.isdigit() or int(suffix) >= self._world:
        continue
      raw = self._store.read(key)
      if raw is None:
        continue
      try:
        out[int(suffix)] = json.loads(raw)
      except (ValueError, UnicodeDecodeError):
        continue
    return out

  def propose_shed(self):
    """Score the fleet from published signals; CAS a shed verdict when
    the slowest rank's score reaches the threshold. Returns the rank a
    *new* verdict was recorded against (this proposer won the CAS), or
    None."""
    if self._shed_score <= 0:
      return None
    signals = self.read_signals()
    if len(signals) < 2:
      return None  # no fleet to compare against
    from ..telemetry.live import straggler_scores
    verdict = straggler_scores(signals)
    slowest = verdict['slowest']
    if slowest is None or verdict['scores'][slowest] < self._shed_score:
      return None
    if self._store.try_claim(f'shed.rank{slowest}') is None:
      self._sheds_c.add(1)
      return slowest
    return None

  def shed_ranks(self):
    """Ranks with a recorded shed verdict (sorted)."""
    out = []
    for key in self._store.list('shed.rank'):
      suffix = key[len('shed.rank'):]
      if suffix.isdigit() and int(suffix) < self._world:
        out.append(int(suffix))
    return sorted(out)

  def poll(self):
    """One membership sweep. Returns a stop-reason string when the
    fleet must checkpoint-and-reform (a peer died, or a shed verdict
    exists — including against this rank), else None."""
    self.propose_shed()
    shed = self.shed_ranks()
    if shed:
      return 'shed:rank' + ','.join(map(str, shed))
    dead = self.dead_ranks()
    new = [r for r in dead if r not in self._counted_dead]
    if new:
      self._counted_dead.update(new)
      self._dead_c.add(len(new))
    if dead:
      return 'dead_rank:' + ','.join(map(str, dead))
    return None


def maybe_membership(comm, step=0, **kwargs):
  """A started :class:`RankMembership` for this run's comm backend, or
  None when elastic training is off, the world is single-rank, or the
  backend has no lease substrate."""
  if comm.world_size <= 1 or not elastic_train_enabled(comm):
    return None
  store = comm.lease_store('train.membership')
  if store is None:
    return None
  return RankMembership(store, comm.rank, comm.world_size,
                        **kwargs).start(step=step)
