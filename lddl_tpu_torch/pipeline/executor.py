"""Task execution across local worker processes and comm ranks: the
preprocessor's map.

The port's :mod:`lddl_tpu.pipeline.executor`: the global task list is
strided across comm ranks (``tasks[rank::world]``); each rank runs its
share in its own process (``num_local_workers=1``, the default) or fans
it out to a persistent local :class:`~.pool.WorkerPool`
(``num_local_workers > 1``), created at the first pooled map and reused by
every later phase until :meth:`Executor.close`. In the pool, tasks go out
largest first (LPT by a deterministic cost key) to whichever worker is
idle. Results (small metadata; bulk data goes through the shared
filesystem) come back in task order and are all-gathered over the comm,
a missing task named at the boundary. Either way a task's shard writes
run on a write-back thread while the next task encodes. Telemetry and
trace names are the JAX package's (``pipeline.<label>.*``, the pool's
``steals``, ``worker_idle_seconds`` and ``pipeline.pool.queue_depth``),
and so is the ``LDDL_PROGRESS`` reporter.

The elastic path (``LDDL_ELASTIC``; on by default over a
:class:`~lddl_tpu_torch.comm.FileBackend`, whose store is a shared
directory) replaces the stride by leases: the whole task list is every
rank's pool of work, each rank claims tasks by compare-and-set in LPT
order, a finished task publishes a completion manifest behind its shard
writes, and a claim whose owner is dead (its pid beacon) or silent (its
heartbeat counter still for :func:`lease_timeout`) is revoked and run
again. A phase is complete when every task has a manifest: no
collective, so a dead rank cannot hang the survivors, and a run
restarted with the same run id skips the tasks its manifests name
(``pipeline.elastic.resume_skipped``). A task's output is a function of
``(task, global_index)`` written by atomic renames, so the bytes are the
static stride's however the claims land. :func:`lease_timeout` is also
read by :class:`~lddl_tpu_torch.training.elastic.RankMembership`.
"""

import functools
import json
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import weakref

from ..comm import (HeartbeatPump, LeaseStaleness, NullBackend,
                    comm_heartbeat_interval)
from ..core import faults
from ..telemetry import get_telemetry
from ..telemetry.trace import get_tracer
from .parquet_io import (MANIFEST_MISSING, manifest_key,
                         publish_result_manifest, read_result_manifest)
from .pool import (AsyncShardWriter, PoolBroken, TaskFailed, WorkerPool,
                   WriteBackError, install_writer, write_back_enabled)

#: Seconds between claim passes while peers hold every pending lease.
_ELASTIC_POLL = 0.05


def lease_timeout():
  """Seconds of heartbeat silence before survivors revoke a lease (env
  ``LDDL_LEASE_TIMEOUT``). The pid-beacon death probe usually fires far
  earlier on same-host worlds; this is the cross-host backstop."""
  try:
    return max(0.2, float(os.environ.get('LDDL_LEASE_TIMEOUT', '60')))
  except ValueError:
    return 60.0


def elastic_enabled(comm):
  """Whether ``map()`` runs the lease-claimed elastic path over ``comm``.

  Env ``LDDL_ELASTIC``: ``0/false/off/no`` forces the static stride;
  ``1/true/on/yes`` takes leases wherever the backend offers a store (the
  torch backend's key-value store in a world above 1); unset, only where
  the store is first-class (``elastic_default``: the FileBackend, also at
  world size 1, where the manifests make a killed preprocess
  resumable)."""
  v = os.environ.get('LDDL_ELASTIC', '').strip().lower()
  if v in ('0', 'false', 'off', 'no'):
    return False
  if v in ('1', 'true', 'on', 'yes'):
    return True
  return getattr(comm, 'elastic_default', False)


def _elastic_run(fn, publisher, rank, task, global_index):
  """A task of the elastic path (module-level: it is pickled to pool
  workers): the ``elastic.task`` fault site, the task, then its
  completion manifest through the ambient write-back queue, so the
  manifest lands only after the task's shard writes. A task run again (a
  pool worker's replay) publishes again."""
  faults.inject('elastic.task', gi=global_index, rank=rank)
  result = fn(task, global_index)
  if publisher is not None:
    publisher(global_index, result)
  return result


class _ElasticTaskError:
  """Pickled into a task's completion manifest when it fails: the phase
  still completes on every rank (no task stays pending, which would hold
  every rank in the manifest wait), and every rank raises it at gather."""

  def __init__(self, err):
    self.err = err


def _publish_error_manifest(store, gi, err):
  """Publish a task's failure as its manifest, where the store can take
  it. ``err`` is an exception or a worker's traceback. A failed publish
  is survivable: the raise that follows stops this rank's heartbeat, and
  its peers revoke the lease."""
  text = err if isinstance(err, str) else f'{type(err).__name__}: {err}'
  try:
    store.publish(manifest_key(gi), pickle.dumps(_ElasticTaskError(text)))
  except OSError:
    return


class _LeaseClaimer:
  """This rank's view of one elastic phase's lease namespace.

  Which rank runs which task is decided by whoever wins a claim's
  compare-and-set first, so a fast rank absorbs a slow or dead rank's
  share; what a task writes is ``f(task, global_index)``, so the bytes do
  not depend on how the claims land or how often a task runs again.

  A pending foreign claim is revoked when its owner is provably dead (the
  pid beacon) or its heartbeat counter has not moved for the lease
  timeout (:class:`~lddl_tpu_torch.comm.LeaseStaleness`). Every survivor
  reads the same shared state, so all reach the same verdict; the revoke
  compare-and-set counts one revocation fleet-wide, and the generation
  bump makes ``claim.<gi>.g<gen+1>`` claimable.
  """

  def __init__(self, store, order, timeout=None, telemetry=None):
    self._store = store
    self._order = list(order)
    self._staleness = LeaseStaleness(
        store, lease_timeout() if timeout is None else timeout)
    self._done = set()
    self._mine = set()  # claims this rank won in this incarnation
    self._gen = {}  # gi -> its live claim generation
    self._foreign = {}  # (gi, gen) -> its owner (fixed once read)
    tele = telemetry if telemetry is not None else get_telemetry()
    self._claims = tele.counter('pipeline.elastic.claims')
    self._reexecutions = tele.counter('pipeline.elastic.reexecutions')
    self._revokes = tele.counter('pipeline.elastic.revokes')

  @property
  def done_count(self):
    return len(self._done)

  def all_done(self):
    return len(self._done) == len(self._order)

  def refresh(self):
    """Read the published manifests into the completion set; returns how
    many completions are new."""
    before = len(self._done)
    for key in self._store.list('done.'):
      suffix = key[len('done.'):]
      if suffix.isdigit():
        self._done.add(int(suffix))
    return len(self._done) - before

  def next_claim(self):
    """Win and return the next task this rank runs (in LPT order), or None
    when every pending task is done, ours, or held by a peer."""
    for gi in self._order:
      if gi in self._done or gi in self._mine:
        continue
      gen = self._gen.get(gi, 0)
      if (gi, gen) in self._foreign:
        continue
      owner = self._store.try_claim(f'claim.{gi}.g{gen}')
      if owner is None or owner == self._store.rank:
        # None: won now. This rank: a claim a previous incarnation of the
        # run left (restarted before its manifest landed); the lease is
        # still ours and a rerun writes the same bytes, so run it.
        self._mine.add(gi)
        self._claims.add(1)
        if gen > 0:
          self._reexecutions.add(1)
        return gi
      if owner >= 0:
        # The owner of (gi, gen) never changes: one compare-and-set per
        # generation per rank. (-1: unreadable for now; retried.)
        self._foreign[(gi, gen)] = owner
    return None

  def pending_unclaimed(self):
    """Whether a claim pass could win anything now."""
    return any(
        gi not in self._done and gi not in self._mine and
        (gi, self._gen.get(gi, 0)) not in self._foreign
        for gi in self._order)

  def observe(self):
    """Sweep the foreign claims of pending tasks: revoke the stale ones
    (one revocation fleet-wide, by compare-and-set) and bump their
    generation here, so the next claim pass can run them. Returns True
    where a lease was revoked (work opened up)."""
    progressed = False
    for gi in self._order:
      if gi in self._done or gi in self._mine:
        continue
      gen = self._gen.get(gi, 0)
      owner = self._foreign.get((gi, gen))
      if owner is None or not self._staleness.stale(owner):
        continue
      if self._store.try_claim(f'revoke.{gi}.g{gen}') is None:
        self._revokes.add(1)
      self._gen[gi] = gen + 1
      progressed = True
    return progressed


def _run_task(fn, global_index, task):
  t0 = time.monotonic()
  result = fn(task, global_index)
  return global_index, result, t0, time.monotonic() - t0, os.getpid()


class ProgressReporter:
  """Live per-rank progress of a phase, controlled by ``LDDL_PROGRESS``:
  ``1``/``stderr`` prints a line per phase every >= 2 s on stderr; a
  directory path gets per-rank JSON heartbeats
  ``lddl_status.rank<R>.json`` (atomic rename). A finished phase leaves
  a ``{"complete": true}`` record, so a status file never claims an
  in-flight phase after the run."""

  def __init__(self, spec, rank):
    self._stderr = spec in ('1', 'true', 'stderr')
    self._dir = None if self._stderr else spec
    if self._dir:
      os.makedirs(self._dir, exist_ok=True)
    self._rank = rank
    self._label = None
    self._t0 = 0.0
    self._done0 = 0
    self._last = 0.0

  def update(self, label, done, total, force=False, extra=None):
    now = time.monotonic()
    if label != self._label:
      self._label, self._t0, self._done0 = label, now, done
    due = force or now - self._last >= 2.0
    self._last = now if due else self._last
    elapsed = max(now - self._t0, 1e-9)
    rate = (done - self._done0) / elapsed if done > self._done0 else None
    eta = (total - done) / rate if rate else None
    if due and self._stderr:
      rate_s = f'{rate:.1f}/s' if rate else '--/s'
      eta_s = f'eta {eta:.0f}s' if eta is not None else 'eta --'
      tail = ' done' if extra and extra.get('complete') else ''
      print(f'[lddl {label}] rank {self._rank}: {done}/{total} '
            f'({rate_s}, {eta_s}){tail}', file=sys.stderr, flush=True)
    elif due:
      record = {
          'rank': self._rank, 'pid': os.getpid(), 'phase': label,
          'done': done, 'total': total,
          'tasks_per_sec': round(rate, 3) if rate else None,
          'eta_sec': round(eta, 1) if eta is not None else None,
          'updated_unix': time.time(),
          'monotonic_elapsed_sec': round(now - self._t0, 3),
      }
      record.update(extra or {})
      fd, tmp = tempfile.mkstemp(dir=self._dir)
      with os.fdopen(fd, 'w') as f:
        f.write(json.dumps(record))
      os.replace(tmp, os.path.join(self._dir,
                                   f'lddl_status.rank{self._rank}.json'))

  def finish(self, label, total, workers):
    self.update(label, total, total, force=True,
                extra={'complete': True, 'workers': workers})


class Executor:
  """Rank-local scheduler: one process a rank, or a persistent pool of
  ``num_local_workers`` processes. The default is 1 (lddl_tpu's is a
  worker a core): the BERT preprocessor's default mask backend, device,
  masks in one process a card. Over a comm whose elastic path is on
  (:func:`elastic_enabled`) a map claims its tasks by lease. Use as a
  context manager (or call :meth:`close`) so the pool is torn down when
  the caller says; a forgotten one is reaped by a finalizer."""

  def __init__(self, comm=None, num_local_workers=None):
    self._comm = comm if comm is not None else NullBackend()
    num_local_workers = 1 if num_local_workers is None else num_local_workers
    if num_local_workers < 1:
      raise ValueError(f'num_local_workers must be >= 1, got '
                       f'{num_local_workers}')
    self._num_local_workers = num_local_workers
    self._pool = None
    self._finalizer = None
    self._warmups = {}  # key -> zero-arg picklable hook
    self._label_counts = {}  # map label -> phases run (lease namespaces)
    spec = os.environ.get('LDDL_PROGRESS', '')
    self._progress = (ProgressReporter(spec, self._comm.rank)
                      if spec not in ('', '0', 'false', 'off') else None)

  @property
  def comm(self):
    return self._comm

  @property
  def num_local_workers(self):
    return self._num_local_workers

  def set_warmup(self, fn, key=None):
    """Register a zero-arg picklable warmup hook, once per ``key``: it
    runs in each pool worker at its start (or at once, by broadcast, in a
    pool already running) and again in a respawned one; with one local
    worker it runs here, now."""
    key = key if key is not None else fn
    if key in self._warmups:
      return
    self._warmups[key] = fn
    if self._num_local_workers == 1:
      fn()
    elif self._pool is not None:
      self._pool.broadcast(fn)

  def _get_pool(self):
    if self._pool is None:
      with get_telemetry().span('pipeline.pool.start_seconds'):
        pool = WorkerPool(self._num_local_workers,
                          warmups=tuple(self._warmups.values()))
      self._pool = pool
      # Reaps the workers if the owner forgets close(); it holds the pool,
      # not the executor, so the executor stays collectable.
      self._finalizer = weakref.finalize(self, pool.shutdown)
    return self._pool

  def _drop_pool(self, force=False):
    if self._finalizer is not None:
      self._finalizer.detach()
      self._finalizer = None
    if self._pool is not None:
      pool, self._pool = self._pool, None
      pool.shutdown(force=force)

  def scheduler_info(self):
    """The scheduler's configuration, for stamping telemetry and logs."""
    pooled = self._num_local_workers > 1
    start_method = None
    if pooled:
      start_method = ('forkserver' if 'forkserver' in
                      multiprocessing.get_all_start_methods() else 'spawn')
    return {
        'workers': self._num_local_workers,
        'start_method': start_method,
        'persistent_pool': pooled,
        'stealing': pooled,
        'lpt': pooled,
        'write_back': write_back_enabled(),
        'elastic': self._elastic(),
    }

  def _elastic(self):
    """Whether maps claim their tasks by lease: the elastic switch is on
    and the comm has a lease store (the null backend and a one-process
    torch world have none, and keep the static stride)."""
    return elastic_enabled(self._comm) and self._comm.has_lease_store

  def _elastic_store(self, label, peek=False):
    """The lease store of the next map phase labelled ``label``, or None
    for the static stride. Namespaces are ``<label>.<n>``, counted per
    label: ranks call ``map`` in the same order, and a restarted run
    makes the same calls again, so a namespace names the same phase on
    every rank and in every incarnation of the run, which is what makes
    its manifests resumable."""
    if not self._elastic():
      return None
    n = self._label_counts.get(label, 0)
    if not peek:
      self._label_counts[label] = n + 1
    return self._comm.lease_store(f'{label}.{n}')

  def resume_pending(self, label):
    """Whether the comm's store already holds completion manifests for the
    next map phase labelled ``label``: a restart that will skip published
    work. Callers keep the partial outputs such a resume still reads
    (``run_shuffled``'s spills)."""
    store = self._elastic_store(label, peek=True)
    return bool(store is not None and store.list('done.'))

  def close(self):
    """Tear down the pool, if one was started (idempotent)."""
    self._drop_pool()

  def __enter__(self):
    return self

  def __exit__(self, exc_type, exc, tb):
    self.close()
    return False

  def map(self, fn, tasks, gather=True, label='map', cost_key=None):
    """Run ``fn(task, global_index)`` for every task, strided over the
    comm's ranks; in the pool, largest ``cost_key(task, global_index)``
    first (any deterministic number, e.g. input bytes; default the
    index). Results never depend on the order or the worker count: a
    task's output is a function of ``(task, global_index)``. With
    ``gather=True`` every rank returns the full, task-ordered result list
    (raising, with the missing indices, if any task has no result); with
    ``gather=False`` each rank returns its own ``[(global_index, result),
    ...]`` in index order, after a barrier. On the elastic path the tasks
    are claimed by lease instead of strided, and no collective runs: the
    full list comes from the completion manifests, and ``gather=False``
    returns the tasks this rank ran."""
    tasks = list(tasks)
    rank = self._comm.rank
    world = self._comm.world_size
    my_indices = list(range(rank, len(tasks), world))
    tele = get_telemetry()
    tracer = get_tracer()
    if tracer.enabled:
      tracer.set_identity(rank=rank)
    store = self._elastic_store(label) if tasks else None
    total = len(tasks) if store is not None else len(my_indices)
    pooled = self._num_local_workers > 1 and total > 1
    local_results = []
    t_map = time.monotonic()
    with tele.span(f'pipeline.{label}.map_seconds'):
      if store is not None:
        ordered = self._map_elastic(fn, tasks, store, pooled, label, cost_key,
                                    tele, tracer, local_results)
      elif pooled:
        self._map_pooled(fn, tasks, my_indices, label, cost_key, tele, tracer,
                         local_results)
      else:
        self._map_serial(fn, tasks, my_indices, label, tele, tracer,
                         local_results)
    if self._progress:
      self._progress.finish(label, total,
                            self._num_local_workers if pooled else 1)
    if tracer.enabled:
      tracer.complete(f'pipeline.{label}.map', t_map,
                      time.monotonic() - t_map, args={'tasks': total})
    if store is not None:
      local_results.sort(key=lambda r: r[0])
      return ordered if gather else local_results
    if not gather:
      self._comm.barrier()
      return local_results
    return self._gather(local_results, len(tasks), label)

  def _map_serial(self, fn, tasks, my_indices, label, tele, tracer,
                  local_results):
    total = len(my_indices)
    task_name = f'pipeline.{label}.task'
    task_hist = tele.histogram(f'pipeline.{label}.task_seconds')
    tasks_done = tele.counter(f'pipeline.{label}.tasks')
    progress_gauge = tele.gauge(f'pipeline.{label}.progress_frac')
    # Overlapped write-back: a task hands its shard writes to the ambient
    # writer's thread, so the encode of shard N+1 overlaps the write of N.
    writer = AsyncShardWriter() if write_back_enabled() else None
    previous = install_writer(writer)
    try:
      for i in my_indices:
        gi, res, t0, dt, pid = _run_task(fn, i, tasks[i])
        task_hist.observe(dt)
        tasks_done.add(1)
        tracer.complete(task_name, t0, dt, tid=pid)
        local_results.append((gi, res))
        progress_gauge.set(len(local_results) / total)
        if self._progress:
          self._progress.update(label, len(local_results), total)
      if writer is not None:
        writer.flush()
    except BaseException:
      # The task's error is the story; drain the writer quietly.
      if writer is not None:
        writer.close(raise_errors=False)
        writer = None
      raise
    finally:
      install_writer(previous)
      if writer is not None:
        backlog = writer.take_backlog_hwm()
        writer.close()
        tele.gauge('pipeline.pool.writer_backlog').set(backlog)

  def _map_pooled(self, fn, tasks, my_indices, label, cost_key, tele,
                  tracer, local_results):
    total = len(my_indices)
    pool = self._get_pool()
    items = [(i, tasks[i], cost_key(tasks[i], i) if cost_key else i)
             for i in my_indices]
    task_name = f'pipeline.{label}.task'
    task_hist = tele.histogram(f'pipeline.{label}.task_seconds')
    tasks_done = tele.counter(f'pipeline.{label}.tasks')
    steals = tele.counter(f'pipeline.{label}.steals')
    idle_hist = tele.histogram(f'pipeline.{label}.worker_idle_seconds')
    depth_gauge = tele.gauge('pipeline.pool.queue_depth')
    progress_gauge = tele.gauge(f'pipeline.{label}.progress_frac')
    done = 0

    def on_result(msg):
      nonlocal done
      _, gi, res, terr, t0, dt, pid, wid, pos, wait = msg
      done += 1
      pending = total - done
      depth_gauge.set(pending)
      progress_gauge.set(done / total)
      if terr is None:
        task_hist.observe(dt)
        tasks_done.add(1)
        idle_hist.observe(wait)
        # Under a static stride, queue position ``pos`` would have been
        # worker ``pos % N``'s: another worker taking it is a steal.
        if pos % pool.num_workers != wid:
          steals.add(1)
        tracer.complete(task_name, t0, dt, tid=pid)
        if wait > 0:
          tracer.complete(f'pipeline.{label}.worker_idle', t0 - wait, wait,
                          tid=pid)
        tracer.counter('pipeline.pool.queue_depth', pending)
        local_results.append((gi, res))
      if self._progress:
        self._progress.update(label, done, total)

    try:
      _, hwms = pool.run_phase(fn, items, on_result=on_result)
    except PoolBroken:
      # The pool cannot be trusted: the next map starts a new one.
      self._drop_pool(force=True)
      raise
    tele.gauge('pipeline.pool.writer_backlog').set(max(hwms))
    # Results arrive in completion order; the contract is task order.
    local_results.sort(key=lambda r: r[0])

  # -- the elastic map (lease-claimed tasks) ---------------------------------

  def _map_elastic(self, fn, tasks, store, pooled, label, cost_key, tele,
                   tracer, local_results):
    """The lease-claimed map: ranks claim tasks by compare-and-set in LPT
    order, publish completion manifests beside the shards, and revoke and
    rerun the leases of dead or silent owners, until every task has a
    manifest. Returns the results in task order, from the manifests."""
    total = len(tasks)
    order = sorted(range(total), key=lambda i: (
        -(cost_key(tasks[i], i) if cost_key is not None else i), i))
    claimer = _LeaseClaimer(store, order, telemetry=tele)
    skipped = claimer.refresh()
    if skipped:
      # A restart: a previous incarnation of this run published these;
      # their outputs are on disk.
      tele.counter('pipeline.elastic.resume_skipped').add(skipped)
    # A FileLeaseStore's manifests are files beside the shards, which the
    # process that ran the task publishes behind its writes. A key-value
    # store has nothing a pool worker can reach: this process publishes
    # them after each pass.
    publisher = (functools.partial(publish_result_manifest,
                                   store.manifest_root)
                 if store.manifest_root else None)
    wrapped = functools.partial(_elastic_run, fn, publisher, self._comm.rank)
    progress_gauge = tele.gauge(f'pipeline.{label}.progress_frac')
    pump = HeartbeatPump(store, comm_heartbeat_interval())
    try:
      while not claimer.all_done():
        if pooled:
          executed = self._elastic_pass_pooled(
              wrapped, tasks, claimer, store, publisher is None, label, tele,
              tracer, local_results)
        else:
          executed = self._elastic_pass_serial(
              wrapped, tasks, claimer, store, publisher is None, label, tele,
              tracer, local_results)
        claimer.refresh()
        progress_gauge.set(claimer.done_count / total)
        if self._progress:
          self._progress.update(label, claimer.done_count, total)
        if claimer.all_done():
          break
        revoked = claimer.observe()
        if not executed and not revoked and not claimer.pending_unclaimed():
          # Peers hold every pending lease and none is stale: wait for
          # their manifests, or for a lease to age into revocation.
          time.sleep(_ELASTIC_POLL)
    finally:
      pump.stop()
    return self._collect_manifests(store, total, label)

  def _elastic_pass_serial(self, wrapped, tasks, claimer, store,
                           parent_publish, label, tele, tracer,
                           local_results):
    """One claim-and-run pass in this process; returns the tasks run."""
    task_name = f'pipeline.{label}.task'
    task_hist = tele.histogram(f'pipeline.{label}.task_seconds')
    tasks_done = tele.counter(f'pipeline.{label}.tasks')
    executed = []
    writer = AsyncShardWriter() if write_back_enabled() else None
    previous = install_writer(writer)
    try:
      while True:
        gi = claimer.next_claim()
        if gi is None:
          break
        t0 = time.monotonic()
        try:
          res = wrapped(tasks[gi], gi)
        except Exception as e:
          # The failure becomes the task's manifest, so peers complete the
          # phase and raise it too instead of waiting on it forever.
          _publish_error_manifest(store, gi, e)
          raise
        dt = time.monotonic() - t0
        task_hist.observe(dt)
        tasks_done.add(1)
        tracer.complete(task_name, t0, dt, tid=os.getpid())
        local_results.append((gi, res))
        executed.append((gi, res))
      if writer is not None:
        writer.flush()
    except BaseException:
      if writer is not None:
        writer.close(raise_errors=False)
        writer = None
      raise
    finally:
      install_writer(previous)
      if writer is not None:
        backlog = writer.take_backlog_hwm()
        writer.close()
        tele.gauge('pipeline.pool.writer_backlog').set(backlog)
    if parent_publish:
      for gi, res in executed:
        store.publish(manifest_key(gi), pickle.dumps(res))
    return len(executed)

  def _elastic_pass_pooled(self, wrapped, tasks, claimer, store,
                           parent_publish, label, tele, tracer,
                           local_results):
    """One claim-and-run pass over :meth:`WorkerPool.run_stream`: a claim
    is won as a worker falls idle, so the claims follow this rank's real
    throughput. A worker's death reruns the task it held and those whose
    writes it had not landed, all claims this rank holds; each rerun
    publishes its manifest again behind its writes. Returns the tasks
    run."""
    pool = self._get_pool()
    task_name = f'pipeline.{label}.task'
    task_hist = tele.histogram(f'pipeline.{label}.task_seconds')
    tasks_done = tele.counter(f'pipeline.{label}.tasks')
    idle_hist = tele.histogram(f'pipeline.{label}.worker_idle_seconds')
    executed = []

    def puller():
      gi = claimer.next_claim()
      return None if gi is None else (gi, tasks[gi], 0)

    def on_result(msg):
      _, gi, res, terr, t0, dt, pid, wid, pos, wait = msg
      if terr is None:
        task_hist.observe(dt)
        tasks_done.add(1)
        idle_hist.observe(wait)
        tracer.complete(task_name, t0, dt, tid=pid)
        local_results.append((gi, res))
        executed.append((gi, res))

    try:
      records = pool.run_stream(wrapped, puller, on_result=on_result)
      hwms, flush_errs = pool.flush_round()
    except PoolBroken:
      self._drop_pool(force=True)
      raise
    tele.gauge('pipeline.pool.writer_backlog').set(max(hwms))
    failed = sorted((m for m in records if m[3] is not None),
                    key=lambda m: m[1])
    if failed:
      gi, err = failed[0][1], failed[0][3]
      _publish_error_manifest(store, gi, err)
      raise TaskFailed(f'task (global index {gi}) failed in pool worker:\n'
                       f'{err}')
    if flush_errs:
      # The writer withheld the manifests of a failed write's task; the
      # raise stops this rank's heartbeat, so peers revoke and rerun them.
      raise WriteBackError('deferred shard write(s) failed:\n' +
                           '\n'.join(flush_errs))
    if parent_publish:
      for gi, res in executed:
        store.publish(manifest_key(gi), pickle.dumps(res))
    return len(executed)

  def _collect_manifests(self, store, total, label):
    """The results of a completed elastic phase, in task order, from its
    manifests; raises on a failed task's (wherever it ran) or a missing
    one."""
    ordered = []
    for gi in range(total):
      res = read_result_manifest(store, gi)
      if res is MANIFEST_MISSING:
        raise RuntimeError(
            f'map({label!r}) completion manifest for task {gi} vanished '
            'after the phase completed: the lease store was modified '
            'from outside')
      if isinstance(res, _ElasticTaskError):
        raise TaskFailed(
            f'task (global index {gi}) failed on another rank (reported '
            f'by its completion manifest):\n{res.err}')
      ordered.append(res)
    return ordered

  def _gather(self, local_results, n, label):
    gathered = self._comm.allgather_object(local_results)
    ordered = [None] * n
    seen = [False] * n
    for rank_results in gathered:
      for i, res in rank_results:
        ordered[i] = res
        seen[i] = True
    missing = [i for i, ok in enumerate(seen) if not ok]
    if missing:
      shown = ', '.join(map(str, missing[:32]))
      more = f' (+{len(missing) - 32} more)' if len(missing) > 32 else ''
      raise RuntimeError(
          f'map({label!r}) gather returned no result for {len(missing)} '
          f'of {n} tasks — missing global indices: {shown}{more}. A rank '
          'likely dropped tasks or returned a truncated result list.')
    return ordered
