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

The elastic lease path (``LDDL_ELASTIC``) is not ported yet (ROADMAP,
Queue 1): asking for it raises. :func:`lease_timeout` is the elastic
executor's, which :class:`~lddl_tpu_torch.training.elastic.RankMembership`
reads.
"""

import json
import multiprocessing
import os
import sys
import tempfile
import time
import weakref

from ..comm import NullBackend
from ..telemetry import get_telemetry
from ..telemetry.trace import get_tracer
from .pool import (AsyncShardWriter, PoolBroken, WorkerPool, install_writer,
                   write_back_enabled)


def lease_timeout():
  """Seconds of heartbeat silence before survivors revoke a lease (env
  ``LDDL_LEASE_TIMEOUT``). The pid-beacon death probe usually fires far
  earlier on same-host worlds; this is the cross-host backstop."""
  try:
    return max(0.2, float(os.environ.get('LDDL_LEASE_TIMEOUT', '60')))
  except ValueError:
    return 60.0


def elastic_enabled(comm):
  """Whether the JAX package's ``map()`` would run its lease-claimed
  elastic path over ``comm`` (env ``LDDL_ELASTIC``; unset: where the
  backend's store is first-class)."""
  v = os.environ.get('LDDL_ELASTIC', '').strip().lower()
  if v in ('0', 'false', 'off', 'no'):
    return False
  if v in ('1', 'true', 'on', 'yes'):
    return True
  return getattr(comm, 'elastic_default', False)


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
  masks in one process a card. A comm whose elastic path is on
  (``LDDL_ELASTIC``) raises: the lease protocol is not ported. Use as a
  context manager (or call :meth:`close`) so the pool is torn down when
  the caller says; a forgotten one is reaped by a finalizer."""

  def __init__(self, comm=None, num_local_workers=None):
    self._comm = comm if comm is not None else NullBackend()
    num_local_workers = 1 if num_local_workers is None else num_local_workers
    if num_local_workers < 1:
      raise ValueError(f'num_local_workers must be >= 1, got '
                       f'{num_local_workers}')
    if elastic_enabled(self._comm):
      raise NotImplementedError(
          'the elastic map (LDDL_ELASTIC) is not ported yet (ROADMAP, Queue '
          '1: the elastic executor)')
    self._num_local_workers = num_local_workers
    self._pool = None
    self._finalizer = None
    self._warmups = {}  # key -> zero-arg picklable hook
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
        'elastic': False,
    }

  def resume_pending(self, label):
    """Whether a restarted elastic run holds manifests for ``label``:
    never, without the elastic path."""
    del label
    return False

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
    ...]`` in index order, after a barrier."""
    tasks = list(tasks)
    rank = self._comm.rank
    world = self._comm.world_size
    my_indices = list(range(rank, len(tasks), world))
    tele = get_telemetry()
    tracer = get_tracer()
    if tracer.enabled:
      tracer.set_identity(rank=rank)
    pooled = self._num_local_workers > 1 and len(my_indices) > 1
    local_results = []
    t_map = time.monotonic()
    with tele.span(f'pipeline.{label}.map_seconds'):
      if pooled:
        self._map_pooled(fn, tasks, my_indices, label, cost_key, tele, tracer,
                         local_results)
      else:
        self._map_serial(fn, tasks, my_indices, label, tele, tracer,
                         local_results)
    if self._progress:
      self._progress.finish(label, len(my_indices),
                            self._num_local_workers if pooled else 1)
    if tracer.enabled:
      tracer.complete(f'pipeline.{label}.map', t_map,
                      time.monotonic() - t_map,
                      args={'tasks': len(my_indices)})
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
