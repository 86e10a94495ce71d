"""Persistent worker pool and overlapped shard write-back: the port's
:mod:`lddl_tpu.pipeline.pool`.

:class:`AsyncShardWriter` and :class:`WriteBackError`: a task hands its
shard writes to a writer thread (the ambient writer,
:func:`current_writer`), so the encode of shard N+1 overlaps the write of
shard N; the train loop's
:class:`~lddl_tpu_torch.training.elastic.AsyncCheckpointWriter` rides the
same overlap-and-flush discipline.

:class:`WorkerPool`: one persistent set of worker processes a
:class:`~.executor.Executor`, started at its first pooled map and reused
by every later phase. Warmup hooks (the tokenizer and its native encoder)
run once in each worker, at its start or by :meth:`WorkerPool.broadcast`,
and again in full in a respawned worker. Dispatch is dynamic: the parent
hands the next task, in the caller's (largest-first) order, to whichever
worker is idle, which is what lddl_tpu's work stealing off a shared queue
does. Each worker owns an :class:`AsyncShardWriter`, drained by
:meth:`WorkerPool.flush_round` before a phase's results count.

**One pair of pipes a worker, no shared queue.** lddl_tpu's workers share
one task queue and one result queue. A ``multiprocessing.Queue`` hands
each message to a feeder thread, which writes it later under a
cross-process lock, so a SIGKILL loses what the dead worker's feeder had
not yet written: the result of the task it finished last, which its
parent (having retried only the task it died in) then waits for forever,
or the lock itself, held mid-message, which then silences every other
worker and the respawned one. Either way the parent sees no worker dead
and waits on (ROADMAP, "Found in the reference, repaired in the port";
``tests/reference_pool_stall.py`` reads both states,
``tests/test_torch_pool.py`` shows the second). Here each worker has a
task pipe and a result pipe of its own, which its one thread writes
before it takes the next task, and the parent waits on all of them and
on the workers' sentinels (:func:`multiprocessing.connection.wait`). A
death can lose only the dead worker's own message, of the task it held.
Since the parent handed each task to one worker, it knows which task a
dead worker held: lddl_tpu's in-flight marker files have nothing left to
say.

The recovery contract is lddl_tpu's: a worker that dies while it holds a
task is respawned (its warmups replayed) and the task retried, once. A
task that kills its worker twice, two workers dying together, a death
before a worker's first task, or more deaths in one phase than there are
workers raise :class:`PoolBroken`. A task that raises comes back as
:class:`TaskFailed` with the worker's traceback, once the phase drained.
One repair more: a worker reports a task done before its write-back
thread has written the task's shards, so the tasks a dead worker finished
since its write-back was last drained run again too
(``pipeline.pool.replays``), where lddl_tpu loses their shards.

Workers start from the forkserver the loader's workers use (spawn where
there is none; :func:`~lddl_tpu_torch.loader.workers.worker_context`),
with the parent's ``LDDL_*`` environment: never from a fork of the
parent, which may hold a CUDA context.
"""

import os
import pickle
import queue as _queue
import threading
import time
import traceback
from multiprocessing import connection as _connection
from multiprocessing.reduction import ForkingPickler

from ..loader.workers import adopt_env, start_processes, worker_context
from ..telemetry import get_telemetry

# Seconds between the parent's liveness checks while it waits on workers.
_POLL_SECONDS = 1.0
# Seconds a death waits for others to count them as dying together (the
# reference judged the deaths of one 1 s poll together).
_TOGETHER_SECONDS = 0.25


def write_back_enabled():
  """Overlapped write-back is on unless ``LDDL_WRITE_BACK`` disables it."""
  return os.environ.get('LDDL_WRITE_BACK', '').strip().lower() not in (
      '0', 'false', 'off')


def _write_back_depth():
  try:
    return max(1, int(os.environ.get('LDDL_WRITE_BACK_DEPTH', '2')))
  except ValueError:
    return 2


class WriteBackError(RuntimeError):
  """A deferred write failed on the background writer thread."""


class AsyncShardWriter:
  """Bounded background write-back: one thread draining a small job queue.

  Callers submit ``(fn, args)`` write jobs and continue computing; the
  queue bound provides backpressure so at most ``max_pending`` jobs are
  held in memory. ``flush()`` blocks until every submitted job has run
  and re-raises the first failure — callers must flush before treating
  the output as durable. ``counter``/``thread_name`` name the telemetry
  counter completions are billed to and the thread.
  """

  def __init__(self, max_pending=None, counter='pipeline.pool.writes',
               thread_name='lddl-write-back'):
    self._q = _queue.Queue(max_pending or _write_back_depth())
    self._err = None
    # _err is written by the writer thread and read by flush()/failed on
    # the submitting thread; the lock makes first-failure-wins atomic.
    self._err_lock = threading.Lock()
    self._counter = counter
    self.backlog_hwm = 0  # max queue depth observed since last reset
    self._thread = threading.Thread(
        target=self._run, name=thread_name, daemon=True)
    self._thread.start()

  def _run(self):
    writes = get_telemetry().counter(self._counter)
    while True:
      job = self._q.get()
      if job is None:
        self._q.task_done()
        return
      fn, args, kwargs = job
      try:
        fn(*args, **kwargs)
        writes.add(1)
      except BaseException:
        with self._err_lock:
          if self._err is None:  # first failure wins; later jobs still run
            self._err = traceback.format_exc()
      finally:
        self._q.task_done()

  @property
  def backlog(self):
    """Jobs currently queued (the checkpoint-backlog gauge input)."""
    return self._q.qsize()

  def raise_pending(self):
    """Surface the first background failure, if any (first-error-wins).
    Cheap enough for a per-step check: one attribute test on the happy
    path."""
    with self._err_lock:
      if self._err is not None:
        raise WriteBackError('background write failed:\n' + self._err)

  def submit(self, fn, *args, **kwargs):
    """Enqueue one write job (blocks when ``max_pending`` are in flight)."""
    self.raise_pending()
    depth = self._q.qsize() + 1
    if depth > self.backlog_hwm:
      self.backlog_hwm = depth
    self._q.put((fn, args, kwargs))

  @property
  def failed(self):
    """Whether a submitted job has failed (the first error is kept)."""
    with self._err_lock:
      return self._err is not None

  def _drain(self):
    """Wait until every submitted job has run: True, or False where the
    writer thread ended with jobs left. The wait is on this process's own
    thread, in steps of :data:`_POLL_SECONDS`, and checks that the thread
    still runs at each step (``Queue.join`` would wait forever on a dead
    one)."""
    done = self._q.all_tasks_done
    with done:
      while self._q.unfinished_tasks and self._thread.is_alive():
        done.wait(timeout=_POLL_SECONDS)
      return not self._q.unfinished_tasks

  def flush(self):
    """Block until all submitted jobs ran; raise on any failure."""
    if not self._drain():
      raise WriteBackError('the write-back thread ended with '
                           f'{self._q.unfinished_tasks} job(s) not run')
    self.raise_pending()

  def take_backlog_hwm(self):
    """Read and reset the high-water mark (per-phase accounting)."""
    hwm, self.backlog_hwm = self.backlog_hwm, 0
    return hwm

  def close(self, raise_errors=True):
    """Drain, stop the thread, and (optionally) raise pending failures."""
    self._q.put(None)
    self._drain()
    self._thread.join(timeout=30.0)
    if raise_errors:
      self.raise_pending()


# The process's ambient writer, which tasks pick up via current_writer():
# the executor's serial map installs one around its task loop; everywhere
# else it is None and writes stay synchronous.
_CURRENT_WRITER = None


def current_writer():
  """The ambient :class:`AsyncShardWriter` of this process, or None."""
  return _CURRENT_WRITER


def install_writer(writer):
  """Install ``writer`` as the ambient writer; returns the previous one."""
  global _CURRENT_WRITER
  previous, _CURRENT_WRITER = _CURRENT_WRITER, writer
  return previous


def _format_remote_error(exc):
  return ''.join(
      traceback.format_exception(type(exc), exc, exc.__traceback__))


def _pickled(obj):
  return bytes(ForkingPickler.dumps(obj))


def _worker_main(worker_id, tasks, results, warmups, env):
  """Pool worker loop: warm up, then run what the parent sends.

  Messages (``tasks``, from the parent): ``('task', gi, pos, payload)``
  (``payload``: ``(fn, task)`` pickled, loaded inside the task, so a
  function this process cannot import fails the task, not the worker),
  ``('flush',)``, ``('call', payload)`` (``fn`` pickled), ``('stop',)``.
  Replies (``results``): ``('ready', wid, pid, err)``, ``('result', gi,
  res, err, t0, dt, pid, wid, pos, wait)``, ``('flush_ack', wid,
  backlog_hwm, err)``, ``('call_ack', wid, err)``. A closed task pipe
  means the parent is gone.
  """
  adopt_env(env)
  from ..core import faults
  err = None
  try:
    for fn in warmups:
      fn()
  except Exception as e:  # noqa: BLE001 - reported; the parent decides
    err = _format_remote_error(e)
  writer = AsyncShardWriter() if write_back_enabled() else None
  install_writer(writer)
  results.send(('ready', worker_id, os.getpid(), err))
  idle_t0 = time.monotonic()
  while True:
    try:
      msg = tasks.recv()
    except EOFError:
      break
    wait = time.monotonic() - idle_t0
    kind = msg[0]
    if kind == 'task':
      _, gi, pos, payload = msg
      res, terr = None, None
      t0 = time.monotonic()
      try:
        faults.inject('pool.task', gi=gi)
        fn, task = pickle.loads(payload)
        res = fn(task, gi)
      except Exception as e:  # noqa: BLE001 - the parent raises it
        terr = _format_remote_error(e)
      dt = time.monotonic() - t0
      reply = ('result', gi, res, terr, t0, dt, os.getpid(), worker_id, pos,
               wait)
      try:
        results.send(reply)
      except (pickle.PicklingError, TypeError, AttributeError) as e:
        # Pickling fails before a byte is written: report it instead.
        results.send(reply[:2] + (None, _format_remote_error(e)) + reply[4:])
    elif kind == 'flush':
      ferr, hwm = None, 0
      if writer is not None:
        try:
          writer.flush()
        except WriteBackError as e:
          ferr = _format_remote_error(e)
        hwm = writer.take_backlog_hwm()
      results.send(('flush_ack', worker_id, hwm, ferr))
    elif kind == 'call':
      cerr = None
      try:
        pickle.loads(msg[1])()
      except Exception as e:  # noqa: BLE001
        cerr = _format_remote_error(e)
      results.send(('call_ack', worker_id, cerr))
    elif kind == 'stop':
      break
    idle_t0 = time.monotonic()
  if writer is not None:
    writer.close(raise_errors=False)


class PoolBroken(RuntimeError):
  """A pool worker died in a way the pool does not recover from."""


class TaskFailed(RuntimeError):
  """A task raised inside a pool worker (the worker's traceback attached)."""


class WorkerPool:
  """``num_workers`` persistent worker processes, each fed through its own
  pipe by the parent (see the module docstring).

  ``warmups``: zero-arg picklable hooks every worker runs at its start;
  :meth:`broadcast` adds one later. The pool is reused across phases
  until :meth:`shutdown`."""

  def __init__(self, num_workers, warmups=()):
    if num_workers < 1:
      raise ValueError(f'num_workers must be >= 1, got {num_workers}')
    self.num_workers = num_workers
    self._ctx = worker_context(__name__)
    # The full warmup history: a respawned worker replays all of it.
    self._warmups = list(warmups)
    self._env = {k: v for k, v in os.environ.items() if k.startswith('LDDL_')}
    n = num_workers
    self._procs = [None] * n
    self._tasks = [None] * n     # the parent's send end of each task pipe
    self._results = [None] * n   # the parent's receive end of each result pipe
    self._ready = [False] * n
    self._holding = [None] * n   # the global index a worker runs, or None
    self._tasked = [False] * n   # whether it was handed a task since its start
    # The tasks each worker finished since its write-back was last drained.
    self._unflushed = [[] for _ in range(n)]
    self.worker_pids = [None] * n
    self._closed = False
    try:
      self._start(range(n))
      for _ in range(n):
        w, msg = self._next()
        if msg[0] != 'ready':
          raise PoolBroken(f'worker {w}: unexpected startup message '
                           f'{msg[0]!r}')
        self._on_ready(w, msg)
    except BaseException:
      self.shutdown(force=True)
      raise

  def _start(self, wids):
    procs = []
    ends = []
    for w in wids:
      task_r, task_w = self._ctx.Pipe(duplex=False)
      res_r, res_w = self._ctx.Pipe(duplex=False)
      p = self._ctx.Process(
          target=_worker_main,
          args=(w, task_r, res_w, tuple(self._warmups), self._env),
          name=f'lddl-torch-pool-w{w}', daemon=True)
      self._procs[w], self._tasks[w], self._results[w] = p, task_w, res_r
      self._ready[w], self._holding[w], self._tasked[w] = False, None, False
      self._unflushed[w] = []
      self.worker_pids[w] = None
      procs.append(p)
      ends += [task_r, res_w]
    try:
      start_processes(procs)
    finally:
      # Only the worker keeps its ends: a dead worker's result pipe then
      # reads as closed, never as a message that hangs half-written.
      for end in ends:
        end.close()

  def _on_ready(self, w, msg):
    if msg[3] is not None:
      raise PoolBroken(f'worker {w} warmup failed:\n{msg[3]}')
    self._ready[w] = True
    self.worker_pids[w] = msg[2]

  def _recv(self, w):
    """The next message of worker ``w``, or None once its pipe closed."""
    conn = self._results[w]
    if conn is None:
      return None
    try:
      return conn.recv()
    except (EOFError, OSError):
      conn.close()
      self._results[w] = None
      return None

  def _drained_dead(self):
    """``(w, message)`` still buffered from a dead worker, else the dead
    workers' ids (every message they sent delivered)."""
    dead = []
    for w, p in enumerate(self._procs):
      if p.is_alive() and self._results[w] is not None:
        continue
      while self._results[w] is not None and self._results[w].poll():
        msg = self._recv(w)
        if msg is not None:
          return w, msg
      dead.append(w)
    return None, dead

  def _named(self, wids):
    return [(self._procs[w].name, self._procs[w].exitcode) for w in wids]

  def _next(self, allow_dead=False):
    """``(w, message)``: the next message of any worker. A dead worker
    (after its last message) raises :class:`PoolBroken`, or with
    ``allow_dead`` returns ``(None, [dead ids])``, the deaths within
    ``_TOGETHER_SECONDS`` of the first together."""
    while True:
      waits = {}
      for w in range(self.num_workers):
        if self._results[w] is not None:
          waits[self._results[w]] = w
        waits[self._procs[w].sentinel] = w
      for obj in _connection.wait(list(waits), timeout=_POLL_SECONDS):
        w = waits[obj]
        if obj is self._results[w]:
          msg = self._recv(w)
          if msg is not None:
            return w, msg
      w, dead = self._drained_dead()
      if w is not None:
        return w, dead
      if not dead:
        continue
      if not allow_dead:
        raise PoolBroken(f'pool worker(s) died: {self._named(dead)}; the '
                         'phase cannot complete')
      others = [p.sentinel for i, p in enumerate(self._procs)
                if i not in dead]
      if others:
        _connection.wait(others, timeout=_TOGETHER_SECONDS)
      w, dead = self._drained_dead()
      if w is not None:
        return w, dead
      return None, dead

  def _send(self, w, msg):
    """Send to worker ``w``; a dead worker's closed pipe is left to
    :meth:`_next`, which sees the death."""
    try:
      self._tasks[w].send(msg)
    except (BrokenPipeError, ConnectionResetError):
      pass

  def _respawn(self, w):
    """Replace dead worker ``w`` (new pipes, full warmup replay); its
    ``ready`` arrives as a message."""
    self._procs[w].join(timeout=5.0)
    for conn in (self._tasks[w], self._results[w]):
      if conn is not None:
        conn.close()
    self._start([w])
    get_telemetry().counter('pipeline.pool.respawns').add(1)

  def _recover(self, dead, retried, retry):
    """Respawn a dead worker; queue its task (once) and the tasks whose
    writes it may not have landed to run again, or raise."""
    if len(dead) > 1:
      raise PoolBroken(f'pool workers died together: {self._named(dead)}; '
                       'not a single-worker transient, the phase cannot be '
                       'trusted')
    w = dead[0]
    gi = self._holding[w]
    if gi is None and not self._tasked[w]:
      # It died before its first task (its warmup, or idle): nothing is
      # attributable, so nothing can be safely retried.
      raise PoolBroken(f'pool worker died outside any task: '
                       f'{self._named(dead)}; the phase cannot complete')
    if gi is not None and gi in retried:
      raise PoolBroken(f'task (global index {gi}) killed its worker twice; '
                       'not a transient')
    # A finished task's shard writes may still have been queued on the
    # dead worker's write-back thread: run those tasks again too (a task is
    # a function of its arguments, its writes atomic renames).
    replays = [g for g in self._unflushed[w] if g not in retry]
    self._respawn(w)
    if gi is not None:
      retried.add(gi)
      retry.append(gi)
    retry.extend(replays)
    get_telemetry().counter('pipeline.pool.replays').add(len(replays))

  def run_stream(self, fn, puller, on_result=None):
    """Run ``fn(task, gi)`` for what ``puller()`` hands out, ``(gi, task,
    cost)`` at a time, None once it has no more: each idle worker gets the
    next item (a task to run again first). Returns each task's first
    ``result`` message, in completion order; ``on_result`` sees each as
    it arrives. Returns once no worker holds a task."""
    if self._closed:
      raise PoolBroken('pool already shut down')
    items = {}      # gi -> (task, queue position)
    pending = set()  # gis whose first result has not arrived
    retry = []      # gis to run again (see _recover)
    retried = set()
    records = []
    deaths = 0
    pos = 0
    exhausted = False

    def dispatch():
      nonlocal pos, exhausted
      for w in range(self.num_workers):
        if not self._ready[w] or self._holding[w] is not None:
          continue
        if retry:
          gi = retry.pop(0)
          task, p = items[gi]
        elif not exhausted:
          item = puller()
          if item is None:
            exhausted = True
            return
          gi, task, _ = item
          p, pos = pos, pos + 1
          items[gi] = (task, p)
          pending.add(gi)
        else:
          return
        self._send(w, ('task', gi, p, _pickled((fn, task))))
        self._holding[w], self._tasked[w] = gi, True

    dispatch()
    while pending or retry or any(h is not None for h in self._holding):
      w, msg = self._next(allow_dead=True)
      if w is None:
        deaths += 1
        if deaths > self.num_workers:
          raise PoolBroken(f'{deaths} worker deaths in one phase; failing '
                           'instead of masking a systemic crash')
        self._recover(msg, retried, retry)
      elif msg[0] == 'ready':  # a respawned worker, warmed up
        self._on_ready(w, msg)
      elif msg[0] == 'result':
        self._holding[w] = None
        self._unflushed[w].append(msg[1])
        if msg[1] in pending:
          pending.discard(msg[1])
          records.append(msg)
          if on_result is not None:
            on_result(msg)
      else:
        raise PoolBroken(f'worker {w}: unexpected message {msg[0]!r} in a '
                         'phase')
      dispatch()
    return records

  def _round(self, msg, ack):
    """Send ``msg`` to every worker and collect each one's ``ack``."""
    for w in range(self.num_workers):
      self._send(w, msg)
    acks = {}
    while len(acks) < self.num_workers:
      w, reply = self._next()
      if reply[0] == 'ready':  # respawned at a phase's tail
        self._on_ready(w, reply)
      elif reply[0] == ack:
        acks[w] = reply
      else:
        raise PoolBroken(f'worker {w}: {reply[0]!r} where {ack!r} was due')
    return [acks[w] for w in range(self.num_workers)]

  def flush_round(self):
    """Drain every worker's write-back: ``(backlog high-water marks,
    errors)``, one each, once every queued write has landed."""
    acks = self._round(('flush',), 'flush_ack')
    self._unflushed = [[] for _ in range(self.num_workers)]
    return [a[2] for a in acks], [a[3] for a in acks if a[3] is not None]

  def run_phase(self, fn, items, on_result=None):
    """Run ``fn(task, gi)`` for every ``(gi, task, cost)``, largest cost
    first (ties by ascending ``gi``), then drain the write-back. Returns
    ``(records, backlog_hwms)``; a failed task raises :class:`TaskFailed`
    (the lowest ``gi``'s), a failed write :class:`WriteBackError`, once
    the phase drained, so the pool stays usable."""
    ordered = iter(sorted(items, key=lambda it: (-it[2], it[0])))
    records = self.run_stream(fn, lambda: next(ordered, None),
                              on_result=on_result)
    hwms, flush_errs = self.flush_round()
    failed = sorted((m for m in records if m[3] is not None),
                    key=lambda m: m[1])
    if failed:
      raise TaskFailed(f'task (global index {failed[0][1]}) failed in pool '
                       f'worker:\n{failed[0][3]}')
    if flush_errs:
      raise WriteBackError('deferred shard write(s) failed:\n' +
                           '\n'.join(flush_errs))
    return records, hwms

  def broadcast(self, fn):
    """Run ``fn()`` once in every worker, and in every later respawn."""
    if self._closed:
      raise PoolBroken('pool already shut down')
    self._warmups.append(fn)
    errs = [a[2] for a in self._round(('call', _pickled(fn)), 'call_ack')
            if a[2] is not None]
    if errs:
      raise PoolBroken('worker warmup broadcast failed:\n' + '\n'.join(errs))

  def shutdown(self, force=False):
    """Stop every worker (idempotent); ``force`` skips the polite stop."""
    if self._closed:
      return
    self._closed = True
    live = [p for p in self._procs if p is not None and p.pid is not None]
    if not force:
      for w, p in enumerate(self._procs):
        if p is not None:
          self._send(w, ('stop',))
    deadline = time.monotonic() + (0.0 if force else 10.0)
    for p in live:
      p.join(timeout=max(0.0, deadline - time.monotonic()))
      if p.is_alive():
        p.kill()
    for p in live:
      p.join(timeout=5.0)
    for conn in self._tasks + self._results:
      if conn is not None:
        conn.close()
