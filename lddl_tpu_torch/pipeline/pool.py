"""Bounded background write-back (the part of
:mod:`lddl_tpu.pipeline.pool` the port needs).

Only :class:`AsyncShardWriter` and :class:`WriteBackError` are copied:
the train loop's :class:`~lddl_tpu_torch.training.elastic.
AsyncCheckpointWriter` rides their overlap-and-flush discipline. The
JAX package's worker pool and its ambient writer are not ported.
"""

import queue as _queue
import threading
import traceback

from ..telemetry import get_telemetry


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

  def __init__(self, max_pending, counter='pipeline.pool.writes',
               thread_name='lddl-write-back'):
    self._q = _queue.Queue(max_pending)
    self._err = None
    # _err is written by the writer thread and read by flush()/failed on
    # the submitting thread; the lock makes first-failure-wins atomic.
    self._err_lock = threading.Lock()
    self._counter = counter
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
    self._q.put((fn, args, kwargs))

  def flush(self):
    """Block until all submitted jobs ran; raise on any failure."""
    self._q.join()
    self.raise_pending()

  def close(self, raise_errors=True):
    """Drain, stop the thread, and (optionally) raise pending failures."""
    self._q.put(None)
    self._q.join()
    self._thread.join(timeout=30.0)
    if raise_errors:
      self.raise_pending()
