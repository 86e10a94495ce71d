"""Bounded background write-back (the part of
:mod:`lddl_tpu.pipeline.pool` the port needs).

:class:`AsyncShardWriter` and :class:`WriteBackError`: the train loop's
:class:`~lddl_tpu_torch.training.elastic.AsyncCheckpointWriter` rides
their overlap-and-flush discipline, and the executor's serial map hands
the preprocessor's shard writes to one (the ambient writer,
:func:`current_writer`). The JAX package's persistent worker pool is not
ported.
"""

import os
import queue as _queue
import threading
import traceback

from ..telemetry import get_telemetry


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

  def flush(self):
    """Block until all submitted jobs ran; raise on any failure."""
    self._q.join()
    self.raise_pending()

  def take_backlog_hwm(self):
    """Read and reset the high-water mark (per-phase accounting)."""
    hwm, self.backlog_hwm = self.backlog_hwm, 0
    return hwm

  def close(self, raise_errors=True):
    """Drain, stop the thread, and (optionally) raise pending failures."""
    self._q.put(None)
    self._q.join()
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
