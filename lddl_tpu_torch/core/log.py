"""Hierarchical, scope-addressed logging of the loader.

Copied from :mod:`lddl_tpu.core.log` (``warn_once``, ``DummyLogger``,
``DatasetLogger``; stdlib only). ``DatasetLogger.to('node'|'rank'|
'worker')`` returns a real logger only where the scope is owned (a
loader worker set by :meth:`DatasetLogger.set_worker` owns the node and
rank scopes as worker 0 only); elsewhere a no-op logger, so library code
can log unconditionally. The loader passes its own ``dp_rank`` where the
JAX package asks ``discover_topology``.
"""

import logging
import os
import pathlib
import sys
import threading
import warnings

_WARNED = set()  # messages already emitted by warn_once (process-local)


def warn_once(message, logger=None, category=UserWarning, stacklevel=2):
  """Emit ``message`` at most once per process.

  Loader hot paths hit the same degenerate condition (no pad token,
  oversized document, ...) once per batch or per row; repeating the
  warning thousands of times buries real signal. Routed to ``logger``
  when one is provided (scope-aware, so multi-rank runs don't multiply
  it further), else to :mod:`warnings`. Returns True when the message
  was actually emitted.
  """
  if message in _WARNED:
    return False
  _WARNED.add(message)
  if logger is not None:
    logger.warning(message)
  else:
    warnings.warn(message, category, stacklevel=stacklevel + 1)
  return True


class DummyLogger:

  def debug(self, *args, **kwargs):
    pass

  def info(self, *args, **kwargs):
    pass

  def warning(self, *args, **kwargs):
    pass

  def error(self, *args, **kwargs):
    pass

  def critical(self, *args, **kwargs):
    pass

  def log(self, *args, **kwargs):
    pass

  def exception(self, *args, **kwargs):
    pass


class _StderrHandler(logging.StreamHandler):
  """A stream handler on the process's own stderr (``sys.__stderr__``),
  not on whatever ``sys.stderr`` was when the logger was made: the
  loggers live for the process, and a stderr swapped in and closed since
  (a ``redirect_stderr`` block's, a captured test's) must not fail their
  records."""

  def __init__(self):
    logging.Handler.__init__(self)

  @property
  def stream(self):
    return sys.__stderr__


class DatasetLogger:
  """Loggers scoped to the node, the rank or a loader worker: a real
  logger where the scope is owned (local rank 0 for 'node', and for
  'node' and 'rank' worker 0 once :meth:`set_worker` ran in a worker;
  every worker its own 'worker' scope), a no-op one elsewhere."""

  def __init__(
      self,
      log_dir=None,
      log_level=logging.INFO,
      rank=0,
      local_rank=0,
      node_rank=0,
      num_workers=1,
  ):
    self._log_dir = log_dir
    self._log_level = log_level
    self._rank = rank
    self._local_rank = local_rank
    self._node_rank = node_rank
    self._num_workers = num_workers
    self._worker_rank = None  # set per loader worker via set_worker()
    if log_dir is not None:
      pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
    self._loggers = {}
    # No caller in the port reaches to() or set_worker() from two threads;
    # the lock is there for lddl-analyze, whose call resolution is by name
    # and so links every tensor.to(...) on the feed's producer thread to
    # this method.
    self._lock = threading.Lock()

  def set_worker(self, worker_rank):
    with self._lock:
      self._worker_rank = worker_rank

  @property
  def num_workers(self):
    return self._num_workers

  @property
  def rank(self):
    return self._rank

  def _make_logger(self, name, filename):
    # Key the process-global logger by configuration, so two DatasetLoggers
    # with different log_dir/log_level never share (and half-apply) config,
    # while identical configs reuse one logger instead of stacking duplicate
    # handlers. (Keying by id() is unsound: a GC'd instance's id can be
    # reused, silently inheriting the dead instance's handlers.)
    logger = logging.getLogger(
        f'{name}@{self._log_dir}@{logging.getLevelName(self._log_level)}')
    logger.setLevel(self._log_level)
    fmt = logging.Formatter(
        'lddl_tpu_torch - %(asctime)s - %(filename)s:%(lineno)d:'
        '%(funcName)s - %(levelname)s - %(message)s')
    if not logger.handlers:
      sh = _StderrHandler()
      sh.setFormatter(fmt)
      logger.addHandler(sh)
      if self._log_dir is not None:
        fh = logging.FileHandler(os.path.join(self._log_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger

  def to(self, which):
    """Return a logger scoped to 'node', 'rank', or 'worker'."""
    if which not in ('node', 'rank', 'worker'):
      raise ValueError(f"unknown logging scope {which!r}; "
                       "expected 'node', 'rank' or 'worker'")
    with self._lock:
      worker = self._worker_rank
      first_worker = worker is None or worker == 0
      if which == 'node':
        owns = self._local_rank == 0 and first_worker
        name = f'node-{self._node_rank}'
      elif which == 'rank':
        owns = first_worker
        name = f'node-{self._node_rank}_rank-{self._rank}'
      else:
        owns = True
        name = f'node-{self._node_rank}_rank-{self._rank}_worker-{worker}'
      if not owns:
        return DummyLogger()
      if name not in self._loggers:
        self._loggers[name] = self._make_logger(name, name + '.log')
      return self._loggers[name]
