"""Preemption-tolerant training: the pieces of
:mod:`lddl_tpu.training.elastic` that one process needs.

- :class:`AsyncCheckpointWriter`: checkpoint writes overlapped with
  compute on :class:`~lddl_tpu_torch.pipeline.pool.AsyncShardWriter`'s
  bounded-depth, first-error-wins write-back (``LDDL_ASYNC_CKPT``). The
  step loop only blocks at backpressure, and a lost background write
  surfaces as an exception on the next step.
- :class:`PreemptionGuard`: SIGTERM (or a maintenance-notice file,
  ``LDDL_PREEMPTION_FILE``) sets a flag the step loop checks at every
  step boundary; the loop then flushes the writer and lands one final
  synchronous checkpoint.

The JAX package's ``RankMembership`` (lease-store membership over the
comm backend) waits for the multi-GPU slice.
"""

import os
import signal
import threading

from ..pipeline.pool import AsyncShardWriter, WriteBackError  # noqa: F401
from ..telemetry import get_telemetry


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
