"""Host-batch -> device feed with prefetch.

Counterpart of :func:`lddl_tpu.loader.device.prefetch_to_device` for one
CUDA card: a producer thread pulls numpy batch dicts from the loader,
copies each into pinned host tensors and issues the host-to-device copies
with ``non_blocking=True`` on a side :class:`torch.cuda.Stream`, recording
one event per batch. The consumer makes its current stream wait on that
event before it uses the batch and calls ``record_stream`` so the caching
allocator does not hand the memory to the side stream's next copy while
the step still reads it. At most ``size`` batches are in flight.

With ``device='cpu'`` batches are plain ``torch.from_numpy`` copies (the
tests' path).

With ``LDDL_LEDGER`` on, the producer records each host batch's ``device``
fingerprint before the pinned copy, as the JAX package's feed does before
its transfer. Its key is the batch's ledger coordinate ``(epoch, index)``
when the caller passes ``coordinate`` (the train loop and the step replay
pass the loader's ``coordinate_of_batch``), so the record aligns with the
``collate`` record of the same batch and a run of many epochs, or one
resumed mid-epoch, keys each batch once; without it the key is the
batch's index in this feed alone, as in the JAX package (whose second
epoch then records ``index=0..`` again). A batch may be a zero-copy
view into a worker's shared-memory slot
(:class:`~lddl_tpu_torch.loader.workers.MultiprocessLoader` with
``zero_copy=True``), valid until the producer pulls the next batch: the
producer therefore copies each batch into fresh pinned memory
(``pin_memory()`` copies synchronously) before it pulls the next, and
never registers a slot as pinned memory or starts an asynchronous copy
straight from it. When the producer ends, for whatever reason, it closes
its source iterator, so a worker loader's processes and rings go with it.

The producer does its CUDA work (pinning, issuing the copies) under
:data:`CUDA_FEED_LOCK`: a CUDA graph capture in global mode fails on any
other thread's CUDA call, so the train step's cache holds the lock while
it captures. Each batch's placement is timed into the
``train.h2d_seconds`` histogram and traced as a ``train.h2d`` span, as in
the JAX package's feed.
"""

import collections
import os
import queue
import threading
import warnings

import numpy as np
import torch

from ..telemetry.ledger import fingerprint_batch, get_ledger
from ..telemetry.metrics import get_telemetry
from ..telemetry.trace import get_tracer

_DONE = object()
# Held by a feed's producer thread while it pins and copies a batch, and
# by whoever must keep other threads' CUDA calls away for a while.
CUDA_FEED_LOCK = threading.Lock()


def _close_join_timeout():
  """Bound on waiting out the producer at close() (env
  ``LDDL_PREFETCH_JOIN_TIMEOUT`` seconds, default 10)."""
  try:
    return max(0.1,
               float(os.environ.get('LDDL_PREFETCH_JOIN_TIMEOUT', '10')))
  except ValueError:
    return 10.0


def _host_copy(batch):
  return {k: torch.from_numpy(np.array(v, copy=True))
          for k, v in batch.items()}


def coordinate_from(loader):
  """The ``coordinate`` argument of :func:`prefetch_to_device` for a feed
  of ``loader``'s batches from where it stands now (its ``tell()``, taken
  before the iteration starts): the feed's k-th batch is the loader's
  ``coordinate_of_batch`` k batches on, across an epoch's end too. None
  for a loader without that positioning contract."""
  tell = getattr(loader, 'tell', None)
  of_batch = getattr(loader, 'coordinate_of_batch', None)
  if tell is None or of_batch is None:
    return None
  epoch, index = tell()
  ordinal0 = epoch * loader.batches_per_epoch + index
  return lambda ordinal: of_batch(ordinal0 + ordinal)


def prefetch_to_device(iterator, device, size=2, coordinate=None):
  """Yield batches of ``iterator`` (numpy dicts, or lists of micro-batch
  dicts) as tensor dicts (or lists of them) on ``device``, keeping up to
  ``size`` in flight.

  ``coordinate`` maps a batch's ordinal in this feed to its ledger
  coordinate ``(epoch, index)``, the key of its ``device`` record.

  A producer error is raised in the consumer at the batch where it
  happened. Closing the generator (or dropping it) stops the producer and
  joins it within ``LDDL_PREFETCH_JOIN_TIMEOUT`` seconds.
  """
  device = torch.device(device)
  if device.type not in ('cpu', 'cuda'):
    raise ValueError(f'prefetch_to_device: unsupported device {device}')
  side = torch.cuda.Stream(device=device) if device.type == 'cuda' else None
  h2d_hist = get_telemetry().histogram('train.h2d_seconds')
  tracer = get_tracer()
  q = queue.Queue(maxsize=size)
  stop = threading.Event()
  err = []

  def _put(item):
    # Bounded put that gives up once the consumer has gone away, so the
    # producer (and the batches it holds) never leaks.
    while not stop.is_set():
      try:
        q.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def _to_device(batch):
    # A micro-batch list is placed element by element behind one event,
    # as the JAX feed places lists.
    micro = isinstance(batch, (list, tuple))
    dicts = list(batch) if micro else [batch]
    if side is None:
      placed, ready = [_host_copy(d) for d in dicts], None
    else:
      pinned = [{k: torch.from_numpy(np.asarray(v)).pin_memory()
                 for k, v in d.items()} for d in dicts]
      with torch.cuda.stream(side):
        placed = [{k: t.to(device, non_blocking=True) for k, t in d.items()}
                  for d in pinned]
        ready = torch.cuda.Event()
        ready.record(side)
    return (placed if micro else placed[0]), ready

  ledger = get_ledger()

  def _producer():
    try:
      for index, batch in enumerate(iterator):
        if ledger.enabled:
          # The device boundary: the last stop where the batch is still
          # host bytes, hashed before the pinned copy.
          if coordinate is None:
            key = {'index': index}
          else:
            epoch, at = coordinate(index)
            key = {'epoch': epoch, 'index': at}
          ledger.record('device', fingerprint_batch(batch), **key)
        with CUDA_FEED_LOCK, tracer.span('train.h2d'), h2d_hist.time():
          item = _to_device(batch)
        if not _put(item):
          return
    except BaseException as e:  # propagate into the consumer
      err.append(e)
    finally:
      try:
        # A worker loader's processes and rings end with its iterator.
        close = getattr(iterator, 'close', None)
        if close is not None:
          close()
      except BaseException as e:
        err.append(e)
      _put(_DONE)

  t = threading.Thread(target=_producer, daemon=True,
                       name='lddl-torch-prefetch')
  t.start()
  try:
    while True:
      item = q.get()
      if item is _DONE:
        if err:
          raise err[0]
        return
      placed, ready = item
      if ready is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(ready)
        for d in (placed if isinstance(placed, list) else [placed]):
          for tensor in d.values():
            tensor.record_stream(current)
      yield placed
  finally:
    stop.set()
    t.join(timeout=_close_join_timeout())
    if t.is_alive():
      warnings.warn('prefetch producer still running '
                    f'{_close_join_timeout():g}s after close(); abandoning '
                    'the daemon thread')


class SeqlenAwarePrefetcher:
  """Pull-style iterator with ``next_seqlen()`` lookahead for pipeline
  schedulers (reference ``torch_mp/dataloader.py:103-133``): buffers one
  decoded batch ahead so the upcoming static shape is known before the
  batch is consumed. A copy of the JAX package's.
  """

  def __init__(self, loader_iter, seqlen_of_batch):
    self._it = iter(loader_iter)
    self._seqlen_of = seqlen_of_batch
    self._pending = collections.deque()

  def close(self):
    """Close the wrapped iterator and drop the lookahead buffer.

    Abandoning a :func:`prefetch_to_device` stream mid-epoch without this
    leaks its producer thread (and the batches it holds): generator
    ``close()`` only runs when the *generator* is dropped, and this
    wrapper keeps a reference to it.
    """
    self._pending.clear()
    close = getattr(self._it, 'close', None)
    if close is not None:
      close()

  def next_seqlen(self):
    if not self._pending:
      self._pending.append(next(self._it))
    return self._seqlen_of(self._pending[0])

  def __iter__(self):
    return self

  def __next__(self):
    if self._pending:
      return self._pending.popleft()
    return next(self._it)
