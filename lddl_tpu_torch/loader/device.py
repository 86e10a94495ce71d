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

The producer does its CUDA work (pinning, issuing the copies) under
:data:`CUDA_FEED_LOCK`: a CUDA graph capture in global mode fails on any
other thread's CUDA call, so the train step's cache holds the lock while
it captures. Each batch's placement is timed into the
``train.h2d_seconds`` histogram and traced as a ``train.h2d`` span, as in
the JAX package's feed.
"""

import os
import queue
import threading
import warnings

import numpy as np
import torch

from ..telemetry import get_telemetry, get_tracer

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


def prefetch_to_device(iterator, device, size=2):
  """Yield batches of ``iterator`` (numpy dicts) as tensor dicts on
  ``device``, keeping up to ``size`` in flight.

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
    if side is None:
      return _host_copy(batch), None
    pinned = {k: torch.from_numpy(np.asarray(v)).pin_memory()
              for k, v in batch.items()}
    with torch.cuda.stream(side):
      placed = {k: t.to(device, non_blocking=True)
                for k, t in pinned.items()}
      ready = torch.cuda.Event()
      ready.record(side)
    return placed, ready

  def _producer():
    try:
      for batch in iterator:
        with CUDA_FEED_LOCK, tracer.span('train.h2d'), h2d_hist.time():
          item = _to_device(batch)
        if not _put(item):
          return
    except BaseException as e:  # propagate into the consumer
      err.append(e)
    finally:
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
        for tensor in placed.values():
          tensor.record_stream(current)
      yield placed
  finally:
    stop.set()
    t.join(timeout=_close_join_timeout())
    if t.is_alive():
      warnings.warn('prefetch producer still running '
                    f'{_close_join_timeout():g}s after close(); abandoning '
                    'the daemon thread')
