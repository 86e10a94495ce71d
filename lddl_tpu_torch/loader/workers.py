"""Within-rank worker-process loading.

A copy of :mod:`lddl_tpu.loader.workers` (numpy and the stdlib; the port
keeps its own copy and imports nothing of :mod:`lddl_tpu`). ``W`` worker
processes shard the *deterministic step sequence* (``step % W == w``):
every worker replays the identical cheap row stream but collates only its
own steps, so the batches a rank sees are **byte-identical for every
worker count** (and to ``num_workers=0``).

Because step ownership is static, the parent needs no reorder buffer:
step ``s`` always arrives on worker ``s % W``'s own queue, so pulling the
queues round-robin yields the exact serial order with per-worker
backpressure (each worker can run at most ``queue_depth`` steps ahead).

Batch transport (``transport=`` / ``LDDL_LOADER_TRANSPORT``):

  - ``'shm'`` (default): workers write each batch's arrays into a
    preallocated shared-memory slot ring (:mod:`.shm`) and the queue
    carries only ``(slot, spec)`` descriptors; ring occupancy is the
    backpressure. The parent copies arrays out of the slot by default;
    with ``zero_copy=True`` (or ``LDDL_LOADER_ZERO_COPY=1``) it yields
    views into the slot instead — valid until the *next* batch from the
    same worker is pulled (W steps of grace), which
    :func:`~lddl_tpu_torch.loader.device.prefetch_to_device` always
    satisfies (it copies each batch into pinned memory before it pulls
    the next), but ``list(loader)`` does not.
  - ``'pickle'``: the classic ``mp.Queue`` handoff (full pickle + pipe
    crossing per batch), kept for comparison and exotic batch payloads.
  - ``'network'``: pull the epoch from a data server (:mod:`.service`)
    instead of starting workers: the server already collated once for
    the whole fleet. A client that loses its server degrades to the
    local serial loader at its exact position and re-attaches later.

All transports deliver byte-identical batches; a batch that does not fit
its shm slot falls back to pickling for that step (counted in
:attr:`MultiprocessLoader.slot_overflows` and ``loader.shm_overflows``).

**Start method.** The parent of a port loader may hold a live CUDA
context, the device feed's producer thread and CUDA's own threads (and,
in the tests, jax and its threads): forking such a process can deadlock
the child. So the port never forks the parent: workers come from the
``forkserver`` (``spawn`` where there is none), whose server process is
started once, imports the worker's chain (:data:`PRELOAD` and the
factory's module) and forks each worker from that clean, single-threaded
state. The chain (``loader.workers``, ``loader.shm``, ``loader.bert``,
``loader.packed``, ``loader.codebert``, ``telemetry.metrics``,
``telemetry.trace``, ``telemetry.ledger``) imports no torch, so a worker
never pays torch's import and cannot touch CUDA. Workers start without
re-running the parent's ``__main__`` (multiprocessing would import the
main script or module afresh in every child, and with it torch), so the
factory must be importable by module name. The parent's ``LDDL_*``
environment is handed to each worker at start: a forkserver child
inherits the server's environment, which dates from the server's start.
"""

import contextlib
import importlib
import multiprocessing as _mp
import os
import queue as _queue
import sys
import threading
import time
import traceback
import types

from ..core import faults
from ..telemetry.ledger import (first_array_span, first_ndarray,
                                fingerprint_batch, fingerprint_packed,
                                get_ledger)
from ..telemetry.metrics import get_telemetry
from ..telemetry.trace import get_tracer
from .shm import SlotOverflow, default_slot_bytes, open_ring

_TRANSPORT_ENV = 'LDDL_LOADER_TRANSPORT'
_DEPTH_ENV = 'LDDL_LOADER_QUEUE_DEPTH'
_ZERO_COPY_ENV = 'LDDL_LOADER_ZERO_COPY'
# The queue-depth gauge reads qsize() on every worker queue — O(W)
# advisory syscalls — so it is sampled once per this many pulls instead
# of every step.
_DEPTH_SAMPLE_EVERY = 32
# Seconds between liveness checks while one side waits on the other: the
# parent on a worker's queue, a worker on a free slot or a full queue.
_POLL_SECONDS = 5

DEFAULT_FACTORY = ('lddl_tpu_torch.loader.bert',
                   'get_bert_pretrain_data_loader')
#: The loaders' arguments that tune the batch handoff.
HANDOFF_KNOBS = ('transport', 'queue_depth', 'zero_copy', 'slot_bytes')
#: Modules the forkserver imports once, before it forks any worker.
PRELOAD = ('lddl_tpu_torch.loader.workers',)

_start_lock = threading.Lock()


def worker_context(factory_module):
  """The forkserver (spawn where the platform has none): never a fork of
  the parent (see the module docstring)."""
  if 'forkserver' not in _mp.get_all_start_methods():
    return _mp.get_context('spawn')
  ctx = _mp.get_context('forkserver')
  # Takes effect when the server starts (once per parent process); a
  # server that is already running keeps its preload, which only costs
  # its children the imports.
  ctx.set_forkserver_preload(sorted({*PRELOAD, factory_module}))
  return ctx


@contextlib.contextmanager
def bare_main():
  """While the block runs, ``sys.modules['__main__']`` is a bare module:
  the preparation data of a process started in it names no main script
  or module for the child to import."""
  with _start_lock:
    main = sys.modules.get('__main__')
    sys.modules['__main__'] = types.ModuleType('__main__')
    try:
      yield
    finally:
      sys.modules['__main__'] = main


def start_processes(procs):
  """Start ``procs`` without re-running ``__main__`` in them
  (:func:`bare_main`)."""
  with bare_main():
    for p in procs:
      p.start()


def _resolve_transport(transport):
  t = (transport or os.environ.get(_TRANSPORT_ENV, '').strip().lower()
       or 'shm')
  if t not in ('shm', 'pickle', 'network'):
    raise ValueError(f'unknown loader transport {t!r} (shm|pickle|network)')
  return t


def _resolve_queue_depth(queue_depth):
  if queue_depth is None:
    queue_depth = int(os.environ.get(_DEPTH_ENV, '').strip() or 4)
  queue_depth = int(queue_depth)
  if queue_depth < 1:
    raise ValueError(f'queue_depth must be >= 1, got {queue_depth}')
  return queue_depth


def _resolve_zero_copy(zero_copy):
  if zero_copy is None:
    spec = os.environ.get(_ZERO_COPY_ENV, '').strip().lower()
    zero_copy = spec in ('1', 'true', 'on', 'yes')
  return bool(zero_copy)


def _resolve_factory(factory):
  module, attr = factory
  return getattr(importlib.import_module(module), attr)


def adopt_env(env):
  """Make this worker's ``LDDL_*`` environment exactly the parent's."""
  for k in [k for k in os.environ if k.startswith('LDDL_')]:
    if k not in env:
      del os.environ[k]
  os.environ.update(env)


def _export_worker_telemetry(tele, rank):
  """Write this worker's metric snapshot beside the rank's (pid-suffixed,
  so a ``telemetry.rank*.jsonl`` glob merges it): without this,
  worker-side series like ``loader.shm_wait_seconds`` would die with the
  process."""
  out_dir = os.environ.get('LDDL_TELEMETRY_DIR')
  if not (out_dir and tele.enabled):
    return
  try:
    tele.write_jsonl(
        os.path.join(out_dir, f'telemetry.rank{rank}.pid{os.getpid()}.jsonl'),
        rank=rank)
  except OSError:
    pass  # export is advisory; never kill a worker over it


def _parent_gone():
  parent = _mp.parent_process()
  return parent is not None and not parent.is_alive()


def _put(q, item):
  """Bounded put that gives up (SystemExit) once the parent is gone."""
  while True:
    try:
      q.put(item, timeout=_POLL_SECONDS)
      return
    except _queue.Full:
      if _parent_gone():
        raise SystemExit('loader worker: parent process is gone')


def _take_slot(free_q):
  while True:
    try:
      return free_q.get(timeout=_POLL_SECONDS)
    except _queue.Empty:
      if _parent_gone():
        raise SystemExit('loader worker: parent process is gone')


def _await_done(q, proc):
  """Wait (at most two polls' time) for a worker with no step left to
  report 'done' or die."""
  for _ in range(20 * _POLL_SECONDS):
    if not proc.is_alive():
      return
    try:
      if q.get(timeout=0.1)[0] in ('done', 'error'):
        return
    except _queue.Empty:
      pass


def _worker_main(env, build_kwargs, factory, epoch, first_step, exact, w,
                 num_workers, q, free_q, ring_desc):
  adopt_env(env)
  tele = get_telemetry()
  tracer = get_tracer()
  rank = int(build_kwargs.get('dp_rank') or 0)
  if tracer.enabled:
    # Fresh buffer under this worker's own identity, flushed to its own
    # trace.rank<R>.pid<P>.jsonl file.
    tracer.reset(rank=rank, per_pid=True)
  stack = contextlib.ExitStack()
  exported = False
  try:
    ring = None
    if ring_desc is not None:
      name, num_slots, slot_bytes = ring_desc
      ring = stack.enter_context(open_ring(num_slots, slot_bytes, name=name))
    wait_h = tele.histogram('loader.shm_wait_seconds')
    occupancy_g = tele.gauge('loader.shm_slot_occupancy')
    loader = _resolve_factory(factory)(**build_kwargs)
    # Position via the public contract, at the offset the *parent*
    # observed — whether it came baked into the factory kwargs
    # (samples_seen) or from a parent-side seek(); the freshly built
    # loader here knows only about the former.
    if exact:
      loader.seek(epoch, first_step, exact=True)
    else:  # the plain contract, which any factory's loader has
      loader.seek(epoch, first_step)
    for step, batch in loader.iter_steps((w, num_workers)):
      if ring is None:
        _put(q, ('batch', step, batch))
        continue
      t0 = time.monotonic()
      slot = _take_slot(free_q)
      wait_h.observe(time.monotonic() - t0)
      if tele.enabled or tracer.enabled:
        try:  # advisory, like the parent's depth gauge
          free = free_q.qsize()
        except NotImplementedError:
          free = None
        if free is not None:
          # Occupied slots = parent-side backpressure: a full ring means
          # the consumer is behind.
          occupancy_g.set(ring.num_slots - free)
          if tracer.enabled:
            tracer.counter(f'loader.shm_slot_occupancy.w{w}',
                           ring.num_slots - free)
      try:
        spec = ring.pack(slot, batch)
      except SlotOverflow:
        # The slot was never published; recycle it and pickle this batch.
        free_q.put(slot)
        _put(q, ('batch', step, batch))
        continue
      _put(q, ('slot', step, (slot, spec)))
    # Flush before signalling 'done': the parent may terminate() this
    # process the moment it sees the sentinel, which would race a
    # flush placed after it (and leave a half-written export's temp
    # file behind), so the finally below does not export again.
    tracer.flush()
    _export_worker_telemetry(tele, rank)
    exported = True
    _put(q, ('done', w, None))
  except BaseException:
    if not _parent_gone():
      try:
        q.put(('error', w, traceback.format_exc()), timeout=_POLL_SECONDS)
      except _queue.Full:
        pass
    raise
  finally:
    if not exported:  # the error path still leaves a tail
      tracer.flush()
      _export_worker_telemetry(tele, rank)
    stack.close()  # unmaps the ring
    if _parent_gone():
      # Nobody reads the queue any more: exit without flushing it.
      q.cancel_join_thread()


class MultiprocessLoader:
  """Drop-in epoch-iterable: ``W`` worker processes collate in parallel,
  batches arrive in exact serial order.

  ``build_kwargs`` must reconstruct the serial loader in a fresh process
  (so pass ``vocab_file``, not a live tokenizer object). The serial
  loader built in-process serves metadata (``__len__``,
  ``samples_per_epoch``) and tracks epoch/resume state.

  ``transport``/``queue_depth``/``zero_copy``/``slot_bytes`` tune the
  batch handoff (see the module docstring); the first three default from
  their ``LDDL_LOADER_*`` environment knobs. ``transport='network'``
  starts no worker (``num_workers`` may then be 0) and drains a data
  server as ``build_kwargs['comm']``'s rank. :attr:`start_seconds` holds,
  per epoch, the seconds from the start of its iteration to its first
  batch (the workers' start and their loader's build included).
  """

  def __init__(self, build_kwargs, num_workers, factory=DEFAULT_FACTORY,
               transport=None, queue_depth=None, zero_copy=None,
               slot_bytes=None):
    if build_kwargs.get('tokenizer') is not None:
      raise ValueError(
          'num_workers > 0 requires vocab_file (worker processes must '
          'reconstruct the tokenizer; a live tokenizer object does not '
          'pickle)')
    self._factory = tuple(factory)
    if self._factory[0] == '__main__':
      raise ValueError('the loader factory must be importable by module '
                       'name (workers do not import __main__)')
    self._kwargs = dict(build_kwargs)
    # The network transport's lease-based multi-client drain needs the
    # rank's real comm backend (for lease_store('serve')); capture it
    # before the workers' substitution below.
    self._client_comm = build_kwargs.get('comm')
    # Workers (and the network client's local fallback loader) take part
    # in no collective.
    self._kwargs['comm'] = None
    self._num_workers = int(num_workers)
    self._transport = _resolve_transport(transport)
    if self._num_workers < 1 and self._transport != 'network':
      raise ValueError(f'num_workers must be >= 1, got {num_workers}')
    self._net_source = None  # the network transport's client, made lazily
    self._exact = False  # the next epoch's seek was byte-exact
    self._queue_depth = _resolve_queue_depth(queue_depth)
    self._zero_copy = _resolve_zero_copy(zero_copy)
    self._serial = _resolve_factory(self._factory)(**build_kwargs)
    if slot_bytes is None:
      slot_bytes = default_slot_bytes(
          build_kwargs.get('batch_size_per_rank')
          or getattr(self._serial, 'batch_size', None) or 64,
          build_kwargs.get('max_seq_length') or 512)
    self._slot_bytes = int(slot_bytes)
    self.slot_overflows = 0
    self.start_seconds = []

  @classmethod
  def from_params(cls, params, factory):
    """The worker loader for a loader factory called with ``params``
    (its ``locals()`` on entry, so a parameter added to the factory
    later cannot be dropped from the workers' rebuild: that would break
    the byte identity with ``num_workers=0``). The handoff knobs shape
    the handoff, not the batches, so they stay out of the rebuild."""
    build = {k: v for k, v in params.items()
             if k not in HANDOFF_KNOBS and k != 'num_workers'}
    return cls(build, params['num_workers'], factory=factory,
               **{k: params[k] for k in HANDOFF_KNOBS})

  def __len__(self):
    return len(self._serial)

  @property
  def samples_per_epoch(self):
    return self._serial.samples_per_epoch

  @property
  def batch_size(self):
    return self._serial.batch_size

  @property
  def transport(self):
    return self._transport

  @property
  def queue_depth(self):
    return self._queue_depth

  @property
  def zero_copy(self):
    return self._zero_copy

  @property
  def epoch(self):
    return self._serial.epoch

  @epoch.setter
  def epoch(self, value):
    self._serial.epoch = value

  @property
  def batches_per_epoch(self):
    return self._serial.batches_per_epoch

  def seek(self, epoch, batch_index, exact=False):
    """Position the next iteration at collate key ``(epoch,
    batch_index)`` — delegates to the serial loader, which owns resume
    state for every transport (see :meth:`lddl_tpu_torch.loader.bert.
    BertPretrainLoader.seek`); ``exact`` reaches the workers' loaders.
    The network transport's stream is the server's uninterrupted one
    either way. Returns ``self``."""
    self._serial.seek(epoch, batch_index)
    self._exact = bool(exact)
    return self

  def tell(self):
    return self._serial.tell()

  def coordinate_of_batch(self, ordinal):
    return self._serial.coordinate_of_batch(ordinal)

  def _get(self, q, proc, w, stall_hist):
    """Queue get that fails fast (naming the worker) on a dead producer
    instead of blocking forever — a hard-killed worker sends no
    sentinel. Time blocked here is the parent's pull stall: the workers
    could not keep a batch ready ahead of the consumer."""
    t0 = time.monotonic()
    while True:
      try:
        item = q.get(timeout=_POLL_SECONDS)
        stall_hist.observe(time.monotonic() - t0)
        return item
      except _queue.Empty:
        if not proc.is_alive():
          raise RuntimeError(
              f'loader worker {w} died without reporting '
              f'(exitcode {proc.exitcode})')

  def _iter_network(self):
    """``transport='network'``: pull the epoch from a data server
    (:mod:`.service`) instead of starting collate workers. Same
    epoch/resume contract as the process path: the serial loader keeps
    the position, so a degraded client (or the next epoch) resumes at
    the exact deterministic step."""
    from .service import NetworkBatchSource
    epoch, first_step = self._serial.tell()
    self._serial.seek(epoch, 0)
    if self._net_source is None:
      self._net_source = NetworkBatchSource(
          build_kwargs=self._kwargs, factory=self._factory,
          comm=self._client_comm)
    ledger = get_ledger()
    for gi, batch in self._net_source.iter_steps(epoch, first_step):
      if ledger.enabled:
        # Same collate boundary as the process transports, recorded at
        # the same point (delivery to the consumer), keyed by the served
        # global index: for a single client gi IS the serial step, so
        # the stream audits against a local run's ledger.
        ledger.record('collate', fingerprint_batch(batch), epoch=epoch,
                      index=gi)
      yield batch
    self._serial.epoch = epoch + 1

  def __iter__(self):
    if self._transport == 'network':
      yield from self._iter_network()
      return
    t_start = time.perf_counter()
    epoch, first_step = self._serial.tell()
    exact, self._exact = self._exact, False
    # Mirror the serial loader exactly: it clears the resume offset the
    # moment an iteration starts, so len() of an abandoned-then-restarted
    # epoch reports the full count either way.
    self._serial.seek(epoch, 0)
    tele = get_telemetry()
    tracer = get_tracer()
    ledger = get_ledger()
    stall_h = tele.histogram('loader.pull_stall_seconds')
    start_h = tele.histogram('loader.worker_start_seconds')
    overflow_c = tele.counter('loader.shm_overflows')
    depth_g = tele.gauge('loader.queue_depth')
    W = self._num_workers
    depth = self._queue_depth
    ctx = worker_context(self._factory[0])
    env = {k: v for k, v in os.environ.items() if k.startswith('LDDL_')}
    queues, rings, free_qs, procs = [], [], [None] * W, []
    # Closed last, after the workers are gone: the parent owns every
    # segment name, so even a SIGKILLed worker cannot leak one.
    ring_scope = contextlib.ExitStack()
    try:
      queues = [ctx.Queue(maxsize=depth) for _ in range(W)]
      ring_descs = [None] * W
      if self._transport == 'shm':
        rings = [ring_scope.enter_context(open_ring(depth, self._slot_bytes))
                 for _ in range(W)]
        free_qs = [ctx.Queue(maxsize=depth) for _ in range(W)]
        for fq in free_qs:
          for s in range(depth):
            fq.put(s)
        ring_descs = [(r.name, depth, self._slot_bytes) for r in rings]
      procs = [
          ctx.Process(
              target=_worker_main,
              args=(env, self._kwargs, self._factory, epoch, first_step,
                    exact, w, W, queues[w], free_qs[w], ring_descs[w]),
              daemon=True, name=f'lddl-torch-loader-w{w}')
          for w in range(W)
      ]
      start_processes(procs)
      step = first_step
      pulls = 0
      held = [None] * W  # zero-copy mode: last yielded slot per worker
      while True:
        w = step % W
        if (tele.enabled or tracer.enabled) and \
            pulls % _DEPTH_SAMPLE_EVERY == 0:
          try:  # qsize is advisory (and absent on some platforms)
            qdepth = sum(q.qsize() for q in queues)
          except NotImplementedError:
            qdepth = None
          if qdepth is not None:
            depth_g.set(qdepth)
            tracer.counter('loader.queue_depth', qdepth)
        pulls += 1
        t_pull = time.monotonic() if tracer.enabled else 0.0
        kind, a, b = self._get(queues[w], procs[w], w, stall_h)
        if pulls == 1:
          self.start_seconds.append(time.perf_counter() - t_start)
          start_h.observe(self.start_seconds[-1])
        if tracer.enabled:
          tracer.complete('loader.pull', t_pull, time.monotonic() - t_pull,
                          args={'worker': w, 'step': step})
        if kind == 'slot':
          if a != step:
            raise RuntimeError(f'worker {w} sent step {a}, expected {step}')
          slot, spec = b
          buf = rings[w].buf
          if ledger.enabled:
            # The collate boundary, parent side: hash the packed slot
            # bytes directly (no unpack, no copy — the spec walk feeds
            # the hasher the same canonical stream a live batch would).
            # The corrupt drill fires first, into the slot's first
            # array, so a damaged batch is damaged for real.
            span = first_array_span(spec)
            if span is not None:
              faults.corrupt_bytes(
                  'ledger.corrupt',
                  memoryview(buf)[span[0]:span[0] + span[1]],
                  rank=ledger.rank, epoch=epoch, index=step)
            ledger.record('collate', fingerprint_packed(spec, buf),
                          epoch=epoch, index=step)
          if self._zero_copy:
            # Views stay valid until this worker's slot supply recycles;
            # release the previous one only now that the consumer asked
            # for a later batch.
            if held[w] is not None:
              free_qs[w].put(held[w])
            batch = rings[w].unpack(spec, copy=False)
            held[w] = slot
          else:
            batch = rings[w].unpack(spec, copy=True)
            free_qs[w].put(slot)
          yield batch
          step += 1
        elif kind == 'batch':
          if a != step:
            raise RuntimeError(f'worker {w} sent step {a}, expected {step}')
          if rings:
            self.slot_overflows += 1
            overflow_c.add(1)
          if ledger.enabled:
            arr = first_ndarray(b)
            if arr is not None:
              faults.corrupt_bytes('ledger.corrupt', arr.data,
                                   rank=ledger.rank, epoch=epoch,
                                   index=step)
            ledger.record('collate', fingerprint_batch(b), epoch=epoch,
                          index=step)
          yield b
          step += 1
        elif kind == 'done':
          # Worker w owns step `step`; it having nothing >= `step` means
          # no worker has any step >= `step` — the epoch is complete. The
          # others have no step left either: let them finish exporting
          # their telemetry before the cleanup below terminates them.
          for v in range(W):
            if v != w:
              _await_done(queues[v], procs[v])
          break
        else:
          raise RuntimeError(f'loader worker {a} failed:\n{b}')
      self._serial.epoch = epoch + 1
    finally:
      for p in procs:
        if p.is_alive():
          p.terminate()
      for p in procs:
        if p.pid is not None:
          p.join(timeout=30)
      for q in [*queues, *(fq for fq in free_qs if fq is not None)]:
        q.close()
        q.cancel_join_thread()
      ring_scope.close()
