"""Shared-memory batch slots: the zero-copy worker→parent transport.

A copy of :mod:`lddl_tpu.loader.shm` (numpy and the stdlib; the port
keeps its own copy and imports nothing of :mod:`lddl_tpu`). Per-bin
batch shapes are static, so the worker→parent handoff is a preallocated
ring of fixed-size slots in ``multiprocessing.shared_memory`` instead of
a pickle through a pipe per batch:

  - the parent creates one segment per worker (``num_slots`` slots of
    ``slot_bytes`` each) and hands every slot id to the worker via a small
    free-slot queue;
  - the worker writes each batch's arrays straight into its next free
    slot (:meth:`BatchRing.pack`) and sends only a tiny ``(slot, spec)``
    descriptor; waiting for a free slot is the transport's only
    backpressure (ring occupancy == steps in flight);
  - the parent materializes arrays from the slot (:meth:`BatchRing.unpack`
    — one memcpy, or zero-copy views in opt-in mode) and recycles the
    slot id.

Segments are named ``lddltorch_<pid>_<nonce>``: not ``lddl_``, the JAX
package's prefix, so that neither package's leak checks count the
other's live rings. The parent's iterator cleanup always unlinks them —
including on consumer abandonment and on a SIGKILLed worker (the parent
owns the name; no worker cooperation is needed to unlink). A batch that
does not fit its slot (mis-sized estimate, raw-samples mode) falls back
to the pickling queue for that step only, so the transport never wedges
on a fat outlier.
"""

import contextlib
import multiprocessing.shared_memory as _shared_memory
import os
import uuid

import numpy as np

_ALIGN = 64  # slot-internal array alignment (cache line / SIMD friendly)

SEGMENT_PREFIX = 'lddltorch_'


class SlotOverflow(Exception):
  """Raised by :meth:`BatchRing.pack` when a batch exceeds ``slot_bytes``."""


def default_slot_bytes(batch_size, max_seq_length):
  """Slot sizing heuristic for token-batch loaders.

  Every shipped loader yields at most ~6 ``[batch, seq]`` int32 planes
  (BERT: 5 + nsp; micro-batch mode adds a float32 ``loss_mask``); 8
  planes of headroom plus a fixed pad absorbs per-array alignment and
  future keys. Oversized batches still degrade gracefully via the
  pickling fallback, so the estimate only has to be usually-right.
  """
  plane = int(batch_size) * int(max_seq_length) * 4
  return max(1 << 20, 8 * plane + (1 << 16))


def _pack_into(obj, buf, offset, limit):
  """Write ``obj``'s arrays into ``buf[offset:limit]``; returns
  ``(spec, next_offset)``. The spec mirrors the object's structure with
  arrays replaced by ``('nd', dtype, shape, offset)`` placeholders;
  non-array leaves ride along by value (pickled with the descriptor)."""
  if isinstance(obj, np.ndarray):
    offset = (offset + _ALIGN - 1) & ~(_ALIGN - 1)
    end = offset + obj.nbytes
    if end > limit:
      raise SlotOverflow(f'batch needs > {limit - offset} bytes at offset '
                         f'{offset}')
    dst = np.ndarray(obj.shape, obj.dtype, buffer=buf, offset=offset)
    dst[...] = obj
    return ('nd', obj.dtype.str, obj.shape, offset), end
  if isinstance(obj, dict):
    items = []
    for k, v in obj.items():
      spec, offset = _pack_into(v, buf, offset, limit)
      items.append((k, spec))
    return ('map', items), offset
  if isinstance(obj, (list, tuple)):
    specs = []
    for v in obj:
      spec, offset = _pack_into(v, buf, offset, limit)
      specs.append(spec)
    return ('seq', isinstance(obj, tuple), specs), offset
  return ('py', obj), offset


def _unpack_from(spec, buf, copy):
  kind = spec[0]
  if kind == 'nd':
    _, dtype, shape, offset = spec
    arr = np.ndarray(shape, dtype, buffer=buf, offset=offset)
    return arr.copy() if copy else arr
  if kind == 'map':
    return {k: _unpack_from(s, buf, copy) for k, s in spec[1]}
  if kind == 'seq':
    _, is_tuple, specs = spec
    out = [_unpack_from(s, buf, copy) for s in specs]
    return tuple(out) if is_tuple else out
  return spec[1]  # 'py'


class BatchRing:
  """A fixed-slot shared-memory segment for one worker's batches (made
  and released by :func:`open_ring`)."""

  def __init__(self, segment, num_slots, slot_bytes):
    self._seg = segment
    self.num_slots = int(num_slots)
    self.slot_bytes = int(slot_bytes)

  @property
  def name(self):
    return self._seg.name

  @property
  def buf(self):
    """The segment's memory (what packed specs index into)."""
    return self._seg.buf

  def pack(self, slot, batch):
    """Write ``batch`` into ``slot``; returns the descriptor spec.

    Raises :class:`SlotOverflow` (leaving the slot reusable) when the
    batch does not fit."""
    base = slot * self.slot_bytes
    spec, _ = _pack_into(batch, self._seg.buf, base, base + self.slot_bytes)
    return spec

  def unpack(self, spec, copy=True):
    """Materialize a packed batch. ``copy=True`` (default) detaches the
    result from the slot; ``copy=False`` returns views into the segment —
    valid only until the slot is recycled (the zero-copy contract
    :class:`~lddl_tpu_torch.loader.workers.MultiprocessLoader` documents)."""
    return _unpack_from(spec, self._seg.buf, copy)


@contextlib.contextmanager
def open_ring(num_slots, slot_bytes, name=None):
  """A :class:`BatchRing` for the duration of a ``with`` block.

  ``name=None`` (the parent): a new segment named
  ``lddltorch_<pid>_<nonce>``, unlinked and unmapped when the block
  exits, whatever the exit — consumer abandonment and SIGKILLed workers
  included: the parent owns the name, so no worker cooperation is needed
  to unlink it. The unmap is best-effort: a consumer still holding
  zero-copy views keeps the (now anonymous) mapping alive until those
  arrays die.

  With ``name`` (a worker): the parent's segment, mapped for the block.
  Attaching auto-registers the name with the resource tracker
  (bpo-38119), but the tracker process is shared with the parent (its fd
  rides along under forkserver and spawn alike), so the re-registration
  dedupes and the parent's single unlink balances it.
  """
  seg = None
  try:
    if name is None:
      seg = _shared_memory.SharedMemory(
          name=f'{SEGMENT_PREFIX}{os.getpid()}_{uuid.uuid4().hex[:12]}',
          create=True, size=int(num_slots) * int(slot_bytes))
    else:
      seg = _shared_memory.SharedMemory(name=name)
    yield BatchRing(seg, num_slots, slot_bytes)
  finally:
    if seg is not None:
      if name is None:
        try:
          seg.unlink()
        except FileNotFoundError:
          pass
      try:
        seg.close()
      except BufferError:
        pass


def live_segments():
  """Names of currently-linked shared-memory segments of the port
  (Linux): the leak-detection hook the tests assert on."""
  try:
    return sorted(n for n in os.listdir('/dev/shm')
                  if n.startswith(SEGMENT_PREFIX))
  except (FileNotFoundError, NotADirectoryError, PermissionError):
    return []
