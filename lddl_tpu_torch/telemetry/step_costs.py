"""The step cost model: the FLOPs and operand bytes of one train step.

The port's counterpart of XLA's cost analysis, which
:func:`lddl_tpu.telemetry.roofline.compiled_step_costs` reads for a
compiled step. PyTorch has no compiler to ask, so the port counts the
ops themselves: :class:`StepCostCounter` is a ``TorchDispatchMode`` that
sees every aten op the step runs (its backward included) and sums, per
op,

  - **FLOPs**: ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` (and the other
    matmul-class ops of ``torch.utils.flop_counter``) count ``2·m·n·k``,
    the formula that module gives; elementwise and reduction ops count 1
    per element written, as XLA counts them; views, metadata and data
    movement (copies, casts, gathers, fills) count none;
  - **bytes**: each distinct input storage read once and each output
    written once; views and metadata ops count 0; an in-place op reads
    and writes its operand; ``_foreach_*`` ops count each list element;
  - **collectives** (``c10d`` ops): their buffers read and written, no
    FLOPs.

The flash kernels are ctypes launches the mode never sees. Their
wrappers (:mod:`lddl_tpu_torch.ops.flash_attention`) bill each launch's
work by one formula (:func:`~lddl_tpu_torch.ops.flash_attention.work`)
through :func:`bill` and keep their own torch ops, and the plain
versions they take on the CPU, out of the count (:func:`uncounted`): a
step counts the same on the CPU as on the card. The count is the
rank's own work: a tensor or seq rank counts its shards' ops.

The count observes and changes nothing: a counted step is bit-equal to
an uncounted one. The step cache
(:class:`~lddl_tpu_torch.training.pretrain.CompiledStepCache`) counts a
step once, at its miss, and bills the count on every step as
``train.xla_flops`` / ``train.xla_bytes``. Bytes are operand bytes, as
XLA's "bytes accessed" are, not DRAM traffic: the L2 cache serves reuse.

This module imports torch; :mod:`.roofline` does not import it (the data
server reads the verdict and never imports torch).
"""

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten

# Ops that move no data: views the schema does not mark as such, and
# allocations and metadata (views proper are found by ``is_view``).
_FREE = frozenset({
    _aten._unsafe_view, _aten._reshape_alias, _aten.empty, _aten.empty_like,
    _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
    _aten.lift_fresh, _aten.set_, _aten.resize_, _aten.record_stream,
})

# Ops that move data and compute nothing: bytes, no FLOPs.
_MOVES = frozenset({
    _aten.copy_, _aten._to_copy, _aten.clone, _aten.cat, _aten.stack,
    _aten.index_select, _aten.gather, _aten.embedding, _aten.index,
    _aten._unsafe_index, _aten.zeros, _aten.zeros_like, _aten.ones,
    _aten.ones_like, _aten.full, _aten.full_like, _aten.fill_, _aten.zero_,
    _aten.new_zeros, _aten.new_ones, _aten.new_full, _aten.arange,
    _aten.scalar_tensor, _aten._local_scalar_dense, _aten.lift_fresh_copy,
    _aten.constant_pad_nd, _aten.repeat, _aten.slice_scatter,
    _aten.select_scatter, _aten.split_with_sizes_copy, _aten._pin_memory,
})

_COLLECTIVES = ('c10d', '_c10d_functional')


class StepCosts:
  """The count of one step (or one window of steps).

  ``matmul_flops`` (aten's matmul-class ops), ``flash_flops`` (the flash
  kernels' launches, K1-K4; ``seg_flops`` is its K4 part, ``seg_kv_flops``
  the part of that of the launches that own kv tiles, dkv's),
  ``other_flops`` (elementwise and reductions) and ``bytes``, of which
  ``collective_bytes`` are the collectives' buffers.
  ``seg_tiles`` and ``seg_kv_tiles``, set by the step cache for a packed
  step, are the tile pairs the counted batch's K4 launches compute on the
  fwd/dq grid and on dkv's (:func:`~lddl_tpu_torch.ops.flash_attention.
  ring_tiles`: under ``seq`` every ring block's): each K4 launch bills
  its computed tiles, so each part is linear in its count, and
  :meth:`bill` scales it by another batch's count over the counted one.
  """

  __slots__ = ('matmul_flops', 'flash_flops', 'seg_flops', 'seg_kv_flops',
               'seg_tiles', 'seg_kv_tiles', 'other_flops', 'bytes',
               'collective_bytes')

  def __init__(self):
    self.matmul_flops = self.flash_flops = self.seg_flops = 0
    self.seg_kv_flops = self.seg_tiles = self.seg_kv_tiles = 0
    self.other_flops = self.bytes = self.collective_bytes = 0

  @property
  def flops(self):
    return self.matmul_flops + self.flash_flops + self.other_flops

  def bill(self, tiles=None):
    """``(flops, bytes)`` as floats for one step like the counted one whose
    batch computes ``tiles`` = ``(fwd/dq tiles, dkv tiles)`` (None: the
    counted batch's). The K4 FLOPs follow the tiles, exactly (integer
    arithmetic); the rest is fixed by the shapes. Bytes are the
    operands', which no tile skip changes."""
    flops = self.flops
    if tiles is not None and self.seg_tiles and self.seg_kv_tiles:
      q_flops = self.seg_flops - self.seg_kv_flops
      flops += (q_flops * tiles[0] // self.seg_tiles +
                self.seg_kv_flops * tiles[1] // self.seg_kv_tiles -
                self.seg_flops)
    return float(flops), float(self.bytes)

  def __repr__(self):
    return (f'StepCosts(matmul_flops={self.matmul_flops}, flash_flops='
            f'{self.flash_flops}, seg_flops={self.seg_flops}, seg_kv_flops='
            f'{self.seg_kv_flops}, seg_tiles={self.seg_tiles}, seg_kv_tiles='
            f'{self.seg_kv_tiles}, other_flops={self.other_flops}, bytes='
            f'{self.bytes}, collective_bytes={self.collective_bytes})')


def _touched_bytes(t):
  """Bytes a tensor's elements span: broadcast (stride-0) dims read once."""
  n = t.element_size()
  for size, stride in zip(t.shape, t.stride()):
    if stride:
      n *= size
  return n


def _tensors(tree):
  return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _by_storage(tensors):
  """{storage key: the most bytes any of ``tensors`` there spans}."""
  out = {}
  for t in tensors:
    key = t.untyped_storage().data_ptr()
    out[key] = max(out.get(key, 0), _touched_bytes(t))
  return out


def _mutated(func, args, kwargs):
  """(operands an in-place op reads and writes, ``out=`` operands it only
  writes)."""
  inout, out = [], []
  for i, arg in enumerate(func._schema.arguments):
    if arg.alias_info is None or not arg.alias_info.is_write:
      continue
    value = args[i] if i < len(args) else kwargs.get(arg.name)
    (out if arg.name.startswith('out') else inout).extend(_tensors(value))
  return inout, out


class StepCostCounter(TorchDispatchMode):
  """``with StepCostCounter() as c:`` runs the code inside and counts its
  ops into ``c.costs`` (:class:`StepCosts`); see the module docstring for
  the rules. The op results are the uncounted ones."""

  def __init__(self):
    super().__init__()
    self.costs = StepCosts()
    self._paused = 0

  def __enter__(self):
    _ACTIVE.append(self)
    return super().__enter__()

  def __exit__(self, *exc):
    _ACTIVE.remove(self)
    return super().__exit__(*exc)

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    result = func(*args, **kwargs)
    if not self._paused:
      self._count(func, args, kwargs, result)
    return result

  def _count(self, func, args, kwargs, result):
    packet = func._overloadpacket
    if func.is_view or packet in _FREE:
      return
    inout, out_args = _mutated(func, args, kwargs)
    reads = _by_storage(_tensors((args, kwargs)))
    for t in out_args:
      reads.pop(t.untyped_storage().data_ptr(), None)
    results = _tensors(result)
    if func.namespace in _COLLECTIVES:
      writes = _by_storage(inout + out_args + results)
      moved = sum(reads.values()) + sum(writes.values())
      self.costs.bytes += moved
      self.costs.collective_bytes += moved
      return
    # A result that shares an input's storage is the in-place operand
    # returned (counted with it) or a view of an input.
    fresh = [t for t in results
             if t.untyped_storage().data_ptr() not in reads]
    writes = _by_storage(inout + out_args + fresh)
    self.costs.bytes += sum(reads.values()) + sum(writes.values())
    if packet in flop_registry:
      self.costs.matmul_flops += int(flop_registry[packet](
          *args, **kwargs, out_val=result))
    elif packet not in _MOVES:
      self.costs.other_flops += sum(t.numel() for t in inout + out_args +
                                    fresh)

  @contextlib.contextmanager
  def paused(self):
    self._paused += 1
    try:
      yield
    finally:
      self._paused -= 1


# The counters entered on this process, innermost last.
_ACTIVE = []


def active():
  """The innermost :class:`StepCostCounter` entered, or None."""
  return _ACTIVE[-1] if _ACTIVE else None


def bill(flops, nbytes, seg=False, kv_owned=False):
  """Add a flash launch's work to the active counter (if any): ``flops``
  and ``nbytes`` from the kernels' formula; ``seg`` for a K4 launch,
  ``kv_owned`` for one whose CTAs own kv tiles (dkv)."""
  counter = active()
  if counter is None:
    return
  costs = counter.costs
  costs.flash_flops += flops
  costs.bytes += nbytes
  if seg:
    costs.seg_flops += flops
    if kv_owned:
      costs.seg_kv_flops += flops


@contextlib.contextmanager
def uncounted():
  """Inside, the active counter (if any) counts no op: a kernel wrapper's
  own torch ops and the plain versions it runs on the CPU, whose work it
  bills by formula instead."""
  counter = active()
  if counter is None:
    yield
    return
  with counter.paused():
    yield

