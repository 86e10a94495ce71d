"""Columnar row handles: the row stream's currency.

Copied from :mod:`lddl_tpu.loader.columnar` over the port's own Parquet
reader (:class:`lddl_tpu_torch.pipeline.parquet_io.RecordBatch` in place
of an Arrow record batch). The stream yields :class:`RowView` handles,
``(block, row)`` pairs over a shared :class:`ColumnarBlock`; a field is
converted once per column per block, on first access. The shuffle buffer
moves handles exactly as the JAX package's moves its handles (its draws
depend on stream position only), so the delivered sample order is the
same.

:func:`gather_token_counts` and :func:`gather_numeric` give collates
per-row values from whole-column numpy work. The JAX package counts
tokens with ``pyarrow.compute.count_substring``
(``lddl_tpu/loader/columnar.py:79``); here it is a numpy count of the
spaces in each value (:meth:`~lddl_tpu_torch.pipeline.parquet_io.
ByteArrays.token_counts`).
"""

import numpy as np


class ColumnarBlock:
  """A decoded record batch with per-column lazy conversion caches,
  shared by all :class:`RowView` handles over it."""

  __slots__ = ('_batch', '_index', '_pylists', '_npcols', '_tokcounts')

  def __init__(self, record_batch):
    self._batch = record_batch
    self._index = {n: i for i, n in enumerate(record_batch.names)}
    self._pylists = {}
    self._npcols = {}
    self._tokcounts = {}

  @property
  def num_rows(self):
    return self._batch.num_rows

  @property
  def names(self):
    return self._batch.names

  def pylist(self, name):
    """The column as a Python list (converted once, then cached)."""
    col = self._pylists.get(name)
    if col is None:
      col = self._batch.column(name)
      if isinstance(col, np.ndarray):
        col = col.tolist()
      self._pylists[name] = col
    return col

  def npcol(self, name):
    """The column as a numpy array (fixed-width types; cached)."""
    arr = self._npcols.get(name)
    if arr is None:
      arr = np.asarray(self._batch.column(name))
      self._npcols[name] = arr
    return arr

  def token_counts(self, name):
    """Per-row token counts of a single-space-joined string column: the
    spaces of each value + 1, counted in numpy over the whole column."""
    arr = self._tokcounts.get(name)
    if arr is None:
      arr = self._batch.byte_arrays(name).token_counts()
      self._tokcounts[name] = arr
    return arr


class RowView:
  """A lightweight ``(block, row)`` handle with dict-style field access.

  Drop-in for the per-row dicts the stream used to yield: supports
  ``row[name]``, ``in``, iteration over field names, ``items()`` etc.
  Pickling materializes to a plain dict (worker fallbacks and
  ``return_raw_samples`` consumers see ordinary dicts on the far side).
  """

  __slots__ = ('block', 'idx')

  def __init__(self, block, idx):
    self.block = block
    self.idx = idx

  def __getitem__(self, name):
    try:
      return self.block.pylist(name)[self.idx]
    except KeyError:
      raise KeyError(name) from None

  def get(self, name, default=None):
    if name in self.block._index:
      return self.block.pylist(name)[self.idx]
    return default

  def keys(self):
    return list(self.block.names)

  def __contains__(self, name):
    return name in self.block._index

  def __iter__(self):
    return iter(self.block.names)

  def __len__(self):
    return len(self.block.names)

  def items(self):
    return [(n, self[n]) for n in self.block.names]

  def values(self):
    return [self[n] for n in self.block.names]

  def to_dict(self):
    return {n: self[n] for n in self.block.names}

  def __eq__(self, other):
    if isinstance(other, RowView):
      return self.block is other.block and self.idx == other.idx
    if isinstance(other, dict):
      return self.to_dict() == other
    return NotImplemented

  def __repr__(self):
    return f'RowView({self.to_dict()!r})'

  def __reduce__(self):
    # Pickle as a plain dict: handles crossing a process boundary (the
    # oversize-batch fallback, raw-samples worker mode) must not drag
    # the whole decoded block along.
    return (dict, (self.to_dict(),))


#: Synthetic field a :class:`DeltaRowView` exposes alongside its block's
#: physical columns: which of the row's ``duplicate_factor`` mask-delta
#: copies this logical sample is.
COPY_FIELD = 'mask_delta_copy'


class DeltaRowView(RowView):
  """A logical sample of a mask-delta shard: ``(block, row, copy)``.

  Delta-format shards store one physical row per base pair plus
  ``duplicate_factor`` packed per-copy deltas; the dataset expands each
  physical row into ``duplicate_factor`` of these handles. Field access
  is exactly :class:`RowView` plus the synthetic ``mask_delta_copy``
  field, which the collate uses to slice this copy's segment out of the
  packed delta columns.
  """

  __slots__ = ('copy',)

  def __init__(self, block, idx, copy):
    super().__init__(block, idx)
    self.copy = copy

  def __getitem__(self, name):
    if name == COPY_FIELD:
      return self.copy
    return super().__getitem__(name)

  def get(self, name, default=None):
    if name == COPY_FIELD:
      return self.copy
    return super().get(name, default)

  def keys(self):
    return list(self.block.names) + [COPY_FIELD]

  def __contains__(self, name):
    return name == COPY_FIELD or super().__contains__(name)

  def __iter__(self):
    return iter(self.keys())

  def __len__(self):
    return len(self.block.names) + 1

  def items(self):
    return [(n, self[n]) for n in self.keys()]

  def values(self):
    return [self[n] for n in self.keys()]

  def to_dict(self):
    return {n: self[n] for n in self.keys()}

  def __eq__(self, other):
    if isinstance(other, DeltaRowView):
      return (self.block is other.block and self.idx == other.idx and
              self.copy == other.copy)
    if isinstance(other, dict):
      return self.to_dict() == other
    return NotImplemented

  def __repr__(self):
    return f'DeltaRowView({self.to_dict()!r})'


def materialize_rows(rows):
  """Plain dicts for raw-samples consumers (no-op on dict rows): the
  ``return_raw_samples`` debug contract is ordinary dicts, not handles."""
  return [r.to_dict() if isinstance(r, RowView) else r for r in rows]


def gather_token_counts(rows, name):
  """Per-row token counts for a single-space-joined string column, via
  the block-level numpy count; ``None`` when any row is not a
  :class:`RowView` (caller falls back to per-row string ops)."""
  n = len(rows)
  if not all(isinstance(r, RowView) for r in rows):
    return None
  return np.fromiter((r.block.token_counts(name)[r.idx] for r in rows),
                     np.int64, count=n)


def gather_numeric(rows, name, dtype):
  """Per-row values of a fixed-width column as ``dtype``, via the cached
  block-level numpy conversion; ``None`` on non-RowView rows."""
  n = len(rows)
  if not all(isinstance(r, RowView) for r in rows):
    return None
  return np.fromiter((r.block.npcol(name)[r.idx] for r in rows),
                     dtype, count=n)
