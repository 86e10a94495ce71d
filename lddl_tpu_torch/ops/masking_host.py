"""Static MLM masking of the BERT preprocessor: the host backend.

The host half of the port's :mod:`lddl_tpu.ops.masking` (numpy and the
native library only, no torch, so a pool worker that masks on the host
never imports torch): copies of the JAX package's native C++ pass
(``native/src/masking.cpp``) and its numpy mirrors (Philox4x32-10 for the
fused partition form, numpy's Philox generator for the padded-matrix
form), bit for bit the JAX package's. :mod:`.masking` holds the device
backend and re-exports these names.
"""

import os

import numpy as np


def ragged_indices(lengths):
  """(row_idx, within_row_idx) index arrays for ragged row extraction."""
  lengths = np.asarray(lengths, dtype=np.int64)
  n = len(lengths)
  total = int(lengths.sum())
  starts = np.zeros(n, dtype=np.int64)
  np.cumsum(lengths[:-1], out=starts[1:])
  row_idx = np.repeat(np.arange(n, dtype=np.int64), lengths)
  col_idx = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
  return row_idx, col_idx


def assemble_pair_matrix(flat_ids, a_ranges, b_ranges, cls_id, sep_id,
                         max_len, pad_id=0):
  """Assemble ``[CLS] A [SEP] B [SEP]`` rows into a padded int32 matrix.

  ``a_ranges``/``b_ranges``: int64 ``[N, 2]`` (start, end) index ranges
  into ``flat_ids``. Returns (ids_mat [N, max_len], row_len [N], na [N]).
  """
  a_ranges = np.asarray(a_ranges, dtype=np.int64).reshape(-1, 2)
  b_ranges = np.asarray(b_ranges, dtype=np.int64).reshape(-1, 2)
  n = len(a_ranges)
  na = (a_ranges[:, 1] - a_ranges[:, 0]).astype(np.int32)
  nb = (b_ranges[:, 1] - b_ranges[:, 0]).astype(np.int32)
  row_len = (na + nb + 3).astype(np.int32)
  if n and row_len.max() > max_len:
    raise ValueError(f'pair of {row_len.max()} tokens exceeds max_len '
                     f'{max_len}')
  mat = np.full((n, max_len), pad_id, dtype=np.int32)
  if n == 0:
    return mat, row_len, na
  rows = np.arange(n)
  na64, nb64 = na.astype(np.int64), nb.astype(np.int64)
  ra, ca = ragged_indices(na64)
  mat[ra, ca + 1] = flat_ids[a_ranges[ra, 0] + ca]
  rb, cb = ragged_indices(nb64)
  mat[rb, cb + 2 + na64[rb]] = flat_ids[b_ranges[rb, 0] + cb]
  mat[rows, 0] = cls_id
  mat[rows, 1 + na64] = sep_id
  mat[rows, row_len.astype(np.int64) - 1] = sep_id
  return mat, row_len, na


def _special_and_valid(ids_shape_l, row_len, na):
  pos = np.arange(ids_shape_l, dtype=np.int32)[None, :]
  row_len = row_len[:, None]
  na = na[:, None]
  is_special = (pos == 0) | (pos == 1 + na) | (pos == row_len - 1)
  valid = (pos < row_len) & ~is_special
  return valid


_TOPK_NATIVE = None  # None = unprobed, False = unavailable


def _native():
  """The host C++ library, or False where it cannot be built (the numpy
  mirrors give the same bits), probed once."""
  global _TOPK_NATIVE
  if _TOPK_NATIVE is None:
    try:
      from ..native.build import library
      _TOPK_NATIVE = library()
    except Exception:  # no toolchain: fall back quietly, like pairing
      _TOPK_NATIVE = False
  return _TOPK_NATIVE


def _select_topk(keys, k, n, l):
  """(rows, cols, picked_bool): the k[r] smallest keys of each row, in
  row-major ascending (row, col) order — identical to np.nonzero on the
  picked matrix. Native C++ per-row nth_element when the toolchain is
  available; numpy argpartition otherwise (same output)."""
  native = _native()
  if native:
    import ctypes
    i64p = ctypes.POINTER(ctypes.c_int64)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    # Clamp here, before the offsets are sized from k — the C++ clamp
    # alone would leave out-of-range rows with unwritten output slots.
    k64 = np.clip(np.asarray(k, dtype=np.int64), 0, l)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(k64, out=offsets[1:])
    cols = np.empty(int(offsets[-1]), dtype=np.int64)
    # Modest thread cap (wordpiece precedent): the executor already runs
    # one worker process per core, so per-call threads must not multiply
    # against that.
    native.lddl_mask_topk(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        k64.ctypes.data_as(i64p), n, l, offsets.ctypes.data_as(i64p),
        cols.ctypes.data_as(i64p), min(8, os.cpu_count() or 1))
    rows = np.repeat(np.arange(n, dtype=np.int64), k64)
    picked = np.zeros((n, l), dtype=bool)
    picked[rows, cols] = True
    return rows, cols, picked
  kmax = int(k.max())
  picked = np.zeros((n, l), dtype=bool)
  if kmax < l:
    part = np.argpartition(keys, kmax, axis=1)[:, :kmax]
    vals = np.take_along_axis(keys, part, axis=1)
    sel = np.take_along_axis(part, np.argsort(vals, axis=1), axis=1)
  else:
    sel = np.argsort(keys, axis=1)
  in_k = np.arange(sel.shape[1], dtype=np.int64)[None, :] < k[:, None]
  rr, cc = np.nonzero(in_k)
  picked[rr, sel[rr, cc]] = True
  pr, pc = np.nonzero(picked)
  return pr, pc, picked


def _philox4x32_np(c0, c1, c2, c3, k0, k1):
  """Vectorized Philox4x32-10 over uint32 arrays — the numpy mirror of
  ``philox4x32`` in ``native/src/masking.cpp`` (same round function and
  key schedule, bit-for-bit). Returns the four uint32 output lanes."""
  c0 = np.asarray(c0, np.uint32)
  c1 = np.asarray(c1, np.uint32)
  c2 = np.asarray(c2, np.uint32)
  c3 = np.asarray(c3, np.uint32)
  M0, M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
  for i in range(10):
    # Key schedule in Python ints (explicit uint32 wrap, no numpy
    # overflow warnings): round i uses (k0 + i*W0, k1 + i*W1).
    ki0 = np.uint32((int(k0) + i * 0x9E3779B9) & 0xffffffff)
    ki1 = np.uint32((int(k1) + i * 0xBB67AE85) & 0xffffffff)
    p0 = c0.astype(np.uint64) * M0
    p1 = c2.astype(np.uint64) * M1
    hi0, lo0 = (p0 >> np.uint64(32)).astype(np.uint32), p0.astype(np.uint32)
    hi1, lo1 = (p1 >> np.uint64(32)).astype(np.uint32), p1.astype(np.uint32)
    c0, c1, c2, c3 = hi1 ^ c1 ^ ki0, lo1, hi0 ^ c3 ^ ki1, lo0
  return c0, c1, c2, c3


# decide thresholds: floor(0.8 * 2**32) and floor(0.9 * 2**32).
_MASK_THRESHOLD = np.uint32(3435973836)
_RAND_THRESHOLD = np.uint32(3865470566)
_MASK_DOMAIN = np.uint32(0x6d61736b)  # "mask"


def _pick_counts(na, nb, masked_lm_ratio, max_predictions):
  """Per-row pick count: ``max(1, rint(row_len * ratio))`` clamped to the
  valid-position count and ``max_predictions`` (same clamp as
  :func:`mask_batch_host`)."""
  row_len = na + nb + 3
  k = np.maximum(1, np.rint(row_len * masked_lm_ratio).astype(np.int64))
  if max_predictions is not None:
    k = np.minimum(k, max_predictions)
  return np.minimum(k, na + nb)


def _mask_partition_numpy(flat_ids, a_ranges, b_ranges, na, nb, offs_a,
                          offs_b, k, offs_k, seed, vocab_size, mask_id):
  """Numpy mirror of ``lddl_mask_partition`` — identical draw scheme,
  bit-identical outputs (parity-tested). Vectorized across rows; the
  partial Fisher-Yates runs as ``kmax`` (~20) batched swap steps."""
  n = len(na)
  L = na + nb
  ra, ca = ragged_indices(na)
  flat_a = flat_ids[a_ranges[ra, 0] + ca]
  rb, cb = ragged_indices(nb)
  flat_b = flat_ids[b_ranges[rb, 0] + cb]
  total_k = int(offs_k[-1])
  if total_k == 0:
    return (flat_a, flat_b, np.zeros(0, np.uint16), np.zeros(0, np.int32))
  kmax = int(k.max())
  rows = np.arange(n, dtype=np.uint32)
  t_grid = np.arange(kmax, dtype=np.uint32)
  x0, x1, x2, _ = _philox4x32_np(
      np.broadcast_to(t_grid[None, :], (n, kmax)),
      np.broadcast_to(rows[:, None], (n, kmax)), _MASK_DOMAIN, np.uint32(0),
      np.uint32(seed & 0xffffffff), np.uint32((int(seed) >> 32) & 0xffffffff))
  # Partial Fisher-Yates over the valid-position indices [0, L).
  Lmax = int(L.max())
  arr = np.broadcast_to(np.arange(Lmax, dtype=np.int32), (n, Lmax)).copy()
  v_mat = np.zeros((n, kmax), dtype=np.int32)
  for t in range(kmax):
    act = np.nonzero(k > t)[0]
    span = (L[act] - t).astype(np.uint64)
    j = t + ((x0[act, t].astype(np.uint64) * span) >> np.uint64(32)).astype(
        np.int64)
    a_t = arr[act, t].copy()
    a_j = arr[act, j]
    arr[act, t] = a_j
    arr[act, j] = a_t
    v_mat[act, t] = a_j
  rand_mat = ((x2.astype(np.uint64) * np.uint64(vocab_size))
              >> np.uint64(32)).astype(np.int32)
  # Sort each row's picks by position (values are unique — no tie issue).
  active = t_grid[None, :] < k[:, None]
  v_sort = np.where(active, v_mat, np.iinfo(np.int32).max)
  order = np.argsort(v_sort, axis=1)
  v_sorted = np.take_along_axis(v_sort, order, axis=1)
  d_sorted = np.take_along_axis(x1, order, axis=1)
  r_sorted = np.take_along_axis(rand_mat, order, axis=1)
  sel = active  # after argsort the first k[r] slots per row are the picks
  ri = np.repeat(np.arange(n, dtype=np.int64), k)
  v = v_sorted[sel]
  decide = d_sorted[sel]
  rand_ids = r_sorted[sel]
  in_a = v < na[ri]
  pos = np.where(in_a, v + 1, v + 2).astype(np.uint16)
  src = np.where(in_a, a_ranges[ri, 0] + v, b_ranges[ri, 0] + v - na[ri])
  label_ids = flat_ids[src].astype(np.int32)
  new_ids = np.where(decide < _MASK_THRESHOLD, np.int32(mask_id),
                     np.where(decide >= _RAND_THRESHOLD, rand_ids,
                              label_ids))
  tgt_a = offs_a[ri] + v
  tgt_b = offs_b[ri] + v - na[ri]
  flat_a[tgt_a[in_a]] = new_ids[in_a]
  flat_b[tgt_b[~in_a]] = new_ids[~in_a]
  return flat_a, flat_b, pos, label_ids


def _check_offsets(name, offs, lens):
  """Caller-provided output offsets must be the exact cumsum of the
  segment lengths: the native kernel scatters through them unchecked, so
  a mismatched array means silent out-of-bounds writes, not an error."""
  offs = np.asarray(offs)
  n = len(lens)
  if offs.shape != (n + 1,):
    raise ValueError(
        f'{name} must have shape ({n + 1},), got {offs.shape}')
  if int(offs[0]) != 0 or not np.array_equal(np.diff(offs), lens):
    raise ValueError(
        f'{name} is not the cumulative sum of the segment lengths '
        '(expected offs[0] == 0 and diff(offs) == lengths)')


def mask_partition_host(flat_ids, a_ranges, b_ranges, *, masked_lm_ratio,
                        vocab_size, mask_id, seed, max_predictions=None,
                        offs_a=None, offs_b=None):
  """Fused ragged host masking for a whole partition.

  One native C++ pass (``lddl_mask_partition``) gathers the A/B id
  columns, draws masked positions via partial Fisher-Yates on a
  counter-based Philox4x32-10 stream (k draws per row instead of a dense
  [N, L] uniform matrix), applies the 80/10/10 recipe, and emits sorted
  positions + label ids — no padded id matrix is ever materialized.
  The numpy fallback produces bit-identical outputs when no toolchain is
  available.

  Determinism contract: bit-identical given (seed, inputs) within a
  framework version; the stream is NOT the padded-matrix
  :func:`mask_batch_host` stream.

  Returns ``(flat_a, flat_b, positions, label_ids, k)`` — ``flat_a`` /
  ``flat_b`` are the post-masking ragged id columns (offsets = cumsum of
  na/nb), ``positions`` uint16 / ``label_ids`` int32 are ragged by ``k``.
  """
  a_ranges = np.ascontiguousarray(a_ranges, dtype=np.int64).reshape(-1, 2)
  b_ranges = np.ascontiguousarray(b_ranges, dtype=np.int64).reshape(-1, 2)
  flat_ids = np.ascontiguousarray(flat_ids, dtype=np.int32)
  n = len(a_ranges)
  na = a_ranges[:, 1] - a_ranges[:, 0]
  nb = b_ranges[:, 1] - b_ranges[:, 0]
  if offs_a is None:
    offs_a = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(na, out=offs_a[1:])
  else:
    _check_offsets('offs_a', offs_a, na)
  if offs_b is None:
    offs_b = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nb, out=offs_b[1:])
  else:
    _check_offsets('offs_b', offs_b, nb)
  k = _pick_counts(na, nb, masked_lm_ratio, max_predictions)
  offs_k = np.zeros(n + 1, dtype=np.int64)
  np.cumsum(k, out=offs_k[1:])
  native = _native()
  if not native or n == 0:
    flat_a, flat_b, pos, label_ids = _mask_partition_numpy(
        flat_ids, a_ranges, b_ranges, na, nb, offs_a, offs_b, k, offs_k,
        seed, vocab_size, mask_id)
    return flat_a, flat_b, pos, label_ids, k
  import ctypes
  c = ctypes
  i32p = c.POINTER(c.c_int32)
  i64p = c.POINTER(c.c_int64)
  offs_a = np.ascontiguousarray(offs_a, dtype=np.int64)
  offs_b = np.ascontiguousarray(offs_b, dtype=np.int64)
  flat_a = np.empty(int(offs_a[-1]), dtype=np.int32)
  flat_b = np.empty(int(offs_b[-1]), dtype=np.int32)
  pos = np.empty(int(offs_k[-1]), dtype=np.uint16)
  label_ids = np.empty(int(offs_k[-1]), dtype=np.int32)
  native.lddl_mask_partition(
      flat_ids.ctypes.data_as(i32p), a_ranges.ctypes.data_as(i64p),
      b_ranges.ctypes.data_as(i64p), n, offs_a.ctypes.data_as(i64p),
      offs_b.ctypes.data_as(i64p), k.ctypes.data_as(i64p),
      offs_k.ctypes.data_as(i64p), c.c_uint64(int(seed) & (2**64 - 1)),
      int(vocab_size), int(mask_id), flat_a.ctypes.data_as(i32p),
      flat_b.ctypes.data_as(i32p),
      pos.ctypes.data_as(c.POINTER(c.c_uint16)),
      label_ids.ctypes.data_as(i32p), min(8, os.cpu_count() or 1))
  return flat_a, flat_b, pos, label_ids, k


def mask_batch_host(ids_mat, row_len, na, *, masked_lm_ratio, vocab_size,
                    mask_id, np_rng, max_predictions=None):
  """Vectorized numpy masking. Returns (masked_mat, picked_mask).

  Determinism contract: bit-identical for a given (seed, inputs) within a
  framework version. The draw layout is NOT stable across versions (the
  decide/replacement draws are taken sparsely at picked positions), so a
  shard regenerated with the same seed under a different version may carry
  different mask bits — pair structure and all non-mask columns are
  unaffected. Matches the repo-wide masking contract
  (the JAX package's "masking bits differ across backends; pair structure
  must not").
  """
  n, l = ids_mat.shape
  if n == 0:
    return ids_mat.copy(), np.zeros((0, l), dtype=bool)
  valid = _special_and_valid(l, row_len, na)
  u = np_rng.random((n, l))
  u[~valid] = 2.0
  k = np.maximum(1, np.rint(row_len * masked_lm_ratio).astype(np.int64))
  if max_predictions is not None:
    k = np.minimum(k, max_predictions)
  k = np.minimum(k, valid.sum(axis=1))
  # The k smallest valid draws per row win. Sort tie-free uint64 keys
  # (positive-float bit patterns order like the floats; the lane index
  # replaces the low mantissa bits) so the result is deterministic across
  # numpy versions — equal float64 draws would otherwise tie-break by sort
  # implementation. argpartition moves the kmax smallest to the front in
  # O(l); only that prefix needs the real sort.
  lane_bits = max(1, (l - 1)).bit_length()
  keys = (u.view(np.uint64) & ~np.uint64((1 << lane_bits) - 1)
          | np.arange(l, dtype=np.uint64)[None, :])
  # Select the k smallest keys per row. Invalid lanes carry the float 2.0
  # bit pattern — larger than any valid [0, 1) draw — and k is clamped to
  # the per-row valid count above, so the selection can never touch an
  # invalid lane. The native path (nth_element per row, C++) and the
  # numpy path (argpartition) produce the identical picked set, emitted
  # in row-major ascending order so the downstream decide/replacement
  # draws line up draw-for-draw either way.
  pr, pc, picked = _select_topk(keys, k, n, l)
  # decide / replacement draws only at picked positions (~ratio of the
  # matrix) instead of dense (n, l) matrices.
  decide = np_rng.random(len(pr))
  rand_ids = np_rng.integers(0, vocab_size, len(pr), dtype=np.int32)
  masked = ids_mat.copy()
  to_mask = decide < 0.8
  masked[pr[to_mask], pc[to_mask]] = mask_id
  keep_random = decide >= 0.9
  masked[pr[keep_random], pc[keep_random]] = rand_ids[keep_random]
  return masked, picked
