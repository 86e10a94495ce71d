"""Static MLM masking of the BERT preprocessor: host and device backends.

The port's :mod:`lddl_tpu.ops.masking`. Semantics per row (the reference
recipe): the row is the assembled ``[CLS] A [SEP] B [SEP]`` sequence;
``k = max(1, round(len * ratio))`` non-special positions are drawn without
replacement; each becomes ``[MASK]`` with p=0.8, a uniform-random vocab
id with p=0.1, or stays itself with p=0.1.

Two backends, each deterministic given its seed, with independent draws:

  - host: copies of the JAX package's native C++ pass and numpy mirrors
    (Philox4x32-10 for the fused partition form, numpy's Philox generator
    for the padded-matrix form), bit for bit the JAX package's;
  - device: the JAX package's two jit programs, ``_partition_kernel`` and
    ``_device_kernel``, as hand-written CUDA (``csrc/masking.cu``,
    :func:`partition_program`, :func:`matrix_program`). They draw with
    JAX's threefry2x32 under ``jax_threefry_partitionable`` (JAX 0.9.0's
    default), so their output equals the jit programs' bit for bit: the
    same positions, post-masking ids and k, and the preprocessor's device
    shards hold the JAX package's rows. Each program has a plain PyTorch
    version (:func:`_partition_plain`, :func:`_matrix_plain`) that the
    wrappers take for CPU tensors only; a CUDA tensor launches the kernel
    or raises. Every launch adds one to :data:`launches`.

Under the partitionable threefry the bits of row ``i`` depend on the row
width, not on the row count, so the port launches at the true ``N``
where the JAX package pads ``N`` (and the flat id array) to a bucket for
jit's cache: the rows come out the same either way.
"""

import os

import numpy as np
import torch

from . import _build

#: Kernel launches by program; each wrapper adds one where it launches.
launches = {'mask_partition': 0, 'mask_matrix': 0}


def reset_launches():
  for name in launches:
    launches[name] = 0


_LINK_OK_CACHE = {}


def _device_link_usable(min_mb_per_s=100.0):
  """One probe per process: does a 1 MB round trip to the card beat
  ``min_mb_per_s``? Offloading pays only when transfers beat the host's
  vectorized path."""
  key = 'probe'
  if key in _LINK_OK_CACHE:
    return _LINK_OK_CACHE[key]
  import time
  try:
    x = torch.zeros((256, 1024), dtype=torch.int32)  # 1 MB
    x.to('cuda')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x.to('cuda').cpu()
    dt = time.perf_counter() - t0
    ok = (2 * x.numel() * 4 / 1e6) / dt >= min_mb_per_s
  except Exception:
    ok = False
  _LINK_OK_CACHE[key] = ok
  return ok


def resolve_mask_backend(backend='auto'):
  """'auto' -> 'device' when a CUDA card with a usable host link is
  attached, else 'host'. Any other name is returned as given."""
  if backend != 'auto':
    return backend
  if not torch.cuda.is_available():
    return 'host'
  return 'device' if _device_link_usable() else 'host'


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




# ------------------------------------------------------------ device (CUDA)

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = torch.float32


def _threefry(k0, k1, x0, x1):
  """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32``) of the counter
  words ``(x0, x1)`` under the key ``(k0, k1)``: Python ints, or int64
  tensors holding uint32 values; the key words are Python ints."""
  k2 = k0 ^ k1 ^ 0x1BD11BDA
  ks = (k0, k1, k2)
  x0 = (x0 + k0) & _M32
  x1 = (x1 + k1) & _M32
  for i in range(5):
    for r in _ROTATIONS[i % 2]:
      x0 = (x0 + x1) & _M32
      x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
    x0 = (x0 + ks[(i + 1) % 3]) & _M32
    x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
  return x0, x1


def prng_key(seed):
  """The two words of ``jax.random.PRNGKey(seed)`` under JAX's 32-bit
  default: ``(0, seed mod 2**32)``, for seeds in ``[-2**31, 2**32)``."""
  seed = int(seed)
  if not -2**31 <= seed < 2**32:
    raise ValueError(f'seed {seed} is outside [-2**31, 2**32): 32-bit JAX '
                     "keys it by a truncation the device programs don't "
                     'reproduce')
  return 0, seed & _M32


def split_key(key, num):
  """``jax.random.split(key, num)`` under ``jax_threefry_partitionable``:
  key ``i`` is the threefry of the counter ``(0, i)``."""
  return [_threefry(key[0], key[1], 0, i) for i in range(num)]


def draw_keys(seed):
  """The eight key words both programs draw with: ``(ku, kd, kr)`` from
  ``split(PRNGKey(seed), 3)``, with ``kr`` split again into randint's two
  keys."""
  ku, kd, kr = split_key(prng_key(seed), 3)
  kr0, kr1 = split_key(kr, 2)
  return (*ku, *kd, *kr0, *kr1)


def randint_constants(vocab_size):
  """``(span, multiplier)`` of ``jax.random.randint(key, shape, 0,
  vocab_size, int32)``: the span and ``(2**16 % span)**2 % span`` in
  uint32."""
  vocab_size = int(vocab_size)
  if vocab_size > 2**31 - 1:
    raise ValueError(f'vocab_size {vocab_size} does not fit int32')
  span = vocab_size if vocab_size > 0 else 1
  mult = (1 << 16) % span
  return span, ((mult * mult) & _M32) % span


def _bits(key, counts):
  """JAX's 32-bit random bits at the int64 ``counts`` (flat indices)."""
  x0, x1 = _threefry(key[0], key[1], counts >> 32, counts & _M32)
  return x0 ^ x1


def _uniform(key, counts):
  """``jax.random.uniform(key, shape, float32)`` at ``counts``."""
  b = (_bits(key, counts) >> 9) | 0x3f800000
  return b.to(torch.int32).view(_F32) - 1.0


def _rand_ids(k0, k1, counts, span, mult):
  """``jax.random.randint`` at ``counts`` (uint32 arithmetic, wrapping)."""
  hi = _bits(k0, counts)
  lo = _bits(k1, counts)
  off = ((hi % span) * mult + lo % span) & _M32
  return (off % span).to(torch.int32)


def _pick_counts_f32(row_len, ratio, nvalid, max_pred):
  """``min(max(1, rint(float32(row_len) * float32(ratio))), nvalid,
  max_pred)``, in float32 as the jit programs compute it (the host
  backend's float64 arithmetic differs by one near half-way points)."""
  prod = row_len.to(_F32) * torch.tensor(ratio, dtype=_F32)
  k = torch.clamp(torch.round(prod).to(torch.int64), min=1)
  if max_pred is not None:
    k = torch.clamp(k, max=max_pred)
  return torch.minimum(k, nvalid)


def _picked(valid, u, k):
  """Whether each position is among its row's ``k`` smallest keys, ties
  broken by position, as the jit programs spell it: the rank of each
  position by the stable argsort of the argsort of ``where(valid, u,
  2.0)``."""
  keyed = torch.where(valid, u, torch.tensor(2.0, dtype=_F32,
                                             device=u.device))
  order = torch.argsort(keyed, dim=1, stable=True)
  ranks = torch.argsort(order, dim=1, stable=True)
  return (ranks < k[:, None]) & valid


def _apply_draw(picked, original, keys, counts, span, mult, mask_id):
  """80/10/10 at the picked positions, from the kd and kr draws there (the
  jit programs draw them over the whole matrix; only these are read)."""
  at = picked.nonzero(as_tuple=True)
  c = counts.expand(picked.shape)[at]
  decide = _uniform(keys[1], c)
  new = torch.where(decide < torch.tensor(0.8, dtype=_F32), mask_id,
                    torch.where(decide >= torch.tensor(0.9, dtype=_F32),
                                _rand_ids(keys[2], keys[3], c, span, mult),
                                original[at]))
  out = original.clone()
  out[at] = new.to(out.dtype)
  return out


def _key_pairs(keys8):
  return [tuple(keys8[i:i + 2]) for i in range(0, 8, 2)]


def _partition_plain(flat, a0, a1, b0, b1, keys8, *, seq_len, ratio, span,
                     mult, mask_id, cls_id, sep_id, max_pred):
  """The plain PyTorch version of the partition program: ``_partition_
  kernel`` of the JAX package, op for op, over the whole ``[N, L]``
  matrix. Returns ``(positions int16 [N, P], new_ids int32 [N, P], k int32
  [N])`` with ``P = min(max_pred, L)``."""
  dev = flat.device
  keys = _key_pairs(keys8)
  length = seq_len
  n = a0.shape[0]
  a0, a1, b0, b1 = (x.to(torch.int64) for x in (a0, a1, b0, b1))
  la, lb = a1 - a0, b1 - b0
  row_len = la + lb + 3
  pos = torch.arange(length, device=dev)[None, :]
  lac = la[:, None]
  in_a = (pos >= 1) & (pos < 1 + lac)
  in_b = (pos >= 2 + lac) & (pos < 2 + lac + lb[:, None])
  gather = torch.where(in_a, a0[:, None] + pos - 1,
                       torch.where(in_b, b0[:, None] + pos - 2 - lac, 0))
  vals = flat.to(torch.int64)[gather.clamp(0, flat.shape[0] - 1)]
  is_sep = (pos == 1 + lac) | (pos == row_len[:, None] - 1)
  mat = torch.where(pos == 0, cls_id,
                    torch.where(is_sep, sep_id,
                                torch.where(in_a | in_b, vals, 0)))
  valid = in_a | in_b
  counts = torch.arange(n, device=dev)[:, None] * length + pos
  u = _uniform(keys[0], counts)
  k = _pick_counts_f32(row_len, ratio, valid.sum(1), max_pred)
  picked = _picked(valid, u, k)
  masked = _apply_draw(picked, mat, keys, counts, span, mult, mask_id)
  pos_sorted = torch.sort(torch.where(picked, pos, length),
                          dim=1).values[:, :max_pred]
  new_ids = torch.gather(masked, 1, pos_sorted.clamp(max=length - 1))
  return (pos_sorted.to(torch.int16), new_ids.to(torch.int32),
          k.to(torch.int32))


def _matrix_plain(ids, row_len, na, keys8, *, ratio, span, mult, mask_id,
                  max_pred):
  """The plain PyTorch version of the matrix program (``_device_kernel``
  of the JAX package). Returns ``(masked int32 [N, L], picked bool)``."""
  dev = ids.device
  keys = _key_pairs(keys8)
  n, length = ids.shape
  pos = torch.arange(length, device=dev)[None, :]
  rl = row_len.to(torch.int64)
  rlc, nac = rl[:, None], na.to(torch.int64)[:, None]
  special = (pos == 0) | (pos == 1 + nac) | (pos == rlc - 1)
  valid = (pos < rlc) & ~special
  counts = torch.arange(n, device=dev)[:, None] * length + pos
  u = _uniform(keys[0], counts)
  k = _pick_counts_f32(rl, ratio, valid.sum(1), max_pred)
  picked = _picked(valid, u, k)
  masked = _apply_draw(picked, ids.to(torch.int64), keys, counts, span, mult,
                       mask_id)
  return masked.to(torch.int32), picked


def _on_card(t):
  """'cpu' -> the plain version, 'cuda' -> the kernel; others raise."""
  if t.device.type not in ('cpu', 'cuda'):
    raise ValueError('the masking programs run on cuda (kernels) or cpu '
                     f'(plain versions); got device {t.device}')
  return t.device.type == 'cuda'


def max_seq_len():
  """The longest row the CUDA kernels take (their shared-memory sort)."""
  return int(_build.masking_library().lddl_mask_max_seq_len())


def _check_len(length):
  limit = max_seq_len()
  if length > limit:
    raise ValueError(f'seq_len {length} exceeds the masking kernels\' '
                     f'limit of {limit}')


def partition_program(flat, a0, a1, b0, b1, keys8, *, seq_len,
                      masked_lm_ratio, vocab_size, mask_id, cls_id, sep_id,
                      max_pred):
  """The partition program (M1) over tensors on one device: ``flat`` the
  partition's ids (uint16 or int32), ``a0, a1, b0, b1`` int32 ``[N]`` row
  ranges into it, ``keys8`` from :func:`draw_keys`. Returns ``(positions
  int16 [N, P], new_ids int32 [N, P], k int32 [N])``. CPU tensors run
  :func:`_partition_plain`; CUDA tensors launch the kernel."""
  span, mult = randint_constants(vocab_size)
  n = a0.shape[0]
  if not _on_card(flat):
    return _partition_plain(
        flat, a0, a1, b0, b1, keys8, seq_len=seq_len, ratio=masked_lm_ratio,
        span=span, mult=mult, mask_id=mask_id, cls_id=cls_id, sep_id=sep_id,
        max_pred=max_pred)
  import ctypes
  width = min(max_pred, seq_len)
  dev = flat.device
  out_pos = torch.empty((n, width), dtype=torch.int16, device=dev)
  out_new = torch.empty((n, width), dtype=torch.int32, device=dev)
  out_k = torch.empty(n, dtype=torch.int32, device=dev)
  if n == 0:
    return out_pos, out_new, out_k
  _check_len(seq_len)
  if flat.dtype not in (torch.uint16, torch.int32):
    raise TypeError(f'flat ids must be uint16 or int32, not {flat.dtype}')
  ranges = [x.contiguous() for x in (a0, a1, b0, b1)]
  if any(x.dtype != torch.int32 or x.device != dev for x in ranges):
    raise TypeError('row ranges must be int32 tensors on the ids\' device')
  flat = flat.contiguous()
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.masking_launch(
        'lddl_mask_partition', flat.data_ptr(),
        int(flat.dtype == torch.uint16), flat.numel(),
        *(x.data_ptr() for x in ranges), n, seq_len, max_pred, width,
        cls_id, sep_id, mask_id, (ctypes.c_uint * 8)(*keys8), span, mult,
        float(masked_lm_ratio), out_pos.data_ptr(), out_new.data_ptr(),
        out_k.data_ptr(), stream)
  launches['mask_partition'] += 1
  return out_pos, out_new, out_k


def matrix_program(ids, row_len, na, keys8, *, masked_lm_ratio, vocab_size,
                   mask_id, max_pred):
  """The matrix program (M2) over tensors on one device: ``ids`` int32
  ``[N, L]``, ``row_len`` and ``na`` int32 ``[N]``; ``max_pred`` None for
  no cap. Returns ``(masked int32 [N, L], picked bool [N, L])``."""
  span, mult = randint_constants(vocab_size)
  if not _on_card(ids):
    return _matrix_plain(ids, row_len, na, keys8, ratio=masked_lm_ratio,
                         span=span, mult=mult, mask_id=mask_id,
                         max_pred=max_pred)
  import ctypes
  n, length = ids.shape
  dev = ids.device
  out = torch.empty((n, length), dtype=torch.int32, device=dev)
  picked = torch.empty((n, length), dtype=torch.bool, device=dev)
  if n == 0:
    return out, picked
  _check_len(length)
  args = [x.contiguous() for x in (ids, row_len, na)]
  if any(x.dtype != torch.int32 or x.device != dev for x in args):
    raise TypeError('ids, row_len and na must be int32 tensors on one card')
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.masking_launch(
        'lddl_mask_matrix', *(x.data_ptr() for x in args), n, length,
        -1 if max_pred is None else int(max_pred), mask_id,
        (ctypes.c_uint * 8)(*keys8), span, mult, float(masked_lm_ratio),
        out.data_ptr(), picked.data_ptr(), stream)
  launches['mask_matrix'] += 1
  return out, picked


def resolve_device(device):
  """``device`` as a torch.device; 'cuda' without a card raises (the
  device backend never falls back to the host)."""
  dev = torch.device(device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        "mask backend 'device' needs a CUDA card and none is available; "
        "pass device='cpu' to run its plain version, or mask on the host "
        "(mask backend 'host')")
  return dev


def partition_max_pred(seq_len, masked_lm_ratio, max_predictions=None):
  """The partition program's position budget per row: ``max(1,
  round(seq_len * ratio) + 1)``, capped by ``max_predictions``."""
  max_pred = max(1, int(round(seq_len * masked_lm_ratio)) + 1)
  if max_predictions is not None:
    max_pred = min(max_pred, max_predictions)
  return max_pred


def mask_partition_device(flat_ids, a_ranges, b_ranges, *, seq_len,
                          masked_lm_ratio, vocab_size, mask_id, cls_id,
                          sep_id, seed, max_predictions=None, device='cuda'):
  """Device masking for a whole partition from flat ids + segment ranges.

  Uploads the flat id array (uint16 when the vocab allows) and the int32
  range columns, runs the partition program on ``device`` (the kernel on
  a card; ``'cpu'`` runs its plain version, as the caller asked), and
  downloads ``(positions int16 [N, P], new_ids int32 [N, P], k int32
  [N])`` as numpy arrays: the JAX package's ``mask_partition_device``
  output, bit for bit."""
  a_ranges = np.asarray(a_ranges, dtype=np.int32).reshape(-1, 2)
  b_ranges = np.asarray(b_ranges, dtype=np.int32).reshape(-1, 2)
  n = len(a_ranges)
  max_pred = partition_max_pred(seq_len, masked_lm_ratio, max_predictions)
  if n == 0:
    return (np.zeros((0, max_pred), np.int16),
            np.zeros((0, max_pred), np.int32), np.zeros(0, np.int32))
  dev = resolve_device(device)
  flat = np.ascontiguousarray(flat_ids)
  flat = flat.astype(np.uint16 if vocab_size <= np.iinfo(np.uint16).max + 1
                     else np.int32)
  cols = [torch.from_numpy(np.ascontiguousarray(c)).to(dev)
          for c in (a_ranges[:, 0], a_ranges[:, 1], b_ranges[:, 0],
                    b_ranges[:, 1])]
  positions, new_ids, k = partition_program(
      torch.from_numpy(flat).to(dev), *cols, draw_keys(seed),
      seq_len=int(seq_len), masked_lm_ratio=float(masked_lm_ratio),
      vocab_size=int(vocab_size), mask_id=int(mask_id), cls_id=int(cls_id),
      sep_id=int(sep_id), max_pred=max_pred)
  return positions.cpu().numpy(), new_ids.cpu().numpy(), k.cpu().numpy()


def mask_batch_device(ids_mat, row_len, na, *, masked_lm_ratio, vocab_size,
                      mask_id, seed, max_predictions=None, device='cuda'):
  """Device masking of a padded id matrix (the matrix program on
  ``device``). Returns ``(masked int32 [N, L], picked bool [N, L])``, the
  JAX package's ``mask_batch_device`` output bit for bit."""
  n, length = ids_mat.shape
  if n == 0:
    return ids_mat.copy(), np.zeros((0, length), dtype=bool)
  dev = resolve_device(device)
  args = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)
          for x in (ids_mat, row_len, na)]
  masked, picked = matrix_program(
      *args, draw_keys(seed), masked_lm_ratio=float(masked_lm_ratio),
      vocab_size=int(vocab_size), mask_id=int(mask_id),
      max_pred=max_predictions)
  return masked.cpu().numpy(), picked.cpu().numpy()


def mask_batch(ids_mat, row_len, na, *, masked_lm_ratio, vocab_size, mask_id,
               seed, backend='auto', max_predictions=None, device='cuda'):
  """Dispatch to the resolved backend. Host RNG is Philox keyed on seed."""
  backend = resolve_mask_backend(backend)
  if backend == 'device':
    return mask_batch_device(
        ids_mat, row_len, na, masked_lm_ratio=masked_lm_ratio,
        vocab_size=vocab_size, mask_id=mask_id, seed=seed,
        max_predictions=max_predictions, device=device)
  if backend != 'host':
    raise ValueError(f'unknown mask backend {backend!r} (auto|device|host)')
  np_rng = np.random.Generator(np.random.Philox(key=np.uint64(seed)))
  return mask_batch_host(
      ids_mat, row_len, na, masked_lm_ratio=masked_lm_ratio,
      vocab_size=vocab_size, mask_id=mask_id, np_rng=np_rng,
      max_predictions=max_predictions)
