"""Static MLM masking of the BERT preprocessor: host and device backends.

The port's :mod:`lddl_tpu.ops.masking`. Semantics per row (the reference
recipe): the row is the assembled ``[CLS] A [SEP] B [SEP]`` sequence;
``k = max(1, round(len * ratio))`` non-special positions are drawn without
replacement; each becomes ``[MASK]`` with p=0.8, a uniform-random vocab
id with p=0.1, or stays itself with p=0.1.

Two backends, each deterministic given its seed, with independent draws:

  - host (:mod:`.masking_host`, re-exported here): copies of the JAX
    package's native C++ pass and numpy mirrors (Philox4x32-10 for the
    fused partition form, numpy's Philox generator for the padded-matrix
    form), bit for bit the JAX package's;
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

import numpy as np
import torch

from . import _build
from .masking_host import (assemble_pair_matrix, mask_batch_host,  # noqa: F401
                           mask_partition_host, ragged_indices)

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
