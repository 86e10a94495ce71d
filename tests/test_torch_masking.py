"""The port's MLM masking against lddl_tpu's, bit for bit, on the CPU.

The device backend's two programs (``csrc/masking.cu``) run here as their
plain PyTorch versions, the path a CPU tensor takes. They equal the JAX
package's jit programs (``_partition_kernel``, ``_device_kernel``) exactly:
positions, post-masking ids and k; masked ids and the picked bitmap. The
host backend (native C++ and its numpy mirror) equals lddl_tpu's host
backend bit for bit. The bits are JAX's under the threefry configuration
asserted in :func:`test_the_jax_prng_configuration_the_bits_follow`.

The kernels themselves run only on a card; :func:`warp_select` models
their select lane for lane (a warp a row, contiguous runs, the descent
over the keys' bits, the warp scan with its tie quota, the shared-memory
layout of long rows) and is held exactly against the plain version's
pick.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from lddl_tpu.ops import masking as jm
from lddl_tpu_torch.ops import masking as tm
from lddl_tpu_torch.ops import masking_host as tm_host
from torch_threads import torch_one_thread_a_file  # noqa: F401


VOCAB, MASK, CLS, SEP = 30522, 103, 101, 102

@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


def _pairs(n, seq_len, seed, lengths=None, dup=1):
  """A partition's flat ids and ``n`` base pairs of ragged A/B ranges
  (row lengths ``lengths`` when given), each tiled ``dup`` times."""
  r = np.random.default_rng(seed)
  if lengths is None:
    lengths = r.integers(5, seq_len + 1, n)
  lengths = np.asarray(lengths, dtype=np.int64)
  na = np.array([r.integers(1, t - 3) if t > 4 else 1 for t in lengths])
  nb = lengths - 3 - na
  total = int((na + nb).sum()) + 64
  flat = r.integers(0, VOCAB, total).astype(np.int32)
  a0 = r.integers(0, total - na)
  b0 = r.integers(0, total - nb)
  a = np.repeat(np.stack([a0, a0 + na], 1), dup, axis=0)
  b = np.repeat(np.stack([b0, b0 + nb], 1), dup, axis=0)
  return flat, a, b


def _partition_kw(seq_len, seed, max_predictions=None):
  return dict(seq_len=seq_len, masked_lm_ratio=0.15, vocab_size=VOCAB,
              mask_id=MASK, cls_id=CLS, sep_id=SEP, seed=seed,
              max_predictions=max_predictions)


def _same(want, got):
  assert len(want) == len(got)
  for w, g in zip(want, got):
    assert w.dtype == g.dtype and w.shape == g.shape
    np.testing.assert_array_equal(w, g)


def test_the_jax_prng_configuration_the_bits_follow():
  """The device programs reproduce threefry2x32 with partitionable keys:
  a change of JAX's defaults fails here by name, not as stray bits."""
  import jax
  assert jax.config.jax_default_prng_impl == 'threefry2x32'
  assert jax.config.jax_threefry_partitionable is True
  assert not jax.config.jax_enable_x64
  for seed in (0, 12345, 2**31 + 7, 2**32 - 1, -5):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(x) for x in np.asarray(key)) == tm.prng_key(seed)
    want = [tuple(int(x) for x in k) for k in np.asarray(
        jax.random.split(key, 3))]
    assert want == tm.split_key(tm.prng_key(seed), 3)
  with pytest.raises(ValueError, match='outside'):
    tm.prng_key(2**32)


@pytest.mark.parametrize('span', [VOCAB, 7, 1 << 16, 100003])
def test_uniform_and_randint_draws_equal_jax(span):
  import jax
  import jax.numpy as jnp
  key = jax.random.PRNGKey(99)
  ku, _, kr = jax.random.split(key, 3)
  keys = tm.draw_keys(99)
  counts = torch.arange(3 * 129, dtype=torch.int64).reshape(3, 129)
  u = np.asarray(jax.random.uniform(ku, (3, 129), dtype=jnp.float32))
  np.testing.assert_array_equal(
      tm._uniform(keys[0:2], counts).numpy().view(np.uint32),
      u.view(np.uint32))
  ids = np.asarray(jax.random.randint(kr, (3, 129), 0, span,
                                      dtype=jnp.int32))
  s, m = tm.randint_constants(span)
  np.testing.assert_array_equal(
      tm._rand_ids(keys[4:6], keys[6:8], counts, s, m).numpy(), ids)


@pytest.mark.parametrize('n,seq_len,dup,max_predictions', [
    (37, 128, 1, None),      # N off _bucket's sizes (JAX pads it to 512)
    (512, 128, 1, None),     # N on a bucket size
    (60, 128, 5, None),      # duplicate tiling: copies draw their own masks
    (40, 512, 1, 9),         # seq 512, a max_predictions cap
], ids=['n37-s128', 'n512-s128', 'dup5', 's512-cap9'])
def test_partition_program_equals_the_jit_program(n, seq_len, dup,
                                                  max_predictions):
  flat, a, b = _pairs(n // dup, seq_len, seed=n + seq_len, dup=dup)
  kw = _partition_kw(seq_len, seed=1234 + n, max_predictions=max_predictions)
  want = jm.mask_partition_device(flat, a, b, **kw)
  got = tm.mask_partition_device(flat, a, b, device='cpu', **kw)
  _same(want, got)
  if dup > 1:  # the tiled copies of one base pair mask differently
    k = got[2].reshape(-1, dup)
    pos = got[0].reshape(-1, dup, got[0].shape[1])
    assert any(not np.array_equal(pos[i, 0], pos[i, 1])
               for i in range(len(k)))


def test_float32_k_departs_from_the_host_at_half_way_lengths():
  """Rows of 190 and 350 tokens: float32(len) * float32(0.15) rounds to
  29 and 53 in the jit program (and the port's device programs), where
  the host's float64 gives 28 and 52."""
  lengths = [190, 350, 390, 200]
  flat, a, b = _pairs(len(lengths), 512, seed=3, lengths=lengths)
  kw = _partition_kw(512, seed=77)
  want = jm.mask_partition_device(flat, a, b, **kw)
  got = tm.mask_partition_device(flat, a, b, device='cpu', **kw)
  _same(want, got)
  np.testing.assert_array_equal(got[2], [29, 53, 59, 30])
  host = tm.mask_partition_host(flat, a, b, masked_lm_ratio=0.15,
                                vocab_size=VOCAB, mask_id=MASK, seed=77)
  np.testing.assert_array_equal(host[4], [28, 52, 58, 30])


def test_an_empty_partition_launches_nothing():
  flat = np.zeros(4, np.int32)
  empty = np.zeros((0, 2), np.int64)
  kw = _partition_kw(128, seed=1)
  _same(jm.mask_partition_device(flat, empty, empty, **kw),
        tm.mask_partition_device(flat, empty, empty, **kw))
  ids = np.zeros((0, 16), np.int32)
  z = np.zeros(0, np.int32)
  mkw = dict(masked_lm_ratio=0.15, vocab_size=VOCAB, mask_id=MASK, seed=1)
  _same(jm.mask_batch_device(ids, z, z, **mkw),
        tm.mask_batch_device(ids, z, z, **mkw))
  assert tm.launches == {'mask_partition': 0, 'mask_matrix': 0}


def test_rows_do_not_depend_on_the_padding():
  """lddl_tpu pads N and the flat ids for jit's cache; the port does not.
  Under the partitionable threefry the rows come out the same: the port
  at N equals the port over the padded arrays, first N rows."""
  flat, a, b = _pairs(50, 128, seed=11)
  kw = _partition_kw(128, seed=5)
  got = tm.mask_partition_device(flat, a, b, device='cpu', **kw)
  pad = 78
  a_pad = np.concatenate([a, np.tile([[0, 1]], (pad, 1))])
  b_pad = np.concatenate([b, np.tile([[0, 1]], (pad, 1))])
  flat_pad = np.concatenate([flat, np.zeros(1 << 10, np.int32)])
  padded = tm.mask_partition_device(flat_pad, a_pad, b_pad, device='cpu',
                                    **kw)
  _same(got, tuple(x[:50] for x in padded))


@pytest.mark.parametrize('flat_dtype', [np.uint16, np.int32],
                         ids=['uint16', 'int32'])
def test_the_partition_program_takes_uint16_and_int32_ids(flat_dtype):
  """partition_program over the flat ids as the wrapper uploads them
  (uint16 where the vocab fits) and as int32: the jit program's rows."""
  flat, a, b = _pairs(30, 128, seed=8)
  keys = tm.draw_keys(4)
  args = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
          for x in (a[:, 0], a[:, 1], b[:, 0], b[:, 1])]
  out = tm.partition_program(
      torch.from_numpy(flat.astype(flat_dtype)), *args, keys, seq_len=128,
      masked_lm_ratio=0.15, vocab_size=VOCAB, mask_id=MASK, cls_id=CLS,
      sep_id=SEP, max_pred=20)
  want = jm.mask_partition_device(flat, a, b, **_partition_kw(128, seed=4))
  _same(want, tuple(x.numpy() for x in out))


@pytest.mark.parametrize('seq_len,max_predictions', [(128, None), (512, 20)])
def test_matrix_program_equals_the_jit_program(seq_len, max_predictions):
  flat, a, b = _pairs(45, seq_len, seed=seq_len)
  ids, row_len, na = jm.assemble_pair_matrix(flat, a, b, CLS, SEP, seq_len)
  kw = dict(masked_lm_ratio=0.15, vocab_size=VOCAB, mask_id=MASK, seed=31,
            max_predictions=max_predictions)
  want = jm.mask_batch_device(ids, row_len, na, **kw)
  got = tm.mask_batch_device(ids, row_len, na, device='cpu', **kw)
  _same(want, got)
  assert got[1].any()


@pytest.mark.parametrize('native', [True, False], ids=['native', 'numpy'])
def test_host_backend_equals_lddl_tpu(native, monkeypatch):
  """The fused partition pass and the padded-matrix path, through the
  C++ library and through its numpy mirror, each bit for bit the JAX
  package's (which runs its own native library)."""
  flat, a, b = _pairs(80, 128, seed=21, dup=2)
  if not native:
    # The host backend lives in ops/masking_host.py (torch-free).
    monkeypatch.setattr(tm_host, '_TOPK_NATIVE', False)
  assert bool(tm_host._native()) == native
  kw = dict(masked_lm_ratio=0.15, vocab_size=VOCAB, mask_id=MASK, seed=9)
  _same(jm.mask_partition_host(flat, a, b, **kw),
        tm.mask_partition_host(flat, a, b, **kw))
  _same(jm.mask_partition_host(flat, a, b, max_predictions=6, **kw),
        tm.mask_partition_host(flat, a, b, max_predictions=6, **kw))
  ids, row_len, na = jm.assemble_pair_matrix(flat, a, b, CLS, SEP, 128)
  mkw = dict(masked_lm_ratio=0.15, vocab_size=VOCAB, mask_id=MASK,
             max_predictions=12)
  want = jm.mask_batch_host(ids, row_len, na, np_rng=np.random.Generator(
      np.random.Philox(key=np.uint64(3))), **mkw)
  got = tm.mask_batch_host(ids, row_len, na, np_rng=np.random.Generator(
      np.random.Philox(key=np.uint64(3))), **mkw)
  _same(want, got)
  _same(jm.mask_batch(ids, row_len, na, backend='host', seed=3, **mkw),
        tm.mask_batch(ids, row_len, na, backend='host', seed=3, **mkw))


def test_device_without_a_card_raises_unless_the_cpu_was_asked_for(
    monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  flat, a, b = _pairs(4, 128, seed=2)
  kw = _partition_kw(128, seed=1)
  with pytest.raises(RuntimeError, match='needs a CUDA card'):
    tm.mask_partition_device(flat, a, b, **kw)
  ids, row_len, na = jm.assemble_pair_matrix(flat, a, b, CLS, SEP, 128)
  with pytest.raises(RuntimeError, match='needs a CUDA card'):
    tm.mask_batch(ids, row_len, na, masked_lm_ratio=0.15, vocab_size=VOCAB,
                  mask_id=MASK, seed=1, backend='device')
  assert tm.resolve_mask_backend('auto') == 'host'
  tm.mask_partition_device(flat, a, b, device='cpu', **kw)
  assert tm.launches == {'mask_partition': 0, 'mask_matrix': 0}


def test_an_unknown_device_raises():
  keys = tm.draw_keys(0)
  t = torch.zeros(4, dtype=torch.int32, device='meta')
  with pytest.raises(ValueError, match='run on cuda'):
    tm.partition_program(t, t, t, t, t, keys, seq_len=8, masked_lm_ratio=0.15,
                         vocab_size=VOCAB, mask_id=MASK, cls_id=CLS,
                         sep_id=SEP, max_pred=3)


# ----------------------------------------------------------------------------
# The kernels' select (csrc/masking.cu), modelled lane for lane in numpy.

MASKING_CU = (Path(__file__).resolve().parent.parent / 'lddl_tpu_torch' /
              'csrc' / 'masking.cu')
WARP, KEY_BITS, REG_SEQ_LEN = 32, 23, 1024
NO_KEY = 0xFFFFFFFF  # a position that draws nothing: above every key


def test_the_model_follows_the_kernels_source():
  """The model's constants are the kernel's; its body has no sort of every
  position and no block-wide barrier."""
  src = MASKING_CU.read_text()
  for name, value in (('kWarp', WARP), ('kKeyBits', KEY_BITS),
                      ('kRegSeqLen', REG_SEQ_LEN)):
    assert re.search(rf'constexpr int {name} = {value};', src), name
  assert re.search(r'kNoKey = 0xffffffffu;', src)
  code = re.sub(r'//.*', '', src)
  assert '__syncthreads' not in code and 'bitonic' not in code.lower()
  assert '__reduce_add_sync' in code and '__shfl_up_sync' in code


def _warp_scan(x):
  """__shfl_up_sync's exclusive scan over 32 lanes (Hillis-Steele), and the
  warp's total (lane 31's inclusive sum)."""
  s = x.copy()
  off = 1
  while off < WARP:
    s = s + np.concatenate([np.zeros(off, s.dtype), s[:-off]])
    off *= 2
  return s - x, int(s[-1])


def warp_select(keys, npos, k):
  """The kernel's pick of one row, lane for lane: ``keys`` uint32 [L] (the
  uniform's 23 bits at valid positions, NO_KEY elsewhere), ``npos`` =
  min(row_len, L), ``k`` the row's count. Returns the picked positions in
  their output slots (ascending)."""
  length = len(keys)
  c = -(-npos // WARP)
  # Lane i owns the run [i * c, i * c + c) of [0, npos): padding gets no key.
  run = np.full((WARP, c), NO_KEY, np.uint64)
  for lane in range(WARP):
    for j in range(c):
      p = lane * c + j
      if p < npos:
        run[lane, j] = keys[p]
  if length > REG_SEQ_LEN:
    # The long-row form: key j of lane i in shared memory at j * 32 + i.
    smem = np.full(WARP * max(c, 1), 0xA5A5A5A5, np.uint64)
    for lane in range(WARP):
      for j in range(c):
        smem[j * WARP + lane] = run[lane, j]
    run = np.stack([[smem[j * WARP + lane] for j in range(c)]
                    for lane in range(WARP)]).reshape(WARP, c)
  t = 0
  if k > 0:  # the descent over the key's bits, from the top
    for b in range(KEY_BITS - 1, -1, -1):
      cand = t | (1 << b)
      under = int((run < cand).sum(axis=1).sum())  # __reduce_add_sync
      if under <= k:
        t = cand
      if under == k:
        break
  under = (run < t).sum(axis=1)
  equal = (run == t).sum(axis=1)
  assert under.sum() < 1 << 16 and equal.sum() < 1 << 16
  before, total = _warp_scan(under | (equal << 16))
  quota = k - (total & 0xffff)
  assert quota >= 0
  slots = np.full(k, -1, np.int64)
  for lane in range(WARP):
    eq_rank = int(before[lane]) >> 16
    slot = (int(before[lane]) & 0xffff) + min(quota, eq_rank)
    for j in range(c):
      key = int(run[lane, j])
      pick = key < t
      if key == t:
        pick = eq_rank < quota
        eq_rank += 1
      if pick:
        slots[slot] = lane * c + j
        slot += 1
  assert (slots >= 0).all()
  return slots


def _plain_pick(keys, valid, k):
  """The plain version's pick (the jit program's argsort of the argsort)
  over keys as the uniforms they are (bits * 2**-23, exact in float32):
  the picked bitmap and the positions ascending, padded with L."""
  u = torch.from_numpy((keys.astype(np.float64) * 2.0**-23).astype(
      np.float32))
  picked = tm._picked(torch.from_numpy(valid), u, torch.from_numpy(k))
  length = keys.shape[1]
  pos = torch.where(picked, torch.arange(length), length)
  return picked.numpy(), torch.sort(pos, dim=1).values.numpy()


def _select_rows(keys, valid, row_len, k):
  """warp_select over each row, held against the plain pick exactly."""
  picked, pos = _plain_pick(keys, valid, k)
  length = keys.shape[1]
  for i in range(len(keys)):
    row_keys = np.where(valid[i], keys[i], NO_KEY)
    got = warp_select(row_keys, max(0, min(int(row_len[i]), length)),
                      int(k[i]))
    np.testing.assert_array_equal(got, pos[i, :k[i]])
    assert (pos[i, k[i]:] == length).all()
    bitmap = np.zeros(length, bool)
    bitmap[got] = True
    np.testing.assert_array_equal(bitmap, picked[i])


def _matrix_rows(rng, n, length, row_len):
  """Valid positions as the matrix program keys them: below row_len and
  not [CLS], the middle [SEP] (after ``na`` tokens of A) or the last."""
  row_len = np.asarray(row_len, np.int64)
  na = np.array([rng.integers(1, t - 3) if t > 4 else 1 for t in row_len])
  pos = np.arange(length)[None, :]
  special = ((pos == 0) | (pos == 1 + na[:, None]) |
             (pos == row_len[:, None] - 1))
  return (pos < row_len[:, None]) & ~special


def _draw(rng, shape, values):
  """23-bit keys: uniform, or drawn from ``values`` distinct ones (ties)."""
  if values is None:
    return rng.integers(0, 1 << KEY_BITS, shape).astype(np.uint64)
  pool = rng.choice(1 << KEY_BITS, values, replace=False)
  return pool[rng.integers(0, values, shape)].astype(np.uint64)


def _counts(row_len, valid, mode):
  """k as the programs count it (ratio 0.15, float32), or forced."""
  nvalid = valid.sum(1)
  if mode == 1:
    return np.minimum(1, nvalid)
  if mode == 'nvalid':
    return nvalid
  cap = 9 if mode == 'cap9' else None
  return tm._pick_counts_f32(torch.from_numpy(np.asarray(row_len)), 0.15,
                             torch.from_numpy(nvalid), cap).numpy()


@pytest.mark.parametrize('values', [None, 2, 3, 4],
                         ids=['distinct', 'ties2', 'ties3', 'ties4'])
@pytest.mark.parametrize('short', [True, False], ids=['row5', 'rowL'])
@pytest.mark.parametrize('length', [5, 128, 512, 1000, 1024, 1025, 8192])
def test_warp_select_equals_the_plain_pick(length, short, values):
  """The model equals the plain version's _picked and its sorted positions
  for k as the programs count it, k = 1, k = every valid position and the
  cap of 9; keys distinct or drawn from 2-4 values (ties broken by
  position); rows of 5 positions and of L; the register form (L <= 1024)
  and the shared-memory one (1025, 8192)."""
  rng = np.random.default_rng([length, short, values or 0])
  n = 3
  row_len = np.full(n, 5 if short else length)
  valid = _matrix_rows(rng, n, length, row_len)
  keys = _draw(rng, (n, length), values)
  for mode in ('ratio', 1, 'nvalid', 'cap9'):
    _select_rows(keys, valid, row_len, _counts(row_len, valid, mode))


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_warp_select_on_random_rows(data):
  """Random widths, row lengths (past L too), key widths (ties) and k."""
  length = data.draw(st.integers(5, 1100) | st.integers(1025, 8192))
  rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
  row_len = np.array([data.draw(st.integers(5, length + 3))])
  valid = _matrix_rows(rng, 1, length, np.minimum(row_len, length + 3))
  bits = data.draw(st.integers(1, KEY_BITS))
  keys = (_draw(rng, (1, length), None) >> (KEY_BITS - bits)) << (
      KEY_BITS - bits)
  k = np.array([data.draw(st.integers(0, int(valid.sum())))])
  _select_rows(keys, valid, row_len, k)


@pytest.mark.parametrize('seq_len,max_predictions', [
    (128, None), (512, 9), (1025, None)])
def test_warp_select_on_the_programs_draws(seq_len, max_predictions):
  """The model over the partition program's own keys (the uniform's 23
  bits from threefry at each valid position) gives its plain version's
  positions and k."""
  flat, a, b = _pairs(6, seq_len, seed=seq_len)
  kw = _partition_kw(seq_len, seed=3, max_predictions=max_predictions)
  pos, _, k = tm.mask_partition_device(flat, a, b, device='cpu', **kw)
  keys8 = tm.draw_keys(3)
  la, lb = a[:, 1] - a[:, 0], b[:, 1] - b[:, 0]
  p = np.arange(seq_len)[None, :]
  valid = (((p >= 1) & (p < 1 + la[:, None])) |
           ((p >= 2 + la[:, None]) & (p < 2 + la[:, None] + lb[:, None])))
  counts = torch.arange(len(a))[:, None] * seq_len + torch.from_numpy(p)
  bits = (tm._bits(keys8[0:2], counts) >> 9).numpy().astype(np.uint64)
  for i in range(len(a)):
    got = warp_select(np.where(valid[i], bits[i], NO_KEY),
                      min(int(la[i] + lb[i] + 3), seq_len), int(k[i]))
    np.testing.assert_array_equal(got, pos[i, :k[i]])
