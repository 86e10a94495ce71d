"""lddl_tpu_torch flash attention vs lddl_tpu's Pallas kernels.

The JAX side runs as its own tests run it on the CPU (Pallas interpret
mode); the port runs its plain PyTorch versions, which is what its
wrappers take for CPU tensors. Same numpy inputs on both sides.
Tolerances are those of tests/test_flash_attention.py: fwd 2e-5, grads
2e-4 (both f32, summation order differs), bf16 3e-2.

Segmented (block-diagonal) cases compare out and lse on real rows only
and feed zero cotangents on padding rows, as tests/test_block_diagonal.py
does: padding rows are outside the parity domain (the kernels skip their
all-padding tiles, the plain version and JAX's larger blocks do not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lddl_tpu.ops import flash_attention as jfa
from lddl_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


def _inputs(b, h, s, d, seed=0):
  rng = np.random.default_rng(seed)
  q, k, v = (rng.standard_normal((b, h, s, d), dtype=np.float32)
             for _ in range(3))
  lens = rng.integers(max(1, s // 2), s + 1, size=(b,))
  mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
  cot = rng.standard_normal((b, h, s, d), dtype=np.float32)
  cot_lse = rng.standard_normal((b, h, s), dtype=np.float32)
  return q, k, v, mask, cot, cot_lse


def _jax_side(q, k, v, mask, cot, cot_lse):
  def loss(q, k, v):
    out, lse = jfa.flash_attention_with_lse(q, k, v, jnp.asarray(mask))
    return jnp.sum(out * cot) + jnp.sum(lse * cot_lse), (out, lse)

  (_, (out, lse)), grads = jax.value_and_grad(
      loss, argnums=(0, 1, 2), has_aux=True)(
          jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  return [np.asarray(x) for x in (out, lse, *grads)]


def _torch_side(q, k, v, mask, cot, cot_lse):
  qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
  out, lse = tfa.flash_attention_with_lse(qt, kt, vt, torch.from_numpy(mask))
  (torch.sum(out * torch.from_numpy(cot)) +
   torch.sum(lse * torch.from_numpy(cot_lse))).backward()
  return [x.detach().numpy() for x in (out, lse, qt.grad, kt.grad, vt.grad)]


def _compare(jax_res, torch_res, fwd_tol=2e-5, grad_tol=2e-4):
  names = ('out', 'lse', 'dq', 'dk', 'dv')
  for name, a, b in zip(names, jax_res, torch_res):
    tol = fwd_tol if name in ('out', 'lse') else grad_tol
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize('shape', [
    (2, 2, 64, 32),    # single block
    (1, 3, 128, 64),   # exact block boundary
    (2, 2, 200, 64),   # ragged tail
    (1, 2, 320, 64),   # multi-block both axes
])
def test_out_lse_and_grads_match_jax(shape):
  args = _inputs(*shape, seed=sum(shape))
  _compare(_jax_side(*args), _torch_side(*args))


@pytest.mark.parametrize('caps', [(128, 128), (256, 256)])
def test_matches_jax_multiblock_kv_grid(monkeypatch, caps):
  """JAX with its kv caps forced small (several sequential kv blocks and
  -inf-biased overshoot columns) against the port."""
  monkeypatch.setattr(jfa, '_BLOCK_KV_FWD', caps[0])
  monkeypatch.setattr(jfa, '_BLOCK_KV_BWD', caps[1])
  args = _inputs(1, 2, 600, 64, seed=11)
  _compare(_jax_side(*args), _torch_side(*args))


def test_bf16_matches_jax():
  q, k, v, mask, _, _ = _inputs(1, 2, 128, 64, seed=5)
  jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
  ref = np.asarray(jfa.flash_attention(jq, jk, jv, jnp.asarray(mask)),
                   dtype=np.float32)
  tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
  out = tfa.flash_attention(tq, tk, tv, torch.from_numpy(mask))
  assert out.dtype == torch.bfloat16
  np.testing.assert_allclose(out.float().numpy(), ref, rtol=3e-2, atol=3e-2)


def test_no_mask_matches_jax():
  q, k, v, _, _, _ = _inputs(1, 2, 96, 32, seed=7)
  ref = np.asarray(jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v))))
  out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
  np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_plain_versions_match_autograd_of_dense():
  """The three plain kernel bodies against torch autograd through dense
  softmax attention (the algebra of delta, the clamp and the scale)."""
  q, k, v, mask, cot, cot_lse = _inputs(2, 2, 48, 32, seed=3)
  qt, kt, vt = (torch.from_numpy(x).double().requires_grad_()
                for x in (q, k, v))
  bias = torch.where(torch.from_numpy(mask) != 0, 0.0, tfa.NEG_INF).double()
  s = torch.einsum('bhqd,bhkd->bhqk', qt, kt) / 32 ** 0.5
  s = s + bias[:, None, None, :]
  lse = torch.logsumexp(s, dim=-1)
  out = torch.einsum('bhqk,bhkd->bhqd', torch.softmax(s, dim=-1), vt)
  (torch.sum(out * torch.from_numpy(cot)) +
   torch.sum(lse * torch.from_numpy(cot_lse))).backward()
  got = _torch_side(q, k, v, mask, cot, cot_lse)
  for name, ref, val in zip(('out', 'lse', 'dq', 'dk', 'dv'),
                            (out, lse, qt.grad, kt.grad, vt.grad), got):
    np.testing.assert_allclose(val, ref.detach().numpy(), rtol=2e-4,
                               atol=2e-4, err_msg=name)


def test_other_devices_raise():
  q = torch.zeros(1, 1, 8, 32, device='meta')
  with pytest.raises(ValueError, match='cuda'):
    tfa.flash_attention(q, q, q)


def test_kernel_checks_reject_what_the_kernels_do_not_take():
  """The CUDA path's argument checks (run on CPU tensors here: the check
  itself needs no card)."""
  q = torch.zeros(2, 8, 32)
  bias = torch.zeros(1, 8)
  tfa._check(q, q, q, bias, 2)  # well-formed: no raise
  with pytest.raises(ValueError, match='head_dim'):
    z = torch.zeros(2, 8, 48)
    tfa._check(z, z, z, bias, 2)
  with pytest.raises(ValueError, match='dtype'):
    h = q.half()
    tfa._check(h, h, h, bias, 2)
  with pytest.raises(ValueError, match='contiguous'):
    t = torch.zeros(2, 32, 8).transpose(1, 2)
    tfa._check(t, t, t, bias, 2)
  with pytest.raises(ValueError, match='bias'):
    tfa._check(q, q, q, bias.double(), 2)


# ---- segment ids (block-diagonal packed attention, K4) ----


def _ragged_segments(b, s, k, seed=0, pad_tail=True):
  """tests/test_block_diagonal.py's rows: k docs per row with boundaries
  off every block size, and a padded tail (ids -1, mask 0) on row 0."""
  rng = np.random.default_rng(seed)
  seg = np.zeros((b, s), np.int32)
  mask = np.ones((b, s), np.int32)
  for row in range(b):
    cuts = sorted(
        set(int(np.clip(i * s // k + rng.integers(-s // (4 * k), s //
                                                  (4 * k) + 1), 1, s - 1))
            for i in range(1, k)))
    bounds = [0] + cuts + [s]
    for d in range(len(bounds) - 1):
      seg[row, bounds[d]:bounds[d + 1]] = d
  if pad_tail:
    tail = s - max(1, s // 13)
    mask[0, tail:] = 0
    seg[0, tail:] = -1
  return seg, mask


def _seg_inputs(b, h, s, d, seg, mask, seed):
  """q, k, v and cotangents (zero on padding rows) as numpy f32."""
  rng = np.random.default_rng(seed)
  q, k, v, cot = (rng.standard_normal((b, h, s, d), dtype=np.float32)
                  for _ in range(4))
  cot_lse = rng.standard_normal((b, h, s), dtype=np.float32)
  real = mask.astype(bool)[:, None, :]
  return q, k, v, cot * real[..., None], cot_lse * real


def _jax_seg(q, k, v, mask, seg, cot, cot_lse):
  segj = jnp.asarray(seg)

  def loss(q, k, v):
    out, lse = jfa.flash_attention_with_lse(q, k, v, jnp.asarray(mask), segj,
                                            segj)
    return jnp.sum(out * cot) + jnp.sum(lse * cot_lse), (out, lse)

  (_, (out, lse)), grads = jax.value_and_grad(
      loss, argnums=(0, 1, 2), has_aux=True)(
          jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  return [np.asarray(x) for x in (out, lse, *grads)]


def _torch_seg(q, k, v, mask, seg, cot, cot_lse):
  qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
  segt = torch.from_numpy(seg)
  out, lse = tfa.flash_attention_with_lse(qt, kt, vt, torch.from_numpy(mask),
                                          segt, segt)
  (torch.sum(out * torch.from_numpy(cot)) +
   torch.sum(lse * torch.from_numpy(cot_lse))).backward()
  return [x.detach().numpy() for x in (out, lse, qt.grad, kt.grad, vt.grad)]


def _compare_real_rows(jax_res, torch_res, mask, fwd_tol=2e-5,
                       grad_tol=2e-4):
  real = mask.astype(bool)[:, None, :]
  for name, a, b in zip(('out', 'lse', 'dq', 'dk', 'dv'), jax_res,
                        torch_res):
    assert np.isfinite(b).all(), name
    if name == 'out':
      a, b = a * real[..., None], b * real[..., None]
    elif name == 'lse':
      a, b = a * real, b * real
    tol = fwd_tol if name in ('out', 'lse') else grad_tol
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize('b,s,k', [(2, 512, 4), (1, 2048, 16)])
def test_segmented_matches_jax(b, s, k):
  h, d = 2, 32
  seg, mask = _ragged_segments(b, s, k, seed=s + 1)
  args = (*_seg_inputs(b, h, s, d, seg, mask, seed=7 * s),)
  q, kk, v, cot, cot_lse = args
  _compare_real_rows(_jax_seg(q, kk, v, mask, seg, cot, cot_lse),
                     _torch_seg(q, kk, v, mask, seg, cot, cot_lse), mask)


def test_segmented_matches_jax_with_small_blocks(monkeypatch):
  """JAX with its blocks forced small, so that its grid really skips
  cross-document tiles in the forward and both backward kernels."""
  monkeypatch.setattr(jfa, '_BLOCK_Q', 64)
  monkeypatch.setattr(jfa, '_BLOCK_KV_SEG', 128)
  b, h, s, d = 2, 2, 512, 32
  seg, mask = _ragged_segments(b, s, 4, seed=11)
  assert jfa.count_skippable_tiles(seg, block_q=64, block_k=128)[1] > 0
  q, kk, v, cot, cot_lse = _seg_inputs(b, h, s, d, seg, mask, seed=13)
  _compare_real_rows(_jax_seg(q, kk, v, mask, seg, cot, cot_lse),
                     _torch_seg(q, kk, v, mask, seg, cot, cot_lse), mask)


@pytest.mark.parametrize('d', [64, 128])
def test_segmented_head_dims_match_jax(d):
  b, h, s = 1, 2, 384
  seg, mask = _ragged_segments(b, s, 3, seed=d)
  q, kk, v, cot, cot_lse = _seg_inputs(b, h, s, d, seg, mask, seed=d + 1)
  _compare_real_rows(_jax_seg(q, kk, v, mask, seg, cot, cot_lse),
                     _torch_seg(q, kk, v, mask, seg, cot, cot_lse), mask)


def test_segmented_bf16_matches_jax():
  b, h, s, d = 1, 2, 384, 64
  seg, mask = _ragged_segments(b, s, 3, seed=29, pad_tail=False)
  q, kk, v, _, _ = _seg_inputs(b, h, s, d, seg, mask, seed=23)
  segj = jnp.asarray(seg)
  ref = jfa.flash_attention(*(jnp.asarray(x).astype(jnp.bfloat16)
                              for x in (q, kk, v)), jnp.asarray(mask), segj,
                            segj)
  segt = torch.from_numpy(seg)
  out = tfa.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                              for x in (q, kk, v)), torch.from_numpy(mask),
                            segt, segt)
  assert out.dtype == torch.bfloat16
  np.testing.assert_allclose(out.float().numpy(),
                             np.asarray(ref, dtype=np.float32), rtol=3e-2,
                             atol=3e-2)


def test_all_padding_row_stays_finite_and_real_rows_match_jax():
  b, h, s, d = 2, 2, 256, 32
  seg, mask = _ragged_segments(b, s, 3, seed=17, pad_tail=False)
  seg[1], mask[1] = -1, 0
  q, kk, v, cot, cot_lse = _seg_inputs(b, h, s, d, seg, mask, seed=19)
  got = _torch_seg(q, kk, v, mask, seg, cot, cot_lse)
  assert all(np.isfinite(x).all() for x in got)
  _compare_real_rows(_jax_seg(q, kk, v, mask, seg, cot, cot_lse), got, mask)


def test_segment_ids_require_pairing():
  q = torch.zeros(1, 1, 64, 32)
  seg = torch.zeros(1, 64, dtype=torch.int32)
  with pytest.raises(ValueError, match='together'):
    tfa.flash_attention(q, q, q, None, seg, None)
  with pytest.raises(ValueError, match='together'):
    tfa.flash_attention(q, q, q, None, None, seg)


def test_plain_segmented_versions_match_autograd_of_dense():
  """The plain bodies with segment ids against torch autograd through
  dense block-diagonal softmax attention in float64 (real rows; zero
  cotangents on padding rows)."""
  b, h, s, d = 2, 2, 96, 32
  seg, mask = _ragged_segments(b, s, 3, seed=5)
  q, k, v, cot, cot_lse = _seg_inputs(b, h, s, d, seg, mask, seed=6)
  qt, kt, vt = (torch.from_numpy(x).double().requires_grad_()
                for x in (q, k, v))
  segt = torch.from_numpy(seg)
  bias = torch.where(torch.from_numpy(mask) != 0, 0.0, tfa.NEG_INF).double()
  same = segt[:, :, None] == segt[:, None, :]
  sc = torch.einsum('bhqd,bhkd->bhqk', qt, kt) / d ** 0.5
  sc = sc + bias[:, None, None, :] + torch.where(same, 0.0,
                                                 tfa.NEG_INF)[:, None]
  lse = torch.logsumexp(sc, dim=-1)
  out = torch.einsum('bhqk,bhkd->bhqd', torch.softmax(sc, dim=-1), vt)
  (torch.sum(out * torch.from_numpy(cot)) +
   torch.sum(lse * torch.from_numpy(cot_lse))).backward()
  ref = [x.detach().numpy() for x in (out, lse, qt.grad, kt.grad, vt.grad)]
  _compare_real_rows(ref, _torch_seg(q, k, v, mask, seg, cot, cot_lse), mask,
                     fwd_tol=2e-4)


def test_kernel_checks_reject_bad_segment_ids():
  q = torch.zeros(2, 8, 32)
  bias = torch.zeros(1, 8)
  seg = torch.zeros(1, 8, dtype=torch.int32)
  tfa._check(q, q, q, bias, 2, seg=tfa.Segments(seg, seg))  # no raise
  with pytest.raises(ValueError, match='segment ids'):
    tfa._check(q, q, q, bias, 2, seg=tfa.Segments(seg.long(), seg))
  with pytest.raises(ValueError, match='segment ids'):
    tfa._check(q, q, q, bias, 2, seg=tfa.Segments(seg, seg[:, :4]))


# ---- tile accounting ----


@pytest.mark.parametrize('block', [64, 128, 512])
def test_segment_block_intervals_match_jax(block):
  seg, _ = _ragged_segments(2, 1024, 7, seed=3)
  seg[1, 1000:] = -1
  for got, ref in zip(tfa.segment_block_intervals(seg, block),
                      jfa.segment_block_intervals(seg, block)):
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('blocks', [(64, 64), (64, 128), (128, 512)])
def test_count_skippable_tiles_matches_jax_at_equal_blocks(blocks):
  seg, _ = _ragged_segments(2, 2048, 16, seed=3)
  assert (tfa.count_skippable_tiles(seg, *blocks) ==
          jfa.count_skippable_tiles(seg, *blocks))


@pytest.mark.parametrize('head_dim', [64, 128])
def test_count_skippable_tiles_at_the_cuda_tiles(head_dim):
  """tests/test_block_diagonal.py::test_count_skippable_tiles's
  expectations at the CUDA tiles (64 owned rows, stream_rows streamed)."""
  one = np.zeros((2, 2048), np.int32)
  total, skipped = tfa.count_skippable_tiles(one, head_dim=head_dim)
  assert total == 2 * 32 * (2048 // tfa.stream_rows(head_dim))
  assert skipped == 0
  seg, _ = _ragged_segments(2, 2048, 16, seed=3, pad_tail=False)
  total, skipped = tfa.count_skippable_tiles(seg, head_dim=head_dim)
  assert skipped / total > 0.8
  pad = np.full((1, 512), -1, np.int32)
  total, skipped = tfa.count_skippable_tiles(pad, head_dim=head_dim)
  assert skipped == total


# ---- the bf16 tensor-core bodies' rounding (K1, K3 and their K4 forms) ----


def _round_bf16(x):
  return x.to(torch.bfloat16).float()


def _mma_fwd(q, k, v, bias, heads, qseg=None, kvseg=None):
  """The bf16 forward body's arithmetic in torch: exact products of the
  bf16 operands summed in float32, an online softmax over kv tiles of
  stream_rows(d) columns, and P rounded to bf16 before P V. The running
  max, l, lse and the accumulator stay float32."""
  s = tfa._scores(q, k, bias, heads, qseg, kvseg)
  bh, s_q, s_kv = s.shape
  m = torch.full((bh, s_q, 1), tfa.NEG_INF)
  l = torch.zeros((bh, s_q, 1))
  acc = torch.zeros((bh, s_q, q.shape[-1]))
  bn = tfa.stream_rows(q.shape[-1])
  for c0 in range(0, s_kv, bn):
    tile = s[:, :, c0:c0 + bn]
    m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
    p = torch.exp(tile - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.matmul(_round_bf16(p), v[:, c0:c0 + bn].float())
    m = m_new
  l = l.clamp_min(tfa._L_FLOOR)
  return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _mma_dkv(q, k, v, bias, dout, lse, delta, heads, qseg=None, kvseg=None):
  """The bf16 dk/dv body's arithmetic: P and dS rounded to bf16 before
  the products that take them, float32 everywhere else."""
  scale = 1.0 / q.shape[-1] ** 0.5
  s = tfa._scores(q, k, bias, heads, qseg, kvseg) - lse[..., None]
  p = torch.exp(torch.clamp_max(s, tfa._EXP_CLAMP))
  dv = torch.matmul(_round_bf16(p).transpose(1, 2), dout.float())
  dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
  ds = p * (dp - delta[..., None])
  dk = torch.matmul(_round_bf16(ds).transpose(1, 2), q.float()) * scale
  return dk.to(q.dtype), dv.to(q.dtype)


def _bf16_chain(q, k, v, mask, cot, cot_lse, seg, fwd, dkv):
  """(out, lse, dq, dk, dv) of [b, h, s, d] numpy inputs in bf16 through
  ``fwd`` and ``dkv`` (dq through the float32 body, as on the card), as
  the autograd function chains them."""
  b, h, s, d = q.shape
  qt, kt, vt = (torch.from_numpy(x.reshape(b * h, s, d)).to(torch.bfloat16)
                for x in (q, k, v))
  bias = tfa.key_bias(torch.from_numpy(mask), b, s, 'cpu')
  ids = () if seg is None else (torch.from_numpy(seg),) * 2
  out, lse = fwd(qt, kt, vt, bias, h, *ids)
  g, delta = tfa._backward_rows(torch.from_numpy(cot.reshape(b * h, s, d)),
                                torch.from_numpy(cot_lse.reshape(b * h, s)),
                                out, qt)
  dq = tfa._dq_plain(qt, kt, vt, bias, g, lse, delta, h, *ids)
  dk, dv = dkv(qt, kt, vt, bias, g, lse, delta, h, *ids)
  return [x.float().numpy().reshape(shape) for x, shape in
          zip((out, lse, dq, dk, dv), ((b, h, s, d), (b, h, s)) + ((b, h, s,
                                                                   d),) * 3)]


def _jax_bf16(q, k, v, mask, cot, cot_lse, seg):
  segj = None if seg is None else jnp.asarray(seg)

  def loss(q, k, v):
    out, lse = jfa.flash_attention_with_lse(q, k, v, jnp.asarray(mask), segj,
                                            segj)
    return (jnp.sum(out.astype(jnp.float32) * cot) + jnp.sum(lse * cot_lse),
            (out, lse))

  (_, (out, lse)), grads = jax.value_and_grad(
      loss, argnums=(0, 1, 2), has_aux=True)(
          *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)))
  return [np.asarray(x, dtype=np.float32) for x in (out, lse, *grads)]


@pytest.mark.parametrize('d,seg_docs', [(32, None), (64, None), (128, None),
                                        (64, 3)],
                         ids=['d32-ragged', 'd64-ragged', 'd128-ragged',
                              'd64-segmented-padding-row'])
def test_bf16_body_rounding_holds_the_bf16_tolerance(d, seg_docs):
  """P (and dS) rounded to bf16 before their products, as the tensor-core
  bodies do, stays within the bf16 tolerance the card is held to (3e-2)
  of the float32 plain versions and of JAX's bf16 flash attention
  (interpret mode). Out and lse on real rows; gradients with zero
  cotangents on padding rows where there are segment ids."""
  b, h, s = 2, 2, 384 if seg_docs else 512 if d == 64 else 256
  if seg_docs is None:
    q, k, v, mask, cot, cot_lse = _inputs(b, h, s, d, seed=d)
    seg = None
  else:
    seg, mask = _ragged_segments(b, s, seg_docs, seed=31, pad_tail=False)
    seg[1], mask[1] = -1, 0  # a row of padding only
    q, k, v, cot, cot_lse = _seg_inputs(b, h, s, d, seg, mask, seed=37)
  args = (q, k, v, mask, cot, cot_lse, seg)
  mma = _bf16_chain(*args, fwd=_mma_fwd, dkv=_mma_dkv)
  plain = _bf16_chain(*args, fwd=tfa._fwd_plain, dkv=tfa._dkv_plain)
  ref = _jax_bf16(*args)
  real = np.ones((b, s), bool) if seg is None else mask.astype(bool)
  rows = np.broadcast_to(real[:, None, :], (b, h, s))
  for name, got, p, r in zip(('out', 'lse', 'dq', 'dk', 'dv'), mma, plain,
                             ref):
    assert np.isfinite(got).all(), name
    if name in ('out', 'lse'):
      got, p, r = got[rows], p[rows], r[rows]
    np.testing.assert_allclose(got, p, rtol=3e-2, atol=3e-2,
                               err_msg=f'{name} vs float32 plain')
    np.testing.assert_allclose(got, r, rtol=3e-2, atol=3e-2,
                               err_msg=f'{name} vs JAX bf16')


def test_kernel_checks_reject_misaligned_bf16_rows():
  """The bf16 bodies copy rows in 16-byte chunks: a bf16 input that does
  not start 16-byte aligned is refused (float32 inputs are not)."""
  bias = torch.zeros(1, 8)
  q = torch.zeros(2, 8, 32, dtype=torch.bfloat16)
  tfa._check(q, q, q, bias, 2)  # a fresh allocation: no raise
  shifted = torch.zeros(2 * 8 * 32 + 1, dtype=torch.bfloat16)[1:].view(2, 8, 32)
  assert shifted.is_contiguous()
  with pytest.raises(ValueError, match='16-byte aligned'):
    tfa._check(shifted, q, q, bias, 2)
  f32 = torch.zeros(2 * 8 * 32 + 1)[1:].view(2, 8, 32)
  tfa._check(f32, f32, f32, bias, 2)
