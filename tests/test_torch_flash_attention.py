"""lddl_tpu_torch flash attention vs lddl_tpu's Pallas kernels.

The JAX side runs as its own tests run it on the CPU (Pallas interpret
mode); the port runs its plain PyTorch versions, which is what its
wrappers take for CPU tensors. Same numpy inputs on both sides.
Tolerances are those of tests/test_flash_attention.py: fwd 2e-5, grads
2e-4 (both f32, summation order differs), bf16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lddl_tpu.ops import flash_attention as jfa
from lddl_tpu_torch.ops import flash_attention as tfa


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


def test_segment_ids_not_ported():
  q = torch.zeros(1, 1, 8, 32)
  seg = torch.zeros(1, 8, dtype=torch.int32)
  with pytest.raises(NotImplementedError):
    tfa.flash_attention(q, q, q, None, seg, seg)


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
