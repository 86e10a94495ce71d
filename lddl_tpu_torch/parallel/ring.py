"""Ring attention: exact attention over the mesh's ``seq`` axis.

The port of :mod:`lddl_tpu.parallel.ring`. Each rank of a ``seq`` group
holds a ``[batch, heads, seq/N, head_dim]`` shard of Q, K and V; the K/V
shards (and the key mask) rotate around the ring, one step to rank
``(r + 1) % N`` at a time, while a streaming log-sum-exp accumulator keeps
the softmax exact. No rank ever holds the whole K/V, so the longest row
grows with the ring at constant memory a rank.

Block-diagonal packed rows compose with the ring: the kv segment ids
(document per token, -1 on padding) rotate with K/V, and every rotated
shard runs its block. The JAX ring skips a shard whose id interval is
disjoint from the local q shard's in every row; here the segmented
kernels (:mod:`lddl_tpu_torch.ops.flash_attention`, K4) skip such a
shard's every tile on the device, and the merge gives it weight exactly
0 (its row max is the finite ``-1e9``), so the values are the same
without a host test of the ids per block, and an eager step runs what a
CUDA graph of it captures.

The rotation is :func:`torch.distributed.batch_isend_irecv`, one message
a step holding K, V, the mask and the ids packed as bytes, inside an
autograd function whose backward rotates the K/V cotangents the other
way (the transpose of JAX's ``ppermute``), so each shard's gradient ends
on the rank that holds it. NCCL sends the card's buffer; any other
backend (gloo) takes host tensors, so a CUDA buffer is staged through
host memory there. A failed send or receive raises.

A liberty the values allow: N - 1 rotations (the JAX loop's N-th
brings every shard home unused).

Numerics: scores and accumulators are float32 whatever the input dtype;
the output is cast back to the input dtype.
"""

import math

import torch

from ..ops.flash_attention import NEG_INF, flash_attention_with_lse

_ALIGN = 16  # byte offset of each tensor in a rotation's message


def _block_attn(q, k, v, bias, scale):
  """One block's contribution: (scores_max, exp_scores @ v, denom)."""
  s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
  if bias is not None:
    s = s + bias
  m = s.amax(dim=-1, keepdim=True)
  p = torch.exp(s - m)
  o = torch.matmul(p, v.float())
  return m, o, p.sum(dim=-1, keepdim=True)


# ---- the rotation ----


def _pack(tensors, device):
  """The tensors' bytes in one uint8 buffer, each at a 16-byte offset;
  returns (buffer, layout)."""
  layout, at = [], 0
  for t in tensors:
    n = t.numel() * t.element_size()
    layout.append((at, n, t.dtype, t.shape))
    at += -(-n // _ALIGN) * _ALIGN
  buf = torch.empty(at, dtype=torch.uint8, device=device)
  for t, (off, n, _, _) in zip(tensors, layout):
    buf[off:off + n].copy_(t.contiguous().view(-1).view(torch.uint8))
  return buf, layout


def _unpack(buf, layout):
  return [buf[off:off + n].view(dtype).view(shape)
          for off, n, dtype, shape in layout]


def _shift(group, tensors, step):
  """``tensors`` sent to group rank ``(r + step) % n`` and the same-shaped
  tensors received from ``(r - step) % n``, in one message each way."""
  import torch.distributed as dist

  from .mesh import backend_for
  n = dist.get_world_size(group)
  r = dist.get_rank(group)
  device = tensors[0].device
  buf, layout = _pack(tensors, device)
  staged = backend_for(group, device) != 'nccl' and device.type != 'cpu'
  if staged:
    buf = buf.cpu()
  out = torch.empty_like(buf)
  ops = [dist.P2POp(dist.isend, buf,
                    dist.get_global_rank(group, (r + step) % n), group),
         dist.P2POp(dist.irecv, out,
                    dist.get_global_rank(group, (r - step) % n), group)]
  for work in dist.batch_isend_irecv(ops):
    work.wait()
  if staged:
    out = out.to(device)
  return _unpack(out, layout)


class _Rotate(torch.autograd.Function):
  """K and V (and the key-side extras: mask, ids) one step around the
  ring; the backward sends the K/V cotangents one step back."""

  @staticmethod
  def forward(ctx, group, k, v, *extras):
    ctx.group = group
    ctx.n_extras = len(extras)
    out = _shift(group, [k, v, *extras], 1)
    ctx.mark_non_differentiable(*out[2:])
    return tuple(out)

  @staticmethod
  def backward(ctx, gk, gv, *_):
    gk, gv = _shift(ctx.group, [gk, gv], -1)
    return (None, gk, gv) + (None,) * ctx.n_extras


def _rotate(group, k, v, mask, seg):
  extras = [t for t in (mask, seg) if t is not None]
  k, v, *rest = _Rotate.apply(group, k, v, *extras)
  rest = iter(rest)
  return (k, v, None if mask is None else next(rest),
          None if seg is None else next(rest))


# ---- the ring ----


def ring_attention(q, k, v, kv_mask=None, group=None, block_impl='dense',
                   q_segment_ids=None, kv_segment_ids=None):
  """Exact softmax attention with K/V sharded over the process group
  ``group`` (the mesh's ``seq`` group; None: one rank, one block).

  Shapes (this rank's shards): q, k, v ``[b, h, s_block, d]``;
  ``kv_mask`` ``[b, s_block]`` with 1 = attend, 0 = padding (it rotates
  with K/V). Every rank of ``group`` must call it.

  ``block_impl``: each block's attention: 'dense' (matmuls over the
  block's score matrix) or 'flash'
  (:func:`~lddl_tpu_torch.ops.flash_attention.flash_attention_with_lse`,
  the CUDA kernels on the card); a flash block's (out, lse) enters the
  streaming merge as ``(m=lse, o=out, l=1)``.

  ``q_segment_ids`` / ``kv_segment_ids``: optional ``[b, s_block]`` int
  per-token doc ids (-1 = padding), given together, restricting attention
  to same-document pairs. The kv ids rotate with K/V; a real q row with
  no same-document key in a rotated shard gets that block's finite
  ``-1e9`` max, so the merge gives the block weight exactly 0.
  """
  if (q_segment_ids is None) != (kv_segment_ids is None):
    raise ValueError('q_segment_ids and kv_segment_ids must be given '
                     'together')
  import torch.distributed as dist
  n = 1 if group is None else dist.get_world_size(group)
  b, h, s, d = q.shape
  scale = 1.0 / math.sqrt(d)
  qf = q.float()
  f32 = dict(dtype=torch.float32, device=q.device)
  zero = torch.zeros((), **f32)

  def bias_of(mask, kv_seg):
    bias = None
    if mask is not None:
      bias = torch.where(mask.bool(), zero, NEG_INF)[:, None, None, :]
    if kv_seg is not None:
      same = q_segment_ids[:, None, :, None] == kv_seg[:, None, None, :]
      seg_bias = torch.where(same, zero, NEG_INF)
      bias = seg_bias if bias is None else bias + seg_bias
    return bias

  if block_impl == 'flash':
    def block(k_blk, v_blk, mask_blk, kv_seg_blk):
      out, lse = flash_attention_with_lse(
          q, k_blk, v_blk, mask_blk,
          q_segment_ids if kv_seg_blk is not None else None, kv_seg_blk)
      # The flash output is normalized by its own denominator, so
      # (m=lse, o=out, l=1) merges exactly: exp(lse - M) * out carries
      # exp(m - M) times the unnormalized sum.
      lse = lse[..., None]
      return lse, out.float(), torch.ones_like(lse)
  elif block_impl == 'dense':
    def block(k_blk, v_blk, mask_blk, kv_seg_blk):
      return _block_attn(qf, k_blk, v_blk, bias_of(mask_blk, kv_seg_blk),
                         scale)
  else:
    raise ValueError(f'unknown block_impl {block_impl!r}')

  m_acc = torch.full((b, h, s, 1), -math.inf, **f32)
  o_acc = torch.zeros((b, h, s, d), **f32)
  l_acc = torch.zeros((b, h, s, 1), **f32)
  blk = (k, v, kv_mask, kv_segment_ids)
  for i in range(n):
    m_blk, o_blk, l_blk = block(*blk)
    m_new = torch.maximum(m_acc, m_blk)
    alpha = torch.exp(m_acc - m_new)
    beta = torch.exp(m_blk - m_new)
    o_acc = o_acc * alpha + o_blk * beta
    l_acc = l_acc * alpha + l_blk * beta
    m_acc = m_new
    if i < n - 1:
      blk = _rotate(group, *blk)
  return (o_acc / l_acc.clamp_min(1e-20)).to(q.dtype)


def make_ring_attention(mesh, block_impl='dense', with_segment_ids=False):
  """:func:`ring_attention` over ``mesh``'s ``seq`` group, as
  :func:`lddl_tpu.parallel.ring.make_ring_attention`. The JAX function
  wraps the ring in ``shard_map`` with q sharded ``P(('data', 'fsdp'),
  'tensor', 'seq', None)``; here a rank already holds its rows, its
  ``num_heads / tensor`` heads and its ``1 / seq`` of the sequence, so the
  returned function checks that the arrays agree with each other and runs
  the ring on them.

  It takes ``(q, k, v, mask)``, or with ``with_segment_ids`` also
  ``segment_ids`` ``[batch, seq/N]`` (self-attention: the same ids for q
  and kv).
  """
  from .mesh import seq_group
  group = seq_group(mesh)

  def sharded(q, k, v, mask, *segment_ids):
    if len(segment_ids) != int(with_segment_ids):
      raise TypeError(f'with_segment_ids={with_segment_ids}: takes '
                      f'{4 + int(with_segment_ids)} arrays, got '
                      f'{4 + len(segment_ids)}')
    if k.shape != q.shape or v.shape != q.shape:
      raise ValueError(f'shape mismatch: q {tuple(q.shape)}, k '
                       f'{tuple(k.shape)}, v {tuple(v.shape)}')
    b, s = q.shape[0], q.shape[2]
    for name, t in (('mask', mask), *(('segment_ids', x) for x in
                                      segment_ids)):
      if tuple(t.shape) != (b, s):
        raise ValueError(f'{name} {tuple(t.shape)} does not match this '
                         f"rank's q {tuple(q.shape)} (rows [{b}, {s}])")
    seg = segment_ids[0] if segment_ids else None
    return ring_attention(q, k, v, mask, group=group, block_impl=block_impl,
                          q_segment_ids=seg, kv_segment_ids=seg)

  return sharded
