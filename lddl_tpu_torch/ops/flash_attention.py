"""Flash attention on the H100: hand-written CUDA kernels + autograd.

Counterpart of :mod:`lddl_tpu.ops.flash_attention`, with its public
layout: ``q, k, v`` are ``[batch, heads, seq, head_dim]``, the key mask is
``[batch, seq]`` (1 = attend, 0 = padding) and becomes an additive float32
bias of 0 or ``NEG_INF`` shared by the heads of a row. Internally the
arrays are flattened to ``[batch*heads, seq, head_dim]``.

Three kernels carry it (``lddl_tpu_torch/csrc/flash_attention.cu``):

  - ``fwd`` (K1): online softmax over kv tiles -> ``out`` in the input
    dtype and the per-row log-sum-exp ``lse`` in float32;
  - ``dq`` (K2): ``dq = scale * sum_kv (P * (dO V^T - delta)) K`` with
    ``P = exp(s - lse)``;
  - ``dkv`` (K3): ``dv = sum_q P^T dO``, ``dk = scale * sum_q dS^T Q`` with
    ``P = exp(min(s - lse, 30))``.

``delta = rowsum(dO * O) - g_lse`` is computed here in torch, outside the
kernels, as the JAX backward computes it outside Pallas; folding the lse
cotangent into it gives gradients for both outputs of
:func:`flash_attention_with_lse`.

Each kernel has a plain PyTorch version (``_fwd_plain``, ``_dq_plain``,
``_dkv_plain``) that repeats its arithmetic over the whole score matrix.
The wrappers take the plain version only for tensors on the CPU (the tests
run there); for a CUDA tensor they launch the kernel or raise. Every launch
adds one to ``launches[name]``.

Padding semantics: the JAX wrapper pads q/k/v to ``_padded_len(s)`` with
``NEG_INF``-biased key columns. Here the kernels bound-check their ragged
edge instead, which gives the same result for every query row with at
least one attended key (a loader row always has ``[CLS]``). A row with no
attended key is outside that domain: it gets the mean of V over the real
keys, where JAX also averages in its zero padding columns.

Segment ids (block-diagonal packed attention, the TPU kernels' segmented
form) are not ported yet and raise ``NotImplementedError``.
"""

import torch

from . import _build

NEG_INF = -1e9
# Softmax-denominator floor, as in the JAX kernels: l >= 1 for any row with
# an attended key, so the floor only guards the degenerate rows.
_L_FLOOR = 1e-30
# The dkv kernel clamps s - lse here before exp (padding-row overflow guard).
_EXP_CLAMP = 30.0

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535

# Kernel launches by name; each wrapper adds one where it launches, nowhere
# else (chip_smoke.py reads these to show the main path used the kernels).
launches = {'fwd': 0, 'dq': 0, 'dkv': 0}


def reset_launches():
  for name in launches:
    launches[name] = 0


# ---- plain PyTorch versions (CPU path and the on-card reference) ----


def _scores(q, k, bias, heads):
  """f32 ``scale * q k^T + bias`` over the whole ``[bh, s_q, s_kv]``."""
  scale = 1.0 / q.shape[-1] ** 0.5
  s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
  return s + bias.repeat_interleave(heads, dim=0)[:, None, :]


def _fwd_plain(q, k, v, bias, heads):
  s = _scores(q, k, bias, heads)
  # The kernels' running max starts at NEG_INF.
  m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
  p = torch.exp(s - m)
  l = p.sum(dim=-1, keepdim=True).clamp_min(_L_FLOOR)
  out = torch.matmul(p, v.float()) / l
  return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _dq_plain(q, k, v, bias, dout, lse, delta, heads):
  scale = 1.0 / q.shape[-1] ** 0.5
  p = torch.exp(_scores(q, k, bias, heads) - lse[..., None])
  dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
  ds = p * (dp - delta[..., None])
  return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def _dkv_plain(q, k, v, bias, dout, lse, delta, heads):
  scale = 1.0 / q.shape[-1] ** 0.5
  s = _scores(q, k, bias, heads) - lse[..., None]
  p = torch.exp(torch.clamp_max(s, _EXP_CLAMP))
  dv = torch.matmul(p.transpose(1, 2), dout.float())
  dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
  ds = p * (dp - delta[..., None])
  dk = torch.matmul(ds.transpose(1, 2), q.float()) * scale
  return dk.to(q.dtype), dv.to(q.dtype)


# ---- kernel wrappers ----


def _check(q, k, v, bias, heads, *rows):
  """Raise on anything the CUDA kernels do not take."""
  if not (q.dim() == k.dim() == v.dim() == 3):
    raise ValueError('q, k, v must be [batch*heads, seq, head_dim]')
  bh, s_q, d = q.shape
  s_kv = k.shape[1]
  if k.shape != (bh, s_kv, d) or v.shape != k.shape:
    raise ValueError(f'shape mismatch: q {tuple(q.shape)}, k '
                     f'{tuple(k.shape)}, v {tuple(v.shape)}')
  if d not in HEAD_DIMS:
    raise ValueError(f'head_dim {d} not supported (kernels take {HEAD_DIMS})')
  if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
    raise ValueError(f'q/k/v must share one dtype of {DTYPES}; got '
                     f'{q.dtype}, {k.dtype}, {v.dtype}')
  if s_q == 0 or s_kv == 0 or bh == 0:
    raise ValueError('empty attention input')
  if bh % heads or bh > _MAX_GRID_Y:
    raise ValueError(f'batch*heads {bh} must be a multiple of heads '
                     f'{heads} and at most {_MAX_GRID_Y}')
  if bias.dtype != torch.float32 or tuple(bias.shape) != (bh // heads, s_kv):
    raise ValueError(f'bias must be float32 [{bh // heads}, {s_kv}]; got '
                     f'{bias.dtype} {tuple(bias.shape)}')
  tensors = (q, k, v, bias) + rows
  for t in tensors:
    if t.device != q.device:
      raise ValueError('all inputs must be on one device')
    if not t.is_contiguous():
      raise ValueError('kernel inputs must be contiguous')


def _use_kernel(q):
  """'cpu' -> plain path, 'cuda' -> kernel; any other device raises."""
  if q.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'flash attention runs on cuda (kernels) or cpu (plain '
                     f'reference); got device {q.device}')
  return q.device.type == 'cuda'


def _launch(name, heads, *tensors):
  """Launch ``lddl_flash_<name>`` on ``tensors`` (q, k, ... in the C
  launcher's order) on the current stream and count it."""
  q, k = tensors[:2]
  bh, s_q, d = q.shape
  with torch.cuda.device(q.device):
    _build.launch(f'lddl_flash_{name}', *(t.data_ptr() for t in tensors),
                  bh, heads, s_q, k.shape[1], d,
                  int(q.dtype == torch.bfloat16), 1.0 / d ** 0.5,
                  torch.cuda.current_stream().cuda_stream)
  launches[name] += 1


def _fwd(q, k, v, bias, heads):
  if not _use_kernel(q):
    return _fwd_plain(q, k, v, bias, heads)
  _check(q, k, v, bias, heads)
  out = torch.empty_like(q)
  lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
  _launch('fwd', heads, q, k, v, bias, out, lse)
  return out, lse


def _dq(q, k, v, bias, dout, lse, delta, heads):
  if not _use_kernel(q):
    return _dq_plain(q, k, v, bias, dout, lse, delta, heads)
  _check(q, k, v, bias, heads, dout, lse, delta)
  dq = torch.empty_like(q)
  _launch('dq', heads, q, k, v, bias, dout, lse, delta, dq)
  return dq


def _dkv(q, k, v, bias, dout, lse, delta, heads):
  if not _use_kernel(q):
    return _dkv_plain(q, k, v, bias, dout, lse, delta, heads)
  _check(q, k, v, bias, heads, dout, lse, delta)
  dk = torch.empty_like(k)
  dv = torch.empty_like(v)
  _launch('dkv', heads, q, k, v, bias, dout, lse, delta, dk, dv)
  return dk, dv


def _backward_rows(g, g_lse, out, q):
  """(dO in q.dtype, delta = rowsum(dO * O) - g_lse in float32)."""
  g = g.to(q.dtype).contiguous()
  delta = (g.float() * out.float()).sum(dim=-1) - g_lse.float()
  return g, delta.contiguous()


class _FlashPair(torch.autograd.Function):
  """``(out, lse)`` of ``[bh, s, d]`` inputs, differentiable in both."""

  @staticmethod
  def forward(ctx, q, k, v, bias, heads):
    out, lse = _fwd(q, k, v, bias, heads)
    ctx.save_for_backward(q, k, v, bias, out, lse)
    ctx.heads = heads
    return out, lse

  @staticmethod
  def backward(ctx, g, g_lse):
    q, k, v, bias, out, lse = ctx.saved_tensors
    g, delta = _backward_rows(g, g_lse, out, q)
    dq = _dq(q, k, v, bias, g, lse, delta, ctx.heads)
    dk, dv = _dkv(q, k, v, bias, g, lse, delta, ctx.heads)
    return dq, dk, dv, None, None


def key_bias(attention_mask, batch, s_kv, device):
  """``[batch, s_kv]`` float32 additive key bias: 0 where the mask is
  nonzero, ``NEG_INF`` elsewhere (zeros when there is no mask)."""
  if attention_mask is None:
    return torch.zeros((batch, s_kv), dtype=torch.float32, device=device)
  zero = torch.zeros((), dtype=torch.float32, device=device)
  return torch.where(attention_mask != 0, zero, NEG_INF).contiguous()


def flash_attention_with_lse(q, k, v, attention_mask=None,
                             q_segment_ids=None, kv_segment_ids=None):
  """Like :func:`flash_attention` but also returns the per-query
  log-sum-exp ``[batch, heads, seq]`` (float32). Gradients flow through
  both outputs."""
  if q_segment_ids is not None or kv_segment_ids is not None:
    raise NotImplementedError(
        'segment ids (block-diagonal packed attention) are not ported to '
        'the CUDA kernels yet')
  b, h, s_q, d = q.shape
  s_kv = k.shape[2]
  bias = key_bias(attention_mask, b, s_kv, q.device)
  out, lse = _FlashPair.apply(q.reshape(b * h, s_q, d).contiguous(),
                              k.reshape(b * h, s_kv, d).contiguous(),
                              v.reshape(b * h, s_kv, d).contiguous(), bias, h)
  return out.view(b, h, s_q, d), lse.view(b, h, s_q)


def flash_attention(q, k, v, attention_mask=None, q_segment_ids=None,
                    kv_segment_ids=None):
  """Blockwise-softmax attention; drop-in for the dense path.

  ``q, k, v``: ``[batch, heads, seq, head_dim]`` in float32 or bfloat16;
  ``attention_mask``: ``[batch, seq]`` with 1 = attend, 0 = padding (key
  side). Returns the context ``[batch, heads, seq, head_dim]`` in the
  input dtype.
  """
  return flash_attention_with_lse(q, k, v, attention_mask, q_segment_ids,
                                  kv_segment_ids)[0]
