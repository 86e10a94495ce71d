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

In bf16 all three run on the tensor cores (``mma.sync``) and round the
probabilities P (``fwd``, ``dkv``) and dS (``dq``, ``dkv``) to bf16 before
the products that take them; in float32 all three run float32 FMAs on the
CUDA cores.

``delta = rowsum(dO * O) - g_lse`` is computed here in torch, outside the
kernels, as the JAX backward computes it outside Pallas; folding the lse
cotangent into it gives gradients for both outputs of
:func:`flash_attention_with_lse`.

Each kernel has a plain PyTorch version (``_fwd_plain``, ``_dq_plain``,
``_dkv_plain``) that repeats its arithmetic over the whole score matrix.
The wrappers take the plain version only for tensors on the CPU (the tests
run there); for a CUDA tensor they launch the kernel or raise. Every launch
adds one to ``launches[name]``. The kernels also count themselves on the
device (:func:`device_launches`), so a launch replayed from a CUDA graph,
which runs no Python, is counted there as it ran.

Padding semantics: the JAX wrapper pads q/k/v to ``_padded_len(s)`` with
``NEG_INF``-biased key columns. Here the kernels bound-check their ragged
edge instead, which gives the same result for every query row with at
least one attended key (a loader row always has ``[CLS]``). A row with no
attended key is outside that domain: it gets the mean of V over the real
keys, where JAX also averages in its zero padding columns.

Segment ids (block-diagonal packed attention): ``q_segment_ids`` and
``kv_segment_ids``, int ``[batch, seq]`` document ids with -1 on padding,
restrict attention to same-document pairs. They run the segmented kernels
``fwd_seg``, ``dq_seg`` and ``dkv_seg`` (K4): the same three bodies, which
skip every tile whose id interval is disjoint from the owned tile's
before loading it, and add a ``NEG_INF`` same-document bias on the tiles
they keep. The intervals come from :func:`_tile_intervals` at the
kernels' tile widths (:data:`TILE_ROWS` owned, :func:`stream_rows`
streamed), once per attention call for its three kernels
(:class:`Segments`); :func:`count_skippable_tiles` counts what the grid
skips. The plain versions add the same bias over the whole score matrix
and skip nothing. Parity domain: rows with an id >= 0 (real tokens) match the
plain version and JAX. Padding rows stay finite; a tile whose rows are
all padding skips every tile and gives out = 0 (with a finite lse), where
the plain version, which skips nothing, averages over the padding keys.
Padding rows are never compared, and their cotangents are zero in the
model.

Step costs: :func:`work` gives a launch's FLOPs and bytes from its shapes
and the (query, key) pairs it computes, one formula for K1-K4 (the
on-card bound table of ``chip_smoke.py`` reads it too). Under a
:class:`~lddl_tpu_torch.telemetry.step_costs.StepCostCounter` each
wrapper bills its launch by it, on the card and on the CPU alike, and
keeps its own torch ops and the plain versions out of the count: a
segment-free launch computes every ``s_q x s_kv`` pair (padded keys are
masked by the bias, not skipped), a K4 launch the ``TILE_ROWS x
stream_rows`` pairs of each tile pair it does not skip
(:meth:`Segments.computed_tiles`).
"""

import ctypes

import numpy as np
import torch

from ..telemetry import step_costs
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
# The kernels' tiles: a CTA owns TILE_ROWS rows (q in fwd and dq, kv in
# dkv) and streams the other side in tiles of stream_rows(head_dim) rows
# (tile_n<D>() in csrc/flash_attention.cu).
TILE_ROWS = 64
# The interval of an all-padding tile: lo above every id, hi = -1.
_EMPTY_LO = 2**30


def stream_rows(head_dim):
  return 32 if head_dim == 128 else 64


# Kernel launches by name; each wrapper adds one where it launches, nowhere
# else. A replayed CUDA graph runs no wrapper: the step cache adds the
# launches it recorded at capture instead (training/pretrain.py).
launches = {'fwd': 0, 'dq': 0, 'dkv': 0, 'fwd_seg': 0, 'dq_seg': 0,
            'dkv_seg': 0}


def reset_launches():
  """Zero :data:`launches`, and the device's counts if the kernels are
  loaded."""
  for name in launches:
    launches[name] = 0
  if _build.loaded():
    _build.launch('lddl_flash_reset_launches')


def device_launches():
  """Launches by name as the kernels counted them on the current CUDA
  device (replays of a CUDA graph included) since the library was loaded
  or :func:`reset_launches`; waits for the device. chip_smoke.py reads
  these to show the main path ran the kernels."""
  out = (ctypes.c_ulonglong * len(launches))()
  _build.launch('lddl_flash_launches', out)
  # The slots' order in csrc/flash_attention.cu (enum Kind, then kSeg).
  return dict(zip(('fwd', 'dq', 'dkv', 'fwd_seg', 'dq_seg', 'dkv_seg'),
                  map(int, out)))


# ---- each launch's work ----


def work(name, b, h, s, d, dtype, pairs, seg=False, s_kv=None):
  """(FLOPs, bytes) of one ``name`` launch (``fwd``, ``dq`` or ``dkv``)
  over ``[b * h, s, d]`` q (and ``[b * h, s_kv, d]`` k and v; default
  ``s``): products over the ``pairs`` (query, key) pairs of one head
  computed (summed over the batch rows), each input read once and each
  output written once; ``seg`` adds the q and kv int32 ids to the
  bias."""
  s_kv = s if s_kv is None else s_kv
  elt = torch.finfo(dtype).bits // 8
  q_mat = b * h * s * d * elt      # one [bh, s, d] tensor (q, out, dO, dq)
  kv_mat = b * h * s_kv * d * elt  # one [bh, s_kv, d] tensor (k, v, dk, dv)
  row = b * h * s * 4              # one [bh, s] float32 tensor (lse, delta)
  bias = b * s_kv * 4 + (b * (s + s_kv) * 4 if seg else 0)
  products = {'fwd': 2, 'dq': 3, 'dkv': 4}[name]  # matmuls of s x s x d
  flops = 2 * products * h * pairs * d
  moved = {'fwd': 2 * q_mat + 2 * kv_mat + row + bias,
           'dq': 3 * q_mat + 2 * kv_mat + 2 * row + bias,
           'dkv': 2 * q_mat + 4 * kv_mat + 2 * row + bias}[name]
  return flops, moved


def _bill(name, q, k, heads, seg, kv_owned=False):
  """Bill one launch of ``name`` on these inputs to the active step-cost
  counter (nothing when none is active). Called with the counter paused:
  the tile count's own ops are not the step's."""
  if step_costs.active() is None:
    return
  bh, s_q, d = q.shape
  s_kv = k.shape[1]
  if seg is None:
    pairs = bh // heads * s_q * s_kv
  else:
    pairs = seg.computed_tiles(d, kv_owned) * TILE_ROWS * stream_rows(d)
  step_costs.bill(*work(name, bh // heads, heads, s_q, d, q.dtype, pairs,
                        seg is not None, s_kv), seg=seg is not None,
                  kv_owned=kv_owned)


# ---- plain PyTorch versions (CPU path and the on-card reference) ----


def _scores(q, k, bias, heads, qseg=None, kvseg=None):
  """f32 ``scale * q k^T + bias`` over the whole ``[bh, s_q, s_kv]``, plus
  the same-document bias (0 or ``NEG_INF``) when segment ids are given."""
  scale = 1.0 / q.shape[-1] ** 0.5
  s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
  s = s + bias.repeat_interleave(heads, dim=0)[:, None, :]
  if qseg is None:
    return s
  zero = torch.zeros((), dtype=torch.float32, device=q.device)
  same = torch.where(qseg[:, :, None] == kvseg[:, None, :], zero, NEG_INF)
  bh, s_q, s_kv = s.shape
  return (s.view(bh // heads, heads, s_q, s_kv) + same[:, None]).view(
      bh, s_q, s_kv)


def _fwd_plain(q, k, v, bias, heads, qseg=None, kvseg=None):
  s = _scores(q, k, bias, heads, qseg, kvseg)
  # The kernels' running max starts at NEG_INF.
  m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
  p = torch.exp(s - m)
  l = p.sum(dim=-1, keepdim=True).clamp_min(_L_FLOOR)
  out = torch.matmul(p, v.float()) / l
  return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _dq_plain(q, k, v, bias, dout, lse, delta, heads, qseg=None, kvseg=None):
  scale = 1.0 / q.shape[-1] ** 0.5
  p = torch.exp(_scores(q, k, bias, heads, qseg, kvseg) - lse[..., None])
  dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
  ds = p * (dp - delta[..., None])
  return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def _dkv_plain(q, k, v, bias, dout, lse, delta, heads, qseg=None,
               kvseg=None):
  scale = 1.0 / q.shape[-1] ** 0.5
  s = _scores(q, k, bias, heads, qseg, kvseg) - lse[..., None]
  p = torch.exp(torch.clamp_max(s, _EXP_CLAMP))
  dv = torch.matmul(p.transpose(1, 2), dout.float())
  dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
  ds = p * (dp - delta[..., None])
  dk = torch.matmul(ds.transpose(1, 2), q.float()) * scale
  return dk.to(q.dtype), dv.to(q.dtype)


# ---- segment tiles ----


def _tile_intervals(seg, rows):
  """``[b, n_tiles, 2]`` int32 ``(lo, hi)`` id interval of each ``rows``-row
  tile of int32 ``seg`` ``[b, s]`` (JAX ``_seg_interval``). Padding (-1)
  is left out of ``lo`` and, being below every id, drops out of ``hi``;
  the ragged last tile is filled with padding. A tile of padding only gets
  ``(2**30, -1)``, disjoint from every tile."""
  b, s = seg.shape
  if s % rows:
    seg = torch.nn.functional.pad(seg, (0, rows - s % rows), value=-1)
  tiles = seg.view(b, -1, rows)
  lo = torch.where(tiles < 0, _EMPTY_LO, tiles).amin(dim=2)
  return torch.stack((lo, tiles.amax(dim=2)), dim=2)


def segment_block_intervals(segment_ids, block):
  """Per-block ``(lo, hi)`` id intervals of a ``[b, s]`` id array, as
  numpy arrays ``[b, n_blocks]`` (JAX ``segment_block_intervals``): the
  host-side mirror of the intervals the kernels test."""
  iv = _tile_intervals(torch.from_numpy(np.asarray(segment_ids, np.int32)),
                       block)
  return iv[..., 0].numpy(), iv[..., 1].numpy()


def _live_tiles(q_ids, kv_ids, q_rows, kv_rows):
  """(total, computed) tile pairs of numpy ``q_ids`` [b, s_q] against
  ``kv_ids`` [b, s_kv] at ``q_rows`` x ``kv_rows`` tiles: the kernels'
  interval test."""
  qlo, qhi = segment_block_intervals(q_ids, q_rows)
  klo, khi = segment_block_intervals(kv_ids, kv_rows)
  live = ((qlo[:, :, None] <= khi[:, None, :]) &
          (klo[:, None, :] <= qhi[:, :, None]))
  return int(live.size), int(live.sum())


def count_skippable_tiles(segment_ids, block_q=None, block_k=None,
                          head_dim=64):
  """``(total, skipped)`` tile counts of the forward grid for a ``[b, s]``
  segment-id batch under the kernels' interval test (JAX
  ``count_skippable_tiles``). The defaults are the CUDA tiles at
  ``head_dim``: ``TILE_ROWS`` q rows owned, ``stream_rows(head_dim)`` kv
  rows streamed, so the count is what the CUDA grid skips per head (the
  fraction is the same for every head, and for dq and, by symmetry of
  self-attention, dk/dv)."""
  block_q = TILE_ROWS if block_q is None else block_q
  block_k = stream_rows(head_dim) if block_k is None else block_k
  total, live = _live_tiles(segment_ids, segment_ids, block_q, block_k)
  return total, total - live


def ring_tiles(segment_ids, head_dim=64, seq_rank=0, seq=1):
  """``(total, computed, kv_computed)`` tile pairs of one head that a
  packed batch's K4 launches test and compute on seq rank ``seq_rank`` of
  ``seq``, from the host ids of the rank's whole rows (``[b, s]``): its
  ``1 / seq`` of the columns as q against every shard's columns as kv,
  the ring's blocks (one block, self-attention, at ``seq`` 1). ``total``
  and ``computed`` are at the grid of fwd and dq (``TILE_ROWS`` q rows
  owned, ``stream_rows(head_dim)`` kv rows streamed; :func:`
  count_skippable_tiles`' at ``seq`` 1), ``kv_computed`` at dkv's (kv
  owned), so the step's K4 FLOPs are linear in the two counts."""
  ids = np.asarray(segment_ids, np.int32)
  per = ids.shape[1] // seq
  q = ids[:, seq_rank * per:(seq_rank + 1) * per]
  own, stream = TILE_ROWS, stream_rows(head_dim)
  total = computed = kv_computed = 0
  for j in range(seq):
    kv = ids[:, j * per:(j + 1) * per]
    n, live = _live_tiles(q, kv, own, stream)
    total += n
    computed += live
    kv_computed += _live_tiles(q, kv, stream, own)[1]
  return total, computed, kv_computed


class Segments:
  """The segment ids of one attention call, shared by its three kernels:
  int32 ``q`` ``[b, s_q]`` and ``kv`` ``[b, s_kv]`` document ids (-1 on
  padding) and, computed at first use and kept, their tile intervals at
  the widths the kernels tile with. Built once per call, so the interval
  ops run once and not before every launch (for self-attention ``q is
  kv`` and one set serves both sides)."""

  def __init__(self, q, kv):
    self.q, self.kv = q, kv
    self._intervals = {}

  def _tiles(self, ids, rows):
    key = (id(ids), rows)
    if key not in self._intervals:
      self._intervals[key] = _tile_intervals(ids, rows)
    return self._intervals[key]

  def launch_args(self, head_dim, kv_owned=False):
    """A K4 launcher's segment arguments: the q and kv ids, then the q and
    kv tile intervals, the side a CTA owns at ``TILE_ROWS`` rows and the
    side it streams at ``stream_rows(head_dim)`` (fwd and dq own q, dkv
    owns kv)."""
    own, stream = TILE_ROWS, stream_rows(head_dim)
    q_rows, kv_rows = (stream, own) if kv_owned else (own, stream)
    return (self.q, self.kv, self._tiles(self.q, q_rows),
            self._tiles(self.kv, kv_rows))

  def computed_tiles(self, head_dim, kv_owned=False):
    """The (owned, streamed) tile pairs a K4 launch computes over all rows
    of the batch, per head: those whose id intervals meet (a host
    read)."""
    _, _, qi, ki = self.launch_args(head_dim, kv_owned)
    live = ((qi[:, :, None, 0] <= ki[:, None, :, 1]) &
            (ki[:, None, :, 0] <= qi[:, :, None, 1]))
    return int(live.sum())


def _ids(seg):
  """The plain versions' segment arguments: (q ids, kv ids) or ()."""
  return () if seg is None else (seg.q, seg.kv)


# ---- kernel wrappers ----


def _check(q, k, v, bias, heads, *rows, seg=None):
  """Raise on anything the CUDA kernels do not take. ``seg``: the call's
  :class:`Segments`, or None for the segment-free kernels."""
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
  if seg is not None:
    for ids, s in zip(_ids(seg), (s_q, s_kv)):
      if ids.dtype != torch.int32 or tuple(ids.shape) != (bh // heads, s):
        raise ValueError(f'segment ids must be int32 [{bh // heads}, {s}]; '
                         f'got {ids.dtype} {tuple(ids.shape)}')
    rows += _ids(seg)
  tensors = (q, k, v, bias) + rows
  for t in tensors:
    if t.device != q.device:
      raise ValueError('all inputs must be on one device')
    if not t.is_contiguous():
      raise ValueError('kernel inputs must be contiguous')
    if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
      # The bf16 bodies copy rows in 16-byte cp.async chunks.
      raise ValueError('bf16 kernel inputs must start 16-byte aligned')


def _use_kernel(q):
  """'cpu' -> plain path, 'cuda' -> kernel; any other device raises."""
  if q.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'flash attention runs on cuda (kernels) or cpu (plain '
                     f'reference); got device {q.device}')
  return q.device.type == 'cuda'


def _launch(name, heads, q, k, v, bias, *rest, seg=()):
  """Launch ``lddl_flash_<name>`` on (q, k, v, bias, *rest), in the C
  launcher's order, on the current stream and count it; with ``seg`` (see
  :meth:`Segments.launch_args`) the K4 launcher ``lddl_flash_<name>_seg``,
  which takes the segment inputs after the bias."""
  if seg:
    name += '_seg'
  tensors = (q, k, v, bias, *seg, *rest)
  bh, s_q, d = q.shape
  with torch.cuda.device(q.device):
    _build.launch(f'lddl_flash_{name}', *(t.data_ptr() for t in tensors),
                  bh, heads, s_q, k.shape[1], d,
                  int(q.dtype == torch.bfloat16), 1.0 / d ** 0.5,
                  torch.cuda.current_stream().cuda_stream)
  launches[name] += 1


def _fwd(q, k, v, bias, heads, seg=None):
  with step_costs.uncounted():
    _bill('fwd', q, k, heads, seg)
    if not _use_kernel(q):
      return _fwd_plain(q, k, v, bias, heads, *_ids(seg))
    _check(q, k, v, bias, heads, seg=seg)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch('fwd', heads, q, k, v, bias, out, lse,
            seg=() if seg is None else seg.launch_args(q.shape[-1]))
  return out, lse


def _dq(q, k, v, bias, dout, lse, delta, heads, seg=None):
  with step_costs.uncounted():
    _bill('dq', q, k, heads, seg)
    if not _use_kernel(q):
      return _dq_plain(q, k, v, bias, dout, lse, delta, heads, *_ids(seg))
    _check(q, k, v, bias, heads, dout, lse, delta, seg=seg)
    dq = torch.empty_like(q)
    _launch('dq', heads, q, k, v, bias, dout, lse, delta, dq,
            seg=() if seg is None else seg.launch_args(q.shape[-1]))
  return dq


def _dkv(q, k, v, bias, dout, lse, delta, heads, seg=None):
  with step_costs.uncounted():
    _bill('dkv', q, k, heads, seg, kv_owned=True)
    if not _use_kernel(q):
      return _dkv_plain(q, k, v, bias, dout, lse, delta, heads, *_ids(seg))
    _check(q, k, v, bias, heads, dout, lse, delta, seg=seg)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch('dkv', heads, q, k, v, bias, dout, lse, delta, dk, dv,
            seg=() if seg is None else seg.launch_args(q.shape[-1],
                                                       kv_owned=True))
  return dk, dv


def _backward_rows(g, g_lse, out, q):
  """(dO in q.dtype, delta = rowsum(dO * O) - g_lse in float32)."""
  g = g.to(q.dtype).contiguous()
  delta = (g.float() * out.float()).sum(dim=-1) - g_lse.float()
  return g, delta.contiguous()


class _FlashPair(torch.autograd.Function):
  """``(out, lse)`` of ``[bh, s, d]`` inputs, differentiable in both.
  ``seg``: the call's :class:`Segments`, or None."""

  @staticmethod
  def forward(ctx, q, k, v, bias, heads, seg):
    out, lse = _fwd(q, k, v, bias, heads, seg)
    ctx.save_for_backward(q, k, v, bias, out, lse)
    ctx.heads, ctx.seg = heads, seg
    return out, lse

  @staticmethod
  def backward(ctx, g, g_lse):
    q, k, v, bias, out, lse = ctx.saved_tensors
    g, delta = _backward_rows(g, g_lse, out, q)
    dq = _dq(q, k, v, bias, g, lse, delta, ctx.heads, ctx.seg)
    dk, dv = _dkv(q, k, v, bias, g, lse, delta, ctx.heads, ctx.seg)
    return dq, dk, dv, None, None, None


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
  if (q_segment_ids is None) != (kv_segment_ids is None):
    raise ValueError('q_segment_ids and kv_segment_ids must be given '
                     'together (self-attention passes the same array)')
  b, h, s_q, d = q.shape
  s_kv = k.shape[2]
  bias = key_bias(attention_mask, b, s_kv, q.device)
  seg = None
  if q_segment_ids is not None:
    qseg = _segment_rows(q_segment_ids, b, s_q, q.device)
    seg = Segments(qseg, qseg if kv_segment_ids is q_segment_ids else
                   _segment_rows(kv_segment_ids, b, s_kv, q.device))
  out, lse = _FlashPair.apply(q.reshape(b * h, s_q, d).contiguous(),
                              k.reshape(b * h, s_kv, d).contiguous(),
                              v.reshape(b * h, s_kv, d).contiguous(), bias, h,
                              seg)
  return out.view(b, h, s_q, d), lse.view(b, h, s_q)


def _segment_rows(segment_ids, batch, s, device):
  """int ``[batch, s]`` doc ids -> the kernels' contiguous int32 rows."""
  if tuple(segment_ids.shape) != (batch, s):
    raise ValueError(f'segment ids must be [{batch}, {s}]; got '
                     f'{tuple(segment_ids.shape)}')
  return segment_ids.to(device=device, dtype=torch.int32).contiguous()


def flash_attention(q, k, v, attention_mask=None, q_segment_ids=None,
                    kv_segment_ids=None):
  """Blockwise-softmax attention; drop-in for the dense path.

  ``q, k, v``: ``[batch, heads, seq, head_dim]`` in float32 or bfloat16;
  ``attention_mask``: ``[batch, seq]`` with 1 = attend, 0 = padding (key
  side). Optional ``q_segment_ids``/``kv_segment_ids`` ``[batch, seq]``
  int (doc index per token, -1 = padding), given together, restrict
  attention to same-document pairs through the segmented kernels. Returns
  the context ``[batch, heads, seq, head_dim]`` in the input dtype.
  """
  return flash_attention_with_lse(q, k, v, attention_mask, q_segment_ids,
                                  kv_segment_ids)[0]


def make_flash_attention(mesh, with_segment_ids=False):
  """:func:`flash_attention` over a mesh, as
  :func:`lddl_tpu.ops.flash_attention.make_flash_attention`: batch over
  (data, fsdp), heads over tensor. The JAX function wraps its kernel in
  ``shard_map``; here a rank already holds only its shards (its rows of
  the batch and, with tensor parallelism, its ``num_heads / tensor``
  heads), so the returned function checks that the arrays agree with each
  other and runs the kernels on them, one launch of each per call as
  without a mesh. The sequence axis is not sharded: a mesh with ``seq``
  above 1 raises ``ValueError``, as in the JAX package.

  The function takes ``(q, k, v, mask)``, or with ``with_segment_ids``
  also ``segment_ids`` ``[batch, seq]`` (self-attention: the same ids for
  q and kv).
  """
  from ..parallel.mesh import axis_size
  if axis_size(mesh, 'seq') > 1:
    raise ValueError(
        "flash attention does not shard the sequence axis; use "
        "attention_impl='ring_flash' on meshes with seq > 1")

  def sharded(q, k, v, mask, *segment_ids):
    if len(segment_ids) != int(with_segment_ids):
      raise TypeError(f'with_segment_ids={with_segment_ids}: takes '
                      f'{4 + int(with_segment_ids)} arrays, got '
                      f'{4 + len(segment_ids)}')
    b, s = q.shape[0], q.shape[2]
    for name, t in (('mask', mask), *(('segment_ids', x) for x in
                                      segment_ids)):
      if tuple(t.shape) != (b, s):
        raise ValueError(f'{name} {tuple(t.shape)} does not match this '
                         f"rank's q {tuple(q.shape)} (rows [{b}, {s}])")
    seg = segment_ids[0] if segment_ids else None
    return flash_attention(q, k, v, mask, seg, seg)

  return sharded
