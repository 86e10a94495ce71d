#!/usr/bin/env python3
"""Drive lddl_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--steps N] [--warmup N]

Phases, each of which raises on failure (the script then exits non-zero):

  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from lddl_tpu_torch/csrc (nvcc, sm_90a) and
     report each kernel's registers and spills (none allowed in the
     tensor-core bodies at head_dim 64);
  3. hold each kernel (flash fwd, dq, dkv) against its plain PyTorch
     version on the card, in float32 (TF32 off) and bfloat16, at the
     shapes the training phase gives them plus a ragged and a d=32 case;
     check that two launches are bitwise equal; time kernel, plain version
     and PyTorch's scaled_dot_product_attention on its memory-efficient
     backend (a yardstick only, never called by the port) with CUDA
     events, beside the least time the card could take for the same work;
     every bf16 kernel runs the tensor-core (mma.sync) body, every float32
     one the CUDA-core body, and each row says which;
  4. the same for the segmented kernels (K4: block-diagonal packed
     attention) on ragged packed rows, out and lse compared on real rows,
     cotangents zero on padding rows; also time the segment-free kernel
     on the same inputs and require the segmented one to take at most
     half its time wherever 80% or more of the tiles skip, and check that
     a row of padding only gives out = 0 and a finite lse;
  5. train BERT-base at full width (hidden 768, 12 layers, 12 heads, FFN
     3072, vocab 30528, bf16, attention_impl='flash') through
     TrainLoop.run on loader-format batches made in numpy from --seed, in
     two bins (seq 128 x batch 64, seq 512 x batch 16) fed by
     prefetch_to_device; check finite losses and 12 launches of each
     kernel per step; check one step against dense attention from the
     same weights; save, restore and check the resumed losses;
  6. packed long-context training: the same model with 8192 positions at
     seq 8192 x batch 2, rows of 12-16 documents packed as
     preprocess/packed.py writes them and collated by PackedCollate
     (block_diagonal=True), dynamic masking, masked-only head of 1359
     predictions; check finite losses and 12 launches per step of each
     segmented kernel (none of the segment-free ones), profile, check one
     packed s=2048 step against dense attention, and save, restore and
     resume bit for bit.

The last lines are the kernels' JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits non-zero before printing any result.
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# Deterministic cuBLAS workspaces (read at the first cuBLAS call), so the
# save/restore check can compare losses bit for bit.
os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
VOCAB_FILE = os.path.join(HERE, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
DEVICE = 'cuda'
MODEL = 'base'
PAD, CLS, SEP, MASK = 0, 2, 3, 4
VOCAB_REAL = 30522
BINS = ((128, 64), (512, 16))  # (seq_len, batch)
# Segment-free kernel cases beside the bins' shapes: a ragged length and
# the other two head dims, (batch, heads, seq, head_dim).
EXTRA_CASES = ((8, 12, 200, 64), (8, 8, 256, 32), (4, 8, 256, 128))
# Packed long-context training (seq_len, batch, max_predictions: the
# dynamic-masking budget check_max_predictions gives for s=8192, as
# examples/long_context_example.sh uses), and the packed bin of its
# flash-vs-dense step (dense at 8192 would hold ~77 GB of scores).
PACKED = (8192, 2, 1359)
PACKED_DENSE = (2048, 2)
# Documents per packed row at s=8192 (Wikipedia-article-sized, median
# ~500 tokens); a shorter bin packs proportionally fewer.
PACKED_DOCS = (12, 16)
# Segmented-kernel cases: (batch, heads, seq, head_dim, dtype, documents
# per row, padded tail, last row padding only). The first is the packed
# phase's shape.
SEG_CASES = (
    (2, 12, 8192, 64, torch.bfloat16, 16, True, False),
    (2, 12, 2048, 64, torch.float32, 4, True, False),
    (2, 8, 1024, 32, torch.float32, 8, True, False),
    (2, 8, 1024, 32, torch.bfloat16, 8, True, False),
    (2, 8, 1024, 128, torch.float32, 8, True, False),
    (2, 8, 1024, 128, torch.bfloat16, 8, True, False),
    (2, 12, 2048, 64, torch.bfloat16, 1, False, False),  # nothing skips
    (2, 12, 4096, 64, torch.float32, 16, True, True),
    (2, 12, 4096, 64, torch.bfloat16, 16, True, True),
)
# Where at least this share of tiles skips, the segmented kernel must take
# at most SKIP_SPEEDUP_MAX of the segment-free kernel's time on the same
# inputs: the skip is an early-out, not masked compute.
SKIP_CHECK_FRACTION, SKIP_SPEEDUP_MAX = 0.8, 0.5
KERNEL_SOURCE = 'lddl_tpu_torch/csrc/flash_attention.cu'
TPU_KERNELS = {
    'fwd': 'lddl_tpu/ops/flash_attention.py:166',
    'dq': 'lddl_tpu/ops/flash_attention.py:210',
    'dkv': 'lddl_tpu/ops/flash_attention.py:248',
    # The same bodies with segment refs: the pl.when(_tile_live) skip.
    'fwd_seg': 'lddl_tpu/ops/flash_attention.py:201',
    'dq_seg': 'lddl_tpu/ops/flash_attention.py:241',
    'dkv_seg': 'lddl_tpu/ops/flash_attention.py:286',
}
# Which body a kernel runs (csrc/flash_attention.cu): every bf16 kernel on
# the tensor cores, every float32 one on the CUDA cores.
MMA_BODY, F32_BODY = 'mma.sync bf16', 'cuda-core f32'


def body(dtype):
  return MMA_BODY if dtype == torch.bfloat16 else F32_BODY


# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Kernel vs plain version: float32 as the CPU parity tests (the kernels
# sum in another order than cuBLAS); bfloat16 outputs round to 8 bits of
# mantissa on both sides, 3e-2 as tests/test_flash_attention.py.
TOL = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (3e-2, 3e-2)}
# One full-width step, flash vs dense attention from the same weights:
# both round attention to bf16 at different points; 12 layers compound it.
DENSE_LOSS_RTOL, DENSE_GRAD_NORM_RTOL = 1e-2, 5e-2


def log(*args):
  print(*args, flush=True)


def card_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
  """Median milliseconds of ``fn`` by CUDA events, one event pair per rep."""
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


# ---- phase 2: the build's register report ----


def ptxas_report(text):
  """Registers and spills of every kernel instantiation from nvcc's
  ``-Xptxas -v`` log, logged one line each. Raises if a tensor-core body
  at head_dim 64 (BERT-base, the main path) spills. Returns {(name, body):
  {'registers': n, 'spill_bytes': n}} for the tensor-core (bf16) head_dim-64
  instantiations, the ones the main path runs."""
  kernels, key = {}, None
  for line in text.splitlines():
    entry = re.search(r"Compiling entry function '(\S+)'", line)
    if entry:
      m = re.search(r'flash_(fwd|dq|dkv)(_mma)?_kernelILi(\d+)ELb([01])E',
                    entry.group(1))
      key = None if m is None else (
          m.group(1) + ('_seg' if m.group(4) == '1' else ''),
          MMA_BODY if m.group(2) else F32_BODY, int(m.group(3)))
      if key is not None:
        kernels[key] = {'registers': None, 'spill_bytes': 0}
      continue
    if key is None:
      continue
    spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
    if spill:
      kernels[key]['spill_bytes'] = int(spill.group(1)) + int(spill.group(2))
    regs = re.search(r'Used (\d+) registers', line)
    if regs:
      kernels[key]['registers'] = int(regs.group(1))
  for (name, kind, d), r in sorted(kernels.items()):
    log(f'    {name:8s} {kind:14s} d={d:3d}: {r["registers"]} registers, '
        f'{r["spill_bytes"]} bytes spilled')
    if kind == MMA_BODY and d == 64 and r['spill_bytes']:
      raise AssertionError(f'{name} ({kind}, d=64) spills '
                           f'{r["spill_bytes"]} bytes')
  return {(name, kind): r for (name, kind, d), r in kernels.items()
          if kind == MMA_BODY and d == 64}


# ---- phase 3: kernels vs plain versions ----


def attention_inputs(b, h, s, d, dtype, seed):
  g = torch.Generator(device=DEVICE).manual_seed(seed)
  shape = (b * h, s, d)
  q, k, v, do = (torch.randn(shape, generator=g, device=DEVICE).to(dtype)
                 for _ in range(4))
  g_lse = torch.randn((b * h, s), generator=g, device=DEVICE)
  lens = torch.randint(s // 2, s + 1, (b,), generator=g, device=DEVICE)
  mask = torch.arange(s, device=DEVICE)[None, :] < lens[:, None]
  return q, k, v, do, g_lse, mask


def work(name, b, h, s, d, dtype, pairs, seg=False):
  """(FLOPs, bytes) the function needs on these inputs: products over the
  ``pairs`` (query, key) pairs of one head that take part (attended keys,
  and same-document ones with segment ids: a kernel could skip the
  rest), each input read once and each output written once."""
  elt = torch.finfo(dtype).bits // 8
  mat = b * h * s * d * elt      # one [bh, s, d] tensor
  row = b * h * s * 4            # one [bh, s] float32 tensor
  bias = b * s * 4 * (3 if seg else 1)  # key bias (+ q and kv int32 ids)
  products = {'fwd': 2, 'dq': 3, 'dkv': 4}[name]  # matmuls of s x s x d
  flops = 2 * products * h * pairs * d
  moved = {'fwd': 4 * mat + row + bias,
           'dq': 5 * mat + 2 * row + bias,
           'dkv': 6 * mat + 2 * row + bias}[name]
  return flops, moved


def bound(flops, moved, dtype):
  """(ms, 'operations' or 'bytes'): the least time the card could take."""
  t_flops, t_bytes = flops / PEAK_FLOPS[dtype], moved / PEAK_BYTES
  return 1e3 * max(t_flops, t_bytes), (
      'operations' if t_flops >= t_bytes else 'bytes')


def compare(label, kernel, plain, tol, rows=None):
  """Launch ``kernel`` twice and ``plain`` once on the same inputs: the two
  launches must be bitwise equal and the kernel within ``tol`` of the
  plain version (on ``rows`` of each output only, where given). Returns
  the largest absolute difference."""
  got, again, ref = kernel(), kernel(), plain()
  torch.cuda.synchronize()
  got, again, ref = ((t,) if torch.is_tensor(t) else t
                     for t in (got, again, ref))
  if not all(torch.equal(a, c) for a, c in zip(got, again)):
    raise AssertionError(f'{label}: two launches on the same inputs differ')
  err = 0.0
  for a, r in zip(got, ref):
    if rows is not None:
      a, r = a[rows], r[rows]
    torch.testing.assert_close(a.float(), r.float(), rtol=tol, atol=tol)
    err = max(err, float((a.float() - r.float()).abs().max()))
  return err


def sdpa_ms(q, k, v, g, attn_mask, shape):
  """Yardstick, never called by the port: milliseconds of PyTorch's
  scaled_dot_product_attention with the equivalent additive mask, forward
  (against fwd) and backward, dq, dk and dv together (against dq and
  dkv), pinned to the memory-efficient backend, the fused one that takes
  an additive mask, so that every call times the same kernels."""
  import torch.nn.functional as F
  from torch.nn.attention import SDPBackend, sdpa_kernel
  q4, k4, v4 = (t.view(shape).detach().requires_grad_() for t in (q, k, v))
  with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
    out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask)
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=attn_mask))
    bwd = cuda_ms(lambda: torch.autograd.grad(
        out, (q4, k4, v4), g.view(shape), retain_graph=True))
  return {'fwd': fwd, 'dq': bwd, 'dkv': bwd}


def check_kernels(tfa, cases, seed):
  """Every case: kernel vs plain, repeatability, timings. Returns the
  rows for the report."""
  rows = []
  for (b, h, s, d, dtype) in cases:
    q, k, v, do, g_lse, mask = attention_inputs(b, h, s, d, dtype, seed)
    bias = tfa.key_bias(mask, b, s, q.device)
    out, lse = tfa._fwd(q, k, v, bias, h)
    g, delta = tfa._backward_rows(do, g_lse, out, q)
    results = {
        'fwd': ((lambda: tfa._fwd(q, k, v, bias, h)),
                (lambda: tfa._fwd_plain(q, k, v, bias, h))),
        'dq': ((lambda: tfa._dq(q, k, v, bias, g, lse, delta, h)),
               (lambda: tfa._dq_plain(q, k, v, bias, g, lse, delta, h))),
        'dkv': ((lambda: tfa._dkv(q, k, v, bias, g, lse, delta, h)),
                (lambda: tfa._dkv_plain(q, k, v, bias, g, lse, delta, h))),
    }
    library = sdpa_ms(q, k, v, g, bias.to(dtype)[:, None, None, :],
                      (b, h, s, d))
    fwd_tol, grad_tol = TOL[dtype]
    for name, (kernel, plain) in results.items():
      tol = fwd_tol if name == 'fwd' else grad_tol
      err = compare(f'{name} {(b, h, s, d, dtype)}', kernel, plain, tol)
      bound_ms, bound_by = bound(
          *work(name, b, h, s, d, dtype, s * int(mask.sum())), dtype)
      rows.append({
          'name': name, 'shape': [b, h, s, d], 'dtype': str(dtype),
          'body': body(dtype), 'max_abs_err': err, 'tol': tol,
          'ms': cuda_ms(kernel), 'plain_ms': cuda_ms(plain),
          'library_ms': library[name],
          'bound_ms': bound_ms, 'bound_by': bound_by})
      r = rows[-1]
      log(f'  {name:3s} b={b:2d} h={h:2d} s={s:3d} d={d:3d} '
          f'{str(dtype):14s} [{r["body"]}] err={err:.3g} (tol {tol:g}) '
          f'bitwise-repeat=ok '
          f'kernel={r["ms"]:.3f}ms plain={r["plain_ms"]:.3f}ms '
          f'sdpa={r["library_ms"]:.3f}ms bound={r["bound_ms"]:.4f}ms '
          f'({r["bound_by"]}, {100 * r["bound_ms"] / r["ms"]:.1f}% of bound)')
  return rows


# ---- phase 4: segmented kernels (K4) vs plain versions ----


def segment_layout(b, s, docs, pad_tail, pad_row, rng):
  """``[b, s]`` int32 document ids: ``docs`` documents per row at random
  (so not tile-aligned) boundaries, a padded tail of up to a quarter of
  the row (-1), and the last row padding only if ``pad_row``."""
  seg = np.full((b, s), -1, np.int32)
  for r in range(b - 1 if pad_row else b):
    total = int(rng.integers(s * 3 // 4, s)) if pad_tail else s
    cuts = np.sort(rng.choice(np.arange(1, total), docs - 1, replace=False))
    seg[r, :total] = np.searchsorted(cuts, np.arange(total), side='right')
  return seg


def same_doc_pairs(seg):
  """(query, key) pairs of real tokens in the same document, summed over
  the rows of a ``[b, s]`` id array."""
  return int(sum((np.bincount(r[r >= 0]) ** 2).sum() for r in seg))


def check_seg_kernels(tfa, cases, seed):
  """Every case: segmented kernel vs plain on real rows (grads
  everywhere, with cotangents zero on padding rows as the model gives
  them), repeatability, the all-padding row, timings against the plain
  version, the segment-free kernel and SDPA, and the skip check."""
  rows = []
  for (b, h, s, d, dtype, docs, pad_tail, pad_row) in cases:
    rng = np.random.default_rng([seed, b, s, d, docs])
    seg_np = segment_layout(b, s, docs, pad_tail, pad_row, rng)
    q, k, v, do, g_lse, _ = attention_inputs(b, h, s, d, dtype, seed)
    seg = torch.from_numpy(seg_np).to(DEVICE)
    mask = seg >= 0
    real = mask.repeat_interleave(h, dim=0)  # [bh, s]: rows with an id
    do = torch.where(real[..., None], do, torch.zeros((), dtype=dtype,
                                                      device=DEVICE))
    g_lse = torch.where(real, g_lse, 0.0)
    bias = tfa.key_bias(mask, b, s, q.device)

    def intervals():
      # What an attention call computes once for its three kernels.
      segs = tfa.Segments(seg, seg)
      segs.launch_args(d)
      segs.launch_args(d, kv_owned=True)
      return segs

    segs = intervals()
    intervals_ms = cuda_ms(intervals)
    out, lse = tfa._fwd(q, k, v, bias, h, segs)
    g, delta = tfa._backward_rows(do, g_lse, out, q)
    calls = {
        'fwd': ((lambda: tfa._fwd(q, k, v, bias, h, segs)),
                (lambda: tfa._fwd_plain(q, k, v, bias, h, seg, seg)),
                (lambda: tfa._fwd(q, k, v, bias, h))),
        'dq': ((lambda: tfa._dq(q, k, v, bias, g, lse, delta, h, segs)),
               (lambda: tfa._dq_plain(q, k, v, bias, g, lse, delta, h, seg,
                                      seg)),
               (lambda: tfa._dq(q, k, v, bias, g, lse, delta, h))),
        'dkv': ((lambda: tfa._dkv(q, k, v, bias, g, lse, delta, h, segs)),
                (lambda: tfa._dkv_plain(q, k, v, bias, g, lse, delta, h, seg,
                                        seg)),
                (lambda: tfa._dkv(q, k, v, bias, g, lse, delta, h))),
    }
    if pad_row:
      pad = slice((b - 1) * h, b * h)
      if not (bool((out[pad] == 0).all()) and
              bool(torch.isfinite(lse[pad]).all())):
        raise AssertionError(f'{(b, h, s, d, dtype)}: the all-padding row '
                             'gives a nonzero out or a non-finite lse')
    zero = torch.zeros((), dtype=torch.float32, device=DEVICE)
    same = torch.where(seg[:, :, None] == seg[:, None, :], zero, tfa.NEG_INF)
    library = sdpa_ms(q, k, v, g, (bias[:, None, :] + same)[:, None].to(dtype),
                      (b, h, s, d))
    del same
    total, skipped = tfa.count_skippable_tiles(seg_np, head_dim=d)
    skip = skipped / total
    pairs = same_doc_pairs(seg_np)
    fwd_tol, grad_tol = TOL[dtype]
    for name, (kernel, plain, free) in calls.items():
      tol = fwd_tol if name == 'fwd' else grad_tol
      # out and lse on real rows only; the gradients everywhere.
      err = compare(f'{name}_seg {(b, h, s, d, dtype)}', kernel, plain, tol,
                    rows=real if name == 'fwd' else None)
      bound_ms, bound_by = bound(*work(name, b, h, s, d, dtype, pairs,
                                       seg=True), dtype)
      rows.append({
          'name': f'{name}_seg', 'shape': [b, h, s, d], 'dtype': str(dtype),
          'body': body(dtype), 'docs': docs, 'max_abs_err': err,
          'tol': tol,
          'skip_fraction': skip, 'ms': cuda_ms(kernel),
          'plain_ms': cuda_ms(plain, reps=5, warmup=1),
          'segment_free_ms': cuda_ms(free), 'intervals_ms': intervals_ms,
          'library_ms': library[name], 'bound_ms': bound_ms,
          'bound_by': bound_by})
      r = rows[-1]
      log(f'  {name:3s}_seg b={b} h={h:2d} s={s:4d} d={d:3d} docs={docs:2d} '
          f'{str(dtype):14s} [{r["body"]}] err={err:.3g} (tol {tol:g}) '
          f'bitwise-repeat=ok '
          f'skip={100 * skip:.1f}% kernel={r["ms"]:.3f}ms '
          f'segment-free={r["segment_free_ms"]:.3f}ms '
          f'plain={r["plain_ms"]:.3f}ms sdpa={r["library_ms"]:.3f}ms '
          f'bound={r["bound_ms"]:.4f}ms ({r["bound_by"]}, '
          f'{100 * r["bound_ms"] / r["ms"]:.2f}% of bound); tile intervals '
          f'{intervals_ms:.3f}ms once per call')
      if skip >= SKIP_CHECK_FRACTION and (
          r['ms'] > SKIP_SPEEDUP_MAX * r['segment_free_ms']):
        raise AssertionError(
            f'{name}_seg {(b, h, s, d, dtype)}: {100 * skip:.1f}% of tiles '
            f'skip but the kernel takes {r["ms"]:.3f} ms against the '
            f'segment-free {r["segment_free_ms"]:.3f} ms (limit '
            f'{SKIP_SPEEDUP_MAX}x): the skip is not an early-out')
    if pad_row:
      log('  all-padding row: out = 0, lse finite')
    del q, k, v, do, g, out, lse, delta, segs
  return rows


# ---- phase 5: training ----


def profile_steps(loop, loader, bin_stats, card, steps=2):
  """Device time by kernel over ``steps`` more steps of ``loader``
  (torch.profiler), per step; the idle share is against the unprofiled
  step time measured before."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  loop.loader = loader
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    loop.run(loop.step + steps, log_every=0)
    torch.cuda.synchronize()
  kernels = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
  busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
  step_ms = bin_stats['ms_per_step']
  top = sorted(kernels, key=lambda e: e.self_device_time_total,
               reverse=True)[:12]
  rows = [{'kernel': e.key[:90], 'ms_per_step':
           e.self_device_time_total / 1e3 / steps,
           'calls_per_step': e.count / steps} for e in top]

  def share(pred):
    return sum(e.self_device_time_total for e in kernels
               if pred(e.key)) / 1e3 / steps

  attn = share(lambda k: 'flash_' in k and '_kernel' in k)
  # cuBLAS's Hopper GEMMs are named nvjet_* / *gemm* / cutlass_*.
  gemm = share(lambda k: any(t in k for t in ('nvjet', 'gemm', 'cutlass')))
  log(f'  profile s={bin_stats["seq_len"]}: device busy {busy:.2f} ms of '
      f'{step_ms:.2f} ms/step (idle {100 * (1 - busy / step_ms):.1f}%): '
      f'flash kernels {attn:.2f} ms, GEMMs {gemm:.2f} ms, other '
      f'{busy - attn - gemm:.2f} ms [{card}]')
  for r in rows:
    log(f'    {r["ms_per_step"]:8.3f} ms  x{r["calls_per_step"]:<6g} '
        f'{r["kernel"]}')
  return {'device_busy_ms_per_step': busy, 'flash_ms_per_step': attn,
          'gemm_ms_per_step': gemm, 'top_kernels': rows}


class BinLoader:
  """Loader-format batches of one bin, made in numpy from a seed: ragged
  ``[CLS] A [SEP] B [SEP]`` rows, token types, dynamic 80/10/10 masks.
  Iterating yields the batches from ``start`` on."""

  def __init__(self, seq_len, batch_size, n, seed, mask_fn):
    self.batch_size = batch_size
    self.start = 0
    self.batches = [self._batch(seq_len, i, seed, mask_fn) for i in range(n)]

  def _batch(self, s, step, seed, mask_fn):
    b = self.batch_size
    rng = np.random.default_rng([seed, s, step])
    total = rng.integers(s // 2 + 1, s + 1, size=b)       # tokens per row
    na = rng.integers(1, total - 3, size=b, endpoint=True)  # A length
    cols = np.arange(s)[None, :]
    ids = rng.integers(MASK + 1, VOCAB_REAL, (b, s)).astype(np.int32)
    ids[:, 0] = CLS
    ids[np.arange(b), na + 1] = SEP
    ids[np.arange(b), total - 1] = SEP
    ids[cols >= total[:, None]] = PAD
    attention_mask = (cols < total[:, None]).astype(np.int32)
    special = (ids == PAD) | (ids == CLS) | (ids == SEP)
    ids, labels = mask_fn(ids, special, mlm_probability=0.15,
                          vocab_size=VOCAB_REAL, mask_id=MASK,
                          base_seed=seed, dp_rank=0, epoch=0, step=step)
    return {
        'input_ids': ids,
        'token_type_ids': ((cols >= (na + 2)[:, None]) &
                           (cols < total[:, None])).astype(np.int32),
        'attention_mask': attention_mask,
        'labels': labels,
        'next_sentence_labels': rng.integers(0, 2, b).astype(np.int32),
    }

  def __iter__(self):
    return iter(self.batches[self.start:])


class PackedLoader:
  """Packed block-diagonal batches of one bin: rows of ``[CLS] doc [SEP]
  doc [SEP] ...`` as preprocess/packed.py writes them (np.save-wire uint16
  ``input_ids`` and ``doc_offsets``), made in numpy from a seed and
  collated by the port's PackedCollate(block_diagonal=True) with dynamic
  masking. A row fills 3/4 to all of the bin (the rest is padding) with
  PACKED_DOCS documents per 8192 tokens, log-normal lengths. Iterating
  yields the batches from ``start`` on."""

  class Tokenizer:
    cls_token_id, sep_token_id, mask_token_id, pad_token_id = (CLS, SEP,
                                                               MASK, PAD)
    vocab_size = VOCAB_REAL

  def __init__(self, seq_len, batch_size, n, seed):
    from lddl_tpu_torch.loader.packed import PackedCollate
    self.batch_size = batch_size
    self.start = 0
    collate = PackedCollate(self.Tokenizer(), base_seed=seed,
                            block_diagonal=True)
    self.batches = [collate(self._rows(seq_len, i, seed), seq_len, epoch=0,
                            step=i) for i in range(n)]

  def _rows(self, s, step, seed):
    from lddl_tpu_torch.core.utils import serialize_np_array
    rng = np.random.default_rng([seed, s, step, 1])
    lo, hi = (max(1, round(n * s / 8192)) for n in PACKED_DOCS)
    rows = []
    for _ in range(self.batch_size):
      total = int(rng.integers(s * 3 // 4, s + 1))
      k = int(rng.integers(lo, hi + 1))
      w = rng.lognormal(0.0, 0.6, k)
      pieces = np.maximum(1, (w / w.sum() * (total - 1 - k)).astype(int))
      pieces[-1] += total - 1 - k - pieces.sum()  # the row holds `total`
      ids, marks = [CLS], []
      for n in pieces:
        marks.append(len(ids))
        ids += rng.integers(MASK + 1, VOCAB_REAL, n).tolist() + [SEP]
      rows.append({
          'input_ids': serialize_np_array(np.asarray(ids, np.uint16)),
          'doc_offsets': serialize_np_array(np.asarray(marks, np.uint16))})
    return rows

  def __iter__(self):
    return iter(self.batches[self.start:])


def check_vocab():
  with open(VOCAB_FILE) as f:
    tokens = f.read().split('\n')[:5]
  want = {'[PAD]': PAD, '[CLS]': CLS, '[SEP]': SEP, '[MASK]': MASK}
  got = {t: i for i, t in enumerate(tokens) if t in want}
  if got != want:
    raise AssertionError(f'{VOCAB_FILE}: special ids {got}, want {want}')


def train(args, card):
  from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.models.flops import peak_flops_per_device
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.training import MODEL_SIZES, TrainLoop

  check_vocab()
  cfg = BertConfig(attention_impl='flash', dtype=torch.bfloat16,
                   **MODEL_SIZES[MODEL])
  steps_per_bin = args.warmup + args.steps
  build = dict(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
               warmup_steps=10, total_steps=1000, seed=args.seed,
               max_predictions=args.max_predictions)
  loop = TrainLoop.build(**build)
  # Per bin: warm-up and timed steps, 2 profiled steps, 2 for the
  # save/restore check, and the last batch for the dense comparison.
  loaders = [BinLoader(s, b, steps_per_bin + 5, args.seed, dynamic_mask_tokens)
             for s, b in BINS]
  peak = peak_flops_per_device()

  # The main path: counts at 0 just before, read just after.
  tfa.reset_launches()
  per_bin = []
  all_losses = []
  for (s, b), loader in zip(BINS, loaders):
    loop.loader = loader
    loader.start = 0
    base = loop.step
    all_losses += loop.run(base + args.warmup, log_every=0)
    loader.start = args.warmup
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = loop.run(base + steps_per_bin, log_every=0)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / len(losses)
    all_losses += losses
    mfu = loop.flops_per_step(b, s) / dt / peak
    per_bin.append({'seq_len': s, 'batch': b, 'ms_per_step': 1e3 * dt,
                    'samples_per_s': b / dt, 'mfu': mfu,
                    'losses': losses})
    log(f'  bin s={s} b={b}: {1e3 * dt:.2f} ms/step, {b / dt:.1f} '
        f'samples/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s bf16 [{card}]; '
        f'losses {losses[0]:.4f} -> {losses[-1]:.4f}')
  counts = dict(tfa.launches)
  total_steps = len(all_losses)
  if not all(np.isfinite(all_losses)):
    raise AssertionError(f'non-finite loss in {all_losses}')
  if loop.stop_reason is not None:
    raise AssertionError(f'run stopped early: {loop.stop_reason}')
  want = cfg.num_layers * total_steps
  if counts != {'fwd': want, 'dq': want, 'dkv': want, 'fwd_seg': 0,
                'dq_seg': 0, 'dkv_seg': 0}:
    raise AssertionError(f'launches {counts} after {total_steps} steps; '
                         f'want {want} of each segment-free kernel (12 per '
                         'step) and none of the segmented ones')
  log(f'  launches over {total_steps} steps: {counts} (12 per step each)')

  for bin_stats, loader in zip(per_bin, loaders):
    loader.start = steps_per_bin
    bin_stats['profile'] = profile_steps(loop, loader, bin_stats, card)

  flash_vs_dense(loop, cfg, loaders[1].batches[-1], args.max_predictions,
                 'the s=512 batch')
  check_resume(loop, build, loaders[1], steps_per_bin + 2)
  return per_bin, counts


def flash_vs_dense(loop, cfg, batch, max_predictions, label):
  """One step, flash vs dense attention, from the same weights and batch:
  loss and gradient norm within DENSE_LOSS_RTOL / DENSE_GRAD_NORM_RTOL."""
  from lddl_tpu_torch.models import BertForPretraining
  from lddl_tpu_torch.parallel.train import global_norm, pretrain_loss
  batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
  dense = BertForPretraining(
      dataclasses.replace(cfg, attention_impl='dense')).to(DEVICE)
  dense.load_state_dict(loop.model.state_dict())
  got = {}
  for name, model in (('flash', loop.model), ('dense', dense)):
    model.zero_grad(set_to_none=True)
    loss, _ = pretrain_loss(model, batch, max_predictions=max_predictions)
    loss.backward()
    got[name] = (float(loss.detach()), float(global_norm(
        [p.grad for p in model.parameters()])))
    model.zero_grad(set_to_none=True)
  del dense
  (fl, fg), (dl, dg) = got['flash'], got['dense']
  if abs(fl - dl) > DENSE_LOSS_RTOL * abs(dl) or (
      abs(fg - dg) > DENSE_GRAD_NORM_RTOL * abs(dg)):
    raise AssertionError(f'flash vs dense ({label}): loss {fl} vs {dl}, '
                         f'grad_norm {fg} vs {dg}')
  log(f'  flash vs dense ({label}): loss {fl:.6f} vs {dl:.6f}, '
      f'grad_norm {fg:.4f} vs {dg:.4f} (rtol {DENSE_LOSS_RTOL}, '
      f'{DENSE_GRAD_NORM_RTOL})')


def check_resume(loop, build, loader, start, steps=2):
  """Save, ``steps`` more steps from batch ``start`` of ``loader``; restore
  into a fresh loop, the same steps: losses and state digest must equal
  the uninterrupted run bit for bit."""
  from lddl_tpu_torch.training import TrainLoop
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    with tempfile.TemporaryDirectory(prefix='lddl_smoke_ckpt_') as ckpt:
      loop.loader = loader
      loader.start = start
      loop.save(ckpt)
      at = loop.step
      straight = loop.run(at + steps, log_every=0)
      digest = loop.state_digest()
      resumed = TrainLoop.build(**build).restore(ckpt)
      resumed.loader = loader
      again = resumed.run(at + steps, log_every=0)
      same_digest = resumed.state_digest() == digest
  finally:
    torch.use_deterministic_algorithms(False)
  if again != straight or not same_digest:
    raise AssertionError(f'resumed losses {again} != uninterrupted '
                         f'{straight}, or state digests differ')
  log(f'  save at step {at}, restore, {steps} steps: losses {again} and the '
      'state digest equal the uninterrupted run bit for bit')


# ---- phase 6: packed long-context training ----


def train_packed(args, card):
  """BERT-base at s=8192 on packed block-diagonal batches through
  TrainLoop.run; returns the phase's numbers and the launch counts read
  just after its warm-up and timed steps."""
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.models.flops import peak_flops_per_device
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.training import MODEL_SIZES, TrainLoop

  s, b, max_predictions = PACKED
  # The JAX CLI sizes the position table max(max_seq_length, 512).
  cfg = BertConfig(attention_impl='flash', dtype=torch.bfloat16,
                   max_position_embeddings=max(s, 512), **MODEL_SIZES[MODEL])
  build = dict(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
               warmup_steps=10, total_steps=1000, seed=args.seed,
               max_predictions=max_predictions, max_seq_length=s)
  loop = TrainLoop.build(**build)
  n_main = args.packed_warmup + args.packed_steps
  # Warm-up and timed steps, 2 profiled, 2 for the save/restore check.
  loader = PackedLoader(s, b, n_main + 4, args.seed)
  peak = peak_flops_per_device()

  # The main path: counts at 0 just before, read just after.
  tfa.reset_launches()
  loop.loader = loader
  loader.start = 0
  losses = loop.run(args.packed_warmup, log_every=0)
  loader.start = args.packed_warmup
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  timed = loop.run(n_main, log_every=0)
  torch.cuda.synchronize()
  dt = (time.perf_counter() - t0) / len(timed)
  counts = dict(tfa.launches)
  losses += timed
  if not all(np.isfinite(losses)):
    raise AssertionError(f'non-finite packed loss in {losses}')
  if loop.stop_reason is not None:
    raise AssertionError(f'packed run stopped early: {loop.stop_reason}')
  want = cfg.num_layers * len(losses)
  expect = {'fwd': 0, 'dq': 0, 'dkv': 0, 'fwd_seg': want, 'dq_seg': want,
            'dkv_seg': want}
  if counts != expect:
    raise AssertionError(f'packed launches {counts} after {len(losses)} '
                         f'steps; want {expect} (12 per step of each '
                         'segmented kernel, none of the segment-free ones)')
  log(f'  launches over {len(losses)} packed steps: {counts}')

  timed_batches = loader.batches[args.packed_warmup:n_main]
  seg = np.concatenate([x['segment_ids'] for x in timed_batches])
  real_tokens = float(np.mean([x['attention_mask'].sum()
                               for x in timed_batches]))
  pairs = same_doc_pairs(seg) / len(timed_batches)
  total, skipped = tfa.count_skippable_tiles(seg, head_dim=cfg.head_dim)
  flops = loop.flops_per_step(b, s)
  # models/flops.py counts attention over all b*s*s pairs: 4 FLOPs per
  # pair and feature per layer forward (QK^T and PV), x3 with backward.
  per_pair = 3 * cfg.num_layers * 4 * cfg.hidden_size
  flops_same_doc = flops - per_pair * (b * s * s - pairs)
  stats = {
      'seq_len': s, 'batch': b, 'max_predictions': max_predictions,
      'ms_per_step': 1e3 * dt, 'samples_per_s': b / dt,
      'real_tokens_per_s': real_tokens / dt,
      'docs_per_row': float(np.mean([r.max() + 1 for r in seg])),
      'real_token_share': real_tokens / (b * s),
      'skip_fraction': skipped / total,
      'mfu_dense_count': flops / dt / peak,
      'mfu_same_doc': flops_same_doc / dt / peak,
      'losses': timed}
  log(f'  packed s={s} b={b}: {1e3 * dt:.2f} ms/step, {b / dt:.2f} '
      f'samples/s, {real_tokens / dt:.0f} real tokens/s '
      f'({100 * stats["real_token_share"]:.1f}% of the bin real, '
      f'{stats["docs_per_row"]:.1f} docs/row, '
      f'{100 * stats["skip_fraction"]:.1f}% of attention tiles skipped) '
      f'[{card}]')
  log(f'  packed MFU of 989 TFLOP/s bf16: {100 * stats["mfu_dense_count"]:.2f}% '
      f'with dense-count FLOPs (models/flops.py, {flops / 1e12:.2f} TFLOP/step), '
      f'{100 * stats["mfu_same_doc"]:.2f}% with attention over same-document '
      f'pairs only ({flops_same_doc / 1e12:.2f} TFLOP/step); losses '
      f'{timed[0]:.4f} -> {timed[-1]:.4f}')

  loader.start = n_main
  stats['profile'] = profile_steps(loop, loader, stats, card)
  flash_vs_dense(loop, cfg, PackedLoader(*PACKED_DENSE, 1, args.seed).batches[0],
                 max_predictions, f'a packed s={PACKED_DENSE[0]} batch')
  check_resume(loop, build, loader, n_main + 2)
  return stats, counts


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--steps', type=int, default=10,
                      help='timed steps per bin')
  parser.add_argument('--warmup', type=int, default=3,
                      help='untimed steps per bin before the timed ones')
  parser.add_argument('--max-predictions', type=int, default=112,
                      help='masked-only MLM head budget (covers dynamic '
                      'masking at s=512)')
  parser.add_argument('--packed-steps', type=int, default=5,
                      help='timed packed s=8192 steps')
  parser.add_argument('--packed-warmup', type=int, default=2,
                      help='untimed packed steps before the timed ones')
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; nothing to check', file=sys.stderr)
    return 2
  from lddl_tpu_torch.ops import _build
  from lddl_tpu_torch.ops import flash_attention as tfa

  card = card_line()
  log(f'card: {card}')
  log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
      f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  log('== build')
  t0 = time.perf_counter()
  _build.library()
  log(f'  kernels loaded in {time.perf_counter() - t0:.1f}s from '
      f'{_build.library_path()}')
  ptxas = {}
  if _build.build_info['log'] is not None:
    log(f'  nvcc took {_build.build_info["seconds"]:.1f}s; ptxas:')
    ptxas = ptxas_report(_build.build_info['log'])

  log('== kernels vs plain versions [' + card + ']')
  cases = []
  for dtype in (torch.float32, torch.bfloat16):
    # The training bins' shapes (BERT-base heads), a ragged length, and
    # the other two head dims the kernels take.
    cases += [(b, 12, s, 64, dtype) for s, b in BINS]
    cases += [(*shape, dtype) for shape in EXTRA_CASES]
  rows = check_kernels(tfa, cases, args.seed)

  log('== segmented kernels (K4) vs plain versions [' + card + ']')
  rows += check_seg_kernels(tfa, SEG_CASES, args.seed)
  torch.cuda.empty_cache()

  log('== training BERT-base, flash attention, bf16 [' + card + ']')
  per_bin, counts = train(args, card)
  torch.cuda.empty_cache()

  log(f'== packed long-context training, BERT-base s={PACKED[0]}, '
      f'block-diagonal, bf16 [{card}]')
  packed, seg_counts = train_packed(args, card)
  counts.update({k: v for k, v in seg_counts.items() if k.endswith('_seg')})

  # Each kernel at the shape of the training phase that runs it, bf16.
  main_shape = {'': [BINS[1][1], 12, BINS[1][0], 64],
                '_seg': list(SEG_CASES[0][:4])}
  summary = []
  for name in ('fwd', 'dq', 'dkv', 'fwd_seg', 'dq_seg', 'dkv_seg'):
    seg = name[-4:] if name.endswith('_seg') else ''
    r = next(x for x in rows if x['name'] == name and
             x['shape'] == main_shape[seg] and
             x['dtype'] == str(torch.bfloat16))
    entry = {
        'name': f'flash_{name}', 'route': 'cuda', 'source': KERNEL_SOURCE,
        'replaces': TPU_KERNELS[name], 'launches': counts[name],
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
        'shape': r['shape'], 'dtype': r['dtype'], 'body': r['body'],
        'library': ('scaled_dot_product_attention forward' if
                    name.startswith('fwd') else
                    'scaled_dot_product_attention backward (dq, dk and dv '
                    'together)') + (' with the [b, 1, s, s] block-diagonal '
                                    'mask' if seg else '') +
                   ', pinned to SDPBackend.EFFICIENT_ATTENTION'}
    entry.update(ptxas.get((name, r['body']), {}))
    if seg:
      entry.update(skip_fraction=r['skip_fraction'],
                   segment_free_ms=r['segment_free_ms'],
                   intervals_ms=r['intervals_ms'])
    summary.append(entry)
  log(json.dumps({'training': [{k: v for k, v in b.items() if k != 'losses'}
                               for b in per_bin],
                  'packed': {k: v for k, v in packed.items()
                             if k != 'losses'}, 'card': card}))
  log(json.dumps({'kernels': summary}))
  log(card)
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
