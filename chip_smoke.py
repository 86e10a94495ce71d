#!/usr/bin/env python3
"""Drive lddl_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--steps N] [--warmup N]

Phases, each of which raises on failure (the script then exits non-zero):

  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from lddl_tpu_torch/csrc (nvcc, sm_90a);
  3. hold each kernel (flash fwd, dq, dkv) against its plain PyTorch
     version on the card, in float32 (TF32 off) and bfloat16, at the
     shapes the training phase gives them plus a ragged and a d=32 case;
     check that two launches are bitwise equal; time kernel, plain version
     and PyTorch's scaled_dot_product_attention (a yardstick only, never
     called by the port) with CUDA events, beside the least time the card
     could take for the same work;
  4. train BERT-base at full width (hidden 768, 12 layers, 12 heads, FFN
     3072, vocab 30528, bf16, attention_impl='flash') through
     TrainLoop.run on loader-format batches made in numpy from --seed, in
     two bins (seq 128 x batch 64, seq 512 x batch 16) fed by
     prefetch_to_device; check finite losses and 12 launches of each
     kernel per step; check one step against dense attention from the
     same weights; save, restore and check the resumed losses.

The last lines are the kernels' JSON summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits non-zero before printing any result.
"""

import argparse
import json
import os
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
KERNEL_SOURCE = 'lddl_tpu_torch/csrc/flash_attention.cu'
TPU_KERNELS = {
    'fwd': 'lddl_tpu/ops/flash_attention.py:166',
    'dq': 'lddl_tpu/ops/flash_attention.py:210',
    'dkv': 'lddl_tpu/ops/flash_attention.py:248',
}
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


def work(name, b, h, s, d, dtype, mask):
  """(FLOPs, bytes) the function needs on these inputs: products over
  attended keys only (a kernel could skip masked ones), each input read
  once and each output written once."""
  keys = int(mask.sum())  # sum over rows of attended keys
  elt = torch.finfo(dtype).bits // 8
  mat = b * h * s * d * elt      # one [bh, s, d] tensor
  row = b * h * s * 4            # one [bh, s] float32 tensor
  bias = b * s * 4
  products = {'fwd': 2, 'dq': 3, 'dkv': 4}[name]  # matmuls of s x s x d
  flops = 2 * products * h * s * keys * d
  moved = {'fwd': 4 * mat + row + bias,
           'dq': 5 * mat + 2 * row + bias,
           'dkv': 6 * mat + 2 * row + bias}[name]
  return flops, moved


def check_kernels(tfa, cases, seed):
  """Every case: kernel vs plain, repeatability, timings. Returns the
  rows for the report."""
  import torch.nn.functional as F
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
    # Yardstick: one PyTorch call computing the same function.
    q4, k4, v4 = (t.view(b, h, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_mask = bias.to(dtype)[:, None, None, :]
    sdpa_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=sdpa_mask)
    sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=sdpa_mask)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (q4, k4, v4), g.view(b, h, s, d), retain_graph=True)
    library = {'fwd': cuda_ms(sdpa_fwd), 'dq': cuda_ms(sdpa_bwd)}
    library['dkv'] = library['dq']
    fwd_tol, grad_tol = TOL[dtype]
    for name, (kernel, plain) in results.items():
      got, again, ref = kernel(), kernel(), plain()
      torch.cuda.synchronize()
      got, again, ref = ((t,) if torch.is_tensor(t) else t
                         for t in (got, again, ref))
      if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f'{name} {(b, h, s, d, dtype)}: two launches '
                             'on the same inputs differ')
      tol = fwd_tol if name == 'fwd' else grad_tol
      err = 0.0
      for a, r in zip(got, ref):
        torch.testing.assert_close(a.float(), r.float(), rtol=tol, atol=tol)
        err = max(err, float((a.float() - r.float()).abs().max()))
      flops, moved = work(name, b, h, s, d, dtype, mask)
      t_flops, t_bytes = flops / PEAK_FLOPS[dtype], moved / PEAK_BYTES
      rows.append({
          'name': name, 'shape': [b, h, s, d], 'dtype': str(dtype),
          'max_abs_err': err, 'tol': tol,
          'ms': cuda_ms(kernel), 'plain_ms': cuda_ms(plain),
          'library_ms': library[name],
          'bound_ms': 1e3 * max(t_flops, t_bytes),
          'bound_by': 'operations' if t_flops >= t_bytes else 'bytes'})
      r = rows[-1]
      log(f'  {name:3s} b={b:2d} h={h:2d} s={s:3d} d={d:3d} '
          f'{str(dtype):14s} err={err:.3g} (tol {tol:g}) bitwise-repeat=ok '
          f'kernel={r["ms"]:.3f}ms plain={r["plain_ms"]:.3f}ms '
          f'sdpa={r["library_ms"]:.3f}ms bound={r["bound_ms"]:.4f}ms '
          f'({r["bound_by"]}, {100 * r["bound_ms"] / r["ms"]:.1f}% of bound)')
    del q4, k4, v4, sdpa_out
  return rows


# ---- phase 4: training ----


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


def check_vocab():
  with open(VOCAB_FILE) as f:
    tokens = f.read().split('\n')[:5]
  want = {'[PAD]': PAD, '[CLS]': CLS, '[SEP]': SEP, '[MASK]': MASK}
  got = {t: i for i, t in enumerate(tokens) if t in want}
  if got != want:
    raise AssertionError(f'{VOCAB_FILE}: special ids {got}, want {want}')


def train(args, card):
  from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
  from lddl_tpu_torch.models import BertConfig, BertForPretraining
  from lddl_tpu_torch.models.flops import peak_flops_per_device
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.parallel.train import global_norm, pretrain_loss
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
  if counts != {'fwd': want, 'dq': want, 'dkv': want}:
    raise AssertionError(f'launches {counts} after {total_steps} steps; '
                         f'want {want} of each (12 per step)')
  log(f'  launches over {total_steps} steps: {counts} (12 per step each)')

  for bin_stats, loader in zip(per_bin, loaders):
    loader.start = steps_per_bin
    bin_stats['profile'] = profile_steps(loop, loader, bin_stats, card)

  # One step, flash vs dense attention, from the same weights and batch.
  batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
           loaders[1].batches[-1].items()}
  dense = BertForPretraining(
      BertConfig(attention_impl='dense', dtype=torch.bfloat16,
                 **MODEL_SIZES[MODEL])).to(DEVICE)
  dense.load_state_dict(loop.model.state_dict())
  got = {}
  for name, model in (('flash', loop.model), ('dense', dense)):
    model.zero_grad(set_to_none=True)
    loss, _ = pretrain_loss(model, batch,
                            max_predictions=args.max_predictions)
    loss.backward()
    got[name] = (float(loss.detach()), float(global_norm(
        [p.grad for p in model.parameters()])))
    model.zero_grad(set_to_none=True)
  del dense
  (fl, fg), (dl, dg) = got['flash'], got['dense']
  if abs(fl - dl) > DENSE_LOSS_RTOL * abs(dl) or (
      abs(fg - dg) > DENSE_GRAD_NORM_RTOL * abs(dg)):
    raise AssertionError(f'flash vs dense: loss {fl} vs {dl}, grad_norm '
                         f'{fg} vs {dg}')
  log(f'  flash vs dense (s=512 batch): loss {fl:.6f} vs {dl:.6f}, '
      f'grad_norm {fg:.4f} vs {dg:.4f} (rtol {DENSE_LOSS_RTOL}, '
      f'{DENSE_GRAD_NORM_RTOL})')

  # Save, two more steps; restore into a fresh loop, the same two steps.
  torch.use_deterministic_algorithms(True, warn_only=True)
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_ckpt_') as ckpt:
    loop.loader = loaders[1]
    loaders[1].start = steps_per_bin + 2
    loop.save(ckpt)
    at = loop.step
    straight = loop.run(at + 2, log_every=0)
    digest = loop.state_digest()
    del loop
    resumed = TrainLoop.build(**build).restore(ckpt)
    resumed.loader = loaders[1]
    again = resumed.run(at + 2, log_every=0)
    same_digest = resumed.state_digest() == digest
  torch.use_deterministic_algorithms(False)
  if again != straight or not same_digest:
    raise AssertionError(f'resumed losses {again} != uninterrupted '
                         f'{straight}, or state digests differ')
  log(f'  save at step {at}, restore, 2 steps: losses {again} and the '
      'state digest equal the uninterrupted run bit for bit')
  return per_bin, counts


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
  if _build.build_info['log'] is not None:
    log(f'  nvcc took {_build.build_info["seconds"]:.1f}s; ptxas:')
    for line in _build.build_info['log'].splitlines():
      if 'registers' in line or 'Compiling entry' in line:
        log('   ', line.strip())

  log('== kernels vs plain versions [' + card + ']')
  cases = []
  for dtype in (torch.float32, torch.bfloat16):
    # The training bins' shapes (BERT-base heads), a ragged length, and
    # the other two head dims the kernels take.
    cases += [(b, 12, s, 64, dtype) for s, b in BINS]
    cases += [(8, 12, 200, 64, dtype), (8, 8, 256, 32, dtype),
              (4, 8, 256, 128, dtype)]
  rows = check_kernels(tfa, cases, args.seed)

  log('== training BERT-base, flash attention, bf16 [' + card + ']')
  per_bin, counts = train(args, card)

  main_shape = [BINS[1][1], 12, BINS[1][0], 64]
  summary = []
  for name in ('fwd', 'dq', 'dkv'):
    r = next(x for x in rows if x['name'] == name and
             x['shape'] == main_shape and x['dtype'] == str(torch.bfloat16))
    summary.append({
        'name': f'flash_{name}', 'route': 'cuda', 'source': KERNEL_SOURCE,
        'replaces': TPU_KERNELS[name], 'launches': counts[name],
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
        'shape': r['shape'], 'dtype': r['dtype'],
        'library': ('scaled_dot_product_attention forward' if name == 'fwd'
                    else 'scaled_dot_product_attention backward (dq, dk '
                    'and dv together)')})
  log(json.dumps({'training': [{k: v for k, v in b.items() if k != 'losses'}
                               for b in per_bin], 'card': card}))
  log(json.dumps({'kernels': summary}))
  log(card)
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
