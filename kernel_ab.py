#!/usr/bin/env python3
"""Time the CUDA kernels of two checkouts on one CUDA card, in turns.

    git archive <base-commit> | tar -x -C build/base   # a git-ignored dir
    python3 kernel_ab.py build/base . [--out kernel_ab.json]

Each checkout runs in its own process, with its own lddl_tpu_torch and
its own kernel build, in the order base, change, change, base. Each
process times every flash kernel through its own checkout's
``chip_smoke.check_kernels`` and ``check_seg_kernels`` at the main path's
shapes (the two training bins and the packed s=8192 case in bf16, the
same in float32), so each side also times its own library yardstick; and
both masking programs (``ops.masking.partition_program`` and
``matrix_program``) at chip_smoke 17a's shapes (MASK_ROWS full rows at
s=128 and s=512, and s=512 under the max_predictions cap), by this
file's :func:`launches_ms`, the same timing code for both checkouts.
Prints one line per kernel and shape with the four times, then the
card's name and power limit. Needs one card; exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys


def launches_ms(fn, graphs=5, calls=10):
  """Milliseconds of one call of ``fn`` (a kernel wrapper: its launch and
  the outputs it allocates), as launches alone: ``calls`` calls captured
  into one CUDA graph (each allocates its outputs once, at capture, from
  the graph's pool), the graph replayed ``graphs`` times between one pair
  of CUDA events, the time divided by the calls. The inputs stay in the
  card's 50 MB L2 between calls where they fit (warm)."""
  import torch
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    fn()  # loads the library and raises its shared-memory limit first
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph, capture_error_mode='thread_local'):
    for _ in range(calls):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(graphs):
    graph.replay()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / (graphs * calls)


# One process per checkout: its chip_smoke, its kernels, its yardstick.
CHILD = r'''
import importlib.util, json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from lddl_tpu_torch.ops import flash_attention as tfa
from lddl_tpu_torch.ops import masking as tm
spec = importlib.util.spec_from_file_location('kernel_ab', sys.argv[1])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cases = [(b, 12, s, 64, dtype) for dtype in (torch.bfloat16, torch.float32)
         for s, b in cs.BINS]
packed = (2, 12, 8192, 64, torch.bfloat16, 16, True, False)
assert tuple(cs.SEG_CASES[0]) == packed, cs.SEG_CASES[0]
rows = cs.check_kernels(tfa, cases, 0)
rows += cs.check_seg_kernels(tfa, [packed, (2, 12, 2048, 64, torch.float32,
                                            4, True, False)], 0)
rows = [{k: r[k] for k in ('name', 'shape', 'dtype', 'ms', 'library_ms')}
        for r in rows]
ratio, vocab, ids = cs.MASK_RATIO, cs.VOCAB_REAL, cs.MASK_IDS
for seq_len, cap in [(s, None) for s in cs.MASK_SEQ_LENS] + [
    (cs.MASK_SEQ_LENS[-1], cs.MASK_CAP)]:
  flat, a, b = cs.mask_inputs(cs.MASK_ROWS, seq_len, seq_len)
  keys = tm.draw_keys(seq_len)
  cols = [torch.from_numpy(np.ascontiguousarray(c, dtype=np.int32)).cuda()
          for c in (a[:, 0], a[:, 1], b[:, 0], b[:, 1])]
  flat_t = torch.from_numpy(flat).cuda()
  mat = [torch.from_numpy(x).cuda() for x in tm.assemble_pair_matrix(
      flat.astype(np.int32), a, b, ids['cls_id'], ids['sep_id'], seq_len)]
  calls = {
      'mask_partition': lambda: tm.partition_program(
          flat_t, *cols, keys, seq_len=seq_len, masked_lm_ratio=ratio,
          vocab_size=vocab, max_pred=tm.partition_max_pred(
              seq_len, ratio, cap), **ids),
      'mask_matrix': lambda: tm.matrix_program(
          *mat, keys, masked_lm_ratio=ratio, vocab_size=vocab,
          mask_id=ids['mask_id'], max_pred=cap)}
  for name, call in calls.items():
    rows.append({'name': name, 'shape': [len(a), seq_len],
                 'dtype': 'int32' + (f' cap {cap}' if cap else ''),
                 'ms': ab.launches_ms(call), 'library_ms': None})
  torch.cuda.empty_cache()
print('ROWS ' + json.dumps(rows))
'''


def run(tree):
  proc = subprocess.run([sys.executable, '-c', CHILD,
                         os.path.abspath(__file__)], cwd=tree,
                        capture_output=True, text=True, check=False)
  rows = [line[5:] for line in proc.stdout.splitlines()
          if line.startswith('ROWS ')]
  if proc.returncode or not rows:
    raise RuntimeError(f'{tree}: exit {proc.returncode}\n'
                       f'{proc.stdout[-4000:]}{proc.stderr[-4000:]}')
  return json.loads(rows[0])


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('base', help='checkout timed first and last')
  parser.add_argument('change', help='checkout timed second and third')
  parser.add_argument('--out', help='write all four runs here as JSON')
  args = parser.parse_args()
  import torch
  if not torch.cuda.is_available():
    print('kernel_ab: no CUDA device', file=sys.stderr)
    return 2
  order = (('base', args.base), ('change', args.change),
           ('change', args.change), ('base', args.base))
  runs = [(name, run(os.path.abspath(tree))) for name, tree in order]
  card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                         '--format=csv,noheader'], capture_output=True,
                        text=True, check=True).stdout.strip()
  for i, r in enumerate(runs[0][1]):
    times = ' '.join(f'{name}={rows[i]["ms"]:.4f}' for name, rows in runs)
    libs = ' '.join('-' if rows[i]['library_ms'] is None else
                    f'{rows[i]["library_ms"]:.3f}' for _, rows in runs)
    print(f'{r["name"]:14s} {str(r["shape"]):18s} {r["dtype"]:14s} ms: '
          f'{times}  library ms: {libs}')
  print(card)
  if args.out:
    with open(args.out, 'w') as f:
      json.dump({'card': card, 'order': [name for name, _ in runs],
                 'runs': [rows for _, rows in runs]}, f, indent=1)
  return 0


if __name__ == '__main__':
  sys.exit(main())
