#!/usr/bin/env python3
"""Time the flash kernels of two checkouts on one CUDA card, in turns.

    git archive <base-commit> | tar -x -C build/base   # a git-ignored dir
    python3 kernel_ab.py build/base . [--out kernel_ab.json]

Each checkout runs in its own process, with its own lddl_tpu_torch and
its own kernel build, in the order base, change, change, base. Each
process times every kernel through its own checkout's
``chip_smoke.check_kernels`` and ``check_seg_kernels`` at the main path's
shapes (the two training bins and the packed s=8192 case in bf16, the
same in float32), so each side also times its own library yardstick.
Prints one line per kernel and shape with the four times, then the
card's name and power limit. Needs one card; exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys

# One process per checkout: its chip_smoke, its kernels, its yardstick.
CHILD = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from lddl_tpu_torch.ops import flash_attention as tfa
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cases = [(b, 12, s, 64, dtype) for dtype in (torch.bfloat16, torch.float32)
         for s, b in cs.BINS]
packed = (2, 12, 8192, 64, torch.bfloat16, 16, True, False)
assert tuple(cs.SEG_CASES[0]) == packed, cs.SEG_CASES[0]
rows = cs.check_kernels(tfa, cases, 0)
rows += cs.check_seg_kernels(tfa, [packed, (2, 12, 2048, 64, torch.float32,
                                            4, True, False)], 0)
print('ROWS ' + json.dumps([{k: r[k] for k in ('name', 'shape', 'dtype',
                                               'ms', 'library_ms')}
                            for r in rows]))
'''


def run(tree):
  proc = subprocess.run([sys.executable, '-c', CHILD], cwd=tree,
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
    times = ' '.join(f'{name}={rows[i]["ms"]:.3f}' for name, rows in runs)
    libs = ' '.join(f'{rows[i]["library_ms"]:.3f}' for _, rows in runs)
    print(f'{r["name"]:8s} {str(r["shape"]):18s} {r["dtype"]:14s} ms: '
          f'{times}  library ms: {libs}')
  print(card)
  if args.out:
    with open(args.out, 'w') as f:
      json.dump({'card': card, 'order': [name for name, _ in runs],
                 'runs': [rows for _, rows in runs]}, f, indent=1)
  return 0


if __name__ == '__main__':
  sys.exit(main())
