"""Load balancer: equalize per-shard sample counts, with no pyarrow.

The port's :mod:`lddl_tpu.balance`, over the port's Parquet reader and
writer (:mod:`lddl_tpu_torch.pipeline.parquet_io`). Input: a directory of
(possibly binned) Parquet shards with unequal sample counts; output:
``shard-<idx>.parquet[_<bin_id>]`` files where every shard of a bin holds
``n`` or ``n+1`` rows, plus the ``.num_samples.json`` cache the loaders
read.

Balancing is planned first, as in the JAX package: every rank counts its
strided slice of the input files from their footers (summed over the
comm), the sorted input files are one logical stream of rows, output
shard ``i`` takes the contiguous slice ``[i*n + min(i, r), ...)`` with
``n, r = divmod(total, num_shards)``, and rank ``i % world`` writes shard
``i`` once, reading only the row groups its slice overlaps. A delta-format
row is a base pair and its per-copy deltas, so delta shards balance in
groups (``n`` or ``n+1`` base rows); mixing formats is refused.

Output files are the port writer's (PLAIN pages, LZ4_RAW), so their bytes
differ from pyarrow's; their rows do not.
"""

import argparse
import json
import os
import time

import numpy as np

from .comm import get_backend
from .core.types import File
from .core.utils import (count_parquet_samples_strided, get_all_bin_ids,
                         get_all_parquets_under, get_file_paths_for_bin_id)
from .pipeline.parquet_io import ParquetFile, Table, write_shard_file
from .pipeline.shard_format import scan_shard_format

NUM_SAMPLES_CACHE = '.num_samples.json'


def count_samples(paths, comm):
  """Per-file sample counts with strided ownership + allreduce."""
  counts = count_parquet_samples_strided(paths, comm)
  return [File(p, c) for p, c in zip(paths, counts)]


def plan_shards(files, num_shards):
  """Contiguous sample slices of the concatenated input stream, one list
  of ``(file_index, row_start, row_stop)`` read ranges per output shard:
  ``n+1`` rows for the first ``total % num_shards`` shards, ``n`` after."""
  if num_shards <= 0:
    raise ValueError(f'num_shards must be positive, got {num_shards}')
  if not files:
    raise ValueError('cannot plan shards from zero input files')
  total = sum(f.num_samples for f in files)
  n, r = divmod(total, num_shards)
  starts = [i * n + min(i, r) for i in range(num_shards + 1)]
  file_offsets = np.cumsum([0] + [f.num_samples for f in files])
  plans = []
  fi = 0
  for s in range(num_shards):
    lo, hi = starts[s], starts[s + 1]
    ranges = []
    while fi < len(files) and file_offsets[fi + 1] <= lo:
      fi += 1
    j = fi
    while j < len(files) and file_offsets[j] < hi:
      a = max(lo, int(file_offsets[j])) - int(file_offsets[j])
      b = min(hi, int(file_offsets[j + 1])) - int(file_offsets[j])
      if b > a:
        ranges.append((j, a, b))
      j += 1
    plans.append(ranges)
  return plans


def _read_row_range(path, a, b):
  """Rows ``[a, b)`` of a Parquet file, reading only the row groups that
  overlap the range."""
  with ParquetFile(path) as pf:
    groups = pf.metadata.row_groups
    offsets = np.cumsum([0] + [g.num_rows for g in groups])
    wanted = [i for i in range(len(groups))
              if offsets[i + 1] > a and offsets[i] < b]
    table = pf.read_row_groups(wanted)
  start = a - int(offsets[wanted[0]]) if wanted else 0
  return table.slice(start, start + (b - a))


def _materialize_shard(files, ranges, out_path, compression='default'):
  pieces = [
      _read_row_range(files[file_idx].path, a, b) for file_idx, a, b in ranges
  ]
  if pieces:
    out = Table.concat(pieces)
  else:
    # A shard whose slice is empty (more shards than samples) still gets a
    # zero-row file with the real schema, so the shard index set stays
    # contiguous for the loader.
    if not files:
      raise ValueError('cannot materialize a shard from zero input files')
    with ParquetFile(files[0].path) as pf:
      out = pf.read_row_groups([])
  write_shard_file(out, out_path, compression=compression)
  return out.num_rows


def balance(input_paths, output_dir, num_shards, comm, postfix=''):
  """Balance one group of shards (one bin, or the whole unbinned set).
  Returns ``{output_basename: num_samples}`` (the same on every rank)."""
  paths = sorted(input_paths)
  scan_shard_format(paths)
  files = count_samples(paths, comm)
  total = sum(f.num_samples for f in files)
  if total == 0 and comm.rank == 0:
    print(f'warning: balancing zero samples (postfix={postfix!r}); '
          f'writing {num_shards} empty shards')
  plans = plan_shards(files, num_shards)
  meta = {}
  for s, ranges in enumerate(plans):
    out_name = f'shard-{s}.parquet{postfix}'
    meta[out_name] = sum(b - a for _, a, b in ranges)
    if s % comm.world_size == comm.rank:
      written = _materialize_shard(files, ranges,
                                   os.path.join(output_dir, out_name))
      if written != meta[out_name]:
        raise RuntimeError(f'{out_name}: wrote {written} rows, planned '
                           f'{meta[out_name]}')
  comm.barrier()
  return meta


def balance_directory(input_dir, output_dir, num_shards, comm=None):
  """Balance a full preprocessor sink, per bin when binned, and write the
  ``.num_samples.json`` cache."""
  comm = comm or get_backend()
  os.makedirs(output_dir, exist_ok=True)
  paths = get_all_parquets_under(input_dir)
  if not paths:
    raise ValueError(f'no parquet shards under {input_dir}')
  # One scan over the whole sink: a corpus mixing formats across bins is
  # as broken as one mixing them within a bin.
  scan_shard_format(paths)
  bin_ids = get_all_bin_ids(paths)
  meta = {}
  if bin_ids:
    for b in bin_ids:
      meta.update(
          balance(
              get_file_paths_for_bin_id(paths, b),
              output_dir,
              num_shards,
              comm,
              postfix=f'_{b}'))
  else:
    meta.update(balance(paths, output_dir, num_shards, comm))
  if comm.rank == 0:
    with open(os.path.join(output_dir, NUM_SAMPLES_CACHE), 'w') as f:
      json.dump(meta, f, indent=2, sort_keys=True)
  comm.barrier()
  return meta


def generate_num_samples_cache(path, comm=None):
  """(Re)build ``.num_samples.json`` for an already-balanced directory."""
  comm = comm or get_backend()
  paths = get_all_parquets_under(path)
  files = count_samples(sorted(paths), comm)
  meta = {os.path.basename(f.path): f.num_samples for f in files}
  if comm.rank == 0:
    with open(os.path.join(path, NUM_SAMPLES_CACHE), 'w') as f:
      json.dump(meta, f, indent=2, sort_keys=True)
  comm.barrier()
  return meta


def load_num_samples_cache(path):
  """Read ``.num_samples.json`` if present; returns None otherwise."""
  cache = os.path.join(path, NUM_SAMPLES_CACHE)
  if not os.path.isfile(cache):
    return None
  with open(cache) as f:
    return json.load(f)


def attach_args(parser):
  parser.add_argument('--indir', type=str, required=True)
  parser.add_argument('--outdir', type=str, required=True)
  parser.add_argument('--num-shards', type=int, required=True)
  parser.add_argument('--comm', type=str, default='null',
                      choices=['null', 'file', 'torch'])
  return parser


def main(args=None):
  parser = attach_args(
      argparse.ArgumentParser(
          description=__doc__,
          formatter_class=argparse.ArgumentDefaultsHelpFormatter))
  args = parser.parse_args(args)
  comm = get_backend(args.comm)
  t0 = time.perf_counter()
  meta = balance_directory(args.indir, args.outdir, args.num_shards, comm)
  if comm.rank == 0:
    print(f'balanced {sum(meta.values())} samples into {len(meta)} shards '
          f'in {time.perf_counter() - t0:.1f}s')
  return meta


def cache_main(args=None):
  """The ``generate_num_samples_cache`` command: rewrite
  ``.num_samples.json`` of a balanced directory."""
  parser = argparse.ArgumentParser(
      description=generate_num_samples_cache.__doc__)
  parser.add_argument('--path', type=str, required=True)
  parser.add_argument('--comm', type=str, default='null',
                      choices=['null', 'file', 'torch'])
  args = parser.parse_args(args)
  return generate_num_samples_cache(args.path, get_backend(args.comm))


if __name__ == '__main__':
  main()
