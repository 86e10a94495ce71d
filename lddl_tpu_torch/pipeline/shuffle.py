"""Deterministic two-phase global shuffle of text lines on disk.

Copied from :mod:`lddl_tpu.pipeline.shuffle`: the same seed puts the same
lines in the same partitions in the same order as the JAX package.

Replaces the reference's Dask dataframe shuffle trick
(``_shuffle_bag_texts``: bag -> dataframe with a random column -> shuffle ->
sample(1.0), reference ``lddl/dask/bert/pretrain.py:100-111``) with an
explicit scatter/gather through spill files:

  phase A (scatter): each input partition assigns every line a target
    output partition with a seeded RNG and appends it to
    ``<spill>/tgt<j>/src<i>.txt`` — one file per (source, target) pair, so
    there are no concurrent writers per file;
  phase B (gather): output partition j concatenates its spill files in
    sorted source order and shuffles locally with a seeded RNG.

Both phases are pure functions of (seed, partition index), so any rank or
worker can recompute any partition — the shuffle is deterministic and
restartable.
"""

import functools
import os

from ..core import random as lrandom
from .partition import read_lines


def _scatter_state(seed, src_index):
  return lrandom.get_state(f'{seed}:scatter:{src_index}')


def _gather_state(seed, tgt_index):
  return lrandom.get_state(f'{seed}:gather:{tgt_index}')


def scatter_partition(lines, src_index, num_targets, spill_dir, seed,
                      delimiter='\n'):
  """Phase A for one input partition. Returns per-target line counts.

  ``delimiter`` is the record delimiter used in the spill files — must be
  one the records cannot contain (CRLF for code records with embedded
  newlines).
  """
  state = _scatter_state(seed, src_index)
  buckets = [[] for _ in range(num_targets)]
  lines = list(lines)
  targets, state = lrandom.randrange_batch(num_targets, len(lines),
                                           rng_state=state)
  for line, j in zip(lines, targets):
    buckets[j].append(line)
  counts = []
  for j, bucket in enumerate(buckets):
    counts.append(len(bucket))
    if not bucket:
      continue
    tgt_dir = os.path.join(spill_dir, f'tgt{j}')
    os.makedirs(tgt_dir, exist_ok=True)
    # pid-unique tmp: an elastic re-execution of this scatter task may
    # briefly overlap the revoked owner; distinct tmps keep both renames
    # well-formed (identical bytes either way — scatter is seeded).
    tmp = os.path.join(tgt_dir, f'.src{src_index}.{os.getpid()}.tmp')
    with open(tmp, 'w', encoding='utf-8', newline='') as f:
      f.write(delimiter.join(bucket))
      f.write(delimiter)
    os.rename(tmp, os.path.join(tgt_dir, f'src{src_index}.txt'))
  return counts


def gather_partition(tgt_index, spill_dir, seed, delimiter='\n'):
  """Phase B for one output partition: concat spills + local shuffle."""
  tgt_dir = os.path.join(spill_dir, f'tgt{tgt_index}')
  lines = []
  if os.path.isdir(tgt_dir):
    names = sorted(
        (f for f in os.listdir(tgt_dir) if f.endswith('.txt')),
        key=lambda n: int(n[len('src'):-len('.txt')]))
    for name in names:
      with open(os.path.join(tgt_dir, name), encoding='utf-8',
                newline='') as f:
        lines.extend(r for r in f.read().split(delimiter) if r.strip())
  lrandom.shuffle(lines, rng_state=_gather_state(seed, tgt_index))
  return lines


def _scatter_corpus_task(part_slices, idx, num_targets, spill_dir, seed,
                         sample_ratio, sample_seed, delimiter):
  from ..preprocess.readers import read_partition_lines
  lines = read_partition_lines(part_slices, idx, sample_ratio, sample_seed,
                               delimiter)
  return scatter_partition(lines, idx, num_targets, spill_dir, seed,
                           delimiter=delimiter)


def _slices_cost(part_slices, idx):
  """LPT cost key for scatter: bytes of text the partition will read.
  Deterministic (pure function of the partition plan), so every rank and
  worker count derives the same enqueue order."""
  try:
    total = sum(int(s.end) - int(s.start) for s in part_slices)
  except (AttributeError, TypeError):
    return idx
  return total if total > 0 else idx


def shuffle_corpus(executor, corpus, spill_dir, seed, num_targets=None):
  """Shuffle a :class:`~lddl_tpu_torch.preprocess.readers.Corpus` (honoring its
  per-partition subsampling) into ``num_targets`` on-disk partitions.

  Each task carries only its own partition's slices (plus scalar sampling
  parameters), so scatter payloads stay O(1) in the number of partitions.
  """
  if num_targets is None:
    num_targets = corpus.num_partitions
  task = functools.partial(
      _scatter_corpus_task,
      num_targets=num_targets,
      spill_dir=spill_dir,
      seed=seed,
      sample_ratio=corpus.sample_ratio,
      sample_seed=corpus.sample_seed,
      delimiter=corpus.delimiter)
  executor.map(task, list(corpus.partitions), gather=False,
               label='scatter', cost_key=_slices_cost)
  return num_targets


def _scatter_slices_task(part_slices, idx, num_targets, spill_dir, seed):
  lines = (line for s in part_slices for line in read_lines(s))
  return scatter_partition(lines, idx, num_targets, spill_dir, seed)


def shuffle_lines(executor, partitions, spill_dir, seed, num_targets=None):
  """Shuffle all lines of ``partitions`` into ``num_targets`` shuffled
  output partitions on disk. Returns the number of output partitions.

  ``partitions`` is a list of :class:`TextSlice` lists/iterables as produced
  by :func:`plan_text_partitions` (each element = one partition's slices).
  """
  partitions = list(partitions)
  if num_targets is None:
    num_targets = len(partitions)
  task = functools.partial(
      _scatter_slices_task,
      num_targets=num_targets,
      spill_dir=spill_dir,
      seed=seed)
  # map(gather=False) ends with a barrier, so all spills are visible to all
  # ranks when this returns.
  executor.map(task, partitions, gather=False, label='scatter',
               cost_key=_slices_cost)
  return num_targets
