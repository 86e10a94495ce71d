"""Streaming dataset over balanced Parquet shards.

Copied from :mod:`lddl_tpu.loader.dataset` (``count_samples`` and
``ParquetShardDataset``, ``lddl_tpu/loader/dataset.py:44-229``), reading
shards with the port's own reader
(:class:`lddl_tpu_torch.pipeline.parquet_io.ParquetFile`) where the JAX
package uses ``pyarrow.parquet.ParquetFile``:

  - sample counts from the ``.num_samples.json`` cache, else the footers;
  - hard preconditions: shards balanced to within one sample, and a file
    count divisible by the data-parallel world;
  - truncation of every file to the smallest count, with a warning;
  - a world-identical file permutation per epoch, then
    ``files[dp_rank::dp_world_size]``;
  - the streaming shuffle of :class:`ShuffleBuffer`;
  - mid-epoch resume, skipping whole files and then rows of the first;
  - the expansion of mask-delta rows into ``duplicate_factor`` samples.

Rows stay columnar: the stream yields :class:`RowView` handles over the
decoded record batches. Every draw matches the JAX package's, so both
loaders deliver the same samples in the same order.
"""

import os

from ..balance import load_num_samples_cache
from ..core.log import warn_once
from ..core.random import rng_from_key
from ..core.utils import count_parquet_samples_strided
from ..pipeline.parquet_io import ParquetFile
from ..pipeline.shard_format import DELTA, scan_shard_format
from ..telemetry.metrics import get_telemetry
from ..telemetry.trace import get_tracer
from .columnar import ColumnarBlock, DeltaRowView, RowView
from .shuffle_buffer import ShuffleBuffer


def count_samples(file_paths, comm=None):
  """Per-file sample counts: ``.num_samples.json`` cache fast path, else the

  shared rank-strided footer scan + all-reduce (reference
  ``torch/datasets.py:161-195``). Returns ``{path: num_samples}``.
  """
  if file_paths:
    cache = load_num_samples_cache(os.path.dirname(file_paths[0]))
    if cache is not None:
      by_base = {os.path.basename(p): p for p in file_paths}
      if all(b in cache for b in by_base):
        return {p: cache[b] for b, p in by_base.items()}
  counts = count_parquet_samples_strided(file_paths, comm)
  return {p: c for p, c in zip(file_paths, counts)}


class ParquetShardDataset:
  """Iterable stream of sample dicts from one set of balanced shards.

  One instance per bin (or one total when unbinned). Re-iterable; each
  ``iter_epoch(epoch)`` call derives all randomness from
  ``(base_seed, epoch, dp_rank)`` so every process can independently
  reconstruct the exact stream.
  """

  def __init__(
      self,
      file_paths,
      dp_rank=0,
      dp_world_size=1,
      shuffle_buffer_size=16384,
      shuffle_buffer_warmup_factor=16,
      base_seed=12345,
      comm=None,
      logger=None,
  ):
    if not file_paths:
      raise ValueError('no shard files given')
    self._files = sorted(file_paths)
    self._dp_rank = dp_rank
    self._dp_world_size = dp_world_size
    self._shuffle_buffer_size = shuffle_buffer_size
    self._shuffle_buffer_warmup_factor = shuffle_buffer_warmup_factor
    self._base_seed = base_seed
    self._log = logger

    # Shard format: a mask-delta corpus expands each physical row into
    # ``duplicate_factor`` logical samples (one per stored mask-delta
    # copy). The scan also refuses mixed materialized/delta file sets
    # loudly — their sample arithmetic is incompatible.
    self._shard_format, dup = scan_shard_format(self._files)
    self._expansion = dup if self._shard_format == DELTA else 1

    counts = count_samples(self._files, comm=comm)
    values = list(counts.values())
    lo, hi = min(values), max(values)
    if hi - lo > 1:
      raise AssertionError(
          f'shards not balanced (min={lo}, max={hi}); run the load balancer '
          '(reference asserts the same: lddl/torch/datasets.py:145-147)')
    if len(self._files) % dp_world_size != 0:
      raise AssertionError(
          f'{len(self._files)} files not divisible by dp world size '
          f'{dp_world_size}')
    # Truncate every file to the min count so each rank sees exactly the
    # same number of samples (reference torch/datasets.py:150-156).
    # Counts (and truncation) are physical rows; a truncated delta row
    # drops its whole group of copies, so expansion stays atomic.
    self._rows_per_file = lo
    self._samples_per_file = lo * self._expansion
    lost = sum(values) - lo * len(self._files)
    if lost > 0:
      msg = (f'truncating shards to {lo} samples each: {lost} samples lost '
             f'out of {sum(values)}')
      # Once per process: re-instantiated datasets (per bin, per epoch
      # resume) would otherwise repeat the identical truncation warning.
      warn_once(msg, logger=self._log)

  @property
  def num_files(self):
    return len(self._files)

  @property
  def shard_format(self):
    return self._shard_format

  @property
  def duplicate_factor(self):
    """Logical samples per physical row (1 for materialized shards)."""
    return self._expansion

  @property
  def samples_per_file(self):
    """Logical samples per file (physical rows × delta expansion)."""
    return self._samples_per_file

  @property
  def total_samples_per_epoch(self):
    """Global samples per epoch after truncation (all dp ranks)."""
    return self._samples_per_file * len(self._files)

  @property
  def samples_per_rank_per_epoch(self):
    return self.total_samples_per_epoch // self._dp_world_size

  def rank_files_for_epoch(self, epoch):
    """World-identical permutation, then this rank's strided slice."""
    files = list(self._files)
    rng_from_key(self._base_seed, 'perm', epoch).shuffle(files)
    return files[self._dp_rank::self._dp_world_size]

  def iter_epoch(self, epoch, samples_to_skip=0):
    """Yield this rank's shuffled sample stream for ``epoch``.

    ``samples_to_skip`` skips that many samples of this rank's stream at
    file granularity + a slice of the first partial file — the
    ``samples_seen`` resume path (reference torch_mp/datasets.py:87-98).
    Note the skip happens *before* shuffle-buffer randomization, matching
    the reference: resume replays the identical stream suffix.
    """
    files = self.rank_files_for_epoch(epoch)
    skip_files, skip_rows, skip_copies = (0, 0, 0)
    if samples_to_skip:
      skip_files = samples_to_skip // self._samples_per_file
      rem = samples_to_skip % self._samples_per_file
      # Delta shards: a physical row is duplicate_factor logical samples,
      # so a resume point may land mid-group — skip whole rows, then the
      # leading copies of the first emitted row.
      skip_rows = rem // self._expansion
      skip_copies = rem % self._expansion
    rng = rng_from_key(self._base_seed, 'shuffle', epoch, self._dp_rank)
    buf = ShuffleBuffer(self._shuffle_buffer_size,
                        self._shuffle_buffer_warmup_factor, rng)
    return buf.shuffle_stream(
        self._row_stream(files, skip_files, skip_rows, skip_copies))

  def _row_stream(self, files, skip_files, skip_rows, skip_copies=0):
    # Telemetry handles are fetched once per stream (not per event): in
    # disabled mode they are the shared no-op singletons, so the per-row
    # cost is one empty method call.
    tele = get_telemetry()
    tracer = get_tracer()
    rows_c = tele.counter('loader.rows')
    decode_h = tele.histogram('loader.read_batch_seconds')
    expansion = self._expansion
    delta = self._shard_format == DELTA
    for fi, path in enumerate(files):
      if fi < skip_files:
        continue
      with ParquetFile(path) as pf:
        remaining = self._rows_per_file
        to_skip = skip_rows if fi == skip_files else 0
        batches = pf.iter_batches()
        while remaining > 0:
          with decode_h.time(), tracer.span('loader.read_batch'):
            batch = next(batches, None)
          if batch is None:
            break
          take = min(batch.num_rows, remaining)
          remaining -= take
          if to_skip >= take:
            to_skip -= take
            continue
          # Columnar handoff: no per-row dicts, no eager conversion — the
          # block converts a column at most once, on first collate-time
          # access (RowView.__getitem__ / the gather_* fast paths).
          block = ColumnarBlock(batch)
          start, to_skip = to_skip, 0
          if not delta:
            rows_c.add(take - start)
            for r in range(start, take):
              yield RowView(block, r)
          else:
            # Even dup=1 delta rows need the copy index: the collate
            # slices the packed delta columns by `mask_delta_copy`.
            # Delta shards: expand each physical row into its
            # duplicate_factor logical copies, in copy order — the same
            # order the materialized format stores them, which is what
            # keeps the two formats' delivered streams identical.
            rows_c.add((take - start) * expansion - skip_copies)
            for r in range(start, take):
              first_copy, skip_copies = skip_copies, 0
              for c in range(first_copy, expansion):
                yield DeltaRowView(block, r, c)
