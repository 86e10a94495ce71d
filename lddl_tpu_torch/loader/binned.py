"""Zero-communication binned batch iteration.

Copied from :mod:`lddl_tpu.loader.binned` (``BinnedIterator``, its
``epoch_and_offset_of`` and ``_BatchChunker``; reference
``lddl/torch/dataloader.py:32-105`` and ``torch_mp/dataloader.py:84-133``):

  - every rank draws the next bin from a weighted ``choices`` over the
    remaining batch counts per bin; the RNG state evolves the same on all
    ranks, so they agree on the bin (and the step's shape) with no
    communication;
  - exact drain: after an epoch every bin iterator must be exhausted;
  - ``samples_seen`` fast-forward for mid-epoch resume, replaying the
    draws to find each bin's skip count;
  - ``next_seqlen()``, the next batch's sequence length without
    materializing it.
"""

from ..core.random import choices, get_state


class BinnedIterator:
  """Iterates (bin_id, list_of_rows) batches for one epoch.

  Rows are whatever the datasets stream — columnar
  :class:`~lddl_tpu_torch.loader.columnar.RowView` handles in the normal
  path — and pass through untouched: bin draws depend only on remaining batch
  counts, never on row contents, so the handle/dict distinction cannot
  perturb the cross-rank bin agreement or the delivered sample order.

  ``datasets``: list of :class:`ParquetShardDataset`, one per bin (a
  single-element list for unbinned data). Each bin contributes
  ``samples_per_rank_per_epoch // samples_per_batch_per_rank`` full
  batches; a sub-batch leftover per bin is dropped at epoch end, the same
  drop-leftovers semantics as the reference's end-of-epoch condition
  (``torch_mp/dataloader.py:105``). Leftovers are deterministic across
  ranks (all ranks truncate identically), so static batch shapes hold.

  ``batches_consumed``: global batches already consumed *this epoch* (for
  mid-epoch resume); the constructor replays that many weighted draws so
  the RNG state, remaining counts, and per-bin skip offsets all line up
  with where the interrupted run stopped.
  """

  def __init__(self,
               datasets,
               samples_per_batch_per_rank,
               base_seed=12345,
               epoch=0,
               batches_consumed=0,
               seqlen_of_bin=None):
    self._datasets = datasets
    self._batch = samples_per_batch_per_rank
    self._base_seed = base_seed
    self._epoch = epoch
    self._seqlen_of_bin = seqlen_of_bin
    self._remaining = [
        d.samples_per_rank_per_epoch // self._batch for d in datasets
    ]
    self._rng_state = get_state(f'{base_seed}:bins:{epoch}')
    self._pending_bin = None
    skip = [0] * len(datasets)
    for _ in range(batches_consumed):
      b = self._draw()
      self._remaining[b] -= 1
      skip[b] += self._batch
    self._iters = [
        _BatchChunker(d.iter_epoch(epoch, samples_to_skip=s), self._batch)
        for d, s in zip(datasets, skip)
    ]

  @classmethod
  def epoch_and_offset_of(cls, datasets, samples_per_batch_per_rank,
                          dp_world_size, samples_seen):
    """Map a global ``samples_seen`` counter to (epoch, batches_consumed).

    ``samples_seen`` counts global samples consumed since training start
    (reference ``torch_mp/bert.py:426-456`` computes the same split).
    The result is exactly the coordinate the public
    :meth:`~lddl_tpu_torch.loader.bert.BertPretrainLoader.seek` contract takes
    — this arithmetic is the bridge between the trainer's sample counter
    and the ledger's ``(epoch, index)`` collate keys.
    """
    global_batch = samples_per_batch_per_rank * dp_world_size
    batches_per_epoch = sum(
        d.samples_per_rank_per_epoch // samples_per_batch_per_rank
        for d in datasets)
    consumed_per_epoch = batches_per_epoch * global_batch
    if consumed_per_epoch == 0:
      raise ValueError(
          'dataset yields zero full batches per epoch (every bin holds '
          f'fewer than {samples_per_batch_per_rank} samples per rank); '
          f'cannot map samples_seen={samples_seen} to an epoch offset')
    return (samples_seen // consumed_per_epoch,
            (samples_seen % consumed_per_epoch) // global_batch)

  def __len__(self):
    return sum(self._remaining)

  @property
  def remaining_batches(self):
    return list(self._remaining)

  def _draw(self):
    if self._pending_bin is not None:
      b, self._pending_bin = self._pending_bin, None
      return b
    (b,), self._rng_state = choices(
        range(len(self._remaining)),
        weights=self._remaining,
        rng_state=self._rng_state)
    return b

  def next_seqlen(self):
    """Sequence length of the *next* batch, without materializing it;
    None once the epoch is exhausted (the lookahead-past-the-end call
    every pipeline scheduler makes)."""
    if sum(self._remaining) == 0 and self._pending_bin is None:
      return None
    if self._pending_bin is None:
      self._pending_bin = self._draw()
    if self._seqlen_of_bin is None:
      raise ValueError('seqlen_of_bin mapping not provided')
    return self._seqlen_of_bin(self._pending_bin)

  def __iter__(self):
    while sum(self._remaining) > 0:
      b = self._draw()
      self._remaining[b] -= 1
      rows = next(self._iters[b])
      yield b, rows
    # Exact drain: no bin may have a *full* batch left (a sub-batch
    # leftover is the documented drop-last tail).
    for b, it in enumerate(self._iters):
      try:
        next(it)
      except StopIteration:
        continue
      raise AssertionError(f'bin {b} not fully drained at epoch end')


class _BatchChunker:
  """Chunk a row stream into fixed-size lists, dropping a trailing

  partial batch (deterministic drop-last; static batch shapes)."""

  def __init__(self, stream, batch):
    self._stream = stream
    self._batch = batch

  def __next__(self):
    rows = []
    for row in self._stream:
      rows.append(row)
      if len(rows) == self._batch:
        return rows
    raise StopIteration

  def __iter__(self):
    return self
