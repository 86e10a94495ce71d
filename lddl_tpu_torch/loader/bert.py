"""BERT pretraining data loader: the loader's public entry point.

Copied from :mod:`lddl_tpu.loader.bert` (pure numpy and stdlib; the port
keeps its own copy and imports nothing of ``lddl_tpu``). Yields numpy
batch dicts, the contract the train loop's feed takes:

  input_ids, token_type_ids, attention_mask: int32 [batch, seq_len]
  labels: int32 [batch, seq_len]   (-100 = not an MLM target)
  next_sentence_labels: int32 [batch]   (1 = random next)

Each bin pads to its fixed bound ``align(bin_size * (bin_id + 1))``, so a
run sees exactly ``num_bins`` batch shapes (one captured step each); the
collate is vectorized, and its 80/10/10 dynamic mask is keyed by (seed,
epoch, rank, step), so a resumed run draws the same masks. Over the same
shards, the port's batches equal the JAX package's byte for byte.

``num_workers > 0`` collates in worker processes
(:mod:`.workers`: the same batches, byte for byte), and with
``LDDL_LEDGER`` on, :meth:`BertPretrainLoader.__iter__` records each
batch's ``collate`` fingerprint (:mod:`..telemetry.ledger`). Not ported
yet, and not accepted as arguments: hub tokenizers (``tokenizer_name``).
The JAX package's :func:`build_pretrain_loader` also starts the live
monitor; the port's does not (every worker process and data server
rebuilds the loader): :meth:`~lddl_tpu_torch.training.pretrain.
TrainLoop.run` starts it.

This module, like the rest of the worker's import chain, imports no
torch.
"""

import logging
import time

import numpy as np

from ..core import faults
from ..core.log import DatasetLogger, warn_once
from ..core.utils import (deserialize_np_array, get_all_bin_ids,
                          get_all_parquets_under, get_file_paths_for_bin_id)
from ..telemetry.ledger import fingerprint_batch, first_ndarray, get_ledger
from ..telemetry.metrics import get_telemetry
from ..telemetry.trace import get_tracer
from .binned import BinnedIterator
from .columnar import gather_numeric, gather_token_counts, materialize_rows
from .dataset import ParquetShardDataset
from .workers import MultiprocessLoader

IGNORE_INDEX = -100


def _align_up(n, align):
  return ((n + align - 1) // align) * align


def dynamic_mask_tokens(input_ids, special_mask, *, mlm_probability,
                        vocab_size, mask_id, base_seed, dp_rank, epoch,
                        step):
  """Vectorized 80/10/10 dynamic masking (reference
  ``torch/bert.py:152-196``), deterministically keyed by
  (seed, epoch, rank, step) so every resume reproduces the identical
  masks. Shared by the BERT and packed long-context collates."""
  rng = np.random.Generator(
      np.random.Philox(
          key=[
              np.uint64(base_seed) << np.uint64(32) | np.uint64(epoch),
              np.uint64(dp_rank) << np.uint64(32) | np.uint64(step),
          ]))
  prob = rng.random(input_ids.shape)
  masked = (prob < mlm_probability) & ~special_mask
  labels = np.where(masked, input_ids, IGNORE_INDEX).astype(np.int32)
  decide = rng.random(input_ids.shape)
  out = input_ids.copy()
  out[masked & (decide < 0.8)] = mask_id
  random_sel = masked & (decide >= 0.8) & (decide < 0.9)
  out[random_sel] = rng.integers(
      0, vocab_size, size=int(random_sel.sum()), dtype=np.int32)
  return out, labels


class BertCollate:
  """Rows -> fixed-shape numpy batch dict."""

  def __init__(self, tokenizer, masking='dynamic', mlm_probability=0.15,
               base_seed=12345, dp_rank=0):
    self._tok = tokenizer
    self._masking = masking
    self._mlm_prob = mlm_probability
    self._base_seed = base_seed
    self._dp_rank = dp_rank
    # Resolved through the tokenizer's own special-token config, not
    # hardcoded names, so BPE vocabs (<s>/</s>, e.g. codebert-base) work.
    self._cls_id = tokenizer.cls_token_id
    self._sep_id = tokenizer.sep_token_id
    self._mask_id = tokenizer.mask_token_id
    if tokenizer.pad_token_id is None:
      warn_once(
          'tokenizer defines no pad token; padding input_ids with id 0 — '
          'for BPE vocabs id 0 is a real token (<s>), harmless for loss '
          '(attention_mask covers pads) but visible to consumers '
          'inspecting input_ids')
      self._pad_id = 0
    else:
      self._pad_id = tokenizer.pad_token_id
    self._vocab_size = tokenizer.vocab_size

  def __call__(self, rows, seq_len, epoch, step):
    """Fully vectorized: no per-row Python inner loop. One id-conversion
    call per batch, then ragged scatter via ``np.repeat``/cumsum index
    arithmetic builds every array in whole-batch numpy ops."""
    tele = get_telemetry()
    tracer = get_tracer()
    t0 = time.monotonic() if (tele.enabled or tracer.enabled) else 0.0
    n = len(rows)
    arange_n = np.arange(n)
    cols = np.arange(seq_len)

    # Segment lengths without per-row splits: segments are single-space
    # joined by the preprocess writer, so token count = space count + 1.
    # Columnar rows get the counts from one numpy count per block
    # (gather_* return None on plain-dict rows — the fallback keeps the
    # collate usable standalone and byte-identical either way).
    a_strs = [row['A'] for row in rows]
    b_strs = [row['B'] for row in rows]
    na = gather_token_counts(rows, 'A')
    if na is None:
      na = np.fromiter((s.count(' ') + 1 for s in a_strs), np.int64, count=n)
    nb = gather_token_counts(rows, 'B')
    if nb is None:
      nb = np.fromiter((s.count(' ') + 1 for s in b_strs), np.int64, count=n)
    # One conversion for the whole batch's tokens (single join + split).
    flat_ids = np.asarray(
        self._tok.convert_tokens_to_ids(' '.join(a_strs + b_strs).split()),
        dtype=np.int32)
    if flat_ids.shape[0] != int(na.sum() + nb.sum()):
      raise AssertionError(
          'A/B segments are not non-empty single-space-joined token '
          'strings; shards were not written by this preprocessor')

    total = na + nb + 3
    worst = int(total.max(initial=0))
    if worst > seq_len:
      raise AssertionError(
          f'sample of {worst} tokens exceeds static seq_len {seq_len}; '
          'bin assignment or max_seq_length is inconsistent')

    # Ragged destination indices: row r's A tokens land at columns
    # [1, 1+na), its B tokens at [2+na, 2+na+nb).
    n_a_total = int(na.sum())
    ids_a, ids_b = flat_ids[:n_a_total], flat_ids[n_a_total:]
    row_a = np.repeat(arange_n, na)
    col_a = np.arange(ids_a.shape[0]) - np.repeat(np.cumsum(na) - na, na) + 1
    row_b = np.repeat(arange_n, nb)
    col_b = (np.arange(ids_b.shape[0]) - np.repeat(np.cumsum(nb) - nb, nb) +
             np.repeat(2 + na, nb))

    input_ids = np.full((n, seq_len), self._pad_id, dtype=np.int32)
    input_ids[row_a, col_a] = ids_a
    input_ids[row_b, col_b] = ids_b
    input_ids[:, 0] = self._cls_id
    input_ids[arange_n, 1 + na] = self._sep_id
    input_ids[arange_n, total - 1] = self._sep_id
    attention_mask = (cols < total[:, None]).astype(np.int32)
    token_type_ids = ((cols >= (2 + na)[:, None]) &
                      (cols < total[:, None])).astype(np.int32)
    nsp = gather_numeric(rows, 'is_random_next', np.int32)
    if nsp is None:
      nsp = np.fromiter((row['is_random_next'] for row in rows),
                        np.int32, count=n)

    labels = np.full((n, seq_len), IGNORE_INDEX, dtype=np.int32)
    if self._masking == 'static' and n and 'mask_delta_positions' in rows[0]:
      # Mask-delta shards: the A/B strings above are the UNMASKED base
      # pair; this sample's mask is stored as a packed per-copy delta.
      # Slice the copy's segment (mask_delta_copy comes from the
      # dataset's row expansion) and scatter new ids into input_ids and
      # the pre-mask originals into labels. The format stores no label
      # column at all: the label at a masked position IS the original
      # token, and input_ids holds exactly those original ids until the
      # delta is applied. Byte-identical to collating the materialized
      # form of the same corpus: token->id conversion is a bijection
      # over the vocab (the materialized path already relies on it),
      # masking never changes token counts, and the scatter targets are
      # exactly the positions the writer's kernel masked.
      pos_list, new_list = [], []
      for row in rows:
        ks = deserialize_np_array(row['mask_delta_k']).astype(np.int64)
        c = row['mask_delta_copy']
        if not 0 <= c < ks.shape[0]:
          raise AssertionError(
              f'mask_delta_copy {c} out of range for a row with '
              f'{ks.shape[0]} stored mask copies — corrupt delta shard or '
              'rows not expanded by ParquetShardDataset')
        s = int(ks[:c].sum())
        e = s + int(ks[c])
        pos_list.append(
            deserialize_np_array(row['mask_delta_positions'])[s:e])
        new_list.append(deserialize_np_array(row['mask_delta_new_ids'])[s:e])
      counts = np.fromiter((a.shape[0] for a in pos_list), np.int64, count=n)
      rr = np.repeat(arange_n, counts)
      cc = np.concatenate(pos_list).astype(np.int64)
      labels[rr, cc] = input_ids[rr, cc]
      input_ids[rr, cc] = np.concatenate(new_list).astype(np.int32)
    elif self._masking == 'static':
      pos_arrays = [
          deserialize_np_array(row['masked_lm_positions']) for row in rows
      ]
      counts = np.fromiter((a.shape[0] for a in pos_arrays), np.int64,
                           count=n)
      # Validate per row (not in aggregate: offsetting mismatches across
      # rows would silently cross-assign labels between rows).
      label_counts = gather_token_counts(rows, 'masked_lm_labels')
      if label_counts is None:
        label_counts = np.fromiter(
            (row['masked_lm_labels'].count(' ') + 1 for row in rows),
            np.int64, count=n)
      if not np.array_equal(label_counts, counts):
        bad = int(np.nonzero(label_counts != counts)[0][0])
        raise AssertionError(
            f'row {bad}: {int(counts[bad])} masked_lm_positions but '
            f'{int(label_counts[bad])} masked_lm_labels — corrupt '
            'static-masking columns')
      label_ids = np.asarray(
          self._tok.convert_tokens_to_ids(
              ' '.join(row['masked_lm_labels'] for row in rows).split()),
          dtype=np.int32)
      if label_ids.shape[0] != int(counts.sum()):
        raise AssertionError(
            'masked_lm_labels are not single-space-joined token strings')
      labels[np.repeat(arange_n, counts),
             np.concatenate(pos_arrays).astype(np.int64)] = label_ids
    elif self._masking == 'dynamic':
      special_mask = np.ones((n, seq_len), dtype=bool)  # pad/CLS/SEP stay True
      special_mask[row_a, col_a] = False
      special_mask[row_b, col_b] = False
      input_ids, labels = self._mask_tokens(input_ids, special_mask, epoch,
                                            step)
    if tele.enabled:
      # Per-bin latency: each static seq_len is its own compiled shape
      # downstream, so its collate cost is tracked under its own name.
      tele.histogram(f'loader.collate_seconds.s{seq_len}').observe(
          time.monotonic() - t0)
      tele.counter('loader.batches').add(1)
      tele.counter('loader.collated_rows').add(n)
      # Goodput accounting per bin: real (attended) tokens vs the padded
      # token slots the batch physically ships — the live padding-
      # efficiency meter binning claims to maximize.
      tele.counter(f'loader.tokens_real.s{seq_len}').add(int(total.sum()))
      tele.counter(f'loader.tokens_padded.s{seq_len}').add(n * seq_len)
    if tracer.enabled:
      tracer.complete(f'loader.collate.s{seq_len}', t0,
                      time.monotonic() - t0, args={'step': step, 'rows': n})
    return {
        'input_ids': input_ids,
        'token_type_ids': token_type_ids,
        'attention_mask': attention_mask,
        'labels': labels,
        'next_sentence_labels': nsp,
    }

  def _mask_tokens(self, input_ids, special_mask, epoch, step):
    return dynamic_mask_tokens(
        input_ids, special_mask, mlm_probability=self._mlm_prob,
        vocab_size=self._vocab_size, mask_id=self._mask_id,
        base_seed=self._base_seed, dp_rank=self._dp_rank, epoch=epoch,
        step=step)


def split_into_micro_batches(batch, micro_batch_size):
  """Split a global-per-rank batch into Megatron-style micro-batch dicts

  with ``loss_mask`` (reference ``torch_mp/bert.py:100-167``): keys
  ``text/types/padding_mask/is_random/loss_mask``.
  """
  n = batch['input_ids'].shape[0]
  if n % micro_batch_size != 0:
    raise AssertionError(
        f'batch of {n} not divisible by micro batch {micro_batch_size}')
  micros = []
  for s in range(0, n, micro_batch_size):
    e = s + micro_batch_size
    micros.append({
        'text': batch['input_ids'][s:e],
        'types': batch['token_type_ids'][s:e],
        'padding_mask': batch['attention_mask'][s:e],
        'is_random': batch['next_sentence_labels'][s:e],
        'labels': batch['labels'][s:e],
        'loss_mask':
            (batch['labels'][s:e] != IGNORE_INDEX).astype(np.float32),
    })
  return micros


class BertPretrainLoader:
  """Epoch-oriented iterable; each ``__iter__`` runs one epoch and advances

  the epoch counter (reference semantics: ``torch/dataloader.py:44-50``).
  """

  def __init__(self, datasets, collate, batch_size_per_rank,
               seqlen_of_bin, base_seed, start_epoch=0, batches_consumed=0,
               micro_batch_size=None):
    self._datasets = datasets
    self._collate = collate
    self._batch = batch_size_per_rank
    self._seqlen_of_bin = seqlen_of_bin
    self._base_seed = base_seed
    self.epoch = start_epoch
    self._batches_consumed = batches_consumed
    # Batches an exact seek skips at the head of the next epoch's
    # uninterrupted stream (their draws run, their collates do not).
    self._skip = 0
    self._micro = micro_batch_size

  @property
  def batch_size(self):
    """Per-rank samples per yielded batch."""
    return self._batch

  def __len__(self):
    """Batches the *next* ``__iter__`` will yield (short on a resumed
    mid-epoch, full afterwards) — keeps len-driven LR schedules and
    progress bars honest across resumes."""
    full = sum(d.samples_per_rank_per_epoch // self._batch
               for d in self._datasets)
    return full - self._batches_consumed - self._skip

  @property
  def samples_per_epoch(self):
    return sum(d.total_samples_per_epoch for d in self._datasets)

  @property
  def batches_per_epoch(self):
    """Batches one full epoch yields on this rank (drop-last)."""
    return sum(d.samples_per_rank_per_epoch // self._batch
               for d in self._datasets)

  def seek(self, epoch, batch_index, exact=False):
    """Position the loader at ledger coordinate ``(epoch, batch_index)``.

    The next ``__iter__``/``iter_steps`` resumes epoch ``epoch`` with
    batch ``batch_index`` as its first step — collate step counters and
    dynamic-mask Philox keys line up with the ledger's collate key
    ``(epoch, index=batch_index)``. This is the positioning contract of
    resume (:func:`lddl_tpu_torch.training.elastic.reseek_loader`, which
    :meth:`~lddl_tpu_torch.training.pretrain.TrainLoop.restore` calls).
    Returns ``self`` for chaining.

    A mid-epoch seek carries *resume* semantics: the skipped draws
    reposition the datasets but the shuffle buffer restarts fresh, so
    batch contents are not byte-identical to the uninterrupted stream
    (loader/binned.py). ``exact=True`` positions byte-exactly instead:
    the next iteration drives the epoch's draws from its start and skips
    the batches before ``batch_index`` without collating them, so it
    yields the uninterrupted stream's batches (rematerialization, step
    replay, the data service's local fallback).
    """
    epoch, batch_index = int(epoch), int(batch_index)
    if epoch < 0 or batch_index < 0:
      raise ValueError(f'seek({epoch}, {batch_index}): coordinates must '
                       'be non-negative')
    full = self.batches_per_epoch
    if batch_index > full:  # == full is a valid position (epoch drained)
      raise ValueError(f'seek({epoch}, {batch_index}): epoch has only '
                       f'{full} batches on this rank')
    self.epoch = epoch
    self._batches_consumed = 0 if exact else batch_index
    self._skip = batch_index if exact else 0
    return self

  def tell(self):
    """``(epoch, batch_index)`` the next iteration starts from — the
    inverse of :meth:`seek`."""
    return self.epoch, self._batches_consumed + self._skip

  def coordinate_of_batch(self, ordinal):
    """Collate key ``(epoch, index)`` of this rank's ``ordinal``-th batch
    since the run began — the ledger coordinate a given global train
    step consumed (one batch per rank per step)."""
    full = self.batches_per_epoch
    return ordinal // full, ordinal % full

  def _make_iterator(self):
    it = BinnedIterator(
        self._datasets,
        self._batch,
        base_seed=self._base_seed,
        epoch=self.epoch,
        batches_consumed=self._batches_consumed,
        seqlen_of_bin=self._seqlen_of_bin)
    self._batches_consumed = 0
    self._skip = 0
    return it

  def iter_steps(self, step_shard=(0, 1)):
    """Yield ``(step, batch)`` for this epoch, ``step`` counting from the
    epoch's first batch (a resumed epoch starts at its seek offset),
    collating only the steps of this shard.

    ``step_shard=(w, W)`` advances the FULL deterministic row stream (the
    shuffle-buffer sequence is position-dependent, so every worker must
    replay it identically) but runs the expensive collate only for steps
    with ``step % W == w`` — the unit of within-rank worker parallelism
    (:mod:`.workers`). Sharding by step index keeps the produced batches
    byte-identical for every W.
    """
    # Capture the resume offset before _make_iterator() clears it: the
    # collate step counter must continue from where the interrupted run
    # stopped, or dynamic-mask Philox keys (keyed on step) would diverge
    # from the uninterrupted run.
    consumed, skip = self._batches_consumed, self._skip
    it = self._make_iterator()
    epoch = self.epoch
    w, num_shards = step_shard
    for step, (bin_idx, rows) in enumerate(it, start=consumed):
      if step < skip or step % num_shards != w:
        continue
      batch = self._collate(rows, self._seqlen_of_bin(bin_idx), epoch, step)
      if self._micro is not None:
        batch = split_into_micro_batches(batch, self._micro)
      yield step, batch
    self.epoch += 1

  def __iter__(self):
    # The collate boundary for serial consumption (num_workers=0):
    # fingerprint each batch in delivery order, keyed (epoch, index) —
    # the exact coordinates a resumed run replays. The worker path
    # records the same boundary at its own delivery point (workers.py),
    # never here: workers iterate iter_steps() directly, so no batch is
    # ever recorded twice.
    ledger = get_ledger()
    epoch = self.epoch
    for step, batch in self.iter_steps():
      if ledger.enabled:
        arr = first_ndarray(batch)
        if arr is not None:
          faults.corrupt_bytes('ledger.corrupt', arr.data,
                               rank=ledger.rank, epoch=epoch, index=step)
        ledger.record('collate', fingerprint_batch(batch), epoch=epoch,
                      index=step)
      yield batch


def build_pretrain_loader(
    path,
    collate,
    dp_rank=0,
    dp_world_size=1,
    batch_size_per_rank=64,
    max_seq_length=512,
    bin_size=None,
    sequence_length_alignment=8,
    shuffle_buffer_size=16384,
    shuffle_buffer_warmup_factor=16,
    base_seed=12345,
    start_epoch=0,
    samples_seen=0,
    micro_batch_size=None,
    comm=None,
    log_dir=None,
    log_level=None,
):
  """Shared wiring for pretrain loaders: shard/bin discovery, per-bin
  datasets, static seq-len mapping, samples_seen resume placement, and the
  scoped :class:`~lddl_tpu_torch.core.log.DatasetLogger` (reference
  constructs it inside the factory too, ``lddl/torch/bert.py:367-372``)."""
  # One process: the loader's dp_rank stands where the JAX package asks
  # discover_topology(comm), and no live monitor is started (the train
  # loop starts it).
  logger = DatasetLogger(
      log_dir=log_dir,
      log_level=logging.WARNING if log_level is None else log_level,
      rank=dp_rank,
      local_rank=dp_rank,
      node_rank=0)
  files = get_all_parquets_under(path)
  if not files:
    raise ValueError(f'no parquet shards under {path}')
  bin_ids = get_all_bin_ids(files)
  mk = lambda fs: ParquetShardDataset(
      fs,
      dp_rank=dp_rank,
      dp_world_size=dp_world_size,
      shuffle_buffer_size=shuffle_buffer_size,
      shuffle_buffer_warmup_factor=shuffle_buffer_warmup_factor,
      base_seed=base_seed,
      comm=comm,
      logger=logger.to('rank'))
  if bin_ids:
    if bin_size is None:
      raise ValueError('binned shards require bin_size')
    datasets = [mk(get_file_paths_for_bin_id(files, b)) for b in bin_ids]
    seqlen_of_bin = lambda i: min(
        _align_up(bin_size * (bin_ids[i] + 1), sequence_length_alignment),
        max_seq_length)
  else:
    datasets = [mk(files)]
    seqlen_of_bin = lambda i: max_seq_length

  # Sample-loss accounting, loudly (reference torch/datasets.py:150-156
  # prints lost samples at init; the drop-last tail was silent there).
  node_log = logger.to('node')
  total = sum(d.total_samples_per_epoch for d in datasets)
  dropped = sum(
      (d.samples_per_rank_per_epoch % batch_size_per_rank) * dp_world_size
      for d in datasets)
  node_log.info(
      'dataset under %s: %d files across %d bin(s), %d samples/epoch '
      '(global)', path, len(files), len(datasets), total)
  if dropped:
    node_log.warning(
        'drop-last tail: %d of %d samples/epoch (%.3f%%) are dropped to '
        'keep batch shapes static (up to batch_size-1 per bin per rank)',
        dropped, total, 100.0 * dropped / max(total, 1))

  epoch, consumed = start_epoch, 0
  if samples_seen:
    epoch, consumed = BinnedIterator.epoch_and_offset_of(
        datasets, batch_size_per_rank, dp_world_size, samples_seen)
    epoch += start_epoch
  return BertPretrainLoader(
      datasets,
      collate,
      batch_size_per_rank,
      seqlen_of_bin,
      base_seed,
      start_epoch=epoch,
      batches_consumed=consumed,
      micro_batch_size=micro_batch_size)


def get_bert_pretrain_data_loader(
    path,
    dp_rank=0,
    dp_world_size=1,
    batch_size_per_rank=64,
    vocab_file=None,
    masking='dynamic',
    mlm_probability=0.15,
    max_seq_length=512,
    bin_size=None,
    sequence_length_alignment=8,
    shuffle_buffer_size=16384,
    shuffle_buffer_warmup_factor=16,
    base_seed=12345,
    start_epoch=0,
    samples_seen=0,
    micro_batch_size=None,
    comm=None,
    tokenizer=None,
    log_dir=None,
    log_level=None,
    return_raw_samples=False,
    num_workers=0,
    transport=None,
    queue_depth=None,
    zero_copy=None,
    slot_bytes=None,
):
  """Build the BERT pretraining loader over a balanced shard directory.

  ``masking``: 'dynamic' (mask at load time, reference default) or
  'static' (use the positions/labels stored by ``--masking`` preprocess).
  ``bin_size``: token width of each bin; required when ``path`` holds
  binned shards (``*.parquet_<bin>``). ``samples_seen``: global samples
  already consumed, for mid-epoch resume (torch_mp parity).
  ``return_raw_samples``: yield the raw row dicts (lists per batch)
  instead of collated arrays — the reference's debug/eyeballing mode
  (``torch/bert.py:253``).
  ``tokenizer``: anything with the special ids, ``vocab_size`` and
  ``convert_tokens_to_ids``; by default a
  :class:`~lddl_tpu_torch.tokenization.wordpiece.BertVocab` over
  ``vocab_file``.
  ``num_workers``: collate in this many worker processes; the batches
  are byte-identical to ``num_workers=0`` (:mod:`.workers`). Workers
  rebuild the tokenizer from ``vocab_file``, so a live ``tokenizer``
  raises. ``transport``/``queue_depth``/``zero_copy``/``slot_bytes``:
  the worker path's batch handoff (:class:`~.workers.MultiprocessLoader`),
  the first three defaulting from their ``LDDL_LOADER_*`` knobs; ignored
  when ``num_workers=0``.
  """
  if num_workers:
    return MultiprocessLoader.from_params(
        locals(), ('lddl_tpu_torch.loader.bert',
                   'get_bert_pretrain_data_loader'))
  if return_raw_samples:
    collate = lambda rows, seq_len, epoch, step: materialize_rows(rows)
    return build_pretrain_loader(
        path, collate, dp_rank=dp_rank, dp_world_size=dp_world_size,
        batch_size_per_rank=batch_size_per_rank,
        max_seq_length=max_seq_length, bin_size=bin_size,
        sequence_length_alignment=sequence_length_alignment,
        shuffle_buffer_size=shuffle_buffer_size,
        shuffle_buffer_warmup_factor=shuffle_buffer_warmup_factor,
        base_seed=base_seed, start_epoch=start_epoch,
        samples_seen=samples_seen, comm=comm, log_dir=log_dir,
        log_level=log_level)
  if tokenizer is None:
    from ..tokenization.wordpiece import load_bert_tokenizer
    tokenizer = load_bert_tokenizer(vocab_file)
  collate = BertCollate(
      tokenizer,
      masking=masking,
      mlm_probability=mlm_probability,
      base_seed=base_seed,
      dp_rank=dp_rank)
  return build_pretrain_loader(
      path,
      collate,
      dp_rank=dp_rank,
      dp_world_size=dp_world_size,
      batch_size_per_rank=batch_size_per_rank,
      max_seq_length=max_seq_length,
      bin_size=bin_size,
      sequence_length_alignment=sequence_length_alignment,
      shuffle_buffer_size=shuffle_buffer_size,
      shuffle_buffer_warmup_factor=shuffle_buffer_warmup_factor,
      base_seed=base_seed,
      start_epoch=start_epoch,
      samples_seen=samples_seen,
      micro_batch_size=micro_batch_size,
      comm=comm,
      log_dir=log_dir,
      log_level=log_level)
