"""The long-context packed-document loader (block-diagonal pretraining).

Copied from :mod:`lddl_tpu.loader.packed` (pure numpy; the port keeps
its own copy and imports nothing of ``lddl_tpu``). It reads the shards
:mod:`lddl_tpu.preprocess.packed` writes (``input_ids`` and
``doc_offsets``, np.save-wire uint16, ``[CLS] doc [SEP] doc [SEP] ...``
rows of up to 8k-32k tokens) and yields fixed-shape batch dicts:

  input_ids, token_type_ids, attention_mask: int32 [batch, seq_len]
  labels: int32 [batch, seq_len]  (-100 = not an MLM target; dynamic
          masking keyed (seed, epoch, rank, step))
  next_sentence_labels: int32 [batch]  (all zero: packed rows carry no NSP
          task)
  segment_ids: int32 [batch, seq_len]  (only with ``block_diagonal=True``:
          the document index per token, -1 on padding)

The collate never re-tokenizes: the id rows deserialize straight into the
padded batch matrix. ``num_workers > 0`` collates in worker processes
(:mod:`.workers`), byte for byte as serially.
"""

import time

import numpy as np

from ..core.utils import deserialize_np_array
from ..telemetry.metrics import get_telemetry
from ..telemetry.trace import get_tracer
from .bert import build_pretrain_loader, dynamic_mask_tokens
from .columnar import materialize_rows
from .workers import MultiprocessLoader


class PackedCollate:
  """Packed-id rows -> fixed-shape numpy batch dict."""

  def __init__(self, tokenizer, mlm_probability=0.15, base_seed=12345,
               dp_rank=0, block_diagonal=False):
    self._mlm_prob = mlm_probability
    self._base_seed = base_seed
    self._dp_rank = dp_rank
    self._block_diagonal = block_diagonal
    self._cls_id = tokenizer.cls_token_id
    self._sep_id = tokenizer.sep_token_id
    self._mask_id = tokenizer.mask_token_id
    self._pad_id = tokenizer.pad_token_id or 0
    self._vocab_size = tokenizer.vocab_size

  def __call__(self, rows, seq_len, epoch, step):
    tele = get_telemetry()
    tracer = get_tracer()
    t0 = time.monotonic() if (tele.enabled or tracer.enabled) else 0.0
    n = len(rows)
    ids_arrays = [
        deserialize_np_array(row['input_ids']).astype(np.int32)
        for row in rows
    ]
    lens = np.fromiter((a.shape[0] for a in ids_arrays), np.int64, count=n)
    worst = int(lens.max(initial=0))
    if worst > seq_len:
      raise AssertionError(
          f'packed row of {worst} tokens exceeds static seq_len {seq_len}; '
          'bin assignment or max_seq_length is inconsistent')
    flat = np.concatenate(ids_arrays) if n else np.zeros(0, np.int32)
    rowi = np.repeat(np.arange(n), lens)
    coli = np.arange(flat.shape[0]) - np.repeat(np.cumsum(lens) - lens, lens)
    input_ids = np.full((n, seq_len), self._pad_id, dtype=np.int32)
    input_ids[rowi, coli] = flat
    cols = np.arange(seq_len)
    attention_mask = (cols < lens[:, None]).astype(np.int32)
    # token_type_ids stay 0 (no NSP task in packed rows); the per-doc
    # structure travels in the separate segment_ids key below instead,
    # so the embedding table keeps its 2-type vocabulary.
    token_type_ids = np.zeros((n, seq_len), dtype=np.int32)
    segment_ids = None
    if self._block_diagonal:
      # Decode the stored doc_offsets wire column into a per-token doc
      # index (pads = -1). Offsets mark each piece's first token —
      # including continuation chunks of a split document, which get
      # their own id (their attention context really is row-local). The
      # leading [CLS] joins doc 0; each [SEP] trails the doc it closes.
      segment_ids = np.zeros((n, seq_len), dtype=np.int32)
      for i, row in enumerate(rows):
        marks = deserialize_np_array(row['doc_offsets']).astype(np.int64)
        if marks.shape[0] > 1:
          segment_ids[i, marks[1:]] = 1
      np.cumsum(segment_ids, axis=1, out=segment_ids)
      segment_ids[attention_mask == 0] = -1
    special_mask = ((input_ids == self._cls_id) |
                    (input_ids == self._sep_id) |
                    (attention_mask == 0))
    input_ids, labels = dynamic_mask_tokens(
        input_ids, special_mask, mlm_probability=self._mlm_prob,
        vocab_size=self._vocab_size, mask_id=self._mask_id,
        base_seed=self._base_seed, dp_rank=self._dp_rank, epoch=epoch,
        step=step)
    if tele.enabled:
      tele.histogram(f'loader.collate_seconds.s{seq_len}').observe(
          time.monotonic() - t0)
      tele.counter('loader.batches').add(1)
      tele.counter('loader.collated_rows').add(n)
      # Goodput: packed rows claim near-zero padding waste; measure it.
      tele.counter(f'loader.tokens_real.s{seq_len}').add(int(lens.sum()))
      tele.counter(f'loader.tokens_padded.s{seq_len}').add(n * seq_len)
    if tracer.enabled:
      tracer.complete(f'loader.collate.s{seq_len}', t0,
                      time.monotonic() - t0, args={'step': step, 'rows': n})
    batch = {
        'input_ids': input_ids,
        'token_type_ids': token_type_ids,
        'attention_mask': attention_mask,
        'labels': labels,
        'next_sentence_labels': np.zeros(n, dtype=np.int32),
    }
    if segment_ids is not None:
      batch['segment_ids'] = segment_ids
    return batch


def get_packed_pretrain_data_loader(
    path,
    dp_rank=0,
    dp_world_size=1,
    batch_size_per_rank=2,
    vocab_file=None,
    mlm_probability=0.15,
    max_seq_length=8192,
    bin_size=None,
    sequence_length_alignment=128,
    shuffle_buffer_size=1024,
    shuffle_buffer_warmup_factor=16,
    base_seed=12345,
    start_epoch=0,
    samples_seen=0,
    comm=None,
    tokenizer=None,
    log_dir=None,
    log_level=None,
    return_raw_samples=False,
    block_diagonal=False,
    num_workers=0,
    transport=None,
    queue_depth=None,
    zero_copy=None,
    slot_bytes=None,
):
  """Build the long-context packed loader over a (balanced) shard dir.

  Mirrors :func:`~lddl_tpu_torch.loader.bert.get_bert_pretrain_data_loader`
  (same sharding, binning, resume and worker-process semantics, the same
  ``num_workers`` and handoff knobs); only the collate differs. Defaults
  are long-context-appropriate: small batches, seq alignment 128
  (ring/flash block multiples), smaller shuffle buffer (rows are
  64-256x BERT-row-sized). The returned loader carries the same public
  ``seek(epoch, batch_index)``/``tell()`` positioning contract as the
  BERT loader.
  """
  if num_workers:
    return MultiprocessLoader.from_params(
        locals(), ('lddl_tpu_torch.loader.packed',
                   'get_packed_pretrain_data_loader'))
  common = dict(
      dp_rank=dp_rank, dp_world_size=dp_world_size,
      batch_size_per_rank=batch_size_per_rank,
      max_seq_length=max_seq_length, bin_size=bin_size,
      sequence_length_alignment=sequence_length_alignment,
      shuffle_buffer_size=shuffle_buffer_size,
      shuffle_buffer_warmup_factor=shuffle_buffer_warmup_factor,
      base_seed=base_seed, start_epoch=start_epoch,
      samples_seen=samples_seen, comm=comm, log_dir=log_dir,
      log_level=log_level)
  if return_raw_samples:
    return build_pretrain_loader(
        path, lambda rows, seq_len, epoch, step: materialize_rows(rows),
        **common)
  if tokenizer is None:
    from ..tokenization.wordpiece import load_bert_tokenizer
    tokenizer = load_bert_tokenizer(vocab_file)
  collate = PackedCollate(
      tokenizer, mlm_probability=mlm_probability, base_seed=base_seed,
      dp_rank=dp_rank, block_diagonal=block_diagonal)
  return build_pretrain_loader(path, collate, **common)
