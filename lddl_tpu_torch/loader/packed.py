"""The packed long-context collate (block-diagonal packed pretraining).

Counterpart of :class:`lddl_tpu.loader.packed.PackedCollate`: packed rows
as :mod:`lddl_tpu.preprocess.packed` writes them (``input_ids`` and
``doc_offsets``, np.save-wire uint16, ``[CLS] doc [SEP] doc [SEP] ...``)
become the fixed-shape batch dict ``TrainLoop`` consumes:

  input_ids, token_type_ids, attention_mask: int32 [batch, seq_len]
  labels: int32 [batch, seq_len]  (-100 = not an MLM target; dynamic
          masking keyed (seed, epoch, rank, step))
  next_sentence_labels: int32 [batch]  (all zero: packed rows carry no NSP
          task)
  segment_ids: int32 [batch, seq_len]  (only with ``block_diagonal=True``:
          the document index per token, -1 on padding)

The JAX collate's telemetry and tracer calls are left out (the port's
observability is a later slice). ``get_packed_pretrain_data_loader``, the
Parquet-reading loader around this collate, waits for the loader slice
(the card's machine has no pyarrow).
"""

import numpy as np

from ..core.utils import deserialize_np_array
from .bert import dynamic_mask_tokens


class PackedCollate:
  """Packed-id rows -> fixed-shape numpy batch dict. ``tokenizer`` needs
  ``cls_token_id``, ``sep_token_id``, ``mask_token_id``, ``pad_token_id``
  and ``vocab_size``."""

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
    # structure travels in the separate segment_ids key.
    token_type_ids = np.zeros((n, seq_len), dtype=np.int32)
    segment_ids = None
    if self._block_diagonal:
      # doc_offsets -> per-token doc index (pads = -1). Offsets mark each
      # piece's first token, continuation chunks of a split document
      # included; the leading [CLS] joins doc 0 and each [SEP] trails the
      # doc it closes.
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
