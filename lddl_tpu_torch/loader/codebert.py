"""CodeBERT pretraining loader: bimodal (docstring, code) batches.

A copy of :mod:`lddl_tpu.loader.codebert` (pure numpy; the port keeps its
own copy and imports nothing of ``lddl_tpu``). The bimodal schema
({id, doc, code, num_tokens}, written by :mod:`lddl_tpu.preprocess.codebert`)
gets its own collate so the segment layout is right even when the
docstring is absent:

  with doc:    [CLS] doc [SEP] code [SEP]   (types 0...0 1...1)
  without doc: [CLS] code [SEP]             (types 0...0)

Dynamic MLM masking reuses the BERT 80/10/10 Philox pass. The shards hold
tokens already, so the loader needs only the vocab map
(:class:`~lddl_tpu_torch.tokenization.wordpiece.BertVocab` over
``vocab_file``); hub tokenizers (the JAX package's default
``microsoft/codebert-base``) need the network and are not ported.
"""

import numpy as np

from .bert import BertCollate, build_pretrain_loader
from .workers import MultiprocessLoader


class CodebertCollate(BertCollate):

  def __call__(self, rows, seq_len, epoch, step):
    n = len(rows)
    input_ids = np.full((n, seq_len), self._pad_id, dtype=np.int32)
    token_type_ids = np.zeros((n, seq_len), dtype=np.int32)
    attention_mask = np.zeros((n, seq_len), dtype=np.int32)
    special_mask = np.ones((n, seq_len), dtype=bool)

    all_tokens, spans = [], []
    for row in rows:
      td = row['doc'].split() if row['doc'] else []
      tc = row['code'].split()
      spans.append((len(td), len(tc)))
      all_tokens.extend(td)
      all_tokens.extend(tc)
    all_ids = np.asarray(self._tok.convert_tokens_to_ids(all_tokens),
                         dtype=np.int32)
    pos = 0
    for i, (nd, nc) in enumerate(spans):
      ids_d = all_ids[pos:pos + nd]
      ids_c = all_ids[pos + nd:pos + nd + nc]
      pos += nd + nc
      total = nd + nc + (3 if nd else 2)
      if total > seq_len:
        raise AssertionError(
            f'sample of {total} tokens exceeds static seq_len {seq_len}')
      input_ids[i, 0] = self._cls_id
      if nd:
        input_ids[i, 1:1 + nd] = ids_d
        input_ids[i, 1 + nd] = self._sep_id
        code_start = 2 + nd
        token_type_ids[i, code_start:total] = 1
        special_mask[i, 1:1 + nd] = False
      else:
        code_start = 1
      input_ids[i, code_start:code_start + nc] = ids_c
      input_ids[i, total - 1] = self._sep_id
      special_mask[i, code_start:code_start + nc] = False
      attention_mask[i, :total] = 1

    input_ids, labels = self._mask_tokens(input_ids, special_mask, epoch,
                                          step)
    return {
        'input_ids': input_ids,
        'token_type_ids': token_type_ids,
        'attention_mask': attention_mask,
        'labels': labels,
        'next_sentence_labels': np.zeros((n,), dtype=np.int32),
    }


def get_codebert_pretrain_data_loader(
    path,
    dp_rank=0,
    dp_world_size=1,
    batch_size_per_rank=16,
    vocab_file=None,
    tokenizer_name=None,
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
    num_workers=0,
    transport=None,
    queue_depth=None,
    zero_copy=None,
    slot_bytes=None,
):
  """Loader over balanced CodeBERT shards; mirrors
  :func:`lddl_tpu_torch.loader.bert.get_bert_pretrain_data_loader`
  (including ``num_workers`` worker-process collate with byte-identical
  output, and its handoff knobs). The tokenizer is a
  :class:`~lddl_tpu_torch.tokenization.wordpiece.BertVocab` over
  ``vocab_file``; a hub ``tokenizer_name`` raises."""
  if tokenizer_name is not None:
    raise ValueError(
        f'tokenizer_name={tokenizer_name!r}: hub tokenizers are not ported '
        '(they need the network and transformers); pass vocab_file')
  if num_workers:
    return MultiprocessLoader.from_params(
        locals(), ('lddl_tpu_torch.loader.codebert',
                   'get_codebert_pretrain_data_loader'))
  if tokenizer is None:
    from ..tokenization.wordpiece import load_bert_tokenizer
    tokenizer = load_bert_tokenizer(vocab_file)
  collate = CodebertCollate(
      tokenizer,
      masking='dynamic',
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
