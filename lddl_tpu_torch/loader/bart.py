"""BART pretraining loader: text-infilling batches from `sentences` shards.

A copy of :mod:`lddl_tpu.loader.bart` (pure numpy; the port keeps its own
copy and imports nothing of ``lddl_tpu``). It reads the unbinned
``sentences`` Parquet shards that :mod:`lddl_tpu.preprocess.bart` writes
and applies BART's text-infilling objective at load time:

  - tokenize each chunk (one batched call to the native WordPiece
    encoder, :class:`~lddl_tpu_torch.tokenization.wordpiece.BertWordPiece`);
  - sample noise spans, length ~ Poisson(lambda=3), covering
    ``noise_density`` (default 0.3) of the tokens, and collapse each span
    to a single ``[MASK]`` token;
  - emit fixed-shape int32 batches: corrupted ``input_ids`` +
    ``attention_mask`` (encoder side), original ``labels`` with -100 at
    padding (decoder target), and ``decoder_input_ids`` (labels shifted
    right, BOS-first).

Every random draw comes from a Philox generator keyed by
``(seed, epoch, dp_rank, step)``, as in
:class:`~lddl_tpu_torch.loader.bert.BertCollate`, so the batches are
byte-equal to the JAX package's for the same shards and settings, serially,
through worker processes and after a byte-exact seek.
"""

import numpy as np

from .bert import IGNORE_INDEX, build_pretrain_loader
from .workers import MultiprocessLoader


class BartCollate:
  """Rows {'sentences': str} -> text-infilling batch dict."""

  def __init__(self, tokenizer, noise_density=0.3, poisson_lambda=3.0,
               base_seed=12345, dp_rank=0):
    # The port's BertWordPiece tokenizes through encode_batch_ids (the
    # native encoder); anything else with a HuggingFace-style batch call
    # (a bare tokenizer, duck-typed) uses that call.
    self._hf = getattr(tokenizer, 'hf', tokenizer)
    self._encode_ids = getattr(tokenizer, 'encode_batch_ids', None)
    self._density = noise_density
    self._lambda = poisson_lambda
    self._base_seed = base_seed
    self._dp_rank = dp_rank
    self._mask_id = tokenizer.mask_token_id
    self._pad_id = (tokenizer.pad_token_id
                    if tokenizer.pad_token_id is not None else 0)
    self._cls_id = tokenizer.cls_token_id
    self._sep_id = tokenizer.sep_token_id
    bos = getattr(self._hf, 'bos_token_id', None)
    self._bos_id = bos if bos is not None else tokenizer.cls_token_id
    if self._mask_id is None:
      raise ValueError('tokenizer defines no mask token; text infilling '
                       'requires one')

  def _rng(self, epoch, step):
    return np.random.Generator(
        np.random.Philox(key=[
            np.uint64(self._base_seed) << np.uint64(32) | np.uint64(epoch),
            np.uint64(self._dp_rank) << np.uint64(32) | np.uint64(step),
        ]))

  def _noise_spans(self, n, rng):
    """Start/length pairs of non-overlapping spans covering ~density*n.

    All draws for the rejection loop are taken up front in two vector
    calls, in the JAX package's order and count, so the spans are its
    spans."""
    budget = int(round(n * self._density))
    if budget <= 0:
      return []
    max_tries = 8 * max(1, n)
    lengths = rng.poisson(self._lambda, max_tries)
    units = rng.random(max_tries)
    taken = bytearray(n)
    spans = []
    for t in range(max_tries):
      if budget <= 0:
        break
      length = max(1, int(lengths[t]))
      length = min(length, budget) or 1
      start = int(units[t] * max(1, n - length + 1))
      end = start + length
      if any(taken[start:end]):
        continue
      taken[start:end] = b'\x01' * length
      spans.append((start, length))
      budget -= length
    return sorted(spans)

  def _tokenize_rows(self, texts, seq_len):
    """Per-row int32 id arrays, [CLS] ... [SEP], truncated to seq_len."""
    if self._encode_ids is not None:
      flat, offs = self._encode_ids(texts, max_tokens=seq_len - 2)
      cls_arr = np.array([self._cls_id], np.int32)
      sep_arr = np.array([self._sep_id], np.int32)
      return [
          np.concatenate((cls_arr, flat[offs[i]:offs[i + 1]], sep_arr))
          for i in range(len(texts))
      ]
    enc = self._hf(texts, truncation=True, max_length=seq_len,
                   add_special_tokens=True)
    return [np.asarray(ids, dtype=np.int32) for ids in enc['input_ids']]

  def __call__(self, rows, seq_len, epoch, step):
    texts = [row['sentences'] for row in rows]
    row_ids = self._tokenize_rows(texts, seq_len)
    rng = self._rng(epoch, step)
    n = len(rows)
    input_ids = np.full((n, seq_len), self._pad_id, dtype=np.int32)
    attention_mask = np.zeros((n, seq_len), dtype=np.int32)
    labels = np.full((n, seq_len), IGNORE_INDEX, dtype=np.int32)
    decoder_input_ids = np.full((n, seq_len), self._pad_id, dtype=np.int32)

    for i, ids in enumerate(row_ids):
      labels[i, :len(ids)] = ids
      decoder_input_ids[i, 0] = self._bos_id
      decoder_input_ids[i, 1:len(ids)] = ids[:-1]
      corrupted = []
      pos = 0
      for start, length in self._noise_spans(len(ids), rng):
        corrupted.extend(ids[pos:start])
        corrupted.append(self._mask_id)
        pos = start + length
      corrupted.extend(ids[pos:])
      corrupted = np.asarray(corrupted[:seq_len], dtype=np.int32)
      input_ids[i, :len(corrupted)] = corrupted
      attention_mask[i, :len(corrupted)] = 1
    return {
        'input_ids': input_ids,
        'attention_mask': attention_mask,
        'labels': labels,
        'decoder_input_ids': decoder_input_ids,
    }


def get_bart_pretrain_data_loader(
    path,
    dp_rank=0,
    dp_world_size=1,
    batch_size_per_rank=64,
    vocab_file=None,
    tokenizer_name=None,
    lowercase=True,
    noise_density=0.3,
    poisson_lambda=3.0,
    max_seq_length=128,
    shuffle_buffer_size=16384,
    shuffle_buffer_warmup_factor=16,
    base_seed=12345,
    start_epoch=0,
    samples_seen=0,
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
  """Loader over (unbinned) BART `sentences` shards; mirrors
  :func:`lddl_tpu.loader.bart.get_bart_pretrain_data_loader`, including
  ``num_workers`` worker-process collate with byte-identical output (each
  worker builds its own tokenizer and native encoder from ``vocab_file``)
  and the port's handoff knobs. A hub ``tokenizer_name`` raises."""
  if tokenizer_name is not None:
    raise ValueError(
        f'tokenizer_name={tokenizer_name!r}: hub tokenizers are not ported '
        '(they need the network and transformers); pass vocab_file')
  if num_workers:
    params = dict(locals())
    # Build the encoder library here, once, before the workers start:
    # otherwise their first builds race and the first batch pays for one.
    from ..native import library
    library()
    return MultiprocessLoader.from_params(
        params, ('lddl_tpu_torch.loader.bart',
                 'get_bart_pretrain_data_loader'))
  if tokenizer is None:
    from ..tokenization.wordpiece import load_bert_tokenizer
    tokenizer = load_bert_tokenizer(vocab_file=vocab_file,
                                    lowercase=lowercase)
  collate = BartCollate(
      tokenizer,
      noise_density=noise_density,
      poisson_lambda=poisson_lambda,
      base_seed=base_seed,
      dp_rank=dp_rank)
  return build_pretrain_loader(
      path,
      collate,
      dp_rank=dp_rank,
      dp_world_size=dp_world_size,
      batch_size_per_rank=batch_size_per_rank,
      max_seq_length=max_seq_length,
      bin_size=None,
      shuffle_buffer_size=shuffle_buffer_size,
      shuffle_buffer_warmup_factor=shuffle_buffer_warmup_factor,
      base_seed=base_seed,
      start_epoch=start_epoch,
      samples_seen=samples_seen,
      comm=comm,
      log_dir=log_dir,
      log_level=log_level)
