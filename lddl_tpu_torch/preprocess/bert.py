"""BERT pretraining preprocessor: the fast engine, with no pyarrow and no JAX.

The port's :mod:`lddl_tpu.preprocess.bert`. It turns one-document-per-line
corpora into next-sentence-prediction pairs with optional static MLM
masking and sequence-length binning, written as Parquet shards with the
JAX package's schema and names:

  A: str                     space-joined WordPiece tokens of segment A
  B: str                     space-joined WordPiece tokens of segment B
  is_random_next: bool       NSP label
  num_tokens: uint16         len(A) + len(B) + 3 ([CLS] + 2x[SEP])
  [masked_lm_positions: binary   serialized uint16 positions into the
                                 assembled [CLS] A [SEP] B [SEP] sequence]
  [masked_lm_labels: str         space-joined original tokens]
  [bin_id: int64             when binned]

or, in the mask-delta format (masked runs with ``duplicate_factor > 1``),
one row per base pair with the per-copy deltas in three binary columns.

The engine is the JAX package's ``fast`` engine: token ids end to end
(one native split-and-encode call per partition), contiguous-range pair
planning (``native/src/pairing.cpp``), one batched masking call, and
column assembly from offsets and buffers (the native columnar emitter),
written by the port's own Parquet writer
(:mod:`lddl_tpu_torch.pipeline.parquet_io`). The same corpus, seed and
settings give the JAX package's rows in the JAX package's order, with
either mask backend:

  - ``device`` (the default): the partition program on the card, a
    hand-written CUDA kernel (``csrc/masking.cu``) whose draws equal the
    JAX package's jit program bit for bit; ``--device cpu`` runs its plain
    version, where the caller asks for it. Without a card it raises:
    nothing falls back to the host;
  - ``host``: the fused native Philox pass, bit for bit the JAX
    package's host backend;
  - ``auto``: ``device`` where a card with a usable host link is
    attached, else ``host``; always ``host`` with more than one local
    worker (``--num-workers``), whose pool's workers cannot share the
    card. An explicit ``device`` with more than one worker is refused
    before any worker starts: which backend masks is part of the shards'
    bits.

The ``python`` engine (``--engine python``) is the JAX package's
reference-style one: each partition's documents are tokenized into
:class:`Document` s of token strings, paired per document
(:func:`create_pairs_from_document`, the reference recipe of
``lddl/dask/bert/pretrain.py:241-365``) and, with ``--masking``, masked
per pair on the host by a Philox stream keyed ``[seed, partition]``
(:func:`create_masked_lm_predictions_np`); its rows are dicts, written
materialized by :func:`~lddl_tpu_torch.pipeline.parquet_io.
write_samples_partition`. It draws the JAX package's streams in the JAX
package's order, so it writes the JAX package's rows; it runs on the host
only and launches no kernel.
"""

import argparse
import dataclasses
import functools
import time

import numpy as np

from ..core.random import rng_from_key
from ..core.utils import (attach_bool_arg, binary_column_from_parts,
                          npy_batch_binary_parts, serialize_np_array,
                          u16_batch_binary_parts)
from ..pipeline.executor import Executor
from ..pipeline.parquet_io import ByteArrays, Schema, Table, \
    write_samples_partition, write_table_partition
from ..pipeline.pool import current_writer
from ..pipeline.shard_format import (DELTA, DELTA_COLUMNS, MATERIALIZED,
                                     tag_table)
from ..pipeline.shuffle import gather_partition
from ..telemetry import get_telemetry
from ..tokenization.sentences import split_sentences
from .common import export_telemetry, run_shuffled
from .readers import read_corpus, split_id_text

#: Telemetry counter of masking kernel launches (one per partition).
MASK_LAUNCHES = 'preprocess.mask_kernel_launches'


@dataclasses.dataclass(frozen=True)
class Document:
  doc_id: str
  sentences: tuple  # tuple of tuples of tokens

  def __len__(self):
    return len(self.sentences)

  def __getitem__(self, i):
    return self.sentences[i]


def documents_from_lines(lines, tokenizer, max_length=512,
                         sentence_backend='auto'):
  """Raw document lines -> tokenized :class:`Document` s, every sentence
  of the partition tokenized in one batched call (the partition-level
  form of the reference's per-sentence loop,
  ``lddl/dask/bert/pretrain.py:77-97``). Documents and sentences that
  tokenize to nothing are dropped."""
  doc_ids, doc_sentence_strs = [], []
  for line in lines:
    doc_id, text = split_id_text(line)
    if not text:
      continue
    sents = [s.strip() for s in split_sentences(text,
                                                backend=sentence_backend)]
    sents = [s for s in sents if s]
    if sents:
      doc_ids.append(doc_id)
      doc_sentence_strs.append(sents)
  flat = [s for sents in doc_sentence_strs for s in sents]
  flat_tokens = tokenizer.batch_tokenize(flat, max_length=max_length)
  documents = []
  pos = 0
  for doc_id, sents in zip(doc_ids, doc_sentence_strs):
    toks = [tuple(t) for t in flat_tokens[pos:pos + len(sents)]]
    pos += len(sents)
    toks = [t for t in toks if t]
    if toks:
      documents.append(Document(doc_id, tuple(toks)))
  return documents


def truncate_seq_pair(tokens_a, tokens_b, max_num_tokens, rng):
  """Trim the longer segment, from the front or the back at random, until
  the pair fits (reference ``pretrain.py:161-176``)."""
  while len(tokens_a) + len(tokens_b) > max_num_tokens:
    trunc = tokens_a if len(tokens_a) > len(tokens_b) else tokens_b
    if rng.random() < 0.5:
      del trunc[0]
    else:
      trunc.pop()


def create_masked_lm_predictions(tokens_a, tokens_b, masked_lm_ratio,
                                 vocab_words, rng, max_predictions=None):
  """Static 80/10/10 MLM masking over ``[CLS] A [SEP] B [SEP]`` with a
  ``random.Random``-like ``rng`` (reference ``pretrain.py:182-238``).
  Returns the masked A and B token lists, the sorted positions (into the
  assembled sequence) and their original tokens."""
  n_a, n_b = len(tokens_a), len(tokens_b)
  tokens = ['[CLS]'] + list(tokens_a) + ['[SEP]'] + list(tokens_b) + ['[SEP]']
  cand = [i for i, t in enumerate(tokens) if t not in ('[CLS]', '[SEP]')]
  rng.shuffle(cand)
  num_to_predict = max(1, int(round(len(tokens) * masked_lm_ratio)))
  if max_predictions is not None:
    num_to_predict = min(num_to_predict, max_predictions)
  picked = sorted(cand[:num_to_predict])
  labels = [tokens[i] for i in picked]
  for i in picked:
    r = rng.random()
    if r < 0.8:
      tokens[i] = '[MASK]'
    elif r >= 0.9:
      tokens[i] = vocab_words[rng.randrange(len(vocab_words))]
  return tokens[1:1 + n_a], tokens[2 + n_a:2 + n_a + n_b], picked, labels


def create_masked_lm_predictions_np(tokens_a, tokens_b, masked_lm_ratio,
                                    vocab_words, np_rng,
                                    max_predictions=None):
  """:func:`create_masked_lm_predictions` drawn from a numpy
  ``Generator``: one ``choice`` of the positions and one uniform and one
  integer draw per pick, instead of a shuffle of every candidate."""
  n_a, n_b = len(tokens_a), len(tokens_b)
  tokens = ['[CLS]'] + list(tokens_a) + ['[SEP]'] + list(tokens_b) + ['[SEP]']
  cand = np.concatenate(
      [np.arange(1, 1 + n_a), np.arange(2 + n_a, 2 + n_a + n_b)])
  num_to_predict = max(1, int(round(len(tokens) * masked_lm_ratio)))
  if max_predictions is not None:
    num_to_predict = min(num_to_predict, max_predictions)
  num_to_predict = min(num_to_predict, cand.size)
  picked = np.sort(np_rng.choice(cand, size=num_to_predict, replace=False))
  labels = [tokens[i] for i in picked]
  decide = np_rng.random(num_to_predict)
  rand_ids = np_rng.integers(0, len(vocab_words), num_to_predict)
  for j, i in enumerate(picked):
    if decide[j] < 0.8:
      tokens[i] = '[MASK]'
    elif decide[j] >= 0.9:
      tokens[i] = vocab_words[rand_ids[j]]
  return (tokens[1:1 + n_a], tokens[2 + n_a:2 + n_a + n_b], picked.tolist(),
          labels)


def create_pairs_from_document(all_documents, document_index, rng,
                               max_seq_length=128, short_seq_prob=0.1,
                               masking=False, masked_lm_ratio=0.15,
                               vocab_words=None, np_rng=None):
  """The NSP pairs of one document (reference ``pretrain.py:241-365``):
  sentences gather into chunks up to a target length, each chunk splits
  at a random point into A, and with probability 0.5 (always for a
  one-sentence chunk) B comes from a random other document of the
  partition, the chunk's unused sentences then read again. Masked with
  ``np_rng`` where given, else with ``rng``."""
  document = all_documents[document_index]
  max_num_tokens = max_seq_length - 3
  target_seq_length = max_num_tokens
  if rng.random() < short_seq_prob:
    target_seq_length = rng.randint(2, max_num_tokens)

  instances = []
  chunk = []
  chunk_len = 0
  i = 0
  while i < len(document):
    chunk.append(document[i])
    chunk_len += len(document[i])
    if i == len(document) - 1 or chunk_len >= target_seq_length:
      if chunk:
        a_end = 1 if len(chunk) < 2 else rng.randint(1, len(chunk) - 1)
        tokens_a = [t for seg in chunk[:a_end] for t in seg]
        tokens_b = []
        if len(chunk) == 1 or rng.random() < 0.5:
          is_random_next = True
          target_b_length = target_seq_length - len(tokens_a)
          random_document_index = document_index
          for _ in range(10):
            candidate = rng.randint(0, len(all_documents) - 1)
            if candidate != document_index:
              random_document_index = candidate
              break
          if random_document_index == document_index:
            is_random_next = False
          random_document = all_documents[random_document_index]
          start = rng.randint(0, len(random_document) - 1)
          for j in range(start, len(random_document)):
            tokens_b.extend(random_document[j])
            if len(tokens_b) >= target_b_length:
              break
          i -= len(chunk) - a_end
        else:
          is_random_next = False
          tokens_b = [t for seg in chunk[a_end:] for t in seg]
        truncate_seq_pair(tokens_a, tokens_b, max_num_tokens, rng)
        if tokens_a and tokens_b:
          if masking:
            mask = (create_masked_lm_predictions_np if np_rng is not None
                    else create_masked_lm_predictions)
            tokens_a, tokens_b, positions, labels = mask(
                tokens_a, tokens_b, masked_lm_ratio, vocab_words,
                np_rng if np_rng is not None else rng)
          instance = {
              'A': ' '.join(tokens_a),
              'B': ' '.join(tokens_b),
              'is_random_next': is_random_next,
              'num_tokens': len(tokens_a) + len(tokens_b) + 3,
          }
          if masking:
            instance['masked_lm_positions'] = serialize_np_array(
                np.asarray(positions, dtype=np.uint16))
            instance['masked_lm_labels'] = ' '.join(labels)
          instances.append(instance)
      chunk = []
      chunk_len = 0
    i += 1
  return instances


def encode_documents(doc_texts, tokenizer, sentence_backend='rules',
                     max_length=512):
  """Raw document texts -> :class:`~lddl_tpu_torch.preprocess.pairing.
  TokenizedDocs`. With the 'rules' sentence backend the whole front end
  (segmentation + WordPiece) is one multithreaded native call; otherwise
  sentences are split in Python and encoded in one batch. Documents with
  no sentence are dropped."""
  from .pairing import TokenizedDocs
  if sentence_backend == 'rules':
    flat, sent_offsets, doc_counts = tokenizer.native.encode_docs(
        doc_texts, max_tokens_per_sent=max_length)
  else:
    sents_per_doc = []
    for text in doc_texts:
      sents = [s.strip() for s in split_sentences(text,
                                                  backend=sentence_backend)]
      sents_per_doc.append([s for s in sents if s])
    flat_sents = [s for sents in sents_per_doc for s in sents]
    flat, offsets = tokenizer.encode_batch_ids(flat_sents,
                                               max_tokens=max_length)
    lens = np.diff(offsets)
    keep = lens > 0
    sent_offsets = np.concatenate(
        [[0], np.cumsum(lens[keep])]).astype(np.int64)
    doc_counts = np.zeros(len(doc_texts), dtype=np.int64)
    pos = 0
    for d, sents in enumerate(sents_per_doc):
      doc_counts[d] = int(keep[pos:pos + len(sents)].sum())
      pos += len(sents)
  nonempty = doc_counts > 0
  return TokenizedDocs(flat, sent_offsets, doc_counts[nonempty])


def _string_column(tokenizer, flat_ids, offsets):
  """Ragged id ranges -> a string column of space-joined tokens."""
  out_offsets, data = tokenizer.decode_join_buffers(flat_ids, offsets)
  return ByteArrays(out_offsets.astype(np.int64), data)


def _fused_string_col(parts):
  """(int32 offsets, utf8 data) from the native emitter -> a column."""
  out_offsets, data = parts
  return ByteArrays(np.asarray(out_offsets, dtype=np.int64), data)


def resolve_shard_format(cfg):
  """Resolve ``cfg.shard_format`` ('auto' | 'materialized' | 'delta').

  'auto' picks delta where it wins: static masking with ``duplicate_factor
  > 1`` (the copies of a pair differ only by their mask, so the base is
  stored once plus per-copy deltas). Explicit 'delta' without masking
  raises: unmasked copies differ by their pairing, which delta cannot
  represent."""
  fmt = cfg.shard_format
  if fmt == 'auto':
    if cfg.masking and cfg.duplicate_factor > 1 and cfg.engine == 'fast':
      return DELTA
    return MATERIALIZED
  if fmt == DELTA:
    if not cfg.masking:
      raise ValueError(
          '--shard-format delta requires --masking: unmasked duplicate '
          'copies differ by pairing, not by a mask delta')
    if cfg.engine != 'fast':
      raise ValueError(
          "--shard-format delta requires the fast engine (engine='fast')")
  elif fmt != MATERIALIZED:
    raise ValueError(f'unknown shard format {fmt!r}')
  return fmt


def bert_schema(masking, shard_format=MATERIALIZED):
  fields = [('A', 'string'), ('B', 'string'), ('is_random_next', 'bool'),
            ('num_tokens', 'uint16')]
  if shard_format == DELTA:
    if not masking:
      raise ValueError('delta shard format requires masking')
    fields += [(name, 'binary') for name in DELTA_COLUMNS]
  elif masking:
    fields += [('masked_lm_positions', 'binary'),
               ('masked_lm_labels', 'string')]
  return Schema(fields)


def _mask_device(flat_ids, a_ranges, b_ranges, tokenizer, cfg, mask_seed):
  """The partition program on ``cfg.device``, its launch counted into
  the :data:`MASK_LAUNCHES` telemetry counter."""
  from ..ops import masking
  before = masking.launches['mask_partition']
  out = masking.mask_partition_device(
      flat_ids, a_ranges, b_ranges, seq_len=cfg.target_seq_length,
      masked_lm_ratio=cfg.masked_lm_ratio, vocab_size=tokenizer.vocab_size,
      mask_id=tokenizer.mask_token_id, cls_id=tokenizer.cls_token_id,
      sep_id=tokenizer.sep_token_id, seed=mask_seed, device=cfg.device)
  get_telemetry().counter(MASK_LAUNCHES).add(
      masking.launches['mask_partition'] - before)
  return out


def process_partition_columnar(doc_texts, tokenizer, cfg, rng, mask_seed):
  """The fast engine on one partition: tokenize -> plan pairs -> batched
  masking -> a :class:`~lddl_tpu_torch.pipeline.parquet_io.Table` of
  :func:`bert_schema` for the resolved shard format, tagged with it.

  Masked runs with ``duplicate_factor > 1`` plan the base pairs once and
  tile the ranges copy-adjacent (p0c0, ..., p0c{dup-1}, p1c0, ...); both
  mask streams are keyed by row index, so each tiled copy draws its own
  mask. Both shard formats hold the same logical rows: delta stores each
  base once plus the per-copy (positions, new ids, k)."""
  from ..ops.masking_host import mask_partition_host, ragged_indices
  from .common import fused_string_columns
  from .pairing import plan_pairs_partition

  tele = get_telemetry()
  shard_format = resolve_shard_format(cfg)
  delta = shard_format == DELTA
  with tele.span('preprocess.tokenize_seconds'):
    docs = encode_documents(doc_texts, tokenizer,
                            sentence_backend=cfg.sentence_backend)
  if len(docs) == 0:
    return tag_table(bert_schema(cfg.masking, shard_format).empty_table(),
                     shard_format, cfg.duplicate_factor)
  plan_once = cfg.masking and cfg.duplicate_factor > 1
  with tele.span('preprocess.plan_seconds'):
    base_a, base_b, base_irn = plan_pairs_partition(
        docs, rng, max_seq_length=cfg.target_seq_length,
        short_seq_prob=cfg.short_seq_prob,
        duplicate_factor=1 if plan_once else cfg.duplicate_factor)
  dup = cfg.duplicate_factor if plan_once else 1
  nbase = len(base_a)
  if plan_once and dup > 1:
    a_ranges = np.repeat(base_a, dup, axis=0)
    b_ranges = np.repeat(base_b, dup, axis=0)
    is_random_next = np.repeat(np.asarray(base_irn), dup)
  else:
    a_ranges, b_ranges, is_random_next = base_a, base_b, base_irn
  flat_ids = docs.flat_ids
  n = len(a_ranges)
  na = (a_ranges[:, 1] - a_ranges[:, 0]).astype(np.int64)
  nb = (b_ranges[:, 1] - b_ranges[:, 0]).astype(np.int64)
  row_len = na + nb + 3
  if n and int(row_len.max()) > cfg.target_seq_length:
    raise ValueError(f'pair of {int(row_len.max())} tokens exceeds '
                     f'target_seq_length {cfg.target_seq_length}')
  mask_mode = resolve_pool_mask_backend(cfg.mask_backend, 1) \
      if cfg.masking else None
  offs_a = np.zeros(n + 1, dtype=np.int64)
  np.cumsum(na, out=offs_a[1:])
  offs_b = np.zeros(n + 1, dtype=np.int64)
  np.cumsum(nb, out=offs_b[1:])

  newv = None
  mask_span = tele.span('preprocess.mask_seconds')
  mask_span.__enter__()
  if mask_mode == 'host':
    flat_a, flat_b, ci, label_ids, k = mask_partition_host(
        flat_ids, a_ranges, b_ranges, masked_lm_ratio=cfg.masked_lm_ratio,
        vocab_size=tokenizer.vocab_size, mask_id=tokenizer.mask_token_id,
        seed=mask_seed, offs_a=offs_a, offs_b=offs_b)
    if delta:
      # The host pass applies the delta in place: read the post-mask ids
      # at the picked positions back for the delta columns.
      ri = np.repeat(np.arange(n, dtype=np.int64), k)
      ci64 = ci.astype(np.int64)
      in_a = ci64 < 1 + na[ri]
      idx_a = offs_a[ri] + ci64 - 1
      idx_b = offs_b[ri] + ci64 - 2 - na[ri]
      newv = np.where(in_a, flat_a[np.where(in_a, idx_a, 0)],
                      flat_b[np.where(in_a, 0, idx_b)])
  else:
    if not delta:
      ra, ca = ragged_indices(na)
      flat_a = flat_ids[a_ranges[ra, 0] + ca]
      rb, cb = ragged_indices(nb)
      flat_b = flat_ids[b_ranges[rb, 0] + cb]
    if mask_mode == 'device':
      positions, new_ids, kk = _mask_device(flat_ids, a_ranges, b_ranges,
                                            tokenizer, cfg, mask_seed)
      k = kk.astype(np.int64)
      pm = np.arange(positions.shape[1])[None, :] < k[:, None]
      ri = np.nonzero(pm)[0]
      ci = positions[pm].astype(np.int64)  # sorted within each row
      in_a = ci < 1 + na[ri]
      if not delta:
        # The label ids, read from the flat array through the ranges (the
        # delta format stores none: the collate reads them from input ids).
        idx_a = a_ranges[ri, 0] + ci - 1
        idx_b = b_ranges[ri, 0] + ci - 2 - na[ri]
        label_ids = np.where(
            in_a, flat_ids[np.where(in_a, idx_a, 0)],
            flat_ids[np.where(in_a, 0, idx_b)]).astype(np.int32)
      newv = new_ids[pm].astype(flat_ids.dtype)
      if not delta:
        tgt_a = offs_a[ri] + ci - 1
        flat_a[tgt_a[in_a]] = newv[in_a]
        tgt_b = offs_b[ri] + ci - 2 - na[ri]
        flat_b[tgt_b[~in_a]] = newv[~in_a]
    elif mask_mode is not None:
      raise ValueError(f'unknown mask backend {mask_mode!r} '
                       '(auto|device|host)')
  mask_span.__exit__(None, None, None)

  offs_l = None
  if cfg.masking:
    offs_l = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(k, out=offs_l[1:])
  schema = bert_schema(cfg.masking, shard_format)

  with tele.span('preprocess.assemble_seconds'):
    if delta:
      # One physical row per base pair: A/B from the unmasked base ids,
      # the dup per-copy deltas packed ragged into the binary columns.
      # Tiled rows are copy-adjacent, so a base row's span is offs_l[::dup].
      base_na = na[::dup]
      base_nb = nb[::dup]
      boffs_a = np.zeros(nbase + 1, dtype=np.int64)
      np.cumsum(base_na, out=boffs_a[1:])
      boffs_b = np.zeros(nbase + 1, dtype=np.int64)
      np.cumsum(base_nb, out=boffs_b[1:])
      ra, ca = ragged_indices(base_na)
      base_flat_a = flat_ids[base_a[ra, 0] + ca]
      rb, cb = ragged_indices(base_nb)
      base_flat_b = flat_ids[base_b[rb, 0] + cb]
      fused = fused_string_columns(
          tokenizer, [(base_flat_a, boffs_a), (base_flat_b, boffs_b)])
      if fused is not None:
        string_parts, _ = fused
        col_a = _fused_string_col(string_parts[0])
        col_b = _fused_string_col(string_parts[1])
      else:
        col_a = _string_column(tokenizer, base_flat_a, boffs_a)
        col_b = _string_column(tokenizer, base_flat_b, boffs_b)
      cols = {
          'A': col_a,
          'B': col_b,
          'is_random_next': np.asarray(base_irn, dtype=bool),
          'num_tokens': (base_na + base_nb + 3).astype(np.uint16),
      }
      doffs = offs_l[::dup]
      koffs = np.arange(nbase + 1, dtype=np.int64) * dup
      new_dt = '<u2' if tokenizer.vocab_size <= 1 << 16 else '<i4'
      for name, vals, offs, dt in (
          ('mask_delta_positions', ci, doffs, '<u2'),
          ('mask_delta_new_ids', newv, doffs, new_dt),
          ('mask_delta_k', k, koffs, '<u2')):
        bo, bd = npy_batch_binary_parts(vals, offs, dt)
        cols[name] = binary_column_from_parts(bo, bd, nbase, name)
      return tag_table(Table(cols, schema.fields), DELTA, dup)

    emit_cols = [(flat_a, offs_a), (flat_b, offs_b)]
    if cfg.masking:
      emit_cols.append((label_ids, offs_l))
    fused = fused_string_columns(
        tokenizer, emit_cols,
        positions=(ci, offs_l) if cfg.masking else None)
    cols = {'is_random_next': np.asarray(is_random_next, dtype=bool),
            'num_tokens': row_len.astype(np.uint16)}
    if fused is not None:
      string_parts, pos_parts = fused
      cols['A'] = _fused_string_col(string_parts[0])
      cols['B'] = _fused_string_col(string_parts[1])
      if cfg.masking:
        boffs, bdata = pos_parts
        cols['masked_lm_positions'] = binary_column_from_parts(
            boffs, bdata, n, 'masked_lm_positions')
        cols['masked_lm_labels'] = _fused_string_col(string_parts[2])
    else:
      cols['A'] = _string_column(tokenizer, flat_a, offs_a)
      cols['B'] = _string_column(tokenizer, flat_b, offs_b)
      if cfg.masking:
        boffs, bdata = u16_batch_binary_parts(ci, offs_l)
        cols['masked_lm_positions'] = binary_column_from_parts(
            boffs, bdata, n, 'masked_lm_positions')
        cols['masked_lm_labels'] = _string_column(tokenizer, label_ids,
                                                  offs_l)
    return tag_table(Table(cols, schema.fields), MATERIALIZED,
                     cfg.duplicate_factor)


@dataclasses.dataclass(frozen=True)
class BertPretrainConfig:
  vocab_file: str = None
  tokenizer_name: str = None
  lowercase: bool = True
  tokenizer_backend: str = 'auto'
  sentence_backend: str = 'auto'
  engine: str = 'fast'  # 'fast' (columnar, batched masking) | 'python'
  mask_backend: str = 'device'  # 'device' | 'host' | 'auto'
  target_seq_length: int = 128
  short_seq_prob: float = 0.1
  duplicate_factor: int = 5
  masking: bool = False
  masked_lm_ratio: float = 0.15
  bin_size: int = None
  seed: int = 12345
  output_format: str = 'parquet'
  shard_format: str = 'auto'
  # Where the device mask backend runs: 'cuda' (the kernel) or 'cpu' (its
  # plain version, run because the caller asked for it).
  device: str = 'cuda'

  @property
  def nbins(self):
    if self.bin_size is None:
      return None
    if self.target_seq_length % self.bin_size != 0:
      raise ValueError('bin_size must divide target_seq_length')
    return self.target_seq_length // self.bin_size


def _get_tokenizer(cfg):
  from .common import get_cached_tokenizer
  return get_cached_tokenizer(
      vocab_file=cfg.vocab_file,
      hub_name=cfg.tokenizer_name,
      lowercase=cfg.lowercase,
      backend=cfg.tokenizer_backend)


def _warmup_worker(cfg):
  """Build (and cache) the tokenizer and its native encoder before the
  first task."""
  _get_tokenizer(cfg).batch_tokenize(['warmup'])


def resolve_pool_mask_backend(backend, num_local_workers):
  """The mask backend a run of ``num_local_workers`` takes: ``auto`` is
  ``host`` under a pool (its workers cannot share the card), else
  :func:`~lddl_tpu_torch.ops.masking.resolve_mask_backend`'s pick; any
  other name as given."""
  if backend != 'auto':
    return backend
  if num_local_workers > 1:
    return 'host'
  from ..ops.masking import resolve_mask_backend
  return resolve_mask_backend(backend)


def _mask_seed(seed, tgt_idx):
  """Per-partition masking seed, independent of the pairing rng stream."""
  return int(
      np.random.SeedSequence([seed, tgt_idx, 0x6d61736b]).generate_state(1)[0])


def _process_partition(tgt_idx, global_idx, spill_dir, out_dir, cfg):
  """Task: the shuffled lines of one partition -> pairs -> (binned)
  Parquet. Returns ``{bin_id_or_None: num_samples}``."""
  del global_idx
  tokenizer = _get_tokenizer(cfg)
  lines = gather_partition(tgt_idx, spill_dir, cfg.seed)
  rng = rng_from_key(cfg.seed, 'pairs', tgt_idx)
  if cfg.engine == 'python':
    return _process_partition_python(lines, tgt_idx, out_dir, cfg, tokenizer,
                                      rng)
  doc_texts = []
  for line in lines:
    _, text = split_id_text(line)
    if text:
      doc_texts.append(text)
  table = process_partition_columnar(doc_texts, tokenizer, cfg, rng,
                                     _mask_seed(cfg.seed, tgt_idx))
  out = write_table_partition(
      table, out_dir, tgt_idx, bin_size=cfg.bin_size, nbins=cfg.nbins,
      output_format=cfg.output_format, writer=current_writer())
  return {b: nrows for b, (_, nrows) in out.items()}


def _process_partition_python(lines, tgt_idx, out_dir, cfg, tokenizer, rng):
  """The python engine on one partition: documents, then
  ``duplicate_factor`` passes of per-document pairing (and masking, from
  the Philox stream keyed ``[seed, tgt_idx]``), written as dict rows."""
  documents = documents_from_lines(lines, tokenizer,
                                   sentence_backend=cfg.sentence_backend)
  np_rng = np.random.Generator(
      np.random.Philox(key=[np.uint64(cfg.seed), np.uint64(tgt_idx)]))
  instances = []
  for _ in range(cfg.duplicate_factor):
    for di in range(len(documents)):
      instances.extend(create_pairs_from_document(
          documents, di, rng, max_seq_length=cfg.target_seq_length,
          short_seq_prob=cfg.short_seq_prob, masking=cfg.masking,
          masked_lm_ratio=cfg.masked_lm_ratio,
          vocab_words=tokenizer.vocab_words, np_rng=np_rng))
  out = write_samples_partition(
      instances, bert_schema(cfg.masking), out_dir, tgt_idx,
      bin_size=cfg.bin_size, nbins=cfg.nbins,
      output_format=cfg.output_format, writer=current_writer())
  return {b: n for b, (_, n) in out.items()}


def run(corpus, sink_dir, cfg, executor=None, num_shuffle_partitions=None):
  """The full preprocess: global document shuffle -> pair/mask/bin ->
  Parquet shards under ``sink_dir``. Returns per-partition sample counts
  (``[{bin_id_or_None: n}]`` in partition order)."""
  if cfg.engine not in ('fast', 'python'):
    raise ValueError(f'unknown engine {cfg.engine!r} (fast|python)')
  executor = executor or Executor()
  # The mask backends are the fast engine's; the python engine masks each
  # pair on the host, in its task.
  fast_masking = cfg.masking and cfg.engine == 'fast'
  if cfg.sentence_backend == 'auto':
    # Resolved once and broadcast: shard content must not depend on which
    # host has nltk's data.
    from ..tokenization.sentences import resolve_backend
    resolved = executor.comm.broadcast_object(resolve_backend(), root=0)
    cfg = dataclasses.replace(cfg, sentence_backend=resolved)
  if cfg.tokenizer_backend == 'auto':
    cfg = dataclasses.replace(cfg, tokenizer_backend='native')
  if fast_masking and cfg.mask_backend == 'auto':
    # The backends draw independently, so which one runs is part of the
    # output: resolve once on rank 0, not per rank (nor per pool worker).
    local = None
    if executor.comm.rank == 0:
      local = resolve_pool_mask_backend('auto', executor.num_local_workers)
    resolved = executor.comm.broadcast_object(local, root=0)
    cfg = dataclasses.replace(cfg, mask_backend=resolved)
  cfg = dataclasses.replace(cfg, shard_format=resolve_shard_format(cfg))
  if fast_masking and cfg.mask_backend == 'device' and \
      executor.num_local_workers > 1:
    raise ValueError(
        f'mask backend device with {executor.num_local_workers} local '
        'workers: the device backend masks in one process a card, and pool '
        'workers mask on the host; pass --mask-backend host (or auto), or '
        '--num-workers 1')
  if fast_masking and cfg.mask_backend == 'device':
    from ..ops.masking import resolve_device
    resolve_device(cfg.device)  # no card: raise before any work
  if executor.comm.rank == 0:
    mask = cfg.mask_backend if fast_masking else (
        'python' if cfg.masking else 'off')
    where = f' on {cfg.device}' if mask == 'device' else ''
    print(f'preprocess backends: tokenizer={cfg.tokenizer_backend} '
          f'sentences={cfg.sentence_backend} mask={mask}{where} '
          f'format={cfg.shard_format}')
  return run_shuffled(
      corpus,
      sink_dir,
      functools.partial(_process_partition, out_dir=sink_dir, cfg=cfg),
      cfg.seed,
      executor=executor,
      num_shuffle_partitions=num_shuffle_partitions,
      warmup=functools.partial(_warmup_worker, cfg),
      warmup_key=('bert-warmup', cfg))


def attach_args(parser):
  parser.add_argument('--wikipedia', type=str, default=None)
  parser.add_argument('--books', type=str, default=None)
  parser.add_argument('--common-crawl', type=str, default=None)
  parser.add_argument('--open-webtext', type=str, default=None)
  parser.add_argument('--source', type=str, default=None,
                      help='generic one-doc-per-line source dir')
  parser.add_argument('--sink', type=str, required=True)
  parser.add_argument('--num-blocks', type=int, default=None)
  parser.add_argument('--block-size', type=str, default=None,
                      help='bytes per partition, accepts n[KMG]')
  parser.add_argument('--sample-ratio', type=float, default=0.9)
  parser.add_argument('--seed', type=int, default=12345)
  parser.add_argument('--vocab-file', type=str, default=None)
  parser.add_argument('--tokenizer', type=str, default=None,
                      help='HF hub tokenizer name (not ported: raises)')
  parser.add_argument('--tokenizer-backend', type=str, default='auto',
                      choices=['auto', 'hf', 'native'],
                      help="auto means native; hf is not ported (raises)")
  parser.add_argument('--engine', type=str, default='fast',
                      choices=['fast', 'python'],
                      help='fast: columnar ids + batched/device masking; '
                      'python: reference-style per-document loop, on the '
                      'host')
  parser.add_argument('--mask-backend', type=str, default='device',
                      choices=['auto', 'device', 'host'],
                      help='where the static MLM masking runs: device (the '
                      'CUDA kernel; raises without a card), host, or auto')
  parser.add_argument('--device', type=str, default='cuda',
                      help="the device backend's device: cuda, or cpu for "
                      'its plain version')
  parser.add_argument('--sentence-backend', type=str, default='auto',
                      choices=['auto', 'punkt', 'rules'])
  parser.add_argument('--target-seq-length', type=int, default=128)
  parser.add_argument('--short-seq-prob', type=float, default=0.1)
  parser.add_argument('--duplicate-factor', type=int, default=5)
  parser.add_argument('--bin-size', type=int, default=None)
  parser.add_argument('--masked-lm-ratio', type=float, default=0.15)
  parser.add_argument('--shard-format', type=str, default='auto',
                      choices=['auto', 'materialized', 'delta'],
                      help='materialized stores every masked duplicate row '
                      'in full; delta stores each base pair once plus '
                      'per-copy mask deltas. auto: delta for masked '
                      'duplicate_factor>1 runs, else materialized')
  attach_bool_arg(parser, 'masking', default=False,
                  help_str='store static MLM masks')
  attach_bool_arg(parser, 'lowercase', default=True)
  parser.add_argument('--output-format', type=str, default='parquet',
                      choices=['parquet', 'txt'])
  parser.add_argument('--num-workers', type=int, default=None,
                      help='local worker processes (default 1); more run '
                      'a persistent pool, which masks on the host')
  parser.add_argument('--comm', type=str, default='null',
                      choices=['null', 'file', 'torch'])
  return parser


def main(args=None):
  parser = attach_args(
      argparse.ArgumentParser(
          description=__doc__,
          formatter_class=argparse.ArgumentDefaultsHelpFormatter))
  args = parser.parse_args(args)
  from ..comm import get_backend
  from ..core.utils import parse_str_of_num_bytes

  dirs = [
      d for d in (args.wikipedia, args.books, args.common_crawl,
                  args.open_webtext, args.source) if d is not None
  ]
  if not dirs:
    parser.error('need at least one source dir')
  if not args.vocab_file and not args.tokenizer:
    parser.error('need --vocab-file or --tokenizer')
  comm = get_backend(args.comm)
  executor = Executor(comm=comm, num_local_workers=args.num_workers)
  block_size = (parse_str_of_num_bytes(args.block_size)
                if args.block_size else None)
  corpus = read_corpus(
      dirs,
      num_blocks=args.num_blocks or 4 * executor.num_local_workers *
      comm.world_size,
      block_size=block_size,
      sample_ratio=args.sample_ratio,
      sample_seed=args.seed,
  )
  cfg = BertPretrainConfig(
      vocab_file=args.vocab_file,
      tokenizer_name=args.tokenizer,
      lowercase=args.lowercase,
      tokenizer_backend=args.tokenizer_backend,
      sentence_backend=args.sentence_backend,
      engine=args.engine,
      mask_backend=args.mask_backend,
      target_seq_length=args.target_seq_length,
      short_seq_prob=args.short_seq_prob,
      duplicate_factor=args.duplicate_factor,
      masking=args.masking,
      masked_lm_ratio=args.masked_lm_ratio,
      bin_size=args.bin_size,
      seed=args.seed,
      output_format=args.output_format,
      shard_format=args.shard_format,
      device=args.device,
  )
  t0 = time.perf_counter()
  with executor:
    counts = run(corpus, args.sink, cfg, executor=executor)
  if comm.rank == 0:
    total = sum(n for c in counts for n in c.values())
    print(f'preprocessed {total} samples into {len(counts)} partitions '
          f'in {time.perf_counter() - t0:.1f}s')
  export_telemetry(comm.rank)
  return counts



if __name__ == '__main__':
  # Run under the module's import name: a pool worker finds the task
  # functions by it (it never imports the script's __main__).
  from lddl_tpu_torch.preprocess import bert as _module
  _module.main()
