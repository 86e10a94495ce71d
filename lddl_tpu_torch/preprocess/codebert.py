"""CodeBERT pretraining preprocessor (bimodal docstring/code pairs), with
no pyarrow and no JAX.

The port's :mod:`lddl_tpu.preprocess.codebert`. Input: CRLF-delimited
``id<CODESPLIT>docstring<CODESPLIT>code`` records
(:func:`~lddl_tpu_torch.preprocess.readers.read_code`). Per record:

  - docstring and code are each split into line "sentences" and tokenized;
  - a *doc segment* is built from leading docstring lines, capped at
    ``64 if max_seq_length >= 512 else 32`` tokens (with probability
    ``short_seq_prob`` just the first docstring line);
  - code lines slide through chunks: a chunk flushes when it would exceed
    ``max_seq_length - doc_len - specials``, emitting one instance, and
    the overflowing last line carries over into the next chunk;
  - chunks shorter than 16 code tokens are dropped (except the first);
  - output schema ``{id, doc, code, num_tokens}``, binned as BERT shards
    are. MLM masks are drawn at load time.

Every draw threads a per-partition RNG, so reruns are deterministic, and
the same records, seed and settings give the JAX package's files, rows
and order. Two partition paths give the same bytes: the fused columnar
path (id ranges into one flat array, one native emit of the string
columns; the default) and the dict path (token strings, one dict an
instance), taken where ``LDDL_NATIVE_COLUMNAR`` is off. Both tokenize
through the native encoder over a ``vocab_file``: hub tokenizers and
``--tokenizer-backend hf`` are not ported (they need the network and
transformers) and raise; nothing falls back to another path.

    python -m lddl_tpu_torch.preprocess.codebert --source <records> \\
        --sink <dir> --vocab-file <vocab> --target-seq-length 512
"""

import argparse
import dataclasses
import functools
import time

import numpy as np

from ..core.random import rng_from_key
from ..core.utils import attach_bool_arg
from ..pipeline.executor import Executor
from ..pipeline.parquet_io import (ByteArrays, Schema, Table,
                                   write_samples_partition,
                                   write_table_partition)
from ..pipeline.pool import current_writer
from ..pipeline.shard_format import (DELTA, MATERIALIZED, tag_schema,
                                     tag_table)
from ..pipeline.shuffle import gather_partition
from .common import (export_telemetry, fused_string_columns,
                     native_columnar_enabled, run_shuffled)
from .readers import read_code, split_id_code_docstring

MIN_CODE_TOKENS = 16


@dataclasses.dataclass(frozen=True)
class CodeDocument:
  doc_id: str
  doc_segments: tuple  # token tuples, or (start, end) id ranges
  code_segments: tuple


def truncate_seq(tokens, max_num_tokens, rng):
  """Random front/back pops until the sequence fits."""
  while len(tokens) > max_num_tokens:
    if rng.random() < 0.5:
      del tokens[0]
    else:
      tokens.pop()


def _parse_records(records):
  """(doc_id, n_doc, n_code) triples plus the flat list of line strings
  in tokenization order."""
  parsed = []
  all_strs = []
  for rec in records:
    split = split_id_code_docstring(rec)
    if split is None:
      continue
    doc_id, docstring, code = split
    doc_lines = [s for s in (x.strip() for x in docstring.split('\n')) if s]
    code_lines = [s for s in (x.strip() for x in code.split('\n')) if s]
    parsed.append((doc_id, len(doc_lines), len(code_lines)))
    all_strs.extend(doc_lines)
    all_strs.extend(code_lines)
  return parsed, all_strs


def documents_from_records(records, tokenizer, max_length=512):
  """Parse and batch-tokenize bimodal records into CodeDocuments of token
  tuples (the dict path)."""
  parsed, all_strs = _parse_records(records)
  all_tokens = tokenizer.batch_tokenize(all_strs, max_length=max_length)
  documents, pos = [], 0
  for doc_id, n_doc, n_code in parsed:
    doc_toks = tuple(tuple(t) for t in all_tokens[pos:pos + n_doc] if t)
    pos += n_doc
    code_toks = tuple(tuple(t) for t in all_tokens[pos:pos + n_code] if t)
    pos += n_code
    if code_toks:
      documents.append(CodeDocument(doc_id, doc_toks, code_toks))
  return documents


def documents_from_records_ids(records, tokenizer, max_length=512):
  """The columnar path's :func:`documents_from_records`: the same token
  stream, its segments ``(start, end)`` ranges into one flat int32 id
  array. Returns ``(documents, flat_ids)``. A document's kept segments
  are contiguous in ``flat_ids`` (empty lines have zero width), so
  concatenating segments is merging ranges."""
  parsed, all_strs = _parse_records(records)
  flat, offsets = tokenizer.encode_batch_ids(all_strs, max_tokens=max_length)
  documents, pos = [], 0
  for doc_id, n_doc, n_code in parsed:
    doc_segs = tuple((int(offsets[k]), int(offsets[k + 1]))
                     for k in range(pos, pos + n_doc)
                     if offsets[k + 1] > offsets[k])
    pos += n_doc
    code_segs = tuple((int(offsets[k]), int(offsets[k + 1]))
                      for k in range(pos, pos + n_code)
                      if offsets[k + 1] > offsets[k])
    pos += n_code
    if code_segs:
      documents.append(CodeDocument(doc_id, doc_segs, code_segs))
  return documents, flat


def build_doc_segment(document, max_doc_seq_length, short_seq_prob, rng):
  """Leading docstring lines capped at ``max_doc_seq_length`` tokens; with
  probability ``short_seq_prob`` just the first line."""
  segs = document.doc_segments
  if not segs:
    return []
  if rng.random() < short_seq_prob:
    doc_tokens = list(segs[0])
  else:
    doc_tokens = []
    chunk, length = [], 0
    for i, seg in enumerate(segs):
      chunk.append(seg)
      length += len(seg)
      if i == len(segs) - 1 or length > max_doc_seq_length:
        end = len(chunk) - 1 if (length > max_doc_seq_length and
                                 len(chunk) > 1) else len(chunk)
        for s in chunk[:end]:
          doc_tokens.extend(s)
        break
  truncate_seq(doc_tokens, max_doc_seq_length, rng)
  return doc_tokens


def create_pairs_from_document(document, rng, max_seq_length=512,
                               short_seq_prob=0.1):
  """Sliding code-chunk pairing with carry-over: a list of
  ``{id, doc, code, num_tokens}`` instances."""
  special = 3 if document.doc_segments else 2
  max_num_tokens = max_seq_length - special
  max_doc_seq_length = 64 if max_seq_length >= 512 else 32
  doc_tokens = build_doc_segment(document, max_doc_seq_length,
                                 short_seq_prob, rng)
  doc_len = len(doc_tokens)

  instances = []
  chunk, length = [], doc_len
  for i, seg in enumerate(document.code_segments):
    chunk.append(seg)
    length += len(seg)
    if i == len(document.code_segments) - 1 or length > max_num_tokens:
      carry = length > max_num_tokens and len(chunk) > 1
      code_tokens = [t for s in chunk for t in s]
      truncate_seq(code_tokens, max_num_tokens - doc_len, rng)
      if code_tokens and (not instances or
                          len(code_tokens) >= MIN_CODE_TOKENS):
        instances.append({
            'id': document.doc_id,
            'doc': ' '.join(doc_tokens),
            'code': ' '.join(code_tokens),
            'num_tokens': doc_len + len(code_tokens) + special,
        })
      chunk = [chunk[-1]] if carry else []
      length = sum(len(s) for s in chunk) + doc_len
  return instances


def truncate_range(start, end, max_num_tokens, rng):
  """Range form of :func:`truncate_seq`: the draws depend only on the
  length, so trimming endpoints consumes the same rng stream."""
  while end - start > max_num_tokens:
    if rng.random() < 0.5:
      start += 1
    else:
      end -= 1
  return start, end


def build_doc_range(document, max_doc_seq_length, short_seq_prob, rng):
  """Range form of :func:`build_doc_segment` over contiguous segments."""
  segs = document.doc_segments
  if not segs:
    return 0, 0
  if rng.random() < short_seq_prob:
    start, end = segs[0]
  else:
    chunk_n, length = 0, 0
    for i, (s, e) in enumerate(segs):
      chunk_n += 1
      length += e - s
      if i == len(segs) - 1 or length > max_doc_seq_length:
        last = chunk_n - 1 if (length > max_doc_seq_length and
                               chunk_n > 1) else chunk_n
        start, end = segs[0][0], segs[last - 1][1]
        break
  return truncate_range(start, end, max_doc_seq_length, rng)


def create_pair_ranges(document, rng, max_seq_length=512,
                       short_seq_prob=0.1):
  """Range form of :func:`create_pairs_from_document`: the same draws and
  carry-over, as ``((doc_start, doc_end), (code_start, code_end),
  num_tokens)`` triples into the flat id array."""
  special = 3 if document.doc_segments else 2
  max_num_tokens = max_seq_length - special
  max_doc_seq_length = 64 if max_seq_length >= 512 else 32
  ds, de = build_doc_range(document, max_doc_seq_length, short_seq_prob, rng)
  doc_len = de - ds

  pairs = []
  segs = document.code_segments
  first, count, length = 0, 0, doc_len
  for i, (s, e) in enumerate(segs):
    if count == 0:
      first = i
    count += 1
    length += e - s
    if i == len(segs) - 1 or length > max_num_tokens:
      carry = length > max_num_tokens and count > 1
      cs, ce = truncate_range(segs[first][0], segs[i][1],
                              max_num_tokens - doc_len, rng)
      if ce > cs and (not pairs or ce - cs >= MIN_CODE_TOKENS):
        pairs.append(((ds, de), (cs, ce), doc_len + (ce - cs) + special))
      if carry:
        first, count, length = i, 1, doc_len + (e - s)
      else:
        count, length = 0, doc_len
  return pairs


CODEBERT_SCHEMA = Schema([('id', 'string'), ('doc', 'string'),
                          ('code', 'string'), ('num_tokens', 'uint16')])


@dataclasses.dataclass(frozen=True)
class CodebertPretrainConfig:
  vocab_file: str = None
  tokenizer_name: str = None  # a hub name: not ported, raises
  tokenizer_backend: str = 'native'
  lowercase: bool = False  # code is case-sensitive; codebert-base is cased
  target_seq_length: int = 512
  short_seq_prob: float = 0.1
  duplicate_factor: int = 1
  bin_size: int = None
  seed: int = 12345
  output_format: str = 'parquet'
  # 'auto' resolves to 'delta' for duplicate_factor > 1 (one stored pass,
  # expanded by the loader; dynamic masking differentiates the copies).
  shard_format: str = 'auto'

  @property
  def nbins(self):
    if self.bin_size is None:
      return None
    if self.target_seq_length % self.bin_size != 0:
      raise ValueError('bin_size must divide target_seq_length')
    return self.target_seq_length // self.bin_size


def resolve_shard_format(cfg):
  """'auto' -> 'delta' iff ``duplicate_factor > 1``.

  CodeBERT masks at load time, so the materialized copies only re-plan
  the same records with a continuing rng; the delta format stores one
  pass and the loader expands each row ``duplicate_factor`` times, the
  copies differing by their dynamic masks."""
  fmt = cfg.shard_format
  if fmt == 'auto':
    return DELTA if cfg.duplicate_factor > 1 else MATERIALIZED
  if fmt not in (MATERIALIZED, DELTA):
    raise ValueError(f'unknown shard format {fmt!r}')
  return fmt


def _get_tokenizer(cfg):
  from .common import get_cached_tokenizer
  return get_cached_tokenizer(
      vocab_file=cfg.vocab_file,
      hub_name=None if cfg.vocab_file else cfg.tokenizer_name,
      lowercase=cfg.lowercase,
      backend=cfg.tokenizer_backend)


def _warmup_worker(cfg):
  """Build (and cache) the tokenizer and its native encoder before the
  first task."""
  _get_tokenizer(cfg).batch_tokenize(['warmup'])


def _passes(cfg):
  return 1 if resolve_shard_format(cfg) == DELTA else cfg.duplicate_factor


def _build_partition_table(records, tokenizer, rng, cfg):
  """The columnar path: pair ranges over one flat id array, one native
  emit of the doc and code columns, a :class:`~lddl_tpu_torch.pipeline.
  parquet_io.Table` tagged with the shard format. Its bytes are the dict
  path's: the same tokenization caps, draws, schema and column order."""
  documents, flat = documents_from_records_ids(
      records, tokenizer, max_length=cfg.target_seq_length)
  ids_col, triples = [], []
  for _ in range(_passes(cfg)):
    for document in documents:
      for tr in create_pair_ranges(document, rng,
                                   max_seq_length=cfg.target_seq_length,
                                   short_seq_prob=cfg.short_seq_prob):
        ids_col.append(document.doc_id)
        triples.append(tr)
  fmt = resolve_shard_format(cfg)
  if not triples:
    return tag_table(CODEBERT_SCHEMA.empty_table(), fmt,
                     cfg.duplicate_factor)

  def flatten(ranges):
    ranges = np.asarray(ranges, dtype=np.int64)
    lens = ranges[:, 1] - ranges[:, 0]
    offs = np.zeros(len(ranges) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    at = np.repeat(ranges[:, 0] - offs[:-1], lens) + np.arange(offs[-1])
    return flat[at], offs

  string_parts, _ = fused_string_columns(
      tokenizer, [flatten([t[0] for t in triples]),
                  flatten([t[1] for t in triples])])
  doc_col, code_col = (ByteArrays(np.asarray(o, dtype=np.int64), d)
                       for o, d in string_parts)
  return tag_table(
      Table({'id': ids_col, 'doc': doc_col, 'code': code_col,
             'num_tokens': np.asarray([t[2] for t in triples],
                                      dtype=np.uint16)},
            CODEBERT_SCHEMA.fields), fmt, cfg.duplicate_factor)


def _process_partition(tgt_idx, global_idx, spill_dir, out_dir, cfg,
                       delimiter='\r\n'):
  """Task: one partition's shuffled records -> pairs -> (binned) Parquet,
  by the columnar path, or by the dict path where ``LDDL_NATIVE_COLUMNAR``
  is off. Returns ``{bin_id_or_None: num_pairs}``."""
  del global_idx
  tokenizer = _get_tokenizer(cfg)
  records = gather_partition(tgt_idx, spill_dir, cfg.seed,
                             delimiter=delimiter)
  rng = rng_from_key(cfg.seed, 'code-pairs', tgt_idx)
  if native_columnar_enabled():
    out = write_table_partition(
        _build_partition_table(records, tokenizer, rng, cfg), out_dir,
        tgt_idx, bin_size=cfg.bin_size, nbins=cfg.nbins,
        output_format=cfg.output_format, writer=current_writer())
    return {b: n for b, (_, n) in out.items()}
  documents = documents_from_records(records, tokenizer,
                                     max_length=cfg.target_seq_length)
  instances = []
  for _ in range(_passes(cfg)):
    for document in documents:
      instances.extend(create_pairs_from_document(
          document, rng, max_seq_length=cfg.target_seq_length,
          short_seq_prob=cfg.short_seq_prob))
  out = write_samples_partition(
      instances,
      tag_schema(CODEBERT_SCHEMA, resolve_shard_format(cfg),
                 cfg.duplicate_factor),
      out_dir, tgt_idx, bin_size=cfg.bin_size, nbins=cfg.nbins,
      output_format=cfg.output_format, writer=current_writer())
  return {b: n for b, (_, n) in out.items()}


def run(corpus, sink_dir, cfg, executor=None, num_shuffle_partitions=None):
  """The full CodeBERT preprocess: global record shuffle -> pairs ->
  (binned) Parquet under ``sink_dir``. Returns the per-partition pair
  counts (``[{bin_id_or_None: n}]``)."""
  _get_tokenizer(cfg)  # a hub name or 'hf' raises here, before any work
  # The gather delimiter must match what the scatter wrote: the corpus's.
  return run_shuffled(
      corpus,
      sink_dir,
      functools.partial(_process_partition, out_dir=sink_dir, cfg=cfg,
                        delimiter=corpus.delimiter),
      cfg.seed,
      executor=executor,
      num_shuffle_partitions=num_shuffle_partitions,
      warmup=functools.partial(_warmup_worker, cfg),
      warmup_key=('codebert-warmup', cfg))


def attach_args(parser):
  parser.add_argument('--source', type=str, required=True,
                      help='dir of CRLF-delimited <CODESPLIT> shards')
  parser.add_argument('--sink', type=str, required=True)
  parser.add_argument('--num-blocks', type=int, default=None)
  parser.add_argument('--block-size', type=str, default=None)
  parser.add_argument('--sample-ratio', type=float, default=1.0)
  parser.add_argument('--seed', type=int, default=12345)
  parser.add_argument('--vocab-file', type=str, default=None)
  parser.add_argument('--tokenizer', type=str, default=None,
                      help='HF hub tokenizer name (not ported: raises)')
  parser.add_argument('--tokenizer-backend', type=str, default='native',
                      choices=['hf', 'native'],
                      help='hf is not ported (raises)')
  attach_bool_arg(parser, 'lowercase', default=False,
                  help_str='lowercase code (codebert-base is cased)')
  parser.add_argument('--target-seq-length', type=int, default=512)
  parser.add_argument('--short-seq-prob', type=float, default=0.1)
  parser.add_argument('--duplicate-factor', type=int, default=1)
  parser.add_argument('--shard-format', type=str, default='auto',
                      choices=['auto', 'materialized', 'delta'],
                      help='delta stores one pairing pass and the loader '
                      'expands it duplicate_factor times (dynamic masking '
                      'differentiates copies); auto: delta iff '
                      'duplicate_factor>1')
  parser.add_argument('--bin-size', type=int, default=None)
  parser.add_argument('--output-format', type=str, default='parquet',
                      choices=['parquet', 'txt'])
  parser.add_argument('--num-workers', type=int, default=None,
                      help='local worker processes (default 1)')
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
  if not args.vocab_file and not args.tokenizer:
    parser.error('need --vocab-file or --tokenizer')
  comm = get_backend(args.comm)
  executor = Executor(comm=comm, num_local_workers=args.num_workers)
  corpus = read_code(
      args.source,
      num_blocks=args.num_blocks or 4 * executor.num_local_workers *
      comm.world_size,
      block_size=(parse_str_of_num_bytes(args.block_size)
                  if args.block_size else None),
      sample_ratio=args.sample_ratio,
      sample_seed=args.seed,
  )
  cfg = CodebertPretrainConfig(
      vocab_file=args.vocab_file,
      tokenizer_name=args.tokenizer,
      tokenizer_backend=args.tokenizer_backend,
      lowercase=args.lowercase,
      target_seq_length=args.target_seq_length,
      short_seq_prob=args.short_seq_prob,
      duplicate_factor=args.duplicate_factor,
      bin_size=args.bin_size,
      seed=args.seed,
      output_format=args.output_format,
      shard_format=args.shard_format)
  t0 = time.perf_counter()
  with executor:
    counts = run(corpus, args.sink, cfg, executor=executor)
  if comm.rank == 0:
    total = sum(n for c in counts for n in c.values())
    print(f'preprocessed {total} pairs into {len(counts)} partitions '
          f'in {time.perf_counter() - t0:.1f}s')
  export_telemetry(comm.rank)
  return counts



if __name__ == '__main__':
  # Run under the module's import name: a pool worker finds the task
  # functions by it (it never imports the script's __main__).
  from lddl_tpu_torch.preprocess import codebert as _module
  _module.main()
