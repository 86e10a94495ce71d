"""Long-context packed-document preprocessor, with no pyarrow and no JAX.

The port's :mod:`lddl_tpu.preprocess.packed`. It greedily concatenates
whole tokenized documents into rows of up to ``target_seq_length``
tokens, ``[CLS] doc [SEP] doc [SEP] ...`` (a document longer than a whole
row is split into budget-sized chunks), and writes them with the JAX
package's schema and ``part.N.parquet[_<bin>]`` names through the port's
own Parquet writer (:mod:`lddl_tpu_torch.pipeline.parquet_io`):

  input_ids:   binary  np.save-framed uint16: the row's ids, specials
               included
  doc_offsets: binary  np.save-framed uint16: where each document's first
               token sits in the row (the block-diagonal attention's
               segments)
  num_tokens:  uint16

The same corpus, seed and settings give the JAX package's files, rows and
order; the loader (:mod:`lddl_tpu_torch.loader.packed`) maps the framed
ids straight into the batch. Documents are encoded by the native encoder
(one split-and-encode call a partition with the ``rules`` sentence
backend); nothing falls back to another tokenizer.

    python -m lddl_tpu_torch.preprocess.packed --source <corpus> \\
        --sink <dir> --vocab-file <vocab> --target-seq-length 8192
"""

import argparse
import dataclasses
import functools
import time

import numpy as np

from ..core.utils import (attach_bool_arg, binary_column_from_parts,
                          u16_batch_binary_parts)
from ..pipeline.executor import Executor
from ..pipeline.parquet_io import Table, write_table_partition
from ..pipeline.pool import current_writer
from ..pipeline.shuffle import gather_partition
from .common import export_telemetry, run_shuffled
from .readers import read_corpus, split_id_text

PACKED_FIELDS = [('input_ids', 'binary'), ('doc_offsets', 'binary'),
                 ('num_tokens', 'uint16')]


@dataclasses.dataclass(frozen=True)
class PackedPretrainConfig:
  vocab_file: str = None
  tokenizer_name: str = None
  lowercase: bool = True
  tokenizer_backend: str = 'auto'
  sentence_backend: str = 'auto'
  target_seq_length: int = 8192
  bin_size: int = None
  seed: int = 12345
  output_format: str = 'parquet'

  @property
  def nbins(self):
    if self.bin_size is None:
      return None
    if self.target_seq_length % self.bin_size != 0:
      raise ValueError('bin_size must divide target_seq_length')
    return self.target_seq_length // self.bin_size


def pack_documents(docs, cls_id, sep_id, target_seq_length):
  """Greedy packing: (flat row ids, row offsets, flat doc starts, doc
  start offsets), all numpy.

  ``docs``: :class:`~lddl_tpu_torch.preprocess.pairing.TokenizedDocs`.
  Each row is ``[CLS] d0 [SEP] d1 [SEP] ...``; a document that does not
  fit the row's remainder but fits a fresh row starts one; one longer
  than a whole row is split into budget-sized chunks. Every row ends with
  [SEP].
  """
  if target_seq_length < 3:
    # [CLS] + >=1 token + [SEP]; below that no row has room for a token.
    raise ValueError('target_seq_length must be >= 3')
  soff = docs.sent_offsets
  dstart = docs.doc_sent_start
  flat = docs.flat_ids
  budget = target_seq_length
  rows = []          # each row's pieces, specials included
  row_lens = []
  doc_marks = []     # each row's document start positions
  cur = [np.array([cls_id], dtype=np.int32)]
  cur_len = 1
  cur_marks = []

  def flush():
    nonlocal cur, cur_len, cur_marks
    if cur_len > 1:
      rows.append(np.concatenate(cur))
      row_lens.append(cur_len)
      doc_marks.append(cur_marks)
    cur = [np.array([cls_id], dtype=np.int32)]
    cur_len = 1
    cur_marks = []

  sep = np.array([sep_id], dtype=np.int32)
  for d in range(len(docs)):
    ids = flat[int(soff[dstart[d]]):int(soff[dstart[d + 1]])]
    while len(ids):
      space = budget - cur_len - 1  # room left before the trailing [SEP]
      if space <= 0:
        flush()
        continue
      if len(ids) > space and cur_len > 1 and len(ids) <= budget - 2:
        # Overflows this row but fits a fresh one whole: start it (an
        # empty row is never flushed, so a document is deferred once).
        flush()
        continue
      piece, ids = ids[:space], ids[space:]
      cur_marks.append(cur_len)
      cur.append(piece)
      cur.append(sep)
      cur_len += len(piece) + 1
      if cur_len >= budget:
        flush()
  flush()

  n = len(rows)
  row_offsets = np.zeros(n + 1, dtype=np.int64)
  np.cumsum(np.asarray(row_lens, dtype=np.int64), out=row_offsets[1:])
  flat_rows = np.concatenate(rows) if rows else np.zeros(0, np.int32)
  mark_offsets = np.zeros(n + 1, dtype=np.int64)
  np.cumsum([len(m) for m in doc_marks], out=mark_offsets[1:])
  flat_marks = (np.concatenate([np.asarray(m, np.int64) for m in doc_marks])
                if n else np.zeros(0, np.int64))
  return flat_rows, row_offsets, flat_marks, mark_offsets


def _binary_column(values, offsets, name):
  """An np.save-framed ``<u2`` binary column over flat values + offsets."""
  boffs, bdata = u16_batch_binary_parts(values, offsets)
  return binary_column_from_parts(boffs, bdata, len(offsets) - 1, name)


def packed_table(docs, cls_id, sep_id, target_seq_length):
  """One partition's documents -> a :class:`~lddl_tpu_torch.pipeline.
  parquet_io.Table` of packed rows (empty where ``docs`` is)."""
  if len(docs) == 0:
    return Table({name: [] for name, _ in PACKED_FIELDS}, PACKED_FIELDS)
  flat_rows, row_offsets, flat_marks, mark_offsets = pack_documents(
      docs, cls_id, sep_id, target_seq_length)
  return Table({
      'input_ids': _binary_column(flat_rows, row_offsets, 'input_ids'),
      'doc_offsets': _binary_column(flat_marks, mark_offsets, 'doc_offsets'),
      'num_tokens': np.diff(row_offsets).astype(np.uint16),
  }, PACKED_FIELDS)


def _process_partition(tgt_idx, global_idx, spill_dir, out_dir, cfg):
  """Task: the shuffled lines of one partition -> packed rows -> (binned)
  Parquet. Returns ``{bin_id_or_None: num_rows}``."""
  del global_idx
  from .bert import _get_tokenizer, encode_documents
  tokenizer = _get_tokenizer(cfg)
  if tokenizer.vocab_size > np.iinfo(np.uint16).max + 1:
    raise NotImplementedError(
        'the packed preprocessor stores uint16 ids; the vocab exceeds 65536')
  doc_texts = []
  for line in gather_partition(tgt_idx, spill_dir, cfg.seed):
    _, text = split_id_text(line)
    if text:
      doc_texts.append(text)
  docs = encode_documents(doc_texts, tokenizer,
                          sentence_backend=cfg.sentence_backend)
  table = packed_table(docs, tokenizer.cls_token_id, tokenizer.sep_token_id,
                       cfg.target_seq_length)
  out = write_table_partition(
      table, out_dir, tgt_idx, bin_size=cfg.bin_size, nbins=cfg.nbins,
      output_format=cfg.output_format, writer=current_writer())
  return {b: nrows for b, (_, nrows) in out.items()}


def run(corpus, sink_dir, cfg, executor=None, num_shuffle_partitions=None):
  """The full packed preprocess: global document shuffle -> tokenize ->
  greedy pack -> (binned) Parquet under ``sink_dir``. Returns the
  per-partition row counts (``[{bin_id_or_None: n}]``)."""
  executor = executor or Executor()
  if cfg.target_seq_length > np.iinfo(np.uint16).max:
    raise ValueError('target_seq_length > 65535 would overflow the uint16 '
                     'num_tokens/input_ids wire format')
  if cfg.sentence_backend == 'auto':
    # Resolved once and broadcast: rows must not depend on which host has
    # nltk's data.
    from ..tokenization.sentences import resolve_backend
    resolved = executor.comm.broadcast_object(resolve_backend(), root=0)
    cfg = dataclasses.replace(cfg, sentence_backend=resolved)
  if cfg.tokenizer_backend == 'auto':
    cfg = dataclasses.replace(cfg, tokenizer_backend='native')
  from .bert import _get_tokenizer
  _get_tokenizer(cfg)  # a hub name or 'hf' raises here, before any work
  return run_shuffled(
      corpus,
      sink_dir,
      functools.partial(_process_partition, out_dir=sink_dir, cfg=cfg),
      cfg.seed,
      executor=executor,
      num_shuffle_partitions=num_shuffle_partitions)


def attach_args(parser):
  parser.add_argument('--source', type=str, default=None,
                      help='generic one-doc-per-line source dir')
  parser.add_argument('--wikipedia', type=str, default=None)
  parser.add_argument('--books', type=str, default=None)
  parser.add_argument('--common-crawl', type=str, default=None)
  parser.add_argument('--open-webtext', type=str, default=None)
  parser.add_argument('--sink', type=str, required=True)
  parser.add_argument('--num-blocks', type=int, default=None)
  parser.add_argument('--sample-ratio', type=float, default=0.9)
  parser.add_argument('--seed', type=int, default=12345)
  parser.add_argument('--vocab-file', type=str, default=None)
  parser.add_argument('--tokenizer', type=str, default=None,
                      help='HF hub tokenizer name (not ported: raises)')
  parser.add_argument('--tokenizer-backend', type=str, default='auto',
                      choices=['auto', 'hf', 'native'],
                      help='auto means native; hf is not ported (raises)')
  parser.add_argument('--sentence-backend', type=str, default='auto',
                      choices=['auto', 'punkt', 'rules'])
  parser.add_argument('--target-seq-length', type=int, default=8192)
  parser.add_argument('--bin-size', type=int, default=None)
  attach_bool_arg(parser, 'lowercase', default=True)
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
  corpus = read_corpus(
      dirs,
      num_blocks=args.num_blocks or 4 * executor.num_local_workers *
      comm.world_size,
      sample_ratio=args.sample_ratio,
      sample_seed=args.seed,
  )
  cfg = PackedPretrainConfig(
      vocab_file=args.vocab_file,
      tokenizer_name=args.tokenizer,
      lowercase=args.lowercase,
      tokenizer_backend=args.tokenizer_backend,
      sentence_backend=args.sentence_backend,
      target_seq_length=args.target_seq_length,
      bin_size=args.bin_size,
      seed=args.seed,
      output_format=args.output_format,
  )
  t0 = time.perf_counter()
  with executor:
    counts = run(corpus, args.sink, cfg, executor=executor)
  if comm.rank == 0:
    total = sum(n for c in counts for n in c.values())
    print(f'packed {total} rows into {len(counts)} partitions '
          f'in {time.perf_counter() - t0:.1f}s')
  export_telemetry(comm.rank)
  return counts



if __name__ == '__main__':
  # Run under the module's import name: a pool worker finds the task
  # functions by it (it never imports the script's __main__).
  from lddl_tpu_torch.preprocess import packed as _module
  _module.main()
