"""BART pretraining preprocessor, with no pyarrow and no JAX.

The port's :mod:`lddl_tpu.preprocess.bart`: sentence-split each document,
then greedily aggregate sentences into chunks whose whitespace-token
count reaches ``target_seq_length - 3``; no tokenizer, no masking, no
binning. One ``sentences`` string column, written through the port's own
Parquet writer with the JAX package's names, files and row order. The
denoising noise (span infilling) is drawn at load time
(:mod:`lddl_tpu_torch.loader.bart`).

    python -m lddl_tpu_torch.preprocess.bart --source <corpus> --sink <dir>
"""

import argparse
import dataclasses
import functools
import time

from ..pipeline.executor import Executor
from ..pipeline.parquet_io import Schema, write_samples_partition
from ..pipeline.pool import current_writer
from ..pipeline.shuffle import gather_partition
from ..tokenization.sentences import split_sentences
from .common import export_telemetry, run_shuffled
from .readers import read_corpus, split_id_text


def aggregate_sentences(sentences, target_seq_length):
  """Greedy chunks of sentences by whitespace token count (the -3 leaves
  room for [CLS]/[SEP]/[SEP])."""
  results = []
  target = target_seq_length - 3
  chunk, num_tokens = '', 0
  for sentence in sentences:
    chunk += ' ' + sentence
    num_tokens += len(sentence.split())
    if num_tokens >= target:
      results.append({'sentences': chunk, 'num_tokens': num_tokens})
      chunk, num_tokens = '', 0
  if num_tokens > 0:
    results.append({'sentences': chunk, 'num_tokens': num_tokens})
  return results


def sequences_from_lines(lines, target_seq_length, sentence_backend='rules'):
  """One-document-per-line input lines -> aggregated chunks, in order."""
  out = []
  for line in lines:
    _, text = split_id_text(line)
    if not text:
      continue
    sents = [s.strip() for s in split_sentences(text, backend=sentence_backend)]
    out.extend(aggregate_sentences([s for s in sents if s],
                                   target_seq_length))
  return out


BART_SCHEMA = Schema([('sentences', 'string')])


@dataclasses.dataclass(frozen=True)
class BartPretrainConfig:
  target_seq_length: int = 128
  sentence_backend: str = 'rules'
  seed: int = 12345
  output_format: str = 'parquet'


def _process_partition(tgt_idx, global_idx, spill_dir, out_dir, cfg):
  """Task: one partition's shuffled lines -> chunks -> Parquet. Returns
  ``{None: num_chunks}``."""
  del global_idx
  lines = gather_partition(tgt_idx, spill_dir, cfg.seed)
  seqs = sequences_from_lines(
      lines, cfg.target_seq_length, sentence_backend=cfg.sentence_backend)
  out = write_samples_partition(
      [{'sentences': s['sentences']} for s in seqs], BART_SCHEMA, out_dir,
      tgt_idx, output_format=cfg.output_format, writer=current_writer())
  return {b: n for b, (_, n) in out.items()}


def run(corpus, sink_dir, cfg, executor=None, num_shuffle_partitions=None):
  """Shuffle -> aggregate -> Parquet shards under ``sink_dir``; returns the
  per-partition chunk counts (``[{None: n}]``)."""
  return run_shuffled(
      corpus,
      sink_dir,
      functools.partial(_process_partition, out_dir=sink_dir, cfg=cfg),
      cfg.seed,
      executor=executor,
      num_shuffle_partitions=num_shuffle_partitions)


def attach_args(parser):
  parser.add_argument('--wikipedia', type=str, default=None)
  parser.add_argument('--books', type=str, default=None)
  parser.add_argument('--common-crawl', type=str, default=None)
  parser.add_argument('--open-webtext', type=str, default=None)
  parser.add_argument('--source', type=str, default=None)
  parser.add_argument('--sink', type=str, required=True)
  parser.add_argument('--num-blocks', type=int, default=None)
  parser.add_argument('--block-size', type=str, default=None)
  parser.add_argument('--sample-ratio', type=float, default=0.9)
  parser.add_argument('--seed', type=int, default=12345)
  parser.add_argument('--target-seq-length', type=int, default=128)
  parser.add_argument('--sentence-backend', type=str, default='auto',
                      choices=['auto', 'punkt', 'rules'])
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
  dirs = [
      d for d in (args.wikipedia, args.books, args.common_crawl,
                  args.open_webtext, args.source) if d is not None
  ]
  if not dirs:
    parser.error('need at least one source dir')
  comm = get_backend(args.comm)
  executor = Executor(comm=comm, num_local_workers=args.num_workers)
  corpus = read_corpus(
      dirs,
      num_blocks=args.num_blocks or 4 * executor.num_local_workers *
      comm.world_size,
      block_size=(parse_str_of_num_bytes(args.block_size)
                  if args.block_size else None),
      sample_ratio=args.sample_ratio,
      sample_seed=args.seed,
  )
  backend = args.sentence_backend
  if backend == 'auto':
    # Resolved once and broadcast: chunks must not depend on which host
    # has nltk's data.
    from ..tokenization.sentences import resolve_backend
    backend = comm.broadcast_object(resolve_backend(), root=0)
  cfg = BartPretrainConfig(
      target_seq_length=args.target_seq_length,
      sentence_backend=backend,
      seed=args.seed,
      output_format=args.output_format)
  t0 = time.perf_counter()
  with executor:
    counts = run(corpus, args.sink, cfg, executor=executor)
  if comm.rank == 0:
    total = sum(n for c in counts for n in c.values())
    print(f'preprocessed {total} sequences into {len(counts)} partitions '
          f'in {time.perf_counter() - t0:.1f}s')
  export_telemetry(comm.rank)
  return counts



if __name__ == '__main__':
  # Run under the module's import name: a pool worker finds the task
  # functions by it (it never imports the script's __main__).
  from lddl_tpu_torch.preprocess import bart as _module
  _module.main()
