"""CodeSearchNet corpus preparation for CodeBERT pretraining: the port's
:mod:`lddl_tpu.download.codesearchnet`.

Capability parity with the reference fork's four root-level one-off
scripts, unified into one parameterized CLI (`prepare_codesearchnet`):

  - ``split``  — dedupe-definitions vs jsonl split membership
    (reference ``split_raw.py:1-50``): for each language, hash the
    ``code``/``function`` bodies of the train/valid/test jsonl.gz files;
    a definition lands in ``train`` iff its function body appears in *no
    other* split, and in ``valid``/``test`` iff it appears in that
    split's jsonl set.
  - ``extract`` — per split, flatten all languages' kept definitions into
    ``(ids, docstrings, codes)`` (reference ``extract_raw.py``).
  - ``shard``  — write the train split as ``num_blocks``
    CRLF-delimited blocks of ``id<CODESPLIT>docstring<CODESPLIT>code``
    records under ``source/`` after a seeded global shuffle (reference
    ``shard_codebert_data.py:1-21``), exactly the input contract of
    ``preprocess_codebert_pretrain`` (:mod:`lddl_tpu_torch.preprocess.
    codebert`).
  - ``train-tokenizer`` — ``lddl_tpu`` trains a WordPiece vocab with
    ``transformers``, which the port does not import (its machines have
    none): here the step raises :class:`TokenizerTrainingNotPorted`
    before any step runs. Train the vocab with ``python -m
    lddl_tpu.cli prepare_codesearchnet --steps train-tokenizer``.

Deliberate deltas from the reference scripts:

  - every path/language/split/seed is a flag (the originals hardcode
    ``/datasets/codebert``);
  - split membership hashes with sha1, not Python's ``hash()`` — the
    builtin is salted per process (PYTHONHASHSEED), which makes the
    reference's dedupe non-reproducible across runs;
  - intermediates are pickles of plain tuples, same shapes as the
    reference's, so downstream steps interoperate.

Expected input layout (the public CodeSearchNet distribution):
  <data-dir>/<lang>/final/jsonl/{train,valid,test}/*.jsonl.gz
  <data-dir>/<lang>_dedupe_definitions_v2.pkl
"""

import argparse
import glob
import gzip
import hashlib
import json
import os
import pickle

import numpy as np

from ..core.utils import expand_outdir_and_mkdir

#: The steps the port runs; ``train-tokenizer`` is a choice that raises.
STEPS = ('split', 'extract', 'shard')

LANGS = ('go', 'java', 'javascript', 'python', 'php', 'ruby')
SPLITS = ('train', 'valid', 'test')
CODE_SPLIT = '<CODESPLIT>'
LINE_DELIMITER = '\r\n'


def _stable_hash(text):
  return hashlib.sha1(text.encode('utf-8', 'surrogatepass')).digest()


def _jsonl_code_hashes(data_dir, lang, split):
  """Set of code-body hashes present in one split's jsonl.gz files."""
  hashes = set()
  pattern = os.path.join(data_dir, lang, 'final', 'jsonl', split,
                         '*.jsonl.gz')
  for path in sorted(glob.glob(pattern)):
    with gzip.open(path, 'rt', encoding='utf-8') as f:
      for line in f:
        if line.strip():
          hashes.add(_stable_hash(json.loads(line)['code']))
  return hashes


def split_raw(data_dir, out_dir, langs=LANGS):
  """Assign each deduped definition to a split; writes
  ``<out>/<lang>_<split>.pkl`` (list of (id, definition-dict))."""
  out_dir = expand_outdir_and_mkdir(out_dir)
  for lang in langs:
    with open(os.path.join(data_dir, f'{lang}_dedupe_definitions_v2.pkl'),
              'rb') as f:
      defs = pickle.load(f)
    split_hashes = {s: _jsonl_code_hashes(data_dir, lang, s) for s in SPLITS}
    def_hashes = [_stable_hash(item['function']) for item in defs]
    for split in SPLITS:
      others = [split_hashes[s] for s in SPLITS if s != split]
      kept = []
      for i, (item, h) in enumerate(zip(defs, def_hashes)):
        if split == 'train':
          keep = all(h not in o for o in others)
        else:
          keep = h in split_hashes[split]
        if keep:
          kept.append((f'{lang}_{i}', item))
      with open(os.path.join(out_dir, f'{lang}_{split}.pkl'), 'wb') as f:
        pickle.dump(kept, f)
      print(f'{lang} {split}: kept {len(kept)} of {len(defs)} definitions')
  return out_dir


def extract_raw(in_dir, out_dir, langs=LANGS, splits=SPLITS):
  """Flatten per-language split pickles into ``extracted_<split>.pkl``
  holding ``(ids, docstrings, codes)`` tuples of parallel lists."""
  out_dir = expand_outdir_and_mkdir(out_dir)
  for split in splits:
    ids, docs, codes = [], [], []
    for lang in langs:
      with open(os.path.join(in_dir, f'{lang}_{split}.pkl'), 'rb') as f:
        kept = pickle.load(f)
      bimodal = sum(1 for _, item in kept if item.get('docstring'))
      for item_id, item in kept:
        ids.append(item_id)
        docs.append(item.get('docstring') or '')
        codes.append(item['function'])
      print(f'{split} {lang}: {bimodal} bimodal, {len(kept) - bimodal} '
            'unimodal')
    with open(os.path.join(out_dir, f'extracted_{split}.pkl'), 'wb') as f:
      pickle.dump((ids, docs, codes), f)
  return out_dir


def shard_data(extracted_pkl, out_dir, num_blocks=4096, seed=12345):
  """Seeded global shuffle -> ``block_<i>.txt`` CRLF-delimited shards of
  ``id<CODESPLIT>docstring<CODESPLIT>code`` records."""
  out_dir = expand_outdir_and_mkdir(out_dir)
  with open(extracted_pkl, 'rb') as f:
    ids, docs, codes = pickle.load(f)
  records = [
      CODE_SPLIT.join(item).replace(LINE_DELIMITER, '\n')
      for item in zip(ids, docs, codes)
  ]
  perm = np.random.default_rng(seed).permutation(len(records))
  for b in range(num_blocks):
    # Round-robin over the permutation: block sizes differ by at most one
    # (contiguous ceil-chunking leaves empty tail blocks whenever the
    # count is not a multiple of num_blocks).
    chunk = perm[b::num_blocks]
    with open(os.path.join(out_dir, f'block_{b}.txt'), 'w',
              encoding='utf-8', newline='') as f:
      for idx in chunk:
        f.write(records[idx] + LINE_DELIMITER)
  print(f'sharded {len(records)} records into {num_blocks} blocks '
        f'under {out_dir}')
  return out_dir


class TokenizerTrainingNotPorted(NotImplementedError):
  """``train-tokenizer`` needs ``transformers``, which the port does not
  import."""


def train_tokenizer(extracted_pkl, out_dir, vocab_size=52000,
                    lowercase=False, batch_size=10000):
  """Raises :class:`TokenizerTrainingNotPorted`: ``lddl_tpu``'s step
  trains with ``transformers``' ``BertTokenizerFast``."""
  del extracted_pkl, out_dir, vocab_size, lowercase, batch_size
  raise TokenizerTrainingNotPorted(
      'prepare_codesearchnet --steps train-tokenizer trains a WordPiece '
      'vocab with transformers, which lddl_tpu_torch does not import: run '
      'it with lddl_tpu (python -m lddl_tpu.cli prepare_codesearchnet '
      '--steps train-tokenizer) and pass its vocab.txt as --vocab-file')


def attach_args(parser):
  parser.add_argument('--data-dir', required=True,
                      help='CodeSearchNet root: <lang>/final/jsonl/... + '
                           '<lang>_dedupe_definitions_v2.pkl')
  parser.add_argument('--outdir', required=True,
                      help='working dir for split/extracted pickles; '
                           'shards land in <outdir>/source, the vocab in '
                           '<outdir>/tokenizer')
  parser.add_argument('--langs', nargs='+', default=list(LANGS))
  parser.add_argument('--steps', nargs='+', default=list(STEPS),
                      choices=[*STEPS, 'train-tokenizer'],
                      help='train-tokenizer needs transformers: it raises '
                      'in the port')
  parser.add_argument('--num-blocks', type=int, default=4096)
  parser.add_argument('--seed', type=int, default=12345)
  parser.add_argument('--vocab-size', type=int, default=52000)
  return parser


def main(args=None):
  if args is None or isinstance(args, list):
    args = attach_args(argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)).parse_args(
            args)
  outdir = expand_outdir_and_mkdir(args.outdir)
  extracted = os.path.join(outdir, 'extracted_train.pkl')
  if 'train-tokenizer' in args.steps:
    # Before any step runs: a run that cannot finish starts nothing.
    train_tokenizer(extracted, os.path.join(outdir, 'tokenizer'),
                    vocab_size=args.vocab_size)
  if 'split' in args.steps:
    split_raw(args.data_dir, outdir, langs=args.langs)
  if 'extract' in args.steps:
    extract_raw(outdir, outdir, langs=args.langs)
  if 'shard' in args.steps:
    shard_data(extracted, os.path.join(outdir, 'source'),
               num_blocks=args.num_blocks, seed=args.seed)


if __name__ == '__main__':
  main()
