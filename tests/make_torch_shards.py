#!/usr/bin/env python3
"""Write the shard sets the port reads on the card: tests/assets/torch_shards.

    python tests/make_torch_shards.py [--digests-only]

Needs the JAX package's preprocessing (pyarrow and transformers); the
card's machine has neither, so the shards are made here and committed.
Writes, under ``tests/assets/torch_shards/``:

  - ``pairs/``: NSP pairs from :mod:`lddl_tpu.core.synth` text, tokenized
    with ``benchmarks/assets/bench_vocab_30522.txt`` by lddl_tpu's BERT
    preprocess (binned: ``bin_size=128``, ``target_seq_length=512``,
    unmasked for dynamic masking, ``duplicate_factor=1``) and balanced by
    its balancer, with their default codec;
  - ``packed/``: documents of the same text through lddl_tpu's packed
    preprocess (``target_seq_length=8192``, unbinned), balanced;
  - ``codebert/``: ``id<CODESPLIT>docstring<CODESPLIT>code`` records made
    of the same text (a document's first sentence is its docstring, none
    for every fourth; its other sentences are the code lines) through
    lddl_tpu's CodeBERT preprocess with the same vocab (binned:
    ``bin_size=128``, ``target_seq_length=512``), balanced;
  - ``digests.json``: the loader settings of chip_smoke.py's phases 7 and
    8 and, for every batch of epoch 0 that lddl_tpu's loaders give over
    these shards with them, its ``batch_sha256`` (chip_smoke.py) and its
    determinism-ledger fingerprint (``ledger``: lddl_tpu's
    ``fingerprint_batch`` under blake2b-8, the digest the ledger writes
    where ``xxhash`` is not installed, as on the card's machine).

``--digests-only`` keeps the committed shards and rewrites digests.json
from them (after a change to the settings below, lddl_tpu's loaders or
``batch_sha256``).

Each set is drawn from a corpus seed; the script takes the first seed
whose shards meet the phase's needs: every bin of ``pairs/`` holds at
least two batches of 16 per epoch, every row of ``packed/`` holds
12-16 documents in 6,144-8,192 tokens, with enough rows for the packed
steps, and ``codebert/`` gives at least CODEBERT_BATCHES batches of 16
per epoch.
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

OUT = os.path.join(HERE, 'assets', 'torch_shards')
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')

# The loader settings of chip_smoke.py's phase 7, recorded in digests.json.
# Each shuffle buffer holds less than the smallest bin (48 pairs, 27 packed
# rows), so after its first batch a bin's stream reads one row per sample,
# as it does over a corpus of real size (whose default buffer of 16,384
# this corpus would never fill).
PAIRS = dict(batch_size_per_rank=16, bin_size=128, max_seq_length=512,
             masking='dynamic', base_seed=2024, shuffle_buffer_size=16)
PACKED = dict(batch_size_per_rank=2, max_seq_length=8192,
              block_diagonal=True, base_seed=2024, shuffle_buffer_size=4)
CODEBERT = dict(batch_size_per_rank=16, bin_size=128, max_seq_length=512,
                base_seed=2024, shuffle_buffer_size=16)
PAIRS_SHARDS, PACKED_SHARDS, CODEBERT_SHARDS = 2, 2, 2
CODEBERT_BYTES = 320 << 10       # source text of the CodeBERT corpus
CODEBERT_BATCHES = 8             # per epoch, at least
PAIRS_BYTES = 320 << 10          # source text of the pairs corpus
PACKED_DOCS = (12, 16)           # documents per packed row
PACKED_TOKENS = (6144, 8192)     # tokens per packed row
PACKED_ROWS = 24                 # at least: warm-up + timed + resume steps
DOC_TOKENS = (500, 680)          # one packed document's token count
SEEDS = range(64)


def _write_source(src, docs):
  os.makedirs(src)
  with open(os.path.join(src, '0.txt'), 'w', encoding='utf-8') as f:
    for i, doc in enumerate(docs):
      f.write(f'synth-{i} {doc}\n')


def _synth_docs(seed, target_bytes):
  from lddl_tpu.core import synth
  words, probs = synth.build_word_population()
  return list(synth.generate_documents(words, probs, target_bytes, seed=seed))


def make_pairs(tmp, seed):
  """lddl_tpu's BERT preprocess and balancer over synth text; returns the
  balanced directory."""
  from lddl_tpu.balance import balance_directory
  from lddl_tpu.pipeline import Executor
  from lddl_tpu.preprocess import bert
  from lddl_tpu.preprocess.readers import read_corpus
  src = os.path.join(tmp, f'pairs_src_{seed}')
  _write_source(src, _synth_docs(seed, PAIRS_BYTES))
  cfg = bert.BertPretrainConfig(
      vocab_file=VOCAB, target_seq_length=PAIRS['max_seq_length'],
      bin_size=PAIRS['bin_size'], duplicate_factor=1, masking=False,
      seed=seed, sentence_backend='rules', tokenizer_backend='hf')
  sink = os.path.join(tmp, f'pairs_sink_{seed}')
  bal = os.path.join(tmp, f'pairs_{seed}')
  bert.run(read_corpus([src], num_blocks=2, sample_ratio=1.0), sink, cfg,
           executor=Executor(num_local_workers=1))
  balance_directory(sink, bal, PAIRS_SHARDS)
  return bal


def make_packed(tmp, seed):
  """lddl_tpu's packed preprocess and balancer over synth documents of
  DOC_TOKENS tokens; returns the balanced directory."""
  from lddl_tpu.balance import balance_directory
  from lddl_tpu.pipeline import Executor
  from lddl_tpu.preprocess import packed
  from lddl_tpu.preprocess.readers import read_corpus
  from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer
  tok = load_bert_tokenizer(vocab_file=VOCAB, backend='hf')
  lo, hi = DOC_TOKENS
  docs = []
  draw = seed
  while len(docs) < PACKED_ROWS * sum(PACKED_DOCS) // 2 + 16:
    batch = _synth_docs(10_000 + draw, 1 << 20)
    draw += 1
    _, offsets = tok.encode_batch_ids(batch)
    n = np.diff(offsets)
    docs += [d for d, k in zip(batch, n) if lo <= k <= hi]
  src = os.path.join(tmp, f'packed_src_{seed}')
  _write_source(src, docs)
  cfg = packed.PackedPretrainConfig(
      vocab_file=VOCAB, target_seq_length=PACKED['max_seq_length'],
      seed=seed, sentence_backend='rules', tokenizer_backend='hf')
  sink = os.path.join(tmp, f'packed_sink_{seed}')
  bal = os.path.join(tmp, f'packed_{seed}')
  packed.run(read_corpus([src], num_blocks=1, sample_ratio=1.0), sink, cfg,
             executor=Executor(num_local_workers=1),
             num_shuffle_partitions=1)
  balance_directory(sink, bal, PACKED_SHARDS)
  return bal


def make_codebert(tmp, seed):
  """lddl_tpu's CodeBERT preprocess and balancer over records made of
  synth text; returns the balanced directory."""
  from lddl_tpu.balance import balance_directory
  from lddl_tpu.pipeline import Executor
  from lddl_tpu.preprocess import codebert
  from lddl_tpu.preprocess.readers import read_code
  src = os.path.join(tmp, f'codebert_src_{seed}')
  os.makedirs(src)
  with open(os.path.join(src, '0.txt'), 'w', encoding='utf-8',
            newline='') as f:
    for i, doc in enumerate(_synth_docs(20_000 + seed, CODEBERT_BYTES)):
      lines = [x.strip() for x in doc.split('. ') if x.strip()]
      if len(lines) < 2:
        continue
      docstring = '' if i % 4 == 3 else lines[0]
      code = '\n'.join(lines[1:])
      f.write(f'synth-{i}<CODESPLIT>{docstring}<CODESPLIT>{code}\r\n')
  cfg = codebert.CodebertPretrainConfig(
      vocab_file=VOCAB, lowercase=True,
      target_seq_length=CODEBERT['max_seq_length'],
      bin_size=CODEBERT['bin_size'], seed=seed)
  sink = os.path.join(tmp, f'codebert_sink_{seed}')
  bal = os.path.join(tmp, f'codebert_{seed}')
  codebert.run(read_code(src, num_blocks=2), sink, cfg,
               executor=Executor(num_local_workers=1))
  balance_directory(sink, bal, CODEBERT_SHARDS)
  return bal


def codebert_ok(path):
  from lddl_tpu.loader import get_codebert_pretrain_data_loader
  n = sum(1 for _ in get_codebert_pretrain_data_loader(
      path, vocab_file=VOCAB, **CODEBERT))
  print(f'  codebert: {n} batches')
  return n >= CODEBERT_BATCHES


def pairs_ok(path):
  from lddl_tpu.loader import get_bert_pretrain_data_loader
  per_bin = {}
  for batch in get_bert_pretrain_data_loader(path, vocab_file=VOCAB,
                                             **PAIRS):
    s = batch['input_ids'].shape[1]
    per_bin[s] = per_bin.get(s, 0) + 1
  print(f'  pairs: batches per bin {dict(sorted(per_bin.items()))}')
  return len(per_bin) == 4 and min(per_bin.values()) >= 2


def packed_ok(path):
  from lddl_tpu.core.utils import deserialize_np_array
  from lddl_tpu.pipeline.parquet_io import read_samples
  from lddl_tpu.core.utils import get_all_parquets_under
  rows = [r for p in get_all_parquets_under(path) for r in read_samples(p)]
  docs = [deserialize_np_array(r['doc_offsets']).shape[0] for r in rows]
  tokens = [int(r['num_tokens']) for r in rows]
  print(f'  packed: {len(rows)} rows, documents {min(docs)}-{max(docs)}, '
        f'tokens {min(tokens)}-{max(tokens)}')
  return (len(rows) >= PACKED_ROWS and
          PACKED_DOCS[0] <= min(docs) and max(docs) <= PACKED_DOCS[1] and
          PACKED_TOKENS[0] <= min(tokens) and max(tokens) <= PACKED_TOKENS[1])


def digests():
  """The settings, and the digest and ledger fingerprint of every epoch-0
  batch of lddl_tpu's loaders over the committed shards."""
  from chip_smoke import batch_sha256
  from lddl_tpu.loader import (get_bert_pretrain_data_loader,
                               get_codebert_pretrain_data_loader,
                               get_packed_pretrain_data_loader)
  from lddl_tpu.telemetry import ledger
  out = {}
  saved = ledger._xxhash
  ledger._xxhash = None  # blake2b-8: the card's machine has no xxhash
  try:
    for name, make, kw in (
        ('pairs', get_bert_pretrain_data_loader, PAIRS),
        ('packed', get_packed_pretrain_data_loader, PACKED),
        ('codebert', get_codebert_pretrain_data_loader, CODEBERT)):
      loader = make(os.path.join(OUT, name), vocab_file=VOCAB, **kw)
      batches = list(loader)
      out[name] = {'settings': kw,
                   'batches': [batch_sha256(b) for b in batches],
                   'ledger': [ledger.fingerprint_batch(b) for b in batches]}
      print(f'  {name}: {len(batches)} batches in epoch 0')
  finally:
    ledger._xxhash = saved
  return out


def _first(make, ok, tmp, name):
  for seed in SEEDS:
    path = make(tmp, seed)
    if ok(path):
      dest = os.path.join(OUT, name)
      shutil.rmtree(dest, ignore_errors=True)
      shutil.copytree(path, dest)
      print(f'  {name}: corpus seed {seed}')
      return seed
  raise RuntimeError(f'no corpus seed in {SEEDS} gives {name} shards that '
                     'meet the phase')


def main():
  os.makedirs(OUT, exist_ok=True)
  if '--digests-only' in sys.argv[1:]:
    with open(os.path.join(OUT, 'digests.json')) as f:
      seeds = {k: v['corpus_seed'] for k, v in json.load(f).items()}
  else:
    with tempfile.TemporaryDirectory(prefix='torch_shards_') as tmp:
      seeds = {'pairs': _first(make_pairs, pairs_ok, tmp, 'pairs'),
               'packed': _first(make_packed, packed_ok, tmp, 'packed'),
               'codebert': _first(make_codebert, codebert_ok, tmp,
                                  'codebert')}
  out = digests()
  for name, seed in seeds.items():
    out[name]['corpus_seed'] = seed
  with open(os.path.join(OUT, 'digests.json'), 'w') as f:
    json.dump(out, f, indent=1, sort_keys=True)
    f.write('\n')
  total = sum(os.path.getsize(os.path.join(r, f))
              for r, _, fs in os.walk(OUT) for f in fs)
  print(f'wrote {OUT}: {total / 2**20:.2f} MiB')


if __name__ == '__main__':
  main()
