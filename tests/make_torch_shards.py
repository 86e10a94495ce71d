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
  - ``packed_small/``: the same through the packed preprocess at
    ``target_seq_length=512`` (documents of 31-42 tokens, 12-16 a row),
    for the CPU tests;
  - ``codebert/``: ``id<CODESPLIT>docstring<CODESPLIT>code`` records made
    of the same text (a document's first sentence is its docstring, none
    for every fourth; its other sentences are the code lines) through
    lddl_tpu's CodeBERT preprocess with the same vocab (binned:
    ``bin_size=128``, ``target_seq_length=512``), balanced;
  - ``bart/``: raw ``sentences`` chunks of the same text through
    lddl_tpu's BART preprocess (``target_seq_length=128``, its default),
    balanced; its digests hold, besides each batch's of epochs 0 and 1
    (lddl_tpu's BART loader at its defaults, tokenizing with
    ``load_bert_tokenizer(vocab_file=VOCAB, backend='hf')``), the sha256
    of every chunk's ids under that tokenizer (``token_sha256``: the
    flat int32 ids, then the int64 offsets), which the port's native
    encoder must give too (lddl_tpu's own native encoder does not: it
    folds some Cyrillic letters of the text wrongly);
  - ``digests.json``: the loader settings of chip_smoke.py's phases 7 and
    8 and, for every batch of epoch 0 that lddl_tpu's loaders give over
    these shards with them, its ``batch_sha256`` (chip_smoke.py) and its
    determinism-ledger fingerprint (``ledger``: lddl_tpu's
    ``fingerprint_batch`` under blake2b-8, the digest the ledger writes
    where ``xxhash`` is not installed, as on the card's machine).

``--digests-only`` keeps the committed shards and rewrites digests.json
from them (after a change to the settings below, lddl_tpu's loaders or
``batch_sha256``). ``--only NAME`` makes the set NAME anew and keeps the
others' shards.

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
# chip_smoke.py's phase 13: lddl_tpu's BART loader at its defaults.
BART = dict(batch_size_per_rank=64, max_seq_length=128, noise_density=0.3,
            poisson_lambda=3.0)
BART_EPOCHS = 2
PAIRS_SHARDS, PACKED_SHARDS, CODEBERT_SHARDS, BART_SHARDS = 2, 2, 2, 2
BART_BYTES = 480 << 10           # source text of the BART corpus
BART_BATCHES = 8                 # per epoch, at least
CODEBERT_BYTES = 320 << 10       # source text of the CodeBERT corpus
CODEBERT_BATCHES = 8             # per epoch, at least
PAIRS_BYTES = 320 << 10          # source text of the pairs corpus
PACKED_DOCS = (12, 16)           # documents per packed row
PACKED_TOKENS = (6144, 8192)     # tokens per packed row
PACKED_ROWS = 24                 # at least: warm-up + timed + resume steps
DOC_TOKENS = (500, 680)          # one packed document's token count
# packed_small/: the same documents at 1/16 the length, rows of 512 for
# the CPU tests of a sharded run's replay (a step at 8192 takes a minute
# there even at the tiny model).
PACKED_SMALL = dict(batch_size_per_rank=2, max_seq_length=512,
                    block_diagonal=True, base_seed=2024,
                    shuffle_buffer_size=4)
PACKED_SMALL_SHAPE = dict(docs=(12, 16), tokens=(384, 512), rows=24,
                          doc_tokens=(31, 42))
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


def make_packed(tmp, seed, name='packed', settings=PACKED,
                doc_tokens=DOC_TOKENS, rows=PACKED_ROWS, docs=PACKED_DOCS,
                draw_bytes=1 << 20):
  """lddl_tpu's packed preprocess and balancer over synth documents of
  ``doc_tokens`` tokens; returns the balanced directory."""
  from lddl_tpu.balance import balance_directory
  from lddl_tpu.pipeline import Executor
  from lddl_tpu.preprocess import packed
  from lddl_tpu.preprocess.readers import read_corpus
  from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer
  tok = load_bert_tokenizer(vocab_file=VOCAB, backend='hf')
  lo, hi = doc_tokens
  kept = []
  draw = seed
  while len(kept) < rows * sum(docs) // 2 + 16:
    batch = _synth_docs(10_000 + draw, draw_bytes)
    draw += 1
    _, offsets = tok.encode_batch_ids(batch)
    n = np.diff(offsets)
    kept += [d for d, k in zip(batch, n) if lo <= k <= hi]
  src = os.path.join(tmp, f'{name}_src_{seed}')
  _write_source(src, kept)
  cfg = packed.PackedPretrainConfig(
      vocab_file=VOCAB, target_seq_length=settings['max_seq_length'],
      seed=seed, sentence_backend='rules', tokenizer_backend='hf')
  sink = os.path.join(tmp, f'{name}_sink_{seed}')
  bal = os.path.join(tmp, f'{name}_{seed}')
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


def make_bart(tmp, seed):
  """lddl_tpu's BART preprocess and balancer over synth text; returns the
  balanced directory."""
  from lddl_tpu.balance import balance_directory
  from lddl_tpu.pipeline import Executor
  from lddl_tpu.preprocess import bart
  from lddl_tpu.preprocess.readers import read_corpus
  src = os.path.join(tmp, f'bart_src_{seed}')
  _write_source(src, _synth_docs(30_000 + seed, BART_BYTES))
  cfg = bart.BartPretrainConfig(target_seq_length=BART['max_seq_length'],
                                sentence_backend='rules', seed=seed)
  sink = os.path.join(tmp, f'bart_sink_{seed}')
  bal = os.path.join(tmp, f'bart_{seed}')
  bart.run(read_corpus([src], num_blocks=2, sample_ratio=1.0), sink, cfg,
           executor=Executor(num_local_workers=1))
  balance_directory(sink, bal, BART_SHARDS)
  return bal


def bart_ok(path):
  from lddl_tpu.loader import get_bart_pretrain_data_loader
  from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer
  n = sum(1 for _ in get_bart_pretrain_data_loader(
      path, tokenizer=load_bert_tokenizer(vocab_file=VOCAB, backend='hf'),
      **BART))
  print(f'  bart: {n} batches')
  return n >= BART_BATCHES


def bart_chunks(path):
  """Every ``sentences`` chunk of the shards under ``path``, file by file
  in the loaders' order, rows in file order."""
  import pyarrow.parquet as pq
  from lddl_tpu.core.utils import get_all_parquets_under
  return [t for p in get_all_parquets_under(path)
          for t in pq.read_table(p, columns=['sentences']).column(0)
          .to_pylist()]


def bart_digests(path):
  """The token digest of every chunk and, for BART_EPOCHS epochs, every
  batch's digest and ledger fingerprint from lddl_tpu's BART loader, all
  through its HF tokenizer."""
  from chip_smoke import batch_sha256, token_sha256
  from lddl_tpu.loader import get_bart_pretrain_data_loader
  from lddl_tpu.telemetry import ledger
  from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.tokenization.wordpiece import (
      load_bert_tokenizer as port_tokenizer)
  hf = load_bert_tokenizer(vocab_file=VOCAB, backend='hf')
  native = load_bert_tokenizer(vocab_file=VOCAB, backend='native')
  chunks = bart_chunks(path)
  ids, offsets = hf.encode_batch_ids(chunks)
  pids, poffsets = port_tokenizer(VOCAB).encode_batch_ids(chunks)
  assert np.array_equal(ids, pids) and np.array_equal(offsets, poffsets), (
      "the port's native encoder and lddl_tpu's HF tokenizer disagree on "
      'bart/')
  # lddl_tpu's own native encoder folds some Cyrillic letters wrongly (a
  # fault of the JAX package, not of these shards): count its departures.
  nids, noffsets = native.encode_batch_ids(chunks)
  off = sum(1 for i in range(len(chunks)) if not np.array_equal(
      ids[offsets[i]:offsets[i + 1]], nids[noffsets[i]:noffsets[i + 1]]))
  print(f"  bart: lddl_tpu's native encoder departs from HF in {off} of "
        f'{len(chunks)} chunks')
  loader = get_bart_pretrain_data_loader(path, tokenizer=hf, **BART)
  epochs = [list(loader) for _ in range(BART_EPOCHS)]
  print(f'  bart: {len(chunks)} chunks, {len(ids)} tokens, '
        f'{[len(e) for e in epochs]} batches an epoch')
  return {'settings': BART, 'chunks': len(chunks), 'tokens': len(ids),
          'token_sha256': token_sha256(ids, offsets),
          'batches_by_epoch': [[batch_sha256(b) for b in e] for e in epochs],
          'ledger_by_epoch': [[ledger.fingerprint_batch(b) for b in e]
                              for e in epochs]}


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


def packed_ok(path, rows_min=PACKED_ROWS, docs_range=PACKED_DOCS,
              tokens_range=PACKED_TOKENS):
  from lddl_tpu.core.utils import deserialize_np_array
  from lddl_tpu.pipeline.parquet_io import read_samples
  from lddl_tpu.core.utils import get_all_parquets_under
  rows = [r for p in get_all_parquets_under(path) for r in read_samples(p)]
  docs = [deserialize_np_array(r['doc_offsets']).shape[0] for r in rows]
  tokens = [int(r['num_tokens']) for r in rows]
  print(f'  packed: {len(rows)} rows, documents {min(docs)}-{max(docs)}, '
        f'tokens {min(tokens)}-{max(tokens)}')
  return (len(rows) >= rows_min and
          docs_range[0] <= min(docs) and max(docs) <= docs_range[1] and
          tokens_range[0] <= min(tokens) and max(tokens) <= tokens_range[1])


def make_packed_small(tmp, seed):
  shape = PACKED_SMALL_SHAPE
  return make_packed(tmp, seed, 'packed_small', PACKED_SMALL,
                     shape['doc_tokens'], shape['rows'], shape['docs'],
                     draw_bytes=1 << 17)


def packed_small_ok(path):
  shape = PACKED_SMALL_SHAPE
  return packed_ok(path, shape['rows'], shape['docs'], shape['tokens'])


def digests():
  """The settings, and the digest and ledger fingerprint of every epoch-0
  batch of lddl_tpu's loaders over the committed shards (epochs 0 and 1
  for bart/, with its token digest)."""
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
        ('packed_small', get_packed_pretrain_data_loader, PACKED_SMALL),
        ('codebert', get_codebert_pretrain_data_loader, CODEBERT)):
      loader = make(os.path.join(OUT, name), vocab_file=VOCAB, **kw)
      batches = list(loader)
      out[name] = {'settings': kw,
                   'batches': [batch_sha256(b) for b in batches],
                   'ledger': [ledger.fingerprint_batch(b) for b in batches]}
      print(f'  {name}: {len(batches)} batches in epoch 0')
    out['bart'] = bart_digests(os.path.join(OUT, 'bart'))
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


SETS = {'pairs': (make_pairs, pairs_ok), 'packed': (make_packed, packed_ok),
        'packed_small': (make_packed_small, packed_small_ok),
        'codebert': (make_codebert, codebert_ok),
        'bart': (make_bart, bart_ok)}


def main():
  os.makedirs(OUT, exist_ok=True)
  argv = sys.argv[1:]
  seeds = {}
  if '--digests-only' in argv or '--only' in argv:
    with open(os.path.join(OUT, 'digests.json')) as f:
      seeds = {k: v['corpus_seed'] for k, v in json.load(f).items()
             if 'corpus_seed' in v}
  remake = (set() if '--digests-only' in argv else
            {argv[argv.index('--only') + 1]} if '--only' in argv else
            set(SETS))
  with tempfile.TemporaryDirectory(prefix='torch_shards_') as tmp:
    for name in SETS:
      if name in remake:
        seeds[name] = _first(*SETS[name], tmp, name)
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
