"""The BERT preprocessor's ``python`` engine, the port's against lddl_tpu's,
on the CPU.

Each function of the engine with the same seeds in both packages
(``truncate_seq_pair``, both masking functions, ``documents_from_lines``,
``create_pairs_from_document``), then the whole engine through both
packages' ``run()``, masked and unmasked, binned and not: the same file
names, counts and rows, read back with pyarrow. lddl_tpu tokenizes with
its HF backend (its native encoder folds some letters unlike HF: ROADMAP,
"Found in the reference"; the port's equals HF). The engine runs on the
host with no card, whatever the mask backend says; ``--shard-format
delta`` with it raises lddl_tpu's message; through a pool it writes the
serial run's bytes.
"""

import glob
import os
import random

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from lddl_tpu.core.random import rng_from_key as jrng_from_key
from lddl_tpu.preprocess import bert as jbert
from lddl_tpu.preprocess import readers as jreaders
from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer as jtokenizer
from lddl_tpu_torch.core import synth
from lddl_tpu_torch.core.random import rng_from_key
from lddl_tpu_torch.preprocess import bert as tbert
from lddl_tpu_torch.preprocess import readers as treaders
from lddl_tpu_torch.testing import hash_parquets
from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
from torch_threads import torch_one_thread_a_file  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
SEED = 11
SETTINGS = dict(vocab_file=VOCAB, sentence_backend='rules', engine='python',
                target_seq_length=128, duplicate_factor=2, seed=SEED)
RUNS = {
    'masked-binned': dict(masking=True, bin_size=32),
    'unmasked': dict(masking=False),
}


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The engine makes no shm segment; the shared fixture would count other
  # xdist workers' segments as this test's leak.
  yield


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  src = str(tmp_path_factory.mktemp('python_engine') / 'source')
  synth.write_corpus(src, 0.12, num_shards=2, seed=5)
  return src


@pytest.fixture(scope='module')
def tokenizers():
  return load_bert_tokenizer(VOCAB), jtokenizer(vocab_file=VOCAB,
                                                backend='hf')


def _read(package, src):
  return package.read_corpus([src], num_blocks=3, sample_ratio=0.9,
                             sample_seed=SEED)


def _lines(corpus, n=60):
  lines = []
  for path in sorted(glob.glob(os.path.join(corpus, '*.txt'))):
    with open(path, encoding='utf-8') as f:
      lines += f.read().splitlines()
  return lines[:n]


def test_truncate_seq_pair():
  r = random.Random(3)
  for case in range(200):
    a = [f'a{i}' for i in range(r.randrange(0, 40))]
    b = [f'b{i}' for i in range(r.randrange(0, 40))]
    limit = r.randrange(1, 60)
    got, want = (list(a), list(b)), (list(a), list(b))
    tbert.truncate_seq_pair(*got, limit, random.Random(case))
    jbert.truncate_seq_pair(*want, limit, random.Random(case))
    assert got == want and len(got[0]) + len(got[1]) <= max(limit, 0)


@pytest.mark.parametrize('numpy_rng', [False, True])
def test_masked_lm_predictions(tokenizers, numpy_rng):
  vocab = tokenizers[0].vocab_words
  r = random.Random(5)
  for case in range(100):
    a = [r.choice(vocab) for _ in range(r.randrange(1, 60))]
    b = [r.choice(vocab) for _ in range(r.randrange(1, 60))]
    cap = r.choice([None, 3, 20])
    if numpy_rng:
      got = tbert.create_masked_lm_predictions_np(
          a, b, 0.15, vocab, np.random.Generator(np.random.Philox(key=case)),
          max_predictions=cap)
      want = jbert.create_masked_lm_predictions_np(
          a, b, 0.15, vocab, np.random.Generator(np.random.Philox(key=case)),
          max_predictions=cap)
    else:
      got = tbert.create_masked_lm_predictions(
          a, b, 0.15, vocab, random.Random(case), max_predictions=cap)
      want = jbert.create_masked_lm_predictions(
          a, b, 0.15, vocab, random.Random(case), max_predictions=cap)
    assert got == want


def test_documents_from_lines(corpus, tokenizers):
  lines = _lines(corpus) + ['doc-x', 'doc-y    ', 'doc-z . . .']
  got = tbert.documents_from_lines(lines, tokenizers[0],
                                   sentence_backend='rules')
  want = jbert.documents_from_lines(lines, tokenizers[1],
                                    sentence_backend='rules')
  assert len(got) == len(want) > 40
  assert [(d.doc_id, d.sentences) for d in got] == \
      [(d.doc_id, d.sentences) for d in want]


@pytest.mark.parametrize('masking', [False, True])
def test_create_pairs_from_document(corpus, tokenizers, masking):
  tok, jtok = tokenizers
  docs = tbert.documents_from_lines(_lines(corpus), tok,
                                    sentence_backend='rules')
  jdocs = jbert.documents_from_lines(_lines(corpus), jtok,
                                     sentence_backend='rules')
  for tgt, (seq, short) in enumerate([(128, 0.1), (64, 0.5), (512, 0.0)]):
    rng, jrng = rng_from_key(SEED, 'pairs', tgt), jrng_from_key(
        SEED, 'pairs', tgt)
    np_rng = np.random.Generator(np.random.Philox(key=[SEED, tgt]))
    jnp_rng = np.random.Generator(np.random.Philox(key=[SEED, tgt]))
    got, want = [], []
    for di in range(len(docs)):
      got += tbert.create_pairs_from_document(
          docs, di, rng, max_seq_length=seq, short_seq_prob=short,
          masking=masking, vocab_words=tok.vocab_words,
          np_rng=np_rng if tgt != 2 else None)
      want += jbert.create_pairs_from_document(
          jdocs, di, jrng, max_seq_length=seq, short_seq_prob=short,
          masking=masking, vocab_words=jtok.vocab_words,
          np_rng=jnp_rng if tgt != 2 else None)
    assert got == want and len(got) > 20


@pytest.mark.parametrize('name', list(RUNS))
def test_the_engine_writes_lddl_tpus_rows(corpus, tmp_path, monkeypatch,
                                          name):
  """Both packages' run() with engine='python': the port with no card and
  its default mask backend (device), which the engine never uses."""
  settings = dict(SETTINGS, **RUNS[name])
  jsink, tsink = str(tmp_path / 'j'), str(tmp_path / 't')
  jcounts = jbert.run(_read(jreaders, corpus), jsink,
                      jbert.BertPretrainConfig(tokenizer_backend='hf',
                                               **settings),
                      executor=jbert.Executor(num_local_workers=1))
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  tcounts = tbert.run(_read(treaders, corpus), tsink,
                      tbert.BertPretrainConfig(**settings))
  assert tcounts == jcounts
  names = sorted(n for n in os.listdir(jsink) if '.parquet' in n)
  assert sorted(n for n in os.listdir(tsink) if '.parquet' in n) == names
  rows = 0
  for n in names:
    got = pq.read_table(os.path.join(tsink, n))
    want = pq.read_table(os.path.join(jsink, n))
    assert [(f.name, f.type) for f in got.schema] == \
        [(f.name, f.type) for f in want.schema], n
    assert got.to_pylist() == want.to_pylist(), n
    rows += got.num_rows
  assert rows == sum(n for c in tcounts for n in c.values()) > 100


def test_the_cli_through_a_pool_and_the_delta_refusal(corpus, tmp_path):
  """``--engine python`` at two pool workers writes the serial run's
  bytes; ``--shard-format delta`` with it raises lddl_tpu's message."""
  argv = ['--source', corpus, '--vocab-file', VOCAB, '--engine', 'python',
          '--masking', '--duplicate-factor', '2', '--target-seq-length',
          '128', '--bin-size', '64', '--num-blocks', '3',
          '--sentence-backend', 'rules', '--seed', str(SEED)]
  serial, pooled = str(tmp_path / 's'), str(tmp_path / 'p')
  assert tbert.main(argv + ['--sink', serial]) == \
      tbert.main(argv + ['--sink', pooled, '--num-workers', '2'])
  assert hash_parquets(serial) == hash_parquets(pooled) != {}
  msgs = []
  for package in (tbert, jbert):
    with pytest.raises(ValueError) as e:
      package.resolve_shard_format(package.BertPretrainConfig(
          engine='python', masking=True, shard_format='delta'))
    msgs.append(str(e.value))
  assert msgs[0] == msgs[1] and 'fast engine' in msgs[0]
  with pytest.raises(ValueError, match='fast engine'):
    tbert.main(argv + ['--sink', str(tmp_path / 'd'), '--shard-format',
                       'delta'])
  assert tbert.resolve_shard_format(tbert.BertPretrainConfig(
      engine='python', masking=True, duplicate_factor=5)) == 'materialized'
