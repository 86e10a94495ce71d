"""The port's corpus loaders against lddl_tpu's, batch for batch.

Shards come from lddl_tpu's own preprocess and balancer (into a tmp dir,
once per module); both packages' loaders then read them, the JAX one
through pyarrow and its HF tokenizer, the port through its own Parquet
reader and vocab map, and every batch must be equal byte for byte
(:func:`chip_smoke.batch_sha256`). Also: the vocab map against
``BertTokenizerFast`` on the bench vocab, the committed shard assets of
chip_smoke.py's phase 7 against their digests, and the collates'
``loader.*`` telemetry against the JAX package's.
"""

import importlib.util
import json
import os
import shutil
from pathlib import Path

import pytest

from lddl_tpu import telemetry as jtelemetry
from lddl_tpu.balance import balance_directory
from lddl_tpu.loader import get_bert_pretrain_data_loader as jax_bert_loader
from lddl_tpu.loader import \
    get_codebert_pretrain_data_loader as jax_codebert_loader
from lddl_tpu.loader import get_packed_pretrain_data_loader as jax_packed_loader
from lddl_tpu.pipeline import Executor
from lddl_tpu.preprocess import bert, packed
from lddl_tpu.preprocess.readers import read_corpus
from lddl_tpu.testing import write_word_corpus, write_word_vocab
from lddl_tpu_torch import telemetry as ttelemetry
from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                   get_codebert_pretrain_data_loader,
                                   get_packed_pretrain_data_loader)
from lddl_tpu_torch.loader.dataset import count_samples
from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


ROOT = Path(__file__).resolve().parent.parent
ASSETS = ROOT / 'tests' / 'assets' / 'torch_shards'
BENCH_VOCAB = str(ROOT / 'benchmarks' / 'assets' / 'bench_vocab_30522.txt')


@pytest.fixture(scope='module')
def batch_sha256():
  """chip_smoke.py's batch digest (the one definition of it)."""
  old = os.environ.get('CUBLAS_WORKSPACE_CONFIG')
  spec = importlib.util.spec_from_file_location('chip_smoke',
                                                ROOT / 'chip_smoke.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  # chip_smoke sets this at import when it is unset; keep it to itself.
  if old is None:
    os.environ.pop('CUBLAS_WORKSPACE_CONFIG', None)
  return module.batch_sha256


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  """Balanced shards lddl_tpu wrote: BERT pairs (binned and unbinned,
  unmasked; static and mask-delta, binned) and packed rows (binned)."""
  root = tmp_path_factory.mktemp('torch_loader')
  vocab = str(root / 'vocab.txt')
  write_word_vocab(vocab)
  src = str(root / 'source')
  write_word_corpus(src, num_docs=100, num_shards=2, seed=11,
                    sents_range=(2, 10), words_range=(4, 20))
  out = {'vocab': vocab}
  runs = {
      'binned': dict(bin_size=16),
      'unbinned': dict(),
      'static': dict(bin_size=16, masking=True,
                     shard_format='materialized'),
      'delta': dict(bin_size=16, masking=True),
  }
  for name, kw in runs.items():
    cfg = bert.BertPretrainConfig(
        vocab_file=vocab, target_seq_length=64, duplicate_factor=2, seed=5,
        sentence_backend='rules', tokenizer_backend='hf', **kw)
    sink = str(root / f'{name}_sink')
    bert.run(read_corpus([src], num_blocks=2, sample_ratio=1.0), sink, cfg,
             executor=Executor(num_local_workers=1))
    out[name] = str(root / name)
    balance_directory(sink, out[name], 4)
  cfg = packed.PackedPretrainConfig(
      vocab_file=vocab, target_seq_length=256, bin_size=64, seed=5,
      sentence_backend='rules', tokenizer_backend='hf')
  sink = str(root / 'packed_sink')
  packed.run(read_corpus([src], num_blocks=2, sample_ratio=1.0), sink, cfg,
             executor=Executor(num_local_workers=1))
  out['packed'] = str(root / 'packed')
  balance_directory(sink, out['packed'], 2)
  return out


def _digests(loader, sha, epochs=2):
  """Per epoch, the digest of every batch (micro-batch lists: of each
  micro-batch; raw rows: their repr)."""
  out = []
  for _ in range(epochs):
    epoch = []
    for batch in loader:
      if isinstance(batch, dict):
        epoch.append(sha(batch))
      elif batch and isinstance(batch[0], dict) and 'text' in batch[0]:
        epoch.append([sha(m) for m in batch])
      else:
        epoch.append(repr(batch))
    out.append(epoch)
  return out


def _pair(jax_make, torch_make, path, mode, **kw):
  """The JAX loader and the port's, built alike for ``mode``."""
  if mode == 'micro':
    kw['micro_batch_size'] = 2
  if mode == 'samples_seen':
    kw['samples_seen'] = 36
  if mode == 'raw':
    kw['return_raw_samples'] = True
  if mode == 'dp2':
    return [(jax_make(path, dp_rank=r, dp_world_size=2, **kw),
             torch_make(path, dp_rank=r, dp_world_size=2, **kw))
            for r in range(2)]
  loaders = (jax_make(path, **kw), torch_make(path, **kw))
  if mode == 'seek':
    for loader in loaders:
      loader.seek(0, 5)
  return [loaders]


@pytest.mark.parametrize('mode', ['plain', 'dp2', 'micro', 'samples_seen',
                                  'seek', 'raw'])
@pytest.mark.parametrize('kind', ['binned', 'unbinned', 'static', 'delta'])
def test_bert_batches_equal_lddl_tpu(corpus, batch_sha256, kind, mode):
  """Two epochs of NSP-pair batches, binned and unbinned, dynamic, static
  and mask-delta masking; both dp ranks of a world of 2, micro-batches,
  a samples_seen resume, a mid-epoch seek, raw rows."""
  kw = dict(vocab_file=corpus['vocab'], batch_size_per_rank=4,
            masking='dynamic' if kind in ('binned', 'unbinned') else
            'static', bin_size=None if kind == 'unbinned' else 16,
            max_seq_length=64, base_seed=9, shuffle_buffer_size=64)
  for jl, tl in _pair(jax_bert_loader, get_bert_pretrain_data_loader,
                      corpus[kind], mode, **kw):
    want = _digests(jl, batch_sha256)
    assert all(want), 'an epoch without batches'
    assert _digests(tl, batch_sha256) == want
    assert tl.tell() == jl.tell()


@pytest.mark.parametrize('mode', ['plain', 'dp2', 'seek', 'raw'])
@pytest.mark.parametrize('block_diagonal', [True, False],
                         ids=['block_diagonal', 'dense'])
def test_packed_batches_equal_lddl_tpu(corpus, batch_sha256, block_diagonal,
                                       mode):
  kw = dict(vocab_file=corpus['vocab'], batch_size_per_rank=2,
            max_seq_length=256, bin_size=64, base_seed=4,
            sequence_length_alignment=64, block_diagonal=block_diagonal)
  for jl, tl in _pair(jax_packed_loader, get_packed_pretrain_data_loader,
                      corpus['packed'], mode, **kw):
    want = _digests(jl, batch_sha256)
    assert all(want), 'an epoch without batches'
    assert _digests(tl, batch_sha256) == want


def test_collate_telemetry_matches_lddl_tpu(corpus):
  """The loader.* counters, histograms and their counts of one epoch."""
  def drain(tele_mod, make, **kw):
    tele = tele_mod.enable()
    try:
      for _ in make(corpus['binned'], vocab_file=corpus['vocab'],
                    batch_size_per_rank=4, bin_size=16, max_seq_length=64,
                    base_seed=9, **kw):
        pass
    finally:
      tele_mod.disable()
    out = {}
    for line in tele.snapshot_lines():
      if line.get('name', '').startswith('loader.'):
        out[line['name']] = (line['kind'], line.get('total',
                                                    line.get('count')))
    return out

  want = drain(jtelemetry, jax_bert_loader)
  got = drain(ttelemetry, get_bert_pretrain_data_loader)
  assert got == want
  assert {'loader.batches', 'loader.rows', 'loader.read_batch_seconds',
          'loader.collated_rows'} <= set(got)
  assert any(k.startswith('loader.collate_seconds.s') for k in got)


def test_counts_from_footers_equal_the_cache(corpus, tmp_path):
  files = sorted(str(p) for p in Path(corpus['binned']).glob('*.parquet_*'))
  cached = count_samples(files)
  copy = tmp_path / 'nocache'
  shutil.copytree(corpus['binned'], copy)
  os.remove(copy / '.num_samples.json')
  plain = count_samples(sorted(str(copy / os.path.basename(f))
                               for f in files))
  assert list(plain.values()) == list(cached.values())


def test_hub_tokenizers_are_not_ported(corpus):
  """Hub tokenizers are not ported: the port's loaders take a vocab file
  (worker processes are, tests/test_torch_workers.py)."""
  with pytest.raises(TypeError, match='tokenizer_name'):
    get_bert_pretrain_data_loader(corpus['binned'],
                                  tokenizer_name='bert-base-uncased')
  with pytest.raises(ValueError, match='vocab_file'):
    load_bert_tokenizer(None)


def test_vocab_map_matches_bert_tokenizer_fast():
  """Special ids, vocab_size, the ids of every token in the committed
  pairs shards, and unknown tokens ([UNK], as the fast tokenizer)."""
  import pyarrow.parquet as pq
  from transformers import BertTokenizerFast
  hf = BertTokenizerFast(vocab_file=BENCH_VOCAB, do_lower_case=True)
  ours = load_bert_tokenizer(vocab_file=BENCH_VOCAB)
  for name in ('cls', 'sep', 'mask', 'pad', 'unk'):
    assert getattr(ours, f'{name}_token_id') == getattr(hf,
                                                        f'{name}_token_id')
  assert ours.vocab_size == hf.vocab_size == len(hf.get_vocab())
  tokens = sorted({t for p in sorted((ASSETS / 'pairs').glob('*.parquet_*'))
                   for col in ('A', 'B')
                   for s in pq.read_table(p, columns=[col]).column(0)
                   .to_pylist() for t in s.split()})
  assert len(tokens) > 1000
  tokens += ['qqqzzz', 'Hello', '##', '[unused0]', '']
  assert ours.convert_tokens_to_ids(tokens) == hf.convert_tokens_to_ids(
      tokens)
  assert ours.convert_tokens_to_ids(['qqqzzz']) == [hf.unk_token_id]


@pytest.mark.parametrize('name', ['pairs', 'packed', 'packed_small',
                                  'codebert'])
def test_committed_shards_match_their_digests(batch_sha256, name,
                                              monkeypatch):
  """digests.json is what lddl_tpu's loaders give over the committed
  shards today, and the port's loaders give the same; its ledger entries
  are the port's blake2b-8 fingerprints of those batches (the card's
  machine has no xxhash)."""
  from lddl_tpu_torch.telemetry import ledger
  monkeypatch.setattr(ledger, '_xxhash', None)
  with open(ASSETS / 'digests.json') as f:
    entry = json.load(f)[name]
  make = {'pairs': (jax_bert_loader, get_bert_pretrain_data_loader),
          'packed': (jax_packed_loader, get_packed_pretrain_data_loader),
          'packed_small': (jax_packed_loader,
                           get_packed_pretrain_data_loader),
          'codebert': (jax_codebert_loader,
                       get_codebert_pretrain_data_loader)}[name]
  for loader in make:
    batches = list(loader(str(ASSETS / name), vocab_file=BENCH_VOCAB,
                          **entry['settings']))
    assert [batch_sha256(b) for b in batches] == entry['batches']
  assert [ledger.fingerprint_batch(b) for b in batches] == entry['ledger']
  sizes = sum(p.stat().st_size for p in ASSETS.rglob('*') if p.is_file())
  assert sizes < 2 << 20


def test_committed_pairs_hold_two_batches_per_bin():
  loader = get_bert_pretrain_data_loader(
      str(ASSETS / 'pairs'), vocab_file=BENCH_VOCAB,
      **json.loads((ASSETS / 'digests.json').read_text())['pairs'][
          'settings'])
  seqs = {}
  for batch in loader:
    s = batch['input_ids'].shape[1]
    seqs[s] = seqs.get(s, 0) + 1
  assert sorted(seqs) == [128, 256, 384, 512]
  assert min(seqs.values()) >= 2
