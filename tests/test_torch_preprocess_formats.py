"""The port's packed, CodeBERT and BART preprocessors against lddl_tpu's,
on the CPU.

Both packages' ``run()`` over one small synthetic corpus each (the port's
copy of ``core/synth``), ``sentence_backend='rules'``, lddl_tpu with
``tokenizer_backend='native'`` (the split-and-encode calls the port
makes): packed at two target lengths (128 splits the long documents; 512
binned), CodeBERT materialized (``duplicate_factor=1``) and delta (3),
each by the port's columnar path and by its dict path
(``LDDL_NATIVE_COLUMNAR=0``), and BART. Each case gives the same file
names and bin sets, the same per-partition counts, the same Arrow types
and shard-format tags, and the same rows in the same order (lddl_tpu's
files read with pyarrow, the port's with its own reader). Then each
package's balancer over its own sink, and each package's loader over its
balanced shards: the same ``batch_sha256`` for every batch. Last, each
format's CLI, ``main([...])``, writes the rows its ``run()`` wrote. The
corpus holds no letter where lddl_tpu's native folding departs from HF's
(``tests/test_torch_preprocess.py``).
"""

import contextlib
import functools
import glob
import importlib.util
import json
import os

import pyarrow.parquet as pq
import pytest

from lddl_tpu import balance as jbalance
from lddl_tpu import loader as jloader
from lddl_tpu.pipeline.executor import Executor as JExecutor
from lddl_tpu.preprocess import bart as jbart
from lddl_tpu.preprocess import codebert as jcodebert
from lddl_tpu.preprocess import packed as jpacked
from lddl_tpu.preprocess import readers as jreaders
from lddl_tpu_torch import balance as tbalance
from lddl_tpu_torch import loader as tloader
from lddl_tpu_torch import testing
from lddl_tpu_torch.core import synth
from lddl_tpu_torch.pipeline.parquet_io import ParquetFile
from lddl_tpu_torch.preprocess import bart as tbart
from lddl_tpu_torch.preprocess import codebert as tcodebert
from lddl_tpu_torch.preprocess import packed as tpacked
from lddl_tpu_torch.preprocess import readers as treaders
from torch_threads import torch_one_thread_a_file  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
SEED = 13

#: name -> (format, the config's settings, the port's partition path).
CASES = {
    'packed-128': ('packed', dict(target_seq_length=128), None),
    'packed-512-binned': ('packed', dict(target_seq_length=512,
                                         bin_size=128), None),
    'codebert-materialized': ('codebert', dict(
        target_seq_length=512, bin_size=128, duplicate_factor=1), 'columnar'),
    'codebert-materialized-dict': ('codebert', dict(
        target_seq_length=512, bin_size=128, duplicate_factor=1), 'dict'),
    'codebert-delta': ('codebert', dict(
        target_seq_length=256, duplicate_factor=3), 'columnar'),
    'codebert-delta-dict': ('codebert', dict(
        target_seq_length=256, duplicate_factor=3), 'dict'),
    'bart': ('bart', dict(target_seq_length=64), None),
}


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The preprocessors create no shm segment; the shared fixture would
  # count other xdist workers' segments as this test's leak.
  yield


def _keep(c):
  """ASCII, Latin-1 and CJK: where lddl_tpu's folding is HF's."""
  return ord(c) < 0x100 or 0x4e00 <= ord(c) <= 0x9fff


def _filtered(src):
  for path in glob.glob(os.path.join(src, '*.txt')):
    with open(path, encoding='utf-8', newline='') as f:
      text = ''.join(c for c in f.read() if _keep(c))
    with open(path, 'w', encoding='utf-8', newline='') as f:
      f.write(text)
  return src


@pytest.fixture(scope='module')
def sources(tmp_path_factory):
  root = tmp_path_factory.mktemp('formats_src')
  docs = str(root / 'docs')
  synth.write_corpus(docs, 0.1, num_shards=2, seed=SEED)
  code = str(root / 'code')
  testing.write_codebert_source(code, SEED, target_bytes=96 << 10)
  return {'packed': _filtered(docs), 'bart': docs, 'codebert': _filtered(code)}


def _corpus(readers, fmt, src):
  if fmt == 'codebert':
    return readers.read_code(src, num_blocks=3)
  return readers.read_corpus([src], num_blocks=3, sample_ratio=0.9,
                             sample_seed=SEED)


@contextlib.contextmanager
def _partition_path(path):
  """Run the port's CodeBERT partitions by ``path`` ('columnar' | 'dict')
  only: the other path raises if it is taken."""
  saved = os.environ.get('LDDL_NATIVE_COLUMNAR')
  if path == 'dict':
    os.environ['LDDL_NATIVE_COLUMNAR'] = '0'
  else:
    os.environ.pop('LDDL_NATIVE_COLUMNAR', None)
  other = ('_build_partition_table' if path == 'dict'
           else 'documents_from_records')
  taken = getattr(tcodebert, other)

  def refuse(*args, **kwargs):
    raise AssertionError(f'the {path} path ran {other}')

  setattr(tcodebert, other, refuse)
  try:
    yield
  finally:
    setattr(tcodebert, other, taken)
    if saved is None:
      os.environ.pop('LDDL_NATIVE_COLUMNAR', None)
    else:
      os.environ['LDDL_NATIVE_COLUMNAR'] = saved


def _jax_run(fmt, settings, src, sink):
  corpus = _corpus(jreaders, fmt, src)
  with JExecutor(num_local_workers=1) as ex:
    if fmt == 'packed':
      cfg = jpacked.PackedPretrainConfig(
          vocab_file=VOCAB, sentence_backend='rules',
          tokenizer_backend='native', seed=SEED, **settings)
      return jpacked.run(corpus, sink, cfg, executor=ex)
    if fmt == 'codebert':
      cfg = jcodebert.CodebertPretrainConfig(
          vocab_file=VOCAB, tokenizer_backend='native', lowercase=True,
          seed=SEED, **settings)
      return jcodebert.run(corpus, sink, cfg, executor=ex)
    return jbart.run(corpus, sink, jbart.BartPretrainConfig(
        sentence_backend='rules', seed=SEED, **settings), executor=ex)


def _port_run(fmt, settings, src, sink, path):
  corpus = _corpus(treaders, fmt, src)
  if fmt == 'packed':
    return tpacked.run(corpus, sink, tpacked.PackedPretrainConfig(
        vocab_file=VOCAB, sentence_backend='rules', seed=SEED, **settings))
  if fmt == 'codebert':
    with _partition_path(path):
      return tcodebert.run(corpus, sink, tcodebert.CodebertPretrainConfig(
          vocab_file=VOCAB, lowercase=True, seed=SEED, **settings))
  return tbart.run(corpus, sink, tbart.BartPretrainConfig(
      sentence_backend='rules', seed=SEED, **settings))


@pytest.fixture(scope='module')
def sinks(sources, tmp_path_factory):
  """``{case: (lddl_tpu's sink, its counts, the port's sink, its counts)}``."""
  root = tmp_path_factory.mktemp('formats_sinks')
  out = {}
  for name, (fmt, settings, path) in CASES.items():
    jsink, tsink = str(root / f'j-{name}'), str(root / f't-{name}')
    jcounts = _jax_run(fmt, settings, sources[fmt], jsink)
    tcounts = _port_run(fmt, settings, sources[fmt], tsink, path)
    out[name] = (jsink, jcounts, tsink, tcounts)
  return out


def _shards(sink):
  return sorted(p for p in os.listdir(sink) if '.parquet' in p)


def _port_rows(path):
  with ParquetFile(path) as pf:
    return pf.read().to_pylist()


@pytest.mark.parametrize('name', list(CASES))
def test_the_same_shards_and_rows_as_lddl_tpu(sinks, name):
  jsink, jcounts, tsink, tcounts = sinks[name]
  assert tcounts == jcounts
  assert sum(n for c in tcounts for n in c.values()) >= 20
  assert _shards(tsink) == _shards(jsink)
  settings = CASES[name][1]
  if settings.get('bin_size'):
    nbins = settings['target_seq_length'] // settings['bin_size']
    assert all(sorted(c) == list(range(nbins)) for c in tcounts)
  for f in _shards(jsink):
    want = pq.read_table(os.path.join(jsink, f))
    got = pq.read_table(os.path.join(tsink, f))
    assert got.schema.names == want.schema.names
    assert got.schema.types == want.schema.types
    for key in (b'lddl_shard_format', b'lddl_duplicate_factor'):
      assert (got.schema.metadata or {}).get(key) == \
          (want.schema.metadata or {}).get(key), (f, key)
    assert _port_rows(os.path.join(tsink, f)) == want.to_pylist(), f


def test_packed_at_128_splits_long_documents(sinks):
  """Some document of the corpus is longer than a row of 128, so a row of
  packed-128 is one chunk of it: a single document start."""
  tsink = sinks['packed-128'][2]
  rows = [r for f in _shards(tsink)
          for r in _port_rows(os.path.join(tsink, f))]
  from lddl_tpu_torch.core.utils import deserialize_np_array
  starts = [len(deserialize_np_array(r['doc_offsets'])) for r in rows]
  assert min(starts) == 1 and max(starts) > 1
  assert max(r['num_tokens'] for r in rows) == 128


def _balanced(sinks, name, tmp_path):
  jsink, _, tsink, _ = sinks[name]
  jout, tout = str(tmp_path / 'j'), str(tmp_path / 't')
  jmeta = jbalance.balance_directory(jsink, jout, 2)
  tmeta = tbalance.main(['--indir', tsink, '--outdir', tout,
                         '--num-shards', '2'])
  assert tmeta == jmeta
  return jout, tout


@functools.lru_cache(maxsize=None)
def _smoke():
  """chip_smoke.py as a module (its batch_sha256 and token_sha256)."""
  spec = importlib.util.spec_from_file_location(
      'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
  smoke = importlib.util.module_from_spec(spec)
  old = os.environ.get('CUBLAS_WORKSPACE_CONFIG')
  spec.loader.exec_module(smoke)
  if old is None:
    os.environ.pop('CUBLAS_WORKSPACE_CONFIG', None)
  return smoke


def _loaders(name, jout, tout):
  fmt, settings, _ = CASES[name]
  seq = settings['target_seq_length']
  if fmt == 'packed':
    kw = dict(vocab_file=VOCAB, batch_size_per_rank=2, max_seq_length=seq,
              bin_size=settings.get('bin_size'), block_diagonal=True,
              base_seed=3, shuffle_buffer_size=4)
    return (jloader.get_packed_pretrain_data_loader(jout, **kw),
            tloader.get_packed_pretrain_data_loader(tout, **kw))
  if fmt == 'codebert':
    kw = dict(vocab_file=VOCAB, batch_size_per_rank=4, max_seq_length=seq,
              bin_size=settings.get('bin_size'), base_seed=3,
              shuffle_buffer_size=8)
    return (jloader.get_codebert_pretrain_data_loader(jout, **kw),
            tloader.get_codebert_pretrain_data_loader(tout, **kw))
  from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer
  kw = dict(batch_size_per_rank=8, max_seq_length=seq)
  return (jloader.get_bart_pretrain_data_loader(
              jout, tokenizer=load_bert_tokenizer(vocab_file=VOCAB,
                                                  backend='native'), **kw),
          tloader.get_bart_pretrain_data_loader(path=tout, vocab_file=VOCAB,
                                                **kw))


@pytest.mark.parametrize('name', ['packed-128', 'packed-512-binned',
                                  'codebert-materialized', 'codebert-delta',
                                  'bart'])
def test_the_loaders_batches_over_either_packages_shards(sinks, tmp_path,
                                                         name):
  batch_sha256 = _smoke().batch_sha256
  jout, tout = _balanced(sinks, name, tmp_path)
  jax_loader, port_loader = _loaders(name, jout, tout)
  want = [batch_sha256(b) for b in jax_loader]
  got = [batch_sha256(b) for b in port_loader]
  assert len(want) >= 3 and got == want


def _cli_argv(fmt, settings, src, sink):
  argv = ['--source', src, '--sink', sink, '--seed', str(SEED),
          '--num-blocks', '3', '--target-seq-length',
          str(settings['target_seq_length'])]
  if settings.get('bin_size'):
    argv += ['--bin-size', str(settings['bin_size'])]
  if fmt == 'codebert':
    return argv + ['--vocab-file', VOCAB, '--lowercase', '--duplicate-factor',
                   str(settings['duplicate_factor'])]
  argv += ['--sentence-backend', 'rules', '--sample-ratio', '0.9']
  return argv + (['--vocab-file', VOCAB] if fmt == 'packed' else [])


@pytest.mark.parametrize('name', ['packed-512-binned', 'codebert-delta',
                                  'bart'])
def test_each_cli_writes_the_rows_of_run(sinks, sources, tmp_path, name):
  fmt, settings, _ = CASES[name]
  main = {'packed': tpacked, 'codebert': tcodebert, 'bart': tbart}[fmt].main
  sink = str(tmp_path / 'cli')
  counts = main(_cli_argv(fmt, settings, sources[fmt], sink))
  _, _, tsink, tcounts = sinks[name]
  assert counts == tcounts
  assert _shards(sink) == _shards(tsink)
  for f in _shards(tsink):
    assert _port_rows(os.path.join(sink, f)) == \
        _port_rows(os.path.join(tsink, f))


def test_hub_tokenizers_and_hf_are_refused(sources, tmp_path):
  corpus = _corpus(treaders, 'codebert', sources['codebert'])
  with pytest.raises(ValueError, match='hub tokenizers are not ported'):
    tcodebert.run(corpus, str(tmp_path / 'hub'),
                  tcodebert.CodebertPretrainConfig(
                      tokenizer_name='microsoft/codebert-base'))
  with pytest.raises(ValueError, match="backend='hf' is not ported"):
    tpacked.run(_corpus(treaders, 'packed', sources['packed']),
                str(tmp_path / 'hf'), tpacked.PackedPretrainConfig(
                    vocab_file=VOCAB, sentence_backend='rules',
                    tokenizer_backend='hf'))


@pytest.mark.parametrize('name', ['packed', 'codebert', 'bart'])
def test_the_committed_sets_rebuilt_by_the_port(tmp_path, name):
  """chip_smoke.py's 18a on the CPU: the set's source remade from its
  digests.json corpus seed (lddl_tpu_torch.testing's recipe), the port's
  CLI and balancer at tests/make_torch_shards.py's settings, and the
  port's loader over the result: every committed digest."""
  smoke = _smoke()
  with open(os.path.join(ROOT, 'tests', 'assets', 'torch_shards',
                         'digests.json')) as f:
    want = json.load(f)[name]
  src, sink, bal = (str(tmp_path / x) for x in ('src', 'sink', 'bal'))
  testing.write_set_source(name, src, want['corpus_seed'], VOCAB)
  main = {'packed': tpacked, 'codebert': tcodebert, 'bart': tbart}[name].main
  main(testing.shard_set_argv(name, src, sink, want['corpus_seed'], VOCAB))
  tbalance.main(['--indir', sink, '--outdir', bal, '--num-shards',
                 str(testing.SHARD_SETS[name][1])])
  if name == 'bart':
    loader = tloader.get_bart_pretrain_data_loader(
        path=bal, vocab_file=VOCAB, **want['settings'])
    got = [[smoke.batch_sha256(b) for b in loader] for _ in range(2)]
    assert got == want['batches_by_epoch'][:2]
    chunks = smoke.bart_chunks(bal)
    from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
    ids, offsets = load_bert_tokenizer(VOCAB).encode_batch_ids(chunks)
    assert len(chunks) == want['chunks']
    assert smoke.token_sha256(ids, offsets) == want['token_sha256']
    return
  make = {'packed': tloader.get_packed_pretrain_data_loader,
          'codebert': tloader.get_codebert_pretrain_data_loader}[name]
  got = [smoke.batch_sha256(b) for b in make(bal, vocab_file=VOCAB,
                                              **want['settings'])]
  assert got == want['batches']
