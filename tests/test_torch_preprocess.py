"""The port's BERT preprocessor and balancer against lddl_tpu's, on the CPU.

Both packages' ``run()`` over one small synthetic corpus (the port's copy
of ``core/synth``), ``sentence_backend='rules'``, lddl_tpu with
``tokenizer_backend='native'`` (the same split-and-encode call the port
makes): the same file names and bin sets, the same per-partition counts,
the same rows in the same order, under the host mask backend and under
the device backend (here its plain version, ``device='cpu'``, which the
caller asks for). The corpus holds no letter where lddl_tpu's native
folding departs from HF's (the port's encoder folds as HF does), and
:func:`test_the_corpus_avoids_the_folding_departures` holds it to that.
Then both balancers over one sink, and lddl_tpu's loader over the port's
balanced shards against over its own.
"""

import glob
import json
import os

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from lddl_tpu import balance as jbalance
from lddl_tpu.loader import get_bert_pretrain_data_loader as jax_bert_loader
from lddl_tpu.pipeline.executor import Executor as JExecutor
from lddl_tpu.preprocess import bert as jbert
from lddl_tpu.preprocess import readers as jreaders
from lddl_tpu_torch import balance as tbalance
from lddl_tpu_torch.core import synth
from lddl_tpu_torch.pipeline.executor import Executor
from lddl_tpu_torch.preprocess import bert as tbert
from lddl_tpu_torch.preprocess import readers as treaders
from torch_threads import torch_one_thread_a_file  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
SEED = 7
SETTINGS = dict(vocab_file=VOCAB, sentence_backend='rules',
                target_seq_length=128, bin_size=64, seed=SEED)
RUNS = {
    'host-delta': dict(mask_backend='host', masking=True),
    'device-delta': dict(mask_backend='device', masking=True),
    'device-materialized': dict(mask_backend='device', masking=True,
                                shard_format='materialized',
                                duplicate_factor=2, bin_size=None),
}

@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


def _keep(c):
  """ASCII, Latin-1 and CJK: where lddl_tpu's folding is HF's."""
  return ord(c) < 0x100 or 0x4e00 <= ord(c) <= 0x9fff


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  src = str(tmp_path_factory.mktemp('torch_preprocess') / 'source')
  synth.write_corpus(src, 0.25, num_shards=2, seed=3)
  for path in glob.glob(os.path.join(src, '*.txt')):
    with open(path, encoding='utf-8') as f:
      text = ''.join(c for c in f.read() if _keep(c))
    with open(path, 'w', encoding='utf-8') as f:
      f.write(text)
  return src


def _read(package, src):
  return package.read_corpus([src], num_blocks=3, sample_ratio=0.9,
                             sample_seed=SEED)


@pytest.fixture(scope='module')
def sinks(corpus, tmp_path_factory):
  """``{run: (lddl_tpu's sink, its counts, the port's sink, its counts)}``."""
  root = tmp_path_factory.mktemp('sinks')
  out = {}
  for name, kw in RUNS.items():
    settings = dict(SETTINGS, **kw)
    jsink, tsink = str(root / f'j-{name}'), str(root / f't-{name}')
    with JExecutor(num_local_workers=1) as ex:
      jcounts = jbert.run(_read(jreaders, corpus), jsink,
                          jbert.BertPretrainConfig(tokenizer_backend='native',
                                                   **settings), executor=ex)
    tcounts = tbert.run(_read(treaders, corpus), tsink,
                        tbert.BertPretrainConfig(device='cpu', **settings))
    out[name] = (jsink, jcounts, tsink, tcounts)
  return out


def _shards(sink):
  return sorted(p for p in os.listdir(sink) if '.parquet' in p)


def test_the_corpus_avoids_the_folding_departures(corpus):
  """Every non-ASCII letter of the corpus encodes alike in both packages'
  native encoders (lddl_tpu departs from HF on others: ROADMAP, "Found
  in the reference")."""
  from lddl_tpu.native import NativeWordPiece as JNative
  from lddl_tpu_torch.tokenization.wordpiece import BertWordPiece
  text = ''.join(open(p, encoding='utf-8').read()
                 for p in glob.glob(os.path.join(corpus, '*.txt')))
  letters = sorted({c for c in text if ord(c) > 0x7f})
  assert letters and all(_keep(c) for c in letters)
  port = BertWordPiece(VOCAB)
  jax = JNative(port.vocab_words)
  for c in letters:
    want = jax.encode_batch_ids([c, c.upper()])
    got = port.encode_batch_ids([c, c.upper()])
    assert all(np.array_equal(w, g) for w, g in zip(want, got)), c


@pytest.mark.parametrize('name', list(RUNS))
def test_the_same_shards_and_rows_as_lddl_tpu(sinks, name):
  jsink, jcounts, tsink, tcounts = sinks[name]
  assert tcounts == jcounts
  assert sum(n for c in tcounts for n in c.values()) > 100
  assert _shards(tsink) == _shards(jsink)
  for f in _shards(jsink):
    want = pq.read_table(os.path.join(jsink, f))
    got = pq.read_table(os.path.join(tsink, f))
    assert got.schema.types == want.schema.types
    assert got.schema.metadata[b'lddl_shard_format'] == \
        want.schema.metadata[b'lddl_shard_format']
    assert got.schema.metadata[b'lddl_duplicate_factor'] == \
        want.schema.metadata[b'lddl_duplicate_factor']
    assert got.to_pylist() == want.to_pylist(), f


def test_the_backends_share_every_column_but_the_masks(sinks):
  """host and device differ only in the mask columns (different RNGs)."""
  _, _, host, _ = sinks['host-delta']
  _, _, device, _ = sinks['device-delta']
  masks = {'mask_delta_positions', 'mask_delta_new_ids', 'mask_delta_k'}
  differ = False
  for f in _shards(host):
    a = pq.read_table(os.path.join(host, f))
    b = pq.read_table(os.path.join(device, f))
    for col in a.column_names:
      same = a.column(col).equals(b.column(col))
      if col in masks:
        differ |= not same
      else:
        assert same, (f, col)
  assert differ


def test_the_cli_runs_the_device_backend_on_the_cpu_when_asked(
    sinks, corpus, tmp_path, monkeypatch):
  monkeypatch.setenv('LDDL_TELEMETRY', '1')
  monkeypatch.setenv('LDDL_TELEMETRY_DIR', str(tmp_path / 'tele'))
  from lddl_tpu_torch.telemetry import metrics
  monkeypatch.setattr(metrics, '_active', None)
  sink = str(tmp_path / 'cli')
  counts = tbert.main([
      '--source', corpus, '--sink', sink, '--vocab-file', VOCAB,
      '--num-blocks', '3', '--seed', str(SEED), '--target-seq-length', '128',
      '--bin-size', '64', '--masking', '--sentence-backend', 'rules',
      '--mask-backend', 'device', '--device', 'cpu'])
  jsink, jcounts, _, _ = sinks['device-delta']
  assert counts == jcounts
  assert _shards(sink) == _shards(jsink)
  for f in _shards(jsink):
    assert pq.read_table(os.path.join(sink, f)).to_pylist() == \
        pq.read_table(os.path.join(jsink, f)).to_pylist()
  with open(tmp_path / 'tele' / 'telemetry.rank0.jsonl') as f:
    text = f.read()
  # Plain versions launch nothing: the kernel counter stays at 0 here.
  assert tbert.MASK_LAUNCHES in text and 'pipeline.process.tasks' in text
  monkeypatch.setattr(metrics, '_active', None)


def test_two_ranks_write_what_one_process_writes(sinks, corpus, tmp_path):
  """The CLI and the balancer as two gloo ranks (``--comm torch``): the
  shuffle's spills shared through the filesystem, the partitions strided
  over the ranks, the results all-gathered: the same counts, shards and
  rows as one process (lddl_tpu's), and the balanced shards the same."""
  import torch_dist_ranks as ranks
  sink, bal = str(tmp_path / 'sink'), str(tmp_path / 'bal')
  argv = ['--source', corpus, '--sink', sink, '--vocab-file', VOCAB,
          '--num-blocks', '3', '--seed', str(SEED), '--target-seq-length',
          '128', '--bin-size', '64', '--masking', '--sentence-backend',
          'rules', '--mask-backend', 'host']
  res = ranks.run_world(ranks.preprocess_ranks, 2, args=(
      (argv, ['--indir', sink, '--outdir', bal, '--num-shards', '3']),))
  jsink, jcounts, _, _ = sinks['host-delta']
  assert res[0]['counts'] == res[1]['counts'] == jcounts
  assert res[0]['meta'] == res[1]['meta']
  assert _shards(sink) == _shards(jsink)
  for f in _shards(jsink):
    assert pq.read_table(os.path.join(sink, f)).to_pylist() == \
        pq.read_table(os.path.join(jsink, f)).to_pylist()
  jbal = str(tmp_path / 'jbal')
  assert jbalance.balance_directory(jsink, jbal, 3) == res[0]['meta']
  for f in _shards(jbal):
    assert pq.read_table(os.path.join(bal, f)).to_pylist() == \
        pq.read_table(os.path.join(jbal, f)).to_pylist()


def test_refusals(corpus, tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  cfg = tbert.BertPretrainConfig(masking=True, **SETTINGS)
  with pytest.raises(RuntimeError, match='needs a CUDA card'):
    tbert.run(_read(treaders, corpus), str(tmp_path / 'a'), cfg)
  # The python engine runs (tests/test_torch_python_engine.py), but not
  # in the delta format.
  with pytest.raises(ValueError, match='fast engine'):
    tbert.run(_read(treaders, corpus), str(tmp_path / 'b'),
              tbert.BertPretrainConfig(engine='python', masking=True,
                                       shard_format='delta', **SETTINGS))
  with pytest.raises(ValueError, match='unknown engine'):
    tbert.run(_read(treaders, corpus), str(tmp_path / 'b'),
              tbert.BertPretrainConfig(engine='rust', **SETTINGS))
  # The pool and the elastic map run (tests/test_torch_pool.py,
  # tests/test_torch_elastic_executor.py); without a lease store the
  # elastic switch leaves the static stride, and says so.
  monkeypatch.setenv('LDDL_ELASTIC', '1')
  with Executor(num_local_workers=2) as ex:
    assert ex.scheduler_info()['elastic'] is False
    assert not ex.resume_pending('process')
  monkeypatch.delenv('LDDL_ELASTIC')
  with pytest.raises(ValueError, match='--mask-backend host'):
    tbert.run(_read(treaders, corpus), str(tmp_path / 'c'), cfg,
              executor=Executor(num_local_workers=2))
  assert not os.path.exists(tmp_path / 'a' / 'part.0.parquet_0')


def test_the_native_planner_equals_the_python_one_and_lddl_tpus():
  import random
  from lddl_tpu.preprocess.pairing import TokenizedDocs as JDocs
  from lddl_tpu.preprocess.pairing import plan_pairs_partition as jplan
  from lddl_tpu_torch.preprocess.pairing import (TokenizedDocs,
                                                 plan_pairs_partition)
  r = np.random.default_rng(4)
  counts = r.integers(1, 12, 40)
  lens = r.integers(1, 60, int(counts.sum()))
  offs = np.concatenate([[0], np.cumsum(lens)])
  flat = r.integers(0, 1000, int(offs[-1])).astype(np.int32)
  outs = []
  for make, plan, backend in ((TokenizedDocs, plan_pairs_partition, 'auto'),
                              (TokenizedDocs, plan_pairs_partition,
                               'python'), (JDocs, jplan, 'auto')):
    rng = random.Random('pairs')
    got = plan(make(flat, offs, counts), rng, max_seq_length=128,
               duplicate_factor=3, backend=backend)
    outs.append((got, rng.random()))
  for got, after in outs[1:]:
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][0], got))
    assert after == outs[0][1]


@pytest.mark.parametrize('name', ['device-delta', 'device-materialized'])
def test_the_balancers_agree(sinks, tmp_path, name):
  """Both balancers over lddl_tpu's sink: the same shards, rows and
  ``.num_samples.json``; and lddl_tpu's loader reads the same batches
  from the port's balanced shards as from its own."""
  jsink = sinks[name][0]
  jout, tout = str(tmp_path / 'j'), str(tmp_path / 't')
  jmeta = jbalance.balance_directory(jsink, jout, 3)
  tmeta = tbalance.main(['--indir', jsink, '--outdir', tout,
                         '--num-shards', '3'])
  assert tmeta == jmeta
  for d in (jout, tout):
    with open(os.path.join(d, '.num_samples.json')) as f:
      assert json.load(f) == jmeta
  for f in _shards(jout):
    assert pq.read_table(os.path.join(tout, f)).to_pylist() == \
        pq.read_table(os.path.join(jout, f)).to_pylist()
  kw = dict(vocab_file=VOCAB, batch_size_per_rank=8, masking='static',
            max_seq_length=128, base_seed=3, shuffle_buffer_size=32,
            bin_size=64 if 'delta' in name else None)
  import importlib.util
  spec = importlib.util.spec_from_file_location(
      'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
  smoke = importlib.util.module_from_spec(spec)
  old = os.environ.get('CUBLAS_WORKSPACE_CONFIG')
  spec.loader.exec_module(smoke)
  if old is None:
    os.environ.pop('CUBLAS_WORKSPACE_CONFIG', None)
  want = [smoke.batch_sha256(b) for b in jax_bert_loader(jout, **kw)]
  got = [smoke.batch_sha256(b) for b in jax_bert_loader(tout, **kw)]
  assert want and got == want
