"""The port's package surface against lddl_tpu's (CPU).

Every name a ``lddl_tpu`` package exports (its ``__init__``'s imports,
``__all__`` and lazy table) is importable from the port's package of the
same name, or stands on :data:`JAX_ONLY` with its port counterpart. The
five public names the port lacked until its step-cost slice are held
against lddl_tpu's: ``models.flops.machine_balance``,
``pipeline.parquet_io.read_samples`` (the port's own reader vs pyarrow's
``to_pylist`` rows through lddl_tpu's), ``BertWordPiece.
get_special_tokens_mask`` (vs lddl_tpu's HF backend),
``DatasetLogger``'s worker scope and ``core.types.File``.
"""

import ast
import dataclasses
import importlib
import logging
import os
import types

import pytest

from lddl_tpu.core import log as jlog
from lddl_tpu.core import types as jtypes
from lddl_tpu.models import flops as jflops
from lddl_tpu.pipeline import parquet_io as jparquet
from lddl_tpu_torch.core import log as tlog
from lddl_tpu_torch.core import types as ttypes
from lddl_tpu_torch.models import flops as tflops
from lddl_tpu_torch.pipeline import parquet_io as tparquet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = os.path.join(REPO, 'tests', 'assets', 'torch_shards')
VOCAB = os.path.join(REPO, 'benchmarks', 'assets', 'bench_vocab_30522.txt')

# lddl_tpu's exports with no name in the port: JAX (or XLA) machinery, each
# with the port's counterpart (a dotted path), or None.
JAX_ONLY = {
    ('comm', 'JaxProcessBackend'): 'lddl_tpu_torch.comm.TorchDistBackend',
    ('comm', 'KVLeaseStore'): 'lddl_tpu_torch.comm.StoreLeaseStore',
    ('comm', 'ensure_jax_distributed'):
        'lddl_tpu_torch.comm.ensure_torch_distributed',
    ('native', 'build_library'): 'lddl_tpu_torch.native.library',
    ('native', 'load_library'): 'lddl_tpu_torch.native.library',
    ('parallel', 'init_params'):
        'lddl_tpu_torch.models.BertForPretraining.reset_parameters',
    ('parallel', 'make_train_step'): 'lddl_tpu_torch.parallel.TrainStep',
    ('parallel', 'reshard_pytree'): 'lddl_tpu_torch.parallel.reshard_state',
    ('parallel', 'shard_batch'): 'lddl_tpu_torch.loader.make_global_batch',
    ('parallel', 'snapshot_for_checkpoint'):
        'lddl_tpu_torch.training.TrainLoop._snapshot',
}


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


def _exports(init_path):
  """Public names an ``__init__.py`` exports: its ``from .x import``
  names, ``__all__`` and the keys of a ``_LAZY`` table."""
  tree = ast.parse(open(init_path).read())
  names = set()
  for node in tree.body:
    if isinstance(node, ast.ImportFrom) and node.level:
      names |= {a.asname or a.name for a in node.names}
    elif isinstance(node, ast.Assign):
      for target in node.targets:
        if not isinstance(target, ast.Name):
          continue
        if target.id == '__all__':
          names |= set(ast.literal_eval(node.value))
        elif target.id == '_LAZY':
          names |= set(ast.literal_eval(node.value))
  return {n for n in names if not n.startswith('_')}


def _packages():
  root = os.path.join(REPO, 'lddl_tpu')
  return sorted(d for d in os.listdir(root)
                if os.path.isfile(os.path.join(root, d, '__init__.py')))


def _resolve(dotted):
  parts = dotted.split('.')
  for i in range(len(parts), 0, -1):
    try:
      obj = importlib.import_module('.'.join(parts[:i]))
    except ImportError:
      continue
    for name in parts[i:]:
      obj = getattr(obj, name)
    return obj
  raise ImportError(dotted)


@pytest.mark.parametrize('package', _packages())
def test_every_export_is_importable_from_the_port(package):
  want = _exports(os.path.join(REPO, 'lddl_tpu', package, '__init__.py'))
  port = importlib.import_module(f'lddl_tpu_torch.{package}')
  missing = []
  for name in sorted(want):
    if (package, name) in JAX_ONLY:
      continue
    try:
      getattr(port, name)
    except AttributeError:
      missing.append(name)
  assert not missing, f'lddl_tpu_torch.{package} lacks {missing}'


def test_the_jax_only_list_is_exact():
  """Each listed name is a lddl_tpu export the port lacks, and its
  counterpart resolves."""
  for (package, name), counterpart in JAX_ONLY.items():
    assert name in _exports(os.path.join(REPO, 'lddl_tpu', package,
                                         '__init__.py')), (package, name)
    assert not hasattr(importlib.import_module(f'lddl_tpu_torch.{package}'),
                       name), (package, name)
    if counterpart is not None:
      assert callable(_resolve(counterpart)), counterpart


def test_exports_are_lddl_tpus_objects_by_name():
  """A sample of the added exports are the port modules' own objects."""
  from lddl_tpu_torch import core, ops, pipeline, preprocess, telemetry
  from lddl_tpu_torch import tokenization, training
  from lddl_tpu_torch.models import bert
  from lddl_tpu_torch.ops import masking_host
  from lddl_tpu_torch.pipeline import executor
  from lddl_tpu_torch.preprocess import readers
  from lddl_tpu_torch.telemetry import report
  from lddl_tpu_torch.tokenization import wordpiece
  from lddl_tpu_torch.training import pretrain
  import lddl_tpu_torch.models as models
  assert core.File is ttypes.File
  assert pipeline.read_samples is tparquet.read_samples
  assert pipeline.Executor is executor.Executor
  assert ops.mask_batch_host is masking_host.mask_batch_host
  assert preprocess.Corpus is readers.Corpus
  assert tokenization.BertWordPiece is wordpiece.BertWordPiece
  assert training.main is pretrain.main
  assert models.spec_for_param is bert.spec_for_param
  assert telemetry.render_report is report.render_report
  with pytest.raises(AttributeError):
    core.no_such_name  # noqa: B018


# ---- the five names ----


def test_machine_balance_is_the_ratio_of_the_peaks(monkeypatch):
  monkeypatch.delenv('LDDL_PEAK_TFLOPS', raising=False)
  monkeypatch.delenv('LDDL_PEAK_HBM_GBPS', raising=False)
  tpu = types.SimpleNamespace(device_kind='TPU v4')
  assert jflops.machine_balance(tpu) == (
      jflops.peak_flops_per_device(tpu) / jflops.peak_hbm_bytes_per_device(
          tpu))
  card = 'NVIDIA H100 80GB HBM3'
  assert tflops.machine_balance(card) == 989e12 / 3350e9
  assert tflops.machine_balance(card) == (
      tflops.peak_flops_per_device(card) /
      tflops.peak_hbm_bytes_per_device(card))
  unknown = types.SimpleNamespace(device_kind='cpu')
  assert jflops.machine_balance(unknown) is None
  assert tflops.machine_balance('cpu') is None
  monkeypatch.setenv('LDDL_PEAK_TFLOPS', '100')
  assert tflops.machine_balance('cpu') is None  # bandwidth still unknown
  monkeypatch.setenv('LDDL_PEAK_HBM_GBPS', '50')
  assert tflops.machine_balance('cpu') == 2000.0


def _shards():
  out = []
  for name in ('pairs', 'packed', 'codebert', 'bart'):
    d = os.path.join(SHARDS, name)
    out.append(os.path.join(d, sorted(
        f for f in os.listdir(d) if '.parquet' in f)[0]))
  return out


@pytest.mark.parametrize('path', _shards(),
                         ids=lambda p: os.path.basename(os.path.dirname(p)))
def test_read_samples_gives_lddl_tpus_rows(path):
  want = jparquet.read_samples(path)
  got = tparquet.read_samples(path)
  assert got == want and len(got) > 0
  columns = list(reversed(list(want[0])))[:2]
  assert tparquet.read_samples(path, columns=columns) == (
      jparquet.read_samples(path, columns=columns))
  assert list(tparquet.read_samples(path, columns=columns)[0]) == columns


def test_special_tokens_mask_is_hfs():
  from lddl_tpu.tokenization import load_bert_tokenizer as jload
  from lddl_tpu_torch.tokenization import load_bert_tokenizer as tload
  jtok = jload(vocab_file=VOCAB, backend='hf')
  ttok = tload(vocab_file=VOCAB)
  ids = list(range(120)) + [ttok.cls_token_id, ttok.sep_token_id,
                            ttok.mask_token_id, ttok.pad_token_id,
                            ttok.unk_token_id, 2000, 30521]
  assert ttok.get_special_tokens_mask(ids) == jtok.get_special_tokens_mask(
      ids)
  assert sum(ttok.get_special_tokens_mask(ids)) >= 5


@pytest.mark.parametrize('local_rank', [0, 1])
@pytest.mark.parametrize('worker', [None, 0, 2])
def test_dataset_logger_scopes_are_lddl_tpus(tmp_path, local_rank, worker):
  kw = dict(log_dir=str(tmp_path), log_level=logging.WARNING, rank=3,
            local_rank=local_rank, node_rank=1, num_workers=4)
  jlogger, tlogger = jlog.DatasetLogger(**kw), tlog.DatasetLogger(**kw)
  assert tlogger.num_workers == 4
  if worker is not None:
    jlogger.set_worker(worker)
    tlogger.set_worker(worker)
  for scope in ('node', 'rank', 'worker'):
    want, got = jlogger.to(scope), tlogger.to(scope)
    assert isinstance(got, tlog.DummyLogger) == isinstance(
        want, jlog.DummyLogger), scope
    if not isinstance(got, tlog.DummyLogger):
      assert got.name.split('@')[0] == want.name.split('@')[0]
  with pytest.raises(ValueError):
    tlogger.to('cluster')


def test_file_is_lddl_tpus_record():
  from lddl_tpu_torch import balance
  assert balance.File is ttypes.File
  fields = [(f.name, f.type) for f in dataclasses.fields(ttypes.File)]
  assert fields == [(f.name, f.type) for f in dataclasses.fields(jtypes.File)]
  got, want = ttypes.File('a/b', 3), jtypes.File('a/b', 3)
  assert str(got) == str(want) and repr(got) == repr(want)
  assert got == ttypes.File('a/b', 3) and hash(got) == hash(
      ttypes.File('a/b', 3))
  with pytest.raises(dataclasses.FrozenInstanceError):
    got.num_samples = 4
