"""lddl_tpu_torch imports torch, numpy and the stdlib only: never jax,
flax, optax, anything of lddl_tpu, pyarrow, transformers or tokenizers,
and never falls back to the CPU unasked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


ROOT = Path(__file__).resolve().parent.parent
# The card's machine has no pyarrow, transformers or tokenizers either.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'lddl_tpu',
             'pyarrow', 'transformers', 'tokenizers')
MODULES = ('lddl_tpu_torch', 'lddl_tpu_torch.models.bert',
           'lddl_tpu_torch.models.convert', 'lddl_tpu_torch.models.flops',
           'lddl_tpu_torch.ops.flash_attention', 'lddl_tpu_torch.ops._build',
           'lddl_tpu_torch.parallel.train', 'lddl_tpu_torch.loader.bert',
           'lddl_tpu_torch.loader.device', 'lddl_tpu_torch.loader.packed',
           'lddl_tpu_torch.core.utils', 'lddl_tpu_torch.training.pretrain',
           'lddl_tpu_torch.core.faults', 'lddl_tpu_torch.pipeline.pool',
           'lddl_tpu_torch.telemetry', 'lddl_tpu_torch.telemetry.metrics',
           'lddl_tpu_torch.telemetry.trace',
           'lddl_tpu_torch.telemetry.roofline',
           'lddl_tpu_torch.telemetry.profiling',
           'lddl_tpu_torch.telemetry.perf',
           'lddl_tpu_torch.telemetry.sentinel',
           'lddl_tpu_torch.training.elastic', 'lddl_tpu_torch.balance',
           'lddl_tpu_torch.core.log', 'lddl_tpu_torch.core.random',
           'lddl_tpu_torch.loader.binned', 'lddl_tpu_torch.loader.columnar',
           'lddl_tpu_torch.loader.dataset',
           'lddl_tpu_torch.loader.shuffle_buffer',
           'lddl_tpu_torch.pipeline.codecs',
           'lddl_tpu_torch.pipeline.parquet_io',
           'lddl_tpu_torch.pipeline.shard_format',
           'lddl_tpu_torch.tokenization.wordpiece',
           'lddl_tpu_torch.loader', 'lddl_tpu_torch.loader.workers',
           'lddl_tpu_torch.loader.shm', 'lddl_tpu_torch.loader.codebert',
           'lddl_tpu_torch.telemetry.ledger',
           'lddl_tpu_torch.telemetry.audit', 'lddl_tpu_torch.comm',
           'lddl_tpu_torch.comm.backend', 'lddl_tpu_torch.core.topology',
           'lddl_tpu_torch.parallel.mesh',
           'lddl_tpu_torch.pipeline.executor',
           'lddl_tpu_torch.telemetry.report',
           'lddl_tpu_torch.telemetry.live',
           'lddl_tpu_torch.telemetry.server',
           'lddl_tpu_torch.telemetry.monitor',
           'lddl_tpu_torch.loader.service', 'lddl_tpu_torch.testing',
           'lddl_tpu_torch.replay', 'lddl_tpu_torch.replay.rematerialize',
           'lddl_tpu_torch.replay.bundle', 'lddl_tpu_torch.replay.steps',
           'lddl_tpu_torch.replay.cli', 'lddl_tpu_torch.training.flight',
           'lddl_tpu_torch.native', 'lddl_tpu_torch.native.build',
           'lddl_tpu_torch.native.wordpiece', 'lddl_tpu_torch.loader.bart')


def test_import_loads_no_jax_and_no_lddl_tpu():
  code = ('import sys\n'
          f'for m in {MODULES!r}: __import__(m)\n'
          f'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
          f'{FORBIDDEN!r})\n'
          'print(bad)\n')
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                       capture_output=True, text=True, check=True, timeout=120)
  assert out.stdout.strip() == '[]', out.stdout


def test_the_data_server_and_the_monitor_import_no_torch():
  """The data server's process (and the monitor it may run) imports no
  torch, so it can never hold a CUDA context."""
  code = ('import sys\n'
          'import lddl_tpu_torch.loader.service, '
          'lddl_tpu_torch.telemetry.server, '
          'lddl_tpu_torch.telemetry.monitor, lddl_tpu_torch.testing\n'
          'print("torch" in sys.modules)\n')
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                       capture_output=True, text=True, check=True, timeout=120)
  assert out.stdout.strip() == 'False', out.stdout


def test_batch_replay_and_bundles_import_no_torch():
  """Rebuilding a recorded batch or reading a bundle needs no torch (a
  data host can verify a ledger's batches without one)."""
  code = ('import sys\n'
          'import lddl_tpu_torch.replay\n'
          'print("torch" in sys.modules)\n')
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                       capture_output=True, text=True, check=True, timeout=120)
  assert out.stdout.strip() == 'False', out.stdout


def test_the_bart_loader_and_the_native_encoder_import_no_torch():
  """The BART loader tokenizes in the data server's process and in
  loader workers, neither of which may load torch."""
  vocab = ROOT / 'benchmarks' / 'assets' / 'bench_vocab_30522.txt'
  code = ('import sys\n'
          'import lddl_tpu_torch.loader.bart, lddl_tpu_torch.native\n'
          'from lddl_tpu_torch.tokenization.wordpiece import '
          'load_bert_tokenizer\n'
          f'load_bert_tokenizer({str(vocab)!r}).encode_batch_ids(["a b"])\n'
          'print("torch" in sys.modules)\n')
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                       capture_output=True, text=True, check=True, timeout=120)
  assert out.stdout.strip() == 'False', out.stdout


def _imported_roots(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split('.')[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(
    [*(ROOT / 'lddl_tpu_torch').rglob('*.py'), ROOT / 'chip_smoke.py',
     ROOT / 'kernel_ab.py']),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_lddl_tpu(path):
  bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
  assert not bad, f'{path} imports {bad}'


def test_build_without_a_device_raises_when_cuda_is_absent(monkeypatch):
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.training import TrainLoop
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    TrainLoop.build(model_cfg=BertConfig(num_layers=1))


@pytest.mark.parametrize('script', ['chip_smoke.py', 'kernel_ab.py'])
def test_card_scripts_exit_nonzero_without_a_card(script):
  """Without a CUDA card each script prints no result and fails."""
  args = ['.', '.'] if script == 'kernel_ab.py' else []
  env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES='')
  out = subprocess.run([sys.executable, str(ROOT / script), *args], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
  assert out.returncode != 0
  assert '"ok": true' not in out.stdout
