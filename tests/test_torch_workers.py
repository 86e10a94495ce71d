"""The port's worker-process loader against lddl_tpu's serial loaders.

The shards come from test_torch_loader.py's module fixture (lddl_tpu's
preprocess and balancer, into a tmp dir) plus a CodeBERT set made the same
way. For every worker count W in {1, 2, 3} and every handoff (shm, shm
with zero-copy views, pickle), the port's ``num_workers=W`` loaders must
give, batch for batch, the ``batch_sha256`` of lddl_tpu's *serial* loader
over two epochs: NSP pairs with dynamic and with static masking, packed
rows and CodeBERT pairs, and from a mid-epoch ``samples_seen`` or
``seek``. Also: a SIGKILLed worker fails the epoch naming it, every ring
is unlinked, the worker's processes load neither torch nor jax, the
TrainLoop trains through workers as it does serially (restore re-seeks
the worker loader), and SeqlenAwarePrefetcher against lddl_tpu's.

Every wait is bounded by the loader's own poll (5 s) and join (30 s):
the tests never block on a bare get() or join().
"""

import json
import math
import multiprocessing
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lddl_tpu.balance import balance_directory
from lddl_tpu.loader import get_bert_pretrain_data_loader as jax_bert_loader
from lddl_tpu.loader import \
    get_codebert_pretrain_data_loader as jax_codebert_loader
from lddl_tpu.loader import get_packed_pretrain_data_loader as jax_packed_loader
from lddl_tpu.pipeline import Executor
from lddl_tpu.preprocess import codebert
from lddl_tpu.preprocess.readers import read_code
from lddl_tpu.testing import WORDS
from lddl_tpu_torch.loader import (MultiprocessLoader,
                                   get_bert_pretrain_data_loader,
                                   get_codebert_pretrain_data_loader,
                                   get_packed_pretrain_data_loader)
from lddl_tpu_torch.loader.shm import SEGMENT_PREFIX, live_segments
from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
from test_torch_loader import batch_sha256, corpus  # noqa: F401 (fixtures)
from torch_threads import torch_one_thread_a_file  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _own_segments():
  """This process's live port segments (``lddltorch_<pid>_...``): other
  xdist workers' rings are theirs to account for."""
  mine = f'{SEGMENT_PREFIX}{os.getpid()}_'
  return {n for n in live_segments() if n.startswith(mine)}


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  """Overrides conftest's check of lddl_tpu's ``lddl_`` segments: fail a
  test that leaves one of the port's own rings behind."""
  before = _own_segments()
  yield
  leaked = sorted(_own_segments() - before)
  assert not leaked, f'leaked shared-memory segments: {leaked}'


@pytest.fixture(scope='module')
def shards(corpus, tmp_path_factory):
  """corpus's binned pairs (unmasked and static-masked) and packed rows,
  plus balanced CodeBERT shards over the same vocab."""
  root = tmp_path_factory.mktemp('torch_workers')
  src = root / 'code_src'
  src.mkdir()
  r = __import__('random').Random(5)
  with open(src / '0.txt', 'w', newline='') as f:
    for i in range(60):
      doc = '\n'.join(
          ' '.join(r.choice(WORDS) for _ in range(r.randrange(3, 8)))
          for _ in range(r.randrange(0, 3)))
      code = '\n'.join(
          ' '.join(r.choice(WORDS) for _ in range(r.randrange(4, 10)))
          for _ in range(r.randrange(3, 12)))
      f.write(f'fn-{i}<CODESPLIT>{doc}<CODESPLIT>{code}\r\n')
  sink = str(root / 'codebert_sink')
  codebert.run(read_code(str(src), num_blocks=2), sink,
               codebert.CodebertPretrainConfig(
                   vocab_file=corpus['vocab'], target_seq_length=64,
                   bin_size=16, seed=11),
               executor=Executor(num_local_workers=1))
  out = dict(corpus)
  out['codebert'] = str(root / 'codebert')
  balance_directory(sink, out['codebert'], 2)
  return out


# kind -> (lddl_tpu's loader, the port's, the shard set, loader settings)
KINDS = {
    'dynamic': (jax_bert_loader, get_bert_pretrain_data_loader, 'binned',
                dict(batch_size_per_rank=4, bin_size=16, max_seq_length=64,
                     base_seed=9, shuffle_buffer_size=64,
                     masking='dynamic')),
    'static': (jax_bert_loader, get_bert_pretrain_data_loader, 'static',
               dict(batch_size_per_rank=4, bin_size=16, max_seq_length=64,
                    base_seed=9, shuffle_buffer_size=64, masking='static')),
    'packed': (jax_packed_loader, get_packed_pretrain_data_loader, 'packed',
               dict(batch_size_per_rank=2, max_seq_length=256, bin_size=64,
                    base_seed=4, sequence_length_alignment=64,
                    block_diagonal=True)),
    'codebert': (jax_codebert_loader, get_codebert_pretrain_data_loader,
                 'codebert',
                 dict(batch_size_per_rank=4, bin_size=16, max_seq_length=64,
                      base_seed=9, shuffle_buffer_size=16)),
}
# (num_workers, transport, zero_copy)
HANDOFFS = [(w, t, z) for w in (1, 2, 3)
            for t, z in (('shm', False), ('shm', True), ('pickle', False))]


def _handoff_id(h):
  w, t, z = h
  return f'W{w}-{t}' + ('-zero_copy' if z else '')


def _digests(loader, sha, epochs=2):
  """Per epoch, each batch's digest, taken before the next batch is
  pulled (a zero-copy batch is a view valid only until then)."""
  return [[sha(b) for b in loader] for _ in range(epochs)]


@pytest.fixture(scope='module')
def serial_digests(shards, batch_sha256):
  """lddl_tpu's serial loader's digests, per (kind, resume mode)."""
  memo = {}

  def get(kind, mode='plain'):
    if (kind, mode) not in memo:
      jax_make, _, name, kw = KINDS[kind]
      loader = jax_make(shards[name], vocab_file=shards['vocab'],
                        **_resume_kw(mode), **kw)
      if mode == 'seek':
        loader.seek(0, 3)
      memo[kind, mode] = (_digests(loader, batch_sha256), loader.tell())
      assert all(memo[kind, mode][0]), f'{kind}: an epoch without batches'
    return memo[kind, mode]
  return get


def _resume_kw(mode):
  return {'samples_seen': 12} if mode == 'samples_seen' else {}


def _port_loader(shards, kind, handoff, mode='plain'):
  _, make, name, kw = KINDS[kind]
  w, transport, zero_copy = handoff
  loader = make(shards[name], vocab_file=shards['vocab'], num_workers=w,
                transport=transport, zero_copy=zero_copy, **_resume_kw(mode),
                **kw)
  assert isinstance(loader, MultiprocessLoader)
  if mode == 'seek':
    loader.seek(0, 3)
  return loader


@pytest.mark.parametrize('handoff', HANDOFFS, ids=_handoff_id)
@pytest.mark.parametrize('kind', list(KINDS))
def test_workers_equal_lddl_tpu_serial(shards, batch_sha256, serial_digests,
                                       kind, handoff):
  """Two epochs, batch for batch; the epoch counter moves as serially."""
  want, want_tell = serial_digests(kind)
  loader = _port_loader(shards, kind, handoff)
  assert _digests(loader, batch_sha256) == want
  assert loader.tell() == want_tell
  assert loader.slot_overflows == 0
  assert len(loader.start_seconds) == 2


@pytest.mark.parametrize('handoff', [(2, 'shm', False), (3, 'pickle', False),
                                     (2, 'shm', True)], ids=_handoff_id)
@pytest.mark.parametrize('mode', ['samples_seen', 'seek'])
@pytest.mark.parametrize('kind', list(KINDS))
def test_workers_resume_equal_lddl_tpu_serial(shards, batch_sha256,
                                              serial_digests, kind, mode,
                                              handoff):
  """From a mid-epoch samples_seen or seek: the rest of epoch 0, then
  epoch 1 whole."""
  want, want_tell = serial_digests(kind, mode)
  loader = _port_loader(shards, kind, handoff, mode)
  assert len(loader) == len(want[0])
  assert _digests(loader, batch_sha256) == want
  assert loader.tell() == want_tell


def test_env_knobs_pick_the_handoff(shards, batch_sha256, serial_digests,
                                    monkeypatch):
  """LDDL_LOADER_TRANSPORT, _QUEUE_DEPTH and _ZERO_COPY stand in for the
  arguments; slot_bytes small enough makes every batch overflow to the
  pickling queue, which changes no byte."""
  monkeypatch.setenv('LDDL_LOADER_TRANSPORT', 'pickle')
  monkeypatch.setenv('LDDL_LOADER_QUEUE_DEPTH', '2')
  monkeypatch.setenv('LDDL_LOADER_ZERO_COPY', '1')
  _, make, name, kw = KINDS['dynamic']
  loader = make(shards[name], vocab_file=shards['vocab'], num_workers=2,
                **kw)
  assert (loader.transport, loader.queue_depth, loader.zero_copy) == (
      'pickle', 2, True)
  monkeypatch.setenv('LDDL_LOADER_TRANSPORT', 'shm')
  loader = make(shards[name], vocab_file=shards['vocab'], num_workers=2,
                slot_bytes=256, **kw)
  want, _ = serial_digests('dynamic')
  assert _digests(loader, batch_sha256, epochs=1) == want[:1]
  assert loader.slot_overflows == len(want[0])


def test_what_workers_refuse(shards):
  _, make, name, kw = KINDS['dynamic']
  with pytest.raises(ValueError, match='unknown loader transport'):
    make(shards[name], vocab_file=shards['vocab'], num_workers=2,
         transport='carrier-pigeon', **kw)
  with pytest.raises(ValueError, match='num_workers'):
    MultiprocessLoader({}, 0, transport='shm')
  with pytest.raises(ValueError, match='vocab_file'):
    make(shards[name], tokenizer=load_bert_tokenizer(shards['vocab']),
         num_workers=2, **kw)
  with pytest.raises(ValueError, match='queue_depth'):
    make(shards[name], vocab_file=shards['vocab'], num_workers=2,
         queue_depth=0, **kw)
  with pytest.raises(ValueError, match='module name'):
    MultiprocessLoader({}, 2, factory=('__main__', 'make'))
  with pytest.raises(ValueError, match='hub tokenizers'):
    get_codebert_pretrain_data_loader(shards['codebert'],
                                      tokenizer_name='microsoft/codebert-base')


@pytest.mark.parametrize('transport', ['shm', 'pickle'])
def test_a_killed_worker_fails_the_epoch_naming_it(shards, transport):
  """SIGKILL worker 1 after the first batch: the parent raises the
  RuntimeError naming it within its poll, and the rings are unlinked
  (the autouse check)."""
  _, make, name, kw = KINDS['dynamic']
  loader = make(shards[name], vocab_file=shards['vocab'], num_workers=2,
                transport=transport, queue_depth=1, **kw)
  assert loader.batches_per_epoch >= 8
  it = iter(loader)
  next(it)
  victim, = [p for p in multiprocessing.active_children()
             if p.name == 'lddl-torch-loader-w1']
  os.kill(victim.pid, signal.SIGKILL)
  t0 = time.monotonic()
  with pytest.raises(RuntimeError, match='loader worker 1 died'):
    for _ in it:
      pass
  assert time.monotonic() - t0 < 15
  it.close()
  assert not [p for p in multiprocessing.active_children()
              if p.name.startswith('lddl-torch-loader-')]


def test_abandoning_an_epoch_stops_the_workers(shards):
  _, make, name, kw = KINDS['packed']
  loader = make(shards[name], vocab_file=shards['vocab'], num_workers=3,
                zero_copy=True, **kw)
  it = iter(loader)
  next(it)
  it.close()
  assert not [p for p in multiprocessing.active_children()
              if p.name.startswith('lddl-torch-loader-')]
  assert loader.tell() == (0, 0)


def test_workers_export_their_telemetry_and_trace(shards, tmp_path,
                                                  monkeypatch):
  """With LDDL_TELEMETRY, LDDL_TRACE and LDDL_TELEMETRY_DIR set after
  the forkserver started, each worker still sees them (the parent's
  LDDL_* environment rides along), and writes its own pid-suffixed
  snapshot and trace beside the rank's."""
  from lddl_tpu_torch import telemetry
  _, make, name, kw = KINDS['dynamic']
  for _ in make(shards[name], vocab_file=shards['vocab'], num_workers=1,
                **kw):  # the forkserver runs from here on
    break
  monkeypatch.setenv('LDDL_TELEMETRY', '1')
  monkeypatch.setenv('LDDL_TRACE', '1')
  monkeypatch.setenv('LDDL_TELEMETRY_DIR', str(tmp_path))
  tele = telemetry.enable()
  try:
    loader = make(shards[name], vocab_file=shards['vocab'], num_workers=2,
                  **kw)
    n = sum(1 for _ in loader)
  finally:
    telemetry.disable()
  names = {line['name'] for line in tele.snapshot_lines() if 'name' in line}
  assert {'loader.pull_stall_seconds', 'loader.worker_start_seconds'} <= names
  pids = sorted(f.name.split('.pid')[1].split('.')[0]
                for f in tmp_path.glob('telemetry.rank0.pid*.jsonl'))
  assert len(pids) == 2
  assert sorted(f.name for f in tmp_path.glob('trace.rank0.pid*.jsonl')) == [
      f'trace.rank0.pid{p}.jsonl' for p in pids]
  worker_names = set()
  for f in tmp_path.glob('telemetry.rank0.pid*.jsonl'):
    worker_names |= {json.loads(x).get('name') for x in
                     f.read_text().splitlines()}
  assert 'loader.shm_wait_seconds' in worker_names
  assert 'loader.batches' in worker_names
  batches = [json.loads(x)
             for f in tmp_path.glob('telemetry.rank0.pid*.jsonl')
             for x in f.read_text().splitlines()
             if json.loads(x).get('name') == 'loader.batches']
  assert not list(tmp_path.glob('*.tmp.*'))
  assert sum(b['total'] for b in batches) == n


def test_workers_load_neither_torch_nor_jax():
  """The worker's processes come from the forkserver, not a fork of this
  process (which holds torch and jax): inside a worker, the port's loader
  chain is loaded and torch, jax and lddl_tpu are not."""
  from torch_worker_probe import PROBED
  loader = MultiprocessLoader({}, 2, factory=('torch_worker_probe',
                                              'probe_loader'))
  batches = list(loader)
  assert len(batches) == 2
  for b in batches:
    assert dict(zip(PROBED, b['loaded'].tolist())) == {
        'torch': 0, 'jax': 0, 'lddl_tpu': 0,
        'lddl_tpu_torch.loader.bert': 1,
        'lddl_tpu_torch.telemetry.ledger': 1}


def test_worker_import_chain_has_no_torch():
  """The modules a worker imports leave torch (and jax) out of
  sys.modules, in a fresh interpreter."""
  chain = ('lddl_tpu_torch.loader', 'lddl_tpu_torch.loader.workers',
           'lddl_tpu_torch.loader.shm', 'lddl_tpu_torch.loader.bert',
           'lddl_tpu_torch.loader.packed', 'lddl_tpu_torch.loader.codebert',
           'lddl_tpu_torch.telemetry', 'lddl_tpu_torch.telemetry.metrics',
           'lddl_tpu_torch.telemetry.trace',
           'lddl_tpu_torch.telemetry.ledger',
           'lddl_tpu_torch.telemetry.audit')
  code = ('import sys\n'
          f'for m in {chain!r}: __import__(m)\n'
          "print(sorted(m for m in sys.modules if m.split('.')[0] in "
          "('torch', 'jax', 'lddl_tpu')))\n")
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                       capture_output=True, text=True, check=True,
                       timeout=120)
  assert out.stdout.strip() == '[]', out.stdout


# ---- the train loop through workers ----

def _loop(shards, num_workers, **kw):
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.training import TrainLoop
  cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, max_position_embeddings=64,
                   dropout_rate=0.0, dtype=torch.float32)
  loader_kwargs = {'vocab_file': shards['vocab'], 'shuffle_buffer_size': 64}
  if num_workers:
    loader_kwargs['num_workers'] = num_workers
  return TrainLoop.build(
      shards['binned'], model_cfg=cfg, device='cpu', learning_rate=1e-3,
      warmup_steps=2, total_steps=40, seed=5, batch_size_per_rank=16,
      bin_size=16, max_seq_length=64, loader_kwargs=loader_kwargs, **kw)


@pytest.fixture()
def one_torch_thread():
  """One intra-op thread for the loop's CPU steps: the loaders' workers
  and the other test processes share the host's cores."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def test_train_loop_through_workers_matches_serial(shards, tmp_path,
                                                   one_torch_thread):
  """Over more than one epoch (a new set of workers each), the losses of
  TrainLoop.build(path, loader_kwargs={'num_workers': 2, ...}) equal the
  serial loader's bit for bit; fresh loops restored from a mid-epoch
  checkpoint re-seek the loader to the same coordinate and continue bit
  for bit alike, through workers and serially (a mid-epoch seek has the
  loader's resume semantics, so neither equals the uninterrupted run)."""
  serial = _loop(shards, 0)
  steps = serial.loader.batches_per_epoch + 3
  want = serial.run(steps, log_every=0)
  assert len(want) == steps and all(math.isfinite(x) for x in want)
  workers = _loop(shards, 2)
  assert isinstance(workers.loader, MultiprocessLoader)
  assert workers.run(steps, log_every=0) == want
  assert workers.state_digest() == serial.state_digest()
  assert len(workers.loader.start_seconds) == 2

  ckpt = str(tmp_path / 'ckpt')
  _loop(shards, 2).run(5, ckpt_dir=ckpt, log_every=0)
  tails = []
  for num_workers in (0, 2):
    resumed = _loop(shards, num_workers)
    resumed.restore(ckpt)
    assert resumed.loader.tell() == (0, 5)
    tails.append((resumed.run(steps, log_every=0), resumed.state_digest()))
  assert len(tails[0][0]) == steps - 5
  assert tails[0] == tails[1]
  assert not [p for p in multiprocessing.active_children()
              if p.name.startswith('lddl-torch-loader-')]


# ---- the seqlen lookahead ----

def test_seqlen_aware_prefetcher_matches_lddl_tpu(shards, batch_sha256):
  from lddl_tpu.loader.device import SeqlenAwarePrefetcher as JaxPrefetcher
  from lddl_tpu_torch.loader import SeqlenAwarePrefetcher
  _, make, name, kw = KINDS['dynamic']
  seqlen = lambda b: b['input_ids'].shape[1]

  def walk(cls):
    loader = make(shards[name], vocab_file=shards['vocab'], **kw)
    pf = cls(loader, seqlen)
    out = []
    for i in range(loader.batches_per_epoch):
      if i % 3 == 0:
        out.append(('next', pf.next_seqlen()))
      out.append(('batch', batch_sha256(next(pf))))
    with pytest.raises(StopIteration):
      pf.next_seqlen()
    return out

  got = walk(SeqlenAwarePrefetcher)
  assert got == walk(JaxPrefetcher)
  assert len({v for k, v in got if k == 'next'}) > 1

  closed = []

  def source():
    try:
      yield {'input_ids': np.zeros((1, 8))}
      yield {'input_ids': np.zeros((1, 16))}
    finally:
      closed.append(True)

  pf = SeqlenAwarePrefetcher(source(), seqlen)
  assert pf.next_seqlen() == 8
  pf.close()
  assert closed == [True]
