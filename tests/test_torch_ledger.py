"""The port's determinism ledger and auditor against lddl_tpu's.

Fingerprints of the same batches, the ledger lines of the same records,
and an epoch's ``collate`` and ``device`` records from the port's loader
(serially and through worker processes) against a JAX run's over the same
shards (test_torch_loader.py's module fixture), key for key and line for
line; both packages' auditors on those files; the ``ledger.corrupt``
drill. Each runs under both hash algorithms: xxh64 (the tests need the
``xxhash`` wheel) and blake2b-8 (``_xxhash`` patched to None in both
modules, as on a machine without the wheel).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lddl_tpu.core.faults as jfaults
import lddl_tpu.loader.device as jdevice
import lddl_tpu.telemetry.audit as jaudit
import lddl_tpu.telemetry.ledger as jledger
import lddl_tpu_torch.core.faults as tfaults
import lddl_tpu_torch.telemetry.audit as taudit
import lddl_tpu_torch.telemetry.ledger as tledger
from lddl_tpu.loader import get_bert_pretrain_data_loader as jax_bert_loader
from lddl_tpu.loader import get_packed_pretrain_data_loader as jax_packed_loader
from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                   get_packed_pretrain_data_loader)
from lddl_tpu_torch.loader.shm import SEGMENT_PREFIX, _pack_into, live_segments
from test_torch_loader import batch_sha256, corpus  # noqa: F401 (fixtures)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  """Overrides conftest's check of lddl_tpu's ``lddl_`` segments: fail a
  test that leaves one of this process's port rings behind."""
  mine = f'{SEGMENT_PREFIX}{os.getpid()}_'
  before = {n for n in live_segments() if n.startswith(mine)}
  yield
  leaked = sorted({n for n in live_segments() if n.startswith(mine)} -
                  before)
  assert not leaked, f'leaked shared-memory segments: {leaked}'


@pytest.fixture(autouse=True)
def _port_ledger_off():
  """The port's ledger gate back to unresolved after every test (conftest
  does so for lddl_tpu's)."""
  yield
  tledger.disable_ledger()
  tledger._active = None


@pytest.fixture(params=['xxh64', 'blake2b8'])
def algo(request, monkeypatch):
  """Both modules hashing with one algorithm."""
  if request.param == 'blake2b8':
    for mod in (jledger, tledger):
      monkeypatch.setattr(mod, '_xxhash', None)
      monkeypatch.setattr(mod, 'ALGO', 'blake2b8')
  assert jledger.ALGO == tledger.ALGO == request.param
  return request.param


BERT = dict(batch_size_per_rank=4, bin_size=16, max_seq_length=64,
            base_seed=9, shuffle_buffer_size=64)
PACKED = dict(batch_size_per_rank=2, max_seq_length=256, bin_size=64,
              base_seed=4, sequence_length_alignment=64, block_diagonal=True)


def _batches(corpus):
  """Batches of every shape the loaders give, and a few odd leaves."""
  out = []
  for make, path, kw in (
      (get_bert_pretrain_data_loader, 'binned', BERT),
      (get_bert_pretrain_data_loader, 'binned',
       dict(BERT, micro_batch_size=2)),
      (get_bert_pretrain_data_loader, 'binned',
       dict(BERT, return_raw_samples=True)),
      (get_packed_pretrain_data_loader, 'packed', PACKED)):
    loader = make(corpus[path], vocab_file=corpus['vocab'], **kw)
    out += [b for b, _ in zip(loader, range(3))]
  out.append(({'a': np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2]},
              [np.zeros((0, 4), np.int64), 7, 'seven', None, 2.5, True]))
  return out


def test_fingerprints_equal_lddl_tpu(corpus, algo):
  """fingerprint_batch of a live batch and fingerprint_packed of the same
  batch packed into a slot, in either package, are one digest."""
  for batch in _batches(corpus):
    want = jledger.fingerprint_batch(batch)
    assert tledger.fingerprint_batch(batch) == want
    buf = bytearray(1 << 20)
    spec, _ = _pack_into(batch, buf, 64, len(buf))
    assert tledger.fingerprint_packed(spec, buf) == want
    assert jledger.fingerprint_packed(spec, buf) == want
    assert tledger.first_array_span(spec) == jledger.first_array_span(spec)
    first = tledger.first_ndarray(batch)
    assert first is jledger.first_ndarray(batch)
  assert len(want) == 16


def test_ledger_lines_equal_lddl_tpu(tmp_path, algo, monkeypatch):
  """The same records make the same lines (the meta line's pid and time
  aside), rolling digests, signals and verdicts included."""
  monkeypatch.setenv('LDDL_LEDGER_WINDOW', '3')
  records = [('collate', {'epoch': 0, 'index': i, 'samples': 4})
             for i in range(5)]
  records += [('device', {'index': 0}), ('step', {'step': 3, 'loss': 1.5}),
              ('shard', {'path': 'shard "0".parquet', 'ok': True})]
  lines, signals = {}, {}
  for name, mod in (('jax', jledger), ('torch', tledger)):
    led = mod.Ledger(directory=str(tmp_path / name), rank=1)
    for boundary, coords in records:
      led.record(boundary, mod.fingerprint_bytes(repr(coords).encode()),
                 **coords)
    signals[name] = led.signals()
    led.close()
    with open(mod.ledger_file_name(str(tmp_path / name), 1)) as f:
      lines[name] = f.read().splitlines()
  meta = [json.loads(x[0]) for x in lines.values()]
  assert [{k: v for k, v in m.items() if k not in ('pid', 'unix_time')}
          for m in meta] == [{'kind': 'meta', 'rank': 1, 'algo': algo,
                              'window': 3}] * 2
  assert lines['torch'][1:] == lines['jax'][1:]
  assert len(lines['torch']) == len(records) + 1
  assert signals['torch'] == signals['jax']
  other = json.loads(json.dumps(signals['torch']))
  other['collate']['rolling'] = 'f' * 16
  other['collate']['recent'][-1][1] = 'f' * 16
  per_rank = {0: signals['torch'], 1: other}
  for replicated in (('collate', 'step'), ('step',)):
    assert tledger.compare_signals(per_rank, replicated) == \
        jledger.compare_signals(per_rank, replicated)
  assert tledger.compare_signals(per_rank, ('collate',))['first']['key'] == \
      [0, 4]


def test_ledger_gate(tmp_path, monkeypatch):
  monkeypatch.delenv('LDDL_LEDGER', raising=False)
  tledger._active = None
  assert tledger.get_ledger() is tledger.NOOP_LEDGER
  assert tledger.determinism_verdict() is None
  monkeypatch.setenv('LDDL_LEDGER', '1')
  monkeypatch.setenv('LDDL_TELEMETRY_DIR', str(tmp_path))
  monkeypatch.setenv('LDDL_RANK', '2')
  tledger._active = None
  led = tledger.get_ledger()
  assert led.enabled and led is tledger.get_ledger()
  led.record('collate', 'ab' * 8, epoch=0, index=0)
  assert tledger.determinism_verdict()['streams']['collate']['count'] == 1
  assert os.path.exists(tmp_path / 'ledger.rank2.jsonl')
  assert tledger.disable_ledger() is tledger.NOOP_LEDGER


def _run(loader, ledger_dir, mod_device, mod_ledger, device_kw):
  """One epoch through the package's device feed with its ledger on;
  returns the ledger's record lines, its meta line dropped."""
  mod_ledger.enable_ledger(directory=str(ledger_dir), rank=0)
  try:
    if mod_device is not jdevice:
      # As the port's train loop feeds: device records keyed (epoch,
      # index) by the loader's coordinate_of_batch.
      device_kw = dict(device_kw,
                       coordinate=mod_device.coordinate_from(loader))
    stream = mod_device.prefetch_to_device(iter(loader), **device_kw)
    n = sum(1 for _ in stream)
  finally:
    mod_ledger.disable_ledger()
  with open(mod_ledger.ledger_file_name(str(ledger_dir), 0)) as f:
    lines = [json.loads(x) for x in f.read().splitlines()]
  assert lines[0]['kind'] == 'meta'
  assert len(lines) == 1 + 2 * n
  return lines[1:]


def _by_boundary(records, drop_device_epoch=False):
  out = {}
  for r in records:
    if drop_device_epoch and r['boundary'] == 'device':
      r = {k: v for k, v in r.items() if k != 'epoch'}
    out.setdefault(r['boundary'], []).append(r)
  return out


@pytest.mark.parametrize('kind', ['pairs', 'packed'])
def test_epoch_records_equal_lddl_tpu(corpus, tmp_path, algo, kind):
  """One epoch's collate and device records: lddl_tpu's serial loader
  through its feed, the port's serially and with W = 2 through its feed
  (the collate record parent-side, over the shm slot): equal key for key
  and line for line; both auditors find the three runs consistent."""
  import lddl_tpu_torch.loader.device as tdevice
  jmake, tmake, path, kw = {
      'pairs': (jax_bert_loader, get_bert_pretrain_data_loader, 'binned',
                BERT),
      'packed': (jax_packed_loader, get_packed_pretrain_data_loader,
                 'packed', PACKED)}[kind]
  common = dict(vocab_file=corpus['vocab'], **kw)
  runs = {
      'jax': _run(jmake(corpus[path], **common), tmp_path / 'jax', jdevice,
                  jledger, {}),
      'serial': _run(tmake(corpus[path], **common), tmp_path / 'serial',
                     tdevice, tledger, {'device': 'cpu'}),
      'workers': _run(tmake(corpus[path], num_workers=2, **common),
                      tmp_path / 'workers', tdevice, tledger,
                      {'device': 'cpu'}),
  }
  want = _by_boundary(runs['jax'])
  assert set(want) == {'collate', 'device'}
  assert [r['index'] for r in want['device']] == list(
      range(len(want['device'])))
  assert [(r['epoch'], r['index']) for r in want['collate']] == [
      (0, i) for i in range(len(want['collate']))]
  for name in ('serial', 'workers'):
    # The port's departure: its device records carry the batch's epoch
    # beside its index (lddl_tpu's key the index in the feed alone, and
    # re-record index=0.. in a second epoch). Within one epoch from its
    # start the index is the same, so without the epoch the lines equal.
    assert {r['epoch'] for r in runs[name]
            if r['boundary'] == 'device'} == {0}, name
    got = _by_boundary(runs[name], drop_device_epoch=True)
    assert got == want, name
  loaded = {name: jaudit.load_run(str(tmp_path / name)) for name in runs}
  for a, b in (('jax', 'serial'), ('jax', 'workers'), ('serial', 'workers')):
    j = jaudit.audit_diff(loaded[a], loaded[b])
    t = taudit.audit_diff(taudit.load_run(str(tmp_path / a)),
                          taudit.load_run(str(tmp_path / b)))
    assert j == t
    assert not t['divergent'] and t['ranks'][0] == []


@pytest.mark.parametrize('num_workers,transport', [(0, None), (2, 'shm'),
                                                   (2, 'pickle')],
                         ids=['serial', 'W2-shm', 'W2-pickle'])
def test_corrupt_drill_names_the_batch(corpus, tmp_path, monkeypatch,
                                       batch_sha256, num_workers, transport):
  """LDDL_FAULTS='corrupt:ledger.corrupt:nth=3' flips a byte of the third
  batch before it is fingerprinted: the delivered batch is damaged for
  real, and both auditors (and the port's CLI, rc 1) name collate
  (epoch 0, index 2) as the first divergence."""
  import lddl_tpu_torch.loader.device as tdevice

  def run(name):
    loader = get_bert_pretrain_data_loader(
        corpus['binned'], vocab_file=corpus['vocab'],
        num_workers=num_workers, transport=transport, **BERT)
    tledger.enable_ledger(directory=str(tmp_path / name), rank=0)
    try:
      return [batch_sha256({k: v.numpy() for k, v in b.items()})
              for b in tdevice.prefetch_to_device(iter(loader), 'cpu')]
    finally:
      tledger.disable_ledger()

  clean = run('clean')
  monkeypatch.setenv('LDDL_FAULTS', 'corrupt:ledger.corrupt:nth=3')
  tfaults.reset()
  damaged = run('damaged')
  assert [i for i, (a, b) in enumerate(zip(clean, damaged)) if a != b] == [2]
  for mod in (jaudit, taudit):
    result = mod.audit_diff(mod.load_run(str(tmp_path / 'clean')),
                            mod.load_run(str(tmp_path / 'damaged')))
    assert result['divergent']
    assert result['first']['boundary'] == 'collate'
    assert result['first']['key'] == {'epoch': 0, 'index': 2}
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  env.pop('LDDL_FAULTS')
  out = subprocess.run(
      [sys.executable, '-m', 'lddl_tpu_torch.telemetry.audit', 'diff',
       str(tmp_path / 'clean'), str(tmp_path / 'damaged')], cwd=ROOT, env=env,
      capture_output=True, text=True, timeout=120)
  assert out.returncode == 1, out.stderr
  assert 'collate: DIVERGED at (epoch=0, index=2)' in out.stdout


def test_audit_cli_on_consistent_and_missing_runs(tmp_path):
  for name in ('a', 'b'):
    led = tledger.Ledger(directory=str(tmp_path / name), rank=0)
    led.record('collate', 'ab' * 8, epoch=0, index=0)
    led.close()
  env = dict(os.environ, PYTHONPATH=str(ROOT))

  def cli(*args):
    return subprocess.run(
        [sys.executable, '-m', 'lddl_tpu_torch.telemetry.audit', *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
  out = cli('diff', str(tmp_path / 'a'), str(tmp_path / 'b'))
  assert out.returncode == 0 and 'ledgers consistent' in out.stdout
  out = cli('show', str(tmp_path / 'a'), '--key', 'epoch=0,index=0')
  assert out.returncode == 0 and '"boundary": "collate"' in out.stdout
  assert cli('diff', str(tmp_path / 'a'), str(tmp_path / 'x')).returncode == 2


@pytest.mark.parametrize('spec', ['corrupt:ledger.corrupt',
                                  'corrupt:ledger.corrupt:nth=2,at=5',
                                  'corrupt:ledger.corrupt:rank=1',
                                  'corrupt:other.site',
                                  'kill:ledger.corrupt'])
def test_corrupt_bytes_matches_lddl_tpu(monkeypatch, spec):
  monkeypatch.setenv('LDDL_FAULTS', spec)
  got = {}
  for name, mod in (('jax', jfaults), ('torch', tfaults)):
    mod.reset()
    bufs = [bytearray(range(8)) for _ in range(3)]
    hits = [mod.corrupt_bytes('ledger.corrupt', memoryview(b), rank=0)
            for b in bufs]
    got[name] = (hits, [bytes(b) for b in bufs])
  assert got['torch'] == got['jax']


# ---------------------------------------------------------------------------
# device records keyed by the batch's ledger coordinate


def _tiny_loop(corpus):
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop
  cfg = BertConfig(dtype=torch.float32, vocab_size=64, hidden_size=32,
                   num_layers=1, num_heads=2, intermediate_size=64,
                   max_position_embeddings=64, dropout_rate=0.0)
  return TrainLoop.build(
      corpus['binned'], load_bert_tokenizer(corpus['vocab']), model_cfg=cfg,
      device='cpu', learning_rate=1e-3, warmup_steps=2, total_steps=100,
      seed=5, batch_size_per_rank=8, bin_size=16, max_seq_length=64,
      loader_kwargs={'shuffle_buffer_size': 16})


def _run_with_ledger(directory, fn):
  tledger._active = None
  tledger.enable_ledger(directory=str(directory), rank=0)
  try:
    return fn()
  finally:
    tledger.disable_ledger()
    tledger._active = None


def _records(directory):
  with open(tledger.ledger_file_name(str(directory), 0)) as f:
    return [json.loads(x) for x in f.read().splitlines()[1:]]


def test_two_epochs_pass_the_audit_self_check(corpus, tmp_path):
  """A two-epoch TrainLoop.run with the ledger on: each device record
  carries the (epoch, index) of its batch's collate record and its digest,
  so both auditors' self-check (``diff run run``) and the port's CLI exit
  0. The same records keyed by the feed's index alone, as lddl_tpu's feed
  keys them, are conflicts (exit 1): the fault this keying repairs."""
  loop = _tiny_loop(corpus)
  n = loop.loader.batches_per_epoch
  led = tmp_path / 'led'
  _run_with_ledger(led, lambda: loop.run(2 * n, log_every=0))
  recs = _records(led)
  device = [r for r in recs if r['boundary'] == 'device']
  collate = {(r['epoch'], r['index']): r['digest'] for r in recs
             if r['boundary'] == 'collate'}
  assert [(r['epoch'], r['index']) for r in device] == [
      (e, i) for e in (0, 1) for i in range(n)]
  assert {(r['epoch'], r['index']): r['digest'] for r in device} == collate
  assert taudit.main(['diff', str(led), str(led)]) == 0
  assert jaudit.main(['diff', str(led), str(led)]) == 0
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  out = subprocess.run(
      [sys.executable, '-m', 'lddl_tpu_torch.telemetry.audit', 'diff',
       str(led), str(led)], cwd=ROOT, env=env, capture_output=True,
      text=True, timeout=120)
  assert out.returncode == 0 and 'ledgers consistent' in out.stdout
  old = tmp_path / 'feed_index'
  old.mkdir()
  with open(tledger.ledger_file_name(str(led), 0)) as f:
    lines = [json.loads(x) for x in f.read().splitlines()]
  with open(tledger.ledger_file_name(str(old), 0), 'w') as f:
    for r in lines:
      if r.get('boundary') == 'device':
        # Each epoch's feed starts at index 0, so the feed's index is the
        # coordinate's: lddl_tpu's key is the line without its epoch.
        r = {k: v for k, v in r.items() if k != 'epoch'}
      f.write(json.dumps(r) + '\n')
  assert taudit.main(['diff', str(old), str(old)]) == 1


def test_a_mid_epoch_resume_verifies_against_its_parent(corpus, tmp_path):
  """A run of two epochs with checkpoints, and a child restored from its
  mid-epoch-0 checkpoint, re-seeked byte-exactly and run to the same end
  across the epoch boundary: ``audit verify child parent`` exits 0 over
  the collate, device and step records, every device record of the child
  at a coordinate the parent recorded with the same digest."""
  parent = _tiny_loop(corpus)
  n = parent.loader.batches_per_epoch
  # Checkpoints at every, 2 * every and the end: all three kept.
  every = 2 * n // 3 + 1
  assert every < n
  _run_with_ledger(tmp_path / 'parent', lambda: parent.run(
      2 * n, ckpt_dir=str(tmp_path / 'ckpt'), ckpt_every=every,
      log_every=0))
  child = _tiny_loop(corpus)
  child.restore(str(tmp_path / 'ckpt'), step=every)
  child.loader.seek(0, every, exact=True)
  _run_with_ledger(tmp_path / 'child', lambda: child.run(
      2 * n, ckpt_dir=str(tmp_path / 'ckpt_child'), ckpt_every=every,
      log_every=0))
  assert taudit.main(['verify', str(tmp_path / 'child'),
                      str(tmp_path / 'parent')]) == 0
  result = taudit.audit_verify(taudit.load_run(str(tmp_path / 'child')),
                               taudit.load_run(str(tmp_path / 'parent')))
  cover = result['coverage'][0]
  assert cover['device'] == {'common': 2 * n - every, 'run_only': 0,
                             'reference_only': every}
  assert cover['step']['common'] == 2  # 2 * every and the end
  assert child.state_digest() == parent.state_digest()


def test_a_loader_swapped_into_a_running_loop_keys_by_its_own_position(
    corpus, tmp_path):
  """A fresh loader attached to a loop that has run an epoch (as a caller
  that times one loop over several loaders does): its device records
  carry the loader's own coordinates, (0, i), equal to its collate
  records, not the loop's step count."""
  loop = _tiny_loop(corpus)
  n = loop.loader.batches_per_epoch
  loop.run(n, log_every=0)
  loop.loader = _tiny_loop(corpus).loader
  _run_with_ledger(tmp_path / 'led', lambda: loop.run(2 * n, log_every=0))
  recs = _records(tmp_path / 'led')
  keys = {b: [(r['epoch'], r['index']) for r in recs if r['boundary'] == b]
          for b in ('collate', 'device')}
  assert keys['device'] == keys['collate'] == [(0, i) for i in range(n)]
