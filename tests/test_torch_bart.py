"""The port's BART text-infilling loader against lddl_tpu's.

Over the committed ``tests/assets/torch_shards/bart/`` shards (lddl_tpu's
BART preprocess over synth text, balanced into two shards): the port's
batches, tokenized by its native encoder, byte-equal to lddl_tpu's loader
tokenizing with its HF tokenizer, epochs 0 and 1, and each dp rank of a
world of 2; through two worker processes; after a byte-exact seek; with
a bare ``BertTokenizerFast`` passed to both loaders; the ``collate``
ledger lines line for line; the digests of digests.json; the data server
serving the BART factory; and the replay CLI rebuilding one batch from
its ledger line.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

import lddl_tpu.telemetry.ledger as jledger
import lddl_tpu_torch.telemetry.ledger as tledger
from chip_smoke import batch_sha256
from lddl_tpu.loader import get_bart_pretrain_data_loader as jax_bart
from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer as jax_tok
from lddl_tpu_torch.loader import get_bart_pretrain_data_loader
from lddl_tpu_torch.loader.shm import SEGMENT_PREFIX, live_segments

ROOT = Path(__file__).resolve().parent.parent
SHARDS = ROOT / 'tests' / 'assets' / 'torch_shards'
BART_PATH = str(SHARDS / 'bart')
VOCAB = str(ROOT / 'benchmarks' / 'assets' / 'bench_vocab_30522.txt')
with open(SHARDS / 'digests.json') as _f:
  DIGESTS = json.load(_f)['bart']
SETTINGS = DIGESTS['settings']
FACTORY = ('lddl_tpu_torch.loader.bart', 'get_bart_pretrain_data_loader')


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
  yield
  tledger.disable_ledger()
  tledger._active = None


def _epochs(loader, n=2):
  return [[batch_sha256(b) for b in loader] for _ in range(n)]


@pytest.fixture(scope='module')
def hf():
  return jax_tok(vocab_file=VOCAB, backend='hf')


@pytest.fixture(scope='module')
def reference(hf):
  """Two epochs of lddl_tpu's loader per (dp_rank, world), tokenizing
  with its HF tokenizer."""
  return {(r, w): _epochs(jax_bart(BART_PATH, tokenizer=hf, dp_rank=r,
                                   dp_world_size=w, **SETTINGS))
          for r, w in ((0, 1), (0, 2), (1, 2))}


def _port(**kw):
  return get_bart_pretrain_data_loader(BART_PATH, vocab_file=VOCAB,
                                       **dict(SETTINGS, **kw))


def test_batches_equal_digests_json():
  """The port's CPU batches of epochs 0 and 1 are digests.json's (made
  from lddl_tpu's loader), and so are their blake2b-8 fingerprints."""
  loader = _port()
  for epoch in range(2):
    batches = list(loader)
    assert [batch_sha256(b) for b in batches] == (
        DIGESTS['batches_by_epoch'][epoch])
    assert len(batches) >= 8
    b = batches[0]
    assert sorted(b) == ['attention_mask', 'decoder_input_ids', 'input_ids',
                         'labels']
    assert all(v.dtype == np.int32 and v.shape == (
        SETTINGS['batch_size_per_rank'], SETTINGS['max_seq_length'])
               for v in b.values())


@pytest.mark.parametrize('rank,world', [(0, 1), (0, 2), (1, 2)],
                         ids=['world1', 'rank0of2', 'rank1of2'])
def test_serial_batches_equal_lddl_tpu(reference, rank, world):
  assert _epochs(_port(dp_rank=rank, dp_world_size=world)) == reference[
      (rank, world)]


def test_two_workers_equal_serial(reference):
  """num_workers=2 (each worker builds its own tokenizer and encoder;
  the parent builds the library first) over the shm ring: byte-equal to
  lddl_tpu's serial loader, both epochs."""
  from lddl_tpu_torch.loader import MultiprocessLoader
  loader = _port(num_workers=2)
  assert isinstance(loader, MultiprocessLoader)
  assert _epochs(loader) == reference[(0, 1)]


@pytest.mark.parametrize('epoch,index', [(0, 3), (1, 5)])
def test_exact_seek_equals_the_uninterrupted_stream(reference, epoch, index):
  loader = _port().seek(epoch, index, exact=True)
  assert [batch_sha256(b) for b in loader] == reference[(0, 1)][epoch][index:]


def test_bare_hf_tokenizer_branch_equals_lddl_tpu(hf):
  """A bare BertTokenizerFast (no encode_batch_ids) takes the collate's
  duck-typed batch-call branch in both packages: equal batches."""
  bare = hf.hf
  assert not hasattr(bare, 'encode_batch_ids')
  mine = _epochs(_port(tokenizer=bare), 1)
  theirs = _epochs(jax_bart(BART_PATH, tokenizer=bare, **SETTINGS), 1)
  assert mine == theirs


def _collate_lines(directory, make, mod_ledger):
  mod_ledger._active = None
  mod_ledger.enable_ledger(directory=str(directory), rank=0)
  try:
    loader = make()
    for _ in range(2):
      for _ in loader:
        pass
  finally:
    mod_ledger.disable_ledger()
    mod_ledger._active = None
  with open(mod_ledger.ledger_file_name(str(directory), 0)) as f:
    lines = [json.loads(x) for x in f.read().splitlines()]
  assert lines[0]['kind'] == 'meta'
  return lines[1:]


def test_collate_ledger_lines_equal_lddl_tpu(hf, tmp_path):
  """Two epochs with the ledger on, serially: the port's collate lines
  are lddl_tpu's line for line, keys (epoch, index) for both epochs."""
  mine = _collate_lines(tmp_path / 'port', _port, tledger)
  theirs = _collate_lines(
      tmp_path / 'jax', lambda: jax_bart(BART_PATH, tokenizer=hf,
                                         **SETTINGS), jledger)
  assert mine == theirs
  n = len(DIGESTS['batches_by_epoch'][0])
  assert [(r['epoch'], r['index']) for r in mine] == [
      (e, i) for e in (0, 1) for i in range(n)]


def test_replay_cli_rebuilds_a_batch_from_its_ledger_line(tmp_path, capsys):
  """``python -m lddl_tpu_torch.replay.cli batch --factory`` over the
  BART factory: the batch at a recorded (epoch, index) is rebuilt bit
  for bit (exit 0)."""
  from lddl_tpu_torch.replay import cli
  _collate_lines(tmp_path / 'led', _port, tledger)
  kwargs = dict(SETTINGS, path=BART_PATH, vocab_file=VOCAB)
  rc = cli.main(['batch', str(tmp_path / 'led'), '--key', 'epoch=1,index=4',
                 '--factory', ':'.join(FACTORY),
                 '--kwargs-json', json.dumps(kwargs)])
  assert rc == 0
  assert 'bit-identical' in capsys.readouterr().out


def test_data_server_serves_the_bart_factory(monkeypatch, reference):
  """A DataServer over the port's BART loader, drained over loopback by
  the network transport of the same factory: lddl_tpu's batches."""
  from lddl_tpu_torch.loader.service import DataServer
  for k in ('LDDL_FAULTS', 'LDDL_DATA_SERVER', 'LDDL_LOADER_TRANSPORT'):
    monkeypatch.delenv(k, raising=False)
  srv = DataServer(_port(), window=4, epochs=2).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  try:
    loader = _port(num_workers=1, transport='network')
    got = _epochs(loader)
  finally:
    srv.stop()
  assert got == reference[(0, 1)]


def test_tokenizer_name_raises():
  with pytest.raises(ValueError, match='tokenizer_name'):
    get_bart_pretrain_data_loader(BART_PATH, tokenizer_name='bert-base')
