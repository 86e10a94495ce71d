"""The port's replay (lddl_tpu_torch.replay) against lddl_tpu's, on the CPU.

Over the committed shards (tests/assets/torch_shards/pairs) and a tiny
BERT:

- batch rematerialization equals lddl_tpu's byte for byte at several
  coordinates, serially, through worker transports, and per rank of a
  world-2 reshard;
- bundles interchange both ways, and a corrupted payload is refused by
  both readers;
- one recorded run per package (the same shards and weights, carried
  over by models/convert.py, dropout off): the port's ``step`` lines
  have the JAX lines' keys and fields, both auditors read them, and
  ``bisect_window`` names the same spike step and batch as lddl_tpu's,
  and the injected sentinel trigger makes the same incident in both;
- step replay in the port matches the recorded fingerprint bit for bit
  from a mid-epoch checkpoint, across the epoch's end, and from bundles,
  where lddl_tpu's replay from the corpus does not (it feeds the loader
  restore re-seeked mid-epoch: resume semantics, another shuffle);
- what replay cannot verify is refused loudly; the CLI's exit codes.

Tolerances: batches, bundles and digests are compared exactly; losses
across the two frameworks within test_torch_train.py's 2e-4 relative.
"""

import json
import os

import numpy as np
import pytest
import torch

from lddl_tpu_torch.core import faults as tfaults
from lddl_tpu_torch.loader.shm import SEGMENT_PREFIX, live_segments
from lddl_tpu_torch.replay import (ReplayMismatch, read_bundle,
                                   rematerialize_batch, replay_coordinate,
                                   write_bundle)
from lddl_tpu_torch.replay.steps import (bisect_window,
                                         replay_step_coordinate,
                                         replay_steps)
from lddl_tpu_torch.telemetry import ledger as tledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, 'tests', 'assets', 'torch_shards', 'pairs')
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
with open(os.path.join(ROOT, 'tests', 'assets', 'torch_shards',
                       'digests.json')) as _f:
  SETTINGS = json.load(_f)['pairs']['settings']
EPOCH = 22  # batches an epoch of pairs/ gives at the committed settings
LOADER = dict(path=PAIRS, vocab_file=VOCAB, **SETTINGS)
TORCH_BERT = ('lddl_tpu_torch.loader.bert', 'get_bert_pretrain_data_loader')
JAX_BERT = ('lddl_tpu.loader.bert', 'get_bert_pretrain_data_loader')
# The tiny BERT (vocab of the committed vocab file, padded to 64).
TINY = dict(vocab_size=30528, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=512)
MAX_PREDICTIONS = 112
# The port-only runs take a smaller masked-only head: the vocab
# projection is most of a tiny step's work, and a replay compares
# whatever the step computes.
PORT_MAX_PREDICTIONS = 16
LOSS_RTOL = 2e-4  # test_torch_train.py's tolerance across the frameworks
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=8,
             batch_size_per_rank=SETTINGS['batch_size_per_rank'],
             bin_size=SETTINGS['bin_size'],
             max_seq_length=SETTINGS['max_seq_length'],
             masking=SETTINGS['masking'], seed=SETTINGS['base_seed'],
             max_predictions=MAX_PREDICTIONS,
             loader_kwargs={'shuffle_buffer_size':
                            SETTINGS['shuffle_buffer_size']})
# The recorded runs: a checkpoint at step 0 (an epoch's start), then
# RECORD_STEPS steps with one every CKPT_EVERY (3: mid-epoch), an injected
# sentinel trigger at the FAULT_NTH-th step (step 2).
RECORD_STEPS = 6
CKPT_EVERY = 3
FAULT = 'raise:sentinel.trigger:nth=3'


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


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
  """Two intra-op threads for the CPU steps: the other test processes
  share the host's cores, and oversubscribed threads make every tiny
  step wait."""
  import torch
  threads = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _gates_off():
  """The port's ledger, sentinel and recorder gates off after each test
  (conftest does so for lddl_tpu's ledger)."""
  yield
  from lddl_tpu_torch.telemetry import sentinel
  from lddl_tpu_torch.training import flight
  tledger.disable_ledger()
  tledger._active = None
  sentinel.disable_sentinel()
  flight.disable_flight()


def _arrays_equal(a, b):
  assert sorted(a) == sorted(b)
  for k in a:
    np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def _record_ledger(directory, fn):
  tledger._active = None
  tledger.enable_ledger(directory=str(directory), rank=0)
  try:
    return fn()
  finally:
    tledger.disable_ledger()
    tledger._active = None


# ---------------------------------------------------------------------------
# batches


@pytest.mark.parametrize('epoch,index', [(0, 0), (0, 7), (0, 21), (1, 4)])
def test_rematerialize_equals_lddl_tpu(epoch, index):
  """The port rebuilds the batch at (epoch, index) from the epoch's start
  exactly as lddl_tpu does, and it is the uninterrupted stream's."""
  from lddl_tpu.replay import rematerialize_batch as jax_rematerialize
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  got = rematerialize_batch(TORCH_BERT, LOADER, epoch, index)
  _arrays_equal(got, jax_rematerialize(JAX_BERT, LOADER, epoch, index))
  loader = get_bert_pretrain_data_loader(**LOADER)
  stream = [b for _ in range(epoch + 1) for b in loader]
  _arrays_equal(got, stream[epoch * EPOCH + index])


@pytest.mark.parametrize('transport', ['pickle', 'shm'])
def test_worker_ledger_replays_in_both_packages(transport, tmp_path):
  """A ledger the port's parent records through two worker processes
  replays byte-identical from the serial loader spec, in the port and in
  lddl_tpu."""
  from lddl_tpu.replay import replay_coordinate as jax_replay
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  kw = dict(LOADER, num_workers=2, transport=transport)
  _record_ledger(tmp_path / 'led', lambda: [
      None for _ in get_bert_pretrain_data_loader(**kw)])
  for index in (0, 9, 21):
    key = (('epoch', 0), ('index', index))
    mine = replay_coordinate(str(tmp_path / 'led'), key, TORCH_BERT,
                             LOADER, boundary='collate')
    theirs = jax_replay(str(tmp_path / 'led'), key, JAX_BERT, LOADER,
                        boundary='collate')
    assert mine['match'] is theirs['match'] is True, (index, mine)
    assert mine['reconstructed'] == theirs['reconstructed']


def test_replay_across_world_size_reshard(tmp_path):
  """Each rank of a world-2 run replays its own collate records; the
  ranks' batches differ at one coordinate and equal lddl_tpu's."""
  from lddl_tpu.replay import rematerialize_batch as jax_rematerialize
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  digests = []
  for r in (0, 1):
    kw = dict(LOADER, dp_rank=r, dp_world_size=2, batch_size_per_rank=8)
    _record_ledger(tmp_path / f'led{r}', lambda kw=kw: [
        None for _ in get_bert_pretrain_data_loader(**kw)])
    res = replay_coordinate(str(tmp_path / f'led{r}'),
                            (('epoch', 0), ('index', 3)), TORCH_BERT, kw,
                            boundary='collate')
    assert res['match'] is True, (r, res)
    _arrays_equal(res['batch'], jax_rematerialize(JAX_BERT, kw, 0, 3))
    digests.append(res['recorded'])
  assert digests[0] != digests[1]


# ---------------------------------------------------------------------------
# bundles


@pytest.mark.parametrize('writer', ['port', 'lddl_tpu'])
def test_bundles_interchange_and_refuse_corruption(writer, tmp_path,
                                                   monkeypatch):
  """A bundle either package writes reads in both to equal arrays under
  one manifest; a flipped payload byte is refused by both readers."""
  from lddl_tpu.core import faults as jfaults
  from lddl_tpu.replay import ReplayMismatch as JaxMismatch
  from lddl_tpu.replay import read_bundle as jax_read
  from lddl_tpu.replay import write_bundle as jax_write
  batch = rematerialize_batch(TORCH_BERT, LOADER, 0, 5)
  bdir = str(tmp_path / 'bundle')
  write = write_bundle if writer == 'port' else jax_write
  write(bdir, batch, {'epoch': 0, 'index': 5},
        checkpoint={'dir': '/ck', 'step': 4})
  (mine, got), (theirs, got_j) = read_bundle(bdir), jax_read(bdir)
  assert mine == theirs and mine['coordinate'] == {'epoch': 0, 'index': 5}
  assert mine['digest'] == tledger.fingerprint_batch(batch)
  _arrays_equal(got, batch)
  _arrays_equal(got_j, batch)
  monkeypatch.setenv('LDDL_FAULTS', 'corrupt:replay.read')
  for reader, error, mod in ((read_bundle, ReplayMismatch, tfaults),
                             (jax_read, JaxMismatch, jfaults)):
    mod.reset()
    with pytest.raises(error, match=r'epoch=0, index=5.*corrupt'):
      reader(bdir)
    mod.reset()


# ---------------------------------------------------------------------------
# one recorded run per package


def _jax_loop(path, dropout=0.0):
  import jax.numpy as jnp
  from lddl_tpu.models import BertConfig as JaxConfig
  from lddl_tpu.parallel import make_mesh
  from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer as jtok
  from lddl_tpu.training.pretrain import TrainLoop as JaxLoop
  return JaxLoop.build(
      path, jtok(vocab_file=VOCAB, backend='hf') if path else None,
      model_cfg=JaxConfig(dtype=jnp.float32, dropout_rate=dropout, **TINY),
      mesh=make_mesh(), **TRAIN)


def _torch_loop(path, params=None, dropout=0.0, **kw):
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop
  loop = TrainLoop.build(
      path, load_bert_tokenizer(VOCAB) if path else None,
      model_cfg=BertConfig(dtype=torch.float32, attention_impl='flash',
                           dropout_rate=dropout, **TINY),
      device='cpu', **dict(TRAIN, **kw))
  if params is not None:
    loop.model.load_state_dict(params)
  return loop


@pytest.fixture(scope='module')
def recorded(tmp_path_factory):
  """The same run in both packages, from the same weights: a checkpoint at
  step 0, RECORD_STEPS steps with a checkpoint every CKPT_EVERY, the
  ledger, the sentinel and the flight recorder on, and an injected
  sentinel trigger."""
  import jax
  from lddl_tpu.core import faults as jfaults
  from lddl_tpu.telemetry import ledger as jledger
  from lddl_tpu.telemetry import sentinel as jsentinel
  from lddl_tpu.training import flight as jflight
  from lddl_tpu_torch.models import flax_to_state_dict
  from lddl_tpu_torch.telemetry import sentinel as tsentinel
  from lddl_tpu_torch.training import flight as tflight
  root = tmp_path_factory.mktemp('recorded')
  jloop = _jax_loop(PAIRS)
  params = flax_to_state_dict(jax.device_get(jloop.params))
  out = {'params': params}
  saved = os.environ.get('LDDL_FAULTS')
  os.environ['LDDL_FAULTS'] = FAULT
  try:
    for name, loop, led_mod, sent_mod, flight_mod, faults_mod in (
        ('jax', jloop, jledger, jsentinel, jflight, jfaults),
        ('torch', _torch_loop(PAIRS, params), tledger, tsentinel, tflight,
         tfaults)):
      paths = {k: str(root / f'{name}_{k}') for k in ('ckpt', 'led', 'inc')}
      faults_mod.reset()
      sent_mod.enable_sentinel()
      flight_mod.enable_flight(out_dir=paths['inc'])
      led_mod._active = None
      led_mod.enable_ledger(directory=paths['led'], rank=0)
      try:
        loop.save(paths['ckpt'])
        losses = loop.run(RECORD_STEPS, ckpt_dir=paths['ckpt'],
                          ckpt_every=CKPT_EVERY, log_every=0)
        incidents = flight_mod.scan_incidents(paths['inc'])
        status = sent_mod.sentinel_status()
      finally:
        led_mod.disable_ledger()
        led_mod._active = None
        sent_mod.disable_sentinel()
        flight_mod.disable_flight()
        faults_mod.reset()
      out[name] = dict(paths, losses=losses, incidents=incidents,
                       status=status, digest=loop.state_digest())
    # The JAX tests restore into this loop: a fresh one would compile its
    # step for every bin again.
    out['jloop'] = jloop
  finally:
    if saved is None:
      del os.environ['LDDL_FAULTS']
    else:
      os.environ['LDDL_FAULTS'] = saved
  return out


def _lines(led, boundary):
  with open(os.path.join(led, 'ledger.rank0.jsonl')) as f:
    recs = [json.loads(x) for x in f.read().splitlines()]
  return [r for r in recs if r.get('boundary') == boundary]


def test_step_lines_have_the_jax_keys_and_both_auditors_read_them(
    recorded, capsys):
  """Step records at the checkpoints, key for key and field for field
  the JAX loop's (digests differ across frameworks; the losses agree
  within LOSS_RTOL); the collate records are equal digest for digest;
  each package's auditor reads the other's ledger."""
  from lddl_tpu.telemetry import audit as jaudit
  from lddl_tpu_torch.telemetry import audit as taudit
  np.testing.assert_allclose(recorded['torch']['losses'],
                             recorded['jax']['losses'], rtol=LOSS_RTOL)
  mine = _lines(recorded['torch']['led'], 'step')
  theirs = _lines(recorded['jax']['led'], 'step')
  assert [sorted(r) for r in mine] == [sorted(r) for r in theirs]
  assert [(r['step'], r['samples'], r['n']) for r in mine] == [
      (r['step'], r['samples'], r['n']) for r in theirs] == [
          (s, s * TRAIN['batch_size_per_rank'], i + 1)
          for i, s in enumerate(range(0, RECORD_STEPS + 1, CKPT_EVERY))]
  assert 'loss' not in mine[0]  # no step has run at step 0
  np.testing.assert_allclose([r['loss'] for r in mine[1:]],
                             [r['loss'] for r in theirs[1:]], rtol=LOSS_RTOL)
  assert [r['digest'] for r in _lines(recorded['torch']['led'], 'collate')
          ] == [r['digest'] for r in _lines(recorded['jax']['led'],
                                            'collate')]
  for audit, led in ((jaudit, recorded['torch']['led']),
                     (taudit, recorded['jax']['led'])):
    assert audit.main(['show', led]) == 0
    assert audit.main(['show', led, '--key', 'step=3']) == 0
    out = capsys.readouterr().out
    assert '"boundary": "step"' in out and '"step": 3' in out


def test_step_replay_from_a_mid_epoch_checkpoint(recorded, tmp_path):
  """Checkpoint 3 sits mid-epoch. The port replays step 6 from it over
  the corpus bit for bit; lddl_tpu's replay feeds the loader restore
  re-seeked to (0, 3) — a fresh shuffle buffer — and its step 6 differs
  from the recorded line (the reference's fault, recorded in ROADMAP
  Queue 3)."""
  from lddl_tpu.replay.steps import replay_step_coordinate as jax_replay
  t, j = recorded['torch'], recorded['jax']
  fresh = _torch_loop(PAIRS)
  out = replay_step_coordinate(fresh, t['ckpt'], RECORD_STEPS,
                               ledger_path=t['led'])
  assert out['restored_step'] == CKPT_EVERY
  assert out['match'] is True, out
  assert out['digest'] == t['digest']
  np.testing.assert_array_equal([x for _, x in out['losses']],
                                t['losses'][CKPT_EVERY:])
  ref = jax_replay(recorded['jloop'], j['ckpt'], RECORD_STEPS,
                   ledger_path=j['led'])
  assert ref['restored_step'] == CKPT_EVERY
  assert ref['match'] is False


def test_bisect_window_names_what_lddl_tpu_names(recorded):
  """bisect over (0, RECORD_STEPS] from checkpoint 0 (an epoch's start,
  where lddl_tpu's replay feeds the recorded batches too): the same
  spike step, delta and batch coordinate; the per-step losses within
  LOSS_RTOL; the port's per-sample losses are lddl_tpu's pretrain_loss on
  the same rows with the same weights."""
  import jax
  from lddl_tpu.parallel.train import pretrain_loss
  from lddl_tpu.replay.steps import bisect_window as jax_bisect
  mine = bisect_window(_torch_loop(PAIRS), recorded['torch']['ckpt'], 0,
                       RECORD_STEPS, per_sample=True)
  jloop = recorded['jloop']
  theirs = jax_bisect(jloop, recorded['jax']['ckpt'], 0, RECORD_STEPS)
  np.testing.assert_allclose([x for _, x in mine['losses']],
                             recorded['torch']['losses'], rtol=0)
  np.testing.assert_allclose([x for _, x in mine['losses']],
                             [x for _, x in theirs['losses']],
                             rtol=LOSS_RTOL)
  deltas = sorted(b - a for (_, a), (_, b) in zip(mine['losses'][:-1],
                                                   mine['losses'][1:]))
  # The spike is unambiguous at this tolerance (the two largest jumps
  # differ by more than the frameworks' loss disagreement).
  assert deltas[-1] - deltas[-2] > 10 * LOSS_RTOL * max(
      x for _, x in mine['losses'])
  assert mine['spike_step'] == theirs['spike_step']
  assert mine['batch_coordinate'] == theirs['batch_coordinate'] == {
      'epoch': 0, 'index': mine['spike_step'] - 1}
  np.testing.assert_allclose(mine['delta'], theirs['delta'],
                             atol=2 * LOSS_RTOL * mine['spike_loss'])
  # Per sample: the weights the spike step started from, in lddl_tpu.
  spike = mine['spike_step']
  jloop.restore(recorded['jax']['ckpt'], step=0)
  from lddl_tpu.replay.steps import replay_steps as jax_replay_steps
  if spike - 1:
    jax_replay_steps(jloop, spike - 1)
  batch = rematerialize_batch(TORCH_BERT, LOADER, 0, spike - 1)
  rows = batch['input_ids'].shape[0]
  row_loss = jax.jit(lambda params, one: pretrain_loss(
      jloop.model, params, one, max_predictions=MAX_PREDICTIONS)[0])
  want = [float(row_loss(jloop.params,
                         {k: v[i:i + 1] for k, v in batch.items()}))
          for i in range(rows)]
  assert len(mine['per_sample']) == rows
  np.testing.assert_allclose(mine['per_sample'], want, rtol=LOSS_RTOL)
  assert mine['spike_sample'] == int(np.argmax(want))


def test_injected_trigger_captures_what_lddl_tpu_captures(recorded):
  """One incident in each package from the same run: the manifests'
  keys, the trigger, its steps, the suspect's coordinate and digest (the
  ledger's collate line), and the ring's shared ordinals' batches equal;
  the sentinel's status lists the port's."""
  t, j = recorded['torch'], recorded['jax']
  assert len(t['incidents']) == len(j['incidents']) == 1
  mine, theirs = t['incidents'][0]['manifest'], j['incidents'][0]['manifest']
  assert sorted(mine) == sorted(theirs)
  for man in (mine, theirs):
    assert man['trigger']['detector'] == 'injected'
    assert (man['step'], man['replay_step']) == (2, 3)
    assert man['suspect']['coordinate'] == {'epoch': 0, 'index': 2}
    assert man['checkpoint'] is None  # no in-loop checkpoint before step 2
    assert sorted(man['ring'][0]) == sorted(theirs['ring'][0])
  recorded_collate = {(r['epoch'], r['index']): r['digest']
                      for r in _lines(t['led'], 'collate')}
  assert mine['suspect']['digest'] == theirs['suspect']['digest'] == (
      recorded_collate[(0, 2)])
  # Ring entries of one ordinal carry one batch in both packages (how far
  # the feed prefetched past the trigger may differ).
  by_ord = {e['ordinal']: e for e in theirs['ring']}
  shared = [e for e in mine['ring'] if e['ordinal'] in by_ord]
  assert len(shared) >= 3
  for e in shared:
    assert (e['coordinate'], e['digest']) == (
        by_ord[e['ordinal']]['coordinate'], by_ord[e['ordinal']]['digest'])
    assert e['digest'] == recorded_collate[(0, e['ordinal'])]
  assert [i['dir'] for i in t['status']['incidents']] == [
      t['incidents'][0]['dir']]


def test_the_port_incident_replays_its_step(recorded):
  """Checkpoint 0, the ring's bundles of steps 1-3: step 3 re-executes
  bit for bit on a loop with no corpus."""
  from lddl_tpu_torch.training import flight
  t = recorded['torch']
  inc = t['incidents'][0]
  bundles = flight.replay_bundles(inc['dir'], dict(
      inc['manifest'], checkpoint={'dir': t['ckpt'], 'step': 0}))
  assert [os.path.basename(b) for b in bundles] == [
      'ord000000-e0-i0', 'ord000001-e0-i1', 'ord000002-e0-i2']
  batches = [read_bundle(b)[1] for b in bundles]
  out = replay_step_coordinate(_torch_loop(None), t['ckpt'], 3,
                               ledger_path=t['led'], batches=batches)
  assert (out['restored_step'], out['match']) == (0, True), out


# ---------------------------------------------------------------------------
# the port alone: dropout on, across the epoch's end, from bundles

PORT_STEPS = 24
PORT_CKPT_EVERY = 8


def _port_loop(path):
  return _torch_loop(path, dropout=0.1,
                     max_predictions=PORT_MAX_PREDICTIONS)


@pytest.fixture(scope='module')
def port_run(tmp_path_factory):
  """PORT_STEPS steps of the tiny BERT with dropout, the ledger on and a
  checkpoint every PORT_CKPT_EVERY (8 and 16 are mid-epoch; the epoch ends
  at 22)."""
  root = tmp_path_factory.mktemp('port_run')
  paths = {k: str(root / k) for k in ('ckpt', 'led')}
  loop = _port_loop(PAIRS)
  losses = _record_ledger(paths['led'], lambda: loop.run(
      PORT_STEPS, ckpt_dir=paths['ckpt'], ckpt_every=PORT_CKPT_EVERY,
      log_every=0))
  return dict(paths, losses=losses, digest=loop.state_digest(), root=root)


@pytest.mark.parametrize('target,restored', [(16, 8), (24, 16)])
def test_port_step_replay_from_the_corpus(port_run, target, restored):
  """Bit for bit from a mid-epoch checkpoint, within the epoch (16 from
  8) and across its end (24 from 16), dropout on."""
  out = replay_step_coordinate(_port_loop(PAIRS),
                               port_run['ckpt'], target,
                               ledger_path=port_run['led'])
  assert (out['restored_step'], out['match']) == (restored, True), out
  np.testing.assert_array_equal([x for _, x in out['losses']],
                                port_run['losses'][restored:target])
  if target == PORT_STEPS:
    assert out['digest'] == port_run['digest']


def test_port_step_replay_from_bundles(port_run, monkeypatch):
  """A loader-free loop (build(path=None)) restores checkpoint 8 and
  replays step 16 from eight bundles bit for bit; the replay.step fault
  site fires before a replayed step."""
  led, ckpt = port_run['led'], port_run['ckpt']
  from lddl_tpu_torch.replay.rematerialize import lookup_digest
  from lddl_tpu_torch.telemetry.audit import load_run
  run = load_run(led)
  batches = []
  for i in range(8, 16):
    res = replay_coordinate(led, (('epoch', 0), ('index', i)), TORCH_BERT,
                            LOADER, boundary='collate')
    assert res['match'] is True
    bdir = os.path.join(port_run['root'], f'bundle{i}')
    write_bundle(bdir, res['batch'], res['coordinate'],
                 digest=lookup_digest(run, (('epoch', 0), ('index', i)),
                                      boundary='collate')[0],
                 checkpoint={'dir': ckpt, 'step': 8})
    batches.append(read_bundle(bdir)[1])
  fresh = _port_loop(None)
  assert fresh.loader is None
  out = replay_step_coordinate(fresh, ckpt, 16, ledger_path=led,
                               batches=batches)
  assert (out['restored_step'], out['match']) == (8, True), out
  monkeypatch.setenv('LDDL_FAULTS', 'raise:replay.step')
  tfaults.reset()
  try:
    with pytest.raises(OSError, match='injected fault at replay.step'):
      replay_step_coordinate(_port_loop(None), ckpt, 16,
                             batches=batches)
  finally:
    tfaults.reset()


def test_step_replay_without_what_it_needs_is_loud(port_run, tmp_path,
                                                   monkeypatch):
  """No checkpoint, no batches, too few batches, an unrecorded step, a
  ledger in a hash this process cannot compute: each refused before a
  step runs."""
  from lddl_tpu_torch.training import pretrain
  ckpt, led = port_run['ckpt'], port_run['led']
  with pytest.raises(FileNotFoundError, match='no checkpoint'):
    replay_step_coordinate(_torch_loop(None), str(tmp_path / 'nope'), 2)
  with pytest.raises(ValueError, match='bundled batches'):
    replay_step_coordinate(_torch_loop(None), ckpt, 16)
  loop = _torch_loop(PAIRS)
  with pytest.raises(ValueError, match='cannot cover'):
    replay_steps(loop, 4, batches=[{}])
  with pytest.raises(LookupError, match=r'no ledger record at \(step=12\)'):
    replay_step_coordinate(loop, ckpt, 12, ledger_path=led)
  # An xxh64 ledger on a host without the xxhash wheel.
  xxh = tmp_path / 'xxh'
  xxh.mkdir()
  with open(os.path.join(led, 'ledger.rank0.jsonl')) as f:
    lines = [json.loads(x) for x in f.read().splitlines()]
  with open(xxh / 'ledger.rank0.jsonl', 'w') as f:
    for rec in lines:
      if rec.get('kind') == 'meta':
        rec['algo'] = 'xxh64'
      f.write(json.dumps(rec) + '\n')
  monkeypatch.setattr(tledger, '_xxhash', None)
  with pytest.raises(ValueError, match='cannot be verified here'):
    replay_step_coordinate(loop, ckpt, 16, ledger_path=str(xxh))
  monkeypatch.undo()
  # A CUDA context that began without the deterministic cuBLAS workspace
  # cannot reproduce a recorded step: refused, never compared.
  monkeypatch.delenv('CUBLAS_WORKSPACE_CONFIG', raising=False)
  monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
  with pytest.raises(ValueError, match='CUBLAS_WORKSPACE_CONFIG'):
    pretrain.require_deterministic_cublas()
  monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: False)
  pretrain.require_deterministic_cublas()
  assert os.environ['CUBLAS_WORKSPACE_CONFIG'] == ':4096:8'


@pytest.fixture(scope='module')
def resumed_run(port_run, tmp_path_factory):
  """port_run preempted mid-epoch and resumed: its first session's ledger
  lines up to the collate of batch 12 (killed after its checkpoint 8),
  then a second session restores checkpoint 8 (the loader re-seeked
  mid-epoch: resume semantics) and runs to step 16 with a checkpoint
  every 4, appending to the same ledger."""
  import shutil
  from lddl_tpu_torch.training.pretrain import _step_dirs
  root = tmp_path_factory.mktemp('resumed')
  paths = {k: str(root / k) for k in ('ckpt', 'led')}
  os.makedirs(paths['led'])
  with open(os.path.join(port_run['led'], 'ledger.rank0.jsonl')) as f:
    lines = f.read().splitlines()
  with open(os.path.join(paths['led'], 'ledger.rank0.jsonl'), 'w') as f:
    for line in lines:
      rec = json.loads(line)
      if rec.get('boundary') == 'collate' and rec['index'] >= 12:
        break
      f.write(line + '\n')
  src = dict(_step_dirs(port_run['ckpt']))[8]
  shutil.copytree(src, os.path.join(paths['ckpt'], os.path.basename(src)))
  loop = _port_loop(PAIRS)
  loop.restore(paths['ckpt'], step=8)
  losses = _record_ledger(paths['led'], lambda: loop.run(
      16, ckpt_dir=paths['ckpt'], ckpt_every=4, log_every=0))
  return dict(paths, losses=losses, digest=loop.state_digest())


@pytest.mark.parametrize('target,restored', [(12, 8), (16, 12)])
def test_port_step_replay_after_a_mid_epoch_resume(resumed_run, port_run,
                                                   target, restored):
  """The run fed the resumed stream after checkpoint 8, not the
  uninterrupted one: the replay reads that from the ledger, bit for bit
  from the resume's own checkpoint (12 from 8) and from a later one in
  the same epoch (16 from 12, the stream resumed at 8 and skipped to
  12)."""
  out = replay_step_coordinate(_port_loop(PAIRS), resumed_run['ckpt'],
                               target, ledger_path=resumed_run['led'])
  assert (out['restored_step'], out['match']) == (restored, True), out
  np.testing.assert_array_equal([x for _, x in out['losses']],
                                resumed_run['losses'][restored - 8:
                                                      target - 8])
  # The resumed run is another run than the uninterrupted one.
  assert resumed_run['losses'] != port_run['losses'][8:16]
  if target == 16:
    assert out['digest'] == resumed_run['digest']


def test_a_stream_the_ledger_does_not_know_is_refused(resumed_run,
                                                      tmp_path):
  """A collate line at the restored coordinate that no stream of the
  loader reproduces: replay refuses (ValueError, exit 2), never
  compares."""
  led = tmp_path / 'led'
  led.mkdir()
  with open(os.path.join(resumed_run['led'], 'ledger.rank0.jsonl')) as f:
    recs = [json.loads(x) for x in f.read().splitlines()]
  for rec in recs:
    if rec.get('boundary') == 'collate' and rec['index'] == 12:
      rec['digest'] = '0' * len(rec['digest'])
  with open(led / 'ledger.rank0.jsonl', 'w') as f:
    f.write(''.join(json.dumps(r) + '\n' for r in recs))
  with pytest.raises(ValueError, match='no stream of this loader') as e:
    replay_step_coordinate(_port_loop(PAIRS), resumed_run['ckpt'], 16,
                           ledger_path=str(led))
  assert not isinstance(e.value, ReplayMismatch)


def test_bisect_feeds_the_recorded_stream_after_a_mid_epoch_resume(
    resumed_run):
  """bisect over (8, 16] of the run resumed at 8, with its ledger: the
  resumed run's losses bit for bit, per-sample scoring from the same
  stream; without the ledger it replays the uninterrupted stream, which
  that run never fed."""
  out = bisect_window(_port_loop(PAIRS), resumed_run['ckpt'], 8, 16,
                      ledger_path=resumed_run['led'], per_sample=True)
  assert out['restored_step'] == 8 and out['stream_checked'] is True
  assert [s for s, _ in out['losses']] == list(range(9, 17))
  np.testing.assert_array_equal([x for _, x in out['losses']],
                                resumed_run['losses'][:8])
  assert len(out['per_sample']) == TRAIN['batch_size_per_rank']
  unchecked = bisect_window(_port_loop(PAIRS), resumed_run['ckpt'], 8, 16)
  assert unchecked['stream_checked'] is False
  assert [x for _, x in unchecked['losses']] != resumed_run['losses'][:8]


def _bisect_argv(resumed_run):
  return ['--checkpoint-dir', resumed_run['ckpt'], '--lo', '8', '--hi',
          '16', '--json']


def test_bisect_cli_refuses_a_ledger_no_stream_matches(
    resumed_run, tmp_path, monkeypatch, capsys):
  """The replay CLI's bisect: exit 2 when no stream of the loader feeds
  the ledger's batches (a collate digest changed at the resume); without
  --ledger, exit 0 and one stderr line saying the stream was not
  checked."""
  from lddl_tpu_torch.replay import cli
  monkeypatch.setattr(cli, 'build_loop', lambda args: _port_loop(PAIRS))
  led = tmp_path / 'led'
  led.mkdir()
  with open(os.path.join(resumed_run['led'], 'ledger.rank0.jsonl')) as f:
    recs = [json.loads(x) for x in f.read().splitlines()]
  for rec in recs:
    if rec.get('boundary') == 'collate' and rec['index'] == 8:
      rec['digest'] = '0' * len(rec['digest'])
  with open(led / 'ledger.rank0.jsonl', 'w') as f:
    f.write(''.join(json.dumps(r) + '\n' for r in recs))
  argv = ['bisect'] + _bisect_argv(resumed_run)
  assert cli.main(argv + ['--ledger', str(led)]) == 2
  assert 'no stream of this loader' in capsys.readouterr().err
  assert cli.main(argv) == 0
  err = capsys.readouterr().err.strip().splitlines()
  assert err == ['replay: bisect feeds the uninterrupted stream, not '
                 'checked against a recording (pass --ledger)']


def test_incident_bisect_forwards_the_ledger(resumed_run, tmp_path,
                                             monkeypatch, capsys):
  """``python -m lddl_tpu_torch.training.flight bisect <incident> --
  --ledger L``: the ledger reaches the replay CLI's bisect, which feeds
  the resumed run's batches (its losses, bit for bit)."""
  from lddl_tpu_torch.replay import cli
  from lddl_tpu_torch.training import flight
  monkeypatch.setattr(cli, 'build_loop', lambda args: _port_loop(PAIRS))
  inc = tmp_path / 'incident'
  inc.mkdir()
  with open(inc / flight.MANIFEST, 'w') as f:
    json.dump({'version': 1, 'trigger': {'detector': 'injected'},
               'step': 15, 'replay_step': 16,
               'checkpoint': {'dir': resumed_run['ckpt'], 'step': 8},
               'ring': [{'ordinal': o} for o in range(8, 16)]}, f)
  assert flight.main(['bisect', str(inc), '--', '--ledger',
                      resumed_run['led'], '--json']) == 0
  out = json.loads(capsys.readouterr().out)
  assert out['window'] == [8, 16] and out['stream_checked'] is True
  np.testing.assert_array_equal([x for _, x in out['losses']],
                                resumed_run['losses'][:8])


@pytest.mark.parametrize('kind', ['serial', 'workers', 'synthetic'])
def test_exact_seek_yields_the_uninterrupted_stream(kind):
  """seek(e, i, exact=True): the next epoch is batches i.. of the
  uninterrupted epoch, with a plain seek's tell() and len(); a plain
  mid-epoch seek of the binned loader gives another batch (resume
  semantics)."""
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.testing import get_synthetic_batch_loader
  if kind == 'synthetic':
    loader = get_synthetic_batch_loader(batch_size=4, seq_len=16, steps=9)
    make = lambda: loader  # noqa: E731
  else:
    kw = dict(LOADER, num_workers=2, transport='pickle') if (
        kind == 'workers') else LOADER
    make = lambda: get_bert_pretrain_data_loader(**kw)  # noqa: E731
    loader = make()
  full = list(loader)
  at = len(full) // 3
  loader = make()
  assert loader.seek(0, at, exact=True) is loader
  assert loader.tell() == (0, at) and len(loader) == len(full) - at
  got = list(loader)
  assert len(got) == len(full) - at
  for a, b in zip(got, full[at:]):
    _arrays_equal(a, b)
  assert loader.tell() == (1, 0)
  if kind == 'serial':
    loader.seek(0, at)
    assert (tledger.fingerprint_batch(next(iter(loader))) !=
            tledger.fingerprint_batch(full[at]))


def test_a_blake2b8_ledger_verifies_where_xxhash_is_the_default(
    tmp_path, monkeypatch):
  """The replay hashes in the algorithm the ledger's meta line names: a
  blake2b-8 ledger and bundle verify in a process whose own algorithm is
  xxh64 (where the wheel is installed)."""
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  monkeypatch.setattr(tledger, '_xxhash', None)
  monkeypatch.setattr(tledger, 'ALGO', 'blake2b8')
  _record_ledger(tmp_path / 'led', lambda: [
      None for _ in get_bert_pretrain_data_loader(**LOADER)])
  batch = rematerialize_batch(TORCH_BERT, LOADER, 0, 5)
  want = tledger.fingerprint_batch(batch)
  write_bundle(str(tmp_path / 'b'), batch, {'epoch': 0, 'index': 5})
  monkeypatch.undo()
  assert tledger.fingerprint_batch(batch, 'blake2b8') == want
  res = replay_coordinate(str(tmp_path / 'led'),
                          (('epoch', 0), ('index', 5)), TORCH_BERT, LOADER,
                          boundary='collate')
  assert (res['match'], res['algo'], res['reconstructed']) == (
      True, 'blake2b8', want)
  manifest, got = read_bundle(str(tmp_path / 'b'))
  assert (manifest['algo'], manifest['digest']) == ('blake2b8', want)
  _arrays_equal(got, batch)


def test_build_sets_the_deterministic_cublas_workspace(tmp_path,
                                                       monkeypatch):
  """With the ledger on, build() for a CUDA device sets
  CUBLAS_WORKSPACE_CONFIG before the model moves to the card (the model
  move is where CUDA comes up), so build-then-run works from the API;
  with the ledger off it leaves the environment alone; a process whose
  CUDA began without it is refused."""
  from lddl_tpu_torch.training import pretrain

  class Moved(Exception):
    pass

  def to(self, device):
    raise Moved(os.environ.get('CUBLAS_WORKSPACE_CONFIG'))

  monkeypatch.delenv('CUBLAS_WORKSPACE_CONFIG', raising=False)
  monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: False)
  monkeypatch.setattr(pretrain, 'resolve_device',
                      lambda device: torch.device('cuda'))
  monkeypatch.setattr(pretrain.BertForPretraining, 'to', to)
  with pytest.raises(Moved) as e:
    _torch_loop(None)
  assert e.value.args == (None,)
  with pytest.raises(Moved) as e:
    _record_ledger(tmp_path / 'led', lambda: _torch_loop(None))
  assert e.value.args == (':4096:8',)
  monkeypatch.delenv('CUBLAS_WORKSPACE_CONFIG')
  monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
  with pytest.raises(ValueError, match='CUBLAS_WORKSPACE_CONFIG'):
    _record_ledger(tmp_path / 'led', lambda: _torch_loop(None))


def test_the_ledger_runs_the_loop_deterministically(tmp_path):
  """With the ledger on, run() turns deterministic algorithms on (an op
  without a deterministic kernel raises) and puts the caller's setting
  back after; off, it leaves the setting alone."""
  seen = []

  class Probe:
    batch_size = TRAIN['batch_size_per_rank']

    def __iter__(self):
      seen.append((torch.are_deterministic_algorithms_enabled(),
                   torch.is_deterministic_algorithms_warn_only_enabled()))
      yield rematerialize_batch(TORCH_BERT, LOADER, 0, 0)

  loop = _torch_loop(None)
  loop.loader = Probe()
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    _record_ledger(tmp_path / 'led', lambda: loop.run(1, log_every=0))
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled()) == (
                True, True)
  finally:
    torch.use_deterministic_algorithms(False)
  loop.run(2, log_every=0)
  assert seen == [(True, False), (False, False)]


# ---------------------------------------------------------------------------
# the CLI


def _loader_argv():
  return ['--path', PAIRS, '--vocab-file', VOCAB, '--batch-size',
          str(SETTINGS['batch_size_per_rank']), '--bin-size',
          str(SETTINGS['bin_size']), '--max-seq-length',
          str(SETTINGS['max_seq_length']), '--masking', SETTINGS['masking'],
          '--shuffle-buffer-size', str(SETTINGS['shuffle_buffer_size']),
          '--base-seed', str(SETTINGS['base_seed'])]


def test_cli_exit_codes(port_run, tmp_path, capsys):
  """batch / bundle / smoke: 0 on a match, 1 on a mismatch (another base
  seed rebuilds another stream; a mismatch refuses to bundle), 2 on
  usage (an unrecorded coordinate, a step coordinate, the ring
  attention the port lacks); step: 2 without a card unless --device cpu
  is given."""
  from lddl_tpu_torch.replay.cli import main
  led = port_run['led']
  argv = _loader_argv()
  assert main(['batch', led, '--key', 'epoch=0,index=4'] + argv) == 0
  assert 'bit-identical' in capsys.readouterr().out
  wrong = [a if a != str(SETTINGS['base_seed']) else '7' for a in argv]
  assert main(['batch', led, '--key', 'epoch=0,index=4'] + wrong) == 1
  assert main(['bundle', led, '--key', 'epoch=0,index=4', '--out',
               str(tmp_path / 'b')] + wrong) == 1
  assert main(['bundle', led, '--key', 'epoch=0,index=4', '--out',
               str(tmp_path / 'b')] + argv) == 0
  assert main(['batch', led, '--key', 'epoch=9,index=0'] + argv) == 2
  assert main(['batch', led, '--key', 'step=8', '--boundary', 'step'] +
              argv) == 2
  assert main(['smoke', led] + argv) == 0
  assert main([]) == 2
  step = ['step', '--checkpoint-dir', port_run['ckpt'], '--step', '16',
          '--bundle', str(tmp_path / 'b'), '--vocab-size', '30528']
  assert main(step + ['--attention', 'ring', '--device', 'cpu']) == 2
  assert main(step + ['--tp', '2', '--device', 'cpu']) == 2
  if not torch.cuda.is_available():
    assert main(step) == 2
    assert 'no CUDA device' in capsys.readouterr().err


def test_cli_step_verdicts(tmp_path, monkeypatch, capsys):
  """A run the pretrain CLI records (ledger on) replays through the replay
  CLI: exit 0 and bit-identical with the recorded run's settings; exit 1,
  MISMATCH, when --learning-rate is not the recorded run's: never a false
  match."""
  from lddl_tpu_torch.replay.cli import main
  from lddl_tpu_torch.training.pretrain import main as pretrain_main
  ckpt = str(tmp_path / 'ckpt')
  common = ['--vocab-file', VOCAB, '--model', 'tiny', '--attention',
            'flash', '--bin-size', str(SETTINGS['bin_size']),
            '--max-seq-length', str(SETTINGS['max_seq_length']),
            '--batch-size', str(SETTINGS['batch_size_per_rank']),
            '--max-predictions', str(PORT_MAX_PREDICTIONS), '--device',
            'cpu']
  monkeypatch.setenv('LDDL_LEDGER', '1')
  monkeypatch.setenv('LDDL_TELEMETRY_DIR', str(tmp_path / 'led'))
  tledger._active = None
  try:
    pretrain_main(['--path', PAIRS, '--steps', '8', '--checkpoint-dir',
                   ckpt, '--checkpoint-every', '4', '--log-every', '0'] +
                  common)
  finally:
    tledger.disable_ledger()
    tledger._active = None
  capsys.readouterr()
  replay = ['step', '--checkpoint-dir', ckpt, '--step', '8', '--ledger',
            str(tmp_path / 'led'), '--path', PAIRS, '--masking', 'dynamic',
            '--seed', '127', '--warmup-steps', '100'] + common
  assert main(replay + ['--total-steps', '8']) == 0
  assert 'reconstructed bit-identical' in capsys.readouterr().out
  assert main(replay + ['--total-steps', '8', '--learning-rate',
                        '2e-4']) == 1
  assert 'MISMATCH' in capsys.readouterr().out
