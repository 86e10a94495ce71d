"""The port's flight recorder (lddl_tpu_torch.training.flight) against
lddl_tpu's, on the CPU. (The incidents of one run recorded by both
packages are compared in test_torch_replay.py, beside that run's other
checks.)

- The pretrain CLI records an incident that the incident CLI replays in
  full (``replay <dir> -- <step args>``).
- The incident cap, the ``flight.dump`` fault (raise: no incident, the
  run goes on; corrupt: both packages' readers refuse the bundle), the
  gate, the tee on the feed's producer thread, the sentinel's incident
  registry and the monitor's panel, the CLI's exit codes.

Batches and digests compare exactly.
"""

import json
import os
import shutil

import numpy as np
import pytest

from lddl_tpu_torch.core import faults as tfaults
from lddl_tpu_torch.replay import ReplayMismatch, read_bundle
from lddl_tpu_torch.telemetry import ledger as tledger
from lddl_tpu_torch.telemetry import sentinel as tsentinel
from lddl_tpu_torch.testing import SyntheticBatchLoader
from lddl_tpu_torch.training import flight

from test_torch_replay import PAIRS, PORT_MAX_PREDICTIONS, SETTINGS, VOCAB


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port's serial loaders and the recorder make no shm segment; the
  # shared fixture would count other xdist workers' lddl_ segments.
  yield


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
  yield
  tledger.disable_ledger()
  tledger._active = None
  tsentinel.disable_sentinel()
  flight.disable_flight()
  tfaults.reset()


def _trigger(step, detector='loss_spike'):
  return {'detector': detector, 'step': step, 'reason': 'a test trigger',
          'value': None}


def _fed_recorder(tmp_path, n=6, **kw):
  """A recorder whose ring holds ``n`` synthetic batches, teed from a
  loader that publishes ``coordinate_of_batch``."""
  rec = flight.FlightRecorder(out_dir=str(tmp_path / 'inc'), **kw)
  loader = SyntheticBatchLoader(batch_size=2, seq_len=8, steps=4)
  batches = list(rec.wrap_host_stream(iter(loader), loader, ordinal0=0))
  rec.note_checkpoint(str(tmp_path / 'ck'), 2)
  for s in range(n):
    rec.record_step(s, loss=1.0 + s, grad_norm=None, data_wait=0.01)
  return rec, batches


# ---------------------------------------------------------------------------
# a run the pretrain CLI records


def test_the_incident_cli_replays_a_cli_run(tmp_path, monkeypatch, capsys):
  """The pretrain CLI with the ledger, the sentinel and an injected
  trigger at step 3: one incident, printed; ``replay <dir>`` checks the
  suspect bundle, ``replay <dir> -- <step args>`` re-executes step 4 from
  checkpoint 2 over the ring's two bundles bit for bit; ``show`` and
  ``list`` name it; ``bisect`` runs over the ring's window."""
  from lddl_tpu_torch.training.pretrain import main as pretrain_main
  ckpt, led, inc = (str(tmp_path / k) for k in ('ckpt', 'led', 'inc'))
  model = ['--vocab-file', VOCAB, '--model', 'tiny', '--attention', 'flash',
           '--bin-size', str(SETTINGS['bin_size']), '--max-seq-length',
           str(SETTINGS['max_seq_length']), '--batch-size',
           str(SETTINGS['batch_size_per_rank']), '--max-predictions',
           str(PORT_MAX_PREDICTIONS), '--device', 'cpu']
  for k, v in (('LDDL_LEDGER', '1'), ('LDDL_TELEMETRY_DIR', led),
               ('LDDL_SENTINEL', '1'), ('LDDL_FLIGHT_DIR', inc),
               ('LDDL_FAULTS', 'raise:sentinel.trigger:nth=4')):
    monkeypatch.setenv(k, v)
  tledger._active = tsentinel._active = flight._active = None
  tfaults.reset()
  try:
    pretrain_main(['--path', PAIRS, '--steps', '6', '--checkpoint-dir', ckpt,
                   '--checkpoint-every', '2', '--log-every', '0'] + model)
  finally:
    tledger.disable_ledger()
    for k in ('LDDL_LEDGER', 'LDDL_SENTINEL', 'LDDL_FAULTS'):
      monkeypatch.delenv(k)
    tfaults.reset()
  assert 'incident captured' in capsys.readouterr().out
  (found,) = flight.scan_incidents(inc)
  man = found['manifest']
  assert (man['step'], man['replay_step']) == (3, 4)
  assert man['checkpoint'] == {'dir': os.path.abspath(ckpt), 'step': 2}
  assert flight.main(['replay', found['dir']]) == 0
  assert 'bundle ok: epoch=0, index=3' in capsys.readouterr().out
  step = ['--checkpoint-dir', ckpt, '--step', '4', '--ledger', led,
          '--masking', 'dynamic', '--seed', '127', '--total-steps', '6',
          '--vocab-size', '30528'] + model
  assert flight.main(['replay', found['dir'], '--'] + step) == 0
  out = capsys.readouterr().out
  assert '(step=4) reconstructed bit-identical' in out
  assert flight.main(['show', found['dir']]) == 0
  out = capsys.readouterr().out
  assert '<- suspect' in out and '--bundle' in out and '--step 4' in out
  assert flight.main(['list', '--root', inc]) == 0
  assert found['dir'] in capsys.readouterr().out
  assert flight.main(['bisect', found['dir'], '--', '--path', PAIRS,
                      '--masking', 'dynamic', '--seed', '127',
                      '--total-steps', '6'] + model) == 0
  assert 'spike at step' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the recorder alone


def test_cap_and_dump_faults(tmp_path, monkeypatch, capsys):
  """Past max_incidents a trigger is counted, not captured; a raise on
  flight.dump leaves no incident and raises nothing; a corrupt on
  flight.dump writes an incident whose damaged bundle both packages'
  readers, and the incident CLI, refuse."""
  from lddl_tpu.core import faults as jfaults
  from lddl_tpu.replay import ReplayMismatch as JaxMismatch
  from lddl_tpu.replay import read_bundle as jax_read
  rec, _ = _fed_recorder(tmp_path, max_incidents=1)
  monkeypatch.setenv('LDDL_FAULTS', 'raise:flight.dump')
  tfaults.reset()
  assert rec.capture(_trigger(3)) is None
  assert 'incident capture failed' in capsys.readouterr().err
  assert rec.incident_dirs == [] and not os.path.exists(rec.out_dir)
  monkeypatch.setenv('LDDL_FAULTS', 'corrupt:flight.dump:nth=2')
  tfaults.reset()
  path = rec.capture(_trigger(3))
  assert path and rec.incident_dirs == [path]
  man = json.load(open(os.path.join(path, flight.MANIFEST)))
  ring = man['ring']
  assert [e['ordinal'] for e in ring] == [0, 1, 2, 3]
  monkeypatch.delenv('LDDL_FAULTS')
  tfaults.reset()
  jfaults.reset()
  for i, e in enumerate(ring):
    bdir = os.path.join(path, e['bundle'])
    if i == 1:  # the second bundle written took the flipped byte
      with pytest.raises(ReplayMismatch, match='corrupt'):
        read_bundle(bdir)
      with pytest.raises(JaxMismatch, match='corrupt'):
        jax_read(bdir)
    else:
      assert read_bundle(bdir)[0]['digest'] == e['digest']
  # The suspect (ordinal 3) reads; a copy whose suspect is the damaged
  # one is refused by the CLI with exit 1.
  assert flight.main(['replay', path]) == 0
  bad = str(tmp_path / 'bad')
  shutil.copytree(path, bad)
  man['suspect'] = ring[1]
  with open(os.path.join(bad, flight.MANIFEST), 'w') as f:
    json.dump(man, f)
  assert flight.main(['replay', bad]) == 1
  capsys.readouterr()
  assert rec.capture(_trigger(5)) is None  # the cap: one incident
  assert 'incident cap (1) reached' in capsys.readouterr().err
  assert len(rec.incident_dirs) == 1


def test_manifest_keys_and_suspect_match_lddl_tpu(tmp_path):
  """One ring, frozen by both packages' recorders: the same manifest keys,
  ring, suspect and digests; a trigger without a step takes the newest
  batch as its suspect in both."""
  from lddl_tpu.training import flight as jflight
  loader = SyntheticBatchLoader(batch_size=2, seq_len=8, steps=4)
  got = {}
  for name, mod in (('port', flight), ('lddl_tpu', jflight)):
    rec = mod.FlightRecorder(out_dir=str(tmp_path / name), capacity=4)
    list(rec.wrap_host_stream(iter(loader), loader, ordinal0=6))
    loader.seek(0, 0)
    rec.note_checkpoint(str(tmp_path / 'ck'), 6)
    rec.record_step(7, loss=2.0, grad_norm=0.5)
    got[name] = [json.load(open(os.path.join(rec.capture(t),
                                             mod.MANIFEST)))
                 for t in (_trigger(8), _trigger(None, 'serve_backlog'))]
  for mine, theirs in zip(got['port'], got['lddl_tpu']):
    assert sorted(mine) == sorted(theirs)
    for k in ('step', 'replay_step', 'ring', 'suspect', 'metrics',
              'checkpoint'):
      assert mine[k] == theirs[k], k
  assert got['port'][0]['suspect']['coordinate'] == {'epoch': 2, 'index': 0}
  assert got['port'][1]['suspect']['ordinal'] == 9


def test_gate_rides_the_sentinel(monkeypatch, tmp_path):
  """No sentinel, no recorder: the no-op passes the iterator through.
  LDDL_FLIGHT_DIR / LDDL_FLIGHT_RING / LDDL_FLIGHT_PROFILE_STEPS set the
  live recorder."""
  monkeypatch.delenv('LDDL_SENTINEL', raising=False)
  tsentinel._active = flight._active = None
  rec = flight.get_flight_recorder()
  assert rec is flight.NOOP_FLIGHT and not rec.enabled
  it = iter([1, 2])
  assert rec.wrap_host_stream(it) is it
  assert rec.capture(_trigger(1)) is None
  monkeypatch.setenv('LDDL_SENTINEL', '1')
  monkeypatch.setenv('LDDL_FLIGHT_DIR', str(tmp_path / 'x'))
  monkeypatch.setenv('LDDL_FLIGHT_RING', '3')
  monkeypatch.setenv('LDDL_FLIGHT_PROFILE_STEPS', '2')
  tsentinel._active = flight._active = None
  rec = flight.get_flight_recorder()
  assert isinstance(rec, flight.FlightRecorder)
  assert (rec.out_dir, rec.capacity, rec.metrics_window,
          rec.profile_steps) == (str(tmp_path / 'x'), 3, 12, 2)


def test_tee_on_the_feed_thread(tmp_path):
  """Under prefetch_to_device the tee runs on the producer thread: the
  ring keeps the newest ``capacity`` batches with their coordinates, the
  batches pass through unchanged, and closing the feed closes the
  source."""
  from lddl_tpu_torch.loader.device import prefetch_to_device
  loader = SyntheticBatchLoader(batch_size=2, seq_len=8, steps=5)
  closed = []

  def source():
    try:
      yield from loader
    finally:
      closed.append(True)

  rec = flight.FlightRecorder(out_dir=str(tmp_path), capacity=3)
  stream = prefetch_to_device(rec.wrap_host_stream(source(), loader,
                                                   ordinal0=10), 'cpu')
  got = [next(stream) for _ in range(2)]
  stream.close()
  assert closed == [True]
  assert [int(b['input_ids'][0, 0]) for b in got] == [0, 1]
  ring = rec._ring
  assert 1 <= len(ring) <= 3
  for e in ring:
    assert (e['epoch'], e['index']) == loader.coordinate_of_batch(
        e['ordinal'])
  assert ring[0]['ordinal'] >= 10


def test_sentinel_status_and_the_monitor_panel(tmp_path):
  """The recorder registers each incident with the sentinel:
  sentinel_status and live_status list it, and the monitor's INCIDENT
  panel names it with the port's CLI."""
  from lddl_tpu_torch.telemetry.live import SnapshotWindow, live_status
  from lddl_tpu_torch.telemetry.monitor import render_frame
  sent = tsentinel.enable_sentinel(detectors=('nonfinite_loss',))
  trigger = sent.observe_step(4, loss=float('nan'))
  rec, _ = _fed_recorder(tmp_path)
  path = rec.capture(trigger)
  status = tsentinel.sentinel_status()
  assert [(i['dir'], i['detector'], i['step']) for i in
          status['incidents']] == [(path, 'nonfinite_loss', 4)]
  snap = live_status(SnapshotWindow())
  assert snap['sentinel']['incidents'][0]['dir'] == path
  frame = render_frame({'ranks': {0: snap}, 'errors': {},
                        'straggler': None, 'verdicts': {},
                        'determinism': None,
                        'sentinel': {0: snap['sentinel']}}, clear=False)
  assert '!! INCIDENT' in frame
  assert f'python -m lddl_tpu_torch.training.flight show {path}' in frame
  for _ in range(tsentinel.MAX_INCIDENT_NOTES + 2):
    sent.note_incident(path, trigger)
  assert len(sent.status()['incidents']) == tsentinel.MAX_INCIDENT_NOTES


def test_scan_incidents_matches_lddl_tpu(tmp_path):
  """The inventory of a tree: incidents at any depth in path order, an
  unreadable manifest reported, an incident's bundles never counted."""
  from lddl_tpu.training.flight import scan_incidents as jax_scan
  rec, _ = _fed_recorder(tmp_path)
  first = rec.capture(_trigger(2))
  second = rec.capture(_trigger(2))
  assert second.endswith('-2')
  torn = tmp_path / 'inc' / 'deeper' / 'incident-torn'
  torn.mkdir(parents=True)
  (torn / flight.MANIFEST).write_text('{"step": ')
  mine = flight.scan_incidents(tmp_path / 'inc')
  theirs = jax_scan(tmp_path / 'inc')
  assert [(i['dir'], i['manifest'], 'error' in i) for i in mine] == [
      (i['dir'], i['manifest'], 'error' in i) for i in theirs]
  assert [i['dir'] for i in mine] == sorted([first, second, str(torn)])
  assert flight.scan_incidents(tmp_path / 'nothing') == []
  cmd = flight.replay_command(first, mine[1]['manifest'])
  assert cmd.startswith('python -m lddl_tpu_torch.replay.cli step --bundle')
  assert cmd.endswith(f'--checkpoint-dir {tmp_path / "ck"} --step 3')


def test_cli_exit_codes(tmp_path, capsys):
  """list 0 (also over nothing); show / replay / bisect 2 for a directory
  that is no incident; bisect 2 for an incident without a checkpoint."""
  assert flight.main(['list', '--root', str(tmp_path / 'none')]) == 0
  assert 'no incidents' in capsys.readouterr().out
  for cmd in ('show', 'replay', 'bisect'):
    assert flight.main([cmd, str(tmp_path)]) == 2
  rec = flight.FlightRecorder(out_dir=str(tmp_path / 'inc'))
  loader = SyntheticBatchLoader(batch_size=2, seq_len=8, steps=4)
  list(rec.wrap_host_stream(iter(loader), loader))
  path = rec.capture(_trigger(1))
  assert flight.main(['bisect', path]) == 2
  assert 'no checkpoint ref' in capsys.readouterr().err
  assert flight.main(['show', path]) == 0
  with pytest.raises(SystemExit):
    flight.main([])


def test_capture_arms_the_step_profiler(tmp_path, monkeypatch):
  """LDDL_FLIGHT_PROFILE_STEPS arms the port's StepProfiler at capture;
  the manifest says so."""
  from lddl_tpu_torch.telemetry import profiling
  profiling._reset_for_tests()
  rec, _ = _fed_recorder(tmp_path, profile_steps=2)
  man = json.load(open(os.path.join(rec.capture(_trigger(1)),
                                    flight.MANIFEST)))
  assert man['profile'] == {'armed_steps': 2}
  assert profiling.get_step_profiler().armed
  profiling._reset_for_tests()
  assert np.isfinite(man['metrics'][-1]['loss'])
