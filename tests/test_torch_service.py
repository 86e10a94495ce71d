"""The port's network data service against lddl_tpu's serial loader.

Every case of tests/test_service.py, over the committed pairs shards
(tests/assets/torch_shards/pairs, 22 batches of 16 an epoch) instead of
synthetic batches: the port's DataServer serves the port's serial BERT
loader, and what its clients receive must equal, batch for batch, what
lddl_tpu's *serial* loader yields over the same shards (the oracle):

  - the packed batch spec and the frames are the reference's, byte for
    byte (pack_batch, a socketpair each way);
  - one client drains the exact serial sequence, through
    ``MultiprocessLoader(transport='network')`` over two epochs, and from
    mid-epoch;
  - a transient wire fault is retried; a killed server degrades the
    client to the local loader at its exact position, exactly once, and a
    restarted one is re-attached; the fallback run's ledger verifies
    against the healthy one; an injected corruption is named at its
    frame;
  - two lease-claiming clients, one SIGKILLed mid-drain: the union is the
    single-consumer run, with no duplicate;
  - a slow consumer bounds the server's window; stop leaves nothing; a
    SIGKILLed server's announce is provably dead and the monitor lists
    it as such; the serve block of the live verdict;
  - wire interop: the port's client against lddl_tpu's server and
    lddl_tpu's client against the port's server.

Every socket has a deadline (``timeout=``/``LDDL_DATA_TIMEOUT``) and
every process and join a bounded wait, so a fault fails its test instead
of holding the run.
"""

import io
import json
import multiprocessing
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

import lddl_tpu.loader.service as jax_service
from lddl_tpu.loader import get_bert_pretrain_data_loader as jax_bert_loader
from lddl_tpu_torch import telemetry as ttele
from lddl_tpu_torch.core import faults
from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
from lddl_tpu_torch.loader.service import (DataServer, NetworkBatchSource,
                                           ProtocolError, _recv_frame,
                                           _send_frame, discover_data_servers,
                                           pack_batch, resolve_endpoint,
                                           unpack_batch)
from torch_live_procs import digest, read_records, union_client
from torch_threads import torch_one_thread_a_file  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PAIRS = ROOT / 'tests' / 'assets' / 'torch_shards' / 'pairs'
VOCAB = ROOT / 'benchmarks' / 'assets' / 'bench_vocab_30522.txt'
SETTINGS = json.loads((PAIRS.parent / 'digests.json').read_text())[
    'pairs']['settings']
BUILD = dict(path=str(PAIRS), vocab_file=str(VOCAB), **SETTINGS)
FACTORY = ('lddl_tpu_torch.loader.bert', 'get_bert_pretrain_data_loader')
STEPS = 22  # batches an epoch of pairs/ at SETTINGS


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The service makes no shared-memory segment; the shared fixture would
  # count other xdist workers' rings as this test's leak.
  yield


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
  """Telemetry off, no fault spec, no endpoint: each test sets its own."""
  for k in ('LDDL_FAULTS', 'LDDL_DATA_SERVER', 'LDDL_MONITOR_DIR',
            'LDDL_TELEMETRY_DIR', 'LDDL_LOADER_TRANSPORT'):
    monkeypatch.delenv(k, raising=False)
  faults.reset()
  ttele.disable()
  yield
  faults.reset()
  ttele.disable()


@pytest.fixture(scope='module')
def reference():
  """Two epochs of lddl_tpu's serial loader: ``[[digest] * 22] * 2``."""
  loader = jax_bert_loader(**BUILD)
  return [[digest(b) for b in loader] for _ in range(2)]


def _loader():
  return get_bert_pretrain_data_loader(**BUILD)


def _source(**kw):
  """A client that can fall back to the port's serial loader."""
  return NetworkBatchSource(build_kwargs=BUILD, factory=FACTORY, **kw)


def _first_batch():
  return next(_loader().iter_steps((0, 1)))[1]


# ---------------------------------------------------------------------------
# wire + spec round trips


def test_pack_roundtrip_byte_identical():
  batch = _first_batch()
  spec, payload = pack_batch(batch)
  # The reference packs the same batch into the same spec and bytes.
  assert (spec, payload) == jax_service.pack_batch(batch)
  out = unpack_batch(spec, payload)
  assert sorted(out) == sorted(batch)
  for k in batch:
    assert np.array_equal(out[k], batch[k])
    assert out[k].dtype == batch[k].dtype


_FRAMES = {'port': (_send_frame, _recv_frame),
           'jax': (jax_service._send_frame, jax_service._recv_frame)}


@pytest.mark.parametrize('sender,receiver', [
    ('port', 'port'), ('port', 'jax'), ('jax', 'port')])
def test_frame_roundtrip_over_socketpair(sender, receiver):
  a, b = socket.socketpair()
  a.settimeout(5)
  b.settimeout(5)
  try:
    _FRAMES[sender][0](a, {'op': 'batch', 'gi': 3}, b'payload-bytes')
    header, body = _FRAMES[receiver][1](b)
    assert header == {'op': 'batch', 'gi': 3}
    assert bytes(body) == b'payload-bytes'
  finally:
    a.close()
    b.close()


def test_frame_bad_magic_is_protocol_error():
  a, b = socket.socketpair()
  a.settimeout(5)
  b.settimeout(5)
  try:
    a.sendall(b'HTTP/1.1 200 OK\r\n' + b'\x00' * 16)
    with pytest.raises(ProtocolError):
      _recv_frame(b)
  finally:
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# healthy-path drains


def test_single_client_drains_exact_serial_sequence(monkeypatch, reference):
  srv = DataServer(_loader(), window=3, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  try:
    got = list(NetworkBatchSource(timeout=10, retries=1).iter_steps(0))
  finally:
    srv.stop()
  assert [gi for gi, _ in got] == list(range(STEPS))
  assert [digest(b) for _, b in got] == reference[0]


def test_multiprocess_loader_network_transport(monkeypatch, reference):
  """The loader factory a user calls, with ``transport='network'``: no
  worker starts, the epoch comes off the wire and bumps like the process
  transports', and the next epoch is the serial loader's next epoch."""
  from lddl_tpu_torch.loader import MultiprocessLoader
  srv = DataServer(_loader(), window=4, epochs=2).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  loader = get_bert_pretrain_data_loader(**BUILD, num_workers=2,
                                         transport='network')
  assert isinstance(loader, MultiprocessLoader)
  try:
    e0 = [digest(b) for b in loader]
    assert loader.epoch == 1
    e1 = [digest(b) for b in loader]
  finally:
    srv.stop()
  assert [e0, e1] == reference
  assert not [t for t in threading.enumerate()
              if t.name.startswith('lddl-lease-hb')]


def test_network_transport_resumes_mid_epoch(monkeypatch, reference):
  """The serial loader's position steers the network drain exactly like
  it steers the process transports (``seek``, the restore path); the
  served batches are the uninterrupted epoch's from that index on."""
  from lddl_tpu_torch.loader import MultiprocessLoader
  srv = DataServer(_loader(), window=STEPS, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  loader = MultiprocessLoader(BUILD, num_workers=0, transport='network',
                              factory=FACTORY)
  loader.seek(0, 5)
  try:
    got = [digest(b) for b in loader]
  finally:
    srv.stop()
  assert got == reference[0][5:]


def test_retry_absorbs_transient_wire_fault(monkeypatch, reference):
  """A raise-spec on ``wire.write`` breaks the first frame send; the
  bounded-backoff retry reconnects and the drain still delivers the
  exact sequence."""
  srv = DataServer(_loader(), window=4, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  monkeypatch.setenv('LDDL_FAULTS', 'raise:wire.write:nth=1')
  faults.reset()
  try:
    got = list(NetworkBatchSource(timeout=10, retries=2).iter_steps(0))
  finally:
    monkeypatch.delenv('LDDL_FAULTS')
    faults.reset()
    srv.stop()
  assert [digest(b) for _, b in got] == reference[0]


# ---------------------------------------------------------------------------
# server death: degraded-mode fallback + re-attach


def test_server_death_falls_back_to_local_mid_epoch(monkeypatch, reference):
  tele = ttele.enable()
  srv = DataServer(_loader(), window=8, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  it = _source(timeout=2, retries=1).iter_steps(0)
  got = [next(it) for _ in range(3)]
  srv.stop()  # server dies mid-epoch
  got.extend(it)
  assert [gi for gi, _ in got] == list(range(STEPS))
  assert [digest(b) for _, b in got] == reference[0]
  assert tele.counter('serve.fallbacks').total == 1
  assert tele.counter('serve.batches_served').total == 3


def test_client_reattaches_when_server_returns(monkeypatch, reference):
  tele = ttele.enable()
  monkeypatch.setenv('LDDL_DATA_REATTACH_EVERY', '2')
  srv1 = DataServer(_loader(), window=STEPS, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv1.url)
  it = _source(timeout=2, retries=0).iter_steps(0)
  got = [next(it) for _ in range(3)]
  srv1.stop()
  # Degraded: the next pulls come from the local loader...
  got.append(next(it))
  # ...then a new server answers and the probe re-attaches to it. Its
  # window holds the whole epoch: it starts at batch 0, and the batches
  # below the client's position are never asked for again.
  srv2 = DataServer(_loader(), window=STEPS, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv2.url)
  try:
    got.extend(it)
  finally:
    srv2.stop()
  assert [gi for gi, _ in got] == list(range(STEPS))
  assert [digest(b) for _, b in got] == reference[0]
  assert tele.counter('serve.fallbacks').total == 1
  assert tele.counter('serve.reattaches').total == 1
  # Re-attached after 2 local batches: 3 + 2 local + the rest served.
  assert tele.counter('serve.batches_served').total == STEPS - 2


def test_a_server_that_only_waits_degrades_past_the_timeout(
    monkeypatch, reference):
  """The port bounds the reference's 'wait' poll by the data timeout: a
  server whose window is full of batches below the client's position
  (never acked, never asked for) costs one degrade, not a hang."""
  tele = ttele.enable()
  monkeypatch.setenv('LDDL_DATA_REATTACH_EVERY', '0')
  srv = DataServer(_loader(), window=2, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  try:
    got = list(_source(timeout=0.5, retries=0).iter_steps(0, first_step=5))
  finally:
    srv.stop()
  assert [gi for gi, _ in got] == list(range(5, STEPS))
  assert [digest(b) for _, b in got] == reference[0][5:]
  assert tele.counter('serve.fallbacks').total == 1
  assert tele.counter('serve.batches_served').total == 0


# ---------------------------------------------------------------------------
# determinism ledger on the service path: tx/rx fingerprints + audit


def _with_ledger(directory, fn):
  import lddl_tpu_torch.telemetry.ledger as ledger_mod
  ledger_mod._active = None
  ledger_mod.enable_ledger(directory=str(directory), rank=0)
  try:
    return fn()
  finally:
    ledger_mod.disable_ledger()


def test_fallback_run_ledger_verifies_against_healthy_reference(
    monkeypatch, tmp_path, reference):
  """A run that lost its server mid-epoch recorded serve.tx/rx only for
  the frames actually served — a strict subset of the healthy run's,
  every common coordinate byte-identical — so the port's auditor
  verifies the recovery (exit 0)."""
  from lddl_tpu_torch.telemetry import audit

  def drain(dirname, stop_after=None):
    def go():
      srv = DataServer(_loader(), window=8, epochs=1).start()
      monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
      it = _source(timeout=2, retries=1).iter_steps(0)
      if stop_after is None:
        got = list(it)
        srv.stop()
        return got
      got = [next(it) for _ in range(stop_after)]
      srv.stop()  # the client degrades locally
      got.extend(it)
      return got
    return _with_ledger(tmp_path / dirname, go)

  ref = drain('ref')
  faulted = drain('run', stop_after=3)
  for got in (ref, faulted):
    assert [gi for gi, _ in got] == list(range(STEPS))
    assert [digest(b) for _, b in got] == reference[0]

  assert audit.main(['verify', str(tmp_path / 'run'),
                     str(tmp_path / 'ref')]) == 0
  run = audit.load_run(str(tmp_path / 'run'))
  indexed = audit.index_records(run[0])[0]
  ref_rx = audit.index_records(
      audit.load_run(str(tmp_path / 'ref'))[0])[0]['serve.rx']
  assert len(ref_rx) == STEPS
  assert len(indexed['serve.rx']) == 3
  assert not audit.wire_mismatches(run)


def test_injected_wire_corruption_caught_with_exact_frame(
    monkeypatch, tmp_path, capsys, reference):
  """``corrupt:ledger.corrupt`` flips one byte of the third packed frame
  after the server hashed it: the client consumes damaged bytes, and the
  audit names the exact frame from one run's ledger."""
  from lddl_tpu_torch.telemetry import audit

  def go():
    monkeypatch.setenv('LDDL_FAULTS', 'corrupt:ledger.corrupt:nth=3')
    faults.reset()
    srv = DataServer(_loader(), window=6, epochs=1).start()
    monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
    try:
      return list(NetworkBatchSource(timeout=10, retries=1).iter_steps(0))
    finally:
      srv.stop()
      monkeypatch.delenv('LDDL_FAULTS')
      faults.reset()
  got = _with_ledger(tmp_path / 'run', go)

  digs = [digest(b) for _, b in got]
  assert digs[2] != reference[0][2]
  assert digs[:2] + digs[3:] == reference[0][:2] + reference[0][3:]

  run_dir = str(tmp_path / 'run')
  mismatches = audit.wire_mismatches(audit.load_run(run_dir))
  assert [m['key'] for m in mismatches] == [{'epoch': 0, 'gi': 2}]
  assert audit.main(['diff', run_dir, run_dir]) == 1
  out = capsys.readouterr().out
  assert 'wire' in out and 'gi=2' in out
  assert audit.main(['show', run_dir]) == 0
  assert 'wire mismatch' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# two clients, one SIGKILLed: lease re-serve + union byte-identity


@pytest.mark.parametrize('kill_spec', [None, 'kill:client.pull:nth=3'])
def test_two_client_union_byte_identity(tmp_path, kill_spec, reference):
  """Two lease-claiming clients drain one serve stream, consuming a batch
  every 20 ms. Healthy: the claim split is disjoint and the union is the
  single-consumer run. With client 1 SIGKILLed before its 3rd pull: the
  survivor revokes its unmanifested lease on positive pid death and the
  union is still the single-consumer run, no batch lost or duplicated.

  The order is pinned, not raced: the server's window is full before
  the clients start, and client 0 starts once client 1 has delivered one
  batch (healthy) or two (killed), so client 1 surely reaches its 3rd
  pull — a client 0 that drained the epoch first would leave the kill
  untested."""
  from lddl_tpu_torch.comm.backend import FileLeaseStore
  run_id = 'svc'
  rdv = str(tmp_path / 'rdv')
  store = FileLeaseStore(os.path.join(rdv, f'{run_id}.elastic.serve'),
                         rank=-1)
  srv = DataServer(_loader(), window=4, epochs=1, lease_store=store).start()
  for _ in range(500):
    if _stat(srv.url)['backlog'] == 4:
      break
    time.sleep(0.01)
  ctx = multiprocessing.get_context('spawn')
  outs = [str(tmp_path / f'client{r}.jsonl') for r in range(2)]
  gate = (outs[1], 2 if kill_spec else 1)
  procs = [
      ctx.Process(target=union_client,
                  args=(0, rdv, run_id, srv.url, outs[0], None, gate, 0.02)),
      ctx.Process(target=union_client,
                  args=(1, rdv, run_id, srv.url, outs[1], kill_spec, None,
                        0.02)),
  ]
  try:
    for p in procs:
      p.start()
    deadline = time.monotonic() + 90
    for p in procs:
      p.join(timeout=max(1.0, deadline - time.monotonic()))
      assert p.exitcode is not None, 'client did not finish in time'
  finally:
    for p in procs:
      if p.is_alive():
        p.kill()
        p.join(timeout=10)
    srv.stop()
  assert procs[0].exitcode == 0
  assert procs[1].exitcode == (-signal.SIGKILL if kill_spec else 0)
  recs = [read_records(o) for o in outs]
  overlap = set(recs[0]) & set(recs[1])
  assert not overlap, f'both clients delivered {sorted(overlap)}'
  union = {**recs[0], **recs[1]}
  assert union == dict(enumerate(reference[0]))
  if kill_spec:
    # The survivor picked up the dead client's share, its claimed batch
    # included.
    assert sorted(recs[1]) == [0, 1] and len(recs[0]) == STEPS - 2


# ---------------------------------------------------------------------------
# backpressure: slow consumer bounds server memory


def _stat(url, timeout=5.0):
  host, _, port = url.rpartition(':')
  with socket.create_connection((host, int(port)), timeout=timeout) as s:
    s.settimeout(timeout)
    _send_frame(s, {'op': 'hello'})
    _recv_frame(s)
    _send_frame(s, {'op': 'stat'})
    header, _ = _recv_frame(s)
  return header


def test_slow_consumer_backpressure_bounds_window(monkeypatch):
  window = 2
  srv = DataServer(_loader(), window=window, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  it = NetworkBatchSource(timeout=10, retries=1).iter_steps(0)
  try:
    for pulled in range(4):
      next(it)
      time.sleep(0.15)  # let the producer run as far ahead as it can
      stat = _stat(srv.url)
      assert stat['backlog'] <= window, (
          f'after {pulled + 1} pulls the server buffered '
          f'{stat["backlog"]} batches (window {window})')
    rest = list(it)
  finally:
    srv.stop()
  assert 4 + len(rest) == STEPS


# ---------------------------------------------------------------------------
# lifecycle hygiene: clean stop, SIGKILL, discovery, monitor folding


def _serve_threads():
  return [t.name for t in threading.enumerate()
          if t.name.startswith('lddl-serve')]


def test_stop_leaves_no_threads_sockets_or_announce(tmp_path):
  announce_dir = str(tmp_path / 'mon')
  srv = DataServer(_loader(), window=4, epochs=1,
                   announce_dir=announce_dir).start()
  url = srv.url
  found = discover_data_servers(announce_dir)
  assert [i['url'] for i in found] == [url]
  assert not found[0]['dead']
  assert resolve_endpoint(announce_dir=announce_dir) is not None
  srv.stop()
  assert _serve_threads() == []
  assert discover_data_servers(announce_dir) == []
  host, _, port = url.rpartition(':')
  with pytest.raises(OSError):
    socket.create_connection((host, int(port)), timeout=1.0).close()
  srv.stop()  # idempotent


def test_sigkilled_server_announce_is_provably_dead(tmp_path):
  """``python -m lddl_tpu_torch.loader.service`` over the shards: it
  announces, loads no torch (so it cannot hold a CUDA context), and once
  SIGKILLed its stale announce is proven dead — not a resolvable
  endpoint, and a fleet error in the monitor's JSON — until a server
  that takes its place removes it."""
  announce_dir = str(tmp_path / 'mon')
  env = dict(os.environ, LDDL_MONITOR_DIR=announce_dir,
             PYTHONPATH=str(ROOT))
  proc = subprocess.Popen(
      [sys.executable, '-m', 'lddl_tpu_torch.loader.service',
       '--path', str(PAIRS), '--vocab-file', str(VOCAB),
       '--batch-size', '16', '--bin-size', '128', '--window', '64'],
      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
  try:
    deadline = time.monotonic() + 60
    live = []
    while time.monotonic() < deadline:
      live = discover_data_servers(announce_dir)
      if live:
        break
      assert proc.poll() is None, proc.stdout.read().decode()
      time.sleep(0.1)
    assert live and not live[0]['dead']
    assert live[0]['pid'] == proc.pid
    with open(f'/proc/{proc.pid}/maps') as f:
      assert 'libtorch' not in f.read()
    proc.kill()  # SIGKILL: no teardown, the announce file stays behind
    proc.wait(timeout=30)
    found = discover_data_servers(announce_dir)
    assert found and found[0]['dead']
    assert resolve_endpoint(announce_dir=announce_dir) is None
    from lddl_tpu_torch.telemetry.monitor import main as monitor_main
    buf = io.StringIO()
    with redirect_stdout(buf):
      rc = monitor_main(['--dir', announce_dir, '--once', '--json'])
    assert rc == 1  # no live rank either
    payload = json.loads(buf.getvalue())
    assert any('data server' in err and 'dead' in err
               for err in payload['errors'].values())
    assert payload['data_servers'][0]['dead']
    # A server that takes its place removes the provably dead announce.
    srv = DataServer(_loader(), window=4, epochs=1,
                     announce_dir=announce_dir).start()
    try:
      assert [i['pid'] for i in discover_data_servers(announce_dir)] == [
          os.getpid()]
    finally:
      srv.stop()
    assert os.listdir(announce_dir) == []
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.wait(timeout=30)
    proc.stdout.close()


# ---------------------------------------------------------------------------
# telemetry: the serve verdict block


def test_serve_block_in_live_verdict(monkeypatch):
  from lddl_tpu_torch.telemetry.live import SnapshotWindow, live_verdict
  ttele.enable()
  window = SnapshotWindow()
  window.sample()
  srv = DataServer(_loader(), window=5, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  try:
    got = list(NetworkBatchSource(timeout=10, retries=1).iter_steps(0))
  finally:
    srv.stop()
  assert len(got) == STEPS
  window.sample()
  serve = live_verdict(window)['serve']
  assert serve is not None
  assert serve['batches_served'] == STEPS
  assert serve['client_pulls'] >= STEPS
  assert serve['reserves'] == 0
  # A registry with no serve activity keeps the dashboard quiet.
  fresh = ttele.Telemetry()
  quiet = SnapshotWindow()
  fresh.counter('train.steps').add(1)
  quiet.sample(telemetry=fresh)
  fresh.counter('train.steps').add(1)
  quiet.sample(telemetry=fresh)
  assert live_verdict(quiet)['serve'] is None


# ---------------------------------------------------------------------------
# wire interop: one client each way


@pytest.mark.parametrize('server,client', [('jax', 'port'), ('port', 'jax')])
def test_wire_interop(monkeypatch, reference, server, client):
  """Either package's client drains either package's server: the port
  speaks the reference's protocol frame for frame."""
  servers = {'port': DataServer, 'jax': jax_service.DataServer}
  clients = {'port': NetworkBatchSource,
             'jax': jax_service.NetworkBatchSource}
  srv = servers[server](_loader(), window=4, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  try:
    got = list(clients[client](timeout=10, retries=1).iter_steps(0))
  finally:
    srv.stop()
  assert [gi for gi, _ in got] == list(range(STEPS))
  assert [digest(b) for _, b in got] == reference[0]


def test_synthetic_loader_serves_the_references_batches(monkeypatch):
  """``--synthetic``'s loader (``lddl_tpu_torch.testing``) yields
  ``lddl_tpu.testing``'s batches, from the start and after a seek, and
  serves them over the wire."""
  from lddl_tpu.testing import SyntheticBatchLoader as JaxSynthetic
  from lddl_tpu_torch.testing import SyntheticBatchLoader
  kw = dict(batch_size=4, seq_len=16, steps=6)
  want = [digest(b) for _, b in JaxSynthetic(**kw).iter_steps((0, 1))]
  port = SyntheticBatchLoader(**kw)
  assert [digest(b) for b in port] == want and port.epoch == 1
  assert [digest(b) for _, b in port.seek(0, 4).iter_steps((0, 1))] == \
      want[4:]
  srv = DataServer(SyntheticBatchLoader(**kw), window=6, epochs=1).start()
  monkeypatch.setenv('LDDL_DATA_SERVER', srv.url)
  try:
    got = list(NetworkBatchSource(timeout=10, retries=1).iter_steps(0))
  finally:
    srv.stop()
  assert [digest(b) for _, b in got] == want
