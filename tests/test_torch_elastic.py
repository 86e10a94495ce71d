"""Rank membership, the fleet report and the ledger's fleet verdict of
lddl_tpu_torch vs lddl_tpu, on the CPU.

- ``telemetry.live.straggler_scores`` and ``telemetry.report``'s merge,
  stage summary and rendering equal lddl_tpu's on the same inputs; the
  merge over a comm backend (``aggregate_over_comm``,
  ``export_telemetry(comm)``) equals merging the files offline.
- ``telemetry.ledger.divergence_over_comm`` over two ranks gives
  lddl_tpu's ``compare_signals`` verdict.
- The membership primitives of tests/test_faults.py
  (``TestTrainMembershipPrimitives``: a heartbeat fault absorbed, the
  shed verdict's CAS), and its ``TestTrainRankDeath`` on the port: two
  ``--comm file`` ranks over the committed pairs shards, one SIGKILLed
  mid-run; the survivor checkpoints, stops with its dead-rank reason and
  resumes at world size 1.
"""

import contextlib
import io
import json
import math
import os
import signal
import threading
import time

import pytest

import torch_dist_ranks as ranks
from lddl_tpu.telemetry import ledger as jledger
from lddl_tpu.telemetry import live as jlive
from lddl_tpu.telemetry import report as jreport
from lddl_tpu_torch import telemetry as ttele
from lddl_tpu_torch.comm import FileBackend, HeartbeatPump
from lddl_tpu_torch.core import faults
from lddl_tpu_torch.telemetry import ledger as tledger
from lddl_tpu_torch.telemetry import live as tlive
from lddl_tpu_torch.telemetry import report as treport
from lddl_tpu_torch.training import TrainLoop, export_telemetry
from lddl_tpu_torch.training.elastic import (RankMembership,
                                             elastic_train_enabled,
                                             maybe_membership,
                                             shed_threshold)
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = os.path.join(ROOT, 'tests', 'assets', 'torch_shards', 'pairs')
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')


@pytest.mark.parametrize('signals', [
    {0: {'steps_per_sec': 10.0}, 1: {'steps_per_sec': 1.0}},
    {0: {'steps_per_sec': 4.0}, 1: {'steps_per_sec': 4.0},
     2: {'steps_per_sec': 0.0}},
    {0: {'steps_per_sec': 3.0, 'rows_per_sec': 90.0},
     1: {'steps_per_sec': 2.0, 'rows_per_sec': None},
     2: {'steps_per_sec': 3.5, 'rows_per_sec': 10.0},
     3: {'steps_per_sec': 3.0}},
    {0: {'steps_per_sec': 1.0}},
    {0: {'steps_per_sec': 0.0}, 1: {'steps_per_sec': 0.0}},
], ids=['two', 'stalled', 'mixed', 'alone', 'idle'])
def test_straggler_scores_match_lddl_tpu(signals):
  assert tlive.straggler_scores(signals) == jlive.straggler_scores(signals)


def _rank_lines(rank, steps):
  """One rank's telemetry snapshot lines, from a registry of the port."""
  tele = ttele.Telemetry()
  tele.counter('train.steps').add(steps)
  tele.counter('train.samples').add(16 * steps)
  tele.counter('train.elastic.dead_ranks').add(rank)
  for i in range(steps):
    tele.histogram('train.data_wait_seconds').observe(0.001 * (i + rank))
    tele.histogram('train.compute_seconds').observe(0.05 + 0.01 * rank)
    tele.histogram('train.step_seconds').observe(0.06)
    tele.histogram('comm.allgather_seconds').observe(0.002 * (rank + 1))
  tele.gauge('train.mfu').set(0.3 + 0.01 * rank)
  tele.gauge('train.samples_per_sec').set(100.0 + rank)
  return tele.snapshot_lines(rank=rank)


def test_report_matches_lddl_tpu(tmp_path):
  per_rank = [_rank_lines(0, 5), _rank_lines(1, 7)]
  merged = treport.merge_metric_lines(per_rank)
  assert merged == jreport.merge_metric_lines(per_rank)
  assert treport.summarize_stages(merged) == jreport.summarize_stages(merged)
  assert treport.render_report(merged) == jreport.render_report(merged)
  for r, lines in enumerate(per_rank):
    with open(tmp_path / f'telemetry.rank{r}.jsonl', 'w') as f:
      f.write(''.join(json.dumps(x) + '\n' for x in lines))
  assert treport.load_rank_files(str(tmp_path)) == \
      jreport.load_rank_files(str(tmp_path))
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert treport.main(['--dir', str(tmp_path)]) == 0
  assert out.getvalue().strip() == jreport.render_report(merged)
  assert treport.main(['--dir', str(tmp_path / 'nowhere')]) == 2


def _threaded_world(tmp_path, fn, world=2):
  """``fn(backend)`` on ``world`` FileBackend ranks, one thread each."""
  out, errors = {}, []

  def run(r):
    try:
      out[r] = fn(FileBackend(str(tmp_path), r, world, timeout=30.0))
    except Exception as e:  # the test fails on it below
      errors.append(e)

  threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(60)
  assert not errors and len(out) == world, errors
  return out


def test_aggregate_over_comm_equals_the_offline_merge(tmp_path):
  per_rank = [_rank_lines(0, 3), _rank_lines(1, 4)]

  def merge(be):
    tele = ttele.Telemetry()
    snapshot = per_rank[be.rank]
    tele.snapshot_lines = lambda rank=0: snapshot
    return treport.aggregate_over_comm(be, telemetry=tele)

  got = _threaded_world(tmp_path, merge)
  assert got[0] == got[1] == jreport.merge_metric_lines(per_rank)


def test_export_telemetry_prints_the_fleet_report_on_rank_0(
    tmp_path, monkeypatch):
  monkeypatch.setenv('LDDL_TELEMETRY_DIR', str(tmp_path / 'out'))
  tele = ttele.enable()
  try:
    tele.counter('train.steps').add(3)
    tele.histogram('train.compute_seconds').observe(0.05)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
      paths = _threaded_world(tmp_path / 'rdv', export_telemetry)
  finally:
    ttele.disable()
  assert [os.path.basename(p) for r in (0, 1) for p in paths[r]] == [
      'telemetry.rank0.jsonl', 'telemetry.rank1.jsonl']
  text = out.getvalue()
  assert text.count('telemetry report') == 1
  assert 'telemetry report — 2 rank(s): [0, 1]' in text


def _ledger_signals(directory, rank, digests):
  led = tledger.Ledger(directory=str(directory), rank=rank)
  for i, d in enumerate(digests):
    led.record('device', d, index=i)
  return led


@pytest.mark.parametrize('diverge', [False, True], ids=['ok', 'diverged'])
def test_divergence_over_comm_matches_compare_signals(tmp_path, diverge,
                                                      monkeypatch):
  # The device boundary is not rank-identical in a real run; here both
  # ranks record the same stream, and the verdict compares it.
  monkeypatch.setenv('LDDL_LEDGER_REPLICATED', 'device')
  digests = [[f'{i:016x}' for i in range(6)] for _ in range(2)]
  if diverge:
    digests[1][3] = 'ffffffffffffffff'
  ledgers = [_ledger_signals(tmp_path / 'led', r, digests[r])
             for r in (0, 1)]
  try:
    got = _threaded_world(
        tmp_path / 'rdv',
        lambda be: tledger.divergence_over_comm(be, ledger=ledgers[be.rank]))
    want = jledger.compare_signals({r: ledgers[r].signals() for r in (0, 1)})
  finally:
    for led in ledgers:
      led.close()
  for r in (0, 1):
    verdict = dict(got[r])
    assert verdict.pop('seq') == 0
    assert verdict == want
    assert ledgers[r].fleet_verdict() == got[r]
  assert want['status'] == ('diverged' if diverge else 'ok')
  if diverge:
    assert want['first']['key'] == [3]


def test_elastic_knobs(monkeypatch, tmp_path):
  be = FileBackend(str(tmp_path), 0, 2, timeout=10.0, run_id='knobs')
  assert elastic_train_enabled(be)
  monkeypatch.setenv('LDDL_ELASTIC_TRAIN', '0')
  assert not elastic_train_enabled(be)
  assert maybe_membership(be) is None
  monkeypatch.setenv('LDDL_SHED_SCORE', '2.5')
  assert shed_threshold() == 2.5
  monkeypatch.setenv('LDDL_SHED_SCORE', 'junk')
  assert shed_threshold() == 0.0


def test_injected_heartbeat_fault_is_absorbed(tmp_path, monkeypatch):
  """tests/test_faults.py's case: a transient error inside the pump's
  republish (injected at train.heartbeat) is absorbed and the counter
  keeps advancing for observers."""
  faults.reset()
  monkeypatch.setenv('LDDL_FAULTS', 'raise:train.heartbeat:nth=1')
  be = FileBackend(str(tmp_path), 0, 1, timeout=10.0, run_id='hb')
  store = be.lease_store('train.membership')
  pump = HeartbeatPump(store, 0.05, fault_site='train.heartbeat')
  try:
    t0 = time.monotonic()
    while store.read_heartbeat(0) < 2 and time.monotonic() - t0 < 10.0:
      time.sleep(0.05)
    assert store.read_heartbeat(0) >= 2
    assert pump.beats >= 2
  finally:
    pump.stop()
    faults.reset()


def test_shed_verdict_cas_unique(tmp_path):
  """tests/test_faults.py's case: both ranks score the same published
  signals, one shed record lands, and every rank's poll obeys it."""
  be0 = FileBackend(str(tmp_path), 0, 2, timeout=10.0, run_id='shed')
  be1 = FileBackend(str(tmp_path), 1, 2, timeout=10.0, run_id='shed')
  m0 = RankMembership(be0.lease_store('train.membership'), 0, 2,
                      interval=0.1, timeout=30.0, shed_score=2.0).start()
  m1 = RankMembership(be1.lease_store('train.membership'), 1, 2,
                      interval=0.1, timeout=30.0, shed_score=2.0).start()
  try:
    m0.publish_signals({'steps_per_sec': 10.0})
    m1.publish_signals({'steps_per_sec': 1.0})  # 5.5x the median: shed
    assert m0.poll() == m1.poll() == 'shed:rank1'
    fresh = be0.lease_store('train.membership')
    assert fresh.list('shed.rank') == ['shed.rank1']
    assert m0.members() == [0, 1]
  finally:
    m0.stop()
    m1.stop()


def test_sigkill_train_rank_fleet_checkpoints_and_resumes(tmp_path):
  """tests/test_faults.py::TestTrainRankDeath on the port: SIGKILL one
  of two train ranks mid-run; the survivor detects the death through the
  lease membership (the pid probe: the 60 s lease timeout would blow the
  deadline), checkpoints, and stops with a dead_rank reason; two
  restores at world size 1 (per-rank batch 8, the same global batch)
  agree on the state and the bins they draw next."""
  ckpt_dir = str(tmp_path / 'ckpt')
  base = {'LDDL_LEASE_TIMEOUT': '60', 'LDDL_COMM_HEARTBEAT': '0.2'}
  procs, q = ranks.start_world(
      ranks.file_fleet_rank, 2,
      args=(str(tmp_path / 'rdv'), SHARDS, VOCAB, ckpt_dir), env=base,
      rank_env={0: {'LDDL_ASYNC_CKPT': '1'},
                1: {'LDDL_FAULTS': 'kill:train.step:rank=1,nth=6'}})
  t0 = time.monotonic()
  info = ranks.join_world(procs, q, timeout=110, expect=[0])[0]
  elapsed = time.monotonic() - t0
  assert procs[1].exitcode == -signal.SIGKILL
  assert str(info['stop_reason']).startswith('dead_rank:1'), info
  assert info['steps_run'] >= 1, info
  assert elapsed < 100.0, elapsed
  meta = TrainLoop.latest_meta(ckpt_dir)
  assert meta == (info['step'], info['samples_seen'])
  assert meta[1] == 8 * meta[0]

  def resume():
    return ranks.shard_loop(0, 1, SHARDS, VOCAB, 8, samples_seen=meta[1],
                            comm='null').restore(ckpt_dir)

  a, b = resume(), resume()
  assert (a.step, a.samples_seen) == meta
  assert a.state_digest() == b.state_digest()
  assert ranks.bin_seq(a, 4) == ranks.bin_seq(b, 4)
  losses = a.run(meta[0] + 2, log_every=0)
  assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
