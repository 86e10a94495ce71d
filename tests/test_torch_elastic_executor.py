"""The port's elastic executor (leases, completion manifests, resume), on
the CPU.

The counterparts of ``tests/test_faults.py``'s elastic executor cases: a
SIGKILLed file-backend rank whose survivor finishes every task through
the pid probe and writes the fault-free static run's bytes; a world-1 run
killed at its third task and restarted with the same run id, skipping
the manifested tasks (their shards keep inode and mtime); the ledger of
that restart audited against a fault-free run; two survivors reaching
the same revoke verdict. Beyond them: a failed task's error manifest
raised on every rank; the same rank-death drill over ``--comm torch``
(``StoreLeaseStore`` over gloo, ``LDDL_ELASTIC=1``); a pooled elastic
map whose worker is killed (its replays publish again); and the port's
elastic BERT preprocess (two file ranks, one killed, host masking) giving
the rows of ``lddl_tpu``'s static run, read back with pyarrow; and each
preprocessor's CLI over ``--comm file`` writing its ``--comm null``
bytes.

Spawned ranks run functions of ``tests/torch_elastic_ranks.py`` (torch
and the port only); every world has a deadline of its own
(:data:`DEADLINE_S`).
"""

import functools
import multiprocessing
import os
import signal
import time

import pyarrow.parquet as pq
import pytest

import torch_dist_ranks
import torch_elastic_ranks as ranks
from lddl_tpu_torch.comm import FileBackend
from lddl_tpu_torch.pipeline.executor import Executor, _LeaseClaimer
from lddl_tpu_torch.testing import hash_parquets
from torch_threads import torch_one_thread_a_file  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
#: Seconds a spawned world of this file may take to report.
DEADLINE_S = 120.0


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The executor makes no shm segment; the shared fixture would count
  # other xdist workers' segments as this test's leak.
  yield


def _spawn(target, *args):
  ctx = multiprocessing.get_context('spawn')
  q = ctx.Queue()
  p = ctx.Process(target=target, args=(*args, q), daemon=True)
  p.start()
  return p, q


def _spawn_ranks(target, world, args_of):
  ctx = multiprocessing.get_context('spawn')
  q = ctx.Queue()
  procs = [ctx.Process(target=target, args=(*args_of(r), q), daemon=True)
           for r in range(world)]
  for p in procs:
    p.start()
  return procs, q


def _reap(procs):
  for p in procs:
    p.join(timeout=30)
    if p.is_alive():
      p.kill()
      p.join(5)


def _collect(q, n):
  """``{rank: (kind, payload)}`` of ``n`` reports within the deadline."""
  out = {}
  deadline = time.monotonic() + DEADLINE_S
  while len(out) < n:
    rank, kind, payload = q.get(timeout=max(1.0, deadline - time.monotonic()))
    out[rank] = (kind, payload)
  return out


def test_sigkill_rank_survivor_completes_byte_identical(tmp_path):
  """Rank 1 SIGKILLed at its first claimed task: the survivor revokes the
  orphaned lease through the pid probe (the 60 s lease timeout would
  miss the bound), runs every task, and writes the static run's bytes;
  a ``gather=False`` map then returns every task as the survivor's own."""
  tasks = list(range(8))
  out_dir, ref_dir = str(tmp_path / 'out'), str(tmp_path / 'ref')
  os.makedirs(out_dir)
  expected = ranks.reference_shards(ref_dir, tasks)
  env = {'LDDL_LEASE_TIMEOUT': '60', 'LDDL_COMM_HEARTBEAT': '0.2'}
  t0 = time.monotonic()
  procs, q = _spawn_ranks(ranks.elastic_rank, 2, lambda r: (
      str(tmp_path / 'rdv'), r, 2, out_dir, tasks,
      dict(env, LDDL_FAULTS='kill:elastic.task:rank=1,nth=1' if r else '')))
  try:
    got = _collect(q, 1)
    elapsed = time.monotonic() - t0
  finally:
    _reap(procs)
  kind, res = got[0]
  assert kind == 'completed', res
  assert res['out'] == expected
  assert res['own'] == [(i, 11 * i) for i in tasks]
  assert res['elastic'] is True
  assert procs[1].exitcode == -signal.SIGKILL
  assert hash_parquets(out_dir) == hash_parquets(ref_dir)
  assert elapsed < 60.0, f'{elapsed:.0f} s: the lease timeout, not the probe'


def test_killed_run_resumes_skipping_manifested_partitions(tmp_path):
  """A world-1 run SIGKILLed at its third task, restarted with the same
  run id: the two manifested tasks are skipped (their shards keep inode
  and mtime; ``pipeline.elastic.resume_skipped`` = 2), the killed one
  runs again, and the bytes are the fault-free run's."""
  tasks = list(range(6))
  out_dir, ref_dir = str(tmp_path / 'out'), str(tmp_path / 'ref')
  rdv, faults = str(tmp_path / 'rdv'), str(tmp_path / 'faults')
  os.makedirs(out_dir)
  os.makedirs(faults)
  expected = ranks.reference_shards(ref_dir, tasks)
  env = {'LDDL_FAULTS': 'kill:elastic.task:nth=3,once',
         'LDDL_FAULTS_DIR': faults, 'LDDL_TELEMETRY': '1',
         # Synchronous shards and manifests: at the kill the manifested
         # set is exactly the finished tasks.
         'LDDL_WRITE_BACK': '0', 'LDDL_COMM_HEARTBEAT': '0.2'}
  p1, _ = _spawn(ranks.resume_rank, rdv, out_dir, tasks, env)
  _reap([p1])
  assert p1.exitcode == -signal.SIGKILL
  survivors = {name: (st.st_ino, st.st_mtime_ns)
               for name in os.listdir(out_dir) if name.endswith('.parquet')
               for st in [os.stat(os.path.join(out_dir, name))]}
  assert len(survivors) == 2, sorted(survivors)
  p2, q = _spawn(ranks.resume_rank, rdv, out_dir, tasks, env)
  try:
    kind, res = _collect(q, 1)[0]
  finally:
    _reap([p2])
  assert kind == 'completed', res
  out, skipped = res
  assert out == expected
  assert skipped == 2
  assert hash_parquets(out_dir) == hash_parquets(ref_dir)
  for name, stat in survivors.items():
    st = os.stat(os.path.join(out_dir, name))
    assert (st.st_ino, st.st_mtime_ns) == stat, f'{name} was rewritten'


def test_killed_restart_ledger_audits_against_reference(tmp_path):
  """Both incarnations of the killed run append shard fingerprints to one
  rank ledger, a fault-free run writes its own, and the port's auditor
  verifies the recovered output; a tampered digest fails naming the
  shard."""
  import json

  from lddl_tpu_torch.telemetry import audit
  tasks = list(range(6))
  out_dir, ref_out = str(tmp_path / 'out'), str(tmp_path / 'refout')
  led_dir, ref_led = str(tmp_path / 'led'), str(tmp_path / 'refled')
  for d in (out_dir, ref_out):
    os.makedirs(d)
  base = {'LDDL_WRITE_BACK': '0', 'LDDL_COMM_HEARTBEAT': '0.2',
          'LDDL_LEDGER': '1'}
  ref, q = _spawn(ranks.resume_rank, str(tmp_path / 'rdv_ref'), ref_out,
                  tasks, dict(base, LDDL_TELEMETRY_DIR=ref_led))
  try:
    assert _collect(q, 1)[0][0] == 'completed'
  finally:
    _reap([ref])
  faults = str(tmp_path / 'faults')
  os.makedirs(faults)
  env = dict(base, LDDL_TELEMETRY_DIR=led_dir, LDDL_FAULTS_DIR=faults,
             LDDL_FAULTS='kill:elastic.task:nth=3,once')
  rdv = str(tmp_path / 'rdv')
  p1, _ = _spawn(ranks.resume_rank, rdv, out_dir, tasks, env)
  _reap([p1])
  assert p1.exitcode == -signal.SIGKILL
  p2, q = _spawn(ranks.resume_rank, rdv, out_dir, tasks, env)
  try:
    kind, res = _collect(q, 1)[0]
  finally:
    _reap([p2])
  assert kind == 'completed', res

  assert audit.main(['verify', led_dir, ref_led]) == 0
  run = audit.load_run(led_dir)
  assert len(audit.index_records(run[0])[0]['shard']) == len(tasks)
  tampered = str(tmp_path / 'tampered')
  os.makedirs(tampered)
  damaged = False
  with open(os.path.join(led_dir, 'ledger.rank0.jsonl')) as f, \
      open(os.path.join(tampered, 'ledger.rank0.jsonl'), 'w') as g:
    for line in f:
      rec = json.loads(line)
      if not damaged and rec.get('boundary') == 'shard' and \
          rec.get('path') == 'part.4.parquet':
        rec['digest'] = rec['digest'][::-1]
        damaged = True
        line = json.dumps(rec) + '\n'
      g.write(line)
  assert damaged
  assert audit.main(['verify', tampered, ref_led]) == 1
  result = audit.audit_verify(audit.load_run(tampered),
                              audit.load_run(ref_led))
  assert result['first']['boundary'] == 'shard'
  assert result['first']['key'] == {'path': 'part.4.parquet'}


def test_all_survivors_reach_same_revoke_decision(tmp_path):
  """Two survivors watching an orphaned claim (its owner never beats and
  has no beacon) both revoke it once the lease times out, agree on the
  generation, and exactly one wins the re-claim."""
  be0 = FileBackend(str(tmp_path), 0, 3, timeout=60.0, run_id='rv')
  be1 = FileBackend(str(tmp_path), 1, 3, timeout=60.0, run_id='rv')
  s0, s1 = be0.lease_store('ph.0'), be1.lease_store('ph.0')
  s0.publish('claim.5.g0', b'2')
  c0 = _LeaseClaimer(s0, [5], timeout=0.5)
  c1 = _LeaseClaimer(s1, [5], timeout=0.5)
  assert c0.next_claim() is None and c1.next_claim() is None
  # The first sweep only records the silent heartbeat.
  assert c0.observe() is False and c1.observe() is False
  time.sleep(0.7)
  assert c0.observe() is True and c1.observe() is True
  assert c0._gen[5] == c1._gen[5] == 1
  assert [k for k in s0.list('revoke.') if k.startswith('revoke.5.')] == \
      ['revoke.5.g0']
  assert len([c for c in (c0, c1) if c.next_claim() == 5]) == 1


def test_a_failed_task_raises_on_every_rank(tmp_path):
  """The rank that runs the failing task raises its error; the other one
  reads the error manifest at gather and raises it too: no rank waits on
  a task nobody can finish."""
  tasks = list(range(6))
  procs, q = _spawn_ranks(ranks.failing_rank, 2, lambda r: (
      str(tmp_path / 'rdv'), r, 2, tasks, 3))
  try:
    got = _collect(q, 2)
  finally:
    _reap(procs)
  for rank in (0, 1):
    kind, err = got[rank]
    assert kind == 'error' and 'task 3 exploded' in err, (rank, err)
  assert {got[r][1].split(':')[0] for r in (0, 1)} == {'ValueError',
                                                       'TaskFailed'}


def test_resume_pending_scheduler_info_and_the_static_switch(tmp_path,
                                                             monkeypatch):
  """World 1 over the file backend is elastic by default: a map's
  manifests make the next executor of the same run id see
  ``resume_pending``; ``LDDL_ELASTIC=0`` forces the static stride."""
  out_dir = str(tmp_path / 'out')
  os.makedirs(out_dir)
  task = functools.partial(ranks.write_shard, out_dir, 0.0)
  be = FileBackend(str(tmp_path / 'rdv'), 0, 1, run_id='rp')
  with Executor(comm=be) as ex:
    assert ex.scheduler_info()['elastic'] is True
    assert not ex.resume_pending('w')
    first = ex.map(task, [1, 2, 3], label='w')
    assert not ex.resume_pending('w')  # the next phase 'w' is 'w.1'
    assert ex.map(task, [4, 5], gather=False, label='w') == [
        (0, ('ok', 0, 4)), (1, ('ok', 1, 5))]
  assert sorted(os.listdir(tmp_path / 'rdv' / 'rp.elastic.w.0')) == [
      'claim.0.g0', 'claim.1.g0', 'claim.2.g0', 'done.0', 'done.1',
      'done.2', 'hb.rank0']
  with Executor(comm=be) as ex:
    assert ex.resume_pending('w')
    assert ex.map(task, [1, 2, 3], label='w') == first
  monkeypatch.setenv('LDDL_ELASTIC', '0')
  with Executor(comm=FileBackend(str(tmp_path / 'rdv'), 0, 1,
                                 run_id='static')) as ex:
    assert ex.scheduler_info()['elastic'] is False
    assert not ex.resume_pending('w')
    assert ex.map(task, [1, 2, 3], label='w') == first
  assert not os.path.exists(tmp_path / 'rdv' / 'static.elastic.w.0')


def test_torch_store_rank_death(tmp_path):
  """The rank-death drill over ``--comm torch``: two gloo ranks,
  ``LDDL_ELASTIC=1`` (a ``StoreLeaseStore``, whose manifests the parent
  publishes after each pass); rank 1 SIGKILLed at its first task, rank 0
  revokes its lease on heartbeat silence (the store has no pid probe) and
  writes the static run's bytes."""
  tasks = list(range(6))
  out_dir, ref_dir = str(tmp_path / 'out'), str(tmp_path / 'ref')
  os.makedirs(out_dir)
  expected = ranks.reference_shards(ref_dir, tasks)
  env = {'LDDL_ELASTIC': '1', 'LDDL_LEASE_TIMEOUT': '1.5',
         'LDDL_COMM_HEARTBEAT': '0.2'}
  procs, q = torch_dist_ranks.start_world(
      ranks.torch_elastic_rank, 2, args=(out_dir, tasks), env=env,
      rank_env={1: {'LDDL_FAULTS': 'kill:elastic.task:rank=1,nth=1'}},
      deadline=DEADLINE_S)
  res = torch_dist_ranks.join_world(procs, q, timeout=DEADLINE_S,
                                    expect={0})
  assert procs[1].exitcode == -signal.SIGKILL
  assert res[0]['out'] == expected and res[0]['elastic'] is True
  assert hash_parquets(out_dir) == hash_parquets(ref_dir)


def test_pooled_elastic_map_with_a_killed_worker(tmp_path):
  """World 1 at two pool workers: a worker SIGKILLed at its third task is
  respawned, the task run again and the tasks whose writes it had not
  landed too, each republishing its manifest behind its shards; every
  task has a manifest and the bytes are the static run's."""
  tasks = list(range(8))
  out_dir, ref_dir = str(tmp_path / 'out'), str(tmp_path / 'ref')
  faults = str(tmp_path / 'faults')
  os.makedirs(out_dir)
  os.makedirs(faults)
  expected = ranks.reference_shards(ref_dir, tasks)
  env = {'LDDL_FAULTS': 'kill:pool.task:nth=3,once',
         'LDDL_FAULTS_DIR': faults, 'LDDL_COMM_HEARTBEAT': '0.2'}
  p, q = _spawn(functools.partial(ranks.elastic_rank, workers=2, sec=0.05),
                str(tmp_path / 'rdv'), 0, 1, out_dir, tasks, env)
  try:
    kind, res = _collect(q, 1)[0]
  finally:
    _reap([p])
  assert kind == 'completed', res
  assert res['out'] == expected
  assert len(os.listdir(faults)) == 1  # the kill fired
  assert hash_parquets(out_dir) == hash_parquets(ref_dir)
  done = sorted(n for n in os.listdir(tmp_path / 'rdv' / 'el.elastic.shards.0')
                if n.startswith('done.'))
  assert done == sorted(f'done.{i}' for i in tasks)


def test_elastic_bert_preprocess_gives_lddl_tpus_rows(tmp_path):
  """Two ``--comm file`` ranks of the port's BERT CLI (host masking,
  binned), rank 1 SIGKILLed at its first task: rank 0 runs every
  partition of both phases, and its shards hold the rows of
  ``lddl_tpu``'s static run on the same corpus (read with pyarrow; the
  two packages' Parquet bytes differ by writer)."""
  from lddl_tpu.preprocess import bert as jbert
  from lddl_tpu.preprocess import readers as jreaders
  from lddl_tpu_torch.testing import write_word_corpus, write_word_vocab
  src, vocab = str(tmp_path / 'src'), str(tmp_path / 'vocab.txt')
  write_word_corpus(src, num_docs=120, num_shards=3, seed=11)
  write_word_vocab(vocab)
  settings = {'target_seq_length': 64, 'bin_size': 32, 'masking': True,
              'duplicate_factor': 2, 'seed': 5, 'sentence_backend': 'rules',
              'mask_backend': 'host'}
  jsink = str(tmp_path / 'jsink')
  jcorpus = jreaders.read_corpus([src], num_blocks=4, sample_ratio=1.0,
                                 sample_seed=5)
  jcounts = jbert.run(jcorpus, jsink, jbert.BertPretrainConfig(
      vocab_file=vocab, tokenizer_backend='native', **settings))
  sink = str(tmp_path / 'sink')
  argv = ['--source', src, '--sink', sink, '--vocab-file', vocab,
          '--num-blocks', '4', '--sample-ratio', '1.0', '--seed', '5',
          '--target-seq-length', '64', '--bin-size', '32', '--masking',
          '--duplicate-factor', '2', '--sentence-backend', 'rules',
          '--mask-backend', 'host']
  env = {'LDDL_COMM_HEARTBEAT': '0.2', 'LDDL_TELEMETRY': '1'}
  procs, q = _spawn_ranks(ranks.preprocess_rank, 2, lambda r: (
      str(tmp_path / 'rdv'), r, 2, argv,
      dict(env, LDDL_FAULTS='kill:elastic.task:rank=1,nth=1' if r else '')))
  try:
    kind, res = _collect(q, 1)[0]
  finally:
    _reap(procs)
  assert kind == 'completed', res
  assert procs[1].exitcode == -signal.SIGKILL
  names = sorted(n for n in os.listdir(jsink) if '.parquet' in n)
  assert names and sorted(n for n in os.listdir(sink)
                          if '.parquet' in n) == names
  assert res['counts'] == jcounts
  assert res['tasks'] == len(jcounts)
  for name in names:
    got = pq.read_table(os.path.join(sink, name))
    want = pq.read_table(os.path.join(jsink, name))
    # Types and tags; the port writes its columns required (Known
    # departures).
    assert [(f.name, f.type) for f in got.schema] == \
        [(f.name, f.type) for f in want.schema], name
    assert got.schema.metadata == want.schema.metadata, name
    assert got.to_pylist() == want.to_pylist(), name


RULES = ['--sentence-backend', 'rules']
PREPROCESSORS = {
    'bert': ['--target-seq-length', '128', '--bin-size', '64',
             '--num-blocks', '3', '--masking', '--mask-backend', 'host',
             *RULES, '--vocab-file', VOCAB],
    'packed': ['--target-seq-length', '1024', '--num-blocks', '2', *RULES,
               '--vocab-file', VOCAB],
    'codebert': ['--target-seq-length', '256', '--bin-size', '128',
                 '--num-blocks', '2', '--vocab-file', VOCAB],
    'bart': ['--target-seq-length', '128', '--num-blocks', '2', *RULES],
}


@pytest.mark.parametrize('name', sorted(PREPROCESSORS))
def test_every_preprocessor_cli_takes_comm_file(name, tmp_path, monkeypatch):
  """Each preprocessor's CLI over ``--comm file`` (world 1: the elastic
  path by default) writes the bytes of its ``--comm null`` run, and
  leaves a manifest for every task of both phases."""
  import importlib

  from lddl_tpu_torch import testing
  module = importlib.import_module(f'lddl_tpu_torch.preprocess.{name}')
  src = str(tmp_path / 'src')
  if name == 'codebert':
    testing.write_codebert_source(src, 3, target_bytes=64 << 10)
  else:
    testing.write_doc_source(src, testing.synth_docs(3, 64 << 10))
  argv = ['--source', src, '--seed', '3', *PREPROCESSORS[name]]
  rdv = str(tmp_path / 'rdv')
  monkeypatch.setenv('LDDL_COMM_DIR', rdv)
  monkeypatch.setenv('LDDL_COMM_RUN_ID', name)
  counts = [module.main(argv + ['--sink', str(tmp_path / s), '--comm', c])
            for s, c in (('null', 'null'), ('file', 'file'))]
  assert counts[0] == counts[1]
  assert hash_parquets(tmp_path / 'file') == hash_parquets(tmp_path / 'null')
  for phase in ('scatter', 'process'):
    done = [n for n in os.listdir(os.path.join(rdv, f'{name}.elastic.{phase}.0'))
            if n.startswith('done.')]
    assert len(done) >= 2, (phase, done)
