"""The port's perf gate, trace CLI and ledger_divergence sentinel against
lddl_tpu's, on the CPU.

- ``lddl_tpu_torch.telemetry.perf`` against ``lddl_tpu.telemetry.perf``:
  every case of tests/test_perf_gate.py's classes (TestJudgeSeries,
  TestLoaders, TestGateCli, TestAuditFold) on the same inputs in both
  packages, the committed BENCH_r*.json, MULTICHIP_r*.json and
  bench_history.jsonl included: equal verdict dicts, series and exit
  codes. Each gate's concurrency leg lints its own package with its own
  analyzer: the port's lints lddl_tpu_torch/ (clean, and rc 1 on a
  planted finding), and the JAX leg is pinned clean here so the other
  legs compare. Beyond those: the port's ``--incidents`` over a tree its
  own flight recorder wrote, ``--replay-smoke`` over a ledger its own
  loader recorded.
- The trace CLI: two rank files merge into the same Chrome-trace
  document in both packages; a directory without trace files exits 2.
- The sentinel's ledger_divergence detector (tests/test_sentinel.py's
  case): a verdict from two gloo ranks' divergence_over_comm over ledgers
  that differ in one collate digest fires once per verdict; equal
  ledgers never fire.

Everything is compared exactly.
"""

import json
import os
import subprocess
import sys

import pytest

from lddl_tpu.telemetry import perf as jperf
from lddl_tpu_torch.telemetry import perf as tperf

from torch_dist_ranks import run_world
from torch_threads import torch_one_thread_a_file  # noqa: F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(REPO_ROOT, 'tests', 'assets', 'torch_shards', 'pairs')
VOCAB = os.path.join(REPO_ROOT, 'benchmarks', 'assets',
                     'bench_vocab_30522.txt')
BOTH = [jperf, tperf]


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # No shm segment here; the shared fixture would count other xdist
  # workers' lddl_ segments as this test's leak.
  yield


@pytest.fixture(autouse=True)
def _jax_concurrency_leg_pinned(monkeypatch):
  monkeypatch.setattr(jperf, 'check_concurrency', lambda: (0, 0))


def _same(fn):
  """``fn(package)`` for both packages: equal; the port's result."""
  want, got = fn(jperf), fn(tperf)
  assert got == want
  return got


def _main(mod, argv, capsys):
  """``mod.main(argv)``: its exit code, stdout and stderr. The
  "concurrency lint clean" line is left out of stdout: each gate prints
  it for its own package."""
  rc = mod.main(argv)
  out = capsys.readouterr()
  return rc, out.out.replace('lddl-perf: concurrency lint clean\n',
                             ''), out.err


def _write_history(path, values, metric='tput_rows_per_sec'):
  with open(path, 'w') as f:
    for v in values:
      f.write(json.dumps({'metric': metric, 'value': v}) + '\n')
  return str(path)


# ---------------------------------------------------------------------------
# TestJudgeSeries


SERIES = {
    'cliff': ('tput_rows_per_sec', [10.0, 10.1, 9.9, 10.05, 3.0],
              'regression'),
    'benign': ('tput_rows_per_sec', [10.0, 10.4, 9.6, 10.2, 9.7], 'ok'),
    'wide_growth': ('mb_per_sec_per_chip',
                    [0.801, 8.28, 10.433, 16.049, 6.913], 'ok'),
    'improvement': ('tput_rows_per_sec', [10.0, 10.1, 9.9, 10.05, 30.0],
                    'ok'),
    'latency_drop': ('step_latency_ms', [10.0, 10.1, 9.9, 10.05, 3.0], 'ok'),
    'latency_rise': ('step_latency_ms', [10.0, 10.1, 9.9, 10.05, 30.0],
                     'regression'),
    'short': ('x_per_sec', [10.0, 3.0], 'insufficient-data'),
    'constant_jitter': ('tput_rows_per_sec', [10.0, 10.0, 10.0, 10.0, 9.8],
                        'ok'),
    'constant_cliff': ('tput_rows_per_sec', [10.0, 10.0, 10.0, 10.0, 5.0],
                       'regression'),
}


@pytest.mark.parametrize('case', sorted(SERIES))
def test_judge_series_matches(case):
  name, values, status = SERIES[case]
  got = _same(lambda m: m.judge_series(name, values))
  assert got['status'] == status


def test_robust_stats_and_direction_match():
  assert _same(lambda m: m.robust_stats([1.0, 2.0, 3.0, 4.0, 100.0])) == (
      3.0, 1.0)
  # 'per_step' holds the 'per_s' hint in both packages: a name like
  # window_ms_per_step reads higher-is-better, so chip_smoke.py names its
  # series *_step_ms.
  names = ['bert_preprocess_mb_per_sec_per_chip', 'train_samples_per_sec',
           'multichip_smoke_ok', 'step_latency_ms', 'data_wait_seconds',
           'hbm_bytes_in_use', 'window_step_ms', 'h2d_seconds',
           'window_ms_per_step']
  assert _same(lambda m: [m.metric_direction(n) for n in names]) == [
      1, 1, 1, -1, -1, -1, -1, -1, 1]


# ---------------------------------------------------------------------------
# TestLoaders


def test_committed_rounds_and_history_load_the_same():
  """The committed BENCH_r*.json, MULTICHIP_r*.json and
  bench_history.jsonl, each loader and the merge."""
  series = _same(lambda m: m.load_bench_rounds(REPO_ROOT))
  assert series['bert_preprocess_mb_per_sec_per_chip'][0] == 0.801
  assert _same(lambda m: m.load_multichip_rounds(REPO_ROOT))
  history = os.path.join(REPO_ROOT, 'bench_history.jsonl')
  assert _same(lambda m: m.load_history_jsonl(history))
  assert _same(lambda m: m.gather_series(REPO_ROOT))


def test_history_roundtrip_matches(tmp_path):
  texts = []
  for mod in BOTH:
    path = str(tmp_path / f'{mod.__name__}.jsonl')
    mod.append_history(path, {'metric': 'm_per_sec', 'value': 1.5, 'n': 1})
    mod.append_history(path, {'metric': 'm_per_sec', 'value': 2.5, 'n': 2,
                              'parsed': {'extra_per_sec': 7.0}})
    with open(path) as f:
      texts.append(f.read())
  assert texts[0] == texts[1]
  path = str(tmp_path / f'{tperf.__name__}.jsonl')
  assert _same(lambda m: m.load_history_jsonl(path)) == {
      'm_per_sec': [1.5, 2.5], 'extra_per_sec': [7.0]}


def test_history_garbage_lines_match(tmp_path):
  path = tmp_path / 'hist.jsonl'
  path.write_text('not json\n{"metric": "x_per_sec", "value": 1.0}\n\n')
  assert _same(lambda m: m.load_history_jsonl(str(path))) == {
      'x_per_sec': [1.0]}
  assert _same(lambda m: m.load_history_jsonl(
      str(tmp_path / 'missing.jsonl'))) == {}


def test_gather_merges_the_same(tmp_path):
  for i, v in enumerate([1.0, 2.0]):
    (tmp_path / f'BENCH_r0{i + 1}.json').write_text(json.dumps(
        {'n': i + 1, 'parsed': {'metric': 'm_per_sec', 'value': v}}))
  _write_history(tmp_path / 'bench_history.jsonl', [3.0, 4.0],
                 metric='m_per_sec')
  assert _same(lambda m: m.gather_series(str(tmp_path)))['m_per_sec'] == [
      1.0, 2.0, 3.0, 4.0]


# ---------------------------------------------------------------------------
# TestGateCli


GATES = {
    'real_repo_gate': (None, ['--gate'], 0),
    'injected_cliff_gate': ([10.0, 10.1, 9.9, 10.05, 3.0], ['--gate'], 1),
    'benign_noise_gate': ([10.0, 10.4, 9.6, 10.2, 9.7], ['--gate'], 0),
    'cliff_without_gate': ([10.0, 10.1, 9.9, 10.05, 3.0], [], 0),
    'no_inputs': ([], [], 2),
}


@pytest.mark.parametrize('case', sorted(GATES))
def test_gate_cli_matches(case, tmp_path, capsys):
  values, flags, want = GATES[case]
  root = REPO_ROOT
  if values is not None:
    root = str(tmp_path)
    if values:
      _write_history(tmp_path / 'bench_history.jsonl', values)
  got = _same(lambda m: _main(m, ['--root', root] + flags, capsys)[:2])
  assert got[0] == want
  if case == 'no_inputs':
    rc, _, err = _main(tperf, ['--root', root], capsys)
    assert rc == 2 and 'no bench history' in err


def test_gate_json_output_matches(tmp_path, capsys):
  _write_history(tmp_path / 'bench_history.jsonl',
                 [10.0, 10.1, 9.9, 10.05, 3.0])
  rc, out = _same(lambda m: _main(m, ['--root', str(tmp_path), '--json',
                                      '--gate'], capsys)[:2])
  payload = json.loads(out)
  assert rc == 1 and payload['regressions'] == 1
  assert payload['concurrency_findings'] == 0


def test_the_gate_runs_as_a_module(tmp_path):
  """The JAX gate is the console script ``lddl-perf``; the port's runs as
  ``python -m lddl_tpu_torch.telemetry.perf`` (setup.py's console
  scripts stay lddl_tpu's), and its concurrency leg lints the port with
  the port's analyzer: clean."""
  with open(os.path.join(REPO_ROOT, 'setup.py')) as f:
    assert 'lddl-perf=lddl_tpu.telemetry.perf:main' in f.read()
  _write_history(tmp_path / 'bench_history.jsonl',
                 [10.0, 10.4, 9.6, 10.2, 9.7])
  proc = subprocess.run(
      [sys.executable, '-m', 'lddl_tpu_torch.telemetry.perf', '--root',
       str(tmp_path), '--gate'], cwd=REPO_ROOT, capture_output=True,
      text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
  assert 'tput_rows_per_sec' in proc.stdout
  assert 'concurrency lint unavailable' not in proc.stderr
  assert 'lddl-perf: concurrency lint clean' in proc.stdout


def test_a_concurrency_finding_fails_the_gate(tmp_path, capsys,
                                              monkeypatch):
  """The leg keeps the unsuppressed LDA014-LDA018 findings of the port's
  analyzer: one planted finding is rendered and fails the gate (rc 1),
  a suppressed one or another rule's does not; the verdict is memoized
  per process."""
  from lddl_tpu_torch import analysis
  from lddl_tpu_torch.analysis import Finding
  race = Finding('LDA014', 'lddl_tpu_torch/x.py', 3, 1, 'a planted race')
  other = Finding('LDA001', 'lddl_tpu_torch/x.py', 4, 1, 'unsorted')
  calls = []

  def planted(cache=None):
    calls.append(cache)
    return [race, other], [Finding('LDA015', 'y.py', 1, 1, 'x',
                                   suppressed=True)]

  monkeypatch.setattr(analysis, 'analyze_package', planted)
  monkeypatch.setattr(tperf, '_CONC_VERDICT', None)
  _write_history(tmp_path / 'bench_history.jsonl',
                 [10.0, 10.4, 9.6, 10.2, 9.7])
  rc, out, err = _main(tperf, ['--root', str(tmp_path), '--gate'], capsys)
  assert rc == 1
  assert 'a planted race' in err and 'unsorted' not in err
  assert '1 unsuppressed concurrency finding(s)' in err
  assert 'concurrency lint clean' not in out
  assert tperf.check_concurrency() == (1, 1) and len(calls) == 1
  assert _main(tperf, ['--root', str(tmp_path)], capsys)[0] == 0

  def broken(cache=None):
    raise RuntimeError('no tree')

  monkeypatch.setattr(analysis, 'analyze_package', broken)
  monkeypatch.setattr(tperf, '_CONC_VERDICT', None)
  assert tperf.check_concurrency() == (0, 0)
  assert 'concurrency lint unavailable: no tree' in capsys.readouterr().err


# ---------------------------------------------------------------------------
# TestAuditFold


def _write_ledger(directory, rank, streams):
  """The port's ledger writer, as test_perf_gate.py uses lddl_tpu's."""
  from lddl_tpu_torch.telemetry.ledger import Ledger, fingerprint_bytes
  led = Ledger(directory=str(directory), rank=rank)
  for boundary, payloads in streams:
    for i, payload in enumerate(payloads):
      key = {'step': i} if boundary == 'step' else {'epoch': 0, 'index': i}
      led.record(boundary, fingerprint_bytes(payload), **key)
  led.close()
  return str(directory)


def _good_history(tmp_path):
  _write_history(tmp_path / 'bench_history.jsonl',
                 [10.0, 10.1, 9.9, 10.05, 10.0])


def _audit_case(case, tmp_path):
  """(argv, expected rc, text the port must print) of a TestAuditFold
  case."""
  root = ['--root', str(tmp_path)]
  if case == 'perf_regression_wins':
    _write_history(tmp_path / 'bench_history.jsonl',
                   [10.0, 10.1, 9.9, 10.05, 3.0])
    return root + ['--gate', '--audit', str(tmp_path / 'absent')], 1, ''
  _good_history(tmp_path)
  if case == 'three_paths':
    return root + ['--gate', '--audit', 'a', 'b', 'c'], 2, '--audit takes'
  if case == 'single_path_wire':
    from lddl_tpu_torch.telemetry.ledger import Ledger, fingerprint_bytes
    led = Ledger(directory=str(tmp_path / 'run'), rank=0)
    for gi in range(3):
      led.record('serve.tx', fingerprint_bytes(b'%d' % gi), epoch=0, gi=gi)
      rx = b'%d' % gi if gi != 1 else b'damaged'
      led.record('serve.rx', fingerprint_bytes(rx), epoch=0, gi=gi)
    led.close()
    return root + ['--gate', '--audit', str(tmp_path / 'run')], 1, 'wire'
  second = {'matching': [b'a', b'b', b'c'], 'divergent': [b'a', b'X', b'c'],
            'without_gate': [b'Z']}
  if case in second:
    first = [b'a'] if case == 'without_gate' else [b'a', b'b', b'c']
    run = _write_ledger(tmp_path / 'run', 0, [('collate', first)])
    ref = _write_ledger(tmp_path / 'ref', 0, [('collate', second[case])])
    gate = [] if case == 'without_gate' else ['--gate']
    want, text = {'matching': (0, 'determinism audit ok'),
                  'divergent': (1, 'index=1'),
                  'without_gate': (0, '')}[case]
    return root + gate + ['--audit', run, ref], want, text
  assert case == 'json_audit_exit'
  run = _write_ledger(tmp_path / 'run', 0, [('step', [b'a', b'b'])])
  ref = _write_ledger(tmp_path / 'ref', 0, [('step', [b'a', b'b'])])
  return root + ['--json', '--audit', run, ref], 0, '"audit_exit": 0'


@pytest.mark.parametrize('case', [
    'matching', 'divergent', 'without_gate', 'perf_regression_wins',
    'single_path_wire', 'three_paths', 'json_audit_exit'])
def test_audit_fold_matches(case, tmp_path, capsys):
  argv, want, text = _audit_case(case, tmp_path)
  rcs = [_main(m, argv, capsys) for m in BOTH]
  assert [rc for rc, _, _ in rcs] == [want, want]
  assert text in rcs[1][1] + rcs[1][2]
  if case == 'json_audit_exit':
    outs = [json.loads(out[out.index('{\n  "verdicts"'):])
            for _, out, _ in rcs]
    assert outs[0] == outs[1] and outs[1]['audit_exit'] == 0


# ---------------------------------------------------------------------------
# the port's own legs: its flight recorder's incidents, its ledger's smoke


def test_incidents_over_a_port_flight_tree(tmp_path, capsys):
  """An incident the port's flight recorder froze fails the gate (rc 1)
  in both packages, with its trigger and replay command printed; no
  incident, no failure."""
  import numpy as np
  from lddl_tpu_torch.training.flight import FlightRecorder
  _good_history(tmp_path)
  inc = tmp_path / 'incidents'
  rec = FlightRecorder(out_dir=str(inc), capacity=4)
  batches = [{'input_ids': np.full((2, 8), i, np.int32)} for i in range(3)]
  assert len(list(rec.wrap_host_stream(iter(batches)))) == 3
  rec.note_checkpoint(str(tmp_path / 'ckpt'), 0)
  assert rec.capture({'detector': 'injected', 'step': 2,
                      'reason': 'drill'}) is not None
  argv = ['--root', str(tmp_path), '--gate', '--incidents', str(inc)]
  rcs = [_main(m, argv, capsys) for m in BOTH]
  assert [rc for rc, _, _ in rcs] == [1, 1]
  assert 'injected at step 2' in rcs[1][2]
  assert _same(lambda m: m.check_incidents(str(inc))) == (1, 1)
  capsys.readouterr()
  empty = tmp_path / 'none'
  empty.mkdir()
  assert _same(lambda m: m.check_incidents(str(empty))) == (0, 0)


def test_replay_smoke_over_a_port_ledger(tmp_path, capsys):
  """A ledger the port's pairs loader recorded (an epoch of the
  committed shards): the gate's audit and replay smoke pass in the port
  (its loader rebuilds the batches) and in lddl_tpu (its own loader over
  the same shards, whose batches are byte-identical)."""
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.telemetry import ledger as tledger
  with open(os.path.join(REPO_ROOT, 'tests', 'assets', 'torch_shards',
                         'digests.json')) as f:
    settings = json.load(f)['pairs']['settings']
  kwargs = dict(path=PAIRS, vocab_file=VOCAB, **settings)
  led = str(tmp_path / 'led')
  tledger._active = None
  tledger.enable_ledger(directory=led, rank=0)
  try:
    n = sum(1 for _ in get_bert_pretrain_data_loader(**kwargs))
  finally:
    tledger.disable_ledger()
    tledger._active = None
  assert n > 0
  _good_history(tmp_path)
  common = ['--root', str(tmp_path), '--gate', '--audit', led,
            '--replay-smoke', '--replay-kwargs-json', json.dumps(kwargs)]
  rc, out, err = _main(tperf, common + [
      '--replay-factory',
      'lddl_tpu_torch.loader.bert:get_bert_pretrain_data_loader'], capsys)
  assert rc == 0, err
  assert 'replay-smoke collate: ok' in out
  assert 'determinism audit ok' in out
  rc, out, err = _main(jperf, common + [
      '--replay-factory',
      'lddl_tpu.loader.bert:get_bert_pretrain_data_loader'], capsys)
  assert rc == 0, err
  assert 'replay-smoke collate: ok' in out
  assert _main(tperf, ['--root', str(tmp_path), '--replay-smoke'],
               capsys)[0] == 2


# ---------------------------------------------------------------------------
# the trace CLI


def _trace_files(directory):
  """Two ranks' trace files (a collective on each, so the merge aligns
  clocks) and rank 0's telemetry, written by the port's tracer and
  registry."""
  from lddl_tpu_torch.telemetry.metrics import Telemetry
  from lddl_tpu_torch.telemetry.trace import Tracer, trace_file_name
  for rank in (0, 1):
    tr = Tracer(rank=rank)
    with tr.span('train.step', args={'step': 1}):
      pass
    tr.complete('comm.allgather', 100.0 + rank * 0.001, 0.002,
                args={'seq': 0})
    tr.counter('loader.backlog', 3 + rank)
    tr.instant('train.checkpoint')
    tr.write_jsonl(trace_file_name(str(directory), rank), rank=rank)
  tele = Telemetry()
  tele.histogram('train.data_wait_seconds').observe(0.01)
  tele.histogram('train.compute_seconds').observe(0.05)
  tele.write_jsonl(os.path.join(str(directory), 'telemetry.rank0.jsonl'))


def test_trace_cli_merges_like_lddl_tpu(tmp_path, capsys):
  from lddl_tpu.telemetry.trace import main as jmain
  from lddl_tpu_torch.telemetry.trace import main as tmain
  _trace_files(tmp_path)
  docs = []
  for name, fn in (('jax', jmain), ('torch', tmain)):
    out = str(tmp_path / f'{name}.json')
    assert fn(['--dir', str(tmp_path), '-o', out]) == 0
    assert 'events from 2 process file(s)' in capsys.readouterr().out
    with open(out) as f:
      docs.append(json.load(f))
  assert docs[1] == docs[0]
  assert docs[1]['metadata']['lddl']['ranks'] == [0, 1]
  assert 'bottleneck' in docs[1]['metadata']['lddl']
  assert len(docs[1]['traceEvents']) > 8
  empty = tmp_path / 'empty'
  empty.mkdir()
  for fn in (jmain, tmain):
    assert fn(['--dir', str(empty)]) == 2
    assert 'no trace.rank*.jsonl files' in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the sentinel's ledger_divergence


def _divergence_verdicts(tmp_path, diverge):
  from torch_dist_ranks import ledger_divergence_ranks
  return run_world(ledger_divergence_ranks, 2,
                   args=(str(tmp_path / 'led'), diverge),
                   env={'LDDL_LEDGER_REPLICATED': 'collate'})


def test_ledger_divergence_fires_once_per_verdict(tmp_path):
  """Two gloo ranks whose ledgers differ in one collate digest: each
  rank's sentinel fires on the first diverged verdict, not again on the
  same one, and again on the next verdict (a new seq), as
  tests/test_sentinel.py's case does in lddl_tpu."""
  got = _divergence_verdicts(tmp_path, True)
  for r in (0, 1):
    verdicts, fired = got[r]
    assert [v['status'] for v in verdicts] == ['diverged', 'diverged']
    assert verdicts[0]['first']['key'] == [0, 3]
    assert verdicts[0]['seq'] != verdicts[1]['seq']
    assert fired == ['ledger_divergence', None, 'ledger_divergence', None]
  assert got[0][0] == got[1][0]


def test_equal_ledgers_never_fire(tmp_path):
  got = _divergence_verdicts(tmp_path, False)
  for r in (0, 1):
    verdicts, fired = got[r]
    assert [v['status'] for v in verdicts] == ['ok', 'ok']
    assert fired == [None, None, None, None]
