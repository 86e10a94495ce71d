"""The port's live monitor against lddl_tpu's, on the same inputs (CPU).

Every case of tests/test_monitor.py against lddl_tpu_torch. Where a
function is pure (the snapshot deltas, SnapshotWindow, stage rates, the
live verdict, goodput meters, straggler scores, Prometheus text, the
dashboard frame) both packages get the same input and must give the same
output. Beside those:

  - with ``LDDL_MONITOR`` unset the monitor is the shared no-op
    singleton: a serial loader drain and a CPU ``TrainLoop.run`` open no
    socket and start no thread;
  - with it set, one daemon thread serves ``/snapshot`` (the key set of
    lddl_tpu's payload), ``/metrics``, ``/healthz`` and ``/profile``,
    announces itself for discovery and removes the announce on stop;
  - a CPU ``TrainLoop.run`` starts the monitor itself, answers a scraper
    all through the run, serves the JAX loop's ``train.*`` names, and an
    HTTP ``/profile?steps=2`` makes the loop write one trace;
  - ``python -m lddl_tpu_torch.telemetry.monitor`` (its ``main``) with
    ``--once``, ``--json``, ``--dir``, ``--url`` and ``--profile``.
"""

import json
import math
import multiprocessing as mp
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from lddl_tpu.telemetry import diff_snapshot_lines as jax_diff
from lddl_tpu.telemetry import live as jlive
from lddl_tpu.telemetry import monitor as jmonitor
from lddl_tpu.telemetry import server as jserver
from lddl_tpu.telemetry.report import merge_metric_lines as jax_merge
from lddl_tpu_torch import telemetry as ttele
from lddl_tpu_torch.telemetry import Telemetry, diff_snapshot_lines, enable
from lddl_tpu_torch.telemetry import monitor as tmonitor
from lddl_tpu_torch.telemetry import profiling as tprofiling
from lddl_tpu_torch.telemetry import roofline as troofline
from lddl_tpu_torch.telemetry.live import (SnapshotWindow, goodput_meters,
                                           live_status, live_verdict,
                                           rank_signals, stage_rates,
                                           straggler_scores)
from lddl_tpu_torch.telemetry.report import merge_metric_lines
from lddl_tpu_torch.telemetry.server import (NOOP_MONITOR, get_monitor,
                                             maybe_start_monitor,
                                             prometheus_lines, stop_monitor)
from torch_live_procs import straggler_rank
from torch_threads import torch_one_thread_a_file  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The monitor makes no shared-memory segment; the shared fixture would
  # count other xdist workers' rings as this test's leak.
  yield


@pytest.fixture(autouse=True)
def _monitor_off(monkeypatch):
  for k in ('LDDL_MONITOR', 'LDDL_MONITOR_DIR', 'LDDL_TELEMETRY_DIR'):
    monkeypatch.delenv(k, raising=False)
  stop_monitor()
  yield
  stop_monitor()
  jserver.stop_monitor()
  ttele.disable()
  tprofiling._reset_for_tests()
  troofline._reset_for_tests()


def _meta(monotonic, rank=0):
  return {'kind': 'meta', 'rank': rank, 'pid': 1,
          'unix_time': 1e9 + monotonic, 'monotonic': monotonic}


def _counter(name, total, rank=0):
  return {'kind': 'counter', 'rank': rank, 'name': name, 'total': total}


def _hist(name, count, total_sec, rank=0, buckets=None):
  return {'kind': 'histogram', 'rank': rank, 'name': name, 'count': count,
          'sum': total_sec, 'min': 0.001, 'max': 1.0,
          'buckets': buckets or {'-1': count}}


def _gauge(name, value, rank=0):
  return {'kind': 'gauge', 'rank': rank, 'name': name, 'value': value,
          'min': value, 'max': value, 'mean': value, 'count': 1}


def _diff(old, new):
  """The port's delta, held equal to lddl_tpu's on the same captures."""
  d = diff_snapshot_lines(old, new)
  assert d == jax_diff(old, new)
  return d


def _windows(*captures, capacity=12):
  """The same captures pushed into both packages' windows."""
  port, ref = SnapshotWindow(capacity), jlive.SnapshotWindow(capacity)
  for lines in captures:
    port.push(lines)
    ref.push(lines)
  return port, ref


# ---------------------------------------------------------------------------
# snapshot deltas


class TestDiffSnapshotLines:

  def test_counter_and_window(self):
    d = _diff([_meta(100.0), _counter('loader.rows', 10)],
              [_meta(110.0), _counter('loader.rows', 70)])
    meta = next(l for l in d if l['kind'] == 'meta')
    assert meta['window_sec'] == pytest.approx(10.0)
    assert next(l for l in d if l['kind'] == 'counter')['total'] == 60

  def test_new_metric_diffs_against_zero(self):
    d = _diff([_meta(0.0)], [_meta(5.0), _counter('train.steps', 7)])
    assert next(l for l in d if l['kind'] == 'counter')['total'] == 7

  def test_gauge_passes_through_latest(self):
    d = _diff([_meta(0.0), _gauge('loader.queue_depth', 3.0)],
              [_meta(5.0), _gauge('loader.queue_depth', 8.0)])
    assert next(l for l in d if l['kind'] == 'gauge')['value'] == 8.0

  def test_histogram_subtracts(self):
    old = [_meta(0.0),
           _hist('train.compute_seconds', 4, 2.0, buckets={'-1': 4})]
    new = [_meta(2.0),
           _hist('train.compute_seconds', 10, 5.0,
                 buckets={'-1': 7, '0': 3})]
    h = next(l for l in _diff(old, new) if l['kind'] == 'histogram')
    assert h['count'] == 6 and h['sum'] == pytest.approx(3.0)
    assert h['buckets'] == {'-1': 3, '0': 3}

  def test_empty_window_histogram_drops_envelope(self):
    lines = [_meta(0.0), _hist('x', 5, 1.0)]
    h = next(l for l in _diff(lines, [_meta(1.0)] + lines[1:])
             if l['kind'] == 'histogram')
    assert h['count'] == 0 and 'min' not in h and 'max' not in h

  def test_negative_delta_reanchors_at_restart(self):
    d = _diff([_meta(10.0), _counter('c', 100)],
              [_meta(5.0), _counter('c', 2)])
    meta = next(l for l in d if l['kind'] == 'meta')
    assert meta['window_sec'] == 0.0  # clocks from different boots
    c = next(l for l in d if l['kind'] == 'counter')
    assert c['total'] == 2 and c['reset'] is True

  def test_histogram_reset_reanchors(self):
    d = _diff([_meta(0.0), _hist('h', count=50, total_sec=5.0)],
              [_meta(10.0), _hist('h', count=3, total_sec=0.3)])
    h = next(l for l in d if l['kind'] == 'histogram')
    assert h['count'] == 3 and h['reset'] is True
    assert h['sum'] == pytest.approx(0.3)

  def test_restarted_rank_rate_stays_finite(self):
    w, ref = _windows([_meta(0.0), _counter('pipeline.encode.tasks', 1000)],
                      [_meta(10.0), _counter('pipeline.encode.tasks', 20)])
    sig = rank_signals(w)
    assert sig == jlive.rank_signals(ref)
    assert sig['tasks_per_sec'] == pytest.approx(2.0)
    scores = straggler_scores({0: sig, 1: {'tasks_per_sec': 4.0}})
    assert all(math.isfinite(s) for s in scores['scores'].values())


class TestSnapshotWindow:

  def test_capacity_validated(self):
    with pytest.raises(ValueError):
      SnapshotWindow(capacity=1)

  def test_delta_needs_two_samples(self):
    w = SnapshotWindow()
    assert w.delta() is None and w.window_sec() == 0.0
    w.push([_meta(0.0), _counter('c', 1)])
    assert w.delta() is None

  def test_sliding_window(self):
    w, ref = _windows(*[[_meta(float(i)), _counter('c', total)]
                        for i, total in enumerate((0, 10, 30, 60))],
                      capacity=3)
    assert w.delta() == ref.delta()
    assert w.window_sec() == pytest.approx(2.0)
    assert next(l for l in w.delta()
                if l['kind'] == 'counter')['total'] == 50

  def test_sample_captures_live_registry(self):
    tele = enable()
    c = tele.counter('loader.rows')
    w = SnapshotWindow()
    c.add(5)
    w.sample(rank=0)
    c.add(7)
    w.sample(rank=0)
    row_line = next(l for l in w.delta() if l.get('name') == 'loader.rows')
    assert row_line['total'] == 7  # only the in-window events
    assert w.window_sec() >= 0.0


# ---------------------------------------------------------------------------
# streaming verdict + rates

_VERDICT_KEYS = ('stages', 'bottleneck', 'detail', 'window_sec', 'serve',
                 'determinism')


def _same_verdict(port_window, ref_window):
  got, want = live_verdict(port_window), jlive.live_verdict(ref_window)
  assert {k: got[k] for k in _VERDICT_KEYS} == {
      k: want[k] for k in _VERDICT_KEYS}
  return got


class TestLiveVerdict:

  def test_warming_up(self):
    v = _same_verdict(SnapshotWindow(), jlive.SnapshotWindow())
    assert 'warming up' in v['bottleneck']

  def test_data_bound_verdict_matches_offline_logic(self):
    w, ref = _windows(
        [_meta(0.0), _hist('train.data_wait_seconds', 10, 1.0),
         _hist('train.compute_seconds', 10, 9.0)],
        [_meta(10.0), _hist('train.data_wait_seconds', 20, 5.0),
         _hist('train.compute_seconds', 20, 10.0)])
    v = _same_verdict(w, ref)
    assert v['bottleneck'].startswith('loader')
    assert v['window_sec'] == pytest.approx(10.0)
    # No compiler cost counters in the port: the roofline says why.
    assert v['roofline']['bound'].startswith('unknown')

  def test_stage_rates(self):
    w, ref = _windows(
        [_meta(0.0), _counter('loader.rows', 0),
         _hist('loader.collate_seconds.s128', 0, 0.0, buckets={})],
        [_meta(4.0), _counter('loader.rows', 100),
         _hist('loader.collate_seconds.s128', 8, 2.0)])
    r = stage_rates(w)
    assert r == jlive.stage_rates(ref)
    assert r['loader.rows'] == pytest.approx(25.0)
    assert r['loader.collate_seconds.s128.rate'] == pytest.approx(2.0)
    assert r['loader.collate_seconds.s128.mean'] == pytest.approx(0.25)


def _meters(lines):
  got = goodput_meters(merge_metric_lines([lines]))
  assert got == jlive.goodput_meters(jax_merge([lines]))
  return got


class TestGoodputMeters:

  def test_padding_efficiency_per_bin(self):
    g = _meters([_meta(0.0),
                 _counter('loader.tokens_real.s128', 900),
                 _counter('loader.tokens_padded.s128', 1280),
                 _counter('loader.tokens_real.s512', 100),
                 _counter('loader.tokens_padded.s512', 720)])
    assert g['padding_efficiency'] == pytest.approx(1000 / 2000)
    assert g['padding_efficiency_per_bin']['s128'] == pytest.approx(
        900 / 1280)
    assert g['tokens_real'] == 1000 and g['tokens_padded'] == 2000

  def test_step_cache_and_overlap(self):
    g = _meters([_meta(0.0),
                 _counter('train.step_cache_hits', 9),
                 _counter('train.step_cache_misses', 1),
                 _hist('train.h2d_seconds', 10, 10.0),
                 _hist('train.data_wait_seconds', 10, 2.0),
                 _counter('serve.batches_served', 4),
                 _gauge('hbm.headroom_frac', 0.5)])
    assert g['step_cache_hit_rate'] == pytest.approx(0.9)
    assert g['h2d_overlap_fraction'] == pytest.approx(0.8)
    assert g['serve']['batches_served'] == 4
    assert g['hbm']['headroom_frac']['mean'] == 0.5

  def test_uninstrumented_meters_are_none(self):
    g = _meters([_meta(0.0)])
    assert g['padding_efficiency'] is None
    assert g['step_cache_hit_rate'] is None
    assert g['h2d_overlap_fraction'] is None
    assert g['queue_depth'] is None

  def test_backpressure_gauges(self):
    g = _meters([_meta(0.0),
                 _gauge('loader.queue_depth', 4.0),
                 _gauge('loader.shm_slot_occupancy', 2.0)])
    assert g['queue_depth']['mean'] == pytest.approx(4.0)
    assert g['shm_slot_occupancy']['max'] == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# straggler scores


def _window_with_tasks(tasks, span=10.0, rank=0):
  return _windows([_meta(0.0, rank), _counter('pipeline.encode.tasks', 0,
                                              rank)],
                  [_meta(span, rank),
                   _counter('pipeline.encode.tasks', tasks, rank)])


def _scores(per_rank):
  got = straggler_scores(per_rank)
  assert got == jlive.straggler_scores(per_rank)
  return got


class TestStragglerScores:

  def test_rank_signals_from_window(self):
    w, ref = _window_with_tasks(50)
    sig = rank_signals(w)
    assert sig == jlive.rank_signals(ref)
    assert sig['tasks_per_sec'] == pytest.approx(5.0)
    assert sig['writes_per_sec'] is None

  def test_deterministic_scores_name_the_slow_rank(self):
    per_rank = {0: rank_signals(_window_with_tasks(100)[0]),
                1: rank_signals(_window_with_tasks(20, rank=1)[0])}
    result = _scores(per_rank)
    assert result['scores'][1] == pytest.approx(3.0)
    assert result['scores'][0] == pytest.approx(0.6)
    assert result['slowest'] == 1
    assert straggler_scores(per_rank) == result

  def test_single_rank_signal_has_no_fleet_comparison(self):
    result = _scores({0: {'tasks_per_sec': 5.0, 'steps_per_sec': None}})
    assert result['scores'] == {0: 1.0} and result['slowest'] is None

  def test_stalled_rank_scores_inf(self):
    result = _scores({0: {'tasks_per_sec': 10.0},
                      1: {'tasks_per_sec': 10.0},
                      2: {'tasks_per_sec': 0.0}})
    assert math.isinf(result['scores'][2])
    assert result['slowest'] == 2

  def test_balanced_fleet_flags_nobody(self):
    result = _scores({0: {'tasks_per_sec': 10.0}, 1: {'tasks_per_sec': 10.0}})
    assert result['slowest'] is None
    assert result['scores'] == {0: 1.0, 1: 1.0}


def test_two_rank_skewed_straggler_names_slow_rank(tmp_path):
  """Two spawned ranks over the port's FileBackend: both compute the
  same table over one collective round and export the slow rank's
  score."""
  ctx = mp.get_context('spawn')
  q = ctx.Queue()
  procs = [ctx.Process(target=straggler_rank,
                       args=(r, str(tmp_path / 'rdzv'), q))
           for r in range(2)]
  for p in procs:
    p.start()
  results = {}
  deadline = time.monotonic() + 120
  try:
    while len(results) < 2 and time.monotonic() < deadline:
      try:
        rank, err, payload = q.get(timeout=5)
      except Exception:
        continue
      assert err is None, f'rank {rank} failed:\n{err}'
      results[rank] = payload
  finally:
    for p in procs:
      p.join(timeout=30)
      if p.is_alive():
        p.kill()
        p.join(timeout=10)
  assert len(results) == 2
  assert results[0]['scores'] == results[1]['scores']
  assert results[0]['slowest'] == results[1]['slowest'] == 1
  assert results[0]['scores'][1] == pytest.approx(3.0)
  assert results[0]['scores'][0] == pytest.approx(0.6)
  assert results[0]['mismatch'] is None
  assert results[0]['seq'] == results[1]['seq'] is not None
  assert results[0]['exported_rank1'] == pytest.approx(3.0)


# ---------------------------------------------------------------------------
# no-op discipline (LDDL_MONITOR unset)


def _monitor_threads():
  return [t for t in threading.enumerate()
          if t.name.startswith('lddl-monitor')]


def _port_loop():
  from test_torch_telemetry import _port_loop as make
  return make()


class TestNoopDiscipline:

  def test_unset_gate_resolves_to_shared_singleton(self, monkeypatch):
    monkeypatch.delenv('LDDL_MONITOR', raising=False)
    stop_monitor()
    assert get_monitor() is NOOP_MONITOR
    assert maybe_start_monitor(rank=3) is NOOP_MONITOR
    assert not get_monitor().enabled

  def test_explicit_off_values(self, monkeypatch):
    for off in ('0', 'false', 'off', 'no'):
      monkeypatch.setenv('LDDL_MONITOR', off)
      stop_monitor()
      assert get_monitor() is NOOP_MONITOR
    stop_monitor()

  def test_loader_and_train_loop_spawn_no_threads_or_sockets(
      self, monkeypatch):
    """With LDDL_MONITOR unset, a serial loader drain over the committed
    shards and a CPU TrainLoop.run (which calls maybe_start_monitor)
    open no socket and leave no thread."""
    monkeypatch.delenv('LDDL_MONITOR', raising=False)
    stop_monitor()
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    pairs = ROOT / 'tests' / 'assets' / 'torch_shards' / 'pairs'
    settings = json.loads((pairs.parent / 'digests.json').read_text())[
        'pairs']['settings']

    def _drain():
      loader = get_bert_pretrain_data_loader(
          str(pairs), vocab_file=str(ROOT / 'benchmarks' / 'assets' /
                                     'bench_vocab_30522.txt'), **settings)
      return sum(1 for _ in loader)

    loop = _port_loop()  # built first: torch's one-time imports are not ours
    created = []
    real_socket = socket.socket

    class _RecordingSocket(real_socket):

      def __init__(self, *a, **k):
        created.append((a, k))
        super().__init__(*a, **k)

    monkeypatch.setattr(socket, 'socket', _RecordingSocket)
    threads_before = set(threading.enumerate())
    assert _drain() > 0
    assert len(loop.run(2, log_every=0)) == 2
    assert created == [], 'no sockets may be opened with LDDL_MONITOR unset'
    assert _monitor_threads() == []
    leaked = set(threading.enumerate()) - threads_before
    assert not leaked, f'leaked threads: {leaked}'

  def test_enabled_overhead_is_off_hot_path(self, monkeypatch, tmp_path):
    monkeypatch.setenv('LDDL_MONITOR', '1')
    monkeypatch.setenv('LDDL_MONITOR_DIR', str(tmp_path))
    stop_monitor()
    tele = enable()
    mon = maybe_start_monitor(rank=0)
    assert mon.enabled and mon.url
    c = tele.counter('bench.events')
    t0 = time.monotonic()
    for _ in range(200_000):
      c.add(1)
    elapsed = time.monotonic() - t0
    assert c.total == 200_000
    assert elapsed < 5.0, f'200k events took {elapsed:.2f}s with monitor on'


# ---------------------------------------------------------------------------
# the server (gate set)


def _fetch(url, path):
  with urllib.request.urlopen(url + path, timeout=10) as resp:
    return resp.read().decode('utf-8')


class TestMonitorServer:

  def test_serves_json_and_prometheus(self, monkeypatch, tmp_path):
    monkeypatch.setenv('LDDL_MONITOR', '1')
    monkeypatch.setenv('LDDL_MONITOR_DIR', str(tmp_path))
    stop_monitor()
    tele = enable()
    tele.counter('loader.rows').add(42)
    tele.gauge('loader.queue_depth').set(3.0)
    tele.histogram('train.compute_seconds').observe(0.75)
    mon = maybe_start_monitor(rank=0)
    assert mon.url.startswith('http://127.0.0.1:')
    assert maybe_start_monitor(rank=0) is mon
    assert len(_monitor_threads()) == 1

    assert _fetch(mon.url, '/healthz').strip() == 'ok'

    snap = json.loads(_fetch(mon.url, '/snapshot'))
    assert snap['rank'] == 0 and snap['pid'] == os.getpid()
    names = {l.get('name') for l in snap['metrics']}
    assert 'loader.rows' in names
    assert 'bottleneck' in snap['verdict']

    text = _fetch(mon.url, '/metrics')
    assert '# TYPE lddl_loader_rows_total counter' in text
    assert 'lddl_loader_rows_total 42' in text
    assert 'lddl_loader_queue_depth 3.0' in text
    assert 'lddl_train_compute_seconds_bucket{le="1.0"} 1' in text
    assert 'lddl_train_compute_seconds_bucket{le="+Inf"} 1' in text
    assert 'lddl_train_compute_seconds_count 1' in text

    announce = list(tmp_path.glob('monitor.rank0.pid*.json'))
    assert len(announce) == 1
    info = json.loads(announce[0].read_text())
    assert info['url'] == mon.url
    assert not tmonitor.discover_announcements(str(tmp_path))[0]['dead']
    stop_monitor()
    assert not list(tmp_path.glob('monitor.rank0.pid*.json'))
    assert _monitor_threads() == []

  def test_snapshot_windows_between_scrapes(self, monkeypatch, tmp_path):
    monkeypatch.setenv('LDDL_MONITOR', '1')
    monkeypatch.setenv('LDDL_MONITOR_DIR', str(tmp_path))
    stop_monitor()
    tele = enable()
    c = tele.counter('loader.rows')
    mon = maybe_start_monitor(rank=0)
    c.add(10)
    json.loads(_fetch(mon.url, '/snapshot'))  # first sample
    c.add(30)
    snap = json.loads(_fetch(mon.url, '/snapshot'))
    assert snap['window_samples'] >= 2
    row_rate = snap['rates']['loader.rows']
    assert row_rate * snap['window_sec'] == pytest.approx(30, rel=0.05)

  def test_unix_socket_endpoint(self, monkeypatch, tmp_path):
    sock_path = str(tmp_path / 'mon.sock')
    monkeypatch.setenv('LDDL_MONITOR', sock_path)
    stop_monitor()
    enable().counter('loader.rows').add(5)
    mon = maybe_start_monitor(rank=0)
    assert mon.url == f'unix:{sock_path}.rank0'
    snap = tmonitor.fetch_snapshot(mon.url)
    assert snap['rank'] == 0
    stop_monitor()
    assert not os.path.exists(sock_path + '.rank0')

  def test_unknown_path_is_404(self, monkeypatch, tmp_path):
    monkeypatch.setenv('LDDL_MONITOR', '1')
    monkeypatch.setenv('LDDL_MONITOR_DIR', str(tmp_path))
    stop_monitor()
    enable()
    mon = maybe_start_monitor(rank=0)
    with pytest.raises(urllib.error.HTTPError) as ei:
      _fetch(mon.url, '/nope')
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
      _fetch(mon.url, '/profile?steps=0')
    assert ei.value.code == 400

  def test_prometheus_rendering_pure(self):
    lines = [
        _meta(0.0),
        _counter('pipeline.encode.tasks', 12),
        _gauge('hbm.bytes_limit', 80.0),
        _hist('loader.collate_seconds.s128', 3, 0.9,
              buckets={'zero': 1, '-1': 2}),
    ]
    text = prometheus_lines(lines)
    assert text == jserver.prometheus_lines(lines)
    assert '# TYPE lddl_pipeline_encode_tasks_total counter' in text
    assert 'lddl_pipeline_encode_tasks_total 12' in text
    assert 'lddl_loader_collate_seconds_s128_bucket{le="0.0"} 1' in text
    assert 'lddl_loader_collate_seconds_s128_bucket{le="1.0"} 3' in text
    assert 'lddl_loader_collate_seconds_s128_bucket{le="+Inf"} 3' in text


# ---------------------------------------------------------------------------
# the dashboard CLI (python -m lddl_tpu_torch.telemetry.monitor)


class TestMonitorCli:

  def test_once_json_returns_live_verdict(self, monkeypatch, tmp_path,
                                          capsys):
    monkeypatch.setenv('LDDL_MONITOR', '1')
    monkeypatch.setenv('LDDL_MONITOR_DIR', str(tmp_path))
    stop_monitor()
    tele = enable()
    tele.histogram('train.data_wait_seconds').observe(4.0)
    tele.histogram('train.compute_seconds').observe(1.0)
    maybe_start_monitor(rank=0)
    assert tmonitor.main(['--dir', str(tmp_path), '--once', '--json']) == 0
    fleet = json.loads(capsys.readouterr().out)
    assert list(fleet['ranks']) == ['0']
    assert fleet['verdicts']['0']
    assert fleet['errors'] == {}
    assert fleet['data_servers'] == []

  def test_once_dashboard_renders(self, monkeypatch, tmp_path, capsys):
    monkeypatch.setenv('LDDL_MONITOR', '1')
    monkeypatch.setenv('LDDL_MONITOR_DIR', str(tmp_path))
    stop_monitor()
    enable().counter('loader.rows').add(10)
    mon = maybe_start_monitor(rank=0)
    assert tmonitor.main(['--url', mon.url, '--once']) == 0
    out = capsys.readouterr().out
    assert 'lddl-monitor' in out and 'rank 0' in out and 'verdict:' in out

  def test_profile_arms_every_live_endpoint(self, monkeypatch, tmp_path,
                                            capsys):
    monkeypatch.setenv('LDDL_MONITOR', '1')
    monkeypatch.setenv('LDDL_MONITOR_DIR', str(tmp_path))
    stop_monitor()
    enable()
    mon = maybe_start_monitor(rank=0)
    assert tmonitor.main(['--dir', str(tmp_path), '--profile', '0']) == 2
    assert not tprofiling.get_step_profiler().armed
    assert tmonitor.main(['--dir', str(tmp_path), '--profile', '2']) == 0
    assert f'{mon.url}: armed 2 step(s)' in capsys.readouterr().out
    assert tprofiling.get_step_profiler().armed

  def test_no_endpoints_exits_2(self, tmp_path, capsys):
    assert tmonitor.main(['--dir', str(tmp_path), '--once']) == 2
    assert 'no endpoints found' in capsys.readouterr().err

  def test_no_args_exits_2(self, capsys):
    assert tmonitor.main(['--once']) == 2
    assert 'provide --url' in capsys.readouterr().err


def _fleet():
  """A poll round touching every branch of render_frame."""
  snap = {
      'pid': 7, 'window_sec': 12.5, 'window_samples': 4,
      'verdict': {
          'bottleneck': 'compute (train step)', 'detail': 'd',
          'roofline': {'bound': 'compute-bound', 'flops_per_sec': 3e14,
                       'flops_frac': 0.3, 'bytes_per_sec': 2e12,
                       'bw_frac': 0.6, 'arithmetic_intensity': 150.0,
                       'machine_balance': 295.0, 'detail': 'r'},
          'serve': {'clients': {'mean': 2.0}, 'batches_per_sec': 150.0,
                    'reserves': 1, 'lease_revokes': 2, 'fallbacks': 1,
                    'reattaches': 1, 'backlog': {'mean': 3.5}}},
      'hbm': {'bytes_in_use': 3 << 30, 'peak_bytes_in_use': 5 << 30,
              'bytes_limit': 80 << 30, 'headroom_frac': 0.9375},
      'rates': {'train.steps': 31.25, 'loader.rows': 1234.5,
                'train.step_seconds.rate': 31.0,
                'train.step_seconds.mean': 0.03},
      'goodput': {'padding_efficiency': 0.8, 'step_cache_hit_rate': 0.99,
                  'h2d_overlap_fraction': 0.95,
                  'attn_tile_skip_fraction': 0.5,
                  'mfu': {'mean': 0.42}, 'grad_norm': {'mean': 1.5},
                  'device_live_batches': {'mean': 2.0},
                  'queue_depth': {'mean': 1.0},
                  'fault_tolerance': {'io_retries': 2, 'claims': 0}},
  }
  return {
      'ranks': {0: snap, 1: dict(snap, pid=8)},
      'errors': {'http://127.0.0.1:1': 'refused'},
      'data_servers': [{'url': '127.0.0.1:7077', 'pid': 9, 'dead': False},
                       {'url': '127.0.0.1:7078', 'pid': 10, 'dead': True}],
      'straggler': {'scores': {0: 1.0, 1: 1.5}, 'slowest': 1},
      'determinism': {'status': 'diverged',
                      'first': {'boundary': 'collate',
                                'key': ['epoch=0', 'index=3'],
                                'digests': {0: 'aa', 1: 'bb'}},
                      'boundaries': {'collate': {'status': 'diverged',
                                                 'counts': {0: 4, 1: 4}}}},
      'sentinel': {1: {'triggers': 2,
                       'last': {'detector': 'serve_backlog', 'step': None,
                                'reason': 'serve backlog 300'},
                       'incidents': []}},
  }


def test_render_frame_matches_jax(monkeypatch):
  monkeypatch.setattr(time, 'strftime', lambda fmt: '12:34:56')
  fleet = _fleet()
  got = tmonitor.render_frame(fleet, clear=False)
  assert got == jmonitor.render_frame(fleet, clear=False)
  for part in ('data-server 127.0.0.1:7077', 'serve: 2 client(s)',
               'fallbacks 1', 'rank 1: 1.500  <-- slowest', 'DIVERGED',
               'INCIDENT', 'headroom 93.8%'):
    assert part in got
  assert '7078' not in got  # a dead server is an error, not a listing
  assert tmonitor.render_frame(fleet).startswith('\x1b[2J\x1b[H')


# ---------------------------------------------------------------------------
# live_status end-to-end shape (what /snapshot serializes)


def test_live_status_payload_shape():
  from lddl_tpu.telemetry import Telemetry as JaxTelemetry
  tele, jax_tele = Telemetry(), JaxTelemetry()
  for t in (tele, jax_tele):
    t.counter('loader.rows').add(3)
  status = live_status(SnapshotWindow(), rank=2, telemetry=tele)
  want = jlive.live_status(jlive.SnapshotWindow(), rank=2,
                           telemetry=jax_tele)
  assert set(status) == set(want)
  assert status['rank'] == 2
  assert status['window_samples'] == 1
  assert status['verdict']['bottleneck'].startswith('unknown')
  assert set(status['signals']) == {'tasks_per_sec', 'writes_per_sec',
                                    'rows_per_sec', 'steps_per_sec'}
  assert status['goodput']['padding_efficiency'] is None
  assert status['hbm'] is None  # the CPU: no card memory
  json.dumps(status)


# ---------------------------------------------------------------------------
# the train loop's monitor


class _Gated:
  """A loader whose first batch waits (at most 60 s) for ``ready``."""

  def __init__(self, loader, ready):
    self.batch_size = loader.batch_size
    self._loader, self._ready = loader, ready

  def __iter__(self):
    self._ready.wait(60)
    return iter(self._loader)


def _train_names(snapshot):
  return {l['name'] for l in snapshot['metrics']
          if l['kind'] != 'meta' and l['name'].startswith('train.')}


def test_train_loop_serves_the_jax_loops_train_names(monkeypatch, tmp_path):
  """``TrainLoop.run`` with LDDL_MONITOR set starts the monitor for its
  rank; a scraper polling /snapshot all through the run is always
  answered; ``/profile?steps=2`` (armed over HTTP before the run) makes
  the loop write one torch.profiler trace; the served ``train.*`` names
  are the JAX loop's, the cost-model counters included, and the
  dashboard lists the rank."""
  from lddl_tpu import telemetry as jtele
  from test_torch_telemetry import _jax_loop
  monkeypatch.setenv('LDDL_MONITOR', '1')
  monkeypatch.setenv('LDDL_MONITOR_DIR', str(tmp_path / 'mon'))
  monkeypatch.setenv('LDDL_TELEMETRY_DIR', str(tmp_path / 'tele'))
  monkeypatch.setenv('LDDL_PEAK_TFLOPS', '0.5')

  jtele.enable()
  try:
    jax_loop = _jax_loop()
    jax_loop.run(4, log_every=0)
    want = _train_names(json.loads(_fetch(jserver.get_monitor().url,
                                          '/snapshot')))
  finally:
    jserver.stop_monitor()
    jtele.disable()

  enable()
  loop = _port_loop()
  ready, stop, codes = threading.Event(), threading.Event(), []
  loop.loader = _Gated(loop.loader, ready)

  def scrape():
    # run() starts the monitor itself: wait for its URL, arm the
    # profiler over HTTP, release the loader, then poll all run long.
    for _ in range(1000):
      if get_monitor().url or stop.is_set():
        break
      time.sleep(0.01)
    url = get_monitor().url
    codes.append(json.loads(_fetch(url, '/profile?steps=2'))['armed_steps'])
    ready.set()
    while not stop.is_set():
      try:
        json.loads(_fetch(url, '/snapshot'))
        codes.append(200)
      except (OSError, ValueError) as e:
        codes.append(repr(e))
      stop.wait(0.01)

  scraper = threading.Thread(target=scrape, daemon=True)
  scraper.start()
  try:
    losses = loop.run(4, log_every=0)
  finally:
    stop.set()
    ready.set()
    scraper.join(timeout=30)
  mon = get_monitor()
  assert len(losses) == 4 and codes[0] == 2 and set(codes[1:]) == {200}
  assert mon.enabled and len(_monitor_threads()) == 1
  got = _train_names(json.loads(_fetch(mon.url, '/snapshot')))
  assert got == want
  trace = tprofiling.get_step_profiler().last_trace_dir
  assert trace and os.path.exists(os.path.join(trace, 'trace.json'))
  assert trace.startswith(str(tmp_path / 'tele' / 'profiles'))
  fleet = tmonitor.poll_fleet(
      tmonitor.discover_endpoints(str(tmp_path / 'mon')))
  assert list(fleet['ranks']) == [0] and fleet['errors'] == {}
