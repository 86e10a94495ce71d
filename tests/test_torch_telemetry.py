"""lddl_tpu_torch's telemetry, trace, sentinels, profiler and the hooks of
TrainLoop.run, held against lddl_tpu on the same inputs (CPU).

  - the registry's snapshot lines and the tracer's events equal, apart
    from timestamps, process ids and thread ids, and the trace merge
    gives the same document from the same files;
  - the same loss / grad-norm / data-wait series through both packages'
    Sentinels fires the same detectors at the same steps;
  - the roofline verdict is the same host arithmetic;
  - a tiny-model TrainLoop.run over two bins emits the JAX loop's
    ``train.*`` metric names and trace spans, ``train.xla_flops`` /
    ``train.xla_bytes`` included (the port's step cost model bills them:
    ``tests/test_torch_step_costs.py``);
  - export_telemetry writes both files; an armed StepProfiler writes one
    Chrome trace; sample_hbm reads the caching allocator.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lddl_tpu.telemetry import metrics as jmetrics
from lddl_tpu.telemetry import roofline as jroofline
from lddl_tpu.telemetry import sentinel as jsentinel
from lddl_tpu.telemetry import trace as jtrace
from lddl_tpu_torch import telemetry as ttele
from lddl_tpu_torch.core import faults
from lddl_tpu_torch.telemetry import metrics as tmetrics
from lddl_tpu_torch.telemetry import profiling as tprofiling
from lddl_tpu_torch.telemetry import roofline as troofline
from lddl_tpu_torch.telemetry import sentinel as tsentinel
from lddl_tpu_torch.telemetry import trace as ttrace
from lddl_tpu_torch.training import TrainLoop, export_telemetry

from test_torch_pretrain import CFG, _batch
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


@pytest.fixture(autouse=True)
def _port_switches_off():
  yield
  ttele.disable()
  ttrace.disable_trace()
  tsentinel.disable_sentinel()
  tprofiling._reset_for_tests()
  troofline._reset_for_tests()
  faults.reset()


# ---- registry and tracer ----


def _drive_registry(tele):
  tele.counter('loader.rows').add(3)
  tele.counter('loader.rows').add(4)
  for v in (0.0, 1e-3, 0.25, 3.0, -1.0):
    tele.histogram('train.step_seconds').observe(v)
  with tele.span('train.span'):
    pass
  tele.gauge('train.mfu').set(0.25)
  tele.gauge('train.mfu').set(0.5)
  tele.gauge('never.set')


def _strip_lines(lines):
  out = []
  for line in lines:
    line = dict(line)
    if line['kind'] == 'meta':
      for k in ('pid', 'unix_time', 'monotonic'):
        line.pop(k)
    if line.get('name') == 'train.span':  # a timed span: one observation
      line = {k: line[k] for k in ('kind', 'rank', 'name', 'count')}
    out.append(line)
  return out


def test_snapshot_lines_match_jax(tmp_path):
  j, t = jmetrics.Telemetry(), tmetrics.Telemetry()
  _drive_registry(j)
  _drive_registry(t)
  assert _strip_lines(t.snapshot_lines(rank=2)) == _strip_lines(
      j.snapshot_lines(rank=2))
  path = t.write_jsonl(tmetrics.rank_file_name(str(tmp_path), 2), rank=2)
  assert os.path.basename(path) == os.path.basename(
      jmetrics.rank_file_name(str(tmp_path), 2)) == 'telemetry.rank2.jsonl'
  with open(path) as f:
    assert [json.loads(x)['kind'] for x in f][0] == 'meta'
  with pytest.raises(ValueError, match='already registered'):
    t.counter('train.mfu')


def test_disabled_registry_is_the_shared_noop():
  tele = ttele.disable()
  assert not tele.enabled and tele is tmetrics.NOOP
  assert tele.counter('a') is tele.histogram('b') is tele.gauge('c')
  assert tele.snapshot_lines() == []
  assert ttele.enable().enabled


def _drive_tracer(tr):
  tr.complete('train.data_wait', 1.0, 0.25, args={'step': 0})
  tr.complete('comm.barrier', 2.0, 0.5, tid=7, args={'seq': 1})
  tr.instant('loader.epoch', args={'epoch': 1})
  tr.counter('train.samples_per_sec', 12.5)
  with tr.span('train.h2d'):
    pass


def _strip_events(events):
  return [{k: v for k, v in e.items() if k not in ('ts', 'dur', 'tid')}
          for e in events]


def test_tracer_events_and_merge_match_jax(tmp_path):
  j = jtrace.Tracer(max_events=16, rank=1, flush_interval=1e9)
  t = ttrace.Tracer(max_events=16, rank=1, flush_interval=1e9)
  _drive_tracer(j)
  _drive_tracer(t)
  assert _strip_events(t.event_dicts()) == _strip_events(j.event_dicts())
  assert [e['ts'] for e in t.event_dicts()[:2]] == [1.0, 2.0]
  # The same files on disk merge into the same Chrome-trace document.
  t.write_jsonl(ttrace.trace_file_name(str(tmp_path), 1), rank=1)
  j.write_jsonl(jtrace.trace_file_name(str(tmp_path), 0), rank=0)
  got = ttrace.merge_trace_files(ttrace.load_trace_files(str(tmp_path)))
  want = jtrace.merge_trace_files(jtrace.load_trace_files(str(tmp_path)))
  assert got == want
  assert {e['name'] for e in got['traceEvents']} >= {'train.data_wait',
                                                     'train.h2d'}


def test_tracer_ring_is_bounded_and_gated(monkeypatch):
  t = ttrace.Tracer(max_events=4, flush_interval=1e9)
  for i in range(10):
    t.counter('c', i)
  assert [e['value'] for e in t.event_dicts()] == [6.0, 7.0, 8.0, 9.0]
  ttrace.disable_trace()
  assert ttrace.get_tracer() is ttrace.NOOP_TRACER
  assert ttrace.enable_trace(max_events=2).enabled


# ---- sentinels ----

_SENTINEL_KW = dict(window=16, warmup=5, z_threshold=6.0, min_rel=0.3,
                    stall_sec=2.0, cooldown=3)


def _series():
  """Loss, grad norm and data wait per step: a noisy baseline, then a
  loss spike, a grad spike, a stall, a NaN loss and an inf grad norm."""
  rng = np.random.default_rng(3)
  out = []
  for step in range(40):
    loss = 3.0 - 0.01 * step + 0.02 * rng.standard_normal()
    grad = 1.0 + 0.05 * rng.standard_normal()
    wait = 0.01
    if step == 12:
      loss *= 4
    if step == 20:
      grad *= 10
    if step == 26:
      wait = 5.0
    if step == 31:
      loss = float('nan')
    if step == 36:
      grad = float('inf')
    out.append((step, loss, grad, wait))
  return out


def _fires(sentinel):
  fired = []
  for step, loss, grad, wait in _series():
    trig = sentinel.observe_step(step, loss=loss, grad_norm=grad,
                                 data_wait=wait)
    if trig is not None:
      fired.append((trig['step'], trig['detector'], trig['reason']))
  return fired


def test_sentinel_fires_what_jax_fires():
  detectors = ('nonfinite_loss', 'loss_spike', 'grad_spike', 'data_stall')
  got = _fires(tsentinel.Sentinel(detectors=detectors, **_SENTINEL_KW))
  want = _fires(jsentinel.Sentinel(detectors=detectors, **_SENTINEL_KW))
  assert got == want
  assert [(s, d) for s, d, _ in got] == [
      (12, 'loss_spike'), (20, 'grad_spike'), (26, 'data_stall'),
      (31, 'nonfinite_loss'), (36, 'grad_spike')]


def test_sentinel_serve_backlog_fires_what_jax_fires():
  """The data server's producer feeds its backlog gauge to the sentinel:
  both packages fire on the same sequence (at the threshold, once per
  excursion, re-armed below half of it) and report the same status."""
  backlogs = [1, 2, 4, 8, 8, 3, 2, 7, 8, 9, 8, 4, 1, 8]
  got, want = [], []
  port = tsentinel.Sentinel(detectors=('serve_backlog',), backlog_max=8)
  ref = jsentinel.Sentinel(detectors=('serve_backlog',), backlog_max=8)
  for i, b in enumerate(backlogs):
    for sent, out in ((port, got), (ref, want)):
      trig = sent.observe_backlog(b)
      if trig is not None:
        out.append((i, trig['detector'], trig['reason'], trig['value']))
  assert got == want
  assert [i for i, *_ in got] == [3, 8, 13]
  status = {k: v for k, v in port.status().items() if k != 'last'}
  assert status == {k: v for k, v in ref.status().items() if k != 'last'}
  assert status['triggers'] == 3
  assert tsentinel.Sentinel(detectors=('loss_spike',)).observe_backlog(
      999) is None
  assert tsentinel.NOOP_SENTINEL.observe_backlog(999) is None
  tsentinel.disable_sentinel()
  assert tsentinel.sentinel_status() is None


def test_sentinel_hbm_headroom_on_the_card_only(monkeypatch):
  sent = tsentinel.Sentinel(detectors=('hbm_headroom',), hbm_every=1,
                            headroom_min=0.5)
  assert sent.observe_step(0, loss=1.0) is None  # the CPU: no card memory
  troofline._reset_for_tests()
  _fake_card(monkeypatch, reserved_peak=60 << 30, total=80 << 30)
  trig = sent.observe_step(1, loss=1.0)
  assert trig['detector'] == 'hbm_headroom' and trig['value'] == 0.25


def test_sentinel_gate_and_detectors(monkeypatch):
  monkeypatch.setenv('LDDL_SENTINEL', '1')
  tsentinel.disable_sentinel()
  tsentinel._active = None
  assert tsentinel.get_sentinel().detectors == tsentinel.DETECTORS
  assert tsentinel.DETECTORS == jsentinel.DETECTORS
  for spec in ('0', '', 'off'):
    assert tsentinel._parse_spec(spec) is None
  assert tsentinel.Sentinel(detectors=('ledger_divergence',)).detectors == (
      'ledger_divergence',)
  with pytest.raises(ValueError, match='no_such_detector'):
    tsentinel.Sentinel(detectors=('no_such_detector',))
  monkeypatch.setenv('LDDL_FAULTS', 'raise:sentinel.trigger:nth=2')
  sent = tsentinel.Sentinel(detectors=('loss_spike',))
  assert sent.observe_step(0, loss=1.0) is None
  assert sent.observe_step(1, loss=1.0)['detector'] == 'injected'


# ---- roofline ----


def _merged(flops, nbytes, wait, compute):
  return {'metrics': {
      'train.xla_flops': {'kind': 'counter', 'total': flops},
      'train.xla_bytes': {'kind': 'counter', 'total': nbytes},
      'train.data_wait_seconds': {'kind': 'histogram', 'sum': wait},
      'train.compute_seconds': {'kind': 'histogram', 'sum': compute}}}


@pytest.mark.parametrize('flops,nbytes,wait,compute', [
    (4e15, 1e12, 0.1, 2.0), (1e14, 1e12, 0.1, 2.0), (1e14, 1e12, 3.0, 1.0),
    (0, 0, 0.0, 1.0), (1e14, 0, 0.0, 1.0)])
def test_roofline_verdict_matches_jax(flops, nbytes, wait, compute):
  peaks = {'flops_per_sec': 989e12, 'hbm_bytes_per_sec': 3.35e12,
           'balance': 989e12 / 3.35e12}
  merged = _merged(flops, nbytes, wait, compute)
  got = troofline.roofline_verdict(merged, 2.0, peaks=peaks)
  want = jroofline.roofline_verdict(merged, 2.0, peaks=peaks)
  if not flops:  # the port's "unknown" names why differently
    assert got['bound'].startswith('unknown') and want['bound'].startswith(
        'unknown')
    got.pop('bound'), want.pop('bound')
  assert got == want
  if flops:
    assert troofline.bound_class(merged, 2.0, peaks) == want['bound']


def test_resolve_peaks_takes_the_overrides(monkeypatch):
  monkeypatch.setenv('LDDL_PEAK_TFLOPS', '989')
  monkeypatch.setenv('LDDL_PEAK_HBM_GBPS', '3350')
  peaks = troofline.resolve_peaks(refresh=True)
  assert peaks['flops_per_sec'] == 989e12
  assert peaks['hbm_bytes_per_sec'] == 3350e9
  assert peaks['balance'] == pytest.approx(989e12 / 3350e9)
  assert peaks['device_kind'] == 'cpu' and peaks['local_devices'] == 1


def _fake_card(monkeypatch, reserved_peak, total, reserved=None):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
  monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
  monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
  monkeypatch.setattr(torch.cuda, 'memory_stats', lambda i: {
      'reserved_bytes.all.current': reserved or reserved_peak // 2,
      'reserved_bytes.all.peak': reserved_peak})
  monkeypatch.setattr(torch.cuda, 'mem_get_info', lambda i: (1, total))


def test_sample_hbm_reads_the_caching_allocator(monkeypatch):
  assert troofline.sample_hbm() is None  # the CPU: probed once, then None
  troofline._reset_for_tests()
  tele = ttele.enable()
  _fake_card(monkeypatch, reserved_peak=20 << 30, total=80 << 30,
             reserved=10 << 30)
  got = troofline.sample_hbm()
  assert got == {'bytes_in_use': 10 << 30, 'peak_bytes_in_use': 20 << 30,
                 'bytes_limit': 80 << 30, 'headroom_frac': 0.75,
                 'devices': 1}
  assert tele.gauge('hbm.headroom_frac').value == 0.75
  assert tele.gauge('hbm.bytes_limit').value == 80 << 30


# ---- TrainLoop.run against the JAX loop ----


class _TwoBins:
  """Bins 64 and 128 in alternation, four batches, numpy dicts."""

  batch_size = 4

  def __init__(self):
    self.batches = [_batch(64 if i % 2 == 0 else 128, i) for i in range(4)]

  def __iter__(self):
    return iter(self.batches)


def _jax_loop():
  from lddl_tpu.models import BertConfig
  from lddl_tpu.parallel import make_mesh
  from lddl_tpu.training.pretrain import TrainLoop as JaxLoop
  cfg = BertConfig(vocab_size=CFG.vocab_size, hidden_size=32, num_layers=1,
                   num_heads=2, intermediate_size=64,
                   max_position_embeddings=128, dropout_rate=0.0,
                   dtype=jnp.float32)
  loop = JaxLoop.build(None, None, model_cfg=cfg,
                       mesh=make_mesh(devices=jax.devices()[:1]),
                       learning_rate=1e-3, warmup_steps=2, total_steps=8,
                       max_seq_length=128, seed=5)
  loop.loader = _TwoBins()
  return loop


def _port_loop():
  loop = TrainLoop.build(model_cfg=CFG, device='cpu', learning_rate=1e-3,
                         warmup_steps=2, total_steps=8, seed=5)
  loop.loader = _TwoBins()
  return loop


def _names_of_a_run(make_loop, tele_mod, trace_mod):
  tele = tele_mod.enable()
  tracer = trace_mod.enable_trace(flush_interval=1e9)
  loop = make_loop()
  losses = loop.run(4, log_every=0)
  assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
  names = {line['name'] for line in tele.snapshot_lines()
           if line['kind'] != 'meta' and line['name'].startswith('train.')}
  spans = {e['name'] for e in tracer.event_dicts()}
  tele_mod.disable()
  trace_mod.disable_trace()
  return names, spans, tele, loop


def test_run_emits_the_jax_loops_train_names(monkeypatch):
  from lddl_tpu import telemetry as jtele
  monkeypatch.setenv('LDDL_PEAK_TFLOPS', '0.5')
  want, want_spans, _, _ = _names_of_a_run(_jax_loop, jtele, jtrace)
  got, got_spans, tele, loop = _names_of_a_run(_port_loop, ttele, ttrace)
  assert {'train.xla_flops', 'train.xla_bytes'} <= want
  assert got == want
  assert got_spans == want_spans
  assert tele.counter('train.steps').total == 4
  assert tele.counter('train.step_cache_misses').total == 2
  assert tele.counter('train.step_cache_hits').total == 2
  assert tele.histogram('train.h2d_seconds').count == 4
  mfu = tele.gauge('train.mfu')
  assert mfu.count == 4 and mfu.value > 0
  # Two bins, a miss and a hit each: every step bills its bin's count.
  counts = loop.step_cache._costs.values()
  assert len(counts) == 2
  assert tele.counter('train.xla_flops').total == sum(
      2 * c.bill()[0] for c in counts)
  assert tele.counter('train.xla_bytes').total == sum(
      2 * c.bill()[1] for c in counts)
  assert loop.step_cache.last_costs in [c.bill() for c in counts]


def test_run_counts_attention_tiles_of_packed_batches(monkeypatch):
  from test_torch_pretrain import _PackedLoader
  tele = ttele.enable()
  loop = TrainLoop.build(model_cfg=CFG, device='cpu', learning_rate=1e-3,
                         warmup_steps=2, total_steps=6, seed=5,
                         max_predictions=40, max_seq_length=128)
  loop.loader = _PackedLoader(2)
  loop.run(2, log_every=0)
  from lddl_tpu_torch.ops.flash_attention import count_skippable_tiles
  want = np.sum([count_skippable_tiles(b['segment_ids'], head_dim=32)
                 for b in loop.loader.batches], axis=0)
  assert (tele.counter('train.attn_tiles_total').total,
          tele.counter('train.attn_tiles_skipped').total) == tuple(want)


def test_export_telemetry_writes_both_files(monkeypatch, tmp_path):
  monkeypatch.setenv('LDDL_PEAK_TFLOPS', '0.5')
  monkeypatch.setenv('LDDL_TELEMETRY_DIR', str(tmp_path))
  ttele.enable()
  ttrace.enable_trace(flush_interval=1e9)
  loop = _port_loop()
  loop.run(3, log_every=0)
  paths = export_telemetry()
  assert sorted(os.path.basename(p) for p in paths) == [
      'telemetry.rank0.jsonl', 'trace.rank0.jsonl']
  with open(tmp_path / 'telemetry.rank0.jsonl') as f:
    lines = {x['name']: x for x in map(json.loads, f) if x['kind'] != 'meta'}
  assert lines['train.step_cache_misses']['total'] == 2
  assert lines['train.step_cache_hits']['total'] == 1
  assert lines['train.mfu']['count'] == 3
  events = ttrace.load_trace_files(str(tmp_path))[0][1]
  assert [e['args']['step'] for e in events
          if e['name'] == 'train.compute'] == [0, 1, 2]
  monkeypatch.delenv('LDDL_TELEMETRY_DIR')
  assert export_telemetry() == []


def test_armed_profiler_writes_one_trace(tmp_path):
  prof = tprofiling.get_step_profiler()
  assert not prof.armed and prof.on_step() is None
  assert prof.arm(2, out_dir=str(tmp_path)) == str(tmp_path)
  loop = _port_loop()
  loop.run(4, log_every=0)
  assert not prof.armed
  captures = sorted(os.listdir(tmp_path))
  assert captures == ['capture0000']
  with open(tmp_path / 'capture0000' / 'trace.json') as f:
    assert json.load(f)['traceEvents']
  prof.close()  # idempotent


def test_profiler_close_writes_an_unfinished_capture(tmp_path):
  prof = tprofiling.StepProfiler()
  prof.arm(10, out_dir=str(tmp_path))
  prof.on_step()
  torch.ones(3).sum()
  prof.close()
  assert os.path.isfile(tmp_path / 'capture0000' / 'trace.json')
  with tprofiling.trace_capture(str(tmp_path / 'region')):
    torch.ones(3).sum()
  assert os.path.isfile(tmp_path / 'region' / 'trace.json')
  with tprofiling.trace_capture(None) as d:
    assert d is None


def test_fault_at_train_step_raises_at_that_step(monkeypatch):
  monkeypatch.setenv('LDDL_FAULTS', 'raise:train.step:nth=3')
  loop = _port_loop()
  with pytest.raises(OSError, match='injected fault at train.step'):
    loop.run(4, log_every=0)
  assert loop.step == 2
