"""lddl_tpu_torch's step cost model (``telemetry/step_costs.py``) on the
CPU, held against lddl_tpu where lddl_tpu has a counterpart.

XLA's cost analysis on the CPU is no oracle for the port's count (it
leaves out part of the model's program, and every Pallas custom call), so
the FLOP oracle is the JAX package's analytic
``lddl_tpu.models.flops.bert_pretrain_flops_per_step``:

  - single ops: ``addmm`` counts ``2mnk`` FLOPs and ``(mk + kn + n + mn)``
    elements of bytes, a view nothing, ``add_`` two reads and a write;
  - the tiny dense step's matmul FLOPs equal the analytic count plus the
    NSP head's ``2·b·d·2·3``, exactly;
  - the flash step counts the dense step's FLOPs plus the kernels'
    recompute (dq's 3 and dkv's 4 products against the backward's 2 of
    the dense path), and the wrappers bill the same count and bytes when
    they launch a kernel (a stand-in launcher here) as on the plain path;
  - a packed batch is billed its own attention tiles;
  - a counted step is bit-equal to an uncounted one;
  - the step cache bills a miss and every hit, and nothing with
    telemetry off;
  - both packages' verdicts agree on a port run's merged metrics, and the
    port's ``compiled_step_costs`` keeps the reference's contract.
"""

import functools

import pytest
import torch

from lddl_tpu.models import BertConfig as JaxConfig
from lddl_tpu.models.flops import bert_pretrain_flops_per_step as jax_flops
from lddl_tpu.telemetry import roofline as jroofline
from lddl_tpu_torch import telemetry as ttele
from lddl_tpu_torch.models import BertConfig, BertForPretraining
from lddl_tpu_torch.ops import flash_attention as tfa
from lddl_tpu_torch.parallel import train as ttrain
from lddl_tpu_torch.telemetry import roofline as troofline
from lddl_tpu_torch.telemetry.report import merge_metric_lines
from lddl_tpu_torch.telemetry.step_costs import StepCostCounter, StepCosts
from lddl_tpu_torch.training import CompiledStepCache, TrainLoop

from test_torch_train import _batch, _packed_batch
from torch_threads import torch_one_thread_a_file  # noqa: F401

# The tiny dense step of the JAX package's tests, float32.
TINY = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=512)
B, S = 8, 128
HEAD_DIM = TINY['hidden_size'] // TINY['num_heads']
KERNELS = ('fwd', 'dq', 'dkv')


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


@pytest.fixture(autouse=True)
def _port_telemetry_off():
  yield
  ttele.disable()


def _cfg(impl, **kw):
  return BertConfig(dtype=torch.float32, attention_impl=impl,
                    max_position_embeddings=256, **TINY, **kw)


def _step(impl='flash', max_predictions=None, seed=5, **kw):
  model = BertForPretraining(_cfg(impl, **kw))
  model.reset_parameters(torch.Generator().manual_seed(seed))
  opt = ttrain.AdamW(model.parameters(), functools.partial(
      ttrain.learning_rate, peak=1e-3, warmup_steps=2, total_steps=6))
  return ttrain.TrainStep(model, opt, max_predictions)


def _tensors(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _nsp(b=B):
  return 2 * b * TINY['hidden_size'] * 2 * 3


def _recompute(b=B, s=S):
  # dq's 3 and dkv's 4 products of s x s x d against the dense backward's
  # 4 (twice the forward's 2), over every pair, per layer.
  return 2 * 3 * b * s * s * TINY['hidden_size'] * TINY['num_layers']


def count_step(fn, *args):
  """``(fn(*args), its StepCosts)``."""
  with StepCostCounter() as counter:
    result = fn(*args)
  return result, counter.costs


# ---- single ops ----


def _count(fn):
  return count_step(fn)[1]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_addmm_counts_2mnk_flops_and_its_operands(dtype):
  m, k, n = 7, 5, 3
  bias, a, b = (torch.ones(shape, dtype=dtype)
                for shape in ((n,), (m, k), (k, n)))
  costs = _count(lambda: torch.addmm(bias, a, b))
  elt = torch.finfo(dtype).bits // 8
  assert costs.matmul_flops == 2 * m * n * k
  assert costs.other_flops == costs.flash_flops == 0
  assert costs.bytes == (m * k + k * n + n + m * n) * elt


def test_views_count_nothing():
  x = torch.ones(4, 6)
  costs = _count(lambda: (x.view(6, 4), x.t(), x.transpose(0, 1),
                          x[:, None].expand(4, 3, 6), x.detach(),
                          x.as_strided((2, 2), (1, 1))))
  assert (costs.flops, costs.bytes) == (0, 0)


def test_in_place_add_reads_two_and_writes_one():
  x, y = torch.ones(10, 3), torch.ones(10, 3)
  costs = _count(lambda: x.add_(y))
  assert costs.bytes == 3 * 30 * 4
  assert costs.other_flops == 30


def test_foreach_ops_count_each_element():
  xs = [torch.ones(4), torch.ones(3, 2)]
  costs = _count(lambda: torch._foreach_mul_(xs, 2.0))
  assert costs.other_flops == 10
  assert costs.bytes == 2 * 10 * 4


# ---- the tiny step ----


@pytest.mark.parametrize('max_predictions', [None, 20])
def test_dense_step_matmul_flops_are_the_analytic_count(max_predictions):
  _, costs = count_step(_step('dense', max_predictions),
                        _tensors(_batch(b=B, s=S)), 3)
  want = jax_flops(JaxConfig(**TINY), B, S, max_predictions=max_predictions)
  assert costs.matmul_flops == want + _nsp()
  assert costs.flash_flops == costs.seg_flops == 0
  assert costs.other_flops > 0 and costs.bytes > 0


def _flash_formula(b=B, s=S):
  """(FLOPs, bytes) the three kernels bill over a step of every pair."""
  per_layer = [tfa.work(n, b, TINY['num_heads'], s, HEAD_DIM, torch.float32,
                        b * s * s) for n in KERNELS]
  return tuple(TINY['num_layers'] * sum(x) for x in zip(*per_layer))


@pytest.mark.parametrize('max_predictions', [None, 20])
def test_flash_step_counts_the_dense_step_plus_the_recompute(
    max_predictions):
  batch = _tensors(_batch(b=B, s=S))
  _, dense = count_step(_step('dense', max_predictions), batch, 3)
  _, flash = count_step(_step('flash', max_predictions), batch, 3)
  assert (flash.matmul_flops + flash.flash_flops ==
          dense.matmul_flops + _recompute())
  assert flash.flash_flops == _flash_formula()[0]
  assert flash.seg_flops == 0


def _stand_in_launch(name, heads, q, k, v, bias, *rest, seg=()):
  """The card's launcher, as the plain versions writing the outputs the
  kernel writes."""
  ids = seg[:2]
  if name == 'fwd':
    for t, x in zip(rest, tfa._fwd_plain(q, k, v, bias, heads, *ids)):
      t.copy_(x)
  elif name == 'dq':
    dout, lse, delta, dq = rest
    dq.copy_(tfa._dq_plain(q, k, v, bias, dout, lse, delta, heads, *ids))
  else:
    dout, lse, delta, dk, dv = rest
    for t, x in zip((dk, dv), tfa._dkv_plain(q, k, v, bias, dout, lse, delta,
                                             heads, *ids)):
      t.copy_(x)


@pytest.mark.parametrize('packed', [False, True])
def test_the_launch_path_bills_what_the_plain_path_bills(monkeypatch,
                                                         packed):
  """With the wrappers taking their launch path (a stand-in launcher on
  CPU tensors), a step counts the FLOPs and bytes the plain path counts,
  and its outputs are the plain path's."""
  batch = _tensors(_packed_batch(b=2, s=256, docs=3, seed=4) if packed
                   else _batch(b=B, s=S))
  plain_step, card_step = _step(), _step()
  plain, plain_costs = count_step(plain_step, batch, 3)
  monkeypatch.setattr(tfa, '_use_kernel', lambda q: True)
  monkeypatch.setattr(tfa, '_check', lambda *a, **kw: None)
  monkeypatch.setattr(tfa, '_launch', _stand_in_launch)
  card, card_costs = count_step(card_step, batch, 3)
  assert repr(card_costs) == repr(plain_costs)
  assert (card_costs.seg_flops > 0) == packed
  for name in ('loss', 'grad_norm'):
    assert torch.equal(card[name], plain[name]), name
  if not packed:
    flops, nbytes = _flash_formula()
    assert card_costs.flash_flops == flops
    # The wrappers' bytes are inside the total; a dense step moves none.
    assert card_costs.bytes > nbytes


@pytest.mark.parametrize('impl', ['dense', 'flash'])
def test_a_counted_step_is_bit_equal_to_an_uncounted_one(impl):
  batches = [_tensors(_batch(b=4, s=64, seed=i)) for i in range(2)]
  counted, plain = _step(impl, dropout_rate=0.1), _step(impl,
                                                        dropout_rate=0.1)
  for batch in batches:
    got, _ = count_step(counted, batch, 3)
    want = plain(batch, 3)
    for name in want:
      assert torch.equal(got[name], want[name]), name
  for p, q in zip(counted.opt.params, plain.opt.params):
    assert torch.equal(p, q)
  assert counted.opt.count == plain.opt.count == 2


# ---- packed steps bill their own tiles ----


def _computed_tiles(batch):
  total, skipped = tfa.count_skippable_tiles(batch['segment_ids'].numpy(),
                                             head_dim=HEAD_DIM)
  return total - skipped


def test_packed_steps_are_billed_their_tile_difference():
  ttele.enable()
  cache = CompiledStepCache(_step())
  few = _tensors(_packed_batch(b=2, s=256, docs=2, seed=1))
  many = _tensors(_packed_batch(b=2, s=256, docs=6, seed=2))
  cache(few, 3)
  billed_few = cache.last_costs
  cache(many, 3)
  billed_many = cache.last_costs
  assert (cache.misses, cache.hits) == (1, 1)
  t_few, t_many = _computed_tiles(few), _computed_tiles(many)
  assert t_many < t_few
  # One tile pair of each kernel, per head and layer, at 64 x 64 pairs.
  per_tile = TINY['num_layers'] * sum(
      tfa.work(n, 1, TINY['num_heads'], S, HEAD_DIM, torch.float32,
               tfa.TILE_ROWS * tfa.stream_rows(HEAD_DIM))[0] for n in KERNELS)
  assert billed_many[0] - billed_few[0] == (t_many - t_few) * per_tile
  assert billed_many[1] == billed_few[1]
  (costs,) = cache._costs.values()
  assert costs.seg_tiles == t_few and costs.seg_flops == t_few * per_tile
  # The bill of a hit is what a miss on that batch counts.
  _, own = count_step(_step(), many, 3)
  assert own.seg_flops == t_many * per_tile
  assert billed_many[0] == own.flops


# ---- billing ----


def test_a_miss_and_its_hits_bill_n_counts():
  tele = ttele.enable()
  cache = CompiledStepCache(_step())
  n = 4
  for i in range(n):
    cache(_tensors(_batch(b=4, s=64, seed=i)), 3)
  (costs,) = cache._costs.values()
  assert (cache.misses, cache.hits) == (1, n - 1)
  assert cache.last_costs == costs.bill()
  assert tele.counter('train.xla_flops').total == n * costs.bill()[0]
  assert tele.counter('train.xla_bytes').total == n * costs.bill()[1]
  assert troofline.compiled_step_costs(costs) == costs.bill()


def test_telemetry_off_counts_nothing():
  cache = CompiledStepCache(_step())
  for i in range(3):
    cache(_tensors(_batch(b=4, s=64, seed=i)), 3)
  assert cache.last_costs is None and cache._costs == {}


def test_a_window_counts_its_k_steps():
  ttele.enable()
  step = _step()
  window = ttrain.make_scan_train_step(step.model, step.opt)
  batches = [_batch(b=4, s=64, seed=i) for i in range(3)]
  window(ttrain.stack_batch_window(batches, 'cpu'), 3)
  counted = window.last_costs
  _, one = count_step(_step(), _tensors(batches[0]), 3)
  assert counted.matmul_flops == 3 * one.matmul_flops
  assert counted.flash_flops == 3 * one.flash_flops


def test_mfu_takes_the_counted_numerator(monkeypatch):
  monkeypatch.setenv('LDDL_PEAK_TFLOPS', '0.5')
  tele = ttele.enable()
  loop = TrainLoop.build(model_cfg=_cfg('flash'), device='cpu',
                         learning_rate=1e-3, warmup_steps=2, total_steps=6,
                         seed=5)
  loop.loader = _Bins([_batch(b=4, s=64)])
  loop.run(1, log_every=0)
  flops = loop.step_cache.last_costs[0]
  (costs,) = loop.step_cache._costs.values()
  assert flops == (loop.flops_per_step(4, 64) + _nsp(4) + _recompute(4, 64)
                   + costs.other_flops)
  # One step: the gauge's step time is the histogram's one observation.
  step_s = tele.histogram('train.step_seconds').sum
  assert tele.gauge('train.mfu').value == pytest.approx(
      flops / (step_s * 0.5e12), rel=1e-12)


class _Bins:

  batch_size = 4

  def __init__(self, batches):
    self.batches = batches

  def __iter__(self):
    return iter(self.batches)


# ---- the verdict and compiled_step_costs ----


def test_both_verdicts_agree_on_a_port_run():
  tele = ttele.enable()
  loop = TrainLoop.build(model_cfg=_cfg('flash'), device='cpu',
                         learning_rate=1e-3, warmup_steps=2, total_steps=6,
                         seed=5)
  loop.loader = _Bins([_batch(b=4, s=64, seed=i) for i in range(3)])
  loop.run(3, log_every=0)
  merged = merge_metric_lines([tele.snapshot_lines()])
  window = merged['metrics']['train.step_seconds']['sum']
  for peaks in ({'flops_per_sec': 989e12, 'hbm_bytes_per_sec': 3.35e12,
                 'balance': 989e12 / 3.35e12},
                {'flops_per_sec': 1e9, 'hbm_bytes_per_sec': 1e12,
                 'balance': 1e-3}):
    got = troofline.roofline_verdict(merged, window, peaks=peaks)
    want = jroofline.roofline_verdict(merged, window, peaks=peaks)
    assert got == want
    assert got['bound'] in ('compute-bound', 'memory-bound', 'input-bound')
    assert got['flops'] == 3 * loop.step_cache.last_costs[0]


class _Entry:

  def __init__(self, costs):
    self.costs = costs


def test_compiled_step_costs_of_objects_without_a_count_is_none():
  assert troofline.compiled_step_costs(object()) is None
  assert troofline.compiled_step_costs(_Entry(None)) is None
  assert troofline.compiled_step_costs(StepCosts()) is None  # 0 FLOPs

  class _Raises:

    @property
    def costs(self):
      raise RuntimeError('no count')

  assert troofline.compiled_step_costs(_Raises()) is None
  assert troofline.compiled_step_costs(ttrain.CapturedGraph(
      None, {}, {}, {})) is None


def test_compiled_step_costs_of_a_count():
  costs = StepCosts()
  costs.matmul_flops, costs.other_flops, costs.bytes = 120, 3, 456
  assert troofline.compiled_step_costs(costs) == (123.0, 456.0)
  got = troofline.compiled_step_costs(ttrain.CapturedGraph(
      None, {}, {}, {}, costs))
  assert got == (123.0, 456.0) and all(type(x) is float for x in got)
  assert ttele.compiled_step_costs is troofline.compiled_step_costs


def test_the_count_stays_out_of_the_wrappers_plain_ops():
  """The plain versions' own matmuls (the whole score matrix) are not
  counted: the launch is billed by formula."""
  b, h, s, d = 2, 2, 64, 32
  q, k, v = (torch.randn(b, h, s, d, generator=torch.Generator()
                         .manual_seed(i)) for i in range(3))
  costs = _count(lambda: tfa.flash_attention(q, k, v))
  assert costs.matmul_flops == 0
  assert costs.flash_flops == tfa.work('fwd', b, h, s, d, torch.float32,
                                       b * s * s)[0]

