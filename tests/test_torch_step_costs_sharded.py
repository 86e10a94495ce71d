"""The step cost model on sharded steps and packed rows, on the CPU.

A packed step's K4 FLOPs follow the tiles its launches compute. Each
launch bills its own computed tiles, so the miss's count is linear in two
counts of its batch: the tile pairs computed on the fwd/dq grid (q tiles
owned) and on dkv's (kv tiles owned). Under ``seq`` above 1 each ring
block launches K4 on the rank's q columns against another shard's kv
columns. The count then covers every block, and so must the bill of a
later step: ``packed_tiles`` counts the rank's q columns against every
shard from the whole rows' ids, which the feed and ``make_global_batch``
keep on the host (``PlacedBatch``).

  - two gloo ranks at ``seq=2`` (``ring_flash``, head_dim 128, where the
    two grids differ), telemetry on, packed batches with different
    documents: every step's bill equals a fresh count of that step, the
    old rule (the rank's own columns' self-attention tiles alone) does
    not, ``train.xla_flops`` is the bills' sum, and a plain dict with no
    host ids is billed the miss's count;
  - ``tensor=2``: each rank counts its shards' matmuls (the layers and the
    tied decoder halved, the rest whole: world 1's count less half those
    terms, exactly) and its collectives' buffers (the replicas' and the
    gradients' flat buffers, read and written, at least);
  - ``fsdp=2``: each rank counts the whole model's matmuls on its rows
    (world 1's count of those rows, exactly) and the working buffer's
    gather and the gradients' reduction, with a few scalars beside;
  - one process, head_dim 128: a later packed batch is billed what a miss
    on it counts;
  - ``TrainLoop.run`` counts a packed batch's tiles once a step, from the
    host ids the feed kept: the cache's bill and the loop's
    ``train.attn_tiles_*`` share the count.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from lddl_tpu.models import BertConfig as JaxConfig
from lddl_tpu.models.flops import bert_pretrain_flops_per_step as jax_flops
from lddl_tpu_torch import telemetry as ttele
from lddl_tpu_torch.models import BertConfig, BertForPretraining
from lddl_tpu_torch.ops import flash_attention as tfa
from lddl_tpu_torch.parallel import train as ttrain
from lddl_tpu_torch.telemetry.step_costs import StepCostCounter
from lddl_tpu_torch.training import CompiledStepCache, TrainLoop
from lddl_tpu_torch.training import pretrain as tpretrain
from test_torch_dp import OPT, TINY
from test_torch_train import _batch, _packed_batch
from torch_threads import torch_one_thread_a_file  # noqa: F401

# head_dim 128: the kernels stream 32 kv rows against 64 owned, so the
# fwd/dq grid and dkv's count different tiles of a cross block.
WIDE = dict(TINY, hidden_size=256, num_heads=2, intermediate_size=256,
            max_position_embeddings=512)


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


@pytest.fixture(autouse=True)
def _port_telemetry_off():
  yield
  ttele.disable()


def _tensors(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _count(cfg_kw, batch, max_predictions=None):
  """A fresh world-1 step's StepCosts on ``batch`` (numpy)."""
  model = BertForPretraining(BertConfig(dtype=torch.float32, **cfg_kw))
  step = ttrain.TrainStep(model, ttrain.AdamW(model.parameters(),
                                              lambda c: 1e-3),
                          max_predictions)
  with StepCostCounter() as counter:
    step(_tensors(batch), 3)
  return counter.costs


def _old_rule(miss, own_miss, own_now):
  """The bill before the repair: the miss's K4 FLOPs scaled by the rank's
  own columns' self-attention tiles now over at the miss."""
  computed = own_now[0] - own_now[1]
  counted = own_miss[0] - own_miss[1]
  flops = (miss['matmul_flops'] + miss['flash_flops'] +
           miss['other_flops'])
  return flops + miss['seg_flops'] * computed / counted - miss['seg_flops']


def test_a_ring_step_is_billed_the_tiles_of_every_block():
  batches = [_packed_batch(b=2, s=512, docs=docs, seed=seed)
             for docs, seed in ((3, 1), (9, 2), (5, 3))]
  cfg = dict(WIDE, attention_impl='ring_flash')
  got = ranks.run_world(ranks.counted_steps, 2,
                        args=({'seq': 2}, [{'cfg': cfg, 'batches': batches}],
                              dict(OPT)))
  old_rule_off = grids_differ = False
  for rank in (0, 1):
    (case,) = got[rank]
    miss = case['miss']
    assert miss['seg_flops'] > miss['seg_kv_flops'] > 0
    bills = []
    for i, step in enumerate(case['steps']):
      assert step['bill'] == step['count'], (rank, i)
      total, computed, kv_computed = step['tiles']
      grids_differ |= computed != kv_computed
      # Both shards' kv columns: twice the rank's own grid.
      assert total == 2 * step['own'][0]
      assert step['costs']['seg_tiles'] == 0  # counted outside the cache
      bills.append(step['bill'][0])
      if i and _old_rule(miss, case['steps'][0]['own'],
                         step['own']) != step['count'][0]:
        old_rule_off = True
    # The documents differ, and so do the steps' K4 FLOPs.
    assert len(set(bills)) == len(bills)
    (first_tiles, seg_tiles, seg_kv_tiles) = case['steps'][0]['tiles']
    assert (miss['seg_tiles'], miss['seg_kv_tiles']) == (seg_tiles,
                                                         seg_kv_tiles)
    assert case['xla_flops'] == sum(bills) + case['plain_bill'][0]
    # No host ids under seq: the miss's count.
    assert case['plain_bill'] == case['miss_bill']
  assert old_rule_off and grids_differ


@pytest.mark.parametrize('packed', [False, True])
def test_a_packed_step_is_billed_its_own_tiles_at_head_dim_128(packed):
  """One process: every later batch is billed what a miss on it counts,
  on both grids (head_dim 128)."""
  ttele.enable()
  cfg = dict(WIDE, attention_impl='flash')
  model = BertForPretraining(BertConfig(dtype=torch.float32, **cfg))
  cache = CompiledStepCache(ttrain.TrainStep(
      model, ttrain.AdamW(model.parameters(), lambda c: 1e-3)))
  batches = ([_packed_batch(b=2, s=512, docs=d, seed=d) for d in (2, 7, 4)]
             if packed else [_batch(b=2, s=128, seed=i) for i in range(2)])
  for batch in batches:
    cache(_tensors(batch), 3)
    assert cache.last_costs == _count(cfg, batch).bill()
  (costs,) = cache._costs.values()
  assert (costs.seg_kv_flops > 0) == packed
  if packed:
    total, computed, kv_computed = tfa.ring_tiles(
        batches[0]['segment_ids'], head_dim=128)
    assert (costs.seg_tiles, costs.seg_kv_tiles) == (computed, kv_computed)
    # Self-attention: dkv's grid is the fwd/dq grid transposed.
    assert computed == kv_computed


def test_tensor_and_fsdp_ranks_count_their_own_shards():
  b, s, mp = 8, 64, 16
  batches = [_batch(b=b, s=s, seed=40)]
  opt_kw = dict(OPT, max_predictions=mp)
  cfg = dict(TINY, attention_impl='dense')
  got = {name: ranks.run_world(ranks.counted_steps, 2,
                               args=(axes, [{'cfg': cfg,
                                             'batches': batches}], opt_kw))
         for name, axes in (('tensor', {'tensor': 2}), ('fsdp', {'fsdp': 2}))}
  d, layers, f, v = (TINY['hidden_size'], TINY['num_layers'],
                     TINY['intermediate_size'], TINY['vocab_size'])
  whole = _count(cfg, batches[0], mp)
  assert whole.matmul_flops == (
      jax_flops(JaxConfig(**TINY), b, s, max_predictions=mp) +
      2 * b * d * 2 * 3)
  # The tensor-cut matmuls: every layer's projections and attention, and
  # the tied decoder over the masked positions (forward x3).
  cut = (layers * 3 * (8 * b * s * d * d + 4 * b * s * s * d +
                       4 * b * s * d * f) + 3 * 2 * b * mp * d * v)
  rows = {k: x[:b // 2] for k, x in batches[0].items()}
  half = _count(cfg, rows, mp)
  for rank in (0, 1):
    (tp,) = got['tensor'][rank]
    costs = tp['steps'][0]['costs']
    assert costs['matmul_flops'] == whole.matmul_flops - cut // 2
    # At least the replicas' broadcast and the gradients' all-reduce (each
    # buffer read and written), and each layer's four [b, s, d] float32
    # activation sums (attention out and FFN out forward, their inputs'
    # cotangents backward).
    sizes = tp['sizes']
    floor = (2 * (sizes['flat'] + sizes['replicas']) +
             layers * 4 * 2 * b * s * d * 4)
    assert costs['collective_bytes'] >= floor
    assert costs['bytes'] > costs['collective_bytes']
    (fs,) = got['fsdp'][rank]
    costs = fs['steps'][0]['costs']
    assert costs['matmul_flops'] == half.matmul_flops
    sizes = fs['sizes']
    # The gather (gloo: an int64 sum over the working buffer) and the
    # gradients' reduction (gloo: an all-reduce of the flat buffer), each
    # read and written; the rest is the normalizers, metrics and norm.
    buffers = 2 * sizes['full'] + 2 * sizes['flat']
    assert 0 < costs['collective_bytes'] - buffers < 1024
    # The bill of the miss's own batch is its count.
    assert fs['steps'][0]['bill'] == fs['steps'][0]['count']
    assert tp['steps'][0]['bill'] == tp['steps'][0]['count']


class _Loader:

  def __init__(self, batches):
    self.batches = batches
    self.batch_size = len(batches[0]['input_ids'])

  def __iter__(self):
    return iter(self.batches)


def test_the_loop_reads_a_packed_batchs_ids_once_a_step(monkeypatch):
  tele = ttele.enable()
  batches = [_packed_batch(b=2, s=512, docs=d, seed=d) for d in (2, 9, 4)]

  def build():
    return TrainLoop.build(model_cfg=BertConfig(
        dtype=torch.float32, attention_impl='flash', **TINY), device='cpu',
        learning_rate=1e-3, warmup_steps=2, total_steps=6, seed=5,
        max_seq_length=512)

  loop, fresh = build(), build()
  loop.loader = _Loader(batches)
  calls = []
  real = tfa.ring_tiles

  def counted(ids, *a, **kw):
    calls.append(np.asarray(ids).copy())
    return real(ids, *a, **kw)

  monkeypatch.setattr(tfa, 'ring_tiles', counted)
  device_reads = []
  real_packed = tpretrain.packed_tiles

  def watched(batch, model):
    if getattr(batch, 'host_segment_ids', None) is None:
      device_reads.append(batch)
    return real_packed(batch, model)

  monkeypatch.setattr(tpretrain, 'packed_tiles', watched)
  loop.run(len(batches), log_every=0)
  assert len(calls) == len(batches)
  assert not device_reads
  for ids, batch in zip(calls, batches):
    np.testing.assert_array_equal(ids, batch['segment_ids'])
  want = np.sum([tfa.count_skippable_tiles(b['segment_ids'], head_dim=32)
                 for b in batches], axis=0)
  assert (tele.counter('train.attn_tiles_total').total,
          tele.counter('train.attn_tiles_skipped').total) == tuple(want)
  counts = []
  for batch in batches:
    with StepCostCounter() as counter:
      fresh.step_fn(_tensors(batch), fresh.dropout_seed)
    counts.append(counter.costs.bill()[0])
  assert tele.counter('train.xla_flops').total == sum(counts)
  assert len(set(counts)) == len(counts)
