"""Data-parallel training of lddl_tpu_torch vs lddl_tpu's data mesh, on
the CPU.

Two spawned gloo ranks (``tests/torch_dist_ranks.py``) each take their
rows of the same numpy global batches (``local_batch``) and step
``TrainLoop``'s data-parallel step from the same converted init; the JAX
side is ``lddl_tpu.parallel.make_train_step`` over
``make_mesh(data=2, devices=jax.devices()[:2])`` with the batches sharded
by ``shard_batch``, so GSPMD computes every normalizer over the global
batch. Tiny config (2 layers, hidden 64), float32, dropout off, 3 steps,
pairs and packed rows. Tolerance: ``test_torch_train.py``'s rtol 2e-4 on
the loss, its parts, ``mlm_acc`` and ``grad_norm``; the two ranks'
parameters must be bit-equal after every step.

The pairs' first batch holds very different masked counts in its two
halves (mlm_probability 0.5 vs 0.04): averaging the ranks' own means, as
``DistributedDataParallel`` would, gives a gradient norm off by far more
than the tolerance there.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_ranks as ranks
from lddl_tpu.models import BertConfig as JaxConfig
from lddl_tpu.models import BertForPretraining as JaxBert
from lddl_tpu.parallel import init_params, make_mesh, make_train_step
from lddl_tpu.parallel import shard_batch
from lddl_tpu_torch.core.utils import serialize_np_array
from lddl_tpu_torch.loader import PackedCollate
from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
from lddl_tpu_torch.models import (BertConfig, BertForPretraining,
                                   flax_to_state_dict)
from lddl_tpu_torch.parallel import train as ttrain
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, dropout_rate=0.0)
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
           weight_decay=0.01)
NAMES = ('loss', 'mlm_loss', 'nsp_loss', 'mlm_acc', 'grad_norm')


def _pairs(b, s, seed, mlm_probability=0.15):
  """Loader-format [CLS] A [SEP] B [SEP] rows, dynamic masks."""
  rng = np.random.default_rng(seed)
  lens = rng.integers(s // 2, s + 1, size=b)
  na = lens // 2 - 1
  cols = np.arange(s)[None, :]
  ids = rng.integers(5, TINY['vocab_size'], (b, s)).astype(np.int32)
  ids[:, 0] = 2
  ids[np.arange(b), na + 1] = 3
  ids[np.arange(b), lens - 1] = 3
  ids[cols >= lens[:, None]] = 0
  mask = (cols < lens[:, None]).astype(np.int32)
  ids, labels = dynamic_mask_tokens(
      ids, ids <= 4, mlm_probability=mlm_probability,
      vocab_size=TINY['vocab_size'], mask_id=4, base_seed=seed, dp_rank=0,
      epoch=0, step=0)
  return {'input_ids': ids,
          'token_type_ids': ((cols >= (na + 2)[:, None]) & (mask > 0)).astype(
              np.int32),
          'attention_mask': mask,
          'labels': labels,
          'next_sentence_labels': rng.integers(0, 2, b).astype(np.int32)}


def _uneven(b, s, seed):
  """A global batch whose first half is masked at 0.5, the second at
  0.04: ranks with very different masked counts."""
  lo, hi = _pairs(b // 2, s, seed, 0.5), _pairs(b // 2, s, seed + 1, 0.04)
  return {k: np.concatenate([lo[k], hi[k]]) for k in lo}


class _Tok:
  cls_token_id, sep_token_id, mask_token_id, pad_token_id = 2, 3, 4, 0
  vocab_size = TINY['vocab_size']


def _packed(b, s, seed, docs=3):
  """Packed block-diagonal rows through the port's PackedCollate."""
  rng = np.random.default_rng(seed)
  rows = []
  for _ in range(b):
    total = int(rng.integers(3 * s // 4, s + 1))
    cuts = np.sort(rng.choice(np.arange(1, total - 1 - docs), docs - 1,
                              replace=False))
    pieces = np.diff(np.r_[0, cuts, total - 1 - docs])
    ids, marks = [_Tok.cls_token_id], []
    for n in pieces:
      marks.append(len(ids))
      ids += list(rng.integers(5, TINY['vocab_size'], n))
      ids.append(_Tok.sep_token_id)
    rows.append({'input_ids': serialize_np_array(np.asarray(ids, np.uint16)),
                 'doc_offsets': serialize_np_array(np.asarray(marks,
                                                              np.uint16))})
  return PackedCollate(_Tok(), base_seed=seed, block_diagonal=True)(
      rows, s, epoch=0, step=seed)


def _jax_run(batches, seq_len):
  """The JAX step over a data=2 mesh: per-step metrics, and the init as
  a torch state dict (numpy, to pickle to the ranks)."""
  mesh = make_mesh(data=2, devices=jax.devices()[:2])
  model = JaxBert(JaxConfig(dtype=jnp.float32, **TINY), mesh=mesh)
  params = init_params(model, mesh, jax.random.key(1), seq_len=seq_len)
  state = {k: v.numpy() for k, v in
           flax_to_state_dict(jax.device_get(params)).items()}
  schedule = optax.warmup_cosine_decay_schedule(
      0.0, OPT['learning_rate'], OPT['warmup_steps'],
      max(OPT['total_steps'], OPT['warmup_steps'] + 1))
  tx = optax.adamw(schedule, weight_decay=OPT['weight_decay'])
  opt_state = tx.init(params)
  step = make_train_step(model, tx, mesh)
  rng = jax.random.key(2)
  out = []
  for batch in batches:
    params, opt_state, m = step(params, opt_state, rng,
                                shard_batch(batch, mesh))
    out.append({k: float(m[k]) for k in NAMES})
  return out, state


def _check(port, ref):
  steps = [port[r]['steps'] for r in (0, 1)]
  for i, want in enumerate(ref):
    assert steps[0][i]['params'] == steps[1][i]['params'], \
        f'step {i}: the ranks\' parameters differ'
    assert steps[0][i]['metrics'] == steps[1][i]['metrics'], i
    for name in NAMES:
      np.testing.assert_allclose(steps[0][i]['metrics'][name], want[name],
                                 rtol=2e-4, atol=1e-7,
                                 err_msg=f'step {i} {name}')
  assert [port[r]['dp'] for r in (0, 1)] == [(0, 2), (1, 2)]
  assert port[0]['backend'] == 'gloo'


def _ddp_grad_norm(state, batch):
  """What averaging the ranks' own means would give: the norm of the
  mean of each half's gradient, each normalized by its own counts."""
  model = BertForPretraining(BertConfig(dtype=torch.float32, **TINY))
  model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
  grads = []
  for half in (slice(0, 4), slice(4, 8)):
    model.zero_grad()
    loss, _ = ttrain.pretrain_loss(
        model, {k: torch.from_numpy(v[half]) for k, v in batch.items()})
    loss.backward()
    grads.append([p.grad.clone() for p in model.parameters()])
  mean = [(a + b) / 2 for a, b in zip(*grads)]
  return float(ttrain.global_norm(mean))


def test_pairs_match_jax_data_mesh_with_uneven_masks():
  batches = [_uneven(8, 64, 10), _pairs(8, 64, 11), _pairs(8, 64, 12)]
  halves = [int((batches[0]['labels'][h] != -100).sum())
            for h in (slice(0, 4), slice(4, 8))]
  assert halves[0] > 5 * halves[1], halves
  ref, state = _jax_run(batches, 64)
  port = ranks.run_world(ranks.dp_steps, 2,
                         args=(TINY, state, batches, OPT))
  _check(port, ref)
  ddp = _ddp_grad_norm(state, batches[0])
  assert not np.isclose(ddp, ref[0]['grad_norm'], rtol=2e-4, atol=0), (
      f'averaging per-rank means ({ddp}) should miss the global '
      f'gradient norm ({ref[0]["grad_norm"]})')


def test_packed_rows_match_jax_data_mesh():
  batches = [_packed(4, 128, 20 + i) for i in range(3)]
  ref, state = _jax_run(batches, 128)
  port = ranks.run_world(ranks.dp_steps, 2,
                         args=(TINY, state, batches, OPT))
  _check(port, ref)


def test_one_rank_group_equals_the_single_process_step():
  """World 1 over a process group: each all-reduce only copies, so the
  data-parallel step equals the step without one, bit for bit."""
  batches = [_uneven(4, 64, 30), _packed(2, 128, 31), _pairs(4, 64, 32)]
  state = {k: v.detach().numpy() for k, v in BertForPretraining(
      BertConfig(dtype=torch.float32, **TINY)).state_dict().items()}
  port = ranks.run_world(ranks.dp_steps, 1, args=(TINY, state, batches,
                                                  OPT))[0]
  model = BertForPretraining(BertConfig(dtype=torch.float32, **TINY))
  model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
  opt = ttrain.AdamW(model.parameters(), functools.partial(
      ttrain.learning_rate, peak=OPT['learning_rate'],
      warmup_steps=OPT['warmup_steps'], total_steps=OPT['total_steps']),
                     weight_decay=OPT['weight_decay'])
  model.train()
  for i, batch in enumerate(batches):
    m = ttrain.train_step(model, opt,
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          dropout_seed=6)
    assert port['steps'][i]['metrics'] == {k: float(v) for k, v in
                                           m.items()}, i
    assert port['steps'][i]['params'] == ranks.param_digest(model), i


# ---- checkpoints across world sizes (the committed pairs shards) ----

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = os.path.join(ROOT, 'tests', 'assets', 'torch_shards', 'pairs')
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')


def test_restore_world_size_1_to_2(tmp_path):
  """As tests/test_training.py::test_restore_world_size_resharding: a
  world-1 checkpoint restores onto a world-2 fleet (halved per-rank
  batch, the same global batch) with equal state on every rank and the
  same forward bin draws."""
  ckpt = str(tmp_path / 'ckpt')
  first = ranks.shard_loop(0, 1, SHARDS, VOCAB, 16, comm='null')
  first.run(4, ckpt_dir=ckpt, log_every=0)
  assert first.latest_meta(ckpt) == (4, 64)
  w1 = ranks.shard_loop(0, 1, SHARDS, VOCAB, 16, samples_seen=64,
                        comm='null').restore(ckpt)
  assert w1.state_digest() == first.state_digest()
  expect = ranks.bin_seq(w1)
  w2 = ranks.run_world(ranks.restore_and_draw, 2,
                       args=(SHARDS, VOCAB, ckpt, 8, 64))
  for r in (0, 1):
    assert w2[r]['digest'] == first.state_digest(), r
    assert w2[r]['meta'] == (4, 64)
    assert w2[r]['bins'] == expect, r


def test_restore_world_size_2_to_1(tmp_path):
  """A world-2 run (rank 0 writes the replicated state behind a barrier)
  restores at world 1: the state equals the ranks' bit for bit, and the
  bins drawn next equal those of a world-1 loader re-seeked to the same
  samples_seen."""
  ckpt = str(tmp_path / 'ckpt')
  w2 = ranks.run_world(ranks.train_and_save, 2,
                       args=(SHARDS, VOCAB, ckpt, 8, 4))
  assert w2[0]['digest'] == w2[1]['digest']
  assert w2[0]['losses'] == w2[1]['losses']
  assert len(w2[0]['losses']) == 4 and np.isfinite(w2[0]['losses']).all()
  assert w2[0]['meta'] == (4, 64)
  w1 = ranks.shard_loop(0, 1, SHARDS, VOCAB, 16, samples_seen=64,
                        comm='null')
  assert w1.latest_meta(ckpt) == (4, 64)
  fresh = ranks.bin_seq(w1)
  w1 = ranks.shard_loop(0, 1, SHARDS, VOCAB, 16, samples_seen=64,
                        comm='null').restore(ckpt)
  assert w1.state_digest() == w2[0]['digest']
  assert (w1.step, w1.samples_seen) == (4, 64)
  assert ranks.bin_seq(w1) == fresh
