"""Tensor-parallel training of lddl_tpu_torch vs lddl_tpu's tensor mesh,
on the CPU.

The rules: every parameter of the port's model, fused and unfused, is
placed as ``lddl_tpu.models.spec_for_param`` places its flax name (the
spec reversed for a Dense kernel, whose torch weight is its transpose),
and a rank's shard of a tensor is the one GSPMD gives the same device
(the fused q/k/v projection excepted: a rank keeps its heads of q, of k
and of v, where GSPMD cuts the concatenation; ``jnp.split`` brings it to
the same values).

The steps: two spawned gloo ranks (``tests/torch_dist_ranks.py``,
``make_mesh(tensor=2)``) step ``TrainLoop``'s step on the same numpy
global batches (``make_global_batch``) from the same converted init as
``lddl_tpu.parallel.make_train_step`` over ``make_mesh(tensor=2,
devices=jax.devices()[:2])``, whose flash runs its Pallas kernels in
interpret mode. Tiny config (2 layers, hidden 64, 2 heads, so one head a
rank, vocab 128 cut in two), float32, dropout off, 3 steps: pairs (the
first batch's halves masked at 0.5 and 0.04) and packed rows, fused and
unfused q/k/v, flash and dense attention. Tolerance: ``test_torch_dp.py``'s
rtol 2e-4 on the loss, its parts, ``mlm_acc`` and ``grad_norm``; atol
5e-5 on the gathered parameters after the 3 steps (lr 1e-3; what GSPMD
and the port sum in other orders moves them by ~1e-7 here). The same
world checks that the replicated parameters stay bit-equal across the
two ranks after every step, that with dropout on both ranks return the
same losses, that a world-1 checkpoint restores there bit for bit and
steps on within rtol 2e-4 of world 1, the loop's counters and the
pretrain CLI with ``--tp 2``.
"""

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
from lddl_tpu.models import spec_for_param as jax_spec_for_param
from lddl_tpu.parallel import init_params, make_mesh, make_train_step
from lddl_tpu.parallel import shard_batch
from lddl_tpu_torch.models import (BertConfig, BertForPretraining,
                                   flax_to_state_dict)
from lddl_tpu_torch.models.bert import param_blocks, spec_for_param
from lddl_tpu_torch.parallel.mesh import (MESH_AXES, batch_pspec,
                                          canonical_batch_spec,
                                          match_partition_rules, seq_columns,
                                          shard, unshard)
from lddl_tpu_torch.training import TrainLoop
from test_torch_dp import NAMES, OPT, TINY, _packed, _pairs, _uneven


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = os.path.join(ROOT, 'tests', 'assets', 'torch_shards', 'pairs')
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
PARAM_ATOL = 5e-5


def pairs_batches(seed):
  return [_uneven(8, 64, seed), _pairs(8, 64, seed + 1),
          _pairs(8, 64, seed + 2)]


def packed_batches(seed):
  return [_packed(4, 128, seed + i) for i in range(3)]


# name -> (batches, model settings beside TINY)
CASES = {
    'pairs-unfused-dense': (pairs_batches, 10, {}),
    'pairs-fused-flash': (pairs_batches, 40,
                          {'fused_qkv': True, 'attention_impl': 'flash'}),
    'packed-unfused-flash': (packed_batches, 50, {'attention_impl': 'flash'}),
    'packed-fused-dense': (packed_batches, 60, {'fused_qkv': True}),
}


def jax_mesh_init(axes, cfg_kw, seq_len):
  """``lddl_tpu``'s model over a mesh of ``axes`` on the first devices of
  the 8-device CPU platform, its params placed there, and the init as a
  whole torch state dict (numpy)."""
  n = int(np.prod(list(axes.values())))
  mesh = make_mesh(devices=jax.devices()[:n], **axes)
  model = JaxBert(JaxConfig(dtype=jnp.float32, **cfg_kw), mesh=mesh)
  params = init_params(model, mesh, jax.random.key(1), seq_len=seq_len)
  state = {k: v.numpy() for k, v in
           flax_to_state_dict(jax.device_get(params)).items()}
  return (mesh, model, params), state


def jax_mesh_steps(jax_model, batches):
  """``lddl_tpu.parallel.make_train_step`` over the batches: per-step
  metrics, and the final parameters as a whole state dict (numpy)."""
  mesh, model, params = jax_model
  schedule = optax.warmup_cosine_decay_schedule(
      0.0, OPT['learning_rate'], OPT['warmup_steps'],
      max(OPT['total_steps'], OPT['warmup_steps'] + 1))
  tx = optax.adamw(schedule, weight_decay=OPT['weight_decay'])
  opt_state = tx.init(params)
  step = make_train_step(model, tx, mesh)
  metrics = []
  for batch in batches:
    params, opt_state, m = step(params, opt_state, jax.random.key(2),
                                shard_batch(batch, mesh))
    metrics.append({k: float(m[k]) for k in NAMES})
  final = {k: v.numpy() for k, v in
           flax_to_state_dict(jax.device_get(params)).items()}
  return {'metrics': metrics, 'final': final}


def mesh_world(axes, names, fn, world, extra=(), more=()):
  """The port's world ``fn(rank, world, axes, cases, opt_kw, *extra)``
  over the cases ``names`` (plus ``more``) started from JAX's init, with
  JAX's steps run while the ranks run; returns (JAX's references by
  name, the ranks' results)."""
  models, cases = {}, []
  for name in names:
    make, seed, kw = CASES[name]
    batches = make(seed)
    cfg = dict(TINY, **kw)
    models[name], state = jax_mesh_init(
        axes, cfg, batches[0]['input_ids'].shape[1])
    cases.append({'cfg': cfg, 'batches': batches, 'state': state})
  procs, q = ranks.start_world(fn, world,
                               args=(axes, cases + list(more), OPT, *extra))
  try:
    refs = {name: dict(jax_mesh_steps(models[name], case['batches']),
                       first=case['batches'][0]['input_ids'])
            for name, case in zip(names, cases)}
  except BaseException:
    for p in procs:
      p.kill()
    raise
  return refs, ranks.join_world(procs, q)


def check_case(name, ref, port, world):
  """Every rank's metrics equal, within rtol 2e-4 of JAX's per step; the
  gathered parameters within PARAM_ATOL of JAX's; the first batch's rows
  the feed gave each rank (its ``batch_rows`` through ``prefetch_to_device``
  with the mesh) its ``(data, fsdp)`` block of them."""
  for r in range(world):
    rank, size = port[r]['dp']
    per = len(ref['first']) // size
    np.testing.assert_array_equal(port[r]['fed'],
                                  ref['first'][rank * per:(rank + 1) * per])
  for i, want in enumerate(ref['metrics']):
    got = port[0]['steps'][i]['metrics']
    for r in range(1, world):
      assert port[r]['steps'][i]['metrics'] == got, (name, i, r)
    for k in NAMES:
      np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-7,
                                 err_msg=f'{name} step {i} {k}')
  for k, want in ref['final'].items():
    np.testing.assert_allclose(port[0]['state'][k], want, rtol=0,
                               atol=PARAM_ATOL, err_msg=f'{name} {k}')


def check_tensor_groups(port, groups):
  """The replicated parameters of each tensor group bit-equal after every
  step."""
  for i in range(len(port[0]['steps'])):
    for group in groups:
      digests = {port[r]['steps'][i]['replicated'] for r in group}
      assert len(digests) == 1, (i, group)


# ---- the rules, in one process ----


class _Mesh:
  """The part of a DeviceMesh :func:`shard` reads: every axis 1 but
  ``tensor`` (at this rank's index) and ``seq``."""

  mesh_dim_names = MESH_AXES

  def __init__(self, tensor, rank, seq=1):
    self.shape = (1, 1, tensor, seq)
    self.rank = rank

  def size(self, dim):
    return self.shape[dim]

  def get_local_rank(self, axis):
    return self.rank if axis == 'tensor' else 0


def _flax_leaves(fused):
  """``[(port name, port shape, flax spec in the port's layout)]`` of the
  JAX model's params: a scanned leaf gives one entry per layer (its
  layer axis dropped), a kernel's spec reversed."""
  cfg = JaxConfig(dtype=jnp.float32, fused_qkv=fused, **TINY)
  ids = jnp.zeros((2, 16), jnp.int32)
  tree = jax.eval_shape(lambda: JaxBert(cfg).init(
      jax.random.key(0), ids, ids, jnp.ones((2, 16), jnp.int32))['params'])
  rename = {'kernel': 'weight', 'scale': 'weight', 'embedding': 'weight'}
  out = []
  for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
    keys = tuple(str(p.key) for p in path)
    spec = tuple(jax_spec_for_param(keys, leaf.shape))
    shape = tuple(leaf.shape)
    if keys[-1] == 'kernel':
      spec, shape = spec[:-2] + spec[-2:][::-1], shape[:-2] + shape[-2:][::-1]
    tail = keys[:-1] + (rename.get(keys[-1], keys[-1]),)
    if keys[:2] == ('encoder', 'layers'):
      for i in range(shape[0]):
        out.append(('.'.join(('encoder', 'layers', str(i)) + tail[2:]),
                    shape[1:], spec[1:]))
    else:
      out.append(('.'.join(tail), shape, spec))
  return out


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
def test_rules_match_jax_spec_for_param(fused):
  model = BertForPretraining(BertConfig(fused_qkv=fused, **TINY))
  placement = model.placement()
  want = {name: (shape, spec) for name, shape, spec in _flax_leaves(fused)}
  assert set(placement) == set(want)
  for name, p in model.named_parameters():
    shape, spec = want[name]
    assert tuple(p.shape) == shape, name
    assert placement[name] == spec, (name, placement[name], spec)
  # A name no rule names is replicated; the transposed Dense specs.
  assert spec_for_param('pooler.weight', (64, 64)) == (None, None)
  assert spec_for_param('encoder.layers.0.attention.query.weight',
                        (64, 64)) == ('tensor', 'fsdp')
  assert spec_for_param('encoder.layers.0.output.weight',
                        (64, 128)) == ('fsdp', 'tensor')
  assert spec_for_param('encoder.layers.0.output_norm.weight',
                        (64,)) == (None,)


def test_match_partition_rules_first_match_scalars_and_refusal():
  named = {'a.weight': torch.zeros(4, 2), 'b.weight': torch.zeros(4),
           'count': torch.zeros(())}
  rules = [(r'a\.weight$', ('tensor', None)), (r'weight$', (None,))]
  assert match_partition_rules(rules, named) == {
      'a.weight': ('tensor', None), 'b.weight': (None,), 'count': ()}
  with pytest.raises(ValueError, match="no partition rule matches 'b.w"):
    match_partition_rules([(r'^a', ())], {'b.w': torch.zeros(3)})


def test_batch_specs_are_the_jax_packages():
  from lddl_tpu.parallel.mesh import batch_pspec as jax_batch_pspec
  from lddl_tpu.parallel.mesh import canonical_batch_spec as jax_canonical
  assert batch_pspec() == tuple(jax_batch_pspec())
  assert batch_pspec(3, None) == tuple(jax_batch_pspec(3, None))
  jmesh = make_mesh(fsdp=2, tensor=2, devices=jax.devices()[:4])
  for shape in ((8, 64), (8,), (8, 64, 3)):
    assert canonical_batch_spec(None, shape) == tuple(
        jax_canonical(jmesh, shape)), shape
  # The seq axis is ported: a seq mesh shards dim 1 as JAX's does, and a
  # length seq does not divide is refused by the batch layout.
  smesh = make_mesh(seq=2, devices=jax.devices()[:2])
  for shape in ((8, 64), (8, 63)):
    assert canonical_batch_spec(_Mesh(1, 0, seq=2), shape) == tuple(
        jax_canonical(smesh, shape)), shape
  with pytest.raises(ValueError, match='length 63 does not split over '
                     'seq=2'):
    seq_columns(_Mesh(1, 0, seq=2), 63)


def test_make_flash_attention_runs_a_ranks_heads_and_refuses_seq():
  """The mesh wrapper is flash_attention on the arrays the rank holds (its
  rows and heads), checked against each other; a mesh with seq above 1
  raises the JAX package's ValueError."""
  from lddl_tpu_torch.ops.flash_attention import (flash_attention,
                                                  make_flash_attention)
  rng = np.random.default_rng(0)
  q, k, v = (torch.from_numpy(rng.standard_normal((2, 1, 16, 32),
                                                  np.float32))
             for _ in range(3))
  mask = torch.ones(2, 16, dtype=torch.int32)
  seg = torch.from_numpy(np.repeat([[0] * 9 + [1] * 7], 2, 0))
  mesh = _Mesh(2, 1)
  torch.testing.assert_close(make_flash_attention(mesh)(q, k, v, mask),
                             flash_attention(q, k, v, mask), rtol=0, atol=0)
  torch.testing.assert_close(
      make_flash_attention(mesh, with_segment_ids=True)(q, k, v, mask, seg),
      flash_attention(q, k, v, mask, seg, seg), rtol=0, atol=0)
  with pytest.raises(ValueError, match='mask'):
    make_flash_attention(mesh)(q, k, v, mask[:1])
  with pytest.raises(TypeError, match='with_segment_ids=False'):
    make_flash_attention(mesh)(q, k, v, mask, seg)
  with pytest.raises(ValueError, match='does not shard the sequence'):
    make_flash_attention(_Mesh(1, 0, seq=2))


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
def test_shards_are_gspmds_and_gather_back(fused):
  """Rank t's shard of each whole parameter is the block GSPMD places on
  the device at tensor index t (the fused q/k/v projection: rank t's
  heads of q, k and v, which jnp.split of GSPMD's block gives); the
  shards of both ranks gather back to the whole tensor."""
  jmesh = make_mesh(tensor=2, devices=jax.devices()[:2])
  model = JaxBert(JaxConfig(dtype=jnp.float32, fused_qkv=fused, **TINY),
                  mesh=jmesh)
  params = init_params(model, jmesh, jax.random.key(3), seq_len=16)
  whole = flax_to_state_dict(jax.device_get(params))
  placement = BertForPretraining(BertConfig(fused_qkv=fused,
                                            **TINY)).placement()
  per_device = [flax_to_state_dict(jax.tree.map(
      lambda a, d=d: np.asarray(next(s.data for s in a.addressable_shards
                                     if s.device == d)), params))
                for d in jmesh.devices.reshape(-1)]
  cut = 0
  for name, t in whole.items():
    spec, blocks = placement[name], param_blocks(name)
    mine = [shard(t, spec, _Mesh(2, r), blocks) for r in range(2)]
    for r in range(2):
      want = per_device[r][name]
      if blocks > 1:
        # jnp.split of GSPMD's block of [q; k; v]: rank r's heads of each.
        n = t.shape[0] // 3
        want = torch.cat([t[b * n + r * n // 2:b * n + (r + 1) * n // 2]
                          for b in range(3)])
      torch.testing.assert_close(mine[r], want, rtol=0, atol=0,
                                 msg=f'{name} rank {r}')
    cut += mine[0].numel() != t.numel()
    assert torch.equal(unshard(torch.stack(mine), spec, blocks), t), name
  # The word table, mlm_bias, and per layer q/k/v (or qkv) with their
  # biases, out, intermediate with its bias and output.
  assert cut == 2 + TINY['num_layers'] * (6 if fused else 10)


# ---- two gloo ranks on a tensor=2 mesh ----


@pytest.fixture(scope='module')
def tp_run(tmp_path_factory):
  dropout = {'cfg': dict(TINY, dropout_rate=0.1),
             'batches': [_pairs(8, 64, 70), _pairs(8, 64, 71)]}
  # A world-1 run's checkpoint after 2 steps, and its third step.
  ckpt = str(tmp_path_factory.mktemp('tp_ckpt'))
  batches = pairs_batches(80)
  w1 = TrainLoop.build(model_cfg=BertConfig(dtype=torch.float32, **TINY),
                       device='cpu', seed=5, **OPT)
  w1.model.train()
  for b in batches[:2]:
    w1.step_fn({k: torch.from_numpy(v) for k, v in b.items()},
               w1.dropout_seed)
  w1.step = 2
  w1.save(ckpt)
  world1 = {'digest': w1.state_digest()}
  world1['next'] = {k: float(v) for k, v in w1.step_fn(
      {k: torch.from_numpy(v) for k, v in batches[2].items()},
      w1.dropout_seed).items()}
  cli = ['--path', SHARDS, '--vocab-file', VOCAB, '--model', 'tiny',
         '--bin-size', '128', '--max-seq-length', '512', '--batch-size', '4',
         '--steps', '2', '--warmup-steps', '1', '--log-every', '1',
         '--attention', 'flash', '--device', 'cpu', '--comm', 'torch',
         '--tp', '2']
  refs, port = mesh_world(
      {'tensor': 2}, list(CASES), ranks.tp_world, 2,
      extra=({'dir': ckpt, 'cfg': TINY, 'next': batches[2]}, cli,
             [_pairs(8, 64, 90), _pairs(8, 64, 91)]),
      more=[dropout])
  return {'refs': refs, 'port': port, 'world1': world1,
          'next_batch': batches[2]}


@pytest.mark.parametrize('name', list(CASES))
def test_tensor2_matches_jax_tensor_mesh(tp_run, name):
  i = list(CASES).index(name)
  port = [tp_run['port'][r]['cases'][i] for r in range(2)]
  check_case(name, tp_run['refs'][name], port, 2)
  for r in range(2):
    assert port[r]['dp'] == (0, 1)
    assert port[r]['exchange'] == 'DataParallel'
    assert port[r]['backend'] == 'gloo'


def test_tensor_group_stays_bit_equal(tp_run):
  for i in range(len(CASES) + 1):
    check_tensor_groups([tp_run['port'][r]['cases'][i] for r in range(2)],
                        [(0, 1)])
  dropout = [tp_run['port'][r]['cases'][len(CASES)] for r in range(2)]
  losses = [[s['metrics']['loss'] for s in d['steps']] for d in dropout]
  assert losses[0] == losses[1] and np.isfinite(losses[0]).all()
  # Each rank holds the cut parameters' halves and the rest whole.
  sizes = dropout[0]['sizes']
  assert sizes['local'] == sizes['opt'] == sizes['mu'] < sizes['whole']


def test_world1_checkpoint_restores_at_tensor2(tp_run):
  for r in range(2):
    restored = tp_run['port'][r]['restored']
    assert restored['digest'] == tp_run['world1']['digest']
    assert restored['meta'] == (2, 0)
    for k in NAMES:
      np.testing.assert_allclose(restored['next'][k],
                                 tp_run['world1']['next'][k], rtol=2e-4,
                                 atol=1e-7, err_msg=k)
  assert (tp_run['port'][0]['restored']['replicated'] ==
          tp_run['port'][1]['restored']['replicated'])


def test_model_refusals_and_rows_of_a_tensor_group(tp_run):
  for r in range(2):
    port = tp_run['port'][r]
    assert set(port['refused']) == {'num_heads', 'intermediate_size',
                                    'vocab_size', 'seq'}
    assert 'tensor=2' in port['refused']['vocab_size']
    # make_mesh(seq=2) builds; the model refuses flash attention there
    # (the seq axis runs ring attention).
    assert port['seq_mesh'] == 'data=1, fsdp=1, tensor=1, seq=2'
    assert "attention_impl='flash' on a mesh with seq=2" in (
        port['refused']['seq'])
    np.testing.assert_array_equal(port['rows'],
                                  tp_run['next_batch']['input_ids'])


def test_loop_counts_samples_of_batch_ranks_and_flops_per_tensor_rank(
    tp_run):
  """Two steps of 8 rows over a tensor=2 world: 16 samples, not 32, and
  each rank's MFU numerator is half the model's step."""
  for r in range(2):
    counted = tp_run['port'][r]['counted']
    assert counted['samples'] == counted['samples_seen'] == 16
    assert counted['flops'] * 2 == counted['model_flops']
    assert counted['mfu_count'] == 0  # no peak known for the CPU


def test_cli_trains_with_tp2(tp_run):
  cli = [tp_run['port'][r]['cli'] for r in range(2)]
  for c in cli:
    assert (c['step'], c['samples'], c['dp']) == (2, 8, (0, 1))
    assert c['heads'] == 1
  assert cli[0]['digest'] == cli[1]['digest']
  whole = BertForPretraining(BertConfig(
      vocab_size=30528, hidden_size=128, num_layers=2, num_heads=2,
      intermediate_size=512, max_position_embeddings=512))
  assert cli[0]['local'] < sum(p.numel() for p in whole.parameters())


@pytest.mark.parametrize('flag', [['--tp', '2'], ['--fsdp', '2']])
def test_replay_cli_refuses_a_sharded_step(tmp_path, flag, capsys):
  """One replay process cannot re-execute a sharded step bit for bit: in
  a world of one the step replay refuses --tp and --fsdp above 1 (exit
  2), naming the launch it needs, the run's two ranks under --comm
  torch (tests/test_torch_replay_ranks.py launches it so)."""
  from lddl_tpu_torch.replay.cli import main
  assert main(['step', '--checkpoint-dir', str(tmp_path), '--step', '1',
               '--vocab-size', '128', '--device', 'cpu'] + flag) == 2
  err = capsys.readouterr().err
  assert 'WORLD_SIZE=2' in err and '--comm torch' in err
