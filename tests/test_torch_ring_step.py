"""Sequence-parallel BERT training of lddl_tpu_torch vs lddl_tpu's seq
meshes, on the CPU.

Spawned gloo ranks (``tests/torch_dist_ranks.py:seq_world``) step
``TrainLoop``'s step over ``make_mesh(seq=2)`` (2 ranks) and
``make_mesh(data=2, seq=2)`` (4 ranks) on the same numpy global batches
(``make_global_batch``: a rank keeps its rows and its half of each) from
the same converted init as ``lddl_tpu.parallel.make_train_step`` over the
same axes on the 8-device CPU platform (run while the ranks run; the
``data=2, seq=2`` world is ``tests/test_torch_ring_dp.py``'s). Two cases
on each mesh: pairs rows (the first batch's halves masked at 0.5
and 0.04) with the masked-only head (``max_predictions`` 48) and
``attention_impl='ring'`` (dense blocks), and packed block-diagonal rows
(``per_doc_mlm_loss``, logits at every position) with ``'ring_flash'``
(JAX's Pallas kernels in interpret mode, the port's plain versions).
Tiny config (2 layers, hidden 64, 2 heads, vocab 128), float32, dropout
off, 3 steps. Compared: the deterministic forward's logits on the first
batch (whole rows on every seq rank; rtol 2e-4, atol 2e-5), the first
step's gradients summed over the ranks (atol 5e-5, the tolerance
``test_torch_tp.py`` holds parameters to), every step's loss, parts,
``mlm_acc`` and ``grad_norm`` (rtol 2e-4, as ``test_torch_tp.py``) and
the parameters after the 3 AdamW steps (atol 5e-5). Every rank holds
the whole parameters, bit-equal after every step. The same world checks
that flash attention on the seq mesh is refused and, on ``seq=2``, that
the pretrain CLI trains 2 steps with ``--sp 2 --attention ring_flash``
from the committed shards.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist_ranks as ranks
from lddl_tpu.models import BertConfig as JaxConfig
from lddl_tpu.models import BertForPretraining as JaxBert
from lddl_tpu.parallel import init_params, make_mesh, make_train_step
from lddl_tpu.parallel import shard_batch
from lddl_tpu.parallel.train import pretrain_loss as jax_pretrain_loss
from lddl_tpu_torch.models import flax_to_state_dict
from test_torch_dp import NAMES, OPT, TINY, _packed, _pairs, _uneven
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = os.path.join(ROOT, 'tests', 'assets', 'torch_shards', 'pairs')
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
PARAM_ATOL = 5e-5

# name -> (batches, model settings beside TINY, max_predictions)
CASES = {
    'pairs-ring-maxpred': (
        lambda: [_uneven(8, 64, 200), _pairs(8, 64, 201),
                 _pairs(8, 64, 202)], {'attention_impl': 'ring'}, 48),
    'packed-ring_flash': (
        lambda: [_packed(4, 128, 210 + i) for i in range(3)],
        {'attention_impl': 'ring_flash'}, None),
}
MESHES = {'seq2': ({'seq': 2}, 2), 'data2-seq2': ({'data': 2, 'seq': 2}, 4),
          'fsdp2-seq2': ({'fsdp': 2, 'seq': 2}, 4)}
CLI = ['--path', SHARDS, '--vocab-file', VOCAB, '--model', 'tiny',
       '--bin-size', '128', '--max-seq-length', '512', '--batch-size', '4',
       '--steps', '2', '--warmup-steps', '1', '--log-every', '1',
       '--attention', 'ring_flash', '--device', 'cpu', '--comm', 'torch',
       '--sp', '2']


def jax_init(axes, cfg_kw, seq_len):
  """lddl_tpu's model over a mesh of ``axes``, its params placed there,
  and the init as a whole numpy state dict."""
  n = int(np.prod(list(axes.values())))
  mesh = make_mesh(devices=jax.devices()[:n], **axes)
  model = JaxBert(JaxConfig(dtype=jnp.float32, **cfg_kw), mesh=mesh)
  params = init_params(model, mesh, jax.random.key(1), seq_len=seq_len)
  state = {k: v.numpy() for k, v in
           flax_to_state_dict(jax.device_get(params)).items()}
  return (mesh, model, params), state


def jax_steps(jax_model, batches, max_predictions):
  """The first batch's logits and gradients, every step's metrics and
  the final parameters (whole numpy state dict)."""
  mesh, model, params = jax_model
  first = shard_batch(batches[0], mesh)
  logits = jax.jit(lambda p, b: model.apply(
      {'params': p}, b['input_ids'], b['token_type_ids'],
      b['attention_mask'], segment_ids=b.get('segment_ids')))(params, first)
  grads = jax.jit(jax.grad(lambda p, b: jax_pretrain_loss(
      model, p, b, max_predictions=max_predictions)[0]))(params, first)
  schedule = optax.warmup_cosine_decay_schedule(
      0.0, OPT['learning_rate'], OPT['warmup_steps'],
      max(OPT['total_steps'], OPT['warmup_steps'] + 1))
  tx = optax.adamw(schedule, weight_decay=OPT['weight_decay'])
  opt_state = tx.init(params)
  step = make_train_step(model, tx, mesh, max_predictions=max_predictions)
  metrics = []
  for batch in batches:
    params, opt_state, m = step(params, opt_state, jax.random.key(2),
                                shard_batch(batch, mesh))
    metrics.append({k: float(m[k]) for k in NAMES})
  return {'logits': tuple(np.asarray(x) for x in logits),
          'grads': {k: v.numpy() for k, v in
                    flax_to_state_dict(jax.device_get(grads)).items()},
          'metrics': metrics,
          'final': {k: v.numpy() for k, v in
                    flax_to_state_dict(jax.device_get(params)).items()},
          'first': batches[0]}


def seq_run(mesh_name, names=tuple(CASES)):
  """The port's world on mesh ``mesh_name`` over the cases ``names``,
  started from JAX's init, with JAX's steps run while the ranks run:
  (JAX's references by case, the ranks' results, the axes, the world
  size)."""
  axes, world = MESHES[mesh_name]
  models, cases = {}, []
  for name in names:
    make, kw, max_predictions = CASES[name]
    batches = make()
    cfg = dict(TINY, **kw)
    models[name], state = jax_init(axes, cfg,
                                   batches[0]['input_ids'].shape[1])
    cases.append({'cfg': cfg, 'batches': batches, 'state': state,
                  'max_predictions': max_predictions})
  procs, q = ranks.start_world(
      ranks.seq_world, world,
      args=(axes, cases, OPT, CLI if mesh_name == 'seq2' else None))
  try:
    refs = {name: jax_steps(models[name], case['batches'],
                            case['max_predictions'])
            for name, case in zip(names, cases)}
  except BaseException:
    for p in procs:
      p.kill()
    raise
  return refs, ranks.join_world(procs, q), axes, world


@pytest.fixture(scope='module')
def seq2_run():
  return seq_run('seq2')


def _rows_cols(axes, world, rank, first):
  """The rows and columns of a global batch rank ``rank`` holds."""
  seq = axes['seq']
  dp = world // seq
  b, s = first['input_ids'].shape
  r, c = rank // seq, rank % seq
  return (slice(r * b // dp, (r + 1) * b // dp),
          slice(c * s // seq, (c + 1) * s // seq))


def check_step(run, name):
  """The case ``name`` of a seq mesh's run against JAX's: the fed rows
  and columns, the logits on every rank, the first step's gradients, every
  step's metrics (the same on every rank) and the final parameters."""
  refs, port, axes, world = run
  ref = refs[name]
  i = list(refs).index(name)
  got = [port[r]['cases'][i] for r in range(world)]
  seq = axes['seq']
  for r in range(world):
    rows, cols = _rows_cols(axes, world, r, ref['first'])
    np.testing.assert_array_equal(got[r]['fed_cols'],
                                  ref['first']['input_ids'][rows, cols])
    np.testing.assert_array_equal(got[r]['fed'],
                                  ref['first']['input_ids'][rows, cols])
    assert got[r]['seq_rank'] == r % seq
    assert got[r]['dp'] == (r // seq, world // seq)
    # Whole rows on every seq rank: the ref's rows, every position.
    for j, part in enumerate(('mlm', 'nsp')):
      np.testing.assert_allclose(got[r]['logits'][j], ref['logits'][j][rows],
                                 rtol=2e-4, atol=2e-5,
                                 err_msg=f'{name} rank {r} {part} logits')
  for k, want in ref['grads'].items():
    np.testing.assert_allclose(got[0]['grads'][k], want, rtol=0,
                               atol=PARAM_ATOL, err_msg=f'{name} grad {k}')
  for step, want in enumerate(ref['metrics']):
    m = got[0]['steps'][step]['metrics']
    for r in range(1, world):
      assert got[r]['steps'][step]['metrics'] == m, (name, step, r)
    for k in NAMES:
      np.testing.assert_allclose(m[k], want[k], rtol=2e-4, atol=1e-7,
                                 err_msg=f'{name} step {step} {k}')
  for k, want in ref['final'].items():
    np.testing.assert_allclose(got[0]['state'][k], want, rtol=0,
                               atol=PARAM_ATOL, err_msg=f'{name} {k}')


def check_bit_equal(run, exchange='DataParallel'):
  """No parameter is cut over seq (or data): every rank's copy of every
  parameter is bit-equal after every step, and the states' digests too;
  the exchange sums over data x fsdp x seq."""
  refs, port, _, world = run
  for i in range(len(refs)):
    got = [port[r]['cases'][i] for r in range(world)]
    for step in range(len(got[0]['steps'])):
      assert len({g['steps'][step]['replicated'] for g in got}) == 1
    assert len({g['digest'] for g in got}) == 1
    for g in got:
      assert (g['exchange'], g['backend']) == (exchange, 'gloo')
      assert g['sizes']['local'] == g['sizes']['whole']


def check_mesh_and_refusal(run):
  """make_mesh built the seq mesh; flash attention on it is refused."""
  _, port, axes, world = run
  for r in range(world):
    assert port[r]['mesh'] == ', '.join(
        f'{a}={axes.get(a, 1)}' for a in ('data', 'fsdp', 'tensor', 'seq'))
    assert "attention_impl='flash'" in port[r]['refused']
    assert 'seq=2' in port[r]['refused']


def test_cli_trains_with_sp2(seq2_run):
  _, port, _, world = seq2_run
  cli = [port[r]['cli'] for r in range(world)]
  for c in cli:
    assert (c['step'], c['samples'], c['dp']) == (2, 8, (0, 1))
    assert c['mesh'] == 'data=1, fsdp=1, tensor=1, seq=2'
  assert cli[0]['digest'] == cli[1]['digest']


@pytest.mark.parametrize('name', list(CASES))
def test_seq2_step_matches_jax(seq2_run, name):
  check_step(seq2_run, name)


def test_seq2_ranks_stay_bit_equal(seq2_run):
  check_bit_equal(seq2_run)


def test_seq2_mesh_builds_and_refuses_flash(seq2_run):
  check_mesh_and_refusal(seq2_run)
