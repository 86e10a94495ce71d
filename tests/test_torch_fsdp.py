"""Sharded-state data parallelism of lddl_tpu_torch vs lddl_tpu's fsdp
meshes, on the CPU.

Spawned gloo ranks (``tests/torch_dist_ranks.py``) step ``TrainLoop``'s
step over ``make_mesh(fsdp=2)`` (2 ranks), ``make_mesh(fsdp=2,
tensor=2)`` (4 ranks) and ``make_mesh(data=2, fsdp=2)`` (4 ranks: the
flattened data x fsdp group ``make_mesh`` builds, and the all-reduce over
``data`` after the fsdp reduce-scatter) on the same numpy global batches
and converted init as ``lddl_tpu.parallel.make_train_step`` over the same
axes on the 8-device CPU platform (``test_torch_tp.py``'s oracle, run
while the ranks run). The first two meshes take a pairs and a packed
case, fused and unfused q/k/v between them, with flash (Pallas in
interpret mode on the JAX side) on fsdp=2 and dense attention on fsdp=2 x
tensor=2; data=2 x fsdp=2 takes one pairs case. Tolerance as
``test_torch_tp.py``: rtol 2e-4 on the metrics, atol 5e-5 on the
gathered parameters after 3 steps.

The port's fsdp shards one flat float32 buffer of the rank's parameters
(``ShardedDataParallel``): at rest a rank holds half of it, and half of
AdamW's ``mu`` and ``nu``, and no working copy; a save gathers the
state without a flat buffer beyond the gradients' one a step holds. A
checkpoint written at
fsdp=2 x tensor=2 is world 1's file: restored at world 1 it equals the
ranks' gathered state bit for bit, and its next step matches theirs at
rtol 2e-4.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from lddl_tpu_torch.models import BertConfig
from lddl_tpu_torch.training import TrainLoop
from test_torch_dp import NAMES, OPT, TINY, _pairs
from test_torch_tp import check_case, check_tensor_groups, mesh_world
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


FSDP_CASES = ['pairs-fused-flash', 'packed-unfused-flash']
BOTH_CASES = ['pairs-unfused-dense', 'packed-fused-dense']
DATA_CASES = ['pairs-unfused-dense']


@pytest.fixture(scope='module')
def fsdp_run():
  return mesh_world({'fsdp': 2}, FSDP_CASES, ranks.mesh_steps, 2)


@pytest.fixture(scope='module')
def both_run(tmp_path_factory):
  ckpt = str(tmp_path_factory.mktemp('fsdp_tp_ckpt'))
  dropout = {'cfg': dict(TINY, dropout_rate=0.1),
             'batches': [_pairs(8, 64, 170), _pairs(8, 64, 171)]}
  nxt = _pairs(8, 64, 180)
  refs, port = mesh_world(
      {'fsdp': 2, 'tensor': 2}, BOTH_CASES, ranks.mesh_steps, 4,
      extra=({'dir': ckpt, 'case': 0, 'next': nxt},), more=[dropout])
  return refs, port, ckpt, nxt


@pytest.fixture(scope='module')
def data_fsdp_run():
  return mesh_world({'data': 2, 'fsdp': 2}, DATA_CASES, ranks.mesh_steps, 4)


@pytest.mark.parametrize('name', FSDP_CASES)
def test_fsdp2_matches_jax_fsdp_mesh(fsdp_run, name):
  refs, port = fsdp_run
  i = FSDP_CASES.index(name)
  got = [port[r][i] for r in range(2)]
  check_case(name, refs[name], got, 2)
  assert [g['dp'] for g in got] == [(0, 2), (1, 2)]
  for g in got:
    assert (g['exchange'], g['backend']) == ('ShardedDataParallel', 'gloo')


def test_fsdp2_keeps_half_of_the_state_at_rest(fsdp_run):
  """Each rank's AdamW runs on half of the flat parameters (padded to an
  even length a rank), with moments of that size; the working buffer the
  model's parameters view is freed between steps; the two ranks' halves
  gather to one state, the same on both."""
  _, port = fsdp_run
  for case in range(len(FSDP_CASES)):
    got = [port[r][case] for r in range(2)]
    for g in got:
      sizes = g['sizes']
      half = -(-sizes['whole'] // 4) * 2
      assert sizes['local'] == sizes['whole']
      assert sizes['opt'] == sizes['mu'] == sizes['nu'] == half
      assert sizes['working_bytes_at_rest'] == 0
    assert got[0]['digest'] == got[1]['digest']


@pytest.mark.parametrize('name', BOTH_CASES)
def test_fsdp2_tensor2_matches_jax_mesh(both_run, name):
  refs, port, _, _ = both_run
  i = BOTH_CASES.index(name)
  got = [port[r][i] for r in range(4)]
  check_case(name, refs[name], got, 4)
  # Ranks (fsdp, tensor): 0 = (0, 0), 1 = (0, 1), 2 = (1, 0), 3 = (1, 1).
  assert [g['dp'] for g in got] == [(0, 2), (0, 2), (1, 2), (1, 2)]
  for g in got:
    assert g['exchange'] == 'ShardedDataParallel'
    assert g['sizes']['opt'] == -(-g['sizes']['local'] // 4) * 2


def test_fsdp2_tensor2_tensor_groups_stay_bit_equal(both_run):
  _, port, _, _ = both_run
  for case in range(len(BOTH_CASES) + 1):
    check_tensor_groups([port[r][case] for r in range(4)], [(0, 1), (2, 3)])
  dropout = [port[r][len(BOTH_CASES)] for r in range(4)]
  losses = [[s['metrics']['loss'] for s in d['steps']] for d in dropout]
  assert losses[0] == losses[1] == losses[2] == losses[3]
  assert np.isfinite(losses[0]).all()


def test_fsdp2_tensor2_checkpoint_restores_at_world1(both_run):
  _, port, ckpt, nxt = both_run
  w1 = TrainLoop.build(model_cfg=BertConfig(dtype=torch.float32, **TINY),
                       device='cpu', seed=5, **OPT)
  assert w1.latest_meta(ckpt) == (3, 0)
  w1.restore(ckpt)
  assert {port[r][0]['digest'] for r in range(4)} == {w1.state_digest()}
  w1.model.train()
  m = w1.step_fn({k: torch.from_numpy(v) for k, v in nxt.items()},
                 w1.dropout_seed)
  for k in NAMES:
    np.testing.assert_allclose(float(m[k]), port[0][0]['next'][k],
                               rtol=2e-4, atol=1e-7, err_msg=k)
  assert all(port[r][0]['next'] == port[0][0]['next'] for r in range(4))


def test_data2_fsdp2_matches_jax_mesh(data_fsdp_run):
  """The flattened data x fsdp group: each rank's group rank is its batch
  rank, ``(data, fsdp)`` flattened in the JAX mesh's order, and the
  gradients summed over fsdp and then data give JAX's steps."""
  refs, port = data_fsdp_run
  got = [port[r][0] for r in range(4)]
  check_case(DATA_CASES[0], refs[DATA_CASES[0]], got, 4)
  # Ranks (data, fsdp): 0 = (0, 0), 1 = (0, 1), 2 = (1, 0), 3 = (1, 1).
  assert [g['dp'] for g in got] == [(r, 4) for r in range(4)]
  assert [g['batch_group'] for g in got] == [(r, 4) for r in range(4)]
  for g in got:
    assert g['exchange'] == 'ShardedDataParallel'
    assert g['sizes']['opt'] == -(-g['sizes']['whole'] // 4) * 2
  assert len({g['digest'] for g in got}) == 1


@pytest.mark.parametrize('world', ['fsdp2', 'fsdp2-tensor2', 'data2-fsdp2'])
def test_a_save_needs_less_than_one_flat_buffer(request, world):
  """A snapshot of the state (what save, state_digest and the ledger's
  step lines gather) allocates, beyond the CPU copies it returns, less
  than one flat buffer of the rank's parameters at any time: the
  parameters, mu and nu are gathered one after the other into the
  gradients' flat buffer and copied out a tensor at a time."""
  fixture = {'fsdp2': 'fsdp_run', 'fsdp2-tensor2': 'both_run',
             'data2-fsdp2': 'data_fsdp_run'}[world]
  port = request.getfixturevalue(fixture)[1]
  for r, cases in port.items():
    for case in cases:
      got = case['save_bytes']
      assert got['flat'] > 0
      assert got['transient'] < got['flat'], (world, r, got)
