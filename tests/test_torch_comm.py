"""lddl_tpu_torch.comm on the CPU: the cases of tests/test_comm.py
(NullBackend, FileBackend over three spawned ranks with uneven payloads
and garbage collection, get_backend from the environment) on the port's
backends, and TorchDistBackend over two spawned gloo ranks: collectives,
its TCPStore lease store (the claim CAS, the key index, heartbeats) and
topology discovery."""

import os

import numpy as np
import pytest

import torch_dist_ranks as ranks
from lddl_tpu_torch.comm import (FileBackend, NullBackend, TorchDistBackend,
                                 get_backend)
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


def test_null_backend():
  b = NullBackend()
  assert b.rank == 0 and b.world_size == 1
  assert b.allgather_object('x') == ['x']
  np.testing.assert_array_equal(
      b.allreduce_sum(np.array([1, 2])), np.array([1, 2]))
  b.barrier()
  assert b.broadcast_object(7) == 7
  assert b.lease_store('ns') is None


def test_file_backend_three_ranks_and_garbage_collection(tmp_path):
  world = 3
  results = ranks.run_world(ranks.comm_file_ranks, world,
                            args=(str(tmp_path),))
  for rank in range(world):
    got, total, root_val = results[rank]
    assert [g['rank'] for g in got] == [0, 1, 2]
    assert got[2]['sq'] == 4
    assert [len(g['pad']) for g in got] == [100, 200, 300]
    assert total == [3, 3, 3]  # 0+1+2
    assert root_val == 'from-1'
  # 25 collectives ran; all but the last few op files (bounded by rank
  # skew at exit, < world) must be gone.
  op_files = [f for f in os.listdir(tmp_path) if '.op' in f]
  assert len(op_files) <= 2 * world * world


def test_torch_backend_two_ranks():
  world = 2
  results = ranks.run_world(ranks.comm_torch_ranks, world)
  claims = [results[r]['claim'] for r in range(world)]
  assert sorted(claims, key=str) == [0, None] or sorted(
      claims, key=str) == [1, None], claims
  winner = claims.index(None)
  for rank in range(world):
    out = results[rank]
    assert (out['rank'], out['world']) == (rank, world)
    assert out['backend'] == 'gloo'
    assert [g['rank'] for g in out['got']] == [0, 1]
    assert [len(g['payload']) for g in out['got']] == [100, 200]
    assert out['total'] == [3, 3, 3, 3]
    assert out['ftotal'] == [1.5, 1.5]
    assert out['utotal'] == [1, 1]
    assert out['root'] == 'from-1'
    assert out['topology'] == (rank, world, rank, 0, world)
    # A repeated claim by the winner reads as owned, as on the file store.
    assert out['claim_again'] == winner
    assert out['claims'] == ['claim.5.g0']
    assert out['done'] == ['done.0', 'done.1']
    assert out['reads'] == [b'r0', b'r1']
    assert out['missing'] is None
    assert out['hb'] == [7, 8]
  assert results[0]['seq'] == results[1]['seq'] > 0


def test_torch_backend_without_a_launcher_is_one_rank(monkeypatch):
  for name in ('MASTER_ADDR', 'RANK', 'WORLD_SIZE',
               'LDDL_COORDINATOR_ADDRESS'):
    monkeypatch.delenv(name, raising=False)
  with pytest.warns(UserWarning, match='single-process'):
    b = TorchDistBackend()
  assert (b.rank, b.world_size) == (0, 1)
  assert b.allgather_object(3) == [3]
  np.testing.assert_array_equal(b.allreduce_sum(np.array([2.0])), [2.0])
  assert b.broadcast_object('x') == 'x'
  b.barrier()
  assert b.lease_store('ns') is None


def test_get_backend_env(tmp_path, monkeypatch):
  monkeypatch.setenv('LDDL_COMM', 'file')
  monkeypatch.setenv('LDDL_COMM_DIR', str(tmp_path))
  monkeypatch.setenv('LDDL_RANK', '0')
  monkeypatch.setenv('LDDL_WORLD_SIZE', '1')
  b = get_backend()
  assert isinstance(b, FileBackend)
  assert b.allgather_object(1) == [1]
  monkeypatch.setenv('LDDL_COMM', 'null')
  assert isinstance(get_backend(), NullBackend)
  with pytest.raises(ValueError, match='jax'):
    get_backend('jax')
