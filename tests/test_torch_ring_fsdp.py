"""Sequence parallelism beside sharded parameters: lddl_tpu_torch's
``make_mesh(fsdp=2, seq=2)`` (4 spawned gloo ranks) vs lddl_tpu's mesh of
the same axes, on the pairs case of ``tests/test_torch_ring_step.py``
(the masked-only head, dense ring blocks; logits, the first step's
gradients, 3 steps' metrics and the final parameters, its tolerances).
The ranks of a seq group hold the same fsdp shard: the gradients are
reduce-scattered over fsdp and the shard summed over the flattened
``data x seq`` group (``ShardedDataParallel``), and the gathered
parameters stay bit-equal on every rank.
"""

import pytest

from test_torch_ring_step import (check_bit_equal, check_mesh_and_refusal,
                                  check_step, seq_run)
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


@pytest.fixture(scope='module')
def fsdp2_seq2_run():
  return seq_run('fsdp2-seq2', names=('pairs-ring-maxpred',))


def test_fsdp2_seq2_step_matches_jax(fsdp2_seq2_run):
  check_step(fsdp2_seq2_run, 'pairs-ring-maxpred')


def test_fsdp2_seq2_ranks_stay_bit_equal(fsdp2_seq2_run):
  check_bit_equal(fsdp2_seq2_run, exchange='ShardedDataParallel')


def test_fsdp2_seq2_mesh_builds_and_refuses_flash(fsdp2_seq2_run):
  check_mesh_and_refusal(fsdp2_seq2_run)
