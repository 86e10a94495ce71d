"""Sequence parallelism beside data parallelism: lddl_tpu_torch's
``make_mesh(data=2, seq=2)`` (4 spawned gloo ranks) vs lddl_tpu's mesh of
the same axes, the cases and tolerances of ``tests/test_torch_ring_step.py``
(pairs with the masked-only head under dense ring blocks, packed
block-diagonal rows under flash ring blocks; logits, the first step's
gradients, 3 steps' metrics and the final parameters). The gradients sum
over the flattened ``data x seq`` group; every rank's parameters stay
bit-equal.
"""

import pytest

from test_torch_ring_step import (CASES, check_bit_equal,
                                  check_mesh_and_refusal, check_step,
                                  seq_run)
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


@pytest.fixture(scope='module')
def data2_seq2_run():
  return seq_run('data2-seq2')


@pytest.mark.parametrize('name', list(CASES))
def test_data2_seq2_step_matches_jax(data2_seq2_run, name):
  check_step(data2_seq2_run, name)


def test_data2_seq2_ranks_stay_bit_equal(data2_seq2_run):
  check_bit_equal(data2_seq2_run)


def test_data2_seq2_mesh_builds_and_refuses_flash(data2_seq2_run):
  check_mesh_and_refusal(data2_seq2_run)
