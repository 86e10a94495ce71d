"""lddl_tpu_torch's packed collate and np.save wire format vs lddl_tpu's.

The same wire rows (tests/test_block_diagonal.py::TestPackedCollateSegmentIds
builds them as preprocess/packed.py writes them) go through both collates;
every key of the batch must be byte-equal, masks and segment ids included.
"""

import numpy as np
import pytest

from lddl_tpu.core import utils as jutils
from lddl_tpu.loader.packed import PackedCollate as JaxPackedCollate
from lddl_tpu_torch.core import utils as tutils
from lddl_tpu_torch.loader.packed import PackedCollate
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


class _Tok:
  cls_token_id = 101
  sep_token_id = 102
  mask_token_id = 103
  pad_token_id = 0
  vocab_size = 30000


def _rows(specs, seq_len):
  """[CLS] p0 [SEP] p1 [SEP] ... rows of the given piece lengths, each
  piece's first token marked in doc_offsets."""
  rows = []
  for pieces in specs:
    ids, marks = [101], []
    for plen in pieces:
      marks.append(len(ids))
      ids.extend([1000 + i for i in range(plen)])
      ids.append(102)
    assert len(ids) <= seq_len
    rows.append({
        'input_ids': jutils.serialize_np_array(np.asarray(ids, np.uint16)),
        'doc_offsets': jutils.serialize_np_array(np.asarray(marks,
                                                            np.uint16)),
        'num_tokens': len(ids),
    })
  return rows


@pytest.mark.parametrize('block_diagonal', [True, False])
@pytest.mark.parametrize('specs,seq_len,step', [
    ([[10, 7, 20], [40]], 64, 0),   # TestPackedCollateSegmentIds rows
    ([[30], [14, 10]], 32, 3),      # split-document chunks
    ([[10]], 32, 1),
    ([[100, 250, 37, 400], [600, 5], [1, 1, 1]], 1024, 7),
])
def test_collate_is_byte_equal_to_jax(specs, seq_len, step, block_diagonal):
  rows = _rows(specs, seq_len)
  kw = dict(base_seed=12345, dp_rank=1, block_diagonal=block_diagonal)
  ref = JaxPackedCollate(_Tok(), **kw)(rows, seq_len, epoch=2, step=step)
  got = PackedCollate(_Tok(), **kw)(rows, seq_len, epoch=2, step=step)
  assert sorted(got) == sorted(ref)
  assert ('segment_ids' in got) == block_diagonal
  for key in ref:
    assert got[key].dtype == ref[key].dtype, key
    assert got[key].shape == ref[key].shape, key
    assert got[key].tobytes() == ref[key].tobytes(), key


def test_collate_rejects_a_row_longer_than_the_bin():
  with pytest.raises(AssertionError, match='exceeds'):
    PackedCollate(_Tok())(_rows([[40]], 64), 32, epoch=0, step=0)


@pytest.mark.parametrize('array', [
    np.arange(7, dtype=np.uint16),
    np.arange(300, dtype=np.int32) - 5,
    np.zeros(0, dtype=np.uint16),
    np.arange(12, dtype=np.float32).reshape(3, 4),
])
def test_wire_format_is_byte_equal_to_jax(array):
  wire = tutils.serialize_np_array(array)
  assert wire == jutils.serialize_np_array(array)
  back = tutils.deserialize_np_array(wire)
  assert back.dtype == array.dtype and np.array_equal(back, array)
  assert back.flags.writeable
