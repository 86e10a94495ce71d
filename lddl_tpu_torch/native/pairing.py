"""ctypes wrapper for the native NSP pair planner, copied from
:mod:`lddl_tpu.native.pairing`.

Drop-in for :func:`lddl_tpu_torch.preprocess.pairing.plan_pairs_partition`'s
hot loop: identical outputs and identical post-call ``rng`` state (the C++ side
embeds a CPython-exact ``random.Random``; see ``src/pairing.cpp``).
"""

import ctypes

import numpy as np

from .build import library


def plan_pairs_partition_native(docs, rng, max_seq_length=128,
                                short_seq_prob=0.1, duplicate_factor=1):
  """Native planner; same contract as the Python
  ``plan_pairs_partition`` (returns (a_ranges, b_ranges, is_random_next)
  and advances ``rng`` draw-for-draw)."""
  if max_seq_length < 5:
    # Same contract as the Python path: randint(2, max_seq_length - 3)
    # has an empty range below 5 and CPython raises — the C++ planner
    # cannot, so reject here before it runs.
    raise ValueError(f'max_seq_length must be >= 5, got {max_seq_length}')
  lib = library()
  version, state, gauss = rng.getstate()
  mt = np.array(state[:624], dtype=np.uint32)
  idx = ctypes.c_int32(state[624])

  n_docs = len(docs)
  n_sents = len(docs.sent_offsets) - 1
  cap = max(1, int(duplicate_factor) * n_sents)
  out = np.empty((cap, 5), dtype=np.int64)
  i64p = ctypes.POINTER(ctypes.c_int64)
  n = lib.lddl_plan_pairs(
      docs.sent_offsets.ctypes.data_as(i64p),
      docs.doc_sent_start.ctypes.data_as(i64p),
      ctypes.c_int64(n_docs),
      mt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
      ctypes.byref(idx),
      ctypes.c_int32(max_seq_length),
      ctypes.c_double(short_seq_prob),
      ctypes.c_int32(duplicate_factor),
      out.ctypes.data_as(i64p),
      ctypes.c_int64(cap))
  if n < 0:
    raise RuntimeError(
        f'native pair planner overflowed its {cap}-row buffer '
        '(impossible for well-formed inputs: one pair consumes >= 1 '
        'sentence)')
  rng.setstate((version, tuple(int(x) for x in mt) + (int(idx.value),),
                gauss))
  if n == 0:
    empty = np.zeros((0, 2), dtype=np.int64)
    return empty, empty.copy(), np.zeros(0, dtype=bool)
  arr = out[:n]
  return (arr[:, 0:2].copy(), arr[:, 2:4].copy(),
          arr[:, 4].astype(bool))
