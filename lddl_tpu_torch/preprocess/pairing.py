"""Offset-based NSP pair planning, copied from
:mod:`lddl_tpu.preprocess.pairing`.

``plan_pairs_from_document`` is a draw-for-draw mirror of
``bert.create_pairs_from_document`` (the reference recipe,
``lddl/dask/bert/pretrain.py:241-365``) that operates on flat token-id
arrays + sentence offsets instead of Python token lists. Because chunk
sentences are consecutive, every segment is a contiguous *range* into the
flat id array — pairing becomes integer bookkeeping, and the expensive
token-list splicing of the reference disappears entirely.

Given the same ``rng``, the planned (A, B, is_random_next) are identical
to the materialized pairs of the JAX package's slow path; the native
planner (``native/src/pairing.cpp``) equals this module's loop draw for
draw (``tests/test_torch_preprocess.py``).
"""

import numpy as np


class TokenizedDocs:
  """Partition of documents as one flat id array + offsets.

  flat_ids: int32 [total_tokens]
  sent_offsets: int64 [n_sents + 1] — token ranges per sentence
  doc_sent_start: int64 [n_docs + 1] — sentence index ranges per doc
  (documents with zero sentences must already be dropped).
  """

  __slots__ = ('flat_ids', 'sent_offsets', 'doc_sent_start')

  def __init__(self, flat_ids, sent_offsets, doc_counts):
    self.flat_ids = np.ascontiguousarray(flat_ids, dtype=np.int32)
    self.sent_offsets = np.ascontiguousarray(sent_offsets, dtype=np.int64)
    doc_counts = np.asarray(doc_counts, dtype=np.int64)
    if (doc_counts == 0).any():
      raise ValueError('drop zero-sentence documents before planning')
    self.doc_sent_start = np.zeros(len(doc_counts) + 1, dtype=np.int64)
    np.cumsum(doc_counts, out=self.doc_sent_start[1:])

  def __len__(self):
    return len(self.doc_sent_start) - 1

  def num_sentences(self, d):
    return int(self.doc_sent_start[d + 1] - self.doc_sent_start[d])


def _truncate_counters(la, lb, max_num_tokens, rng):
  """Mirror of ``truncate_seq_pair``: returns (front_a, back_a, front_b,
  back_b) removal counts with the identical rng draw sequence."""
  fa = ba = fb = bb = 0
  while la + lb > max_num_tokens:
    if la > lb:
      if rng.random() < 0.5:
        fa += 1
      else:
        ba += 1
      la -= 1
    else:
      if rng.random() < 0.5:
        fb += 1
      else:
        bb += 1
      lb -= 1
  return fa, ba, fb, bb


def plan_pairs_from_document(docs, document_index, rng, out,
                             max_seq_length=128, short_seq_prob=0.1):
  """Plan pairs for one document, appending (a0, a1, b0, b1, is_random)
  tuples to ``out``. Draw-for-draw mirror of
  ``bert.create_pairs_from_document``."""
  soff = docs.sent_offsets
  ds = docs.doc_sent_start[document_index]
  n_sent = int(docs.doc_sent_start[document_index + 1] - ds)
  max_num_tokens = max_seq_length - 3
  target_seq_length = max_num_tokens
  if rng.random() < short_seq_prob:
    target_seq_length = rng.randint(2, max_num_tokens)

  chunk_first = 0  # sentence index (doc-local) of first sentence in chunk
  chunk_n = 0
  chunk_len = 0
  i = 0
  while i < n_sent:
    if chunk_n == 0:
      chunk_first = i
    sent_len = int(soff[ds + i + 1] - soff[ds + i])
    chunk_n += 1
    chunk_len += sent_len
    if i == n_sent - 1 or chunk_len >= target_seq_length:
      if chunk_n:
        a_end = 1 if chunk_n < 2 else rng.randint(1, chunk_n - 1)
        a0 = int(soff[ds + chunk_first])
        a1 = int(soff[ds + chunk_first + a_end])
        la = a1 - a0
        if chunk_n == 1 or rng.random() < 0.5:
          is_random_next = True
          target_b_length = target_seq_length - la
          random_document_index = document_index
          for _ in range(10):
            candidate = rng.randint(0, len(docs) - 1)
            if candidate != document_index:
              random_document_index = candidate
              break
          if random_document_index == document_index:
            is_random_next = False
          rds = docs.doc_sent_start[random_document_index]
          rn = int(docs.doc_sent_start[random_document_index + 1] - rds)
          start = rng.randint(0, rn - 1)
          # First sentence j >= start where cumulative length reaches
          # target_b_length (the slow path always takes >= 1 sentence).
          b0 = int(soff[rds + start])
          ends = soff[rds + start + 1:rds + rn + 1]
          j = int(np.searchsorted(ends, b0 + max(target_b_length, 1)))
          j = min(j, rn - start - 1)
          b1 = int(ends[j])
          # Unused trailing chunk sentences are replayed.
          i -= chunk_n - a_end
        else:
          is_random_next = False
          b0 = a1
          b1 = int(soff[ds + chunk_first + chunk_n])
        lb = b1 - b0
        fa, ba, fb, bb = _truncate_counters(la, lb, max_num_tokens, rng)
        a0 += fa
        a1 -= ba
        b0 += fb
        b1 -= bb
        if a1 > a0 and b1 > b0:
          out.append((a0, a1, b0, b1, is_random_next))
      chunk_n = 0
      chunk_len = 0
    i += 1


_NATIVE_PLANNER = None  # unresolved; False once probing failed


def _native_planner():
  """Resolve the native planner once per process; None when the native
  toolchain is unavailable (first failure warns, then stays on Python)."""
  global _NATIVE_PLANNER
  if _NATIVE_PLANNER is None:
    import os
    if os.environ.get('LDDL_PAIRING') == 'python':
      _NATIVE_PLANNER = False
    else:
      try:
        from ..native.build import library
        from ..native.pairing import plan_pairs_partition_native
        library()  # the c++ build happens here, inside the guard
        _NATIVE_PLANNER = plan_pairs_partition_native
      except Exception as e:  # no g++ / build failure
        import warnings
        warnings.warn(f'native pair planner unavailable ({e}); '
                      'planning pairs in Python')
        _NATIVE_PLANNER = False
  return _NATIVE_PLANNER or None


def plan_pairs_partition(docs, rng, max_seq_length=128, short_seq_prob=0.1,
                         duplicate_factor=1, backend='auto'):
  """Plan all pairs of a partition (``duplicate_factor`` passes over all
  documents, like the slow path's outer loop).

  Returns (a_ranges int64 [n,2], b_ranges int64 [n,2], is_random_next
  bool [n]). ``backend='auto'`` uses the native planner when buildable
  (bit-identical outputs and rng stream — ``src/pairing.cpp``; set env
  ``LDDL_PAIRING=python`` to force the Python path); 'python' forces this
  module's loop.
  """
  if max_seq_length < 5:
    # The short-seq draw is randint(2, max_seq_length - 3); below 5 the
    # range is empty and CPython raises — validate up front so the native
    # planner (which cannot raise mid-plan) never sees the degenerate
    # config.
    raise ValueError(f'max_seq_length must be >= 5, got {max_seq_length}')
  if backend == 'auto':
    native = _native_planner()
    if native is not None:
      return native(docs, rng, max_seq_length=max_seq_length,
                    short_seq_prob=short_seq_prob,
                    duplicate_factor=duplicate_factor)
  out = []
  for _ in range(duplicate_factor):
    for di in range(len(docs)):
      plan_pairs_from_document(docs, di, rng, out,
                               max_seq_length=max_seq_length,
                               short_seq_prob=short_seq_prob)
  if not out:
    empty = np.zeros((0, 2), dtype=np.int64)
    return empty, empty.copy(), np.zeros(0, dtype=bool)
  arr = np.asarray(out, dtype=np.int64)
  return (arr[:, 0:2].copy(), arr[:, 2:4].copy(),
          arr[:, 4].astype(bool))
