"""The loader's batch contract and dynamic masking.

Copied from :mod:`lddl_tpu.loader.bert` (pure numpy; the port keeps its
own copy and imports nothing of ``lddl_tpu``). ``BertCollate`` and the
Parquet loader wait for the loader slice; until then batches in the
collate's dict format come from the caller.
"""

import numpy as np

IGNORE_INDEX = -100


def _align_up(n, align):
  return ((n + align - 1) // align) * align


def dynamic_mask_tokens(input_ids, special_mask, *, mlm_probability,
                        vocab_size, mask_id, base_seed, dp_rank, epoch,
                        step):
  """Vectorized 80/10/10 dynamic masking (reference
  ``torch/bert.py:152-196``), deterministically keyed by
  (seed, epoch, rank, step) so every resume reproduces the identical
  masks. Shared by the BERT and packed long-context collates."""
  rng = np.random.Generator(
      np.random.Philox(
          key=[
              np.uint64(base_seed) << np.uint64(32) | np.uint64(epoch),
              np.uint64(dp_rank) << np.uint64(32) | np.uint64(step),
          ]))
  prob = rng.random(input_ids.shape)
  masked = (prob < mlm_probability) & ~special_mask
  labels = np.where(masked, input_ids, IGNORE_INDEX).astype(np.int32)
  decide = rng.random(input_ids.shape)
  out = input_ids.copy()
  out[masked & (decide < 0.8)] = mask_id
  random_sel = masked & (decide >= 0.8) & (decide < 0.9)
  out[random_sel] = rng.integers(
      0, vocab_size, size=int(random_sel.sum()), dtype=np.int32)
  return out, labels
