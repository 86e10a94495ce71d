"""lddl_tpu_torch TrainLoop on the CPU: run, checkpoint, resume."""

import math
import os

import numpy as np
import pytest
import torch

from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
from lddl_tpu_torch.models import BertConfig
from lddl_tpu_torch.training import TrainLoop

CFG = BertConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
                 intermediate_size=128, max_position_embeddings=128,
                 dtype=torch.float32, attention_impl='flash')


def _batch(seq_len, step, b=4):
  """A loader-format batch of one bin: ragged [CLS] A [SEP] B [SEP] rows."""
  rng = np.random.default_rng(1000 + step)
  lens = rng.integers(seq_len // 2 + 1, seq_len + 1, size=b)
  na = lens // 2 - 1
  cols = np.arange(seq_len)[None, :]
  ids = rng.integers(5, CFG.vocab_size, (b, seq_len)).astype(np.int32)
  ids[:, 0] = 2
  ids[np.arange(b), na + 1] = 3
  ids[np.arange(b), lens - 1] = 3
  ids[cols >= lens[:, None]] = 0
  mask = (cols < lens[:, None]).astype(np.int32)
  ids, labels = dynamic_mask_tokens(
      ids, ids <= 4, mlm_probability=0.15, vocab_size=CFG.vocab_size,
      mask_id=4, base_seed=7, dp_rank=0, epoch=0, step=step)
  return {'input_ids': ids,
          'token_type_ids': ((cols >= (na + 2)[:, None]) & (mask > 0)).astype(
              np.int32),
          'attention_mask': mask,
          'labels': labels,
          'next_sentence_labels': rng.integers(0, 2, b).astype(np.int32)}


class _Loader:
  """Two bins (seq 64 and 128) in alternation, one epoch = the batches
  from ``start`` on (a resumed run starts where the checkpoint was)."""

  batch_size = 4

  def __init__(self, n, start=0):
    self.batches = [_batch(64 if i % 2 == 0 else 128, i) for i in range(n)]
    self.start = start

  def __iter__(self):
    return iter(self.batches[self.start:])


def _loop(**kw):
  loop = TrainLoop.build(model_cfg=CFG, device='cpu', learning_rate=1e-3,
                         warmup_steps=2, total_steps=6, seed=5, **kw)
  loop.loader = _Loader(6)
  return loop


def test_resume_is_bit_equal_to_uninterrupted(tmp_path):
  straight = _loop()
  losses = straight.run(6, log_every=0)
  assert len(losses) == 6 and all(math.isfinite(x) for x in losses)

  first = _loop()
  head = first.run(3, ckpt_dir=str(tmp_path), log_every=0)
  assert TrainLoop.latest_meta(str(tmp_path)) == (3, 12)
  resumed = _loop().restore(str(tmp_path))
  assert (resumed.step, resumed.samples_seen) == (3, 12)
  resumed.loader.start = resumed.step
  tail = resumed.run(6, log_every=0)
  assert head + tail == losses
  assert resumed.state_digest() == straight.state_digest()
  assert resumed.state_digest() != first.state_digest()


def test_latest_meta_skips_a_half_written_newest_step(tmp_path):
  loop = _loop()
  loop.run(2, ckpt_dir=str(tmp_path), ckpt_every=1, log_every=0)
  assert TrainLoop.latest_meta(str(tmp_path)) == (2, 8)
  os.makedirs(tmp_path / 'step_0000000009')  # no state, no meta
  torn = tmp_path / 'step_0000000007'
  os.makedirs(torn)
  (torn / 'state.pt').write_bytes(b'')
  (torn / 'meta.json').write_text('{"step": 7,')  # cut mid-write
  assert TrainLoop.latest_meta(str(tmp_path)) == (2, 8)
  assert TrainLoop.latest_meta(str(tmp_path), max_step=1) == (1, 4)
  assert TrainLoop.latest_meta(str(tmp_path / 'absent')) is None


def test_save_keeps_the_newest_three(tmp_path):
  loop = _loop()
  loop.run(5, ckpt_dir=str(tmp_path), ckpt_every=1, log_every=0)
  assert sorted(os.listdir(tmp_path)) == [
      'step_0000000003', 'step_0000000004', 'step_0000000005']


def test_zero_batch_epoch_raises():
  loop = _loop()
  loop.loader.start = 6
  with pytest.raises(ValueError, match='zero batches'):
    loop.run(3, log_every=0)


def _nan_loop():
  loop = _loop()
  with torch.no_grad():
    loop.model.mlm_bias.fill_(float('nan'))
  return loop


def test_nonfinite_loss_stops_the_run(monkeypatch, tmp_path):
  loop = _nan_loop()
  losses = loop.run(4, ckpt_dir=str(tmp_path), log_every=0)
  assert len(losses) == 1 and loop.stop_reason == 'nonfinite_loss'
  assert TrainLoop.latest_meta(str(tmp_path)) == (1, 4)
  monkeypatch.setenv('LDDL_NONFINITE', 'ignore')
  assert len(_nan_loop().run(3, log_every=0)) == 3


def test_build_rejects_a_corpus_path():
  with pytest.raises(NotImplementedError, match='loader'):
    TrainLoop.build('/data/balanced', model_cfg=CFG, device='cpu')
