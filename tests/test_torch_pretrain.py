"""lddl_tpu_torch TrainLoop on the CPU: run, checkpoint, resume."""

import math
import os

import numpy as np
import pytest
import torch

from lddl_tpu_torch.core.utils import serialize_np_array
from lddl_tpu_torch.loader import PackedCollate
from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
from lddl_tpu_torch.models import BertConfig
from lddl_tpu_torch.training import TrainLoop
from torch_threads import torch_one_thread_a_file  # noqa: F401

@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


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


def test_build_rejects_a_corpus_path(tmp_path):
  """A corpus path builds the loader, so one without shards (or a
  block-diagonal loop over pair shards) is refused before any model."""
  with pytest.raises(ValueError, match='no parquet shards'):
    TrainLoop.build(str(tmp_path), _Tok(), model_cfg=CFG, device='cpu')
  with pytest.raises(ValueError, match='block_diagonal'):
    TrainLoop.build(str(tmp_path), model_cfg=CFG, device='cpu',
                    block_diagonal=True)


class _Tok:
  cls_token_id, sep_token_id, mask_token_id, pad_token_id = 2, 3, 4, 0
  vocab_size = CFG.vocab_size


class _PackedLoader:
  """Packed block-diagonal batches of one bin (seq 128, 2-4 documents per
  row) from wire rows through PackedCollate; iterating yields them from
  ``start`` on."""

  batch_size = 2

  def __init__(self, n, start=0):
    collate = PackedCollate(_Tok(), base_seed=3, block_diagonal=True)
    self.batches = [collate(self._rows(i), 128, epoch=0, step=i)
                    for i in range(n)]
    self.start = start

  def _rows(self, step):
    rng = np.random.default_rng(500 + step)
    rows = []
    for _ in range(self.batch_size):
      ids, marks = [_Tok.cls_token_id], []
      for n in rng.integers(10, 40, size=rng.integers(2, 5)):
        marks.append(len(ids))
        ids += list(rng.integers(5, CFG.vocab_size, n)) + [_Tok.sep_token_id]
      rows.append({'input_ids': serialize_np_array(np.asarray(ids, np.uint16)),
                   'doc_offsets': serialize_np_array(np.asarray(marks,
                                                                np.uint16))})
    return rows

  def __iter__(self):
    return iter(self.batches[self.start:])


def test_packed_batches_train_and_resume_bit_equal(tmp_path):
  """segment_ids batches pass through the feed and the train step; a
  resumed packed run equals the uninterrupted one."""
  def loop():
    lp = TrainLoop.build(model_cfg=CFG, device='cpu', learning_rate=1e-3,
                         warmup_steps=2, total_steps=6, seed=5,
                         max_predictions=32, max_seq_length=128)
    lp.loader = _PackedLoader(4)
    return lp

  assert all('segment_ids' in b for b in _PackedLoader(4).batches)
  straight = loop()
  losses = straight.run(4, log_every=0)
  assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
  first = loop()
  head = first.run(2, ckpt_dir=str(tmp_path), log_every=0)
  resumed = loop().restore(str(tmp_path))
  resumed.loader.start = resumed.step
  tail = resumed.run(4, log_every=0)
  assert head + tail == losses
  assert resumed.state_digest() == straight.state_digest()


def test_build_accepts_the_packed_budget_at_8192():
  import warnings
  with warnings.catch_warnings():
    warnings.simplefilter('error')
    TrainLoop.build(model_cfg=CFG, device='cpu', max_predictions=1359,
                    max_seq_length=8192)


# ---- training from shards, against the JAX loop ----

SHARD_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                 intermediate_size=64, max_position_embeddings=128,
                 dropout_rate=0.0)


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
  """Balanced shards lddl_tpu wrote: binned NSP pairs and packed rows."""
  from lddl_tpu.balance import balance_directory
  from lddl_tpu.pipeline import Executor
  from lddl_tpu.preprocess import bert, packed
  from lddl_tpu.preprocess.readers import read_corpus
  from lddl_tpu.testing import write_word_corpus, write_word_vocab
  root = tmp_path_factory.mktemp('torch_shards')
  vocab = str(root / 'vocab.txt')
  write_word_vocab(vocab)
  src = str(root / 'source')
  write_word_corpus(src, num_docs=80, num_shards=2, seed=3,
                    sents_range=(2, 8), words_range=(4, 16))
  out = {'vocab': vocab}
  for name, run, cfg in (
      ('pairs', bert.run, bert.BertPretrainConfig(
          vocab_file=vocab, target_seq_length=64, bin_size=32,
          duplicate_factor=2, seed=5, sentence_backend='rules',
          tokenizer_backend='hf')),
      ('packed', packed.run, packed.PackedPretrainConfig(
          vocab_file=vocab, target_seq_length=128, seed=5,
          sentence_backend='rules', tokenizer_backend='hf'))):
    sink = str(root / f'{name}_sink')
    run(read_corpus([src], num_blocks=2, sample_ratio=1.0), sink, cfg,
        executor=Executor(num_local_workers=1))
    out[name] = str(root / name)
    balance_directory(sink, out[name], 2)
  return out


def _build_kw(data_format):
  if data_format == 'packed':
    return dict(batch_size_per_rank=8, max_seq_length=128,
                data_format='packed', block_diagonal=True,
                loader_kwargs={'shuffle_buffer_size': 16})
  return dict(batch_size_per_rank=8, bin_size=32, max_seq_length=64,
              loader_kwargs={'shuffle_buffer_size': 16})


def _torch_loop(shards, data_format, **kw):
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  cfg = BertConfig(dtype=torch.float32, **SHARD_CFG)
  return TrainLoop.build(
      shards[data_format], load_bert_tokenizer(vocab_file=shards['vocab']),
      model_cfg=cfg, device='cpu', learning_rate=1e-3, warmup_steps=2,
      total_steps=8, seed=5, **dict(_build_kw(data_format), **kw))


@pytest.mark.parametrize('data_format', ['pairs', 'packed'])
def test_build_from_path_trains_as_the_jax_loop(shards, data_format):
  """TrainLoop.build(path, ...) in both packages over the same shards,
  the JAX params carried across (models/convert.py): four steps' losses
  within test_torch_train.py's five-step tolerance (2e-4 relative)."""
  import jax
  import jax.numpy as jnp
  from lddl_tpu.models import BertConfig as JaxConfig
  from lddl_tpu.parallel import make_mesh
  from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer as jtok
  from lddl_tpu.training.pretrain import TrainLoop as JaxLoop
  from lddl_tpu_torch.models import flax_to_state_dict
  jloop = JaxLoop.build(
      shards[data_format], jtok(vocab_file=shards['vocab'], backend='hf'),
      model_cfg=JaxConfig(dtype=jnp.float32, **SHARD_CFG), mesh=make_mesh(),
      learning_rate=1e-3, warmup_steps=2, total_steps=8, seed=5,
      **_build_kw(data_format))
  tloop = _torch_loop(shards, data_format)
  tloop.model.load_state_dict(flax_to_state_dict(jax.device_get(
      jloop.params)))
  want = jloop.run(4, log_every=0)
  got = tloop.run(4, log_every=0)
  assert len(got) == len(want) == 4
  np.testing.assert_allclose(got, want, rtol=2e-4)
  assert (tloop.step, tloop.samples_seen) == (jloop.step, jloop.samples_seen)


def test_restore_reseeks_the_loader(shards, tmp_path):
  """restore() positions a fresh loop's loader at the checkpoint's
  samples_seen (the coordinate lddl_tpu's reseek_loader gives), and every
  restart from one checkpoint continues bit for bit."""
  from lddl_tpu.loader import get_bert_pretrain_data_loader as jax_loader
  from lddl_tpu.training.elastic import reseek_loader as jax_reseek
  ckpt = str(tmp_path / 'ckpt')
  first = _torch_loop(shards, 'pairs')
  first.run(5, ckpt_dir=ckpt, log_every=0)
  assert TrainLoop.latest_meta(ckpt) == (5, 40)

  def resume():
    loop = _torch_loop(shards, 'pairs')
    assert loop.loader.tell() == (0, 0)
    loop.restore(ckpt)
    return loop, loop.loader.tell(), loop.run(8, log_every=0)

  (a, at_a, tail_a), (b, at_b, tail_b) = resume(), resume()
  jl = jax_loader(shards['pairs'], vocab_file=shards['vocab'],
                  batch_size_per_rank=8, bin_size=32, max_seq_length=64)
  jax_reseek(jl, 40)
  assert at_a == at_b == jl.tell() == (0, 5)
  assert len(tail_a) == 3 and tail_a == tail_b
  assert a.state_digest() == b.state_digest()


def test_cli_trains_from_shards_and_resumes(shards, tmp_path, capsys):
  from lddl_tpu_torch.training.pretrain import main
  base = ['--path', shards['pairs'], '--vocab-file', shards['vocab'],
          '--model', 'tiny', '--bin-size', '32', '--max-seq-length', '64',
          '--batch-size', '8', '--warmup-steps', '1', '--log-every', '1',
          '--device', 'cpu', '--checkpoint-dir', str(tmp_path / 'ckpt')]
  first = main(base + ['--steps', '2', '--checkpoint-every', '2'])
  assert (first.step, first.samples_seen) == (2, 16)
  resumed = main(base + ['--steps', '4', '--resume'])
  out = capsys.readouterr().out
  assert 'resuming from samples_seen=16' in out
  assert (resumed.step, resumed.samples_seen) == (4, 32)
  losses = [float(x.split('loss=')[1].split()[0])
            for x in out.splitlines() if x.startswith('step=')]
  assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
  assert '"final_step": 4' in out


@pytest.mark.parametrize('flag', [['--dp', '2'], ['--tp', '2'],
                                  ['--fsdp', '2'], ['--sp', '2'],
                                  ['--comm', 'jax'],
                                  ['--attention', 'sparse']])
def test_cli_refuses_what_is_not_ported(shards, flag, capsys):
  """``--dp``, ``--tp``, ``--fsdp`` and ``--sp`` above 1 need a process
  group (``--comm torch``; ``tests/test_torch_tp.py`` trains with ``--tp
  2`` over two ranks, ``tests/test_torch_ring_step.py`` with ``--sp 2``);
  the CLI offers no ``jax`` backend and no attention beyond dense, flash,
  ring and ring_flash, so argparse refuses those."""
  from lddl_tpu_torch.training.pretrain import main
  argv = ['--path', shards['pairs'], '--vocab-file', shards['vocab'],
          '--device', 'cpu'] + flag
  raised = {'--dp': (ValueError, '--dp 2 needs --comm torch'),
            '--tp': (ValueError, '--tp 2 needs --comm torch'),
            '--fsdp': (ValueError, '--fsdp 2 needs --comm torch'),
            '--sp': (ValueError, '--sp 2 needs --comm torch')}.get(
                flag[0])
  if raised is not None:
    with pytest.raises(raised[0], match=raised[1]):
      main(argv)
    return
  with pytest.raises(SystemExit) as exc:
    main(argv)
  assert exc.value.code == 2
  assert flag[0] in capsys.readouterr().err
