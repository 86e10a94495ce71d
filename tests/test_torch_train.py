"""lddl_tpu_torch loss, AdamW and train step vs lddl_tpu's.

Tiny config, dropout off, float32, the same converted init and the same
loader-format numpy batches on both sides. The JAX step is
``lddl_tpu.parallel.train._train_step_body`` under ``jax.jit`` with
``optax.adamw`` over the warmup-cosine schedule, exactly as
``TrainLoop.build`` makes it, without the mesh.

Tolerances: metrics of one forward 1e-5 relative (f32, summation order);
five steps 2e-4 relative on loss and grad_norm (f32 rounding differences
compound through Adam's normalised updates step over step).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lddl_tpu.models import BertConfig as JaxConfig
from lddl_tpu.models import BertForPretraining as JaxBert
from lddl_tpu.parallel import train as jtrain
from lddl_tpu_torch.models import (BertConfig, BertForPretraining,
                                   flax_to_state_dict)
from lddl_tpu_torch.parallel import train as ttrain
from lddl_tpu_torch.loader.bert import dynamic_mask_tokens

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, dropout_rate=0.0)


def _batch(b=4, s=64, seed=0):
  """A loader-format batch: [CLS] A [SEP] B [SEP] rows, dynamic masks."""
  rng = np.random.default_rng(seed)
  lens = rng.integers(s // 2, s + 1, size=b)
  na = lens // 2 - 1
  cols = np.arange(s)[None, :]
  ids = rng.integers(5, TINY['vocab_size'], (b, s)).astype(np.int32)
  ids[:, 0] = 2
  ids[np.arange(b), na + 1] = 3
  ids[np.arange(b), lens - 1] = 3
  ids[cols >= lens[:, None]] = 0
  mask = (cols < lens[:, None]).astype(np.int32)
  special = (ids <= 4)
  ids, labels = dynamic_mask_tokens(
      ids, special, mlm_probability=0.15, vocab_size=TINY['vocab_size'],
      mask_id=4, base_seed=seed, dp_rank=0, epoch=0, step=0)
  return {
      'input_ids': ids,
      'token_type_ids': ((cols >= (na + 2)[:, None]) & (mask > 0)).astype(
          np.int32),
      'attention_mask': mask,
      'labels': labels,
      'next_sentence_labels': rng.integers(0, 2, b).astype(np.int32),
  }


def _pair(impl='dense'):
  batch = _batch()
  jmodel = JaxBert(JaxConfig(dtype=jnp.float32, attention_impl=impl, **TINY),
                   mesh=None)
  params = jmodel.init(jax.random.key(1), jnp.asarray(batch['input_ids']),
                       jnp.asarray(batch['token_type_ids']),
                       jnp.asarray(batch['attention_mask']))['params']
  tmodel = BertForPretraining(BertConfig(dtype=torch.float32,
                                         attention_impl=impl, **TINY))
  tmodel.load_state_dict(flax_to_state_dict(jax.device_get(params)))
  return jmodel, params, tmodel


def _tensors(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize('max_predictions', [None, 16])
def test_pretrain_loss_matches_jax(max_predictions):
  jmodel, params, tmodel = _pair()
  batch = _batch()
  _, jm = jtrain.pretrain_loss(jmodel, params,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               max_predictions=max_predictions)
  with torch.no_grad():
    _, tm = ttrain.pretrain_loss(tmodel.eval(), _tensors(batch),
                                 max_predictions=max_predictions)
  for name in ('mlm_loss', 'nsp_loss', 'mlm_acc'):
    np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5,
                               atol=1e-6, err_msg=name)


def test_masked_positions_match_jax_argsort():
  labels = _batch(b=6)['labels']
  ref = np.asarray(jnp.argsort(jnp.asarray(labels) == -100, axis=1,
                               stable=True)[:, :12])
  got = ttrain.masked_positions(torch.from_numpy(labels), 12).numpy()
  np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('impl', ['dense', 'flash'])
def test_five_steps_match_jax(impl):
  lr, warmup, total, wd = 1e-3, 2, 10, 0.01
  jmodel, params, tmodel = _pair(impl)
  schedule = optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                                max(total, warmup + 1))
  tx = optax.adamw(schedule, weight_decay=wd)
  opt_state = tx.init(params)
  jstep = jax.jit(functools.partial(jtrain._train_step_body, jmodel, tx))
  rng = jax.random.key(2)
  topt = ttrain.AdamW(
      tmodel.parameters(),
      functools.partial(ttrain.learning_rate, peak=lr, warmup_steps=warmup,
                        total_steps=total), weight_decay=wd)
  tmodel.train()
  for i in range(5):
    batch = _batch(seed=10 + i)
    params, opt_state, jm = jstep(params, opt_state, rng,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    tm = ttrain.train_step(tmodel, topt, _tensors(batch), dropout_seed=3)
    for name in ('loss', 'grad_norm'):
      np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                 rtol=2e-4, err_msg=f'step {i} {name}')
  assert topt.count == 5


@pytest.mark.parametrize('warmup,total', [(2, 10), (0, 5), (5, 3)])
def test_learning_rate_matches_optax(warmup, total):
  # optax evaluates in float32 (the cosine included), the port in float64:
  # agreement to float32 rounding of values of order peak.
  ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                           max(total, warmup + 1))
  for step in range(total + 4):
    np.testing.assert_allclose(
        ttrain.learning_rate(step, 3e-4, warmup, total), float(ref(step)),
        rtol=1e-6, atol=3e-4 * 1e-6, err_msg=f'step {step}')


def test_adamw_matches_optax_on_raw_arrays():
  """One parameter, ten updates with arbitrary gradients: the update rule
  alone, without a model in the way."""
  rng = np.random.default_rng(0)
  p0 = rng.standard_normal((5, 3), dtype=np.float32)
  grads = [rng.standard_normal((5, 3), dtype=np.float32) for _ in range(10)]
  sched = functools.partial(ttrain.learning_rate, peak=1e-2, warmup_steps=3,
                            total_steps=10)
  tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10),
                   weight_decay=0.05)
  jp = jnp.asarray(p0)
  state = tx.init(jp)
  tp = torch.from_numpy(p0.copy())
  opt = ttrain.AdamW([tp], sched, weight_decay=0.05)
  for g in grads:
    upd, state = tx.update(jnp.asarray(g), state, jp)
    jp = optax.apply_updates(jp, upd)
    opt.step([torch.from_numpy(g)])
  np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                             atol=1e-7)


def test_dropout_key_makes_a_step_pure():
  """The same (state, batch, step) gives the same update; another dropout
  seed gives another."""
  cfg = BertConfig(dtype=torch.float32, **dict(TINY, dropout_rate=0.1))
  batch = _tensors(_batch())
  results = []
  for seed in (3, 3, 4):
    model = BertForPretraining(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = ttrain.AdamW(model.parameters(), lambda step: 1e-3)
    results.append(float(ttrain.train_step(model, opt, batch, seed)['loss']))
  assert results[0] == results[1]
  assert results[0] != results[2]


def test_check_max_predictions_warns_when_short():
  with pytest.warns(UserWarning, match='max_predictions'):
    ttrain.check_max_predictions(20, 128, 'dynamic')
  ttrain.check_max_predictions(40, 128, 'dynamic')
