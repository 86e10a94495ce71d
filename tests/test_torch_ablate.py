"""lddl_tpu_torch's ``BertConfig.ablate`` vs lddl_tpu's, on the CPU.

Each ablation drops one component from every layer
(``lddl_tpu/models/bert.py:93-94, 150-161``): 'attention-core' (ctx :=
v), 'ffn', 'norms', 'gelu'. Tiny config, float32, dropout off, converted
weights of the ablated flax tree:

  - the loss, its parts and every gradient against ``jax.value_and_grad``
    of ``lddl_tpu.parallel.train.pretrain_loss`` (dense attention; also
    'attention-core' with the fused projection, and 'ffn' with flash,
    whose JAX kernels run in interpret mode), at
    ``test_torch_train.py``'s tolerances: 1e-5 relative on the loss and
    its parts, gradients rtol 1e-4 and atol 1e-6 of the largest entry;
  - the ablated model's ``state_dict`` keys equal
    ``flax_to_state_dict``'s of the ablated tree: flax never creates a
    dropped module's parameters, and neither does the port;
  - under 'attention-core' the q and k projections get zero gradients,
    AdamW leaves them where optax's adamw leaves them (decayed only, rtol
    1e-6), and no q/k ``Dense`` and no flash wrapper runs;
  - two gloo ranks at ``tensor=2`` step an ablated model as world 1 does
    (rtol 2e-4 on the metrics, ``test_torch_tp.py``'s);
  - the step cost model counts an ablated step's matmul FLOPs as the
    analytic count (``lddl_tpu.models.flops``, which ignores ``ablate``)
    less the dropped terms, plus the NSP head, exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_ranks as ranks
from lddl_tpu.models import BertConfig as JaxConfig
from lddl_tpu.models import BertForPretraining as JaxBert
from lddl_tpu.models.flops import bert_pretrain_flops_per_step as jax_flops
from lddl_tpu.parallel import train as jtrain
from lddl_tpu_torch.models import (BertConfig, BertForPretraining,
                                   flax_to_state_dict)
from lddl_tpu_torch.models import bert as tbert
from lddl_tpu_torch.ops import flash_attention as tfa
from lddl_tpu_torch.parallel import train as ttrain
from lddl_tpu_torch.telemetry.step_costs import StepCostCounter
from test_torch_dp import OPT
from test_torch_train import TINY, _batch, _tensors
from torch_threads import torch_one_thread_a_file  # noqa: F401

ABLATIONS = ('attention-core', 'ffn', 'norms', 'gelu')
QK = ('query.weight', 'query.bias', 'key.weight', 'key.bias')


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


def _pair(ablate, impl='dense', fused_qkv=False, batch=None):
  """lddl_tpu's ablated model and params, and the port's from them."""
  batch = _batch() if batch is None else batch
  kw = dict(attention_impl=impl, fused_qkv=fused_qkv, ablate=ablate, **TINY)
  jmodel = JaxBert(JaxConfig(dtype=jnp.float32, **kw), mesh=None)
  params = jax.device_get(jmodel.init(
      jax.random.key(1), jnp.asarray(batch['input_ids']),
      jnp.asarray(batch['token_type_ids']),
      jnp.asarray(batch['attention_mask']))['params'])
  tmodel = BertForPretraining(BertConfig(dtype=torch.float32, **kw))
  tmodel.load_state_dict(flax_to_state_dict(params))
  return jmodel, params, tmodel


@pytest.mark.parametrize('ablate,impl,fused_qkv', [
    *((a, 'dense', False) for a in ABLATIONS),
    ('attention-core', 'dense', True), ('ffn', 'flash', False)])
def test_loss_and_every_gradient_match_jax(ablate, impl, fused_qkv):
  batch = _batch(seed=7)
  jmodel, params, tmodel = _pair(ablate, impl, fused_qkv, batch)
  jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
  (jloss, jm), jgrads = jax.value_and_grad(
      lambda p: jtrain.pretrain_loss(jmodel, p, jbatch, max_predictions=16),
      has_aux=True)(params)
  tmodel.eval()
  tloss, tm = ttrain.pretrain_loss(tmodel, _tensors(batch),
                                   max_predictions=16)
  tloss.backward()
  np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
  for name in ('mlm_loss', 'nsp_loss', 'mlm_acc'):
    np.testing.assert_allclose(float(tm[name].detach()), float(jm[name]),
                               rtol=1e-5, atol=1e-6, err_msg=name)
  ref = flax_to_state_dict(jgrads)
  got = dict(tmodel.named_parameters())
  assert set(ref) == set(got)
  scale = max(float(np.abs(g.numpy()).max()) for g in ref.values())
  for name, g in ref.items():
    assert got[name].grad is not None, name
    np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), rtol=1e-4,
                               atol=1e-6 * scale, err_msg=name)
  if ablate == 'attention-core':
    # JAX's cotangent of a parameter the program never reads is zero, and
    # so is the port's: a tensor of zeros, not None.
    for layer in range(TINY['num_layers']):
      for name in (('qkv.weight', 'qkv.bias') if fused_qkv else QK):
        key = f'encoder.layers.{layer}.attention.{name}'
        g = got[key].grad
        assert not np.any(ref[key].numpy()[:2 * TINY['hidden_size']])
        if fused_qkv:
          g = g[:2 * TINY['hidden_size']]
        assert torch.count_nonzero(g) == 0, key


@pytest.mark.parametrize('ablate', ABLATIONS)
@pytest.mark.parametrize('fused_qkv', [False, True])
def test_state_dict_keys_are_the_ablated_trees(ablate, fused_qkv):
  _, params, tmodel = _pair(ablate, fused_qkv=fused_qkv)
  want = flax_to_state_dict(params)
  assert set(tmodel.state_dict()) == set(want)
  layer = dict(tmodel.encoder.layers[0].named_children())
  dropped = {'attention-core': set(), 'gelu': set(),
             'ffn': {'intermediate', 'output', 'output_norm'},
             'norms': {'attention_norm', 'output_norm'}}[ablate]
  assert not dropped & set(layer)
  # The port's own init draws the same parameter list.
  fresh = BertForPretraining(BertConfig(dtype=torch.float32, ablate=ablate,
                                        fused_qkv=fused_qkv, **TINY))
  assert [k for k, _ in fresh.named_parameters()] == list(tmodel.state_dict())


def test_attention_core_step_decays_q_and_k_as_optax_does():
  """optax's adamw (no mask) decays the q/k weights by lr * wd alone (zero
  gradients give a zero Adam update); the port's step, whose q/k
  gradients are zero tensors, does the same. Two steps: the schedule's
  learning rate is 0 at step 0."""
  batch = _batch(seed=3)
  jmodel, params, tmodel = _pair('attention-core', batch=batch)
  schedule = optax.warmup_cosine_decay_schedule(
      0.0, OPT['learning_rate'], OPT['warmup_steps'],
      max(OPT['total_steps'], OPT['warmup_steps'] + 1))
  tx = optax.adamw(schedule, weight_decay=OPT['weight_decay'])
  jstep = jax.jit(functools.partial(jtrain._train_step_body, jmodel, tx))
  opt_state = tx.init(params)
  topt = ttrain.AdamW(tmodel.parameters(), functools.partial(
      ttrain.learning_rate, peak=OPT['learning_rate'],
      warmup_steps=OPT['warmup_steps'], total_steps=OPT['total_steps']),
      weight_decay=OPT['weight_decay'])
  before = {k: v.detach().clone() for k, v in tmodel.named_parameters()}
  tmodel.train()
  for i in range(2):
    b = _batch(seed=20 + i)
    params, opt_state, jm = jstep(params, opt_state, jax.random.key(2),
                                  {k: jnp.asarray(v) for k, v in b.items()})
    tm = ttrain.train_step(tmodel, topt, _tensors(b), dropout_seed=3)
    np.testing.assert_allclose(float(tm['loss']), float(jm['loss']),
                               rtol=2e-4)
  ref = flax_to_state_dict(jax.device_get(params))
  lr1 = ttrain.learning_rate(1, OPT['learning_rate'], OPT['warmup_steps'],
                             OPT['total_steps'])
  for layer in range(TINY['num_layers']):
    for name in QK:
      key = f'encoder.layers.{layer}.attention.{name}'
      got = dict(tmodel.named_parameters())[key].detach()
      np.testing.assert_allclose(got.numpy(), ref[key].numpy(), rtol=1e-6,
                                 atol=1e-9, err_msg=key)
      # Decayed only: step 0 at lr 0, step 1 at lr1.
      want = before[key] * (1 - lr1 * OPT['weight_decay'])
      torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9)
  moved = dict(tmodel.named_parameters())[
      'encoder.layers.0.attention.query.weight'].detach()
  assert not torch.equal(moved, before[
      'encoder.layers.0.attention.query.weight'])


def test_attention_core_runs_no_q_k_projection_and_no_attention(
    monkeypatch):
  calls = {'dense': [], 'flash': 0}
  for name in ('_fwd', '_dq', '_dkv'):
    real = getattr(tfa, name)

    def counted(*a, real=real, **kw):
      calls['flash'] += 1
      return real(*a, **kw)

    monkeypatch.setattr(tfa, name, counted)
  real_dense = tbert.Dense.forward

  def dense(self, x):
    calls['dense'].append(self)
    return real_dense(self, x)

  monkeypatch.setattr(tbert.Dense, 'forward', dense)
  batch = _tensors(_batch())
  for fused_qkv in (False, True):
    model = BertForPretraining(BertConfig(
        dtype=torch.float32, attention_impl='flash', fused_qkv=fused_qkv,
        ablate='attention-core', **dict(TINY, dropout_rate=0.1)))
    opt = ttrain.AdamW(model.parameters(), lambda step: 1e-3)
    calls['dense'].clear()
    m = ttrain.train_step(model, opt, batch, dropout_seed=3)
    assert np.isfinite(float(m['loss']))
    qk = []
    for layer in model.encoder.layers:
      att = layer.attention
      qk += [att.qkv] if fused_qkv else [att.query, att.key]
    assert not any(any(d is x for x in qk) for d in calls['dense'])
  assert calls['flash'] == 0
  # The real model does run them (the counters see what they should).
  model = BertForPretraining(BertConfig(dtype=torch.float32,
                                        attention_impl='flash', **TINY))
  ttrain.train_step(model, ttrain.AdamW(model.parameters(), lambda s: 1e-3),
                    batch, dropout_seed=3)
  assert calls['flash'] == 3 * TINY['num_layers']


def test_ffn_layer_draws_its_attention_mask_only():
  """Under 'ffn' a layer's generator draws one mask a step (the attention
  output's): the same masks as the real model's first draw, so the
  embedding dropout and every layer's attention dropout are unchanged."""
  cfg = dict(dtype=torch.float32, **dict(TINY, dropout_rate=0.1))
  model = BertForPretraining(BertConfig(ablate='ffn', **cfg))
  gens = model.seed_dropout((3, 0))
  start = [g.get_state() for g in gens]
  model(*(_tensors(_batch())[k] for k in ('input_ids', 'token_type_ids',
                                          'attention_mask')),
        dropout_key=tbert.SEEDED)
  b, s = _batch()['input_ids'].shape
  for gen, state in zip(gens[1:], start[1:]):
    g = torch.Generator().set_state(state)
    torch.rand((b, s, TINY['hidden_size']), generator=g)
    assert torch.equal(g.get_state(), gen.get_state())
  assert len(gens) == TINY['num_layers'] + 1


# ---- the step cost model on an ablated step ----


def _nsp(b, d):
  return 2 * b * d * 2 * 3


def _dropped(ablate, b, s, cfg):
  """Matmul FLOPs a step that each ablation takes out of the analytic
  count: the q and k projections (2 x 2bsd^2 forward, x3) and the
  attention's scores and context (4bs^2d forward, x3) under
  'attention-core'; the FFN's two projections (2 x 2bsd d_ff, x3) under
  'ffn'; nothing under 'norms' and 'gelu'."""
  d, layers = cfg['hidden_size'], cfg['num_layers']
  return layers * {
      'attention-core': 3 * (2 * 2 * b * s * d * d + 4 * b * s * s * d),
      'ffn': 3 * 2 * 2 * b * s * d * cfg['intermediate_size'],
      'norms': 0, 'gelu': 0}[ablate]


@pytest.mark.parametrize('ablate', ABLATIONS)
@pytest.mark.parametrize('impl', ['dense', 'flash'])
def test_step_costs_are_the_analytic_count_less_the_dropped_terms(ablate,
                                                                  impl):
  b, s, mp = 4, 64, 16
  model = BertForPretraining(BertConfig(dtype=torch.float32,
                                        attention_impl=impl, ablate=ablate,
                                        **TINY))
  step = ttrain.TrainStep(model, ttrain.AdamW(model.parameters(),
                                              lambda c: 1e-3), mp)
  with StepCostCounter() as counter:
    step(_tensors(_batch(b=b, s=s)), 3)
  costs = counter.costs
  want = (jax_flops(JaxConfig(**TINY), b, s, max_predictions=mp) -
          _dropped(ablate, b, s, TINY) + _nsp(b, TINY['hidden_size']))
  if impl == 'flash' and ablate != 'attention-core':
    # The kernels' recompute: dq's 3 and dkv's 4 products against the
    # dense backward's 4.
    want += 2 * 3 * b * s * s * TINY['hidden_size'] * TINY['num_layers']
    assert costs.flash_flops > 0
  else:
    assert costs.flash_flops == 0
  assert costs.matmul_flops + costs.flash_flops == want
  assert costs.seg_flops == 0


# ---- two ranks at tensor=2 ----


def test_tensor_parallel_ablated_steps_equal_world_one():
  cases, want = [], []
  for i, (ablate, fused) in enumerate((('attention-core', True),
                                        ('ffn', False))):
    cfg = dict(TINY, ablate=ablate, fused_qkv=fused)
    model = BertForPretraining(BertConfig(dtype=torch.float32, **cfg))
    model.reset_parameters(torch.Generator().manual_seed(11 + i))
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    batches = [_batch(b=8, s=64, seed=30 + i + j) for j in range(2)]
    cases.append({'cfg': cfg, 'batches': batches, 'state': state})
    opt = ttrain.AdamW(model.parameters(), functools.partial(
        ttrain.learning_rate, peak=OPT['learning_rate'],
        warmup_steps=OPT['warmup_steps'], total_steps=OPT['total_steps']),
        weight_decay=OPT['weight_decay'])
    model.train()
    want.append([{k: float(v) for k, v in ttrain.train_step(
        model, opt, _tensors(b), dropout_seed=127).items()}
        for b in batches])
  opt_kw = dict(OPT)
  got = ranks.run_world(ranks.mesh_steps, 2,
                        args=({'tensor': 2}, cases, opt_kw))
  for rank in (0, 1):
    for case, steps in zip(got[rank], want):
      assert case['dp'] == (0, 1)
      for step, ref in zip(case['steps'], steps):
        for name in ('loss', 'mlm_loss', 'nsp_loss', 'grad_norm'):
          np.testing.assert_allclose(step['metrics'][name], ref[name],
                                     rtol=2e-4, err_msg=f'rank {rank} {name}')
  # The ranks hold the replicated parameters bit-equal.
  for a, b in zip(got[0], got[1]):
    assert [s['replicated'] for s in a['steps']] == [
        s['replicated'] for s in b['steps']]
