"""lddl_tpu_torch BertForPretraining vs lddl_tpu's, from converted weights.

Tiny config, dropout off, float32. Logits must match to 1e-4, the
tolerance of tests/test_flash_attention.py::test_model_flash_impl_matches_dense
(summation order differs between XLA and torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lddl_tpu.models import BertConfig as JaxConfig
from lddl_tpu.models import BertForPretraining as JaxBert
from lddl_tpu_torch.models import (BertConfig, BertForPretraining,
                                   flax_to_state_dict)
from torch_threads import torch_one_thread_a_file  # noqa: F401

@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, dropout_rate=0.0)


def _batch(b=2, s=64, seed=0):
  rng = np.random.default_rng(seed)
  ids = rng.integers(0, TINY['vocab_size'], (b, s)).astype(np.int32)
  lens = np.array([s - 14, s] + [s // 2] * (b - 2))[:b]
  mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
  types = ((np.arange(s)[None, :] >= lens[:, None] // 2) & (mask > 0))
  return ids, types.astype(np.int32), mask


def _models(impl, fused_qkv=False):
  ids, types, mask = _batch()
  jmodel = JaxBert(JaxConfig(dtype=jnp.float32, attention_impl=impl,
                             fused_qkv=fused_qkv, **TINY), mesh=None)
  params = jax.device_get(
      jmodel.init(jax.random.key(3), jnp.asarray(ids), jnp.asarray(types),
                  jnp.asarray(mask))['params'])
  tmodel = BertForPretraining(BertConfig(dtype=torch.float32,
                                         attention_impl=impl,
                                         fused_qkv=fused_qkv, **TINY))
  tmodel.load_state_dict(flax_to_state_dict(params))
  return jmodel, params, tmodel.eval()


def _compare(jax_out, torch_out):
  for name, a, b in zip(('mlm_logits', 'nsp_logits'), jax_out, torch_out):
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-4,
                               atol=1e-4, err_msg=name)


@pytest.mark.parametrize('impl,fused_qkv', [
    ('dense', False), ('flash', False), ('dense', True), ('flash', True)])
def test_logits_match_jax(impl, fused_qkv):
  jmodel, params, tmodel = _models(impl, fused_qkv)
  ids, types, mask = _batch()
  jout = jmodel.apply({'params': params}, jnp.asarray(ids),
                      jnp.asarray(types), jnp.asarray(mask))
  with torch.no_grad():
    tout = tmodel(*(torch.from_numpy(x) for x in (ids, types, mask)))
  assert tout[0].shape == (2, 64, TINY['vocab_size'])
  _compare(jout, tout)


@pytest.mark.parametrize('impl', ['dense', 'flash'])
def test_masked_only_head_matches_jax(impl):
  jmodel, params, tmodel = _models(impl)
  ids, types, mask = _batch()
  pos = np.sort(np.random.default_rng(1).choice(50, (2, 9)), axis=1)
  pos = pos.astype(np.int32)
  jout = jmodel.apply({'params': params}, jnp.asarray(ids),
                      jnp.asarray(types), jnp.asarray(mask),
                      mlm_positions=jnp.asarray(pos))
  with torch.no_grad():
    tout = tmodel(*(torch.from_numpy(x) for x in (ids, types, mask)),
                  mlm_positions=torch.from_numpy(pos))
  assert tout[0].shape == (2, 9, TINY['vocab_size'])
  _compare(jout, tout)


@pytest.mark.parametrize('impl', ['dense', 'flash'])
def test_segment_ids_logits_match_jax(impl):
  """Block-diagonal attention in the model: three documents per row, a
  padded tail on row 0 (logits compared on real rows)."""
  jmodel, params, tmodel = _models(impl)
  ids, types, mask = _batch()
  seg = np.where(mask > 0, np.arange(64)[None, :] * 3 // 64, -1)
  seg = seg.astype(np.int32)
  jout = jmodel.apply({'params': params}, jnp.asarray(ids),
                      jnp.asarray(types), jnp.asarray(mask),
                      segment_ids=jnp.asarray(seg))
  with torch.no_grad():
    tout = tmodel(*(torch.from_numpy(x) for x in (ids, types, mask)),
                  segment_ids=torch.from_numpy(seg))
  real = mask.astype(bool)[..., None]
  np.testing.assert_allclose(tout[0].numpy() * real, np.asarray(jout[0]) * real,
                             rtol=1e-4, atol=1e-4)
  np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=1e-4,
                             atol=1e-4)


def test_converter_covers_every_parameter():
  """The converted state dict loads strictly (no missing or unexpected
  key) and transposes Dense kernels to torch's [out, in]."""
  _, params, tmodel = _models('dense')
  sd = flax_to_state_dict(params)
  assert set(sd) == set(tmodel.state_dict())
  kernel = params['encoder']['layers']['intermediate']['kernel'][1]
  np.testing.assert_array_equal(
      sd['encoder.layers.1.intermediate.weight'].numpy(), kernel.T)


def test_init_distributions_follow_flax():
  """reset_parameters draws what flax's initializers draw (checked by
  moments at BERT-base width, where the sample is large)."""
  model = BertForPretraining(BertConfig(num_layers=1, dtype=torch.float32))
  model.reset_parameters(torch.Generator().manual_seed(0))
  assert abs(model.word_embeddings.weight.std().item() - 0.02) < 1e-3
  assert abs(model.position_embeddings.weight.std().item() -
             768 ** -0.5) < 2e-3
  layer = model.encoder.layers[0]
  assert abs(layer.intermediate.weight.std().item() - 0.02) < 1e-3
  assert torch.count_nonzero(layer.intermediate.bias) == 0
  assert torch.all(layer.output_norm.weight == 1)
  assert torch.count_nonzero(model.mlm_bias) == 0


def _remat_grads(**kw):
  """Layer-0 FFN gradients without and with remat, dropout on."""
  ids, types, mask = (torch.from_numpy(x) for x in _batch())
  grads = []
  for remat in (False, True):
    torch.manual_seed(0)
    model = BertForPretraining(BertConfig(dtype=torch.float32, remat=remat,
                                          attention_impl='flash',
                                          **dict(TINY, dropout_rate=0.1)))
    model.reset_parameters(torch.Generator().manual_seed(0))
    mlm, nsp = model(ids, types, mask, dropout_key=(5, 2), **kw)
    (mlm.square().mean() + nsp.sum()).backward()
    grads.append(model.encoder.layers[0].intermediate.weight.grad.clone())
  return grads


def test_remat_gives_the_same_gradients():
  grads = _remat_grads()
  torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


def test_remat_gives_the_same_gradients_with_segment_ids():
  mask = torch.from_numpy(_batch()[2])
  seg = torch.where(mask > 0, torch.arange(64)[None, :] // 20, -1)
  grads = _remat_grads(segment_ids=seg)
  torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


def test_a_mesh_that_is_not_the_ports_is_refused():
  with pytest.raises(NotImplementedError):
    BertForPretraining(BertConfig(**TINY), mesh=object())


@pytest.mark.parametrize('ablate', ['attention_core', 'FFN', 'layernorm'])
def test_an_unknown_ablate_raises(ablate):
  """The reference runs the whole model on a value it does not know; the
  port refuses it."""
  with pytest.raises(ValueError, match='ablate'):
    BertForPretraining(BertConfig(ablate=ablate, **TINY))
