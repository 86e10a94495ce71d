"""lddl_tpu_torch's step cache and the pieces a captured step needs.

On the CPU the cache runs every step eagerly (the kernel wrappers take
their plain versions there) and counts misses and hits per batch
signature, as the card does; the graphs themselves run only on the card
(``chip_smoke.py`` holds them against eager steps bit for bit). Held
against lddl_tpu on the same inputs:

  - the cache's (misses, hits) sequence, counter names and env gate, as
    ``tests/test_device_feed.py::TestCompiledStepCache`` drives the JAX
    cache;
  - AdamW with its device-side count and schedule against optax over
    steps that cross the warmup boundary (rtol 1e-5, atol 1e-7, as
    ``test_torch_train.py``'s raw-array AdamW test);
  - the persistent dropout generators draw the bits the former fresh
    per-call generators drew, remat included;
  - a preemption notice stops the run behind a checkpoint whose resume
    equals the uninterrupted run.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lddl_tpu.training.pretrain import CompiledStepCache as JaxCache
from lddl_tpu.training.pretrain import _step_cache_enabled as jax_enabled
from lddl_tpu_torch import telemetry as ttele
from lddl_tpu_torch.core import faults
from lddl_tpu_torch.models import BertConfig, BertForPretraining
from lddl_tpu_torch.models import bert as tbert
from lddl_tpu_torch.parallel import train as ttrain
from lddl_tpu_torch.training import CompiledStepCache, TrainLoop
from lddl_tpu_torch.training.elastic import WriteBackError
from lddl_tpu_torch.training.pretrain import _step_cache_enabled

from test_torch_pretrain import CFG, _batch, _Loader
from torch_threads import torch_one_thread_a_file  # noqa: F401


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


@pytest.fixture(autouse=True)
def _port_telemetry_off():
  yield
  ttele.disable()
  faults.reset()


def _tensors(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _step(seed=5):
  model = BertForPretraining(CFG)
  model.reset_parameters(torch.Generator().manual_seed(seed))
  opt = ttrain.AdamW(model.parameters(), functools.partial(
      ttrain.learning_rate, peak=1e-3, warmup_steps=2, total_steps=6))
  return ttrain.TrainStep(model, opt)


# ---- the cache against lddl_tpu's ----

# Batch signatures in the order a binned loader might give them: two bins,
# then a third shape (another batch size) late in the run.
_SEQUENCE = ((64, 4), (128, 4), (64, 4), (64, 4), (128, 4), (64, 2),
             (128, 4), (64, 2))


def _jax_step(params, opt_state, rng, batch):
  del rng
  return params, opt_state, {'loss': jnp.sum(batch['input_ids']) * params}


def test_miss_hit_sequence_matches_jax():
  jcache = JaxCache(jax.jit(_jax_step))
  tcache = CompiledStepCache(_step())
  got, want = [], []
  for i, (s, b) in enumerate(_SEQUENCE):
    batch = _batch(s, i, b=b)
    jcache(jnp.float32(1.0), jnp.float32(0.0), jax.random.PRNGKey(0), batch)
    metrics = tcache(_tensors(batch), dropout_seed=3)
    assert math.isfinite(float(metrics['loss']))
    want.append((jcache.misses, jcache.hits))
    got.append((tcache.misses, tcache.hits))
  assert got == want
  assert got[-1] == (3, 5)
  assert tcache.retrace_seconds > 0.0
  assert tcache.last_costs is None  # telemetry off: nothing is counted


def test_cache_steps_equal_plain_steps():
  """On the CPU a cached step is the step: same losses, same state."""
  cached, plain = _step(), _step()
  cache = CompiledStepCache(cached)
  for i, (s, b) in enumerate(_SEQUENCE[:4]):
    batch = _tensors(_batch(s, i, b=b))
    a = cache(batch, dropout_seed=3)
    c = plain(batch, dropout_seed=3)
    assert float(a['loss']) == float(c['loss'])
    assert float(a['grad_norm']) == float(c['grad_norm'])
  assert cached.opt.count == plain.opt.count == 4
  for p, q in zip(cached.opt.params, plain.opt.params):
    torch.testing.assert_close(p, q, rtol=0, atol=0)


def _snapshot(tele):
  return {line['name']: line for line in tele.snapshot_lines()
          if line['kind'] != 'meta'}


def test_counter_names_match_jax():
  from lddl_tpu.telemetry import enable as jax_enable
  jtele = jax_enable()
  jcache = JaxCache(jax.jit(_jax_step))
  batch = _batch(64, 0)
  for _ in range(2):
    jcache(jnp.float32(1.0), jnp.float32(0.0), jax.random.PRNGKey(0), batch)
  ttele.enable()
  tcache = CompiledStepCache(_step())
  for _ in range(2):
    tcache(_tensors(batch), dropout_seed=3)
  want = _snapshot(jtele)
  got = _snapshot(ttele.get_telemetry())
  assert sorted(got) == sorted(want) == [
      'train.retrace_seconds', 'train.step_cache_hits',
      'train.step_cache_misses', 'train.xla_bytes', 'train.xla_flops']
  # XLA's count of a toy step and the port's of a BERT step differ; both
  # bill theirs on each of the two steps.
  for name in ('train.xla_flops', 'train.xla_bytes'):
    assert got[name]['total'] > 0 and want[name]['total'] > 0, name
  for name in ('train.step_cache_hits', 'train.step_cache_misses'):
    assert got[name]['total'] == want[name]['total'] == 1, name
  assert got['train.retrace_seconds']['count'] == 1


@pytest.mark.parametrize('value', ['0', 'false', 'off', 'no', 'No', ' 0 ',
                                   '1', '', 'yes', 'on'])
def test_env_gate_matches_jax(monkeypatch, value):
  monkeypatch.setenv('LDDL_STEP_CACHE', value)
  assert _step_cache_enabled() == jax_enabled()
  monkeypatch.delenv('LDDL_STEP_CACHE')
  assert _step_cache_enabled() and jax_enabled()


def _loop(**kw):
  loop = TrainLoop.build(model_cfg=CFG, device='cpu', learning_rate=1e-3,
                         warmup_steps=2, total_steps=6, seed=5, **kw)
  loop.loader = _Loader(6)
  return loop


def test_loop_keeps_its_cache_across_runs_and_restore(tmp_path):
  """The loop wraps its step once: a second run(), and a restore(), go on
  with the same cache and its entries (one miss per bin)."""
  loop = _loop()
  loop.run(3, ckpt_dir=str(tmp_path), log_every=0)
  cache = loop.step_cache
  assert (cache.misses, cache.hits) == (2, 1)
  loop.loader.start = 3
  loop.run(6, log_every=0)
  assert loop.step_cache is cache and (cache.misses, cache.hits) == (2, 4)
  loop.restore(str(tmp_path))
  loop.loader.start = 3
  loop.run(6, log_every=0)
  assert loop.step_cache is cache and (cache.misses, cache.hits) == (2, 7)


def test_cache_off_runs_the_plain_step(monkeypatch):
  on = _loop().run(6, log_every=0)
  monkeypatch.setenv('LDDL_STEP_CACHE', '0')
  loop = _loop()
  assert loop.run(6, log_every=0) == on
  assert loop.step_cache is None


# ---- AdamW with its count and schedule on the device ----


@pytest.mark.parametrize('warmup,total', [(3, 10), (0, 5), (5, 3)])
def test_schedule_of_a_device_count_matches_optax(warmup, total):
  ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                           max(total, warmup + 1))
  count = torch.zeros((), dtype=torch.float32)
  for step in range(total + 4):
    got = ttrain.learning_rate(count, 3e-4, warmup, total)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(ref(step)), rtol=1e-6,
                               atol=3e-4 * 1e-6, err_msg=f'step {step}')
    count += 1


def test_adamw_device_count_matches_optax_across_warmup():
  """Twelve updates through warmup (3 steps) into the cosine decay, the
  count, bias corrections and learning rate all tensors."""
  rng = np.random.default_rng(1)
  p0 = [rng.standard_normal(s, dtype=np.float32) for s in ((5, 3), (7,))]
  grads = [[rng.standard_normal(p.shape, dtype=np.float32) for p in p0]
           for _ in range(12)]
  tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10),
                   weight_decay=0.05)
  jp = [jnp.asarray(p) for p in p0]
  state = tx.init(jp)
  tp = [torch.from_numpy(p.copy()) for p in p0]
  opt = ttrain.AdamW(tp, functools.partial(
      ttrain.learning_rate, peak=1e-2, warmup_steps=3, total_steps=10),
                     weight_decay=0.05)
  count_t, mu = opt.count_t, list(opt.mu)
  for i, g in enumerate(grads):
    upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
    jp = optax.apply_updates(jp, upd)
    opt.step([torch.from_numpy(x) for x in g])
    for t, j in zip(tp, jp):
      np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                 atol=1e-7, err_msg=f'update {i}')
  assert opt.count == 12 and float(opt.count_t) == 12.0
  # Updated in place, never rebound: a captured graph keeps its pointers.
  assert opt.count_t is count_t and all(a is b for a, b in zip(opt.mu, mu))


def test_adamw_load_state_dict_copies_in_place():
  params = [torch.ones(4), torch.zeros(2)]
  opt = ttrain.AdamW(params, lambda step: 1e-2)
  for _ in range(3):
    opt.step([torch.ones(4), torch.ones(2)])
  saved = {'count': opt.state_dict()['count'],
           'mu': [t.clone() for t in opt.mu],
           'nu': [t.clone() for t in opt.nu]}
  ptrs = [t.data_ptr() for t in [opt.count_t] + opt.mu + opt.nu]
  opt.step([torch.ones(4), torch.ones(2)])
  opt.load_state_dict(saved)
  assert isinstance(opt.state_dict()['count'], int)
  assert opt.count == 3 and float(opt.count_t) == 3.0
  assert [t.data_ptr() for t in [opt.count_t] + opt.mu + opt.nu] == ptrs
  for a, b in zip(opt.mu + opt.nu, saved['mu'] + saved['nu']):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- persistent dropout generators ----


def _fresh_generator_masks(key, cfg, shape):
  """The masks the former per-call generators drew: one fresh generator
  per site seeded from (key, site), the embeddings' one draw, then two
  per layer in the order the layer applies them."""
  seeds = tbert._site_seeds(key, cfg.num_layers + 1)
  masks = []
  for site, seed in enumerate(seeds):
    g = torch.Generator().manual_seed(seed)
    for _ in range(1 if site == 0 else 2):
      masks.append(torch.rand(shape, generator=g) < 1 - cfg.dropout_rate)
  return masks


def _drawn_masks(monkeypatch, model, batch, **kw):
  drawn = []
  original = tbert._keep_mask

  def recording(*args):
    keep = original(*args)
    drawn.append(keep)
    return keep

  monkeypatch.setattr(tbert, '_keep_mask', recording)
  ids, types, mask = (torch.from_numpy(batch[k]) for k in
                      ('input_ids', 'token_type_ids', 'attention_mask'))
  mlm, nsp = model(ids, types, mask, **kw)
  (mlm.square().mean() + nsp.sum()).backward()
  monkeypatch.setattr(tbert, '_keep_mask', original)
  return drawn, model.encoder.layers[0].intermediate.weight.grad.clone()


@pytest.mark.parametrize('remat', [False, True], ids=['plain', 'remat'])
def test_persistent_generators_draw_the_former_fresh_bits(monkeypatch,
                                                          remat):
  cfg = BertConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
                   intermediate_size=128, max_position_embeddings=128,
                   dtype=torch.float32, attention_impl='flash', remat=remat,
                   dropout_rate=0.1)
  model = BertForPretraining(cfg)
  model.reset_parameters(torch.Generator().manual_seed(0))
  batch = _batch(64, 0)
  shape = (4, 64, cfg.hidden_size)
  gens = None
  for key in ((5, 2), (5, 3), (5, 2)):
    model.zero_grad(set_to_none=True)
    drawn, grad = _drawn_masks(monkeypatch, model, batch, dropout_key=key)
    # The forward draws once per site, equal to the former fresh draws;
    # with remat the backward then recomputes the layers, last first, and
    # redraws each layer's two masks from its twin.
    want = _fresh_generator_masks(key, cfg, shape)
    assert len(want) == 1 + 2 * cfg.num_layers
    if remat:
      for layer in reversed(range(cfg.num_layers)):
        want += want[1 + 2 * layer:3 + 2 * layer]
    assert len(drawn) == len(want)
    for d, w in zip(drawn, want):
      assert torch.equal(d, w)
    if gens is None:
      gens, first_grad = model.dropout_generators(), grad
    assert all(a is b for a, b in zip(model.dropout_generators(), gens))
  # The same key gives the same step, whatever ran in between.
  torch.testing.assert_close(grad, first_grad, rtol=0, atol=0)
  # SEEDED draws from the generators as seed_dropout left them.
  model.seed_dropout((5, 3))
  model.zero_grad(set_to_none=True)
  drawn, _ = _drawn_masks(monkeypatch, model, batch, dropout_key=tbert.SEEDED)
  for d, w in zip(drawn, _fresh_generator_masks((5, 3), cfg, shape)):
    assert torch.equal(d, w)


def test_seeded_before_any_seed_raises():
  model = BertForPretraining(BertConfig(
      vocab_size=128, hidden_size=64, num_layers=1, num_heads=2,
      intermediate_size=128, dtype=torch.float32, dropout_rate=0.1))
  ids = torch.zeros((1, 8), dtype=torch.int32)
  with pytest.raises(ValueError, match='seed_dropout'):
    model(ids, ids, torch.ones_like(ids), dropout_key=tbert.SEEDED)


def test_train_step_reseeds_from_the_count():
  """The step's dropout key is (dropout_seed, opt.count): two steps from
  one state and batch with the same count draw the same masks."""
  step = _step()
  batch = _tensors(_batch(64, 0))
  a = float(step(batch, dropout_seed=3)['loss'])
  b = float(step(batch, dropout_seed=3)['loss'])
  restarted = _step()
  assert float(restarted(batch, dropout_seed=3)['loss']) == a
  assert a != b


# ---- preemption and the async checkpoint writer ----


def test_preemption_file_stops_behind_a_resumable_checkpoint(monkeypatch,
                                                             tmp_path):
  straight = _loop().run(6, log_every=0)
  notice = tmp_path / 'maintenance'
  monkeypatch.setenv('LDDL_PREEMPTION_FILE', str(notice))
  ckpt = str(tmp_path / 'ckpt')
  loop = _loop()
  head = loop.run(2, log_every=0)
  notice.write_text('')
  loop.loader.start = 2
  head += loop.run(6, ckpt_dir=ckpt, log_every=0)
  assert loop.stop_reason == 'preempted' and len(head) == 3
  assert TrainLoop.latest_meta(ckpt) == (3, 12)
  notice.unlink()
  resumed = _loop().restore(ckpt)
  resumed.loader.start = resumed.step
  tail = resumed.run(6, log_every=0)
  assert resumed.stop_reason is None
  assert head + tail == straight


def test_async_checkpoints_equal_sync_ones(tmp_path):
  digests = {}
  for mode in (False, True):
    ckpt = str(tmp_path / f'async{int(mode)}')
    loop = _loop()
    loop.run(4, ckpt_dir=ckpt, ckpt_every=2, log_every=0, async_ckpt=mode)
    assert TrainLoop.latest_meta(ckpt) == (4, 16)
    digests[mode] = [_loop().restore(ckpt, step=s).state_digest()
                     for s in (2, 4)]
  assert digests[True] == digests[False]


def test_async_checkpoint_failure_surfaces(monkeypatch, tmp_path):
  monkeypatch.setenv('LDDL_FAULTS', 'raise:train.ckpt:nth=1')
  with pytest.raises(WriteBackError, match='injected fault at train.ckpt'):
    _loop().run(4, ckpt_dir=str(tmp_path), ckpt_every=1, log_every=0,
                async_ckpt=True)
