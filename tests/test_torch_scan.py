"""The scan window (lddl_tpu_torch.parallel.train.make_scan_train_step,
stack_batch_window) against K single steps of the port and against
lddl_tpu's make_scan_train_step, on the CPU.

- The port against itself, dropout on, K=3, pairs and packed batches,
  one process and a data rank above 0: a window leaves the params,
  AdamW's mu, nu, count_t and host count, and the last step's metrics
  bit-equal to 3 TrainStep calls, window after window. The CPU window
  draws its dropout from one generator set per step slot, the mechanism
  its CUDA graph uses.
- The port against lddl_tpu, dropout off, float32, the same numpy
  batches and converted weights, flash attention (Pallas in interpret
  mode on the JAX side), segment-free and packed: the last step's loss,
  mlm_loss, nsp_loss and grad_norm within test_torch_train.py's 2e-4
  relative; the params after the window within PARAM_RTOL / PARAM_ATOL.
- stack_batch_window: np.stack's values, its host stack reused across
  windows of one signature, mixed signatures refused.
- A capture that fails names the op (the capture itself is stubbed: the
  CPU has no CUDA graph).

Tolerances: see each test; the port against itself is exact.
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
from lddl_tpu.parallel import make_mesh
from lddl_tpu.parallel import make_scan_train_step as jax_scan
from lddl_tpu.parallel import stack_batch_window as jax_stack
from lddl_tpu_torch.models import (BertConfig, BertForPretraining,
                                   flax_to_state_dict)
from lddl_tpu_torch.parallel import (TrainStep, make_scan_train_step,
                                     stack_batch_window)
from lddl_tpu_torch.parallel import train as ttrain

from test_torch_train import TINY, _batch, _packed_batch
from torch_threads import torch_one_thread_a_file  # noqa: F401

K = 3
LR, WARMUP, TOTAL, WD = 1e-3, 2, 10, 0.01
LOSS_RTOL = 2e-4  # test_torch_train.py's, across the frameworks
# Params after K steps across the frameworks: test_torch_train.py's AdamW
# tolerance (rtol 1e-5, atol 1e-7) holds for every weight but the attention
# key biases, whose gradient is zero up to float32 rounding (softmax
# ignores a per-row shift): Adam normalizes that rounding into an update,
# and the frameworks' differ by up to 7.1e-7 after these 3 steps.
PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-6
METRICS = ('loss', 'mlm_loss', 'nsp_loss', 'grad_norm')


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port makes no shm segment here; the shared fixture would count
  # other xdist workers' lddl_ segments as this test's leak.
  yield


def _batches(packed, first, n=K):
  if packed:
    return [_packed_batch(s=128, seed=first + i) for i in range(n)]
  return [_batch(seed=first + i) for i in range(n)]


def _torch_model(dropout, params=None, impl='flash'):
  cfg = BertConfig(dtype=torch.float32, attention_impl=impl,
                   **dict(TINY, dropout_rate=dropout))
  model = BertForPretraining(cfg)
  if params is None:
    model.reset_parameters(torch.Generator().manual_seed(0))
  else:
    model.load_state_dict(params)
  return model.train()


def _opt(model):
  return ttrain.AdamW(model.parameters(), functools.partial(
      ttrain.learning_rate, peak=LR, warmup_steps=WARMUP, total_steps=TOTAL),
                      weight_decay=WD)


def _state(model, opt):
  return ([p.detach().clone() for p in model.parameters()],
          [t.clone() for t in opt.mu], [t.clone() for t in opt.nu],
          opt.count_t.clone(), opt.count)


def _assert_same_state(a, b):
  for x, y in zip(a[:3], b[:3]):
    for u, v in zip(x, y):
      torch.testing.assert_close(u, v, rtol=0, atol=0)
  torch.testing.assert_close(a[3], b[3], rtol=0, atol=0)
  assert a[4] == b[4]


@pytest.mark.parametrize('packed', [False, True], ids=['pairs', 'packed'])
@pytest.mark.parametrize('dp_rank', [0, 1])
def test_window_equals_single_steps_with_dropout(packed, dp_rank):
  """Two windows of K steps vs 2K TrainStep calls from the same state,
  dropout 0.1: every state tensor and the last step's metrics bit-equal
  after each window."""
  windows = [_batches(packed, 10), _batches(packed, 20)]
  single, scan = _torch_model(0.1), _torch_model(0.1)
  sopt, wopt = _opt(single), _opt(scan)
  step = TrainStep(single, sopt, max_predictions=16, dp_rank=dp_rank)
  run = make_scan_train_step(scan, wopt, max_predictions=16,
                             dp_rank=dp_rank)
  assert run.mode == 'graph'  # what the card runs; here eagerly
  for batches in windows:
    for b in batches:
      want = step({k: torch.from_numpy(v) for k, v in b.items()},
                  dropout_seed=3)
    got = run(stack_batch_window(batches, 'cpu'), dropout_seed=3)
    assert sorted(got) == sorted(want)
    for name in want:
      torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    _assert_same_state(_state(scan, wopt), _state(single, sopt))
  assert wopt.count == 2 * K
  assert (run.captures, run.hits) == (0, 0)  # no CUDA graph on the CPU


def test_window_steps_draw_different_masks():
  """The K slots draw K different dropout masks: a window of one batch
  repeated K times differs from K steps that all draw step 0's mask."""
  b = _batch(seed=5)
  scan, fixed = _torch_model(0.1), _torch_model(0.1)
  wopt, fopt = _opt(scan), _opt(fixed)
  got = make_scan_train_step(scan, wopt)(stack_batch_window([b] * K, 'cpu'),
                                         dropout_seed=3)
  step = TrainStep(fixed, fopt)
  for _ in range(K):
    fixed.seed_dropout((3, 0))
    want = step.body({k: torch.from_numpy(v) for k, v in b.items()})
    step.finish()
  assert float(got['loss']) != float(want['loss'])


def _jax_side(impl, batch):
  jmodel = JaxBert(JaxConfig(dtype=jnp.float32, attention_impl=impl,
                             **TINY), mesh=None)
  params = jmodel.init(jax.random.key(1), jnp.asarray(batch['input_ids']),
                       jnp.asarray(batch['token_type_ids']),
                       jnp.asarray(batch['attention_mask']))['params']
  return jmodel, params


@pytest.mark.parametrize('packed', [False, True], ids=['pairs', 'packed'])
def test_window_matches_lddl_tpu_scan(packed):
  """One window of K steps in both packages from the same weights and
  batches, dropout off, flash attention: the last step's metrics within
  LOSS_RTOL, the params within PARAM_RTOL / PARAM_ATOL."""
  batches = _batches(packed, 30)
  jmodel, params = _jax_side('flash', batches[0])
  tmodel = _torch_model(0.0, flax_to_state_dict(jax.device_get(params)))
  tx = optax.adamw(optax.warmup_cosine_decay_schedule(
      0.0, LR, WARMUP, max(TOTAL, WARMUP + 1)), weight_decay=WD)
  mesh = make_mesh(devices=jax.devices()[:1])
  run = jax_scan(jmodel, tx, mesh)
  params, _, jm = run(params, tx.init(params), jax.random.key(2),
                      jax_stack(batches, mesh))
  topt = _opt(tmodel)
  tm = make_scan_train_step(tmodel, topt)(stack_batch_window(batches, 'cpu'),
                                          dropout_seed=3)
  assert topt.count == K
  for name in METRICS:
    np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                               rtol=LOSS_RTOL, err_msg=name)
  want = flax_to_state_dict(jax.device_get(params))
  got = tmodel.state_dict()
  assert sorted(got) == sorted(want)
  for name in want:
    np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                               rtol=PARAM_RTOL, atol=PARAM_ATOL,
                               err_msg=name)


def test_stack_batch_window_values():
  """Every key = np.stack of the batches' arrays, dtype kept; numpy and
  CPU tensors alike."""
  batches = _batches(True, 40)
  got = stack_batch_window(batches, 'cpu')
  mixed = stack_batch_window(
      [{k: torch.from_numpy(v) for k, v in b.items()} if i % 2 else b
       for i, b in enumerate(batches)], 'cpu')
  for window in (got, mixed):
    assert sorted(window) == sorted(batches[0])
    for k in batches[0]:
      want = np.stack([b[k] for b in batches])
      assert window[k].numpy().dtype == want.dtype
      np.testing.assert_array_equal(window[k].numpy(), want)


def test_stack_batch_window_reuses_its_host_stack():
  """One host stack per (signature, K): the same storage for two windows
  of one signature, another for another K; the returned windows are
  copies, so the second window leaves the first intact."""
  first, second = _batches(False, 50), _batches(False, 60)
  w1 = stack_batch_window(first, 'cpu')
  sig = ttrain.signature({k: torch.from_numpy(v) for k, v in
                          first[0].items()})
  host = ttrain.WINDOW_STACKS[(sig, K, False)][0]
  ptrs = {k: t.data_ptr() for k, t in host.items()}
  w2 = stack_batch_window(second, 'cpu')
  host = ttrain.WINDOW_STACKS[(sig, K, False)][0]
  assert {k: t.data_ptr() for k, t in host.items()} == ptrs
  for k in first[0]:
    np.testing.assert_array_equal(w1[k].numpy(),
                                  np.stack([b[k] for b in first]))
    np.testing.assert_array_equal(w2[k].numpy(),
                                  np.stack([b[k] for b in second]))
    assert w1[k].data_ptr() != ptrs[k]
  stack_batch_window(first[:2], 'cpu')
  assert (sig, 2, False) in ttrain.WINDOW_STACKS


def test_stack_batch_window_refuses_mixed_signatures():
  pairs = _batches(False, 70, n=2)
  with pytest.raises(ValueError, match='mixed batch signatures'):
    stack_batch_window(pairs + [_batch(s=32, seed=1)], 'cpu')
  other = dict(pairs[1], labels=pairs[1]['labels'].astype(np.int64))
  with pytest.raises(ValueError, match='mixed batch signatures'):
    stack_batch_window([pairs[0], other], 'cpu')


def test_window_mode_follows_the_step():
  """mode is 'eager' for a step whose exchange cannot be captured (gloo),
  as CompiledStepCache.mode; it then runs the K bodies in turn."""

  class Gloo:
    capturable = False

  model = _torch_model(0.0)
  run = make_scan_train_step(model, _opt(model), exchange=Gloo())
  assert run.mode == 'eager'


def test_a_failed_capture_names_the_op(monkeypatch):
  """capture_step (the cache's and the window's) raises a RuntimeError
  naming the file and line of the op that failed, after running the
  warm-up; the launch counters are put back."""
  from lddl_tpu_torch.ops import flash_attention as tfa

  class Stream:

    def wait_stream(self, other):
      pass

  class Graph:

    def register_generator_state(self, gen):
      pass

  monkeypatch.setattr(torch.cuda, 'current_stream', lambda: Stream())
  monkeypatch.setattr(torch.cuda, 'stream', lambda s: _null())
  monkeypatch.setattr(torch.cuda, 'CUDAGraph', Graph)
  monkeypatch.setattr(torch.cuda, 'graph', lambda *a, **kw: _null())
  before = dict(tfa.launches)
  ran = []

  def body():
    tfa.launches['fwd'] += 12
    raise RuntimeError('operation not permitted when stream is capturing')

  with pytest.raises(RuntimeError) as e:
    ttrain.capture_step(Stream(), lambda: ran.append(1), body, [],
                        'a window of 3 train steps')
  assert ran == [1]
  msg = str(e.value)
  assert msg.startswith('capturing a window of 3 train steps into a CUDA '
                        'graph failed at ')
  assert 'test_torch_scan.py' in msg and 'raise RuntimeError' in msg
  assert tfa.launches == before


def _null():
  import contextlib
  return contextlib.nullcontext()
