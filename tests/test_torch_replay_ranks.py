"""Step replay and bisect of a sharded run, launched as the run's ranks,
on the CPU.

One world of two spawned gloo ranks (``tests/torch_dist_ranks.py:
replay_ranks``) records four runs over the committed shards with the
ledger on, each on its own mesh: ``tensor=2`` and ``fsdp=2`` flash on
``pairs/``, ``seq=2`` ``ring_flash`` on ``packed_small/`` (block-diagonal
rows of 512) with the sentinel and the flight recorder on and an
injected trigger, and ``data=2`` on ``pairs/``; the tiny model the
replay CLI builds (``--model tiny``, bf16, dropout on), a checkpoint at
step 2 and the ``step`` line at step 4. The replay CLI then runs as the
same two ranks (``--comm torch``): ``step 4`` from the corpus and from
the bundles ``bundle`` wrote launched as ranks must match the recorded
fingerprint bit for bit on every rank (exit 0 everywhere, rank 0 alone
printing the verdict), and from a checkpoint with one flipped bit exit
1 on every rank; ``bisect --per-sample`` over ``(2, 4]`` names the
recorded losses exactly, and the incident CLI's bisect of the injected
incident (each rank its own, ``{rank}``) gives the same result, its
replay the recorded step.

Parity with lddl_tpu: a ``tensor=2`` run in float32 with dropout off from
lddl_tpu's init (converted), a checkpoint at 0, bisected over ``(0, 4]``
with ``--per-sample`` through ``bisect_window`` on the ranks, against
``lddl_tpu.replay.steps.bisect_window`` over ``make_mesh(tensor=2)`` (its
flash in interpret mode; run while the ranks run): the same spike step,
batch coordinate and spike sample, the losses and per-sample losses
within ``test_torch_replay.py``'s rtol 2e-4. A mesh the world does not
have is refused in a world of one (``test_torch_tp.py``,
``test_torch_ring.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = os.path.join(ROOT, 'tests', 'assets', 'torch_shards')
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
LOSS_RTOL = 2e-4  # test_torch_replay.py's, across the frameworks
# Both runs: 4 rows a batch rank, the masked-only head, the schedule.
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=8,
             max_predictions=112, seed=2024)
REPLAY = {'steps': 4, 'ckpt_every': 2, 'target': 4}
PARITY_STEPS = 4
PARITY_LR = 1e-2
TINY = dict(vocab_size=30528, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=512, max_position_embeddings=512)
PAIRS = dict(batch_size_per_rank=4, bin_size=128, max_seq_length=512,
             masking='dynamic', shuffle_buffer_size=16)
PACKED = dict(batch_size_per_rank=2, max_seq_length=512,
              shuffle_buffer_size=4)


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


def _model_argv(attention, data):
  argv = ['--model', 'tiny', '--attention', attention, '--device', 'cpu',
          '--learning-rate', str(TRAIN['learning_rate']), '--warmup-steps',
          str(TRAIN['warmup_steps']), '--total-steps',
          str(TRAIN['total_steps']), '--seed', str(TRAIN['seed']),
          '--max-predictions', str(TRAIN['max_predictions'])]
  if data == 'packed':
    argv += ['--data-format', 'packed', '--block-diagonal']
  return argv


def _loader(data):
  """(build kwargs, step's loader argv, bundle's loader argv)."""
  path = os.path.join(SHARDS, 'pairs' if data == 'pairs' else
                      'packed_small')
  if data == 'pairs':
    s = PAIRS
    argv = ['--path', path, '--vocab-file', VOCAB, '--batch-size',
            str(s['batch_size_per_rank']), '--bin-size', str(s['bin_size']),
            '--max-seq-length', str(s['max_seq_length']), '--masking',
            s['masking'], '--shuffle-buffer-size',
            str(s['shuffle_buffer_size'])]
    build = dict(batch_size_per_rank=s['batch_size_per_rank'],
                 bin_size=s['bin_size'], max_seq_length=s['max_seq_length'],
                 masking=s['masking'],
                 loader_kwargs={'shuffle_buffer_size':
                                s['shuffle_buffer_size']})
    return build, argv, argv + ['--base-seed', str(TRAIN['seed'])]
  s = PACKED
  argv = ['--path', path, '--vocab-file', VOCAB, '--batch-size',
          str(s['batch_size_per_rank']), '--max-seq-length',
          str(s['max_seq_length']), '--masking', 'dynamic',
          '--shuffle-buffer-size', str(s['shuffle_buffer_size'])]
  build = dict(batch_size_per_rank=s['batch_size_per_rank'],
               max_seq_length=s['max_seq_length'], masking='dynamic',
               data_format='packed', block_diagonal=True,
               loader_kwargs={'shuffle_buffer_size':
                              s['shuffle_buffer_size']})
  kwargs = dict(path=path, vocab_file=VOCAB, base_seed=TRAIN['seed'],
                block_diagonal=True, **s)
  factory = ['--factory', 'lddl_tpu_torch.loader.packed:'
             'get_packed_pretrain_data_loader', '--kwargs-json',
             json.dumps(kwargs)]
  return build, argv, factory


def _layout(name, axes, attention, data, **extra):
  build, loader_argv, bundle_argv = _loader(data)
  cfg = dict(TINY, attention_impl=attention)
  cfg.update(extra.pop('cfg', {}))
  build.update(TRAIN)
  build.update(extra.pop('build', {}))
  mesh_argv = ['--comm', 'torch'] + [
      a for flag, axis in (('--dp', 'data'), ('--fsdp', 'fsdp'),
                           ('--tp', 'tensor'), ('--sp', 'seq'))
      if axis in axes for a in (flag, str(axes[axis]))]
  return dict(name=name, axes=axes, cfg=cfg, build=build,
              path=loader_argv[1],
              vocab=VOCAB, model_argv=_model_argv(attention, data),
              mesh_argv=mesh_argv, loader_argv=loader_argv,
              bundle_argv=bundle_argv,
              bundled_argv=['--vocab-size', str(TINY['vocab_size'])] + (
                  ['--max-seq-length', str(PACKED['max_seq_length'])]
                  if data == 'packed' else []),
              **extra)


# The injected trigger: the sentinel fires at the 4th step (step 3), so
# the incident's checkpoint is step 2 and its replay step 4.
INCIDENT = 'raise:sentinel.trigger:nth=4'
LAYOUTS = [
    _layout('tp2', {'tensor': 2}, 'flash', 'pairs', flip=True),
    _layout('fsdp2', {'fsdp': 2}, 'flash', 'pairs'),
    _layout('sp2', {'seq': 2}, 'ring_flash', 'packed', incident=INCIDENT),
    _layout('dp2', {'data': 2}, 'flash', 'pairs', bisect=True),
]


def _parity_layout():
  import torch
  return _layout('parity', {'tensor': 2}, 'flash', 'pairs',
                 cfg={'dtype': torch.float32, 'dropout_rate': 0.0},
                 build={'learning_rate': PARITY_LR})


def _jax_run(init_path, ckpt):
  """lddl_tpu's tensor=2 loop over the same shards (float32, dropout
  off, flash in interpret mode): its init written for the ranks, a
  checkpoint at 0, PARITY_STEPS steps, then its bisect_window; and
  lddl_tpu's loss of each row the run fed its spike step, with the
  weights that step started from. (lddl_tpu's own per-sample scoring
  re-seeks its loader mid-epoch, with resume semantics: another batch
  than the run fed, ROADMAP Queue 3; ``test_torch_replay.py`` scores the
  fed rows the same way.)"""
  from lddl_tpu.models import BertConfig as JaxConfig
  from lddl_tpu.parallel import make_mesh
  from lddl_tpu.parallel.train import pretrain_loss
  from lddl_tpu.replay.steps import bisect_window, replay_steps
  from lddl_tpu.tokenization.wordpiece import load_bert_tokenizer as jtok
  from lddl_tpu.training.pretrain import TrainLoop as JaxLoop
  from lddl_tpu_torch.models import flax_to_state_dict
  from lddl_tpu_torch.replay import rematerialize_batch
  build, _, _ = _loader('pairs')
  build.update(TRAIN, learning_rate=PARITY_LR)
  loop = JaxLoop.build(
      os.path.join(SHARDS, 'pairs'), jtok(vocab_file=VOCAB, backend='hf'),
      model_cfg=JaxConfig(dtype=jnp.float32, dropout_rate=0.0,
                          attention_impl='flash', **TINY),
      mesh=make_mesh(tensor=2, devices=jax.devices()[:2]), **build)
  state = {k: v.numpy() for k, v in
           flax_to_state_dict(jax.device_get(loop.params)).items()}
  np.savez(init_path + '.tmp.npz', **state)
  os.replace(init_path + '.tmp.npz', init_path)
  loop.save(ckpt)
  losses = loop.run(PARITY_STEPS, log_every=0)
  out = bisect_window(loop, ckpt, 0, PARITY_STEPS)
  loop.restore(ckpt, step=0)
  if out['spike_step'] > 1:
    replay_steps(loop, out['spike_step'] - 1)
  c = out['batch_coordinate']
  batch = rematerialize_batch(
      ('lddl_tpu_torch.loader.bert', 'get_bert_pretrain_data_loader'),
      dict(path=os.path.join(SHARDS, 'pairs'), vocab_file=VOCAB,
           base_seed=TRAIN['seed'], **PAIRS), c['epoch'], c['index'])
  row_loss = jax.jit(lambda params, one: pretrain_loss(
      loop.model, params, one, max_predictions=TRAIN['max_predictions'])[0])
  fed = [float(row_loss(loop.params, {k: v[i:i + 1] for k, v in
                                      batch.items()}))
         for i in range(len(batch['input_ids']))]
  return losses, out, fed


@pytest.fixture(scope='module')
def world(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('replay_ranks'))
  init = os.path.join(root, 'init.npz')
  parity = {'init': init, 'layout': _parity_layout(),
            'steps': PARITY_STEPS}
  procs, q = ranks.start_world(ranks.replay_ranks, 2,
                               args=(root, LAYOUTS, REPLAY, parity))
  try:
    jax_losses, jax_bisect, jax_fed = _jax_run(
        init, os.path.join(root, 'jax_ckpt'))
  finally:
    res = ranks.join_world(procs, q, timeout=300)
  return {'ranks': res, 'jax_losses': jax_losses, 'jax_bisect': jax_bisect,
          'jax_fed': jax_fed}


@pytest.mark.parametrize('name', [x['name'] for x in LAYOUTS])
@pytest.mark.parametrize('source', ['corpus', 'bundled'])
def test_step_replays_bit_for_bit_on_every_rank(world, name, source):
  """``step 4`` launched as the two ranks: exit 0 on both, rank 0 alone
  printing the verdict, in the single-process wording."""
  got = [world['ranks'][r][name][source] for r in range(2)]
  assert [rc for rc, _, _ in got] == [0, 0], got
  assert 'reconstructed bit-identical' in got[0][1], got[0]
  assert got[1][1] == '', got[1]


@pytest.mark.parametrize('name', [x['name'] for x in LAYOUTS])
def test_bundles_are_written_one_a_batch_rank(world, name):
  layout = next(x for x in LAYOUTS if x['name'] == name)
  n = layout['axes'].get('data', 1) * layout['axes'].get('fsdp', 1)
  for r in range(2):
    res = world['ranks'][r][name]
    assert [rc for rc, _, _ in res['bundle']] == [0, 0], res['bundle']
    assert res['bundle_ranks'] == [f'rank{b}' for b in range(n)]
    assert res['record']['dp'] == ((r if n == 2 else 0), n)


def test_a_flipped_bit_is_a_mismatch_on_every_rank(world):
  got = [world['ranks'][r]['tp2']['flipped'] for r in range(2)]
  assert [rc for rc, _, _ in got] == [1, 1], got
  assert 'MISMATCH' in got[0][1] and got[1][1] == ''


@pytest.mark.parametrize('name', ['dp2', 'sp2'])
def test_bisect_names_the_recorded_losses(world, name):
  """``bisect --per-sample`` over (2, 4]: the recorded losses bit for
  bit, the batch rank's coordinate, the global rows of every batch
  rank scored."""
  rc, out, _ = world['ranks'][0][name]['bisect']
  assert rc == 0 and world['ranks'][1][name]['bisect'][0] == 0
  result = json.loads(out)
  recorded = world['ranks'][0][name]['record']
  assert [x for _, x in result['losses']] == recorded['losses'][2:]
  assert result['batch_coordinate'] == dict(zip(
      ('epoch', 'index'), recorded['coords'][result['spike_step'] - 1]))
  layout = next(x for x in LAYOUTS if x['name'] == name)
  rows = layout['build']['batch_size_per_rank'] * recorded['dp'][1]
  assert len(result['per_sample']) == rows
  assert result['spike_sample_batch_rank'] == (
      result['spike_sample'] // layout['build']['batch_size_per_rank'])


def test_incident_bisect_is_the_replay_bisect(world):
  """The incident CLI launched as the ranks bisects each rank's own
  incident (``{rank}``) to the replay CLI's result; its replay
  reproduces the recorded step from each rank's ring."""
  for r in range(2):
    res = world['ranks'][r]['sp2']
    assert len(res['incidents']) == 1, res['incidents']
    assert res['incident_bisect'][0] == 0, res['incident_bisect']
    assert res['incident_replay'][0] == 0, res['incident_replay']
  mine = world['ranks'][0]['sp2']
  assert json.loads(mine['incident_bisect'][1]) == json.loads(
      mine['bisect'][1])
  assert 'reconstructed bit-identical' in mine['incident_replay'][1]


def test_bisect_names_what_lddl_tpu_names(world):
  """tensor=2 from lddl_tpu's init: the port's bisect_window on the two
  ranks names lddl_tpu's spike step and batch coordinate, and as spike
  sample the row lddl_tpu's loss ranks first among the rows the run fed;
  losses and per-sample losses within LOSS_RTOL."""
  mine = [world['ranks'][r]['parity']['bisect'] for r in range(2)]
  assert mine[0] == mine[1]
  mine, theirs = mine[0], world['jax_bisect']
  np.testing.assert_allclose(world['ranks'][0]['parity']['record']['losses'],
                             world['jax_losses'], rtol=LOSS_RTOL)
  np.testing.assert_allclose([x for _, x in mine['losses']],
                             [x for _, x in theirs['losses']],
                             rtol=LOSS_RTOL)
  assert mine['spike_step'] == theirs['spike_step']
  assert mine['batch_coordinate'] == theirs['batch_coordinate']
  fed = world['jax_fed']
  np.testing.assert_allclose(mine['per_sample'], fed, rtol=LOSS_RTOL)
  assert mine['spike_sample'] == int(np.argmax(fed))
  assert mine['spike_sample_batch_rank'] == 0
