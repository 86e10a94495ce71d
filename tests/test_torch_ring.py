"""Ring attention of lddl_tpu_torch vs lddl_tpu's, on the CPU.

The port's ``ring_attention`` runs on rings of 1, 2 and 4 spawned gloo
ranks (``tests/torch_dist_ranks.py:ring_shards``; each rank holds its
``1 / n`` of the sequence, K/V rotate by ``batch_isend_irecv``); the JAX
side is ``lddl_tpu.parallel.ring.make_ring_attention`` over
``make_mesh(seq=n)`` on the 8-device CPU platform (flash blocks run the
Pallas kernels in interpret mode; the port's run its kernels' plain
versions). The same numpy inputs go to both, at the sizes of
``tests/test_model.py::TestRingAttention`` ([2, 2, 32, 8], a padded
tail of 7), ``tests/test_flash_attention.py::test_ring_flash_matches_dense``
([2, 2, 64, 32]) and ``tests/test_block_diagonal.py::test_ring_*``
(ragged documents over the shards, so that some rotated shards are
disjoint from the q shard in every row, which the JAX ring skips whole
and the port's segmented kernels empty tile by tile, and others
overlap it). The
outputs on real rows, and dq/dk/dv for a random cotangent that is zero
on padding rows (as in the model), agree with JAX's (``jax.vjp`` of the
sharded ring) within 2e-4, float32. A case whose q shard is all padding
on one rank, so that JAX skips every block there, its first included,
gives no NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_ranks as ranks
from lddl_tpu.parallel import make_mesh
from lddl_tpu.parallel.ring import make_ring_attention as jax_ring
from lddl_tpu_torch.parallel.mesh import (MESH_AXES, canonical_batch_spec,
                                          local_batch, seq_columns)
from lddl_tpu_torch.parallel.ring import make_ring_attention, ring_attention


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


TOL = 2e-4


def _ragged(b, s, k, seed, pad_tail=True):
  """tests/test_block_diagonal.py's ``_ragged_segments``: k docs a row,
  boundaries off every block size, row 0's tail padding."""
  rng = np.random.default_rng(seed)
  seg = np.zeros((b, s), np.int32)
  mask = np.ones((b, s), np.int32)
  for row in range(b):
    cuts = sorted(
        set(int(np.clip(i * s // k + rng.integers(-s // (4 * k), s //
                                                  (4 * k) + 1), 1, s - 1))
            for i in range(1, k)))
    bounds = [0] + cuts + [s]
    for d in range(len(bounds) - 1):
      seg[row, bounds[d]:bounds[d + 1]] = d
  if pad_tail:
    tail = s - max(1, s // 13)
    mask[0, tail:] = 0
    seg[0, tail:] = -1
  return seg, mask


def _case(n, impl, shape, seed, layout=None):
  """One case's numpy inputs: q, k, v, the key mask, the ids (or None)
  and a cotangent zeroed on padding rows. ``layout``: None (a padded
  tail of 7 on every row), ``('ragged', docs, seed)`` or ``'half-pad'``
  (the second half of every row padding: the last rank's q shard holds
  no real token)."""
  b, h, s, d = shape
  rng = np.random.default_rng(seed)
  q, k, v, g = (rng.standard_normal(shape, dtype=np.float32)
                for _ in range(4))
  seg = None
  if layout is None:
    mask = np.ones((b, s), np.int32)
    mask[:, -7:] = 0
  elif layout == 'half-pad':
    seg, mask = _ragged(b, s, 3, seed + 1, pad_tail=False)
    seg[:, s // 2:] = -1
    mask[:, s // 2:] = 0
  else:
    _, docs, lseed = layout
    seg, mask = _ragged(b, s, docs, lseed)
  g = g * mask[:, None, :, None]
  return {'n': n, 'impl': impl, 'q': q, 'k': k, 'v': v, 'mask': mask,
          'seg': seg, 'g': g}


CASES = {
    'ring1-dense': _case(1, 'dense', (2, 2, 32, 8), 0),
    'ring2-dense': _case(2, 'dense', (2, 2, 32, 8), 1),
    'ring4-dense': _case(4, 'dense', (2, 2, 32, 8), 2),
    'ring1-flash': _case(1, 'flash', (2, 2, 64, 32), 3),
    'ring2-flash': _case(2, 'flash', (2, 2, 64, 32), 4),
    'ring4-flash': _case(4, 'flash', (2, 2, 64, 32), 5),
    'ring4-flash-seg': _case(4, 'flash', (2, 2, 64, 32), 6,
                             ('ragged', 4, 41)),
    'ring2-dense-seg': _case(2, 'dense', (2, 2, 64, 32), 7,
                             ('ragged', 3, 43)),
    'ring2-flash-seg': _case(2, 'flash', (2, 2, 64, 32), 8,
                             ('ragged', 3, 44)),
    'ring4-dense-seg': _case(4, 'dense', (2, 2, 64, 32), 9,
                             ('ragged', 4, 45)),
    'ring1-flash-seg': _case(1, 'flash', (2, 2, 64, 32), 10,
                             ('ragged', 4, 46)),
    'ring2-flash-first-skip': _case(2, 'flash', (2, 2, 64, 32), 11,
                                    'half-pad'),
}


def jax_ring_case(c):
  """lddl_tpu's ring over make_mesh(seq=n): out and (dq, dk, dv)."""
  n = c['n']
  mesh = make_mesh(seq=n, devices=jax.devices()[:n])
  with_seg = c['seg'] is not None
  fn = jax_ring(mesh, q_spec=P(None, None, 'seq', None),
                mask_spec=P(None, 'seq'),
                block_impl='flash' if c['impl'] == 'flash' else 'dense',
                with_segment_ids=with_seg)
  extra = (jnp.asarray(c['seg']),) if with_seg else ()

  @jax.jit
  def run(q, k, v, mask, g, *extra):
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mask, *extra), q, k, v)
    return (out, *vjp(g))

  out, dq, dk, dv = run(*(jnp.asarray(c[x]) for x in ('q', 'k', 'v')),
                        jnp.asarray(c['mask'], bool), jnp.asarray(c['g']),
                        *extra)
  return {'out': np.asarray(out), 'dq': np.asarray(dq),
          'dk': np.asarray(dk), 'dv': np.asarray(dv)}


@pytest.fixture(scope='module')
def ring_run():
  """The port's cases on a world of 4 ranks, JAX's computed meanwhile."""
  cases = list(CASES.values())
  procs, q = ranks.start_world(ranks.ring_shards, 4, args=(cases,))
  try:
    refs = {name: jax_ring_case(c) for name, c in CASES.items()}
  except BaseException:
    for p in procs:
      p.kill()
    raise
  port = ranks.join_world(procs, q)
  got = {}
  for i, (name, c) in enumerate(CASES.items()):
    got[name] = {k: np.concatenate([port[r][i][k] for r in range(c['n'])],
                                   axis=2)
                 for k in ('out', 'dq', 'dk', 'dv')}
  return refs, got


@pytest.mark.parametrize('name', list(CASES))
def test_ring_attention_matches_jax(ring_run, name):
  refs, got = ring_run
  c = CASES[name]
  real = (c['mask'] > 0) if c['seg'] is None else (c['seg'] >= 0)
  rows = real[:, None, :, None]
  for k in ('out', 'dq'):
    np.testing.assert_allclose(got[name][k] * rows, refs[name][k] * rows,
                               rtol=TOL, atol=TOL, err_msg=f'{name} {k}')
  for k in ('dk', 'dv'):
    # Keys on padding get no gradient from a real row in either package.
    np.testing.assert_allclose(got[name][k], refs[name][k], rtol=TOL,
                               atol=TOL, err_msg=f'{name} {k}')
  for k in ('out', 'dq', 'dk', 'dv'):
    assert np.isfinite(got[name][k]).all(), (name, k)


def test_ragged_cases_skip_whole_shards_and_fall_through():
  """The ragged layouts hold both kinds of rotated shard: some disjoint
  from the q shard in every row (the JAX ring skips them whole; the port
  runs their blocks, which the merge weighs 0) and some overlapping; the
  half-padded case's last q shard is disjoint from every shard, its own
  included."""
  def interval(seg):
    # Per row (lo, hi) of the real ids; an all-padding row is empty.
    real = seg >= 0
    return (np.where(real, seg, 2**30).min(axis=1),
            np.where(real, seg, -1).max(axis=1))

  kinds = set()
  for name, c in CASES.items():
    if c['seg'] is None or c['n'] == 1:
      continue
    n = c['n']
    shards = np.split(c['seg'], n, axis=1)
    for r in range(n):
      q_lo, q_hi = interval(shards[r])
      for j in range(n):
        kv_lo, kv_hi = interval(shards[j])
        live = bool(((q_lo <= kv_hi) & (kv_lo <= q_hi)).any())
        kinds.add((name, live, r == j))
  names = {n for n, _, _ in kinds}
  for name in names - {'ring2-flash-first-skip'}:
    assert (name, True, False) in kinds, name
  assert any(not live for _, live, _ in kinds)
  assert ('ring2-flash-first-skip', False, True) in kinds


def test_ring_without_group_is_one_block():
  """group=None is a ring of one: flash blocks equal one flash call
  merged once (l=1 divides out), dense blocks the dense softmax."""
  from lddl_tpu_torch.ops.flash_attention import flash_attention
  c = CASES['ring1-flash']
  q, k, v = (torch.from_numpy(c[x]) for x in ('q', 'k', 'v'))
  mask = torch.from_numpy(c['mask'])
  torch.testing.assert_close(
      ring_attention(q, k, v, mask, block_impl='flash'),
      flash_attention(q, k, v, mask), rtol=1e-6, atol=1e-6)
  with pytest.raises(ValueError, match='together'):
    ring_attention(q, k, v, mask, q_segment_ids=mask)
  with pytest.raises(ValueError, match='block_impl'):
    ring_attention(q, k, v, mask, block_impl='sparse')


class _SeqMesh:
  """The part of a DeviceMesh the port's mesh helpers read: every axis 1
  but ``seq`` (at this rank's index)."""

  mesh_dim_names = MESH_AXES

  def __init__(self, seq, rank):
    self.shape = (1, 1, 1, seq)
    self.rank = rank

  def size(self, dim):
    return self.shape[dim]

  def get_local_rank(self, axis):
    return self.rank if axis == 'seq' else 0

  def get_group(self, axis):
    return None


def test_seq_batch_layout_and_refusals():
  """A seq rank keeps its contiguous 1/seq of every [b, s] array and
  the whole [b] ones; canonical_batch_spec marks dim 1 'seq' as JAX's
  does on a seq mesh; a length seq does not divide raises ValueError
  naming it; make_flash_attention still refuses a seq mesh; the mesh
  wrapper checks the shard's shapes."""
  from lddl_tpu.parallel.mesh import canonical_batch_spec as jax_canonical
  from lddl_tpu_torch.ops.flash_attention import make_flash_attention
  jmesh = make_mesh(seq=2, devices=jax.devices()[:2])
  for shape in ((4, 64), (4,), (4, 63)):
    assert canonical_batch_spec(_SeqMesh(2, 0), shape) == tuple(
        jax_canonical(jmesh, shape)), shape
  batch = {'input_ids': np.arange(24).reshape(2, 12),
           'next_sentence_labels': np.array([0, 1])}
  for r in range(3):
    got = local_batch(batch, _SeqMesh(3, r))
    np.testing.assert_array_equal(got['input_ids'],
                                  batch['input_ids'][:, 4 * r:4 * r + 4])
    np.testing.assert_array_equal(got['next_sentence_labels'], [0, 1])
  assert seq_columns(_SeqMesh(4, 3), 64) == slice(48, 64)
  with pytest.raises(ValueError, match='length 63 does not split over '
                     'seq=2'):
    seq_columns(_SeqMesh(2, 1), 63)
  with pytest.raises(ValueError, match='input_ids: sequence length 10'):
    local_batch({'input_ids': np.zeros((2, 10))}, _SeqMesh(4, 0))
  with pytest.raises(ValueError, match='does not shard the sequence'):
    make_flash_attention(_SeqMesh(2, 0))
  attend = make_ring_attention(_SeqMesh(1, 0), block_impl='dense')
  q = torch.zeros(2, 1, 8, 8)
  with pytest.raises(ValueError, match='mask'):
    attend(q, q, q, torch.ones(2, 7))
  with pytest.raises(TypeError, match='with_segment_ids=False'):
    attend(q, q, q, torch.ones(2, 8), torch.zeros(2, 8))


@pytest.mark.parametrize('flag', [['--sp', '2'],
                                  ['--attention', 'ring_flash', '--sp', '2']])
def test_replay_cli_refuses_seq_and_ring(tmp_path, flag, capsys):
  """One replay process cannot re-execute a step of a seq mesh: in a
  world of one the step replay refuses --sp above 1, ring attention
  included (exit 2), naming the launch it needs, the run's two ranks
  under --comm torch (tests/test_torch_replay_ranks.py launches it so)."""
  from lddl_tpu_torch.replay.cli import main
  assert main(['step', '--checkpoint-dir', str(tmp_path), '--step', '1',
               '--vocab-size', '128', '--device', 'cpu'] + flag) == 2
  err = capsys.readouterr().err
  assert 'WORLD_SIZE=2' in err and '--comm torch' in err
