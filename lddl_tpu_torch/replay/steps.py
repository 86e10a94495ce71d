"""Re-execute recorded train steps and bisect loss spikes.

The port's counterpart of :mod:`lddl_tpu.replay.steps`. The ledger's
``step`` boundary fingerprints the full train state (params, the AdamW
moments and count, the dropout key) at every checkpoint. The step
reseeds its dropout generators from ``(dropout_seed, count)`` and the
loaders are coordinate-addressable, so *state at step S* is a pure
function of *(checkpoint at S0 < S, batches S0..S-1)*: any recorded step
can be re-executed bit for bit in a fresh process. Restore the newest
checkpoint at or below ``S - 1``, drive the step through the loop's
:class:`~lddl_tpu_torch.training.pretrain.CompiledStepCache` (one CUDA
graph per bin on the card) over the recorded batch stream (or a
hermetic bundle's batches, no corpus needed), and diff
:func:`~lddl_tpu_torch.training.pretrain.state_fingerprint` against the
recorded line.

Two things make that hold on a CUDA card, where the JAX package's TPU
runs are deterministic by construction:

- Replay runs under deterministic algorithms
  (:func:`~lddl_tpu_torch.training.pretrain.deterministic_algorithms`),
  as :meth:`TrainLoop.run` does whenever the ledger is on, so every
  ``step`` line the loop writes was written in the mode replay runs in.
  A process that cannot run that mode (its CUDA context began without
  ``CUBLAS_WORKSPACE_CONFIG``) is refused, never compared.
- The batches fed after a restore are the ones the recorded run fed,
  decided from the ledger. ``restore`` re-seeks the loader with *resume*
  semantics (a fresh shuffle buffer); the recorded run fed that stream
  only where it was itself resumed at that checkpoint. So the replay
  tries the uninterrupted stream (the loader's byte-exact seek), then
  the run resumed at each checkpoint its ``step`` lines name in the
  epoch, and feeds the one whose first batch has the ``collate`` digest
  that the session which recorded the target step recorded; a ledger
  that none of them matches is refused, never compared. Without a
  ledger the stream is the uninterrupted run's. (The JAX package's
  ``replay_steps`` always feeds the re-seeked loader.)

``bisect`` rides the same machinery: replay a step window, find the
largest per-step loss jump, and name the ``(epoch, index)`` batch
coordinate that fed it — optionally re-scoring that batch per sample
(:func:`~lddl_tpu_torch.parallel.train.pretrain_loss` on singleton
slices, no dropout) to attribute the spike below batch granularity.
With a ledger it feeds the stream the ledger says the run fed, as step
replay does, per-sample scoring included; without one, the
uninterrupted stream, unchecked. (The JAX package's bisect takes no
ledger and feeds the loader ``restore`` re-seeked mid-epoch.)
"""

import torch

from ..core import faults
from ..loader.device import prefetch_to_device
from ..parallel.train import pretrain_loss
from ..telemetry import ledger
from ..telemetry.audit import load_run
from ..telemetry.ledger import fingerprint_batch
from ..training.pretrain import (CompiledStepCache, _step_cache_enabled,
                                 deterministic_algorithms)
from .rematerialize import _check_algo, lookup_digest


def _step_fn(loop):
  """The loop's step as ``run`` calls it: through its step cache when
  ``LDDL_STEP_CACHE`` is on (kept on the loop, as ``run`` keeps it)."""
  if not _step_cache_enabled():
    return loop.step_fn
  if loop.step_cache is None:
    loop.step_cache = CompiledStepCache(loop.step_fn)
  return loop.step_cache


def _global_batch_of(loop, batch):
  if loop.loader is not None:
    per_rank = loop.loader.batch_size
  else:
    arr = next(v for v in batch.values() if hasattr(v, 'shape'))
    per_rank = int(arr.shape[0])
  return per_rank * max(loop.dp_world, 1)


def _stream(loader, epoch, index, origin):
  """The batches a run fed from collate coordinate ``(epoch, index)`` on,
  epoch after epoch, where it resumed epoch ``epoch`` at batch ``origin``
  (None: never resumed in it, the loader's byte-exact stream). The
  stream ends at an epoch that yields no batch."""
  if origin is None:
    loader.seek(epoch, index, exact=True)
    skip = 0
  else:
    loader.seek(epoch, origin)
    skip = index - origin
  while True:
    pulled = 0
    for batch in loader:
      pulled += 1
      if skip:
        skip -= 1
        continue
      yield batch
    if not pulled:
      return


def _fed_collate(run, rank, target_step):
  """``{(epoch, index): digest}`` of the ``collate`` lines recorded
  before ``run``'s first ``step`` line at ``target_step`` on ``rank``,
  the newest per coordinate: the batches of the session that reached
  that step. Also the steps of the ``step`` lines before it (the
  checkpoints a session may have resumed at)."""
  fed, ckpts = {}, []
  for rec in run[rank]['records']:
    if rec['boundary'] == 'step':
      if rec.get('step') == target_step:
        break
      ckpts.append(rec['step'])
    elif rec['boundary'] == 'collate' and 'index' in rec:
      fed[(rec['epoch'], rec['index'])] = rec['digest']
  return fed, ckpts


def _recorded(run, rank, target_step, algo):
  """``recorded_stream``'s ``recorded`` from a loaded ledger: the fed
  batches and checkpoints of ``rank``'s session that reached
  ``target_step`` (:func:`_fed_collate`), and the ledger's algorithm."""
  if rank not in run:
    raise LookupError(f'the ledger holds no rank {rank} (ranks '
                      f'{sorted(run)})')
  return (*_fed_collate(run, rank, target_step), algo)


def _feeds(loader, epoch, index, origin, want, algo):
  """Whether the stream ``_stream(loader, epoch, index, origin)`` starts
  with batches of the digests ``want`` (stops at the first that
  differs)."""
  stream = _stream(loader, epoch, index, origin)
  try:
    for digest in want:
      batch = next(stream, None)
      if batch is None or fingerprint_batch(batch, algo) != digest:
        return False
    return True
  finally:
    stream.close()


def recorded_stream(loader, recorded=None, ordinals=()):
  """The batches the recorded run fed from ``loader``'s current position
  on (where :meth:`~lddl_tpu_torch.training.pretrain.TrainLoop.restore`
  put it), epoch after epoch.

  ``recorded`` is ``(fed, checkpoints, algo)`` from the ledger
  (:func:`_fed_collate`), and ``ordinals`` the batch ordinals the replay
  will feed. The candidates are the uninterrupted stream, then the run
  resumed at each recorded checkpoint in this epoch, newest first; the
  first whose batches at ``ordinals`` all have the recorded digests is
  fed (a first batch alone can agree where later ones do not: a bin
  whose draws the resume did not touch), and none is ``ValueError``.
  Without ``recorded`` the uninterrupted stream is fed. A loader without
  the ``tell``/``seek`` contract is iterated as it is.
  """
  if getattr(loader, 'tell', None) is None:
    yield from loader
    return
  epoch, index = loader.tell()
  origin = None
  if recorded is not None:
    fed, checkpoints, algo = recorded
    want = []
    for coord in map(loader.coordinate_of_batch, ordinals):
      if coord not in fed:
        raise ValueError(
            f'the ledger records no collate line at (epoch={coord[0]}, '
            f'index={coord[1]}) before the target step; cannot tell which '
            'batches the run fed')
      want.append(fed[coord])
    resumes = sorted({i for e, i in map(loader.coordinate_of_batch,
                                        checkpoints)
                      if e == epoch and 0 < i <= index}, reverse=True)
    for origin in [None] + resumes:
      if _feeds(loader, epoch, index, origin, want, algo):
        break
    else:
      raise ValueError(
          f'no stream of this loader feeds the recorded batches from '
          f'(epoch={epoch}, index={index}) on (tried the uninterrupted run '
          f'and resumes at {resumes}); the loader spec is not the recorded '
          'run\'s')
  yield from _stream(loader, epoch, index, origin)


def replay_steps(loop, target_step, batches=None, prefetch=2,
                 recorded=None):
  """Advance ``loop`` from its current (restored) step to ``target_step``.

  Mirrors the live loop's step execution — the same device feed
  (:func:`~lddl_tpu_torch.loader.device.prefetch_to_device`), the same
  step cache, the dropout key passed through unchanged (the step folds
  in the optimizer count itself) — under deterministic algorithms, so
  the resulting state is bit-identical to the recorded run's.
  ``batches`` (host batches, e.g. from bundles) overrides the loop's
  loader; they must cover ``target_step - loop.step`` steps. Otherwise
  the loader feeds :func:`recorded_stream` (``recorded``: the ledger's
  account of the fed batches). Returns
  ``[(step, loss), ...]`` keyed like the ledger (the loss of *reaching*
  step S).
  """
  if loop.step >= target_step:
    raise ValueError(
        f'loop is at step {loop.step}, at/past target {target_step}; '
        'restore an older checkpoint first')
  if batches is not None and len(batches) < target_step - loop.step:
    raise ValueError(
        f'{len(batches)} bundled batch(es) cannot cover steps '
        f'{loop.step + 1}..{target_step}')
  if batches is None and loop.loader is None:
    raise ValueError(
        'loop has no loader (built with path=None); step replay needs '
        'bundled batches')
  with deterministic_algorithms(loop.device):
    step_fn = _step_fn(loop)
    source = (iter(batches) if batches is not None
              else recorded_stream(loop.loader, recorded,
                                   range(loop.step, target_step)))
    stream = prefetch_to_device(source, loop.device, size=prefetch)
    loop.model.train()
    losses = []
    try:
      while loop.step < target_step:
        try:
          batch = next(stream)
        except StopIteration:
          raise ValueError(
              f'batch stream ended at step {loop.step} before target '
              f'{target_step}') from None
        faults.inject('replay.step', rank=loop.dp_rank, gi=loop.step)
        metrics = step_fn(batch, loop.dropout_seed)
        loss = float(metrics['loss'])
        loop.step += 1
        loop.samples_seen += _global_batch_of(loop, batch)
        loop._last_loss = loss
        losses.append((loop.step, loss))
    finally:
      stream.close()
  return losses


def replay_step_coordinate(loop, ckpt_dir, target_step, ledger_path=None,
                           batches=None, prefetch=2, rank=None):
  """Rematerialize train state at ``step=target_step`` and (optionally)
  verify it against a ledger's recorded ``step`` fingerprint.

  Restores the newest checkpoint at or below ``target_step - 1`` from
  ``ckpt_dir``, replays forward, and fingerprints the resulting state.
  With ``ledger_path`` the result carries ``recorded``/``match`` — the
  acceptance check that a replayed step reproduces the recorded
  fingerprint bit for bit, in the ledger's algorithm. The ledger is read
  first, so a coordinate it never recorded, or one hashed with an
  algorithm this process lacks, is refused before any step runs; from
  the corpus, it also decides which batches are fed
  (:func:`recorded_stream`).
  """
  target_step = int(target_step)
  recorded = fed = None
  algo = ledger.ALGO
  if ledger_path is not None:
    run = load_run(ledger_path, rank=rank)
    algo = _check_algo(run)
    recorded, hits = lookup_digest(run, (('step', target_step),),
                                   boundary='step')
    fed = _recorded(run, hits[0][0] if rank is None else rank, target_step,
                    algo)
  meta = type(loop).latest_meta(ckpt_dir, max_step=target_step - 1)
  if meta is None:
    raise FileNotFoundError(
        f'no checkpoint at or below step {target_step - 1} under '
        f'{ckpt_dir}')
  loop.restore(ckpt_dir, step=meta[0])
  losses = replay_steps(loop, target_step, batches=batches,
                        prefetch=prefetch, recorded=fed)
  digest = loop.state_digest(algo)
  out = {'step': target_step, 'restored_step': meta[0], 'digest': digest,
         'losses': losses, 'algo': algo}
  if recorded is not None:
    out['recorded'] = recorded
    out['match'] = digest == recorded
  return out


def bisect_window(loop, ckpt_dir, lo, hi, prefetch=2, per_sample=False,
                  ledger_path=None):
  """Walk steps ``(lo, hi]`` and attribute the largest loss jump.

  Restores the newest checkpoint at or below ``lo``, replays through
  ``hi`` collecting per-step losses, and reports the step with the
  largest positive loss delta plus the ``(epoch, index)`` collate
  coordinate of the batch that fed it (step ``S`` consumes this rank's
  batch ordinal ``S - 1`` — one batch per rank per global step).
  ``per_sample=True`` additionally re-restores at the spike step's
  predecessor and scores the spike batch row by row with the pre-spike
  params, naming the sample index that contributed most.

  ``ledger_path``: the run's ledger (the loop's data rank's file). The
  replay and the per-sample batch then come from the stream the ledger
  says the run fed (:func:`recorded_stream`: the uninterrupted one, or
  the run resumed at a recorded checkpoint), every fed batch checked
  against the ``collate`` digests of the session that reached ``hi``;
  none matching is ``ValueError``. Without it the uninterrupted stream
  is fed, unchecked: wrong for a run that resumed mid-epoch inside the
  window's epoch.
  """
  lo, hi = int(lo), int(hi)
  if hi <= lo:
    raise ValueError(f'empty bisect window ({lo}, {hi}]')
  recorded = None
  if ledger_path is not None:
    run = load_run(ledger_path, rank=loop.dp_rank)
    recorded = _recorded(run, loop.dp_rank, hi, _check_algo(run))
  meta = type(loop).latest_meta(ckpt_dir, max_step=lo)
  if meta is None:
    raise FileNotFoundError(
        f'no checkpoint at or below step {lo} under {ckpt_dir}')
  loop.restore(ckpt_dir, step=meta[0])
  losses = replay_steps(loop, hi, prefetch=prefetch, recorded=recorded)
  by_step = dict(losses)
  deltas = [(by_step[s] - by_step[s - 1], s)
            for s in range(max(lo, meta[0] + 1) + 1, hi + 1)
            if s in by_step and s - 1 in by_step]
  if not deltas:
    raise ValueError(
        f'window ({lo}, {hi}] left no consecutive step pair to compare '
        f'(restored at {meta[0]})')
  delta, spike = max(deltas)
  out = {'window': [lo, hi], 'restored_step': meta[0],
         'losses': losses, 'spike_step': spike,
         'spike_loss': by_step[spike], 'delta': delta,
         'stream_checked': recorded is not None}
  if loop.loader is not None:
    epoch, index = loop.loader.coordinate_of_batch(spike - 1)
    out['batch_coordinate'] = {'epoch': epoch, 'index': index}
    if per_sample:
      out['per_sample'] = _per_sample_losses(loop, ckpt_dir, spike,
                                             recorded)
      out['spike_sample'] = max(
          range(len(out['per_sample'])), key=out['per_sample'].__getitem__)
  return out


def _per_sample_losses(loop, ckpt_dir, spike_step, recorded=None):
  """Loss of each row of the batch feeding ``spike_step``, scored with
  the params the spike step started from (leaves ``loop`` positioned at
  ``spike_step - 1``) and no dropout. The batch is the one
  :func:`recorded_stream` feeds at that ordinal from the newest
  checkpoint below the spike (``recorded``: the ledger's account, as
  the bisect's replay used; None: the uninterrupted stream). The JAX
  package re-seeks mid-epoch here, which gives a resumed batch. Single
  process only."""
  meta = type(loop).latest_meta(ckpt_dir, max_step=spike_step - 1)
  loop.restore(ckpt_dir, step=meta[0])
  stream = recorded_stream(loop.loader, recorded,
                           range(meta[0], spike_step))
  try:
    for _ in range(spike_step - 1 - meta[0]):
      next(stream)
    batch = next(stream)
  finally:
    stream.close()
  if not isinstance(batch, dict):
    raise ValueError('per-sample attribution supports dict batches only '
                     '(micro-batch loaders yield lists)')
  loop.restore(ckpt_dir, step=meta[0])
  if loop.step < spike_step - 1:
    replay_steps(loop, spike_step - 1, recorded=recorded)
  rows = batch['input_ids'].shape[0]
  out = []
  loop.model.eval()
  with torch.no_grad():
    for i in range(rows):
      one = {k: torch.from_numpy(v[i:i + 1]).to(loop.device)
             for k, v in batch.items()
             if hasattr(v, 'shape') and v.shape and v.shape[0] == rows}
      loss, _ = pretrain_loss(loop.model, one,
                              max_predictions=loop.max_predictions)
      out.append(float(loss))
  loop.model.train()
  return out
