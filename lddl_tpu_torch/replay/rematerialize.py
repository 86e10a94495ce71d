"""Rebuild a recorded batch by replaying the deterministic draw sequence.

A copy of :mod:`lddl_tpu.replay.rematerialize` over the port's loaders
(numpy and the stdlib; torch is never imported here). Every batch
coordinate the ledger records — a ``(epoch, index)`` collate key or an
``(epoch, gi)`` serve frame — names a position in a loader's
deterministic stream: same shards, same seed, same draw sequence.
Rematerialization is *build the loader the run used, replay its epoch's
draw sequence to the coordinate, take that batch* — then prove the
reconstruction by fingerprinting it with the ledger's own digest
arithmetic and comparing against the recorded line, in the algorithm
the ledger's meta line names. (The loaders' ``seek(..., exact=True)``
replays the epoch's draws from its start; a plain mid-epoch seek is the
*resume* contract, whose shuffle buffer restarts fresh and is
deliberately not byte-identical.)

Serve frames replay through the same path: the data service's global
index ``gi`` is the serial step of the server's loader for the epoch,
so replaying to step ``gi`` on a loader built from the server's spec
reproduces the frame that crossed the wire.

Factory specs are ``(module, attr)`` pairs, as the worker and service
layers take them: ``('lddl_tpu_torch.loader.bert',
'get_bert_pretrain_data_loader')``, ``('lddl_tpu_torch.testing',
'get_synthetic_batch_loader')``. A ledger written by either package
replays here: the batch fingerprints are one format.
"""

import random

from ..telemetry import ledger
from ..telemetry.audit import load_run, lookup_records, run_algo
from ..telemetry.ledger import fingerprint_batch, record_key


class ReplayMismatch(ValueError):
  """A reconstructed artifact's fingerprint differs from the recorded
  one — raised with the exact coordinate in the message."""


def format_coordinate(coord):
  """``{'epoch': 0, 'index': 3}`` -> ``'epoch=0, index=3'`` (the
  rendered-key grammar of the auditor)."""
  return ', '.join(f'{f}={v}' for f, v in dict(coord).items())


def _check_algo(run):
  """The algorithm ``run``'s meta lines name (this process's own when
  none survived), which every digest compared with it is computed in;
  refused with ``ValueError`` when this process cannot compute it (an
  xxh64 ledger on a host without the xxhash wheel)."""
  algo = run_algo(run) or ledger.ALGO
  if not ledger.algo_available(algo):
    raise ValueError(
        f'ledger was hashed with {algo}, which this process cannot '
        'compute; reconstruction cannot be verified here')
  return algo


def lookup_digest(run, key, boundary=None):
  """The single digest recorded at ``key`` in ``run`` (a
  :func:`~lddl_tpu_torch.telemetry.audit.load_run` dict). Raises
  :class:`LookupError` when the coordinate was never recorded and
  :class:`ReplayMismatch` when the run recorded *conflicting* digests
  for it (the coordinate is not trustworthy enough to replay against).
  Returns ``(digest, [(rank, record), ...])``."""
  hits = lookup_records(run, key, boundary=boundary)
  if not hits:
    where = f' at boundary {boundary}' if boundary else ''
    raise LookupError(
        f'no ledger record at ({format_coordinate(key)}){where}')
  digests = sorted({rec['digest'] for _, rec in hits})
  if len(digests) > 1:
    raise ReplayMismatch(
        f'ledger records conflicting digests at '
        f'({format_coordinate(key)}): {digests} — audit the run first')
  return digests[0], hits


def corpus_shard_format(build_kwargs):
  """``(shard_format, duplicate_factor)`` of the corpus a loader spec
  points at, or ``None`` when the spec has no shard directory (synthetic
  factories)."""
  path = dict(build_kwargs).get('path')
  if path is None:
    return None
  try:
    from ..core.utils import get_all_parquets_under
    from ..pipeline.shard_format import scan_shard_format
    return scan_shard_format(get_all_parquets_under(path))
  except (OSError, ValueError):
    return None


def rematerialize_batch(factory, build_kwargs, epoch, index):
  """Build the loader ``factory(**build_kwargs)`` names, drive its
  epoch-``epoch`` draw sequence from batch 0, and return the batch at
  collate coordinate ``(epoch, index)``.

  The loader's byte-exact seek (``seek(epoch, index, exact=True)``)
  drives the draws from the epoch's start and collates nothing before
  ``index``; a plain mid-epoch ``seek`` has resume semantics (a fresh
  shuffle buffer) and would give another batch.
  """
  from ..loader.workers import _resolve_factory
  loader = _resolve_factory(tuple(factory))(**build_kwargs)
  loader.seek(int(epoch), int(index), exact=True)
  for _, batch in loader.iter_steps():
    return batch
  raise LookupError(
      f'loader produced no batch at epoch={epoch}, index={index} '
      '(dataset shorter than the recorded run?)')


#: Boundaries whose coordinates name a batch position this module can
#: rematerialize. ``serve.*`` keys are ``(epoch, gi)`` and gi is the
#: serial step; ``collate`` keys are ``(epoch, index)`` directly.
REPLAYABLE_BOUNDARIES = ('collate', 'serve.tx', 'serve.rx')


def _batch_position(key):
  """Map a lineage key tuple to the ``(epoch, batch_index)`` target, or
  None for boundaries with no batch position (shard paths, device
  frames, train steps)."""
  d = dict(key)
  if 'epoch' in d and 'index' in d:
    return d['epoch'], d['index']
  if 'epoch' in d and 'gi' in d:
    return d['epoch'], d['gi']
  return None


def replay_coordinate(ledger_path, key, factory, build_kwargs,
                      boundary=None, rank=None):
  """Rematerialize the batch at ``key`` and verify it against the
  ledger at ``ledger_path``.

  Returns a result dict (coordinate, boundary, recorded / reconstructed
  digests, match verdict, algo, the batch). Raises :class:`LookupError`
  for an unrecorded coordinate and :class:`ValueError` for an algorithm
  the host cannot reproduce or a coordinate with no batch position; a
  mismatch is a verdict (``result['match']``), not an exception.
  """
  run = load_run(ledger_path, rank=rank)
  algo = _check_algo(run)
  digest, hits = lookup_digest(run, tuple(key), boundary=boundary)
  pos = _batch_position(tuple(key))
  if pos is None:
    raise ValueError(
        f'coordinate ({format_coordinate(key)}) has no batch position; '
        "replay batch coordinates are (epoch, index) or (epoch, gi) — "
        "use 'replay step' for step coordinates")
  batch = rematerialize_batch(factory, build_kwargs, *pos)
  actual = fingerprint_batch(batch, algo)
  fmt = corpus_shard_format(build_kwargs)
  return {
      'coordinate': dict(tuple(key)),
      'boundary': boundary or hits[0][1]['boundary'],
      'recorded': digest,
      'reconstructed': actual,
      'match': actual == digest,
      'algo': algo,
      'shard_format': fmt[0] if fmt else None,
      'batch': batch,
  }


def replay_smoke(ledger_path, factory, build_kwargs, seed=0, rank=None):
  """One random recorded coordinate per boundary, replayed and verified.

  Batch-position boundaries (:data:`REPLAYABLE_BOUNDARIES`) are
  rematerialized through :func:`rematerialize_batch`; boundaries with
  no batch position (``shard``/``device``/``step``) are reported
  ``skipped``. Returns ``(results, rc)`` where ``rc`` is 0 when every
  replayed coordinate matched (skips don't fail) and 1 on any mismatch.
  Deterministic under ``seed``.
  """
  run = load_run(ledger_path, rank=rank)
  algo = _check_algo(run)
  rnd = random.Random(seed)
  by_boundary = {}
  for r in sorted(run):
    for rec in run[r]['records']:
      k = record_key(rec)
      if k is not None:
        by_boundary.setdefault(rec['boundary'], {})[(r, k)] = rec
  results, rc = {}, 0
  for bd in sorted(by_boundary):
    table = by_boundary[bd]
    if bd not in REPLAYABLE_BOUNDARIES:
      results[bd] = {'status': 'skipped',
                     'reason': 'no batch position (needs shards or a '
                               'checkpoint, not a loader spec)'}
      continue
    rec_rank, key = rnd.choice(sorted(table))
    pos = _batch_position(key)
    if pos is None:
      results[bd] = {'status': 'skipped', 'reason': 'incomplete key'}
      continue
    # Collate records are per-dp-rank streams: rebuild *that* rank's
    # loader. Serve frames come off the server's single loader, so the
    # spec is used as-is.
    kwargs = dict(build_kwargs)
    if bd == 'collate':
      kwargs.setdefault('dp_rank', rec_rank)
    try:
      batch = rematerialize_batch(factory, kwargs, *pos)
    except Exception as e:  # an unreplayable spec is a failed smoke
      results[bd] = {'status': 'error', 'coordinate': dict(key),
                     'error': f'{type(e).__name__}: {e}'}
      rc = 1
      continue
    actual = fingerprint_batch(batch, algo)
    recorded = table[(rec_rank, key)]['digest']
    ok = actual == recorded
    fmt = corpus_shard_format(kwargs)
    results[bd] = {'status': 'ok' if ok else 'mismatch',
                   'coordinate': dict(key), 'rank': rec_rank,
                   'recorded': recorded, 'reconstructed': actual,
                   'shard_format': fmt[0] if fmt else None}
    if not ok:
      rc = 1
  return results, rc
