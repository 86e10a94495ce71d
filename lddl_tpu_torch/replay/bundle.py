"""Hermetic repro bundles: a recorded batch, portable without the corpus.

A copy of :mod:`lddl_tpu.replay.bundle` over the port's
:func:`~lddl_tpu_torch.loader.service.pack_batch` (numpy and the stdlib).
The format is the JAX package's, file for file, so either package reads
the other's bundles. A bundle is a directory of two files:

- ``bundle.json`` — manifest: format version, digest algorithm, the
  ledger coordinate, the recorded fingerprint, the packed-batch spec
  (the shm/wire spec of :mod:`lddl_tpu_torch.loader.shm`, JSON-encoded),
  the RNG/Philox inputs that parameterized collate (base seed, dp rank,
  epoch, step), an optional checkpoint ref (directory + step) for step
  replay, and the ledger excerpt (the raw recorded lines) it was cut
  from;
- ``batch.bin`` — the packed batch payload, byte-identical to what a
  shm slot or a service frame carries.

``read_bundle`` re-fingerprints the payload against the manifest before
handing the batch out, so a bundle damaged in storage or transit is
rejected with the mismatch named at its exact coordinate. The
``replay.read`` fault site drills exactly this.
"""

import json
import os

from ..core import faults
from ..loader.service import pack_batch, unpack_batch
from ..telemetry import ledger
from ..telemetry.ledger import fingerprint_packed
from .rematerialize import ReplayMismatch, format_coordinate

#: Bump on any incompatible manifest/payload layout change; readers
#: refuse newer-versioned bundles instead of misparsing them.
BUNDLE_VERSION = 1

_MANIFEST = 'bundle.json'
_PAYLOAD = 'batch.bin'


def _spec_to_json(spec):
  """Packed-batch spec -> JSON-able form (tuples become lists; 'py'
  leaves must be JSON-encodable or the bundle write fails loudly)."""
  kind = spec[0]
  if kind == 'nd':
    return ['nd', spec[1], list(spec[2]), spec[3]]
  if kind == 'map':
    return ['map', [[k, _spec_to_json(s)] for k, s in spec[1]]]
  if kind == 'seq':
    return ['seq', bool(spec[1]), [_spec_to_json(s) for s in spec[2]]]
  if kind == 'py':
    return ['py', spec[1]]
  raise ValueError(f'unknown spec node kind {kind!r}')


def _spec_from_json(node):
  kind = node[0]
  if kind == 'nd':
    return ('nd', node[1], tuple(node[2]), node[3])
  if kind == 'map':
    return ('map', [(k, _spec_from_json(s)) for k, s in node[1]])
  if kind == 'seq':
    return ('seq', bool(node[1]), [_spec_from_json(s) for s in node[2]])
  if kind == 'py':
    return ('py', node[1])
  raise ValueError(f'unknown spec node kind {kind!r}')


def write_bundle(out_dir, batch, coordinate, *, digest=None, philox=None,
                 checkpoint=None, ledger_excerpt=None, algo=None):
  """Pack ``batch`` into a bundle directory at ``out_dir`` (created).

  ``coordinate`` is the ledger key dict (e.g. ``{'epoch': 0,
  'index': 3}``). ``digest`` defaults to the payload's own fingerprint
  — pass the *recorded* ledger digest when bundling a verified replay
  so the bundle carries the run's ground truth, not a re-derivation,
  and with it ``algo``, the algorithm the digest is in (default this
  process's). Returns the bundle directory path.
  """
  algo = algo or ledger.ALGO
  spec, payload = pack_batch(batch)
  manifest = {
      'version': BUNDLE_VERSION,
      'algo': algo,
      'coordinate': dict(coordinate),
      'digest': digest or fingerprint_packed(spec, payload, algo),
      'spec': _spec_to_json(spec),
      'payload_bytes': len(payload),
      'philox': dict(philox) if philox else None,
      'checkpoint': dict(checkpoint) if checkpoint else None,
      'ledger_excerpt': list(ledger_excerpt or ()),
  }
  os.makedirs(out_dir, exist_ok=True)
  with open(os.path.join(out_dir, _PAYLOAD), 'wb') as f:
    f.write(payload)
  with open(os.path.join(out_dir, _MANIFEST), 'w') as f:
    json.dump(manifest, f, indent=2, default=str)
    f.write('\n')
  return out_dir


def read_bundle(bundle_dir, verify=True):
  """Load a bundle -> ``(manifest, batch)``.

  ``verify=True`` (default, and what every CLI path uses)
  re-fingerprints the payload and raises :class:`ReplayMismatch` naming
  the exact coordinate when it no longer matches the manifest, in the
  algorithm the manifest names. A manifest hashed with an algorithm this
  host cannot compute refuses to verify rather than comparing apples to
  oranges.
  """
  path = os.path.join(bundle_dir, _MANIFEST)
  if not os.path.isfile(path):
    raise FileNotFoundError(f'not a bundle (no {_MANIFEST}): {bundle_dir}')
  with open(path) as f:
    manifest = json.load(f)
  if manifest.get('version', 0) > BUNDLE_VERSION:
    raise ValueError(
        f'bundle {bundle_dir} has version {manifest["version"]}; this '
        f'reader understands <= {BUNDLE_VERSION}')
  coord = manifest.get('coordinate') or {}
  with open(os.path.join(bundle_dir, _PAYLOAD), 'rb') as f:
    payload = bytearray(f.read())
  # The storage-corruption drill: flip a payload byte after the read,
  # before verification — a damaged bundle must be *rejected*, never
  # silently replayed.
  faults.corrupt_bytes('replay.read', payload, **coord)
  faults.inject('replay.read', **coord)
  spec = _spec_from_json(manifest['spec'])
  if verify:
    algo = manifest.get('algo') or ledger.ALGO
    if not ledger.algo_available(algo):
      raise ValueError(
          f'bundle hashed with {algo}, which this process cannot compute; '
          'cannot verify')
    actual = fingerprint_packed(spec, payload, algo)
    if actual != manifest['digest']:
      raise ReplayMismatch(
          f'bundle payload rejected at ({format_coordinate(coord)}): '
          f'recorded {manifest["digest"]}, got {actual} — the bundle '
          'is corrupt')
  return manifest, unpack_batch(spec, payload)
