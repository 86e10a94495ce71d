"""Deterministic time-travel: the determinism ledger made executable.

The port of :mod:`lddl_tpu.replay`. The ledger records a fingerprint
lineage (collate → device → step) at every pipeline boundary; this
package rematerializes any recorded coordinate on demand:

- :mod:`.rematerialize` — drive a loader's epoch from its start to
  rebuild exactly the batch a ledger line fingerprinted, and verify the
  reconstruction against the recorded digest;
- :mod:`.bundle` — hermetic repro bundles (packed batch bytes, Philox
  inputs, checkpoint ref, ledger excerpt) that replay on a machine that
  has never seen the corpus; the JAX package's format;
- :mod:`.steps` — re-execute a recorded train step (checkpoint restore
  at or below ``S - 1``, then the steps through the loop's
  :class:`~lddl_tpu_torch.training.pretrain.CompiledStepCache` under
  deterministic algorithms) and diff the state fingerprint against the
  ledger's ``step`` record; ``bisect`` attributes a loss spike to the
  batch (and the sample) that moved it;
- :mod:`.cli` — ``python -m lddl_tpu_torch.replay.cli`` (the JAX
  package's ``lddl-replay``); a sharded run's steps are replayed by
  launching it as the run's ranks (``--comm torch``).

The exports are the JAX package's; :mod:`.steps` (which imports the train
loop) loads on its own.
"""

from .bundle import BUNDLE_VERSION, read_bundle, write_bundle
from .rematerialize import (ReplayMismatch, format_coordinate,
                            lookup_digest, rematerialize_batch,
                            replay_coordinate, replay_smoke)

__all__ = [
    'BUNDLE_VERSION',
    'ReplayMismatch',
    'format_coordinate',
    'lookup_digest',
    'read_bundle',
    'rematerialize_batch',
    'replay_coordinate',
    'replay_smoke',
    'write_bundle',
]
