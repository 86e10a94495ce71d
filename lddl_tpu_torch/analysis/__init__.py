"""Static analysis for the port's SPMD determinism and resource-safety
invariants (``python -m lddl_tpu_torch.cli lddl_analyze``).

The port's copy of :mod:`lddl_tpu.analysis`. It imports the standard
library only (no torch: it is a host linter, like
:mod:`~lddl_tpu_torch.ops.masking_host`) and nothing of :mod:`lddl_tpu`.
Every rule keeps the reference's id, name, invariant and message text, and
on a source that uses none of torch's spellings below the two analyzers
give the same findings.

The correctness story of this codebase rests on properties no runtime
test can fully cover: every rank derives the identical sample plan
without communication, all randomness flows through seeded helpers,
collectives are issued uniformly — even through call chains — the
elastic path never blocks on a peer, and compiled or captured code never
syncs the host. This package turns those conventions into an AST-based
check that runs in tier-1 (``tests/test_torch_analysis_self.py``), so
refactors cannot silently erode them.

**torch's spellings beside JAX's, per effect.** The reference knows the
repo's comm vocabulary and JAX's; the port keeps every reference spelling
and adds torch's counterpart for the same effect. No rule is added and no
invariant changes.

* collective (LDA005/LDA008/LDA009/LDA011). The reference knows
  ``allreduce``, ``allgather``, ``broadcast``, ``barrier``,
  ``reduce_scatter``, ``all_to_all``, ``sync_global_devices``,
  ``process_allgather``, ... The port adds ``all_reduce``,
  ``all_gather``, ``all_gather_object``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``broadcast_object_list``,
  ``batch_isend_irecv``, ``monitored_barrier``, ``all_to_all_single``;
  not ``gather`` and ``scatter``, which are tensor methods too (attribute
  calls match by method name).
* compiled-code root (LDA010). The reference knows defs decorated
  ``jit``/``shard_map``/``pallas_call`` and argument 0 of those and of
  ``CompiledStepCache``. The port adds ``capture_step``'s ``body`` (the
  third positional argument or ``body=``; not ``warm_up``, which runs
  eagerly and may sync), a lambda body resolving to the call it makes;
  ``torch.compile`` (decorator or wrapper) and
  ``torch.cuda.make_graphed_callables``.
* host sync (LDA010). The reference knows ``.item()``,
  ``float()``/``bool()`` of a non-constant, ``numpy.asarray``,
  ``jax.device_get``, ``.block_until_ready()``. The port adds
  zero-argument ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``.synchronize()``, and ``torch.cuda.synchronize()``.
* global RNG (LDA002). The reference knows ``random.*`` and
  ``np.random.*`` module draws. The port adds ``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``bernoulli``, ``multinomial``, ``normal``,
  ``poisson`` and the ``*_like`` forms, each without ``generator=``;
  ``torch.manual_seed``, ``torch.seed``, ``torch.cuda.manual_seed`` and
  ``manual_seed_all``. The same files are exempt.

The call graph also follows ``Cls.apply(...)`` of a project subclass of
``torch.autograd.Function`` into ``Cls.forward`` (the ring attention's
K/V rotation).

Two departures keep the port steady: the per-file pool starts its
workers from the ``forkserver``
(:func:`~lddl_tpu_torch.loader.workers.worker_context`), never by a fork
of a parent that may hold threads; and the cache's keys carry the port's
own namespace and schema, so a directory both analyzers share never
serves one package's pickles to the other.

Layout:
  - :mod:`.engine`: parse + single ancestor-tracking walk, import/local
    alias resolution, per-module facts export, pragma suppression, the
    (parallel) per-file driver;
  - :mod:`.project`: whole-program index — import/method resolution
    across modules, ``ProjectRule`` base, ``analyze_project``;
  - :mod:`.callgraph`: deterministic call graph, transitive effect
    sets, call-chain traces;
  - :mod:`.concurrency`: thread graph (spawn edges), shared-state
    access sets, lockset inference, and the LDA014–LDA018 concurrency
    rules;
  - :mod:`.cache`: content-hash incremental cache for findings and
    per-module facts (``LDDL_ANALYZE_CACHE``);
  - :mod:`.rules`: the per-file LDA001–LDA007 and interprocedural
    LDA008–LDA011 rulesets;
  - :mod:`.findings`: the finding model (file:line, rule id, fix hint,
    call chain);
  - :mod:`.pragmas`: inline ``# lddl: noqa[LDAxxx]`` suppressions;
  - :mod:`.sarif`: SARIF 2.1.0 rendering for CI annotation;
  - :mod:`.cli`: the ``lddl-analyze`` command.
"""

import os

from .cache import AnalysisCache, cache_from_env
from .concurrency import CONCURRENCY_RULE_IDS
from .engine import (
    Rule,
    analyze_file,
    analyze_paths,
    analyze_source,
)
from .findings import Finding
from .project import ProjectRule, analyze_project
from .rules import all_rules, default_rules, project_rules, rules_by_id

# Schema of the lint status dict / --format json document. v3 adds the
# labeled multi-chain traces (``chains``) the concurrency rules emit.
LINT_SCHEMA_VERSION = 3


def analyze_package(rules=None, jobs=None, cache=None):
  """Run the analyzer — project mode, full call graph — over the
  installed ``lddl_tpu_torch`` tree itself.

  Returns ``(unsuppressed, suppressed)`` finding lists — the self-check
  test and the ``lddl-perf --gate`` concurrency leg go through here.
  """
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  findings, _ = analyze_project([root], rules=rules, jobs=jobs,
                                cache=cache)
  return ([f for f in findings if not f.suppressed],
          [f for f in findings if f.suppressed])


__all__ = [
    'AnalysisCache',
    'CONCURRENCY_RULE_IDS',
    'Finding',
    'LINT_SCHEMA_VERSION',
    'ProjectRule',
    'Rule',
    'all_rules',
    'cache_from_env',
    'analyze_file',
    'analyze_package',
    'analyze_paths',
    'analyze_project',
    'analyze_source',
    'default_rules',
    'project_rules',
    'rules_by_id',
]
