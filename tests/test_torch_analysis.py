"""lddl-analyze over the port: every rule, project mode, no finding.

The port has threads (the feed's producer, the async checkpoint writer,
``CUDA_FEED_LOCK``) and file handles (the Parquet reader), so the
concurrency and resource rules (LDA001-LDA018) apply to it as to
``lddl_tpu``; this holds ``lddl_tpu_torch/`` at zero findings, suppressed
ones included.
"""

from pathlib import Path

import pytest

from lddl_tpu.analysis.project import analyze_project


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The port creates no lddl_ shm segment; the shared fixture would count
  # segments of other xdist workers' loader tests as this test's leak.
  yield


ROOT = Path(__file__).resolve().parent.parent


def test_the_port_has_no_findings():
  findings, scanned = analyze_project([str(ROOT / 'lddl_tpu_torch')])
  assert scanned >= 40
  assert [(f.rule_id, f.path, f.line, f.message) for f in findings] == []


def test_the_elastic_path_is_pure():
  """LDA009 over the port: nothing reachable from the elastic executor's
  map (its passes, the pool, the write-back drain), the lease claimer or
  the heartbeat pump issues a collective or waits without a bound. The
  roots and the passes must be in the call graph, so that the zero is
  the analyzer's verdict and not a path it could not follow."""
  from lddl_tpu.analysis.callgraph import CallGraph
  from lddl_tpu.analysis.project import ProjectIndex, discover_py_files
  from lddl_tpu.analysis.rules import ElasticPathPurity
  rule = ElasticPathPurity()
  index = ProjectIndex.build(discover_py_files([str(ROOT / 'lddl_tpu_torch')]))
  graph = CallGraph(index)
  # The rule's own findings, before any pragma could suppress one.
  assert [(f.path, f.line, f.message)
          for f in rule.check(index, graph)] == []
  roots = {index.display(gq): gq for gq in rule._roots(index)}
  assert {'Executor._map_elastic', '_LeaseClaimer.next_claim',
          'HeartbeatPump._run'} <= set(roots)
  reached = {index.display(gq) for gq, _, _ in graph.reachable_effects(
      roots['Executor._map_elastic'], ('wall_clock',))}
  assert {'Executor._map_elastic', 'Executor._elastic_pass_serial',
          'WorkerPool.shutdown'} <= reached
