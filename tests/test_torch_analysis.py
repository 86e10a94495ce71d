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
