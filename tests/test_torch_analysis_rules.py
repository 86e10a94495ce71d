"""The port's analyzer against ``lddl_tpu``'s, file by file, on the CPU.

- Every case of ``tests/test_analysis.py`` (the per-file rules LDA001-
  LDA007, LDA012, LDA013, the pragmas, local aliases, the CLI) run against
  ``lddl_tpu_torch.analysis`` by :mod:`torch_analysis_mirror`: its own
  assertions on the port's findings, and every fixture source through
  both analyzers with equal findings, exit codes and documents.
- Every ``.py`` file under ``lddl_tpu/`` through both analyzers' per-file
  rules: equal findings, suppressed ones included.
"""

from pathlib import Path

import pytest

import lddl_tpu.analysis as ref
import lddl_tpu_torch.analysis as port

from torch_analysis_mirror import assert_same_findings, cases, run_case

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The analyzer makes no shm segment; the shared fixture would count other
  # xdist workers' lddl_ segments as this test's leak.
  yield


@pytest.mark.parametrize('case', cases('test_analysis'))
def test_lddl_tpu_case(case, request):
  run_case('test_analysis', case, request)


@pytest.mark.parametrize('path', sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / 'lddl_tpu').rglob('*.py')))
def test_every_lddl_tpu_file(path, monkeypatch):
  monkeypatch.chdir(ROOT)
  assert_same_findings(port.analyze_file(path), ref.analyze_file(path))
