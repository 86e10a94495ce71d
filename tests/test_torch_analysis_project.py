"""The port's analyzer in project mode against ``lddl_tpu``'s, on the CPU.

- Every case of ``tests/test_analysis_project.py`` (LDA008-LDA011, call
  chains, SARIF code flows, the parallel driver's byte identity) and of
  ``tests/test_analysis_concurrency.py`` (LDA014-LDA018, the cache's
  cold/warm identity, ``--jobs``) run against ``lddl_tpu_torch.analysis``
  by :mod:`torch_analysis_mirror`: each case's own assertions on the
  port, and every fixture tree through both analyzers with equal
  findings, exit codes and documents. The port's per-file pass runs in
  forkserver workers where a case gives it 8 files or more.
- The whole ``lddl_tpu/`` tree in project mode: both analyzers give the
  same findings, none unsuppressed and the 11 suppressed that
  ``tests/test_analysis_self.py`` pins; both CLIs print the same
  ``--format json`` and SARIF documents over it.
"""

import json
from pathlib import Path

import pytest

import lddl_tpu.analysis as ref
import lddl_tpu_torch.analysis as port

from torch_analysis_mirror import (as_reference_text, assert_same_findings,
                                   cases, run_both_clis, run_case)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The analyzer makes no shm segment; the shared fixture would count other
  # xdist workers' lddl_ segments as this test's leak.
  yield


@pytest.mark.parametrize('case', cases('test_analysis_project'))
def test_lddl_tpu_project_case(case, request):
  run_case('test_analysis_project', case, request)


@pytest.mark.parametrize('case', cases('test_analysis_concurrency'))
def test_lddl_tpu_concurrency_case(case, request):
  run_case('test_analysis_concurrency', case, request)


def test_the_lddl_tpu_tree_in_project_mode(monkeypatch):
  monkeypatch.delenv('LDDL_ANALYZE_CACHE', raising=False)
  got, scanned = port.analyze_project([str(ROOT / 'lddl_tpu')])
  want, want_scanned = ref.analyze_project([str(ROOT / 'lddl_tpu')], jobs=1)
  assert scanned == want_scanned
  assert_same_findings(got, want)
  assert not [f for f in got if not f.suppressed]
  assert len(got) == 11


@pytest.mark.parametrize('fmt', ['json', 'sarif'])
def test_both_clis_print_the_same_document(fmt, monkeypatch):
  monkeypatch.chdir(ROOT)
  monkeypatch.delenv('LDDL_ANALYZE_CACHE', raising=False)
  (rc, out, err), want = run_both_clis(['--format', fmt, 'lddl_tpu'])
  assert rc == 0 and not err
  assert (rc, as_reference_text(out), err) == want
  doc = json.loads(out)
  if fmt == 'json':
    assert doc['clean'] and doc['num_suppressed'] == 11
  else:
    results = doc['runs'][0]['results']
    assert len(results) == 11
    assert all(r['suppressions'] == [{'kind': 'inSource'}] for r in results)
