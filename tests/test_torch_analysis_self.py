"""The port's standing gate: its own analyzer over ``lddl_tpu_torch/``.

``analyze_package`` runs in project mode with every rule (LDA001-LDA018),
torch's spellings included. The tree has no unsuppressed finding, and the
suppressed ones are exactly :data:`SUPPRESSED`, each with its reason
inline: a PR adding one is a conscious, reviewed decision. Beside it:
the command as a user runs it (``python -m lddl_tpu_torch.cli
lddl_analyze``, JSON and SARIF, in a process that loads nothing of
``lddl_tpu``), the elastic path's purity under the port's rules, a cache
directory shared with ``lddl_tpu``'s analyzer, and the forkserver pool
against the serial pass.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import lddl_tpu_torch
from lddl_tpu_torch.analysis import (CONCURRENCY_RULE_IDS, analyze_package,
                                     analyze_paths, analyze_project)

ROOT = Path(__file__).resolve().parent.parent
PKG = os.path.dirname(os.path.abspath(lddl_tpu_torch.__file__))

#: (rule, path under the package, message) of every suppressed finding.
#: Both branch on a process group's backend, one per group, so every rank
#: of the group takes the same arm.
SUPPRESSED = [
    ('LDA011', 'parallel/train.py',
     'branch arms in TensorReplicas.__call__() reach different collective '
     'sequences (broadcast vs all_reduce): ranks disagreeing on the '
     'condition issue mismatched collectives and deadlock'),
    ('LDA011', 'parallel/train.py',
     'branch arms in ShardedDataParallel.grads() reach different collective '
     'sequences (reduce_scatter_tensor vs all_reduce): ranks disagreeing on '
     'the condition issue mismatched collectives and deadlock'),
]


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The analyzer makes no shm segment; the shared fixture would count other
  # xdist workers' lddl_ segments as this test's leak.
  yield


def _named(findings):
  return [(f.rule_id, os.path.relpath(f.path, PKG).replace(os.sep, '/'),
           f.message) for f in findings]


def test_the_port_has_no_unsuppressed_finding(monkeypatch):
  monkeypatch.delenv('LDDL_ANALYZE_CACHE', raising=False)
  unsuppressed, suppressed = analyze_package()
  assert not unsuppressed, '\n'.join(f.render() for f in unsuppressed)
  assert _named(suppressed) == SUPPRESSED, \
      '\n'.join(f.render() for f in suppressed)


def test_concurrency_rules_clean_with_no_suppressions(monkeypatch):
  monkeypatch.delenv('LDDL_ANALYZE_CACHE', raising=False)
  unsuppressed, suppressed = analyze_package(jobs=1)
  conc = [f for f in unsuppressed + suppressed
          if f.rule_id in CONCURRENCY_RULE_IDS]
  assert not conc, '\n'.join(f.render() for f in conc)


def test_the_elastic_path_is_pure_under_the_ports_rules():
  from lddl_tpu_torch.analysis.rules import ElasticPathPurity
  findings, _ = analyze_project([PKG], rules=[ElasticPathPurity()])
  assert findings == []


def _run(code, env=None):
  return subprocess.run(
      [sys.executable, '-c', code], cwd=ROOT, capture_output=True,
      text=True, timeout=300,
      env=dict(os.environ if env is None else env, PYTHONPATH=str(ROOT)))


_CLI = ('import json, sys\n'
        'from lddl_tpu_torch.cli import main\n'
        'rc = main(["lddl_analyze", "--format", {fmt!r}])\n'
        'print(json.dumps([rc, sorted(m for m in sys.modules\n'
        '                  if m.split(".")[0] == "lddl_tpu")]))\n')


@pytest.mark.parametrize('fmt', ['json', 'sarif'])
def test_the_command_over_the_port(fmt):
  """``lddl_analyze`` with no path lints ./lddl_tpu_torch: exit 0, the
  named suppressions, and no module of lddl_tpu loaded."""
  env = {k: v for k, v in os.environ.items() if k != 'LDDL_ANALYZE_CACHE'}
  proc = _run(_CLI.format(fmt=fmt), env)
  assert proc.returncode == 0, proc.stderr
  doc_line, tail = proc.stdout.strip().splitlines()
  assert json.loads(tail) == [0, []]
  doc = json.loads(doc_line)
  if fmt == 'json':
    assert doc['clean'] and doc['mode'] == 'project'
    assert doc['files_scanned'] >= 100
    assert [(f['rule'], f['path'].split('lddl_tpu_torch/', 1)[1],
             f['message']) for f in doc['findings']] == SUPPRESSED
  else:
    run = doc['runs'][0]
    assert len(run['tool']['driver']['rules']) == 18
    assert [r['ruleId'] for r in run['results']] == ['LDA011', 'LDA011']
    assert all(r['suppressions'] == [{'kind': 'inSource'}]
               for r in run['results'])


def test_a_cache_shared_with_lddl_tpus_analyzer(tmp_path):
  """A directory lddl_tpu's analyzer filled over the same tree: the port's
  run over it gives its uncached findings, stores entries of its own (the
  key spaces are disjoint), and loads no module of lddl_tpu."""
  cache = tmp_path / 'cache'
  env = dict(os.environ, LDDL_ANALYZE_CACHE=str(cache))
  ref = _run('from lddl_tpu.analysis.cli import main\n'
             f'main(["--format", "json", "--jobs", "1", {PKG!r}])\n', env)
  assert ref.returncode == 0, ref.stderr
  written = set(os.listdir(cache))
  assert written
  code = ('import json, sys\n'
          'from lddl_tpu_torch.analysis import analyze_project, '
          'cache_from_env\n'
          f'f, n = analyze_project([{PKG!r}], cache=cache_from_env())\n'
          'print(json.dumps([n, [x.as_dict() for x in f], sorted(m for m in '
          'sys.modules if m.split(".")[0] == "lddl_tpu")]))\n')
  runs = []
  for _ in range(2):  # cold (for the port), then warm
    proc = _run(code, env)
    assert proc.returncode == 0, proc.stderr
    runs.append(json.loads(proc.stdout))
  uncached, n = analyze_project([PKG], cache=None)
  for scanned, findings, loaded in runs:
    assert loaded == []
    assert scanned == n
    assert findings == [f.as_dict() for f in uncached]
  mine = set(os.listdir(cache)) - written
  assert mine and written <= set(os.listdir(cache))


def test_the_forkserver_pool_gives_the_serial_findings(monkeypatch):
  from lddl_tpu_torch.loader import workers
  contexts = []
  real = workers.worker_context

  def recorded(module):
    ctx = real(module)
    contexts.append((module, ctx.get_start_method()))
    return ctx

  monkeypatch.setattr(workers, 'worker_context', recorded)
  serial, n = analyze_paths([PKG], jobs=1)
  assert contexts == []
  pooled, m = analyze_paths([PKG], jobs=4)
  assert contexts == [('lddl_tpu_torch.analysis.engine', 'forkserver')]
  assert n == m
  assert [f.as_dict() for f in pooled] == [f.as_dict() for f in serial]
