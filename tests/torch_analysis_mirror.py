"""Runs ``lddl_tpu``'s analyzer test cases against the port's analyzer.

:func:`port_version` loads a test module of ``lddl_tpu``'s analyzer
(``tests/test_analysis.py``, ``test_analysis_project.py``,
``test_analysis_concurrency.py``) with every ``lddl_tpu.analysis`` import
pointed at ``lddl_tpu_torch.analysis``, at module level and inside its
functions alike, so each case's own assertions judge the port. Its entry
points (``analyze_source``, ``analyze_paths``, ``analyze_project``,
``cli_main``, ``to_sarif``) are then wrapped so that every call also runs
``lddl_tpu``'s counterpart on the same input, and the two must agree:
equal findings (rule id, path, line, column, message, hint, chain,
chains, suppressed flag), equal exit codes and equal printed documents.
The reference runs serially (``jobs=1``): its output is the same at any
worker count, and its pool forks.

The one text the two analyzers may print differently is a hint the port
rewrote to name its own helpers (:data:`PORTED_HINTS`); the comparison
maps it back before it compares. The reference's test files are read,
never edited. This module imports no torch.
"""

import contextlib
import functools
import importlib.util
import inspect
import io
import json
import os
import sys

import lddl_tpu.analysis as ref
import lddl_tpu.analysis.cli as ref_cli
import lddl_tpu.analysis.rules as ref_rules
import lddl_tpu.analysis.sarif as ref_sarif
import lddl_tpu_torch.analysis as port
import lddl_tpu_torch.analysis.cli as port_cli
import lddl_tpu_torch.analysis.rules as port_rules
import lddl_tpu_torch.analysis.sarif as port_sarif

TESTS = os.path.dirname(os.path.abspath(__file__))

#: rule id -> (the port's hint, lddl_tpu's), where the port names its own
#: helpers.
PORTED_HINTS = {
    rid: (r.hint, ref_rules.rules_by_id()[rid].hint)
    for rid, r in port_rules.rules_by_id().items()
    if r.hint != ref_rules.rules_by_id()[rid].hint}


def as_reference_text(text):
  """``text`` (a render, a JSON or SARIF document) with the port's hints
  spelled as the reference's."""
  for mine, theirs in PORTED_HINTS.values():
    text = text.replace(mine, theirs)
    text = text.replace(json.dumps(mine)[1:-1], json.dumps(theirs)[1:-1])
  return text


def finding_key(f):
  """Everything a finding says, with a ported hint spelled as the
  reference's."""
  hint = f.hint
  if f.rule_id in PORTED_HINTS and hint == PORTED_HINTS[f.rule_id][0]:
    hint = PORTED_HINTS[f.rule_id][1]
  return (f.rule_id, f.path, f.line, f.col, f.end_line, f.message, hint,
          f.suppressed, f.chain, f.chains)


def assert_same_findings(port_findings, ref_findings):
  assert ([finding_key(f) for f in port_findings] ==
          [finding_key(f) for f in ref_findings])


def reference_rules(rules):
  """The reference's instances of the port's ``rules`` (by rule id)."""
  if rules is None:
    return None
  by_id = ref_rules.rules_by_id()
  return [by_id[r.rule_id] for r in rules]


def _dual_source(source, path='<string>', rules=None):
  got = port.analyze_source(source, path=path, rules=rules)
  assert_same_findings(got, ref.analyze_source(
      source, path=path, rules=reference_rules(rules)))
  return got


def _dual_paths(paths, rules=None, jobs=None, cache=None):
  got = port.analyze_paths(paths, rules=rules, jobs=jobs, cache=cache)
  want = ref.analyze_paths(paths, rules=reference_rules(rules), jobs=1)
  assert got[1] == want[1]
  assert_same_findings(got[0], want[0])
  return got


def _dual_project(paths, rules=None, jobs=None, file_filter=None,
                  cache=None):
  got = port.analyze_project(paths, rules=rules, jobs=jobs,
                             file_filter=file_filter, cache=cache)
  want = ref.analyze_project(paths, rules=reference_rules(rules), jobs=1,
                             file_filter=file_filter)
  assert got[1] == want[1]
  assert_same_findings(got[0], want[0])
  return got


def _serial_argv(argv):
  """``argv`` with the reference held to one job."""
  out, skip = [], False
  for a in argv:
    if skip:
      skip = False
      continue
    if a == '--jobs':
      skip = True
      continue
    out.append(a)
  return out + ['--jobs', '1']


def run_both_clis(argv):
  """Both CLIs over ``argv``: the reference's output captured here, the
  port's printed as usual (after it); returns ``(rc, out, err)`` of each,
  the port's first."""
  out, err = io.StringIO(), io.StringIO()
  with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
    want = ref_cli.main(_serial_argv(list(argv)))
  pout, perr = io.StringIO(), io.StringIO()
  with contextlib.redirect_stdout(pout), contextlib.redirect_stderr(perr):
    got = port_cli.main(list(argv))
  return (got, pout.getvalue(), perr.getvalue()), (want, out.getvalue(),
                                                   err.getvalue())


def _dual_cli(argv=None):
  (rc, out, err), want = run_both_clis(argv)
  assert (rc, as_reference_text(out), as_reference_text(err)) == want
  sys.stdout.write(out)
  sys.stderr.write(err)
  return rc


def _dual_sarif(findings, rules):
  got = port_sarif.to_sarif(findings, rules)
  want = ref_sarif.to_sarif(findings, reference_rules(rules))
  assert as_reference_text(json.dumps(got)) == json.dumps(want)
  return got


DUALS = {
    'analyze_source': _dual_source,
    'analyze_paths': _dual_paths,
    'analyze_project': _dual_project,
    'cli_main': _dual_cli,
    'to_sarif': _dual_sarif,
}


@functools.lru_cache(maxsize=None)
def port_version(name):
  """``tests/<name>.py`` with ``lddl_tpu.analysis`` read as the port's,
  its entry points wrapped by :data:`DUALS`."""
  path = os.path.join(TESTS, f'{name}.py')
  with open(path, encoding='utf-8') as f:
    source = f.read().replace('lddl_tpu.analysis', 'lddl_tpu_torch.analysis')
  spec = importlib.util.spec_from_loader(f'torch_mirror_{name}', loader=None)
  module = importlib.util.module_from_spec(spec)
  module.__file__ = path
  exec(compile(source, path, 'exec'), module.__dict__)  # noqa: S102
  for attr, dual in DUALS.items():
    if attr in module.__dict__:
      module.__dict__[attr] = dual
  return module


def cases(name):
  """The test functions of ``tests/<name>.py``, by name, in file order."""
  module = port_version(name)
  fns = [(fn.__code__.co_firstlineno, n) for n, fn in vars(module).items()
         if n.startswith('test_') and inspect.isfunction(fn)]
  return [n for _, n in sorted(fns)]


def run_case(name, case, request):
  """Run ``case`` of ``tests/<name>.py`` against the port, with its
  fixtures (``tmp_path``, ``capsys``, ``monkeypatch``) from ``request``."""
  fn = getattr(port_version(name), case)
  kwargs = {p: request.getfixturevalue(p)
            for p in inspect.signature(fn).parameters}
  fn(**kwargs)
