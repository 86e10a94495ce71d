"""``lddl-analyze``: the SPMD determinism & resource-safety linter, the
port's copy of :mod:`lddl_tpu.analysis.cli`.

Run it as ``python -m lddl_tpu_torch.cli lddl_analyze [args...]`` (or
``python -m lddl_tpu_torch.analysis.cli``); the installed console script
``lddl-analyze`` stays ``lddl_tpu``'s. Usage::

  lddl-analyze [paths...]             # default: lddl_tpu_torch/ if present
  lddl-analyze --format json pkg/     # machine-readable findings
  lddl-analyze --format sarif .       # SARIF 2.1.0 for CI annotations
  lddl-analyze --rule LDA001,LDA009 . # subset of rules
  lddl-analyze --no-project pkg/      # per-file rules only
  lddl-analyze --jobs 8 .             # worker count for the file pass
  lddl-analyze --changed              # only files changed vs HEAD
  lddl-analyze --changed --diff-base main~3
  lddl-analyze --list-rules

Directory targets analyze in **project mode** by default: on top of the
per-file rules, the whole-program pass builds a cross-module call graph
and runs the interprocedural rules (LDA008–LDA011), attaching a
``via: a() → b() → allgather at path:L`` call-chain trace to each
finding. ``--no-project`` restricts to the per-file rules;
``--project`` forces the whole-program pass even for file targets.
``--changed`` implies ``--no-project`` unless ``--project`` is given
(a partial file list can't support whole-program claims); with both,
the per-file pass runs only over the changed files while the call
graph is still built over the full tree, and a project finding is
reported when the changed set touches *any* hop of its call chains —
a small diff re-runs exactly the interprocedural claims it can affect.

Setting ``LDDL_ANALYZE_CACHE`` to a directory enables the incremental
cache: per-file findings and per-module facts are keyed by content
hash, so a warm run over an unchanged tree skips parsing entirely and
produces byte-identical output. ``--no-cache`` bypasses it.

Exit status: 0 when every finding is pragma-suppressed (or none exist),
1 when unsuppressed findings remain, 2 on usage errors. The tier-1
self-check (``tests/test_torch_analysis_self.py``) asserts exit-0 over
``lddl_tpu_torch/`` itself — in project mode — making the analyzer a
standing gate for every change.
"""

import argparse
import json
import os
import subprocess
import sys

from .cache import cache_from_env
from .engine import Rule, analyze_paths, discover_py_files
from .project import ProjectRule, analyze_project
from .rules import all_rules, rules_by_id
from .sarif import to_sarif

JSON_SCHEMA_VERSION = 3


def _git_changed_files(diff_base):
  """Absolute paths of files changed vs ``diff_base`` plus untracked
  files, per git; raises on any git failure (a broken filter silently
  scanning nothing would report a falsely clean tree)."""
  top = subprocess.run(
      ['git', 'rev-parse', '--show-toplevel'],
      capture_output=True, text=True, check=True).stdout.strip()
  changed = subprocess.run(
      ['git', 'diff', '--name-only', '-z', diff_base, '--'],
      capture_output=True, text=True, check=True, cwd=top).stdout
  untracked = subprocess.run(
      ['git', 'ls-files', '--others', '--exclude-standard', '-z'],
      capture_output=True, text=True, check=True, cwd=top).stdout
  names = [n for n in (changed + untracked).split('\0') if n]
  return {os.path.abspath(os.path.join(top, n)) for n in names}


def build_parser():
  parser = argparse.ArgumentParser(
      prog='lddl-analyze',
      description='SPMD determinism & resource-safety linter for the '
      'lddl_tpu_torch pipeline')
  parser.add_argument('paths', nargs='*',
                      help='files or directories to analyze '
                      '(default: ./lddl_tpu_torch when present, '
                      'else .)')
  parser.add_argument('--format', default=None, dest='fmt',
                      choices=('text', 'json', 'sarif'),
                      help='output format (default: text)')
  parser.add_argument('--json', action='store_true', dest='as_json',
                      help='shorthand for --format json')
  parser.add_argument('--project', action='store_true', default=None,
                      help='force the whole-program (call-graph) pass; '
                      'default: on for directory targets')
  parser.add_argument('--no-project', action='store_false',
                      dest='project',
                      help='per-file rules only')
  parser.add_argument('--jobs', type=int, default=None,
                      help='worker processes for the per-file pass '
                      '(default: $LDDL_ANALYZE_JOBS or CPU count)')
  parser.add_argument('--rule', default=None,
                      help='comma-separated rule ids to run '
                      '(e.g. LDA001,LDA009); default: all')
  parser.add_argument('--changed', action='store_true',
                      help='only analyze files git reports as changed '
                      'or untracked (fast local runs)')
  parser.add_argument('--diff-base', default='HEAD',
                      help='git ref --changed diffs against '
                      '(default: HEAD)')
  parser.add_argument('--no-cache', action='store_true',
                      help='ignore LDDL_ANALYZE_CACHE and recompute '
                      'everything')
  parser.add_argument('--show-suppressed', action='store_true',
                      help='also print pragma-suppressed findings in '
                      'text mode')
  parser.add_argument('--list-rules', action='store_true',
                      help='print the rule table and exit')
  return parser


def _touches(finding, file_filter):
  """Whether a finding concerns any file in the ``--changed`` set: its
  anchor file, or any hop of any of its call chains (a changed callee
  re-surfaces the project findings that flow through it)."""
  if os.path.abspath(finding.path) in file_filter:
    return True
  chains = finding.chains or (
      [{'hops': finding.chain}] if finding.chain else [])
  return any(os.path.abspath(hop['path']) in file_filter
             for entry in chains for hop in entry['hops'])


def _select_rules(spec):
  """Rule instances for a ``--rule`` spec (None = all), or an error."""
  if not spec:
    return None, None
  by_id = rules_by_id()
  wanted = [r.strip().upper() for r in spec.split(',') if r.strip()]
  unknown = [r for r in wanted if r not in by_id]
  if unknown:
    return None, f'unknown rule id(s): {", ".join(unknown)} ' \
                 f'(known: {", ".join(sorted(by_id))})'
  return [by_id[r] for r in wanted], None


def main(args=None):
  opts = build_parser().parse_args(args)
  if opts.list_rules:
    for rule in all_rules():
      scope = ('project' if isinstance(rule, ProjectRule) else 'file')
      print(f'{rule.rule_id}  {rule.name}  [{scope}]')
      print(f'    protects: {rule.invariant}')
      print(f'    fix: {rule.hint}')
    return 0

  fmt = opts.fmt or ('json' if opts.as_json else 'text')
  rules, err = _select_rules(opts.rule)
  if err:
    print(f'lddl-analyze: {err}', file=sys.stderr)
    return 2

  paths = opts.paths
  if not paths:
    paths = (['lddl_tpu_torch'] if os.path.isdir('lddl_tpu_torch')
             else ['.'])
  missing = [p for p in paths if not os.path.exists(p)]
  if missing:
    print(f'lddl-analyze: no such path: {", ".join(missing)}',
          file=sys.stderr)
    return 2

  file_filter = None
  if opts.changed:
    try:
      file_filter = _git_changed_files(opts.diff_base)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
      print(f'lddl-analyze: --changed requires a git checkout ({e})',
            file=sys.stderr)
      return 2

  project_mode = opts.project
  if project_mode is None:
    selected_project_rule = bool(rules) and any(
        isinstance(r, ProjectRule) for r in rules)
    project_mode = (not opts.changed and
                    (any(os.path.isdir(p) for p in paths)
                     or selected_project_rule))

  cache = cache_from_env(no_cache=opts.no_cache)
  if project_mode:
    findings, files_scanned = analyze_project(
        paths, rules=rules, jobs=opts.jobs, file_filter=file_filter,
        cache=cache)
    if file_filter is not None:
      findings = [f for f in findings if _touches(f, file_filter)]
  else:
    file_rules = (None if rules is None
                  else [r for r in rules if isinstance(r, Rule)])
    if file_filter is not None:
      files = [f for f in discover_py_files(paths)
               if os.path.abspath(f) in file_filter]
      findings, files_scanned = analyze_paths(files, rules=file_rules,
                                              jobs=opts.jobs,
                                              cache=cache)
    else:
      findings, files_scanned = analyze_paths(paths, rules=file_rules,
                                              jobs=opts.jobs,
                                              cache=cache)

  unsuppressed = [f for f in findings if not f.suppressed]
  suppressed = [f for f in findings if f.suppressed]
  exit_code = 0 if not unsuppressed else 1

  if fmt == 'json':
    print(json.dumps({
        'version': JSON_SCHEMA_VERSION,
        'mode': 'project' if project_mode else 'files',
        'files_scanned': files_scanned,
        'findings': [f.as_dict() for f in findings],
        'num_findings': len(unsuppressed),
        'num_suppressed': len(suppressed),
        'clean': not unsuppressed,
    }))
    return exit_code
  if fmt == 'sarif':
    print(json.dumps(to_sarif(findings, all_rules())))
    return exit_code

  shown = findings if opts.show_suppressed else unsuppressed
  for f in shown:
    print(f.render())
  state = 'clean' if not unsuppressed else 'DIRTY'
  mode = 'project' if project_mode else 'files'
  print(f'lddl-analyze: {files_scanned} files ({mode} mode), '
        f'{len(unsuppressed)} finding(s), '
        f'{len(suppressed)} suppressed — {state}')
  return exit_code


if __name__ == '__main__':
  sys.exit(main())
