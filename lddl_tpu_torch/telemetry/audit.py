"""Cross-run / cross-rank determinism auditing over ledger files.

A copy of :mod:`lddl_tpu.telemetry.audit` (stdlib and :mod:`.ledger`),
run as ``python -m lddl_tpu_torch.telemetry.audit`` (the console
script ``lddl-audit`` stays the JAX package's). It consumes the per-rank
``ledger.rank<R>.jsonl`` files the determinism ledger (:mod:`.ledger`,
env ``LDDL_LEDGER``) streams at every pipeline boundary, of either
package (the format is one), and turns the loaders' byte-identity
contracts into a checkable verdict:

  - ``diff A B`` — align two runs (directories) or two rank files
    record-by-record and bisect the **first divergent coordinate** per
    boundary, reported in pipeline lineage order (shard → collate →
    serve → device → step) so the earliest boundary that broke names
    the culprit stage;
  - ``verify RUN REF`` — verify a resumed run against its parent
    (reference) run's ledger: every coordinate both runs recorded must
    carry the same digest (the child typically covers a subset — it
    resumed mid-stream — so coverage is reported but only *conflicts*
    fail);
  - ``show DIR`` — per-boundary stream summary of one run.

Alignment is key-based (:func:`~.ledger.record_key`: ``(epoch,
index)`` for collates, ``index`` for the device feed, ``gi`` for
service frames, ``step`` for train records, shard ``path``), so
restarts that re-record a coordinate are handled — and a coordinate
recorded twice *within one run* with two different digests (a replayed
batch that came back different) is itself a divergence. Mixed-algorithm
ledgers refuse to compare: fingerprints are only meaningful under one
hash.

Exit codes: ``0`` consistent, ``1`` divergence found, ``2`` usage / no
input.
"""

import argparse
import glob
import json
import os
import re
import sys

from .ledger import KEY_FIELDS, record_key

#: Pipeline lineage order: the earliest diverging boundary in this
#: order names the stage that introduced the divergence (everything
#: downstream inherits it).
BOUNDARY_ORDER = ('shard', 'collate', 'serve.tx', 'serve.rx', 'device',
                  'step')

#: Boundaries whose records form an unordered set (keyed, written by
#: many pool workers) rather than a sequenced stream.
_UNORDERED = ('shard',)

_PROG = 'lddl_tpu_torch.telemetry.audit'


def _boundary_sort(b):
  try:
    return (BOUNDARY_ORDER.index(b), b)
  except ValueError:
    return (len(BOUNDARY_ORDER), b)


def load_ledger_file(path):
  """Parse one ledger JSONL file -> ``{'meta': [...], 'records': [...],
  'bad_lines': N}``. Torn lines (a process SIGKILLed mid-append) are
  tolerated and counted, never fatal — the ledger is exactly the
  artifact that must survive crashes."""
  meta, records, bad = [], [], 0
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line:
        continue
      try:
        d = json.loads(line)
      except ValueError:
        bad += 1
        continue
      if 'boundary' in d:
        records.append(d)
      elif d.get('kind') == 'meta':
        meta.append(d)
  return {'meta': meta, 'records': records, 'bad_lines': bad}


def load_run(path, rank=None):
  """Load a run's ledgers: ``path`` is a directory of
  ``ledger.rank*.jsonl`` files or a single file. Returns
  ``{rank: parsed-file-dict}``."""
  if os.path.isdir(path):
    pattern = (f'ledger.rank{rank}.jsonl' if rank is not None
               else 'ledger.rank*.jsonl')
    paths = sorted(glob.glob(os.path.join(path, pattern)))
    if not paths:
      raise FileNotFoundError(
          f'no {pattern} under {path} '
          '(run with LDDL_LEDGER=1 and LDDL_TELEMETRY_DIR set)')
    out = {}
    for p in paths:
      m = re.search(r'ledger\.rank(\d+)\.jsonl$', p)
      out[int(m.group(1)) if m else len(out)] = load_ledger_file(p)
    return out
  if not os.path.exists(path):
    raise FileNotFoundError(f'no such ledger: {path}')
  parsed = load_ledger_file(path)
  r = parsed['meta'][0].get('rank', 0) if parsed['meta'] else 0
  return {r: parsed}


def run_algo(run):
  """The (single) digest algorithm a run's meta lines declare, or None
  when no meta line survived."""
  algos = {m.get('algo') for parsed in run.values()
           for m in parsed['meta'] if m.get('algo')}
  if len(algos) > 1:
    raise ValueError(f'mixed digest algorithms in one run: {sorted(algos)}')
  return algos.pop() if algos else None


def index_records(parsed):
  """Key-indexed view of one rank's records:
  ``{boundary: {key: record}}`` plus intra-run conflicts (one key, two
  digests — a replay that came back different)."""
  by_boundary, conflicts = {}, []
  seq = {}
  for rec in parsed['records']:
    b = rec['boundary']
    key = record_key(rec)
    if key is None:
      seq[b] = seq.get(b, 0) + 1
      key = (('#seq', seq[b]),)
    table = by_boundary.setdefault(b, {})
    prev = table.get(key)
    if prev is not None and prev['digest'] != rec['digest']:
      conflicts.append({'boundary': b, 'key': _key_dict(key),
                        'digests': [prev['digest'], rec['digest']]})
    table[key] = rec
  return by_boundary, conflicts


def _key_dict(key):
  return {f: v for f, v in key}


def _fmt_key(key):
  return '(' + ', '.join(f'{f}={v}' for f, v in key) + ')'


def parse_key(spec):
  """Parse a lineage-key spec string into the canonical key tuple
  :func:`~.ledger.record_key` produces.

  The grammar is the rendered key form without the parens:
  ``"epoch=0,index=3"`` (a collate coordinate), ``"epoch=1,gi=7"`` (a
  serve frame), ``"step=42"`` (a train step), ``"path=shard-00.parquet"``
  (a shard). Field order is normalized to :data:`~.ledger.KEY_FIELDS`;
  every field but ``path`` is coerced to int. This is the shared
  coordinate grammar of ``show --key`` and the JAX package's ``lddl-replay``.
  """
  fields = {}
  for part in str(spec).split(','):
    part = part.strip()
    if not part:
      continue
    if '=' not in part:
      raise ValueError(f'bad key spec {spec!r}: expected field=value, '
                       f'got {part!r}')
    f, v = part.split('=', 1)
    f = f.strip()
    if f not in KEY_FIELDS:
      raise ValueError(f'bad key spec {spec!r}: unknown field {f!r} '
                       f'(known: {", ".join(KEY_FIELDS)})')
    fields[f] = v.strip() if f == 'path' else int(v)
  if not fields:
    raise ValueError(f'bad key spec {spec!r}: no fields')
  return tuple((f, fields[f]) for f in KEY_FIELDS if f in fields)


def lookup_records(run, key, boundary=None):
  """All records in ``run`` (a :func:`load_run` dict) whose lineage key
  equals ``key``, as ``(rank, record)`` pairs in file order —
  ``show --key``'s coordinate-lookup path.
  ``boundary`` restricts to one boundary name."""
  out = []
  for rank in sorted(run):
    for rec in run[rank]['records']:
      if boundary is not None and rec['boundary'] != boundary:
        continue
      if record_key(rec) == key:
        out.append((rank, rec))
  return out


def diff_indexed(a, b, boundaries=None):
  """First divergence per boundary between two key-indexed views.

  Returns a list of finding dicts, pipeline-lineage ordered. A finding
  is either a digest mismatch at a common key (``kind='divergence'``,
  with the *first* such key in key order) or, for sequenced
  boundaries, a note that one side stops early (``kind='truncated'`` —
  informational, not a failure: a shorter run is not a divergent one).
  """
  findings = []
  names = boundaries or sorted(set(a) | set(b), key=_boundary_sort)
  for bd in names:
    ta, tb = a.get(bd, {}), b.get(bd, {})
    if not ta or not tb:
      continue
    common = sorted(set(ta) & set(tb))
    mismatches = [k for k in common
                  if ta[k]['digest'] != tb[k]['digest']]
    if mismatches:
      k = mismatches[0]
      findings.append({
          'kind': 'divergence', 'boundary': bd, 'key': _key_dict(k),
          'key_str': _fmt_key(k),
          'digest_a': ta[k]['digest'], 'digest_b': tb[k]['digest'],
          'mismatched_keys': len(mismatches), 'common_keys': len(common),
      })
    elif bd not in _UNORDERED and len(ta) != len(tb):
      findings.append({
          'kind': 'truncated', 'boundary': bd,
          'records_a': len(ta), 'records_b': len(tb),
          'common_keys': len(common),
      })
  findings.sort(key=lambda f: _boundary_sort(f['boundary']))
  return findings


def wire_mismatches(run):
  """Intra-run wire-integrity check: the data service fingerprints every
  frame twice — ``serve.tx`` on the server pre-send, ``serve.rx`` on the
  client post-receive — so a frame damaged in between (wire fault,
  corrupted buffer) shows as one coordinate carrying two digests inside
  a single run, no reference run needed. Records are pooled across the
  run's rank files: server and client are usually different processes
  of the same run."""
  tx, rx = {}, {}
  for parsed in run.values():
    indexed, _ = index_records(parsed)
    for key, rec in indexed.get('serve.tx', {}).items():
      tx.setdefault(key, rec['digest'])
    for key, rec in indexed.get('serve.rx', {}).items():
      rx.setdefault(key, rec['digest'])
  return [{'kind': 'wire', 'boundary': 'serve.rx', 'key': _key_dict(k),
           'key_str': _fmt_key(k), 'digest_tx': tx[k],
           'digest_rx': rx[k]}
          for k in sorted(set(tx) & set(rx)) if tx[k] != rx[k]]


def _align_single_rank(run_a, run_b):
  """When two single-rank inputs carry different rank ids, the caller
  is comparing two *rank files* (the cross-rank audit) or a recovered
  rank against a differently-numbered parent; align them positionally
  under the first input's rank id."""
  if not (set(run_a) & set(run_b)) and len(run_a) == 1 and len(run_b) == 1:
    return {next(iter(run_a)): next(iter(run_b.values()))}
  return run_b


def audit_diff(run_a, run_b, boundaries=None):
  """Diff two runs rank-by-rank. Returns
  ``{'ranks': {rank: findings}, 'conflicts': [...], 'wire': [...],
  'divergent': bool, 'first': finding|None}`` where ``first`` is the
  earliest divergence in pipeline lineage order across all compared
  ranks."""
  try:
    alg_a, alg_b = run_algo(run_a), run_algo(run_b)
  except ValueError as e:
    raise ValueError(str(e))
  if alg_a and alg_b and alg_a != alg_b:
    raise ValueError(
        f'cannot compare ledgers hashed with different algorithms: '
        f'{alg_a} vs {alg_b}')
  run_b = _align_single_rank(run_a, run_b)
  out = {'ranks': {}, 'conflicts': [], 'wire': [], 'divergent': False,
         'first': None}
  out['wire'] = [
      dict(m, run=side)
      for side, run in (('a', run_a), ('b', run_b))
      for m in wire_mismatches(run)
  ]
  for rank in sorted(set(run_a) & set(run_b)):
    ia, ca = index_records(run_a[rank])
    ib, cb = index_records(run_b[rank])
    out['conflicts'].extend(
        dict(c, rank=rank, run=side)
        for side, cs in (('a', ca), ('b', cb)) for c in cs)
    findings = diff_indexed(ia, ib, boundaries)
    out['ranks'][rank] = findings
    for f in findings:
      if f['kind'] != 'divergence':
        continue
      out['divergent'] = True
      if (out['first'] is None or
          _boundary_sort(f['boundary']) <
          _boundary_sort(out['first']['boundary'])):
        out['first'] = dict(f, rank=rank)
  if out['conflicts'] or out['wire']:
    out['divergent'] = True
  if out['first'] is None and out['wire']:
    out['first'] = dict(out['wire'][0], rank=None,
                        digest_a=out['wire'][0]['digest_tx'],
                        digest_b=out['wire'][0]['digest_rx'])
  return out


def audit_verify(run, reference, boundaries=None):
  """Verify a recovered run against its reference: every coordinate
  both runs recorded must agree. Subset coverage is normal (the child
  resumed mid-stream); only conflicting digests fail. Returns the
  :func:`audit_diff` dict plus per-rank coverage counts."""
  reference = _align_single_rank(run, reference)
  result = audit_diff(run, reference, boundaries)
  coverage = {}
  for rank in sorted(set(run) & set(reference)):
    ia, _ = index_records(run[rank])
    ib, _ = index_records(reference[rank])
    cov = {}
    for bd in sorted(set(ia) | set(ib), key=_boundary_sort):
      ka, kb = set(ia.get(bd, {})), set(ib.get(bd, {}))
      cov[bd] = {'common': len(ka & kb), 'run_only': len(ka - kb),
                 'reference_only': len(kb - ka)}
    coverage[rank] = cov
  result['coverage'] = coverage
  # Truncation findings are expected on the verify path (the child is
  # shorter or longer than its parent by construction); only real
  # divergences and intra-run conflicts fail.
  result['divergent'] = (bool(result['conflicts']) or
                         bool(result['wire']) or any(
      f['kind'] == 'divergence'
      for fs in result['ranks'].values() for f in fs))
  return result


# ---------------------------------------------------------------------------
# CLI


def _render_findings(result, label_a='A', label_b='B'):
  lines = []
  for rank in sorted(result['ranks']):
    for f in result['ranks'][rank]:
      if f['kind'] == 'divergence':
        lines.append(
            f'rank {rank} · {f["boundary"]}: DIVERGED at {f["key_str"]} '
            f'— {label_a}={f["digest_a"]} {label_b}={f["digest_b"]} '
            f'({f["mismatched_keys"]}/{f["common_keys"]} keys differ)')
      else:
        lines.append(
            f'rank {rank} · {f["boundary"]}: lengths differ '
            f'({label_a}={f["records_a"]} {label_b}={f["records_b"]} '
            f'records; {f["common_keys"]} common keys all agree)')
  for c in result['conflicts']:
    lines.append(
        f'run {c["run"]} rank {c["rank"]} · {c["boundary"]}: intra-run '
        f'conflict at {_fmt_key(tuple(c["key"].items()))} — replayed '
        f'coordinate produced {c["digests"][0]} then {c["digests"][1]}')
  for w in result.get('wire', ()):
    lines.append(
        f'run {w["run"]} · wire: frame damaged in flight at '
        f'{w["key_str"]} — serve.tx={w["digest_tx"]} '
        f'serve.rx={w["digest_rx"]}')
  if result['first']:
    f = result['first']
    where = (f'on rank {f["rank"]}' if f.get('rank') is not None
             else 'on the wire')
    lines.append(
        f'first divergence (pipeline order): {f["boundary"]} '
        f'{f["key_str"]} {where} — everything downstream '
        'inherits it')
  return lines


def _cmd_diff(args, verify=False):
  try:
    run_a = load_run(args.a, rank=args.rank)
    run_b = load_run(args.b, rank=args.rank)
    result = (audit_verify if verify else audit_diff)(
        run_a, run_b, args.boundary or None)
  except (FileNotFoundError, ValueError) as e:
    print(f'{_PROG}: {e}', file=sys.stderr)
    return 2
  if not result['ranks'] and not result['wire']:
    print(f'{_PROG}: no common ranks between {args.a} ({sorted(run_a)}) '
          f'and {args.b} ({sorted(run_b)})', file=sys.stderr)
    return 2
  if args.as_json:
    print(json.dumps(result, indent=2, default=str))
  else:
    labels = (('run', 'reference') if verify else ('A', 'B'))
    for line in _render_findings(result, *labels):
      print(line)
    if verify:
      for rank, cov in sorted(result['coverage'].items()):
        parts = []
        for bd, c in cov.items():
          s = f'{bd}: {c["common"]} common'
          extra = [f'{c[k]} {label}' for k, label in
                   (('run_only', 'run-only'),
                    ('reference_only', 'ref-only')) if c[k]]
          parts.append(s + (f' ({", ".join(extra)})' if extra else ''))
        print(f'rank {rank} coverage: ' + '; '.join(parts))
    if not result['divergent']:
      print(f'{_PROG}: ledgers consistent '
            f'({len(result["ranks"])} rank(s) compared)')
  return 1 if result['divergent'] else 0


def _cmd_show(args):
  try:
    run = load_run(args.dir, rank=args.rank)
  except FileNotFoundError as e:
    print(f'{_PROG}: {e}', file=sys.stderr)
    return 2
  if getattr(args, 'key', None):
    # Single-coordinate pull: the replay lookup path on the CLI. Exit 0
    # with the matching lines, 1 when the coordinate was never recorded.
    try:
      key = parse_key(args.key)
    except ValueError as e:
      print(f'{_PROG}: {e}', file=sys.stderr)
      return 2
    hits = lookup_records(run, key, boundary=args.boundary or None)
    for rank, rec in hits:
      print(json.dumps(dict(rec, rank=rank), default=str))
    if not hits:
      print(f'{_PROG}: no record at {_fmt_key(key)} in {args.dir}',
            file=sys.stderr)
      return 1
    return 0
  for rank, parsed in sorted(run.items()):
    indexed, conflicts = index_records(parsed)
    algo = parsed['meta'][0].get('algo') if parsed['meta'] else '?'
    print(f'rank {rank} · {len(parsed["records"])} records · algo {algo}'
          + (f' · {parsed["bad_lines"]} torn line(s) tolerated'
             if parsed['bad_lines'] else ''))
    for bd in sorted(indexed, key=_boundary_sort):
      table = indexed[bd]
      tail = [r for r in parsed['records'] if r['boundary'] == bd][-1]
      print(f'  {bd}: {len(table)} coordinate(s), rolling '
            f'{tail.get("rolling", "?")}')
    for c in conflicts:
      print(f'  !! intra-run conflict in {c["boundary"]} at '
            f'{_fmt_key(tuple(c["key"].items()))}: {c["digests"]}')
  for w in wire_mismatches(run):
    print(f'!! wire mismatch at {w["key_str"]}: '
          f'serve.tx {w["digest_tx"]} != serve.rx {w["digest_rx"]}')
  return 0


def attach_args(parser):
  sub = parser.add_subparsers(dest='command')
  for name, doc in (('diff', 'first divergent coordinate between two '
                             'runs (or two rank files)'),
                    ('verify', 'verify a recovered run against its '
                               'reference run')):
    p = sub.add_parser(name, help=doc)
    p.add_argument('a', metavar='RUN' if name == 'verify' else 'A',
                   help='ledger directory or ledger.rank<R>.jsonl file')
    p.add_argument('b', metavar='REFERENCE' if name == 'verify' else 'B',
                   help='ledger directory or ledger.rank<R>.jsonl file')
    p.add_argument('--rank', type=int, default=None,
                   help='compare only this rank')
    p.add_argument('--boundary', action='append', default=[],
                   help='restrict to a boundary (repeatable)')
    p.add_argument('--json', action='store_true', dest='as_json',
                   help='emit the full result as JSON')
  p = sub.add_parser('show', help='per-boundary summary of one run')
  p.add_argument('dir', help='ledger directory or file')
  p.add_argument('--rank', type=int, default=None)
  p.add_argument('--key', default=None, metavar='LINEAGE_KEY',
                 help="pull one coordinate's record lines instead of "
                      "the summary (e.g. 'epoch=0,index=3', 'step=42')")
  p.add_argument('--boundary', default=None,
                 help='with --key: restrict the lookup to one boundary')
  return parser


def main(argv=None):
  parser = attach_args(argparse.ArgumentParser(
      prog='python -m lddl_tpu_torch.telemetry.audit',
      description='determinism-ledger auditing: diff runs, verify '
                  'recovery paths, bisect the first divergent batch',
      formatter_class=argparse.RawDescriptionHelpFormatter))
  args = parser.parse_args(argv)
  if args.command == 'diff':
    return _cmd_diff(args, verify=False)
  if args.command == 'verify':
    return _cmd_diff(args, verify=True)
  if args.command == 'show':
    return _cmd_show(args)
  parser.print_usage(sys.stderr)
  return 2


if __name__ == '__main__':
  sys.exit(main())
