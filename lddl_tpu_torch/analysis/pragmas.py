"""Inline suppression pragmas (the port's copy of
:mod:`lddl_tpu.analysis.pragmas`: the same syntax).

Syntax (anywhere in a comment)::

  do_thing()  # lddl: noqa[LDA001] reason the hazard does not apply here
  other()     # lddl: noqa  -- suppresses every rule on this line

A pragma on a *standalone* comment line covers the whole next logical
line (the full multi-line statement), so a suppression and its
(mandatory, by convention) reason can live on their own line when the
code line has no room. When the next statement is a decorator, coverage
extends through the decorator stack to the ``def``/``class`` signature
line, so a pragma placed above a decorated definition suppresses
findings anchored at the definition itself::

  # lddl: noqa[LDA003] timeout detection: aborting a stuck collective
  # never diverges ranks, it raises.
  if now > deadline:
      ...

A finding is suppressed when a pragma naming its rule (or a bare
``noqa``) covers any source line the flagged node spans
(``lineno..end_lineno``). Comments are found with ``tokenize`` so
pragma-like text inside string literals never suppresses anything.
"""

import io
import re
import tokenize

_PRAGMA_RE = re.compile(r'#\s*lddl:\s*noqa(?:\[([A-Za-z0-9_,\s]+)\])?')

# None as a value means "suppress all rules" (bare ``# lddl: noqa``).
ALL_RULES = None

_TRIVIA = frozenset({
    tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
    tokenize.DEDENT, tokenize.ENCODING, tokenize.ENDMARKER,
})


def _merge(out, line, rules):
  prev = out.get(line, frozenset())
  if rules is ALL_RULES or (line in out and prev is ALL_RULES):
    out[line] = ALL_RULES
  else:
    out[line] = prev | rules


def pragma_lines(source):
  """Map source line number -> frozenset of suppressed rule ids (or
  :data:`ALL_RULES`). Files that fail to tokenize (the engine reports
  those as LDA000) yield no pragmas."""
  try:
    tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
  except (tokenize.TokenError, SyntaxError, IndentationError):
    return {}
  code_lines = set()
  for tok in tokens:
    if tok.type not in _TRIVIA:
      code_lines.update(range(tok.start[0], tok.end[0] + 1))
  out = {}
  for i, tok in enumerate(tokens):
    if tok.type != tokenize.COMMENT:
      continue
    m = _PRAGMA_RE.search(tok.string)
    if not m:
      continue
    ids = m.group(1)
    rules = (ALL_RULES if ids is None else frozenset(
        r.strip().upper() for r in ids.split(',') if r.strip()))
    line = tok.start[0]
    _merge(out, line, rules)
    if line in code_lines:
      continue
    # Standalone comment: cover the next logical line in full (the
    # statement may span many physical lines; the flagged node can sit
    # on any of them). Comment-only lines in between — e.g. the
    # pragma's reason text — don't count as the statement. When that
    # logical line is a decorator, keep extending through any further
    # decorators and the ``def``/``class`` signature line they adorn:
    # a pragma above a decorated definition must suppress findings on
    # the definition itself, which ``ast`` anchors at the ``def`` line.
    j = i + 1
    while j < len(tokens):
      start = end = None
      first = None
      for k in range(j, len(tokens)):
        nxt = tokens[k]
        if start is None:
          if nxt.type in _TRIVIA:
            continue
          start = nxt.start[0]
          first = nxt
        end = nxt.end[0]
        if nxt.type == tokenize.NEWLINE:
          j = k + 1
          break
      else:
        j = len(tokens)
      if start is None:
        break
      for l in range(start, end + 1):
        _merge(out, l, rules)
      if not (first.type == tokenize.OP and first.string == '@'):
        break
  return out


def is_suppressed(finding, pragmas):
  """Whether ``finding`` is covered by a pragma on any line it spans."""
  for line in range(finding.line, max(finding.line, finding.end_line) + 1):
    if line not in pragmas:
      continue
    rules = pragmas[line]
    if rules is ALL_RULES or finding.rule_id in rules:
      return True
  return False
