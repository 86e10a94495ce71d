"""The finding model shared by the engine, rules, and CLI (the port's
copy of :mod:`lddl_tpu.analysis.findings`).

A :class:`Finding` is one rule violation at one source location. Findings
carry a stable ``rule_id`` (``LDAxxx``), a human message describing the
hazard, and a ``hint`` describing the idiomatic fix, so both the text and
``--json`` renderings are self-explanatory. ``suppressed`` marks findings
covered by an inline ``# lddl: noqa[LDAxxx]`` pragma — they are reported
(in ``--json`` and with ``--show-suppressed``) but never fail the run.
"""

import dataclasses


@dataclasses.dataclass
class Finding:
  """One rule violation at ``path:line:col``.

  Interprocedural (project-mode) findings carry a ``chain``: the call
  path from the analysis root to the effect site, as a list of
  ``{'name', 'path', 'line'}`` hops ending at the hazardous call itself.
  Per-file findings leave it ``None``.

  Concurrency findings relate *two* execution paths (the writer's thread
  chain and the reader's main chain); those carry ``chains`` — a list of
  ``{'label', 'hops'}`` entries, each ``hops`` shaped like ``chain``.
  When ``chains`` is set, ``chain`` mirrors its first entry's hops so
  single-chain consumers keep working.
  """

  rule_id: str
  path: str
  line: int
  col: int
  message: str
  hint: str = ''
  end_line: int = 0  # last source line of the flagged node (pragma window)
  suppressed: bool = False
  chain: list = None  # call-chain trace (project mode), else None
  chains: list = None  # labeled multi-chain traces (concurrency rules)

  def __post_init__(self):
    if not self.end_line:
      self.end_line = self.line
    if self.chains and self.chain is None:
      self.chain = self.chains[0]['hops']

  def location(self):
    return f'{self.path}:{self.line}:{self.col}'

  def as_dict(self):
    """JSON-stable rendering (the ``--json`` schema v3, one entry per
    finding): rule, path, line, col, message, hint, suppressed, chain,
    chains."""
    return {
        'rule': self.rule_id,
        'path': self.path,
        'line': self.line,
        'col': self.col,
        'message': self.message,
        'hint': self.hint,
        'suppressed': self.suppressed,
        'chain': self.chain,
        'chains': self.chains,
    }

  @staticmethod
  def _render_hops(hops):
    head = ' → '.join(hop['name'] for hop in hops[:-1])
    last = hops[-1]
    sep = ' → ' if head else ''
    return (f"{head}{sep}{last['name']}"
            f" at {last['path']}:{last['line']}")

  def render(self):
    tag = ' (suppressed)' if self.suppressed else ''
    out = f'{self.location()}: {self.rule_id}{tag}: {self.message}'
    if self.chains:
      for entry in self.chains:
        out += f"\n    {entry['label']}: {self._render_hops(entry['hops'])}"
    elif self.chain:
      out += f'\n    via: {self._render_hops(self.chain)}'
    if self.hint:
      out += f'\n    hint: {self.hint}'
    return out


def sort_findings(findings):
  """Deterministic report order: path, then line/col, then rule id."""
  return sorted(findings,
                key=lambda f: (f.path, f.line, f.col, f.rule_id))
