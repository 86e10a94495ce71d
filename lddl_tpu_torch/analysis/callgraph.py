"""Deterministic call graph + transitive-effect engine (project mode),
the port's copy of :mod:`lddl_tpu.analysis.callgraph`.

Built on top of a
:class:`~lddl_tpu_torch.analysis.project.ProjectIndex`: every definition
is a node; every call site the index can resolve to a project definition
is an edge. On the graph this module computes

  - **transitive effect sets** — a function's effects are its own lexical
    effects (``collective``, ``host_sync``, ``wall_clock``,
    ``blocking_io``, ``thread_spawn``, ``unbounded_wait``) unioned with
    everything its callees can do, to a fixed point, so cycles are safe;
  - **shortest call chains** from a root to any reachable effect site
    (the ``via: a() → b() → ...`` traces findings carry);
  - **ordered collective traces** — the sequence of collectives a call
    into a function will issue, in source order, for the
    collective-order-divergence rule.

Everything iterates over sorted structures: two runs over the same tree
produce the same graph, the same chains, and byte-identical findings.

Deliberate non-edges: ``Thread(target=f)`` / ``Process(target=f)`` do
*not* link caller to ``f`` — the target runs in a separate failure
domain and its waits/collectives are not issued on the caller's path
(the spawn itself is recorded as a ``thread_spawn`` effect). Ditto
callables handed to worker pools. ``functools.partial(f, ...)`` *is* an
edge: the partial runs in the caller's dynamic extent.
"""

import collections

from .engine import COLLECTIVES, DEVICE_COLLECTIVE_PREFIXES


def is_lexical_collective(call):
  """Whether one CallSite is itself a cross-rank collective.

  Attribute calls match on the method name (``comm.barrier()``); bare
  names only when alias resolution proves the origin (``from ..comm
  import barrier``) — a local function that happens to be called
  ``barrier`` resolves dotless and is not a collective. Mirrors
  rules.LDA005 exactly: the two must agree or findings would shift
  between file and project mode.
  """
  dotted = call.dotted or ''
  if call.receiver:
    name = call.terminal
  else:
    if '.' not in dotted:
      return False
    name = dotted.rsplit('.', 1)[-1]
  return (name in COLLECTIVES
          and not dotted.startswith(DEVICE_COLLECTIVE_PREFIXES))


class CallGraph:
  """Edges + transitive effects over a built ProjectIndex."""

  # Recursion guard for collective traces (deep chains carry no extra
  # ordering information past this).
  _TRACE_DEPTH = 12
  _TRACE_LIMIT = 8

  def __init__(self, index):
    self.index = index
    # gq -> list aligned with defs[gq].calls: resolved callee gq or ''.
    self.call_targets = {}
    for gq in sorted(index.defs):
      facts = index.defs[gq]
      self.call_targets[gq] = [index.resolve_call(gq, c)
                               for c in facts.calls]
    # gq -> ((callee gq, first call-site line), ...) in source order.
    self.edges = {}
    for gq in sorted(self.call_targets):
      first_line = {}
      for call, tgt in zip(index.defs[gq].calls, self.call_targets[gq]):
        if tgt and tgt in index.defs and tgt not in first_line:
          first_line[tgt] = call.line
      self.edges[gq] = tuple(
          sorted(first_line.items(), key=lambda kv: (kv[1], kv[0])))
    self._transitive = self._fixed_point_effects()
    self._trace_memo = {}

  def _fixed_point_effects(self):
    eff = {gq: frozenset(e.kind for e in self.index.defs[gq].effects)
           for gq in self.index.defs}
    changed = True
    while changed:
      changed = False
      for gq in sorted(eff):
        merged = eff[gq]
        for tgt, _ in self.edges.get(gq, ()):
          merged = merged | eff.get(tgt, frozenset())
        if merged != eff[gq]:
          eff[gq] = merged
          changed = True
    return eff

  def transitive_effects(self, gq):
    """Effect kinds ``gq`` can perform, directly or through any callee."""
    return self._transitive.get(gq, frozenset())

  def bfs_parents(self, root):
    """First-visit parent map ``gq -> (parent gq, call-site line)`` from
    ``root`` (root maps to None). First visit along sorted adjacency =
    a deterministic shortest chain to every reachable definition."""
    parents = {root: None}
    queue = collections.deque([root])
    while queue:
      cur = queue.popleft()
      for tgt, line in self.edges.get(cur, ()):
        if tgt not in parents:
          parents[tgt] = (cur, line)
          queue.append(tgt)
    return parents

  def chain_hops(self, parents, target):
    """``[(hop gq, line of the call it makes toward target), ...]`` from
    the BFS root down to (excluding) ``target``."""
    rev = []
    cur = target
    while parents[cur] is not None:
      parent, line = parents[cur]
      rev.append((parent, line))
      cur = parent
    return list(reversed(rev))

  def reachable_effects(self, root, kinds):
    """Every effect site of ``kinds`` reachable from ``root``:
    ``(def gq, EffectSite, hops)`` sorted by effect location."""
    parents = self.bfs_parents(root)
    out = []
    for gq in sorted(parents):
      facts = self.index.defs.get(gq)
      if facts is None:
        continue
      for eff in facts.effects:
        if eff.kind in kinds:
          out.append((gq, eff, self.chain_hops(parents, gq)))
    out.sort(key=lambda t: (self.index.def_path(t[0]), t[1].line,
                            t[1].col, t[1].kind))
    return out

  def collective_trace(self, gq):
    """Ordered tuple of collective names a call to ``gq`` issues, in
    source order, following resolved callees (capped, cycle-guarded;
    best-effort on recursion)."""
    return self._trace(gq, frozenset())

  def _trace(self, gq, stack):
    if gq in self._trace_memo:
      return self._trace_memo[gq]
    facts = self.index.defs.get(gq)
    if facts is None or gq in stack or len(stack) > self._TRACE_DEPTH:
      return ()
    stack = stack | {gq}
    out = []
    for call, tgt in zip(facts.calls, self.call_targets.get(gq, ())):
      if is_lexical_collective(call):
        out.append(call.terminal)
      elif tgt:
        out.extend(self._trace(tgt, stack))
      if len(out) >= self._TRACE_LIMIT:
        out = out[:self._TRACE_LIMIT]
        break
    trace = tuple(out)
    self._trace_memo[gq] = trace
    return trace
