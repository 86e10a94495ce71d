"""Thread graph + lockset substrate and the LDA014–LDA018 rules (the
port's copy of :mod:`lddl_tpu.analysis.concurrency`).

The call graph (analysis/callgraph.py) deliberately stops at the thread
boundary: ``Thread(target=f)`` is not a call edge because ``f`` runs in
a separate failure domain. This module builds the *other* edge domain on
top of the same per-module facts:

  - **thread graph** — spawn edges from every ``Thread(target=...)``
    site into the target's call-graph-reachable set (the "thread side"),
    against the set reachable from call-graph roots that no thread can
    reach (the "main side");
  - **shared-state access sets** — each definition's reads/writes of
    ``self.*`` attributes and module globals, keyed per class/module so
    the two sides can be compared field by field;
  - **lockset inference** — every access and call site carries the
    ``with``-contexts lexically held around it; an interprocedural
    fixed point adds the locks *all* callers hold at the call site
    (the ``_trim_locked``-style callee pattern), and lock names are
    canonicalized per class/module so ``self._lock`` in two methods is
    one lock and in two classes is two.

Everything iterates over sorted structures, like the call graph: two
runs over the same tree produce byte-identical findings.

Known under-approximations (shared with ``resolve_call``): closures
handed to opaque iterators/executors never become thread roots, and a
lock object passed as a function argument changes name across the call.
A missing edge can hide a race; it never invents one.
"""

import os

from .engine import UNBOUNDED_WAIT_ATTRS
from .project import ProjectRule

# Rule ids this module contributes (bench.py stamps their finding
# counts; lddl-perf gates on them).
CONCURRENCY_RULE_IDS = frozenset(
    {'LDA014', 'LDA015', 'LDA016', 'LDA017', 'LDA018'})

# A `with` context (or attribute) is lock-like when its name says so or
# its recorded constructor is a lock type.
LOCK_NAME_TOKENS = ('lock', 'mutex', 'cond', 'sem')
LOCK_CTORS = frozenset({
    'threading.Lock', 'threading.RLock', 'threading.Condition',
    'threading.Semaphore', 'threading.BoundedSemaphore',
    'multiprocessing.Lock', 'multiprocessing.RLock',
})

# Attribute constructors that are internally synchronized: cross-thread
# use without an extra lock is their design, not a race.
THREAD_SAFE_CTORS = frozenset(LOCK_CTORS | {
    'threading.Event', 'threading.Barrier', 'threading.local',
    'queue.Queue', 'queue.SimpleQueue', 'queue.LifoQueue',
    'queue.PriorityQueue', 'multiprocessing.Queue',
    'multiprocessing.Event', 'multiprocessing.SimpleQueue',
})

# Method names that mark a definition as teardown: an unbounded
# `thread.join()` reachable from one of these is the worker-pool deadlock
# class (a wedged worker joined forever).
SHUTDOWN_NAMES = frozenset({
    'close', 'stop', 'shutdown', 'teardown', 'finalize',
    '__exit__', '__del__',
})


def _testish(path):
  """Test fixtures exercise hazards on purpose; concurrency rules skip
  definitions living in test files (same convention as LDA013 etc.)."""
  p = os.path.abspath(path).replace(os.sep, '/')
  base = p.rsplit('/', 1)[-1]
  return ('/tests/' in p or base.startswith('test_')
          or base in ('conftest.py', 'testing.py'))


def _is_ctor(gq):
  return gq.rsplit('.', 1)[-1] in ('__init__', '__new__')


def _lockish(name, ctor=''):
  last = name.rsplit('.', 1)[-1].lower()
  if any(tok in last for tok in LOCK_NAME_TOKENS):
    return True
  return ctor in LOCK_CTORS


def _short_lock(canon):
  """Readable lock name for messages: last two dotted segments."""
  return '.'.join(canon.split('.')[-2:])


class ThreadGraph:
  """Spawn edges, thread/main reachable sets, shared-state access
  table, and canonical locksets over a built index + call graph."""

  def __init__(self, index, graph):
    self.index = index
    self.graph = graph
    self._parents_memo = {}
    self._canon_memo = {}
    self._trans_acq = None

    # Every spawn site, with its target resolved to a project def.
    self.spawns = []
    for gq in sorted(index.defs):
      for sp in index.defs[gq].spawns:
        self.spawns.append((gq, sp, self._resolve_target(gq, sp)))
    self.spawns.sort(
        key=lambda t: (index.def_path(t[0]), t[1].line, t[1].col))

    # Thread side: defs reachable from any Thread target. Process
    # targets live in another address space — no shared state.
    self.thread_roots = sorted({tgt for _, sp, tgt in self.spawns
                                if tgt and sp.ctor == 'Thread'})
    self.spawn_for_root = {}
    for owner, sp, tgt in self.spawns:
      if tgt and sp.ctor == 'Thread':
        self.spawn_for_root.setdefault(tgt, (owner, sp))
    self.thread_owner = {}
    for root in self.thread_roots:
      for gq in sorted(self._parents(root)):
        self.thread_owner.setdefault(gq, root)
    self.thread_defs = frozenset(self.thread_owner)

    # Main side: call-graph roots (no resolved incoming edge) that no
    # thread reaches, plus everything they reach. A def reachable only
    # through unresolvable calls lands on neither side — consistent
    # with resolve_call's under-approximation contract.
    incoming = set()
    for gq in sorted(graph.edges):
      for tgt, _ in graph.edges[gq]:
        incoming.add(tgt)
    self.main_roots = sorted(gq for gq in index.defs
                             if gq not in incoming
                             and gq not in self.thread_defs)
    self.main_owner = {}
    for root in self.main_roots:
      for gq in sorted(self._parents(root)):
        self.main_owner.setdefault(gq, root)
    self.main_defs = frozenset(self.main_owner)

    self.entry_locks = self._entry_locks()

  # -- resolution --------------------------------------------------------

  def _resolve_target(self, owner_gq, sp):
    if not sp.target:
      return ''
    index = self.index
    module = index.def_module.get(owner_gq, '')
    if sp.target.startswith('self.') and sp.target.count('.') == 1:
      facts = index.defs[owner_gq]
      if facts.cls:
        cls_gq = f'{module}.{facts.cls}' if module else facts.cls
        return index.mro_method(cls_gq, sp.target.split('.', 1)[1])
      return ''
    # x.run / self._worker.run: type the receiver like resolve_call does.
    if '.' in sp.target and not sp.target.startswith('.'):
      receiver, _, meth = sp.target.rpartition('.')
      cls_gq = index._receiver_class(module, owner_gq, receiver)
      if cls_gq:
        found = index.mro_method(cls_gq, meth)
        if found:
          return found
    return index._resolve_value(module, index.display(owner_gq),
                                sp.target)

  def _parents(self, root):
    if root not in self._parents_memo:
      self._parents_memo[root] = self.graph.bfs_parents(root)
    return self._parents_memo[root]

  # -- lock identity -----------------------------------------------------

  def canon_lock(self, gq, name):
    """Canonical (class- or module-scoped) identity of a lock-like
    ``with`` context named from inside ``gq``, or '' when the name is
    not lock-like. ``self._lock`` in two methods of one class is one
    lock; the same spelling in another class is a different lock."""
    key = (gq, name)
    if key in self._canon_memo:
      return self._canon_memo[key]
    index = self.index
    module = index.def_module.get(gq, '')
    facts = index.defs[gq]
    ctor = ''
    if name.startswith('self.'):
      rest = name.split('.', 1)[1]
      if facts.cls:
        cls_gq = f'{module}.{facts.cls}' if module else facts.cls
        cls = index.classes.get(cls_gq)
        if cls is not None and '.' not in rest:
          ctor = cls.attr_ctors.get(rest, '')
        canon = f'{cls_gq}.{rest}'
      else:
        canon = f'{module}.<self>.{rest}'
    else:
      if '.' not in name:
        ctor = facts.var_ctors.get(name, '')
      canon = f'{module}.{name}' if module else name
    out = canon if _lockish(name, ctor) else ''
    self._canon_memo[key] = out
    return out

  def canon_locks(self, gq, names):
    return frozenset(c for c in (self.canon_lock(gq, n) for n in names)
                     if c)

  def held_at(self, gq, locks):
    """Effective lockset at a site in ``gq``: the lexical `with`
    contexts plus the locks every caller provably holds on entry."""
    return self.entry_locks.get(gq, frozenset()) | \
        self.canon_locks(gq, locks)

  def _entry_locks(self):
    """gq -> locks held at *every* resolved call into gq (intersection
    over call sites, propagated to a fixed point). Thread roots are
    pinned to the empty set: a thread body always starts lock-free."""
    index, graph = self.index, self.graph
    incoming = {}
    for gq in sorted(graph.call_targets):
      facts = index.defs[gq]
      for call, tgt in zip(facts.calls, graph.call_targets.get(gq, ())):
        if tgt and tgt in index.defs:
          incoming.setdefault(tgt, []).append((gq, call.locks))
    pinned = set(self.thread_roots)
    entry = {}
    for gq in index.defs:
      entry[gq] = (frozenset() if gq in pinned or gq not in incoming
                   else None)  # None: no caller's entry known yet
    changed = True
    while changed:
      changed = False
      for gq in sorted(incoming):
        if gq in pinned:
          continue
        acc = None
        for caller, locks in incoming[gq]:
          base = entry.get(caller)
          if base is None:
            continue
          held = base | self.canon_locks(caller, locks)
          acc = held if acc is None else (acc & held)
        if acc is not None and acc != entry[gq]:
          entry[gq] = acc
          changed = True
    return {gq: (v if v is not None else frozenset())
            for gq, v in entry.items()}

  def trans_acquires(self, gq):
    """Canonical lock names ``gq`` (transitively) acquires."""
    if self._trans_acq is None:
      acq = {}
      for g in sorted(self.index.defs):
        acq[g] = frozenset(
            c for c in (self.canon_lock(g, a.name)
                        for a in self.index.defs[g].acquires) if c)
      changed = True
      while changed:
        changed = False
        for g in sorted(acq):
          merged = acq[g]
          for tgt, _ in self.graph.edges.get(g, ()):
            merged = merged | acq.get(tgt, frozenset())
          if merged != acq[g]:
            acq[g] = merged
            changed = True
      self._trans_acq = acq
    return self._trans_acq.get(gq, frozenset())

  # -- shared state ------------------------------------------------------

  def shared_access_table(self):
    """(kind, scope gq, attr) -> [(def gq, AccessSite)] for every
    ``self.*`` attribute (keyed by class) and tracked module global."""
    table = {}
    for gq in sorted(self.index.defs):
      facts = self.index.defs[gq]
      module = self.index.def_module.get(gq, '')
      for acc in facts.accesses:
        if acc.scope == 'global':
          key = ('global', module, acc.attr)
        else:
          if not facts.cls:
            continue
          cls_gq = f'{module}.{facts.cls}' if module else facts.cls
          key = ('attr', cls_gq, acc.attr)
        table.setdefault(key, []).append((gq, acc))
    return table

  def attr_ctor(self, key):
    kind, scope_gq, attr = key
    if kind != 'attr':
      return ''
    cls = self.index.classes.get(scope_gq)
    return cls.attr_ctors.get(attr, '') if cls is not None else ''

  # -- chains ------------------------------------------------------------

  def _hops_from(self, parents, gq, site_name, site_line):
    index = self.index
    hops = [{'name': f'{index.display(hop_gq)}()',
             'path': index.def_path(hop_gq), 'line': line}
            for hop_gq, line in self.graph.chain_hops(parents, gq)]
    hops.append({'name': f'{index.display(gq)}()',
                 'path': index.def_path(gq),
                 'line': index.defs[gq].line})
    hops.append({'name': site_name, 'path': index.def_path(gq),
                 'line': site_line})
    return hops

  def thread_chain(self, gq, site_name, site_line):
    """Spawn site → ... → site: how a spawned thread reaches ``gq``."""
    root = self.thread_owner[gq]
    index = self.index
    hops = []
    sp_entry = self.spawn_for_root.get(root)
    if sp_entry is not None:
      owner, sp = sp_entry
      hops.append({'name': f'{index.display(owner)}() spawns '
                           f'{index.display(root)}()',
                   'path': index.def_path(owner), 'line': sp.line})
    return hops + self._hops_from(self._parents(root), gq,
                                  site_name, site_line)

  def main_chain(self, gq, site_name, site_line):
    root = self.main_owner[gq]
    return self._hops_from(self._parents(root), gq, site_name, site_line)

  def root_chain(self, root, gq, site_name, site_line):
    return self._hops_from(self._parents(root), gq, site_name, site_line)


def thread_graph_for(index, graph):
  """The per-run ThreadGraph, built once and shared by all five rules
  (memoized on the CallGraph instance the run already owns)."""
  tg = getattr(graph, '_lddl_thread_graph', None)
  if tg is None or tg.index is not index:
    tg = ThreadGraph(index, graph)
    graph._lddl_thread_graph = tg
  return tg


# ---------------------------------------------------------------------------
# rules


class CrossThreadUnlockedState(ProjectRule):
  rule_id = 'LDA014'
  name = 'cross-thread-unlocked-state'
  invariant = ('state shared across the thread boundary is accessed '
               'under one common lock: a field written on a '
               'spawned-thread path and read or written on a main path '
               'with disjoint locksets is a data race — torn reads, '
               'lost updates, and order-dependent behavior that defeats '
               'determinism by construction')
  hint = ('guard both sides with the same lock, or hand the value '
          'across the boundary through a Queue/Event instead of a '
          'bare attribute')

  def _describe(self, key):
    kind, scope_gq, attr = key
    if kind == 'global':
      return f'module global {attr!r}'
    return f'self.{attr} (class {scope_gq.rsplit(".", 1)[-1]})'

  def _fmt_locks(self, locks):
    if not locks:
      return 'no lock'
    return ', '.join(sorted(_short_lock(c) for c in locks))

  def check(self, index, graph):
    tg = thread_graph_for(index, graph)
    if not tg.thread_roots:
      return
    for key in sorted(tg.shared_access_table().items()):
      key, sites = key
      ctor = tg.attr_ctor(key)
      if ctor in THREAD_SAFE_CTORS or _lockish(key[2], ctor):
        continue
      usable = [(gq, a) for gq, a in sites
                if not _is_ctor(gq) and not _testish(index.def_path(gq))]
      thread_side = [(gq, a) for gq, a in usable if gq in tg.thread_defs]
      main_side = [(gq, a) for gq, a in usable if gq in tg.main_defs]
      if not thread_side or not main_side:
        continue
      pair = self._first_racy_pair(tg, index, thread_side, main_side)
      if pair is None:
        continue
      (wgq, w), (ogq, o), write_on_thread = pair
      w_locks = tg.held_at(wgq, w.locks)
      o_locks = tg.held_at(ogq, o.locks)
      what = self._describe(key)
      side_w = 'thread' if write_on_thread else 'main'
      side_o = 'main' if write_on_thread else 'thread'
      w_chain = (tg.thread_chain if write_on_thread else tg.main_chain)(
          wgq, f'{what} written', w.line)
      o_chain = (tg.main_chain if write_on_thread else tg.thread_chain)(
          ogq, f'{what} {o.kind}', o.line)
      yield self.finding(
          index.def_path(wgq), w.line, w.col,
          f'{what} is written on a {side_w} path and {o.kind} on a '
          f'{side_o} path with no common lock '
          f'({side_w} holds {self._fmt_locks(w_locks)}, '
          f'{side_o} holds {self._fmt_locks(o_locks)})',
          chains=[
              {'label': f'written via {side_w} chain', 'hops': w_chain},
              {'label': f'{o.kind} via {side_o} chain', 'hops': o_chain},
          ])

  def _first_racy_pair(self, tg, index, thread_side, main_side):
    """First (write, opposite-side access) pair with disjoint effective
    locksets, in deterministic location order; thread-side writes are
    preferred as the anchor."""
    def loc(entry):
      gq, a = entry
      return (index.def_path(gq), a.line, a.col)

    for writes, others, on_thread in (
        ([e for e in thread_side if e[1].kind == 'write'], main_side,
         True),
        ([e for e in main_side if e[1].kind == 'write'], thread_side,
         False)):
      for w_entry in sorted(writes, key=loc):
        wgq, w = w_entry
        w_locks = tg.held_at(wgq, w.locks)
        for o_entry in sorted(others, key=loc):
          ogq, o = o_entry
          if (wgq, w.line, w.col) == (ogq, o.line, o.col):
            continue
          if w_locks & tg.held_at(ogq, o.locks):
            continue
          return w_entry, o_entry, on_thread
    return None


class ThreadLifecycle(ProjectRule):
  rule_id = 'LDA015'
  name = 'thread-lifecycle'
  invariant = ('every spawned thread has an exit discipline: either '
               'daemon=True (the process may exit without it) or a '
               'reachable join — and no shutdown path joins a thread '
               'without a timeout, which is exactly the infinite-join '
               'deadlock a wedged worker turns into a wedged trainer')
  hint = ('spawn with daemon=True or join the thread where it is torn '
          'down; give every shutdown-path join a timeout and handle '
          'the still-alive case')

  def check(self, index, graph):
    tg = thread_graph_for(index, graph)
    for owner_gq, sp, _tgt in tg.spawns:
      if sp.ctor != 'Thread' or _testish(index.def_path(owner_gq)):
        continue
      if sp.daemon is True or self._has_join(index, owner_gq, sp):
        continue
      bind = sp.binding or '<unbound>'
      yield self.finding(
          index.def_path(owner_gq), sp.line, sp.col,
          f'thread spawned in {index.display(owner_gq)}() (bound to '
          f'{bind}) has neither daemon=True nor a reachable join: it '
          'can outlive the process teardown and strand interpreter '
          'exit')
    yield from self._shutdown_joins(tg, index, graph)

  def _has_join(self, index, owner_gq, sp):
    if sp.binding.startswith('self.'):
      facts = index.defs[owner_gq]
      module = index.def_module.get(owner_gq, '')
      if not facts.cls:
        return False
      cls_gq = f'{module}.{facts.cls}' if module else facts.cls
      methods = index.class_methods.get(cls_gq, {})
      for mname in sorted(methods):
        for call in index.defs[methods[mname]].calls:
          if call.terminal == 'join' and call.receiver == sp.binding:
            return True
      return False
    if sp.binding:
      for call in index.defs[owner_gq].calls:
        if call.terminal == 'join' and call.receiver == sp.binding:
          return True
    return False

  def _thread_receiver(self, index, tg, gq, receiver):
    """Whether ``receiver`` names a thread object: a spawn binding or a
    Thread-constructed attribute/local visible from ``gq``."""
    facts = index.defs[gq]
    module = index.def_module.get(gq, '')
    if receiver.startswith('self.') and facts.cls:
      cls_gq = f'{module}.{facts.cls}' if module else facts.cls
      ctor = ''
      cls = index.classes.get(cls_gq)
      if cls is not None:
        ctor = cls.attr_ctors.get(receiver.split('.', 1)[1], '')
      if ctor.rsplit('.', 1)[-1] == 'Thread':
        return True
      methods = set(index.class_methods.get(cls_gq, {}).values())
      return any(owner in methods and sp.binding == receiver
                 and sp.ctor == 'Thread'
                 for owner, sp, _ in tg.spawns)
    if '.' not in receiver:
      if facts.var_ctors.get(receiver, '').rsplit('.', 1)[-1] == 'Thread':
        return True
      return any(owner == gq and sp.binding == receiver
                 and sp.ctor == 'Thread'
                 for owner, sp, _ in tg.spawns)
    return False

  def _shutdown_joins(self, tg, index, graph):
    roots = [gq for gq in sorted(index.defs)
             if gq.rsplit('.', 1)[-1] in SHUTDOWN_NAMES
             and not _testish(index.def_path(gq))]
    owner = {}
    for root in roots:
      for gq in sorted(tg._parents(root)):
        owner.setdefault(gq, root)
    seen = set()
    for gq in sorted(owner):
      facts = index.defs.get(gq)
      if facts is None or _testish(index.def_path(gq)):
        continue
      for call in facts.calls:
        if (call.terminal != 'join' or call.nargs or call.nkw
            or not call.receiver):
          continue
        if not self._thread_receiver(index, tg, gq, call.receiver):
          continue
        key = (index.def_path(gq), call.line, call.col)
        if key in seen:
          continue
        seen.add(key)
        root = owner[gq]
        chain = tg.root_chain(root, gq,
                              f'{call.receiver}.join() — no timeout',
                              call.line)
        yield self.finding(
            index.def_path(gq), call.line, call.col,
            f'{call.receiver}.join() without a timeout is reachable '
            f'from shutdown path {index.display(root)}(): if the '
            'thread is wedged, teardown never returns (the PR 9 '
            'worker-pool deadlock class)',
            chains=[{'label': 'shutdown path', 'hops': chain}])


class LockOrderInversion(ProjectRule):
  rule_id = 'LDA016'
  name = 'lock-order-inversion'
  invariant = ('any two locks are always acquired in one global order: '
               'one path taking A then B while another takes B then A '
               'deadlocks the moment both run concurrently')
  hint = ('pick one acquisition order for the pair and restructure the '
          'second path to match (or collapse the two locks into one)')

  def check(self, index, graph):
    tg = thread_graph_for(index, graph)
    pairs = {}  # (lock A canon, lock B canon) -> (path, line, gq)
    for gq in sorted(index.defs):
      if _testish(index.def_path(gq)):
        continue
      facts = index.defs[gq]
      entry = tg.entry_locks.get(gq, frozenset())
      for acq in facts.acquires:
        b = tg.canon_lock(gq, acq.name)
        if not b:
          continue
        held = entry | tg.canon_locks(gq, acq.held)
        for a in sorted(held):
          if a != b:
            pairs.setdefault((a, b),
                             (index.def_path(gq), acq.line, gq))
      for call, tgt in zip(facts.calls, graph.call_targets.get(gq, ())):
        if not tgt:
          continue
        held = entry | tg.canon_locks(gq, call.locks)
        if not held:
          continue
        for b in sorted(tg.trans_acquires(tgt)):
          for a in sorted(held):
            if a != b:
              pairs.setdefault((a, b),
                               (index.def_path(gq), call.line, gq))
    for a, b in sorted(pairs):
      if a >= b or (b, a) not in pairs:
        continue
      path1, line1, gq1 = pairs[(a, b)]
      path2, line2, gq2 = pairs[(b, a)]
      sa, sb = _short_lock(a), _short_lock(b)
      yield self.finding(
          path1, line1, 1,
          f'lock order inversion: {index.display(gq1)}() acquires '
          f'{sa} then {sb} while {index.display(gq2)}() '
          f'({path2}:{line2}) acquires {sb} then {sa} — concurrent '
          'execution of the two paths deadlocks',
          chains=[
              {'label': f'{sa} → {sb}',
               'hops': [{'name': f'{index.display(gq1)}(): '
                                 f'{sa} then {sb}',
                         'path': path1, 'line': line1}]},
              {'label': f'{sb} → {sa}',
               'hops': [{'name': f'{index.display(gq2)}(): '
                                 f'{sb} then {sa}',
                         'path': path2, 'line': line2}]},
          ])


class SignalHandlerSafety(ProjectRule):
  rule_id = 'LDA017'
  name = 'signal-handler-safety'
  invariant = ('signal handlers only set flags: a handler runs on the '
               'main thread at an arbitrary bytecode boundary, so lock '
               'acquisition self-deadlocks against the frame it '
               'interrupted, blocking I/O stalls delivery, and '
               'allocation-heavy work (logging, print) re-enters '
               'non-reentrant machinery — the PreemptionGuard bug class')
  hint = ('have the handler set a threading.Event (or write a '
          'self-pipe) and do the real work on the next loop iteration')

  def check(self, index, graph):
    tg = thread_graph_for(index, graph)
    seen = set()
    for module in sorted(index.modules):
      mfacts = index.modules[module]
      if _testish(mfacts.path):
        continue
      for handler, scope, reg_line in mfacts.signal_handlers:
        hgq = self._resolve_handler(index, module, scope, handler)
        if not hgq:
          continue
        reg_hop = {'name': f'signal.signal(..., {handler})',
                   'path': mfacts.path, 'line': reg_line}
        yield from self._scan_handler(tg, index, hgq, reg_hop, seen)

  def _resolve_handler(self, index, module, scope, handler):
    if handler.startswith('self.') and handler.count('.') == 1:
      owner_gq = f'{module}.{scope}' if module else scope
      facts = index.defs.get(owner_gq)
      if facts is None or not facts.cls:
        return ''
      cls_gq = f'{module}.{facts.cls}' if module else facts.cls
      return index.mro_method(cls_gq, handler.split('.', 1)[1])
    return index._resolve_value(module, scope, handler)

  def _scan_handler(self, tg, index, hgq, reg_hop, seen):
    parents = tg._parents(hgq)
    for gq in sorted(parents):
      facts = index.defs.get(gq)
      if facts is None:
        continue
      sites = []
      for eff in facts.effects:
        if eff.kind in ('blocking_io', 'unbounded_wait'):
          sites.append((eff.line, eff.col,
                        f'{eff.kind.replace("_", " ")} {eff.detail}'))
      for acq in facts.acquires:
        if tg.canon_lock(gq, acq.name):
          sites.append((acq.line, acq.col,
                        f'lock acquisition (with {acq.name}:)'))
      for call in facts.calls:
        d = call.dotted or ''
        if d == 'print' or d.startswith('logging.'):
          sites.append((call.line, call.col,
                        f'{call.terminal}() (allocates and takes '
                        'interpreter-internal locks)'))
      for line, col, what in sorted(sites):
        key = (index.def_path(gq), line, col)
        if key in seen:
          continue
        seen.add(key)
        hops = [reg_hop] + tg.root_chain(hgq, gq, what, line)
        yield self.finding(
            index.def_path(gq), line, col,
            f'{what} reachable from signal handler '
            f'{index.display(hgq)}(): handlers interrupt arbitrary '
            'frames — only async-signal-safe flag setting is safe '
            'here',
            chains=[{'label': 'handler path', 'hops': hops}])


class BlockingCallUnderLock(ProjectRule):
  rule_id = 'LDA018'
  name = 'blocking-under-lock'
  invariant = ('no lock is held across a blocking call: an unbounded '
               'queue/socket/join/sleep inside a with-lock region '
               'serializes every other thread on the slow operation '
               'and, if the unblocker needs the same lock, deadlocks')
  hint = ('move the blocking call outside the with block (snapshot '
          'state under the lock, block after releasing it), or bound '
          'it with a timeout; Condition.wait on the held lock is the '
          'sanctioned exception')

  # Zero-arg forms of these are unbounded waits (mirrors the engine's
  # UNBOUNDED_WAIT_ATTRS); these block regardless of arguments.
  ALWAYS_BLOCKING = frozenset({'recv', 'recv_into', 'accept', 'select'})

  def check(self, index, graph):
    tg = thread_graph_for(index, graph)
    for gq in sorted(index.defs):
      if _testish(index.def_path(gq)):
        continue
      facts = index.defs[gq]
      entry = tg.entry_locks.get(gq, frozenset())
      for call in facts.calls:
        held = entry | tg.canon_locks(gq, call.locks)
        if not held:
          continue
        hazard = self._hazard(tg, gq, call, held)
        if hazard is None:
          continue
        locks = ', '.join(sorted(_short_lock(c) for c in held))
        yield self.finding(
            index.def_path(gq), call.line, call.col,
            f'blocking {hazard} in {index.display(gq)}() while '
            f'holding {locks}: every thread contending for the lock '
            'stalls behind this call, and a deadlock if the unblocker '
            'needs the same lock')

  def _hazard(self, tg, gq, call, held):
    if call.dotted == 'time.sleep':
      return 'time.sleep(...)'
    if not call.receiver:
      return None
    recv_canon = tg.canon_lock(gq, call.receiver)
    if call.terminal in ('wait', 'wait_for') and recv_canon in held:
      return None  # Condition.wait releases the lock it waits on
    if (call.terminal in UNBOUNDED_WAIT_ATTRS
        and call.nargs == 0 and call.nkw == 0):
      return f'{call.receiver}.{call.terminal}()'
    if call.terminal == 'wait_for' and call.nkw == 0:
      return f'{call.receiver}.wait_for(...) (no timeout)'
    if call.terminal in self.ALWAYS_BLOCKING:
      return f'{call.receiver}.{call.terminal}(...)'
    return None


def concurrency_rules():
  """Fresh instances of the concurrency ruleset, in rule-id order."""
  return [
      CrossThreadUnlockedState(),
      ThreadLifecycle(),
      LockOrderInversion(),
      SignalHandlerSafety(),
      BlockingCallUnderLock(),
  ]
