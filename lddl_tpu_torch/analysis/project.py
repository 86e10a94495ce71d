"""Whole-program index: every module parsed once, names resolved to
definitions, ready for call-graph construction (the port's copy of
:mod:`lddl_tpu.analysis.project`; its compiled-code roots add torch's).

The per-file engine sees one module at a time; this layer links the
per-module facts (:func:`~lddl_tpu_torch.analysis.engine.extract_module_facts`)
across the project so rules can follow a call through any number of
files. Resolution is deliberately best-effort and *deterministic* —
when a name can't be pinned to exactly one project definition it
resolves to nothing rather than to a guess:

  - module-level names resolve through import aliases, including
    relative imports (anchored at the importing module's package) and
    one level of re-export chasing through package ``__init__`` files;
  - ``self.method()`` / ``cls.method()`` resolve through the enclosing
    class and its project-local bases (a bounded MRO walk);
  - ``x.method()`` resolves when ``x`` was built by a visible
    constructor — a local ``x = ClassName(...)`` (also through a
    ``... if ... else None`` conditional) or a ``self.x = ClassName(...)``
    recorded on the class;
  - ``Cls.apply(...)`` on a project subclass of ``torch.autograd.Function``
    resolves to ``Cls.forward``, which the call runs (a port addition:
    the ring's K/V rotation is such a function);
  - as a last resort, a method name defined by exactly **one** project
    class (and not on the common-vocabulary blacklist below) resolves to
    that class's method.

``ProjectRule`` is the base for interprocedural rules; they run once
over the built index + call graph, not per AST node.
"""

import ast
import os

from .callgraph import CallGraph
from .engine import (COMPILE_WRAPPERS, Rule, analyze_paths,
                     discover_py_files, extract_module_facts)
from .findings import Finding, sort_findings
from .pragmas import is_suppressed, pragma_lines

# Method names too generic to trust the unique-attribute fallback with:
# if exactly one project class defines `frobnicate` the match is
# meaningful; if exactly one happens to define `read` today, resolving
# every `x.read()` there would be wrong tomorrow.
COMMON_ATTRS = frozenset({
    'get', 'put', 'read', 'write', 'open', 'close', 'run', 'start',
    'stop', 'join', 'wait', 'acquire', 'release', 'send', 'recv',
    'update', 'append', 'add', 'extend', 'insert', 'pop', 'clear',
    'copy', 'items', 'keys', 'values', 'submit', 'map', 'apply',
    'result', 'encode', 'decode', 'load', 'save', 'reset', 'flush',
    'next', 'info', 'debug', 'warning', 'error', 'exception', 'name',
})

# The base whose subclasses' ``apply`` runs their ``forward``.
AUTOGRAD_FUNCTION = 'torch.autograd.Function'

_MAX_MRO_DEPTH = 5
_MAX_REEXPORT_DEPTH = 4


def module_name_for(path):
  """Dotted module name for a file, derived by walking up while
  ``__init__.py`` exists (matches what an import of the file would
  bind). A free-standing script is just its stem."""
  path = os.path.abspath(path)
  d, base = os.path.split(path)
  parts = [] if base == '__init__.py' else [os.path.splitext(base)[0]]
  while os.path.isfile(os.path.join(d, '__init__.py')):
    d, pkg = os.path.split(d)
    parts.append(pkg)
  return '.'.join(reversed(parts))


class ProjectIndex:
  """Cross-module definition tables + name resolution."""

  def __init__(self):
    self.modules = {}        # module name -> ModuleFacts
    self.module_is_pkg = {}  # module name -> bool (__init__.py)
    self.defs = {}           # global qualname -> DefFacts
    self.def_module = {}     # global qualname -> module name
    self.classes = {}        # global class qualname -> ClassFacts
    self.class_module = {}
    self.class_methods = {}  # class gq -> {method local name -> def gq}
    self.attr_index = {}     # method name -> sorted tuple of class gqs

  @classmethod
  def build(cls, files, cache=None):
    """Parse + index every file (sorted); unparsable files are skipped
    here — the per-file pass reports them as LDA000. With a ``cache``,
    unchanged files load their pickled ModuleFacts by content hash and
    skip the parse (the dominant cost of a warm project run)."""
    index = cls()
    for path in sorted(files):
      try:
        with open(path, encoding='utf-8') as fh:
          source = fh.read()
      except OSError:
        continue
      module = module_name_for(path)
      if module in index.modules:
        continue  # duplicate module name across roots: first (sorted) wins
      facts = cache.load('facts', path, source) if cache else None
      if facts is None:
        try:
          tree = ast.parse(source, filename=path)
        except (SyntaxError, ValueError):
          continue
        facts = extract_module_facts(tree, path)
        if cache is not None:
          cache.store('facts', path, source, facts)
      index.modules[module] = facts
      index.module_is_pkg[module] = (
          os.path.basename(path) == '__init__.py')
      for dq in facts.defs:
        gq = f'{module}.{dq}' if module else dq
        index.defs[gq] = facts.defs[dq]
        index.def_module[gq] = module
      for cq in facts.classes:
        gq = f'{module}.{cq}' if module else cq
        index.classes[gq] = facts.classes[cq]
        index.class_module[gq] = module
    for gq, d in index.defs.items():
      if not d.cls:
        continue
      module = index.def_module[gq]
      cls_gq = f'{module}.{d.cls}' if module else d.cls
      index.class_methods.setdefault(cls_gq, {})[
          d.qualname.rsplit('.', 1)[-1]] = gq
    attr = {}
    for cls_gq in sorted(index.class_methods):
      for mname in index.class_methods[cls_gq]:
        attr.setdefault(mname, []).append(cls_gq)
    index.attr_index = {m: tuple(v) for m, v in attr.items()}
    return index

  # -- display / location helpers ----------------------------------------

  def def_path(self, gq):
    return self.modules[self.def_module[gq]].path

  def display(self, gq):
    """Module-stripped def qualname ('Executor._map_elastic')."""
    module = self.def_module.get(gq, '')
    return gq[len(module) + 1:] if module and gq.startswith(module) else gq

  # -- name resolution ---------------------------------------------------

  def _absolutize(self, module, dotted):
    if not dotted.startswith('.'):
      return dotted
    level = len(dotted) - len(dotted.lstrip('.'))
    rest = dotted[level:]
    parts = module.split('.') if module else []
    anchor = parts if self.module_is_pkg.get(module) else parts[:-1]
    drop = level - 1
    if drop:
      anchor = anchor[:len(anchor) - drop] if drop <= len(anchor) else []
    return '.'.join(anchor + ([rest] if rest else []))

  def _resolve_global(self, dotted, depth=_MAX_REEXPORT_DEPTH):
    """('def'|'class'|'', gq) for an absolute dotted name, chasing
    re-exports through package __init__ aliases."""
    if dotted in self.defs:
      return 'def', dotted
    if dotted in self.classes:
      return 'class', dotted
    if depth <= 0:
      return '', ''
    # Longest known module prefix, then follow that module's alias for
    # the next segment (the `from .executor import Executor` re-export).
    parts = dotted.split('.')
    for i in range(len(parts) - 1, 0, -1):
      prefix = '.'.join(parts[:i])
      if prefix not in self.modules:
        continue
      first, rest = parts[i], parts[i + 1:]
      al = self.modules[prefix].aliases.get(first)
      if not al:
        return '', ''
      target = self._absolutize(prefix, al)
      return self._resolve_global('.'.join([target] + rest),
                                  depth=depth - 1)
    return '', ''

  def _resolve_in_scope(self, module, scope_path, dotted):
    """('def'|'class'|'', gq) for a dotted name as seen from inside
    ``scope_path`` (a def qualname within ``module``, or '')."""
    if not dotted:
      return '', ''
    if dotted.startswith('.') or '.' in dotted:
      return self._resolve_global(self._absolutize(module, dotted))
    # Plain name: walk enclosing function scopes out to module level.
    # Class frames are skipped — Python name lookup never sees them.
    segs = scope_path.split('.') if scope_path else []
    for i in range(len(segs), -1, -1):
      parent = segs[:i]
      if i:
        parent_gq = '.'.join(([module] if module else []) + parent)
        if parent_gq in self.classes:
          continue
      cand = '.'.join(([module] if module else []) + parent + [dotted])
      if cand in self.defs:
        return 'def', cand
      if cand in self.classes:
        return 'class', cand
    return '', ''

  def mro_method(self, cls_gq, mname, depth=_MAX_MRO_DEPTH):
    """Def gq of ``mname`` on ``cls_gq`` or its project-local bases."""
    methods = self.class_methods.get(cls_gq, {})
    if mname in methods:
      return methods[mname]
    if depth <= 0:
      return ''
    cls = self.classes.get(cls_gq)
    if cls is None:
      return ''
    module = self.class_module.get(cls_gq, '')
    for base in cls.bases:
      kind, bgq = self._resolve_in_scope(module, '', base)
      if kind == 'class' and bgq != cls_gq:
        found = self.mro_method(bgq, mname, depth=depth - 1)
        if found:
          return found
    return ''

  def _resolve_value(self, module, scope_path, dotted):
    """Def gq a dotted *callable* name resolves to (classes resolve to
    their __init__), or ''."""
    kind, gq = self._resolve_in_scope(module, scope_path, dotted)
    if kind == 'def':
      return gq
    if kind == 'class':
      return self.mro_method(gq, '__init__')
    return ''

  def _receiver_class(self, module, caller_gq, receiver):
    """Class gq of a call receiver, via the three typing heuristics
    (self/cls, local ctor, self-attribute ctor)."""
    facts = self.defs.get(caller_gq)
    if facts is None:
      return ''
    scope_path = self.display(caller_gq)
    if receiver in ('self', 'cls'):
      if facts.cls:
        cls_gq = f'{module}.{facts.cls}' if module else facts.cls
        if cls_gq in self.classes:
          return cls_gq
      return ''
    ctor = ''
    if receiver.startswith('self.') and receiver.count('.') == 1:
      if facts.cls:
        cls_gq = f'{module}.{facts.cls}' if module else facts.cls
        cls = self.classes.get(cls_gq)
        if cls is not None:
          ctor = cls.attr_ctors.get(receiver.split('.', 1)[1], '')
    elif '.' not in receiver:
      ctor = facts.var_ctors.get(receiver, '')
    if not ctor:
      return ''
    kind, gq = self._resolve_in_scope(module, scope_path, ctor)
    return gq if kind == 'class' else ''

  def resolve_call(self, caller_gq, call):
    """Def gq one CallSite resolves to, or '' (unresolvable names make
    no edge — missing edges under-approximate, they never invent
    reachability)."""
    module = self.def_module.get(caller_gq, '')
    scope_path = self.display(caller_gq)
    if call.terminal == 'partial' and call.arg0:
      return self._resolve_value(module, scope_path, call.arg0)
    if call.dotted:
      gq = self._resolve_value(module, scope_path, call.dotted)
      if gq:
        return gq
    if call.receiver:
      cls_gq = self._receiver_class(module, caller_gq, call.receiver)
      if cls_gq:
        found = self.mro_method(cls_gq, call.terminal)
        if found:
          return found
      if call.terminal == 'apply':
        kind, fn_gq = self._resolve_in_scope(module, scope_path,
                                             call.receiver)
        if kind == 'class' and AUTOGRAD_FUNCTION in self.classes[
            fn_gq].bases:
          return self.mro_method(fn_gq, 'forward')
      if call.terminal not in COMMON_ATTRS:
        owners = self.attr_index.get(call.terminal, ())
        if len(owners) == 1:
          return self.class_methods[owners[0]][call.terminal]
    return ''

  def jit_root_defs(self):
    """Def gqs whose bodies become traced/compiled code: defs decorated
    with jit/shard_map/pallas_call (directly or through
    functools.partial) or ``torch.compile``, plus functions passed to
    ``jax.jit(f)`` / ``shard_map(f)`` / ``pallas_call(f)`` /
    ``CompiledStepCache(f)`` call sites (including ``step_fn =
    jax.jit(step)`` wrapping), and torch's: ``torch.compile(f)``,
    ``torch.cuda.make_graphed_callables(f, ...)`` and ``capture_step``'s
    ``body`` (``self.step.body``, ``lambda: self._bodies(x, k)``), typed
    as :meth:`resolve_call` types a call from the wrapping scope."""
    roots = []
    for module in sorted(self.modules):
      facts = self.modules[module]
      for dq in sorted(facts.defs):
        d = facts.defs[dq]
        for dec in d.decorators:
          if (dec.rsplit('.', 1)[-1] in ('jit', 'shard_map', 'pallas_call')
              or dec in COMPILE_WRAPPERS):
            roots.append((f'{module}.{dq}' if module else dq, dec))
            break
      for arg0, scope, _line in facts.jit_roots:
        gq = self._resolve_value(module, scope, arg0)
        if gq:
          roots.append((gq, 'wrapped'))
      for site, scope, _line in facts.compiled_roots:
        if scope:
          gq = self.resolve_call(f'{module}.{scope}' if module else scope,
                                 site)
        else:
          gq = self._resolve_value(module, '', site.dotted)
        if gq:
          roots.append((gq, 'captured'))
    out = {}
    for gq, how in roots:
      out.setdefault(gq, how)
    return out


class ProjectRule:
  """Base for interprocedural rules: runs once over the whole project
  (index + call graph), not per AST node. Same metadata contract as the
  per-file :class:`~lddl_tpu_torch.analysis.engine.Rule`."""

  rule_id = ''
  name = ''
  invariant = ''
  hint = ''

  def check(self, index, graph):
    """Yield findings over the built project."""
    return ()

  def finding(self, path, line, col, message, chain=None, chains=None,
              hint=None):
    return Finding(
        rule_id=self.rule_id, path=path, line=line, col=col,
        message=message, hint=self.hint if hint is None else hint,
        chain=chain, chains=chains)


def build_chain(index, hops, target_gq, effect):
  """Findings' ``chain`` field: the call path root → ... → effect.

  ``hops`` come from :meth:`CallGraph.chain_hops` (each with the line of
  the call it makes toward the target); the target definition and the
  effect site close the chain.
  """
  chain = [{'name': f'{index.display(gq)}()', 'path': index.def_path(gq),
            'line': line} for gq, line in hops]
  chain.append({'name': f'{index.display(target_gq)}()',
                'path': index.def_path(target_gq),
                'line': index.defs[target_gq].line})
  chain.append({'name': effect.detail, 'path': index.def_path(target_gq),
                'line': effect.line})
  return chain


def analyze_project(paths, rules=None, jobs=None, file_filter=None,
                    cache=None):
  """Whole-program analysis: the per-file rules over every ``.py`` under
  ``paths`` (parallel when ``jobs`` allows) plus the interprocedural
  project rules over the linked index.

  Returns ``(findings, files_scanned)`` like :func:`analyze_paths`;
  project findings honor the same ``# lddl: noqa[...]`` pragmas, applied
  at the effect/call site they are anchored to.

  ``file_filter`` (a set of absolute paths, from ``--changed``)
  restricts the *per-file* pass to those files while the index and the
  project rules still cover the whole tree — interprocedural claims
  need every module, and the caller filters project findings down to
  the ones whose chains touch the filter. ``files_scanned`` stays the
  full tree count for the same reason. ``cache`` accelerates both
  passes (cached findings + cached per-module facts).
  """
  if rules is None:
    file_rules = None
    from .rules import project_rules
    proj_rules = project_rules()
  else:
    file_rules = [r for r in rules if isinstance(r, Rule)]
    proj_rules = [r for r in rules if isinstance(r, ProjectRule)]
  files = discover_py_files(paths)
  if file_filter is None:
    findings, files_scanned = analyze_paths(paths, rules=file_rules,
                                            jobs=jobs, cache=cache)
  else:
    targets = [p for p in files if os.path.abspath(p) in file_filter]
    findings, _ = analyze_paths(targets, rules=file_rules, jobs=jobs,
                                cache=cache)
    files_scanned = len(files)
  index = ProjectIndex.build(files, cache=cache)
  graph = CallGraph(index)
  project_findings = []
  for rule in proj_rules:
    project_findings.extend(rule.check(index, graph))
  pragma_cache = {}
  for f in project_findings:
    if f.path not in pragma_cache:
      try:
        with open(f.path, encoding='utf-8') as fh:
          pragma_cache[f.path] = pragma_lines(fh.read())
      except OSError:
        pragma_cache[f.path] = {}
    if pragma_cache[f.path]:
      f.suppressed = is_suppressed(f, pragma_cache[f.path])
  return sort_findings(findings + project_findings), files_scanned
