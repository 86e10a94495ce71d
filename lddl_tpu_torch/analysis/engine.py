"""AST visitor engine: one parse + one ancestor-tracking walk per file,
with every registered rule riding the same traversal (the port's copy of
:mod:`lddl_tpu.analysis.engine`, with torch's spellings beside JAX's:
:data:`COLLECTIVES`, :data:`COMPILE_WRAPPERS`, :data:`CAPTURE_BODY_ARGS`,
:data:`HOST_SYNC_METHODS`).

The engine owns the cross-cutting machinery rules should not reimplement:

  - import-alias resolution, so ``import numpy as np; np.random.rand()``
    and ``from random import shuffle; shuffle(x)`` both resolve to their
    canonical dotted names (``numpy.random.rand`` / ``random.shuffle``) —
    including relative imports, which keep their leading dots so
    ``from ..core import random as lrandom`` can never be mistaken for
    the stdlib ``random`` module;
  - ancestor chains (``ctx.ancestors``), so rules can ask "is this call
    wrapped in ``sorted(...)``?" or "is this node under a ``with`` item?"
    without bookkeeping of their own;
  - pragma-based suppression and deterministic finding order.

Rules subclass :class:`Rule`: ``begin_module`` runs once per file (for
scope/taint pre-passes), ``on_node`` runs for every AST node.
"""

import ast
import concurrent.futures
import dataclasses
import os

from .findings import Finding, sort_findings
from .pragmas import is_suppressed, pragma_lines

# Identifiers that gate code on rank identity (shared with rules.LDA005
# and the interprocedural LDA008: both must agree on what "rank-
# conditional" means or findings would shift between modes).
RANK_IDENTS = frozenset({
    'process_index', 'process_id', 'is_primary', 'is_coordinator',
    'is_main_process',
})


def rank_mention(test):
  """First identifier in ``test`` that smells like a rank check, or
  None. Matches bare/attribute names containing ``rank`` and the
  conventional jax/launcher spellings in :data:`RANK_IDENTS`."""
  for node in ast.walk(test):
    ident = None
    if isinstance(node, ast.Name):
      ident = node.id
    elif isinstance(node, ast.Attribute):
      ident = node.attr
    if ident and ('rank' in ident.lower() or ident in RANK_IDENTS):
      return ident
  return None


class Rule:
  """Base class for one ``LDAxxx`` check."""

  rule_id = ''
  name = ''
  # One line: the pipeline invariant this rule protects (docs + --list-rules).
  invariant = ''
  hint = ''

  def exempt(self, ctx):
    """Whether this rule is off for ``ctx.path`` (e.g. LDA002 inside the
    seeded-RNG module itself). Default: applies everywhere."""
    return False

  def begin_module(self, ctx):
    """Per-file pre-pass; may yield findings."""
    return ()

  def on_node(self, node, ctx):
    """Per-node check; may yield findings."""
    return ()

  def finding(self, node, message, ctx, hint=None):
    return Finding(
        rule_id=self.rule_id,
        path=ctx.path,
        line=getattr(node, 'lineno', 1),
        col=getattr(node, 'col_offset', 0) + 1,
        message=message,
        hint=self.hint if hint is None else hint,
        end_line=getattr(node, 'end_lineno', 0) or 0,
    )


class ModuleContext:
  """Everything rules may want to know about the file being analyzed."""

  def __init__(self, tree, path, source):
    self.tree = tree
    self.path = path
    self.source = source
    # Normalized forward-slash path for rule exemption matching.
    self.norm_path = os.path.abspath(path).replace(os.sep, '/')
    self.aliases = _import_aliases(tree)
    self.aliases.update(_local_aliases(tree, self.aliases))
    self.ancestors = ()  # set by the walker before each on_node dispatch

  def path_is(self, *fragments):
    """Whether the file lives under any of the given path fragments
    (``'telemetry/'``, ``'core/random.py'``, ...)."""
    return any(f'/{frag}' in self.norm_path or
               self.norm_path.endswith(f'/{frag.rstrip("/")}')
               for frag in fragments)

  def basename(self):
    return os.path.basename(self.norm_path)

  def qualname(self, node):
    """Canonical dotted name of an attribute/name chain, resolved through
    this module's import aliases; None when the chain does not bottom out
    in a plain name (e.g. a call result: ``Path(p).glob(...)``)."""
    parts = []
    while isinstance(node, ast.Attribute):
      parts.append(node.attr)
      node = node.value
    if not isinstance(node, ast.Name):
      return None
    parts.append(self.aliases.get(node.id, node.id))
    return '.'.join(reversed(parts))

  def call_name(self, call):
    """(dotted, terminal) for a Call: the resolved dotted name (or None)
    and the last attribute/name segment (always available)."""
    dotted = self.qualname(call.func)
    if isinstance(call.func, ast.Attribute):
      return dotted, call.func.attr
    if isinstance(call.func, ast.Name):
      return dotted, call.func.id
    return dotted, ''

  def enclosing(self, *types):
    """Nearest ancestor of the given AST types (innermost first)."""
    for node in reversed(self.ancestors):
      if isinstance(node, types):
        return node
    return None


def _import_aliases(tree):
  """local name -> canonical dotted origin, from every import statement.

  ``import numpy as np`` -> ``np: numpy``; ``import a.b`` -> ``a: a``;
  ``from x.y import z as w`` -> ``w: x.y.z``; relative imports keep
  their dots (``from ..core import random`` -> ``random: ..core.random``)
  so they can never collide with an absolute stdlib name.
  """
  aliases = {}
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        if a.asname:
          aliases[a.asname] = a.name
        else:
          root = a.name.split('.')[0]
          aliases[root] = root
    elif isinstance(node, ast.ImportFrom):
      base = '.' * node.level + (node.module or '')
      for a in node.names:
        if a.name == '*':
          continue
        sep = '' if base.endswith('.') or not base else '.'
        aliases[a.asname or a.name] = f'{base}{sep}{a.name}'
  return aliases


def _qual_of(node, aliases):
  """Dotted name of a Name/Attribute chain resolved through ``aliases``,
  or None (standalone twin of :meth:`ModuleContext.qualname`)."""
  parts = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if not isinstance(node, ast.Name):
    return None
  parts.append(aliases.get(node.id, node.id))
  return '.'.join(reversed(parts))


def _local_aliases(tree, import_aliases):
  """local name -> canonical dotted origin for simple rebindings.

  ``rng = random`` or ``jit = jax.jit`` makes every later use of the
  new name opaque to pure import-alias resolution — the known
  false-negative hole in LDA002/LDA005. A name qualifies only when it
  is bound exactly once in the whole module (any rebinding, loop
  target, or parameter shadow disqualifies it) and that one binding is
  a plain ``x = name.chain`` assignment, so the alias can never be
  stale. Alias-of-alias chains resolve via a short fixed point.
  """
  bind_counts = {}

  def bump(name):
    bind_counts[name] = bind_counts.get(name, 0) + 1

  for node in ast.walk(tree):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
      bump(node.name)
    elif isinstance(node, (ast.Import, ast.ImportFrom)):
      for a in node.names:
        bump((a.asname or a.name).split('.')[0])
    elif isinstance(node, ast.arg):
      bump(node.arg)
    elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                   (ast.Store, ast.Del)):
      bump(node.id)

  candidates = {}
  for node in ast.walk(tree):
    if (isinstance(node, ast.Assign) and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
        and isinstance(node.value, (ast.Name, ast.Attribute))
        and bind_counts.get(node.targets[0].id, 0) == 1):
      candidates[node.targets[0].id] = node.value

  out = {}
  for _ in range(3):  # bounded fixed point for alias-of-alias chains
    changed = False
    merged = dict(import_aliases)
    merged.update(out)
    for name, value in sorted(candidates.items()):
      if name in out:
        continue
      dotted = _qual_of(value, merged)
      if dotted and dotted.split('.')[0] != name:
        out[name] = dotted
        changed = True
    if not changed:
      break
  return out


def walk_with_ancestors(tree):
  """Yield ``(node, ancestors)`` for every node; ancestors are outermost
  first and exclude the node itself."""
  stack = [(tree, ())]
  while stack:
    node, anc = stack.pop()
    yield node, anc
    child_anc = anc + (node,)
    for child in ast.iter_child_nodes(node):
      stack.append((child, child_anc))


# ---------------------------------------------------------------------------
# Per-module facts export (project mode).
#
# ``extract_module_facts`` distills one parsed module into the flat,
# picklable facts the whole-program layer needs: every definition with
# its resolved calls, lexical effects, decorators, and branch structure.
# The project index (analysis/project.py) links these across modules
# into a call graph; nothing here looks outside the file.
# ---------------------------------------------------------------------------

# Cross-rank collective operations (the repo's comm vocabulary plus the
# jax multihost spellings, and torch.distributed's for the same effects).
# Shared with rules.LDA005/LDA008/LDA009. Attribute calls match by method
# name, so torch's ``gather``/``scatter`` stay out: they are tensor
# methods too.
COLLECTIVES = frozenset({
    'allgather_object', 'allreduce_sum', 'broadcast_object', 'barrier',
    'allreduce', 'allgather', 'broadcast', 'reduce_scatter', 'all_to_all',
    'sync_global_devices', 'process_allgather',
    'all_reduce', 'all_gather', 'all_gather_object',
    'all_gather_into_tensor', 'reduce_scatter_tensor',
    'broadcast_object_list', 'batch_isend_irecv', 'monitored_barrier',
    'all_to_all_single',
})

# Dotted prefixes whose ``allgather``/``all_to_all``-style terminals are
# *device* collectives (legal inside jit/shard_map), not host-blocking
# cross-rank ones.
DEVICE_COLLECTIVE_PREFIXES = ('numpy.', 'jax.lax.', 'jax.numpy.')

# Wrappers whose function argument becomes traced/compiled code.
JIT_WRAPPERS = frozenset({'jit', 'shard_map', 'pallas_call',
                          'CompiledStepCache'})

# torch's compiled code: the wrappers (by resolved dotted name) whose
# first argument is compiled or captured (``torch.compile`` is a decorator
# too), and the calls whose ``body`` argument -- by position, or
# ``body=`` -- is captured into a CUDA graph. ``capture_step``'s
# ``warm_up`` runs eagerly and may sync.
COMPILE_WRAPPERS = frozenset({'torch.compile',
                              'torch.cuda.make_graphed_callables'})
CAPTURE_BODY_ARGS = {'capture_step': 2}

# Zero-argument methods that copy a tensor to the host or wait for the
# device (torch's counterparts of ``.item()``/``.block_until_ready()``).
HOST_SYNC_METHODS = frozenset({'cpu', 'tolist', 'numpy', 'synchronize'})

# ``x.join()`` / ``x.wait()`` / ``x.get()`` / ``x.acquire()`` with *no*
# arguments: a wait with no timeout, unbounded by construction. The
# zero-arg requirement keeps ``os.path.join(a, b)``, ``sep.join(parts)``
# and ``q.get(timeout=...)`` out.
UNBOUNDED_WAIT_ATTRS = frozenset({'join', 'wait', 'acquire', 'get'})

# Method calls that mutate their receiver in place: ``self.buf.append(x)``
# is a *write* to the shared object behind ``self.buf``, not a read.
MUTATOR_METHODS = frozenset({
    'append', 'appendleft', 'extend', 'extendleft', 'insert', 'add',
    'update', 'pop', 'popleft', 'popitem', 'remove', 'discard', 'clear',
    'setdefault', 'sort', 'reverse', 'rotate',
})


@dataclasses.dataclass
class CallSite:
  """One call expression inside a definition."""
  dotted: str        # alias-resolved dotted name ('' when unresolvable)
  terminal: str      # last name segment (always available)
  receiver: str      # dotted chain of an attribute call's receiver, or ''
  line: int
  col: int
  nargs: int
  nkw: int
  arg0: str          # dotted name of first positional arg, or ''
  rank_cond: str     # gating rank identifier when under a rank branch
  locks: tuple = ()  # dotted `with` contexts lexically held at the call


@dataclasses.dataclass
class EffectSite:
  """One lexical effect (collective, host_sync, ...) at a location."""
  kind: str
  detail: str
  line: int
  col: int


@dataclasses.dataclass
class AccessSite:
  """One read or write of shared state inside a definition: a ``self.X``
  attribute (``scope='self'``) or a module global (``scope='global'``,
  recorded only in modules with a ``global`` statement naming it)."""
  attr: str          # attribute / global name
  kind: str          # 'read' | 'write'
  scope: str         # 'self' | 'global'
  line: int
  col: int
  locks: tuple = ()  # dotted `with` contexts lexically held at the access


@dataclasses.dataclass
class SpawnSite:
  """One ``Thread(target=...)`` / ``Process(target=...)`` construction."""
  ctor: str          # 'Thread' | 'Process'
  target: str        # dotted target name ('' for lambdas/opaque values)
  binding: str       # name the object binds to: 'self.X', a local, or ''
  daemon: object     # True/False when a literal daemon= kwarg, else None
  line: int
  col: int


@dataclasses.dataclass
class AcquireSite:
  """One ``with <lock-like name>:`` entry (no-call context expressions
  only — ``with open(...)`` is a resource, never a lock candidate)."""
  name: str          # dotted context name ('self._lock', 'window_lock')
  line: int
  col: int
  held: tuple = ()   # dotted contexts already held when this one enters


@dataclasses.dataclass
class BranchFacts:
  """One ``if`` statement and the call indices in each arm, in source
  order (indices into the owning DefFacts.calls)."""
  line: int
  body: list
  orelse: list


@dataclasses.dataclass
class DefFacts:
  """One function/method definition."""
  qualname: str      # dotted within the module ('Executor._map_elastic')
  line: int
  cls: str           # immediately enclosing class qualname, or ''
  decorators: tuple  # resolved dotted decorator names
  calls: list        # [CallSite]
  effects: list      # [EffectSite]
  var_ctors: dict    # local var -> dotted ctor name it was built from
  branches: list     # [BranchFacts]
  accesses: list = dataclasses.field(default_factory=list)  # [AccessSite]
  spawns: list = dataclasses.field(default_factory=list)    # [SpawnSite]
  acquires: list = dataclasses.field(default_factory=list)  # [AcquireSite]


@dataclasses.dataclass
class ClassFacts:
  qualname: str
  line: int
  bases: tuple       # resolved dotted base names
  attr_ctors: dict   # 'self.X = Ctor(...)' in any method -> {X: ctor}


@dataclasses.dataclass
class ModuleFacts:
  path: str
  defs: dict         # def qualname -> DefFacts
  classes: dict      # class qualname -> ClassFacts
  jit_roots: list    # [(arg0_dotted, scope_qualname, line)] from
                     # jit(f)/shard_map(f)/pallas_call(f)/CompiledStepCache(f)
  aliases: dict      # local name -> dotted origin (for re-export chasing)
  signal_handlers: list = dataclasses.field(default_factory=list)
                     # [(handler_dotted, scope_qualname, line)] from
                     # signal.signal(sig, handler) registrations
  compiled_roots: list = dataclasses.field(default_factory=list)
                     # [(CallSite, scope_qualname, line)]: the function a
                     # torch.compile/make_graphed_callables/capture_step
                     # body argument names (a lambda: the call it makes),
                     # as a call site resolve_call can type


def _scope_chain(ancestors, node):
  """Enclosing def/class AST nodes of ``node``, outermost first,
  counting only scopes entered through their *body*: a node hanging off
  a def's decorator list or signature belongs to the outer scope —
  decorators evaluate at definition time, not inside the function."""
  chain = list(ancestors) + [node]
  scopes = []
  for i, anc in enumerate(chain[:-1]):
    if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.ClassDef)):
      if any(chain[i + 1] is stmt for stmt in anc.body):
        scopes.append(anc)
  return scopes


def _owner_def_qualname(scopes):
  """Qualname of the innermost enclosing *function* in ``scopes`` (its
  path may pass through classes), or '' for module/class-level code."""
  idx = None
  for i in range(len(scopes) - 1, -1, -1):
    if isinstance(scopes[i], (ast.FunctionDef, ast.AsyncFunctionDef)):
      idx = i
      break
  if idx is None:
    return ''
  return '.'.join(s.name for s in scopes[:idx + 1])


def _with_locks(chain, aliases):
  """Dotted ``with``-context names lexically held at the innermost node
  of ``chain`` (ancestors + node, outermost first): every ``with`` whose
  *body* the path passes through, inside the innermost enclosing
  function. Only plain Name/Attribute contexts count — ``with
  open(...)`` is a resource, not a lock candidate — and contexts from an
  enclosing def don't leak into nested defs (which run later, lock-free).
  """
  last_def = -1
  for i, anc in enumerate(chain[:-1]):
    if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)) \
        and any(chain[i + 1] is stmt for stmt in anc.body):
      last_def = i
  held = []
  for i, anc in enumerate(chain[:-1]):
    if i <= last_def or not isinstance(anc, (ast.With, ast.AsyncWith)):
      continue
    if not any(chain[i + 1] is stmt for stmt in anc.body):
      continue
    for item in anc.items:
      dotted = _qual_of(item.context_expr, aliases)
      if dotted:
        held.append(dotted)
  return tuple(held)


def _access_kind(node, ancestors):
  """'read'/'write' for an attribute/name access node. A Store/Del
  context, a store through a subscript or sub-attribute
  (``self.X[k] = v``, ``self.X.y = v``), and an in-place mutator call
  (``self.X.append(v)``) are all writes to the shared object."""
  if isinstance(node.ctx, (ast.Store, ast.Del)):
    return 'write'
  parent = ancestors[-1] if ancestors else None
  if isinstance(parent, ast.Attribute) and parent.value is node:
    if isinstance(parent.ctx, (ast.Store, ast.Del)):
      return 'write'
    gp = ancestors[-2] if len(ancestors) >= 2 else None
    if (isinstance(gp, ast.Call) and gp.func is parent
        and parent.attr in MUTATOR_METHODS):
      return 'write'
  elif (isinstance(parent, ast.Subscript) and parent.value is node
        and isinstance(parent.ctx, (ast.Store, ast.Del))):
    return 'write'
  return 'read'


def _arm_of(if_node, child):
  """'body'/'orelse' when ``child`` (an immediate AST child of
  ``if_node``) sits in that arm, else None (e.g. inside the test)."""
  if any(child is stmt for stmt in if_node.body):
    return 'body'
  if any(child is stmt for stmt in if_node.orelse):
    return 'orelse'
  return None


def _decorator_names(node, aliases):
  """Resolved dotted names of a def's decorators. ``functools.partial(
  jax.jit, ...)`` resolves to its first argument — the wrapper that
  actually applies."""
  out = []
  for dec in node.decorator_list:
    if isinstance(dec, ast.Call):
      fn = _qual_of(dec.func, aliases) or ''
      if fn.rsplit('.', 1)[-1] == 'partial' and dec.args:
        inner = _qual_of(dec.args[0], aliases)
        if inner:
          out.append(inner)
          continue
      if fn:
        out.append(fn)
    else:
      fn = _qual_of(dec, aliases)
      if fn:
        out.append(fn)
  return tuple(out)


def _first_fn_arg(call, aliases):
  """Dotted name of the function a wrapper call wraps: the first
  positional arg, unwrapping one level of ``functools.partial``."""
  if not call.args:
    return ''
  a = call.args[0]
  if isinstance(a, ast.Call):
    fn = _qual_of(a.func, aliases) or ''
    if fn.rsplit('.', 1)[-1] == 'partial' and a.args:
      a = a.args[0]
    else:
      return ''
  return _qual_of(a, aliases) or ''


def _fn_site(node, aliases, line, col):
  """A :class:`CallSite` for the function a compiled-root argument names,
  or None: a Name/Attribute (``self.step.body``), one level of
  ``functools.partial`` unwrapped, or a lambda whose body is a call (the
  call it makes)."""
  if isinstance(node, ast.Lambda):
    if not isinstance(node.body, ast.Call):
      return None
    node = node.body.func
  elif isinstance(node, ast.Call):
    fn = _qual_of(node.func, aliases) or ''
    if fn.rsplit('.', 1)[-1] != 'partial' or not node.args:
      return None
    node = node.args[0]
  dotted = _qual_of(node, aliases)
  if not dotted:
    return None
  if isinstance(node, ast.Attribute):
    terminal, receiver = node.attr, _qual_of(node.value, aliases)
  else:
    terminal, receiver = node.id, ''
  return CallSite(dotted=dotted, terminal=terminal, receiver=receiver,
                  line=line, col=col, nargs=0, nkw=0, arg0='', rank_cond='')


def _compiled_arg(call, dotted, terminal):
  """The argument node of ``call`` that becomes compiled or captured
  code under torch's spellings, or None."""
  if dotted in COMPILE_WRAPPERS:
    return call.args[0] if call.args else None
  if terminal in CAPTURE_BODY_ARGS:
    i = CAPTURE_BODY_ARGS[terminal]
    if len(call.args) > i:
      return call.args[i]
    for kw in call.keywords:
      if kw.arg == 'body':
        return kw.value
  return None


def _call_effects(call, dotted, terminal, receiver, aliases):
  """Lexical ``(kind, detail)`` effects of one call expression."""
  del aliases  # resolution already folded into ``dotted``
  d = dotted or ''
  nargs, nkw = len(call.args), len(call.keywords)
  effects = []
  # Attribute calls are collectives by method name; bare names only when
  # alias resolution proves the origin (mirrors rules.LDA005 — a local
  # function that happens to be named `barrier` is not one).
  if isinstance(call.func, ast.Attribute):
    coll = terminal if terminal in COLLECTIVES else ''
  else:
    coll = (d.rsplit('.', 1)[-1]
            if '.' in d and d.rsplit('.', 1)[-1] in COLLECTIVES else '')
  if coll and not d.startswith(DEVICE_COLLECTIVE_PREFIXES):
    effects.append(('collective', coll))
  if d.startswith('time.'):
    effects.append(('wall_clock', f'{d}()'))
  if terminal == 'item' and receiver and nargs == 0:
    effects.append(('host_sync', f'{receiver}.item()'))
  elif (d in ('float', 'bool') and nargs == 1
        and not isinstance(call.args[0], ast.Constant)):
    effects.append(('host_sync', f'{d}()'))
  elif d in ('numpy.asarray', 'jax.device_get'):
    effects.append(('host_sync', f'{d}()'))
  elif terminal == 'block_until_ready':
    effects.append(('host_sync', '.block_until_ready()'))
  elif (terminal in HOST_SYNC_METHODS and receiver and nargs == 0
        and nkw == 0):
    effects.append(('host_sync', f'{receiver}.{terminal}()'))
  elif d == 'torch.cuda.synchronize':
    effects.append(('host_sync', 'torch.cuda.synchronize()'))
  if d == 'open' or d.startswith('subprocess.'):
    effects.append(('blocking_io', f'{d}()'))
  if (terminal in ('Thread', 'Process')
      and any(kw.arg == 'target' for kw in call.keywords)):
    effects.append(('thread_spawn', terminal))
  if (receiver and terminal in UNBOUNDED_WAIT_ATTRS
      and nargs == 0 and nkw == 0):
    effects.append(('unbounded_wait', f'{receiver}.{terminal}()'))
  return effects


def extract_module_facts(tree, path, aliases=None):
  """Distill one parsed module into :class:`ModuleFacts`.

  Calls/effects inside each definition are recorded in source order;
  module-level and class-level statements (which run at import time,
  uniformly on every rank) are not attributed to any definition.
  """
  if aliases is None:
    aliases = _import_aliases(tree)
    aliases.update(_local_aliases(tree, aliases))
  defs = {}
  classes = {}
  jit_roots = []
  compiled_roots = []
  signal_handlers = []
  # def qualname -> [(CallSite, [(if line, arm)])]; sorted per def at the end
  raw_calls = {}
  # def qualname -> {if line: If node}
  def_ifs = {}
  # Names declared ``global`` anywhere in the module: accesses to these
  # are shared state worth tracking. Collected up front because the main
  # walk's traversal order gives no ordering guarantee between a
  # ``global`` statement and the uses it governs.
  global_names = set()
  for n in ast.walk(tree):
    if isinstance(n, ast.Global):
      global_names.update(n.names)

  for node, ancestors in walk_with_ancestors(tree):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      scopes = _scope_chain(ancestors, node)
      qual = '.'.join([s.name for s in scopes] + [node.name])
      cls = ''
      if scopes and isinstance(scopes[-1], ast.ClassDef):
        cls = '.'.join(s.name for s in scopes)
      if qual not in defs:
        defs[qual] = DefFacts(
            qualname=qual, line=node.lineno, cls=cls,
            decorators=_decorator_names(node, aliases),
            calls=[], effects=[], var_ctors={}, branches=[])
      continue
    if isinstance(node, ast.ClassDef):
      scopes = _scope_chain(ancestors, node)
      qual = '.'.join([s.name for s in scopes] + [node.name])
      bases = tuple(b for b in (_qual_of(b, aliases) for b in node.bases)
                    if b)
      if qual not in classes:
        classes[qual] = ClassFacts(qualname=qual, line=node.lineno,
                                   bases=bases, attr_ctors={})
      continue

    scopes = _scope_chain(ancestors, node)
    owner = _owner_def_qualname(scopes)

    if isinstance(node, ast.Assign) and owner and owner in defs:
      value = node.value
      if isinstance(value, ast.IfExp):
        # `writer = Ctor() if flag else None`: either branch may type
        # the receiver; prefer the one that is a constructor call.
        value = (value.body if isinstance(value.body, ast.Call)
                 else value.orelse)
      if isinstance(value, ast.Call):
        ctor = _qual_of(value.func, aliases)
        if ctor and len(node.targets) == 1:
          tgt = node.targets[0]
          if isinstance(tgt, ast.Name):
            defs[owner].var_ctors.setdefault(tgt.id, ctor)
          elif (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == 'self' and defs[owner].cls in classes):
            classes[defs[owner].cls].attr_ctors.setdefault(tgt.attr, ctor)
      continue

    if isinstance(node, ast.If) and owner and owner in defs:
      def_ifs.setdefault(owner, {})[node.lineno] = node
      continue

    if isinstance(node, (ast.With, ast.AsyncWith)) and owner in defs:
      held = list(_with_locks(list(ancestors) + [node], aliases))
      for item in node.items:
        dotted = _qual_of(item.context_expr, aliases)
        if dotted:
          defs[owner].acquires.append(AcquireSite(
              name=dotted, line=node.lineno, col=node.col_offset + 1,
              held=tuple(held)))
          held.append(dotted)  # `with a, b:` — b enters with a held
      # fall through: nothing else to record on the With node itself

    if (isinstance(node, ast.Attribute) and owner in defs
        and isinstance(node.value, ast.Name) and node.value.id == 'self'):
      parent = ancestors[-1] if ancestors else None
      # `self.method()` is a call (a CallSite), not a state access.
      if not (isinstance(parent, ast.Call) and parent.func is node):
        defs[owner].accesses.append(AccessSite(
            attr=node.attr, kind=_access_kind(node, ancestors),
            scope='self', line=node.lineno, col=node.col_offset + 1,
            locks=_with_locks(list(ancestors) + [node], aliases)))
      continue

    if (global_names and isinstance(node, ast.Name)
        and node.id in global_names and owner in defs):
      parent = ancestors[-1] if ancestors else None
      if not (isinstance(parent, ast.Call) and parent.func is node):
        defs[owner].accesses.append(AccessSite(
            attr=node.id, kind=_access_kind(node, ancestors),
            scope='global', line=node.lineno, col=node.col_offset + 1,
            locks=_with_locks(list(ancestors) + [node], aliases)))
      continue

    if not isinstance(node, ast.Call):
      continue

    dotted = _qual_of(node.func, aliases) or ''
    if isinstance(node.func, ast.Attribute):
      terminal = node.func.attr
      receiver = _qual_of(node.func.value, aliases) or ''
    elif isinstance(node.func, ast.Name):
      terminal = node.func.id
      receiver = ''
    else:
      terminal, receiver = '', ''

    if terminal in JIT_WRAPPERS:
      arg0_fn = _first_fn_arg(node, aliases)
      if arg0_fn:
        jit_roots.append((arg0_fn, owner, node.lineno))
    compiled = _compiled_arg(node, dotted, terminal)
    if compiled is not None:
      site = _fn_site(compiled, aliases, node.lineno, node.col_offset + 1)
      if site is not None:
        compiled_roots.append((site, owner, node.lineno))

    if dotted == 'signal.signal' and len(node.args) >= 2:
      handler = _qual_of(node.args[1], aliases) or ''
      if handler:  # lambdas/opaque handlers can't be followed
        signal_handlers.append((handler, owner, node.lineno))

    if not owner or owner not in defs:
      continue

    if (terminal in ('Thread', 'Process')
        and any(kw.arg == 'target' for kw in node.keywords)):
      target, daemon = '', None
      for kw in node.keywords:
        if kw.arg == 'target':
          target = _qual_of(kw.value, aliases) or ''
        elif kw.arg == 'daemon' and isinstance(kw.value, ast.Constant):
          daemon = bool(kw.value.value)
      binding = ''
      parent = ancestors[-1] if ancestors else None
      if (isinstance(parent, ast.Assign) and parent.value is node
          and len(parent.targets) == 1):
        tgt_node = parent.targets[0]
        if isinstance(tgt_node, ast.Name):
          binding = tgt_node.id
        elif (isinstance(tgt_node, ast.Attribute)
              and isinstance(tgt_node.value, ast.Name)
              and tgt_node.value.id == 'self'):
          binding = f'self.{tgt_node.attr}'
      defs[owner].spawns.append(SpawnSite(
          ctor=terminal, target=target, binding=binding, daemon=daemon,
          line=node.lineno, col=node.col_offset + 1))

    # Innermost owning def node: If-ancestors beyond it gate this call.
    owner_node = None
    for s in reversed(scopes):
      if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
        owner_node = s
        break
    arms = []
    rank_cond = ''
    past_owner = False
    chain = list(ancestors) + [node]
    for i, anc in enumerate(chain[:-1]):
      if anc is owner_node:
        past_owner = True
        continue
      if not past_owner or not isinstance(anc, ast.If):
        continue
      arm = _arm_of(anc, chain[i + 1])
      if arm is None:
        continue
      arms.append((anc.lineno, arm))
      if not rank_cond:
        ident = rank_mention(anc.test)
        if ident:
          rank_cond = ident

    arg0 = ''
    if node.args and isinstance(node.args[0], (ast.Name, ast.Attribute)):
      arg0 = _qual_of(node.args[0], aliases) or ''
    site = CallSite(
        dotted=dotted, terminal=terminal, receiver=receiver,
        line=node.lineno, col=node.col_offset + 1,
        nargs=len(node.args), nkw=len(node.keywords), arg0=arg0,
        rank_cond=rank_cond, locks=_with_locks(chain, aliases))
    raw_calls.setdefault(owner, []).append((site, arms))
    for kind, detail in _call_effects(node, dotted, terminal, receiver,
                                      aliases):
      defs[owner].effects.append(
          EffectSite(kind=kind, detail=detail, line=node.lineno,
                     col=node.col_offset + 1))

  for owner, entries in raw_calls.items():
    entries.sort(key=lambda e: (e[0].line, e[0].col))
    facts = defs[owner]
    facts.calls = [site for site, _ in entries]
    arm_map = {}  # if line -> {'body': [...], 'orelse': [...]}
    for idx, (_, arms) in enumerate(entries):
      for if_line, arm in arms:
        arm_map.setdefault(if_line, {'body': [], 'orelse': []})
        arm_map[if_line][arm].append(idx)
    for if_line in sorted(def_ifs.get(owner, {})):
      arms = arm_map.get(if_line, {'body': [], 'orelse': []})
      facts.branches.append(
          BranchFacts(line=if_line, body=arms['body'],
                      orelse=arms['orelse']))
  for facts in defs.values():
    facts.effects.sort(key=lambda e: (e.line, e.col, e.kind))
    facts.accesses.sort(key=lambda a: (a.line, a.col, a.attr, a.kind))
    facts.spawns.sort(key=lambda s: (s.line, s.col))
    facts.acquires.sort(key=lambda a: (a.line, a.col, a.name))
  jit_roots.sort(key=lambda r: (r[2], r[0]))
  compiled_roots.sort(key=lambda r: (r[2], r[0].col, r[0].dotted))
  signal_handlers.sort(key=lambda r: (r[2], r[0]))
  return ModuleFacts(path=path, defs=defs, classes=classes,
                     jit_roots=jit_roots, aliases=dict(aliases),
                     signal_handlers=signal_handlers,
                     compiled_roots=compiled_roots)


def analyze_source(source, path='<string>', rules=None):
  """Run ``rules`` over one module's source. Returns all findings (the
  pragma-suppressed ones flagged, not dropped), sorted by location.

  A file that does not parse yields a single ``LDA000`` finding — a
  syntactically broken module can't have its invariants checked, which
  is itself a finding, not a crash.
  """
  if rules is None:
    from .rules import default_rules
    rules = default_rules()
  try:
    tree = ast.parse(source, filename=path)
  except (SyntaxError, ValueError) as e:
    line = getattr(e, 'lineno', 1) or 1
    return [
        Finding(rule_id='LDA000', path=path, line=line, col=1,
                message=f'file does not parse: {e.msg or e}',
                hint='fix the syntax error so the file can be analyzed')
    ]
  ctx = ModuleContext(tree, path, source)
  findings = []
  applicable = [r for r in rules if not r.exempt(ctx)]
  for rule in applicable:
    findings.extend(rule.begin_module(ctx))
  node_rules = [r for r in applicable
                if type(r).on_node is not Rule.on_node]
  if node_rules:
    for node, ancestors in walk_with_ancestors(tree):
      ctx.ancestors = ancestors
      for rule in node_rules:
        findings.extend(rule.on_node(node, ctx))
  pragmas = pragma_lines(source)
  if pragmas:
    for f in findings:
      f.suppressed = is_suppressed(f, pragmas)
  return sort_findings(findings)


def analyze_file(path, rules=None):
  with open(path, encoding='utf-8') as f:
    source = f.read()
  return analyze_source(source, path=path, rules=rules)


def discover_py_files(paths):
  """Expand files/directories into a sorted, deduplicated ``.py`` list
  (sorted: the analyzer's own output order must be rank-stable too)."""
  out = []
  for p in paths:
    if os.path.isdir(p):
      out.extend(sorted(
          os.path.join(r, f)
          for r, _, files in os.walk(p)
          for f in files
          if f.endswith('.py')))
    elif p.endswith('.py'):
      out.append(p)
  return sorted(set(out))


# Below this many files the pool's spawn cost beats the win.
_PARALLEL_MIN_FILES = 8


def _analyze_file_worker(path, rule_ids=None):
  """Top-level (picklable) per-file worker: rules travel as ids and are
  re-instantiated from the registry inside the worker process."""
  rules = None
  if rule_ids is not None:
    from .rules import rules_by_id
    by_id = rules_by_id()
    rules = [by_id[rid] for rid in rule_ids]
  return analyze_file(path, rules=rules)


def _serializable_rule_ids(rules):
  """Rule ids when ``rules`` are stock registry instances (safe to
  rebuild in a worker), else None — custom rule objects force the
  serial path rather than silently analyzing with a lookalike."""
  if rules is None:
    return None
  from .rules import rules_by_id
  by_id = rules_by_id()
  ids = []
  for r in rules:
    stock = by_id.get(r.rule_id)
    if stock is None or type(stock) is not type(r):
      return ()
    ids.append(r.rule_id)
  return ids


def resolve_jobs(jobs=None):
  """Worker count: explicit arg, else ``LDDL_ANALYZE_JOBS``, else CPU
  count."""
  if jobs is None:
    try:
      jobs = int(os.environ.get('LDDL_ANALYZE_JOBS', '0'))
    except ValueError:
      jobs = 0
  return jobs if jobs and jobs > 0 else (os.cpu_count() or 1)


def _cache_fingerprint(rule_ids):
  """Stable ruleset fingerprint for findings-cache keys, or None when
  the rules are custom instances (no stable identity → no caching)."""
  if rule_ids == ():
    return None
  if rule_ids is None:
    from .rules import default_rules
    rule_ids = [r.rule_id for r in default_rules()]
  return ','.join(sorted(rule_ids))


def analyze_paths(paths, rules=None, jobs=None, cache=None):
  """Analyze every ``.py`` file under ``paths`` (files or directories).

  Returns ``(findings, files_scanned)``; findings include suppressed
  ones (callers filter on ``f.suppressed``).

  Files fan out across a process pool when ``jobs`` (or
  ``LDDL_ANALYZE_JOBS``, or the CPU count) exceeds 1. Results are
  collected in the same sorted file order the serial loop uses and each
  file's findings are internally sorted, so the output is byte-identical
  to the serial run at any worker count. Custom (non-registry) rule
  instances can't travel to workers and fall back to the serial loop.

  With a ``cache`` (:class:`~lddl_tpu_torch.analysis.cache.AnalysisCache`),
  unchanged files load their findings by content hash and only the
  misses are analyzed; suppression state travels with the cached
  findings (pragmas live in the hashed source), so warm output is
  byte-identical to cold.
  """
  files = discover_py_files(paths)
  jobs = resolve_jobs(jobs)
  rule_ids = _serializable_rule_ids(rules)
  fingerprint = _cache_fingerprint(rule_ids) if cache is not None else None
  per_file = {}
  pending = list(files)
  sources = {}
  if fingerprint is not None:
    pending = []
    for path in files:
      try:
        with open(path, encoding='utf-8') as fh:
          sources[path] = fh.read()
      except OSError:
        pending.append(path)  # unreadable now: let analyze_file report
        continue
      hit = cache.load('findings', path, sources[path],
                       extra=fingerprint)
      if hit is None:
        pending.append(path)
      else:
        per_file[path] = hit
  analyzed = None
  parallel_ok = (jobs > 1 and len(pending) >= _PARALLEL_MIN_FILES
                 and rule_ids != ())
  if parallel_ok:
    # Workers come from the forkserver, never a fork of this process: the
    # analyzer runs inside processes that hold threads (the perf gate, a
    # test runner beside a loader's), and a forked child of a threaded
    # parent can inherit a lock some thread held. The pool launches every
    # worker at its first submit, so the main module is blanked across
    # map()'s submits only.
    from ..loader.workers import bare_main, worker_context
    try:
      with concurrent.futures.ProcessPoolExecutor(
          max_workers=min(jobs, len(pending)),
          mp_context=worker_context(__name__)) as pool:
        with bare_main():
          results = pool.map(_analyze_file_worker, pending,
                             [rule_ids] * len(pending),
                             chunksize=max(1, len(pending) // (jobs * 4)))
        analyzed = list(results)
    except (OSError, ValueError, concurrent.futures.process
            .BrokenProcessPool):
      analyzed = None  # restricted environments: serial fallback below
  if analyzed is None:
    analyzed = [analyze_file(path, rules=rules) for path in pending]
  for path, batch in zip(pending, analyzed):
    per_file[path] = batch
    if fingerprint is not None and path in sources:
      cache.store('findings', path, sources[path], batch,
                  extra=fingerprint)
  findings = [f for path in files for f in per_file.get(path, ())]
  return findings, len(files)
