"""The initial ruleset: the SPMD-determinism and resource-safety
invariants this pipeline actually depends on (the port's copy of
:mod:`lddl_tpu.analysis.rules`; LDA002 also knows torch's global
generator, and the collectives and LDA010's roots and host syncs come
from the engine's torch spellings).

Every rank must derive the identical sample plan without communication
(LDA001/LDA002/LDA003), collectives must be issued uniformly by all ranks
(LDA005), and a killed worker must never leak file handles or shared
memory (LDA004). Each rule documents the invariant it protects in
``invariant`` — that text is what ``--list-rules`` and the README table
show.
"""

import ast

from .engine import (COLLECTIVES, DEVICE_COLLECTIVE_PREFIXES, Rule,
                     rank_mention)
from .callgraph import is_lexical_collective
from .project import ProjectRule, build_chain

# ---------------------------------------------------------------------------
# LDA001: unsorted filesystem iteration


_FS_OS = frozenset({'os.listdir', 'os.scandir', 'os.walk'})
_FS_GLOB = frozenset({'glob.glob', 'glob.iglob'})
_FS_PATH_METHODS = frozenset({'iterdir', 'rglob'})


class UnsortedFsIteration(Rule):
  rule_id = 'LDA001'
  name = 'unsorted-fs-iteration'
  invariant = ('every rank derives the identical file plan: directory '
               'listing order is filesystem-dependent, so unsorted '
               'iteration can diverge across hosts')
  hint = 'wrap the call in sorted(...) before consuming its order'

  def on_node(self, node, ctx):
    if not isinstance(node, ast.Call):
      return
    dotted, term = ctx.call_name(node)
    hazard = None
    if dotted in _FS_OS or dotted in _FS_GLOB:
      hazard = dotted
    elif term in _FS_PATH_METHODS and isinstance(node.func, ast.Attribute):
      hazard = f'.{term}'
    elif (term == 'glob' and isinstance(node.func, ast.Attribute) and
          dotted not in _FS_GLOB and
          (dotted is None or not dotted.startswith('glob.'))):
      # Path(...).glob(...) / some_path.glob(...): same order hazard.
      hazard = '.glob'
    if hazard is None:
      return
    for anc in ctx.ancestors:
      if (isinstance(anc, ast.Call) and
          isinstance(anc.func, ast.Name) and anc.func.id == 'sorted'):
        return
    yield self.finding(
        node,
        f'{hazard}() consumed without sorted(): filesystem iteration '
        'order is not deterministic across hosts, so ranks can derive '
        'divergent plans', ctx)


# ---------------------------------------------------------------------------
# LDA002: process-global / unseeded RNG


_NP_BIT_GENERATORS = frozenset({
    'Generator', 'Philox', 'PCG64', 'PCG64DXSM', 'MT19937', 'SFC64',
    'SeedSequence', 'BitGenerator',
})
_NP_SEED_REQUIRED = frozenset({'default_rng', 'RandomState'})
# torch's draws from its process-global generator unless given
# ``generator=``, and the calls that reseed that generator.
_TORCH_DRAWS = frozenset({
    'rand', 'randn', 'randint', 'randperm', 'bernoulli', 'multinomial',
    'normal', 'poisson', 'rand_like', 'randn_like', 'randint_like',
})
_TORCH_SEEDS = frozenset({
    'torch.manual_seed', 'torch.seed', 'torch.cuda.manual_seed',
    'torch.cuda.manual_seed_all',
})


class GlobalStateRng(Rule):
  rule_id = 'LDA002'
  name = 'global-state-rng'
  invariant = ('all randomness flows through seeded Philox / '
               'core.random helpers: global-state RNG draws depend on '
               'call order and imports, not on the run seed')
  hint = ('use lddl_tpu_torch.core.random helpers, a seeded '
          'torch.Generator passed as generator=, or a seeded '
          'np.random.Generator(Philox(...)) / random.Random(seed)')

  def exempt(self, ctx):
    # The seeded-RNG module itself wraps the global state (under a state
    # swap), and test/benchmark scaffolding may use ad-hoc randomness.
    if ctx.path_is('core/random.py', 'tests/'):
      return True
    base = ctx.basename()
    return (base.startswith('test_') or
            base in ('conftest.py', 'testing.py'))

  def on_node(self, node, ctx):
    if not isinstance(node, ast.Call):
      return
    dotted, _ = ctx.call_name(node)
    if not dotted:
      return
    seeded = bool(node.args or node.keywords)
    if dotted.split('.')[0] == 'random' and dotted.count('.') == 1:
      fn = dotted.split('.')[1]
      if fn == 'Random':
        if not seeded:
          yield self.finding(
              node, 'random.Random() without a seed falls back to OS '
              'entropy: draws differ per rank and per run', ctx)
        return
      if fn == 'SystemRandom':
        yield self.finding(
            node, 'random.SystemRandom draws OS entropy: '
            'non-reproducible by design', ctx)
        return
      yield self.finding(
          node, f'random.{fn}() uses the process-global RNG: draws '
          'depend on import/call order, not on the run seed', ctx)
      return
    if dotted.startswith('numpy.random.'):
      fn = dotted[len('numpy.random.'):].split('.')[0]
      if fn in _NP_BIT_GENERATORS:
        return
      if fn in _NP_SEED_REQUIRED:
        if not seeded:
          yield self.finding(
              node, f'np.random.{fn}() without a seed draws OS entropy: '
              'every rank gets a different stream', ctx)
        return
      yield self.finding(
          node, f'np.random.{fn}() uses numpy\'s process-global RNG: '
          'draws depend on call order, not on the run seed', ctx)
      return
    if dotted in _TORCH_SEEDS:
      yield self.finding(
          node, f'{dotted}() reseeds torch\'s process-global generator: '
          'every later unseeded draw in the process depends on where '
          'this ran, not on the run seed', ctx)
      return
    if (dotted.startswith('torch.') and dotted.count('.') == 1
        and dotted[len('torch.'):] in _TORCH_DRAWS
        and not any(kw.arg == 'generator' for kw in node.keywords)):
      yield self.finding(
          node, f'{dotted}() without generator= draws from torch\'s '
          'process-global generator: draws depend on call order, not on '
          'the run seed', ctx)


# ---------------------------------------------------------------------------
# LDA003: wall-clock in control flow


_CLOCKS = frozenset({
    'time.time', 'time.time_ns', 'time.monotonic', 'time.monotonic_ns',
})


def _clock_call(node, ctx):
  """The first wall-clock call anywhere under ``node``, or None."""
  for n in ast.walk(node):
    if isinstance(n, ast.Call) and ctx.call_name(n)[0] in _CLOCKS:
      return ctx.call_name(n)[0]
  return None


def _scope_nodes(root):
  """All nodes of one scope, without descending into nested functions
  (those are their own taint scopes)."""
  stack = list(ast.iter_child_nodes(root))
  while stack:
    n = stack.pop()
    yield n
    if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
      stack.extend(ast.iter_child_nodes(n))


def _assigned_names(target):
  """Plain names bound by an assignment target. Attribute/subscript
  targets (``self.t0 = time.monotonic()``) are object state, outside
  this rule's one-level name taint — tainting ``self`` for them would
  flag every later ``if self...`` branch."""
  if isinstance(target, ast.Name):
    yield target.id
  elif isinstance(target, (ast.Tuple, ast.List)):
    for elt in target.elts:
      yield from _assigned_names(elt)
  elif isinstance(target, ast.Starred):
    yield from _assigned_names(target.value)


class WallClockControlFlow(Rule):
  rule_id = 'LDA003'
  name = 'wall-clock-control-flow'
  invariant = ('control flow is a function of logical progress, not '
               'wall-clock: ranks observing different times take '
               'different branches and diverge or deadlock')
  hint = ('branch on step/sample counts instead; timing that only feeds '
          'metrics belongs in telemetry/')

  def exempt(self, ctx):
    # Telemetry is *about* time; its comparisons never steer the
    # pipeline. This covers the whole package, explicitly including the
    # live-observability modules (telemetry/live.py windowed rates,
    # telemetry/server.py LDDL_MONITOR endpoint, telemetry/monitor.py
    # dashboard repaint loop): their time arithmetic produces
    # rates/verdicts for operators, never a branch a rank acts on.
    return ctx.path_is('telemetry/')

  def begin_module(self, ctx):
    scopes = [ctx.tree]
    scopes.extend(
        n for n in ast.walk(ctx.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
    for scope in scopes:
      nodes = list(_scope_nodes(scope))
      tainted = set()
      for n in nodes:
        value = getattr(n, 'value', None)
        if value is None:
          continue
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                          ast.NamedExpr)) and _clock_call(value, ctx):
          targets = n.targets if isinstance(n, ast.Assign) else [n.target]
          for t in targets:
            tainted.update(_assigned_names(t))
      for n in nodes:
        if not isinstance(n, (ast.If, ast.While, ast.IfExp)):
          continue
        clock = _clock_call(n.test, ctx)
        if clock:
          yield self.finding(
              n.test, f'{clock}() feeds this branch condition: ranks '
              'observing different clocks diverge', ctx)
          continue
        used = sorted(
            x.id for x in ast.walk(n.test)
            if isinstance(x, ast.Name) and x.id in tainted)
        if used:
          yield self.finding(
              n.test, f'{used[0]!r} (derived from a wall-clock read) '
              'feeds this branch condition: ranks observing different '
              'clocks diverge', ctx)


# ---------------------------------------------------------------------------
# LDA004: resource acquisition without scoped release


_OPENERS = frozenset({'open', 'io.open', 'os.fdopen'})
_RELEASE_ATTRS = frozenset({
    'close', 'destroy', 'unlink', 'terminate', 'release', 'shutdown',
    'cleanup', '__exit__',
})


def _finally_releases(try_node):
  for stmt in try_node.finalbody:
    for n in ast.walk(stmt):
      if not isinstance(n, ast.Call):
        continue
      if (isinstance(n.func, ast.Attribute) and
          n.func.attr in _RELEASE_ATTRS):
        return True
      if isinstance(n.func, ast.Name) and 'close' in n.func.id:
        return True
  return False


class UnscopedResource(Rule):
  rule_id = 'LDA004'
  name = 'unscoped-resource'
  invariant = ('a crashed or killed worker never leaks handles or '
               '/dev/shm segments: every acquisition is released by a '
               'with block or try/finally')
  hint = ('acquire under "with", or inside a try whose finally '
          'closes/unlinks the resource')

  def on_node(self, node, ctx):
    if not isinstance(node, ast.Call):
      return
    dotted, term = ctx.call_name(node)
    what = None
    if dotted in _OPENERS:
      what = f'{dotted}()'
    elif term == 'ParquetFile' and dotted != 'ParquetFile':
      what = 'pq.ParquetFile()'
    elif term == 'SharedMemory':
      what = 'shared_memory.SharedMemory()'
    if what is None:
      return
    for anc in reversed(ctx.ancestors):
      if isinstance(anc, ast.withitem):
        return  # the context expression of a with block
      if isinstance(anc, ast.Call):
        _, anc_term = ctx.call_name(anc)
        if anc_term in ('closing', 'enter_context'):
          return  # ExitStack / contextlib ownership
      if isinstance(anc, ast.Try) and _finally_releases(anc):
        return
    yield self.finding(
        node, f'{what} acquired without a scoped release: a crash '
        'before the close leaks the handle (the ParquetFile/shm leak '
        'class)', ctx)


# ---------------------------------------------------------------------------
# LDA005: collective inside a rank-conditional branch


# The collective vocabulary and rank-identifier heuristics live in the
# engine: the facts extractor (project mode) and these lexical rules
# must agree on them or findings would shift between modes.
_COLLECTIVES = COLLECTIVES
_rank_mention = rank_mention


class RankConditionalCollective(Rule):
  rule_id = 'LDA005'
  name = 'rank-conditional-collective'
  invariant = ('collectives are issued uniformly by every rank: a '
               'collective some ranks skip deadlocks the ones that '
               'entered it (the classic SPMD hang)')
  hint = ('hoist the collective out of the rank conditional; keep only '
          'the rank-local work (logging, file writes) inside it')

  def on_node(self, node, ctx):
    if not isinstance(node, ast.Call):
      return
    dotted, term = ctx.call_name(node)
    if isinstance(node.func, ast.Attribute):
      if term not in _COLLECTIVES:
        return
    elif isinstance(node.func, ast.Name):
      # A bare name is a collective only when alias resolution proves
      # it (``from ..comm import barrier`` / ``sync = comm.barrier``):
      # an unrelated local function that happens to be called
      # ``barrier`` resolves to itself, dotless, and is not flagged.
      if (not dotted or '.' not in dotted
          or dotted.rsplit('.', 1)[-1] not in _COLLECTIVES):
        return
      term = dotted.rsplit('.', 1)[-1]
    else:
      return
    if dotted and dotted.startswith(DEVICE_COLLECTIVE_PREFIXES):
      return  # array shape ops (e.g. lax.broadcast), not collectives
    for anc in ctx.ancestors:
      if isinstance(anc, (ast.If, ast.While, ast.IfExp)):
        ident = _rank_mention(anc.test)
        if ident:
          yield self.finding(
              node, f'collective {term}() inside a branch '
              f'conditioned on {ident!r}: ranks disagreeing on the '
              'branch deadlock the collective', ctx)
          return


# ---------------------------------------------------------------------------
# LDA006: worker-pool churn


_POOL_EXECUTORS = frozenset({'ProcessPoolExecutor', 'ThreadPoolExecutor'})
_POOL_LIFECYCLE_METHODS = frozenset({'__init__', '__new__', '__enter__'})


class PoolChurn(Rule):
  rule_id = 'LDA006'
  name = 'pool-churn'
  invariant = ('worker pools have a lifetime, not a call site: a pool '
               'constructed per loop iteration or per method call re-pays '
               'worker spawn + per-worker warmup (tokenizer, native '
               'encoder) on every phase')
  hint = ('hoist the pool to an owner with a lifetime (create lazily '
          'once, reuse across phases, close() at teardown) — e.g. '
          'pipeline.pool.WorkerPool owned by Executor')

  def exempt(self, ctx):
    # Tests/benchmark scaffolding may build throwaway pools on purpose.
    if ctx.path_is('tests/'):
      return True
    base = ctx.basename()
    return (base.startswith('test_') or
            base in ('conftest.py', 'testing.py'))

  def _pool_name(self, node, ctx):
    dotted, term = ctx.call_name(node)
    if term in _POOL_EXECUTORS:
      return term
    if term == 'Pool' and (isinstance(node.func, ast.Attribute) or
                           (dotted and 'multiprocessing' in dotted)):
      # mp.Pool / ctx.Pool / multiprocessing.Pool; a bare local Pool()
      # class of unrelated meaning is not flagged.
      return 'Pool'
    return None

  def on_node(self, node, ctx):
    if not isinstance(node, ast.Call):
      return
    what = self._pool_name(node, ctx)
    if what is None:
      return
    for anc in ctx.ancestors:
      if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
        yield self.finding(
            node, f'{what}() constructed inside a loop: every iteration '
            're-pays worker spawn and per-worker warmup (pool churn)',
            ctx)
        return
    func = ctx.enclosing(ast.FunctionDef, ast.AsyncFunctionDef)
    if func is None or func.name in _POOL_LIFECYCLE_METHODS:
      return
    params = func.args.posonlyargs + func.args.args
    if not params or params[0].arg not in ('self', 'cls'):
      return
    ancestors = list(ctx.ancestors)
    fi = ancestors.index(func)
    if not any(isinstance(a, ast.ClassDef) for a in ancestors[:fi]):
      return  # self-named first arg on a plain function, not a method
    for anc in reversed(ancestors):
      if isinstance(anc, ast.Assign):
        for t in anc.targets:
          if (isinstance(t, ast.Attribute) and
              isinstance(t.value, ast.Name) and
              t.value.id in ('self', 'cls')):
            return  # cached on the instance: a lifetime, not churn
    yield self.finding(
        node, f'{what}() constructed per call of method {func.name!r}: '
        'every invocation re-pays worker spawn and per-worker warmup '
        'instead of reusing a pool with a lifetime (pool churn)', ctx)


# ---------------------------------------------------------------------------
# LDA007: swallowed exceptions


_BROAD_EXC = frozenset({'Exception', 'BaseException'})


class SwallowedException(Rule):
  rule_id = 'LDA007'
  name = 'swallowed-exception'
  invariant = ('fault-tolerance code must never eat errors blindly: a '
               'bare/broad except whose body does nothing turns rank '
               'death, lease races, and IO corruption into silent wrong '
               'answers the recovery machinery can no longer see')
  hint = ('catch the narrow exception the site actually expects '
          '(OSError, FileExistsError, ...), or handle it: count it in '
          'telemetry, log it, or re-raise — if swallowing broadly is '
          'truly intended, annotate why with  # lddl: noqa[LDA007]')

  def exempt(self, ctx):
    # Tests exercise failure paths on purpose (and often probe with
    # deliberately broad catches).
    if ctx.path_is('tests/'):
      return True
    base = ctx.basename()
    return (base.startswith('test_') or
            base in ('conftest.py', 'testing.py'))

  def _is_broad(self, node, ctx):
    if node.type is None:
      return True  # bare `except:`
    types = (node.type.elts if isinstance(node.type, ast.Tuple)
             else [node.type])
    for t in types:
      name = None
      if isinstance(t, ast.Name):
        name = t.id
      elif isinstance(t, ast.Attribute):
        name = t.attr
      if name in _BROAD_EXC:
        return True
    return False

  def _is_inert(self, body):
    # pass / continue / `...` / a lone docstring: nothing observed the
    # error. A `return`/assignment/call/raise counts as handling.
    for stmt in body:
      if isinstance(stmt, (ast.Pass, ast.Continue)):
        continue
      if (isinstance(stmt, ast.Expr) and
          isinstance(stmt.value, ast.Constant) and
          (stmt.value.value is Ellipsis or
           isinstance(stmt.value.value, str))):
        continue
      return False
    return True

  def on_node(self, node, ctx):
    if not isinstance(node, ast.ExceptHandler):
      return
    if not self._is_broad(node, ctx) or not self._is_inert(node.body):
      return
    what = ('bare except:' if node.type is None else
            'except ' + ast.unparse(node.type) + ':')
    yield self.finding(
        node, f'{what} with a do-nothing body swallows every error '
        '(including rank death, lease races, and IO corruption) '
        'invisibly — catch the narrow exception the site expects, or '
        'observe the failure (telemetry/log/re-raise)', ctx)


# ---------------------------------------------------------------------------
# LDA012: socket without a deadline


_SOCKET_CTORS = frozenset({'socket.socket'})
_SOCKET_CONNECTORS = frozenset({'socket.create_connection'})


class SocketWithoutDeadline(Rule):
  rule_id = 'LDA012'
  name = 'socket-without-deadline'
  invariant = ('every socket carries a deadline before blocking use: an '
               'unbounded accept/recv/connect turns one dead peer into '
               'a hung rank the lease machinery cannot distinguish from '
               'a slow one')
  hint = ('call .settimeout(...) on the socket in the same scope, or '
          'pass timeout= to socket.create_connection(...)')

  def exempt(self, ctx):
    # Tests open throwaway sockets (port probes, fake peers) whose
    # lifetime the test harness itself bounds.
    if ctx.path_is('tests/'):
      return True
    base = ctx.basename()
    return (base.startswith('test_') or
            base in ('conftest.py', 'testing.py'))

  def begin_module(self, ctx):
    scopes = [ctx.tree]
    scopes.extend(
        n for n in ast.walk(ctx.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
    for scope in scopes:
      nodes = list(_scope_nodes(scope))
      # One-level scope discipline (same granularity as LDA003): a
      # .settimeout(...) anywhere in the creating scope bounds every
      # socket it creates; a socket handed to another function for its
      # deadline would be flagged here, keeping the bound visible at
      # the creation site.
      has_deadline = any(
          isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
          and n.func.attr == 'settimeout' for n in nodes)
      if has_deadline:
        continue
      for n in nodes:
        if not isinstance(n, ast.Call):
          continue
        dotted, _ = ctx.call_name(n)
        if dotted in _SOCKET_CTORS:
          yield self.finding(
              n, 'socket.socket() created with no .settimeout(...) in '
              'scope: its blocking calls can hang forever on a dead '
              'peer', ctx)
        elif dotted in _SOCKET_CONNECTORS and len(n.args) < 2 and not \
            any(kw.arg == 'timeout' for kw in n.keywords):
          yield self.finding(
              n, 'socket.create_connection() without timeout= (and no '
              '.settimeout(...) in scope): the connect can block '
              'forever on an unreachable server', ctx)


# ---------------------------------------------------------------------------
# LDA013: salted builtin hash() escaping the process


# Attribute-call terminals through which a value leaves the process (or
# the run): file/socket writes, queue handoffs, serialization, wire
# packing, and the determinism ledger itself.
_HASH_SINKS = frozenset({
    'write', 'writelines', 'send', 'sendall', 'sendto', 'put',
    'put_nowait', 'dump', 'dumps', 'pack', 'pack_into', 'publish',
    'record',
})


def _builtin_hash_call(node, ctx):
  """The first builtin ``hash(...)`` call whose *value* escapes through
  ``node``, or None. Comparison/boolean subtrees are pruned: the result
  of ``hash(a) == hash(b)`` computed in one interpreter is the same for
  every salt, so only the raw hash value carries the hazard. Alias
  resolution keeps a local/imported ``hash`` name out."""
  stack = [node]
  while stack:
    n = stack.pop()
    if isinstance(n, (ast.Compare, ast.BoolOp)):
      continue  # boolean results are salt-invariant
    if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and
        ctx.call_name(n)[0] == 'hash'):
      return n
    stack.extend(ast.iter_child_nodes(n))
  return None


class SaltedHashEscape(Rule):
  rule_id = 'LDA013'
  name = 'salted-hash'
  invariant = ('fingerprints that cross a process or run boundary come '
               'from a stable hash: builtin hash() on str/bytes is '
               'salted per interpreter (PYTHONHASHSEED), so a persisted '
               'or sent value never matches the next run or another rank')
  hint = ('use hashlib (blake2b/sha256) or the telemetry.ledger '
          'fingerprint helpers for anything written, sent, or used for '
          'placement; builtin hash() is only meaningful inside one '
          'process')

  def exempt(self, ctx):
    # Tests may assert on salted hashes within their own interpreter.
    if ctx.path_is('tests/'):
      return True
    base = ctx.basename()
    return (base.startswith('test_') or
            base in ('conftest.py', 'testing.py'))

  def _sink_of(self, node, ctx, in_hash_protocol):
    """Human description of the escape ``node`` represents, or None.
    Only the *payload* position of a call counts (its arguments):
    ``hash_index.write(...)`` must not read as a hash sink."""
    if isinstance(node, ast.Call):
      _, term = ctx.call_name(node)
      if term in _HASH_SINKS:
        return f'{term}()', list(node.args) + [kw.value
                                               for kw in node.keywords]
      return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
      # hash(key) % n: placement/sharding — the classic cross-worker
      # divergence — and "%s" % hash(x) stringification both land here.
      return "a '%' placement/format expression", [node.left, node.right]
    if isinstance(node, ast.Return) and node.value is not None \
        and not in_hash_protocol:
      # A returned hash escapes the one scope this analysis can see;
      # __hash__ is the process-local protocol use and stays legal.
      return 'a return (escapes this scope)', [node.value]
    return None

  def begin_module(self, ctx):
    scopes = [ctx.tree]
    scopes.extend(
        n for n in ast.walk(ctx.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
    for scope in scopes:
      nodes = list(_scope_nodes(scope))
      in_hash_protocol = (
          isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)) and
          scope.name == '__hash__')
      tainted = set()
      for n in nodes:
        value = getattr(n, 'value', None)
        if value is None:
          continue
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                          ast.NamedExpr)) and _builtin_hash_call(value,
                                                                 ctx):
          targets = n.targets if isinstance(n, ast.Assign) else [n.target]
          for t in targets:
            tainted.update(_assigned_names(t))
      seen = set()
      for n in nodes:
        sink = self._sink_of(n, ctx, in_hash_protocol)
        if sink is None:
          continue
        what, payload = sink
        for arg in payload:
          call = _builtin_hash_call(arg, ctx)
          if call is not None:
            key = (call.lineno, call.col_offset)
            if key not in seen:
              seen.add(key)
              yield self.finding(
                  call, f'builtin hash() feeds {what}: hash() of '
                  'str/bytes is salted per interpreter '
                  '(PYTHONHASHSEED), so the value differs across runs '
                  'and ranks', ctx)
            continue
          used = sorted(
              x.id for x in ast.walk(arg)
              if isinstance(x, ast.Name) and x.id in tainted)
          if used:
            key = (n.lineno, n.col_offset, used[0])
            if key not in seen:
              seen.add(key)
              yield self.finding(
                  n, f'{used[0]!r} (derived from builtin hash()) feeds '
                  f'{what}: hash() of str/bytes is salted per '
                  'interpreter (PYTHONHASHSEED), so the value differs '
                  'across runs and ranks', ctx)


# ---------------------------------------------------------------------------
# Project-mode (interprocedural) rules: LDA008–LDA011 run over the
# whole-program call graph, not per file. Each finding carries the call
# chain from the analysis root to the effect site.


class TransitiveRankCollective(ProjectRule):
  rule_id = 'LDA008'
  name = 'transitive-rank-collective'
  invariant = ('collectives are issued uniformly by every rank even '
               'through call chains: a rank-conditional call whose '
               'callee (transitively) performs a collective deadlocks '
               'exactly like a lexical one — LDA005 one indirection out')
  hint = ('hoist the call (or just its collective) out of the rank '
          'conditional; keep only rank-local work inside it')

  def check(self, index, graph):
    for gq in sorted(index.defs):
      facts = index.defs[gq]
      targets = graph.call_targets.get(gq, ())
      for call, tgt in zip(facts.calls, targets):
        if not call.rank_cond or not tgt:
          continue
        if is_lexical_collective(call):
          continue  # lexical case: LDA005's finding, not ours
        if 'collective' not in graph.transitive_effects(tgt):
          continue
        sites = graph.reachable_effects(tgt, ('collective',))
        if not sites:
          continue
        eff_gq, eff, hops = sites[0]
        chain = ([{'name': f'{index.display(gq)}()',
                   'path': index.def_path(gq), 'line': call.line}]
                 + build_chain(index, hops, eff_gq, eff))
        yield self.finding(
            index.def_path(gq), call.line, call.col,
            f'{call.terminal}() called under a branch conditioned on '
            f'{call.rank_cond!r} transitively issues collective '
            f'{eff.detail}(): ranks skipping the branch deadlock the '
            'ones that entered it', chain=chain)


class ElasticPathPurity(ProjectRule):
  rule_id = 'LDA009'
  name = 'elastic-path-purity'
  invariant = ('the elastic scheduling path issues zero collectives and '
               'never waits unboundedly: survivors must make progress '
               'when a rank dies mid-phase, so nothing reachable from '
               'the claim/heartbeat/re-execution machinery may block on '
               'a peer')
  hint = ('make phase completion an observable fact (manifests, lease '
          'expiry) instead of a rendezvous; give every wait a timeout')

  # Roots are matched by definition/class name so the rule holds for
  # the real executor and for fixtures shaped like it.
  ROOT_DEFS = ('Executor._map_elastic',)
  ROOT_CLASSES = ('_LeaseClaimer', '_HeartbeatPump', 'HeartbeatPump',
                  'RankMembership')

  def _roots(self, index):
    roots = []
    for gq in sorted(index.defs):
      if index.display(gq) in self.ROOT_DEFS:
        roots.append(gq)
        continue
      cls = index.defs[gq].cls
      if cls and cls.rsplit('.', 1)[-1] in self.ROOT_CLASSES:
        roots.append(gq)
    return roots

  def check(self, index, graph):
    seen = set()
    for root in self._roots(index):
      for eff_gq, eff, hops in graph.reachable_effects(
          root, ('collective', 'unbounded_wait')):
        key = (index.def_path(eff_gq), eff.line, eff.col, eff.detail)
        if key in seen:
          continue
        seen.add(key)
        what = ('collective ' + eff.detail + '()'
                if eff.kind == 'collective'
                else f'unbounded wait {eff.detail}')
        yield self.finding(
            index.def_path(eff_gq), eff.line, eff.col,
            f'{what} reachable from elastic root '
            f'{index.display(root)}(): a dead rank would hang the '
            'survivors that are supposed to outlive it',
            chain=build_chain(index, hops, eff_gq, eff))


class JitHostSync(ProjectRule):
  rule_id = 'LDA010'
  name = 'jit-host-sync'
  invariant = ('jit-compiled code stays on device: a host sync '
               '(.item()/float()/np.asarray/device_get/'
               'block_until_ready) or wall-clock read reachable from a '
               'traced function forces a device flush at best and a '
               'retrace or tracer error at worst, stalling every step')
  hint = ('keep host-side reads outside the jitted function; pass '
          'values in as arguments, return metrics as arrays and read '
          'them after the step')

  def check(self, index, graph):
    roots = index.jit_root_defs()
    seen = set()
    for root in sorted(roots):
      for eff_gq, eff, hops in graph.reachable_effects(
          root, ('host_sync', 'wall_clock')):
        key = (index.def_path(eff_gq), eff.line, eff.col, eff.detail)
        if key in seen:
          continue
        seen.add(key)
        yield self.finding(
            index.def_path(eff_gq), eff.line, eff.col,
            f'{eff.detail} ({eff.kind}) reachable from jit-compiled '
            f'{index.display(root)}(): host synchronization inside '
            'traced code stalls or retraces the step',
            chain=build_chain(index, hops, eff_gq, eff))


class CollectiveOrderDivergence(ProjectRule):
  rule_id = 'LDA011'
  name = 'collective-order-divergence'
  invariant = ('every rank issues the same collectives in the same '
               'order: two branch arms reaching different collective '
               'sequences deadlock the fleet as soon as ranks disagree '
               'on the (data-dependent) condition')
  hint = ('restructure so both arms issue the identical collective '
          'sequence (hoist the collectives out of the branch), or make '
          'the condition provably rank-uniform')

  def _arm_trace(self, graph, facts, targets, idxs):
    out = []
    for i in idxs:
      call = facts.calls[i]
      if is_lexical_collective(call):
        out.append(call.terminal)
      elif targets[i]:
        out.extend(graph.collective_trace(targets[i]))
      if len(out) >= 8:
        return tuple(out[:8])
    return tuple(out)

  def check(self, index, graph):
    for gq in sorted(index.defs):
      facts = index.defs[gq]
      targets = graph.call_targets.get(gq, ())
      for branch in facts.branches:
        if not branch.body or not branch.orelse:
          continue
        body = self._arm_trace(graph, facts, targets, branch.body)
        orelse = self._arm_trace(graph, facts, targets, branch.orelse)
        if not body or not orelse or body == orelse:
          continue
        yield self.finding(
            index.def_path(gq), branch.line, 1,
            f'branch arms in {index.display(gq)}() reach different '
            f'collective sequences ({" → ".join(body)} vs '
            f'{" → ".join(orelse)}): ranks disagreeing on the '
            'condition issue mismatched collectives and deadlock')


def default_rules():
  """Fresh instances of every shipped per-file rule, in rule-id order."""
  return [
      UnsortedFsIteration(),
      GlobalStateRng(),
      WallClockControlFlow(),
      UnscopedResource(),
      RankConditionalCollective(),
      PoolChurn(),
      SwallowedException(),
      SocketWithoutDeadline(),
      SaltedHashEscape(),
  ]


def project_rules():
  """Fresh instances of every interprocedural (project-mode) rule:
  the call-graph rules here plus the thread-graph concurrency rules
  (LDA014–LDA018) from :mod:`.concurrency`."""
  from .concurrency import concurrency_rules
  return [
      TransitiveRankCollective(),
      ElasticPathPurity(),
      JitHostSync(),
      CollectiveOrderDivergence(),
  ] + concurrency_rules()


def all_rules():
  """Per-file + project rules, in rule-id order."""
  return default_rules() + project_rules()


def rules_by_id():
  return {r.rule_id: r for r in all_rules()}
