"""What the port's analyzer adds to ``lddl_tpu``'s: torch's spellings.

- One planted fixture per spelling of the table in
  ``lddl_tpu_torch/analysis/__init__.py``: torch's collectives under a rank
  branch (LDA005) and in diverging arms (LDA011), ``capture_step``'s
  ``body`` / ``torch.compile`` / ``make_graphed_callables`` as roots with
  a host sync behind them (LDA010), torch's host syncs behind a
  ``jax.jit`` root (LDA010), torch's global-generator draws and reseeds
  (LDA002). The port reports each under its rule; ``lddl_tpu``'s analyzer
  reports none. The spellings the table leaves out stay silent in both.
- The roots are not vacuous on the port itself: ``TrainStep.body`` and
  ``ScanTrainStep._bodies`` are LDA010 roots of the port's index,
  collectives are reachable from the data-parallel and fsdp exchanges and
  from ``ring_attention``, and a ``.item()`` planted in a copy of the
  step body is found through the captured root.
"""

import shutil
import textwrap
from pathlib import Path

import pytest

import lddl_tpu.analysis as ref
import lddl_tpu_torch.analysis as port
from lddl_tpu_torch.analysis.callgraph import CallGraph
from lddl_tpu_torch.analysis.engine import discover_py_files
from lddl_tpu_torch.analysis.project import ProjectIndex

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The analyzer makes no shm segment; the shared fixture would count other
  # xdist workers' lddl_ segments as this test's leak.
  yield


def ids(findings):
  return [f.rule_id for f in findings if not f.suppressed]


def both_on_source(src, path='lddl_tpu_torch/pkg/mod.py'):
  src = textwrap.dedent(src)
  return (ids(port.analyze_source(src, path=path)),
          ids(ref.analyze_source(src, path=path)))


def both_on_tree(tmp_path, files):
  """Both analyzers in project mode over a package of ``files``."""
  root = tmp_path / 'proj'
  for rel, src in files.items():
    (root / rel).parent.mkdir(parents=True, exist_ok=True)
    (root / rel).write_text(textwrap.dedent(src))
  (root / '__init__.py').write_text('')
  got, _ = port.analyze_project([str(root)], jobs=1)
  want, _ = ref.analyze_project([str(root)], jobs=1)
  return got, want


# ---------------------------------------------------------------------------
# collectives


TORCH_COLLECTIVES = [
    'all_reduce', 'all_gather', 'all_gather_object',
    'all_gather_into_tensor', 'reduce_scatter_tensor',
    'broadcast_object_list', 'batch_isend_irecv', 'monitored_barrier',
    'all_to_all_single']


@pytest.mark.parametrize('name', TORCH_COLLECTIVES)
def test_torch_collective_under_a_rank_branch(name):
  got, want = both_on_source(f"""
      import torch.distributed as dist
      def step(rank, t):
        if rank == 0:
          dist.{name}(t)
      """)
  assert (got, want) == (['LDA005'], [])


def test_a_bare_imported_torch_collective_is_one():
  got, want = both_on_source("""
      from torch.distributed import all_reduce
      def step(rank, t):
        if rank == 0:
          all_reduce(t)
      """)
  assert (got, want) == (['LDA005'], [])


def test_gather_and_scatter_stay_tensor_methods():
  assert both_on_source("""
      import torch.distributed as dist
      def pick(rank, t, idx):
        if rank == 0:
          t = t.gather(1, idx)
          t.scatter_(1, idx, t)
          dist.gather(t)
        return t
      """) == ([], [])


def test_torch_collectives_in_diverging_arms(tmp_path):
  got, want = both_on_tree(tmp_path, {'ex.py': """
      class Exchange:
        def __init__(self, dist, nccl):
          self._dist = dist
          self.nccl = nccl

        def grads(self, flat, shard):
          if self.nccl:
            self._dist.reduce_scatter_tensor(shard, flat)
          else:
            self._dist.all_reduce(flat)
      """})
  race = [f for f in got if f.rule_id == 'LDA011']
  assert len(race) == 1 and 'reduce_scatter_tensor vs all_reduce' in \
      race[0].message
  assert ids(want) == []


# ---------------------------------------------------------------------------
# compiled-code roots (LDA010)


@pytest.mark.parametrize('wrap, root', [
    ('capture_step(stream, lambda: _read(t), lambda: _read(t), [], "s")',
     '_read'),
    ('capture_step(stream, warm_up, body=lambda: _read(t), '
     'generators=[], what="s")', '_read'),
    ('capture_step(stream, warm_up, _read, [], "s")', '_read'),
    ('capture_step(stream, warm_up, functools.partial(_read, t), [], "s")',
     '_read'),
    ('torch.compile(_read)', '_read'),
    ('torch.cuda.make_graphed_callables(_read, (t,))', '_read'),
])
def test_captured_and_compiled_roots(tmp_path, wrap, root):
  got, want = both_on_tree(tmp_path, {
      'cap.py': """
          def capture_step(stream, warm_up, body, generators, what):
            return warm_up(), body()
          """,
      'step.py': f"""
          import functools

          import torch

          from .cap import capture_step

          def _read(t):
            return t.item()

          def run(stream, warm_up, t):
            return {wrap}
          """})
  found = [f for f in got if f.rule_id == 'LDA010']
  assert len(found) == 1, [f.render() for f in got]
  assert found[0].chain[0]['name'] == f'{root}()'
  assert 't.item()' in found[0].message
  assert ids(want) == []


def test_warm_up_is_not_a_root(tmp_path):
  got, _ = both_on_tree(tmp_path, {'step.py': """
      import torch

      def _warm(t):
        torch.cuda.synchronize()
        return t.cpu()

      def _body(t):
        return t * 2

      def run(stream, capture_step, t):
        return capture_step(stream, lambda: _warm(t), lambda: _body(t),
                            [], 's')
      """})
  assert ids(got) == []


def test_a_method_body_through_its_receiver(tmp_path):
  """``lambda: self.step.body(x)``: the body resolves through the class
  that built ``self.step``, as ``CompiledStepCache._miss`` names it."""
  got, want = both_on_tree(tmp_path, {'cache.py': """
      class Step:
        def body(self, batch):
          return batch.tolist()

      class Cache:
        def __init__(self):
          self.step = Step()

        def miss(self, stream, capture_step, batch):
          return capture_step(stream, lambda: None,
                              lambda: self.step.body(batch), [], 'step')
      """})
  found = [f for f in got if f.rule_id == 'LDA010']
  assert len(found) == 1
  assert [h['name'] for h in found[0].chain][:1] == ['Step.body()']
  assert ids(want) == []


def test_torch_compile_as_a_decorator(tmp_path):
  got, want = both_on_tree(tmp_path, {'step.py': """
      import torch

      @torch.compile(mode='max-autotune')
      def step(x):
        return x.numpy()
      """})
  assert ids(got) == ['LDA010'] and ids(want) == []


# ---------------------------------------------------------------------------
# host syncs behind a root both analyzers know


@pytest.mark.parametrize('sync', [
    't.cpu()', 't.tolist()', 't.numpy()', 'ev.synchronize()',
    'torch.cuda.synchronize()',
    'torch.cuda.synchronize(t.device)'])
def test_torch_host_sync_behind_a_jit_root(tmp_path, sync):
  got, want = both_on_tree(tmp_path, {'step.py': f"""
      import jax
      import torch

      @jax.jit
      def step(t, ev):
        return _helper(t, ev)

      def _helper(t, ev):
        return {sync}
      """})
  assert ids(got) == ['LDA010'] and ids(want) == []
  assert 'host_sync' in got[0].message


def test_a_host_copy_with_arguments_is_not_a_sync(tmp_path):
  got, _ = both_on_tree(tmp_path, {'step.py': """
      import jax

      @jax.jit
      def step(t, out):
        return t.cpu(memory_format=out), t.numpy(force=True)
      """})
  assert ids(got) == []


# ---------------------------------------------------------------------------
# torch's global generator (LDA002)


@pytest.mark.parametrize('call', [
    'torch.rand(3)', 'torch.randn(2, 3)', 'torch.randint(0, 5, (3,))',
    'torch.randperm(5)', 'torch.bernoulli(p)', 'torch.multinomial(p, 2)',
    'torch.normal(0.0, 1.0, (3,))', 'torch.poisson(p)',
    'torch.rand_like(p)', 'torch.randn_like(p)', 'torch.randint_like(p, 5)',
    'torch.manual_seed(0)', 'torch.seed()', 'torch.cuda.manual_seed(0)',
    'torch.cuda.manual_seed_all(0)'])
def test_torch_global_generator(call):
  got, want = both_on_source(f"""
      import torch
      def draw(p):
        return {call}
      """)
  assert (got, want) == (['LDA002'], [])


@pytest.mark.parametrize('call', [
    'torch.rand(3, generator=g)', 'torch.randperm(5, generator=g)',
    'torch.normal(0.0, 1.0, (3,), generator=g)',
    'torch.bernoulli(p, generator=g)', 'g.manual_seed(0)',
    'torch.Generator().manual_seed(0)'])
def test_a_seeded_generator_is_clean(call):
  assert both_on_source(f"""
      import torch
      def draw(p, g):
        return {call}
      """) == ([], [])


def test_the_same_files_are_exempt():
  src = """
      import torch
      x = torch.rand(3)
      torch.manual_seed(0)
      """
  for path in ('lddl_tpu_torch/core/random.py', 'tests/test_thing.py',
               'lddl_tpu_torch/testing.py'):
    assert both_on_source(src, path=path) == ([], [])
  assert both_on_source(src)[0] == ['LDA002', 'LDA002']


def test_the_hint_names_the_ports_helpers():
  (f,) = port.analyze_source('import torch\nx = torch.rand(3)\n',
                             path='m.py')
  assert 'lddl_tpu_torch.core.random' in f.hint
  assert 'torch.Generator' in f.hint


# ---------------------------------------------------------------------------
# the roots on the port itself are not vacuous


@pytest.fixture(scope='module')
def port_graph():
  index = ProjectIndex.build(
      discover_py_files([str(ROOT / 'lddl_tpu_torch')]))
  return index, CallGraph(index)


def test_the_captured_step_bodies_are_roots(port_graph):
  index, _ = port_graph
  roots = {index.display(gq) for gq in index.jit_root_defs()}
  assert {'TrainStep.body', 'ScanTrainStep._bodies'} <= roots


@pytest.mark.parametrize('root, collectives', [
    ('lddl_tpu_torch.parallel.train.DataParallel.grads', {'all_reduce'}),
    ('lddl_tpu_torch.parallel.train.ShardedDataParallel.grads',
     {'reduce_scatter_tensor', 'all_reduce'}),
    ('lddl_tpu_torch.parallel.ring.ring_attention', {'batch_isend_irecv'}),
])
def test_the_exchanges_reach_their_collectives(port_graph, root,
                                               collectives):
  index, graph = port_graph
  assert root in index.defs
  assert 'collective' in graph.transitive_effects(root)
  reached = {eff.detail for _, eff, _ in graph.reachable_effects(
      root, ('collective',))}
  assert collectives <= reached


def test_an_item_planted_in_the_step_body_is_found(tmp_path):
  pkg = tmp_path / 'lddl_tpu_torch'
  shutil.copytree(ROOT / 'lddl_tpu_torch', pkg,
                  ignore=shutil.ignore_patterns('__pycache__', '*.so'))
  train = pkg / 'parallel' / 'train.py'
  src = train.read_text()
  anchor = '    loss.backward()\n'
  assert src.count(anchor) == 1
  train.write_text(src.replace(anchor, anchor + '    loss.item()\n'))
  unsuppressed, _ = port.analyze_project([str(pkg)], rules=[
      port.rules_by_id()['LDA010']])
  found = [f for f in unsuppressed if not f.suppressed]
  assert len(found) == 1
  assert found[0].path.endswith('parallel/train.py')
  assert 'loss.item()' in found[0].message
  assert found[0].chain[0]['name'] in ('TrainStep.body()',
                                       'ScanTrainStep._bodies()')
