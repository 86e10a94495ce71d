"""The port's worker pool and pooled map, on the CPU.

The pooled map equals the serial map at 1, 2 and 3 workers, in task
order; warmups run once in each worker and again in a respawned one; a
task's error carries the worker's traceback; a single SIGKILL mid-task is
respawned and retried and the pool serves the next phase (20 times, each
with a pool of its own: the stall the JAX-side copy of this test meets
would show); a task that kills twice breaks the pool; a pooled map under
two gloo ranks; the BERT (host masking) and packed preprocessors write
the same bytes at 3 workers as at 1; ``auto`` masks on the host under a
pool and an explicit ``device`` is refused before any worker starts.

:func:`test_the_reference_pool_stalls_where_the_port_recovers` shows one
state of the reference's stall: a worker SIGKILLed while it holds the
write lock of lddl_tpu's shared result queue (its feeder thread takes it
for every message) silences every other worker, and its parent, which
sees no worker dead, waits on; the port's pool, a pipe pair a worker,
recovers from the same task. (``tests/reference_pool_stall.py`` reads the
state of the reference's natural stalls.) A death also reruns the tasks
whose shard writes the dead worker had not landed, which lddl_tpu loses.

Every test here runs under a deadline of its own (:data:`DEADLINE_S`):
past it, the test's worker processes are killed, which ends any wait on
them, and the test fails naming each one's state. No test waits on the
tier-1 run's clock.
"""

import functools
import multiprocessing
import os
import threading
import time

import pytest

import torch_pool_tasks as tasks
from lddl_tpu.pipeline.pool import WorkerPool as JWorkerPool
from lddl_tpu_torch.core import synth
from lddl_tpu_torch.pipeline.executor import Executor
from lddl_tpu_torch.pipeline.pool import PoolBroken, TaskFailed, WorkerPool
from lddl_tpu_torch.preprocess import bert as tbert
from lddl_tpu_torch.preprocess import packed as tpacked
from lddl_tpu_torch.preprocess import readers as treaders
from torch_threads import torch_one_thread_a_file  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
#: Seconds a test of this file may take before its processes are killed.
DEADLINE_S = 90.0
#: Seconds the reference's pool is given to finish a phase of 8 tiny tasks
#: (it finishes in well under one where it does not stall).
STALL_S = 8.0
RESPAWN_REPS = 20


def _state(pid):
  """A process's state letter and kernel wait channel, from /proc."""
  try:
    with open(f'/proc/{pid}/stat') as f:
      letter = f.read().rsplit(')', 1)[1].split()[0]
    with open(f'/proc/{pid}/wchan') as f:
      return f'{letter} in {f.read() or "-"}'
  except OSError:
    return 'gone'


class Watchdog:
  """Past ``seconds`` from its start, keeps killing every child process
  of this one (a pool's workers, a respawned one included) until
  :meth:`stop`; :attr:`fired` holds what each was doing at the first
  kill."""

  def __init__(self, seconds):
    self.fired = None
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._run, args=(seconds,),
                                    daemon=True)
    self._thread.start()

  def _run(self, seconds):
    if self._stop.wait(seconds):
      return
    kids = multiprocessing.active_children()
    self.fired = [(p.name, p.pid, _state(p.pid)) for p in kids]
    while not self._stop.is_set():
      for p in multiprocessing.active_children():
        p.kill()
      self._stop.wait(0.2)

  def stop(self):
    self._stop.set()
    self._thread.join(timeout=5.0)


@pytest.fixture(autouse=True)
def deadline(request):
  """The test's own deadline (see the module docstring)."""
  dog = Watchdog(DEADLINE_S)
  yield dog
  dog.stop()
  if dog.fired is not None:
    pytest.fail(f'{request.node.name}: past its {DEADLINE_S:.0f} s deadline;'
                f' its processes, killed: {dog.fired}')


@pytest.fixture(autouse=True)
def _no_leaked_shm_segments():
  # The pool creates no shm segment; the shared fixture would count other
  # xdist workers' segments as this test's leak.
  yield


@pytest.fixture
def telemetry():
  from lddl_tpu_torch.telemetry import disable, enable
  tele = enable()
  yield tele
  disable()


@pytest.mark.parametrize('workers', [1, 2, 3])
def test_the_pooled_map_equals_the_serial_map(workers):
  items = [7, 3, 9, 1, 4, 8, 2, 6, 5, 0, 11]
  want = [tasks.mix(t, i) for i, t in enumerate(items)]
  with Executor(num_local_workers=workers) as ex:
    # A cost order unlike the index order: results still come back in
    # task order.
    assert ex.map(tasks.mix, items, cost_key=lambda t, i: t) == want
    assert ex.map(tasks.mix, items, gather=False) == list(enumerate(want))
    info = ex.scheduler_info()
    assert (ex._pool is not None) == (workers > 1)
  assert info['workers'] == workers and info['persistent_pool'] == (
      workers > 1)
  if workers > 1:
    assert info['start_method'] == 'forkserver'


def test_the_pool_is_persistent_and_reports_its_scheduling(telemetry):
  with Executor(num_local_workers=2) as ex:
    ex.map(tasks.mix, list(range(6)), label='a')
    pids = list(ex._pool.worker_pids)
    ex.map(tasks.mix, list(range(6)), label='b')
    assert ex._pool.worker_pids == pids
  assert ex._pool is None
  assert telemetry.counter('pipeline.a.tasks').total == 6
  assert telemetry.histogram('pipeline.b.worker_idle_seconds').count == 6
  assert telemetry.counter('pipeline.b.steals').total <= 6


def test_warmups_run_once_in_each_worker_and_again_on_respawn(tmp_path):
  warm = tmp_path / 'warm'
  warm.mkdir()
  with Executor(num_local_workers=2) as ex:
    ex.set_warmup(functools.partial(tasks.touch_pid_file, str(warm)),
                  key='warm')
    ex.set_warmup(functools.partial(tasks.touch_pid_file, str(warm)),
                  key='warm')  # a repeated key runs nothing more
    assert ex.map(tasks.mix, list(range(4))) == [0, 101, 202, 303]
    first = set(ex._pool.worker_pids)
    assert {p.name for p in warm.iterdir()} == {str(p) for p in first}
    late = tmp_path / 'late'
    late.mkdir()
    ex.set_warmup(functools.partial(tasks.touch_pid_file, str(late)),
                  key='late')  # broadcast to the running pool
    assert {p.name for p in late.iterdir()} == {str(p) for p in first}
    kill = functools.partial(tasks.kill_once, str(tmp_path / 'killed'))
    assert ex.map(kill, list(range(8))) == [101 * i for i in range(8)]
    fresh = set(ex._pool.worker_pids) - first
    assert len(fresh) == 1
  for d in (warm, late):
    files = {p.name: p.read_text() for p in d.iterdir()}
    assert set(files) == {str(p) for p in first | fresh}
    assert set(files.values()) == {'x'}


def test_a_task_error_carries_the_worker_traceback():
  with Executor(num_local_workers=2) as ex:
    with pytest.raises(TaskFailed) as err:
      ex.map(tasks.boom, list(range(5)))
    text = str(err.value)
    assert 'global index 2' in text and 'ValueError: task 2 exploded' in text
    assert 'torch_pool_tasks.py' in text and 'in boom' in text
    # The phase drained: the same pool serves the next one.
    assert ex.map(tasks.mix, [1, 2]) == [100, 201]


@pytest.mark.parametrize('rep', range(RESPAWN_REPS))
def test_a_single_kill_mid_task_is_respawned_and_retried(
    tmp_path, telemetry, rep):
  """The port's copy of ``tests/test_pool.py``'s respawn test."""
  del rep
  kill = functools.partial(tasks.kill_once, str(tmp_path / 'killed'))
  with Executor(num_local_workers=2) as ex:
    assert ex.map(kill, list(range(8))) == [101 * i for i in range(8)]
    assert telemetry.counter('pipeline.pool.respawns').total == 1
    # The same pool, the next phase: the respawned worker takes part.
    assert ex.map(tasks.mix, [5, 6, 7]) == [500, 601, 702]
    assert os.path.exists(tmp_path / 'killed')


@pytest.mark.parametrize('package', ['lddl_tpu', 'lddl_tpu_torch'])
def test_a_death_reruns_the_tasks_whose_writes_had_not_landed(
    tmp_path, telemetry, package):
  """One worker, whose write-back thread still holds the writes of tasks
  it reported done when it dies: the port runs them again and every file
  lands; lddl_tpu's pool retries the killed task alone and loses them."""
  out = tmp_path / 'out'
  out.mkdir()
  fn = functools.partial(tasks.slow_writes_kill_once,
                         f'{package}.pipeline.pool', str(tmp_path / 'killed'),
                         str(out))
  if package == 'lddl_tpu':
    pool = JWorkerPool(1, mp_context=multiprocessing.get_context(
        'forkserver'))
  else:
    pool = WorkerPool(1)
  try:
    records, _ = pool.run_phase(fn, [(i, i, -i) for i in range(6)])
  finally:
    pool.shutdown()
  assert sorted(r[1] for r in records) == list(range(6))
  landed = sorted(p.name for p in out.iterdir() if not p.name.startswith('.'))
  if package == 'lddl_tpu':
    assert landed != [str(i) for i in range(6)]
    return
  assert landed == [str(i) for i in range(6)]
  assert telemetry.counter('pipeline.pool.respawns').total == 1
  assert telemetry.counter('pipeline.pool.replays').total >= 1


def test_a_task_that_kills_twice_breaks_the_pool():
  with Executor(num_local_workers=2) as ex:
    with pytest.raises(PoolBroken, match='killed its worker twice'):
      ex.map(tasks.kill_always, list(range(8)))
    assert ex._pool is None  # dropped: the next map starts a new one
    assert ex.map(tasks.mix, [1, 2]) == [100, 201]


def test_the_reference_pool_stalls_where_the_port_recovers(tmp_path):
  """Confirms the mechanism of the reference's respawn stall (ROADMAP,
  "Found in the reference, repaired in the port"): with its dead worker's
  write lock held, lddl_tpu's pool finishes no phase of 8 tiny tasks in
  STALL_S seconds, and ends only when its workers are killed; the port's
  pool runs the same task through one respawn."""
  items = [(i, i, -i) for i in range(8)]  # run in index order
  kill = functools.partial(tasks.die_holding_result_lock,
                           str(tmp_path / 'ref'))
  pool = JWorkerPool(2, mp_context=multiprocessing.get_context('forkserver'))
  dog = Watchdog(STALL_S)
  t0 = time.monotonic()
  try:
    with pytest.raises(Exception) as err:
      pool.run_phase(kill, items)
  finally:
    dog.stop()
    pool.shutdown(force=True)
  assert dog.fired is not None, 'the reference pool did not stall'
  assert time.monotonic() - t0 >= STALL_S
  assert type(err.value).__name__ == 'PoolBroken'
  # The stall's state: every worker (the respawned one included) alive
  # and idle, none of them dead.
  assert len(dog.fired) == 2 and all(s != 'gone' for _, _, s in dog.fired)

  port = WorkerPool(2)
  try:
    kill = functools.partial(tasks.die_holding_result_lock,
                             str(tmp_path / 'port'))
    t0 = time.monotonic()
    records, _ = port.run_phase(kill, items)
    assert time.monotonic() - t0 < STALL_S
    assert sorted(r[2] for r in records) == [101 * i for i in range(8)]
  finally:
    port.shutdown()


def test_a_pooled_map_under_two_gloo_ranks():
  import torch_dist_ranks as ranks
  items = list(range(13))
  procs, q = ranks.start_world(ranks.pooled_map_ranks, 2, args=(items, 2),
                               deadline=DEADLINE_S - 10)
  res = ranks.join_world(procs, q, timeout=DEADLINE_S - 10)
  want = [tasks.mix(t, i) for i, t in enumerate(items)]
  for rank in (0, 1):
    assert res[rank]['gathered'] == want
    assert res[rank]['own'] == [(i, want[i]) for i in range(rank, 13, 2)]
    assert res[rank]['info']['persistent_pool']


# ---- the preprocessors under a pool ----

def _keep(c):
  """ASCII, Latin-1 and CJK (as in test_torch_preprocess.py)."""
  return ord(c) < 0x100 or 0x4e00 <= ord(c) <= 0x9fff


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
  src = str(tmp_path_factory.mktemp('torch_pool') / 'source')
  synth.write_corpus(src, 0.12, num_shards=2, seed=5)
  return src


def _read(src, num_blocks=5):
  return treaders.read_corpus([src], num_blocks=num_blocks, sample_ratio=0.9,
                              sample_seed=11)


def _files(sink):
  out = {}
  for name in sorted(os.listdir(sink)):
    if '.parquet' in name:
      with open(os.path.join(sink, name), 'rb') as f:
        out[name] = f.read()
  return out


BERT = dict(vocab_file=VOCAB, sentence_backend='rules', target_seq_length=128,
            bin_size=64, seed=11, masking=True, mask_backend='host')


@pytest.mark.parametrize('fmt', ['bert', 'packed'])
def test_three_workers_write_the_bytes_of_one(corpus, tmp_path, fmt):
  sinks = {}
  for workers in (1, 3):
    sink = str(tmp_path / f'w{workers}')
    with Executor(num_local_workers=workers) as ex:
      if fmt == 'bert':
        counts = tbert.run(_read(corpus), sink,
                           tbert.BertPretrainConfig(**BERT), executor=ex)
      else:
        counts = tpacked.run(_read(corpus), sink, tpacked.PackedPretrainConfig(
            vocab_file=VOCAB, sentence_backend='rules',
            target_seq_length=256, seed=11), executor=ex)
    sinks[workers] = (counts, _files(sink))
  assert sinks[3][0] == sinks[1][0]
  assert sum(n for c in sinks[1][0] for n in c.values()) > 50
  assert len(sinks[1][1]) > 4 and sinks[3][1] == sinks[1][1]


def test_auto_masks_on_the_host_under_a_pool_and_device_is_refused(
    corpus, tmp_path, capsys):
  assert tbert.resolve_pool_mask_backend('auto', 2) == 'host'
  with Executor(num_local_workers=2) as ex:
    with pytest.raises(ValueError, match='--mask-backend host'):
      tbert.run(_read(corpus), str(tmp_path / 'device'),
                tbert.BertPretrainConfig(**dict(BERT, mask_backend='device')),
                executor=ex)
    assert ex._pool is None  # refused before any worker started
    assert not os.path.exists(tmp_path / 'device')
    capsys.readouterr()
    auto = str(tmp_path / 'auto')
    tbert.run(_read(corpus), auto,
              tbert.BertPretrainConfig(**dict(BERT, mask_backend='auto')),
              executor=ex)
    assert 'mask=host' in capsys.readouterr().out
  host = str(tmp_path / 'host')
  tbert.run(_read(corpus), host, tbert.BertPretrainConfig(**BERT))
  assert _files(auto) == _files(host)


def test_the_cli_refuses_device_masking_with_workers(corpus, tmp_path):
  with pytest.raises(ValueError, match='--mask-backend host'):
    tbert.main(['--source', corpus, '--sink', str(tmp_path / 's'),
                '--vocab-file', VOCAB, '--num-blocks', '3', '--masking',
                '--sentence-backend', 'rules', '--num-workers', '2',
                '--mask-backend', 'device'])


def test_no_worker_outlives_its_pool():
  with Executor(num_local_workers=3) as ex:
    ex.map(tasks.mix, list(range(5)))
    pids = list(ex._pool.worker_pids)
  assert not [p for p in multiprocessing.active_children()
              if p.name.startswith('lddl-torch-pool')]
  assert [_state(pid) for pid in pids] == ['gone'] * 3
