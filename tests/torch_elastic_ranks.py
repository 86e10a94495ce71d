"""Ranks and tasks for the port's elastic executor tests
(``tests/test_torch_elastic_executor.py``).

They live in a module of their own, which imports the stdlib, numpy and
the port only: a spawned rank, and a pool worker, import the module of
their target, and this one costs them neither jax nor lddl_tpu.
"""

import functools
import os
import time

import numpy as np


def write_shard(out_dir, sec, seed, gi):
  """Writes one shard that is a function of ``(task, global_index)``
  only, the contract the elastic path's byte identity rides on."""
  from lddl_tpu_torch.pipeline.parquet_io import Table, write_shard_file
  time.sleep(sec)
  values = np.array([seed * 1000 + gi * 10 + k for k in range(20)],
                    dtype=np.int64)
  write_shard_file(Table({'v': values}, [('v', 'int64')]),
                   os.path.join(out_dir, f'part.{gi}.parquet'))
  return ('ok', gi, seed)


def fail_at(bad, task, gi):
  """Raises at global index ``bad``; elsewhere a small result."""
  if gi == bad:
    raise ValueError(f'task {gi} exploded')
  return task * 10 + gi


def reference_shards(out_dir, tasks):
  """The fault-free static-stride run (one process, no comm)."""
  from lddl_tpu_torch.pipeline.executor import Executor
  os.makedirs(out_dir, exist_ok=True)
  with Executor(num_local_workers=1) as ex:
    return ex.map(functools.partial(write_shard, out_dir, 0.0), tasks,
                  label='ref')


def _report(q, rank, fn):
  try:
    q.put((rank, 'completed', fn()))
  except BaseException as e:  # noqa: BLE001 - the test reads every outcome
    q.put((rank, 'error', f'{type(e).__name__}: {e}'))


def elastic_rank(rendezvous, rank, world, out_dir, tasks, env, q,
                 workers=1, sec=0.2):
  """One file-backend rank: a barrier (both ranks claim before a fault
  fires), then a lease-claimed map writing one shard a task."""
  os.environ.update(env)

  def run():
    import multiprocessing

    from lddl_tpu_torch.comm import FileBackend
    from lddl_tpu_torch.pipeline.executor import Executor
    multiprocessing.current_process().daemon = False  # may start a pool
    be = FileBackend(rendezvous, rank, world, timeout=60.0, run_id='el')
    be.barrier()
    with Executor(comm=be, num_local_workers=workers) as ex:
      out = ex.map(functools.partial(write_shard, out_dir, sec), tasks,
                   label='shards')
      own = ex.map(functools.partial(fail_at, -1), tasks, gather=False,
                   label='own')
      info = ex.scheduler_info()
    return {'out': out, 'own': own, 'elastic': info['elastic']}

  _report(q, rank, run)


def failing_rank(rendezvous, rank, world, tasks, bad, q):
  """One file-backend rank of a map whose task ``bad`` raises."""
  def run():
    from lddl_tpu_torch.comm import FileBackend
    from lddl_tpu_torch.pipeline.executor import Executor
    be = FileBackend(rendezvous, rank, world, timeout=60.0, run_id='err')
    be.barrier()
    with Executor(comm=be) as ex:
      return ex.map(functools.partial(fail_at, bad), tasks, label='err')

  _report(q, rank, run)


def resume_rank(rendezvous, out_dir, tasks, env, q):
  """A world-1 elastic run (the file backend's default), for the
  kill-then-restart tests; reports its resume_skipped count too."""
  os.environ.update(env)

  def run():
    from lddl_tpu_torch.comm import FileBackend
    from lddl_tpu_torch.pipeline.executor import Executor
    from lddl_tpu_torch.telemetry import get_telemetry
    from lddl_tpu_torch.telemetry.ledger import get_ledger
    be = FileBackend(rendezvous, 0, 1, timeout=60.0, run_id='resume')
    with Executor(comm=be, num_local_workers=1) as ex:
      out = ex.map(functools.partial(write_shard, out_dir, 0.0), tasks,
                   label='shards')
    get_ledger().flush()
    skipped = get_telemetry().counter('pipeline.elastic.resume_skipped')
    return out, getattr(skipped, 'total', None)

  _report(q, 0, run)


def torch_elastic_rank(rank, world, out_dir, tasks):
  """A rank of a ``torch.distributed`` world (gloo) running the elastic
  map over the process group's store (``LDDL_ELASTIC=1``): run by
  ``torch_dist_ranks.start_world``."""
  import torch_dist_ranks
  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.pipeline.executor import Executor
  be = get_backend('torch')
  be.barrier()
  torch_dist_ranks.doing('torch_elastic_rank: the elastic map')
  with Executor(comm=be) as ex:
    out = ex.map(functools.partial(write_shard, out_dir, 0.2), tasks,
                 label='shards')
    info = ex.scheduler_info()
  return {'out': out, 'elastic': info['elastic']}


def preprocess_rank(rendezvous, rank, world, argv, env, q):
  """The port's BERT preprocess CLI as one ``--comm file`` rank."""
  os.environ.update(env, LDDL_COMM_DIR=rendezvous, LDDL_RANK=str(rank),
                    LDDL_WORLD_SIZE=str(world))

  def run():
    import torch

    from lddl_tpu_torch.preprocess import bert
    from lddl_tpu_torch.telemetry import get_telemetry
    torch.set_num_threads(1)
    counts = bert.main([*argv, '--comm', 'file'])
    tele = get_telemetry()
    return {'counts': counts,
            'tasks': tele.counter('pipeline.process.tasks').total}

  _report(q, rank, run)
