#!/usr/bin/env python3
"""Reads the state of lddl_tpu's worker pool when its respawn test stalls.

    python tests/reference_pool_stall.py [--runs 100] [--stall-s 15]

Runs the scenario of ``tests/test_pool.py``'s
``test_single_worker_death_respawns_and_retries`` (two workers, 8 tasks,
task 3 SIGKILLs its worker once, then a second phase on the same pool)
``--runs`` times against lddl_tpu's pool and as many against the port's.
A run that has not finished after ``--stall-s`` seconds is a stall: the
script then reads, before it kills the workers, whether the write lock of
the reference pool's shared result queue is held (its semaphore's value,
0 when held) and each worker's state, and prints one line a stall and a
summary of both pools. It needs lddl_tpu (and so jax), and runs on the
CPU; the stall is a race, so its count varies from run to run.
"""

import argparse
import functools
import multiprocessing
import os
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def _state(pid):
  try:
    with open(f'/proc/{pid}/stat') as f:
      letter = f.read().rsplit(')', 1)[1].split()[0]
    with open(f'/proc/{pid}/wchan') as f:
      return f'{letter} in {f.read() or "-"}'
  except OSError:
    return 'gone'


def one_run(executor_cls, marker, stall_s):
  """One scenario; returns None, or at a stall what the watchdog read."""
  import torch_pool_tasks as tasks
  done = threading.Event()
  seen = []
  box = {}

  def watchdog():
    if done.wait(stall_s):
      return
    pool = getattr(box.get('ex'), '_pool', None)
    lock = getattr(getattr(pool, '_result_q', None), '_wlock', None)
    value = lock._semlock._get_value() if lock is not None else None
    seen.append({'result_lock_value': value,
                 'workers': [(p.name, _state(p.pid))
                             for p in multiprocessing.active_children()]})
    while not done.is_set():
      for p in multiprocessing.active_children():
        p.kill()
      done.wait(0.2)

  threading.Thread(target=watchdog, daemon=True).start()
  kill = functools.partial(tasks.kill_once, marker)
  try:
    with executor_cls(num_local_workers=2) as ex:
      box['ex'] = ex
      ex.map(kill, list(range(8)))
      ex.map(tasks.mix, [5, 6, 7])
  except Exception:  # noqa: BLE001 - the watchdog's kill ends a stall
    pass
  finally:
    done.set()
  return seen[0] if seen else None


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--runs', type=int, default=100)
  parser.add_argument('--stall-s', type=float, default=15.0)
  args = parser.parse_args()
  import jax  # noqa: F401 - lddl_tpu's pool takes the forkserver with jax
  from lddl_tpu.pipeline import Executor as JExecutor
  from lddl_tpu_torch.pipeline.executor import Executor
  with tempfile.TemporaryDirectory(prefix='pool_stall_') as tmp:
    for name, cls in (('lddl_tpu', JExecutor), ('port', Executor)):
      stalls = 0
      t0 = time.monotonic()
      for i in range(args.runs):
        marker = os.path.join(tmp, f'{name}.{i}')
        seen = one_run(cls, marker, args.stall_s)
        if seen is not None:
          stalls += 1
          print(f'{name} run {i}: stalled; {seen}', flush=True)
      print(f'{name}: {stalls} stalls in {args.runs} runs '
            f'({time.monotonic() - t0:.1f} s)', flush=True)


if __name__ == '__main__':
  main()
