"""Tasks and warmup hooks for the pool tests (``tests/test_torch_pool.py``).

They live in a module of their own, which imports the stdlib only: a pool
worker imports the module of each task it unpickles, and this one costs it
neither torch nor jax nor either package.
"""

import os
import signal
import sys


def mix(task, idx):
  """Depends on the task and its index: a scheduler that pairs the wrong
  two, or returns results out of order, shows."""
  return task * 100 + idx


def boom(task, idx):
  if idx == 2:
    raise ValueError(f'task {task} exploded')
  return task


def touch_pid_file(directory):
  """A warmup hook: one character a run into a file named by this pid."""
  with open(os.path.join(directory, str(os.getpid())), 'a') as f:
    f.write('x')


def kill_once(marker, task, idx):
  """SIGKILL this worker in task 3, the first time only (the marker file
  remembers across processes)."""
  if idx == 3 and not os.path.exists(marker):
    open(marker, 'w').close()
    os.kill(os.getpid(), signal.SIGKILL)
  return task * 100 + idx


def kill_always(task, idx):
  if idx == 3:
    os.kill(os.getpid(), signal.SIGKILL)
  return task * 100 + idx


def die_holding_result_lock(marker, task, idx):
  """SIGKILL this worker in task 3, once, while it holds the lock a writer
  of lddl_tpu's shared result queue takes for each message (as its feeder
  thread does for every result it sends). In lddl_tpu's worker loop the
  caller's frame holds that queue as ``result_q``; the port's worker has
  no shared queue, and just dies."""
  if idx == 3 and not os.path.exists(marker):
    open(marker, 'w').close()
    result_q = sys._getframe(1).f_locals.get('result_q')
    if result_q is not None:
      result_q._wlock.acquire()
    os.kill(os.getpid(), signal.SIGKILL)
  return task * 100 + idx


def write_slowly(out_dir, idx):
  """A write-back job: ``out_dir/<idx>``, after a pause, by an atomic
  rename."""
  import time
  time.sleep(0.3)
  tmp = os.path.join(out_dir, f'.{idx}.{os.getpid()}.tmp')
  with open(tmp, 'w') as f:
    f.write(str(idx))
  os.replace(tmp, os.path.join(out_dir, str(idx)))


def slow_writes_kill_once(pool_module, marker, out_dir, task, idx):
  """Hand ``out_dir/<idx>`` to this worker's write-back thread (that of
  the pool in ``pool_module``) and return; task 3 first SIGKILLs this
  worker, once, while earlier tasks' writes still wait on that thread."""
  import importlib
  if idx == 3 and not os.path.exists(marker):
    open(marker, 'w').close()
    os.kill(os.getpid(), signal.SIGKILL)
  writer = importlib.import_module(pool_module).current_writer()
  writer.submit(write_slowly, out_dir, idx)
  return task
