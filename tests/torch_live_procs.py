"""Spawned processes of tests/test_torch_service.py and
tests/test_torch_monitor.py.

A spawned child imports the module of its target; this one imports the
port only (never jax or lddl_tpu), so a client starts in about a second.
"""

import hashlib
import json
import os
import time

import numpy as np


def digest(batch):
  """sha256 over a batch dict's keys and array bytes, in key order."""
  h = hashlib.sha256()
  for k in sorted(batch):
    h.update(k.encode())
    h.update(np.ascontiguousarray(batch[k]).tobytes())
  return h.hexdigest()


def union_client(rank, rdv, run_id, url, out_path, faults_spec, gate=None,
                 pace=0.0):
  """Drain epoch 0 as ``rank`` of a two-rank FileBackend fleet, appending
  one JSONL record per delivered batch (flushed at once, so a SIGKILLed
  client's delivered set survives it). ``gate=(path, n)``: start only
  once ``path`` holds ``n`` records (at most 60 s); ``pace``: seconds a
  batch takes to consume, as a train step does."""
  if gate is not None:
    for _ in range(6000):
      if len(read_records(gate[0])) >= gate[1]:
        break
      time.sleep(0.01)
    else:
      raise TimeoutError(f'{gate[0]} never held {gate[1]} records')
  os.environ['LDDL_DATA_SERVER'] = url
  os.environ['LDDL_COMM_HEARTBEAT'] = '0.1'
  os.environ['LDDL_LEASE_TIMEOUT'] = '10'
  if faults_spec:
    os.environ['LDDL_FAULTS'] = faults_spec
  from lddl_tpu_torch.comm import FileBackend
  from lddl_tpu_torch.loader.service import NetworkBatchSource
  comm = FileBackend(rdv, rank=rank, world_size=2, run_id=run_id)
  src = NetworkBatchSource(comm=comm, timeout=10, retries=2)
  with open(out_path, 'w') as f:
    for gi, batch in src.iter_steps(0):
      f.write(json.dumps({'gi': gi, 'digest': digest(batch)}) + '\n')
      f.flush()
      time.sleep(pace)


def read_records(path):
  """``{gi: digest}`` of what a client wrote (empty if it wrote nothing)."""
  if not os.path.exists(path):
    return {}
  out = {}
  with open(path) as f:
    for line in f:
      line = line.strip()
      if line:
        rec = json.loads(line)
        out[rec['gi']] = rec['digest']
  return out


def straggler_rank(rank, rdzv, q):
  """One rank of a two-rank FileBackend fleet with a deterministic skew
  (rank 0: 100 tasks in a 10 s window, rank 1: 20): reports its
  straggler_over_comm table and the exported rank-1 gauge on ``q``."""
  try:
    os.environ['LDDL_TELEMETRY'] = '1'
    from lddl_tpu_torch.comm import FileBackend
    from lddl_tpu_torch.telemetry import get_telemetry
    from lddl_tpu_torch.telemetry.live import (SnapshotWindow,
                                               straggler_over_comm)
    comm = FileBackend(rdzv, rank, 2, timeout=120.0)
    w = SnapshotWindow()
    tasks = 100 if rank == 0 else 20
    for mono, total in ((0.0, 0), (10.0, tasks)):
      w.push([{'kind': 'meta', 'rank': rank, 'pid': 1,
               'unix_time': 1e9 + mono, 'monotonic': mono},
              {'kind': 'counter', 'rank': rank,
               'name': 'pipeline.encode.tasks', 'total': total}])
    result = straggler_over_comm(comm, w)
    exported = get_telemetry().gauge('straggler.rank1.score').value
    q.put((rank, None, {'scores': result['scores'],
                        'slowest': result['slowest'],
                        'seq': result['seq'],
                        'mismatch': result.get('seq_mismatch'),
                        'exported_rank1': exported}))
  except BaseException as e:
    import traceback
    q.put((rank, f'{e!r}\n{traceback.format_exc()}', None))
    raise
