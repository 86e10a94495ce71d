"""Spawned ranks for the port's multi-process CPU tests.

:func:`run_world` starts ``world`` spawned processes, each running
``fn(rank, world, *args)`` with the ``torch.distributed`` rendezvous
environment set (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
``WORLD_SIZE``, the port from ``bind(('localhost', 0))``), and returns
``{rank: result}``. The whole world has one deadline: a rank that has
not reported by then, or that dies without reporting, fails the call,
and every process still alive is killed, so a stuck rank fails its test
instead of holding the tier-1 run.

The rank functions live here, not in the test files: a spawned child
imports the module of its target, and this one imports torch and the
port only (never jax or lddl_tpu).
"""

import multiprocessing
import os
import queue
import socket
import time
import traceback

import numpy as np

WORLD_TIMEOUT = 120.0


def free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _entry(fn, rank, world, port, env, args, q):
  os.environ.update(env)
  os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port),
                    RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank))
  try:
    q.put((rank, 'ok', fn(rank, world, *args)))
  except BaseException:
    # Reported to the parent (it fails the test with the traceback).
    q.put((rank, 'error', traceback.format_exc()))
    raise
  finally:
    import torch.distributed as dist
    if dist.is_initialized():
      dist.destroy_process_group()


def start_world(fn, world, args=(), env=None, rank_env=None):
  """Start the ranks; returns ``(procs, queue)`` for :func:`join_world`.
  ``rank_env``: extra environment per rank (``{rank: {...}}``)."""
  ctx = multiprocessing.get_context('spawn')
  q = ctx.Queue()
  port = free_port()
  procs = []
  for r in range(world):
    e = dict(env or {})
    e.update((rank_env or {}).get(r, {}))
    procs.append(ctx.Process(target=_entry,
                             args=(fn, r, world, port, e, args, q),
                             daemon=True))
  for p in procs:
    p.start()
  return procs, q


def join_world(procs, q, timeout=WORLD_TIMEOUT, expect=None):
  """Collect the reports of the ranks in ``expect`` (default all) within
  ``timeout`` seconds, join every process, kill what is left; raises on
  a rank's error, a silent death or the deadline."""
  expect = set(range(len(procs)) if expect is None else expect)
  deadline = time.monotonic() + timeout
  results, errors = {}, {}
  try:
    while expect - set(results) - set(errors):
      left = deadline - time.monotonic()
      if left <= 0:
        raise TimeoutError(f'ranks {sorted(expect - set(results))} did not '
                           f'report within {timeout:.0f}s')
      try:
        rank, kind, payload = q.get(timeout=min(left, 0.5))
      except queue.Empty:
        silent = [r for r in expect - set(results) - set(errors)
                  if procs[r].exitcode is not None]
        if silent:
          # A rank that exited may still have a report in flight.
          try:
            rank, kind, payload = q.get(timeout=2.0)
          except queue.Empty:
            raise RuntimeError(
                f'rank {silent[0]} exited with {procs[silent[0]].exitcode} '
                'without reporting') from None
        else:
          continue
      (results if kind == 'ok' else errors)[rank] = payload
    for p in procs:
      p.join(max(deadline - time.monotonic(), 0.1))
  finally:
    for p in procs:
      if p.is_alive():
        p.kill()
        p.join(5)
  if errors:
    raise RuntimeError('rank failures:\n' + '\n'.join(
        f'-- rank {r}:\n{e}' for r, e in sorted(errors.items())))
  return results


def run_world(fn, world, args=(), env=None, timeout=WORLD_TIMEOUT):
  procs, q = start_world(fn, world, args, env)
  return join_world(procs, q, timeout)


# ---- rank functions ----


def comm_file_ranks(rank, world, d, n_gc=20):
  """tests/test_comm.py's FileBackend cases on the port's backend."""
  from lddl_tpu_torch.comm import FileBackend
  b = FileBackend(d, rank, world, timeout=30.0)
  got = b.allgather_object({'rank': rank, 'sq': rank * rank,
                            'pad': 'x' * (rank + 1) * 100})
  total = b.allreduce_sum(np.full((3,), rank, dtype=np.uint64))
  b.barrier()
  root_val = b.broadcast_object(f'from-{rank}', root=1)
  for i in range(n_gc):
    b.allgather_object(i)
  b.barrier()
  return got, total.tolist(), root_val


def comm_torch_ranks(rank, world):
  """The same cases on TorchDistBackend, plus its lease store (CAS,
  index listing, heartbeats) and topology."""
  import torch

  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.core.topology import discover_topology
  from lddl_tpu_torch.parallel.train import backend_for
  b = get_backend('torch')
  out = {'rank': b.rank, 'world': b.world_size,
         'backend': backend_for(b.group, torch.device('cpu'))}
  out['got'] = b.allgather_object({'rank': rank,
                                   'payload': 'x' * (rank + 1) * 100})
  out['total'] = b.allreduce_sum(np.full((4,), rank + 1,
                                         dtype=np.int64)).tolist()
  out['ftotal'] = b.allreduce_sum(np.full((2,), 0.5 * (rank + 1),
                                          dtype=np.float32)).tolist()
  out['utotal'] = b.allreduce_sum(np.full((2,), rank, np.uint64)).tolist()
  b.barrier()
  out['root'] = b.broadcast_object(f'from-{rank}', root=1)
  out['topology'] = tuple(discover_topology(b))
  store = b.lease_store('ph.0')
  b.barrier()
  out['claim'] = store.try_claim('claim.5.g0')
  out['claim_again'] = store.try_claim('claim.5.g0')
  store.publish(f'done.{rank}', f'r{rank}'.encode())
  store.heartbeat(7 + rank)
  b.barrier()
  out['claims'] = store.list('claim.')
  out['done'] = store.list('done.')
  out['reads'] = [store.read(f'done.{r}') for r in range(world)]
  out['missing'] = store.read('done.99')
  out['hb'] = [store.read_heartbeat(r) for r in range(world)]
  out['seq'] = b.collective_seq
  return out


def dp_steps(rank, world, cfg_kw, state, batches, opt_kw, seed=5):
  """Data-parallel steps of the port on this rank's rows of each global
  batch (:class:`TrainLoop` over ``make_mesh()`` and TorchDistBackend,
  CPU, gloo): per step the metrics and a digest of the parameters."""
  import torch

  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.parallel import local_batch, make_mesh
  from lddl_tpu_torch.training import TrainLoop
  comm = get_backend('torch')
  mesh = make_mesh(device_type='cpu')
  cfg = BertConfig(dtype=torch.float32, **cfg_kw)
  loop = TrainLoop.build(model_cfg=cfg, device='cpu', mesh=mesh, comm=comm,
                         seed=seed, **opt_kw)
  loop.model.load_state_dict({k: torch.from_numpy(v)
                              for k, v in state.items()})
  loop.model.train()
  out = []
  for batch in batches:
    mine = {k: torch.from_numpy(v) for k, v in
            local_batch(batch, mesh).items()}
    m = loop.step_fn(mine, loop.dropout_seed)
    out.append({'metrics': {k: float(v) for k, v in m.items()},
                'params': param_digest(loop.model)})
  return {'steps': out, 'dp': (loop.dp_rank, loop.dp_world),
          'backend': loop.step_fn.exchange.backend}


def param_digest(model):
  import hashlib
  h = hashlib.sha256()
  for name, t in model.state_dict().items():
    h.update(name.encode())
    h.update(t.detach().cpu().contiguous().numpy().tobytes())
  return h.hexdigest()


def shard_loop(rank, world, shards, vocab_file, batch, samples_seen=0,
               comm='torch', **kw):
  """A TrainLoop over the committed pairs shards at the tiny size, on
  the port's comm backend ``comm`` (``torch``: the data mesh)."""
  import torch

  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.parallel import make_mesh
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop
  backend = get_backend(comm)
  mesh = make_mesh(device_type='cpu') if comm == 'torch' else None
  tok = load_bert_tokenizer(vocab_file)
  cfg = BertConfig(vocab_size=((tok.vocab_size + 63) // 64) * 64,
                   hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, max_position_embeddings=512,
                   dropout_rate=0.0, dtype=torch.float32)
  return TrainLoop.build(
      shards, tok, model_cfg=cfg, device='cpu', learning_rate=1e-3,
      warmup_steps=2, total_steps=100, batch_size_per_rank=batch,
      bin_size=128, max_seq_length=512, seed=5, samples_seen=samples_seen,
      mesh=mesh, comm=backend, loader_kwargs={'shuffle_buffer_size': 16},
      **kw)


def bin_seq(loop, n=6):
  import itertools
  return [b['input_ids'].shape[1]
          for b in itertools.islice(iter(loop.loader), n)]


def train_and_save(rank, world, shards, vocab_file, ckpt, batch, steps):
  """World ``world`` trains ``steps`` steps from the shards and saves
  (rank 0 writes behind a barrier)."""
  loop = shard_loop(rank, world, shards, vocab_file, batch)
  losses = loop.run(steps, ckpt_dir=ckpt, log_every=0)
  return {'losses': losses, 'digest': loop.state_digest(),
          'meta': (loop.step, loop.samples_seen),
          'params': param_digest(loop.model)}


def restore_and_draw(rank, world, shards, vocab_file, ckpt, batch,
                     samples_seen):
  """World ``world`` restores the checkpoint and draws the next bins."""
  loop = shard_loop(rank, world, shards, vocab_file, batch,
                    samples_seen=samples_seen).restore(ckpt)
  return {'digest': loop.state_digest(),
          'meta': (loop.step, loop.samples_seen), 'bins': bin_seq(loop)}


def file_fleet_rank(rank, world, rdv, shards, vocab_file, ckpt_dir):
  """One rank of an elastic --comm file fleet (independent
  single-process worlds sharing a FileBackend membership store), as
  tests/test_faults.py's ``_train_rank``; the injected fault SIGKILLs
  rank 1 mid-training and rank 0 must detect it, checkpoint and stop."""
  from lddl_tpu_torch.comm import FileBackend
  from lddl_tpu_torch.training.elastic import RankMembership
  be = FileBackend(rdv, rank, world, timeout=60.0, run_id='train')
  loop = shard_loop(rank, world, shards, vocab_file, 4, comm='null',
                    dp_rank=rank, dp_world=world)
  membership = RankMembership(be.lease_store('train.membership'), rank,
                              world).start()
  be.barrier()  # both ranks are members before any fault can fire
  try:
    # max_steps is unreachable: only a membership event ends rank 0's run.
    losses = loop.run(100, ckpt_dir=(ckpt_dir if rank == 0 else None),
                      ckpt_every=2, log_every=0, membership=membership)
  finally:
    membership.stop()
  return {'stop_reason': loop.stop_reason, 'step': loop.step,
          'samples_seen': loop.samples_seen, 'steps_run': len(losses)}


def ledger_divergence_ranks(rank, world, directory, diverge):
  """Each rank records six collate digests (rank 1's fourth differs when
  ``diverge``), exchanges its ledger signals twice by
  ``divergence_over_comm`` over gloo, and asks a ledger_divergence
  sentinel after each exchange, twice: the verdicts and what fired."""
  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.telemetry import ledger
  from lddl_tpu_torch.telemetry.sentinel import Sentinel
  comm = get_backend('torch')
  led = ledger.enable_ledger(directory=directory, rank=rank)
  try:
    for i in range(6):
      digest = 'f' * 16 if diverge and rank == 1 and i == 3 else f'{i:016x}'
      led.record('collate', digest, epoch=0, index=i)
    sent = Sentinel(detectors=('ledger_divergence',))
    verdicts, fired = [], []
    for step in (1, 3):
      verdicts.append(ledger.divergence_over_comm(comm))
      for s in (step, step + 1):
        trig = sent.observe_step(s)
        fired.append(trig and trig['detector'])
    return verdicts, fired
  finally:
    ledger.disable_ledger()


# ---- parameter placement over fsdp and tensor ----


def replicated_digest(loop):
  """A digest of the parameters no rule cuts over ``tensor`` (the
  replicated ones), this rank's own copies: equal across a tensor group
  when they stay bit-equal. Collective on an fsdp loop."""
  import hashlib
  h = hashlib.sha256()
  with loop.step_fn.exchange.gathered():
    for (name, p), cut in zip(loop.model.named_parameters(),
                              loop.model.tensor_sharded()):
      if not cut:
        h.update(name.encode())
        # A copy: exporting the fsdp working buffer itself to numpy
        # would pin it.
        h.update(p.detach().clone().numpy().tobytes())
  return h.hexdigest()


def transient_peak_bytes(fn):
  """``fn()`` and the peak bytes of the storages it allocated and did not
  return, live at one time: what it needs beyond what it keeps. A storage
  is new where an op's output aliases none of the op's inputs, and lives
  while a tensor seen on it does (every view made through an op is seen)."""
  import weakref

  import torch
  from torch.utils._python_dispatch import TorchDispatchMode
  from torch.utils._pytree import tree_leaves

  live = {}  # storage data_ptr -> [uid, bytes, tensors alive]
  events = []  # (uid, +bytes when made / -bytes when freed), in order
  seen = set()

  def tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

  def drop(key, ident):
    seen.discard(ident)
    entry = live[key]
    entry[2] -= 1
    if entry[2] == 0:
      del live[key]
      events.append((entry[0], -entry[1]))

  class Track(TorchDispatchMode):

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      out = func(*args, **(kwargs or {}))
      inputs = {t.untyped_storage().data_ptr()
                for t in tensors((args, kwargs))}
      for t in tensors(out):
        key = t.untyped_storage().data_ptr()
        nbytes = t.untyped_storage().nbytes()
        if id(t) in seen or (key not in live and (key in inputs or
                                                  not nbytes)):
          continue
        if key in live:
          live[key][2] += 1
        else:
          live[key] = [len(events), nbytes, 1]
          events.append((len(events), nbytes))
        seen.add(id(t))
        weakref.finalize(t, drop, key, id(t))
      return out

  with Track():
    result = fn()
  end = len(events)
  kept = {live[k][0] for k in {t.untyped_storage().data_ptr()
                                for t in tensors(result)} if k in live}
  now = peak = 0
  for uid, nbytes in events[:end]:
    if uid not in kept:
      now += nbytes
      peak = max(peak, now)
  return result, peak


def mesh_loop(mesh, comm, cfg_kw, opt_kw, state=None, seed=5):
  """A tiny float32 TrainLoop on ``mesh`` with no loader; ``state``
  (a whole numpy state_dict) replaces its init."""
  import torch

  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.training import TrainLoop
  cfg = BertConfig(dtype=torch.float32, **cfg_kw)
  loop = TrainLoop.build(model_cfg=cfg, device='cpu', mesh=mesh, comm=comm,
                         seed=seed, **opt_kw)
  if state is not None:
    loop.load_whole_state({k: torch.from_numpy(v) for k, v in state.items()})
  loop.model.train()
  return loop


def mesh_case(rank, mesh, comm, case, opt_kw):
  """One case's steps on this rank's part of each global batch
  (``make_global_batch``): per step the metrics and the replicated
  digest; then the sizes the rank holds, its batch group's rank and size,
  the bytes a snapshot of the state needs beyond what it returns
  (:func:`transient_peak_bytes`) beside the exchange's flat buffer and, on
  rank 0, the gathered parameters; and the rows ``prefetch_to_device(...,
  mesh=mesh)`` places of the first batch's ``batch_rows`` block (what a
  loader built with ``dp_rank=batch_rank(mesh)`` yields)."""
  import torch.distributed as dist

  from lddl_tpu_torch.loader.device import (make_global_batch,
                                            prefetch_to_device)
  from lddl_tpu_torch.parallel import batch_group, batch_rows
  loop = mesh_loop(mesh, comm, case['cfg'], opt_kw, case.get('state'))
  first = case['batches'][0]
  mine = batch_rows(mesh, len(first['input_ids']))
  rows = {k: v[mine] for k, v in first.items()}
  fed = list(prefetch_to_device(iter([rows]), 'cpu',
                                mesh=mesh))[0]['input_ids'].numpy()
  steps = []
  for batch in case['batches']:
    m = loop.step_fn(make_global_batch(batch, mesh, device='cpu'),
                     loop.dropout_seed)
    steps.append({'metrics': {k: float(v) for k, v in m.items()},
                  'replicated': replicated_digest(loop)})
  exchange = loop.step_fn.exchange
  snap, transient = transient_peak_bytes(loop._snapshot)
  group = batch_group(mesh)
  out = {'steps': steps, 'dp': (loop.dp_rank, loop.dp_world), 'fed': fed,
         'exchange': type(exchange).__name__, 'backend': exchange.backend,
         'batch_group': (dist.get_rank(group), dist.get_world_size(group)),
         'save_bytes': {'transient': transient, 'flat': exchange.flat.numel()
                        * exchange.flat.element_size()},
         'digest': loop.state_digest(),
         'sizes': {'whole': sum(v.numel() for v in snap['model'].values()),
                   'local': sum(p.numel() for p in loop.model.parameters()),
                   'opt': sum(p.numel() for p in loop.opt.params),
                   'mu': sum(t.numel() for t in loop.opt.mu),
                   'nu': sum(t.numel() for t in loop.opt.nu)}}
  full = getattr(exchange, 'full', None)
  if full is not None:
    out['sizes']['working_bytes_at_rest'] = full.untyped_storage().nbytes()
  if rank == 0:
    out['state'] = {k: v.numpy() for k, v in snap['model'].items()}
  return out, loop


def mesh_steps(rank, world, axes, cases, opt_kw, ckpt=None):
  """Every case of ``cases`` (``{'cfg', 'batches', 'state'}``) on a mesh
  of ``axes`` (gloo, CPU, torch at two threads a rank: the test process
  runs JAX beside them). With ``ckpt`` (``{'dir', 'case', 'next'}``) the
  loop of case ``case`` also saves into ``dir`` and then steps on the
  ``next`` global batch."""
  import torch

  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.loader.device import make_global_batch
  from lddl_tpu_torch.parallel import make_mesh
  torch.set_num_threads(2)
  comm = get_backend('torch')
  mesh = make_mesh(device_type='cpu', **axes)
  out = []
  for i, case in enumerate(cases):
    res, loop = mesh_case(rank, mesh, comm, case, opt_kw)
    if ckpt is not None and ckpt['case'] == i:
      loop.step = len(case['batches'])
      loop.save(ckpt['dir'])
      m = loop.step_fn(make_global_batch(ckpt['next'], mesh, device='cpu'),
                       loop.dropout_seed)
      res['next'] = {k: float(v) for k, v in m.items()}
    out.append(res)
  return out


def tp_world(rank, world, axes, cases, opt_kw, restore, cli, counted):
  """A tensor mesh of ``axes``: the cases (:func:`mesh_steps`); the model's
  refusals (on a seq=2 mesh, flash attention); a
  world-1 checkpoint restored (``restore``: ``{'dir', 'cfg', 'next'}``),
  its digest and the next step; ``TrainLoop.run``'s counters
  (:func:`counted_run` over ``counted``'s batches); then the pretrain
  CLI with ``--tp 2`` (``cli``: its argv)."""
  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.loader.device import make_global_batch
  from lddl_tpu_torch.models import BertConfig, BertForPretraining
  from lddl_tpu_torch.parallel import make_mesh, mesh_summary
  from lddl_tpu_torch.training import pretrain
  out = {'cases': mesh_steps(rank, world, axes, cases, opt_kw)}
  comm = get_backend('torch')
  mesh = make_mesh(device_type='cpu', **axes)
  out['refused'] = {}
  for what, kw in (('num_heads', {'num_heads': 1, 'hidden_size': 32}),
                   ('intermediate_size', {'intermediate_size': 33}),
                   ('vocab_size', {'vocab_size': 129})):
    try:
      BertForPretraining(BertConfig(**dict(restore['cfg'], **kw)), mesh)
    except ValueError as e:
      out['refused'][what] = str(e)
  seq_mesh = make_mesh(tensor=1, seq=2, device_type='cpu')
  out['seq_mesh'] = mesh_summary(seq_mesh)
  try:
    BertForPretraining(BertConfig(**dict(restore['cfg'],
                                         attention_impl='flash')), seq_mesh)
  except ValueError as e:
    out['refused']['seq'] = str(e)
  out['rows'] = make_global_batch(restore['next'], mesh,
                                  device='cpu')['input_ids'].numpy()
  out['counted'] = counted_run(mesh, comm, dict(restore['cfg']), opt_kw,
                               counted)
  loop = mesh_loop(mesh, comm, restore['cfg'], opt_kw).restore(
      restore['dir'])
  out['restored'] = {'digest': loop.state_digest(),
                     'replicated': replicated_digest(loop),
                     'meta': (loop.step, loop.samples_seen)}
  m = loop.step_fn(make_global_batch(restore['next'], mesh, device='cpu'),
                   loop.dropout_seed)
  out['restored']['next'] = {k: float(v) for k, v in m.items()}
  cli_loop = pretrain.main(cli)
  out['cli'] = {'step': cli_loop.step, 'samples': cli_loop.samples_seen,
                'dp': (cli_loop.dp_rank, cli_loop.dp_world),
                'local': sum(p.numel() for p in cli_loop.model.parameters()),
                'heads': cli_loop.model.encoder.layers[0].attention.heads,
                'digest': cli_loop.state_digest()}
  return out


class ListLoader:
  """Batches in order, one epoch, as a loader with a ``batch_size``."""

  def __init__(self, batches, batch_size):
    self.batches = batches
    self.batch_size = batch_size

  def __iter__(self):
    return iter(self.batches)


def counted_run(mesh, comm, cfg_kw, opt_kw, batches):
  """``TrainLoop.run`` over this rank's rows of ``batches`` with the
  telemetry on: the loop's sample counters and its flop count."""
  from lddl_tpu_torch.models.flops import bert_pretrain_flops_per_step
  from lddl_tpu_torch.parallel import local_batch
  from lddl_tpu_torch.telemetry import metrics
  tele = metrics.enable()
  try:
    loop = mesh_loop(mesh, comm, cfg_kw, opt_kw)
    mine = [local_batch(b, mesh) for b in batches]
    loop.loader = ListLoader(mine, len(mine[0]['input_ids']))
    loop.run(len(mine), log_every=0)
    b, s = mine[0]['input_ids'].shape
    return {'samples': tele.counter('train.samples').total,
            'samples_seen': loop.samples_seen,
            'flops': loop.flops_per_step(b, s),
            'model_flops': bert_pretrain_flops_per_step(loop.model.cfg, b, s),
            'mfu_count': tele.gauge('train.mfu').count}
  finally:
    metrics.disable()


# ---- sequence parallelism: ring attention over the seq axis ----


def ring_shards(rank, world, cases):
  """Each case of ``cases`` (``{'n', 'impl', 'q', 'k', 'v', 'mask',
  'seg', 'g'}``, whole numpy arrays) through the port's ``ring_attention``
  on a ring of ``n`` ranks (groups of consecutive ranks; n=1 without a
  group): this rank's shard of the output and of dq, dk, dv for the
  cotangent ``g``, keyed by case index, from the ranks of the first ring
  (the others run the same case on theirs)."""
  import torch
  import torch.distributed as dist

  from lddl_tpu_torch.parallel.ring import ring_attention
  dist.init_process_group('gloo')
  torch.set_num_threads(1)
  groups = {}
  for n in sorted({c['n'] for c in cases}):
    # new_group is collective: every rank makes every ring of every size.
    for first in range(0, world, n):
      g = dist.new_group(list(range(first, first + n)))
      if first <= rank < first + n:
        groups[n] = g
  out = {}
  for i, c in enumerate(cases):
    n = c['n']
    group = groups[n] if n > 1 else None
    r = rank % n
    per = c['q'].shape[2] // n
    cols = slice(r * per, (r + 1) * per)
    q, k, v = (torch.from_numpy(c[x][:, :, cols]).requires_grad_()
               for x in ('q', 'k', 'v'))
    mask = torch.from_numpy(c['mask'][:, cols])
    seg = None if c['seg'] is None else torch.from_numpy(c['seg'][:, cols])
    o = ring_attention(q, k, v, mask, group=group, block_impl=c['impl'],
                       q_segment_ids=seg, kv_segment_ids=seg)
    o.backward(torch.from_numpy(c['g'][:, :, cols]))
    if rank < n:
      out[i] = {'out': o.detach().numpy(), 'dq': q.grad.numpy(),
                'dk': k.grad.numpy(), 'dv': v.grad.numpy()}
  return out


def seq_case(rank, mesh, comm, case, opt_kw):
  """One case on a seq mesh: the deterministic forward's logits on the
  first batch, the first step's gradients on it summed over the ranks
  (rank 0), then the steps' metrics and replicated digests and the final
  whole state (:func:`mesh_case`'s), with ``case['max_predictions']``."""
  import torch
  import torch.distributed as dist

  from lddl_tpu_torch.loader.device import make_global_batch
  from lddl_tpu_torch.parallel.mesh import reduce_group
  from lddl_tpu_torch.parallel.train import pretrain_loss
  kw = dict(opt_kw, max_predictions=case.get('max_predictions'))
  loop = mesh_loop(mesh, comm, case['cfg'], kw, case.get('state'))
  first = make_global_batch(case['batches'][0], mesh, device='cpu')
  model = loop.model
  exchange = loop.step_fn.exchange
  out = {'seq_rank': model.sp.rank if model.sp is not None else 0,
         'fed_cols': first['input_ids'].numpy(), 'grads': {}}
  with exchange.gathered():
    model.eval()
    with torch.no_grad():
      mlm, nsp = model(first['input_ids'], first['token_type_ids'],
                       first['attention_mask'],
                       segment_ids=first.get('segment_ids'))
    out['logits'] = (mlm.numpy(), nsp.numpy())
    model.train()
    loss, _ = pretrain_loss(model, first,
                            max_predictions=kw['max_predictions'],
                            reduce=exchange.sum_)
    loss.backward()
    for name, p in model.named_parameters():
      g = p.grad.detach().clone()
      dist.all_reduce(g, group=reduce_group(mesh))
      if rank == 0:
        out['grads'][name] = g.numpy()
      p.grad = None
  res, _ = mesh_case(rank, mesh, comm, case, kw)
  out.update(res)
  return out


def seq_world(rank, world, axes, cases, opt_kw, cli=None):
  """A mesh of ``axes`` with seq above 1 (gloo, CPU, two torch threads a
  rank): every case (:func:`seq_case`); the model's refusal of flash on
  the seq mesh; with ``cli``, the pretrain CLI's argv run after."""
  import torch

  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.models import BertConfig, BertForPretraining
  from lddl_tpu_torch.parallel import make_mesh, mesh_summary
  from lddl_tpu_torch.training import pretrain
  torch.set_num_threads(2)
  comm = get_backend('torch')
  mesh = make_mesh(device_type='cpu', **axes)
  out = {'mesh': mesh_summary(mesh),
         'cases': [seq_case(rank, mesh, comm, c, opt_kw) for c in cases]}
  try:
    BertForPretraining(BertConfig(**dict(cases[0]['cfg'],
                                         attention_impl='flash')), mesh)
  except ValueError as e:
    out['refused'] = str(e)
  if cli is not None:
    loop = pretrain.main(cli)
    out['cli'] = {'step': loop.step, 'samples': loop.samples_seen,
                  'dp': (loop.dp_rank, loop.dp_world),
                  'mesh': mesh_summary(loop.mesh),
                  'digest': loop.state_digest()}
  return out


# ---- step replay of a sharded run, launched as its ranks ----


def _cli(main, argv):
  """``main(argv)`` with its stdout and stderr captured: ``(rc, out,
  err)``."""
  import contextlib
  import io
  out, err = io.StringIO(), io.StringIO()
  with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
    rc = main(argv)
  return rc, out.getvalue(), err.getvalue()


def _record(rank, layout, root, run_kw, init=None, incident=None):
  """Record ``layout``'s run on this rank: ``TrainLoop.run`` over its
  mesh with the ledger on (this rank's file), a checkpoint every
  ``run_kw['ckpt_every']`` (with ``init``, the whole state loaded and a
  checkpoint at step 0 first); with ``incident`` (a fault spec) the
  sentinel and the flight recorder on, into this rank's incident dir.
  Returns the losses and the batch coordinates of the first ordinals."""
  import torch

  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.core import faults
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.parallel import make_mesh
  from lddl_tpu_torch.telemetry import ledger, sentinel
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop, flight
  comm = get_backend('torch')
  mesh = make_mesh(device_type='cpu', **layout['axes'])
  d = os.path.join(root, layout['name'])
  ledger._active = None
  ledger.enable_ledger(directory=os.path.join(d, 'ledger'), rank=rank)
  if incident is not None:
    os.environ['LDDL_FAULTS'] = incident
    faults.reset()
    sentinel.enable_sentinel()
    flight.enable_flight(out_dir=os.path.join(d, 'incidents', f'rank{rank}'))
  try:
    cfg = BertConfig(**layout['cfg'])
    loop = TrainLoop.build(
        layout['path'], load_bert_tokenizer(layout['vocab']), model_cfg=cfg,
        device='cpu', mesh=mesh, comm=comm, **layout['build'])
    if init is not None:
      loop.load_whole_state({k: torch.from_numpy(v) for k, v in init.items()})
      loop.save(os.path.join(d, 'ckpt'))
    losses = loop.run(run_kw['steps'], ckpt_dir=os.path.join(d, 'ckpt'),
                      ckpt_every=run_kw['ckpt_every'], log_every=0)
    coords = [loop.loader.coordinate_of_batch(o)
              for o in range(run_kw['steps'])]
  finally:
    ledger.disable_ledger()
    ledger._active = None
    if incident is not None:
      del os.environ['LDDL_FAULTS']
      faults.reset()
      sentinel.disable_sentinel()
      flight.disable_flight()
  return {'losses': losses, 'coords': coords, 'dp': (loop.dp_rank,
                                                      loop.dp_world)}


def replay_ranks(rank, world, root, layouts, replay_kw, parity):
  """Each layout of ``layouts`` recorded (:func:`_record`) and replayed by
  the replay CLI launched as this world's ranks (``--comm torch``): step
  ``replay_kw['target']`` from the corpus, the same step from bundles
  that ``bundle`` wrote launched as ranks, and (``flip``) from a
  checkpoint with one flipped bit; ``bisect --per-sample`` where the
  layout asks, and for an ``incident`` layout the incident CLI's bisect
  and replay over each rank's incident. Then ``parity``: a float32 run,
  dropout off, from ``parity['init']`` (polled for: the test writes it
  once lddl_tpu has drawn it), bisected through ``bisect_window``.
  Returns every command's exit code and rank 0's output, and seconds per
  layout."""
  import time

  import numpy as np
  import torch

  from lddl_tpu_torch.replay.cli import main as replay
  from lddl_tpu_torch.training.flight import main as incident
  torch.set_num_threads(2)
  out = {}
  for layout in layouts:
    t0 = time.perf_counter()
    name, d = layout['name'], os.path.join(root, layout['name'])
    res = out[name] = {'record': _record(rank, layout, root, replay_kw,
                                         incident=layout.get('incident'))}
    target = replay_kw['target']
    base = (['--checkpoint-dir', os.path.join(d, 'ckpt'), '--ledger',
             os.path.join(d, 'ledger')] + layout['model_argv'] +
            layout['mesh_argv'])
    step = ['step', '--step', str(target)]
    res['corpus'] = _cli(replay, step + base + layout['loader_argv'])
    bundles = []
    for o in range(replay_kw['ckpt_every'], target):
      e, i = res['record']['coords'][o]
      bundles.append(os.path.join(d, 'bundles', f'step{o + 1}'))
      res.setdefault('bundle', []).append(_cli(replay, [
          'bundle', os.path.join(d, 'ledger'), '--key',
          f'epoch={e},index={i}', '--out', bundles[-1]] +
          layout['bundle_argv'] + layout['mesh_argv']))
    res['bundled'] = _cli(replay, step + base + layout['bundled_argv'] +
                          [a for b in bundles for a in ('--bundle', b)])
    res['bundle_ranks'] = (sorted(os.listdir(bundles[0]))
                           if os.path.isdir(bundles[0]) else None)
    if layout.get('flip'):
      flipped = os.path.join(d, 'ckpt_flipped')
      if rank == 0:
        from chip_smoke import flip_a_bit
        flip_a_bit(os.path.join(d, 'ckpt'), replay_kw['ckpt_every'],
                   flipped)
      torch.distributed.barrier()
      argv = [a if a != os.path.join(d, 'ckpt') else flipped for a in base]
      res['flipped'] = _cli(replay, step + argv + layout['loader_argv'])
    window = ['--lo', str(replay_kw['ckpt_every']), '--hi', str(target),
              '--per-sample', '--json']
    if layout.get('bisect') or layout.get('incident'):
      res['bisect'] = _cli(replay, ['bisect'] + window + base +
                           layout['loader_argv'])
    if layout.get('incident'):
      inc = os.path.join(d, 'incidents', 'rank{rank}')
      found = sorted(os.listdir(os.path.join(d, 'incidents', f'rank{rank}')))
      res['incidents'] = found
      path = os.path.join(inc, found[0])
      res['incident_bisect'] = _cli(incident, [
          'bisect', path, '--', '--per-sample', '--json'] + base[2:] +
          layout['loader_argv'])
      res['incident_replay'] = _cli(incident, [
          'replay', path, '--', '--step', str(target)] + base +
          layout['bundled_argv'])
    res['seconds'] = time.perf_counter() - t0
  if parity is None:
    return out
  t0 = time.perf_counter()
  deadline = time.monotonic() + 90
  while not os.path.exists(parity['init']):
    if time.monotonic() > deadline:
      raise TimeoutError(f'no {parity["init"]}')
    time.sleep(0.1)
  time.sleep(0.5)  # the writer renames it into place; let the fs settle
  init = dict(np.load(parity['init']))
  layout = parity['layout']
  kw = dict(replay_kw, steps=parity['steps'])
  res = out['parity'] = {'record': _record(rank, layout, root, kw,
                                           init=init)}
  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.parallel import make_mesh
  from lddl_tpu_torch.replay.steps import bisect_window
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop
  d = os.path.join(root, layout['name'])
  loop = TrainLoop.build(
      layout['path'], load_bert_tokenizer(layout['vocab']),
      model_cfg=BertConfig(**layout['cfg']), device='cpu',
      mesh=make_mesh(device_type='cpu', **layout['axes']),
      comm=get_backend('torch'), **layout['build'])
  res['bisect'] = bisect_window(loop, os.path.join(d, 'ckpt'), 0,
                                parity['steps'], per_sample=True,
                                ledger_path=os.path.join(d, 'ledger'))
  res['seconds'] = time.perf_counter() - t0
  return out
