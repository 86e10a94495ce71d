"""BERT pretraining loop on one CUDA card: steps + checkpoint/resume.

Counterpart of :class:`lddl_tpu.training.pretrain.TrainLoop`. A
checkpoint holds the model and optimizer state, the dropout key and the
``(step, samples_seen)`` counters, so a restart resumes the parameter
trajectory and the data-stream position together.

``build(path, tokenizer, ...)`` makes the loop and its corpus loader
over a balanced shard directory that :mod:`lddl_tpu` wrote: NSP pairs
(:func:`~lddl_tpu_torch.loader.bert.get_bert_pretrain_data_loader`) or,
with ``data_format='packed'``, packed long-context rows
(:func:`~lddl_tpu_torch.loader.packed.get_packed_pretrain_data_loader`),
whose ``block_diagonal=True`` batches carry ``segment_ids``: the feed
copies every key and the train step then runs block-diagonal attention
and the per-document MLM loss. ``build(path=None, ...)`` makes a loop
without a corpus; the caller attaches ``loop.loader``, any iterable of
loader-format batch dicts with a ``batch_size`` attribute, or replays
steps from bundled batches (:func:`~lddl_tpu_torch.replay.steps.
replay_steps`). :meth:`TrainLoop.restore` re-seeks a loader that has the
loader's ``seek`` contract to the restored ``samples_seen``.
``loader_kwargs={'num_workers': W, 'vocab_file': ...}`` (``tokenizer``
None) collates in W worker processes
(:class:`~lddl_tpu_torch.loader.workers.MultiprocessLoader`), which start
afresh every epoch and end with the epoch's feed, whatever ends it.

CLI: ``python -m lddl_tpu_torch.training.pretrain --path <balanced>
--vocab-file <vocab> ...`` (:func:`main`).

Checkpoints are ``torch.save`` files, written into a temporary directory
and renamed into place, so a reader sees a step whole or not at all. They
do not interchange with the JAX loop's orbax checkpoints.

:class:`CompiledStepCache` is the counterpart of the JAX loop's cache of
one compiled executable per bin: on the card it captures the step into
one CUDA graph per batch signature and replays it (``LDDL_STEP_CACHE=0``
runs every step eagerly). :meth:`TrainLoop.run` carries the JAX loop's
hooks: ``train.*`` telemetry and trace spans, MFU, the sentinels, the
step profiler, fault injection, the preemption guard, the async
checkpoint writer and rank membership. With telemetry on, the cache
counts a step's FLOPs and operand bytes at its miss (the port's step
cost model, :mod:`~lddl_tpu_torch.telemetry.step_costs`, where the JAX
loop asks XLA's cost analysis) and bills them every step as
``train.xla_flops`` / ``train.xla_bytes``, which the roofline verdict
reads; MFU then takes the counted FLOPs as its numerator, as the JAX
loop takes XLA's, and the analytic count where no count exists. With
``LDDL_MONITOR`` set, ``run`` starts the live monitor
(:mod:`~lddl_tpu_torch.telemetry.server`) for this rank.

With ``LDDL_LEDGER`` on, every checkpoint also records the ledger's
``step`` line: :func:`state_fingerprint` of the state it writes (params,
AdamW moments and count, dropout key), keyed by ``step`` with
``samples`` and ``loss`` as context, as the JAX loop records it; and
``run`` then runs under deterministic algorithms
(:func:`deterministic_algorithms`), so the recorded steps re-execute
bit for bit (:mod:`lddl_tpu_torch.replay`, ``python -m
lddl_tpu_torch.replay.cli``). ``build`` for a CUDA device then sets the
deterministic cuBLAS workspace (:func:`require_deterministic_cublas`)
before the model brings CUDA up; a ledger turned on after CUDA started
without it makes ``run`` refuse. Step digests do not compare across the
two frameworks; the lines' keys and fields do. With ``LDDL_SENTINEL``
on, ``run`` tees the host batches into the flight recorder's ring
(:mod:`~lddl_tpu_torch.training.flight`) and freezes an incident
directory when a sentinel fires.

Multi-process training: ``build(..., mesh=make_mesh(data, fsdp, tensor,
seq), comm=...)`` over a ``torch.distributed`` group gives each ``data x
fsdp`` rank its share of the shards (the ranks of a tensor or seq group
read the same rows) and a step that reduces over those ranks and the seq
ranks (:class:`~lddl_tpu_torch.parallel.train.DataParallel`, or
:class:`~lddl_tpu_torch.parallel.train.ShardedDataParallel` with
``fsdp`` above 1, which shards the flat parameters and AdamW's moments);
with ``tensor`` above 1 the model holds its tensor shards (``_RULES``);
with ``seq`` above 1 (``attention_impl`` 'ring' or 'ring_flash') the
feed keeps each rank's ``1 / seq`` of every row
(:func:`~lddl_tpu_torch.parallel.mesh.seq_shard`) and ring attention
runs over the seq group.
The global batch is ``batch_size_per_rank * dp_world``, ``dp_world``
the ``data x fsdp`` product. Every rank gathers the whole state at a
checkpoint and rank 0 writes it behind a barrier, so a checkpoint
restores at any world size and layout. ``fsdp`` or ``tensor`` above 1
with the ledger on: every rank fingerprints the gathered state.
Under ``--comm file`` the ranks are independent single-process worlds
that share membership and telemetry only, as in the JAX package.
Launch the CLI multi-process with ``python -m torch.distributed.run
--nproc-per-node N -m lddl_tpu_torch.training.pretrain --comm torch
...``; ranks that share one card need ``LDDL_DIST_CUDA_BACKEND=gloo``
and ``--device cuda:0``.
"""

import argparse
import contextlib
import functools
import json
import logging
import math
import os
import shutil
import tempfile
import time

import torch

from ..comm import NullBackend, get_backend
from ..core import faults
from ..core.topology import discover_topology
from ..loader.bert import get_bert_pretrain_data_loader
from ..loader.device import coordinate_from, prefetch_to_device
from ..loader.packed import get_packed_pretrain_data_loader
from ..models.bert import BertConfig, BertForPretraining
from ..models.flops import bert_pretrain_flops_per_step, peak_flops_per_device
from ..ops import flash_attention as tfa
from ..parallel.mesh import (axis_size, batch_rank, batch_size, make_mesh,
                             mesh_summary, reshard_state)
from ..parallel.train import (AdamW, CapturedGraph, TrainStep, capture_step,
                              check_max_predictions, make_exchange,
                              signature, step_counter)
from ..parallel.train import learning_rate as lr_schedule
from ..telemetry import (get_step_profiler, get_telemetry, get_tracer,
                         rank_file_name, sample_hbm, trace_file_name)
from ..telemetry.ledger import fingerprint_batch, get_ledger
from ..telemetry.roofline import hbm_limits
from ..telemetry.server import get_monitor, maybe_start_monitor
from ..telemetry.sentinel import get_sentinel
from ..tokenization.wordpiece import load_bert_tokenizer
from .elastic import (AsyncCheckpointWriter, PreemptionGuard,
                      async_ckpt_enabled, maybe_membership, reseek_loader)

MODEL_SIZES = {
    'tiny': dict(hidden_size=128, num_layers=2, num_heads=2,
                 intermediate_size=512),
    'base': dict(hidden_size=768, num_layers=12, num_heads=12,
                 intermediate_size=3072),
    'large': dict(hidden_size=1024, num_layers=24, num_heads=16,
                  intermediate_size=4096),
}

_STEP_PREFIX = 'step_'
_STATE_FILE = 'state.pt'
_META_FILE = 'meta.json'


def resolve_device(device=None):
  """``None`` means the CUDA card; it raises when there is none rather
  than falling back to the CPU. Pass ``'cpu'`` to run there on purpose."""
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError('no CUDA device available; pass device="cpu" to '
                         'run lddl_tpu_torch on the CPU')
    device = 'cuda'
  return torch.device(device)


def rank_device(device, comm):
  """This rank's device: ``device``, or with None the CUDA card
  ``cuda:<local rank>`` (:func:`resolve_device`: it raises without one),
  made the process's current CUDA device. Call it before the mesh:
  DeviceMesh picks ``cuda:<LOCAL_RANK>`` for a process that has not
  chosen, and ranks sharing one card have chosen ``cuda:0``."""
  if device is None and torch.cuda.is_available():
    device = f'cuda:{discover_topology(comm).local_rank}'
  device = resolve_device(device)
  if device.type == 'cuda':
    if device.index is None:
      device = torch.device('cuda', torch.cuda.current_device())
    torch.cuda.set_device(device)
  return device


def _step_dirs(ckpt_dir):
  """``[(step, path)]`` of the step directories, newest first."""
  found = []
  for name in sorted(os.listdir(ckpt_dir)):
    if name.startswith(_STEP_PREFIX) and name[len(_STEP_PREFIX):].isdigit():
      found.append((int(name[len(_STEP_PREFIX):]),
                    os.path.join(ckpt_dir, name)))
  return sorted(found, reverse=True)


def _read_meta(path):
  with open(os.path.join(path, _META_FILE)) as f:
    meta = json.load(f)
  return int(meta['step']), int(meta['samples_seen'])


#: The cuBLAS workspace settings under which its GEMMs repeat bit for
#: bit (``torch.use_deterministic_algorithms`` requires one of them).
DETERMINISTIC_CUBLAS = (':4096:8', ':16:8')


def require_deterministic_cublas():
  """Make sure ``CUBLAS_WORKSPACE_CONFIG`` holds a deterministic
  setting. cuBLAS reads it when the process first uses the card, so it
  is set here while CUDA is not initialised yet; a process whose CUDA
  began without it is refused with ``ValueError`` (its GEMMs may not
  repeat, whatever the flags say now)."""
  if os.environ.get('CUBLAS_WORKSPACE_CONFIG') in DETERMINISTIC_CUBLAS:
    return
  if torch.cuda.is_initialized():
    raise ValueError(
        'deterministic training needs CUBLAS_WORKSPACE_CONFIG='
        f'{DETERMINISTIC_CUBLAS[0]} set before CUDA initialises; this '
        'process initialised CUDA without it (set it in the environment '
        'that starts the process)')
  os.environ['CUBLAS_WORKSPACE_CONFIG'] = DETERMINISTIC_CUBLAS[0]


@contextlib.contextmanager
def deterministic_algorithms(device):
  """Run the enclosed steps under ``torch.use_deterministic_algorithms
  (True)`` (an op without a deterministic kernel raises, it never warns),
  with the deterministic cuBLAS workspace on a CUDA ``device``; the
  previous setting comes back after. :meth:`TrainLoop.run` runs so while
  the ledger is on, and step replay always: a recorded ``step`` line is
  reproducible by construction, as the JAX package's TPU steps are."""
  if torch.device(device).type == 'cuda':
    require_deterministic_cublas()
  was = (torch.are_deterministic_algorithms_enabled(),
         torch.is_deterministic_algorithms_warn_only_enabled())
  torch.use_deterministic_algorithms(True)
  try:
    yield
  finally:
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _host_arrays(obj):
  """``obj`` with every (CPU) tensor as a numpy array."""
  if torch.is_tensor(obj):
    return obj.detach().cpu().numpy()
  if isinstance(obj, dict):
    return {k: _host_arrays(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(_host_arrays(v) for v in obj)
  return obj


def state_fingerprint(snap, algo=None):
  """Content fingerprint of a train-state snapshot (the CPU copy
  :meth:`TrainLoop.save` writes: model params, the AdamW count and
  moments, the dropout seed), the digest the ledger's ``step`` boundary
  records: :func:`~lddl_tpu_torch.telemetry.ledger.fingerprint_batch` in
  the ledger's algorithm (or ``algo``), as the JAX package's
  ``state_fingerprint``. Module-level so :mod:`lddl_tpu_torch.replay` can
  diff a re-executed step against the recorded line without a live
  ledger."""
  return fingerprint_batch(_host_arrays(snap), algo)


def _cpu_copy(obj):
  """``obj`` (dicts, lists, tensors, plain values) with every tensor
  copied to the CPU."""
  if torch.is_tensor(obj):
    return obj.detach().to('cpu', copy=True)
  if isinstance(obj, dict):
    return {k: _cpu_copy(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(_cpu_copy(v) for v in obj)
  return obj


def packed_tiles(batch, model):
  """``(total, computed, kv_computed)`` tile pairs of one head that a
  packed batch's K4 launches test and compute on this rank
  (:func:`~lddl_tpu_torch.ops.flash_attention.ring_tiles`: under ``seq``
  the rank's q columns against every shard's kv columns, the ring's
  blocks), counted once a batch. The feed's batches carry their whole
  rows' ids on the host (:class:`~lddl_tpu_torch.loader.device.
  PlacedBatch`), and keep the count; any other batch is read from the
  device, where under ``seq`` above 1 the rank holds its own columns
  only: None then, and the step is billed the miss's count."""
  if getattr(batch, 'tiles', None) is not None:
    return batch.tiles
  sp = getattr(model, 'sp', None)
  ids = getattr(batch, 'host_segment_ids', None)
  if ids is None:
    if sp is not None:
      return None
    ids = batch['segment_ids'].cpu().numpy()
  tiles = tfa.ring_tiles(ids, model.cfg.head_dim,
                         *((0, 1) if sp is None else (sp.rank, sp.size)))
  if hasattr(batch, 'tiles'):
    batch.tiles = tiles
  return tiles


class CompiledStepCache:
  """Per-bin captured train step: one CUDA graph per batch signature.

  The counterpart of :class:`lddl_tpu.training.pretrain.CompiledStepCache`
  (one compiled executable per bin). ``step`` is a
  :class:`~lddl_tpu_torch.parallel.train.TrainStep`; calling the cache
  with ``(batch, dropout_seed)`` runs one step and returns its metrics.

  - **A miss** (the first batch of a signature,
    :func:`~lddl_tpu_torch.parallel.train.signature`) copies the batch
    into new static input buffers, runs the real step eagerly on a side
    stream (the warm-up that capture needs, and the step itself), then
    captures the step into a ``torch.cuda.CUDAGraph`` with its own memory
    pool, reading those buffers
    (:func:`~lddl_tpu_torch.parallel.train.capture_step`). Capture
    executes nothing; the host count does not advance and the kernels'
    launch counters are put back, the capture's launches kept as the
    entry's per-replay count. A capture that fails raises and names the
    op; it never falls back to eager. The miss is timed into
    ``train.retrace_seconds`` and counted in
    ``train.step_cache_misses``.
  - **A hit** copies the batch into the entry's static inputs on the
    current stream (which the feed made wait for the batch), reseeds the
    dropout generators the graph registered, replays, and adds the
    launches the entry recorded at capture to the wrappers' counters
    (``tfa.launches``); the kernels' own count on the device
    (``tfa.device_launches()``) measures the replayed launches. Counted
    in ``train.step_cache_hits``.

  Bins replay in any order, so each graph keeps its own pool. A graph
  fixes the kernels chosen when it was captured, so an entry also keys
  on whether deterministic algorithms were on. The outputs of a hit are
  the graph's static tensors, overwritten by the entry's next replay.
  Batches on the CPU run the step eagerly and are counted the same way
  (the kernel wrappers take their plain versions there); so does a
  data-parallel step whose group cannot run inside a graph (gloo for
  CUDA tensors, :attr:`~lddl_tpu_torch.parallel.train.DataParallel.
  capturable`): :attr:`mode` says which the card runs. Under NCCL the
  step's all-reduces are captured with the rest of it.

  **Step costs.** With telemetry on, a miss counts its step
  (:mod:`~lddl_tpu_torch.telemetry.step_costs`): a captured entry in the
  capture's warm-up, which runs the same step eagerly, an eager entry by
  running the miss's step under the counter. Every step of a counted
  entry, hit or miss, bills the count as ``train.xla_flops`` /
  ``train.xla_bytes`` (two counter adds, as the JAX cache bills XLA's
  cost analysis) and sets ``last_costs`` to ``(flops, bytes)``, the
  train loop's MFU numerator. A packed step's attention FLOPs follow its
  own batch: the count's K4 FLOPs scaled by the attention tiles this
  batch computes over those of the counted batch
  (:meth:`~lddl_tpu_torch.telemetry.step_costs.StepCosts.bill`), under
  ``seq`` every ring block's (:func:`packed_tiles`). With
  telemetry off at the miss nothing is counted, and the entry's steps
  leave ``last_costs`` None.
  """

  def __init__(self, step):
    self.step = step
    # (signature, deterministic) -> CapturedGraph, or None for a CPU batch's.
    self._graphs = {}
    self._stream = None   # the side stream misses run and capture on
    self.hits = 0
    self.misses = 0
    self.retrace_seconds = 0.0
    # (signature, deterministic) -> the StepCosts of its step (counted).
    self._costs = {}
    self.last_costs = None
    self._tele = tele = get_telemetry()
    self._hits_c = tele.counter('train.step_cache_hits')
    self._misses_c = tele.counter('train.step_cache_misses')
    self._retrace_h = tele.histogram('train.retrace_seconds')
    self._flops_c = tele.counter('train.xla_flops')
    self._bytes_c = tele.counter('train.xla_bytes')

  @property
  def mode(self):
    """``'graph'``, or ``'eager'`` when the step cannot be captured."""
    return 'graph' if getattr(self.step, 'capturable', True) else 'eager'

  def __call__(self, batch, dropout_seed):
    key = (signature(batch), torch.are_deterministic_algorithms_enabled())
    if key not in self._graphs:
      t0 = time.perf_counter()
      counter = step_counter()
      if (next(iter(batch.values())).device.type == 'cuda' and
          self.mode == 'graph'):
        metrics, self._graphs[key] = self._miss(key, batch, dropout_seed,
                                                counter)
      else:
        with counter or contextlib.nullcontext():
          metrics = self.step(batch, dropout_seed)
        self._graphs[key] = None
      if counter is not None:
        self._costs[key] = counter.costs
        tiles = (packed_tiles(batch, self.step.model)
                 if counter.costs.seg_flops else None)
        if tiles is not None:
          _, counter.costs.seg_tiles, counter.costs.seg_kv_tiles = tiles
      self._count(False, time.perf_counter() - t0)
      self._bill(key, batch)
      return metrics
    entry = self._graphs[key]
    if entry is None:
      metrics = self.step(batch, dropout_seed)
      self._count(True, 0.0)
      self._bill(key, batch)
      return metrics
    for name, t in batch.items():
      entry.inputs[name].copy_(t)
    self.step.prepare(dropout_seed)
    entry.graph.replay()
    for name, n in entry.launches.items():
      tfa.launches[name] += n
    self.step.finish()
    self._count(True, 0.0)
    self._bill(key, batch)
    return entry.outputs

  def _bill(self, key, batch):
    """Set ``last_costs`` for this step and bill it to ``train.xla_*``."""
    costs = self._costs.get(key)
    if costs is None or not self._tele.enabled:
      self.last_costs = None
      return
    tiles = (packed_tiles(batch, self.step.model) if costs.seg_flops
             else None)
    self.last_costs = costs.bill(None if tiles is None else tiles[1:])
    self._flops_c.add(self.last_costs[0])
    self._bytes_c.add(self.last_costs[1])

  def _count(self, hit, seconds):
    if hit:
      self.hits += 1
      self._hits_c.add(1)
      return
    self.misses += 1
    self.retrace_seconds += seconds
    self._misses_c.add(1)
    self._retrace_h.observe(seconds)

  def _miss(self, key, batch, dropout_seed, counter):
    if self._stream is None:
      self._stream = torch.cuda.Stream()
    inputs = {name: t.clone() for name, t in batch.items()}
    self.step.prepare(dropout_seed)
    metrics, graph, outputs, launches = capture_step(
        self._stream, lambda: self.step.body(inputs),
        lambda: self.step.body(inputs), self.step.generators(),
        f'the train step for batch signature {key[0]}', counter)
    self.step.finish()
    return metrics, CapturedGraph(graph, inputs, outputs, launches,
                                  counter and counter.costs)


def _step_cache_enabled():
  return os.environ.get('LDDL_STEP_CACHE', '').strip().lower() not in (
      '0', 'false', 'off', 'no')


def export_telemetry(comm=None):
  """Write this rank's telemetry and trace under ``LDDL_TELEMETRY_DIR``,
  then merge every rank's telemetry over ``comm`` (default a one-rank
  :class:`~lddl_tpu_torch.comm.NullBackend`) and print the cross-rank
  report on rank 0 (:mod:`~lddl_tpu_torch.telemetry.report`), as the
  JAX package's ``export_telemetry(comm)``.

  The files are ``telemetry.rank<R>.jsonl`` when telemetry is on, with
  the ``hbm.*`` gauges sampled just before (while the run goes, the live
  monitor samples them at its scrape cadence), and
  ``trace.rank<R>.jsonl`` when tracing is on. Returns the paths written;
  nothing without the directory. Every rank must call it when telemetry
  is on (the merge is a collective).
  """
  from ..telemetry.report import aggregate_over_comm, render_report
  comm = comm or NullBackend()
  rank = comm.rank
  out_dir = os.environ.get('LDDL_TELEMETRY_DIR')
  written = []
  tracer = get_tracer()
  if tracer.enabled and out_dir:
    tracer.set_identity(rank=rank)
    written.append(tracer.write_jsonl(trace_file_name(out_dir, rank),
                                      rank=rank))
  tele = get_telemetry()
  if not tele.enabled:
    return written
  sample_hbm(tele)
  if out_dir:
    written.append(tele.write_jsonl(rank_file_name(out_dir, rank),
                                    rank=rank))
  merged = aggregate_over_comm(comm, telemetry=tele)
  if rank == 0:
    print(render_report(merged))
  return written


class TrainLoop:
  """Owns the model, the optimizer, the loader, the step and its cache,
  and the step counters.

  ``mesh``: None (one process holds the whole batch) or a mesh
  (:func:`~lddl_tpu_torch.parallel.mesh.make_mesh`): the model holds its
  ``tensor`` shards, the step's ``exchange``
  (:func:`~lddl_tpu_torch.parallel.train.make_exchange`) reduces over the
  ``data x fsdp`` ranks and with ``fsdp`` above 1 shards the parameters
  and AdamW's moments (``opt`` is then built on ``exchange.opt_params``),
  and a checkpoint holds the whole state, gathered.
  """

  def __init__(self, model, opt, device, dropout_seed, loader=None,
               max_predictions=None, dp_rank=0, dp_world=1, mesh=None,
               exchange=None):
    self.model = model
    self.opt = opt
    self.device = device
    self.dropout_seed = dropout_seed
    self.loader = loader
    self.max_predictions = max_predictions
    self.dp_rank = dp_rank
    self.dp_world = dp_world
    self.mesh = mesh
    if exchange is None and mesh is not None:
      exchange = make_exchange(mesh, model)
    self.step_fn = TrainStep(model, opt, max_predictions, exchange,
                             dp_rank=dp_rank)
    # Made by the first run() with LDDL_STEP_CACHE on and kept, so repeated
    # run() calls, epochs and restore() replay the same per-bin graphs.
    self.step_cache = None
    self.samples_seen = 0
    self.step = 0
    # Why the last run() stopped early (preemption, non-finite loss), or
    # None when it ran to max_steps.
    self.stop_reason = None
    self._last_saved = -1
    # The latest step loss, carried onto the ledger's ``step`` record as
    # context (never part of its key).
    self._last_loss = None

  @classmethod
  def build(cls, path=None, tokenizer=None, *, model_cfg, device=None,
            learning_rate=1e-4, warmup_steps=100, total_steps=10000,
            weight_decay=0.01, batch_size_per_rank=64, bin_size=None,
            max_seq_length=512, masking='dynamic', seed=127, samples_seen=0,
            loader_kwargs=None, max_predictions=None, data_format='pairs',
            block_diagonal=False, dp_rank=None, dp_world=None, mesh=None,
            comm=None):
    """A loop with freshly initialised params (flax's init distributions,
    drawn from ``seed`` on the CPU, then moved to ``device``) and the
    corpus loader over ``path``, as the JAX loop's ``build``
    (``lddl_tpu/training/pretrain.py:201-278``); :meth:`restore` moves it
    to a checkpoint.

    ``dp_rank``/``dp_world`` default to ``comm``'s rank and world size
    (the JAX ``build`` takes ``jax.process_index()``/``process_count()``);
    with a ``mesh`` they are its ``(data, fsdp)`` coordinates
    (:func:`~lddl_tpu_torch.parallel.mesh.batch_rank`, ``batch_size``),
    since the loader's shard and the gradient group must agree: the ranks
    of a tensor group read the same rows. Every rank draws the same
    initial parameters from ``seed`` (the whole model, on the CPU) and
    keeps its shards of them, so every layout starts where world 1 does.

    ``tokenizer``: the special ids, ``vocab_size`` and
    ``convert_tokens_to_ids``
    (:func:`~lddl_tpu_torch.tokenization.wordpiece.load_bert_tokenizer`);
    None loads one from ``loader_kwargs['vocab_file']``; with
    ``loader_kwargs['num_workers']`` it must be None (each worker builds
    its own from ``vocab_file``). The loader is positioned at
    ``samples_seen`` and the step counter at
    ``samples_seen // (batch_size_per_rank * dp_world)``. ``dp_rank`` and
    ``dp_world`` pick this rank's share of the shards. With ``path=None``
    the loop has no loader: the caller
    attaches ``loop.loader``, and ``max_seq_length`` and ``masking``
    describe it for :func:`check_max_predictions`.
    """
    if block_diagonal and data_format != 'packed':
      raise ValueError("block_diagonal requires data_format='packed' "
                       '(pair shards carry no doc_offsets)')
    comm = comm or NullBackend()
    if mesh is not None:
      dp_rank = batch_rank(mesh) if dp_rank is None else dp_rank
      dp_world = batch_size(mesh) if dp_world is None else dp_world
      if (dp_rank, dp_world) != (batch_rank(mesh), batch_size(mesh)):
        raise ValueError(f'dp_rank={dp_rank} dp_world={dp_world} disagree '
                         f'with the mesh ({mesh_summary(mesh)}, data x '
                         f'fsdp rank {batch_rank(mesh)} of '
                         f'{batch_size(mesh)})')
    dp_rank = comm.rank if dp_rank is None else dp_rank
    dp_world = comm.world_size if dp_world is None else dp_world
    device = resolve_device(device)
    if device.type == 'cuda' and get_ledger().enabled:
      # run() records under deterministic algorithms, whose cuBLAS
      # workspace must be set before the model brings CUDA up.
      require_deterministic_cublas()
    if path is None:
      loader = None
    elif data_format == 'packed':
      # Long-context document-packed shards: always dynamic masking, no
      # NSP pairs.
      if masking != 'dynamic':
        raise ValueError("data_format='packed' supports masking='dynamic' "
                         'only (no stored masks in packed shards)')
      loader = get_packed_pretrain_data_loader(
          path,
          dp_rank=dp_rank,
          dp_world_size=dp_world,
          batch_size_per_rank=batch_size_per_rank,
          tokenizer=tokenizer,
          max_seq_length=max_seq_length,
          bin_size=bin_size,
          base_seed=seed,
          samples_seen=samples_seen,
          block_diagonal=block_diagonal,
          **(loader_kwargs or {}))
    else:
      loader = get_bert_pretrain_data_loader(
          path,
          dp_rank=dp_rank,
          dp_world_size=dp_world,
          batch_size_per_rank=batch_size_per_rank,
          tokenizer=tokenizer,
          masking=masking,
          max_seq_length=max_seq_length,
          bin_size=bin_size,
          base_seed=seed,
          samples_seen=samples_seen,
          **(loader_kwargs or {}))
    model = BertForPretraining(
        model_cfg, mesh=mesh, generator=torch.Generator().manual_seed(seed))
    model.to(device)
    exchange = make_exchange(mesh, model)
    schedule = functools.partial(lr_schedule, peak=learning_rate,
                                 warmup_steps=warmup_steps,
                                 total_steps=total_steps)
    opt = AdamW(model.parameters() if exchange is None else
                exchange.opt_params(model.parameters()), schedule,
                weight_decay=weight_decay)
    if max_predictions is not None:
      check_max_predictions(
          max_predictions, max_seq_length, masking,
          mlm_probability=(loader_kwargs or {}).get('mlm_probability', 0.15))
    loop = cls(model, opt, device, dropout_seed=seed + 1, loader=loader,
               max_predictions=max_predictions, dp_rank=dp_rank,
               dp_world=dp_world, mesh=mesh, exchange=exchange)
    loop.samples_seen = samples_seen
    loop.step = samples_seen // (batch_size_per_rank * dp_world)
    return loop

  def flops_per_step(self, batch, seq_len):
    """Analytic FLOPs of this rank's step at ``[batch, seq_len]`` (MFU
    numerator; ``seq_len`` the whole row's): the model's on the rank's
    rows, divided by ``tensor x seq``, whose ranks split the work of those
    rows."""
    flops = bert_pretrain_flops_per_step(
        self.model.cfg, batch, seq_len, max_predictions=self.max_predictions)
    split = axis_size(self.mesh, 'tensor') * axis_size(self.mesh, 'seq')
    return flops if split == 1 else flops / split

  # ---- checkpointing ----

  def _sharded(self):
    """Whether this rank holds shards of the state (``fsdp`` or
    ``tensor`` above 1)."""
    return self.mesh is not None and (axis_size(self.mesh, 'fsdp') > 1 or
                                      self.model.tp is not None)

  def _state(self):
    """The whole train state in world 1's layout: the live tensors on an
    unsharded loop, else :meth:`_snapshot`'s gathered CPU copy."""
    if self._sharded():
      return self._snapshot()
    return {'model': self.model.state_dict(),
            'opt': self.opt.state_dict(),
            'dropout_seed': self.dropout_seed}

  def _snapshot(self):
    """A CPU copy of the whole train state, world 1's layout whatever the
    mesh: the model's ``state_dict`` and AdamW's moments aligned with
    ``parameters()``. On a sharded loop every rank gathers it (the
    tensor shards over the tensor group, the fsdp shards of the
    parameters and moments over fsdp): a collective every rank calls.
    The parameters, ``mu`` and ``nu`` are gathered one after the other
    and copied to the CPU a tensor at a time, so the device holds no
    flat state beyond what a step holds."""
    if not self._sharded():
      return _cpu_copy(self._state())
    names = [n for n, _ in self.model.named_parameters()]
    parts = []
    for local in self.step_fn.exchange.local_states(
        self.model.parameters(), self.opt):
      # One whole tensor at a time on the device, then on the CPU.
      parts.append({n: _cpu_copy(self.model.whole(n, t))
                    for n, t in zip(names, local)})
    model, mu, nu = parts
    return {'model': {k: model[k] for k in self.model.state_dict()},
            'opt': {'count': self.opt.count, 'mu': [mu[n] for n in names],
                    'nu': [nu[n] for n in names]},
            'dropout_seed': self.dropout_seed}

  def load_whole_state(self, model_state, opt_state=None):
    """Copy a whole (world 1's layout) model ``state_dict`` and, if given,
    AdamW's state into this rank's shards (:func:`~lddl_tpu_torch.
    parallel.mesh.reshard_state`): the restore path, also for a state
    made elsewhere (a converted JAX init). Collective on an fsdp loop."""
    if not self._sharded():
      self.model.load_state_dict(model_state)
      if opt_state is not None:
        self.opt.load_state_dict(opt_state)
      return
    exchange = self.step_fn.exchange
    with exchange.gathered(), torch.no_grad():
      self.model.load_whole_state_dict(model_state)
      exchange.load_params()
    if opt_state is None:
      return
    names = [n for n, _ in self.model.named_parameters()]
    moments = [reshard_state(dict(zip(names, opt_state[k])), self.mesh,
                             like=self.model) for k in ('mu', 'nu')]
    exchange.load_local(self.opt, *([m[n] for n in names]
                                    for m in moments))
    self.opt.count = int(opt_state['count'])
    self.opt.count_t.fill_(self.opt.count)

  def _shared(self):
    """Whether several ranks hold this one train state: rank 0 alone
    writes it."""
    import torch.distributed as dist
    return self.mesh is not None and dist.get_world_size() > 1

  def _rank(self):
    """This process's rank in the whole world (0 without a mesh)."""
    import torch.distributed as dist
    return 0 if self.mesh is None else dist.get_rank()

  def _barrier(self):
    import torch.distributed as dist
    dist.barrier()

  def save(self, ckpt_dir, keep=3, writer=None):
    """Write the state at the current step; keep the newest ``keep``.

    The state is copied to the CPU here, synchronously: the step (a
    replayed graph too) updates the parameters and moments in place. With
    ``writer`` (an :class:`~lddl_tpu_torch.training.elastic.
    AsyncCheckpointWriter`) the file write then runs on its background
    thread; a failed write surfaces on the next ``submit`` /
    ``raise_pending`` / ``flush`` (first-error-wins).

    On a mesh every rank holds the whole state gathered
    (:meth:`_snapshot`, a collective), rank 0 writes it and the other
    ranks wait at a barrier over the whole world until the write is done
    (with ``writer``: at the barrier after :meth:`run`'s flush). So the
    file is world 1's, whatever the world size and layout, and
    :meth:`restore` reads it on any mesh.

    With the ledger on, every rank records the ``step`` line of the
    state, fingerprinted here from the CPU copy the writer serializes
    (:meth:`_record_step_fingerprint`).
    """
    shared = self._shared()
    ledger = get_ledger()
    writes = not shared or self._rank() == 0
    state = None
    if self._sharded():
      state = self._snapshot()
    elif writes or ledger.enabled:
      state = _cpu_copy(self._state())
    if ledger.enabled:
      self._record_step_fingerprint(ledger, state)
    if writes:
      meta = {'step': self.step, 'samples_seen': self.samples_seen}
      if writer is not None:
        writer.submit(self._write_ckpt, ckpt_dir, keep, self.step, state,
                      meta)
        get_telemetry().gauge('train.ckpt_backlog').set(writer.backlog)
      else:
        self._write_ckpt(ckpt_dir, keep, self.step, state, meta)
    if shared and writer is None:
      self._barrier()
    self._last_saved = self.step
    return self.step

  def _record_step_fingerprint(self, ledger, snap):
    """The ledger's ``step`` boundary: :func:`state_fingerprint` of the
    full train state at a checkpoint, keyed by the global step, with
    ``samples`` and the last step's ``loss`` as context (the JAX loop's
    line, key for key). The state is the same on every rank after the
    gradient all-reduce, so this is the boundary the cross-rank verdict
    compares, and the one step replay verifies against."""
    coords = {'step': self.step, 'samples': self.samples_seen}
    if self._last_loss is not None:
      coords['loss'] = self._last_loss
    ledger.record('step', state_fingerprint(snap), **coords)

  @staticmethod
  def _write_ckpt(ckpt_dir, keep, step, state, meta):
    """The file write: inline for a synchronous save, or on the async
    writer's thread."""
    faults.inject('train.ckpt', rank=0)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f'{_STEP_PREFIX}{step:010d}')
    tmp = tempfile.mkdtemp(prefix='.tmp-', dir=ckpt_dir)
    try:
      torch.save(state, os.path.join(tmp, _STATE_FILE))
      with open(os.path.join(tmp, _META_FILE), 'w') as f:
        json.dump(meta, f)
      if os.path.exists(final):
        shutil.rmtree(final)
      os.rename(tmp, final)
    except BaseException:
      shutil.rmtree(tmp, ignore_errors=True)
      raise
    for _, old in _step_dirs(ckpt_dir)[keep:]:
      shutil.rmtree(old, ignore_errors=True)

  @staticmethod
  def latest_meta(ckpt_dir, max_step=None):
    """(step, samples_seen) of the newest *readable* checkpoint, or None.

    Walks the step directories newest first and skips one it cannot read
    (a half-written step), so a restart resumes from the next-older one.
    ``max_step`` bounds the search to steps <= it.
    """
    if not os.path.isdir(ckpt_dir):
      return None
    for step, path in _step_dirs(ckpt_dir):
      if max_step is not None and step > max_step:
        continue
      try:
        if not os.path.isfile(os.path.join(path, _STATE_FILE)):
          raise FileNotFoundError(_STATE_FILE)
        return _read_meta(path)
      except (OSError, ValueError, KeyError) as e:
        logging.getLogger('lddl_tpu_torch').warning(
            'checkpoint %s unreadable (%s: %s); trying an older step', path,
            type(e).__name__, e)
    return None

  def restore(self, ckpt_dir, step=None):
    """Restore the newest readable step (or exactly ``step``), copying
    into the live parameters and optimizer tensors, so the step cache's
    graphs stay valid, and re-seek ``loop.loader`` to the restored
    ``samples_seen`` (:func:`~lddl_tpu_torch.training.elastic.
    reseek_loader`; a loader without ``seek`` is left to the caller).

    The checkpoint holds the whole state and the global
    ``samples_seen``, so a run of any world size and layout restores it:
    each rank reads the whole state, keeps its shards
    (:meth:`load_whole_state`) and re-seeks its own loader with the
    loop's ``dp_world`` (the counterpart of the JAX ``restore`` with
    ``reshard_pytree``)."""
    if step is None:
      meta = self.latest_meta(ckpt_dir)
      if meta is None:
        raise FileNotFoundError(f'no checkpoint under {ckpt_dir}')
      step = meta[0]
    path = os.path.join(ckpt_dir, f'{_STEP_PREFIX}{step:010d}')
    if not os.path.isdir(path):
      raise FileNotFoundError(f'no checkpoint for step {step} under '
                              f'{ckpt_dir}')
    state = torch.load(os.path.join(path, _STATE_FILE),
                       map_location='cpu' if self._sharded() else
                       self.device, weights_only=True)
    self.load_whole_state(state['model'], state['opt'])
    self.dropout_seed = int(state['dropout_seed'])
    self.step, self.samples_seen = _read_meta(path)
    self._last_saved = self.step
    reseek_loader(self.loader, self.samples_seen, self.dp_world)
    return self

  def state_digest(self, algo=None):
    """:func:`state_fingerprint` of the loop's live train state (the
    params, the optimizer state and the dropout key: every step reseeds
    its generators from it) — equal to the ledger's ``step`` record when
    the loop sits at that step (hashed in ``algo``, default the
    ledger's)."""
    return state_fingerprint(self._snapshot(), algo)

  # ---- the loop ----

  def run(self, max_steps, ckpt_dir=None, ckpt_every=0, log_every=50,
          prefetch=2, membership=None, async_ckpt=None):
    """Train until ``max_steps`` (global); returns the per-step losses.

    Hook for hook as the JAX loop's ``run``: a SIGTERM (or an
    ``LDDL_PREEMPTION_FILE`` notice) stops the loop at the next step
    boundary (``stop_reason='preempted'``) behind one final synchronous
    checkpoint; so does a non-finite loss (``'nonfinite_loss'``) unless
    ``LDDL_NONFINITE=ignore``, and a fleet event that ``membership`` (a
    :class:`~lddl_tpu_torch.training.elastic.RankMembership`, polled at
    its heartbeat cadence) reports: a dead peer (``'dead_rank:<r>'``) or
    a shed verdict (``'shed:rank<r>'``). ``async_ckpt`` overrides
    ``LDDL_ASYNC_CKPT``: in-loop checkpoints then ride the background
    writer. With ``LDDL_STEP_CACHE`` on (the default) steps go through
    the loop's :class:`CompiledStepCache`. The device is synchronised
    once per step, by the loss read.

    With the ledger on the steps run under :func:`deterministic_algorithms`
    and every checkpoint records the ``step`` line. With the sentinel on,
    the flight recorder (:func:`~lddl_tpu_torch.training.flight.
    get_flight_recorder`) tees the host batches before the device feed,
    keeps each step's scalars and the newest checkpoint, and a trigger
    freezes an incident directory (``incident captured`` is printed).
    """
    if self.loader is None:
      raise ValueError('attach loop.loader before run()')
    # Live metrics endpoint (LDDL_MONITOR): the no-op singleton when
    # unset. The card's memory size is read first, here on the loop's
    # thread: the monitor's scrapes then read only the allocator's host
    # counters, never making a CUDA call beside a graph capture.
    if get_monitor().enabled:
      hbm_limits()
    maybe_start_monitor(rank=self._rank() if self.mesh is not None else
                        max(self.dp_rank, 0))
    # Armed through the API (get_step_profiler().arm(n)) or the monitor's
    # /profile; unarmed, on_step() is two attribute reads.
    profiler = get_step_profiler()
    # Streaming sentinels and the black-box recorder (LDDL_SENTINEL): both
    # the shared no-op singletons when the gate is off. (Imported here:
    # ``python -m lddl_tpu_torch.training.flight`` loads this package.)
    from .flight import get_flight_recorder
    sentinel = get_sentinel()
    flight = get_flight_recorder()
    nonfinite_stop = (os.environ.get('LDDL_NONFINITE', '')
                      .strip().lower() != 'ignore')
    global_batch = self.loader.batch_size * max(self.dp_world, 1)
    # A seq rank is fed its 1 / seq of each of its rows.
    seq = axis_size(self.mesh, 'seq')
    tele = get_telemetry()
    tracer = get_tracer()
    data_wait_h = tele.histogram('train.data_wait_seconds')
    compute_h = tele.histogram('train.compute_seconds')
    step_h = tele.histogram('train.step_seconds')
    steps_c = tele.counter('train.steps')
    samples_c = tele.counter('train.samples')
    grad_norm_g = tele.gauge('train.grad_norm')
    tiles_total_c = tele.counter('train.attn_tiles_total')
    tiles_skipped_c = tele.counter('train.attn_tiles_skipped')
    # The card's peak (LDDL_PEAK_TFLOPS overrides the table); None where
    # neither knows the device (the CPU), and MFU is then omitted.
    peak_total = peak_flops_per_device() if tele.enabled else None
    step_fn = self.step_fn
    if _step_cache_enabled():
      if self.step_cache is None:
        self.step_cache = CompiledStepCache(self.step_fn)
      step_fn = self.step_cache
    self.stop_reason = None
    use_async = async_ckpt_enabled() if async_ckpt is None else async_ckpt
    writer = AsyncCheckpointWriter() if (ckpt_dir and use_async) else None
    modes = contextlib.ExitStack()
    if get_ledger().enabled:
      # A recorded step line must re-execute bit for bit (replay).
      modes.enter_context(deterministic_algorithms(self.device))
    guard = PreemptionGuard().install()
    # Membership polls once per heartbeat (the first step boundary, then
    # each beat), and the steps_per_sec window it publishes.
    polled_beat = -1
    rate_anchor = (self.step, time.monotonic())
    losses = []
    self.model.train()
    try:
      while self.step < max_steps and self.stop_reason is None:
        # The recorder tees the *host* batches (the device copies cannot
        # be packed); ordinal0 is the global step the next batch feeds, so
        # each ring entry carries its ledger collate coordinate. Each
        # device record carries it too, from the loader's own position.
        coordinate = coordinate_from(self.loader)
        stream = prefetch_to_device(
            flight.wrap_host_stream(iter(self.loader), self.loader,
                                    ordinal0=self.step),
            self.device, size=prefetch, coordinate=coordinate,
            mesh=self.mesh)
        t0 = time.perf_counter()
        steps_this_epoch = 0
        try:
          while True:
            # The batch pull is timed apart from the step: the data wait
            # is the loader-vs-compute signal.
            t_wait = time.perf_counter()
            tm_wait = time.monotonic() if tracer.enabled else 0.0
            try:
              batch = next(stream)
            except StopIteration:
              break
            t_step = time.perf_counter()
            tm_step = time.monotonic() if tracer.enabled else 0.0
            if tracer.enabled:
              tracer.complete('train.data_wait', tm_wait, tm_step - tm_wait,
                              args={'step': self.step})
            data_wait_h.observe(t_step - t_wait)
            # After the batch pull, before the step: a 'kill' here models
            # the process dying mid-training, a 'term' the preemption
            # notice.
            faults.inject('train.step', rank=self.dp_rank)
            steps_this_epoch += 1
            step_no = self.step
            metrics = step_fn(batch, self.dropout_seed)
            # float() waits for the device to finish the step, so the
            # compute span covers its execution, not only its launch; the
            # grad norm is then a copy of a finished scalar.
            loss = float(metrics['loss'])
            grad_norm = float(metrics['grad_norm'])
            losses.append(loss)
            self._last_loss = loss
            self.step += 1
            self.samples_seen += global_batch
            if not math.isfinite(loss) and nonfinite_stop:
              self.stop_reason = 'nonfinite_loss'
            data_wait = t_step - t_wait
            trigger = sentinel.observe_step(step_no, loss=loss,
                                            grad_norm=grad_norm,
                                            data_wait=data_wait)
            flight.record_step(step_no, loss=loss, grad_norm=grad_norm,
                               data_wait=data_wait)
            if trigger is not None:
              incident = flight.capture(trigger)
              if incident:
                print(f'sentinel: {trigger["detector"]} fired at step '
                      f'{step_no} — incident captured to {incident}')
              else:
                print(f'sentinel: {trigger["detector"]} fired at step '
                      f'{step_no} ({trigger["reason"]})')
            finished_trace = profiler.on_step()
            if finished_trace:
              print(f'profiler: wrote trace for step {self.step} window to '
                    f'{finished_trace}')
            if tracer.enabled:
              tm_now = time.monotonic()
              tracer.complete('train.compute', tm_step, tm_now - tm_step,
                              args={'step': step_no})
              tracer.counter('train.samples_per_sec',
                             global_batch / max(tm_now - tm_wait, 1e-9))
            if tele.enabled:
              now = time.perf_counter()
              compute_h.observe(now - t_step)
              step_h.observe(now - t_wait)
              steps_c.add(1)
              samples_c.add(global_batch)
              grad_norm_g.set(grad_norm)
              tele.gauge('train.samples_per_sec').set(
                  global_batch / max(now - t_wait, 1e-9))
              if peak_total:
                # The counted FLOPs of this step where the step cache
                # counted it (the JAX loop prefers XLA's count alike),
                # else the analytic count.
                measured = getattr(step_fn, 'last_costs', None)
                if measured is not None:
                  numerator = measured[0]
                else:
                  b, s = batch['input_ids'].shape
                  numerator = self.flops_per_step(b, s * seq)
                tele.gauge('train.mfu').set(
                    numerator / (max(now - t_wait, 1e-9) * peak_total))
              tiles = (packed_tiles(batch, self.model)
                       if 'segment_ids' in batch else None)
              if tiles is not None:
                # The kernels' tile-skip rule on the host: how much
                # attention work block-diagonal packing removed this step
                # (with seq above 1, over every ring block of the rank's
                # q columns). The step cache's bill counted the same
                # tiles: the ids are read once a step.
                total, computed, _ = tiles
                tiles_total_c.add(total)
                tiles_skipped_c.add(total - computed)
            if log_every and self.step % log_every == 0:
              dt = time.perf_counter() - t0
              t0 = time.perf_counter()
              print(f'step={self.step} loss={loss:.4f} '
                    f'samples_seen={self.samples_seen} '
                    f'({log_every * global_batch / max(dt, 1e-9):.1f} '
                    'samples/s)')
            if writer is not None:
              # First-error-wins: a checkpoint that died in the background
              # fails the run at the next step, not at the final flush.
              writer.raise_pending()
            if guard.requested:
              self.stop_reason = 'preempted'
            elif membership is not None and (
                membership.beats != polled_beat):
              # One lease-store sweep per heartbeat: a late poll delays
              # noticing a fleet event, it never changes any verdict.
              polled_beat = membership.beats
              now_m = time.monotonic()
              w_step, w_t = rate_anchor
              membership.publish_signals(
                  {'steps_per_sec':
                   (self.step - w_step) / max(now_m - w_t, 1e-9)})
              rate_anchor = (self.step, now_m)
              # A quiet poll (None) must not wipe a stop reason an
              # earlier check set (a non-finite loss).
              reason = membership.poll()
              if reason is not None:
                self.stop_reason = reason
            if self.stop_reason is not None:
              break
            if ckpt_dir and ckpt_every and self.step % ckpt_every == 0:
              self.save(ckpt_dir, writer=writer)
              flight.note_checkpoint(ckpt_dir, self.step)
            if self.step >= max_steps:
              break
        finally:
          stream.close()
        if steps_this_epoch == 0 and self.stop_reason is None:
          raise ValueError(
              'loader yielded zero batches for a full epoch (dataset '
              'smaller than one global batch?); refusing to spin')
      # A capture armed near the end of the run may still be recording.
      profiler.close()
      if writer is not None:
        writer.flush()
        if self._shared():
          self._barrier()
      # After a preemption, a membership event or a non-finite loss this
      # synchronous trailing save is the emergency checkpoint, complete
      # before the return.
      if ckpt_dir and self._last_saved != self.step:
        self.save(ckpt_dir)
        flight.note_checkpoint(ckpt_dir, self.step)
    finally:
      guard.uninstall()
      modes.close()
      if writer is not None:
        # Idempotent after flush(); raise_errors=False so cleanup never
        # masks an exception already propagating.
        writer.close(raise_errors=False)
    if self.stop_reason is not None:
      print(f'stopping early: {self.stop_reason} '
            f'(step={self.step} samples_seen={self.samples_seen})')
    return losses


def attach_args(parser):
  """The JAX CLI's arguments (``lddl_tpu/training/pretrain.py:785-853``),
  plus ``--device``. ``--comm`` takes ``torch`` where the JAX CLI takes
  ``jax``; ``--dp``, ``--fsdp``, ``--tp`` and ``--sp`` above 1 need it.
  Left out: ``--tokenizer`` (a hub tokenizer needs the network) and
  ``--prng`` (a JAX setting)."""
  parser.add_argument('--path', required=True, help='balanced shard dir')
  parser.add_argument('--vocab-file', required=True)
  parser.add_argument('--model', choices=sorted(MODEL_SIZES),
                      default='base')
  parser.add_argument('--attention',
                      choices=['dense', 'flash', 'ring', 'ring_flash'],
                      default='dense',
                      help="'ring'/'ring_flash': ring attention over the "
                      "mesh's seq ranks (--sp) with dense/flash blocks; "
                      "without a mesh they are 'dense'/'flash'")
  parser.add_argument('--remat', action='store_true')
  parser.add_argument('--dp', type=int, default=None,
                      help='data-parallel ranks; default: the world size')
  parser.add_argument('--fsdp', type=int, default=1,
                      help='ranks over which the parameters and the '
                      'optimizer state are sharded (a flat buffer cut in '
                      'fsdp parts); the batch splits over dp x fsdp')
  parser.add_argument('--tp', type=int, default=1,
                      help='tensor-parallel ranks: each holds num_heads/tp '
                      'heads, an FFN slice and a vocabulary slice, and '
                      'reads the same rows as the others')
  parser.add_argument('--sp', type=int, default=1,
                      help='sequence-parallel ranks: each holds 1/sp of '
                      'every row of its data x fsdp rank and attends over '
                      'the others by ring attention (--attention ring or '
                      'ring_flash); the length must divide by sp')
  parser.add_argument('--batch-size', type=int, default=64,
                      help='per-process samples per step')
  parser.add_argument('--bin-size', type=int, default=None)
  parser.add_argument('--max-seq-length', type=int, default=512)
  parser.add_argument('--masking', choices=['dynamic', 'static'],
                      default='dynamic')
  parser.add_argument('--data-format', choices=['pairs', 'packed'],
                      default='pairs',
                      help="'pairs': NSP-pair shards (preprocess_bert_"
                      "pretrain); 'packed': long-context document-packed "
                      'id shards (preprocess_packed_pretrain)')
  parser.add_argument('--block-diagonal', action='store_true',
                      help='packed rows only: attention within documents '
                      'and the MLM loss normalized per document')
  parser.add_argument('--steps', type=int, default=1000)
  parser.add_argument('--learning-rate', type=float, default=1e-4)
  parser.add_argument('--warmup-steps', type=int, default=100)
  parser.add_argument('--weight-decay', type=float, default=0.01)
  parser.add_argument('--seed', type=int, default=127)
  parser.add_argument('--max-predictions', type=int, default=None,
                      help='masked-only MLM head: vocab logits at this many '
                      'gathered MLM positions per row')
  parser.add_argument('--checkpoint-dir', default=None)
  parser.add_argument('--checkpoint-every', type=int, default=500)
  parser.add_argument('--log-every', type=int, default=50)
  parser.add_argument('--resume', action='store_true',
                      help='resume from the newest checkpoint in '
                           '--checkpoint-dir (model state AND data '
                           'stream position)')
  parser.add_argument('--comm', choices=['null', 'file', 'torch'],
                      default='null',
                      help="'torch': a torch.distributed group from the "
                      "launcher's environment, gradients all-reduced over "
                      "the mesh's data axis; 'file': independent ranks "
                      'that share membership over LDDL_COMM_DIR')
  parser.add_argument('--device', default=None,
                      help="torch device; default the CUDA card "
                      "cuda:<local rank> (raises without one). 'cpu' runs "
                      'on the CPU')
  return parser


def main(args=None):
  """Train from a balanced shard directory (the JAX CLI's ``main``,
  ``lddl_tpu/training/pretrain.py:856-916``); returns the loop."""
  if args is None or isinstance(args, list):
    args = attach_args(argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)).parse_args(
            args)
  if get_ledger().enabled and not str(args.device).startswith('cpu'):
    # The ledger's step lines are recorded under deterministic algorithms,
    # whose cuBLAS workspace must be set before CUDA initialises.
    require_deterministic_cublas()
  comm = get_backend(args.comm)
  tracer = get_tracer()
  if tracer.enabled:
    # Identity up front, so the crash-tail flushes during the run land at
    # this rank's trace file.
    tracer.set_identity(rank=comm.rank)
  tokenizer = load_bert_tokenizer(args.vocab_file)
  vocab = ((tokenizer.vocab_size + 63) // 64) * 64
  cfg = BertConfig(
      vocab_size=vocab,
      max_position_embeddings=max(args.max_seq_length, 512),
      attention_impl=args.attention,
      remat=args.remat,
      **MODEL_SIZES[args.model])
  device = rank_device(args.device, comm)
  if args.comm == 'torch':
    mesh = make_mesh(data=args.dp or 1, fsdp=args.fsdp, tensor=args.tp,
                     seq=args.sp, device_type=device.type)
  else:
    # No process group: the process holds its whole batch (under file the
    # ranks are independent single-process worlds, as in the JAX CLI).
    for flag, n in (('--dp', args.dp or 1), ('--fsdp', args.fsdp),
                    ('--tp', args.tp), ('--sp', args.sp)):
      if n != 1:
        raise ValueError(f'{flag} {n} needs --comm torch')
    mesh = None
  print(f'device: {device}; mesh: {mesh_summary(mesh)}; rank {comm.rank} '
        f'of {comm.world_size}; model={args.model} '
        f'attention={args.attention}')

  samples_seen = 0
  resume = False
  if args.resume and args.checkpoint_dir:
    meta = TrainLoop.latest_meta(args.checkpoint_dir)
    if meta is not None:
      _, samples_seen = meta
      resume = True
      print(f'resuming from samples_seen={samples_seen}')

  loop = TrainLoop.build(
      args.path, tokenizer, model_cfg=cfg, device=device,
      learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
      total_steps=args.steps, weight_decay=args.weight_decay,
      batch_size_per_rank=args.batch_size, bin_size=args.bin_size,
      max_seq_length=args.max_seq_length, masking=args.masking,
      seed=args.seed, samples_seen=samples_seen,
      max_predictions=args.max_predictions,
      data_format=args.data_format,
      block_diagonal=args.block_diagonal, mesh=mesh, comm=comm)
  if resume:
    loop.restore(args.checkpoint_dir)
  exchange = loop.step_fn.exchange
  if exchange is not None:
    graphs = (device.type == 'cuda' and _step_cache_enabled() and
              exchange.capturable)
    print(f'{type(exchange).__name__} step over {exchange.world} data x '
          f'fsdp x seq rank(s) ({mesh_summary(mesh)}), '
          f'{exchange.backend} for {device.type} tensors: ' +
          ('the all-reduces run inside the CUDA graphs' if graphs else
           'eager steps'))
  membership = maybe_membership(comm, step=loop.step)
  try:
    losses = loop.run(args.steps, ckpt_dir=args.checkpoint_dir,
                      ckpt_every=args.checkpoint_every,
                      log_every=args.log_every, membership=membership)
  finally:
    if membership is not None:
      membership.stop()
  export_telemetry(comm)
  if losses:
    print(json.dumps({'final_step': loop.step,
                      'final_loss': round(losses[-1], 4),
                      'samples_seen': loop.samples_seen}))
  return loop


if __name__ == '__main__':
  main()
