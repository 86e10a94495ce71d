"""BERT pretraining loop on one CUDA card: steps + checkpoint/resume.

Counterpart of :class:`lddl_tpu.training.pretrain.TrainLoop`. A
checkpoint holds the model and optimizer state, the dropout key and the
``(step, samples_seen)`` counters, so a restart resumes the parameter
trajectory and the data-stream position together.

This slice ends at the loader's batch boundary: ``build(path=None, ...)``
makes a loop without a corpus and the caller attaches ``loop.loader``,
any iterable of loader-format batch dicts (``input_ids``,
``token_type_ids``, ``attention_mask``, ``labels``,
``next_sentence_labels``) with a ``batch_size`` attribute — the same
contract replay uses with the JAX loop. Batches of the packed collate
(:class:`~lddl_tpu_torch.loader.packed.PackedCollate` with
``block_diagonal=True``) also carry ``segment_ids``; the feed copies every
key and the train step then runs block-diagonal attention and the
per-document MLM loss.

Checkpoints are ``torch.save`` files, written into a temporary directory
and renamed into place, so a reader sees a step whole or not at all. They
do not interchange with the JAX loop's orbax checkpoints.

:class:`CompiledStepCache` is the counterpart of the JAX loop's cache of
one compiled executable per bin: on the card it captures the step into
one CUDA graph per batch signature and replays it (``LDDL_STEP_CACHE=0``
runs every step eagerly). :meth:`TrainLoop.run` carries the JAX loop's
hooks for one process: ``train.*`` telemetry and trace spans, MFU, the
sentinels, the step profiler, fault injection, the preemption guard and
the async checkpoint writer. PyTorch has no compiler cost model, so the
cache never bills ``train.xla_flops`` / ``train.xla_bytes``, and MFU
takes the analytic FLOP count as its numerator, as the JAX loop does
when no cost model exists. The flight recorder, the determinism ledger,
rank membership and the live monitor are not ported yet.
"""

import functools
import hashlib
import json
import logging
import math
import os
import shutil
import tempfile
import time
import traceback
from collections import namedtuple

import torch

from ..core import faults
from ..loader.device import CUDA_FEED_LOCK, prefetch_to_device
from ..models.bert import BertForPretraining
from ..models.flops import bert_pretrain_flops_per_step, peak_flops_per_device
from ..ops import flash_attention as tfa
from ..parallel.train import AdamW, TrainStep, check_max_predictions
from ..parallel.train import learning_rate as lr_schedule
from ..telemetry import (get_step_profiler, get_telemetry, get_tracer,
                         rank_file_name, sample_hbm, trace_file_name)
from ..telemetry.sentinel import get_sentinel
from .elastic import AsyncCheckpointWriter, PreemptionGuard, async_ckpt_enabled

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


def _step_dirs(ckpt_dir):
  """``[(step, path)]`` of the step directories, newest first."""
  found = []
  for name in os.listdir(ckpt_dir):
    if name.startswith(_STEP_PREFIX) and name[len(_STEP_PREFIX):].isdigit():
      found.append((int(name[len(_STEP_PREFIX):]),
                    os.path.join(ckpt_dir, name)))
  return sorted(found, reverse=True)


def _read_meta(path):
  with open(os.path.join(path, _META_FILE)) as f:
    meta = json.load(f)
  return int(meta['step']), int(meta['samples_seen'])


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


# One captured step: the graph, the static input buffers it reads, the
# outputs it writes, and the kernel launches it makes per replay.
_Graph = namedtuple('_Graph', 'graph inputs outputs launches')


def _where_raised(exc):
  """``file:line: source`` of the innermost frame outside torch itself
  in ``exc``'s traceback: the op of the step that raised."""
  frames = traceback.extract_tb(exc.__traceback__)
  torch_dir = os.path.dirname(torch.__file__)
  ours = [f for f in frames if not f.filename.startswith(torch_dir)]
  f = (ours or frames)[-1]
  return f'{f.filename}:{f.lineno}: {f.line}'


class CompiledStepCache:
  """Per-bin captured train step: one CUDA graph per batch signature.

  The counterpart of :class:`lddl_tpu.training.pretrain.CompiledStepCache`
  (one compiled executable per bin). ``step`` is a
  :class:`~lddl_tpu_torch.parallel.train.TrainStep`; calling the cache
  with ``(batch, dropout_seed)`` runs one step and returns its metrics.

  - **A miss** (the first batch of a signature, :meth:`key_of`) copies
    the batch into new static input buffers, runs the real step eagerly
    on a side stream (the warm-up that capture needs, and the step
    itself), then captures the step into a ``torch.cuda.CUDAGraph`` with
    its own memory pool, reading those buffers. Capture executes nothing;
    the host count does not advance and the kernels' launch counters are
    put back, the capture's launches kept as the entry's per-replay
    count. A capture that fails raises and names the op; it never falls
    back to eager. The miss is timed into ``train.retrace_seconds`` and
    counted in ``train.step_cache_misses``.
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
  (the kernel wrappers take their plain versions there).

  ``last_costs`` stays None: PyTorch has no compiler cost model, so
  ``train.xla_flops`` / ``train.xla_bytes`` are not billed.
  """

  def __init__(self, step):
    self.step = step
    # (signature, deterministic) -> _Graph, or None for a CPU batch's.
    self._graphs = {}
    self._stream = None   # the side stream misses run and capture on
    self.hits = 0
    self.misses = 0
    self.retrace_seconds = 0.0
    self.last_costs = None
    tele = get_telemetry()
    self._hits_c = tele.counter('train.step_cache_hits')
    self._misses_c = tele.counter('train.step_cache_misses')
    self._retrace_h = tele.histogram('train.retrace_seconds')

  @staticmethod
  def key_of(batch):
    return tuple(
        sorted((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))

  def __call__(self, batch, dropout_seed):
    key = (self.key_of(batch), torch.are_deterministic_algorithms_enabled())
    if key not in self._graphs:
      t0 = time.perf_counter()
      if next(iter(batch.values())).device.type == 'cuda':
        metrics, self._graphs[key] = self._miss(key, batch, dropout_seed)
      else:
        metrics, self._graphs[key] = self.step(batch, dropout_seed), None
      self._count(False, time.perf_counter() - t0)
      return metrics
    entry = self._graphs[key]
    if entry is None:
      metrics = self.step(batch, dropout_seed)
      self._count(True, 0.0)
      return metrics
    for name, t in batch.items():
      entry.inputs[name].copy_(t)
    self.step.prepare(dropout_seed)
    entry.graph.replay()
    for name, n in entry.launches.items():
      tfa.launches[name] += n
    self.step.finish()
    self._count(True, 0.0)
    return entry.outputs

  def _count(self, hit, seconds):
    if hit:
      self.hits += 1
      self._hits_c.add(1)
      return
    self.misses += 1
    self.retrace_seconds += seconds
    self._misses_c.add(1)
    self._retrace_h.observe(seconds)

  def _miss(self, key, batch, dropout_seed):
    current = torch.cuda.current_stream()
    if self._stream is None:
      self._stream = torch.cuda.Stream()
    side = self._stream
    inputs = {name: t.clone() for name, t in batch.items()}
    side.wait_stream(current)
    self.step.prepare(dropout_seed)
    with torch.cuda.stream(side):
      metrics = self.step.body(inputs)
    graph = torch.cuda.CUDAGraph()
    for gen in self.step.generators():
      graph.register_generator_state(gen)
    before = dict(tfa.launches)
    try:
      # Global capture mode: another thread's CUDA call would break the
      # capture, so the feed's producers wait until it is over.
      with CUDA_FEED_LOCK, torch.cuda.graph(graph, stream=side,
                                            capture_error_mode='global'):
        outputs = self.step.body(inputs)
    except Exception as e:
      raise RuntimeError(
          f'capturing the train step for batch signature {key[0]} into a '
          f'CUDA graph failed at {_where_raised(e)}: {e}') from e
    finally:
      launches = {n: tfa.launches[n] - before[n] for n in before}
      tfa.launches.update(before)
    current.wait_stream(side)
    self.step.finish()
    return metrics, _Graph(graph, inputs, outputs, launches)


def _step_cache_enabled():
  return os.environ.get('LDDL_STEP_CACHE', '').strip().lower() not in (
      '0', 'false', 'off', 'no')


def export_telemetry(rank=0):
  """Write this process's telemetry and trace under ``LDDL_TELEMETRY_DIR``:
  ``telemetry.rank<R>.jsonl`` when telemetry is on, with the ``hbm.*``
  gauges sampled just before (the port has no monitor to sample them
  while the run goes), and ``trace.rank<R>.jsonl`` when tracing is on.
  Returns the paths written; nothing without the directory. One process,
  no cross-rank merge (the JAX package's report waits for the comm
  backend)."""
  out_dir = os.environ.get('LDDL_TELEMETRY_DIR')
  if not out_dir:
    return []
  written = []
  tracer = get_tracer()
  if tracer.enabled:
    tracer.set_identity(rank=rank)
    written.append(tracer.write_jsonl(trace_file_name(out_dir, rank),
                                      rank=rank))
  tele = get_telemetry()
  if tele.enabled:
    sample_hbm(tele)
    written.append(tele.write_jsonl(rank_file_name(out_dir, rank),
                                    rank=rank))
  return written


class TrainLoop:
  """Owns the model, the optimizer, the loader, the step and its cache,
  and the step counters."""

  def __init__(self, model, opt, device, dropout_seed, loader=None,
               max_predictions=None):
    self.model = model
    self.opt = opt
    self.device = device
    self.dropout_seed = dropout_seed
    self.loader = loader
    self.max_predictions = max_predictions
    self.step_fn = TrainStep(model, opt, max_predictions)
    # Made by the first run() with LDDL_STEP_CACHE on and kept, so repeated
    # run() calls, epochs and restore() replay the same per-bin graphs.
    self.step_cache = None
    self.samples_seen = 0
    self.step = 0
    # Why the last run() stopped early (preemption, non-finite loss), or
    # None when it ran to max_steps.
    self.stop_reason = None
    self._last_saved = -1

  @classmethod
  def build(cls, path=None, *, model_cfg, device=None, learning_rate=1e-4,
            warmup_steps=100, total_steps=10000, weight_decay=0.01,
            seed=127, max_predictions=None, max_seq_length=512,
            masking='dynamic', mlm_probability=0.15):
    """A loop at step 0 with freshly initialised params (flax's init
    distributions, drawn from ``seed`` on the CPU, then moved to
    ``device``); :meth:`restore` moves it to a checkpoint.

    ``path`` must be None: the corpus loader is not ported yet, so the
    caller attaches ``loop.loader``. ``max_seq_length``, ``masking`` and
    ``mlm_probability`` describe that loader, for
    :func:`check_max_predictions`.
    """
    if path is not None:
      raise NotImplementedError('the corpus loader is not ported yet: build '
                                'with path=None and attach loop.loader')
    device = resolve_device(device)
    model = BertForPretraining(model_cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    schedule = functools.partial(lr_schedule, peak=learning_rate,
                                 warmup_steps=warmup_steps,
                                 total_steps=total_steps)
    opt = AdamW(model.parameters(), schedule, weight_decay=weight_decay)
    if max_predictions is not None:
      check_max_predictions(max_predictions, max_seq_length, masking,
                            mlm_probability=mlm_probability)
    return cls(model, opt, device, dropout_seed=seed + 1,
               max_predictions=max_predictions)

  def flops_per_step(self, batch, seq_len):
    """Analytic FLOPs of one step at ``[batch, seq_len]`` (MFU numerator)."""
    return bert_pretrain_flops_per_step(self.model.cfg, batch, seq_len,
                                        max_predictions=self.max_predictions)

  # ---- checkpointing ----

  def _state(self):
    return {'model': self.model.state_dict(),
            'opt': self.opt.state_dict(),
            'dropout_seed': self.dropout_seed}

  def save(self, ckpt_dir, keep=3, writer=None):
    """Write the state at the current step; keep the newest ``keep``.

    The state is copied to the CPU here, synchronously: the step (a
    replayed graph too) updates the parameters and moments in place. With
    ``writer`` (an :class:`~lddl_tpu_torch.training.elastic.
    AsyncCheckpointWriter`) the file write then runs on its background
    thread; a failed write surfaces on the next ``submit`` /
    ``raise_pending`` / ``flush`` (first-error-wins).
    """
    state = _cpu_copy(self._state())
    meta = {'step': self.step, 'samples_seen': self.samples_seen}
    if writer is not None:
      writer.submit(self._write_ckpt, ckpt_dir, keep, self.step, state, meta)
      get_telemetry().gauge('train.ckpt_backlog').set(writer.backlog)
    else:
      self._write_ckpt(ckpt_dir, keep, self.step, state, meta)
    self._last_saved = self.step
    return self.step

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
    graphs stay valid. The caller positions ``loop.loader`` at the
    restored ``samples_seen`` (the corpus loader's seek contract waits
    for the loader slice)."""
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
                       map_location=self.device, weights_only=True)
    self.model.load_state_dict(state['model'])
    self.opt.load_state_dict(state['opt'])
    self.dropout_seed = int(state['dropout_seed'])
    self.step, self.samples_seen = _read_meta(path)
    self._last_saved = self.step
    return self

  def state_digest(self):
    """sha256 over the CPU bytes of the params, the optimizer state and
    the dropout key (the generator state: every step reseeds from it)."""
    h = hashlib.sha256()
    for name, t in self.model.state_dict().items():
      h.update(name.encode())
      h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(str(self.opt.count).encode())
    for t in self.opt.mu + self.opt.nu:
      h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(str(self.dropout_seed).encode())
    return h.hexdigest()

  # ---- the loop ----

  def run(self, max_steps, ckpt_dir=None, ckpt_every=0, log_every=50,
          prefetch=2, async_ckpt=None):
    """Train until ``max_steps`` (global); returns the per-step losses.

    Hook for hook as the JAX loop's ``run`` on one process: a SIGTERM (or
    an ``LDDL_PREEMPTION_FILE`` notice) stops the loop at the next step
    boundary (``stop_reason='preempted'``) behind one final synchronous
    checkpoint; so does a non-finite loss (``'nonfinite_loss'``) unless
    ``LDDL_NONFINITE=ignore``. ``async_ckpt`` overrides
    ``LDDL_ASYNC_CKPT``: in-loop checkpoints then ride the background
    writer. With ``LDDL_STEP_CACHE`` on (the default) steps go through
    the loop's :class:`CompiledStepCache`. The device is synchronised
    once per step, by the loss read.
    """
    if self.loader is None:
      raise ValueError('attach loop.loader before run()')
    # Armed through the API (get_step_profiler().arm(n)); unarmed,
    # on_step() is two attribute reads.
    profiler = get_step_profiler()
    sentinel = get_sentinel()
    nonfinite_stop = (os.environ.get('LDDL_NONFINITE', '')
                      .strip().lower() != 'ignore')
    global_batch = self.loader.batch_size
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
    guard = PreemptionGuard().install()
    losses = []
    self.model.train()
    try:
      while self.step < max_steps and self.stop_reason is None:
        stream = prefetch_to_device(iter(self.loader), self.device,
                                    size=prefetch)
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
            faults.inject('train.step', rank=0)
            steps_this_epoch += 1
            step_no = self.step
            metrics = step_fn(batch, self.dropout_seed)
            # float() waits for the device to finish the step, so the
            # compute span covers its execution, not only its launch; the
            # grad norm is then a copy of a finished scalar.
            loss = float(metrics['loss'])
            grad_norm = float(metrics['grad_norm'])
            losses.append(loss)
            self.step += 1
            self.samples_seen += global_batch
            if not math.isfinite(loss) and nonfinite_stop:
              self.stop_reason = 'nonfinite_loss'
            data_wait = t_step - t_wait
            trigger = sentinel.observe_step(step_no, loss=loss,
                                            grad_norm=grad_norm,
                                            data_wait=data_wait)
            if trigger is not None:
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
                b, s = batch['input_ids'].shape
                tele.gauge('train.mfu').set(
                    self.flops_per_step(b, s) /
                    (max(now - t_wait, 1e-9) * peak_total))
              if 'segment_ids' in batch:
                # The kernels' tile-skip rule on the host: how much
                # attention work block-diagonal packing removed this step.
                total, skipped = tfa.count_skippable_tiles(
                    batch['segment_ids'].cpu().numpy(),
                    head_dim=self.model.cfg.head_dim)
                tiles_total_c.add(total)
                tiles_skipped_c.add(skipped)
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
            if self.stop_reason is not None:
              break
            if ckpt_dir and ckpt_every and self.step % ckpt_every == 0:
              self.save(ckpt_dir, writer=writer)
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
      # After a preemption or a non-finite loss this synchronous trailing
      # save is the emergency checkpoint, complete before the return.
      if ckpt_dir and self._last_saved != self.step:
        self.save(ckpt_dir)
    finally:
      guard.uninstall()
      if writer is not None:
        # Idempotent after flush(); raise_errors=False so cleanup never
        # masks an exception already propagating.
        writer.close(raise_errors=False)
    if self.stop_reason is not None:
      print(f'stopping early: {self.stop_reason} '
            f'(step={self.step} samples_seen={self.samples_seen})')
    return losses
