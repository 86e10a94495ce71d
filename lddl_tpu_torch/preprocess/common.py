"""Shared preprocess orchestration: the shuffle-spill run skeleton and the
per-process tokenizer cache (copied from :mod:`lddl_tpu.preprocess.common`)."""

import functools
import os
import shutil

from ..pipeline.executor import Executor
from ..pipeline.shuffle import shuffle_corpus

_TOKENIZER_CACHE = {}


def native_columnar_enabled():
  """The ``LDDL_NATIVE_COLUMNAR`` gate for the fused native
  encode->columnar shard assembly (default on; the native library being
  unavailable still falls back per call, so 'on' is always safe).
  Outputs are byte-identical either way — the gate exists for A/B
  benchmarking and as an escape hatch."""
  return os.environ.get('LDDL_NATIVE_COLUMNAR', '').strip().lower() not in (
      '0', 'false', 'off', 'no')


def fused_string_columns(tokenizer, columns, positions=None):
  """Gate + fallback probe for the fused columnar build.

  Returns ``(string_parts, pos_parts)`` from the tokenizer's native
  :meth:`columnar_emit`, or ``None`` when the gate is off or the native
  library is unavailable (callers use the per-column
  ``decode_join_buffers`` + numpy-framing path instead).
  """
  if not native_columnar_enabled():
    return None
  emit = getattr(tokenizer, 'columnar_emit', None)
  if emit is None:
    return None
  return emit(columns, positions=positions)


def get_cached_tokenizer(vocab_file=None, hub_name=None, lowercase=True,
                         backend='native'):
  """One tokenizer per (vocab, name, case, backend) per worker process."""
  key = (vocab_file, hub_name, lowercase, backend)
  if key not in _TOKENIZER_CACHE:
    from ..tokenization.wordpiece import load_bert_tokenizer
    _TOKENIZER_CACHE[key] = load_bert_tokenizer(
        vocab_file=vocab_file,
        hub_name=hub_name,
        lowercase=lowercase,
        backend=backend)
  return _TOKENIZER_CACHE[key]


def spill_partition_bytes(spill_dir, tgt_idx, global_idx):
  """LPT cost key for the process phase: total spilled bytes destined for
  output partition ``tgt_idx``. Pure function of on-disk state every rank
  shares, so all ranks derive the same ordering; falls back to the task
  index when the partition received no spills."""
  tgt_dir = os.path.join(spill_dir, f'tgt{tgt_idx}')
  if not os.path.isdir(tgt_dir):
    return global_idx
  total = 0
  for name in sorted(os.listdir(tgt_dir)):
    if name.endswith('.txt'):
      try:
        total += os.path.getsize(os.path.join(tgt_dir, name))
      except OSError:
        pass
  return total if total > 0 else global_idx


def run_shuffled(corpus, sink_dir, process_partition, seed, executor=None,
                 num_shuffle_partitions=None, warmup=None, warmup_key=None):
  """Global shuffle -> ``process_partition(tgt_idx, global_idx)`` fan-out.

  ``process_partition`` must be a picklable callable taking
  ``(tgt_idx, global_idx, spill_dir)`` (use ``functools.partial`` to bind
  config). ``warmup`` (optional, picklable, zero-arg) is registered on the
  executor once per ``warmup_key`` (the tokenizer and its native encoder,
  built before the first task). Pre-cleans stale
  spills from a previous crashed/re-partitioned run, removes the plaintext
  spill copy on success, and returns the task-ordered result list. An
  executor created here (none passed in) is closed before returning.
  """
  owned = executor is None
  executor = executor or Executor()
  try:
    if warmup is not None:
      executor.set_warmup(warmup, key=warmup_key)
    os.makedirs(sink_dir, exist_ok=True)
    spill_dir = os.path.join(sink_dir, '_shuffle_spill')
    # A restarted elastic run resumes from the scatter phase's completion
    # manifests — the spills backing already-manifested scatter tasks are
    # inputs the resume still needs, so only pre-clean when this is a
    # fresh (or statically scheduled) run.
    resuming = executor.resume_pending('scatter')
    if not resuming and executor.comm.rank == 0 and os.path.isdir(spill_dir):
      shutil.rmtree(spill_dir)
    executor.comm.barrier()
    n = shuffle_corpus(
        executor, corpus, spill_dir, seed, num_targets=num_shuffle_partitions)
    task = functools.partial(process_partition, spill_dir=spill_dir)
    results = executor.map(
        task, list(range(n)), label='process',
        cost_key=functools.partial(_process_cost, spill_dir))
    if executor.comm.rank == 0:
      shutil.rmtree(spill_dir, ignore_errors=True)
    return results
  finally:
    if owned:
      executor.close()


def export_telemetry(rank):
  """This rank's ``telemetry.rank<R>.jsonl`` under ``LDDL_TELEMETRY_DIR``
  when telemetry is on (the ``pipeline.*`` and ``preprocess.*`` names, the
  pool's among them); returns its path or None. The preprocessor CLIs
  call it last."""
  from ..telemetry import get_telemetry, rank_file_name
  tele = get_telemetry()
  out_dir = os.environ.get('LDDL_TELEMETRY_DIR')
  if not tele.enabled or not out_dir:
    return None
  return tele.write_jsonl(rank_file_name(out_dir, rank), rank=rank)


def _process_cost(spill_dir, tgt_idx, global_idx):
  return spill_partition_bytes(spill_dir, tgt_idx, global_idx)
