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
contract replay uses with the JAX loop.

Checkpoints are ``torch.save`` files, written into a temporary directory
and renamed into place, so a reader sees a step whole or not at all. They
do not interchange with the JAX loop's orbax checkpoints.
"""

import functools
import hashlib
import json
import logging
import math
import os
import shutil
import tempfile

import torch

from ..loader.device import prefetch_to_device
from ..models.bert import BertForPretraining
from ..models.flops import bert_pretrain_flops_per_step
from ..parallel.train import AdamW, check_max_predictions, train_step
from ..parallel.train import learning_rate as lr_schedule

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


class TrainLoop:
  """Owns the model, the optimizer, the loader and the step counters."""

  def __init__(self, model, opt, device, dropout_seed, loader=None,
               max_predictions=None):
    self.model = model
    self.opt = opt
    self.device = device
    self.dropout_seed = dropout_seed
    self.loader = loader
    self.max_predictions = max_predictions
    self.samples_seen = 0
    self.step = 0
    # Why the last run() stopped early, or None when it ran to max_steps.
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

  def save(self, ckpt_dir, keep=3):
    """Write the state at the current step; keep the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f'{_STEP_PREFIX}{self.step:010d}')
    tmp = tempfile.mkdtemp(prefix='.tmp-', dir=ckpt_dir)
    try:
      torch.save(self._state(), os.path.join(tmp, _STATE_FILE))
      with open(os.path.join(tmp, _META_FILE), 'w') as f:
        json.dump({'step': self.step, 'samples_seen': self.samples_seen}, f)
      if os.path.exists(final):
        shutil.rmtree(final)
      os.rename(tmp, final)
    except BaseException:
      shutil.rmtree(tmp, ignore_errors=True)
      raise
    for _, old in _step_dirs(ckpt_dir)[keep:]:
      shutil.rmtree(old, ignore_errors=True)
    self._last_saved = self.step
    return self.step

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
    """Restore the newest readable step (or exactly ``step``). The caller
    positions ``loop.loader`` at the restored ``samples_seen`` (the corpus
    loader's seek contract waits for the loader slice)."""
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
          prefetch=2):
    """Train until ``max_steps`` (global); returns the per-step losses.

    A non-finite loss stops the run at that step boundary
    (``stop_reason='nonfinite_loss'``) behind the trailing checkpoint,
    unless ``LDDL_NONFINITE=ignore``.
    """
    if self.loader is None:
      raise ValueError('attach loop.loader before run()')
    nonfinite_stop = (os.environ.get('LDDL_NONFINITE', '')
                      .strip().lower() != 'ignore')
    global_batch = self.loader.batch_size
    self.stop_reason = None
    losses = []
    self.model.train()
    while self.step < max_steps and self.stop_reason is None:
      stream = prefetch_to_device(iter(self.loader), self.device,
                                  size=prefetch)
      steps_this_epoch = 0
      try:
        for batch in stream:
          steps_this_epoch += 1
          metrics = train_step(self.model, self.opt, batch,
                               self.dropout_seed, self.max_predictions)
          loss = float(metrics['loss'])
          losses.append(loss)
          self.step += 1
          self.samples_seen += global_batch
          if not math.isfinite(loss) and nonfinite_stop:
            self.stop_reason = 'nonfinite_loss'
            break
          if log_every and self.step % log_every == 0:
            print(f'step={self.step} loss={loss:.4f} '
                  f'samples_seen={self.samples_seen}')
          if ckpt_dir and ckpt_every and self.step % ckpt_every == 0:
            self.save(ckpt_dir)
          if self.step >= max_steps:
            break
      finally:
        stream.close()
      if steps_this_epoch == 0 and self.stop_reason is None:
        raise ValueError(
            'loader yielded zero batches for a full epoch (dataset smaller '
            'than one global batch?); refusing to spin')
    if ckpt_dir and self._last_saved != self.step:
      self.save(ckpt_dir)
    if self.stop_reason is not None:
      print(f'stopping early: {self.stop_reason} '
            f'(step={self.step} samples_seen={self.samples_seen})')
    return losses
