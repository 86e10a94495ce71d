"""BERT-pretraining loss, AdamW and the train step, on one device.

Counterpart of :mod:`lddl_tpu.parallel.train` (its mesh placement waits
for the multi-GPU slice). Loss = masked-LM cross entropy (ignore label
-100, mean over masked positions) + next-sentence-prediction cross
entropy, over exactly the dict the loader yields. A batch with a
``segment_ids`` key (the packed loader with ``block_diagonal=True``) runs
block-diagonal attention and :func:`per_doc_mlm_loss`.

The optimizer is ``optax.adamw`` over
``warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))``
written out (b1 0.9, b2 0.999, eps 1e-8, decay on every parameter, the
learning rate taken at the pre-increment step count so step 0 runs at lr
0). PyTorch's own AdamW folds the decay and the schedule in differently,
so the port carries optax's update rule itself. As in optax, the step
count, the bias corrections and the schedule are float32 values on the
device, updated inside the step, so the step bakes no host number into a
launch and can be captured into a CUDA graph and replayed
(:class:`TrainStep`, :class:`~lddl_tpu_torch.training.pretrain.
CompiledStepCache`).
"""

import math
import warnings

import torch
import torch.nn.functional as F

from ..loader.bert import IGNORE_INDEX
from ..models.bert import SEEDED


def masked_positions(labels, max_predictions):
  """The first ``P = min(max_predictions, s)`` masked column indices per
  row, padded with unmasked columns (stable sort of the ~masked bitmap:
  masked columns first, in order)."""
  p = min(max_predictions, labels.shape[1])
  unmasked = (labels == IGNORE_INDEX).to(torch.uint8)
  return torch.argsort(unmasked, dim=1, stable=True)[:, :p]


def per_doc_mlm_loss(mlm_ce, masked, seg, num_docs_cap):
  """Packing-aware MLM normalization (arXiv:2107.02027 §3.2), as
  :func:`lddl_tpu.parallel.train.per_doc_mlm_loss`: each document's own
  masked-mean cross entropy, then the mean over the documents with at
  least one MLM target, so a packed row weighs its documents as unpacked
  training would.

  ``seg``: doc index per column, aligned with ``mlm_ce``/``masked``
  (gathered at ``mlm_positions`` under the masked-only head); padding (-1)
  and unmasked columns carry weight 0. ``num_docs_cap``: the bound on docs
  per row (the sequence length). The per-document sums are float32
  ``index_add`` over ``b * num_docs_cap`` segments.
  """
  b = masked.shape[0]
  rows = torch.arange(b, device=seg.device)[:, None]
  ids = (seg.long().clamp(0, num_docs_cap - 1) +
         num_docs_cap * rows).reshape(-1)
  w = masked.float().reshape(-1)
  zeros = torch.zeros(b * num_docs_cap, dtype=torch.float32,
                      device=mlm_ce.device)
  ce_sum = zeros.index_add(0, ids, mlm_ce.float().reshape(-1) * w)
  cnt = zeros.index_add(0, ids, w)
  has = cnt > 0
  per_doc = torch.where(has, ce_sum / cnt.clamp_min(1.0), 0.0)
  return per_doc.sum() / has.sum().clamp_min(1)


def pretrain_loss(model, batch, dropout_key=None, max_predictions=None):
  """Scalar loss + metrics dict for one batch.

  ``dropout_key=None`` runs deterministically (the JAX function's
  ``dropout_rng=None``). ``max_predictions=P`` selects the masked-only MLM
  head: only the first P masked positions per row get ``[b, P, V]``
  logits — the same MLM cross entropy at a fraction of the head's work,
  provided P covers the masking budget (:func:`check_max_predictions`).

  A ``segment_ids`` batch key switches on block-diagonal attention in the
  model and the :func:`per_doc_mlm_loss` normalization.
  """
  segment_ids = batch.get('segment_ids')
  labels = batch['labels'].long()
  mlm_positions = None
  if max_predictions is not None:
    mlm_positions = masked_positions(labels, max_predictions)
    labels = torch.gather(labels, 1, mlm_positions)
  mlm_logits, nsp_logits = model(
      batch['input_ids'], batch['token_type_ids'], batch['attention_mask'],
      dropout_key=dropout_key, mlm_positions=mlm_positions,
      segment_ids=segment_ids)
  masked = labels != IGNORE_INDEX
  safe_labels = torch.where(masked, labels, 0)
  mlm_ce = F.cross_entropy(mlm_logits.flatten(0, 1), safe_labels.flatten(),
                           reduction='none').view_as(labels)
  denom = masked.sum().clamp_min(1)
  if segment_ids is not None:
    seg = segment_ids
    if mlm_positions is not None:
      seg = torch.gather(segment_ids, 1, mlm_positions)
    mlm_loss = per_doc_mlm_loss(mlm_ce, masked, seg,
                                num_docs_cap=batch['input_ids'].shape[1])
  else:
    mlm_loss = torch.where(masked, mlm_ce, 0.0).sum() / denom
  nsp_loss = F.cross_entropy(nsp_logits,
                             batch['next_sentence_labels'].long())
  hits = masked & (mlm_logits.argmax(dim=-1) == labels)
  mlm_acc = hits.sum() / denom
  return mlm_loss + nsp_loss, {
      'mlm_loss': mlm_loss,
      'nsp_loss': nsp_loss,
      'mlm_acc': mlm_acc,
  }


def learning_rate(step, peak, warmup_steps, total_steps):
  """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
  max(total_steps, warmup_steps + 1))`` at ``step`` (end value 0), as a
  float32 0-d tensor computed as optax computes it. ``step`` is an int or
  a float32 tensor (the optimizer's device-side count: the result then
  lies beside it and the schedule runs inside the step)."""
  decay_steps = max(total_steps, warmup_steps + 1)
  count = torch.as_tensor(step, dtype=torch.float32)
  # optax.cosine_decay_schedule(peak, decay_steps - warmup_steps), joined
  # at the warmup boundary.
  span = decay_steps - warmup_steps
  t = torch.clamp(count - warmup_steps, max=span)
  cosine = peak * (0.5 * (1 + torch.cos(math.pi * t / span)))
  if warmup_steps <= 0:
    return cosine
  # optax.linear_schedule(0, peak, warmup_steps)
  frac = 1 - torch.clamp(count, 0, warmup_steps) / warmup_steps
  return torch.where(count < warmup_steps, -peak * frac + peak, cosine)


class AdamW:
  """``optax.adamw`` (eps_root 0, decay on every parameter) over a fixed
  list of float32 parameters.

  ``count`` is optax's step count as a host int (checkpoints, dropout
  keys); ``count_t`` is the same count as a float32 0-d tensor beside the
  parameters, which :meth:`apply` reads and advances on the device.
  :meth:`step` is :meth:`apply` plus the host count. ``params``, ``mu``,
  ``nu`` and ``count_t`` are updated in place and never rebound, so a
  CUDA graph that captured :meth:`apply` stays valid across
  :meth:`load_state_dict`.
  """

  def __init__(self, params, schedule, weight_decay=1e-4, b1=0.9, b2=0.999,
               eps=1e-8):
    self.params = list(params)
    self.schedule = schedule
    self.weight_decay = weight_decay
    self.b1, self.b2, self.eps = b1, b2, eps
    self.count = 0
    device = self.params[0].device if self.params else None
    self.count_t = torch.zeros((), dtype=torch.float32, device=device)
    self.mu = [torch.zeros_like(p) for p in self.params]
    self.nu = [torch.zeros_like(p) for p in self.params]

  @torch.no_grad()
  def apply(self, grads):
    """Apply one update from ``grads`` (aligned with ``params``) on the
    device: the learning rate at the pre-increment count, the moments,
    the count and the bias corrections all stay tensors, so nothing here
    reads the host (JAX returns new arrays; in place saves a copy of the
    model and both moments)."""
    lr = self.schedule(self.count_t)
    b1, b2 = self.b1, self.b2
    torch._foreach_mul_(self.mu, b1)
    torch._foreach_add_(self.mu, grads, alpha=1 - b1)
    torch._foreach_mul_(self.nu, b2)
    torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
    self.count_t += 1
    mu_hat = torch._foreach_div(self.mu, 1 - b1 ** self.count_t)
    denom = torch._foreach_sqrt(torch._foreach_div(self.nu,
                                                   1 - b2 ** self.count_t))
    torch._foreach_add_(denom, self.eps)
    update = torch._foreach_div(mu_hat, denom)
    torch._foreach_add_(update, self.params, alpha=self.weight_decay)
    torch._foreach_mul_(update, -lr)
    torch._foreach_add_(self.params, update)

  def step(self, grads):
    """:meth:`apply`, then advance the host count."""
    self.apply(grads)
    self.count += 1

  def state_dict(self):
    return {'count': self.count, 'mu': self.mu, 'nu': self.nu}

  def load_state_dict(self, state):
    """Copy ``state`` into the live tensors (in place)."""
    self.count = int(state['count'])
    with torch.no_grad():
      self.count_t.fill_(self.count)
      for dst, src in zip(self.mu + self.nu, state['mu'] + state['nu']):
        dst.copy_(src)


def global_norm(tensors):
  """``optax.global_norm``: the 2-norm of all tensors together."""
  return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainStep:
  """One train step, split where a CUDA graph needs it.

  :meth:`prepare` is host work: it reseeds the model's dropout
  generators from the dropout key ``(dropout_seed, opt.count)``, the JAX
  step's ``fold_in(rng, count)``, so a step is a pure function of
  (state, batch). :meth:`body` is device work only (forward, backward,
  grad norm, :meth:`AdamW.apply`) and can be captured and replayed;
  :meth:`finish` advances the host count. Calling the step runs the
  three in turn.
  """

  def __init__(self, model, opt, max_predictions=None):
    self.model = model
    self.opt = opt
    self.max_predictions = max_predictions

  def prepare(self, dropout_seed):
    self.model.seed_dropout((dropout_seed, self.opt.count))

  def generators(self):
    """The generators :meth:`body` draws from (what a CUDA graph of it
    must register)."""
    return self.model.dropout_generators()

  def body(self, batch):
    """Forward, backward and update; returns the metrics dict (0-d
    tensors). ``grad_norm`` is the global norm of the raw gradients,
    before the optimizer."""
    opt = self.opt
    for p in opt.params:
      p.grad = None
    loss, metrics = pretrain_loss(self.model, batch, dropout_key=SEEDED,
                                  max_predictions=self.max_predictions)
    loss.backward()
    grads = [p.grad for p in opt.params]
    metrics['grad_norm'] = global_norm(grads)
    opt.apply(grads)
    for p in opt.params:
      p.grad = None
    metrics['loss'] = loss
    # Detached, so no metric keeps the step's autograd graph alive (a
    # captured graph's outputs live as long as the graph).
    return {k: v.detach() for k, v in metrics.items()}

  def finish(self):
    self.opt.count += 1

  def __call__(self, batch, dropout_seed):
    self.prepare(dropout_seed)
    metrics = self.body(batch)
    self.finish()
    return metrics


def train_step(model, opt, batch, dropout_seed, max_predictions=None):
  """One eager train step (:class:`TrainStep`); returns the metrics dict
  (0-d tensors)."""
  return TrainStep(model, opt, max_predictions)(batch, dropout_seed)


def check_max_predictions(max_predictions, seq_len, masking,
                          mlm_probability=0.15):
  """Warn when a masked-only head budget under-covers the masking mode.

  Static masking caps per-row predictions at ``round(s·ratio)(+1)``;
  dynamic masking is per-position Bernoulli, so its count has a binomial
  tail — require ~4 standard deviations of headroom before calling the
  budget safe. An under-sized P silently drops the overflow targets from
  loss and gradients, which is exactly the quiet failure this warning
  exists to surface.
  """
  budget = round(seq_len * mlm_probability) + 1
  if masking == 'dynamic':
    sd = (seq_len * mlm_probability * (1 - mlm_probability)) ** 0.5
    budget = int(seq_len * mlm_probability + 4 * sd) + 1
  if max_predictions < min(budget, seq_len):
    warnings.warn(
        f'max_predictions={max_predictions} is below the {masking}-masking '
        f'budget ~{budget} for seq_len {seq_len}: rows with more masked '
        'positions silently drop their overflow MLM targets from the loss')
