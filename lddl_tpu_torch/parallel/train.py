"""BERT-pretraining loss, AdamW and the train step, on one device or
over a mesh of processes.

Counterpart of :mod:`lddl_tpu.parallel.train` over its mesh's ``data``,
``fsdp``, ``tensor`` and ``seq`` axes (:func:`make_exchange`; the model
holds its tensor shards and its ``1 / seq`` of each row,
:mod:`lddl_tpu_torch.models.bert`). Loss = masked-LM cross
entropy (ignore label -100, mean over masked positions) + next-sentence-
prediction cross entropy, over exactly the dict the loader yields. A
batch with a ``segment_ids`` key (the packed loader with
``block_diagonal=True``) runs block-diagonal attention and
:func:`per_doc_mlm_loss`.

Data parallelism (:class:`DataParallel`) computes what GSPMD computes
for the JAX step over a ``data`` mesh: every normalizer is the global
batch's. The MLM denominator, the documents with a target and the rows
depend only on the labels, the segment ids and the masked-only head, so
one small all-reduce of them runs before the forward; each rank's loss
is then its share of the global loss, the gradients all-reduce as a sum,
and the reported metrics and ``grad_norm`` are the global batch's.
Averaging per-rank means, as ``DistributedDataParallel`` does, would
weigh a rank's masked tokens by its own count instead.

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
CompiledStepCache`), or K steps into one graph (:func:`make_scan_train_step`
over a :func:`stack_batch_window` window, the JAX package's scan).
"""

import collections
import contextlib
import math
import os
import time
import traceback
import warnings

import torch
import torch.nn.functional as F

from ..loader.bert import IGNORE_INDEX
from ..loader.device import CUDA_FEED_LOCK
from ..models.bert import SEEDED
from ..ops import flash_attention as tfa
from ..telemetry import get_telemetry
from ..telemetry.step_costs import StepCostCounter
from .mesh import backend_for


def masked_positions(labels, max_predictions):
  """The first ``P = min(max_predictions, s)`` masked column indices per
  row, padded with unmasked columns (stable sort of the ~masked bitmap:
  masked columns first, in order)."""
  p = min(max_predictions, labels.shape[1])
  unmasked = (labels == IGNORE_INDEX).to(torch.uint8)
  return torch.argsort(unmasked, dim=1, stable=True)[:, :p]


def _doc_targets(masked, seg, num_docs_cap):
  """Per (row, document) segment: the float32 masked-target count, and
  the flat segment index of every column."""
  b = masked.shape[0]
  rows = torch.arange(b, device=seg.device)[:, None]
  ids = (seg.long().clamp(0, num_docs_cap - 1) +
         num_docs_cap * rows).reshape(-1)
  w = masked.float().reshape(-1)
  zeros = torch.zeros(b * num_docs_cap, dtype=torch.float32,
                      device=masked.device)
  return zeros.index_add(0, ids, w), ids, w, zeros


def per_doc_mlm_loss(mlm_ce, masked, seg, num_docs_cap, num_docs=None):
  """Packing-aware MLM normalization (arXiv:2107.02027 §3.2), as
  :func:`lddl_tpu.parallel.train.per_doc_mlm_loss`: each document's own
  masked-mean cross entropy, then the mean over the documents with at
  least one MLM target, so a packed row weighs its documents as unpacked
  training would.

  ``seg``: doc index per column, aligned with ``mlm_ce``/``masked``
  (gathered at ``mlm_positions`` under the masked-only head); padding (-1)
  and unmasked columns carry weight 0. ``num_docs_cap``: the bound on docs
  per row (the sequence length). The per-document sums are float32
  ``index_add`` over ``b * num_docs_cap`` segments. ``num_docs``: the
  global batch's count of documents with a target (data parallelism),
  default this batch's.
  """
  cnt, ids, w, zeros = _doc_targets(masked, seg, num_docs_cap)
  ce_sum = zeros.index_add(0, ids, mlm_ce.float().reshape(-1) * w)
  has = cnt > 0
  per_doc = torch.where(has, ce_sum / cnt.clamp_min(1.0), 0.0)
  if num_docs is None:
    num_docs = has.sum()
  return per_doc.sum() / num_docs.clamp_min(1)


def local_counts(masked, seg, num_docs_cap):
  """This rank's share of the step's normalizers, int64 ``[3]``: masked
  MLM targets, documents with a target (0 without ``seg``) and rows."""
  docs = torch.zeros((), dtype=torch.int64, device=masked.device)
  if seg is not None:
    docs = (_doc_targets(masked, seg, num_docs_cap)[0] > 0).sum()
  rows = torch.full((), masked.shape[0], dtype=torch.int64,
                    device=masked.device)
  return torch.stack([masked.sum(), docs, rows])


def vocab_parallel_cross_entropy(logits, labels, tp):
  """Per-position cross entropy and argmax over the vocabulary, where
  ``logits`` holds this rank's ``V / tensor`` columns (the tensor-parallel
  tied decoder) and ``labels`` are global ids: the whole-vocabulary
  :func:`F.cross_entropy` and ``argmax``, without gathering the logits.

  The ranks' row maxima and their first argmax are stacked over the tensor
  group (:func:`~lddl_tpu_torch.parallel.mesh.stack_over`); the max is
  the largest, the prediction the lowest global index that reaches it, as
  ``jnp.argmax`` breaks ties. The sum of ``exp(logit - max)`` and the
  target's shifted logit are summed over the group with an identity
  backward, so each rank's logits get ``softmax - onehot`` of their own
  columns. Returns float32 ``ce`` and int64 ``predicted``, both whole on
  every rank of the group."""
  from ..models.bert import reduce_from_tensor
  from .mesh import stack_over
  v = logits.shape[-1]
  lo = tp.rank * v
  with torch.no_grad():
    local_max, local_arg = logits.max(dim=-1)
    maxes = stack_over(local_max, tp.group)
    args = stack_over(local_arg + lo, tp.group)
    top = maxes.amax(dim=0)
    predicted = torch.where(maxes == top, args,
                            torch.iinfo(torch.int64).max).amin(dim=0)
  shifted = logits.float() - top[..., None]
  total = reduce_from_tensor(shifted.exp().sum(dim=-1), tp)
  local = labels.long() - lo
  mine = (local >= 0) & (local < v)
  picked = torch.gather(shifted, -1, torch.where(mine, local, 0)[..., None])
  target = reduce_from_tensor(torch.where(mine, picked[..., 0], 0.0), tp)
  return torch.log(total) - target, predicted


def pretrain_loss(model, batch, dropout_key=None, max_predictions=None,
                  reduce=None):
  """Scalar loss + metrics dict for one batch.

  ``dropout_key=None`` runs deterministically (the JAX function's
  ``dropout_rng=None``). ``max_predictions=P`` selects the masked-only MLM
  head: only the first P masked positions per row get ``[b, P, V]``
  logits — the same MLM cross entropy at a fraction of the head's work,
  provided P covers the masking budget (:func:`check_max_predictions`).

  A ``segment_ids`` batch key switches on block-diagonal attention in the
  model and the :func:`per_doc_mlm_loss` normalization.

  ``reduce``: data parallelism. It sums :func:`local_counts` over the
  ranks (in place, returning the tensor) before the forward, and the
  loss and metrics are then this rank's shares of the global batch's:
  summed over the ranks they are the global values. With one rank they
  equal ``reduce=None``'s bit for bit. Under tensor parallelism (the
  model's ``tp``) the MLM logits are the rank's vocabulary columns and
  the cross entropy and accuracy run :func:`vocab_parallel_cross_entropy`;
  ``reduce`` then sums over the ``data x fsdp (x seq)`` ranks only.

  Under sequence parallelism (the model's ``sp``) the batch holds the
  rank's ``1 / seq`` of each row: the labels and segment ids are gathered
  into whole rows (the model's heads read whole rows on every seq rank),
  the normalizers are counted on seq rank 0 alone, and with ``reduce``
  each seq rank's loss and metrics are ``1 / seq`` of its rows' share, so
  the sum over ``data x fsdp x seq`` is the global batch's.
  """
  from ..models.bert import gather_columns
  sp = getattr(model, 'sp', None)
  segment_ids = batch.get('segment_ids')
  labels = batch['labels'].long()
  seg = segment_ids
  if sp is not None:
    labels = gather_columns(labels, sp)
    if segment_ids is not None:
      seg = gather_columns(segment_ids, sp)
  mlm_positions = None
  if max_predictions is not None:
    mlm_positions = masked_positions(labels, max_predictions)
  num_docs_cap = labels.shape[1]
  if mlm_positions is not None:
    labels = torch.gather(labels, 1, mlm_positions)
    if seg is not None:
      seg = torch.gather(seg, 1, mlm_positions)
  masked = labels != IGNORE_INDEX
  totals = None
  share = 1.0
  if reduce is not None:
    counts = local_counts(masked, seg, num_docs_cap)
    if sp is not None:
      # Every seq rank holds the same whole rows: one of them counts.
      counts = counts * int(sp.rank == 0)
      share = 1.0 / sp.size
    totals = reduce(counts)
  mlm_logits, nsp_logits = model(
      batch['input_ids'], batch['token_type_ids'], batch['attention_mask'],
      dropout_key=dropout_key, mlm_positions=mlm_positions,
      segment_ids=segment_ids)
  safe_labels = torch.where(masked, labels, 0)
  tp = getattr(model, 'tp', None)
  if tp is None:
    mlm_ce = F.cross_entropy(mlm_logits.flatten(0, 1), safe_labels.flatten(),
                             reduction='none').view_as(labels)
    predicted = mlm_logits.argmax(dim=-1)
  else:
    mlm_ce, predicted = vocab_parallel_cross_entropy(mlm_logits, safe_labels,
                                                     tp)
  denom = (masked.sum() if totals is None else totals[0]).clamp_min(1)
  if segment_ids is not None:
    mlm_loss = per_doc_mlm_loss(
        mlm_ce, masked, seg, num_docs_cap=num_docs_cap,
        num_docs=None if totals is None else totals[1])
  else:
    mlm_loss = torch.where(masked, mlm_ce, 0.0).sum() / denom
  nsp_loss = F.cross_entropy(nsp_logits,
                             batch['next_sentence_labels'].long())
  if totals is not None:
    # This rank's rows' share of the global mean (exactly 1 on one rank).
    nsp_loss = nsp_loss * (labels.shape[0] / totals[2])
  hits = masked & (predicted == labels)
  mlm_acc = hits.sum() / denom
  if share != 1.0:
    mlm_loss, nsp_loss, mlm_acc = (t * share for t in (mlm_loss, nsp_loss,
                                                       mlm_acc))
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


class TensorReplicas:
  """Makes a tensor group's replicated gradients equal by construction.

  The parameters no rule cuts over ``tensor`` (the position and type
  tables, the LayerNorms, the pooler, the NSP head, ``mlm_transform``,
  the row-parallel biases) are held whole by every rank of a tensor
  group, and each rank computes their gradients on its own: outside
  deterministic mode CUDA's atomics can round them differently on each
  rank, and the replicas would drift where GSPMD holds one array. So the
  exchange copies them into one flat buffer and broadcasts it from the
  group's rank 0 before its data/fsdp reduction. A broadcast of values
  that are already equal changes no bit (an average over more than two
  ranks could round). NCCL broadcasts, inside a captured step too; any
  other backend (gloo, which stages CUDA tensors through host memory)
  sums the int64 words of the buffer, zeroed on every rank but the
  source, which moves the source's bits unchanged."""

  def __init__(self, tensor, views, sharded):
    import torch.distributed as dist
    self._dist = dist
    self.group = tensor
    self.views = [v for v, cut in zip(views, sharded) if not cut]
    sizes = [v.numel() for v in self.views]
    n = sum(sizes)
    device = self.views[0].device
    # An even length: the int64 sum moves 8-byte words.
    self.buf = torch.zeros(n + n % 2, dtype=torch.float32, device=device)
    self.parts = [part.view_as(v) for part, v in
                  zip(self.buf[:n].split(sizes), self.views)]
    self.src = dist.get_global_rank(tensor, 0)
    self.is_src = dist.get_rank() == self.src
    self.backend = backend_for(tensor, device)

  def __call__(self):
    torch._foreach_copy_(self.parts, self.views)
    # lddl: noqa[LDA011] rank-uniform: the backend is the tensor group's
    # one backend (backend_for), the same on every rank of the group.
    if self.backend == 'nccl':
      self._dist.broadcast(self.buf, src=self.src, group=self.group)
    else:
      if not self.is_src:
        self.buf.zero_()
      self._dist.all_reduce(self.buf.view(torch.int64), group=self.group)
    torch._foreach_copy_(self.views, self.parts)


class DataParallel:
  """The data-parallel exchange of one step over a process group (the
  mesh's ``data x fsdp x seq`` group, :func:`~lddl_tpu_torch.parallel.
  mesh.reduce_group`): the normalizers' all-reduce before the forward
  (:func:`pretrain_loss`'s ``reduce``), the gradients' and the metrics'
  after the backward, all sums.

  The gradients are copied into one flat float32 buffer, made once, and
  reduced in one call; the optimizer then reads views of it, so every
  rank applies the same update to the same parameters and the ranks stay
  bit-equal. With one rank each reduction is a copy and the step equals
  the single-process step bit for bit. The ranks of a ``seq`` group hold
  the same parameters and each its gradient's part from its columns: the
  sum over the group is the step's gradient, whole on every rank, so
  :meth:`grad_norm` counts each parameter once.

  Under tensor parallelism (``tensor``: the tensor group, ``sharded``:
  per parameter whether the rank holds a tensor shard of it) the
  parameters are the rank's shards, their gradients need no exchange
  over the tensor group (the model's collectives made them whole), the
  replicated parameters' gradients are broadcast from the group's rank 0
  first (:class:`TensorReplicas`), and :meth:`grad_norm` sums the sharded
  parameters' squares over it while the replicated ones count once.

  :attr:`capturable`: whether the group's backend for the parameters'
  device can run inside a CUDA graph (NCCL can; gloo, which stages CUDA
  tensors through host memory, cannot).
  """

  def __init__(self, group, params, tensor=None, sharded=None):
    import torch.distributed as dist
    self._dist = dist
    self.group = group
    self.world = dist.get_world_size(group)
    params = list(params)
    device = params[0].device
    self.flat = torch.empty(sum(p.numel() for p in params),
                            dtype=torch.float32, device=device)
    self.views, at = [], 0
    for p in params:
      self.views.append(self.flat[at:at + p.numel()].view_as(p))
      at += p.numel()
    self.backend = backend_for(group, device)
    self.capturable = device.type == 'cuda' and self.backend == 'nccl'
    self.tensor = tensor
    self._sharded = None
    self.replicas = None
    if tensor is not None:
      sharded = list(sharded)
      self._sharded = torch.tensor(sharded, dtype=torch.float32,
                                   device=device)
      self.replicas = TensorReplicas(tensor, self.views, sharded)

  def sum_(self, t):
    """All-reduce ``t`` in place (a sum over the ranks); returns it."""
    self._dist.all_reduce(t, group=self.group)
    return t

  def grads(self, grads):
    """The global gradients: the sum of every rank's, as views of the
    flat buffer aligned with ``grads``."""
    torch._foreach_copy_(self.views, grads)
    if self.replicas is not None:
      self.replicas()
    self.sum_(self.flat)
    return self.views

  def metrics(self, metrics):
    """Sum each 0-d metric over the ranks (one all-reduce)."""
    names = sorted(metrics)
    total = self.sum_(torch.stack([metrics[k].float() for k in names]))
    return dict(zip(names, total.unbind()))

  def grad_norm(self, grads):
    """The global norm of the model's gradient (:func:`global_norm`
    without tensor parallelism)."""
    if self.tensor is None:
      return global_norm(grads)
    sq = torch.stack(torch._foreach_norm(grads)) ** 2
    sharded = (sq * self._sharded).sum()
    self._dist.all_reduce(sharded, group=self.tensor)
    return torch.sqrt(sharded + (sq * (1 - self._sharded)).sum())

  # The parameters are the model's own: nothing to gather, release or
  # take back from them.

  def gather_params(self):
    pass

  def release_params(self):
    pass

  def load_params(self):
    pass

  @contextlib.contextmanager
  def gathered(self):
    yield

  def opt_params(self, params):
    return list(params)

  def local_states(self, params, opt):
    """The parameters ``params``, then AdamW's ``mu``, then its ``nu``,
    each yielded as a list aligned with the model's parameters, in this
    rank's shapes."""
    yield [p.detach() for p in params]
    yield opt.mu
    yield opt.nu

  def load_local(self, opt, mu, nu):
    """Copy per-parameter moments (this rank's shapes) into ``opt``."""
    with torch.no_grad():
      torch._foreach_copy_(opt.mu + opt.nu, list(mu) + list(nu))


class ShardedDataParallel(DataParallel):
  """Data parallelism with sharded parameters and optimizer state over
  the mesh's ``fsdp`` axis (ZeRO-3 over :class:`DataParallel`'s flat
  buffer), the port's counterpart of GSPMD's ``fsdp`` placement.

  The model's parameters (this rank's tensor shards) are views of one
  flat float32 working buffer, padded to a multiple of ``fsdp``. Each
  ``fsdp`` rank owns one contiguous ``1 / fsdp`` of it (:attr:`shard`,
  the master copy), and AdamW runs on that shard alone (:meth:`opt_params`;
  its rule is per element, so ``mu`` and ``nu`` are ``1 / fsdp`` too).
  A step (:class:`TrainStep`) gathers the working buffer from the shards
  before the forward (:meth:`gather_params`); after the backward the
  replicated parameters' gradients are broadcast over ``tensor``
  (:class:`TensorReplicas`), then the gradients' flat buffer is
  reduce-scattered over ``fsdp`` and its shard
  all-reduced over ``data x seq`` (:meth:`grads`, the ranks that hold the
  same shard), and the update runs on the shard. Eager steps then free the working buffer (:meth:`release_params`),
  so between steps a rank keeps ``1 / fsdp`` of the parameters and the
  moments; read them through :meth:`gathered`. A CUDA-graph step keeps
  the buffer (its addresses are the graph's), gathering it again at each
  replay's start.

  Collectives by the group's backend: NCCL runs ``all_gather_into_tensor``
  and ``reduce_scatter_tensor``; any other backend (gloo for CUDA tensors,
  which stages through host memory) gathers as an exact int64 sum of the
  ranks' zero-padded slots (:meth:`_gather`) and reduce-scatters as an
  all-reduce of the whole buffer and a slice: that choice is logged once
  when the exchange is made.

  A save (:meth:`local_states`) gathers the parameters, ``mu`` and ``nu``
  one at a time into the gradients' flat buffer, which is idle between
  steps, so it needs no flat buffer beyond what a step holds.
  """

  def __init__(self, mesh, model):
    import logging

    import torch.distributed as dist

    from .mesh import (axis_rank, axis_size, fsdp_group, reduce_group,
                       replica_group, tensor_group)
    self._dist = dist
    self.group = reduce_group(mesh)
    self.world = dist.get_world_size(self.group)
    self.fsdp = fsdp_group(mesh)
    self.data = replica_group(mesh)
    size, rank = axis_size(mesh, 'fsdp'), axis_rank(mesh, 'fsdp')
    params = list(model.parameters())
    device = params[0].device
    n = sum(p.numel() for p in params)
    # Each shard an even length: the gloo gather sums 8-byte words.
    per = -(-n // (2 * size)) * 2
    self.lo, self.hi = rank * per, (rank + 1) * per
    self.full = torch.zeros(per * size, dtype=torch.float32, device=device)
    self.flat = torch.zeros_like(self.full)
    self.views, at = [], 0
    sharded = torch.zeros_like(self.full)
    cuts = list(model.tensor_sharded())
    with torch.no_grad():
      for p, cut in zip(params, cuts):
        view = self.full[at:at + p.numel()].view_as(p)
        view.copy_(p)
        p.data = view
        self.views.append(self.flat[at:at + p.numel()].view_as(p))
        sharded[at:at + p.numel()] = float(cut)
        at += p.numel()
    self.shard = self.full[self.lo:self.hi].clone()
    self.grad_shard = torch.zeros_like(self.shard)
    self.backend = backend_for(self.fsdp, device)
    self.capturable = device.type == 'cuda' and self.backend == 'nccl'
    self.tensor = tensor_group(mesh) if model.tp is not None else None
    self._sharded = sharded[self.lo:self.hi].clone() if self.tensor else None
    self.replicas = (TensorReplicas(self.tensor, self.views, cuts)
                     if self.tensor is not None else None)
    self._nbytes = self.full.numel() * self.full.element_size()
    self._release = not self.capturable
    self._released = False
    if self.backend != 'nccl':
      logging.getLogger('lddl_tpu_torch').info(
          'fsdp over %s for %s tensors: the parameters gather as a sum of '
          'zero-padded slots and the gradients reduce-scatter as an '
          'all-reduce and a slice', self.backend, device.type)
    self.release_params()

  def opt_params(self, params):
    del params
    return [self.shard]

  def _gather(self, out, shard):
    """Fill the flat buffer ``out`` with every fsdp rank's ``shard``, in
    place. Over gloo, whose one collective shown to take CUDA tensors is
    a sum: each rank writes its shard into its own slot of ``out``
    zeroed, and the int64 sum adds one rank's bits to zeros, exactly."""
    if self.backend == 'nccl':
      self._dist.all_gather_into_tensor(out, shard, group=self.fsdp)
      return
    out.zero_()
    out[self.lo:self.hi].copy_(shard)
    self._dist.all_reduce(out.view(torch.int64), group=self.fsdp)

  def gather_params(self):
    """Fill the working buffer (the model's parameters) from the shards."""
    if self._released:
      self.full.untyped_storage().resize_(self._nbytes)
      self._released = False
    self._gather(self.full, self.shard)

  def release_params(self):
    """Free the working buffer after an eager step. A CPU buffer that
    ``Tensor.numpy()`` has exported can no longer be resized: it then
    stays allocated (a warning says so), which changes no value."""
    if not self._release or self._released:
      return
    storage = self.full.untyped_storage()
    if not storage.resizable():
      warnings.warn('the fsdp working buffer was exported (Tensor.numpy()) '
                    'and cannot be freed between steps; it stays allocated')
      self._release = False
      return
    storage.resize_(0)
    self._released = True

  @contextlib.contextmanager
  def gathered(self):
    """The model's parameters gathered inside (collective over fsdp)."""
    self.gather_params()
    try:
      yield
    finally:
      self.release_params()

  def grads(self, grads):
    """This rank's shard of the global gradient: ``[grad_shard]``."""
    torch._foreach_copy_(self.views, grads)
    if self.replicas is not None:
      self.replicas()
    # lddl: noqa[LDA011] rank-uniform: the backend is the fsdp group's one
    # backend (backend_for), the same on every rank of the group.
    if self.backend == 'nccl':
      self._dist.reduce_scatter_tensor(self.grad_shard, self.flat,
                                       group=self.fsdp)
    else:
      self._dist.all_reduce(self.flat, group=self.fsdp)
      self.grad_shard.copy_(self.flat[self.lo:self.hi])
    if self.data is not None:
      # Over data x seq: every rank that holds this shard.
      self._dist.all_reduce(self.grad_shard, group=self.data)
    return [self.grad_shard]

  def grad_norm(self, grads):
    """The global norm from the gradient shards: each shard's sum of
    squares summed over fsdp; the tensor-sharded parameters' part summed
    over the tensor group too, the replicated ones counted once."""
    (g,) = grads
    sq = g * g
    if self.tensor is None:
      parts = sq.sum()[None]
    else:
      parts = torch.stack([(sq * self._sharded).sum(),
                           (sq * (1 - self._sharded)).sum()])
    self._dist.all_reduce(parts, group=self.fsdp)
    if self.tensor is None:
      return torch.sqrt(parts[0])
    sharded = parts[0].clone()
    self._dist.all_reduce(sharded, group=self.tensor)
    return torch.sqrt(sharded + parts[1])

  def local_states(self, params, opt):
    """The parameters, then ``mu``, then ``nu``, each gathered whole
    (collective over fsdp) into the gradients' flat buffer and yielded as
    its views aligned with the parameters: a list is valid until the next
    is yielded. The buffer is zeroed after, as a step expects it."""
    del params
    try:
      for shard in (self.shard, opt.mu[0], opt.nu[0]):
        self._gather(self.flat, shard)
        yield self.views
    finally:
      self.flat.zero_()

  def load_local(self, opt, mu, nu):
    """Copy this rank's range of per-parameter moments (whole over
    fsdp, the rank's tensor shapes) into its shards of ``mu`` and ``nu``,
    parameter by parameter."""
    with torch.no_grad():
      for dst, parts in ((opt.mu[0], mu), (opt.nu[0], nu)):
        for v, t in zip(self.views, parts):
          lo = max(v.storage_offset(), self.lo)
          hi = min(v.storage_offset() + v.numel(), self.hi)
          if lo < hi:
            dst[lo - self.lo:hi - self.lo].copy_(
                t.reshape(-1)[lo - v.storage_offset():hi - v.storage_offset()])

  def load_params(self):
    """Take the master shard from the working buffer after the model's
    parameters were written (inside :meth:`gathered`)."""
    with torch.no_grad():
      self.shard.copy_(self.full[self.lo:self.hi])


def make_exchange(mesh, model):
  """The train step's exchange over ``mesh``: None without one,
  :class:`ShardedDataParallel` with ``fsdp`` above 1, else
  :class:`DataParallel` over the ``data x fsdp x seq`` group (with the
  tensor group when ``tensor`` is above 1). Build it after the model is
  on its device and before the optimizer, which takes
  ``exchange.opt_params(model.parameters())``."""
  from .mesh import axis_size, reduce_group, tensor_group
  if mesh is None:
    return None
  if axis_size(mesh, 'fsdp') > 1:
    return ShardedDataParallel(mesh, model)
  tp = model.tp is not None
  return DataParallel(reduce_group(mesh), model.parameters(),
                      tensor_group(mesh) if tp else None,
                      model.tensor_sharded() if tp else None)


class TrainStep:
  """One train step, split where a CUDA graph needs it.

  :meth:`prepare` is host work: it reseeds the model's dropout
  generators from the dropout key ``(dropout_seed, opt.count)``, the JAX
  step's ``fold_in(rng, count)``, so a step is a pure function of
  (state, batch); a batch rank above 0 (``dp_rank``, the mesh's
  :func:`~lddl_tpu_torch.parallel.mesh.batch_rank`) folds its rank in
  (``(dropout_seed, opt.count, dp_rank)``), so ranks draw different
  masks for their different rows and rank 0 draws what one process
  draws. The ranks of a tensor group share a batch rank and so draw the
  same masks: every dropout site acts on activations they all hold
  whole. A seq rank above 0 (the model's ``sp``) folds in its batch and
  seq ranks (``(dropout_seed, opt.count, dp_rank, seq_rank)``): each seq
  rank draws its own columns' masks, where the JAX step draws one mask
  over the whole row. :meth:`body` is device work only (forward, backward, grad norm,
  :meth:`AdamW.apply`, and with ``exchange`` (:func:`make_exchange`) its
  collectives) and can be captured and replayed; :meth:`finish`
  advances the host count. Calling the step runs the three in turn.
  """

  def __init__(self, model, opt, max_predictions=None, exchange=None,
               dp_rank=0):
    self.model = model
    self.opt = opt
    self.max_predictions = max_predictions
    self.exchange = exchange
    self.dp_rank = dp_rank
    sp = getattr(model, 'sp', None)
    self.seq_rank = 0 if sp is None else sp.rank
    self.params = list(model.parameters())

  @property
  def capturable(self):
    """Whether :meth:`body` can be captured into a CUDA graph."""
    return self.exchange is None or self.exchange.capturable

  def dropout_key(self, dropout_seed, ahead=0):
    """The dropout key of the step ``ahead`` steps after the next one."""
    key = (dropout_seed, self.opt.count + ahead)
    if self.seq_rank:
      key += (self.dp_rank, self.seq_rank)
    elif self.dp_rank:
      key += (self.dp_rank,)
    return key

  def prepare(self, dropout_seed):
    self.model.seed_dropout(self.dropout_key(dropout_seed))

  def generators(self):
    """The generators :meth:`body` draws from (what a CUDA graph of it
    must register)."""
    return self.model.dropout_generators()

  def body(self, batch):
    """Forward, backward and update; returns the metrics dict (0-d
    tensors). ``grad_norm`` is the global norm of the raw gradients,
    before the optimizer."""
    opt = self.opt
    exchange = self.exchange
    for p in self.params:
      p.grad = None
    if exchange is not None:
      exchange.gather_params()
    loss, metrics = pretrain_loss(
        self.model, batch, dropout_key=SEEDED,
        max_predictions=self.max_predictions,
        reduce=None if exchange is None else exchange.sum_)
    loss.backward()
    grads = [p.grad for p in self.params]
    metrics['loss'] = loss
    if exchange is None:
      metrics['grad_norm'] = global_norm(grads)
    else:
      grads = exchange.grads(grads)
      metrics = exchange.metrics({k: v.detach() for k, v in metrics.items()})
      metrics['grad_norm'] = exchange.grad_norm(grads)
    opt.apply(grads)
    for p in self.params:
      p.grad = None
    if exchange is not None:
      exchange.release_params()
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


def signature(batch):
  """A batch's (or window's) graph signature: its keys, shapes and
  dtypes."""
  return tuple(
      sorted((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))


def _where_raised(exc):
  """``file:line: source`` of the innermost frame outside torch itself
  in ``exc``'s traceback: the op of the step that raised."""
  frames = traceback.extract_tb(exc.__traceback__)
  torch_dir = os.path.dirname(torch.__file__)
  ours = [f for f in frames if not f.filename.startswith(torch_dir)]
  f = (ours or frames)[-1]
  return f'{f.filename}:{f.lineno}: {f.line}'


def capture_step(stream, warm_up, body, generators, what, counter=None):
  """Capture train-step work into one CUDA graph: the miss of
  :class:`~lddl_tpu_torch.training.pretrain.CompiledStepCache` and of
  :class:`ScanTrainStep`.

  ``warm_up()`` runs the real work eagerly on the side ``stream`` (the
  warm-up a capture needs, and the step itself); then ``body()`` is
  captured on that stream into a ``torch.cuda.CUDAGraph`` with its own
  memory pool, ``generators`` registered so that a replay draws from
  their state at the replay. The capture runs in global mode under
  :data:`~lddl_tpu_torch.loader.device.CUDA_FEED_LOCK`: another thread's
  CUDA call would break it, so the feed's producers wait until it is
  over. Capture executes nothing, so the kernels' launch counters
  (``tfa.launches``) are put back and the launches of one replay are
  returned. A capture that fails raises and names the op (``what`` says
  what was captured); nothing falls back to eager. With a ``counter``
  (:class:`~lddl_tpu_torch.telemetry.step_costs.StepCostCounter`) the
  warm-up runs under it: it runs the same work eagerly, so its count is a
  replay's. The capture stays outside the counter.

  Returns ``(warm_up's result, graph, body's outputs, launches per
  replay)``.
  """
  current = torch.cuda.current_stream()
  stream.wait_stream(current)
  with torch.cuda.stream(stream), (counter or contextlib.nullcontext()):
    result = warm_up()
  graph = torch.cuda.CUDAGraph()
  for gen in generators:
    graph.register_generator_state(gen)
  before = dict(tfa.launches)
  try:
    with CUDA_FEED_LOCK, torch.cuda.graph(graph, stream=stream,
                                          capture_error_mode='global'):
      outputs = body()
  except Exception as e:
    raise RuntimeError(f'capturing {what} into a CUDA graph failed at '
                       f'{_where_raised(e)}: {e}') from e
  finally:
    launches = {n: tfa.launches[n] - before[n] for n in before}
    tfa.launches.update(before)
  current.wait_stream(stream)
  return result, graph, outputs, launches


# One captured step or window: the graph, the static input buffers it
# reads, the outputs it writes (a window's: its last step's), the kernel
# launches it makes per replay and, when it was counted, the StepCosts of a
# replay (telemetry.step_costs; None uncounted).
CapturedGraph = collections.namedtuple(
    'CapturedGraph', 'graph inputs outputs launches costs',
    defaults=(None,))


def step_counter():
  """A fresh :class:`~lddl_tpu_torch.telemetry.step_costs.StepCostCounter`
  when telemetry is on, else None: a step is counted only where its count
  is billed."""
  return StepCostCounter() if get_telemetry().enabled else None


class ScanTrainStep:
  """K train steps as one program: the counterpart of the JAX package's
  ``make_scan_train_step`` (``lax.scan`` over a window of batches).

  ``run(window, dropout_seed)`` takes a window (dict of ``[K, ...]``
  tensors, :func:`stack_batch_window`) and returns the metrics of its
  last step, as the JAX function does (``m[-1]``). K steps run this way
  leave the model, AdamW's ``mu``, ``nu``, ``count_t`` and the host
  ``count`` exactly as K :class:`TrainStep` calls over the K batches
  would.

  **Dropout.** A step reseeds its dropout generators on the host from
  ``(dropout_seed, count)`` (:meth:`TrainStep.prepare`), and no host
  work runs between the steps of one CUDA graph. So the window keeps K
  generator sets, one per step slot
  (:meth:`~lddl_tpu_torch.models.bert.BertForPretraining.drawing_from`):
  before every run slot i's set is seeded from step i's key
  (:meth:`TrainStep.dropout_key`), and step i draws from it, in a graph
  and on the CPU alike. The device-side count (``count_t``) carries the
  learning rate from step to step inside the window; the host count
  advances by K after it.

  **On the card** (CUDA window, :attr:`TrainStep.capturable` step), the
  first run of a (signature, K, deterministic algorithms) key copies the
  window into static input buffers, runs the K steps eagerly on a side
  stream and captures the K step bodies into one CUDA graph reading
  slices of those buffers (:func:`capture_step`, shared with the step
  cache); every later run copies the window in (one copy per key),
  seeds the K sets and replays once, and adds the launches recorded at
  capture to the wrappers' counters. A CPU window, or a step whose group
  cannot be captured (gloo), runs the K step bodies in turn;
  :attr:`mode` says which the card runs, as the step cache's does.
  ``captures`` and ``hits`` count the graph runs; ``miss_seconds`` is
  the time of the captures' runs, ``capture_seconds`` the part of it
  that capturing and instantiating the graphs took (the rest ran the K
  steps eagerly).

  **Step costs.** With telemetry on, the first run of a key counts its K
  step bodies (:mod:`~lddl_tpu_torch.telemetry.step_costs`; a graph's
  in its warm-up) and ``last_costs`` holds the count of the window that
  just ran, the K steps' together (XLA counts a ``scan`` body once); None
  while the key is uncounted.
  """

  def __init__(self, model, opt, max_predictions=None, exchange=None,
               dp_rank=0):
    self.step = TrainStep(model, opt, max_predictions, exchange, dp_rank)
    self.model = model
    self._graphs = {}
    self._slots = []      # one dropout generator set per step slot
    self._stream = None   # the side stream captures run on
    self.captures = 0
    self.hits = 0
    self.miss_seconds = 0.0
    self.capture_seconds = 0.0
    self._costs = {}      # key -> the StepCosts of its window
    self.last_costs = None

  @property
  def mode(self):
    """``'graph'``, or ``'eager'`` when the step cannot be captured."""
    return 'graph' if self.step.capturable else 'eager'

  def generators(self):
    """Every generator the window's steps draw from."""
    return [g for gens in self._slots for g in gens]

  def _seed(self, k, dropout_seed):
    """Slot i's set seeded from step i's dropout key, i < ``k``."""
    while len(self._slots) < k:
      self._slots.append(self.model.new_dropout_generators())
    for i in range(k):
      with self.model.drawing_from(self._slots[i]):
        self.model.seed_dropout(self.step.dropout_key(dropout_seed, i))

  def _bodies(self, window, k):
    """The K step bodies over ``window``'s slices, step i drawing from
    slot i; the last step's metrics."""
    metrics = None
    for i in range(k):
      with self.model.drawing_from(self._slots[i]):
        metrics = self.step.body({name: t[i] for name, t in window.items()})
    return metrics

  def __call__(self, window, dropout_seed):
    first = next(iter(window.values()))
    k = first.shape[0]
    self._seed(k, dropout_seed)
    key = (signature(window), k, torch.are_deterministic_algorithms_enabled())
    if first.device.type == 'cuda' and self.mode == 'graph':
      metrics = self._graph_run(window, k, key)
    else:
      counter = None if key in self._costs else step_counter()
      with counter or contextlib.nullcontext():
        metrics = self._bodies(window, k)
      if counter is not None:
        self._costs[key] = counter.costs
    self.last_costs = self._costs.get(key)
    for _ in range(k):
      self.step.finish()
    return metrics

  def _graph_run(self, window, k, key):
    entry = self._graphs.get(key)
    if entry is not None:
      for name, t in window.items():
        entry.inputs[name].copy_(t)
      entry.graph.replay()
      for name, n in entry.launches.items():
        tfa.launches[name] += n
      self.hits += 1
      return entry.outputs
    t0 = time.perf_counter()
    if self._stream is None:
      self._stream = torch.cuda.Stream()
    inputs = {name: t.clone() for name, t in window.items()}
    eager = []

    def warm_up():
      t = time.perf_counter()
      metrics = self._bodies(inputs, k)
      torch.cuda.synchronize()
      eager.append(time.perf_counter() - t)
      return metrics

    counter = step_counter()
    metrics, graph, outputs, launches = capture_step(
        self._stream, warm_up, lambda: self._bodies(inputs, k),
        self.generators(),
        f'a window of {k} train steps of signature {key[0]}', counter)
    self._graphs[key] = CapturedGraph(graph, inputs, outputs, launches,
                                      counter and counter.costs)
    if counter is not None:
      self._costs[key] = counter.costs
    self.captures += 1
    seconds = time.perf_counter() - t0
    self.miss_seconds += seconds
    self.capture_seconds += seconds - eager[0]
    return metrics


def make_scan_train_step(model, opt, max_predictions=None, exchange=None,
                         dp_rank=0):
  """``run(window, dropout_seed) -> metrics of the window's last step``:
  a :class:`ScanTrainStep` (the JAX package's ``make_scan_train_step``;
  ``exchange``/``dp_rank`` as :class:`TrainStep`'s)."""
  return ScanTrainStep(model, opt, max_predictions, exchange, dp_rank)


# (signature, K, pinned) -> [{key: host [K, ...] tensor}, the CUDA event
# after the last copy out of it, or None].
WINDOW_STACKS = {}


def stack_batch_window(batches, device):
  """Stack K same-signature host batches (numpy arrays or CPU tensors)
  into one window of ``[K, ...]`` tensors on ``device``: the JAX
  package's ``stack_batch_window`` (its mesh has no counterpart here:
  data-parallel ranks hold their local rows, as in :class:`TrainStep`).

  The host stack is one tensor per key, pinned for a CUDA device, kept
  per (signature, K) in :data:`WINDOW_STACKS` and reused from window to
  window (after the previous window's copies out of it are done); each
  key then takes one ``non_blocking`` copy onto ``device``. Batches of
  mixed signatures raise ``ValueError``.
  """
  batches = [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches]
  if not batches:
    raise ValueError('an empty window')
  sig = signature(batches[0])
  for b in batches[1:]:
    if signature(b) != sig:
      raise ValueError(f'a window of mixed batch signatures: {sig} and '
                       f'{signature(b)}')
  device = torch.device(device)
  pinned = device.type == 'cuda'
  k = len(batches)
  entry = WINDOW_STACKS.get((sig, k, pinned))
  if entry is None:
    entry = WINDOW_STACKS[(sig, k, pinned)] = [{
        name: torch.empty((k, *t.shape), dtype=t.dtype, pin_memory=pinned)
        for name, t in batches[0].items()}, None]
  host, copied = entry
  if copied is not None:
    copied.synchronize()
  out = {}
  for name, stack in host.items():
    torch.stack([b[name] for b in batches], out=stack)
    out[name] = torch.empty_like(stack, device=device).copy_(
        stack, non_blocking=pinned)
  if pinned:
    entry[1] = torch.cuda.Event()
    entry[1].record()
  return out


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
