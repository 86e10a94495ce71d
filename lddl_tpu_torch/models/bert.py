"""BERT for pretraining (MLM + NSP) in PyTorch.

Counterpart of :mod:`lddl_tpu.models.bert`, module for module, consuming
the same loader batch dict. Where torch's defaults differ from flax's, this
module follows flax, so converted weights (:mod:`.convert`) give the same
logits:

  - post-LN layers (original BERT residual layout);
  - LayerNorm epsilon 1e-6 with float32 statistics and flax's fast
    variance, ``E[x^2] - E[x]^2`` clipped at 0;
  - tanh GELU;
  - an additive -1e9 key bias in dense attention, plus a -1e9
    cross-document bias when the batch carries ``segment_ids``;
  - the masked-only head gathers positions *before* the transform;
  - the MLM decoder is tied to ``word_embeddings`` with its own
    ``mlm_bias``;
  - parameters are float32 and compute runs in ``cfg.dtype`` (flax
    ``Dense``/``Embed`` with ``dtype=bf16``, ``param_dtype=f32``).

``nn.scan`` over layers becomes a ``ModuleList`` walked in a loop;
``remat`` becomes :func:`torch.utils.checkpoint.checkpoint`.

Dropout draws from one ``torch.Generator`` per site (the embeddings, then
one per layer), reseeded every step from the step's dropout key, so a
step is a pure function of (state, batch, key). The generators live as
long as the model: a CUDA graph of the step registers them and draws from
whatever seed they hold at replay, so reseeding before a replay draws the
masks an eager step draws. With ``remat`` each layer also has a twin
generator, reseeded with the layer's seed: the checkpointed forward draws
from the layer's generator and the recompute from its twin, so the
recompute redraws the forward's masks without saving them or reading a
generator's state (which a capture could not do).
"""

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import NEG_INF, flash_attention


# BertConfig.ablate's values.
ABLATIONS = ('', 'attention-core', 'ffn', 'norms', 'gelu')


@dataclasses.dataclass(frozen=True)
class BertConfig:
  vocab_size: int = 30528  # 30522 padded up to a multiple of 64
  hidden_size: int = 768
  num_layers: int = 12
  num_heads: int = 12
  intermediate_size: int = 3072
  max_position_embeddings: int = 512
  type_vocab_size: int = 2
  dropout_rate: float = 0.1
  dtype: torch.dtype = torch.bfloat16
  attention_impl: str = 'dense'  # 'dense' | 'flash' | 'ring' | 'ring_flash'
  remat: bool = False
  # One [d, 3d] projection instead of three [d, d] ones (changes the param
  # tree, so checkpoints are not interchangeable with the unfused layout).
  fused_qkv: bool = False
  # Profiling aid: drop one component from every layer to attribute step
  # time. '' (default) = the real model; 'attention-core' (ctx := v, no
  # q/k projection and no attention), 'ffn' (return after
  # attention_norm), 'norms' (no attention_norm, output_norm), 'gelu' (no
  # GELU). Never set in training configs.
  ablate: str = ''

  @property
  def head_dim(self):
    return self.hidden_size // self.num_heads


class TensorParallel:
  """A rank's place in its ``tensor`` group: the group, its size and the
  rank's index in it. The model holds one when the mesh's ``tensor`` axis
  is above 1, and None otherwise (every module then runs its world-1
  form, bit for bit)."""

  def __init__(self, mesh):
    from ..parallel.mesh import axis_rank, axis_size, tensor_group
    self.group = tensor_group(mesh)
    self.size = axis_size(mesh, 'tensor')
    self.rank = axis_rank(mesh, 'tensor')

  def split(self, n, what):
    if n % self.size:
      raise ValueError(f'{what} {n} does not divide by tensor={self.size}')
    return n // self.size


class SequenceParallel:
  """A rank's place in its ``seq`` group: the group, its size and the
  rank's index in it (which ``1 / seq`` of every row it holds). The model
  holds one when the mesh's ``seq`` axis is above 1, and None
  otherwise."""

  def __init__(self, mesh):
    from ..parallel.mesh import seq_group, seq_rank, seq_size
    self.group = seq_group(mesh)
    self.size = seq_size(mesh)
    self.rank = seq_rank(mesh)


def gather_columns(t, sp):
  """The whole rows of ``t`` (``[b, s / seq, ...]``, this rank's columns)
  from every rank of the seq group, in rank order: ``[b, s, ...]``. No
  gradient."""
  from ..parallel.mesh import stack_over
  parts = stack_over(t.detach(), sp.group)
  return torch.cat(parts.unbind(0), dim=1)


class _GatherSeq(torch.autograd.Function):
  """The encoder's output gathered over the seq group (:func:`
  gather_columns`); the backward sums the whole rows' cotangents over the
  group in float32 and keeps this rank's columns (a reduce-scatter), so
  each rank's columns get the sum of every rank's heads' cotangent."""

  @staticmethod
  def forward(ctx, x, sp):
    ctx.sp = sp
    return gather_columns(x, sp)

  @staticmethod
  def backward(ctx, g):
    sp = ctx.sp
    per = g.shape[1] // sp.size
    whole = _sum_over(g, sp.group)
    return whole[:, sp.rank * per:(sp.rank + 1) * per].contiguous(), None


def gather_seq(x, sp):
  return x if sp is None else _GatherSeq.apply(x, sp)


def _sum_over(x, group):
  """``x`` summed over ``group``'s ranks, reduced in float32 (a bf16
  activation is widened for the sum and rounded once after)."""
  import torch.distributed as dist
  y = x.float().clone()
  dist.all_reduce(y, group=group)
  return y.to(x.dtype)


class _CopyToTensor(torch.autograd.Function):
  """Megatron's ``f``: identity forward; the backward sums the
  cotangent over the tensor group. It enters a tensor-parallel region
  whose input every rank holds whole (each rank's branch adds its part
  of the input's gradient)."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return _sum_over(g, ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
  """Megatron's ``g``: the forward sums the ranks' partial results over
  the tensor group; identity backward (the sum is whole on every rank,
  and so is its cotangent)."""

  @staticmethod
  def forward(ctx, x, group):
    return _sum_over(x, group)

  @staticmethod
  def backward(ctx, g):
    return g, None


class _ZeroGrads(torch.autograd.Function):
  """Identity on ``x`` whose backward gives each of ``params`` a zero
  gradient: parameters the forward does not read (the q and k
  projections under ``ablate='attention-core'``) still get a gradient
  tensor, as a flax parameter the program never reads gets zeros, so the
  norm, the exchange and AdamW's decay see every parameter."""

  @staticmethod
  def forward(ctx, x, *params):
    ctx.params = params
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):
    return (g, *(torch.zeros_like(p) for p in ctx.params))


def copy_to_tensor(x, tp):
  return x if tp is None else _CopyToTensor.apply(x, tp.group)


def reduce_from_tensor(x, tp):
  return x if tp is None else _ReduceFromTensor.apply(x, tp.group)


class Dense(nn.Module):
  """flax ``nn.Dense``: float32 params, compute in ``dtype``. ``weight``
  is ``[out, in]`` (torch layout; flax kernels are ``[in, out]``).

  Tensor-parallel forms (``tp``, a :class:`TensorParallel`):
  ``'column'`` keeps the rank's ``out / tensor`` outputs (weight rows and
  bias), on an input every rank holds whole (the caller enters the region
  with :func:`copy_to_tensor`); ``'row'`` takes the rank's ``in / tensor``
  inputs, sums the partial products over the group and adds the whole
  bias once, after the sum.
  """

  def __init__(self, in_features, out_features, dtype, tp=None,
               parallel=None):
    super().__init__()
    self.tp = tp if parallel else None
    self.parallel = parallel
    if self.tp is not None and parallel == 'column':
      out_features = self.tp.split(out_features, 'out features')
    elif self.tp is not None:
      in_features = self.tp.split(in_features, 'in features')
    self.weight = nn.Parameter(torch.empty(out_features, in_features))
    self.bias = nn.Parameter(torch.zeros(out_features))
    self.dtype = dtype

  def reset_parameters(self, generator):
    nn.init.normal_(self.weight, std=0.02, generator=generator)
    nn.init.zeros_(self.bias)

  def forward(self, x):
    if self.tp is not None and self.parallel == 'row':
      y = reduce_from_tensor(
          F.linear(x.to(self.dtype), self.weight.to(self.dtype)), self.tp)
      return y + self.bias.to(self.dtype)
    return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                    self.bias.to(self.dtype))


class Embed(nn.Module):
  """flax ``nn.Embed``: float32 table, lookups in ``dtype``.

  Vocab-parallel with ``tp``: the rank holds rows ``[rank * V / tensor,
  (rank + 1) * V / tensor)``, looks up the ids that fall there (zeros
  elsewhere) and sums the lookups over the group, which adds one real row
  to zeros and equals the whole table's lookup bit for bit; ``attend``
  then gives the rank's slice of the logits."""

  def __init__(self, num_embeddings, features, dtype, std, tp=None):
    super().__init__()
    self.tp = tp
    self.offset = 0
    if tp is not None:
      num_embeddings = tp.split(num_embeddings, 'vocab_size')
      self.offset = tp.rank * num_embeddings
    self.weight = nn.Parameter(torch.empty(num_embeddings, features))
    self.dtype = dtype
    self.std = std

  def reset_parameters(self, generator):
    nn.init.normal_(self.weight, std=self.std, generator=generator)

  def forward(self, ids):
    if self.tp is None:
      # Gather-then-cast equals flax's cast-then-gather, element for
      # element.
      return F.embedding(ids, self.weight).to(self.dtype)
    local = ids.long() - self.offset
    mine = (local >= 0) & (local < self.weight.shape[0])
    rows = F.embedding(torch.where(mine, local, 0), self.weight)
    rows = torch.where(mine[..., None], rows, 0.0)
    return reduce_from_tensor(rows, self.tp).to(self.dtype)

  def attend(self, h):
    """Logits against the table (the tied MLM decoder); with ``tp`` the
    rank's ``V / tensor`` columns of them."""
    h = copy_to_tensor(h, self.tp)
    return F.linear(h.to(self.dtype), self.weight.to(self.dtype))


class LayerNorm(nn.Module):
  """flax ``nn.LayerNorm``: eps 1e-6, float32 statistics, fast variance
  clipped at 0, output in ``dtype``."""

  def __init__(self, features, dtype, eps=1e-6):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(features))
    self.bias = nn.Parameter(torch.zeros(features))
    self.dtype = dtype
    self.eps = eps

  def reset_parameters(self, generator):
    del generator
    nn.init.ones_(self.weight)
    nn.init.zeros_(self.bias)

  def forward(self, x):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
    return y.to(self.dtype)


# ``dropout_key`` value that draws from the generators as the last
# :meth:`BertForPretraining.seed_dropout` left them (a captured step).
SEEDED = 'seeded'


def _keep_mask(shape, rate, generator, device):
  """flax ``nn.Dropout``'s keep bitmap: keep with probability 1 - rate."""
  return torch.rand(shape, generator=generator, device=device) < 1 - rate


def _dropout(x, rate, generator):
  """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
  values by 1 / (1 - rate). ``generator=None`` is deterministic mode."""
  if generator is None or rate == 0.0:
    return x
  keep = _keep_mask(x.shape, rate, generator, x.device)
  return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class SelfAttention(nn.Module):
  """With ``tp`` the q/k/v projections are column-parallel and ``out`` is
  row-parallel, so the rank attends over its ``num_heads / tensor``
  heads; a fused ``qkv`` rank holds its heads of q, of k and of v, in
  that order (``param_blocks``).

  ``attention_impl`` 'ring' or 'ring_flash' with a ``mesh`` runs ring
  attention over the mesh's ``seq`` group on the rank's heads and its
  ``1 / seq`` of the rows (:func:`~lddl_tpu_torch.parallel.ring.
  make_ring_attention`; dense or flash blocks), at ``seq`` 1 too (one
  block, then the merge), as the JAX model does. Without a mesh
  'ring_flash' is 'flash' and 'ring' is 'dense'.

  ``ablate='attention-core'`` takes ``ctx := v`` ahead of every
  attention branch. XLA drops the q and k projections the reference
  then never reads; torch runs what it is given, so here they are never
  computed (a fused rank projects its v rows alone), no attention kernel
  launches and no ring rotates, and their parameters get zero gradients
  (:class:`_ZeroGrads`)."""

  def __init__(self, cfg, tp=None, mesh=None):
    super().__init__()
    self.cfg = cfg
    self.tp = tp
    self.mesh = mesh
    d = cfg.hidden_size
    self.heads = cfg.num_heads if tp is None else tp.split(cfg.num_heads,
                                                           'num_heads')
    if cfg.fused_qkv:
      self.qkv = Dense(d, 3 * d, cfg.dtype, tp, 'column')
    else:
      self.query = Dense(d, d, cfg.dtype, tp, 'column')
      self.key = Dense(d, d, cfg.dtype, tp, 'column')
      self.value = Dense(d, d, cfg.dtype, tp, 'column')
    self.out = Dense(d, d, cfg.dtype, tp, 'row')

  def forward(self, x, attention_mask, generator=None, segment_ids=None):
    cfg = self.cfg
    b, s, _ = x.shape
    heads, hd = self.heads, cfg.head_dim
    width = heads * hd
    x_in = copy_to_tensor(x, self.tp)
    if cfg.ablate == 'attention-core':
      if cfg.fused_qkv:
        # The rank's block is its heads of q, of k and of v: v is the last
        # third. The slice's backward gives the q and k rows zeros.
        w, bias = self.qkv.weight[2 * width:], self.qkv.bias[2 * width:]
        ctx = F.linear(x_in.to(cfg.dtype), w.to(cfg.dtype),
                       bias.to(cfg.dtype))
      else:
        ctx = _ZeroGrads.apply(self.value(x_in), self.query.weight,
                               self.query.bias, self.key.weight,
                               self.key.bias)
      return _dropout(self.out(ctx), cfg.dropout_rate, generator)
    if cfg.fused_qkv:
      q, k, v = self.qkv(x_in).split(width, dim=-1)
    else:
      q, k, v = self.query(x_in), self.key(x_in), self.value(x_in)
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2) for t in (q, k, v))
    if cfg.attention_impl in ('ring', 'ring_flash') and self.mesh is not None:
      from ..parallel.ring import make_ring_attention
      attend = make_ring_attention(
          self.mesh, 'flash' if cfg.attention_impl == 'ring_flash' else
          'dense', with_segment_ids=segment_ids is not None)
      ctx = attend(q, k, v, attention_mask,
                   *(() if segment_ids is None else (segment_ids,)))
    elif cfg.attention_impl in ('flash', 'ring_flash'):
      ctx = flash_attention(q, k, v, attention_mask, segment_ids,
                            segment_ids)
    else:
      scale = 1.0 / hd ** 0.5
      scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
      zero = torch.zeros((), dtype=torch.float32, device=x.device)
      bias = torch.where(attention_mask, zero, NEG_INF)[:, None, None, :]
      if segment_ids is not None:
        # The flash kernels' block-diagonal semantics as an additive bias.
        same_doc = (segment_ids[:, None, :, None] ==
                    segment_ids[:, None, None, :])
        bias = bias + torch.where(same_doc, zero, NEG_INF)
      probs = torch.softmax(scores + bias, dim=-1)
      ctx = torch.matmul(probs.to(cfg.dtype), v)
    ctx = ctx.transpose(1, 2).reshape(b, s, width)
    return _dropout(self.out(ctx), cfg.dropout_rate, generator)


class Layer(nn.Module):
  """Post-LN transformer block (original BERT residual layout)."""

  def __init__(self, cfg, tp=None, mesh=None):
    super().__init__()
    self.cfg = cfg
    self.tp = tp
    self.attention = SelfAttention(cfg, tp, mesh)
    # Under 'norms' and 'ffn' the dropped modules are not built: flax's
    # nn.compact never creates their parameters either.
    norms = cfg.ablate != 'norms'
    if norms:
      self.attention_norm = LayerNorm(cfg.hidden_size, cfg.dtype)
    if cfg.ablate != 'ffn':
      self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size,
                                cfg.dtype, tp, 'column')
      self.output = Dense(cfg.intermediate_size, cfg.hidden_size,
                          cfg.dtype, tp, 'row')
      if norms:
        self.output_norm = LayerNorm(cfg.hidden_size, cfg.dtype)

  def forward(self, x, attention_mask, generator=None, segment_ids=None):
    """``generator`` draws the attention output's mask, then the FFN
    output's; None is deterministic mode."""
    ablate = self.cfg.ablate
    x = x + self.attention(x, attention_mask, generator, segment_ids)
    if ablate != 'norms':
      x = self.attention_norm(x)
    if ablate == 'ffn':
      return x
    h = self.intermediate(copy_to_tensor(x, self.tp))
    if ablate != 'gelu':
      h = F.gelu(h, approximate='tanh')
    h = _dropout(self.output(h), self.cfg.dropout_rate, generator)
    x = x + h
    return x if ablate == 'norms' else self.output_norm(x)


class Encoder(nn.Module):

  def __init__(self, cfg, tp=None, mesh=None):
    super().__init__()
    self.cfg = cfg
    self.layers = nn.ModuleList(Layer(cfg, tp, mesh)
                                for _ in range(cfg.num_layers))

  def forward(self, x, attention_mask, generators, twins, segment_ids=None):
    """``generators``: one per layer (None in deterministic mode);
    ``twins``: the layers' recompute generators under remat."""
    for layer, gen, twin in zip(self.layers, generators, twins):
      if self.cfg.remat and torch.is_grad_enabled():
        # The forward draws from the layer's generator, the recompute from
        # its twin, seeded alike: the same masks. The layer's own
        # generators are the only RNG it reads, so no global RNG state is
        # saved (reading it would also break a capture).
        draw = iter((gen, twin))
        x = checkpoint(lambda h, m, seg, layer=layer, draw=draw:
                       layer(h, m, next(draw), seg),
                       x, attention_mask, segment_ids, use_reentrant=False,
                       preserve_rng_state=False)
      else:
        x = layer(x, attention_mask, gen, segment_ids)
    return x


def _site_seeds(dropout_key, n):
  """``n`` 64-bit seeds from a dropout key tuple, one per dropout site."""
  return [int(np.random.SeedSequence([*dropout_key, i]).generate_state(
      1, np.uint64)[0]) for i in range(n)]


# --- Tensor/FSDP parameter placement (Megatron pattern) ---

# lddl_tpu.models.bert._RULES under this model's state_dict names. A Dense
# weight is the flax kernel transposed ([out, in]), so its spec is the
# kernel's reversed: ('fsdp', 'tensor') on query/kernel, the output dim
# over tensor, is ('tensor', 'fsdp') here (a column-parallel weight);
# ('tensor', 'fsdp') on out/kernel and output/kernel is ('fsdp', 'tensor')
# (row-parallel). Embedding tables and biases keep their layout. A name no
# rule matches is replicated: the LayerNorms, the position and type
# tables, the pooler, the NSP head, mlm_transform and the row-parallel
# biases.
_RULES = (
    ('word_embeddings.weight', ('tensor', 'fsdp')),
    ('position_embeddings.weight', (None, None)),
    ('token_type_embeddings.weight', (None, None)),
    ('qkv.weight', ('tensor', 'fsdp')),
    ('qkv.bias', ('tensor',)),
    ('query.weight', ('tensor', 'fsdp')),
    ('key.weight', ('tensor', 'fsdp')),
    ('value.weight', ('tensor', 'fsdp')),
    ('query.bias', ('tensor',)),
    ('key.bias', ('tensor',)),
    ('value.bias', ('tensor',)),
    ('attention.out.weight', ('fsdp', 'tensor')),
    ('intermediate.weight', ('tensor', 'fsdp')),
    ('intermediate.bias', ('tensor',)),
    ('output.weight', ('fsdp', 'tensor')),
    ('mlm_bias', ('tensor',)),
)


def spec_for_param(name, shape):
  """The spec of one parameter by its ``state_dict`` name, as
  :func:`lddl_tpu.models.spec_for_param` by its flax path: the first rule
  that ends the parameter's name (or follows a dot inside it) wins,
  left-padded with None to the parameter's rank; replicated when none
  does."""
  for suffix, spec in _RULES:
    if name.endswith(suffix) or f'.{suffix}' in name:
      pad = (None,) * (len(shape) - len(spec))
      return pad + tuple(spec)
  return (None,) * len(shape)


def param_blocks(name):
  """How many blocks a parameter's ``tensor`` dim cuts separately: 3 for
  the fused q/k/v projection (each rank keeps its heads of q, k and v, as
  ``jnp.split`` of the sharded kernel computes under GSPMD), else 1."""
  return 3 if name.endswith(('qkv.weight', 'qkv.bias')) else 1


class BertForPretraining(nn.Module):
  """``forward`` returns (mlm_logits float32, nsp_logits [b, 2] float32).

  ``mesh`` is the JAX model's multi-chip argument: None, or a mesh
  (:func:`~lddl_tpu_torch.parallel.mesh.make_mesh`). With ``tensor``
  above 1 the rank holds its shards by :data:`_RULES`
  (:meth:`placement`): column-parallel q/k/v (or fused qkv) and
  ``intermediate``, row-parallel ``out`` and ``output``, a vocab-parallel
  word table whose tied decoder gives the rank's ``V / tensor`` columns of
  the MLM logits (``mlm_bias`` is cut with them), and attention over the
  rank's ``num_heads / tensor`` heads; everything else is replicated. The
  ``data`` and ``fsdp`` axes are the train step's
  (:class:`~lddl_tpu_torch.parallel.train.DataParallel`,
  :class:`~lddl_tpu_torch.parallel.train.ShardedDataParallel`). With
  ``seq`` above 1 (``attention_impl`` 'ring' or 'ring_flash'; any other
  raises ``ValueError``) the rank holds ``1 / seq`` of each of its rows
  (:class:`SequenceParallel`): the embeddings take the row's global
  positions, the layers run on the rank's columns with ring attention
  over the seq group, and the encoder's output is gathered over the
  group (:func:`gather_seq`), so the heads read whole rows on every seq
  rank: the masked-only head gathers global ``mlm_positions``, the pooler
  row ``[CLS]`` at position 0, and every seq rank returns the same
  logits. ``num_heads``, ``intermediate_size`` or ``vocab_size`` that
  ``tensor`` does not divide raise ``ValueError``.

  ``generator``: the CPU generator the initial parameters are drawn from
  (:meth:`reset_parameters`); None draws from torch's global one.
  """

  def __init__(self, cfg, mesh=None, generator=None):
    super().__init__()
    from ..parallel.mesh import axis_size, check_mesh
    check_mesh(mesh)
    if cfg.attention_impl not in ('dense', 'flash', 'ring', 'ring_flash'):
      raise ValueError(f'unknown attention_impl {cfg.attention_impl!r}')
    if cfg.ablate not in ABLATIONS:
      raise ValueError(f'unknown ablate {cfg.ablate!r}; one of '
                       f'{ABLATIONS}')
    if axis_size(mesh, 'seq') > 1 and cfg.attention_impl not in (
        'ring', 'ring_flash'):
      raise ValueError(
          f"attention_impl={cfg.attention_impl!r} on a mesh with seq="
          f"{axis_size(mesh, 'seq')}: the seq axis runs ring attention "
          "('ring' or 'ring_flash')")
    self.cfg = cfg
    self.mesh = mesh
    self.sp = SequenceParallel(mesh) if axis_size(mesh, 'seq') > 1 else None
    tp = TensorParallel(mesh) if axis_size(mesh, 'tensor') > 1 else None
    if tp is not None:
      for n, what in ((cfg.num_heads, 'num_heads'),
                      (cfg.intermediate_size, 'intermediate_size'),
                      (cfg.vocab_size, 'vocab_size')):
        tp.split(n, what)
    self.tp = tp
    d = cfg.hidden_size
    self.word_embeddings = Embed(cfg.vocab_size, d, cfg.dtype, std=0.02,
                                 tp=tp)
    # flax's default embedding init: variance scaling 1.0, fan_in = d.
    self.position_embeddings = Embed(cfg.max_position_embeddings, d,
                                     cfg.dtype, std=1.0 / math.sqrt(d))
    self.token_type_embeddings = Embed(cfg.type_vocab_size, d, cfg.dtype,
                                       std=1.0 / math.sqrt(d))
    self.embed_norm = LayerNorm(d, cfg.dtype)
    self.encoder = Encoder(cfg, tp, mesh)
    self.pooler = Dense(d, d, cfg.dtype)
    self.nsp_classifier = Dense(d, 2, cfg.dtype)
    self.mlm_transform = Dense(d, d, cfg.dtype)
    self.mlm_norm = LayerNorm(d, cfg.dtype)
    self.mlm_bias = nn.Parameter(torch.zeros(
        cfg.vocab_size if tp is None else tp.split(cfg.vocab_size,
                                                   'vocab_size')))
    self._dropout_gens = None
    self.reset_parameters(generator)

  def placement(self):
    """``{state_dict name: spec}`` of every parameter
    (:func:`spec_for_param`)."""
    return {name: spec_for_param(name, p.shape)
            for name, p in self.named_parameters()}

  param_blocks = staticmethod(param_blocks)

  def tensor_sharded(self):
    """Per parameter, in ``parameters()`` order: whether the rank holds a
    ``tensor`` shard of it (always False without tensor parallelism)."""
    from ..parallel.mesh import _axes
    specs = self.placement()
    return [self.tp is not None and any('tensor' in _axes(e)
                                        for e in specs[name])
            for name, _ in self.named_parameters()]

  def load_whole_state_dict(self, state):
    """Copy a whole (world 1's) ``state_dict`` into this rank's shards of
    it (:func:`~lddl_tpu_torch.parallel.mesh.reshard_state`)."""
    from ..parallel.mesh import reshard_state
    if self.tp is not None:
      state = reshard_state(state, self.mesh, like=self)
    self.load_state_dict(state)

  def whole(self, name, t):
    """The whole tensor of this rank's shard ``t`` of parameter ``name``
    (or of a tensor shaped like it, e.g. AdamW's moment), gathered over
    the tensor group: every rank of the group must call it. Without a
    tensor cut, ``t`` itself."""
    from ..parallel.mesh import _axes, stack_over, unshard
    spec = spec_for_param(name, t.shape)
    if self.tp is None or not any('tensor' in _axes(e) for e in spec):
      return t
    return unshard(stack_over(t.detach(), self.tp.group), spec,
                   param_blocks(name))

  def reset_parameters(self, generator=None):
    """flax's init distributions: normal(0.02) for Dense kernels and the
    word table, fan-in variance scaling for the position/type tables,
    zeros for biases, ones/zeros for LayerNorm. Draws in module order from
    ``generator`` (a CPU generator: the draw is the same on any device if
    the model is built on the CPU and moved after). With tensor
    parallelism the whole model is drawn on the CPU and the rank keeps
    its shards, so every layout starts from world 1's parameters."""
    if self.tp is not None:
      whole = BertForPretraining(self.cfg, generator=generator)
      with torch.no_grad():
        self.load_whole_state_dict(whole.state_dict())
      return
    for module in self.modules():
      if isinstance(module, (Dense, Embed, LayerNorm)):
        module.reset_parameters(generator)
    nn.init.zeros_(self.mlm_bias)

  def dropout_generators(self):
    """The dropout generators on the parameters' device, made at first use
    and kept for the model's life: one per site (the embeddings', then one
    per layer), then with ``remat`` the layers' twins; [] when dropout is
    off."""
    if self.cfg.dropout_rate == 0.0:
      return []
    device = self.word_embeddings.weight.device
    if self._dropout_gens is None or self._dropout_gens[0].device != device:
      self._dropout_gens = self.new_dropout_generators()
    return self._dropout_gens

  def new_dropout_generators(self):
    """A fresh set of generators shaped like :meth:`dropout_generators`'
    (unseeded), for :meth:`drawing_from`."""
    if self.cfg.dropout_rate == 0.0:
      return []
    device = self.word_embeddings.weight.device
    n = self.cfg.num_layers * (2 if self.cfg.remat else 1) + 1
    return [torch.Generator(device=device) for _ in range(n)]

  @contextlib.contextmanager
  def drawing_from(self, gens):
    """Inside, ``gens`` (from :meth:`new_dropout_generators`) is the
    model's generator set: :meth:`seed_dropout` seeds it and a
    :data:`SEEDED` forward draws from it. A scan window gives each of its
    steps a set of its own, since no host reseed runs between the steps
    of one CUDA graph."""
    saved = self._dropout_gens
    self._dropout_gens = gens or saved
    try:
      yield
    finally:
      self._dropout_gens = saved

  def seed_dropout(self, dropout_key):
    """Reseed every generator from ``dropout_key`` (a tuple of ints), a
    layer's twin with the layer's seed: host work, done before a step and
    never inside a CUDA graph. Returns the generators."""
    gens = self.dropout_generators()
    seeds = _site_seeds(dropout_key, self.cfg.num_layers + 1)
    for gen, seed in zip(gens, seeds + seeds[1:]):
      gen.manual_seed(seed)
    return gens

  def forward(self, input_ids, token_type_ids, attention_mask,
              dropout_key=None, mlm_positions=None, segment_ids=None):
    """``dropout_key=None`` is deterministic mode; a tuple of ints (the
    train step passes ``(seed + 1, step)``) reseeds every dropout site's
    generator from it (:meth:`seed_dropout`) and draws; :data:`SEEDED`
    draws from the generators as the last :meth:`seed_dropout` left them,
    which is what a captured step does.

    ``mlm_positions=None``: logits over every position, ``[b, s, V]``.
    ``mlm_positions`` int ``[b, P]``: the masked-only head, hidden states
    gathered at those positions before the transform, logits
    ``[b, P, V]``.

    ``segment_ids`` int ``[b, s]`` (doc index per token, -1 = padding, the
    packed loader's ``block_diagonal`` key) restricts attention to
    same-document pairs: the segmented flash kernels, or an additive bias
    in dense attention.

    With ``seq`` above 1 the row inputs are the rank's columns ``[b, s /
    seq]`` while ``mlm_positions`` index the whole row, and the logits
    are the whole rows'.
    """
    cfg = self.cfg
    s = input_ids.shape[1]
    first = 0 if self.sp is None else self.sp.rank * s
    gens = [None] * (2 * cfg.num_layers + 1)
    if dropout_key is SEEDED:
      if self._dropout_gens is None and cfg.dropout_rate > 0.0:
        raise ValueError('dropout_key=SEEDED before any seed_dropout()')
      gens = self.dropout_generators() or gens
    elif dropout_key is not None:
      gens = self.seed_dropout(dropout_key) or gens
    pos = torch.arange(first, first + s, device=input_ids.device)[None, :]
    x = (self.word_embeddings(input_ids) + self.position_embeddings(pos) +
         self.token_type_embeddings(token_type_ids))
    x = self.embed_norm(x)
    x = _dropout(x, cfg.dropout_rate, gens[0])
    layers = gens[1:cfg.num_layers + 1]
    twins = gens[cfg.num_layers + 1:] or [None] * cfg.num_layers
    x = self.encoder(x, attention_mask.bool(), layers, twins, segment_ids)
    x = gather_seq(x, self.sp)

    x_mlm = x
    if mlm_positions is not None:
      idx = mlm_positions.long()[:, :, None].expand(-1, -1, x.shape[-1])
      x_mlm = torch.gather(x, 1, idx)
    h = self.mlm_norm(F.gelu(self.mlm_transform(x_mlm), approximate='tanh'))
    mlm_logits = self.word_embeddings.attend(h).float() + self.mlm_bias
    pooled = torch.tanh(self.pooler(x[:, 0]))
    nsp_logits = self.nsp_classifier(pooled).float()
    return mlm_logits, nsp_logits
