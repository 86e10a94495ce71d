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
  # Profiling aid of the TPU benchmark (drop one component); only '' (the
  # real model) is ported.
  ablate: str = ''

  @property
  def head_dim(self):
    return self.hidden_size // self.num_heads


class Dense(nn.Module):
  """flax ``nn.Dense``: float32 params, compute in ``dtype``. ``weight``
  is ``[out, in]`` (torch layout; flax kernels are ``[in, out]``)."""

  def __init__(self, in_features, out_features, dtype):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(out_features, in_features))
    self.bias = nn.Parameter(torch.zeros(out_features))
    self.dtype = dtype

  def reset_parameters(self, generator):
    nn.init.normal_(self.weight, std=0.02, generator=generator)
    nn.init.zeros_(self.bias)

  def forward(self, x):
    return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                    self.bias.to(self.dtype))


class Embed(nn.Module):
  """flax ``nn.Embed``: float32 table, lookups in ``dtype``."""

  def __init__(self, num_embeddings, features, dtype, std):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(num_embeddings, features))
    self.dtype = dtype
    self.std = std

  def reset_parameters(self, generator):
    nn.init.normal_(self.weight, std=self.std, generator=generator)

  def forward(self, ids):
    # Gather-then-cast equals flax's cast-then-gather, element for element.
    return F.embedding(ids, self.weight).to(self.dtype)

  def attend(self, h):
    """Logits against the table (the tied MLM decoder)."""
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

  def __init__(self, cfg):
    super().__init__()
    self.cfg = cfg
    d = cfg.hidden_size
    if cfg.fused_qkv:
      self.qkv = Dense(d, 3 * d, cfg.dtype)
    else:
      self.query = Dense(d, d, cfg.dtype)
      self.key = Dense(d, d, cfg.dtype)
      self.value = Dense(d, d, cfg.dtype)
    self.out = Dense(d, d, cfg.dtype)

  def forward(self, x, attention_mask, generator=None, segment_ids=None):
    cfg = self.cfg
    b, s, d = x.shape
    heads, hd = cfg.num_heads, cfg.head_dim
    if cfg.fused_qkv:
      q, k, v = self.qkv(x).split(d, dim=-1)
    else:
      q, k, v = self.query(x), self.key(x), self.value(x)
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2) for t in (q, k, v))
    if cfg.attention_impl in ('flash', 'ring_flash'):
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
    ctx = ctx.transpose(1, 2).reshape(b, s, d)
    return _dropout(self.out(ctx), cfg.dropout_rate, generator)


class Layer(nn.Module):
  """Post-LN transformer block (original BERT residual layout)."""

  def __init__(self, cfg):
    super().__init__()
    self.cfg = cfg
    self.attention = SelfAttention(cfg)
    self.attention_norm = LayerNorm(cfg.hidden_size, cfg.dtype)
    self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size,
                              cfg.dtype)
    self.output = Dense(cfg.intermediate_size, cfg.hidden_size, cfg.dtype)
    self.output_norm = LayerNorm(cfg.hidden_size, cfg.dtype)

  def forward(self, x, attention_mask, generator=None, segment_ids=None):
    """``generator`` draws the attention output's mask, then the FFN
    output's; None is deterministic mode."""
    x = self.attention_norm(
        x + self.attention(x, attention_mask, generator, segment_ids))
    h = F.gelu(self.intermediate(x), approximate='tanh')
    h = _dropout(self.output(h), self.cfg.dropout_rate, generator)
    return self.output_norm(x + h)


class Encoder(nn.Module):

  def __init__(self, cfg):
    super().__init__()
    self.cfg = cfg
    self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_layers))

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


class BertForPretraining(nn.Module):
  """``forward`` returns (mlm_logits float32, nsp_logits [b, 2] float32).

  ``mesh`` is the JAX model's multi-chip argument: None, or a mesh
  (:func:`~lddl_tpu_torch.parallel.mesh.make_mesh`) whose only axis above
  1 is ``data``, where every rank holds the whole model and the train
  step reduces the gradients (:class:`~lddl_tpu_torch.parallel.train.
  DataParallel`). Parameter placement over ``fsdp``/``tensor`` and ring
  attention over ``seq`` raise :class:`NotImplementedError` (later
  slices).
  """

  def __init__(self, cfg, mesh=None):
    super().__init__()
    from ..parallel.mesh import check_mesh
    check_mesh(mesh)
    if cfg.attention_impl not in ('dense', 'flash', 'ring', 'ring_flash'):
      raise ValueError(f'unknown attention_impl {cfg.attention_impl!r}')
    if cfg.ablate:
      raise NotImplementedError(f'ablate={cfg.ablate!r} is not ported')
    self.cfg = cfg
    d = cfg.hidden_size
    self.word_embeddings = Embed(cfg.vocab_size, d, cfg.dtype, std=0.02)
    # flax's default embedding init: variance scaling 1.0, fan_in = d.
    self.position_embeddings = Embed(cfg.max_position_embeddings, d,
                                     cfg.dtype, std=1.0 / math.sqrt(d))
    self.token_type_embeddings = Embed(cfg.type_vocab_size, d, cfg.dtype,
                                       std=1.0 / math.sqrt(d))
    self.embed_norm = LayerNorm(d, cfg.dtype)
    self.encoder = Encoder(cfg)
    self.pooler = Dense(d, d, cfg.dtype)
    self.nsp_classifier = Dense(d, 2, cfg.dtype)
    self.mlm_transform = Dense(d, d, cfg.dtype)
    self.mlm_norm = LayerNorm(d, cfg.dtype)
    self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
    self._dropout_gens = None
    self.reset_parameters()

  def reset_parameters(self, generator=None):
    """flax's init distributions: normal(0.02) for Dense kernels and the
    word table, fan-in variance scaling for the position/type tables,
    zeros for biases, ones/zeros for LayerNorm. Draws in module order from
    ``generator`` (a CPU generator: the draw is the same on any device if
    the model is built on the CPU and moved after)."""
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
    """
    cfg = self.cfg
    s = input_ids.shape[1]
    gens = [None] * (2 * cfg.num_layers + 1)
    if dropout_key is SEEDED:
      if self._dropout_gens is None and cfg.dropout_rate > 0.0:
        raise ValueError('dropout_key=SEEDED before any seed_dropout()')
      gens = self.dropout_generators() or gens
    elif dropout_key is not None:
      gens = self.seed_dropout(dropout_key) or gens
    pos = torch.arange(s, device=input_ids.device)[None, :]
    x = (self.word_embeddings(input_ids) + self.position_embeddings(pos) +
         self.token_type_embeddings(token_type_ids))
    x = self.embed_norm(x)
    x = _dropout(x, cfg.dropout_rate, gens[0])
    layers = gens[1:cfg.num_layers + 1]
    twins = gens[cfg.num_layers + 1:] or [None] * cfg.num_layers
    x = self.encoder(x, attention_mask.bool(), layers, twins, segment_ids)

    x_mlm = x
    if mlm_positions is not None:
      idx = mlm_positions.long()[:, :, None].expand(-1, -1, x.shape[-1])
      x_mlm = torch.gather(x, 1, idx)
    h = self.mlm_norm(F.gelu(self.mlm_transform(x_mlm), approximate='tanh'))
    mlm_logits = self.word_embeddings.attend(h).float() + self.mlm_bias
    pooled = torch.tanh(self.pooler(x[:, 0]))
    nsp_logits = self.nsp_classifier(pooled).float()
    return mlm_logits, nsp_logits
