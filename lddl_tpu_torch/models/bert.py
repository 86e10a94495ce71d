"""BERT for pretraining (MLM + NSP) in PyTorch.

Counterpart of :mod:`lddl_tpu.models.bert`, module for module, consuming
the same loader batch dict. Where torch's defaults differ from flax's, this
module follows flax, so converted weights (:mod:`.convert`) give the same
logits:

  - post-LN layers (original BERT residual layout);
  - LayerNorm epsilon 1e-6 with float32 statistics and flax's fast
    variance, ``E[x^2] - E[x]^2`` clipped at 0;
  - tanh GELU;
  - an additive -1e9 key bias in dense attention;
  - the masked-only head gathers positions *before* the transform;
  - the MLM decoder is tied to ``word_embeddings`` with its own
    ``mlm_bias``;
  - parameters are float32 and compute runs in ``cfg.dtype`` (flax
    ``Dense``/``Embed`` with ``dtype=bf16``, ``param_dtype=f32``).

``nn.scan`` over layers becomes a ``ModuleList`` walked in a loop;
``remat`` becomes :func:`torch.utils.checkpoint.checkpoint`. Dropout draws
from a ``torch.Generator`` per layer, seeded from the step's dropout key,
so a step is a pure function of (state, batch, key) and a rematerialized
layer redraws the same masks.
"""

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


def _generator(seed, device):
  if seed is None:
    return None
  g = torch.Generator(device=device)
  g.manual_seed(seed)
  return g


def _dropout(x, rate, generator):
  """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
  values by 1 / (1 - rate). ``generator=None`` is deterministic mode."""
  if generator is None or rate == 0.0:
    return x
  keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - rate
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

  def forward(self, x, attention_mask, generator=None):
    cfg = self.cfg
    b, s, d = x.shape
    heads, hd = cfg.num_heads, cfg.head_dim
    if cfg.fused_qkv:
      q, k, v = self.qkv(x).split(d, dim=-1)
    else:
      q, k, v = self.query(x), self.key(x), self.value(x)
    q, k, v = (t.reshape(b, s, heads, hd).transpose(1, 2) for t in (q, k, v))
    if cfg.attention_impl in ('flash', 'ring_flash'):
      ctx = flash_attention(q, k, v, attention_mask)
    else:
      scale = 1.0 / hd ** 0.5
      scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
      zero = torch.zeros((), dtype=torch.float32, device=x.device)
      bias = torch.where(attention_mask, zero, NEG_INF)[:, None, None, :]
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

  def forward(self, x, attention_mask, seed=None):
    # One generator per layer call: a checkpointed layer recomputes its
    # forward from the same seed and so redraws the same dropout masks.
    gen = _generator(seed, x.device)
    x = self.attention_norm(
        x + self.attention(x, attention_mask, gen))
    h = F.gelu(self.intermediate(x), approximate='tanh')
    h = _dropout(self.output(h), self.cfg.dropout_rate, gen)
    return self.output_norm(x + h)


class Encoder(nn.Module):

  def __init__(self, cfg):
    super().__init__()
    self.cfg = cfg
    self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_layers))

  def forward(self, x, attention_mask, seeds):
    for layer, seed in zip(self.layers, seeds):
      if self.cfg.remat and torch.is_grad_enabled():
        x = checkpoint(layer, x, attention_mask, seed, use_reentrant=False)
      else:
        x = layer(x, attention_mask, seed)
    return x


def _site_seeds(dropout_key, n):
  """``n`` 64-bit seeds from a dropout key tuple, one per dropout site;
  all None in deterministic mode."""
  if dropout_key is None:
    return [None] * n
  return [int(np.random.SeedSequence([*dropout_key, i]).generate_state(
      1, np.uint64)[0]) for i in range(n)]


class BertForPretraining(nn.Module):
  """``forward`` returns (mlm_logits float32, nsp_logits [b, 2] float32).

  ``mesh`` is the JAX model's multi-chip argument; multi-GPU placement
  waits for a later slice, so only ``None`` is accepted. The JAX
  model's ``segment_ids`` (block-diagonal packed attention) waits for the
  packed slice.
  """

  def __init__(self, cfg, mesh=None):
    super().__init__()
    if mesh is not None:
      raise NotImplementedError('multi-GPU (mesh, ring attention) is not '
                                'ported yet; use mesh=None')
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

  def forward(self, input_ids, token_type_ids, attention_mask,
              dropout_key=None, mlm_positions=None):
    """``dropout_key=None`` is deterministic mode; otherwise a tuple of
    ints (the train step passes ``(seed + 1, step)``) from which every
    dropout site's generator is seeded.

    ``mlm_positions=None``: logits over every position, ``[b, s, V]``.
    ``mlm_positions`` int ``[b, P]``: the masked-only head, hidden states
    gathered at those positions before the transform, logits
    ``[b, P, V]``.
    """
    cfg = self.cfg
    s = input_ids.shape[1]
    seeds = _site_seeds(dropout_key, cfg.num_layers + 1)
    pos = torch.arange(s, device=input_ids.device)[None, :]
    x = (self.word_embeddings(input_ids) + self.position_embeddings(pos) +
         self.token_type_embeddings(token_type_ids))
    x = _dropout(self.embed_norm(x), cfg.dropout_rate,
                 _generator(seeds[0], x.device))
    x = self.encoder(x, attention_mask.bool(), seeds[1:])

    x_mlm = x
    if mlm_positions is not None:
      idx = mlm_positions.long()[:, :, None].expand(-1, -1, x.shape[-1])
      x_mlm = torch.gather(x, 1, idx)
    h = self.mlm_norm(F.gelu(self.mlm_transform(x_mlm), approximate='tanh'))
    mlm_logits = self.word_embeddings.attend(h).float() + self.mlm_bias
    pooled = torch.tanh(self.pooler(x[:, 0]))
    nsp_logits = self.nsp_classifier(pooled).float()
    return mlm_logits, nsp_logits
