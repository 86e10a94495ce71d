"""Analytic FLOP accounting and peak-throughput lookup for MFU reporting.

Copies of :mod:`lddl_tpu.models.flops`'s BERT FLOP counts (the port keeps
its own copy: that module imports jax), plus a peak table keyed on
``torch.cuda.get_device_name()``. ``LDDL_PEAK_TFLOPS`` and
``LDDL_PEAK_HBM_GBPS`` override the table, per device.
"""

import os

import torch

# Published dense peaks per card (NVIDIA data sheets, SXM parts, at the full
# power limit), keyed by a lowercase substring of the device name; first
# match wins.
_PEAK_TFLOPS_BF16 = (
    ('h100', 989.0),
)
_PEAK_HBM_GBPS = (
    ('h100', 3350.0),
)


def _lookup(table, env, scale, device_name):
  override = os.environ.get(env)
  if override:
    return float(override) * scale
  if device_name is None:
    if not torch.cuda.is_available():
      return None
    device_name = torch.cuda.get_device_name(0)
  name = device_name.lower()
  for key, peak in table:
    if key in name:
      return peak * scale
  return None


def peak_flops_per_device(device_name=None):
  """Peak bf16 FLOP/s of the card (default: CUDA device 0), or None when
  it is not in the table and ``LDDL_PEAK_TFLOPS`` is unset."""
  return _lookup(_PEAK_TFLOPS_BF16, 'LDDL_PEAK_TFLOPS', 1e12, device_name)


def peak_hbm_bytes_per_device(device_name=None):
  """Peak device-memory bandwidth (bytes/s), or None when unknown
  (override: ``LDDL_PEAK_HBM_GBPS``, in GB/s)."""
  return _lookup(_PEAK_HBM_GBPS, 'LDDL_PEAK_HBM_GBPS', 1e9, device_name)


def machine_balance(device_name=None):
  """The roofline ridge point of the card in FLOPs/byte (peak FLOP/s over
  peak memory bytes/s): work whose arithmetic intensity exceeds it is
  compute-bound, below it memory-bound. None when either peak is
  unknown."""
  flops = peak_flops_per_device(device_name)
  bw = peak_hbm_bytes_per_device(device_name)
  if not flops or not bw:
    return None
  return flops / bw


def bert_encoder_flops(cfg, batch, seq_len):
  """Forward matmul FLOPs of the encoder stack on a padded batch.

  Per layer: QKV+output projections 8·B·S·d², attention scores + context
  (QKᵀ and PV) 4·B·S²·d, MLP in+out 4·B·S·d·d_ff. A multiply-add counts
  as 2 FLOPs. Padded positions are counted — the device computes them.
  """
  b, s, d = batch, seq_len, cfg.hidden_size
  per_layer = (8 * b * s * d * d + 4 * b * s * s * d +
               4 * b * s * d * cfg.intermediate_size)
  return cfg.num_layers * per_layer


def bert_pretrain_flops_per_step(cfg, batch, seq_len, max_predictions=None):
  """Total matmul FLOPs of one pretraining train step (fwd + bwd).

  Head terms: MLM transform d², tied decoder d·V — over every position
  for the full head, or over ``max_predictions`` gathered positions for
  the masked-only head. Pooler+NSP ≈ 2·B·d². Backward pass costs 2×
  forward; optimizer update FLOPs are vector ops, negligible next to the
  matmuls.
  """
  b, s, d = batch, seq_len, cfg.hidden_size
  head_positions = s if max_predictions is None else min(max_predictions, s)
  fwd = bert_encoder_flops(cfg, batch, seq_len)
  fwd += 2 * b * head_positions * d * d               # MLM transform
  fwd += 2 * b * head_positions * d * cfg.vocab_size  # tied decoder
  fwd += 2 * b * d * d                        # pooler (NSP head is d x 2)
  return 3 * fwd
