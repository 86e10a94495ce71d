"""flax param tree -> :class:`~lddl_tpu_torch.models.bert.BertForPretraining`
``state_dict``.

Takes the tree as nested dicts of numpy arrays (the caller fetches it from
the device, e.g. with ``jax.device_get``; nothing here imports jax):

  - ``nn.scan`` stacks every layer's params on a leading ``num_layers``
    axis under ``encoder/layers``; each slice becomes
    ``encoder.layers.<i>.*``;
  - Dense ``kernel`` ``[in, out]`` becomes ``weight`` ``[out, in]``;
  - LayerNorm ``scale`` and Embed ``embedding`` become ``weight``;
  - everything else (``bias``, ``mlm_bias``) keeps its name.

Covers the fused (``qkv``) and unfused (``query``/``key``/``value``) trees
alike, since it maps names generically.
"""

from collections.abc import Mapping

import numpy as np
import torch

_RENAME = {'kernel': 'weight', 'scale': 'weight', 'embedding': 'weight'}


def _leaf(path, arr, out):
  name = path[-1]
  if name == 'kernel':
    arr = arr.T
  key = '.'.join(path[:-1] + (_RENAME.get(name, name),))
  out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order='C'))


def flax_to_state_dict(params):
  """``state_dict`` for ``BertForPretraining.load_state_dict``."""
  out = {}

  def walk(tree, path):
    for name, val in tree.items():
      here = path + (str(name),)
      if isinstance(val, Mapping):
        walk(val, here)
      elif here[:2] == ('encoder', 'layers'):
        arr = np.asarray(val)
        for i in range(arr.shape[0]):
          _leaf(('encoder', 'layers', str(i)) + here[2:], arr[i], out)
      else:
        _leaf(here, np.asarray(val), out)

  walk(params, ())
  return out
