"""Hand-written CUDA kernels of the port and their wrappers: flash
attention (:mod:`.flash_attention`) and MLM masking (:mod:`.masking`,
with its host backend :mod:`.masking_host`).

Its exports (``lddl_tpu.ops``'s masking names) load at first access: the
host backend imports no torch.
"""

_LAZY = {
    'assemble_pair_matrix': 'masking_host',
    'mask_batch': 'masking',
    'mask_batch_device': 'masking',
    'mask_batch_host': 'masking_host',
    'mask_partition_device': 'masking',
    'mask_partition_host': 'masking_host',
    'resolve_mask_backend': 'masking',
}


def __getattr__(name):
  module = _LAZY.get(name)
  if module is None:
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
  import importlib
  return getattr(importlib.import_module(f'.{module}', __name__), name)
