from .bert import IGNORE_INDEX, dynamic_mask_tokens
from .device import prefetch_to_device
from .packed import PackedCollate

__all__ = ['IGNORE_INDEX', 'PackedCollate', 'dynamic_mask_tokens',
           'prefetch_to_device']
