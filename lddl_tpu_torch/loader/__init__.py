from .bert import IGNORE_INDEX, dynamic_mask_tokens
from .device import prefetch_to_device

__all__ = ['IGNORE_INDEX', 'dynamic_mask_tokens', 'prefetch_to_device']
