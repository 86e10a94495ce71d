"""Training-time data loaders: balanced-shard streaming with deterministic
shuffling, zero-communication binned iteration, dynamic or static MLM
masking, the packed long-context collate, and the host-to-device feed."""
from .bert import (IGNORE_INDEX, dynamic_mask_tokens,
                   get_bert_pretrain_data_loader)
from .binned import BinnedIterator
from .dataset import ParquetShardDataset
from .device import prefetch_to_device
from .packed import PackedCollate, get_packed_pretrain_data_loader
from .shuffle_buffer import ShuffleBuffer

__all__ = ['IGNORE_INDEX', 'BinnedIterator', 'PackedCollate',
           'ParquetShardDataset', 'ShuffleBuffer', 'dynamic_mask_tokens',
           'get_bert_pretrain_data_loader', 'get_packed_pretrain_data_loader',
           'prefetch_to_device']
