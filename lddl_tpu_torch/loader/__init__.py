"""Training-time data loaders: balanced-shard streaming with deterministic
shuffling, zero-communication binned iteration, dynamic or static MLM
masking, the packed long-context, CodeBERT and BART text-infilling
collates, worker-process collate over a shared-memory batch ring, and the
host-to-device feed.

The device feed (:func:`prefetch_to_device`, :func:`make_global_batch`,
:class:`SeqlenAwarePrefetcher`)
imports torch, so it loads lazily on first access, as the JAX package
keeps its device exports lazy: the loader's worker processes import this
package and never pay for torch. The data service (:class:`DataServer`,
:class:`NetworkBatchSource`, :func:`discover_data_servers`) loads lazily
too, as in the JAX package: only network-transport users pay for it.
"""
from .bart import BartCollate, get_bart_pretrain_data_loader
from .bert import (IGNORE_INDEX, dynamic_mask_tokens,
                   get_bert_pretrain_data_loader)
from .binned import BinnedIterator
from .codebert import CodebertCollate, get_codebert_pretrain_data_loader
from .dataset import ParquetShardDataset
from .packed import PackedCollate, get_packed_pretrain_data_loader
from .shuffle_buffer import ShuffleBuffer
from .workers import MultiprocessLoader

__all__ = ['IGNORE_INDEX', 'BartCollate', 'BinnedIterator', 'CodebertCollate',
           'DataServer', 'MultiprocessLoader', 'NetworkBatchSource',
           'PackedCollate', 'ParquetShardDataset', 'discover_data_servers',
           'SeqlenAwarePrefetcher', 'ShuffleBuffer', 'dynamic_mask_tokens',
           'get_bart_pretrain_data_loader', 'get_bert_pretrain_data_loader',
           'get_codebert_pretrain_data_loader',
           'get_packed_pretrain_data_loader', 'make_global_batch',
           'prefetch_to_device']

_DEVICE_EXPORTS = ('make_global_batch', 'prefetch_to_device',
                   'SeqlenAwarePrefetcher')
_SERVICE_EXPORTS = ('DataServer', 'NetworkBatchSource',
                    'discover_data_servers')


def __getattr__(name):
  if name in _DEVICE_EXPORTS:
    from . import device
    return getattr(device, name)
  if name in _SERVICE_EXPORTS:
    from . import service
    return getattr(service, name)
  raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
