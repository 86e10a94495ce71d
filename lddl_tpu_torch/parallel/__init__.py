from .mesh import (MESH_AXES, batch_group, batch_pspec, batch_rank,
                   batch_rows, batch_size, canonical_batch_spec, fsdp_group,
                   local_batch, make_mesh, match_partition_rules,
                   mesh_summary, reduce_group, reshard_state, seq_group,
                   seq_rank, seq_shard, tensor_group)
from .ring import make_ring_attention, ring_attention
from .train import (AdamW, DataParallel, ScanTrainStep, ShardedDataParallel,
                    TrainStep, make_exchange, make_scan_train_step,
                    pretrain_loss, stack_batch_window, train_step)

__all__ = ['AdamW', 'DataParallel', 'MESH_AXES', 'ScanTrainStep',
           'ShardedDataParallel', 'TrainStep', 'batch_group', 'batch_pspec',
           'batch_rank', 'batch_rows', 'batch_size', 'canonical_batch_spec',
           'fsdp_group', 'local_batch', 'make_exchange', 'make_mesh',
           'make_ring_attention', 'make_scan_train_step',
           'match_partition_rules', 'mesh_summary', 'pretrain_loss',
           'reduce_group', 'reshard_state', 'ring_attention', 'seq_group',
           'seq_rank', 'seq_shard', 'stack_batch_window', 'tensor_group',
           'train_step']
