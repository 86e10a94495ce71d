from .mesh import (MESH_AXES, batch_group, batch_pspec, batch_rank,
                   batch_rows, batch_size, canonical_batch_spec, fsdp_group,
                   local_batch, make_mesh, match_partition_rules,
                   mesh_summary, reshard_state, tensor_group)
from .train import (AdamW, DataParallel, ScanTrainStep, ShardedDataParallel,
                    TrainStep, make_exchange, make_scan_train_step,
                    pretrain_loss, stack_batch_window, train_step)

__all__ = ['AdamW', 'DataParallel', 'MESH_AXES', 'ScanTrainStep',
           'ShardedDataParallel', 'TrainStep', 'batch_group', 'batch_pspec',
           'batch_rank', 'batch_rows', 'batch_size', 'canonical_batch_spec',
           'fsdp_group', 'local_batch', 'make_exchange', 'make_mesh',
           'make_scan_train_step', 'match_partition_rules', 'mesh_summary',
           'pretrain_loss', 'reshard_state', 'stack_batch_window',
           'tensor_group', 'train_step']
