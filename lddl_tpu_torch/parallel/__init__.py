from .mesh import MESH_AXES, batch_rows, local_batch, make_mesh, mesh_summary
from .train import (AdamW, DataParallel, ScanTrainStep, TrainStep,
                    make_scan_train_step, pretrain_loss, stack_batch_window,
                    train_step)

__all__ = ['AdamW', 'DataParallel', 'MESH_AXES', 'ScanTrainStep',
           'TrainStep', 'batch_rows', 'local_batch', 'make_mesh',
           'make_scan_train_step', 'mesh_summary', 'pretrain_loss',
           'stack_batch_window', 'train_step']
