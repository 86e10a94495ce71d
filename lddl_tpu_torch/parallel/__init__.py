from .mesh import MESH_AXES, batch_rows, local_batch, make_mesh, mesh_summary
from .train import (AdamW, DataParallel, TrainStep, pretrain_loss,
                    train_step)

__all__ = ['AdamW', 'DataParallel', 'MESH_AXES', 'TrainStep', 'batch_rows',
           'local_batch', 'make_mesh', 'mesh_summary', 'pretrain_loss',
           'train_step']
