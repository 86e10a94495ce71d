from .train import AdamW, TrainStep, pretrain_loss, train_step

__all__ = ['AdamW', 'TrainStep', 'pretrain_loss', 'train_step']
