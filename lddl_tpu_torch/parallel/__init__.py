from .train import AdamW, pretrain_loss, train_step

__all__ = ['AdamW', 'pretrain_loss', 'train_step']
