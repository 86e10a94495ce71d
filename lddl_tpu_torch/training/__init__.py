from .pretrain import MODEL_SIZES, TrainLoop

__all__ = ['MODEL_SIZES', 'TrainLoop']
