from .pretrain import (MODEL_SIZES, CompiledStepCache, TrainLoop,
                       export_telemetry)

__all__ = ['MODEL_SIZES', 'CompiledStepCache', 'TrainLoop',
           'export_telemetry']
