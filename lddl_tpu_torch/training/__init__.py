"""Training loop layer: :class:`~.pretrain.TrainLoop`, its step cache and
CLI, the elastic hooks (:mod:`.elastic`) and the flight recorder
(:mod:`.flight`, ``python -m lddl_tpu_torch.training.flight``)."""
from .pretrain import (MODEL_SIZES, CompiledStepCache, TrainLoop,
                       export_telemetry, main, state_fingerprint)

__all__ = ['MODEL_SIZES', 'CompiledStepCache', 'TrainLoop',
           'export_telemetry', 'main', 'state_fingerprint']
