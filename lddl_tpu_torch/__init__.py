"""lddl_tpu_torch: the PyTorch/CUDA port of lddl_tpu for one NVIDIA H100.

Same module names and layout as :mod:`lddl_tpu`, written in PyTorch, with
the TPU's Pallas kernels replaced by CUDA kernels written for Hopper
(``csrc/``). The package imports torch and numpy only, never jax or
anything of :mod:`lddl_tpu`. Entry points put tensors on ``cuda`` unless
the caller passes ``device='cpu'``.

Ported so far (the BERT pretraining step from the loader's batch boundary,
and packed long-context pretraining with block-diagonal attention):
``models.bert``, ``models.convert``, ``models.flops``,
``ops.flash_attention``, ``parallel.train``, ``loader.bert`` (masking),
``loader.packed`` (``PackedCollate``), ``loader.device``, ``core.utils``
(the np.save wire format), ``training.pretrain`` (with the step cache:
one CUDA graph per bin), and the train loop's hooks: ``telemetry``
(metrics, trace, roofline, profiler, sentinels), ``core.faults``,
``training.elastic`` (preemption, async checkpoints) and
``pipeline.pool`` (its background writer).
"""
