"""lddl_tpu_torch: the PyTorch/CUDA port of lddl_tpu for one NVIDIA H100.

Same module names and layout as :mod:`lddl_tpu`, written in PyTorch, with
the TPU's Pallas kernels replaced by CUDA kernels written for Hopper
(``csrc/``). The package imports torch, numpy and the stdlib only: never
jax, anything of :mod:`lddl_tpu`, pyarrow or transformers. Entry points
put tensors on ``cuda`` unless the caller passes ``device='cpu'``.

Ported so far: BERT pretraining on one card from balanced Parquet shards
(written by :mod:`lddl_tpu` or by the port itself), segment-free and packed long-context with
block-diagonal attention. The corpus loader: ``pipeline.parquet_io`` (a
Parquet reader in numpy, no pyarrow) with ``pipeline.codecs`` (LZ4 and
Snappy in host C++, ``csrc/codecs.cpp``), ``pipeline.shard_format``,
``balance`` (the sample-count cache), ``tokenization.wordpiece``
(the vocab map and ``BertWordPiece``, no transformers) over ``native``
(the C++ WordPiece encoder, ``native/src/wordpiece.cpp``, built with the
host's ``c++`` at the first encode), ``core.utils``, ``core.random``, ``core.log``,
``loader.dataset``, ``loader.columnar``, ``loader.shuffle_buffer``,
``loader.binned``, ``loader.bert``, ``loader.packed``,
``loader.codebert`` and ``loader.bart`` (BART text infilling, tokenizing
raw text at load time), with worker-process collate (``loader.workers``
over the ``loader.shm`` batch ring) and the determinism ledger's
``collate`` and ``device`` records (the latter keyed by the batch's
``(epoch, index)`` where the train loop and the step replay feed;
``telemetry.ledger``, audited by
``python -m lddl_tpu_torch.telemetry.audit``). The step:
``models.bert``, ``models.convert``, ``models.flops``,
``ops.flash_attention``, ``parallel.train``, ``loader.device``,
``training.pretrain`` (``TrainLoop``, its step cache of one CUDA graph per
bin, and the ``pretrain`` CLI), and the train loop's hooks: ``telemetry``
(metrics, trace, roofline, profiler, sentinels), ``core.faults``,
``training.elastic`` (preemption, async checkpoints, loader re-seek,
rank membership) and ``pipeline.pool``'s background writer.
Data-parallel training across processes: ``comm`` (the null, file and
``torch.distributed`` backends, with lease stores), ``core.topology``,
``pipeline.executor`` (its lease timeout), ``parallel.mesh`` (the
``data`` axis of a ``DeviceMesh``), ``parallel.train.DataParallel``
(global-batch normalizers, the gradient all-reduce),
``telemetry.live`` (straggler scores), ``telemetry.report`` (the
cross-rank merge and its CLI) and the ledger's
``divergence_over_comm``. The network data service: ``loader.service``
(``DataServer``, ``NetworkBatchSource``, ``python -m
lddl_tpu_torch.loader.service``; ``transport='network'`` in
``loader.workers``), and the live monitor: ``telemetry.live``,
``telemetry.server`` (``LDDL_MONITOR``) and ``telemetry.monitor``
(``python -m lddl_tpu_torch.telemetry.monitor``), with ``testing``'s
``SyntheticBatchLoader``. Deterministic replay: the ledger's ``step``
record (``training.pretrain.state_fingerprint``; with the ledger on the
loop runs deterministic algorithms), ``replay`` (``rematerialize``,
``bundle``, ``steps``, ``python -m lddl_tpu_torch.replay.cli``) and the
flight recorder, ``training.flight`` (``python -m
lddl_tpu_torch.training.flight``), which the sentinel's incident
registry lists; bisect over the stream the ledger records. The K-step
scan window (``parallel.train.make_scan_train_step`` and
``stack_batch_window``: K steps in one CUDA graph), the bench-history
perf gate (``python -m lddl_tpu_torch.telemetry.perf``), the trace CLI
(``python -m lddl_tpu_torch.telemetry.trace``) and the sentinel's
``ledger_divergence``. Parameter placement over the mesh's ``fsdp`` and
``tensor`` axes: ``models.bert`` (``_RULES``, tensor-parallel Dense and
Embed forms), ``models.convert.shard_state_dict``, ``parallel.mesh``
(the batch layout, the axes' groups, ``match_partition_rules``,
``reshard_state``), ``parallel.train`` (``ShardedDataParallel``, the
vocab-parallel cross entropy), ``ops.flash_attention.
make_flash_attention`` and ``loader.device.make_global_batch``. Ring
attention over the mesh's ``seq`` axis: ``parallel.ring``
(``ring_attention``, ``make_ring_attention``: K/V rotated by
``batch_isend_irecv``, dense or flash blocks),
``parallel.mesh`` (the seq group, ``seq_shard``, the flattened
``data x fsdp x seq`` group), ``models.bert`` (``attention_impl`` 'ring'
and 'ring_flash' on a mesh, global positions, the encoder's output
gathered over seq for the heads), ``parallel.train`` (normalizers and
gradients over ``data x fsdp x seq``) and the CLI's ``--sp``. Step
replay, bisect and bundles of a sharded run launched as its ranks: the
replay CLI's ``--comm torch`` over the run's mesh (``replay.cli``'s
``World``: the world's verdict), each rank's own ledger file and batch
rank, ``training.flight`` over each rank's incident. BERT preprocessing
and balancing on the card: ``preprocess.bert`` (the fast engine, ``python
-m lddl_tpu_torch.preprocess.bert``) over ``preprocess.readers``,
``pipeline.partition``, ``pipeline.shuffle``, ``preprocess.common``,
``pipeline.executor`` (the serial map over comm ranks, with write-back),
``preprocess.pairing`` (and ``native``'s ``src/pairing.cpp``),
``tokenization.sentences``, the encoder's preprocessing half, host
masking (``native/src/masking.cpp``) and device masking as CUDA
(``ops.masking``, ``csrc/masking.cu``: both jit programs of
:mod:`lddl_tpu.ops.masking`, bit for bit), and the shard writer
(``pipeline.parquet_io``: Parquet in numpy, LZ4_RAW pages from
``csrc/codecs.cpp``; ``pipeline.shard_format``'s tags); ``balance``
(``python -m lddl_tpu_torch.balance``); ``core.synth``. Every other shard
format the port trains on, and the local worker pool: ``preprocess.packed``,
``preprocess.codebert`` and ``preprocess.bart`` (``python -m
lddl_tpu_torch.preprocess.packed|codebert|bart``), ``pipeline.pool``'s
``WorkerPool`` and ``pipeline.executor``'s pooled map (``--num-workers``),
``ops.masking_host`` (host masking without torch), and ``testing``'s
recipes of the committed shard sets' sources. The preprocessor's fleet
and front end: ``pipeline.executor``'s elastic map (leases over the
comm's store, completion manifests from ``pipeline.parquet_io``, the
resume of a killed run; ``--comm file`` and ``LDDL_ELASTIC``),
``preprocess.bert``'s ``python`` engine, ``download`` (the downloaders;
their offline steps write ``lddl_tpu``'s bytes), ``cli`` (``python -m
lddl_tpu_torch.cli <name>``, ``lddl_tpu``'s command table), and
``testing``'s word-salad corpus, Parquet hash and data-parallel drain
accounting. The static analyzer: ``analysis`` (``python -m
lddl_tpu_torch.cli lddl_analyze``, the stdlib only: ``lddl_tpu``'s rules
LDA001-LDA018 with torch's collectives, compiled-code roots, host syncs
and global-generator draws beside JAX's), which also runs the perf
gate's concurrency leg.
"""
