#!/usr/bin/env python3
"""Drive lddl_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--steps N] [--warmup N]

Phases, each of which raises on failure (the script then exits non-zero):

  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from lddl_tpu_torch/csrc (nvcc, sm_90a) and
     report each kernel's registers and spills (none allowed in the
     tensor-core bodies at head_dim 64, nor any spill or stack frame in a
     masking kernel);
  3. hold each kernel (flash fwd, dq, dkv) against its plain PyTorch
     version on the card, in float32 (TF32 off) and bfloat16, at the
     shapes the training phase gives them plus a ragged and a d=32 case;
     check that two launches are bitwise equal; time kernel, plain version
     and PyTorch's scaled_dot_product_attention on its memory-efficient
     backend (a yardstick only, never called by the port) with CUDA
     events, beside the least time the card could take for the same work;
     every bf16 kernel runs the tensor-core (mma.sync) body, every float32
     one the CUDA-core body, and each row says which;
  4. the same for the segmented kernels (K4: block-diagonal packed
     attention) on ragged packed rows, out and lse compared on real rows,
     cotangents zero on padding rows; also time the segment-free kernel
     on the same inputs and require the segmented one to take at most
     half its time wherever 80% or more of the tiles skip, and check that
     a row of padding only gives out = 0 and a finite lse;
  5. train BERT-base at full width (hidden 768, 12 layers, 12 heads, FFN
     3072, vocab 30528, bf16, attention_impl='flash', dropout 0.1)
     through TrainLoop.run on loader-format batches made in numpy from
     --seed, in two bins (seq 128 x batch 64, seq 512 x batch 16) fed by
     prefetch_to_device, with the step cache on (the default: one CUDA
     graph per bin, replayed); check finite losses, 12 launches of each
     kernel per step as the kernels count them on the device (replays
     included; the wrappers' count, which adds the launches a graph
     recorded at capture per replay, must agree), and exactly one cache
     miss per bin with none after the first pass over the bins (hits =
     steps - misses); time the same steps with the cache off
     (LDDL_STEP_CACHE=0) and profile them with the cache on, printing
     ms/step per bin with the cache on and off, device busy, and the idle
     share of each against that busy time, and
     check that the profiler saw 12 calls per replayed step of each
     kernel; check one step against dense attention from the same
     weights; check the timed graphs themselves (deterministic algorithms
     off) against eager steps from one checkpoint, loss, grad_norm and
     the update within NONDET_*_RTOL, beside the eager-vs-eager spread;
     check that fresh loops restored from one checkpoint, with the cache
     on and off, without and with remat, give bit-equal losses and state
     digests over 3 steps of each bin (graph vs eager and the remat
     recompute's dropout, deterministic algorithms on); save, restore and
     check the resumed
     losses bit for bit, into a fresh loop and into the same loop (its
     graphs survive restore); with telemetry and trace on, for each bin,
     check that export_telemetry writes both files with the
     train.step_cache_* counters, train.mfu and non-zero hbm.* gauges,
     and that an armed StepProfiler writes one trace; and the step cost
     model: train.xla_flops / train.xla_bytes are the steps' bills, the
     count's matmul + flash FLOPs are the analytic count (models/flops.py)
     + the flash recompute + the NSP head to STEP_FLOPS_RTOL, the
     profiled steps' billed FLOPs over their device-busy time are at most
     989 TFLOP/s, and the roofline verdict over the file names a bound
     class (printed with the fractions, the intensity against the machine
     balance, and counted against analytic MFU);
  6. packed long-context training: the same model with 8192 positions at
     seq 8192 x batch 2, rows of 12-16 documents packed as
     preprocess/packed.py writes them and collated by PackedCollate
     (block_diagonal=True), dynamic masking, masked-only head of 1359
     predictions, the step cache on; check finite losses, 12 launches per
     step of each segmented kernel (none of the segment-free ones), on
     the device and in the profiler, and one cache miss; time with the
     cache on and off, profile with it on; check one packed s=2048 step against
     dense attention, the timed graph against eager steps, graph vs eager
     (with and without remat) on packed rows bit for bit, and save,
     restore and resume bit for bit; the telemetry and step-cost checks
     of phase 5, each step billed its own computed attention tiles;
  7. training from shards, through the corpus loader as a user calls it,
     from the balanced Parquet shards lddl_tpu wrote (tests/assets/
     torch_shards, made by tests/make_torch_shards.py): (a) drain one
     epoch of the pairs loader (batch 16, bins of 128 up to 512, dynamic
     masking) and of the packed one (batch 2, s=8192, block-diagonal),
     every batch's batch_sha256 held against the digests of lddl_tpu's
     loaders (digests.json), timed and split into read+decode, collate
     and the rest; (b) SHARD_EPOCHS epochs of BERT-base from pairs/
     through TrainLoop.build(path=...) and TrainLoop.run with the step
     cache on, the shuffle buffers smaller than a bin (digests.json's
     settings): finite losses, one cache miss per bin, 12 launches per
     step of each segment-free kernel and none of the segmented ones
     (counts at 0 just before, read just after); per bin, the loop's
     whole window per step (data wait included) and the step alone,
     against synthetic batches made beforehand in the same shapes and
     order through the same graphs and loop, and against the shards again
     with the thread switch interval cut to GIL_SWITCH_S;
     train.data_wait_seconds
     with the epochs' first steps apart, train.h2d_seconds and the
     collate time from the loop's telemetry; then save at the first
     epoch's midpoint, restore into the same loop and into a fresh one
     (whose loader restore must re-seek), and check the rest of the epoch
     bit for bit; (c) packed s=8192 from packed/ for the warm-up and
     timed packed steps: 12 launches per step of each segmented kernel
     and none of the others, one cache miss, the whole window and real
     tokens/s over it, and the data wait; (d) python -m
     lddl_tpu_torch.training.pretrain on pairs/ for 4 steps with a
     checkpoint at step 4, then --resume to step 6: rc 0 and finite
     losses;
  8. the loaders through WORKERS worker processes (forkserver children
     that import no torch; batches handed over in shared-memory slot
     rings or pickled): (a) one epoch of pairs/, packed/ and codebert/
     by each handoff (shm, pickle, shm with zero-copy views), every
     batch's batch_sha256 = digests.json, samples/s and ms/batch beside
     the serial loader's in alternating order, the workers' start per
     epoch, and no slot overflow at the default slot size; (b)
     SHARD_EPOCHS epochs of BERT-base from pairs/ through
     TrainLoop.build(path, loader_kwargs={'num_workers': WORKERS,
     'vocab_file': ...}), the step cache on: 12 launches per step of each
     segment-free kernel and none of the segmented ones, one miss per bin
     (counts at 0 just before, read just after); then the serial loader
     and synthetic batches through the same loop, alternating with the
     workers (W S Y Y S W): the loop's whole window per step, the step
     alone, the data wait with the epochs' first steps apart,
     train.h2d_seconds and the workers' start per epoch; and a midpoint
     resume through a re-seeked MultiprocessLoader, bit for bit; (c)
     packed s=8192 from packed/ through the workers: 12 launches per step
     of each segmented kernel and none of the others, one miss, the
     window and data wait beside 7c's; (d) one epoch with the
     determinism ledger on, serially and through the workers, and off,
     alternating: the collate and device records equal key for key (the
     port's auditor exits 0), the collate digests = lddl_tpu's blake2b-8
     ones (digests.json), and the ledger's cost per step; (e)
     CODEBERT_STEPS BERT-base steps from codebert/ through
     get_codebert_pretrain_data_loader(..., num_workers=WORKERS): finite
     losses, the batches = digests.json; (f) a worker SIGKILLed
     mid-epoch: the parent raises the RuntimeError naming it within its
     5 s poll. No ``lddltorch_`` shared-memory segment is left after any
     phase from 7 on;
  9. data-parallel training across processes, each rank a process of this
     script (``--rank-task``) in a session of its own, the world killed
     and the phase failed past RANK_TIMEOUT; the processes are those of
     phases 14 and 15 (b in ``--rank-task 14``'s two ranks before 14a,
     a in ``--rank-task 14c``'s before 14c), started here, so phases 14,
     15b-c, 16's recorded runs and their replays run now and are checked
     in their own phases; (a)'s process starts first and its CLI runs
     (below, untimed) overlap (b); it waits for the two ranks to exit
     before its timed steps and before it resumes (b)'s checkpoint: (a)
     under
     ``torch.distributed.run`` at world 1 over NCCL, the CLI as 7d runs
     it, 4 steps with a checkpoint then --resume for 2, with --comm null
     and with --comm torch in one process, deterministic algorithms on:
     the losses bit-equal (the one-rank all-reduces copy), and within the
     print precision of 7d's; 12 launches per step of each segment-free
     kernel and none of the segmented (counts at 0 just before each run,
     read just after), one cache miss per bin, the all-reduces inside
     the CUDA graphs (mode graph, backend nccl); then 16 more steps
     timed through the same graphs each way, the step alone against
     phase 7b's; (b) two ranks on the one card, gloo for CUDA tensors
     (LDDL_DIST_CUDA_BACKEND=gloo, --device cuda:0; eager steps):
     DP_NUMPY's numpy global batches (8 rows a rank, dropout off, the
     first with halves masked at DP_UNEVEN's very different rates)
     through the data-parallel step, the ranks bit-equal after every
     step and within DP_LOSS_RTOL / DP_GRAD_NORM_RTOL of the world-1
     step on the whole batches run by rank 0 (per step, and a held-out
     batch's loss after them), where averaging per-rank means must miss
     the global grad_norm; then the CLI from pairs/ with --comm torch, 4
     steps with a checkpoint (launches, misses per rank); (a)'s world-1
     NCCL process resumes it: the state equal to the ranks' bit for bit, the
     same samples_seen, the next 3 batches equal to a world-1 loader
     re-seeked to it, 2 more finite steps; ms/step per rank; (c) no
     ``lddltorch_`` segment and no rank process left;
  10. the network data service and the live monitor, BERT-base from
     pairs/ with the step cache on: (a) ``python -m
     lddl_tpu_torch.loader.service`` (a process that imports no torch)
     serves digests.json's pairs loader; TrainLoop.build with
     LDDL_LOADER_TRANSPORT=network finds it by its announce and trains
     SERVE_EPOCHS epochs (deterministic algorithms on, the ledger on, the
     monitor on): every batch = the serial loader's (epoch 0 =
     digests.json), the collate records = its blake2b-8 digests, every
     batch over the wire, the server served one per step, 0 fallbacks,
     12 launches per step of K1-K3 and none of K4 (counts at 0 just
     before, read just after), one miss per bin, the losses bit-equal to
     a serial-loader run in a fresh loop, and the server holds no CUDA
     context; then, for the record, the window per step and the data
     wait from the server, the serial loader and W=2 workers (S N W W N
     S); (c) during (a) a scraper GETs /snapshot every SCRAPE_S while
     the graphs are captured (no error, one miss per bin, mode graph,
     hbm.bytes_limit = the card's memory, headroom in (0, 1)), /metrics
     parses as Prometheus text, /profile?steps=2 writes a torch.profiler
     trace with 24 calls of each of K1-K3, and ``python -m
     lddl_tpu_torch.telemetry.monitor --dir ... --once --json`` lists
     rank 0 and the server; the window per step with the monitor off and
     on at a 1 s scrape; (b) the server SIGKILLed before
     SERVE_KILL_STEP: the monitor CLI lists it dead, the client degrades
     once to its local loader at the exact step, re-attaches to a
     restarted server after SERVE_REATTACH batches, every batch is still
     the serial loader's; no server process and no announce left;
  11. the ledger's step record, step replay and the flight recorder,
     BERT-base from pairs/: (a) RECORD_STEPS steps through TrainLoop with
     the ledger (blake2b-8) and the sentinel on (so deterministic
     algorithms), a checkpoint every RECORD_CKPT_EVERY steps and an
     injected sentinel trigger (RECORD_FAULT): 12 launches a step of each
     of K1-K3 and none of K4 (counts at 0 just before, read just after),
     one miss per bin, step lines at the checkpoints with the JAX line's
     keys, the collate digests = the serial loader's (epoch 0 =
     digests.json), exactly one incident (in the sentinel's status), and
     the trace the incident armed (LDDL_FLIGHT_PROFILE_STEPS) naming
     K1-K3; (c) ``python -m lddl_tpu_torch.replay.cli batch`` at BATCH_KEYS
     = the ledger, ``bundle`` of each batch from the incident's
     checkpoint to its suspect, and with corrupt:replay.read the bundled
     step refused with exit 1; (b) the replay CLI's ``step`` (its
     ``main``, in this process, each replay building its own loop from
     the checkpoints) at REPLAYS from the corpus (across the epoch's end)
     and from the bundles with no corpus (from the mid-epoch checkpoint):
     each matches its step line bit for bit, 12 launches a replayed step
     of each of K1-K3 counted on the device; (d) after it, the incident
     CLI's ``replay <incident> -- <step args>`` (``lddl_tpu_torch.
     training.flight``'s ``main``) exits 0 with a match; the manifest's
     trigger, step, replay_step, suspect (its digest = the ledger's) and
     checkpoint, and the incident CLI's list, show and replay; (e) for
     the record: the ops that warn under deterministic algorithms (an
     epoch of pairs/ and a packed step, eager), ms/step with
     deterministic algorithms off and on (O N N O), the window with the
     ledger and the recorder off and on (F T T F), and the cost of one
     step fingerprint; (f) the recording run resumed at its mid-epoch
     checkpoint RESUME_AT (resume semantics: another shuffle) to
     RESUME_TO with the ledger and tracing on, its ledger 11a's up to the
     step line at RESUME_AT: 12 launches a step of each of K1-K3 (counts
     at 0 just before, read just after), losses that are not 11a's; in
     11b, the replay CLI's ``step`` of RESUME_TO bit for bit with
     that ledger and ``bisect --ledger`` over (RESUME_AT, RESUME_TO]
     giving the resumed run's losses bit for bit (the recorded stream);
     (g) after phase 12: ``python -m lddl_tpu_torch.telemetry.perf
     --gate`` with 11a's two-epoch ledger (``--audit``: the self-check,
     its device records keyed by (epoch, index); ``--replay-smoke`` over
     the pairs loader), phase 11's incident tree and phase 12's bench
     history: exit 1 for the injected incident, the audit and the smoke
     ok, a verdict per series and no regression, the concurrency leg
     linting lddl_tpu_torch/ with the port's analyzer, clean (no
     "concurrency lint unavailable"); 11e's two ledgers
     verified one against the other (exit 0); ``python -m
     lddl_tpu_torch.telemetry.trace`` over (f)'s trace: exit 0 and a
     merged document with events, exit 2 over a directory with none;
  12. the K-step scan window (make_scan_train_step over
     stack_batch_window) at BERT-base width with dropout 0.1, at
     SCAN_CELLS (s=128 x 64 and s=512 x 16 with K=8, packed s=8192 x 2
     with K=4), numpy batches from --seed: (a) under deterministic
     algorithms, from one state, one window equals K hits of the
     per-step graph (CompiledStepCache) bit for bit: params, AdamW's mu,
     nu, count_t, the host count and the last step's metrics; (b) one
     window's launches, counted on the device (counts at 0 just before,
     read just after): K x 12 of each kernel of the path, none of the
     others; (c) one capture per (signature, K), every later window a
     hit; (d) mode graph; for the record, with the batches already on
     the card, ms/step of windows (W), of per-step hits reading every
     loss (S) and of per-step hits queued (Q), in the order W S Q Q S W;
     device busy and idle by torch.profiler over one window against K
     hits; the capture and instantiation time; each graph's pool and the
     peak allocated over its hits; stack_batch_window's host time a
     window against the feed's train.h2d_seconds a batch. Each timed
     window's ms/step goes into a bench-history JSONL that 11g gates;
  13. the BART text-infilling loader (no model: lddl_tpu has no BART
     model) over tests/assets/torch_shards/bart/ at the loader's defaults
     (batch 64, 128 tokens, noise density 0.3, Poisson lambda 3): (a)
     build the native WordPiece library (lddl_tpu_torch/native/src,
     the host's c++) and print its seconds; (b) every chunk through the
     port's tokenizer: the sha256 of the ids and offsets = digests.json's
     (lddl_tpu's HF tokenizer), tokens/s at 1 and 8 threads; (c) the
     serial loader, epochs 0 and 1: every batch_sha256 = digests.json,
     samples/s, collate p50/p99; (d) through 2 worker processes: the same
     digests, no ``lddltorch_`` segment left; (e) a data server process
     serving the BART factory, drained over loopback: the same digests,
     every batch over the wire; (f) the ledger on (blake2b-8): collate
     and device records (epoch, index) = digests.json's, the auditor's
     self-check exit 0, ``replay.cli batch --factory`` on one coordinate
     exit 0; (g) each epoch through prefetch_to_device onto the card, every
     batch read back equal to its host batch;
  14. parameter placement over the mesh's fsdp and tensor axes, BERT-base
     (flash, bf16, dropout off, the masked-only head) from one --seed
     init, two ranks on the one card over gloo (``--rank-task 14``; eager
     steps, deterministic algorithms on), PLACE_STEPS steps on batches of
     pairs/ at s=PLACE_SEQ, PLACE_ROWS rows a data x fsdp rank, each
     rank taking its rows by make_global_batch: (a) tensor=2, 6 heads a
     rank: 12 launches a step of each of K1-K3 and none of K4 on each
     rank (counts at 0 just before, read just after), the ranks' metrics
     bit-equal every step, loss and grad_norm within PLACE_LOSS_RTOL /
     PLACE_GRAD_NORM_RTOL of world 1's step on the same batches from the
     same init (run by rank 0 after), then a checkpoint and one step
     more; (b) fsdp=2 the same, and a rank keeps half of world 1's
     parameter and optimizer bytes between steps; in both, a snapshot of
     the whole state (what a save gathers) allocates less on the card
     than the rank's flat buffer; (c) a world-1 NCCL process
     (``--rank-task 14c``) resumes (a)'s checkpoint, its state equal to
     the ranks' gathered state bit for bit, and takes (a)'s next step
     through the step cache (a capture) within the same limits of (a)'s;
     ms/step per rank and world 1's, the peak allocated per rank and the
     phase's seconds; (d) in the same two processes, PLACE_DRIFT_STEPS
     steps at tensor=2 with the ledger and deterministic algorithms off:
     the replicated parameters (position and type tables, LayerNorms,
     pooler, NSP head, mlm_transform, row-parallel biases) bit-equal
     across the ranks after every step. ``--place-faults`` runs (a), (b)
     and (d) alone, sound and under the planted faults of PLACE_FAULTS
     (for (d), the exchange without its replica broadcast), and prints
     their gaps to world 1 and (d)'s drift: the readings the two limits
     sit between;
  15. ring attention over the mesh's seq axis: (a) in this process, the
     kernels on the inputs a ring at seq=2 gives them, bf16, against
     their plain versions (RING_TOL = 3e-2 for out on real rows,
     absolute for lse; each element of dq, dk and dv within 3e-2 of the
     sum of the absolute values of its products, each tensor's relative
     norm error within 1e-2), bitwise repeatable, every output finite:
     K1-K3 on a q shard of s=512 rows against the other shard's K/V and
     key mask
     (RING_KERNEL_PAIRS), K4 on shard 0's q ids against shard 1's kv ids
     of a packed s=8192 row (RING_KERNEL_PACKED), with real rows that
     have no same-document key there (their lse below -1e8: weight 0 in
     the merge) and q tiles disjoint whole; a random g_out and a random
     non-zero g_lse; (b) in phase 14's two rank processes after 14a/14b,
     BERT-base ring_flash over make_mesh(seq=RING_SEQ) (eager,
     deterministic, dropout off) on RING_CELLS (packed s=8192 x 2
     block-diagonal, 4 steps; pairs s=512 x 16, 2 steps; numpy batches,
     each rank's half of every row by make_global_batch): each kernel's
     launches on each rank = 12 x RING_SEQ blocks a step (every rotated
     shard runs its block; counts at 0 just before, read just after), the
     ranks' metrics and parameters bit-equal, loss, grad_norm and the
     parameters' gap within the cell's RING_LIMITS of world 1 (flash, one
     process, run by rank 0 from the same init), ms/step and peak a rank;
     (c) in 14c's process, the ring at n=1 (world 1 over NCCL with a
     mesh) on a packed s=8192 batch: the step captured by the step cache
     and replayed, bit-equal to the same step eager, 12 launches of each
     K4 kernel a replay, loss and grad_norm within DENSE_*_RTOL of
     flash's. ``--ring-faults`` runs (b) alone, sound and under each
     fault of RING_FAULTS, and prints the gaps RING_LIMITS sit between;
  16. step replay of a sharded run, launched as its ranks: in phase 14's
     two rank processes after 15b, BERT-base runs from the committed
     shards as the replay CLI builds them (bf16, dropout on), the ledger
     on (each rank its file, deterministic algorithms), REPLAY_STEPS
     steps with a checkpoint every step, on each mesh of REPLAY_LAYOUTS:
     (a) tensor=2 flash on pairs/, (b) seq=2 ring_flash on packed/ at
     s=8192 (the packed K4 through the ring; also a checkpoint at 0),
     (c) data=2 flash on pairs/; rank 0 also writes (a)'s checkpoint at
     step 1 with one bit flipped. Then the same two processes (ranks on
     the card over gloo) run ``python -m lddl_tpu_torch.replay.cli``'s
     ``main`` as those ranks (``--comm torch``), job after job: ``step 2`` of each run from its step-1
     checkpoint over the corpus, exit 0 on both ranks with the step
     line's digest reconstructed (rank 0 alone printing the verdict),
     (a) from the flipped checkpoint exit 1 on both, and (b)'s ``bisect
     --per-sample`` over (0, 2]: spike step 2, the losses = the loss
     lines and the recorded losses bit for bit; each job's launches on
     each rank counted by the kernels on the device, 12 a replayed step
     of each kernel of the path (x 2 blocks under the ring, and one
     forward a row scored), and the seconds a rank.
  17. preprocessing on the card: (a) both static-masking kernels
     (csrc/masking.cu: the partition program, the port of lddl_tpu's jit
     program _partition_kernel, and the matrix program, of
     _device_kernel) against their plain versions on the card, exactly,
     at s=128 and s=512 over MASK_ROWS rows made from --seed with the
     preprocessor's row lengths (mostly full), over the rows of one of
     17b's launches, with a max_predictions cap and over MASK_LONG's rows
     of 8192 (the kernels' shared-memory form), two launches bitwise
     equal, timed by their launches alone (CUDA graph replays,
     kernel_ab.launches_ms) and as one wrapper call an event pair, with
     the plain version (the jit program's argsort-twice form as torch
     ops) beside the bound; the whole mask_partition_device call on 17b's
     rows by the host clock; an empty partition launches nothing; the
     matrix program through mask_batch(backend='device'), one launch;
     (b) ``python -m
     lddl_tpu_torch.preprocess.bert --target-seq-length 512 --bin-size
     64 --num-blocks 8 --masking`` (the default mask backend, device) on
     a PREP_CORPUS_MB MiB synthetic corpus (core/synth, --seed), telemetry
     on: one masking kernel launch a partition (its telemetry export),
     every bin file, footers tagged delta with duplicate factor 5, each
     copy's k, its positions increasing inside A or B and never special,
     every file read by the port's reader; MB/s of corpus and the seconds
     of its parts; (c) the same with ``--mask-backend host``: every
     non-masking column byte-identical, the masks not; (d) ``python -m
     lddl_tpu_torch.balance --num-shards 8``: n or n+1 groups a shard in
     every bin, the sum = (b)'s, ``.num_samples.json``; (e) BERT-base
     from the balanced shards (static masks, step cache off): PREP_STEPS
     finite losses, 12 launches a step of each of K1-K3.
  18. every shard format the port trains on, written on the card's
     machine: (a) beside the build, the sources of the committed packed/,
     codebert/ and bart/ sets remade from digests.json's corpus seeds
     (lddl_tpu_torch.testing's recipes) and run through ``python -m
     lddl_tpu_torch.preprocess.packed|codebert|bart`` and ``python -m
     lddl_tpu_torch.balance`` at tests/make_torch_shards.py's settings;
     before the first timed phase, the port's loaders over the results
     give every committed batch_sha256 (bart: epochs 0 and 1, and every
     chunk's token_sha256): lddl_tpu's shards, bit for bit, made where
     lddl_tpu cannot run; (b) phase 7c trains from 18a's packed/ (K4,
     12 launches a step of each) and 8e from its codebert/ (K1-K3, the
     same), the counts at 0 just before and read just after; (c) last,
     with nothing else of the script running, phase 17's corpus through
     the BERT (``--mask-backend host``) and packed preprocessors at
     ``--num-workers 1`` and N = min(POOL_MAX_WORKERS, cores), wall
     seconds and MB/s of each: every file byte-identical at 1 and N;
     then the BERT run at N with ``--mask-backend auto`` (it must resolve
     to host) and one pool worker SIGKILLed at a task's start by the
     pool.task fault hook: one respawn, and the clean run's bytes.

  19. the preprocessor's front end and its fleet on the card's machine:
     (a) beside the build, WIKI_CORPUS_MB MiB of synth articles in
     wikiextractor's format through ``python -m lddl_tpu_torch.cli
     download_wikipedia --no-download --no-extract`` (every article in
     WIKI_SHARDS shards), then ``preprocess_bert_pretrain --engine
     python`` (no masking) and ``balance_shards``; before the first timed
     phase, the port's loader reads WIKI_BATCHES batches of the result;
     (b) after 18c, 17b's run as two ``--comm file`` ranks (the elastic
     executor, device masking), rank 1 SIGKILLed at its first task
     (ELASTIC_KILL): rank 0 revokes its lease through the death probe,
     runs every partition in under half the lease timeout with an M1
     launch each (its telemetry), and writes 17b's files byte for byte;
     (c) one rank SIGKILLed at the third task of the process phase, then
     restarted with the same run id: the partitions manifested before the
     kill keep their files' inode and mtime, resume_skipped counts every
     manifest the kill left, the rest run again, 17b's files.
  20. the port's static analyzer on the card's machine, host only: (a)
     beside the build (joined before the first timed phase), ``python -m
     lddl_tpu_torch.cli lddl_analyze --format json`` over lddl_tpu_torch/
     exits 0 with no unsuppressed finding and exactly the suppressions of
     ANALYZE_SUPPRESSED; a cold and a warm run over a fresh
     ``LDDL_ANALYZE_CACHE`` give the same document, each with its seconds;
     a planted package (ANALYZE_PLANTED) exits 1 naming LDA005 (a torch
     collective under a rank branch), LDA010 (``.cpu()`` in a
     ``capture_step`` body) and LDA002 (``torch.rand(3)``); ``--format
     sarif`` parses; the probed processes load nothing of lddl_tpu, torch
     or jax. 11g's gate lints over 20a's warm cache.
  21. right after phase 6, BertConfig.ablate at BERT-base width: each of
     'attention-core', 'ffn', 'norms' and 'gelu' built from --seed and
     trained at phase 5's bins (bf16, flash, dropout 0.1, the step cache
     on; phase 5's warm-up and timed steps, ABLATE_PROFILED profiled
     steps a bin), launch
     counts at 0 just before and read just after: finite losses, one
     cache miss a bin, 12 launches a step of each of K1-K3 on the device
     and in the profiler (none under 'attention-core'), the miss's
     counted matmul + flash FLOPs = expected_flops less the ablated terms
     to STEP_FLOPS_RTOL; ms/step and device-busy ms beside phase 5's.

The last lines are the kernels' JSON summary (with the launch counts of
phases 9-12, 14-17, 19 and 21; phase 13 runs no kernel), the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA card the
script exits non-zero before printing any result.
"""

import argparse
import atexit
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# Deterministic cuBLAS workspaces (read at the first cuBLAS call), so the
# save/restore check can compare losses bit for bit.
os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
VOCAB_FILE = os.path.join(HERE, 'benchmarks', 'assets', 'bench_vocab_30522.txt')
# Balanced shards lddl_tpu wrote, with the digests of its loaders' batches
# over them (tests/make_torch_shards.py).
SHARDS = os.path.join(HERE, 'tests', 'assets', 'torch_shards')
# Epochs of pairs/ in phase 7b: its smallest bins hold 3 batches an epoch,
# so 2 epochs give each bin at least 5 cache hits.
SHARD_EPOCHS = 2
# The thread switch interval of 7b's third pass over the shards (Python's
# default is 5 ms).
GIL_SWITCH_S = 0.0005
# Phase 8: worker processes of the loaders, their handoffs (transport,
# zero_copy), the shard sets and their loaders, and the CodeBERT steps.
WORKERS = 2
HANDOFFS = (('shm', False), ('pickle', False), ('shm', True))
SHARD_LOADERS = {'pairs': 'get_bert_pretrain_data_loader',
                 'packed': 'get_packed_pretrain_data_loader',
                 'codebert': 'get_codebert_pretrain_data_loader'}
CODEBERT_STEPS = 6
DEVICE = 'cuda'
MODEL = 'base'
PAD, CLS, SEP, MASK = 0, 2, 3, 4
VOCAB_REAL = 30522
BINS = ((128, 64), (512, 16))  # (seq_len, batch)
# Segment-free kernel cases beside the bins' shapes: a ragged length and
# the other two head dims, (batch, heads, seq, head_dim).
EXTRA_CASES = ((8, 12, 200, 64), (8, 8, 256, 32), (4, 8, 256, 128))
# Packed long-context training (seq_len, batch, max_predictions: the
# dynamic-masking budget check_max_predictions gives for s=8192, as
# examples/long_context_example.sh uses), and the packed bin of its
# flash-vs-dense step (dense at 8192 would hold ~77 GB of scores).
PACKED = (8192, 2, 1359)
PACKED_DENSE = (2048, 2)
# Documents per packed row at s=8192 (Wikipedia-article-sized, median
# ~500 tokens); a shorter bin packs proportionally fewer.
PACKED_DOCS = (12, 16)
# Segmented-kernel cases: (batch, heads, seq, head_dim, dtype, documents
# per row, padded tail, last row padding only). The first is the packed
# phase's shape.
SEG_CASES = (
    (2, 12, 8192, 64, torch.bfloat16, 16, True, False),
    (2, 12, 2048, 64, torch.float32, 4, True, False),
    (2, 8, 1024, 32, torch.float32, 8, True, False),
    (2, 8, 1024, 32, torch.bfloat16, 8, True, False),
    (2, 8, 1024, 128, torch.float32, 8, True, False),
    (2, 8, 1024, 128, torch.bfloat16, 8, True, False),
    (2, 12, 2048, 64, torch.bfloat16, 1, False, False),  # nothing skips
    (2, 12, 4096, 64, torch.float32, 16, True, True),
    (2, 12, 4096, 64, torch.bfloat16, 16, True, True),
)
# Where at least this share of tiles skips, the segmented kernel must take
# at most SKIP_SPEEDUP_MAX of the segment-free kernel's time on the same
# inputs: the skip is an early-out, not masked compute.
SKIP_CHECK_FRACTION, SKIP_SPEEDUP_MAX = 0.8, 0.5
KERNEL_SOURCE = 'lddl_tpu_torch/csrc/flash_attention.cu'
TPU_KERNELS = {
    'fwd': 'lddl_tpu/ops/flash_attention.py:166',
    'dq': 'lddl_tpu/ops/flash_attention.py:210',
    'dkv': 'lddl_tpu/ops/flash_attention.py:248',
    # The same bodies with segment refs: the pl.when(_tile_live) skip.
    'fwd_seg': 'lddl_tpu/ops/flash_attention.py:201',
    'dq_seg': 'lddl_tpu/ops/flash_attention.py:241',
    'dkv_seg': 'lddl_tpu/ops/flash_attention.py:286',
}
# Which body a kernel runs (csrc/flash_attention.cu): every bf16 kernel on
# the tensor cores, every float32 one on the CUDA cores.
MMA_BODY, F32_BODY = 'mma.sync bf16', 'cuda-core f32'


def body(dtype):
  return MMA_BODY if dtype == torch.bfloat16 else F32_BODY


# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Kernel vs plain version: float32 as the CPU parity tests (the kernels
# sum in another order than cuBLAS); bfloat16 outputs round to 8 bits of
# mantissa on both sides, 3e-2 as tests/test_flash_attention.py.
TOL = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (3e-2, 3e-2)}
# One full-width step, flash vs dense attention from the same weights:
# both round attention to bf16 at different points; 12 layers compound it.
DENSE_LOSS_RTOL, DENSE_GRAD_NORM_RTOL = 1e-2, 5e-2
# The step cost model's matmul + flash FLOPs against expected_flops().
STEP_FLOPS_RTOL = 1e-6
# Gaps between two kernels up to this long (microseconds) count as launch
# latency in the profile's idle split; longer ones as waiting on the host.
LAUNCH_GAP_US = 50
# The timed graphs (deterministic algorithms off) against eager steps from
# one checkpoint: the gathers' and index_add's atomics sum in any order, so
# two eager runs differ in the last bits and the steps are held within
# these: per-step loss and grad_norm, and the parameter update over the run
# (|theta_graph - theta_eager| / |theta_eager - theta_0|). Sized from the
# spread of two eager runs on an H100 (6 bin steps, 3 packed): loss 1.9e-7
# (packed), grad_norm 0, update 2.4e-9; each limit is 50x or more that.
NONDET_LOSS_RTOL, NONDET_GRAD_NORM_RTOL, NONDET_UPDATE_RTOL = 1e-5, 1e-5, 1e-6
# A kernel's name in the profiler: its body and whether it is segmented.
FLASH_KERNEL_NAME = re.compile(
    r'flash_(fwd|dq|dkv)(?:_mma)?_kernel<\d+, (true|false)>')


# (header, perf_counter) of each phase's '== ' line, for the phases'
# seconds at the end.
PHASE_STARTS = []


def log(*args):
  if args and str(args[0]).startswith('== '):
    PHASE_STARTS.append((str(args[0])[3:].split(' [')[0],
                         time.perf_counter()))
  print(*args, flush=True)


def phase_seconds():
  """Seconds from each phase's header to the next one's (the last to
  now)."""
  ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter()]
  return {name: round(end - t, 1)
          for (name, t), end in zip(PHASE_STARTS, ends)}


def batch_sha256(batch):
  """The digest of one loader batch (a dict of numpy arrays): sha256 over
  each key in sorted order, then its array's dtype, shape and bytes. The
  same on every machine, so batches of two loaders (or of one loader on
  two machines) compare by it."""
  h = hashlib.sha256()
  for key in sorted(batch):
    value = np.ascontiguousarray(batch[key])
    h.update(key.encode() + b'\0')
    h.update(value.dtype.str.encode() + b'\0')
    h.update(repr(value.shape).encode() + b'\0')
    h.update(value.tobytes())
  return h.hexdigest()


def token_sha256(ids, offsets):
  """The digest of a tokenizer's output over many texts: sha256 over the
  flat ids as int32, then the [n+1] offsets as int64 (little-endian)."""
  h = hashlib.sha256(np.ascontiguousarray(ids, dtype='<i4').tobytes())
  h.update(np.ascontiguousarray(offsets, dtype='<i8').tobytes())
  return h.hexdigest()


def card_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
  """Median milliseconds of ``fn`` by CUDA events, one event pair per rep."""
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


# ---- phase 2: the build's register report ----


def ptxas_entries(text, pattern):
  """(match, stats) for each entry function in nvcc's ``-Xptxas -v`` log
  whose name ``pattern`` matches: stats {'registers', 'spill_bytes',
  'stack_bytes'}."""
  found, stats = [], None
  for line in text.splitlines():
    entry = re.search(r"Compiling entry function '(\S+)'", line)
    if entry:
      m = re.search(pattern, entry.group(1))
      stats = None if m is None else {'registers': None, 'spill_bytes': 0,
                                      'stack_bytes': 0}
      if m is not None:
        found.append((m, stats))
      continue
    if stats is None:
      continue
    frame = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
    if frame:
      stats['stack_bytes'] = int(frame.group(1))
      stats['spill_bytes'] = int(frame.group(2)) + int(frame.group(3))
    regs = re.search(r'Used (\d+) registers', line)
    if regs:
      stats['registers'] = int(regs.group(1))
  return found


def ptxas_report(text):
  """Registers and spills of every kernel instantiation from nvcc's
  ``-Xptxas -v`` log, logged one line each. Raises if a tensor-core body
  at head_dim 64 (BERT-base, the main path) spills. Returns {(name, body):
  {'registers': n, 'spill_bytes': n}} for the tensor-core (bf16) head_dim-64
  instantiations, the ones the main path runs."""
  kernels = {}
  for m, r in ptxas_entries(
      text, r'flash_(fwd|dq|dkv)(_mma)?_kernelILi(\d+)ELb([01])E'):
    key = (m.group(1) + ('_seg' if m.group(4) == '1' else ''),
           MMA_BODY if m.group(2) else F32_BODY, int(m.group(3)))
    kernels[key] = {'registers': r['registers'],
                    'spill_bytes': r['spill_bytes']}
  for (name, kind, d), r in sorted(kernels.items()):
    log(f'    {name:8s} {kind:14s} d={d:3d}: {r["registers"]} registers, '
        f'{r["spill_bytes"]} bytes spilled')
    if kind == MMA_BODY and d == 64 and r['spill_bytes']:
      raise AssertionError(f'{name} ({kind}, d=64) spills '
                           f'{r["spill_bytes"]} bytes')
  return {(name, kind): r for (name, kind, d), r in kernels.items()
          if kind == MMA_BODY and d == 64}


def masking_ptxas_report(text):
  """Registers, spills and stack of every masking kernel instantiation
  from nvcc's ``-Xptxas -v`` log (csrc/masking.cu: C keys a lane holds in
  registers, 0 for shared memory), logged one line each. Raises if any
  spills or keeps a stack frame (a register form whose keys went to local
  memory). Returns {name: {...}} for the instantiations the main path
  runs: s=512 rows (C = 16), uint16 ids for the partition program."""
  kernels = {(m.group(1), m.group(2), int(m.group(3))): r
             for m, r in ptxas_entries(
                 text, r'(mask_partition|mask_matrix)_kernelI([a-z]?)Li(\d+)E')}
  if len(kernels) != 15:  # 2 id types x 5 key forms + 5 forms
    raise AssertionError(f'masking.cu: {len(kernels)} kernel instantiations '
                         'in the ptxas log, not 15')
  for (name, ids, c), r in sorted(kernels.items()):
    log(f'    {name:14s} {ids or "-"} C={c:2d}: {r["registers"]} registers, '
        f'{r["spill_bytes"]} bytes spilled, {r["stack_bytes"]} bytes stack')
    if r['spill_bytes'] or r['stack_bytes']:
      raise AssertionError(f'{name} (C={c}) spills {r["spill_bytes"]} bytes '
                           f'and keeps {r["stack_bytes"]} bytes of stack')
  return {name: kernels[(name, ids, 16)]
          for name, ids in (('mask_partition', 't'), ('mask_matrix', ''))}


# ---- phase 3: kernels vs plain versions ----


def attention_inputs(b, h, s, d, dtype, seed):
  g = torch.Generator(device=DEVICE).manual_seed(seed)
  shape = (b * h, s, d)
  q, k, v, do = (torch.randn(shape, generator=g, device=DEVICE).to(dtype)
                 for _ in range(4))
  g_lse = torch.randn((b * h, s), generator=g, device=DEVICE)
  lens = torch.randint(s // 2, s + 1, (b,), generator=g, device=DEVICE)
  mask = torch.arange(s, device=DEVICE)[None, :] < lens[:, None]
  return q, k, v, do, g_lse, mask


def bound(flops, moved, dtype):
  """(ms, 'operations' or 'bytes'): the least time the card could take."""
  t_flops, t_bytes = flops / PEAK_FLOPS[dtype], moved / PEAK_BYTES
  return 1e3 * max(t_flops, t_bytes), (
      'operations' if t_flops >= t_bytes else 'bytes')


def compare(label, kernel, plain, tol, rows=None):
  """Launch ``kernel`` twice and ``plain`` once on the same inputs: the two
  launches must be bitwise equal and the kernel within ``tol`` of the
  plain version (on ``rows`` of each output only, where given). Returns
  the largest absolute difference."""
  got, again, ref = kernel(), kernel(), plain()
  torch.cuda.synchronize()
  got, again, ref = ((t,) if torch.is_tensor(t) else t
                     for t in (got, again, ref))
  if not all(torch.equal(a, c) for a, c in zip(got, again)):
    raise AssertionError(f'{label}: two launches on the same inputs differ')
  err = 0.0
  for a, r in zip(got, ref):
    if rows is not None:
      a, r = a[rows], r[rows]
    torch.testing.assert_close(a.float(), r.float(), rtol=tol, atol=tol)
    err = max(err, float((a.float() - r.float()).abs().max()))
  return err


def sdpa_ms(q, k, v, g, attn_mask, shape):
  """Yardstick, never called by the port: milliseconds of PyTorch's
  scaled_dot_product_attention with the equivalent additive mask, forward
  (against fwd) and backward, dq, dk and dv together (against dq and
  dkv), pinned to the memory-efficient backend, the fused one that takes
  an additive mask, so that every call times the same kernels."""
  import torch.nn.functional as F
  from torch.nn.attention import SDPBackend, sdpa_kernel
  q4, k4, v4 = (t.view(shape).detach().requires_grad_() for t in (q, k, v))
  with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
    out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask)
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=attn_mask))
    bwd = cuda_ms(lambda: torch.autograd.grad(
        out, (q4, k4, v4), g.view(shape), retain_graph=True))
  return {'fwd': fwd, 'dq': bwd, 'dkv': bwd}


def check_kernels(tfa, cases, seed):
  """Every case: kernel vs plain, repeatability, timings. Returns the
  rows for the report."""
  rows = []
  for (b, h, s, d, dtype) in cases:
    q, k, v, do, g_lse, mask = attention_inputs(b, h, s, d, dtype, seed)
    bias = tfa.key_bias(mask, b, s, q.device)
    out, lse = tfa._fwd(q, k, v, bias, h)
    g, delta = tfa._backward_rows(do, g_lse, out, q)
    results = {
        'fwd': ((lambda: tfa._fwd(q, k, v, bias, h)),
                (lambda: tfa._fwd_plain(q, k, v, bias, h))),
        'dq': ((lambda: tfa._dq(q, k, v, bias, g, lse, delta, h)),
               (lambda: tfa._dq_plain(q, k, v, bias, g, lse, delta, h))),
        'dkv': ((lambda: tfa._dkv(q, k, v, bias, g, lse, delta, h)),
                (lambda: tfa._dkv_plain(q, k, v, bias, g, lse, delta, h))),
    }
    library = sdpa_ms(q, k, v, g, bias.to(dtype)[:, None, None, :],
                      (b, h, s, d))
    fwd_tol, grad_tol = TOL[dtype]
    for name, (kernel, plain) in results.items():
      tol = fwd_tol if name == 'fwd' else grad_tol
      err = compare(f'{name} {(b, h, s, d, dtype)}', kernel, plain, tol)
      bound_ms, bound_by = bound(
          *tfa.work(name, b, h, s, d, dtype, s * int(mask.sum())), dtype)
      rows.append({
          'name': name, 'shape': [b, h, s, d], 'dtype': str(dtype),
          'body': body(dtype), 'max_abs_err': err, 'tol': tol,
          'ms': cuda_ms(kernel), 'plain_ms': cuda_ms(plain),
          'library_ms': library[name],
          'bound_ms': bound_ms, 'bound_by': bound_by})
      r = rows[-1]
      log(f'  {name:3s} b={b:2d} h={h:2d} s={s:3d} d={d:3d} '
          f'{str(dtype):14s} [{r["body"]}] err={err:.3g} (tol {tol:g}) '
          f'bitwise-repeat=ok '
          f'kernel={r["ms"]:.3f}ms plain={r["plain_ms"]:.3f}ms '
          f'sdpa={r["library_ms"]:.3f}ms bound={r["bound_ms"]:.4f}ms '
          f'({r["bound_by"]}, {100 * r["bound_ms"] / r["ms"]:.1f}% of bound)')
  return rows


# ---- phase 4: segmented kernels (K4) vs plain versions ----


def segment_layout(b, s, docs, pad_tail, pad_row, rng):
  """``[b, s]`` int32 document ids: ``docs`` documents per row at random
  (so not tile-aligned) boundaries, a padded tail of up to a quarter of
  the row (-1), and the last row padding only if ``pad_row``."""
  seg = np.full((b, s), -1, np.int32)
  for r in range(b - 1 if pad_row else b):
    total = int(rng.integers(s * 3 // 4, s)) if pad_tail else s
    cuts = np.sort(rng.choice(np.arange(1, total), docs - 1, replace=False))
    seg[r, :total] = np.searchsorted(cuts, np.arange(total), side='right')
  return seg


def same_doc_pairs(seg):
  """(query, key) pairs of real tokens in the same document, summed over
  the rows of a ``[b, s]`` id array."""
  return int(sum((np.bincount(r[r >= 0]) ** 2).sum() for r in seg))


def check_seg_kernels(tfa, cases, seed):
  """Every case: segmented kernel vs plain on real rows (grads
  everywhere, with cotangents zero on padding rows as the model gives
  them), repeatability, the all-padding row, timings against the plain
  version, the segment-free kernel and SDPA, and the skip check."""
  rows = []
  for (b, h, s, d, dtype, docs, pad_tail, pad_row) in cases:
    rng = np.random.default_rng([seed, b, s, d, docs])
    seg_np = segment_layout(b, s, docs, pad_tail, pad_row, rng)
    q, k, v, do, g_lse, _ = attention_inputs(b, h, s, d, dtype, seed)
    seg = torch.from_numpy(seg_np).to(DEVICE)
    mask = seg >= 0
    real = mask.repeat_interleave(h, dim=0)  # [bh, s]: rows with an id
    do = torch.where(real[..., None], do, torch.zeros((), dtype=dtype,
                                                      device=DEVICE))
    g_lse = torch.where(real, g_lse, 0.0)
    bias = tfa.key_bias(mask, b, s, q.device)

    def intervals():
      # What an attention call computes once for its three kernels.
      segs = tfa.Segments(seg, seg)
      segs.launch_args(d)
      segs.launch_args(d, kv_owned=True)
      return segs

    segs = intervals()
    intervals_ms = cuda_ms(intervals)
    out, lse = tfa._fwd(q, k, v, bias, h, segs)
    g, delta = tfa._backward_rows(do, g_lse, out, q)
    calls = {
        'fwd': ((lambda: tfa._fwd(q, k, v, bias, h, segs)),
                (lambda: tfa._fwd_plain(q, k, v, bias, h, seg, seg)),
                (lambda: tfa._fwd(q, k, v, bias, h))),
        'dq': ((lambda: tfa._dq(q, k, v, bias, g, lse, delta, h, segs)),
               (lambda: tfa._dq_plain(q, k, v, bias, g, lse, delta, h, seg,
                                      seg)),
               (lambda: tfa._dq(q, k, v, bias, g, lse, delta, h))),
        'dkv': ((lambda: tfa._dkv(q, k, v, bias, g, lse, delta, h, segs)),
                (lambda: tfa._dkv_plain(q, k, v, bias, g, lse, delta, h, seg,
                                        seg)),
                (lambda: tfa._dkv(q, k, v, bias, g, lse, delta, h))),
    }
    if pad_row:
      pad = slice((b - 1) * h, b * h)
      if not (bool((out[pad] == 0).all()) and
              bool(torch.isfinite(lse[pad]).all())):
        raise AssertionError(f'{(b, h, s, d, dtype)}: the all-padding row '
                             'gives a nonzero out or a non-finite lse')
    zero = torch.zeros((), dtype=torch.float32, device=DEVICE)
    same = torch.where(seg[:, :, None] == seg[:, None, :], zero, tfa.NEG_INF)
    library = sdpa_ms(q, k, v, g, (bias[:, None, :] + same)[:, None].to(dtype),
                      (b, h, s, d))
    del same
    total, skipped = tfa.count_skippable_tiles(seg_np, head_dim=d)
    skip = skipped / total
    pairs = same_doc_pairs(seg_np)
    fwd_tol, grad_tol = TOL[dtype]
    for name, (kernel, plain, free) in calls.items():
      tol = fwd_tol if name == 'fwd' else grad_tol
      # out and lse on real rows only; the gradients everywhere.
      err = compare(f'{name}_seg {(b, h, s, d, dtype)}', kernel, plain, tol,
                    rows=real if name == 'fwd' else None)
      bound_ms, bound_by = bound(*tfa.work(name, b, h, s, d, dtype, pairs,
                                       seg=True), dtype)
      rows.append({
          'name': f'{name}_seg', 'shape': [b, h, s, d], 'dtype': str(dtype),
          'body': body(dtype), 'docs': docs, 'max_abs_err': err,
          'tol': tol,
          'skip_fraction': skip, 'ms': cuda_ms(kernel),
          'plain_ms': cuda_ms(plain, reps=5, warmup=1),
          'segment_free_ms': cuda_ms(free), 'intervals_ms': intervals_ms,
          'library_ms': library[name], 'bound_ms': bound_ms,
          'bound_by': bound_by})
      r = rows[-1]
      log(f'  {name:3s}_seg b={b} h={h:2d} s={s:4d} d={d:3d} docs={docs:2d} '
          f'{str(dtype):14s} [{r["body"]}] err={err:.3g} (tol {tol:g}) '
          f'bitwise-repeat=ok '
          f'skip={100 * skip:.1f}% kernel={r["ms"]:.3f}ms '
          f'segment-free={r["segment_free_ms"]:.3f}ms '
          f'plain={r["plain_ms"]:.3f}ms sdpa={r["library_ms"]:.3f}ms '
          f'bound={r["bound_ms"]:.4f}ms ({r["bound_by"]}, '
          f'{100 * r["bound_ms"] / r["ms"]:.2f}% of bound); tile intervals '
          f'{intervals_ms:.3f}ms once per call')
      if skip >= SKIP_CHECK_FRACTION and (
          r['ms'] > SKIP_SPEEDUP_MAX * r['segment_free_ms']):
        raise AssertionError(
            f'{name}_seg {(b, h, s, d, dtype)}: {100 * skip:.1f}% of tiles '
            f'skip but the kernel takes {r["ms"]:.3f} ms against the '
            f'segment-free {r["segment_free_ms"]:.3f} ms (limit '
            f'{SKIP_SPEEDUP_MAX}x): the skip is not an early-out')
    if pad_row:
      log('  all-padding row: out = 0, lse finite')
    del q, k, v, do, g, out, lse, delta, segs
  return rows


# ---- phase 5: training ----


@contextlib.contextmanager
def step_cache(on):
  """``LDDL_STEP_CACHE`` on (the default) or off for the runs inside."""
  old = os.environ.get('LDDL_STEP_CACHE')
  os.environ['LDDL_STEP_CACHE'] = '1' if on else '0'
  try:
    yield
  finally:
    if old is None:
      del os.environ['LDDL_STEP_CACHE']
    else:
      os.environ['LDDL_STEP_CACHE'] = old


def timed_run(loop, loader, start, steps):
  """(seconds per step, losses) of ``steps`` steps of ``loader`` from
  batch ``start``: host clock around TrainLoop.run, synchronised."""
  loop.loader = loader
  loader.start = start
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  losses = loop.run(loop.step + steps, log_every=0)
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) / len(losses), losses


def profile_steps(loop, loader, start, seq_len, step_ms, card, cache,
                  steps=2):
  """Device time by kernel over ``steps`` more steps of ``loader`` from
  batch ``start`` (torch.profiler), per step; the idle share is against
  the unprofiled ``step_ms`` measured before in the same cache mode
  (``cache``: 'on' or 'off'). The profiler sees the kernels of a CUDA
  graph replay by name, so the split holds with the cache on, and
  ``flash_calls_per_step`` counts each flash kernel's launches there."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  loop.loader = loader
  loader.start = start
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    loop.run(loop.step + steps, log_every=0)
    torch.cuda.synchronize()
  kernels = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
  busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
  launched = sum(e.count for e in kernels) / steps
  # The device's idle time between its kernels, split by gap length: gaps
  # of at most LAUNCH_GAP_US are the time from one kernel to the next of a
  # stream of launches (inside a replayed graph, its node latency); the
  # longer ones are the device waiting for the host.
  gaps = {'short': 0.0, 'long': 0.0}
  end = None
  for start, stop in sorted((e.time_range.start, e.time_range.end)
                            for e in prof.events()
                            if e.device_type == DeviceType.CUDA):
    if end is not None and start > end:
      gaps['short' if start - end <= LAUNCH_GAP_US else 'long'] += (
          start - end) / 1e3 / steps
    end = stop if end is None else max(end, stop)
  # The flash kernels' calls by name, counted by the profiler on the
  # device (graph replays included).
  flash_calls = {}
  for e in kernels:
    m = FLASH_KERNEL_NAME.search(e.key)
    if m:
      name = m.group(1) + ('_seg' if m.group(2) == 'true' else '')
      flash_calls[name] = flash_calls.get(name, 0) + e.count
  top = sorted(kernels, key=lambda e: e.self_device_time_total,
               reverse=True)[:12]
  rows = [{'kernel': e.key[:90], 'ms_per_step':
           e.self_device_time_total / 1e3 / steps,
           'calls_per_step': e.count / steps} for e in top]

  def share(pred):
    return sum(e.self_device_time_total for e in kernels
               if pred(e.key)) / 1e3 / steps

  attn = share(lambda k: 'flash_' in k and '_kernel' in k)
  # cuBLAS's Hopper GEMMs are named nvjet_* / *gemm* / cutlass_*.
  gemm = share(lambda k: any(t in k for t in ('nvjet', 'gemm', 'cutlass')))
  idle = 1 - busy / step_ms
  log(f'  profile s={seq_len} cache {cache}: device busy {busy:.2f} ms of '
      f'{step_ms:.2f} ms/step (idle {100 * idle:.1f}%): flash kernels '
      f'{attn:.2f} ms, GEMMs {gemm:.2f} ms, other {busy - attn - gemm:.2f} '
      f'ms; {launched:.0f} kernels/step; idle between kernels '
      f'{gaps["short"]:.2f} ms/step in gaps <= {LAUNCH_GAP_US} us, '
      f'{gaps["long"]:.2f} ms/step in longer ones [{card}]')
  for r in rows:
    log(f'    {r["ms_per_step"]:8.3f} ms  x{r["calls_per_step"]:<6g} '
        f'{r["kernel"]}')
  return {'device_busy_ms_per_step': busy, 'idle_share': idle,
          'flash_ms_per_step': attn, 'gemm_ms_per_step': gemm,
          'flash_calls_per_step': {k: v / steps
                                   for k, v in flash_calls.items()},
          'kernels_per_step': launched, 'short_gap_ms_per_step': gaps['short'],
          'long_gap_ms_per_step': gaps['long'], 'top_kernels': rows}


def check_launches(counts, host, want, label):
  """The kernels' own counts on the device over the main path (``counts``,
  graph replays included) are ``want``, and the wrappers' count
  (``host``: eager launches plus the launches the step cache recorded at
  capture, once per replay) agrees with them."""
  if counts != want:
    raise AssertionError(f'{label}: the kernels counted {counts} launches '
                         f'on the device; want {want} (12 per step of each '
                         'kernel of the path)')
  if host != counts:
    raise AssertionError(f'{label}: the wrappers and the step cache counted '
                         f'{host} launches, the device {counts}')
  log(f'  launches ({label}), counted by the kernels on the device (graph '
      f'replays included): {counts}; the wrappers\' count agrees')


def check_profiled_launches(prof, want, label):
  """The profiler saw ``want`` (name -> calls per step) of the flash
  kernels in its window, and no other flash kernel."""
  got = prof['flash_calls_per_step']
  if got != {k: v for k, v in want.items() if v}:
    raise AssertionError(f'{label}: the profiler saw flash kernel calls '
                         f'{got} per step; want {want}')
  log(f'  profiler ({label}, cache on): flash kernel calls per step {got}')


def check_cache(cache, misses, steps, label):
  """The step cache missed exactly once per bin (``misses``) and hit on
  every other of ``steps`` steps."""
  if cache is None:
    raise AssertionError(f'{label}: the step cache is off (LDDL_STEP_CACHE '
                         'set?); the main path runs with it on')
  if (cache.misses, cache.hits) != (misses, steps - misses):
    raise AssertionError(f'{label}: step cache misses {cache.misses}, hits '
                         f'{cache.hits} over {steps} steps; want {misses} '
                         f'miss(es), one per bin, and {steps - misses} hits')
  log(f'  step cache ({label}): {cache.misses} misses (one per bin, '
      f'{cache.retrace_seconds:.2f} s of eager step + capture), '
      f'{cache.hits} hits over {steps} steps')


def cache_line(label, on_ms, on_prof, off_ms, card):
  """The cache off runs the same kernels: its idle share is taken
  against the cache-on profile's busy time (profiled both ways, the two
  read the same busy time within 0.1 ms in every cell)."""
  busy = on_prof['device_busy_ms_per_step']
  log(f'  {label}: cache on {on_ms:.2f} ms/step, busy {busy:.2f} ms, idle '
      f'{100 * on_prof["idle_share"]:.1f}% | cache off {off_ms:.2f} '
      f'ms/step, idle {100 * (1 - busy / off_ms):.1f}% of it [{card}]')


class BinLoader:
  """Loader-format batches of one bin, made in numpy from a seed: ragged
  ``[CLS] A [SEP] B [SEP]`` rows, token types, dynamic 80/10/10 masks.
  Iterating yields the batches from ``start`` on."""

  def __init__(self, seq_len, batch_size, n, seed, mask_fn):
    self.batch_size = batch_size
    self.start = 0
    self.batches = [self._batch(seq_len, i, seed, mask_fn) for i in range(n)]

  def _batch(self, s, step, seed, mask_fn):
    b = self.batch_size
    rng = np.random.default_rng([seed, s, step])
    total = rng.integers(s // 2 + 1, s + 1, size=b)       # tokens per row
    na = rng.integers(1, total - 3, size=b, endpoint=True)  # A length
    cols = np.arange(s)[None, :]
    ids = rng.integers(MASK + 1, VOCAB_REAL, (b, s)).astype(np.int32)
    ids[:, 0] = CLS
    ids[np.arange(b), na + 1] = SEP
    ids[np.arange(b), total - 1] = SEP
    ids[cols >= total[:, None]] = PAD
    attention_mask = (cols < total[:, None]).astype(np.int32)
    special = (ids == PAD) | (ids == CLS) | (ids == SEP)
    ids, labels = mask_fn(ids, special, mlm_probability=0.15,
                          vocab_size=VOCAB_REAL, mask_id=MASK,
                          base_seed=seed, dp_rank=0, epoch=0, step=step)
    return {
        'input_ids': ids,
        'token_type_ids': ((cols >= (na + 2)[:, None]) &
                           (cols < total[:, None])).astype(np.int32),
        'attention_mask': attention_mask,
        'labels': labels,
        'next_sentence_labels': rng.integers(0, 2, b).astype(np.int32),
    }

  def __iter__(self):
    return iter(self.batches[self.start:])


class PackedLoader:
  """Packed block-diagonal batches of one bin: rows of ``[CLS] doc [SEP]
  doc [SEP] ...`` as preprocess/packed.py writes them (np.save-wire uint16
  ``input_ids`` and ``doc_offsets``), made in numpy from a seed and
  collated by the port's PackedCollate(block_diagonal=True) with dynamic
  masking. A row fills 3/4 to all of the bin (the rest is padding) with
  PACKED_DOCS documents per 8192 tokens, log-normal lengths. Iterating
  yields the batches from ``start`` on."""

  class Tokenizer:
    cls_token_id, sep_token_id, mask_token_id, pad_token_id = (CLS, SEP,
                                                               MASK, PAD)
    vocab_size = VOCAB_REAL

  def __init__(self, seq_len, batch_size, n, seed):
    from lddl_tpu_torch.loader.packed import PackedCollate
    self.batch_size = batch_size
    self.start = 0
    collate = PackedCollate(self.Tokenizer(), base_seed=seed,
                            block_diagonal=True)
    self.batches = [collate(self._rows(seq_len, i, seed), seq_len, epoch=0,
                            step=i) for i in range(n)]

  def _rows(self, s, step, seed):
    from lddl_tpu_torch.core.utils import serialize_np_array
    rng = np.random.default_rng([seed, s, step, 1])
    lo, hi = (max(1, round(n * s / 8192)) for n in PACKED_DOCS)
    rows = []
    for _ in range(self.batch_size):
      total = int(rng.integers(s * 3 // 4, s + 1))
      k = int(rng.integers(lo, hi + 1))
      w = rng.lognormal(0.0, 0.6, k)
      pieces = np.maximum(1, (w / w.sum() * (total - 1 - k)).astype(int))
      pieces[-1] += total - 1 - k - pieces.sum()  # the row holds `total`
      ids, marks = [CLS], []
      for n in pieces:
        marks.append(len(ids))
        ids += rng.integers(MASK + 1, VOCAB_REAL, n).tolist() + [SEP]
      rows.append({
          'input_ids': serialize_np_array(np.asarray(ids, np.uint16)),
          'doc_offsets': serialize_np_array(np.asarray(marks, np.uint16))})
    return rows

  def __iter__(self):
    return iter(self.batches[self.start:])


def check_vocab():
  with open(VOCAB_FILE) as f:
    tokens = f.read().split('\n')[:5]
  want = {'[PAD]': PAD, '[CLS]': CLS, '[SEP]': SEP, '[MASK]': MASK}
  got = {t: i for i, t in enumerate(tokens) if t in want}
  if got != want:
    raise AssertionError(f'{VOCAB_FILE}: special ids {got}, want {want}')


def train(args, card):
  from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.models.flops import peak_flops_per_device
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.training import MODEL_SIZES, TrainLoop

  check_vocab()
  cfg = BertConfig(attention_impl='flash', dtype=torch.bfloat16,
                   **MODEL_SIZES[MODEL])
  steps_per_bin = args.warmup + args.steps
  build = dict(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
               warmup_steps=10, total_steps=1000, seed=args.seed,
               max_predictions=args.max_predictions)
  loop = TrainLoop.build(**build)
  # Per bin: warm-up and timed steps, 2 profiled steps, 2 for the
  # save/restore check, and the last batch for the dense comparison.
  loaders = [BinLoader(s, b, steps_per_bin + 5, args.seed, dynamic_mask_tokens)
             for s, b in BINS]
  peak = peak_flops_per_device()

  # The main path: counts at 0 just before, read just after.
  tfa.reset_launches()
  per_bin = []
  all_losses = []
  for (s, b), loader in zip(BINS, loaders):
    loop.loader = loader
    loader.start = 0
    all_losses += loop.run(loop.step + args.warmup, log_every=0)
    dt, losses = timed_run(loop, loader, args.warmup, args.steps)
    all_losses += losses
    mfu = loop.flops_per_step(b, s) / dt / peak
    per_bin.append({'seq_len': s, 'batch': b, 'ms_per_step': 1e3 * dt,
                    'samples_per_s': b / dt, 'mfu': mfu,
                    'losses': losses})
    log(f'  bin s={s} b={b}: {1e3 * dt:.2f} ms/step, {b / dt:.1f} '
        f'samples/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s bf16 [{card}]; '
        f'losses {losses[0]:.4f} -> {losses[-1]:.4f}')
  counts = tfa.device_launches()
  host = dict(tfa.launches)
  total_steps = len(all_losses)
  if not all(np.isfinite(all_losses)):
    raise AssertionError(f'non-finite loss in {all_losses}')
  if loop.stop_reason is not None:
    raise AssertionError(f'run stopped early: {loop.stop_reason}')
  per_step = {'fwd': cfg.num_layers, 'dq': cfg.num_layers,
              'dkv': cfg.num_layers, 'fwd_seg': 0, 'dq_seg': 0, 'dkv_seg': 0}
  check_launches(counts, host,
                 {k: n * total_steps for k, n in per_step.items()},
                 f'bins, {total_steps} steps')
  cache = loop.step_cache
  check_cache(cache, len(BINS), total_steps, 'bins')

  # The same steps with the cache off, then profiled with it on.
  for bin_stats, loader in zip(per_bin, loaders):
    with step_cache(False):
      dt_off, _ = timed_run(loop, loader, args.warmup, args.steps)
    bin_stats['ms_per_step_cache_off'] = 1e3 * dt_off
    bin_stats['profile'] = profile_steps(
        loop, loader, steps_per_bin, bin_stats['seq_len'],
        bin_stats['ms_per_step'], card, 'on')
    check_profiled_launches(bin_stats['profile'], per_step,
                            f'bin s={bin_stats["seq_len"]}')
  for bin_stats in per_bin:
    cache_line(f'bin s={bin_stats["seq_len"]} b={bin_stats["batch"]}',
               bin_stats['ms_per_step'], bin_stats['profile'],
               bin_stats['ms_per_step_cache_off'], card)
  # Bins switched back and forth since the first pass: no new miss.
  if cache.misses != len(BINS):
    raise AssertionError(f'step cache missed {cache.misses} times after '
                         f'the first pass over {len(BINS)} bins')

  flash_vs_dense(loop, cfg, loaders[1].batches[-1], args.max_predictions,
                 'the s=512 batch')
  check_timed_graphs(loop, [(loader, 0, 3) for loader in loaders],
                     'both bins')
  check_graph_vs_eager(loop, build, [(loader, 0, 3) for loader in loaders],
                       'both bins')
  check_resume(loop, build, loaders[1], steps_per_bin + 2)
  for bin_stats, loader in zip(per_bin, loaders):
    bin_stats['step_costs'] = check_telemetry(
        loop, loader, 0, f'bin s={bin_stats["seq_len"]} b='
        f'{bin_stats["batch"]}', card)
  return per_bin, counts


def flash_vs_dense(loop, cfg, batch, max_predictions, label):
  """One step, flash vs dense attention, from the same weights and batch:
  loss and gradient norm within DENSE_LOSS_RTOL / DENSE_GRAD_NORM_RTOL."""
  from lddl_tpu_torch.models import BertForPretraining
  from lddl_tpu_torch.parallel.train import global_norm, pretrain_loss
  batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
  dense = BertForPretraining(
      dataclasses.replace(cfg, attention_impl='dense')).to(DEVICE)
  dense.load_state_dict(loop.model.state_dict())
  got = {}
  for name, model in (('flash', loop.model), ('dense', dense)):
    model.zero_grad(set_to_none=True)
    loss, _ = pretrain_loss(model, batch, max_predictions=max_predictions)
    loss.backward()
    got[name] = (float(loss.detach()), float(global_norm(
        [p.grad for p in model.parameters()])))
    model.zero_grad(set_to_none=True)
  del dense
  (fl, fg), (dl, dg) = got['flash'], got['dense']
  if abs(fl - dl) > DENSE_LOSS_RTOL * abs(dl) or (
      abs(fg - dg) > DENSE_GRAD_NORM_RTOL * abs(dg)):
    raise AssertionError(f'flash vs dense ({label}): loss {fl} vs {dl}, '
                         f'grad_norm {fg} vs {dg}')
  log(f'  flash vs dense ({label}): loss {fl:.6f} vs {dl:.6f}, '
      f'grad_norm {fg:.4f} vs {dg:.4f} (rtol {DENSE_LOSS_RTOL}, '
      f'{DENSE_GRAD_NORM_RTOL})')


@contextlib.contextmanager
def recorded_grad_norms(loop):
  """The grad norms of the steps ``loop`` runs inside, read from each
  step's metrics as the loop reads its loss."""
  norms = []
  saved = loop.step_cache, loop.step_fn

  def recording(fn):
    def step(batch, dropout_seed):
      metrics = fn(batch, dropout_seed)
      norms.append(float(metrics['grad_norm']))
      return metrics
    return step

  loop.step_cache, loop.step_fn = (recording(f) for f in saved)
  try:
    yield norms
  finally:
    loop.step_cache, loop.step_fn = saved


def check_timed_graphs(loop, runs, label):
  """The main path's own graphs, captured and timed with deterministic
  algorithms off, against eager steps: from one checkpoint of ``loop``,
  graph, eager, and eager again, each run ``runs`` ((loader, start,
  steps) in turn) with dropout on. Per-step loss and grad_norm, and the
  parameter update over the run, must agree within NONDET_*_RTOL, graph
  vs eager and eager vs eager (the run-to-run spread the tolerances are
  sized from); the graphs must be the main path's (no new miss)."""
  cache = loop.step_cache
  misses = cache.misses
  got = {}
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_timed_') as ckpt:
    loop.save(ckpt)
    theta0 = [p.detach().clone() for p in loop.model.parameters()]
    for mode in ('graph', 'eager', 'eager again'):
      loop.restore(ckpt)
      losses = []
      with step_cache(mode == 'graph'), recorded_grad_norms(loop) as norms:
        for loader, start, steps in runs:
          loop.loader = loader
          loader.start = start
          losses += loop.run(loop.step + steps, log_every=0)
      got[mode] = (losses, norms,
                   [p.detach().clone() for p in loop.model.parameters()])
  if cache.misses != misses:
    raise AssertionError(f'timed graphs ({label}): the cache missed '
                         f'{cache.misses - misses} more times; the main '
                         "path's graphs were not replayed")

  def norm(ts):
    return float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in ts])))

  def rel(xs, ys):
    return max(abs(x - y) / abs(y) for x, y in zip(xs, ys))

  (e_loss, e_norms, e_theta) = got['eager']
  update = norm([t - t0 for t, t0 in zip(e_theta, theta0)])
  for mode in ('graph', 'eager again'):
    losses, norms, theta = got[mode]
    d = (rel(losses, e_loss), rel(norms, e_norms),
         norm([a - b for a, b in zip(theta, e_theta)]) / update)
    line = (f'{mode} vs eager ({label}, deterministic algorithms off, '
            f'dropout 0.1, {len(losses)} steps from one checkpoint): '
            f'loss rel diff {d[0]:.3e}, grad_norm {d[1]:.3e}, update '
            f'{d[2]:.3e} (limits {NONDET_LOSS_RTOL}, {NONDET_GRAD_NORM_RTOL}'
            f', {NONDET_UPDATE_RTOL}; bit-equal: '
            f'{losses == e_loss and norms == e_norms})')
    if (d[0] > NONDET_LOSS_RTOL or d[1] > NONDET_GRAD_NORM_RTOL
        or d[2] > NONDET_UPDATE_RTOL):
      raise AssertionError(line)
    log(f'  {line}')
  del got, theta0
  torch.cuda.empty_cache()


def check_graph_vs_eager(loop, build, runs, label):
  """Fresh loops restored from one checkpoint of ``loop``, with the step
  cache on and off, each without and with remat, each run ``runs``
  ((loader, start, steps) in turn) with dropout on: losses and state
  digests must be equal bit for bit, so a replayed graph computes what an
  eager step computes, its dropout masks included (reseeded before each
  replay), and a rematerialized layer's recompute redraws its forward's
  masks (from its twin generator). Deterministic algorithms are on in
  all, as for resume."""
  from lddl_tpu_torch.training import TrainLoop
  if build['model_cfg'].dropout_rate != 0.1:
    raise AssertionError('graph vs eager runs with dropout 0.1')
  got = {}
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    with tempfile.TemporaryDirectory(prefix='lddl_smoke_gve_') as ckpt:
      loop.save(ckpt)
      for remat in (False, True):
        cfg = dataclasses.replace(build['model_cfg'], remat=remat)
        for on in (True, False):
          with step_cache(on):
            fresh = TrainLoop.build(**dict(build, model_cfg=cfg)).restore(
                ckpt)
            losses = []
            for loader, start, steps in runs:
              fresh.loader = loader
              loader.start = start
              losses += fresh.run(fresh.step + steps, log_every=0)
            cache = fresh.step_cache
            got[remat, on] = (losses, fresh.state_digest(), None if
                              cache is None else (cache.misses, cache.hits))
            del fresh, cache
            torch.cuda.empty_cache()
  finally:
    torch.use_deterministic_algorithms(False)
  steps = sum(n for _, _, n in runs)
  want = {True: (len(runs), steps - len(runs)), False: None}
  graph, digest, _ = got[False, True]
  for (remat, on), (losses, dig, counts) in got.items():
    if counts != want[on]:
      raise AssertionError(f'graph vs eager ({label}, remat {remat}): cache '
                           f'counts {counts}, want {want[on]}')
    if losses != graph or dig != digest:
      raise AssertionError(f'graph vs eager ({label}): remat {remat}, cache '
                           f'{"on" if on else "off"} gives losses {losses}, '
                           f'the graph without remat {graph}, or state '
                           'digests differ')
  log(f'  graph vs eager ({label}, dropout 0.1, {steps} steps from one '
      f'checkpoint, cache on and off, without and with remat): losses '
      f'{graph} and the state digest equal bit for bit')


def check_resume(loop, build, loader, start, steps=2):
  """Save, ``steps`` more steps from batch ``start`` of ``loader``; restore
  into a fresh loop, and into the same loop, the same steps: losses and
  state digest must equal the uninterrupted run bit for bit. The step
  cache is on: the same loop replays the graphs it captured before the
  restore (no new miss)."""
  from lddl_tpu_torch.training import TrainLoop
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    with tempfile.TemporaryDirectory(prefix='lddl_smoke_ckpt_') as ckpt:
      loop.loader = loader
      loader.start = start
      loop.save(ckpt)
      at = loop.step
      straight = loop.run(at + steps, log_every=0)
      digest = loop.state_digest()
      misses = loop.step_cache.misses
      loop.restore(ckpt)
      loader.start = start
      replayed = loop.run(at + steps, log_every=0)
      same_loop = (replayed == straight and loop.state_digest() == digest
                   and loop.step_cache.misses == misses)
      resumed = TrainLoop.build(**build).restore(ckpt)
      resumed.loader = loader
      loader.start = start
      again = resumed.run(at + steps, log_every=0)
      same_digest = resumed.state_digest() == digest
      cached = resumed.step_cache is not None
      del resumed
  finally:
    torch.use_deterministic_algorithms(False)
  if again != straight or not same_digest or not same_loop or not cached:
    raise AssertionError(f'resumed losses {again} (same loop: {replayed}) '
                         f'!= uninterrupted {straight}, or state digests or '
                         'cache misses differ, or the cache was off')
  log(f'  save at step {at}, restore, {steps} steps (cache on): losses '
      f'{again} and the state digest equal the uninterrupted run bit for '
      'bit, in a fresh loop and in the same loop (its graphs replayed)')


def device_busy_us(trace_dir):
  """Device-busy microseconds in a torch.profiler Chrome trace: the union
  of its kernels', copies' and sets' intervals."""
  with open(os.path.join(trace_dir, 'trace.json')) as f:
    events = json.load(f)['traceEvents']
  spans = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                 if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'))
  busy, end = 0.0, None
  for a, b in spans:
    if end is None or a > end:
      busy += b - a
      end = b
    elif b > end:
      busy += b - end
      end = b
  return busy


def expected_flops(loop, batch):
  """The count's matmul and flash FLOPs a step of ``batch`` should have:
  the analytic count at the run's max_predictions (models/flops.py) with
  its attention term (4 b s^2 d a layer forward, x3) replaced by what the
  kernels compute (tfa.work: fwd's 2, dq's 3 and dkv's 4 products over
  every pair, or a packed batch's computed 64 x 64 tiles), plus the NSP
  head's 2 b d 2 x3 that the analytic count leaves out. The analytic
  count ignores BertConfig.ablate, as lddl_tpu's does; an ablated model's
  dropped terms come off it: under 'attention-core' the q and k
  projections (2 x 2 b s d^2 a layer forward, x3) and every kernel term,
  under 'ffn' the FFN's two projections (2 x 2 b s d d_ff, x3); 'norms'
  and 'gelu' drop no matmul."""
  from lddl_tpu_torch.ops import flash_attention as tfa
  cfg = loop.model.cfg
  b, s = batch['input_ids'].shape
  d, h, dh, layers = (cfg.hidden_size, cfg.num_heads, cfg.head_dim,
                      cfg.num_layers)
  if 'segment_ids' in batch:
    total, skipped = tfa.count_skippable_tiles(batch['segment_ids'],
                                               head_dim=dh)
    pairs = (total - skipped) * tfa.TILE_ROWS * tfa.stream_rows(dh)
  else:
    pairs = b * s * s
  flash = layers * sum(tfa.work(k, b, h, s, dh, cfg.dtype, pairs)[0]
                       for k in ('fwd', 'dq', 'dkv'))
  dropped = 0
  if cfg.ablate == 'attention-core':
    dropped, flash = 12 * b * s * d * d * layers, 0
  elif cfg.ablate == 'ffn':
    dropped = 12 * b * s * d * cfg.intermediate_size * layers
  return (loop.flops_per_step(b, s) - 12 * b * s * s * d * layers +
          2 * b * d * 2 * 3 + flash - dropped)


def check_telemetry(loop, loader, start, label, card, steps=4):
  """With telemetry and trace on, the phase's ``loop`` with a fresh step
  cache runs ``steps`` steps, the StepProfiler armed for the last 2
  (reusing the loop spares a BERT-base build): export_telemetry must
  write both files,
  the telemetry holding the train.step_cache_* counters, train.mfu and
  non-zero hbm.* gauges, and the profiler exactly one trace. The step
  cost model: the file's train.xla_flops / train.xla_bytes are the sum of
  the steps' bills (the miss's count, a packed step's K4 part scaled by
  its own tiles), the count's matmul and flash FLOPs are
  expected_flops' to STEP_FLOPS_RTOL, the profiled steps' billed FLOPs
  over their device-busy time are at most the card's bf16 peak, and the
  roofline verdict over the file names a bound class."""
  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.models.flops import machine_balance
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.telemetry import diff_snapshot_lines
  from lddl_tpu_torch.telemetry.report import merge_metric_lines
  from lddl_tpu_torch.telemetry.roofline import roofline_verdict
  from lddl_tpu_torch.training import export_telemetry
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_tele_') as out:
    os.environ['LDDL_TELEMETRY_DIR'] = out
    telemetry.enable()
    telemetry.enable_trace()
    try:
      loop.step_cache = None  # a fresh cache, made with telemetry on
      loop.loader = loader
      loader.start = start
      loop.run(loop.step + 1, log_every=0)  # the miss
      after_miss = telemetry.get_telemetry().snapshot_lines()
      # The hits; the profiler starts at the first one's boundary (run()
      # stops a capture in flight when it returns) and takes the next 2.
      telemetry.get_step_profiler().arm(2)
      loader.start = start + 1
      loop.run(loop.step + steps - 1, log_every=0)
      hits = merge_metric_lines([diff_snapshot_lines(
          after_miss, telemetry.get_telemetry().snapshot_lines())])
      (costs,) = loop.step_cache._costs.values()
      batches = loader.batches[start:start + steps]
      want_flops = expected_flops(loop, batches[0])
      analytic = loop.flops_per_step(*batches[0]['input_ids'].shape)
      paths = sorted(os.path.basename(p) for p in export_telemetry())
      with open(os.path.join(out, 'telemetry.rank0.jsonl')) as f:
        raw = [json.loads(x) for x in f]
      lines = {x['name']: x for x in raw if x['kind'] != 'meta'}
      profiles = os.path.join(out, 'profiles')
      captures = sorted(os.listdir(profiles))
      traced = [os.path.isfile(os.path.join(profiles, c, 'trace.json'))
                for c in captures]
      busy_us = (device_busy_us(os.path.join(profiles, captures[0]))
                 if traced == [True] else 0.0)
    finally:
      telemetry.disable()
      telemetry.disable_trace()
      del os.environ['LDDL_TELEMETRY_DIR']
  want = {'train.step_cache_misses': 1, 'train.step_cache_hits': steps - 1}
  got = {k: lines.get(k, {}).get('total') for k in want}
  hbm = {k: lines.get(f'hbm.{k}', {}).get('value') for k in
         ('bytes_in_use', 'peak_bytes_in_use', 'bytes_limit',
          'headroom_frac')}
  mfu = lines.get('train.mfu', {})
  if (paths != ['telemetry.rank0.jsonl', 'trace.rank0.jsonl'] or got != want
      or mfu.get('count') != steps or not mfu.get('value')
      or not all(hbm.values()) or traced != [True]):
    raise AssertionError(f'telemetry: files {paths}, cache counters {got} '
                         f'(want {want}), train.mfu {mfu}, hbm {hbm}, '
                         f'profiler captures {captures}')
  log(f'  telemetry: {paths} with cache counters {got}, train.mfu '
      f'{mfu["value"]:.4f} (last step, profiled), hbm.bytes_in_use '
      f'{hbm["bytes_in_use"] / 2**30:.2f} GiB, peak '
      f'{hbm["peak_bytes_in_use"] / 2**30:.2f} of '
      f'{hbm["bytes_limit"] / 2**30:.2f} GiB (headroom '
      f'{100 * hbm["headroom_frac"]:.1f}%); profiler wrote {captures[0]}/'
      'trace.json')

  # The step cost model: a packed step billed the tiles its K4 launches
  # compute, on the fwd/dq grid and on dkv's.
  def computed_tiles(batch):
    return tfa.ring_tiles(batch['segment_ids'],
                          head_dim=loop.model.cfg.head_dim)[1:]

  bills = [costs.bill(computed_tiles(x) if costs.seg_flops else None)
           for x in batches]
  totals = {k: lines.get(f'train.xla_{k}', {}).get('total')
            for k in ('flops', 'bytes')}
  want_totals = {'flops': sum(x[0] for x in bills),
                 'bytes': sum(x[1] for x in bills)}
  if any(totals[k] is None or abs(totals[k] - want_totals[k]) >
         1e-12 * want_totals[k] for k in totals):
    raise AssertionError(f'{label}: train.xla_flops / xla_bytes {totals}; '
                         f'want the steps\' bills {want_totals}')
  counted = costs.matmul_flops + costs.flash_flops
  if abs(counted - want_flops) > STEP_FLOPS_RTOL * want_flops:
    raise AssertionError(f'{label}: the count\'s matmul + flash FLOPs '
                         f'{counted:.6e} (matmul {costs.matmul_flops:.6e}, '
                         f'flash {costs.flash_flops:.6e}); want '
                         f'{want_flops:.6e} within {STEP_FLOPS_RTOL}')
  # The profiler ran over the last two steps.
  if not busy_us:
    raise AssertionError(f'{label}: the profiler\'s trace shows no device '
                         'activity')
  profiled = bills[-2][0] + bills[-1][0]
  rate = profiled / (busy_us * 1e-6)
  byte_rate = (bills[-2][1] + bills[-1][1]) / (busy_us * 1e-6)
  if rate > PEAK_FLOPS[torch.bfloat16]:
    raise AssertionError(f'{label}: {profiled:.4e} counted FLOPs over '
                         f'{busy_us:.0f} us device-busy is {rate / 1e12:.1f} '
                         'TFLOP/s, above the card\'s bf16 peak: the count '
                         'is wrong')
  merged = merge_metric_lines([raw])
  verdict = roofline_verdict(merged,
                             merged['metrics']['train.step_seconds']['sum'])
  if verdict['bound'].startswith('unknown'):
    raise AssertionError(f'{label}: roofline verdict over the file '
                         f'{verdict}')
  # The verdict the live monitor would give over the hits alone.
  hits_s = hits['metrics']['train.step_seconds']['sum']
  live = roofline_verdict(hits, hits_s)
  peak = PEAK_FLOPS[torch.bfloat16]
  result = {
      'label': label, 'flops_per_step': costs.flops,
      'matmul_flops': costs.matmul_flops, 'flash_flops': costs.flash_flops,
      'seg_flops': costs.seg_flops, 'other_flops': costs.other_flops,
      'bytes_per_step': costs.bytes, 'expected_flops': want_flops,
      'analytic_flops': analytic, 'bills': bills,
      'busy_ms_per_step': busy_us / 2e3,
      'flops_per_busy_s': rate, 'bytes_per_busy_s': byte_rate,
      'bound': verdict['bound'], 'hits_bound': live['bound'],
      'hits_flops_frac': live['flops_frac'], 'hits_bw_frac': live['bw_frac'],
      'arithmetic_intensity': verdict['arithmetic_intensity'],
      'machine_balance': machine_balance(),
      'hits_ms_per_step': hits_s / (steps - 1) * 1e3,
      'mfu_counted': sum(x[0] for x in bills[1:]) / (hits_s * peak),
      'mfu_analytic': (steps - 1) * analytic / (hits_s * peak)}
  log(f'  step costs ({label}): {costs.flops:.4e} FLOPs a step (matmul '
      f'{costs.matmul_flops:.4e}, flash {costs.flash_flops:.4e} of which K4 '
      f'{costs.seg_flops:.4e}, elementwise {costs.other_flops:.4e}), '
      f'{costs.bytes / 1e9:.3f} GB of operands; matmul + flash = expected '
      f'{want_flops:.6e} (analytic {analytic:.4e} + recompute + NSP) to '
      f'{abs(counted - want_flops) / want_flops:.1e}; totals over {steps} '
      f'steps = the bills [{card}]')
  log(f'  step costs ({label}): {rate / 1e12:.1f} TFLOP/s and '
      f'{byte_rate / 1e12:.2f} TB/s of operands over '
      f'{busy_us / 2e3:.2f} ms device-busy a profiled step; verdict over '
      f'the file {verdict["bound"]}, over the {steps - 1} hits '
      f'({result["hits_ms_per_step"]:.2f} ms/step, profiled) '
      f'{live["bound"]}: flops_frac {live["flops_frac"]:.4f}, bw_frac '
      f'{live["bw_frac"]:.4f}, intensity '
      f'{verdict["arithmetic_intensity"]:.1f} FLOPs/byte vs balance '
      f'{machine_balance():.1f}; MFU over the hits counted '
      f'{result["mfu_counted"]:.4f} vs analytic '
      f'{result["mfu_analytic"]:.4f} [{card}]')
  return result


# ---- phase 6: packed long-context training ----


def train_packed(args, card):
  """BERT-base at s=8192 on packed block-diagonal batches through
  TrainLoop.run; returns the phase's numbers and the launch counts read
  just after its warm-up and timed steps."""
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.models.flops import peak_flops_per_device
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.training import MODEL_SIZES, TrainLoop

  from lddl_tpu_torch.telemetry import sample_hbm

  s, b, max_predictions = PACKED
  torch.cuda.reset_peak_memory_stats()
  # The JAX CLI sizes the position table max(max_seq_length, 512).
  cfg = BertConfig(attention_impl='flash', dtype=torch.bfloat16,
                   max_position_embeddings=max(s, 512), **MODEL_SIZES[MODEL])
  build = dict(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
               warmup_steps=10, total_steps=1000, seed=args.seed,
               max_predictions=max_predictions, max_seq_length=s)
  loop = TrainLoop.build(**build)
  n_main = args.packed_warmup + args.packed_steps
  # Warm-up and timed steps, 2 profiled, 2 for the save/restore check.
  loader = PackedLoader(s, b, n_main + 4, args.seed)
  peak = peak_flops_per_device()

  # The main path: counts at 0 just before, read just after.
  tfa.reset_launches()
  loop.loader = loader
  loader.start = 0
  losses = loop.run(args.packed_warmup, log_every=0)
  dt, timed = timed_run(loop, loader, args.packed_warmup, args.packed_steps)
  counts = tfa.device_launches()
  host = dict(tfa.launches)
  losses += timed
  if not all(np.isfinite(losses)):
    raise AssertionError(f'non-finite packed loss in {losses}')
  if loop.stop_reason is not None:
    raise AssertionError(f'packed run stopped early: {loop.stop_reason}')
  per_step = {'fwd': 0, 'dq': 0, 'dkv': 0, 'fwd_seg': cfg.num_layers,
              'dq_seg': cfg.num_layers, 'dkv_seg': cfg.num_layers}
  check_launches(counts, host,
                 {k: n * len(losses) for k, n in per_step.items()},
                 f'packed, {len(losses)} steps')
  check_cache(loop.step_cache, 1, len(losses), 'packed')
  with step_cache(False):
    dt_off, _ = timed_run(loop, loader, args.packed_warmup,
                          args.packed_steps)

  timed_batches = loader.batches[args.packed_warmup:n_main]
  seg = np.concatenate([x['segment_ids'] for x in timed_batches])
  real_tokens = float(np.mean([x['attention_mask'].sum()
                               for x in timed_batches]))
  pairs = same_doc_pairs(seg) / len(timed_batches)
  total, skipped = tfa.count_skippable_tiles(seg, head_dim=cfg.head_dim)
  flops = loop.flops_per_step(b, s)
  # models/flops.py counts attention over all b*s*s pairs: 4 FLOPs per
  # pair and feature per layer forward (QK^T and PV), x3 with backward.
  per_pair = 3 * cfg.num_layers * 4 * cfg.hidden_size
  flops_same_doc = flops - per_pair * (b * s * s - pairs)
  stats = {
      'seq_len': s, 'batch': b, 'max_predictions': max_predictions,
      'ms_per_step': 1e3 * dt, 'samples_per_s': b / dt,
      'real_tokens_per_s': real_tokens / dt,
      'docs_per_row': float(np.mean([r.max() + 1 for r in seg])),
      'real_token_share': real_tokens / (b * s),
      'skip_fraction': skipped / total,
      'mfu_dense_count': flops / dt / peak,
      'mfu_same_doc': flops_same_doc / dt / peak,
      'ms_per_step_cache_off': 1e3 * dt_off,
      'losses': timed}
  log(f'  packed s={s} b={b}: {1e3 * dt:.2f} ms/step, {b / dt:.2f} '
      f'samples/s, {real_tokens / dt:.0f} real tokens/s '
      f'({100 * stats["real_token_share"]:.1f}% of the bin real, '
      f'{stats["docs_per_row"]:.1f} docs/row, '
      f'{100 * stats["skip_fraction"]:.1f}% of attention tiles skipped) '
      f'[{card}]')
  log(f'  packed MFU of 989 TFLOP/s bf16: {100 * stats["mfu_dense_count"]:.2f}% '
      f'with dense-count FLOPs (models/flops.py, {flops / 1e12:.2f} TFLOP/step), '
      f'{100 * stats["mfu_same_doc"]:.2f}% with attention over same-document '
      f'pairs only ({flops_same_doc / 1e12:.2f} TFLOP/step); losses '
      f'{timed[0]:.4f} -> {timed[-1]:.4f}')

  stats['profile'] = profile_steps(loop, loader, n_main, s, 1e3 * dt, card,
                                   'on')
  check_profiled_launches(stats['profile'], per_step, f'packed s={s}')
  cache_line(f'packed s={s} b={b}', stats['ms_per_step'], stats['profile'],
             stats['ms_per_step_cache_off'], card)
  if loop.step_cache.misses != 1:
    raise AssertionError(f'packed step cache missed '
                         f'{loop.step_cache.misses} times')
  flash_vs_dense(loop, cfg, PackedLoader(*PACKED_DENSE, 1, args.seed).batches[0],
                 max_predictions, f'a packed s={PACKED_DENSE[0]} batch')
  check_timed_graphs(loop, [(loader, 0, 3)], 'packed rows')
  check_graph_vs_eager(loop, build, [(loader, 0, 3)], 'packed rows')
  check_resume(loop, build, loader, n_main + 2)
  stats['hbm'] = hbm = sample_hbm()
  log(f'  card memory over the packed phase: peak '
      f'{hbm["peak_bytes_in_use"] / 2**30:.2f} of '
      f'{hbm["bytes_limit"] / 2**30:.2f} GiB reserved (headroom '
      f'{100 * hbm["headroom_frac"]:.1f}%; graph pools included)')
  stats['step_costs'] = check_telemetry(loop, loader, 0,
                                        f'packed s={s} b={b}', card)
  return stats, counts


# ---- phase 21: BertConfig.ablate at BERT-base width ----

ABLATE_VALUES = ('attention-core', 'ffn', 'norms', 'gelu')
# Profiled steps a bin, after phase 5's warm-up (the miss, counted with
# telemetry on, first) and timed steps: timed_run's ms/step holds run()'s
# start and end, so the same counts as phase 5's compare like with like.
ABLATE_PROFILED = 2


def ablations(args, card, per_bin):
  """Phase 21: each ablation of BertConfig.ablate built at full width
  from the run's seed and trained at phase 5's bins (bf16, flash, dropout
  0.1, the step cache on) through TrainLoop.run, launch counts at 0 just
  before and read just after: finite losses, one cache miss a bin, 12
  launches a step of each of K1-K3 (none under 'attention-core', which
  must skip the attention; none of K4), the same per step in the
  profiler, and the miss's counted matmul + flash FLOPs = the ablated
  expected_flops to STEP_FLOPS_RTOL. Prints each ablation's ms/step and
  device-busy ms a bin beside phase 5's (``per_bin``): the difference is
  the dropped component's cost."""
  import gc

  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.training import MODEL_SIZES, TrainLoop
  warmup, timed, profiled = args.warmup, args.steps, ABLATE_PROFILED
  loaders = [BinLoader(s, b, warmup + timed + profiled, args.seed,
                       dynamic_mask_tokens) for s, b in BINS]
  out = []
  for ablate in ABLATE_VALUES:
    t0 = time.perf_counter()
    cfg = BertConfig(attention_impl='flash', dtype=torch.bfloat16,
                     ablate=ablate, **MODEL_SIZES[MODEL])
    loop = TrainLoop.build(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
                           warmup_steps=10, total_steps=1000, seed=args.seed,
                           max_predictions=args.max_predictions)
    label = f'21 {ablate}'
    # The main path: counts at 0 just before, read just after.
    tfa.reset_launches()
    losses = []
    telemetry.enable()  # each bin's miss counts its step
    try:
      for loader in loaders:
        loop.loader = loader
        loader.start = 0
        losses += loop.run(loop.step + warmup, log_every=0)
    finally:
      telemetry.disable()
    counted = list(loop.step_cache._costs.values())
    rows = []
    for loader in loaders:
      dt, timed_losses = timed_run(loop, loader, warmup, timed)
      losses += timed_losses
      rows.append({'ms_per_step': 1e3 * dt})
    for row, loader in zip(rows, loaders):
      loop.loader = loader
      loader.start = warmup + timed
      busy, kernels, flash = device_busy(
          lambda: losses.extend(loop.run(loop.step + profiled, log_every=0)),
          profiled)
      row.update(device_busy_ms_per_step=busy, kernels_per_step=kernels,
                 flash_calls_per_step=flash)
    counts = tfa.device_launches()
    host = dict(tfa.launches)
    if not all(np.isfinite(losses)):
      raise AssertionError(f'{label}: non-finite loss in {losses}')
    if loop.stop_reason is not None:
      raise AssertionError(f'{label}: run stopped early: {loop.stop_reason}')
    per_step = 0 if ablate == 'attention-core' else cfg.num_layers
    want = {k: per_step * len(losses) if k in ('fwd', 'dq', 'dkv') else 0
            for k in counts}
    check_launches(counts, host, want, f'{label}, {len(losses)} steps')
    check_cache(loop.step_cache, len(BINS), len(losses), label)
    for (s, b), row, loader, costs, base in zip(BINS, rows, loaders, counted,
                                                per_bin):
      got = {k: v for k, v in row['flash_calls_per_step'].items() if v}
      if got != {k: float(per_step) for k in ('fwd', 'dq', 'dkv')
                 if per_step}:
        raise AssertionError(f'{label} s={s}: the profiler saw flash kernel '
                             f'calls {got} per step; want {per_step} of '
                             'each of K1-K3')
      flops = costs.matmul_flops + costs.flash_flops
      want_flops = expected_flops(loop, loader.batches[0])
      if abs(flops - want_flops) > STEP_FLOPS_RTOL * want_flops:
        raise AssertionError(
            f'{label} s={s}: the count\'s matmul + flash FLOPs {flops:.6e} '
            f'(matmul {costs.matmul_flops:.6e}, flash {costs.flash_flops:.6e})'
            f'; want the ablated expected_flops {want_flops:.6e} within '
            f'{STEP_FLOPS_RTOL}')
      base_busy = base['profile']['device_busy_ms_per_step']
      row.update(seq_len=s, batch=b, flops=flops, expected_flops=want_flops,
                 flash_flops=costs.flash_flops,
                 delta_ms=row['ms_per_step'] - base['ms_per_step'],
                 delta_busy_ms=row['device_busy_ms_per_step'] - base_busy)
      log(f'  {label} s={s} b={b}: {row["ms_per_step"]:.2f} ms/step '
          f'({row["delta_ms"]:+.2f} vs phase 5\'s {base["ms_per_step"]:.2f}),'
          f' device busy {row["device_busy_ms_per_step"]:.2f} ms '
          f'({row["delta_busy_ms"]:+.2f} vs {base_busy:.2f}), '
          f'{row["kernels_per_step"]:.0f} kernels/step; matmul + flash '
          f'{flops:.6e} FLOPs = the ablated expected {want_flops:.6e} '
          f'(flash {costs.flash_flops:.4e}) [{card}]')
    seconds = time.perf_counter() - t0
    log(f'  {label}: losses {losses[0]:.4f} -> {losses[-1]:.4f} over '
        f'{len(losses)} steps, {loop.step_cache.misses} misses; '
        f'{seconds:.1f} s with the build [{card}]')
    out.append({'ablate': ablate, 'bins': rows, 'launches': counts,
                'steps': len(losses), 'seconds': seconds})
    loop.step_cache = None
    del loop, counted
    gc.collect()
    torch.cuda.empty_cache()
  return out


# ---- phase 7: training from shards ----


def shard_path(name):
  return os.path.join(SHARDS, name)


def load_digests():
  """digests.json: each shard set's loader settings and the digest of
  every epoch-0 batch that lddl_tpu's loaders give over it
  (tests/make_torch_shards.py)."""
  with open(os.path.join(SHARDS, 'digests.json')) as f:
    return json.load(f)


def histogram(tele, name):
  """(count, sum, max) of one telemetry histogram."""
  h = tele.histogram(name)
  return h.count, h.sum, (h.max if h.count else 0.0)


def collate_seconds(tele):
  """Seconds and calls of the collates, summed over their per-bin
  loader.collate_seconds.s<L> histograms."""
  lines = [x for x in tele.snapshot_lines()
           if x.get('name', '').startswith('loader.collate_seconds.s')]
  return sum(x['sum'] for x in lines), sum(x['count'] for x in lines)


def loader_alone(digests, card):
  """7a: drain one epoch of each shard set through the port's loader (the
  card machine's reader, codec library and collate) and hold every batch's
  digest against digests.json; time it, split into reading and decoding
  the shards (loader.read_batch_seconds), the collate
  (loader.collate_seconds.s<L>) and the rest (shuffle and bin draws)."""
  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                     get_packed_pretrain_data_loader)
  from lddl_tpu_torch.pipeline import codecs
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  t0 = time.perf_counter()
  codecs.library()
  log(f'  codec library loaded in {time.perf_counter() - t0:.2f}s from '
      f'{codecs.library_path()}')
  tok = load_bert_tokenizer(VOCAB_FILE)
  stats = {}
  for name, make in (('pairs', get_bert_pretrain_data_loader),
                     ('packed', get_packed_pretrain_data_loader)):
    settings = digests[name]['settings']
    tele = telemetry.enable()
    try:
      t0 = time.perf_counter()
      loader = make(shard_path(name), tokenizer=tok, **settings)
      batches = list(loader)
      seconds = time.perf_counter() - t0
      read = histogram(tele, 'loader.read_batch_seconds')[1]
      collate, calls = collate_seconds(tele)
    finally:
      telemetry.disable()
    got = [batch_sha256(b) for b in batches]
    want = digests[name]['batches']
    if got != want:
      bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
      raise AssertionError(f'{name}: {len(got)} batches, want {len(want)}; '
                           f'batch {bad} differs from lddl_tpu\'s '
                           '(digests.json)')
    samples = sum(b['input_ids'].shape[0] for b in batches)
    n = len(batches)
    stats[name] = {
        'batches': n, 'samples': samples, 'samples_per_s': samples / seconds,
        'ms_per_batch': 1e3 * seconds / n,
        'read_decode_ms_per_batch': 1e3 * read / n,
        'collate_ms_per_batch': 1e3 * collate / n,
        'other_ms_per_batch': 1e3 * (seconds - read - collate) / n,
        'shapes': sorted({tuple(b['input_ids'].shape) for b in batches})}
    r = stats[name]
    log(f'  loader alone, {name}: {n} batches = lddl_tpu\'s bytes '
        f'(digests.json); {r["samples_per_s"]:.0f} samples/s, '
        f'{r["ms_per_batch"]:.2f} ms/batch: read+decode '
        f'{r["read_decode_ms_per_batch"]:.2f} ms, collate '
        f'{r["collate_ms_per_batch"]:.2f} ms ({calls} calls), shuffle and '
        f'bins {r["other_ms_per_batch"]:.2f} ms; shapes {r["shapes"]} '
        f'(host CPU of the card machine) [{card}]')
  return stats


@contextlib.contextmanager
def timed_steps(loop, epoch, tele):
  """The steps ``loop`` runs inside, one dict each: ``seq_len``;
  ``compute``, the host clock around the step through the loop's step
  cache, synchronised before and after; ``wall``, from the end of the
  previous step (or of the set-up) to the end of this one: the loop's
  whole window per step, its own work and the data wait included;
  ``wait``, this step's ``train.data_wait_seconds`` (the histogram's sum
  grows by it just before the step); ``hit``, the cache had the step's
  graph; ``first``, the first step of an epoch of ``epoch`` steps (the run
  starts at an epoch's start)."""
  from lddl_tpu_torch.training import CompiledStepCache
  if loop.step_cache is None:
    loop.step_cache = CompiledStepCache(loop.step_fn)
  cache = loop.step_cache
  wait_h = tele.histogram('train.data_wait_seconds')
  steps = []
  last = {'wait': wait_h.sum}

  def step(batch, dropout_seed):
    misses = cache.misses
    wait = wait_h.sum - last['wait']
    last['wait'] = wait_h.sum
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = cache(batch, dropout_seed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps.append({'seq_len': batch['input_ids'].shape[1],
                  'compute': t1 - t0, 'wall': t1 - last['end'],
                  'wait': wait, 'hit': cache.misses == misses,
                  'first': len(steps) % epoch == 0})
    last['end'] = t1
    return metrics

  loop.step_cache = step
  torch.cuda.synchronize()
  last['end'] = time.perf_counter()
  try:
    yield steps
  finally:
    loop.step_cache = cache


def ms(xs, how):
  return 1e3 * float(how(xs)) if xs else None


def step_stats(steps):
  """Per bin and over all bins, from timed_steps' records: compute ms
  (median of cache hits); wall ms, the loop's whole window (mean over
  cache hits, epochs' first steps included, and median over the hits that
  are not an epoch's first); the data wait of the steps that are not an
  epoch's first (mean, max); and the epochs' first steps' waits apart."""
  def summary(xs):
    hits = [x for x in xs if x['hit']]
    steady = [x for x in hits if not x['first']]
    waits = [x['wait'] for x in xs if not x['first']]
    return {
        'steps': len(xs), 'hits': len(hits),
        'compute_ms': ms([x['compute'] for x in hits], np.median),
        'wall_ms': ms([x['wall'] for x in hits], np.mean),
        'steady_wall_ms': ms([x['wall'] for x in steady], np.median),
        'wait_ms': ms(waits, np.mean), 'wait_max_ms': ms(waits, np.max)}
  out = {s: summary([x for x in steps if x['seq_len'] == s])
         for s in sorted({x['seq_len'] for x in steps})}
  out['all'] = summary(steps)
  out['all']['epoch_first_wait_ms'] = [1e3 * x['wait'] for x in steps
                                       if x['first']]
  return out


class ReplayLoader:
  """Synthetic batches (BinLoader's) in the shapes and order of recorded
  steps: the k-th iteration yields epoch k's sequence of seq lens."""

  def __init__(self, epochs, batch_size, seed, mask_fn):
    self.batch_size = batch_size
    lens = [s for e in epochs for s in e]
    made = {s: iter(BinLoader(s, batch_size, lens.count(s), seed,
                              mask_fn).batches) for s in set(lens)}
    self.epochs = [[next(made[s]) for s in e] for e in epochs]
    self._next = 0

  def __iter__(self):
    epoch = self.epochs[self._next % len(self.epochs)]
    self._next += 1
    return iter(epoch)


def pairs_build(args, settings, **loader_kwargs):
  """TrainLoop.build's arguments for BERT-base over pairs/ (phases 7b,
  8b, 8d)."""
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.training import MODEL_SIZES
  cfg = BertConfig(attention_impl='flash', dtype=torch.bfloat16,
                   **MODEL_SIZES[MODEL])
  return dict(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
              warmup_steps=10, total_steps=1000, seed=settings['base_seed'],
              max_predictions=args.max_predictions,
              batch_size_per_rank=settings['batch_size_per_rank'],
              bin_size=settings['bin_size'],
              max_seq_length=settings['max_seq_length'],
              masking=settings['masking'],
              loader_kwargs={'shuffle_buffer_size':
                             settings['shuffle_buffer_size'],
                             **loader_kwargs})


def train_from_shards(args, digests, card):
  """7b: BERT-base through TrainLoop.build(path=pairs/) for SHARD_EPOCHS
  epochs with the step cache on; then the same shapes in the same order on
  synthetic batches made beforehand, through the same graphs and the same
  loop; then the shards again with a short thread switch interval; then
  save at the first epoch's midpoint and restore into fresh loops."""
  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop

  settings = digests['pairs']['settings']
  tok = load_bert_tokenizer(VOCAB_FILE)
  build = pairs_build(args, settings)
  cfg = build['model_cfg']
  loop = TrainLoop.build(shard_path('pairs'), tok, **build)
  epoch = loop.loader.batches_per_epoch
  n = SHARD_EPOCHS * epoch
  b = loop.loader.batch_size

  # The main path: counts at 0 just before, read just after.
  tele = telemetry.enable()
  try:
    tfa.reset_launches()
    with timed_steps(loop, epoch, tele) as steps:
      losses = loop.run(n, log_every=0)
    counts = tfa.device_launches()
    host = dict(tfa.launches)
    wait = histogram(tele, 'train.data_wait_seconds')
    h2d = histogram(tele, 'train.h2d_seconds')
    collate, calls = collate_seconds(tele)
  finally:
    telemetry.disable()
  if len(losses) != n or not all(np.isfinite(losses)):
    raise AssertionError(f'pairs, {SHARD_EPOCHS} epochs: {len(losses)} '
                         f'steps of {n}, losses {losses}')
  if loop.stop_reason is not None:
    raise AssertionError(f'pairs run stopped early: {loop.stop_reason}')
  per_step = {'fwd': cfg.num_layers, 'dq': cfg.num_layers,
              'dkv': cfg.num_layers, 'fwd_seg': 0, 'dq_seg': 0, 'dkv_seg': 0}
  check_launches(counts, host, {k: m * n for k, m in per_step.items()},
                 f'pairs from shards, {n} steps')
  bins = sorted({x['seq_len'] for x in steps})
  check_cache(loop.step_cache, len(bins), n, 'pairs from shards')
  shard = step_stats(steps)

  # The same shapes in the same order on synthetic batches made
  # beforehand, through the same graphs and the same loop, telemetry on.
  lens = [x['seq_len'] for x in steps]
  shard_loader = loop.loader
  loop.loader = ReplayLoader([lens[i:i + epoch] for i in range(0, n, epoch)],
                             b, args.seed, dynamic_mask_tokens)
  tele = telemetry.enable()
  try:
    with timed_steps(loop, epoch, tele) as synth_steps:
      loop.run(loop.step + n, log_every=0)
  finally:
    telemetry.disable()
  if [x['seq_len'] for x in synth_steps] != lens:
    raise AssertionError('the synthetic run did not replay the shapes')
  synth = step_stats(synth_steps)

  # The shards again with the interpreter's thread switch interval cut
  # from its 5 ms to GIL_SWITCH_S: a thread that wants the GIL waits up to
  # one interval for the holder, so if the data wait is the loop's thread
  # waiting on the feed thread's Python work, it shrinks here.
  loop.loader = shard_loader
  interval = sys.getswitchinterval()
  tele = telemetry.enable()
  try:
    sys.setswitchinterval(GIL_SWITCH_S)
    with timed_steps(loop, epoch, tele) as gil_steps:
      loop.run(loop.step + n, log_every=0)
  finally:
    sys.setswitchinterval(interval)
    telemetry.disable()
  gil = step_stats(gil_steps)
  stats = {'epochs': SHARD_EPOCHS, 'steps': n, 'batch': b, 'bins': {},
           'losses': losses, 'default_switch_interval_s': interval,
           'switch_interval_s': GIL_SWITCH_S}
  for s in bins + ['all']:
    r = dict(shard[s])
    r.update(samples_per_s=b / r['wall_ms'] * 1e3,
             synthetic={k: synth[s][k] for k in
                        ('compute_ms', 'wall_ms', 'steady_wall_ms',
                         'wait_ms', 'wait_max_ms')},
             compute_ratio=r['compute_ms'] / synth[s]['compute_ms'],
             wall_ratio=r['wall_ms'] / synth[s]['wall_ms'],
             short_switch={k: gil[s][k] for k in
                           ('steps', 'compute_ms', 'wall_ms',
                            'steady_wall_ms', 'wait_ms', 'wait_max_ms')})
    stats['bins'][s] = r
    log(f'  pairs from shards {"s=" + str(s) if s != "all" else "all bins"}'
        f' b={b}: {r["steps"]} steps ({r["hits"]} cache hits); wall (the '
        f'loop\'s whole window per step, data wait included) '
        f'{r["wall_ms"]:.2f} ms/step mean of hits, {r["steady_wall_ms"]:.2f}'
        f' median outside epochs\' first steps, {r["samples_per_s"]:.1f} '
        f'samples/s; compute {r["compute_ms"]:.2f} ms/step median; data wait'
        f' outside epochs\' first steps {r["wait_ms"]:.3f} ms mean, '
        f'{r["wait_max_ms"]:.2f} max. Synthetic batches, same shapes and '
        f'order: wall {r["synthetic"]["wall_ms"]:.2f} (ratio '
        f'{r["wall_ratio"]:.3f}), steady {r["synthetic"]["steady_wall_ms"]:.2f},'
        f' compute {r["synthetic"]["compute_ms"]:.2f} (ratio '
        f'{r["compute_ratio"]:.3f}), data wait {r["synthetic"]["wait_ms"]:.3f}'
        f' ms. Shards, switch interval {GIL_SWITCH_S * 1e3:g} ms: wall '
        f'{r["short_switch"]["wall_ms"]:.2f}, steady '
        f'{r["short_switch"]["steady_wall_ms"]:.2f}, compute '
        f'{r["short_switch"]["compute_ms"]:.2f}, data wait '
        f'{r["short_switch"]["wait_ms"]:.3f} ms [{card}]')
  firsts = shard['all']['epoch_first_wait_ms']
  stats.update(
      data_wait_s=wait[1], data_wait_max_s=wait[2],
      data_wait_ms_per_step=1e3 * wait[1] / max(wait[0], 1),
      epoch_first_wait_ms=firsts,
      synthetic_epoch_first_wait_ms=synth['all']['epoch_first_wait_ms'],
      short_switch_epoch_first_wait_ms=gil['all']['epoch_first_wait_ms'],
      h2d_ms_per_step=1e3 * h2d[1] / max(h2d[0], 1), h2d_max_s=h2d[2],
      collate_ms_per_step=1e3 * collate / max(calls, 1))
  log(f'  pairs, {SHARD_EPOCHS} epochs of {epoch} steps: '
      f'train.data_wait_seconds {wait[1]:.4f} s over {wait[0]} steps '
      f'({stats["data_wait_ms_per_step"]:.3f} ms/step; epochs\' first '
      f'steps {", ".join(f"{x:.2f}" for x in firsts)} ms; synthetic '
      f'{", ".join(f"{x:.2f}" for x in synth["all"]["epoch_first_wait_ms"])}'
      f' ms), train.h2d_seconds {stats["h2d_ms_per_step"]:.3f} ms/batch '
      f'(max {1e3 * h2d[2]:.2f} ms), collate '
      f'{stats["collate_ms_per_step"]:.3f} ms/step ({calls} collates); '
      f'losses {losses[0]:.4f} -> {losses[-1]:.4f} [{card}]')
  del loop
  torch.cuda.empty_cache()
  check_shard_resume(build, tok, epoch)
  return stats


def check_shard_resume(build, tok, epoch, label='pairs'):
  """Save at the epoch's midpoint; restore into the same loop and into a
  fresh one, whose loader restore itself must re-seek to the midpoint;
  the rest of the epoch must give the same losses and state digest bit for
  bit (deterministic algorithms on)."""
  from lddl_tpu_torch.training import TrainLoop
  mid = epoch // 2
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    with tempfile.TemporaryDirectory(prefix='lddl_smoke_shards_') as ckpt:
      first = TrainLoop.build(shard_path('pairs'), tok, **build)
      first.run(mid, ckpt_dir=ckpt, log_every=0)
      same = first.restore(ckpt).run(epoch, log_every=0)
      same_digest = first.state_digest()
      del first
      torch.cuda.empty_cache()
      fresh = TrainLoop.build(shard_path('pairs'), tok, **build)
      at = fresh.loader.tell()
      fresh.restore(ckpt)
      seeked = fresh.loader.tell()
      again = fresh.run(epoch, log_every=0)
      fresh_digest = fresh.state_digest()
      del fresh
      torch.cuda.empty_cache()
  finally:
    torch.use_deterministic_algorithms(False)
  if at != (0, 0) or seeked != (0, mid):
    raise AssertionError(f'{label}: restore left the loader at {seeked} '
                         f'(built at {at}); want (0, {mid})')
  if again != same or fresh_digest != same_digest or len(again) != (
      epoch - mid):
    raise AssertionError(f'{label}, resumed from the midpoint: fresh loop '
                         f'losses {again}, same loop {same}, or state '
                         'digests differ')
  log(f'  {label} resume: saved at step {mid} of {epoch}; restore re-seeked a '
      f'fresh loop\'s loader from {at} to {seeked}; the {len(again)} '
      'resumed steps equal the same loop\'s bit for bit (losses and state '
      'digest, deterministic algorithms on)')


def train_packed_from_shards(args, digests, card, workers=0, path=None):
  """7c (8c with ``workers``: through that many loader worker processes):
  BERT-base at s=8192 through TrainLoop.build(path=packed/,
  data_format='packed', block_diagonal=True) for the warm-up and timed
  steps, the step cache on. ``path``: the set to read in packed/'s place
  (7c reads 18a's, whose batches are packed/'s: 18b)."""
  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import MODEL_SIZES, TrainLoop

  settings = digests['packed']['settings']
  s, b = settings['max_seq_length'], settings['batch_size_per_rank']
  loader_kwargs = {'shuffle_buffer_size': settings['shuffle_buffer_size']}
  if workers:
    tok = None
    loader_kwargs.update(num_workers=workers, vocab_file=VOCAB_FILE)
  else:
    tok = load_bert_tokenizer(VOCAB_FILE)
  label = f'packed through {workers} workers' if workers else (
      'packed from shards')
  if path:
    label += " (18b: the port's own, 18a)"
  cfg = BertConfig(attention_impl='flash', dtype=torch.bfloat16,
                   max_position_embeddings=max(s, 512), **MODEL_SIZES[MODEL])
  loop = TrainLoop.build(
      path or shard_path('packed'), tok, model_cfg=cfg, device=DEVICE,
      learning_rate=1e-4, warmup_steps=10, total_steps=1000,
      seed=settings['base_seed'], max_predictions=PACKED[2],
      batch_size_per_rank=b, max_seq_length=s, data_format='packed',
      block_diagonal=settings['block_diagonal'], loader_kwargs=loader_kwargs)
  n = args.packed_warmup + args.packed_steps
  if loop.loader.batches_per_epoch < n:
    raise AssertionError(f'packed shards give {loop.loader.batches_per_epoch}'
                         f' batches per epoch; the phase runs {n}')
  tele = telemetry.enable()
  try:
    tfa.reset_launches()
    with timed_steps(loop, loop.loader.batches_per_epoch, tele) as steps:
      losses = loop.run(n, log_every=0)
    counts = tfa.device_launches()
    host = dict(tfa.launches)
    wait = histogram(tele, 'train.data_wait_seconds')
    # Real tokens of the batches the loader collated: the run's and the
    # feed's prefetch beyond them (in the workers' processes when there
    # are workers: their counters are not this process's).
    real = (tele.counter(f'loader.tokens_real.s{s}').total /
            max(tele.counter('loader.batches').total, 1))
  finally:
    telemetry.disable()
  if len(losses) != n or not all(np.isfinite(losses)):
    raise AssertionError(f'{label}: losses {losses}')
  per_step = {'fwd': 0, 'dq': 0, 'dkv': 0, 'fwd_seg': cfg.num_layers,
              'dq_seg': cfg.num_layers, 'dkv_seg': cfg.num_layers}
  check_launches(counts, host, {k: m * n for k, m in per_step.items()},
                 f'{label}, {n} steps')
  check_cache(loop.step_cache, 1, n, label)
  timed = [x for x in steps[args.packed_warmup:] if x['hit']]
  dt = float(np.mean([x['compute'] for x in timed]))
  wall = float(np.mean([x['wall'] for x in timed]))
  stats = {'seq_len': s, 'batch': b, 'steps': n, 'ms_per_step': 1e3 * dt,
           'launches': counts, 'wall_ms_per_step': 1e3 * wall,
           'data_wait_ms_per_step': 1e3 * wait[1] / max(wait[0], 1),
           'data_wait_max_s': wait[2], 'losses': losses}
  if workers:
    stats['start_ms'] = [1e3 * x for x in loop.loader.start_seconds]
    starts = ', '.join(f'{x:.0f}' for x in stats['start_ms'])
    tokens = f'workers\' start {starts} ms'
  else:
    stats.update(real_tokens_per_step=real, real_tokens_per_s=real / wall)
    tokens = (f'{real / wall:.0f} real tokens/s over the wall ({real:.0f} '
              'real tokens/step)')
  log(f'  {label} s={s} b={b}, {len(timed)} timed cache hits: wall (the '
      f'loop\'s whole window per step, data wait included) '
      f'{1e3 * wall:.2f} ms/step mean, compute {1e3 * dt:.2f}; {tokens}; '
      f'train.data_wait_seconds {stats["data_wait_ms_per_step"]:.3f} '
      f'ms/step over all {n} steps (max {1e3 * wait[2]:.2f} ms); losses '
      f'{losses[0]:.4f} -> {losses[-1]:.4f} [{card}]')
  del loop
  torch.cuda.empty_cache()
  return stats


def cli_from_shards(digests, card):
  """7d: the CLI as a user runs it, from shards to a checkpoint, then
  resumed from it; rc 0 and finite losses both times."""
  settings = digests['pairs']['settings']
  base = [sys.executable, '-m', 'lddl_tpu_torch.training.pretrain',
          *cli_argv(digests, settings['batch_size_per_rank'])]
  out = {}
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_cli_') as ckpt:
    for label, extra in (('run', ['--steps', '4', '--checkpoint-every',
                                  '4']),
                         ('resume', ['--resume', '--steps', '6'])):
      t0 = time.perf_counter()
      proc = subprocess.run(base + extra + ['--checkpoint-dir', ckpt],
                            cwd=HERE, capture_output=True, text=True,
                            timeout=600, check=False)
      seconds = time.perf_counter() - t0
      losses = [float(x) for x in re.findall(r'^step=\d+ loss=(\S+)',
                                             proc.stdout, re.M)]
      final = [json.loads(x) for x in proc.stdout.splitlines()
               if x.startswith('{"final_step"')]
      if (proc.returncode != 0 or not losses or not final or
          not all(np.isfinite(losses))):
        raise AssertionError(f'CLI {label} exited {proc.returncode}, losses '
                             f'{losses}:\n{proc.stdout[-3000:]}\n'
                             f'{proc.stderr[-3000:]}')
      out[label] = {'rc': proc.returncode, 'losses': losses,
                    'final': final[-1], 'seconds': seconds}
      log(f'  CLI {label}: rc 0 in {seconds:.1f}s, losses {losses}, '
          f'{final[-1]} [{card}]')
  if out['resume']['final']['final_step'] != 6 or len(
      out['resume']['losses']) != 2:
    raise AssertionError(f'CLI resume did not continue from step 4: {out}')
  return out


# ---- phase 8: the corpus loader through worker processes ----

def check_no_segments(label):
  """No shared-memory ring of the port (``lddltorch_``) is left linked."""
  from lddl_tpu_torch.loader.shm import live_segments
  left = live_segments()
  if left:
    raise AssertionError(f'{label}: shared-memory segments left behind: '
                         f'{left}')


def check_digests(label, got, want):
  if got != want:
    bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
               min(len(got), len(want)))
    raise AssertionError(f'{label}: {len(got)} batches, want {len(want)}; '
                         f'batch {bad} differs from lddl_tpu\'s '
                         '(digests.json)')


def handoff_label(handoff):
  if handoff is None:
    return 'serial'
  transport, zero_copy = handoff
  return f'W={WORKERS} {transport}' + (' zero-copy' if zero_copy else '')


def loader_through_workers(digests, card):
  """8a: one epoch of each shard set through WORKERS worker processes by
  each handoff (shm, pickle, shm with zero-copy views), every batch's
  digest (taken before the next pull: a zero-copy batch is valid only
  until then) held against digests.json; samples/s and ms/batch, build
  and drain, beside the serial loader's in alternating order; the
  workers' start (from iter() to the first batch) and the slot overflows
  (batches pickled because they did not fit their slot: 0 required at
  the default slot size)."""
  from lddl_tpu_torch import loader as tloader
  stats = {}
  for name, attr in SHARD_LOADERS.items():
    make = getattr(tloader, attr)
    settings = digests[name]['settings']
    runs = {}
    order = [None, *HANDOFFS]
    for handoff in order + order[::-1]:
      kw = {} if handoff is None else dict(
          num_workers=WORKERS, transport=handoff[0], zero_copy=handoff[1])
      label = handoff_label(handoff)
      t0 = time.perf_counter()
      loader = make(shard_path(name), vocab_file=VOCAB_FILE, **settings, **kw)
      got, rows = [], 0
      for batch in loader:
        got.append(batch_sha256(batch))
        rows += batch['input_ids'].shape[0]
      seconds = time.perf_counter() - t0
      check_digests(f'{name}, {label}', got, digests[name]['batches'])
      r = runs.setdefault(label, {'seconds': [], 'start_ms': [],
                                  'slot_overflows': 0})
      r['seconds'].append(seconds)
      r['start_ms'] += [1e3 * x for x in getattr(loader, 'start_seconds', [])]
      r['slot_overflows'] += getattr(loader, 'slot_overflows', 0)
      r.update(rows=rows, batches=len(got))
      check_no_segments(f'8a {name}, {label}')
    for label, r in runs.items():
      if label != 'serial' and 'shm' in label and r['slot_overflows']:
        raise AssertionError(f'{name}, {label}: {r["slot_overflows"]} '
                             'batches did not fit their shm slot at the '
                             'default slot_bytes')
      sec = float(np.mean(r['seconds']))
      r.update(samples_per_s=r['rows'] / sec,
               ms_per_batch=1e3 * sec / r['batches'])
      starts = ', '.join(f'{x:.0f}' for x in r['start_ms'])
      extra = ('' if label == 'serial' else
               f'; workers\' start {starts} ms; slot overflows '
               f'{r["slot_overflows"]}')
      log(f'  loader alone, {name}, {label}: {r["batches"]} batches = '
          f'lddl_tpu\'s bytes (digests.json), twice; '
          f'{r["samples_per_s"]:.0f} samples/s, {r["ms_per_batch"]:.2f} '
          f'ms/batch (build and drain, mean of 2{extra}) [{card}]')
    stats[name] = runs
  return stats


def timed_epochs(loop, loader, epoch, n):
  """``n`` more steps of ``loop`` on ``loader``, telemetry on: the
  timed_steps records, the data wait and h2d histograms, and (a worker
  loader's) the workers' start per epoch. A loader with ``seek`` starts
  at epoch 0, so every run takes the same batches."""
  from lddl_tpu_torch import telemetry
  if hasattr(loader, 'seek'):
    loader.seek(0, 0)
  loop.loader = loader
  starts = len(getattr(loader, 'start_seconds', []))
  tele = telemetry.enable()
  try:
    with timed_steps(loop, epoch, tele) as steps:
      losses = loop.run(loop.step + n, log_every=0)
    h2d = histogram(tele, 'train.h2d_seconds')
  finally:
    telemetry.disable()
  if len(losses) != n or not all(np.isfinite(losses)):
    raise AssertionError(f'{n} steps: {len(losses)} finite losses')
  return {'steps': steps, 'losses': losses,
          'h2d_ms_per_step': 1e3 * h2d[1] / max(h2d[0], 1),
          'start_ms': [1e3 * x for x in
                       getattr(loader, 'start_seconds', [])[starts:]]}


def train_through_workers(args, digests, card):
  """8b: BERT-base from pairs/ through TrainLoop.build(path,
  loader_kwargs={'num_workers': WORKERS, 'vocab_file': ...}) for
  SHARD_EPOCHS epochs, cache on: 12 launches per step of K1-K3 and none
  of K4 on the device, one miss per bin; then the serial loader and
  synthetic batches (the same shapes and order) through the same loop
  and graphs, alternating with the workers (W S Y Y S W); then a midpoint
  resume through a re-seeked MultiprocessLoader."""
  from lddl_tpu_torch.loader import (MultiprocessLoader,
                                     get_bert_pretrain_data_loader)
  from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.training import TrainLoop

  settings = digests['pairs']['settings']
  build = pairs_build(args, settings, num_workers=WORKERS,
                      vocab_file=VOCAB_FILE)
  loop = TrainLoop.build(shard_path('pairs'), **build)
  workers = loop.loader
  if not isinstance(workers, MultiprocessLoader):
    raise AssertionError(f'TrainLoop.build made a {type(workers)}')
  epoch = workers.batches_per_epoch
  n = SHARD_EPOCHS * epoch
  b = workers.batch_size
  cfg = build['model_cfg']

  # The main path: counts at 0 just before, read just after.
  tfa.reset_launches()
  runs = {'workers': [timed_epochs(loop, workers, epoch, n)]}
  counts = tfa.device_launches()
  host = dict(tfa.launches)
  per_step = {'fwd': cfg.num_layers, 'dq': cfg.num_layers,
              'dkv': cfg.num_layers, 'fwd_seg': 0, 'dq_seg': 0, 'dkv_seg': 0}
  check_launches(counts, host, {k: m * n for k, m in per_step.items()},
                 f'pairs through {WORKERS} workers, {n} steps')
  lens = [x['seq_len'] for x in runs['workers'][0]['steps']]
  check_cache(loop.step_cache, len(set(lens)), n,
              f'pairs through {WORKERS} workers')
  check_no_segments('8b main path')

  serial = get_bert_pretrain_data_loader(
      shard_path('pairs'), vocab_file=VOCAB_FILE, **settings)
  synthetic = ReplayLoader([lens[i:i + epoch] for i in range(0, n, epoch)],
                           b, args.seed, dynamic_mask_tokens)
  loaders = {'workers': workers, 'serial': serial, 'synthetic': synthetic}
  for name in ('serial', 'synthetic', 'synthetic', 'serial', 'workers'):
    runs.setdefault(name, []).append(
        timed_epochs(loop, loaders[name], epoch, n))
    got = [x['seq_len'] for x in runs[name][-1]['steps']]
    if got != lens:
      raise AssertionError(f'8b {name}: shapes {got}, not the main path\'s '
                           f'{lens}')
  check_no_segments('8b alternation')

  stats = {'epochs': SHARD_EPOCHS, 'steps_per_run': n, 'batch': b,
           'workers': WORKERS, 'order': 'W S Y Y S W', 'runs': {}}
  for name, rs in runs.items():
    per = [step_stats(r['steps'])['all'] for r in rs]
    r = {k: float(np.mean([p[k] for p in per])) for k in
         ('wall_ms', 'steady_wall_ms', 'compute_ms', 'wait_ms',
          'wait_max_ms')}
    r.update(per_run=[{k: p[k] for k in ('wall_ms', 'steady_wall_ms',
                                          'compute_ms', 'wait_ms')}
                      for p in per],
             epoch_first_wait_ms=[x for p in per
                                  for x in p['epoch_first_wait_ms']],
             h2d_ms_per_step=float(np.mean([x['h2d_ms_per_step']
                                            for x in rs])),
             start_ms=[x for q in rs for x in q['start_ms']],
             samples_per_s=b / r['wall_ms'] * 1e3)
    stats['runs'][name] = r
    log(f'  pairs b={b}, {name}: {len(rs)} runs of {n} steps; wall (the '
        f'loop\'s whole window per step, data wait included) '
        f'{r["wall_ms"]:.2f} ms/step mean of hits, {r["steady_wall_ms"]:.2f}'
        f' median outside epochs\' first steps, {r["samples_per_s"]:.1f} '
        f'samples/s; the step alone {r["compute_ms"]:.2f} ms median; data '
        f'wait outside epochs\' first steps {r["wait_ms"]:.3f} ms mean, '
        f'{r["wait_max_ms"]:.2f} max; epochs\' first steps\' waits '
        f'{", ".join(f"{x:.1f}" for x in r["epoch_first_wait_ms"])} ms; '
        f'train.h2d_seconds {r["h2d_ms_per_step"]:.3f} ms/batch'
        + (f'; workers\' start per epoch '
           f'{", ".join(f"{x:.0f}" for x in r["start_ms"])} ms'
           if r['start_ms'] else '') + f' [{card}]')
  stats['losses'] = runs['workers'][0]['losses']
  del loop, workers, loaders
  torch.cuda.empty_cache()
  check_shard_resume(build, None, epoch, f'pairs through {WORKERS} workers')
  check_no_segments('8b resume')
  return stats


def ledger_on_card(args, digests, card):
  """8d: one epoch of BERT-base from pairs/ with LDDL_LEDGER on, serially
  and through WORKERS workers, and the same two with it off, alternating
  (serial off, on; workers on, off): the two ledgers' collate and device
  records are equal key for key and digest for digest (the port's auditor
  exits 0 on the pair), the collate digests are digests.json's ledger
  entries (lddl_tpu's batches under blake2b-8, which the phase forces
  wherever xxhash is installed), and the ledger's cost per step is the
  window's difference."""
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.telemetry import ledger
  from lddl_tpu_torch.training import TrainLoop

  settings = digests['pairs']['settings']
  saved = ledger._xxhash, ledger.ALGO
  ledger._xxhash, ledger.ALGO = None, 'blake2b8'
  loop = TrainLoop.build(shard_path('pairs'), **pairs_build(args, settings,
                                                            vocab_file=
                                                            VOCAB_FILE))
  epoch = loop.loader.batches_per_epoch
  timed = {}
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_ledger_') as root:
    try:
      for mode, on in (('serial', False), ('serial', True),
                       ('workers', True), ('workers', False)):
        kw = {'num_workers': WORKERS} if mode == 'workers' else {}
        loader = get_bert_pretrain_data_loader(
            shard_path('pairs'), vocab_file=VOCAB_FILE, **settings, **kw)
        if on:
          ledger.enable_ledger(directory=os.path.join(root, mode), rank=0)
        try:
          run = timed_epochs(loop, loader, epoch, epoch)
        finally:
          ledger.disable_ledger()
        timed[mode, on] = step_stats(run['steps'])['all']
    finally:
      ledger._xxhash, ledger.ALGO = saved
    records = {}
    for mode in ('serial', 'workers'):
      with open(os.path.join(root, mode, 'ledger.rank0.jsonl')) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
      if lines[0].get('algo') != 'blake2b8':
        raise AssertionError(f'8d {mode}: ledger meta {lines[0]}')
      records[mode] = {
          b: {tuple((k, r[k]) for k in ('epoch', 'index') if k in r):
              r['digest'] for r in lines[1:] if r['boundary'] == b}
          for b in ('collate', 'device')}
    audit = subprocess.run(
        [sys.executable, '-m', 'lddl_tpu_torch.telemetry.audit', 'diff',
         os.path.join(root, 'serial'), os.path.join(root, 'workers')],
        cwd=HERE, capture_output=True, text=True, timeout=120, check=False)
  del loop
  torch.cuda.empty_cache()
  if records['serial'] != records['workers']:
    raise AssertionError('8d: the serial and worker ledgers differ')
  if audit.returncode != 0:
    raise AssertionError(f'8d: the auditor exited {audit.returncode}:\n'
                         f'{audit.stdout}\n{audit.stderr}')
  collate = [records['serial']['collate'][(('epoch', 0), ('index', i))]
             for i in range(len(records['serial']['collate']))]
  if collate != digests['pairs']['ledger']:
    raise AssertionError('8d: the collate digests are not lddl_tpu\'s '
                         '(digests.json ledger entries)')
  if len(records['serial']['device']) != epoch:
    raise AssertionError(f'8d: {len(records["serial"]["device"])} device '
                         f'records, want {epoch}')
  stats = {'records': {b: len(v) for b, v in records['serial'].items()}}
  for mode in ('serial', 'workers'):
    on, off = timed[mode, True], timed[mode, False]
    stats[mode] = {
        'on_wall_ms': on['wall_ms'], 'off_wall_ms': off['wall_ms'],
        'on_steady_wall_ms': on['steady_wall_ms'],
        'off_steady_wall_ms': off['steady_wall_ms'],
        'cost_ms_per_step': on['wall_ms'] - off['wall_ms'],
        'steady_cost_ms_per_step': on['steady_wall_ms'] -
                                   off['steady_wall_ms']}
    r = stats[mode]
    log(f'  ledger, {mode}: {epoch} steps each way; wall {r["on_wall_ms"]:.2f}'
        f' ms/step on, {r["off_wall_ms"]:.2f} off (cost '
        f'{r["cost_ms_per_step"]:+.3f} ms/step; steady medians '
        f'{r["on_steady_wall_ms"]:.2f} vs {r["off_steady_wall_ms"]:.2f}, '
        f'{r["steady_cost_ms_per_step"]:+.3f}) [{card}]')
  log(f'  ledger: {stats["records"]} records per run; serial and '
      f'{WORKERS} workers equal key for key (the auditor exits 0: '
      f'{audit.stdout.strip().splitlines()[-1]}); collate = lddl_tpu\'s '
      'blake2b-8 digests (digests.json)')
  return stats


class DigestingLoader:
  """Passes ``loader``'s batches on, keeping each one's batch_sha256."""

  def __init__(self, loader):
    self.loader = loader
    self.batch_size = loader.batch_size
    self.digests = []

  def __iter__(self):
    for batch in self.loader:
      self.digests.append(batch_sha256(batch))
      yield batch


def codebert_through_workers(args, digests, card, path=None):
  """8e: a few BERT-base steps from codebert/ (or the set at ``path``: 18a's,
  whose batches are codebert/'s, in 18b) through a TrainLoop whose loader
  is get_codebert_pretrain_data_loader(..., num_workers=WORKERS): finite
  losses, 12 launches a step of each of K1-K3 (counts at 0 just before,
  read just after), and the batches it took are lddl_tpu's
  (digests.json)."""
  from lddl_tpu_torch.loader import get_codebert_pretrain_data_loader
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.training import TrainLoop

  settings = digests['codebert']['settings']
  build = pairs_build(args, dict(settings, masking='dynamic'))
  del build['loader_kwargs']
  loop = TrainLoop.build(**build)
  loop.loader = DigestingLoader(get_codebert_pretrain_data_loader(
      path or shard_path('codebert'), vocab_file=VOCAB_FILE,
      num_workers=WORKERS, **settings))
  n = CODEBERT_STEPS
  layers = build['model_cfg'].num_layers
  tfa.reset_launches()
  t0 = time.perf_counter()
  losses = loop.run(n, log_every=0)
  seconds = time.perf_counter() - t0
  counts = tfa.device_launches()
  check_launches(counts, dict(tfa.launches),
                 {k: 0 if k.endswith('_seg') else layers * n for k in counts},
                 f'codebert through {WORKERS} workers, {n} steps')
  got = loop.loader.digests
  want = digests['codebert']['batches']
  del loop
  torch.cuda.empty_cache()
  if len(losses) != n or not all(np.isfinite(losses)):
    raise AssertionError(f'codebert through workers: losses {losses}')
  if len(got) < n or got != want[:len(got)]:
    raise AssertionError(f'codebert: the {len(got)} batches the loop took '
                         'are not lddl_tpu\'s (digests.json)')
  check_no_segments('8e')
  where = " (18b: the port's own shards, 18a)" if path else ''
  log(f'  codebert through {WORKERS} workers{where}: {n} steps in '
      f'{seconds:.1f} s (graph captures included), losses {losses[0]:.4f} -> '
      f'{losses[-1]:.4f}; the {len(got)} batches taken = lddl_tpu\'s '
      f'(digests.json) [{card}]')
  return {'steps': n, 'seconds': seconds, 'losses': losses,
          'launches': counts}


def kill_a_worker(digests, card):
  """8f: SIGKILL worker 1 of a WORKERS-worker pairs loader after the first
  batch: the parent raises the RuntimeError naming it within its 5 s
  poll (plus the batches already queued), and no segment is left."""
  import multiprocessing
  import signal
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  loader = get_bert_pretrain_data_loader(
      shard_path('pairs'), vocab_file=VOCAB_FILE, num_workers=WORKERS,
      queue_depth=1, **digests['pairs']['settings'])
  it = iter(loader)
  next(it)
  victim = [p for p in multiprocessing.active_children()
            if p.name == 'lddl-torch-loader-w1']
  if len(victim) != 1:
    raise AssertionError(f'8f: worker 1 not found: {victim}')
  os.kill(victim[0].pid, signal.SIGKILL)
  t0 = time.perf_counter()
  try:
    for _ in it:
      pass
  except RuntimeError as e:
    message = str(e)
  else:
    raise AssertionError('8f: the epoch ended without an error after '
                         'worker 1 was killed')
  seconds = time.perf_counter() - t0
  it.close()
  if 'loader worker 1 died' not in message or seconds > 10:
    raise AssertionError(f'8f: after {seconds:.1f} s: {message}')
  left = [p for p in multiprocessing.active_children()
          if p.name.startswith('lddl-torch-loader-')]
  if left:
    raise AssertionError(f'8f: workers still running: {left}')
  check_no_segments('8f')
  log(f'  killed worker 1 mid-epoch: the parent raised "{message}" '
      f'{seconds:.2f} s later; no worker and no segment left [{card}]')
  return {'seconds': seconds, 'message': message}


# ---- phase 9: data-parallel training across processes ----

# Every rank process of phase 9 lives at most this long (seconds): past
# it the parent kills every process of the world and the phase fails.
RANK_TIMEOUT = 420
# 9a: the steps timed after the CLI's runs, through the same graphs (the
# rest of the pairs epoch: 6 + 16 = 22 batches).
DP_TIMED_STEPS = 16
# 9b: numpy global batches (seq_len, global batch, steps), the masking
# rates of the first batch's two halves (one per rank: very different
# masked counts), and the ranks against the world-1 step on the whole
# global batch, bf16: each rank runs 8-row GEMMs where the world-1 step
# runs 16-row ones, so the sums round differently; the limits are phase
# 5's flash-vs-dense ones, per-step loss and grad_norm, and the loss of a
# held-out batch after the steps.
DP_NUMPY = (128, 16, 3)
DP_UNEVEN = (0.5, 0.03)
DP_LOSS_RTOL, DP_GRAD_NORM_RTOL = DENSE_LOSS_RTOL, DENSE_GRAD_NORM_RTOL
# 9a vs 7d's CLI run: 7d's losses are printed to 4 decimals and its steps
# ran with deterministic algorithms off.
CLI_PRINT_ATOL = 1e-4
# Rank processes phase 9 started (9c: none may be left), and the script
# they run.
RANK_PROCS = []
RANK_SCRIPT = os.path.abspath(__file__)


def free_port():
  import socket
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def cli_argv(digests, batch):
  """7d's CLI arguments over pairs/, ``batch`` samples per rank."""
  settings = digests['pairs']['settings']
  return ['--path', shard_path('pairs'), '--vocab-file', VOCAB_FILE,
          '--model', MODEL, '--bin-size', str(settings['bin_size']),
          '--max-seq-length', str(settings['max_seq_length']),
          '--batch-size', str(batch), '--attention', 'flash',
          '--log-every', '1']


def group_alive(pgid):
  try:
    os.killpg(pgid, 0)
    return True
  except ProcessLookupError:
    return False


def launch_ranks(label, task, world, out_dir, extra=(), env=None,
                 torchrun=False, timeout=RANK_TIMEOUT):
  """Start ``world`` rank processes of this script's ``--rank-task task``
  (each in a session of its own); returns the handle
  :func:`finish_ranks` takes. By hand, each rank gets the rendezvous
  environment torch.distributed reads (``MASTER_ADDR``/``MASTER_PORT``/
  ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``); with ``torchrun`` one
  ``torch.distributed.run`` launcher starts them. The world has one
  deadline, ``timeout`` seconds from now."""
  port = free_port()
  script = [RANK_SCRIPT, '--rank-task', task, '--out', out_dir, *extra]
  base_env = dict(os.environ, **(env or {}))
  if torchrun:
    cmds = [([sys.executable, '-m', 'torch.distributed.run', '--nnodes',
              '1', '--nproc-per-node', str(world), '--master-addr',
              'localhost', '--master-port', str(port), *script], base_env)]
  else:
    cmds = [([sys.executable, *script],
             dict(base_env, MASTER_ADDR='localhost', MASTER_PORT=str(port),
                  RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r)))
            for r in range(world)]
  procs, logs = [], []
  t0 = time.perf_counter()
  deadline = time.monotonic() + timeout
  try:
    for i, (cmd, e) in enumerate(cmds):
      logs.append(os.path.join(out_dir, f'{task}.proc{i}.log'))
      with open(logs[-1], 'w') as f:
        procs.append(subprocess.Popen(cmd, cwd=HERE, env=e, stdout=f,
                                      stderr=subprocess.STDOUT,
                                      start_new_session=True))
      RANK_PROCS.append(procs[-1])
  except BaseException:
    kill_ranks((label, task, world, out_dir, procs, logs, t0, deadline,
                timeout))
    raise
  return label, task, world, out_dir, procs, logs, t0, deadline, timeout


def kill_ranks(handle):
  """Kill every process of a launch's sessions that is left."""
  for p in handle[4]:
    if group_alive(p.pid):
      os.killpg(p.pid, 9)
    p.wait()


def finish_ranks(handle):
  """Wait for a launch's ranks: each rank's JSON result and the world's
  seconds from its start. Past the world's deadline every process of it
  is killed and the phase fails, as it does for a non-zero exit or a
  process left behind."""
  label, task, world, out_dir, procs, logs, t0, deadline, timeout = handle
  try:
    for p in procs:
      try:
        p.wait(max(deadline - time.monotonic(), 0.1))
      except subprocess.TimeoutExpired:
        raise AssertionError(f'{label}: a rank process outlived its '
                             f'{timeout} s; the world is killed')
    left = [p.pid for p in procs if group_alive(p.pid)]
    if left:
      raise AssertionError(f'{label}: processes of the sessions {left} are '
                           'left after the ranks exited')
  finally:
    kill_ranks(handle)
  seconds = time.perf_counter() - t0
  failed = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
  if failed:
    tails = ''.join(f'\n-- {path}:\n' + open(path).read()[-4000:]
                    for path in logs)
    raise AssertionError(f'{label}: rank processes exited {failed}{tails}')
  results = []
  for r in range(world):
    with open(os.path.join(out_dir, f'{task}.rank{r}.json')) as f:
      results.append(json.load(f))
  return results, seconds


def run_ranks(label, task, world, out_dir, extra=(), env=None,
              torchrun=False):
  """Run ``world`` rank processes of ``--rank-task task`` to their end
  (:func:`launch_ranks`, :func:`finish_ranks`): each rank's JSON result
  and the world's seconds."""
  return finish_ranks(launch_ranks(label, task, world, out_dir, extra, env,
                                   torchrun))


def check_no_rank_processes(label='9c'):
  """9c (and phase 14): every rank process the script started has
  exited, and nothing of its session is left."""
  left = [p.pid for p in RANK_PROCS if p.poll() is None or
          group_alive(p.pid)]
  if left:
    raise AssertionError(f'{label}: rank processes left: {left}')
  log(f'  {label}: all {len(RANK_PROCS)} rank processes (and their '
      'sessions) have exited')


# ---- the rank processes' side ----


class StepTimer:
  """Wraps a loop's step cache: each step's time, synchronised, the
  cache's hits apart."""

  def __init__(self, cache):
    self.cache = cache
    self.hit_ms = []

  def __call__(self, batch, dropout_seed):
    misses = self.cache.misses
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = self.cache(batch, dropout_seed)
    torch.cuda.synchronize()
    if self.cache.misses == misses:
      self.hit_ms.append(1e3 * (time.perf_counter() - t0))
    return out


def record_runs():
  """Record what every TrainLoop.run of this process does, the CLI's
  too: its losses and seconds, and the bins its steps ran (the seq lens
  the step cache was called with)."""
  from lddl_tpu_torch.training import pretrain
  runs, seen = [], []
  run, call = pretrain.TrainLoop.run, pretrain.CompiledStepCache.__call__

  def recorded_run(self, *a, **k):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = run(self, *a, **k)
    torch.cuda.synchronize()
    runs.append({'losses': losses, 'seconds': time.perf_counter() - t0})
    return losses

  def recorded_call(self, batch, dropout_seed):
    seen.append(int(batch['input_ids'].shape[1]))
    return call(self, batch, dropout_seed)

  pretrain.TrainLoop.run = recorded_run
  pretrain.CompiledStepCache.__call__ = recorded_call
  return runs, seen


def cli_run(argv, runs, seen):
  """``pretrain.main(argv)`` with the kernels' counts at 0 just before and
  read just after; the run's losses, launches, cache and state."""
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.training import pretrain
  seen.clear()
  tfa.reset_launches()
  loop = pretrain.main(argv)
  counts, host = tfa.device_launches(), dict(tfa.launches)
  cache = loop.step_cache
  exchange = loop.step_fn.exchange
  return loop, {
      'losses': runs[-1]['losses'], 'seconds': runs[-1]['seconds'],
      'launches': counts, 'host_launches': host,
      'misses': cache.misses if cache else 0,
      'hits': cache.hits if cache else 0,
      'mode': cache.mode if cache else None, 'bins': sorted(set(seen)),
      'backend': exchange.backend if exchange else None,
      'step': loop.step, 'samples_seen': loop.samples_seen}


def rank_result(args, result):
  rank = int(os.environ.get('RANK', '0'))
  with open(os.path.join(args.out, f'{args.rank_task}.rank{rank}.json'),
            'w') as f:
    json.dump(result, f, default=str)


def world_9a(args, digests):
  """World 1 over NCCL (under torch.distributed.run; the first work of
  ``--rank-task 14c``'s process, beside the two ranks): the CLI as 7d
  runs it, one process (--comm null) and the world of one (--comm torch),
  4 steps with a checkpoint then --resume for 2, deterministic algorithms
  on; then, once the two ranks have written it, 9b's world-2 checkpoint
  resumed (:func:`resume_9b`). Returns the results and the CLI loops, whose
  steps :func:`time_9a` times once the two ranks have exited."""
  runs, seen = record_runs()
  batch = digests['pairs']['settings']['batch_size_per_rank']
  out, loops = {}, {}
  for comm in ('null', 'torch'):
    torch.use_deterministic_algorithms(True)
    with tempfile.TemporaryDirectory(prefix='lddl_smoke_9a_') as ckpt:
      per = []
      for extra in (['--steps', '4', '--checkpoint-every', '4'],
                    ['--resume', '--steps', '6']):
        loop, r = cli_run(cli_argv(digests, batch) + extra +
                          ['--comm', comm, '--checkpoint-dir', ckpt],
                          runs, seen)
        per.append(r)
    out[comm] = {'runs': per}
    loops[comm] = loop
  del loop
  torch.use_deterministic_algorithms(False)
  out['waited_for_9b_s'] = wait_for(args, 'ckpt_9b.written')
  out['9b_resume'] = resume_9b(args, digests, runs, seen)
  return out, loops


def time_9a(args, out, loops):
  """9a's timed steps, once the two ranks have exited (GO_FILE): each CLI
  loop's steps to the end of the epoch through its graphs."""
  out['waited_for_two_ranks_s'] = wait_for(args, GO_FILE)
  for comm, loop in loops.items():
    timer = StepTimer(loop.step_cache)
    loop.step_cache = timer
    loop.run(loop.step + DP_TIMED_STEPS, log_every=0)
    out[comm].update(step_ms=float(np.median(timer.hit_ms)),
                     timed_hits=len(timer.hit_ms))
  loops.clear()
  torch.cuda.empty_cache()
  return out


def dp_batches(seed):
  """DP_NUMPY's global batches, the first with halves masked at
  DP_UNEVEN's rates, plus one held out."""
  from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
  s, b, steps = DP_NUMPY
  out = []
  for i in range(steps + 1):
    rates = DP_UNEVEN if i == 0 else (0.15, 0.15)
    halves = []
    for h, rate in enumerate(rates):
      def mask_fn(*a, mlm_probability, rate=rate, **k):
        return dynamic_mask_tokens(*a, mlm_probability=rate, **k)
      halves.append(BinLoader(s, b // 2, 1, seed * 100 + 2 * i + h,
                              mask_fn).batches[0])
    out.append({k: np.concatenate([x[k] for x in halves])
                for k in halves[0]})
  return out


def to_device(batch):
  return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def flat_params(model):
  return torch.cat([p.detach().float().reshape(-1)
                    for p in model.parameters()])


def world_9b(args, digests):
  """One of two ranks on the one card, gloo for CUDA tensors (the first
  work of ``--rank-task 14``'s processes): the numpy global batches
  through the data-parallel step (rank 0 also runs the world-1 step on
  the whole batches), then the CLI from shards, 4 steps with a
  checkpoint (into ``ckpt_9b`` under ``--ckpt``)."""
  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.parallel import local_batch, make_mesh
  from lddl_tpu_torch.parallel import train as ttrain
  from lddl_tpu_torch.training import TrainLoop
  from lddl_tpu_torch.training.pretrain import MODEL_SIZES
  runs, seen = record_runs()
  torch.cuda.set_device(0)  # both ranks on the one card
  comm = get_backend('torch')
  mesh = make_mesh(device_type=torch.device(DEVICE).type)
  rank, world = comm.rank, comm.world_size
  batches = dp_batches(args.seed)
  steps = DP_NUMPY[2]
  cfg = BertConfig(vocab_size=((VOCAB_REAL + 63) // 64) * 64,
                   attention_impl='flash', dropout_rate=0.0,
                   **MODEL_SIZES[MODEL])
  build = dict(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
               warmup_steps=0, total_steps=100, seed=args.seed)
  loop = TrainLoop.build(mesh=mesh, comm=comm, **build)
  theta0 = flat_params(loop.model) if rank == 0 else None
  out = {'backend': loop.step_fn.exchange.backend,
         'masked': [int((local_batch(b, mesh)['labels'] != -100).sum())
                    for b in batches[:1]],
         'steps': []}
  for b in batches[:steps]:
    mine = to_device(local_batch(b, mesh))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = loop.step_fn(mine, loop.dropout_seed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    digest = hashlib.sha256(
        flat_params(loop.model).cpu().numpy().tobytes()).hexdigest()
    out['steps'].append({'metrics': {k: float(v) for k, v in m.items()},
                         'ms': 1e3 * seconds,
                         'digests': comm.allgather_object(digest)})
  if rank == 0:
    out['reference'] = world_one_reference(build, batches, steps, theta0,
                                           loop.model, ttrain)
  del loop
  torch.cuda.empty_cache()
  comm.barrier()
  loop, out['cli'] = cli_run(
      cli_argv(digests, digests['pairs']['settings']['batch_size_per_rank']
               // world) +
      ['--comm', 'torch', '--device', f'{DEVICE}:0', '--steps', '4',
       '--checkpoint-every', '4', '--checkpoint-dir',
       os.path.join(args.ckpt, 'ckpt_9b')], runs, seen)
  out['cli']['digest'] = loop.state_digest()
  del loop
  torch.cuda.empty_cache()
  return out


def world_one_reference(build, batches, steps, theta0, dp_model, ttrain):
  """The world-1 step on the whole global batches from the same init:
  per-step metrics, the held-out batch's loss under both models, the
  update's cosine against the ranks', and the gradient norm that
  averaging each half's own mean would give at the first batch."""
  from lddl_tpu_torch.training import TrainLoop
  ref = TrainLoop.build(**build)
  model = ref.model
  halves = []
  for half in (slice(0, DP_NUMPY[1] // 2), slice(DP_NUMPY[1] // 2, None)):
    model.zero_grad(set_to_none=True)
    loss, _ = ttrain.pretrain_loss(
        model, to_device({k: v[half] for k, v in batches[0].items()}))
    loss.backward()
    halves.append([p.grad.float().clone() for p in model.parameters()])
  model.zero_grad(set_to_none=True)
  ddp = float(ttrain.global_norm([(a + b) / 2 for a, b in zip(*halves)]))
  del halves
  metrics = []
  for b in batches[:steps]:
    m = ref.step_fn(to_device(b), ref.dropout_seed)
    metrics.append({k: float(v) for k, v in m.items()})
  held = to_device(batches[steps])
  with torch.no_grad():
    held_loss = [float(ttrain.pretrain_loss(x.eval(), held)[0])
                 for x in (dp_model, model)]
  upd_dp = flat_params(dp_model) - theta0
  upd_ref = flat_params(model) - theta0
  cosine = float(torch.dot(upd_dp, upd_ref) /
                 (upd_dp.norm() * upd_ref.norm()))
  del ref
  return {'metrics': metrics, 'ddp_grad_norm': ddp,
          'held_out_loss': held_loss, 'update_cosine': cosine}


def resume_9b(args, digests, runs, seen):
  """World 1 over NCCL (9a's process) resumes 9b's world-2 checkpoint
  (the same global batch): the state, samples_seen, and the next bins
  against a world-1 loader re-seeked to the same samples_seen; then 2
  more steps. ``runs``, ``seen``: the process's :func:`record_runs`."""
  import itertools

  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  settings = digests['pairs']['settings']
  batch = settings['batch_size_per_rank']
  argv = cli_argv(digests, batch) + ['--comm', 'torch', '--resume',
                                     '--checkpoint-dir',
                                     os.path.join(args.ckpt, 'ckpt_9b')]
  loop, restored = cli_run(argv + ['--steps', '4'], runs, seen)
  out = {'restored': restored, 'digest': loop.state_digest()}
  fresh = get_bert_pretrain_data_loader(
      shard_path('pairs'), dp_rank=0, dp_world_size=1,
      batch_size_per_rank=batch, tokenizer=load_bert_tokenizer(VOCAB_FILE),
      masking='dynamic', max_seq_length=settings['max_seq_length'],
      bin_size=settings['bin_size'], base_seed=127,
      samples_seen=loop.samples_seen)
  out['next_bins'] = [[batch_sha256(b) for b in itertools.islice(
      iter(x), 3)] for x in (loop.loader, fresh)]
  losses = loop.run(loop.step + 2, log_every=0)
  out['more_losses'] = losses
  del loop
  torch.cuda.empty_cache()
  return out


RANK_TASKS = {}


# ---- phase 9: the parent's checks ----


def check_cli_run(r, label, mode, backend):
  """One CLI run of a rank: finite losses, one launch per layer and step
  (12 for BERT-base) of each segment-free kernel and none of the
  segmented (device = wrappers), one
  cache miss per bin, the cache mode and the group's backend."""
  from lddl_tpu_torch.training.pretrain import MODEL_SIZES
  n = len(r['losses'])
  if not n or not all(np.isfinite(r['losses'])):
    raise AssertionError(f'{label}: losses {r["losses"]}')
  layers = MODEL_SIZES[MODEL]['num_layers']
  want = {k: (layers * n if k in ('fwd', 'dq', 'dkv') else 0)
          for k in ('fwd', 'dq', 'dkv', 'fwd_seg', 'dq_seg', 'dkv_seg')}
  if r['launches'] != want or r['host_launches'] != r['launches']:
    raise AssertionError(f'{label}: launches {r["launches"]} on the '
                         f'device, {r["host_launches"]} by the wrappers; '
                         f'want {want}')
  bins = len(r['bins'])
  if (r['misses'], r['hits'], r['mode'], r['backend']) != (
      bins, n - bins, mode, backend):
    raise AssertionError(
        f'{label}: cache misses {r["misses"]} hits {r["hits"]} mode '
        f'{r["mode"]} over bins {r["bins"]}, backend {r["backend"]}; want '
        f'one miss per bin, mode {mode}, backend {backend}')


def dp_world_one(digests, cli7d, shards7, card, res, seconds):
  """9a's checks (``res``: its result from 14c's process), and 9b's
  resume in that process; returns 9a's numbers and the resume's
  result."""
  for comm, mode, backend in (('null', 'graph', None),
                              ('torch', 'graph', 'nccl')):
    for r, label in zip(res[comm]['runs'], ('run', 'resume')):
      check_cli_run(r, f'9a {comm} {label}', mode, backend)
  for a, b, label in zip(res['null']['runs'], res['torch']['runs'],
                         ('run', 'resume')):
    if a['losses'] != b['losses'] or (a['step'], a['samples_seen']) != (
        b['step'], b['samples_seen']):
      raise AssertionError(f'9a {label}: world 1 over NCCL {b["losses"]} '
                           f'!= one process {a["losses"]} (deterministic '
                           'algorithms on: want bit-equal)')
    want = cli7d[label]['losses']
    if len(want) != len(b['losses']) or not np.allclose(
        b['losses'], want, rtol=0, atol=CLI_PRINT_ATOL):
      raise AssertionError(f'9a {label}: losses {b["losses"]} vs 7d\'s CLI '
                           f'{want} (printed to 4 decimals)')
  null_ms, torch_ms = res['null']['step_ms'], res['torch']['step_ms']
  p7 = shards7['bins']['all']['compute_ms']
  log(f'  9a: world 1 over NCCL (torch.distributed.run): losses '
      f'{res["torch"]["runs"][0]["losses"]} + '
      f'{res["torch"]["runs"][1]["losses"]} bit-equal to the one-process '
      'CLI in the same process (deterministic algorithms on), and to 7d\'s '
      'at its print precision; the all-reduces run inside the CUDA graphs '
      f'(one miss per bin, {res["torch"]["runs"][0]["launches"]["fwd"]} + '
      f'{res["torch"]["runs"][1]["launches"]["fwd"]} launches of each '
      'kernel)')
  log(f'  9a: step alone, median of {res["torch"]["timed_hits"]} graph '
      f'replays: world 1 over NCCL {torch_ms:.2f} ms/step, one process '
      f'{null_ms:.2f} ms/step (the group and its all-reduces: '
      f'{torch_ms - null_ms:+.2f} ms); phase 7b {p7:.2f} ms/step; the '
      f'process {seconds:.1f} s with 14c and 15c [{card}]')
  return {'seconds': seconds, 'step_ms': torch_ms, 'one_process_ms': null_ms,
          'phase7_step_ms': p7,
          'launches': res['torch']['runs'][0]['launches'],
          'losses': res['torch']['runs'][0]['losses'] +
                    res['torch']['runs'][1]['losses']}, res['9b_resume']


def dp_world_two(args, digests, card, res, seconds):
  """9b's checks (``res``: each rank's result from phase 14's world);
  returns its numbers and the ranks' CLI results, which
  :func:`check_9b_resume` reads."""
  masked = [r['masked'][0] for r in res]
  if not masked[0] > 5 * masked[1]:
    raise AssertionError(f'9b: the uneven batch\'s halves hold {masked} '
                         'masked tokens')
  ref = res[0]['reference']
  for i, step in enumerate(res[0]['steps']):
    if len(set(step['digests'])) != 1 or any(
        r['steps'][i]['metrics'] != step['metrics'] for r in res):
      raise AssertionError(f'9b step {i}: the ranks differ: '
                           f'{[r["steps"][i] for r in res]}')
    want = ref['metrics'][i]
    for name, rtol in (('loss', DP_LOSS_RTOL),
                       ('grad_norm', DP_GRAD_NORM_RTOL)):
      got = step['metrics'][name]
      if not abs(got - want[name]) <= rtol * abs(want[name]):
        raise AssertionError(f'9b step {i}: {name} {got} vs the world-1 '
                             f'step\'s {want[name]} (rtol {rtol})')
  held = ref['held_out_loss']
  if not abs(held[0] - held[1]) <= DP_LOSS_RTOL * abs(held[1]):
    raise AssertionError(f'9b: held-out loss {held[0]} after the steps vs '
                         f'the world-1 model\'s {held[1]}')
  ddp, g0 = ref['ddp_grad_norm'], ref['metrics'][0]['grad_norm']
  if abs(ddp - g0) <= DP_GRAD_NORM_RTOL * abs(g0):
    raise AssertionError(f'9b: averaging per-rank means gives grad_norm '
                         f'{ddp}, within tolerance of the global {g0}: the '
                         'uneven batch does not test the normalizers')
  for rank, r in enumerate(res):
    check_cli_run(r['cli'], f'9b CLI rank {rank}', 'eager', 'gloo')
  if (len({r['cli']['digest'] for r in res}) != 1 or
      len({json.dumps(r['cli']['losses']) for r in res}) != 1):
    raise AssertionError('9b CLI: the ranks end with different states or '
                         'losses')
  numpy_ms = [float(np.median([s['ms'] for s in r['steps'][1:]]))
              for r in res]
  cli_ms = [1e3 * r['cli']['seconds'] / len(r['cli']['losses'])
            for r in res]
  log(f'  9b: world 2 on the one card over gloo (eager steps): numpy '
      f'batches of {DP_NUMPY[1]} ({masked} masked tokens in the first '
      f'batch\'s halves), the ranks bit-equal after every step; vs the '
      f'world-1 step: loss {[s["metrics"]["loss"] for s in res[0]["steps"]]}'
      f' vs {[m["loss"] for m in ref["metrics"]]}, grad_norm '
      f'{[s["metrics"]["grad_norm"] for s in res[0]["steps"]]} vs '
      f'{[m["grad_norm"] for m in ref["metrics"]]}, held-out loss {held}, '
      f'update cosine {ref["update_cosine"]:.6f}; averaging per-rank means '
      f'would give grad_norm {ddp:.4f} at the first step')
  log(f'  9b: ms/step per rank, numpy steps (median after the first) '
      f'{[round(x, 2) for x in numpy_ms]}, CLI (run time / steps) '
      f'{[round(x, 2) for x in cli_ms]}; launches per rank '
      f'{[r["cli"]["launches"]["fwd"] for r in res]} of each kernel over '
      f'the CLI\'s {len(res[0]["cli"]["losses"])} steps [{card}]')
  return {'seconds': seconds, 'numpy_ms_per_rank': numpy_ms,
          'cli_ms_per_rank': cli_ms, 'masked_halves': masked,
          'reference': ref, 'launches_per_rank': [r['cli']['launches']
                                                  for r in res],
          'steps': [s['metrics'] for s in res[0]['steps']]}, res[0]['cli']


def check_9b_resume(cli, resumed, card):
  """9b's checkpoint resumed at world 1 over NCCL (in 9a's process): the
  state and samples_seen those of rank 0's CLI (``cli``), the next bins
  a re-seeked world-1 loader's, 2 more finite losses."""
  want = (cli['digest'], cli['samples_seen'])
  got = (resumed['digest'], resumed['restored']['samples_seen'])
  bins = resumed['next_bins']
  more = resumed['more_losses']
  if (got != want or bins[0] != bins[1] or resumed['restored']['losses']
      or len(more) != 2 or not all(np.isfinite(more))):
    raise AssertionError(f'9b resume at world 1: state/samples_seen {got} '
                         f'vs saved {want}; next bins {bins}; losses {more}')
  log(f'  9b: resumed at world 1 over NCCL (in 9a\'s process): the state '
      f'equals the world-2 ranks\' bit for bit, samples_seen {got[1]}, the '
      f'next 3 batches equal a re-seeked world-1 loader\'s, 2 more steps '
      f'{more} [{card}]')
  return more


def rank_worlds(args, root):
  """The rank launches phases 9, 14, 15 and 16 share: two ranks on the
  card over gloo (``--rank-task 14``: 9b, 14a, 14b, 14d, 15b, then 16's
  recorded runs and their replays), and one world-1 NCCL process under
  torch.distributed.run (``--rank-task 14c``: 9a with 9b's resume, 14c,
  15c), started first so that 9a's CLI runs overlap the two ranks; it
  waits for them before anything timed or anything of theirs it reads.
  Files under ``root`` (the checkpoints, 16's runs) stay for phase 16."""
  seed = ['--seed', str(args.seed)]
  # World 1 starts first: 9a's CLI runs (deterministic, checked by their
  # bits, not timed) overlap the two ranks; it waits for GO_FILE, written
  # when they have exited, before its timed steps and what reads their
  # checkpoints.
  one = launch_ranks('9a, 14c, 15c', '14c', 1, root,
                     extra=['--ckpt', root] + seed, torchrun=True,
                     timeout=2 * RANK_TIMEOUT)
  try:
    two, two_s = run_ranks('9b, 14, 15b, 16', '14', 2, root,
                           extra=['--ckpt', root] + seed,
                           env={'LDDL_DIST_CUDA_BACKEND': 'gloo'})
    with open(os.path.join(root, GO_FILE), 'w') as f:
      f.write('go')
    (one,), one_s = finish_ranks(one)
  except BaseException:
    kill_ranks(one)
    raise
  return {'two': two, 'one': one, 'seconds': {'two': two_s, 'one': one_s}}


# Written by rank_worlds when the two ranks have exited: world 1 waits for
# it before its timed steps.
GO_FILE = 'go_world1'


def flag_written(args, comm, name):
  """The two ranks: once both are past writing checkpoint ``name``, rank 0
  marks it written (``<name>.written`` under ``--ckpt``) for world 1."""
  comm.barrier()
  if comm.rank == 0:
    with open(os.path.join(args.ckpt, f'{name}.written'), 'w') as f:
      f.write('written')


def wait_for(args, name):
  """World 1 (``--rank-task 14c``): wait for the file ``name`` under
  ``--ckpt``; the seconds waited."""
  t0 = time.perf_counter()
  path = os.path.join(args.ckpt, name)
  while not os.path.exists(path):
    if time.perf_counter() - t0 > 2 * RANK_TIMEOUT:
      raise AssertionError(f'14c: no {name} after {2 * RANK_TIMEOUT} s')
    time.sleep(0.1)
  return time.perf_counter() - t0


def data_parallel(args, digests, cli7d, shards7, card, worlds):
  """Phase 9's checks: 9b, then 9a (whose process also resumed 9b's
  checkpoint), 9c; from :func:`rank_worlds`' processes."""
  world2, cli = dp_world_two(args, digests, card,
                             [r['9b'] for r in worlds['two']],
                             worlds['seconds']['two'])
  world1, resumed = dp_world_one(digests, cli7d, shards7, card,
                                 worlds['one']['9a'],
                                 worlds['seconds']['one'])
  world2['resume_losses'] = check_9b_resume(cli, resumed, card)
  check_no_segments('phase 9')
  check_no_rank_processes()
  return {'world1': world1, 'world2': world2}


# ---- phase 10: the network data service and the live monitor ----

# The data client's knobs, set in the environment as a user sets them: a
# killed server costs the trainer 3 connection attempts (~0.4 s of
# backoff) before it degrades, and the degraded client probes for a
# server every SERVE_REATTACH local batches.
SERVE_REATTACH = 4
SERVE_ENV = {'LDDL_DATA_TIMEOUT': '5', 'LDDL_DATA_RETRIES': '2',
             'LDDL_DATA_REATTACH_EVERY': str(SERVE_REATTACH)}
SERVE_EPOCHS = 2
# 10b: the server is SIGKILLed just before this step of the run.
SERVE_KILL_STEP = 5
# A server's window in 10b: both epochs, so the restarted server (which
# starts at batch 0) holds the batch the re-attached client asks for.
SERVE_KILL_WINDOW = 64
# The scraper's period through the main path (10a/10c) and in 10c's
# monitor-on timing, seconds.
SCRAPE_S = 0.05
SCRAPE_SLOW_S = 1.0
# A data server announces within this many seconds of its start.
SERVER_START_TIMEOUT = 60
# Prometheus text exposition: a sample line.
PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$')


class ServerProc:
  """``python -m lddl_tpu_torch.loader.service`` over pairs/, started as
  a user starts it: digests.json's pairs loader through ``--factory``,
  its serve announce into ``fleet`` (where the trainer discovers it), in
  a session of its own. With ``monitor_dir`` it runs its own monitor
  (LDDL_MONITOR, telemetry on), announced there, apart from the
  trainer's rank 0. ``factory`` and ``kwargs`` serve another loader."""

  def __init__(self, settings, fleet, log_path, window=None,
               monitor_dir=None, factory=None, kwargs=None):
    if kwargs is None:
      kwargs = dict(path=shard_path('pairs'), vocab_file=VOCAB_FILE,
                    **settings)
    self.cmd = [sys.executable, '-m', 'lddl_tpu_torch.loader.service',
                '--factory', factory or
                'lddl_tpu_torch.loader.bert:get_bert_pretrain_data_loader',
                '--kwargs-json', json.dumps(kwargs), '--announce-dir', fleet]
    if window:
      self.cmd += ['--window', str(window)]
    self.env = {k: v for k, v in os.environ.items()
                if k not in ('LDDL_MONITOR', 'LDDL_MONITOR_DIR',
                             'LDDL_TELEMETRY', 'LDDL_TELEMETRY_DIR')}
    if monitor_dir:
      self.env.update(LDDL_MONITOR='1', LDDL_MONITOR_DIR=monitor_dir,
                      LDDL_TELEMETRY='1')
    self.fleet, self.log_path, self.monitor_dir = fleet, log_path, monitor_dir
    self.proc = self.url = None

  @property
  def pid(self):
    return self.proc.pid

  def start(self):
    from lddl_tpu_torch.loader.service import discover_data_servers
    t0 = time.perf_counter()
    with open(self.log_path, 'w') as f:
      self.proc = subprocess.Popen(self.cmd, cwd=HERE, env=self.env, stdout=f,
                                   stderr=subprocess.STDOUT,
                                   start_new_session=True)
    deadline = time.monotonic() + SERVER_START_TIMEOUT
    while time.monotonic() < deadline:
      mine = [i for i in discover_data_servers(self.fleet)
              if i.get('pid') == self.pid and not i['dead']]
      if mine:
        self.url = mine[0]['url']
        self.start_seconds = time.perf_counter() - t0
        return self
      if self.proc.poll() is not None:
        break
      time.sleep(0.05)
    self.stop()
    raise AssertionError(f'phase 10: the data server did not announce:\n'
                         + open(self.log_path).read()[-4000:])

  def served(self):
    """The server's ``serve.batches_served``, from its own monitor."""
    from lddl_tpu_torch.telemetry import monitor
    urls = monitor.discover_endpoints(self.monitor_dir)
    if len(urls) != 1:
      raise AssertionError(f'phase 10: server monitor endpoints {urls}')
    snap = monitor.fetch_snapshot(urls[0], timeout=10)
    if snap['pid'] != self.pid:
      raise AssertionError(f'phase 10: monitor of pid {snap["pid"]}')
    return next((x['total'] for x in snap['metrics']
                 if x.get('name') == 'serve.batches_served'), 0)

  def kill(self):
    os.killpg(self.pid, 9)
    self.proc.wait(30)

  def stop(self):
    """SIGTERM (the server's clean teardown), SIGKILL past 30 s; returns
    the exit code."""
    if self.proc is None:
      return None
    if self.proc.poll() is None:
      self.proc.terminate()
      try:
        self.proc.wait(30)
      except subprocess.TimeoutExpired:
        pass
    if group_alive(self.pid):
      os.killpg(self.pid, 9)
    self.proc.wait()
    return self.proc.returncode


def check_no_cuda_context(pid, label):
  """The process ``pid`` holds no CUDA context: nvidia-smi does not list
  it, and it has neither the CUDA driver nor torch mapped."""
  out = subprocess.run(['nvidia-smi', '--query-compute-apps=pid',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True, timeout=60)
  pids = sorted(int(x) for x in out.stdout.split() if x.strip().isdigit())
  with open(f'/proc/{pid}/maps') as f:
    maps = f.read()
  mapped = [lib for lib in ('libcuda.so', 'libtorch') if lib in maps]
  if pid in pids or mapped:
    raise AssertionError(f'{label}: the data server (pid {pid}) holds CUDA '
                         f'state: nvidia-smi compute pids {pids}, mapped '
                         f'{mapped}')
  seen = os.getpid() in pids
  where = ('among them' if seen else
           'not among them: the query sees another pid namespace')
  log(f'  {label}: the data server (pid {pid}) holds no CUDA context: '
      f'nvidia-smi lists compute pids {pids} (this trainer, pid '
      f'{os.getpid()}, {where}); neither libcuda nor libtorch is mapped in '
      'it')
  return {'compute_pids': pids, 'trainer_listed': seen}


def monitor_cli(fleet):
  """``python -m lddl_tpu_torch.telemetry.monitor --dir fleet --once
  --json``: its exit code and payload."""
  r = subprocess.run([sys.executable, '-m', 'lddl_tpu_torch.telemetry.monitor',
                      '--dir', fleet, '--once', '--json'], cwd=HERE,
                     capture_output=True, text=True, timeout=120,
                     check=False)
  try:
    payload = json.loads(r.stdout)
  except ValueError:
    raise AssertionError(f'phase 10: the monitor CLI printed no JSON '
                         f'(rc {r.returncode}):\n{r.stdout}\n{r.stderr}')
  return r.returncode, payload


class Scraper:
  """A thread that GETs the trainer's ``/snapshot`` every ``period``
  seconds from the moment its monitor serves until :meth:`stop`, keeping
  the errors, the scrapes made before ``steps[0]`` reached ``first``,
  and the last snapshot; with ``arm_at`` it GETs ``/profile?steps=2``
  once ``steps[0]`` reaches it."""

  def __init__(self, monitor, period, steps=None, first=0, arm_at=None):
    import threading
    self.monitor, self.period, self.steps = monitor, period, steps or [0]
    self.first, self.arm_at = first, arm_at
    self.errors, self.scrapes, self.scrapes_first = [], 0, 0
    self.last = self.armed = self.metrics = None
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._run, name='smoke-scraper',
                                    daemon=True)
    self._thread.start()

  def _get(self, path):
    import urllib.request
    with urllib.request.urlopen(self.monitor.url + path, timeout=10) as r:
      return r.read().decode()

  def _run(self):
    while not self.monitor.url and not self._stop.wait(0.005):
      pass
    while not self._stop.is_set():
      try:
        if (self.arm_at is not None and self.armed is None and
            self.steps[0] >= self.arm_at):
          self.armed = json.loads(self._get('/profile?steps=2'))
        self.last = json.loads(self._get('/snapshot'))
        self.scrapes += 1
        if self.steps[0] < self.first:
          self.scrapes_first += 1
      except Exception as e:  # every failure is a finding of the phase
        self.errors.append(repr(e))
      self._stop.wait(self.period)

  def stop(self):
    self._stop.set()
    self._thread.join(30)
    if self.monitor.url:
      try:
        self.metrics = self._get('/metrics')
      except OSError as e:
        self.errors.append(repr(e))


@contextlib.contextmanager
def on_steps(loop, hooks):
  """Counts the steps ``loop`` takes inside (``taken[0]``) and runs
  ``hooks[i]()`` on the loop's thread just before the i-th of them."""
  from lddl_tpu_torch.training import CompiledStepCache
  if loop.step_cache is None:
    loop.step_cache = CompiledStepCache(loop.step_fn)
  cache = loop.step_cache
  taken = [0]

  def step(batch, dropout_seed):
    hook = hooks.get(taken[0])
    if hook is not None:
      hook()
    taken[0] += 1
    return cache(batch, dropout_seed)

  loop.step_cache = step
  try:
    yield taken
  finally:
    loop.step_cache = cache


def read_ledger(path):
  """``{boundary: [digest, ...]}`` in (epoch, index/gi) order."""
  with open(path) as f:
    lines = [json.loads(x) for x in f.read().splitlines()]
  if lines[0].get('algo') != 'blake2b8':
    raise AssertionError(f'phase 10: ledger meta {lines[0]}')
  out = {}
  for r in lines[1:]:
    key = (r.get('epoch'), r.get('index', r.get('gi')))
    out.setdefault(r['boundary'], []).append((key, r['digest']))
  return {b: [d for _, d in sorted(v)] for b, v in out.items()}


@contextlib.contextmanager
def blake2b8():
  """The ledger's digests are blake2b-8 inside (what digests.json's
  ``ledger`` entries hold), wherever xxhash is installed."""
  from lddl_tpu_torch.telemetry import ledger
  saved = ledger._xxhash, ledger.ALGO
  ledger._xxhash, ledger.ALGO = None, 'blake2b8'
  try:
    yield
  finally:
    ledger._xxhash, ledger.ALGO = saved


@contextlib.contextmanager
def blake2b8_ledger(directory):
  """The determinism ledger on, with blake2b-8 digests, for the enclosed
  run."""
  from lddl_tpu_torch.telemetry import ledger
  with blake2b8():
    ledger.enable_ledger(directory=directory, rank=0)
    try:
      yield
    finally:
      ledger.disable_ledger()


def serve_expected(digests):
  """What the service must deliver over SERVE_EPOCHS epochs: the port's
  serial loader's batches (its epoch 0 held against digests.json here) as
  batch_sha256 and as blake2b-8 ledger digests, and their bins."""
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.telemetry import ledger
  loader = get_bert_pretrain_data_loader(
      shard_path('pairs'), vocab_file=VOCAB_FILE,
      **digests['pairs']['settings'])
  batches = [b for _ in range(SERVE_EPOCHS) for b in loader]
  sha = [batch_sha256(b) for b in batches]
  with blake2b8():
    fp = [ledger.fingerprint_batch(b) for b in batches]
  bins = len({b['input_ids'].shape[1] for b in batches})
  n = len(digests['pairs']['batches'])
  check_digests('10: the serial loader', sha[:n], digests['pairs']['batches'])
  if fp[:n] != digests['pairs']['ledger']:
    raise AssertionError('10: the serial loader\'s blake2b-8 digests are not '
                         'digests.json\'s ledger entries')
  return sha, fp, bins


def flash_calls_in_trace(trace_dir):
  """Calls of each flash kernel in a torch.profiler Chrome trace."""
  with open(os.path.join(trace_dir, 'trace.json')) as f:
    events = json.load(f)['traceEvents']
  calls = {}
  for e in events:
    m = FLASH_KERNEL_NAME.search(str(e.get('name', '')))
    if m and e.get('cat') == 'kernel':
      name = m.group(1) + ('_seg' if m.group(2) == 'true' else '')
      calls[name] = calls.get(name, 0) + 1
  return calls


def check_prometheus(text, label):
  samples = [x for x in text.splitlines() if x and not x.startswith('#')]
  bad = [x for x in samples if not PROM_SAMPLE.match(x)]
  for x in samples:
    float(x.rsplit(' ', 1)[1])
  if bad or not samples or '# TYPE lddl_train_steps_total counter' not in text:
    raise AssertionError(f'{label}: /metrics is not Prometheus text: '
                         f'{bad[:3]} ({len(samples)} samples)')
  return len(samples)


def serve_healthy(args, digests, want, root, fleet, servers, card):
  """10a, with 10c's checks during it: BERT-base from a data server
  through TrainLoop with LDDL_LOADER_TRANSPORT=network, the endpoint
  found by discovery, deterministic algorithms on, the ledger on, the
  monitor on (LDDL_MONITOR=1) with a scraper every SCRAPE_S; then the
  same steps through the serial loader in a fresh loop, bit-equal."""
  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.loader import MultiprocessLoader
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.telemetry import profiling, server
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop

  settings = digests['pairs']['settings']
  want_sha, want_fp, bins = want
  srv = ServerProc(settings, fleet, os.path.join(root, 'srv_a.log'),
                   monitor_dir=os.path.join(root, 'srv_a_monitor')).start()
  servers.append(srv)
  build = pairs_build(args, settings, num_workers=WORKERS,
                      vocab_file=VOCAB_FILE)
  os.environ['LDDL_LOADER_TRANSPORT'] = 'network'
  try:
    loop = TrainLoop.build(shard_path('pairs'), **build)
  finally:
    del os.environ['LDDL_LOADER_TRANSPORT']
  if not (isinstance(loop.loader, MultiprocessLoader) and
          loop.loader.transport == 'network'):
    raise AssertionError(f'10a: TrainLoop.build made {loop.loader!r}')
  epoch = loop.loader.batches_per_epoch
  n = SERVE_EPOCHS * epoch
  loop.loader = taken_batches = DigestingLoader(loop.loader)
  cfg = build['model_cfg']
  cli = {}
  os.environ['LDDL_MONITOR'] = '1'
  server.stop_monitor()
  mon = server.get_monitor()  # resolved here, started by run()
  ledger_dir = os.path.join(root, 'ledger_a')
  tele = telemetry.enable()
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    with blake2b8_ledger(ledger_dir), on_steps(
        loop, {epoch + 2: lambda: cli.update(live=monitor_cli(fleet))}) as \
        steps:
      scraper = Scraper(mon, SCRAPE_S, steps, first=epoch, arm_at=epoch)
      try:
        tfa.reset_launches()
        t0 = time.perf_counter()
        losses = loop.run(n, log_every=0)
        seconds = time.perf_counter() - t0
        counts = tfa.device_launches()
        host = dict(tfa.launches)
      finally:
        scraper.stop()
    client = {k: tele.counter(f'serve.{k}').total
              for k in ('client_pulls', 'fallbacks', 'reattaches')}
  finally:
    torch.use_deterministic_algorithms(False)
    telemetry.disable()
  if len(losses) != n or not all(np.isfinite(losses)):
    raise AssertionError(f'10a: {len(losses)} losses of {n}: {losses}')
  check_digests('10a, the batches the loop took', taken_batches.digests,
                want_sha)
  records = read_ledger(os.path.join(ledger_dir, 'ledger.rank0.jsonl'))
  if records.get('collate') != want_fp:
    raise AssertionError('10a: the ledger\'s collate digests are not the '
                         'serial loader\'s (epoch 0: digests.json)')
  if len(records.get('serve.rx', [])) != n:
    raise AssertionError(f'10a: {len(records.get("serve.rx", []))} batches '
                         f'came over the wire, want all {n}')
  served = srv.served()
  if client['fallbacks'] or client['reattaches'] or served != n:
    raise AssertionError(f'10a: fallbacks {client["fallbacks"]}, '
                         f'reattaches {client["reattaches"]}, the server '
                         f'served {served}; want 0, 0, {n}')
  per_step = {'fwd': cfg.num_layers, 'dq': cfg.num_layers,
              'dkv': cfg.num_layers, 'fwd_seg': 0, 'dq_seg': 0, 'dkv_seg': 0}
  check_launches(counts, host, {k: m * n for k, m in per_step.items()},
                 f'10a, from the data server, {n} steps')
  check_cache(loop.step_cache, bins, n, '10a, under a scraper every '
              f'{1e3 * SCRAPE_S:.0f} ms')
  if loop.step_cache.mode != 'graph':
    raise AssertionError(f'10a: step cache mode {loop.step_cache.mode}')
  # 10c, during the same run.
  if scraper.errors or not scraper.scrapes_first:
    raise AssertionError(f'10c: scraper errors {scraper.errors[:3]}, '
                         f'{scraper.scrapes_first} scrapes in epoch 0')
  hbm = scraper.last['hbm']
  total = torch.cuda.mem_get_info(0)[1]
  if hbm['bytes_limit'] != total or not 0 < hbm['headroom_frac'] < 1:
    raise AssertionError(f'10c: /snapshot hbm {hbm}; the card has {total} '
                         'bytes')
  prom = check_prometheus(scraper.metrics, '10c')
  trace = profiling.get_step_profiler().last_trace_dir
  if not scraper.armed or not trace:
    raise AssertionError(f'10c: /profile answered {scraper.armed}; trace '
                         f'{trace}')
  calls = flash_calls_in_trace(trace)
  if calls != {k: 2 * v for k, v in per_step.items() if v}:
    raise AssertionError(f'10c: the /profile trace of 2 steps names the '
                         f'flash kernels {calls}; want 24 calls of each of '
                         'K1-K3 and none of K4')
  rc, fleet_json = cli['live']
  live = [d for d in fleet_json.get('data_servers', [])
          if d['url'] == srv.url and not d['dead']]
  if rc != 0 or list(fleet_json['ranks']) != ['0'] or not live or \
      fleet_json['errors']:
    raise AssertionError(f'10c: the monitor CLI exited {rc} with ranks '
                         f'{list(fleet_json["ranks"])}, data servers '
                         f'{fleet_json.get("data_servers")}, errors '
                         f'{fleet_json["errors"]}')
  context = check_no_cuda_context(srv.pid, '10a')
  if srv.stop() != 0:
    raise AssertionError(f'10a: the data server exited {srv.proc.returncode}')
  log(f'  10a: {n} steps ({SERVE_EPOCHS} epochs) from the data server in '
      f'{seconds:.1f} s (graph captures included), losses {losses[0]:.4f} '
      f'-> {losses[-1]:.4f}; the {n} batches = the serial loader\'s (epoch 0 '
      f'= digests.json), collate records = its blake2b-8 digests, {n} '
      f'serve.rx; the server served {served}, the client pulled '
      f'{client["client_pulls"]} times, 0 fallbacks; server start '
      f'{srv.start_seconds:.2f} s [{card}]')
  log(f'  10c: {scraper.scrapes} scrapes of /snapshot every '
      f'{1e3 * SCRAPE_S:.0f} ms ({scraper.scrapes_first} in epoch 0, while '
      f'{bins} graphs were captured), no error; hbm.bytes_limit {total} = '
      f'the card\'s, headroom {hbm["headroom_frac"]:.4f}; /metrics {prom} '
      f'Prometheus samples; /profile?steps=2 -> {trace}: {calls}; the '
      'monitor CLI listed rank 0 and the data server [' + card + ']')

  tok = load_bert_tokenizer(VOCAB_FILE)
  ref = TrainLoop.build(shard_path('pairs'), tok, **pairs_build(args,
                                                                 settings))
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    ref_losses = ref.run(n, log_every=0)
  finally:
    torch.use_deterministic_algorithms(False)
  del ref
  torch.cuda.empty_cache()
  if ref_losses != losses:
    bad = next(i for i, (a, b) in enumerate(zip(ref_losses, losses))
               if a != b)
    raise AssertionError(f'10a: step {bad}: loss {losses[bad]} from the data '
                         f'server, {ref_losses[bad]} from the serial loader '
                         '(deterministic algorithms on)')
  log(f'  10a: the {n} losses equal a serial-loader run\'s in a fresh loop '
      'bit for bit (deterministic algorithms on)')
  return loop, epoch, {
      'steps': n, 'seconds': seconds, 'losses': losses,
      'served': served, 'client': client, 'launches': counts,
      'server_start_s': srv.start_seconds, 'cuda_context': context,
      'scrapes': scraper.scrapes, 'scrapes_epoch0': scraper.scrapes_first,
      'hbm': hbm, 'prometheus_samples': prom, 'profile_calls': calls}


def serve_timing(loop, digests, epoch, root, fleet, servers, card):
  """10a's record: the loop's whole window per step and the data wait,
  from the data server (N), the serial loader (S) and W=2 workers (W),
  in the order S N W W N S through the same loop and graphs
  (deterministic algorithms off, as 7b and 8b); a fresh server for each
  network run."""
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.telemetry import server
  server.stop_monitor()
  os.environ.pop('LDDL_MONITOR', None)
  settings = digests['pairs']['settings']
  n = SERVE_EPOCHS * epoch

  def make(**kw):
    return get_bert_pretrain_data_loader(shard_path('pairs'),
                                         vocab_file=VOCAB_FILE, **settings,
                                         **kw)
  loaders = {'serial': make(), 'workers': make(num_workers=WORKERS,
                                                transport='shm')}
  runs = {}
  for i, name in enumerate(('serial', 'network', 'workers', 'workers',
                            'network', 'serial')):
    srv = None
    if name == 'network':
      srv = ServerProc(settings, fleet, os.path.join(root, f'srv_t{i}.log'))
      servers.append(srv.start())
      loader = make(num_workers=WORKERS, transport='network')
    else:
      loader = loaders[name]
    runs.setdefault(name, []).append(timed_epochs(loop, loader, epoch, n))
    if srv is not None:
      srv.stop()
  stats = {'order': 'S N W W N S', 'steps_per_run': n, 'runs': {}}
  for name, rs in runs.items():
    per = [step_stats(r['steps'])['all'] for r in rs]
    r = {k: float(np.mean([p[k] for p in per])) for k in
         ('wall_ms', 'steady_wall_ms', 'compute_ms', 'wait_ms')}
    r['epoch_first_wait_ms'] = [x for p in per
                                for x in p['epoch_first_wait_ms']]
    stats['runs'][name] = r
    log(f'  10a record, {name}: {len(rs)} runs of {n} steps; window mean of '
        f'hits {r["wall_ms"]:.2f} ms/step, median not first '
        f'{r["steady_wall_ms"]:.2f}; the step alone {r["compute_ms"]:.2f}; '
        f'data wait mean not first {r["wait_ms"]:.3f} ms, epochs\' first '
        f'steps {", ".join(f"{x:.1f}" for x in r["epoch_first_wait_ms"])} '
        f'ms [{card}]')
  return stats


def monitor_cost(loop, digests, epoch, card):
  """10c's record: the window per step with the monitor off and on with
  a scrape every SCRAPE_SLOW_S, off on on off, serial loader."""
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.telemetry import server
  loader = get_bert_pretrain_data_loader(
      shard_path('pairs'), vocab_file=VOCAB_FILE,
      **digests['pairs']['settings'])
  n = SERVE_EPOCHS * epoch
  runs = {}
  for mode in ('off', 'on', 'on', 'off'):
    server.stop_monitor()
    if mode == 'on':
      os.environ['LDDL_MONITOR'] = '1'
    else:
      os.environ.pop('LDDL_MONITOR', None)
    mon = server.get_monitor()
    scraper = Scraper(mon, SCRAPE_SLOW_S) if mode == 'on' else None
    try:
      run = timed_epochs(loop, loader, epoch, n)
    finally:
      if scraper is not None:
        scraper.stop()
    if scraper is not None and (scraper.errors or not scraper.scrapes):
      raise AssertionError(f'10c: 1 Hz scraper: {scraper.errors[:3]}')
    runs.setdefault(mode, []).append(step_stats(run['steps'])['all'])
  server.stop_monitor()
  stats = {mode: {k: float(np.mean([p[k] for p in per]))
                  for k in ('wall_ms', 'steady_wall_ms')}
           for mode, per in runs.items()}
  log(f'  10c record: window mean of hits {stats["off"]["wall_ms"]:.2f} '
      f'ms/step with the monitor off, {stats["on"]["wall_ms"]:.2f} on with a '
      f'scrape every {SCRAPE_SLOW_S:.0f} s (medians not first '
      f'{stats["off"]["steady_wall_ms"]:.2f} / '
      f'{stats["on"]["steady_wall_ms"]:.2f}); off on on off, serial loader, '
      f'{n} steps a run [{card}]')
  return stats


def serve_kill(loop, digests, want, epoch, root, fleet, servers, card):
  """10b: the data server SIGKILLed before step SERVE_KILL_STEP; the
  monitor CLI lists it dead; a restarted server is re-attached after
  SERVE_REATTACH local batches; every batch is still the serial
  loader's."""
  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.core import log as tlog
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.loader.service import discover_data_servers
  from lddl_tpu_torch.telemetry import server
  settings = digests['pairs']['settings']
  want_sha = want[0]
  n = SERVE_EPOCHS * epoch
  os.environ['LDDL_MONITOR'] = '1'
  server.stop_monitor()
  first = ServerProc(settings, fleet, os.path.join(root, 'srv_k.log'),
                     window=SERVE_KILL_WINDOW).start()
  servers.append(first)
  events = {}

  def kill():
    first.kill()
    events['dead_cli'] = monitor_cli(fleet)
    events['restarted'] = ServerProc(
        settings, fleet, os.path.join(root, 'srv_r.log'),
        window=SERVE_KILL_WINDOW).start()
    servers.append(events['restarted'])

  tele = telemetry.enable()
  ledger_dir = os.path.join(root, 'ledger_b')
  try:
    loader = DigestingLoader(get_bert_pretrain_data_loader(
        shard_path('pairs'), vocab_file=VOCAB_FILE, num_workers=WORKERS,
        transport='network', **settings))
    loop.loader = loader
    with blake2b8_ledger(ledger_dir), on_steps(loop,
                                               {SERVE_KILL_STEP: kill}):
      losses = loop.run(loop.step + n, log_every=0)
    client = {k: tele.counter(f'serve.{k}').total
              for k in ('client_pulls', 'fallbacks', 'reattaches')}
  finally:
    telemetry.disable()
  if len(losses) != n or not all(np.isfinite(losses)):
    raise AssertionError(f'10b: {len(losses)} losses of {n}: {losses}')
  check_digests('10b, the batches the loop took', loader.digests, want_sha)
  rx = len(read_ledger(os.path.join(ledger_dir, 'ledger.rank0.jsonl'))
           .get('serve.rx', []))
  warned = [m for m in tlog._WARNED if 'server unreachable' in m]
  if (client['fallbacks'], client['reattaches'], n - rx) != (
      1, 1, SERVE_REATTACH) or len(warned) != 1:
    raise AssertionError(f'10b: fallbacks {client["fallbacks"]}, '
                         f'reattaches {client["reattaches"]}, {n - rx} '
                         f'local batches, warnings {warned}; want 1, 1, '
                         f'{SERVE_REATTACH} and one warning')
  rc, fleet_json = events['dead_cli']
  dead = [d for d in fleet_json.get('data_servers', [])
          if d['pid'] == first.pid and d['dead']]
  errors = [e for k, e in fleet_json['errors'].items()
            if first.url in k and 'dead' in e]
  if rc != 0 or not dead or not errors or list(fleet_json['ranks']) != ['0']:
    raise AssertionError(f'10c: after the kill the monitor CLI exited {rc} '
                         f'with data servers {fleet_json.get("data_servers")}'
                         f', errors {fleet_json["errors"]}, ranks '
                         f'{list(fleet_json["ranks"])}')
  restarted = events['restarted']
  context = check_no_cuda_context(restarted.pid, '10b')
  if restarted.stop() != 0:
    raise AssertionError(f'10b: the restarted server exited '
                         f'{restarted.proc.returncode}')
  left = discover_data_servers(fleet)
  if left or group_alive(first.pid) or first.proc.poll() is None:
    raise AssertionError(f'10b: left behind: announces {left}, the killed '
                         f'server alive {group_alive(first.pid)}')
  log(f'  10b: the server SIGKILLed before step {SERVE_KILL_STEP}: the client '
      f'degraded once ("{warned[0][:60]}..."), took {SERVE_REATTACH} batches '
      f'from its local loader, re-attached to the restarted server '
      f'({client["reattaches"]}); all {n} batches = the serial loader\'s, '
      f'{rx} over the wire; the monitor CLI listed the dead server as dead '
      f'("{errors[0][:50]}..."); no announce and no process left [{card}]')
  return {'steps': n, 'client': client, 'wire': rx, 'local': n - rx,
          'cuda_context': context}


def data_service(args, digests, card):
  """Phase 10: 10a, its timing record, 10c's monitor cost, 10b."""
  from lddl_tpu_torch.telemetry import server
  want = serve_expected(digests)
  keys = (*SERVE_ENV, 'LDDL_MONITOR', 'LDDL_MONITOR_DIR', 'LDDL_TELEMETRY_DIR',
          'LDDL_LOADER_TRANSPORT')
  saved = {k: os.environ.get(k) for k in keys}
  servers = []
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_serve_') as root:
    fleet = os.path.join(root, 'fleet')
    os.environ.update(SERVE_ENV, LDDL_MONITOR_DIR=fleet,
                      LDDL_TELEMETRY_DIR=os.path.join(root, 'telemetry'))
    try:
      loop, epoch, stats = serve_healthy(args, digests, want, root, fleet,
                                         servers, card)
      stats['timing'] = serve_timing(loop, digests, epoch, root, fleet,
                                     servers, card)
      stats['monitor_cost'] = monitor_cost(loop, digests, epoch, card)
      stats['kill'] = serve_kill(loop, digests, want, epoch, root, fleet,
                                 servers, card)
    finally:
      for s in servers:
        s.stop()
      server.stop_monitor()
      for k, v in saved.items():
        if v is None:
          os.environ.pop(k, None)
        else:
          os.environ[k] = v
  del loop
  torch.cuda.empty_cache()
  check_no_segments('phase 10')
  left = [s.pid for s in servers if s.proc.poll() is None or
          group_alive(s.pid)]
  if left:
    raise AssertionError(f'phase 10: data server processes left: {left}')
  log(f'  phase 10: all {len(servers)} data server processes have exited')
  return stats


# ---- phase 11: the ledger's step record, step replay, the flight recorder

# Checkpoints 8, 16 and 24 (the loop keeps three): the replays restore 8
# and 16, and the epoch ends at 22.
RECORD_STEPS = 24
RECORD_CKPT_EVERY = 8
# The 16th observed step is step 15: its incident's replay_step, 16, has a
# step line (a step line is written at a checkpoint), and 11b replays it.
RECORD_FAULT = 'raise:sentinel.trigger:nth=16'
RECORD_INCIDENT_STEP = 15
# The ring holds the batches of steps 9..16 (ordinals 8..15) at the capture,
# with the feed's prefetch beyond them.
RECORD_RING = 12
# (the step replayed, the checkpoint it restores): across the epoch's end at
# 22 (the bundled replay and the resumed run's restore the mid-epoch
# checkpoint 8).
REPLAYS = ((24, 16),)
# Within what 11a's ledger holds: its 24 steps and the feed's prefetch
# reach batch (1, 4).
BATCH_KEYS = ((0, 3), (0, 21), (1, 2))
FLIGHT_PROFILE_STEPS = 2
FINGERPRINT_REPS = 1
# 11f: the recording run resumed at its mid-epoch checkpoint RESUME_AT and
# run to RESUME_TO (a checkpoint there, every RECORD_CKPT_EVERY).
RESUME_AT, RESUME_TO = 8, 16
# The keys of a step line, the JAX loop's.
STEP_LINE_KEYS = ['boundary', 'digest', 'loss', 'n', 'rolling', 'samples',
                  'step']


def replay_loader_argv(digests):
  """The replay CLI's loader spec for pairs/ at the settings of the loop
  that recorded (pairs_build's)."""
  s = digests['pairs']['settings']
  return ['--vocab-file', VOCAB_FILE, '--batch-size',
          str(s['batch_size_per_rank']), '--bin-size', str(s['bin_size']),
          '--max-seq-length', str(s['max_seq_length']), '--masking',
          s['masking'], '--shuffle-buffer-size',
          str(s['shuffle_buffer_size']), '--base-seed', str(s['base_seed'])]


def replay_model_argv(args, digests):
  """The replay CLI's model arguments for the loop pairs_build makes."""
  s = digests['pairs']['settings']
  return ['--model', MODEL, '--attention', 'flash', '--seed',
          str(s['base_seed']), '--learning-rate', '1e-4', '--warmup-steps',
          '10', '--total-steps', '1000', '--max-predictions',
          str(args.max_predictions), '--device', DEVICE]


def run_cli(main_fn, argv):
  """``main_fn(argv)`` in this process: its exit code and its stdout
  (with its stderr after it when the exit code is not 0)."""
  import io
  out, err = io.StringIO(), io.StringIO()
  with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
    rc = main_fn(argv)
  return rc, out.getvalue() + (err.getvalue() if rc else '')


@contextlib.contextmanager
def environ(**env):
  """The enclosed code sees ``env`` in os.environ (None: unset)."""
  saved = {k: os.environ.get(k) for k in env}
  try:
    for k, v in env.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
    yield
  finally:
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v


def ledger_lines(path):
  with open(os.path.join(path, 'ledger.rank0.jsonl')) as f:
    return [json.loads(x) for x in f.read().splitlines()]


def record_run(args, digests, root, card):
  """11a: BERT-base from pairs/ through TrainLoop with the ledger and the
  sentinel on, checkpoints every RECORD_CKPT_EVERY steps, an injected
  sentinel trigger; returns the loop and what 11b-11e check against."""
  from lddl_tpu_torch.core import faults
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.telemetry import profiling, sentinel
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop, flight

  _, fp, bins = serve_expected(digests)
  settings = digests['pairs']['settings']
  paths = {k: os.path.join(root, k) for k in ('ckpt', 'ledger', 'incidents',
                                               'telemetry')}
  loop = TrainLoop.build(shard_path('pairs'), load_bert_tokenizer(VOCAB_FILE),
                         **pairs_build(args, settings))
  with environ(LDDL_SENTINEL='1', LDDL_FLIGHT_DIR=paths['incidents'],
               LDDL_FLIGHT_RING=str(RECORD_RING),
               LDDL_FLIGHT_PROFILE_STEPS=str(FLIGHT_PROFILE_STEPS),
               LDDL_TELEMETRY_DIR=paths['telemetry'],
               LDDL_FAULTS=RECORD_FAULT):
    faults.reset()
    sentinel.enable_sentinel()
    flight.enable_flight()
    try:
      with blake2b8_ledger(paths['ledger']):
        tfa.reset_launches()
        t0 = time.perf_counter()
        losses, printed = run_cli(lambda _: loop.run(
            RECORD_STEPS, ckpt_dir=paths['ckpt'],
            ckpt_every=RECORD_CKPT_EVERY, log_every=0), None)
        seconds = time.perf_counter() - t0
        counts = tfa.device_launches()
        host = dict(tfa.launches)
      status = sentinel.sentinel_status()
    finally:
      sentinel.disable_sentinel()
      flight.disable_flight()
      faults.reset()
  if len(losses) != RECORD_STEPS or not all(np.isfinite(losses)):
    raise AssertionError(f'11a: losses {losses}')
  n = RECORD_STEPS
  cfg = loop.model.cfg
  per_step = {'fwd': cfg.num_layers, 'dq': cfg.num_layers,
              'dkv': cfg.num_layers, 'fwd_seg': 0, 'dq_seg': 0, 'dkv_seg': 0}
  check_launches(counts, host, {k: m * n for k, m in per_step.items()},
                 f'11a, recording {n} steps')
  check_cache(loop.step_cache, bins, n, '11a, deterministic (ledger on)')
  lines = ledger_lines(paths['ledger'])
  if lines[0].get('algo') != 'blake2b8':
    raise AssertionError(f'11a: ledger meta {lines[0]}')
  steps = [r for r in lines[1:] if r['boundary'] == 'step']
  want_steps = sorted({*range(RECORD_CKPT_EVERY, n + 1, RECORD_CKPT_EVERY),
                       n})
  if [r['step'] for r in steps] != want_steps or any(
      sorted(r) != STEP_LINE_KEYS or
      r['samples'] != r['step'] * settings['batch_size_per_rank']
      for r in steps):
    raise AssertionError(f'11a: step lines {steps}; want steps {want_steps} '
                         f'with the keys {STEP_LINE_KEYS}')
  collate = sorted((r['epoch'], r['index'], r['digest']) for r in lines[1:]
                   if r['boundary'] == 'collate')
  # The feed's prefetch collates a batch or two beyond the run's last.
  if len(collate) < n or [d for _, _, d in collate] != fp[:len(collate)]:
    raise AssertionError('11a: the collate digests are not the serial '
                         'loader\'s (epoch 0: digests.json)')
  if 'incident captured' not in printed:
    raise AssertionError(f'11a: the loop printed {printed!r}')
  incidents = flight.scan_incidents(paths['incidents'])
  if len(incidents) != 1 or [i['dir'] for i in status['incidents']] != [
      incidents[0]['dir']]:
    raise AssertionError(f'11a: incidents {incidents}, sentinel status '
                         f'{status}; want exactly one')
  trace_dir = profiling.get_step_profiler().last_trace_dir
  traced = flash_calls_in_trace(trace_dir)
  want_traced = {k: FLIGHT_PROFILE_STEPS * m for k, m in per_step.items()
                 if m}
  if traced != want_traced:
    raise AssertionError(f'11a: the trace the incident armed ({trace_dir}) '
                         f'has flash calls {traced}; want {want_traced}')
  log(f'  11a: {n} steps recorded in {seconds:.1f} s (deterministic, the '
      f'ledger and the sentinel on); step lines at {want_steps} with the '
      f'JAX line\'s keys; {len(collate)} collate digests = the serial '
      f'loader\'s (epoch 0 = digests.json); one incident, '
      f'{incidents[0]["dir"]}, in the sentinel\'s status; the trace it '
      f'armed for {FLIGHT_PROFILE_STEPS} steps has flash calls {traced} '
      f'[{card}]')
  return loop, {'paths': paths, 'fp': fp, 'steps': steps,
                'incident': incidents[0], 'launches': counts,
                'record_seconds': seconds, 'losses': losses,
                'vocab_size': cfg.vocab_size}


def check_incident(rec, epoch):
  """11d's manifest checks: the trigger, its steps, the suspect and its
  digest against the ledger, the checkpoint, the ring."""
  inc = rec['incident']
  man = inc['manifest']
  s = RECORD_INCIDENT_STEP
  suspect = {'epoch': s // epoch, 'index': s % epoch}
  recorded = rec['fp'][s]
  ring = [e['ordinal'] for e in man['ring']]
  ckpt = {'dir': os.path.abspath(rec['paths']['ckpt']),
          'step': (s // RECORD_CKPT_EVERY) * RECORD_CKPT_EVERY}
  if (man['trigger']['detector'] != 'injected' or man['step'] != s or
      man['replay_step'] != s + 1 or man['suspect']['coordinate'] != suspect
      or man['suspect']['digest'] != recorded or man['checkpoint'] != ckpt
      or not set(range(ckpt['step'], s + 1)) <= set(ring)):
    raise AssertionError(
        f'11d: manifest trigger {man["trigger"]}, step {man["step"]}, '
        f'replay_step {man["replay_step"]}, suspect {man["suspect"]}, '
        f'checkpoint {man["checkpoint"]}, ring {ring}; want injected at '
        f'{s}, {s + 1}, suspect {suspect} with the ledger\'s {recorded}, '
        f'{ckpt}, ordinals {ckpt["step"]}..{s} in the ring')
  log(f'  11d: the manifest: trigger injected at step {s}, replay_step '
      f'{s + 1}, suspect {suspect} digest {recorded} = the ledger\'s collate '
      f'line, checkpoint {ckpt["step"]}, ring ordinals {ring[0]}..{ring[-1]}')


def batches_and_bundles(args, digests, rec, root):
  """11c in this process: ``batch`` at BATCH_KEYS against the ledger, a
  ``bundle`` of each batch from the incident's checkpoint to its suspect,
  and the corrupt drill (``corrupt:replay.read``: the bundled step is
  refused with exit 1)."""
  from lddl_tpu_torch.replay import cli
  paths = rec['paths']
  epoch = len(digests['pairs']['batches'])
  loader = ['--path', shard_path('pairs')] + replay_loader_argv(digests)
  got = []
  for e, i in BATCH_KEYS:
    rc, out = run_cli(cli.main, ['batch', paths['ledger'], '--key',
                                 f'epoch={e},index={i}', '--boundary',
                                 'collate', '--json'] + loader)
    res = json.loads(out) if rc in (0, 1) else {'printed': out[-2000:]}
    want = rec['fp'][e * epoch + i]
    if rc != 0 or not res['match'] or res.get('reconstructed') != want:
      raise AssertionError(f'11c: batch ({e}, {i}) exit {rc}: {res}; '
                           f'want {want}')
    got.append(res['reconstructed'])
  first = (RECORD_INCIDENT_STEP // RECORD_CKPT_EVERY) * RECORD_CKPT_EVERY
  bundles = []
  for i in range(first, RECORD_INCIDENT_STEP + 1):
    bundles.append(os.path.join(root, 'bundles', f'i{i}'))
    rc, out = run_cli(cli.main, [
        'bundle', paths['ledger'], '--key', f'epoch=0,index={i}', '--out',
        bundles[-1], '--boundary', 'collate', '--checkpoint-dir',
        paths['ckpt'], '--checkpoint-step', str(first)] + loader)
    if rc != 0:
      raise AssertionError(f'11c: bundle (0, {i}) exit {rc}: {out}')
  step = ['step', '--checkpoint-dir', paths['ckpt'], '--step',
          str(RECORD_INCIDENT_STEP + 1), '--ledger', paths['ledger']]
  for b in bundles:
    step += ['--bundle', b]
  # No corpus and no vocab file: the bundles hold the batches.
  step += replay_model_argv(args, digests) + [
      '--vocab-size', str(rec['vocab_size'])]
  from lddl_tpu_torch.core import faults
  with environ(LDDL_FAULTS='corrupt:replay.read'):
    faults.reset()
    try:
      rc, out = run_cli(cli.main, step)
    finally:
      faults.reset()
  if rc != 1:
    raise AssertionError(f'11c: a corrupt bundle gave exit {rc}: {out}; '
                         'want 1')
  log(f'  11c: batch at {list(BATCH_KEYS)}: digests {got} = the ledger\'s; '
      f'{len(bundles)} bundles (0, {first})..(0, {RECORD_INCIDENT_STEP}) '
      'written; with corrupt:replay.read the bundled step replay exits 1')
  return {'batch_digests': got, 'bundles': bundles, 'step_argv': step}


def replays_in_this_process(args, digests, rec, bundled, resumed):
  """11b (with 11c's bundled step and 11f's resumed replay and bisect)
  through the replay CLI's ``main``, and 11d's ``flight replay``
  through the incident CLI's, both in this process (the run that recorded
  them is gone: each replay builds its own loop from the checkpoints): every
  replay matches the recorded step line, 12 launches a replayed step of
  each of K1-K3, counted by the kernels on the device; the bisect of the
  resumed run over its ledger gives that run's losses bit for bit."""
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.replay import cli
  from lddl_tpu_torch.training import flight
  paths = rec['paths']
  model = replay_model_argv(args, digests)
  corpus = ['--path', shard_path('pairs')] + replay_loader_argv(digests)
  jobs = [(f'step {s} from checkpoint {c}, from the corpus',
           ['step', '--checkpoint-dir', paths['ckpt'], '--step', str(s),
            '--ledger', paths['ledger']] + corpus + model)
          for s, c in REPLAYS]
  jobs.append((f'step {RECORD_INCIDENT_STEP + 1} from '
               f'{len(bundled["bundles"])} bundles, no corpus',
               bundled['step_argv']))
  rp = resumed['paths']
  jobs.append((f'step {RESUME_TO} of the run resumed at {RESUME_AT}, from '
               'the corpus', ['step', '--checkpoint-dir', rp['ckpt'],
                              '--step', str(RESUME_TO), '--ledger',
                              rp['ledger']] + corpus + model))
  jobs.append((f'bisect ({RESUME_AT}, {RESUME_TO}] of the resumed run, with '
               'its ledger', ['bisect', '--checkpoint-dir', rp['ckpt'],
                              '--lo', str(RESUME_AT), '--hi',
                              str(RESUME_TO), '--ledger', rp['ledger']] +
               corpus + model))
  t_all = time.perf_counter()
  child = []
  for label, argv in jobs:
    tfa.reset_launches()
    t0 = time.perf_counter()
    rc, printed = run_cli(cli.main, argv + ['--json'])
    seconds = time.perf_counter() - t0
    res = json.loads(printed) if rc in (0, 1) else {'printed': printed[-2000:]}
    if argv[0] == 'step':
      res.pop('losses', None)
    child.append({'label': label, 'rc': rc, 'result': res,
                  'launches': tfa.device_launches(), 'seconds': seconds})
  inc = rec['incident']['dir']
  flight_argv = ['replay', inc, '--', '--checkpoint-dir', paths['ckpt'],
                 '--step', str(RECORD_INCIDENT_STEP + 1), '--ledger',
                 paths['ledger'], '--json', '--vocab-size',
                 str(rec['vocab_size'])] + model
  t0 = time.perf_counter()
  flight_rc, printed = run_cli(flight.main, flight_argv)
  flight_s = time.perf_counter() - t0
  seconds = time.perf_counter() - t_all
  from lddl_tpu_torch.training import MODEL_SIZES
  layers = MODEL_SIZES[MODEL]['num_layers']
  want_restored = [c for _, c in REPLAYS] + [
      (RECORD_INCIDENT_STEP // RECORD_CKPT_EVERY) * RECORD_CKPT_EVERY,
      RESUME_AT]
  wanted_steps = [s for s, _ in REPLAYS] + [RECORD_INCIDENT_STEP + 1,
                                            RESUME_TO]
  per = {'fwd': layers, 'dq': layers, 'dkv': layers, 'fwd_seg': 0,
         'dq_seg': 0, 'dkv_seg': 0}
  for job, restored, target in zip(child, want_restored, wanted_steps):
    res = job['result']
    want = {k: m * (target - restored) for k, m in per.items()}
    if (job['rc'] != 0 or res.get('match') is not True or
        res.get('restored_step') != restored or job['launches'] != want):
      raise AssertionError(f'11b: {job["label"]}: exit {job["rc"]}, '
                           f'{res}, launches {job["launches"]}; want a '
                           f'match from checkpoint {restored}, {want}')
    log(f'  11b: {job["label"]}: restored {restored}, bit-identical to the '
        f'recorded step line ({res["digest"]}), {job["seconds"]:.1f} s; '
        f'launches, counted on the device: {job["launches"]}')
  job = child[len(wanted_steps)]
  res = job['result']
  want = {k: m * (RESUME_TO - RESUME_AT) for k, m in per.items()}
  got = [x for _, x in res.get('losses', [])]
  if (job['rc'] != 0 or got != resumed['losses'] or
      res.get('stream_checked') is not True or job['launches'] != want):
    raise AssertionError(f'11f: {job["label"]}: exit {job["rc"]}, {res}, '
                         f'launches {job["launches"]}; want the resumed '
                         f'run\'s losses {resumed["losses"]}, {want}')
  log(f'  11f: {job["label"]}: the resumed run\'s losses bit for bit '
      f'(spike at step {res["spike_step"]}, batch '
      f'{res.get("batch_coordinate")}), {job["seconds"]:.1f} s; launches: '
      f'{job["launches"]}')
  if flight_rc != 0 or '"match": true' not in printed:
    raise AssertionError(f'11d: the incident CLI\'s replay exited '
                         f'{flight_rc}:\n{printed[-3000:]}')
  log(f'  11d: lddl_tpu_torch.training.flight replay <incident> -- ... '
      f'--step {RECORD_INCIDENT_STEP + 1}: exit 0, a match (its ring\'s '
      f'bundles from checkpoint {want_restored[-1]} on), {flight_s:.1f} s; '
      f'11b and it took {seconds:.1f} s in this process')
  return {'child': child, 'seconds': seconds}


def incident_cli(rec):
  """11d: the incident CLI's ``list``, ``show`` and ``replay`` (the
  suspect bundle's check) in this process."""
  from lddl_tpu_torch.training import flight
  inc = rec['incident']['dir']
  rcs = {}
  for argv in (['list', '--root', rec['paths']['incidents']], ['show', inc],
               ['replay', inc]):
    rc, out = run_cli(flight.main, argv)
    rcs[argv[0]] = rc
    if rc != 0 or (argv[0] == 'replay' and 'bundle ok' not in out) or (
        argv[0] == 'list' and inc not in out):
      raise AssertionError(f'11d: incident CLI {argv[0]} exit {rc}: {out}')
  log(f'  11d: the incident CLI\'s list, show and replay (the suspect '
      f'bundle\'s check) exit {rcs}')


def warned_ops(args, digests, loop):
  """Module 1: one epoch of pairs/ (every bin) and one packed step,
  eagerly, under deterministic algorithms with warn_only: the ops that
  warn (have no deterministic kernel)."""
  import warnings
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import MODEL_SIZES, TrainLoop
  epoch = len(digests['pairs']['batches'])
  packed = digests['packed']['settings']
  s = packed['max_seq_length']
  cfg = BertConfig(attention_impl='flash', dtype=torch.bfloat16,
                   max_position_embeddings=max(s, 512), **MODEL_SIZES[MODEL])
  messages = set()
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    with environ(LDDL_STEP_CACHE='0'), warnings.catch_warnings(
        record=True) as caught:
      warnings.simplefilter('always')
      loop.loader.seek(0, 0)
      loop.run(loop.step + epoch, log_every=0)
      ploop = TrainLoop.build(
          shard_path('packed'), load_bert_tokenizer(VOCAB_FILE),
          model_cfg=cfg, device=DEVICE, seed=packed['base_seed'],
          max_predictions=PACKED[2],
          batch_size_per_rank=packed['batch_size_per_rank'],
          max_seq_length=s, data_format='packed',
          block_diagonal=packed['block_diagonal'],
          loader_kwargs={'shuffle_buffer_size':
                         packed['shuffle_buffer_size']})
      ploop.run(1, log_every=0)
      del ploop
      torch.cuda.empty_cache()
    messages = sorted({str(w.message).split('\n')[0][:200] for w in caught
                       if 'determinis' in str(w.message)})
  finally:
    torch.use_deterministic_algorithms(False)
  log(f'  11e: ops that warn under deterministic algorithms (one step of '
      f'each bin of pairs/, eager; one packed s={s} step): '
      f'{messages or "none"}')
  return messages


def phase11_timing(args, digests, loop, root, card):
  """11e, for the record: ms/step with deterministic algorithms off and
  on (O N N O), then the loop's window per step with the ledger and the
  flight recorder off and on, deterministic both ways (F T T F); each run
  one epoch of pairs/ through the loop's graphs."""
  from lddl_tpu_torch.telemetry import sentinel
  from lddl_tpu_torch.training import flight
  epoch = len(digests['pairs']['batches'])
  det, rec = {False: [], True: []}, {False: [], True: []}
  for on in (False, True, True, False):
    torch.use_deterministic_algorithms(on)
    try:
      run = timed_epochs(loop, loop.loader, epoch, epoch)
    finally:
      torch.use_deterministic_algorithms(False)
    det[on].append(step_stats(run['steps'])['all'])
  for i, on in enumerate((False, True, True, False)):
    torch.use_deterministic_algorithms(True)
    try:
      if on:
        sentinel.enable_sentinel()
        flight.enable_flight(out_dir=os.path.join(root, f'quiet{i}'))
        with blake2b8_ledger(os.path.join(root, f'ledger_e{i}')):
          run = timed_epochs(loop, loop.loader, epoch, epoch)
      else:
        run = timed_epochs(loop, loop.loader, epoch, epoch)
    finally:
      sentinel.disable_sentinel()
      flight.disable_flight()
      torch.use_deterministic_algorithms(False)
    rec[on].append(step_stats(run['steps'])['all'])
  out = {
      'det_off_step_ms': [x['compute_ms'] for x in det[False]],
      'det_on_step_ms': [x['compute_ms'] for x in det[True]],
      'det_off_window_ms': [x['wall_ms'] for x in det[False]],
      'det_on_window_ms': [x['wall_ms'] for x in det[True]],
      'recorder_off_window_ms': [x['wall_ms'] for x in rec[False]],
      'recorder_on_window_ms': [x['wall_ms'] for x in rec[True]],
      'recorder_off_step_ms': [x['compute_ms'] for x in rec[False]],
      'recorder_on_step_ms': [x['compute_ms'] for x in rec[True]]}
  log(f'  11e: the step alone, median of hits, deterministic off '
      f'{fmt_ms(out["det_off_step_ms"])} / on {fmt_ms(out["det_on_step_ms"])}'
      f' ms (O N N O; windows {fmt_ms(out["det_off_window_ms"])} / '
      f'{fmt_ms(out["det_on_window_ms"])}) [{card}]')
  log(f'  11e: the window per step, mean of hits, deterministic, ledger and '
      f'recorder off {fmt_ms(out["recorder_off_window_ms"])} / on '
      f'{fmt_ms(out["recorder_on_window_ms"])} ms (F T T F; the step alone '
      f'{fmt_ms(out["recorder_off_step_ms"])} / '
      f'{fmt_ms(out["recorder_on_step_ms"])}) [{card}]')
  return out


def fmt_ms(xs):
  return ', '.join(f'{x:.2f}' for x in xs)


def fingerprint_cost(loop, card):
  """11e: ms of one ``step`` fingerprint at BERT-base: the CPU copy that
  save() makes anyway, and the hash, in blake2b-8 and in this host's own
  algorithm."""
  from lddl_tpu_torch.telemetry import ledger
  from lddl_tpu_torch.training.pretrain import _cpu_copy, state_fingerprint
  out = {'copy_ms': [], 'hash_ms': {}}
  snap = None
  for _ in range(FINGERPRINT_REPS):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = _cpu_copy(loop._state())
    out['copy_ms'].append(1e3 * (time.perf_counter() - t0))
  nbytes = sum(t.numel() * t.element_size() for t in
               [*snap['model'].values(), *snap['opt']['mu'],
                *snap['opt']['nu']])
  for label, ctx in (('blake2b8', blake2b8), (ledger.ALGO,
                                               contextlib.nullcontext)):
    with ctx():
      ms = []
      for _ in range(FINGERPRINT_REPS):
        t0 = time.perf_counter()
        state_fingerprint(snap)
        ms.append(1e3 * (time.perf_counter() - t0))
    out['hash_ms'][label] = ms
  out['state_bytes'] = nbytes
  log(f'  11e: one step fingerprint of {nbytes / 2**30:.2f} GiB of state: '
      f'the CPU copy {fmt_ms(out["copy_ms"])} ms; the hash ' +
      '; '.join(f'{k} {fmt_ms(v)} ms' for k, v in out['hash_ms'].items()) +
      f' [{card}]')
  return out


def resumed_run(loop, rec, root, card):
  """11f: the recording run preempted after its checkpoint RESUME_AT and
  resumed there to RESUME_TO (``restore`` re-seeks the loader with resume
  semantics: another shuffle than the uninterrupted run's), with the
  ledger and tracing on. Its ledger is 11a's up to the step line at
  RESUME_AT, as a run killed after that checkpoint leaves it, then the
  resumed session's; its trace and telemetry are exported."""
  import shutil
  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.training import export_telemetry
  from lddl_tpu_torch.training.pretrain import _step_dirs
  paths = {k: os.path.join(root, f'resumed_{k}')
           for k in ('ckpt', 'ledger', 'telemetry')}
  with open(os.path.join(rec['paths']['ledger'], 'ledger.rank0.jsonl')) as f:
    lines = f.read().splitlines()
  cut = next(i for i, x in enumerate(lines)
             if json.loads(x).get('boundary') == 'step' and
             json.loads(x)['step'] == RESUME_AT)
  os.makedirs(paths['ledger'])
  with open(os.path.join(paths['ledger'], 'ledger.rank0.jsonl'), 'w') as f:
    f.write('\n'.join(lines[:cut + 1]) + '\n')
  src = dict(_step_dirs(rec['paths']['ckpt']))[RESUME_AT]
  shutil.copytree(src, os.path.join(paths['ckpt'], os.path.basename(src)))
  loop.restore(paths['ckpt'], step=RESUME_AT)
  with environ(LDDL_TELEMETRY_DIR=paths['telemetry']):
    telemetry.enable()
    telemetry.enable_trace()
    try:
      with blake2b8_ledger(paths['ledger']):
        tfa.reset_launches()
        losses, _ = run_cli(lambda _: loop.run(
            RESUME_TO, ckpt_dir=paths['ckpt'], ckpt_every=RECORD_CKPT_EVERY,
            log_every=0), None)
        counts = tfa.device_launches()
        host = dict(tfa.launches)
      written, _ = run_cli(lambda _: export_telemetry(), None)
    finally:
      telemetry.disable()
      telemetry.disable_trace()
  n = RESUME_TO - RESUME_AT
  if len(losses) != n or not all(np.isfinite(losses)):
    raise AssertionError(f'11f: losses {losses}')
  layers = loop.model.cfg.num_layers
  check_launches(counts, host, {k: (n * layers if k in ('fwd', 'dq', 'dkv')
                                    else 0) for k in counts},
                 f'11f, the run resumed at {RESUME_AT}')
  if losses == rec['losses'][RESUME_AT:RESUME_TO]:
    raise AssertionError('11f: the resumed run fed the uninterrupted run\'s '
                         'batches; a mid-epoch restore re-seeks with resume '
                         'semantics')
  steps = [r['step'] for r in ledger_lines(paths['ledger'])
           if r.get('boundary') == 'step']
  if steps[-1] != RESUME_TO or sorted(
      os.path.basename(p) for p in written) != ['telemetry.rank0.jsonl',
                                                'trace.rank0.jsonl']:
    raise AssertionError(f'11f: step lines {steps}, exported {written}')
  log(f'  11f: resumed at checkpoint {RESUME_AT} and run to {RESUME_TO} with '
      f'the ledger and tracing on: losses {losses[0]:.4f} -> '
      f'{losses[-1]:.4f} (not the uninterrupted run\'s), step lines '
      f'{steps}, trace and telemetry exported [{card}]')
  return {'paths': paths, 'losses': losses, 'launches': counts}


def gate_and_trace(digests, rec, resumed, history, card, analyze_cache=None):
  """11g, after phase 12: ``python -m lddl_tpu_torch.telemetry.perf
  --gate`` with 11a's ledger of two epochs (``--audit``: the auditor's
  self-check, ``diff run run``, which the device records keyed by their
  batch's (epoch, index) pass; the replay smoke over the pairs loader),
  phase 11's incident tree and phase 12's bench history: exit 1 for the
  one injected incident, the audit and the smoke ok, a verdict line per
  series and no regression, the concurrency leg linting the port with
  the port's analyzer (clean; over ``analyze_cache``, 20a's warm
  ``LDDL_ANALYZE_CACHE``, where given); ``python -m
  lddl_tpu_torch.telemetry.audit verify`` of 11e's two ledgers of one epoch each, the first against the
  second: exit 0; then ``python -m lddl_tpu_torch.telemetry.trace`` over
  11f's traced run (exit 0, a merged document with events) and over an
  empty directory (exit 2)."""
  from lddl_tpu_torch.telemetry.perf import load_history_jsonl
  kwargs = dict(path=shard_path('pairs'), vocab_file=VOCAB_FILE,
                **digests['pairs']['settings'])
  epochs = sorted({r['epoch'] for r in ledger_lines(rec['paths']['ledger'])
                   if r.get('boundary') == 'device'})
  if epochs != [0, 1]:
    raise AssertionError(f'11g: 11a\'s device records span epochs {epochs}')
  root = os.path.dirname(rec['paths']['ledger'])
  ledgers = [os.path.join(root, f'ledger_e{i}') for i in (1, 2)]
  p = subprocess.run([sys.executable, '-m', 'lddl_tpu_torch.telemetry.audit',
                      'verify', *ledgers], cwd=HERE, capture_output=True,
                     text=True, timeout=RANK_TIMEOUT)
  if p.returncode != 0:
    raise AssertionError(f'11g: audit verify of 11e\'s ledgers exited '
                         f'{p.returncode}:\n{p.stdout[-3000:]}')
  log('  11g: python -m lddl_tpu_torch.telemetry.audit verify over 11e\'s '
      'two ledgers: exit 0')
  cmd = [sys.executable, '-m', 'lddl_tpu_torch.telemetry.perf', '--gate',
         '--audit', rec['paths']['ledger'], '--replay-smoke',
         '--replay-factory',
         'lddl_tpu_torch.loader.bert:get_bert_pretrain_data_loader',
         '--replay-kwargs-json', json.dumps(kwargs), '--incidents',
         rec['paths']['incidents'], '--root', os.path.dirname(history)]
  env = dict(os.environ)
  if analyze_cache:
    env['LDDL_ANALYZE_CACHE'] = analyze_cache
  t0 = time.perf_counter()
  p = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                     timeout=RANK_TIMEOUT, env=env)
  seconds = time.perf_counter() - t0
  verdicts = dict(
      (m.group(2), m.group(1)) for m in
      re.finditer(r'^\s*(ok|regression|insufficient-data)\s+(\S+)\s+n=',
                  p.stdout, re.M))
  series = sorted(load_history_jsonl(history))
  step = RECORD_INCIDENT_STEP
  if (p.returncode != 1 or 'lddl-perf: determinism audit ok' not in p.stdout
      or not re.search(r'replay-smoke collate: ok', p.stdout)
      or f'injected at step {step}' not in p.stderr
      or 'concurrency lint unavailable' in p.stderr
      or 'lddl-perf: concurrency lint clean' not in p.stdout
      or sorted(verdicts) != series
      or 'regression' in verdicts.values()):
    raise AssertionError(f'11g: the perf gate exited {p.returncode}, '
                         f'verdicts {verdicts} for series {series}:\n'
                         f'{p.stdout[-3000:]}\n{p.stderr[-3000:]}')
  log(f'  11g: python -m lddl_tpu_torch.telemetry.perf --gate: exit 1 for '
      f'the injected incident at step {step}; determinism audit of 11a\'s '
      f'two-epoch ledger ok, replay smoke ok; verdicts {verdicts} over phase '
      f'12\'s history; the concurrency leg linted lddl_tpu_torch/ with the '
      f'port\'s analyzer: clean ({seconds:.1f} s)')
  traced = resumed['paths']['telemetry']
  merged = os.path.join(traced, 'merged.json')
  empty = os.path.join(os.path.dirname(traced), 'no_trace')
  os.makedirs(empty)
  rcs = []
  for argv in (['--dir', traced, '-o', merged], ['--dir', empty]):
    rcs.append(subprocess.run(
        [sys.executable, '-m', 'lddl_tpu_torch.telemetry.trace', *argv],
        cwd=HERE, capture_output=True, text=True,
        timeout=RANK_TIMEOUT).returncode)
  with open(merged) as f:
    doc = json.load(f)
  events = len(doc['traceEvents'])
  if rcs != [0, 2] or not events or doc['metadata']['lddl']['ranks'] != [0]:
    raise AssertionError(f'11g: the trace CLI exited {rcs}; {events} events')
  log(f'  11g: python -m lddl_tpu_torch.telemetry.trace over 11f\'s run: '
      f'exit 0, {events} events; over a directory with no trace: exit 2')
  return {'gate_rc': p.returncode, 'verdicts': verdicts,
          'gate_seconds': seconds, 'trace_events': events}


def record_and_replay(args, digests, root, card):
  """Phase 11: 11a, 11c, 11f, 11b with 11d's replay, 11d, 11e; its files
  stay under ``root`` for 11g."""
  loop, rec = record_run(args, digests, root, card)
  check_incident(rec, len(digests['pairs']['batches']))
  bundled = batches_and_bundles(args, digests, rec, root)
  resumed = resumed_run(loop, rec, root, card)
  replays = replays_in_this_process(args, digests, rec, bundled, resumed)
  incident_cli(rec)
  warned = warned_ops(args, digests, loop)
  timing = phase11_timing(args, digests, loop, root, card)
  cost = fingerprint_cost(loop, card)
  del loop
  torch.cuda.empty_cache()
  return {'launches': rec['launches'],
          'resumed_launches': resumed['launches'],
          'replay_launches': [j['launches'] for j in replays['child']],
          'record_seconds': rec['record_seconds'],
          'replay_seconds': replays['seconds'], 'warned_ops': warned,
          'timing': timing, 'fingerprint': cost}, rec, resumed


# ---- phase 12: the K-step scan window ----

# (label, seq_len, batch, K, packed): phases 5 and 6's widths; K=4 packed
# is long_context_bench.py's default window.
SCAN_CELLS = (('s128_b64_k8', 128, 64, 8, False),
              ('s512_b16_k8', 512, 16, 8, False),
              ('packed_s8192_b2_k4', PACKED[0], PACKED[1], 4, True))
# Windows in each timed window run (W); a per-step run (S) takes as many
# steps.
SCAN_TIMED_WINDOWS = 2


def card_memory():
  """(bytes reserved, bytes allocated at peak) on the card."""
  return torch.cuda.memory_reserved(), torch.cuda.max_memory_allocated()


def pool_bytes(fn):
  """Bytes the card's allocator holds more after ``fn()`` (a capture:
  its graph's private pool) than before, the caches emptied around it."""
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  before = card_memory()[0]
  fn()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  return card_memory()[0] - before


def peak_bytes(fn):
  """Peak bytes allocated on the card while ``fn()`` runs."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  fn()
  torch.cuda.synchronize()
  return card_memory()[1]


def device_busy(fn, steps):
  """torch.profiler over ``fn()`` (``steps`` train steps): device busy ms
  per step, kernels per step and the flash kernels' calls per step."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  kernels = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
  flash = {}
  for e in kernels:
    m = FLASH_KERNEL_NAME.search(e.key)
    if m:
      name = m.group(1) + ('_seg' if m.group(2) == 'true' else '')
      flash[name] = flash.get(name, 0) + e.count / steps
  return (sum(e.self_device_time_total for e in kernels) / 1e3 / steps,
          sum(e.count for e in kernels) / steps, flash)


def train_state(loop):
  """Copies of everything a step changes: params, AdamW's mu, nu,
  count_t and host count."""
  opt = loop.opt
  return ([p.detach().clone() for p in opt.params],
          [t.clone() for t in opt.mu], [t.clone() for t in opt.nu],
          opt.count_t.clone(), opt.count)


def load_train_state(loop, state):
  """Put ``state`` (train_state's) back into the live tensors, in place,
  so the captured graphs stay valid."""
  with torch.no_grad():
    for p, t in zip(loop.opt.params, state[0]):
      p.copy_(t)
  loop.opt.load_state_dict({'count': state[4], 'mu': state[1],
                            'nu': state[2]})


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def same_bits(a, b):
  """Whether two lists of tensors (or two tensors) are equal bit for
  bit (floats compared as their bits: NaN payloads and signed zeros
  count)."""
  if isinstance(a, torch.Tensor):
    a, b = [a], [b]

  def bits(t):
    return t.view(_INT_OF_SIZE[t.element_size()]) if (
        t.is_floating_point()) else t

  return len(a) == len(b) and all(
      x.dtype == y.dtype and x.shape == y.shape and
      torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def check_window_bits(loop, label, batches, windows, seed, k):
  """(a) Under deterministic algorithms with dropout on, from one state:
  K per-step cache hits and one window hit over the same K batches leave
  the params, mu, nu, count_t and the host count, and the last step's
  metrics, bit-equal. Returns the two graphs' counts."""
  from lddl_tpu_torch.parallel.train import make_scan_train_step
  from lddl_tpu_torch.training.pretrain import CompiledStepCache
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    cache = CompiledStepCache(loop.step_fn)
    win = make_scan_train_step(loop.model, loop.opt, loop.max_predictions)
    cache(batches[0], seed)
    win(windows[0], seed)
    start = train_state(loop)
    for b in batches[k:2 * k]:
      want = cache(b, seed)
    want = {n: t.clone() for n, t in want.items()}
    stepped = train_state(loop)
    load_train_state(loop, start)
    got = win(windows[1], seed)
    windowed = train_state(loop)
  finally:
    torch.use_deterministic_algorithms(False)
  parts = ('params', 'mu', 'nu', 'count_t')
  diff = [n for n, x, y in zip(parts, windowed, stepped) if not same_bits(x, y)]
  if windowed[4] != stepped[4]:
    diff.append(f'host count {windowed[4]} vs {stepped[4]}')
  if sorted(got) != sorted(want) or not all(
      same_bits(got[n], want[n]) for n in want):
    diff.append(f'metrics {got} vs {want}')
  counts = {'cache': (cache.misses, cache.hits),
            'window': (win.captures, win.hits)}
  if diff or counts != {'cache': (1, k), 'window': (1, 1)}:
    raise AssertionError(f'12a ({label}): one window vs {k} per-step cache '
                         f'hits, deterministic, dropout 0.1: {diff} differ; '
                         f'graph counts {counts}')
  log(f'  12a ({label}): one window = {k} per-step cache hits bit for bit '
      f'(params, mu, nu, count_t, host count {windowed[4]}, the last '
      f'step\'s metrics: loss {float(got["loss"]):.6f}), deterministic, '
      'dropout 0.1')
  del cache, win
  return counts


def scan_cell(args, card, history, label, s, b, k, packed):
  """Phase 12 at one width: the window against the per-step graph."""
  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
  from lddl_tpu_torch.loader.device import prefetch_to_device
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.parallel.train import (make_scan_train_step,
                                             stack_batch_window)
  from lddl_tpu_torch.telemetry.perf import append_history
  from lddl_tpu_torch.training import MODEL_SIZES, TrainLoop
  from lddl_tpu_torch.training.pretrain import CompiledStepCache

  cfg = BertConfig(attention_impl='flash', dtype=torch.bfloat16,
                   max_position_embeddings=max(s, 512), **MODEL_SIZES[MODEL])
  max_predictions = PACKED[2] if packed else args.max_predictions
  loop = TrainLoop.build(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
                         warmup_steps=10, total_steps=1000, seed=args.seed,
                         max_predictions=max_predictions, max_seq_length=s)
  if cfg.dropout_rate != 0.1:
    raise AssertionError('phase 12 runs with dropout 0.1')
  host = (PackedLoader(s, b, 2 * k, args.seed) if packed else
          BinLoader(s, b, 2 * k, args.seed, dynamic_mask_tokens)).batches
  seed = loop.dropout_seed
  batches = [{n: torch.from_numpy(v).to(DEVICE) for n, v in x.items()}
             for x in host]
  windows = [stack_batch_window(host[i * k:(i + 1) * k], DEVICE)
             for i in range(2)]
  seg = '_seg' if packed else ''
  per_step = {n + x: (cfg.num_layers if x == seg else 0)
              for n in ('fwd', 'dq', 'dkv') for x in ('', '_seg')}
  out = {'label': label, 'seq_len': s, 'batch': b, 'k': k}

  # The per-step graph and the window: their captures and pools.
  cache = CompiledStepCache(loop.step_fn)
  win = make_scan_train_step(loop.model, loop.opt, max_predictions)
  out['step_pool_gib'] = pool_bytes(lambda: cache(batches[0], seed)) / 2**30
  out['window_pool_gib'] = pool_bytes(lambda: win(windows[0], seed)) / 2**30
  out['window_capture_s'] = win.capture_seconds
  out['window_miss_s'] = win.miss_seconds
  out['step_miss_s'] = cache.retrace_seconds

  # (b) one window's launches, counted on the device: counts at 0 just
  # before, read just after.
  tfa.reset_launches()
  metrics = win(windows[1], seed)
  counts = tfa.device_launches()
  check_launches(counts, dict(tfa.launches),
                 {n: m * k for n, m in per_step.items()},
                 f'12b, one window of {k} steps ({label})')
  out['window_launches'] = counts
  if not np.isfinite(float(metrics['loss'])):
    raise AssertionError(f'12 ({label}): loss {metrics["loss"]}')

  # Timed in alternating runs, W S S W, the batches already on the card.
  def run_windows():
    times = []
    for j in range(SCAN_TIMED_WINDOWS):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      win(windows[j % 2], seed)
      torch.cuda.synchronize()
      times.append(time.perf_counter() - t0)
    return times

  def run_steps(read_loss):
    n = SCAN_TIMED_WINDOWS * k
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
      metrics = cache(batches[i % len(batches)], seed)
      if read_loss:
        float(metrics['loss'])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n

  # W: windows, each read once (a sync a window). S: per-step hits, each
  # step's loss read as TrainLoop.run reads it. Q: per-step hits queued
  # with no read (the device never waits for the host if the host keeps
  # ahead).
  w_ms, s_ms, q_ms = [], [], []
  for kind in 'WSQQSW':
    if kind == 'W':
      times = run_windows()
      w_ms.append(1e3 * sum(times) / len(times) / k)
      for t in times:
        append_history(history, {'cell': label,
                                 f'window_step_ms_{label}': 1e3 * t / k})
    else:
      (s_ms if kind == 'S' else q_ms).append(1e3 * run_steps(kind == 'S'))
  out['window_ms_per_step'], out['step_ms_per_step'] = w_ms, s_ms
  out['queued_step_ms_per_step'] = q_ms
  out['window_peak_gib'] = peak_bytes(lambda: win(windows[0], seed)) / 2**30
  out['step_peak_gib'] = peak_bytes(
      lambda: [cache(x, seed) for x in batches[:k]]) / 2**30

  # The idle share by profiler: one window against K per-step hits.
  wb, wk, wf = device_busy(lambda: win(windows[0], seed), k)
  sb, sk, sf = device_busy(lambda: [cache(x, seed) for x in batches[:k]], k)
  want_flash = {n: m for n, m in per_step.items() if m}
  if wf != want_flash or sf != want_flash:
    raise AssertionError(f'12 ({label}): the profiler saw flash calls per '
                         f'step {wf} (window), {sf} (per step); want '
                         f'{want_flash}')
  w_mean, s_mean = float(np.mean(w_ms)), float(np.mean(s_ms))
  out.update(window_busy_ms=wb, step_busy_ms=sb, window_kernels=wk,
             step_kernels=sk, window_idle=1 - wb / w_mean,
             step_idle=1 - sb / s_mean)

  # (c) one capture per (signature, K), every later window a hit; the
  # per-step graph one miss. (d) the card runs the graph.
  runs = 2 + 2 * SCAN_TIMED_WINDOWS + 2
  graphs = {'window': (win.captures, win.hits),
            'cache': (cache.misses, cache.hits)}
  want = {'window': (1, runs - 1),
          'cache': (1, 4 * SCAN_TIMED_WINDOWS * k + 2 * k)}
  if graphs != want or win.mode != 'graph':
    raise AssertionError(f'12c/d ({label}): graph counts {graphs}, want '
                         f'{want}; mode {win.mode}')
  del cache, win
  torch.cuda.empty_cache()

  # (a) bit-equality under deterministic algorithms.
  out['deterministic_graphs'] = check_window_bits(loop, label, batches,
                                                  windows, seed, k)

  # The copies: stack_batch_window per window, host time of the call and
  # to the copies' end, against the feed's train.h2d_seconds per batch.
  stack_s, done_s = [], []
  for j in range(4):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack_batch_window(host[(j % 2) * k:(j % 2 + 1) * k], DEVICE)
    stack_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    done_s.append(time.perf_counter() - t0)
  tele = telemetry.enable()
  try:
    for _ in prefetch_to_device(iter(host), DEVICE):
      pass
    h2d = histogram(tele, 'train.h2d_seconds')
  finally:
    telemetry.disable()
  out.update(stack_ms_per_window=1e3 * float(np.median(stack_s[1:])),
             stack_done_ms_per_window=1e3 * float(np.median(done_s[1:])),
             feed_h2d_ms_per_batch=1e3 * h2d[1] / max(h2d[0], 1))
  log(f'  12 ({label}): ms/step window {fmt_ms(w_ms)} vs per-step graph '
      f'{fmt_ms(s_ms)} with each loss read, {fmt_ms(q_ms)} queued (W S Q Q '
      f'S W, {SCAN_TIMED_WINDOWS} windows of {k} a W); device busy '
      f'{wb:.2f} vs {sb:.2f} ms/step, idle {100 * out["window_idle"]:.1f}% '
      f'vs {100 * out["step_idle"]:.1f}% (against the loss-read per-step '
      f'time), kernels/step {wk:.0f} vs {sk:.0f} [{card}]')
  log(f'  12 ({label}): capture + instantiate {capture_summary(out)}; '
      f'graph pool {out["window_pool_gib"]:.2f} GiB (window) vs '
      f'{out["step_pool_gib"]:.2f} GiB (per step), peak allocated over the '
      f'hits {out["window_peak_gib"]:.2f} vs {out["step_peak_gib"]:.2f} '
      f'GiB; stack_batch_window {out["stack_ms_per_window"]:.2f} ms a '
      f'window ({out["stack_done_ms_per_window"]:.2f} ms to the copies\' '
      f'end) vs the feed\'s h2d {out["feed_h2d_ms_per_batch"]:.2f} ms a '
      f'batch [{card}]')
  del loop, batches, windows
  torch.cuda.empty_cache()
  return out


def capture_summary(out):
  """The window's capture time beside its miss and the per-step graph's
  miss."""
  return (f'{out["window_capture_s"]:.2f} s of a {out["window_miss_s"]:.2f} '
          f's miss (the rest ran the K steps eagerly; the per-step graph\'s '
          f'miss {out["step_miss_s"]:.2f} s)')


def scan_window(args, card, history):
  """Phase 12: the K-step scan window at SCAN_CELLS' widths, each
  window's time appended to ``history`` (a bench-history JSONL)."""
  cells = [scan_cell(args, card, history, *cell) for cell in SCAN_CELLS]
  return {c['label']: c for c in cells}


# ---- phase 13: the BART text-infilling loader on the card ----

BART_FACTORY = 'lddl_tpu_torch.loader.bart:get_bart_pretrain_data_loader'
BART_EPOCHS = 2          # digests.json holds epochs 0 and 1
BART_WORKERS = 2
BART_THREADS = (1, 8)    # the encoder's thread counts timed in 13b
TOKENIZE_REPS = 5
# (f) the replay CLI rebuilds the recorded batch at this (epoch, index).
BART_REPLAY_KEY = (1, 3)


def bart_kwargs(digests, **kw):
  """The BART loader at digests.json's settings (the loader's defaults:
  batch 64, 128 tokens, noise density 0.3, Poisson lambda 3)."""
  return dict(path=shard_path('bart'), vocab_file=VOCAB_FILE,
              **digests['bart']['settings'], **kw)


def bart_want(digests):
  return digests['bart']['batches_by_epoch'][:BART_EPOCHS]


def bart_chunks(root=None):
  """Every ``sentences`` chunk of bart/ (or of the set at ``root``), read
  by the port's Parquet reader in the loaders' file order, rows in file
  order."""
  from lddl_tpu_torch.core.utils import get_all_parquets_under
  from lddl_tpu_torch.pipeline.parquet_io import ParquetFile
  chunks = []
  for path in get_all_parquets_under(root or shard_path('bart')):
    with ParquetFile(path) as pf:
      for batch in pf.iter_batches():
        chunks += list(batch.column('sentences'))
  return chunks


def bart_build(card):
  """13a: build the wordpiece library from the checkout's source."""
  from lddl_tpu_torch.native import build as native_build
  t0 = time.perf_counter()
  native_build.library()
  seconds = time.perf_counter() - t0
  built = native_build.build_info['seconds']
  how = (f'built with {native_build._toolchain()[0]} in {built:.2f} s'
         if built is not None else 'built before this run, loaded')
  log(f'  13a: {native_build.library_path().name}: {how} ({seconds:.2f} s '
      f'to first use) [{card}]')
  return {'build_seconds': built, 'first_use_seconds': seconds}


def bart_tokenize(digests, card):
  """13b: every chunk of bart/ through the port's tokenizer: the sha256 of
  its ids and offsets = digests.json's (lddl_tpu's HF tokenizer); then
  the encoder alone at each of BART_THREADS, timed."""
  from lddl_tpu_torch.native import NativeWordPiece
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  want = digests['bart']['token_sha256']
  chunks = bart_chunks()
  tok = load_bert_tokenizer(VOCAB_FILE)
  ids, offsets = tok.encode_batch_ids(chunks)
  if (token_sha256(ids, offsets) != want or
      len(chunks) != digests['bart']['chunks']):
    raise AssertionError(f'13b: the ids of {len(chunks)} chunks are not '
                         'lddl_tpu\'s HF tokenizer\'s (digests.json)')
  nbytes = sum(len(c.encode()) for c in chunks)
  rates = {}
  for threads in BART_THREADS:
    enc = NativeWordPiece(tok.vocab_words, num_threads=threads)
    times = []
    for _ in range(TOKENIZE_REPS):
      t0 = time.perf_counter()
      got = enc.encode_batch_ids(chunks)
      times.append(time.perf_counter() - t0)
      if token_sha256(*got) != want:
        raise AssertionError(f'13b: {threads} threads give other ids')
    best = float(np.median(times))
    rates[threads] = {'ms': 1e3 * best, 'tokens_per_s': len(ids) / best,
                      'mb_per_s': nbytes / best / 1e6}
  log(f'  13b: {len(chunks)} chunks, {len(ids)} tokens, {nbytes} bytes: '
      f'sha256 = digests.json (lddl_tpu\'s HF tokenizer); ' + ', '.join(
          f'{t} thread(s) {r["tokens_per_s"]:.3e} tokens/s '
          f'({r["ms"]:.2f} ms, median of {TOKENIZE_REPS})'
          for t, r in rates.items()) + f' [{card}]')
  return {'chunks': len(chunks), 'tokens': len(ids), 'bytes': nbytes,
          'threads': rates}


def bart_serial(digests, card):
  """13c: the serial loader, BART_EPOCHS epochs, every batch = digests.json;
  samples/s over the epochs and each collate's time."""
  from lddl_tpu_torch.loader import get_bart_pretrain_data_loader
  loader = get_bart_pretrain_data_loader(**bart_kwargs(digests))
  collate, collate_s = loader._collate, []

  def timed(*a):
    t0 = time.perf_counter()
    out = collate(*a)
    collate_s.append(time.perf_counter() - t0)
    return out

  loader._collate = timed
  t0 = time.perf_counter()
  epochs = [list(loader) for _ in range(BART_EPOCHS)]
  seconds = time.perf_counter() - t0
  for e, (got, want) in enumerate(zip(epochs, bart_want(digests))):
    check_digests(f'13c, epoch {e}', [batch_sha256(b) for b in got], want)
  n = sum(len(e) for e in epochs)
  samples = n * loader.batch_size
  stats = {'batches': n, 'samples_per_s': samples / seconds,
           'seconds': seconds,
           'collate_p50_ms': ms(collate_s, np.median),
           'collate_p99_ms': ms(collate_s, lambda x: np.percentile(x, 99))}
  log(f'  13c: serial, {BART_EPOCHS} epochs of {n // BART_EPOCHS} batches of '
      f'{loader.batch_size} = digests.json; {stats["samples_per_s"]:.0f} '
      f'samples/s, collate p50 {stats["collate_p50_ms"]:.2f} ms, p99 '
      f'{stats["collate_p99_ms"]:.2f} ms [{card}]')
  return stats, epochs


def bart_workers(digests, card):
  """13d: the same through BART_WORKERS worker processes over the shm
  ring: the same digests, and no ``lddltorch_`` segment left."""
  from lddl_tpu_torch.loader import get_bart_pretrain_data_loader
  loader = get_bart_pretrain_data_loader(
      **bart_kwargs(digests, num_workers=BART_WORKERS))
  t0 = time.perf_counter()
  got = [[batch_sha256(b) for b in loader] for _ in range(BART_EPOCHS)]
  seconds = time.perf_counter() - t0
  for e, (g, want) in enumerate(zip(got, bart_want(digests))):
    check_digests(f'13d, epoch {e}', g, want)
  check_no_segments('13d')
  samples = sum(map(len, got)) * loader.batch_size
  log(f'  13d: {BART_WORKERS} workers: the same digests; '
      f'{samples / seconds:.0f} samples/s (workers\' start included); no '
      f'segment left [{card}]')
  return {'samples_per_s': samples / seconds, 'seconds': seconds}


def bart_served(digests, card):
  """13e: a ``python -m lddl_tpu_torch.loader.service`` process serving
  the BART factory, drained over loopback by the factory's network
  transport: the same digests, every batch over the wire."""
  from lddl_tpu_torch import telemetry
  from lddl_tpu_torch.loader import get_bart_pretrain_data_loader
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_bart_') as root:
    srv = ServerProc(None, os.path.join(root, 'fleet'),
                     os.path.join(root, 'server.log'), factory=BART_FACTORY,
                     kwargs=bart_kwargs(digests))
    tele = telemetry.enable()
    try:
      srv.start()
      with environ(LDDL_DATA_SERVER=srv.url, LDDL_LOADER_TRANSPORT=None):
        loader = get_bart_pretrain_data_loader(
            **bart_kwargs(digests, num_workers=1, transport='network'))
        t0 = time.perf_counter()
        got = [[batch_sha256(b) for b in loader] for _ in range(BART_EPOCHS)]
        seconds = time.perf_counter() - t0
      client = {k: tele.counter(f'serve.{k}').total
                for k in ('client_pulls', 'fallbacks', 'reattaches')}
    finally:
      telemetry.disable()
      rc = srv.stop()
  for e, (g, want) in enumerate(zip(got, bart_want(digests))):
    check_digests(f'13e, epoch {e}', g, want)
  n = sum(map(len, got))
  # A pull per batch and one per epoch's end.
  if (client['fallbacks'] or client['reattaches'] or
      client['client_pulls'] < n or group_alive(srv.pid)):
    raise AssertionError(f'13e: client {client} over {n} batches; the '
                         f'server exited {rc}')
  log(f'  13e: a data server process (start {srv.start_seconds:.1f} s) '
      f'served the BART factory: {n} batches over the wire '
      f'({client["client_pulls"]} pulls), 0 fallbacks, the same digests; {n * loader.batch_size / seconds:.0f} samples/s '
      f'[{card}]')
  return {'batches': n, 'samples_per_s': n * loader.batch_size / seconds,
          'server_start_seconds': srv.start_seconds}


def bart_ledger_and_feed(digests, card):
  """13f and 13g: the serial loader again with the ledger on (blake2b-8),
  each epoch fed by prefetch_to_device onto the card with its loader's
  coordinates: every batch read back from the card equals the host batch,
  the collate fingerprints = digests.json's, the device records keyed by
  (epoch, index) = the collate ones; the auditor's self-check (``diff run
  run``) exits 0, and ``python -m lddl_tpu_torch.replay.cli batch
  --factory`` rebuilds the batch at BART_REPLAY_KEY bit for bit."""
  from lddl_tpu_torch.loader import get_bart_pretrain_data_loader
  from lddl_tpu_torch.loader.device import (coordinate_from,
                                            prefetch_to_device)
  from lddl_tpu_torch.telemetry.audit import main as audit_main
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_bart_led_') as led:
    loader = get_bart_pretrain_data_loader(**bart_kwargs(digests))
    hosts, placed, fed = [], 0, []
    with blake2b8_ledger(led):
      for _ in range(BART_EPOCHS):
        host = []

        def tee(it, host=host):
          for b in it:
            host.append({k: np.array(v, copy=True) for k, v in b.items()})
            yield b

        coordinate = coordinate_from(loader)
        stream = prefetch_to_device(tee(iter(loader)), DEVICE,
                                    coordinate=coordinate)
        t0 = time.perf_counter()
        for i, batch in enumerate(stream):
          if any(t.device.type != torch.device(DEVICE).type
                 for t in batch.values()):
            raise AssertionError('13g: a batch is not on the card')
          back = {k: t.cpu().numpy() for k, t in batch.items()}
          if batch_sha256(back) != batch_sha256(host[i]):
            raise AssertionError(f'13g: batch {i} read back from the card '
                                 'differs from the host batch')
          placed += 1
        torch.cuda.synchronize()
        fed.append(time.perf_counter() - t0)
        hosts.append(host)
    records = read_ledger(os.path.join(led, 'ledger.rank0.jsonl'))
    want = [d for e in digests['bart']['ledger_by_epoch'][:BART_EPOCHS]
            for d in e]
    if records.get('collate') != want or records.get('device') != want:
      raise AssertionError('13f: the collate and device records are not '
                           'digests.json\'s ledger digests')
    rc, out = run_cli(audit_main, ['diff', led, led])
    if rc != 0 or 'ledgers consistent' not in out:
      raise AssertionError(f'13f: the audit self-check exited {rc}:\n{out}')
    kwargs = bart_kwargs(digests)
    p = subprocess.run(
        [sys.executable, '-m', 'lddl_tpu_torch.replay.cli', 'batch', led,
         '--key', 'epoch={},index={}'.format(*BART_REPLAY_KEY), '--factory',
         BART_FACTORY, '--kwargs-json', json.dumps(kwargs)], cwd=HERE,
        capture_output=True, text=True, timeout=RANK_TIMEOUT)
    if p.returncode != 0 or 'bit-identical' not in p.stdout:
      raise AssertionError(f'13f: the replay CLI exited {p.returncode}:\n'
                           f'{p.stdout}\n{p.stderr[-3000:]}')
  log(f'  13f: the ledger over {len(want)} batches: collate and device '
      f'records (epoch, index) = digests.json\'s blake2b-8 digests; audit '
      f'diff run run exit 0; replay.cli batch --factory at '
      f'{BART_REPLAY_KEY}: exit 0, bit-identical')
  log(f'  13g: prefetch_to_device placed {placed} batches on the card, each '
      f'read back equal to its host batch; {1e3 * sum(fed) / placed:.2f} ms '
      f'a batch from the loader (its collate included) through the feed to '
      f'the read-back [{card}]')
  return {'placed': placed, 'loader_to_readback_ms_per_batch':
          1e3 * sum(fed) / placed}


def bart_on_card(digests, card):
  """Phase 13: 13a-13g."""
  out = {'build': bart_build(card), 'tokenize': bart_tokenize(digests, card)}
  out['serial'], _ = bart_serial(digests, card)
  out['workers'] = bart_workers(digests, card)
  out['served'] = bart_served(digests, card)
  out['ledger_and_feed'] = bart_ledger_and_feed(digests, card)
  check_no_segments('phase 13')
  return out


# ---- phase 14: parameter placement over the fsdp and tensor axes ----

# Rows a data x fsdp rank takes a step, the bin the steps run in, the
# steps each layout runs (and then one more, 14a's continuation), and the
# layouts: two ranks on the one card over gloo (eager steps).
PLACE_ROWS = 16
PLACE_SEQ = 128
PLACE_STEPS = 2
# Phase 14's limits against world 1 (and 14c's against 14a's
# continuation), relative: each about the geometric mean of the largest
# gap of a sound run and the smallest that a broken split gave, both read
# with --place-faults (NVIDIA H100 80GB HBM3, 700.00 W): sound 3.6e-4 /
# 3.0e-3 (14a), one row-parallel layer without its sum 6.4e-3 / 5.8e-2.
PLACE_LOSS_RTOL, PLACE_GRAD_NORM_RTOL = 1.5e-3, 1.3e-2
# Faults --place-faults plants in the rank processes, and the layouts
# each is read under: every row-parallel layer without its sum over
# tensor (and at fsdp=2 the gradients not summed over fsdp); layer 0's
# attention output alone without its sum; every row-parallel bias added
# on each rank before the sum (the ranks stay bit-equal).
PLACE_FAULTS = {'no-row-sum': ('14a', '14b'), 'one-row-sum': ('14a',),
                'row-bias-twice': ('14a',),
                # The tensor group's replicated gradients left unsynced
                # (the exchange before TensorReplicas): read under 14d.
                'no-replica-broadcast': ('14d',)}
# 14d: steps at tensor=2 with the ledger and deterministic algorithms off
# (CUDA's embedding backward then sums with atomics), the replicated
# parameters compared across the ranks after each. Without the replicas'
# broadcast they drift from step 1 (--place-faults).
PLACE_DRIFT_STEPS = 12
PLACE_LAYOUTS = (('14a', {'tensor': 2}), ('14b', {'fsdp': 2}))
# 14c's step cache: a capture, its all-reduce over NCCL.
PLACE_RESUME = ('graph', 1, 'nccl')


def placement_batches(digests, rows, n):
  """``n`` global batches of ``rows`` rows in the s=PLACE_SEQ bin of
  pairs/, from the world-1 serial loader at digests.json's settings,
  epoch after epoch (the bin fills about one such batch an epoch)."""
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  settings = digests['pairs']['settings']
  loader = get_bert_pretrain_data_loader(
      shard_path('pairs'), dp_rank=0, dp_world_size=1,
      batch_size_per_rank=rows, tokenizer=load_bert_tokenizer(VOCAB_FILE),
      masking=settings['masking'], max_seq_length=settings['max_seq_length'],
      bin_size=settings['bin_size'], base_seed=settings['base_seed'],
      shuffle_buffer_size=settings['shuffle_buffer_size'])
  out = []
  for _ in range(8 * n):
    out += [b for b in loader if b['input_ids'].shape[1] == PLACE_SEQ]
    if len(out) >= n:
      return out[:n]
  raise AssertionError(f'phase 14: pairs/ gave {len(out)} batches of '
                       f'{rows} at s={PLACE_SEQ}, want {n}')


def placement_build(args):
  """BERT-base, flash, bf16, dropout off (the layouts compare with world
  1), the masked-only head, from --seed."""
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.training.pretrain import MODEL_SIZES
  cfg = BertConfig(vocab_size=((VOCAB_REAL + 63) // 64) * 64,
                   attention_impl='flash', dropout_rate=0.0,
                   **MODEL_SIZES[MODEL])
  return dict(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
              warmup_steps=0, total_steps=100, seed=args.seed,
              max_predictions=args.max_predictions)


def state_bytes(loop):
  """(parameter bytes, optimizer bytes) the rank keeps between steps:
  the model's parameters, or with fsdp the master shard and whatever the
  working buffer still holds, and AdamW's moments."""
  exchange = loop.step_fn.exchange
  opt = sum(t.numel() * t.element_size() for t in loop.opt.mu + loop.opt.nu)
  if hasattr(exchange, 'shard'):
    return (exchange.shard.numel() * exchange.shard.element_size() +
            exchange.full.untyped_storage().nbytes()), opt
  return sum(p.numel() * p.element_size()
             for p in loop.model.parameters()), opt


def snapshot_extra(loop):
  """The state's digest (a snapshot of the whole state, what a save
  gathers) and the device bytes the snapshot allocated at its peak
  beyond what was allocated before it."""
  torch.cuda.synchronize()
  before = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  digest = loop.state_digest()
  torch.cuda.synchronize()
  return digest, torch.cuda.max_memory_allocated() - before


def placement_steps(loop, batches, place):
  """Steps of ``loop`` on ``place(batch)`` each: metrics and ms."""
  out = []
  for b in batches:
    mine = place(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = loop.step_fn(mine, loop.dropout_seed)
    torch.cuda.synchronize()
    out.append({'metrics': {k: float(v) for k, v in m.items()},
                'ms': 1e3 * (time.perf_counter() - t0)})
  return out


def rank_14(args, digests):
  """One of two ranks on the one card, gloo for CUDA tensors: 9b first
  (:func:`world_9b`; not with ``--only``); then each layout of
  PLACE_LAYOUTS trains PLACE_STEPS steps from one init on its rows of
  the same global batches (make_global_batch), deterministic algorithms
  on, the kernels' counts at 0 just before and read just after; 14a then
  saves (rank 0 writes the whole state) and steps once more. Rank 0 then
  runs world 1 on the whole batches from the same init. Then 14d
  (:func:`replica_drift`), 15b (:func:`ring_rank`) and 16's recorded runs
  (:func:`record_sharded`; not with ``--only``) in the same processes."""
  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.loader.device import make_global_batch
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.parallel import batch_size, make_mesh
  from lddl_tpu_torch.training import TrainLoop
  torch.cuda.set_device(0)  # both ranks on the one card
  out = {}
  if args.only is None:
    out['9b'] = world_9b(args, digests)
  torch.use_deterministic_algorithms(True)
  comm = get_backend('torch')
  if args.only is None:
    flag_written(args, comm, 'ckpt_9b')
  batches = placement_batches(digests, 2 * PLACE_ROWS, PLACE_STEPS + 1)
  build = placement_build(args)
  for label, axes in PLACE_LAYOUTS:
    mesh = make_mesh(device_type=torch.device(DEVICE).type, **axes)
    rows = PLACE_ROWS * batch_size(mesh)
    glob = [{k: v[:rows] for k, v in b.items()} for b in batches]
    loop = TrainLoop.build(mesh=mesh, comm=comm, **build)
    loop.model.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    steps = placement_steps(loop, glob[:PLACE_STEPS],
                            lambda b: make_global_batch(b, mesh,
                                                        device=DEVICE))
    r = {'steps': steps, 'launches': tfa.device_launches(),
         'host_launches': dict(tfa.launches),
         'peak_bytes': torch.cuda.max_memory_allocated(),
         'bytes': state_bytes(loop), 'dp': (loop.dp_rank, loop.dp_world),
         'exchange': type(loop.step_fn.exchange).__name__,
         'backend': loop.step_fn.exchange.backend,
         'heads': loop.model.encoder.layers[0].attention.heads,
         'rows': rows}
    if label == '14a':
      loop.step = PLACE_STEPS
      loop.save(os.path.join(args.ckpt, 'ckpt_14a'))
      if args.only is None:
        flag_written(args, comm, 'ckpt_14a')
    r['digest'], r['snapshot_extra_bytes'] = snapshot_extra(loop)
    r['flat_bytes'] = 4 * loop.step_fn.exchange.flat.numel()  # float32
    if label == '14a':
      r['next'] = placement_steps(
          loop, glob[PLACE_STEPS:],
          lambda b: make_global_batch(b, mesh, device=DEVICE))[0]
    out[label] = r
    del loop
    torch.cuda.empty_cache()
    if comm.rank == 0:
      ref = TrainLoop.build(**build)
      ref.model.train()
      torch.cuda.reset_peak_memory_stats()
      out[label]['world1'] = {
          'steps': placement_steps(ref, glob[:PLACE_STEPS], to_device),
          'peak_bytes': torch.cuda.max_memory_allocated(),
          'bytes': state_bytes(ref)}
      del ref
      torch.cuda.empty_cache()
    comm.barrier()
  if args.only != '15b' and '14d' in PLACE_FAULTS.get(args.fault, ('14d',)):
    out['14d'] = replica_drift(comm, batches, build)
  out['15b'] = ring_rank(args, comm)
  if args.only is None:
    out['16'] = record_sharded(args, comm)
    out['16replay'] = replay_in_ranks(args)
  rank_result(args, out)


def replicated_digest(loop):
  """A digest of this rank's copies of the parameters no rule cuts over
  tensor (the replicated ones)."""
  h = hashlib.sha256()
  for (name, p), cut in zip(loop.model.named_parameters(),
                            loop.model.tensor_sharded()):
    if not cut:
      h.update(name.encode())
      h.update(p.detach().float().cpu().numpy().tobytes())
  return h.hexdigest()[:16]


def replica_drift(comm, batches, build):
  """14d: PLACE_DRIFT_STEPS steps at tensor=2 with the ledger and
  deterministic algorithms off, cycling over phase 14's global batches;
  after each, whether the two ranks' replicated parameters are
  bit-equal (their digests all-gathered)."""
  from lddl_tpu_torch.loader.device import make_global_batch
  from lddl_tpu_torch.parallel import make_mesh
  from lddl_tpu_torch.training import TrainLoop
  torch.use_deterministic_algorithms(False)
  try:
    mesh = make_mesh(device_type=torch.device(DEVICE).type, tensor=2)
    loop = TrainLoop.build(mesh=mesh, comm=comm, **build)
    loop.model.train()
    rows = PLACE_ROWS
    glob = [{k: v[:rows] for k, v in b.items()} for b in batches]
    equal = []
    t0 = time.perf_counter()
    for i in range(PLACE_DRIFT_STEPS):
      loop.step_fn(make_global_batch(glob[i % len(glob)], mesh,
                                     device=DEVICE), loop.dropout_seed)
      digests = comm.allgather_object(replicated_digest(loop))
      equal.append(len(set(digests)) == 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del loop
    torch.cuda.empty_cache()
  finally:
    torch.use_deterministic_algorithms(True)
  drifted = [i + 1 for i, ok in enumerate(equal) if not ok]
  return {'equal': equal, 'first_drift_step': drifted[0] if drifted else None,
          'seconds': seconds}


def rank_14c(args, digests):
  """World 1 over NCCL (under torch.distributed.run), beside the two
  ranks: 9a first (:func:`world_9a`, with 9b's resume once they have
  written its checkpoint); then it resumes 14a's checkpoint once written,
  with the step cache on, and takes the step 14a took after saving,
  deterministic algorithms on; then 15c (:func:`ring_capture`); then,
  once the two ranks have exited, 9a's timed steps (:func:`time_9a`)."""
  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.parallel import make_mesh
  from lddl_tpu_torch.training import TrainLoop
  from lddl_tpu_torch.training.pretrain import CompiledStepCache
  nine, loops = world_9a(args, digests)
  torch.use_deterministic_algorithms(True)
  comm = get_backend('torch')
  mesh = make_mesh(device_type=torch.device(DEVICE).type)
  batch = placement_batches(digests, 2 * PLACE_ROWS, PLACE_STEPS + 1)[-1]
  loop = TrainLoop.build(mesh=mesh, comm=comm, **placement_build(args))
  nine['waited_for_14a_s'] = wait_for(args, 'ckpt_14a.written')
  loop.restore(os.path.join(args.ckpt, 'ckpt_14a'))
  digest = loop.state_digest()
  loop.model.train()
  cache = CompiledStepCache(loop.step_fn)
  tfa.reset_launches()
  m = cache(to_device({k: v[:PLACE_ROWS] for k, v in batch.items()}),
            loop.dropout_seed)
  out = {
      'metrics': {k: float(v) for k, v in m.items()}, 'digest': digest,
      'meta': (loop.step, loop.samples_seen), 'mode': cache.mode,
      'misses': cache.misses, 'backend': loop.step_fn.exchange.backend,
      'launches': tfa.device_launches()}
  del cache, loop
  torch.cuda.empty_cache()
  out['15c'] = ring_capture(args)
  torch.use_deterministic_algorithms(False)
  out['9a'] = time_9a(args, nine, loops)
  rank_result(args, out)


RANK_TASKS.update({'14': rank_14, '14c': rank_14c})


def plant_fault(name):
  """Break this rank process's placement as PLACE_FAULTS names it (by
  patching the model's classes) and keep only the layouts it is read
  under."""
  global PLACE_LAYOUTS
  import torch.nn.functional as F
  if name in RING_FAULTS:
    plant_ring_fault(name)
    return

  from lddl_tpu_torch.models import bert
  from lddl_tpu_torch.parallel import train
  init0, forward0 = bert.BertForPretraining.__init__, bert.Dense.forward

  def init(self, cfg, mesh=None, **kw):
    init0(self, cfg, mesh, **kw)
    if self.tp is None:
      return
    if name == 'one-row-sum':
      self.encoder.layers[0].attention.out.fault = name
      return
    for layer in self.encoder.layers:
      layer.attention.out.fault = layer.output.fault = name

  def forward(self, x):
    fault = getattr(self, 'fault', None)
    if fault is None:
      return forward0(self, x)
    x, w, b = x.to(self.dtype), self.weight.to(self.dtype), self.bias
    if fault == 'row-bias-twice':
      return bert.reduce_from_tensor(F.linear(x, w, b.to(self.dtype)),
                                     self.tp)
    return F.linear(x, w) + b.to(self.dtype)

  def grads(self, grads):
    torch._foreach_copy_(self.views, grads)
    self.grad_shard.copy_(self.flat[self.lo:self.hi])
    return [self.grad_shard]

  bert.BertForPretraining.__init__ = init
  bert.Dense.forward = forward
  if name == 'no-row-sum':
    train.ShardedDataParallel.grads = grads
  if name == 'no-replica-broadcast':
    train.TensorReplicas.__call__ = lambda self: None
  PLACE_LAYOUTS = tuple(layout for layout in PLACE_LAYOUTS
                        if layout[0] in PLACE_FAULTS[name])


def place_faults(args, card):
  """--place-faults: phase 14's two-rank world once under each fault of
  PLACE_FAULTS (only ``--fault``'s, when given); per fault and layout, rank 0's relative gap to world 1's
  loss and grad_norm at each step and whether the ranks stayed
  bit-equal, beside the same for a sound run. Checks nothing: the
  readings PLACE_LOSS_RTOL and PLACE_GRAD_NORM_RTOL are set between."""
  out = {}
  names = (args.fault,) if args.fault in PLACE_FAULTS else tuple(PLACE_FAULTS)
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_faults_') as out_dir:
    for name in (None, *names):
      extra = ['--ckpt', os.path.join(out_dir, f'ckpt_{name}'), '--seed',
               str(args.seed), '--only', '14'] + (
                   [] if name is None else ['--fault', name])
      res, seconds = run_ranks(f'--place-faults {name}', '14', 2, out_dir,
                               extra=extra,
                               env={'LDDL_DIST_CUDA_BACKEND': 'gloo'})
      if '14d' in res[0]:
        drift = res[0]['14d']
        out[f'{name or "sound"} 14d'] = drift
        log(f'  {name or "sound"} 14d: {PLACE_DRIFT_STEPS} steps at tensor=2, '
            f'ledger and deterministic algorithms off: replicated '
            f'parameters bit-equal after each step {drift["equal"]}; first '
            f'drift at step {drift["first_drift_step"]} [{card}]')
      for label, _ in PLACE_LAYOUTS:
        if name is not None and label not in PLACE_FAULTS[name]:
          continue
        per = [r[label] for r in res]
        row = {'ranks_equal': all(
            a['metrics'] == b['metrics']
            for a, b in zip(per[0]['steps'], per[1]['steps'])),
               'seconds': seconds}
        for metric in ('loss', 'grad_norm'):
          row[metric] = [
              abs(s['metrics'][metric] - w['metrics'][metric]) /
              abs(w['metrics'][metric])
              for s, w in zip(per[0]['steps'], per[0]['world1']['steps'])]
        out[f'{name or "sound"} {label}'] = row
        log(f'  {name or "sound"} {label}: ranks bit-equal '
            f'{row["ranks_equal"]}; relative gap to world 1 per step, loss '
            f'{[f"{x:.3g}" for x in row["loss"]]}, grad_norm '
            f'{[f"{x:.3g}" for x in row["grad_norm"]]} [{card}]')
  check_no_rank_processes('--place-faults')
  print(json.dumps({'place_faults': out, 'limits': {
      'loss': PLACE_LOSS_RTOL, 'grad_norm': PLACE_GRAD_NORM_RTOL},
                    'card': card}))


def check_placement_layout(label, res, world1):
  """A layout's checks: the ranks' metrics bit-equal, 12 launches a step
  of each of K1-K3 on each rank (device = wrappers) and none of K4, loss
  and grad_norm within the DP limits of world 1's step by step."""
  from lddl_tpu_torch.training.pretrain import MODEL_SIZES
  layers = MODEL_SIZES[MODEL]['num_layers']
  want = {k: (layers * PLACE_STEPS if k in ('fwd', 'dq', 'dkv') else 0)
          for k in ('fwd', 'dq', 'dkv', 'fwd_seg', 'dq_seg', 'dkv_seg')}
  for rank, r in enumerate(res):
    if r['launches'] != want or r['host_launches'] != r['launches']:
      raise AssertionError(f'{label} rank {rank}: launches {r["launches"]} '
                           f'on the device, {r["host_launches"]} by the '
                           f'wrappers; want {want}')
  for i in range(PLACE_STEPS):
    got = [r['steps'][i]['metrics'] for r in res]
    if any(g != got[0] for g in got):
      raise AssertionError(f'{label} step {i}: the ranks differ: {got}')
    for name, rtol in (('loss', PLACE_LOSS_RTOL),
                       ('grad_norm', PLACE_GRAD_NORM_RTOL)):
      w = world1[i]['metrics'][name]
      if not abs(got[0][name] - w) <= rtol * abs(w):
        raise AssertionError(f'{label} step {i}: {name} {got[0][name]} vs '
                             f'world 1\'s {w} (rtol {rtol})')


def placement(args, digests, card, worlds):
  """Phase 14's checks: 14a, 14b, 14c; and phase 15's 15b and 15c,
  which ran in the same rank processes (:func:`rank_worlds`)."""
  t0 = time.perf_counter()
  out = {}
  res, seconds = worlds['two'], worlds['seconds']['two']
  drift = [r['14d'] for r in res]
  if not all(all(d['equal']) and len(d['equal']) == PLACE_DRIFT_STEPS
             for d in drift):
    raise AssertionError(f'14d: the replicated parameters drifted apart '
                         f'across the tensor group: {drift}')
  out['14d'] = drift[0]
  log(f'  14d: {PLACE_DRIFT_STEPS} steps at tensor=2, the ledger and '
      f'deterministic algorithms off: the replicated parameters bit-equal '
      f'across the ranks after every step ({drift[0]["seconds"]:.1f} s) '
      f'[{card}]')
  for label, axes in PLACE_LAYOUTS:
    per = [r[label] for r in res]
    world1 = per[0]['world1']
    check_placement_layout(label, per, world1['steps'])
    ms = [float(np.median([s['ms'] for s in r['steps'][1:]]))
          for r in per]
    w1_ms = float(np.median([s['ms'] for s in world1['steps'][1:]]))
    params, opt = per[0]['bytes']
    w_params, w_opt = world1['bytes']
    ratio = (params + opt) / (w_params + w_opt)
    if label == '14b' and not abs(ratio - 0.5) < 1e-4:
      raise AssertionError(f'14b: a rank keeps {params} parameter and '
                           f'{opt} optimizer bytes, world 1 {w_params} and '
                           f'{w_opt}: want half')
    extra = [r['snapshot_extra_bytes'] for r in per]
    flat = per[0]['flat_bytes']
    if not max(extra) < flat:
      raise AssertionError(f'{label}: a snapshot of the state allocated '
                           f'{extra} B on the device beyond what the rank '
                           f'held, want less than its flat buffer, {flat} B')
    out[label] = {
        'axes': axes, 'ms_per_step_per_rank': ms, 'world1_ms': w1_ms,
        'peak_bytes_per_rank': [r['peak_bytes'] for r in per],
        'world1_peak_bytes': world1['peak_bytes'],
        'param_bytes': params, 'opt_bytes': opt,
        'world1_param_bytes': w_params, 'world1_opt_bytes': w_opt,
        'launches_per_rank': [r['launches'] for r in per],
        'snapshot_extra_bytes_per_rank': extra, 'flat_bytes': flat,
        'loss': [s['metrics']['loss'] for s in per[0]['steps']],
        'world1_loss': [s['metrics']['loss'] for s in world1['steps']],
        'grad_norm': [s['metrics']['grad_norm'] for s in per[0]['steps']],
        'world1_grad_norm': [s['metrics']['grad_norm']
                             for s in world1['steps']],
        'exchange': per[0]['exchange'], 'backend': per[0]['backend'],
        'local_heads': per[0]['heads'], 'global_rows': per[0]['rows']}
    log(f'  {label}: {axes} over {per[0]["backend"]} '
        f'({per[0]["exchange"]}, {per[0]["heads"]} heads a rank, '
        f'{per[0]["rows"]} rows a step): losses {out[label]["loss"]} vs '
        f'world 1 {out[label]["world1_loss"]}, grad_norm '
        f'{out[label]["grad_norm"]} vs {out[label]["world1_grad_norm"]}; '
        'the ranks bit-equal every step; 12 launches a step of each of '
        'K1-K3 on each rank')
    log(f'  {label}: ms/step per rank (eager, median after the first) '
        f'{[round(x, 2) for x in ms]} vs world 1 {w1_ms:.2f}; peak '
        f'allocated per rank {[r["peak_bytes"] for r in per]} B vs world '
        f'1 {world1["peak_bytes"]} B; kept between steps: {params} B of '
        f'parameters + {opt} B of optimizer state a rank vs world 1\'s '
        f'{w_params} + {w_opt} ({ratio:.4f}); a snapshot of the state '
        f'(what a save gathers) allocated {extra} B at its peak beyond '
        f'that, under the flat buffer\'s {flat} B [{card}]')
  out['15b'] = ring_world(res, card)
  want = (res[0]['14a']['digest'], res[0]['14a']['next'])
  resumed, resume_seconds = worlds['one'], worlds['seconds']['one']
  if resumed['digest'] != want[0] or resumed['meta'] != [PLACE_STEPS, 0]:
    raise AssertionError(f'14c: the restored state {resumed["digest"]} '
                         f'{resumed["meta"]} vs 14a\'s {want[0]}')
  if (resumed['mode'], resumed['misses'], resumed['backend']) != (
      PLACE_RESUME):
    raise AssertionError(f'14c: mode {resumed["mode"]}, misses '
                         f'{resumed["misses"]}, backend {resumed["backend"]}')
  for name, rtol in (('loss', PLACE_LOSS_RTOL),
                     ('grad_norm', PLACE_GRAD_NORM_RTOL)):
    got, w = resumed['metrics'][name], want[1]['metrics'][name]
    if not abs(got - w) <= rtol * abs(w):
      raise AssertionError(f'14c: {name} {got} at world 1 vs 14a\'s '
                           f'continuation {w} (rtol {rtol})')
  out['14c'] = {'metrics': resumed['metrics'], 'continuation': want[1],
                'launches': resumed['launches'], 'seconds': resume_seconds}
  out['15c'] = ring_capture_check(resumed['15c'], card)
  log(f'  14c: 14a\'s checkpoint resumed at world 1 over NCCL: the state '
      f'equals the tensor=2 ranks\' gathered state bit for bit; its next '
      f'step through the step cache (a capture, mode graph) loss '
      f'{resumed["metrics"]["loss"]} grad_norm '
      f'{resumed["metrics"]["grad_norm"]} vs 14a\'s continuation '
      f'{want[1]["metrics"]["loss"]} / {want[1]["metrics"]["grad_norm"]} '
      f'({resume_seconds:.1f} s) [{card}]')
  check_no_rank_processes('phase 14')
  out['seconds'] = {'ranks': seconds, 'resume': resume_seconds,
                    'checks': time.perf_counter() - t0}
  log(f'  phase 14: the two-rank world {seconds:.1f} s (with 9b, 15b and '
      f'16\'s records), the world-1 process {resume_seconds:.1f} s (with '
      f'9a and 15c), ran in phase 9 [{card}]')
  return out


# ---- phase 15: ring attention over the seq axis ----

# 15a: the kernels on the inputs a ring at seq=2 gives them, bf16: a q
# shard of s=512 pairs rows against the other shard's K/V (K1-K3), and of
# packed s=8192 rows, q ids from shard 0 against kv ids from shard 1 (K4).
RING_KERNEL_PAIRS = (16, 12, 256, 64)
RING_KERNEL_PACKED = (2, 12, 4096, 64)
# 15a's limits, bf16. out on real rows: RING_TOL of plain, absolute plus
# relative (the two bf16 roundings of a value differ by up to an ulp,
# 2^-8 of it); lse on real rows: RING_TOL absolute. dq, dk and dv, every
# element: RING_GRAD_FLOOR plus RING_TOL of the sum of the absolute values
# of the products it adds (|dS| |k|, |dS|^T |q|, P^T |dO|: the bodies
# round P and dS to bf16, 2^-9 of each product, and the output to bf16,
# so an element is off by at most about 2^-8 of that sum); and each
# tensor's ||kernel - plain|| / ||plain|| within RING_REL_NORM, which
# holds the bulk of the tensor as well.
RING_TOL = 3e-2
RING_GRAD_FLOOR = 1e-4
RING_REL_NORM = 1e-2
# 15b: two ranks on the one card over gloo at seq=2, ring_flash; each
# cell's (label, seq_len, rows, steps): packed block-diagonal rows, then
# pairs rows.
RING_SEQ = 2
RING_CELLS = (('packed', 8192, 2, 4), ('pairs', 512, 16, 2))
# 15b's limits against world 1 (flash, one process, same init and
# batches), per cell, relative: loss and grad_norm at every step, and the
# parameters after the cell's steps, |theta - theta_1| / |theta_1 -
# theta_0|. Each is about the geometric mean of the sound run's largest gap
# and the smallest gap of a planted fault (RING_FAULTS) that the metric
# separates, both read with --ring-faults (NVIDIA H100 80GB HBM3,
# 700.00 W): packed, sound 1.6e-5 / 3.2e-4 / 0.0129 against the lse left
# out (loss 5.9e-3), the gather without its sum (grad_norm 0.30) and the
# own shard alone (parameters 0.048); pairs, sound 2.7e-4 / 8.5e-4 /
# 0.072 against the lse left out (5.1e-4, 1.4e-2) and the gather without
# its sum (parameters 0.119).
RING_LIMITS = {'packed': {'loss': 3.1e-4, 'grad_norm': 9.8e-3,
                          'params': 2.5e-2},
               'pairs': {'loss': 3.7e-4, 'grad_norm': 3.4e-3,
                         'params': 9.3e-2}}
# Faults --ring-faults plants in 15b's rank processes: the ring attends to
# its own shard alone (no rotation); the flash block's lse left out of the
# merge (each block weighs 1); the gather's backward without its sum over
# seq (each rank's columns get its own heads' cotangent only).
RING_FAULTS = ('own-shard', 'no-lse', 'gather-no-sum')
# 15c: world 1 over NCCL, the ring at n=1 through the step cache.
RING_CAPTURE = ('graph', 1, 1, 'nccl')  # mode, misses, hits, backend


def grad_magnitudes(tfa, q, k, v, bias, g, lse, delta, h, ids):
  """Per element of dq, dk and dv, the sum of the absolute values of the
  products it adds: scale |dS| |k|, scale |dS|^T |q| and P^T |dO|, with P
  and dS as the plain versions form them (float32)."""
  scale = 1.0 / q.shape[-1] ** 0.5
  s = tfa._scores(q, k, bias, h, *ids) - lse[..., None]
  p = torch.exp(torch.clamp_max(s, 30.0))
  del s
  dp = torch.matmul(g.float(), v.float().transpose(1, 2))
  ds = (p * (dp - delta[..., None])).abs()
  del dp
  m_dq = torch.matmul(ds, k.float().abs()) * scale
  m_dk = torch.matmul(ds.transpose(1, 2), q.float().abs()) * scale
  m_dv = torch.matmul(p.transpose(1, 2), g.float().abs())
  return m_dq, m_dk, m_dv


def compare_bounded(label, kernel, plain, allowed, rows=None,
                    rel_norm=None):
  """Launch ``kernel`` twice and ``plain`` once on the same inputs: the two
  launches must be bitwise equal, and each output's every element (of
  ``rows``, where given) within its ``allowed`` error (one per output, a
  number or a tensor of the output's shape), and with ``rel_norm``
  ``||kernel - plain|| / ||plain||`` within it. Returns (the largest
  absolute difference, the largest difference over its allowed error,
  the largest relative norm)."""
  got, again, ref = kernel(), kernel(), plain()
  torch.cuda.synchronize()
  got, again, ref = ((t,) if torch.is_tensor(t) else t
                     for t in (got, again, ref))
  if not all(torch.equal(a, c) for a, c in zip(got, again)):
    raise AssertionError(f'{label}: two launches on the same inputs differ')
  err = use = norm = 0.0
  for i, (a, r, bound) in enumerate(zip(got, ref, allowed)):
    diff = (a.float() - r.float()).abs()
    bound = torch.as_tensor(bound, dtype=torch.float32, device=diff.device)
    if rows is not None:
      diff, r = diff[rows], r[rows]
      bound = bound[rows] if bound.dim() else bound
    bound = bound.expand_as(diff)
    over = diff > bound
    if bool(over.any()):
      at = int(over.view(-1).nonzero()[0])
      raise AssertionError(
          f'{label} output {i}: {int(over.sum())} of {diff.numel()} '
          f'elements past their bound; the first off by '
          f'{float(diff.view(-1)[at]):.4g} against '
          f'{float(bound.reshape(-1)[at]):.4g} (plain '
          f'{float(r.reshape(-1)[at]):.4g})')
    err = max(err, float(diff.max()))
    use = max(use, float((diff / bound).max()))
    if rel_norm is not None:
      ratio = float(diff.norm() / r.float().norm().clamp_min(1e-30))
      if not ratio <= rel_norm:
        raise AssertionError(f'{label} output {i}: ||kernel - plain|| / '
                             f'||plain|| = {ratio:.4g}, limit {rel_norm}')
      norm = max(norm, ratio)
  return err, use, norm


def ring_kernel_case(tfa, label, q, k, v, do, g_lse, mask, qseg, kvseg,
                     rows, h, card):
  """One 15a case: K1-K3 (ids None) or K4 on a q shard against another
  shard's K/V, with a random cotangent of out and a random non-zero one of
  lse, zero on ``rows``' complement as the merge gives them. out and lse
  are compared on ``rows``, dq, dk and dv everywhere, each to the limits
  RING_* set out; every output must be finite. Returns the report's row
  per kernel."""
  b = mask.shape[0]
  d = q.shape[-1]
  bias = tfa.key_bias(mask, b, k.shape[1], q.device)
  real = rows.repeat_interleave(h, dim=0)  # [bh, s_q]
  do = torch.where(real[..., None], do, torch.zeros((), dtype=do.dtype,
                                                    device=DEVICE))
  g_lse = torch.where(real, g_lse, 0.0)
  segs = None if qseg is None else tfa.Segments(qseg, kvseg)
  ids = () if qseg is None else (qseg, kvseg)
  out, lse = tfa._fwd(q, k, v, bias, h, segs)
  g, delta = tfa._backward_rows(do, g_lse, out, q)
  dq = tfa._dq(q, k, v, bias, g, lse, delta, h, segs)
  dk, dv = tfa._dkv(q, k, v, bias, g, lse, delta, h, segs)
  for name, t in (('out', out), ('lse', lse), ('dq', dq), ('dk', dk),
                  ('dv', dv)):
    if not bool(torch.isfinite(t).all()):
      raise AssertionError(f'15a {label}: non-finite {name}')
  m_dq, m_dk, m_dv = grad_magnitudes(tfa, q, k, v, bias, g, lse, delta, h,
                                     ids)
  out_plain = tfa._fwd_plain(q, k, v, bias, h, *ids)[0]
  allowed = {
      'fwd': (RING_TOL + RING_TOL * out_plain.float().abs(), RING_TOL),
      'dq': (RING_GRAD_FLOOR + RING_TOL * m_dq,),
      'dkv': (RING_GRAD_FLOOR + RING_TOL * m_dk,
              RING_GRAD_FLOOR + RING_TOL * m_dv)}
  del out_plain
  suffix = '' if qseg is None else '_seg'
  calls = {
      'fwd': ((lambda: tfa._fwd(q, k, v, bias, h, segs)),
              (lambda: tfa._fwd_plain(q, k, v, bias, h, *ids))),
      'dq': ((lambda: tfa._dq(q, k, v, bias, g, lse, delta, h, segs)),
             (lambda: tfa._dq_plain(q, k, v, bias, g, lse, delta, h, *ids))),
      'dkv': ((lambda: tfa._dkv(q, k, v, bias, g, lse, delta, h, segs)),
              (lambda: tfa._dkv_plain(q, k, v, bias, g, lse, delta, h,
                                      *ids))),
  }
  report = []
  for name, (kernel, plain) in calls.items():
    fwd = name == 'fwd'
    err, use, norm = compare_bounded(
        f'15a {label} {name}{suffix}', kernel, plain, allowed[name],
        rows=real if fwd else None, rel_norm=None if fwd else RING_REL_NORM)
    report.append({'name': name + suffix, 'shape': [b, h, q.shape[1], d],
                   'max_abs_err': err, 'tol': RING_TOL,
                   'bound_use': use, 'rel_norm_err': None if fwd else norm,
                   'ms': cuda_ms(kernel),
                   'plain_ms': cuda_ms(plain, reps=5, warmup=1)})
    r = report[-1]
    held = ('out rtol and atol, lse atol' if fwd else
            f'each element {RING_GRAD_FLOOR:g} + tol x its sum of |products|;'
            f' rel norm {norm:.3g} (limit {RING_REL_NORM:g})')
    log(f'  15a {label} {name}{suffix}: err={err:.3g} (tol {RING_TOL:g}: '
        f'{held}; at most {use:.3g} of an element\'s bound) '
        f'bitwise-repeat=ok kernel={r["ms"]:.3f}ms '
        f'plain={r["plain_ms"]:.3f}ms [{card}]')
  del m_dq, m_dk, m_dv, allowed
  return report, lse


def ring_kernels(tfa, seed, card):
  """15a: K1-K4 on ring inputs against their plain versions, bf16."""
  dtype = torch.bfloat16
  rows = []
  # K1-K3: the q shard of s=512 rows against the other shard, whose key
  # mask pads a random tail (every row keeps a real key).
  b, h, s, d = RING_KERNEL_PAIRS
  q, k, v, do, g_lse, _ = attention_inputs(b, h, s, d, dtype, seed)
  gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
  lens = torch.randint(1, s + 1, (b,), generator=gen, device=DEVICE)
  mask = torch.arange(s, device=DEVICE)[None, :] < lens[:, None]
  if not bool((g_lse != 0).all()):
    raise AssertionError('15a: the lse cotangent must be non-zero')
  report, _ = ring_kernel_case(
      tfa, f'pairs q shard vs kv shard {[b, h, s, d]}', q, k, v, do, g_lse,
      mask, None, None, torch.ones((b, s), dtype=torch.bool, device=DEVICE),
      h, card)
  rows += report
  # K4: shard 0's q ids against shard 1's kv ids of packed s=8192 rows.
  b, h, s, d = RING_KERNEL_PACKED
  rng = np.random.default_rng([seed, 15])
  seg_np = segment_layout(b, 2 * s, int(rng.integers(PACKED_DOCS[0],
                                                     PACKED_DOCS[1] + 1)),
                          True, False, rng)
  q_np, kv_np = seg_np[:, :s], seg_np[:, s:]
  real_np = q_np >= 0
  has_key = real_np & np.stack([np.isin(q_np[r], kv_np[r][kv_np[r] >= 0])
                                for r in range(b)])
  no_key = real_np & ~has_key
  qlo, qhi = tfa.segment_block_intervals(q_np, tfa.TILE_ROWS)
  klo, khi = tfa.segment_block_intervals(kv_np, tfa.stream_rows(d))
  live = ((qlo[:, :, None] <= khi[:, None, :]) &
          (klo[:, None, :] <= qhi[:, :, None]))
  dead_tiles = int((~live.any(axis=2)).sum())
  if not (no_key.sum() and dead_tiles and has_key.sum()):
    raise AssertionError(f'15a: the packed shards give {int(no_key.sum())} '
                         f'real rows with no key, {dead_tiles} disjoint q '
                         f'tiles and {int(has_key.sum())} rows with a key: '
                         'want each above 0')
  q, k, v, do, g_lse, _ = attention_inputs(b, h, s, d, dtype, seed + 2)
  qseg = torch.from_numpy(q_np).to(DEVICE)
  kvseg = torch.from_numpy(kv_np).to(DEVICE)
  report, lse = ring_kernel_case(
      tfa, f'packed q ids of shard 0 vs kv ids of shard 1 {[b, h, s, d]}',
      q, k, v, do, g_lse, kvseg >= 0, qseg, kvseg,
      torch.from_numpy(has_key).to(DEVICE), h, card)
  rows += report
  # A real row with no same-document key: lse near -1e9, so the merge
  # gives the block weight exp(lse - M) = 0.
  gone = torch.from_numpy(no_key).to(DEVICE).repeat_interleave(h, dim=0)
  top = float(lse[gone].max())
  if not top < -1e8:
    raise AssertionError(f'15a: a real row with no key in the block has lse '
                         f'{top}, want below -1e8 (zero weight in the merge)')
  log(f'  15a: {int(no_key.sum())} real rows of shard 0 have no key in shard '
      f'1 (lse at most {top:.4g}, finite), {dead_tiles} of '
      f'{live.shape[0] * live.shape[1]} q tiles are disjoint whole; g_lse '
      'random and non-zero')
  return rows


def ring_cell_batches(label, s, b, steps, seed):
  from lddl_tpu_torch.loader.bert import dynamic_mask_tokens
  if label == 'packed':
    return PackedLoader(s, b, steps, seed).batches
  return BinLoader(s, b, steps, seed, dynamic_mask_tokens).batches


def ring_build(args, s, impl):
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.training.pretrain import MODEL_SIZES
  cfg = BertConfig(vocab_size=((VOCAB_REAL + 63) // 64) * 64,
                   attention_impl=impl, dropout_rate=0.0,
                   max_position_embeddings=max(s, 512),
                   **MODEL_SIZES[MODEL])
  return dict(model_cfg=cfg, device=DEVICE, learning_rate=1e-4,
              warmup_steps=0, total_steps=100, seed=args.seed,
              max_predictions=(PACKED[2] if s == PACKED[0] else
                               args.max_predictions))


def params_digest(model):
  h = hashlib.sha256()
  for p in model.parameters():
    h.update(p.detach().cpu().numpy().tobytes())
  return h.hexdigest()


def ring_rank(args, comm):
  """15b on one of the two ranks: each cell of RING_CELLS from one init,
  ring_flash over make_mesh(seq=RING_SEQ), every rank's columns by
  make_global_batch, the kernels' counts at 0 just before the steps and
  read just after; rank 0 then runs world 1 (flash, one process) on the
  whole batches from the same init."""
  from lddl_tpu_torch.loader.device import make_global_batch
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.parallel import make_mesh
  from lddl_tpu_torch.training import TrainLoop
  mesh = make_mesh(seq=RING_SEQ, device_type=torch.device(DEVICE).type)
  out = {}
  for label, s, b, steps in RING_CELLS:
    batches = ring_cell_batches(label, s, b, steps, args.seed)
    loop = TrainLoop.build(mesh=mesh, comm=comm,
                           **ring_build(args, s, 'ring_flash'))
    loop.model.train()
    theta0 = flat_params(loop.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()
    r = {'steps': placement_steps(
        loop, batches, lambda x: make_global_batch(x, mesh, device=DEVICE)),
         'launches': tfa.device_launches(),
         'host_launches': dict(tfa.launches),
         'peak_bytes': torch.cuda.max_memory_allocated(),
         'seq_rank': loop.model.sp.rank,
         'backend': loop.step_fn.exchange.backend,
         'exchange': type(loop.step_fn.exchange).__name__,
         'digest': params_digest(loop.model)}
    theta = flat_params(loop.model)
    del loop
    torch.cuda.empty_cache()
    if comm.rank == 0:
      ref = TrainLoop.build(**ring_build(args, s, 'flash'))
      ref.model.train()
      torch.cuda.reset_peak_memory_stats()
      r['world1'] = {
          'steps': placement_steps(ref, batches, to_device),
          'peak_bytes': torch.cuda.max_memory_allocated()}
      theta1 = flat_params(ref.model)
      r['param_gap'] = float((theta - theta1).norm() /
                             (theta1 - theta0).norm())
      del ref, theta1
    del theta, theta0
    torch.cuda.empty_cache()
    out[label] = r
    comm.barrier()
  return out


def ring_capture(args):
  """15c in the world-1 NCCL process: the ring at n=1 (ring_flash over
  its mesh) on a packed s=8192 batch, one step eager from a snapshot of
  the state, then from the same state through the step cache (a miss:
  warm-up and capture) and again (a hit: the graph's replay; the state
  is copied into the live tensors, so the graph stays valid),
  deterministic algorithms on; then flash without a mesh from the same
  state."""
  from lddl_tpu_torch.comm import get_backend
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.parallel import make_mesh
  from lddl_tpu_torch.training import TrainLoop
  from lddl_tpu_torch.training.pretrain import CompiledStepCache
  comm = get_backend('torch')
  mesh = make_mesh(device_type=torch.device(DEVICE).type)
  s, b = PACKED[:2]
  batch = to_device(ring_cell_batches('packed', s, b, 1, args.seed)[0])
  loop = TrainLoop.build(mesh=mesh, comm=comm,
                         **ring_build(args, s, 'ring_flash'))
  loop.model.train()
  snap = loop._snapshot()
  out = {}
  eager = {k: float(v) for k, v in loop.step_fn(batch,
                                                loop.dropout_seed).items()}
  out['eager'] = {'metrics': eager, 'digest': loop.state_digest()}
  cache = CompiledStepCache(loop.step_fn)
  loop.load_whole_state(snap['model'], snap['opt'])
  cache(batch, loop.dropout_seed)  # the miss: warm-up, then capture
  loop.load_whole_state(snap['model'], snap['opt'])
  tfa.reset_launches()
  m = cache(batch, loop.dropout_seed)  # the hit: a replay
  out['graph'] = {'metrics': {k: float(v) for k, v in m.items()},
                  'digest': loop.state_digest(),
                  'launches': tfa.device_launches(),
                  'host_launches': dict(tfa.launches)}
  out['cache'] = (cache.mode, cache.misses, cache.hits,
                  loop.step_fn.exchange.backend)
  del cache, loop
  torch.cuda.empty_cache()
  flash = TrainLoop.build(**ring_build(args, s, 'flash'))
  flash.load_whole_state(snap['model'], snap['opt'])
  flash.model.train()
  out['flash'] = {k: float(v) for k, v in flash.step_fn(
      batch, flash.dropout_seed).items()}
  return out


def plant_ring_fault(name):
  """Break this rank process's ring as RING_FAULTS names it."""
  from lddl_tpu_torch.models import bert
  from lddl_tpu_torch.parallel import ring
  if name == 'own-shard':
    make0 = ring.make_ring_attention

    def make(mesh, block_impl='dense', with_segment_ids=False):
      attend = make0(mesh, block_impl, with_segment_ids)

      def own(q, k, v, mask, *seg):
        s = seg[0] if seg else None
        return ring.ring_attention(q, k, v, mask, group=None,
                                   block_impl=block_impl, q_segment_ids=s,
                                   kv_segment_ids=s)
      del attend
      return own
    ring.make_ring_attention = make
  elif name == 'no-lse':
    flash0 = ring.flash_attention_with_lse

    def flash(*a, **k):
      out, lse = flash0(*a, **k)
      return out, torch.zeros_like(lse)
    ring.flash_attention_with_lse = flash
  elif name == 'gather-no-sum':
    def backward(ctx, g):
      sp = ctx.sp
      per = g.shape[1] // sp.size
      return g[:, sp.rank * per:(sp.rank + 1) * per].contiguous(), None
    bert._GatherSeq.backward = staticmethod(backward)


def check_ring_cell(label, res, world1):
  """A 15b cell's checks: each rank's launches = 12 x RING_SEQ blocks a
  step (every rotated shard runs its block), of K1-K3 on pairs rows and
  of K4 on packed ones (device = the wrappers'); the ranks' metrics and
  parameters bit-equal; loss,
  grad_norm and the parameters within the cell's RING_LIMITS of world
  1's."""
  from lddl_tpu_torch.training.pretrain import MODEL_SIZES
  layers = MODEL_SIZES[MODEL]['num_layers']
  seg = label == 'packed'
  for rank, r in enumerate(res):
    blocks = RING_SEQ * len(r['steps'])
    want = {k: (layers * blocks if k.endswith('_seg') == seg else 0)
            for k in ('fwd', 'dq', 'dkv', 'fwd_seg', 'dq_seg', 'dkv_seg')}
    if r['launches'] != want or r['host_launches'] != r['launches']:
      raise AssertionError(f'15b {label} rank {rank}: launches '
                           f'{r["launches"]} on the device, '
                           f'{r["host_launches"]} by the wrappers; want '
                           f'{want} ({RING_SEQ} blocks a step)')
  if len({r['digest'] for r in res}) != 1:
    raise AssertionError(f'15b {label}: the ranks\' parameters differ')
  limits = RING_LIMITS[label]
  for i, w in enumerate(world1['steps']):
    got = [r['steps'][i]['metrics'] for r in res]
    if any(g != got[0] for g in got):
      raise AssertionError(f'15b {label} step {i}: the ranks differ: {got}')
    for name in ('loss', 'grad_norm'):
      want = w['metrics'][name]
      if not abs(got[0][name] - want) <= limits[name] * abs(want):
        raise AssertionError(f'15b {label} step {i}: {name} {got[0][name]} '
                             f'vs world 1\'s {want} (rtol {limits[name]})')
  if not res[0]['param_gap'] <= limits['params']:
    raise AssertionError(f'15b {label}: the parameters are '
                         f'{res[0]["param_gap"]:.3g} of world 1\'s update '
                         f'away from world 1\'s (limit {limits["params"]})')


def ring_gaps(r):
  """Rank 0's relative gaps to world 1 in a 15b cell (``r``, its
  result): per step loss and grad_norm, and the parameters'."""
  w = r['world1']['steps']
  return {m: [abs(s['metrics'][m] - x['metrics'][m]) / abs(x['metrics'][m])
              for s, x in zip(r['steps'], w)] for m in ('loss', 'grad_norm')
          } | {'params': r['param_gap']}


def ring_world(res, card):
  """15b's checks and report from the phase-14 world's results."""
  out = {}
  for label, s, b, steps in RING_CELLS:
    per = [r['15b'][label] for r in res]
    world1 = per[0]['world1']
    check_ring_cell(label, per, world1)
    ms = [float(np.median([x['ms'] for x in r['steps'][1:]])) for r in per]
    w1_ms = float(np.median([x['ms'] for x in world1['steps'][1:]]))
    gaps = ring_gaps(per[0])
    out[label] = {
        'shape': [b, s], 'steps': steps, 'seq': RING_SEQ,
        'ms_per_step_per_rank': ms, 'world1_ms': w1_ms,
        'peak_bytes_per_rank': [r['peak_bytes'] for r in per],
        'world1_peak_bytes': world1['peak_bytes'],
        'launches_per_rank': [r['launches'] for r in per],
        'loss': [x['metrics']['loss'] for x in per[0]['steps']],
        'world1_loss': [x['metrics']['loss'] for x in world1['steps']],
        'grad_norm': [x['metrics']['grad_norm'] for x in per[0]['steps']],
        'world1_grad_norm': [x['metrics']['grad_norm']
                             for x in world1['steps']],
        'gaps': gaps, 'backend': per[0]['backend']}
    log(f'  15b {label} [{b}, {s}] at seq={RING_SEQ} over {per[0]["backend"]} '
        f'({per[0]["exchange"]}, ring_flash, {s // RING_SEQ} columns a rank):'
        f' losses {out[label]["loss"]} vs world 1 (flash) '
        f'{out[label]["world1_loss"]}; relative gaps loss '
        f'{[f"{x:.3g}" for x in gaps["loss"]]}, grad_norm '
        f'{[f"{x:.3g}" for x in gaps["grad_norm"]]}, parameters '
        f'{gaps["params"]:.3g} (limits {RING_LIMITS[label]}); the ranks '
        f'bit-equal; '
        f'launches = layers x {RING_SEQ} blocks a step')
    log(f'  15b {label}: ms/step per rank (eager, median after the first) '
        f'{[round(x, 2) for x in ms]} vs world 1 {w1_ms:.2f}; peak allocated '
        f'per rank {out[label]["peak_bytes_per_rank"]} B vs world 1 '
        f'{world1["peak_bytes"]} B [{card}]')
  return out


def ring_capture_check(res, card):
  """15c's checks: a capture then a replay, bit-equal to the eager step;
  one replay's launches = 12 of each K4 kernel; within DENSE_*_RTOL of
  flash."""
  if tuple(res['cache']) != RING_CAPTURE:
    raise AssertionError(f'15c: cache {res["cache"]}, want {RING_CAPTURE}')
  if (res['graph']['metrics'] != res['eager']['metrics'] or
      res['graph']['digest'] != res['eager']['digest']):
    raise AssertionError(f'15c: the replay {res["graph"]["metrics"]} differs '
                         f'from the eager step {res["eager"]["metrics"]}')
  from lddl_tpu_torch.training.pretrain import MODEL_SIZES
  layers = MODEL_SIZES[MODEL]['num_layers']
  want = {k: (layers if k.endswith('_seg') else 0)
          for k in ('fwd', 'dq', 'dkv', 'fwd_seg', 'dq_seg', 'dkv_seg')}
  g = res['graph']
  if g['launches'] != want or g['host_launches'] != want:
    raise AssertionError(f'15c: a replay launched {g["launches"]} on the '
                         f'device, {g["host_launches"]} counted by the cache; '
                         f'want {want}')
  for name, rtol in (('loss', DENSE_LOSS_RTOL),
                     ('grad_norm', DENSE_GRAD_NORM_RTOL)):
    got, w = g['metrics'][name], res['flash'][name]
    if not abs(got - w) <= rtol * abs(w):
      raise AssertionError(f'15c: {name} {got} vs flash {w} (rtol {rtol})')
  log(f'  15c: the ring at n=1 over NCCL, packed s={PACKED[0]}: one replay of '
      f'the captured step = the eager step bit for bit (loss '
      f'{g["metrics"]["loss"]}, grad_norm {g["metrics"]["grad_norm"]}, state '
      f'digest), {layers} launches of each K4 kernel a replay; flash alone: '
      f'loss '
      f'{res["flash"]["loss"]}, grad_norm {res["flash"]["grad_norm"]} [{card}]')
  return {'metrics': g['metrics'], 'flash': res['flash'],
          'launches': g['launches']}


def ring_faults(args, card):
  """--ring-faults: 15b's world once sound and once under each fault of
  RING_FAULTS (phase 14's layouts left out); per fault and cell, rank 0's
  relative gaps to world 1. Checks nothing: the readings RING_LIMITS are
  set between."""
  out = {}
  with tempfile.TemporaryDirectory(prefix='lddl_smoke_ring_faults_') as d:
    for name in (None, *RING_FAULTS):
      extra = ['--ckpt', os.path.join(d, f'ckpt_{name}'), '--seed',
               str(args.seed), '--only', '15b'] + (
                   [] if name is None else ['--fault', name])
      res, seconds = run_ranks(f'--ring-faults {name}', '14', 2, d,
                               extra=extra,
                               env={'LDDL_DIST_CUDA_BACKEND': 'gloo'})
      for label, *_ in RING_CELLS:
        per = [r['15b'][label] for r in res]
        row = ring_gaps(per[0])
        row['ranks_equal'] = all(
            a['metrics'] == b['metrics']
            for a, b in zip(per[0]['steps'], per[1]['steps']))
        row['seconds'] = seconds
        out[f'{name or "sound"} {label}'] = row
        log(f'  {name or "sound"} {label}: ranks bit-equal '
            f'{row["ranks_equal"]}; relative gap to world 1 per step, loss '
            f'{[f"{x:.3g}" for x in row["loss"]]}, grad_norm '
            f'{[f"{x:.3g}" for x in row["grad_norm"]]}, parameters '
            f'{row["params"]:.3g} [{card}]')
  check_no_rank_processes('--ring-faults')
  print(json.dumps({'ring_faults': out, 'limits': RING_LIMITS,
                    'card': card}))


# ---- phase 16: step replay of a sharded run, launched as its ranks ----

# The runs phase 14's two ranks record with the ledger on (label, mesh
# axes, shard set, attention): BERT-base from the committed shards, as
# the replay CLI builds it (dropout on, bf16), REPLAY_STEPS steps with a
# checkpoint every step (the step line at 2 is the target; 16b also saves
# at 0, where its bisect over (0, 2] restores).
REPLAY_LAYOUTS = (('16a', {'tensor': 2}, 'pairs', 'flash'),
                  ('16b', {'seq': 2}, 'packed', 'ring_flash'),
                  ('16c', {'data': 2}, 'pairs', 'flash'))
REPLAY_STEPS = 2
REPLAY_FLAG = {'data': '--dp', 'fsdp': '--fsdp', 'tensor': '--tp',
               'seq': '--sp'}


def replay_settings(args, data):
  """The recorded run's loader and model settings: ``(TrainLoop.build
  kwargs, BertConfig kwargs, the replay CLI's arguments for the same)``;
  digests.json's loader settings, the masked-only head."""
  from lddl_tpu_torch.training.pretrain import MODEL_SIZES
  settings = load_digests()[data]['settings']
  s = settings['max_seq_length']
  heads = PACKED[2] if data == 'packed' else args.max_predictions
  build = dict(device=DEVICE, learning_rate=1e-4, warmup_steps=0,
               total_steps=100, batch_size_per_rank=settings[
                   'batch_size_per_rank'], max_seq_length=s,
               masking='dynamic', seed=args.seed, max_predictions=heads,
               loader_kwargs={'shuffle_buffer_size':
                              settings['shuffle_buffer_size']})
  argv = ['--path', shard_path(data), '--vocab-file', VOCAB_FILE,
          '--batch-size', str(settings['batch_size_per_rank']),
          '--max-seq-length', str(s), '--masking', 'dynamic',
          '--shuffle-buffer-size', str(settings['shuffle_buffer_size']),
          '--model', MODEL, '--seed', str(args.seed), '--learning-rate',
          '1e-4', '--warmup-steps', '0', '--total-steps', '100',
          '--max-predictions', str(heads), '--device', f'{DEVICE}:0']
  if data == 'packed':
    build.update(data_format='packed', block_diagonal=True)
    argv += ['--data-format', 'packed', '--block-diagonal']
  else:
    build['bin_size'] = settings['bin_size']
    argv += ['--bin-size', str(settings['bin_size'])]
  cfg = dict(vocab_size=((VOCAB_REAL + 63) // 64) * 64,
             max_position_embeddings=max(s, 512), **MODEL_SIZES[MODEL])
  return build, cfg, argv


def record_sharded(args, comm):
  """16's recorded runs, on each rank of phase 14's world: each layout of
  REPLAY_LAYOUTS through TrainLoop.run with the ledger on (this rank's
  file, deterministic algorithms), from the committed shards; rank 0
  then writes 16a's checkpoint at step 1 again with one bit flipped."""
  from lddl_tpu_torch.models import BertConfig
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.parallel import make_mesh
  from lddl_tpu_torch.telemetry import ledger
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop
  root = os.path.join(args.ckpt, '16')
  out = {}
  for label, axes, data, impl in REPLAY_LAYOUTS:
    build, cfg, _ = replay_settings(args, data)
    d = os.path.join(root, label)
    mesh = make_mesh(device_type=torch.device(DEVICE).type, **axes)
    ledger._active = None
    ledger.enable_ledger(directory=os.path.join(d, 'ledger'),
                         rank=comm.rank)
    try:
      loop = TrainLoop.build(
          shard_path(data), load_bert_tokenizer(VOCAB_FILE),
          model_cfg=BertConfig(attention_impl=impl, **cfg), mesh=mesh,
          comm=comm, **build)
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      tfa.reset_launches()
      if label == '16b':
        loop.save(os.path.join(d, 'ckpt'))
      losses = loop.run(REPLAY_STEPS, ckpt_dir=os.path.join(d, 'ckpt'),
                        ckpt_every=1, log_every=0)
      out[label] = {'losses': losses, 'launches': tfa.device_launches(),
                    'seconds': time.perf_counter() - t0,
                    'dp': (loop.dp_rank, loop.dp_world)}
    finally:
      ledger.disable_ledger()
      ledger._active = None
    del loop
    torch.cuda.empty_cache()
    if comm.rank == 0:  # the replays restore the steps below the target
      shutil.rmtree(os.path.join(d, 'ckpt', f'step_{REPLAY_STEPS:010d}'))
  if comm.rank == 0:
    flip_a_bit(os.path.join(root, '16a', 'ckpt'), 1,
               os.path.join(root, '16a', 'ckpt_flipped'))
  comm.barrier()
  return out


def flip_a_bit(ckpt, step, out):
  """Step ``step`` of checkpoint dir ``ckpt`` copied into ``out`` with one
  bit flipped: the lowest of the high half of the first element of the
  first float32 matrix (a weight every step reads)."""
  name = f'step_{step:010d}'
  shutil.copytree(os.path.join(ckpt, name), os.path.join(out, name))
  path = os.path.join(out, name, 'state.pt')
  state = torch.load(path, weights_only=True)
  key = next(k for k, v in state['model'].items()
             if v.dtype == torch.float32 and v.dim() == 2)
  halves = state['model'][key].view(-1).view(torch.int16)
  halves[1] ^= 1  # little-endian: the high half of element 0
  torch.save(state, path)


def replay_in_ranks(args):
  """16 on one of the two ranks of phase 14's world, after its
  recordings (:func:`record_sharded`): the replay CLI's ``main`` for each
  job of :func:`replay_jobs`, as ``python -m lddl_tpu_torch.replay.cli``
  runs it launched as the run's ranks (``--comm torch``: the world these
  processes already are), each job's exit code, rank 0's printed
  verdict, and the kernels' launches counted on the device, at 0 just
  before and read just after."""
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.replay import cli
  jobs, _ = replay_jobs(args, os.path.join(args.ckpt, '16'))
  import io
  out = []
  for label, argv in jobs:
    torch.cuda.synchronize()
    tfa.reset_launches()
    t0 = time.perf_counter()
    printed, errors = io.StringIO(), io.StringIO()
    with (contextlib.redirect_stdout(printed),
          contextlib.redirect_stderr(errors)):
      rc = cli.main(argv)
    torch.cuda.synchronize()
    out.append({'label': label, 'rc': rc, 'printed': printed.getvalue(),
                'errors': errors.getvalue()[-3000:],
                'launches': tfa.device_launches(),
                'host_launches': dict(tfa.launches),
                'seconds': time.perf_counter() - t0})
  return out


def step_line(ledger_dir, rank, step):
  """The ``step`` ledger line of ``step`` in ``rank``'s file."""
  with open(os.path.join(ledger_dir, f'ledger.rank{rank}.jsonl')) as f:
    for line in f:
      rec = json.loads(line)
      if rec.get('boundary') == 'step' and rec.get('step') == step:
        return rec
  raise AssertionError(f'16: no step line of step {step} in {ledger_dir} '
                       f'rank {rank}')


def replay_jobs(args, root):
  """16's jobs, in order: each layout's ``step 2`` from the corpus
  (expect exit 0), 16a's from the flipped checkpoint (exit 1) and 16b's
  ``bisect --per-sample`` over (0, 2] (exit 0)."""
  jobs, want = [], []
  for label, axes, data, impl in REPLAY_LAYOUTS:
    _, _, argv = replay_settings(args, data)
    d = os.path.join(root, label)
    mesh = ['--comm', 'torch', '--attention', impl] + [
        a for axis, n in axes.items() for a in (REPLAY_FLAG[axis], str(n))]
    base = argv + mesh + ['--ledger', os.path.join(d, 'ledger'), '--json']
    step = ['step', '--step', str(REPLAY_STEPS), '--checkpoint-dir']
    jobs.append((label, step + [os.path.join(d, 'ckpt')] + base))
    want.append((label, axes, data, 'step', 0, REPLAY_STEPS - 1))
    if label == '16a':
      jobs.append((f'{label} flipped',
                   step + [os.path.join(d, 'ckpt_flipped')] + base))
      want.append((label, axes, data, 'flipped', 1, REPLAY_STEPS - 1))
    if label == '16b':
      jobs.append((f'{label} bisect',
                   ['bisect', '--lo', '0', '--hi', str(REPLAY_STEPS),
                    '--per-sample', '--checkpoint-dir',
                    os.path.join(d, 'ckpt')] + base))
      want.append((label, axes, data, 'bisect', 0, REPLAY_STEPS))
  return jobs, want


def replay_launches(axes, data, kind, steps, rows):
  """The launches a 16 job makes on each rank: 12 a step of each kernel
  of its path, x seq blocks under the ring (``steps`` replayed), and
  for the bisect's per-sample scoring one forward of each of ``rows``
  rows."""
  from lddl_tpu_torch.training.pretrain import MODEL_SIZES
  per = MODEL_SIZES[MODEL]['num_layers'] * axes.get('seq', 1)
  fwd = per * (steps + (rows if kind == 'bisect' else 0))
  seg = data == 'packed'
  names = ('fwd', 'dq', 'dkv')
  return {(k + ('_seg' if s else '')): (
      (fwd if k == 'fwd' else per * steps) if s == seg else 0)
      for k in names for s in (False, True)}


def sharded_replay(args, card, worlds, root):
  """Phase 16's checks: the replay CLI run as the recorded runs' two ranks
  on the card (gloo), in phase 14's rank processes after the recordings
  (:func:`replay_in_ranks`); each replay's exit code on both ranks, its
  verdict against the recorded ``step`` line, its launches against
  :func:`replay_launches`; the bisect's spike step and losses against
  the recorded loss lines."""
  t0 = time.perf_counter()
  d16 = os.path.join(root, '16')
  rec = [r['16'] for r in worlds['two']]
  jobs, want = replay_jobs(args, d16)
  res = [r['16replay'] for r in worlds['two']]
  seconds = sum(job['seconds'] for job in res[0])
  out = {'seconds': seconds, 'jobs': {}}
  for i, (label, axes, data, kind, rc, steps) in enumerate(want):
    per = [r[i] for r in res]
    name = jobs[i][0]
    if [p['rc'] for p in per] != [rc, rc]:
      raise AssertionError(f'16 {name}: exit codes {[p["rc"] for p in per]}'
                           f', want {rc} on both ranks: '
                           f'{[p["printed"][-2000:] + p["errors"] for p in per]}')
    if per[1]['printed']:
      raise AssertionError(f'16 {name}: rank 1 printed '
                           f'{per[1]["printed"][-2000:]!r}')
    printed = json.loads(per[0]['printed']) if kind != 'flipped' else None
    line = step_line(os.path.join(d16, label, 'ledger'), 0, REPLAY_STEPS)
    rows = 0
    if kind == 'step':
      if not (printed['match'] and printed['digest'] == line['digest'] and
              printed['restored_step'] == 1):
        raise AssertionError(f'16 {name}: {printed} vs the step line {line}')
    elif kind == 'bisect':
      recorded = [step_line(os.path.join(d16, label, 'ledger'), 0,
                            s)['loss'] for s in (1, 2)]
      losses = [x for _, x in printed['losses']]
      if (losses != recorded or losses != rec[0][label]['losses'] or
          printed['spike_step'] != REPLAY_STEPS):
        raise AssertionError(f'16 {name}: losses {losses}, spike '
                             f'{printed["spike_step"]}; recorded '
                             f'{recorded} / {rec[0][label]["losses"]}')
      rows = len(printed['per_sample'])
    expect = replay_launches(axes, data, kind, steps, rows)
    for rank, p in enumerate(per):
      if p['launches'] != expect or p['host_launches'] != expect:
        raise AssertionError(f'16 {name} rank {rank}: launches '
                             f'{p["launches"]} on the device, '
                             f'{p["host_launches"]} by the wrappers; want '
                             f'{expect}')
    out['jobs'][name] = {
        'rc': rc, 'seconds': [p['seconds'] for p in per],
        'launches_per_rank': [p['launches'] for p in per],
        'result': {k: v for k, v in (printed or {}).items()
                   if k != 'losses'} if printed else None}
    log(f'  16 {name}: {" ".join(jobs[i][1][:1])} launched as two ranks '
        f'({axes}, {data}): exit {rc} on both'
        + (f', the step line\'s {line["digest"]} reconstructed'
           if kind == 'step' else '')
        + (f', spike at step {printed["spike_step"]}, losses = the loss '
           f'lines, {rows} rows scored' if kind == 'bisect' else '')
        + f'; launches a rank {per[0]["launches"]}; '
        f'{[round(p["seconds"], 1) for p in per]} s a rank [{card}]')
  for label, *_ in REPLAY_LAYOUTS:
    r = rec[0][label]
    log(f'  16 {label} recorded in phase 14\'s ranks: losses {r["losses"]}, '
        f'{r["seconds"]:.1f} s a rank, batch rank {r["dp"]} [{card}]')
  check_no_rank_processes('phase 16')
  out['recorded'] = {label: rec[0][label] for label, *_ in REPLAY_LAYOUTS}
  out['phase_seconds'] = time.perf_counter() - t0
  log(f'  phase 16: {out["phase_seconds"]:.1f} s of checks (the replays '
      f'{seconds:.1f} s, in phase 14\'s rank processes) [{card}]')
  return out


# ---- phase 17: preprocessing on the card ----

MASK_SOURCE = 'lddl_tpu_torch/csrc/masking.cu'
MASK_REPLACES = {'mask_partition': 'lddl_tpu/ops/masking.py:494',
                 'mask_matrix': 'lddl_tpu/ops/masking.py:414'}
MASK_ROWS = 16384            # rows of 17a's partitions
MASK_SEQ_LENS = (128, 512)
MASK_CAP = 9                 # 17a's max_predictions cap case
# 17a's long rows (seq_len, rows): above 1024 positions the kernels keep
# a row's keys in shared memory, not in registers (csrc/masking.cu).
MASK_LONG = (8192, 256)
MASK_RATIO = 0.15
MASK_IDS = {'mask_id': 103, 'cls_id': 101, 'sep_id': 102}
MASK_SHORT_PROB = 0.1        # the preprocessor's short_seq_prob
# int32 operations a second: the table's 67 TFLOP/s of float32 outside
# the tensor cores counts an FMA as two on 128 lanes an SM; an H100 SM has
# 64 INT32 lanes, so a quarter of it counts single int32 operations.
PEAK_INT32_OPS = 67e12 / 4
# Integer operations of one threefry2x32 (threefry_bits in masking.cu,
# counted from the code): 2 adds of the key, 20 rounds of add, funnel
# rotate and xor, 5 key injections of 2 adds, the final xor.
THREEFRY_OPS = 2 + 20 * 3 + 5 * 2 + 1
# Per valid position beyond its threefry: the valid test (~6), the
# uniform's shift, or and subtract, the key's shift and or (~5); per picked
# position three more threefry (decide, randint's two draws) and the
# 80/10/10 compares and randint's three remainders and multiply-add (~12).
# A padding or special position needs no draw: the function's least work
# there is its output bytes.
POSITION_OPS = THREEFRY_OPS + 11
PICKED_OPS = 3 * THREEFRY_OPS + 12
PREP_CORPUS_MB = 64          # synthetic one-document-per-line corpus
PREP_SEQ, PREP_BIN, PREP_BLOCKS = 512, 64, 8
PREP_DUP = 5                 # the preprocessor's default duplicate factor
PREP_FLAGS = ['--target-seq-length', str(PREP_SEQ), '--bin-size',
              str(PREP_BIN), '--num-blocks', str(PREP_BLOCKS), '--masking']
PREP_SHARDS = 8
PREP_STEPS = 8               # 17e's training steps
PREP_BATCH = 16
PREP_TIMEOUT = 600
PREP_MASK_COLUMNS = ('mask_delta_positions', 'mask_delta_new_ids',
                     'mask_delta_k')
# Phase 18: the committed sets the card's machine remakes (18a), and the
# pool's runs over phase 17's corpus (18c).
FORMAT_SETS = ('packed', 'codebert', 'bart')
FORMAT_MODULES = {'packed': 'lddl_tpu_torch.preprocess.packed',
                  'codebert': 'lddl_tpu_torch.preprocess.codebert',
                  'bart': 'lddl_tpu_torch.preprocess.bart'}
POOL_MAX_WORKERS = 8
POOL_RUNS = {'bert': ('lddl_tpu_torch.preprocess.bert',
                      PREP_FLAGS + ['--mask-backend', 'host']),
             'packed': ('lddl_tpu_torch.preprocess.packed',
                        ['--target-seq-length', '8192', '--num-blocks',
                         str(PREP_BLOCKS)])}
# One pool worker SIGKILLed at the start of its third task, once in the run:
# with N=8 workers over 10 partitions a worker takes at most two of the
# shuffle's scatter tasks, so the kill lands in the process phase, where the
# worker's earlier shard writes may still wait on its write-back thread.
POOL_FAULT = 'kill:pool.task:nth=3,once'


def mask_inputs(n, seq_len, seed):
  """A partition's flat ids (uint16 of a 30,522 vocab) and ``n`` rows of
  ragged A/B ranges into it, from ``seed``, with the row lengths the
  preprocessor makes from documents longer than a row (preprocess/
  pairing.py): a full row of ``seq_len`` tokens, or with MASK_SHORT_PROB a
  short one of 5..seq_len."""
  r = np.random.default_rng(seed)
  lengths = np.where(r.random(n) < MASK_SHORT_PROB,
                     r.integers(5, seq_len + 1, n), seq_len)
  na = r.integers(1, lengths - 3)
  nb = lengths - 3 - na
  total = int((na + nb).sum()) + 64
  flat = r.integers(0, VOCAB_REAL, total).astype(np.uint16)
  a0 = r.integers(0, total - na)
  b0 = r.integers(0, total - nb)
  return flat, np.stack([a0, a0 + na], 1), np.stack([b0, b0 + nb], 1)


def path_partition(sink, seed, part=0):
  """The masking kernel's inputs of one of the preprocessor's launches:
  partition ``part``'s base rows as written under ``sink`` (every bin; A's
  and B's lengths), each tiled PREP_DUP times copy-adjacent as the
  preprocessor tiles them, A and B of a row adjacent in a flat array of
  ids from ``seed``."""
  na, nb = [], []
  for name, t in shard_tables(sink).items():
    if name.startswith(f'part.{part}.parquet') and t.num_rows:
      a = t.column('A').token_counts().astype(np.int64)
      na.append(a)
      nb.append(t.column('num_tokens').astype(np.int64) - 3 - a)
  na, nb = np.concatenate(na), np.concatenate(nb)
  a0 = np.concatenate([[0], np.cumsum(na + nb)[:-1]])
  flat = np.random.default_rng(seed).integers(
      0, VOCAB_REAL, int((na + nb).sum())).astype(np.uint16)
  a = np.repeat(np.stack([a0, a0 + na], 1), PREP_DUP, axis=0)
  b = np.repeat(np.stack([a0 + na, a0 + na + nb], 1), PREP_DUP, axis=0)
  return flat, a, b


def mask_bound(kind, n, seq_len, valid, picked, width=None):
  """(ms, 'operations' or 'bytes'): the least time the card could take for
  one program's work on these inputs: a uniform draw at each of the
  ``valid`` positions (A's and B's tokens) and three more at each picked
  one; each input byte read once (the partition program reads the flat ids
  at valid positions only) and each output byte written once."""
  ops = valid * POSITION_OPS + picked * PICKED_OPS
  if kind == 'mask_partition':
    moved = valid * 2 + n * 16 + n * width * (2 + 4) + n * 4
  else:
    moved = n * seq_len * 4 + n * 8 + n * seq_len * (4 + 1)
  t_ops, t_bytes = ops / PEAK_INT32_OPS, moved / PEAK_BYTES
  return 1e3 * max(t_ops, t_bytes), (
      'operations' if t_ops >= t_bytes else 'bytes')


def check_equal(label, got, want):
  """Every output of ``got`` equals ``want``'s exactly."""
  for i, (g, w) in enumerate(zip(got, want)):
    if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
      bad = (g != w).sum().item() if g.shape == w.shape else 'shape'
      raise AssertionError(f'{label}: output {i} differs ({bad} elements; '
                           f'{tuple(g.shape)} {g.dtype} vs '
                           f'{tuple(w.shape)} {w.dtype})')


def mask_kernel_case(tm, kind, seq_len, seed, cap=None, inputs=None):
  """One program at one shape: the kernel twice (bitwise equal) and its
  plain version (the jit program as torch ops, argsort of the argsort: the
  yardstick too) on the same card inputs, equal exactly. The kernel is
  timed by its launches alone (kernel_ab.launches_ms: CUDA graph replays
  of the wrapper's call) and by one wrapper call a CUDA event pair (with
  the host's work between the events); the plain version by CUDA
  events. ``inputs``: (flat, a, b, label) in place of mask_inputs'
  MASK_ROWS rows."""
  from kernel_ab import launches_ms
  flat, a, b, rows = inputs or (*mask_inputs(MASK_ROWS, seq_len, seed),
                                'full')
  keys = tm.draw_keys(seed)
  n = len(a)
  if kind == 'mask_partition':
    max_pred = tm.partition_max_pred(seq_len, MASK_RATIO, cap)
    args = [torch.from_numpy(flat).to(DEVICE)] + [
        torch.from_numpy(np.ascontiguousarray(c, dtype=np.int32)).to(DEVICE)
        for c in (a[:, 0], a[:, 1], b[:, 0], b[:, 1])]
    kw = dict(seq_len=seq_len, masked_lm_ratio=MASK_RATIO,
              vocab_size=VOCAB_REAL, max_pred=max_pred, **MASK_IDS)
    run = tm.partition_program
  else:
    ids, row_len, na = tm.assemble_pair_matrix(
        flat.astype(np.int32), a, b, MASK_IDS['cls_id'], MASK_IDS['sep_id'],
        seq_len)
    args = [torch.from_numpy(x).to(DEVICE) for x in (ids, row_len, na)]
    kw = dict(masked_lm_ratio=MASK_RATIO, vocab_size=VOCAB_REAL,
              mask_id=MASK_IDS['mask_id'], max_pred=cap)
    run = tm.matrix_program
  kernel = lambda: run(*args, keys, **kw)  # noqa: E731
  plain = lambda: run(*[x.cpu() for x in args], keys, **kw)  # noqa: E731
  on_card_plain = lambda: _on_card_plain(tm, kind, args, keys, kw)  # noqa
  first, second = kernel(), kernel()
  torch.cuda.synchronize()
  label = f'17a: {kind} s={seq_len} x {n} ({rows} rows)' + (
      f' cap {cap}' if cap else '')
  check_equal(f'{label}: two launches', second, first)
  want = on_card_plain()
  check_equal(f'{label}: kernel vs plain', first, want)
  if seq_len == MASK_SEQ_LENS[0] and cap is None:
    # The CPU's plain version (what the CPU tests hold against JAX) too.
    check_equal(f'{label}: the CPU plain version', [x.to(DEVICE) for x in
                                                    plain()], want)
  k = (first[2] if kind == 'mask_partition' else first[1].sum(1)).to(
      torch.int64)
  picked = int(k.sum())
  valid = int((a[:, 1] - a[:, 0]).sum() + (b[:, 1] - b[:, 0]).sum())
  width = first[0].shape[1] if kind == 'mask_partition' else None
  bound_ms, bound_by = mask_bound(kind, n, seq_len, valid, picked, width)
  ms = launches_ms(kernel)
  wrapper_ms = cuda_ms(kernel)
  plain_ms = cuda_ms(on_card_plain, reps=5, warmup=1)
  share = valid / (n * seq_len)
  row = {'name': kind, 'shape': [n, seq_len], 'rows': rows, 'cap': cap,
         'max_abs_err': 0,
         'ms': ms, 'wrapper_ms': wrapper_ms, 'plain_ms': plain_ms,
         'bound_ms': bound_ms, 'bound_by': bound_by, 'picked': picked,
         'valid': valid, 'valid_share': share, 'k_max': int(k.max())}
  log(f'  {label}: = plain exactly, two launches bitwise equal; kernel '
      f'{ms:.4f} ms by launches alone ({wrapper_ms:.4f} ms a wrapper call '
      f'an event pair), plain (argsort-twice yardstick) {plain_ms:.3f} ms, '
      f'bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound;'
      f' {valid} valid positions ({share:.1%}), {picked} picked')
  return row


def mask_call_ms(tm, inputs, seed, picked, reps=5):
  """Host milliseconds of one whole mask_partition_device call on
  ``inputs`` (flat, a, b, label) at PREP_SEQ: numpy in (the uploads), the
  launch, numpy out (the downloads, which synchronise); the median of
  ``reps`` after a warm-up. Its k must sum to ``picked``, the kernel's."""
  flat, a, b, _ = inputs
  kw = dict(seq_len=PREP_SEQ, masked_lm_ratio=MASK_RATIO,
            vocab_size=VOCAB_REAL, seed=seed, **MASK_IDS)
  tm.mask_partition_device(flat, a, b, **kw)
  times = []
  for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, k = tm.mask_partition_device(flat, a, b, **kw)
    times.append(time.perf_counter() - t0)
  if int(k.sum()) != picked:
    raise AssertionError(f'17a: mask_partition_device picked {k.sum()}, '
                         f'the kernel {picked}')
  return 1e3 * float(np.median(times))


def _on_card_plain(tm, kind, args, keys, kw):
  """The plain version on the card's tensors (what the wrapper runs for
  CPU tensors), for the comparison and its time."""
  span, mult = tm.randint_constants(kw['vocab_size'])
  if kind == 'mask_partition':
    return tm._partition_plain(
        *args, keys, seq_len=kw['seq_len'], ratio=kw['masked_lm_ratio'],
        span=span, mult=mult, mask_id=kw['mask_id'], cls_id=kw['cls_id'],
        sep_id=kw['sep_id'], max_pred=kw['max_pred'])
  return tm._matrix_plain(
      *args, keys, ratio=kw['masked_lm_ratio'], span=span, mult=mult,
      mask_id=kw['mask_id'], max_pred=kw['max_pred'])


def masking_kernels(args, card, path_sink):
  """17a: both masking programs against their plain versions on the
  card, at s=128 and s=512 over MASK_ROWS full rows, over the rows of one
  of the preprocessor's launches (partition 0 under ``path_sink``, 17c's
  sink: 17b's rows; also the whole mask_partition_device call on them), a
  max_predictions cap, MASK_LONG's rows of 8192 (keys in shared memory),
  an empty partition; and the matrix program through its entry point,
  mask_batch(backend='device'), counted."""
  from lddl_tpu_torch.ops import masking as tm
  rows = []
  for seq_len in MASK_SEQ_LENS:
    for kind in MASK_REPLACES:
      rows.append(mask_kernel_case(tm, kind, seq_len, args.seed + seq_len))
  path = (*path_partition(path_sink, args.seed + 3), '17b partition 0')
  for kind in MASK_REPLACES:
    rows.append(mask_kernel_case(tm, kind, PREP_SEQ, args.seed + 3,
                                 inputs=path))
    torch.cuda.empty_cache()
  # The whole call the preprocessor makes a partition, beside its kernel.
  m1 = next(r for r in rows if r['name'] == 'mask_partition' and
            r['rows'] == path[3])
  m1['call_ms'] = mask_call_ms(tm, path, args.seed + 3, m1['picked'])
  log(f'  17a: mask_partition_device on {path[3]} (numpy in, numpy out): '
      f'{m1["call_ms"]:.3f} ms, the kernel {m1["ms"] / m1["call_ms"]:.1%} '
      'of it')
  for kind in MASK_REPLACES:
    rows.append(mask_kernel_case(tm, kind, MASK_SEQ_LENS[-1],
                                 args.seed + 1, cap=MASK_CAP))
    torch.cuda.empty_cache()
  seq_long, n_long = MASK_LONG
  long_rows = (*mask_inputs(n_long, seq_long, args.seed + seq_long), 'full')
  for kind in MASK_REPLACES:
    rows.append(mask_kernel_case(tm, kind, seq_long, args.seed + seq_long,
                                 inputs=long_rows))
    torch.cuda.empty_cache()
  empty = np.zeros((0, 2), np.int64)
  tm.reset_launches()
  pos, new, k = tm.mask_partition_device(
      np.zeros(4, np.int32), empty, empty, seq_len=PREP_SEQ,
      masked_lm_ratio=MASK_RATIO, vocab_size=VOCAB_REAL, seed=args.seed,
      **MASK_IDS)
  if pos.shape != (0, tm.partition_max_pred(PREP_SEQ, MASK_RATIO)) or \
      len(k) or any(tm.launches.values()):
    raise AssertionError(f'17a: an empty partition gave {pos.shape}, '
                         f'{len(k)} k, launches {tm.launches}')
  # M2's entry point as a user calls it (it has no caller in the
  # preprocessor): mask_batch(backend='device') on a padded id matrix.
  flat, a, b = mask_inputs(MASK_ROWS, PREP_SEQ, args.seed + 7)
  ids, row_len, na = tm.assemble_pair_matrix(
      flat.astype(np.int32), a, b, MASK_IDS['cls_id'], MASK_IDS['sep_id'],
      PREP_SEQ)
  tm.reset_launches()
  masked, picked = tm.mask_batch(
      ids, row_len, na, masked_lm_ratio=MASK_RATIO, vocab_size=VOCAB_REAL,
      mask_id=MASK_IDS['mask_id'], seed=args.seed + 7, backend='device')
  matrix_launches = tm.launches['mask_matrix']
  want = _on_card_plain(
      tm, 'mask_matrix', [torch.from_numpy(x).to(DEVICE) for x in
                          (ids, row_len, na)],
      tm.draw_keys(args.seed + 7),
      dict(masked_lm_ratio=MASK_RATIO, vocab_size=VOCAB_REAL,
           mask_id=MASK_IDS['mask_id'], max_pred=None))
  if matrix_launches != 1 or not (
      np.array_equal(masked, want[0].cpu().numpy()) and
      np.array_equal(picked, want[1].cpu().numpy())):
    raise AssertionError(f'17a: mask_batch(backend=device) launched '
                         f'{matrix_launches} kernels or differs from the '
                         'plain version')
  log(f'  17a: an empty partition launches nothing; mask_batch(backend='
      f"'device') on {MASK_ROWS} x {PREP_SEQ}: 1 launch, = plain exactly")
  return {'rows': rows, 'mask_matrix_launches': matrix_launches}


# Phase 17's subprocesses: killed at exit if still running.
PREP_PROCS = []


def prep_start(cmd, env):
  """Start ``cmd`` from the checkout (killed by the backgrounds' close)."""
  proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
  PREP_PROCS.append(proc)
  return proc


def stopped(proc):
  """Wait for ``proc`` (killed past PREP_TIMEOUT, which raises): (exit
  code, stdout, stderr)."""
  try:
    out, err = proc.communicate(timeout=PREP_TIMEOUT)
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.wait()
  return proc.returncode, out, err


def prep_run(cmd, env, label):
  """``cmd`` from the checkout: (stdout, seconds); raises with its output
  on a non-zero exit or past PREP_TIMEOUT."""
  t0 = time.perf_counter()
  rc, out, err = stopped(prep_start(cmd, env))
  seconds = time.perf_counter() - t0
  if rc:
    raise AssertionError(f'{label}: {" ".join(cmd[1:4])} exited '
                         f'{rc}:\n{out[-3000:]}\n{err[-5000:]}')
  return out, seconds


def prep_cli(module, argv, env, label):
  """``python -m <module> <argv>`` from the checkout, as a user runs it."""
  return prep_run([sys.executable, '-m', module, *argv], env, label)


def telemetry_lines(directory):
  with open(os.path.join(directory, 'telemetry.rank0.jsonl')) as f:
    return {x['name']: x for x in map(json.loads, f) if 'name' in x}


def preprocess_run(corpus, sink, tele, backend, label):
  """One preprocess of ``corpus`` into ``sink`` by the CLI (telemetry on,
  exported to ``tele``): (partitions, samples, seconds, telemetry)."""
  env = dict(os.environ, LDDL_TELEMETRY='1', LDDL_TELEMETRY_DIR=tele)
  argv = ['--source', corpus, '--sink', sink, '--vocab-file', VOCAB_FILE,
          *PREP_FLAGS] + (['--mask-backend', backend] if backend else [])
  out, seconds = prep_cli('lddl_tpu_torch.preprocess.bert', argv, env, label)
  m = re.search(r'preprocessed (\d+) samples into (\d+) partitions in '
                r'([0-9.]+)s', out)
  if not m or 'mask=device' not in out and backend != 'host':
    raise AssertionError(f'{label}: unexpected output:\n{out[-2000:]}')
  return (int(m.group(2)), int(m.group(1)), float(m.group(3)), seconds,
          telemetry_lines(tele))


def shard_tables(sink):
  """``{file name: Table}`` of every shard under ``sink`` (port reader)."""
  from lddl_tpu_torch.pipeline.parquet_io import ParquetFile
  out = {}
  for name in sorted(os.listdir(sink)):
    if '.parquet' in name:
      with ParquetFile(os.path.join(sink, name)) as pf:
        out[name] = pf.read()
  return out


def npy_u2_values(column, counts):
  """The uint16 payloads of a binary column of np.save-framed ``<u2``
  arrays (the writer's delta columns), ``counts[i]`` values in row i,
  gathered flat in numpy; raises where a row's framing says otherwise."""
  offsets, data = column.offsets, column.data
  starts = offsets[:-1]
  hlen = data[starts + 8].astype(np.int64) | (
      data[starts + 9].astype(np.int64) << 8)
  payload = starts + 10 + hlen
  counts = np.asarray(counts, dtype=np.int64)
  if not np.array_equal(offsets[1:] - payload, 2 * counts) or not all(
      b"'descr': '<u2'" in data[a:a + 10 + int(h)].tobytes()
      for a, h in zip(starts[:1], hlen[:1])):
    raise AssertionError('a delta column\'s framing disagrees with its k')
  total = int(counts.sum())
  at = np.repeat(payload - 2 * np.concatenate([[0], np.cumsum(counts)[:-1]]),
                 counts) + 2 * np.arange(total)
  return (data[at].astype(np.int64) | (data[at + 1].astype(np.int64) << 8))


def check_delta_rows(tables, label, backend):
  """The row invariants of a delta shard, over every copy of every row
  in numpy: each copy's k is min(max(1, rint(num_tokens * 0.15)),
  num_tokens - 3[, max_pred]) (the device program's float32 arithmetic
  and its max_pred cap; the host pass's float64, uncapped), its
  positions strictly increasing, inside A or B, never on [CLS] or a
  [SEP]. Returns (rows, copies, tokens of A and B)."""
  from lddl_tpu_torch.ops.masking import partition_max_pred
  max_pred = partition_max_pred(PREP_SEQ, MASK_RATIO)
  rows = copies = tokens = 0
  for name, t in tables.items():
    n = t.num_rows
    if not n:
      continue
    num_tokens = t.column('num_tokens').astype(np.int64)
    na = t.column('A').token_counts()
    if backend == 'device':
      want_k = np.minimum(np.maximum(1, np.rint(
          num_tokens.astype(np.float32) * np.float32(MASK_RATIO)).astype(
              np.int64)), max_pred)
    else:
      want_k = np.maximum(1, np.rint(num_tokens * MASK_RATIO).astype(
          np.int64))
    want_k = np.minimum(want_k, num_tokens - 3)
    k = npy_u2_values(t.column('mask_delta_k'),
                      np.full(n, PREP_DUP)).reshape(n, PREP_DUP)
    if (k != want_k[:, None]).any():
      bad = int(np.nonzero((k != want_k[:, None]).any(1))[0][0])
      raise AssertionError(f'{label}: {name} row {bad}: k {k[bad].tolist()}'
                           f', want {int(want_k[bad])} x {PREP_DUP}')
    pos = npy_u2_values(t.column('mask_delta_positions'), k.sum(1))
    per_copy = k.reshape(-1)
    row = np.repeat(np.repeat(np.arange(n), PREP_DUP), per_copy)
    first = np.zeros(len(pos), dtype=bool)
    first[np.concatenate([[0], np.cumsum(per_copy)[:-1]])[per_copy > 0]] = True
    rising = np.diff(pos, prepend=-1) > 0
    in_a = (pos >= 1) & (pos < 1 + na[row])
    in_b = (pos >= 2 + na[row]) & (pos < num_tokens[row] - 1)
    ok = (first | rising) & (in_a | in_b)
    if not ok.all():
      bad = int(row[np.nonzero(~ok)[0][0]])
      raise AssertionError(f'{label}: {name} row {bad}: positions break the '
                           f'invariants (na {na[bad]}, num_tokens '
                           f'{num_tokens[bad]})')
    rows += n
    copies += n * PREP_DUP
    tokens += int((num_tokens - 3).sum())
  return rows, copies, tokens


def prep_seconds(tele):
  """Seconds of the preprocessor's parts, from its telemetry export."""
  pick = {'tokenize': 'preprocess.tokenize_seconds',
          'plan': 'preprocess.plan_seconds',
          'mask': 'preprocess.mask_seconds',
          'assemble': 'preprocess.assemble_seconds',
          'write': 'pipeline.write_seconds',
          'scatter': 'pipeline.scatter.map_seconds',
          'process': 'pipeline.process.map_seconds'}
  return {k: round(tele.get(v, {}).get('sum', 0.0), 3)
          for k, v in pick.items()}


class PrepBackground:
  """Phase 17's host-only work, started beside the kernels' build at the
  script's start (it needs no kernel, and the build leaves the host's
  cores idle; the script joins it before its first timed phase): the synthetic corpus (core/synth, PREP_CORPUS_MB
  MiB from --seed), then 17c's preprocess with ``--mask-backend host``.
  Phase 17 reads its results; :meth:`close` kills what still runs."""

  def __init__(self, args):
    import threading
    self.root = tempfile.mkdtemp(prefix='lddl_smoke_prep_')
    self.corpus = os.path.join(self.root, 'corpus')
    self.started = time.perf_counter()
    self.done = None
    self.result, self.error = {}, None
    self.thread = threading.Thread(target=self._run, args=(args.seed,),
                                   daemon=True)
    self.thread.start()

  def _run(self, seed):
    try:
      code = ('from lddl_tpu_torch.core import synth; '
              f'print(synth.write_corpus({self.corpus!r}, {PREP_CORPUS_MB}, '
              f'seed={seed}))')
      out, seconds = prep_run([sys.executable, '-c', code],
                              dict(os.environ), '17b corpus')
      self.result['corpus'] = (float(out.strip().splitlines()[-1]), seconds)
      self.result['host'] = preprocess_run(
          self.corpus, os.path.join(self.root, 'sink_host'),
          os.path.join(self.root, 'tele_host'), 'host', '17c')
    except BaseException as e:  # re-raised by join(), on the main thread
      self.error = e
    finally:
      self.done = time.perf_counter()

  def join(self):
    """Wait for it (seconds waited); raise what it raised."""
    t0 = time.perf_counter()
    self.thread.join(PREP_TIMEOUT)
    if self.thread.is_alive():
      raise AssertionError('17: the background preprocess outlived '
                           f'{PREP_TIMEOUT} s')
    if self.error is not None:
      raise self.error
    return time.perf_counter() - t0

  def close(self):
    for proc in PREP_PROCS:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(self.root, ignore_errors=True)


def preprocess_on_card(args, card, bg):
  """17b-17e: the preprocessor as users call it on a synthetic corpus,
  device masking by default (17b); the same with --mask-backend host
  (17c, run by ``bg`` beside the build); the balancer (17d); BERT-base
  trained from the balanced shards (17e)."""
  from lddl_tpu_torch.ops import flash_attention as tfa
  from lddl_tpu_torch.pipeline import shard_format as tformat
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  from lddl_tpu_torch.training import TrainLoop

  root = bg.root
  waited = bg.join()
  mb, corpus_s = bg.result['corpus']
  log(f'  17b: synthetic corpus of {mb:.1f} MiB (core/synth, seed '
      f'{args.seed}) in {corpus_s:.1f} s, then 17c, both in processes '
      f'started beside the build: done {bg.done - bg.started:.1f} s after '
      f'the script\'s start; phase 17 waited {waited:.1f} s for them')
  out = {'corpus_mib': mb, 'corpus_seconds': corpus_s}
  sinks = {}
  for backend in ('device', 'host'):
    label = '17b' if backend == 'device' else '17c'
    sink = os.path.join(root, f'sink_{backend}')
    if backend == 'device':
      parts, samples, run_s, wall_s, tl = preprocess_run(
          bg.corpus, sink, os.path.join(root, 'tele_device'), None, label)
    else:
      parts, samples, run_s, wall_s, tl = bg.result['host']
    sinks[backend] = sink
    # The counter exists once a partition masked on the device.
    launches = tl.get('preprocess.mask_kernel_launches', {}).get('total', 0)
    tasks = tl.get('pipeline.process.tasks', {}).get('total')
    want_launches = parts if backend == 'device' else 0
    if launches != want_launches or tasks != parts:
      raise AssertionError(f'{label}: {launches} masking kernel launches '
                           f'for {tasks} tasks, {parts} partitions; want '
                           f'{want_launches}')
    names = sorted(x for x in os.listdir(sink) if '.parquet' in x)
    want_names = sorted(f'part.{p}.parquet_{b}' for p in range(parts)
                        for b in range(PREP_SEQ // PREP_BIN))
    if names != want_names:
      raise AssertionError(f'{label}: shards {names[:5]}...; want every '
                           f'bin of every partition')
    tables = shard_tables(sink)
    for name in names:
      tag = tformat.shard_format_of(os.path.join(sink, name))
      if tag != ('delta', PREP_DUP):
        raise AssertionError(f'{label}: {name} is tagged {tag}')
    rows, copies, tokens = check_delta_rows(tables, label, backend)
    if rows != samples:
      raise AssertionError(f'{label}: the reader read {rows} rows of '
                           f'{samples}')
    secs = prep_seconds(tl)
    res = {'partitions': parts, 'rows': rows, 'samples': copies,
           'valid_share': tokens / (rows * PREP_SEQ),
           'seconds': run_s, 'wall_seconds': wall_s,
           'mb_per_s': mb / run_s, 'launches': launches, 'parts': secs}
    out[backend] = res
    log(f'  {label}: python -m lddl_tpu_torch.preprocess.bert '
        f'{" ".join(PREP_FLAGS)} (mask backend {backend}): {parts} '
        f'partitions, {rows} delta rows ({copies} samples at dup '
        f'{PREP_DUP}), every bin file, tags (delta, {PREP_DUP}); k, '
        f'positions in A or B, none special, increasing: held on every '
        f'copy ({tokens / (rows * PREP_SEQ):.1%} of the positions in A or '
        f'B); masking kernel launches {launches} (telemetry export); '
        f'{run_s:.1f} s in run ({wall_s:.1f} s of process): '
        f'{mb / run_s:.2f} MB/s of corpus on one card at dup {PREP_DUP}; '
        f'parts {secs} [{card}]')
  dev, host = shard_tables(sinks['device']), shard_tables(sinks['host'])
  differ = 0
  for name, t in dev.items():
    h = host[name]
    for col, kind in t.fields:
      a, b = t.column(col), h.column(col)
      same = (np.array_equal(a.offsets, b.offsets) and
              np.array_equal(a.data, b.data)) if kind in (
                  'string', 'binary') else np.array_equal(a, b)
      if col in PREP_MASK_COLUMNS:
        differ += not same
      elif not same:
        raise AssertionError(f'17c: {name} column {col} differs between '
                             'the device and host backends')
  if not differ:
    raise AssertionError('17c: the two backends wrote the same masks')
  log(f'  17c: every non-masking column byte-identical to 17b\'s, row for '
      f'row; the masking columns differ ({differ} file-columns: '
      'different draws)')
  bal = os.path.join(root, 'balanced')
  _, bal_s = prep_cli('lddl_tpu_torch.balance',
                      ['--indir', sinks['device'], '--outdir', bal,
                       '--num-shards', str(PREP_SHARDS)], dict(os.environ),
                      '17d')
  with open(os.path.join(bal, '.num_samples.json')) as f:
    meta = json.load(f)
  balanced = shard_tables(bal)
  total = 0
  for b in range(PREP_SEQ // PREP_BIN):
    counts = [balanced[f'shard-{s}.parquet_{b}'].num_rows
              for s in range(PREP_SHARDS)]
    if max(counts) - min(counts) > 1 or any(
        meta[f'shard-{s}.parquet_{b}'] != c for s, c in enumerate(counts)):
      raise AssertionError(f'17d: bin {b} shards hold {counts} groups, the '
                           f'cache says {meta}')
    total += sum(counts)
  if total != out['device']['rows']:
    raise AssertionError(f'17d: {total} groups balanced of '
                         f'{out["device"]["rows"]}')
  out['balance'] = {'seconds': bal_s, 'groups': total}
  log(f'  17d: python -m lddl_tpu_torch.balance --num-shards {PREP_SHARDS}:'
      f' every bin\'s {PREP_SHARDS} shards hold n or n+1 groups, {total} in '
      f'all = 17b\'s, .num_samples.json written, {bal_s:.1f} s')
  settings = {'base_seed': args.seed, 'batch_size_per_rank': PREP_BATCH,
              'bin_size': PREP_BIN, 'max_seq_length': PREP_SEQ,
              'masking': 'static', 'shuffle_buffer_size': 256}
  with step_cache(False):
    loop = TrainLoop.build(bal, load_bert_tokenizer(VOCAB_FILE),
                           **pairs_build(args, settings))
    tfa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = loop.run(PREP_STEPS, log_every=0)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / max(1, len(losses))
    counts = tfa.device_launches()
  layers = loop.model.cfg.num_layers
  want = {k: (layers * PREP_STEPS if not k.endswith('_seg') else 0)
          for k in counts}
  if len(losses) != PREP_STEPS or not np.isfinite(losses).all():
    raise AssertionError(f'17e: losses {losses}')
  check_launches(counts, dict(tfa.launches), want, '17e')
  out['train'] = {'losses': [float(x) for x in losses],
                  'ms_per_step': 1e3 * step_s, 'launches': counts}
  log(f'  17e: BERT-base from the balanced shards (static masks, bins of '
      f'{PREP_BIN}, batch {PREP_BATCH}, step cache off): {PREP_STEPS} '
      f'finite losses {losses[0]:.4f} -> {losses[-1]:.4f}, '
      f'{1e3 * step_s:.1f} ms/step [{card}]')
  del loop
  torch.cuda.empty_cache()
  return out


def preprocessing(args, card, bg):
  """Phase 17: 17a the masking kernels, 17b-17e the preprocessing path
  (``bg``: its host-only part, started at the script's start; phase 18c
  reads its corpus, and the caller closes it)."""
  from lddl_tpu_torch.ops import masking as tm
  bg.join()
  kernels = masking_kernels(args, card, os.path.join(bg.root, 'sink_host'))
  torch.cuda.empty_cache()
  tm.reset_launches()
  path = preprocess_on_card(args, card, bg)
  return {'kernels': kernels, 'path': path}


class FormatsBackground:
  """Phase 18a's host work, started beside the build with phase 17's
  (joined with it before the first timed phase): the sources of the
  committed sets of FORMAT_SETS remade from digests.json's corpus seeds
  by lddl_tpu_torch.testing's recipes, then each through the port's
  preprocessor and balancer CLIs at tests/make_torch_shards.py's settings
  (``testing.SHARD_SETS``). :attr:`sets` names each balanced directory;
  :meth:`close` kills what still runs and removes them."""

  def __init__(self, digests):
    import threading
    self.root = tempfile.mkdtemp(prefix='lddl_smoke_formats_')
    self.sets = {n: os.path.join(self.root, n) for n in FORMAT_SETS}
    self.started = time.perf_counter()
    self.done = None
    self.result, self.error = {}, None
    self.thread = threading.Thread(target=self._run, args=(digests,),
                                   daemon=True)
    self.thread.start()

  def _run(self, digests):
    from lddl_tpu_torch import testing
    try:
      seeds = {n: digests[n]['corpus_seed'] for n in FORMAT_SETS}
      srcs = {n: os.path.join(self.root, f'{n}_src') for n in FORMAT_SETS}
      code = '; '.join(['from lddl_tpu_torch import testing'] + [
          f'testing.write_set_source({n!r}, {srcs[n]!r}, {seeds[n]}, '
          f'{VOCAB_FILE!r})' for n in FORMAT_SETS])
      _, self.result['sources_seconds'] = prep_run(
          [sys.executable, '-c', code], dict(os.environ), '18a sources')
      for n in FORMAT_SETS:
        sink = os.path.join(self.root, f'{n}_sink')
        out, prep_s = prep_cli(
            FORMAT_MODULES[n], testing.shard_set_argv(
                n, srcs[n], sink, seeds[n], VOCAB_FILE), dict(os.environ),
            f'18a {n}')
        _, bal_s = prep_cli(
            'lddl_tpu_torch.balance',
            ['--indir', sink, '--outdir', self.sets[n], '--num-shards',
             str(testing.SHARD_SETS[n][1])], dict(os.environ),
            f'18a {n} balance')
        self.result[n] = {'printed': out.strip().splitlines()[-1],
                          'preprocess_seconds': prep_s,
                          'balance_seconds': bal_s}
    except BaseException as e:  # re-raised by join(), on the main thread
      self.error = e
    finally:
      self.done = time.perf_counter()

  def join(self):
    """Wait for it (seconds waited); raise what it raised."""
    t0 = time.perf_counter()
    self.thread.join(PREP_TIMEOUT)
    if self.thread.is_alive():
      raise AssertionError(f'18a: the background preprocessors outlived '
                           f'{PREP_TIMEOUT} s')
    if self.error is not None:
      raise self.error
    return time.perf_counter() - t0

  def close(self):
    for proc in PREP_PROCS:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(self.root, ignore_errors=True)


def formats_rebuilt(digests, fb, card):
  """18a's check: the port's loaders over the sets ``fb`` wrote give every
  committed digest (packed, codebert: epoch 0; bart: epochs 0 and 1, and
  every chunk's token_sha256), so they are lddl_tpu's shards, made on the
  card's machine. Returns each set's directory and times."""
  from lddl_tpu_torch.loader import (get_bart_pretrain_data_loader,
                                     get_codebert_pretrain_data_loader,
                                     get_packed_pretrain_data_loader)
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  waited = fb.join()
  out = {'sources_seconds': fb.result['sources_seconds'],
         'done_after_start_s': fb.done - fb.started, 'waited_s': waited}
  for name, make in (('packed', get_packed_pretrain_data_loader),
                     ('codebert', get_codebert_pretrain_data_loader)):
    t0 = time.perf_counter()
    got = [batch_sha256(b) for b in make(fb.sets[name], vocab_file=VOCAB_FILE,
                                         **digests[name]['settings'])]
    check_digests(f'18a {name}', got, digests[name]['batches'])
    out[name] = dict(fb.result[name], batches=len(got),
                     check_seconds=time.perf_counter() - t0)
  t0 = time.perf_counter()
  loader = get_bart_pretrain_data_loader(
      path=fb.sets['bart'], vocab_file=VOCAB_FILE,
      **digests['bart']['settings'])
  for e, want in enumerate(bart_want(digests)):
    check_digests(f'18a bart, epoch {e}', [batch_sha256(b) for b in loader],
                  want)
  chunks = bart_chunks(fb.sets['bart'])
  ids, offsets = load_bert_tokenizer(VOCAB_FILE).encode_batch_ids(chunks)
  if (len(chunks) != digests['bart']['chunks'] or
      token_sha256(ids, offsets) != digests['bart']['token_sha256']):
    raise AssertionError(f'18a bart: the ids of {len(chunks)} chunks are not '
                         'the committed set\'s (digests.json)')
  out['bart'] = dict(fb.result['bart'], chunks=len(chunks),
                     check_seconds=time.perf_counter() - t0)
  for name in FORMAT_SETS:
    r = out[name]
    log(f'  18a {name}: source remade from corpus seed '
        f'{digests[name]["corpus_seed"]}, python -m {FORMAT_MODULES[name]} '
        f'({r["printed"]}; {r["preprocess_seconds"]:.1f} s of process) and '
        f'the balancer ({r["balance_seconds"]:.1f} s): every committed '
        'digest (digests.json' + (', epochs 0 and 1 and token_sha256'
                                   if name == 'bart' else '') +
        f'), {r["check_seconds"]:.1f} s [{card}]')
  log(f'  18a: sources in {out["sources_seconds"]:.1f} s; all done '
      f'{out["done_after_start_s"]:.1f} s after the script\'s start, '
      f'beside the build; waited {waited:.1f} s here')
  return out


def sink_files(sink):
  """``{name: sha256}`` of a sink's shard files, and its hidden files (a
  killed writer's temporary files)."""
  files, hidden = {}, []
  for name in sorted(os.listdir(sink)):
    if name.startswith('.'):
      hidden.append(name)
    elif os.path.isfile(os.path.join(sink, name)):
      with open(os.path.join(sink, name), 'rb') as f:
        files[name] = hashlib.sha256(f.read()).hexdigest()
  return files, hidden


def pool_run(module, argv, corpus, workers, root, label, env=None):
  """One preprocess CLI run over ``corpus`` at ``--num-workers workers``,
  telemetry on: {run seconds (printed), wall seconds (the process), its
  output, its telemetry lines, its files, its hidden files}."""
  sink, tele = os.path.join(root, label), os.path.join(root, label + '_tele')
  env = dict(env or os.environ, LDDL_TELEMETRY='1', LDDL_TELEMETRY_DIR=tele)
  out, wall = prep_cli(module, ['--source', corpus, '--sink', sink,
                                '--vocab-file', VOCAB_FILE, *argv,
                                '--num-workers', str(workers)], env, label)
  m = re.search(r' in ([0-9.]+)s$', out.strip().splitlines()[-1])
  if not m:
    raise AssertionError(f'{label}: unexpected output:\n{out[-2000:]}')
  files, hidden = sink_files(sink)
  if not files:
    raise AssertionError(f'{label}: no shard written')
  return {'seconds': float(m.group(1)), 'wall_seconds': wall, 'out': out,
          'tele': telemetry_lines(tele), 'files': files, 'hidden': hidden}


def tele_total(tele, name):
  return tele.get(name, {}).get('total', 0)


def pool_parts(tele):
  """A pooled run's seconds by part, from its telemetry export: the pool's
  start (inside the scatter map), the scatter and process maps, and the
  process tasks' summed seconds (over all workers)."""
  pick = {'pool_start': 'pipeline.pool.start_seconds',
          'scatter': 'pipeline.scatter.map_seconds',
          'process': 'pipeline.process.map_seconds',
          'process_tasks': 'pipeline.process.task_seconds'}
  return {k: round(tele.get(v, {}).get('sum', 0.0), 3)
          for k, v in pick.items()}


def pool_runs(card, bg):
  """18c: phase 17's corpus through the BERT (host masking) and packed
  preprocessors at --num-workers 1 and N, nothing else of the script
  running: wall seconds and MB/s, the same files byte for byte; then BERT
  at N with --mask-backend auto and POOL_FAULT: mask=host, one respawn,
  the clean run's bytes."""
  mb = bg.result['corpus'][0]
  n = min(POOL_MAX_WORKERS, os.cpu_count() or 1)
  root = tempfile.mkdtemp(prefix='lddl_smoke_pool_', dir=bg.root)
  out = {'workers': n, 'corpus_mib': mb}
  for fmt, (module, argv) in POOL_RUNS.items():
    runs = {}
    for workers in (1, n):
      label = f'18c_{fmt}_w{workers}'
      r = pool_run(module, argv, bg.corpus, workers, root, label)
      steals = tele_total(r['tele'], 'pipeline.process.steals')
      runs[workers] = r
      log(f'  18c {fmt}, --num-workers {workers}: {len(r["files"])} files, '
          f'{r["seconds"]:.1f} s in run ({r["wall_seconds"]:.1f} s of '
          f'process), {mb / r["seconds"]:.2f} MB/s of corpus (host CPU of '
          f'the card machine, {os.cpu_count()} cores); parts '
          f'{pool_parts(r["tele"])}; process-phase steals {steals} [{card}]')
    if runs[n]['files'] != runs[1]['files']:
      bad = sorted(set(runs[n]['files'].items()) ^
                   set(runs[1]['files'].items()))[:4]
      raise AssertionError(f'18c {fmt}: {n} workers wrote other files than '
                           f'1: {bad}')
    out[fmt] = {w: {'seconds': r['seconds'], 'wall_seconds': r['wall_seconds'],
                    'mb_per_s': mb / r['seconds'], 'files': len(r['files']),
                    'steals': tele_total(r['tele'], 'pipeline.process.steals'),
                    'parts': pool_parts(r['tele'])}
                for w, r in runs.items()}
    out[fmt]['speedup'] = runs[1]['seconds'] / runs[n]['seconds']
    if fmt == 'bert':
      clean = runs[n]
  # 17c ran the same flags at one worker beside the build: its bytes too.
  if sink_files(os.path.join(bg.root, 'sink_host'))[0] != clean['files']:
    raise AssertionError('18c bert: the pool\'s files are not 17c\'s')
  log(f'  18c: BERT and packed at {n} workers wrote the files of 1, byte for '
      f'byte (BERT\'s also = 17c\'s); speedup {out["bert"]["speedup"]:.2f}x '
      f'/ {out["packed"]["speedup"]:.2f}x [{card}]')
  faults = os.path.join(root, 'faults')
  os.makedirs(faults)
  module, argv = POOL_RUNS['bert']
  argv = [a for a in argv if a not in ('--mask-backend', 'host')]
  r = pool_run(module, argv + ['--mask-backend', 'auto'], bg.corpus, n, root,
               '18c_bert_kill', env=dict(os.environ, LDDL_FAULTS=POOL_FAULT,
                                         LDDL_FAULTS_DIR=faults))
  respawns = tele_total(r['tele'], 'pipeline.pool.respawns')
  replays = tele_total(r['tele'], 'pipeline.pool.replays')
  fired = os.listdir(faults)
  if 'mask=host' not in r['out']:
    raise AssertionError(f'18c: --mask-backend auto at {n} workers did not '
                         f'resolve to host:\n{r["out"][-1500:]}')
  if len(fired) != 1 or respawns != 1:
    raise AssertionError(f'18c: fault markers {fired}, respawns {respawns}; '
                         'want one kill and one respawn')
  if r['files'] != clean['files']:
    raise AssertionError('18c: the run with a killed worker wrote other '
                         'files than the clean run')
  out['kill'] = {'seconds': r['seconds'], 'wall_seconds': r['wall_seconds'],
                 'respawns': respawns, 'replays': replays,
                 'hidden_files': r['hidden'], 'auto': 'host'}
  log(f'  18c: --mask-backend auto at {n} workers resolved to host; with '
      f'{POOL_FAULT} one worker SIGKILLed, {respawns} respawn, {replays} '
      f'task(s) run again for writes the dead worker had not landed, '
      f'{len(r["hidden"])} temporary file(s) it left; the clean run\'s '
      f'files byte for byte, {r["seconds"]:.1f} s in run [{card}]')
  shutil.rmtree(root, ignore_errors=True)
  return out


# Phase 19: the preprocessor's front end and its fleet on the card's
# machine. 19a: synth articles in wikiextractor's format through the
# download CLI's offline step, then the python engine (no masking).
WIKI_CORPUS_MB = 1
WIKI_SHARDS = 4
WIKI_FLAGS = ['--engine', 'python', '--target-seq-length', '128',
              '--bin-size', '64', '--num-blocks', '4']
WIKI_BATCHES, WIKI_BATCH = 2, 16
# 19b/19c: phase 17's corpus and flags over --comm file (the elastic
# executor by default), device masking. The lease timeout is the default;
# the death probe (the dead rank's pid beacon) must revoke far sooner.
ELASTIC_ENV = {'LDDL_LEASE_TIMEOUT': '60', 'LDDL_COMM_HEARTBEAT': '0.2'}
ELASTIC_KILL = 'kill:elastic.task:rank=1,nth=1'
# 19c's kill lands on the third task of the process phase: the scatter
# phase's tasks (one a corpus partition) come first, so nth counts past
# them (the partitions of 17b's run).
ELASTIC_RESUME_NTH = 3


class WikiBackground:
  """Phase 19a's host work, started beside the build with phase 17's and
  18a's (joined with them before the first timed phase): synth articles
  (WIKI_CORPUS_MB MiB from --seed) written as wikiextractor's output,
  ``python -m lddl_tpu_torch.cli download_wikipedia --no-download
  --no-extract``, then ``preprocess_bert_pretrain --engine python`` over
  its source and ``balance_shards``. :meth:`close` removes it."""

  def __init__(self, args):
    import threading
    self.root = tempfile.mkdtemp(prefix='lddl_smoke_wiki_')
    self.balanced = os.path.join(self.root, 'balanced')
    self.started = time.perf_counter()
    self.done = None
    self.result, self.error = {}, None
    self.thread = threading.Thread(target=self._run, args=(args.seed,),
                                   daemon=True)
    self.thread.start()

  def _run(self, seed):
    try:
      wiki = os.path.join(self.root, 'wiki')
      code = ('from lddl_tpu_torch import testing; print(testing.'
              f'write_wikiextractor_source({wiki + "/extracted/en"!r}, '
              f'{seed}, {WIKI_CORPUS_MB << 20}))')
      out, secs = prep_run([sys.executable, '-c', code], dict(os.environ),
                           '19a articles')
      self.result['articles'] = (int(out.split()[-1]), secs)
      cli = 'lddl_tpu_torch.cli'
      out, secs = prep_cli(cli, ['download_wikipedia', '--outdir', wiki,
                                 '--no-download', '--no-extract',
                                 '--num-shards', str(WIKI_SHARDS)],
                           dict(os.environ), '19a download_wikipedia')
      self.result['shard'] = (out.strip().splitlines()[-1], secs)
      sink = os.path.join(self.root, 'sink')
      out, secs = prep_cli(cli, ['preprocess_bert_pretrain', '--wikipedia',
                                 os.path.join(wiki, 'source', 'en'),
                                 '--sink', sink, '--vocab-file', VOCAB_FILE,
                                 '--seed', str(seed), *WIKI_FLAGS],
                           dict(os.environ), '19a preprocess')
      self.result['preprocess'] = (out.strip().splitlines(), secs)
      out, secs = prep_cli(cli, ['balance_shards', '--indir', sink,
                                 '--outdir', self.balanced, '--num-shards',
                                 '2'], dict(os.environ), '19a balance')
      self.result['balance'] = (out.strip().splitlines()[-1], secs)
    except BaseException as e:  # re-raised by join(), on the main thread
      self.error = e
    finally:
      self.done = time.perf_counter()

  def join(self):
    """Wait for it (seconds waited); raise what it raised."""
    t0 = time.perf_counter()
    self.thread.join(PREP_TIMEOUT)
    if self.thread.is_alive():
      raise AssertionError(f'19a: the background run outlived '
                           f'{PREP_TIMEOUT} s')
    if self.error is not None:
      raise self.error
    return time.perf_counter() - t0

  def close(self):
    shutil.rmtree(self.root, ignore_errors=True)


def wiki_python_engine(args, wb, card):
  """19a's check: the articles sharded, the python engine's samples (its
  printed backends: no masking, materialized), and the port's loader
  reading WIKI_BATCHES batches of the balanced output."""
  from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
  from lddl_tpu_torch.tokenization.wordpiece import load_bert_tokenizer
  cls_id = load_bert_tokenizer(VOCAB_FILE).cls_token_id
  waited = wb.join()
  articles, art_s = wb.result['articles']
  shard_line, shard_s = wb.result['shard']
  lines, prep_s = wb.result['preprocess']
  m = re.search(r'sharded (\d+) articles into (\d+) shards', shard_line)
  if not m or int(m.group(1)) != articles or \
      int(m.group(2)) != WIKI_SHARDS:
    raise AssertionError(f'19a: {articles} articles written, the download '
                         f'CLI said: {shard_line!r}')
  p = re.search(r'preprocessed (\d+) samples into (\d+) partitions in '
                r'([0-9.]+)s', lines[-1])
  if not p or 'mask=off format=materialized' not in '\n'.join(lines):
    raise AssertionError(f'19a: the python engine printed {lines[-3:]}')
  samples, run_s = int(p.group(1)), float(p.group(3))
  with open(os.path.join(wb.balanced, '.num_samples.json')) as f:
    balanced = sum(json.load(f).values())
  if balanced != samples:
    raise AssertionError(f'19a: {balanced} samples balanced of {samples}')
  t0 = time.perf_counter()
  loader = get_bert_pretrain_data_loader(
      wb.balanced, vocab_file=VOCAB_FILE, batch_size_per_rank=WIKI_BATCH,
      bin_size=64, max_seq_length=128, masking='dynamic',
      base_seed=args.seed, shuffle_buffer_size=64)
  batches = []
  for batch in loader:
    batches.append(batch)
    if len(batches) == WIKI_BATCHES:
      break
  load_s = time.perf_counter() - t0
  for b in batches:
    ids = b['input_ids']
    if ids.shape[0] != WIKI_BATCH or ids.shape[1] > 128 or \
        not (ids >= 0).all() or not (ids[:, 0] == cls_id).all():
      raise AssertionError(f'19a: a batch of input_ids {ids.shape} '
                           f'{ids[:1, :4]}')
  if len(batches) != WIKI_BATCHES:
    raise AssertionError(f'19a: the loader gave {len(batches)} batches')
  out = {'articles': articles, 'samples': samples, 'run_seconds': run_s,
         'seconds': {'articles': art_s, 'download_wikipedia': shard_s,
                     'preprocess': prep_s, 'balance': wb.result['balance'][1],
                     'load': load_s},
         'done_after_start_s': wb.done - wb.started, 'waited_s': waited,
         'batch_shapes': [list(b['input_ids'].shape) for b in batches]}
  log(f'  19a: {articles} synth articles ({WIKI_CORPUS_MB} MiB, '
      f'wikiextractor\'s format) through python -m lddl_tpu_torch.cli '
      f'download_wikipedia --no-download --no-extract ({shard_s:.1f} s) into '
      f'{WIKI_SHARDS} shards; preprocess_bert_pretrain '
      f'{" ".join(WIKI_FLAGS)}: {samples} samples, {run_s:.1f} s in run '
      f'({prep_s:.1f} s of process); balanced ({wb.result["balance"][1]:.1f} '
      f's); the port\'s loader read {WIKI_BATCHES} batches '
      f'{out["batch_shapes"]} in {load_s:.2f} s; all done '
      f'{out["done_after_start_s"]:.1f} s after the script\'s start, beside '
      f'the build; waited {waited:.1f} s here [{card}]')
  return out


def elastic_env(rdv, run_id, tele, rank=0, world=1, faults=None,
                faults_dir=None):
  """The environment of one ``--comm file`` rank: the rendezvous, the
  lease and heartbeat settings, telemetry on, and a fault spec."""
  env = dict(os.environ, LDDL_COMM_DIR=rdv, LDDL_COMM_RUN_ID=run_id,
             LDDL_RANK=str(rank), LDDL_WORLD_SIZE=str(world),
             LDDL_TELEMETRY='1', LDDL_TELEMETRY_DIR=tele, **ELASTIC_ENV)
  if faults:
    env.update(LDDL_FAULTS=faults, LDDL_FAULTS_DIR=faults_dir or tele)
  return env


def elastic_cmd(corpus, sink):
  return [sys.executable, '-m', 'lddl_tpu_torch.preprocess.bert',
          '--source', corpus, '--sink', sink, '--vocab-file', VOCAB_FILE,
          *PREP_FLAGS, '--comm', 'file']


def run_seconds(out):
  m = re.search(r'preprocessed \d+ samples into \d+ partitions in '
                r'([0-9.]+)s', out)
  return float(m.group(1)) if m else None


def elastic_fleet(card, bg, prep):
  """19b and 19c over phase 17b's corpus, against 17b's files."""
  root = tempfile.mkdtemp(prefix='lddl_smoke_elastic_', dir=bg.root)
  want, _ = sink_files(os.path.join(bg.root, 'sink_device'))
  parts = prep['path']['device']['partitions']
  out = {'fleet': killed_rank(card, bg.corpus, root, want, parts),
         'resume': killed_and_resumed(card, bg.corpus, root, want, parts)}
  shutil.rmtree(root, ignore_errors=True)
  return out


def killed_rank(card, corpus, root, want, parts):
  """19b: 17b's run as two ``--comm file`` ranks, rank 1 SIGKILLed at its
  first task: rank 0 revokes its lease through the death probe, runs
  every partition in well under the lease timeout with an M1 launch each,
  and writes ``want`` (17b's files)."""
  rdv, sink = os.path.join(root, 'rdv_b'), os.path.join(root, 'sink_b')
  procs = []
  t0 = time.perf_counter()
  for rank in (0, 1):
    tele = os.path.join(root, f'tele_b{rank}')
    env = elastic_env(rdv, 'fleet', tele, rank, 2,
                      ELASTIC_KILL if rank else None)
    procs.append(prep_start(elastic_cmd(corpus, sink), env))
  rc1, _, err1 = stopped(procs[1])
  rc0, out0, err0 = stopped(procs[0])
  wall = time.perf_counter() - t0
  if rc1 != -9:
    raise AssertionError(f'19b: rank 1 exited {rc1}, not by SIGKILL:\n'
                         f'{err1[-2000:]}')
  if rc0:
    raise AssertionError(f'19b: rank 0 exited {rc0}:\n{out0[-1500:]}\n'
                         f'{err0[-3000:]}')
  run_s = run_seconds(out0)
  tl = telemetry_lines(os.path.join(root, 'tele_b0'))
  tasks = tele_total(tl, 'pipeline.process.tasks')
  launches = tele_total(tl, 'preprocess.mask_kernel_launches')
  revokes = tele_total(tl, 'pipeline.elastic.revokes')
  lease_timeout = float(ELASTIC_ENV['LDDL_LEASE_TIMEOUT'])
  if tasks != parts or launches < tasks or revokes < 1:
    raise AssertionError(f'19b: rank 0 ran {tasks} of {parts} partitions, '
                         f'{launches} M1 launches, {revokes} revocations')
  if run_s is None or 'mask=device' not in out0 or \
      run_s > lease_timeout / 2:
    raise AssertionError(f'19b: rank 0 took {run_s} s in run (the lease '
                         f'timeout is {lease_timeout:.0f} s):\n{out0[-1500:]}')
  files, hidden = sink_files(sink)
  if files != want:
    bad = sorted(set(files.items()) ^ set(want.items()))[:4]
    raise AssertionError(f'19b: the survivor\'s shards are not 17b\'s: {bad}')
  out = {'rank1_exit': rc1, 'partitions': tasks,
         'scatter_tasks': tele_total(tl, 'pipeline.scatter.tasks'),
         'mask_launches': launches, 'revokes': revokes,
         'reexecutions': tele_total(tl, 'pipeline.elastic.reexecutions'),
         'run_seconds': run_s, 'wall_seconds': wall, 'hidden_files': hidden}
  log(f'  19b: two --comm file ranks of python -m '
      f'lddl_tpu_torch.preprocess.bert {" ".join(PREP_FLAGS)} (device '
      f'masking) on 17b\'s corpus, {ELASTIC_KILL}: rank 1 SIGKILLed; rank 0 '
      f'revoked {revokes} lease(s) through the death probe, ran every '
      f'scatter task ({out["scatter_tasks"]}) and all {tasks} '
      f'partitions with {launches} M1 launches, {run_s:.1f} s in run (lease '
      f'timeout {lease_timeout:.0f} s), {wall:.1f} s of processes; its '
      f'{len(files)} files = 17b\'s, byte for byte [{card}]')
  return out


def killed_and_resumed(card, corpus, root, want, parts):
  """19c: one ``--comm file`` rank SIGKILLed at the third task of the
  process phase, then restarted with the same run id: the partitions
  manifested before the kill keep their files' inode and mtime,
  resume_skipped counts every manifest the kill left, the rest run again,
  and the files are ``want`` (17b's)."""
  rdv, sink = os.path.join(root, 'rdv_c'), os.path.join(root, 'sink_c')
  faults = os.path.join(root, 'faults_c')
  os.makedirs(faults)
  spec = f'kill:elastic.task:nth={parts + ELASTIC_RESUME_NTH},once'

  def run(tele):
    t0 = time.perf_counter()
    rc, o, e = stopped(prep_start(
        elastic_cmd(corpus, sink),
        elastic_env(rdv, 'resume', tele, faults=spec, faults_dir=faults)))
    return rc, o, e, time.perf_counter() - t0

  rc, _, e, killed_s = run(os.path.join(root, 'tele_c0'))
  if rc != -9:
    raise AssertionError(f'19c: the first run exited {rc}, not by '
                         f'SIGKILL:\n{e[-2000:]}')
  manifests = {ph: sorted(int(n[5:]) for n in os.listdir(os.path.join(
      rdv, f'resume.elastic.{ph}.0')) if n.startswith('done.'))
               for ph in ('scatter', 'process')}
  kept = {n: (st.st_ino, st.st_mtime_ns)
          for gi in manifests['process']
          for n in [f'part.{gi}.parquet_{b}'
                    for b in range(PREP_SEQ // PREP_BIN)]
          for st in [os.stat(os.path.join(sink, n))]}
  tele = os.path.join(root, 'tele_c1')
  rc, o, e, wall2 = run(tele)
  if rc:
    raise AssertionError(f'19c: the restart exited {rc}:\n{o[-1500:]}\n'
                         f'{e[-3000:]}')
  manifested = len(manifests['scatter']) + len(manifests['process'])
  if len(manifests['scatter']) != parts or not manifests['process'] or \
      len(manifests['process']) >= parts or run_seconds(o) is None:
    raise AssertionError(f'19c: manifests at the kill {manifests}')
  tl = telemetry_lines(tele)
  skipped = tele_total(tl, 'pipeline.elastic.resume_skipped')
  tasks = tele_total(tl, 'pipeline.process.tasks')
  launches = tele_total(tl, 'preprocess.mask_kernel_launches')
  if skipped != manifested or tasks != parts - len(manifests['process']) \
      or launches < tasks:
    raise AssertionError(f'19c: resume_skipped {skipped} of {manifested} '
                         f'manifests, {tasks} partitions run again, '
                         f'{launches} M1 launches')
  for n, stat in kept.items():
    st = os.stat(os.path.join(sink, n))
    if (st.st_ino, st.st_mtime_ns) != stat:
      raise AssertionError(f'19c: {n} was manifested before the kill and '
                           'rewritten by the restart')
  files, hidden = sink_files(sink)
  if files != want:
    bad = sorted(set(files.items()) ^ set(want.items()))[:4]
    raise AssertionError(f'19c: the resumed shards are not 17b\'s: {bad}')
  out = {'spec': spec, 'manifests_at_kill': manifests,
         'resume_skipped': skipped, 'partitions_rerun': tasks,
         'mask_launches': launches, 'killed_wall_seconds': killed_s,
         'run_seconds': run_seconds(o), 'wall_seconds': wall2,
         'hidden_files': hidden}
  log(f'  19c: one --comm file rank (elastic by default), {spec}: killed '
      f'with {len(manifests["scatter"])} scatter and '
      f'{len(manifests["process"])} process manifests '
      f'({killed_s:.1f} s); restarted with the same run id: '
      f'resume_skipped {skipped}, {tasks} partitions run again with '
      f'{launches} M1 launches, {run_seconds(o):.1f} s in run ({wall2:.1f} s '
      f'of process); the {len(kept)} manifested files kept their inode and '
      f'mtime; {len(files)} files = 17b\'s, byte for byte [{card}]')
  return out



# Phase 20: the port's static analyzer on the card's machine. The
# suppressions it reports over lddl_tpu_torch/ (rule, file, the definition
# its message names), as tests/test_torch_analysis_self.py pins them.
ANALYZE_SUPPRESSED = (
    ('LDA011', 'lddl_tpu_torch/parallel/train.py',
     'TensorReplicas.__call__()'),
    ('LDA011', 'lddl_tpu_torch/parallel/train.py',
     'ShardedDataParallel.grads()'),
)
# Workers of each run's per-file pass: the build and phases 17-19's host
# work share the host's cores meanwhile.
ANALYZE_JOBS = '2'
# 20a's planted package: one torch spelling per file, by the rule that
# must name it.
ANALYZE_PLANTED = {
    'collective.py': ('LDA005', (
        'import torch.distributed as dist\n\n\n'
        'def step(rank, t):\n'
        '  if rank == 0:\n'
        '    dist.all_reduce(t)\n')),
    'captured.py': ('LDA010', (
        'from lddl_tpu_torch.parallel.train import capture_step\n\n\n'
        'def _body(t):\n'
        '  return t.cpu()\n\n\n'
        'def step(stream, t):\n'
        '  return capture_step(stream, lambda: t, lambda: _body(t), [],\n'
        '                      "a step")\n')),
    'draw.py': ('LDA002', (
        'import torch\n\n\n'
        'def init():\n'
        '  return torch.rand(3)\n')),
}
# ``lddl_analyze`` through the port's command table, then the modules of
# lddl_tpu, torch and jax the process loaded (stderr's last line).
ANALYZE_PROBE = (
    'import json, sys\n'
    'from lddl_tpu_torch.cli import main\n'
    'rc = main(["lddl_analyze", *sys.argv[1:]])\n'
    'print("loaded " + json.dumps(sorted(m for m in sys.modules if '
    'm.split(".")[0] in ("lddl_tpu", "torch", "jax"))), file=sys.stderr)\n'
    'sys.exit(rc)\n')


class AnalyzeBackground:
  """Phase 20a, host only, started beside the build with phases 17-19's
  host work (joined with them before the first timed phase): ``python -m
  lddl_tpu_torch.cli lddl_analyze --format json`` over lddl_tpu_torch/;
  a cold and a warm run over a fresh ``LDDL_ANALYZE_CACHE``; the planted
  package (ANALYZE_PLANTED); ``--format sarif``. :attr:`cache` stays
  warm for 11g's gate until :meth:`close`."""

  def __init__(self):
    import threading
    self.root = tempfile.mkdtemp(prefix='lddl_smoke_analyze_')
    self.cache = os.path.join(self.root, 'cache')
    self.started = time.perf_counter()
    self.done = None
    self.result, self.error = {}, None
    self.thread = threading.Thread(target=self._run, daemon=True)
    self.thread.start()

  @staticmethod
  def _analyze(argv, env, probe=True):
    cmd = ([sys.executable, '-c', ANALYZE_PROBE, *argv] if probe else
           [sys.executable, '-m', 'lddl_tpu_torch.cli', 'lddl_analyze',
            *argv])
    t0 = time.perf_counter()
    rc, out, err = stopped(prep_start(cmd, env))
    return rc, out, err, time.perf_counter() - t0

  def _run(self):
    try:
      env = {k: v for k, v in os.environ.items()
             if k != 'LDDL_ANALYZE_CACHE'}
      env['LDDL_ANALYZE_JOBS'] = ANALYZE_JOBS
      self.result['plain'] = self._analyze(
          ['--format', 'json', 'lddl_tpu_torch'], env, probe=False)
      # The installed tree's absolute path, as the perf gate lints it, so
      # 11g's gate reads this cache warm.
      tree = os.path.join(HERE, 'lddl_tpu_torch')
      cached = dict(env, LDDL_ANALYZE_CACHE=self.cache)
      for run in ('cold', 'warm'):
        self.result[run] = self._analyze(['--format', 'json', tree], cached)
      planted = os.path.join(self.root, 'planted')
      os.makedirs(planted)
      for name, (_, src) in [('__init__.py', ('', '')),
                             *ANALYZE_PLANTED.items()]:
        with open(os.path.join(planted, name), 'w') as f:
          f.write(src)
      self.result['planted'] = self._analyze(['--format', 'json', planted],
                                             env)
      self.result['sarif'] = self._analyze(['--format', 'sarif', tree],
                                           cached)
    except BaseException as e:  # re-raised by join(), on the main thread
      self.error = e
    finally:
      self.done = time.perf_counter()

  def join(self):
    """Wait for it (seconds waited); raise what it raised."""
    t0 = time.perf_counter()
    self.thread.join(PREP_TIMEOUT)
    if self.thread.is_alive():
      raise AssertionError(f'20a: the analyzer runs outlived '
                           f'{PREP_TIMEOUT} s')
    if self.error is not None:
      raise self.error
    return time.perf_counter() - t0

  def close(self):
    shutil.rmtree(self.root, ignore_errors=True)


def _analyzer_doc(label, run, want_rc, probe=True):
  """The JSON document of one 20a run, its exit code checked, and (a
  probed run) that its process loaded nothing of lddl_tpu, torch or
  jax."""
  rc, out, err, _ = run
  if rc != want_rc:
    raise AssertionError(f'20a: lddl_analyze ({label}) exited {rc}, not '
                         f'{want_rc}:\n{out[-3000:]}\n{err[-3000:]}')
  if probe:
    last = (err.strip().splitlines() or [''])[-1]
    if not last.startswith('loaded ') or json.loads(last[7:]):
      raise AssertionError(f'20a: the analyzer\'s process ({label}): '
                           f'{last!r}')
  return json.loads(out)


def static_analysis(ab, card):
  """20a's checks, from the runs ``ab`` made beside the build: the tree
  clean with exactly ANALYZE_SUPPRESSED, cold and warm runs equal with
  their seconds, every planted spelling named, the SARIF document, and no
  module of lddl_tpu (nor torch, nor jax) in the probed processes."""
  waited = ab.join()
  doc = _analyzer_doc('python -m, JSON', ab.result['plain'], 0, probe=False)
  suppressed = [(f['rule'], f['path'], f['message']) for f in doc['findings']
                if f['suppressed']]
  got = [(r, p[p.index('lddl_tpu_torch/'):]) for r, p, _ in suppressed]
  if (not doc['clean'] or doc['num_findings'] or doc['mode'] != 'project'
      or got != [(r, p) for r, p, _ in ANALYZE_SUPPRESSED]
      or not all(name in m for (_, _, name), (_, _, m) in
                 zip(ANALYZE_SUPPRESSED, suppressed))):
    raise AssertionError(f'20a: lddl_analyze over lddl_tpu_torch/: '
                         f'{doc["num_findings"]} unsuppressed, suppressed '
                         f'{suppressed}')
  cold = _analyzer_doc('cold cache', ab.result['cold'], 0)
  warm = _analyzer_doc('warm cache', ab.result['warm'], 0)
  if cold != warm or cold['num_suppressed'] != len(ANALYZE_SUPPRESSED):
    raise AssertionError('20a: the warm run\'s document is not the cold '
                         'run\'s')
  planted = _analyzer_doc('planted', ab.result['planted'], 1)
  named = sorted((os.path.basename(f['path']), f['rule'])
                 for f in planted['findings'] if not f['suppressed'])
  want = sorted((name, rule) for name, (rule, _) in ANALYZE_PLANTED.items())
  if named != want:
    raise AssertionError(f'20a: the planted package gave {named}, not '
                         f'{want}')
  sarif = _analyzer_doc('SARIF', ab.result['sarif'], 0)
  results = sarif['runs'][0]['results']
  if sarif['version'] != '2.1.0' or len(results) != len(
      ANALYZE_SUPPRESSED) or any(r.get('suppressions') != [
          {'kind': 'inSource'}] for r in results):
    raise AssertionError(f'20a: the SARIF document: {sarif["version"]}, '
                         f'{len(results)} results')
  seconds = {k: round(v[3], 2) for k, v in ab.result.items()}
  log(f'  20a: python -m lddl_tpu_torch.cli lddl_analyze over '
      f'lddl_tpu_torch/: exit 0, {doc["files_scanned"]} files, 0 '
      f'unsuppressed, {len(suppressed)} suppressed '
      f'({", ".join(n for _, _, n in ANALYZE_SUPPRESSED)}); '
      f'{seconds["plain"]:.2f} s; over LDDL_ANALYZE_CACHE cold '
      f'{seconds["cold"]:.2f} s, warm {seconds["warm"]:.2f} s, the same '
      f'document; the planted package exit 1 naming {named}; SARIF '
      f'{sarif["version"]} with {len(results)} suppressed results; no '
      f'module of lddl_tpu, torch or jax in the probed processes; '
      f'LDDL_ANALYZE_JOBS={ANALYZE_JOBS}; done '
      f'{ab.done - ab.started:.1f} s after the script\'s start, waited '
      f'{waited:.1f} s here [{card}]')
  return {'files': doc['files_scanned'], 'suppressed': got,
          'seconds': seconds, 'planted': named, 'waited': waited,
          'done_after': ab.done - ab.started, 'jobs': int(ANALYZE_JOBS)}


def main():
  global PLACE_LAYOUTS, RING_CELLS
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--steps', type=int, default=10,
                      help='timed steps per bin')
  parser.add_argument('--warmup', type=int, default=3,
                      help='untimed steps per bin before the timed ones')
  parser.add_argument('--max-predictions', type=int, default=112,
                      help='masked-only MLM head budget (covers dynamic '
                      'masking at s=512)')
  parser.add_argument('--packed-steps', type=int, default=5,
                      help='timed packed s=8192 steps')
  parser.add_argument('--packed-warmup', type=int, default=2,
                      help='untimed packed steps before the timed ones')
  parser.add_argument('--rank-task', choices=sorted(RANK_TASKS),
                      help="the rank processes of phases 9, 14, 15 and 16 "
                      '(the script starts them itself)')
  parser.add_argument('--out', help='--rank-task: where it writes')
  parser.add_argument('--ckpt', help='--rank-task: the checkpoint dir')
  parser.add_argument('--fault', choices=sorted(PLACE_FAULTS) +
                      list(RING_FAULTS),
                      help='--rank-task 14: the fault to plant')
  parser.add_argument('--only', choices=('14', '15b'),
                      help='--rank-task 14: run phase 14 (14a, 14b) or 15b '
                      'alone')
  parser.add_argument('--ring-faults', action='store_true',
                      help="read 15b's gaps to world 1 under planted "
                      'faults (the limits\' calibration); runs nothing '
                      'else')
  parser.add_argument('--place-faults', action='store_true',
                      help="read phase 14's gaps to world 1 under planted "
                      'faults (the limits\' calibration); runs nothing '
                      'else')
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; nothing to check', file=sys.stderr)
    return 2
  if args.rank_task:
    if args.only == '15b':
      PLACE_LAYOUTS = ()
    elif args.only == '14':
      RING_CELLS = ()
    if args.fault:
      plant_fault(args.fault)
    RANK_TASKS[args.rank_task](args, load_digests())
    return 0
  from lddl_tpu_torch.ops import _build
  from lddl_tpu_torch.ops import flash_attention as tfa

  card = card_line()
  log(f'card: {card}')
  # Phase 17's host-only work (a corpus, a preprocess on the host) runs
  # beside the build, which leaves the host's cores idle.
  prep_bg = formats_bg = wiki_bg = analyze_bg = None
  if not (args.place_faults or args.ring_faults):
    prep_bg = PrepBackground(args)
    atexit.register(prep_bg.close)
    formats_bg = FormatsBackground(load_digests())
    atexit.register(formats_bg.close)
    wiki_bg = WikiBackground(args)
    atexit.register(wiki_bg.close)
    analyze_bg = AnalyzeBackground()
    atexit.register(analyze_bg.close)
  log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
      f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  log('== build')
  t0 = time.perf_counter()
  _build.build_all()  # the flash and masking libraries' nvcc together
  log(f'  kernels loaded in {time.perf_counter() - t0:.1f}s from '
      f'{_build.library_path()} and {_build.masking_library_path()}')
  mask_ptxas = {}
  if _build.masking_build_info['log'] is not None:
    log(f'  masking.cu: nvcc took {_build.masking_build_info["seconds"]:.1f}'
        's; ptxas:')
    mask_ptxas = masking_ptxas_report(_build.masking_build_info['log'])
  if args.place_faults:
    place_faults(args, card)
    return 0
  if args.ring_faults:
    ring_faults(args, card)
    return 0
  ptxas = {}
  if _build.build_info['log'] is not None:
    log(f'  nvcc took {_build.build_info["seconds"]:.1f}s; ptxas:')
    ptxas = ptxas_report(_build.build_info['log'])
  # Phase 17's host work ends here, before the first timed phase (K1-K4's
  # CUDA-event times): no host process of it runs beside a timing.
  log(f'  (phase 17\'s corpus and host preprocess, started beside the '
      f'build: waited {prep_bg.join():.1f} s for them here)')
  digests = load_digests()
  log('== 18a: the committed packed/, codebert/ and bart/ sets, remade by the '
      'port\'s preprocessors beside the build [' + card + ']')
  formats = {'rebuilt': formats_rebuilt(digests, formats_bg, card)}
  log('== 19a: download_wikipedia\'s offline step and the python engine, '
      'beside the build [' + card + ']')
  fleet = {'wiki': wiki_python_engine(args, wiki_bg, card)}
  wiki_bg.close()
  log('== 20a: the static analyzer over lddl_tpu_torch/, beside the build '
      '[' + card + ']')
  analysis = static_analysis(analyze_bg, card)

  log('== kernels vs plain versions [' + card + ']')
  cases = []
  for dtype in (torch.float32, torch.bfloat16):
    # The training bins' shapes (BERT-base heads), a ragged length, and
    # the other two head dims the kernels take.
    cases += [(b, 12, s, 64, dtype) for s, b in BINS]
    cases += [(*shape, dtype) for shape in EXTRA_CASES]
  rows = check_kernels(tfa, cases, args.seed)

  log('== segmented kernels (K4) vs plain versions [' + card + ']')
  rows += check_seg_kernels(tfa, SEG_CASES, args.seed)
  torch.cuda.empty_cache()

  log('== training BERT-base, flash attention, bf16 [' + card + ']')
  per_bin, counts = train(args, card)
  torch.cuda.empty_cache()

  log(f'== packed long-context training, BERT-base s={PACKED[0]}, '
      f'block-diagonal, bf16 [{card}]')
  packed, seg_counts = train_packed(args, card)
  counts.update({k: v for k, v in seg_counts.items() if k.endswith('_seg')})
  torch.cuda.empty_cache()

  log(f'== 21: BertConfig.ablate at BERT-base width, phase 5\'s bins '
      f'[{card}]')
  ablated = ablations(args, card, per_bin)
  torch.cuda.empty_cache()

  log('== training from shards: the corpus loader [' + card + ']')
  shards = {'loader': loader_alone(digests, card)}
  shards['pairs'] = train_from_shards(args, digests, card)
  shards['packed'] = train_packed_from_shards(
      args, digests, card, path=formats_bg.sets['packed'])
  shards['cli'] = cli_from_shards(digests, card)
  check_no_segments('phase 7')

  log(f'== training from shards through {WORKERS} loader worker processes '
      f'[{card}]')
  workers = {'loader': loader_through_workers(digests, card)}
  workers['pairs'] = train_through_workers(args, digests, card)
  workers['packed'] = train_packed_from_shards(args, digests, card,
                                               workers=WORKERS)
  check_no_segments('8c')
  workers['ledger'] = ledger_on_card(args, digests, card)
  workers['codebert'] = codebert_through_workers(
      args, digests, card, path=formats_bg.sets['codebert'])
  workers['kill'] = kill_a_worker(digests, card)

  ranks_root = tempfile.mkdtemp(prefix='lddl_smoke_ranks_')
  log(f'== data-parallel training across processes, in the rank processes '
      f'phases 14, 15 and 16 share [{card}]')
  worlds = rank_worlds(args, ranks_root)
  dp = data_parallel(args, digests, shards['cli'], shards['pairs'], card,
                     worlds)
  for done in ('ckpt_9b', 'ckpt_14a'):  # resumed in 14c's process
    shutil.rmtree(os.path.join(ranks_root, done))

  log(f'== the network data service and the live monitor [{card}]')
  served = data_service(args, digests, card)

  replay_root = tempfile.mkdtemp(prefix='lddl_smoke_replay_')
  try:
    log(f'== the ledger\'s step record, step replay and the flight '
        f'recorder [{card}]')
    replayed, rec, resumed = record_and_replay(args, digests, replay_root,
                                               card)

    log(f'== the K-step scan window as one CUDA graph [{card}]')
    history = os.path.join(replay_root, 'bench', 'bench_history.jsonl')
    scanned = scan_window(args, card, history)

    log(f'== phase 11, the gate and the trace CLI over phases 11 and 12 '
        f'[{card}]')
    replayed['gate'] = gate_and_trace(digests, rec, resumed, history, card,
                                      analyze_bg.cache)
    analyze_bg.close()
  finally:
    shutil.rmtree(replay_root, ignore_errors=True)

  log(f'== the BART text-infilling loader and its native WordPiece encoder '
      f'[{card}]')
  bart = bart_on_card(digests, card)

  log(f'== ring attention: the kernels on a ring\'s inputs (15a) [{card}]')
  ring_rows = ring_kernels(tfa, args.seed, card)
  torch.cuda.empty_cache()

  log(f'== parameter placement over the fsdp and tensor axes (14) and ring '
      f'attention over the seq axis (15b, 15c): two ranks on '
      f'the card [{card}]')
  placed = placement(args, digests, card, worlds)

  log(f'== step replay of a sharded run, launched as its ranks (16) '
      f'[{card}]')
  try:
    sharded = sharded_replay(args, card, worlds, ranks_root)
  finally:
    shutil.rmtree(ranks_root, ignore_errors=True)

  log(f'== preprocessing on the card: the masking kernels (17a), the '
      f'preprocessor, the balancer and training from their shards (17b-e) '
      f'[{card}]')
  try:
    prep = preprocessing(args, card, prep_bg)
    log(f'== 18c: the preprocessors through the local worker pool, nothing '
        f'else running [{card}]')
    formats['pool'] = pool_runs(card, prep_bg)
    log(f'== 19b-c: the elastic executor: a killed rank of two, a killed '
        f'and resumed run, over --comm file [{card}]')
    fleet.update(elastic_fleet(card, prep_bg, prep))
  finally:
    prep_bg.close()
    formats_bg.close()
  formats['trained'] = {'packed_7c': shards['packed']['launches'],
                        'codebert_8e': workers['codebert']['launches']}

  profiled = {'': per_bin[1]['profile']['flash_calls_per_step'],
              '_seg': packed['profile']['flash_calls_per_step']}
  # Each kernel at the shape of the training phase that runs it, bf16.
  main_shape = {'': [BINS[1][1], 12, BINS[1][0], 64],
                '_seg': list(SEG_CASES[0][:4])}
  summary = []
  for name in ('fwd', 'dq', 'dkv', 'fwd_seg', 'dq_seg', 'dkv_seg'):
    seg = name[-4:] if name.endswith('_seg') else ''
    r = next(x for x in rows if x['name'] == name and
             x['shape'] == main_shape[seg] and
             x['dtype'] == str(torch.bfloat16))
    entry = {
        'name': f'flash_{name}', 'route': 'cuda', 'source': KERNEL_SOURCE,
        'replaces': TPU_KERNELS[name], 'launches': counts[name],
        'launches_counted_by': 'the kernel itself, on the device, over the '
                               'main path (CUDA graph replays included)',
        'profiled_calls_per_step': profiled[seg].get(name),
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
        'shape': r['shape'], 'dtype': r['dtype'], 'body': r['body'],
        'library': ('scaled_dot_product_attention forward' if
                    name.startswith('fwd') else
                    'scaled_dot_product_attention backward (dq, dk and dv '
                    'together)') + (' with the [b, 1, s, s] block-diagonal '
                                    'mask' if seg else '') +
                   ', pinned to SDPBackend.EFFICIENT_ATTENTION'}
    entry.update(ptxas.get((name, r['body']), {}))
    entry['phase9_launches'] = {
        'world1_nccl': dp['world1']['launches'][name],
        'world2_gloo_per_rank': [x[name] for x in
                                 dp['world2']['launches_per_rank']]}
    entry['phase10_launches'] = served['launches'][name]
    entry['phase11_launches'] = {
        'record': replayed['launches'][name],
        'resumed': replayed['resumed_launches'][name],
        'replays': [x[name] for x in replayed['replay_launches']]}
    entry['phase12_launches_per_window'] = {
        label: c['window_launches'][name] for label, c in scanned.items()}
    entry['phase14_launches_per_rank'] = {
        label: [x[name] for x in placed[label]['launches_per_rank']]
        for label, _ in PLACE_LAYOUTS}
    entry['phase14_launches_resumed'] = placed['14c']['launches'][name]
    entry['phase15_launches_per_rank'] = {
        label: [x[name] for x in placed['15b'][label]['launches_per_rank']]
        for label, *_ in RING_CELLS}
    entry['phase15_launches_captured'] = placed['15c']['launches'][name]
    entry['phase18b_launches'] = {
        'packed_7c': shards['packed']['launches'][name],
        'codebert_8e': workers['codebert']['launches'][name]}
    entry['phase16_launches_per_rank'] = {
        job: r['launches_per_rank'][0][name]
        for job, r in sharded['jobs'].items()}
    entry['phase21_launches'] = {a['ablate']: a['launches'][name]
                                 for a in ablated}
    ring = next(x for x in ring_rows if x['name'] == name)
    entry['phase15a'] = {k: ring[k] for k in (
        'shape', 'max_abs_err', 'tol', 'bound_use', 'rel_norm_err', 'ms',
        'plain_ms')}
    if seg:
      entry.update(skip_fraction=r['skip_fraction'],
                   segment_free_ms=r['segment_free_ms'],
                   intervals_ms=r['intervals_ms'])
    summary.append(entry)
  for name, replaces in MASK_REPLACES.items():
    # Timed on the rows of one of 17b's launches: the main path's load.
    r = next(x for x in prep['kernels']['rows'] if x['name'] == name and
             x['rows'] == '17b partition 0')
    summary.append({
        'name': name, 'route': 'cuda', 'source': MASK_SOURCE,
        'replaces': replaces,
        'launches': (prep['path']['device']['launches']
                     if name == 'mask_partition' else
                     prep['kernels']['mask_matrix_launches']),
        'launches_counted_by': (
            "the wrapper, in the preprocessor's process (its telemetry "
            'export), one a partition (17b)' if name == 'mask_partition'
            else "the wrapper, over mask_batch(backend='device') (17a)"),
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': None,
        'plain': 'the jit program as torch ops (argsort of the argsort), '
                 'on the card: the yardstick too',
        'valid_share': r['valid_share'],
        'shape': r['shape'], 'dtype': 'int32',
        'wrapper_ms': r['wrapper_ms'],
        'timed_by': 'launches alone: CUDA graph replays of the wrapper '
                    '(kernel_ab.launches_ms)'})
    summary[-1].update(mask_ptxas.get(name, {}))
    if 'call_ms' in r:
      summary[-1]['mask_partition_device_ms'] = r['call_ms']
    if name == 'mask_partition':
      summary[-1]['phase19_launches'] = {
          '19b_survivor': fleet['fleet']['mask_launches'],
          '19c_restart': fleet['resume']['mask_launches']}
  log(json.dumps({'training': [{k: v for k, v in b.items() if k != 'losses'}
                               for b in per_bin],
                  'packed': {k: v for k, v in packed.items()
                             if k != 'losses'},
                  'shards': {k: ({kk: vv for kk, vv in v.items()
                                  if kk != 'losses'} if k != 'cli' else v)
                             for k, v in shards.items()},
                  'workers': {k: ({kk: vv for kk, vv in v.items()
                                   if kk != 'losses'})
                              for k, v in workers.items()},
                  'data_parallel': dp,
                  'data_service': {k: v for k, v in served.items()
                                   if k != 'losses'},
                  'record_and_replay': replayed,
                  'scan_window': scanned, 'bart': bart,
                  'placement': placed, 'sharded_replay': sharded,
                  'preprocessing': {k: v for k, v in prep.items()},
                  'formats': formats, 'fleet': fleet,
                  'static_analysis': analysis, 'ablations': ablated,
                  'card': card},
                 default=str))
  log(f'phase seconds: {json.dumps(phase_seconds())}')
  log(json.dumps({'kernels': summary}))
  log(card)
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
