#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``distributed_embeddings_torch``) on one
NVIDIA H100.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``distributed_embeddings_torch/
csrc/`` and drives the port's paths on the card: DLRM serving on
frozen tables, and the README's serving snippet (export the artifact,
load it, serve it, a ``MicroBatcher`` in front; world 1 and world 4), the
world-1 sparse train step of ``bench.py``, the dense-autodiff train step
of the README's Quick start (world 1 and world 4) and its "Train
end-to-end" command (``examples/dlrm/main_torch.py``, the port's twin of
``examples/dlrm/main.py``), the synthetic zoo's Tiny train step of
``tools/bench_synthetic.py tiny 65536``, the world-4 hybrid-parallel
train step of ``examples/dlrm/main.py --sparse`` under
``overlap='fused'``, and the README's wire compression on it
(``dedup_exchange``, ``dedup_capacity``, the bf16 and fp8 wires),
column-sliced tables at world 4, and the README Quick start's last
command (``examples/benchmarks/synthetic_models/main_torch.py``, the
zoo's dense-autodiff step) with the zoo harness at world 4 and the
lookup microbenchmark (``examples/benchmarks/benchmark_torch.py``). One
JSON line per phase:

1. ``device``: the card (``nvidia-smi`` name and power limit), which
   must have compute capability (9, 0);
2. ``build``: every kernel compiled with ``nvcc`` for ``sm_90a``; a
   row per kernel with each entry function's registers, static shared
   memory and spills from ``ptxas -v``;
3. ``kernel``: each kernel against its plain PyTorch version at the
   main paths' shapes. K2-fwd (``interact_fwd``) and K2-bwd
   (``interact_bwd``) at F=27, D=128, k in {-1, 0}, B in {4096, 65536,
   4000}: at least 99.9% of the cells bit-equal, every cell within one
   bf16 ulp or, where its terms cancel, within the f32 summation bound
   (K2-fwd: ``D * 2^-24 * sum_d |x_p[d] x_q[d]|``, its tensor-core sums
   rounding otherwise than the plain version's; K2-bwd: ``F * 2^-24 *
   sum_q |c_pq x_q|``); the K2-fwd launcher's geometry read back and
   held to ``cuda_interact.fwd_geometry``. K1 (``apply_rows``)
   on the buffer of the train plan's first sparse class (4,991,510 x 128
   f32) with 131,072 ids per stream, scale -0.1 (SGD's -lr): uniform,
   power-law and 17% out-of-range streams within 1e-5 of each cell's
   absolute sum (duplicates add in another order), a stream of unique ids
   bit-equal. K4 (``gather_rows``) on the first sparse class's rank
   buffer of the four-card world-4 plan (9,994,943 x 128 f32), one
   (round, chunk) block of 8,192 int32 ids, uniform and with 30% of the
   ids out of range or sentinels: bit-equal, the uniform stream timed
   beside four yardsticks (the ids mapped into a 65,536-row buffer, the
   ids sorted, an empty kernel of the kernel's grid, a contiguous copy
   of the same rows); so are blocks of 1, 31 and 8,193 ids, one of 8,192
   ids of one row, and fused strides of 96, 65 and 256 lanes on a small
   buffer. K6 (``build_delta_rows``, Adagrad
   0.01) at the two buckets of Tiny's largest class: 786,432 one-hot
   samples with 32-lane state rows, and 65,536 ten-hot samples with
   window-masked 128-lane state rows; then momentum, Adam and a width-8
   class on 4,096-sample streams: within rtol 1e-6, atol 2e-7; and on
   the column-sliced narrow layouts of ``world4_colslice`` (2 and 4
   lanes, 16-32 rows a physical row with Adagrad's state), one-hot and
   ten-hot streams of 65,536 samples of power-law ids (K1 there too,
   under SGD with 32-64 rows a physical row and under Adagrad, the
   duplicate tolerance of the other K1 streams). K7
   (``row_major``) on views of the [12, 65536, 16] cotangent, each
   bit-equal and timed, with the path the wrapper chose: transposed (f32
   and bf16) and sliced (vector path), last two dimensions transposed
   (f32 and bf16; tile path), an innermost stride-0 broadcast (general
   path). K2-fwd, K2-bwd, K3-fwd and K3-bwd also at the edge shapes F in
   {1, 2, 13, 32} x D in {8, 16, 64, 256}, B=1000, both k, in their
   class. K3-fwd
   (``interact_flat_fwd``) and K3-bwd (``interact_flat_bwd``), the flat
   ``[B, F, D]`` forms no path launches, at F=27, D=128, k in {-1, 0},
   B in {4096, 65536}, in K2's tolerance classes. K5
   (``gather_send_rows``, no path launches it either) at K4's block
   shape, bit-equal: a loopback round on the first card and, with two or
   more cards, the rotate-by-k rounds across them (peer pushes), timed
   against the peer link's rate measured by a 1 GiB ``copy_``. Times
   are medians of
   CUDA-event timings of single calls, kernel, plain and library in
   turns, with the 50 MB L2 flushed and the card held busy while the
   host queues each call, after two seconds of warm-up. Then the wire
   compression's plain PyTorch pieces: ``fp8_codec``, the fp8 block
   codec on the card bit-equal to the CPU's (encoded bytes and decoded
   values of blocks with an all-zero block and one whose amax maps onto
   448, the e4m3 cast of the edge values), the encode and decode of one
   four-card world-4 payload timed; ``unique_map``, ``unique_ids_map``
   (safe and capped capacity) and ``expand_unique_rows`` at the one-card
   world-4 cell's block under ``torch.cuda.set_sync_debug_mode("error")``
   (a host sync fails the phase), bit-equal to the CPU's, timed;
4. ``golden``: the JAX package's serve golden
   (``tests/data/torch_serve_golden.npz``) replayed through the port's
   ``ServeEngine``: activations bit-equal, predictions within
   ``serving.golden.PRED_TOL``;
5. ``train_golden``: the JAX package's train golden
   (``tests/data/torch_train_golden.npz``, three SGD steps of a small
   bf16 DLRM) replayed through the port's train step: losses within
   ``train_golden.LOSS_TOL``, each final tensor within
   ``train_golden.UPDATE_TOL`` of its largest update. ``zoo_golden``:
   the same for the zoo golden (``tests/data/torch_train_zoo_golden.npz``,
   three Adagrad steps of Tiny with its vocabularies cut to 2,000 rows,
   f32). ``dense_golden``: the same for the dense-autodiff golden
   (``tests/data/torch_dense_train_golden.npz``, three ``optax.sgd``
   steps of the JAX ``make_train_step`` on a small DLRM that owns its
   tables, its bf16 run) through ``training.make_train_step``.
   ``ragged_golden``: the same for the ragged golden
   (``tests/data/torch_train_ragged_golden.npz``, three SGD steps of a
   small bf16 DLRM with four ``RaggedIds`` inputs);
6. ``serve``: the full-width DLRM of ``bench.py`` (26 Criteo-1TB tables
   x 1/16, width 128, dense_row_threshold=4096, bf16 compute, one-hot
   ids, world 1), its packed tables drawn on the card by
   ``training.init_sparse_state_direct``, frozen to f32 and to int8; per
   image a ``ServeEngine`` answers 3 requests of batch 4096. The
   predictions are finite, agree with a recomputation through the plain
   interaction, and K2-fwd ran once per request. A fourth request per
   image runs under ``torch.profiler`` (``serve_trace``): the device's
   busy time and idle share, the costliest device operations and K2-fwd's
   device time. Then ``serve_artifact``: per image (f32, then int8) the
   same state ``serving.export``-ed to a ``tempfile.mkdtemp()``
   directory, ``checkpoint.verify``-ed, ``serving.load``-ed and served by
   a ``ServeEngine`` on the artifact: the 3 requests' predictions
   bit-equal to the in-memory engine's (and, f32, to
   ``make_sparse_eval_step``'s), K2-fwd once per request; the bytes and
   files written, the seconds of export, verify and load, the free disk
   space (the directory is deleted before the next image). And
   ``serve_batcher``: the f32 artifact engine behind ``MicroBatcher(
   max_batch=4096, max_delay_s=0.002)``, 4 submitter threads sending
   3,000 requests of 1-512 rows as Poisson arrivals at 250, 1,000 and
   3,000 requests/s: per rate the p50 / p99 / p99.9 request latency,
   the dispatches and their mean fill, rejections by reason (summing to
   the batcher's count), the flusher's time in a dispatch and the
   completer's wait for the device; every answer within
   ``serving.golden.PRED_TOL`` of ``predict`` of the same rows, K2-fwd
   once per dispatch;
7. ``train``: ``bench.py``'s train step at full width (the same tables,
   ``batch_hint=65536``: 4 sparse classes and one dense class; SGD 0.1
   on the tables and the dense params; one batch of 65,536 uniform ids
   from seed 0, reused every step as ``bench.py`` does), once with f32
   compute and once with bf16: 3 warm-up and 10 timed steps, each timed
   alone on the host clock up to a synchronize. Every step: the loss is
   finite, K2-fwd and K2-bwd launched once and K1 once per sparse class,
   sampled rows of the first sparse class that the batch does not touch
   are bit-unchanged and sampled touched rows changed. A 14th step runs
   under ``torch.profiler`` (``train_trace``; K2-fwd's device time and its
   one launch there);
8. ``train_dense``: the README Quick start's dense-autodiff step at the
   train phase's width (``DLRM`` with its ``DistributedEmbedding``:
   the same 26 tables x 1/16 as class buffers, dense gradients,
   ``torch.optim.SGD`` 0.1 over every parameter, ``make_train_step``),
   f32 and bf16 compute: 3 warm-up and 5 timed steps with the train
   phase's checks, K2-fwd and K2-bwd launched once per step and no other
   kernel, a traced step (``train_dense_trace``). With bf16, then
   ``dense_vs_sparse``: one dense step and one fused sparse SGD step
   (``make_sparse_train_step``) from one state; every class row agrees
   within 1e-5 of its cell's absolute sum, the dense parameters within
   the f32 matmul class (``train_golden.dense_vs_sparse_step``). Then
   ``dlrm_main``: ``examples/dlrm/main_torch.py --dataset dummy --steps
   20 --batch_size 4096 --vocab_scale 0.0625 --lr 0.1 --warmup_steps 5
   --eval`` in a subprocess (world 1): exit 0, every printed loss and
   the AUC finite, its samples/s (and, split, its first step's seconds
   and the steady steps' samples/s). Then ``train_ckpt``: the train
   phase's cell (f32) with ``sgd_rule(schedule)`` and the scheduled
   dense SGD (``training.ScheduledSGD``): 3 steps, ``checkpoint.save``,
   ``verify`` and ``restore`` (seconds, bytes, files), the restored
   state bit-equal to the saved one (every fused buffer, dense tensor,
   dense-class table, optimizer state, the step), 3 more steps against 6
   run straight from a copy of the initial state: losses and final
   arrays bit-equal or within 1e-5 of each cell's magnitude (K1's
   atomics order duplicates), reported; K2-fwd and K2-bwd once and K1
   once per sparse class each step. Then ``dlrm_main_sparse``: the
   README's command with full-state checkpoints through the twin's
   ``main(argv)`` in this process (``--sparse --checkpoint_dir <tmp>
   --checkpoint_every 10 --steps 20``, B=4096, x 1/16) twice: finite
   losses and AUC, the second run resumed at step 20, the directory
   verified; then ``--dataset criteo`` over a split that
   ``write_dummy_criteo_split`` writes into a temporary directory, with
   the native loader built here and its batches bit-equal to the numpy
   backend's. Then the rest of the sparse step (slice 13): ``train_mb``,
   the train cell (f32) with ``micro_batches`` 1 and 4 from one state, 4
   steps each (step ms, the step's own peak memory, K2-fwd and K2-bwd once
   per micro-batch, K1 once per sparse class a step, the final states
   within 1e-5 of each other); ``train_guard``, the train cell with
   ``guard=True`` and without in turns (the guard's cost), a NaN batch
   (``bad_step`` 1, every array bit-equal to before, the step held), an
   out-of-range id under ``oov='error'`` (the same, and ``check_oov``
   raises) and ``make_sparse_eval_step(with_metrics=True)`` (its counts
   equal a numpy count); ``resilient``, the README's "Resilient
   training" through ``ResilientTrainer`` with the chaos story of
   ``tools/torch_chaos_train.py`` at the train cell's widths and the
   vocabulary cut to 1/256 (snapshot and restore seconds from the
   trainer's spans, the resumed losses within 1e-5 of the uninterrupted
   run's); ``dlrm_main_mb``, the twin with ``--sparse --micro_batches
   4``. Then the ragged value streams (slice 15): ``train_ragged``, the
   train cell's tables with ``combiner='sum'`` and the MLPerf DLRM-DCNv2
   multi-hot Criteo mix (the 15 features whose bag size h exceeds 1 as
   ``RaggedIds`` with lengths uniform in [1, h], capacity ``ceil(1.05 B
   (1 + h) / 2 / 8192) * 8192``, declared by negative ``input_hotness``;
   about 7.9 M ids a step), f32: one ragged step and one on its padded
   twin (``ragged_to_padded``) from one state, the losses and every
   touched row within 1e-5 of each cell's magnitude; 3 timed steps (K1 as
   predicted from the plan, chunked above 4,194,304 occurrences a class),
   untouched rows bit-unchanged, two eval forwards bit-equal; then
   ``serve_ragged``: its state served (bf16, B=4096, the same mix) from
   f32 and int8 images, in memory and from an artifact, every prediction
   bit-equal across two calls, the two engines and the eval step on the
   image's rows;
9. ``train_zoo``: Tiny at its published widths and full vocabulary (55
   tables, 58 inputs; 8.99 GB of fused buffers in two width-16
   generations and a width-8 class, Adagrad's accumulator interleaved),
   global batch 65,536 of power-law ids (``generate_batch(alpha=1.05,
   seed=i)`` for two batches used in turns), Adagrad 0.01 on the sparse
   classes, ``training.Adagrad`` 0.01 on the dense parameters, f32. First
   one step with ``DE_TORCH_COTANGENT_PIN`` off and one with it on from
   the same state: the losses, K6's update rows and the dense parameters
   bit-equal, the buffers bit-equal on every row fewer than two ids hit;
   K7 launched once per sparse bucket in the pinned step only. Then 3
   warm-up and 10 timed steps as in phase 7, each checked: the loss
   finite, K6 launched once per sparse bucket and K1 once per sparse
   class, sampled logical rows that neither batch touches bit-unchanged
   and most sampled touched ones changed. A further step under
   ``torch.profiler`` (``train_zoo_trace``). Then ``train_zoo_mb``: Tiny
   with ``micro_batches`` 1 and 4 from one state as ``train_mb`` (K6
   once per sparse bucket and micro-batch). ``train_zoo_ragged``: on the
   zoo's state, the ten-hot inputs as ``RaggedIds`` (lengths 1-10), one
   Adagrad step against its padded twin as in ``train_ragged`` (K6 builds
   the ``h=0`` parts of the narrow classes). Then ``zoo_main``: the
   twin ``examples/benchmarks/synthetic_models/main_torch.py --model tiny
   --batch_size 65536 --steps 6 --warmup_steps 2`` in this process (its
   ``main(argv)``), f32 and ``--amp``: ``SyntheticModel`` owning its
   ``DistributedEmbedding`` at the published vocabulary (4.49 GB of class
   buffers), ``training.Adagrad`` over every parameter, the
   dense-autodiff step; every loss finite, the mean loss of the last pass
   over the four batches below the first pass's, no kernel launched; its
   step ms, samples/s and peak memory beside this run's sparse
   ``train_zoo`` step. Then ``lookup_bench``: ``benchmark_torch.py`` at
   hotness 64 and 500 (vocab 1M x 128, batch 16,384), the CSR lookup
   against the padded gather + reduce, forward, gradient and SGD step,
   and the engine's ``segment_reduce`` combine, CUDA-event medians;
10. ``world4_golden``, ``train_world4``: four ranks spawned with
   ``torch.multiprocessing``, over NCCL when each owns a card, else over
   gloo with the four sharing the card (the backend is printed). Each
   first replays the JAX world-4 golden
   (``tests/data/torch_train_world4_golden.npz``, its bf16 run) within
   the train-golden tolerances, then trains the DLRM of ``examples/dlrm/
   main.py`` at world 4: 26 Criteo-1TB tables of width 128,
   ``memory_balanced``, ``dense_row_threshold=4096``, global batch 65,536
   (16,384 per rank) of one-hot ids from seed 0, SGD 0.1,
   ``overlap='fused'`` with 2 chunks, f32 wire; four cards: the full
   vocabulary, ``row_slice=2**30``; one card: vocabulary x 1/16,
   ``row_slice=2**26``. At f32 and bf16 compute: 3 warm-up and 10 timed
   steps, with the train phase's checks on each rank, K4 launched once
   per (sparse bucket, round, chunk), every rank's losses equal, and a
   traced step on rank 0 (K4's device time). Then ``world4_ckpt``: a
   state of the plan at x 1/16 (on four cards too: the full vocabulary
   would write 101 GB) with the scheduled SGD takes one step, every rank
   saves its own blocks and rank 0 publishes, every rank restores and
   is bit-equal to what it saved, and one step from the restored state
   and one from the saved state give the same loss, each launching K4,
   K1, K2-fwd and K2-bwd as a world-4 step does. Before it,
   ``world4_guard_mb``: a guarded step whose batch holds NaN in rank 1's
   slice only (every rank skips it, its arrays bit-equal to before), then
   one one-shot and one ``micro_batches=2`` step from one state, within
   1e-5 of each other, K4 launched once per (bucket, round, chunk) and
   micro-batch. Then one f32 step under
   ``overlap='fused'``
   and one under ``'none'`` from the same state: the losses bit-equal,
   the fused buffers bit-equal on every row fewer than two ids hit
   (elsewhere K1's atomics order the duplicates' adds). Then the
   README Quick start at world 4 (``world4_dense_golden``,
   ``train_dense_world4``): the JAX world-4 dense golden
   (``tests/data/torch_dense_train_world4_golden.npz``, its f32 run,
   whose interaction the card computes in bf16) replayed through
   ``make_train_step(mesh=)`` within the train-golden tolerances; then a
   ``DLRM(mesh=)`` of the same plan that owns its rank's blocks,
   ``broadcast_variables``, ``make_train_step(mesh=)``, ``SGD(0.1)``, f32
   and bf16: 3 warm-up and 5 timed steps with the train phase's checks on
   each rank (K2-fwd and K2-bwd once a step, no other kernel), every
   rank's losses equal, the replicated parameters bit-equal across the
   ranks, a traced step on rank 0. Then ``serve_world4``: on both
   backends a state of the x 1/16 plan, exported by the four ranks into
   one directory (f32), loaded with each rank's mesh, served by
   ``ServeEngine(mesh=)`` for 3 global requests of 4096 in lockstep:
   every rank's predictions equal, bit-equal to the in-memory engine's
   and to the world-4 ``make_sparse_eval_step``'s, K2-fwd once per rank
   and request. Before the guarded run, ``world4_wire`` (slice 14): from
   one seeded state each, the raw fused step and ``dedup_exchange=True``
   under ``'none'``, ``'pipelined'`` and ``'fused'`` (their activations
   bit-equal to the raw exchange's, 3 steps within 1e-5 of each cell's
   magnitude of the raw steps), bf16 and fp8 with dedup under ``'fused'``
   (activations within the JAX tests' bounds of f32, finite steps), a
   power-law batch (``models/synthetic.py: power_law_ids``, alpha 1.05)
   raw and dedup, a guarded step with ``dedup_capacity=4096`` (every
   rank's ``dedup_overflow`` above zero and equal to a numpy count) and
   one with a generous cap (0), dedup serving bit-equal to raw serving;
   each run's launches as predicted (K4 per round chunk of the unique
   capacity); per variant the step ms, each class's unique share and the
   float bytes a step sends (raw, dedup, bf16, fp8). After it,
   ``world4_ragged`` (slice 15): the world-4 tables with the multi-hot
   mix (a global batch of 65,536, each rank its block), the activations
   bit-equal under the three schedules (K4 once per ragged bucket and
   round), a row-sliced ``mean`` table, the padded twin within 1e-5,
   ``dedup_exchange`` beside raw ragged buckets bit-equal, ragged serving
   bit-equal to the eval step, a guarded step's OOV counts equal to
   numpy's, and model-parallel inputs (``pack_mp_inputs``,
   ``forward_mp``) bit-equal to the dp-input forward with their
   gradients within 1e-5. Then ``world4_colslice`` (slice 16): the
   world-4 Criteo tables (x 1/16 on both backends) with
   ``column_slice_threshold=2**23`` (every
   width-128 table above it in four 32-lane slices, the two smallest
   sparse ones whole), SGD, and Tiny's three shared multi-hot tables
   (x 1/16 on one card; a one-hot and a ten-hot input each) sliced into
   2- and 4-lane pieces, Adagrad: per cell the activations under the
   three schedules and with ``dedup_exchange`` bit-equal to ``'none'``'s
   (dedup beside the narrow cell's window-masked gather in the f32
   class: it adds a bag in another order, as the JAX engine does), 3
   fused steps with finite losses equal on every rank, K4, K1 and K6
   launched as predicted from the plan (K4 only for the plain-row
   width-128 class, ``k4_classes``), and one global request served from
   the frozen f32 image bit-equal to the eval step (the narrow cell in
   the f32 class: its serve image packs more rows a physical row). Then
   ``zoo_world4``: ``utils.zoo_bench.run_zoo_plan_step("tiny")`` (one
   card: vocabulary x 1/16, global batch 16,384; four cards: the full
   vocabulary and 65,536), its K6 and K1 launches predicted from the
   routed batch, and Tiny's dense-autodiff step at world 4
   (``SyntheticModel(mesh=)``, ``broadcast_variables``,
   ``training.Adagrad``, ``make_train_step(mesh=)``; the same cuts), no
   kernel launched, the losses equal on every rank. After
   ``serve_world4``, ``world4_bf16`` (slice 17): the plan's tables in bf16
   (x 1/16 on both backends), SGD under ``'none'``, ``'pipelined'`` and
   ``'fused'`` from one state (3 steps each; the first step's losses
   equal and its buffers bit-equal to ``'none'``'s off duplicate rows;
   K4's bf16 form as ``k4_classes`` predicts, K1's once per class), one
   Adagrad step, and ``serve_world4_fp8``: the SGD state's fp8 images
   exported, loaded and served in lockstep, equal on every rank and
   bit-equal to the in-memory engine's.
11. Narrow storage and fp8 images (slice 17), in the first card's
   phases: ``kernel`` rows of K1's and K4's bf16 forms
   (``apply_rows_bf16``: 131,072 uniform, unique and one-row ids on the
   train plan's first class in bf16 and the Tiny w16 stream at
   physical-row granularity, unique ids bit-equal, duplicates within
   ``3 m 2^-8`` of a cell's absolute sum; ``gather_rows_bf16``: the K4
   block, bit-equal); ``train_bf16_golden`` (the committed JAX
   narrow-storage golden within ``train_golden.compare_bf16``'s bounds);
   ``serve_fp8`` (the serve cell's fp8 images exported, loaded and
   served, bit-equal to the in-memory engine, every activation within the
   JAX fp8 bound of the f32 image's); ``train_bf16`` (``bench.py``'s step
   on the 26 Criteo-1TB tables at their full vocabulary in bf16, 48.07
   GB, on this card: 3 warm-up and 10 timed steps, the train phase's
   checks, K1's bf16 form once per class); ``train_bf16_vs_f32`` (x 1/16:
   ten steps of a bf16 state and of an f32 state of the same values,
   losses within 1e-2) and ``bf16_ckpt`` (its bf16 state saved and
   restored bit-equal).
12. Tiered storage (slice 18): ``tiered_golden`` (the committed JAX
   tiered golden, three guarded Adagrad steps of ``TieredTrainer`` with a
   spill and a re-rank, replayed through the port's: losses and tables
   within the golden tolerances, hit counters exact); ``train_tiered``
   (``bench.py``'s step on the 26 Criteo-1TB tables in f32 with the five
   above ``host_row_threshold=10_000_000`` host-tier: 183,703,407 rows,
   94.06 GB of host images, a 40 GiB device budget, staging 16,384,
   re-rank every 8 steps, SGD 0.1, B = 65,536 power-law ids at alpha
   1.05; ``MemTotal`` / ``MemAvailable`` first, every table cut by the
   smallest power of two whose images fit 1/1.25 of the available RAM;
   2 warm-up and 10 timed steps through ``TieredTrainer.run``: step
   times, the host spans against the device window, hit rate, gather
   bytes, spill steps, K1 and K2 against the plan); ``train_tiered_vs_
   device`` (x 1/16: one drawn state trained all-device twice and
   tiered once, with a 2-row staging region, so steps spill, and a
   re-rank: losses within rtol 1e-5, the tables within K1's duplicate
   tolerance after the first step and, at the end, no farther from the
   all-device run than twice its twin, the bit-equal shares); ``tiered_ckpt`` (x 1/16: save, ``verify``, restore into a
   fresh store, resume against the straight run); inside the world-4
   phase, ``world4_tiered`` (x 1/16 on one card: four ranks, each store
   owning its rank's images, under ``'fused'``: the first step's losses
   equal to ``'none'``'s, K4 and K1 as ``k4_classes`` predicts).

13. Narrow storage under every rule and id form, dense Adam (slice 20):
   ``kernel`` rows of K1's bf16 form at the momentum and Adam rules'
   lanes (256 and 384 lanes at width 128: 131,072 ids, a sixteenth out
   of range on either side, 64 on one row; Tiny's largest w16 class at
   32- and 48-lane strides), each held to its plain version as in item
   11; ``train_bf16_rules_golden`` (the committed JAX rules golden: bf16
   buffers under ``adam_rule``, ``optax.adam`` on the dense side, one
   ragged input); ``train_bf16_adam`` (``bench.py``'s step on the
   Criteo-1TB tables cut by 3 under ``adam_rule`` and ``training.Adam``,
   48.07 GB: K1's bf16 form once per class, untouched rows with their
   moment lanes bit-equal); ``train_bf16_ragged`` (the multi-hot Criteo
   mix on the full vocabulary in bf16: the ragged step against its padded
   twin, K1 as :func:`k1_launches` predicts); ``train_bf16_rules_vs_f32``
   (x 1/16, momentum and Adam: ten steps of a bf16 state and of its f32
   twin, losses within 1e-2); ``sparse_optim`` (the table-level sparse
   optimizers on the card against the CPU); ``train_dense_bf16`` (the
   dense-autodiff step with bf16 class buffers under ``training.Adam``
   against its f32 twin, no K1); and in ``world4_bf16``
   ``world4_bf16_rules``: the dedup exchange under the momentum rule in
   the three schedules (the first step bit-equal to ``'none'``'s off
   duplicate rows), an Adam step and a ragged step under ``'fused'``, K4's
   bf16 form as :func:`k4_forward_launches` predicts.

then the ``kernels`` line, the ``nvidia-smi`` line and, last, the
contract line ``{"ok": true, "device": {...}}``. The launch counts of
the ``kernels`` line (the nine kernels and the two bf16 forms) come from
the serve, serve_artifact, serve_batcher, serve_fp8, train, train_bf16,
train_bf16_vs_f32, dense, train_ckpt, dlrm_main_sparse, train_mb,
train_guard, resilient, dlrm_main_mb, train_ragged, serve_ragged, zoo,
train_zoo_mb, train_zoo_ragged, zoo_main and world-4 (sparse train, wire
compression, ragged, guard and micro-batch, checkpoint, dense train,
serve, bf16 tables, column slices, the zoo and tiered storage), the
tiered (golden, train, vs device, checkpoint) phases alone: each sets
every counter to 0 just before each
run of its path, reads them all just after, and checks them against the
launches it expects, 0 for the kernels the path does not run (the world-4
counts are summed over the ranks; K7's come from the pinned zoo step).
Any failed check exits non-zero before the last line; so does a machine
without CUDA.

On a machine with four cards the same command runs every phase; phases
1-9 use the first card (K5's peer rounds all four), and phase 10 runs
over NCCL at the full vocabulary, one rank per card.
"""

import functools
import importlib
import json
import re
import statistics
import subprocess
import sys
import time

SEED = 0
F, D = 27, 128
KERNEL_BATCHES = (4096, 65536, 4000)
SERVE_BATCH = 4096
SERVE_REQUESTS = 3
# the batcher phase: Poisson arrivals of requests of 1-512 rows from
# several submitter threads, at each offered rate (requests/s)
BATCHER_RATES = (250, 1000, 3000)
BATCHER_REQUESTS = 3000
BATCHER_THREADS = 4
BATCHER_MAX_ROWS = 512
BATCHER_DELAY_S = 0.002
BATCHER_POOL = 4  # request rows are drawn from 4 x 4096 pooled rows
TRAIN_BATCH = 65536
# bench.py's 24.0 sends this random-label batch's loss to NaN by the
# fourth step; 0.1 is what MLPerf DLRM's warm-up from 0 to 24 over 2,750
# steps reaches by step 13. The step's work is the same at any rate.
TRAIN_LR = 0.1
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
# the dense-autodiff step's timed steps (phase 8, train_dense, and the
# world-4 dense step of phase 10)
DENSE_TIMED = 5
# the README's "Train end-to-end" command, as the port's twin of
# examples/dlrm/main.py runs it here (world 1, the Criteo tables x 1/16)
DLRM_MAIN_ARGS = ("--dataset", "dummy", "--steps", "20", "--batch_size",
                  "4096", "--vocab_scale", "0.0625", "--lr", "0.1",
                  "--warmup_steps", "5", "--eval")
# the trainer's checkpoints (train_ckpt): the train phase's cell with
# sgd_rule(schedule) and the scheduled dense SGD, CKPT_STEPS steps, a
# save, a restore and CKPT_STEPS more, against 2 x CKPT_STEPS straight;
# the schedule warms up, holds and decays within the six steps
CKPT_STEPS = 3
CKPT_SCHEDULE = (TRAIN_LR, 2, 3, 3)
# the README's "Train end-to-end" command with full-state checkpoints,
# run twice (the second resumes), then over a locally written Criteo split
DLRM_MAIN_SPARSE_FLAGS = {"--dataset": "dummy", "--steps": "20",
                          "--batch_size": "4096", "--vocab_scale": "0.0625",
                          "--lr": "0.1", "--warmup_steps": "5",
                          "--checkpoint_every": "10"}
CRITEO_SAMPLES = 4096 * 12  # 12 batches of 4,096 in each split
CRITEO_STEPS = 10
# the world-4 checkpoint phase's vocabulary cut on either backend (on four
# cards the full vocabulary would write 101 GB of rank files)
W4_CKPT_VOCAB_SCALE = 16
# the micro-batch phases (train_mb, train_zoo_mb, dlrm_main_mb): the
# micro-batches of a step, and the steps per mode (the first untimed)
MICRO_BATCHES = 4
MB_STEPS = 4
# the guard's cost (train_guard): timed steps with and without it
GUARD_TIMED = 5
# the README's "Resilient training" (resilient): the chaos story of
# tools/torch_chaos_train.py at the train cell's widths, the vocabulary
# cut to 1/256 of Criteo-1TB (the train cell's 1/16 cut 16 times more) so
# that a save takes about a second, not the full cell's 10.6 s
RESILIENT_VOCAB_SCALE = 256
RESILIENT_STEPS, RESILIENT_NAN_EVERY, RESILIENT_SNAPSHOT_EVERY = 24, 7, 4
# the world-4 guarded step: the rank whose slice of the batch holds NaN
W4_NAN_RANK = 1
# the interaction backward's edge shapes (K2-bwd and K3-bwd, B=1000):
# one and few features, F=32, narrow and wide rows
BWD_EDGE_F = (1, 2, 13, 32)
BWD_EDGE_D = (8, 16, 64, 256)
BWD_EDGE_B = 1000
# K3 at the batches of the serve request and the train step
K3_BATCHES = (4096, 65536)
ROWS_SAMPLED = 4096
K1_IDS = 131072
K1_SCALE = -TRAIN_LR
TIMING_REPS = 50
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clocks
# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, dense bf16,
# f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
CRITEO_1TB_VOCAB = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36
]
REPLACES = {
    "interact_fwd": "distributed_embeddings_tpu/ops/pallas_interact.py:139",
    "interact_flat_fwd":
        "distributed_embeddings_tpu/ops/pallas_interact.py:188",
    "interact_flat_bwd":
        "distributed_embeddings_tpu/ops/pallas_interact.py:206",
    "gather_send_rows": "distributed_embeddings_tpu/ops/pallas_exchange.py:236",
    "interact_bwd": "distributed_embeddings_tpu/ops/pallas_interact.py:162",
    "apply_rows": "distributed_embeddings_tpu/ops/pallas_apply.py:211",
    "gather_rows": "distributed_embeddings_tpu/ops/pallas_exchange.py:212",
    "build_delta_rows": "distributed_embeddings_tpu/ops/pallas_delta.py:78",
    "row_major": "distributed_embeddings_tpu/ops/pallas_layout.py:32",
    "apply_rows_bf16": "distributed_embeddings_tpu/ops/pallas_apply.py:211",
    "gather_rows_bf16":
        "distributed_embeddings_tpu/ops/pallas_exchange.py:212",
}
# every kernel's launch counter: the wrapper's module under
# distributed_embeddings_torch.ops, and its attribute there
COUNTERS = {
    "interact_fwd": ("cuda_interact", "launches"),
    "interact_bwd": ("cuda_interact", "bwd_launches"),
    "interact_flat_fwd": ("cuda_interact", "flat_launches"),
    "interact_flat_bwd": ("cuda_interact", "flat_bwd_launches"),
    "apply_rows": ("cuda_apply", "launches"),
    "gather_rows": ("cuda_exchange", "launches"),
    "gather_send_rows": ("cuda_exchange", "send_launches"),
    "build_delta_rows": ("cuda_delta", "launches"),
    "row_major": ("cuda_layout", "launches"),
    "apply_rows_bf16": ("cuda_apply", "launches_bf16"),
    "gather_rows_bf16": ("cuda_exchange", "launches_bf16"),
}
# the bf16 forms of K1 and K4 (narrow storage): second entry points of
# their kernels' sources, each with its own launch counter
BF16_FORMS = {"apply_rows_bf16": "apply_rows",
              "gather_rows_bf16": "gather_rows"}
# the kernels of the world-4 path (every one must launch there)
W4_KERNELS = ("interact_fwd", "interact_bwd", "apply_rows", "gather_rows")
# the synthetic zoo's train step (tools/bench_synthetic.py tiny 65536):
# Tiny at its full vocabulary, power-law ids, Adagrad 0.01 on the sparse
# classes and the dense parameters, f32
ZOO_MODEL = "tiny"
ZOO_BATCH = 65536
ZOO_ALPHA = 1.05
ZOO_LR = 0.01
ZOO_DENSE_ROW_THRESHOLD = 2048
# K6 against its plain version (the JAX test's tolerance: the rsqrt chains
# round a few ulps apart)
K6_TOL = {"rtol": 1e-6, "atol": 2e-7}
# K6's rule checks: the widths of the vector path (multiples of 4) and of
# the general path
K6_WIDTHS = (8, 16, 32, 64)
K6_GENERAL_WIDTHS = (6,)
# pin-on vs pin-off steps: cells of rows that two or more of the step's
# ids hit may differ by K1's (and the dense-class index_add_'s) atomic
# order, by at most this share of the cell's magnitude
ZOO_DUP_RTOL = 1e-5
# the world-4 hybrid-parallel step (examples/dlrm/main.py --sparse at
# world 4, under the plan's overlap='fused' wire)
WORLD = 4
W4_BATCH = 65536  # global: 16,384 per rank
W4_CHUNKS = 2
# four cards: full Criteo-1TB vocabulary, five tables row-sliced 4 ways
# (25.3 GB of fused buffers per card); one card shared by the four ranks:
# vocabulary x 1/16, the same five tables row-sliced (2.1 GB per rank)
W4_ROW_SLICE = {"nccl": 2**30, "gloo": 2**26}
W4_VOCAB_SCALE = {"nccl": 1, "gloo": 16}
K4_BAD_SHARE = 0.3  # ids out of range or sentinels in K4's second stream
# cells of a fused-vs-none comparison that may differ: only rows that two
# or more of the step's ids hit (K1 adds duplicates with atomics, in an
# order of the card's choosing), and there by at most this much
W4_DUP_ATOL = 1e-6
CSRC = "distributed_embeddings_torch/csrc"
# device kernel names (demangled or mangled) of K2-fwd and K4 in a trace
K2_FWD_TRACE = {"interact_fwd": ("interact::fwd_kernel<interact::PartRows>",
                                 "8interact10fwd_kernelINS_8PartRows")}
K4_TRACE = {"gather_rows": ("gather_rows_kernel",)}
# K4's edge blocks (ids), beside the world-4 block of 8,192
K4_EDGE_N = (1, 31, 8193)
K4_SMALL_ROWS = 65536  # the TLB-reach yardstick's buffer: 32 MB of rows
# the wire compression (README "wire compression"): the world-4 cell under
# dedup_exchange / dedup_capacity / the bf16 and fp8 wires
W4_WIRE_STEPS = 3
W4_WIRE_CAP = 4096  # a dedup_capacity below the cell's unique counts
W4_WIRE_GENEROUS = 1 << 30  # one above every block's safe bound
W4_WIRE_ALPHA = 1.05  # the power-law batch (models/synthetic.py)
# the JAX tests' bounds of a narrow wire's activations against f32, per
# element: hotness x this x the output's largest magnitude
W4_WIRE_BOUND = {"bf16": 2.0 ** -8, "fp8": 2.0 ** -3}
FP8_BLOCKS = 16  # the fp8 codec's CPU-vs-card blocks
# ragged value streams (slice 15): the MLPerf Training DLRM-DCNv2 multi-hot
# Criteo bag sizes (its multi_hot_sizes), one per Criteo feature; a feature
# whose size h exceeds 1 arrives as RaggedIds with lengths uniform in
# [1, h], the others one-hot
MULTI_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                   12, 100, 27, 10, 3, 1, 1)
# a stream's capacity: this share over its expected length, rounded up to
# a multiple of RAGGED_ALIGN (features of one size share a bucket)
RAGGED_SLACK = 1.05
RAGGED_ALIGN = 8192
RAGGED_STEPS = 3  # timed ragged steps (train_ragged)
# the world-4 ragged cell's row-sliced table given combiner='mean'
RAGGED_MEAN_FEATURE = 21
ZOO_RAGGED_HOT = 10  # Tiny's multi-hot inputs as RaggedIds: lengths 1-10
# model-parallel inputs refuse row slices: their world-4 plan holds the
# tables whole, cut to x 1/16 on either backend; every rank gathers the
# global batch's padded ids of its tables (a sixteenth of the cell's batch
# keeps four ranks' gathers and gradients on one card)
W4_MP_VOCAB_SCALE = 16
W4_MP_BATCH = 4096
# column-sliced tables at world 4 (slice 16): the world-4 Criteo tables
# (x 1/16 on either backend) with a column_slice_threshold that cuts every
# width-128 table above it
# into four 32-lane slices (the two smallest sparse tables stay whole: a
# plain-row class that takes K4), and a Tiny-like plan of Tiny's three
# shared multi-hot tables (a one-hot and a ten-hot input each; x 1/16 on
# one card) sliced into 2- and 4-lane pieces, Adagrad's state beside them
W4_COL_SLICE = 2**23
W4_NARROW_SLICE = 2048
W4_NARROW_GROUPS = ((10_000, 8), (1_000_000, 16), (25_000_000, 16))
W4_SLICED_STEPS = 3
# the zoo at world 4: four cards run Tiny at its full vocabulary and
# B = 65,536; one card shared by four gloo ranks cuts the vocabulary by 16
# and the global batch to 16,384
W4_ZOO_VOCAB_SCALE = {"nccl": 1, "gloo": 16}
W4_ZOO_BATCH = {"nccl": 65536, "gloo": 16384}
W4_ZOO_STEPS = 3
# the README Quick start's last command, in-process: the twin
# examples/benchmarks/synthetic_models/main_torch.py at the published
# widths and vocabulary (its four power-law batches in turn)
ZOO_MAIN_FLAGS = ("--model", "tiny", "--batch_size", "65536", "--steps",
                  "6", "--warmup_steps", "2")
ZOO_MAIN_BATCHES = 4  # main.py's --num_batches default
# examples/benchmarks/benchmark_torch.py's hotness caps
LOOKUP_BENCH_HOTNESS = (64, 500)
# the sparse Tiny step of this run (phase_train_zoo), printed beside the
# dense-autodiff zoo step (phase_zoo_main)
ZOO_SPARSE_STEP = {}
# narrow storage (slice 17): on a row that m occurrences hit, K1's bf16
# form and its plain version (XLA's scatter) may differ by their roundings:
# m on the plain side (every add), at most two a run of one id on the
# kernel's (the run's f32 sum to bf16, then the atomic add), each at most
# 2^-8 of the cell's absolute sum |buf| + sum |d|: 3 m 2^-8 of it
BF16_DUP_ULP = 3 * 2.0 ** -8
# the bf16 state against its f32 twin at 1/16 (train_bf16_vs_f32)
NARROW_VS_STEPS = 10
NARROW_LOSS_RTOL = 1e-2
# narrow storage under every rule and id form, dense Adam (slice 20)
ADAM_LR = 1e-3  # adam_rule and training.Adam on the card's paths
# the rules golden's planted fault, which its card bound must refuse
RULES_PLANTED_FAULT = {"b2": 0.99}
# ... and the small one only the card-emulation bound sees
RULES_SMALL_FAULT = {"b2": 0.998}
# train_dense_bf16's hand-written loop (zero_grad, backward, Adam's step)
# on bf16 class buffers, on the card and on the CPU: a linear head over
# the embeddings, so nothing but the dense class's cotangent rounding (to
# bf16 on the card, as on the TPU) and the order of bf16 adds parts them.
# Every buffer: this share of its cells within HAND_LOOP_ULPS bf16 ulps of
# the larger of the cell and the learning rate, and every cell within a
# step's flip a step (2 x ADAM_LR x steps, a cell whose gradient is about
# 0 steps by +-lr) plus HAND_LOOP_ULPS ulps
HAND_LOOP_VOCAB = (3, 24, 300, 5000, 20000)
HAND_LOOP_THRESHOLD = 512  # the 3-, 24- and 300-row tables: a dense class
HAND_LOOP_BATCH = 4096
HAND_LOOP_STEPS = 3
HAND_LOOP_ULPS = 2
HAND_LOOP_SHARE = 0.99
ADAM_VOCAB_CUT = 3  # train_bf16_adam: 384 bf16 lanes a row, 48.07 GB
SPARSE_OPTIM_ROWS = 1 << 18
W4_RULES_STEPS = 1  # world4_bf16_rules: steps a dedup schedule
# train_bf16_ragged's ragged step against its padded twin: every touched
# bf16 cell within this many bf16 ulps (the ragged bag rounds each add to
# bf16, the padded bag once)
RAGGED_BF16_TWIN_ULPS = 4
# ... plus this share of its tensor's largest update: a ragged bag adds
# each row rounded to bf16 (XLA's segment_sum), a padded bag sums in f32
# and rounds once, so the two arms' gradients differ by a share of a
# gradient (13 % on the CPU rehearsal at a small vocabulary)
TWIN_UPDATE_SHARE = 0.25
# the world-4 narrow cell's steps per schedule (world4_bf16)
W4_NARROW_STEPS = 3
# tiered storage (train_tiered and the phases after it): the five
# Criteo-1TB tables above 10 M rows host-tier, a 40 GiB device budget,
# staging for 16,384 cold rows a class, a re-rank every 8 steps,
# power-law ids (uniform ids would defeat any cache)
TIERED_HOST_ROWS = 10_000_000
TIERED_BUDGET = 40 * 2**30
TIERED_STAGING = 16384
TIERED_RERANK = 8
TIERED_ALPHA = 1.05
TIERED_WARMUP = 2
TIERED_TIMED = 10
TIERED_RAM_SLACK = 1.25  # host RAM needed over the images' bytes
TIERED_VS_SCALE = 16  # train_tiered_vs_device, tiered_ckpt, world4_tiered
TIERED_VS_STEPS = 4
TIERED_VS_DUP_RTOL = 1e-5  # K1's: of each cell's absolute sum
TIERED_CKPT_STEPS = 2
W4_TIERED_STEPS = 3
# the host-pass pipeline and elastic worlds (slice 21)
TIERED_OVERLAP_VS_STEPS = 6     # tiered_overlap_vs_serial: a NaN batch, a
TIERED_OVERLAP_VS_NAN = 2       # re-rank every 3 steps, batch 4 repeating
TIERED_OVERLAP_VS_RERANK = 3    # batch 3 (its cold rows written back while
TIERED_OVERLAP_VS_BATCH = 64    # the worker gathers them): distinct ids in a
#                                 sparse table's column of a batch, then the
#                                 cell's power-law traffic (TRAIN_BATCH)
W4_ELASTIC_VOCAB_SCALE = 512    # world4_elastic: the world-4 plan's tables
W4_ELASTIC_BATCH = 16384        # global batch of its steps
# tiered serving (serve_tiered and the phases after it): the train_tiered
# cell's trained store frozen to int8 and fp8 images (f32 at the cut the
# host's RAM forces: it holds a second full-width copy of the images), a
# serve cache of a quarter of each host-tier class's serve rows, staging
# for 1,024 cold rows a class, SERVE_BATCH power-law requests
SERVE_TIERED_REQUESTS = 20
SERVE_TIERED_CACHE = 0.25
SERVE_TIERED_STAGING = 1024
SERVE_TIERED_COUNT_BATCHES = 2  # traffic classified into a fresh store's counts
SERVE_TIERED_VS_REQUESTS = 3    # serve_tiered_vs_device, serve_tiered_artifact
W4_SERVE_TIERED_REQUESTS = 3
# the rank-0 batcher at world 4 (one card shared by four gloo ranks serves a
# few dispatches a second): Poisson arrivals of 1-512 rows
W4_BATCHER_RATE = 20
W4_BATCHER_REQUESTS = 200


class SmokeFailure(Exception):
  pass


_T0 = time.perf_counter()


def emit(obj) -> None:
  """One JSON line; a phase's line carries ``t_s``, the seconds since the
  script started, so the run's time can be laid out phase by phase."""
  if "phase" in obj:
    obj = {**obj, "t_s": round(time.perf_counter() - _T0, 3)}
  print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
  if not cond:
    raise SmokeFailure(what)


def _counter_module(mod: str):
  return importlib.import_module(f"distributed_embeddings_torch.ops.{mod}")


def reset_counts() -> None:
  """Every kernel's launch counter to 0."""
  for mod, attr in COUNTERS.values():
    setattr(_counter_module(mod), attr, 0)


def read_counts() -> dict:
  """Every kernel's launches since the last :func:`reset_counts`."""
  return {name: getattr(_counter_module(mod), attr)
          for name, (mod, attr) in COUNTERS.items()}


def expect(**launches) -> dict:
  """Launches of every kernel: ``launches``' counts, 0 for the others."""
  unknown = set(launches) - set(COUNTERS)
  check(not unknown, f"no launch counter for {sorted(unknown)}")
  return {name: launches.get(name, 0) for name in COUNTERS}


def add_counts(totals: dict, got: dict) -> None:
  for name, n in got.items():
    totals[name] += n


def nvidia_smi() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
      check=True).stdout
  return out.strip().splitlines()[0]


def event_ms(torch, fns, flush, reps: int = TIMING_REPS) -> dict:
  """Median device time of one call of each of ``fns`` (name -> fn),
  timed in turns so that drift reaches every version alike, the L2
  flushed before each call (the train and serve steps find these inputs
  cold at large B). A spin of about a millisecond on the card precedes
  each start event, so the host has queued the whole call before the
  card reaches it: the time is the card's, not the host's launch
  latency."""
  for fn in fns.values():
    fn()
  times = {name: [] for name in fns}
  for _ in range(reps):
    for name, fn in fns.items():
      flush.zero_()
      torch.cuda._sleep(SPIN_CYCLES)
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn()
      end.record()
      end.synchronize()
      times[name].append(start.elapsed_time(end))
  return {name: statistics.median(t) for name, t in times.items()}


def bound(bytes_moved: float, ops: float, peak_ops: float) -> dict:
  """The least time of the work on this card: bytes over the HBM rate or
  operations over the peak rate of their type, whichever is larger."""
  by_bytes = bytes_moved / HBM_BYTES_PER_S
  by_ops = ops / peak_ops
  return {"bound_ms": max(by_bytes, by_ops) * 1e3,
          "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def warm_up(torch, seconds: float = 2.0) -> None:
  """Keep the card busy with bf16 matrix products for ``seconds``, so the
  timings that follow do not start from idle clocks."""
  a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
  t0 = time.perf_counter()
  while time.perf_counter() - t0 < seconds:
    for _ in range(50):
      a @ a
    torch.cuda.synchronize()


def within_one_bf16_ulp(torch, got, want, slack=None) -> tuple:
  """(cells that differ, max |got - want| / max(one bf16 ulp, slack))."""
  differ = int((got != want).sum().item())
  _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
  ulp = torch.ldexp(torch.ones_like(got), e - 8)
  if slack is not None:
    ulp = torch.maximum(ulp, slack)
  return differ, ((got - want).abs() / ulp).max().item()


def bf16_parts(torch, b: int, seed: int) -> list:
  gen = torch.Generator(device="cuda").manual_seed(seed)
  return [(torch.randn((b, D), generator=gen, device="cuda") * 0.3)
          .to(torch.bfloat16) for _ in range(F)]


def fwd_check(torch, ci, name, got, want, feats, k) -> dict:
  """K2-fwd's and K3-fwd's tolerance class: at least 99.9% of the cells
  bit-equal, every cell within one bf16 ulp or, where its D terms cancel,
  within the f32 summation bound ``D * 2^-24 * sum_d |x_p[d] x_q[d]|``
  (the tensor cores' f32 sums round otherwise than the plain version's).
  ``feats``: the ``[B, F, D]`` inputs. Returns the cells that differ,
  the largest difference in bf16 ulps, the cells past one ulp (each
  within the bound) and the largest share of the bound such a cell
  takes."""
  b, f, d = feats.shape
  if got.numel() == 0:
    return {"cells_differ": 0, "max_ulp": 0.0, "cells_past_one_ulp": 0,
            "max_share_of_bound_past_one_ulp": 0.0}
  rows, cols = ci.tril_pairs(f, k)
  x = feats.float().abs()
  idx = torch.as_tensor(rows * f + cols, device=got.device)
  abs_sum = torch.bmm(x, x.transpose(1, 2)).flatten(1).index_select(1, idx)
  slack = d * 2.0**-24 * abs_sum
  differ, ulps = within_one_bf16_ulp(torch, got, want)
  _, share = within_one_bf16_ulp(torch, got, want, slack=slack)
  check(differ <= 0.001 * got.numel() and share <= 1.0,
        f"{name} B={b} F={f} D={d} k={k}: {differ} of {got.numel()} cells "
        f"differ, worst by {share} of its allowance")
  _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
  err = (got - want).abs()
  past = err > torch.ldexp(torch.ones_like(got), e - 8)
  n_past = int(past.sum().item())
  return {"cells_differ": differ, "max_ulp": ulps,
          "cells_past_one_ulp": n_past,
          "max_share_of_bound_past_one_ulp":
              (err[past] / slack[past]).max().item() if n_past else 0.0}


def k2_geometry_check(torch, ci, f: int, d: int, k: int) -> dict:
  """The launcher's forward geometry for ``(f, d, k)``, read back from the
  library, against ``cuda_interact.fwd_geometry``; returns it."""
  import ctypes

  from distributed_embeddings_torch.ops._build import load
  want = ci.fwd_geometry(f, d, k)
  fn = load("interact_fwd").interact_fwd_geometry
  fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int64)]
  fn.restype = ctypes.c_int
  got = (ctypes.c_int64 * 8)()
  check(fn(f, d, k, want.ns, got) == 0,
        f"interact_fwd_geometry({f}, {d}, {k}) failed")
  mask = sum(1 << (m * 4 + n) for m, n in want.tiles)
  laid = [want.xr, want.kt, want.nkt, want.re, mask, want.x_stage,
          want.o_stage, want.smem]
  check(list(got) == laid, f"interact_fwd: the launcher lays out "
        f"{list(got)} for F={f} D={d} k={k}, fwd_geometry {laid}")
  return {"ns": want.ns, "xr": want.xr, "kt": want.kt,
          "tiles": len(want.tiles), "smem": want.smem}


def fwd_edges(torch, ci, name: str) -> None:
  """K2-fwd (``interact_fwd``) or K3-fwd (``interact_flat_fwd``) at the
  backward's edge shapes, B=1000, k in {-1, 0}, in the class of
  :func:`fwd_check`, with K2-fwd's launcher geometry checked at each
  shape; checked, not timed."""
  cases = []
  for f in BWD_EDGE_F:
    for d in BWD_EDGE_D:
      for k in (-1, 0):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 89 * f + d - k)
        feats = (torch.randn((BWD_EDGE_B, f, d), generator=gen,
                             device="cuda") * 0.3).to(torch.bfloat16)
        if name == "interact_flat_fwd":
          got = ci.interact_flat_fwd(feats, k)
          torch.cuda.synchronize()
          want = ci.interact_flat_fwd_plain(feats, k)
        else:
          k2_geometry_check(torch, ci, f, d, k)
          parts = [feats[:, p].contiguous() for p in range(f)]
          got = ci.interact_parts_fwd(parts, k)
          torch.cuda.synchronize()
          want = ci.interact_parts_fwd_plain(parts, k)
        npair = len(ci.tril_pairs(f, k)[0])
        check(tuple(got.shape) == (BWD_EDGE_B, npair),
              f"{name} F={f} D={d} k={k}: shape {tuple(got.shape)}")
        c = fwd_check(torch, ci, name, got, want, feats, k)
        cases.append([f, d, k, c["cells_differ"], c["max_ulp"],
                      c["cells_past_one_ulp"],
                      c["max_share_of_bound_past_one_ulp"]])
  emit({"phase": "kernel", "name": name, "stream": "edges",
        "B": BWD_EDGE_B,
        "F_D_k_differ_max_ulp_past_one_ulp_share_of_bound": cases})


def phase_kernel_fwd(torch, ci, flush) -> dict:
  """K2-fwd against its plain version; returns the serve-shape row."""
  main = None
  geometry = {k: k2_geometry_check(torch, ci, F, D, k) for k in (-1, 0)}
  for b in KERNEL_BATCHES:
    for k in (-1, 0):
      parts = bf16_parts(torch, b, SEED + b - k)
      got = ci.interact_parts_fwd(parts, k)
      torch.cuda.synchronize()
      want = ci.interact_parts_fwd_plain(parts, k)
      rows, cols = ci.tril_pairs(F, k)
      check(tuple(got.shape) == (b, len(rows)), f"shape {tuple(got.shape)}")
      checked = fwd_check(torch, ci, "interact_fwd", got, want,
                          torch.stack(parts, dim=1), k)
      idx = torch.as_tensor(rows * F + cols, device="cuda")

      def library(parts=parts, idx=idx):
        feats = torch.stack(parts, dim=1)
        inter = torch.bmm(feats, feats.transpose(1, 2))
        return inter.flatten(1).index_select(1, idx).float()

      npair = len(rows)
      timed = event_ms(torch, {
          "kernel_ms": lambda: ci.interact_parts_fwd(parts, k),
          "plain_ms": lambda: ci.interact_parts_fwd_plain(parts, k),
          "library_ms": library}, flush)
      row = {
          "phase": "kernel", "name": "interact_fwd", "B": b, "F": F, "D": D,
          "k": k, "geometry": geometry[k], "cells": got.numel(),
          **checked, "max_abs_err": (got - want).abs().max().item(),
          **timed, **bound(b * (F * D * 2 + npair * 4), 2 * npair * D * b,
                           BF16_FLOPS)}
      emit(row)
      if b == SERVE_BATCH and k == -1:
        main = row
  fwd_edges(torch, ci, "interact_fwd")
  return main


def bwd_check(torch, ci, name, got, want, d_acts, feats, k) -> tuple:
  """K2-bwd's and K3-bwd's tolerance class: at least 99.9% of the cells
  bit-equal, every cell within one bf16 ulp or, where its F terms cancel,
  within the f32 summation bound ``F * 2^-24 * sum_q |c_pq x_q|``.
  ``feats``: the ``[B, F, D]`` inputs. Returns (cells that differ, the
  largest share of its allowance a cell takes)."""
  b, f, d = feats.shape
  coef = ci.pair_coefficients(d_acts, f, k)
  abs_sum = torch.bmm(coef.abs(), feats.float().abs())
  differ, worst = within_one_bf16_ulp(torch, got, want,
                                      slack=f * 2.0**-24 * abs_sum)
  check(differ <= 0.001 * got.numel() and worst <= 1.0,
        f"{name} B={b} F={f} D={d} k={k}: {differ} of {got.numel()} cells "
        f"differ, worst by {worst} of its allowance")
  return differ, worst


def bwd_edges(torch, ci, name: str) -> None:
  """K2-bwd (``interact_bwd``) or K3-bwd (``interact_flat_bwd``) at the
  edge shapes, B=1000, k in {-1, 0}, in the tolerance class of
  :func:`bwd_check`; checked, not timed."""
  cases = []
  for f in BWD_EDGE_F:
    for d in BWD_EDGE_D:
      for k in (-1, 0):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 97 * f + d - k)
        feats = (torch.randn((BWD_EDGE_B, f, d), generator=gen,
                             device="cuda") * 0.3).to(torch.bfloat16)
        npair = len(ci.tril_pairs(f, k)[0])
        d_acts = torch.randn((BWD_EDGE_B, npair), generator=gen,
                             device="cuda")
        if name == "interact_flat_bwd":
          got = ci.interact_flat_bwd(d_acts, feats, k).float()
          torch.cuda.synchronize()
          want = ci.interact_flat_bwd_plain(d_acts, feats, k).float()
        else:
          parts = [feats[:, p].contiguous() for p in range(f)]
          got = torch.stack(ci.interact_parts_bwd(d_acts, parts, k), 1).float()
          torch.cuda.synchronize()
          want = torch.stack(ci.interact_parts_bwd_plain(d_acts, parts, k),
                             1).float()
        check(tuple(got.shape) == (BWD_EDGE_B, f, d),
              f"{name} F={f} D={d}: shape {tuple(got.shape)}")
        cases.append([f, d, k, *bwd_check(torch, ci, name, got, want,
                                          d_acts, feats, k)])
  emit({"phase": "kernel", "name": name, "stream": "edges",
        "B": BWD_EDGE_B, "F_D_k_differ_allowance_share": cases})


def phase_kernel_bwd(torch, ci, flush) -> dict:
  """K2-bwd against its plain version; returns the train-shape row."""
  main = None
  for b in KERNEL_BATCHES:
    for k in (-1, 0):
      parts = bf16_parts(torch, b, SEED + 7 * b - k)
      npair = len(ci.tril_pairs(F, k)[0])
      gen = torch.Generator(device="cuda").manual_seed(SEED + b + k)
      d_acts = torch.randn((b, npair), generator=gen, device="cuda")
      got = torch.stack(ci.interact_parts_bwd(d_acts, parts, k), 1).float()
      torch.cuda.synchronize()
      want = torch.stack(ci.interact_parts_bwd_plain(d_acts, parts, k),
                         1).float()
      feats = torch.stack(parts, dim=1)
      check(tuple(got.shape) == (b, F, D), f"shape {tuple(got.shape)}")
      differ, worst = bwd_check(torch, ci, "interact_bwd", got, want, d_acts,
                                feats, k)
      coef_bf16 = ci.pair_coefficients(d_acts, F, k).to(torch.bfloat16)
      timed = event_ms(torch, {
          "kernel_ms": lambda: ci.interact_parts_bwd(d_acts, parts, k),
          "plain_ms": lambda: ci.interact_parts_bwd_plain(d_acts, parts, k),
          "library_ms": lambda: torch.bmm(coef_bf16, feats)}, flush)
      row = {
          "phase": "kernel", "name": "interact_bwd", "B": b, "F": F, "D": D,
          "k": k, "cells": got.numel(), "cells_differ": differ,
          "max_allowance_share": worst,
          "max_abs_err": (got - want).abs().max().item(), **timed,
          **bound(b * (npair * 4 + 2 * F * D * 2), 2 * F * F * D * b,
                  BF16_FLOPS)}
      emit(row)
      if b == TRAIN_BATCH and k == -1:
        main = row
  bwd_edges(torch, ci, "interact_bwd")
  return main


def k1_streams(torch, rows: int) -> dict:
  """The K1 id streams: name -> int64 ids on the card (seed 0). The last,
  every id on one row, is the worst case of the kernel's tile accounting
  (each tile's whole sorted list one run, cut at every warp's range)."""
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  n = K1_IDS
  r = torch.rand((n,), generator=gen, device="cuda", dtype=torch.float64)
  gamma = -0.05  # the power law of tests/pallas_goldens.py
  power = ((r * ((rows + 1.0) ** gamma - 1.0) + 1.0) ** (1.0 / gamma))
  margin = rows // 10
  return {
      "uniform": torch.randint(0, rows, (n,), generator=gen, device="cuda"),
      "power_law": (power.long() - 1).clamp(0, rows - 1),
      "out_of_range": torch.randint(-margin, rows + margin, (n,),
                                    generator=gen, device="cuda"),
      "unique": torch.randperm(rows, generator=gen, device="cuda")[:n],
      "one_row": torch.full((n,), rows // 2, dtype=torch.int64,
                            device="cuda"),
  }


def k1_plan_check(torch, ca, n: int) -> dict:
  """The launcher's tile plan for ``n`` occurrences on this card, read back
  from the library, against ``cuda_apply.plan_apply``; returns it."""
  import ctypes

  from distributed_embeddings_torch.ops._build import load
  fn = load("apply_rows").apply_rows_plan
  fn.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
  fn.restype = ctypes.c_int
  got = (ctypes.c_int * 3)()
  check(fn(n, got) == 0, "apply_rows_plan failed")
  want = ca.plan_apply(D, n, torch.cuda.get_device_properties(0)
                       .multi_processor_count)
  check(list(got) == [want.tile, want.slots, want.smem],
        f"apply_rows: the launcher plans {list(got)} for n={n}, "
        f"plan_apply {want}")
  return want._asdict()


def phase_kernel_apply(torch, ca, flush, rows: int) -> dict:
  """K1 against its plain version on the first sparse class's buffer of
  the train plan; returns the uniform stream's row."""
  gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
  base = torch.rand((rows, D), generator=gen, device="cuda")
  work = torch.empty_like(base)
  main = None
  for name, ids in k1_streams(torch, rows).items():
    delta = torch.randn((ids.shape[0], D), generator=gen, device="cuda")
    work.copy_(base)
    got = ca.apply_rows(work, ids, delta, K1_SCALE)
    torch.cuda.synchronize()
    want = ca.apply_rows_plain(base.clone(), ids, delta, K1_SCALE)
    valid = (ids >= 0) & (ids < rows)
    ids_v, delta_v = ids[valid], delta[valid]
    if name == "unique":
      check(torch.equal(got, want),
            "apply_rows: a stream of unique ids is not bit-equal to the "
            "plain version")
      share = 0.0
    else:
      abs_sum = base.abs().index_add_(0, ids_v, (K1_SCALE * delta_v).abs())
      share = ((got - want).abs() / (1e-5 * abs_sum).clamp(min=1e-30)) \
          .max().item()
      del abs_sum
      check(share <= 1.0, f"apply_rows {name}: off by {share} x 1e-5 of "
            "the cells' absolute sums")
    touched = torch.zeros((rows,), dtype=torch.bool, device="cuda")
    touched[ids_v] = True
    check(torch.equal(got[~touched], base[~touched]),
          f"apply_rows {name}: a row no id touches changed")
    del touched
    max_err = (got - want).abs().max().item()
    del want
    n_valid = int(valid.sum().item())
    unique = int(torch.unique(ids_v).numel())
    lib = base.clone()
    timed = event_ms(torch, {
        "kernel_ms": lambda: ca.apply_rows(work, ids, delta, K1_SCALE),
        "plain_ms": lambda: ca.apply_rows_plain(work, ids, delta, K1_SCALE),
        "library_ms": lambda: lib.index_add_(0, ids_v, delta_v,
                                             alpha=K1_SCALE)}, flush)
    del lib
    row = {"phase": "kernel", "name": "apply_rows", "stream": name,
           "plan": k1_plan_check(torch, ca, int(ids.shape[0])),
           "rows": rows, "width": D, "ids": int(ids.shape[0]),
           "valid_ids": n_valid, "unique_rows": unique,
           "max_abs_err": max_err, "max_abs_sum_share": share, **timed,
           **bound(ids.shape[0] * 8 + n_valid * D * 4 + unique * D * 4 * 2,
                   2 * n_valid * D, F32_FLOPS)}
    emit(row)
    if name == "uniform":
      main = row
  return main


def phase_golden(torch, golden) -> None:
  data = golden.load()
  for q in golden.QUANTIZE:
    acts, preds = golden.replay(data, q, device="cuda")
    want_acts = data[f"acts/{q}"]
    check(acts.shape == want_acts.shape, f"golden {q} acts shape")
    check((acts.view("int32") == want_acts.view("int32")).all(),
          f"golden {q}: activations differ from the JAX serve step")
    want = data[f"preds/{q}"]
    err = abs(preds - want)
    tol = golden.PRED_TOL["atol"] + golden.PRED_TOL["rtol"] * abs(want)
    check(preds.shape == want.shape and bool((err <= tol).all()),
          f"golden {q}: predictions off by up to {err.max()}")
    emit({"phase": "golden", "quantize": q, "acts_bit_equal": True,
          "pred_max_abs_err": float(err.max()), "tol": golden.PRED_TOL})


def phase_train_golden(torch) -> None:
  from distributed_embeddings_torch import train_golden
  data = train_golden.load()
  losses, got = train_golden.replay(data, device="cuda")
  try:
    worst = train_golden.compare(data, losses, got)
  except AssertionError as exc:
    raise SmokeFailure(f"train golden: {exc}") from exc
  emit({"phase": "train_golden", "losses": losses,
        "want_losses": [float(v) for v in data["losses"]], **worst,
        "loss_tol": train_golden.LOSS_TOL,
        "update_tol": train_golden.UPDATE_TOL})


def plain_forward(torch, ci, model, numerical, acts):
  """The DLRM forward with the plain interaction in place of K2-fwd."""
  cd = model.compute_dtype
  bottom = model.bottom_mlp(numerical.to(cd))
  parts = [bottom.to(torch.bfloat16)] + [a.to(torch.bfloat16) for a in acts]
  x = torch.cat([ci.interact_parts_fwd_plain(parts, -1), bottom.float()], 1)
  return model.top_mlp(x.to(cd)).squeeze(-1).float()


def trace_call(torch, fn, kernels=None) -> dict:
  """One call of ``fn`` under ``torch.profiler``: its host wall time, the
  device's busy time (kernels, copies and fills on the card) and idle
  share, the device operations it ran and the costliest of them; with
  ``kernels`` (label -> substrings of device kernel names), each label's
  device ms and launches in ``kernel_device_ms``."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  spans, by_name = [], {}
  mine = {label: [0.0, 0] for label in kernels or {}}
  for e in prof.events():
    if e.device_type == DeviceType.CUDA:
      spans.append((e.time_range.start, e.time_range.end))
      ms = (e.time_range.end - e.time_range.start) / 1e3
      by_name[e.name] = by_name.get(e.name, 0.0) + ms
      for label, subs in (kernels or {}).items():
        if any(sub in e.name for sub in subs):
          mine[label][0] += ms
          mine[label][1] += 1
  busy_us, end = 0.0, float("-inf")
  for s, e in sorted(spans):  # union of the device intervals
    busy_us += max(0.0, e - max(s, end))
    end = max(end, e)
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
  # NCCL's own kernels (the profiler also lists each collective under an
  # annotation of the same span, which is not counted twice)
  nccl_ms = sum(ms for name, ms in by_name.items()
                if name.startswith(("ncclDevKernel", "ncclKernel")))
  # the device time each PyTorch operator launched itself (its kernels,
  # copies and fills), by operator name
  by_op = []
  for avg in prof.key_averages():
    ms = getattr(avg, "self_device_time_total", 0.0) / 1e3
    if ms > 0 and avg.device_type != DeviceType.CUDA:
      by_op.append((avg.key, ms, avg.count))
  by_op.sort(key=lambda t: -t[1])
  out = {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
         "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
         "device_ops": len(spans), "nccl_ms": nccl_ms,
         "top_ms": [[name[:72], ms] for name, ms in top],
         "top_ops_ms": [[name[:48], ms, n] for name, ms, n in by_op[:12]]}
  if kernels:
    out["kernel_device_ms"] = {label: {"ms": ms, "launches": n}
                               for label, (ms, n) in mine.items()}
  return out


def criteo_vocab() -> list:
  return [max(4, int(v / 16)) for v in CRITEO_1TB_VOCAB]


def sgd_factory(torch):
  return functools.partial(torch.optim.SGD, lr=TRAIN_LR)


def serve_setup(torch) -> dict:
  """The full-width serve cell's plan, model, train state and requests
  (``phase_serve`` and ``phase_serve_artifact`` serve the same)."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM, dlrm_embedding_plan
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.training import init_sparse_state_direct

  vocab = criteo_vocab()
  plan = dlrm_embedding_plan(vocab, D, dense_row_threshold=4096)
  rule = sgd_rule(TRAIN_LR)
  model = DLRM(vocab, D, compute_dtype=torch.bfloat16, tables=False,
               device="cuda", generator=torch.Generator().manual_seed(SEED))
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  rng = np.random.default_rng(SEED)
  requests = [(rng.standard_normal((SERVE_BATCH, 13)).astype(np.float32),
               [rng.integers(0, v, SERVE_BATCH).astype(np.int32)
                for v in vocab]) for _ in range(SERVE_REQUESTS)]
  return {"vocab": vocab, "plan": plan, "rule": rule, "model": model,
          "state": state, "init_s": init_s, "requests": requests}


def phase_serve(torch, ci, smi: str, setup: dict) -> tuple:
  """The full-width serve path; returns each kernel's launches in it and
  each image's predictions of the requests."""
  import numpy as np

  from distributed_embeddings_torch.serving import (
      ServeEngine,
      freeze,
      make_serve_step,
      shard_batch,
  )
  from distributed_embeddings_torch.serving.golden import PRED_TOL, EmbActs

  vocab, plan, rule = setup["vocab"], setup["plan"], setup["rule"]
  model, state, requests = setup["model"], setup["state"], setup["requests"]
  init_s = setup["init_s"]
  dense_tables = sum(len(cp.shards_per_rank[0])
                     for cp in plan.classes.values() if cp.kind == "dense")
  by_image = {}
  want = expect(interact_fwd=SERVE_REQUESTS)
  totals = expect()
  for q in ("f32", "int8"):
    t0 = time.perf_counter()
    frozen = freeze(plan, rule, state, quantize=q)
    torch.cuda.synchronize()
    freeze_s = time.perf_counter() - t0
    image_bytes = sum(b.numel() * b.element_size()
                      for blocks in frozen.device_blocks.values()
                      for b in blocks)
    eng = ServeEngine(model, plan, frozen, device="cuda")
    reset_counts()
    preds, ms = [], []
    for numerical, cats in requests:
      t0 = time.perf_counter()
      preds.append(eng.predict(numerical, cats))
      ms.append((time.perf_counter() - t0) * 1e3)
    got = read_counts()
    check(got == want, f"serve {q}: launches {got} for {SERVE_REQUESTS} "
          f"requests, expected {want}")
    add_counts(totals, got)
    acts_step = make_serve_step(EmbActs(), plan, eng.meta)
    worst = 0.0
    for (numerical, cats), p in zip(requests, preds):
      check(p.shape == (SERVE_BATCH,) and np.isfinite(p).all(),
            f"serve {q}: predictions not finite [{SERVE_BATCH}]")
      num_d, cats_d = shard_batch((numerical, tuple(cats)), None, "cuda")
      with torch.inference_mode():
        acts = acts_step(eng.state, num_d, cats_d)
        ref = plain_forward(torch, ci, model, num_d, acts).cpu().numpy()
      err = np.abs(p - ref)
      check(bool((err <= PRED_TOL["atol"]
                  + PRED_TOL["rtol"] * np.abs(ref)).all()),
            f"serve {q}: kernel path vs plain interaction off by "
            f"{err.max()}")
      worst = max(worst, float(err.max()))
    emit({"phase": "serve", "quantize": q, "card": smi,
          "tables": len(vocab), "dense_class_tables": dense_tables,
          "rows": int(sum(vocab)),
          "image_bytes": image_bytes, "batch": SERVE_BATCH,
          "requests": SERVE_REQUESTS, "request_ms": ms,
          "p50_ms": statistics.median(ms), "launches": got,
          "max_abs_err_vs_plain": worst, "init_s": init_s,
          "freeze_s": freeze_s,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "serve_trace", "quantize": q, "card": smi,
          **trace_call(torch, lambda: eng.predict(*requests[0]),
                       kernels=K2_FWD_TRACE)})
    by_image[q] = preds
    del eng, frozen
    torch.cuda.empty_cache()
  return totals, by_image


def dir_bytes(path: str) -> tuple:
  """Bytes and files under ``path``."""
  import os
  files = [os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs]
  return sum(os.path.getsize(f) for f in files), len(files)


def phase_serve_artifact(torch, smi: str, setup: dict,
                         frozen_preds: dict) -> tuple:
  """The README's serving snippet at world 1: per image, ``export`` the
  serve cell's state to disk, ``verify`` and ``load`` it, build a
  ``ServeEngine`` on the artifact and answer the serve phase's requests:
  bit-equal to the ``FrozenTables`` engine's predictions, and for f32 to
  ``make_sparse_eval_step``'s. Returns each kernel's launches in the
  answers and the f32 artifact's engine (the batcher phase serves it)."""
  import shutil
  import tempfile

  import numpy as np

  from distributed_embeddings_torch import checkpoint
  from distributed_embeddings_torch.serving import ServeEngine, export, load
  from distributed_embeddings_torch.training import (
      make_sparse_eval_step,
      shard_batch,
  )

  plan, rule, model = setup["plan"], setup["rule"], setup["model"]
  state, requests = setup["state"], setup["requests"]
  want = expect(interact_fwd=SERVE_REQUESTS)
  totals = expect()
  engines = {}
  for q in ("f32", "int8"):
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    path = f"{root}/artifact"
    t0 = time.perf_counter()
    export(path, plan, rule, state, quantize=q, extra={"cell": "serve"})
    export_s = time.perf_counter() - t0
    nbytes, nfiles = dir_bytes(path)
    free = shutil.disk_usage(root).free
    t0 = time.perf_counter()
    problems = checkpoint.verify(path)
    verify_s = time.perf_counter() - t0
    check(problems == [], f"serve_artifact {q}: verify found {problems}")
    t0 = time.perf_counter()
    art = load(path, plan, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng = ServeEngine(model, plan, art, device="cuda")
    reset_counts()
    preds, ms = [], []
    for numerical, cats in requests:
      t0 = time.perf_counter()
      preds.append(eng.predict(numerical, cats))
      ms.append((time.perf_counter() - t0) * 1e3)
    got = read_counts()
    check(got == want, f"serve_artifact {q}: launches {got} for "
          f"{SERVE_REQUESTS} requests, expected {want}")
    add_counts(totals, got)
    for i, (p, f) in enumerate(zip(preds, frozen_preds[q])):
      check(p.shape == (SERVE_BATCH,) and np.isfinite(p).all(),
            f"serve_artifact {q}: predictions not finite [{SERVE_BATCH}]")
      check(np.array_equal(p.view(np.int32), f.view(np.int32)),
            f"serve_artifact {q} request {i}: the artifact engine's "
            "predictions differ from the FrozenTables engine's")
    line = {"phase": "serve_artifact", "quantize": q, "card": smi,
            "bytes": nbytes, "files": nfiles, "export_s": export_s,
            "verify_s": verify_s, "load_s": load_s,
            "disk_free_bytes": free, "request_ms": ms,
            "bit_equal_frozen": True, "launches": got}
    if q == "f32":
      ev = make_sparse_eval_step(model, plan, rule)
      for i, (numerical, cats) in enumerate(requests):
        with torch.inference_mode():
          ref = ev(state, *shard_batch((numerical, cats), None,
                                       "cuda")).cpu().numpy()
        check(np.array_equal(preds[i].view(np.int32), ref.view(np.int32)),
              f"serve_artifact f32 request {i}: predictions differ from "
              "make_sparse_eval_step's by up to "
              f"{np.abs(preds[i] - ref).max()}")
      line["bit_equal_eval"] = True
      engines[q] = eng
    emit(line)
    shutil.rmtree(root)
    del art
    torch.cuda.empty_cache()
  return totals, engines["f32"]


def phase_serve_batcher(torch, smi: str, eng, vocab) -> dict:
  """The f32 artifact engine behind a ``MicroBatcher`` (max_batch 4096,
  max_delay 2 ms): ``BATCHER_THREADS`` submitters send requests of
  1-512 rows as Poisson arrivals, at each offered rate of
  ``BATCHER_RATES``. Per rate: request latency percentiles, dispatches,
  the mean fill of a dispatch, rejections by reason (their sum is the
  total), the flusher's time in a dispatch against the completer's wait
  for the device. Each future's rows agree with ``predict`` of the same
  rows within ``serving.golden.PRED_TOL``, and K2-fwd launched once per
  dispatch. Returns each kernel's launches over the rates."""
  import threading

  import numpy as np

  from distributed_embeddings_torch.serving import (
      REJECT_REASONS,
      MicroBatcher,
      Rejected,
  )
  from distributed_embeddings_torch.serving.golden import PRED_TOL

  rng = np.random.default_rng(SEED + 7)
  pool = BATCHER_POOL * SERVE_BATCH
  numerical = rng.standard_normal((pool, 13)).astype(np.float32)
  cats = [rng.integers(0, v, pool).astype(np.int32) for v in vocab]
  ref = np.concatenate([
      eng.predict(numerical[i:i + SERVE_BATCH],
                  [c[i:i + SERVE_BATCH] for c in cats])
      for i in range(0, pool, SERVE_BATCH)])
  totals = expect()
  for rate in BATCHER_RATES:
    dispatch_ms = []

    def timed_dispatch(n, c):
      t0 = time.perf_counter()
      out = eng.dispatch(n, c)
      dispatch_ms.append((time.perf_counter() - t0) * 1e3)
      return out

    mb = MicroBatcher(timed_dispatch, max_batch=SERVE_BATCH,
                      max_delay_s=BATCHER_DELAY_S)
    plan_rng = np.random.default_rng(SEED + rate)
    per_thread = BATCHER_REQUESTS // BATCHER_THREADS
    schedules = []
    for _ in range(BATCHER_THREADS):
      gaps = plan_rng.exponential(BATCHER_THREADS / rate, per_thread)
      sizes = plan_rng.integers(1, BATCHER_MAX_ROWS + 1, per_thread)
      starts = plan_rng.integers(0, pool - BATCHER_MAX_ROWS, per_thread)
      schedules.append((np.cumsum(gaps), sizes, starts))
    results = [[] for _ in range(BATCHER_THREADS)]
    shed = [{r: 0 for r in REJECT_REASONS} for _ in range(BATCHER_THREADS)]

    def submitter(k, t0):
      at, sizes, starts = schedules[k]
      for t, n, a in zip(at, sizes, starts):
        wait = t0 + t - time.perf_counter()
        if wait > 0:
          time.sleep(wait)
        try:
          fut = mb.submit(numerical[a:a + n], [c[a:a + n] for c in cats])
        except Rejected as e:
          shed[k][e.reason] += 1
          continue
        results[k].append((a, n, fut))

    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(k, t0))
               for k in range(BATCHER_THREADS)]
    for t in threads:
      t.start()
    for t in threads:
      t.join()
    lat, worst = [], 0.0
    for k in range(BATCHER_THREADS):
      for a, n, fut in results[k]:
        try:
          out = fut.result(timeout=120)
        except Rejected as e:
          shed[k][e.reason] += 1
          continue
        err = np.abs(out - ref[a:a + n])
        check(out.shape == (n,) and bool(
            (err <= PRED_TOL["atol"] + PRED_TOL["rtol"]
             * np.abs(ref[a:a + n])).all()),
              f"serve_batcher {rate}/s: a request's rows differ from "
              f"predict's by up to {err.max()}")
        worst = max(worst, float(err.max()))
        lat.append(fut.latency_s * 1e3)
    wall_s = time.perf_counter() - t0
    mb.close()
    got = read_counts()
    stats = mb.stats
    shed = {r: sum(t[r] for t in shed) for r in REJECT_REASONS}
    check(got == expect(interact_fwd=stats["batches"]),
          f"serve_batcher {rate}/s: launches {got} for {stats['batches']} "
          "dispatches")
    check(stats["rejected"] == sum(stats[f"rejected/{r}"]
                                   for r in REJECT_REASONS)
          and all(stats[f"rejected/{r}"] == shed[r] for r in REJECT_REASONS),
          f"serve_batcher {rate}/s: rejections {shed} vs stats {stats}")
    check(stats["completed"] == len(lat) and stats["submitted"]
          == BATCHER_THREADS * per_thread,
          f"serve_batcher {rate}/s: stats {stats}, {len(lat)} answered")
    add_counts(totals, got)
    rows = int(sum(n for res in results for _, n, _ in res))
    dequant = mb.telemetry.histogram("serve/stage_s/dequant")
    emit({"phase": "serve_batcher", "card": smi,
          "offered_requests_per_s": rate,
          "offered_rows_per_s": rate * (BATCHER_MAX_ROWS + 1) / 2,
          "threads": BATCHER_THREADS, "max_batch": SERVE_BATCH,
          "max_delay_s": BATCHER_DELAY_S, "requests": len(lat),
          "wall_s": wall_s, "answered_rows_per_s": rows / wall_s,
          "p50_ms": float(np.percentile(lat, 50)),
          "p99_ms": float(np.percentile(lat, 99)),
          "p999_ms": float(np.percentile(lat, 99.9)),
          "dispatches": stats["batches"],
          "mean_fill": rows / (stats["batches"] * SERVE_BATCH),
          "rejected": stats["rejected"],
          "rejected_by_reason": {r: stats[f"rejected/{r}"]
                                 for r in REJECT_REASONS},
          "dispatch_ms_median": statistics.median(dispatch_ms),
          "complete_wait_ms_p50": dequant.p50 * 1e3,
          "max_abs_err_vs_predict": worst, "launches": got})
  return totals


def train_plan(vocab=None, oov: str = "clip", **plan_kw):
  """The train cell's plan (``bench.py``'s: ``dlrm_embedding_plan`` of the
  Criteo tables x 1/16, width 128, ``dense_row_threshold=4096``,
  ``batch_hint=65536``), over ``vocab`` when given, with the ``oov``
  policy (``plan_kw``: more plan knobs)."""
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  return DistEmbeddingStrategy(
      [TableConfig(input_dim=int(v), output_dim=D)
       for v in vocab or criteo_vocab()], 1, "basic",
      dense_row_threshold=4096, batch_hint=TRAIN_BATCH, oov=oov, **plan_kw)


def first_sparse_class(plan):
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_param_name,
      padded_rows,
  )
  key = next(k for k in plan.class_keys if plan.classes[k].kind == "sparse")
  return key, class_param_name(*key), padded_rows(plan, key)


def phase_train(torch, smi: str, compute: str) -> dict:
  """``bench.py``'s train step at full width; returns each kernel's
  launches in the run."""
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  vocab = criteo_vocab()
  plan = train_plan()
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  check(n_sparse == 4, f"the train plan has {n_sparse} sparse classes, "
        "expected 4")
  dtype = torch.float32 if compute == "f32" else torch.bfloat16
  model = DLRM(vocab, D, compute_dtype=dtype, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  b = TRAIN_BATCH
  numerical = torch.randn((b, 13), generator=gen, device="cuda")
  cats = [torch.randint(0, v, (b,), generator=gen, device="cuda",
                        dtype=torch.int32) for v in vocab]
  labels = torch.randint(0, 2, (b,), generator=gen, device="cuda").float()

  # sampled rows of the first sparse class: touched and not by the batch
  key, name, rows = first_sparse_class(plan)
  ids = [v for bk, v in DistributedLookup(plan).route_ids(cats).items()
         if bk.class_key == key]
  touched = torch.zeros((rows,), dtype=torch.bool, device="cuda")
  for v in ids:
    touched[v.reshape(-1)] = True
  pick = torch.Generator(device="cuda").manual_seed(SEED + 2)
  hit = torch.nonzero(touched).squeeze(1)
  miss = torch.nonzero(~touched).squeeze(1)
  hit = hit[torch.randperm(hit.numel(), generator=pick,
                           device="cuda")[:ROWS_SAMPLED]]
  miss = miss[torch.randperm(miss.numel(), generator=pick,
                             device="cuda")[:ROWS_SAMPLED]]
  buf = state["fused"][name]
  miss_rows = buf[miss].clone()

  step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                rule)
  ms, losses, changed = [], [], []
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows=n_sparse)
  totals = expect()
  for i in range(TRAIN_WARMUP + TRAIN_TIMED):
    hit_rows = buf[hit].clone()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, numerical, cats, labels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = read_counts()
    check(got == want, f"train {compute} step {i}: launches {got}, "
          f"expected {want}")
    add_counts(totals, got)
    if i >= TRAIN_WARMUP:
      ms.append((t1 - t0) * 1e3)
    losses.append(float(loss))
    check(losses[-1] == losses[-1] and abs(losses[-1]) < float("inf"),
          f"train {compute} step {i}: loss {losses[-1]}")
    check(torch.equal(buf[miss], miss_rows),
          f"train {compute} step {i}: rows the batch does not touch changed")
    changed.append((buf[hit] != hit_rows).any(dim=1).float().mean().item())
    check(changed[-1] > 0.5,
          f"train {compute} step {i}: only {changed[-1]:.1%} of the "
          "sampled touched rows changed")
  peak = torch.cuda.max_memory_allocated() / 2**30
  med = statistics.median(ms)
  emit({"phase": "train", "compute": compute, "card": smi,
        "batch": b, "sparse_classes": n_sparse,
        "dense_class_tables": sum(len(cp.shards_per_rank[0])
                                  for cp in plan.classes.values()
                                  if cp.kind == "dense"),
        "fused_bytes": sum(t.numel() * 4 for t in state["fused"].values()),
        "init_s": init_s, "step_ms": ms, "step_ms_median": med,
        "samples_per_s": b / (med / 1e3), "peak_gib": peak,
        "launches_per_step": want,
        "losses": losses, "touched_rows_changed_share": changed,
        "untouched_rows_bit_equal": True})
  trace = trace_call(torch, lambda: step(state, numerical, cats, labels),
                     kernels=K2_FWD_TRACE)
  check(trace["kernel_device_ms"]["interact_fwd"]["launches"] == 1,
        f"train_trace {compute}: "
        f"{trace['kernel_device_ms']['interact_fwd']['launches']} device "
        "launches of interact_fwd in the traced step, expected 1")
  emit({"phase": "train_trace", "compute": compute, "card": smi, **trace})
  del state, buf, step
  torch.cuda.empty_cache()
  return totals


def world4_plan(backend: str, overlap: str = "fused", scale=None,
                **wire_kw):
  """The world-4 plan of ``examples/dlrm/main.py --sparse``: 26 Criteo-1TB
  tables of width 128, ``memory_balanced``, ``dense_row_threshold=4096``,
  row-sliced as ``backend``'s configuration says, under ``overlap``, the
  vocabulary cut by ``scale`` (default: ``backend``'s); ``wire_kw`` sets
  the wire compression (``wire_dtype``, ``dedup_exchange``,
  ``dedup_capacity``)."""
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  scale = scale or W4_VOCAB_SCALE[backend]
  vocab = [max(4, int(v / scale)) for v in CRITEO_1TB_VOCAB]
  plan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=D) for v in vocab], WORLD,
      "memory_balanced", dense_row_threshold=4096,
      row_slice_threshold=W4_ROW_SLICE[backend], batch_hint=W4_BATCH,
      overlap=overlap, exchange_chunks=1 if overlap == "none" else W4_CHUNKS,
      **wire_kw)
  return vocab, plan


def w4_block_rows(plan, key, bucket) -> int:
  """The rows of one (round) block a rank gathers for a sparse bucket of
  the world-4 plan: ``B_local`` routed ids, or under ``dedup_exchange``
  the unique capacity ``K = min(n_b * B_local, sentinel + 1)`` (the
  plan's ``dedup_capacity`` below it); every input is one-hot."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      padded_rows,
  )
  b = W4_BATCH // WORLD
  if not plan.dedup_exchange:
    return b
  k = min(bucket.n_b * b, padded_rows(plan, key) + 1)
  cap = plan.dedup_capacity
  return k if cap is None else min(k, cap)


def k4_classes(plan, rule=None) -> set:
  """The sparse classes whose round gathers take K4 under ``'fused'``:
  ``_fused_gather``'s condition (``parallel/lookup_engine.py``), an f32 or
  bf16 layout of one fused row per physical row (``rows_per_phys == 1``;
  a bf16 buffer takes K4's bf16 form, the same count; a
  window-masked gather has more). A narrow class (column slices, Tiny's
  widths: several rows per physical row) gathers without K4. ``rule``:
  the state's (SGD by default)."""
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
  )
  layouts = DistributedLookup(plan).fused_layouts(rule or sgd_rule(TRAIN_LR))
  return {key for key in plan.class_keys
          if plan.classes[key].kind == "sparse"
          and layouts[class_param_name(*key)].rows_per_phys == 1}


def k4_launches_per_step(plan, rule=None) -> int:
  """K4 launches the fused schedule makes per rank and forward of one-hot
  inputs: one per (bucket, round, chunk) of each class of
  :func:`k4_classes`, the chunks cut from the block's rows
  (:func:`w4_block_rows`: the unique capacity under ``dedup_exchange``);
  0 under the other schedules, which gather without K4."""
  return k4_forward_launches(plan, None, rule)


def k4_empty_kernel(torch, n: int, stride: int):
  """A launcher of an empty kernel with the grid of K4's gather of ``n``
  ids of ``stride`` lanes: K4's library's yardstick of the card's
  dispatch floor for that grid."""
  import ctypes

  from distributed_embeddings_torch.ops._build import load
  fn = load("gather_rows").gather_rows_empty_launch
  fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
  fn.restype = ctypes.c_int

  def launch():
    err = fn(n, stride, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"gather_rows_empty_launch failed: cudaError {err}")
  return launch


def k4_bad_ids(torch, ids, rows: int, gen):
  """``ids`` with K4_BAD_SHARE of them replaced by sentinels and ids out of
  range (what row slicing sends)."""
  n = ids.shape[0]
  bad = torch.rand((n,), generator=gen, device="cuda") < K4_BAD_SHARE
  junk = torch.tensor([rows, -1, rows + 7, 2**31 - 1, -2**31],
                      dtype=torch.int32, device="cuda")[
      torch.randint(0, 5, (n,), generator=gen, device="cuda")]
  return torch.where(bad, junk, ids)


def phase_kernel_gather(torch, cx, flush) -> dict:
  """K4 against its plain version at the four-card world-4 path's block
  shape: the first sparse class's rank buffer, one (round, chunk) block of
  its first bucket's ids. A uniform stream and one with 30% of its ids out
  of range or sentinels (what row slicing sends); the uniform stream
  timed beside four yardsticks in the same calls: the kernel on the same
  ids mapped into a 65,536-row buffer (32 MB: every row in TLB reach,
  the L2 still flushed), the kernel on the ids sorted, an empty kernel
  of the kernel's grid (the dispatch floor), and a contiguous copy of
  ``n`` rows (the streaming floor). Then bit-equal edge blocks (1, 31
  and 8,193 ids, every id one row). Returns the uniform stream's row."""
  from distributed_embeddings_torch.ops.packed_table import PackedLayout
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
  )
  _, plan = world4_plan("nccl")
  key, _, rows = first_sparse_class(plan)
  n_b = class_buckets(plan, key, lambda i: 1)[0].n_b
  n = n_b * (W4_BATCH // WORLD // W4_CHUNKS)
  layout = PackedLayout(rows=rows, width=D)
  gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
  buf = torch.rand((rows, D), generator=gen, device="cuda")
  main = None
  for stream in ("uniform", "out_of_range"):
    # int32, as the wire carries the routed ids
    ids = torch.randint(0, rows, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if stream == "out_of_range":
      ids = k4_bad_ids(torch, ids, rows, gen)
    got = cx.gather_rows(layout, buf, ids)
    torch.cuda.synchronize()
    want = cx.gather_rows_plain(buf, ids)
    check(torch.equal(got, want),
          f"gather_rows {stream}: not bit-equal to the plain version")
    n_valid = int(((ids >= 0) & (ids < rows)).sum().item())
    fns = {
        "kernel_ms": lambda: cx.gather_rows(layout, buf, ids),
        "plain_ms": lambda: cx.gather_rows_plain(buf, ids),
        # moves the same bytes, but reads row rows-1 for the out-of-range
        # ids instead of writing zeros
        "library_ms": lambda: buf.index_select(0, ids.clamp(0, rows - 1))}
    if stream == "uniform":
      small = PackedLayout(rows=K4_SMALL_ROWS, width=D)
      small_buf, small_ids = buf[:K4_SMALL_ROWS], ids % K4_SMALL_ROWS
      sorted_ids = torch.sort(ids).values
      for yard_ids, yard_buf, yard_layout in ((small_ids, small_buf, small),
                                              (sorted_ids, buf, layout)):
        check(torch.equal(cx.gather_rows(yard_layout, yard_buf, yard_ids),
                          cx.gather_rows_plain(yard_buf, yard_ids)),
              "gather_rows yardstick: not bit-equal to the plain version")
      copy_out = torch.empty((n, D), device="cuda")
      fns.update({
          "tlb_reach_ms": lambda: cx.gather_rows(small, small_buf,
                                                 small_ids),
          "sorted_ms": lambda: cx.gather_rows(layout, buf, sorted_ids),
          "empty_grid_ms": k4_empty_kernel(torch, n, D),
          "stream_copy_ms": lambda: copy_out.copy_(buf[:n])})
    timed = event_ms(torch, fns, flush)
    row = {"phase": "kernel", "name": "gather_rows", "stream": stream,
           "rows": rows, "width": D, "ids": n, "valid_ids": n_valid,
           "bit_equal": True, "max_abs_err": 0.0, **timed,
           "library_note": "index_select of clamped ids: no zero rows",
           **bound(n * 4 + n_valid * D * 4 + n * D * 4, 0, F32_FLOPS)}
    if stream == "uniform":
      row["stream_copy_bound_ms"] = bound(2 * n * D * 4, 0,
                                          F32_FLOPS)["bound_ms"]
    emit(row)
    if stream == "uniform":
      main = row
  # edge blocks on the same buffer, bit-equal, not timed
  edges = []
  for m in K4_EDGE_N:
    ids = k4_bad_ids(torch, torch.randint(0, rows, (m,), generator=gen,
                                          device="cuda", dtype=torch.int32),
                     rows, gen)
    edges.append([f"n={m}", ids])
  edges.append(["one_row", torch.full((n,), rows // 2, dtype=torch.int32,
                                      device="cuda")])
  for what, ids in edges:
    check(torch.equal(cx.gather_rows(layout, buf, ids),
                      cx.gather_rows_plain(buf, ids)),
          f"gather_rows {what}: not bit-equal to the plain version")
  emit({"phase": "kernel", "name": "gather_rows", "stream": "edges",
        "blocks": [w for w, _ in edges], "bit_equal": True})
  del buf
  # fused rows short of their physical row (the kernel reads the stride's
  # lanes; 65 takes its 4-byte path) and a two-row pitch (one optimizer
  # slot): bit-equal on a small buffer, not timed
  strides = []
  for width, n_aux in ((96, 0), (65, 0), (128, 1)):
    layout = PackedLayout(rows=100_000, width=width, n_aux=n_aux)
    buf = torch.rand(tuple(layout.shape), generator=gen, device="cuda")
    for m in (n, *K4_EDGE_N):
      ids = torch.randint(-100, layout.rows + 100, (m,), generator=gen,
                          device="cuda", dtype=torch.int32)
      got = cx.gather_rows(layout, buf, ids)
      check(torch.equal(got, cx.gather_rows_plain(buf, ids, layout.stride)),
            f"gather_rows stride {layout.stride} n={m}: not bit-equal to "
            "the plain version")
    strides.append([layout.stride, layout.phys_width])
  emit({"phase": "kernel", "name": "gather_rows", "stream": "strides",
        "stride_pitch": strides, "ids": [n, *K4_EDGE_N], "bit_equal": True})
  del buf
  torch.cuda.empty_cache()
  return main


def _w4_touch_counts(torch, plan, mesh, cats, state) -> dict:
  """Per sparse class of this rank: how many of the step's ids hit each
  of its rows (the routed ids are the same every step)."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DedupRouted,
      DistributedLookup,
      class_param_name,
  )
  counts = {name: torch.zeros((buf.shape[0],), dtype=torch.int32,
                              device=buf.device)
            for name, buf in state["fused"].items()}
  for bk, ids in DistributedLookup(plan, mesh=mesh).route_ids(cats).items():
    name = class_param_name(*bk.class_key)
    if name not in counts:
      continue
    # a deduplicated bucket applies one row per unique id and source rank
    flat = (ids.uniq if isinstance(ids, DedupRouted) else ids).reshape(-1)
    flat = flat[(flat >= 0) & (flat < counts[name].shape[0])]
    counts[name].index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
  return counts


def _w4_compare_none(torch, mesh, model, vocab, backend, state, batch,
                     touch) -> dict:
  """One ``overlap='fused'`` step and one ``overlap='none'`` step from the
  same state: the losses bit-equal, and the fused buffers bit-equal on
  every row fewer than two of the step's ids hit (within
  ``W4_DUP_ATOL`` on the others, where K1's atomics pick the order of the
  duplicates' adds). Then ``TRAIN_TIMED`` more ``'none'`` steps, timed as
  the fused ones are, for the schedules' comparison."""
  from distributed_embeddings_torch.models import bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.training import make_sparse_train_step

  snap = {"fused": {k: v.clone() for k, v in state["fused"].items()},
          "emb_dense": {k: v.detach().clone()
                        for k, v in state["emb_dense"].items()},
          "dense": {k: v.detach().clone() for k, v in state["dense"].items()},
          "step": state["step"]}
  losses = {}
  for overlap, st in (("fused", state), ("none", snap)):
    _, plan = world4_plan(backend, overlap)
    step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                  sgd_rule(TRAIN_LR), mesh=mesh)
    _, loss = step(st, *batch)
    losses[overlap] = float(loss)
  check(losses["fused"] == losses["none"],
        f"world 4: fused loss {losses['fused']} != none {losses['none']}")
  differ, dup_rows, worst = 0, 0, 0.0
  for name, buf in state["fused"].items():
    other = snap["fused"][name]
    dup = touch[name] >= 2
    dup_rows += int(dup.sum().item())
    bad = (buf != other).any(dim=1)
    differ += int((buf != other).sum().item())
    check(not bool((bad & ~dup).any().item()),
          f"world 4 {name}: fused and none differ on a row fewer than two "
          "ids hit")
    if bool(bad.any().item()):
      worst = max(worst, (buf[bad] - other[bad]).abs().max().item())
  check(worst <= W4_DUP_ATOL,
        f"world 4: fused and none differ by {worst} on duplicate rows")
  none_ms = []
  for _ in range(TRAIN_TIMED):
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    step(snap, *batch)
    torch.cuda.synchronize(mesh.device)
    none_ms.append((time.perf_counter() - t0) * 1e3)
  del snap
  return {"loss_bit_equal": True, "cells_differ": differ,
          "dup_rows": dup_rows, "dup_rows_max_abs_err": worst,
          "none_step_ms": none_ms,
          "none_step_ms_median": statistics.median(none_ms)}


def _w4_serve(torch, mesh, outdir: str) -> dict:
  """World-4 serving from an artifact, on every rank: a state of the
  Criteo x 1/16 plan (both backends), the per-rank ``export`` into one
  shared directory, ``load(mesh=)``, ``ServeEngine(mesh=)``, and
  ``SERVE_REQUESTS`` global requests of ``SERVE_BATCH`` answered in
  lockstep. The predictions are equal on every rank, bit-equal to the
  in-memory ``FrozenTables`` engine's and to the world-4
  ``make_sparse_eval_step``'s; K2-fwd runs once per request."""
  import os
  import shutil

  import numpy as np

  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.wire import gather_blocks
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      export,
      freeze,
      load,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_eval_step,
      shard_batch,
  )

  dev = mesh.device
  vocab, plan = world4_plan("gloo", "fused")  # x 1/16 on both backends
  rule = sgd_rule(TRAIN_LR)
  model = DLRM(vocab, D, compute_dtype=torch.bfloat16, tables=False,
               device=dev, generator=torch.Generator().manual_seed(SEED))
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device=dev).manual_seed(SEED + 1 + mesh.rank),
      mesh=mesh)
  rng = np.random.default_rng(SEED + 3)
  requests = [(rng.standard_normal((SERVE_BATCH, 13)).astype(np.float32),
               [rng.integers(0, v, SERVE_BATCH).astype(np.int32)
                for v in vocab]) for _ in range(SERVE_REQUESTS)]
  path = os.path.join(outdir, "serve_artifact")
  torch.cuda.synchronize(dev)
  t0 = time.perf_counter()
  export(path, plan, rule, state, quantize="f32", mesh=mesh)
  export_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  art = load(path, plan, mesh=mesh)
  torch.cuda.synchronize(dev)
  load_s = time.perf_counter() - t0
  eng = ServeEngine(model, plan, art, mesh=mesh)
  reset_counts()
  preds, ms = [], []
  for numerical, cats in requests:
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    preds.append(eng.predict(numerical, cats))
    ms.append((time.perf_counter() - t0) * 1e3)
  launches = read_counts()
  want = expect(interact_fwd=SERVE_REQUESTS)
  check(launches == want, f"serve world 4 rank {mesh.rank}: launches "
        f"{launches}, expected {want}")
  frozen = ServeEngine(model, plan, freeze(plan, rule, state, "f32",
                                           mesh=mesh), mesh=mesh)
  ev = make_sparse_eval_step(model, plan, rule, mesh=mesh)
  for i, (numerical, cats) in enumerate(requests):
    p = preds[i]
    check(p.shape == (SERVE_BATCH,) and np.isfinite(p).all(),
          f"serve world 4 rank {mesh.rank}: predictions not finite")
    every = gather_blocks(torch.from_numpy(p).to(dev), mesh).cpu().numpy()
    check(all(np.array_equal(every[r * SERVE_BATCH:(r + 1) * SERVE_BATCH]
                             .view(np.int32), p.view(np.int32))
              for r in range(WORLD)),
          f"serve world 4 request {i}: the ranks' predictions differ")
    check(np.array_equal(frozen.predict(numerical, cats).view(np.int32),
                         p.view(np.int32)),
          f"serve world 4 rank {mesh.rank} request {i}: the artifact "
          "engine differs from the FrozenTables engine")
    with torch.inference_mode():
      local = ev(state, *shard_batch((numerical, cats), mesh))
      ref = gather_blocks(local, mesh).cpu().numpy()
    check(np.array_equal(ref.view(np.int32), p.view(np.int32)),
          f"serve world 4 rank {mesh.rank} request {i}: predictions "
          f"differ from make_sparse_eval_step's by up to "
          f"{np.abs(ref - p).max()}")
  torch.distributed.barrier()
  if mesh.rank == 0:
    shutil.rmtree(path)
  return {"launches": launches, "request_ms": ms, "export_s": export_s,
          "load_s": load_s,
          "serve_bytes": sum(t.numel() * t.element_size()
                             for t in art.state["serve"].values())}


def _w4_ckpt(torch, mesh, backend: str, outdir: str) -> dict:
  """``world4_ckpt`` in this rank: a state of the world-4 plan (the
  vocabulary x 1/``W4_CKPT_VOCAB_SCALE``) with ``sgd_rule(schedule)`` and
  the scheduled dense SGD takes one step; every rank saves its own blocks
  into ``outdir/ckpt`` and rank 0 publishes; every rank restores
  (``restore(mesh=)``, rank 0 verifying) and its state is bit-equal to
  what it saved; one step from the restored state and one from the saved
  state give the same loss, each launching K4, K1, K2-fwd and K2-bwd as a
  world-4 step does. The checkpoint stays in ``outdir`` with each rank's
  part of every table's checksum (:func:`slot_checksums`) for the main
  process's world-1 restore (:func:`phase_world4_ckpt_world1`)."""
  import math
  import os
  import shutil

  import torch.distributed as dist

  from distributed_embeddings_torch import checkpoint
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.training import (
      ScheduledSGD,
      init_sparse_state_direct,
      make_sparse_train_step,
  )
  from distributed_embeddings_torch.utils import dlrm_lr_schedule

  dev = mesh.device
  vocab, plan = world4_plan(backend, scale=W4_CKPT_VOCAB_SCALE)
  schedule = dlrm_lr_schedule(*CKPT_SCHEDULE)
  rule = sgd_rule(schedule)

  def dense_opt(params):
    return ScheduledSGD(params, schedule)

  model = DLRM(vocab, D, tables=False, device=dev,
               generator=torch.Generator().manual_seed(SEED))
  torch.cuda.reset_peak_memory_stats(dev)
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), dense_opt,
      torch.Generator(device=dev).manual_seed(SEED + 11 + mesh.rank),
      mesh=mesh)
  batch = w4_batch(torch, vocab, mesh)
  step = make_sparse_train_step(model, plan, bce_loss, dense_opt, rule,
                                mesh=mesh)
  want = expect(gather_rows=k4_launches_per_step(plan),
                apply_rows=len(state["fused"]), interact_fwd=1,
                interact_bwd=1)
  totals = expect()

  def one(st, tag):
    reset_counts()
    st, loss = step(st, *batch)
    got = read_counts()
    check(got == want, f"world4_ckpt rank {mesh.rank} {tag}: launches "
          f"{got}, expected {want}")
    add_counts(totals, got)
    loss = float(loss)
    check(math.isfinite(loss), f"world4_ckpt rank {mesh.rank} {tag}: loss "
          f"{loss}")
    return st, loss

  state, _ = one(state, "before the save")
  path = os.path.join(outdir, "ckpt")
  torch.cuda.synchronize(dev)
  t0 = time.perf_counter()
  checkpoint.save(path, plan, rule, state, mesh=mesh)
  save_s = time.perf_counter() - t0
  # this rank's part of each table's checksum, for the world-1 restore of
  # the checkpoint in the main process (world4_ckpt_world1)
  out = {"save_s": save_s, "checksums": {
      str(k): v for k, v in slot_checksums(torch, plan, rule, state,
                                           [mesh.rank]).items()}}
  if mesh.rank == 0:
    out["bytes"], out["files"] = dir_bytes(path)
    out["disk_free_bytes"] = shutil.disk_usage(path).free
    t0 = time.perf_counter()
    problems = checkpoint.verify(path)
    out["verify_s"] = time.perf_counter() - t0
    check(problems == [], f"world4_ckpt: verify found {problems}")
  dist.barrier()
  t0 = time.perf_counter()
  restored = checkpoint.restore(path, plan, rule, state, mesh=mesh,
                                verify_integrity=False)
  torch.cuda.synchronize(dev)
  out["restore_s"] = time.perf_counter() - t0
  bad = states_bit_equal(torch, state_arrays(restored), state_arrays(state))
  check(not bad, f"world4_ckpt rank {mesh.rank}: restored arrays differ "
        f"from the saved ones: {bad[:8]}")
  restored, loss_restored = one(restored, "after the restore")
  state, loss_saved = one(state, "from the saved state")
  check(abs(loss_restored - loss_saved) <= 1e-5 * max(1.0, abs(loss_saved)),
        f"world4_ckpt rank {mesh.rank}: the step after the restore gave "
        f"loss {loss_restored}, the saved state's {loss_saved}")
  out.update({
      "vocab_scale": f"1/{W4_CKPT_VOCAB_SCALE}",
      "fused_bytes": sum(t.numel() * 4 for t in state["fused"].values()),
      "restored_bit_equal": True, "loss_after_restore": loss_restored,
      "loss_from_saved_state": loss_saved,
      "losses_bit_equal": loss_restored == loss_saved,
      "launches_per_step": want, "launches": totals,
      "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30})
  del state, restored, step
  torch.cuda.empty_cache()
  dist.barrier()  # every rank has read its blocks
  # the checkpoint stays for world4_ckpt_world1, which removes it
  return out


def slot_checksums(torch, plan, rule, state, ranks, images=None) -> dict:
  """Per logical table, a checksum of every cell this state holds of it:
  ``sum bits(cell) * ((row * width + col) % (2^31 - 1) + 1)`` over the
  table's rows and columns in the table's own coordinates, in wrapping
  int64 (a sum of parts, so the ranks' parts add up to the whole
  table's). ``ranks``: the rank blocks the state holds, in order. The
  tables' bits are compared this way across worlds without gathering
  them. ``images`` (a tiered state's): per host-tier class, this
  process's host images of ``ranks`` (the state holds only their compact
  caches)."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
      padded_rows,
  )
  layouts = DistributedLookup(plan).fused_layouts(rule)
  images = images or {}
  out = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    name = class_param_name(*key)
    if name in images:
      lay = layouts[name]
      buf = torch.cat([torch.from_numpy(img) for img in images[name]])
      per = lay.phys_rows
    elif cp.kind == "sparse":
      lay = layouts[name]
      buf = state["fused"][name]
      per = lay.phys_rows
    else:
      buf = state["emb_dense"][name].detach()
      per = padded_rows(plan, key)
    for i, r in enumerate(ranks):
      block = buf[i * per:(i + 1) * per]
      tbl = lay.unpack(block)[0] if cp.kind == "sparse" else block
      for s in cp.slots_per_rank[r]:
        sh = s.shard
        rows = tbl[s.row_offset:s.row_offset + sh.input_dim,
                   :sh.col_end - sh.col_start]
        width = plan.global_configs[sh.table_id].output_dim
        r_idx = torch.arange(sh.row_start, sh.row_start + sh.input_dim,
                             device=rows.device, dtype=torch.int64)
        c_idx = torch.arange(sh.col_start, sh.col_end, device=rows.device,
                             dtype=torch.int64)
        weight = (r_idx[:, None] * width + c_idx[None, :]) % (2**31 - 1) + 1
        bits = rows.contiguous().view(torch.int32).to(torch.int64)
        part = int((bits * weight).sum().item())
        out[sh.table_id] = (out.get(sh.table_id, 0) + part) % 2**64
  return out


def _w4_elastic(torch, mesh, backend: str, outdir: str) -> dict:
  """``world4_elastic`` in this rank, last in ``world4_rank``: the rank is
  pod member ``m<rank>`` of ``outdir/pod``. The world-4 plan (x
  1/``W4_ELASTIC_VOCAB_SCALE``) under a guarded ``ResilientTrainer``
  takes a step at world 4, resizes in the run to 2 (members 2 and 3 park:
  no state, waiting at the next barrier) and takes a step, resizes back
  to 4 (they return) and takes a step; then the tiered form of the plan
  (its tables above ``TIERED_HOST_ROWS`` cut alike in host RAM, each
  rank's store owning its rank) takes a step at world 4, resizes to 2 and
  takes a step. At each boundary every logical table's bits are the same
  on both sides (:func:`slot_checksums`, summed over the ranks), every
  step launches K1, K2 and K4 as the plan says, and ``consumed == steps +
  skipped``. The default process group is formed again at each world
  from a rendezvous file of the pod."""
  import math
  import os

  import torch.distributed as dist

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.mesh import rank_mesh
  from distributed_embeddings_torch.resilience import elastic
  from distributed_embeddings_torch.resilience.trainer import \
      ResilientTrainer
  from distributed_embeddings_torch.telemetry import MetricsRegistry
  from distributed_embeddings_torch.tiering import (
      HostTierStore,
      TieredTrainer,
      TieringConfig,
      TieringPlan,
      init_tiered_state,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
      shard_batch,
  )

  pod = os.path.join(outdir, "pod")
  member = f"m{mesh.rank}"
  elastic.register_member(pod, member)
  scale = W4_ELASTIC_VOCAB_SCALE
  rule = sgd_rule(TRAIN_LR)
  vocab, plan4 = world4_plan(backend, scale=scale)
  model = DLRM(vocab, D, tables=False, device=mesh.device,
               generator=torch.Generator().manual_seed(SEED))
  batch = tiered_batches(vocab, 1, W4_ELASTIC_BATCH, SEED + 31)[0]
  totals = expect()
  out = {"rank": mesh.rank, "vocab_scale": f"1/{scale}", "steps": {},
         "resize_s": {}, "same_bits": {}}

  def gathered(t, tag):
    # every rank's part of each table's checksum, summed over the world
    # (a collective of the trainer's current group)
    st = t.tiered.state if t.tiered is not None else t.state
    if t.tiered is not None:
      t.tiered.flush()
    images = ({name: [per[t.mesh.rank]]
               for name, per in t.tiered.store.images.items()}
              if t.tiered is not None else None)
    sums = slot_checksums(torch, t.plan, rule, st, [t.mesh.rank], images)
    parts = [None] * t.mesh.world
    dist.all_gather_object(parts, sums)
    total = {}
    for p in parts:
      for tid, v in p.items():
        total[tid] = (total.get(tid, 0) + v) % 2**64
    out.setdefault("checksums", {})[tag] = len(total)
    return total

  def one_step(t, tag):
    k4 = k4_launches_per_step(t.plan) * t.plan.world_size // WORLD
    st = t.tiered.state if t.tiered is not None else t.state
    want = expect(gather_rows=k4, apply_rows=len(st["fused"]),
                  interact_fwd=1, interact_bwd=1)
    reset_counts()
    if t.tiered is not None:
      loss = t.step(*batch)
    else:
      loss = t.step(*shard_batch(batch, t.mesh))
    got = read_counts()
    check(got == want, f"world4_elastic {tag} rank {mesh.rank}: launches "
          f"{got}, expected {want}")
    add_counts(totals, got)
    check(math.isfinite(loss), f"world4_elastic {tag}: loss {loss}")
    out["steps"][tag] = {"loss": loss, "world": t.plan.world_size,
                         "launches": got}

  def resize(t, world, epoch, tag, **kw):
    before = None if t.parked else gathered(t, f"{tag}/before")
    r = elastic.member_rank(elastic.alive_members(pod), member, world)
    new_mesh = None if r is None else rank_mesh(world, r, "cuda")
    if new_mesh is not None and t.tiered is None:
      kw["step_fn"] = make_sparse_train_step(
          model, elastic.plan_for_world(plan4, world), bce_loss,
          sgd_factory(torch), rule, mesh=new_mesh, guard=True)
    elif new_mesh is not None:
      kw = {k: v(new_mesh) for k, v in kw.items()}
    else:
      kw = {}
    t0 = time.perf_counter()
    t.resize(world, new_mesh=new_mesh, pod_dir=pod, barrier_epoch=epoch,
             member_id=member, n_participants=WORLD, **kw)
    out["resize_s"][tag] = time.perf_counter() - t0
    if not t.parked:
      after = gathered(t, f"{tag}/after")
      if before is not None:
        out["same_bits"][tag] = after == before
        check(after == before, f"world4_elastic {tag} rank {mesh.rank}: "
              "logical rows changed across the move")

  step4 = make_sparse_train_step(model, plan4, bce_loss, sgd_factory(torch),
                                 rule, mesh=mesh, guard=True)
  state = init_sparse_state_direct(
      plan4, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device=mesh.device).manual_seed(SEED + 31 + mesh.rank),
      mesh=mesh)
  reg = MetricsRegistry()
  t = ResilientTrainer(step4, state, plan4, rule,
                       os.path.join(pod, f"ckpt_{member}"), mesh=mesh,
                       resume=False, telemetry=reg)
  del state
  one_step(t, "sparse/w4")
  resize(t, 2, 1, "sparse/4to2")
  if not t.parked:
    one_step(t, "sparse/w2")
  resize(t, 4, 2, "sparse/2to4")
  one_step(t, "sparse/w4b")
  check(t.consumed == t.step_count + t.skipped_steps,
        f"world4_elastic rank {mesh.rank}: consumed {t.consumed} != steps "
        f"{t.step_count} + skipped {t.skipped_steps}")
  out["sparse"] = {"consumed": t.consumed, "steps": t.step_count,
                   "skipped": t.skipped_steps,
                   "resizes": reg.counter("elastic/resizes").value,
                   "quiesce_s": reg.histogram("elastic/quiesce_s").mean}
  mesh4 = t.mesh
  del t, step4
  torch.cuda.empty_cache()

  # tiered: 4 -> 2, each rank's store owning its rank
  cfg = TieringConfig(cache_fraction=0.5, staging_grps=4096,
                      rerank_interval=2)
  tvocab, tplan4 = world4_plan(backend, scale=scale,
                               host_row_threshold=TIERED_HOST_ROWS // scale)
  tplan = TieringPlan(tplan4, rule, cfg)
  store = HostTierStore(tplan, owned_ranks=(mesh4.rank,))
  tstate = init_tiered_state(
      tplan, store, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device=mesh4.device).manual_seed(SEED + 41 + mesh4.rank),
      mesh=mesh4, image_seed=SEED, image_device=mesh4.device)
  tt = ResilientTrainer(None, None, tplan4, rule,
                        os.path.join(pod, f"tckpt_{member}"), mesh=mesh4,
                        resume=False, telemetry=MetricsRegistry(),
                        tiered=TieredTrainer(model, tplan, store, bce_loss,
                                             sgd_factory(torch), rule, mesh4,
                                             tstate, guard=True))
  del tstate
  one_step(tt, "tiered/w4")

  def new_store(m):
    return HostTierStore(TieringPlan(elastic.plan_for_world(tplan4, 2), rule,
                                     cfg), owned_ranks=(m.rank,))

  stores = {}

  def store_for(m):
    stores[m.rank] = stores.get(m.rank) or new_store(m)
    return stores[m.rank]

  def factory_for(m):
    sto = store_for(m)
    return lambda st: TieredTrainer(model, sto.tplan, sto, bce_loss,
                                    sgd_factory(torch), rule, m, st,
                                    guard=True)

  resize(tt, 2, 3, "tiered/4to2", new_store=store_for,
         tiered_factory=factory_for)
  if not tt.parked:
    one_step(tt, "tiered/w2")
    check(tt.consumed == tt.step_count + tt.skipped_steps,
          f"world4_elastic tiered rank {mesh.rank}: consumed {tt.consumed}")
  out["parked_at_end"] = tt.parked
  out["launches"] = totals
  del tt, store, stores
  torch.cuda.empty_cache()
  return out


def w4_host_batch(torch, vocab, alpha: float = 0.0):
  """The world-4 phase's global batch on the host: ``W4_BATCH`` samples
  of one-hot ids, uniform from seed ``SEED`` (``alpha=0``) or power-law
  with exponent ``alpha`` (``models/synthetic.py: power_law_ids``, seed
  ``SEED + 7``)."""
  import numpy as np

  from distributed_embeddings_torch.models.synthetic import power_law_ids

  gen = torch.Generator().manual_seed(SEED)
  numerical = torch.randn((W4_BATCH, 13), generator=gen)
  cats = [torch.randint(0, v, (W4_BATCH,), generator=gen, dtype=torch.int32)
          for v in vocab]
  labels = torch.randint(0, 2, (W4_BATCH,), generator=gen).float()
  if alpha:
    rng = np.random.default_rng(SEED + 7)
    cats = [torch.from_numpy(power_law_ids(rng, W4_BATCH, 1, v, alpha)[:, 0]
                             .astype(np.int32)) for v in vocab]
  return numerical, cats, labels


def w4_batch(torch, vocab, mesh, alpha: float = 0.0):
  """This rank's slice of :func:`w4_host_batch`, on its device."""
  from distributed_embeddings_torch.training import shard_batch

  return shard_batch(w4_host_batch(torch, vocab, alpha), mesh)


def w4_overflow_numpy(plan, cats, cap: int) -> dict:
  """Per class of the world-4 plan, the dedup-capacity overflow of one
  global batch of one-hot ids (``cats``, host tensors), counted in numpy
  from the plan's slots: each source rank routes its slice to every
  destination, one block per (sparse bucket, destination) of ``n_b``
  slots (a padded slot and an id outside a row slice's window are the
  sentinel), and a block with more distinct values than ``cap`` (below
  its safe bound) overflows by the excess. Summed over the ranks."""
  import numpy as np

  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
      class_param_name,
      padded_rows,
  )
  b = W4_BATCH // WORLD
  host = [np.asarray(c) for c in cats]
  out = {class_param_name(*k): 0 for k in plan.class_keys}
  for key in plan.class_keys:
    cp = plan.classes[key]
    if cp.kind != "sparse":
      continue
    sentinel = padded_rows(plan, key)
    for bucket in class_buckets(plan, key, lambda i: 1):
      if cap >= min(bucket.n_b * b, sentinel + 1):
        continue
      for src in range(WORLD):
        for dst in range(WORLD):
          idxs = bucket.slot_idx_per_rank[dst]
          vals = [np.full(1, sentinel)] if len(idxs) < bucket.n_b else []
          for i in idxs:
            slot = cp.slots_per_rank[dst][i]
            ids = host[slot.input_id][src * b:(src + 1) * b].astype(np.int64)
            sh = slot.shard
            if sh.row_sliced:
              vocab = plan.global_configs[sh.table_id].input_dim
              cl = np.clip(ids, 0, vocab - 1)
              inw = (cl >= sh.row_start) & (cl < sh.row_start + sh.input_dim)
              vals.append(np.where(inw, cl - sh.row_start + slot.row_offset,
                                   sentinel))
            else:
              vals.append(np.clip(ids, 0, sh.input_dim - 1) + slot.row_offset)
          distinct = np.unique(np.concatenate(vals)).size
          out[class_param_name(*key)] += max(0, distinct - cap)
  return out


def w4_wire_bytes(plan, wire: str) -> int:
  """The sparse classes' float payload one rank's step sends over the
  wire (forward activations and backward cotangents, the self block
  excluded), from the plan's static shapes: ``n_b * B_local`` rows a
  destination, or under ``dedup_exchange`` the unique capacity ``K``
  (:func:`w4_block_rows`, sized for the worst case); 4, 2 or 1 bytes a
  value for the f32, bf16 and fp8 wires, the fp8 blocks carrying 4 scale
  bytes per (destination, chunk)."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
  )
  total = 0
  for key in plan.class_keys:
    if plan.classes[key].kind != "sparse":
      continue
    for bucket in class_buckets(plan, key, lambda i: 1):
      rows = w4_block_rows(plan, key, bucket)
      if not plan.dedup_exchange:
        rows *= bucket.n_b
      values = rows * D
      per_dest = {"f32": 4 * values, "bf16": 2 * values,
                  "fp8": values + 4 * min(W4_CHUNKS, rows)}[wire]
      total += 2 * (WORLD - 1) * per_dest
  return total


def w4_unique_share(torch, plan, mesh, cats) -> dict:
  """Per sparse class, this rank's distinct routed ids over its routed
  occurrences (the sentinel excluded from both), read from the
  :class:`DedupRouted` blocks of one ``route_ids``."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DedupRouted,
      DistributedLookup,
      class_param_name,
      padded_rows,
  )
  uniq, occ = {}, {}
  for bk, r in DistributedLookup(plan, mesh=mesh).route_ids(cats).items():
    if not isinstance(r, DedupRouted):
      continue
    name = class_param_name(*bk.class_key)
    sentinel = padded_rows(plan, bk.class_key)
    real = r.uniq_local < sentinel
    uniq[name] = uniq.get(name, 0) + int(real.sum())
    occ[name] = occ.get(name, 0) + int(torch.gather(
        real, 1, r.inv.reshape(WORLD, -1).long()).sum())
  return {n: uniq[n] / max(1, occ[n]) for n in uniq}


def _w4_acts(torch, plan, mesh, state, batch, rule=None):
  """The activations the eval step feeds the model (every input's,
  concatenated): route, fused gather (K4 per round chunk under
  ``'fused'`` for the classes of :func:`k4_classes`), dense classes,
  exchange, assembly. ``rule``: the state's (SGD by default); inputs
  ``[B]`` or ``[B, h]``."""
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  numerical, cats, _ = batch
  hot = w4_codes(cats)
  engine = DistributedLookup(plan, mesh=mesh)
  with torch.inference_mode():
    ids_all = engine.route_ids(cats, lambda i: hot[i])
    z, _ = engine.lookup_sparse_fused(
        state["fused"], engine.fused_layouts(rule or sgd_rule(TRAIN_LR)),
        ids_all, keep_aux=False)
    acts = engine.finish_forward(z, state["emb_dense"], ids_all,
                                 numerical.shape[0], lambda i: hot[i],
                                 engine.mean_counts(cats))
  return acts


def w4_codes(cats) -> list:
  """Each padded input's hotness: 1 for ``[B]``, ``h`` for ``[B, h]``."""
  return [1 if c.dim() == 1 else int(c.shape[1]) for c in cats]


def _w4_wire(torch, mesh, backend: str, batch) -> dict:
  """``world4_wire`` in this rank: the README's wire compression on the
  world-4 cell (f32 compute, SGD ``TRAIN_LR``). Every state is drawn
  from one seed.

  - ``dedup_exchange=True`` under ``'none'``, ``'pipelined'`` and
    ``'fused'``: the activations bit-equal to the raw fused exchange's,
    then ``W4_WIRE_STEPS`` steps within the f32 class (1e-5 of each
    cell's magnitude) of the raw fused steps;
  - ``bf16`` and ``fp8`` with dedup under ``'fused'``: the activations
    within the JAX tests' bounds of f32 (``W4_WIRE_BOUND``), finite
    steps;
  - the power-law batch: raw and dedup fused activations bit-equal,
    steps of each;
  - a guarded dedup step with ``dedup_capacity=W4_WIRE_CAP``: the
    ``dedup_overflow`` counts above zero and equal to numpy's
    (:func:`w4_overflow_numpy`) on every rank; ``W4_WIRE_GENEROUS``
    counts 0;
  - serving (``FrozenTables`` f32, ``SERVE_BATCH``) under the dedup plan
    bit-equal to the raw plan's.

  Every run's launches are checked: K4 once per (bucket, round, chunk)
  of the fused forward (chunks of the unique capacity under dedup), K1
  once per sparse class, K2-fwd and K2-bwd once a step."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.serving import ServeEngine, freeze
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  dev = mesh.device
  vocab, raw_plan = world4_plan(backend)
  model = DLRM(vocab, D, tables=False, device=dev,
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  totals = expect()
  host = w4_host_batch(torch, vocab)
  power = w4_batch(torch, vocab, mesh, W4_WIRE_ALPHA)

  def fresh(plan):
    torch.cuda.empty_cache()
    return init_sparse_state_direct(
        plan, rule, model.state_dict(), sgd_factory(torch),
        torch.Generator(device=dev).manual_seed(SEED + 41 + mesh.rank),
        mesh=mesh)

  def counted(fn, want, what):
    reset_counts()
    out = fn()
    got = read_counts()
    check(got == want, f"world 4 wire {what} rank {mesh.rank}: launches "
          f"{got}, expected {want}")
    add_counts(totals, got)
    return out

  def acts_of(plan, state, b, what):
    acts = counted(lambda: _w4_acts(torch, plan, mesh, state, b),
                   expect(gather_rows=k4_launches_per_step(plan)), what)
    return torch.cat(acts, dim=1)

  def steps(plan, state, b, n, what, **kw):
    step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                  rule, mesh=mesh, **kw)
    want = expect(gather_rows=k4_launches_per_step(plan),
                  apply_rows=len(state["fused"]), interact_fwd=1,
                  interact_bwd=1)
    losses, ms, metrics = [], [], []
    for i in range(n):
      torch.cuda.synchronize(dev)
      t0 = time.perf_counter()
      res = counted(lambda: step(state, *b), want, f"{what} step {i}")
      torch.cuda.synchronize(dev)
      ms.append((time.perf_counter() - t0) * 1e3)
      losses.append(float(res[1]))
      check(np.isfinite(losses[-1]), f"world 4 wire {what}: loss "
            f"{losses[-1]}")
      if kw.get("guard"):
        metrics.append({k: int(v) for k, v in
                        res[2]["dedup_overflow"].items()})
    # the first step of a new step function pays first-call costs
    return {"losses": losses, "step_ms": ms,
            "step_ms_median": statistics.median(ms[1:] or ms)}, metrics

  out = {"variants": {}}
  # the raw fused exchange: the reference of every f32 variant
  state = fresh(raw_plan)
  ref_acts = acts_of(raw_plan, state, batch, "raw acts")
  out["variants"]["raw_fused"], _ = steps(raw_plan, state, batch,
                                          W4_WIRE_STEPS, "raw")
  ref = state_arrays(state)
  for overlap in ("none", "pipelined", "fused"):
    name = f"dedup_{overlap}"
    _, plan = world4_plan(backend, overlap, dedup_exchange=True)
    state = fresh(plan)
    acts = acts_of(plan, state, batch, f"{name} acts")
    check(torch.equal(acts, ref_acts), f"world 4 wire {name} rank "
          f"{mesh.rank}: the activations differ from the raw exchange's")
    run, _ = steps(plan, state, batch, W4_WIRE_STEPS, name)
    close = states_close(torch, state_arrays(state), ref, 1e-5)
    ref_losses = out["variants"]["raw_fused"]["losses"]
    check(close["within"] and all(
        abs(a - b) <= 1e-5 * max(1.0, abs(b))
        for a, b in zip(run["losses"], ref_losses)),
          f"world 4 wire {name} rank {mesh.rank}: {W4_WIRE_STEPS} steps "
          f"left the raw steps by {close['max_abs_err']}")
    run.update(acts_bit_equal=True, max_abs_err=close["max_abs_err"],
               cells_differing=close["cells_differing"])
    out["variants"][name] = run
    del state
  del ref
  for wire in ("bf16", "fp8"):
    name = f"dedup_fused_{wire}"
    _, plan = world4_plan(backend, dedup_exchange=True, wire_dtype=wire)
    state = fresh(plan)
    acts = acts_of(plan, state, batch, f"{name} acts")
    err = (acts - ref_acts).abs()
    worst = 0.0
    for t in range(len(vocab)):
      cols = slice(t * D, (t + 1) * D)
      lim = W4_WIRE_BOUND[wire] * float(ref_acts[:, cols].abs().max()) + 1e-6
      worst = max(worst, float(err[:, cols].max()) / lim)
    check(worst <= 1.0, f"world 4 wire {name} rank {mesh.rank}: "
          f"activations at {worst:.3f} of the bound")
    run, _ = steps(plan, state, batch, W4_WIRE_STEPS, name)
    run.update(acts_max_abs_err=float(err.max()), acts_bound_share=worst)
    out["variants"][name] = run
    del state
  # the power-law batch: raw against dedup
  power_acts = None
  for name, plan in (("power_raw_fused", raw_plan),
                     ("power_dedup_fused",
                      world4_plan(backend, dedup_exchange=True)[1])):
    state = fresh(plan)
    acts = acts_of(plan, state, power, f"{name} acts")
    if power_acts is None:
      power_acts = acts
    check(torch.equal(acts, power_acts), f"world 4 wire {name} rank "
          f"{mesh.rank}: the power-law activations differ")
    out["variants"][name], _ = steps(plan, state, power, W4_WIRE_STEPS,
                                     name)
    del state
  _, dedup_plan = world4_plan(backend, dedup_exchange=True)
  out["unique_share"] = {
      "uniform": w4_unique_share(torch, dedup_plan, mesh, batch[1]),
      "power_law": w4_unique_share(torch, dedup_plan, mesh, power[1])}
  del power_acts, ref_acts
  # dedup_capacity and its counter
  out["overflow"] = {}
  for name, cap in (("capped", W4_WIRE_CAP), ("generous", W4_WIRE_GENEROUS)):
    _, plan = world4_plan(backend, dedup_exchange=True, dedup_capacity=cap)
    state = fresh(plan)
    _, metrics = steps(plan, state, batch, 1, name, guard=True)
    want = w4_overflow_numpy(plan, host[1], cap)
    check(metrics[0] == want, f"world 4 wire {name} rank {mesh.rank}: "
          f"dedup_overflow {metrics[0]}, numpy counts {want}")
    check((sum(want.values()) > 0) == (name == "capped"),
          f"world 4 wire {name}: overflow {sum(want.values())}")
    out["overflow"][name] = {"cap": cap, "dedup_overflow": metrics[0]}
    del state
  # serving: the dedup plan's answers bit-equal to the raw plan's
  rng = np.random.default_rng(SEED + 5)
  request = (rng.standard_normal((SERVE_BATCH, 13)).astype(np.float32),
             [rng.integers(0, v, SERVE_BATCH).astype(np.int32)
              for v in vocab])
  state = fresh(raw_plan)
  frozen = freeze(raw_plan, rule, state, "f32", mesh=mesh)
  del state
  preds = {}
  for name, plan in (("raw", raw_plan), ("dedup", dedup_plan)):
    eng = ServeEngine(model, plan, frozen, mesh=mesh)
    preds[name] = counted(lambda: eng.predict(*request),
                          expect(interact_fwd=1), f"serve {name}")
  check(np.array_equal(preds["raw"].view(np.int32),
                       preds["dedup"].view(np.int32)),
        f"world 4 wire serve rank {mesh.rank}: dedup serving differs")
  del frozen, eng
  torch.cuda.empty_cache()
  out["serve_bit_equal"] = True
  out["wire_bytes"] = {
      "raw": w4_wire_bytes(raw_plan, "f32"),
      "dedup": w4_wire_bytes(dedup_plan, "f32"),
      "dedup_bf16": w4_wire_bytes(dedup_plan, "bf16"),
      "dedup_fp8": w4_wire_bytes(dedup_plan, "fp8")}
  out["k4_per_forward"] = {"raw": k4_launches_per_step(raw_plan),
                           "dedup": k4_launches_per_step(dedup_plan)}
  out["launches"] = totals
  return out


def _w4_dense(torch, mesh, backend: str, batch) -> dict:
  """The README Quick start at world 4, in this rank: the committed
  world-4 dense golden's f32 run replayed (compared on rank 0), then a
  ``DLRM(mesh=)`` of the world-4 plan that owns this rank's blocks,
  ``broadcast_variables`` (its MLPs drawn from a per-rank seed first),
  ``make_train_step(mesh=)`` with ``torch.optim.SGD(0.1)``, at f32 and
  bf16 compute: ``TRAIN_WARMUP`` + ``DENSE_TIMED`` steps on ``batch``
  (this rank's slice of the global batch), each checked (loss finite,
  K2-fwd and K2-bwd once and no other kernel, sampled rows of this rank's
  first sparse block that no rank's batch touches bit-unchanged, most
  touched ones changed); then every rank's losses equal, the replicated
  parameters bit-equal across the ranks, and one more step traced on
  rank 0."""
  import numpy as np

  from distributed_embeddings_torch import train_golden
  from distributed_embeddings_torch.layers import broadcast_variables
  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.parallel.wire import gather_blocks
  from distributed_embeddings_torch.training import make_train_step

  rank, dev = mesh.rank, mesh.device
  out = {"runs": {}}
  golden = train_golden.load(train_golden.DENSE_WORLD4_PATH)
  # its f32 run: the card computes the interaction in bf16 (the JAX
  # step's bf16 run also sums the replicated gradients in bf16, which the
  # port does not; train_golden's docstring)
  losses, got, preds = train_golden.replay_dense_world4(golden, mesh,
                                                        compute="f32")
  if rank == 0:
    try:
      worst = train_golden.compare_dense_world4(golden, losses, got, preds,
                                                "f32")
    except AssertionError as exc:
      raise SmokeFailure(f"world-4 dense golden: {exc}") from exc
    out["golden"] = {"compute": "f32", "losses": losses,
                     "want_losses": [float(v)
                                     for v in golden["f32_losses"]],
                     **worst, "loss_tol": train_golden.LOSS_TOL,
                     "update_tol": train_golden.UPDATE_TOL}
  vocab, plan = world4_plan(backend)
  key, name, _ = first_sparse_class(plan)
  for compute in ("f32", "bf16"):
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = DLRM(vocab, D, compute_dtype=(torch.float32 if compute == "f32"
                                          else torch.bfloat16),
                 world_size=WORLD, strategy="memory_balanced",
                 row_slice=W4_ROW_SLICE[backend], dense_row_threshold=4096,
                 batch_hint=W4_BATCH, overlap="fused",
                 exchange_chunks=W4_CHUNKS, mesh=mesh,
                 generator=torch.Generator().manual_seed(SEED + rank),
                 table_generator=torch.Generator(device=dev)
                 .manual_seed(SEED + 1 + rank))
    broadcast_variables(model, 0, mesh)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    check(model.embeddings.plan.class_keys == plan.class_keys,
          "the world-4 DLRM's plan is not world4_plan's")
    buf = model.embeddings.class_params()[name]
    touch = torch.zeros((buf.shape[0],), dtype=torch.int32, device=dev)
    for bk, ids in model.embeddings.engine.route_ids(batch[1]).items():
      if bk.class_key == key:
        flat = ids.reshape(-1)
        flat = flat[(flat >= 0) & (flat < buf.shape[0])]
        touch.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    pick = torch.Generator(device=dev).manual_seed(SEED + 2)
    hit = torch.nonzero(touch > 0).squeeze(1)
    miss = torch.nonzero(touch == 0).squeeze(1)
    hit = hit[torch.randperm(hit.numel(), generator=pick,
                             device=dev)[:ROWS_SAMPLED]]
    miss = miss[torch.randperm(miss.numel(), generator=pick,
                               device=dev)[:ROWS_SAMPLED]]
    miss_rows = buf[miss].detach().clone()
    opt = torch.optim.SGD(model.parameters(), lr=TRAIN_LR)
    step = make_train_step(train_golden.dense_loss, opt, model, mesh=mesh)
    want = expect(interact_fwd=1, interact_bwd=1)
    totals = expect()
    ms, losses, changed = [], [], []
    for i in range(TRAIN_WARMUP + DENSE_TIMED):
      hit_rows = buf[hit].detach().clone()
      reset_counts()
      torch.cuda.synchronize(dev)
      t0 = time.perf_counter()
      loss = step(*batch)
      torch.cuda.synchronize(dev)
      t1 = time.perf_counter()
      got = read_counts()
      check(got == want, f"dense world 4 {compute} rank {rank} step {i}: "
            f"launches {got}, expected {want}")
      add_counts(totals, got)
      if i >= TRAIN_WARMUP:
        ms.append((t1 - t0) * 1e3)
      losses.append(float(loss))
      check(np.isfinite(losses[-1]),
            f"dense world 4 {compute} rank {rank} step {i}: loss "
            f"{losses[-1]}")
      check(torch.equal(buf[miss], miss_rows),
            f"dense world 4 {compute} rank {rank} step {i}: rows no "
            "rank's batch touches changed")
      changed.append((buf[hit] != hit_rows).any(dim=1).float().mean()
                     .item())
      check(changed[-1] > 0.5,
            f"dense world 4 {compute} rank {rank} step {i}: only "
            f"{changed[-1]:.1%} of the sampled touched rows changed")
    torch.cuda.synchronize(dev)
    run = {"step_ms": ms, "step_ms_median": statistics.median(ms),
           "losses": losses, "touched_rows_changed_share": changed,
           "launches": totals, "launches_per_step": want, "init_s": init_s,
           "class_bytes": sum(p.numel() * 4 for p in
                              model.embeddings.class_params().values()),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    every = gather_blocks(torch.tensor(losses, device=dev), mesh)
    check(torch.equal(every.reshape(WORLD, -1),
                      every[:len(losses)].expand(WORLD, -1)),
          f"dense world 4 {compute}: the ranks' losses differ")
    replicated = torch.cat([p.detach().reshape(-1) for n, p in
                            model.named_parameters()
                            if not n.startswith("embeddings.")])
    every = gather_blocks(replicated[None], mesh)
    check(torch.equal(every, replicated[None].expand(WORLD, -1)),
          f"dense world 4 {compute}: the replicated parameters differ "
          "across the ranks")
    run["replicated_params"] = replicated.numel()
    if rank == 0:
      run["trace"] = trace_call(torch, lambda: step(*batch))
    else:
      step(*batch)
    out["runs"][compute] = run
    del model, opt, step, buf, touch, replicated
    torch.cuda.empty_cache()
  return out


def w4_narrow_plan(backend: str, overlap: str = "fused", **wire_kw):
  """The Tiny-like narrow cell of ``world4_colslice``: Tiny's three shared
  multi-hot tables (``W4_NARROW_GROUPS``, vocabulary x 1/16 on one card),
  each read by a one-hot and a ten-hot input, ``column_slice_threshold=
  W4_NARROW_SLICE`` (each table in four slices: 2 lanes of the width-8
  table, 4 of the width-16 ones), no dense class. Returns ``(config,
  plan)``; the config is Tiny's MLP over these inputs."""
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  from distributed_embeddings_torch.models.synthetic import (
      SYNTHETIC_MODELS,
      EmbeddingGroup,
      SyntheticModelConfig,
      expand_tables,
  )
  tiny = SYNTHETIC_MODELS[ZOO_MODEL]
  scale = W4_VOCAB_SCALE[backend]
  cfg = SyntheticModelConfig(
      "Tiny V3 shared multi-hot tables, column-sliced",
      tuple(EmbeddingGroup(1, (1, 10), max(4, rows // scale), w, True)
            for rows, w in W4_NARROW_GROUPS),
      tiny.mlp_sizes, tiny.num_numerical_features, None)
  tables, tmap, hot = expand_tables(cfg)
  plan = DistEmbeddingStrategy(
      tables, WORLD, "memory_balanced", input_table_map=tmap,
      input_hotness=hot, column_slice_threshold=W4_NARROW_SLICE,
      batch_hint=W4_BATCH, overlap=overlap,
      exchange_chunks=1 if overlap == "none" else W4_CHUNKS, **wire_kw)
  return cfg, plan


def w4_sliced_plan(backend: str, overlap: str = "fused", **wire_kw):
  """The world-4 Criteo plan (:func:`world4_plan`) at x 1/16 on either
  backend, with ``column_slice_threshold=W4_COL_SLICE``: ``(vocab,
  plan)``."""
  return world4_plan(backend, overlap, scale=W4_VOCAB_SCALE["gloo"],
                     column_slice_threshold=W4_COL_SLICE, **wire_kw)


def _w4_sliced_runs(torch, mesh, tag: str, plan_of, model, rule, factory,
                    state, batch, interact: bool) -> dict:
  """One column-sliced cell in this rank: the activations of ``batch``
  under ``overlap='none'``, ``'pipelined'``, ``'fused'`` and with
  ``dedup_exchange`` (fused) from ``state``, each bit-equal to
  ``'none'``'s, K4 launched as :func:`k4_forward_launches` predicts; then
  ``W4_SLICED_STEPS`` fused train steps (``rule``, dense ``factory``), each
  launching K4, K1 and K6 as predicted from the plan (K2 with the DLRM's
  ``interact``), the losses finite and equal on every rank; then f32
  serving (``freeze``, ``ServeEngine(mesh=)``) of one global request
  bit-equal to the eval step (beside a window-masked gather in the f32
  class). ``plan_of(overlap, **wire_kw)`` builds the
  cell's plan."""
  import numpy as np

  from distributed_embeddings_torch.models import bce_loss
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  from distributed_embeddings_torch.parallel.wire import gather_blocks
  from distributed_embeddings_torch.serving import ServeEngine, freeze
  from distributed_embeddings_torch.training import (
      make_sparse_eval_step,
      make_sparse_train_step,
      shard_batch,
  )
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
      class_param_name,
  )
  rank, dev = mesh.rank, mesh.device
  numerical, cats, _ = batch
  hot = w4_codes(cats)
  base = plan_of("none")
  layouts = DistributedLookup(base).fused_layouts(rule)
  # a multi-hot bucket of a class with several rows a physical row and
  # optimizer state: the window-masked gather (_masked_multi_hot)
  masked = any(
      b.h > 1 and layouts[class_param_name(*k)].rows_per_phys > 1
      and rule.n_aux
      for k in base.class_keys if base.classes[k].kind == "sparse"
      for b in class_buckets(base, k, lambda i: hot[i]))
  out = {"forward_ms": {}, "k4_per_forward": {}, "masked_gather": masked}
  totals = expect()
  ref = None
  for name, overlap, kw in (("none", "none", {}),
                            ("pipelined", "pipelined", {}),
                            ("fused", "fused", {}),
                            ("dedup", "fused", {"dedup_exchange": True})):
    p = plan_of(overlap, **kw)
    check(p.class_keys == base.class_keys,
          f"{tag} {name}: the plan's classes differ from 'none''s")
    want = expect(gather_rows=k4_forward_launches(p, hot, rule))
    reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    acts = _w4_acts(torch, p, mesh, state, batch, rule)
    torch.cuda.synchronize(dev)
    out["forward_ms"][name] = (time.perf_counter() - t0) * 1e3
    got = read_counts()
    check(got == want, f"{tag} rank {rank} {name} forward: launches {got}, "
          f"expected {want}")
    add_counts(totals, got)
    out["k4_per_forward"][name] = want["gather_rows"]
    acts = torch.cat(list(acts), dim=1)
    if ref is None:
      ref = acts
    if name == "dedup" and masked:
      # dedup gathers each unique id's row and adds a bag in hotness
      # order; the raw path adds a masked class's window-masked physical
      # rows and folds the windows (the JAX engine's two paths differ
      # alike): the f32 class
      out["dedup_max_abs_diff"] = (acts - ref).abs().max().item()
      check(torch.allclose(acts, ref, rtol=1e-5, atol=1e-6),
            f"{tag} rank {rank}: the dedup activations differ from "
            f"'none''s by up to {out['dedup_max_abs_diff']}")
    else:
      check(torch.equal(acts, ref), f"{tag} rank {rank}: the {name} "
            "activations differ from 'none''s")
  del ref, acts
  plan = plan_of("fused")
  engine = DistributedLookup(plan, mesh=mesh)
  ids_all = engine.route_ids(cats, lambda i: hot[i])
  k1, chunked, k6 = k1_launches(plan, ids_all)
  del ids_all
  want = expect(gather_rows=k4_forward_launches(plan, hot, rule),
                apply_rows=k1,
                build_delta_rows=k6 if rule.name != "sgd" else 0,
                **({"interact_fwd": 1, "interact_bwd": 1} if interact
                   else {}))
  step = make_sparse_train_step(model, plan, bce_loss, factory, rule,
                                mesh=mesh)
  ms, losses = [], []
  for i in range(W4_SLICED_STEPS):
    reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, loss = step(state, *batch)
    torch.cuda.synchronize(dev)
    ms.append((time.perf_counter() - t0) * 1e3)
    got = read_counts()
    check(got == want, f"{tag} rank {rank} step {i}: launches {got}, "
          f"expected {want}")
    add_counts(totals, got)
    losses.append(float(loss))
    check(np.isfinite(losses[-1]), f"{tag} rank {rank} step {i}: loss "
          f"{losses[-1]}")
  every = gather_blocks(torch.tensor(losses, device=dev), mesh)
  check(torch.equal(every.reshape(WORLD, -1),
                    every[:len(losses)].expand(WORLD, -1)),
        f"{tag}: the ranks' losses differ")
  # serving: one global request through the frozen f32 image
  rng = np.random.default_rng(SEED + 5)
  req_num = rng.standard_normal(
      (SERVE_BATCH, numerical.shape[1])).astype(np.float32)
  req_cats = [rng.integers(0, plan.global_configs[t].input_dim,
                           (SERVE_BATCH,) + tuple(c.shape[1:]))
              .astype(np.int32)
              for t, c in zip(plan.input_table_map, cats)]
  eng = ServeEngine(model, plan, freeze(plan, rule, state, "f32", mesh=mesh),
                    mesh=mesh)
  pred = eng.predict(req_num, req_cats)
  ev = make_sparse_eval_step(model, plan, rule, mesh=mesh)
  with torch.inference_mode():
    ev_pred = gather_blocks(ev(state, *shard_batch((req_num, req_cats),
                                                    mesh)), mesh)
  ev_pred = ev_pred.cpu().numpy()
  check(pred.shape == (SERVE_BATCH,) and np.isfinite(pred).all(),
        f"{tag} rank {rank}: served predictions not finite")
  out["serve_max_abs_diff"] = float(np.abs(pred - ev_pred).max())
  if masked:
    # the serve image packs a narrow class's table lanes without the
    # optimizer's (more rows a physical row), so its masked bags fold
    # their windows in another order than the eval step's (the JAX
    # package's serve and eval differ alike): the f32 class
    check(np.allclose(pred, ev_pred, rtol=1e-5, atol=1e-6),
          f"{tag} rank {rank}: serving differs from the eval step by up "
          f"to {out['serve_max_abs_diff']}")
  else:
    check(np.array_equal(pred.view(np.int32), ev_pred.view(np.int32)),
          f"{tag} rank {rank}: serving differs from the eval step by up "
          f"to {out['serve_max_abs_diff']}")
  out.update({
      "classes": {f"w{plan.classes[k].width}_{plan.classes[k].kind}":
                  len(plan.classes[k].shards_per_rank[rank])
                  for k in plan.class_keys},
      "k4_classes": sorted(f"w{k[0]}" for k in k4_classes(plan, rule)),
      "launches": totals, "launches_per_step": want,
      "k1_chunked": chunked, "step_ms": ms,
      "step_ms_median": statistics.median(ms), "losses": losses,
      "fused_bytes": sum(t.numel() * 4 for t in state["fused"].values()),
      "serve_bit_equal_eval": not masked})
  return out


def _w4_colslice(torch, mesh, backend: str) -> dict:
  """``world4_colslice`` in this rank: the column-sliced Criteo cell
  (SGD, the DLRM; :func:`w4_sliced_plan`) and the Tiny-like narrow cell
  (Adagrad, its 2- and 4-lane slices; :func:`w4_narrow_plan`), each
  through :func:`_w4_sliced_runs`."""
  from distributed_embeddings_torch.models import DLRM, SyntheticModel
  from distributed_embeddings_torch.models.synthetic import generate_batch
  from distributed_embeddings_torch.ops.packed_table import (
      adagrad_rule,
      sgd_rule,
  )
  from distributed_embeddings_torch.training import (
      Adagrad,
      init_sparse_state_direct,
      shard_batch,
  )
  rank, dev = mesh.rank, mesh.device
  out = {}
  vocab, plan = w4_sliced_plan(backend)
  widths = sorted({plan.classes[k].width for k in plan.class_keys
                   if plan.classes[k].kind == "sparse"})
  check(D in widths and min(widths) < D, f"world4_colslice: sparse widths "
        f"{widths}, expected slices beside whole width-{D} tables")
  rule = sgd_rule(TRAIN_LR)
  model = DLRM(vocab, D, tables=False, device=dev,
               generator=torch.Generator().manual_seed(SEED))
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device=dev).manual_seed(SEED + 1 + rank), mesh=mesh)
  out["criteo"] = _w4_sliced_runs(
      torch, mesh, "world4_colslice criteo",
      lambda ov, **kw: w4_sliced_plan(backend, ov, **kw)[1], model, rule,
      sgd_factory(torch), state, w4_batch(torch, vocab, mesh),
      interact=True)
  out["criteo"]["table_col_ranges"] = [len(r) for r in
                                       plan.table_col_ranges]
  del state
  torch.cuda.empty_cache()
  cfg, nplan = w4_narrow_plan(backend)
  widths = sorted({nplan.classes[k].width for k in nplan.class_keys})
  check(widths == [2, 4], f"world4_colslice narrow: widths {widths}")
  rule = adagrad_rule(ZOO_LR)
  adagrad = functools.partial(Adagrad, lr=ZOO_LR)
  model = SyntheticModel(cfg, tables=False, device=dev,
                         generator=torch.Generator().manual_seed(SEED))
  state = init_sparse_state_direct(
      nplan, rule, model.state_dict(), adagrad,
      torch.Generator(device=dev).manual_seed(SEED + 1 + rank), mesh=mesh)
  numerical, cats, labels = generate_batch(cfg, W4_BATCH, alpha=ZOO_ALPHA,
                                           seed=SEED)
  batch = shard_batch((numerical, cats, labels), mesh)
  out["narrow"] = _w4_sliced_runs(
      torch, mesh, "world4_colslice narrow",
      lambda ov, **kw: w4_narrow_plan(backend, ov, **kw)[1], model, rule,
      adagrad, state, batch, interact=False)
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  layouts = DistributedLookup(nplan).fused_layouts(rule)
  out["narrow"]["rows_per_phys"] = {n: lay.rows_per_phys
                                    for n, lay in layouts.items()}
  out["narrow"]["vocab"] = [int(t.input_dim) for t in nplan.global_configs]
  del state, batch, numerical, cats, labels
  torch.cuda.empty_cache()
  return out


def _w4_zoo(torch, mesh, backend: str) -> dict:
  """``zoo_world4`` in this rank: ``utils.zoo_bench.run_zoo_plan_step(
  "tiny")`` (vocabulary cap and batch per backend, ``W4_ZOO_*``), its K6
  and K1 launches as predicted from the plan and the routed batch; then
  the world-4 dense-autodiff zoo step (``SyntheticModel(mesh=)`` owning
  this rank's blocks, ``broadcast_variables``, ``training.Adagrad``,
  ``make_train_step(mesh=)``): one warm-up and ``W4_ZOO_STEPS`` timed
  steps, no kernel launched, the losses finite and equal on every
  rank."""
  import dataclasses

  import numpy as np

  from distributed_embeddings_torch.layers import broadcast_variables
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      SyntheticModel,
      bce_loss,
      expand_tables,
      generate_batch,
  )
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  from distributed_embeddings_torch.parallel.wire import gather_blocks
  from distributed_embeddings_torch.training import (
      Adagrad,
      make_train_step,
      shard_batch,
  )
  from distributed_embeddings_torch.utils.zoo_bench import (
      run_zoo_plan_step,
      zoo_batch,
      zoo_tables,
  )
  rank, dev = mesh.rank, mesh.device
  scale = W4_ZOO_VOCAB_SCALE[backend]
  batch_size = W4_ZOO_BATCH[backend]
  out = {"vocab_scale": f"1/{scale}", "global_batch": batch_size}
  # the plan step: its launches predicted from the recipe's plan and batch
  cap = max(t.input_dim
            for t in expand_tables(SYNTHETIC_MODELS[ZOO_MODEL])[0]) // scale
  b_local = batch_size // WORLD
  _, tables, tmap, hot = zoo_tables(ZOO_MODEL, cap)
  plan = DistEmbeddingStrategy(tables, WORLD, "memory_balanced",
                               input_table_map=tmap, dense_row_threshold=16,
                               input_hotness=hot, batch_hint=batch_size)
  cats = shard_batch(zoo_batch(ZOO_MODEL, batch_size, cap)[1], mesh)
  codes = w4_codes(cats)
  k1, chunked, k6 = k1_launches(plan, DistributedLookup(
      plan, mesh=mesh).route_ids(cats, lambda i: codes[i]))
  del cats
  want = expect(apply_rows=k1, build_delta_rows=k6)
  reset_counts()
  res = run_zoo_plan_step(ZOO_MODEL, mesh, WORLD, b_local=b_local,
                          vocab_cap=cap)
  got = read_counts()
  check(got == want, f"zoo_world4 plan step rank {rank}: launches {got}, "
        f"expected {want}")
  check(np.isfinite(res["loss"]), f"zoo_world4 plan step: loss "
        f"{res['loss']}")
  out["plan_step"] = {**res, "vocab_cap": cap, "b_local": b_local,
                      "launches": got, "k1_chunked": chunked}
  torch.cuda.empty_cache()
  # the dense-autodiff step
  cfg = SYNTHETIC_MODELS[ZOO_MODEL]
  cfg = dataclasses.replace(cfg, embedding_groups=tuple(
      dataclasses.replace(g, num_rows=max(4, g.num_rows // scale))
      for g in cfg.embedding_groups))
  torch.cuda.reset_peak_memory_stats(dev)
  t0 = time.perf_counter()
  model = SyntheticModel(cfg, world_size=WORLD, batch_hint=batch_size,
                         mesh=mesh,
                         generator=torch.Generator().manual_seed(SEED + rank),
                         table_generator=torch.Generator(device=dev)
                         .manual_seed(SEED + 1 + rank))
  broadcast_variables(model, 0, mesh)
  torch.cuda.synchronize(dev)
  init_s = time.perf_counter() - t0
  opt = Adagrad(model.parameters(), lr=ZOO_LR)
  step = make_train_step(lambda m, n, c, y: bce_loss(m(n, c), y), opt, model,
                         mesh=mesh)
  tabs, tmap, _ = expand_tables(cfg)
  numerical, cats, labels = generate_batch(cfg, batch_size, alpha=ZOO_ALPHA,
                                           seed=SEED)
  cats = [np.minimum(c, tabs[t].input_dim - 1).astype(np.int32)
          for c, t in zip(cats, tmap)]
  batch = shard_batch((numerical, cats, labels), mesh)
  ms, losses, totals = [], [], expect()
  for i in range(1 + W4_ZOO_STEPS):
    reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    loss = step(*batch)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    got = read_counts()
    check(got == expect(), f"zoo_world4 dense step {i} rank {rank}: "
          f"launches {got}, expected none")
    add_counts(totals, got)
    if i:
      ms.append((t1 - t0) * 1e3)
    losses.append(float(loss))
    check(np.isfinite(losses[-1]), f"zoo_world4 dense step {i}: loss "
          f"{losses[-1]}")
  every = gather_blocks(torch.tensor(losses, device=dev), mesh)
  check(torch.equal(every.reshape(WORLD, -1),
                    every[:len(losses)].expand(WORLD, -1)),
        "zoo_world4 dense: the ranks' losses differ")
  out["dense"] = {
      "init_s": init_s, "step_ms": ms, "step_ms_median": statistics.median(ms),
      "losses": losses, "launches": totals,
      "class_bytes": sum(p.numel() * 4 for p in
                         model.embeddings.class_params().values()),
      "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
  del model, opt, step, batch
  torch.cuda.empty_cache()
  return out


def world4_rank(rank: int, port: int, backend: str, outdir: str) -> None:
  """One rank of the world-4 phase (a spawned process): the world-4
  golden, then the sparse path at f32 and bf16 compute, the dense-autodiff
  path (:func:`_w4_dense`) and serving (:func:`_w4_serve`). Writes its
  result to ``outdir/rank<rank>.json``."""
  import os

  import numpy as np
  import torch

  from distributed_embeddings_torch import train_golden
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.mesh import create_mesh
  from distributed_embeddings_torch.parallel.wire import gather_blocks
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  mesh = create_mesh(WORLD, rank, f"tcp://127.0.0.1:{port}", device="cuda")
  check(mesh.backend == backend,
        f"rank {rank}: backend {mesh.backend}, expected {backend}")
  dev = mesh.device
  out = {"rank": rank, "backend": mesh.backend, "device": str(dev)}
  try:
    # the committed world-4 golden's bf16 run, under the fused schedule
    golden = train_golden.load(train_golden.WORLD4_PATH)
    losses, got, preds = train_golden.replay_world4(golden, mesh,
                                                    compute="bf16")
    if rank == 0:
      try:
        worst = train_golden.compare_world4(golden, losses, got, preds)
      except AssertionError as exc:
        raise SmokeFailure(f"world-4 golden: {exc}") from exc
      out["golden"] = {"compute": "bf16", "losses": losses,
                       "want_losses": [float(v)
                                       for v in golden["bf16_losses"]],
                       **worst, "loss_tol": train_golden.LOSS_TOL,
                       "update_tol": train_golden.UPDATE_TOL}

    vocab, plan = world4_plan(backend)
    k4_per_step = k4_launches_per_step(plan)
    batch = w4_batch(torch, vocab, mesh)
    out["runs"] = {}
    for compute in ("f32", "bf16"):
      dtype = torch.float32 if compute == "f32" else torch.bfloat16
      model = DLRM(vocab, D, compute_dtype=dtype, tables=False, device=dev,
                   generator=torch.Generator().manual_seed(SEED))
      rule = sgd_rule(TRAIN_LR)
      torch.cuda.reset_peak_memory_stats(dev)
      t0 = time.perf_counter()
      state = init_sparse_state_direct(
          plan, rule, model.state_dict(), sgd_factory(torch),
          torch.Generator(device=dev).manual_seed(SEED + 1 + rank),
          mesh=mesh)
      torch.cuda.synchronize(dev)
      init_s = time.perf_counter() - t0
      touch = _w4_touch_counts(torch, plan, mesh, batch[1], state)
      # sampled rows of the first sparse class, touched and not
      name = next(iter(state["fused"]))
      buf = state["fused"][name]
      pick = torch.Generator(device=dev).manual_seed(SEED + 2)
      hit = torch.nonzero(touch[name] > 0).squeeze(1)
      miss = torch.nonzero(touch[name] == 0).squeeze(1)
      hit = hit[torch.randperm(hit.numel(), generator=pick,
                               device=dev)[:ROWS_SAMPLED]]
      miss = miss[torch.randperm(miss.numel(), generator=pick,
                                 device=dev)[:ROWS_SAMPLED]]
      miss_rows = buf[miss].clone()
      step = make_sparse_train_step(model, plan, bce_loss,
                                    sgd_factory(torch), rule, mesh=mesh)
      want = expect(gather_rows=k4_per_step, apply_rows=len(state["fused"]),
                    interact_fwd=1, interact_bwd=1)
      totals = expect()
      ms, losses, changed = [], [], []
      for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        hit_rows = buf[hit].clone()
        reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        got = read_counts()
        check(got == want, f"world 4 {compute} rank {rank} step {i}: "
              f"launches {got}, expected {want}")
        add_counts(totals, got)
        if i >= TRAIN_WARMUP:
          ms.append((t1 - t0) * 1e3)
        losses.append(float(loss))
        check(np.isfinite(losses[-1]),
              f"world 4 {compute} rank {rank} step {i}: loss {losses[-1]}")
        check(torch.equal(buf[miss], miss_rows),
              f"world 4 {compute} rank {rank} step {i}: rows the batch "
              "does not touch changed")
        changed.append((buf[hit] != hit_rows).any(dim=1).float().mean()
                       .item())
        check(changed[-1] > 0.5,
              f"world 4 {compute} rank {rank} step {i}: only "
              f"{changed[-1]:.1%} of the sampled touched rows changed")
      run = {"step_ms": ms, "step_ms_median": statistics.median(ms),
             "losses": losses, "touched_rows_changed_share": changed,
             "launches": totals, "launches_per_step": want,
             "init_s": init_s,
             "fused_bytes": sum(t.numel() * 4
                                for t in state["fused"].values()),
             "sparse_buckets_k4": k4_per_step // (WORLD * W4_CHUNKS)}
      torch.cuda.synchronize(dev)
      run["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
      # every rank's losses, to check they agree
      all_losses = gather_blocks(torch.tensor(losses, device=dev), mesh)
      run["losses_agree"] = bool(torch.equal(
          all_losses.reshape(WORLD, -1),
          all_losses[:len(losses)].expand(WORLD, -1)))
      check(run["losses_agree"], f"world 4 {compute}: ranks' losses differ")
      if rank == 0:
        run["trace"] = trace_call(torch, lambda: step(state, *batch),
                                  kernels=K4_TRACE)
      else:
        step(state, *batch)
      if compute == "f32":
        run["fused_vs_none"] = _w4_compare_none(
            torch, mesh, model, vocab, backend, state, batch, touch)
      out["runs"][compute] = run
      del state, buf, step, touch
      torch.cuda.empty_cache()
    out["wire"] = _w4_wire(torch, mesh, backend, batch)
    out["ragged"] = _w4_ragged(torch, mesh, backend)
    out["guard_mb"] = _w4_guard_mb(torch, mesh, backend, batch)
    out["ckpt"] = _w4_ckpt(torch, mesh, backend, outdir)
    out["dense"] = _w4_dense(torch, mesh, backend, batch)
    out["serve"] = _w4_serve(torch, mesh, outdir)
    del batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["narrow"] = _w4_narrow(torch, mesh, backend, outdir)
    out["narrow"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["colslice"] = _w4_colslice(torch, mesh, backend)
    out["colslice"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["zoo"] = _w4_zoo(torch, mesh, backend)
    out["zoo"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["tiered"] = _w4_tiered(torch, mesh, backend)
    out["tiered"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["serve_tiered"] = _w4_serve_tiered(torch, mesh, backend)
    out["serve_tiered"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # last: it forms the default process group again at each world
    t0 = time.perf_counter()
    out["elastic"] = _w4_elastic(torch, mesh, backend, outdir)
    out["elastic"]["wall_s"] = time.perf_counter() - t0
  finally:
    mesh.close()
  with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)


def phase_world4(torch, smi: str) -> dict:
  """The world-4 hybrid-parallel train step: four ranks spawned with
  ``torch.multiprocessing``, NCCL when each owns a card, else gloo with
  the four sharing the card. Returns each kernel's launches in the run
  (summed over the ranks)."""
  import os
  import socket
  import tempfile

  import torch.multiprocessing as mp

  backend = "nccl" if torch.cuda.device_count() >= WORLD else "gloo"
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
  outdir = tempfile.mkdtemp(prefix="chip_smoke_world4_")
  t0 = time.perf_counter()
  mp.spawn(world4_rank, args=(port, backend, outdir), nprocs=WORLD,
           join=True)
  wall_s = time.perf_counter() - t0
  ranks = []
  for rank in range(WORLD):
    with open(os.path.join(outdir, f"rank{rank}.json")) as f:
      ranks.append(json.load(f))
  _, plan = world4_plan(backend)
  emit({"phase": "world4_golden", "backend": backend, **ranks[0]["golden"]})
  totals = expect()
  for compute in ("f32", "bf16"):
    runs = [r["runs"][compute] for r in ranks]
    med = max(r["step_ms_median"] for r in runs)
    for rank, r in enumerate(runs):
      check(set(r["launches"]) == set(COUNTERS),
            f"world 4 {compute} rank {rank}: counts of "
            f"{sorted(r['launches'])}")
      add_counts(totals, r["launches"])
    emit({"phase": "train_world4", "compute": compute, "backend": backend,
          "mode": ("four cards, one rank each" if backend == "nccl" else
                   "one card shared by the four ranks"),
          "cards": torch.cuda.device_count(), "card": smi,
          "vocab_scale": f"1/{W4_VOCAB_SCALE[backend]}",
          "row_slice": W4_ROW_SLICE[backend], "global_batch": W4_BATCH,
          "exchange_chunks": W4_CHUNKS,
          "sparse_buckets": runs[0]["sparse_buckets_k4"],
          "fused_bytes_per_rank": [r["fused_bytes"] for r in runs],
          "init_s": [r["init_s"] for r in runs],
          "step_ms": runs[0]["step_ms"],
          "step_ms_median_by_rank": [r["step_ms_median"] for r in runs],
          "step_ms_median": med, "samples_per_s": W4_BATCH / (med / 1e3),
          "peak_gib_by_rank": [r["peak_gib"] for r in runs],
          "launches_per_step_per_rank": runs[0]["launches_per_step"],
          "losses": runs[0]["losses"], "losses_agree": True,
          "touched_rows_changed_share": runs[0]["touched_rows_changed_share"],
          "untouched_rows_bit_equal": True,
          **({"fused_vs_none": [r["fused_vs_none"] for r in runs],
              "none_step_ms_median": max(
                  r["fused_vs_none"]["none_step_ms_median"] for r in runs)}
             if compute == "f32" else {})})
    emit({"phase": "train_world4_trace", "compute": compute,
          "backend": backend, "rank": 0, "card": smi,
          **runs[0]["trace"]})
  wire_totals = emit_wire_world4(backend, smi, [r["wire"] for r in ranks])
  ragged_totals = emit_ragged_world4(backend, smi,
                                     [r["ragged"] for r in ranks])
  guard, mb = emit_guard_mb_world4(backend, smi,
                                   [r["guard_mb"] for r in ranks])
  ckpt_totals = emit_ckpt_world4(backend, smi, [r["ckpt"] for r in ranks])
  dense_totals = emit_dense_world4(backend, smi, [r["dense"] for r in ranks])
  serve_totals = emit_serve_world4(backend, smi,
                                   [r["serve"] for r in ranks])
  narrow_totals = emit_narrow_world4(backend, smi,
                                     [r["narrow"] for r in ranks])
  colslice_totals = emit_colslice_world4(backend, smi,
                                         [r["colslice"] for r in ranks])
  zoo_plan_totals, zoo_dense_totals = emit_zoo_world4(
      backend, smi, [r["zoo"] for r in ranks])
  tiered_totals = emit_tiered_world4(backend, smi,
                                     [r["tiered"] for r in ranks])
  serve_tiered_totals, batcher_totals = emit_serve_tiered_world4(
      backend, smi, [r["serve_tiered"] for r in ranks])
  elastic_totals = emit_elastic_world4(backend, smi,
                                       [r["elastic"] for r in ranks])
  emit({"phase": "world4", "wall_s": wall_s,
        "serve_tiered_wall_s": [r["serve_tiered"]["wall_s"] for r in ranks],
        "elastic_wall_s": [r["elastic"]["wall_s"] for r in ranks]})
  ckpt1_totals = phase_world4_ckpt_world1(
      torch, smi, backend, os.path.join(outdir, "ckpt"),
      [r["ckpt"]["checksums"] for r in ranks])
  return {"train_world4": totals, "world4_ckpt": ckpt_totals,
          "train_dense_world4": dense_totals, "serve_world4": serve_totals,
          "train_world4_guard": guard, "train_world4_mb": mb,
          "world4_wire": wire_totals, "world4_ragged": ragged_totals,
          "world4_colslice": colslice_totals,
          "zoo_world4_plan": zoo_plan_totals,
          "zoo_world4_dense": zoo_dense_totals,
          "world4_bf16": narrow_totals, "world4_tiered": tiered_totals,
          "world4_serve_tiered": serve_tiered_totals,
          "world4_batcher": batcher_totals, "world4_elastic": elastic_totals,
          "world4_ckpt_world1": ckpt1_totals}


def emit_colslice_world4(backend: str, smi: str, res: list) -> dict:
  """The ``world4_colslice`` lines (one per cell) from the ranks'
  :func:`_w4_colslice` results; returns each kernel's launches summed
  over the ranks and cells."""
  totals = expect()
  for cell in ("criteo", "narrow"):
    runs = [r[cell] for r in res]
    for rank, r in enumerate(runs):
      check(set(r["launches"]) == set(COUNTERS),
            f"world4_colslice {cell} rank {rank}: counts of "
            f"{sorted(r['launches'])}")
      add_counts(totals, r["launches"])
    med = max(r["step_ms_median"] for r in runs)
    emit({"phase": "world4_colslice", "cell": cell, "backend": backend,
          "mode": ("four cards, one rank each" if backend == "nccl" else
                   "one card shared by the four ranks"),
          "card": smi,
          "vocab_scale": "1/%d" % (W4_VOCAB_SCALE["gloo"] if cell == "criteo"
                                   else W4_VOCAB_SCALE[backend]),
          "global_batch": W4_BATCH, "exchange_chunks": W4_CHUNKS,
          "column_slice_threshold": (W4_COL_SLICE if cell == "criteo"
                                     else W4_NARROW_SLICE),
          **{k: runs[0][k] for k in ("classes", "k4_classes",
                                     "k4_per_forward", "launches_per_step",
                                     "k1_chunked", "losses")},
          **{k: runs[0][k] for k in ("table_col_ranges", "rows_per_phys",
                                     "vocab") if k in runs[0]},
          "classes_by_rank": [r["classes"] for r in runs],
          "forward_ms_by_rank": [r["forward_ms"] for r in runs],
          "fused_bytes_per_rank": [r["fused_bytes"] for r in runs],
          "step_ms_by_rank": [r["step_ms"] for r in runs],
          "step_ms_median": med, "samples_per_s": W4_BATCH / (med / 1e3),
          "losses_agree": True,
          **{k: runs[0][k] for k in ("masked_gather", "serve_bit_equal_eval")},
          "dedup_max_abs_diff_by_rank": [r.get("dedup_max_abs_diff")
                                         for r in runs],
          "serve_max_abs_diff_by_rank": [r["serve_max_abs_diff"]
                                         for r in runs],
          "wall_s_by_rank": [r["wall_s"] for r in res]})
  return totals


def emit_zoo_world4(backend: str, smi: str, res: list) -> tuple:
  """The ``zoo_world4`` lines (the plan step, the dense step) from the
  ranks' :func:`_w4_zoo` results; returns each path's launches summed
  over the ranks."""
  plan_totals, dense_totals = expect(), expect()
  for rank, r in enumerate(res):
    for part, tot in (("plan_step", plan_totals), ("dense", dense_totals)):
      check(set(r[part]["launches"]) == set(COUNTERS),
            f"zoo_world4 {part} rank {rank}: counts of "
            f"{sorted(r[part]['launches'])}")
      add_counts(tot, r[part]["launches"])
  losses = [r["plan_step"]["loss"] for r in res]
  check(len(set(losses)) == 1, f"zoo_world4 plan step: losses {losses}")
  mode = ("four cards, one rank each" if backend == "nccl" else
          "one card shared by the four ranks")
  emit({"phase": "zoo_world4", "part": "plan_step", "backend": backend,
        "mode": mode, "card": smi, "model": ZOO_MODEL,
        "cuts": {"vocabulary": res[0]["vocab_scale"],
                 "global_batch": res[0]["global_batch"]},
        **{k: res[0]["plan_step"][k] for k in
           ("tables", "inputs", "classes", "loss", "vocab_cap", "b_local",
            "k1_chunked")},
        "plan_s_by_rank": [r["plan_step"]["plan_s"] for r in res],
        "init_s_by_rank": [r["plan_step"]["init_s"] for r in res],
        "step_s_by_rank": [r["plan_step"]["step_s"] for r in res],
        "launches_per_rank": res[0]["plan_step"]["launches"]})
  med = max(r["dense"]["step_ms_median"] for r in res)
  batch = res[0]["global_batch"]
  emit({"phase": "zoo_world4", "part": "dense", "backend": backend,
        "mode": mode, "card": smi, "model": ZOO_MODEL,
        "cuts": {"vocabulary": res[0]["vocab_scale"],
                 "global_batch": batch},
        "optimizer": "training.Adagrad", "lr": ZOO_LR,
        "class_bytes_per_rank": [r["dense"]["class_bytes"] for r in res],
        "init_s": [r["dense"]["init_s"] for r in res],
        "step_ms_by_rank": [r["dense"]["step_ms"] for r in res],
        "step_ms_median": med, "samples_per_s": batch / (med / 1e3),
        "peak_gib_by_rank": [r["dense"]["peak_gib"] for r in res],
        "losses": res[0]["dense"]["losses"], "losses_agree": True,
        "launches": dense_totals,
        "wall_s_by_rank": [r["wall_s"] for r in res]})
  return plan_totals, dense_totals


def emit_wire_world4(backend: str, smi: str, res: list) -> dict:
  """The ``world4_wire`` line from the ranks' :func:`_w4_wire` results;
  returns each kernel's launches summed over the ranks."""
  totals = expect()
  for r in res:
    add_counts(totals, r.pop("launches"))
  check(all(r["overflow"] == res[0]["overflow"] for r in res),
        "world 4 wire: the ranks' dedup_overflow counts differ")
  variants = {}
  for name in res[0]["variants"]:
    runs = [r["variants"][name] for r in res]
    check(all(v["losses"] == runs[0]["losses"] for v in runs),
          f"world 4 wire {name}: the ranks' losses differ")
    variants[name] = {**{k: v for k, v in runs[0].items()
                         if k != "step_ms_median"},
                      "step_ms_median": max(v["step_ms_median"]
                                            for v in runs)}
  emit({"phase": "world4_wire", "backend": backend, "card": smi,
        "mode": ("four cards, one rank each" if backend == "nccl" else
                 "one card shared by the four ranks"),
        "vocab_scale": f"1/{W4_VOCAB_SCALE[backend]}",
        "global_batch": W4_BATCH, "exchange_chunks": W4_CHUNKS,
        "variants": variants,
        "unique_share_by_rank": [r["unique_share"] for r in res],
        "dedup_overflow": res[0]["overflow"],
        "serve_bit_equal": True, "wire_bytes_per_rank_step":
            res[0]["wire_bytes"],
        "k4_per_forward": res[0]["k4_per_forward"], "launches": totals})
  return totals


def emit_guard_mb_world4(backend: str, smi: str, res: list) -> tuple:
  """The ``world4_guard_mb`` line from the ranks' :func:`_w4_guard_mb`
  results; returns the guarded and the micro-batch runs' launches, each
  summed over the ranks."""
  guard, mb = expect(), expect()
  for r in res:
    add_counts(guard, r.pop("guard_launches"))
    add_counts(mb, r.pop("mb_launches"))
  check(all(r["bad_step"] == 1 for r in res),
        "world 4: a rank did not skip the poisoned step")
  emit({"phase": "world4_guard_mb", "backend": backend, "card": smi,
        "nan_rank": W4_NAN_RANK, "bad_step_by_rank": [1] * len(res),
        "arrays_bit_equal_by_rank": [r["arrays_bit_equal"] for r in res],
        "k4_per_step": res[0]["k4_per_step"],
        "mb_by_rank": [r["mb"] for r in res],
        "mb_max_abs_err": max(r["mb_max_abs_err"] for r in res),
        "mb_cells_differing": [r["mb_cells_differing"] for r in res],
        "launches_guard": guard, "launches_mb": mb})
  return guard, mb


def emit_ckpt_world4(backend: str, smi: str, ckpt: list) -> dict:
  """The ``world4_ckpt`` line from the ranks' :func:`_w4_ckpt` results;
  returns each kernel's launches summed over the ranks."""
  ckpt_totals = expect()
  for r in ckpt:
    add_counts(ckpt_totals, r.pop("launches"))
  emit({"phase": "world4_ckpt", "backend": backend, "card": smi,
        "vocab_scale": ckpt[0]["vocab_scale"],
        "row_slice": W4_ROW_SLICE[backend], "global_batch": W4_BATCH,
        "bytes": ckpt[0]["bytes"], "files": ckpt[0]["files"],
        "disk_free_bytes": ckpt[0]["disk_free_bytes"],
        "verify_s": ckpt[0]["verify_s"],
        "save_s_by_rank": [r["save_s"] for r in ckpt],
        "restore_s_by_rank": [r["restore_s"] for r in ckpt],
        "fused_bytes_per_rank": [r["fused_bytes"] for r in ckpt],
        "peak_gib_by_rank": [r["peak_gib"] for r in ckpt],
        "restored_bit_equal": True,
        "loss_after_restore_by_rank": [r["loss_after_restore"]
                                       for r in ckpt],
        "losses_bit_equal": all(r["losses_bit_equal"] for r in ckpt),
        "launches_per_step_per_rank": ckpt[0]["launches_per_step"],
        "launches": ckpt_totals})
  return ckpt_totals


def emit_dense_world4(backend: str, smi: str, dense: list) -> dict:
  """The ``world4_dense_golden``, ``train_dense_world4`` and
  ``train_dense_world4_trace`` lines from the ranks' :func:`_w4_dense`
  results; returns each kernel's launches summed over the ranks and
  computes."""
  emit({"phase": "world4_dense_golden", "backend": backend,
        **dense[0]["golden"]})
  totals = expect()
  for compute in ("f32", "bf16"):
    runs = [r["runs"][compute] for r in dense]
    for rank, r in enumerate(runs):
      check(set(r["launches"]) == set(COUNTERS),
            f"dense world 4 {compute} rank {rank}: counts of "
            f"{sorted(r['launches'])}")
      add_counts(totals, r["launches"])
    med = max(r["step_ms_median"] for r in runs)
    emit({"phase": "train_dense_world4", "compute": compute,
          "backend": backend,
          "mode": ("four cards, one rank each" if backend == "nccl" else
                   "one card shared by the four ranks"),
          "card": smi, "vocab_scale": f"1/{W4_VOCAB_SCALE[backend]}",
          "row_slice": W4_ROW_SLICE[backend], "global_batch": W4_BATCH,
          "overlap": "fused", "exchange_chunks": W4_CHUNKS,
          "class_bytes_per_rank": [r["class_bytes"] for r in runs],
          "init_s": [r["init_s"] for r in runs],
          "step_ms_by_rank": [r["step_ms"] for r in runs],
          "step_ms_median_by_rank": [r["step_ms_median"] for r in runs],
          "step_ms_median": med, "samples_per_s": W4_BATCH / (med / 1e3),
          "peak_gib_by_rank": [r["peak_gib"] for r in runs],
          "launches_per_step_per_rank": runs[0]["launches_per_step"],
          "losses": runs[0]["losses"], "losses_agree": True,
          "replicated_params_bit_equal": runs[0]["replicated_params"],
          "touched_rows_changed_share": runs[0]["touched_rows_changed_share"],
          "untouched_rows_bit_equal": True})
    emit({"phase": "train_dense_world4_trace", "compute": compute,
          "backend": backend, "rank": 0, "card": smi, **runs[0]["trace"]})
  return totals


def emit_serve_world4(backend: str, smi: str, serve: list) -> dict:
  """The ``serve_world4`` line from the ranks' :func:`_w4_serve`
  results; returns each kernel's launches summed over the ranks."""
  totals = expect()
  for r in serve:
    add_counts(totals, r["launches"])
  emit({"phase": "serve_world4", "backend": backend, "card": smi,
        "vocab_scale": f"1/{W4_VOCAB_SCALE['gloo']}", "quantize": "f32",
        "global_batch": SERVE_BATCH, "requests": SERVE_REQUESTS,
        "request_ms_by_rank": [r["request_ms"] for r in serve],
        "export_s_by_rank": [r["export_s"] for r in serve],
        "load_s_by_rank": [r["load_s"] for r in serve],
        "serve_bytes_per_rank": [r["serve_bytes"] for r in serve],
        "ranks_equal": True, "bit_equal_frozen": True,
        "bit_equal_eval": True, "launches_per_rank": serve[0]["launches"]})
  return totals


def flat_feats(torch, b: int, seed: int):
  gen = torch.Generator(device="cuda").manual_seed(seed)
  return (torch.randn((b, F, D), generator=gen, device="cuda") * 0.3) \
      .to(torch.bfloat16)


def phase_kernel_flat_fwd(torch, ci, flush) -> dict:
  """K3-fwd against its plain version (K2-fwd's tolerance class); returns
  the B=65536, k=-1 row."""
  main = None
  for b in K3_BATCHES:
    for k in (-1, 0):
      feats = flat_feats(torch, b, SEED + 11 * b - k)
      got = ci.interact_flat_fwd(feats, k)
      torch.cuda.synchronize()
      want = ci.interact_flat_fwd_plain(feats, k)
      rows, cols = ci.tril_pairs(F, k)
      check(tuple(got.shape) == (b, len(rows)), f"shape {tuple(got.shape)}")
      checked = fwd_check(torch, ci, "interact_flat_fwd", got, want, feats,
                          k)
      idx = torch.as_tensor(rows * F + cols, device="cuda")
      npair = len(rows)
      timed = event_ms(torch, {
          "kernel_ms": lambda: ci.interact_flat_fwd(feats, k),
          "plain_ms": lambda: ci.interact_flat_fwd_plain(feats, k),
          "library_ms": lambda: torch.bmm(feats, feats.transpose(1, 2))
          .flatten(1).index_select(1, idx).float()}, flush)
      row = {
          "phase": "kernel", "name": "interact_flat_fwd", "B": b, "F": F,
          "D": D, "k": k, "cells": got.numel(), **checked,
          "max_abs_err": (got - want).abs().max().item(),
          **timed, **bound(b * (F * D * 2 + npair * 4), 2 * npair * D * b,
                           BF16_FLOPS)}
      emit(row)
      if b == TRAIN_BATCH and k == -1:
        main = row
  fwd_edges(torch, ci, "interact_flat_fwd")
  return main


def phase_kernel_flat_bwd(torch, ci, flush) -> dict:
  """K3-bwd against its plain version (K2-bwd's tolerance class); returns
  the B=65536, k=-1 row."""
  main = None
  for b in K3_BATCHES:
    for k in (-1, 0):
      feats = flat_feats(torch, b, SEED + 13 * b - k)
      npair = len(ci.tril_pairs(F, k)[0])
      gen = torch.Generator(device="cuda").manual_seed(SEED + 3 * b + k)
      d_acts = torch.randn((b, npair), generator=gen, device="cuda")
      got = ci.interact_flat_bwd(d_acts, feats, k).float()
      torch.cuda.synchronize()
      want = ci.interact_flat_bwd_plain(d_acts, feats, k).float()
      check(tuple(got.shape) == (b, F, D), f"shape {tuple(got.shape)}")
      differ, worst = bwd_check(torch, ci, "interact_flat_bwd", got, want,
                                d_acts, feats, k)
      coef_bf16 = ci.pair_coefficients(d_acts, F, k).to(torch.bfloat16)
      timed = event_ms(torch, {
          "kernel_ms": lambda: ci.interact_flat_bwd(d_acts, feats, k),
          "plain_ms": lambda: ci.interact_flat_bwd_plain(d_acts, feats, k),
          "library_ms": lambda: torch.bmm(coef_bf16, feats)}, flush)
      row = {
          "phase": "kernel", "name": "interact_flat_bwd", "B": b, "F": F,
          "D": D, "k": k, "cells": got.numel(), "cells_differ": differ,
          "max_allowance_share": worst,
          "max_abs_err": (got - want).abs().max().item(), **timed,
          **bound(b * (npair * 4 + 2 * F * D * 2), 2 * F * F * D * b,
                  BF16_FLOPS)}
      emit(row)
      if b == TRAIN_BATCH and k == -1:
        main = row
  bwd_edges(torch, ci, "interact_flat_bwd")
  return main


def k5_ids(torch, n: int, rows: int, stream: str, gen):
  """int32 ids of one send block: uniform, or with ``K4_BAD_SHARE`` of
  them out of range or sentinels (as K4's streams)."""
  ids = torch.randint(0, rows, (n,), generator=gen, device=gen.device,
                      dtype=torch.int32)
  if stream == "out_of_range":
    bad = torch.rand((n,), generator=gen, device=gen.device) < K4_BAD_SHARE
    junk = torch.tensor([rows, -1, rows + 7, 2**31 - 1, -2**31],
                        dtype=torch.int32, device=gen.device)[
        torch.randint(0, 5, (n,), generator=gen, device=gen.device)]
    ids = torch.where(bad, junk, ids)
  return ids


def link_rate(torch, src: int, dst: int) -> float:
  """Bytes per second of one 1 GiB ``copy_`` from card ``src`` to card
  ``dst`` (median of 5, timed with CUDA events on ``src``): the peer
  link's rate as this machine delivers it."""
  a = torch.empty(2**28, dtype=torch.float32, device=f"cuda:{src}")
  b = torch.empty_like(a, device=f"cuda:{dst}")
  b.copy_(a)
  times = []
  with torch.cuda.device(src):
    for _ in range(5):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      b.copy_(a)
      end.record()
      end.synchronize()
      times.append(start.elapsed_time(end))
  torch.cuda.synchronize(dst)
  return a.numel() * 4 / (statistics.median(times) / 1e3)


def phase_kernel_send(torch, cx, flush) -> dict:
  """K5 against its plain version, bit for bit, at K4's block shape (the
  first sparse class's rank buffer of the four-card world-4 plan, one
  block of 8,192 int32 ids, uniform and 30 % out of range): as a loopback
  round on the first card and, on a machine with two or more cards, as
  the rotate-by-k rounds k = 1 .. n-1 across the cards from this one
  process (peer access enabled; no staging through the host). Returns
  the loopback uniform row."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
  )
  _, plan = world4_plan("nccl")
  key, _, rows = first_sparse_class(plan)
  n = class_buckets(plan, key, lambda i: 1)[0].n_b * (
      W4_BATCH // WORLD // W4_CHUNKS)
  lanes = cx.LANES
  cards = torch.cuda.device_count()
  bufs, gens = [], []
  for c in range(cards):
    gens.append(torch.Generator(device=f"cuda:{c}").manual_seed(SEED + 50 + c))
    bufs.append(torch.rand((rows, lanes), generator=gens[c],
                           device=f"cuda:{c}"))
  main = None
  for stream in ("uniform", "out_of_range"):
    ids = [k5_ids(torch, n, rows, stream, g) for g in gens]
    n_valid = int(((ids[0] >= 0) & (ids[0] < rows)).sum().item())
    dst = torch.full((n, lanes), float("nan"), device="cuda")
    got = cx.gather_send_rows(bufs[0], ids[0], dst)
    torch.cuda.synchronize()
    check(torch.equal(got, cx.gather_send_rows_plain(bufs[0], ids[0])),
          f"gather_send_rows loopback {stream}: not bit-equal to the plain "
          "version")
    timed = event_ms(torch, {
        "kernel_ms": lambda: cx.gather_send_rows(bufs[0], ids[0], dst),
        "plain_ms": lambda: cx.gather_send_rows_plain(bufs[0], ids[0]),
        "library_ms": lambda: bufs[0].index_select(
            0, ids[0].clamp(0, rows - 1))}, flush)
    row = {"phase": "kernel", "name": "gather_send_rows", "round":
           "loopback", "stream": stream, "rows": rows, "width": lanes,
           "ids": n, "valid_ids": n_valid, "bit_equal": True,
           "max_abs_err": 0.0, **timed,
           "library_note": "index_select of clamped ids: no zero rows",
           **bound(n * 4 + n_valid * lanes * 4 + n * lanes * 4, 0,
                   F32_FLOPS)}
    emit(row)
    if stream == "uniform":
      main = row
    if cards < 2:
      continue
    # rotate-by-k rounds: card i pushes its block into card (i + k)'s
    # receive buffer, every card at once
    for k in range(1, cards):
      dsts = [torch.full((n, lanes), float("nan"), device=f"cuda:{c}")
              for c in range(cards)]
      for i in range(cards):
        cx.gather_send_rows(bufs[i], ids[i], dsts[(i + k) % cards])
        check(torch.cuda.current_device() == 0,
              f"gather_send_rows from card {i}: the caller's current card "
              f"became {torch.cuda.current_device()}")
      for c in range(cards):
        torch.cuda.synchronize(c)
      for j in range(cards):
        i = (j - k) % cards
        check(torch.equal(dsts[j], cx.gather_send_rows_plain(
            bufs[i], ids[i], device=f"cuda:{j}")),
              f"gather_send_rows round k={k} {stream}: card {j}'s receive "
              f"buffer differs from card {i}'s rows")
      del dsts
    peer = torch.full((n, lanes), float("nan"), device="cuda:1")
    lib = torch.empty_like(peer)
    rate = link_rate(torch, 0, 1)
    timed = event_ms(torch, {
        "kernel_ms": lambda: cx.gather_send_rows(bufs[0], ids[0], peer),
        "plain_ms": lambda: cx.gather_send_rows_plain(bufs[0], ids[0],
                                                      device="cuda:1"),
        "library_ms": lambda: lib.copy_(bufs[0].index_select(
            0, ids[0].clamp(0, rows - 1)))}, flush)
    torch.cuda.synchronize(1)
    emit({"phase": "kernel", "name": "gather_send_rows", "round":
          "remote", "cards": cards, "rounds_bit_equal": cards - 1,
          "stream": stream, "rows": rows, "ids": n, "valid_ids": n_valid,
          "bit_equal": True, "max_abs_err": 0.0, **timed,
          "library_note": "index_select, then copy_ to the peer card",
          "link_bytes_per_s": rate,
          "link_source": "median of five 1 GiB copy_ from card 0 to card 1",
          "bound_ms": max(n * lanes * 4 / rate,
                          (n * 4 + n_valid * lanes * 4) / HBM_BYTES_PER_S)
          * 1e3, "bound_by": "link bytes"})
    del peer, lib
  del bufs
  for c in range(cards):
    with torch.cuda.device(c):
      torch.cuda.empty_cache()
  return main


def phase_dense_golden(torch) -> None:
  """The JAX dense-autodiff golden's bf16 run replayed through the port's
  ``make_train_step`` (on the card the interaction runs in bf16 whatever
  the compute dtype, which only the bf16 run shares with the CPU
  golden)."""
  from distributed_embeddings_torch import train_golden
  data = train_golden.load(train_golden.DENSE_PATH)
  losses, got = train_golden.replay_dense(data, "bf16", device="cuda")
  try:
    worst = train_golden.compare_dense(data, losses, got, "bf16")
  except AssertionError as exc:
    raise SmokeFailure(f"dense golden: {exc}") from exc
  emit({"phase": "dense_golden", "compute": "bf16", "losses": losses,
        "want_losses": [float(v) for v in data["bf16_losses"]], **worst,
        "loss_tol": train_golden.LOSS_TOL,
        "update_tol": train_golden.UPDATE_TOL})


def phase_train_dense(torch, smi: str, compute: str) -> dict:
  """The README Quick start's dense-autodiff train step at full width
  (``DLRM`` owning its ``DistributedEmbedding``, ``make_train_step``,
  ``torch.optim.SGD``); with bf16 compute, then one dense and one fused
  sparse SGD step from one state, compared. Returns each kernel's
  launches in the timed run."""
  from distributed_embeddings_torch import train_golden
  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.training import make_train_step

  vocab = criteo_vocab()
  plan = train_plan()
  dtype = torch.float32 if compute == "f32" else torch.bfloat16
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  model = DLRM(vocab, D, compute_dtype=dtype, dense_row_threshold=4096,
               batch_hint=TRAIN_BATCH, device="cuda",
               generator=torch.Generator().manual_seed(SEED),
               table_generator=torch.Generator(device="cuda")
               .manual_seed(SEED))
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  check(model.embeddings.plan.class_keys == plan.class_keys,
        "the model's embedding plan is not dlrm_embedding_plan's")
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  b = TRAIN_BATCH
  numerical = torch.randn((b, 13), generator=gen, device="cuda")
  cats = [torch.randint(0, v, (b,), generator=gen, device="cuda",
                        dtype=torch.int32) for v in vocab]
  labels = torch.randint(0, 2, (b,), generator=gen, device="cuda").float()
  key, name, rows = first_sparse_class(plan)
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  touched = torch.zeros((rows,), dtype=torch.bool, device="cuda")
  for bk, v in DistributedLookup(plan).route_ids(cats).items():
    if bk.class_key == key:
      touched[v.reshape(-1)] = True
  pick = torch.Generator(device="cuda").manual_seed(SEED + 2)
  hit = torch.nonzero(touched).squeeze(1)
  miss = torch.nonzero(~touched).squeeze(1)
  hit = hit[torch.randperm(hit.numel(), generator=pick,
                           device="cuda")[:ROWS_SAMPLED]]
  miss = miss[torch.randperm(miss.numel(), generator=pick,
                             device="cuda")[:ROWS_SAMPLED]]
  buf = model.embeddings.class_params()[name]
  miss_rows = buf[miss].detach().clone()
  opt = torch.optim.SGD(model.parameters(), lr=TRAIN_LR)
  step = make_train_step(train_golden.dense_loss, opt, model, plan=plan,
                         device="cuda")
  want = expect(interact_fwd=1, interact_bwd=1)
  totals = expect()
  ms, losses, changed = [], [], []
  for i in range(TRAIN_WARMUP + DENSE_TIMED):
    hit_rows = buf[hit].detach().clone()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step(numerical, cats, labels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = read_counts()
    check(got == want, f"train_dense {compute} step {i}: launches {got}, "
          f"expected {want}")
    add_counts(totals, got)
    if i >= TRAIN_WARMUP:
      ms.append((t1 - t0) * 1e3)
    losses.append(float(loss))
    check(losses[-1] == losses[-1] and abs(losses[-1]) < float("inf"),
          f"train_dense {compute} step {i}: loss {losses[-1]}")
    check(torch.equal(buf[miss], miss_rows),
          f"train_dense {compute} step {i}: rows the batch does not touch "
          "changed")
    changed.append((buf[hit] != hit_rows).any(dim=1).float().mean().item())
    check(changed[-1] > 0.5,
          f"train_dense {compute} step {i}: only {changed[-1]:.1%} of the "
          "sampled touched rows changed")
  peak = torch.cuda.max_memory_allocated() / 2**30
  med = statistics.median(ms)
  emit({"phase": "train_dense", "compute": compute, "card": smi,
        "batch": b, "classes": [list(k) for k in plan.class_keys],
        "class_bytes": sum(p.numel() * 4 for p in
                           model.embeddings.class_params().values()),
        "init_s": init_s, "step_ms": ms, "step_ms_median": med,
        "samples_per_s": b / (med / 1e3), "peak_gib": peak,
        "launches_per_step": want, "losses": losses,
        "touched_rows_changed_share": changed,
        "untouched_rows_bit_equal": True})
  emit({"phase": "train_dense_trace", "compute": compute, "card": smi,
        **trace_call(torch, lambda: step(numerical, cats, labels))})
  if compute == "bf16":
    torch.cuda.reset_peak_memory_stats()
    try:
      agree = train_golden.dense_vs_sparse_step(model, plan, numerical, cats,
                                                labels, lr=TRAIN_LR)
    except AssertionError as exc:
      raise SmokeFailure(f"dense vs sparse step: {exc}") from exc
    emit({"phase": "dense_vs_sparse", "compute": compute, "card": smi,
          **agree, "dup_share_tol": train_golden.DUP_SHARE,
          "dense_tol": train_golden.DENSE_TOL,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
  del model, opt, step, buf
  torch.cuda.empty_cache()
  return totals


def phase_dlrm_main(smi: str) -> None:
  """``examples/dlrm/main_torch.py`` (the twin of the README's "Train
  end-to-end" command, dense path) at world 1 in a subprocess with
  ``DLRM_MAIN_ARGS``: it must exit 0, and every loss and AUC it prints
  must be finite. Emits its samples/s (its own clock, from its first
  step to its last one's end)."""
  import math
  import os

  root = os.path.dirname(os.path.abspath(__file__))
  argv = [sys.executable, os.path.join("examples", "dlrm", "main_torch.py"),
          *DLRM_MAIN_ARGS]
  t0 = time.perf_counter()
  r = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                     timeout=600)
  wall_s = time.perf_counter() - t0
  check(r.returncode == 0, f"dlrm_main exited {r.returncode}: "
        f"{(r.stdout + r.stderr)[-2000:]}")
  losses = [float(v) for v in re.findall(r"loss ([-+0-9.naif]+)", r.stdout)]
  aucs = [float(v) for v in re.findall(r"AUC: ([-+0-9.naif]+)", r.stdout)]
  rate = re.search(r"trained (\d+) steps in [0-9.]+s \(([0-9,]+) "
                   r"samples/sec\)", r.stdout)
  check(losses and aucs and rate, f"dlrm_main printed {r.stdout[-2000:]}")
  check(all(math.isfinite(v) for v in losses + aucs),
        f"dlrm_main: a loss or AUC is not finite: {losses}, {aucs}")
  numbers = _twin_numbers(r.stdout, "dlrm_main")
  emit({"phase": "dlrm_main", "card": smi,
        "argv": ["examples/dlrm/main_torch.py", *DLRM_MAIN_ARGS],
        "steps": int(rate.group(1)),
        "samples_per_s": float(rate.group(2).replace(",", "")),
        "first_step_s": numbers["first_step_s"],
        "steady_samples_per_s": numbers["steady_samples_per_s"],
        "losses": losses, "auc": aucs, "wall_s": wall_s,
        "stdout": r.stdout.strip().splitlines()})


def state_arrays(state) -> dict:
  """Every array of a port train state, by name: the fused buffers, the
  dense-class tables and the dense params as tensors on their device,
  the optimizers' states in optax's spelling (numpy), and the step."""
  from distributed_embeddings_torch.convert import optax_state_of

  out = {f"fused/{k}": v for k, v in state["fused"].items()}
  out.update({f"emb_dense/{k}": v.detach()
              for k, v in state["emb_dense"].items()})
  out.update({f"dense/{k}": v.detach() for k, v in state["dense"].items()})
  for part in ("dense", "emb_dense"):
    out.update({f"{part}_opt/{k}": v for k, v in optax_state_of(
        state[f"{part}_opt"], state[part]).items()})
  out["step"] = state["step"]
  return out


def states_bit_equal(torch, got: dict, want: dict) -> list:
  """The names of ``want``'s arrays that ``got`` lacks or holds with
  other bits."""
  import numpy as np

  bad = sorted(set(want) ^ set(got))
  for k, w in want.items():
    if k not in got:
      continue
    g = got[k]
    if isinstance(w, torch.Tensor):
      same = g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    else:
      same = np.array_equal(np.asarray(g), np.asarray(w))
    if not same:
      bad.append(k)
  return bad


def states_close(torch, got: dict, want: dict, rtol: float) -> dict:
  """``got`` against ``want`` (float tensors and arrays): bit-equal or
  within ``rtol`` of each cell's magnitude (at least 1); returns the
  largest difference, the cells that differ and whether all are within
  the tolerance."""
  import numpy as np

  worst, differ, ok = 0.0, 0, True
  for k, w in want.items():
    g = got[k]
    if not isinstance(w, torch.Tensor):
      w, g = torch.as_tensor(np.asarray(w)), torch.as_tensor(np.asarray(g))
    if not w.is_floating_point():
      ok = ok and torch.equal(g, w)
      continue
    d = (g.float() - w.float()).abs()
    differ += int((d > 0).sum())
    if d.numel():
      worst = max(worst, float(d.max()))
      ok = ok and bool((d <= rtol * w.float().abs().clamp_min(1.0)).all())
  return {"max_abs_err": worst, "cells_differing": differ, "within": ok}


def phase_train_ckpt(torch, smi: str) -> dict:
  """``train_ckpt``: the world-1 train cell at full width (the train
  phase's plan, batch 65,536) with ``sgd_rule(schedule)`` and the
  scheduled dense SGD: ``CKPT_STEPS`` steps, ``checkpoint.save``,
  ``verify``, ``restore`` into a fresh state (every array bit-equal to the
  saved one), ``CKPT_STEPS`` more, against ``2 * CKPT_STEPS`` steps run
  straight from a copy of the initial state: losses and final arrays
  bit-equal or within K1's 1e-5 (duplicates add in the atomics' order),
  reported. Each step launches K2-fwd and K2-bwd once and K1 once per
  sparse class. Returns the launches of the steps."""
  import math
  import shutil
  import tempfile

  from distributed_embeddings_torch import checkpoint
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.training import (
      ScheduledSGD,
      init_sparse_state_direct,
      make_sparse_train_step,
  )
  from distributed_embeddings_torch.utils import dlrm_lr_schedule

  vocab = criteo_vocab()
  plan = train_plan()
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  schedule = dlrm_lr_schedule(*CKPT_SCHEDULE)
  rule = sgd_rule(schedule)

  def dense_opt(params):
    return ScheduledSGD(params, schedule)

  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  torch.cuda.reset_peak_memory_stats()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), dense_opt,
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  straight = {"fused": {k: v.clone() for k, v in state["fused"].items()},
              "emb_dense": {k: v.detach().clone()
                            for k, v in state["emb_dense"].items()},
              "dense": {k: v.detach().clone()
                        for k, v in state["dense"].items()},
              "step": 0}
  gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
  b = TRAIN_BATCH
  batches = [(torch.randn((b, 13), generator=gen, device="cuda"),
              [torch.randint(0, v, (b,), generator=gen, device="cuda",
                             dtype=torch.int32) for v in vocab],
              torch.randint(0, 2, (b,), generator=gen,
                            device="cuda").float())
             for _ in range(2 * CKPT_STEPS)]
  step = make_sparse_train_step(model, plan, bce_loss, dense_opt, rule)
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows=n_sparse)
  totals = expect()

  def run(st, todo, tag):
    losses = []
    for i, batch in enumerate(todo):
      reset_counts()
      st, loss = step(st, *batch)
      got = read_counts()
      check(got == want, f"train_ckpt {tag} step {i}: launches {got}, "
            f"expected {want}")
      add_counts(totals, got)
      losses.append(float(loss))
      check(math.isfinite(losses[-1]),
            f"train_ckpt {tag} step {i}: loss {losses[-1]}")
    torch.cuda.synchronize()
    return st, losses

  state, first = run(state, batches[:CKPT_STEPS], "before the save")
  root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
  path = f"{root}/ckpt"
  t0 = time.perf_counter()
  checkpoint.save(path, plan, rule, state, extra={"cell": "train_ckpt"})
  save_s = time.perf_counter() - t0
  nbytes, nfiles = dir_bytes(path)
  free = shutil.disk_usage(root).free
  t0 = time.perf_counter()
  problems = checkpoint.verify(path)
  verify_s = time.perf_counter() - t0
  check(problems == [], f"train_ckpt: verify found {problems}")
  t0 = time.perf_counter()
  restored = checkpoint.restore(path, plan, rule, state, device="cuda",
                                verify_integrity=False)
  torch.cuda.synchronize()
  restore_s = time.perf_counter() - t0
  saved = state_arrays(state)
  bad = states_bit_equal(torch, state_arrays(restored), saved)
  check(not bad, f"train_ckpt: restored arrays differ from the saved "
        f"ones: {bad[:8]}")
  check(restored["step"] == CKPT_STEPS and isinstance(
      restored["dense_opt"], ScheduledSGD) and
      restored["dense_opt"].count == CKPT_STEPS,
        "train_ckpt: the restored step or schedule count is not "
        f"{CKPT_STEPS}")
  n_arrays = len(saved)
  del state, saved
  shutil.rmtree(root)
  torch.cuda.empty_cache()
  restored, second = run(restored, batches[CKPT_STEPS:], "after the restore")
  straight, whole = run(straight, batches, "straight")
  peak = torch.cuda.max_memory_allocated() / 2**30
  final = states_close(torch, state_arrays(restored),
                       state_arrays(straight), 1e-5)
  losses_equal = first + second == whole
  check(final["within"] and all(
      abs(a - w) <= 1e-5 * max(1.0, abs(w))
      for a, w in zip(first + second, whole)),
        f"train_ckpt: the resumed run left the straight one by "
        f"{final['max_abs_err']} ({final['cells_differing']} cells)")
  emit({"phase": "train_ckpt", "card": smi, "batch": b,
        "sparse_classes": n_sparse, "schedule": list(CKPT_SCHEDULE),
        "fused_bytes": sum(t.numel() * 4 for t in restored["fused"].values()),
        "bytes": nbytes, "files": nfiles, "disk_free_bytes": free,
        "save_s": save_s, "verify_s": verify_s, "restore_s": restore_s,
        "restored_bit_equal": True, "arrays_compared": n_arrays,
        "losses_resumed": first + second, "losses_straight": whole,
        "losses_bit_equal": losses_equal,
        "final_bit_equal": final["cells_differing"] == 0,
        "final_max_abs_err": final["max_abs_err"],
        "final_cells_differing": final["cells_differing"],
        "tolerance": "bit-equal, else 1e-5 of each cell's magnitude",
        "launches_per_step": want, "peak_gib": peak})
  del restored, straight, step, batches
  torch.cuda.empty_cache()
  return totals


def state_copy(torch, state) -> dict:
  """:func:`state_arrays` with every tensor cloned: a snapshot no later
  step can change."""
  return {k: v.clone() if isinstance(v, torch.Tensor) else v
          for k, v in state_arrays(state).items()}


def twin_state(state) -> dict:
  """A second train state with a copy of ``state``'s arrays and no
  optimizers yet (the step binds fresh ones; only for optimizers without
  state, as SGD's before its first step)."""
  return {"fused": {k: v.clone() for k, v in state["fused"].items()},
          "emb_dense": {k: v.detach().clone()
                        for k, v in state["emb_dense"].items()},
          "dense": {k: v.detach().clone() for k, v in state["dense"].items()},
          "step": state["step"]}


def train_batches(torch, vocab, n: int, seed: int):
  """``n`` batches of the train cell on the card: ``TRAIN_BATCH`` samples
  of uniform one-hot ids, random labels, from ``seed``."""
  b = TRAIN_BATCH
  gen = torch.Generator(device="cuda").manual_seed(seed)
  return [(torch.randn((b, 13), generator=gen, device="cuda"),
           [torch.randint(0, v, (b,), generator=gen, device="cuda",
                          dtype=torch.int32) for v in vocab],
           torch.randint(0, 2, (b,), generator=gen, device="cuda").float())
          for _ in range(n)]


def mb_runs(torch, tag, make_step, state, batches, wants) -> tuple:
  """The micro-batch comparison of ``train_mb`` and ``train_zoo_mb``:
  ``state`` (micro_batches=1) and a copy of it (``MICRO_BATCHES``) each
  take the steps of ``batches``; per mode the step ms (the first step
  untimed), the step's own peak memory above what was allocated before it,
  the whole peak, and the launches, checked against ``wants[mode]``.
  Returns ``(per mode results, totals, the two final states)``."""
  import math

  other = twin_state(state)
  totals = expect()
  out = {}
  for mode, st in ((1, state), (MICRO_BATCHES, other)):
    step = make_step(mode)
    ms, losses, step_peak = [], [], []
    for i, batch in enumerate(batches):
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      base = torch.cuda.memory_allocated()
      reset_counts()
      t0 = time.perf_counter()
      st, loss = step(st, *batch)
      torch.cuda.synchronize()
      t1 = time.perf_counter()
      got = read_counts()
      check(got == wants[mode], f"{tag} micro_batches={mode} step {i}: "
            f"launches {got}, expected {wants[mode]}")
      add_counts(totals, got)
      step_peak.append((torch.cuda.max_memory_allocated() - base) / 2**30)
      if i:
        ms.append((t1 - t0) * 1e3)
      losses.append(float(loss))
      check(math.isfinite(losses[-1]),
            f"{tag} micro_batches={mode} step {i}: loss {losses[-1]}")
    out[mode] = {"step_ms": ms, "step_ms_median": statistics.median(ms),
                 "step_peak_gib": max(step_peak),
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "losses": losses, "launches_per_step": wants[mode]}
    del step
  return out, totals, (state, other)


def phase_train_mb(torch, smi: str) -> dict:
  """``train_mb``: the world-1 train cell (f32, SGD 0.1, B=65,536) with
  ``micro_batches`` 1 and ``MICRO_BATCHES`` from one state, in turns of
  whole runs: step ms, the step's peak memory, K2-fwd and K2-bwd once
  per micro-batch and K1 once per sparse class a step, and the final
  states against each other within K1's 1e-5. Returns the launches."""
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  vocab = criteo_vocab()
  plan = train_plan()
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  batches = train_batches(torch, vocab, MB_STEPS, SEED + 11)
  wants = {m: expect(interact_fwd=m, interact_bwd=m, apply_rows=n_sparse)
           for m in (1, MICRO_BATCHES)}

  def make_step(mode):
    return make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                  rule, micro_batches=mode)

  runs, totals, (one, mb) = mb_runs(torch, "train_mb", make_step, state,
                                    batches, wants)
  final = states_close(torch, state_arrays(mb), state_arrays(one), 1e-5)
  check(final["within"] and all(
      abs(a - w) <= 1e-5 * max(1.0, abs(w))
      for a, w in zip(runs[MICRO_BATCHES]["losses"], runs[1]["losses"])),
        f"train_mb: micro_batches={MICRO_BATCHES} left the one-shot run by "
        f"{final['max_abs_err']} ({final['cells_differing']} cells)")
  emit({"phase": "train_mb", "card": smi, "batch": TRAIN_BATCH,
        "micro_batches": [1, MICRO_BATCHES], "steps": MB_STEPS,
        "fused_bytes": sum(t.numel() * 4 for t in one["fused"].values()),
        "runs": {str(k): v for k, v in runs.items()},
        "final_max_abs_err": final["max_abs_err"],
        "final_cells_differing": final["cells_differing"],
        "tolerance": "1e-5 of each cell's magnitude"})
  del state, one, mb, batches
  torch.cuda.empty_cache()
  return totals


def phase_train_zoo_mb(torch, smi: str) -> dict:
  """``train_zoo_mb``: Tiny (Adagrad 0.01, 8.99 GB, B=65,536) with
  ``micro_batches`` 1 and ``MICRO_BATCHES`` from one state: step ms, the
  step's peak memory, K6 once per sparse bucket and micro-batch, K1 once
  per sparse class a step, the final states within K1's 1e-5. Returns
  the launches."""
  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      SyntheticModel,
      bce_loss,
  )
  from distributed_embeddings_torch.ops.packed_table import adagrad_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
  )
  from distributed_embeddings_torch.training import (
      Adagrad,
      init_sparse_state_direct,
      make_sparse_train_step,
  )
  plan = zoo_plan()
  rule = adagrad_rule(ZOO_LR)
  hot = zoo_hotness()
  sparse = [k for k in plan.class_keys if plan.classes[k].kind == "sparse"]
  n_buckets = sum(len(class_buckets(plan, k, lambda i: hot[i]))
                  for k in sparse)
  model = SyntheticModel(SYNTHETIC_MODELS[ZOO_MODEL], tables=False,
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
  adagrad = functools.partial(Adagrad, lr=ZOO_LR)
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), adagrad,
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  batches = zoo_batches(torch)
  batches = [batches[i % 2] for i in range(MB_STEPS)]
  wants = {m: expect(build_delta_rows=m * n_buckets, apply_rows=len(sparse))
           for m in (1, MICRO_BATCHES)}

  def make_step(mode):
    return make_sparse_train_step(model, plan, bce_loss, adagrad, rule,
                                  micro_batches=mode)

  runs, totals, (one, mb) = mb_runs(torch, "train_zoo_mb", make_step, state,
                                    batches, wants)
  final = states_close(torch, state_arrays(mb), state_arrays(one), 1e-5)
  check(final["within"],
        f"train_zoo_mb: micro_batches={MICRO_BATCHES} left the one-shot run "
        f"by {final['max_abs_err']} ({final['cells_differing']} cells)")
  emit({"phase": "train_zoo_mb", "model": ZOO_MODEL, "card": smi,
        "batch": ZOO_BATCH, "micro_batches": [1, MICRO_BATCHES],
        "steps": MB_STEPS,
        "fused_bytes": sum(t.numel() * 4 for t in one["fused"].values()),
        "runs": {str(k): v for k, v in runs.items()},
        "final_max_abs_err": final["max_abs_err"],
        "final_cells_differing": final["cells_differing"],
        "tolerance": "1e-5 of each cell's magnitude"})
  del state, one, mb, batches
  torch.cuda.empty_cache()
  return totals


def oov_count(plan, cats) -> dict:
  """Per class, the ids of ``cats`` past their table's vocabulary (a
  numpy count: each input's count goes to every class its pieces live
  in, negative ids are padding)."""
  import numpy as np

  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_param_name,
  )
  out = {class_param_name(*k): 0 for k in plan.class_keys}
  for i, pieces in enumerate(plan.output_pieces):
    vocab = plan.global_configs[plan.input_table_map[i]].input_dim
    n = int((np.asarray(cats[i].cpu()) >= vocab).sum())
    for ck in {p.class_key for p in pieces}:
      out[class_param_name(*ck)] += n
  return out


def phase_train_guard(torch, smi: str) -> dict:
  """``train_guard``: the world-1 train cell with ``guard=True`` and
  without, in turns from one state (the guard's cost); then a NaN batch
  (``bad_step`` 1, every state array bit-equal to before, the step
  held), an out-of-range id under ``oov='error'`` (``check_oov`` raises,
  the state bit-equal), and ``make_sparse_eval_step(with_metrics=True)``
  on a batch with out-of-range ids (its counts equal a numpy count).
  Returns the launches of the guarded steps."""
  import math

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.resilience.guards import check_oov
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_eval_step,
      make_sparse_train_step,
  )

  vocab = criteo_vocab()
  plan = train_plan()
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  batches = train_batches(torch, vocab, 2, SEED + 13)
  steps = {g: make_sparse_train_step(model, plan, bce_loss,
                                     sgd_factory(torch), rule, guard=g)
           for g in (False, True)}
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows=n_sparse)
  totals = expect()
  ms = {False: [], True: []}
  for i in range(1 + GUARD_TIMED):
    for g in (False, True):
      reset_counts()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = steps[g](state, *batches[i % 2])
      torch.cuda.synchronize()
      t1 = time.perf_counter()
      got = read_counts()
      check(got == want, f"train_guard guard={g} step {i}: launches {got}, "
            f"expected {want}")
      if g:
        add_counts(totals, got)
        check(int(out[2]["bad_step"]) == 0,
              f"train_guard step {i}: a clean batch was skipped")
      check(math.isfinite(float(out[1])), f"train_guard step {i}: loss")
      if i:
        ms[g].append((t1 - t0) * 1e3)

  def poisoned_step(tag, batch, guarded):
    before = state_copy(torch, state)
    reset_counts()
    _, loss, m = guarded(state, *batch)
    got = read_counts()
    check(got == want, f"train_guard {tag}: launches {got}, expected {want}")
    add_counts(totals, got)
    check(int(m["bad_step"]) == 1, f"train_guard {tag}: bad_step "
          f"{int(m['bad_step'])}")
    bad = states_bit_equal(torch, state_arrays(state), before)
    check(not bad, f"train_guard {tag}: arrays changed: {bad[:8]}")
    return float(loss), {k: int(v) for k, v in m["oov"].items()}, len(before)

  numerical, cats, labels = batches[0]
  nan_loss, _, n_arrays = poisoned_step(
      "NaN batch", (torch.full_like(numerical, float("nan")), cats, labels),
      steps[True])
  plan_err = train_plan(oov="error")
  guarded_err = make_sparse_train_step(model, plan_err, bce_loss,
                                       sgd_factory(torch), rule, guard=True)
  bad_cats = [c.clone() for c in cats]
  bad_cats[0][:3] = vocab[0] + 1
  bad_cats[20][5] = vocab[20] + 7
  _, oov, _ = poisoned_step("oov='error'", (numerical, bad_cats, labels),
                            guarded_err)
  want_oov = oov_count(plan, bad_cats)
  check(oov == want_oov, f"train_guard: oov counts {oov}, numpy {want_oov}")
  try:
    check_oov(plan_err, oov)
    raised = None
  except ValueError as exc:
    raised = str(exc)
  check(raised is not None and "OOV policy 'error'" in raised,
        "train_guard: check_oov did not raise under oov='error'")
  ev = make_sparse_eval_step(model, plan_err, rule, with_metrics=True)
  reset_counts()
  preds, m = ev(state, numerical, bad_cats)
  got = read_counts()
  check(got == expect(interact_fwd=1), f"train_guard eval: launches {got}")
  ev_oov = {k: int(v) for k, v in m["oov"].items()}
  check(ev_oov == want_oov and bool(torch.isfinite(preds).all()),
        f"train_guard eval: counts {ev_oov}, numpy {want_oov}")
  med = {g: statistics.median(v) for g, v in ms.items()}
  emit({"phase": "train_guard", "card": smi, "batch": TRAIN_BATCH,
        "step_ms": {"plain": ms[False], "guard": ms[True]},
        "step_ms_median": {"plain": med[False], "guard": med[True]},
        "guard_cost_ms": med[True] - med[False],
        "nan_step": {"bad_step": 1, "loss": nan_loss,
                     "arrays_bit_equal": n_arrays, "step": state["step"]},
        "oov_error": {"oov": oov, "numpy": want_oov, "bad_step": 1,
                      "arrays_bit_equal": n_arrays,
                      "check_oov": raised[:160]},
        "eval_metrics": {"oov": ev_oov, "numpy": want_oov},
        "launches_per_step": want})
  del state, steps, guarded_err, batches
  torch.cuda.empty_cache()
  return totals


def phase_resilient(torch, smi: str) -> dict:
  """``resilient``: the README's "Resilient training" snippet through
  ``ResilientTrainer`` at the train cell's widths (26 tables of width
  128, B=65,536, SGD 0.1, the vocabulary cut to 1/``RESILIENT_VOCAB_
  SCALE`` of Criteo-1TB so that a save takes about a second), with the
  chaos story of ``tools/torch_chaos_train.py``: NaN batches, a transient
  write fault, a crash mid-save, a fresh trainer that resumes; the
  resumed run's losses against the uninterrupted run's within 1e-5
  (K1's atomics), the skips counted, the loss falling; each snapshot's
  and restore's seconds from the trainer's spans. Returns the launches
  of its steps."""
  import os

  import numpy as np

  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.telemetry import (
      Tracer,
      install_tracer,
      uninstall_tracer,
  )
  from distributed_embeddings_torch.training import init_sparse_state_direct

  sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
      __file__)), "tools"))
  import torch_chaos_train as chaos

  vocab = [max(4, int(v / RESILIENT_VOCAB_SCALE)) for v in CRITEO_1TB_VOCAB]
  plan = train_plan(vocab)
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  rule = sgd_rule(TRAIN_LR)
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rng = np.random.default_rng(SEED)
  unique = []
  for _ in range(6):
    numerical = rng.standard_normal((TRAIN_BATCH, 13)).astype(np.float32)
    cats = [rng.integers(0, v, TRAIN_BATCH).astype(np.int32) for v in vocab]
    unique.append((numerical, cats,
                   (numerical[:, 0] > 0).astype(np.float32)))

  def fresh_state():
    return init_sparse_state_direct(
        plan, rule, model.state_dict(), sgd_factory(torch),
        torch.Generator(device="cuda").manual_seed(SEED), device="cuda")

  setup = {"plan": plan, "rule": rule, "opt": sgd_factory(torch),
           "model": model,
           "batches": [unique[i % 6] for i in range(RESILIENT_STEPS)],
           "fresh_state": fresh_state}
  tracer = install_tracer(Tracer())
  reset_counts()
  t0 = time.perf_counter()
  try:
    res = chaos.run_chaos(RESILIENT_STEPS, RESILIENT_NAN_EVERY,
                          RESILIENT_SNAPSHOT_EVERY, device="cuda",
                          setup=setup)
  finally:
    uninstall_tracer()
  wall_s = time.perf_counter() - t0
  got = read_counts()
  calls = res["step_calls"]
  want = expect(interact_fwd=calls, interact_bwd=calls,
                apply_rows=n_sparse * calls)
  check(got == want, f"resilient: launches {got}, expected {want}")
  ref_state, resumed_state = res.pop("_states")
  fused_bytes = sum(t.numel() * 4 for t in ref_state["fused"].values())
  final = states_close(torch, state_arrays(resumed_state),
                       state_arrays(ref_state), 1e-5)
  check(res["ok"] and final["within"], "resilient: the chaos story failed: "
        + json.dumps({k: v for k, v in res.items()
                      if k not in ("losses_reference",
                                   "losses_resumed_run")})[:1500])
  spans = {}
  for ev in tracer.events():
    if ev[0] == "X" and ev[2] in ("ckpt/save", "ckpt/restore"):
      spans.setdefault(ev[2], []).append(ev[4] / 1e9)
  del res["reference_summary"]
  emit({"phase": "resilient", "card": smi, "batch": TRAIN_BATCH,
        "vocab_scale": f"1/{RESILIENT_VOCAB_SCALE} of Criteo-1TB (the "
                       f"train cell's 1/16, cut {RESILIENT_VOCAB_SCALE // 16}"
                       " times more)",
        "fused_bytes": fused_bytes, "wall_s": wall_s,
        "snapshot_s": spans.get("ckpt/save", []),
        "restore_s": spans.get("ckpt/restore", []),
        "final_max_abs_err": final["max_abs_err"],
        "final_cells_differing": final["cells_differing"],
        "launches": got, **res})
  del ref_state, resumed_state, setup
  torch.cuda.empty_cache()
  return got


def phase_dlrm_main_mb(torch, smi: str) -> dict:
  """``dlrm_main_mb``: ``examples/dlrm/main_torch.py --dataset dummy
  --sparse --micro_batches 4`` (20 steps of 4096, x 1/16, ``--eval``)
  through the twin's ``main(argv)`` in this process: finite losses and
  AUC, K2-bwd ``4`` times a step, K1 once per sparse class a step."""
  from distributed_embeddings_torch.models import dlrm_embedding_plan

  flags = {k: v for k, v in DLRM_MAIN_SPARSE_FLAGS.items()
           if k != "--checkpoint_every"}
  argv = twin_argv(flags) + ["--micro_batches", str(MICRO_BATCHES),
                             "--device", "cuda"]
  t0 = time.perf_counter()
  out, got = _run_twin(argv)
  wall_s = time.perf_counter() - t0
  numbers = _twin_numbers(out, "dlrm_main_mb")
  steps = numbers["steps"]
  vocab = [max(4, int(v * float(flags["--vocab_scale"])))
           for v in CRITEO_1TB_VOCAB]
  plan = dlrm_embedding_plan(vocab, D, 1, "memory_balanced",
                             batch_hint=int(flags["--batch_size"]))
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  check(got["interact_bwd"] == MICRO_BATCHES * steps and
        got["apply_rows"] == n_sparse * steps and
        got["interact_fwd"] > MICRO_BATCHES * steps,
        f"dlrm_main_mb: launches {got} for {steps} steps")
  torch.cuda.empty_cache()
  emit({"phase": "dlrm_main_mb", "card": smi,
        "argv": ["examples/dlrm/main_torch.py", *argv], "wall_s": wall_s,
        "launches": got, **numbers, "stdout": out.strip().splitlines()})
  return got


def _w4_guard_mb(torch, mesh, backend: str, batch) -> dict:
  """The guarded and the micro-batched step at world 4, in this rank: a
  guarded step whose batch holds NaN in rank ``W4_NAN_RANK``'s slice
  only (every rank: ``bad_step`` 1, its arrays bit-equal to before); then
  one one-shot step and one ``micro_batches=2`` step from the same state,
  within K1's 1e-5 of each other, K4 once per (bucket, round, chunk) and
  micro-batch."""
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  vocab, plan = world4_plan(backend)
  dev = mesh.device
  model = DLRM(vocab, D, tables=False, device=dev,
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device=dev).manual_seed(SEED + 21 + mesh.rank),
      mesh=mesh)
  k4 = k4_launches_per_step(plan)
  n_cls = len(state["fused"])

  def build(**kw):
    return make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                  rule, mesh=mesh, **kw)

  numerical, cats, labels = batch
  poisoned = (torch.full_like(numerical, float("nan"))
              if mesh.rank == W4_NAN_RANK else numerical)
  before = state_copy(torch, state)
  reset_counts()
  _, loss, m = build(guard=True)(state, poisoned, cats, labels)
  guard_counts = read_counts()
  want = expect(gather_rows=k4, apply_rows=n_cls, interact_fwd=1,
                interact_bwd=1)
  check(guard_counts == want, f"world 4 guard rank {mesh.rank}: launches "
        f"{guard_counts}, expected {want}")
  check(int(m["bad_step"]) == 1, f"world 4 guard rank {mesh.rank}: "
        f"bad_step {int(m['bad_step'])}")
  bad = states_bit_equal(torch, state_arrays(state), before)
  check(not bad, f"world 4 guard rank {mesh.rank}: arrays changed: "
        f"{bad[:8]}")
  n_arrays = len(before)
  del before
  other = twin_state(state)
  mb_counts = expect()
  losses = {}
  for mode, st in ((1, state), (2, other)):
    reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, loss = build(micro_batches=mode)(st, numerical, cats, labels)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    got = read_counts()
    want = expect(gather_rows=mode * k4, apply_rows=n_cls,
                  interact_fwd=mode, interact_bwd=mode)
    check(got == want, f"world 4 micro_batches={mode} rank {mesh.rank}: "
          f"launches {got}, expected {want}")
    add_counts(mb_counts, got)
    losses[mode] = {"loss": float(loss), "step_ms": (t1 - t0) * 1e3}
  final = states_close(torch, state_arrays(other), state_arrays(state), 1e-5)
  check(final["within"] and abs(losses[2]["loss"] - losses[1]["loss"]) <=
        1e-5 * max(1.0, abs(losses[1]["loss"])),
        f"world 4 micro_batches=2 rank {mesh.rank} left the one-shot step "
        f"by {final['max_abs_err']}")
  del state, other
  torch.cuda.empty_cache()
  return {"nan_rank": W4_NAN_RANK, "bad_step": 1,
          "arrays_bit_equal": n_arrays, "guard_launches": guard_counts,
          "mb_launches": mb_counts, "k4_per_step": k4,
          "mb": {str(k): v for k, v in losses.items()},
          "mb_max_abs_err": final["max_abs_err"],
          "mb_cells_differing": final["cells_differing"]}


def twin_argv(flags: dict) -> list:
  """The sparse twin's command line: ``flags`` and ``--eval --sparse``."""
  return [a for kv in flags.items() for a in kv] + ["--eval", "--sparse"]


def _run_twin(argv) -> tuple:
  """``examples/dlrm/main_torch.py``'s ``main(argv)`` in this process
  (so the launch counters see its steps): ``(stdout, launches)``."""
  import contextlib
  import io

  twin = _load_script("main_torch", "examples", "dlrm", "main_torch.py")
  buf = io.StringIO()
  reset_counts()
  with contextlib.redirect_stdout(buf):
    twin.main(list(argv))
  got = read_counts()
  return buf.getvalue(), got


def _twin_numbers(out: str, tag: str) -> dict:
  """The losses, AUCs and rates a twin run printed, each checked finite."""
  import math

  losses = [float(v) for v in re.findall(r"loss ([-+0-9.naif]+)", out)]
  aucs = [float(v) for v in re.findall(r"AUC: ([-+0-9.naif]+)", out)]
  rate = re.search(r"trained (\d+) steps in [0-9.]+s \(([0-9,]+) "
                   r"samples/sec\)", out)
  first = re.search(r"first step ([0-9.]+)s", out)
  steady = re.search(r"steady steps (\d+) in ([0-9.]+)s \(([0-9,]+) "
                     r"samples/sec\)", out)
  check(losses and aucs and rate and first and steady,
        f"{tag} printed {out[-2000:]}")
  check(all(math.isfinite(v) for v in losses + aucs),
        f"{tag}: a loss or AUC is not finite: {losses}, {aucs}")
  return {"steps": int(rate.group(1)),
          "samples_per_s": float(rate.group(2).replace(",", "")),
          "first_step_s": float(first.group(1)),
          "steady_steps": int(steady.group(1)),
          "steady_s": float(steady.group(2)),
          "steady_samples_per_s": float(steady.group(3).replace(",", "")),
          "losses": losses, "auc": aucs}


def phase_dlrm_main_sparse(torch, smi: str) -> dict:
  """``dlrm_main_sparse``: the README's "Train end-to-end" command through
  the twin (``main_torch.py`` with ``DLRM_MAIN_SPARSE_FLAGS`` and a
  temporary ``--checkpoint_dir``) twice at world 1, in this process: both
  runs end with finite losses and AUC, the second prints ``resumed from
  <dir> at step 20``, and the published directory passes ``verify`` and
  holds step 20, then 40.
  Then one run with ``--dataset criteo`` over a split that
  ``write_dummy_criteo_split`` writes into a temporary directory, and the
  native loader (built here) against the numpy backend on that split,
  batch for batch bit-equal. Every run launches K2-fwd, K2-bwd and K1.
  Returns the runs' launches."""
  import shutil
  import tempfile

  import numpy as np

  from distributed_embeddings_torch import cc, checkpoint
  from distributed_embeddings_torch.utils import (
      RawBinaryCriteoDataset,
      categorical_dtype,
      write_dummy_criteo_split,
  )

  root = tempfile.mkdtemp(prefix="chip_smoke_main_sparse_")
  ckpt = f"{root}/ckpt"
  steps = int(DLRM_MAIN_SPARSE_FLAGS["--steps"])
  totals = expect()
  runs = []
  for i in range(2):
    t0 = time.perf_counter()
    out, got = _run_twin(twin_argv(DLRM_MAIN_SPARSE_FLAGS) +
                         ["--device", "cuda", "--checkpoint_dir", ckpt])
    wall_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    numbers = _twin_numbers(out, f"dlrm_main_sparse run {i}")
    resumed = f"resumed from {ckpt} at step {steps}" in out
    check(resumed == (i == 1), f"dlrm_main_sparse run {i}: the resume line "
          f"{'is missing' if i else 'is there'}: {out[-2000:]}")
    for name in ("interact_fwd", "interact_bwd", "apply_rows"):
      check(got[name] > 0, f"dlrm_main_sparse run {i} never launched {name}")
    add_counts(totals, got)
    t0 = time.perf_counter()
    problems = checkpoint.verify(ckpt)
    verify_s = time.perf_counter() - t0
    check(problems == [], f"dlrm_main_sparse run {i}: verify found "
          f"{problems}")
    manifest = checkpoint.read_manifest(ckpt)
    check(manifest["step"] == steps * (i + 1),
          f"dlrm_main_sparse run {i}: the checkpoint holds step "
          f"{manifest['step']}")
    nbytes, nfiles = dir_bytes(ckpt)
    runs.append({"resumed": resumed, "wall_s": wall_s, "verify_s": verify_s,
                 "checkpoint_step": manifest["step"], "bytes": nbytes,
                 "files": nfiles, "launches": got, **numbers,
                 "stdout": out.strip().splitlines()})
  shutil.rmtree(root)

  # the split-binary Criteo reader, at the twin's vocabulary and batch
  flags = dict(DLRM_MAIN_SPARSE_FLAGS)
  batch = int(flags["--batch_size"])
  vocab = [max(4, int(v * float(flags["--vocab_scale"])))
           for v in CRITEO_1TB_VOCAB]
  data = tempfile.mkdtemp(prefix="chip_smoke_criteo_")
  write_dummy_criteo_split(data, CRITEO_SAMPLES, vocab, seed=SEED)
  t0 = time.perf_counter()
  cc.build()
  build_s = time.perf_counter() - t0
  kw = dict(numerical_features=13, categorical_features=list(range(26)),
            categorical_feature_sizes=vocab)
  compared = 0
  for valid in (False, True):
    native = list(RawBinaryCriteoDataset(data, batch, valid=valid,
                                         backend="native", **kw))
    plain = list(RawBinaryCriteoDataset(data, batch, valid=valid,
                                        backend="numpy", **kw))
    check(len(native) == len(plain) == CRITEO_SAMPLES // batch,
          f"criteo reader: {len(native)} native and {len(plain)} numpy "
          "batches")
    for (n1, c1, l1), (n2, c2, l2) in zip(native, plain):
      check(np.array_equal(n1, n2) and np.array_equal(l1, l2) and
            all(np.array_equal(a, b) for a, b in zip(c1, c2)),
            "criteo reader: a native batch differs from the numpy one")
      compared += 1
  flags.update({"--dataset": "criteo", "--steps": str(CRITEO_STEPS)})
  del flags["--checkpoint_every"]
  argv = twin_argv(flags) + ["--dataset_path", data, "--device", "cuda"]
  t0 = time.perf_counter()
  out, got = _run_twin(argv)
  wall_s = time.perf_counter() - t0
  numbers = _twin_numbers(out, "dlrm_main_sparse criteo")
  check(numbers["steps"] == CRITEO_STEPS,
        f"dlrm_main_sparse criteo: {numbers['steps']} steps")
  for name in ("interact_fwd", "interact_bwd", "apply_rows"):
    check(got[name] > 0, f"dlrm_main_sparse criteo never launched {name}")
  add_counts(totals, got)
  shutil.rmtree(data)
  torch.cuda.empty_cache()
  emit({"phase": "dlrm_main_sparse", "card": smi,
        "argv": ["examples/dlrm/main_torch.py",
                 *twin_argv(DLRM_MAIN_SPARSE_FLAGS),
                 "--checkpoint_dir", "<tmp>"],
        "runs": runs,
        "criteo": {"samples_per_split": CRITEO_SAMPLES,
                   "cat_dtypes": sorted({str(categorical_dtype(v))
                                         for v in vocab}),
                   "native_build_s": build_s,
                   "native_batches_bit_equal_numpy": compared,
                   "wall_s": wall_s, "launches": got, **numbers,
                   "stdout": out.strip().splitlines()}})
  return totals


def zoo_plan():
  """The plan of ``tools/bench_synthetic.py tiny 65536`` at world 1: Tiny's
  55 tables at their published vocabularies, ``"basic"``,
  ``dense_row_threshold=2048``, ``batch_hint=65536``."""
  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      synthetic_plan,
  )
  return synthetic_plan(SYNTHETIC_MODELS[ZOO_MODEL],
                        dense_row_threshold=ZOO_DENSE_ROW_THRESHOLD,
                        batch_hint=ZOO_BATCH)


def zoo_hotness():
  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      expand_tables,
  )
  return expand_tables(SYNTHETIC_MODELS[ZOO_MODEL])[2]


def zoo_classes(plan, rule) -> list:
  """The largest sparse class of each width of the plan, widest first:
  ``(name, layout)``."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
  )
  layouts = DistributedLookup(plan).fused_layouts(rule)
  best = {}
  for key in plan.class_keys:
    if plan.classes[key].kind != "sparse":
      continue
    name = class_param_name(*key)
    lay = layouts[name]
    if (lay.width not in best
        or lay.phys_rows > layouts[best[lay.width]].phys_rows):
      best[lay.width] = name
  return [(best[w], layouts[best[w]]) for w in sorted(best, reverse=True)]


def zoo_routed(torch, plan) -> dict:
  """The routed ids of ``generate_batch(seed=0)`` per sparse class and
  bucket, as the train step's lookup gets them: ``name -> [(h, ids)]``,
  ids on the card, ``[n_b, B]`` or ``[n_b, B, h]``."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
  )
  out = {}
  routed = DistributedLookup(plan).route_ids(zoo_batches(torch, 1)[0][1])
  for bk, ids in routed.items():
    if plan.classes[bk.class_key].kind == "sparse":
      out.setdefault(class_param_name(*bk.class_key), []).append((bk.h, ids))
  return out


def k6_inputs(torch, layout, sub, h: int, aux_last: int, seed: int):
  """K6's other inputs on the card for the windows ``sub`` ([K*h]):
  per-sample cotangents and state rows (an Adagrad accumulator of at
  least 0.1; masked rows nonzero in their occurrence's window only)."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  n = sub.shape[0]
  dz = torch.randn((n // h, layout.width), generator=gen, device="cuda") * 1e-2
  aux = torch.rand((n, aux_last), generator=gen, device="cuda") + 0.1
  if aux_last != layout.stride:
    win = torch.arange(aux_last, device="cuda") // layout.stride
    aux = torch.where(win[None, :] == sub[:, None], aux,
                      torch.zeros_like(aux))
  return dz, aux


def k6_bytes(layout, rule, k: int, n: int, aux_last: int) -> int:
  """The bytes K6 must move: each sample's cotangent row, each
  occurrence's int64 window index and the state lanes the function reads
  (``n_aux * w`` lanes of a stride-wide row; of each of the ``rpp``
  windows of a masked physical row, which it sums), and the 128-lane
  update rows written once."""
  windows = 1 if aux_last == layout.stride else layout.rows_per_phys
  state = n * windows * rule.n_aux * layout.width * 4
  return k * layout.width * 4 + n * 8 + state + n * 128 * 4


def k6_fetch_yardsticks(torch, layout, aux) -> dict:
  """Two timed yardsticks of the state reads of masked rows ``aux``
  (Adagrad: one state slot): every window's table and state lanes read
  (their sum written), or only its state lanes read (copied). Equal times
  mean the card fetches the table lanes with the state lanes, which the
  bound (:func:`k6_bytes`) does not count."""
  w = layout.width
  win_lanes = aux.view(aux.shape[0], layout.rows_per_phys, layout.stride)
  half = torch.empty((aux.shape[0], layout.rows_per_phys, w), device="cuda")
  return {
      "all_lanes_ms": lambda: torch.add(win_lanes[:, :, :w],
                                        win_lanes[:, :, w:2 * w], out=half),
      "state_lanes_ms": lambda: half.copy_(win_lanes[:, :, w:2 * w])}


def k6_within_tol(torch, got, want) -> float:
  """max |got - want| over its allowance ``atol + rtol * |want|``."""
  allow = K6_TOL["atol"] + K6_TOL["rtol"] * want.abs()
  return ((got - want).abs() / allow).max().item()


def k6_stream_row(torch, cd, flush, name, layout, rule, sub, h: int,
                  seed: int, step: int = 5) -> dict:
  """K6 on one stream against its plain version: the windows ``sub``
  (``[K*h]``) with :func:`k6_inputs`' cotangents and state rows
  (stride-wide one-hot, window-masked physical rows multi-hot), within
  ``K6_TOL``; timed beside its plain version (and, masked, the fetch
  yardsticks). Emits and returns its ``kernel`` row."""
  n = sub.shape[0]
  k = n // h
  aux_last = (layout.stride if h == 1
              else layout.rows_per_phys * layout.stride)
  dz, aux = k6_inputs(torch, layout, sub, h, aux_last, seed)
  got = cd.build_delta_rows(layout, rule, dz, sub, aux, h, step)
  torch.cuda.synchronize()
  want = cd.build_delta_rows_plain(layout, rule, dz, sub, aux, h, step)
  share = k6_within_tol(torch, got, want)
  check(share <= 1.0, f"build_delta_rows {name} h={h}: off by {share} "
        f"of rtol {K6_TOL['rtol']}, atol {K6_TOL['atol']}")
  max_err = (got - want).abs().max().item()
  del want, got
  fns = {
      "kernel_ms": lambda: cd.build_delta_rows(layout, rule, dz, sub,
                                               aux, h, step),
      "plain_ms": lambda: cd.build_delta_rows_plain(layout, rule, dz,
                                                    sub, aux, h, step)}
  if aux_last != layout.stride:
    fns.update(k6_fetch_yardsticks(torch, layout, aux))
  timed = event_ms(torch, fns, flush)
  del fns
  row = {"phase": "kernel", "name": "build_delta_rows", "class": name,
         "rule": rule.name, "width": layout.width,
         "stride": layout.stride, "rows_per_phys": layout.rows_per_phys,
         "samples": k, "h": h, "occurrences": n, "aux_last": aux_last,
         "aux": "stride" if aux_last == layout.stride else "masked_phys",
         "max_abs_err": max_err, "max_tol_share": share, "tol": K6_TOL,
         **timed, "library_ms": None,
         "library_note": "no single PyTorch call computes this function",
         # about ten flops per logical lane
         **bound(k6_bytes(layout, rule, k, n, aux_last),
                 10 * n * layout.stride, F32_FLOPS)}
  emit(row)
  return row


def phase_kernel_delta(torch, cd, flush) -> dict:
  """K6 against its plain version at Tiny's shapes: every bucket of the
  largest w16 class and of the w8 class (one-hot with stride-wide state
  rows, ten-hot with window-masked physical rows), the windows those of
  the routed ids of ``generate_batch(seed=0)``; then momentum and Adam on
  small streams. Returns the ten-hot w16 bucket's row."""
  from distributed_embeddings_torch.ops.packed_table import (
      PackedLayout,
      _grp_sub,
      adagrad_rule,
      adam_rule,
      momentum_rule,
  )
  rule = adagrad_rule(ZOO_LR)
  plan = zoo_plan()
  routed = zoo_routed(torch, plan)
  main = None
  for c, (name, layout) in enumerate(zoo_classes(plan, rule)):
    for i, (h, ids) in enumerate(routed.pop(name)):
      _, sub, _ = _grp_sub(layout, ids.reshape(-1))
      del ids
      row = k6_stream_row(torch, cd, flush, name, layout, rule, sub, h,
                          SEED + 10 + 2 * c + i)
      if c == 0 and h > 1:
        main = row
      del sub
  del routed
  step = 5
  # every rule at every width of K6_WIDTHS whose stride fits a physical
  # row (the vector path), and at K6_GENERAL_WIDTHS (the general path),
  # with stride-wide and window-masked state rows, h 1 and 10: within the
  # tolerance, small
  others = []
  gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
  cases = [(rule2, w) for rule2 in (adagrad_rule(ZOO_LR),
                                    momentum_rule(ZOO_LR), adam_rule(ZOO_LR))
           for w in K6_WIDTHS + K6_GENERAL_WIDTHS
           if w * (1 + rule2.n_aux) <= D]
  for rule2, w in cases:
    layout = PackedLayout(rows=100_000, width=w, n_aux=rule2.n_aux)
    auxes = sorted({layout.stride, layout.phys_width})
    for h, aux_last in [(h, a) for h in (1, 10) for a in auxes]:
      sub = torch.randint(0, layout.rows_per_phys, (4096 * h,),
                          generator=gen, device="cuda")
      dz, aux = k6_inputs(torch, layout, sub, h, aux_last, SEED + 20)
      got = cd.build_delta_rows(layout, rule2, dz, sub, aux, h, step)
      share = k6_within_tol(
          torch, got, cd.build_delta_rows_plain(layout, rule2, dz, sub, aux,
                                                h, step))
      check(share <= 1.0, f"build_delta_rows {rule2.name} w={w} h={h} "
            f"aux_last={aux_last}: off by {share} of the tolerance")
      others.append([rule2.name, w, h, aux_last, share])
  emit({"phase": "kernel", "name": "build_delta_rows", "stream": "rules",
        "rule_width_h_auxlast_tolshare": others})
  torch.cuda.empty_cache()
  return main


def phase_kernel_apply_zoo(torch, ca, flush) -> None:
  """K1 against its plain version at the Tiny step's streams: for the
  largest w16 class and the w8 class, the class's buffer (random rows),
  every routed occurrence of ``generate_batch(seed=0)`` (power-law ids,
  its buckets in turn) sent to its physical row, and K6-shaped update
  rows (nonzero in the occurrence's window only, no scale), as the train
  step hands them to K1. Held to the duplicate tolerance of
  :func:`phase_kernel_apply` on the rows the stream touches, and
  bit-equal elsewhere."""
  from distributed_embeddings_torch.ops.packed_table import adagrad_rule
  plan = zoo_plan()
  routed = zoo_routed(torch, plan)
  gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
  for name, layout in zoo_classes(plan, adagrad_rule(ZOO_LR)):
    ids = torch.cat([ids.reshape(-1).long() for _, ids in routed.pop(name)])
    k1_stream_row(torch, ca, flush, f"tiny_{name}", layout, ids, gen)
    del ids
    torch.cuda.empty_cache()


def k1_stream_row(torch, ca, flush, name: str, layout, ids, gen) -> dict:
  """K1 against its plain version on the class buffer of ``layout``
  (random rows) and the logical ids ``ids`` sent to their physical rows,
  with K6-shaped update rows (nonzero in the occurrence's window only, no
  scale), as the train step hands them to K1. Held to the duplicate
  tolerance of :func:`phase_kernel_apply` on the rows the stream touches,
  and bit-equal elsewhere; timed beside its plain version and
  ``index_add_``. Emits and returns its ``kernel`` row."""
  from distributed_embeddings_torch.ops.packed_table import _grp_sub
  grp, sub, valid = _grp_sub(layout, ids)
  n = grp.shape[0]
  win = torch.arange(D, device="cuda") // layout.stride
  rows = torch.randn((n, D), generator=gen, device="cuda") * 1e-2
  rows = torch.where(win[None, :] == sub[:, None], rows,
                     torch.zeros_like(rows))
  base = torch.rand((layout.phys_rows, D), generator=gen, device="cuda")
  work = base.clone()
  got = ca.apply_rows(work, grp, rows)
  torch.cuda.synchronize()
  want = ca.apply_rows_plain(base.clone(), grp, rows)
  grp_v, rows_v = grp[valid], rows[valid]
  touched, inv = torch.unique(grp_v, return_inverse=True)
  differ = (got != want).any(dim=1)
  differ[touched] = False
  check(not bool(differ.any().item()), f"apply_rows {name}: a row "
        "no id touches differs from the plain version")
  del differ
  abs_sum = base[touched].abs().index_add_(0, inv, rows_v.abs())
  err = (got[touched] - want[touched]).abs()
  share = (err / (1e-5 * abs_sum).clamp(min=1e-30)).max().item()
  max_err = err.max().item()
  del want, abs_sum, err
  check(share <= 1.0, f"apply_rows {name}: off by {share} x 1e-5 "
        "of the cells' absolute sums")
  hits = torch.bincount(inv)
  timed = event_ms(torch, {
      "kernel_ms": lambda: ca.apply_rows(work, grp, rows),
      "plain_ms": lambda: ca.apply_rows_plain(work, grp, rows),
      "library_ms": lambda: work.index_add_(0, grp_v, rows_v)}, flush)
  n_valid, unique = grp_v.shape[0], touched.shape[0]
  row = {"phase": "kernel", "name": "apply_rows", "stream": name,
         "plan": k1_plan_check(torch, ca, n),
         "rows": layout.phys_rows, "width": D,
         "logical_width": layout.width,
         "rows_per_phys": layout.rows_per_phys, "ids": n,
         "valid_ids": n_valid, "unique_rows": unique,
         "most_hits_on_a_row": int(hits.max().item()),
         "max_abs_err": max_err, "max_abs_sum_share": share, **timed,
         **bound(n * 8 + n_valid * D * 4 + unique * D * 4 * 2,
                 2 * n_valid * D, F32_FLOPS)}
  emit(row)
  del base, work, got, rows, grp, sub, valid, grp_v, rows_v, touched, inv
  return row


def phase_kernel_layout(torch, cl, flush) -> dict:
  """K7 against its plain version, bit-equal, on views of the shape of
  Tiny's largest one-hot cotangent ([12, 65536, 16]): transposed (f32 and
  bf16) and sliced ones take the vector path, a transpose of the last two
  dimensions (f32 and bf16) the tile path, a stride-0 broadcast of the
  innermost dimension the general path. Every view is timed against
  ``x.contiguous()``; returns the transposed f32 row."""
  gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
  n_b, g, w = 12, ZOO_BATCH, 16

  def randn(*shape):
    return torch.randn(shape, generator=gen, device="cuda")

  # name -> (view, the path the wrapper must choose for it)
  views = {
      "transposed": (randn(g, n_b, w).transpose(0, 1), "vector"),
      "sliced": (randn(n_b, g, 2 * w)[:, :, :w], "vector"),
      "transposed_bf16": (randn(g, n_b, w).to(torch.bfloat16)
                          .transpose(0, 1), "vector"),
      "last_two": (randn(n_b, w, g).transpose(1, 2), "transpose"),
      "last_two_bf16": (randn(n_b, w, g).to(torch.bfloat16).transpose(1, 2),
                        "transpose"),
      "broadcast": (randn(g, n_b, w)[:, :, :1].expand(-1, -1, w)
                    .transpose(0, 1), "general"),
  }
  main = None
  for name, (x, path) in views.items():
    check(not x.is_contiguous(), f"row_major {name}: input is contiguous")
    check(cl.plan_of(x).path == path,
          f"row_major {name}: path {cl.plan_of(x).path}, not {path}")
    got = cl.row_major(x)
    torch.cuda.synchronize()
    want = cl.row_major_plain(x)
    bits = torch.int32 if x.dtype == torch.float32 else torch.int16
    check(got.is_contiguous() and torch.equal(got.view(bits),
                                              want.view(bits)),
          f"row_major {name}: not bit-equal to the plain version")
    # bytes: the output written once, each distinct source element read
    # once (a broadcast reads 1/w of its output's elements)
    reads = x.numel() // w if name == "broadcast" else x.numel()
    row = {"phase": "kernel", "name": "row_major", "stream": name,
           "path": path, "shape": list(x.shape),
           "strides": list(x.stride()), "dtype": str(x.dtype),
           "bit_equal": True, "max_abs_err": 0.0,
           **event_ms(torch, {
               "kernel_ms": lambda: cl.row_major(x),
               "plain_ms": lambda: cl.row_major_plain(x),
               "library_ms": lambda: x.contiguous()}, flush),
           **bound((x.numel() + reads) * x.element_size(), 0, F32_FLOPS)}
    emit(row)
    if name == "transposed":
      main = row
  del views
  torch.cuda.empty_cache()
  return main


def phase_zoo_golden(torch) -> None:
  from distributed_embeddings_torch import train_golden
  data = train_golden.load(train_golden.ZOO_PATH)
  losses, got = train_golden.replay_zoo(data, device="cuda")
  try:
    worst = train_golden.compare_zoo(data, losses, got)
  except AssertionError as exc:
    raise SmokeFailure(f"zoo golden: {exc}") from exc
  emit({"phase": "zoo_golden", "losses": losses,
        "want_losses": [float(v) for v in data["losses"]], **worst,
        "loss_tol": train_golden.LOSS_TOL,
        "update_tol": train_golden.UPDATE_TOL})


def zoo_batches(torch, n: int = 2) -> list:
  """``tools/bench_synthetic.py``'s batches: ``generate_batch(tiny, 65536,
  alpha=1.05, seed=i)``, ids clamped to each table, one-hot inputs as
  ``[B]``, on the card."""
  import numpy as np

  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      expand_tables,
      generate_batch,
  )
  cfg = SYNTHETIC_MODELS[ZOO_MODEL]
  tables, tmap, hot = expand_tables(cfg)
  out = []
  for i in range(n):
    numerical, cats, labels = generate_batch(cfg, ZOO_BATCH, alpha=ZOO_ALPHA,
                                             seed=i)
    cats = [np.minimum(c, tables[t].input_dim - 1).astype(np.int32)
            for c, t in zip(cats, tmap)]
    cats = [torch.as_tensor(c if h > 1 else c[:, 0], device="cuda")
            for c, h in zip(cats, hot)]
    out.append((torch.as_tensor(numerical, device="cuda"), cats,
                torch.as_tensor(labels, device="cuda")))
  return out


def zoo_hits(torch, plan, batch) -> dict:
  """Per class buffer, how many ids of ``batch`` hit each of its logical
  rows."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
      padded_rows,
  )
  out = {}
  for bk, ids in DistributedLookup(plan).route_ids(batch[1]).items():
    name = class_param_name(*bk.class_key)
    rows = padded_rows(plan, bk.class_key)
    flat = ids.reshape(-1).long()
    flat = flat[(flat >= 0) & (flat < rows)]
    cnt = out.setdefault(name, torch.zeros((rows,), dtype=torch.int32,
                                           device="cuda"))
    cnt.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
  return out


def zoo_phys_hits(layout, cnt):
  """Logical-row hit counts -> the most of them in each physical row."""
  full = cnt.new_zeros(layout.phys_rows * layout.rows_per_phys)
  full[:cnt.shape[0]] = cnt
  return full.view(layout.phys_rows, layout.rows_per_phys).amax(dim=1)


def zoo_rel_diff(torch, a, b) -> float:
  """max |a - b| / max(|a|, |b|) over the cells that differ (0 if none)."""
  bad = a != b
  if not bool(bad.any().item()):
    return 0.0
  return ((a[bad] - b[bad]).abs()
          / torch.maximum(a[bad].abs(), b[bad].abs())).max().item()


def zoo_compare_pin(torch, step, state, batch, hits, layouts,
                    want) -> tuple:
  """One step with ``DE_TORCH_COTANGENT_PIN`` off (on ``state``) and one
  with it on (on a copy), from the same state before either has stepped.
  The losses, the K6 update rows of every bucket and the dense parameters
  are bit-equal; every class buffer is bit-equal on the rows that fewer
  than two of the step's ids hit, and within ``ZOO_DUP_RTOL`` of each cell
  on the others, where the atomics of K1 and of the dense-class
  ``index_add_`` add the duplicates in an order of the card's choosing.
  The unpinned step launches no K7, the pinned one one per sparse bucket.
  Returns ``(result, the pinned step's launches)``."""
  import os

  from distributed_embeddings_torch.parallel import lookup_engine
  snap = {"fused": {k: v.clone() for k, v in state["fused"].items()},
          "emb_dense": {k: v.detach().clone()
                        for k, v in state["emb_dense"].items()},
          "dense": {k: v.detach().clone() for k, v in state["dense"].items()},
          "step": state["step"]}  # fresh optimizers bind at its first step
  kernel = lookup_engine.build_delta_rows
  built = {"0": [], "1": []}
  runs = {}
  for pin, st in (("0", state), ("1", snap)):
    def recording(*args, _pin=pin, **kwargs):
      rows = kernel(*args, **kwargs)
      if _pin == "0":
        built["0"].append(rows)
      else:
        i = len(built["1"])
        built["1"].append(i < len(built["0"])
                          and torch.equal(rows, built["0"][i]))
      return rows
    os.environ["DE_TORCH_COTANGENT_PIN"] = pin
    lookup_engine.build_delta_rows = recording
    try:
      reset_counts()
      torch.cuda.synchronize()
      _, loss = step(st, *batch)
      torch.cuda.synchronize()
      runs[pin] = (float(loss), read_counts())
    finally:
      os.environ.pop("DE_TORCH_COTANGENT_PIN", None)
      lookup_engine.build_delta_rows = kernel
  want_pin = dict(want, row_major=want["build_delta_rows"])
  check(runs["0"][1] == want, f"zoo pin off: launches {runs['0'][1]}, "
        f"expected {want}")
  check(runs["1"][1] == want_pin, f"zoo pin on: launches {runs['1'][1]}, "
        f"expected {want_pin}")
  check(runs["0"][0] == runs["1"][0],
        f"zoo pin: loss {runs['1'][0]} pinned, {runs['0'][0]} unpinned")
  check(len(built["1"]) == len(built["0"]) and all(built["1"]),
        "zoo pin: the K6 update rows differ between the pinned and the "
        "unpinned step")
  for k, v in state["dense"].items():
    check(torch.equal(v, snap["dense"][k]),
          f"zoo pin: dense parameter {k} differs")
  dup_worst, dup_rows = 0.0, 0
  for part in ("fused", "emb_dense"):
    for name, buf in state[part].items():
      other = snap[part][name]
      dup = (zoo_phys_hits(layouts[name], hits[name]) if part == "fused"
             else hits[name]) >= 2
      dup_rows += int(dup.sum().item())
      bad = (buf != other).any(dim=1)
      check(not bool((bad & ~dup).any().item()),
            f"zoo pin {name}: a row fewer than two ids hit differs")
      dup_worst = max(dup_worst, zoo_rel_diff(torch, buf.detach(),
                                              other.detach()))
  check(dup_worst <= ZOO_DUP_RTOL, f"zoo pin: duplicate rows differ by "
        f"{dup_worst} of their magnitude")
  del snap, built
  torch.cuda.empty_cache()
  return ({"loss_bit_equal": True, "update_rows_bit_equal": True,
           "dense_bit_equal": True, "dup_rows": dup_rows,
           "dup_rows_max_rel_diff": dup_worst,
           "launches_unpinned": runs["0"][1],
           "launches_pinned": runs["1"][1]}, runs["1"][1])


def phase_train_zoo(torch, smi: str) -> dict:
  """``tools/bench_synthetic.py tiny 65536`` in the port at world 1; returns
  each kernel's launches in its unpinned run (``train_zoo``) and in the
  pinned step (``train_zoo_pin``)."""
  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      SyntheticModel,
      bce_loss,
  )
  from distributed_embeddings_torch.ops.packed_table import (
      adagrad_rule,
      gather_fused,
  )
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_buckets,
      class_param_name,
  )
  from distributed_embeddings_torch.training import (
      Adagrad,
      init_sparse_state_direct,
      make_sparse_train_step,
  )
  cfg = SYNTHETIC_MODELS[ZOO_MODEL]
  plan = zoo_plan()
  rule = adagrad_rule(ZOO_LR)
  hot = zoo_hotness()
  layouts = DistributedLookup(plan).fused_layouts(rule)
  sparse = [k for k in plan.class_keys if plan.classes[k].kind == "sparse"]
  buckets = [b for k in sparse for b in class_buckets(plan, k,
                                                     lambda i: hot[i])]
  # K6 once per sparse bucket (every class is Adagrad on 128-lane rows),
  # K1 once per sparse class, no K7 unpinned; the model has no
  # interaction and the plan no exchange
  want = expect(build_delta_rows=len(buckets), apply_rows=len(sparse))
  occurrences = sum(b.n_b * b.h for b in buckets) * ZOO_BATCH
  model = SyntheticModel(cfg, tables=False, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
  adagrad = functools.partial(Adagrad, lr=ZOO_LR)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), adagrad,
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  batches = zoo_batches(torch)
  hits = [zoo_hits(torch, plan, b) for b in batches]
  step = make_sparse_train_step(model, plan, bce_loss, adagrad, rule)
  pin, pin_counts = zoo_compare_pin(torch, step, state, batches[0], hits[0],
                                    layouts, want)
  # sampled logical rows of every sparse class (their fused rows: table
  # and accumulator lanes): untouched by both batches, and touched by each
  pick = torch.Generator(device="cuda").manual_seed(SEED + 2)

  def sample(mask):
    idx = torch.nonzero(mask).squeeze(1)
    return idx[torch.randperm(idx.numel(), generator=pick,
                              device="cuda")[:ROWS_SAMPLED]]

  def fused_rows(name, ids):
    return gather_fused(layouts[name], state["fused"][name], ids)

  miss, hit = {}, {}
  for name in layouts:
    miss[name] = sample((hits[0][name] == 0) & (hits[1][name] == 0))
    hit[name] = [sample(h[name] > 0) for h in hits]
    check(miss[name].numel() > 0 and min(h.numel() for h in hit[name]) > 0,
          f"zoo {name}: no untouched or no touched rows to sample")
  miss_rows = {n: fused_rows(n, m) for n, m in miss.items()}
  totals = expect()
  ms, losses, changed = [], [], []
  for i in range(TRAIN_WARMUP + TRAIN_TIMED):
    batch = batches[i % 2]
    before = {n: fused_rows(n, h[i % 2]) for n, h in hit.items()}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, *batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = read_counts()
    check(got == want, f"train_zoo step {i}: launches {got}, expected {want}")
    add_counts(totals, got)
    if i >= TRAIN_WARMUP:
      ms.append((t1 - t0) * 1e3)
    losses.append(float(loss))
    check(losses[-1] == losses[-1] and abs(losses[-1]) < float("inf"),
          f"train_zoo step {i}: loss {losses[-1]}")
    share = []
    for n, h in hit.items():
      check(torch.equal(fused_rows(n, miss[n]), miss_rows[n]),
            f"train_zoo step {i}: rows of {n} no id touches changed")
      share.append((fused_rows(n, h[i % 2]) != before[n]).any(dim=1).float()
                   .mean().item())
    changed.append(min(share))
    check(changed[-1] > 0.5, f"train_zoo step {i}: only {changed[-1]:.1%} "
          "of the sampled touched rows of a class changed")
  peak = torch.cuda.max_memory_allocated() / 2**30
  med = statistics.median(ms)
  ZOO_SPARSE_STEP.update(step_ms_median=med,
                         samples_per_s=ZOO_BATCH / (med / 1e3),
                         peak_gib=peak)
  emit({"phase": "train_zoo", "model": ZOO_MODEL, "card": smi,
        "batch": ZOO_BATCH, "alpha": ZOO_ALPHA, "rule": "adagrad",
        "lr": ZOO_LR, "compute": "f32",
        "tables": len(plan.global_configs), "inputs": len(hot),
        "sparse_classes": [class_param_name(*k) for k in sparse],
        "sparse_buckets": [[b.h, b.n_b] for b in buckets],
        "sparse_occurrences_per_step": occurrences,
        "dense_class_tables": sum(len(cp.shards_per_rank[0])
                                  for cp in plan.classes.values()
                                  if cp.kind == "dense"),
        "fused_bytes": sum(t.numel() * 4 for t in state["fused"].values()),
        "init_s": init_s, "step_ms": ms, "step_ms_median": med,
        "samples_per_s": ZOO_BATCH / (med / 1e3), "peak_gib": peak,
        "launches_per_step": want, "losses": losses,
        "untouched_logical_rows": {n: int(((hits[0][n] == 0)
                                           & (hits[1][n] == 0)).sum().item())
                                   for n in layouts},
        "touched_rows_changed_share": changed,
        "untouched_rows_bit_equal": True, "pin": pin})
  trace = trace_call(torch, lambda: step(state, *batches[0]),
                     kernels={"apply_rows": ("apply_tiles_kernel",),
                              "build_delta_rows": ("build_delta_",)})
  for name, n in (("apply_rows", len(sparse)),
                  ("build_delta_rows", len(buckets))):
    check(trace["kernel_device_ms"][name]["launches"] == n,
          f"train_zoo_trace: {trace['kernel_device_ms'][name]['launches']} "
          f"device launches of {name} in the traced step, expected {n}")
  emit({"phase": "train_zoo_trace", "card": smi, **trace})
  del hits, miss_rows
  zoo_ragged = _zoo_ragged(torch, smi, plan, rule, step, state, layouts,
                           batches[0])
  del state, step
  torch.cuda.empty_cache()
  return {"train_zoo": totals, "train_zoo_pin": pin_counts,
          "train_zoo_ragged": zoo_ragged}


def phase_kernel_sliced(torch, ca, cd, flush) -> None:
  """K6 and K1 against their plain versions on the column-sliced narrow
  layouts of ``world4_colslice`` (:func:`w4_narrow_plan`, this machine's
  backend): for the largest class of each width (2 and 4 lanes), K6 with
  Adagrad on a world-4 rank's streams of ``W4_BATCH`` samples, one-hot
  (stride-wide state rows) and ten-hot (window-masked physical rows), the
  windows of power-law ids; K1 on the class buffer under SGD (32-64 rows
  a physical row) and Adagrad (16-32), the two streams' ids together."""
  import numpy as np

  from distributed_embeddings_torch.models.synthetic import power_law_ids
  from distributed_embeddings_torch.ops.packed_table import (
      _grp_sub,
      adagrad_rule,
      sgd_rule,
  )
  backend = "nccl" if torch.cuda.device_count() >= WORLD else "gloo"
  _, plan = w4_narrow_plan(backend)
  gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
  for r, rule in enumerate((adagrad_rule(ZOO_LR), sgd_rule(TRAIN_LR))):
    classes = zoo_classes(plan, rule)
    check(sorted(lay.width for _, lay in classes) == [2, 4],
          f"the narrow plan's widths {[lay.width for _, lay in classes]}")
    for c, (name, layout) in enumerate(classes):
      rng = np.random.default_rng(SEED + 50 + c)
      streams = {h: torch.from_numpy(power_law_ids(
          rng, W4_BATCH, h, layout.rows, ZOO_ALPHA).reshape(-1)).to("cuda")
          for h in (1, 10)}
      if rule.n_aux:
        for h, ids in streams.items():
          _, sub, _ = _grp_sub(layout, ids)
          k6_stream_row(torch, cd, flush, f"sliced_{name}", layout, rule,
                        sub, h, SEED + 60 + 2 * c + h)
          del sub
      k1_stream_row(torch, ca, flush, f"sliced_{rule.name}_{name}", layout,
                    torch.cat(list(streams.values())), gen)
      del streams
      torch.cuda.empty_cache()


def _load_script(name: str, *parts):
  """A script of the repository (``parts``: its path) as a module."""
  import importlib.util
  import os

  root = os.path.dirname(os.path.abspath(__file__))
  spec = importlib.util.spec_from_file_location(name,
                                                os.path.join(root, *parts))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def phase_zoo_main(torch, smi: str) -> dict:
  """The README Quick start's last command in the port:
  ``examples/benchmarks/synthetic_models/main_torch.py`` (``main(argv)`` in
  this process, so the counters see it) with ``ZOO_MAIN_FLAGS``, f32 and
  ``--amp``: Tiny at its published widths and vocabulary, its own
  ``DistributedEmbedding`` (4.49 GB of class buffers), ``training.Adagrad``
  over every parameter, the dense-autodiff step. Every loss finite, the
  mean loss of the last pass over the batches below the first pass's, no
  kernel launched. Its step ms,
  samples/s and peak memory beside the sparse Tiny step of this run
  (``train_zoo``). Returns each run's launches."""
  import contextlib
  import io

  twin = _load_script("zoo_main_torch", "examples", "benchmarks",
                      "synthetic_models", "main_torch.py")
  out = {}
  for tag, extra in (("f32", ()), ("amp", ("--amp",))):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
      res = twin.main(list(ZOO_MAIN_FLAGS) + list(extra))
    wall = time.perf_counter() - t0
    got = read_counts()
    check(got == expect(), f"zoo_main {tag}: launches {got}, expected none "
          "(the dense-autodiff zoo step runs no hand-written kernel)")
    losses = res["losses"]
    check(all(v == v and abs(v) < float("inf") for v in losses),
          f"zoo_main {tag}: losses {losses}")
    n = ZOO_MAIN_BATCHES
    first, last = losses[:n], losses[-n:]
    check(len(losses) >= 2 * n and sum(last) < sum(first),
          f"zoo_main {tag}: the losses did not fall over a pass of the "
          f"{n} batches: {losses}")
    emit({"phase": "zoo_main", "compute": tag, "card": smi,
          "argv": list(ZOO_MAIN_FLAGS) + list(extra),
          "step_ms": res["step_ms"], "samples_per_s": res["samples_per_s"],
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "losses": losses, "printed": buf.getvalue().splitlines(),
          "launches": got, "wall_s": wall,
          "sparse_train_zoo_step": dict(ZOO_SPARSE_STEP)})
    out[f"zoo_main_{tag}"] = got
  torch.cuda.empty_cache()
  return out


def phase_lookup_bench(torch, smi: str) -> None:
  """``examples/benchmarks/benchmark_torch.py`` at each hotness cap of
  ``LOOKUP_BENCH_HOTNESS`` (vocab 1M x 128, batch 16,384): the CSR lookup
  (``ops.csr_lookup``) against the padded gather + reduce, forward,
  gradient and SGD step, and the engine's ``segment_reduce`` combine, in
  CUDA-event medians."""
  import contextlib
  import io

  bench = _load_script("benchmark_torch", "examples", "benchmarks",
                       "benchmark_torch.py")
  for h in LOOKUP_BENCH_HOTNESS:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
      res = bench.main(["--hotness", str(h)])
    for name, row in res["rows"].items():
      check(all(v > 0 for v in row.values()), f"lookup_bench {name}: {row}")
    emit({"phase": "lookup_bench", "hotness": h, "card": smi, **res,
          "printed": buf.getvalue().splitlines(),
          "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()


def ptxas_report(log: str) -> list:
  """Each entry function of an ``nvcc -Xptxas -v`` log: its (mangled)
  name, registers per thread, static shared memory and spill bytes
  (dynamic shared memory is sized at launch and not in the log)."""
  funcs = []
  for ln in log.splitlines():
    entry = re.search(r"Compiling entry function '([^']+)'", ln)
    if entry:
      funcs.append({"function": entry.group(1), "registers": None,
                    "smem_bytes": 0, "spill_stores": None,
                    "spill_loads": None})
      continue
    if not funcs:
      continue
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
    if spill:
      funcs[-1]["spill_stores"] = int(spill.group(1))
      funcs[-1]["spill_loads"] = int(spill.group(2))
    regs = re.search(r"Used (\d+) registers", ln)
    if regs:
      funcs[-1]["registers"] = int(regs.group(1))
      smem = re.search(r"(\d+) bytes smem", ln)
      funcs[-1]["smem_bytes"] = int(smem.group(1)) if smem else 0
  return funcs


def fp8_blocks(torch):
  """The fp8 codec's check blocks (host f32, 4,099 values each):
  magnitudes spread over 2^+-30, an all-zero block, a block whose amax
  maps exactly onto 448, one whose values fall in e4m3's subnormals once
  scaled, and the cast's edge values (448, the midpoints about it, 464,
  past it, the subnormal midpoints, 0, inf and NaN of both signs)."""
  gen = torch.Generator().manual_seed(SEED + 31)
  x = torch.randn((FP8_BLOCKS, 4099), generator=gen) * torch.exp2(
      torch.empty((FP8_BLOCKS, 1)).uniform_(-30, 30, generator=gen))
  x[1] = 0.0
  x[2] = torch.empty(4099).uniform_(-448, 448, generator=gen)
  x[2, :2] = torch.tensor([448.0, -448.0])
  x[3] = torch.randn(4099, generator=gen) * 2.0 ** -12
  x[3, 0] = 1.0
  edges = torch.tensor([448.0, -448.0, 440.0, 456.0, 463.99, 464.0, -464.0,
                        464.01, 480.0, 1e6, float("inf"), float("-inf"),
                        float("nan"), 2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -9,
                        2.5 * 2.0 ** -9, 0.0, -0.0, 1.0625, 1.1875])
  return x, edges


def phase_fp8_codec(torch, flush) -> None:
  """``fp8_codec``: the wire's fp8 block codec (``parallel/wire.py``,
  plain PyTorch operations) on the card bit-equal to the CPU's: the
  encoded bytes of :func:`fp8_blocks`, their decode, the e4m3 cast of
  the edge values; then the encode and decode of one world-4 payload
  (the four-card cell's largest sparse bucket: ``[4, n_b * 16,384 *
  128]`` f32) timed beside their bound (5 bytes a value moved)."""
  from distributed_embeddings_torch.parallel import wire
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
  )
  x, edges = fp8_blocks(torch)
  want = wire._fp8_encode(x)
  got = wire._fp8_encode(x.cuda()).cpu()
  check(torch.equal(got, want), "fp8 encode: the card's bytes differ from "
        f"the CPU's in {int((got != want).sum())} places")
  dec_want = wire._fp8_decode(want, torch.float32)
  dec_got = wire._fp8_decode(want.cuda(), torch.float32).cpu()
  check(torch.equal(dec_got.view(torch.int32), dec_want.view(torch.int32)),
        "fp8 decode: the card's values differ from the CPU's")
  cast_want = wire._e4m3_bytes(edges)
  cast_got = wire._e4m3_bytes(edges.cuda()).cpu()
  check(torch.equal(cast_got, cast_want), "fp8 cast: the card's edge bytes "
        f"{cast_got.tolist()} differ from the CPU's {cast_want.tolist()}")
  check(float(want[1, -4:].clone().view(torch.float32)) == 1.0
        and float(want[2, -4:].clone().view(torch.float32)) == 1.0,
        "fp8 encode: the zero and the 448 blocks do not keep scale 1")
  _, plan = world4_plan("nccl")
  n_b = max(bucket.n_b for key in plan.class_keys
            if plan.classes[key].kind == "sparse"
            for bucket in class_buckets(plan, key, lambda i: 1))
  m = n_b * (W4_BATCH // WORLD) * D
  gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
  payload = torch.randn((WORLD, m), generator=gen, device="cuda")
  enc = wire._fp8_encode(payload)
  times = event_ms(torch, {
      "encode": lambda: wire._fp8_encode(payload),
      "decode": lambda: wire._fp8_decode(enc, torch.float32)}, flush,
                   reps=10)
  values = WORLD * m
  check(bool(((wire._fp8_decode(enc, torch.float32) - payload).abs()
              <= 2.0 ** -4 * payload.abs().amax(dim=1, keepdim=True))
             .all()), "fp8 round trip: a value left its block's half-ulp")
  emit({"phase": "fp8_codec", "blocks": FP8_BLOCKS, "edges": len(edges),
        "bit_equal_cpu": True, "payload": [WORLD, m], "n_b": n_b,
        "encode_ms": times["encode"], "decode_ms": times["decode"],
        "bound_ms": bound(5 * values, 0, 1)["bound_ms"],
        "bound_by": "bytes", "bytes_f32": 4 * values,
        "bytes_wire": values + 4 * WORLD})
  del payload, enc
  torch.cuda.empty_cache()


def phase_unique_map(torch, flush) -> None:
  """``unique_map``: ``ops/sparse_grad.py: unique_ids_map`` (sort, run
  starts, ``cumsum``, ``scatter_reduce``) on the card at the one-card
  world-4 cell's block (its largest sparse bucket: ``[4, n_b * 16,384]``
  ids in ``[0, sentinel]``, a tenth of them the sentinel), with the safe
  capacity and with ``W4_WIRE_CAP``, and ``expand_unique_rows``, under
  ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises), each
  bit-equal to the CPU's; then timed."""
  from distributed_embeddings_torch.ops.sparse_grad import (
      expand_unique_rows,
      unique_ids_map,
  )
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
      padded_rows,
  )
  _, plan = world4_plan("gloo", dedup_exchange=True)
  key, bucket = max(((key, bucket) for key in plan.class_keys
                     if plan.classes[key].kind == "sparse"
                     for bucket in class_buckets(plan, key, lambda i: 1)),
                    key=lambda kb: (kb[1].n_b, padded_rows(plan, kb[0])))
  sentinel = padded_rows(plan, key)
  m = bucket.n_b * (W4_BATCH // WORLD)
  cap = min(m, sentinel + 1)
  gen = torch.Generator().manual_seed(SEED + 33)
  ids = torch.randint(0, sentinel, (WORLD, m), generator=gen,
                      dtype=torch.int32)
  ids[torch.rand((WORLD, m), generator=gen) < 0.1] = sentinel
  rows = torch.randn((WORLD, cap, 8), generator=gen)
  want = {"safe": unique_ids_map(ids, sentinel, cap, with_count=True),
          "capped": unique_ids_map(ids, sentinel, W4_WIRE_CAP,
                                   with_count=True)}
  want["expand"] = expand_unique_rows(rows, want["safe"][1])
  dev_ids, dev_rows = ids.cuda(), rows.cuda()
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    got = {"safe": unique_ids_map(dev_ids, sentinel, cap, with_count=True),
           "capped": unique_ids_map(dev_ids, sentinel, W4_WIRE_CAP,
                                    with_count=True)}
    got["expand"] = expand_unique_rows(dev_rows, got["safe"][1])
  finally:
    torch.cuda.set_sync_debug_mode(0)
  for name in ("safe", "capped"):
    for part, g, w in zip(("uniq", "inv", "n_distinct"), got[name],
                          want[name]):
      check(torch.equal(g.cpu(), w), f"unique_map {name}: the card's {part} "
            "differs from the CPU's")
  check(torch.equal(got["expand"].cpu(), want["expand"]),
        "unique_map: expand_unique_rows differs from the CPU's")
  times = event_ms(torch, {
      "unique_ids_map": lambda: unique_ids_map(dev_ids, sentinel, cap,
                                               with_count=True)}, flush,
                   reps=10)
  emit({"phase": "unique_map", "blocks": WORLD, "block_ids": m,
        "sentinel": sentinel, "capacity": cap, "capped": W4_WIRE_CAP,
        "sync_debug_mode": "error", "bit_equal_cpu": True,
        "n_distinct": want["safe"][2].tolist(),
        "overflow_at_cap": int((want["capped"][2] - W4_WIRE_CAP)
                               .clamp(min=0).sum()),
        "ms": times["unique_ids_map"]})


# ---------------------------------------------------------------------------
# ragged value streams (slice 15)
# ---------------------------------------------------------------------------


def ragged_capacity(b: int, h: int) -> int:
  """The value-stream capacity of ``b`` samples of lengths uniform in
  ``[1, h]``: ``ceil(RAGGED_SLACK * b * (1 + h) / 2 / RAGGED_ALIGN) *
  RAGGED_ALIGN``."""
  import math
  return math.ceil(RAGGED_SLACK * b * (1 + h) / 2 / RAGGED_ALIGN) \
      * RAGGED_ALIGN


def ragged_stream(torch, b: int, h: int, vocab: int, gen, device,
                  blocks: int = 1):
  """One ragged feature: ``blocks`` stacked blocks (the JAX package's
  global form, each block's splits from 0) of ``b`` samples, lengths
  uniform in ``[1, h]`` trimmed where a block would pass its capacity, ids
  uniform over the vocabulary (the dead tail past the live stream
  too)."""
  from distributed_embeddings_torch.ops.ragged import RaggedIds
  cap = ragged_capacity(b, h)
  vals, splits = [], []
  for _ in range(blocks):
    lens = torch.randint(1, h + 1, (b,), generator=gen, device=device)
    lens = torch.minimum(lens, (cap - (torch.cumsum(lens, 0) - lens))
                         .clamp(min=0))
    splits.append(torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)]))
    vals.append(torch.randint(0, vocab, (cap,), generator=gen, device=device,
                              dtype=torch.int32))
  return RaggedIds(torch.cat(vals), torch.cat(splits))


def ragged_batch(torch, vocab, b: int, gen, device, blocks: int = 1):
  """``(numerical, cats, labels)`` of ``blocks * b`` samples of the
  multi-hot Criteo mix: feature ``i`` ragged with :data:`MULTI_HOT_SIZES`
  ``[i]`` > 1, else one-hot ``[blocks * b]``."""
  g = blocks * b
  numerical = torch.randn((g, 13), generator=gen, device=device)
  cats = [ragged_stream(torch, b, h, v, gen, device, blocks) if h > 1 else
          torch.randint(0, v, (g,), generator=gen, device=device,
                        dtype=torch.int32)
          for v, h in zip(vocab, MULTI_HOT_SIZES)]
  labels = torch.randint(0, 2, (g,), generator=gen, device=device).float()
  return numerical, cats, labels


def ragged_live(cats, b: int) -> int:
  """The live ids of a batch's inputs (ragged streams up to each block's
  ``row_splits[-1]``, one-hot ids all): one host read per ragged input."""
  from distributed_embeddings_torch.ops.ragged import RaggedIds
  total = 0
  for c in cats:
    if isinstance(c, RaggedIds):
      total += int(c.row_splits.view(-1, b + 1)[:, -1].sum())
    else:
      total += c.numel()
  return total


def padded_twin(cats):
  """Each ragged input of a rank's batch padded to its feature's size
  (``ragged_to_padded``): the same ids, PAD_ID holes."""
  from distributed_embeddings_torch.ops.ragged import RaggedIds
  from distributed_embeddings_torch.parallel.lookup_engine import (
      ragged_to_padded,
  )
  return [ragged_to_padded(c, h) if isinstance(c, RaggedIds) else c
          for c, h in zip(cats, MULTI_HOT_SIZES)]


def ragged_plan(vocab, world: int = 1, overlap: str = "none", mean=(),
                hotness=None, **kw):
  """The multi-hot Criteo cell's plan: ``vocab``'s tables of width 128,
  ``combiner='sum'`` (``'mean'`` for the features in ``mean``),
  ``dense_row_threshold=4096``, the ragged features declared by negative
  ``input_hotness`` (so the planner keeps their tables sparse), or the
  given ``hotness``."""
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  if hotness is None:
    hotness = [-h if h > 1 else 1 for h in MULTI_HOT_SIZES]
  return DistEmbeddingStrategy(
      [TableConfig(input_dim=int(v), output_dim=D,
                   combiner="mean" if i in mean else "sum")
       for i, v in enumerate(vocab)], world,
      "basic" if world == 1 else "memory_balanced",
      dense_row_threshold=4096, input_hotness=list(hotness),
      overlap=overlap, exchange_chunks=1 if overlap == "none" else W4_CHUNKS,
      **kw)


def k1_launches(plan, ids_all, chunk: int = 1 << 22) -> tuple:
  """K1's launches in one step over ``route_ids``' output (this rank's
  parts): one per sparse class, or, for a class whose occurrences pass
  ``chunk``, one per chunk of each of its parts (the apply's rule). Also
  returns the chunked classes' launches by name, and the delta builds
  (K6 for a rule with a lane form): one per part, or per chunk of a
  chunked class."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DedupRouted,
      class_param_name,
  )
  parts = {}
  for bk, ids in ids_all.items():
    if plan.classes[bk.class_key].kind != "sparse":
      continue
    if isinstance(ids, tuple):
      n, h = ids[0].numel(), 0
    elif isinstance(ids, DedupRouted):
      n, h = ids.uniq.numel(), 0
    else:
      n, h = ids.numel(), bk.h
    parts.setdefault(class_param_name(*bk.class_key), []).append((n, h))
  total, builds, chunked = 0, 0, {}
  for name, ps in parts.items():
    if sum(n for n, _ in ps) <= chunk:
      total += 1
      builds += len(ps)
      continue
    k = sum(-(-n // max(max(1, h), (chunk // max(1, h)) * max(1, h)))
            for n, h in ps)
    total += k
    builds += k
    chunked[name] = k
  return total, chunked, builds


def k4_forward_launches(plan, codes, rule=None) -> int:
  """K4 launches of one world-N forward under ``overlap='fused'`` for
  inputs of hotness codes ``codes`` (None: every input one-hot): per
  bucket of each class of :func:`k4_classes` (``rule``: the state's) and
  round, one for a ragged stream (none for an empty one), else one per
  row chunk of the round's block (``B_local`` ids, or the unique capacity
  under ``dedup_exchange``); 0 under the other schedules."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
      padded_rows,
  )
  if plan.overlap != "fused":
    return 0
  b = W4_BATCH // WORLD
  total = 0
  for key in k4_classes(plan, rule):
    for bucket in class_buckets(plan, key, lambda i: 1 if codes is None
                                else codes[i]):
      if bucket.h < 0:
        total += WORLD if -bucket.h - 1 else 0
        continue
      rows = b
      if plan.dedup_exchange:
        rows = min(bucket.n_b * b * bucket.h, padded_rows(plan, key) + 1)
        if plan.dedup_capacity is not None:
          rows = min(rows, plan.dedup_capacity)
      total += WORLD * min(W4_CHUNKS, rows)
  return total


def touched_rows(torch, plan, layouts, ids_all) -> dict:
  """Per sparse class, the physical rows a routed batch can change."""
  from distributed_embeddings_torch.ops.packed_table import _grp_sub
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_param_name,
  )
  rows = {}
  for bk, ids in ids_all.items():
    if plan.classes[bk.class_key].kind != "sparse":
      continue
    name = class_param_name(*bk.class_key)
    flat = (ids[0] if isinstance(ids, tuple) else ids).reshape(-1)
    grp, _, valid = _grp_sub(layouts[name], flat)
    rows.setdefault(name, []).append(grp[valid])
  return {n: torch.unique(torch.cat(v)) for n, v in rows.items()}


def snapshot(torch, state, rows) -> dict:
  """What a step on a batch touching ``rows`` can change: those packed
  rows, the dense-class tables, the dense params, the optimizers' states
  and the step (a train state's worth of memory only on the touched
  rows)."""
  import copy
  return {"fused": {n: state["fused"][n][r].clone() for n, r in rows.items()},
          "emb_dense": {k: v.detach().clone()
                        for k, v in state["emb_dense"].items()},
          "dense": {k: v.detach().clone() for k, v in state["dense"].items()},
          "opt": {o: (copy.deepcopy(state[o].state_dict())
                      if isinstance(state[o], torch.optim.Optimizer)
                      else state[o])
                  for o in ("dense_opt", "emb_dense_opt")},
          "step": state["step"]}


def restore(torch, state, rows, snap) -> None:
  """Put a :func:`snapshot` back."""
  with torch.no_grad():
    for n, r in rows.items():
      state["fused"][n][r] = snap["fused"][n]
    for part in ("emb_dense", "dense"):
      for k, v in state[part].items():
        v.copy_(snap[part][k])
  for o, saved in snap["opt"].items():
    if isinstance(state[o], torch.optim.Optimizer):
      state[o].load_state_dict(saved)
    else:
      state[o] = saved
  state["step"] = snap["step"]


def touched_now(state, rows) -> dict:
  """The touched packed rows, the dense-class tables and the dense params
  as they are now (copies)."""
  out = {f"fused/{n}": state["fused"][n][r].clone() for n, r in rows.items()}
  out.update({f"emb_dense/{k}": v.detach().clone()
              for k, v in state["emb_dense"].items()})
  out.update({f"dense/{k}": v.detach().clone()
              for k, v in state["dense"].items()})
  return out


def ragged_vs_twin(torch, step, state, rows, batch, twin, want, want_twin,
                   counted, what: str) -> dict:
  """One step on the ragged ``batch`` and one on its padded ``twin`` from
  the same state (the touched rows put back between them): the losses
  and every touched row, dense-class table and dense param in the f32
  class (1e-5 of each cell's magnitude: K1 adds duplicates in its
  atomics' order, and the two arms order their occurrences otherwise).
  The state is left as the twin's step left it."""
  numerical, cats, labels = batch
  snap = snapshot(torch, state, rows)
  res = counted(lambda: step(state, numerical, cats, labels), want,
                f"{what} ragged step")
  after = touched_now(state, rows)
  restore(torch, state, rows, snap)
  del snap
  res_t = counted(lambda: step(state, numerical, twin, labels), want_twin,
                  f"{what} padded twin step")
  close = states_close(torch, after, touched_now(state, rows), 1e-5)
  loss, loss_t = float(res[1]), float(res_t[1])
  check(close["within"] and abs(loss - loss_t) <= 1e-5 * max(1.0,
                                                              abs(loss_t)),
        f"{what}: the ragged step left its padded twin by "
        f"{close['max_abs_err']} (losses {loss} / {loss_t})")
  return {"loss": loss, "twin_loss": loss_t, "loss_bit_equal": loss == loss_t,
          "touched_rows": sum(int(r.numel()) for r in rows.values()),
          "max_abs_err": close["max_abs_err"],
          "cells_differing": close["cells_differing"]}


def phase_ragged_golden(torch) -> None:
  from distributed_embeddings_torch import train_golden
  data = train_golden.load(train_golden.RAGGED_PATH)
  losses, got = train_golden.replay_ragged(data, device="cuda")
  try:
    worst = train_golden.compare_ragged(data, losses, got)
  except AssertionError as exc:
    raise SmokeFailure(f"ragged golden: {exc}") from exc
  emit({"phase": "ragged_golden", "losses": losses,
        "want_losses": [float(v) for v in data["losses"]], **worst,
        "loss_tol": train_golden.LOSS_TOL,
        "update_tol": train_golden.UPDATE_TOL})


def phase_train_ragged(torch, smi: str) -> tuple:
  """``train_ragged``: the train cell (the 26 Criteo tables x 1/16, width
  128, SGD ``TRAIN_LR``, B=65,536, f32) with ``combiner='sum'`` and the
  multi-hot Criteo mix (:func:`ragged_batch`). The ragged step against its
  padded twin from one state (:func:`ragged_vs_twin`), then
  ``RAGGED_STEPS`` timed steps (the loss finite, K2-fwd and K2-bwd once,
  K1 as :func:`k1_launches` predicts, chunked apply included; sampled rows
  of the first sparse class that the batch does not touch bit-unchanged),
  and two eval forwards on one state bit-equal. Returns the path's
  launches and what ``serve_ragged`` serves."""
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_buckets,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_eval_step,
      make_sparse_train_step,
  )

  vocab = criteo_vocab()
  b = TRAIN_BATCH
  plan = ragged_plan(vocab, batch_hint=b)
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  engine = DistributedLookup(plan)
  layouts = engine.fused_layouts(rule)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
  batch = ragged_batch(torch, vocab, b, gen, "cuda")
  twin = padded_twin(batch[1])
  ids_all = engine.route_ids(batch[1])
  k1, chunked, _ = k1_launches(plan, ids_all)
  k1_twin, chunked_twin, _ = k1_launches(plan, engine.route_ids(twin))
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows=k1)
  want_twin = expect(interact_fwd=1, interact_bwd=1, apply_rows=k1_twin)
  codes = [-(c.values.shape[0] + 1) if h > 1 else 1
           for c, h in zip(batch[1], MULTI_HOT_SIZES)]
  buckets = [[bk.h, bk.n_b] for key in plan.class_keys
             if plan.classes[key].kind == "sparse"
             for bk in class_buckets(plan, key, lambda i: codes[i])]
  rows = touched_rows(torch, plan, layouts, ids_all)
  name0 = next(iter(rows))
  buf0 = state["fused"][name0]
  hit = torch.zeros((buf0.shape[0],), dtype=torch.bool, device="cuda")
  hit[rows[name0]] = True
  pick = torch.Generator(device="cuda").manual_seed(SEED + 2)
  miss = torch.nonzero(~hit).squeeze(1)
  miss = miss[torch.randperm(miss.numel(), generator=pick,
                             device="cuda")[:ROWS_SAMPLED]]
  miss_rows = buf0[miss].clone()
  step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                rule)
  totals = expect()

  def counted(fn, want_, what):
    reset_counts()
    out = fn()
    got = read_counts()
    check(got == want_, f"train_ragged {what}: launches {got}, expected "
          f"{want_}")
    add_counts(totals, got)
    return out

  twin_check = ragged_vs_twin(torch, step, state, rows, batch, twin, want,
                              want_twin, counted, "train_ragged")
  del twin
  torch.cuda.empty_cache()
  ms, losses = [], []
  for i in range(RAGGED_STEPS):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = counted(lambda: step(state, *batch), want, f"step {i}")
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    losses.append(float(loss))
    check(losses[-1] == losses[-1] and abs(losses[-1]) < float("inf"),
          f"train_ragged step {i}: loss {losses[-1]}")
  check(torch.equal(buf0[miss], miss_rows),
        "train_ragged: rows the batch does not touch changed")
  peak = torch.cuda.max_memory_allocated() / 2**30
  ev = make_sparse_eval_step(model, plan, rule)
  first = counted(lambda: ev(state, *batch[:2]), expect(interact_fwd=1),
                  "eval 1")
  second = counted(lambda: ev(state, *batch[:2]), expect(interact_fwd=1),
                   "eval 2")
  check(torch.equal(first, second),
        "train_ragged: two forwards on one state differ")
  med = statistics.median(ms)
  emit({"phase": "train_ragged", "card": smi, "batch": b, "compute": "f32",
        "multi_hot_sizes": list(MULTI_HOT_SIZES),
        "capacities": {i: c.values.shape[0] for i, c in enumerate(batch[1])
                       if is_ragged(c)},
        "occurrences_per_step": ragged_live(batch[1], b),
        "padded_twin_slots_per_step": sum(c.numel() for c in
                                          padded_twin(batch[1])),
        "sparse_buckets": buckets, "init_s": init_s,
        "fused_bytes": sum(t.numel() * 4 for t in state["fused"].values()),
        "step_ms": ms, "step_ms_median": med,
        "samples_per_s": b / (med / 1e3), "peak_gib": peak,
        "launches_per_step": want, "chunked_apply_launches": chunked,
        "twin_launches_per_step": want_twin,
        "twin_chunked_apply_launches": chunked_twin, "losses": losses,
        "vs_padded_twin": twin_check, "untouched_rows_bit_equal": True,
        "forward_twice_bit_equal": True})
  del step, miss_rows, buf0, hit, first, second
  torch.cuda.empty_cache()
  return totals, {"vocab": vocab, "plan": plan, "rule": rule,
                  "state": state}


def is_ragged(c) -> bool:
  """Whether an input is a ragged value stream."""
  from distributed_embeddings_torch.ops.ragged import RaggedIds
  return isinstance(c, RaggedIds)


def dequantized_state(torch, plan, rule, frozen, state) -> dict:
  """An eval state whose packed tables are an int8 image's rows
  dequantized (one multiply, the serve step's), beside the state's
  dense-class tables and dense params: what the int8 image serves."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  from distributed_embeddings_torch.serving.export import (
      dequantize_rows_int8,
  )
  layouts = DistributedLookup(plan).fused_layouts(rule)
  fused = {}
  for name, meta in frozen.meta.items():
    rows, _ = meta.packed.unpack(frozen.device_blocks[name][0])
    fused[name] = layouts[name].pack(dequantize_rows_int8(rows))
  return {"fused": fused, "emb_dense": state["emb_dense"],
          "dense": state["dense"]}


def phase_serve_ragged(torch, smi: str, trained: dict) -> dict:
  """``serve_ragged``: the serve cell (bf16 compute, B=4096) on
  ``train_ragged``'s state with its request mix (:func:`ragged_batch`),
  f32 and int8 images, in memory (``freeze``) and from an artifact
  (``export`` to a temporary directory, ``load``): per image the
  predictions of every request bit-equal between two calls, between the
  two engines, and to ``make_sparse_eval_step``'s on the image's rows
  (the int8 rows dequantized); K2-fwd once per request. Returns the
  path's launches."""
  import os
  import shutil
  import tempfile

  import numpy as np

  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      export,
      freeze,
      load,
  )
  from distributed_embeddings_torch.training import make_sparse_eval_step

  plan, rule, state = trained["plan"], trained["rule"], trained["state"]
  model = DLRM(trained["vocab"], D, compute_dtype=torch.bfloat16,
               tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
  requests = [ragged_batch(torch, trained["vocab"], SERVE_BATCH, gen,
                           "cuda")[:2] for _ in range(SERVE_REQUESTS)]
  ev = make_sparse_eval_step(model, plan, rule)
  totals = expect()

  def counted(fn, what):
    reset_counts()
    out = fn()
    got = read_counts()
    check(got == expect(interact_fwd=1), f"serve_ragged {what}: launches "
          f"{got}, expected one interact_fwd")
    add_counts(totals, got)
    return out

  def bits(a):
    return np.asarray(a).view(np.int32)

  out = {}
  for q in ("f32", "int8"):
    frozen = freeze(plan, rule, state, q)
    ref = state if q == "f32" else dequantized_state(torch, plan, rule,
                                                     frozen, state)
    want = [counted(lambda: ev(ref, *r), f"{q} eval").cpu().numpy()
            for r in requests]
    del ref
    eng = ServeEngine(model, plan, frozen)
    ms = []
    for i, r in enumerate(requests):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      got = counted(lambda: eng.predict(*r), f"{q} request {i}")
      ms.append((time.perf_counter() - t0) * 1e3)
      again = counted(lambda: eng.predict(*r), f"{q} request {i} again")
      check(np.isfinite(got).all() and np.array_equal(bits(got),
                                                      bits(again)),
            f"serve_ragged {q} request {i}: two calls differ")
      check(np.array_equal(bits(got), bits(want[i])),
            f"serve_ragged {q} request {i}: the predictions differ from "
            "the eval step's")
    del eng
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_ragged_")
    path = os.path.join(tmp, q)
    t0 = time.perf_counter()
    export(path, plan, rule, state, quantize=q)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = load(path, plan, verify_integrity=False)
    load_s = time.perf_counter() - t0
    eng = ServeEngine(model, plan, art)
    for i, r in enumerate(requests):
      got = counted(lambda: eng.predict(*r), f"{q} artifact request {i}")
      check(np.array_equal(bits(got), bits(want[i])),
            f"serve_ragged {q} artifact request {i}: the predictions differ")
    del eng, art, frozen
    shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    out[q] = {"request_ms": ms, "request_ms_median": statistics.median(ms),
              "export_s": export_s, "load_s": load_s}
  emit({"phase": "serve_ragged", "card": smi, "batch": SERVE_BATCH,
        "requests": SERVE_REQUESTS, "compute": "bf16",
        "occurrences_per_request": ragged_live(requests[0][1], SERVE_BATCH),
        "images": out, "two_calls_bit_equal": True,
        "artifact_bit_equal": True, "eval_bit_equal": True,
        "launches": totals})
  return totals


def _zoo_ragged(torch, smi: str, plan, rule, step, state, layouts,
                batch) -> dict:
  """``train_zoo_ragged``: Tiny's ten-hot inputs of ``batch`` as
  ``RaggedIds`` (each sample's first 1-10 ids), capacity
  :func:`ragged_capacity`, one Adagrad step against its padded twin
  (:func:`ragged_vs_twin`) from ``phase_train_zoo``'s state: K6 builds the
  ragged buckets' ``h=0`` parts of the narrow classes (once per sparse
  bucket), K1 once per sparse class. Returns the path's launches."""
  from distributed_embeddings_torch.ops.ragged import RaggedIds
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      ragged_to_padded,
  )
  numerical, cats, labels = batch
  gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
  cap = ragged_capacity(ZOO_BATCH, ZOO_RAGGED_HOT)
  ragged, twin = [], []
  for c in cats:
    if c.dim() == 1:
      ragged.append(c)
      twin.append(c)
      continue
    lens = torch.randint(1, ZOO_RAGGED_HOT + 1, (ZOO_BATCH,), generator=gen,
                         device="cuda")
    lens = torch.minimum(lens, (cap - (torch.cumsum(lens, 0) - lens))
                         .clamp(min=0))
    live = c[torch.arange(c.shape[1], device="cuda") < lens[:, None]]
    values = torch.zeros((cap,), dtype=c.dtype, device="cuda")
    values[:live.numel()] = live
    rg = RaggedIds(values, torch.cat([lens.new_zeros(1),
                                      torch.cumsum(lens, 0)]))
    ragged.append(rg)
    twin.append(ragged_to_padded(rg, ZOO_RAGGED_HOT))
  engine = DistributedLookup(plan)
  ids_all = engine.route_ids(ragged)
  codes = [-(c.values.shape[0] + 1) if isinstance(c, RaggedIds) else
           (1 if c.dim() == 1 else c.shape[1]) for c in ragged]
  def launches(routed):
    k1, _, builds = k1_launches(plan, routed)
    return expect(build_delta_rows=builds, apply_rows=k1)

  want = launches(ids_all)
  want_twin = launches(engine.route_ids(twin))
  totals = expect()

  def counted(fn, want_, what):
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    got = read_counts()
    check(got == want_, f"train_zoo_ragged {what}: launches {got}, "
          f"expected {want_}")
    add_counts(totals, got)
    return out

  ms = []
  rows = touched_rows(torch, plan, layouts, ids_all)
  res = ragged_vs_twin(torch, step, state, rows, (numerical, ragged, labels),
                       twin, want, want_twin, counted, "train_zoo_ragged")
  emit({"phase": "train_zoo_ragged", "card": smi, "batch": ZOO_BATCH,
        "rule": "adagrad", "ragged_inputs": sum(h < 0 for h in codes),
        "capacity": cap, "occurrences_per_step": ragged_live(ragged,
                                                             ZOO_BATCH),
        "ragged_step_ms": ms[0], "twin_step_ms": ms[1],
        "launches_per_step": want, "twin_launches_per_step": want_twin,
        "vs_padded_twin": res})
  return totals


def w4_ragged_plan(backend: str, overlap: str = "fused", scale=None,
                   row_slice: bool = True, hotness=None, **kw):
  """The world-4 ragged cell: the world-4 plan's tables (x ``scale``,
  default ``backend``'s cut) with ``combiner='sum'``, feature
  :data:`RAGGED_MEAN_FEATURE` (row-sliced) ``'mean'``, the ragged features
  declared by negative ``input_hotness`` (or ``hotness``), under
  ``overlap``; ``row_slice=False`` keeps every table whole."""
  scale = scale or W4_VOCAB_SCALE[backend]
  vocab = [max(4, int(v / scale)) for v in CRITEO_1TB_VOCAB]
  return vocab, ragged_plan(
      vocab, WORLD, overlap, mean=(RAGGED_MEAN_FEATURE,), hotness=hotness,
      row_slice_threshold=W4_ROW_SLICE[backend] if row_slice else None,
      batch_hint=W4_BATCH, **kw)


def w4_oov_numpy(plan, cats, b: int) -> dict:
  """Per class, the out-of-vocabulary occurrences of a global batch in the
  stacked form (ragged streams counted up to each block's
  ``row_splits[-1]``), each input counted once per class its pieces live
  in, as ``oov_counts`` counts them (summed over the ranks)."""
  import numpy as np

  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_param_name,
  )
  out = {class_param_name(*k): 0 for k in plan.class_keys}
  for i, pieces in enumerate(plan.output_pieces):
    vocab = plan.global_configs[plan.input_table_map[i]].input_dim
    c = cats[i]
    if is_ragged(c):
      v = np.asarray(c.values).reshape(WORLD, -1)
      ends = np.asarray(c.row_splits).reshape(WORLD, b + 1)[:, -1]
      n = sum(int((v[r, :ends[r]] >= vocab).sum()) for r in range(WORLD))
    else:
      n = int((np.asarray(c) >= vocab).sum())
    for ck in {p.class_key for p in pieces}:
      out[class_param_name(*ck)] += n
  return out


def w4_with_oov(torch, cats, vocab, b: int):
  """A copy of a global batch (stacked form) with, in every rank's block
  of the first two ragged features, one live id past the vocabulary and,
  where the block has a dead tail, one there (which must not count)."""
  from distributed_embeddings_torch.ops.ragged import RaggedIds
  out = list(cats)
  done = 0
  for i, c in enumerate(cats):
    if not is_ragged(c) or done == 2:
      continue
    done += 1
    values = c.values.clone()
    cap = values.shape[0] // WORLD
    ends = c.row_splits.view(WORLD, b + 1)[:, -1]
    for r in range(WORLD):
      values[r * cap] = vocab[i] + 3
      if int(ends[r]) < cap:
        values[r * cap + int(ends[r])] = vocab[i] + 9
    out[i] = RaggedIds(values, c.row_splits)
  return out


def _w4_ragged_acts(torch, plan, mesh, state, batch):
  """The eval step's activations (every input's, concatenated) for a
  batch of any hotness (ragged streams included)."""
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      ragged_hotness,
  )
  numerical, cats, _ = batch
  hot = [ragged_hotness(c) for c in cats]
  engine = DistributedLookup(plan, mesh=mesh)
  with torch.inference_mode():
    ids_all = engine.route_ids(cats, lambda i: hot[i])
    z, _ = engine.lookup_sparse_fused(
        state["fused"], engine.fused_layouts(sgd_rule(TRAIN_LR)), ids_all,
        keep_aux=False)
    acts = engine.finish_forward(z, state["emb_dense"], ids_all,
                                 numerical.shape[0], lambda i: hot[i],
                                 engine.mean_counts(cats))
  return torch.cat(acts, dim=1)


def _w4_ragged(torch, mesh, backend: str) -> dict:
  """``world4_ragged`` in this rank: the world-4 cell's tables with the
  multi-hot Criteo mix (this rank's block of a global batch of
  ``W4_BATCH``, :func:`ragged_batch` on the host), f32, SGD ``TRAIN_LR``,
  one seeded state:

  - the activations under ``overlap='none'``, ``'pipelined'`` and
    ``'fused'`` bit-equal (K4 once per ragged bucket and round under
    ``'fused'``, per row chunk for the one-hot buckets), the padded twin's
    within the f32 class (feature :data:`RAGGED_MEAN_FEATURE`: a
    row-sliced ``mean`` table), ``dedup_exchange=True`` (deduplicated
    one-hot buckets beside raw ragged ones) bit-equal to raw;
  - serving: ``FrozenTables`` f32, a global ragged request of
    ``SERVE_BATCH``, two calls bit-equal and bit-equal to the world-4 eval
    step's predictions;
  - a guarded step whose batch holds out-of-vocabulary ids in live
    windows and dead tails: ``bad_step`` 0 and the OOV counts equal to
    numpy's (:func:`w4_oov_numpy`) on every rank;
  - model-parallel inputs (a plan without row slices, x
    :data:`W4_MP_VOCAB_SCALE`): ``forward_mp`` of a padded global batch
    of :data:`W4_MP_BATCH` bit-equal to the dp-input forward, the class gradients of one
    backward through ``_FillRows`` within 1e-5 of each cell's magnitude
    of the dp-input ones.

  Every run's launches are checked."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel import wire
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      pack_mp_inputs,
      ragged_hotness,
  )
  from distributed_embeddings_torch.serving import ServeEngine, freeze
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_eval_step,
      make_sparse_train_step,
      shard_batch,
  )

  dev = mesh.device
  torch.cuda.empty_cache()
  b = W4_BATCH // WORLD
  vocab, plan = w4_ragged_plan(backend)
  model = DLRM(vocab, D, tables=False, device=dev,
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  host = ragged_batch(torch, vocab, b, torch.Generator().manual_seed(SEED + 18),
                      "cpu", blocks=WORLD)
  batch = shard_batch(host, mesh)
  codes = [ragged_hotness(c) for c in batch[1]]
  totals = expect()

  def counted(fn, want, what):
    reset_counts()
    out = fn()
    got = read_counts()
    check(got == want, f"world 4 ragged {what} rank {mesh.rank}: launches "
          f"{got}, expected {want}")
    add_counts(totals, got)
    return out

  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device=dev).manual_seed(SEED + 51 + mesh.rank),
      mesh=mesh)
  out = {"k4_per_forward": {}, "forward_ms": {}}
  acts = {}
  for overlap in ("none", "pipelined", "fused"):
    _, p = w4_ragged_plan(backend, overlap)
    k4 = k4_forward_launches(p, codes)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    acts[overlap] = counted(lambda: _w4_ragged_acts(torch, p, mesh, state,
                                                    batch),
                            expect(gather_rows=k4), f"{overlap} acts")
    torch.cuda.synchronize(dev)
    out["forward_ms"][overlap] = (time.perf_counter() - t0) * 1e3
    out["k4_per_forward"][overlap] = k4
    check(torch.equal(acts[overlap], acts["none"]),
          f"world 4 ragged rank {mesh.rank}: the {overlap} activations "
          "differ from the monolithic schedule's")
  _, dplan = w4_ragged_plan(backend, dedup_exchange=True)
  k4 = k4_forward_launches(dplan, codes)
  out["k4_per_forward"]["dedup_fused"] = k4
  dacts = counted(lambda: _w4_ragged_acts(torch, dplan, mesh, state, batch),
                  expect(gather_rows=k4), "dedup acts")
  check(torch.equal(dacts, acts["none"]), f"world 4 ragged rank "
        f"{mesh.rank}: the dedup mix's activations differ from raw")
  twin = padded_twin(batch[1])
  twin_codes = [1 if c.dim() == 1 else c.shape[1] for c in twin]
  tacts = counted(lambda: _w4_ragged_acts(torch, plan, mesh, state,
                                          (batch[0], twin, batch[2])),
                  expect(gather_rows=k4_forward_launches(plan, twin_codes)),
                  "padded twin acts")
  err = (tacts - acts["none"]).abs()
  lim = 1e-5 * acts["none"].abs().clamp_min(1.0)
  check(bool((err <= lim).all()), f"world 4 ragged rank {mesh.rank}: the "
        f"padded twin's activations differ by {float(err.max())}")
  cols = slice(RAGGED_MEAN_FEATURE * D, (RAGGED_MEAN_FEATURE + 1) * D)
  out["twin"] = {"max_abs_err": float(err.max()),
                 "bit_equal": bool(torch.equal(tacts, acts["none"])),
                 "mean_row_sliced_max_abs_err": float(err[:, cols].max())}
  del acts, dacts, tacts, twin, err, lim
  # serving a global ragged request
  req = ragged_batch(torch, vocab, SERVE_BATCH // WORLD,
                     torch.Generator().manual_seed(SEED + 19), "cpu",
                     blocks=WORLD)[:2]
  frozen = freeze(plan, rule, state, "f32", mesh=mesh)
  eng = ServeEngine(model, plan, frozen, mesh=mesh)
  first = counted(lambda: eng.predict(*req), expect(interact_fwd=1),
                  "serve")
  again = counted(lambda: eng.predict(*req), expect(interact_fwd=1),
                  "serve again")
  req_codes = [ragged_hotness(c) for c in shard_batch(req, mesh)[1]]
  ev = make_sparse_eval_step(model, plan, rule, mesh=mesh)
  preds = counted(lambda: wire.gather_blocks(ev(state, *shard_batch(
      req, mesh)), mesh), expect(interact_fwd=1, gather_rows=(
          k4_forward_launches(plan, req_codes))), "eval")
  check(np.array_equal(first.view(np.int32), again.view(np.int32))
        and np.array_equal(first.view(np.int32),
                           preds.cpu().numpy().view(np.int32)),
        f"world 4 ragged serve rank {mesh.rank}: two calls or the eval step "
        "differ")
  del frozen, eng
  # the guarded step's OOV counts
  oov_cats = w4_with_oov(torch, host[1], vocab, b)
  ob = shard_batch((host[0], oov_cats, host[2]), mesh)
  step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                rule, mesh=mesh, guard=True)
  # the guarded step gates whole per-class streams: one K1 a class
  k1 = len(state["fused"])
  _, loss, metrics = counted(
      lambda: step(state, *ob),
      expect(gather_rows=k4_forward_launches(
          plan, [ragged_hotness(c) for c in ob[1]]), apply_rows=k1,
          interact_fwd=1, interact_bwd=1), "guarded step")
  want_oov = w4_oov_numpy(plan, oov_cats, b)
  got_oov = {k: int(v) for k, v in metrics["oov"].items()}
  check(int(metrics["bad_step"]) == 0 and got_oov == want_oov
        and sum(want_oov.values()) > 0,
        f"world 4 ragged guard rank {mesh.rank}: bad_step "
        f"{int(metrics['bad_step'])}, oov {got_oov}, numpy {want_oov}")
  out["guard"] = {"loss": float(loss), "oov": got_oov, "k1": k1}
  del state, step
  torch.cuda.empty_cache()
  # model-parallel inputs against the dp-input forward
  mvocab, mplan = w4_ragged_plan(backend, scale=W4_MP_VOCAB_SCALE,
                                 row_slice=False,
                                 hotness=list(MULTI_HOT_SIZES))
  mstate = init_sparse_state_direct(
      mplan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device=dev).manual_seed(SEED + 61 + mesh.rank),
      mesh=mesh)
  mb = W4_MP_BATCH // WORLD
  mhost = ragged_batch(torch, mvocab, mb,
                       torch.Generator().manual_seed(SEED + 20), "cpu",
                       blocks=WORLD)
  glob = []
  for c, h in zip(mhost[1], MULTI_HOT_SIZES):  # the padded global batch
    if not is_ragged(c):
      glob.append(c)
      continue
    cap = c.values.shape[0] // WORLD
    glob.append(torch.cat([padded_twin_one(c, r, cap, mb, h)
                           for r in range(WORLD)]))
  packed = pack_mp_inputs(mplan, [[glob[i] for i in mplan.input_ids_list[r]]
                                  for r in range(WORLD)],
                          list(MULTI_HOT_SIZES))
  block = shard_batch(packed, mesh)
  local = shard_batch(glob, mesh)
  cgen = torch.Generator(device=dev).manual_seed(SEED + 71 + mesh.rank)
  engine = DistributedLookup(mplan, mesh=mesh)
  # the state's own tensors are the leaves (the forwards only read them)
  leaves = {n: t.requires_grad_(True) for n, t in
            list(mstate["fused"].items()) + list(mstate["emb_dense"].items())}
  res = {}
  for form in ("mp", "dp"):
    for p in leaves.values():
      p.grad = None

    def fwd_bwd():
      outs = (engine.forward_mp(leaves, block, list(MULTI_HOT_SIZES))
              if form == "mp" else engine.forward(leaves, local))
      loss = sum((o * torch.randn(o.shape, generator=cgen, device=dev))
                 .sum() for o in outs)
      loss.backward()
      return torch.cat([o.detach() for o in outs], dim=1)

    cgen.manual_seed(SEED + 71 + mesh.rank)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res[form] = (counted(fwd_bwd, expect(), f"{form} input forward"),
                 {n: p.grad for n, p in leaves.items()})
    torch.cuda.synchronize(dev)
    out["forward_ms"][f"{form}_input_fwd_bwd"] = (time.perf_counter()
                                                  - t0) * 1e3
  check(torch.equal(res["mp"][0], res["dp"][0]), f"world 4 mp input rank "
        f"{mesh.rank}: forward_mp differs from the dp-input forward")
  # the gradients on the rows either form reached (the rest are zeros)
  got, want = {}, {}
  for n, g in res["mp"][1].items():
    w = res["dp"][1][n]
    hit = (g != 0).any(dim=1) | (w != 0).any(dim=1)
    got[n], want[n] = g[hit], w[hit]
  close = states_close(torch, got, want, 1e-5)
  check(close["within"], f"world 4 mp input rank {mesh.rank}: gradients "
        f"off by {close['max_abs_err']}")
  out["mp_input"] = {"acts_bit_equal": True,
                     "grad_max_abs_err": close["max_abs_err"],
                     "grad_cells_differing": close["cells_differing"],
                     "packed_ids_per_rank": sum(v.numel()
                                                for v in block.values())}
  out["occurrences_per_rank"] = ragged_live(batch[1], b)
  out["launches"] = totals
  del mstate, leaves, res, got, want, block, local, packed
  torch.cuda.empty_cache()
  return out


def padded_twin_one(c, r: int, cap: int, b: int, h: int):
  """Rank ``r``'s block of a stacked ragged input padded to ``h``."""
  from distributed_embeddings_torch.ops.ragged import RaggedIds
  from distributed_embeddings_torch.parallel.lookup_engine import (
      ragged_to_padded,
  )
  return ragged_to_padded(
      RaggedIds(c.values[r * cap:(r + 1) * cap],
                c.row_splits[r * (b + 1):(r + 1) * (b + 1)]), h)


def emit_ragged_world4(backend: str, smi: str, res: list) -> dict:
  """The ``world4_ragged`` line from the ranks' :func:`_w4_ragged`
  results; returns each kernel's launches summed over the ranks."""
  totals = expect()
  for r in res:
    add_counts(totals, r.pop("launches"))
  check(all(r["guard"]["oov"] == res[0]["guard"]["oov"] for r in res),
        "world 4 ragged: the ranks' OOV counts differ")
  emit({"phase": "world4_ragged", "backend": backend, "card": smi,
        "mode": ("four cards, one rank each" if backend == "nccl" else
                 "one card shared by the four ranks"),
        "vocab_scale": f"1/{W4_VOCAB_SCALE[backend]}",
        "mp_vocab_scale": f"1/{W4_MP_VOCAB_SCALE}", "global_batch": W4_BATCH,
        "mp_global_batch": W4_MP_BATCH,
        "exchange_chunks": W4_CHUNKS,
        "occurrences_by_rank": [r["occurrences_per_rank"] for r in res],
        "k4_per_rank_forward": res[0]["k4_per_forward"],
        "forward_ms_by_rank": [r["forward_ms"] for r in res],
        "schedules_bit_equal": True, "dedup_mix_bit_equal": True,
        "twin_by_rank": [r["twin"] for r in res],
        "serve_bit_equal_eval": True, "guard_oov": res[0]["guard"]["oov"],
        "guard_k1_by_rank": [r["guard"]["k1"] for r in res],
        "mp_input_by_rank": [r["mp_input"] for r in res],
        "launches": totals})
  return totals


# ---------------------------------------------------------------------------
# narrow storage (bf16 tables) and fp8 serve images (slice 17)
# ---------------------------------------------------------------------------


def k1_bf16_check(torch, ca, name: str, base, ids, delta, scale) -> dict:
  """K1's bf16 form on one stream against its plain version: bit-equal
  when no id repeats; where ``m`` occurrences hit a row, every cell within
  ``m * BF16_DUP_ULP`` of its absolute sum (``|buf| + sum |bf16(scale) *
  d|``): the plain version (XLA's scatter) rounds every add, the kernel a
  tile's run of one id once and its atomic once; rows no id touches
  bit-equal. Returns the check's numbers."""
  work = base.clone()
  got = ca.apply_rows(work, ids, delta, scale)
  torch.cuda.synchronize()
  want = ca.apply_rows_plain(base.clone(), ids, delta, scale)
  valid = (ids >= 0) & (ids < base.shape[0])
  ids_v = ids[valid]
  touched, inv = torch.unique(ids_v, return_inverse=True)
  hits = torch.bincount(inv)
  differ = (got != want).any(dim=1)
  differ[touched] = False
  check(not bool(differ.any().item()), f"apply_rows_bf16 {name}: a row no "
        "id touches differs from the plain version")
  del differ
  err = (got[touched].float() - want[touched].float()).abs()
  most = int(hits.max().item())
  if most == 1:
    check(torch.equal(got, want), f"apply_rows_bf16 {name}: unique ids are "
          "not bit-equal to the plain version")
    share = 0.0
  else:
    d = delta[valid].float()
    if scale is not None:
      d = d * torch.tensor(float(scale)).to(torch.bfloat16).float().item()
    abs_sum = base[touched].float().abs().index_add_(0, inv, d.abs())
    lim = hits[:, None].float() * BF16_DUP_ULP * abs_sum
    share = (err / lim.clamp(min=1e-30)).max().item()
    del d, abs_sum, lim
    check(share <= 1.0, f"apply_rows_bf16 {name}: off by {share} x the "
          "bound hits * 3 * 2^-8 * |cell's absolute sum|")
  out = {"max_abs_err": err.max().item(), "dup_bound_share": share,
         "unique_rows": int(touched.numel()), "valid_ids": int(ids_v.numel()),
         "most_hits_on_a_row": most}
  del want, err, touched, inv, hits
  return out


def phase_kernel_apply_bf16(torch, ca, flush, rows: int) -> dict:
  """K1's bf16 form (narrow storage) against its plain version: on the
  train cell's first sparse class in bf16, 131,072 uniform ids, 131,072
  unique ids and 131,072 ids on one row, SGD's scale; and a Tiny-like
  stream, the Tiny step's routed ids of its largest w16 class at
  physical-row granularity (bf16, Adagrad's 32-lane stride, K6-shaped
  update rows, no scale). Timed with CUDA events beside its plain
  version (uniform and unique streams: the plain version adds one
  occurrence level at a time) and a bf16 ``index_add_``. Returns the
  uniform stream's row."""
  from distributed_embeddings_torch.ops.packed_table import (
      _grp_sub,
      adagrad_rule,
  )
  gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
  base = torch.rand((rows, D), generator=gen, device="cuda").to(
      torch.bfloat16)
  streams = k1_streams(torch, rows)
  streams = {k: streams[k] for k in ("uniform", "unique", "one_row")}
  main = None
  for name, ids in streams.items():
    delta = torch.randn((ids.shape[0], D), generator=gen,
                        device="cuda").to(torch.bfloat16)
    res = k1_bf16_check(torch, ca, name, base, ids, delta, K1_SCALE)
    work = base.clone()
    valid = (ids >= 0) & (ids < rows)
    ids_v, delta_v = ids[valid], delta[valid]
    fns = {"kernel_ms": lambda: ca.apply_rows(work, ids, delta, K1_SCALE),
           "library_ms": lambda: work.index_add_(0, ids_v, delta_v,
                                                 alpha=K1_SCALE)}
    if name != "one_row":
      fns["plain_ms"] = lambda: ca.apply_rows_plain(work, ids, delta,
                                                    K1_SCALE)
    timed = event_ms(torch, fns, flush)
    timed.setdefault("plain_ms", None)
    n, nv, uniq = int(ids.shape[0]), res["valid_ids"], res["unique_rows"]
    row = {"phase": "kernel", "name": "apply_rows_bf16", "stream": name,
           "plan": k1_plan_check(torch, ca, n), "rows": rows, "width": D,
           "dtype": "bfloat16", "ids": n, **res, **timed,
           **bound(n * 8 + nv * D * 2 + uniq * D * 2 * 2, 2 * nv * D,
                   F32_FLOPS)}
    emit(row)
    if name == "uniform":
      main = row
    del work, delta, ids_v, delta_v
  del base, streams
  torch.cuda.empty_cache()
  # the Tiny-like stream: the largest w16 class's routed ids, expanded to
  # their physical rows' windows
  plan = zoo_plan()
  routed = zoo_routed(torch, plan)
  name, layout = next((n, lay) for n, lay in
                      zoo_classes(plan, adagrad_rule(ZOO_LR))
                      if lay.width == 16)
  ids = torch.cat([i.reshape(-1).long() for _, i in routed.pop(name)])
  del routed
  grp, sub, _ = _grp_sub(layout, ids)
  win = torch.arange(D, device="cuda") // layout.stride
  delta = torch.randn((grp.shape[0], D), generator=gen, device="cuda") * 1e-2
  delta = torch.where(win[None, :] == sub[:, None], delta,
                      torch.zeros_like(delta)).to(torch.bfloat16)
  base = torch.rand((layout.phys_rows, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
  res = k1_bf16_check(torch, ca, f"tiny_{name}", base, grp, delta, None)
  work = base.clone()
  valid = grp < layout.phys_rows
  grp_v, delta_v = grp[valid], delta[valid]
  timed = event_ms(torch, {
      "kernel_ms": lambda: ca.apply_rows(work, grp, delta),
      "library_ms": lambda: work.index_add_(0, grp_v, delta_v)}, flush)
  n, nv, uniq = int(grp.shape[0]), res["valid_ids"], res["unique_rows"]
  emit({"phase": "kernel", "name": "apply_rows_bf16",
        "stream": f"tiny_{name}", "plan": k1_plan_check(torch, ca, n),
        "rows": layout.phys_rows, "width": D, "logical_width": layout.width,
        "rows_per_phys": layout.rows_per_phys, "dtype": "bfloat16",
        "ids": n, **res, **timed, "plain_ms": None,
        **bound(n * 8 + nv * D * 2 + uniq * D * 2 * 2, 2 * nv * D,
                F32_FLOPS)})
  del base, work, delta, grp, sub, grp_v, delta_v, ids
  torch.cuda.empty_cache()
  return main


def phase_kernel_gather_bf16(torch, cx, flush) -> dict:
  """K4's bf16 form (narrow storage) against its plain version at the
  four-card world-4 path's block shape (the first sparse class's rank
  buffer in bf16, 8,192 ids of one round and chunk): a uniform stream and
  one with 30 % of its ids out of range or sentinels, bit-equal, timed
  beside its plain version and ``index_select`` of clamped ids; edge
  blocks and a short stride bit-equal. Returns the uniform stream's
  row."""
  from distributed_embeddings_torch.ops.packed_table import PackedLayout
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
  )
  _, plan = world4_plan("nccl")
  key, _, rows = first_sparse_class(plan)
  n_b = class_buckets(plan, key, lambda i: 1)[0].n_b
  n = n_b * (W4_BATCH // WORLD // W4_CHUNKS)
  layout = PackedLayout(rows=rows, width=D)
  gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
  buf = torch.rand((rows, D), generator=gen, device="cuda").to(
      torch.bfloat16)
  main = None
  for stream in ("uniform", "out_of_range"):
    ids = torch.randint(0, rows, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if stream == "out_of_range":
      ids = k4_bad_ids(torch, ids, rows, gen)
    got = cx.gather_rows(layout, buf, ids)
    torch.cuda.synchronize()
    check(got.dtype == torch.bfloat16 and torch.equal(
        got, cx.gather_rows_plain(buf, ids)),
          f"gather_rows_bf16 {stream}: not bit-equal to the plain version")
    n_valid = int(((ids >= 0) & (ids < rows)).sum().item())
    timed = event_ms(torch, {
        "kernel_ms": lambda: cx.gather_rows(layout, buf, ids),
        "plain_ms": lambda: cx.gather_rows_plain(buf, ids),
        "library_ms": lambda: buf.index_select(0, ids.clamp(0, rows - 1))},
        flush)
    row = {"phase": "kernel", "name": "gather_rows_bf16", "stream": stream,
           "rows": rows, "width": D, "dtype": "bfloat16", "ids": n,
           "valid_ids": n_valid, "bit_equal": True, "max_abs_err": 0.0,
           **timed,
           "library_note": "index_select of clamped ids: no zero rows",
           **bound(n * 4 + n_valid * D * 2 + n * D * 2, 0, F32_FLOPS)}
    emit(row)
    if stream == "uniform":
      main = row
  for m in K4_EDGE_N:
    ids = k4_bad_ids(torch, torch.randint(0, rows, (m,), generator=gen,
                                          device="cuda", dtype=torch.int32),
                     rows, gen)
    check(torch.equal(cx.gather_rows(layout, buf, ids),
                      cx.gather_rows_plain(buf, ids)),
          f"gather_rows_bf16 n={m}: not bit-equal to the plain version")
  del buf
  short = PackedLayout(rows=100_000, width=65)
  buf = torch.rand(tuple(short.shape), generator=gen, device="cuda").to(
      torch.bfloat16)
  ids = torch.randint(-100, short.rows + 100, (n,), generator=gen,
                      device="cuda", dtype=torch.int32)
  check(torch.equal(cx.gather_rows(short, buf, ids),
                    cx.gather_rows_plain(buf, ids, short.stride)),
        "gather_rows_bf16 stride 65: not bit-equal to the plain version")
  emit({"phase": "kernel", "name": "gather_rows_bf16", "stream": "edges",
        "blocks": list(K4_EDGE_N), "strides": [D, 65], "bit_equal": True})
  del buf
  torch.cuda.empty_cache()
  return main


def _train_batch(torch, vocab, b: int, seed: int):
  """One-hot ids uniform over each table, normal features, random labels
  (``phase_train``'s batch), on the card."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  numerical = torch.randn((b, 13), generator=gen, device="cuda")
  cats = [torch.randint(0, v, (b,), generator=gen, device="cuda",
                        dtype=torch.int32) for v in vocab]
  labels = torch.randint(0, 2, (b,), generator=gen, device="cuda").float()
  return numerical, cats, labels


def phase_train_bf16(torch, smi: str) -> dict:
  """Narrow storage at the MLPerf Criteo-1TB vocabulary on one card
  (``train_bf16``): ``bench.py``'s sparse step (26 tables of width 128,
  ``dense_row_threshold=4096``, one-hot ids, SGD 0.1, f32 compute, B =
  65,536) on tables drawn in bf16 by ``init_sparse_state_direct(dtype=
  torch.bfloat16)``: 187,767,399 rows, 48.07 GB, where the f32 twin would
  need 96.1 GB. The plan lifts the TPU's per-buffer element bound
  (``buffer_elements=None``) so that the largest tables stay whole.
  Checks K1's bf16 form launches once per sparse class and step, K2 once
  each way, the losses are finite, sampled rows the batch does not touch
  stay bit-equal and touched ones move. Returns each kernel's
  launches."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  vocab = list(CRITEO_1TB_VOCAB)
  # five tables of 25.6-40.0 M rows stay whole on the one card: past the
  # TPU's 2^31-element buffer bound, which the card does not have
  plan = train_plan(vocab, buffer_elements=None)
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda",
      dtype=torch.bfloat16)
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  check(all(t.dtype == torch.bfloat16 for part in ("fused", "emb_dense")
            for t in state[part].values()), "train_bf16: a table is not bf16")
  table_bytes = sum(t.numel() * t.element_size()
                    for part in ("fused", "emb_dense")
                    for t in state[part].values())
  numerical, cats, labels = _train_batch(torch, vocab, TRAIN_BATCH, SEED)
  key, name, rows = first_sparse_class(plan)
  touched = torch.zeros((rows,), dtype=torch.bool, device="cuda")
  for bk, v in DistributedLookup(plan).route_ids(cats).items():
    if bk.class_key == key:
      v = v.reshape(-1)
      touched[v[(v >= 0) & (v < rows)]] = True
  pick = torch.Generator(device="cuda").manual_seed(SEED + 2)
  hit = torch.nonzero(touched).squeeze(1)
  miss = torch.nonzero(~touched).squeeze(1)
  hit = hit[torch.randperm(hit.numel(), generator=pick,
                           device="cuda")[:ROWS_SAMPLED]]
  miss = miss[torch.randperm(miss.numel(), generator=pick,
                             device="cuda")[:ROWS_SAMPLED]]
  del touched
  buf = state["fused"][name]
  miss_rows = buf[miss].clone()
  step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                rule)
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows_bf16=n_sparse)
  totals = expect()
  ms, losses, changed = [], [], []
  for i in range(TRAIN_WARMUP + TRAIN_TIMED):
    hit_rows = buf[hit].clone()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, numerical, cats, labels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = read_counts()
    check(got == want, f"train_bf16 step {i}: launches {got}, expected "
          f"{want}")
    add_counts(totals, got)
    if i >= TRAIN_WARMUP:
      ms.append((t1 - t0) * 1e3)
    losses.append(float(loss))
    check(np.isfinite(losses[-1]), f"train_bf16 step {i}: loss "
          f"{losses[-1]}")
    check(torch.equal(buf[miss], miss_rows),
          f"train_bf16 step {i}: rows the batch does not touch changed")
    changed.append((buf[hit] != hit_rows).any(dim=1).float().mean().item())
  check(max(changed) > 0.0, "train_bf16: no sampled touched row moved")
  med = statistics.median(ms)
  emit({"phase": "train_bf16", "card": smi, "batch": TRAIN_BATCH,
        "vocab": "Criteo-1TB, full", "rows": int(sum(vocab)),
        "sparse_classes": n_sparse, "table_bytes": table_bytes,
        "f32_table_bytes": 2 * table_bytes, "compute": "f32",
        "init_s": init_s, "step_ms": ms, "step_ms_median": med,
        "samples_per_s": TRAIN_BATCH / (med / 1e3),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": want, "launches": totals, "losses": losses,
        "touched_rows_changed_share": changed,
        "untouched_rows_bit_equal": True})
  del state, buf, step, hit, miss, miss_rows, numerical, cats, labels
  torch.cuda.empty_cache()
  return totals


def phase_train_bf16_vs_f32(torch, smi: str) -> dict:
  """The train cell (x 1/16) from one bf16 state and from an f32 state
  holding the same values: ``NARROW_VS_STEPS`` steps each on the same
  batches, the losses within ``NARROW_LOSS_RTOL`` (``train_bf16_vs_f32``);
  K1's bf16 form on the bf16 state, its f32 form on the other. Then the
  bf16 state saved with ``checkpoint.save`` and restored bit-equal
  (``bf16_ckpt``: bytes, seconds). Returns each kernel's launches on the
  bf16 state."""
  import shutil
  import tempfile

  import numpy as np

  from distributed_embeddings_torch import checkpoint
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  vocab = criteo_vocab()
  plan = train_plan()
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  narrow = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda",
      dtype=torch.bfloat16)
  wide = {"fused": {k: v.float() for k, v in narrow["fused"].items()},
          "emb_dense": {k: v.detach().float()
                        for k, v in narrow["emb_dense"].items()},
          "dense": {k: v.detach().clone() for k, v in narrow["dense"].items()},
          "step": 0}
  batches = [_train_batch(torch, vocab, TRAIN_BATCH, SEED + 70 + i)
             for i in range(NARROW_VS_STEPS)]
  losses, totals = {}, {}
  for tag, state, kernel in (("bf16", narrow, "apply_rows_bf16"),
                             ("f32", wide, "apply_rows")):
    step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                  rule)
    want = expect(interact_fwd=1, interact_bwd=1, **{kernel: n_sparse})
    totals[tag] = expect()
    losses[tag] = []
    for i, batch in enumerate(batches):
      reset_counts()
      state, loss = step(state, *batch)
      got = read_counts()
      check(got == want, f"train_bf16_vs_f32 {tag} step {i}: launches "
            f"{got}, expected {want}")
      add_counts(totals[tag], got)
      losses[tag].append(float(loss))
    check(np.isfinite(losses[tag]).all(), f"train_bf16_vs_f32 {tag}: "
          f"losses {losses[tag]}")
  del wide
  torch.cuda.empty_cache()
  err = np.abs(np.asarray(losses["bf16"]) - np.asarray(losses["f32"]))
  rel = float((err / np.abs(np.asarray(losses["f32"]))).max())
  check(rel <= NARROW_LOSS_RTOL, f"train_bf16_vs_f32: losses differ by "
        f"{rel} relative (> {NARROW_LOSS_RTOL})")
  emit({"phase": "train_bf16_vs_f32", "card": smi, "batch": TRAIN_BATCH,
        "vocab_scale": "1/16", "steps": NARROW_VS_STEPS,
        "losses_bf16": losses["bf16"], "losses_f32": losses["f32"],
        "loss_max_rel_err": rel, "loss_rtol": NARROW_LOSS_RTOL,
        "launches_bf16": totals["bf16"], "launches_f32": totals["f32"]})
  # the bf16 state through a checkpoint
  root = tempfile.mkdtemp(prefix="chip_smoke_bf16_ckpt_")
  path = f"{root}/ckpt"
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  checkpoint.save(path, plan, rule, narrow)
  save_s = time.perf_counter() - t0
  nbytes, nfiles = dir_bytes(path)
  t0 = time.perf_counter()
  back = checkpoint.restore(path, plan, rule, narrow, device="cuda")
  torch.cuda.synchronize()
  restore_s = time.perf_counter() - t0
  manifest = checkpoint.read_manifest(path)
  check({m["dtype"] for m in manifest["fused"].values()} == {"bfloat16"},
        "bf16_ckpt: the manifest's fused dtypes are not bfloat16")
  for part in ("fused", "emb_dense", "dense"):
    for k, v in narrow[part].items():
      check(back[part][k].dtype == v.dtype and torch.equal(
          back[part][k].detach(), v.detach()),
            f"bf16_ckpt: {part}/{k} not restored bit-equal")
  check(back["step"] == narrow["step"], "bf16_ckpt: step not restored")
  emit({"phase": "bf16_ckpt", "card": smi, "vocab_scale": "1/16",
        "bytes": nbytes, "files": nfiles, "save_s": save_s,
        "restore_s": restore_s, "bit_equal": True})
  shutil.rmtree(root)
  del narrow, back, batches
  torch.cuda.empty_cache()
  return totals["bf16"]


def phase_train_bf16_golden(torch) -> None:
  """The committed JAX narrow-storage golden
  (``tests/data/torch_train_bf16_golden.npz``) replayed on the card
  within ``train_golden.compare_bf16``'s bounds."""
  from distributed_embeddings_torch import train_golden
  golden = train_golden.load(train_golden.BF16_PATH)
  losses, got = train_golden.replay_bf16(golden, device="cuda")
  try:
    worst = train_golden.compare_bf16(golden, losses, got)
  except AssertionError as exc:
    raise SmokeFailure(f"bf16 train golden: {exc}") from exc
  emit({"phase": "train_bf16_golden", "losses": losses,
        "want_losses": [float(v) for v in golden["losses"]], **worst,
        "loss_tol": train_golden.LOSS_TOL,
        "bf16_ulps": train_golden.BF16_ULPS,
        "bf16_atol": train_golden.BF16_ATOL,
        "dense_update_tol": train_golden.BF16_DENSE_UPDATE_TOL})


def _input_bounds(torch, plan, state) -> dict:
  """Per input of a sparse table: ``2^-4 * max|table|``, the fp8 serve
  error bound of ``tests/test_serving.py::test_fp8_serve_error_bound`` for
  one-hot ids, from the table's rows in its class buffer (world 1, one
  fused row a physical row)."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_param_name,
  )
  out = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    if cp.kind != "sparse":
      continue
    buf = state["fused"][class_param_name(*key)]
    for slot in cp.slots_per_rank[0]:
      rows = buf[slot.row_offset:slot.row_offset + slot.shard.input_dim,
                 :cp.width]
      out[slot.input_id] = 2.0 ** -4 * rows.abs().max().item()
  return out


def phase_serve_fp8(torch, smi: str, setup: dict) -> dict:
  """fp8 serve images of the serve cell (``serve_fp8``): ``export(...,
  quantize='fp8')``, ``verify``, ``load``, ``SERVE_REQUESTS`` requests of
  ``SERVE_BATCH`` through the artifact's engine (K2-fwd once each),
  bit-equal to the in-memory ``freeze`` engine's; every activation within
  the JAX package's fp8 bound (``2^-4 * max|table|`` a one-hot input) of
  the f32 image's; the image's bytes beside the f32 and int8 images'.
  Returns each kernel's launches in the requests."""
  import shutil
  import tempfile

  import numpy as np

  from distributed_embeddings_torch import checkpoint
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      export,
      freeze,
      load,
      make_serve_step,
      shard_batch,
  )
  from distributed_embeddings_torch.serving.export import serve_class_meta
  from distributed_embeddings_torch.serving.golden import EmbActs

  plan, rule, model = setup["plan"], setup["rule"], setup["model"]
  state, requests = setup["state"], setup["requests"]
  root = tempfile.mkdtemp(prefix="chip_smoke_serve_fp8_")
  path = f"{root}/artifact"
  t0 = time.perf_counter()
  export(path, plan, rule, state, quantize="fp8", extra={"cell": "serve"})
  export_s = time.perf_counter() - t0
  nbytes, nfiles = dir_bytes(path)
  check(checkpoint.verify(path) == [], "serve_fp8: verify found problems")
  t0 = time.perf_counter()
  art = load(path, plan, device="cuda")
  torch.cuda.synchronize()
  load_s = time.perf_counter() - t0
  image_bytes = {q: sum(m.packed.phys_rows * m.packed.phys_width *
                        (4 if q == "f32" else 1)
                        for m in serve_class_meta(plan, rule, q)[0].values())
                 for q in ("f32", "int8", "fp8")}
  got_bytes = sum(t.numel() * t.element_size()
                  for t in art.state["serve"].values())
  check(got_bytes == image_bytes["fp8"], f"serve_fp8: {got_bytes} image "
        f"bytes, the layout says {image_bytes['fp8']}")
  eng = ServeEngine(model, plan, art, device="cuda")
  reset_counts()
  preds, ms = [], []
  for numerical, cats in requests:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds.append(eng.predict(numerical, cats))
    ms.append((time.perf_counter() - t0) * 1e3)
  got = read_counts()
  want = expect(interact_fwd=SERVE_REQUESTS)
  check(got == want, f"serve_fp8: launches {got}, expected {want}")
  frozen = ServeEngine(model, plan, freeze(plan, rule, state, "fp8"),
                       device="cuda")
  wide = ServeEngine(model, plan, freeze(plan, rule, state, "f32"),
                     device="cuda")
  bounds = _input_bounds(torch, plan, state)
  acts8 = make_serve_step(EmbActs(), plan, eng.meta)
  acts32 = make_serve_step(EmbActs(), plan, wide.meta)
  worst = 0.0
  for i, (numerical, cats) in enumerate(requests):
    p = preds[i]
    check(p.shape == (SERVE_BATCH,) and np.isfinite(p).all(),
          "serve_fp8: predictions not finite")
    check(np.array_equal(frozen.predict(numerical, cats).view(np.int32),
                         p.view(np.int32)),
          f"serve_fp8 request {i}: the artifact engine differs from the "
          "FrozenTables engine")
    num_d, cats_d = shard_batch((numerical, tuple(cats)), None, "cuda")
    with torch.inference_mode():
      a8 = acts8(eng.state, num_d, cats_d).float()
      a32 = acts32(wide.state, num_d, cats_d).float()
    for f in range(a8.shape[0]):
      err = (a8[f] - a32[f]).abs().max().item()
      lim = bounds.get(f, 0.0) + 1e-6
      check(err <= lim, f"serve_fp8 request {i} input {f}: off the f32 "
            f"image by {err} > {lim}")
      if f in bounds:
        worst = max(worst, err / lim)
  emit({"phase": "serve_fp8", "card": smi, "batch": SERVE_BATCH,
        "requests": SERVE_REQUESTS, "request_ms": ms,
        "p50_ms": statistics.median(ms), "image_bytes": image_bytes,
        "artifact_bytes": nbytes, "files": nfiles, "export_s": export_s,
        "load_s": load_s, "bit_equal_frozen": True,
        "acts_max_share_of_fp8_bound": worst, "launches": got})
  shutil.rmtree(root)
  del art, eng, frozen, wide
  torch.cuda.empty_cache()
  return got


def _w4_narrow(torch, mesh, backend: str, outdir: str) -> dict:
  """Narrow storage at world 4 on every rank (``world4_bf16``): the
  world-4 plan x 1/16 (both backends) in bf16, SGD from one state under
  ``'none'``, ``'pipelined'`` and ``'fused'`` (``W4_NARROW_STEPS`` steps
  each; K4's bf16 form ``k4_launches_per_step`` times a fused step, K1's
  bf16 form once per class), the first step's losses bit-equal and its
  buffers bit-equal to ``'none'``'s on rows fewer than two ids hit (within
  ``hits * BF16_DUP_ULP`` of the cell's magnitude on the others, where
  K1's atomics order the adds); one Adagrad step under ``'fused'``; then the
  SGD state's fp8 images served in lockstep (export, load, requests),
  equal on every rank and bit-equal to the in-memory ``freeze``
  engine's."""
  import os
  import shutil

  import numpy as np

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import (
      adagrad_rule,
      sgd_rule,
  )
  from distributed_embeddings_torch.parallel.wire import gather_blocks
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      export,
      freeze,
      load,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  dev = mesh.device
  out = {"runs": {}}
  model = DLRM(world4_plan("gloo")[0], D, tables=False, device=dev,
               generator=torch.Generator().manual_seed(SEED))

  def fresh(overlap, rule):
    vocab, plan = world4_plan("gloo", overlap)  # x 1/16 on both backends
    state = init_sparse_state_direct(
        plan, rule, model.state_dict(), sgd_factory(torch),
        torch.Generator(device=dev).manual_seed(SEED + 1 + mesh.rank),
        mesh=mesh, dtype=torch.bfloat16)
    return vocab, plan, state

  rule = sgd_rule(TRAIN_LR)
  batch = w4_batch(torch, world4_plan("gloo")[0], mesh)
  base = None
  for overlap in ("none", "pipelined", "fused"):
    vocab, plan, state = fresh(overlap, rule)
    touch = _w4_touch_counts(torch, plan, mesh, batch[1], state)
    step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                  rule, mesh=mesh)
    k4 = k4_launches_per_step(plan) if overlap == "fused" else 0
    want = expect(gather_rows_bf16=k4, apply_rows_bf16=len(state["fused"]),
                  interact_fwd=1, interact_bwd=1)
    totals = expect()
    ms, losses = [], []
    for i in range(W4_NARROW_STEPS):
      reset_counts()
      torch.cuda.synchronize(dev)
      t0 = time.perf_counter()
      state, loss = step(state, *batch)
      torch.cuda.synchronize(dev)
      ms.append((time.perf_counter() - t0) * 1e3)
      got = read_counts()
      check(got == want, f"world4_bf16 {overlap} rank {mesh.rank} step {i}: "
            f"launches {got}, expected {want}")
      add_counts(totals, got)
      losses.append(float(loss))
      check(np.isfinite(losses[-1]), f"world4_bf16 {overlap}: loss "
            f"{losses[-1]}")
      if i == 0:
        first = {k: v.clone() for k, v in state["fused"].items()}
    if base is None:
      base = (losses[0], first)
    else:
      check(losses[0] == base[0], f"world4_bf16: {overlap}'s first loss "
            f"{losses[0]} != none's {base[0]}")
      for name, buf in first.items():
        other = base[1][name]
        bad = (buf != other).any(dim=1)
        check(not bool((bad & (touch[name] < 2)).any().item()),
              f"world4_bf16 {overlap} {name}: a row fewer than two ids hit "
              "differs from none's")
        if bool(bad.any().item()):
          a, b = buf[bad].float(), other[bad].float()
          lim = touch[name][bad][:, None].float() * BF16_DUP_ULP * \
              torch.maximum(a.abs(), b.abs()) + 2.0 ** -24
          check(bool(((a - b).abs() <= lim).all().item()),
                f"world4_bf16 {overlap} {name}: duplicate rows off "
                "none's beyond hits * 3 * 2^-8")
    out["runs"][overlap] = {"step_ms": ms, "losses": losses,
                            "launches": totals, "launches_per_step": want}
    del first, touch, step
    if overlap != "fused":
      del state
      torch.cuda.empty_cache()
  # one Adagrad step under the fused schedule
  ada = adagrad_rule(0.01)
  vocab, plan, astate = fresh("fused", ada)
  step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                ada, mesh=mesh)
  reset_counts()
  astate, loss = step(astate, *batch)
  got = read_counts()
  want = expect(gather_rows_bf16=k4_launches_per_step(plan, ada),
                apply_rows_bf16=len(astate["fused"]), interact_fwd=1,
                interact_bwd=1)
  check(got == want, f"world4_bf16 adagrad rank {mesh.rank}: launches {got}, "
        f"expected {want}")
  check(np.isfinite(float(loss)), "world4_bf16 adagrad: loss not finite")
  out["adagrad"] = {"loss": float(loss), "launches": got}
  del astate, step
  torch.cuda.empty_cache()
  # slice 20: the dedup exchange, the Adam rule and a ragged bucket
  out["rules"] = _w4_narrow_rules(torch, mesh, model, batch)
  # the SGD state's fp8 images, served in lockstep
  rng = np.random.default_rng(SEED + 5)
  requests = [(rng.standard_normal((SERVE_BATCH, 13)).astype(np.float32),
               [rng.integers(0, v, SERVE_BATCH).astype(np.int32)
                for v in vocab]) for _ in range(SERVE_REQUESTS)]
  path = os.path.join(outdir, "serve_fp8")
  export(path, plan, rule, state, quantize="fp8", mesh=mesh)
  eng = ServeEngine(model, plan, load(path, plan, mesh=mesh), mesh=mesh)
  frozen = ServeEngine(model, plan, freeze(plan, rule, state, "fp8",
                                           mesh=mesh), mesh=mesh)
  reset_counts()
  preds, ms = [], []
  for numerical, cats in requests:
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    preds.append(eng.predict(numerical, cats))
    ms.append((time.perf_counter() - t0) * 1e3)
  serve_launches = read_counts()
  want = expect(interact_fwd=SERVE_REQUESTS)
  check(serve_launches == want, f"world4 fp8 serve rank {mesh.rank}: "
        f"launches {serve_launches}, expected {want}")
  for i, ((numerical, cats), p) in enumerate(zip(requests, preds)):
    check(p.shape == (SERVE_BATCH,) and np.isfinite(p).all(),
          "world4 fp8 serve: predictions not finite")
    every = gather_blocks(torch.from_numpy(p).to(dev), mesh).cpu().numpy()
    check(all(np.array_equal(every[r * SERVE_BATCH:(r + 1) * SERVE_BATCH]
                             .view(np.int32), p.view(np.int32))
              for r in range(WORLD)),
          f"world4 fp8 serve request {i}: the ranks' predictions differ")
    check(np.array_equal(frozen.predict(numerical, cats).view(np.int32),
                         p.view(np.int32)),
          f"world4 fp8 serve request {i}: the artifact engine differs from "
          "the FrozenTables engine")
  torch.distributed.barrier()
  if mesh.rank == 0:
    shutil.rmtree(path)
  out["serve_fp8"] = {"request_ms": ms, "launches": serve_launches,
                      "serve_bytes": sum(
                          t.numel() * t.element_size()
                          for t in eng.state["serve"].values())}
  del state, eng, frozen, batch
  torch.cuda.empty_cache()
  return out


def emit_narrow_world4(backend: str, smi: str, narrow: list) -> dict:
  """The ``world4_bf16`` and ``serve_world4_fp8`` lines from the ranks'
  :func:`_w4_narrow` results; returns each kernel's launches summed over
  the ranks and runs (the fp8 requests' too)."""
  totals = expect()
  for r in narrow:
    for run in r["runs"].values():
      add_counts(totals, run["launches"])
    add_counts(totals, r["adagrad"]["launches"])
    add_counts(totals, r["serve_fp8"]["launches"])
    for run in r["rules"]["runs"].values():
      add_counts(totals, run["launches"])
    add_counts(totals, r["rules"]["adam"]["launches"])
    add_counts(totals, r["rules"]["ragged"]["launches"])
  emit({"phase": "world4_bf16", "backend": backend, "card": smi,
        "vocab_scale": "1/16", "global_batch": W4_BATCH,
        "steps": W4_NARROW_STEPS,
        "step_ms_by_schedule": {o: [r["runs"][o]["step_ms"] for r in narrow]
                                for o in narrow[0]["runs"]},
        "losses_by_schedule": {o: narrow[0]["runs"][o]["losses"]
                               for o in narrow[0]["runs"]},
        "launches_per_step_per_rank": {
            o: narrow[0]["runs"][o]["launches_per_step"]
            for o in narrow[0]["runs"]},
        "first_step_fused_vs_none": "bit-equal off duplicate rows",
        "adagrad_loss": narrow[0]["adagrad"]["loss"],
        "adagrad_launches_per_rank": narrow[0]["adagrad"]["launches"],
        "wall_s_by_rank": [r["wall_s"] for r in narrow]})
  rules = narrow[0]["rules"]
  for r in narrow[1:]:
    check(all(r["rules"]["runs"][o]["losses"] == run["losses"]
              for o, run in rules["runs"].items())
          and r["rules"]["adam"]["loss"] == rules["adam"]["loss"]
          and r["rules"]["ragged"]["loss"] == rules["ragged"]["loss"],
          "world4_bf16_rules: the ranks' losses differ")
  emit({"phase": "world4_bf16_rules", "backend": backend, "card": smi,
        "vocab_scale": "1/16", "global_batch": W4_BATCH,
        "dedup_steps": W4_RULES_STEPS,
        "dedup_losses_by_schedule": {o: run["losses"] for o, run in
                                     rules["runs"].items()},
        "dedup_step_ms_by_schedule": {
            o: [r["rules"]["runs"][o]["step_ms"] for r in narrow]
            for o in rules["runs"]},
        "adam_step_ms_by_rank": [r["rules"]["adam"]["step_ms"]
                                 for r in narrow],
        "ragged_step_ms_by_rank": [r["rules"]["ragged"]["step_ms"]
                                   for r in narrow],
        "dedup_launches_per_step_per_rank": {
            o: run["launches_per_step"] for o, run in rules["runs"].items()},
        "dedup_first_step_vs_none": "bit-equal off duplicate rows",
        "adam_loss": rules["adam"]["loss"],
        "adam_launches_per_rank": rules["adam"]["launches"],
        "ragged_loss": rules["ragged"]["loss"],
        "ragged_launches_per_rank": rules["ragged"]["launches"],
        "ranks_agree": True})
  emit({"phase": "serve_world4_fp8", "backend": backend, "card": smi,
        "vocab_scale": "1/16", "global_batch": SERVE_BATCH,
        "requests": SERVE_REQUESTS,
        "request_ms_by_rank": [r["serve_fp8"]["request_ms"] for r in narrow],
        "serve_bytes_per_rank": [r["serve_fp8"]["serve_bytes"]
                                 for r in narrow],
        "ranks_equal": True, "bit_equal_frozen": True,
        "launches_per_rank": narrow[0]["serve_fp8"]["launches"]})
  return totals


# ---------------------------------------------------------------------------
# tiered storage (slice 18)
# ---------------------------------------------------------------------------


def host_ram() -> dict:
  """``MemTotal`` and ``MemAvailable`` of ``/proc/meminfo``, in bytes."""
  out = {}
  with open("/proc/meminfo") as f:
    for line in f:
      key, rest = line.split(":", 1)
      if key in ("MemTotal", "MemAvailable"):
        out[key] = int(rest.split()[0]) * 1024
  return out


def host_ram_at_least(nbytes: float, timeout_s: float = 60.0) -> dict:
  """:func:`host_ram` once ``MemAvailable`` reaches ``nbytes``, or after
  ``timeout_s``: the chip machine hands freed pages back to
  ``MemAvailable`` seconds after a process frees them, so a reading right
  after a release undercounts."""
  t0 = time.perf_counter()
  while True:
    ram = host_ram()
    if ram["MemAvailable"] >= nbytes or time.perf_counter() - t0 > timeout_s:
      return ram
    time.sleep(0.5)


def tiered_cut(image_bytes: int, available: int) -> int:
  """The smallest power of two that cuts every table so that the host
  images fit ``available`` bytes ``TIERED_RAM_SLACK`` times over."""
  cut = 1
  while TIERED_RAM_SLACK * image_bytes / cut > available:
    cut *= 2
  return cut


def tiered_plan(vocab, cut: int = 1, **plan_kw):
  """The train plan over ``vocab`` with the tables above
  ``TIERED_HOST_ROWS / cut`` host-tier, the TPU's per-buffer bound lifted
  (the five largest tables stay whole)."""
  return train_plan(vocab, buffer_elements=None,
                    host_row_threshold=TIERED_HOST_ROWS // cut, **plan_kw)


def tiered_batches(vocab, n: int, b: int, seed: int) -> list:
  """``n`` global host batches (numpy) of ``b`` samples: one-hot
  power-law ids at ``TIERED_ALPHA`` (``models/synthetic.py:
  power_law_ids``, id 0 the hottest), normal features, random labels."""
  import numpy as np

  from distributed_embeddings_torch.models.synthetic import power_law_ids
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n):
    cats = [power_law_ids(rng, b, 1, v, TIERED_ALPHA)[:, 0].astype(np.int32)
            for v in vocab]
    out.append((rng.standard_normal((b, 13)).astype(np.float32), cats,
                rng.integers(0, 2, b).astype(np.float32)))
  return out


def tiered_spans(events, steps: int, t_end_ns: int) -> dict:
  """Per-step wall times and host spans of a traced ``TieredTrainer.run``
  (``telemetry`` span events): a step runs from its ``tiered/stage``
  start to the next one's (the last to ``t_end_ns``); the host spans
  (classify, stage, dispatch, write-back, re-rank) are summed per name,
  the device windows (``device/step``: dispatch to the write-back's
  download) listed."""
  starts = sorted(t0 for ph, _, name, t0, _, _ in events
                  if ph == "X" and name == "tiered/stage")
  check(len(starts) == steps, f"tiered trace: {len(starts)} stage spans "
        f"for {steps} steps")
  step_ms = [(b - a) / 1e6 for a, b in zip(starts, starts[1:] + [t_end_ns])]
  host = {}
  for ph, _, name, _, dur, _ in events:
    if ph == "X" and name.startswith("tiered/"):
      host.setdefault(name, []).append(dur / 1e6)
  device = [dur / 1e6 for ph, _, name, _, dur, _ in events
            if ph == "X" and name == "device/step"]
  return {"step_ms": step_ms,
          "host_ms": {k: {"total": sum(v), "calls": len(v),
                          "max": max(v)} for k, v in sorted(host.items())},
          "device_window_ms": device}


def phase_train_tiered(torch, smi: str) -> dict:
  """``train_tiered``: ``bench.py``'s sparse step (26 Criteo-1TB tables of
  width 128, ``dense_row_threshold=4096``, SGD 0.1, f32, B = 65,536) with
  the five tables above ``TIERED_HOST_ROWS`` host-tier: their f32 images
  (94.06 GB at the full vocabulary, drawn on the card chunk by chunk and
  downloaded) in host RAM, a hot cache sized to a ``TIERED_BUDGET`` device
  budget and ``TIERED_STAGING`` staging rows on the card, a re-rank every
  ``TIERED_RERANK`` steps. Every table is cut by the smallest power of two
  whose images fit the host's ``MemAvailable`` ``TIERED_RAM_SLACK`` times
  over (1 when they fit whole). ``TIERED_WARMUP`` steps, then
  ``TIERED_TIMED`` traced ones through ``TieredTrainer.run``: K2 once each
  way and K1 once per sparse class a step, finite losses, no lookup
  missing both tiers. Returns each kernel's launches and the trained
  pieces (plan, rule, state, store, model) for ``serve_tiered``."""
  import gc

  import numpy as np

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.telemetry import tracing
  from distributed_embeddings_torch.tiering import (
      HostTierStore,
      TieredTrainer,
      TieringConfig,
      TieringPlan,
      init_tiered_state,
  )

  rule = sgd_rule(TRAIN_LR)
  cfg = TieringConfig(hbm_budget_bytes=TIERED_BUDGET,
                      staging_grps=TIERED_STAGING,
                      rerank_interval=TIERED_RERANK)
  ram = host_ram()
  full = list(CRITEO_1TB_VOCAB)
  full_bytes = TieringPlan(tiered_plan(full), rule,
                           cfg).host_bytes_per_rank()
  cut = tiered_cut(full_bytes, ram["MemAvailable"])
  vocab = [max(4, v // cut) for v in full]
  plan = tiered_plan(vocab, cut)
  tplan = TieringPlan(plan, rule, cfg)
  host_tables = sorted(sh.table_id for key in plan.host_tier_class_keys()
                       for sh in plan.classes[key].shards_per_rank[0])
  check(len(host_tables) == 5, f"train_tiered: host-tier tables "
        f"{host_tables}, expected the five above {TIERED_HOST_ROWS} rows")
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  table_bytes = sum(vocab) * D * 4
  card_bytes = torch.cuda.get_device_properties(0).total_memory
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  store = HostTierStore(tplan)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_tiered_state(
      tplan, store, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), image_seed=SEED,
      image_device="cuda", device="cuda")
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  trainer = TieredTrainer(model, tplan, store, bce_loss, sgd_factory(torch),
                          rule, None, state, device="cuda")
  batches = tiered_batches(vocab, TIERED_WARMUP + TIERED_TIMED, TRAIN_BATCH,
                           SEED + 11)
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows=n_sparse)
  reset_counts()
  losses = trainer.run(batches[:TIERED_WARMUP])
  check(read_counts() == {k: v * TIERED_WARMUP for k, v in want.items()},
        f"train_tiered warm-up: launches {read_counts()}, expected {want} "
        "a step")
  reset_counts()
  torch.cuda.synchronize()
  with tracing() as tr:
    t0 = time.perf_counter()
    losses += trainer.run(batches[TIERED_WARMUP:])
    torch.cuda.synchronize()
    t_end = time.perf_counter_ns()
    wall_s = time.perf_counter() - t0
  got = read_counts()
  check(got == {k: v * TIERED_TIMED for k, v in want.items()},
        f"train_tiered: launches {got} in {TIERED_TIMED} steps, expected "
        f"{want} a step")
  check(all(np.isfinite(losses)), f"train_tiered: losses {losses}")
  spans = tiered_spans(tr.events(), TIERED_TIMED, t_end)
  summary = trainer.metrics_summary()
  check(all(m["missed"] == 0 for m in summary["per_class"].values()),
        f"train_tiered: lookups missed both tiers: {summary}")
  med = statistics.median(spans["step_ms"])
  steps = TIERED_WARMUP + TIERED_TIMED
  emit({"phase": "train_tiered", "card": smi, "batch": TRAIN_BATCH,
        "host_ram": ram, "vocab_cut": cut,
        "cut_reason": (None if cut == 1 else
                       f"{TIERED_RAM_SLACK} x the full vocabulary's "
                       f"{full_bytes} image bytes exceed MemAvailable"),
        "rows": int(sum(vocab)), "host_tier_tables": host_tables,
        "host_tier_rows": int(sum(vocab[t] for t in host_tables)),
        "tables_f32_bytes": table_bytes, "card_bytes": card_bytes,
        "tables_exceed_card": table_bytes > card_bytes,
        "host_image_bytes": tplan.host_bytes_per_rank(),
        "device_tier_bytes": plan.tier_capacity_report(0)[
            "device_bytes_per_rank"],
        "tiered_device_bytes": tplan.device_bytes_per_rank(),
        "geometry": tplan.geometry(), "sparse_classes": n_sparse,
        "init_s": init_s, "step_ms": spans["step_ms"],
        "step_ms_median": med, "step_ms_range": [min(spans["step_ms"]),
                                                 max(spans["step_ms"])],
        "wall_s": wall_s, "samples_per_s": TRAIN_BATCH / (med / 1e3),
        "host_ms": spans["host_ms"],
        "device_window_ms": spans["device_window_ms"],
        "hit_rate": summary["hit_rate"], "per_class": summary["per_class"],
        "host_gather_bytes_per_step": summary["host_gather_bytes"] / steps,
        "spill_steps": summary["spill_steps"], "steps": steps,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": want, "launches": got, "losses": losses})
  totals = {k: v * (TIERED_WARMUP + TIERED_TIMED) for k, v in want.items()}
  # the trainer goes on to train_tiered_overlap, its state and store to
  # serve_tiered
  trained = {"vocab": vocab, "plan": plan, "rule": rule, "store": store,
             "state": trainer.state, "model": model, "cut": cut,
             "full_vocab_image_bytes": full_bytes, "host_ram": ram,
             "trainer": trainer, "step_ms_median": med,
             "launches_per_step": want}
  del state, batches
  gc.collect()
  torch.cuda.empty_cache()
  return totals, trained


def overlap_spans(events, steps: int, t_end_ns: int) -> dict:
  """Per-step wall times and spans of a traced overlapped
  ``TieredTrainer.run``: a step runs from its ``tiered/dispatch`` start
  to the next one's (the last to ``t_end_ns``); the host spans summed per
  name; and how much of the worker's ``tiered/host_prepare`` time fell
  inside the device windows (``device/step``, dispatch to the
  write-back's download)."""
  starts = sorted(t0 for ph, _, name, t0, _, _ in events
                  if ph == "X" and name == "tiered/dispatch")
  check(len(starts) == steps, f"tiered overlap trace: {len(starts)} "
        f"dispatch spans for {steps} steps")
  step_ms = [(b - a) / 1e6 for a, b in zip(starts, starts[1:] + [t_end_ns])]
  host, device, jobs = {}, [], []
  for ph, _, name, t0, dur, _ in events:
    if ph != "X":
      continue
    if name.startswith(("tiered/", "pipeline/")):
      host.setdefault(name, []).append(dur / 1e6)
    if name == "device/step":
      device.append((t0, t0 + dur))
    if name == "tiered/host_prepare":
      jobs.append((t0, t0 + dur))
  inside = sum(max(0, min(b, d) - max(a, c)) for a, b in jobs
               for c, d in device)
  job_ns = sum(b - a for a, b in jobs)
  return {"step_ms": step_ms,
          "host_ms": {k: {"total": sum(v), "calls": len(v),
                          "max": max(v)} for k, v in sorted(host.items())},
          "device_window_ms": [(d - c) / 1e6 for c, d in device],
          "worker_ms_inside_device_windows": inside / 1e6,
          "worker_inside_share": inside / job_ns if job_ns else 0.0}


def sync_sites(torch, fn) -> dict:
  """Run ``fn`` with PyTorch's synchronizing-operation warnings on
  (``torch.cuda.set_sync_debug_mode("warn")``) and count each warning by
  its thread and the innermost frame of the port's package (else of
  this script) that made it: where the host waited for the card."""
  import collections
  import threading
  import traceback
  import warnings

  sites = collections.Counter()
  show = warnings.showwarning

  def record(message, category, filename, lineno, file=None, line=None):
    if "synchroniz" not in str(message):
      return show(message, category, filename, lineno, file, line)
    stack = traceback.extract_stack()
    where = next((f for f in reversed(stack)
                  if "distributed_embeddings_torch" in f.filename), None)
    where = where or next((f for f in reversed(stack)
                           if f.filename.endswith("chip_smoke.py")), stack[-1])
    name = where.filename.rsplit("distributed_embeddings_torch/", 1)[-1]
    sites[f"{threading.current_thread().name}: {name}:{where.lineno} "
          f"{where.name}"] += 1

  warnings.showwarning = record
  try:
    with warnings.catch_warnings():
      warnings.simplefilter("always")
      warnings.showwarning = record
      torch.cuda.set_sync_debug_mode("warn")
      try:
        fn()
      finally:
        torch.cuda.set_sync_debug_mode("default")
  finally:
    warnings.showwarning = show
  return dict(sites)


def phase_train_tiered_overlap(torch, smi: str, trained: dict) -> dict:
  """``train_tiered_overlap``: ``train_tiered``'s trainer, store and cell,
  ``TIERED_TIMED`` traced steps more with ``overlap_host=True`` (the next
  batch's classify and cold gather on the pipeline's worker thread while
  the card runs the step): K2 once each way and K1 once per sparse class
  a step, finite losses, no lookup missing both tiers. Reports the step
  time beside ``train_tiered``'s, the hidden host seconds
  (``tiered/overlap_hidden_s``), the main thread's waits for the worker
  (``tiered/overlap_wait``), the conflict rows re-gathered and the share
  of the worker's time that fell inside the device windows. Returns the
  launches."""
  import numpy as np

  from distributed_embeddings_torch.telemetry import tracing

  trainer = trained["trainer"]
  reg = trainer.telemetry
  trainer.overlap_host = True
  batches = tiered_batches(trained["vocab"], TIERED_TIMED, TRAIN_BATCH,
                           SEED + 12)
  want = trained["launches_per_step"]
  regathered0 = reg.counter("tiered/conflict_rows_regathered").value
  hidden0 = reg.histogram("tiered/overlap_hidden_s").count
  reset_counts()
  torch.cuda.synchronize()
  with tracing() as tr:
    t0 = time.perf_counter()
    losses = trainer.run(batches)
    torch.cuda.synchronize()
    t_end = time.perf_counter_ns()
    wall_s = time.perf_counter() - t0
  got = read_counts()
  check(got == {k: v * TIERED_TIMED for k, v in want.items()},
        f"train_tiered_overlap: launches {got} in {TIERED_TIMED} steps, "
        f"expected {want} a step")
  check(all(np.isfinite(losses)), f"train_tiered_overlap: losses {losses}")
  summary = trainer.metrics_summary()
  check(all(m["missed"] == 0 for m in summary["per_class"].values()),
        f"train_tiered_overlap: lookups missed both tiers: {summary}")
  spans = overlap_spans(tr.events(), TIERED_TIMED, t_end)
  hidden = reg.histogram("tiered/overlap_hidden_s")
  wait = reg.histogram("tiered/overlap_wait")
  check(hidden.count > hidden0, "train_tiered_overlap: no worker job ran")
  # two more steps (untimed, not counted) with the host's waits for the
  # card located: the worker thread must make none
  syncs = sync_sites(torch, lambda: trainer.run(tiered_batches(
      trained["vocab"], 2, TRAIN_BATCH, SEED + 14)))
  check(not any(k.startswith("tiered-overlap") for k in syncs),
        f"train_tiered_overlap: the worker thread waited for the card: "
        f"{syncs}")
  med = statistics.median(spans["step_ms"])
  emit({"phase": "train_tiered_overlap", "card": smi, "batch": TRAIN_BATCH,
        "vocab_cut": trained["cut"], "step_ms": spans["step_ms"],
        "step_ms_median": med,
        "step_ms_range": [min(spans["step_ms"]), max(spans["step_ms"])],
        "train_tiered_step_ms_median": trained["step_ms_median"],
        "wall_s": wall_s, "samples_per_s": TRAIN_BATCH / (med / 1e3),
        "overlap_hidden_s": {"count": hidden.count - hidden0,
                             "mean": hidden.mean, "max": hidden.max},
        "overlap_wait_s": {"count": wait.count, "mean": wait.mean,
                           "max": wait.max},
        "conflict_rows_regathered": reg.counter(
            "tiered/conflict_rows_regathered").value - regathered0,
        "host_ms": spans["host_ms"],
        "device_window_ms": spans["device_window_ms"],
        "worker_ms_inside_device_windows":
            spans["worker_ms_inside_device_windows"],
        "worker_inside_share": spans["worker_inside_share"],
        "hit_rate": summary["hit_rate"], "launches_per_step": want,
        "sync_sites_two_steps": syncs,
        "launches": got, "losses": losses})
  trainer.overlap_host = False
  return got


def overlap_vs_serial_runs(torch, tplan, model, rule, batches, want,
                           totals, form: str) -> dict:
  """One form of ``tiered_overlap_vs_serial``: a state drawn on the card
  (its images on the host) and two copies of it (and of its store) take
  ``batches`` through the serial ``TieredTrainer.run`` (``serial``), the
  serial run again (``serial_again``) and the overlapped one
  (``overlap``), guarded; each run's launches are checked against
  ``want`` a step and added to ``totals``. Returns the runs by tag."""
  from distributed_embeddings_torch.models import bce_loss
  from distributed_embeddings_torch.telemetry import MetricsRegistry
  from distributed_embeddings_torch.tiering import (
      HostTierStore,
      TieredTrainer,
      init_tiered_state,
  )

  store = HostTierStore(tplan)
  state = init_tiered_state(
      tplan, store, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED + 21),
      image_seed=SEED + 21, image_device="cuda", device="cuda")
  twins = []
  for _ in range(2):
    twin_store = HostTierStore(tplan)
    for name in tplan.tier_specs:
      twin_store.set_image(name, 0, store.images[name][0])
    twins.append((twin_state(state), twin_store))
  deterministic = torch.are_deterministic_algorithms_enabled()
  torch.use_deterministic_algorithms(True, warn_only=True)
  runs = {}
  try:
    for tag, (st, sto) in zip(("serial", "serial_again", "overlap"),
                              [(state, store)] + twins):
      trainer = TieredTrainer(model, tplan, sto, bce_loss,
                              sgd_factory(torch), rule, None, st, guard=True,
                              overlap_host=tag == "overlap", device="cuda",
                              telemetry=MetricsRegistry())
      reset_counts()
      t0 = time.perf_counter()
      losses = trainer.run(batches)
      torch.cuda.synchronize()
      wall_s = time.perf_counter() - t0
      got = read_counts()
      # the guard's skipped step launches the same kernels and commits
      # nothing
      check(got == {k: v * len(batches) for k, v in want.items()},
            f"tiered_overlap_vs_serial {form} {tag}: launches {got}, "
            f"expected {want} a step")
      add_counts(totals, got)
      trainer.flush()
      runs[tag] = {"trainer": trainer, "losses": losses, "wall_s": wall_s}
  finally:
    torch.use_deterministic_algorithms(deterministic)
  return runs


def run_arrays_differ(torch, tplan, a, b) -> dict:
  """Every array two tiered trainers hold, by name (fused buffers, host
  images, resident sets, observed counts, hit counters): for each that
  differs, the cells that differ and the largest |b - a| (by row
  chunks; the integer arrays in int64)."""
  import numpy as np

  pairs = [(f"fused/{k}", a.state["fused"][k], b.state["fused"][k])
           for k in a.state["fused"]]
  pairs += [(f"{part}/{n}", torch.from_numpy(np.asarray(getattr(
      a.store, part)[n][0])), torch.from_numpy(np.asarray(getattr(
          b.store, part)[n][0])))
            for part in ("images", "resident_grps", "counts")
            for n in tplan.tier_specs]
  pairs += [(f"hits/{n}", torch.from_numpy(a.hits[n]),
             torch.from_numpy(b.hits[n])) for n in a.hits]
  out = {}
  for k, x, y in pairs:
    if torch.equal(x, y):
      continue
    cells, worst = 0, 0.0
    for r0 in range(0, x.shape[0], 1 << 16):
      xs, ys = x[r0:r0 + (1 << 16)], y[r0:r0 + (1 << 16)]
      if torch.equal(xs, ys):
        continue
      d = ys - xs if xs.is_floating_point() else ys.long() - xs.long()
      cells += int(torch.count_nonzero(d))
      worst = max(worst, float(d.abs_().max()))
    out[k] = {"cells": cells, "max_abs_err": worst}
  return out


def phase_tiered_overlap_vs_serial(torch, smi: str) -> dict:
  """``tiered_overlap_vs_serial``: the train_tiered cell at 1/
  ``TIERED_VS_SCALE`` (images drawn on the card), a cache of half of each
  host-tier class, a re-rank every ``TIERED_OVERLAP_VS_RERANK`` steps,
  guarded, in two forms of ``TIERED_OVERLAP_VS_STEPS`` batches (a NaN
  batch the guard skips, one batch repeating the one before it), each
  from its own drawn state through :func:`overlap_vs_serial_runs`.

  ``distinct``: ``TIERED_OVERLAP_VS_BATCH`` samples whose ids in a sparse
  table's batch column are distinct, so no row of a sparse class takes
  two occurrences in a step (K1 adds a row's duplicates in an order that
  varies, and the order of three f32 adds or more changes their sum) and
  PyTorch's scatters run deterministically: the overlapped run's losses,
  fused buffers, reconciled host images, resident sets, observed counts
  and hit counters are bit-equal to the serial run's, as the second
  serial run's are; conflict rows are re-gathered.

  ``power_law``: the cell's own traffic, ``TRAIN_BATCH`` power-law ids at
  ``TIERED_ALPHA``, where hot rows repeat and K1's order shows: for every
  buffer, image, resident set, count and hit counter, max |overlap -
  serial| <= 2 max |serial_again - serial| (``train_tiered_vs_device``'s
  rule: the counts, sets and hits, which K1 does not touch, so stay
  bit-equal), and the losses within rtol 1e-5 / atol 1e-6. Returns the
  launches."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.tiering import TieringConfig, TieringPlan

  vocab = [max(4, v // TIERED_VS_SCALE) for v in CRITEO_1TB_VOCAB]
  plan = tiered_plan(vocab, TIERED_VS_SCALE)
  rule = sgd_rule(TRAIN_LR)
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  tplan = TieringPlan(plan, rule, TieringConfig(
      cache_fraction=0.5, staging_grps=1024,
      rerank_interval=TIERED_OVERLAP_VS_RERANK))
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rng = np.random.default_rng(SEED + 19)
  b = TIERED_OVERLAP_VS_BATCH
  # distinct ids within each sparse table's batch column (the dense
  # classes' tables are smaller than the batch)
  forms = {"distinct": [
      (rng.standard_normal((b, 13)).astype(np.float32),
       [rng.choice(v, b, replace=v < b).astype(np.int32) for v in vocab],
       rng.integers(0, 2, b).astype(np.float32))
      for _ in range(TIERED_OVERLAP_VS_STEPS)],
      "power_law": tiered_batches(vocab, TIERED_OVERLAP_VS_STEPS,
                                  TRAIN_BATCH, SEED + 23)}
  for batches in forms.values():
    numerical = batches[TIERED_OVERLAP_VS_NAN][0].copy()
    numerical[0, 0] = np.nan
    batches[TIERED_OVERLAP_VS_NAN] = (numerical,) + batches[
        TIERED_OVERLAP_VS_NAN][1:]
    batches[4] = batches[3]
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows=n_sparse)
  totals = expect()
  line = {"phase": "tiered_overlap_vs_serial", "card": smi,
          "vocab_scale": f"1/{TIERED_VS_SCALE}",
          "steps": TIERED_OVERLAP_VS_STEPS,
          "nan_batch": TIERED_OVERLAP_VS_NAN,
          "rerank_interval": TIERED_OVERLAP_VS_RERANK,
          "geometry": tplan.geometry(), "launches_per_step": want}
  for form, batches in forms.items():
    t0 = time.perf_counter()
    runs = overlap_vs_serial_runs(torch, tplan, model, rule, batches, want,
                                  totals, form)
    t1 = time.perf_counter()
    a = runs["serial"]["trainer"]
    la = runs["serial"]["losses"]
    bad = {tag: run_arrays_differ(torch, tplan, a, runs[tag]["trainer"])
           for tag in ("serial_again", "overlap")}
    compare_s = time.perf_counter() - t1
    b = runs["overlap"]["trainer"]
    check(not np.isfinite(la[TIERED_OVERLAP_VS_NAN]) and a.bad_steps == 1
          and b.bad_steps == 1, f"tiered_overlap_vs_serial {form}: the NaN "
          f"batch was not skipped ({la}, {a.bad_steps}, {b.bad_steps})")
    regathered = b.telemetry.counter(
        "tiered/conflict_rows_regathered").value
    hidden = b.telemetry.histogram("tiered/overlap_hidden_s")
    res = {"batch": len(batches[0][2]), "losses": la,
           "conflict_rows_regathered": regathered,
           "worker_jobs": hidden.count, "overlap_hidden_s_mean": hidden.mean,
           "wall_s": {tag: r["wall_s"] for tag, r in runs.items()},
           "draw_and_runs_s": t1 - t0, "compare_s": compare_s,
           "differ": bad}
    if form == "distinct":
      for tag in ("serial_again", "overlap"):
        lb = runs[tag]["losses"]
        check(np.array_equal(np.asarray(la), np.asarray(lb), equal_nan=True),
              f"tiered_overlap_vs_serial {form}: {tag} losses {lb} != "
              f"serial {la}")
        check(not bad[tag], f"tiered_overlap_vs_serial {form}: the {tag} "
              f"run's arrays differ from the serial run's: {bad[tag]}"
              + (f"; two serial runs differ too: {bad['serial_again']}"
                 if tag == "overlap" and bad["serial_again"] else ""))
      check(regathered > 0, "tiered_overlap_vs_serial: no conflict row was "
            "re-gathered")
      res["bit_equal"] = True
    else:
      lb = runs["overlap"]["losses"]
      check(np.allclose(lb, la, rtol=1e-5, atol=1e-6, equal_nan=True),
            f"tiered_overlap_vs_serial {form}: overlap losses {lb} vs "
            f"serial {la}")
      for k, d in bad["overlap"].items():
        again = bad["serial_again"].get(k, {"max_abs_err": 0.0})
        check(d["max_abs_err"] <= 2 * again["max_abs_err"],
              f"tiered_overlap_vs_serial {form} {k}: the overlapped run is "
              f"off by {d['max_abs_err']}, more than twice the second "
              f"serial run's {again['max_abs_err']}")
      res["overlap_losses"] = lb
      res["tolerance"] = ("max |overlap - serial| <= 2 max |serial_again - "
                          "serial| per array; losses rtol 1e-5 / atol 1e-6")
    line[form] = res
    del a, b, runs
    torch.cuda.empty_cache()
  emit(line)
  return totals


def abs_apply(layout, absum, ids, fused_delta, delta_scale=None) -> None:
  """Add ``|delta_scale * fused_delta|`` of every occurrence into ``absum``
  at its physical row (the lanes ``scatter_add_fused`` adds to), in plain
  PyTorch: with the buffer's initial magnitudes, each cell's absolute sum,
  the scale of K1's duplicate-order bound."""
  from distributed_embeddings_torch.ops.packed_table import (
      _grp_sub,
      expand_phys,
  )
  grp, sub, _ = _grp_sub(layout, ids.reshape(-1))
  rows = fused_delta.reshape(grp.shape[0], -1).float().abs()
  if rows.shape[-1] != layout.phys_width:
    rows = expand_phys(layout, rows, sub)
  if delta_scale is not None:
    rows = rows * abs(float(delta_scale))
  keep = grp < absum.shape[0]
  absum.index_add_(0, grp[keep], rows[keep])


def tables_within_dup(torch, got, want, absum, rtol: float) -> dict:
  """``got`` against ``want`` (f32 tensors on one device, chunked by
  rows): every cell within ``rtol`` of its absolute sum ``absum``;
  returns the largest difference, the bit-equal share and the verdict."""
  worst, equal, cells, ok = 0.0, 0, 0, True
  for r0 in range(0, want.shape[0], 1 << 16):
    g, w = got[r0:r0 + (1 << 16)], want[r0:r0 + (1 << 16)]
    d = (g - w).abs()
    cells += d.numel()
    equal += int((d == 0).sum())
    if d.numel():
      worst = max(worst, float(d.max()))
    ok = ok and bool((d <= rtol * absum[r0:r0 + (1 << 16)]).all())
  return {"max_abs_err": worst, "bit_equal_share": equal / max(1, cells),
          "within": ok}


def phase_train_tiered_vs_device(torch, smi: str) -> dict:
  """``train_tiered_vs_device``: the train_tiered cell at 1/
  ``TIERED_VS_SCALE`` of the vocabulary. One state drawn all-device
  (``init_sparse_state_direct``) trains ``TIERED_VS_STEPS`` steps with
  ``make_sparse_train_step`` twice (runs A and B: the card's own
  run-to-run spread) and, from a copy moved onto tiering
  (``init_tiered_state_from_fused``: a cache of half of each host-tier
  class, a 2-row staging region so steps spill, a re-rank every 3 steps),
  once through ``TieredTrainer`` (run T), all on the same power-law
  batches. Losses within rtol 1e-5 / atol 1e-6. After the first step
  (one apply from one state) every sparse table cell of T, the host-tier
  ones reconciled, lies within ``TIERED_VS_DUP_RTOL`` of its absolute sum
  of A's (K1's duplicate tolerance: the initial magnitude plus every
  occurrence's absolute delta, summed in plain PyTorch beside A's
  applies; K1 adds duplicates in its atomics' order). Later steps feed
  those last bits back through the model in both runs alike, so at the
  end each table's largest |T - A| must stay within twice its largest
  |B - A|. The bit-equal shares are reported. Returns T's launches."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel import lookup_engine
  from distributed_embeddings_torch.tiering import (
      HostTierStore,
      TieredTrainer,
      TieringConfig,
      TieringPlan,
      init_tiered_state_from_fused,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
      shard_batch,
  )

  vocab = [max(4, v // TIERED_VS_SCALE) for v in CRITEO_1TB_VOCAB]
  plan = tiered_plan(vocab, TIERED_VS_SCALE)
  rule = sgd_rule(TRAIN_LR)
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED + 3), device="cuda")
  twin = twin_state(state)
  tplan = TieringPlan(plan, rule, TieringConfig(
      cache_fraction=0.5, staging_grps=2, rerank_interval=3))
  store = HostTierStore(tplan)
  tiered = init_tiered_state_from_fused(tplan, store, twin_state(state))
  absum = {k: v.abs() for k, v in state["fused"].items()}
  trainer = TieredTrainer(model, tplan, store, bce_loss, sgd_factory(torch),
                          rule, None, tiered, device="cuda")
  step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                rule)
  batches = tiered_batches(vocab, TIERED_VS_STEPS, TRAIN_BATCH, SEED + 13)
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows=n_sparse)
  totals = expect()
  losses = {"A": [], "B": [], "T": []}
  absum_of = {state["fused"][k].data_ptr(): v for k, v in absum.items()}
  apply = lookup_engine.scatter_add_fused

  def apply_and_sum(layout, buf, ids, fused_delta, delta_scale=None):
    abs_apply(layout, absum_of[buf.data_ptr()], ids, fused_delta,
              delta_scale)
    return apply(layout, buf, ids, fused_delta, delta_scale=delta_scale)

  def tiered_table(name):
    if name in tplan.tier_specs:
      return torch.from_numpy(store.images[name][0]).to("cuda")
    return trainer.state["fused"][name]

  first = {}
  for i, batch in enumerate(batches):
    lookup_engine.scatter_add_fused = apply_and_sum
    try:
      state, loss = step(state, *shard_batch(batch, device="cuda"))
    finally:
      lookup_engine.scatter_add_fused = apply
    losses["A"].append(float(loss))
    twin, loss = step(twin, *shard_batch(batch, device="cuda"))
    losses["B"].append(float(loss))
    reset_counts()
    losses["T"].append(trainer.step(*batch))
    got = read_counts()
    check(got == want, f"train_tiered_vs_device step {i}: launches {got}, "
          f"expected {want}")
    add_counts(totals, got)
    if i == 0:
      trainer.flush()
      for name, buf in state["fused"].items():
        first[name] = tables_within_dup(torch, tiered_table(name), buf,
                                        absum[name], TIERED_VS_DUP_RTOL)
        check(first[name]["within"], f"train_tiered_vs_device {name}: off "
              f"by {first[name]['max_abs_err']} after the first step, past "
              f"{TIERED_VS_DUP_RTOL} of a cell's absolute sum")
  for run in ("B", "T"):
    check(np.allclose(losses[run], losses["A"], rtol=1e-5, atol=1e-6),
          f"train_tiered_vs_device: run {run}'s losses {losses[run]} vs "
          f"{losses['A']}")
  trainer.flush()
  tables = {}
  for name, buf in state["fused"].items():
    t = tables_within_dup(torch, tiered_table(name), buf, absum[name],
                          TIERED_VS_DUP_RTOL)
    b = tables_within_dup(torch, twin["fused"][name], buf, absum[name],
                          TIERED_VS_DUP_RTOL)
    tables[name] = {"first_step": first[name], "tiered_vs_A": t,
                    "twin_B_vs_A": b}
    check(t["max_abs_err"] <= 2 * b["max_abs_err"],
          f"train_tiered_vs_device {name}: the tiered run is off by "
          f"{t['max_abs_err']}, more than twice the all-device twin's "
          f"{b['max_abs_err']}")
  summary = trainer.metrics_summary()
  check(summary["spill_steps"] >= 1,
        f"train_tiered_vs_device: no step spilled ({summary})")
  emit({"phase": "train_tiered_vs_device", "card": smi,
        "vocab_scale": f"1/{TIERED_VS_SCALE}", "batch": TRAIN_BATCH,
        "steps": TIERED_VS_STEPS, "geometry": tplan.geometry(),
        "losses": losses,
        "losses_bit_equal": losses["T"] == losses["A"],
        "tables": tables, "tolerance": (
            f"first step: {TIERED_VS_DUP_RTOL} of each cell's absolute "
            "sum (initial magnitude + every occurrence's absolute delta); "
            "end: max |T - A| <= 2 max |B - A|"),
        "spill_steps": summary["spill_steps"], "reranks": 1,
        "hit_rate": summary["hit_rate"], "launches_per_step": want})
  del trainer, state, twin, tiered, store, absum, step
  torch.cuda.empty_cache()
  return totals


def phase_tiered_golden(torch) -> dict:
  """``tiered_golden``: the committed JAX tiered golden replayed through
  the port's ``TieredTrainer`` on the card; returns the launches."""
  from distributed_embeddings_torch import train_golden

  golden = train_golden.load(train_golden.TIERED_PATH)
  reset_counts()
  losses, summary, got = train_golden.replay_tiered(golden, device="cuda")
  counts = read_counts()
  try:
    worst = train_golden.compare_tiered(golden, losses, summary, got)
  except AssertionError as exc:
    raise SmokeFailure(f"tiered_golden: {exc}") from exc
  for name in ("apply_rows", "interact_fwd", "interact_bwd"):
    check(counts[name] > 0, f"tiered_golden never launched {name}")
  emit({"phase": "tiered_golden", "losses": losses,
        "want_losses": [float(v) for v in golden["losses"]], **worst,
        "per_class": summary["per_class"],
        "spill_steps": summary["spill_steps"],
        "loss_tol": train_golden.LOSS_TOL,
        "update_tol": train_golden.UPDATE_TOL, "launches": counts})
  return counts


def phase_tiered_ckpt(torch, smi: str) -> dict:
  """``tiered_ckpt``: the train_tiered cell at 1/``TIERED_VS_SCALE``
  (images drawn on the card): ``TIERED_CKPT_STEPS`` steps,
  ``checkpoint.save(store=)``, ``verify``, ``restore`` into a fresh store
  and state (images, resident sets and counts bit-equal to the saved
  ones), ``TIERED_CKPT_STEPS`` more, against the straight run: the first
  resumed loss bit-equal, every one within K1's 1e-5 (the later steps
  add duplicates in K1's atomics' order), the bit-equal verdict
  reported. Returns the launches."""
  import math
  import shutil
  import tempfile

  import numpy as np

  from distributed_embeddings_torch import checkpoint
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.tiering import (
      HostTierStore,
      TieredTrainer,
      TieringConfig,
      TieringPlan,
      init_tiered_state,
  )

  vocab = [max(4, v // TIERED_VS_SCALE) for v in CRITEO_1TB_VOCAB]
  plan = tiered_plan(vocab, TIERED_VS_SCALE)
  rule = sgd_rule(TRAIN_LR)
  cfg = TieringConfig(cache_fraction=0.5, staging_grps=1024,
                      rerank_interval=TIERED_CKPT_STEPS)
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  totals = expect()

  def fresh(seed):
    tplan = TieringPlan(plan, rule, cfg)
    store = HostTierStore(tplan)
    state = init_tiered_state(
        tplan, store, rule, model.state_dict(), sgd_factory(torch),
        torch.Generator(device="cuda").manual_seed(seed), image_seed=seed,
        image_device="cuda", device="cuda")
    return tplan, store, TieredTrainer(model, tplan, store, bce_loss,
                                       sgd_factory(torch), rule, None, state,
                                       device="cuda")

  def run(trainer, todo):
    reset_counts()
    losses = trainer.run(todo)
    add_counts(totals, read_counts())
    check(all(math.isfinite(v) for v in losses), f"tiered_ckpt: {losses}")
    return losses

  batches = tiered_batches(vocab, 2 * TIERED_CKPT_STEPS, TRAIN_BATCH,
                           SEED + 17)
  tplan, store, a = fresh(SEED)
  run(a, batches[:TIERED_CKPT_STEPS])
  root = tempfile.mkdtemp(prefix="chip_smoke_tiered_ckpt_")
  path = f"{root}/ckpt"
  t0 = time.perf_counter()
  checkpoint.save(path, plan, rule, a.state, store=store)
  save_s = time.perf_counter() - t0
  nbytes, nfiles = dir_bytes(path)
  saved = {f"{part}/{name}": np.asarray(getattr(store, part)[name][0]).copy()
           for part in ("images", "resident_grps", "counts")
           for name in tplan.tier_specs}
  saved_fused = {k: v.clone() for k, v in a.state["fused"].items()}
  t0 = time.perf_counter()
  problems = checkpoint.verify(path)
  verify_s = time.perf_counter() - t0
  check(problems == [], f"tiered_ckpt: verify found {problems}")
  straight = run(a, batches[TIERED_CKPT_STEPS:])
  del a
  _, store_b, b = fresh(SEED + 1)
  t0 = time.perf_counter()
  b.state = checkpoint.restore(path, plan, rule, b.state, store=store_b,
                               device="cuda", verify_integrity=False)
  b.prefetcher.refresh_resident()
  torch.cuda.synchronize()
  restore_s = time.perf_counter() - t0
  for key, want in saved.items():
    part, name = key.split("/", 1)
    check(np.array_equal(np.asarray(getattr(store_b, part)[name][0]), want),
          f"tiered_ckpt: restored {key} differs from the saved one")
  for k, v in saved_fused.items():
    # a tiered buffer's staging region is scratch; its cache region is
    # state
    keep = (tplan.tier_specs[k].cache_grps if k in tplan.tier_specs
            else v.shape[0])
    check(torch.equal(b.state["fused"][k][:keep], v[:keep]),
          f"tiered_ckpt: restored buffer {k} differs from the saved one")
  shutil.rmtree(root)
  resumed = run(b, batches[TIERED_CKPT_STEPS:])
  check(resumed[0] == straight[0], f"tiered_ckpt: first resumed loss "
        f"{resumed[0]} != straight {straight[0]}")
  check(all(abs(r - w) <= 1e-5 * max(1.0, abs(w))
            for r, w in zip(resumed, straight)),
        f"tiered_ckpt: resumed {resumed} left the straight {straight}")
  emit({"phase": "tiered_ckpt", "card": smi,
        "vocab_scale": f"1/{TIERED_VS_SCALE}", "batch": TRAIN_BATCH,
        "host_image_bytes": tplan.host_bytes_per_rank(), "bytes": nbytes,
        "files": nfiles, "save_s": save_s, "verify_s": verify_s,
        "restore_s": restore_s, "restored_bit_equal": True,
        "losses_resumed": resumed, "losses_straight": straight,
        "losses_bit_equal": resumed == straight})
  del b, store_b, saved, saved_fused
  torch.cuda.empty_cache()
  return totals


def _w4_tiered(torch, mesh, backend: str) -> dict:
  """``world4_tiered`` in this rank: the world-4 plan (x 1/``W4_VOCAB_
  SCALE``) with its tables above ``TIERED_HOST_ROWS`` (cut alike)
  host-tier, this rank's store owning its images, one drawn state trained
  under ``'fused'`` (``W4_TIERED_STEPS`` steps of the power-law global
  batch through ``TieredTrainer``) and, from the same draws, one step
  under ``'none'``: the first losses equal, K4 and K1 launched as
  ``k4_classes`` predicts for the plan, K2 once each way."""
  import math

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.tiering import (
      HostTierStore,
      TieredTrainer,
      TieringConfig,
      TieringPlan,
      init_tiered_state,
  )

  dev = mesh.device
  scale = W4_VOCAB_SCALE[backend]
  rule = sgd_rule(TRAIN_LR)
  cfg = TieringConfig(cache_fraction=0.5, staging_grps=4096,
                      rerank_interval=2)
  batch = w4_host_batch(torch, world4_plan(backend)[0], TIERED_ALPHA)
  out = {"vocab_scale": f"1/{scale}"}
  totals = expect()
  for overlap in ("fused", "none"):
    vocab, plan = world4_plan(backend, overlap,
                              host_row_threshold=TIERED_HOST_ROWS // scale)
    tplan = TieringPlan(plan, rule, cfg)
    store = HostTierStore(tplan, owned_ranks=(mesh.rank,))
    model = DLRM(vocab, D, tables=False, device=dev,
                 generator=torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    state = init_tiered_state(
        tplan, store, rule, model.state_dict(), sgd_factory(torch),
        torch.Generator(device=dev).manual_seed(SEED + 1 + mesh.rank),
        mesh=mesh, image_seed=SEED, image_device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    trainer = TieredTrainer(model, tplan, store, bce_loss,
                            sgd_factory(torch), rule, mesh, state)
    k4 = k4_launches_per_step(plan) if overlap == "fused" else 0
    want = expect(gather_rows=k4, apply_rows=len(state["fused"]),
                  interact_fwd=1, interact_bwd=1)
    steps = W4_TIERED_STEPS if overlap == "fused" else 1
    ms, losses = [], []
    for i in range(steps):
      reset_counts()
      torch.cuda.synchronize(dev)
      t0 = time.perf_counter()
      losses.append(trainer.step(*batch))
      ms.append((time.perf_counter() - t0) * 1e3)
      got = read_counts()
      check(got == want, f"world4_tiered {overlap} rank {mesh.rank} step "
            f"{i}: launches {got}, expected {want}")
      add_counts(totals, got)
      check(math.isfinite(losses[-1]), f"world4_tiered {overlap} rank "
            f"{mesh.rank} step {i}: loss {losses[-1]}")
    summary = trainer.metrics_summary()
    out[overlap] = {"losses": losses, "step_ms": ms, "init_s": init_s,
                    "launches_per_step": want,
                    "host_image_bytes": sum(
                        store.images[n][mesh.rank].nbytes
                        for n in tplan.tier_specs),
                    "hit_rate": summary["hit_rate"],
                    "spill_steps": summary["spill_steps"],
                    "host_gather_bytes": summary["host_gather_bytes"]}
    del trainer, state, store
    torch.cuda.empty_cache()
  check(out["fused"]["losses"][0] == out["none"]["losses"][0],
        f"world4_tiered rank {mesh.rank}: fused loss "
        f"{out['fused']['losses'][0]} != none {out['none']['losses'][0]}")
  out["launches"] = totals
  return out


def emit_tiered_world4(backend: str, smi: str, res: list) -> dict:
  """The ``world4_tiered`` line from the ranks' :func:`_w4_tiered`
  results; returns each kernel's launches summed over the ranks."""
  totals = expect()
  for r in res:
    add_counts(totals, r.pop("launches"))
  check(all(r["fused"]["losses"] == res[0]["fused"]["losses"] for r in res),
        "world4_tiered: the ranks' losses differ")
  emit({"phase": "world4_tiered", "backend": backend, "card": smi,
        "vocab_scale": res[0]["vocab_scale"], "global_batch": W4_BATCH,
        "alpha": TIERED_ALPHA, "losses": res[0]["fused"]["losses"],
        "first_loss_equals_none": True,
        "step_ms_by_rank": [r["fused"]["step_ms"] for r in res],
        "init_s_by_rank": [r["fused"]["init_s"] for r in res],
        "host_image_bytes_by_rank": [r["fused"]["host_image_bytes"]
                                     for r in res],
        "host_gather_bytes_by_rank": [r["fused"]["host_gather_bytes"]
                                      for r in res],
        "hit_rate": res[0]["fused"]["hit_rate"],
        "spill_steps": res[0]["fused"]["spill_steps"],
        "launches_per_step_per_rank": [r["fused"]["launches_per_step"]
                                       for r in res],
        "launches": totals})
  return totals


def emit_elastic_world4(backend: str, smi: str, res: list) -> dict:
  """The ``world4_elastic`` line from the ranks' :func:`_w4_elastic`
  results; returns each kernel's launches summed over the ranks."""
  totals = expect()
  for r in res:
    add_counts(totals, r.pop("launches"))
  check([r["parked_at_end"] for r in res] == [False, False, True, True],
        f"world4_elastic: parked at the end "
        f"{[r['parked_at_end'] for r in res]}, expected members 2 and 3")
  for tag in ("sparse/4to2", "sparse/2to4", "tiered/4to2"):
    check(all(r["same_bits"].get(tag, True) for r in res) and any(
        tag in r["same_bits"] for r in res),
        f"world4_elastic {tag}: a rank saw other bits after the move")
  emit({"phase": "world4_elastic", "backend": backend, "card": smi,
        "vocab_scale": res[0]["vocab_scale"],
        "global_batch": W4_ELASTIC_BATCH,
        "same_bits": res[0]["same_bits"],
        "resize_s_by_rank": [r["resize_s"] for r in res],
        "steps_by_rank": [r["steps"] for r in res],
        "sparse_accounting_by_rank": [r["sparse"] for r in res],
        "wall_s_by_rank": [r["wall_s"] for r in res],
        "launches": totals})
  return totals


def phase_world4_ckpt_world1(torch, smi: str, backend: str, path: str,
                             parts: list) -> dict:
  """``world4_ckpt_world1``: ``world4_ckpt``'s checkpoint (written by the
  four ranks) restored in this process at world 1 on the card
  (``checkpoint.restore``'s elastic path: every rank file re-sliced into
  the world-1 plan's blocks): every logical table's checksum
  (:func:`slot_checksums`) equals the sum of the ranks' parts, so its
  bits are the ranks' tables'; then one step from it, K1 once per sparse
  class and K2 once each way. Removes the checkpoint. Returns the
  launches."""
  import math
  import shutil

  from distributed_embeddings_torch import checkpoint
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_param_name,
  )
  from distributed_embeddings_torch.resilience.elastic import plan_for_world
  from distributed_embeddings_torch.training import (
      ScheduledSGD,
      make_sparse_train_step,
      shard_batch,
  )
  from distributed_embeddings_torch.utils import dlrm_lr_schedule

  vocab, plan4 = world4_plan(backend, scale=W4_CKPT_VOCAB_SCALE)
  plan1 = plan_for_world(plan4, 1)
  schedule = dlrm_lr_schedule(*CKPT_SCHEDULE)
  rule = sgd_rule(schedule)

  def dense_opt(params):
    return ScheduledSGD(params, schedule)

  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  # the template restore needs: the dense names and shapes, the dense
  # classes' names, the optimizers' kind
  like = {"dense": model.state_dict(),
          "emb_dense": {class_param_name(*k): torch.empty(0)
                        for k in plan1.class_keys
                        if plan1.classes[k].kind != "sparse"},
          "dense_opt": dense_opt([torch.zeros(1, requires_grad=True)]),
          "emb_dense_opt": dense_opt([torch.zeros(1, requires_grad=True)])}
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = checkpoint.restore(path, plan1, rule, like, device="cuda",
                             verify_integrity=False)
  torch.cuda.synchronize()
  restore_s = time.perf_counter() - t0
  want = {}
  for p in parts:
    for tid, v in p.items():
      want[int(tid)] = (want.get(int(tid), 0) + v) % 2**64
  got = slot_checksums(torch, plan1, rule, state, [0])
  check(got == want, f"world4_ckpt_world1: the world-1 restore's tables "
        f"differ from the ranks': "
        f"{sorted(t for t in want if got.get(t) != want[t])}")
  n_sparse = sum(cp.kind == "sparse" for cp in plan1.classes.values())
  step = make_sparse_train_step(model, plan1, bce_loss, dense_opt, rule)
  launches = expect(interact_fwd=1, interact_bwd=1, apply_rows=n_sparse)
  reset_counts()
  state, loss = step(state, *shard_batch(w4_host_batch(torch, vocab),
                                         device="cuda"))
  loss = float(loss)
  got_counts = read_counts()
  check(got_counts == launches, f"world4_ckpt_world1: launches "
        f"{got_counts}, expected {launches}")
  check(math.isfinite(loss), f"world4_ckpt_world1: loss {loss}")
  emit({"phase": "world4_ckpt_world1", "backend": backend, "card": smi,
        "vocab_scale": f"1/{W4_CKPT_VOCAB_SCALE}",
        "fused_bytes": sum(t.numel() * t.element_size()
                           for t in state["fused"].values()),
        "restore_s": restore_s, "tables_bit_equal": True,
        "tables": len(want), "loss": loss,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": launches, "launches": got_counts})
  del state, step
  torch.cuda.empty_cache()
  shutil.rmtree(path)
  return got_counts


def serve_tiered_requests(vocab, n: int, seed: int) -> list:
  """``n`` requests of ``SERVE_BATCH`` samples: the tiered cell's one-hot
  power-law ids (``tiered_batches``) and normal features."""
  return [(num, cats) for num, cats, _ in tiered_batches(vocab, n,
                                                         SERVE_BATCH, seed)]


def host_image_bytes(plan, rule, quantize: str) -> int:
  """Host bytes of the host-tier classes' serve images under ``quantize``
  (one rank's when the plan has several)."""
  from distributed_embeddings_torch.parallel.lookup_engine import \
      class_param_name
  from distributed_embeddings_torch.serving.export import serve_class_meta
  meta, _ = serve_class_meta(plan, rule, quantize,
                             frozenset(class_param_name(*k) for k in
                                       plan.host_tier_class_keys()))
  return sum(m.packed.phys_rows * m.packed.phys_width * m.np_dtype.itemsize
             for m in meta.values() if m.tier == "host")


def tier_totals(metrics: list) -> dict:
  """Per class, the ``[hot, staged, missed, valid]`` counters of a run's
  dispatches summed; with the run's hit rate over every class."""
  per = {}
  for m in metrics:
    for name, v in m["tier"].items():
      per[name] = [a + int(b) for a, b in zip(per.get(name, [0] * 4), v)]
  hot = sum(v[0] for v in per.values())
  valid = sum(v[3] for v in per.values())
  return {"per_class": per, "hit_rate": hot / max(1, valid),
          "missed": sum(v[2] for v in per.values())}


def serve_tiered_image(torch, ci, smi: str, cell: dict, quantize: str,
                       requests: list) -> dict:
  """One image of the full-width tiered serve cell: ``freeze(store=)``,
  a tiered ``ServeEngine`` with metrics, ``requests`` answered one by one
  (host ms around ``predict``); K2-fwd once a request, every lookup hot or
  staged, the predictions finite and, on the first request, the kernel
  path against the plain interaction over the same activations (the
  engine's state and staging through an activations model). Emits the
  ``serve_tiered`` line; returns the launches."""
  import gc

  import numpy as np

  from distributed_embeddings_torch.serving import (
      ServeEngine,
      ServeTierConfig,
      freeze,
      make_serve_step,
      shard_batch,
  )
  from distributed_embeddings_torch.serving.golden import PRED_TOL, EmbActs

  plan, rule, model = cell["plan"], cell["rule"], cell["model"]
  need = host_image_bytes(plan, rule, quantize)
  ram = host_ram_at_least(TIERED_RAM_SLACK * need)
  check(TIERED_RAM_SLACK * need <= ram["MemAvailable"],
        f"serve_tiered {quantize}: {need} B of images need "
        f"{TIERED_RAM_SLACK} x that of host RAM, MemAvailable "
        f"{ram['MemAvailable']}")
  cfg = ServeTierConfig(cache_fraction=SERVE_TIERED_CACHE,
                        staging_grps=SERVE_TIERED_STAGING)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  frozen = freeze(plan, rule, cell["state"], quantize=quantize,
                  store=cell["store"])
  torch.cuda.synchronize()
  freeze_s = time.perf_counter() - t0
  image_bytes = sum(img.nbytes for imgs in frozen.host_images.values()
                    for img in imgs)
  check(image_bytes == need, f"serve_tiered {quantize}: {image_bytes} B "
        f"of images, {need} planned")
  t0 = time.perf_counter()
  eng = ServeEngine(model, plan, frozen, device="cuda", tier_config=cfg,
                    with_metrics=True)
  torch.cuda.synchronize()
  engine_s = time.perf_counter() - t0
  reset_counts()
  preds, metrics, ms = [], [], []
  for numerical, cats in requests:
    t0 = time.perf_counter()
    p, m = eng.predict(numerical, cats)
    ms.append((time.perf_counter() - t0) * 1e3)
    preds.append(p)
    metrics.append(m)
  got = read_counts()
  want = expect(interact_fwd=len(requests))
  check(got == want, f"serve_tiered {quantize}: launches {got} for "
        f"{len(requests)} requests, expected {want}")
  tiers = tier_totals(metrics)
  check(tiers["missed"] == 0 and all(
      v[0] + v[1] == v[3] for v in tiers["per_class"].values()),
        f"serve_tiered {quantize}: lookups missed both tiers: {tiers}")
  for p in preds:
    check(p.shape == (SERVE_BATCH,) and np.isfinite(p).all(),
          f"serve_tiered {quantize}: predictions not finite "
          f"[{SERVE_BATCH}]")
  peak = torch.cuda.max_memory_allocated() / 2**30
  device_bytes = sum(t.numel() * t.element_size()
                     for t in eng.state["serve"].values())
  geometry = {n: {"cache_grps": sp.cache_grps,
                  "staging_grps": sp.staging_grps,
                  "phys_rows": eng.tplan.by_name(n).layout_logical.phys_rows}
              for n, sp in eng.tplan.tier_specs.items()}
  gather_bytes = eng.prefetcher.total_host_gather_bytes
  spills = eng.prefetcher.spill_steps
  # the kernel path against the plain interaction on the same activations:
  # the engine's own state and staging through an activations model
  acts_step = make_serve_step(EmbActs(), plan, eng.meta,
                              tier_specs=eng.tplan.tier_specs)
  numerical, cats = requests[0]
  staged = eng.prefetcher.prepare(list(cats))
  num_d, cats_d = shard_batch((numerical, tuple(cats)), None, "cuda")
  with torch.inference_mode():
    acts = acts_step(eng.state, staged.device, num_d, cats_d)
    ref = plain_forward(torch, ci, model, num_d, acts).cpu().numpy()
  err = np.abs(preds[0] - ref)
  check(bool((err <= PRED_TOL["atol"] + PRED_TOL["rtol"]
              * np.abs(ref)).all()),
        f"serve_tiered {quantize}: kernel path vs plain interaction off "
        f"by {err.max()}")
  del eng, staged, frozen, acts
  gc.collect()  # the engine's prefetcher holds a reference cycle
  torch.cuda.empty_cache()
  emit({"phase": "serve_tiered", "quantize": quantize, "card": smi,
        "vocab_cut": cell["cut"], "cut_reason": cell["cut_reason"],
        "host_ram": ram, "rows": int(sum(cell["vocab"])),
        "host_tier_tables": len([
            sh for k in plan.host_tier_class_keys()
            for sh in plan.classes[k].shards_per_rank[0]]),
        "image_bytes": image_bytes, "device_serve_bytes": device_bytes,
        "geometry": geometry, "batch": SERVE_BATCH, "alpha": TIERED_ALPHA,
        "requests": len(requests), "freeze_s": freeze_s,
        "engine_s": engine_s, "request_ms": ms,
        "p50_ms": statistics.median(ms), "request_ms_range": [min(ms),
                                                              max(ms)],
        "hit_rate": tiers["hit_rate"], "per_class": tiers["per_class"],
        "missed": tiers["missed"],
        "gather_bytes_per_request": gather_bytes / len(requests),
        "spill_dispatches": spills, "peak_gib": peak,
        "max_abs_err_vs_plain": float(err.max()), "launches": got})
  return got


def phase_serve_tiered(torch, ci, smi: str, trained: dict) -> dict:
  """``serve_tiered``: the train_tiered cell served at full width. Its
  trained state and store (the f32 Criteo-1TB tables, the five above
  ``TIERED_HOST_ROWS`` in host RAM, cut as ``train_tiered`` cut them)
  freeze to int8 and to fp8 images behind a ``SERVE_TIERED_CACHE`` hot
  cache, and answer ``SERVE_TIERED_REQUESTS`` requests of ``SERVE_BATCH``
  power-law ids each (:func:`serve_tiered_image`). f32 images hold a
  second full copy of the training images, so f32 serves a fresh state at
  the smallest power-of-two cut whose training and serve images fit
  ``MemAvailable`` ``TIERED_RAM_SLACK`` times over, after the trained
  store is released (the fresh store's counts come from classifying
  ``SERVE_TIERED_COUNT_BATCHES`` train batches). Returns the launches."""
  import gc

  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.tiering import (
      HostTierStore,
      TieredPrefetcher,
      TieringConfig,
      TieringPlan,
      init_tiered_state,
  )

  totals = expect()
  vocab = trained["vocab"]
  requests = serve_tiered_requests(vocab, SERVE_TIERED_REQUESTS, SEED + 19)
  cell = dict(trained, cut_reason=(
      None if trained["cut"] == 1 else
      f"train_tiered's cut: {TIERED_RAM_SLACK} x the full vocabulary's "
      f"{trained['full_vocab_image_bytes']} training image bytes exceed "
      "MemAvailable"))
  for q in ("int8", "fp8"):
    add_counts(totals, serve_tiered_image(torch, ci, smi, cell, q,
                                          requests))
  trained_ram = trained["host_ram"]
  trained.clear()
  del cell
  gc.collect()
  torch.cuda.empty_cache()
  # f32: training images and their serve copy at once
  rule = sgd_rule(TRAIN_LR)
  full = list(CRITEO_1TB_VOCAB)
  full_bytes = host_image_bytes(tiered_plan(full), rule, "f32")
  # the trained store's pages back first (they return to MemAvailable
  # with a lag)
  ram = host_ram_at_least(0.9 * trained_ram["MemAvailable"])
  cut = tiered_cut(2 * full_bytes, ram["MemAvailable"])
  vocab = [max(4, v // cut) for v in full]
  plan = tiered_plan(vocab, cut)
  tplan = TieringPlan(plan, rule, TieringConfig(cache_fraction=0.01,
                                                staging_grps=16))
  store = HostTierStore(tplan)
  model = dlrm_of(torch, vocab)
  t0 = time.perf_counter()
  state = init_tiered_state(
      tplan, store, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED + 5),
      image_seed=SEED + 5, image_device="cuda", device="cuda")
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  pf = TieredPrefetcher(tplan, store, device="cuda")
  for batch in tiered_batches(vocab, SERVE_TIERED_COUNT_BATCHES, TRAIN_BATCH,
                              SEED + 21):
    pf.classify(batch[1])
  del pf
  emit({"phase": "serve_tiered_f32_setup", "vocab_cut": cut,
        "full_vocab_f32_image_bytes": full_bytes, "init_s": init_s,
        "host_image_bytes": tplan.host_bytes_per_rank()})
  cell = {"vocab": vocab, "plan": plan, "rule": rule, "store": store,
          "state": state, "model": model, "cut": cut,
          "cut_reason": (None if cut == 1 else
                         f"{TIERED_RAM_SLACK} x twice the full vocabulary's "
                         f"{full_bytes} f32 image bytes (the training "
                         "images and their serve copy) exceed "
                         "MemAvailable")}
  requests = serve_tiered_requests(vocab, SERVE_TIERED_REQUESTS, SEED + 19)
  add_counts(totals, serve_tiered_image(torch, ci, smi, cell, "f32",
                                        requests))
  del cell, state, store, model
  gc.collect()
  torch.cuda.empty_cache()
  return totals


def dlrm_of(torch, vocab):
  """The train cell's f32 DLRM over ``vocab`` (dense parameters from
  ``SEED``)."""
  from distributed_embeddings_torch.models import DLRM
  return DLRM(vocab, D, tables=False, device="cuda",
              generator=torch.Generator().manual_seed(SEED))


def serve_tiered_setup(torch) -> dict:
  """The 1/``TIERED_VS_SCALE`` tiered serve cell of
  ``serve_tiered_vs_device`` and ``serve_tiered_artifact``: one state of
  the tiered plan drawn all-device (``init_sparse_state_direct``); a copy
  moved onto tiering (``init_tiered_state_from_fused``: a cache of half of
  each host-tier class), its counts from classifying
  ``SERVE_TIERED_COUNT_BATCHES`` train batches; the same tables laid out
  for the plan without a host tier (``get_weights`` / ``set_weights``,
  ``init_sparse_state``); ``SERVE_TIERED_VS_REQUESTS`` power-law
  requests."""
  from distributed_embeddings_torch.layers.dist_model_parallel import (
      get_weights,
      set_weights,
  )
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.tiering import (
      HostTierStore,
      TieredPrefetcher,
      TieringConfig,
      TieringPlan,
      init_tiered_state_from_fused,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state,
      init_sparse_state_direct,
      unpack_sparse_state,
  )

  vocab = [max(4, v // TIERED_VS_SCALE) for v in CRITEO_1TB_VOCAB]
  plan = tiered_plan(vocab, TIERED_VS_SCALE)
  flat = train_plan(vocab, buffer_elements=None)
  rule = sgd_rule(TRAIN_LR)
  model = dlrm_of(torch, vocab)
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED + 7), device="cuda")
  tplan = TieringPlan(plan, rule, TieringConfig(cache_fraction=0.5,
                                                staging_grps=1024))
  store = HostTierStore(tplan)
  tiered = init_tiered_state_from_fused(tplan, store, twin_state(state))
  pf = TieredPrefetcher(tplan, store, device="cuda")
  for batch in tiered_batches(vocab, SERVE_TIERED_COUNT_BATCHES, TRAIN_BATCH,
                              SEED + 23):
    pf.classify(batch[1])
  del pf
  params, _ = unpack_sparse_state(plan, rule, state)
  weights = get_weights(plan, params["embeddings"])
  params["embeddings"] = {k: torch.from_numpy(v) for k, v in
                          set_weights(flat, weights).items()}
  del weights
  flat_state = init_sparse_state(flat, params, rule, sgd_factory(torch),
                                 device="cuda")
  del params
  return {"vocab": vocab, "plan": plan, "flat": flat, "rule": rule,
          "model": model, "state": state, "tiered": tiered, "store": store,
          "flat_state": flat_state,
          "requests": serve_tiered_requests(vocab, SERVE_TIERED_VS_REQUESTS,
                                            SEED + 27)}


def phase_serve_tiered_vs_device(torch, smi: str, setup: dict) -> dict:
  """``serve_tiered_vs_device``: the 1/``TIERED_VS_SCALE`` cell
  (:func:`serve_tiered_setup`) served tiered through a 2-row staging
  region (every dispatch spills) against all-device serving of the same
  tables: per image (f32, int8, fp8) the tiered predictions bit-equal to
  the untiered plan's all-device engine's, f32 ones also to
  ``make_sparse_eval_step``'s; no lookup missed. K2-fwd once per request
  of each engine and per eval call. Returns the launches."""
  import gc

  import numpy as np

  from distributed_embeddings_torch.serving import (
      ServeEngine,
      ServeTierConfig,
      freeze,
  )
  from distributed_embeddings_torch.training import (
      make_sparse_eval_step,
      shard_batch,
  )

  plan, flat, rule = setup["plan"], setup["flat"], setup["rule"]
  model, requests = setup["model"], setup["requests"]
  cfg = ServeTierConfig(cache_fraction=0.5, staging_grps=2)
  ev = make_sparse_eval_step(model, plan, rule)
  totals = expect()
  for q in ("f32", "int8", "fp8"):
    reset_counts()
    eng = ServeEngine(model, plan, freeze(plan, rule, setup["tiered"], q,
                                          store=setup["store"]),
                      device="cuda", tier_config=cfg, with_metrics=True)
    flat_eng = ServeEngine(model, flat, freeze(flat, rule,
                                               setup["flat_state"], q),
                           device="cuda")
    metrics, evals = [], 0
    for i, (numerical, cats) in enumerate(requests):
      got, m = eng.predict(numerical, cats)
      metrics.append(m)
      want = flat_eng.predict(numerical, cats)
      check(np.array_equal(got.view(np.int32), want.view(np.int32)),
            f"serve_tiered_vs_device {q} request {i}: tiered predictions "
            f"differ from all-device serving's by up to "
            f"{np.abs(got - want).max()}")
      if q == "f32":
        with torch.inference_mode():
          ref = ev(setup["state"], *shard_batch((numerical, cats), None,
                                                "cuda")).cpu().numpy()
        evals += 1
        check(np.array_equal(got.view(np.int32), ref.view(np.int32)),
              f"serve_tiered_vs_device f32 request {i}: tiered predictions "
              f"differ from make_sparse_eval_step's by up to "
              f"{np.abs(got - ref).max()}")
    got_l = read_counts()
    want_l = expect(interact_fwd=2 * len(requests) + evals)
    check(got_l == want_l, f"serve_tiered_vs_device {q}: launches {got_l}, "
          f"expected {want_l}")
    add_counts(totals, got_l)
    tiers = tier_totals(metrics)
    check(tiers["missed"] == 0, f"serve_tiered_vs_device {q}: {tiers}")
    check(eng.prefetcher.spill_steps == len(requests),
          f"serve_tiered_vs_device {q}: {eng.prefetcher.spill_steps} of "
          f"{len(requests)} dispatches spilled")
    emit({"phase": "serve_tiered_vs_device", "quantize": q, "card": smi,
          "vocab_scale": f"1/{TIERED_VS_SCALE}", "batch": SERVE_BATCH,
          "requests": len(requests), "staging_grps": 2,
          "spill_dispatches": eng.prefetcher.spill_steps,
          "hit_rate": tiers["hit_rate"], "per_class": tiers["per_class"],
          "bit_equal_all_device": True,
          **({"bit_equal_eval": True} if q == "f32" else {}),
          "launches": got_l})
    del eng, flat_eng
    gc.collect()  # the tiered engine's prefetcher holds a reference cycle
    torch.cuda.empty_cache()
  return totals


def phase_serve_tiered_artifact(torch, smi: str, setup: dict) -> dict:
  """``serve_tiered_artifact``: the 1/``TIERED_VS_SCALE`` cell's int8
  tiered artifact: ``export(store=)`` (cold images and
  ``serve_ranking.npz`` beside the device blocks), ``verify``, ``load``,
  a tiered ``ServeEngine`` on it answering the requests bit-equal to the
  ``FrozenTables`` engine's; seconds, bytes and files. Returns the
  launches; the cell's arrays are released."""
  import gc
  import os
  import shutil
  import tempfile

  import numpy as np

  from distributed_embeddings_torch import checkpoint
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      ServeTierConfig,
      export,
      load,
  )

  plan, rule, model = setup["plan"], setup["rule"], setup["model"]
  requests = setup["requests"]
  cfg = ServeTierConfig(cache_fraction=SERVE_TIERED_CACHE,
                        staging_grps=SERVE_TIERED_STAGING)
  root = tempfile.mkdtemp(prefix="chip_smoke_serve_tiered_")
  path = f"{root}/artifact"
  t0 = time.perf_counter()
  frozen = export(path, plan, rule, setup["tiered"], quantize="int8",
                  store=setup["store"], extra={"cell": "serve_tiered"})
  export_s = time.perf_counter() - t0
  nbytes, nfiles = dir_bytes(path)
  cold = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
             if f.startswith("serve_cold_"))
  free = shutil.disk_usage(root).free
  t0 = time.perf_counter()
  problems = checkpoint.verify(path)
  verify_s = time.perf_counter() - t0
  check(problems == [], f"serve_tiered_artifact: verify found {problems}")
  t0 = time.perf_counter()
  art = load(path, plan, device="cuda")
  torch.cuda.synchronize()
  load_s = time.perf_counter() - t0
  check(sorted(art.host_images) == sorted(frozen.host_images) != [],
        "serve_tiered_artifact: the loaded artifact's host-tier classes "
        f"{sorted(art.host_images)}")
  reset_counts()
  ms = []
  eng = ServeEngine(model, plan, art, device="cuda", tier_config=cfg)
  ref = ServeEngine(model, plan, frozen, device="cuda", tier_config=cfg)
  for i, (numerical, cats) in enumerate(requests):
    t0 = time.perf_counter()
    got = eng.predict(numerical, cats)
    ms.append((time.perf_counter() - t0) * 1e3)
    want = ref.predict(numerical, cats)
    check(np.array_equal(got.view(np.int32), want.view(np.int32)),
          f"serve_tiered_artifact request {i}: the artifact engine differs "
          f"from the FrozenTables engine by {np.abs(got - want).max()}")
  launches = read_counts()
  want_l = expect(interact_fwd=2 * len(requests))
  check(launches == want_l, f"serve_tiered_artifact: launches {launches}, "
        f"expected {want_l}")
  emit({"phase": "serve_tiered_artifact", "quantize": "int8", "card": smi,
        "vocab_scale": f"1/{TIERED_VS_SCALE}", "bytes": nbytes,
        "cold_image_bytes": cold, "files": nfiles, "export_s": export_s,
        "verify_s": verify_s, "load_s": load_s, "disk_free_bytes": free,
        "request_ms": ms, "bit_equal_frozen": True, "launches": launches})
  shutil.rmtree(root)
  del eng, ref, art, frozen
  setup.clear()  # the cell's last phase
  gc.collect()
  torch.cuda.empty_cache()
  return launches


def phase_serve_tiered_golden(torch) -> dict:
  """``serve_tiered_golden``: the committed JAX tiered serve golden
  replayed through the port's tiered ``ServeEngine`` on the card, per
  image: activations bit-equal, counters and spill dispatches exact,
  predictions within ``serving.golden.PRED_TOL`` (the interaction runs in
  bf16 on the card). Returns the launches."""
  from distributed_embeddings_torch.serving import golden

  g = golden.load(golden.TIERED_PATH)
  reset_counts()
  worst = {}
  for q in golden.TIERED_QUANTIZE:
    got = golden.replay_tiered(g, q, device="cuda")
    try:
      worst[q] = golden.compare_tiered(g, q, got)
    except AssertionError as exc:
      raise SmokeFailure(f"serve_tiered_golden {q}: {exc}") from exc
  counts = read_counts()
  # two engines (a serve cache, a spilling one) x two requests per image
  want = expect(interact_fwd=4 * len(golden.TIERED_QUANTIZE))
  check(counts == want, f"serve_tiered_golden: launches {counts}, "
        f"expected {want}")
  emit({"phase": "serve_tiered_golden", "pred_max_abs_err": worst,
        "pred_tol": golden.PRED_TOL, "acts_bit_equal": True,
        "counters_exact": True, "launches": counts})
  return counts


def w4_local_tables(plan, tplan, store, rule, state, mesh) -> dict:
  """This rank's simple-layout class tables ``[padded_rows, width]``: the
  host-tier ones unpacked from its store's image (on the host), the
  device-tier sparse ones from its fused buffers, the dense classes' rows
  of ``emb_dense``."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
  )
  layouts = DistributedLookup(plan).fused_layouts(rule)
  out = {}
  for key in plan.class_keys:
    name = class_param_name(*key)
    if name in tplan.tier_specs:
      lay = tplan.by_name(name).layout_logical
      out[name] = lay.unpack(store.images[name][mesh.rank])[0]
    elif plan.classes[key].kind == "sparse":
      out[name] = layouts[name].unpack(state["fused"][name])[0]
    else:
      out[name] = state["emb_dense"][name]
  return out


def w4_world1_acts(torch, plan, mesh, local: dict, cats) -> list:
  """Every table's rows at the global request's ids ``cats`` (one-hot,
  numpy), on every rank: each rank fills the rows of the shards it owns
  from its local tables (:func:`w4_local_tables`), zeros elsewhere, and
  one ``all_reduce`` adds them (every row comes from one rank)."""
  import numpy as np

  from distributed_embeddings_torch.parallel.lookup_engine import \
      class_param_name
  dev = mesh.device
  acts = []
  for t, ids in enumerate(cats):
    ids = np.asarray(ids).astype(np.int64)
    rows = torch.zeros((ids.shape[0], D), dtype=torch.float32, device=dev)
    for rank, shard in plan.table_shard_map(t):
      if rank != mesh.rank:
        continue
      key = plan.class_key_of(shard)
      cp = plan.classes[key]
      row0 = cp.row_offsets_per_rank[rank][cp.shards_per_rank[rank].index(
          shard)]
      sel = np.flatnonzero((ids >= shard.row_start)
                           & (ids < shard.row_start + shard.input_dim))
      table = local[class_param_name(*key)]
      src = torch.as_tensor(row0 + ids[sel] - shard.row_start)
      got = table[src.to(table.device) if isinstance(table, torch.Tensor)
                  else src.numpy()]
      rows[torch.as_tensor(sel, device=dev),
           shard.col_start:shard.col_end] = torch.as_tensor(got).to(dev)
    torch.distributed.all_reduce(rows)
    acts.append(rows)
  return acts


def _w4_serve_tiered(torch, mesh, backend: str) -> dict:
  """``world4_serve_tiered`` and ``world4_batcher`` in this rank: the
  world-4 plan (x 1/16 on both backends) with its tables above
  ``TIERED_HOST_ROWS`` (cut alike) host-tier, this rank's store owning its
  image (a drawn state, counts from classifying two global train
  batches); per image (f32, int8) ``freeze(store=, mesh=)`` and a tiered
  ``ServeEngine(mesh=)`` answering ``W4_SERVE_TIERED_REQUESTS`` global
  power-law requests in lockstep: the answers equal on every rank, no
  lookup missed, K2-fwd once a request; the f32 answers against the
  world-1 forward of the same rows (the model on one process over each
  rank's slice of the global request in turn, its activations the
  tables' rows gathered from the owning ranks), in the f32 class, the
  bit-equal verdict reported. Then the rank-0 ``MicroBatcher``
  (``serving.world_batcher``) in front of the f32 engine: rank 0 submits
  ``W4_BATCHER_REQUESTS`` requests of 1-``BATCHER_MAX_ROWS`` rows as
  Poisson arrivals at ``W4_BATCHER_RATE`` a second from
  ``BATCHER_THREADS`` threads while the other ranks follow; each
  request's rows against lockstep predictions of the same rows within
  ``serving.golden.PRED_TOL``, and K2-fwd once per dispatch on every
  rank."""
  import gc
  import threading

  import numpy as np

  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.wire import gather_blocks
  from distributed_embeddings_torch.serving import (
      REJECT_REASONS,
      Rejected,
      ServeEngine,
      ServeTierConfig,
      freeze,
      shard_batch,
      world_batcher,
  )
  from distributed_embeddings_torch.serving.golden import PRED_TOL
  from distributed_embeddings_torch.tiering import (
      HostTierStore,
      TieredPrefetcher,
      TieringConfig,
      TieringPlan,
      init_tiered_state,
  )

  dev = mesh.device
  scale = W4_VOCAB_SCALE["gloo"]
  vocab, plan = world4_plan("gloo", "fused",
                            host_row_threshold=TIERED_HOST_ROWS // scale)
  rule = sgd_rule(TRAIN_LR)
  tplan = TieringPlan(plan, rule, TieringConfig(cache_fraction=0.5,
                                                staging_grps=4096))
  store = HostTierStore(tplan, owned_ranks=(mesh.rank,))
  model = DLRM(vocab, D, tables=False, device=dev,
               generator=torch.Generator().manual_seed(SEED))
  state = init_tiered_state(
      tplan, store, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device=dev).manual_seed(SEED + 1 + mesh.rank),
      mesh=mesh, image_seed=SEED, image_device=dev)
  pf = TieredPrefetcher(tplan, store, mesh)
  for batch in tiered_batches(vocab, 2, W4_BATCH, SEED + 31):
    pf.classify(batch[1])
  del pf
  requests = serve_tiered_requests(vocab, W4_SERVE_TIERED_REQUESTS, SEED + 29)
  cfg = ServeTierConfig(cache_fraction=SERVE_TIERED_CACHE,
                        staging_grps=SERVE_TIERED_STAGING)
  out = {"vocab_scale": f"1/{scale}", "launches": expect()}
  for q in ("f32", "int8"):
    t0 = time.perf_counter()
    frozen = freeze(plan, rule, state, quantize=q, store=store, mesh=mesh)
    torch.cuda.synchronize(dev)
    freeze_s = time.perf_counter() - t0
    eng = ServeEngine(model, plan, frozen, mesh=mesh, tier_config=cfg,
                      with_metrics=True)
    reset_counts()
    preds, metrics, ms = [], [], []
    for numerical, cats in requests:
      torch.cuda.synchronize(dev)
      t0 = time.perf_counter()
      p, m = eng.predict(numerical, cats)
      ms.append((time.perf_counter() - t0) * 1e3)
      preds.append(p)
      metrics.append(m)
    got = read_counts()
    want = expect(interact_fwd=len(requests))
    check(got == want, f"world4_serve_tiered {q} rank {mesh.rank}: launches "
          f"{got}, expected {want}")
    add_counts(out["launches"], got)
    tiers = tier_totals(metrics)
    check(tiers["missed"] == 0, f"world4_serve_tiered {q} rank {mesh.rank}: "
          f"{tiers}")
    for i, p in enumerate(preds):
      check(p.shape == (SERVE_BATCH,) and np.isfinite(p).all(),
            f"world4_serve_tiered {q}: predictions not finite")
      every = gather_blocks(torch.from_numpy(p).to(dev), mesh).cpu().numpy()
      check(all(np.array_equal(every[r * SERVE_BATCH:(r + 1) * SERVE_BATCH]
                               .view(np.int32), p.view(np.int32))
                for r in range(WORLD)),
            f"world4_serve_tiered {q} request {i}: the ranks' predictions "
            "differ")
    line = {"freeze_s": freeze_s, "request_ms": ms,
            "hit_rate": tiers["hit_rate"], "per_class": tiers["per_class"],
            "spill_dispatches": eng.prefetcher.spill_steps,
            "gather_bytes": eng.prefetcher.total_host_gather_bytes,
            "image_bytes": sum(imgs[mesh.rank].nbytes for imgs in
                               frozen.host_images.values()),
            "launches": got}
    if q == "f32":
      local = w4_local_tables(plan, tplan, store, rule, state, mesh)
      worst, equal = 0.0, True
      n = SERVE_BATCH // WORLD
      for i, (numerical, cats) in enumerate(requests):
        acts = w4_world1_acts(torch, plan, mesh, local, cats)
        num_d, cats_d = shard_batch((numerical, tuple(cats)), None, dev)
        reset_counts()
        # one forward per rank's slice: the world-4 step's matmul shapes
        # (a bottom-MLP output one f32 ulp off moves a bf16 K2 operand)
        with torch.inference_mode():
          ref = torch.cat([
              model(num_d[r * n:(r + 1) * n],
                    [c[r * n:(r + 1) * n] for c in cats_d],
                    emb_acts=[a[r * n:(r + 1) * n] for a in acts])
              for r in range(WORLD)]).float().cpu().numpy()
        check(read_counts() == expect(interact_fwd=WORLD),
              "world4_serve_tiered: the world-1 forward's launches")
        p = preds[i]
        err = np.abs(p - ref)
        check(bool((err <= 1e-6 + 1e-5 * np.abs(ref)).all()),
              f"world4_serve_tiered rank {mesh.rank}: off the world-1 "
              f"forward by {err.max()}")
        worst = max(worst, float(err.max()))
        equal = equal and np.array_equal(p.view(np.int32), ref.view(np.int32))
      line["world1_max_abs_err"], line["world1_bit_equal"] = worst, equal
      del local
      f32_frozen = frozen
    out[q] = line
    del frozen, eng
    gc.collect()  # the engine's prefetcher holds a reference cycle
  del state
  # the batcher's engine: predictions only (no counters)
  eng = ServeEngine(model, plan, f32_frozen, mesh=mesh, tier_config=cfg)
  del f32_frozen
  torch.cuda.empty_cache()

  # the rank-0 batcher: lockstep predictions of a pool of rows first
  pool = BATCHER_POOL * SERVE_BATCH
  rng = np.random.default_rng(SEED + 37)
  numerical = rng.standard_normal((pool, 13)).astype(np.float32)
  draws = serve_tiered_requests(vocab, BATCHER_POOL, SEED + 41)
  cats = [np.concatenate([c[t] for _, c in draws])
          for t in range(len(vocab))]
  reset_counts()
  ref, lockstep_ms = [], []
  for i in range(0, pool, SERVE_BATCH):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ref.append(eng.predict(numerical[i:i + SERVE_BATCH],
                           [c[i:i + SERVE_BATCH] for c in cats]))
    lockstep_ms.append((time.perf_counter() - t0) * 1e3)
  ref = np.concatenate(ref)
  bat = {"lockstep_request_ms": lockstep_ms}
  if mesh.rank != 0:
    t0 = time.perf_counter()
    mb = world_batcher(eng, SERVE_BATCH)
    check(mb is None, "world4_batcher: a follower got a batcher")
    bat["follow_s"] = time.perf_counter() - t0
  else:
    mb = world_batcher(eng, SERVE_BATCH, max_delay_s=BATCHER_DELAY_S)
    plan_rng = np.random.default_rng(SEED + W4_BATCHER_RATE)
    per_thread = W4_BATCHER_REQUESTS // BATCHER_THREADS
    schedules = []
    for _ in range(BATCHER_THREADS):
      gaps = plan_rng.exponential(BATCHER_THREADS / W4_BATCHER_RATE,
                                  per_thread)
      sizes = plan_rng.integers(1, BATCHER_MAX_ROWS + 1, per_thread)
      starts = plan_rng.integers(0, pool - BATCHER_MAX_ROWS, per_thread)
      schedules.append((np.cumsum(gaps), sizes, starts))
    results = [[] for _ in range(BATCHER_THREADS)]
    shed = [{r: 0 for r in REJECT_REASONS} for _ in range(BATCHER_THREADS)]

    def submitter(k, t0):
      at, sizes, starts = schedules[k]
      for t, n, a in zip(at, sizes, starts):
        wait = t0 + t - time.perf_counter()
        if wait > 0:
          time.sleep(wait)
        try:
          fut = mb.submit(numerical[a:a + n], [c[a:a + n] for c in cats])
        except Rejected as e:
          shed[k][e.reason] += 1
          continue
        results[k].append((a, n, fut))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(k, t0))
               for k in range(BATCHER_THREADS)]
    for t in threads:
      t.start()
    for t in threads:
      t.join()
    lat, worst = [], 0.0
    for k in range(BATCHER_THREADS):
      for a, n, fut in results[k]:
        try:
          got_rows = fut.result(timeout=300)
        except Rejected as e:
          shed[k][e.reason] += 1
          continue
        err = np.abs(got_rows - ref[a:a + n])
        check(got_rows.shape == (n,) and bool(
            (err <= PRED_TOL["atol"] + PRED_TOL["rtol"]
             * np.abs(ref[a:a + n])).all()),
              f"world4_batcher: a request's rows differ from lockstep "
              f"predict's by up to {err.max()}")
        worst = max(worst, float(err.max()))
        lat.append(fut.latency_s * 1e3)
    wall_s = time.perf_counter() - t0
    mb.close()
    stats = mb.stats
    check(stats["completed"] == len(lat),
          f"world4_batcher: stats {stats}, {len(lat)} answered")
    bat.update({"offered_requests_per_s": W4_BATCHER_RATE,
                "requests": len(lat), "wall_s": wall_s,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "p999_ms": float(np.percentile(lat, 99.9)),
                "dispatches": stats["batches"],
                "mean_fill": sum(n for res in results for _, n, _ in res)
                / (stats["batches"] * SERVE_BATCH),
                "rejected": stats["rejected"],
                "rejected_by_reason": {r: sum(t[r] for t in shed)
                                       for r in REJECT_REASONS},
                "max_abs_err_vs_lockstep": worst})
  got = read_counts()
  # every rank ran each lockstep dispatch and each batcher dispatch
  n_disp = torch.tensor([bat.get("dispatches", 0)], device=dev)
  torch.distributed.broadcast(n_disp, src=0)
  want = expect(interact_fwd=pool // SERVE_BATCH + int(n_disp.item()))
  check(got == want, f"world4_batcher rank {mesh.rank}: launches {got}, "
        f"expected {want}")
  bat["launches"] = got
  del eng
  gc.collect()
  torch.cuda.empty_cache()
  return {"serve": out, "batcher": bat}


def emit_serve_tiered_world4(backend: str, smi: str, res: list) -> tuple:
  """The ``world4_serve_tiered`` and ``world4_batcher`` lines from the
  ranks' :func:`_w4_serve_tiered` results; returns each path's launches
  summed over the ranks."""
  serve, bat = expect(), expect()
  for r in res:
    add_counts(serve, r["serve"].pop("launches"))
    add_counts(bat, r["batcher"].pop("launches"))
  s0 = res[0]["serve"]
  emit({"phase": "world4_serve_tiered", "backend": backend, "card": smi,
        "vocab_scale": s0["vocab_scale"], "global_batch": SERVE_BATCH,
        "requests": W4_SERVE_TIERED_REQUESTS, "alpha": TIERED_ALPHA,
        "ranks_equal": True,
        **{q: {"request_ms_by_rank": [r["serve"][q]["request_ms"]
                                      for r in res],
               "freeze_s_by_rank": [r["serve"][q]["freeze_s"] for r in res],
               "image_bytes_by_rank": [r["serve"][q]["image_bytes"]
                                       for r in res],
               "gather_bytes_by_rank": [r["serve"][q]["gather_bytes"]
                                        for r in res],
               "hit_rate": s0[q]["hit_rate"],
               "spill_dispatches": s0[q]["spill_dispatches"],
               **({"world1_max_abs_err_by_rank": [
                   r["serve"][q]["world1_max_abs_err"] for r in res],
                   "world1_bit_equal_by_rank": [
                       r["serve"][q]["world1_bit_equal"] for r in res]}
                  if q == "f32" else {})}
           for q in ("f32", "int8")},
        "launches": serve})
  b0 = res[0]["batcher"]
  emit({"phase": "world4_batcher", "backend": backend, "card": smi,
        "quantize": "f32", "max_batch": SERVE_BATCH,
        "max_delay_s": BATCHER_DELAY_S, "threads": BATCHER_THREADS,
        **{k: v for k, v in b0.items() if k != "lockstep_request_ms"},
        "lockstep_request_ms_by_rank": [r["batcher"]["lockstep_request_ms"]
                                        for r in res],
        "follow_s_by_rank": [r["batcher"].get("follow_s") for r in res],
        "launches": bat})
  return serve, bat


# ---------------------------------------------------------------------------
# narrow storage under every rule and id form, dense Adam (slice 20)
# ---------------------------------------------------------------------------


def k1_rule_streams(torch, layout, gen) -> dict:
  """K1's bf16 streams at a rule's fused rows (``layout``: one logical
  row a physical row): ``K1_IDS`` uniform ids with a sixteenth out of
  range on either side (the duplicates uniform draws give), 64 of them on
  one row; the fused deltas of momentum's or Adam's lanes, bf16."""
  rows = layout.rows
  margin = rows // 32
  ids = torch.randint(-margin, rows + margin, (K1_IDS,), generator=gen,
                      device="cuda")
  ids[:64] = rows // 3  # a run of one id
  delta = (torch.randn((K1_IDS, layout.phys_width), generator=gen,
                       device="cuda") * 1e-2).to(torch.bfloat16)
  return ids, delta


def phase_kernel_apply_bf16_rules(torch, ca, flush, rows: int) -> list:
  """K1's bf16 form at the momentum and Adam rules' lanes (``n_aux`` 1 and
  2): width-128 rows of 256 and 384 bf16 lanes (``rows`` of them, the
  train cell's first class), :func:`k1_rule_streams`, and Tiny's largest
  w16 class under each rule (32- and 48-lane strides, 4 and 2 rows a
  physical row) at physical-row granularity; each held to its plain
  version by :func:`k1_bf16_check` and timed beside it (the w128 streams),
  a bf16 ``index_add_`` and its bound. Returns the rows emitted."""
  from distributed_embeddings_torch.ops.packed_table import (
      PackedLayout,
      _grp_sub,
      adam_rule,
      momentum_rule,
  )
  gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
  out = []
  for rule in (momentum_rule(TRAIN_LR), adam_rule(ADAM_LR)):
    layout = PackedLayout(rows=rows, width=D, n_aux=rule.n_aux)
    w = layout.phys_width
    base = (torch.rand(layout.shape, generator=gen, device="cuda")
            - 0.5).to(torch.bfloat16)
    ids, delta = k1_rule_streams(torch, layout, gen)
    res = k1_bf16_check(torch, ca, f"w128_{rule.name}", base, ids, delta,
                        None)
    work = base.clone()
    valid = (ids >= 0) & (ids < rows)
    ids_v, delta_v = ids[valid], delta[valid]
    timed = event_ms(torch, {
        "kernel_ms": lambda: ca.apply_rows(work, ids, delta),
        "plain_ms": lambda: ca.apply_rows_plain(work, ids, delta),
        "library_ms": lambda: work.index_add_(0, ids_v, delta_v)}, flush)
    n, nv, uniq = K1_IDS, res["valid_ids"], res["unique_rows"]
    row = {"phase": "kernel", "name": "apply_rows_bf16",
           "stream": f"w128_{rule.name}", "rule": rule.name,
           "n_aux": rule.n_aux, "plan": k1_plan_check(torch, ca, n),
           "rows": rows, "width": w, "dtype": "bfloat16", "ids": n, **res,
           **timed, **bound(n * 8 + nv * w * 2 + uniq * w * 2 * 2,
                            2 * nv * w, F32_FLOPS)}
    emit(row)
    out.append(row)
    del base, work, ids, delta, ids_v, delta_v
    torch.cuda.empty_cache()
    # Tiny's largest w16 class under the rule, at physical-row granularity
    plan = zoo_plan()
    routed = zoo_routed(torch, plan)
    name, lay = next((nm, lt) for nm, lt in zoo_classes(plan, rule)
                     if lt.width == 16)
    tid = torch.cat([i.reshape(-1).long() for _, i in routed.pop(name)])
    del routed
    grp, sub, _ = _grp_sub(lay, tid)
    win = torch.arange(D, device="cuda") // lay.stride
    delta = torch.randn((grp.shape[0], D), generator=gen,
                        device="cuda") * 1e-2
    delta = torch.where(win[None, :] == sub[:, None], delta,
                        torch.zeros_like(delta)).to(torch.bfloat16)
    base = torch.rand((lay.phys_rows, D), generator=gen,
                      device="cuda").to(torch.bfloat16)
    res = k1_bf16_check(torch, ca, f"tiny_{name}_{rule.name}", base, grp,
                        delta, None)
    work = base.clone()
    valid = grp < lay.phys_rows
    grp_v, delta_v = grp[valid], delta[valid]
    timed = event_ms(torch, {
        "kernel_ms": lambda: ca.apply_rows(work, grp, delta),
        "library_ms": lambda: work.index_add_(0, grp_v, delta_v)}, flush)
    n, nv, uniq = int(grp.shape[0]), res["valid_ids"], res["unique_rows"]
    row = {"phase": "kernel", "name": "apply_rows_bf16",
           "stream": f"tiny_{name}_{rule.name}", "rule": rule.name,
           "n_aux": rule.n_aux, "plan": k1_plan_check(torch, ca, n),
           "rows": lay.phys_rows, "width": D, "logical_width": lay.width,
           "stride": lay.stride, "rows_per_phys": lay.rows_per_phys,
           "dtype": "bfloat16", "ids": n, **res, **timed, "plain_ms": None,
           **bound(n * 8 + nv * D * 2 + uniq * D * 2 * 2, 2 * nv * D,
                   F32_FLOPS)}
    emit(row)
    out.append(row)
    del base, work, delta, grp, sub, grp_v, delta_v, tid
    torch.cuda.empty_cache()
  return out


def phase_sparse_optim(torch) -> dict:
  """``sparse_optim``: the table-level sparse optimizers
  (``ops.sparse_optimizer``: SGD, Adagrad, momentum, Adam) on a card
  table (``SPARSE_OPTIM_ROWS`` x 128, f32) against the same calls on the
  CPU: two applies of the card's deduplicated gradients (``dedup_rows``
  of ``K1_IDS`` power-law ids, a sixteenth out of range: its ids equal to
  the CPU's, its sums within 1e-5 of their absolute sums), a scheduled
  learning rate; the tables and every state leaf in the f32 class (rtol
  1e-5, atol 1e-6). No kernel of the port runs here. Returns the (zero)
  launches."""
  from distributed_embeddings_torch import ops

  gen = torch.Generator(device="cuda").manual_seed(SEED + 63)
  rows, n = SPARSE_OPTIM_ROWS, K1_IDS
  table0 = torch.randn((rows, D), generator=gen, device="cuda")
  r = torch.rand((n,), generator=gen, device="cuda", dtype=torch.float64)
  ids = (((r * ((rows + 1.0) ** -0.05 - 1.0) + 1.0) ** (1 / -0.05)).long()
         - 1).clamp(0, rows - 1)
  ids[:n // 16] = torch.randint(rows, 2 * rows, (n // 16,), generator=gen,
                                device="cuda")
  grads = [torch.randn((n, D), generator=gen, device="cuda")
           for _ in range(2)]
  reset_counts()
  # the card's deduplicated gradients: the ids equal the CPU's, the rows
  # (sums of up to thousands of duplicates, added in the atomics' order)
  # within 1e-5 of each sum's absolute sum; both optimizers apply them
  srs = []
  for g in grads:
    sr = ops.dedup_rows(ids, g, rows)
    want = ops.dedup_rows(ids.cpu(), g.cpu(), rows)
    check(torch.equal(sr.ids.cpu(), want.ids), "sparse_optim: dedup_rows' "
          "ids on the card differ from the CPU's")
    absum = ops.dedup_rows(ids.cpu(), g.abs().cpu(), rows).rows
    check(bool(((sr.rows.cpu() - want.rows).abs() <= 1e-5 * absum + 1e-6)
               .all()), "sparse_optim: dedup_rows' sums on the card off "
          "the CPU's beyond 1e-5 of their absolute sums")
    srs.append(sr)
  res = {}
  for name in ("sgd", "adagrad", "momentum", "adam"):
    t0 = time.perf_counter()
    got = {}
    for dev in ("cuda", "cpu"):
      opt = ops.sparse_optimizer(name, lambda c: 0.05 * (1.0 + c))
      table = table0.to(dev).clone()
      st = opt.init(table)
      for sr in srs:
        table, st = opt.apply(table, st, ops.SparseRows(sr.ids.to(dev),
                                                        sr.rows.to(dev)))
      got[dev] = (table, st)
    torch.cuda.synchronize()
    (tc, sc), (tp, sp) = got["cuda"], got["cpu"]
    err = (tc.cpu() - tp).abs().max().item()
    check(torch.allclose(tc.cpu(), tp, rtol=1e-5, atol=1e-6),
          f"sparse_optim {name}: the card's table is {err} off the CPU's")
    for field, v in sc._asdict().items():
      if isinstance(v, torch.Tensor):
        check(torch.allclose(v.cpu(), getattr(sp, field), rtol=1e-5,
                             atol=1e-6), f"sparse_optim {name}: state "
              f"{field} differs from the CPU's")
      else:
        check(v == getattr(sp, field) == 2, f"sparse_optim {name}: count")
    moved = (tc != table0).any(dim=1).float().mean().item()
    check(moved > 0, f"sparse_optim {name}: no row moved")
    res[name] = {"max_abs_err": err, "rows_moved_share": moved,
                 "wall_s": time.perf_counter() - t0}
  got = read_counts()
  check(got == expect(), f"sparse_optim: launches {got}, expected none")
  emit({"phase": "sparse_optim", "rows": rows, "width": D, "ids": n,
        "steps": 2, "by_optimizer": res, "launches": got})
  del table0, grads, ids, srs
  torch.cuda.empty_cache()
  return got


def _table_rows(torch, plan, cats, seed: int):
  """Sampled physical rows of the plan's first sparse class that the
  batch touches (``hit``) and does not (``miss``), ``ROWS_SAMPLED`` each
  (one-hot ids: one logical row a physical row at width 128)."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  key, name, rows = first_sparse_class(plan)
  touched = torch.zeros((rows,), dtype=torch.bool, device="cuda")
  for bk, v in DistributedLookup(plan).route_ids(cats).items():
    if bk.class_key == key:
      v = v.reshape(-1)
      touched[v[(v >= 0) & (v < rows)].long()] = True
  pick = torch.Generator(device="cuda").manual_seed(seed)
  hit = torch.nonzero(touched).squeeze(1)
  miss = torch.nonzero(~touched).squeeze(1)
  hit = hit[torch.randperm(hit.numel(), generator=pick,
                           device="cuda")[:ROWS_SAMPLED]]
  miss = miss[torch.randperm(miss.numel(), generator=pick,
                             device="cuda")[:ROWS_SAMPLED]]
  return name, hit, miss


def phase_train_bf16_adam(torch, smi: str) -> dict:
  """``train_bf16_adam``: ``bench.py``'s step (26 Criteo-1TB tables of
  width 128, ``dense_row_threshold=4096``, one-hot ids, f32 compute, B =
  65,536) on bf16 tables under ``adam_rule(ADAM_LR)`` (384 lanes a row:
  the table and both moments), ``training.Adam(ADAM_LR)`` on the MLPs and
  the dense-class tables. The full vocabulary would need 187,767,399 rows
  x 384 lanes x 2 B = 144 GB, so every table is cut by ``ADAM_VOCAB_CUT``
  (3: 48.07 GB, ``train_bf16``'s bytes). Checks K1's bf16 form once per
  sparse class and step, K2 once each way, K6 never (a bf16 stream takes
  the plain delta, as in the JAX package), finite losses, sampled rows the
  batch does not touch bit-equal with their moment lanes, touched rows
  moved. Returns each kernel's launches."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import adam_rule
  from distributed_embeddings_torch.training import (
      Adam,
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  vocab = [max(4, v // ADAM_VOCAB_CUT) for v in CRITEO_1TB_VOCAB]
  emit({"phase": "train_bf16_adam_cut", "vocab_cut": ADAM_VOCAB_CUT,
        "why": "the full Criteo-1TB vocabulary under Adam's 384 bf16 lanes "
               "a row is 144 GB; cut by 3 it is 48.07 GB, train_bf16's "
               "bytes, on this 80 GB card"})
  plan = train_plan(vocab, buffer_elements=None)
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rule = adam_rule(ADAM_LR)
  dense = functools.partial(Adam, lr=ADAM_LR)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), dense,
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda",
      dtype=torch.bfloat16)
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  table_bytes = sum(t.numel() * t.element_size()
                    for part in ("fused", "emb_dense")
                    for t in state[part].values())
  numerical, cats, labels = _train_batch(torch, vocab, TRAIN_BATCH, SEED)
  name, hit, miss = _table_rows(torch, plan, cats, SEED + 2)
  buf = state["fused"][name]
  check(buf.shape[1] == 3 * D, f"train_bf16_adam: {buf.shape[1]} lanes a "
        "row, not 384")
  miss_rows = buf[miss].clone()
  step = make_sparse_train_step(model, plan, bce_loss, dense, rule)
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows_bf16=n_sparse)
  totals = expect()
  ms, losses, changed = [], [], []
  for i in range(TRAIN_WARMUP + TRAIN_TIMED):
    hit_rows = buf[hit, :D].clone()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, numerical, cats, labels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = read_counts()
    check(got == want, f"train_bf16_adam step {i}: launches {got}, "
          f"expected {want}")
    add_counts(totals, got)
    if i >= TRAIN_WARMUP:
      ms.append((t1 - t0) * 1e3)
    losses.append(float(loss))
    check(np.isfinite(losses[-1]), f"train_bf16_adam step {i}: loss "
          f"{losses[-1]}")
    check(torch.equal(buf[miss], miss_rows), f"train_bf16_adam step {i}: "
          "rows the batch does not touch changed (table or moment lanes)")
    changed.append((buf[hit, :D] != hit_rows).any(dim=1).float().mean()
                   .item())
  check(max(changed) > 0.0, "train_bf16_adam: no sampled touched row moved")
  med = statistics.median(ms)
  emit({"phase": "train_bf16_adam", "card": smi, "batch": TRAIN_BATCH,
        "vocab": f"Criteo-1TB / {ADAM_VOCAB_CUT}", "rows": int(sum(vocab)),
        "lanes_per_row": 3 * D, "sparse_classes": n_sparse,
        "table_bytes": table_bytes, "compute": "f32", "rule": "adam",
        "lr": ADAM_LR, "dense_optimizer": "training.Adam",
        "init_s": init_s, "step_ms": ms, "step_ms_median": med,
        "samples_per_s": TRAIN_BATCH / (med / 1e3),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": want, "launches": totals, "losses": losses,
        "touched_rows_table_lanes_moved_share": changed,
        "untouched_rows_bit_equal": True})
  del state, buf, step, hit, miss, miss_rows, numerical, cats, labels
  torch.cuda.empty_cache()
  return totals


def bf16_twin_close(torch, got: dict, want: dict, before: dict,
                    ulps: int) -> dict:
  """``got`` against ``want`` (``touched_now``'s tensors after two arms of
  one step from ``before``): each cell within ``ulps`` bf16 ulps of its
  larger magnitude (f32 tensors: ``ulps * 2^-24`` of max(|cell|, 1)),
  plus ``TWIN_UPDATE_SHARE`` of its tensor's largest update in ``want``
  (the arms round their bags differently, so their gradients differ by a
  share of a gradient); the worst error, the worst share and the cells
  that differ."""
  worst, worst_share, differ, ok = 0.0, 0.0, 0, True
  for k, w in want.items():
    g, wf = got[k].float(), w.float()
    d = (g - wf).abs()
    differ += int((d > 0).sum())
    if not d.numel():
      continue
    worst = max(worst, float(d.max()))
    if w.dtype == torch.bfloat16:
      m = torch.maximum(g.abs(), wf.abs()).clamp_min(2.0 ** -126)
      lim = ulps * torch.exp2(torch.floor(torch.log2(m)) - 7)
    else:
      lim = ulps * 2.0 ** -24 * wf.abs().clamp_min(1.0)
    moved = float((wf - before[k].float()).abs().max())
    share = float((d - lim).clamp(min=0).max()) / max(moved, 1e-30)
    worst_share = max(worst_share, share)
    ok = ok and share <= TWIN_UPDATE_SHARE
  return {"max_abs_err": worst, "max_update_share": worst_share,
          "cells_differing": differ, "within": ok}


def phase_train_bf16_ragged(torch, smi: str) -> dict:
  """``train_bf16_ragged``: the multi-hot Criteo mix of ``train_ragged``
  (:func:`ragged_batch`, B = 65,536) on the full Criteo-1TB vocabulary in
  bf16 (48.07 GB), ``combiner='sum'``, SGD ``TRAIN_LR``. The tables are
  drawn anew: the ragged plan's classes carry ``combiner='sum'`` (other
  class names than ``train_bf16``'s) and the card does not hold two such
  states. One ragged step and one on its padded twin from one state (the
  touched rows put back between them): the losses within 2^-8 and every
  touched row, dense-class table and dense param within
  :func:`bf16_twin_close`'s bound (the ragged bag adds each row rounded to
  bf16, XLA's ``segment_sum``, the padded bag sums in f32 and rounds
  once); then
  ``RAGGED_STEPS`` timed steps, K1's bf16 form as :func:`k1_launches`
  predicts (chunked above 4,194,304 occurrences a class), K2 once each
  way, finite losses, untouched sampled rows bit-equal. Returns each
  kernel's launches."""
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  vocab = list(CRITEO_1TB_VOCAB)
  b = TRAIN_BATCH
  plan = ragged_plan(vocab, batch_hint=b, buffer_elements=None)
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  engine = DistributedLookup(plan)
  layouts = engine.fused_layouts(rule)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda",
      dtype=torch.bfloat16)
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  table_bytes = sum(t.numel() * t.element_size()
                    for part in ("fused", "emb_dense")
                    for t in state[part].values())
  gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
  batch = ragged_batch(torch, vocab, b, gen, "cuda")
  twin = padded_twin(batch[1])
  ids_all = engine.route_ids(batch[1])
  k1, chunked, _ = k1_launches(plan, ids_all)
  k1_twin, _, _ = k1_launches(plan, engine.route_ids(twin))
  want = expect(interact_fwd=1, interact_bwd=1, apply_rows_bf16=k1)
  want_twin = expect(interact_fwd=1, interact_bwd=1,
                     apply_rows_bf16=k1_twin)
  rows = touched_rows(torch, plan, layouts, ids_all)
  del ids_all
  name0 = next(iter(rows))
  buf0 = state["fused"][name0]
  hit = torch.zeros((buf0.shape[0],), dtype=torch.bool, device="cuda")
  hit[rows[name0]] = True
  pick = torch.Generator(device="cuda").manual_seed(SEED + 2)
  miss = torch.nonzero(~hit).squeeze(1)
  miss = miss[torch.randperm(miss.numel(), generator=pick,
                             device="cuda")[:ROWS_SAMPLED]]
  del hit
  miss_rows = buf0[miss].clone()
  step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                rule)
  totals = expect()

  def counted(fn, want_, what):
    reset_counts()
    out = fn()
    got = read_counts()
    check(got == want_, f"train_bf16_ragged {what}: launches {got}, "
          f"expected {want_}")
    add_counts(totals, got)
    return out

  numerical, cats, labels = batch
  snap = snapshot(torch, state, rows)
  before = touched_now(state, rows)
  res = counted(lambda: step(state, numerical, cats, labels), want,
                "ragged step")
  after = touched_now(state, rows)
  restore(torch, state, rows, snap)
  del snap
  res_t = counted(lambda: step(state, numerical, twin, labels), want_twin,
                  "padded twin step")
  close = bf16_twin_close(torch, after, touched_now(state, rows), before,
                          RAGGED_BF16_TWIN_ULPS)
  twin_losses = (float(res[1]), float(res_t[1]))
  check(close["within"] and abs(twin_losses[0] - twin_losses[1])
        <= 2.0 ** -8 * max(1.0, abs(twin_losses[1])),
        f"train_bf16_ragged: the ragged step left its padded twin by "
        f"{close['max_abs_err']} (losses {twin_losses})")
  del after, before, twin
  torch.cuda.empty_cache()
  ms, losses = [], []
  for i in range(RAGGED_STEPS):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = counted(lambda: step(state, *batch), want, f"step {i}")
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    losses.append(float(loss))
    check(losses[-1] == losses[-1] and abs(losses[-1]) < float("inf"),
          f"train_bf16_ragged step {i}: loss {losses[-1]}")
  check(torch.equal(buf0[miss], miss_rows),
        "train_bf16_ragged: rows the batch does not touch changed")
  med = statistics.median(ms)
  emit({"phase": "train_bf16_ragged", "card": smi, "batch": b,
        "vocab": "Criteo-1TB, full", "rows": int(sum(vocab)),
        "table_bytes": table_bytes, "compute": "f32",
        "tables": "drawn anew (the ragged plan's class names differ from "
                  "train_bf16's; the card holds one such state)",
        "multi_hot_sizes": list(MULTI_HOT_SIZES),
        "occurrences_per_step": ragged_live(batch[1], b), "init_s": init_s,
        "step_ms": ms, "step_ms_median": med,
        "samples_per_s": b / (med / 1e3),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": want, "chunked_apply_launches": chunked,
        "twin_launches_per_step": want_twin, "losses": losses,
        "vs_padded_twin": {"loss": twin_losses[0],
                           "twin_loss": twin_losses[1],
                           "bound_ulps": RAGGED_BF16_TWIN_ULPS,
                           "bound_update_share": TWIN_UPDATE_SHARE,
                           **close},
        "untouched_rows_bit_equal": True})
  del state, step, batch, buf0, miss, miss_rows
  torch.cuda.empty_cache()
  return totals


def phase_rules_vs_f32(torch, smi: str) -> dict:
  """``train_bf16_rules_vs_f32``: the train cell (x 1/16) under the
  momentum rule (SGD 0.1 on the dense side) and under ``adam_rule``
  (``training.Adam`` on the dense side, ``ADAM_LR``), each from one bf16
  state and from an f32 state holding the same values:
  ``NARROW_VS_STEPS`` steps on the same batches, the losses within
  ``NARROW_LOSS_RTOL``; K1's bf16 form on the bf16 states, its f32 form
  on the others, never K6 (the rows are 256 and 384 lanes). Returns each
  kernel's launches on the bf16 states."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import (
      adam_rule,
      momentum_rule,
  )
  from distributed_embeddings_torch.training import (
      Adam,
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  vocab = criteo_vocab()
  plan = train_plan()
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  model = DLRM(vocab, D, tables=False, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  batches = [_train_batch(torch, vocab, TRAIN_BATCH, SEED + 80 + i)
             for i in range(NARROW_VS_STEPS)]
  totals = expect()
  out = {}
  for rule, dense in ((momentum_rule(TRAIN_LR), sgd_factory(torch)),
                      (adam_rule(ADAM_LR),
                       functools.partial(Adam, lr=ADAM_LR))):
    narrow = init_sparse_state_direct(
        plan, rule, model.state_dict(), dense,
        torch.Generator(device="cuda").manual_seed(SEED), device="cuda",
        dtype=torch.bfloat16)
    wide = {"fused": {k: v.float() for k, v in narrow["fused"].items()},
            "emb_dense": {k: v.detach().float()
                          for k, v in narrow["emb_dense"].items()},
            "dense": {k: v.detach().clone()
                      for k, v in narrow["dense"].items()},
            "step": 0}
    losses = {}
    for tag, state, kernel in (("bf16", narrow, "apply_rows_bf16"),
                               ("f32", wide, "apply_rows")):
      step = make_sparse_train_step(model, plan, bce_loss, dense, rule)
      want = expect(interact_fwd=1, interact_bwd=1, **{kernel: n_sparse})
      losses[tag] = []
      for i, batch in enumerate(batches):
        reset_counts()
        state, loss = step(state, *batch)
        got = read_counts()
        check(got == want, f"train_bf16_rules_vs_f32 {rule.name} {tag} step "
              f"{i}: launches {got}, expected {want}")
        if tag == "bf16":
          add_counts(totals, got)
        losses[tag].append(float(loss))
      check(np.isfinite(losses[tag]).all(), f"train_bf16_rules_vs_f32 "
            f"{rule.name} {tag}: losses {losses[tag]}")
      del step, state
    del narrow, wide
    torch.cuda.empty_cache()
    err = np.abs(np.asarray(losses["bf16"]) - np.asarray(losses["f32"]))
    rel = float((err / np.abs(np.asarray(losses["f32"]))).max())
    check(rel <= NARROW_LOSS_RTOL, f"train_bf16_rules_vs_f32 {rule.name}: "
          f"losses differ by {rel} relative (> {NARROW_LOSS_RTOL})")
    out[rule.name] = {"losses_bf16": losses["bf16"],
                      "losses_f32": losses["f32"], "loss_max_rel_err": rel}
  emit({"phase": "train_bf16_rules_vs_f32", "card": smi,
        "batch": TRAIN_BATCH, "vocab_scale": "1/16",
        "steps": NARROW_VS_STEPS, "loss_rtol": NARROW_LOSS_RTOL,
        "by_rule": out, "launches_bf16": totals})
  del batches
  torch.cuda.empty_cache()
  return totals


def _hand_loop_run(torch, device: str) -> tuple:
  """``HAND_LOOP_STEPS`` steps of a hand-written loop (``zero_grad``,
  ``loss.backward()``, ``training.Adam(ADAM_LR).step()``) on a
  ``DistributedEmbedding`` of ``HAND_LOOP_VOCAB`` at width ``D`` with its
  class buffers in bf16 and a linear head, on ``device``; the weights and
  batches drawn on the CPU from ``SEED``. Returns the losses and the class
  buffers as f32 numpy. No kernel runs: the head has no interaction."""
  from torch import nn

  from distributed_embeddings_torch.layers import DistributedEmbedding
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.models import bce_loss
  from distributed_embeddings_torch.training import Adam

  class HandLoop(nn.Module):

    def __init__(self):
      super().__init__()
      self.embeddings = DistributedEmbedding(
          [TableConfig(input_dim=v, output_dim=D) for v in HAND_LOOP_VOCAB],
          dense_row_threshold=HAND_LOOP_THRESHOLD, device="cpu",
          generator=torch.Generator().manual_seed(SEED))
      self.head = nn.Linear(13 + D * len(HAND_LOOP_VOCAB), 1)

    def forward(self, numerical, cats):
      x = torch.cat([numerical] + list(self.embeddings(cats)), dim=1)
      return self.head(x)[:, 0]

  torch.manual_seed(SEED)
  model = HandLoop().to(device)  # drawn on the CPU
  kinds = {k.kind for k in model.embeddings.plan.classes.values()}
  check(kinds == {"dense", "sparse"}, f"hand loop: class kinds {kinds}")
  model.embeddings.to(torch.bfloat16)
  opt = Adam(model.parameters(), lr=ADAM_LR)
  gen = torch.Generator().manual_seed(SEED + 7)
  losses = []
  for _ in range(HAND_LOOP_STEPS):
    numerical = torch.randn((HAND_LOOP_BATCH, 13), generator=gen)
    cats = [torch.randint(0, v, (HAND_LOOP_BATCH,), generator=gen)
            for v in HAND_LOOP_VOCAB]
    labels = torch.randint(0, 2, (HAND_LOOP_BATCH,), generator=gen).float()
    opt.zero_grad()
    loss = bce_loss(model(numerical.to(device),
                          [c.to(device) for c in cats]), labels.to(device))
    loss.backward()
    opt.step()
    losses.append(float(loss.detach()))
  return losses, {n: p.detach().float().cpu().numpy()
                  for n, p in model.embeddings.class_params().items()}


def _hand_loop_vs_cpu(torch) -> dict:
  """The hand-written loop on the card against the same loop on the CPU
  (see ``HAND_LOOP_ULPS``): per class buffer the share of cells within
  ``HAND_LOOP_ULPS`` bf16 ulps and the worst cell in learning rates."""
  import numpy as np

  card_losses, card = _hand_loop_run(torch, "cuda")
  cpu_losses, cpu = _hand_loop_run(torch, "cpu")
  out = {"losses_card": card_losses, "losses_cpu": cpu_losses,
         "by_buffer": {}}
  check(np.allclose(card_losses, cpu_losses, rtol=1e-5, atol=1e-6),
        f"hand loop: card losses {card_losses}, CPU {cpu_losses}")
  for name, want in cpu.items():
    got = card[name]
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), ADAM_LR)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    diff = np.abs(got - want)
    share = float((diff <= HAND_LOOP_ULPS * ulp).mean())
    worst_lr = float(diff.max() / ADAM_LR)
    out["by_buffer"][name] = {
        "cells": int(diff.size), "within_ulps_share": share,
        "bit_equal_share": float((got == want).mean()),
        "worst_in_lr": worst_lr}
    check(share >= HAND_LOOP_SHARE, f"hand loop {name}: {share:.4%} of the "
          f"cells within {HAND_LOOP_ULPS} ulps of the CPU's")
    check(bool((diff <= 2 * ADAM_LR * HAND_LOOP_STEPS
                + HAND_LOOP_ULPS * ulp).all()),
          f"hand loop {name}: a cell {worst_lr} learning rates off")
  return out


def phase_train_dense_bf16(torch, smi: str) -> dict:
  """``train_dense_bf16``: the README Quick start's dense-autodiff step
  (``DLRM`` owning its ``DistributedEmbedding``, ``make_train_step``) on
  the train cell (26 tables x 1/16, about 3.0 GB of bf16 class buffers)
  with its class buffers in bf16 under ``training.Adam(ADAM_LR)``, against
  its f32 twin holding the same values: ``NARROW_VS_STEPS`` steps each on
  the same batches, the losses within ``NARROW_LOSS_RTOL``; K2 once each
  way a step and no K1 (the dense path applies no sparse stream). Returns
  each kernel's launches on the bf16 model."""
  import numpy as np

  from distributed_embeddings_torch import train_golden
  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.training import Adam, make_train_step

  vocab = criteo_vocab()
  plan = train_plan()
  batches = [_train_batch(torch, vocab, TRAIN_BATCH, SEED + 90 + i)
             for i in range(NARROW_VS_STEPS)]
  want = expect(interact_fwd=1, interact_bwd=1)
  totals = expect()
  losses, ms, class_bytes = {}, {}, {}
  torch.cuda.reset_peak_memory_stats()
  for tag in ("bf16", "f32"):
    model = DLRM(vocab, D, dense_row_threshold=4096, batch_hint=TRAIN_BATCH,
                 device="cuda", generator=torch.Generator().manual_seed(SEED),
                 table_generator=torch.Generator(device="cuda")
                 .manual_seed(SEED))
    check(model.embeddings.plan.class_keys == plan.class_keys,
          "train_dense_bf16: the model's plan is not the train plan")
    # both twins hold the bf16-representable values
    model.embeddings.to(torch.bfloat16)
    if tag == "f32":
      model.embeddings.to(torch.float32)
    class_bytes[tag] = sum(p.numel() * p.element_size() for p in
                           model.embeddings.class_params().values())
    opt = Adam(model.parameters(), lr=ADAM_LR)
    step = make_train_step(train_golden.dense_loss, opt, model, plan=plan,
                           device="cuda")
    losses[tag], ms[tag] = [], []
    for i, batch in enumerate(batches):
      reset_counts()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      loss = step(*batch)
      torch.cuda.synchronize()
      ms[tag].append((time.perf_counter() - t0) * 1e3)
      got = read_counts()
      check(got == want, f"train_dense_bf16 {tag} step {i}: launches {got}, "
            f"expected {want}")
      if tag == "bf16":
        add_counts(totals, got)
      losses[tag].append(float(loss))
    check(np.isfinite(losses[tag]).all(), f"train_dense_bf16 {tag}: losses "
          f"{losses[tag]}")
    if tag == "bf16":
      check(all(p.dtype == torch.bfloat16 for p in
                model.embeddings.class_params().values()),
            "train_dense_bf16: a class buffer left bf16")
    del model, opt, step
    torch.cuda.empty_cache()
  err = np.abs(np.asarray(losses["bf16"]) - np.asarray(losses["f32"]))
  rel = float((err / np.abs(np.asarray(losses["f32"]))).max())
  check(rel <= NARROW_LOSS_RTOL, f"train_dense_bf16: losses differ by {rel} "
        f"relative (> {NARROW_LOSS_RTOL})")
  hand_loop = _hand_loop_vs_cpu(torch)
  emit({"phase": "train_dense_bf16", "card": smi, "batch": TRAIN_BATCH,
        "vocab_scale": "1/16", "steps": NARROW_VS_STEPS,
        "optimizer": "training.Adam", "lr": ADAM_LR,
        "class_bytes": class_bytes, "step_ms_median": {
            t: statistics.median(v) for t, v in ms.items()},
        "losses_bf16": losses["bf16"], "losses_f32": losses["f32"],
        "loss_max_rel_err": rel, "loss_rtol": NARROW_LOSS_RTOL,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": want,
        "hand_loop_vs_cpu": {"vocab": HAND_LOOP_VOCAB,
                             "batch": HAND_LOOP_BATCH,
                             "steps": HAND_LOOP_STEPS,
                             "ulps": HAND_LOOP_ULPS,
                             "share": HAND_LOOP_SHARE, **hand_loop}})
  del batches
  torch.cuda.empty_cache()
  return totals


def phase_train_bf16_rules_golden(torch) -> None:
  """The committed JAX rules golden
  (``tests/data/torch_train_bf16_rules_golden.npz``: bf16 buffers under
  ``adam_rule``, ``optax.adam`` on the dense side, one ragged input)
  replayed on the card within ``train_golden.compare_bf16``'s bounds with
  ``RULES_UPDATE_TOL`` (every bf16 cell) and ``RULES_DENSE_CELL_SHARE``
  (the dense params' cells)."""
  from distributed_embeddings_torch import train_golden
  golden = train_golden.load(train_golden.BF16_RULES_PATH)
  losses, got = train_golden.replay_bf16_rules(golden, device="cuda")
  try:
    worst = train_golden.compare_bf16(golden, losses, got,
                                      train_golden.RULES_UPDATE_TOL)
  except AssertionError as exc:
    raise SmokeFailure(f"bf16 rules golden: {exc}") from exc
  # the bound refuses a faulty Adam on the card too: b2 = 0.99 in both
  bad_losses, bad = train_golden.replay_bf16_rules(
      golden, device="cuda", adam_kw=RULES_PLANTED_FAULT)
  try:
    train_golden.compare_bf16(golden, bad_losses, bad,
                              train_golden.RULES_UPDATE_TOL)
    planted = None
  except AssertionError as exc:
    planted = str(exc).splitlines()[0]
  check(planted is not None, f"bf16 rules golden: Adam with "
        f"{RULES_PLANTED_FAULT} passed the card bound")
  # the second bound: the same replay against the CPU emulation of the
  # card's arithmetic (committed), which sees a fault as small as b2=0.998
  emulated = train_golden.load(train_golden.RULES_CARD_PATH)
  try:
    card = train_golden.compare_card_emulation(emulated, losses, got)
  except AssertionError as exc:
    raise SmokeFailure(f"bf16 rules golden, card emulation: {exc}") from exc
  small_losses, small = train_golden.replay_bf16_rules(
      golden, device="cuda", adam_kw=RULES_SMALL_FAULT)
  small_shares = train_golden.compare_card_emulation(
      emulated, small_losses, small, moment_share=0.0)
  try:
    train_golden.compare_card_emulation(emulated, small_losses, small)
    small_refused = None
  except AssertionError as exc:
    small_refused = str(exc).splitlines()[0]
  check(small_refused is not None, f"bf16 rules golden: Adam with "
        f"{RULES_SMALL_FAULT} passed the card-emulation bound: "
        f"{small_shares}")
  emit({"phase": "train_bf16_rules_golden", "losses": losses,
        "want_losses": [float(v) for v in golden["losses"]], **worst,
        "loss_tol": train_golden.LOSS_TOL,
        "bf16_ulps": train_golden.BF16_ULPS,
        "update_tol": train_golden.RULES_UPDATE_TOL,
        "dense_cell_share": train_golden.RULES_DENSE_CELL_SHARE,
        "planted_fault": RULES_PLANTED_FAULT, "planted_refused_by": planted,
        "card_emulation": card,
        "card_emulation_ulps": train_golden.RULES_CARD_ULPS,
        "card_emulation_moment_share": train_golden.RULES_CARD_MOMENT_SHARE,
        "small_fault": RULES_SMALL_FAULT, "small_fault_shares": small_shares,
        "small_fault_refused_by": small_refused})


def _w4_narrow_rules(torch, mesh, model, batch) -> dict:
  """``world4_bf16``'s slice-20 runs on every rank (the world-4 plan x
  1/16 in bf16): the dedup exchange (``dedup_exchange=True``) under the
  momentum rule in ``'none'``, ``'pipelined'`` and ``'fused'`` from one
  state (``W4_RULES_STEPS`` steps each: the first step's losses equal and
  its buffers bit-equal to ``'none'``'s off duplicate rows; K4's bf16
  form as :func:`k4_forward_launches` predicts per bucket, round and chunk
  of the unique capacity); one ``adam_rule`` step under ``'fused'`` (K4's
  bf16 form on 384-lane rows); one SGD step of the ragged cell
  (:func:`w4_ragged_plan`, the multi-hot Criteo mix as ``RaggedIds``)
  under ``'fused'``, K4 and K1 as predicted from the batch. Returns the
  runs' numbers and launches."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import (
      adam_rule,
      momentum_rule,
      sgd_rule,
  )
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      ragged_hotness,
  )
  from distributed_embeddings_torch.training import (
      Adam,
      init_sparse_state_direct,
      make_sparse_train_step,
      shard_batch,
  )

  dev = mesh.device
  out = {"runs": {}}

  def fresh(plan, rule, dense, mdl):
    return init_sparse_state_direct(
        plan, rule, mdl.state_dict(), dense,
        torch.Generator(device=dev).manual_seed(SEED + 1 + mesh.rank),
        mesh=mesh, dtype=torch.bfloat16)

  def timed(fn):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(dev)
    return res, (time.perf_counter() - t0) * 1e3

  rule = momentum_rule(TRAIN_LR)
  base = None
  for overlap in ("none", "pipelined", "fused"):
    _, plan = world4_plan("gloo", overlap, dedup_exchange=True)
    state, init_ms = timed(lambda: fresh(plan, rule, sgd_factory(torch),
                                         model))
    touch = _w4_touch_counts(torch, plan, mesh, batch[1], state)
    step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                  rule, mesh=mesh)
    want = expect(gather_rows_bf16=k4_forward_launches(plan, None, rule),
                  apply_rows_bf16=len(state["fused"]), interact_fwd=1,
                  interact_bwd=1)
    totals = expect()
    losses, ms = [], []
    for i in range(W4_RULES_STEPS):
      reset_counts()
      (state, loss), t = timed(lambda: step(state, *batch))
      ms.append(t)
      got = read_counts()
      check(got == want, f"world4_bf16 dedup {overlap} rank {mesh.rank} "
            f"step {i}: launches {got}, expected {want}")
      add_counts(totals, got)
      losses.append(float(loss))
      check(np.isfinite(losses[-1]), f"world4_bf16 dedup {overlap}: loss "
            f"{losses[-1]}")
      if i == 0:
        first = {k: v.clone() for k, v in state["fused"].items()}
    if base is None:
      base = (losses[0], first)
    else:
      check(losses[0] == base[0], f"world4_bf16 dedup: {overlap}'s first "
            f"loss {losses[0]} != none's {base[0]}")
      for name, buf in first.items():
        other = base[1][name]
        bad = (buf != other).any(dim=1)
        check(not bool((bad & (touch[name] < 2)).any().item()),
              f"world4_bf16 dedup {overlap} {name}: a row fewer than two "
              "ids hit differs from none's")
        if bool(bad.any().item()):
          a, b = buf[bad].float(), other[bad].float()
          lim = touch[name][bad][:, None].float() * BF16_DUP_ULP * \
              torch.maximum(a.abs(), b.abs()) + 2.0 ** -24
          check(bool(((a - b).abs() <= lim).all().item()),
                f"world4_bf16 dedup {overlap} {name}: duplicate rows off "
                "none's beyond hits * 3 * 2^-8")
    out["runs"][f"dedup_{overlap}"] = {"losses": losses, "step_ms": ms,
                                       "init_ms": init_ms,
                                       "launches": totals,
                                       "launches_per_step": want}
    del first, touch, step, state
    torch.cuda.empty_cache()
  del base
  # one Adam step under the fused schedule
  ada = adam_rule(ADAM_LR)
  _, plan = world4_plan("gloo", "fused")
  dense = functools.partial(Adam, lr=ADAM_LR)
  state = fresh(plan, ada, dense, model)
  step = make_sparse_train_step(model, plan, bce_loss, dense, ada, mesh=mesh)
  reset_counts()
  (state, loss), adam_ms = timed(lambda: step(state, *batch))
  got = read_counts()
  want = expect(gather_rows_bf16=k4_forward_launches(plan, None, ada),
                apply_rows_bf16=len(state["fused"]), interact_fwd=1,
                interact_bwd=1)
  check(got == want, f"world4_bf16 adam rank {mesh.rank}: launches {got}, "
        f"expected {want}")
  check(np.isfinite(float(loss)), "world4_bf16 adam: loss not finite")
  check(all(t.shape[-1] == 3 * D for t in state["fused"].values()),
        "world4_bf16 adam: a buffer without Adam's 384 lanes")
  out["adam"] = {"loss": float(loss), "step_ms": adam_ms, "launches": got}
  del state, step
  torch.cuda.empty_cache()
  # one SGD step of the ragged cell under the fused schedule
  vocab, plan = w4_ragged_plan("gloo", "fused")
  rmodel = DLRM(vocab, D, tables=False, device=dev,
                generator=torch.Generator().manual_seed(SEED))
  srule = sgd_rule(TRAIN_LR)
  state = fresh(plan, srule, sgd_factory(torch), rmodel)
  rbatch = shard_batch(ragged_batch(
      torch, vocab, W4_BATCH // WORLD, torch.Generator().manual_seed(
          SEED + 40), "cpu", blocks=WORLD), mesh)
  codes = [ragged_hotness(c) for c in rbatch[1]]
  k1, _, _ = k1_launches(plan, DistributedLookup(plan, mesh=mesh)
                         .route_ids(rbatch[1]))
  want = expect(gather_rows_bf16=k4_forward_launches(plan, codes, srule),
                apply_rows_bf16=k1, interact_fwd=1, interact_bwd=1)
  step = make_sparse_train_step(rmodel, plan, bce_loss, sgd_factory(torch),
                                srule, mesh=mesh)
  reset_counts()
  (state, loss), ragged_ms = timed(lambda: step(state, *rbatch))
  got = read_counts()
  check(got == want, f"world4_bf16 ragged rank {mesh.rank}: launches "
        f"{got}, expected {want}")
  check(np.isfinite(float(loss)), "world4_bf16 ragged: loss not finite")
  out["ragged"] = {"loss": float(loss), "step_ms": ragged_ms,
                   "launches": got}
  del state, step, rbatch, rmodel
  torch.cuda.empty_cache()
  return out


def kernel_entry(name, row, launches, by_path) -> dict:
  source = BF16_FORMS.get(name, name)
  return {"name": name, "route": "cuda", "source": f"{CSRC}/{source}.cu",
          "replaces": REPLACES[name], "launches": launches,
          "launches_by_path": by_path, "max_abs_err": row["max_abs_err"],
          "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
          "library_ms": row["library_ms"]}


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this smoke "
          "runs on an NVIDIA H100 only", file=sys.stderr)
    return 2
  from distributed_embeddings_torch.ops import _build
  from distributed_embeddings_torch.ops import cuda_apply as ca
  from distributed_embeddings_torch.ops import cuda_delta as cd
  from distributed_embeddings_torch.ops import cuda_exchange as cx
  from distributed_embeddings_torch.ops import cuda_interact as ci
  from distributed_embeddings_torch.ops import cuda_layout as cl
  from distributed_embeddings_torch.serving import golden

  # f32 products stay f32 (PyTorch's defaults, stated)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = nvidia_smi()
  cap = torch.cuda.get_device_capability(0)
  emit({"phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0), "capability": list(cap),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda})
  check(cap == (9, 0), f"compute capability {cap}, not (9, 0)")
  check(set(COUNTERS) == set(_build.KERNELS) | set(BF16_FORMS),
        f"launch counters for {sorted(COUNTERS)}, kernels "
        f"{sorted(_build.KERNELS)} and the bf16 forms {sorted(BF16_FORMS)}")

  t0 = time.perf_counter()
  _build.build_all(_build.KERNELS)
  emit({"phase": "build", "kernels": list(_build.KERNELS),
        "seconds": time.perf_counter() - t0})
  for name in _build.KERNELS:
    emit({"phase": "build", "kernel": name,
          "ptxas": ptxas_report(_build.BUILD_LOG[name])})

  flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
  warm_up(torch)
  rows = {"interact_fwd": phase_kernel_fwd(torch, ci, flush),
          "interact_bwd": phase_kernel_bwd(torch, ci, flush)}
  torch.cuda.empty_cache()
  rows["interact_flat_fwd"] = phase_kernel_flat_fwd(torch, ci, flush)
  rows["interact_flat_bwd"] = phase_kernel_flat_bwd(torch, ci, flush)
  torch.cuda.empty_cache()
  rows["apply_rows"] = phase_kernel_apply(
      torch, ca, flush, first_sparse_class(train_plan())[2])
  torch.cuda.empty_cache()
  phase_kernel_apply_zoo(torch, ca, flush)
  rows["apply_rows_bf16"] = phase_kernel_apply_bf16(
      torch, ca, flush, first_sparse_class(train_plan())[2])
  phase_kernel_apply_bf16_rules(torch, ca, flush,
                                first_sparse_class(train_plan())[2])
  rows["gather_rows"] = phase_kernel_gather(torch, cx, flush)
  rows["gather_rows_bf16"] = phase_kernel_gather_bf16(torch, cx, flush)
  rows["gather_send_rows"] = phase_kernel_send(torch, cx, flush)
  rows["build_delta_rows"] = phase_kernel_delta(torch, cd, flush)
  phase_kernel_sliced(torch, ca, cd, flush)
  rows["row_major"] = phase_kernel_layout(torch, cl, flush)
  phase_fp8_codec(torch, flush)
  phase_unique_map(torch, flush)
  del flush
  torch.cuda.empty_cache()
  phase_golden(torch, golden)
  phase_train_golden(torch)
  phase_zoo_golden(torch)
  phase_dense_golden(torch)
  phase_ragged_golden(torch)
  phase_train_bf16_golden(torch)
  phase_train_bf16_rules_golden(torch)

  # every path's counts, each read from all nine counters just after the
  # path ran with them set to 0 just before
  setup = serve_setup(torch)
  by_path = {}
  by_path["serve"], frozen_preds = phase_serve(torch, ci, smi, setup)
  by_path["serve_artifact"], eng = phase_serve_artifact(torch, smi, setup,
                                                        frozen_preds)
  by_path["serve_batcher"] = phase_serve_batcher(torch, smi, eng,
                                                 setup["vocab"])
  del eng, frozen_preds
  torch.cuda.empty_cache()
  by_path["serve_fp8"] = phase_serve_fp8(torch, smi, setup)
  del setup
  torch.cuda.empty_cache()
  for compute in ("f32", "bf16"):
    by_path[f"train_{compute}"] = phase_train(torch, smi, compute)
  torch.cuda.empty_cache()
  # narrow storage: the full Criteo-1TB vocabulary in bf16 on this card
  by_path["train_bf16_tables"] = phase_train_bf16(torch, smi)
  by_path["train_bf16_vs_f32"] = phase_train_bf16_vs_f32(torch, smi)
  torch.cuda.empty_cache()
  # slice 20: bf16 tables under Adam and with ragged ids at full width,
  # the momentum and Adam rules against their f32 twins, the table-level
  # sparse optimizers
  by_path["train_bf16_adam"] = phase_train_bf16_adam(torch, smi)
  by_path["train_bf16_ragged"] = phase_train_bf16_ragged(torch, smi)
  by_path["train_bf16_rules_vs_f32"] = phase_rules_vs_f32(torch, smi)
  by_path["sparse_optim"] = phase_sparse_optim(torch)
  torch.cuda.empty_cache()
  # tiered storage: f32 tables past the card's memory, host-RAM images
  by_path["tiered_golden"] = phase_tiered_golden(torch)
  by_path["train_tiered"], trained = phase_train_tiered(torch, smi)
  # the host-pass pipeline on the same trainer, store and cell
  by_path["train_tiered_overlap"] = phase_train_tiered_overlap(torch, smi,
                                                               trained)
  del trained["trainer"]
  # tiered serving: the trained store's images frozen behind a hot cache
  by_path["serve_tiered"] = phase_serve_tiered(torch, ci, smi, trained)
  del trained
  torch.cuda.empty_cache()
  by_path["train_tiered_vs_device"] = phase_train_tiered_vs_device(torch,
                                                                   smi)
  by_path["tiered_ckpt"] = phase_tiered_ckpt(torch, smi)
  torch.cuda.empty_cache()
  by_path["tiered_overlap_vs_serial"] = phase_tiered_overlap_vs_serial(
      torch, smi)
  by_path["serve_tiered_golden"] = phase_serve_tiered_golden(torch)
  setup = serve_tiered_setup(torch)
  by_path["serve_tiered_vs_device"] = phase_serve_tiered_vs_device(
      torch, smi, setup)
  by_path["serve_tiered_artifact"] = phase_serve_tiered_artifact(
      torch, smi, setup)
  del setup
  torch.cuda.empty_cache()
  for compute in ("f32", "bf16"):
    by_path[f"train_dense_{compute}"] = phase_train_dense(torch, smi,
                                                          compute)
  torch.cuda.empty_cache()
  by_path["train_dense_bf16_tables"] = phase_train_dense_bf16(torch, smi)
  torch.cuda.empty_cache()
  phase_dlrm_main(smi)
  by_path["train_ckpt"] = phase_train_ckpt(torch, smi)
  by_path["dlrm_main_sparse"] = phase_dlrm_main_sparse(torch, smi)
  torch.cuda.empty_cache()
  by_path["train_mb"] = phase_train_mb(torch, smi)
  by_path["train_guard"] = phase_train_guard(torch, smi)
  by_path["resilient"] = phase_resilient(torch, smi)
  by_path["dlrm_main_mb"] = phase_dlrm_main_mb(torch, smi)
  torch.cuda.empty_cache()
  by_path["train_ragged"], trained = phase_train_ragged(torch, smi)
  by_path["serve_ragged"] = phase_serve_ragged(torch, smi, trained)
  del trained
  torch.cuda.empty_cache()
  by_path.update(phase_train_zoo(torch, smi))
  by_path["train_zoo_mb"] = phase_train_zoo_mb(torch, smi)
  for path, name in (("train_zoo", "build_delta_rows"),
                     ("train_zoo", "apply_rows"),
                     ("train_zoo_pin", "row_major")):
    check(by_path[path][name] > 0, f"the {path} path never launched {name}")
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  by_path.update(phase_zoo_main(torch, smi))
  emit({"phase": "zoo_main", "wall_s": time.perf_counter() - t0})
  t0 = time.perf_counter()
  phase_lookup_bench(torch, smi)
  emit({"phase": "lookup_bench", "wall_s": time.perf_counter() - t0})
  torch.cuda.empty_cache()
  by_path.update(phase_world4(torch, smi))
  for name in W4_KERNELS:
    check(by_path["train_world4"][name] > 0,
          f"the world-4 path never launched {name}")
  for name in ("interact_fwd", "interact_bwd"):
    check(by_path["train_dense_world4"][name] > 0,
          f"the world-4 dense path never launched {name}")
  for path, name in (("train_bf16_tables", "apply_rows_bf16"),
                     ("train_bf16_vs_f32", "apply_rows_bf16"),
                     ("train_bf16_adam", "apply_rows_bf16"),
                     ("train_bf16_ragged", "apply_rows_bf16"),
                     ("train_bf16_rules_vs_f32", "apply_rows_bf16"),
                     ("train_dense_bf16_tables", "interact_bwd"),
                     ("world4_bf16", "apply_rows_bf16"),
                     ("world4_bf16", "gather_rows_bf16"),
                     ("serve_fp8", "interact_fwd")):
    check(by_path[path][name] > 0, f"the {path} path never launched {name}")
  dlrm_sparse = ("interact_fwd", "interact_bwd", "apply_rows")
  for path, names in (("train_ckpt", dlrm_sparse),
                      ("dlrm_main_sparse", dlrm_sparse),
                      ("world4_ckpt", W4_KERNELS),
                      ("train_mb", dlrm_sparse), ("train_guard", dlrm_sparse),
                      ("resilient", dlrm_sparse),
                      ("dlrm_main_mb", dlrm_sparse),
                      ("train_zoo_mb", ("build_delta_rows", "apply_rows")),
                      ("train_world4_guard", W4_KERNELS),
                      ("train_world4_mb", W4_KERNELS),
                      ("world4_wire", W4_KERNELS),
                      ("train_ragged", dlrm_sparse),
                      ("serve_ragged", ("interact_fwd",)),
                      ("train_zoo_ragged", ("build_delta_rows",
                                            "apply_rows")),
                      ("world4_ragged", W4_KERNELS),
                      ("world4_colslice", W4_KERNELS + ("build_delta_rows",)),
                      ("zoo_world4_plan", ("build_delta_rows",
                                           "apply_rows")),
                      ("tiered_golden", dlrm_sparse + ("build_delta_rows",)),
                      ("train_tiered", dlrm_sparse),
                      ("train_tiered_overlap", dlrm_sparse),
                      ("tiered_overlap_vs_serial", dlrm_sparse),
                      ("world4_elastic", W4_KERNELS),
                      ("world4_ckpt_world1", dlrm_sparse),
                      ("train_tiered_vs_device", dlrm_sparse),
                      ("tiered_ckpt", dlrm_sparse),
                      ("world4_tiered", W4_KERNELS),
                      ("serve_tiered", ("interact_fwd",)),
                      ("serve_tiered_vs_device", ("interact_fwd",)),
                      ("serve_tiered_golden", ("interact_fwd",)),
                      ("serve_tiered_artifact", ("interact_fwd",)),
                      ("world4_serve_tiered", ("interact_fwd",)),
                      ("world4_batcher", ("interact_fwd",))):
    for name in names:
      check(by_path[path][name] > 0, f"the {path} path never launched {name}")

  for path, p in by_path.items():
    check(set(p) == set(COUNTERS), f"the {path} path read the counts of "
          f"{sorted(p)}, not of every kernel")
  emit({"kernels": [
      kernel_entry(name, rows[name],
                   sum(p[name] for p in by_path.values()),
                   {path: p[name] for path, p in by_path.items()})
      for name in list(_build.KERNELS) + list(BF16_FORMS)]})
  print(smi, flush=True)
  emit({"ok": True, "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}})
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  except SmokeFailure as exc:
    print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
    sys.exit(1)
