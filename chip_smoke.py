"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit;
2. builds the port's CUDA kernels from ``models_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source, all at once) and prints their ptxas registers
   (flash_ce's, streaming_topk's, row_scatter's, binned_rescore's and
   bin_max's per kernel, with spills, shared memory and any wgmma
   serialization warning), checks that ``flash_ce.DMAX`` is the
   kernels' width limit, and prints how K6 launches at the path's shapes
   (warps, ring stages, lists) and how K4 does (query tile, row blocks,
   splits of the bins, shared memory, reduction form);
3. holds each kernel against its plain PyTorch version on the card: the top-k
   kernels at the shapes the serving path gives them, fp32 and bf16, with
   padding and planted ties, the streaming kernel also at k=256 and k=512,
   with few query rows over a 1M-row catalog (many catalog splits per row),
   at k=5000 (its lists in global memory), and at D = 130, D = 300 and on
   rows off 16-byte alignment (its element-wise copies), fp32, bf16 and
   int8; the flash-CE kernels (forward K1, backward K2 and K3) at
   Q = N = 8192, D = 128 with downscoring, planted duplicate ids and MIN_FLOAT
   biases (K2 and K3 twice, equal bit for bit), at Q=1000, N=3001, T=0.7
   with zero weights and no ids, at D = 64, 100 and 256, at Q = 8191,
   N = 8193 and at N = 40 (fewer negatives than K3 has chunks), and their
   bf16 forms (bf16 query and negatives) at the same shapes, at Q = N =
   8192, D = 64 and on query rows off 16-byte alignment (K1-K3 twice at
   Q = N = 8192, equal bit for bit), printing which kernels each case's
   bf16 K1 and K2 / K3 took (lse_wg and grad_wg: wgmma, a TMA ring; or
   lse_partial and grad_rows by shape and alignment, one rule for all
   three), that lse_wg's logits, taken through K1 itself, equal grad_wg's
   bit for bit on one tile at D = 64 and 128, and how far lse_partial's
   (mma.sync) are from them; the row
   scatters (K7 add, K8 write) bit for bit, fp32 and bf16 tables, on the
   userId table at the path's batch (deduplicated skewed ids, stale
   duplicates and out-of-range ids on invalid positions), 81,920 ids over
   24 rows, D = 64, 200 and 130, misaligned rows, N = 1 and no valid
   position, and K7's batch edges (N = 31, 33, 32 P +- 1 for its P
   positions a warp, N = 3, D = 256, ids -7 and R + 7 on valid and invalid
   positions), and K8's (N = 1, P +- 1, 33, 257 for its P positions a warp,
   D = 64, 128, 200 and 256, the same ids; misaligned rows of both
   scatters, fp32 and bf16); the binned rescore (K5) against its plain
   version, fp32, bf16 and int8, printing each case's route (the bin-major
   rescore_bins with its grid, distinct bins and busiest block, or the first
   design by shape): random bins of the serving catalog, every query on one
   bin, every bin selected, kb = 1 with B = 1, bins out of range (NaN,
   INT32_MIN), 6,656 selections (two of the bin-major form's windows), one
   block owning every pair, D = 64 and 100; the row gather (K9) bit for
   bit, printing each case's plan (piece bytes, lanes a row, rows a warp),
   fp32, bf16 and fp16 tables of R % 8 != 0 rows, duplicates, ids at both
   ends, clamped ids, B = 1, D = 7, D = 256, a misaligned table, the
   training route's pack (2**20 rows of 26 int32, one chunk of 131,072 ids:
   8-byte pieces, 16 lanes a row) and views of it and of an fp32 table 8
   bytes off 16-byte alignment, and 8192 ids into the bench's 4M x 128 fp32
   and 16M x 128 bf16 tables; the int8 forms: K5 (int8 x int8 -> int32) equal,
   also at D = 130 and on a misaligned catalog (the first design), K6 with
   int8 rows and per-row scales within the fp32 tolerance, with planted ties;
   the binned phase A (K4, ``bin_max``) against its plain version
   (``phase_bin_max``), each case in the design the plan picks: the wgmma
   design at 1M x 128 at B = 256, 1365 (the binned route's bound at k = 10)
   and 8, fp32, bf16 and int8 with per-bin and per-row scales, at D = 128,
   64, 32 and the widths between, bins of 64 and 128 rows, one query row
   and a NaN query row; the first design at D = 130 with n_valid padding,
   D = 300, misaligned rows, bins of 40 and 8 rows: two calls bit-equal,
   int8 bit-equal, fp32 and bf16 within ``tol_for``, the selected bins
   equal outside near-ties;
4. serves the two-tower model end to end at the bench's full width
   (movielens-25m schema, query_tower=(256, 128), embedding_dim=128, seeded
   random weights) over the whole 56,680-item catalog, fp32 and bf16
   indexes: a 256-row request (the binned route, phase A in K4, phase B in
   the rescore kernel) and a 4096-row request (the streaming kernel), each
   held against the plain route, K4's launches equal to K5's on this and
   every path that serves through the binned route; then the int8 index: built on the card equal bit for bit
   to a CPU build, 256 rows by the binned route with ids and scores equal to
   the CPU route's, 4096 rows through K6 int8 against the plain route; the
   launch counts of each run show which kernels it ran; then
   ``topk_scores`` at B = 256 and k = 600 over the catalog (K6, fp32 and int8
   indexes) against the CPU route;
5. times the requests (fp32, bf16, int8; host clock), their parts, the index
   builds and the top-k layer on the bench's 1M x 128 catalog at B = 256,
   phase A's split there (the plain route's widening copy, product,
   ``amax`` and sort beside K4; the peak memory above the index, under
   PHASE_A_PEAK_MAX), with K5 at that layer's own bins (L2 flushed, against
   its plain version); ``topk_scores`` over 2**24 x 128 bf16 rows at B =
   1024 (binned: peak above the index under TOPK_16M_PEAK_MAX, against
   K6); K4 at the serving bins, timed beside its plain version and the
   library's product + ``amax``;
6. checks the training step at the same width: the fused loss (K1-K3) against
   the unfused head (materialised logits, cuBLAS fp32, autograd) at batch
   8192, loss and every parameter's gradient; three adagrad steps at batch
   1024 against a CPU copy of the model (the plain versions); and towers
   wider than the flash-CE kernels hold (``query_tower=(512, 320)``): three
   adagrad steps at batch 8192 through the unfused head against a CPU copy,
   with no launch of K1-K3;
7. trains at full width, the training path: ``compile("adagrad",
   learning_rate=0.05, metrics=[])`` and ``fit`` over 65,536 generated rows
   in batches of 8192 for two epochs (16 steps), requiring each of K1, K2
   and K3 to launch once per step and every loss to be finite, then serves
   the trained model (256 rows, fp32 index);
8. times the train step (host clock, median and range, examples/s), splits
   it with CUDA events into host batch and copy, tower forward, loss forward,
   backward and optimizer step, and traces four steps with torch.profiler
   (the device's busy share, the largest kernels' time per step); then the
   mixed-precision path (``set_dtype_policy("mixed_bfloat16")``,
   ``compile(..., optimizer_state_dtype="bfloat16")``): the fused step at
   batch 8192 against a CPU copy and the unfused head (the bf16 forms of
   K1-K3 launched once each, the fp32 forms never; also the head's float32
   cotangents before it rounds them), three steps at batch 8192 against a
   CPU copy with bf16 and fp32 slots and row-sparsely with bf16 tables, 16
   steps at full width (the bf16 forms once a step), timed as above;
   then k steps a chunk (``compile(steps_per_execution=k, jit=...)``, the
   dataset's columns packed on the card, each chunk's rows gathered by K9,
   the chunk one CUDA graph replay): (a) fp32 dense adagrad, 16 batches of
   8192, 2 epochs, shuffled, 8 steps a chunk, on the graph route, eagerly
   (``jit=False``, twice) and one step at a time, and graph and eager with
   deterministic algorithms on: those two bit for bit (losses, parameters
   and the optimizer's state), the others within SPE_LOSS_RTOL and
   PARAM_ATOL (F.embedding's backward sums the genres table's repeated rows
   in an order that varies from call to call; the script prints two calls'
   differing elements); then two fits on the default device
   (``device=None``) that must reuse the pack and the graph and call no
   wrapper, timed (ms a step) and traced (busy share, and the route's
   kernels counted in the trace: K1-K3 once a step, K9 once a chunk on the
   pack, and the row route's K9 and K8a: the dense adagrad steps userId and
   movieId at their looked-up rows, 3 gathers and 2 writes a table a step);
   (b) the JAX package's pipeline headline (``mixed_bfloat16``, bf16 slots,
   no metrics, PIPE_BATCHES = 128 batches an epoch and a chunk, unshuffled;
   16 batches of rows generated, repeated): graph and eager bit for bit
   over 3 epochs with deterministic algorithms on, then the same model's
   chunk captured again without them, a warm fit, a measured fit of 3
   epochs (ms a step, examples/s), a traced epoch (busy share, the bf16
   kernels counted), the capture's seconds and its memory pool's bytes;
   (c) the top-k metrics every 3rd step, 4 steps a chunk, deterministic
   algorithms on: graph and eager histories bit for bit; (d) the wrappers'
   counts: the graph route's eager chunk and captured chunk (replays call
   no wrapper and are counted in the traces), the row route's at each step
   issued; (e) Adam, capturable on the
   card: against torch's default form on the same gradients (ADAM_REL,
   ADAM_ATOL_P), card against a CPU copy one step at a time (PARAM_ATOL but
   for rounding-noise gradients, ADAM_FLIP_ATOL), graph and eager bit for
   bit in fp32 and under mixed_bfloat16 with bf16 slots;
9. checks row-sparse training (``embedding_optimizer="adagrad"``) with fp32
   and with bf16 tables: three steps at batch 1024 on the card and on a CPU
   copy, both rounding with the CPU generator's noise;
10. trains row-sparsely at full width: 16 steps of 8192 rows with fp32 tables
   (K7 six times a step: acc and table of userId, movieId and genres) and
   with bf16 tables (K7 three times, K8 three times), K1-K3 once a step,
   finite losses, rows no batch looked up unchanged, the trained models
   serving 256 rows;
11. times those steps as in 8, with a row-sparse update part, the bench's
   op-level steps (sparse adagrad on a 4M x 128 fp32 table, dense adagrad on
   the same as its yardstick, sparse adagrad on a 16M x 128 bf16 table), and
   K7, K8 (bf16) and K8's fp32 instance on the 4M-row table (and on the
   userId table; also after a read-only flush, which leaves the L2's lines
   clean, and warm);
12. runs the row gather through its entry point (8192 ids into the 4M x 128
   fp32 and 16M x 128 bf16 tables, four calls each) and times it there and
   on the training route's pack, L2 warm and flushed; then the row route
   (phase 10b): 8192 skewed ids sorted with the first of each run marked,
   K9 and K8a bit for bit against their plain versions and two routed
   Adagrad steps bit for bit against two dense ones, into dlrm_train's C1
   (10M x 64) and C3 and tt_train's userId and movieId (x 128); and the
   step's device time on the route and densely, each a CUDA graph replayed
   (a sweep of N / R at D = 32, 64 and 128, and the bench's tables);
13. evaluates, the README's flow at full width: ``compile(metrics=None,
   train_metrics_steps=4)`` and ``fit`` for 8 steps of 8192 rows (K1-K3
   must launch on exactly the 6 steps without metrics), in-batch
   ``evaluate`` at batch 8192 and ``evaluate(item_corpus=...)`` with fp32,
   bf16 and int8 indexes (K6, 2048 queries) against a CPU copy, and times
   both (examples/s); then (phase 11b) ``evaluate``'s device route (the
   eval pack, chunks of batches, each one CUDA graph replay from the third
   call on) against its streaming route, bit for bit over every call: in-batch
   over 65,536 rows at 8192, the 56,680-item catalog at 16,384 queries in
   batches of 4096 (K6) and of 256 (K4, K5), fp32, bf16 and int8 indexes,
   and the DLRM's binary head with AUC; each case's first device-route run
   under ``torch.cuda.set_sync_debug_mode("error")``, K4, K5, K6 and K9
   counted in a traced replay (and no wrapper called), at most two graphs a
   case, both routes' examples/s, each graph's capture seconds and pool;
   the in-batch evaluate over 64 batches of 8192 (one whole chunk: eager,
   captured and replayed bit-equal), its pool beside the 8-batch chunk's;
   ``fit(validation_data=)`` with k = 8 steps a chunk, the validation inside
   the epoch's device work against a separate ``evaluate`` an epoch
   (histories bit for bit, one copy to the host an epoch against two, a
   timed epoch each); the streaming fit one step at a time with each batch
   prefetched (``_device_prefetch``) against copied in line, bit for bit,
   host ms a step in turns of fits of 32 steps; phase 24 adds a parquet-streamed fit with its
   batches copied in line beside the prefetched ones;
14. the ranking models (phases 12-14): the DLRM at the bench's width
   (``bench.py::bench_dlrm_compute``: criteo-small, D = 64, bottom MLP 256,
   64, top MLP 256, 128, adagrad at 0.05, batch 8192, 16 batches of seeded
   rows): (a) one step at a time, timed as in 8; (b) 8 steps a chunk, each
   chunk one CUDA graph replay with K9 gathering the chunk's rows of the
   40-column pack (160-byte rows): graph and eager bit for bit with
   deterministic algorithms on, K9's launches counted from zero around the
   graph run (the eager chunk and the capture), then a timed fit and a
   traced epoch of replays (K9 once a chunk, the busy share); (c) the card
   against a CPU copy after 4 steps (losses within FCE_TOL, parameters
   within PARAM_ATOL); (d) ``evaluate`` with the binary head's metrics (AUC,
   precision, recall, binary accuracy) against the CPU copy's (loss within
   FCE_TOL, metrics within METRIC_ATOL), and its examples/s; (e)
   ``predict``: probabilities in [0, 1] of shape (B,), within FCE_TOL of the
   CPU's, its latency at 8192 rows; then K9 on that pack at one chunk's ids,
   bit for bit, timed warm and flushed beside ``index_select``; the DLRM on
   the full Criteo cardinalities (26 tables, 31.46M rows, fp32 tables and
   adagrad slots of 8 GB each) trained row-sparsely, 8 steps at batch 8192:
   K7 counted from zero around the fit (twice a table a step, fused and
   per-domain tables), losses finite, each table's looked-up rows moved, the
   peak memory and the step's times, then K7 bit for bit against its plain
   version on the largest table's slot at one batch's ids, timed there
   beside ``index_add_``; DCN-v2 (stacked; parallel with low rank), DeepFM
   and NCF at the JAX tests' widths, 3 steps of 1024 against a CPU copy; a
   DCN whose deep MLP has BatchNorm, graph and eager bit for bit (its
   running statistics among the buffers compared); Dropout's generator on a
   captured graph (each replay draws a new mask);
15. the session models (phases 15-17): the bench's ``session`` cell
   (``sequence-testing``, its L = 4, batch 1024, the GPT2-style block at
   d_model 128, 8 heads, 2 layers, Adam at 1e-3) trained next-item through
   ``fit(pre=SequencePredictNext)`` one step at a time (K1-K3 once a step)
   and 8 steps a graph replay (graph and eager bit for bit with
   deterministic algorithms on; the replays traced: K1-K3 once a step, K9
   once a chunk), against a CPU copy after 4 steps, ``evaluate(pre=
   SequencePredictLast)`` against the CPU's, ``predict`` (full-catalog
   scores); ``session_bucket``'s data at ``pad="max"`` (L = 64): K1-K3
   against their plain versions at Q = N = 65,536 on the head's real
   operands, timed there beside their PyTorch yardsticks (the (Q, N) fp32
   logits materialised once, 17.2 GB, and worked in place: masked product
   and ``logsumexp``; the coefficient and ``coef @ neg`` / ``coefᵀ @ q``;
   the bytes asked for where the card runs out), 8 steps one at a time (the
   kernels' share of the step), and the mixed head (``lse_wg``, ``grad_wg``) against the unfused
   one at the ``session`` size; ``pad="bucket"`` with 16 steps a chunk
   (one pack and one graph a length group of 8, 16, 32, 64 positions):
   sessions/s, each group's replayed step, the traced replays, K9 on each
   group's pack (bit for bit, warm and flushed, ``index_select``);
16. multi-task ranking (phase 19) on the full Ali-CCP schema (21 tables,
   3,448,362 rows at D = 32), 16 seeded batches of 2048: the MMOE at
   ``examples/04_multi_task_mmoe.py``'s width (Adam 1e-3, loss weights 1 and
   0.5) one step at a time, 8 steps a graph replay (graph and eager bit for
   bit with deterministic algorithms on; a traced epoch of replays: K9 once
   a chunk on the 23-column pack, the busy share, the ``_foreach`` kernels'
   share, dense Adam's), row-sparse (adagrad 0.05 on the three tables of
   more than 10,000 rows: K7 twice a table a step), against a CPU copy after
   4 Adam steps with ``class_weight={0: 1, 1: 4}``, ``evaluate`` (both
   tasks' AUC, precision, recall) and ``predict`` against the CPU's; one
   step of each of adamw, rmsprop, lamb and adafactor against a CPU copy,
   then 4 steps of each, 2 a chunk (the second chunk a graph replay);
   frozen experts bit-unchanged by a fit while the gates move; PLE at the
   JAX package's defaults one step at a time and graph-replayed (K9
   traced); the V1 prediction tasks at
   ``examples/14_v1_prediction_tasks.py``'s width one step at a time;
17. the block DSL slice (phase 20): Wide&Deep at its defaults on
   criteo-small, batch 8192 (the wide path's gathered form against its
   dense form on 256 rows; 16 steps one at a time; 8 a graph replay, graph
   and eager bit for bit, K9 on the 40-column pack; row-sparse on the 26
   deep tables, K7 twice a table a step; against a CPU copy after 4 steps;
   ``evaluate``, ``predict``; K9 and K7 on the path's own pack and slot);
   dynamic-vocabulary tables over full-Criteo raw ids (26 tables, 39.3M
   rows at the default capacities, 16 row-sparse steps: each batch's slots
   and the keys bit for bit against a CPU replay of the map, each id left
   without a slot met a full probe window or was outbid by a larger id of
   its batch, ``evaluate`` leaving the keys, a second day
   allocating, the probe and insert's share of the step, K7 on the slots;
   ``examples/17`` at its capacities 8 steps a graph replay bit for bit
   against eager, keys included, and against a CPU copy); a pretrained
   movieId table frozen (bit-unchanged dense and row-sparse, no K7 on it),
   unfrozen, and ``trainable=False``; five TT tables on full Criteo, one
   step against a CPU copy, their lookups timed;
17b. persistence (phase 21): the bench's two-tower trained 4 epochs of 8
   batches of 8192 (unshuffled, deterministic algorithms on) against the
   same run cut after 2 by ``ModelCheckpoint`` and resumed on a fresh model
   through ``CheckpointManager.restore_training`` and
   ``fit(initial_epoch=2)``: adam on a warmup-cosine schedule (a function
   of the device step) one step at a time and 8 steps a graph replay, and
   row-sparse adagrad on bf16 tables (2 epochs of 4), each bit for bit
   (losses, state, row-sparse slots, optimizer state, step), the resumed
   fits' launches counted (K1-K3; K9 on the graph route; K7 and K8b
   row-sparsely); the trained model saved on the card and loaded on the
   card (predictions bit for bit) and on the CPU (within FCE_TOL); K5 and
   K6 through ``torch.ops.models_tpu_torch`` against their wrappers (bit
   for bit) and plain versions; its top-k encoder over the catalog with
   fp32, bf16 and int8 indexes and the DLRM at the bench's width exported
   (``torch.export``) and served by a fresh process that builds no model
   (``SERVE_CODE``): 256 rows through the K5 op and 4096 through the K6
   op, each counted there, scores and ids bit for bit against
   ``predict``'s, the DLRM's 8192 probabilities within FCE_TOL, and each
   program's latency (host clock and CUDA events, median of 20 calls from
   host arrays) beside ``predict``'s;
18. the mesh (phase 22), its ranks started by
   ``models_tpu_torch.parallel.launch.spawn`` as functions of this file:
   (a) one rank over NCCL trains the bench's two-tower 8 steps on a
   {1, 1} mesh, bit for bit the fit without a mesh (deterministic
   algorithms on), and runs the sharded lookup (K9), row update (K7) and
   top-k (K5 at 256 rows, K6 at 4096) on a model axis of one against the
   single-card ops; NCCL is asked for four ranks on the card and its answer
   printed; (b) four ranks on the one card over MESH_BACKEND (gloo: NCCL
   refuses ranks that share a card) train the two-tower (dense Adam,
   row-sparse adagrad on fp32 and on bf16 tables) and the DLRM at the
   bench's widths 8 steps each on {2, 2}, each step's global loss within
   MESH_RTOL of the same fit in this process (the bf16 tables, stitched
   from the shards, to its tables by the flip rule), each rank's launches of the
   path's kernels counted, the largest collective at most the global
   batch's rows of its widest lookup and no all-reduce larger than the
   dense gradients; rank 0 holds K1-K3 (Q = 4096, N = 8192), K9, K7 and
   K8 on the userId shard, and K5 and K6 on a 250,000-row catalog shard,
   to their plain versions; the 1M x 128 catalog split over {1, 4}
   (fp32, bf16, int8) serves 256 rows (K5) and 4096 (K6) with the
   one-rank route's ids; each rank's step time (host clock and CUDA
   events) and time in collectives (medians of steps 2-8), labelled
   MESH_LABEL;
18b. the data plane from files (phase 24), with no pyarrow: the port's
   ``to_parquet`` writes 262,144 movielens-25m rows (4 files, row groups of
   20,000: chunks do not align with batches) and 16,384 sequence-testing
   rows (list columns); ``Dataset(path)`` reads every column back bit for
   bit; the C++ batcher (``pad_ragged``) bit-equal to its numpy version on
   the list columns; the two-tower model at the bench's width trains 32
   steps of 8192 from the files one step at a time through a streaming
   ``Loader(shuffle=False, prefetch=2, cache=False)`` (and ``prefetch=0``;
   K1-K3 once a step) and 32 steps at ``steps_per_execution=8`` from
   ``dense_columns`` over the files (K9 and K1-K3 launched), each bit for
   bit against the same fit from the Dataset in memory (deterministic
   algorithms on); the write and read seconds and MB/s at 4,194,304 rows,
   the loader's host ms a batch in an uncached and a cached epoch, and each
   fit's ms a step, with the card's name and power limit;
18c. the public surface and the side stacks (phase 25): the torch
   side-backend's two-tower model (``models_tpu_torch.torch_backend``) at
   the bench's width (movielens-25m schema, dim 128, towers (256, 128),
   embedding_dim 128) trains SIDE_TRAIN_ROWS rows in batches of 8192 on the
   card and on a CPU copy made with the same seed (losses within
   SIDE_LOSS_RTOL), serves 256 rows through ``to_top_k_recommender`` over
   the whole 56,680-id catalog (K5: the binned route; the top-10 agreeing
   under ``ops/topk.py::ids_agree`` with a CPU copy of the card's trained
   weights) and runs ``evaluate_retrieval``
   at batch 8192 (K6: the streaming route; the same recommender then driven
   over the same 8192-row batches, each batch's top-10 agreeing under
   ``ids_agree`` with the CPU copy's, K6 launched once a batch; the card's
   and the CPU copy's metrics printed); K5 and K6 counted from zero around
   that run (``launches_side`` in each kernels row); the side DLRM and the side
   session transformer card vs CPU copy; ``examples/05`` and ``examples/10``
   on the port's names (the source read with ``models_tpu`` as
   ``models_tpu_torch``), their predictions against a CPU copy of the
   trained model within SIDE_PRED_RTOL, the kernels' launches counted on
   examples/05 (its default metrics, fed every step, read the logits: the
   unfused CE, no K1-K3); the
   step, the served call and ``evaluate_retrieval`` timed on the host clock
   with the card's name and power limit;
19. prints one JSON line with each kernel's launches (on its own path's run;
   K7 and K8: both row-sparse runs), error against its plain version, its
   time, the plain version's, the least time the card could take and a
   PyTorch yardstick's (the bound at the peak of the fastest arithmetic
   that gives each product fp32's error: 3xTF32 for K1-K3 and K6 on fp32
   rows, 3xbf16 for K6 on bf16 and int8 rows, bf16 and 3xbf16 for K1-K3's
   bf16 forms, 3xTF32 and int8 for K4, or HBM3 bytes, named in
   ``bound_peak``; K1, K4, K5 and K6 also with the L2 flushed, ``ms_cold``;
   K4 and K5 also their profiler device time with the catalog in L2,
   ``ms_warm``, since back to back their calls are timed at the host's
   rate; K4 also its plan, its launches on the 1M x 128 layer
   (``launches_topk_1M``) and the 2**24 x 128 bf16 case
   (``topk_16M_bf16_B1024``); K9 profiler device time warm and flushed, its launches those
   its wrapper issued on the graph route's run, the pack's times under
   ``pack``; K1-K3 and K9 also ``launches_replayed_traced``, their kernels
   in the traces of the graph route's replays; K9 also the DLRM's graph
   route's launches, ``launches_dlrm`` and ``launches_replayed_traced_dlrm``,
   and its Criteo pack's times, ``criteo_pack``; K7 also the full-Criteo
   fit's launches, ``launches_criteo``, and its times there, ``criteo``;
   K1-K3 also ``launches_session`` and the session routes' traced
   launches, and their times at 65,536 x 65,536, ``session_long``; K9 the
   session routes' launches and its times on the group packs,
   ``session_bucket``; K9 and K7 the multi-task paths' launches,
   ``launches_mmoe*``, ``launches_ple*``; K9 and K7 the DSL slice's,
   ``launches_wd*``, ``launches_dynamic``, ``launches_pretrained``,
   ``launches_example17``, and their times there, ``wd_pack``, ``wd``,
   ``dynamic_slots``; K1-K3, K7, K8b and K9 the resumed fits',
   ``launches_resume*``; K4, K5 and K6 the served programs',
   ``launches_exported_<index>_B<rows>``, and the MF's, YouTube-DNN's, the
   mesh's and the side backend's serves; K1-K3 and K9 the data plane's
   fits from files, ``launches_parquet_stream`` and
   ``launches_parquet_chunked``),
   then the card line
   and ``{"ok": true,
   ...}`` last. Host-clock times are [median, min, max].

Tolerances. Top-k scores: 2e-6 of the largest |score| (K6 sums 128
products as 3xTF32 or 2xTF32, about 2^-21 relative each, in another order
than the plain version's cuBLAS fp32). Flash-CE: (m, s) and the loss within
1e-5 of their largest value, gradients within 2e-5 of the largest
|gradient|: K1-K3 compute their products as 3xTF32 on the tensor cores
(about 2^-21 relative per product), K1 merges the exponentials over the
four lanes of a quad and the negative splits, K2 and K3 sum the chunks in
order, where the plain versions sum with cuBLAS (TF32 off) and tile by
tile. Training:
loss within 1e-5, every parameter's gradient within 2e-5 of the model's
largest |gradient| (the unfused path rounds a log-softmax over
8193 columns, and sums the embedding gradients in another order); after
three steps on the card and on the CPU, losses within 1e-5 and parameters
within 1e-5 absolute. Row scatters: bit for bit (one fp32 add or one copy per
element). Row-sparse steps, card vs CPU: as training, slots included; a bf16
table element may be one bf16 ulp off where the two sides' fp32 sums differ
in the last bits and the noise falls between them (at most 1e-3 of the
elements written).

Mixed precision: the bf16 forms of K1-K3 under the fp32 forms'
tolerances; card vs CPU and fused vs unfused as the constants FLIP_SHARE_MAX,
FLIP_GRAD_TOL, MIXED_PARAM_ATOL and MIXED_HEAD_GRAD_TOL say (bf16 rounding
flips bounded and counted; the heads round the query's cotangents at other
places, and before they do agree within 2e-5 of the largest).

Multi-task, card vs CPU after 4 Adam steps and after 2 steps of adamw,
rmsprop, lamb or adafactor: each step's loss within FCE_TOL; parameters
within PARAM_ATOL but for flips (elements whose gradient is rounding noise
may step either way), each within twice the most the optimizer's steps can
move an element (noise_step), in each parameter at most MT_FLIP_PARAM_SHARE
of the elements that moved on the CPU or one row, and FLIP_SHARE_MAX of all
that moved; ``evaluate`` and ``predict`` as the ranking models'.

Row gather: bit for bit (a copy). int8: the binned route's ids and scores
bit-equal card vs CPU (integer dots); K6 int8 within the top-k tolerance.
Evaluation, card vs CPU: loss within 1e-5, metrics within METRIC_ATOL.
k steps a chunk: the CUDA graph's replays against the same chunk run eagerly
bit for bit with deterministic algorithms on (the same kernels in the same
order; losses, parameters, the optimizer's state); with them off, and
against one step at a time, losses within
SPE_LOSS_RTOL (a plain mean of the rows' losses against a weighted one;
F.embedding's backward, whose sums over a table's repeated rows vary from
call to call) and parameters within PARAM_ATOL.

Ranking, card vs CPU: losses within FCE_TOL, parameters and buffers within
PARAM_ATOL after 3 or 4 steps (fp32 sums in another order); ``evaluate``'s
loss within FCE_TOL and its metrics within METRIC_ATOL (a probability that
the two sigmoids round to either side of a threshold moves a count);
``predict``'s probabilities within FCE_TOL; the graph route bit for bit
against the eager one with deterministic algorithms on (the fused table's
``F.embedding`` backward sums its repeated rows in an order that varies
otherwise).

Sessions, card vs CPU after 4 Adam steps: losses within FCE_TOL,
parameters within PARAM_ATOL but for rounding-noise elements (a gradient
whose true value is 0 may step either way each step: SESSION_ADAM_FLIP_ATOL,
at most FLIP_SHARE_MAX of them); ``evaluate`` as above; ``predict``'s
scores within FCE_TOL of the largest; K1-K3 at 65,536 x 65,536 under the
flash-CE tolerances.

Wide&Deep and the DSL slice's models, card vs CPU: as multi-task, with
adagrad's bound (one learning rate a step); the wide path's gathered form
within FCE_TOL of its dense form (the largest |output| at least 1); dynamic
tables' slots and keys bit for bit.

The mesh: one NCCL rank bit for bit against no mesh; four ranks' global
losses within MESH_RTOL (2e-4, the JAX package's mesh tests' tolerance) of
one process's (fp32 sums in another order, over the data line), the bf16
tables as card vs CPU under the policy (every element that differs a
flip within MIXED_PARAM_ATOL and one bf16 ulp, at most FLIP_SHARE_MAX of
those the steps moved: both sides round with the same noise); sharded
top-k ids against the one-rank route as the serving checks hold them. A
rank that fails fails the phase (``spawn`` raises with its traceback).

Any failed check raises, and the script exits non-zero. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, TF32 and
# bf16 (dense) on the tensor cores, HBM3. A bound takes the fastest tensor-core
# arithmetic that gives a product fp32's error: fp32 x fp32 as 3xTF32 (three
# TF32 products, as K1-K3 and K6 on fp32 rows run; six bf16 ones are as
# fast); fp32 x bf16 (or int8, exact in bf16) as 3xbf16, the fp32 operand
# split in three bf16 parts, faster than the 2xTF32 that K2/K3's bf16 forms
# and K6 on bf16 and int8 rows run; bf16 x bf16 as one bf16 product
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_3XTF32 = (PEAK_TF32_FLOPS / 3, "3xTF32")
PEAK_3XBF16 = (PEAK_BF16_FLOPS / 3, "3xbf16")
PEAK_FP32 = (PEAK_FP32_FLOPS, "fp32")
PEAK_BF16 = (PEAK_BF16_FLOPS, "bf16")  # the bf16 forms' logit products
SFU_PER_CLOCK_PER_SM = 16  # exponentials a clock on each SM (the special function units)
PEAK_BYTES_PER_S = 3.35e12
REL_TOL = 2e-6  # fp32 sums of 128 products taken in another order
FCE_TOL = 1e-5  # flash-CE (m, s) and loss, of their largest |value|
FCE_GRAD_TOL = 2e-5  # flash-CE gradients, of the largest |gradient|
TRAIN_GRAD_TOL = 2e-5  # fused vs unfused gradients, of the model's largest |gradient|
PARAM_ATOL = 1e-5  # card vs CPU parameters after three steps
# mixed precision (the mixed_bfloat16 policy). A value rounded to bf16 from
# float32 values a few ulps apart (card and CPU sum in other orders) may
# land one bf16 ulp away (a flip). Such elements, at most FLIP_SHARE_MAX of
# those compared, are held to a bound on what a flip can do instead of the
# float32 tolerance: a gradient term moves by 2**-7 of itself; an adagrad
# update (at most the learning rate) by 2**-7 of the learning rate a step, so
# after three steps parameters are held to PARAM_ATOL but for flips, which
# stay within MIXED_PARAM_ATOL (bf16 tables: and one ulp of their rounding)
FLIP_SHARE_MAX = 1e-3
MIXED_PARAM_ATOL = 3 * 0.05 * 2.0 ** -7
# card vs CPU gradients under the policy: a flipped element within this share
# of the largest |gradient| (one bf16 ulp of it), five times the largest flip
# seen at batch 8192 (1.6e-3 of it: 3.81e-6 of 2.38e-3, on an H100 80GB HBM3
# at 700 W; PERF.md)
FLIP_GRAD_TOL = 2.0 ** -7
# fused vs unfused head under the policy, of the model's largest |gradient|:
# the unfused head rounds the query's two cotangents (positive, negatives)
# to bf16 each, the fused one their sum, and the two nearly cancel (the JAX
# package's branches differ alike; tests/test_torch_mixed_precision.py holds
# them to this on the CPU too). At batch 8192 on the card 4.37e-3 (PERF.md).
# Before each head rounds them, the cotangents agree within TRAIN_GRAD_TOL
# (mixed_head_cotangents)
MIXED_HEAD_GRAD_TOL = 1e-2
TRAIN_BATCH = 8192
SEED = 0
CATALOG = 56_680  # movieIds 0..56679
K = 10
USER_ROWS = 162_544  # the userId table, padded to a multiple of 8
# device_ms: device events a trace may miss (or hold extra) over whole calls.
# At most 2 cannot round a kernel launched once a call away (reps >= 5)
LOST_EVENTS_MAX = 2
# A traced window's lead-in: filler kernels before its first marker. Late in
# a long run the profiler drops the first device events of an active step
# (on an H100 under torch 2.11, whether or not the host pauses after the
# step: a few calls' kernels of a device_ms trace, the first steps' of a
# traced epoch; window_events prints how many of the fillers it dropped),
# and some traces hold a warm-up call's events; the fillers take the drop,
# and only the events between the two markers count
LEAD_IN_KERNELS = 4096
FILLER_KERNEL = "CUDAFunctorOnSelf_add<double>"  # a float64 add: nothing traced runs one
WINDOW_MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: nothing traced launches it
# the binned top-k's peak memory above the index at 1M x 128, B = 256: the
# (B, L) maxima and their sort, never the (B, C) scores (1.02 GB there)
PHASE_A_PEAK_MAX = 256e6
# the same at 2**24 x 128 bf16, B = 1024: a quarter of the (B, C) fp32 scores
# (68.7 GB) that phase A wrote before it had a kernel
TOPK_16M_PEAK_MAX = 17.2e9
# the bench's op-level embedding-optimizer tables (bench.py:40)
OP_ROWS_FP32, OP_ROWS_BF16 = 4_000_000, 16_000_000


T0 = time.perf_counter()


def stamp(what: str) -> None:
    """A progress line with the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:.1f} s] {what}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_LEAD_IN = []


def lead_in_graph():
    """LEAD_IN_KERNELS float64 adds captured as one CUDA graph, once, outside
    any trace: a replay puts the lead-in on the device's timeline for one
    launch (the profiler's host-side work grows faster than linearly in the
    host events of a trace: eager adds would cost seconds a window)."""
    if not _LEAD_IN:
        filler = torch.zeros(1, device="cuda", dtype=torch.float64)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(LEAD_IN_KERNELS):
                filler.add_(1.0)
        _LEAD_IN.append((graph, filler))
    return _LEAD_IN[0][0]


@contextlib.contextmanager
def traced_window():
    """Marks a window of a profiler trace on the device's timeline: the body's
    kernels come between two of WINDOW_MARKER's, behind LEAD_IN_KERNELS
    fillers (and before a few) that take a drop of the trace's first (or
    last) events in their place. Call lead_in_graph() before the trace
    starts; read with window_events."""
    lead_in_graph().replay()
    torch.cuda._sleep(1)
    yield
    torch.cuda._sleep(1)
    filler = _LEAD_IN[0][1]
    for _ in range(64):
        filler.add_(1.0)


def window_events(events):
    """The device events (kernels and copies; no annotation ranges, whose
    kernels would count twice) that start between a traced_window's two
    markers, or None where the trace lost a marker. Prints how many of the
    lead-in's fillers the profiler dropped, where it dropped any."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA and not (
        getattr(e, "is_user_annotation", False) or e.name.startswith("Optimizer."))]
    marks = sorted(e.time_range.start for e in dev if WINDOW_MARKER in e.name)
    lead_in = sum(FILLER_KERNEL in e.name and (not marks or e.time_range.start < marks[0])
                  for e in dev)
    if lead_in < LEAD_IN_KERNELS:
        print(f"  traced window: the profiler dropped {LEAD_IN_KERNELS - lead_in} of the "
              f"{LEAD_IN_KERNELS} lead-in kernels" + ("" if len(marks) == 2 else
                                                       f", {2 - len(marks)} marker(s)"), flush=True)
    if len(marks) != 2:
        return None
    return [e for e in dev if marks[0] < e.time_range.start < marks[1]]


def device_ms(fn, reps: int = 50, warmup: int = 5, cold=False) -> float:
    """Device time of one call of ``fn``: the kernels and copies ``reps``
    calls put on the card (torch.profiler), each at its mean duration, as
    many times as one call launches it. For calls of a few microseconds,
    where back-to-back events would time the host's launches instead.
    ``cold``: before each call, rewrite a 128 MB buffer (its kernel is left
    out of the sum), so that the call finds its rows in device memory and not
    in the 50 MB L2; the L2 is then full of the buffer's dirty lines, and
    each line the call brings in first writes one back. ``cold="read"``:
    read the buffer instead (a sum), which leaves the L2 full of clean
    lines."""
    from torch.profiler import ProfilerActivity, profile, schedule

    flush = torch.ones(32 << 20, device="cuda") if cold else None
    # the flush's own kernels: none of the timed calls runs one
    flush_kernels = ("reduce_kernel", "Memset") if cold == "read" else ("MulFunctor",)

    def call():
        if cold == "read":
            flush.sum()
        elif cold:
            flush.mul_(1.0)
        fn()

    for _ in range(warmup):
        call()
    lead_in_graph()
    torch.cuda.synchronize()
    # the profiler loses device events now and then (on an H100 under
    # torch 2.11: a trace with none, and traces short of 1-24 of 50 calls'
    # events), so a call's time is each kernel's mean duration times the
    # number of times a call launches it (its count over `reps`, rounded). A
    # trace more than LOST_EVENTS_MAX events off whole calls, or with no
    # device time, is taken again; the fifth such trace fails the run. The
    # trace runs a warm-up step before the timed one: a trace that starts with
    # the timed calls misses the first call's first events on a slow host
    # (2 memsets, a copy and a kernel of the sparse update, every trace); and
    # the timed calls sit in a traced_window, behind fillers that take the
    # drop of an active step's first events
    for attempt in range(5):
        events = []
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
                wait=0, warmup=1, active=1), on_trace_ready=lambda p: events.extend(p.events())
                ) as prof:
            for _ in range(warmup):
                call()
            torch.cuda.synchronize()  # none of the warm-up's kernels in the timed step
            prof.step()
            with traced_window():
                for _ in range(reps):
                    call()
            torch.cuda.synchronize()
            prof.step()
        by_name = {}
        for e in window_events(events) or ():
            if not (cold and any(k in e.name for k in flush_kernels)):
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        lost = sum(abs(n - round(n / reps) * reps) for n, _ in by_name.values())
        per_call_us = sum(us / n * round(n / reps) for n, us in by_name.values())
        if per_call_us > 0 and lost <= LOST_EVENTS_MAX:
            if lost:
                print(f"  device_ms: {lost} device events missing or extra over {reps} calls",
                      flush=True)
            return per_call_us / 1e3
        odd = {name[:60]: n for name, (n, _) in by_name.items() if n % reps}
        print(f"  device_ms: trace {attempt + 1}: {lost} device events missing or extra over "
              f"{reps} calls ({odd}), device time {per_call_us:.3f} us a call; taken again",
              flush=True)
    raise AssertionError("device_ms: five traces in a row lost device events or saw none")


def host_ms(fn, reps: int = 21) -> list:
    """Wall times of ``reps`` calls of ``fn``, each ending in a synchronise (a
    whole request): [median, min, max] in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return [float(np.median(times)), min(times), max(times)]


def tol_for(ref) -> float:
    """REL_TOL of the largest |score| of the reference, and at least REL_TOL."""
    ref = torch.as_tensor(ref).float()
    real = ref[ref > torch.finfo(torch.float32).min]
    return REL_TOL * max(1.0, float(real.abs().max()) if real.numel() else 0.0)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_topk(name, got, want, positions=None):
    """Kernel result vs plain result: scores within ``tol_for``, ids equal outside
    near-ties; with ``positions`` (ids were positions), equal scores must come
    in ascending position."""
    from models_tpu_torch.ops.topk import ids_agree, max_abs_err

    torch.cuda.synchronize()
    (s, i), (ps, pi) = [(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()) for a, b in (got, want)]
    err, tol = max_abs_err(s, ps), tol_for(ps)
    require(torch.isfinite(s).all().item(), f"{name}: non-finite scores")
    require(ids_agree(s, i, ps, pi, tol),
            f"{name}: disagrees with the plain version (max |d score| {err})")
    if positions:
        same = s[:, 1:] == s[:, :-1]
        require(bool((i[:, 1:][same] > i[:, :-1][same]).all()),
                f"{name}: equal scores not in ascending position")
    exact = float((i == pi).float().mean())
    print(f"  {name}: max|d score| {err:.3g} (tol {tol:.3g}), ids equal {exact:.6f}",
          flush=True)
    return err


def zero_topk_counts() -> None:
    """The top-k kernels' launch counts (K4, K5, K6) set to 0."""
    from models_tpu_torch.ops import topk as T

    T.bin_max.launches = T.binned_rescore.launches = T.streaming_topk.launches = 0


def topk_counts(what: str, suffix: str = "") -> dict:
    """K4's, K5's and K6's launch counts since zero_topk_counts, by name (and
    ``suffix``). Every call of the binned route runs phase A once and phase
    B once: K4's count must equal K5's."""
    from models_tpu_torch.ops import topk as T

    counts = {"bin_max": T.bin_max.launches, "binned_rescore": T.binned_rescore.launches,
              "streaming_topk": T.streaming_topk.launches}
    require(counts["bin_max"] == counts["binned_rescore"],
            f"{what}: K4 launched {counts['bin_max']} times, K5 {counts['binned_rescore']}")
    return {name + suffix: n for name, n in counts.items()}


# ---------------------------------------------------------------------------


def phase_kernels(dev, gen):
    """Each kernel against its plain version at the serving shapes."""
    from models_tpu_torch.ops import topk as T

    errs = {"streaming_topk": 0.0, "binned_rescore": 0.0, "streaming_topk_int8": 0.0}
    # (B, C, n_valid, k): the two serving sizes; long lists in shared memory
    # (k = 256 and 512: merged, not inserted one by one), a list past what
    # shared memory holds (k = 5000, in global memory); few rows over 1M
    # candidates, so that each row merges over many splits
    cases = ((4096, 56_704, CATALOG, K), (2048, 1_000_000, None, K),
             (64, 1_000_000, 999_937, 256), (16, 56_704, CATALOG, 512),
             (8, 1_000_000, None, K), (8, 65_536, None, 5000))
    for B, C, n_valid, k in cases:
        q = torch.randn(B, 128, device=dev, generator=gen)
        c = torch.randn(C, 128, device=dev, generator=gen)
        for dup in (C // 3, C // 2, (n_valid or C) - 1):  # planted ties
            c[dup] = c[7]
        for dtype in (torch.float32, torch.bfloat16):
            cd = c.to(dtype)
            got = T.streaming_topk(q, cd, k, n_valid=n_valid)
            want = T.streaming_topk_plain(q, cd, k, n_valid=n_valid)
            err = check_topk(f"streaming_topk B={B} C={C} n_valid={n_valid} k={k} {dtype}",
                             got, want, positions=True)
            errs["streaming_topk"] = max(errs["streaming_topk"], err)
            # a planted duplicate ranks: query with row 7 itself
            s, pos = T.streaming_topk(c[7:8].float().contiguous(), cd, 4, n_valid=n_valid)
            require(pos[0, :4].tolist() == sorted(pos[0, :4].tolist())
                    and pos[0, 0].item() == 7, f"planted ties resolved as {pos.tolist()}")
    # K6's other copy paths: a width off the 16-byte copies (D = 130, plain
    # loads), widths past one 256-deep stage (D = 300, the query rows streamed
    # with the tiles), rows one element off 16-byte alignment; every row type
    for D, off, k in ((130, 0, K), (300, 0, 40), (128, 1, K)):
        q = torch.randn(100, D, device=dev, generator=gen)
        buf = torch.randn(5000 * D + off, device=dev, generator=gen)
        buf8 = torch.randint(-127, 128, (5000 * D + off,), device=dev, generator=gen,
                             dtype=torch.int8)
        scale = torch.rand(5000, device=dev, generator=gen) * 0.03 + 0.002
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            src = buf8 if dtype == torch.int8 else buf.to(dtype)
            cd, sc = src[off:].view(5000, D), scale if dtype == torch.int8 else None
            got = T.streaming_topk(q, cd, k, n_valid=4999, scale=sc)
            want = T.streaming_topk_plain(q, cd, k, n_valid=4999, scale=sc)
            err = check_topk(f"streaming_topk B=100 C=5000 D={D} offset={off} k={k} {dtype}",
                             got, want, positions=True)
            tag = "streaming_topk_int8" if dtype == torch.int8 else "streaming_topk"
            errs[tag] = max(errs[tag], err)
    phase_rescore(dev, gen, errs)
    return errs


def rescore_case(dev, q, c, idx, name, errs, bs=64):
    """K5 against its plain version on one case, printing the route it took
    (and for the bin-major form its grid, the distinct bins, and the busiest
    block's bins and pairs by ``rescore_schedule``): fp32 and bf16 within
    ``tol_for``, int8 equal; a bin outside the catalog gives NaN
    (INT32_MIN), the other slots are held against the plain version on the
    bins clamped into range."""
    from models_tpu_torch.ops import topk as T

    n_bins = c.shape[0] // bs
    plan = T.rescore_plan(q, c, idx, bs)
    got = T.binned_rescore(q, c, idx, bs)
    inside = (idx >= 0) & (idx < n_bins)
    want = T.binned_rescore_plain(q, c, idx.clamp(0, n_bins - 1), bs)
    torch.cuda.synchronize()
    bad = (~inside).repeat_interleave(bs, dim=1)
    is_int = c.dtype == torch.int8
    if is_int:
        require(got.dtype == torch.int32 and torch.equal(got[~bad], want[~bad])
                and bool((got[bad] == -2**31).all()), f"binned_rescore int8 {name}: differs")
        err, tag = 0.0, "binned_rescore_int8"
    else:
        err = T.max_abs_err(got[~bad], want[~bad])
        require(err <= tol_for(want) and bool(torch.isnan(got[bad]).all())
                and bool(torch.isfinite(got[~bad]).all()),
                f"binned_rescore {c.dtype} {name}: max|d| {err}")
        tag = "binned_rescore"
    errs[tag] = max(errs.get(tag, 0.0), err)
    B, kb = idx.shape
    if plan["route"] == "bins":
        sched, _ = T.rescore_schedule(idx.cpu(), n_bins, plan["blocks"], plan["window"],
                                      plan["query_group"], plan["pairs_per_item"])
        items = [sum(len(w) for w in blk) for blk in sched]
        pairs = [sum(len(e) for w in blk for _, e in w) for blk in sched]
        distinct = int(torch.unique(idx[inside]).numel())
        route = (f"bins ({plan['blocks']} blocks, {distinct} distinct bins, {sum(items)} "
                 f"items; busiest block {max(items)} items and {max(pairs)} pairs)")
    else:
        route = "rows"
    print(f"  binned_rescore {name} B={B} kb={kb} bs={bs} D={q.shape[1]} {c.dtype}: "
          f"{'equal' if is_int else f'max|d| {err:.3g}'}; route {route}", flush=True)
    return plan["route"]


def phase_rescore(dev, gen, errs):
    """K5 (fp32, bf16, int8) against its plain version: random bins of the
    serving catalog (886 bins of 64), every query on one bin, every bin
    selected, kb = 1 with B = 1, bins out of range, B kb past the bin-major
    form's window (two windows), one block owning every pair (32 query rows,
    one group), D = 64 and 100
    (bf16 and int8 rows of 100 are not 16-byte pieces: the first design), a
    catalog off 16-byte alignment (the first design)."""
    from models_tpu_torch.ops import topk as T

    def selections(B, kb, how):
        if how == "random":
            return torch.randint(0, 886, (B, kb), device=dev, generator=gen, dtype=torch.int32)
        if how == "one bin":
            return torch.full((B, kb), 417, device=dev, dtype=torch.int32)
        if how == "every bin":
            e = torch.randperm(B * kb, device=dev, generator=gen) % 886
            return e.view(B, kb).to(torch.int32).contiguous()
        if how == "out of range":
            idx = selections(B, kb, "random")
            idx[3, 1], idx[100, 0], idx[200, kb - 1] = -1, 886, 2**30
            return idx
        if how == "one owner":  # one group of query rows, bins 5 + G m: block 5's
            G = T.rescore_plan(q[:B], c, selections(B, kb, "random"), 64)["blocks"]
            m = torch.randint(0, (886 - 5 + G - 1) // G, (B, kb), device=dev, generator=gen)
            return (5 + G * m).clamp(max=885).to(torch.int32)
        raise ValueError(how)

    cases = [(256, 12, "random"), (256, 13, "one bin"), (256, 13, "every bin"),
             (1, 1, "random"), (256, 13, "out of range"), (512, 13, "random"),
             (32, 13, "one owner")]
    routes = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for D in (128, 64, 100):
            if dtype == torch.int8:
                q = torch.randint(-127, 128, (512, D), device=dev, generator=gen,
                                  dtype=torch.int8)
                c = torch.randint(-127, 128, (886 * 64, D), device=dev, generator=gen,
                                  dtype=torch.int8)
            else:
                q = torch.randn(512, D, device=dev, generator=gen)
                c = torch.randn(886 * 64, D, device=dev, generator=gen).to(dtype)
            for B, kb, how in cases if D == 128 else cases[:1]:
                idx = selections(B, kb, how)
                route = rescore_case(dev, q[:B], c, idx, f"{how} D={D}", errs)
                routes[(dtype, D, how)] = route
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        require(routes[(dtype, 128, "random")] == "bins", f"K5 {dtype} D=128: not bin-major")
    require(routes[(torch.float32, 100, "random")] == "bins"
            and routes[(torch.bfloat16, 100, "random")] == "rows", "K5 D=100 routes")


def build_model(dev):
    import models_tpu_torch as mt

    schema = mt.generate_data("movielens-25m", num_rows=1).schema
    model = mt.TwoTowerModel(schema, query_tower=(256, 128), embedding_dim=128,
                             seed=SEED, device=dev)
    cat = mt.generate_data("movielens-25m", num_rows=CATALOG, seed=SEED + 1).to_numpy_dict()
    cat["movieId"] = np.arange(CATALOG, dtype=np.int32)  # every item once
    catalog = mt.Dataset(cat, schema=schema)
    queries = mt.generate_data("movielens-25m", num_rows=4096, seed=SEED + 2)
    return model, catalog, queries


def phase_serving(dev, model, catalog, queries):
    """The main path: index, then serve requests of 256 rows (the binned
    route, phase A in K4, phase B in the rescore kernel) and 4096 rows (the
    streaming kernel)."""
    from models_tpu_torch.ops import topk as T

    results, timing = {}, {}
    q_ds = {256: queries.take(256), 4096: queries}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        t = time.perf_counter()
        enc = model.to_top_k_encoder(catalog, k=K, batch_size=1024, candidate_dtype=dtype,
                                     device=dev)
        torch.cuda.synchronize()
        timing[f"index_{tag}_ms"] = (time.perf_counter() - t) * 1e3
        bf = enc.blocks[-1].topk_layer
        require(bf.candidates.shape == (56_704, 128) and bf.n_valid == CATALOG,
                f"index shape {tuple(bf.candidates.shape)}, n_valid {bf.n_valid}")
        for B in (256, 4096):
            before = T.streaming_topk.launches, T.binned_rescore.launches, T.bin_max.launches
            out = enc.predict(q_ds[B], batch_size=B, device=dev)
            ran_k6 = T.streaming_topk.launches > before[0]
            ran_k5 = T.binned_rescore.launches > before[1]
            ran_k4 = T.bin_max.launches > before[2]
            require(ran_k6 == (B == 4096), f"B={B}: streaming kernel ran: {ran_k6}")
            require(ran_k5 == ran_k4 == (B == 256), f"B={B}: K5, K4 ran: {ran_k5}, {ran_k4}")
            require(out["scores"].shape == (B, K) and out["ids"].shape == (B, K),
                    f"predict shapes {out['scores'].shape}")
            require(np.isfinite(out["scores"]).all(), "non-finite scores")
            require(((out["ids"] >= 0) & (out["ids"] < CATALOG)).all(), "ids out of range")
            results[(tag, B)] = (enc, out)
    return results, timing


def check_serving(dev, model, queries, results):
    """Each served result against the plain route on the card, and the first
    rows against the same model run on the CPU."""
    import copy

    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import topk as T

    for (tag, B), (bf_enc, out) in results.items():
        x, _ = next(iter(Loader(queries.take(B), B)))
        with torch.no_grad():
            qv = model.query_encoder(to_device_batch(x, dev))
        got = (torch.as_tensor(out["scores"]), torch.as_tensor(out["ids"]))
        bf = bf_enc.blocks[-1].topk_layer
        want = T.streaming_topk_plain(qv, bf.candidates, K, ids=bf.ids, n_valid=bf.n_valid)
        check_topk(f"serve {tag} B={B} vs plain", got, want)
    # a small input through the same model on the CPU
    enc = results[("fp32", 256)][0]
    small = queries.take(16)
    ref = copy.deepcopy(enc).to("cpu").predict(small, batch_size=16, device="cpu")
    out = enc.predict(small, batch_size=16, device=dev)
    require(T.ids_agree(out["scores"], out["ids"], ref["scores"], ref["ids"],
                        tol_for(ref["scores"])),
            "card and CPU disagree on 16 requests")
    print("  serve fp32 B=16 card vs CPU: agree", flush=True)


def phase_large_k(dev, model, queries, index_fp32, index_int8):
    """Top-k past the 512 entries a row's list held before: ``topk_scores``
    over the catalog at B = 256 and k = 600, which the route sends to K6 on
    the card (the binned pool would pass 512 MB), with the fp32 and the int8
    index, against the CPU route (blockwise, the plain version) on the same
    query embeddings and index. Returns K6's launches."""
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import topk as T

    x, _ = next(iter(Loader(queries.take(256), 256)))
    with torch.no_grad():
        q = model.query_encoder(to_device_batch(x, dev)).contiguous()
    launches = 0
    for tag, bf in (("fp32", index_fp32), ("int8", index_int8)):
        C, D = bf.candidates.shape
        require(T.topk_route(256, C, D, 600, on_cuda=True) == "streaming",
                "B=256 k=600 does not route to K6")
        args = dict(n_valid=bf.n_valid, col_scale_per_bin=bf.scales_per_bin)
        before = T.streaming_topk.launches
        got = T.topk_scores(q, bf.candidates, 600, ids=bf.ids, col_scale=bf.scales,
                            device=dev, **args)
        torch.cuda.synchronize()
        launches += T.streaming_topk.launches - before
        require(T.streaming_topk.launches == before + 1, f"k=600 {tag}: K6 did not run once")
        cpu = [None if a is None else a.cpu() for a in (bf.candidates, bf.ids, bf.scales)]
        want = T.topk_scores(q.cpu(), cpu[0], 600, ids=cpu[1], col_scale=cpu[2], device="cpu",
                             **args)
        check_topk(f"topk_scores {tag} index B=256 k=600, card (K6) vs CPU", got, want)
    return launches


def serving_breakdown(dev, model, queries, results):
    """Where a request's time goes: host batch assembly and copy to the card
    (host clock), the query tower and the top-k layer (device time)."""
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader

    out = {}
    for B in (256, 4096):
        ds = queries.take(B)
        out[f"host_batch_B{B}_ms"] = host_ms(
            lambda: to_device_batch(next(iter(Loader(ds, B)))[0], dev))
        xb = to_device_batch(next(iter(Loader(ds, B)))[0], dev)
        with torch.no_grad():
            out[f"tower_B{B}_ms"] = cuda_ms(lambda: model.query_encoder(xb))
            qv = model.query_encoder(xb)
            for tag in ("fp32", "bf16"):
                bf = results[(tag, B)][0].blocks[-1].topk_layer
                out[f"topk_{tag}_B{B}_ms"] = cuda_ms(lambda: bf(qv))
    return out


def _row(name, source, replaces, launches, err, ms, plain, lib, flops, nbytes, peak=PEAK_FP32,
         ms_cold=None, extra=()):
    """A kernel's entry of the kernels line. ``peak``: the rate of the
    fastest arithmetic that gives its products their precision, (FLOP/s, its
    name), named in ``bound_peak``.
    ``extra``: more (ms, name) terms of operations the kernel runs on other
    units or at other peaks; the operations' bound is the largest term (a
    caller sums terms that share a unit into one). ``ms_cold``: the
    kernel's device time with the L2 flushed before each call, where it was
    taken beside the back-to-back time ``ms``."""
    terms = [(flops / peak[0] * 1e3, peak[1]), *extra]
    ops_ms, ops_peak = max(terms)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_peak": ops_peak if ops_ms >= bytes_ms else "HBM3", "library_ms": lib,
    }
    if ms_cold is not None:
        row["ms_cold"] = ms_cold
    return row


def rescore_design(q, c, idx, bs) -> dict:
    """K5's route for these operands and its design, for the kernels line."""
    from models_tpu_torch.ops import topk as T

    plan = T.rescore_plan(q, c, idx, bs)
    if plan["route"] == "bins":
        design = (f"bin-major: {plan['blocks']} blocks own the keys (a bin and a group of "
                  f"{plan['query_group']} query rows), scan the selections {plan['window']} at "
                  f"a time, items of at most {plan['pairs_per_item']} pairs, one bulk copy of "
                  "the bin and one of each pair's query row into mbarrier rings, the bin in "
                  "registers as mma.sync B fragments (3xTF32 fp32, 2xTF32 bf16, s8 int8) "
                  "against the item's query rows")
    else:
        design = "rows: a block per query row, a warp per candidate row"
    return {"form": plan["route"], "design": design}


def phase_measure(dev, model, queries, results, launches, errs):
    """Each kernel timed on the inputs the serving path gave it (the query
    embeddings of the 4096- and 256-row requests, the index, the bins phase A
    selects), beside its plain version and one PyTorch call. Calls run back to
    back, so a catalog that fits the 50 MB L2 stays there, as it does between
    requests. Returns the kernels line (fp32 index) and the bf16 times."""
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import topk as T

    x, _ = next(iter(Loader(queries, 4096)))
    with torch.no_grad():
        q4096 = model.query_encoder(to_device_batch(x, dev)).contiguous()
    q256 = q4096[:256].contiguous()
    rows, bf16 = [], {}
    for tag in ("fp32", "bf16"):
        bf = results[(tag, 4096)][0].blocks[-1].topk_layer
        n, D = bf.n_valid, bf.candidates.shape[1]
        item = bf.candidates.element_size()
        cand, ids = bf.candidates[:n], bf.ids[:n]  # the streaming route drops the padding
        B = q4096.shape[0]
        ms = cuda_ms(lambda: T.streaming_topk(q4096, cand, K, ids=ids))
        cold = device_ms(lambda: T.streaming_topk(q4096, cand, K, ids=ids), cold=True)
        plain = cuda_ms(lambda: T.streaming_topk_plain(q4096, cand, K, ids=ids), reps=3)
        lib = cuda_ms(lambda: torch.topk(q4096 @ cand.float().T, K))
        k6 = _row("streaming_topk", "models_tpu_torch/csrc/streaming_topk.cu",
                  "models_tpu/ops/topk.py:102", launches["streaming_topk"],
                  errs["streaming_topk"], ms, plain, lib, 2 * B * n * D,
                  B * D * 4 + n * D * item + n * 4 + B * K * 8,
                  PEAK_3XTF32 if tag == "fp32" else PEAK_3XBF16, ms_cold=cold)
        full = bf.candidates  # 886 full bins, the padding in the last
        bs = 64
        k4 = measure_bin_max(q256, full, n, launches["bin_max"], errs, tag)
        idx = T.select_bins(q256, full, K, n_valid=n)
        B, kb = idx.shape
        c3 = full.view(-1, bs, D)
        got = T.binned_rescore(q256, full, idx, bs)
        want = T.binned_rescore_plain(q256, full, idx, bs)
        torch.cuda.synchronize()
        err = T.max_abs_err(got, want)
        require(err <= tol_for(want), f"binned_rescore {tag} at the serving bins: max|d| {err}")
        print(f"  binned_rescore {tag} at the serving bins B={B} kb={kb}: max|d| {err:.3g}",
              flush=True)
        ms = cuda_ms(lambda: T.binned_rescore(q256, full, idx, bs))
        cold = device_ms(lambda: T.binned_rescore(q256, full, idx, bs), cold=True)
        plain = cuda_ms(lambda: T.binned_rescore_plain(q256, full, idx, bs))
        lib = cuda_ms(lambda: torch.einsum("bd,bksd->bks", q256, c3[idx.long()].float()))
        n_bins = int(torch.unique(idx).numel())  # each selected bin read once
        k5 = _row("binned_rescore", "models_tpu_torch/csrc/binned_rescore.cu",
                  "models_tpu/ops/topk.py:208", launches["binned_rescore"],
                  max(errs["binned_rescore"], err), ms, plain, lib, 2 * B * kb * bs * D,
                  n_bins * bs * D * item + B * D * 4 + B * kb * 4 + B * kb * bs * 4,
                  ms_cold=cold)
        # back to back, a call of a few tens of microseconds is timed at the
        # host's rate of calls: its device time (profiler) beside it
        k5["ms_warm"] = device_ms(lambda: T.binned_rescore(q256, full, idx, bs))
        k5.update(rescore_design(q256, full, idx, bs))
        print(f"  {tag}: phase A selects kb={kb} bins per row, {n_bins} distinct", flush=True)
        if tag == "fp32":
            rows = [k6, k5, k4]
        else:
            bf16 = {"streaming_topk": k6, "binned_rescore": k5, "bin_max": k4}
    return rows, bf16


def measure_bin_max(q, full, n_valid, launches, errs, tag, scale=None) -> dict:
    """K4 on the inputs a 256-row request gives it (the query rows, the
    index's full bins; the int8 index's per-bin scales): held against its
    plain version, timed back to back (CUDA events) and with the L2 flushed
    (profiler device time) beside the plain version and the library's
    product + ``amax`` (cuBLAS fp32 on rows widened beforehand, or the
    cuBLASLt int8 product). Bound: the product's operations at the peak of
    the arithmetic that gives it its precision (3xTF32 fp32 rows, 3xbf16
    bf16 rows, int8), or the bytes: the queries, the rows and the scales
    read once, the (B, L) maxima written once. Returns its kernels row."""
    from models_tpu_torch.ops import topk as T

    per_bin = scale is not None
    err = bin_max_case(f"serving {tag}", q, full, errs, scale=scale, per_bin=per_bin,
                       n_valid=n_valid)
    (B, D), bs = q.shape, 64
    L = full.shape[0] // bs
    k4 = lambda: T.bin_max(q, full, bs, scale, per_bin)  # noqa: E731
    ms, cold = cuda_ms(k4), device_ms(k4, cold=True)
    plain = cuda_ms(lambda: T.bin_max_plain(q, full, bs, scale, per_bin))
    if full.dtype == torch.int8:
        sc = T._bin_scales(scale, L, bs)[None]
        lib = cuda_ms(lambda: T._int_scores(q, full).view(B, L, bs).amax(2).float() * sc)
        peak, qbytes = (1979e12, "int8"), 1
    else:
        wide = full.float()
        lib = cuda_ms(lambda: (q @ wide.T).view(B, L, bs).amax(2))
        peak, qbytes = (PEAK_3XTF32 if full.dtype == torch.float32 else PEAK_3XBF16), 4
    name = "bin_max_int8" if full.dtype == torch.int8 else "bin_max"
    row = _row(name, "models_tpu_torch/csrc/bin_max.cu", "models_tpu/ops/topk.py:284",
               launches, max(errs[name], err), ms, plain, lib, 2 * B * L * bs * D,
               B * D * qbytes + L * bs * D * full.element_size() + B * L * 4
               + (L * 4 if per_bin else 0), peak, ms_cold=cold)
    # back to back, a call of some 0.05 ms is timed at the host's rate of
    # calls: its device time (profiler) beside it
    row["ms_warm"] = device_ms(k4)
    row["plan"] = T.bin_max_plan(full.dtype, B, D, L, bs)
    row["design"] = row["plan"]["design"]
    print(f"  bin_max {tag} at the serving shape B={B} L={L}: {ms:.4f} ms, warm "
          f"{row['ms_warm']:.4f}, cold {cold:.4f}, plain {plain:.4f}, library {lib:.4f}, "
          f"bound {row['bound_ms']:.4f}; {row['design']}", flush=True)
    return row


def bin_max_bound_ms(B, D, L, bs, dtype, per_bin) -> float:
    """K4's bound: the products' operations at the peak of the arithmetic
    that gives them their precision (3xTF32 fp32 rows, 3xbf16 bf16 rows,
    int8), or its bytes (the queries, the rows and the per-bin scales read
    once, the (B, L) maxima written once), the larger."""
    if dtype == torch.int8:
        peak, qbytes = 1979e12, 1
    else:
        peak, qbytes = (PEAK_3XTF32 if dtype == torch.float32 else PEAK_3XBF16)[0], 4
    item = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    nbytes = B * D * qbytes + L * bs * D * item + B * L * 4 + (L * 4 if per_bin else 0)
    return max(2 * B * L * bs * D / peak, nbytes / PEAK_BYTES_PER_S) * 1e3


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = want.double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    return max_err(got, want) / max(scale, 1e-30)


def max_err(got, want) -> float:
    from models_tpu_torch.ops.topk import max_abs_err

    return max_abs_err(got, want)


def fce_case(dev, gen, Q, N, D, T, ids, bias_min, zero_w, dtype=torch.float32):
    """Seeded flash-CE inputs: ids with planted duplicates (in-batch: the
    negatives' ids are the positives'), a bias with MIN_FLOAT where the row
    is invalid (its embedding zeroed, as the head does), row weights; query
    and negatives in ``dtype`` (the positive logit from the same values)."""
    from models_tpu_torch.core.constants import MIN_FLOAT

    q = torch.randn(Q, D, device=dev, generator=gen) * 0.3
    pos = torch.randn(Q, D, device=dev, generator=gen) * 0.3
    neg = torch.randn(N, D, device=dev, generator=gen) * 0.3
    pid = nid = bias = None
    if ids:
        pid = torch.randint(0, CATALOG, (Q,), device=dev, generator=gen, dtype=torch.int32)
        pid[1000:1100] = pid[7]
        nid = pid[:N].contiguous() if N <= Q else torch.randint(
            0, CATALOG, (N,), device=dev, generator=gen, dtype=torch.int32)
    if bias_min:
        bias = torch.zeros(N, device=dev)
        bias[::97] = MIN_FLOAT
        neg[::97] = 0.0
    w = torch.ones(Q, device=dev)
    if zero_w:
        w[::5] = 0.0
    q, pos, neg = (a.to(dtype) for a in (q, pos, neg))
    pos_logit = ((q.float() * pos.float()).sum(1) / T).contiguous()
    return q, pos_logit, neg, pid, nid, bias, w


def check_fce(name, dev, args, T, errs, repeat=False):
    """K1, K2 and K3 against their plain versions on the same inputs, in the
    form the query's dtype takes (fp32, or bf16: errors under ``*_bf16``);
    ``repeat``: the three again, to the same bits (the chunk merges are
    ordered)."""
    from models_tpu_torch.ops import contrastive as C
    from models_tpu_torch.ops import flash_ce as F

    q, pos_logit, neg, pid, nid, bias, w = args
    sfx = "_bf16" if q.dtype == torch.bfloat16 else ""
    ds = pid is not None
    m, s = F.lse_forward(q, pos_logit, neg, pid, nid, bias, T, ds)
    pm, ps = F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, T, ds)
    loss, ploss = (C._loss_from_lse(pos_logit, a, b, w) for a, b in ((m, s), (pm, ps)))
    lse = (pm + torch.log(ps)).contiguous()
    gw = (w / w.sum()).contiguous()
    dq = F.grad_query(q, neg, lse, gw, pid, nid, bias, T, ds)
    pdq = F.grad_query_plain(q, neg, lse, gw, pid, nid, bias, T, ds)
    dn = F.grad_neg(q, neg, lse, gw, pid, nid, bias, T, ds)
    pdn = F.grad_neg_plain(q, neg, lse, gw, pid, nid, bias, T, ds)
    torch.cuda.synchronize()
    for what, got, want, tol in (("m", m, pm, FCE_TOL), ("s", s, ps, FCE_TOL),
                                 ("loss", loss[None], ploss[None], FCE_TOL),
                                 ("dq", dq, pdq, FCE_GRAD_TOL), ("dneg", dn, pdn, FCE_GRAD_TOL)):
        require(bool(torch.isfinite(got).all()), f"flash-CE {name}: non-finite {what}")
        err = rel_err(got, want)
        require(err <= tol, f"flash-CE {name}: {what} off by {err:.3g} of its size (tol {tol})")
    require(not dq[gw == 0].any(), f"flash-CE {name}: zero-weight rows have a gradient")
    if repeat:
        again = (*F.lse_forward(q, pos_logit, neg, pid, nid, bias, T, ds),
                 F.grad_query(q, neg, lse, gw, pid, nid, bias, T, ds),
                 F.grad_neg(q, neg, lse, gw, pid, nid, bias, T, ds))
        torch.cuda.synchronize()
        require(all(torch.equal(raw_bits(a), raw_bits(b))
                    for a, b in zip((m, s, dq, dn), again)),
                f"flash-CE {name}: K1 / K2 / K3 differ from one call to the next")
    for key, err in (("lse_forward", max(max_err(m, pm), max_err(s, ps))),
                     ("grad_query", max_err(dq, pdq)), ("grad_neg", max_err(dn, pdn))):
        errs[key + sfx] = max(errs.get(key + sfx, 0.0), err)
    form = " (bf16 forms)" if sfx else ""
    print(f"  flash-CE {name}{form}: rel m {rel_err(m, pm):.3g} s {rel_err(s, ps):.3g} "
          f"loss {rel_err(loss[None], ploss[None]):.3g} dq {rel_err(dq, pdq):.3g} "
          f"dneg {rel_err(dn, pdn):.3g}", flush=True)


def phase_flash_ce(dev, gen, errs):
    """K1-K3 against their plain versions at the training path's shapes (K2
    and K3 twice, bit-equal), at ragged shapes (against every tile and chunk;
    fewer negatives than K3 has chunks), at a width that is no multiple of 8
    and at the widths the design holds."""
    cases = (("Q=N=8192 D=128 downscore bias", 8192, 8192, 128, 1.0, True, True, False),
             ("Q=1000 N=3001 D=64 T=0.7 zero weights", 1000, 3001, 64, 0.7, False, False, True),
             ("Q=N=2048 D=64 downscore bias", 2048, 2048, 64, 1.0, True, True, False),
             ("Q=N=2048 D=256 T=0.7 downscore", 2048, 2048, 256, 0.7, True, False, True),
             ("Q=N=2048 D=100 downscore bias", 2048, 2048, 100, 1.0, True, True, True),
             ("Q=8191 N=8193 D=128 T=0.7 downscore bias", 8191, 8193, 128, 0.7, True, True, True),
             ("Q=8192 N=40 D=128 downscore bias", 8192, 40, 128, 1.0, True, True, True))
    for name, Q, N, D, T, ids, bias_min, zero_w in cases:
        check_fce(name, dev, fce_case(dev, gen, Q, N, D, T, ids, bias_min, zero_w), T, errs,
                  repeat=Q == N == 8192)


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts one element past a
    16-byte boundary (rows no TMA copy takes)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def phase_flash_ce_bf16(dev, gen, errs):
    """The bf16 forms of K1-K3 (the mixed_bfloat16 path) against their plain
    versions, under the fp32 forms' tolerances: the training path's shapes
    with downscoring, duplicate ids and MIN_FLOAT biases (the three twice,
    bit-equal), the same at D = 64, 1000 x 3001 at T = 0.7 with zero
    weights, D = 64 and 256, a width with no 16-byte rows (D = 100: the
    element-wise copies), query rows off 16-byte alignment, ragged Q, N,
    and fewer negatives than K3 has chunks (N = 40). Each case prints the
    kernels K1 (lse_wg or lse_partial) and K2 / K3 (grad_wg or grad_rows)
    took: lse_wg exactly where grad_wg, on every D = 64 and 128 case with
    16-byte rows. Then the logit invariant (``logit_invariant``)."""
    from models_tpu_torch.ops import flash_ce as F

    cases = (("Q=N=8192 D=128 downscore bias", 8192, 8192, 128, 1.0, True, True, False),
             ("Q=N=8192 D=64 downscore bias", 8192, 8192, 64, 1.0, True, True, False),
             ("Q=1000 N=3001 D=128 T=0.7 zero weights", 1000, 3001, 128, 0.7, False, False,
              True),
             ("Q=N=2048 D=64 downscore bias", 2048, 2048, 64, 1.0, True, True, False),
             ("Q=N=2048 D=256 T=0.7 downscore", 2048, 2048, 256, 0.7, True, False, True),
             ("Q=N=2048 D=100 downscore bias", 2048, 2048, 100, 1.0, True, True, True),
             ("Q=N=2048 D=128 unaligned query rows", 2048, 2048, 128, 1.0, True, True, False),
             ("Q=8191 N=8193 D=128 T=0.7 downscore bias", 8191, 8193, 128, 0.7, True, True,
              True),
             ("Q=8192 N=40 D=128 downscore bias", 8192, 40, 128, 1.0, True, True, True))
    routes = {}
    for name, Q, N, D, T, ids, bias_min, zero_w in cases:
        args = fce_case(dev, gen, Q, N, D, T, ids, bias_min, zero_w, torch.bfloat16)
        if "unaligned" in name:
            args = (misaligned(args[0]), *args[1:])
        routes[name] = (F.lse_route(args[0], args[2]), F.grad_route(args[0], args[2]))
        check_fce(name, dev, args, T, errs, repeat=Q == N == 8192)
    print("  K1 / K2, K3 bf16 routes: " + json.dumps(routes), flush=True)
    for name, (lse, grad) in routes.items():
        require((lse == "lse_wg") == (grad == "grad_wg"),
                f"{name}: K1 took {lse}, K2 / K3 {grad}: not the same rule")
        wg = (" D=64 " in name or " D=128 " in name) and "unaligned" not in name
        require(lse == ("lse_wg" if wg else "lse_partial"), f"{name}: K1 took {lse}")
    logit_invariant(dev, gen)


def lse_wg_logits(dev, gen, q, nk):
    """lse_wg's logit sums of q (64, D) against nk (64, D), both bf16, taken
    through K1 itself: one split over 256 negatives (four tiles), nk's rows
    as tiles 1 and 2 (those the kernel computes while the tile before takes
    its exponentials; tile 2 in the other register set), the rest random,
    T = 1, the positive logit -inf and every negative's bias -1e30 but one:
    then m_i is that negative's logit sum. Returns (tile 1's, tile 2's),
    each (64, 64) float32."""
    from models_tpu_torch.ops import flash_ce as F
    from models_tpu_torch.ops import kernels

    lib, D = F._lib(), q.shape[1]
    fill = (torch.randn(64, D, device=dev, generator=gen) * 0.3).bfloat16()
    neg = torch.cat([fill, nk, nk, fill]).contiguous()
    pos = torch.full((64,), -float("inf"), device=dev)
    part = torch.empty(2, 64, device=dev)
    m, s = torch.empty(64, device=dev), torch.empty(64, device=dev)
    require(F.lse_route(q, neg) == "lse_wg", "the lse_wg logit probe did not take lse_wg")
    out = []
    for tile in (1, 2):
        cols = torch.empty(64, 64, device=dev)
        for k in range(64):
            bias = torch.full((256,), -1e30, device=dev)
            bias[64 * tile + k] = 0.0
            rc = lib.flash_ce_lse_forward(q.data_ptr(), pos.data_ptr(), neg.data_ptr(), None,
                                          None, bias.data_ptr(), part[0].data_ptr(),
                                          part[1].data_ptr(), m.data_ptr(), s.data_ptr(), 64,
                                          256, D, 1.0, 0, 1, 1, F._stream(q))
            kernels.check(lib, rc, "flash_ce_lse_forward")
            cols[:, k] = m
        out.append(cols)
    torch.cuda.synchronize()
    return out


def logit_invariant(dev, gen):
    """K1-bf16 and K2 / K3-bf16 must see one x: the forward's lse and the
    backward's exp(x - lse). On seeded rows scaled as the towers' outputs,
    at D = 64 and 128: lse_wg's logit sums (``lse_wg_logits``, through K1
    itself) must equal grad_wg's (``wg_logits``, the probe kernel) bit for
    bit, as they share the wgmma parts and their order; and lse_partial's
    (``logit_products``, mma.sync: the other shapes' K1) must lie within
    1e-6 of the largest |logit| of them (each 32-deep sum on either path is
    within a few fp32 ulps of the exact one). Prints how far each is from
    the exact sums."""
    from models_tpu_torch.ops import flash_ce as F
    from models_tpu_torch.ops import kernels

    lib = F._lib()
    for D in (64, 128):
        q = (torch.randn(64, D, device=dev, generator=gen) * 0.3).bfloat16()
        neg = (torch.randn(64, D, device=dev, generator=gen) * 0.3).bfloat16()
        out_mma = torch.empty(64, 64, device=dev)
        out_wg = torch.empty(64, 64, device=dev)
        rc = lib.flash_ce_logit_probe(q.data_ptr(), neg.data_ptr(), out_mma.data_ptr(),
                                      out_wg.data_ptr(), D, F._stream(q))
        kernels.check(lib, rc, "flash_ce_logit_probe")
        lse_t1, lse_t2 = lse_wg_logits(dev, gen, q, neg)
        exact = q.double() @ neg.double().T
        scale = float(exact.abs().max())
        # by value: lse_wg's m adds a zero bias, which turns a -0 sum into +0
        same = [int((o == out_wg).sum()) for o in (lse_t1, lse_t2)]
        mma_same = int((raw_bits(out_mma) == raw_bits(out_wg)).sum())
        diff = float((out_mma - out_wg).abs().max()) / scale
        errs_vs_exact = [float((o.double() - exact).abs().max()) / scale
                         for o in (out_mma, out_wg)]
        print(f"  logit invariant D={D}: lse_wg (tiles 1, 2) and grad_wg logits equal on "
              f"{same[0]} and {same[1]} of 4096; lse_partial (mma.sync) and grad_wg bit-equal "
              f"on {mma_same} of 4096, largest difference {diff:.3g} of the largest |logit|; "
              f"against the exact sums mma.sync {errs_vs_exact[0]:.3g}, wgmma "
              f"{errs_vs_exact[1]:.3g}", flush=True)
        require(same == [4096, 4096], f"logit invariant D={D}: lse_wg and grad_wg logits differ")
        require(diff <= 1e-6, f"logit invariant D={D}: lse_partial and grad_wg logits "
                f"{diff:.3g} apart")


def head_grads(model, xb, yb, fused):
    """(loss, {parameter: gradient}) of one training forward and backward,
    through the fused loss or the unfused head."""
    from models_tpu_torch.core.types import ModelContext

    model.contrastive_output.fused_loss = "auto" if fused else False
    model.zero_grad(set_to_none=True)
    ctx = ModelContext(features=xb, targets=yb, step=0, need_logits=False)
    preds = model(xb, targets=yb, training=True, context=ctx)
    total, _ = model._compute_losses(model._as_pred_dict(preds), xb, model._resolve_task_losses())
    total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.contrastive_output.fused_loss = "auto"
    model.zero_grad(set_to_none=True)
    return float(total.detach()), grads


def phase_train_checks(dev, model):
    """The kernel path against two independent ones: the unfused head at batch
    8192, and the same three steps on a CPU copy (plain versions)."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.core.types import to_device_batch, to_device_targets
    from models_tpu_torch.data import Loader

    ds = mt.generate_data("movielens-25m", num_rows=TRAIN_BATCH, seed=SEED + 4)
    x, y = next(iter(Loader(ds, TRAIN_BATCH)))
    xb, yb = to_device_batch(x, dev), to_device_targets(y, dev)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    fused_loss, fused = head_grads(model, xb, yb, fused=True)
    plain_loss, plain = head_grads(model, xb, yb, fused=False)
    err = abs(fused_loss - plain_loss) / abs(plain_loss)
    require(err <= FCE_TOL, f"fused loss {fused_loss} vs unfused {plain_loss}")
    # against the model's largest |gradient|: the last candidate bias has a
    # true gradient of exactly 0 (a shift of every candidate cancels in the
    # softmax), so its own scale is rounding noise
    scale = max(float(g.abs().max()) for g in plain.values())
    worst = max(max_err(fused[n], plain[n]) for n in plain) / scale
    require(worst <= TRAIN_GRAD_TOL, f"fused vs unfused gradients off by {worst:.3g}")
    print(f"  batch {TRAIN_BATCH}: fused loss {fused_loss:.7f} vs unfused {plain_loss:.7f} "
          f"(rel {err:.3g}); gradients off by {worst:.3g} of the largest |gradient| "
          f"{scale:.3g}, at worst over {len(plain)} parameters", flush=True)
    stamp("the same steps on the card and on a CPU copy")

    small = mt.generate_data("movielens-25m", num_rows=1024, seed=SEED + 5)
    on_card, on_cpu = copy.deepcopy(model), copy.deepcopy(model).to("cpu")
    hist = {}
    for tag, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
        stamp(f"3 steps on the {tag}")
        m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
        hist[tag] = m.fit(small, epochs=3, batch_size=1024, shuffle=False,
                          device=d).history["loss"]
    np.testing.assert_allclose(hist["card"], hist["cpu"], rtol=FCE_TOL)
    cpu_params = dict(on_cpu.named_parameters())
    worst = max(max_err(p.detach().cpu(), cpu_params[n].detach())
                for n, p in on_card.named_parameters())
    require(worst <= PARAM_ATOL, f"card and CPU parameters differ by {worst:.3g}")
    print(f"  3 adagrad steps at batch 1024, card vs CPU: losses {hist['card']} vs "
          f"{hist['cpu']}; parameters max|d| {worst:.3g}", flush=True)


def phase_wide_towers(dev, catalog):
    """Towers wider than the flash-CE kernels hold (D = 320 > DMAX): the head
    takes the unfused logits where ``flash_ce.fits`` refuses, as the JAX
    package's ``_use_flash`` routes shapes outside its kernel. Three adagrad
    steps at batch 8192, ``metrics=[]``, on the card and on a CPU copy:
    losses within FCE_TOL, parameters within PARAM_ATOL, and no launch of
    K1-K3."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.ops import flash_ce as F

    require(not F.fits(320, dev) and F.fits(320, "cpu") and F.fits(128, dev),
            "flash_ce.fits: want D = 320 refused on the card only, D = 128 taken")
    model = mt.TwoTowerModel(catalog.schema, query_tower=(512, 320), embedding_dim=128,
                             seed=SEED + 10, device=dev)
    data = mt.generate_data("movielens-25m", num_rows=TRAIN_BATCH, seed=SEED + 11)
    on_cpu = copy.deepcopy(model).to("cpu")
    hist = {}
    for tag, m, d in (("card", model, dev), ("cpu", on_cpu, "cpu")):
        zero_launches()
        m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
        hist[tag] = m.fit(data, epochs=3, batch_size=TRAIN_BATCH, shuffle=False,
                          device=d).history["loss"]
        if tag == "card":
            torch.cuda.synchronize()
            launches = flash_launches()
            require(not any(launches.values()), f"D = 320 launched the flash-CE kernels: "
                    f"{launches}")
    require(all(np.isfinite(hist["card"])), "wide towers: non-finite loss")
    np.testing.assert_allclose(hist["card"], hist["cpu"], rtol=FCE_TOL)
    cpu_params = dict(on_cpu.named_parameters())
    worst = max(max_err(p.detach().cpu(), cpu_params[n].detach())
                for n, p in model.named_parameters())
    require(worst <= PARAM_ATOL, f"wide towers: card and CPU parameters differ by {worst:.3g}")
    print(f"  query_tower=(512, 320), 3 adagrad steps at batch {TRAIN_BATCH}, card vs CPU: "
          f"losses {hist['card']} vs {hist['cpu']}; parameters max|d| {worst:.3g}; K1-K3 "
          "launched 0 times", flush=True)


def flash_launches():
    from models_tpu_torch.ops import flash_ce as F

    return {"lse_forward": F.lse_forward.launches, "grad_query": F.grad_query.launches,
            "grad_neg": F.grad_neg.launches}


def flash_launches_bf16():
    """The bf16 forms' launches, under the kernels line's names."""
    from models_tpu_torch.ops import flash_ce as F

    return {f"{name}_bf16": fn.launches_bf16 for name, fn in (
        ("lse_forward", F.lse_forward), ("grad_query", F.grad_query), ("grad_neg", F.grad_neg))}


def phase_train(dev, model, catalog, queries):
    """The training path at full width: fit 16 steps of 8192 rows, then serve
    the trained model. Each flash-CE counter must rise by one per step."""
    import models_tpu_torch as mt
    from models_tpu_torch.ops import flash_ce as F

    data = mt.generate_data("movielens-25m", num_rows=8 * TRAIN_BATCH, seed=SEED + 3)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    F.lse_forward.launches = F.grad_query.launches = F.grad_neg.launches = 0
    t = time.perf_counter()
    hist = model.fit(data, epochs=2, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    torch.cuda.synchronize()
    launches = flash_launches()
    steps = 2 * data.num_rows // TRAIN_BATCH
    print(f"  fit {steps} steps in {time.perf_counter() - t:.2f} s: loss "
          f"{hist.history['loss']}, launches {launches}", flush=True)
    for name, n in launches.items():
        require(n == steps, f"the training path launched {name} {n} times in {steps} steps")
    require(all(np.isfinite(hist.history["loss"])), "non-finite training loss")
    enc = model.to_top_k_encoder(catalog, k=K, batch_size=1024, device=dev)
    out = enc.predict(queries.take(256), batch_size=256, device=dev)
    require(out["scores"].shape == (256, K) and np.isfinite(out["scores"]).all(),
            "the trained model serves non-finite scores")
    require(((out["ids"] >= 0) & (out["ids"] < CATALOG)).all(), "trained model: ids out of range")
    print("  the trained model serves 256 rows", flush=True)
    return data, launches, {"fit_loss": hist.history["loss"],
                            "fit_examples_per_sec": hist.history["examples_per_sec"]}


def train_times(dev, model, data, batch=TRAIN_BATCH):
    """The train step on the host clock (each step ends in a synchronise), and
    its parts on CUDA events recorded at ``train_step``'s marks and at the end
    of the towers' forward: host batch and copy, tower forward, loss forward
    (K1), backward (K2, K3, the towers, the embedding gradients), dense
    optimizer step, row-sparse update (dedup, gathers, K7, K8; none without an
    embedding optimizer). Event times are device time between marks, launch
    gaps included."""
    from models_tpu_torch.core.types import to_device_batch, to_device_targets
    from models_tpu_torch.data import Loader

    loss_fns = model._resolve_task_losses()
    t = time.perf_counter()
    batches = list(Loader(data, batch, drop_last=True))
    out = {"host_assemble_ms": (time.perf_counter() - t) * 1e3 / len(batches)}
    it = iter(batches * 4)

    def step():
        x, y = next(it)
        model.train_step(to_device_batch(x, dev), to_device_targets(y, dev), loss_fns)

    out["step_ms"] = host_ms(step, reps=12)
    out["examples_per_sec"] = batch / out["step_ms"][0] * 1e3
    names = ("batch_copy", "towers", "loss_forward", "backward", "optimizer", "sparse_update")
    sums = dict.fromkeys(names, 0.0)
    ev = {}

    def mark(name):
        ev[name] = torch.cuda.Event(enable_timing=True)
        ev[name].record()

    hook = model.blocks[0].register_forward_hook(lambda *_: mark("towers"))
    reps = 8
    try:
        for x, y in batches[:reps]:
            ev.clear()
            mark("start")
            xb, yb = to_device_batch(x, dev), to_device_targets(y, dev)
            mark("batch_copy")
            model.train_step(xb, yb, loss_fns, mark=mark)
            torch.cuda.synchronize()
            require(sorted(ev) == sorted(names + ("start",)), f"train step marks {sorted(ev)}")
            for prev, name in zip(("start",) + names, names):
                sums[name] += ev[prev].elapsed_time(ev[name])
    finally:
        hook.remove()
    out.update({f"{name}_ms": v / reps for name, v in sums.items()})
    return out


def train_profile(dev, model, data, steps: int = 4, batch=TRAIN_BATCH):
    """A torch.profiler trace of ``steps`` train steps: the device's busy
    share of the window (kernels and copies over host wall time) and the
    device time per step of the largest kernels."""
    from models_tpu_torch.core.types import to_device_batch, to_device_targets
    from models_tpu_torch.data import Loader

    loss_fns = model._resolve_task_losses()
    batches = list(Loader(data, batch, drop_last=True))[:steps]

    def run():
        for x, y in batches:
            model.train_step(to_device_batch(x, dev), to_device_targets(y, dev), loss_fns)

    # eager steps: the trace counts what the wrappers counted
    out = profile_launches(run, steps, None, "eager train steps")
    require(out["device_busy_share"] > 0, "the profiler saw no device time in the train steps")
    return out


# the launch counters of the training route's wrappers, which a trace counts
# by kernel name (traced_wrapper)
TRACED_WRAPPERS = ("row_gather", "lse_forward", "grad_query", "grad_neg", "lse_forward_bf16",
                   "grad_query_bf16", "grad_neg_bf16", "row_scatter_write")
KERNEL_NAME = re.compile(r"^void \(anonymous namespace\)::(\w+)<([^>]*)>\(")


def traced_wrapper(name: str):
    """The wrapper (its counter's name in TRACED_WRAPPERS) whose call launched
    the kernel of a trace's demangled ``name``, or None: K9's ``gather``; K8's
    ``scatter_write`` (fp32, the row route's; bf16, the row-sparse step's); K1's
    ``lse_partial`` (``_bf16`` on bf16 rows) and ``lse_wg`` (bf16); K2's and
    K3's ``grad_rows`` and ``grad_wg`` (``OWN_Q`` true: K2). One wrapper call
    launches one of these (and at most one merge kernel beside it)."""
    m = KERNEL_NAME.match(name)
    if m is None:
        return None
    kernel, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
    bf16 = "" if args[-1] == "float" and kernel in ("lse_partial", "grad_rows") else "_bf16"
    if kernel == "gather":
        return "row_gather"
    if kernel == "scatter_write":
        return "row_scatter_write"
    if kernel in ("lse_partial", "lse_wg"):
        return "lse_forward" + bf16
    if kernel in ("grad_rows", "grad_wg"):
        return ("grad_query" if args[1] == "true" else "grad_neg") + bf16
    return None


def profile_busy(run, steps: int) -> dict:
    """A torch.profiler trace of ``run()`` (``steps`` train steps, ending in a
    synchronise): the device's busy share of the window (kernels and copies
    over host wall time), its device time a step, the largest kernels', the
    training route's kernels launched in it by wrapper (``launches_traced``:
    a graph replay's kernels too, which no wrapper counts) and the launches
    the wrappers counted in it (``launches_issued``). As in device_ms, the
    trace runs ``run()`` once as a warm-up step before the traced one: a
    trace that starts with the traced calls may miss their first events; and
    the traced run sits in a traced_window (a trace that lost one of its
    markers counts no launch, and profile_launches takes it again)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    lead_in_graph()
    torch.cuda.synchronize()
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        with traced_window():
            torch.cuda.synchronize()  # the fillers and the marker before the clock starts
            before = route_launches()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
            issued = {n: v - before[n] for n, v in route_launches().items()}
        torch.cuda.synchronize()
        prof.step()
    by_name, traced = {}, dict.fromkeys(TRACED_WRAPPERS, 0)
    for e in window_events(events) or ():
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        wrapper = traced_wrapper(e.name)
        if wrapper is not None:
            traced[wrapper] += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # torch's foreach kernels: on the training routes, the dense optimizer's
    foreach = sum(v for n, v in by_name.items() if "multi_tensor_apply_kernel" in n)
    return {"device_busy_share": busy / wall_us,
            "device_ms_per_step": busy / steps / 1e3,
            "foreach_ms_per_step": foreach / steps / 1e3,
            "top_kernels_ms_per_step": [[n[:90], v / steps / 1e3] for n, v in top],
            "launches_traced": traced, "launches_issued": issued}


def profile_launches(run, steps: int, want, what: str, attempts: int = 3) -> dict:
    """profile_busy(run, steps) whose trace shows the training route's
    kernels launched as ``want`` says, by wrapper (None: as the wrappers
    counted them in the traced window). The profiler loses a device event
    now and then (device_ms), so a trace that does not is taken again, up to
    ``attempts`` traces; a kernel launched too often or too rarely fails
    every one."""
    for attempt in range(attempts):
        out = profile_busy(run, steps)
        expect = out["launches_issued"] if want is None else {
            n: want.get(n, 0) for n in TRACED_WRAPPERS}
        if out["launches_traced"] == expect:
            return out
        print(f"  {what}: trace {attempt + 1} shows launches {out['launches_traced']}, want "
              f"{expect}; taken again", flush=True)
    raise AssertionError(f"{what}: {attempts} traces in a row show other launches than {expect}")


def measure_flash_ce(dev, model, data, launches, errs, dtype=torch.float32):
    """K1-K3 timed on the inputs the training path gives them (the towers'
    outputs for one batch, in-batch negatives, downscoring, the valid rows'
    zero bias), beside the plain versions and PyTorch yardsticks over the
    materialised logits (never called by the port). ``dtype`` bf16: the
    mixed-precision path's forms, on the towers' outputs cast to bf16 as the
    head casts them (rows ``*_bf16``; the yardsticks take the bf16 product
    with an fp32 result, ``torch.mm(out_dtype=torch.float32)``, which runs
    on the card but has no backward). Bounds: fp32 forms at 3xTF32; bf16
    forms the larger of the tensor cores' time (the logits at the bf16
    peak, plus K2 / K3's gradient product at 3xbf16: one unit runs both)
    and the Q*N exponentials at the special function units' rate, or the
    bytes."""
    from models_tpu_torch.core.constants import MIN_FLOAT
    from models_tpu_torch.core.types import ModelContext, to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import flash_ce as F

    x, _ = next(iter(Loader(data, TRAIN_BATCH, drop_last=True)))
    xb = to_device_batch(x, dev)
    with torch.no_grad():
        towers = model.blocks[0](xb, context=ModelContext(features=xb))
    q, neg = towers["query"].contiguous(), towers["candidate"].contiguous()
    valid = xb["__row_valid__"].bool()
    neg = torch.where(valid[:, None], neg, 0.0).to(dtype).contiguous()
    bias = torch.where(valid, 0.0, MIN_FLOAT).contiguous()
    pid = nid = xb[model.item_id_name].to(torch.int32).contiguous()
    pos = towers["candidate"].to(dtype)
    q = q.to(dtype).contiguous()
    pos_logit = (q.float() * pos.float()).sum(1).contiguous()
    T, (Q, D), N = 1.0, q.shape, neg.shape[0]
    check_fce("the training path's inputs", dev,
              (q, pos_logit, neg, pid, nid, bias, valid.float()), T, errs)
    m, s = F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, T, True)
    lse = (m + torch.log(s)).contiguous()
    gw = torch.full_like(lse, 1.0 / Q)
    if dtype == torch.bfloat16:
        def product(a, b):
            return torch.mm(a, b, out_dtype=torch.float32)
    else:
        product = torch.matmul

    def logits():
        x = torch.where(nid[None, :] == pid[:, None], MIN_FLOAT, product(q, neg.T) + bias)
        return x / T

    def coef():
        return gw[:, None] * torch.exp(logits() - lse[:, None]) / T

    args = (q, neg, lse, gw, pid, nid, bias, T, True)
    item = q.element_size()
    vec = 4 * (2 * Q + 2 * N)  # pid, nid, bias and one per-row f32 input
    logit_flops = 2 * Q * N * D  # and as much again for K2 / K3's gradient product
    if dtype == torch.bfloat16:
        sfx = "_bf16"
        exp_ms = Q * N / (SFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0)
                          .multi_processor_count * sm_clock_hz()) * 1e3
        logit_ms = logit_flops / PEAK_BF16[0] * 1e3
        grad_ms = logit_flops / PEAK_3XBF16[0] * 1e3
        bounds = {"lse_forward": (0, [(logit_ms, "bf16"), (exp_ms, "SFU exp")]),
                  "grad": (0, [(logit_ms + grad_ms, "bf16 + 3xbf16"), (exp_ms, "SFU exp")])}
    else:  # both products as 3xTF32; the exponentials left out
        sfx = ""
        bounds = {"lse_forward": (logit_flops, []), "grad": (2 * logit_flops, [])}
    rows = []
    for name, line, fn, plain, lib, nbytes in (
            ("lse_forward", 76, lambda: F.lse_forward(q, pos_logit, neg, pid, nid, bias, T, True),
             lambda: F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, T, True),
             lambda: torch.logsumexp(torch.cat([pos_logit[:, None], logits()], 1), 1),
             (Q + N) * D * item + vec + 2 * Q * 4),
            ("grad_query", 134, lambda: F.grad_query(*args), lambda: F.grad_query_plain(*args),
             lambda: coef() @ neg.float(), (Q + N) * D * item + vec + 4 * Q + Q * D * 4),
            ("grad_neg", 184, lambda: F.grad_neg(*args), lambda: F.grad_neg_plain(*args),
             lambda: coef().T @ q.float(), (Q + N) * D * item + vec + 4 * Q + N * D * 4)):
        flops, extra = bounds["lse_forward" if name == "lse_forward" else "grad"]
        source, design = "models_tpu_torch/csrc/flash_ce.cu", None
        if sfx:  # the bf16 forms take the wgmma kernels on these inputs
            kernel = "lse_wg" if name == "lse_forward" else "grad_wg"
            route = (F.lse_route if name == "lse_forward" else F.grad_route)(q, neg)
            require(route == kernel, f"{name}{sfx} took {route}, not {kernel}")
            source += f":{source_line(source, kernel + '(const __grid_constant__')}"
            design = WG_DESIGNS[kernel]
        row = _row(name + sfx, source, f"models_tpu/ops/flash_ce.py:{line}",
                   launches[name + sfx], errs[name + sfx], cuda_ms(fn), cuda_ms(plain, reps=3),
                   cuda_ms(lib, reps=3), flops, nbytes, PEAK_3XTF32,
                   ms_cold=device_ms(fn, cold=True) if name == "lse_forward" else None,
                   extra=extra)
        if design:
            row["design"] = design
        rows.append(row)
    return rows


WG_DESIGNS = {
    "lse_wg": "lse_wg: wgmma, TMA ring, the next tile's logits in flight during this tile's "
              "exponentials (ex2 with the scale folded into one fma)",
    "grad_wg": "grad_wg: wgmma, TMA ring, 3xbf16 gradient product",
}


def source_line(path: str, text: str) -> int:
    """The line of ``path`` (from the repo's root) where ``text`` first
    appears."""
    with open(os.path.join(ROOT, path)) as f:
        for n, ln in enumerate(f, 1):
            if text in ln:
                return n
    raise AssertionError(f"{text!r} not in {path}")


# ---------------------------------------------------------------------------
# row-sparse and bf16-at-rest embedding training
# ---------------------------------------------------------------------------


def raw_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def skewed_ids(n: int, card: int, seed: int) -> np.ndarray:
    """Ids with the data generator's popularity skew (id 0 reserved)."""
    p = 1.0 / np.arange(2, card + 1) ** 0.75
    return np.random.default_rng(seed).choice(np.arange(1, card), size=n,
                                              p=p / p.sum()).astype(np.int32)


def scatter_case(dev, gen, R, D, N, dtype, ids, valid=None, errs=None):
    """Kernel against plain version, both scatters, on copies of one table:
    the results must be equal bit for bit; ``errs`` keeps each kernel's
    largest |difference|. ``ids`` None: a deduplicated skewed batch, its
    stale duplicates then marked invalid and their ids moved out of range,
    so that the kernel must skip them unread."""
    from models_tpu_torch.ops import scatter as S

    if ids is None:
        raw = torch.as_tensor(skewed_ids(N, R - 3, SEED + N + D), device=dev)
        ids, _, valid = S.dedup_rows(raw, torch.zeros(N, 1, device=dev))
        ids = torch.where(valid | (torch.arange(N, device=dev) % 2 == 0), ids,
                          torch.where(torch.arange(N, device=dev) % 4 == 1, 999_999, -7))
        ids = ids.to(torch.int32).contiguous()
    table = torch.randn(R, D, device=dev, generator=gen).to(dtype)
    upd = torch.randn(N, D, device=dev, generator=gen)
    rows = torch.randn(N, D, device=dev, generator=gen).to(dtype)
    for name, fn, plain, arg in (("add", S.row_scatter_add, S.row_scatter_add_plain, upd),
                                 ("write", S.row_scatter_write, S.row_scatter_write_plain, rows)):
        got, want = fn(table.clone(), ids, arg, valid), plain(table.clone(), ids, arg, valid)
        err = max_err(got.float(), want.float())
        errs[f"row_scatter_{name}"] = max(errs[f"row_scatter_{name}"], err)
        require(torch.equal(raw_bits(got), raw_bits(want)),
                f"row_scatter_{name} R={R} D={D} N={N} {dtype}: differs from the plain version "
                f"(max|d| {err})")
    n_valid = N if valid is None else int(valid.sum())
    return n_valid


def phase_row_scatter(dev, gen, errs):
    """K7 and K8 against their plain versions, bit for bit: the userId table
    at the path's batch (a deduplicated skewed batch with stale duplicates
    and out-of-range ids on invalid positions), genres-like (81,920 ids over
    24 rows), D = 64 and 200, D = 130 and misaligned rows (the scalar path),
    fp32 and bf16 tables, N = 1 and no valid position; K7's batch edges
    (N = 31, 33, 32 P - 1, 32 P + 1, N = 3, fewer positions than the grid's
    warps, D = 256), with ids -7 and R + 7 on invalid and valid positions."""
    from models_tpu_torch.ops import scatter as S

    errs["row_scatter_add"] = errs["row_scatter_write"] = 0.0
    cases = [(USER_ROWS, 128, 8192), (24, 128, 81_920), (4096, 64, 2048), (4096, 200, 2048),
             (4096, 130, 2048)]
    for R, D, N in cases:
        for dtype in (torch.float32, torch.bfloat16):
            n_valid = scatter_case(dev, gen, R, D, N, dtype, None, errs=errs)
            print(f"  row scatters R={R} D={D} N={N} {dtype}: {n_valid} valid, bit-equal "
                  f"(write: {S.write_order(N, R)})", flush=True)
    one = torch.tensor([5], dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        none = torch.zeros(512, dtype=torch.bool, device=dev)
        scatter_case(dev, gen, 64, 128, 1, dtype, one, errs=errs)
        scatter_case(dev, gen, 64, 128, 1, dtype, one, none[:1], errs=errs)
        ids = torch.randperm(4096, device=dev, generator=gen)[:512].to(torch.int32)
        scatter_case(dev, gen, 4096, 128, 512, dtype, ids, none, errs=errs)
    # K7's batches of P positions a warp: ragged last batches, fewer
    # positions than the grid has warps, two pieces a lane (D = 256); valid
    # and invalid positions with ids -7 and R + 7
    P = S._lib().row_scatter_add_batch()
    R = 4096
    for N, D in ((31, 128), (33, 128), (32 * P - 1, 128), (32 * P + 1, 128), (3, 128),
                 (1000, 256)):
        ids = torch.randperm(R, device=dev, generator=gen)[:N].to(torch.int32)
        valid = torch.rand(N, device=dev, generator=gen) < 0.8
        off = torch.arange(N, device=dev)
        ids = torch.where(~valid & (off % 2 == 0), -7, ids)
        ids = torch.where(~valid & (off % 2 == 1), R + 7, ids)
        ids = torch.where(valid & (off % 13 == 5), R + 7, ids)  # valid, out of range: dropped
        ids = torch.where(valid & (off % 13 == 6), -7, ids).to(torch.int32).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            n_valid = scatter_case(dev, gen, R, D, N, dtype, ids, valid, errs=errs)
        in_range = int(((ids >= 0) & (ids < R) & valid).sum())
        print(f"  row scatters P={P} N={N} D={D}: {n_valid} valid ({in_range} in range), fp32 "
              "and bf16 tables bit-equal", flush=True)
    # K8's batches of P positions a warp, its rows one run of 16-byte pieces
    # (two bf16 rows of 128 an instruction, pieces split across rows at
    # D = 200 bf16): one position, a batch short by one and one past it,
    # ragged batches, N past 32 P; the same ids as K7's edges
    P = S._lib().row_scatter_write_batch()
    for N in (1, P - 1, P + 1, 33, 257):
        ids = torch.randperm(R, device=dev, generator=gen)[:N].to(torch.int32)
        valid = torch.rand(N, device=dev, generator=gen) < 0.8
        off = torch.arange(N, device=dev)
        ids = torch.where(~valid & (off % 2 == 0), -7, ids)
        ids = torch.where(~valid & (off % 2 == 1), R + 7, ids)
        ids = torch.where(valid & (off % 13 == 5), R + 7, ids)
        ids = torch.where(valid & (off % 13 == 6), -7, ids).to(torch.int32).contiguous()
        for D in (64, 128, 200, 256):
            for dtype in (torch.float32, torch.bfloat16):
                scatter_case(dev, gen, R, D, N, dtype, ids, valid, errs=errs)
        print(f"  row scatters P={P} (write: {S.write_order(N, R)}) N={N} D=64, 128, 200, 256: "
              "fp32 and bf16 tables bit-equal", flush=True)
    # rows one element off 16-byte alignment take the scalar path
    ids = torch.randperm(4096, device=dev, generator=gen)[:512].to(torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn(4096, 128, device=dev, generator=gen).to(dtype)
        buf = torch.randn(512 * 128 + 1, device=dev, generator=gen)
        for name, fn, plain, arg in (
                ("add", S.row_scatter_add, S.row_scatter_add_plain, buf[1:].view(512, 128)),
                ("write", S.row_scatter_write, S.row_scatter_write_plain,
                 buf.to(dtype)[1:].view(512, 128))):
            got, want = fn(table.clone(), ids, arg), plain(table.clone(), ids, arg)
            errs[f"row_scatter_{name}"] = max(errs[f"row_scatter_{name}"],
                                              max_err(got.float(), want.float()))
            require(torch.equal(raw_bits(got), raw_bits(want)),
                    f"row_scatter_{name} {dtype}, misaligned rows")
    print("  row scatters N=1, no valid position, misaligned rows: bit-equal", flush=True)


def sparse_launches():
    from models_tpu_torch.ops import scatter as S

    return {**flash_launches(), "row_scatter_add": S.row_scatter_add.launches,
            "row_scatter_write": S.row_scatter_write.launches}


def zero_launches():
    from models_tpu_torch.ops import flash_ce as F
    from models_tpu_torch.ops import scatter as S

    for fn in (F.lse_forward, F.grad_query, F.grad_neg, S.row_scatter_add, S.row_scatter_write):
        fn.launches = 0
    for fn in (F.lse_forward, F.grad_query, F.grad_neg):
        fn.launches_bf16 = 0


def cpu_noise(shape, salt, step, device):
    """The rounding noise of the CPU's generator, wherever the table lies."""
    from models_tpu_torch.blocks.optimizer import draw_noise

    return draw_noise(shape, salt, step, "cpu").to(device)


def compile_sparse(model):
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[],
                  embedding_optimizer="adagrad")
    return model


def seen_ids(data, batch) -> dict:
    """Every id each column's lookups see in ``fit`` over ``data`` (padding
    included), as numpy."""
    from models_tpu_torch.data import Loader

    seen = {}
    for x, _ in Loader(data, batch, drop_last=True):
        for name in ("userId", "movieId", "genres"):
            v = getattr(x[name], "values", x[name])
            seen.setdefault(name, []).append(np.ravel(v))
    return {k: np.unique(np.concatenate(v)) for k, v in seen.items()}


def phase_sparse_checks(dev, models):
    """Three row-sparse adagrad steps at batch 1024 on the card and on a CPU
    copy, both rounding bf16 tables with the CPU generator's noise. Losses
    within 1e-5; dense parameters, fp32 tables and the acc slots within
    PARAM_ATOL; a bf16 table element may differ by one bf16 ulp where the
    two sides' fp32 sums differ in the last bits and the noise falls
    between them (at most 1e-3 of the elements the steps wrote)."""
    import copy

    import models_tpu_torch as mt

    small = mt.generate_data("movielens-25m", num_rows=1024, seed=SEED + 5)
    written = seen_ids(small, 1024)
    for tag, model in models.items():
        on_card, on_cpu = copy.deepcopy(model), copy.deepcopy(model).to("cpu")
        hist = {}
        for side, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
            compile_sparse(m)._emb_opt.noise = cpu_noise
            hist[side] = m.fit(small, epochs=3, batch_size=1024, shuffle=False,
                               device=d).history["loss"]
        np.testing.assert_allclose(hist["card"], hist["cpu"], rtol=FCE_TOL)
        cpu = {**dict(on_cpu.named_parameters()), **dict(on_cpu.named_buffers())}
        worst, flips, n_written = 0.0, 0, 0
        for name, t in list(on_card.named_parameters()) + list(on_card.named_buffers()):
            got, want = t.detach().cpu(), cpu[name].detach()
            if got.dtype == torch.bfloat16:
                d = (got.float() - want.float()).abs()
                # one bf16 ulp is at most 2**-7 of the larger neighbour
                ulp = torch.maximum(got.float().abs(), want.float().abs()) * 2.0 ** -7
                require(bool((d <= ulp).all()), f"{tag}: {name} off by more than one bf16 ulp")
                flips += int((d > 0).sum())
                n_written += len(written[name.split(".")[-2]]) * got.shape[1]
            else:
                worst = max(worst, max_err(got, want))
        require(worst <= PARAM_ATOL, f"{tag}: card and CPU differ by {worst:.3g}")
        require(flips <= 1e-3 * max(n_written, 1), f"{tag}: {flips} bf16 rounding flips")
        print(f"  3 sparse adagrad steps at batch 1024, {tag} tables, card vs CPU: losses "
              f"{hist['card']} vs {hist['cpu']}; fp32 parameters and slots max|d| {worst:.3g}"
              + (f"; bf16 elements one ulp apart {flips} of {n_written} written"
                 if n_written else ""), flush=True)


def phase_sparse_train(dev, models, catalog, queries):
    """The slice's path at full width: fit 16 steps of 8192 rows with
    ``embedding_optimizer="adagrad"``, fp32 tables and bf16 tables. Each step
    must launch K1-K3 once, K7 six times with fp32 tables (acc and table of
    userId, movieId and genres) or three times with K8 three times with bf16
    tables; losses finite; rows no batch looked up unchanged; the trained
    model serves 256 rows."""
    import models_tpu_torch as mt

    data = mt.generate_data("movielens-25m", num_rows=8 * TRAIN_BATCH, seed=SEED + 3)
    steps = 2 * data.num_rows // TRAIN_BATCH
    seen = seen_ids(data, TRAIN_BATCH)
    launches, out = {}, {}
    for tag, model in models.items():
        compile_sparse(model)
        tables = {t.block_name: t for t in model._embedding_tables()}
        before = {n: t.table.detach().clone() for n, t in tables.items()}
        zero_launches()
        t = time.perf_counter()
        hist = model.fit(data, epochs=2, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
        torch.cuda.synchronize()
        launches[tag] = n = sparse_launches()
        print(f"  fit {steps} sparse steps, {tag} tables, in {time.perf_counter() - t:.2f} s: "
              f"loss {hist.history['loss']}, launches {n}", flush=True)
        k7, k8 = (6, 0) if tag == "fp32" else (3, 3)
        want = {"lse_forward": steps, "grad_query": steps, "grad_neg": steps,
                "row_scatter_add": k7 * steps, "row_scatter_write": k8 * steps}
        require(n == want, f"{tag} tables: launches {n}, want {want}")
        require(all(np.isfinite(hist.history["loss"])), f"{tag} tables: non-finite loss")
        for name, table in tables.items():
            require(table.table.dtype == (torch.float32 if tag == "fp32" else torch.bfloat16),
                    f"{name} changed dtype")
            keep = np.setdiff1d(np.arange(table.table.shape[0]), seen[name])
            keep = torch.as_tensor(keep, device=dev)
            require(torch.equal(raw_bits(table.table.detach()[keep]), raw_bits(before[name][keep])),
                    f"{tag}: rows of {name} that no batch looked up changed")
            require(not torch.equal(table.table.detach(), before[name]), f"{name} never moved")
        enc = model.to_top_k_encoder(catalog, k=K, batch_size=1024, device=dev)
        res = enc.predict(queries.take(256), batch_size=256, device=dev)
        require(res["scores"].shape == (256, K) and np.isfinite(res["scores"]).all(),
                f"{tag}: the trained model serves non-finite scores")
        out[f"sparse_{tag}_fit_loss"] = hist.history["loss"]
        out[f"sparse_{tag}_fit_examples_per_sec"] = hist.history["examples_per_sec"]
    print("  rows outside the batches unchanged; the trained models serve 256 rows", flush=True)
    return data, launches, out


def opt_step_times(dev, gen):
    """The bench's op-level embedding-optimizer steps (``bench.py:837-875``)
    through the port's optimizer, B = 8192 uniform ids per step (new ones
    each step), D = 128: row-sparse adagrad on a 4M-row fp32 table (dedup,
    gathers, two K7), the dense adagrad step on the same table as its
    yardstick (a full (R, D) gradient, accumulator and update, plain torch),
    and row-sparse adagrad on a 16M-row bf16 table (K7 on acc, stochastic
    rounding, K8). Per step: device time (``device_ms``) and wall time of
    back-to-back steps (CUDA events, which the host's launch rate sets when
    the device work is small)."""
    import torch.nn.functional as Fn

    from models_tpu_torch.blocks.optimizer import SparseEmbeddingOptimizer
    from models_tpu_torch.inputs.embedding import EmbeddingTable
    from models_tpu_torch.schema import create_categorical_column

    B, D = 8192, 128
    out = {}
    for tag, R, dtype in (("sparse_adagrad_4M_fp32", OP_ROWS_FP32, torch.float32),
                          ("sparse_adagrad_16M_bf16", OP_ROWS_BF16, torch.bfloat16)):
        table = EmbeddingTable(D, create_categorical_column("item", R - 1), dtype=dtype,
                               seed=SEED, device=dev)
        opt = SparseEmbeddingOptimizer("adagrad", 0.05)
        opt.init_slots(table)
        ids = [torch.randint(0, R, (B,), device=dev, generator=gen, dtype=torch.int32)
               for _ in range(128)]
        g = torch.full((B, D), 1e-6, device=dev)
        steps = iter(range(10 ** 6))

        def step():
            t = next(steps)
            opt.apply(table, ids[t % len(ids)], g, t)

        out[f"{tag}_device_ms"] = device_ms(step, reps=50)
        out[f"{tag}_wall_ms"] = cuda_ms(step, reps=50, warmup=3)
        del table, opt
        torch.cuda.empty_cache()
    R = OP_ROWS_FP32
    w = torch.full((R, D), 1e-12, device=dev, requires_grad=True)
    acc = torch.full((R, D), 0.1, device=dev)
    ids = [torch.randint(0, R, (B,), device=dev, generator=gen) for _ in range(5)]
    steps = iter(range(10 ** 6))

    def dense_step():
        w.grad = None
        (Fn.embedding(ids[next(steps) % len(ids)], w).sum() * 1e-6).backward()
        with torch.no_grad():
            acc.addcmul_(w.grad, w.grad)
            w.sub_(0.05 * w.grad / (acc.sqrt() + 1e-8))

    out["dense_adagrad_4M_fp32_device_ms"] = device_ms(dense_step, reps=5, warmup=2)
    out["dense_adagrad_4M_fp32_wall_ms"] = cuda_ms(dense_step, reps=5, warmup=1)
    del w, acc
    torch.cuda.empty_cache()
    return out


def scatter_design(name: str) -> str:
    """The design of K7 or K8, for the kernels line."""
    from models_tpu_torch.ops import scatter as S

    if name == "row_scatter_add":
        return (f"batches of {S._lib().row_scatter_add_batch()} positions a warp, the batch's "
                "ids in one load, grid from occupancy")
    return (f"batches of {S._lib().row_scatter_write_batch()} positions a warp, the batch's ids "
            "in one load, its rows one run of 16-byte pieces read once before the first "
            "store (beside the ids where N <= R, after them where N > R), grid from occupancy")


def measure_row_scatter(dev, gen, launches, errs):
    """K7 and K8 timed at the op-level step's shape (a 4M x 128 table, a
    deduplicated batch of 8192 ids) and at the model's (the userId table,
    162,544 x 128), beside the plain versions and ``index_add_`` /
    ``index_copy_`` on the valid ids compacted beforehand. K7 on an fp32
    table, K8 on a bf16 one, as the path runs them. Times are device time
    per call from the profiler with the L2 flushed before each call
    (``device_ms(cold=True)``), as the bound assumes; the times with the rows
    left in L2 by the call before, and the back-to-back event time of the
    wrappers (the host's launch rate), are printed beside."""
    from models_tpu_torch.ops import scatter as S

    B, D = 8192, 128
    rows, extra = [], {}
    for R in (OP_ROWS_FP32, USER_ROWS):
        raw = torch.randint(0, R, (B,), device=dev, generator=gen, dtype=torch.int32)
        ids, _, valid = S.dedup_rows(raw, torch.zeros(B, 1, device=dev))
        ids_v = ids[valid].long()
        n = int(valid.sum())
        upd = torch.randn(B, D, device=dev, generator=gen)
        for name, line, dtype, fn, plain, lib, nbytes in (
                ("row_scatter_add", 372, torch.float32, S.row_scatter_add,
                 S.row_scatter_add_plain, lambda t, a, a_v: t.index_add_(0, ids_v, a_v),
                 3 * n * D * 4 + B * 5),
                ("row_scatter_write", 243, torch.bfloat16, S.row_scatter_write,
                 S.row_scatter_write_plain, lambda t, a, a_v: t.index_copy_(0, ids_v, a_v),
                 2 * n * D * 2 + B * 5)):
            table = torch.randn(R, D, device=dev, generator=gen).to(dtype)
            arg = upd if name == "row_scatter_add" else upd.to(dtype)
            arg_v = arg[valid]
            def kernel():
                return fn(table, ids, arg, valid)

            ms = device_ms(kernel, cold=True)
            plain_ms = device_ms(lambda: plain(table, ids, arg, valid), reps=10, cold=True)
            lib_ms = device_ms(lambda: lib(table, arg, arg_v), cold=True)
            row = _row(name, "models_tpu_torch/csrc/row_scatter.cu",
                       f"models_tpu/ops/scatter.py:{line}", launches[name], errs[name], ms,
                       plain_ms, lib_ms, 0, nbytes)
            row["design"] = scatter_design(name)
            if name == "row_scatter_write":
                row["order"] = S.write_order(B, R)
            extra[f"{name}_R{R}"] = {
                **{k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                "read_flush_ms": device_ms(kernel, cold="read"),
                "l2_warm_ms": device_ms(kernel),
                "library_l2_warm_ms": device_ms(lambda: lib(table, arg, arg_v)),
                "back_to_back_ms": cuda_ms(kernel, reps=50)}
            if R == OP_ROWS_FP32:
                rows.append(row)
            del table
        print(f"  R={R}: {n} of {B} ids valid", flush=True)
    print("row scatters " + json.dumps(extra), flush=True)
    return rows


# ---------------------------------------------------------------------------
# the row gather (K9), and the int8 forms of K5 and K6
# ---------------------------------------------------------------------------


def gather_case(name, table, ids, errs, plan=None):
    """K9 against its plain version: equal bit for bit. Prints the kernel's
    plan (piece bytes, lanes a row, rows a warp) and, with ``plan``,
    requires it."""
    from models_tpu_torch.ops import embedding_lookup as E

    got, want = E.row_gather(table, ids), E.row_gather_plain(table, ids)
    torch.cuda.synchronize()
    require(got.dtype == table.dtype and got.shape == want.shape, f"row_gather {name}: "
            f"{got.dtype} {tuple(got.shape)}")
    err = max_err(got.float(), want.float())
    errs["row_gather"] = max(errs["row_gather"], err)
    require(torch.equal(raw_bits(got), raw_bits(want)),
            f"row_gather {name}: differs from the plain version (max|d| {err})")
    got_plan = E.gather_plan(table, got)
    require(plan is None or got_plan == plan, f"row_gather {name}: plan {got_plan}, want {plan}")
    print(f"  row_gather {name}: bit-equal, {got_plan}", flush=True)


# the device-resident training route's pack: movielens-25m's columns as 26
# int32 a row (movieId, userId, genres' 10 values and 10 mask, two
# continuous columns, two targets), 2**20 rows, one chunk of 16 batches
PACK_ROWS, PACK_COLS, PACK_IDS = 1 << 20, 26, 16 * 8192
PACK_PLAN = {"piece_bytes": 8, "lanes": 16, "rows_per_warp": 16}


def phase_gather(dev, gen, errs):
    """K9 against its plain version, bit for bit: fp32, bf16 and fp16 tables
    of R % 8 != 0 rows, duplicates, ids at both ends, B = 1 and B not a
    multiple of a warp's rows, ids out of range (clamped), D = 7 (4- and
    2-byte pieces), D = 256 (two passes of 32 lanes), a table one element off
    16-byte alignment; the training route's pack (int32, 26 columns: 13
    pieces of 8 bytes, 16 lanes a row) and a view of it 8 bytes off 16-byte
    alignment; and at the bench's op-level sizes, 8192 ids into 4M x 128
    fp32 and 16M x 128 bf16 tables."""
    errs["row_gather"] = 0.0
    R = 1003
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        table = torch.randn(R, 128, device=dev, generator=gen).to(dtype)
        ids = torch.randint(0, R, (1000,), device=dev, generator=gen, dtype=torch.int32)
        ids[:6] = torch.tensor([0, R - 1, 5, 5, 5, R - 1], dtype=torch.int32)
        ids[500:503] = torch.tensor([-3, R, R + 77], dtype=torch.int32)  # clamped
        gather_case(f"R={R} D=128 B=1000 {dtype}", table, ids, errs)
        gather_case(f"R={R} D=128 B=1 {dtype}", table, ids[1:2].contiguous(), errs)
        narrow = torch.randn(R, 7, device=dev, generator=gen).to(dtype)
        gather_case(f"R={R} D=7 {dtype}", narrow, ids, errs)
        buf = torch.randn(R * 128 + 1, device=dev, generator=gen).to(dtype)
        gather_case(f"R={R} D=128 misaligned {dtype}", buf[1:].view(R, 128), ids, errs)
    wide = torch.randn(R, 256, device=dev, generator=gen)
    gather_case(f"R={R} D=256 fp32", wide, ids, errs)
    buf = torch.randint(-2**31, 2**31 - 1, (PACK_ROWS * PACK_COLS + 2,), device=dev,
                        generator=gen, dtype=torch.int32)
    ids = torch.randint(0, PACK_ROWS, (PACK_IDS,), device=dev, generator=gen, dtype=torch.int32)
    ids[:4] = torch.tensor([0, PACK_ROWS - 1, -1, PACK_ROWS], dtype=torch.int32)
    gather_case(f"pack R={PACK_ROWS} D={PACK_COLS} B={PACK_IDS} int32",
                buf[:PACK_ROWS * PACK_COLS].view(PACK_ROWS, PACK_COLS), ids, errs, PACK_PLAN)
    gather_case(f"pack R={PACK_ROWS} D={PACK_COLS} 8 bytes off 16 int32",
                buf[2:].view(PACK_ROWS, PACK_COLS), ids, errs, PACK_PLAN)
    gather_case(f"R={R} D=128 8 bytes off 16 fp32", buf[2:2 + R * 128].view(torch.float32)
                .view(R, 128), ids[:1000].remainder(R), errs,
                {"piece_bytes": 8, "lanes": 32, "rows_per_warp": 8})
    del buf
    for R, dtype in ((OP_ROWS_FP32, torch.float32), (OP_ROWS_BF16, torch.bfloat16)):
        table = torch.empty(R, 128, device=dev, dtype=dtype).normal_(generator=gen)
        ids = torch.randint(0, R, (8192,), device=dev, generator=gen, dtype=torch.int32)
        ids[:2] = torch.tensor([0, R - 1], dtype=torch.int32)
        gather_case(f"R={R} D=128 B=8192 {dtype}", table, ids, errs)
        del table
    torch.cuda.empty_cache()


def quantized_catalog(dev, gen, C, D=128, per_bin=True):
    """Random int8 rows and positive fp32 scales, one per 64-row bin."""
    c8 = torch.randint(-127, 128, (C, D), device=dev, generator=gen, dtype=torch.int8)
    n_scales = -(-C // 64) if per_bin else C
    scale = torch.rand(n_scales, device=dev, generator=gen) * 0.03 + 0.002
    if per_bin:
        scale = scale.repeat_interleave(64)[:C].contiguous()
    return c8, scale


def phase_int8_kernels(dev, gen, errs):
    """The int8 forms: K5 (int8 x int8 -> int32) bit-equal to its plain
    version at the serving bins, at D = 130 (no whole 4-byte words) and on a
    misaligned catalog; K6 with int8 rows and per-row scales within the fp32
    tolerance, with planted ties, at the serving sizes and over 1M rows; and
    the int8 binned route where its product pads (D = 130, 5 query rows, 37
    rows past the last bin), card and CPU equal bit for bit."""
    from models_tpu_torch.ops import topk as T

    # K5 int8's and K6 int8's errors began in phase_kernels
    for D, offset in ((128, 0), (130, 0), (128, 1)):
        q8 = torch.randint(-127, 128, (256, D), device=dev, generator=gen, dtype=torch.int8)
        buf = torch.randint(-127, 128, (886 * 64 * D + offset,), device=dev, generator=gen,
                            dtype=torch.int8)
        c8 = buf[offset:].view(886 * 64, D)
        idx = torch.randint(0, 886, (256, 12), device=dev, generator=gen, dtype=torch.int32)
        route = rescore_case(dev, q8, c8, idx, f"offset={offset} D={D}", errs)
        require(route == ("bins" if (D, offset) == (128, 0) else "rows"),
                f"binned_rescore int8 D={D} offset={offset}: route {route}")
    for B, C, n_valid, k in ((4096, 56_704, CATALOG, K), (16, 56_704, CATALOG, 512),
                             (8, 1_000_000, None, K)):
        q = torch.randn(B, 128, device=dev, generator=gen)
        c8, scale = quantized_catalog(dev, gen, C, per_bin=False)
        scale[7] = 1.0  # row 7 and its copies outscore every row against row 7
        for dup in (C // 3, C // 2, (n_valid or C) - 1):  # planted ties
            c8[dup], scale[dup] = c8[7], scale[7]
        got = T.streaming_topk(q, c8, k, n_valid=n_valid, scale=scale)
        want = T.streaming_topk_plain(q, c8, k, n_valid=n_valid, scale=scale)
        err = check_topk(f"streaming_topk int8 B={B} C={C} n_valid={n_valid} k={k}", got, want,
                         positions=True)
        errs["streaming_topk_int8"] = max(errs["streaming_topk_int8"], err)
        s, pos = T.streaming_topk(c8[7:8].float().contiguous(), c8, 4, n_valid=n_valid,
                                  scale=scale)
        require(pos[0, :4].tolist() == sorted(pos[0, :4].tolist()) and pos[0, 0].item() == 7,
                f"int8 planted ties resolved as {pos.tolist()}")
    C = 886 * 64 + 37
    c8, scale = quantized_catalog(dev, gen, C, D=130)
    for B in (5, 256):
        q = torch.randn(B, 130, device=dev, generator=gen)
        args = dict(n_valid=C - 7, col_scale_per_bin=True)
        s, i = T.binned_topk(q, c8, K, col_scale=scale, device=dev, **args)
        cs, ci = T.binned_topk(q.cpu(), c8.cpu(), K, col_scale=scale.cpu(), device="cpu", **args)
        require(torch.equal(i.cpu(), ci) and torch.equal(raw_bits(s.cpu()), raw_bits(cs)),
                f"int8 binned route B={B} D=130 C={C}: card and CPU differ")
        print(f"  int8 binned route B={B} D=130 C={C}: card and CPU equal", flush=True)


def bin_max_case(name, q, c, errs, bs=64, scale=None, per_bin=False, n_valid=None,
                 expect=None) -> float:
    """K4 against its plain version on one case, in the design the plan
    picks (``bin_max_design``; ``expect``: the design these shapes must
    take), printing its plan: the same bits from two calls; int8 bit-equal,
    fp32 and bf16 within ``tol_for`` (NaN maxima where the plain version has
    them); the kb bins that ``stable_topk`` then selects equal outside
    near-ties. Returns the error."""
    from models_tpu_torch.ops import topk as T

    design = T.bin_max_design(c.dtype, q.shape[1], bs, c.data_ptr() % 16 == 0)
    if expect is not None:
        require(design == expect, f"bin_max {name}: the plan picks {design}, not {expect}")
    got = T.bin_max(q, c, bs, scale, per_bin)
    again = T.bin_max(q, c, bs, scale, per_bin)
    # the plain version on aligned copies: the cuBLASLt int8 product refuses
    # operands off 16-byte alignment
    want = T.bin_max_plain(q.clone(), c.clone(), bs, scale, per_bin)
    torch.cuda.synchronize()
    B, L = want.shape
    name = f"{name} [{design}]"
    require(got.shape == (B, L) and got.dtype == torch.float32, f"bin_max {name}: {got.shape}")
    require(torch.equal(raw_bits(got), raw_bits(again)), f"bin_max {name}: two calls differ")
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan), f"bin_max {name}: NaN maxima differ")
    kb = min(K + 2 + (1 if n_valid is not None and n_valid < L * bs else 0), L)
    if c.dtype == torch.int8:
        require(torch.equal(raw_bits(got), raw_bits(want)), f"bin_max int8 {name}: differs")
        require(torch.equal(T.stable_topk(got, kb)[1], T.stable_topk(want, kb)[1]),
                f"bin_max int8 {name}: selected bins differ")
        err, tag, what = 0.0, "bin_max_int8", "equal"
    else:
        err = T.max_abs_err(got[~nan], want[~nan])
        tol = tol_for(want[~nan])
        require(err <= tol, f"bin_max {c.dtype} {name}: max|d| {err} (tol {tol})")
        rows = ~nan.any(dim=1)
        (gs, gi), (ws, wi) = T.stable_topk(got[rows], kb), T.stable_topk(want[rows], kb)
        require(T.ids_agree(gs.cpu(), gi.cpu(), ws.cpu(), wi.cpu(), tol),
                f"bin_max {c.dtype} {name}: selected bins differ outside near-ties")
        tag, what = "bin_max", f"max|d| {err:.3g} (tol {tol:.3g}), bins agree"
    errs[tag] = max(errs.get(tag, 0.0), err)
    # bin_max_plan reports rows on a 16-byte address: not these, if the
    # design differs
    plan = T.bin_max_plan(c.dtype, B, q.shape[1], L, bs)
    plan = plan if plan["design"] == design else "(rows off a 16-byte address)"
    print(f"  bin_max {name} B={B} L={L} bs={bs} D={q.shape[1]} {c.dtype}"
          f"{'' if scale is None else ' per-bin scale' if per_bin else ' per-row scale'}: "
          f"{what}; plan {plan}", flush=True)
    return err


def phase_bin_max(dev, gen, errs):
    """K4 against its plain version on the card, each case in the design
    the plan picks, which the case names: the wgmma design at 1M x 128 at B
    = 256, 1365 (the binned route's bound at k = 10) and 8, fp32, bf16 and
    int8 with per-bin and per-row scales; at the serving paths' widths (D =
    128, 64, 32) at 300 query rows, bins of 64 and 128, both scale forms; at
    the widths between them (fp32 D = 4, 48, 72, 96: depth past D from the
    TMA's zero fill, and at 72 and 96 a tile's unused slab zeroed; bf16 D =
    8, 120; int8 D = 16, 48); bins of 128 (two tiles a bin), one row and a
    NaN query row. The first design at its shapes: D = 130 (no 16-byte rows)
    with n_valid padding; D = 300 (query rows streamed with the tiles); rows
    off 16-byte alignment; bins of 40 and 8 rows (the reduction through
    shared memory)."""
    from models_tpu_torch.ops import topk as T

    C = 1_000_000
    cand = torch.randn(C, 128, device=dev, generator=gen)
    c8, sc_bin = quantized_catalog(dev, gen, C)
    sc_row = torch.rand(C, device=dev, generator=gen) * 0.03 + 0.002
    for B in (256, 1365, 8):
        q = torch.randn(B, 128, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            bin_max_case("1M", q, cand.to(dtype), errs, expect="wgmma")
        q8, _ = T.quantize_queries(q)
        bin_max_case("1M", q8, c8, errs, scale=sc_bin, per_bin=True, expect="wgmma")
        bin_max_case("1M", q8, c8, errs, scale=sc_row, expect="wgmma")
    del cand, c8, sc_bin, sc_row
    # the serving paths' widths: the two-tower and the 1M / 2**24 layers
    # (128), the MF (64), YouTube-DNN (32); 300 rows, off the warpgroups' 64
    n = 886 * 64
    for D in (128, 64, 32):
        q = torch.randn(300, D, device=dev, generator=gen)
        c = torch.randn(n, D, device=dev, generator=gen)
        c8, sc_bin = quantized_catalog(dev, gen, n, D)
        sc_row = torch.rand(n, device=dev, generator=gen) * 0.03 + 0.002
        q8, _ = T.quantize_queries(q)
        for bs in (64, 128):
            name = f"serving D={D}"
            for dtype in (torch.float32, torch.bfloat16):
                bin_max_case(name, q, c.to(dtype), errs, bs=bs, expect="wgmma")
            bin_max_case(name, q8, c8, errs, bs=bs, scale=sc_bin, per_bin=True, expect="wgmma")
            bin_max_case(name, q8, c8, errs, bs=bs, scale=sc_row, expect="wgmma")
            bin_max_case(name, q8, c8, errs, bs=bs, expect="wgmma")
    # the widths between them: a whole number of 16-byte pieces, at most 128
    n = 300 * 64
    for dtype, widths in ((torch.float32, (4, 48, 72, 96)), (torch.bfloat16, (8, 120)),
                          (torch.int8, (16, 48))):
        for D in widths:
            q = torch.randn(100, D, device=dev, generator=gen)
            name = f"D={D}"
            if dtype != torch.int8:
                c = torch.randn(n, D, device=dev, generator=gen).to(dtype)
                bin_max_case(name, q, c, errs, expect="wgmma")
                continue
            c8, sc_bin = quantized_catalog(dev, gen, n, D)
            sc_row = torch.rand(n, device=dev, generator=gen) * 0.03 + 0.002
            q8, _ = T.quantize_queries(q)
            bin_max_case(name, q8, c8, errs, scale=sc_bin, per_bin=True, expect="wgmma")
            bin_max_case(name, q8, c8, errs, scale=sc_row, expect="wgmma")
    # D = 130 with the padding an index carries; D = 300; misaligned rows
    for D, shift, n_valid in ((130, False, 886 * 64 - 41), (300, False, None),
                              (128, True, None)):
        q = torch.randn(100, D, device=dev, generator=gen)
        c = torch.randn(886 * 64, D, device=dev, generator=gen)
        c8, scale = quantized_catalog(dev, gen, 886 * 64, D)
        if n_valid is not None:
            c[n_valid:] = 0
            c8[n_valid:] = 0
        q8, _ = T.quantize_queries(q)
        place = misaligned if shift else (lambda x: x)
        name = f"D={D}{' misaligned' if shift else ''} n_valid={n_valid}"
        for dtype in (torch.float32, torch.bfloat16):
            bin_max_case(name, place(q), place(c.to(dtype)), errs, n_valid=n_valid,
                         expect="mma_sync")
        bin_max_case(name, place(q8), place(c8), errs, scale=scale, per_bin=True,
                     n_valid=n_valid, expect="mma_sync")
        bin_max_case(name, place(q8), place(c8), errs, scale=scale, n_valid=n_valid,
                     expect="mma_sync")
    # other bin sizes; one query row; a NaN query row
    q = torch.randn(33, 128, device=dev, generator=gen)
    c = torch.randn(64 * 300 + 5, 128, device=dev, generator=gen)
    c8, scale = quantized_catalog(dev, gen, 64 * 300 + 5)
    q8, _ = T.quantize_queries(q)
    for bs in (40, 8, 128):
        design = "wgmma" if bs == 128 else "mma_sync"
        bin_max_case(f"bs={bs}", q, c, errs, bs=bs, expect=design)
        bin_max_case(f"bs={bs}", q8, c8, errs, bs=bs, scale=scale, expect=design)
    bin_max_case("B=1", q[:1].contiguous(), c.to(torch.bfloat16), errs, expect="wgmma")
    q[3] = float("nan")
    bin_max_case("a NaN query row", q, c, errs, expect="wgmma")
    bin_max_case("a NaN query row, bs=40", q, c, errs, bs=40, expect="mma_sync")


# ---------------------------------------------------------------------------
# the int8 index, evaluation
# ---------------------------------------------------------------------------


def phase_serving_int8(dev, model, catalog, queries):
    """The int8 index of the catalog, built on the card and on the CPU from
    the same embeddings, equal bit for bit; 256 rows by the binned route (K4
    and K5 int8) on the card and the CPU from the same query embeddings, ids equal
    and scores bit-equal; 4096 rows through K6 int8, held against the plain
    route. Returns the encoder, the launch counts and the index build time."""
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import topk as T
    from models_tpu_torch.outputs.topk import BruteForce

    zero_topk_counts()
    t = time.perf_counter()
    enc = model.to_top_k_encoder(catalog, k=K, batch_size=1024, candidate_dtype=torch.int8,
                                 device=dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t) * 1e3
    bf = enc.blocks[-1].topk_layer
    require(bf.candidates.dtype == torch.int8 and bf.candidates.shape == (56_704, 128)
            and bf.n_valid == CATALOG and bf.scales_per_bin, "int8 index layout")
    for B in (256, 4096):
        before = T.streaming_topk.launches, T.binned_rescore.launches, T.bin_max.launches
        out = enc.predict(queries.take(B), batch_size=B, device=dev)
        ran = (T.streaming_topk.launches > before[0], T.binned_rescore.launches > before[1],
               T.bin_max.launches > before[2])
        require(ran == (B == 4096, B == 256, B == 256), f"int8 B={B}: K6, K5, K4 ran {ran}")
        require(out["scores"].shape == (B, K) and np.isfinite(out["scores"]).all()
                and ((out["ids"] >= 0) & (out["ids"] < CATALOG)).all(), f"int8 B={B} output")
    torch.cuda.synchronize()
    launches = topk_counts("the int8 serving path", "_int8")
    print(f"  int8 index built in {build_ms:.1f} ms, launches {launches}", flush=True)

    emb = model.candidate_embeddings(catalog, batch_size=1024, device=dev)
    on_card = BruteForce(K).index(emb.to_numpy_dict()["embedding"],
                                  emb.to_numpy_dict()["id"], dtype=torch.int8, device=dev)
    on_cpu = BruteForce(K).index(emb.to_numpy_dict()["embedding"],
                                 emb.to_numpy_dict()["id"], dtype=torch.int8, device="cpu")
    for name in ("candidates", "ids", "scales"):
        a, b = getattr(on_card, name).cpu(), getattr(on_cpu, name)
        require(torch.equal(raw_bits(a) if a.is_floating_point() else a,
                            raw_bits(b) if b.is_floating_point() else b),
                f"int8 index: {name} built on the card differs from the CPU build")
    require(torch.equal(bf.candidates.cpu(), on_cpu.candidates), "encoder's int8 index")
    x, _ = next(iter(Loader(queries, 4096)))
    with torch.no_grad():
        q4096 = model.query_encoder(to_device_batch(x, dev)).contiguous()
    q256 = q4096[:256]
    s, i = on_card(q256)
    cs, ci = on_cpu(q256.cpu())
    torch.cuda.synchronize()
    require(torch.equal(i.cpu(), ci), "int8 binned route: ids differ from the CPU route's")
    require(torch.equal(raw_bits(s.cpu()), raw_bits(cs)),
            "int8 binned route: scores differ from the CPU route's")
    print("  int8 index: card build equals the CPU build bit for bit; 256 rows, binned "
          "route, ids and scores equal to the CPU route's", flush=True)
    want = T.streaming_topk_plain(q4096, bf.candidates, K, ids=bf.ids, n_valid=bf.n_valid,
                                  scale=bf.scales)
    check_topk("serve int8 B=4096 vs plain", bf(q4096), want)
    return enc, launches, build_ms, q4096


def evaluate_model(dev, catalog):
    """A full-width two-tower compiled with the default metrics, every 4th
    step feeding them."""
    import models_tpu_torch as mt

    model = mt.TwoTowerModel(catalog.schema, query_tower=(256, 128), embedding_dim=128,
                             seed=SEED + 7, device=dev)
    model.compile(optimizer="adagrad", learning_rate=0.05, train_metrics_steps=4)
    return model


def phase_evaluate(dev, catalog):
    """The README's flow at full width: ``fit`` 8 steps of 8192 rows with the
    default top-k metrics on every 4th step (K1 must launch on exactly the
    other 6), in-batch ``evaluate`` at batch 8192 against a CPU copy (loss
    within FCE_TOL, metrics within METRIC_ATOL), then ``evaluate(item_corpus=
    ...)`` over the 56,680-item catalog with fp32, bf16 and int8 indexes,
    2048 queries a batch (K6 on the card, the plain route on the CPU copy),
    metrics within METRIC_ATOL."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.ops import flash_ce as F
    from models_tpu_torch.ops import topk as T

    model = evaluate_model(dev, catalog)
    data = mt.generate_data("movielens-25m", num_rows=8 * TRAIN_BATCH, seed=SEED + 8)
    zero_launches()
    hist = model.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    torch.cuda.synchronize()
    launches = flash_launches()
    print(f"  fit 8 steps with metrics every 4th: {hist.history}, launches {launches}",
          flush=True)
    require(all(n == 6 for n in launches.values()),
            f"K1-K3 launched {launches}, want 6 (the steps without metrics)")
    require(all(np.isfinite(v).all() for v in hist.history.values()), "non-finite history")
    require(0.0 <= hist.history["recall_at_10"][0] <= 1.0, "recall out of range")
    stamp("in-batch evaluate, card and CPU")

    small = mt.generate_data("movielens-25m", num_rows=TRAIN_BATCH, seed=SEED + 9)
    cpu_model = copy.deepcopy(model).to("cpu")
    got = model.evaluate(small, batch_size=TRAIN_BATCH, device=dev)
    want = cpu_model.evaluate(small, batch_size=TRAIN_BATCH, device="cpu")
    compare_eval("in-batch evaluate, batch 8192", got, want, TRAIN_BATCH)
    stamp("corpus evaluate, card and CPU")

    # 2048 queries (K6's side of the route), each labelled with an item the
    # card ranks in its fp32 top 10, at rank r % 10: the metrics then move
    # with every rank the two sides place differently
    q_rows = small.take(2048)
    top = model.to_top_k_encoder(catalog, k=K, device=dev).predict(q_rows, batch_size=2048,
                                                                   device=dev)
    cols = q_rows.to_numpy_dict()
    cols["movieId"] = top["ids"][np.arange(2048), np.arange(2048) % K].astype(np.int32)
    q_rows = mt.Dataset(cols, schema=q_rows.schema)
    corpus_launches = {}
    for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        before = T.streaming_topk.launches
        if dtype is None:  # the entry point; it builds the fp32 index itself
            got = model.evaluate(q_rows, batch_size=2048, item_corpus=catalog, k=K, device=dev)
            torch.cuda.synchronize()
            corpus_launches[tag] = T.streaming_topk.launches - before
            want = cpu_model.evaluate(q_rows, batch_size=2048, item_corpus=catalog, k=K,
                                      device="cpu")
        else:
            card_enc = model.to_top_k_encoder(catalog, k=K, candidate_dtype=dtype, device=dev)
            got = card_enc.evaluate(q_rows, batch_size=2048, device=dev)
            torch.cuda.synchronize()
            corpus_launches[tag] = T.streaming_topk.launches - before
            # the CPU copy serves the card's index: an element of a bf16 index
            # encoded on each side may round one bf16 ulp apart (and move an
            # int8 row to another bin); the int8 build itself was held bit
            # for bit against the CPU's above
            cpu_enc = cpu_model.to_top_k_encoder(catalog, k=K, candidate_dtype=dtype,
                                                 device="cpu")
            src, dst = card_enc.blocks[-1].topk_layer, cpu_enc.blocks[-1].topk_layer
            # what the copy's own index gives, printed: not a check
            own = cpu_enc.evaluate(q_rows, batch_size=2048, device="cpu")
            differ = dst.candidates != src.candidates.cpu()
            print(f"  the CPU copy's own {tag} index differs from the card's in "
                  f"{int(differ.sum())} of {differ.numel()} elements; its metrics from the "
                  f"card's by {max(abs(got[k] - own[k]) for k in got):.3g} at most", flush=True)
            for name in ("candidates", "ids", "scales"):
                value = getattr(src, name)
                setattr(dst, name, None if value is None else value.cpu())
            want = cpu_enc.evaluate(q_rows, batch_size=2048, device="cpu")
        require(corpus_launches[tag] == 1,
                f"corpus evaluate {tag}: K6 ran {corpus_launches[tag]} times")
        compare_eval(f"corpus evaluate, {tag} index, 2048 queries", got, want, 2048)
    return model, data, small, {**launches, "streaming_topk_corpus": corpus_launches}


# metrics, card vs CPU: the scores differ in the last bits, so a row whose
# relevant item is near-tied with a neighbour may rank it one place apart;
# one such flip at the top moves a mean by at most 0.5 / rows. Allowed: two
# flips in the in-batch evaluation (8192 rows), four in the corpus's (2048)
# evaluate, card vs CPU, by the rows evaluated: a row whose positive and a
# negative score within the two sides' rounding may rank either way (8192:
# one row; 2048: two rows; 4096, the session's predict-last evaluation: two
# rows)
METRIC_ATOL = {8192: 1.25e-4, 2048: 1e-3, 4096: 5e-4}


def compare_eval(name, got, want, rows):
    require(list(got) == list(want), f"{name}: keys {list(got)} vs {list(want)}")
    loss_err = abs(got["loss"] - want["loss"]) / max(abs(want["loss"]), 1e-30)
    require(loss_err <= FCE_TOL, f"{name}: loss {got['loss']} vs CPU {want['loss']}")
    worst = max(abs(got[k] - want[k]) for k in got if k != "loss")
    require(worst <= METRIC_ATOL[rows], f"{name}: metrics {got} vs CPU {want}")
    print(f"  {name}: card {got}; vs CPU: loss rel {loss_err:.3g}, metrics max|d| {worst:.3g}",
          flush=True)


def evaluate_times(dev, model, data, catalog):
    """examples/s of in-batch ``evaluate`` (65,536 rows, batch 8192) and of
    corpus ``evaluate`` (16,384 queries in batches of 4096; fp32 index, index
    build included, as the method builds it), host clock: each one call, the
    device route's first on its data (the eval pack uploaded, the chunks
    eager; phase 11b times the steady state of both routes)."""
    out = {}
    t = time.perf_counter()
    model.evaluate(data, batch_size=TRAIN_BATCH, device=dev)
    torch.cuda.synchronize()
    out["evaluate_in_batch_examples_per_sec"] = data.num_rows / (time.perf_counter() - t)
    q_rows = data.take(4 * 4096)
    for tag, dtype in (("fp32", None), ("int8", torch.int8)):
        t = time.perf_counter()
        enc = model.to_top_k_encoder(catalog, k=K, candidate_dtype=dtype, device=dev)
        enc.evaluate(q_rows, batch_size=4096, device=dev)
        torch.cuda.synchronize()
        out[f"evaluate_corpus_{tag}_examples_per_sec"] = q_rows.num_rows / (
            time.perf_counter() - t)
    return out


# phase 11b: the device-resident evaluate and in-fit validation
EVAL_QUERIES = 4 * 4096  # the corpus cases' queries: 4 batches of 4096 (K6), 64 of 256 (K4, K5)
EVAL_TIMED = 3  # calls a steady-state time is the median of (replays on the device route)
EVAL_TRACED = ("bin_max", "binned_rescore", "streaming_topk", "row_gather")
# a traced kernel by its demangled name (``void (anonymous namespace)::name...``):
# the wrapper whose call launches it, once a call (K6's merge kernel left out)
EVAL_KERNELS = {"bin_max_kernel": "bin_max", "bin_max_wg": "bin_max",
                "rescore_bins": "binned_rescore", "rescore": "binned_rescore",
                "rescore_i8": "binned_rescore", "topk_partial": "streaming_topk",
                "gather": "row_gather"}
EVAL_KERNEL_NAME = re.compile(r"^void \(anonymous namespace\)::(\w+)[<(]")
VAL_EPOCHS = 3
PREFETCH_FITS = 3  # timed fits of a turn (prefetched or in line)
PREFETCH_TIMED_ROWS = 32 * TRAIN_BATCH  # a timed fit's rows: 32 steps
PREFETCH_TURNS = ("prefetched", "in_line", "in_line", "prefetched") * 2


def eval_counters() -> dict:
    from models_tpu_torch.ops import embedding_lookup as E
    from models_tpu_torch.ops import topk as T

    return {"bin_max": T.bin_max.launches, "binned_rescore": T.binned_rescore.launches,
            "streaming_topk": T.streaming_topk.launches, "row_gather": E.row_gather.launches}


def zero_eval_counters() -> None:
    from models_tpu_torch.ops import embedding_lookup as E

    zero_topk_counts()
    E.row_gather.launches = 0


@contextlib.contextmanager
def streaming_evaluate():
    """``evaluate`` with its device route refused inside the block: it
    streams (``tests/unit/test_parallel.py::test_fused_evaluate_matches_
    streaming`` refuses it so)."""
    from models_tpu_torch.models.base import BaseModel

    saved = BaseModel._try_device_eval
    BaseModel._try_device_eval = lambda *a, **k: None
    try:
        yield
    finally:
        BaseModel._try_device_eval = saved


def in_line_batches(batches, dev):
    from models_tpu_torch.core.types import to_device_batch, to_device_targets

    for x, y in batches:
        yield to_device_batch(x, dev), to_device_targets(y, dev)


@contextlib.contextmanager
def batches_in_line():
    """The streaming routes with each batch copied in line (pageable,
    synchronous) instead of through ``_device_prefetch`` inside the block."""
    from models_tpu_torch.models import base

    saved = base._device_prefetch
    base._device_prefetch = in_line_batches
    try:
        yield
    finally:
        base._device_prefetch = saved


@contextlib.contextmanager
def counted_fetches(out: list):
    """Each copy of a fit's or an evaluation's logs to the host
    (``models/base.py::_fetch``) appended to ``out`` inside the block."""
    from models_tpu_torch.models import base

    saved = base._fetch
    base._fetch = lambda values: out.append(len(values)) or saved(values)
    try:
        yield
    finally:
        base._fetch = saved


def traced_eval(run, what: str, want: dict, attempts: int = 3) -> dict:
    """A torch.profiler trace of ``run()`` (replayed evaluations; it ends in
    a copy to the host) in a traced_window: the eval route's kernels the
    trace shows by wrapper (``traced``: a replay calls no wrapper), the
    wrappers' own counts over the window (``issued``), and the device's busy
    share of the window's host wall time. The profiler loses an event now
    and then (device_ms), so a trace that lost a marker or shows other
    launches than ``want`` is taken again; the last attempt's fails."""
    from torch.profiler import ProfilerActivity, profile, schedule

    lead_in_graph()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        events = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: events.extend(p.events())) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            with traced_window():
                torch.cuda.synchronize()
                before = eval_counters()
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t) * 1e6
                issued = {n: v - before[n] for n, v in eval_counters().items()}
            torch.cuda.synchronize()
            prof.step()
        traced, busy = dict.fromkeys(EVAL_TRACED, 0), 0.0
        for e in window_events(events) or ():
            busy += e.time_range.elapsed_us()
            m = EVAL_KERNEL_NAME.match(e.name)
            if m is not None and m.group(1) in EVAL_KERNELS:
                traced[EVAL_KERNELS[m.group(1)]] += 1
        if traced == want:
            return {"traced": traced, "issued": issued, "device_busy_share": busy / wall_us}
        print(f"  {what}: trace {attempt + 1} shows launches {traced}, want {want}; taken "
              "again", flush=True)
    raise AssertionError(f"{what}: {attempts} traces in a row show other launches than {want}")


def sync_checked_first_run(model, data, batch: int, dev) -> dict:
    """The device route's first run of ``model`` over ``data`` (its chunks
    eager) under ``torch.cuda.set_sync_debug_mode("error")``: a host sync in
    an evaluation step raises here, where a capture would fail later. The
    eval pack is uploaded before, and the metrics' constants. Returns the
    evaluation's results."""
    from models_tpu_torch.data import Loader
    from models_tpu_torch.models.base import _fetch

    loader = Loader(data, batch)
    loss_fns, task_metrics = model._resolve_task_losses(), model._resolve_task_metrics()
    run = model._try_device_eval(loader, loss_fns, task_metrics, dev)
    require(run is not None, "the eval route refused a dataset of every row")
    # the metrics' constants (the AUC's thresholds) are uploaded once a process
    # and device, when a state is first made, before any chunk: made here
    model._init_metric_states(task_metrics, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, acc = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    results = _fetch(model._eval_values(states, acc, task_metrics))
    return {"loss": results.pop("loss"), **results}


def eval_case(model, data, batch: int, dev, what: str, rows: int, traced: dict) -> dict:
    """One evaluation both ways: streaming (one call to warm, EVAL_TIMED
    timed), then the device route from its first run (the model's eval
    graphs dropped first): eager under the sync check, captured, EVAL_TIMED
    replays timed. Every result equal to the first bit for bit; one replayed
    call traced, its kernels by wrapper as ``traced`` says (the others of
    EVAL_TRACED never) and no wrapper called; at most two graphs for the
    dataset and batch size. Each route's wrapper launches are counted from
    zero around its calls."""
    call = lambda: model.evaluate(data, batch_size=batch, device=dev)  # noqa: E731

    def timed(results):
        times = []
        for _ in range(EVAL_TIMED):
            t = time.perf_counter()
            results.append(call())  # ends in the copy of its results to the host
            times.append(time.perf_counter() - t)
        return float(np.median(times))

    streamed = []
    with streaming_evaluate():
        zero_eval_counters()
        streamed.append(call())
        stream_ln = eval_counters()
        stream_s = timed(streamed)
    model._eval_graphs.clear()
    model._eval_graphs.stats.clear()
    zero_eval_counters()
    device = [sync_checked_first_run(model, data, batch, dev)]
    t = time.perf_counter()
    device.append(call())  # the capture
    capture_call_s = time.perf_counter() - t
    route_ln = eval_counters()
    replay_s = timed(device)
    want = streamed[0]
    for i, res in enumerate(streamed[1:] + device):
        require(list(res) == list(want), f"{what}: keys {list(res)} vs {list(want)}")
        differ = {k: (res[k], want[k]) for k in want if res[k] != want[k]}
        require(not differ, f"{what}: call {i + 2} differs from the first streaming call in "
                f"{differ}")
    trace = traced_eval(call, what, {n: traced.get(n, 0) for n in EVAL_TRACED})
    require(not any(trace["issued"].values()),
            f"{what}: a replayed evaluate called a wrapper: {trace['issued']}")
    graphs = [{"batches": key[0], **v} for key, v in model._eval_graphs.stats.items()]
    require(1 <= len(model._eval_graphs) <= 2, f"{what}: eval graphs {graphs}")
    out = {"rows": rows, "batch": batch, "results": want,
           "streaming_examples_per_sec": rows / stream_s,
           "device_route_examples_per_sec": rows / replay_s,
           "capture_call_s": capture_call_s, "graphs": graphs,
           "launches_streaming": stream_ln, "launches_device_route": route_ln,
           "launches_replay_traced": trace["traced"],
           "replay_device_busy_share": trace["device_busy_share"]}
    print(f"  {what}: {len(streamed)} streaming calls and {len(device)} on the device route "
          f"(eager under the sync check, captured, {EVAL_TIMED} replays) bit-equal; "
          f"examples/s streaming {out['streaming_examples_per_sec']:.0f}, device route "
          f"{out['device_route_examples_per_sec']:.0f}; graphs {graphs}; launches streaming "
          f"{stream_ln}, device route (eager + capture) {route_ln}, traced in one replayed "
          f"call {trace['traced']}, busy {trace['device_busy_share']:.3f}", flush=True)
    return out


def validated_fit(dev, catalog, train, val, fused: bool) -> tuple:
    """The bench's two-tower compiled with k = 8 steps a chunk (the training
    pack's route) and the default metrics, fit VAL_EPOCHS epochs with
    ``validation_data``, deterministic algorithms on: with no callback the
    validation rides the epoch's device work (``fused``), with a no-op
    callback it is a separate ``evaluate`` an epoch. Then one more epoch,
    timed (every graph captured). Returns (history, the timed epoch's
    seconds, its copies to the host, the model)."""

    class Noop:
        pass

    model = evaluate_model(dev, catalog)
    model.compile(optimizer="adagrad", learning_rate=0.05, steps_per_execution=8)
    callbacks = None if fused else [Noop()]
    kw = dict(batch_size=TRAIN_BATCH, shuffle=False, validation_data=val, device=dev,
              callbacks=callbacks, verbose=0)
    with deterministic(True):
        hist = model.fit(train, epochs=VAL_EPOCHS, **kw).history
        fetches = []
        with counted_fetches(fetches):
            t = time.perf_counter()
            model.fit(train, epochs=1, **kw)
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t
    return hist, epoch_s, len(fetches), model


def prefetch_fit(dev, catalog, data, timed_data, in_line: bool):
    """A fresh seeded two-tower at the bench's width (no metrics) fit one
    epoch of ``data`` one step at a time with deterministic algorithms on,
    each batch through ``_device_prefetch`` or, with ``in_line``, copied in
    line. Returns (the model, the fit's losses, a function that runs
    PREFETCH_FITS more fits of one epoch of ``timed_data``, deterministic
    algorithms off, and returns their median ms a step, host clock)."""
    model = evaluate_model(dev, catalog)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    steps = timed_data.num_rows // TRAIN_BATCH

    def copies():
        return batches_in_line() if in_line else contextlib.nullcontext()

    def fit(ds):
        return model.fit(ds, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, verbose=0,
                         device=dev).history["loss"]

    with copies(), deterministic(True):
        losses = fit(data)

    def timed():
        ms = []
        with copies():
            for _ in range(PREFETCH_FITS):
                t = time.perf_counter()
                fit(timed_data)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) / steps * 1e3)
        return float(np.median(ms))

    return model, losses, timed


def copy_ms(dev, data, in_line: bool) -> float:
    """Host ms a batch of copying ``data``'s batches of 8192 (assembled
    beforehand) to the card and waiting for them, through
    ``_device_prefetch`` or in line: the copy's own cost, without a step to
    overlap."""
    from models_tpu_torch.data import Loader
    from models_tpu_torch.models import base

    host = list(Loader(data, TRAIN_BATCH))
    send = in_line_batches if in_line else base._device_prefetch
    ms = []
    for _ in range(PREFETCH_FITS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in send(host, dev):
            pass
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) / len(host) * 1e3)
    return float(np.median(ms[1:]))


def tiled(data, rows: int):
    """``data``'s rows repeated to ``rows`` rows (made in a blink, where
    synthesising them takes seconds)."""
    from models_tpu_torch.data.dataset import take_rows

    idx = np.resize(np.arange(data.num_rows), rows)
    return data._from_cols(take_rows(data.to_numpy_dict(), idx))


def eval_full_chunk(dev, model, data, graphs_8: list) -> dict:
    """The in-batch evaluate over EVAL_CHUNK_BATCHES batches of 8192 (one
    whole chunk: ``data``'s rows repeated) with phase 11's model, three
    calls (eager, captured, replayed; each bit-equal to the first): its
    graph's capture seconds and pool bytes beside the 8-batch chunk's
    (``graphs_8``, eval_case's), so that the pool's growth with the chunk's
    length is measured."""
    from models_tpu_torch.models.base import EVAL_CHUNK_BATCHES

    rows = EVAL_CHUNK_BATCHES * TRAIN_BATCH
    big = tiled(data, rows)
    model._eval_graphs.clear()
    model._eval_graphs.stats.clear()
    res = []
    for _ in range(3):
        t = time.perf_counter()
        res.append(model.evaluate(big, batch_size=TRAIN_BATCH, device=dev))
        res[-1]["_s"] = time.perf_counter() - t
    for i, r in enumerate(res[1:]):
        differ = {k: (r[k], res[0][k]) for k in res[0] if k != "_s" and r[k] != res[0][k]}
        require(not differ, f"in-batch, one {EVAL_CHUNK_BATCHES}-batch chunk: call {i + 2} "
                f"differs from the eager call in {differ}")
    graphs = [{"batches": key[0], **v} for key, v in model._eval_graphs.stats.items()]
    require(len(graphs) == 1 and graphs[0]["batches"] == EVAL_CHUNK_BATCHES,
            f"in-batch, one {EVAL_CHUNK_BATCHES}-batch chunk: graphs {graphs}")
    pool_8 = max(g["pool_bytes"] for g in graphs_8)
    out = {"rows": rows, "batch": TRAIN_BATCH, "graphs": graphs, "pool_bytes_8": pool_8,
           "pool_ratio_to_8": graphs[0]["pool_bytes"] / max(pool_8, 1),
           "call_s": [r.pop("_s") for r in res]}
    out["replay_examples_per_sec"] = rows / out["call_s"][2]
    print(f"  in-batch, {rows} rows at {TRAIN_BATCH} (one {EVAL_CHUNK_BATCHES}-batch chunk): "
          f"eager, captured and replayed calls bit-equal; the graph {graphs[0]}, pool "
          f"{out['pool_ratio_to_8']:.3f} x the 8-batch chunk's {pool_8} bytes; calls "
          f"{out['call_s']} s", flush=True)
    big._device_eval_pack = None
    model._eval_graphs.clear()
    torch.cuda.empty_cache()
    return out


def eval_route_cases(dev, catalog, model, data) -> dict:
    """Phase 11b's evaluations (eval_case): in-batch over ``data`` (65,536
    rows) at 8192 with phase 11's model; the corpus over the 56,680-item
    catalog, EVAL_QUERIES queries at 4096 (K6) and at 256 (K4, K5), fp32,
    bf16 and int8 indexes (a top-k encoder held across calls), each replay
    traced with the route's kernels as many times as it has batches;
    the DLRM's binary head with AUC (criteo-small, 65,536 rows at 8192)."""
    import models_tpu_torch as mt

    gather = {"row_gather": 1}  # one chunk: K9 gathers its rows once
    out = {"in_batch": eval_case(model, data, TRAIN_BATCH, dev,
                                 "in-batch, 65,536 rows at 8192", data.num_rows, gather)}
    encoders = {tag: model.to_top_k_encoder(catalog, k=K, candidate_dtype=dtype, device=dev)
                for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16),
                                   ("int8", torch.int8))}
    # each query labelled with an item the fp32 index ranks in its top 10,
    # at rank r % 10 (as phase 11's): the metrics move with every rank
    q_rows = data.take(EVAL_QUERIES)
    top = encoders["fp32"].predict(q_rows, batch_size=4096, device=dev)
    cols = q_rows.to_numpy_dict()
    rows = np.arange(EVAL_QUERIES)
    cols["movieId"] = top["ids"][rows, rows % K].astype(np.int32)
    q_rows = mt.Dataset(cols, schema=q_rows.schema)
    for batch, kernels in ((4096, ("streaming_topk",)), (256, ("bin_max", "binned_rescore"))):
        # a call of B queries a batch: each batch's top-k on the route B takes
        want = {**gather, **dict.fromkeys(kernels, EVAL_QUERIES // batch)}
        for tag, enc in encoders.items():
            case = f"corpus_{tag}_B{batch}"
            res = eval_case(enc, q_rows, batch, dev, f"corpus, {tag} index, {EVAL_QUERIES} "
                            f"queries at {batch}", EVAL_QUERIES, want)
            require(0.0 < res["results"]["recall_at_10"],
                    f"{case}: recall {res['results']['recall_at_10']} on labelled queries")
            out[case] = res
    del encoders
    torch.cuda.empty_cache()

    criteo = mt.generate_data("criteo-small", num_rows=8 * TRAIN_BATCH, seed=SEED + 11)
    dlrm = dlrm_model(dev, criteo.schema)
    dlrm.compile(optimizer="adagrad", learning_rate=0.05)
    out["dlrm_auc"] = eval_case(dlrm, criteo, TRAIN_BATCH, dev,
                                "DLRM, binary head with AUC, 65,536 rows at 8192",
                                criteo.num_rows, gather)
    require("label/auc" in out["dlrm_auc"]["results"], "the DLRM's evaluation has no AUC")
    del dlrm, criteo
    torch.cuda.empty_cache()
    return out


def eval_route_fits(dev, catalog, data, card) -> dict:
    """Phase 11b's fits: ``fit(validation_data=)`` with the validation
    inside the epoch's device work against a separate evaluate an epoch
    (validated_fit: histories bit-equal, one copy to the host an epoch
    against two, a timed epoch each), and the streaming fit one step at a
    time with each batch prefetched against copied in line (prefetch_fit:
    bit for bit, host ms a step in turns)."""
    out = {}
    val = data.take(EVAL_QUERIES)
    fused_h, fused_s, fused_n, m1 = validated_fit(dev, catalog, data, val, fused=True)
    separate_h, separate_s, separate_n, m2 = validated_fit(dev, catalog, data, val, fused=False)
    require(list(fused_h) == list(separate_h), f"validated fit: keys {list(fused_h)} vs "
            f"{list(separate_h)}")
    differ = [k for k in fused_h if k != "examples_per_sec" and fused_h[k] != separate_h[k]]
    require(not differ, f"validated fit: histories differ in {differ}")
    require(fused_n == 1 and separate_n == 2,
            f"validated fit: {fused_n} / {separate_n} copies to the host an epoch, want 1 / 2")
    out["validated_fit"] = {
        "epochs": VAL_EPOCHS, "train_rows": data.num_rows, "val_rows": val.num_rows,
        "steps_per_execution": 8, "epoch_s": {"validation_inside": fused_s,
                                              "separate_evaluate": separate_s},
        "copies_an_epoch": {"validation_inside": fused_n, "separate_evaluate": separate_n},
        "val_recall_at_10": fused_h["val_recall_at_10"],
        "eval_graphs": list(m1._eval_graphs.stats.values())}
    print(f"  validated fit: histories bit-equal over {VAL_EPOCHS} epochs; a timed epoch "
          f"(8 steps a graph replay, {val.num_rows} rows validated) {fused_s:.4f} s with "
          f"{fused_n} copy to the host, {separate_s:.4f} s with {separate_n}; {card}",
          flush=True)
    del m1, m2
    torch.cuda.empty_cache()
    stamp("the streaming step: each batch prefetched against copied in line")

    timed_data = tiled(data, PREFETCH_TIMED_ROWS)
    pm, p_losses, p_timed = prefetch_fit(dev, catalog, data, timed_data, in_line=False)
    im, i_losses, i_timed = prefetch_fit(dev, catalog, data, timed_data, in_line=True)
    require(p_losses == i_losses, f"prefetched fit: losses {p_losses} vs in line {i_losses}")
    require(same_params(pm, im), f"prefetched fit: parameters differ from the in-line fit: "
            f"{param_spread(pm, im)}")
    ms = {"prefetched": [], "in_line": []}
    for turn in PREFETCH_TURNS:
        ms[turn].append(p_timed() if turn == "prefetched" else i_timed())
    copies = {"prefetched": copy_ms(dev, data, False), "in_line": copy_ms(dev, data, True)}
    out["prefetch_ms_per_step"] = ms
    out["prefetch_timed_steps"] = PREFETCH_TIMED_ROWS // TRAIN_BATCH
    out["copy_ms_per_batch"] = copies
    steps, timed_steps = data.num_rows // TRAIN_BATCH, PREFETCH_TIMED_ROWS // TRAIN_BATCH
    print(f"  streaming fit one step at a time: prefetched bit-equal to in line over {steps} "
          f"steps (deterministic algorithms); ms a step (host clock, median of "
          f"{PREFETCH_FITS} fits of {timed_steps} steps a turn), turns PIIPPIIP: "
          f"{json.dumps(ms)}; "
          f"the copies alone, ms a batch: {json.dumps(copies)}; {card}", flush=True)
    del pm, im
    torch.cuda.empty_cache()
    return out


def phase_eval_route(dev, catalog, model, data, card):
    """The device-resident ``evaluate`` (the eval pack, chunks of batches,
    each chunk one CUDA graph replay from the third call on) against the
    streaming route, bit for bit, at the bench's width (eval_route_cases),
    each case's first device-route run under the sync check and K4, K5, K6
    and K9 counted in a traced replay; one whole in-batch chunk's pool
    (eval_full_chunk); then validation inside ``fit`` and the streaming
    step's device prefetch (eval_route_fits). Returns (the
    numbers, the evaluations' numbers by case)."""
    t_phase = time.perf_counter()
    cases = eval_route_cases(dev, catalog, model, data)
    full = eval_full_chunk(dev, model, data, cases["in_batch"]["graphs"])
    stamp("fit(validation_data=): validation inside the epoch against a separate evaluate")
    out = {"card": card, **cases, "in_batch_full_chunk": full,
           **eval_route_fits(dev, catalog, data, card)}
    out["phase_s"] = time.perf_counter() - t_phase
    return out, cases


def topk_1m_times(dev, gen, errs):
    """The top-k layer on the bench's 1M x 128 catalog (``bench.py:730-815``),
    B = 256, k = 10, fp32, bf16 and int8 indexes: CUDA events, back to back,
    K4 and K5 counted there (once each a call); phase A's split
    (``phase_a_split``), its peak memory above the index under
    PHASE_A_PEAK_MAX; and K5 at the bins the layer's phase A selects (kb = 12 of 15,625 bins:
    most distinct, some 100 MB of fp32 rows, past the 50 MB L2), with the L2
    flushed before each call (profiler device time), against its plain
    version, with its bound (the distinct bins once)."""
    from models_tpu_torch.ops import topk as T
    from models_tpu_torch.outputs.topk import BruteForce

    cand = torch.randn(1_000_000, 128, device=dev, generator=gen)
    q = torch.randn(256, 128, device=dev, generator=gen)
    out = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        bf = BruteForce(K).index(cand, dtype=dtype, device=dev)
        zero_topk_counts()
        out[f"topk_1M_{tag}_B256_ms"] = cuda_ms(lambda: bf(q))
        torch.cuda.synchronize()
        out[f"launches_1M_{tag}"] = topk_counts(f"top-k on 1M x 128 {tag}")
        require(out[f"launches_1M_{tag}"]["bin_max"] == 12,
                f"1M x 128 {tag}: {out[f'launches_1M_{tag}']} in 12 calls")
        split = out[f"phase_a_1M_{tag}"] = phase_a_split(q, bf)
        require(split["layer_peak_bytes"] < PHASE_A_PEAK_MAX,
                f"1M x 128 {tag}: the layer's peak above the index "
                f"{split['layer_peak_bytes']} bytes")
        full, n = bf.candidates, bf.n_valid
        if dtype == torch.int8:
            qk, _ = T.quantize_queries(q)
            idx = T.select_bins(qk, full, K, n_valid=n, col_scale=bf.scales,
                                col_scale_per_bin=bf.scales_per_bin)
        else:
            qk = q
            idx = T.select_bins(q, full, K, n_valid=n)
        rescore_case(dev, qk, full, idx, f"1M catalog {tag}", errs)
        distinct = int(torch.unique(idx).numel())
        B, kb = idx.shape
        qbytes = 1 if dtype == torch.int8 else 4
        nbytes = (distinct * 64 * 128 * full.element_size() + B * 128 * qbytes + B * kb * 4
                  + B * kb * 64 * 4)
        out[f"binned_rescore_1M_{tag}"] = {
            "kb": kb, "distinct_bins": distinct,
            "ms_cold": device_ms(lambda: T.binned_rescore(qk, full, idx, 64), cold=True),
            "ms_read_flush": device_ms(lambda: T.binned_rescore(qk, full, idx, 64),
                                       cold="read"),
            "plain_ms_cold": device_ms(lambda: T.binned_rescore_plain(qk, full, idx, 64),
                                       reps=10, cold=True),
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, **rescore_design(qk, full, idx, 64)}
        del bf
    del cand
    torch.cuda.empty_cache()
    return out


def topk_16m_memory(dev, gen) -> dict:
    """``topk_scores`` over 2**24 x 128 bf16 rows (a 4.3 GB index) at B =
    1024, k = 10: the route is binned, and phase A writes only the (B, L)
    maxima (1.07 GB) where the (B, C) fp32 scores would take 68.7 GB. Its
    peak memory above the index (under TOPK_16M_PEAK_MAX), K4 and K5 once
    each, the result against K6 (``streaming_topk``) on the same inputs
    under ``ids_agree``; K4 alone and the call timed (CUDA events)."""
    from models_tpu_torch.ops import topk as T

    C, D, B = 2**24, 128, 1024
    cand = torch.empty(C, D, device=dev, dtype=torch.bfloat16).normal_(generator=gen)
    q = torch.randn(B, D, device=dev, generator=gen)
    require(T.topk_route(B, C, D, K, on_cuda=True) == "binned", "2**24 x 128: not binned")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_topk_counts()
    s, i = T.topk_scores(q, cand, K, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = topk_counts("top-k over 2**24 x 128 bf16")
    require(launches["bin_max"] == 1 and launches["streaming_topk"] == 0,
            f"2**24 x 128 bf16: launches {launches}")
    require(peak < TOPK_16M_PEAK_MAX, f"2**24 x 128 bf16 at B={B}: peak {peak} bytes "
            "above the index")
    s6, i6 = T.streaming_topk(q, cand, K)
    torch.cuda.synchronize()
    check_topk(f"topk_scores over 2**24 x 128 bf16 B={B}, binned (K4, K5) vs K6", (s, i),
               (s6, i6))
    out = {"peak_bytes_above_index": peak, "index_bytes": C * D * 2,
           "bin_max_ms": cuda_ms(lambda: T.bin_max(q, cand), reps=3, warmup=1),
           "topk_scores_ms": cuda_ms(lambda: T.topk_scores(q, cand, K, device=dev), reps=3,
                                     warmup=1),
           "streaming_topk_ms": cuda_ms(lambda: T.streaming_topk(q, cand, K), reps=3,
                                        warmup=1),
           "bin_max_plan": T.bin_max_plan(torch.bfloat16, B, D, C // 64),
           "bin_max_bound_ms": bin_max_bound_ms(B, D, C // 64, 64, torch.bfloat16, False)}
    print("  top-k over 2**24 x 128 bf16 at B=1024: " + json.dumps(out), flush=True)
    del cand
    torch.cuda.empty_cache()
    return out


def phase_a_split(q, bf) -> dict:
    """Phase A of the binned top-k over one index of the 1M x 128 catalog at
    B = q.shape[0], k = K, split into its parts as the plain route runs them
    (CUDA events, back to back): the bf16 rows widened to fp32
    (``widen_ms``), the (B, C) product (``product_ms``: cuBLAS fp32, or the
    cuBLASLt int8 product), each 64-row bin's max with the int8 index's
    per-bin scale (``amax_ms``) and the stable sort of the (B, L) maxima
    that picks the kb bins (``sort_ms``, with its peak memory and its share
    of ``select_bins``' time and memory, ``sort_share``); K4 in their place
    (``bin_max_ms``, and its plain version, ``bin_max_plain_ms``: the parts
    before the sort); then ``select_bins`` as the port takes it (K4 and the
    sort, ``select_bins_ms``) and the layer's call (``layer_ms``), each
    with its peak memory above what was allocated before it (the index and
    the queries): ``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``."""
    from models_tpu_torch.ops import topk as T

    full, n = bf.candidates, bf.n_valid
    B, bs = q.shape[0], 64
    L = full.shape[0] // bs
    is_int = full.dtype == torch.int8
    qk = T.quantize_queries(q)[0] if is_int else q
    args = dict(n_valid=n, col_scale=bf.scales, col_scale_per_bin=bf.scales_per_bin)
    out = {"B": B, "L": L}
    wide = full
    if full.dtype == torch.bfloat16:
        out["widen_ms"] = cuda_ms(lambda: full.to(torch.float32))
        wide = full.to(torch.float32)
    product = (lambda: T._int_scores(qk, full)) if is_int else (lambda: qk @ wide.T)
    out["product_ms"] = cuda_ms(product)
    raw = product().view(B, L, bs)

    def amax():
        if is_int:
            return raw.amax(dim=2).to(torch.float32) * T._bin_scales(bf.scales, L, bs)[None]
        return raw.amax(dim=2)

    out["amax_ms"] = cuda_ms(amax)
    bin_max = amax()
    kb = min(K + 2 + (1 if n < L * bs else 0), L)
    del wide, raw
    k4 = lambda: T.bin_max(qk, full, bs, bf.scales, bf.scales_per_bin)  # noqa: E731
    out["bin_max_ms"] = cuda_ms(k4)
    out["bin_max_ms_warm"] = device_ms(k4)
    out["bin_max_ms_cold"] = device_ms(k4, cold=True)
    out["bin_max_bound_ms"] = bin_max_bound_ms(B, full.shape[1], L, bs, full.dtype,
                                               bf.scales_per_bin and bf.scales is not None)
    out["bin_max_plan"] = T.bin_max_plan(full.dtype, B, full.shape[1], L, bs)
    out["bin_max_plain_ms"] = cuda_ms(
        lambda: T.bin_max_plain(qk, full, bs, bf.scales, bf.scales_per_bin))
    for name, fn in (("sort", lambda: T.stable_topk(bin_max, kb)),
                     ("select_bins", lambda: T.select_bins(qk, full, K, **args)),
                     ("layer", lambda: bf(q))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        out[f"{name}_ms"] = cuda_ms(fn)
    # the (B, L) selection, outside any kernel, in select_bins
    out["sort_share"] = {"time": out["sort_ms"] / out["select_bins_ms"],
                         "memory": out["sort_peak_bytes"] / out["select_bins_peak_bytes"]}
    print(f"  phase A {full.dtype} B={B}: K4 ({out['bin_max_plan']['design']}) "
          f"{out['bin_max_ms']:.4f} ms, warm {out['bin_max_ms_warm']:.4f}, cold "
          f"{out['bin_max_ms_cold']:.4f}, bound {out['bin_max_bound_ms']:.4f}; the sort "
          f"{out['sort_ms']:.4f}; select_bins {out['select_bins_ms']:.4f}; the layer "
          f"{out['layer_ms']:.4f}; the sort of (B, L) takes {out['sort_share']} of "
          "select_bins' time and peak memory", flush=True)
    return out


def measure_gather(dev, gen, launches, errs):
    """K9 on the bench's op-level tables (8192 uniform ids into 4M x 128 fp32
    and 16M x 128 bf16) and on the training route's pack (one chunk of
    131,072 ids into 2**20 rows of 26 int32): profiler device time per call
    with the L2 warm (``ms``) and flushed dirty (``ms_cold``, as the bound
    assumes), the plain version and ``index_select`` flushed (and the latter
    warm). Bound: 2*n*row_bytes + 4*n bytes. Returns the K9 row: the 4M fp32
    table's numbers, the pack's under ``pack``; ``launches``: the training
    route's."""
    from models_tpu_torch.ops import embedding_lookup as E

    row, extra = None, {}
    for tag, R, D, dtype, B in (("R4000000_fp32", OP_ROWS_FP32, 128, torch.float32, 8192),
                                ("R16000000_bf16", OP_ROWS_BF16, 128, torch.bfloat16, 8192),
                                ("pack", PACK_ROWS, PACK_COLS, torch.int32, PACK_IDS)):
        if dtype == torch.int32:
            table = torch.randint(-2**31, 2**31 - 1, (R, D), device=dev, generator=gen,
                                  dtype=dtype)
        else:
            table = torch.empty(R, D, device=dev, dtype=dtype).normal_(generator=gen)
        ids = torch.randint(0, R, (B,), device=dev, generator=gen, dtype=torch.int32)
        ids_l = ids.long()
        nbytes = 2 * B * D * table.element_size() + 4 * B
        times = {"ms": device_ms(lambda: E.row_gather(table, ids)),
                 "ms_cold": device_ms(lambda: E.row_gather(table, ids), cold=True),
                 "plain_ms": device_ms(lambda: E.row_gather_plain(table, ids), cold=True),
                 "library_ms": device_ms(lambda: torch.index_select(table, 0, ids_l), cold=True),
                 "library_ms_warm": device_ms(lambda: torch.index_select(table, 0, ids_l)),
                 "back_to_back_ms": cuda_ms(lambda: E.row_gather(table, ids), reps=50),
                 "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
        times["share_of_bound_cold"] = times["bound_ms"] / times["ms_cold"]
        extra[f"row_gather_{tag}"] = times
        if tag == "R4000000_fp32":
            row = _row("row_gather", "models_tpu_torch/csrc/row_gather.cu",
                       "models_tpu/ops/embedding_lookup.py:38", launches, errs["row_gather"],
                       times["ms"], times["plain_ms"], times["library_ms"], 0, nbytes,
                       ms_cold=times["ms_cold"])
            row["library_ms_warm"] = times["library_ms_warm"]
        elif tag == "pack":
            row["pack"] = {k: times[k] for k in ("ms", "ms_cold", "plain_ms", "library_ms",
                                                 "library_ms_warm", "bound_ms")}
        del table
    torch.cuda.empty_cache()
    print("row gather " + json.dumps(extra), flush=True)
    return row


def measure_scatter_write_fp32(dev, gen, errs, launches):
    """K8a, the fp32 instance of the row scatter-write, timed as K8b is: a
    deduplicated batch of 8192 ids into a 4M x 128 fp32 table, L2 flushed,
    beside the plain version and ``index_copy_``. Bound: 2*n_valid*D*4 + 5*N
    bytes. ``launches``: the row-sparse run with fp32 tables counted them,
    and must have counted none (only bf16 tables are written whole rows)."""
    from models_tpu_torch.ops import scatter as S

    require(launches == 0, f"the fp32-table run launched row_scatter_write {launches} times")
    B, D, R = 8192, 128, OP_ROWS_FP32
    raw = torch.randint(0, R, (B,), device=dev, generator=gen, dtype=torch.int32)
    ids, _, valid = S.dedup_rows(raw, torch.zeros(B, 1, device=dev))
    ids_v = ids[valid].long()
    n = int(valid.sum())
    table = torch.randn(R, D, device=dev, generator=gen)
    rows = torch.randn(B, D, device=dev, generator=gen)
    got = S.row_scatter_write(table.clone(), ids, rows, valid)
    want = S.row_scatter_write_plain(table.clone(), ids, rows, valid)
    require(torch.equal(raw_bits(got), raw_bits(want)), "row_scatter_write fp32 4M: differs")
    err = max(errs["row_scatter_write"], max_err(got, want))
    del got, want
    rows_v = rows[valid]
    ms = device_ms(lambda: S.row_scatter_write(table, ids, rows, valid), cold=True)
    plain = device_ms(lambda: S.row_scatter_write_plain(table, ids, rows, valid), reps=10,
                      cold=True)
    lib = device_ms(lambda: table.index_copy_(0, ids_v, rows_v), cold=True)
    row = _row("row_scatter_write_fp32", "models_tpu_torch/csrc/row_scatter.cu",
               "models_tpu/ops/scatter.py:243", launches, err, ms, plain, lib, 0,
               2 * n * D * 4 + B * 5)
    row["design"] = scatter_design("row_scatter_write")
    row["order"] = S.write_order(B, R)
    kernel = lambda: S.row_scatter_write(table, ids, rows, valid)  # noqa: E731
    print("row scatter write fp32 " + json.dumps({
        "ms": ms, "read_flush_ms": device_ms(kernel, cold="read"),
        "l2_warm_ms": device_ms(kernel), "back_to_back_ms": cuda_ms(kernel, reps=50)}),
        flush=True)
    del table
    torch.cuda.empty_cache()
    return row


# the row route's kernel cases: (column, rows, width) of the bench's routed
# tables (dlrm_train's largest and smallest, tt_train's two), 8192 ids a step
ROUTE_CASES = (("C1", 10_000_000, 64), ("C3", 17_289, 64), ("userId", 162_542, 128),
               ("movieId", 56_681, 128))
ROUTE_IDS = 8192
# the timed steps: (what, [(rows R, width D, ids N a step) of each table]); a
# sweep of R at N = 8192 (2048 at D = 32) at three widths, and the bench's
# tables: those the route leaves dense (dlrm_train's three fused groups, C15
# and C24; tt_train's genres), those it routes, and dlrm_train's three
# smallest of N <= R / 2 together
ROUTE_TIMED = tuple(
    (f"d{D}_r{R}", [(R, D, N)])
    for D, N, rows in ((64, 8192, (8192, 16_384, 24_576, 32_768, 49_152, 65_536, 98_304,
                                   163_840)),
                       (128, 8192, (8192, 16_384, 24_576, 32_768, 49_152, 65_536, 98_304)),
                       (32, 2048, (4096, 16_384, 65_536, 131_072)))
    for R in rows) + (
    ("fused_8_cols", [(2048, 64, 8 * 8192)]), ("fused_3_cols", [(12_288, 64, 3 * 8192)]),
    ("fused_2_cols", [(16_384, 64, 2 * 8192)]), ("C15", [(11_938, 64, 8192)]),
    ("C24", [(12_972, 64, 8192)]), ("genres", [(24, 128, 10 * 8192)]),
    ("C2", [(39_043, 64, 8192)]), ("C3", [(17_289, 64, 8192)]), ("C5", [(20_263, 64, 8192)]),
    ("C2_C3_C5", [(39_043, 64, 8192), (17_289, 64, 8192), (20_263, 64, 8192)]),
    ("C1", [(10_000_000, 64, 8192)]), ("userId", [(162_542, 128, 8192)]),
    ("movieId", [(56_681, 128, 8192)]))


def route_case(dev, gen, name, R, D, errs) -> dict:
    """The row route at one table's shape: ROUTE_IDS skewed ids (repeats)
    into an R x D fp32 table, sorted int32 with the first of each run marked
    (``looked_up_rows``); K9 on those ids and K8a at the marked positions
    against their plain versions, and two Adagrad steps of the route against
    two dense steps from the same state and gradients, bit for bit."""
    from models_tpu_torch.blocks import optimizer as O
    from models_tpu_torch.ops import embedding_lookup as E
    from models_tpu_torch.ops import scatter as S

    ids = torch.as_tensor(skewed_ids(ROUTE_IDS, R, SEED + R), device=dev)
    sids, first = O.looked_up_rows([ids])
    table = torch.empty(R, D, device=dev).uniform_(-0.05, 0.05, generator=gen)
    got = E.row_gather(table, sids)
    require(torch.equal(raw_bits(got), raw_bits(E.row_gather_plain(table, sids))),
            f"row route {name}: K9 differs from its plain version")
    rows = torch.randn(ROUTE_IDS, D, device=dev, generator=gen)
    got = S.row_scatter_write(table.clone(), sids, rows, first)
    want = S.row_scatter_write_plain(table.clone(), sids, rows, first)
    require(torch.equal(raw_bits(got), raw_bits(want)),
            f"row route {name}: K8a differs from its plain version")
    errs["row_scatter_write"] = max(errs["row_scatter_write"], max_err(got, want))
    del got, want, rows
    params = [torch.nn.Parameter(table.clone()) for _ in range(2)]
    del table
    opts = [O.Adagrad([p], 0.05) for p in params]
    for _ in range(2):
        # one gradient for both, as F.embedding's backward leaves it: +0 at
        # every row no id took
        grad = torch.zeros_like(params[0]).index_add_(
            0, ids.long(), torch.randn(ROUTE_IDS, D, device=dev, generator=gen))
        for i, (p, o) in enumerate(zip(params, opts)):
            p.grad = grad.clone()
            o.step(lookups={p: [ids]} if i == 0 else None)
        del grad
    (a, b), (sa, sb) = params, (o.state[p]["sum"] for o, p in zip(opts, params))
    require(torch.equal(raw_bits(a.detach()), raw_bits(b.detach()))
            and torch.equal(raw_bits(sa), raw_bits(sb)),
            f"row route {name}: the routed Adagrad step differs from the dense step")
    return {"rows": R, "dim": D, "ids": ROUTE_IDS, "distinct": int(first.sum())}


def captured(fn):
    """``fn`` captured as a CUDA graph, after two warm-up calls on a side
    stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def route_step_us(dev, gen, shapes) -> dict:
    """One Adagrad step of tables of ``shapes`` ((R, D, N): an R x D table
    looked up at N skewed ids), beside a 512 x 512 parameter that shares
    their ``_foreach`` launches, densely and on the row route: each captured
    as a CUDA graph, device microseconds a replay (back-to-back replays,
    CUDA events)."""
    from models_tpu_torch.blocks import optimizer as O

    mlp = torch.nn.Parameter(torch.randn(512, 512, device=dev, generator=gen))
    mlp.grad = torch.randn_like(mlp)
    lookups = {}
    for R, D, N in shapes:
        table = torch.nn.Parameter(torch.empty(R, D, device=dev).uniform_(-0.05, 0.05,
                                                                          generator=gen))
        ids = torch.as_tensor(skewed_ids(N, R, SEED + N + R), device=dev)
        torch.nn.functional.embedding(ids.long(), table).backward(
            torch.randn(N, D, device=dev, generator=gen))
        lookups[table] = [ids]
    out = {}
    for tag, routed in (("dense", None), ("route", lookups)):
        opt = O.Adagrad([mlp, *lookups], 0.05)
        graph = captured(lambda: opt.step(lookups=routed))
        out[f"{tag}_us"] = cuda_ms(graph.replay, reps=200, warmup=10) * 1e3
        del graph, opt
    return out


def phase_row_route(dev, gen, errs) -> dict:
    """The row route (the dense Adagrad or SGD at a lookup-only table's
    looked-up rows): its kernels and its step at the bench's tables
    (route_case), then the step's device time on the route and densely at
    each of ROUTE_TIMED's shapes (route_step_us), the measurement the
    route's cutoff (``models/base.py``) rests on."""
    out = {"cases": {name: route_case(dev, gen, name, R, D, errs)
                     for name, R, D in ROUTE_CASES}}
    torch.cuda.empty_cache()
    print(f"  K9, K8a and the routed Adagrad step bit-equal to their plain versions and the "
          f"dense step: {json.dumps(out['cases'])}", flush=True)
    timed = {}
    for what, shapes in ROUTE_TIMED:
        timed[what] = {"tables": shapes, **route_step_us(dev, gen, shapes)}
        torch.cuda.empty_cache()
    out["timed"] = timed
    print("  the step's device time, dense / row route (us): " + "; ".join(
        f"{w} {v['dense_us']:.2f} / {v['route_us']:.2f}" for w, v in timed.items()), flush=True)
    return out


def measure_int8(dev, enc, q4096, launches, errs):
    """K5 and K6 int8 timed on the inputs the int8 serving path gives them:
    the int8 index of the catalog, the 256-row request's quantized queries and
    the bins phase A selects (K5), the 4096-row request's fp32 queries with
    the per-row scales (K6). Back-to-back CUDA events, as K5 and K6 are timed
    above; yardsticks: the gather and an fp32 einsum of the widened int8
    values (exact), and ``torch.topk`` of the scaled product."""
    from models_tpu_torch.ops import topk as T

    bf = enc.blocks[-1].topk_layer
    n, D = bf.n_valid, bf.candidates.shape[1]
    cand, ids, scale = bf.candidates[:n], bf.ids[:n], bf.scales[:n].contiguous()
    B = q4096.shape[0]
    ms = cuda_ms(lambda: T.streaming_topk(q4096, cand, K, ids=ids, scale=scale))
    cold = device_ms(lambda: T.streaming_topk(q4096, cand, K, ids=ids, scale=scale), cold=True)
    plain = cuda_ms(lambda: T.streaming_topk_plain(q4096, cand, K, ids=ids, scale=scale),
                    reps=3)
    lib = cuda_ms(lambda: torch.topk((q4096 @ cand.float().T) * scale[None, :], K))
    k6 = _row("streaming_topk_int8", "models_tpu_torch/csrc/streaming_topk.cu",
              "models_tpu/ops/topk.py:102", launches["streaming_topk_int8"],
              errs["streaming_topk_int8"], ms, plain, lib, 2 * B * n * D,
              B * D * 4 + n * D + n * 8 + B * K * 8, PEAK_3XBF16, ms_cold=cold)
    q8, _ = T.quantize_queries(q4096[:256].contiguous())
    full, bs = bf.candidates, 64
    k4 = measure_bin_max(q8, full, n, launches["bin_max_int8"], errs, "int8", scale=bf.scales)
    idx = T.select_bins(q8, full, K, n_valid=n, col_scale=bf.scales, col_scale_per_bin=True)
    B, kb = idx.shape
    c3 = full.view(-1, bs, D)
    got, want = T.binned_rescore(q8, full, idx, bs), T.binned_rescore_plain(q8, full, idx, bs)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "binned_rescore int8 at the serving bins: differs")
    ms = cuda_ms(lambda: T.binned_rescore(q8, full, idx, bs))
    cold = device_ms(lambda: T.binned_rescore(q8, full, idx, bs), cold=True)
    plain = cuda_ms(lambda: T.binned_rescore_plain(q8, full, idx, bs))
    lib = cuda_ms(lambda: torch.einsum("bd,bksd->bks", q8.float(), c3[idx.long()].float()))
    n_bins = int(torch.unique(idx).numel())
    k5 = _row("binned_rescore_int8", "models_tpu_torch/csrc/binned_rescore.cu",
              "models_tpu/ops/topk.py:208", launches["binned_rescore_int8"],
              errs["binned_rescore_int8"], ms, plain, lib, 2 * B * kb * bs * D,
              n_bins * bs * D + B * D + B * kb * 4 + B * kb * bs * 4, ms_cold=cold)
    k5["ms_warm"] = device_ms(lambda: T.binned_rescore(q8, full, idx, bs))
    k5.update(rescore_design(q8, full, idx, bs))
    print(f"  int8: phase A selects kb={kb} bins per row, {n_bins} distinct", flush=True)
    return [k6, k5, k4]


# ---------------------------------------------------------------------------
# mixed precision: the mixed_bfloat16 policy, bf16 optimizer slots, the bf16
# forms of K1-K3
# ---------------------------------------------------------------------------

_SM_CLOCK_HZ = []


def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi ``clocks.max.sm``), in Hz."""
    if not _SM_CLOCK_HZ:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=60, check=True)
        _SM_CLOCK_HZ.append(float(out.stdout.split()[0]) * 1e6)
    return _SM_CLOCK_HZ[0]


def mixed_model(dev, catalog, seed):
    import models_tpu_torch as mt

    return mt.TwoTowerModel(catalog.schema, query_tower=(256, 128), embedding_dim=128,
                            seed=seed, device=dev)


def compare_rounded(name, pairs, tol, flip, share_of=None):
    """``pairs`` of (card, CPU) tensors: every element within ``tol`` but for
    the flips, which stay within ``flip`` = (a, r): a + r * the larger
    |value| (2**-7 of it is one bf16 ulp at most). At most FLIP_SHARE_MAX of
    ``share_of`` elements (default: all compared) may flip. Returns the
    largest |difference| outside the flips, their count, the share's
    denominator and the largest flip."""
    worst, flips, total, largest = 0.0, 0, 0, 0.0
    for got, want in pairs:
        got, want = got.detach().float().cpu(), want.detach().float().cpu()
        d = (got - want).abs()
        off = d > tol
        within = d <= flip[0] + flip[1] * torch.maximum(got.abs(), want.abs())
        require(bool(within[off].all()),
                f"{name}: {int(off.sum())} elements past {tol:.3g}, some past {flip} "
                f"(largest |d| {float(d.max()):.3g})")
        worst = max(worst, float(d[~off].max()) if bool((~off).any()) else 0.0)
        largest = max(largest, float(d[off].max()) if bool(off.any()) else 0.0)
        flips += int(off.sum())
        total += d.numel()
    share_of = total if share_of is None else share_of
    require(flips <= FLIP_SHARE_MAX * max(share_of, 1),
            f"{name}: {flips} elements flipped, of {share_of}")
    return worst, flips, share_of, largest


def moved(base: dict, after: dict) -> int:
    """Elements of ``after``'s tensors that differ from ``base``'s."""
    return sum(int((after[n].detach().cpu() != t.detach().cpu()).sum()) for n, t in base.items())


def mixed_head_cotangents(model, xb):
    """The fused head's float32 cotangents under the policy, before the head
    rounds them to bf16 (``ops/contrastive.py::loss_cotangents``: the bf16
    forms of K2 and K3 and the positive's term, on the towers' outputs cast
    to bf16 as the head casts them), against the unfused head's loss taken
    by float32 autograd on the same bf16 values: within TRAIN_GRAD_TOL of the
    largest |cotangent|. Control: the same cotangents rounded to bf16, as
    the head returns them, must miss that tolerance. Returns (error,
    control's error), of the largest |cotangent|."""
    from models_tpu_torch.core.constants import MIN_FLOAT
    from models_tpu_torch.core.types import ModelContext
    from models_tpu_torch.ops import contrastive as C

    head = model.contrastive_output
    T = head.logits_scaler.temperature if head.logits_scaler is not None else 1.0
    with torch.no_grad():
        towers = model.blocks[0](xb, context=ModelContext(features=xb))
    valid = xb["__row_valid__"].bool()
    q = towers["query"].bfloat16().contiguous()
    c = towers["candidate"].bfloat16().contiguous()
    neg = torch.where(valid[:, None], c, 0.0).contiguous()
    bias = torch.where(valid, 0.0, MIN_FLOAT).contiguous()
    ids = xb[model.item_id_name].to(torch.int32).contiguous()
    pid = nid = ids if head.downscore_false_negatives else None
    w = valid.float()
    stats = C.loss_stats(q, c, neg, pid, nid, bias, None, T)
    dq, dp, dn = C.loss_cotangents(torch.ones((), device=q.device), q, c, neg, pid, nid, w, bias,
                                   *stats, T)
    fused = {"query": dq, "candidate": dp + torch.where(valid[:, None], dn, 0.0)}
    # the unfused head: [positive | negatives] logits, the false negatives and
    # the invalid rows masked, a softmax cross-entropy weighted by the rows
    qf, cf = q.float().requires_grad_(), c.float().requires_grad_()
    negs = qf @ cf.T
    mask = ~valid[None, :]
    if pid is not None:
        mask = mask | (ids[None, :] == ids[:, None])
    logits = torch.cat([(qf * cf).sum(1, keepdim=True), torch.where(mask, MIN_FLOAT, negs)], 1)
    per = torch.logsumexp(logits / T, 1) - logits[:, 0] / T
    ((per * w).sum() / w.sum()).backward()
    want = {"query": qf.grad, "candidate": cf.grad}
    scale = max(float(g.abs().max()) for g in want.values())
    err = max(max_err(fused[k], want[k]) for k in want) / scale
    control = max(max_err(fused[k].bfloat16().float(), want[k]) for k in want) / scale
    require(err <= TRAIN_GRAD_TOL, f"mixed: fused vs unfused float32 cotangents off by {err:.3g}")
    require(control > TRAIN_GRAD_TOL,
            f"mixed: cotangents rounded to bf16 within {control:.3g} of the float32 ones")
    return err, control


def phase_mixed_checks(dev, catalog):
    """The mixed-precision path at the bench's configuration
    (``set_dtype_policy("mixed_bfloat16")``, ``compile("adagrad",
    learning_rate=0.05, optimizer_state_dtype="bfloat16")``), checked at
    batch 8192:

    - the fused loss (the bf16 forms of K1-K3, each launched once, the fp32
      forms never) against the same step on a CPU copy (the plain versions;
      loss within FCE_TOL, gradients within TRAIN_GRAD_TOL of the largest
      |gradient| but for bf16 rounding flips: at most FLIP_SHARE_MAX of the
      nonzero elements, each within FLIP_GRAD_TOL of it);
    - against the unfused head on the card: the loss within FCE_TOL, the
      model's gradients within MIXED_HEAD_GRAD_TOL, the head's float32
      cotangents within TRAIN_GRAD_TOL (``mixed_head_cotangents``);
    - three steps against a CPU copy, with and without
      ``optimizer_state_dtype`` (losses within FCE_TOL, parameters and slots
      within PARAM_ATOL but for flips, which stay within MIXED_PARAM_ATOL;
      the slots bf16);
    - row-sparsely with bf16 tables (``embedding_optimizer="adagrad"``),
      three steps against a CPU copy rounding with the same noise: as
      above, a bf16 table element one bf16 ulp at most.

    The caller sets the policy."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.core.types import to_device_batch, to_device_targets
    from models_tpu_torch.data import Loader

    model = mixed_model(dev, catalog, SEED + 12)
    ds = mt.generate_data("movielens-25m", num_rows=TRAIN_BATCH, seed=SEED + 4)
    x, y = next(iter(Loader(ds, TRAIN_BATCH)))
    xb, yb = to_device_batch(x, dev), to_device_targets(y, dev)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[],
                  optimizer_state_dtype="bfloat16")
    zero_launches()
    fused_loss, fused = head_grads(model, xb, yb, fused=True)
    torch.cuda.synchronize()
    launches = {**flash_launches(), **flash_launches_bf16()}
    require(launches == {"lse_forward": 0, "grad_query": 0, "grad_neg": 0, "lse_forward_bf16": 1,
                         "grad_query_bf16": 1, "grad_neg_bf16": 1},
            f"one mixed-precision step launched {launches}")
    cpu = copy.deepcopy(model).to("cpu")
    cpu_loss, cpu_grads = head_grads(cpu, to_device_batch(x, "cpu"), to_device_targets(y, "cpu"),
                                     fused=True)
    err = abs(fused_loss - cpu_loss) / abs(cpu_loss)
    require(err <= FCE_TOL, f"mixed: fused loss {fused_loss} on the card vs {cpu_loss} on the CPU")
    # a gradient element may sum bf16-rounded cotangents (an embedding row's
    # over the batch), some of which the two sides round to neighbours
    scale = max(float(g.abs().max()) for g in cpu_grads.values())
    worst, flips, total, largest = compare_rounded(
        "mixed fused gradients, card vs CPU",
        [(fused[n], cpu_grads[n]) for n in cpu_grads], TRAIN_GRAD_TOL * scale,
        (FLIP_GRAD_TOL * scale, 0.0), share_of=sum(int((g != 0).sum()) for g in cpu_grads.values()))
    print(f"  batch {TRAIN_BATCH}, mixed_bfloat16: fused loss card {fused_loss:.7f} vs CPU "
          f"{cpu_loss:.7f} (rel {err:.3g}); gradients off by {worst / scale:.3g} of the largest "
          f"|gradient| {scale:.3g} but {flips} of {total} nonzero elements, the largest "
          f"{largest:.3g} ({largest / scale:.3g} of it)", flush=True)
    plain_loss, plain = head_grads(model, xb, yb, fused=False)
    err = abs(fused_loss - plain_loss) / abs(plain_loss)
    require(err <= FCE_TOL, f"mixed: fused loss {fused_loss} vs unfused {plain_loss}")
    worst = max(max_err(fused[n], plain[n]) for n in plain) / scale
    require(worst <= MIXED_HEAD_GRAD_TOL, f"mixed: fused vs unfused gradients off by {worst:.3g}")
    head, control = mixed_head_cotangents(model, xb)
    print(f"  batch {TRAIN_BATCH}, mixed_bfloat16: fused loss {fused_loss:.7f} vs unfused "
          f"{plain_loss:.7f} (rel {err:.3g}); gradients off by {worst:.3g} of the largest "
          f"|gradient| (the heads round the query's cotangents at other places); the head's "
          f"float32 cotangents off by {head:.3g} of the largest (rounded to bf16: "
          f"{control:.3g})", flush=True)
    stamp("mixed precision: three steps on the card and on a CPU copy")

    steps = mt.generate_data("movielens-25m", num_rows=TRAIN_BATCH, seed=SEED + 5)
    runs = (("bf16 slots", {"optimizer_state_dtype": "bfloat16"}, None),
            ("fp32 slots", {}, None),
            ("bf16 tables, row-sparse", {"embedding_optimizer": "adagrad"}, torch.bfloat16))
    for tag, kw, table_dtype in runs:
        base = model if table_dtype is None else mt.TwoTowerModel(
            catalog.schema, query_tower=(256, 128), embedding_dim=128, table_dtype=table_dtype,
            seed=SEED + 13, device=dev)
        on_card, on_cpu = copy.deepcopy(base), copy.deepcopy(base).to("cpu")
        hist = {}
        for side, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
            m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], **kw)
            if m._emb_opt is not None:
                m._emb_opt.noise = cpu_noise
            hist[side] = m.fit(steps, epochs=3, batch_size=TRAIN_BATCH, shuffle=False,
                               device=d).history["loss"]
        np.testing.assert_allclose(hist["card"], hist["cpu"], rtol=FCE_TOL)
        state = {n: t for n, t in list(base.named_parameters()) + list(base.named_buffers())}
        cpu_state = {**dict(on_cpu.named_parameters()), **dict(on_cpu.named_buffers())}
        card_state = {**dict(on_card.named_parameters()), **dict(on_card.named_buffers())}
        # parameters and the row-sparse slots: PARAM_ATOL, flips within
        # MIXED_PARAM_ATOL, at most FLIP_SHARE_MAX of the parameter elements the
        # steps moved (the slots, made by fit, count their flips only); bf16
        # tables, rounded stochastically from such updates: every element
        # that differs is a flip, within MIXED_PARAM_ATOL and one bf16 ulp
        for kind, names, tol, flip in (
                ("fp32 parameters and row-sparse slots",
                 [n for n, t in card_state.items() if t.dtype == torch.float32], PARAM_ATOL,
                 (MIXED_PARAM_ATOL, 0.0)),
                ("bf16 tables", [n for n, t in card_state.items() if t.dtype == torch.bfloat16],
                 0.0, (MIXED_PARAM_ATOL, 2.0 ** -7))):
            if not names:
                continue
            worst, flips, n_moved, largest = compare_rounded(
                f"mixed {tag} {kind}, card vs CPU", [(card_state[n], cpu_state[n]) for n in names],
                tol, flip, share_of=moved({n: state[n] for n in names if n in state}, cpu_state))
            print(f"  mixed_bfloat16, {tag}: 3 adagrad steps at batch {TRAIN_BATCH}, card vs "
                  f"CPU: losses {hist['card']} vs {hist['cpu']}; {kind} max|d| {worst:.3g} but "
                  f"{flips} of {n_moved} moved elements, the largest {largest:.3g} (within "
                  f"{flip})", flush=True)
        # the dense optimizer's slots: a flipped gradient g moves acc += g*g by
        # up to 2**-6 of itself; bf16 slots round that to one more ulp at most
        slots = [(a, b) for sa, sb in zip(on_card._optimizer.state.values(),
                                          on_cpu._optimizer.state.values())
                 for a, b in zip(sa.values(), sb.values())]
        dtypes = {a.dtype for pair in slots for a in pair}
        require(dtypes == {torch.bfloat16 if "optimizer_state_dtype" in kw else torch.float32},
                f"{tag}: dense slots {dtypes}")
        worst, flips, n_slots, largest = compare_rounded(
            f"mixed {tag} dense slots, card vs CPU", slots, PARAM_ATOL, (0.0, 2.0 ** -6 + 2.0 ** -7))
        print(f"  mixed_bfloat16, {tag}: dense slots ({dtypes.pop()}) max|d| {worst:.3g} but "
              f"{flips} of {n_slots} elements, the largest {largest:.3g}", flush=True)
    return model


def phase_mixed_train(dev, model, catalog, queries):
    """The mixed-precision training path at full width: 16 steps of 8192
    rows (``fit``, two epochs), each launching K1-K3 once in their bf16
    forms and never in their fp32 forms; losses finite, the slots bf16; the
    trained model serves 256 rows under the policy."""
    import models_tpu_torch as mt

    data = mt.generate_data("movielens-25m", num_rows=8 * TRAIN_BATCH, seed=SEED + 3)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[],
                  optimizer_state_dtype="bfloat16")
    zero_launches()
    t = time.perf_counter()
    hist = model.fit(data, epochs=2, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    torch.cuda.synchronize()
    steps = 2 * data.num_rows // TRAIN_BATCH
    launches = flash_launches_bf16()
    print(f"  fit {steps} mixed-precision steps in {time.perf_counter() - t:.2f} s: loss "
          f"{hist.history['loss']}, launches {launches}, fp32 forms {flash_launches()}",
          flush=True)
    require(all(n == steps for n in launches.values()),
            f"the mixed path launched the bf16 forms {launches} in {steps} steps")
    require(not any(flash_launches().values()), "the mixed path launched an fp32 form")
    require(all(np.isfinite(hist.history["loss"])), "mixed: non-finite training loss")
    require(all(v.dtype == torch.bfloat16 for st in model._optimizer.state.values()
                for v in st.values()), "mixed: the optimizer's slots left bf16")
    enc = model.to_top_k_encoder(catalog, k=K, batch_size=1024, device=dev)
    out = enc.predict(queries.take(256), batch_size=256, device=dev)
    require(out["scores"].shape == (256, K) and np.isfinite(out["scores"]).all(),
            "mixed: the trained model serves non-finite scores")
    return data, launches, {"fit_loss": hist.history["loss"],
                            "fit_examples_per_sec": hist.history["examples_per_sec"]}


# ---------------------------------------------------------------------------
# k steps a chunk (compile(steps_per_execution=, jit=)): device-resident
# columns, the chunk's rows gathered by K9, the chunk one CUDA graph replay
# ---------------------------------------------------------------------------

PIPE_BATCHES = 128  # the JAX package's pipeline headline (bench.py:37, :464-522)
# the chunked route against one step at a time: the packed batches carry no
# __row_valid__, so the loss is a plain mean of the rows' losses where the
# streaming route takes a weighted one (weights 1): a few ulps apart. Also
# the graph route against the eager one: F.embedding's backward sums the
# genres table's repeated rows in an order that varies from call to call
SPE_LOSS_RTOL = 1e-6
# Adam on the card is capturable: its step count lives on the device and its
# bias corrections are taken there in float32, with beta2 = 0.999 rounded to
# float32 (1.3e-8 off: 1.3e-5 of 1 - beta2, as optax takes them), where
# torch's default form takes them in Python floats. On the same gradients
# the two forms' updates differ by up to 6.4e-6 of the update (half of that
# error, under the square root), |u_t| <= lr * sqrt(t) at step t, and each
# step may round the parameter one ulp apart: after n steps an element is
# held to ADAM_MOVE * ADAM_REL + n * ADAM_ATOL_P * |p|
ADAM_LR = 1e-3
ADAM_STEPS = 3
ADAM_REL = 2.0 ** -16
ADAM_ATOL_P = 2.0 ** -23
ADAM_MOVE = ADAM_LR * sum((t + 1) ** 0.5 for t in range(ADAM_STEPS))  # sum_t lr * sqrt(t)
# Adam card vs CPU: an element whose gradient is rounding noise (a bias whose
# true gradient is 0) takes a step of up to lr * sqrt(t) of either sign on
# either side; such elements, at most FLIP_SHARE_MAX of them, are held to
# twice the sum of those steps, the rest to PARAM_ATOL
ADAM_FLIP_ATOL = 2 * ADAM_MOVE


def spe_data(batches: int):
    """movielens-25m rows for ``batches`` batches of 8192: 16 batches
    generated from a seed (the generator builds list columns row by row,
    some 27 s for 2**20 rows), repeated to the count where it is larger."""
    import models_tpu_torch as mt
    from models_tpu_torch.data.dataset import take_rows

    base = mt.generate_data("movielens-25m", num_rows=16 * TRAIN_BATCH, seed=SEED + 5)
    if batches <= 16:
        return base.take(batches * TRAIN_BATCH)
    idx = np.tile(np.arange(base.num_rows), -(-batches // 16))[:batches * TRAIN_BATCH]
    return base._from_cols(take_rows(base.to_numpy_dict(), idx))


def route_launches() -> dict:
    from models_tpu_torch.ops import embedding_lookup as E
    from models_tpu_torch.ops import scatter as S

    return {**flash_launches(), **flash_launches_bf16(), "row_gather": E.row_gather.launches,
            "row_scatter_write": S.row_scatter_write.launches}


def row_route(model, steps: int = 1) -> dict:
    """The row route's launches in ``steps`` steps of ``model`` (the dense
    Adagrad or SGD at a lookup-only table's looked-up rows,
    ``blocks/optimizer.py``), issued or replayed: each routed table's step
    gathers (K9) its rows, its gradient's and each slot's, and writes (K8a)
    its rows and each slot's back."""
    from models_tpu_torch.blocks.optimizer import MultiStep

    opt, routes = model._optimizer, model._row_routes or frozenset()
    k9 = k8 = 0
    for o in (opt.optimizers.values() if isinstance(opt, MultiStep) else [opt]):
        n = sum(p in routes for g in o.param_groups for p in g["params"])
        slots = len(getattr(o, "slots", ()))
        k9, k8 = k9 + n * (2 + slots), k8 + n * (1 + slots)
    return {"row_gather": k9 * steps, "row_scatter_write": k8 * steps}


def routed_tables(model) -> list:
    """The columns (block names) of the tables the row route steps."""
    routes = model._row_routes or frozenset()
    return sorted(n.split(".")[-2] for n, p in model.named_parameters() if p in routes)


def zero_route_launches() -> None:
    from models_tpu_torch.ops import embedding_lookup as E

    zero_launches()
    E.row_gather.launches = 0


def spe_fit(dev, catalog, data, epochs, shuffle=True, optimizer="adagrad", learning_rate=0.05,
            make=None, batch=None, pre=None, **compile_kw):
    """A fresh seeded model (the two-tower model, or ``make()``) fit with
    ``compile(**compile_kw)`` in batches of ``batch`` (TRAIN_BATCH), with
    ``fit(pre=pre)``: (history, model, the launches its wrappers counted,
    host seconds)."""
    model = make() if make is not None else mixed_model(dev, catalog, SEED)
    model.compile(optimizer=optimizer, learning_rate=learning_rate, **compile_kw)
    zero_route_launches()
    t = time.perf_counter()
    hist = model.fit(data, epochs=epochs, batch_size=batch or TRAIN_BATCH, shuffle=shuffle,
                     pre=pre, device=dev)
    torch.cuda.synchronize()
    return hist.history, model, route_launches(), time.perf_counter() - t


def same_params(a, b) -> bool:
    """Every parameter and buffer (BatchNorm's statistics) equal."""
    pa = dict(list(a.named_parameters()) + list(a.named_buffers()))
    pb = dict(list(b.named_parameters()) + list(b.named_buffers()))
    return sorted(pa) == sorted(pb) and all(torch.equal(pa[n], pb[n]) for n in pa)


def optimizer_tensors(model) -> list:
    """The dense optimizer's state tensors, in the order of its parameters
    (Adam's ``step`` among them); with bf16 slots, the flat tensor at rest."""
    opt = model._optimizer
    inner = getattr(opt, "optimizer", opt)
    ts = [v for st in inner.state.values() for v in st.values() if torch.is_tensor(v)]
    rest = getattr(opt, "_rest", None)
    return ts + ([rest] if rest is not None else [])


def same_state(a, b) -> bool:
    sa, sb = optimizer_tensors(a), optimizer_tensors(b)
    return len(sa) == len(sb) > 0 and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(sa, sb))


def param_spread(a, b) -> list:
    """[max |a - b| over every parameter, the elements that differ]."""
    pb = dict(b.named_parameters())
    with torch.no_grad():
        diffs = [(p - pb[n]).abs() for n, p in a.named_parameters()]
    return [max(float(d.max()) for d in diffs), int(sum(int((d != 0).sum()) for d in diffs))]


@contextlib.contextmanager
def deterministic(on: bool):
    """``torch.use_deterministic_algorithms`` on inside the block, where
    ``on`` (an op with no deterministic form only warns; the warnings are
    dropped)."""
    if not on:
        yield
        return
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def graph_vs_eager(dev, catalog, data, epochs, what, shuffle=True, **kw):
    """One configuration fit on the graph route and eagerly (``jit=False``)
    from the same seed, deterministic algorithms on: losses, every parameter
    and the optimizer's state bit for bit, one graph captured. Returns the
    graph run's (history, model, launches) and the eager run's launches."""
    with deterministic(True):
        hg, mg, lg, _ = spe_fit(dev, catalog, data, epochs, shuffle, **kw)
        he, me, le, _ = spe_fit(dev, catalog, data, epochs, shuffle, jit=False, **kw)
    require(len(mg._chunk_graphs) == 1 and len(me._chunk_graphs) == 0,
            f"{what}: {len(mg._chunk_graphs)} graphs captured on the graph route")
    require(hg["loss"] == he["loss"], f"{what}: losses {hg['loss']} (graph) / {he['loss']}")
    require(same_params(mg, me), f"{what}: graph and eager parameters differ: "
            f"{param_spread(mg, me)}")
    require(same_state(mg, me), f"{what}: graph and eager optimizer states differ")
    print(f"  {what}: graph and eager bit-equal over {epochs} epochs (losses {hg['loss']}, "
          f"parameters, {len(optimizer_tensors(mg))} optimizer state tensors)", flush=True)
    return hg, mg, lg, le


def embedding_backward_repeat(dev, data) -> list:
    """F.embedding's backward twice on the first batch's genres ids into the
    genres table's 24 rows: [elements of the two gradients that differ, of
    all]."""
    from models_tpu_torch.data import Loader

    x, _ = next(iter(Loader(data, TRAIN_BATCH, drop_last=True)))
    ids = torch.as_tensor(x["genres"].values, device=dev).long()
    table = torch.randn(24, 128, device=dev, requires_grad=True)
    up = torch.randn(*ids.shape, 128, device=dev)
    grads = []
    for _ in range(2):
        table.grad = None
        torch.nn.functional.embedding(ids, table).backward(up)
        grads.append(table.grad.clone())
    return [int((grads[0] != grads[1]).sum()), grads[0].numel()]


def graph_stats(model) -> list:
    return [{"k": key[0], "metrics": key[1], **v} for key, v in model._chunk_graphs.stats.items()]


def replayed_fit(model, data, epochs, steps, what, batch=TRAIN_BATCH, pre=None):
    """A fit of a model whose chunks are all captured, on the default device
    (``device=None``): host seconds, ms a step (host clock, the fit's wall
    over its steps), the history. Every chunk must replay: the same pack and
    the same graphs as before, and no wrapper launches a kernel."""
    ds_pack = getattr(data, "_device_train_pack", None)
    graphs = dict(model._chunk_graphs._entries)
    zero_route_launches()
    t = time.perf_counter()
    hist = model.fit(data, epochs=epochs, batch_size=batch, shuffle=False, pre=pre)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ln = route_launches()
    require(ds_pack is not None and data._device_train_pack is ds_pack,
            f"{what}: fit(device=None) packed the dataset again")
    require(len(model._chunk_graphs) == len(graphs) and all(
        model._chunk_graphs._entries.get(key) is e for key, e in graphs.items()),
        f"{what}: fit(device=None) captured its chunks again")
    require(not any(ln.values()), f"{what}: eager launches on the replayed route: {ln}")
    return hist.history, wall, wall / steps * 1e3


def traced_replays(model, data, steps, want, what, batch=TRAIN_BATCH, pre=None) -> dict:
    """The device's busy share of a traced fit of one epoch of replays and the
    launches its trace shows (profile_launches): each of ``want``'s kernels
    that many times, and the row route's K9 and K8a besides (row_route), the
    route's others never, and no wrapper called."""
    route = row_route(model, steps)
    want = {**want, **{n: want.get(n, 0) + v for n, v in route.items()}}
    out = profile_launches(
        lambda: model.fit(data, epochs=1, batch_size=batch, shuffle=False, pre=pre), steps,
        want, what)
    require(not any(out["launches_issued"].values()),
            f"{what}: eager launches on the replayed route: {out['launches_issued']}")
    return out


def adam_capturable_cost(dev, model) -> dict:
    """The card's Adam (``make_optimizer``: capturable) against torch's
    default Adam on copies of ``model``'s parameters, fed the same seeded
    gradients for ADAM_STEPS steps (spread over eight decades, a tenth of
    them exactly 0): every element within ADAM_MOVE * ADAM_REL +
    ADAM_STEPS * ADAM_ATOL_P * |p|. Returns the largest |difference| and
    the elements that differ."""
    from models_tpu_torch.blocks.optimizer import make_optimizer

    g = torch.Generator(dev).manual_seed(SEED + 7)
    base = [p.detach().clone() for p in model.parameters()]
    pa, pb = [p.clone() for p in base], [p.clone() for p in base]
    oa = make_optimizer("adam", pa, ADAM_LR)
    ob = torch.optim.Adam(pb, lr=ADAM_LR, eps=1e-8)
    require(oa.defaults["capturable"] and not ob.defaults["capturable"],
            "make_optimizer's Adam on the card is not capturable")
    for _ in range(ADAM_STEPS):
        for a, b in zip(pa, pb):
            scale = torch.empty(a.shape, device=dev).uniform_(-23.0, -4.6, generator=g).exp_()
            grad = torch.randn(a.shape, device=dev, generator=g) * scale
            grad[torch.rand(a.shape, device=dev, generator=g) < 0.1] = 0.0
            a.grad, b.grad = grad, grad.clone()
        oa.step()
        ob.step()
    worst, differ = 0.0, 0
    for a, b in zip(pa, pb):
        d = (a - b).abs()
        tol = (ADAM_MOVE * ADAM_REL + ADAM_STEPS * ADAM_ATOL_P * torch.maximum(a.abs(), b.abs()))
        require(bool((d <= tol).all()), f"Adam capturable vs not: |d| {float(d.max()):.3g} past "
                f"the tolerance")
        worst, differ = max(worst, float(d.max())), differ + int((d != 0).sum())
    return {"max_abs": worst, "elements_differing": differ,
            "elements": sum(p.numel() for p in pa)}


def adam_card_vs_cpu(dev, catalog) -> dict:
    """ADAM_STEPS Adam steps, one at a time, at batch 1024 on the card
    (capturable) and on a CPU copy (not): losses within FCE_TOL, parameters
    within PARAM_ATOL but for elements whose gradient is rounding noise,
    held to ADAM_FLIP_ATOL (at most FLIP_SHARE_MAX of them)."""
    import copy

    import models_tpu_torch as mt

    small = mt.generate_data("movielens-25m", num_rows=1024, seed=SEED + 5)
    on_card = mixed_model(dev, catalog, SEED)
    on_cpu = copy.deepcopy(on_card).to("cpu")
    hist = {}
    for tag, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
        m.compile(optimizer="adam", learning_rate=ADAM_LR, metrics=[])
        hist[tag] = m.fit(small, epochs=ADAM_STEPS, batch_size=1024, shuffle=False,
                          device=d).history["loss"]
    np.testing.assert_allclose(hist["card"], hist["cpu"], rtol=FCE_TOL)
    require(on_card._optimizer.defaults["capturable"]
            and not on_cpu._optimizer.defaults["capturable"], "Adam's forms on card and CPU")
    cpu = dict(on_cpu.named_parameters())
    worst, flips, total, largest = compare_rounded(
        "Adam card vs CPU", [(p, cpu[n]) for n, p in on_card.named_parameters()], PARAM_ATOL,
        (ADAM_FLIP_ATOL, 0.0))
    return {"losses_card": hist["card"], "losses_cpu": hist["cpu"], "params_max_abs": worst,
            "flips": flips, "of": total, "largest_flip": largest}


def phase_steps_per_execution(dev, catalog, card):
    """``compile(steps_per_execution=, jit=)`` at full width.

    (a) fp32 dense adagrad, 16 batches, 2 epochs, shuffled, 8 steps a chunk:
    graph, eager (twice) and one step at a time, and graph and eager again
    with deterministic algorithms on; those two bit for bit (losses, every
    parameter, the optimizer's state), the others within SPE_LOSS_RTOL and
    PARAM_ATOL (the eager route does not repeat itself bit for bit:
    F.embedding's backward on the genres table, printed). Then two fits of
    the graph model on the default device (``device=None``), every chunk
    replayed: the first timed, the second traced.
    (b) the JAX package's pipeline headline (mixed_bfloat16, bf16 slots, no
    metrics, PIPE_BATCHES batches an epoch and a chunk, unshuffled): graph
    and eager bit for bit over 3 epochs (the first chunk eager, the second
    captured, the third replayed), deterministic algorithms on; then the
    same graph model, its chunk captured again with them off (as users run
    it): a warm fit, a measured one, its ms a step, the device's busy share
    of a traced replay, the capture's seconds and its pool's bytes.
    (c) metrics inside a chunk (train_metrics_steps = 3, 4 steps a chunk,
    the default top-k metrics), deterministic algorithms on: graph and eager
    histories bit for bit.
    (d) the launch counts. A wrapper counts what it issues: the eager
    chunk's launches and those a capture records, so on the graph route K9
    twice and K1-K3 2 k times (eager, then captured), eagerly once a chunk
    and once a step. Replays call no wrapper: the traces of (a) and (b)
    count their kernels, K1-K3 once a step and K9 once a chunk.
    (e) Adam (capturable on the card): its arithmetic against torch's default
    form on the same gradients, the card against a CPU copy one step at a
    time, and graph and eager bit for bit in fp32 and under mixed_bfloat16
    with bf16 slots (which Adam makes at its first step, in the eager
    chunk).

    Returns (the launches of (a)'s graph run, the kernels' launches in the
    traces of (a) and (b), the numbers to print)."""
    import models_tpu_torch as mt

    t_phase = time.perf_counter()
    out = {"card": card}
    data = spe_data(16)
    runs = {}
    for tag, kw in (("graph", dict(steps_per_execution=8)),
                    ("eager", dict(steps_per_execution=8, jit=False)),
                    ("eager2", dict(steps_per_execution=8, jit=False)),
                    ("spe1", dict(steps_per_execution=1))):
        runs[tag] = spe_fit(dev, catalog, data, 2, metrics=[], **kw)
    hd, md, ld, lde = graph_vs_eager(dev, catalog, data, 2, "(a) fp32 adagrad", metrics=[],
                                     steps_per_execution=8)
    runs["graph_det"] = (hd, md, ld, None)
    runs["eager_det"] = (None, None, lde, None)
    (hg, mg, lg, sg), (he, me, le, se), (h1, m1, l1, s1) = (runs[t] for t in
                                                            ("graph", "eager", "spe1"))
    print(f"  (a) fp32, 8 steps a chunk: graph {sg:.2f} s, eager {se:.2f} s, one step at a "
          f"time {s1:.2f} s; losses {hg['loss']} / {he['loss']} / {h1['loss']}; launches "
          f"{lg} / {le} / {l1}; graphs {graph_stats(mg)}", flush=True)
    require(len(mg._chunk_graphs) == 1 and len(me._chunk_graphs) == 0,
            f"(a): {len(mg._chunk_graphs)} graphs captured on the graph route")
    # F.embedding's backward sums the genres table's repeated rows (81,920
    # ids into 24 rows a batch) in an order that varies from call to call
    # unless deterministic algorithms are on: the eager route does not repeat
    # itself bit for bit. With them on, graph and eager are bit-equal
    # (graph_vs_eager); with them off (the route as users run it), within
    # the fp32 tolerances
    spread = {f"{a}_vs_{b}": param_spread(runs[a][1], runs[b][1])
              for a, b in (("graph", "eager"), ("eager", "eager2"))}
    out["embedding_backward_repeat"] = embedding_backward_repeat(dev, data)
    print(f"  (a) parameters, max |d| and elements differing: {spread}; F.embedding backward "
          f"called twice on a batch's genres ids: {out['embedding_backward_repeat']}",
          flush=True)
    out["param_spread"] = spread
    require(np.allclose(hg["loss"], he["loss"], rtol=SPE_LOSS_RTOL, atol=0)
            and spread["graph_vs_eager"][0] <= PARAM_ATOL,
            f"(a): graph against eager: losses {hg['loss']} / {he['loss']}, parameters {spread}")
    require(np.allclose(hg["loss"], h1["loss"], rtol=SPE_LOSS_RTOL, atol=0),
            f"(a): chunked losses {hg['loss']} against one step at a time {h1['loss']}")
    dp = param_spread(mg, m1)[0]
    require(dp <= PARAM_ATOL, f"(a): parameters {dp} from one step at a time")
    k, steps = 8, 2 * 16
    # the row route steps userId (162,542 x 128) and movieId (56,681 x 128)
    # at the 8192 ids a step looks up in each; genres (24 rows) densely
    for tag, m in (("graph", mg), ("eager", me), ("spe1", m1), ("graph_det", md)):
        require(routed_tables(m) == ["movieId", "userId"],
                f"(a) {tag}: the row route steps {routed_tables(m)}")
    for tag, (_, _, ln, _) in runs.items():
        # (K9 on the pack, each of K1-K3) the wrappers issue: the graph
        # route's eager chunk and captured chunk, eagerly every chunk and
        # step; the row route's K9 and K8a at each step issued
        want = {"graph": (2, 2 * k), "graph_det": (2, 2 * k), "spe1": (0, steps)}.get(
            tag, (steps // k, steps))
        route = row_route(mg, want[1])
        require(all(ln[n] == want[1] for n in ("lse_forward", "grad_query", "grad_neg"))
                and ln["row_gather"] == want[0] + route["row_gather"]
                and ln["row_scatter_write"] == route["row_scatter_write"],
                f"(a) {tag}: the wrappers issued {ln} in {steps} steps, want K9 {want[0]} on "
                f"the pack, K1-K3 {want[1]} times and the row route's {route}")
    out["dense_params_max_abs_from_spe1"] = dp
    del md, runs
    hist, wall, ms = replayed_fit(mg, data, 2, steps, "(a)")
    out["dense_graph_ms_per_step"] = ms
    out["dense_graph_examples_per_sec"] = hist["examples_per_sec"]
    dense = traced_replays(mg, data, 16, {"row_gather": 2, "lse_forward": 16,
                                          "grad_query": 16, "grad_neg": 16}, "(a)")
    out.update({f"dense_graph_{k}": v for k, v in dense.items()})
    launches = lg
    del mg, me, m1

    mt.set_dtype_policy("mixed_bfloat16")
    try:
        pipe = spe_data(PIPE_BATCHES)
        pipe_kw = dict(metrics=[], optimizer_state_dtype="bfloat16",
                       steps_per_execution=PIPE_BATCHES)
        _, model, _, _ = graph_vs_eager(dev, catalog, pipe, 3, "(b) mixed, bf16 slots, "
                                        f"{PIPE_BATCHES} steps a chunk", shuffle=False, **pipe_kw)
        # captured with deterministic algorithms on: the timed chunk is
        # captured again without them, as users run it
        model._chunk_graphs.clear()
        t = time.perf_counter()
        warm = model.fit(pipe, epochs=2, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
        torch.cuda.synchronize()
        out["pipe_warm_fit_s"] = time.perf_counter() - t
        out["pipe_warm_examples_per_sec"] = warm.history["examples_per_sec"]
        out["pipe_graphs"] = graph_stats(model)
        require(len(model._chunk_graphs) == 1, "(b): no graph captured")
        steps = 3 * PIPE_BATCHES
        hist, wall, ms = replayed_fit(model, pipe, 3, steps, "(b)")
        print(f"  (b) mixed, {PIPE_BATCHES} steps a chunk: {ms:.3f} ms a step, examples/s "
              f"{hist['examples_per_sec']}, graphs {out['pipe_graphs']}; {card}", flush=True)
        require(all(np.isfinite(hist["loss"])), "(b): non-finite loss")
        out.update({"pipe_batches": PIPE_BATCHES, "pipe_rows_generated": 16 * TRAIN_BATCH,
                    "pipe_ms_per_step": ms, "pipe_examples_per_sec": hist["examples_per_sec"],
                    "pipe_fit_s": wall, "pipe_loss": hist["loss"]})
        pipe_trace = traced_replays(model, pipe, PIPE_BATCHES, {
            "row_gather": 1, "lse_forward_bf16": PIPE_BATCHES,
            "grad_query_bf16": PIPE_BATCHES, "grad_neg_bf16": PIPE_BATCHES}, "(b)")
        out.update({f"pipe_{k}": v for k, v in pipe_trace.items()})
        del model, pipe
        torch.cuda.empty_cache()
        graph_vs_eager(dev, catalog, data, 2, "(e) Adam, mixed, bf16 slots, 8 steps a chunk",
                       optimizer="adam", learning_rate=ADAM_LR, metrics=[],
                       optimizer_state_dtype="bfloat16", steps_per_execution=8)
    finally:
        mt.set_dtype_policy("float32")
    torch.cuda.empty_cache()

    # deterministic algorithms on: the two routes run the same arithmetic, and
    # F.embedding's backward then repeats itself (see (a))
    data12 = data.take(12 * TRAIN_BATCH)
    with deterministic(True):
        hm, mm, lm, sm = spe_fit(dev, catalog, data12, 1, train_metrics_steps=3,
                                 steps_per_execution=4)
        hx, mx, lx, sx = spe_fit(dev, catalog, data12, 1, train_metrics_steps=3,
                                 steps_per_execution=4, jit=False)
    keys = sorted(k for k in hm if k != "examples_per_sec")
    print(f"  (c) metrics every 3rd step, 4 steps a chunk: graph {sm:.2f} s, eager {sx:.2f} s; "
          f"{ {k: hm[k] for k in keys} }; graphs {graph_stats(mm)}", flush=True)
    require(sorted(hm) == sorted(hx) and "recall_at_10" in hm, f"(c): keys {sorted(hm)}")
    require(all(hm[k] == hx[k] for k in keys), "(c): graph and eager histories differ")
    # K9: the pack's, once a chunk issued (the eager chunk and the capture;
    # eagerly 3 chunks), and the row route's at each of their 8 / 12 steps
    require(len(mm._chunk_graphs) == 1
            and lm["row_gather"] == 2 + row_route(mm, 8)["row_gather"]
            and lx["row_gather"] == 3 + row_route(mx, 12)["row_gather"],
            f"(c): {len(mm._chunk_graphs)} graphs, launches {lm} / {lx}")
    out["metrics_graphs"] = graph_stats(mm)
    del mm, mx

    graph_vs_eager(dev, catalog, data, 2, "(e) Adam, fp32, 8 steps a chunk", optimizer="adam",
                   learning_rate=ADAM_LR, metrics=[], steps_per_execution=8)
    probe = mixed_model(dev, catalog, SEED)
    out["adam_capturable_vs_default"] = adam_capturable_cost(dev, probe)
    del probe
    out["adam_card_vs_cpu"] = adam_card_vs_cpu(dev, catalog)
    print(f"  (e) Adam: capturable against torch's default form on the same gradients "
          f"{out['adam_capturable_vs_default']}; card against CPU, one step at a time, "
          f"{out['adam_card_vs_cpu']}", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    traced = {**dense["launches_traced"],
              **{n: v for n, v in pipe_trace["launches_traced"].items() if n.endswith("_bf16")}}
    # (a)'s K8 launches are the row route's fp32 writes (K8a)
    traced["row_scatter_write_fp32"] = traced.pop("row_scatter_write")
    return launches, traced, out


# ---------------------------------------------------------------------------
# ranking: the DLRM at the bench's width (criteo-small), the DLRM on the full
# Criteo cardinalities row-sparsely, DCN-v2, DeepFM and NCF, K9 on the pack
# ---------------------------------------------------------------------------

# bench.py::bench_dlrm_compute's model: D = 64, a bottom MLP of 256, 64 (and
# the embedding width), a top MLP of 256, 128; adagrad at 0.05, batch 8192
DLRM_KW = dict(embedding_dim=64, bottom_block=(256, 64), top_block=(256, 128))
DLRM_BATCHES = 16
DLRM_SPE = 8
DLRM_CPU_STEPS = 4
CRITEO_STEPS = 8
ZOO_BATCH, ZOO_STEPS = 1024, 3


def dlrm_model(dev, schema):
    import models_tpu_torch as mt

    return mt.DLRMModel(schema, seed=SEED, device=dev, **DLRM_KW)


def card_vs_cpu(dev, make, data, steps, batch, what) -> dict:
    """A seeded model and its CPU copy, ``steps`` adagrad steps each, in
    batches of ``batch``, unshuffled, no metrics: losses within FCE_TOL,
    every parameter and buffer within PARAM_ATOL. Returns the card's model,
    the CPU's and the numbers."""
    import copy

    on_card = make()
    on_cpu = copy.deepcopy(on_card).to("cpu")
    hist = {}
    for side, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
        m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
        hist[side] = m.fit(data.take(steps * batch), epochs=1, batch_size=batch, shuffle=False,
                           device=d).history
    loss_card, loss_cpu = hist["card"]["loss"], hist["cpu"]["loss"]
    require(all(np.isfinite(loss_card)), f"{what}: non-finite loss on the card")
    require(np.allclose(loss_card, loss_cpu, rtol=FCE_TOL, atol=0),
            f"{what}: losses {loss_card} (card) / {loss_cpu} (CPU)")
    cpu = dict(list(on_cpu.named_parameters()) + list(on_cpu.named_buffers()))
    worst = max(max_err(t.detach().cpu(), cpu[n].detach())
                for n, t in list(on_card.named_parameters()) + list(on_card.named_buffers()))
    require(worst <= PARAM_ATOL, f"{what}: card and CPU parameters differ by {worst:.3g}")
    print(f"  {what}: {steps} steps of {batch}, card vs CPU: losses {loss_card} / {loss_cpu}, "
          f"parameters max|d| {worst:.3g}", flush=True)
    return on_card, on_cpu, {"loss_card": loss_card, "loss_cpu": loss_cpu, "param_max_abs": worst}


def phase_dlrm(dev, card):
    """The DLRM at the bench's width on criteo-small (DLRM_KW, batch 8192,
    DLRM_BATCHES batches of seeded rows): (a) one step at a time, timed as
    the two-tower steps are (train_times, train_profile); (b) DLRM_SPE steps
    a chunk, each chunk a CUDA graph replay (K9 gathers the chunk's rows of
    the 40-column pack): graph and eager bit for bit with deterministic
    algorithms on, then the chunk captured again without them, a timed fit
    and a traced epoch (K9 once a chunk); (c) the card against a CPU copy
    after DLRM_CPU_STEPS steps; (d) ``evaluate`` with the binary head's
    metrics against the CPU copy's, and its examples/s; (e) ``predict``:
    probabilities in [0, 1], (B,), against the CPU copy's, and its latency at
    8192 rows. Returns (the numbers, K9's launches issued on the graph route,
    traced in a replayed epoch, the dataset)."""
    import models_tpu_torch as mt

    t_phase = time.perf_counter()
    out = {"card": card, "config": {**DLRM_KW, "batch": TRAIN_BATCH, "schema": "criteo-small",
                                    "optimizer": "adagrad", "learning_rate": 0.05}}
    data = mt.generate_data("criteo-small", num_rows=DLRM_BATCHES * TRAIN_BATCH, seed=SEED + 7)

    def make():
        return dlrm_model(dev, data.schema)

    model = make()
    out["parameters"] = sum(p.numel() for p in model.parameters())
    out["tables"] = {n: tuple(t.table.shape) for n, t in
                     model.blocks[0].embeddings.branches.items()}
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    warm = model.fit(data.take(2 * TRAIN_BATCH), batch_size=TRAIN_BATCH, shuffle=False,
                     device=dev)
    require(all(np.isfinite(warm.history["loss"])), "(a): non-finite loss")
    out["one_step"] = {**train_times(dev, model, data), **train_profile(dev, model, data)}
    print(f"  (a) one step at a time: {out['one_step']['step_ms']} ms, busy "
          f"{out['one_step']['device_busy_share']:.3f}, device "
          f"{out['one_step']['device_ms_per_step']:.3f} ms a step; {card}", flush=True)
    del model

    # (b) the graph route; its K9 launches counted from zero by spe_fit
    _, mg, lg, le = graph_vs_eager(dev, None, data, 2, f"(b) DLRM, {DLRM_SPE} steps a chunk",
                                   make=make, metrics=[], steps_per_execution=DLRM_SPE)
    # criteo-small's 26 columns share one fused table of 26,208 rows, looked
    # up 26 x 8192 times a step: more ids than half its rows, so no row route
    require(lg["row_gather"] == 2 and le["row_gather"] == 2 * DLRM_BATCHES // DLRM_SPE
            and lg["row_scatter_write"] == le["row_scatter_write"] == 0
            and not routed_tables(mg),
            f"(b): K9 issued {lg['row_gather']} (graph) / {le['row_gather']} (eager) times, "
            f"the row route on {routed_tables(mg)}")
    pack = data._device_train_pack
    require(pack is not None and tuple(pack.packed.shape) == (DLRM_BATCHES * TRAIN_BATCH, 40),
            f"(b): the pack is {None if pack is None else tuple(pack.packed.shape)}")
    mg._chunk_graphs.clear()  # captured again as users run it, deterministic algorithms off
    mg.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    steps = 2 * DLRM_BATCHES
    hist, wall, ms = replayed_fit(mg, data, 2, steps, "(b) DLRM")
    require(all(np.isfinite(hist["loss"])), "(b): non-finite loss")
    trace = traced_replays(mg, data, DLRM_BATCHES,
                           {"row_gather": DLRM_BATCHES // DLRM_SPE}, "(b) DLRM")
    out["graph"] = {"ms_per_step": ms, "examples_per_sec": hist["examples_per_sec"],
                    "fit_s": wall, "loss": hist["loss"], "graphs": graph_stats(mg),
                    "one_step_ms_ratio": ms / out["one_step"]["step_ms"][0],
                    **{k: v for k, v in trace.items() if k != "launches_issued"}}
    print(f"  (b) DLRM graph route: {ms:.3f} ms a step, examples/s {hist['examples_per_sec']}, "
          f"busy {trace['device_busy_share']:.3f}, K9 traced "
          f"{trace['launches_traced']['row_gather']} in {DLRM_BATCHES} replayed steps; {card}",
          flush=True)
    del mg

    on_card, on_cpu, out["card_vs_cpu"] = card_vs_cpu(dev, make, data, DLRM_CPU_STEPS,
                                                      TRAIN_BATCH, "(c) DLRM")
    evaluation = data.take(8 * TRAIN_BATCH)
    for m in (on_card, on_cpu):  # the binary head's default metrics
        m.compile(optimizer="adagrad", learning_rate=0.05)
    got = on_card.evaluate(evaluation, batch_size=TRAIN_BATCH, device=dev)
    want = on_cpu.evaluate(evaluation, batch_size=TRAIN_BATCH, device="cpu")
    require(sorted(got) == sorted(want) == ["label/auc", "label/binary_accuracy",
                                            "label/precision", "label/recall", "loss"],
            f"(d): evaluate's keys {sorted(got)}")
    compare_eval("(d) DLRM evaluate", got, want, TRAIN_BATCH)
    t = time.perf_counter()
    on_card.evaluate(evaluation, batch_size=TRAIN_BATCH, device=dev)
    torch.cuda.synchronize()
    out["evaluate"] = {"card": got, "cpu": want, "rows": evaluation.num_rows,
                       "examples_per_sec": evaluation.num_rows / (time.perf_counter() - t)}
    request = data.take(TRAIN_BATCH)
    probs = on_card.predict(request, batch_size=TRAIN_BATCH, device=dev)
    ref = on_cpu.predict(request, batch_size=TRAIN_BATCH, device="cpu")
    require(probs.shape == (TRAIN_BATCH,) and np.isfinite(probs).all()
            and ((probs >= 0) & (probs <= 1)).all(), f"(e): predict gave {probs.shape}")
    err = float(np.abs(probs - ref).max())
    require(err <= FCE_TOL, f"(e): card and CPU probabilities differ by {err:.3g}")
    out["predict"] = {"rows": TRAIN_BATCH, "max_abs_vs_cpu": err,
                      "ms": host_ms(lambda: on_card.predict(request, batch_size=TRAIN_BATCH,
                                                            device=dev))}
    print(f"  (d) evaluate {got}, {out['evaluate']['examples_per_sec']:.0f} examples/s; (e) "
          f"predict at {TRAIN_BATCH} rows {out['predict']['ms']} ms, probabilities within "
          f"{err:.3g} of the CPU's", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, lg["row_gather"], trace["launches_traced"]["row_gather"], data


def phase_criteo_sparse(dev, gen, errs):
    """The DLRM on the full Criteo cardinalities (26 tables, 31.46M rows at
    D = 64: fp32 tables and adagrad slots of 8 GB each), row-sparsely
    (``embedding_optimizer="adagrad"``), batch 8192, CRITEO_STEPS steps: K7
    must launch twice (slot and table) a table a step, on the fused tables
    and on the per-domain ones, every loss finite, every table's looked-up
    rows moved; the peak memory, the step's times (host clock, its parts);
    then K7 against its plain version, bit for bit, on the largest table's
    slot at one batch's deduplicated ids, and timed there (L2 flushed)
    beside ``index_add_``. Returns (the numbers, K7's launches in the fit,
    K7's times at that shape)."""
    import models_tpu_torch as mt
    from models_tpu_torch.ops import scatter as S

    t_phase = time.perf_counter()
    data = mt.generate_data("criteo", num_rows=CRITEO_STEPS * TRAIN_BATCH, seed=SEED + 8)
    gen_s = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)  # the earlier phases' tensors still alive
    model = dlrm_model(dev, data.schema)
    tables = model._embedding_tables()
    fused = [t for t in tables if isinstance(t, mt.inputs.FusedEmbeddingTables)]
    rows = sum(t.table.shape[0] for t in tables)
    x0, _ = next(iter(mt.Loader(data, TRAIN_BATCH)))
    before = {}
    for t in tables:
        ids = (torch.stack([torch.as_tensor(x0[f]) for f in t.features], 1).to(dev).long()
               + t.offsets if isinstance(t, mt.inputs.FusedEmbeddingTables)
               else torch.as_tensor(x0[t.features[0]], device=dev).long())
        before[id(t)] = (ids, t.table[ids].detach().clone())
    model.compile(optimizer="adagrad", learning_rate=0.05, embedding_optimizer="adagrad",
                  metrics=[])
    S.row_scatter_add.launches = 0
    t = time.perf_counter()
    hist = model.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    launches = S.row_scatter_add.launches
    n_sparse = len(model._sparse_tables)
    require(n_sparse == len(tables) and fused and len(tables) > len(fused),
            f"criteo: {n_sparse} of {len(tables)} tables row-sparse, {len(fused)} fused")
    require(launches == 2 * n_sparse * CRITEO_STEPS,
            f"criteo: K7 launched {launches} times in {CRITEO_STEPS} steps, want "
            f"{2 * n_sparse * CRITEO_STEPS}")
    require(all(np.isfinite(hist.history["loss"])), f"criteo: losses {hist.history['loss']}")
    for t in tables:
        ids, old = before[id(t)]
        require(not torch.equal(t.table[ids], old), f"criteo: table {t.block_name} did not move")
    peak = torch.cuda.max_memory_allocated(dev)
    out = {"rows": rows, "tables": n_sparse, "fused_tables": len(fused),
           "table_gb": sum(t.table.numel() * 4 for t in tables) / 1e9,
           "slot_gb": sum(t.sparse_slots["acc"].numel() * 4 for t in tables) / 1e9,
           "max_memory_allocated_gb": peak / 1e9, "peak_above_held_gb": (peak - held) / 1e9,
           "data_s": gen_s, "fit_s": fit_s,
           "loss": hist.history["loss"], "k7_launches": launches}
    out.update(train_times(dev, model, data))
    out.update(train_profile(dev, model, data))
    print(f"  criteo row-sparse: {rows} rows in {n_sparse} tables ({len(fused)} fused), peak "
          f"{peak / 1e9:.2f} GB ({(peak - held) / 1e9:.2f} above what earlier phases hold), K7 {launches} launches in {CRITEO_STEPS} steps, step "
          f"{out['step_ms']} ms (row-sparse update {out['sparse_update_ms']:.3f} ms)", flush=True)

    # K7 on the largest table's slot at one batch's ids, as the update runs it
    big = max(tables, key=lambda t: t.table.shape[0])
    k7 = measure_k7(dev, gen, big,
                    torch.as_tensor(x0[big.features[0]], device=dev).to(torch.int32), errs,
                    "criteo")
    del model, tables, before, big
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches, k7


def phase_ranking_zoo(dev):
    """DCN-v2 (stacked; parallel with low rank), DeepFM and NCF at the JAX
    tests' widths, ZOO_STEPS steps of ZOO_BATCH on the card against a CPU
    copy (card_vs_cpu); then a DCN whose deep MLP has BatchNorm, 4 steps a
    chunk: graph and eager bit for bit with deterministic algorithms on,
    BatchNorm's running statistics among the compared buffers; and Dropout's
    generator on a captured graph: each replay draws a new mask, and the
    replays draw what eager calls from the same seed draw."""
    import models_tpu_torch as mt
    from models_tpu_torch.blocks.mlp import Dropout, MLPBlock

    out = {}
    ec = mt.generate_data("e-commerce", num_rows=8 * ZOO_BATCH, seed=SEED + 9)
    ml = mt.generate_data("movielens-25m", num_rows=ZOO_STEPS * ZOO_BATCH, seed=SEED + 9)
    cases = {
        "dcn_stacked": (ec, lambda: mt.DCNModel(ec.schema, depth=2, deep_block=(32, 16),
                                                embedding_dim=8, device=dev)),
        "dcn_parallel_low_rank": (ec, lambda: mt.DCNModel(
            ec.schema, depth=1, deep_block=(16,), stacked=False, low_rank_dim=4,
            embedding_dim=8, device=dev)),
        "deepfm": (ec, lambda: mt.DeepFMModel(ec.schema, embedding_dim=8, deep_block=(16,),
                                              device=dev)),
        "ncf": (ml, lambda: mt.NCFModel(ml.schema, embedding_dim=8, mlp_block=(16,),
                                        device=dev)),
    }
    for name, (data, make) in cases.items():
        _, _, out[name] = card_vs_cpu(dev, make, data, ZOO_STEPS, ZOO_BATCH, name)

    def dcn_bn():
        width = mt.inputs.InputBlockV2(ec.schema, dim=8, device=dev).out_features
        return mt.DCNModel(ec.schema, depth=1, embedding_dim=8, device=dev,
                           deep_block=MLPBlock((32, 16), normalization="batch_norm",
                                               in_features=width, device=dev))

    _, mbn, _, _ = graph_vs_eager(dev, None, ec, 2, "DCN with BatchNorm, 4 steps a chunk",
                                  make=dcn_bn, batch=ZOO_BATCH, metrics=[],
                                  steps_per_execution=4)
    bn = [m for m in mbn.modules() if isinstance(m, mt.blocks.BatchNorm)]
    require(len(bn) == 2 and not torch.equal(bn[0].mean, torch.zeros_like(bn[0].mean)),
            "DCN with BatchNorm: the running statistics did not move on the graph route")

    x = torch.ones(4096, device=dev)
    eager = Dropout(0.5, seed=11, device=dev)
    stream = [eager(x, training=True) for _ in range(3)]
    drop = Dropout(0.5, seed=11, device=dev)
    first = drop(x, training=True)  # the eager chunk before a capture
    graph = torch.cuda.CUDAGraph()
    from models_tpu_torch.models.step_graph import chunk_generators

    holder = torch.nn.ModuleList([drop])
    for g in chunk_generators(holder):
        graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        captured = drop(x, training=True)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(captured.clone())
    torch.cuda.synchronize()
    require(not torch.equal(replays[0], replays[1]), "Dropout: two replays drew the same mask")
    out["dropout_replays_follow_eager_stream"] = bool(
        torch.equal(first, stream[0]) and torch.equal(replays[0], stream[1])
        and torch.equal(replays[1], stream[2]))
    print(f"  Dropout on a captured graph: replays draw new masks; they follow the eager "
          f"stream: {out['dropout_replays_follow_eager_stream']}", flush=True)
    return out


def measure_pack(dev, gen, packed, B, what, piece_bytes, errs) -> dict:
    """K9 on a training route's pack (``packed``: the dataset's int32
    columns) at one chunk's ids (B rows of a permutation): bit for bit
    against its plain version, its plan's piece bytes required, then timed as
    measure_gather times K9's other shapes: warm and flushed, the plain
    version and ``index_select`` flushed and warm. Bound: 2*B*row bytes +
    4*B bytes."""
    from models_tpu_torch.ops import embedding_lookup as E

    R, C = packed.shape
    ids = torch.randperm(R, device=dev, generator=gen)[:B].to(torch.int32)
    gather_case(f"{what} R={R} D={C} B={B} int32", packed, ids, errs)
    out_plan = E.gather_plan(packed, torch.empty(B, C, dtype=torch.int32, device=dev))
    require(out_plan["piece_bytes"] == piece_bytes, f"{what}: K9's plan {out_plan}")
    ids_l = ids.long()
    nbytes = 2 * B * C * 4 + 4 * B
    times = {"rows": R, "row_bytes": C * 4, "ids": B, "plan": out_plan,
             "ms": device_ms(lambda: E.row_gather(packed, ids)),
             "ms_cold": device_ms(lambda: E.row_gather(packed, ids), cold=True),
             "plain_ms": device_ms(lambda: E.row_gather_plain(packed, ids), cold=True),
             "library_ms": device_ms(lambda: torch.index_select(packed, 0, ids_l), cold=True),
             "library_ms_warm": device_ms(lambda: torch.index_select(packed, 0, ids_l)),
             "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
    times["share_of_bound_cold"] = times["bound_ms"] / times["ms_cold"]
    print(f"row gather, {what} " + json.dumps(times), flush=True)
    return times


def measure_k7(dev, gen, table, raw, errs, what) -> dict:
    """K7 on a row-sparse ``table``'s adagrad slot at one batch's ids
    (``raw``, int32), as the update runs it: the ids deduplicated with seeded
    row gradients, against its plain version bit for bit, then timed (L2
    flushed) beside the plain version and ``index_add_``. Bound: the valid
    rows read, their gradients read and the rows written, 4 bytes an element,
    and 5 bytes an id (the id and its valid flag)."""
    from models_tpu_torch.ops import scatter as S

    D, N = table.table.shape[1], raw.shape[0]
    grads = torch.randn(N, D, device=dev, generator=gen)
    ids, gsum, valid = S.dedup_rows(raw, grads)
    acc = table.sparse_slots["acc"]
    got, want = S.row_scatter_add(acc.clone(), ids, gsum, valid), S.row_scatter_add_plain(
        acc.clone(), ids, gsum, valid)
    err = max_err(got, want)
    errs["row_scatter_add"] = max(errs["row_scatter_add"], err)
    require(torch.equal(raw_bits(got), raw_bits(want)),
            f"{what}: K7 on {table.block_name} differs from its plain version (max|d| {err})")
    del got, want
    work = acc.clone()
    n = int(valid.sum())
    ids_v, g_v = ids[valid].long(), gsum[valid]
    nbytes = 3 * n * D * 4 + N * 5
    k7 = {"table": table.block_name, "rows": table.table.shape[0], "ids": N, "valid_ids": n,
          "ms": device_ms(lambda: S.row_scatter_add(work, ids, gsum, valid), cold=True),
          "plain_ms": device_ms(lambda: S.row_scatter_add_plain(work, ids, gsum, valid), reps=10,
                                cold=True),
          "library_ms": device_ms(lambda: work.index_add_(0, ids_v, g_v), cold=True),
          "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
    print(f"  K7 on {table.block_name} ({table.table.shape[0]} rows), {n} of {N} ids: "
          f"bit-equal to its plain version; {json.dumps(k7)}", flush=True)
    return k7


# the bench's session cells (bench.py:657-676 `session`, :525-576
# `session_bucket`): the GPT2-style block at d_model 128, 8 heads, 2 layers,
# no dropout, the item table 128 wide, Adam at 1e-3 with no metrics
SESSION_BATCH = 1024
SESSION_BATCHES = 16
SESSION_SPE = 8
SESSION_CPU_STEPS = 4
# Adam card vs CPU after SESSION_CPU_STEPS steps: a rounding-noise gradient
# may step either way each step (ADAM_FLIP_ATOL's reasoning)
SESSION_ADAM_FLIP_ATOL = 2 * ADAM_LR * sum((t + 1) ** 0.5 for t in range(SESSION_CPU_STEPS))
# session_bucket's lengths, 16 batches of sessions each (bench.py:538-545)
BUCKET_LENGTHS = ((5, 8), (9, 16), (17, 32), (33, 64))
BUCKET_BATCHES = 16
BUCKET_SPE = 16
LONG_STEPS = 8


def session_model(dev, schema):
    import models_tpu_torch as mt
    from models_tpu_torch.transformer import GPT2Block

    return mt.SessionBasedTransformerModel(
        schema, transformer=GPT2Block(d_model=128, n_head=8, n_layer=2, dropout=0.0, seed=SEED),
        embedding_dim=128, seed=SEED, device=dev)


def session_pre(schema, kind="next"):
    from models_tpu_torch.transforms import SequencePredictLast, SequencePredictNext

    return (SequencePredictNext if kind == "next" else SequencePredictLast)(
        schema, target="item_id_seq")


def bucket_data():
    """session_bucket's data, drawn as bench.py:538-567 draws it: 16 batches
    of 1024 sessions of each length range (5-8, 9-16, 17-32, 33-64),
    shuffled, item ids uniform in 1..9999, one list column ``item_id_seq``
    of at most 64 positions over 10,000 items."""
    import models_tpu_torch as mt
    from models_tpu_torch.schema import Schema, Tags, create_categorical_column

    rng = np.random.default_rng(11)
    per_group = BUCKET_BATCHES * SESSION_BATCH
    lengths = np.concatenate([rng.integers(lo, hi + 1, per_group) for lo, hi in BUCKET_LENGTHS])
    rng.shuffle(lengths)
    values = rng.integers(1, 10_000, int(lengths.sum())).astype(np.int32)
    schema = Schema([create_categorical_column(
        "item_id_seq", 10_000, tags=(Tags.ITEM, Tags.ITEM_ID, Tags.SEQUENCE), is_list=True,
        max_seq_length=64)])
    rows = np.empty(len(lengths), dtype=object)
    rows[:] = np.split(values, np.cumsum(lengths)[:-1])
    return mt.Dataset({"item_id_seq": rows}, schema=schema)


def head_inputs(model, x, dev, pre):
    """The fused head's operands for one loader batch, as the training step
    forms them: the flattened (B*L, D) queries, the positives' rows of the
    tied table (also the in-batch negatives), their ids, the prediction mask
    as weights, and the valid rows' pinned bias (0)."""
    from models_tpu_torch.core.types import ModelContext, to_device_batch

    xb = to_device_batch(x, dev)
    xp, yp = model._apply_pre(pre, xb, None, training=True)
    with torch.no_grad():
        ctx = ModelContext(features=xp, targets=yp)
        hidden = model._query(xp, training=True, context=ctx)
        q, pos, w = model.contrastive_output._query_and_positive(hidden, ctx, yp)
    q, neg = q.contiguous(), pos.embedding.contiguous()
    ids = pos.id.to(torch.int32).contiguous()
    pos_logit = (q * neg).sum(1).contiguous()
    return (q, pos_logit, neg, ids, ids, torch.zeros(neg.shape[0], device=dev),
            w.contiguous()), (xp, yp)


def phase_session(dev, card):
    """The bench's ``session`` cell (sequence-testing, its session length L
    = 4, batch 1024, SESSION_BATCHES batches of seeded rows), trained
    next-item through ``fit(pre=SequencePredictNext)``: (a) one step at a
    time (K1-K3 once a step); (b) SESSION_SPE steps a chunk as CUDA graph
    replays, graph and eager bit for bit with deterministic algorithms on,
    then captured again without them, timed and traced (K1-K3 once a step,
    K9 once a chunk, counted in the trace); (c) the card against a CPU copy
    after SESSION_CPU_STEPS Adam steps (losses within FCE_TOL, parameters
    within PARAM_ATOL but for rounding-noise elements, SESSION_ADAM_FLIP_ATOL);
    (d) ``evaluate(pre=SequencePredictLast)`` against the CPU copy's (loss
    within FCE_TOL, metrics within METRIC_ATOL); (e) ``predict`` at 1024
    sessions: full-catalog scores (1024, 4, 101), finite, within FCE_TOL of
    the CPU's. Returns (the numbers, K1-K3's launches on the one-step
    route, the traced replays' launches)."""
    import copy

    import models_tpu_torch as mt

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    data = mt.generate_data("sequence-testing", num_rows=SESSION_BATCHES * SESSION_BATCH,
                            seed=SEED + 10)
    schema = data.schema
    pre = session_pre(schema)

    def make():
        return session_model(dev, schema)

    out = {"card": card, "config": {"block": "GPT2Block(d_model=128, n_head=8, n_layer=2)",
                                    "embedding_dim": 128, "batch": SESSION_BATCH,
                                    "schema": "sequence-testing", "max_seq_length": 4,
                                    "optimizer": "adam", "learning_rate": ADAM_LR,
                                    "data_s": time.perf_counter() - t_phase}}
    model = make()
    out["parameters"] = sum(p.numel() for p in model.parameters())
    model.compile(optimizer="adam", learning_rate=ADAM_LR, metrics=[])
    model.fit(data.take(2 * SESSION_BATCH), batch_size=SESSION_BATCH, shuffle=False, pre=pre,
              device=dev)
    zero_route_launches()
    t = time.perf_counter()
    hist = model.fit(data, batch_size=SESSION_BATCH, shuffle=False, pre=pre, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    one = route_launches()
    require(all(np.isfinite(hist.history["loss"])), f"(a): losses {hist.history['loss']}")
    require(all(one[n] == SESSION_BATCHES for n in ("lse_forward", "grad_query", "grad_neg")),
            f"(a): K1-K3 launched {one} in {SESSION_BATCHES} steps")
    out["one_step"] = {"ms_per_step": wall / SESSION_BATCHES * 1e3, "loss": hist.history["loss"],
                       "launches": one}
    print(f"  (a) session one step at a time: {out['one_step']['ms_per_step']:.3f} ms a step "
          f"(host clock), launches {one}; {card}", flush=True)
    del model

    what = f"(b) session, {SESSION_SPE} steps a chunk"
    _, mg, lg, le = graph_vs_eager(dev, None, data, 1, what, make=make, batch=SESSION_BATCH,
                                   pre=pre, optimizer="adam", learning_rate=ADAM_LR,
                                   metrics=[], steps_per_execution=SESSION_SPE)
    for n in ("lse_forward", "grad_query", "grad_neg"):
        require(lg[n] == 2 * SESSION_SPE and le[n] == SESSION_BATCHES,
                f"{what}: {n} issued {lg[n]} (graph) / {le[n]} (eager) times")
    require(lg["row_gather"] == 2, f"{what}: K9 issued {lg['row_gather']} times")
    mg._chunk_graphs.clear()  # captured again as users run it, deterministic algorithms off
    mg.fit(data, epochs=1, batch_size=SESSION_BATCH, shuffle=False, pre=pre, device=dev)
    hist, wall, ms = replayed_fit(mg, data, 2, 2 * SESSION_BATCHES, what,
                                  batch=SESSION_BATCH, pre=pre)
    require(all(np.isfinite(hist["loss"])), f"{what}: non-finite loss")
    want = {"row_gather": SESSION_BATCHES // SESSION_SPE, "lse_forward": SESSION_BATCHES,
            "grad_query": SESSION_BATCHES, "grad_neg": SESSION_BATCHES}
    trace = traced_replays(mg, data, SESSION_BATCHES, want, what, batch=SESSION_BATCH, pre=pre)
    out["graph"] = {"ms_per_step": ms, "examples_per_sec": hist["examples_per_sec"],
                    "fit_s": wall, "loss": hist["loss"], "graphs": graph_stats(mg),
                    "one_step_ms_ratio": ms / out["one_step"]["ms_per_step"],
                    **{k: v for k, v in trace.items() if k != "launches_issued"}}
    print(f"  {what}: {ms:.3f} ms a step graph-replayed, busy "
          f"{trace['device_busy_share']:.3f}, traced {trace['launches_traced']}; {card}",
          flush=True)
    del mg

    on_card = make()
    on_cpu = copy.deepcopy(on_card).to("cpu")
    losses = {}
    for tag, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
        m.compile(optimizer="adam", learning_rate=ADAM_LR, metrics=[])
        losses[tag] = m.fit(data.take(SESSION_CPU_STEPS * SESSION_BATCH),
                            batch_size=SESSION_BATCH, shuffle=False, pre=pre,
                            device=d).history["loss"]
    require(np.allclose(losses["card"], losses["cpu"], rtol=FCE_TOL, atol=0),
            f"(c) session: losses {losses['card']} (card) / {losses['cpu']} (CPU)")
    cpu = dict(on_cpu.named_parameters())
    worst, flips, total, largest = compare_rounded(
        "(c) session card vs CPU", [(p, cpu[n]) for n, p in on_card.named_parameters()],
        PARAM_ATOL, (SESSION_ADAM_FLIP_ATOL, 0.0))
    out["card_vs_cpu"] = {"steps": SESSION_CPU_STEPS, "loss_card": losses["card"],
                          "loss_cpu": losses["cpu"], "param_max_abs": worst, "flips": flips,
                          "of": total, "largest_flip": largest}
    print(f"  (c) session card vs CPU after {SESSION_CPU_STEPS} Adam steps: "
          f"{json.dumps(out['card_vs_cpu'])}", flush=True)

    last = session_pre(schema, "last")
    evaluation = data.take(4 * SESSION_BATCH)
    for m in (on_card, on_cpu):  # the head's default top-k metrics
        m.compile(optimizer="adam", learning_rate=ADAM_LR)
    got = on_card.evaluate(evaluation, batch_size=SESSION_BATCH, pre=last, device=dev)
    want = on_cpu.evaluate(evaluation, batch_size=SESSION_BATCH, pre=last, device="cpu")
    compare_eval("(d) session evaluate(pre=SequencePredictLast)", got, want,
                 evaluation.num_rows)
    request = data.take(SESSION_BATCH)
    scores = on_card.predict(request, batch_size=SESSION_BATCH, device=dev)
    ref = on_cpu.predict(request, batch_size=SESSION_BATCH, device="cpu")
    require(scores.shape == (SESSION_BATCH, 4, 101) and np.isfinite(scores).all(),
            f"(e): predict gave {scores.shape}")
    err = float(np.abs(scores - ref).max() / np.abs(ref).max())
    require(err <= FCE_TOL, f"(e): card and CPU scores differ by {err:.3g} of the largest")
    out["evaluate"] = {"card": got, "cpu": want, "rows": evaluation.num_rows}
    out["predict"] = {"rows": SESSION_BATCH, "shape": list(scores.shape), "rel_vs_cpu": err,
                      "ms": host_ms(lambda: on_card.predict(request, batch_size=SESSION_BATCH,
                                                            device=dev))}
    print(f"  (e) session predict at {SESSION_BATCH} sessions: {out['predict']}; {card}",
          flush=True)
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    return out, one, trace["launches_traced"]


def session_long_library(q, pos_logit, neg, pid, nid, bias, lse, gw) -> dict:
    """K1-K3's PyTorch yardsticks at Q = N = 65,536 (T = 1), each with its
    (Q, N) fp32 logits materialised once (17.2 GB) and worked in place: K1
    the masked ``q @ negᵀ`` and ``logsumexp`` (with the positive by
    ``logaddexp``); K2 / K3 the logits again, the coefficient ``gw ·
    exp(logit - lse)`` in place and ``coef @ neg`` / ``coefᵀ @ q``; beside
    them the two products alone on a kept coefficient. Where the card runs
    out of memory, the bytes asked for in place of the times."""
    from models_tpu_torch.core.constants import MIN_FLOAT

    def logits():
        x = q @ neg.T
        x.add_(bias[None, :])
        return x.masked_fill_(nid[None, :] == pid[:, None], MIN_FLOAT)

    def coef():
        return logits().sub_(lse[:, None]).exp_().mul_(gw[:, None])

    out = {name: {"library_ms": None} for name in ("lse_forward", "grad_query", "grad_neg")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        out["lse_forward"]["library_ms"] = cuda_ms(
            lambda: torch.logaddexp(torch.logsumexp(logits(), 1), pos_logit), reps=3, warmup=1)
        out["grad_query"]["library_ms"] = cuda_ms(lambda: coef() @ neg, reps=3, warmup=1)
        out["grad_neg"]["library_ms"] = cuda_ms(lambda: coef().T @ q, reps=3, warmup=1)
        kept = coef()
        out["grad_query"]["library_product_ms"] = cuda_ms(lambda: kept @ neg, reps=3, warmup=1)
        out["grad_neg"]["library_product_ms"] = cuda_ms(lambda: kept.T @ q, reps=3, warmup=1)
        del kept
        peak = torch.cuda.max_memory_allocated() / 1e9
        for v in out.values():
            v["library_peak_gb"] = peak
    except torch.OutOfMemoryError as e:
        for v in out.values():
            v["library_oom"] = str(e).splitlines()[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the phase's peak is its fit's
    return out


def phase_session_long(dev, gen, card, errs, data):
    """session_bucket's data with pad="max" (L = 64: Q = N = 65,536
    flattened positions a batch): K1, K2 and K3 once each against their
    plain versions on the head's real operands of the first batch (the
    prediction mask as weights, the shifted ids, downscoring), then timed
    there (their bounds: the logit product at 3xTF32, K2 / K3's gradient
    product as much again); LONG_STEPS steps one at a time (K1-K3 once a
    step), the step's time and the kernels' share of it; then, under
    ``mixed_bfloat16``, the fused head (``lse_wg``, ``grad_wg``) against the
    unfused head at the ``session`` size (loss within FCE_TOL, gradients
    within MIXED_HEAD_GRAD_TOL of the largest). Returns the numbers and the
    K1-K3 times at this size."""
    import models_tpu_torch as mt
    from models_tpu_torch.ops import flash_ce as F

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pre = session_pre(data.schema)
    long = data.take(LONG_STEPS * SESSION_BATCH)
    model = session_model(dev, data.schema)
    x, _ = next(iter(mt.Loader(long, SESSION_BATCH)))
    args, _ = head_inputs(model, x, dev, pre)
    q, pos_logit, neg, pid, nid, bias, w = args
    Q, D = q.shape
    N = neg.shape[0]
    require(Q == N == SESSION_BATCH * 64, f"session_long: Q={Q}, N={N}")
    out = {"card": card, "Q": Q, "N": N, "D": D, "weighted_rows": int((w > 0).sum())}
    check_fce(f"session_long Q=N={Q} D={D} prediction-mask weights, shifted ids", dev, args,
              1.0, errs)
    m, s = F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, 1.0, True)
    lse = (m + torch.log(s)).contiguous()
    gw = (w / w.sum()).contiguous()
    gargs = (q, neg, lse, gw, pid, nid, bias, 1.0, True)
    logit_flops = 2 * Q * N * D
    vec = 4 * (2 * Q + 2 * N)
    kernels_ms = {}
    for name, fn, plain, flops, nbytes in (
            ("lse_forward", lambda: F.lse_forward(q, pos_logit, neg, pid, nid, bias, 1.0, True),
             lambda: F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, 1.0, True),
             logit_flops, (Q + N) * D * 4 + vec + 2 * Q * 4),
            ("grad_query", lambda: F.grad_query(*gargs), lambda: F.grad_query_plain(*gargs),
             2 * logit_flops, (Q + N) * D * 4 + vec + 4 * Q + Q * D * 4),
            ("grad_neg", lambda: F.grad_neg(*gargs), lambda: F.grad_neg_plain(*gargs),
             2 * logit_flops, (Q + N) * D * 4 + vec + 4 * Q + N * D * 4)):
        ops_ms = flops / PEAK_3XTF32[0] * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        kernels_ms[name] = {
            "Q": Q, "N": N, "D": D, "ms": cuda_ms(fn, reps=3, warmup=1),
            "plain_ms": cuda_ms(plain, reps=1, warmup=1),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_peak": PEAK_3XTF32[1] if ops_ms >= bytes_ms else "HBM3"}
    for name, lib in session_long_library(q, pos_logit, neg, pid, nid, bias, lse, gw).items():
        kernels_ms[name].update(lib)
    del args, q, neg, gargs, m, s, lse
    print(f"  session_long kernels at Q = N = {Q}: {json.dumps(kernels_ms)}; {card}", flush=True)

    model.compile(optimizer="adam", learning_rate=ADAM_LR, metrics=[])
    model.fit(long.take(SESSION_BATCH), batch_size=SESSION_BATCH, shuffle=False, pre=pre,
              device=dev)
    zero_route_launches()
    t = time.perf_counter()
    hist = model.fit(long, batch_size=SESSION_BATCH, shuffle=False, pre=pre, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ln = route_launches()
    require(all(np.isfinite(hist.history["loss"])), f"session_long: {hist.history['loss']}")
    require(all(ln[n] == LONG_STEPS for n in ("lse_forward", "grad_query", "grad_neg")),
            f"session_long: K1-K3 launched {ln} in {LONG_STEPS} steps")
    step_ms = wall / LONG_STEPS * 1e3
    kernel_sum = sum(v["ms"] for v in kernels_ms.values())
    out.update(step_ms=step_ms, loss=hist.history["loss"], launches=ln,
               kernels_ms_per_step=kernel_sum, kernels_share_of_step=kernel_sum / step_ms,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"  session_long: {LONG_STEPS} steps one at a time at L = 64, {step_ms:.3f} ms a step "
          f"(host clock), K1-K3 {kernel_sum:.3f} ms of it ({kernel_sum / step_ms:.3f}); "
          f"{card}", flush=True)
    del model
    torch.cuda.empty_cache()

    sdata = mt.generate_data("sequence-testing", num_rows=SESSION_BATCH, seed=SEED + 10)
    mt.set_dtype_policy("mixed_bfloat16")
    try:
        mm = session_model(dev, sdata.schema)
        mm.compile(optimizer="adam", learning_rate=ADAM_LR, metrics=[])
        x, _ = next(iter(mt.Loader(sdata, SESSION_BATCH)))
        spre = session_pre(sdata.schema)
        args, (xp, yp) = head_inputs(mm, x, dev, spre)
        routes = (F.lse_route(args[0].to(torch.bfloat16), args[2].to(torch.bfloat16)),
                  F.grad_route(args[0].to(torch.bfloat16), args[2].to(torch.bfloat16)))
        require(routes == ("lse_wg", "grad_wg"), f"mixed session head: routes {routes}")
        zero_launches()
        loss_f, g_f = head_grads(mm, xp, yp, fused=True)
        bf16 = flash_launches_bf16()
        require(all(v == 1 for v in bf16.values()) and not any(flash_launches().values()),
                f"mixed session head: fused launches {bf16}, fp32 {flash_launches()}")
        loss_u, g_u = head_grads(mm, xp, yp, fused=False)
    finally:
        mt.set_dtype_policy("float32")
    largest = max(float(g.abs().max()) for g in g_u.values())
    worst = max(float((g_f[n] - g_u[n]).abs().max()) for n in g_u)
    loss_rel = abs(loss_f - loss_u) / abs(loss_u)
    require(loss_rel <= FCE_TOL, f"mixed session head: loss {loss_f} fused / {loss_u}")
    require(worst <= MIXED_HEAD_GRAD_TOL * largest,
            f"mixed session head: gradients {worst:.3g} apart of {largest:.3g}")
    out["mixed_head"] = {"routes": routes, "loss_rel": loss_rel, "grad_max_abs": worst,
                         "largest_grad": largest, "launches_bf16": bf16}
    print(f"  mixed_bfloat16 session head, fused (lse_wg, grad_wg) vs unfused: "
          f"{json.dumps(out['mixed_head'])}", flush=True)
    del mm
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, kernels_ms


def phase_session_bucket(dev, gen, card, errs, data):
    """The bench's ``session_bucket`` cell (bench.py:568-576): Loader(pad=
    "bucket", batch 1024, unshuffled), BUCKET_SPE steps a chunk: one packed
    matrix and one graph a bucket group (8, 16, 32, 64). A first fit runs
    each group's chunk eagerly (K9 once a group), a second of two epochs
    captures and replays them, a third is timed (sessions/s; no wrapper
    called), and a fourth traced (K1-K3 once a step, K9 once a group, busy
    share). Then each group's graph replayed alone (ms a step, sessions/s),
    and K9 on each group's pack at one chunk's ids, bit for bit against its
    plain version, timed warm and flushed beside ``index_select``. Returns
    the numbers, K9's launches and its per-group times."""
    import models_tpu_torch as mt
    from models_tpu_torch.ops import embedding_lookup as E

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pre = session_pre(data.schema)
    loader = mt.Loader(data, SESSION_BATCH, pad="bucket", drop_last=True, shuffle=False)
    model = session_model(dev, data.schema)
    model.compile(optimizer="adam", learning_rate=ADAM_LR, metrics=[],
                  train_metrics_steps=10_000, steps_per_execution=BUCKET_SPE)
    steps = len(BUCKET_LENGTHS) * BUCKET_BATCHES
    zero_route_launches()
    t = time.perf_counter()
    model.fit(loader, epochs=1, pre=pre, device=dev)
    torch.cuda.synchronize()
    out = {"card": card, "eager_fit_s": time.perf_counter() - t,
           "launches_eager": route_launches()}
    groups = data._device_bucket_groups
    require([b for b, _ in groups] == [8, 16, 32, 64] and all(
        g.n_rows == BUCKET_BATCHES * SESSION_BATCH for _, g in groups),
        f"session_bucket: groups {[(b, g.n_rows) for b, g in groups]}")
    require(out["launches_eager"]["row_gather"] == len(groups)
            and out["launches_eager"]["lse_forward"] == steps,
            f"session_bucket: eager launches {out['launches_eager']}")
    t = time.perf_counter()
    model.fit(loader, epochs=2, pre=pre, device=dev)
    torch.cuda.synchronize()
    out["capture_fit_s"] = time.perf_counter() - t
    require(sorted(model._group_graphs) == [8, 16, 32, 64]
            and all(len(g) == 1 for g in model._group_graphs.values()),
            f"session_bucket: graphs {[(b, len(g)) for b, g in model._group_graphs.items()]}")
    out["graphs"] = {b: list(g.stats.values()) for b, g in model._group_graphs.items()}
    zero_route_launches()
    t = time.perf_counter()
    hist = model.fit(loader, epochs=1, pre=pre)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    issued = route_launches()
    require(not any(issued.values()), f"session_bucket: eager launches on replays: {issued}")
    require(all(np.isfinite(hist.history["loss"])), f"session_bucket: {hist.history['loss']}")
    out.update(sessions_per_sec=steps * SESSION_BATCH / wall, ms_per_step=wall / steps * 1e3,
               loss=hist.history["loss"], examples_per_sec=hist.history["examples_per_sec"])
    want = {"row_gather": len(groups), "lse_forward": steps, "grad_query": steps,
            "grad_neg": steps}
    # a trace of 64 long steps loses a device event more often than the
    # other routes' short ones (on an H100, two traces of three came one K9
    # or two K1-K3 events short): more attempts, the same count required
    trace = profile_launches(lambda: model.fit(loader, epochs=1, pre=pre), steps, want,
                             "session_bucket", attempts=6)
    out.update({k: v for k, v in trace.items() if k != "launches_issued"})
    per_group = {}
    for bucket, graphs in model._group_graphs.items():
        (entry,) = [e for e in graphs._entries.values() if e.graph is not None]
        ms = cuda_ms(entry.graph.replay, reps=2, warmup=1)
        per_group[bucket] = {"ms_per_step": ms / BUCKET_SPE,
                             "sessions_per_sec": BUCKET_SPE * SESSION_BATCH / ms * 1e3}
    out["per_group"] = per_group
    print(f"  session_bucket: {out['sessions_per_sec']:.0f} sessions/s, "
          f"{out['ms_per_step']:.3f} ms a step (host clock), busy "
          f"{trace['device_busy_share']:.3f}; per group {json.dumps(per_group)}; {card}",
          flush=True)
    k9 = {}
    for bucket, gpack in groups:
        packed = gpack.packed
        B = BUCKET_SPE * SESSION_BATCH
        ids = torch.randperm(packed.shape[0], device=dev, generator=gen)[:B].to(torch.int32)
        gather_case(f"session pack bucket {bucket} R={packed.shape[0]} D={packed.shape[1]}",
                    packed, ids, errs)
        ids_l = ids.long()
        nbytes = 2 * B * packed.shape[1] * 4 + 4 * B
        k9[bucket] = {"rows": packed.shape[0], "row_bytes": packed.shape[1] * 4, "ids": B,
                      "ms": device_ms(lambda: E.row_gather(packed, ids)),
                      "ms_cold": device_ms(lambda: E.row_gather(packed, ids), cold=True),
                      "plain_ms": device_ms(lambda: E.row_gather_plain(packed, ids), cold=True),
                      "library_ms": device_ms(lambda: torch.index_select(packed, 0, ids_l),
                                              cold=True),
                      "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
        k9[bucket]["share_of_bound_cold"] = k9[bucket]["bound_ms"] / k9[bucket]["ms_cold"]
    out["k9"] = k9
    print("  row gather on the session packs " + json.dumps(k9), flush=True)
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del model
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, out["launches_eager"]["row_gather"], trace["launches_traced"], k9


# ---------------------------------------------------------------------------
# retrieval breadth: the matrix factorization with cross-batch negatives and
# YouTube-DNN, trained and served at full width
# ---------------------------------------------------------------------------

MF_BATCH = 4096  # the reference's tuned MF (BASELINE.md): dim 64, T 1.4, batch 4096, Adam 0.005
MF_DIM = 64
MF_QUEUE = 4096
MF_T = 1.4
MF_LR = 0.005
MF_STEPS = 16
MF_SPE = 8
MF_CPU_STEPS = 3
YT_SAMPLED = 100


def mf_model(dev, schema, table_dtype=None, **kw):
    """The matrix factorization of the slice's path: movielens-25m's 162,541
    users and 56,680 items, dim 64, T 1.4, ``["in-batch",
    CachedCrossBatchSampler(4096, 64)]`` negatives (Q = 4096, N = 8192)."""
    import models_tpu_torch as mt

    return mt.MatrixFactorizationModel(
        schema, dim=MF_DIM, logits_temperature=MF_T, table_dtype=table_dtype, seed=SEED,
        negative_samplers=["in-batch", mt.CachedCrossBatchSampler(MF_QUEUE, MF_DIM)],
        device=dev, **kw)


def mf_queue(model):
    return model.contrastive_output.samplers[1].queue


def fce_args_of(model, xb, T, samplers_ids=None):
    """The fused head's operands for one batch, as the training step forms
    them: the query rows, the positives' rows, the negatives (the in-batch
    positives, then the ring with its unfilled slots zeroed and pinned to
    MIN_FLOAT; or the sampled ids' rows with their logQ bias), ids, the
    positive logit (logQ on it where the head has one sampler that knows its
    probabilities) and the row weights."""
    from models_tpu_torch.core.constants import LOGQ_EPS, MIN_FLOAT
    from models_tpu_torch.core.types import ModelContext

    head = model.contrastive_output
    with torch.no_grad():
        q = model.query_encoder(xb, context=ModelContext(features=xb)).contiguous()
        pid = xb[head.item_id_name].to(torch.int32).contiguous()
        pos = head.table.embeddings[pid.long()]
        pos_logit = (q * pos).sum(1)
        if samplers_ids is None:  # ["in-batch", queue]
            snap = mf_queue(model).snapshot()
            neg = torch.cat([pos, torch.where(snap.valid[:, None], snap.embedding, 0.0)])
            nid = torch.cat([pid, snap.id])
            bias = torch.cat([torch.zeros_like(pos_logit),
                              torch.where(snap.valid, 0.0, MIN_FLOAT)])
        else:  # one popularity sampler: logQ on both sides
            sampler = head.samplers[0]
            nid = samplers_ids.to(torch.int32)
            neg = head.table.embeddings[nid.long()]
            bias = -torch.log(sampler.sampling_probs(nid, sampler.max_id) + LOGQ_EPS)
            pos_logit = pos_logit - torch.log(sampler.sampling_probs(pid, sampler.max_id)
                                              + LOGQ_EPS)
    return (q, (pos_logit / T).contiguous(), neg.contiguous(), pid, nid.contiguous(),
            bias.contiguous(), torch.ones_like(pos_logit))


def fce_shape_times(args, T) -> dict:
    """K1-K3 at one path's operands (fp32): device time back to back, the
    plain versions', the PyTorch calls' over the materialised logits, and
    the bound (3xTF32 products, or the bytes)."""
    from models_tpu_torch.core.constants import MIN_FLOAT
    from models_tpu_torch.ops import flash_ce as F

    q, pos_logit, neg, pid, nid, bias, w = args
    (Q, D), N = q.shape, neg.shape[0]
    m, s = F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, T, True)
    lse = (m + torch.log(s)).contiguous()
    gw = (w / w.sum()).contiguous()
    gargs = (q, neg, lse, gw, pid, nid, bias, T, True)

    def logits():
        return torch.where(nid[None, :] == pid[:, None], MIN_FLOAT, q @ neg.T + bias) / T

    def coef():
        return gw[:, None] * torch.exp(logits() - lse[:, None]) / T

    vec = 4 * (2 * Q + 2 * N)
    flops = 2 * Q * N * D
    out = {"Q": Q, "N": N, "D": D, "T": T}
    for name, fn, plain, lib, nbytes, f in (
            ("lse_forward", lambda: F.lse_forward(q, pos_logit, neg, pid, nid, bias, T, True),
             lambda: F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, T, True),
             lambda: torch.logsumexp(torch.cat([pos_logit[:, None], logits()], 1), 1),
             (Q + N) * D * 4 + vec + 2 * Q * 4, flops),
            ("grad_query", lambda: F.grad_query(*gargs), lambda: F.grad_query_plain(*gargs),
             lambda: coef() @ neg, (Q + N) * D * 4 + vec + 4 * Q + Q * D * 4, 2 * flops),
            ("grad_neg", lambda: F.grad_neg(*gargs), lambda: F.grad_neg_plain(*gargs),
             lambda: coef().T @ q, (Q + N) * D * 4 + vec + 4 * Q + N * D * 4, 2 * flops)):
        ops_ms = f / PEAK_3XTF32[0] * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"ms": cuda_ms(fn), "ms_cold": device_ms(fn, cold=True),
                     "plain_ms": cuda_ms(plain, reps=3), "library_ms": cuda_ms(lib, reps=3),
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    return out


def check_head_routes(dev, model, xb, what, errs, T, fce_args) -> dict:
    """The fused loss and its gradients against the unfused head's CE over
    the same step (every parameter's gradient within TRAIN_GRAD_TOL of the
    largest), and K1-K3 against their plain versions on the head's
    operands."""
    fused_loss, fused = head_grads(model, xb, None, fused=True)
    plain_loss, plain = head_grads(model, xb, None, fused=False)
    require(np.isfinite(fused_loss) and np.isfinite(plain_loss),
            f"{what}: losses {fused_loss} (fused) / {plain_loss} (unfused)")
    err = abs(fused_loss - plain_loss) / abs(plain_loss)
    require(err <= FCE_TOL, f"{what}: fused loss {fused_loss} vs unfused {plain_loss}")
    scale = max(float(g.abs().max()) for g in plain.values())
    worst = max(max_err(fused[n], plain[n]) for n in plain) / scale
    require(worst <= TRAIN_GRAD_TOL, f"{what}: fused vs unfused gradients off by {worst:.3g}")
    check_fce(what, dev, fce_args, T, errs)
    print(f"  {what}: fused loss {fused_loss:.7f} vs unfused {plain_loss:.7f} (rel {err:.3g}); "
          f"gradients off by {worst:.3g} of the largest", flush=True)
    return {"loss_fused": fused_loss, "loss_unfused": plain_loss, "loss_rel": err,
            "grad_rel": worst}


def serve_tied(dev, model, queries, what, sizes) -> dict:
    """``to_top_k_encoder(k=10)`` over the tied catalog (no candidates
    given): requests of each of ``sizes`` rows, each through the route the
    dispatch gives its shape (``topk_route``: binned, phase B in K5, while
    the binned pool holds; else streaming, K6) and against the plain route
    on the same query rows and index; the request's host-clock time. Both
    routes must serve, K4 once with each K5. Returns the numbers and K4's,
    K5's and K6's launches."""
    from models_tpu_torch.core.types import ModelContext, to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import topk as T

    t = time.perf_counter()
    enc = model.to_top_k_encoder(k=K, device=dev)
    torch.cuda.synchronize()
    bf = enc.blocks[-1].topk_layer
    catalog = model.contrastive_output.table.input_dim
    require(bf.n_valid == catalog, f"{what}: index of {bf.n_valid} rows, want {catalog}")
    out = {"index_ms": (time.perf_counter() - t) * 1e3, "catalog": list(bf.candidates.shape)}
    zero_topk_counts()
    for B in sizes:
        ds = queries.take(B)
        route = T.topk_route(B, bf.candidates.shape[0], bf.candidates.shape[1], K, on_cuda=True)
        out[f"route_B{B}"] = route
        before = T.streaming_topk.launches, T.binned_rescore.launches
        got = enc.predict(ds, batch_size=B, device=dev)
        ran = T.streaming_topk.launches > before[0], T.binned_rescore.launches > before[1]
        require(ran == (route == "streaming", route == "binned"),
                f"{what} B={B}: K6 / K5 ran {ran} on the {route} route")
        xb = to_device_batch(next(iter(Loader(ds, B)))[0], dev)
        with torch.no_grad():
            qv = model.query_encoder(xb, context=ModelContext(features=xb))
        want = T.streaming_topk_plain(qv, bf.candidates, K, ids=bf.ids, n_valid=bf.n_valid)
        check_topk(f"{what} serve B={B} vs plain",
                   (torch.as_tensor(got["scores"]), torch.as_tensor(got["ids"])), want)
    torch.cuda.synchronize()
    launches = topk_counts(f"{what} serving")
    require(all(launches.values()), f"{what}: the requests launched {launches}")
    for B in sizes:
        ds = queries.take(B)
        out[f"predict_B{B}_ms"] = host_ms(lambda: enc.predict(ds, batch_size=B, device=dev))
    return out, launches


def phase_retrieval(dev, card, errs):
    """Retrieval breadth at full width (movielens-25m, batch 4096):
    (a) the MF's fused head against the unfused one at T = 1.4 and 0.6, the
    ring empty (every one of its 4096 slots invalid) and full: loss, every
    gradient, and K1-K3 against their plain versions at Q = 4096, N = 8192,
    D = 64; (b) three adagrad steps, card vs a CPU copy, the ring, its ids
    and its cursor included; (c) 16 Adam steps one at a time (K1-K3 once a
    step), then 8 a chunk as CUDA graph replays, graph and eager bit for bit
    with deterministic algorithms on (the ring too), timed and traced (K1-K3
    once a step, K9 once a chunk); after each fit the ring holds the last
    batch's 4096 positives; (d) 16 row-sparse steps on bf16 tables (K7 and
    K8b on the user table and on the tied item table, each once a table a
    step; rows no batch looked up unchanged); (e) serving the tied catalog at
    B = 256 (K5) and 4096 (K6) against the plain route; (f) YouTube-DNN at
    its defaults (item dim 32, 100 popularity-sampled negatives, logQ on
    both sides): fused vs unfused with fixed draws, K1-K3 at Q = 4096, N =
    100, D = 32, 16 steps (K1-K3 once a step), serving at B = 256 (K5) and
    8192 (K6: at D = 32 the binned route holds 4096 rows); (g) ``loss="bpr"``
    with no metric: the logits route, K1-K3 never launched. Returns the
    numbers, each path's launches and K1-K3's times at the two shapes."""
    import models_tpu_torch as mt
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import scatter as S

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    data = mt.generate_data("movielens-25m", num_rows=MF_STEPS * MF_BATCH, seed=SEED + 20)
    schema = data.schema
    queries = data.take(8192)
    out = {"card": card, "config": {
        "model": "MatrixFactorizationModel", "dim": MF_DIM, "batch": MF_BATCH,
        "negative_samplers": ["in-batch", f"CachedCrossBatchSampler({MF_QUEUE}, {MF_DIM})"],
        "logits_temperature": MF_T, "optimizer": "adam", "learning_rate": MF_LR,
        "data_s": time.perf_counter() - t_phase}}
    launches, shapes = {}, {}
    xb = to_device_batch(next(iter(Loader(data, MF_BATCH)))[0], dev)
    last = torch.as_tensor(data.to_numpy_dict()["movieId"][-MF_BATCH:], device=dev)

    def ring_holds_the_last_batch(model, what):
        queue = mf_queue(model)
        require(torch.equal(queue.ids.long(), last.long()) and int(queue.cursor) == 0,
                f"{what}: the ring does not hold the last batch's positives")

    # (a) fused vs unfused, the ring empty and full
    model = mf_model(dev, schema)
    model.compile(optimizer="adam", learning_rate=MF_LR, metrics=[])
    head, queue = model.contrastive_output, mf_queue(model)
    out["heads"] = {}
    for fill in ("empty", "full"):
        if fill == "full":
            ids = torch.randint(0, head.table.input_dim, (MF_QUEUE,), device=dev,
                                dtype=torch.int32, generator=torch.Generator(dev).manual_seed(3))
            queue.enqueue(ids, head.table.embeddings[ids.long()])
        for T in (MF_T, 0.6):
            head.logits_scaler.temperature = T
            args = fce_args_of(model, xb, T)
            tag = f"(a) MF T={T} ring {fill}"
            out["heads"][f"T{T}_{fill}"] = check_head_routes(dev, model, xb, tag, errs, T, args)
            if fill == "empty" and T == MF_T:
                require(int((args[5] == args[5].min()).sum()) == MF_QUEUE,
                        "(a): the empty ring's slots are not pinned to MIN_FLOAT")
                shapes["mf"] = fce_shape_times(args, T)
    head.logits_scaler.temperature = MF_T
    del model

    # (b) card vs CPU, the ring included
    on_card, on_cpu, out["card_vs_cpu"] = card_vs_cpu(
        dev, lambda: mf_model(dev, schema), data, MF_CPU_STEPS, MF_BATCH, "(b) MF")
    for name in ("ids", "cursor"):
        require(torch.equal(getattr(mf_queue(on_card), name).cpu(),
                            getattr(mf_queue(on_cpu), name)), f"(b) MF: the ring's {name} differ")
    del on_card, on_cpu

    # (c) one step at a time, then graph-replayed
    model = mf_model(dev, schema)
    model.compile(optimizer="adam", learning_rate=MF_LR, metrics=[])
    model.fit(data.take(2 * MF_BATCH), batch_size=MF_BATCH, shuffle=False, device=dev)
    zero_route_launches()
    t = time.perf_counter()
    hist = model.fit(data, batch_size=MF_BATCH, shuffle=False, device=dev).history
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    one = route_launches()
    require(all(np.isfinite(hist["loss"])), f"(c) MF: losses {hist['loss']}")
    require(all(one[n] == MF_STEPS for n in ("lse_forward", "grad_query", "grad_neg"))
            and one["row_gather"] == 0, f"(c) MF: launches {one} in {MF_STEPS} steps")
    ring_holds_the_last_batch(model, "(c) MF one step at a time")
    launches["mf"] = one
    out["one_step"] = {"ms_per_step": wall / MF_STEPS * 1e3, "loss": hist["loss"],
                       "examples_per_sec": MF_BATCH * MF_STEPS / wall, "launches": one}
    print(f"  (c) MF one step at a time: {out['one_step']['ms_per_step']:.3f} ms a step "
          f"(host clock), launches {one}; {card}", flush=True)
    del model
    what = f"(c) MF, {MF_SPE} steps a chunk"
    _, mg, lg, le = graph_vs_eager(dev, None, data, 1, what, shuffle=False,
                                   make=lambda: mf_model(dev, schema), batch=MF_BATCH,
                                   optimizer="adam", learning_rate=MF_LR, metrics=[],
                                   steps_per_execution=MF_SPE)
    for n in ("lse_forward", "grad_query", "grad_neg"):
        require(lg[n] == 2 * MF_SPE and le[n] == MF_STEPS,
                f"{what}: {n} issued {lg[n]} (graph) / {le[n]} (eager) times")
    require(lg["row_gather"] == 2, f"{what}: K9 issued {lg['row_gather']} times")
    ring_holds_the_last_batch(mg, what)
    mg._chunk_graphs.clear()  # captured again as users run it, deterministic algorithms off
    mg.fit(data, epochs=1, batch_size=MF_BATCH, shuffle=False, device=dev)
    hist, wall, ms = replayed_fit(mg, data, 2, 2 * MF_STEPS, what, batch=MF_BATCH)
    require(all(np.isfinite(hist["loss"])), f"{what}: non-finite loss")
    ring_holds_the_last_batch(mg, f"{what}, replayed")
    want = {"row_gather": MF_STEPS // MF_SPE, "lse_forward": MF_STEPS,
            "grad_query": MF_STEPS, "grad_neg": MF_STEPS}
    trace = traced_replays(mg, data, MF_STEPS, want, what, batch=MF_BATCH)
    launches["mf_graph"] = {"issued": lg, "traced": trace["launches_traced"]}
    out["graph"] = {"ms_per_step": ms, "examples_per_sec": hist["examples_per_sec"],
                    "fit_s": wall, "loss": hist["loss"], "graphs": graph_stats(mg),
                    **{k: v for k, v in trace.items() if k != "launches_issued"}}
    print(f"  {what}: {ms:.3f} ms a step graph-replayed, busy "
          f"{trace['device_busy_share']:.3f}, traced {trace['launches_traced']}; {card}",
          flush=True)

    # (e) serving the tied catalog (the graph-trained model)
    out["serving"], launches["mf_serving"] = serve_tied(dev, mg, queries, "(e) MF", (256, 4096))
    print(f"  (e) MF serving: {json.dumps(out['serving'])}; {card}", flush=True)
    del mg

    # (d) row-sparse, bf16 tables
    model = compile_sparse(mf_model(dev, schema, table_dtype=torch.bfloat16))
    applied = {}
    apply = model._emb_opt.apply

    def counted(table, ids, grads, step):
        applied[table.block_name] = applied.get(table.block_name, 0) + 1
        return apply(table, ids, grads, step)

    model.fit(data.take(2 * MF_BATCH), batch_size=MF_BATCH, shuffle=False, device=dev)
    model._emb_opt.apply = counted
    tables = {t.block_name: t.table.detach().clone() for t in model._embedding_tables()}
    S.row_scatter_add.launches = S.row_scatter_write.launches = 0
    zero_route_launches()
    t = time.perf_counter()
    hist = model.fit(data, batch_size=MF_BATCH, shuffle=False, device=dev).history
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    sparse = {"row_scatter_add": S.row_scatter_add.launches,
              "row_scatter_write": S.row_scatter_write.launches, **flash_launches()}
    require(all(np.isfinite(hist["loss"])), f"(d) MF row-sparse: losses {hist['loss']}")
    require(applied == {"userId": MF_STEPS, "movieId": MF_STEPS},
            f"(d) MF row-sparse: updates by table {applied}")
    require(sparse["row_scatter_add"] == sparse["row_scatter_write"] == 2 * MF_STEPS,
            f"(d) MF row-sparse: launches {sparse}, want K7 and K8b once a table a step")
    seen = seen_ids(data, MF_BATCH)
    for t in model._embedding_tables():
        untouched = torch.ones(t.table.shape[0], dtype=torch.bool, device=dev)
        untouched[torch.as_tensor(seen[t.block_name], device=dev).long()] = False
        require(torch.equal(t.table.detach()[untouched], tables[t.block_name][untouched]),
                f"(d) MF row-sparse: {t.block_name} rows no batch looked up moved")
        require(t.table.dtype == torch.bfloat16, "(d): the table is no longer bf16")
    ring_holds_the_last_batch(model, "(d) MF row-sparse")
    launches["mf_sparse"] = sparse
    out["sparse_bf16"] = {"ms_per_step": wall / MF_STEPS * 1e3, "loss": hist["loss"],
                          "launches": sparse, "updates": applied}
    print(f"  (d) MF row-sparse bf16: {out['sparse_bf16']['ms_per_step']:.3f} ms a step, "
          f"launches {sparse}; {card}", flush=True)
    del model, tables

    # (g) bpr: the logits route
    model = mf_model(dev, schema)
    model.compile(optimizer="adam", learning_rate=MF_LR, loss="bpr", metrics=[])
    zero_route_launches()
    hist = model.fit(data.take(2 * MF_BATCH), batch_size=MF_BATCH, shuffle=False,
                     device=dev).history
    torch.cuda.synchronize()
    bpr = route_launches()
    require(not any(bpr.values()), f"(g) MF loss=bpr launched {bpr}")
    require(all(np.isfinite(hist["loss"])) and hist["loss"][0] < 1.0,
            f"(g) MF loss=bpr: losses {hist['loss']} (bpr starts near log 2)")
    out["bpr"] = {"loss": hist["loss"], "launches": bpr}
    print(f"  (g) MF loss=bpr, metrics=[]: loss {hist['loss']}, launches {bpr}", flush=True)
    del model

    # (f) YouTube-DNN
    yt = mt.YoutubeDNNRetrievalModel(schema, seed=SEED, device=dev)
    (sampler,) = yt.contrastive_output.samplers
    require(sampler.max_num_samples == YT_SAMPLED and yt.contrastive_output.table.dim == 32,
            "(f) YouTube-DNN defaults")
    yt.compile(optimizer="adam", learning_rate=MF_LR, metrics=[])
    fixed = sampler.sample_ids(YT_SAMPLED, sampler.max_id, dev)
    sampler.sample_ids = lambda n, max_id, device: fixed
    args = fce_args_of(yt, xb, 1.0, fixed)
    out["youtube_dnn"] = {"heads": check_head_routes(dev, yt, xb, "(f) YouTube-DNN, fixed draws",
                                                     errs, 1.0, args),
                          "parameters": sum(p.numel() for p in yt.parameters())}
    shapes["youtube_dnn"] = fce_shape_times(args, 1.0)
    del sampler.sample_ids  # its own draws again
    yt.fit(data.take(2 * MF_BATCH), batch_size=MF_BATCH, shuffle=False, device=dev)
    zero_route_launches()
    t = time.perf_counter()
    hist = yt.fit(data, batch_size=MF_BATCH, shuffle=False, device=dev).history
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ytl = route_launches()
    require(all(np.isfinite(hist["loss"])), f"(f) YouTube-DNN: losses {hist['loss']}")
    require(all(ytl[n] == MF_STEPS for n in ("lse_forward", "grad_query", "grad_neg")),
            f"(f) YouTube-DNN: launches {ytl} in {MF_STEPS} steps")
    launches["youtube_dnn"] = ytl
    out["youtube_dnn"].update(ms_per_step=wall / MF_STEPS * 1e3, loss=hist["loss"],
                              examples_per_sec=MF_BATCH * MF_STEPS / wall, launches=ytl)
    # at D = 32 the binned pool holds 4096 rows: 8192 take the streaming route
    out["youtube_dnn"]["serving"], launches["youtube_dnn_serving"] = serve_tied(
        dev, yt, queries, "(f) YouTube-DNN", (256, 8192))
    print(f"  (f) YouTube-DNN: {json.dumps(out['youtube_dnn'])}; {card}", flush=True)
    del yt
    out["shapes"] = shapes
    print("  K1-K3 at the new shapes " + json.dumps(shapes), flush=True)
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches, shapes


# ---------------------------------------------------------------------------
# multi-task ranking: MMOE and PLE on the full Ali-CCP schema, the V1
# prediction tasks, and the optimizers they train under
# ---------------------------------------------------------------------------

# examples/04_multi_task_mmoe.py's model and loss weights; PLE at the JAX
# package's defaults; examples/14_v1_prediction_tasks.py's V1 tasks. Adam at
# 1e-3, batch 2048, MT_BATCHES batches of seeded rows of the full schema
# (21 tables, 3,448,362 rows at D = 32: 441 MB of fp32 tables)
MT_BATCH = 2048
MT_BATCHES = 16
MT_SPE = 8
MT_CPU_STEPS = 4
MT_SPARSE_STEPS = 8
MT_LOSS_WEIGHTS = {"click/BinaryOutput": 1.0, "conversion/BinaryOutput": 0.5}
MT_CLASS_WEIGHT = {0: 1.0, 1: 4.0}
MMOE_KW = dict(expert_block=(64, 32), num_experts=4, embedding_dim=32)
PLE_KW = dict(expert_block=(64, 32), num_layers=2, num_task_experts=1, num_shared_experts=2,
              embedding_dim=32)
MT_SPARSE_THRESHOLD = 10_000
MT_OPTIMIZERS = ("adamw", "rmsprop", "lamb", "adafactor")
MT_OPT_STEPS = 2  # each further optimizer's steps, card vs CPU: the second loss sees the update
# card vs CPU flips in one parameter: at most 1% of its moved elements or
# one row (a unit's weights, a table's row), whichever is more. A unit at a
# ReLU's kink on one device and not the other changes its row of the next
# gradient: 4 Adam steps flipped 313 of the 42,963 moved elements of an
# expert's first kernel (0.73%, about half a 672-wide row), 10 of the user
# profile table's 3164 (0.32%); at most 6e-4 elsewhere and 4.5e-4 of all
# that moved (H100 80GB HBM3, 700 W). A lamb whose trust ratio is 1% off
# flips 82% of the item table's moved elements, 10.9% of all that moved
MT_FLIP_PARAM_SHARE = 0.01


def adam_step_bound(t: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The most Adam's bias-corrected direction ``mu_hat / sqrt(nu_hat)``
    can be in magnitude at its t-th step, whatever the gradients
    (Cauchy-Schwarz over the moments' weights): 1.0 at t = 1, 1.0068 at 4."""
    s = sum(((1 - b1) * b1 ** (t - k)) ** 2 / ((1 - b2) * b2 ** (t - k)) for k in range(1, t + 1))
    return s ** 0.5 * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)


def noise_step(name: str, steps: int, before: torch.Tensor, after: torch.Tensor,
               lr: float = ADAM_LR) -> float:
    """The most ``steps`` steps of optimizer ``name`` at ``lr`` can move one
    element of a parameter, whatever its gradients: the move of an element
    whose gradient is rounding noise, which the card and the CPU may take
    with opposite signs (``before`` and ``after``: the parameter on the CPU
    around the steps). adam and adamw: adam_step_bound a step (adamw's decay,
    1e-4 of the parameter, is the same on both); rmsprop: 1 / sqrt(1 - 0.9)
    a step; adafactor: t**0.4 a step (its decay 1 - t**-0.8 keeps that share
    of the squared gradient), times the parameter's RMS (at least 1e-3);
    lamb: its step is the trust ratio |p| / |u| times Adam's direction, and
    the ratio is the parameter's own, so the unit is the largest move on the
    CPU, a step where Adam's direction is 1, times adam_step_bound; adagrad:
    1 a step (its accumulator holds the gradient's square)."""
    ts = range(1, steps + 1)
    if name in ("adam", "adamw"):
        return lr * sum(adam_step_bound(t) for t in ts)
    if name == "adagrad":
        return lr * steps
    if name == "rmsprop":
        return lr * steps / (1 - 0.9) ** 0.5
    if name == "adafactor":
        rms = max(float(x.float().pow(2).mean().sqrt()) for x in (before, after))
        return lr * max(rms, 1e-3) * sum(t ** 0.4 for t in ts)
    if name == "lamb":
        return float((after - before).abs().max()) * max(adam_step_bound(t) for t in ts)
    raise ValueError(name)


def mt_compile(model, **kw):
    args = dict(optimizer="adam", learning_rate=ADAM_LR, metrics=[],
                loss_weights=MT_LOSS_WEIGHTS)
    args.update(kw)
    return model.compile(**args)


def v1_model(dev, schema):
    """examples/14_v1_prediction_tasks.py: an MLP of 64, 32 over the input
    block; ``PredictionTasks`` with one tower of 16 cloned a task, a bias
    tower of 8, task weights 1 and 0.5."""
    import models_tpu_torch as mt
    from models_tpu_torch.core import SequentialBlock

    inputs = mt.InputBlockV2(schema, seed=SEED, device=dev)
    body = SequentialBlock([inputs, mt.MLPBlock([64, 32], seed=SEED,
                                                in_features=inputs.out_features, device=dev)])
    tasks = mt.PredictionTasks(schema, task_blocks=mt.MLPBlock([16], in_features=32, device=dev),
                               task_weight_dict={"click": 1.0, "conversion": 0.5},
                               bias_block=mt.MLPBlock([8], in_features=32, device=dev),
                               in_features=32, device=dev)
    return mt.Model(body, tasks, schema=schema)


def rows_of(data, start: int, n: int):
    """Rows [start, start + n) of ``data``, as a dataset."""
    from models_tpu_torch.data.dataset import take_rows

    return data._from_cols(take_rows(data._cols, np.arange(start, start + n)))


def step_card_vs_cpu(model, on_cpu, data, steps, what, optimizer, lr=ADAM_LR, batch=MT_BATCH):
    """``steps`` steps of the compiled ``model`` on the card and of its
    compiled CPU copy, one batch a ``fit`` so that each step's loss is read:
    every loss within FCE_TOL (from the second on, the updates enter them).
    Parameters within PARAM_ATOL but for flips, elements whose gradient is
    rounding noise, which the two may step either way: each within twice
    noise_step. In each parameter at most MT_FLIP_PARAM_SHARE of the
    elements that moved on the CPU by more than PARAM_ATOL or one row,
    whichever is more, and at most FLIP_SHARE_MAX of all the moved
    elements."""
    cpu_before = {n: p.detach().clone() for n, p in on_cpu.named_parameters()}
    losses = {"card": [], "cpu": []}
    dev = next(model.parameters()).device
    for s in range(steps):
        rows = rows_of(data, s * batch, batch)
        for tag, m, d in (("card", model, dev), ("cpu", on_cpu, "cpu")):
            losses[tag] += m.fit(rows, batch_size=batch, shuffle=False,
                                 device=d).history["loss"]
    require(all(np.isfinite(losses["card"])), f"{what}: losses {losses['card']}")
    require(np.allclose(losses["card"], losses["cpu"], rtol=FCE_TOL, atol=0),
            f"{what}: losses {losses['card']} (card) / {losses['cpu']} (CPU)")
    cpu = dict(on_cpu.named_parameters())
    worst, flips, moved, largest, by_param = 0.0, 0, 0, 0.0, {}
    for n, p in model.named_parameters():
        after = cpu[n].detach()
        moved_here = int(((after - cpu_before[n]).abs() > PARAM_ATOL).sum())
        bound = 2 * noise_step(optimizer, steps, cpu_before[n], after, lr)
        w, f, _, big = compare_rounded(f"{what}: {n}", [(p, after)], PARAM_ATOL,
                                       (max(bound, PARAM_ATOL), 0.0), share_of=math.inf)
        allowed = max(p.numel() // p.shape[0], MT_FLIP_PARAM_SHARE * moved_here)
        require(f <= allowed, f"{what}: {n}: {f} elements flipped, of {moved_here} moved "
                f"(at most {allowed:g})")
        worst, flips, moved, largest = max(worst, w), flips + f, moved + moved_here, max(
            largest, big)
        if f:
            by_param[n] = [f, moved_here]
    require(flips <= FLIP_SHARE_MAX * moved, f"{what}: {flips} elements flipped, of {moved} "
            "moved")
    out = {"steps": steps, "loss_card": losses["card"], "loss_cpu": losses["cpu"],
           "param_max_abs": worst, "flips": flips, "of_moved": moved, "largest_flip": largest,
           "flips_by_parameter": by_param}
    print(f"  {what}: {json.dumps(out)}", flush=True)
    return out


def phase_multi_task(dev, gen, card, errs):
    """Multi-task ranking on the full Ali-CCP schema (MT_BATCHES batches of
    MT_BATCH seeded rows): (a) the MMOE (MMOE_KW, adam, loss weights) one
    step at a time, timed as the two-tower steps are; (b) MT_SPE steps a
    chunk as CUDA graph replays: graph and eager bit for bit with
    deterministic algorithms on, then captured again without them, a timed
    fit and a traced epoch (K9 once a chunk on the 23-column pack); (c)
    row-sparse, adagrad at 0.05 on the tables of more than
    MT_SPARSE_THRESHOLD rows (user_id, item_id, user_intentions: K7 twice a
    table a step), timed; (d) card vs CPU after MT_CPU_STEPS Adam steps
    with loss weights and ``class_weight``, then ``evaluate`` (both tasks'
    AUC, precision, recall) and ``predict`` at 2048 rows against the CPU
    copy's; (e) MT_OPT_STEPS steps of each of adamw, rmsprop, lamb and
    adafactor, card vs CPU, then 4 steps of each, 2 a chunk, the second
    chunk a graph replay; (f) frozen experts bit-unchanged by a fit while the gates
    move; (g) PLE (PLE_KW) one step at a time and graph-replayed (K9
    traced); (h) the V1 prediction tasks one step at a time. K9 on the
    route's 23-column pack and K7 on item_id's slot at one batch's ids are
    held against their plain versions, bit for bit, and timed (measure_pack,
    measure_k7). Returns (the numbers, the launches by path, K9's and K7's
    times at these shapes)."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.ops import scatter as S

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    data = mt.generate_data("aliccp", num_rows=MT_BATCHES * MT_BATCH, seed=SEED + 19)
    schema = data.schema
    out = {"card": card, "config": {"mmoe": {k: list(v) if isinstance(v, tuple) else v
                                             for k, v in MMOE_KW.items()},
                                    "ple": {k: list(v) if isinstance(v, tuple) else v
                                            for k, v in PLE_KW.items()},
                                    "batch": MT_BATCH, "schema": "aliccp",
                                    "loss_weights": MT_LOSS_WEIGHTS,
                                    "optimizer": "adam", "learning_rate": ADAM_LR,
                                    "data_s": time.perf_counter() - t_phase}}
    launches = {}

    def make():
        return mt.MMOEModel(schema, seed=SEED, device=dev, **MMOE_KW)

    def make_ple():
        return mt.PLEModel(schema, seed=SEED, device=dev, **PLE_KW)

    # (a) one step at a time
    model = make()
    out["parameters"] = sum(p.numel() for p in model.parameters())
    out["table_rows"] = sum(t.table.shape[0] for t in model._embedding_tables())
    mt_compile(model)
    warm = model.fit(data.take(2 * MT_BATCH), batch_size=MT_BATCH, shuffle=False, device=dev)
    require(all(np.isfinite(warm.history["loss"])), "(a) MMOE: non-finite loss")
    out["mmoe_one_step"] = {**train_times(dev, model, data, batch=MT_BATCH),
                            **train_profile(dev, model, data, batch=MT_BATCH)}
    one = out["mmoe_one_step"]
    print(f"  (a) MMOE one step at a time: {one['step_ms']} ms, busy "
          f"{one['device_busy_share']:.3f}, device {one['device_ms_per_step']:.3f} ms a step, "
          f"optimizer {one['optimizer_ms']:.3f} ms; {card}", flush=True)
    del model

    # (b) the graph route
    what = f"(b) MMOE, {MT_SPE} steps a chunk"
    _, mg, lg, le = graph_vs_eager(dev, None, data, 2, what, make=make, batch=MT_BATCH,
                                   optimizer="adam", learning_rate=ADAM_LR, metrics=[],
                                   loss_weights=MT_LOSS_WEIGHTS, steps_per_execution=MT_SPE)
    require(lg["row_gather"] == 2 and le["row_gather"] == 2 * MT_BATCHES // MT_SPE,
            f"{what}: K9 issued {lg['row_gather']} (graph) / {le['row_gather']} (eager)")
    pack = data._device_train_pack
    require(pack is not None and tuple(pack.packed.shape) == (MT_BATCHES * MT_BATCH, 23),
            f"{what}: the pack is {None if pack is None else tuple(pack.packed.shape)}")
    # K9 at a chunk's ids on the pack: 92-byte rows, so 4-byte pieces
    k9 = measure_pack(dev, gen, pack.packed, MT_SPE * MT_BATCH, "aliccp pack", 4, errs)
    mg._chunk_graphs.clear()  # captured again as users run it, deterministic algorithms off
    mg.fit(data, epochs=1, batch_size=MT_BATCH, shuffle=False, device=dev)
    hist, wall, ms = replayed_fit(mg, data, 2, 2 * MT_BATCHES, what, batch=MT_BATCH)
    require(all(np.isfinite(hist["loss"])), f"{what}: non-finite loss")
    trace = traced_replays(mg, data, MT_BATCHES, {"row_gather": MT_BATCHES // MT_SPE}, what,
                           batch=MT_BATCH)
    out["mmoe_graph"] = {"ms_per_step": ms, "examples_per_sec": hist["examples_per_sec"],
                         "fit_s": wall, "loss": hist["loss"], "graphs": graph_stats(mg),
                         "one_step_ms_ratio": ms / one["step_ms"][0],
                         "foreach_share_of_device": trace["foreach_ms_per_step"]
                         / max(trace["device_ms_per_step"], 1e-12),
                         **{k: v for k, v in trace.items() if k != "launches_issued"}}
    launches["mmoe_graph"] = {"issued": lg["row_gather"], "eager": le["row_gather"],
                              "traced": trace["launches_traced"]["row_gather"]}
    print(f"  {what}: {ms:.3f} ms a step graph-replayed, examples/s {hist['examples_per_sec']}, "
          f"busy {trace['device_busy_share']:.3f}, device {trace['device_ms_per_step']:.3f} ms "
          f"a step, foreach (dense Adam) {trace['foreach_ms_per_step']:.3f} ms, K9 traced "
          f"{trace['launches_traced']['row_gather']}; {card}", flush=True)
    del mg
    torch.cuda.empty_cache()

    # (c) row-sparse
    model = make()
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[],
                  loss_weights=MT_LOSS_WEIGHTS, embedding_optimizer="adagrad",
                  sparse_threshold=MT_SPARSE_THRESHOLD)
    before = {t.block_name: t.table.detach().clone() for t in model._embedding_tables()}
    S.row_scatter_add.launches = S.row_scatter_write.launches = 0
    hist = model.fit(data.take(MT_SPARSE_STEPS * MT_BATCH), batch_size=MT_BATCH,
                     shuffle=False, device=dev)
    torch.cuda.synchronize()
    routed = sorted(t.block_name for t in model._sparse_tables)
    k7 = S.row_scatter_add.launches
    require(routed == ["item_id", "user_id", "user_intentions"], f"(c): routed {routed}")
    # the dense adagrad's tables (at most 10,000 x 32) are too small for the
    # row route (ROW_ROUTE_MIN_ELEMENTS): no K8a
    rows = routed_tables(model)
    require(not rows, f"(c): the row route steps {rows}")
    require(k7 == 2 * len(routed) * MT_SPARSE_STEPS and S.row_scatter_write.launches == 0,
            f"(c): K7 launched {k7} times, K8 {S.row_scatter_write.launches} in "
            f"{MT_SPARSE_STEPS} steps")
    require(all(np.isfinite(hist.history["loss"])), "(c): non-finite loss")
    require(all(not torch.equal(before[n], model._embedding_tables()[i].table)
                for i, n in enumerate(before)), "(c): a table did not move")
    launches["mmoe_sparse"] = k7
    x0, _ = next(iter(mt.Loader(data, MT_BATCH)))
    item = next(t for t in model._sparse_tables if t.block_name == "item_id")
    k7_times = measure_k7(dev, gen, item, torch.as_tensor(x0[item.features[0]], device=dev).to(
        torch.int32), errs, "(c) MMOE row-sparse")
    out["mmoe_sparse"] = {"routed": routed, "k7_launches": k7, "loss": hist.history["loss"],
                          **train_times(dev, model, data, batch=MT_BATCH)}
    print(f"  (c) MMOE row-sparse: routed {routed}, K7 {k7} in {MT_SPARSE_STEPS} steps, "
          f"{out['mmoe_sparse']['step_ms']} ms a step; {card}", flush=True)
    del model, before
    torch.cuda.empty_cache()

    # (d) card vs CPU with class weights, evaluate, predict
    on_card = make()
    on_cpu = copy.deepcopy(on_card).to("cpu")
    for m in (on_card, on_cpu):
        mt_compile(m, class_weight=MT_CLASS_WEIGHT)
    out["card_vs_cpu"] = step_card_vs_cpu(on_card, on_cpu, data, MT_CPU_STEPS,
                                          "(d) MMOE card vs CPU, adam, class weights", "adam")
    evaluation = data.take(MT_BATCH)
    for m in (on_card, on_cpu):  # the binary heads' default metrics
        mt_compile(m, metrics=None)
    got = on_card.evaluate(evaluation, batch_size=MT_BATCH, device=dev)
    want = on_cpu.evaluate(evaluation, batch_size=MT_BATCH, device="cpu")
    require({"click/auc", "conversion/auc", "click/precision", "conversion/recall"}
            <= set(got), f"(d): evaluate's keys {sorted(got)}")
    compare_eval("(d) MMOE evaluate", got, want, MT_BATCH)
    t = time.perf_counter()
    on_card.evaluate(evaluation, batch_size=MT_BATCH, device=dev)
    torch.cuda.synchronize()
    out["evaluate"] = {"card": got, "cpu": want, "rows": evaluation.num_rows,
                       "examples_per_sec": evaluation.num_rows / (time.perf_counter() - t)}
    probs = on_card.predict(evaluation, batch_size=MT_BATCH, device=dev)
    ref = on_cpu.predict(evaluation, batch_size=MT_BATCH, device="cpu")
    require(sorted(probs) == sorted(MT_LOSS_WEIGHTS) and all(
        v.shape == (MT_BATCH,) and np.isfinite(v).all() and ((v >= 0) & (v <= 1)).all()
        for v in probs.values()), "(d): predict's probabilities")
    err = max(float(np.abs(probs[k] - ref[k]).max()) for k in probs)
    require(err <= FCE_TOL, f"(d): card and CPU probabilities differ by {err:.3g}")
    out["predict"] = {"rows": MT_BATCH, "max_abs_vs_cpu": err,
                      "ms": host_ms(lambda: on_card.predict(evaluation, batch_size=MT_BATCH,
                                                            device=dev))}
    print(f"  (d) evaluate {got['click/auc']:.4f} / {got['conversion/auc']:.4f} AUC, "
          f"{out['evaluate']['examples_per_sec']:.0f} examples/s; predict at {MT_BATCH} rows "
          f"{out['predict']['ms']} ms, within {err:.3g} of the CPU's", flush=True)
    del on_card, on_cpu

    # (e) each further optimizer, one step, card vs CPU
    out["optimizers"] = {}
    base = make()
    for name in MT_OPTIMIZERS:
        on_card = copy.deepcopy(base)
        on_cpu = copy.deepcopy(base).to("cpu")
        for m in (on_card, on_cpu):
            mt_compile(m, optimizer=name)
        out["optimizers"][name] = step_card_vs_cpu(on_card, on_cpu, data, MT_OPT_STEPS,
                                                   f"(e) MMOE {name} card vs CPU", name)
        require(type(on_card._optimizer).__name__.lower() == name,
                f"(e): {name} ran as {type(on_card._optimizer).__name__}")
        # captured: 2 steps a chunk, the second chunk one graph replay
        mt_compile(on_card, optimizer=name, steps_per_execution=2)
        hist = on_card.fit(data.take(4 * MT_BATCH), batch_size=MT_BATCH, shuffle=False,
                           device=dev)
        require(len(on_card._chunk_graphs) == 1 and all(np.isfinite(hist.history["loss"]))
                and all(int(st["step"]) == 4 for st in on_card._optimizer.state.values()),
                f"(e) {name}: the captured chunk ({len(on_card._chunk_graphs)} graphs, "
                f"losses {hist.history['loss']})")
        out["optimizers"][name]["captured_loss"] = hist.history["loss"]
        del on_card, on_cpu
    del base
    torch.cuda.empty_cache()

    # (f) frozen experts
    model = make()
    mt_compile(model)
    experts = model.blocks[0].layers[1].experts
    model.freeze_blocks(experts)
    frozen = [p.detach().clone() for p in experts.parameters()]
    gates = [p.detach().clone() for p in model.blocks[0].layers[1].gates.parameters()]
    model.fit(data.take(MT_CPU_STEPS * MT_BATCH), batch_size=MT_BATCH, shuffle=False,
              device=dev)
    require(all(torch.equal(a, b) for a, b in zip(frozen, experts.parameters())),
            "(f): a frozen expert moved")
    require(all(not torch.equal(a, b) for a, b in
                zip(gates, model.blocks[0].layers[1].gates.parameters())),
            "(f): a gate did not move")
    require(not {id(p) for p in experts.parameters()} & {id(p) for p in model._optimizer.state},
            "(f): the optimizer holds a frozen expert's slots")
    out["frozen_experts"] = {"experts_unchanged": True, "gates_moved": True,
                             "frozen_parameters": sum(p.numel() for p in frozen)}
    print(f"  (f) frozen experts bit-unchanged over {MT_CPU_STEPS} steps, the gates moved",
          flush=True)
    del model
    torch.cuda.empty_cache()

    # (g) PLE: one step at a time, graph-replayed
    model = make_ple()
    out["ple_parameters"] = sum(p.numel() for p in model.parameters())
    mt_compile(model)
    model.fit(data.take(2 * MT_BATCH), batch_size=MT_BATCH, shuffle=False, device=dev)
    out["ple_one_step"] = train_times(dev, model, data, batch=MT_BATCH)
    mt_compile(model, steps_per_execution=MT_SPE)
    zero_route_launches()
    model.fit(data, epochs=1, batch_size=MT_BATCH, shuffle=False, device=dev)
    torch.cuda.synchronize()
    issued = route_launches()["row_gather"]
    require(issued == 2 and len(model._chunk_graphs) == 1,
            f"(g) PLE: K9 issued {issued} times, {len(model._chunk_graphs)} graphs")
    hist, wall, ms = replayed_fit(model, data, 2, 2 * MT_BATCHES, "(g) PLE", batch=MT_BATCH)
    require(all(np.isfinite(hist["loss"])), "(g) PLE: non-finite loss")
    trace = traced_replays(model, data, MT_BATCHES, {"row_gather": MT_BATCHES // MT_SPE},
                           "(g) PLE", batch=MT_BATCH)
    out["ple_graph"] = {"ms_per_step": ms, "examples_per_sec": hist["examples_per_sec"],
                        "loss": hist["loss"],
                        **{k: v for k, v in trace.items() if k != "launches_issued"}}
    launches["ple_graph"] = {"issued": issued, "traced": trace["launches_traced"]["row_gather"]}
    print(f"  (g) PLE: {out['ple_one_step']['step_ms']} ms a step one at a time, {ms:.3f} ms "
          f"graph-replayed, busy {trace['device_busy_share']:.3f}; {card}", flush=True)
    del model
    torch.cuda.empty_cache()

    # (h) the V1 prediction tasks
    model = v1_model(dev, schema)
    mt_compile(model, loss_weights=None)
    require(model._loss_weight_for("conversion/BinaryOutput") == 0.5,
            "(h): the task weight dict's weight")
    hist = model.fit(data.take(2 * MT_BATCH), batch_size=MT_BATCH, shuffle=False, device=dev)
    require(all(np.isfinite(hist.history["loss"])), "(h) V1 tasks: non-finite loss")
    out["v1_tasks_one_step"] = train_times(dev, model, data, batch=MT_BATCH)
    print(f"  (h) V1 prediction tasks: {out['v1_tasks_one_step']['step_ms']} ms a step; {card}",
          flush=True)
    del model
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches, k9, k7_times


# ---------------------------------------------------------------------------
# phase 20: the block DSL and the rest of the inputs: Wide&Deep on
# criteo-small, dynamic-vocabulary tables over full-Criteo raw ids,
# pretrained and frozen tables, tensor-train tables
# ---------------------------------------------------------------------------

WD_BATCHES = 16
WD_SPE = 8
WD_CPU_STEPS = 4
WD_DENSE_ROWS = 256  # the wide path's dense form: (256, 351,026) float32, 359 MB
ADAGRAD_LR = 0.05
DYN_STEPS = 16
DYN_DIM = 16
DAY2_STEPS = 2
EX17_BATCH, EX17_ROWS, EX17_SPE, EX17_CPU_STEPS = 512, 4096, 8, 4
PRE_STEPS, PRE_DIM = 8, 64
TT_THRESHOLD = 1_000_000


def wd_model(dev, schema):
    import models_tpu_torch as mt

    return mt.WideAndDeepModel(schema, seed=SEED, device=dev)


def eval_and_predict(dev, on_card, on_cpu, data, batch, what) -> dict:
    """``evaluate`` (the binary head's metrics) and ``predict`` on the card
    against the CPU copy, 8 batches and one."""
    evaluation = data.take(8 * batch)
    for m in (on_card, on_cpu):
        m.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR)
    got = on_card.evaluate(evaluation, batch_size=batch, device=dev)
    want = on_cpu.evaluate(evaluation, batch_size=batch, device="cpu")
    compare_eval(f"{what} evaluate", got, want, batch)
    request = data.take(batch)
    probs = on_card.predict(request, batch_size=batch, device=dev)
    ref = on_cpu.predict(request, batch_size=batch, device="cpu")
    require(probs.shape == (batch,) and np.isfinite(probs).all(), f"{what}: predict {probs.shape}")
    err = float(np.abs(probs - ref).max())
    require(err <= FCE_TOL, f"{what}: card and CPU probabilities differ by {err:.3g}")
    return {"evaluate": got, "evaluate_cpu": want, "predict_max_abs_vs_cpu": err,
            "predict_ms": host_ms(lambda: on_card.predict(request, batch_size=batch, device=dev))}


def phase_wide_and_deep(dev, gen, card, errs):
    """(a) Wide&Deep at its defaults on criteo-small (embedding_dim 32, deep
    (64, 32), 325 crosses x 1000 bins: the wide Dense over 351,026 inputs),
    batch 8192, adagrad 0.05: the wide path's gathered form against its
    dense form on WD_DENSE_ROWS rows; WD_BATCHES steps one at a time
    (timed, peak memory); WD_SPE steps a chunk as CUDA graph replays (graph
    and eager bit for bit with deterministic algorithms on, a timed fit, a
    traced epoch, K9 on the 40-column pack); row-sparse on the 26 deep
    tables (K7 twice a table a step); card vs CPU (step_card_vs_cpu) after
    WD_CPU_STEPS steps; ``evaluate`` and ``predict`` against the CPU copy.
    Returns (numbers, K9's launches on the graph route, traced, K9 on the
    pack, K7's launches row-sparsely, K7 on a deep table's slot)."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.ops import scatter as S

    t_phase = time.perf_counter()
    data = mt.generate_data("criteo-small", num_rows=WD_BATCHES * TRAIN_BATCH, seed=SEED + 20)

    def make():
        return wd_model(dev, data.schema)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    model = make()
    wide = model.blocks[0].branches["wide"]
    width = wide.linear.weight.shape[1]
    out = {"card": card, "config": {"embedding_dim": 32, "deep_block": [64, 32], "crosses": 325,
                                    "num_bins": 1000, "batch": TRAIN_BATCH,
                                    "schema": "criteo-small", "optimizer": "adagrad",
                                    "learning_rate": ADAGRAD_LR},
           "parameters": sum(p.numel() for p in model.parameters()), "wide_inputs": width,
           "dense_multi_hot_gb_at_batch": TRAIN_BATCH * width * 4 / 1e9}
    x, _ = next(iter(mt.Loader(data, WD_DENSE_ROWS)))
    xb = to_device_batch(x, dev)
    with torch.no_grad():
        gathered, dense = wide(xb), wide.dense_forward(xb)
    err = max_err(gathered, dense)
    require(gathered.shape == dense.shape == (WD_DENSE_ROWS, 1)
            and err <= FCE_TOL * max(1.0, float(dense.abs().max())),
            f"(a) the wide path's gathered and dense forms differ by {err:.3g}")
    out["wide_gathered_vs_dense_max_abs"] = err
    del dense, xb
    torch.cuda.empty_cache()
    model.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR, metrics=[])
    warm = model.fit(data.take(2 * TRAIN_BATCH), batch_size=TRAIN_BATCH, shuffle=False,
                     device=dev)
    require(all(np.isfinite(warm.history["loss"])), "(a): non-finite loss")
    out["one_step"] = {**train_times(dev, model, data), **train_profile(dev, model, data)}
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["peak_above_held_gb"] = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
    print(f"  (a) W&D: wide Dense over {width} inputs, gathered vs dense form {err:.3g}; one "
          f"step at a time {out['one_step']['step_ms']} ms, busy "
          f"{out['one_step']['device_busy_share']:.3f}, peak {out['peak_above_held_gb']:.2f} GB "
          f"above what earlier phases hold; {card}", flush=True)
    del model, wide

    _, mg, lg, le = graph_vs_eager(dev, None, data, 2, f"(a) W&D, {WD_SPE} steps a chunk",
                                   make=make, metrics=[], steps_per_execution=WD_SPE)
    # each of the 26 deep tables has fewer than 2 x 8192 rows: no row route
    require(lg["row_gather"] == 2 and le["row_gather"] == 2 * WD_BATCHES // WD_SPE
            and lg["row_scatter_write"] == le["row_scatter_write"] == 0
            and not routed_tables(mg),
            f"(a): K9 issued {lg['row_gather']} (graph) / {le['row_gather']} (eager) times, "
            f"the row route on {routed_tables(mg)}")
    pack = data._device_train_pack
    require(pack is not None and tuple(pack.packed.shape) == (WD_BATCHES * TRAIN_BATCH, 40),
            f"(a): the pack is {None if pack is None else tuple(pack.packed.shape)}")
    mg._chunk_graphs.clear()  # captured again as users run it, deterministic algorithms off
    mg.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    hist, wall, ms = replayed_fit(mg, data, 2, 2 * WD_BATCHES, "(a) W&D")
    require(all(np.isfinite(hist["loss"])), "(a): non-finite loss on the graph route")
    trace = traced_replays(mg, data, WD_BATCHES, {"row_gather": WD_BATCHES // WD_SPE},
                           "(a) W&D")
    out["graph"] = {"ms_per_step": ms, "examples_per_sec": hist["examples_per_sec"],
                    "fit_s": wall, "loss": hist["loss"], "graphs": graph_stats(mg),
                    **{k: v for k, v in trace.items() if k != "launches_issued"}}
    print(f"  (a) W&D graph route: {ms:.3f} ms a step, busy {trace['device_busy_share']:.3f}, "
          f"K9 traced {trace['launches_traced']['row_gather']} in {WD_BATCHES} replayed steps",
          flush=True)
    del mg
    k9 = measure_pack(dev, gen, pack.packed, WD_SPE * TRAIN_BATCH, "W&D pack", 16, errs)

    sm = make()
    sm.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR, embedding_optimizer="adagrad",
               metrics=[])
    S.row_scatter_add.launches = 0
    h = sm.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    torch.cuda.synchronize()
    k7_launches = S.row_scatter_add.launches
    n_sparse = len(sm._sparse_tables)
    require(n_sparse == 26 and k7_launches == 2 * n_sparse * WD_BATCHES,
            f"(a) row-sparse: {n_sparse} tables, K7 {k7_launches} launches in {WD_BATCHES} steps")
    require(all(np.isfinite(h.history["loss"])), "(a) row-sparse: non-finite loss")
    out["sparse"] = {"tables": n_sparse, "k7_launches": k7_launches, "loss": h.history["loss"],
                     **train_times(dev, sm, data)}
    print(f"  (a) W&D row-sparse on {n_sparse} deep tables: K7 {k7_launches} launches, step "
          f"{out['sparse']['step_ms']} ms", flush=True)
    x0, _ = next(iter(mt.Loader(data, TRAIN_BATCH)))
    table = sm._sparse_tables[0]
    k7 = measure_k7(dev, gen, table,
                    torch.as_tensor(x0[table.features[0]], device=dev).to(torch.int32), errs,
                    "W&D")
    del sm, table

    on_card = make()
    on_cpu = copy.deepcopy(on_card).to("cpu")
    for m in (on_card, on_cpu):
        m.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR, metrics=[])
    out["card_vs_cpu"] = step_card_vs_cpu(on_card, on_cpu, data, WD_CPU_STEPS,
                                          "(a) W&D card vs CPU", "adagrad", lr=ADAGRAD_LR,
                                          batch=TRAIN_BATCH)
    out.update(eval_and_predict(dev, on_card, on_cpu, data, TRAIN_BATCH, "(a) W&D"))
    del on_card, on_cpu
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, lg["row_gather"], trace["launches_traced"]["row_gather"], k9, k7_launches, k7


def criteo_raw(card: int, n: int, seed: int) -> np.ndarray:
    """examples/17's raw 31-bit ids, ``id * 2654435761 % 2**31``, over ids
    drawn from a domain of ``card`` with the data generator's skew."""
    return skewed_ids(n, card, seed).astype(np.int64) * 2654435761 % 2**31


def dynamic_model(dev, schema, target, **emb_kw):
    """examples/17's model: dynamic tables DYN_DIM wide, an MLP of 32, a
    binary head."""
    import models_tpu_torch as mt

    emb = mt.Embeddings(schema.categorical, dim=DYN_DIM, dynamic=True, seed=SEED, device=dev,
                        **emb_kw)
    return mt.Model(mt.SequentialBlock([mt.InputBlockV2(schema, categorical=emb, device=dev),
                                        mt.MLPBlock([32], seed=SEED)]),
                    mt.BinaryOutput(target), schema=schema)


def unplaced_ids(table, raw: torch.Tensor, keys: torch.Tensor, place):
    """Runs ``place(raw, keys)`` (one training call of the map, which
    writes its claims into ``keys``) and sorts the ids of ``raw`` that own
    no slot after it, from the probe windows as they were before it: an id
    whose whole window was taken (the overflow case: it takes the shared
    fallback slot), or an id outbid for the first empty slot of its window
    by a larger id of the same batch (the claim keeps the largest). Returns
    (slots, full-window ids, outbid ids, ids that own no slot for neither
    reason: none, unless the map is at fault)."""
    from models_tpu_torch.inputs.dynamic import EMPTY, _mix

    h = (_mix(raw) % table.capacity).long()
    pos = (h[:, None] + torch.arange(table.probes, device=raw.device)) % table.capacity
    window = keys[pos]
    matched = (window == raw[:, None]).any(1)
    empty = window == EMPTY
    full = ~matched & ~empty.any(1)
    cand = pos.gather(1, empty.to(torch.uint8).argmax(1, keepdim=True))[:, 0]
    slots = place(raw, keys)
    holder = keys[cand]
    lost = ~matched & ~full & (holder != raw)
    outbid = lost & (holder > raw) & torch.isin(holder, raw)
    return (slots, set(raw[full].tolist()), set(raw[outbid].tolist()),
            set(raw[lost & ~outbid].tolist()))


def phase_dynamic(dev, gen, card, errs):
    """(b) dynamic-vocabulary tables over full-Criteo raw ids: examples/17's
    model on the 26 Criteo categorical columns at their cardinalities (the
    default capacities: 39.3M rows, 2.52 GB fp32), raw 31-bit ids, batch
    8192, DYN_STEPS steps one at a time, row-sparse adagrad 0.05 on every
    table (K7 on the slots). Checks: each batch's slots and the key buffers
    bit-equal to a CPU replay of ``_map_ids`` over the same batches;
    every id the map leaves without a slot, at each batch, met a full probe
    window or was outbid for its window's first empty slot by a larger id of
    its batch (where a domain is nearly full, all its ids seen at the default
    capacity of cardinality / 0.8, some ids meet a full probe window and
    share the fallback slot, as the JAX package's map gives them; they are
    counted); ``evaluate`` leaves
    the keys; a second day of new ids allocates mid-fit; K7 bit for bit on
    the largest table's slot at one batch's slots. Then examples/17 itself
    (capacities 2048 and 1024, batch 512): a dense fit EX17_SPE steps a
    chunk as CUDA graph replays, keys and parameters bit-equal to the eager
    fit's; card vs CPU after EX17_CPU_STEPS Adam steps. Returns (numbers,
    K7's launches, K7 at the slot table, K9's launches on example 17's
    graph route)."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.data.synthetic import known_schema
    from models_tpu_torch.ops import scatter as S

    t_phase = time.perf_counter()
    full = known_schema("criteo")
    schema = mt.Schema(list(full.categorical) + list(full.targets))
    cards = {c.name: c.cardinality for c in full.categorical}
    n = DYN_STEPS * TRAIN_BATCH

    def day(seed_base, shift):
        cols = {name: criteo_raw(c, n, seed_base + i) + shift
                for i, (name, c) in enumerate(cards.items())}
        cols = {k: v % 2**31 for k, v in cols.items()}
        cols["label"] = (cols["C1"] % 2).astype(np.float32)
        return mt.Dataset(cols, schema=schema)

    day1 = day(SEED + 30, 0)
    gen_s = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    model = dynamic_model(dev, schema, "label")
    tables = [m for m in model.modules() if isinstance(m, mt.DynamicEmbeddingTable)]
    require(len(tables) == 26, f"(b): {len(tables)} dynamic tables")
    rows = sum(t.capacity for t in tables)
    recorded = {t.block_name: [] for t in tables}
    probe_ev = []

    def spy(table):
        orig = table._map_ids

        def mapped(raw, keys, training):
            if not training:
                return orig(raw, keys, training)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            slots = orig(raw, keys, training)
            ev[1].record()
            probe_ev.append(ev)
            recorded[table.block_name].append(slots.clone())
            return slots

        table._map_ids = mapped
        return orig

    origs = {t.block_name: spy(t) for t in tables}
    model.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR, embedding_optimizer="adagrad",
                  metrics=[])
    S.row_scatter_add.launches = 0
    t = time.perf_counter()
    hist = model.fit(day1, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    k7_launches = S.row_scatter_add.launches
    require(len(model._sparse_tables) == 26 and k7_launches == 2 * 26 * DYN_STEPS,
            f"(b): K7 launched {k7_launches} times in {DYN_STEPS} steps")
    require(all(np.isfinite(hist.history["loss"])), f"(b): losses {hist.history['loss']}")
    peak = torch.cuda.max_memory_allocated(dev)

    # the CPU replay of the map over the same batches, in the model's order.
    # Every id the map leaves without a slot at a sighting must have met a
    # full probe window (its domain nearly full: the default capacity is its
    # cardinality / 0.8) or been outbid by a larger id of its batch; an id
    # without a slot at the end is one of those at its last sighting
    keys = {tb.block_name: torch.full((tb.capacity,), -1, dtype=torch.int32) for tb in tables}
    seen = {tb.block_name: set() for tb in tables}
    overflowed = {tb.block_name: set() for tb in tables}
    outbid = {tb.block_name: set() for tb in tables}
    for step, (x, _) in enumerate(mt.Loader(day1, TRAIN_BATCH, drop_last=True)):
        for tb in tables:
            name = tb.block_name
            raw = torch.as_tensor(x[tb.features[0]]).to(torch.int32)
            slots, full_w, lost, unjustified = unplaced_ids(
                tb, raw, keys[name], lambda r, k, f=origs[name]: f(r, k, True))
            require(not unjustified,
                    f"(b): step {step}, {name}: {len(unjustified)} ids left without a slot "
                    "with a free slot in their window and no larger id claiming it")
            overflowed[name] |= full_w
            outbid[name] |= lost
            require(torch.equal(slots, recorded[name][step].cpu()),
                    f"(b): step {step}, {name}: the card's slots differ from the CPU replay's")
            seen[name].update(raw.tolist())
    by_table = {}
    for tb in tables:
        name = tb.block_name
        require(torch.equal(tb.hash_keys.cpu(), keys[name]),
                f"(b): {name}'s keys differ from the CPU replay's")
        owned = set(keys[name][keys[name] != -1].tolist())
        left = seen[name] - owned
        require(tb.num_allocated == len(owned) and owned <= seen[name],
                f"(b): {name} allocated {tb.num_allocated}, owned {len(owned)}")
        require(left <= overflowed[name] | outbid[name],
                f"(b): {name}: {len(left - overflowed[name] - outbid[name])} ids without a "
                "slot were never outbid and never met a full window")
        if left:
            by_table[name] = {"cardinality": cards[name], "capacity": tb.capacity,
                              "distinct": len(seen[name]), "without_slot": len(left),
                              "full_window": len(left & overflowed[name]),
                              "outbid": len(left - overflowed[name])}
    distinct = sum(len(v) for v in seen.values())
    allocated = sum(tb.num_allocated for tb in tables)
    without = sum(v["without_slot"] for v in by_table.values())
    full = sum(v["full_window"] for v in by_table.values())
    print(f"  (b) dynamic tables: {rows} rows in 26 tables, {allocated} of {distinct} distinct "
          f"ids allocated; {without} without a slot ({full} met a full probe window, the rest "
          f"were outbid in their batch): {json.dumps(by_table)}; slots and keys bit-equal to "
          f"the CPU replay; K7 {k7_launches} launches; fit {fit_s:.1f} s", flush=True)

    # the step's time and its probe-and-insert share (CUDA events)
    probe_ev.clear()
    times = train_times(dev, model, day1)
    torch.cuda.synchronize()
    n_steps = len(probe_ev) // 26
    probe_ms = sum(a.elapsed_time(b) for a, b in probe_ev) / max(n_steps, 1)
    out = {"card": card, "rows": rows, "table_gb": rows * DYN_DIM * 4 / 1e9,
           "hash_keys_mb": rows * 4 / 1e6, "slot_gb": rows * DYN_DIM * 4 / 1e9,
           "data_s": gen_s, "fit_s": fit_s, "loss": hist.history["loss"],
           "k7_launches": k7_launches, "distinct_ids": distinct, "allocated": allocated,
           "without_slot": without, "full_window": full, "without_slot_by_table": by_table,
           "max_memory_allocated_gb": peak / 1e9,
           "peak_above_held_gb": (peak - held) / 1e9, **times,
           "probe_insert_ms_per_step": probe_ms,
           "probe_insert_share": probe_ms / times["step_ms"][0]}

    before = [tb.hash_keys.clone() for tb in tables]
    model.evaluate(day1.take(2 * TRAIN_BATCH), batch_size=TRAIN_BATCH, device=dev)
    require(all(torch.equal(k, tb.hash_keys) for k, tb in zip(before, tables)),
            "(b): evaluate changed the keys")
    day2 = day(SEED + 60, 1_000_003)  # a second day: other raw ids
    n1 = allocated
    model.fit(day2.take(DAY2_STEPS * TRAIN_BATCH), epochs=1, batch_size=TRAIN_BATCH,
              shuffle=False, device=dev)
    n2 = sum(tb.num_allocated for tb in tables)
    require(n2 > n1, f"(b): day 2 allocated nothing ({n1} -> {n2})")
    out["day2_allocated"] = n2 - n1
    for tb in tables:
        tb._map_ids = origs[tb.block_name]
    big = max(tables, key=lambda tb: tb.capacity)
    x0, _ = next(iter(mt.Loader(day1, TRAIN_BATCH)))
    slots0 = origs[big.block_name](torch.as_tensor(x0[big.features[0]], device=dev).int(),
                                   big.hash_keys.clone(), False).to(torch.int32)
    k7 = measure_k7(dev, gen, big, slots0, errs, "dynamic slots")
    print(f"  (b) step {times['step_ms']} ms, probe and insert {probe_ms:.3f} ms a step "
          f"({out['probe_insert_share']:.3f}); peak {(peak - held) / 1e9:.2f} GB above what "
          f"earlier phases hold; evaluate left the keys; day 2 allocated {n2 - n1} slots in "
          f"{DAY2_STEPS} steps", flush=True)
    del model, tables, big, recorded, keys, before
    torch.cuda.empty_cache()

    # examples/17 at its own capacities: the graph route and card vs CPU
    rng = np.random.default_rng(7)
    ex_schema = mt.Schema([
        mt.create_categorical_column("item", 1_000_000_000, tags=(mt.Tags.ITEM_ID,)),
        mt.create_categorical_column("user", 1_000_000_000, tags=(mt.Tags.USER_ID,)),
        mt.create_categorical_column("click", 1, tags=(mt.Tags.TARGET,
                                                       mt.Tags.BINARY_CLASSIFICATION))])
    items = rng.integers(0, 200, EX17_ROWS).astype(np.int64) * 2654435761 % 2**31
    users = mt.string_id_hash(np.array([f"user_{u}" for u in rng.integers(0, 500, EX17_ROWS)]))
    ex_data = mt.Dataset({"item": items, "user": users.astype(np.int64),
                          "click": (items % 2).astype(np.float32)}, schema=ex_schema)

    def make17():
        return dynamic_model(dev, ex_schema, "click",
                             dynamic_capacity={"item": 2048, "user": 1024})

    _, mg, lg, le = graph_vs_eager(dev, None, ex_data, 2, f"(b) examples/17, {EX17_SPE} steps a "
                                   "chunk", make=make17, batch=EX17_BATCH, optimizer="adam",
                                   learning_rate=ADAGRAD_LR, metrics=[],
                                   steps_per_execution=EX17_SPE)
    require(lg["row_gather"] == 2, f"(b) examples/17: K9 issued {lg['row_gather']} times")
    ex_tables = [m for m in mg.modules() if isinstance(m, mt.DynamicEmbeddingTable)]
    out["example17_graph"] = {"allocated": [t.num_allocated for t in ex_tables],
                              "graphs": graph_stats(mg)}
    del mg
    on_card = make17().build(ex_data, device=dev)  # built on the card, then copied
    on_cpu = copy.deepcopy(on_card).to("cpu")
    for m in (on_card, on_cpu):
        m.compile(optimizer="adam", learning_rate=ADAGRAD_LR, metrics=[])
    out["example17_card_vs_cpu"] = step_card_vs_cpu(
        on_card, on_cpu, ex_data, EX17_CPU_STEPS, "(b) examples/17 card vs CPU", "adam",
        lr=ADAGRAD_LR, batch=EX17_BATCH)
    for a, b in zip([m for m in on_card.modules() if isinstance(m, mt.DynamicEmbeddingTable)],
                    [m for m in on_cpu.modules() if isinstance(m, mt.DynamicEmbeddingTable)]):
        require(torch.equal(a.hash_keys.cpu(), b.hash_keys), f"(b) examples/17: {a.block_name}'s "
                "keys differ card vs CPU")
    out["phase_s"] = time.perf_counter() - t_phase
    return out, k7_launches, k7, lg["row_gather"]


def phase_pretrained(dev, card):
    """(c) examples/15's flow on movielens-25m: D = PRE_DIM, batch 8192, the
    movieId table (56,681 x 64) from given rows. Frozen, it is bit-unchanged
    after PRE_STEPS dense steps and after PRE_STEPS row-sparse steps, and
    K7 lands only on the other tables (the wrapper's count: twice a table a
    step); unfrozen, it moves; built ``trainable=False`` it is a buffer in no
    optimizer group and stays. Returns (numbers, K7's launches)."""
    import models_tpu_torch as mt
    from models_tpu_torch.ops import scatter as S

    t_phase = time.perf_counter()
    data = mt.generate_data("movielens-25m", num_rows=PRE_STEPS * TRAIN_BATCH, seed=SEED + 40)
    schema = data.schema.excluding_by_name(["rating", "title"])
    n_items = schema["movieId"].cardinality
    rows = (np.random.default_rng(SEED).normal(size=(n_items, PRE_DIM)) / 4.0).astype(np.float32)
    want = torch.as_tensor(rows)

    def make(**kw):
        inputs = mt.InputBlockV2(schema, dim=PRE_DIM, seed=SEED, device=dev,
                                 table_kwargs={"movieId": {"weights": rows}}, **kw)
        model = mt.Model(inputs >> mt.MLPBlock([64, 32], seed=SEED), mt.OutputBlock(schema),
                         schema=schema)
        return model, inputs["categorical"]["movieId"]

    def fit(model):
        return model.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False,
                         device=dev).history["loss"]

    out = {"card": card, "table": [n_items, PRE_DIM]}
    model, table = make()
    model.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR, metrics=[])
    model.freeze_blocks("movieId")
    out["dense_frozen_loss"] = fit(model)
    require(torch.equal(table.embeddings.cpu(), want), "(c): the frozen table moved (dense)")

    model, table = make()
    model.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR, embedding_optimizer="adagrad",
                  metrics=[])
    model.freeze_blocks("movieId")
    S.row_scatter_add.launches = 0
    out["sparse_frozen_loss"] = fit(model)
    torch.cuda.synchronize()
    launches = S.row_scatter_add.launches
    others = len(model._sparse_tables) - 1
    require(table in model._sparse_tables and launches == 2 * others * PRE_STEPS,
            f"(c): K7 launched {launches} times, want {2 * others * PRE_STEPS} (none on the "
            "frozen table)")
    require(torch.equal(table.embeddings.cpu(), want), "(c): the frozen table moved (row-sparse)")
    model.unfreeze_all_frozen_blocks()
    out["sparse_unfrozen_loss"] = fit(model)
    moved = int((table.embeddings.cpu() != want).any(dim=1).sum())
    require(moved > 0, "(c): the unfrozen table did not move")

    model, table = make(trainable={"movieId": False})
    model.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR, metrics=[])
    out["buffer_loss"] = fit(model)
    groups = {id(p) for g in model._optimizer.param_groups for p in g["params"]}
    require(not isinstance(table.table, torch.nn.Parameter) and id(table.table) not in groups
            and table not in model._sparse_tables and torch.equal(table.embeddings.cpu(), want),
            "(c): the trainable=False table is in an optimizer group or moved")
    out.update(k7_launches=launches, unfrozen_rows_moved=moved,
               phase_s=time.perf_counter() - t_phase)
    print(f"  (c) pretrained movieId: frozen bit-unchanged after {PRE_STEPS} dense and "
          f"{PRE_STEPS} row-sparse steps (K7 {launches} launches, none on it), unfrozen "
          f"{moved} rows moved, trainable=False in no optimizer group", flush=True)
    return out, launches


def phase_tt(dev, card):
    """(d) ``Embeddings(dim=16, tt_compression_threshold=TT_THRESHOLD)`` on the
    full Criteo layout: five TT tables (C1, C10, C20, C21, C22); one adagrad
    step at batch 8192 on the card against a CPU copy; each TT lookup's time
    at one batch's ids and the tables' bytes against the plain tables'."""
    import copy

    import models_tpu_torch as mt

    t_phase = time.perf_counter()
    data = mt.generate_data("criteo", num_rows=TRAIN_BATCH, seed=SEED + 50)
    schema = data.schema
    emb = mt.Embeddings(schema.categorical, dim=16, tt_compression_threshold=TT_THRESHOLD,
                        seed=SEED, device=dev)
    tts = {n: b for n, b in emb.branches.items() if isinstance(b, mt.TTEmbeddingTable)}
    require(sorted(tts) == ["C1", "C10", "C20", "C21", "C22"], f"(d): TT tables {sorted(tts)}")
    model = mt.Model(mt.InputBlockV2(schema, categorical=emb, device=dev)
                     >> mt.MLPBlock([32], seed=SEED), mt.OutputBlock(schema), schema=schema)
    model.build(data, device=dev)
    on_cpu = copy.deepcopy(model).to("cpu")
    for m in (model, on_cpu):
        m.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR, metrics=[])
    cvc = step_card_vs_cpu(model, on_cpu, data, 1, "(d) TT card vs CPU", "adagrad",
                           lr=ADAGRAD_LR, batch=TRAIN_BATCH)
    x, _ = next(iter(mt.Loader(data, TRAIN_BATCH)))
    lookup = {n: cuda_ms(lambda b=b, ids=torch.as_tensor(x[n], device=dev): b._lookup(ids))
              for n, b in tts.items()}
    tt_bytes = sum(sum(c.numel() for c in (b.core1, b.core2, b.core3)) * 4 for b in tts.values())
    plain_bytes = sum(b.input_dim * b.dim * 4 for b in tts.values())
    out = {"card": card, "card_vs_cpu": cvc, "lookup_ms": lookup, "tt_bytes": tt_bytes,
           "plain_bytes": plain_bytes, "phase_s": time.perf_counter() - t_phase}
    print(f"  (d) TT tables {sorted(tts)}: {tt_bytes / 1e6:.2f} MB against {plain_bytes / 1e9:.2f} "
          f"GB plain; lookups {json.dumps(lookup)} ms at {TRAIN_BATCH} ids; {card}", flush=True)
    return out


def phase_dsl(dev, gen, card, errs):
    """Phase 20: (a) Wide&Deep, (b) dynamic tables, (c) pretrained and
    frozen tables, (d) TT tables. Returns (numbers, K9 launches, K9 on the
    W&D pack, K7 launches, K7 times)."""
    out = {}
    out["wide_and_deep"], wd_k9, wd_k9_traced, wd_pack, wd_k7, wd_k7_times = \
        phase_wide_and_deep(dev, gen, card, errs)
    out["dynamic"], dyn_k7, dyn_k7_times, ex17_k9 = phase_dynamic(dev, gen, card, errs)
    out["pretrained"], pre_k7 = phase_pretrained(dev, card)
    out["tt"] = phase_tt(dev, card)
    k9 = {"launches_wd": wd_k9, "launches_replayed_traced_wd": wd_k9_traced,
          "launches_example17": ex17_k9, "wd_pack": wd_pack}
    k7 = {"launches_wd_sparse": wd_k7, "launches_dynamic": dyn_k7,
          "launches_pretrained": pre_k7, "wd": wd_k7_times, "dynamic_slots": dyn_k7_times}
    return out, k9, k7


# ---------------------------------------------------------------------------
# phase 21: save and load, step checkpoints and exact resume, serving export
# ---------------------------------------------------------------------------

PERSIST_BATCHES = 8  # batches of TRAIN_BATCH an epoch of the resume runs
SERVE_REPS = 20  # calls a latency is the median of
PERSIST_DIR = os.path.join(ROOT, "build", "phase21")

# the exported programs, served in a fresh process that builds no model:
# each program's outputs, the K4, K5 and K6 launches its run counted, the
# models_tpu_torch operators it holds and its latency (host clock and CUDA
# events, median of SERVE_REPS calls from host arrays)
SERVE_CODE = r"""
import json, sys, time
import numpy as np
import torch
import models_tpu_torch as mt
from models_tpu_torch.core import config
from models_tpu_torch.ops import topk as T

out = {}
for job in json.loads(sys.argv[1]):
    model = mt.load_serving(job["path"])
    with np.load(job["request"]) as z:
        x = {k: z[k] for k in z.files}
    T.bin_max.launches = T.binned_rescore.launches = T.streaming_topk.launches = 0
    got = model(x)
    torch.cuda.synchronize()
    launches = {"bin_max": T.bin_max.launches, "binned_rescore": T.binned_rescore.launches,
                "streaming_topk": T.streaming_topk.launches}
    got = got if isinstance(got, dict) else {"": got}
    np.savez(job["out"], **{k: v.cpu().numpy() for k, v in got.items()})
    host, events = [], []
    for _ in range(%d):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        model(x)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        events.append(start.elapsed_time(end))
    # the program on inputs already on the card, through its call (the
    # input guards of ExportedProgram.module() first) and its forward alone
    feats = {k: torch.as_tensor(v, device="cuda") for k, v in x.items()}
    timed = {}
    for what, fn in (("call", model._run), ("forward", model._run.forward)):
        fn(feats)
        torch.cuda.synchronize()
        ts = []
        for _ in range(%d):
            t = time.perf_counter()
            fn(feats)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        timed[what] = float(np.median(ts))
    ops = sorted({str(n.target) for n in model.program.graph.nodes
                  if n.op == "call_function" and "models_tpu_torch" in str(n.target)})
    out[job["name"]] = {"launches": launches, "ops": ops, "host_ms": float(np.median(host)),
                        "event_ms": float(np.median(events)),
                        "device_inputs_call_ms": timed["call"],
                        "device_inputs_forward_ms": timed["forward"]}
print(json.dumps({"served": out, "constructed": len(config._INIT_ARGS)}))
""" % (SERVE_REPS, SERVE_REPS)


def request_ms(fn, reps: int = SERVE_REPS) -> dict:
    """A request's latency, median of ``reps`` calls each ending in a
    synchronise: host clock and CUDA events (ms)."""
    fn()
    torch.cuda.synchronize()
    host, events = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        events.append(start.elapsed_time(end))
    return {"host_ms": float(np.median(host)), "event_ms": float(np.median(events))}


def warmup_cosine(peak: float, warmup: int, decay: int):
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay) in torch
    ops on the optimizer's device step: evaluated inside the step, so that a
    captured chunk replays it."""
    def schedule(step):
        s = step.to(torch.float32)
        warm = peak * torch.clamp(s, 0, warmup) / warmup
        c = torch.clamp(s - warmup, 0, decay - warmup)
        return torch.where(s < warmup, warm,
                           peak * 0.5 * (1 + torch.cos(math.pi * c / (decay - warmup))))

    return schedule


def resume_case(dev, schema, data, epochs, what, make_kw, compile_kw) -> dict:
    """An uninterrupted fit of ``epochs`` epochs, unshuffled, against the same
    run cut after ``epochs // 2`` epochs by a ``ModelCheckpoint`` and resumed
    on a fresh model through ``CheckpointManager.restore_training`` and
    ``fit(initial_epoch=)``, deterministic algorithms on: losses, every
    parameter and buffer (row-sparse slots, bf16 tables), the dense
    optimizer's state and the step count bit for bit. Returns the launches
    the resumed fit's wrappers counted and the restore's seconds."""
    import models_tpu_torch as mt
    from models_tpu_torch.utils.checkpoint import CheckpointManager, ModelCheckpoint
    from models_tpu_torch.utils.io import model_state

    def make():
        m = mt.TwoTowerModel(schema, query_tower=(256, 128), embedding_dim=128, seed=SEED,
                             device=dev, **make_kw)
        m.compile(metrics=[], **compile_kw)
        return m

    half = epochs // 2
    ckpt = os.path.join(PERSIST_DIR, "ckpt_" + what.replace(" ", "_"))
    with deterministic(True):
        whole = make()
        hw = whole.fit(data, epochs=epochs, batch_size=TRAIN_BATCH, shuffle=False,
                       device=dev).history
        first = make()
        first.fit(data, epochs=half, batch_size=TRAIN_BATCH, shuffle=False, device=dev,
                  callbacks=[ModelCheckpoint(ckpt, max_to_keep=1)])
        del first
        resumed = make()
        t = time.perf_counter()
        step = CheckpointManager(ckpt).restore_training(resumed, data=data, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        zero_route_launches()
        hr = resumed.fit(data, epochs=epochs, initial_epoch=step + 1, batch_size=TRAIN_BATCH,
                         shuffle=False, device=dev).history
        torch.cuda.synchronize()
        launches = {**route_launches(), **sparse_launches()}
    require(step == half - 1, f"{what}: restored step {step}")
    require(hr["loss"] == hw["loss"][half:],
            f"{what}: resumed losses {hr['loss']} against {hw['loss'][half:]}")
    require(resumed._step == whole._step, f"{what}: steps {resumed._step} / {whole._step}")
    sw, sr = model_state(whole), model_state(resumed)
    require(list(sw) == list(sr) and all(
        sw[k].dtype == sr[k].dtype and torch.equal(sw[k], sr[k]) for k in sw),
        f"{what}: resumed state differs: {[k for k in sw if not torch.equal(sw[k], sr[k])]}")
    ow, orr = whole.training_state()["opt_state"], resumed.training_state()["opt_state"]
    require(sorted(ow) == sorted(orr) and all(
        torch.equal(v, orr[i][n]) for i in ow for n, v in ow[i].items() if torch.is_tensor(v)),
        f"{what}: resumed optimizer state differs")
    slots = sum(".sparse_slots." in k for k in sw)
    print(f"  (a) {what}: resumed from epoch {step} bit-equal to the uninterrupted run "
          f"(losses {hr['loss']}, {len(sw)} state tensors, {slots} row-sparse slots, "
          f"{sum(len(v) for v in ow.values())} optimizer tensors, step {resumed._step}); "
          f"restore {restore_s:.2f} s, launches {launches}", flush=True)
    return {"losses": hr["loss"], "restore_s": restore_s, "launches": launches,
            "model": resumed}


def export_trained(dev, model, data, rows: int = 1024) -> None:
    """A model trained 8 steps a graph replay, its captured chunk (a
    ``torch.cuda.CUDAGraph``) and optimizer in its engine, exported with
    the default platforms (the card and the CPU; the CPU program traced on
    a copy without the engine): the card's program serves ``predict``'s
    outputs bit for bit, the CPU's within the fp32 tolerance, and the
    model keeps its chunk."""
    import models_tpu_torch as mt

    art = os.path.join(PERSIST_DIR, "graph_trained")
    ds = data.take(rows)
    t = time.perf_counter()
    model.export_serving(art, data=ds, batch_size=rows, device=dev)
    export_s = time.perf_counter() - t
    with open(os.path.join(art, "serving_spec.json")) as f:
        require(json.load(f)["platforms"] == ["cuda", "cpu"], "default platforms")
    require(len(model._chunk_graphs) == 1 and model._optimizer is not None,
            "the export took the engine away")
    x, _ = next(iter(mt.Loader(ds, rows)))
    x = {k: v for k, v in x.items() if k != "__row_valid__"}

    def arrays(out):
        out = out if isinstance(out, dict) else {"": out}
        return {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in out.items()}

    want = arrays(model.predict(ds, batch_size=rows, device=dev))
    card_out = arrays(mt.load_serving(art, device=dev)(x))
    cpu_out = arrays(mt.load_serving(art, device="cpu")(x))
    require(sorted(card_out) == sorted(want) == sorted(cpu_out)
            and all(np.array_equal(card_out[k], want[k]) for k in want),
            "the graph-trained model's card program differs from predict")
    err = max(float(np.abs(cpu_out[k] - want[k]).max()) for k in want)
    scale = max(1.0, max(float(np.abs(v).max()) for v in want.values()))
    require(err <= FCE_TOL * scale, f"the graph-trained model's CPU program: max|d| {err}")
    print(f"  (a) the graph-trained model exported for the card and the CPU in {export_s:.2f} s "
          f"(its captured chunk and optimizer kept): the card's program bit-equal to predict, "
          f"the CPU's within {err:.3g}", flush=True)


def served_kernels(name: str) -> list:
    """The kernels an exported top-k program of phase 21 holds: K4 and K5 at
    256 rows (the binned route), K6 at 4096 (the streaming route)."""
    return ["bin_max", "binned_rescore"] if name.endswith("B256") else ["streaming_topk"]


def check_ops_entry(dev, index, queries) -> dict:
    """K4, K5 and K6 through their custom-op entries (``torch.ops.
    models_tpu_torch``), against the wrappers (bit for bit) and the plain
    versions (the top-k tolerance), on the fp32 index at the serving
    shapes."""
    from models_tpu_torch.ops import topk as T

    q = queries.contiguous()
    n = index.n_valid
    op4 = torch.ops.models_tpu_torch.bin_max(q[:256], index.candidates, 64, None, False)
    wrap4 = T.bin_max(q[:256], index.candidates)
    plain4 = T.bin_max_plain(q[:256], index.candidates, 64)
    torch.cuda.synchronize()
    require(torch.equal(raw_bits(op4), raw_bits(wrap4)), "bin_max's op differs from its wrapper")
    err4 = T.max_abs_err(op4, plain4)
    require(err4 <= tol_for(plain4), f"bin_max through its op: max|d| {err4}")
    idx = T.select_bins(q[:256], index.candidates, K, n_valid=n)
    op5 = torch.ops.models_tpu_torch.binned_rescore(q[:256], index.candidates, idx, 64)
    wrap5 = T.binned_rescore(q[:256], index.candidates, idx, 64)
    plain5 = T.binned_rescore_plain(q[:256], index.candidates, idx, 64)
    s6, i6 = torch.ops.models_tpu_torch.streaming_topk(q, index.candidates, K, index.ids, n, None)
    ws, wi = T.streaming_topk(q, index.candidates, K, ids=index.ids, n_valid=n)
    ps, pi = T.streaming_topk_plain(q, index.candidates, K, ids=index.ids, n_valid=n)
    torch.cuda.synchronize()
    require(torch.equal(op5, wrap5) and torch.equal(s6, ws) and torch.equal(i6, wi),
            "the custom-op entries differ from the wrappers")
    err5 = T.max_abs_err(op5, plain5)
    require(err5 <= tol_for(plain5), f"binned_rescore through its op: max|d| {err5}")
    check_topk("streaming_topk through its op", (s6, i6), (ps, pi))
    print(f"  (c) K4, K5, K6 through torch.ops.models_tpu_torch: equal to the wrappers, K4 "
          f"max|d| {err4:.3g}, K5 {err5:.3g} against their plain versions", flush=True)
    return {"bin_max": err4, "binned_rescore": err5, "streaming_topk": T.max_abs_err(s6, ps)}


def phase_persistence(dev, card, errs):
    """Phase 21: (a) exact resume, (b) save and load, (c) the exported top-k
    encoder served by a fresh process, (d) the exported DLRM. Returns
    (numbers, launches by kernel row and path)."""
    import shutil

    import models_tpu_torch as mt
    from models_tpu_torch.ops import topk as T

    shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    os.makedirs(PERSIST_DIR)
    out, rows = {}, {}
    schema = mt.generate_data("movielens-25m", num_rows=1).schema
    data = mt.generate_data("movielens-25m", num_rows=PERSIST_BATCHES * TRAIN_BATCH,
                            seed=SEED + 21)

    # (a) resume: adam on a warmup-cosine schedule one step at a time and 8
    # steps a graph replay; adagrad row-sparsely on bf16 tables
    sched = dict(optimizer="adam", learning_rate=warmup_cosine(1e-3, 4, 40))
    one = resume_case(dev, schema, data, 4, "adam warmup-cosine, one step at a time", {},
                      sched)
    graph = resume_case(dev, schema, data, 4, "adam warmup-cosine, 8 steps a graph replay",
                        {}, dict(sched, steps_per_execution=PERSIST_BATCHES))
    require(len(graph["model"]._chunk_graphs) == 1, "the resumed graph route captured no chunk")
    sparse = resume_case(dev, schema, data.take(4 * TRAIN_BATCH), 2,
                         "row-sparse adagrad on bf16 tables", dict(table_dtype=torch.bfloat16),
                         dict(optimizer="adagrad", learning_rate=0.05,
                              embedding_optimizer="adagrad"))
    out["resume"] = {k: {"losses": v["losses"], "restore_s": v["restore_s"]}
                     for k, v in (("one_step", one), ("graph", graph), ("sparse_bf16", sparse))}
    for name in ("lse_forward", "grad_query", "grad_neg"):
        rows.setdefault(name, {})["launches_resume"] = one["launches"][name]
        rows[name]["launches_resume_graph"] = graph["launches"][name]
        rows[name]["launches_resume_sparse"] = sparse["launches"][name]
        require(one["launches"][name] > 0 and graph["launches"][name] > 0,
                f"the resumed fits never launched {name}")
    export_trained(dev, graph["model"], data)
    rows["row_gather"] = {"launches_resume_graph": graph["launches"]["row_gather"]}
    rows["row_scatter_add"] = {"launches_resume_sparse": sparse["launches"]["row_scatter_add"]}
    rows["row_scatter_write"] = {
        "launches_resume_sparse": sparse["launches"]["row_scatter_write"]}
    for name, n in (("row_gather", graph["launches"]["row_gather"]),
                    ("row_scatter_add", sparse["launches"]["row_scatter_add"]),
                    ("row_scatter_write", sparse["launches"]["row_scatter_write"])):
        require(n > 0, f"the resumed fits never launched {name}")

    # (b) save on the card, load on the card and on the CPU
    model = one["model"]
    del graph, sparse
    queries = mt.generate_data("movielens-25m", num_rows=4096, seed=SEED + 22)
    path = os.path.join(PERSIST_DIR, "saved")
    t = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    on_card = mt.load_model(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    on_cpu = mt.load_model(path, device="cpu")
    want = model.predict(queries, batch_size=1024, device=dev)
    got = on_card.predict(queries, batch_size=1024, device=dev)
    cpu = on_cpu.predict(queries, batch_size=1024, device="cpu")
    require(np.array_equal(got, want), "the model loaded on the card predicts otherwise")
    cpu_err = float(np.abs(cpu - want).max())
    require(cpu_err <= FCE_TOL * max(1.0, float(np.abs(want).max())),
            f"the model loaded on the CPU: max|d| {cpu_err}")
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
               if os.path.isfile(os.path.join(path, f)))
    out["save_load"] = {"save_s": save_s, "load_s": load_s, "bytes": size, "cpu_max_abs_err":
                        cpu_err}
    print(f"  (b) saved in {save_s:.2f} s ({size} bytes), loaded on the card in {load_s:.2f} s: "
          f"predictions bit-equal; on the CPU within {cpu_err:.3g}", flush=True)
    del on_card, on_cpu

    # (c) the top-k encoder exported over the catalog, fp32, bf16 and int8
    _, catalog, _ = build_model(dev)
    jobs, want, export_s, latency = [], {}, {}, {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        enc = model.to_top_k_encoder(catalog, k=K, candidate_dtype=dtype, batch_size=8192,
                                     device=dev)
        if tag == "fp32":
            out["ops_entry_max_abs_err"] = check_ops_entry(
                dev, enc.blocks[-1].topk_layer,
                enc.blocks[0](mt.core.types.to_device_batch(
                    next(iter(mt.Loader(queries, 4096)))[0], dev)).detach())
        for B in (256, 4096):
            name = f"topk_{tag}_B{B}"
            art = os.path.join(PERSIST_DIR, name)
            ds = queries.take(B)
            t = time.perf_counter()
            enc.export_serving(art, data=ds, batch_size=B, device=dev,
                               platforms=("cuda", "cpu") if B == 256 else ("cuda",))
            export_s[name] = time.perf_counter() - t
            x, _ = next(iter(mt.Loader(ds, B)))
            np.savez(os.path.join(art, "request.npz"), **mt.core.types.flatten_features(
                {k: v for k, v in x.items() if k != "__row_valid__"}))
            want[name] = enc.predict(ds, batch_size=B, device=dev)
            latency[name] = {f"predict_{k}": v for k, v in request_ms(
                lambda: enc.predict(ds, batch_size=B, device=dev)).items()}
            jobs.append({"name": name, "path": art, "request": os.path.join(art, "request.npz"),
                         "out": os.path.join(art, "served.npz")})
        del enc
    # (d) the DLRM at the bench's width, 8192 rows
    crit = mt.generate_data("criteo-small", num_rows=TRAIN_BATCH, seed=SEED + 23)
    dlrm = dlrm_model(dev, crit.schema)
    art = os.path.join(PERSIST_DIR, "dlrm_B8192")
    t = time.perf_counter()
    dlrm.export_serving(art, data=crit, batch_size=TRAIN_BATCH, device=dev,
                        platforms=("cuda",))
    export_s["dlrm_B8192"] = time.perf_counter() - t
    x, _ = next(iter(mt.Loader(crit, TRAIN_BATCH)))
    np.savez(os.path.join(art, "request.npz"), **mt.core.types.flatten_features(
        {k: v for k, v in x.items() if k != "__row_valid__"}))
    want["dlrm_B8192"] = dlrm.predict(crit, batch_size=TRAIN_BATCH, device=dev)
    latency["dlrm_B8192"] = {f"predict_{k}": v for k, v in request_ms(
        lambda: dlrm.predict(crit, batch_size=TRAIN_BATCH, device=dev)).items()}
    jobs.append({"name": "dlrm_B8192", "path": art, "request": os.path.join(art, "request.npz"),
                 "out": os.path.join(art, "served.npz")})
    del dlrm, model
    torch.cuda.empty_cache()
    print(f"  exported in {json.dumps(export_s)} s", flush=True)

    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", SERVE_CODE, json.dumps(jobs)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    require(res.returncode == 0, f"the serving process failed:\n{res.stderr[-4000:]}")
    report = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"  the serving process ran in {time.perf_counter() - t:.1f} s, constructed "
          f"{report['constructed']} blocks", flush=True)
    require(report["constructed"] == 0, "the serving process built a model")
    launches = {}
    for job in jobs:
        name, served = job["name"], report["served"][job["name"]]
        with np.load(job["out"]) as z:
            got = {k: z[k] for k in z.files}
        latency[name].update(served_host_ms=served["host_ms"], served_event_ms=served["event_ms"],
                             served_device_inputs_call_ms=served["device_inputs_call_ms"],
                             served_device_inputs_forward_ms=served["device_inputs_forward_ms"])
        launches[name] = served["launches"]
        if name.startswith("dlrm"):
            err = float(np.abs(got[""] - want[name]).max())
            require(err <= FCE_TOL, f"{name}: served probabilities max|d| {err}")
            require(served["ops"] == [], f"{name}: operators {served['ops']}")
            print(f"  (d) {name}: served within {err:.3g} of predict; {latency[name]}",
                  flush=True)
            continue
        held = served_kernels(name)
        require(served["ops"] == [f"models_tpu_torch.{k}.default" for k in held],
                f"{name}: the program holds {served['ops']}")
        require(all(served["launches"][k] > 0 for k in held),
                f"{name}: the loaded program never launched {held}: {served['launches']}")
        require(served["launches"]["bin_max"] == served["launches"]["binned_rescore"],
                f"{name}: K4 and K5 launched {served['launches']}")
        require(np.array_equal(got["scores"], want[name]["scores"])
                and np.array_equal(got["ids"], want[name]["ids"]),
                f"{name}: served scores or ids differ from predict's")
        print(f"  (c) {name}: {served['ops']}, launches {served['launches']}, scores and ids "
              f"bit-equal to predict's; {latency[name]}", flush=True)
    out.update(export_s=export_s, latency=latency, served_launches=launches)
    for name, n in launches.items():  # on the kernel's fp32 row, by index and batch
        if name.startswith("topk"):
            for kernel in served_kernels(name):
                rows.setdefault(kernel, {})[f"launches_exported_{name[len('topk_'):]}"] = n[kernel]
    shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    print(card, flush=True)
    return out, rows


# ---------------------------------------------------------------------------
# phase 22: the mesh (torch.distributed ranks)
# ---------------------------------------------------------------------------

# The four ranks share the one card. NCCL refuses two ranks on one device
# (the phase asks it again and prints its answer), so they join over gloo,
# chosen here and not by a try: the collective layer stages each collective
# of CUDA tensors through host memory under gloo
# (models_tpu_torch/parallel/collectives.py).
MESH_BACKEND = "gloo"
MESH_SHAPE = {"data": 2, "model": 2}
TOPK_MESH = {"data": 1, "model": 4}
MESH_STEPS = 8
MESH_RTOL = 2e-4  # the JAX tests' tolerance on a mesh's loss trajectory
MESH_TIMEOUT = 300
MESH_LABEL = "four ranks sharing one H100, not a multi-card time"
MESH_KINDS = ("dense", "sparse", "bf16", "dlrm")
# where each run must launch each kernel of its path
MESH_PATHS = {
    "dense": ("lse_forward", "grad_query", "grad_neg", "row_gather", "row_scatter_add"),
    "sparse": ("lse_forward", "grad_query", "grad_neg", "row_gather", "row_scatter_add"),
    "bf16": ("lse_forward", "grad_query", "grad_neg", "row_gather", "row_scatter_add",
             "row_scatter_write"),
    "dlrm": ("row_gather", "row_scatter_add"),
}


def mesh_counters() -> dict:
    from models_tpu_torch.ops import embedding_lookup as E
    from models_tpu_torch.ops import flash_ce as F
    from models_tpu_torch.ops import scatter as S
    from models_tpu_torch.ops import topk as T

    return {"lse_forward": F.lse_forward, "grad_query": F.grad_query, "grad_neg": F.grad_neg,
            "row_gather": E.row_gather, "row_scatter_add": S.row_scatter_add,
            "row_scatter_write": S.row_scatter_write, "bin_max": T.bin_max,
            "binned_rescore": T.binned_rescore, "streaming_topk": T.streaming_topk}


def zero_mesh_counts() -> None:
    for fn in mesh_counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0


def mesh_counts() -> dict:
    return {name: fn.launches for name, fn in mesh_counters().items()}


def mesh_model(kind: str, schema, dev):
    import models_tpu_torch as mt

    if kind == "dlrm":
        return dlrm_model(dev, schema)
    dtype = torch.bfloat16 if kind == "bf16" else None
    return mt.TwoTowerModel(schema, query_tower=(256, 128), embedding_dim=128, table_dtype=dtype,
                            seed=SEED, device=dev)


def mesh_compile(model, kind: str):
    if kind == "dense":
        return model.compile(optimizer="adam", learning_rate=ADAM_LR, metrics=[])
    if kind == "dlrm":
        return model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    return compile_sparse(model)


class StepClock:
    """A fit callback: each step's local loss, its end on the host clock
    (after a synchronise) and as a CUDA event, and the host seconds spent in
    collectives so far (``TRAFFIC``)."""

    def set_model(self, model):
        pass

    def _mark(self):
        from models_tpu_torch.parallel.collectives import TRAFFIC

        self.host.append(time.perf_counter())
        self.coll.append(sum(TRAFFIC.seconds.values()))

    def on_epoch_begin(self, epoch):
        torch.cuda.synchronize()
        self.losses, self.events = [], [torch.cuda.Event(enable_timing=True)]
        self.events[0].record()
        self.host, self.coll = [], []
        self._mark()

    def on_batch_end(self, step, logs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda.synchronize()
        self._mark()
        self.events.append(ev)
        self.losses.append(logs["loss"].detach().reshape(()))

    def step_ms(self) -> dict:
        """Medians over the steps after the first (which builds the
        optimizer's slots, the lookups' buffers and the groups' links)."""
        host = np.diff(self.host) * 1e3
        coll = np.diff(self.coll) * 1e3
        events = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        return {"host_ms": float(np.median(host[1:])), "events_ms": float(np.median(events[1:])),
                "collective_ms": float(np.median(coll[1:])), "first_host_ms": float(host[0])}


def mesh_fit(model, kind, data, dev, mesh=None) -> dict:
    """MESH_STEPS steps of a seeded model, one epoch, unshuffled: the global
    batch's loss of each step (the mean over the data line of the ranks'),
    the kernels' launches, the collectives and the step times."""
    from models_tpu_torch.parallel.collectives import TRAFFIC, all_reduce

    mesh_compile(model, kind)
    clock = StepClock()
    zero_mesh_counts()
    TRAFFIC.reset()
    model.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, device=dev, mesh=mesh,
              callbacks=[clock])
    torch.cuda.synchronize()
    traffic = TRAFFIC.snapshot()
    launches = mesh_counts()
    losses = torch.stack(clock.losses).float()
    if mesh is not None:
        g = mesh.group("data")
        losses = all_reduce(losses, g) / g.size
    return {"loss": losses.cpu().tolist(), "launches": launches, "traffic": traffic,
            **clock.step_ms()}


def nccl_probe(rank, world, init):
    """NCCL's answer to four ranks on one card: an all-reduce over them, or
    the error it raises (recorded: the phase's backend is chosen apart)."""
    from models_tpu_torch.parallel import initialize, shutdown

    try:
        initialize(init, world, rank, backend="nccl", device="cuda:0", timeout=30)
        t = torch.ones(4, device="cuda:0")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        return {"ok": True, "sum": float(t[0])}
    except Exception as err:  # the probe's result is the answer itself
        return {"ok": False, "error": f"{type(err).__name__}: {err}"[:800]}
    finally:
        shutdown()


def mesh_ops_one(mesh, dev) -> dict:
    """The sharded ops on a model axis of one against the single-card ones:
    the lookup (K9), the row update (K7), the top-k (K5 at 256 queries, K6
    at 4096) over a 65,536-row catalog."""
    from models_tpu_torch.ops import embedding_lookup as E
    from models_tpu_torch.ops import topk as T

    gen = torch.Generator(dev).manual_seed(SEED + 221)
    table = torch.randn(USER_ROWS, 128, device=dev, generator=gen)
    ids = torch.randint(0, USER_ROWS, (TRAIN_BATCH,), device=dev, generator=gen)
    upd = torch.randn(TRAIN_BATCH, 128, device=dev, generator=gen)
    zero_mesh_counts()
    got = E.sharded_lookup(table, ids, mesh)
    require(torch.equal(got, E.row_gather_plain(table, ids.to(torch.int32))),
            "sharded_lookup on a model axis of one differs from the gather")
    moved = E.sharded_update_rows(table.clone(), ids, upd, mesh)
    want = table.clone().index_add_(0, ids, upd)
    require(max_err(moved, want) <= 1e-5, "sharded_update_rows on a model axis of one")
    cand = torch.randn(65_536, 128, device=dev, generator=gen)
    q = torch.randn(4096, 128, device=dev, generator=gen)
    for B in (256, 4096):
        check_topk(f"sharded_topk, a model axis of one, B={B}",
                   T.sharded_topk(q[:B], cand, K, mesh), T.topk_scores(q[:B], cand, K))
    torch.cuda.synchronize()
    return mesh_counts()


def mesh_one_rank(rank, world, init, data):
    """Phase 22a: one rank over NCCL. The bench's two-tower trained
    MESH_STEPS steps on a {1, 1} mesh equals the same fit without a mesh,
    bit for bit (deterministic algorithms on); then the sharded ops."""
    from models_tpu_torch.parallel import initialize, make_mesh, shutdown

    initialize(init, world, rank, backend="nccl", device="cuda:0", timeout=MESH_TIMEOUT)
    dev = torch.device("cuda", 0)
    try:
        mesh = make_mesh({"data": 1, "model": 1})
        runs = {}
        with deterministic(True):
            for tag, m in (("mesh", mesh), ("none", None)):
                model = mesh_model("dense", data.schema, dev)
                runs[tag] = (mesh_fit(model, "dense", data, dev, m), model)
        (rec, a), (ref, b) = runs["mesh"], runs["none"]
        same = all(torch.equal(raw_bits(x), raw_bits(y))
                   for x, y in zip(list(a.parameters()) + list(a.buffers()),
                                   list(b.parameters()) + list(b.buffers())))
        return {"loss_mesh": rec["loss"], "loss_none": ref["loss"], "params_equal": same,
                "launches_fit": rec["launches"], "launches_ops": mesh_ops_one(mesh, dev),
                "backend": mesh.backend}
    finally:
        shutdown()


def mesh_kernel_checks(dev, shards: dict) -> dict:
    """K1-K3, K7, K8b and K9 at the shapes a {2, 2} rank gives them, against
    their plain versions: the flash-CE kernels at Q = B/dp = 4096 queries
    and N = B = 8192 (the global in-batch negatives), the scatters and the
    gather on the rank's userId shard with a step's ids."""
    gen = torch.Generator(dev).manual_seed(SEED + 222)
    errs = {"row_scatter_add": 0.0, "row_scatter_write": 0.0, "row_gather": 0.0}
    Q, N = TRAIN_BATCH // MESH_SHAPE["data"], TRAIN_BATCH
    check_fce(f"mesh shard Q={Q} N={N}", dev, fce_case(dev, gen, Q, N, 128, 1.0, True, False,
                                                        False), 1.0, errs)
    for tag, shard in shards.items():
        rows = shard.shape[0]
        ids = torch.randint(0, rows, (Q,), device=dev, generator=gen, dtype=torch.int32)
        gather_case(f"mesh userId shard {tag} ({rows} rows)", shard.contiguous(), ids, errs)
        scatter_case(dev, gen, rows, shard.shape[1], N, shard.dtype, None, errs=errs)
    return errs


def mesh_topk(dev, mesh, check: bool) -> dict:
    """The 1M x 128 catalog split by rows over {1, 4}, fp32, bf16 and int8
    indexes (each a rank's 250,000 rows; the int8 index takes one scale a
    row, 1M rows not being whole bins a shard): 256 queries (K5) and 4096
    (K6), launches counted; then, with ``check``, K4, K5 and K6 at the
    shard's shapes against their plain versions."""
    from models_tpu_torch.ops import topk as T
    from models_tpu_torch.outputs.topk import BruteForce

    gen = torch.Generator(dev).manual_seed(SEED + 223)
    cand = torch.randn(1_000_000, 128, device=dev, generator=gen)
    q = torch.randn(4096, 128, device=dev, generator=gen)
    out, counts = {}, {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        layer = BruteForce(K).index(cand, dtype=dtype, device=dev, mesh=mesh)
        zero_mesh_counts()
        for B in (256, 4096):
            pred = layer(q[:B])
            out[f"{tag}/{B}"] = (pred.scores.cpu(), pred.identifiers.cpu())
        torch.cuda.synchronize()
        counts[tag] = mesh_counts()
        if check:
            shard, scales = layer.candidates, layer.scales
            full = shard[: shard.shape[0] // 64 * 64]  # the shard's whole bins
            qk = T.quantize_queries(q[:256])[0] if dtype == torch.int8 else q[:256]
            bin_max_case(f"mesh shard {tag}", qk, full, {},
                         scale=None if scales is None else scales[: full.shape[0]])
            idx = T.select_bins(qk, full, K, col_scale=scales)
            rescore_case(dev, qk, full, idx, f"mesh shard {tag}", {})
            check_topk(f"streaming_topk, mesh shard {tag}",
                       T.streaming_topk(q, shard, K, scale=scales),
                       T.streaming_topk_plain(q, shard, K, scale=scales))
        del layer
    del cand
    torch.cuda.empty_cache()
    return {"results": out, "launches": counts}


def mesh_ranks(rank, world, init, tt_data, dlrm_data, t_spawn):
    """Phase 22b, one of four ranks on the one card: the two-tower (dense
    adam, row-sparse adagrad on fp32 and on bf16 tables) and the DLRM, each
    MESH_STEPS steps on the {2, 2} mesh; the kernels at the rank's shapes;
    the 1M-row top-k on {1, 4}."""
    import models_tpu_torch as mt
    from models_tpu_torch.parallel import initialize, make_mesh, shutdown

    quiet = rank != 0
    sink = open(os.devnull, "w")
    marks = {"entered": time.time() - t_spawn}
    initialize(init, world, rank, backend=MESH_BACKEND, device="cuda:0", timeout=MESH_TIMEOUT)
    dev = torch.device("cuda", 0)
    try:
        marks["joined"] = time.time() - t_spawn
        mesh = make_mesh(MESH_SHAPE)
        marks["mesh"] = time.time() - t_spawn
        out = {"coords": mesh.coords, "backend": mesh.backend, "runs": {}, "marks": marks}
        shards = {}
        for kind in MESH_KINDS:
            data = dlrm_data if kind == "dlrm" else tt_data
            model = mesh_model(kind, data.schema, dev)
            marks[f"{kind}_built"] = time.time() - t_spawn
            rec = mesh_fit(model, kind, data, dev, mesh)
            marks[f"{kind}_fit"] = time.time() - t_spawn
            sharded = model._sharded_ids()
            tables = model._embedding_tables()
            rec["shard_bytes"] = sum(t.table.numel() * t.table.element_size() for t in tables
                                     if t.shard is not None)
            rec["dense_bytes"] = sum(p.numel() * p.element_size()
                                     for g in model._optimizer.param_groups
                                     for p in g["params"] if id(p) not in sharded)
            # the global batch's rows of its widest lookup (ids a row looks up
            # in one table: a list column's length, a fused table's columns)
            x, _ = next(iter(mt.Loader(data, TRAIN_BATCH)))
            width = max(sum(int(np.prod(getattr(x[f], "values", x[f]).shape[1:]))
                            for f in t.features if f in x) for t in tables)
            rec["lookup_bytes"] = TRAIN_BATCH * width * max(t.dim for t in tables) * 4
            if kind == "bf16" and mesh.index("data") == 0:
                # the model line's shards, for the flip rule in the parent
                rec["bf16_shards"] = {t.block_name: t.table.detach().cpu() for t in tables
                                      if t.shard is not None}
            out["runs"][kind] = rec
            if kind in ("sparse", "bf16"):
                user = next(t for t in model._embedding_tables() if t.block_name == "userId")
                shards[kind] = user.table.detach()
            del model
        # every rank's kernels take the same shapes: rank 0 holds them to
        # their plain versions
        out["kernel_errs"] = mesh_kernel_checks(dev, shards) if rank == 0 else {}
        del shards
        torch.cuda.empty_cache()
        marks["kernels"] = time.time() - t_spawn
        with contextlib.redirect_stdout(sink) if quiet else contextlib.nullcontext():
            out["topk"] = mesh_topk(dev, make_mesh(TOPK_MESH), check=rank == 0)
        marks["topk"] = time.time() - t_spawn
        if quiet:
            out["topk"]["results"] = {k: v for k, v in out["topk"]["results"].items()
                                      if k.endswith("/256")}
        return out
    finally:
        shutdown()


def mesh_references(dev, tt_data, dlrm_data) -> dict:
    """The same fits in this process, no mesh: the trajectories the ranks
    are held to, and the bf16 tables before and after theirs."""
    refs = {}
    for kind in MESH_KINDS:
        data = dlrm_data if kind == "dlrm" else tt_data
        model = mesh_model(kind, data.schema, dev)
        before = {t.block_name: t.table.detach().cpu().clone()
                  for t in model._embedding_tables()}
        refs[kind] = mesh_fit(model, kind, data, dev)
        if kind == "bf16":
            refs[kind]["tables"] = (before, {t.block_name: t.table.detach().cpu()
                                             for t in model._embedding_tables()})
    return refs


def mesh_bf16_flips(ranks, ref) -> list:
    """The bf16 tables the four ranks trained, stitched from the model
    line's shards, against the one process's: every element that differs is
    a stochastic-rounding flip, within MIXED_PARAM_ATOL and one bf16 ulp, at
    most FLIP_SHARE_MAX of the elements the steps moved."""
    before, after = ref["tables"]
    parts: dict = {}
    for out in ranks:
        for name, shard in out["runs"]["bf16"].get("bf16_shards", {}).items():
            parts.setdefault(name, {})[out["coords"][1]] = shard
    require(bool(parts), "22b bf16: no shard came back")
    names = sorted(parts)
    pairs = [(torch.cat([parts[n][m] for m in sorted(parts[n])]), after[n]) for n in names]
    worst, flips, n_moved, largest = compare_rounded(
        "22b bf16 tables, four ranks vs one process", pairs, 0.0, (MIXED_PARAM_ATOL, 2.0 ** -7),
        share_of=moved({n: before[n] for n in names}, {n: after[n] for n in names}))
    print(f"  22b bf16 tables {names}: {flips} of {n_moved} moved elements flipped, the largest "
          f"{largest:.3g}", flush=True)
    return [flips, n_moved, largest]


def mesh_topk_references(dev) -> dict:
    """The one-rank route over the whole 1M-row catalog, each index as the
    mesh builds it (the int8 one with one scale a row)."""
    from models_tpu_torch.ops import topk as T

    gen = torch.Generator(dev).manual_seed(SEED + 223)
    cand = torch.randn(1_000_000, 128, device=dev, generator=gen)
    q = torch.randn(4096, 128, device=dev, generator=gen)
    out = {}
    for tag in ("fp32", "bf16", "int8"):
        if tag == "int8":
            scales = T.int8_scale(cand.abs().amax(dim=1))
            c = torch.clamp(torch.round(cand / scales[:, None]), -127, 127).to(torch.int8)
        else:
            scales, c = None, cand.to(getattr(torch, "float32" if tag == "fp32" else "bfloat16"))
        for B in (256, 4096):
            s, i = T.topk_scores(q[:B], c, K, col_scale=scales)
            out[f"{tag}/{B}"] = (s.cpu(), i.cpu())
        del c
    del cand
    torch.cuda.empty_cache()
    return out


def phase_mesh(dev, card) -> tuple:
    """Phase 22: (a) one rank over NCCL equals the fit without a mesh, and
    the sharded ops on a model axis of one; NCCL's answer to four ranks on
    the one card; (b) four ranks over MESH_BACKEND: the trajectories of the
    {2, 2} fits against this process's, the launches of each kernel on the
    mesh path, the largest collective (of order B * D, never a table), the
    kernels at the ranks' shapes, the 1M-row top-k against the one-rank
    route; times labelled MESH_LABEL."""
    import threading

    import models_tpu_torch as mt
    from models_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    tt_data = mt.generate_data("movielens-25m", num_rows=MESH_STEPS * TRAIN_BATCH,
                               seed=SEED + 22)
    box = {}

    def run(name, *args, **kw):
        try:
            box[name] = spawn(*args, **kw)
        except RuntimeError as err:
            box[name + "_error"] = str(err)

    dlrm_data = mt.generate_data("criteo-small", num_rows=MESH_STEPS * TRAIN_BATCH,
                                 seed=SEED + 23)
    # 22a, NCCL's probe and 22b start together, and this process fits the
    # references while the ranks start (22b's ranks take some 40 s to reach
    # their first step, by when the others are done)
    t_spawn = time.time()
    threads = [threading.Thread(target=run, args=("one", mesh_one_rank, 1, (tt_data,)),
                                kwargs={"timeout": MESH_TIMEOUT}),
               threading.Thread(target=run, args=("probe", nccl_probe, 4, ()),
                                kwargs={"timeout": 90}),
               threading.Thread(target=run, args=("ranks", mesh_ranks, 4,
                                                  (tt_data, dlrm_data, t_spawn)),
                                kwargs={"timeout": MESH_TIMEOUT})]
    for th in threads:
        th.start()
    refs = mesh_references(dev, tt_data, dlrm_data)
    topk_refs = mesh_topk_references(dev)
    stamp(f"  22: one-process references done, {time.time() - t_spawn:.1f} s after the spawns")
    threads[0].join()
    threads[1].join()
    stamp(f"  22a and the NCCL probe joined, {time.time() - t_spawn:.1f} s after the spawns")
    require("one" in box, f"phase 22a failed: {box.get('one_error')}")
    one = box["one"][0]
    probe = box.get("probe") or [{"ok": False, "error": box.get("probe_error", "")[:800]}]
    print(f"  22a: one rank over {one['backend']}: losses {one['loss_mesh']} / without a mesh "
          f"{one['loss_none']}, parameters bit-equal {one['params_equal']}", flush=True)
    require(one["loss_mesh"] == one["loss_none"] and one["params_equal"],
            "22a: the fit on a mesh of one rank differs from the fit without a mesh")
    for name in ("lse_forward", "grad_query", "grad_neg"):
        require(one["launches_fit"][name] == MESH_STEPS, f"22a: {name} launched "
                f"{one['launches_fit'][name]} times in {MESH_STEPS} steps")
    for name in ("row_gather", "row_scatter_add", "bin_max", "binned_rescore", "streaming_topk"):
        require(one["launches_ops"][name] > 0, f"22a: the sharded ops never launched {name}")
    require(one["launches_ops"]["bin_max"] == one["launches_ops"]["binned_rescore"],
            f"22a: K4 and K5 launched {one['launches_ops']}")
    print(f"  22a: sharded ops on a model axis of one, launches {one['launches_ops']}",
          flush=True)
    nccl = {"ok": all(p.get("ok") for p in probe),
            "answer": next((p["error"] for p in probe if not p.get("ok")), "all-reduce ok")}
    print(f"  NCCL, four ranks on one card: {nccl}", flush=True)

    threads[2].join()
    require("ranks" in box, f"phase 22b failed: {box.get('ranks_error')}")
    ranks = box["ranks"]
    wall_ranks = time.time() - t_spawn
    stamp(f"  22b joined, {wall_ranks:.1f} s after the spawns; rank 0 (s after the spawns): "
          f"{ranks[0]['marks']}")
    summary = {"label": MESH_LABEL, "backend": MESH_BACKEND, "card": card, "nccl_4_ranks": nccl,
               "one_rank": {k: one[k] for k in ("loss_mesh", "loss_none", "params_equal")},
               "ranks_s": wall_ranks, "rank0_marks_s": ranks[0]["marks"]}
    for kind in MESH_KINDS:
        ref = refs[kind]
        for rank, out in enumerate(ranks):
            rec = out["runs"][kind]
            require(out["backend"] == MESH_BACKEND, f"rank {rank}: backend {out['backend']}")
            require(np.allclose(rec["loss"], ref["loss"], rtol=MESH_RTOL, atol=0),
                    f"{kind}, rank {rank}: losses {rec['loss']}, one process {ref['loss']}")
            for name in MESH_PATHS[kind]:
                require(rec["launches"][name] > 0,
                        f"{kind}, rank {rank}: the mesh path never launched {name}")
            # rows and ids move at most as the global batch's rows of its
            # widest lookup (a bound of the batch alone, whatever the tables'
            # rows); an all-reduce at most as the dense gradients
            largest = rec["traffic"]["largest"]
            moved = max(largest.get("all_gather", 0), largest.get("all_to_all", 0))
            require(0 < moved <= rec["lookup_bytes"],
                    f"{kind}, rank {rank}: a collective of {moved} bytes, more than the "
                    f"batch's widest lookup ({rec['lookup_bytes']})")
            require(largest.get("all_reduce", 0) <= rec["dense_bytes"],
                    f"{kind}, rank {rank}: an all-reduce larger than the dense parameters")
        r0 = ranks[0]["runs"][kind]
        summary[kind] = {
            "loss_rank0": r0["loss"], "loss_one_process": ref["loss"],
            "max_rel_dev": max(float(np.max(np.abs(np.asarray(o["runs"][kind]["loss"])
                                                   - ref["loss"]) / np.abs(ref["loss"])))
                               for o in ranks),
            "launches_per_rank": [o["runs"][kind]["launches"] for o in ranks],
            "largest_collective_bytes": [o["runs"][kind]["traffic"]["max_bytes"] for o in ranks],
            "largest_by_kind_rank0": r0["traffic"]["largest"],
            "shard_bytes": r0["shard_bytes"], "dense_bytes": r0["dense_bytes"],
            "lookup_bytes": r0["lookup_bytes"],
            "b_d_bytes": TRAIN_BATCH * (64 if kind == "dlrm" else 128) * 4,
            "step_host_ms_per_rank": [o["runs"][kind]["host_ms"] for o in ranks],
            "step_events_ms_per_rank": [o["runs"][kind]["events_ms"] for o in ranks],
            "collective_ms_per_step_per_rank": [o["runs"][kind]["collective_ms"]
                                                for o in ranks],
            "one_process_step_host_ms": ref["host_ms"],
            "one_process_step_events_ms": ref["events_ms"]}
        print(f"  22b {kind} on {MESH_SHAPE} ({MESH_LABEL}): losses rank 0 {r0['loss']} / one "
              f"process {ref['loss']}, largest collective {r0['traffic']['max_bytes']} B "
              f"({r0['traffic']['max_kind']}), step {r0['host_ms']:.1f} ms host / "
              f"{r0['events_ms']:.1f} ms events, collectives "
              f"{r0['collective_ms']:.1f} ms a step (medians of steps 2-{MESH_STEPS})",
              flush=True)
    summary["bf16"]["table_flips_of_moved"] = mesh_bf16_flips(ranks, refs["bf16"])
    for o in ranks:
        o["runs"]["bf16"].pop("bf16_shards", None)
    summary["kernel_errs_per_rank"] = [o["kernel_errs"] for o in ranks]
    for tag in ("fp32", "bf16", "int8"):
        for B in (256, 4096):
            key = f"{tag}/{B}"
            for rank, out in enumerate(ranks):
                if key in out["topk"]["results"]:
                    check_topk(f"sharded top-k {key}, rank {rank}",
                               out["topk"]["results"][key], topk_refs[key])
        for rank, out in enumerate(ranks):
            ln = out["topk"]["launches"][tag]
            for name in ("bin_max", "binned_rescore", "streaming_topk"):
                require(ln[name] > 0, f"sharded top-k {tag}, rank {rank}: never launched {name}")
            require(ln["bin_max"] == ln["binned_rescore"],
                    f"sharded top-k {tag}, rank {rank}: K4 and K5 launched {ln}")
    summary["topk_launches_per_rank"] = [o["topk"]["launches"] for o in ranks]
    summary["phase_s"] = time.perf_counter() - t0
    rows = {}
    for name in mesh_counters():
        rows[name] = {"launches_mesh": {
            "one_rank_nccl": one["launches_fit"][name],
            **{f"two_tower_{k}" if k != "dlrm" else "dlrm": [o["runs"][k]["launches"][name]
                                                             for o in ranks]
               for k in MESH_KINDS},
            "topk_1M": [sum(o["topk"]["launches"][t][name] for t in o["topk"]["launches"])
                        for o in ranks]}}
    return summary, rows


# phase 23: the last mesh configurations and the data plane that feeds them
BREADTH_DYN_STEPS = 4  # steps a route of 23a (the keys hashed after each)
BREADTH_DYN_ROUTES = ("adagrad", "adam", "bf16")
BREADTH_SESSION_BATCH = 1024
BREADTH_MUSIC_BATCH = TRAIN_BATCH
BREADTH_EX06_ROWS = 20_000
BREADTH_EX06_BATCH = 1024
BREADTH_EX09_ROWS = 10_000
BREADTH_EX09_RTOL = 1e-4  # the card's and the CPU's two epochs of example 09's DLRM
# (a run on an H100 read 1.53e-5)
BREADTH_KINDS = ("session", "tied", "music", "ex06")
# where each run must launch each kernel of its path
BREADTH_PATHS = {
    "dynamic_adagrad": ("row_gather", "row_scatter_add"),
    "dynamic_adam": ("row_gather", "row_scatter_add"),
    "dynamic_bf16": ("row_gather", "row_scatter_add", "row_scatter_write"),
    "session": ("lse_forward", "grad_query", "grad_neg", "row_gather", "row_scatter_add"),
    "tied": ("row_gather", "row_scatter_add"),
    "music": ("row_gather", "row_scatter_add"),
    "ex06": ("lse_forward", "grad_query", "grad_neg", "row_gather", "row_scatter_add"),
}


def sha(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def criteo_dynamic_data(n: int):
    """phase_dynamic's first day: the 26 Criteo columns as raw 31-bit ids,
    ``n`` rows, the label from C1."""
    import models_tpu_torch as mt
    from models_tpu_torch.data.synthetic import known_schema

    full = known_schema("criteo")
    schema = mt.Schema(list(full.categorical) + list(full.targets))
    cols = {c.name: criteo_raw(c.cardinality, n, SEED + 30 + i) % 2**31
            for i, c in enumerate(full.categorical)}
    cols["label"] = (cols["C1"] % 2).astype(np.float32)
    return mt.Dataset(cols, schema=schema)


def breadth_dyn_model(dev, schema, route):
    import models_tpu_torch as mt

    kw = {"param_dtype": torch.bfloat16} if route == "bf16" else {}
    model = dynamic_model(dev, schema, "label", **kw)
    if route == "adam":
        model.compile(optimizer="adam", learning_rate=ADAM_LR, metrics=[])
    else:
        model.compile(optimizer="adagrad", learning_rate=ADAGRAD_LR, metrics=[],
                      embedding_optimizer="adagrad")
    return model, [m for m in model.modules() if isinstance(m, mt.DynamicEmbeddingTable)]


class KeyDigests:
    """A fit callback and a spy on each dynamic table's map: the SHA-256 of
    every table's slots at each training call (the global batch's, on a
    mesh) and of its key buffer after each step."""

    def __init__(self, tables):
        self.tables = tables
        self.slots = {t.block_name: [] for t in tables}
        self.keys = {t.block_name: [] for t in tables}
        for t in tables:
            orig = t._map_ids

            def mapped(raw, keys, training, orig=orig, name=t.block_name):
                out = orig(raw, keys, training)
                if training:
                    self.slots[name].append(sha(out))
                return out

            t._map_ids = mapped

    def set_model(self, model):
        pass

    def on_batch_end(self, step, logs):
        for t in self.tables:
            self.keys[t.block_name].append(sha(t.hash_keys))


def breadth_fit(model, data, dev, mesh, batch, pre=None, callbacks=()) -> dict:
    """One epoch, unshuffled: the global batch's loss of each step (the mean
    over the data line of the ranks'), the kernels' launches, the
    collectives and the step times (medians of the steps after the
    first)."""
    from models_tpu_torch.parallel.collectives import TRAFFIC, all_reduce

    clock = StepClock()
    zero_mesh_counts()
    TRAFFIC.reset()
    model.fit(data, epochs=1, batch_size=batch, shuffle=False, device=dev, mesh=mesh, pre=pre,
              callbacks=[clock, *callbacks])
    torch.cuda.synchronize()
    launches, traffic = mesh_counts(), TRAFFIC.snapshot()
    losses = torch.stack(clock.losses).float()
    if mesh is not None:
        g = mesh.group("data")
        losses = all_reduce(losses, g) / g.size
    return {"loss": losses.cpu().tolist(), "launches": launches, "traffic": traffic,
            **clock.step_ms()}


def breadth_tied_model(dev, schema):
    """The session body at phase_session's width into the tied full-catalog
    ``NextItemPredictionTask(table=)``."""
    import models_tpu_torch as mt
    from models_tpu_torch.models.session import (_find_item_table, _ProjectToTableDim,
                                                 _SequenceConcat)
    from models_tpu_torch.transformer import GPT2Block

    inputs = mt.InputBlockV2(schema.excluding_by_tag(mt.Tags.TARGET), dim=128, aggregation=None,
                             seed=SEED, device=dev)
    table = _find_item_table(inputs, schema.select_by_tag(mt.Tags.ITEM_ID).first.domain_name)
    tr = GPT2Block(d_model=128, n_head=8, n_layer=2, dropout=0.0, seed=SEED).to(dev)
    tr.set_in_features(inputs.out_features, dev)
    body = mt.SequentialBlock([inputs, _SequenceConcat(), tr,
                               _ProjectToTableDim(tr.d_model, table.dim, device=dev)])
    return mt.Model(body, mt.NextItemPredictionTask(schema, table=table, device=dev))


def breadth_case(kind, dev, data):
    """(model, batch, pre) of 23b-d, compiled."""
    import models_tpu_torch as mt

    if kind in ("session", "tied"):
        model = (session_model(dev, data.schema) if kind == "session"
                 else breadth_tied_model(dev, data.schema))
        model.compile(optimizer="adam", learning_rate=ADAM_LR, metrics=[])
        return model, BREADTH_SESSION_BATCH, session_pre(data.schema)
    if kind == "music":
        model = dlrm_model(dev, data.schema)
        model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
        return model, BREADTH_MUSIC_BATCH, None
    model = mt.TwoTowerModel(data.schema, query_tower=(64, 32), embedding_dim=32, seed=SEED,
                             device=dev)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    return model, BREADTH_EX06_BATCH, None


class IdGathers:
    """A spy on the dynamic tables' all-gather of the raw ids over the data
    line: the bytes ``TRAFFIC`` counts for those calls alone, and their host
    seconds."""

    def __init__(self):
        from models_tpu_torch.inputs import dynamic

        self.module, self.orig = dynamic, dynamic.all_gather
        self.bytes, self.seconds = 0, 0.0

        def counted(t, g):
            from models_tpu_torch.parallel.collectives import TRAFFIC

            b0, s0 = TRAFFIC.bytes.get("all_gather", 0), TRAFFIC.seconds.get("all_gather", 0.0)
            out = self.orig(t, g)
            self.bytes += TRAFFIC.bytes.get("all_gather", 0) - b0
            self.seconds += TRAFFIC.seconds.get("all_gather", 0.0) - s0
            return out

        dynamic.all_gather = counted

    def close(self):
        self.module.all_gather = self.orig


class TiedBackward:
    """A spy on the tied head's backward over a split table
    (``_ShardLogits``): the bytes ``TRAFFIC`` counts in each call, by kind,
    the largest over the calls, beside the bound of one collective of the
    queries' gradient and one of the shard's (their bytes, whatever the
    catalog)."""

    def __init__(self):
        from models_tpu_torch.outputs.base import _ShardLogits
        from models_tpu_torch.parallel.collectives import TRAFFIC

        self.cls, self.orig = _ShardLogits, _ShardLogits.backward
        self.calls, self.bytes, self.bound = 0, {}, 0

        def spy(ctx, grad):
            x, shard = ctx.saved_tensors
            before = dict(TRAFFIC.bytes)
            out = self.orig(ctx, grad)
            for kind, n in TRAFFIC.bytes.items():
                if n > before.get(kind, 0):
                    self.bytes[kind] = max(self.bytes.get(kind, 0), n - before.get(kind, 0))
            self.bound = max(self.bound, (x.numel() + shard.numel()) * 4)
            self.calls += 1
            return out

        _ShardLogits.backward = staticmethod(spy)

    def close(self):
        self.cls.backward = staticmethod(self.orig)

    def record(self) -> dict:
        return {"calls": self.calls, "bytes_by_kind": self.bytes, "bound": self.bound}


def breadth_dynamic_run(route, dev, data, mesh) -> dict:
    model, tables = breadth_dyn_model(dev, data.schema, route)
    digests = KeyDigests(tables)
    ids = IdGathers()
    try:
        rec = breadth_fit(model, data, dev, mesh, TRAIN_BATCH, callbacks=[digests])
    finally:
        ids.close()
    steps = len(rec["loss"])
    rec.update(slot_sha=digests.slots, key_sha=digests.keys,
               allocated=sum(t.num_allocated for t in tables),
               id_gather_bytes_per_step=ids.bytes / steps,
               id_gather_ms_per_step=ids.seconds * 1e3 / steps)
    if route == "bf16" and mesh is not None:
        rec["shard_rows"] = max(t.table.shape[0] for t in tables)
    return rec


def breadth_kernel_checks(dev, shard_rows: int, positions: int) -> dict:
    """K1-K3, K7, K8b and K9 at a {2, 2} rank's shapes, against their plain
    versions: the flash-CE kernels at the session's Q = a rank's
    predicted positions and N = the global batch's (D = 128), the gather and
    the scatters on a shard of the largest dynamic table (D = 16) with a
    step's ids."""
    gen = torch.Generator(dev).manual_seed(SEED + 231)
    errs = {"row_scatter_add": 0.0, "row_scatter_write": 0.0, "row_gather": 0.0}
    Q, N = positions // MESH_SHAPE["data"], positions
    check_fce(f"23b session shard Q={Q} N={N}", dev,
              fce_case(dev, gen, Q, N, 128, 1.0, True, False, False), 1.0, errs)
    table = torch.randn(shard_rows, DYN_DIM, device=dev, generator=gen)
    ids = torch.randint(0, shard_rows, (TRAIN_BATCH,), device=dev, generator=gen,
                        dtype=torch.int32)
    gather_case(f"23a dynamic shard ({shard_rows} rows)", table, ids, errs)
    for dtype in (torch.float32, torch.bfloat16):
        scatter_case(dev, gen, shard_rows, DYN_DIM, TRAIN_BATCH, dtype, None, errs=errs)
    return errs


def breadth_ranks(rank, world, init, dyn_data, datas, t_spawn):
    """Phase 23, one of four ranks on the one card over MESH_BACKEND, on
    MESH_SHAPE: (a) the dynamic tables, three routes; (b) the session
    transformer with the in-batch head and with the tied full-catalog head;
    (c) the music-streaming DLRM; (d) examples/06's two-tower; then, on
    rank 0, the kernels at a rank's shapes."""
    from models_tpu_torch.parallel import initialize, make_mesh, shutdown

    marks = {"entered": time.time() - t_spawn}
    initialize(init, world, rank, backend=MESH_BACKEND, device="cuda:0", timeout=MESH_TIMEOUT)
    dev = torch.device("cuda", 0)
    try:
        mesh = make_mesh(MESH_SHAPE)
        marks["mesh"] = time.time() - t_spawn
        out = {"coords": mesh.coords, "backend": mesh.backend, "runs": {}, "marks": marks}
        shard_rows = 0
        for route in BREADTH_DYN_ROUTES:
            rec = breadth_dynamic_run(route, dev, dyn_data, mesh)
            shard_rows = rec.pop("shard_rows", shard_rows)
            out["runs"][f"dynamic_{route}"] = rec
            marks[f"dynamic_{route}"] = time.time() - t_spawn
            torch.cuda.empty_cache()
        for kind in BREADTH_KINDS:
            model, batch, pre = breadth_case(kind, dev, datas[kind])
            spy = TiedBackward() if kind == "tied" else None
            try:
                out["runs"][kind] = breadth_fit(model, datas[kind], dev, mesh, batch, pre=pre)
            finally:
                if spy is not None:
                    spy.close()
                    out["runs"][kind]["tied_backward"] = spy.record()
            marks[kind] = time.time() - t_spawn
            del model
        torch.cuda.empty_cache()
        out["kernel_errs"] = (breadth_kernel_checks(dev, shard_rows, datas["positions"])
                              if rank == 0 else {})
        marks["kernels"] = time.time() - t_spawn
        return out
    finally:
        shutdown()


def breadth_replay(dyn_data, tables) -> dict:
    """The CPU replay of the map over 23a's global batches, in order: the
    SHA-256 of each table's slots at each step and of its keys after it."""
    import models_tpu_torch as mt

    keys = {t.block_name: torch.full((t.capacity,), -1, dtype=torch.int32) for t in tables}
    out = {"slots": {t.block_name: [] for t in tables}, "keys": {t.block_name: [] for t in tables}}
    for x, _ in mt.Loader(dyn_data, TRAIN_BATCH, drop_last=True):
        for t in tables:
            raw = torch.as_tensor(x[t.features[0]]).to(torch.int32)
            slots = mt.DynamicEmbeddingTable._map_ids(t, raw, keys[t.block_name], True)
            out["slots"][t.block_name].append(sha(slots))
            out["keys"][t.block_name].append(sha(keys[t.block_name]))
    out["allocated"] = sum(int((k != -1).sum()) for k in keys.values())
    return out


def phase_example09(dev) -> dict:
    """examples/09 on the port's names: the raw log through the Workflow
    (Categorify, TargetEncoding, GroupbyCount, Bucketize, LambdaOp), the
    DLRM fit two epochs with validation and evaluated, on the card and on a
    CPU copy."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.data.workflow import (Bucketize, Categorify, GroupbyCount, LambdaOp,
                                                TargetEncoding, Workflow)

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    n = BREADTH_EX09_ROWS
    raw = mt.Dataset(
        {"userId": rng.integers(1000, 2000, n), "movieId": rng.choice([7, 11, 42, 99, 123], n),
         "rating": rng.integers(1, 6, n).astype(np.float64),
         "age": rng.integers(10, 80, n).astype(np.float32)},
        schema=mt.Schema([mt.ColumnSchema("userId", dtype="int64"),
                          mt.ColumnSchema("movieId", dtype="int64"),
                          mt.create_continuous_column("rating"),
                          mt.create_continuous_column("age")]))
    train, valid = raw.split([0.8, 0.2], seed=1)
    wf = Workflow([
        Categorify(["userId", "movieId"]),
        TargetEncoding("movieId", target="rating", kfold=5, p_smooth=20,
                       out="TE_movieId_rating", tags=mt.Tags.ITEM),
        GroupbyCount("userId", log=True, tags=mt.Tags.USER),
        Bucketize({"age": [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]}, tags=mt.Tags.USER),
        LambdaOp("rating", lambda v: (v > 3).astype("int32"), out="rating_binary",
                 tags=(mt.Tags.BINARY_CLASSIFICATION, mt.Tags.TARGET), dtype="int32"),
    ])
    train_t, valid_t = wf.fit_transform(train), wf.transform(valid)
    workflow_s = time.perf_counter() - t0
    schema = train_t.schema.excluding_by_name("rating")
    on_card = mt.DLRMModel(schema, embedding_dim=16, top_block=(32, 16), seed=SEED, device=dev)
    on_card.build(train_t, device=dev)
    on_cpu = copy.deepcopy(on_card).to("cpu")
    hist = {}
    for tag, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
        m.compile(learning_rate=0.01)
        hist[tag] = m.fit(train_t, epochs=2, batch_size=512, shuffle=False, device=d,
                          validation_data=valid_t).history
    ev = on_card.evaluate(valid_t, batch_size=512, device=dev)
    for k in ("loss", "val_loss"):
        require(all(np.isfinite(hist["card"][k])), f"23d examples/09: {k} {hist['card'][k]}")
        require(np.allclose(hist["card"][k], hist["cpu"][k], rtol=BREADTH_EX09_RTOL, atol=0),
                f"23d examples/09: {k} card {hist['card'][k]} vs CPU {hist['cpu'][k]}")
    require("rating_binary/auc" in ev and np.isfinite(ev["loss"]), f"23d examples/09: {ev}")
    dev_rel = max(float(np.max(np.abs(np.asarray(hist["card"][k]) - hist["cpu"][k])
                               / np.abs(hist["cpu"][k]))) for k in ("loss", "val_loss"))
    out = {"rows": n, "workflow_s": workflow_s, "schema": train_t.schema.column_names,
           "loss_card": hist["card"]["loss"], "loss_cpu": hist["cpu"]["loss"],
           "val_loss_card": hist["card"]["val_loss"], "max_rel_dev_card_cpu": dev_rel,
           "evaluate": {k: float(v) for k, v in ev.items()}}
    print(f"  23d examples/09: workflow {workflow_s:.2f} s, columns {out['schema']}; DLRM losses "
          f"card {out['loss_card']} / CPU {out['loss_cpu']} (max rel {dev_rel:.3g}); evaluate "
          f"{out['evaluate']}", flush=True)
    return out


def phase_breadth(dev, card, errs) -> tuple:
    """Phase 23: four ranks over MESH_BACKEND on MESH_SHAPE, each at the
    slice's full width: (a) examples/17's dynamic tables on the 26 full
    Criteo columns (39.3M rows, D = 16, raw 31-bit ids, batch 8192),
    row-sparse adagrad, dense Adam and row-sparse adagrad on bf16 tables,
    BREADTH_DYN_STEPS steps each: every rank's slots and keys, hashed at each
    step, equal to a CPU replay of the map, the losses to this process's;
    (b) the session transformer (GPT2Block(128, 8, 2), D = 128, batch 1024)
    with its in-batch head and with the tied full-catalog head; (c) dry run
    3, the multi-task DLRM on music-streaming at the bench's DLRM width; (d)
    examples/06 (get_movielens("ml-25m", num_rows=20,000) synthesized, the
    two-tower (64, 32) at dim 32, batch 1024, adagrad 0.05 as the example
    compiles it but without its top-k metrics, so that every step takes the
    fused head, K1-K3), each held to this process's
    trajectory at MESH_RTOL. Before the ranks start, this process runs those
    references, the replay and examples/09's workflow into a DLRM on the
    card, held to a CPU copy. Times labelled MESH_LABEL."""
    import models_tpu_torch as mt
    from models_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    dyn_data = criteo_dynamic_data(BREADTH_DYN_STEPS * TRAIN_BATCH)
    seq = mt.generate_data("sequence-testing", num_rows=MESH_STEPS * BREADTH_SESSION_BATCH,
                           seed=SEED + 23)
    datas = {"session": seq, "tied": seq,
             "music": mt.generate_data("music-streaming", num_rows=MESH_STEPS
                                       * BREADTH_MUSIC_BATCH, seed=SEED + 24),
             "ex06": mt.data.datasets.get_movielens(variant="ml-25m",
                                                    num_rows=BREADTH_EX06_ROWS)[0]}
    x, _ = next(iter(mt.Loader(seq, BREADTH_SESSION_BATCH)))
    pre = session_pre(seq.schema)
    from models_tpu_torch.core.types import to_device_batch

    _, y = mt.Model._apply_pre(pre, to_device_batch(x, "cpu"), None, training=True)
    datas["positions"] = int(next(iter(y.values())).values.numel()
                             if isinstance(y, dict) else y.values.numel())
    data_s = time.perf_counter() - t0
    # the one-process references, the CPU replay and examples/09 first, so
    # that the ranks' times are taken with no fifth process on the card
    refs = {}
    replay = None
    for route in BREADTH_DYN_ROUTES:
        model, tables = breadth_dyn_model(dev, dyn_data.schema, route)
        if replay is None:
            replay = breadth_replay(dyn_data, tables)
            capacity = sum(t.capacity for t in tables)
        refs[f"dynamic_{route}"] = breadth_fit(model, dyn_data, dev, None, TRAIN_BATCH)
        del model, tables
        torch.cuda.empty_cache()
    for kind in BREADTH_KINDS:
        model, batch, pre_k = breadth_case(kind, dev, datas[kind])
        refs[kind] = breadth_fit(model, datas[kind], dev, None, batch, pre=pre_k)
        del model
    torch.cuda.empty_cache()
    stamp("  23: one-process references and the CPU replay done")
    ex09 = phase_example09(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stamp("  23: examples/09 done; the four ranks start")
    t_spawn = time.time()
    try:
        ranks = spawn(breadth_ranks, 4, (dyn_data, datas, t_spawn), timeout=2 * MESH_TIMEOUT)
    except RuntimeError as err:
        raise AssertionError(f"phase 23 failed: {err}") from err
    wall = time.time() - t_spawn
    stamp(f"  23 joined, {wall:.1f} s after the spawn; rank 0 (s after the spawn): "
          f"{ranks[0]['marks']}")
    summary = {"label": MESH_LABEL, "backend": MESH_BACKEND, "card": card, "shape": MESH_SHAPE,
               "data_s": data_s, "ranks_s": wall, "rank0_marks_s": ranks[0]["marks"],
               "examples09": ex09, "dynamic_table_rows": capacity,
               "session_positions": datas["positions"]}
    for name in [f"dynamic_{r}" for r in BREADTH_DYN_ROUTES] + list(BREADTH_KINDS):
        ref = refs[name]
        for rank, out in enumerate(ranks):
            rec = out["runs"][name]
            require(out["backend"] == MESH_BACKEND, f"23 rank {rank}: backend {out['backend']}")
            require(len(rec["loss"]) == len(ref["loss"]) and all(np.isfinite(rec["loss"])),
                    f"23 {name}, rank {rank}: losses {rec['loss']}")
            require(np.allclose(rec["loss"], ref["loss"], rtol=MESH_RTOL, atol=0),
                    f"23 {name}, rank {rank}: losses {rec['loss']}, one process {ref['loss']}")
            for kernel in BREADTH_PATHS[name]:
                require(rec["launches"][kernel] > 0,
                        f"23 {name}, rank {rank}: the mesh path never launched {kernel}")
            if name.startswith("dynamic_"):
                for tname, want in replay["slots"].items():
                    require(rec["slot_sha"][tname] == want,
                            f"23a {name}, rank {rank}, {tname}: slots differ from the CPU replay")
                    require(rec["key_sha"][tname] == replay["keys"][tname],
                            f"23a {name}, rank {rank}, {tname}: keys differ from the CPU replay "
                            "after some step")
                require(rec["allocated"] == replay["allocated"],
                        f"23a {name}, rank {rank}: {rec['allocated']} slots allocated, the "
                        f"replay {replay['allocated']}")
            if name == "tied":
                tb = rec["tied_backward"]
                require(tb["calls"] == len(rec["loss"]),
                        f"23b tied, rank {rank}: {tb['calls']} backward calls of the split "
                        f"head in {len(rec['loss'])} steps")
                require("all_gather" not in tb["bytes_by_kind"]
                        and sum(tb["bytes_by_kind"].values()) <= tb["bound"],
                        f"23b tied, rank {rank}: the split head's backward moved "
                        f"{tb['bytes_by_kind']}, beyond one all-reduce of the queries' and "
                        f"one of the shard's gradient ({tb['bound']} B)")
        r0 = ranks[0]["runs"][name]
        if name == "tied":
            print(f"  23b tied: the split head's backward, rank 0, largest a call by kind "
                  f"{r0['tied_backward']['bytes_by_kind']} B, bound {r0['tied_backward']['bound']}"
                  " B (the queries' and the shard's gradients)", flush=True)
        summary[name] = {
            "loss_rank0": r0["loss"], "loss_one_process": ref["loss"],
            "max_rel_dev": max(float(np.max(np.abs(np.asarray(o["runs"][name]["loss"])
                                                   - ref["loss"]) / np.abs(ref["loss"])))
                               for o in ranks),
            "launches_per_rank": [o["runs"][name]["launches"] for o in ranks],
            "largest_collective_bytes": [o["runs"][name]["traffic"]["max_bytes"]
                                         for o in ranks],
            "largest_by_kind_rank0": r0["traffic"]["largest"],
            "bytes_by_kind_rank0": r0["traffic"].get("bytes"),
            "step_host_ms_per_rank": [o["runs"][name]["host_ms"] for o in ranks],
            "step_events_ms_per_rank": [o["runs"][name]["events_ms"] for o in ranks],
            "collective_ms_per_step_per_rank": [o["runs"][name]["collective_ms"]
                                                for o in ranks],
            "one_process_step_host_ms": ref["host_ms"],
            "one_process_step_events_ms": ref["events_ms"]}
        if name == "tied":
            summary[name]["split_head_backward_rank0"] = r0["tied_backward"]
        if name.startswith("dynamic_"):
            summary[name]["allocated"] = r0["allocated"]
            # the ids each rank gathers over its data line to agree on the
            # keys, as TRAFFIC counted them (mean of the steps)
            summary[name]["id_gather_bytes_per_step"] = r0["id_gather_bytes_per_step"]
            summary[name]["id_gather_host_ms_per_step"] = r0["id_gather_ms_per_step"]
            require(r0["id_gather_bytes_per_step"] > 0,
                    f"23a {name}: the ranks gathered no ids over the data line")
            summary[name]["steps_keys_checked"] = len(next(iter(r0["key_sha"].values())))
        print(f"  23 {name} on {MESH_SHAPE} ({MESH_LABEL}): losses rank 0 {r0['loss']} / one "
              f"process {ref['loss']} (max rel {summary[name]['max_rel_dev']:.3g}), largest "
              f"collective {r0['traffic']['max_bytes']} B ({r0['traffic']['max_kind']}), step "
              f"{r0['host_ms']:.1f} ms host / {r0['events_ms']:.1f} ms events, collectives "
              f"{r0['collective_ms']:.1f} ms a step (medians after the first); one process "
              f"{ref['host_ms']:.1f} ms", flush=True)
    print(f"  23a: every rank's slots and keys of the 26 tables equal to the CPU replay at each "
          f"of {BREADTH_DYN_STEPS} steps, in each route; {replay['allocated']} slots "
          "allocated", flush=True)
    print("  23a: the raw ids' all-gather over the data line, rank 0, a step: "
          + ", ".join(f"{r} {summary[f'dynamic_{r}']['id_gather_bytes_per_step']:.0f} B / "
                      f"{summary[f'dynamic_{r}']['id_gather_host_ms_per_step']:.1f} ms"
                      for r in BREADTH_DYN_ROUTES), flush=True)
    k_errs = ranks[0]["kernel_errs"]
    for key, err in k_errs.items():
        errs[key] = max(errs.get(key, 0.0), err)
    summary["kernel_errs_rank0"] = k_errs
    summary["phase_s"] = time.perf_counter() - t0
    names = [f"dynamic_{r}" for r in BREADTH_DYN_ROUTES] + list(BREADTH_KINDS)
    rows = {kernel: {f"23_{name}": [o["runs"][name]["launches"][kernel] for o in ranks]
                     for name in names}
            for kernel in mesh_counters()}
    return summary, rows


PARQUET_ROWS = 262_144  # movielens-25m rows written and trained on: 32 batches of 8192
PARQUET_GROUP = 20_000  # rows a row group: chunks do not align with batches
PARQUET_PARTS = 4
PARQUET_SESSION_ROWS = 16_384
PARQUET_TIMING_ROWS = 4_194_304  # the write / read timing's rows (the 262,144 tiled)
PARQUET_SPE = 8


def column_bytes(cols: dict) -> int:
    """The bytes a table's values hold: numbers as stored, strings as their
    UTF-8."""
    total = 0
    for v in cols.values():
        if v.dtype == object or v.dtype.kind == "U":
            total += sum(len(x.encode()) for x in v.tolist() if x is not None)
        else:
            total += v.nbytes
    return total


def same_table(got: dict, want: dict, what: str) -> None:
    """Every column bit-equal: the same names, numbers of the same dtype and
    bytes, strings equal."""
    require(sorted(got) == sorted(want), f"{what}: columns {sorted(got)} / {sorted(want)}")
    for k, w in want.items():
        g = got[k]
        if w.dtype == object or w.dtype.kind == "U":
            require(g.dtype == object and g.tolist() == w.tolist(), f"{what}: {k} differs")
        else:
            require(g.dtype == w.dtype and np.ascontiguousarray(g).view(np.uint8).tobytes()
                    == np.ascontiguousarray(w).view(np.uint8).tobytes(),
                    f"{what}: {k} ({g.dtype} / {w.dtype}) differs")


def parquet_fit(dev, schema, data, what, spe=1):
    """A fresh seeded two-tower model at the bench's width fit one epoch of
    ``data`` (a Dataset or a Loader) in batches of 8192, deterministic
    algorithms on: (history, model, launches its wrappers counted, ms a
    step on the host clock)."""
    import models_tpu_torch as mt

    model = mt.TwoTowerModel(schema, query_tower=(256, 128), embedding_dim=128, seed=SEED,
                             device=dev)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[], steps_per_execution=spe)
    with deterministic(True):
        zero_route_launches()
        t = time.perf_counter()
        hist = model.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    steps = PARQUET_ROWS // TRAIN_BATCH
    require(all(np.isfinite(hist.history["loss"])), f"{what}: loss {hist.history['loss']}")
    return hist.history, model, route_launches(), wall / steps * 1e3


def phase_parquet(dev, card) -> tuple:
    """The data plane from files on the card's host (no pyarrow): the
    port's ``to_parquet`` writes PARQUET_ROWS rows of movielens-25m
    (PARQUET_PARTS files in row groups of PARQUET_GROUP) and
    PARQUET_SESSION_ROWS of sequence-testing (list columns); ``Dataset(path)``
    reads every column back bit for bit; the C++ batcher pads the list
    columns bit-equal to its numpy version; the two-tower model at the
    bench's width trains 32 steps from the files one step at a time through
    a streaming ``Loader(shuffle=False, prefetch=2, cache=False)`` (and with
    ``prefetch=0``) and 32 steps at ``steps_per_execution=8`` from
    ``dense_columns`` over the files (K9, K1-K3), each bit-equal to the same
    fit from the Dataset in memory (deterministic algorithms on); then the
    write and read times at PARQUET_TIMING_ROWS rows and the loader's host
    ms a batch uncached and cached. Returns the numbers and the kernels'
    launches on the two routes."""
    import shutil
    import tempfile

    import models_tpu_torch as mt
    from models_tpu_torch.data import native, parquet
    from models_tpu_torch.data.dataset import take_rows

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_parquet_")
    out = {"card": card}
    try:
        ml = mt.generate_data("movielens-25m", num_rows=PARQUET_ROWS, seed=SEED + 30)
        sess = mt.generate_data("sequence-testing", num_rows=PARQUET_SESSION_ROWS,
                                seed=SEED + 31)
        out["data_s"] = time.perf_counter() - t_phase
        ml_path = ml.to_parquet(os.path.join(root, "ml"), row_group_size=PARQUET_GROUP,
                                num_partitions=PARQUET_PARTS)
        sess_path = sess.to_parquet(os.path.join(root, "sess"), row_group_size=PARQUET_GROUP)
        files = mt.Dataset(ml_path)
        require(len(files.files) == PARQUET_PARTS and files.num_rows == PARQUET_ROWS,
                f"parquet: {files.files} hold {files.num_rows} rows")
        require(files.schema.to_dict() == ml.schema.to_dict(), "parquet: schema sidecar")
        same_table(files.table(), ml.table(), "movielens-25m round trip")
        sess_back = mt.Dataset(sess_path)
        same_table(sess_back.table(), sess.table(), "sequence-testing round trip")
        groups = sum(parquet.ParquetFile(f).num_row_groups for f in files.files)
        print(f"  round trip bit-equal: {PARQUET_ROWS} movielens-25m rows in "
              f"{PARQUET_PARTS} files, {groups} row groups; {PARQUET_SESSION_ROWS} "
              f"sequence-testing rows", flush=True)

        padded = 0
        for ds, back in ((ml, files), (sess, sess_back)):
            cols = back.table()
            for col in ds.schema:
                if not col.is_list:
                    continue
                vals, offs = cols[col.name + "__values"], cols[col.name + "__offsets"]
                L = max(col.max_seq_length, 1)
                got, mask = native.pad_ragged(vals, offs, L)
                want, wmask = native.plain_pad_ragged(vals, offs, L)
                require(got.dtype == want.dtype and np.array_equal(got, want)
                        and np.array_equal(mask, wmask), f"pad_ragged on {col.name}")
                padded += 1
        out["pad_ragged_columns_bit_equal"] = padded
        print(f"  pad_ragged (C++) bit-equal to numpy on {padded} list columns", flush=True)

        memory = mt.Dataset(ml.table(), schema=ml.schema)
        runs = {}  # the first fit warms the process up; "memory" is the second
        runs["memory_first"] = parquet_fit(dev, ml.schema, memory, "in-memory fit, first")
        for prefetch in (2, 0):
            loader = mt.Loader(ml_path, TRAIN_BATCH, shuffle=False, drop_last=True,
                               prefetch=prefetch, cache=False)
            require(len(loader._chunk_list()) == groups, "parquet: the loader's chunks")
            runs[f"stream_prefetch{prefetch}"] = parquet_fit(dev, ml.schema, loader,
                                                             f"streaming fit, prefetch={prefetch}")
        with batches_in_line():  # the device prefetch's control: each batch copied in line
            loader = mt.Loader(ml_path, TRAIN_BATCH, shuffle=False, drop_last=True, prefetch=2,
                               cache=False)
            runs["stream_prefetch2_in_line"] = parquet_fit(
                dev, ml.schema, loader, "streaming fit, prefetch=2, batches copied in line")
        runs["memory"] = parquet_fit(dev, ml.schema, memory, "in-memory fit")
        h0, m0, _, _ = runs["memory_first"]
        for name in ("stream_prefetch2", "stream_prefetch0", "stream_prefetch2_in_line",
                     "memory"):
            h, m, ln, _ = runs[name]
            require(h["loss"] == h0["loss"], f"{name}: losses {h['loss']} / {h0['loss']}")
            require(same_params(m, m0), f"{name}: parameters differ from the in-memory fit: "
                    f"{param_spread(m, m0)}")
        stream_ln = runs["stream_prefetch2"][2]
        steps = PARQUET_ROWS // TRAIN_BATCH
        for k in ("lse_forward", "grad_query", "grad_neg"):
            require(stream_ln[k] == steps, f"streaming fit: {k} launched {stream_ln[k]} times")
        out["ms_per_step"] = {name: run[3] for name, run in runs.items()}
        print(f"  streaming fits bit-equal to the in-memory fit over {steps} steps; ms a step "
              f"(host clock, deterministic algorithms): {json.dumps(out['ms_per_step'])}; "
              f"{card}", flush=True)

        chunked = {}
        for name, data in (("memory", mt.Dataset(ml.table(), schema=ml.schema)),
                           ("files", mt.Dataset(ml_path))):
            chunked[name] = parquet_fit(dev, ml.schema, data, f"chunked fit from {name}",
                                        spe=PARQUET_SPE)
            require(getattr(data, "_device_train_pack", None) is not None,
                    f"chunked fit from {name}: no device pack")
        (hm, mm_, _, _), (hf, mf, chunk_ln, chunk_ms) = chunked["memory"], chunked["files"]
        require(hf["loss"] == hm["loss"], f"chunked fits: losses {hf['loss']} / {hm['loss']}")
        require(same_params(mf, mm_), f"chunked fits differ: {param_spread(mf, mm_)}")
        for k in ("lse_forward", "grad_query", "grad_neg", "row_gather"):
            require(chunk_ln[k] > 0, f"chunked fit from files: {k} never launched")
        out["chunked_ms_per_step"] = {"memory": chunked["memory"][3], "files": chunk_ms}
        print(f"  chunked fits (k = {PARQUET_SPE}) from files and memory bit-equal; launches "
              f"{chunk_ln}; ms a step {json.dumps(out['chunked_ms_per_step'])}", flush=True)
        del runs, chunked, m0, mf, mm_
        torch.cuda.empty_cache()

        loader = mt.Loader(ml_path, TRAIN_BATCH, shuffle=True, prefetch=0)
        per_epoch = []
        for _ in range(2):
            t = time.perf_counter()
            n = sum(1 for _ in loader)
            per_epoch.append((time.perf_counter() - t) / n * 1e3)
        require(len(loader._file_cache) == groups, "the loader's cache")
        out["loader_host_ms_per_batch"] = {"uncached": per_epoch[0], "cached": per_epoch[1],
                                           "batches": n, "prefetch": 0}
        print(f"  loader, host ms a batch of {TRAIN_BATCH}: "
              f"{json.dumps(out['loader_host_ms_per_batch'])}", flush=True)

        cols = ml.table()
        big = take_rows(cols, np.tile(np.arange(PARQUET_ROWS), PARQUET_TIMING_ROWS // PARQUET_ROWS))
        nbytes = column_bytes(big)
        big_path = os.path.join(root, "big.parquet")
        t = time.perf_counter()
        parquet.write_table(big, big_path)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        back = parquet.read_table(big_path)
        read_s = time.perf_counter() - t
        require(parquet.table_rows(back) == PARQUET_TIMING_ROWS, "the timing file's rows")
        out["io"] = {"rows": PARQUET_TIMING_ROWS, "column_bytes": nbytes,
                     "file_bytes": os.path.getsize(big_path), "write_s": write_s,
                     "read_s": read_s, "write_mb_per_s": nbytes / write_s / 1e6,
                     "read_mb_per_s": nbytes / read_s / 1e6, "read": "warm (page cache)"}
        print(f"  {PARQUET_TIMING_ROWS} rows: {json.dumps(out['io'])}; {card}", flush=True)
        out["launches"] = {"stream": {k: stream_ln[k] for k in ("lse_forward", "grad_query",
                                                                "grad_neg", "row_gather")},
                           "chunked": {k: chunk_ln[k] for k in ("lse_forward", "grad_query",
                                                                "grad_neg", "row_gather")}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, out["launches"]


# the side stacks (phase 25)
SIDE_TRAIN_ROWS = 3 * TRAIN_BATCH  # three steps an epoch, two epochs
SIDE_EVAL_ROWS = 2 * TRAIN_BATCH  # evaluate_retrieval: two batches of 8192 (K6)
SIDE_SERVE = 256  # rows a served request (K5)
SIDE_LOSS_RTOL = 1e-5  # card vs CPU epoch losses (fp32 sums in another order, Adam;
#                        sound runs read 3.5e-8 to 5.9e-8 on the H100)
SIDE_PRED_RTOL = 1e-4  # card vs CPU predictions of the same weights, of the largest


def _close(got, want, rtol: float, what: str) -> float:
    """The largest deviation of ``got`` from ``want`` relative to the largest
    |want|; raises above ``rtol``."""
    got, want = (torch.as_tensor(np.asarray(a, np.float64)) for a in (got, want))
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"{what}: shapes or non-finite")
    dev = rel_err(got, want)
    require(dev <= rtol, f"{what}: deviation {dev:.3g} > {rtol}")
    return dev


def _run_example(name: str, rows: dict) -> dict:
    """``examples/<name>`` with ``models_tpu`` read as ``models_tpu_torch``,
    its ``num_rows`` replaced by ``rows``; returns its globals."""
    import re

    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                            name)).read()
    for old, new in rows.items():
        src = src.replace(old, new)
    scope = {"__name__": "__side_example__"}
    exec(compile(re.sub(r"\bmodels_tpu\b", "models_tpu_torch", src), name, "exec"), scope)
    return scope


def phase_side(dev, card) -> tuple:
    """The side stacks on the card (docstring item 18c). Returns the numbers
    and each kernel's launches on the side two-tower path."""
    import copy

    import models_tpu_torch as mt
    import models_tpu_torch.torch_backend as tb
    from models_tpu_torch.ops.topk import ids_agree
    from models_tpu_torch.utils.io import cpu_copy

    t_phase = time.perf_counter()
    out = {"card": card}
    cpu = torch.device("cpu")
    schema = mt.generate_data("movielens-25m", num_rows=1).schema
    cat = mt.generate_data("movielens-25m", num_rows=CATALOG, seed=SEED + 41).to_numpy_dict()
    cat["movieId"] = np.arange(CATALOG, dtype=np.int32)  # every item once
    catalog = mt.Dataset(cat, schema=schema)
    train = mt.generate_data("movielens-25m", num_rows=SIDE_TRAIN_ROWS, seed=SEED + 42)
    evalset = mt.generate_data("movielens-25m", num_rows=SIDE_EVAL_ROWS, seed=SEED + 43)
    serve_x, _ = mt.Loader(evalset, SIDE_SERVE).peek()

    def two_tower(where):  # the constructor on each device, the same seeded draws
        torch.manual_seed(SEED)
        return tb.TwoTowerModel(schema, dim=128, query_block=(256, 128), embedding_dim=128,
                                device=where)

    card_m, cpu_m = two_tower(dev), two_tower(cpu)
    for (name, a), b in zip(card_m.state_dict().items(), cpu_m.state_dict().values()):
        require(torch.equal(a.cpu(), b), f"side two-tower: {name} differs at construction")

    zero_mesh_counts()
    t = time.perf_counter()
    hist = card_m.fit(train, epochs=2, batch_size=TRAIN_BATCH, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    def serve_batch(recommender, x):
        with torch.no_grad():
            return recommender(x)

    def serve(recommender):
        return serve_batch(recommender, serve_x)

    rec = card_m.to_top_k_recommender(catalog, k=K, batch_size=TRAIN_BATCH, device=dev)
    scores, ids = serve(rec)
    metrics = card_m.evaluate_retrieval(evalset, candidate_data=catalog, k=K,
                                        batch_size=TRAIN_BATCH, device=dev)
    torch.cuda.synchronize()
    launches = mesh_counts()
    for name in ("bin_max", "binned_rescore", "streaming_topk"):
        require(launches[name] >= 1, f"the side two-tower path never launched {name}")
    require(launches["bin_max"] == launches["binned_rescore"],
            f"the side two-tower path: K4 and K5 launched {launches}")
    print(f"  side two-tower path launches {launches}", flush=True)

    cpu_hist = cpu_m.fit(train, epochs=2, batch_size=TRAIN_BATCH, device=cpu)
    out["two_tower_loss"] = {"card": hist["loss"], "cpu": cpu_hist["loss"]}
    out["two_tower_loss_rel_dev"] = _close(hist["loss"], cpu_hist["loss"], SIDE_LOSS_RTOL,
                                           "side two-tower losses")
    # serving and evaluation against a CPU copy of the card's trained weights
    served_cpu = copy.deepcopy(card_m).to(cpu)
    cpu_rec = served_cpu.to_top_k_recommender(catalog, k=K, batch_size=TRAIN_BATCH, device=cpu)
    cs, ci = serve(cpu_rec)
    tol = tol_for(cs)
    require(ids_agree(scores.cpu(), ids.cpu(), cs, ci, tol),
            "side two-tower: the card's served top-10 against the CPU copy's (scores "
            f"{float((scores.cpu() - cs).abs().max()):.3g} apart, tol {tol:.3g})")
    out["served_ids_agree"] = True
    out["served_ids_equal_share"] = float((ids.cpu() == ci).float().mean())
    # evaluate_retrieval's K6 held at its own shapes: the same recommender driven
    # over the same 8192-row batches, each batch's top-10 against the CPU copy's
    zero_mesh_counts()
    eval_agree = []
    for x, _ in mt.Loader(evalset, TRAIN_BATCH):
        (gs, gi), (ws, wi) = serve_batch(rec, x), serve_batch(cpu_rec, x)
        gs, gi = gs.cpu(), gi.cpu()
        tol = tol_for(ws)
        require(ids_agree(gs, gi, ws, wi, tol),
                f"side two-tower: the card's top-{K} of an 8192-row evaluate_retrieval batch "
                f"against the CPU copy's (scores {float((gs - ws).abs().max()):.3g} apart, "
                f"tol {tol:.3g})")
        eval_agree.append(float((gi == wi).float().mean()))
    checked = mesh_counts()
    require(checked["streaming_topk"] == len(eval_agree)
            and checked["binned_rescore"] == checked["bin_max"] == 0,
            f"the 8192-row batches took another route than K6: {checked}")
    out["eval_batches_ids_equal_share"] = eval_agree
    cpu_metrics = served_cpu.evaluate_retrieval(evalset, candidate_data=catalog, k=K,
                                                batch_size=TRAIN_BATCH, device=cpu)
    for key, value in metrics.items():
        require(np.isfinite(value), f"side evaluate_retrieval {key}: {value}")
    out["evaluate_retrieval"] = {"card": metrics, "cpu": cpu_metrics}
    print(f"  side two-tower: losses {json.dumps(out['two_tower_loss'])}, largest relative "
          f"deviation {out['two_tower_loss_rel_dev']:.3g}; served top-{K} agree (ids equal "
          f"{out['served_ids_equal_share']:.4f}); evaluate_retrieval's 8192-row batches agree "
          f"(ids equal {out['eval_batches_ids_equal_share']}); evaluate_retrieval card "
          f"{json.dumps(metrics)}, CPU copy {json.dumps(cpu_metrics)}",
          flush=True)

    steps = 2 * (SIDE_TRAIN_ROWS // TRAIN_BATCH)
    t = time.perf_counter()
    card_m.fit(train, epochs=1, batch_size=TRAIN_BATCH, device=dev)
    torch.cuda.synchronize()
    out["times"] = {
        "step_ms_first_fit": fit_s / steps * 1e3,
        "step_ms": (time.perf_counter() - t) / (SIDE_TRAIN_ROWS // TRAIN_BATCH) * 1e3,
        "served_256_ms": host_ms(lambda: serve(rec)),
        "to_top_k_recommender_ms": host_ms(lambda: card_m.to_top_k_recommender(
            catalog, k=K, batch_size=TRAIN_BATCH, device=dev), reps=3),
        "evaluate_retrieval_8192_ms": host_ms(lambda: card_m.evaluate_retrieval(
            evalset, candidate_data=catalog, k=K, batch_size=TRAIN_BATCH, device=dev), reps=3),
        "clock": "host, each call ending in a synchronise; [median, min, max] where a list",
    }
    print(f"  side two-tower times {json.dumps(out['times'])}; {card}", flush=True)
    del card_m, cpu_m, served_cpu, rec, cpu_rec
    torch.cuda.empty_cache()

    # the side DLRM, card vs a CPU copy of the same weights
    criteo = mt.generate_data("criteo-small", num_rows=4 * TRAIN_BATCH, seed=SEED + 44)
    torch.manual_seed(SEED)
    dlrm = tb.DLRMModel(criteo.schema, dim=64, bottom_block=(256, 128), top_block=(256, 128),
                        device=dev)
    dlrm_cpu = copy.deepcopy(dlrm).to(cpu)
    h = dlrm.fit(criteo, epochs=1, batch_size=TRAIN_BATCH, learning_rate=1e-3, device=dev)
    hc = dlrm_cpu.fit(criteo, epochs=1, batch_size=TRAIN_BATCH, learning_rate=1e-3,
                      device=cpu)
    out["dlrm_loss"] = {"card": h["loss"], "cpu": hc["loss"],
                        "rel_dev": _close(h["loss"], hc["loss"], SIDE_LOSS_RTOL,
                                          "side DLRM losses")}
    pc = dlrm.predict(criteo, batch_size=TRAIN_BATCH, device=dev)
    pcc = copy.deepcopy(dlrm).to(cpu).predict(criteo, batch_size=TRAIN_BATCH, device=cpu)
    out["dlrm_predict_rel_dev"] = _close(pc["label"], pcc["label"], SIDE_PRED_RTOL,
                                         "side DLRM predictions")
    print(f"  side DLRM: {json.dumps(out['dlrm_loss'])}, predictions of the trained weights "
          f"within {out['dlrm_predict_rel_dev']:.3g}", flush=True)
    del dlrm, dlrm_cpu

    # the side session transformer, card vs a CPU copy of the same weights
    seq = mt.generate_data("sequence-testing", num_rows=4096, seed=SEED + 45)
    torch.manual_seed(SEED)
    sess = tb.SessionTransformerModel(seq.schema, d_model=64, n_head=4, n_layer=2, device=dev)
    sess_cpu = copy.deepcopy(sess).to(cpu)
    pre = tb.TabularPredictNext(seq.schema, "item_id_seq")
    h = sess.fit(seq, epochs=2, batch_size=512, pre=pre, device=dev)
    hc = sess_cpu.fit(seq, epochs=2, batch_size=512, pre=pre, device=cpu)
    out["session_loss"] = {"card": h["loss"], "cpu": hc["loss"],
                           "rel_dev": _close(h["loss"], hc["loss"], SIDE_LOSS_RTOL,
                                             "side session losses")}
    s1, i1 = sess.predict_next(seq, k=K, device=dev)
    s2, i2 = copy.deepcopy(sess).to(cpu).predict_next(seq, k=K, device=cpu)
    require(ids_agree(s1, i1, s2, i2, SIDE_PRED_RTOL * max(1.0, float(np.abs(s2).max()))),
            "side session predict_next: card against the CPU copy")
    print(f"  side session transformer: {json.dumps(out['session_loss'])}; predict_next "
          "agrees with the CPU copy", flush=True)
    del sess, sess_cpu

    # examples/05 (the JAX package's session transformer) and examples/10 (the
    # side backend) on the port's names, at their sizes
    zero_mesh_counts()
    t = time.perf_counter()
    ex05 = _run_example("05_session_based_transformer.py", {})
    torch.cuda.synchronize()
    # counted, not required: the example compiles the default metrics, fed on
    # every step, so its steps read the logits and take the unfused CE
    ex05_launches = mesh_counts()
    model, data = ex05["model"], ex05["data"]
    probe = data.take(512)
    pa = model.predict(probe, batch_size=256, device=dev)
    pb = cpu_copy(model).predict(probe, batch_size=256, device=cpu)
    out["example_05"] = {"s": time.perf_counter() - t, "launches": ex05_launches,
                         "predict_rel_dev": _close(pa, pb, SIDE_PRED_RTOL,
                                                   "examples/05 predictions")}
    del ex05, model
    t = time.perf_counter()
    ex10 = _run_example("10_torch_backend.py", {})
    dcn, custom, valid = ex10["model"], ex10["custom"], ex10["valid"]
    devs = {}
    for tag, m in (("dcn", dcn), ("custom", custom)):
        pa = m.predict(valid, batch_size=512, device=dev)
        pb = copy.deepcopy(m).to(cpu).predict(valid, batch_size=512, device=cpu)
        devs[tag] = max(_close(pa[k], pb[k], SIDE_PRED_RTOL, f"examples/10 {tag} {k}")
                        for k in pb)
    out["example_10"] = {"s": time.perf_counter() - t, "predict_rel_dev": devs,
                         "evaluate": dcn.evaluate(valid, batch_size=512, device=dev)}
    del ex10, dcn, custom
    torch.cuda.empty_cache()
    print(f"  examples/05 and 10 on the port's names: {json.dumps(out['example_05'])} "
          f"{json.dumps(out['example_10'])}", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches


def main() -> int:
    from models_tpu_torch.ops import kernels
    from models_tpu_torch.ops import topk as T

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(SEED)

    t = time.perf_counter()
    kernels.build()
    print(f"kernels built in {time.perf_counter() - t:.1f} s", flush=True)
    for name, log in kernels.build_logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {regs}", flush=True)
    # the tensor-core kernels in full: each kernel's registers, static shared
    # memory and spills
    for name in ("flash_ce", "streaming_topk", "row_scatter", "binned_rescore", "bin_max"):
        for ln in kernels.build_logs.get(name, "").splitlines():
            if ("entry function" in ln or "Used" in ln or "spill" in ln
                    or "wgmma" in ln or "warning" in ln.lower()):
                print(f"    {name} ptxas: {ln.split(':', 1)[-1].strip()}", flush=True)
    from models_tpu_torch.ops import flash_ce as F

    require(F.DMAX == F._lib().flash_ce_dmax(),
            f"flash_ce.DMAX {F.DMAX} is not the kernels' {F._lib().flash_ce_dmax()}")
    for form, bf16 in (("fp32", 0), ("bf16", 1)):
        print(f"    flash_ce grad_rows and lse_partial dynamic shared memory (bytes), {form} "
              f"forms, at D = 64, 128, 256: "
              f"{[F._lib().flash_ce_grad_smem(d, bf16) for d in (64, 128, 256)]}", flush=True)
    print(f"    flash_ce grad_wg (bf16 K2 / K3) and lse_wg (bf16 K1) dynamic shared memory "
          f"(bytes) at D = 64, 128: {[F._lib().flash_ce_grad_wg_smem(d) for d in (64, 128)]}, "
          f"{[F._lib().flash_ce_lse_wg_smem(d) for d in (64, 128)]}", flush=True)
    for dtype, B, k in ((torch.float32, 4096, K), (torch.bfloat16, 4096, K),
                        (torch.int8, 4096, K), (torch.float32, 256, 600),
                        (torch.float32, 8, 5000)):
        print(f"    streaming_topk launch at B={B} C={CATALOG} D=128 k={k} {dtype}: "
              f"{T.streaming_plan(dtype, B, 128, CATALOG, k)}", flush=True)
    for dtype, B, L, D in ((torch.float32, 256, 886, 128), (torch.bfloat16, 256, 886, 128),
                           (torch.int8, 256, 886, 128), (torch.float32, 256, 15_625, 128),
                           (torch.int8, 256, 15_625, 128), (torch.bfloat16, 1024, 2**18, 128),
                           (torch.float32, 256, 886, 64), (torch.float32, 256, 886, 32),
                           (torch.float32, 100, 886, 130)):
        print(f"    bin_max (K4) launch at B={B} L={L} bins of 64 D={D} {dtype}: "
              f"{T.bin_max_plan(dtype, B, D, L)}", flush=True)

    stamp("phase 1: kernels against their plain versions")
    errs = phase_kernels(dev, gen)
    errs.update(lse_forward=0.0, grad_query=0.0, grad_neg=0.0)
    phase_flash_ce(dev, gen, errs)
    phase_flash_ce_bf16(dev, gen, errs)
    phase_row_scatter(dev, gen, errs)
    phase_gather(dev, gen, errs)
    phase_int8_kernels(dev, gen, errs)
    phase_bin_max(dev, gen, errs)

    stamp("phase 2: serving")
    model, catalog, queries = build_model(dev)
    zero_topk_counts()
    t = time.perf_counter()
    results, timing = phase_serving(dev, model, catalog, queries)
    torch.cuda.synchronize()
    launches = topk_counts("the fp32 and bf16 serving path")
    print(f"  served in {time.perf_counter() - t:.1f} s, launches {launches}", flush=True)
    for name, n in launches.items():
        require(n > 0, f"the serving path never launched {name}")
    check_serving(dev, model, queries, results)
    enc8, int8_launches, timing["index_int8_ms"], q4096 = phase_serving_int8(
        dev, model, catalog, queries)
    for name, n in int8_launches.items():
        require(n > 0, f"the int8 serving path never launched {name}")
    stamp("phase 2b: top-k at k = 600 (K6), fp32 and int8 indexes, card vs CPU")
    large_k_launches = phase_large_k(dev, model, queries,
                                     results[("fp32", 256)][0].blocks[-1].topk_layer,
                                     enc8.blocks[-1].topk_layer)
    print(f"  K6 launched {large_k_launches} times at k = 600", flush=True)

    stamp("phase 3: times")
    for tag in ("fp32", "bf16"):
        for B in (256, 4096):
            enc = results[(tag, B)][0]
            ds = queries.take(B)
            timing[f"predict_{tag}_B{B}_ms"] = host_ms(
                lambda: enc.predict(ds, batch_size=B, device=dev))
    for B in (256, 4096):
        ds = queries.take(B)
        timing[f"predict_int8_B{B}_ms"] = host_ms(
            lambda: enc8.predict(ds, batch_size=B, device=dev))
    timing.update(serving_breakdown(dev, model, queries, results))
    timing.update(topk_1m_times(dev, gen, errs))
    timing["topk_16M_bf16_B1024"] = topk_16m_memory(dev, gen)
    print("serving " + json.dumps(timing), flush=True)
    rows, bf16 = phase_measure(dev, model, queries, results, launches, errs)
    for row in rows:  # K4 on the 1M x 128 and 2**24 x 128 layers
        if row["name"] == "bin_max":
            row["launches_topk_1M"] = {tag: timing[f"launches_1M_{tag}"]["bin_max"]
                                       for tag in ("fp32", "bf16", "int8")}
            row["topk_16M_bf16_B1024"] = timing["topk_16M_bf16_B1024"]
    print("bf16 index " + json.dumps(bf16), flush=True)
    int8_rows = measure_int8(dev, enc8, q4096, int8_launches, errs)
    del enc8

    stamp("phase 4: the training step against the unfused head and the CPU")
    tmodel = model  # the serving phases are done: train the same seeded model
    phase_train_checks(dev, tmodel)
    stamp("phase 4b: towers wider than the flash-CE kernels (D = 320), card vs CPU")
    phase_wide_towers(dev, catalog)

    stamp("phase 5: training at full width")
    data, train_launches, train = phase_train(dev, tmodel, catalog, queries)

    stamp("phase 6: training times")
    train.update(train_times(dev, tmodel, data))
    train.update(train_profile(dev, tmodel, data))
    print("training " + json.dumps(train), flush=True)
    rows += measure_flash_ce(dev, tmodel, data, train_launches, errs)

    stamp("phase 6b: mixed precision (mixed_bfloat16, bf16 slots) against the CPU and the "
          "unfused head")
    import models_tpu_torch as mt

    mt.set_dtype_policy("mixed_bfloat16")
    try:
        mmodel = phase_mixed_checks(dev, catalog)
        stamp("phase 6c: mixed-precision training at full width")
        mdata, mixed_launches, mixed = phase_mixed_train(dev, mmodel, catalog, queries)
        stamp("mixed-precision training times")
        mixed.update(train_times(dev, mmodel, mdata))
        mixed.update(train_profile(dev, mmodel, mdata))
        print("mixed training " + json.dumps(mixed), flush=True)
        rows += measure_flash_ce(dev, mmodel, mdata, mixed_launches, errs, torch.bfloat16)
    finally:
        mt.set_dtype_policy("float32")
    del mmodel

    stamp("phase 6d: k steps a chunk (steps_per_execution), device-resident, CUDA graphs")
    spe_launches, spe_traced, spe = phase_steps_per_execution(dev, catalog, card)
    print("steps_per_execution " + json.dumps(spe), flush=True)

    stamp("phase 7: row-sparse training against the CPU")
    sparse_models = {tag: mt.TwoTowerModel(catalog.schema, query_tower=(256, 128),
                                           embedding_dim=128, table_dtype=dtype, seed=SEED,
                                           device=dev)
                     for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16))}
    phase_sparse_checks(dev, sparse_models)

    stamp("phase 8: row-sparse training at full width")
    data, sparse_runs, sparse = phase_sparse_train(dev, sparse_models, catalog, queries)

    stamp("phase 9: row-sparse training times")
    for tag, model in sparse_models.items():
        for key, value in {**train_times(dev, model, data),
                           **train_profile(dev, model, data)}.items():
            sparse[f"sparse_{tag}_{key}"] = value
    sparse.update(opt_step_times(dev, gen))
    print("sparse training " + json.dumps(sparse), flush=True)
    row_launches = {name: sum(run[name] for run in sparse_runs.values())
                    for name in ("row_scatter_add", "row_scatter_write")}
    rows += measure_row_scatter(dev, gen, row_launches, errs)
    rows.append(measure_scatter_write_fp32(dev, gen, errs,
                                           sparse_runs["fp32"]["row_scatter_write"]))
    # K8a's launches on the row route: phase 6d's (a), graph route, issued
    rows[-1]["launches_row_route"] = spe_launches["row_scatter_write"]

    stamp("phase 10: the row gather through its entry point")
    from models_tpu_torch.ops import embedding_lookup as E

    tables = [(torch.empty(R, 128, device=dev, dtype=dt).normal_(generator=gen),
               torch.randint(0, R, (8192,), device=dev, generator=gen, dtype=torch.int32))
              for R, dt in ((OP_ROWS_FP32, torch.float32), (OP_ROWS_BF16, torch.bfloat16))]
    E.row_gather.launches = 0
    for table, ids in tables:
        for _ in range(4):
            out = E.row_gather(table, ids)
            require(out.shape == (8192, 128) and out.dtype == table.dtype, "row_gather output")
    torch.cuda.synchronize()
    gather_launches = E.row_gather.launches
    require(gather_launches == 8, f"row_gather launched {gather_launches} times, want 8")
    del tables, out
    torch.cuda.empty_cache()
    rows.append(measure_gather(dev, gen, spe_launches["row_gather"], errs))

    stamp("phase 10b: the row route: K9, K8a and the routed step at the bench's tables, "
          "its step timed against the dense step")
    row_route_out = phase_row_route(dev, gen, errs)
    print("row_route " + json.dumps(row_route_out), flush=True)

    stamp("phase 11: evaluation (fit with metrics, in-batch and corpus evaluate)")
    emodel, edata, _, eval_launches = phase_evaluate(dev, catalog)
    print(f"  launches {eval_launches}", flush=True)
    stamp("evaluation times")
    etimes = evaluate_times(dev, emodel, edata, catalog)
    print("evaluation " + json.dumps(etimes), flush=True)
    stamp("phase 11b: the device-resident evaluate (the eval pack, chunks of batches as CUDA "
          "graph replays; K4-K6 and K9 traced in the replays) against the streaming route, "
          "validation inside fit, the streaming step's device prefetch")
    eval_route, eval_ln = phase_eval_route(dev, catalog, emodel, edata, card)
    print("eval_route " + json.dumps(eval_route), flush=True)
    del emodel
    torch.cuda.empty_cache()
    rows += int8_rows
    for row in rows:  # the eval route's launches: its wrappers' (eager and capture), a replay's
        name = row["name"].removesuffix("_int8")
        mine = eval_ln if name not in EVAL_TRACED[:3] else {
            case: v for case, v in eval_ln.items()
            if case.startswith("corpus_int8") == row["name"].endswith("_int8")}
        row["launches_eval_route"] = sum(v["launches_device_route"].get(name, 0)
                                         for v in mine.values())
        row["launches_eval_route_traced"] = sum(v["launches_replay_traced"].get(name, 0)
                                                for v in mine.values())
    for row in rows:  # the graph route's replays, counted in their traces
        if row["name"] in spe_traced:
            row["launches_replayed_traced"] = spe_traced[row["name"]]

    stamp("phase 12: the DLRM at the bench's width (criteo-small), one step at a time, "
          "graph-replayed, card vs CPU, evaluate, predict")
    dlrm, dlrm_k9, dlrm_k9_traced, dlrm_data = phase_dlrm(dev, card)
    print("dlrm " + json.dumps(dlrm), flush=True)
    stamp("phase 12b: K9 on the DLRM's 160-byte pack")
    criteo_pack = measure_pack(dev, gen, dlrm_data._device_train_pack.packed,
                               DLRM_SPE * TRAIN_BATCH, "criteo pack", 16, errs)
    del dlrm_data
    torch.cuda.empty_cache()
    stamp("phase 13: the DLRM on the full Criteo cardinalities, row-sparse (K7)")
    criteo, criteo_k7, criteo_k7_times = phase_criteo_sparse(dev, gen, errs)
    print("criteo " + json.dumps(criteo), flush=True)
    stamp("phase 14: DCN-v2, DeepFM, NCF card vs CPU; BatchNorm and Dropout on the graph route")
    zoo = phase_ranking_zoo(dev)
    print("ranking zoo " + json.dumps(zoo), flush=True)
    for row in rows:  # the ranking paths' launches, each counted from zero around its run
        if row["name"] == "row_gather":
            row.update(launches_dlrm=dlrm_k9, launches_replayed_traced_dlrm=dlrm_k9_traced,
                       criteo_pack=criteo_pack)
            row["max_abs_err"] = errs["row_gather"]
        elif row["name"] == "row_scatter_add":
            row.update(launches_criteo=criteo_k7, criteo=criteo_k7_times)
            row["max_abs_err"] = errs["row_scatter_add"]
    stamp("phase 15: the session model (sequence-testing, L = 4): one step at a time, "
          "graph-replayed, card vs CPU, evaluate, predict")
    session, session_launches, session_traced = phase_session(dev, card)
    print("session " + json.dumps(session), flush=True)
    bucket_ds = bucket_data()
    stamp("phase 16: session_bucket's data at pad=\"max\" (L = 64, Q = N = 65,536)")
    session_long, long_kernels = phase_session_long(dev, gen, card, errs, bucket_ds)
    print("session_long " + json.dumps(session_long), flush=True)
    stamp("phase 17: session_bucket: pad=\"bucket\", one graph a bucket group")
    session_bucket, bucket_k9, bucket_traced, bucket_k9_times = phase_session_bucket(
        dev, gen, card, errs, bucket_ds)
    print("session_bucket " + json.dumps(session_bucket), flush=True)
    for row in rows:  # the session paths' launches and the kernels' times at their sizes
        name = row["name"]
        if name in ("lse_forward", "grad_query", "grad_neg"):
            row.update(launches_session=session_launches[name],
                       launches_replayed_traced_session=session_traced[name],
                       launches_replayed_traced_session_bucket=bucket_traced[name],
                       session_long=long_kernels[name])
            row["max_abs_err"] = errs[name]
        elif name == "row_gather":
            row.update(launches_session_bucket=bucket_k9,
                       launches_replayed_traced_session=session_traced[name],
                       launches_replayed_traced_session_bucket=bucket_traced[name],
                       session_bucket=bucket_k9_times)
            row["max_abs_err"] = errs["row_gather"]
    stamp("phase 18: retrieval breadth: the matrix factorization with cross-batch negatives "
          "(Q = 4096, N = 8192, D = 64) and YouTube-DNN (N = 100, D = 32), trained and served")
    retrieval, rl, shapes = phase_retrieval(dev, card, errs)
    print("retrieval " + json.dumps(retrieval), flush=True)
    for row in rows:  # the retrieval paths' launches and K1-K3 at their shapes
        name = row["name"]
        if name in ("lse_forward", "grad_query", "grad_neg"):
            row.update(launches_mf=rl["mf"][name],
                       launches_replayed_traced_mf=rl["mf_graph"]["traced"][name],
                       launches_youtube_dnn=rl["youtube_dnn"][name],
                       mf=shapes["mf"][name], youtube_dnn=shapes["youtube_dnn"][name])
            row["max_abs_err"] = errs[name]
        elif name in ("streaming_topk", "binned_rescore", "bin_max"):
            row.update(launches_mf_serving=rl["mf_serving"][name],
                       launches_youtube_dnn_serving=rl["youtube_dnn_serving"][name])
        elif name in ("row_scatter_add", "row_scatter_write"):
            row["launches_mf_sparse"] = rl["mf_sparse"][name]
        elif name == "row_gather":
            row.update(launches_mf=rl["mf_graph"]["issued"][name],
                       launches_replayed_traced_mf=rl["mf_graph"]["traced"][name])
    stamp("phase 19: multi-task ranking on the full Ali-CCP schema: MMOE (one step at a time, "
          "graph-replayed, row-sparse, card vs CPU, evaluate, predict, four optimizers, frozen "
          "experts), PLE, the V1 prediction tasks")
    multi, ml, mt_k9, mt_k7 = phase_multi_task(dev, gen, card, errs)
    print("multi_task " + json.dumps(multi), flush=True)
    for row in rows:  # the multi-task paths' launches, each counted from zero around its run
        if row["name"] == "row_gather":
            row.update(launches_mmoe=ml["mmoe_graph"]["issued"],
                       launches_mmoe_eager=ml["mmoe_graph"]["eager"],
                       launches_replayed_traced_mmoe=ml["mmoe_graph"]["traced"],
                       launches_ple=ml["ple_graph"]["issued"],
                       launches_replayed_traced_ple=ml["ple_graph"]["traced"],
                       aliccp_pack=mt_k9)
            row["max_abs_err"] = errs["row_gather"]
        elif row["name"] == "row_scatter_add":
            row.update(launches_mmoe_sparse=ml["mmoe_sparse"], aliccp=mt_k7)
            row["max_abs_err"] = errs["row_scatter_add"]
    stamp("phase 20: the block DSL and the rest of the inputs: Wide&Deep on criteo-small, "
          "dynamic tables over full-Criteo raw ids, pretrained and frozen tables, TT tables")
    dsl, dsl_k9, dsl_k7 = phase_dsl(dev, gen, card, errs)
    print("dsl " + json.dumps(dsl), flush=True)
    for row in rows:  # the slice's launches, each counted from zero around its run
        if row["name"] == "row_gather":
            row.update(dsl_k9)
            row["max_abs_err"] = errs["row_gather"]
        elif row["name"] == "row_scatter_add":
            row.update(dsl_k7)
            row["max_abs_err"] = errs["row_scatter_add"]
    stamp("phase 21: save and load, exact resume through ModelCheckpoint, the exported "
          "top-k encoder and DLRM served by a fresh process")
    persistence, prow = phase_persistence(dev, card, errs)
    print("persistence " + json.dumps(persistence), flush=True)
    for row in rows:  # the slice's launches, each counted from zero around its run
        row.update(prow.get(row["name"], {}))
    stamp("phase 22: the mesh: one rank over NCCL against no mesh; four ranks on the one card "
          f"over {MESH_BACKEND}: the two-tower and the DLRM on {MESH_SHAPE}, the 1M-row top-k "
          f"on {TOPK_MESH}")
    mesh, mrows = phase_mesh(dev, card)
    print("mesh " + json.dumps(mesh), flush=True)
    for row in rows:  # each rank's launches on the mesh path, counted from zero around each run
        row.update(mrows.get(row["name"], {}))
    stamp("phase 23: four ranks on the one card over {MESH_BACKEND} on {MESH_SHAPE}: dynamic "
          "tables over full-Criteo raw ids (adagrad, adam, bf16), the session transformer "
          "(in-batch and tied full-catalog heads), the music-streaming DLRM, examples/06; "
          "examples/09's workflow into a DLRM".format(MESH_BACKEND=MESH_BACKEND,
                                                      MESH_SHAPE=MESH_SHAPE))
    breadth, brows = phase_breadth(dev, card, errs)
    print("mesh_breadth " + json.dumps(breadth), flush=True)
    for row in rows:  # the slice's mesh paths' launches, each rank's, counted from zero a run
        row.setdefault("launches_mesh", {}).update(brows.get(row["name"], {}))
        if row["name"] in errs:
            row["max_abs_err"] = max(row.get("max_abs_err", 0.0), errs[row["name"]])
    stamp("phase 24: the data plane from files (the port's parquet codec, file-backed "
          "Datasets, the streaming Loader, the C++ batcher), fits from files against memory")
    pq_out, pq_ln = phase_parquet(dev, card)
    print("parquet " + json.dumps(pq_out), flush=True)
    for row in rows:  # the slice's launches, each counted from zero around its run
        for route, ln in pq_ln.items():
            if row["name"] in ln:
                row[f"launches_parquet_{route}"] = ln[row["name"]]
    stamp("phase 25: the public surface and the side stacks: the torch side-backend's "
          "two-tower at the bench's width (K5 serving 256 rows, K6 in evaluate_retrieval at "
          "8192), its DLRM and session transformer, examples/05 and examples/10, card vs CPU")
    side, side_ln = phase_side(dev, card)
    print("side " + json.dumps(side), flush=True)
    for row in rows:  # the side two-tower path's launches, counted from zero around its run
        row["launches_side"] = side_ln.get(row["name"], 0)
    stamp("done")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
