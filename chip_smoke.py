"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

Run from the repository root, on a machine with one H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

1. set-up: the card's name and power limit, TF32 off, the kernels built
   from ``recommender_system_tpu_torch/csrc`` (one nvcc per source, all
   started together);
2. every kernel against its plain PyTorch version on the card:
   ``cross_fused`` vs ``cross_network`` at B=4,096 and 8,192 (D=221, L=6),
   at 4,097 and 8,193 (a partial last tile of 32 rows) and at D=100 on
   the tile kernel, and with x0 off 16-byte alignment, at D=1000 and L=16
   on the register kernel, and on the global kernel at x0 widths 1,025,
   1,053 (B=4,096 and 8,192) and 1,677, each at L=0, 1 and 6 and off
   16-byte alignment, at 29 layers of 1,024 and 12 of 3,000 (weights past
   the shared memory) and at D=4,900 (past the registers: its rows
   kernel), forward and gradient (rtol=1e-4, atol=1e-5), two launches
   bitwise equal, and which of the kernels ran; the global entry point
   against the stack kernel at D=1,000 and 1,024 (x0 aligned and not),
   bitwise; ``din_attention_fused`` vs
   ``din_attention_ref`` at DIN's bench shape (B=8,192, T=50, K=32, scorer
   80-40) in all eight combinations of activation, softmax and scores, at
   T=13, T=1, B=1, at K=6 (not a multiple of 4) and with a scorer of
   128-64 on the tiled kernel, and on the global kernel at K=128 (T=50 and
   T=1), at K=32, T=515 and with a scorer of 300-260, and at B=8,192 at its
   three timed shapes, (K=128, T=50), (K=64, T=200) and (K=32, T=1,000),
   pooled and returning the weights, each with a row that has no valid
   position, forward (rtol=1e-4, atol=1e-5), and which of the two kernels
   ran; at each of these cases the backward: the forward's saved weights
   bitwise its returned ones, the gradient through the autograd Function
   bitwise one launch of ``din_attention_backward`` on them (its tile
   kernel where ``din_backward_kernel_takes``, its wide kernel where
   ``din_backward_wide_takes``, counted in ``wide_launches``, else its
   global kernel, counted in ``global_launches``; the wide kernel's cases
   add K=33, 64 and 100, T=65, T=128 with rows of exactly 64, 65 and 128
   valid positions, 80-40 against 81-40), that kernel twice bitwise and against
   ``din_attention_backward_ref`` in f32 (rtol 1e-4, atol 1e-5 of each
   gradient's scale; rows at relu's kink left out, ``din_kink_rows``) and,
   on up to 1,024 rows, no farther from the plain version in float64 than
   ``DIN_F64_FACTOR`` times the f32 plain version's distance
   (``din_backward_close``); where the tile or the wide kernel takes the
   case, the global kernel too (the launcher's ``global_kernel``), held
   the same way;
   ``fm_fused`` vs ``fm_ref`` (evaluated in float64: in float32 on the
   card its own sums miss the tolerance at D >= 3,419, B=16,384) at
   B=16,384, D=221, k=8, at B=16,385 and B=31 (a partial last group of 4
   rows) and at B=1, D=1, k=1, at D=13, k=64, and at Ds that are not
   multiples of 32, forward and gradient through the Function (rtol=1e-4,
   atol=1e-5), two launches bitwise equal, and which of the three kernels
   of ``csrc/fm.cu`` ran (the register kernel for D <= 256, k <= 8, the
   wide kernel past them while its shared memory fits, the global kernel
   past that: D=3,419, 4,000 and 4,001 at k=8, each at B=1, 1,000 and
   16,384, k=19 at D=1,500, D=20,000);
   ``fused_adagrad_apply``, ``fused_sgd_apply`` and ``fused_adam_apply``
   (lazy Adam at step 0, and at step 3 from non-zero moments) vs
   ``fused_adagrad_ref``, ``fused_sgd_ref`` and ``fused_adam_ref``, and
   ``scatter_add_sorted`` vs ``scatter_add_dense_ref``, at the bench shape
   (N=425,984 lookups into 2,600,000 rows of dim 9), at dims 1 to 156 (33,
   and FFM's 1 and 156, among them), at N=1 and N=0, with ids on the table's last row, with half
   the ids on one row, with rows named only by all-zero cotangents or by
   cotangents that cancel, on DIN's two-site stream of table_d32 (425,984
   positions, ~184,000 on the padding row; once more with the padding
   row's cotangents zero, as in training), on segments whose lengths
   cycle through 1..70, so that segments start and end at every lane of the
   kernels' 32-position tiles and cross up to three of them, and on the
   long path's streams at dims 1, 9, 32 and 156: one row holding 60,000
   positions, and segments of 255, 256, 257, 511, 513, 767 and 769
   positions (the long path takes 256 and more, in chunks of 256) at
   several offsets, three long ones back to back and one at each end of
   the stream (rtol=1e-5, atol=1e-6 x the largest |value|: the plain
   versions' ``index_add_`` sums in another order; rows no id touches, and
   for Adam the rows whose summed gradient is zero, must come back bitwise
   equal; on the bench, half-on-one-row, cycled, zero-padding DIN and long
   streams the scatter-add, Adagrad, SGD and lazy Adam launch twice on
   identical inputs and must agree bitwise; on every stream the scatter-add
   is bitwise ``scatter_add_chunked_ref``, its own order, Adagrad's
   accumulator ``acc + G * G`` of that sum G, SGD's table ``table - lr *
   G`` and lazy Adam's table and moments ``fused_adam_ref``'s formula on
   G); the long streams again with normal cotangents, where the order
   shows: the four rules twice bitwise equal, the scatter-add, Adagrad's
   accumulator, SGD and lazy Adam (steps 0 and 3) bitwise equal to their
   formulas on ``scatter_add_chunked_ref``'s sums, and the one row's sum
   within the recursive-summation bound of its float64 sum;
3. serving at full width: DCN on 26 sparse fields of 100,000 ids (dim 8)
   and 13 dense fields, 6 cross layers, deep tower 256-128-64, f32, random
   weights from a seed; ``Scorer(batch_size=4096)`` answers requests of 1,
   1000, 4096 and 10,000 rows. The kernel counts must show one launch per
   padded batch, and every answer must equal a plain forward on the card
   (atol=1e-5 on probabilities) and the CPU path on 1000 rows;
3b. fused training at ``bench.py``'s width: DeepFM (factor dim 8, deep tower
   256-128-64 in bf16) with ``Adagrad(0.05)`` and
   ``FusedAdagrad(0.05)``, three ``multi_step`` calls of K=8 pre-staged
   batches of 16,384. ``fused_adagrad_apply`` must launch 24 times and
   ``scatter_add_sorted`` never; one call runs under
   ``torch.cuda.set_sync_debug_mode("error")``; losses finite and falling;
   table rows no batch touched bitwise unchanged; AUC on 65,536 held-out
   rows;
3c. plain training: the same model without the fused optimizer, one call of
   K=8; ``scatter_add_sorted`` must launch 8 times;
3d. card against CPU: two fused steps at full width (f32 tower) on the card
   and on the CPU from the same start; parameters and accumulators agree;
3f. DIN training at ``benchmarks/model_step.py``'s width (user_id 100,000
   ids, item_id 200,000 ids and a T=50 history on the same table_d32 of
   300,000 x 32, attention 80-40, BatchNorm, Dice tower 256-128-64, f32,
   batch 8,192), K=8 batches built as model_step.py builds them (seeds
   0-7): fused, three calls, each step one attention launch, one of the
   attention's backward kernel and one
   ``fused_adagrad_apply`` (the two lookup sites of table_d32 go as one
   stream) and no scatter-add, one call under
   ``set_sync_debug_mode("error")``, losses falling, untouched rows
   bitwise unchanged, the BatchNorm statistics moved; plain, one call, two
   ``scatter_add_sorted`` launches a step; then two fused steps on the card
   and on the CPU, whose parameters, BatchNorm statistics and accumulators
   agree;
3e. DIN serving: ``Scorer(batch_size=8192)`` with the DIN that 3f trained
   answers requests of 1, 1000, 8192 and 20,000 rows, one attention launch
   per padded batch; the answers equal a plain forward on the card
   (atol=1e-5) and the CPU path on 1000 rows;
3g. the Criteo CTR models at ``benchmarks/model_step.py``'s width (26
   fields of 100,000 ids at dim 8, 13 dense fields, f32 towers 256-128-64,
   batch 8,192, K=8 pre-staged batches, seeds 0-7), built as model_step.py
   builds them, weights from seed 0: WideDeep with ``SGD(0.01)`` and
   ``FusedSGD(0.01)`` (table_d9 2,600,000 x 9), three calls, 24
   ``fused_sgd_apply`` launches; NFM with ``Adam(1e-3)`` and
   ``FusedAdam(1e-3)`` (table_d8 with m and v), three calls, 24
   ``fused_adam_apply`` launches, its BatchNorm statistics moved; each with
   one call under ``set_sync_debug_mode("error")``, losses finite and
   falling, untouched rows bitwise unchanged (Adam's m and v too); FM with
   ``FusedAdam``, one call (8 launches), ``init_from_fm`` into FNN (the copy
   equals the FM table's first 8 columns), FNN with ``FusedSGD``, one call
   (8 launches); DCN (6 cross layers) with ``Adagrad(0.05)`` and
   ``FusedAdagrad(0.05)``, one call: 8 ``cross_fused`` and 8
   ``fused_adagrad_apply`` launches; then two steps of WideDeep/FusedSGD and
   of NFM/FusedAdam on the card and on the CPU from the same start, whose
   parameters, BatchNorm statistics and optimizer states agree;
3h. ``FMLayer`` on x [16,384, 221], k=8: 8 forward and backward passes, one
   ``fm_fused`` launch per forward, output and gradients equal to the plain
   version's;
3i. the rest of the Criteo CTR family at ``model_step.py``'s width (the
   batches of 3g), each with ``Adagrad(0.05)`` and ``FusedAdagrad(0.05)``:
   DeepCrossing (3 residual units of 256-128), PNN (inner products, tower
   256-128-64) and AFM (8 attention units, linear term in table_d9), two
   calls each, 16 ``fused_adagrad_apply`` launches; FFM (k=4: table_d1 of
   its linear weights and table_d156 of its field-aware factors, 2,600,000
   rows each), three calls, 48 launches (one a table a step), its losses
   falling; PNN ``mode="both"`` with FGCNN (83 fields, 3,403 pairs), one
   call, 8 launches; every table's untouched rows bitwise unchanged with
   their slots; FFM with the plain step, one call, 16 ``scatter_add_sorted``
   launches (dims 1 and 156); then two steps of PNN and of AFM on the card
   and on the CPU, whose parameters and optimizer states agree;
3j. DIEN at ``benchmarks/model_step.py``'s width (3f's columns and batches,
   seeds 0-7, with a sampled history ``neg_hist_item_id`` on the same
   table_d32: three lookup sites; ``use_negsampling``, GRU and AUGRU of
   H=32, attention 80-40 over the GRU states, auxiliary tower 100-50, relu
   tower 256-128-64, f32, batch 8,192) with ``Adagrad(0.05)`` and
   ``FusedAdagrad(0.05)``: three fused calls, each step one attention
   launch, one of its backward kernel and one ``fused_adagrad_apply`` (the
   three sites one stream), one
   call under ``set_sync_debug_mode("error")``, losses falling, untouched
   rows bitwise unchanged; one plain call, three ``scatter_add_sorted``
   launches a step; two fused steps on the card and on the CPU at batch
   1,024, which agree; the trained DIEN through ``Scorer(batch_size=8192)``,
   one attention launch per padded batch, its answers equal to the plain
   attention's on the card and to the CPU path's on 1000 rows;
3k. the global kernels on the paths that reach them: DCN at
   ``model_step.py``'s Criteo width and batch 8,192 but embedding dim 40
   (x0 1,053 wide) trained with ``Adagrad(0.05)`` + ``FusedAdagrad(0.05)``
   (three K=8 calls, 8 global cross launches a call, losses falling,
   untouched rows bitwise unchanged), then three graphed calls against
   three looped ones, bitwise equal; DCN served at x0
   width 1,053 (26 fields at dim 40, 13 dense), ``fm_fused`` at D=4,000,
   ``din_attention_fused`` at K=128, T=50, one fused step of
   ``DIEN(gru_hidden=128)`` at batch 1,024 (its backward on the wide
   kernel, ``wide_launches``) and one of DIN with a 128-64 attention scorer
   (its backward on the global kernel); each launch counted in
   ``launches`` and in ``global_launches`` or ``wide_launches``, each
   answer against the CPU;
3l. DSSM at ``benchmarks/model_step.py:109-122``'s width (3f's columns and
   batches without the price column, seeds 0-7: the user tower reads
   user_id and the mean-pooled T=50 history, the item tower item_id, all on
   table_d32 of 300,000 x 32; towers 256-128-64, relu, f32; the in-batch
   softmax at temperature 0.05) with ``Adagrad(0.05)`` and
   ``FusedAdagrad(0.05)``: three fused calls, each step one
   ``fused_adagrad_apply`` (two calls of the collection, three lookup
   sites, one stream of 425,984 positions) and no scatter-add, one call
   under ``set_sync_debug_mode("error")``, losses falling, untouched rows
   bitwise unchanged and every touched user_id row moved; one plain call,
   three ``scatter_add_sorted`` launches a step; two fused steps on the card
   and on the CPU at batch 1,024, which agree; ``RetrievalIndex`` over item
   ids 1..199,999 answering 1, 1,024 and 8,192 users at k=10 with no kernel
   launch, ids and scores equal to a full product and sort on the card and
   to the CPU path on 64 users (atol=1e-5, ties in either order), and the
   8,192-user answer's recall@10 against each row's item_id;
3m. MMOE at ``model_step.py:69-74``'s width (3g's Criteo batches, labels
   ``[y, y[::-1]]``, 2 tasks, 4 experts of 64 units, towers of 64) with
   ``Adagrad(0.05)`` and ``FusedAdagrad(0.05)``: two fused calls, 16
   ``fused_adagrad_apply`` launches, losses falling, untouched rows bitwise
   unchanged; two steps on the card and on the CPU, which agree;
   ``Scorer(batch_size=8192)`` answering 1, 1,000 and 20,000 rows with
   ``[n, 2]`` probabilities and no kernel launch, equal to the CPU path on
   1,000 rows;
3n. the training CLI, ``main([...])`` of ``recommender_system_tpu_torch.train``
   in this process: the port's native Criteo parser must build; a
   Criteo-format TSV of 524,288 rows (4 packed groups of 8 x 16,384) and a
   held-out file of 65,536 rows from the same token pools, written by this
   script into a temporary directory; the README's north-star command
   (``--stream --fused-embedding adagrad --batch-size 16384 --hash-buckets
   1000000 --stream-eval-path``, 5 epochs: DeepFM's table_d9 26,000,000 x
   9) with one ``fused_adagrad_apply`` a step and nothing else, losses
   finite and falling, held-out AUC above 0.5; the same command to step 32,
   and stopped at step 16 (checkpoints every 8) then resumed to 32, whose
   final checkpoints must be bitwise equal; the README's in-memory quick
   start on the same file (one ``scatter_add_sorted`` a step); every model
   the CLI builds, one epoch of 2,048 synthetic rows, with the launches of
   ``CLI_MODEL_LAUNCHES``; DeepFM (``--optimizer adagrad --learning-rate
   0.05``) on the card against ``--device cpu``: train_loss at rtol 1e-4,
   AUC and logloss within 2e-3;
3o. the tables sharded by row over ``torch.distributed``
   (``Trainer(mesh=...)``; the kernels built before any rank starts): (a)
   one NCCL rank a card of the machine's cards, spawned here: DeepFM at
   ``bench.py``'s width (bf16 tower) with ``Adagrad(0.05)`` and
   ``FusedAdagrad(0.05)``, the explicit lookup at the README's capacity
   factor 2.0, one K=8 call held to the single card's from the same start
   (losses, every table row, accumulator and parameter at the
   card-against-CPU tolerance), 8 ``fused_adagrad_apply`` launches a rank,
   no overflow, a second call under ``set_sync_debug_mode("error")``, a
   third timed; (b) four gloo ranks sharing card 0, a rehearsal of the
   four-shard routing and of the per-shard launches whose times are no
   speed figure: two steps each of DeepFM at ``bench.py``'s width (f32
   tower) with ``FusedAdagrad``, the explicit lookup at 2.0 and the
   full-capacity lookup, its plain step (``scatter_add_sorted``), WideDeep
   with ``FusedSGD`` and NFM with ``FusedAdam`` (BatchNorm on the global
   batch's moments) at ``model_step.py``'s Criteo width, and DIN at its
   width with ``FusedAdagrad`` and the explicit lookup at a capacity factor
   of 4 (nothing dropped), each held to the single card's steps (NFM's
   Adam-trained parameters within ``ADAM_PARITY``, its moved rows the
   single card's), its launches checked on every rank; (c) the README's multi-chip command
   under ``python -m torch.distributed.run --nproc-per-node N`` with
   ``--mesh-data N`` (N the card count) on 16,000 synthetic rows (310
   steps): exit code 0, one JSON line, its checkpoint restored on one card
   scoring the held-out rows as the run did. A rank that fails fails the
   script;
3p. the model axis: (a) four gloo ranks sharing card 0 as a 2 x 2
   ('data', 'model') mesh, two steps at batch 8,192 each of FFM at
   ``model_step.py``'s Criteo width with the plain ``Adagrad(0.05)`` step
   (table_d156 of 2,600,000 x 156 column-sharded, rows over 'data' and 78
   columns a model rank; table_d1 row-sharded; 4 ``scatter_add_sorted``
   launches a rank), held to the single card at the touched rows with the
   rest unchanged, and of MMOE at ``model_step.py:69-74``'s width with
   ``FusedAdagrad(0.05)`` (its 4 experts of 64 units 2 a model rank; 2
   ``fused_adagrad_apply`` launches a rank), held to the single card
   whole; (b) ``--mesh-data 2 --mesh-model 2`` through the CLI under
   ``python -m torch.distributed.run --nproc-per-node 4`` on gloo (MMOE at
   embedding dim 64: a column-sharded table_d64), its checkpoint restored
   on the card scoring the held-out rows as the run did; (c) LR, ItemCF /
   UserCF and MF at MovieLens-100k's shape (943 users, 1,682 items,
   100,000 ratings drawn from a seed), each on the card against its CPU
   run, with no kernel launch;
3q. a call of K steps as one CUDA graph: for every single-card training
   path above (DeepFM fused and plain at ``bench.py``'s width; WideDeep,
   NFM, DCN, FFM, PNN, AFM, DeepCrossing and MMOE at ``model_step.py``'s
   Criteo width; DIN fused and plain, DIEN and DSSM at its width; and two
   paths that draw: DeepFM with dropout 0.1, its masks from the Trainer's
   generator, and DSSM with a sampled softmax whose negatives come from a
   step generator of the loss, uniform and, with a numpy ``item_probs``,
   by frequency), two copies of one state: three
   ``multi_step`` calls (steps one by one, then
   capture and replay, then a replay under ``set_sync_debug_mode("error")``)
   against three ``make_multi_step(graphed=False)`` calls; losses,
   parameters, buffers, optimizer states, the step and the generators'
   states bitwise equal (else within PARITY, the largest difference and its
   cause printed: a second looped copy tells atomics from the graph), the
   launch counts equal; and the north-star stream CLI to step 32 with its
   packed calls looped, whose checkpoint must equal the graphed run's
   bitwise. Every training call of the phases before it goes through the
   graphs too, the sync check on the first replay (a capture synchronises);
3r. DIN at ``model_step.py``'s width with 128-wide embeddings (table_d128
   of 300,000 x 128), whose attention only the global kernel takes:
   three fused K=8 calls (``Adagrad(0.05)`` + ``FusedAdagrad(0.05)``; the
   second captures the graph, the third replays it under
   ``set_sync_debug_mode("error")``), losses falling, untouched rows and
   slots bitwise unchanged, 24 attention launches, all of the global
   kernel, and 24 of the backward, all of the wide kernel; then
   ``Scorer(batch_size=8192)`` serves it (one global launch a
   padded batch), its answers equal to the plain attention's forward on
   the card and to the CPU path;
3s. the long path of the fused SGD and lazy Adam on the main path: DIN at
   ``model_step.py``'s width with ``SGD(0.01)`` + ``FusedSGD(0.01)`` and
   with ``Adam(1e-3)`` + ``FusedAdam(1e-3)``, three K=8 calls each (the
   third a graph replay under ``set_sync_debug_mode("error")``), 24
   launches of the rule's wrapper and of its long path, the padding row
   (zero cotangents, a long segment of every step) and its slots bitwise
   unchanged; WideDeep (``FusedSGD``) and NFM (``FusedAdam``) at
   ``model_step.py``'s Criteo width, one K=8 call each, on batches with 5 %
   of the fields missing (id 0, as ``write_criteo_tsv`` drops them and the
   CLI buckets them: ~410 positions a step on each column's id-0 row);
4. timings: each kernel's and its plain version's device time (from the
   profiler's trace) and time per call (CUDA events over back-to-back calls,
   host overhead included), and the library call where there is one (the
   DIN attention and its backward against two bounds: the tensor cores' at
   three TF32 passes, its ``bound_ms``, and f32 outside them,
   ``f32_bound_ms``, the backward's over its unmasked positions, the
   least work, and over all of them, ``all_positions_bound_ms``; the
   backward's tile kernel at DIN's shape, its wide kernel and its global
   kernel at the global forward kernel's three shapes, the global kernel
   also at DIN's shape with a 128-64 scorer); each
   Scorer's latency and throughput (host clock), its device busy time per
   batch and its top kernels; the training throughput of a fused K=8 call,
   graphed and looped (CUDA events), its device idle share, the top device
   work of a step and the count of host ops a call issues, for DeepFM, DIN
   (and DIN with ``FusedSGD`` and with ``FusedAdam`` beside it), WideDeep
   and NFM (also on phase 3s's batches with missing fields),
   DeepCrossing, PNN, AFM, FFM, DIEN, DSSM and MMOE; the device and host
   time of DIEN's GRU, AUGRU, attention and auxiliary net (forward and
   backward); the share of DIN's, DIEN's and DSSM's steps that their padding
   row takes in ``fused_adagrad_apply``; ``RetrievalIndex``'s latency at 1
   and 1,024 users (host clock), its catalog build and the 1,024-user
   query's top device work; each sparse row kernel's time on a stream
   with a hot row and on DIN's step stream, back to back and with the L2
   cache flushed before each call, beside each stream's bound and, for the
   scatter-add and SGD, ``index_add_`` on it; each global kernel at a shape of
   its path (also by CUDA events around a graph of 100 calls, beside the
   same read of its bytes), the DIN attention's at its three timed shapes;
   and the stream
   CLI: the CLI's own examples/s, CUDA events around each packed group's
   call, the host's seconds by part (waiting for
   the parser, bucketing, packing into pinned memory, issuing the copies
   and the steps) and the device's idle share from a ``--profile-dir``
   trace.

Every launch check compares all eight wrappers' launch counts (the DIN
attention's backward, ``din_attention_backward``, launches once a training
step of DIN and DIEN, and never when serving), the
``global_launches`` of the cross, FM and DIN attention wrappers and of
the attention's backward, which must be 0 on every path but 3k's and, for
the attention, 3r's, the backward's ``wide_launches``, 0 on every path
but 3k's and 3r's, and the
``long_launches`` of the four sparse row wrappers, which every launch of
theirs counts (the long path's pass 2 runs on every stream; DIN's, DSSM's
and DIEN's padding rows and the id-0 rows of Criteo batches with missing
fields take it).

The line before the last lists every kernel with its launches on its main
path (the graphed calls of phase 3q's paths as ``graph_launches``; the
cross global kernel: on phase 3k's DCN training, the FM's on phase 3k's
path, the attention's on phase 3r's, with its times at three shapes as
``shapes``; the attention backward's wide kernel on phase 3r's, its
global kernel on phase 3k's 128-64 DIN step, both timed at the three
shapes as ``shapes``; the global kernels' ``events_ms`` beside ``ms``; kernels 3-7 also on
phase 3o's and 3p's runs, summed over ranks, as ``mesh_launches``, and
kernels 4 and 5 on phase 3p's grid rank by rank as
``grid_launches_per_rank``; kernels 4-7's long path's launches as
``long_launches``: 4 and 5 on DeepFM's, DIN's, DIEN's and DSSM's calls, 6
and 7 on WideDeep's or NFM's, DIN's and phase 3s's missing-field calls),
its error against
the plain version (kernel 4's one long row also against its float64 sum,
``long_row_f64_err``), its times and its bound; the line
before that names the card and its power limit; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import collections
import copy
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores, dense TF32 FLOP/s in the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

RTOL, ATOL = 1e-4, 1e-5
SERVE_BATCH = 4096
REQUESTS = (1, 1000, 4096, 10_000)
THROUGHPUT_ROWS = 65_536

# bench.py's training width: 26 fields of 100,000 ids at factor dim 8 (a
# table_d9 of 2,600,000 rows), 13 dense fields, batch 16,384, K=8
VOCAB, FIELDS, FACTOR_DIM = 100_000, 26, 8
TRAIN_BATCH, K = 16_384, 8
# sparse row kernels: f32 sums are taken in another order than the plain
# version's index_add_ (atomics on the card)
SPARSE_RTOL, SPARSE_ATOL_SCALE = 1e-5, 1e-6
LR, EPS = 0.05, 1e-7
# card against CPU after two fused steps: f32 on both, GEMMs and reductions
# summed in another order
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5

# benchmarks/model_step.py's Criteo width: bench.py's fields at batch 8,192,
# f32 towers; the reference's SGD recipe and the Adam it pairs with
CTR_BATCH = 8192
SGD_LR, ADAM_LR = 0.01, 1e-3

# benchmarks/model_step.py's DIN width: user_id 100,000 ids, item_id
# 200,000 ids with its history (T=50, padding id 0) on the same table, dim
# 32 (table_d32 of 300,000 rows), batch 8,192
DIN_USERS, DIN_ITEMS, DIN_T, DIN_DIM, DIN_BATCH = 100_000, 200_000, 50, 32, 8192
# DIEN (model_step.py:99-107) adds a sampled history on the same table: the
# card-against-CPU steps and DIEN(gru_hidden=128)'s step take this batch
DIEN_SMALL_BATCH = 1024
# shapes that the global kernels of csrc/cross.cu, fm.cu and din_attention.cu
# take: DCN's x0 of 26 fields at dim 40 and 13 dense (1,053 wide; vocabulary
# cut, the width is what counts), an FM input past the wide kernel's shared
# memory, the DIN attention at K=128
WIDE_DIM, WIDE_VOCAB, WIDE_FM_D = 40, 10_000, 4000
# the DIN attention's global kernel: (K, T) of its three timed shapes, at
# B=8,192 and 80-40, which the tiled kernel's shared memory refuses; and
# phase 3r's DIN, model_step.py's with its embedding dim 128
DIN_GLOBAL_SHAPES = ((128, 50), (64, 200), (32, 1000))
DIN_WIDE_DIM = 128
# an attention scorer wider than 80-40 (the attention backward's global
# kernel's path, phase 3k): DIN with att_hidden_units=(128, 64)
DIN_WIDE_SCORER = (128, 64)
# the widest x0 whose rows csrc/cross.cu's global kernel holds in registers;
# past it, its rows kernel
CROSS_GLOBAL_REGISTER_DIM = 3072


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def clocks_during(fn, calls: int = 40) -> str:
    """The card's SM and memory clocks, as ``nvidia-smi`` reads them while
    ``calls`` queued calls of ``fn`` run on the device."""
    for _ in range(calls):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    torch.cuda.synchronize()
    return out.strip().splitlines()[0]


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Time per call of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events: the device time, or the host's time to issue the call where that
    is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def events_ms(fn, iters: int = 100) -> float:
    """Device time per call of ``fn``: CUDA events around one replay of a
    CUDA graph of ``iters`` back-to-back calls, so that no host time falls
    between them (a wrapper's own host time can exceed a short kernel's).
    The wrappers count the captured calls as launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


# device_ms's lead-in: torch.cuda._sleep kernels of ~10 us (their kernel's
# name holds "spin") before a trace's calls
LEAD_IN, LEAD_IN_CYCLES, LEAD_IN_KERNEL = 64, 20_000, "spin"
TRACES = 8


def device_ms(fn, iters: int = 50) -> collections.Counter:
    """Device time per call of ``fn``, by kernel name, from the profiler's
    trace (kernels and copies; the gaps between them do not count).

    The profiler now and then loses device records, most often the first
    ones after a window or a burst of launches begins (``chip_lab_profiler.py``),
    which read low where the sum is divided by the calls. So a trace begins
    with a lead-in of sleep kernels and a synchronise, not counted, and each
    kernel's records are counted: each call launches each of its kernels
    the same number of times, so a whole trace holds a positive multiple of
    ``iters`` records of every name. A trace that does not is traced again,
    up to ``TRACES`` traces; then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(LEAD_IN_CYCLES)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = collections.Counter()
        records = collections.Counter()
        for event in prof.events():
            if event.device_type == DeviceType.CUDA and LEAD_IN_KERNEL not in event.name:
                total[event.name] += event.time_range.elapsed_us() / 1e3
                records[event.name] += 1
        short = {name: count for name, count in records.items() if count % iters}
        if records and not short:
            return collections.Counter({name: ms / iters for name, ms in total.items()})
        print(f"device_ms: a trace of {iters} calls held "
              f"{short if records else 'no device records'}, not a multiple of {iters} "
              f"records a kernel; tracing again", flush=True)
    raise RuntimeError(f"the profiler lost device records in {TRACES} traces")


def host_ms(fn, iters: int, warmup: int = 3) -> list:
    """Host-clock times of ``fn`` (which returns host data, so each call ends
    after the device finished)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def cross_bound(B: int, D: int, L: int):
    """Least time for the cross stack: x0 read and the output written once,
    weights and biases read once; 5*B*D*L f32 flops."""
    byte_ms = 4 * (2 * B * D + 2 * L * D) / PEAK_BYTES_PER_S * 1e3
    flop_ms = 5 * B * D * L / PEAK_F32_FLOPS * 1e3
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations"


def check_cross_kernel(cross_fused, cross_network) -> dict:
    """Phase 2: the kernels against their plain version; returns the largest
    absolute error of the forward, by kernel."""
    from recommender_system_tpu_torch.ops.kernels import cross_kernel_takes

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = collections.Counter()
    # the bench shape at the Scorer's and DCN training's batch sizes and
    # at sizes that leave a partial last tile of the tile kernel's 32 rows,
    # a D that is not a multiple of 32 (all on the tile kernel); x0 one float
    # off 16-byte alignment, a D up to 1,024, and weights beyond 48 KB of
    # shared memory (on the register kernel); on the global kernel: DCN's x0
    # at dim 40 (1,053 wide) at the Scorer's and training's batches, x0
    # 1,025 and 1,677 wide (dim 64), each at L = 0, 1 and 6 and off
    # alignment, 29 layers of 1,024 and 12 of 3,000 (weights past the
    # shared memory: staged a chunk of layers at a time), D=3,000 and 4,900
    # (past the registers: the rows kernel)
    for B, D, L, shift in [(1, 221, 6, 0), (1000, 221, 6, 0), (4096, 221, 6, 0),
                           (4097, 221, 6, 0), (8192, 221, 6, 0), (8193, 221, 6, 0),
                           (1000, 100, 6, 0), (4096, 221, 6, 1), (1000, 1000, 6, 0),
                           (1000, 1000, 16, 0), (4096, 1053, 6, 0), (4097, 1053, 6, 1),
                           (8192, 1053, 6, 0), (1000, 1053, 0, 1), (1000, 1053, 1, 0),
                           (1000, 1025, 0, 0), (1000, 1025, 1, 1), (1000, 1025, 6, 1),
                           (1000, 1677, 0, 1), (1000, 1677, 1, 0), (1000, 1677, 6, 0),
                           (1001, 1677, 6, 1), (1000, 1024, 29, 0), (257, 3000, 12, 1),
                           (300, 3000, 3, 0), (257, 4900, 12, 0), (100, 4900, 12, 1)]:
        x0 = torch.randn(B * D + shift, generator=gen, device="cuda")[shift:].view(B, D)
        w = torch.randn(L, D, generator=gen, device="cuda") * (0.2 / math.sqrt(D))
        b = torch.randn(L, D, generator=gen, device="cuda") * 0.1
        with torch.inference_mode():
            out = cross_fused(x0, w, b)
            again = cross_fused(x0, w, b)
            torch.cuda.synchronize()
            ref = cross_network(x0, w, b)
            torch.cuda.synchronize()
            ran = sorted(device_ms(lambda: cross_fused(x0, w, b), iters=1))
        if not torch.equal(out, again):
            raise RuntimeError(f"cross_fused B={B} D={D} L={L}: two launches on identical "
                               "inputs differ")
        if not cross_kernel_takes(x0, w, b):
            want = ("cross_global_kernel" if D <= CROSS_GLOBAL_REGISTER_DIM
                    else "cross_global_rows_kernel")
        else:
            want = "cross_tile_kernel" if D <= 256 and shift == 0 else "cross_stack_kernel"
        if not all(want in name for name in ran):
            raise RuntimeError(f"cross_fused B={B} D={D} L={L} ran {ran}, not {want}")
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        err = (out - ref).abs().max().item()
        max_err[want] = max(max_err[want], err)

        grads = []
        for fn in (cross_fused, cross_network):
            args = [t.clone().requires_grad_(True) for t in (x0, w, b)]
            (fn(*args) ** 2).sum().backward()
            torch.cuda.synchronize()
            grads.append([a.grad for a in args])
        for g_kernel, g_plain, t in zip(*grads, (x0, w, b)):
            # with no layers the plain stack leaves the weights out of the
            # graph (no gradient), the wrapper gives them zeros
            g_plain = torch.zeros_like(t) if g_plain is None else g_plain
            # the cotangent 2*out carries the forward's rounding into sums
            # that cancel, so the absolute tolerance scales with the
            # gradient's largest entry
            scale = g_plain.abs().max().item() if g_plain.numel() else 0.0
            torch.testing.assert_close(g_kernel, g_plain, rtol=RTOL, atol=ATOL * max(1.0, scale))
        print(f"kernel check cross_fused B={B} D={D} L={L}"
              f"{' x0 off 16-byte alignment' if shift else ''}: ran {', '.join(ran)}; "
              f"max_abs_err={err:.3e}, two launches bitwise equal, gradients match",
              flush=True)

    # the global kernel keeps the fast kernels' arithmetic: where the stack
    # kernel takes a shape, the global entry point's answer is bitwise its
    from recommender_system_tpu_torch.ops import kernels
    for B, D, shift in [(4096, 1000, 0), (4097, 1000, 1), (4096, 1024, 0), (1000, 1024, 1)]:
        x0 = torch.randn(B * D + shift, generator=gen, device="cuda")[shift:].view(B, D)
        w = torch.randn(6, D, generator=gen, device="cuda") * (0.2 / math.sqrt(D))
        b = torch.randn(6, D, generator=gen, device="cuda") * 0.1
        with torch.inference_mode():
            fast = cross_fused(x0, w, b)
            ran = sorted(device_ms(lambda: cross_global_entry(x0, w, b), iters=1))
            on_global = cross_global_entry(x0, w, b)
            torch.cuda.synchronize()
        if not all("cross_global_kernel" in name for name in ran):
            raise RuntimeError(f"cross_global_forward B={B} D={D} ran {ran}")
        if not torch.equal(on_global, fast):
            raise RuntimeError(f"cross_global_forward B={B} D={D} L=6 differs from "
                               f"cross_forward by {(on_global - fast).abs().max().item():.3e}")
        print(f"kernel check cross_global_forward B={B} D={D} L=6"
              f"{' x0 off 16-byte alignment' if shift else ''}: ran {', '.join(ran)}; "
              f"bitwise equal to cross_forward's stack kernel", flush=True)
    return max_err


def cross_global_entry(x0, w, b):
    """The global kernel at any shape, through ``csrc/cross.cu``'s entry
    point (the wrapper takes it only where the fast kernels do not); for
    checks, uncounted."""
    from recommender_system_tpu_torch.ops import kernels

    out = torch.empty_like(x0)
    err = kernels._library("cross").cross_global_forward(
        x0.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), *x0.shape, w.shape[0],
        kernels._stream(x0))
    if err != 0:
        raise RuntimeError(f"cross_global_forward failed with CUDA error {err}")
    return out


def fm_bound(B: int, D: int, k: int):
    """Least time for the FM logit: x read once, w1 and v read once, the
    output written once; ``4*B*D*k + 2*B*D`` f32 flops (the TPU kernel's
    cost estimate)."""
    byte_ms = 4 * (B * D + D + D * k + B) / PEAK_BYTES_PER_S * 1e3
    flop_ms = (4 * B * D * k + 2 * B * D) / PEAK_F32_FLOPS * 1e3
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations"


def fm_inputs(gen, B, D, k):
    """Random FM inputs on the card: x normal, w1 and v at 1/sqrt(D) scale."""
    x = torch.randn(B, D, generator=gen, device="cuda")
    w1 = torch.randn(D, 1, generator=gen, device="cuda") / math.sqrt(D)
    v = torch.randn(D, k, generator=gen, device="cuda") / math.sqrt(D)
    return x, w1, v


def check_fm_kernel() -> dict:
    """Phase 2 for csrc/fm.cu: ``fm_fused`` against ``fm_ref`` on the card
    (the forward against ``fm_ref`` in float64), forward and gradient
    through the autograd Function; returns the largest absolute error of
    the forward, by kernel."""
    from recommender_system_tpu_torch.ops.kernels import (FM_ROWS_FACTORS, FM_ROWS_MAX_DIM,
                                                          fm_fused, fm_kernel_takes, fm_ref)

    gen = torch.Generator(device="cuda").manual_seed(6)
    max_err = collections.Counter()
    # the FMLayer path's shape, and at batches that leave a partial last
    # group of the register kernel's 4 rows a warp, the smallest, a
    # dense-column width with a wide factor count (8 chunks), Ds that are
    # not multiples of 32, a factor count that is not a multiple of the wide
    # kernel's chunk of 8, and v past 48 KB of shared memory (the last three
    # on the wide kernel); on the global kernel: past the wide kernel's
    # shared memory at k=8 (D=3,419 and 4,001: rows off 16-byte alignment,
    # its 4-byte copies; 4,000) at batches 1, 1,000 and 16,384, at k=19 (three
    # factor groups) and at a D of 20,000
    global_shapes = [(B, D, 8) for D in (3419, 4000, 4001) for B in (1, 1000, FM_B)]
    for B, D, k in [(16_384, 221, 8), (16_385, 221, 8), (31, 221, 8), (1, 1, 1),
                    (4096, 13, 64), (1000, 100, 8), (333, 45, 3), (257, 221, 20),
                    (64, 1500, 8), *global_shapes, (64, 1500, 19), (7, 20_000, 2)]:
        x, w1, v = fm_inputs(gen, B, D, k)
        with torch.inference_mode():
            out = fm_fused(x, w1, v)
            again = fm_fused(x, w1, v)
            torch.cuda.synchronize()
            # the plain version in float64: in float32 on the card its own
            # sums are up to 4.3e-5 off the exact value at D >= 3,419 and
            # B=16,384, outside the tolerance on ~1 row in 1,600, where the
            # kernels stay within 4e-6 (PERF.md)
            ref = fm_ref(x.double(), w1.double(), v.double()).float()
            plain_err = (fm_ref(x, w1, v) - ref).abs().max().item()
            torch.cuda.synchronize()
            ran = sorted(device_ms(lambda: fm_fused(x, w1, v), iters=1))
        if not torch.equal(out, again):
            raise RuntimeError(f"fm_fused B={B} D={D} k={k}: two launches on identical "
                               "inputs differ")
        if not fm_kernel_takes(x, w1, v):
            want = "fm_global_kernel"
        elif D <= FM_ROWS_MAX_DIM and k <= FM_ROWS_FACTORS:
            want = "fm_rows_kernel"
        else:
            want = "fm_wide_kernel"
        if not all(want in name for name in ran):
            raise RuntimeError(f"fm_fused B={B} D={D} k={k} ran {ran}, not {want}")
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        err = (out - ref).abs().max().item()
        max_err[want] = max(max_err[want], err)
        cot = torch.randn(out.shape, generator=gen, device="cuda")
        grads = []
        for fn in (fm_fused, fm_ref):
            args = [t.clone().requires_grad_(True) for t in (x, w1, v)]
            grads.append(torch.autograd.grad(fn(*args), args, cot))
            torch.cuda.synchronize()
        for g_kernel, g_plain in zip(*grads):
            # both are the plain VJP, on the same inputs
            torch.testing.assert_close(g_kernel, g_plain, rtol=RTOL, atol=ATOL)
        print(f"kernel check fm_fused B={B} D={D} k={k}: ran {', '.join(ran)}; "
              f"max_abs_err={err:.3e} against the plain version in float64 (the plain "
              f"version in float32: {plain_err:.3e}), two launches bitwise equal, gradients "
              f"match", flush=True)
    return max_err


def din_bound(B: int, T: int, K: int, H1: int, H2: int):
    """Least time for the DIN attention: query, keys and mask read and the
    pooled output written once, the weights read once; the scorer's flops
    in their least form, the first layer folded per row,
    2*B*T*(K*H1 + H1*H2 + H2), plus the per-row query term and fold and the
    pooling, 2*B*(2*K*H1 + T*K). Returns (bound, what bounds it, the bound
    in f32 outside the tensor cores): the bound is the tensor cores', where
    an f32-accurate product takes three TF32 passes (3xTF32)."""
    byte_ms, flops = din_work(B, T, K, H1, H2)
    tc_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    f32_ms = max(byte_ms, flops / PEAK_F32_FLOPS * 1e3)
    return max(byte_ms, tc_ms), "bytes" if byte_ms >= tc_ms else "operations", f32_ms


def din_work(B: int, T: int, K: int, H1: int, H2: int):
    """The DIN attention's least bytes (as ms at the memory rate) and flops,
    as ``din_bound`` counts them."""
    nbytes = 4 * (B * K + B * T * K + B * T + B * K
                  + 4 * K * H1 + H1 + H1 * H2 + 2 * H2 + 1)
    flops = 2 * B * T * (K * H1 + H1 * H2 + H2) + 2 * B * (2 * K * H1 + T * K)
    return nbytes / PEAK_BYTES_PER_S * 1e3, flops


def din_backward_work(B: int, T: int, K: int, H1: int, H2: int, pooled: bool = True,
                      positions: int = None):
    """The DIN attention backward's least bytes (as ms at the memory rate)
    and flops: query, keys, mask, the saved weights, the cotangent and the
    parameters read once, dq, dkeys and the parameters' gradients written
    once; the flops in their least form, as ``din_work`` counts the
    forward's (the first layer folded per row): the scorer recomputed,
    2*B*T*(K*H1 + H1*H2 + H2), then du.W2^T and h1^T.du, 2*B*T*H1*H2
    each, dkeys through the row's folded K x H1 matrix and the per-row
    keys^T.dh_pre that gives dBw and dP, 2*B*T*K*H1 each, plus the
    per-row q (Wq + Wm), dq and dA, 2*B*K*H1 each. ``positions`` (B*T
    unless given) counts the positions whose dlogit can be non-zero, the
    unmasked ones: a masked one adds nothing to any product."""
    P = B * T if positions is None else positions
    params = 4 * K * H1 + H1 + H1 * H2 + 2 * H2 + 1
    nbytes = 4 * (2 * B * K + 2 * B * T * K + 2 * B * T + (B * K if pooled else B * T)
                  + 2 * params)
    flops = (2 * P * (K * H1 + H1 * H2 + H2) + 2 * 2 * P * H1 * H2
             + 2 * 2 * P * K * H1 + 3 * 2 * B * K * H1)
    return nbytes / PEAK_BYTES_PER_S * 1e3, flops


def din_backward_bound(B: int, T: int, K: int, H1: int, H2: int, positions: int = None):
    """Least time for the DIN attention's backward, as ``din_bound``:
    (bound, what bounds it, the bound in f32 outside the tensor cores), the
    tensor cores' time in 3xTF32, over all B*T positions or the
    ``positions`` unmasked ones."""
    byte_ms, flops = din_backward_work(B, T, K, H1, H2, positions=positions)
    tc_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    f32_ms = max(byte_ms, flops / PEAK_F32_FLOPS * 1e3)
    return max(byte_ms, tc_ms), "bytes" if byte_ms >= tc_ms else "operations", f32_ms


# phase 2's shapes of the DIN attention's backward: (B, T, K, H1, H2, the
# number of FLAG combinations, or "all"): DIN's and DIEN's width, T not a
# multiple of 4, K=6, T=1, B=1, the tiled kernel's opt-in shared memory;
# the wide kernel's: K=128 at T=50 and T=1, T=515, K=33, 64 and 100 (not a
# multiple of 4), T=65, T=128 with rows of exactly 64, 65 and 128 valid
# positions (``DIN_BACKWARD_LENGTHS``), a 80-40 scorer at K=64, T=100 and a
# narrow one at K=48; the global kernel's: hidden widths past 256, 128-64,
# K=128 by 256-64, 81-40; and the three timed shapes
DIN_BACKWARD_CASES = [(DIN_BATCH, DIN_T, DIN_DIM, 80, 40, "all"),
                      (64, 13, 8, 10, 5, "all"),
                      (100, 7, 6, 12, 3, 4),
                      (300, 1, DIN_DIM, 80, 40, "all"),
                      (1, DIN_T, DIN_DIM, 80, 40, "all"),
                      (257, DIN_T, DIN_DIM, 128, 64, 4),
                      (1024, DIN_T, 128, 80, 40, "all"),
                      (33, 1, 128, 80, 40, 4),
                      (64, 515, DIN_DIM, 80, 40, 4),
                      (100, 13, 8, 300, 260, 4),
                      (64, 20, 128, 256, 64, 4),
                      (257, DIN_T, 33, 80, 40, 4),
                      (300, DIN_T, 64, 80, 40, "all"),
                      (257, DIN_T, 100, 80, 40, 4),
                      (300, 65, DIN_DIM, 80, 40, 4),
                      (71, 128, DIN_DIM, 80, 40, "all"),
                      (71, 128, 128, 80, 40, 4),
                      (257, 100, 64, 80, 40, 2),
                      (257, 100, 64, 81, 40, 2),
                      (64, 70, 48, 10, 5, 4)]
DIN_BACKWARD_CASES += [(DIN_BATCH, T, K_, 80, 40, 2) for K_, T in DIN_GLOBAL_SHAPES]
# rows' valid positions at a case's shape (B, T, K, H1, H2), cycled over its
# rows (else uniform on 1..T), the first row none as phase 2 checks: pairs
# of rows 0 and 64 (one whole tile), 65 and 128 (four tiles, each row
# across two), 1 and 63 (one tile, two rows), 127 and 64 (three tiles)
DIN_BACKWARD_LENGTHS = {(71, 128, DIN_DIM, 80, 40): [0, 64, 65, 128, 1, 63, 127, 64],
                        (71, 128, 128, 80, 40): [0, 64, 65, 128, 1, 63, 127, 64]}
# the batch at which the backward is also held to float64: its rows are the
# first this many of a case's
DIN_F64_ROWS = 1024
# how much farther from float64 the kernel's gradients may be than the
# plain version's f32 ones, each gradient's largest error over its scale
# (``din_grad_scale``; plus 1e-6 of it, for a plain error that rounds to
# 0): the kernel sums in other orders and its products are 3xTF32
DIN_F64_FACTOR = 4.0
# the kernel's gradients against the plain version's f32 ones on the card:
# an element may differ by RTOL of itself plus DIN_GRAD_ATOL of its
# gradient's scale (``din_grad_scale``), since both sum up to B*T products
# in different orders
DIN_GRAD_ATOL = 1e-5


def din_grad_scale(name: str, ref, keys, maskf, saved, cot, flags) -> float:
    """A gradient's scale for its tolerance: its largest magnitude, but for
    db3, the sum of the dlogits, the sum of their magnitudes (under the
    softmax db3 is 0 up to rounding: each row's dlogits sum to 0)."""
    if name != "db3":
        return ref.abs().max().item() or 1.0
    dscore = cot if flags[2] else torch.einsum("bk,btk->bt", cot, keys)
    dl = saved * (dscore - (saved * dscore).sum(-1, keepdim=True)) if flags[1] else dscore
    return torch.where(maskf > 0.5, dl, 0.0).abs().sum().item() or 1.0


# relu's kink: a first- or second-layer pre-activation this close to 0 (in
# float64) may round to either side in the kernel's 3xTF32 sums and in
# cuBLAS's f32 ones, and relu's derivative (JAX's a > 0) flips there
DIN_KINK = 1e-6


def din_kink_rows(q, keys, maskf, weights) -> torch.Tensor:
    """The rows (bool [B]) holding a valid position whose scorer has a
    pre-activation within ``DIN_KINK`` of 0, in float64."""
    w1, b1, w2, b2 = (t.double() for t in weights[:4])
    q64, k64 = q.double(), keys.double()
    K = keys.shape[-1]
    wq, wk, wm, wp = w1[:K], w1[K:2 * K], w1[2 * K:3 * K], w1[3 * K:]
    ck = torch.cat([k64, q64[:, None, :] * k64], dim=-1)
    h_pre = (q64 @ (wq + wm))[:, None, :] + ck @ torch.cat([wk - wm, wp]) + b1
    z = torch.relu(h_pre) @ w2 + b2
    near = (h_pre.abs() < DIN_KINK).any(-1) | (z.abs() < DIN_KINK).any(-1)
    return (near & (maskf > 0.5)).any(-1)


def din_backward_close(q, keys, maskf, weights, saved, cot, flags, global_kernel=False):
    """Hold ``din_attention_backward`` on the card to its plain version in
    f32 and, on the first ``DIN_F64_ROWS`` rows, both to the plain version
    in float64; two kernel calls must agree bitwise. ``global_kernel``
    holds the global kernel instead, where the tile kernel would run.
    Returns (a note of the errors, the largest absolute error against the
    plain version)."""
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.din_vjp import din_attention_backward_ref

    def din_attention_backward(*args):
        return kernels._din_backward_launch(*args, global_kernel=global_kernel)

    names = ("dq", "dkeys", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    kink = ""
    if flags[0] == "relu":
        # rows at relu's kink are left out of both sides: there the kernel
        # and the plain version may each take either side of it
        near = din_kink_rows(q, keys, maskf, weights)
        kink = f"; {int(near.sum())} row(s) at relu's kink left out"
        if int(near.sum()) > 2 + q.shape[0] // 50:
            raise RuntimeError(f"din_attention_backward {flags}: {int(near.sum())} rows of "
                               f"{q.shape[0]} at relu's kink")
        q, keys, maskf, saved, cot = (t[~near] for t in (q, keys, maskf, saved, cot))
    got = din_attention_backward(q, keys, maskf, *weights, saved, cot, *flags)
    again = din_attention_backward(q, keys, maskf, *weights, saved, cot, *flags)
    torch.cuda.synchronize()
    for name, a, b in zip(names, got, again):
        if not torch.equal(a, b):
            raise RuntimeError(f"din_attention_backward {flags}: two calls differ in {name}")
    plain = din_attention_backward_ref(q, keys, maskf, *weights, saved, cot, *flags)
    worst = 0.0
    for name, k, p in zip(names, got, plain):
        scale = din_grad_scale(name, p, keys, maskf, saved, cot, flags)
        if not torch.isfinite(k).all():
            raise RuntimeError(f"din_attention_backward {flags}: {name} not finite")
        torch.testing.assert_close(k, p, rtol=RTOL, atol=DIN_GRAD_ATOL * scale,
                                   msg=lambda m, name=name: f"{name} {flags}: {m}")
        worst = max(worst, (k - p).abs().max().item() / scale)
    abs_err = max((k - p).abs().max().item() for k, p in zip(got, plain))
    note = f"bitwise twice; largest error over the gradient's scale {worst:.3e}{kink}"
    B = min(q.shape[0], DIN_F64_ROWS)
    rows = [t[:B] for t in (q, keys, maskf, saved, cot)]
    got_b = din_attention_backward(rows[0], rows[1], rows[2], *weights, rows[3], rows[4],
                                   *flags)
    plain_b = din_attention_backward_ref(rows[0], rows[1], rows[2], *weights, rows[3], rows[4],
                                         *flags)
    d64 = [t.double() for t in rows]
    w64 = [t.double() for t in weights]
    want = din_attention_backward_ref(d64[0], d64[1], d64[2], *w64, d64[3], d64[4], *flags)
    ratios = []
    for name, k, p, w in zip(names, got_b, plain_b, want):
        scale = din_grad_scale(name, w, d64[1], d64[2], d64[3], d64[4], flags)
        dk = (k.double() - w).abs().max().item() / scale
        dp = (p.double() - w).abs().max().item() / scale
        if dk > DIN_F64_FACTOR * dp + 1e-6:
            raise RuntimeError(f"din_attention_backward {flags}: {name} is {dk:.3e} from "
                               f"float64, more than {DIN_F64_FACTOR} x the plain f32 "
                               f"version's {dp:.3e}")
        ratios.append(f"{name} {dk:.2e}/{dp:.2e}")
    return note + f"; from float64 at B={B}, kernel/plain: {', '.join(ratios)}", abs_err


def din_inputs(gen, B, T, K, H1, H2, lengths=None):
    """Random DIN attention inputs on the card: lengths uniform on 1..T, the
    first row with no valid position (or ``lengths``, cycled over the
    rows); weights at glorot scale."""
    q = torch.randn(B, K, generator=gen, device="cuda")
    keys = torch.randn(B, T, K, generator=gen, device="cuda")
    if lengths is None:
        lengths = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
        lengths[0] = 0
    else:
        lengths = torch.tensor([lengths[i % len(lengths)] for i in range(B)], device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
    weights = []
    for fan_in, fan_out in ((4 * K, H1), (H1, H2), (H2, 1)):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        weights.append((torch.rand(fan_in, fan_out, generator=gen, device="cuda") * 2 - 1)
                       * limit)
        weights.append(torch.randn(fan_out, generator=gen, device="cuda") * 0.1)
    return q, keys, mask, weights


# the backward's errors in check_din_kernel's result, by route
DIN_BACKWARD_ERR_KEY = {"tile": "din_attention_backward", "wide": "din_attention_wide_backward",
                        "global": "din_attention_global_backward"}


def check_din_kernel() -> dict:
    """Phase 2 for csrc/din_attention.cu: ``din_attention_fused`` against
    ``din_attention_ref`` on the card at every case of
    ``DIN_BACKWARD_CASES``; its backward, through the autograd Function,
    bitwise ``din_attention_backward`` on the forward's saved weights (the
    saved weights bitwise the returned ones), and that kernel held to
    ``din_attention_backward_ref`` in f32 and float64
    (``din_backward_close``): the tile kernel where
    ``din_backward_kernel_takes``, the wide kernel where
    ``din_backward_wide_takes`` (at either, the global kernel as well,
    through the launcher's ``global_kernel``), else the global kernel.
    Returns the largest absolute error of the forward by kernel, and of
    the backward's gradients by kernel (``DIN_BACKWARD_ERR_KEY``)."""
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.kernels import (din_attention_backward,
                                                          din_attention_fused, din_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(4)
    flags = [(a, wn, rs) for a in ("sigmoid", "relu") for wn in (True, False)
             for rs in (False, True)]
    max_err = collections.Counter()
    for B, T, K, H1, H2, combos in DIN_BACKWARD_CASES:
        q, keys, mask, weights = din_inputs(gen, B, T, K, H1, H2,
                                            DIN_BACKWARD_LENGTHS.get((B, T, K, H1, H2)))
        maskf = mask.float()
        smem = kernels.din_shared_bytes(T, K, H1, H2)
        fast = kernels.din_kernel_takes(q, keys, maskf, *weights, "sigmoid")
        kernel = "din_attention_kernel" if fast else "din_attention_global_kernel"
        with torch.inference_mode():
            # the bool mask's conversion to float runs beside the kernel
            ran = sorted(name for name in device_ms(
                lambda: din_attention_fused(q, keys, mask, *weights), iters=1)
                if "din_attention" in name)
        if not ran or not all(kernel in name for name in ran):
            raise RuntimeError(f"din_attention_fused B={B} T={T} K={K} H1={H1} H2={H2} "
                               f"ran {ran}, not {kernel}")
        for activation, wn, rs in (flags if combos == "all" else flags[:combos]):
            with torch.inference_mode():
                out = din_attention_fused(q, keys, mask, *weights, activation, wn, rs)
                torch.cuda.synchronize()
                ref = din_attention_ref(q, keys, mask, *weights, activation, wn, rs)
                torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
            err = (out - ref).abs().max().item()
            max_err[kernel] = max(max_err[kernel], err)
            if wn:
                # the first row has no valid position: weights 1/T, the mean key
                want = (torch.full((T,), 1.0 / T, device="cuda") if rs
                        else keys[0].mean(dim=0))
                torch.testing.assert_close(out[0], want, rtol=RTOL, atol=ATOL)
            # the backward: through autograd, one launch of the backward
            # kernel on the forward's saved weights
            with torch.inference_mode():
                _, saved = kernels._din_launch(q, keys, maskf, *weights, activation, wn, rs, True)
                scores, _ = kernels._din_launch(q, keys, maskf, *weights, activation, wn, True)
            if not torch.equal(saved, scores):
                raise RuntimeError(f"din_attention_fused B={B} T={T} K={K} {activation} "
                                   f"{wn} {rs}: the saved weights differ from the returned")
            cot = torch.randn(out.shape, generator=gen, device="cuda")
            route = kernels.din_backward_route(q, keys, maskf, *weights, saved, cot,
                                               activation, rs)
            args = [t.clone().requires_grad_(True) for t in (q, keys, *weights)]

            def backward_counts():
                return (din_attention_backward.launches, din_attention_backward.wide_launches,
                        din_attention_backward.global_launches)

            before = backward_counts()
            got = torch.autograd.grad(din_attention_fused(args[0], args[1], mask, *args[2:],
                                                          activation, wn, rs), args, cot)
            direct = din_attention_backward(q, keys, maskf, *weights, saved, cot, activation,
                                            wn, rs)
            torch.cuda.synchronize()
            want = (before[0] + 2, before[1] + 2 * (route == "wide"),
                    before[2] + 2 * (route == "global"))
            if backward_counts() != want:
                raise RuntimeError(f"din_attention_fused's backward did not launch the "
                                   f"{route} backward kernel once")
            if not all(torch.equal(a, b) for a, b in zip(got, direct)):
                raise RuntimeError(f"din_attention_fused B={B} T={T} K={K} {activation} {wn} "
                                   f"{rs}: its backward differs from din_attention_backward")
            name = DIN_BACKWARD_ERR_KEY[route]
            note, grad_err = din_backward_close(q, keys, maskf, weights, saved, cot,
                                                (activation, wn, rs))
            note = f"{route} kernel: {note}"
            max_err[name] = max(max_err[name], grad_err)
            if route != "global":
                g_note, grad_err = din_backward_close(q, keys, maskf, weights, saved, cot,
                                                      (activation, wn, rs), global_kernel=True)
                note += f"; global kernel: {g_note}"
                max_err["din_attention_global_backward"] = max(
                    max_err["din_attention_global_backward"], grad_err)
            print(f"kernel check din_attention_fused B={B} T={T} K={K} H1={H1} H2={H2} "
                  f"{activation} weight_normalization={wn} return_scores={rs} "
                  f"(tiled kernel's shared memory {smem} B at one row a group): ran "
                  f"{', '.join(re.search(r'din_attention\w*(<\w+>)?', n).group(0) for n in ran)}; "
                  f"max_abs_err={err:.3e}; backward: autograd's bitwise the kernel's, {note}",
                  flush=True)
    return max_err


# tables each sparse row rule reads and writes on a touched row, and its
# flops per touched element
RULE_TABLES = {"sgd": 1, "adagrad": 2, "adam": 3}
RULE_FLOPS = {"sgd": 2, "adagrad": 5, "adam": 12}


def sparse_rows_bound(n: int, touched: int, rows: int, dim: int, rule: str):
    """Least time for a sparse row kernel: the stream (slid and order, which
    fit int32, and f32 cotangents) read once; an update rule reads and
    writes its tables (SGD param; Adagrad param and acc; Adam param, m and
    v) on the touched rows, the scatter-add writes its whole output. A few
    flops per byte, so bytes bound them all. (The port's stream is int64, 8
    bytes a position more than the bound counts.)"""
    stream = 8 * n + 4 * n * dim
    if rule == "scatter":
        nbytes, flops = stream + 4 * rows * dim, n * dim
    else:
        nbytes = stream + 8 * RULE_TABLES[rule] * touched * dim
        flops = n * dim + RULE_FLOPS[rule] * touched * dim
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_F32_FLOPS * 1e3
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations"


def bench_rows(seed: int, batch: int = TRAIN_BATCH) -> np.ndarray:
    """The ``[batch, 26]`` rows of table_d9 that one synthetic Criteo batch
    of bench.py's width looks up (ids of field f offset by f * VOCAB)."""
    from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

    _, X, _ = synthetic_criteo(n_rows=batch, vocab=VOCAB,
                               embedding_dim=FACTOR_DIM, seed=seed)
    return np.stack([X[f"C{f + 1}"].astype(np.int64) + f * VOCAB
                     for f in range(FIELDS)], axis=1)


def din_batch(seed: int, batch: int = DIN_BATCH, negatives: bool = False):
    """One DIN batch as ``benchmarks/model_step.py:86-95`` builds it:
    history lengths uniform on 5..50, padding id 0, random labels; with
    ``negatives``, DIEN's batch (``:99-101``): a sampled history
    ``neg_hist_item_id`` drawn next, padded as the history."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5, DIN_T + 1, size=batch)
    hist = rng.integers(1, DIN_ITEMS, size=(batch, DIN_T)).astype(np.int32)
    hist[np.arange(DIN_T)[None, :] >= lengths[:, None]] = 0
    X = {"user_id": rng.integers(1, DIN_USERS, size=batch).astype(np.int32),
         "item_id": rng.integers(1, DIN_ITEMS, size=batch).astype(np.int32),
         "hist_item_id": hist,
         "price": rng.normal(size=(batch, 1)).astype(np.float32)}
    y = rng.integers(0, 2, size=batch).astype(np.float32)
    if negatives:
        neg = rng.integers(1, DIN_ITEMS, size=(batch, DIN_T)).astype(np.int32)
        neg[np.arange(DIN_T)[None, :] >= lengths[:, None]] = 0
        X["neg_hist_item_id"] = neg
    return X, y


def din_columns(negatives: bool = False, dim: int = DIN_DIM):
    """``benchmarks/model_step.py:79-85``'s DIN schema: table_d32 holds
    user_id's 100,000 rows, then item_id's 200,000, which the history
    shares; with ``negatives``, DIEN's (``:102-104``), whose sampled
    history shares them too. ``dim`` replaces the embedding dim."""
    from recommender_system_tpu_torch.utils.features import (DenseFeat, SparseFeat,
                                                             VarLenSparseFeat)

    cols = (SparseFeat("user_id", DIN_USERS, dim),
            SparseFeat("item_id", DIN_ITEMS, dim, embedding_name="item_id"),
            VarLenSparseFeat(SparseFeat("hist_item_id", DIN_ITEMS, dim,
                                        embedding_name="item_id"), maxlen=DIN_T),
            DenseFeat("price", 1))
    if negatives:
        cols += (VarLenSparseFeat(SparseFeat("neg_hist_item_id", DIN_ITEMS, dim,
                                             embedding_name="item_id"), maxlen=DIN_T),)
    return cols


def din_stream(X) -> np.ndarray:
    """DIN's lookup sites of table_d32 as the fused step concatenates them:
    the [B, 2] user and item group, then the [B, T] history (and DIEN's
    [B, T] sampled history)."""
    group = np.stack([X["user_id"].astype(np.int64),
                      X["item_id"].astype(np.int64) + DIN_USERS], axis=1)
    sites = [group.reshape(-1)]
    sites += [X[name].astype(np.int64).reshape(-1) + DIN_USERS
              for name in ("hist_item_id", "neg_hist_item_id") if name in X]
    return np.concatenate(sites)


def long_lengths() -> list:
    """Segment lengths for the long path's streams (C = ``SPARSE_CHUNK``,
    from which a segment is long): a long segment first; C - 1, C, C + 1,
    2C - 1, 2C + 1, 3C - 1 and 3C + 1 three times, each behind a short
    segment of another length, so that each meets the chunks at several
    offsets; three long segments back to back; a long segment last."""
    from recommender_system_tpu_torch.ops.kernels import SPARSE_CHUNK as C

    lengths = [3 * C + 1]
    for i, n in enumerate([C - 1, C, C + 1, 2 * C - 1, 2 * C + 1, 3 * C - 1, 3 * C + 1] * 3):
        lengths += [1 + 17 * i % 50, n]
    return lengths + [C, 5 * C + 7, C + 3, 2, 4 * C + 5]


def long_streams(gen: torch.Generator):
    """(name, lids, rows) for the long path: one row holding a stream of
    60,000 positions, and the segments of ``long_lengths`` on rows 3 apart,
    the ids in random order."""
    yield "one_row", torch.full((60_000,), 7, device="cuda"), 100
    lengths = torch.tensor(long_lengths(), device="cuda")
    segment_rows = 3 * torch.arange(lengths.numel(), device="cuda")
    lids = torch.repeat_interleave(segment_rows, lengths)
    yield ("long_edges", lids[torch.randperm(lids.numel(), generator=gen, device="cuda")],
           int(segment_rows[-1]) + 1)


# the long path's streams run at these dims (FFM's 1 and 156 among them)
LONG_DIMS = (1, 9, 32, 156)


def sparse_cases(gen: torch.Generator):
    """(name, lids, ct, rows) on the card for phase 2."""
    dev = "cuda"
    rows9 = FIELDS * VOCAB
    bench = torch.as_tensor(bench_rows(0), device=dev).reshape(-1)
    n = bench.numel()
    yield "bench", bench, torch.randn(n, 9, generator=gen, device=dev), rows9
    # dims 1 and 156 are FFM's tables (its linear weights, and 39 fields x
    # k=4 of field-aware factors: four column chunks of 32 and a tail of 28)
    for dim in (1, 8, 9, 16, 32, 33, 128, 156):
        lids = torch.randint(0, 100_000, (200_000,), generator=gen, device=dev)
        yield f"dim{dim}", lids, torch.randn(200_000, dim, generator=gen, device=dev), 100_000
    yield "n1", bench[:1], torch.randn(1, 9, generator=gen, device=dev), rows9
    yield "n0", bench[:0], torch.zeros(0, 9, device=dev), rows9
    last = bench[:1000].clone()
    last[::7] = rows9 - 1
    yield "last_row", last, torch.randn(1000, 9, generator=gen, device=dev), rows9
    # half the ids on one row; the cotangents lie on a grid of 1/8, so that
    # every partial sum of the 213k-term row is exact in f32 and the order
    # of summation cannot matter
    skew = bench.clone()
    skew[::2] = 12_345
    ct = torch.randint(-8, 9, (n, 9), generator=gen, device=dev).float() / 8
    yield "skewed", skew, ct, rows9
    # rows named by the stream whose summed gradient is zero: row 0 (id 0 of
    # field 1, which the batches never hold) with all-zero cotangents at 200
    # positions, row VOCAB with two that cancel; Adam must leave both as
    # they are. The rest on the 1/8 grid.
    zero = bench[:2000].clone()
    ct = torch.randint(-8, 9, (2000, 9), generator=gen, device=dev).float() / 8
    zero[::10] = 0
    ct[::10] = 0.0
    zero[1], zero[2] = VOCAB, VOCAB
    ct[1], ct[2] = 0.5, -0.5
    yield "zero_rows", zero, ct, rows9
    # DIN's two-site stream of table_d32 (425,984 positions), ~184,000 of
    # them on the padding row; cotangents on the 1/8 grid again
    din = torch.as_tensor(din_stream(din_batch(0)[0]), device=dev)
    ct = torch.randint(-8, 9, (din.numel(), DIN_DIM), generator=gen, device=dev).float() / 8
    yield "din_two_sites", din, ct, DIN_USERS + DIN_ITEMS
    # the same stream with the padding row's cotangents zero, as in
    # training: a long row that lazy Adam must leave as it is
    ct = ct.clone()
    ct[din == DIN_USERS] = 0.0
    yield "din_padding_zero", din, ct, DIN_USERS + DIN_ITEMS
    # segments whose lengths cycle through 1..70, 32 times (79,520
    # positions; a cycle is 2,485 = 21 mod 32): a segment starts and ends at
    # every lane of the kernels' 32-position tiles and crosses one, two and
    # three tile boundaries. Rows 3 apart leave untouched rows between them;
    # the ids in random order.
    lengths = torch.arange(1, 71, device=dev).repeat(32)
    segment_rows = 3 * torch.arange(lengths.numel(), device=dev)
    cycled = torch.repeat_interleave(segment_rows, lengths)
    cycled = cycled[torch.randperm(cycled.numel(), generator=gen, device=dev)]
    yield ("cycled_lengths", cycled, torch.randn(cycled.numel(), 9, generator=gen, device=dev),
           int(segment_rows[-1]) + 1)
    # the long path's streams, cotangents on the 1/8 grid (every sum exact,
    # so every rule's plain version is exact too); check_long_order takes
    # them with normal cotangents
    for dim in LONG_DIMS:
        for name, lids, rows in long_streams(gen):
            ct = torch.randint(-8, 9, (lids.numel(), dim), generator=gen, device=dev).float() / 8
            yield f"{name}_d{dim}", lids, ct, rows


SPARSE_KERNELS = ("fused_adagrad_apply", "fused_sgd_apply", "fused_adam_apply",
                  "scatter_add_sorted")
# streams on which the four sparse row kernels launch twice on identical
# inputs and must give bitwise-equal results
TWICE_CASES = ("bench", "skewed", "cycled_lengths", "din_padding_zero",
               *(f"{name}_d{dim}" for name in ("one_row", "long_edges") for dim in LONG_DIMS))


def sgd_on_sums(table, g):
    """SGD's update from the summed gradient ``g`` (``scatter_add_chunked_ref``'s,
    the kernels' order), in PyTorch: ``table - lr * g``."""
    return table - SGD_LR * g


def adam_on_sums(table, m, v, g, step):
    """Lazy Adam's update from the summed gradient ``g`` (one row each), in
    ``fused_adam_ref``'s operations: the plain version on a stream that
    names every row once with its sum as the cotangent."""
    from recommender_system_tpu_torch.ops.fused_adagrad import fused_adam_ref

    rows = torch.arange(g.shape[0], device=g.device)
    return fused_adam_ref(table, m, v, rows, g, ADAM_LR, step)


def check_sparse_rows() -> dict:
    """Phase 2 for csrc/sparse_rows.cu: the four kernels against their plain
    versions; the scatter-add bitwise equal to ``scatter_add_chunked_ref``
    (its own order), Adagrad's accumulator to ``acc + G * G`` of that sum,
    SGD's table to ``table - lr * G`` and lazy Adam's table and moments to
    ``fused_adam_ref``'s formula on G; returns the largest absolute error of
    each against its plain version."""
    from recommender_system_tpu_torch.ops.embedding_grad import (
        scatter_add_chunked_ref, scatter_add_dense_ref, scatter_add_sorted)
    from recommender_system_tpu_torch.ops.fused_adagrad import (
        fused_adagrad_apply, fused_adagrad_ref, fused_adam_apply, fused_adam_ref,
        fused_sgd_apply, fused_sgd_ref)
    from recommender_system_tpu_torch.ops.stream_sort import blocked_sort, sort_ids

    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = dict.fromkeys(SPARSE_KERNELS, 0.0)

    def close(name, got, want):
        tol = SPARSE_ATOL_SCALE * max(want.abs().max().item(), 1e-30)
        torch.testing.assert_close(got, want, rtol=SPARSE_RTOL, atol=tol,
                                   msg=lambda m: f"{name} {case}: {m}")
        err = (got - want).abs().max().item()
        errs[name] = max(errs[name], err)
        return err

    def unchanged(name, keep, pairs):
        if not all(torch.equal(new[keep], old[keep]) for new, old in pairs):
            raise RuntimeError(f"{name} {case}: a row it must not update changed")

    def same_again(name, first, launch):
        """On the TWICE_CASES streams: a second launch on identical inputs
        gives bitwise the same tensors."""
        if case in TWICE_CASES and not all(map(torch.equal, first, launch())):
            raise RuntimeError(f"{name} {case}: two launches on identical inputs differ")

    for case, lids, ct, rows in sparse_cases(gen):
        dim = ct.shape[1]
        slid, order = sort_ids(lids)
        if case == "bench":
            # the stream the lookup gives the kernels: blocked_sort of [B, F]
            ranges = [(f * VOCAB, VOCAB) for f in range(FIELDS)]
            slid, order = blocked_sort(lids.reshape(-1, FIELDS), ranges)
            if not torch.equal(slid, lids[order]):
                raise RuntimeError("blocked_sort's stream does not read back the ids")
        presorted = (slid, order)
        touched = torch.zeros(rows, dtype=torch.bool, device="cuda")
        touched[lids] = True

        out = scatter_add_sorted(slid, order, ct, rows)
        want = scatter_add_dense_ref(lids, ct, rows)
        torch.cuda.synchronize()
        e_scatter = close("scatter_add_sorted", out, want)
        if out[~touched].count_nonzero().item():
            raise RuntimeError(f"scatter_add_sorted {case}: an untouched row is not 0")
        chunked = scatter_add_chunked_ref(slid, order, ct, rows)
        if not torch.equal(out, chunked):
            raise RuntimeError(f"scatter_add_sorted {case}: differs from its order's sum by "
                               f"{(out - chunked).abs().max().item():.3e}")
        same_again("scatter_add_sorted", (out,),
                   lambda: (scatter_add_sorted(slid, order, ct, rows),))
        # Adam's rows: touched with a summed gradient that is not zero
        nonzero = want.ne(0).any(dim=1)

        table = torch.randn(rows, dim, generator=gen, device="cuda")
        acc = 0.1 + torch.rand(rows, dim, generator=gen, device="cuda")
        t1, a1 = table.clone(), acc.clone()
        fused_adagrad_apply(t1, a1, lids, ct, lr=LR, eps=EPS, presorted=presorted)
        want_t, want_a = fused_adagrad_ref(table, acc, lids, ct, LR, EPS)
        torch.cuda.synchronize()
        e_adagrad = max(close("fused_adagrad_apply", t1, want_t),
                        close("fused_adagrad_apply", a1, want_a))
        unchanged("fused_adagrad_apply", ~touched, [(t1, table), (a1, acc)])
        if not torch.equal(a1, acc + chunked * chunked):
            raise RuntimeError(f"fused_adagrad_apply {case}: acc is not acc + G * G of "
                               f"scatter_add_chunked_ref's G")
        same_again("fused_adagrad_apply", (t1, a1),
                   lambda: fused_adagrad_apply(table.clone(), acc.clone(), lids, ct, lr=LR,
                                               eps=EPS, presorted=presorted))

        t1 = table.clone()
        fused_sgd_apply(t1, lids, ct, lr=SGD_LR, presorted=presorted)
        want_t = fused_sgd_ref(table, lids, ct, SGD_LR)
        torch.cuda.synchronize()
        e_sgd = close("fused_sgd_apply", t1, want_t)
        unchanged("fused_sgd_apply", ~touched, [(t1, table)])
        if not torch.equal(t1, sgd_on_sums(table, chunked)):
            raise RuntimeError(f"fused_sgd_apply {case}: the table is not table - lr * G of "
                               f"scatter_add_chunked_ref's G")
        same_again("fused_sgd_apply", (t1,),
                   lambda: (fused_sgd_apply(table.clone(), lids, ct, lr=SGD_LR,
                                            presorted=presorted),))

        e_adam = 0.0
        for step in (0, 3):
            if step == 0:
                m = torch.zeros_like(table)
                v = torch.zeros_like(table)
            else:
                m = 0.1 * torch.randn(rows, dim, generator=gen, device="cuda")
                v = 0.01 * torch.rand(rows, dim, generator=gen, device="cuda")
            state = [t.clone() for t in (table, m, v)]
            fused_adam_apply(*state, lids, ct, lr=ADAM_LR, step=step, presorted=presorted)
            wants = fused_adam_ref(table, m, v, lids, ct, ADAM_LR, step)
            torch.cuda.synchronize()
            for got, w in zip(state, wants):
                e_adam = max(e_adam, close("fused_adam_apply", got, w))
            unchanged("fused_adam_apply", ~nonzero, zip(state, (table, m, v)))
            on_sums = adam_on_sums(table, m, v, chunked, step)
            if not all(map(torch.equal, state, on_sums)):
                diff = max((a - b).abs().max().item() for a, b in zip(state, on_sums))
                raise RuntimeError(f"fused_adam_apply {case} step {step}: param, m and v are "
                                   f"not fused_adam_ref's formula on scatter_add_chunked_ref's "
                                   f"G (largest difference {diff:.3e})")

            def adam_again(step=step, m=m, v=v):
                again = [t.clone() for t in (table, m, v)]
                fused_adam_apply(*again, lids, ct, lr=ADAM_LR, step=step, presorted=presorted)
                return again

            same_again("fused_adam_apply", state, adam_again)
        zero_rows = int((touched & ~nonzero).sum())
        twice = (" scatter-add, Adagrad, SGD and Adam bitwise equal over two launches;"
                 if case in TWICE_CASES else "")
        twice += (" the scatter-add, Adagrad's acc, SGD's table and Adam's table and moments"
                  " bitwise equal to their formulas on scatter_add_chunked_ref's sums;")
        print(f"kernel check sparse rows {case}: N={lids.numel()} rows={rows} dim={dim} "
              f"touched={int(touched.sum())} (summed gradient zero: {zero_rows}): "
              f"max_abs_err scatter_add_sorted {e_scatter:.3e}, fused_adagrad_apply "
              f"{e_adagrad:.3e}, fused_sgd_apply {e_sgd:.3e}, fused_adam_apply "
              f"{e_adam:.3e} (steps 0 and 3);{twice} untouched rows equal", flush=True)
        if case == "zero_rows" and zero_rows != 2:
            raise RuntimeError(f"zero_rows: {zero_rows} rows with a zero sum, want 2")
        if case == "din_padding_zero" and (nonzero[DIN_USERS] or not touched[DIN_USERS]):
            raise RuntimeError("din_padding_zero: the padding row is not a touched row "
                               "with a zero sum")
    return errs


def check_long_order() -> dict:
    """Phase 2 for the long path of the four sparse row rules, on
    ``long_streams`` at ``LONG_DIMS`` with normal cotangents (so that the
    order of the sums shows): each rule twice, bitwise equal; the
    scatter-add bitwise equal to ``scatter_add_chunked_ref``, Adagrad's
    accumulator to ``acc + G * G`` of that sum and its table to the update
    from it within SPARSE_RTOL / SPARSE_ATOL_SCALE (rsqrtf is not correctly
    rounded), SGD's table to ``table - lr * G`` and lazy Adam's table and
    moments (steps 0 and 3) to ``fused_adam_ref``'s formula on G, both
    bitwise; the one row's sum against its float64 sum. Returns the one
    row's error in each dim."""
    from recommender_system_tpu_torch.ops.embedding_grad import (scatter_add_chunked_ref,
                                                                 scatter_add_sorted)
    from recommender_system_tpu_torch.ops.fused_adagrad import (fused_adagrad_apply,
                                                                fused_adam_apply,
                                                                fused_sgd_apply)
    from recommender_system_tpu_torch.ops.kernels import SPARSE_CHUNK, SPARSE_SHARES
    from recommender_system_tpu_torch.ops.stream_sort import sort_ids

    gen = torch.Generator(device="cuda").manual_seed(4)
    errs = {}
    for dim in LONG_DIMS:
        for name, lids, rows in long_streams(gen):
            case = f"{name}_d{dim} (normal cotangents)"
            ct = torch.randn(lids.numel(), dim, generator=gen, device="cuda")
            slid, order = sort_ids(lids)
            out = scatter_add_sorted(slid, order, ct, rows)
            again = scatter_add_sorted(slid, order, ct, rows)
            want = scatter_add_chunked_ref(slid, order, ct, rows)
            table = torch.randn(rows, dim, generator=gen, device="cuda")
            acc = 0.1 + torch.rand(rows, dim, generator=gen, device="cuda")
            states = [(table.clone(), acc.clone()) for _ in range(2)]
            for t, a in states:
                fused_adagrad_apply(t, a, lids, ct, lr=LR, eps=EPS, presorted=(slid, order))
            torch.cuda.synchronize()
            if not (torch.equal(out, again) and all(map(torch.equal, *states))):
                raise RuntimeError(f"long path {case}: two launches on identical inputs differ")
            if not torch.equal(out, want):
                raise RuntimeError(f"scatter_add_sorted {case}: differs from "
                                   f"scatter_add_chunked_ref by "
                                   f"{(out - want).abs().max().item():.3e}")
            want_a = acc + want * want
            if not torch.equal(states[0][1], want_a):
                raise RuntimeError(f"fused_adagrad_apply {case}: acc is not acc + G * G")
            want_t = table - LR * want * torch.where(want_a > 0, torch.rsqrt(want_a + EPS), 0.0)
            torch.testing.assert_close(
                states[0][0], want_t, rtol=SPARSE_RTOL,
                atol=SPARSE_ATOL_SCALE * want_t.abs().max().item(),
                msg=lambda m: f"fused_adagrad_apply {case}: {m}")
            sgd = [table.clone() for _ in range(2)]
            for t in sgd:
                fused_sgd_apply(t, lids, ct, lr=SGD_LR, presorted=(slid, order))
            if not (torch.equal(*sgd) and torch.equal(sgd[0], sgd_on_sums(table, want))):
                raise RuntimeError(f"fused_sgd_apply {case}: two launches differ, or the "
                                   f"table is not table - lr * G")
            for step in (0, 3):
                m, v = torch.zeros_like(table), torch.zeros_like(table)
                if step > 0:
                    m = 0.1 * torch.randn(rows, dim, generator=gen, device="cuda")
                    v = 0.01 * torch.rand(rows, dim, generator=gen, device="cuda")
                adam = [[t.clone() for t in (table, m, v)] for _ in range(2)]
                for state in adam:
                    fused_adam_apply(*state, lids, ct, lr=ADAM_LR, step=step,
                                     presorted=(slid, order))
                on_sums = adam_on_sums(table, m, v, want, step)
                if not (all(map(torch.equal, *adam))
                        and all(map(torch.equal, adam[0], on_sums))):
                    raise RuntimeError(f"fused_adam_apply {case} step {step}: two launches "
                                       f"differ, or param, m and v are not fused_adam_ref's "
                                       f"formula on G")
            note = ""
            if name == "one_row":
                # the recursive-summation bound: each term passes through at
                # most depth = (a piece's positions) + (a share's pieces) +
                # 3 (the tree) additions in f32, so |G - exact| <= depth * u
                # / (1 - depth * u) * sum|x|, u = 2**-24
                pieces = -(-lids.numel() // SPARSE_CHUNK)
                depth = SPARSE_CHUNK + -(-pieces // SPARSE_SHARES) + 3
                u = 2.0 ** -24
                exact = ct.double().sum(0)
                bound = depth * u / (1 - depth * u) * ct.double().abs().sum(0)
                err = (out[7].double() - exact).abs()
                library = (ct.sum(0).double() - exact).abs()
                if not bool((err <= bound).all()):
                    raise RuntimeError(f"scatter_add_sorted {case}: the row's sum is "
                                       f"{err.max().item():.3e} off its float64 sum, past "
                                       f"the bound {bound.min().item():.3e}")
                errs[dim] = err.max().item()
                note = (f"; the row's sum {err.max().item():.3e} off its float64 sum (bound "
                        f"{bound.min().item():.3e}; torch.sum in f32 "
                        f"{library.max().item():.3e})")
            print(f"kernel check long path {case}: N={lids.numel()} rows={rows}: the "
                  f"four rules bitwise equal over two launches, the scatter-add, Adagrad's "
                  f"acc, SGD's table and Adam's table and moments (steps 0 and 3) bitwise "
                  f"equal to their formulas on scatter_add_chunked_ref's sums, Adagrad's "
                  f"table within rtol {SPARSE_RTOL}{note}", flush=True)
    return errs


def staged_batches(seeds, device="cuda", batch=TRAIN_BATCH, dim=FACTOR_DIM):
    """bench.py's pre-staged batches: synthetic Criteo of the bench width
    (columns at embedding dim ``dim``), one seed per batch, stacked on a
    leading K axis on ``device``."""
    from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

    data = [synthetic_criteo(n_rows=batch, vocab=VOCAB,
                             embedding_dim=dim, seed=s) for s in seeds]
    cols = data[0][0]
    batches = {k: torch.as_tensor(np.stack([X[k] for _, X, _ in data]), device=device)
               for k in data[0][1]}
    labels = torch.as_tensor(np.stack([y for _, _, y in data]), device=device)
    return cols, batches, labels


def deepfm(cols, dnn_dtype, device="cuda", seed=0):
    from recommender_system_tpu_torch import DeepFM

    return DeepFM(tuple(cols), hidden_units=(256, 128, 64), dnn_dtype=dnn_dtype,
                  device=device, generator=torch.Generator().manual_seed(seed))


def touched_rows(batches, rows: int) -> torch.Tensor:
    """The rows of a Criteo table (field f's ids offset by f * VOCAB) that
    the staged batches look up, as a bool mask on the card."""
    touched = torch.zeros(rows, dtype=torch.bool, device="cuda")
    for f in range(FIELDS):
        touched[batches[f"C{f + 1}"].reshape(-1).long().clamp(0, VOCAB - 1) + f * VOCAB] = True
    return touched


def train_checked(name, model, batches, labels, optimizer, fused, calls, want, card,
                  touched=None, loss_fn=None):
    """``calls`` K-step calls of ``model`` through ``Trainer`` (the third,
    the first replay of the graph that the second captured, under
    ``set_sync_debug_mode("error")``: no step may wait for the device; a
    capture synchronises); the launches must equal ``want``, the losses be finite and,
    over several calls, fall; table rows that ``touched`` (default: the
    Criteo rows the batches look up) leaves out keep their values and slots
    bitwise, in every ``table_d*`` of the model; a BatchNorm's statistics
    move. ``loss_fn`` replaces the Trainer's ``default_loss``. Returns
    (trainer, launches)."""
    from recommender_system_tpu_torch import Trainer
    from recommender_system_tpu_torch.training import default_loss

    tables = {n: p for n, p in model.named_parameters()
              if n.rsplit(".", 1)[-1].startswith("table_d")}
    trainer = Trainer(model, optimizer, fused_embedding=fused,
                      loss_fn=loss_fn or default_loss)
    start = {n: [t.detach().clone(), *(s.clone() for s in trainer.fused_slots[n])]
             for n, t in tables.items()}
    bn_start = model.bn.running_mean.clone() if hasattr(model, "bn") else None
    print(f"{name}: {', '.join(f'{n} {tuple(t.shape)}' for n, t in tables.items())}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{type(optimizer).__name__} + {type(fused).__name__}", flush=True)

    zero_counts()
    calls_out = []
    for call in range(calls):
        if call == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            calls_out.append(trainer.multi_step(batches, labels))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"{name} training launches: {launches} over {calls} call(s) of K={K}", flush=True)
    if launches != want:
        raise RuntimeError(f"{name} training launched {launches}, want {want}")
    losses = torch.stack(calls_out).cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{name} training losses not finite: {losses}")
    if calls > 1 and not losses[-1].mean() < losses[0].mean():
        raise RuntimeError(f"{name} training loss did not fall: {losses}")

    untouched = []
    for tname, table in tables.items():
        mask = touched if touched is not None else touched_rows(batches, table.shape[0])
        after = [table.detach(), *trainer.fused_slots[tname]]
        if not all(torch.equal(a[~mask], b[~mask]) for a, b in zip(after, start[tname])):
            raise RuntimeError(f"{name} training changed a row of {tname} (or its slots) "
                               "no batch touched")
        if torch.equal(table.detach()[mask], start[tname][0][mask]):
            raise RuntimeError(f"{name} training left every touched row of {tname} as it was")
        untouched.append(f"{int((~mask).sum())} of {tname} with their "
                         f"{len(start[tname]) - 1} slot(s)")
    note = ""
    if bn_start is not None:
        moved = (model.bn.running_mean - bn_start).abs().max().item()
        if moved == 0.0:
            raise RuntimeError(f"{name} training left the BatchNorm statistics as they were")
        note = f"; BatchNorm running mean moved by up to {moved:.4g}"
    sync = (" (call 3, a graph replay, under set_sync_debug_mode('error'))"
            if calls > 2 else "")
    print(f"{name} training: mean loss per call {[float(x) for x in losses.mean(axis=1)]}"
          f"{sync}; untouched rows bitwise unchanged: {'; '.join(untouched)}{note}; "
          f"on {card}", flush=True)
    return trainer, launches


def train_fused(cols, batches, labels, card):
    """Phase 3b: three fused calls, then evaluate; returns (trainer,
    launches)."""
    from recommender_system_tpu_torch import FusedAdagrad
    from recommender_system_tpu_torch.training import Adagrad
    from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

    trainer, launches = train_checked(
        "DeepFM", deepfm(cols, torch.bfloat16), batches, labels, Adagrad(LR),
        FusedAdagrad(LR), 3, launches_want(fused_adagrad_apply=3 * K), card)
    _, X_test, y_test = synthetic_criteo(n_rows=65_536, vocab=VOCAB,
                                         embedding_dim=FACTOR_DIM, seed=100)
    t0 = time.perf_counter()
    metrics = trainer.evaluate(X_test, y_test, batch_size=TRAIN_BATCH)
    print(f"fused training: evaluate on 65,536 held-out rows {metrics} in "
          f"{time.perf_counter() - t0:.2f} s; on {card}", flush=True)
    if not np.isfinite(metrics["logloss"]) or not 0.0 <= metrics["auc"] <= 1.0:
        raise RuntimeError(f"evaluate gave {metrics}")
    return trainer, launches


def train_plain(cols, batches, labels):
    """Phase 3c: returns the launches of one plain K-step call."""
    from recommender_system_tpu_torch import Trainer
    from recommender_system_tpu_torch.training import Adagrad

    trainer = Trainer(deepfm(cols, torch.bfloat16), Adagrad(LR))
    zero_counts()
    losses = trainer.multi_step(batches, labels).cpu().numpy()
    launches = read_counts()
    print(f"plain training launches: {launches} over 1 call of K={K}; losses {losses}",
          flush=True)
    if launches != launches_want(scatter_add_sorted=K):
        raise RuntimeError(f"plain training launched {launches}, want {K} "
                           "scatter_add_sorted and nothing else")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"plain training losses not finite: {losses}")
    return launches


def card_against_cpu(model, batches, labels, name, optimizer=None, fused=None,
                     loss_fn=None):
    """Phases 3d, 3f and 3g: two fused steps at full width (f32) on the card
    and on the CPU from the same start; parameters, BatchNorm statistics and
    optimizer states agree. ``optimizer`` and ``fused`` make the Trainer's
    optimizers (default ``Adagrad(LR)`` and ``FusedAdagrad(LR)``);
    ``loss_fn`` replaces its ``default_loss``."""
    from recommender_system_tpu_torch import FusedAdagrad, Trainer
    from recommender_system_tpu_torch.training import Adagrad, default_loss

    optimizer = optimizer or (lambda: Adagrad(LR))
    loss_fn = loss_fn or default_loss
    fused = fused or (lambda: FusedAdagrad(LR))
    cpu_model = copy.deepcopy(model).to("cpu")
    runs = {}
    for device, m in (("cuda", model), ("cpu", cpu_model)):
        trainer = Trainer(m, optimizer(), fused_embedding=fused(), device=device,
                          loss_fn=loss_fn)
        sub = {k: v[:2].to(device) for k, v in batches.items()}
        trainer.multi_step(sub, labels[:2].to(device))
        # parameters and persistent buffers (BatchNorm statistics)
        state = {n: t.detach().cpu() for n, t in m.state_dict().items()}
        state.update({f"opt:{key}:{n}": t.cpu() for n, slots in trainer.opt_state.items()
                      for key, t in slots.items()})
        state.update({f"slot{i}:{n}": t.cpu() for n, slots in trainer.fused_slots.items()
                      for i, t in enumerate(slots)})
        runs[device] = state
    worst = 0.0
    for key, want in runs["cpu"].items():
        got = runs["cuda"][key]
        torch.testing.assert_close(got, want, rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   msg=lambda m, key=key: f"{key}: {m}")
        worst = max(worst, (got - want).abs().max().item())
    print(f"card against CPU, {name}: {len(runs['cpu'])} parameters, statistics and "
          f"optimizer states agree after {min(2, labels.shape[0])} fused step(s) "
          f"(rtol={PARITY_RTOL}, atol={PARITY_ATOL}); largest difference {worst:.3e}",
          flush=True)


def time_sparse_rows(card) -> dict:
    """Phase 4 for the sparse row kernels at the bench shape: device time,
    time per call, plain version, library call, bound; each kernel's device
    time on the bench stream with every other id on one hot row and on DIN's
    step stream (two sites of table_d32, the padding row's cotangents zero
    as in training), with each stream's bound and, for the scatter-add and
    SGD, ``index_add_`` on it."""
    from recommender_system_tpu_torch.ops.embedding_grad import (
        scatter_add_dense_ref, scatter_add_sorted)
    from recommender_system_tpu_torch.ops.fused_adagrad import (
        fused_adagrad_apply, fused_adagrad_ref, fused_adam_apply, fused_adam_ref,
        adam_scalars, fused_sgd_apply, fused_sgd_ref)
    from recommender_system_tpu_torch.ops.stream_sort import blocked_sort, sort_ids

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, dim = FIELDS * VOCAB, FACTOR_DIM + 1
    rows2d = torch.as_tensor(bench_rows(0), device="cuda")
    lids = rows2d.reshape(-1)
    n = lids.numel()
    slid, order = blocked_sort(rows2d, [(f * VOCAB, VOCAB) for f in range(FIELDS)])
    ct = torch.randn(n, dim, generator=gen, device="cuda") * 1e-3
    table = torch.randn(rows, dim, generator=gen, device="cuda") * 1e-4
    acc = torch.full((rows, dim), 0.1, device="cuda")
    m, v = torch.zeros_like(table), torch.zeros_like(table)
    touched = int(torch.unique(lids).numel())
    hot = lids.clone()
    hot[::2] = 12_345
    hot_slid, hot_order = sort_ids(hot)
    hot_touched = int(torch.unique(hot).numel())

    din_lids = torch.as_tensor(din_stream(din_batch(0)[0]), device="cuda")
    din_ct = torch.randn(din_lids.numel(), DIN_DIM, generator=gen, device="cuda") * 1e-3
    din_ct[din_lids == DIN_USERS] = 0.0
    din_table = torch.randn(DIN_USERS + DIN_ITEMS, DIN_DIM, generator=gen, device="cuda")
    din_state = [torch.full_like(din_table, 0.1), torch.zeros_like(din_table),
                 torch.zeros_like(din_table)]
    din_sorted = sort_ids(din_lids)
    din_rows = DIN_USERS + DIN_ITEMS
    din_touched = int(torch.unique(din_lids).numel())
    lr, sgd_lr = on_card(LR), on_card(SGD_LR)
    adam = on_card(*adam_scalars(ADAM_LR, 0, 0.9, 0.999))
    # zeroing a buffer past the 50 MB L2 before a call leaves the call's
    # stream and cotangents in device memory, as a training step leaves them
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def walk_ms(fn):
        """Device time of the sparse row kernel alone, the L2 flushed
        before each call."""
        dev = device_ms(lambda: (flush.zero_(), fn()), iters=5)
        return sum(ms for name, ms in dev.items() if "sparse_rows" in name)

    out = {}
    # name: (kernel, plain version, hot row, DIN's stream, library call on
    # the three streams, rule, kernel name)
    fns = {
        "fused_adagrad_apply": (
            lambda: fused_adagrad_apply(table, acc, lids, ct, eps=EPS, scalars=lr,
                                        presorted=(slid, order)),
            lambda: fused_adagrad_ref(table, acc, lids, ct, eps=EPS, scalars=lr),
            lambda: fused_adagrad_apply(table, acc, hot, ct, eps=EPS, scalars=lr,
                                        presorted=(hot_slid, hot_order)),
            lambda: fused_adagrad_apply(din_table, din_state[0], din_lids, din_ct, eps=EPS,
                                        scalars=lr, presorted=din_sorted),
            None, "adagrad", "sparse_rows"),
        "fused_sgd_apply": (
            lambda: fused_sgd_apply(table, lids, ct, scalars=sgd_lr, presorted=(slid, order)),
            lambda: fused_sgd_ref(table, lids, ct, scalars=sgd_lr),
            lambda: fused_sgd_apply(table, hot, ct, scalars=sgd_lr,
                                    presorted=(hot_slid, hot_order)),
            lambda: fused_sgd_apply(din_table, din_lids, din_ct, scalars=sgd_lr,
                                    presorted=din_sorted),
            # one PyTorch call for the same update; it rounds per position
            (lambda: table.index_add_(0, lids, ct, alpha=-SGD_LR),
             lambda: table.index_add_(0, hot, ct, alpha=-SGD_LR),
             lambda: din_table.index_add_(0, din_lids, din_ct, alpha=-SGD_LR)),
            "sgd", "sparse_rows"),
        "fused_adam_apply": (
            lambda: fused_adam_apply(table, m, v, lids, ct, scalars=adam,
                                     presorted=(slid, order)),
            lambda: fused_adam_ref(table, m, v, lids, ct, scalars=adam),
            lambda: fused_adam_apply(table, m, v, hot, ct, scalars=adam,
                                     presorted=(hot_slid, hot_order)),
            lambda: fused_adam_apply(din_table, *din_state[1:], din_lids, din_ct,
                                     scalars=adam, presorted=din_sorted),
            None, "adam", "sparse_rows"),
        "scatter_add_sorted": (
            lambda: scatter_add_sorted(slid, order, ct, rows),
            lambda: scatter_add_dense_ref(lids, ct, rows),
            lambda: scatter_add_sorted(hot_slid, hot_order, ct, rows),
            lambda: scatter_add_sorted(*din_sorted, din_ct, din_rows),
            # the zero fill and index_add_, as the kernel's zero fill and walk
            (lambda: torch.zeros(rows, dim, device="cuda").index_add_(0, lids, ct),
             lambda: torch.zeros(rows, dim, device="cuda").index_add_(0, hot, ct),
             lambda: torch.zeros(din_rows, DIN_DIM, device="cuda").index_add_(
                 0, din_lids, din_ct)),
            "scatter", None),
    }
    for name, (kernel_fn, plain_fn, hot_fn, din_fn, library, rule, only) in fns.items():
        library_fn, hot_library_fn, din_library_fn = library or (None, None, None)
        kernel_dev = device_ms(kernel_fn)
        if only and not all(only in k for k in kernel_dev):
            raise RuntimeError(f"{name} ran other device work: {dict(kernel_dev)}")
        plain_dev = device_ms(plain_fn)
        rec = {"ms": sum(kernel_dev.values()), "plain_ms": sum(plain_dev.values()),
               "call_ms": call_ms(kernel_fn), "plain_call_ms": call_ms(plain_fn),
               "library_ms": sum(device_ms(library_fn).values()) if library_fn else None,
               "hot_row_ms": sum(device_ms(hot_fn, iters=5).values()),
               "hot_row_cold_ms": walk_ms(hot_fn), "hot_row_clocks": clocks_during(hot_fn),
               "hot_row_library_ms": (sum(device_ms(hot_library_fn, iters=5).values())
                                      if hot_library_fn else None)}
        rec["hot_row_bound_ms"], _ = sparse_rows_bound(n, hot_touched, rows, dim, rule)
        if din_fn:
            rec["din_stream_ms"] = sum(device_ms(din_fn, iters=5).values())
            rec["din_stream_cold_ms"] = walk_ms(din_fn)
            rec["din_stream_library_ms"] = (sum(device_ms(din_library_fn, iters=5).values())
                                            if din_library_fn else None)
            rec["din_stream_bound_ms"], _ = sparse_rows_bound(
                din_lids.numel(), din_touched, din_rows, DIN_DIM, rule)
        rec["bound_ms"], rec["bound_by"] = sparse_rows_bound(n, touched, rows, dim, rule)
        out[name] = rec
        split = ", ".join(f"{(re.search(r'sparse_rows\w*', k) or re.search(r'.*', k)).group(0)[:40]} "
                          f"{v:.5f}" for k, v in kernel_dev.most_common())

        def ms(key):
            return "none" if rec.get(key) is None else f"{rec[key]:.5f} ms"

        din = (f"; on DIN's step stream ({din_lids.numel()} positions, "
               f"{int((din_lids == DIN_USERS).sum())} on the padding row; bound "
               f"{rec['din_stream_bound_ms']:.5f} ms): device {rec['din_stream_ms']:.5f} ms, "
               f"the kernels {rec['din_stream_cold_ms']:.5f} ms with the L2 flushed before "
               f"each call, library {ms('din_stream_library_ms')}" if din_fn else "")
        print(f"timing {name} N={n} U={touched} rows={rows} dim={dim}: device "
              f"{rec['ms']:.5f} ms ({split}; {100 * rec['bound_ms'] / rec['ms']:.1f}% "
              f"of the bound {rec['bound_ms']:.5f} ms, {rec['bound_by']}), "
              f"{rec['call_ms']:.5f} ms per call; plain: device {rec['plain_ms']:.5f} ms, "
              f"{rec['plain_call_ms']:.5f} ms per call; library {ms('library_ms')}; with "
              f"{n // 2} positions on one row (bound {rec['hot_row_bound_ms']:.5f} ms): "
              f"device {rec['hot_row_ms']:.5f} ms, the kernels {rec['hot_row_cold_ms']:.5f} "
              f"ms with the L2 flushed before each call, library "
              f"{ms('hot_row_library_ms')}, the clocks (SM, memory) {rec['hot_row_clocks']} "
              f"during its walks{din}; on {card}", flush=True)
    return out


def time_training(trainer, batches, labels, card, name) -> dict:
    """Phase 4 for a training path, for both forms of a K-step call: graphed
    (``multi_step``, one CUDA graph replay a call) and looped
    (``make_multi_step(graphed=False)``, the steps issued op by op): ms a
    step by CUDA events over 5 calls, the device's busy time and idle share
    over 3 traced calls, the top device work of a step and the host ops a
    call issues. Returns the graphed form's ``step_ms``, ``busy_ms`` and
    ``per_step`` (device ms by kernel name; the looped form's where the
    profiler sees no kernel of a graph) and the looped form's as
    ``looped_step_ms`` and ``looped_busy_ms``. A Trainer of a tree without
    graphs (``chip_turns.py``'s parent) is timed looped alone, through its
    ``multi_step``."""
    from torch.profiler import ProfilerActivity, profile

    calls = 5
    k, batch = labels.shape[:2]
    out = {}
    forms = ((("graphed", trainer.multi_step),
              ("looped", trainer.make_multi_step(graphed=False)))
             if hasattr(trainer, "make_multi_step") else (("looped", trainer.multi_step),))
    for form, run in forms:
        # a signature's first call runs step by step, its second captures
        for _ in range(2):
            run(batches, labels)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            run(batches, labels)
        end.record()
        end.synchronize()
        call = start.elapsed_time(end) / calls
        wall = statistics.median(host_ms(lambda: (run(batches, labels),
                                                  torch.cuda.synchronize()), iters=3, warmup=1))
        try:
            per_name = device_ms(lambda: (run(batches, labels), torch.cuda.synchronize()),
                                 iters=3)
        except RuntimeError:  # the profiler saw no kernel of the graph
            per_name = None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run(batches, labels)
        host_ops = collections.Counter(e.name for e in prof.events() if e.cpu_parent is None)
        busy = sum(per_name.values()) if per_name else None
        idle = f"{1 - busy / wall:.3f}" if busy else "not measured (no device events traced)"
        busy_text = f"{busy:.3f}" if busy else "not measured"
        print(f"timing {name} {form}: {k * batch / (call / 1e3):.1f} examples/s "
              f"({call:.3f} ms per K={k} call of {batch} examples a step, "
              f"{call / k:.3f} ms a step, CUDA events over {calls} calls); device busy "
              f"{busy_text} ms of {wall:.3f} ms wall a call, idle share {idle}; "
              f"{sum(host_ops.values())} top-level host ops a call, most frequent "
              f"{host_ops.most_common(4)}; on {card}", flush=True)
        if per_name:
            print(f"{name} {form}: top device work of a step:", flush=True)
            for kernel, ms in per_name.most_common(8):
                print(f"  {ms / k:.4f} ms  {100 * ms / busy:5.1f}%  {kernel[:90]}")
        out[form] = {"step_ms": call / k, "busy_ms": busy / k if busy else None,
                     "idle": 1 - busy / wall if busy else None,
                     "host_ops": sum(host_ops.values()),
                     "per_step": collections.Counter(
                         {n: ms / k for n, ms in (per_name or {}).items()})}
    lp = out["looped"]
    g = out.get("graphed", lp)
    if "graphed" in out:
        print(f"timing {name}: graphed {g['step_ms']:.4f} ms a step against looped "
              f"{lp['step_ms']:.4f} ({lp['step_ms'] / g['step_ms']:.2f}x); host ops a call "
              f"{g['host_ops']} against {lp['host_ops']}; on {card}", flush=True)
    return {"step_ms": g["step_ms"], "busy_ms": g["busy_ms"],
            "per_step": g["per_step"] or lp["per_step"],
            "looped_step_ms": lp["step_ms"], "looped_busy_ms": lp["busy_ms"]}


# ---------------------------------------------------------------------------
# DIN at benchmarks/model_step.py's width
# ---------------------------------------------------------------------------

DIN_REQUESTS = (1, 1000, DIN_BATCH, 20_000)


def din_staged(seeds, negatives: bool = False, batch: int = DIN_BATCH):
    """model_step.py's DIN (or DIEN) batches, one seed each, stacked on a
    leading K axis on the card."""
    data = [din_batch(s, batch, negatives) for s in seeds]
    batches = {k: torch.as_tensor(np.stack([X[k] for X, _ in data]), device="cuda")
               for k in data[0][0]}
    labels = torch.as_tensor(np.stack([y for _, y in data]), device="cuda")
    return batches, labels


def din_model(dim: int = DIN_DIM, att_hidden_units=(80, 40)):
    """DIN at model_step.py's width (attention 80-40 sigmoid, BatchNorm on
    the 97-wide concat at dim 32, Dice tower 256-128-64, f32) on the card,
    weights from seed 0; ``dim`` replaces the embedding dim,
    ``att_hidden_units`` the attention's scorer."""
    from recommender_system_tpu_torch import DIN

    model = DIN(din_columns(dim=dim), behavior_feature_list=("item_id",),
                att_hidden_units=att_hidden_units, device="cuda",
                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        # the default init std of 1e-4 would leave the embeddings, and so
        # the attention, no say in the output
        getattr(model.embeddings, f"table_d{dim}").normal_(
            0.0, 0.1, generator=torch.Generator(device="cuda").manual_seed(1))
    return model


def counted():
    """Every kernel wrapper, each with its launch count."""
    from recommender_system_tpu_torch.ops.embedding_grad import scatter_add_sorted
    from recommender_system_tpu_torch.ops.fused_adagrad import (
        fused_adagrad_apply, fused_adam_apply, fused_sgd_apply)
    from recommender_system_tpu_torch.ops.kernels import (cross_fused, din_attention_backward,
                                                          din_attention_fused, fm_fused)

    return (cross_fused, fm_fused, din_attention_fused, din_attention_backward,
            fused_adagrad_apply, fused_sgd_apply, fused_adam_apply, scatter_add_sorted)


def read_counts() -> dict:
    """Every wrapper's launches, and of them the launches of the global
    kernels of the wrappers that have one (``<wrapper>.global_launches``),
    of the attention backward's wide kernel
    (``din_attention_backward.wide_launches``) and of the long path of the
    four sparse row rules (``<wrapper>.long_launches``)."""
    counts = {fn.__name__: fn.launches for fn in counted()}
    counts.update({f"{fn.__name__}.{attr}": getattr(fn, attr) for fn in counted()
                   for attr in ("global_launches", "wide_launches", "long_launches")
                   if hasattr(fn, attr)})
    return counts


def zero_counts() -> None:
    for fn in counted():
        for attr in ("launches", "global_launches", "wide_launches", "long_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def launches_want(**launches) -> dict:
    """Every count: the ones named, and 0 for the rest, but the long path's:
    every launch of a sparse row wrapper runs it, so its count is the
    wrapper's unless named."""
    want = {**dict.fromkeys(read_counts(), 0), **launches}
    for key in want:
        if key.endswith(".long_launches") and key not in launches:
            want[key] = want[key.split(".")[0]]
    return want


def global_key(name: str) -> str:
    """The key of ``name``'s global kernel launches in ``read_counts``."""
    return f"{name}.global_launches"


def wide_key(name: str) -> str:
    """The key of ``name``'s wide kernel launches in ``read_counts`` (the
    attention backward's)."""
    return f"{name}.wide_launches"


def long_key(name: str) -> str:
    """The key of ``name``'s long-path launches in ``read_counts``."""
    return f"{name}.long_launches"


def on_card(*values: float) -> torch.Tensor:
    """A sparse row rule's step scalars (``[lr]`` or ``[lr, bc1, bc2]``) in
    device memory, where its kernel reads them: made once, so that a timed
    call copies nothing from the host."""
    return torch.tensor(values, dtype=torch.float32, device="cuda")


def train_din_fused(batches, labels, card):
    """Phase 3f, fused: three K=8 calls; returns (trainer, launches). A
    step: one attention forward and one of its backward kernel; one
    fused_adagrad_apply, since the [B, 2] group and the [B, T] history of
    table_d32 go as one stream; no scatter-add."""
    from recommender_system_tpu_torch import FusedAdagrad
    from recommender_system_tpu_torch.training import Adagrad

    return train_checked(
        "DIN", din_model(), batches, labels, Adagrad(LR), FusedAdagrad(LR), 3,
        launches_want(din_attention_fused=3 * K, din_attention_backward=3 * K,
                      fused_adagrad_apply=3 * K), card,
        touched=table_d32_touched(batches))


def train_din_plain(batches, labels):
    """Phase 3f, plain: one K=8 call; returns the launches."""
    from recommender_system_tpu_torch import Trainer
    from recommender_system_tpu_torch.training import Adagrad

    trainer = Trainer(din_model(), Adagrad(LR))
    zero_counts()
    losses = trainer.multi_step(batches, labels).cpu().numpy()
    launches = read_counts()
    # a step: two take_fast lookups of table_d32 (the [B, 2] group and the
    # [B, T] history), each with one scatter-add in its backward
    want = launches_want(din_attention_fused=K, din_attention_backward=K,
                         scatter_add_sorted=2 * K)
    print(f"DIN plain training launches: {launches} over 1 call of K={K}; losses {losses}",
          flush=True)
    if launches != want:
        raise RuntimeError(f"DIN plain training launched {launches}, want {want}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"DIN plain training losses not finite: {losses}")
    return launches


def serve_din(model, name: str = "DIN", on_global: bool = False):
    """Phase 3e (and 3r): the trained DIN through Scorer; returns (scorer,
    requests, launches). ``on_global``: every attention launch is one of
    the global kernel."""
    from recommender_system_tpu_torch import Scorer
    from recommender_system_tpu_torch.ops.kernels import din_attention_ref

    X, _ = din_batch(100, max(DIN_REQUESTS))
    requests = {n: {k: v[:n] for k, v in X.items()} for n in DIN_REQUESTS}
    scorer = Scorer(model, batch_size=DIN_BATCH)
    zero_counts()
    answers = {n: scorer(req) for n, req in requests.items()}
    torch.cuda.synchronize()
    launches = read_counts()
    padded = sum(-(-n // DIN_BATCH) for n in DIN_REQUESTS)
    print(f"{name} serving launches: {launches} for {padded} padded batches", flush=True)
    want = launches_want(din_attention_fused=padded, **(
        {global_key("din_attention_fused"): padded} if on_global else {}))
    if launches != want:
        raise RuntimeError(f"{name} serving launched {launches} for {padded} padded batches")

    a = model.attention

    def plain_forward(req):
        with torch.inference_mode():
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in req.items()}
            emb = model.embeddings(batch)
            query = emb.sparse["item_id"]
            att = din_attention_ref(query, emb.varlen_raw["hist_item_id"],
                                    emb.varlen_mask["hist_item_id"], a.w1, a.b1, a.w2,
                                    a.b2, a.w3, a.b3)
            x = torch.cat([emb.sparse["user_id"], att, query, emb.dense], dim=-1)
            return torch.sigmoid(model.deep(model.bn(x))).cpu().numpy()

    for n, got in answers.items():
        if got.shape != (n, 1) or got.dtype != np.float32 or not np.isfinite(got).all():
            raise RuntimeError(f"{name} request of {n} rows answered {got.shape} {got.dtype}")
        np.testing.assert_allclose(got, plain_forward(requests[n]), rtol=0, atol=ATOL)
    spread = float(np.std(answers[max(DIN_REQUESTS)]))
    if spread < 1e-3:
        raise RuntimeError(f"{name} scores barely vary (std {spread}): inputs have no say")
    cpu_scorer = Scorer(copy.deepcopy(model).to("cpu"), batch_size=DIN_BATCH, device="cpu")
    np.testing.assert_allclose(answers[1000], cpu_scorer(requests[1000]), rtol=0, atol=ATOL)
    print(f"{name} serving check: {len(DIN_REQUESTS)} requests equal the plain forward on the "
          f"card and the CPU path (atol={ATOL}); score std {spread:.4f}", flush=True)
    return scorer, requests, launches


def din_wide_path(card) -> dict:
    """Phase 3r: DIN at model_step.py's width with its embedding dim 128
    (table_d128 of 300,000 x 128), whose attention's keys only the global
    forward kernel takes: three fused K=8 calls through
    ``Trainer.multi_step`` (the second captures the graph, the third
    replays it), then served through ``Scorer(batch_size=8192)``. Every
    attention launch must be one of the global kernel, every backward one
    of the wide kernel. Returns the launches of each."""
    from recommender_system_tpu_torch import FusedAdagrad
    from recommender_system_tpu_torch.training import Adagrad

    t0 = time.perf_counter()
    batches, labels = din_staged(range(K))
    name = f"DIN at dim {DIN_WIDE_DIM}"
    trainer, train_launches = train_checked(
        name, din_model(DIN_WIDE_DIM), batches, labels, Adagrad(LR), FusedAdagrad(LR), 3,
        launches_want(din_attention_fused=3 * K, din_attention_backward=3 * K,
                      fused_adagrad_apply=3 * K,
                      **{global_key("din_attention_fused"): 3 * K,
                         wide_key("din_attention_backward"): 3 * K}), card,
        touched=table_d32_touched(batches))
    _, _, serve_launches = serve_din(trainer.model, name, on_global=True)
    print(f"phase 3r took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"train": train_launches, "serve": serve_launches}


# the share of the fields that write_criteo_tsv leaves missing; the CLI
# buckets a missing field to id 0, each column's padding row
MISSING_SHARE = 0.05


def missing_fields(batches, seed: int = 7) -> dict:
    """The staged Criteo ``batches`` with each sparse field missing in
    MISSING_SHARE of the rows, drawn field by field as ``write_criteo_tsv``
    drops them, and id 0 in its place, as the CLI's bucketing gives it
    (``utils/datasets.py``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = dict(batches)
    for f in range(FIELDS):
        ids = batches[f"C{f + 1}"]
        drop = torch.rand(ids.shape, generator=gen, device="cuda") < MISSING_SHARE
        out[f"C{f + 1}"] = torch.where(drop, torch.zeros_like(ids), ids)
    return out


def long_rules_path(card) -> dict:
    """Phase 3s: the long path of FusedSGD and FusedAdam on the main path.
    DIN at model_step.py's width with SGD + FusedSGD and with Adam +
    FusedAdam, three K=8 calls each (the third a graph replay): every
    step's stream holds the padding row as a long segment whose cotangents
    are zero, so the row keeps its values and its slots bitwise. WideDeep
    (FusedSGD) and NFM (FusedAdam) at model_step.py's Criteo width, one K=8
    call each, on ``missing_fields`` batches: each column's id-0 row a long
    segment of every step. Returns the trainers, the Criteo batches and
    each path's launches."""
    from recommender_system_tpu_torch import FusedAdam, FusedSGD
    from recommender_system_tpu_torch.ops.kernels import SPARSE_CHUNK
    from recommender_system_tpu_torch.training import SGD, Adam

    t0 = time.perf_counter()
    out = {"trainers": {}, "launches": {}}
    batches, labels = din_staged(range(K))
    for name, optimizer, fused, wrapper in (
            ("din_sgd", SGD(SGD_LR), FusedSGD(SGD_LR), "fused_sgd_apply"),
            ("din_adam", Adam(ADAM_LR), FusedAdam(ADAM_LR), "fused_adam_apply")):
        model = din_model()
        key = next(n for n, _ in model.named_parameters() if n.endswith("table_d32"))
        pad = model.embeddings.table_d32[DIN_USERS].detach().clone()
        label = f"DIN with {type(fused).__name__}"
        trainer, launches = train_checked(
            label, model, batches, labels, optimizer, fused, 3,
            launches_want(din_attention_fused=3 * K, din_attention_backward=3 * K,
                          **{wrapper: 3 * K}), card,
            touched=table_d32_touched(batches))
        slots = [s[DIN_USERS] for s in trainer.fused_slots[key]]
        if not (torch.equal(model.embeddings.table_d32[DIN_USERS], pad)
                and all(s.count_nonzero().item() == 0 for s in slots)):
            raise RuntimeError(f"{label}: the padding row (zero cotangents) or its slots moved")
        print(f"{label}: the padding row and its {len(slots)} slot(s) bitwise unchanged",
              flush=True)
        out["trainers"][name], out["launches"][name] = trainer, launches

    cols, ctr_batches, ctr_labels = staged_batches(range(K), batch=CTR_BATCH)
    missing = missing_fields(ctr_batches)
    least = min(int((missing[f"C{f + 1}"] == 0).sum(dim=1).min()) for f in range(FIELDS))
    if least < SPARSE_CHUNK:
        raise RuntimeError(f"missing fields: {least} positions on a column's id 0 in a step, "
                           f"fewer than the long path's {SPARSE_CHUNK}")
    out["batches"] = (missing, ctr_labels)
    for name, model_name, optimizer, fused, wrapper in (
            ("wide_deep_missing", "wide_deep", SGD(SGD_LR), FusedSGD(SGD_LR), "fused_sgd_apply"),
            ("nfm_missing", "nfm", Adam(ADAM_LR), FusedAdam(ADAM_LR), "fused_adam_apply")):
        out["trainers"][name], out["launches"][name] = train_checked(
            f"{model_name} with {100 * MISSING_SHARE:.0f}% of the fields missing",
            ctr_model(model_name, cols), missing, ctr_labels, optimizer, fused, 1,
            launches_want(**{wrapper: K}), card)
    print(f"missing fields: at least {least} positions on each column's id 0 in every step "
          f"(long from {SPARSE_CHUNK}); phase 3s took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def time_din(trainer, scorer, requests, batches, labels, card, rules=None) -> dict:
    """Phase 4 for DIN: the attention kernel and its backward kernel at the
    main path's inputs (the backward's figures under ``"backward"``), the
    Scorer's latency, throughput and idle share, the fused step's
    throughput and idle share, and the padding row's share of the step;
    then the step of each trainer in ``rules`` (label -> DIN trainer with
    another fused rule) beside it, with its sparse row kernels' share."""
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.din_vjp import din_attention_backward_ref
    from recommender_system_tpu_torch.ops.fused_adagrad import fused_adagrad_apply
    from recommender_system_tpu_torch.ops.kernels import (din_attention_backward,
                                                          din_attention_fused, din_attention_ref)

    model = trainer.model.eval()
    a = model.attention
    weights = (a.w1, a.b1, a.w2, a.b2, a.w3, a.b3)
    with torch.inference_mode():
        emb = model.embeddings({k: v[0] for k, v in batches.items()})
        q = emb.sparse["item_id"].contiguous()
        keys = emb.varlen_raw["hist_item_id"]
        mask = emb.varlen_mask["hist_item_id"].float()
        kernel_dev = device_ms(lambda: din_attention_fused(q, keys, mask, *weights))
        plain_dev = device_ms(lambda: din_attention_ref(q, keys, mask, *weights))
        rec = {"call_ms": call_ms(lambda: din_attention_fused(q, keys, mask, *weights)),
               "plain_call_ms": call_ms(lambda: din_attention_ref(q, keys, mask, *weights))}
    if not all("din_attention_kernel" in name for name in kernel_dev):
        raise RuntimeError(f"din_attention_fused ran other device work: {dict(kernel_dev)}")
    B, T, Kd = keys.shape
    H1, H2 = a.w1.shape[1], a.w2.shape[1]
    rec.update(ms=sum(kernel_dev.values()), plain_ms=sum(plain_dev.values()), library_ms=None)
    rec["bound_ms"], rec["bound_by"], rec["f32_bound_ms"] = din_bound(B, T, Kd, H1, H2)
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    rec["share_of_f32_bound"] = rec["f32_bound_ms"] / rec["ms"]
    print(f"timing din_attention_fused B={B} T={T} K={Kd} H1={H1} H2={H2}: device "
          f"{rec['ms']:.5f} ms ({100 * rec['bound_ms'] / rec['ms']:.1f}% of the tensor-core "
          f"bound {rec['bound_ms']:.5f} ms, {rec['bound_by']}, 3xTF32; "
          f"{100 * rec['f32_bound_ms'] / rec['ms']:.1f}% of the f32 bound "
          f"{rec['f32_bound_ms']:.5f} ms), {rec['call_ms']:.5f} ms per call; "
          f"plain din_attention_ref: device {rec['plain_ms']:.5f} ms in {len(plain_dev)} "
          f"kernel kinds, {rec['plain_call_ms']:.5f} ms per call; on {card}", flush=True)

    # the backward kernel on the forward's saved weights and a cotangent
    with torch.inference_mode():
        _, saved = kernels._din_launch(q, keys, mask, *weights, "sigmoid", True, False, True)
        cot = torch.randn(B, Kd, generator=torch.Generator(device="cuda").manual_seed(6),
                          device="cuda")
        args = (q, keys, mask, *weights, saved, cot)
        bwd_dev = device_ms(lambda: din_attention_backward(*args), iters=20)
        plain_bwd_dev = device_ms(lambda: din_attention_backward_ref(*args), iters=20)
        bwd = {"call_ms": call_ms(lambda: din_attention_backward(*args), iters=50),
               "plain_call_ms": call_ms(lambda: din_attention_backward_ref(*args), iters=50)}
    if not any("din_backward_tile_kernel" in name for name in bwd_dev) or not all(
            "din_backward_tile_kernel" in name or "din_backward_reduce" in name
            for name in bwd_dev):
        raise RuntimeError(f"din_attention_backward ran other device work than its tile "
                           f"kernel and the reduction: {dict(bwd_dev)}")
    bwd.update(ms=sum(bwd_dev.values()), plain_ms=sum(plain_bwd_dev.values()), library_ms=None,
               by_kernel={name[:60]: ms for name, ms in bwd_dev.items()})
    # the least work is over the unmasked positions: a masked one adds to no
    # product (the tile kernel skips them)
    valid = int((mask > 0.5).sum().item())
    bwd["valid_positions"] = valid
    bwd["bound_ms"], bwd["bound_by"], bwd["f32_bound_ms"] = din_backward_bound(
        B, T, Kd, H1, H2, positions=valid)
    bwd["all_positions_bound_ms"], bwd["all_positions_bound_by"], _ = din_backward_bound(
        B, T, Kd, H1, H2)
    bwd["share_of_bound"] = bwd["bound_ms"] / bwd["ms"]
    rec["backward"] = bwd
    print(f"timing din_attention_backward (tile kernel) B={B} T={T} K={Kd} H1={H1} H2={H2}: "
          f"device {bwd['ms']:.5f} ms in {len(bwd_dev)} kernels "
          f"({100 * bwd['share_of_bound']:.1f}% "
          f"of the tensor-core bound over its {valid} unmasked positions {bwd['bound_ms']:.5f} "
          f"ms, {bwd['bound_by']}, 3xTF32; f32 bound {bwd['f32_bound_ms']:.5f} ms; over all "
          f"{B * T}: {bwd['all_positions_bound_ms']:.5f} ms), {bwd['call_ms']:.5f} ms per call; "
          f"plain din_attention_backward_ref: device {bwd['plain_ms']:.5f} ms in "
          f"{len(plain_bwd_dev)} kernel kinds, {bwd['plain_call_ms']:.5f} ms per call; "
          f"by kernel {bwd['by_kernel']}; on {card}", flush=True)

    lat = {n: host_ms(lambda n=n: scorer(requests[n]), iters=30) for n in (1, DIN_BATCH)}
    for n, times in lat.items():
        print(f"timing DIN Scorer {n}-row request: median {statistics.median(times):.3f} ms, "
              f"min {min(times):.3f} ms, max {max(times):.3f} ms over {len(times)}; "
              f"on {card}", flush=True)
    X_big, _ = din_batch(101, THROUGHPUT_ROWS)
    big = host_ms(lambda: scorer(X_big), iters=5, warmup=1)
    print(f"timing DIN Scorer throughput over {THROUGHPUT_ROWS} rows: "
          f"{THROUGHPUT_ROWS / (statistics.median(big) / 1e3):.1f} examples/s "
          f"(median of {len(big)} calls, {statistics.median(big):.2f} ms each); on {card}",
          flush=True)
    serve_dev = device_ms(lambda: scorer(requests[DIN_BATCH]), iters=10)
    busy = sum(serve_dev.values())
    wall = statistics.median(lat[DIN_BATCH])
    print(f"DIN Scorer {DIN_BATCH}-row request: device busy {busy:.4f} ms of {wall:.4f} ms "
          f"wall, idle share {1 - busy / wall:.3f}; top device work:", flush=True)
    for name, ms in serve_dev.most_common(8):
        print(f"  {ms:.4f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")

    step = time_training(trainer, batches, labels, card, "DIN fused training")
    # the padding row: fused_adagrad_apply on one step's stream, and on the
    # same stream without its padding positions (item id 0, row 100,000)
    lids = torch.as_tensor(din_stream(din_batch(0)[0]), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    ct = torch.randn(lids.numel(), DIN_DIM, generator=gen, device="cuda") * 1e-3
    table = torch.randn(DIN_USERS + DIN_ITEMS, DIN_DIM, generator=gen, device="cuda")
    acc = torch.full_like(table, 0.1)
    lr = on_card(LR)
    pad = lids == DIN_USERS
    kernel = "sparse_rows"
    hot = {}
    for what, (ids, c) in {"with": (lids, ct), "without": (lids[~pad], ct[~pad])}.items():
        dev = device_ms(lambda ids=ids, c=c: fused_adagrad_apply(table, acc, ids, c, eps=EPS,
                                                                  scalars=lr), iters=5)
        hot[what] = sum(ms for name, ms in dev.items() if kernel in name)
    clocks = clocks_during(lambda: fused_adagrad_apply(table, acc, lids, ct, eps=EPS,
                                                       scalars=lr))
    in_step = sum(ms for name, ms in step["per_step"].items() if kernel in name)
    print(f"DIN padding row: {int(pad.sum())} of {lids.numel()} positions of a step's stream; "
          f"fused_adagrad_rows takes {hot['with']:.4f} ms on the stream (clocks, SM and "
          f"memory, {clocks} during its walks) and "
          f"{hot['without']:.4f} ms without its padding positions; in the step it takes "
          f"{in_step:.4f} ms of {step['busy_ms']:.4f} ms device busy and of "
          f"{step['step_ms']:.4f} ms a step ({100 * in_step / step['step_ms']:.1f}%); "
          f"on {card}", flush=True)
    for label, other in (rules or {}).items():
        got = time_training(other, batches, labels, card, f"DIN {label} training")
        rows_ms = sum(ms for name, ms in got["per_step"].items() if kernel in name)
        print(f"DIN with {label}: {got['step_ms']:.4f} ms a graphed step against "
              f"{step['step_ms']:.4f} with FusedAdagrad; its sparse row kernels {rows_ms:.4f} "
              f"ms of the step against {in_step:.4f}; on {card}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# DIEN at benchmarks/model_step.py's width
# ---------------------------------------------------------------------------

def dien_model(gru_hidden: int = 0, device: str = "cuda"):
    """DIEN at model_step.py's width (``:99-107``: use_negsampling, GRU and
    AUGRU of H=32 unless ``gru_hidden`` names another, attention 80-40
    sigmoid over the GRU states, auxiliary tower 100-50, relu tower
    256-128-64, f32) on ``device``, weights from seed 0, table_d32 at std
    0.1 as DIN's."""
    from recommender_system_tpu_torch import DIEN

    model = DIEN(din_columns(negatives=True), behavior_feature_list=("item_id",),
                 gru_hidden=gru_hidden, use_negsampling=True, device=device,
                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.embeddings.table_d32.normal_(
            0.0, 0.1, generator=torch.Generator(device=device).manual_seed(1))
    return model


def table_d32_touched(batches) -> torch.Tensor:
    """The rows of table_d32 that DIN's, DIEN's or DSSM's staged batches
    look up."""
    touched = torch.zeros(DIN_USERS + DIN_ITEMS, dtype=torch.bool, device="cuda")
    touched[batches["user_id"].reshape(-1).long()] = True
    for name in ("item_id", "hist_item_id", "neg_hist_item_id"):
        if name in batches:
            touched[batches[name].reshape(-1).long() + DIN_USERS] = True
    return touched


def train_dien(batches, labels, card):
    """Phase 3j: DIEN fused (three K=8 calls) and plain (one call); returns
    (trainer, fused launches, plain launches). A fused step: one attention
    launch and one of its backward kernel; one fused_adagrad_apply, since
    the [B, 2] group, the [B, T] history and the [B, T] sampled history of
    table_d32 go as one stream. A plain step: one scatter-add for each of
    the three lookups."""
    from recommender_system_tpu_torch import FusedAdagrad, Trainer
    from recommender_system_tpu_torch.training import Adagrad

    trainer, fused_launches = train_checked(
        "DIEN", dien_model(), batches, labels, Adagrad(LR), FusedAdagrad(LR), 3,
        launches_want(din_attention_fused=3 * K, din_attention_backward=3 * K,
                      fused_adagrad_apply=3 * K), card,
        touched=table_d32_touched(batches))

    plain_trainer = Trainer(dien_model(), Adagrad(LR))
    zero_counts()
    losses = plain_trainer.multi_step(batches, labels).cpu().numpy()
    plain_launches = read_counts()
    want = launches_want(din_attention_fused=K, din_attention_backward=K,
                         scatter_add_sorted=3 * K)
    print(f"DIEN plain training launches: {plain_launches} over 1 call of K={K}; "
          f"losses {losses}", flush=True)
    if plain_launches != want:
        raise RuntimeError(f"DIEN plain training launched {plain_launches}, want {want}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"DIEN plain training losses not finite: {losses}")
    return trainer, fused_launches, plain_launches


class plain_attention:
    """Within: ``din_attention_fused`` (and the cross and FM wrappers) run
    their plain version on CUDA tensors, as they do on the CPU."""

    def __enter__(self):
        from recommender_system_tpu_torch.ops import kernels

        self.kernels, self.use_kernel = kernels, kernels.use_kernel
        kernels.use_kernel = lambda *tensors: False

    def __exit__(self, *exc):
        self.kernels.use_kernel = self.use_kernel


def serve_dien(model, card):
    """Phase 3j, serving: the trained DIEN through Scorer, one attention
    launch per padded batch; the answers equal the plain attention's on the
    card and the CPU path's on 1000 rows. Returns the launches."""
    from recommender_system_tpu_torch import Scorer

    X, _ = din_batch(100, max(DIN_REQUESTS), negatives=True)
    requests = {n: {k: v[:n] for k, v in X.items()} for n in DIN_REQUESTS}
    scorer = Scorer(model, batch_size=DIN_BATCH)
    zero_counts()
    answers = {n: scorer(req) for n, req in requests.items()}
    torch.cuda.synchronize()
    launches = read_counts()
    padded = sum(-(-n // DIN_BATCH) for n in DIN_REQUESTS)
    print(f"DIEN serving launches: {launches} for {padded} padded batches", flush=True)
    if launches != launches_want(din_attention_fused=padded):
        raise RuntimeError(f"DIEN serving launched {launches} for {padded} padded batches")
    with plain_attention():
        plain_answers = {n: scorer(req) for n, req in requests.items()}
    for n, got in answers.items():
        if got.shape != (n, 1) or got.dtype != np.float32 or not np.isfinite(got).all():
            raise RuntimeError(f"DIEN request of {n} rows answered {got.shape} {got.dtype}")
        np.testing.assert_allclose(got, plain_answers[n], rtol=0, atol=ATOL)
    spread = float(np.std(answers[max(DIN_REQUESTS)]))
    if spread < 1e-3:
        raise RuntimeError(f"DIEN scores barely vary (std {spread}): inputs have no say")
    cpu_scorer = Scorer(copy.deepcopy(model).to("cpu"), batch_size=DIN_BATCH, device="cpu")
    np.testing.assert_allclose(answers[1000], cpu_scorer(requests[1000]), rtol=0, atol=ATOL)
    print(f"DIEN serving check: {len(DIN_REQUESTS)} requests equal the plain attention's "
          f"answers on the card and the CPU path (atol={ATOL}); score std {spread:.4f}; "
          f"on {card}", flush=True)
    return launches


def check_global_shapes(card) -> dict:
    """Phase 3k: at shapes that their fast kernels do not take, the cross,
    FM and DIN attention wrappers launch their global kernels, each launch
    counted in ``launches`` and ``global_launches``: DCN at embedding dim 40
    trained (graphed calls equal to looped ones) and served; the answers
    agree with the CPU's. Returns each path's counts."""
    from recommender_system_tpu_torch import DCN, Scorer
    from recommender_system_tpu_torch.ops.kernels import (din_attention_fused,
                                                          din_attention_ref, fm_fused, fm_ref)
    from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

    out = {}

    def counted_run(what, want, fn):
        zero_counts()
        result = fn()
        torch.cuda.synchronize()
        got = read_counts()
        print(f"global kernel, {what}: {got}", flush=True)
        if got != want:
            raise RuntimeError(f"{what} counted {got}, want {want}")
        out[what] = got
        return result

    # DCN trained at model_step.py's width and batch with embedding dim 40
    # (x0 1,053 wide): every cross forward on the global kernel, three K=8
    # calls (the third a graph replay), then graphed calls against looped
    from recommender_system_tpu_torch import FusedAdagrad
    from recommender_system_tpu_torch.training import Adagrad

    t0 = time.perf_counter()
    dcn_cols, dcn_batches, dcn_labels = staged_batches(range(K), batch=CTR_BATCH, dim=WIDE_DIM)
    per_call = dict(cross_fused=K, fused_adagrad_apply=K, **{global_key("cross_fused"): K})
    trainer, launches = train_checked(
        f"DCN at embedding dim {WIDE_DIM}", ctr_model("dcn", dcn_cols), dcn_batches,
        dcn_labels, Adagrad(LR), FusedAdagrad(LR), 3,
        launches_want(**{k: 3 * n for k, n in per_call.items()}), card)
    width = trainer.model.cross.weights.shape[1]
    if width != FIELDS * WIDE_DIM + 13:
        raise RuntimeError(f"DCN at embedding dim {WIDE_DIM}: x0 {width} wide")
    out[f"DCN trained at x0 width {width}"] = launches
    graphed = graph_against_loop(f"DCN at embedding dim {WIDE_DIM}", trainer, dcn_batches,
                                 dcn_labels, card)
    if graphed["unequal"] or graphed["launches"] != launches:
        raise RuntimeError(f"DCN at x0 width {width}: graphed calls {graphed}, want bitwise "
                           f"equal to the looped ones and {launches}")
    out[f"DCN graphed at x0 width {width}"] = graphed["launches"]
    print(f"phase 3k: DCN at x0 width {width} trained, {K} global cross launches a call, "
          f"graphed equal to looped; {time.perf_counter() - t0:.1f} s", flush=True)
    del trainer, dcn_batches, dcn_labels

    # DCN's x0 of 26 fields at dim 40 and 13 dense: 1,053 wide
    cols, X, _ = synthetic_criteo(n_rows=1000, vocab=WIDE_VOCAB, embedding_dim=WIDE_DIM,
                                  seed=0)
    model = DCN(tuple(cols), cross_layers=6, hidden_units=(256, 128, 64), device="cuda",
                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.embeddings.table_d40.normal_(
            0.0, 0.1, generator=torch.Generator(device="cuda").manual_seed(1))
    width = model.cross.weights.shape[1]
    scorer = Scorer(model, batch_size=SERVE_BATCH)
    padded = -(-X['I1'].shape[0] // SERVE_BATCH)
    got = counted_run(f"DCN served at x0 width {width}",
                      launches_want(cross_fused=padded, **{global_key("cross_fused"): padded}),
                      lambda: scorer(X))
    cpu = Scorer(copy.deepcopy(model).to("cpu"), batch_size=SERVE_BATCH, device="cpu")(X)
    np.testing.assert_allclose(got, cpu, rtol=0, atol=ATOL)
    if width != FIELDS * WIDE_DIM + 13 or float(np.std(got)) < 1e-3:
        raise RuntimeError(f"DCN at x0 width {width}: scores std {np.std(got)}")

    gen = torch.Generator(device="cuda").manual_seed(9)
    x, w1, v = fm_inputs(gen, 1000, WIDE_FM_D, 8)
    with torch.inference_mode():
        got = counted_run(f"fm_fused at D={WIDE_FM_D}, k=8",
                          launches_want(fm_fused=1, **{global_key("fm_fused"): 1}),
                          lambda: fm_fused(x, w1, v))
    torch.testing.assert_close(got.cpu(), fm_ref(x.cpu(), w1.cpu(), v.cpu()),
                               rtol=RTOL, atol=ATOL)

    q, keys, mask, weights = din_inputs(gen, DIN_BATCH, DIN_T, 128, 80, 40)
    with torch.inference_mode():
        got = counted_run("din_attention_fused at K=128, T=50",
                          launches_want(din_attention_fused=1,
                                        **{global_key("din_attention_fused"): 1}),
                          lambda: din_attention_fused(q, keys, mask, *weights))
        cpu = din_attention_ref(q.cpu(), keys.cpu(), mask.cpu(), *(w.cpu() for w in weights))
    torch.testing.assert_close(got.cpu(), cpu, rtol=RTOL, atol=ATOL)

    # DIEN(gru_hidden=128): the attention reads GRU states 128 wide
    batches, labels = din_staged([0], negatives=True, batch=DIEN_SMALL_BATCH)
    counted_run("one fused step of DIEN(gru_hidden=128) at batch 1,024",
                launches_want(fused_adagrad_apply=1, din_attention_fused=1,
                              din_attention_backward=1,
                              **{global_key("din_attention_fused"): 1,
                                 wide_key("din_attention_backward"): 1}),
                lambda: card_against_cpu(dien_model(gru_hidden=128), batches, labels,
                                         "DIEN(gru_hidden=128)"))
    # DIN with a scorer wider than 80-40: the attention backward's global
    # kernel (the forward's tiled kernel takes the scorer)
    batches, labels = din_staged([0], batch=DIEN_SMALL_BATCH)
    counted_run(f"one fused step of DIN(att_hidden_units={DIN_WIDE_SCORER}) at batch 1,024",
                launches_want(fused_adagrad_apply=1, din_attention_fused=1,
                              din_attention_backward=1,
                              **{global_key("din_attention_backward"): 1}),
                lambda: card_against_cpu(din_model(att_hidden_units=DIN_WIDE_SCORER),
                                         batches, labels,
                                         f"DIN(att_hidden_units={DIN_WIDE_SCORER})"))
    print(f"global kernels: each shape launched its wrapper's global kernel and agreed "
          f"with the CPU; on {card}", flush=True)
    return out


def time_dien(trainer, batches, labels, card) -> None:
    """Phase 4 for DIEN: the fused step's throughput, idle share, top
    device work and host ops; the device and host time of its parts
    (forward and backward at one batch's tensors); the padding row's share
    of the step."""
    from recommender_system_tpu_torch.ops.fused_adagrad import fused_adagrad_apply

    step = time_training(trainer, batches, labels, card, "DIEN fused training")
    model = trainer.model.train()
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():
        emb = model.embeddings({k: v[0] for k, v in batches.items()})
        keys = emb.varlen_raw["hist_item_id"]
        neg = emb.varlen_raw["neg_hist_item_id"]
        query = emb.sparse["item_id"]
        mask = emb.varlen_mask["hist_item_id"]
        states, _ = model.interest_gru(keys, mask=mask)
        scores = model.attention(query, states, mask)
    B, T, H = states.shape
    cot_states = torch.randn(B, T, H, generator=gen, device="cuda")
    cot_scores = torch.randn(B, T, generator=gen, device="cuda")
    cot_h = torch.randn(B, H, generator=gen, device="cuda")
    leaves = {n: t.detach().requires_grad_(True)
              for n, t in (("keys", keys), ("neg", neg), ("query", query),
                           ("states", states), ("scores", scores))}

    def grads(out, cot, *inputs):
        return torch.autograd.grad(out, [*inputs], cot)

    parts = {
        "GRU (interest_gru)": lambda: grads(
            model.interest_gru(leaves["keys"], mask=mask)[0], cot_states, leaves["keys"],
            *model.interest_gru.parameters()),
        "AUGRU (augru)": lambda: grads(
            model.augru(leaves["states"], leaves["scores"], mask=mask)[1], cot_h,
            leaves["states"], leaves["scores"], *model.augru.parameters()),
        "attention (forward kernel, backward kernel)": lambda: grads(
            model.attention(leaves["query"], leaves["states"], mask), cot_scores,
            leaves["query"], leaves["states"], *model.attention.parameters()),
        "auxiliary net (positive and sampled)": lambda: grads(
            model.aux_net(leaves["states"][:, :-1], leaves["keys"][:, 1:]).sum()
            + model.aux_net(leaves["states"][:, :-1], leaves["neg"][:, 1:]).sum(), None,
            leaves["states"], leaves["keys"], leaves["neg"], *model.aux_net.parameters()),
    }
    for name, fn in parts.items():
        dev = sum(device_ms(fn, iters=3).values())
        issue = statistics.median(host_ms(fn, iters=5, warmup=1))
        torch.cuda.synchronize()
        print(f"DIEN part {name}, forward and backward at B={B}, T={T}, H={H}: device "
              f"{dev:.3f} ms, host {issue:.3f} ms to issue; on {card}", flush=True)

    lids = torch.as_tensor(din_stream(din_batch(0, negatives=True)[0]), device="cuda")
    ct = torch.randn(lids.numel(), DIN_DIM, generator=gen, device="cuda") * 1e-3
    table = torch.randn(DIN_USERS + DIN_ITEMS, DIN_DIM, generator=gen, device="cuda")
    acc = torch.full_like(table, 0.1)
    lr = on_card(LR)
    pad = lids == DIN_USERS
    kernel = "sparse_rows"
    hot = {}
    for what, (ids, c) in {"with": (lids, ct), "without": (lids[~pad], ct[~pad])}.items():
        dev = device_ms(lambda ids=ids, c=c: fused_adagrad_apply(table, acc, ids, c, eps=EPS,
                                                                  scalars=lr), iters=3)
        hot[what] = sum(ms for name, ms in dev.items() if kernel in name)
    in_step = sum(ms for name, ms in step["per_step"].items() if kernel in name)
    print(f"DIEN padding row: {int(pad.sum())} of {lids.numel()} positions of a step's "
          f"stream; fused_adagrad_rows takes {hot['with']:.4f} ms on the stream and "
          f"{hot['without']:.4f} ms without its padding positions; in the step it takes "
          f"{in_step:.4f} ms of {step['busy_ms']:.4f} ms device busy and of "
          f"{step['step_ms']:.4f} ms a step ({100 * in_step / step['step_ms']:.1f}%); "
          f"on {card}", flush=True)


# ---------------------------------------------------------------------------
# The Criteo CTR models at benchmarks/model_step.py's width, and FMLayer
# ---------------------------------------------------------------------------

def ctr_model(name: str, cols, device="cuda", **overrides):
    """A Criteo CTR model as ``benchmarks/model_step.py:51-68`` builds it
    (f32 towers 256-128-64; DCN with 6 cross layers; DeepCrossing with 3
    residual units of 256-128; PNN's inner products; AFM with 8 attention
    units and its linear term; FFM with k=4), weights from seed 0."""
    from recommender_system_tpu_torch import CTR_MODELS

    kw = {"fm": {}, "dcn": dict(cross_layers=6, hidden_units=(256, 128, 64)),
          "deep_crossing": dict(hidden_units=(256, 128), num_res_blocks=3),
          "pnn": dict(mode="inner", hidden_units=(256, 128, 64)),
          "afm": {}, "ffm": dict(factor_dim=4)}.get(name, dict(hidden_units=(256, 128, 64)))
    return CTR_MODELS[name](tuple(cols), **{**kw, **overrides}, device=device,
                            generator=torch.Generator().manual_seed(0))


def train_ctr_models(card) -> dict:
    """Phase 3g: WideDeep, NFM, FM -> FNN and DCN at model_step.py's width;
    returns the trained WideDeep and NFM trainers, the columns and batches,
    and each path's launches."""
    from recommender_system_tpu_torch import (FusedAdagrad, FusedAdam, FusedSGD,
                                              init_from_fm)
    from recommender_system_tpu_torch.training import SGD, Adagrad, Adam

    cols, batches, labels = staged_batches(range(K), batch=CTR_BATCH)
    out = {"cols": cols, "batches": (batches, labels), "launches": {}}
    out["wide_deep"], out["launches"]["wide_deep"] = train_checked(
        "WideDeep", ctr_model("wide_deep", cols), batches, labels, SGD(SGD_LR),
        FusedSGD(SGD_LR), 3, launches_want(fused_sgd_apply=3 * K), card)
    out["nfm"], out["launches"]["nfm"] = train_checked(
        "NFM", ctr_model("nfm", cols), batches, labels, Adam(ADAM_LR), FusedAdam(ADAM_LR),
        3, launches_want(fused_adam_apply=3 * K), card)
    fm, out["launches"]["fm"] = train_checked(
        "FM", ctr_model("fm", cols), batches, labels, Adam(ADAM_LR), FusedAdam(ADAM_LR), 1,
        launches_want(fused_adam_apply=K), card)
    fnn = init_from_fm(ctr_model("fnn", cols), fm.model)
    if not torch.equal(fnn.embeddings.table_d8, fm.model.unified.embeddings.table_d9[:, :8]):
        raise RuntimeError("init_from_fm: FNN's table_d8 is not the FM table's first 8 columns")
    print("init_from_fm: FNN's table_d8 equals the trained FM's table_d9[:, :8]", flush=True)
    _, out["launches"]["fnn"] = train_checked(
        "FNN", fnn, batches, labels, SGD(SGD_LR), FusedSGD(SGD_LR), 1,
        launches_want(fused_sgd_apply=K), card)
    _, out["launches"]["dcn"] = train_checked(
        "DCN", ctr_model("dcn", cols), batches, labels, Adagrad(LR), FusedAdagrad(LR), 1,
        launches_want(cross_fused=K, fused_adagrad_apply=K), card)
    card_against_cpu(ctr_model("wide_deep", cols), batches, labels, "WideDeep",
                     lambda: SGD(SGD_LR), lambda: FusedSGD(SGD_LR))
    card_against_cpu(ctr_model("nfm", cols), batches, labels, "NFM",
                     lambda: Adam(ADAM_LR), lambda: FusedAdam(ADAM_LR))
    return out


def train_ctr_family(cols, batches, labels, card) -> dict:
    """Phase 3i: DeepCrossing, PNN (inner), AFM and FFM at model_step.py's
    width with ``Adagrad(0.05)`` and ``FusedAdagrad(0.05)``, PNN
    ``mode="both"`` with FGCNN, FFM with the plain step, and two steps of
    PNN and of AFM on the card against the CPU; returns the trainers and
    each path's launches."""
    from recommender_system_tpu_torch import FusedAdagrad, Trainer
    from recommender_system_tpu_torch.training import Adagrad

    t0 = time.perf_counter()
    out = {"launches": {}}
    for name, label in (("deep_crossing", "DeepCrossing"), ("pnn", "PNN"), ("afm", "AFM")):
        out[name], out["launches"][name] = train_checked(
            label, ctr_model(name, cols), batches, labels, Adagrad(LR), FusedAdagrad(LR), 2,
            launches_want(fused_adagrad_apply=2 * K), card)
    # FFM's two tables, table_d1 (its linear weights) and table_d156 (39
    # fields x k=4), each one stream a step
    out["ffm"], out["launches"]["ffm"] = train_checked(
        "FFM", ctr_model("ffm", cols), batches, labels, Adagrad(LR), FusedAdagrad(LR), 3,
        launches_want(fused_adagrad_apply=3 * 2 * K), card)
    # PNN with every product and FGCNN's 57 generated fields: 83 fields,
    # 3,403 pairs, a tower 7,483 wide
    both = ctr_model("pnn", cols, mode="both", use_fgcnn=True)
    _, out["launches"]["pnn_both_fgcnn"] = train_checked(
        "PNN both+FGCNN", both, batches, labels, Adagrad(LR), FusedAdagrad(LR), 1,
        launches_want(fused_adagrad_apply=K), card)
    del both

    # FFM's plain step: a scatter-add for each of its two lookups a step
    trainer = Trainer(ctr_model("ffm", cols), Adagrad(LR))
    zero_counts()
    losses = trainer.multi_step(batches, labels).cpu().numpy()
    launches = read_counts()
    print(f"FFM plain training launches: {launches} over 1 call of K={K}; losses {losses}",
          flush=True)
    if launches != launches_want(scatter_add_sorted=2 * K):
        raise RuntimeError(f"FFM plain training launched {launches}, want {2 * K} "
                           "scatter_add_sorted and nothing else")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"FFM plain training losses not finite: {losses}")
    out["launches"]["ffm_plain"] = launches
    del trainer

    card_against_cpu(ctr_model("pnn", cols), batches, labels, "PNN")
    card_against_cpu(ctr_model("afm", cols), batches, labels, "AFM")
    print(f"phase 3i took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


FM_B, FM_D, FM_K = 16_384, 221, 8


def fm_layer_path(card):
    """Phase 3h: ``FMLayer`` at the JAX package's dispatch-benchmark shape,
    K forward and backward passes; returns (layer, an input, launches)."""
    from recommender_system_tpu_torch.layers import FMLayer
    from recommender_system_tpu_torch.ops.kernels import fm_ref

    layer = FMLayer(FM_D, FM_K, device="cuda", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = [torch.randn(FM_B, FM_D, generator=gen, device="cuda") for _ in range(K)]
    cots = [torch.randn(FM_B, 1, generator=gen, device="cuda") for _ in range(K)]
    params = [layer.w0, layer.w1, layer.v]
    zero_counts()
    results = []
    for x, cot in zip(xs, cots):
        xg = x.clone().requires_grad_(True)
        out = layer(xg)
        results.append((out.detach(), torch.autograd.grad(out, [xg, *params], cot)))
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"FMLayer launches: {launches} over {K} forward and backward passes", flush=True)
    if launches != launches_want(fm_fused=K):
        raise RuntimeError(f"FMLayer launched {launches}, want {K} fm_fused")
    worst = 0.0
    for x, cot, (out, grads) in zip(xs, cots, results):
        xg = x.clone().requires_grad_(True)
        plain = [t.detach().clone().requires_grad_(True) for t in params]
        want = fm_ref(xg, plain[1], plain[2]) + plain[0]
        torch.testing.assert_close(out, want.detach(), rtol=RTOL, atol=ATOL)
        worst = max(worst, (out - want).abs().max().item())
        for g, w in zip(grads, torch.autograd.grad(want, [xg, *plain], cot)):
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL * max(1.0, w.abs().max().item()))
    if not torch.isfinite(torch.cat([o for o, _ in results])).all():
        raise RuntimeError("FMLayer gave values that are not finite")
    print(f"FMLayer x [{FM_B}, {FM_D}], k={FM_K}: outputs equal w0 + fm_ref "
          f"(max_abs_err {worst:.3e}), gradients of x, w0, w1, v equal the plain VJP's; "
          f"on {card}", flush=True)
    return layer, xs[0], launches


def time_fm(layer, x, card) -> dict:
    """Phase 4 for csrc/fm.cu at the FMLayer path's shape."""
    from recommender_system_tpu_torch.ops.kernels import fm_fused, fm_ref

    w1, v = layer.w1.detach(), layer.v.detach()
    with torch.inference_mode():
        kernel_dev = device_ms(lambda: fm_fused(x, w1, v))
        plain_dev = device_ms(lambda: fm_ref(x, w1, v))
        rec = {"call_ms": call_ms(lambda: fm_fused(x, w1, v)),
               "plain_call_ms": call_ms(lambda: fm_ref(x, w1, v))}
    if not all("fm_rows_kernel" in name for name in kernel_dev):
        raise RuntimeError(f"fm_fused ran other device work: {dict(kernel_dev)}")
    rec.update(ms=sum(kernel_dev.values()), plain_ms=sum(plain_dev.values()), library_ms=None)
    rec["bound_ms"], rec["bound_by"] = fm_bound(*x.shape, v.shape[1])
    print(f"timing fm_fused B={x.shape[0]} D={x.shape[1]} k={v.shape[1]}: device "
          f"{rec['ms']:.5f} ms ({100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound "
          f"{rec['bound_ms']:.5f} ms, {rec['bound_by']}), {rec['call_ms']:.5f} ms per call; "
          f"plain fm_ref: device {rec['plain_ms']:.5f} ms in {len(plain_dev)} kernel kinds, "
          f"{rec['plain_call_ms']:.5f} ms per call; on {card}", flush=True)
    return rec


def time_global_kernels(card, errors: dict, counts: dict, wide: dict) -> list:
    """Phase 4 for the global kernels, each at a shape of its path: the
    cross stack at DCN's x0 1,053 wide and the Scorer's batch, the FM logit
    at x [16,384, 4,000], k=8, the DIN attention at B=8,192, 80-40 at its
    three timed shapes (K=128, T=50, the first, phase 3r's; K=64, T=200;
    K=32, T=1,000). Returns their entries of the ``kernels`` line:
    ``errors`` gives each one's largest error in phase 2, ``counts`` phase
    3k's counts, ``wide`` phase 3r's."""
    from recommender_system_tpu_torch.ops.interactions import cross_network
    from recommender_system_tpu_torch.ops.kernels import (cross_fused, din_attention_fused,
                                                          din_attention_ref, fm_fused, fm_ref)

    gen = torch.Generator(device="cuda").manual_seed(11)
    D = FIELDS * WIDE_DIM + 13
    x0 = torch.randn(SERVE_BATCH, D, generator=gen, device="cuda")
    w = torch.randn(6, D, generator=gen, device="cuda") * (0.2 / math.sqrt(D))
    b = torch.randn(6, D, generator=gen, device="cuda") * 0.1
    x0_train = torch.randn(CTR_BATCH, D, generator=gen, device="cuda")
    x, w1, v = fm_inputs(gen, FM_B, WIDE_FM_D, 8)
    trained = f"DCN trained at x0 width {D}"
    cases = [
        ("cross_fused", "cross.cu", "pallas_kernels.py:124", "cross_global_kernel",
         lambda: cross_fused(x0, w, b), lambda: cross_network(x0, w, b),
         lambda: x0.clone(), cross_bound(SERVE_BATCH, D, 6),
         trained, f"B={SERVE_BATCH} D={D} L=6"),
        ("fm_fused", "fm.cu", "pallas_kernels.py:61", "fm_global_kernel",
         lambda: fm_fused(x, w1, v), lambda: fm_ref(x, w1, v),
         lambda: torch.sum(x, 1), fm_bound(FM_B, WIDE_FM_D, 8),
         f"fm_fused at D={WIDE_FM_D}, k=8", f"B={FM_B} D={WIDE_FM_D} k=8"),
    ]
    entries = []
    for name, source, replaces, kernel, fn, plain_fn, floor_fn, bound, path, shape in cases:
        with torch.inference_mode():
            kernel_dev = device_ms(fn)
            plain_dev = device_ms(plain_fn)
            rec = {"events_ms": events_ms(fn), "call_ms": call_ms(fn, iters=50),
                   "plain_call_ms": call_ms(plain_fn, iters=50),
                   "floor_events_ms": events_ms(floor_fn)}
        if not all(kernel in k for k in kernel_dev):
            raise RuntimeError(f"{name} at {shape} ran other device work: {dict(kernel_dev)}")
        rec.update(ms=sum(kernel_dev.values()), plain_ms=sum(plain_dev.values()),
                   library_ms=None)
        rec["bound_ms"], rec["bound_by"] = bound
        print(f"timing {name} ({kernel}) {shape}: device {rec['ms']:.5f} ms by the profiler, "
              f"{rec['events_ms']:.5f} ms by events over a graph of 100 calls "
              f"({100 * rec['bound_ms'] / rec['events_ms']:.1f}% of the bound "
              f"{rec['bound_ms']:.5f} ms, {rec['bound_by']}), {rec['call_ms']:.5f} ms per "
              f"call; a read of the same bytes {rec['floor_events_ms']:.5f} ms; plain: device "
              f"{rec['plain_ms']:.5f} ms in {len(plain_dev)} kernel kinds, "
              f"{rec['plain_call_ms']:.5f} ms per call; on {card}", flush=True)
        entry = {
            "name": f"{name} ({kernel})", "route": "cuda",
            "source": f"recommender_system_tpu_torch/csrc/{source}",
            "replaces": f"recommender_system_tpu/ops/{replaces}",
            "launches": counts[path][global_key(name)], "max_abs_err": errors[kernel],
            **rec, "path": path, "timed_at": shape}
        if name == "cross_fused":
            # DCN training's own batch, and the other paths' launches
            with torch.inference_mode():
                entry["events_ms_b8192"] = events_ms(lambda: cross_fused(x0_train, w, b))
            entry["bound_ms_b8192"] = cross_bound(CTR_BATCH, D, 6)[0]
            entry["graph_launches"] = counts[f"DCN graphed at x0 width {D}"][global_key(name)]
            # x0 past the registers: the global entry point's rows kernel
            entry["rows_kernel_max_abs_err"] = errors["cross_global_rows_kernel"]
            entry["serving_launches"] = counts[f"DCN served at x0 width {D}"][global_key(name)]
            print(f"timing {name} ({kernel}) B={CTR_BATCH} D={D} L=6: "
                  f"{entry['events_ms_b8192']:.5f} ms by events (bound "
                  f"{entry['bound_ms_b8192']:.5f} ms); on {card}", flush=True)
        entries.append(entry)

    # the attention's global kernel at its three shapes, against the
    # tensor cores' bound (three TF32 passes), the bytes' and f32's
    kernel = "din_attention_global_kernel"
    shapes = []
    for K_, T in DIN_GLOBAL_SHAPES:
        q, keys, mask, weights = din_inputs(gen, DIN_BATCH, T, K_, 80, 40)
        mask = mask.float()  # as the wrapper takes it, so that the kernel runs alone
        with torch.inference_mode():
            kernel_dev = device_ms(lambda: din_attention_fused(q, keys, mask, *weights))
            plain_dev = device_ms(lambda: din_attention_ref(q, keys, mask, *weights), iters=10)
            rec = {"K": K_, "T": T,
                   "events_ms": events_ms(lambda: din_attention_fused(q, keys, mask, *weights)),
                   "call_ms": call_ms(lambda: din_attention_fused(q, keys, mask, *weights),
                                      iters=50),
                   "plain_call_ms": call_ms(lambda: din_attention_ref(q, keys, mask, *weights),
                                            iters=10, warmup=3)}
        if not all(kernel in k for k in kernel_dev):
            raise RuntimeError(f"din_attention_fused at K={K_}, T={T} ran other device work: "
                               f"{dict(kernel_dev)}")
        rec.update(ms=sum(kernel_dev.values()), plain_ms=sum(plain_dev.values()),
                   library_ms=None)
        rec["bound_ms"], rec["bound_by"], rec["f32_bound_ms"] = din_bound(
            DIN_BATCH, T, K_, 80, 40)
        rec["byte_bound_ms"] = din_work(DIN_BATCH, T, K_, 80, 40)[0]
        print(f"timing din_attention_fused ({kernel}) B={DIN_BATCH} T={T} K={K_} H1=80 H2=40: "
              f"device {rec['ms']:.5f} ms by the profiler, {rec['events_ms']:.5f} ms by "
              f"events ({100 * rec['bound_ms'] / rec['events_ms']:.1f}% of the "
              f"tensor cores' bound {rec['bound_ms']:.5f} ms, {rec['bound_by']}; bytes "
              f"{rec['byte_bound_ms']:.5f} ms, f32 {rec['f32_bound_ms']:.5f} ms), "
              f"{rec['call_ms']:.5f} ms per call; plain: device {rec['plain_ms']:.5f} ms in "
              f"{len(plain_dev)} kernel kinds, {rec['plain_call_ms']:.5f} ms per call; "
              f"on {card}", flush=True)
        shapes.append(rec)
        del q, keys, mask, weights
    first = {k: v for k, v in shapes[0].items() if k not in ("K", "T")}
    entries.append({
        "name": f"din_attention_fused ({kernel})", "route": "cuda",
        "source": "recommender_system_tpu_torch/csrc/din_attention.cu",
        "replaces": "recommender_system_tpu/ops/pallas_kernels.py:190",
        "launches": wide["train"][global_key("din_attention_fused")],
        "max_abs_err": errors[kernel], **first,
        "path": f"DIN at dim {DIN_WIDE_DIM} trained, three K=8 calls (phase 3r)",
        "timed_at": f"B={DIN_BATCH} T={DIN_T} K={DIN_WIDE_DIM} H1=80 H2=40",
        "serving_launches": wide["serve"][global_key("din_attention_fused")],
        "dien_gru_hidden_128_launches": counts[
            "one fused step of DIEN(gru_hidden=128) at batch 1,024"][
            global_key("din_attention_fused")],
        "shapes": shapes})
    entries.extend(time_global_backward(card, errors, counts, wide, gen))
    return entries


def backward_record(fn, plain, shape, valid: int, kernel: str, what: str, card) -> dict:
    """One backward kernel timed on the card at ``shape`` (B, T, K, H1,
    H2): its device time from the profiler (all of its call's launches),
    per call, its plain version's, and the bound over the ``valid``
    positions (``bound_ms``, the least work) and over all of them."""
    B, T, K_, H1, H2 = shape
    with torch.inference_mode():
        kernel_dev = device_ms(fn, iters=5)
        plain_dev = device_ms(plain, iters=3)
        rec = {"B": B, "K": K_, "T": T, "H1": H1, "H2": H2,
               "call_ms": call_ms(fn, iters=10, warmup=2),
               "plain_call_ms": call_ms(plain, iters=5, warmup=1)}
    # the kernel, beside its own launches: the pack, the row terms, the
    # dlogits, the reduction, dq
    if not any(kernel in k for k in kernel_dev) or not all(
            "din_backward" in k or "row_terms" in k for k in kernel_dev):
        raise RuntimeError(f"din_attention_backward at {shape} ran {dict(kernel_dev)}, not "
                           f"{kernel}")
    rec.update(ms=sum(kernel_dev.values()), plain_ms=sum(plain_dev.values()), library_ms=None,
               launches_a_call=len(kernel_dev))
    # the least work is over the valid positions: a masked one adds to no product
    rec["valid_positions"] = valid
    rec["bound_ms"], rec["bound_by"], rec["f32_bound_ms"] = din_backward_bound(
        *shape, positions=valid)
    rec["all_positions_bound_ms"], rec["all_positions_bound_by"], _ = din_backward_bound(*shape)
    print(f"timing din_attention_backward ({what}, {kernel}) B={B} T={T} K={K_} H1={H1} "
          f"H2={H2}: device {rec['ms']:.5f} ms in {len(kernel_dev)} kernels "
          f"({100 * rec['bound_ms'] / rec['ms']:.1f}% of the tensor cores' bound over the "
          f"{valid} valid positions {rec['bound_ms']:.5f} ms, {rec['bound_by']}; over all "
          f"{B * T} {rec['all_positions_bound_ms']:.5f} ms), {rec['call_ms']:.5f} ms per call; "
          f"plain: device "
          f"{rec['plain_ms']:.5f} ms, {rec['plain_call_ms']:.5f} ms per call; on {card}",
          flush=True)
    return rec


def time_global_backward(card, errors: dict, counts: dict, wide: dict, gen) -> list:
    """Phase 4 for the attention backward's wide and global kernels, on the
    forward's saved weights and a cotangent, each against its plain version
    and the bound (``din_backward_bound``, also over the valid positions):
    the wide kernel at B=8,192, 80-40 at the global forward kernel's three
    timed shapes (its entry timed at the first, phase 3r's); the global
    kernel there too (the launcher's ``global_kernel``) and at its own
    path's shape, DIN's attention with a 128-64 scorer (phase 3k), where its
    entry is timed. Returns the two ``kernels`` entries."""
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.din_vjp import din_attention_backward_ref

    def inputs(B, T, K_, H1, H2):
        q, keys, mask, weights = din_inputs(gen, B, T, K_, H1, H2)
        mask = mask.float()
        with torch.inference_mode():
            _, saved = kernels._din_launch(q, keys, mask, *weights, "sigmoid", True, False, True)
        cot = torch.randn(B, K_, generator=gen, device="cuda")
        return (q, keys, mask, *weights, saved, cot), int((mask > 0.5).sum().item())

    wide_shapes, global_shapes = [], []
    for K_, T in DIN_GLOBAL_SHAPES:
        shape = (DIN_BATCH, T, K_, 80, 40)
        args, valid = inputs(*shape)
        if kernels.din_backward_route(*args, "sigmoid", False) != "wide":
            raise RuntimeError(f"the backward's wide kernel does not take K={K_}, T={T}")
        plain = lambda: din_attention_backward_ref(*args)  # noqa: E731
        wide_shapes.append(backward_record(
            lambda: kernels._din_backward_launch(*args, "sigmoid", True, False), plain, shape,
            valid, "din_backward_wide_kernel", "wide kernel", card))
        global_shapes.append(backward_record(
            lambda: kernels._din_backward_launch(*args, "sigmoid", True, False,
                                                 global_kernel=True), plain, shape, valid,
            "din_backward_kernel", "global kernel", card))
        del args
    shape = (DIN_BATCH, DIN_T, DIN_DIM) + DIN_WIDE_SCORER
    args, valid = inputs(*shape)
    if kernels.din_backward_route(*args, "sigmoid", False) != "global":
        raise RuntimeError(f"the backward's global kernel does not take {shape}")
    own = backward_record(lambda: kernels._din_backward_launch(*args, "sigmoid", True, False),
                          lambda: din_attention_backward_ref(*args), shape, valid,
                          "din_backward_kernel", "global kernel", card)
    del args
    first = {k: v for k, v in wide_shapes[0].items() if k not in ("B", "K", "T", "H1", "H2")}
    dien = counts["one fused step of DIEN(gru_hidden=128) at batch 1,024"]
    scorer_path = f"one fused step of DIN(att_hidden_units={DIN_WIDE_SCORER}) at batch 1,024"
    return [{
        "name": "din_attention_backward (din_backward_wide_kernel)", "route": "cuda",
        "source": "recommender_system_tpu_torch/csrc/din_attention.cu",
        "replaces": "recommender_system_tpu/ops/din_vjp.py:120",
        "launches": wide["train"][wide_key("din_attention_backward")],
        "max_abs_err": errors["din_attention_wide_backward"], **first,
        "path": f"DIN at dim {DIN_WIDE_DIM} trained, three K=8 calls (phase 3r)",
        "timed_at": f"B={DIN_BATCH} T={DIN_T} K={DIN_WIDE_DIM} H1=80 H2=40",
        "global_launches_there": wide["train"][global_key("din_attention_backward")],
        "dien_gru_hidden_128_launches": dien[wide_key("din_attention_backward")],
        "dien_gru_hidden_128_global_launches": dien[global_key("din_attention_backward")],
        "shapes": wide_shapes,
    }, {
        "name": "din_attention_backward (din_backward_kernel)", "route": "cuda",
        "source": "recommender_system_tpu_torch/csrc/din_attention.cu",
        "replaces": "recommender_system_tpu/ops/din_vjp.py:120",
        "launches": counts[scorer_path][global_key("din_attention_backward")],
        "max_abs_err": errors["din_attention_global_backward"],
        **{k: v for k, v in own.items() if k not in ("B", "K", "T", "H1", "H2")},
        "path": f"{scorer_path} (phase 3k)",
        "timed_at": "B={} T={} K={} H1={} H2={}".format(*shape),
        "shapes": global_shapes,
    }]


# ---------------------------------------------------------------------------
# DSSM and RetrievalIndex, MMOE, at benchmarks/model_step.py's width
# ---------------------------------------------------------------------------

# model_step.py:109-122: DSSM's towers over DIN's columns (the user tower
# reads user_id and the mean-pooled history, the item tower item_id), the
# in-batch softmax at temperature 0.05; the RetrievalIndex catalog is every
# item id but the padding id 0
DSSM_TEMPERATURE, RETRIEVAL_K = 0.05, 10
RETRIEVAL_USERS = (1, 1024, DIN_BATCH)
CATALOG = np.arange(1, DIN_ITEMS, dtype=np.int32)


def dssm_loss(outputs, labels, batch):
    """``model_step.py:119-121``: the in-batch softmax of the two towers'
    embeddings, each row's own item its label (``labels`` unused)."""
    from recommender_system_tpu_torch.training.losses import inbatch_softmax_loss

    u, v = outputs
    return inbatch_softmax_loss(u, v, batch["item_id"], temperature=DSSM_TEMPERATURE)


def dssm_model(device: str = "cuda"):
    """DSSM at model_step.py's width (towers 256-128-64, relu, f32, the
    user and item columns on one table_d32 of 300,000 x 32) on ``device``,
    weights from seed 0, table_d32 at std 0.1 as DIN's."""
    from recommender_system_tpu_torch import DSSM

    user_id, item_id, hist, _ = din_columns()
    model = DSSM((user_id, hist), (item_id,), user_hidden_units=(256, 128, 64),
                 item_hidden_units=(256, 128, 64), device=device,
                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.embeddings.table_d32.normal_(
            0.0, 0.1, generator=torch.Generator(device=device).manual_seed(1))
    return model


def dssm_staged(seeds, batch: int = DIN_BATCH):
    """model_step.py's DSSM batches (DIN's, without the price column), one
    seed each, stacked on a leading K axis on the card."""
    batches, labels = din_staged(seeds, batch=batch)
    return {k: v for k, v in batches.items() if k != "price"}, labels


def dssm_stream(X) -> np.ndarray:
    """DSSM's lookup sites of table_d32 in the order the fused step
    concatenates them: the user tower's [B, 1] user_id and [B, T] history,
    then the item tower's [B, 1] item_id."""
    return np.concatenate([X["user_id"].astype(np.int64),
                           X["hist_item_id"].astype(np.int64).reshape(-1) + DIN_USERS,
                           X["item_id"].astype(np.int64) + DIN_USERS])


def train_dssm(batches, labels, card):
    """Phase 3l, training: three fused K=8 calls, one fused_adagrad_apply a
    step (the three sites of table_d32 one stream) and no scatter-add; every
    touched user_id row moved; one plain call, one scatter-add a site a
    step. Returns (trainer, fused launches, plain launches)."""
    from recommender_system_tpu_torch import FusedAdagrad, Trainer
    from recommender_system_tpu_torch.training import Adagrad

    model = dssm_model()
    start = model.embeddings.table_d32.detach().clone()
    trainer, fused_launches = train_checked(
        "DSSM", model, batches, labels, Adagrad(LR), FusedAdagrad(LR), 3,
        launches_want(fused_adagrad_apply=3 * K), card, touched=table_d32_touched(batches),
        loss_fn=dssm_loss)
    users = torch.unique(batches["user_id"].reshape(-1).long())
    moved = (model.embeddings.table_d32.detach()[users] != start[users]).any(dim=1)
    if not bool(moved.all()):
        raise RuntimeError(f"DSSM fused training left {int((~moved).sum())} of "
                           f"{users.numel()} touched user_id rows as they were")
    print(f"DSSM fused training: all {users.numel()} touched user_id rows moved", flush=True)

    plain = Trainer(dssm_model(), Adagrad(LR), loss_fn=dssm_loss)
    zero_counts()
    losses = plain.multi_step(batches, labels).cpu().numpy()
    plain_launches = read_counts()
    # a step: the user tower's two lookups (user_id; the history) and the
    # item tower's one, each with one scatter-add in its backward
    want = launches_want(scatter_add_sorted=3 * K)
    print(f"DSSM plain training launches: {plain_launches} over 1 call of K={K}; "
          f"losses {losses}", flush=True)
    if plain_launches != want:
        raise RuntimeError(f"DSSM plain training launched {plain_launches}, want {want}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"DSSM plain training losses not finite: {losses}")
    return trainer, fused_launches, plain_launches


def same_topk(got_ids, got_scores, want_ids, want_scores, atol: float) -> int:
    """Scores equal within ``atol``; ids equal wherever a score lies more
    than ``atol`` from its neighbours' (a tie may come in either order).
    Returns the count of positions whose ids were compared."""
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=atol)
    gaps = np.abs(np.diff(want_scores, axis=-1)) > atol
    apart = np.ones(want_scores.shape, bool)
    apart[:, 1:] &= gaps
    apart[:, :-1] &= gaps
    np.testing.assert_array_equal(got_ids[apart], want_ids[apart])
    return int(apart.sum())


def serve_dssm(model, card):
    """Phase 3l, serving: ``RetrievalIndex`` over the catalog, queried by 1,
    1,024 and 8,192 users at k=10 (no kernel on the path); ids and scores
    equal a brute force on the card (a full product and a sort, 1,024 users
    at a time) and the CPU path's on 64 users; recall@10 of the 8,192-user answer against each
    row's item_id. Returns (index, requests, launches)."""
    from recommender_system_tpu_torch import RetrievalIndex
    from recommender_system_tpu_torch.utils.metrics import recall_at_n

    X, _ = din_batch(100, max(RETRIEVAL_USERS))
    requests = {n: {k: X[k][:n] for k in ("user_id", "hist_item_id")}
                for n in RETRIEVAL_USERS}
    zero_counts()
    t0 = time.perf_counter()
    index = RetrievalIndex(model, {"item_id": CATALOG})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    answers = {n: index.query(req, k=RETRIEVAL_K) for n, req in requests.items()}
    launches = read_counts()
    if launches != launches_want():
        raise RuntimeError(f"DSSM retrieval launched {launches}; its path has no kernel")
    compared = 0
    for n, (ids, scores) in answers.items():
        if (ids.shape != (n, RETRIEVAL_K) or scores.dtype != np.float32
                or not np.isfinite(scores).all() or (np.diff(scores, axis=-1) > 0).any()):
            raise RuntimeError(f"DSSM query of {n} users answered {ids.shape} "
                               f"{scores.dtype}, or not best first")
        for lo in range(0, n, 1024):
            with torch.inference_mode():
                user = model.user_embedding({k: torch.as_tensor(v[lo:lo + 1024], device="cuda")
                                             for k, v in requests[n].items()})
                full = torch.matmul(user, index.item_embeddings.T)
                top, order = torch.sort(full, dim=-1, descending=True)
                want_scores = top[:, :RETRIEVAL_K].cpu().numpy()
                want_ids = CATALOG[order[:, :RETRIEVAL_K].cpu().numpy()]
            compared += same_topk(ids[lo:lo + 1024], scores[lo:lo + 1024], want_ids,
                                  want_scores, ATOL)
    positions = sum(RETRIEVAL_USERS) * RETRIEVAL_K
    if compared < positions // 2:
        raise RuntimeError(f"DSSM retrieval: only {compared} of {positions} top-k ids lie "
                           f"apart from their neighbours by more than {ATOL}: the check "
                           "against the brute force would be void")
    cpu_index = RetrievalIndex(copy.deepcopy(model).to("cpu"), {"item_id": CATALOG},
                               device="cpu")
    mid = RETRIEVAL_USERS[1]
    sub = {k: v[:64] for k, v in requests[mid].items()}
    cpu_ids, cpu_scores = cpu_index.query(sub, k=RETRIEVAL_K)
    same_topk(answers[mid][0][:64], answers[mid][1][:64], cpu_ids, cpu_scores, ATOL)
    recall = recall_at_n(answers[DIN_BATCH][0], X["item_id"])
    top = answers[DIN_BATCH][1]
    print(f"DSSM retrieval check: catalog of {CATALOG.size} items embedded in "
          f"{build_s:.3f} s; queries of {list(RETRIEVAL_USERS)} users at k={RETRIEVAL_K} "
          f"equal a full product and sort on the card ({compared} of {positions} ids "
          f"apart from ties and compared) and, on 64 users, the CPU path (atol={ATOL}, ties "
          f"in either order); best scores' std over users {np.std(top[:, 0]):.4g}, mean "
          f"gap from the best to the {RETRIEVAL_K}th {np.mean(top[:, 0] - top[:, -1]):.4g}; "
          f"recall@{RETRIEVAL_K} of the "
          f"{DIN_BATCH}-user answer against each row's item_id: {recall}; on {card}",
          flush=True)
    return index, requests, launches


def time_dssm(trainer, index, requests, batches, labels, card) -> None:
    """Phase 4 for DSSM: the fused step's throughput, idle share, top device
    work and host ops; the padding row's share of fused_adagrad_rows; the
    RetrievalIndex's latency at 1 and 1,024 users and its catalog build."""
    from recommender_system_tpu_torch import RetrievalIndex
    from recommender_system_tpu_torch.ops.fused_adagrad import fused_adagrad_apply

    step = time_training(trainer, batches, labels, card, "DSSM fused training")
    lids = torch.as_tensor(dssm_stream(din_batch(0)[0]), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    ct = torch.randn(lids.numel(), DIN_DIM, generator=gen, device="cuda") * 1e-3
    table = torch.randn(DIN_USERS + DIN_ITEMS, DIN_DIM, generator=gen, device="cuda")
    acc = torch.full_like(table, 0.1)
    lr = on_card(LR)
    pad = lids == DIN_USERS
    kernel = "sparse_rows"
    hot = {}
    for what, (ids, c) in {"with": (lids, ct), "without": (lids[~pad], ct[~pad])}.items():
        dev = device_ms(lambda ids=ids, c=c: fused_adagrad_apply(table, acc, ids, c, eps=EPS,
                                                                  scalars=lr), iters=3)
        hot[what] = sum(ms for name, ms in dev.items() if kernel in name)
    in_step = sum(ms for name, ms in step["per_step"].items() if kernel in name)
    print(f"DSSM padding row: {int(pad.sum())} of {lids.numel()} positions of a step's "
          f"stream; fused_adagrad_rows takes {hot['with']:.4f} ms on the stream and "
          f"{hot['without']:.4f} ms without its padding positions; in the step it takes "
          f"{in_step:.4f} ms of {step['busy_ms']:.4f} ms device busy and of "
          f"{step['step_ms']:.4f} ms a step ({100 * in_step / step['step_ms']:.1f}%); "
          f"on {card}", flush=True)

    model = index.model
    for n in RETRIEVAL_USERS[:2]:
        times = host_ms(lambda n=n: index.query(requests[n], k=RETRIEVAL_K), iters=30)
        print(f"timing RetrievalIndex query of {n} user(s), k={RETRIEVAL_K} over "
              f"{CATALOG.size} items: median {statistics.median(times):.3f} ms, min "
              f"{min(times):.3f} ms, max {max(times):.3f} ms over {len(times)}; on {card}",
              flush=True)
    build = host_ms(lambda: (RetrievalIndex(model, {"item_id": CATALOG}),
                             torch.cuda.synchronize()), iters=5, warmup=1)
    print(f"timing RetrievalIndex catalog build ({CATALOG.size} items through the item "
          f"tower): median {statistics.median(build):.3f} ms over {len(build)}; on {card}",
          flush=True)
    mid = RETRIEVAL_USERS[1]
    query_dev = device_ms(lambda: index.query(requests[mid], k=RETRIEVAL_K), iters=10)
    busy = sum(query_dev.values())
    print(f"RetrievalIndex {mid}-user query: device busy {busy:.4f} ms; top device work:",
          flush=True)
    for name, ms in query_dev.most_common(6):
        print(f"  {ms:.4f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")


MMOE_REQUESTS = (1, 1000, 20_000)


def mmoe_model(cols, device: str = "cuda"):
    """MMOE at model_step.py:69-71's width (2 tasks, 4 experts of 64 units,
    towers of 64) over the Criteo columns, weights from seed 0."""
    from recommender_system_tpu_torch import MMOE

    return MMOE(feature_columns=tuple(cols), num_tasks=2, num_experts=4, expert_units=64,
                tower_hidden_units=(64,), device=device,
                generator=torch.Generator().manual_seed(0))


def mmoe_path(cols, batches, labels, card):
    """Phase 3m: MMOE fused (two K=8 calls, one fused_adagrad_apply a step),
    two steps on the card against the CPU, and ``Scorer(batch_size=8192)``
    answering 1, 1,000 and 20,000 rows with two probabilities a row (no
    kernel on the path), equal to the CPU path on 1,000 rows. Labels are
    model_step.py:74's ``[y, y[::-1]]``. Returns (trainer, labels,
    launches)."""
    from recommender_system_tpu_torch import FusedAdagrad, Scorer
    from recommender_system_tpu_torch.training import Adagrad
    from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

    labels2 = torch.stack([labels, labels.flip(-1)], dim=-1)  # [K, B, 2]
    trainer, launches = train_checked(
        "MMOE", mmoe_model(cols), batches, labels2, Adagrad(LR), FusedAdagrad(LR), 2,
        launches_want(fused_adagrad_apply=2 * K), card)
    card_against_cpu(mmoe_model(cols), batches, labels2, "MMOE")

    _, X, _ = synthetic_criteo(n_rows=max(MMOE_REQUESTS), vocab=VOCAB,
                               embedding_dim=FACTOR_DIM, seed=100)
    requests = {n: {k: v[:n] for k, v in X.items()} for n in MMOE_REQUESTS}
    scorer = Scorer(trainer.model, batch_size=CTR_BATCH)
    zero_counts()
    answers = {n: scorer(req) for n, req in requests.items()}
    served = read_counts()
    if served != launches_want():
        raise RuntimeError(f"MMOE serving launched {served}; its path has no kernel")
    for n, got in answers.items():
        if got.shape != (n, 2) or got.dtype != np.float32 or not np.isfinite(got).all():
            raise RuntimeError(f"MMOE request of {n} rows answered {got.shape} {got.dtype}")
    cpu_scorer = Scorer(copy.deepcopy(trainer.model).to("cpu"), batch_size=CTR_BATCH,
                        device="cpu")
    np.testing.assert_allclose(answers[1000], cpu_scorer(requests[1000]), rtol=0, atol=ATOL)
    spread = float(np.std(answers[max(MMOE_REQUESTS)], axis=0).min())
    if spread < 1e-4:
        raise RuntimeError(f"MMOE scores barely vary (std {spread}): inputs have no say")
    print(f"MMOE serving check: {len(MMOE_REQUESTS)} requests answered [n, 2], the "
          f"1,000-row one equal to the CPU path (atol={ATOL}); smaller task's score std "
          f"{spread:.4f}; on {card}", flush=True)
    return trainer, labels2, launches


# ---------------------------------------------------------------------------
# The training CLI: python -m recommender_system_tpu_torch.train on the card
# ---------------------------------------------------------------------------

# a Criteo-format TSV of 4 packed groups of 8 batches of 16,384 rows, and a
# held-out file drawn from the same token pools with other rows
CLI_BATCH, CLI_K, CLI_GROUPS = 16_384, 8, 4
CLI_ROWS, CLI_HELD_OUT = CLI_GROUPS * CLI_K * CLI_BATCH, 65_536
CLI_BUCKETS = 1_000_000
CLI_EPOCHS = 5  # the CLI's default
# the resumed run: stopped at step 16 (checkpoints every 8), resumed to 32
CLI_STOP, CLI_EVERY, CLI_TOTAL = 16, 8, 32
# every model the CLI builds, a few steps at its defaults on synthetic data
CLI_MODEL_ROWS = 2048
# card against CPU for the CLI's DeepFM: train_loss per epoch at f32
# tolerance; AUC and logloss, rounded to 4 places by the CLI, may move by a
# swapped near-tie of the 409 held-out predictions
CLI_LOSS_RTOL, CLI_METRIC_ATOL = 1e-4, 2e-3


def write_criteo_tsv(path: str, rows: int, row_seed: int, pool_seed: int = 0) -> None:
    """A Criteo-format TSV (``label \t I1..I13 \t C1..C26``) with a learnable
    label: dense ints, 8-hex-digit tokens drawn skewed from per-column pools
    of 20,000-100,000 tokens (``pool_seed`` fixes the pools and the tokens'
    label effects, ``row_seed`` the rows), 5 % of the fields missing."""
    pool_rng = np.random.default_rng(pool_seed)
    vocabs = [20_000 * (1 + 2 * (i % 3)) for i in range(26)]
    pools = [np.char.mod("%08x", pool_rng.integers(0, 2 ** 32, v, dtype=np.uint64))
             for v in vocabs]
    effects = [0.25 * np.sin(np.arange(v) * (i + 1) * 0.37) for i, v in enumerate(vocabs)]
    rng = np.random.default_rng(row_seed)
    logits = np.zeros(rows)
    cols = []
    for i in range(13):
        v = rng.integers(0, 1000, rows)
        logits += (0.4 if i % 2 == 0 else -0.4) * (v / 1000.0 - 0.5)
        s = v.astype("U4")
        s[rng.random(rows) < 0.05] = ""
        cols.append(s)
    for i in range(26):
        ids = (rng.random(rows) ** 2 * vocabs[i]).astype(np.int64)
        logits += effects[i][ids]
        s = pools[i][ids]
        s[rng.random(rows) < 0.05] = ""
        cols.append(s)
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logits))).astype(np.int64)
    with open(path, "w") as f:
        f.write("\n".join("\t".join(r) for r in zip(y.astype("U1"), *cols)) + "\n")


def north_star(train_path: str, held_out: str, *more: str) -> list:
    """The README's out-of-core command on the two files."""
    return ["--stream", "--data-path", train_path, "--stream-eval-path", held_out,
            "--fused-embedding", "adagrad", "--batch-size", str(CLI_BATCH),
            "--hash-buckets", str(CLI_BUCKETS), *more]


def cli_run(argv: list, want: dict, name: str, card) -> tuple:
    """``main(argv)`` in this process, its launches counted; they must equal
    ``want``. Returns (result, launches, seconds)."""
    from recommender_system_tpu_torch.train import main

    zero_counts()
    t0 = time.perf_counter()
    result = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    print(f"CLI {name}: {seconds:.1f} s, launches {launches}; on {card}", flush=True)
    if launches != want:
        raise RuntimeError(f"CLI {name} launched {launches}, want {want}")
    losses = np.asarray(result["train_loss"])
    if losses.size == 0 or not np.isfinite(losses).all():
        raise RuntimeError(f"CLI {name}: train_loss {result['train_loss']}")
    return result, launches, seconds


def cli_north_star(train_path: str, held_out: str, card) -> tuple:
    """Phase 3n (b): the north-star stream at full width, CLI_EPOCHS epochs
    of CLI_ROWS rows: one fused_adagrad_apply a step and nothing else; the
    held-out AUC above 0.5. Returns (result, launches)."""
    steps = CLI_EPOCHS * CLI_ROWS // CLI_BATCH
    result, launches, _ = cli_run(north_star(train_path, held_out),
                                  launches_want(fused_adagrad_apply=steps),
                                  "north-star stream", card)
    if not (result["auc"] > 0.5 and np.isfinite(result["logloss"])):
        raise RuntimeError(f"CLI north-star stream: held-out {result}")
    if not result["train_loss"][-1] < result["train_loss"][0]:
        raise RuntimeError(f"CLI north-star stream: loss did not fall {result['train_loss']}")
    print(f"CLI north-star stream ({CLI_EPOCHS} epochs of {CLI_ROWS} rows, batch {CLI_BATCH}, "
          f"{CLI_BUCKETS} buckets): {result}; on {card}", flush=True)
    return result, launches


def _checkpoint(path: str) -> dict:
    from recommender_system_tpu_torch.training.checkpoint import FILE, latest_step

    return torch.load(f"{path}/{latest_step(path)}/{FILE}", map_location="cuda",
                      weights_only=True)


def _tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}/{i}")


def cli_graph_against_loop(train_path: str, held_out: str, tmp: str, graphed: dict,
                           card) -> None:
    """Phase 3q for the CLI: the north-star command to CLI_TOTAL steps with
    every packed group's call looped (``make_multi_step_packed(spec,
    graphed=False)``); its final checkpoint must equal ``graphed``, the
    uninterrupted run's, whose groups ran as graph replays from the second
    on, bitwise."""
    from recommender_system_tpu_torch.training import Trainer

    looped = f"{tmp}/looped"
    packed = Trainer.make_multi_step_packed
    Trainer.make_multi_step_packed = lambda self, spec, graphed=True: packed(
        self, spec, graphed=False)
    try:
        cli_run(north_star(train_path, held_out, "--stream-max-steps", str(CLI_TOTAL),
                           "--checkpoint-dir", looped),
                launches_want(fused_adagrad_apply=CLI_TOTAL), "stream to step 32 looped",
                card)
    finally:
        Trainer.make_multi_step_packed = packed
    ta, tb = dict(_tensors(graphed)), dict(_tensors(_checkpoint(looped)))
    unequal = [k for k in ta if not torch.equal(ta[k], tb[k])]
    if ta.keys() != tb.keys() or unequal:
        raise RuntimeError(f"graph CLI north-star stream: {len(unequal)} tensors of the "
                           f"looped run's checkpoint differ from the graphed run's, e.g. "
                           f"{unequal[:4]}")
    print(f"graph CLI north-star stream: {CLI_TOTAL} steps in packed groups of {CLI_K}, "
          f"graphed and looped, end in bitwise equal checkpoints "
          f"({len(ta)} tensors); on {card}", flush=True)
    shutil.rmtree(looped)


def cli_resume(train_path: str, held_out: str, tmp: str, card) -> dict:
    """Phase 3n (c): the north-star command run to CLI_TOTAL steps at once,
    and stopped at CLI_STOP (checkpoints every CLI_EVERY), then resumed to
    CLI_TOTAL; the two final checkpoints (parameters, the dense Adam's
    moments, the tables' Adagrad slots, the step, the generator) must be
    bitwise equal. Returns the resumed run's launches."""
    whole, part = f"{tmp}/whole", f"{tmp}/part"
    cli_run(north_star(train_path, held_out, "--stream-max-steps", str(CLI_TOTAL),
                       "--checkpoint-dir", whole),
            launches_want(fused_adagrad_apply=CLI_TOTAL), "stream to step 32", card)
    cli_run(north_star(train_path, held_out, "--stream-max-steps", str(CLI_STOP),
                       "--checkpoint-every", str(CLI_EVERY), "--checkpoint-dir", part),
            launches_want(fused_adagrad_apply=CLI_STOP), "stream stopped at step 16", card)
    saved = sorted(int(d) for d in os.listdir(part) if d.isdigit())
    if saved != list(range(CLI_EVERY, CLI_STOP + 1, CLI_EVERY)):
        raise RuntimeError(f"CLI stream saved checkpoints at steps {saved}")
    for step in saved[:-1]:  # 1.9 GB each; the resumed run reads the last
        shutil.rmtree(f"{part}/{step}")
    _, launches, _ = cli_run(
        north_star(train_path, held_out, "--stream-max-steps", str(CLI_TOTAL),
                   "--checkpoint-dir", part, "--resume"),
        launches_want(fused_adagrad_apply=CLI_TOTAL - CLI_STOP), "stream resumed to step 32",
        card)
    a, b = _checkpoint(whole), _checkpoint(part)
    if not a["step"] == b["step"] == CLI_TOTAL:
        raise RuntimeError(f"CLI resume: steps {a['step']} and {b['step']}")
    cli_graph_against_loop(train_path, held_out, tmp, a, card)
    ta, tb = dict(_tensors(a)), dict(_tensors(b))
    if ta.keys() != tb.keys():
        raise RuntimeError("CLI resume: the checkpoints hold different tensors")
    unequal = [k for k in ta if not torch.equal(ta[k], tb[k])]
    if unequal:
        raise RuntimeError(f"CLI resume: {len(unequal)} tensors differ from the "
                           f"uninterrupted run's, e.g. {unequal[:4]}")
    elements = sum(t.numel() for t in ta.values())
    print(f"CLI resume: the resumed run's step-{CLI_TOTAL} checkpoint equals the "
          f"uninterrupted run's bitwise ({len(ta)} tensors, {elements} elements: parameters, "
          f"Adam moments, the table's Adagrad slot, the generator); on {card}", flush=True)
    shutil.rmtree(whole)
    shutil.rmtree(part)
    return launches


def cli_quick_start(train_path: str, card) -> dict:
    """Phase 3n (d): the README's in-memory quick start on the training
    file (10,000 rows, 8,000 trained, batch 512, 2 epochs): one
    scatter_add_sorted a step and nothing else. Returns the launches."""
    steps = 2 * ((10_000 - 10_000 // 5) // 512)
    result, launches, _ = cli_run(
        ["--model", "deepfm", "--dataset", "criteo", "--data-path", train_path,
         "--hash-buckets", "50000", "--epochs", "2", "--batch-size", "512",
         "--max-rows", "10000"], launches_want(scatter_add_sorted=steps), "quick start", card)
    if not 0.0 <= result["auc"] <= 1.0 or not np.isfinite(result["logloss"]):
        raise RuntimeError(f"CLI quick start: {result}")
    print(f"CLI quick start: {result}; on {card}", flush=True)
    return launches


# the kernels each CLI model launches: per training step (the plain step,
# the CLI's default), and per evaluation forward
CLI_MODEL_LAUNCHES = {
    "afm": ({"scatter_add_sorted": 1}, {}),
    "dcn": ({"scatter_add_sorted": 1, "cross_fused": 1}, {"cross_fused": 1}),
    "deep_crossing": ({"scatter_add_sorted": 1}, {}),
    "deepfm": ({"scatter_add_sorted": 1}, {}),
    "dien": ({"scatter_add_sorted": 3, "din_attention_fused": 1, "din_attention_backward": 1},
             {"din_attention_fused": 1}),
    "din": ({"scatter_add_sorted": 2, "din_attention_fused": 1, "din_attention_backward": 1},
            {"din_attention_fused": 1}),
    "dssm": ({"scatter_add_sorted": 3}, {}),
    "ffm": ({"scatter_add_sorted": 2}, {}),
    "fm": ({"scatter_add_sorted": 1}, {}),
    "fnn": ({"scatter_add_sorted": 1}, {}),
    "lstm": ({}, {}),
    "mmoe": ({"scatter_add_sorted": 1}, {}),
    "nfm": ({"scatter_add_sorted": 1}, {}),
    "pnn": ({"scatter_add_sorted": 1}, {}),
    "transformer": ({}, {}),
    "wide_deep": ({"scatter_add_sorted": 1}, {}),
}


def cli_models(card) -> dict:
    """Phase 3n (e): every model the CLI builds, one epoch of CLI_MODEL_ROWS
    synthetic rows at its defaults (batch 256): the launches of
    CLI_MODEL_LAUNCHES; then DeepFM with ``--optimizer adagrad
    --learning-rate 0.05`` on the card and with ``--device cpu``, whose
    train_loss, AUC and logloss agree. Returns {model: launches}."""
    from recommender_system_tpu_torch.models import CTR_MODELS

    names = sorted(CTR_MODELS) + ["dssm", "mmoe", "lstm", "transformer"]
    if sorted(names) != sorted(CLI_MODEL_LAUNCHES):
        raise RuntimeError(f"the CLI builds {sorted(names)}")
    n_test = CLI_MODEL_ROWS // 5
    steps = (CLI_MODEL_ROWS - n_test) // 256
    evals = -(-n_test // 1024)
    base = ["--dataset", "synthetic", "--max-rows", str(CLI_MODEL_ROWS), "--epochs", "1"]
    out = {}
    for name in names:
        per_step, per_eval = CLI_MODEL_LAUNCHES[name]
        want = launches_want(**{k: steps * per_step.get(k, 0) + evals * per_eval.get(k, 0)
                                for k in set(per_step) | set(per_eval)})
        result, out[name], _ = cli_run(["--model", name, *base], want, name, card)
        print(f"  {name}: {result}", flush=True)
    argv = ["--model", "deepfm", *base, "--optimizer", "adagrad", "--learning-rate", "0.05"]
    card_result, _, _ = cli_run(argv, launches_want(scatter_add_sorted=steps),
                                "deepfm adagrad", card)
    cpu_result, _, _ = cli_run(argv + ["--device", "cpu"], launches_want(),
                               "deepfm adagrad --device cpu", card)
    np.testing.assert_allclose(card_result["train_loss"], cpu_result["train_loss"],
                               rtol=CLI_LOSS_RTOL)
    for key in ("auc", "logloss"):
        np.testing.assert_allclose(card_result[key], cpu_result[key], rtol=0,
                                   atol=CLI_METRIC_ATOL)
    print(f"CLI DeepFM card against CPU: train_loss {card_result['train_loss']} / "
          f"{cpu_result['train_loss']} (rtol={CLI_LOSS_RTOL}), auc {card_result['auc']} / "
          f"{cpu_result['auc']}, logloss {card_result['logloss']} / {cpu_result['logloss']} "
          f"(atol={CLI_METRIC_ATOL}); on {card}", flush=True)
    return out


def cli_path(card) -> dict:
    """Phase 3n: the CLI on the card. The native parser must build; the
    files go to a temporary directory."""
    from recommender_system_tpu_torch import native

    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"the port's native parser did not build: {native.build_error()}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    train_path, held_out = f"{tmp}/train.tsv", f"{tmp}/heldout.tsv"
    write_criteo_tsv(train_path, CLI_ROWS, row_seed=1)
    write_criteo_tsv(held_out, CLI_HELD_OUT, row_seed=2)
    print(f"phase 3n: the native parser built ({native.library_path().name}); wrote "
          f"{CLI_ROWS} and {CLI_HELD_OUT} rows ({os.path.getsize(train_path) / 1e6:.1f} and "
          f"{os.path.getsize(held_out) / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    result, stream_launches = cli_north_star(train_path, held_out, card)
    resume_launches = cli_resume(train_path, held_out, tmp, card)
    quick_launches = cli_quick_start(train_path, card)
    model_launches = cli_models(card)
    print(f"phase 3n took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"tmp": tmp, "train": train_path, "held_out": held_out, "result": result,
            "stream": stream_launches, "resume": resume_launches, "quick": quick_launches,
            "models": model_launches}


def device_busy_from_trace(path: str) -> tuple:
    """(device busy ms, traced span ms) of a ``torch.profiler`` chrome trace:
    the union of its kernel, copy and set intervals, and the span of all its
    events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for lo, hi in device:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return busy / 1e3, span / 1e3


def time_cli(cli: dict, card) -> None:
    """Phase 4 for the stream CLI: one epoch of the north-star command
    through ``run_stream`` with its host clocks (waiting for the parser,
    bucketing, packing, issuing the copies and the steps) and CUDA events
    around each group's call; then one epoch under ``--profile-dir``, whose
    trace gives the device's idle share."""
    from recommender_system_tpu_torch.train import parse_args, run_stream

    argv = north_star(cli["train"], cli["held_out"], "--epochs", "1")
    timings = {}
    t0 = time.perf_counter()
    result = run_stream(parse_args(argv), timings=timings)
    wall = time.perf_counter() - t0
    events = timings["events"]
    group_ms = [a.elapsed_time(b) for a, b in events]
    first_to_last = events[0][0].elapsed_time(events[-1][1])
    rows = len(events) * CLI_K * CLI_BATCH
    print(f"timing stream CLI, 1 epoch of {CLI_ROWS} rows: the CLI's own figure "
          f"{result['examples_per_sec']} examples/s (5-epoch run of phase 3n: "
          f"{cli['result']['examples_per_sec']}); CUDA events: {len(events)} groups of "
          f"K={CLI_K}, {statistics.mean(group_ms):.3f} ms a group on the device "
          f"({statistics.mean(group_ms) / CLI_K:.3f} ms a step; min {min(group_ms):.3f}, "
          f"max {max(group_ms):.3f}), {rows / (sum(group_ms) / 1e3):.1f} examples/s over the "
          f"groups' device time, {rows / (first_to_last / 1e3):.1f} from the first group's "
          f"start to the last one's end ({first_to_last:.1f} ms); run_stream wall "
          f"{wall:.2f} s with model build and held-out evaluation; on {card}", flush=True)
    host = {k: v for k, v in timings.items() if k.endswith("_s")}
    print(f"stream CLI host seconds, 1 epoch: parser wait {host['parser_wait_s']:.3f}, "
          f"bucketing and pooling {host['batch_s']:.3f} (both inside waiting for the next "
          f"batch {host['input_s']:.3f}), packing into pinned memory {host['pack_s']:.3f}, "
          f"issuing the copies {host['copy_s']:.3f}, issuing the steps {host['step_s']:.3f}; "
          f"on {card}", flush=True)

    trace_dir = f"{cli['tmp']}/trace"
    run_stream(parse_args(argv + ["--profile-dir", trace_dir]))
    busy, span = device_busy_from_trace(f"{trace_dir}/trace.json")
    print(f"stream CLI under the profiler, 1 epoch: device busy {busy:.1f} ms of "
          f"{span:.1f} ms traced, idle share {1 - busy / span:.3f}; on {card}", flush=True)
    shutil.rmtree(cli["tmp"])


# ---------------------------------------------------------------------------
# The distributed slice: Trainer(mesh=...) over NCCL on the machine's cards,
# a rehearsal of four gloo ranks on one card, and the README's multi-chip
# command under torchrun
# ---------------------------------------------------------------------------

MESH_CAPACITY = 2.0  # the README's multi-chip command's --capacity-factor
GLOO_RANKS = 4
# steps of each configuration of the gloo rehearsal, held to the
# single-card step at the card-against-CPU tolerance (PARITY_*)
GLOO_STEPS = 2
# the README's multi-chip command on the synthetic stand-in: 16,000
# training rows at the CLI's batch of 256, 5 epochs: 310 steps
MULTICHIP_ROWS = 20_000
MULTICHIP_ARGV = ["--model", "deepfm", "--fused-embedding", "adagrad", "--explicit-lookup",
                  "--capacity-factor", "2.0", "--max-rows", str(MULTICHIP_ROWS)]


def mesh_configs() -> dict:
    """The gloo rehearsal's configurations: name -> (model builder, dense
    optimizer, fused optimizer or None, batch maker, Trainer mesh options,
    launches a rank per step). DeepFM at bench.py's width with an f32 tower
    (the bf16 tower's GEMMs round each rank's partial gradient sums, which a
    f32 tolerance would not hold); WideDeep and NFM at model_step.py's
    Criteo width; DIN at its width, at a capacity that drops nothing (two
    lookup sites: the JAX package splits their concatenation otherwise).
    NFM's parameters are held by ``ADAM_PARITY`` (see ``_held_to``)."""
    from recommender_system_tpu_torch import FusedAdagrad, FusedAdam, FusedSGD
    from recommender_system_tpu_torch.training import SGD, Adagrad, Adam

    bench = lambda: staged_batches(range(GLOO_STEPS), device="cpu")[1:]
    criteo = lambda: staged_batches(range(GLOO_STEPS), device="cpu", batch=CTR_BATCH)[1:]
    cols = lambda: staged_batches(range(1), device="cpu", batch=8)[0]
    explicit = dict(capacity_factor=MESH_CAPACITY, explicit_lookup=True)
    return {
        "deepfm_fused_explicit": (lambda: deepfm(cols(), None), lambda: Adagrad(LR),
                                  lambda: FusedAdagrad(LR), bench, explicit,
                                  {"fused_adagrad_apply": 1}),
        "deepfm_fused_full_capacity": (lambda: deepfm(cols(), None), lambda: Adagrad(LR),
                                       lambda: FusedAdagrad(LR), bench,
                                       dict(capacity_factor=MESH_CAPACITY),
                                       {"fused_adagrad_apply": 1}),
        "deepfm_plain": (lambda: deepfm(cols(), None), lambda: Adagrad(LR), None, bench, {},
                         {"scatter_add_sorted": 1}),
        "wide_deep_fused_sgd": (lambda: ctr_model("wide_deep", cols()), lambda: SGD(SGD_LR),
                                lambda: FusedSGD(SGD_LR), criteo, explicit,
                                {"fused_sgd_apply": 1}),
        "nfm_fused_adam": (lambda: ctr_model("nfm", cols()), lambda: Adam(ADAM_LR),
                           lambda: FusedAdam(ADAM_LR), criteo, explicit,
                           {"fused_adam_apply": 1}),
        "din_fused": (din_model, lambda: Adagrad(LR), lambda: FusedAdagrad(LR),
                      lambda: din_staged(range(GLOO_STEPS)), dict(
                          capacity_factor=float(GLOO_RANKS), explicit_lookup=True),
                      {"din_attention_fused": 1, "din_attention_backward": 1,
                       "fused_adagrad_apply": 1}),
    }


def _rank_batches(batches, labels, mesh):
    """This rank's rows of K stacked global batches, on its card."""
    b = labels.shape[1] // mesh.n
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return ({k: v[:, rows].to(mesh.device) for k, v in batches.items()},
            labels[:, rows].to(mesh.device))


def _whole_state(trainer) -> dict:
    """The trainer's parameters, buffers and optimizer states on the host,
    the sharded tables gathered whole (a collective under a mesh)."""
    def whole(name, t):
        if trainer.mesh is not None:
            t = trainer.whole(name, t.detach())
        return t.detach().to("cpu", copy=True)

    state = {n: whole(n, t) for n, t in trainer.model.state_dict().items()}
    state.update({f"opt:{k}:{n}": whole(n, t) for n, slots in trainer.opt_state.items()
                  for k, t in slots.items()})
    state.update({f"slot{i}:{n}": whole(n, t) for n, slots in trainer.fused_slots.items()
                  for i, t in enumerate(slots)})
    return state


def _gather_objects(obj, mesh) -> list:
    import torch.distributed as dist

    out = [None] * mesh.n
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def nccl_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """Phase 3o (a) on one rank of the NCCL group: DeepFM at bench.py's
    width (bf16 tower) through Trainer(mesh=...) with FusedAdagrad and the
    explicit lookup at the README's capacity factor: one K=8 call counted
    and gathered, one under set_sync_debug_mode("error"), one timed."""
    import torch.distributed as dist
    from recommender_system_tpu_torch import FusedAdagrad, Trainer
    from recommender_system_tpu_torch.parallel import make_mesh
    from recommender_system_tpu_torch.training import Adagrad

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(world)
        cols, batches, labels = staged_batches(range(K), device="cpu")
        batches, labels = _rank_batches(batches, labels, mesh)
        trainer = Trainer(deepfm(cols, torch.bfloat16, device=mesh.device), Adagrad(LR),
                          fused_embedding=FusedAdagrad(LR), mesh=mesh,
                          capacity_factor=MESH_CAPACITY, explicit_lookup=True)
        zero_counts()
        losses = trainer.multi_step(batches, labels)
        torch.cuda.synchronize()
        launches = read_counts()
        overflow = trainer.take_overflow()
        state = _whole_state(trainer)
        torch.cuda.set_sync_debug_mode("error")
        try:
            trainer.multi_step(batches, labels)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.multi_step(batches, labels)
        end.record()
        end.synchronize()
        per_rank = _gather_objects({"launches": launches,
                                    "step_ms": start.elapsed_time(end) / K}, mesh)
        if mesh.rank == 0:
            torch.save({"losses": losses.cpu(), "overflow": overflow, "state": state,
                        "ranks": per_rank}, os.path.join(out_dir, "nccl.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def gloo_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """Phase 3o (b) on one of four gloo ranks sharing card 0: each of
    ``mesh_configs`` for GLOO_STEPS steps in one multi_step call, its
    launches counted, its state gathered; rank 0 writes them."""
    import torch.distributed as dist
    from recommender_system_tpu_torch import Trainer
    from recommender_system_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        # gloo carries the card's tensors through host memory: the group is
        # passed, so the mesh takes it for the card
        mesh = make_mesh(world, group=dist.group.WORLD, device=torch.device("cuda", 0))
        for name, (model, optimizer, fused, data, mesh_kw, _) in mesh_configs().items():
            batches, labels = _rank_batches(*data(), mesh)
            trainer = Trainer(model(), optimizer(), fused_embedding=fused and fused(),
                              mesh=mesh, **mesh_kw)
            dist.barrier()
            zero_counts()
            t0 = time.perf_counter()
            losses = trainer.multi_step(batches, labels)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counts()
            overflow = trainer.take_overflow()
            state = _whole_state(trainer)
            per_rank = _gather_objects({"launches": launches, "seconds": seconds}, mesh)
            if mesh.rank == 0:
                torch.save({"losses": losses.cpu(), "overflow": overflow, "state": state,
                            "ranks": per_rank}, os.path.join(out_dir, f"{name}.pt"))
            del trainer, state
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn_ranks(fn, world: int, out_dir: str, timeout: float) -> None:
    """Run ``fn(rank, world, init_file, out_dir)`` in ``world`` spawned
    processes; any rank that fails or outlives ``timeout`` fails the phase
    (the rest are stopped)."""
    ctx = torch.multiprocessing.get_context("spawn")
    init_file = os.path.join(out_dir, f"{fn.__name__}.group")
    procs = [ctx.Process(target=fn, args=(r, world, init_file, out_dir)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        codes = [p.exitcode for p in procs]
        if any(code != 0 for code in codes):
            raise RuntimeError(f"{fn.__name__}: rank exit codes {codes} (None: still "
                               f"running after {timeout:.0f} s)")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)


# Adam moves a parameter by about lr a step whatever its gradient's size
# (at most 1.1 lr in the first two steps), so where f32 summation order
# flips the sign of a gradient that all but cancels, or a ReLU that sits at
# zero, two runs differ by up to 2.2 lr a step: NFM's parameters after
# GLOO_STEPS steps are held to that bound, its Adam moments and losses to
# PARITY, and the rows its lazy Adam moved must be the single card's.
ADAM_PARITY = 2.2 * ADAM_LR * GLOO_STEPS


def _held_to(name: str, got: dict, trainer, losses, card, start=None) -> float:
    """A mesh run's losses and whole state against the single-card
    trainer's after the same steps (PARITY tolerance); with ``start`` (the
    untrained model's state, for an Adam-trained model), its parameters
    within ``ADAM_PARITY`` and each table's moved rows equal to the single
    card's. Returns the largest difference; prints the elements past
    PARITY."""
    torch.testing.assert_close(got["losses"], losses.cpu(), rtol=PARITY_RTOL, atol=PARITY_ATOL,
                               msg=lambda m: f"{name} losses: {m}")
    want = _whole_state(trainer)
    if want.keys() != got["state"].keys():
        raise RuntimeError(f"{name}: the mesh state names {sorted(got['state'])}, "
                           f"the single card's {sorted(want)}")
    worst, past = 0.0, 0
    for key, value in want.items():
        adam_param = start is not None and key in start
        torch.testing.assert_close(got["state"][key], value, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL + (ADAM_PARITY if adam_param else 0.0),
                                   msg=lambda m, key=key: f"{name} {key}: {m}")
        if value.is_floating_point():
            worst = max(worst, (got["state"][key] - value).abs().max().item())
            past += int((~torch.isclose(got["state"][key], value, rtol=PARITY_RTOL,
                                        atol=PARITY_ATOL)).sum())
        if adam_param and key.rsplit(".", 1)[-1].startswith("table_d"):
            moved = [(t != start[key]).any(1) for t in (got["state"][key], value)]
            if not torch.equal(*moved):
                raise RuntimeError(f"{name} {key}: the mesh moved {int(moved[0].sum())} rows, "
                                   f"the single card {int(moved[1].sum())}, not the same ones")
    if past:
        print(f"{name}: {past} elements past PARITY, within {ADAM_PARITY:.1e} (Adam)",
              flush=True)
    return worst


def mesh_path(card) -> dict:
    """Phase 3o: (a) NCCL over the machine's cards, (b) four gloo ranks
    sharing card 0, (c) the README's multi-chip command under torchrun.
    Returns each run's launches per rank and its times."""
    from recommender_system_tpu_torch import FusedAdagrad, Trainer
    from recommender_system_tpu_torch.training import Adagrad, Adam

    t0 = time.perf_counter()
    out = {"launches": {}, "times": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    world = torch.cuda.device_count()

    # (a) NCCL, one rank a card, against the single card from the same start
    _spawn_ranks(nccl_rank, world, tmp, timeout=300)
    got = torch.load(os.path.join(tmp, "nccl.pt"), weights_only=False)
    cols, batches, labels = staged_batches(range(K))
    single = Trainer(deepfm(cols, torch.bfloat16), Adagrad(LR), fused_embedding=FusedAdagrad(LR))
    losses = single.multi_step(batches, labels)
    worst = _held_to("NCCL DeepFM", got, single, losses, card)
    table = "unified.embeddings.table_d9"
    bitwise = all(torch.equal(got["state"][k], v) for k, v in _whole_state(single).items())
    ranks = got["ranks"]
    want = launches_want(fused_adagrad_apply=K)
    if any(r["launches"] != want for r in ranks) or got["overflow"] != 0:
        raise RuntimeError(f"NCCL mesh: launches {[r['launches'] for r in ranks]} and "
                           f"overflow {got['overflow']}, want {want} a rank and 0")
    out["launches"]["nccl_deepfm"] = [r["launches"] for r in ranks]
    out["times"]["nccl_deepfm_step_ms"] = [r["step_ms"] for r in ranks]
    print(f"phase 3o (a): DeepFM at bench.py's width on {world} NCCL rank(s), "
          f"{got['state'][table].shape[0]} rows of {table} over them, FusedAdagrad, explicit "
          f"lookup at capacity factor {MESH_CAPACITY}: one K={K} call equals the single card's "
          f"(losses {[round(float(x), 5) for x in got['losses']]}; largest difference "
          f"{worst:.3e}, bitwise equal: {bitwise}), overflow {got['overflow']}; launches a "
          f"rank {[r['launches']['fused_adagrad_apply'] for r in ranks]} fused_adagrad_apply; "
          f"a call under set_sync_debug_mode('error'); {[round(r['step_ms'], 3) for r in ranks]}"
          f" ms a step (CUDA events, a K={K} call); on {card}", flush=True)
    del single

    # (b) four gloo ranks sharing card 0: a rehearsal of the routing and of
    # the per-shard launches, whose times are no speed figure
    _spawn_ranks(gloo_rank, GLOO_RANKS, tmp, timeout=600)
    for name, (model, optimizer, fused, data, _, per_step) in mesh_configs().items():
        got = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
        batches, labels = data()
        batches, labels = {k: v.to("cuda") for k, v in batches.items()}, labels.to("cuda")
        m = model()
        start = ({n: t.detach().to("cpu", copy=True) for n, t in m.named_parameters()}
                 if isinstance(optimizer(), Adam) else None)
        single = Trainer(m, optimizer(), fused_embedding=fused and fused())
        losses = single.multi_step(batches, labels)
        worst = _held_to(f"gloo {name}", got, single, losses, card, start)
        want = launches_want(**{k: v * GLOO_STEPS for k, v in per_step.items()})
        ranks = got["ranks"]
        if any(r["launches"] != want for r in ranks) or got["overflow"] != 0:
            raise RuntimeError(f"gloo {name}: launches {[r['launches'] for r in ranks]}, "
                               f"overflow {got['overflow']}; want {want} a rank and 0")
        out["launches"][f"gloo_{name}"] = [r["launches"] for r in ranks]
        out["times"][f"gloo_{name}_s"] = [r["seconds"] for r in ranks]
        print(f"phase 3o (b): {name} on {GLOO_RANKS} gloo ranks sharing one card: "
              f"{GLOO_STEPS} steps equal the single card's (largest difference {worst:.3e}), "
              f"overflow 0, launches a rank {want}; rehearsal, no speed figure: "
              f"{max(r['seconds'] for r in ranks):.3f} s for the call; on {card}", flush=True)
        del single

    # (c) the README's multi-chip command under torchrun, one rank a card
    out["multichip"] = multichip_cli(tmp, world, card)
    shutil.rmtree(tmp)
    print(f"phase 3o took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def multichip_cli(tmp: str, world: int, card) -> dict:
    """Phase 3o (c): ``python -m torch.distributed.run --nproc-per-node N
    -m recommender_system_tpu_torch.train --mesh-data N`` with the README's
    flags on the synthetic stand-in; its exit code, its JSON line, and its
    checkpoint, which one card restores and which scores the held-out rows
    as the mesh did."""
    from recommender_system_tpu_torch import train
    from recommender_system_tpu_torch.training.checkpoint import (latest_step,
                                                                  restore_checkpoint)

    ckpt = os.path.join(tmp, "multichip_ckpt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(world), "-m", "recommender_system_tpu_torch.train", "--mesh-data", str(world),
           *MULTICHIP_ARGV, "--checkpoint-dir", ckpt]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"the multi-chip command exited {run.returncode}:\n"
                           f"{run.stderr[-4000:]}")
    lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
    if len(lines) != 1:
        raise RuntimeError(f"the multi-chip command printed {len(lines)} result lines:\n"
                           f"{run.stdout[-2000:]}")
    result = json.loads(lines[0])
    config = train.parse_args(MULTICHIP_ARGV)
    train_rows = MULTICHIP_ROWS - MULTICHIP_ROWS // 5
    steps = config.epochs * (train_rows // config.batch_size)
    if (len(result["train_loss"]) != config.epochs or not np.isfinite(result["train_loss"]).all()
            or latest_step(ckpt) != steps):
        raise RuntimeError(f"the multi-chip command: {result}, checkpoint at step "
                           f"{latest_step(ckpt)}, want {config.epochs} epochs and step {steps}")
    columns, _, _, X_test, y_test = train.build_data(config)
    single = train.build_trainer(config, columns)
    restore_checkpoint(ckpt, single)
    metrics = single.evaluate(X_test, y_test)
    for key in ("auc", "logloss"):
        # the CLI prints them rounded to 4 places
        if abs(metrics[key] - result[key]) > 5.1e-5:
            raise RuntimeError(f"the restored checkpoint scores {key} {metrics[key]}, the "
                               f"multi-chip run {result[key]}")
    print(f"phase 3o (c): {' '.join(cmd[1:])} exited 0 in {seconds:.1f} s: {result}; its "
          f"step-{steps} checkpoint restored on one card scores AUC {metrics['auc']:.6f}, "
          f"logloss {metrics['logloss']:.6f} (the run's, to its 4 places); on {card}",
          flush=True)
    return {"result": result, "seconds": seconds, "steps": steps}


# ---------------------------------------------------------------------------
# The model axis: a 2 x 2 mesh of four gloo ranks on one card (FFM's
# column-sharded table_d156, MMOE's experts split), --mesh-model under
# torchrun, and the classics at MovieLens-100k's shape
# ---------------------------------------------------------------------------

GRID = (2, 2)
GRID_STEPS = 2
# the grid CLI: MMOE at embedding dim 64 (a column-sharded table_d64 of 26
# fields of 1,000 ids, its 4 experts 2 a model rank), the plain step
GRID_CLI_ROWS = 10_000
GRID_CLI_ARGV = ["--model", "mmoe", "--embedding-dim", "64", "--optimizer", "adagrad",
                 "--learning-rate", "0.05", "--dataset", "synthetic", "--max-rows",
                 str(GRID_CLI_ROWS), "--epochs", "2", "--batch-size", "1024"]
# MovieLens-100k's shape (u.data is not in the repo): 943 users, 1,682
# items, 100,000 ratings of 1-5, drawn from a seed
ML_USERS, ML_ITEMS, ML_RATINGS = 943, 1682, 100_000
# the classics on the card against the CPU: f32 sums in another order over
# chained steps (LR, MF); float64 similarities and scores (CF)
CLASSIC_RTOL, CLASSIC_ATOL = 1e-4, 1e-6
CF_TOL = 1e-12


def grid_configs() -> dict:
    """The grid's configurations at model_step.py's Criteo width: name ->
    (model builder over the columns, dense optimizer, fused optimizer or
    None, two-task labels, launches a rank per step). FFM with the plain
    Adagrad step: table_d156 column-sharded (rows over 'data', 78 columns
    a model rank), table_d1 row-sharded, one scatter-add each a step. MMOE
    with FusedAdagrad: table_d8 row-sharded (the fused step), the experts
    [221, 64, 4] split 2 a model rank, one fused update a step."""
    from recommender_system_tpu_torch import FusedAdagrad
    from recommender_system_tpu_torch.training import Adagrad

    return {
        "ffm_plain": (lambda cols: ctr_model("ffm", cols), lambda: Adagrad(LR), None, False,
                      {"scatter_add_sorted": 2}),
        "mmoe_fused": (mmoe_model, lambda: Adagrad(LR), lambda: FusedAdagrad(LR), True,
                       {"fused_adagrad_apply": 1}),
    }


def _two_tasks(labels: torch.Tensor) -> torch.Tensor:
    """model_step.py:74's MMOE labels ``[y, y[::-1]]`` of ``[K, B]`` labels."""
    return torch.stack([labels, labels.flip(-1)], dim=-1)


def _rows_state(trainer, rows: torch.Tensor, start: dict) -> dict:
    """A grid trainer's state (a collective): each sharded table's and its
    optimizer states' values at the global ``rows`` (sorted, on the card),
    gathered; every other parameter whole; and whether every row outside
    ``rows`` of every shard is bitwise as ``start`` kept it."""
    mesh = trainer.mesh
    state, unchanged = {}, True
    tensors = {n: [("", p)] for n, p in trainer.model.named_parameters()}
    for n, slots in trainer.opt_state.items():
        tensors[n] += [(f"opt:{k}:", t) for k, t in slots.items()]
    for name, parts in tensors.items():
        placement = trainer.sharded.get(name)
        for prefix, t in parts:
            t = t.detach()
            if placement is None:
                state[prefix + name] = t.to("cpu", copy=True)
                continue
            per = t.shape[0]
            lo = (mesh.data_index if placement.kind == "columns" else mesh.rank) * per
            mine = (rows >= lo) & (rows < lo + per)
            touched = torch.zeros(per, dtype=torch.bool, device=t.device)
            touched[rows[mine] - lo] = True
            unchanged &= bool(torch.equal(t[~touched], start[prefix + name][~touched]))
            part = torch.zeros(rows.shape[0], t.shape[1], dtype=t.dtype, device=t.device)
            part[mine] = t[rows[mine] - lo]
            if placement.kind == "columns":
                part = mesh.data_axis.all_reduce_(mesh.model_axis.all_gather(part, dim=1))
            else:
                part = mesh.all_reduce_(part)
            state[prefix + name] = part[:, :placement.shape[1]].cpu()
    flag = torch.tensor([int(unchanged)], device=mesh.device)
    state["untouched_rows_unchanged"] = bool(mesh.all_reduce_(flag).item() == mesh.n)
    return state


def grid_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """Phase 3p (a) on one of four gloo ranks sharing card 0, laid out as a
    2 x 2 mesh: each of ``grid_configs`` for GRID_STEPS steps in one
    multi_step call, its launches counted; FFM's tables compared at the
    rows the steps touched (the rest checked unchanged on each rank),
    MMOE's state gathered whole; rank 0 writes them."""
    import torch.distributed as dist
    from recommender_system_tpu_torch import Trainer
    from recommender_system_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(*GRID, group=dist.group.WORLD, device=torch.device("cuda", 0))
        cols, batches, labels = staged_batches(range(GRID_STEPS), device="cpu", batch=CTR_BATCH)
        rows = torch.nonzero(touched_rows({k: v.to("cuda") for k, v in batches.items()},
                                          FIELDS * VOCAB)).reshape(-1)
        for name, (model, optimizer, fused, tasks, _) in grid_configs().items():
            mine, ys = _rank_batches(batches, _two_tasks(labels) if tasks else labels, mesh)
            trainer = Trainer(model(cols), optimizer(), fused_embedding=fused and fused(),
                              mesh=mesh)
            start = {}
            if fused is None:
                for n in trainer.sharded:
                    start[n] = trainer.model.get_parameter(n).detach().clone()
                    start.update({f"opt:{k}:{n}": t.clone()
                                  for k, t in trainer.opt_state[n].items()})
            dist.barrier()
            zero_counts()
            t0 = time.perf_counter()
            losses = trainer.multi_step(mine, ys)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counts()
            overflow = trainer.take_overflow()
            state = _rows_state(trainer, rows, start) if fused is None else _whole_state(trainer)
            shards = {n: (p.kind, tuple(trainer.model.get_parameter(n).shape))
                      for n, p in trainer.sharded.items()}
            per_rank = _gather_objects({"launches": launches, "seconds": seconds,
                                        "shards": shards}, mesh)
            if mesh.rank == 0:
                torch.save({"losses": losses.cpu(), "overflow": overflow, "state": state,
                            "rows": rows.cpu(), "ranks": per_rank},
                           os.path.join(out_dir, f"grid_{name}.pt"))
            del trainer, state, start
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _held_at_rows(name: str, got: dict, trainer, losses, card) -> float:
    """A grid run's FFM state against the single card's at the touched rows
    (tables and accumulators) and whole elsewhere, at PARITY; returns the
    largest difference."""
    torch.testing.assert_close(got["losses"], losses.cpu(), rtol=PARITY_RTOL, atol=PARITY_ATOL,
                               msg=lambda m: f"{name} losses: {m}")
    if not got["state"].pop("untouched_rows_unchanged"):
        raise RuntimeError(f"{name}: a row no step touched moved on the grid")
    rows = got["rows"].to("cuda")
    want = {n: p.detach() for n, p in trainer.model.named_parameters()}
    want.update({f"opt:{k}:{n}": t for n, slots in trainer.opt_state.items()
                 for k, t in slots.items()})
    if want.keys() != got["state"].keys():
        raise RuntimeError(f"{name}: the grid state names {sorted(got['state'])}, the single "
                           f"card's {sorted(want)}")
    worst = 0.0
    for key, value in want.items():
        if key.rsplit(".", 1)[-1].startswith("table_d"):
            value = value[rows]
        value = value.cpu()
        torch.testing.assert_close(got["state"][key], value, rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   msg=lambda m, key=key: f"{name} {key}: {m}")
        worst = max(worst, (got["state"][key] - value).abs().max().item())
    return worst


def grid_path(card) -> dict:
    """Phase 3p: (a) the 2 x 2 grid of four gloo ranks on card 0 against
    the single card, (b) ``--mesh-data 2 --mesh-model 2`` under torchrun on
    gloo, its checkpoint restored on one card, (c) the classics on the card
    against the CPU. Returns each grid run's launches per rank and times."""
    from recommender_system_tpu_torch import Trainer

    t0 = time.perf_counter()
    out = {"launches": {}, "times": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_grid_")
    _spawn_ranks(grid_rank, GRID[0] * GRID[1], tmp, timeout=400)
    cols, batches, labels = staged_batches(range(GRID_STEPS), batch=CTR_BATCH)
    for name, (model, optimizer, fused, tasks, per_step) in grid_configs().items():
        got = torch.load(os.path.join(tmp, f"grid_{name}.pt"), weights_only=False)
        single = Trainer(model(cols), optimizer(), fused_embedding=fused and fused())
        losses = single.multi_step(batches, _two_tasks(labels) if tasks else labels)
        if fused is None:
            worst = _held_at_rows(f"grid {name}", got, single, losses, card)
        else:
            worst = _held_to(f"grid {name}", got, single, losses, card)
        want = launches_want(**{k: v * GRID_STEPS for k, v in per_step.items()})
        ranks = got["ranks"]
        if any(r["launches"] != want for r in ranks) or got["overflow"] != 0:
            raise RuntimeError(f"grid {name}: launches {[r['launches'] for r in ranks]}, "
                               f"overflow {got['overflow']}; want {want} a rank and 0")
        shards = ranks[0]["shards"]
        # FFM's 2,600,000 rows in 5,079 wide rows of 512: half a data index
        half = -(-FIELDS * VOCAB // 512) * 512 // GRID[0]
        if name == "ffm_plain" and (
                shards["field_embeddings.table_d156"] != ("columns", (half, 78))
                or shards["linear.linear_tables.table_d1"][0] != "rows"):
            raise RuntimeError(f"grid {name}: placements {shards}")
        if name == "mmoe_fused" and (shards["mmoe.experts"] != ("experts", (221, 64, 2))
                                     or shards["embeddings.table_d8"][0] != "rows"):
            raise RuntimeError(f"grid {name}: placements {shards}")
        out["launches"][f"grid_{name}"] = [r["launches"] for r in ranks]
        out["times"][f"grid_{name}_s"] = [r["seconds"] for r in ranks]
        at_rows = (f"; the tables at the {got['rows'].shape[0]} touched rows, the rest "
                   f"unchanged" if fused is None else "")
        print(f"phase 3p (a): {name} on a 2 x 2 grid of gloo ranks sharing one card "
              f"(placements {shards}): {GRID_STEPS} steps at batch {CTR_BATCH} equal the "
              f"single card's (largest difference {worst:.3e}{at_rows}), overflow 0, "
              f"launches a rank {[{k: v for k, v in r['launches'].items() if v} for r in ranks]}"
              f"; rehearsal, no speed figure: {max(r['seconds'] for r in ranks):.3f} s for "
              f"the call; on {card}", flush=True)
        del single
    out["cli"] = grid_cli(tmp, card)
    out["classics"] = classics_path(card)
    shutil.rmtree(tmp)
    print(f"phase 3p took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def grid_cli(tmp: str, card) -> dict:
    """Phase 3p (b): ``torchrun --nproc-per-node 4 -m
    recommender_system_tpu_torch.train --mesh-data 2 --mesh-model 2
    --device cpu`` (gloo: NCCL takes one rank a card) with MMOE at
    embedding dim 64; its checkpoint restored on one card scores the
    held-out rows as the grid did."""
    from recommender_system_tpu_torch import train
    from recommender_system_tpu_torch.training.checkpoint import (latest_step,
                                                                  restore_checkpoint)

    ckpt = os.path.join(tmp, "grid_ckpt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "recommender_system_tpu_torch.train", *GRID_CLI_ARGV, "--device", "cpu",
           "--mesh-data", "2", "--mesh-model", "2", "--checkpoint-dir", ckpt]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"the grid command exited {run.returncode}:\n{run.stderr[-4000:]}")
    lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
    if len(lines) != 1:
        raise RuntimeError(f"the grid command printed {len(lines)} result lines:\n"
                           f"{run.stdout[-2000:]}")
    result = json.loads(lines[0])
    config = train.parse_args(GRID_CLI_ARGV)
    steps = config.epochs * ((GRID_CLI_ROWS - GRID_CLI_ROWS // 5) // config.batch_size)
    if (len(result["train_loss"]) != config.epochs or not np.isfinite(result["train_loss"]).all()
            or latest_step(ckpt) != steps):
        raise RuntimeError(f"the grid command: {result}, checkpoint at step "
                           f"{latest_step(ckpt)}, want {config.epochs} epochs and step {steps}")
    columns, _, _, X_test, y_test = train.build_data(config)
    single = train.build_trainer(config, columns)
    restore_checkpoint(ckpt, single)
    if single.model.embeddings.table_d64.device.type != "cuda":
        raise RuntimeError("the grid checkpoint did not come back on the card")
    metrics = single.evaluate(X_test, y_test)
    for key in ("task0_auc", "task0_logloss", "task1_auc", "task1_logloss"):
        # the CLI prints them rounded to 4 places; the card sums in another order
        if abs(metrics[key] - result[key]) > 2e-4:
            raise RuntimeError(f"the restored grid checkpoint scores {key} {metrics[key]} on "
                               f"the card, the grid run {result[key]}")
    print(f"phase 3p (b): {' '.join(cmd[1:])} exited 0 in {seconds:.1f} s: {result}; its "
          f"step-{steps} checkpoint restored on one card scores task0 AUC "
          f"{metrics['task0_auc']:.6f}, task1 AUC {metrics['task1_auc']:.6f} (the run's, to "
          f"2e-4); on {card}", flush=True)
    return {"result": result, "seconds": seconds, "steps": steps}


def movielens_like(seed: int = 0) -> np.ndarray:
    """A [943, 1682] rating matrix with 100,000 ratings of 1-5, every user
    with at least 20 (as in MovieLens-100k), users' counts and items drawn
    with a long tail."""
    rng = np.random.default_rng(seed)
    user_p = rng.pareto(1.5, ML_USERS) + 1
    item_p = rng.pareto(1.2, ML_ITEMS) + 1
    counts = 20 + rng.multinomial(ML_RATINGS - 20 * ML_USERS, user_p / user_p.sum())
    counts = np.minimum(counts, ML_ITEMS // 2)
    for u in np.argsort(-user_p):  # what the cap cut goes to the next users
        counts[u] += min(ML_ITEMS // 2 - counts[u], ML_RATINGS - counts.sum())
    r = np.zeros((ML_USERS, ML_ITEMS))
    for u, n in enumerate(counts):
        items = rng.choice(ML_ITEMS, n, replace=False, p=item_p / item_p.sum())
        r[u, items] = rng.integers(1, 6, n)
    return r


def _same_ranking(name: str, got: list, want: list, tol: float) -> None:
    """Two rankings: the same scores position by position within ``tol``
    (relative), and the same names wherever the scores around a position
    are further apart than ``tol``."""
    gs = np.asarray([s for _, s in got])
    np.testing.assert_allclose(gs, [s for _, s in want], rtol=tol, atol=tol, err_msg=name)
    for i, ((g, s), (w, _)) in enumerate(zip(got, want)):
        near = [abs(s - o) <= tol * max(1.0, abs(s)) for o in gs[max(i - 1, 0):i + 2]]
        if g != w and sum(near) < 2:
            raise RuntimeError(f"{name}: position {i} is {g} on the card, {w} on the CPU")


def classics_path(card) -> dict:
    """Phase 3p (c): LR, ItemCF / UserCF and MF at MovieLens-100k's shape,
    each on the card (the default device) against its CPU run; no kernel
    on these paths."""
    from recommender_system_tpu_torch.models import cf, lr, mf

    r = movielens_like()
    users = [f"u{i}" for i in range(ML_USERS)]
    items = [f"i{j}" for j in range(ML_ITEMS)]
    times = {}
    zero_counts()
    # LR: does a rating reach 4, from the user's and the item's mean rating
    u_idx, i_idx = np.nonzero(r)
    means_u = r.sum(1) / np.maximum((r > 0).sum(1), 1)
    means_i = r.sum(0) / np.maximum((r > 0).sum(0), 1)
    X = np.stack([means_u[u_idx], means_i[i_idx]], 1).astype(np.float32)
    X = (X - X.mean(0)) / X.std(0)
    y = (r[u_idx, i_idx] >= 4).astype(np.float32)
    kw = dict(batch_size=256, lr=0.1, stop_type=lr.STOP_ITER, thresh=200, seed=0)
    t0 = time.perf_counter()
    theta, costs = lr.fit_logistic_regression(X, y, **kw)
    times["lr_s"] = time.perf_counter() - t0
    c_theta, c_costs = lr.fit_logistic_regression(X, y, device="cpu", **kw)
    np.testing.assert_allclose(costs, c_costs, rtol=CLASSIC_RTOL, atol=CLASSIC_ATOL)
    np.testing.assert_allclose(theta, c_theta, rtol=CLASSIC_RTOL, atol=CLASSIC_ATOL)
    acc = float(((lr.predict_proba(theta, X) >= 0.5) == (y > 0.5)).mean())
    # CF: the similarity matrices and ten users' recommendations
    t0 = time.perf_counter()
    item_cf = {t: cf.ItemCF(users, items, r, t) for t in ("euc", "pea")}
    user_cf = {t: cf.UserCF(users, items, r, t) for t in ("euc", "pea")}
    recs = {(t, u): (item_cf[t].recommend(u, 10), user_cf[t].recommend(u, 20, 10))
            for t in ("euc", "pea") for u in users[:10]}
    times["cf_s"] = time.perf_counter() - t0
    for t in ("euc", "pea"):
        c_item = cf.ItemCF(users, items, r, t, device="cpu")
        c_user = cf.UserCF(users, items, r, t, device="cpu")
        for got, want in ((item_cf[t].item_sim, c_item.item_sim),
                          (user_cf[t].user_sim, c_user.user_sim)):
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=CF_TOL,
                                       atol=CF_TOL)
        for u in users[:10]:
            _same_ranking(f"ItemCF {t} {u}", recs[t, u][0], c_item.recommend(u, 10), CF_TOL)
            _same_ranking(f"UserCF {t} {u}", recs[t, u][1], c_user.recommend(u, 20, 10), CF_TOL)
    # MF: 200 steps at latent dim 10
    kw = dict(latent_dim=10, steps=200, lr=2e-4, beta=0.02, seed=0)
    t0 = time.perf_counter()
    p, q, losses = mf.matrix_factorization(r, **kw)
    times["mf_s"] = time.perf_counter() - t0
    c_p, c_q, c_losses = mf.matrix_factorization(r, device="cpu", **kw)
    if len(losses) != len(c_losses):
        raise RuntimeError(f"MF stopped after {len(losses)} steps on the card, "
                           f"{len(c_losses)} on the CPU")
    for got, want in ((losses, c_losses), (p, c_p), (q, c_q)):
        np.testing.assert_allclose(got, want, rtol=CLASSIC_RTOL, atol=CLASSIC_ATOL)
    for u in range(10):
        _same_ranking(f"MF {u}", mf.recommend(u, p, q, r[u] > 0, items, 10),
                      mf.recommend(u, c_p, c_q, r[u] > 0, items, 10, device="cpu"),
                      CLASSIC_RTOL)
    if read_counts() != launches_want():
        raise RuntimeError(f"the classics launched {read_counts()}; their paths have none")
    if not losses[-1] < losses[0] or not costs[-1] < costs[0]:
        raise RuntimeError(f"the classics did not learn: LR {costs[0]} -> {costs[-1]}, "
                           f"MF {losses[0]} -> {losses[-1]}")
    print(f"phase 3p (c): the classics at MovieLens-100k's shape ({ML_USERS} users, "
          f"{ML_ITEMS} items, {int((r > 0).sum())} ratings) on the card equal their CPU "
          f"runs: LR 200 steps (cost {costs[0]:.5f} -> {costs[-1]:.5f}, accuracy {acc:.4f}), "
          f"ItemCF and UserCF (euc, pea) similarities to {CF_TOL} and 10 users' top-10, MF "
          f"200 steps at k=10 (loss {losses[0]:.1f} -> {losses[-1]:.1f}); host seconds on "
          f"the card {times}; no kernel launch; on {card}", flush=True)
    return times


# ---------------------------------------------------------------------------
# Phase 3q: each single-card training path's K-step call as a CUDA graph
# against the same steps one by one
# ---------------------------------------------------------------------------

GRAPH_CALLS = 3


def trainer_state(trainer) -> dict:
    """Everything a step changes, by name, as it lies: parameters and
    buffers (BatchNorm's statistics), the dense optimizer's state, the
    fused slots, the step count and the dropout generator's state."""
    out = {f"model:{n}": t for n, t in trainer.model.state_dict().items()}
    out.update({f"opt:{key}:{n}": t for n, slots in trainer.opt_state.items()
                for key, t in slots.items()})
    out.update({f"slot{i}:{n}": t for n, slots in trainer.fused_slots.items()
                for i, t in enumerate(slots)})
    out["step"] = torch.tensor(trainer.step)
    out["generator"] = trainer.generator.get_state()
    out.update({f"step_generator{i}": g.get_state()
                for i, g in enumerate(trainer.step_generators)})
    return out


class DssmSampledLoss:
    """DSSM's sampled softmax over the batch's item vectors: 255 negatives a
    step drawn from the loss's own CUDA generator, which the Trainer takes
    as a step generator: uniformly, or by frequency where ``item_probs``
    (numpy, one a row of the batch, as a JAX user passes them) is given. An
    object, so that a copy of the Trainer copies the generator it registers
    and the one the loss draws from as one."""

    def __init__(self, seed: int = 7, item_probs=None):
        from recommender_system_tpu_torch.training.losses import NegativeSampler

        self.generator = torch.Generator(device="cuda").manual_seed(seed)
        self.sampler = (NegativeSampler("uniform", num_sampled=255) if item_probs is None
                        else NegativeSampler("frequency", num_sampled=255,
                                             item_probs=item_probs))

    def __call__(self, outputs, labels, batch):
        from recommender_system_tpu_torch.training.losses import sampled_softmax_loss

        user, item = outputs
        rows = torch.arange(user.shape[0], device=user.device)
        return sampled_softmax_loss(user, item, rows, self.sampler, self.generator,
                                    temperature=0.05)


def graph_against_loop(name, trainer, batches, labels, card) -> dict:
    """Phase 3q for one path: two copies of ``trainer``'s state; one trains
    GRAPH_CALLS calls of ``multi_step`` (the steps one by one, then a
    capture and its replay, then replays, the last under
    ``set_sync_debug_mode("error")``), the other as many calls of
    ``make_multi_step(graphed=False)``. Their losses and every tensor of
    ``trainer_state`` must be equal bitwise, or, where not, within
    PARITY_RTOL and PARITY_ATOL with the largest difference printed (the
    step and the generators exactly); their launches must be equal. Where
    they differ, a second looped copy tells whether the steps one by one
    differ from themselves as well (atomics in a backward), which is then
    the cause. Returns the graphed copy's launches and the largest
    difference."""
    trainer.drop_graphs()
    runs = {}
    t0 = time.perf_counter()
    for form in ("graphed", "looped", "looped again"):
        if form == "looped again" and all(
                torch.equal(a, b) for a, b in zip(runs["graphed"][1].values(),
                                                  runs["looped"][1].values())):
            break
        t = copy.deepcopy(trainer)
        run = t.multi_step if form == "graphed" else t.make_multi_step(graphed=False)
        zero_counts()
        losses = []
        for call in range(GRAPH_CALLS):
            if call == GRAPH_CALLS - 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                losses.append(run(batches, labels))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        runs[form] = (read_counts(), {"losses": torch.stack(losses), **trainer_state(t)})
    (launches, got), (looped_launches, want) = runs["graphed"], runs["looped"]
    if launches != looped_launches:
        raise RuntimeError(f"graph {name}: the graphed calls launched {launches}, the "
                           f"looped ones {looped_launches}")
    unequal = {key: (got[key].double() - want[key].double()).abs().max().item()
               for key in want if not torch.equal(got[key], want[key])}
    for key in unequal:
        if key == "step" or "generator" in key:
            raise RuntimeError(f"graph {name}: {key} differs: {got[key]} against {want[key]}")
        torch.testing.assert_close(got[key], want[key], rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   msg=lambda m, key=key: f"graph {name}, {key}: {m}")
    worst = max(unequal.values(), default=0.0)
    verdict = "bitwise equal"
    if unequal:
        again = runs["looped again"][1]
        itself = sorted(key for key in want if not torch.equal(again[key], want[key]))
        cause = (f"the steps one by one differ from themselves too, in {itself[:6]}: "
                 "the order of a backward's atomic adds" if itself else
                 "two looped runs agree bitwise, so the graph itself")
        verdict = (f"{len(unequal)} of {len(want)} differ, within rtol={PARITY_RTOL}, "
                   f"atol={PARITY_ATOL}; largest difference {worst:.3e} in "
                   f"{max(unequal, key=unequal.get)}; differing: {sorted(unequal)[:6]}; "
                   f"cause: {cause}")
    print(f"graph {name}: {GRAPH_CALLS} graphed calls against {GRAPH_CALLS} looped calls "
          f"of K={labels.shape[0]} from one state: losses, {len(want) - 1} tensors (parameters, "
          f"buffers, optimizer states, step, generator) {verdict}; launches {launches} "
          f"both; the last graph replay under set_sync_debug_mode('error'); "
          f"{time.perf_counter() - t0:.1f} s; on {card}", flush=True)
    return {"launches": launches, "worst": worst, "unequal": len(unequal)}


class _CollectInCapture:
    """A loss that, once a capture has begun, makes the collector run at
    nearly every allocation (restored by ``graph_beside_garbage``)."""

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn

    def __call__(self, outputs, labels, batch):
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1, 1, 1)
        return self.loss_fn(outputs, labels, batch)


def graph_beside_garbage(name, trainer, batches, labels, card) -> None:
    """Phase 3q: a capture while an earlier copy's graph is garbage in a
    reference cycle (its cached K-step callable closes over the Trainer),
    the collector made to run at nearly every allocation once the capture
    has begun. Destroying a graph during a capture invalidates it, so this
    passes only where ``Trainer`` collects before and holds the collector
    through the capture."""
    old = copy.deepcopy(trainer)
    old.drop_graphs()
    for _ in range(2):  # the steps one by one, then a capture
        old.multi_step(batches, labels)
    new = copy.deepcopy(trainer)
    new.drop_graphs()
    new.loss_fn = _CollectInCapture(new.loss_fn)
    new.multi_step(batches, labels)
    del old
    thresholds = gc.get_threshold()
    try:
        new.multi_step(batches, labels)  # the capture, then its replay
        losses = new.multi_step(batches, labels)
    finally:
        gc.set_threshold(*thresholds)
    if not torch.isfinite(losses).all():
        raise RuntimeError(f"graph {name} beside a garbage graph: losses {losses}")
    print(f"graph {name}: captured and replayed while another copy's graph was garbage "
          f"in a reference cycle, the collector at every allocation during the capture; "
          f"on {card}", flush=True)


def graph_path(card, trained: dict) -> dict:
    """Phase 3q: ``graph_against_loop`` on every single-card training path
    that the earlier phases drive, at their widths and on their batches:
    ``trained``'s trainers (name -> Trainer) where it has them, new ones
    built as those phases build them for the rest; on DeepFM fused also
    ``graph_beside_garbage``. Returns each path's result."""
    from recommender_system_tpu_torch import FusedAdagrad, FusedAdam, FusedSGD, Trainer
    from recommender_system_tpu_torch.training import SGD, Adagrad, Adam

    t0 = time.perf_counter()
    cols, batches, labels = staged_batches(range(K))
    ctr_cols, ctr_batches, ctr_labels = staged_batches(range(K), batch=CTR_BATCH)
    din = din_staged(range(K))
    dien = din_staged(range(K), negatives=True)

    def fused(model, loss_fn=None, **kw):
        return Trainer(model, Adagrad(LR), fused_embedding=FusedAdagrad(LR),
                       **({"loss_fn": loss_fn} if loss_fn else {}), **kw)

    def dropout_deepfm():
        from recommender_system_tpu_torch import DeepFM

        return fused(DeepFM(tuple(cols), hidden_units=(256, 128, 64),
                            dnn_dtype=torch.bfloat16, dropout_rate=0.1, device="cuda",
                            generator=torch.Generator().manual_seed(0)))

    def sampled_dssm(item_probs=None):
        loss = DssmSampledLoss(item_probs=item_probs)
        return fused(dssm_model(), loss, step_generators=(loss.generator,))

    zipf = np.random.default_rng(3).zipf(1.5, DIN_BATCH).astype(np.float64)

    paths = {
        "DeepFM fused": (lambda: fused(deepfm(cols, torch.bfloat16)), batches, labels),
        "DeepFM plain": (lambda: Trainer(deepfm(cols, torch.bfloat16), Adagrad(LR)),
                         batches, labels),
        "WideDeep": (lambda: Trainer(ctr_model("wide_deep", ctr_cols), SGD(SGD_LR),
                                     fused_embedding=FusedSGD(SGD_LR)), ctr_batches, ctr_labels),
        "NFM": (lambda: Trainer(ctr_model("nfm", ctr_cols), Adam(ADAM_LR),
                                fused_embedding=FusedAdam(ADAM_LR)), ctr_batches, ctr_labels),
        **{label: (lambda name=name: fused(ctr_model(name, ctr_cols)), ctr_batches, ctr_labels)
           for name, label in (("dcn", "DCN"), ("ffm", "FFM"), ("pnn", "PNN"), ("afm", "AFM"),
                               ("deep_crossing", "DeepCrossing"))},
        "MMOE": (lambda: fused(mmoe_model(ctr_cols)), ctr_batches, _two_tasks(ctr_labels)),
        "DIN fused": (lambda: fused(din_model()), *din),
        "DIN plain": (lambda: Trainer(din_model(), Adagrad(LR)), *din),
        "DIEN": (lambda: fused(dien_model()), *dien),
        "DSSM": (lambda: fused(dssm_model(), dssm_loss), *dssm_staged(range(K))),
        # the generators: dropout masks from the Trainer's, negatives from a
        # step generator
        "DeepFM fused, dropout 0.1": (dropout_deepfm, batches, labels),
        "DSSM, sampled softmax": (sampled_dssm, *dssm_staged(range(K))),
        "DSSM, frequency sampler": (lambda: sampled_dssm(zipf), *dssm_staged(range(K))),
    }
    out = {}
    for name, (build, path_batches, path_labels) in paths.items():
        trainer = trained[name] if name in trained else build()
        out[name] = graph_against_loop(name, trainer, path_batches, path_labels, card)
        if name == "DeepFM fused":
            graph_beside_garbage(name, trainer, path_batches, path_labels, card)
        del trainer
    print(f"phase 3q took {time.perf_counter() - t0:.1f} s; {len(out)} paths, "
          f"{sum(r['unequal'] == 0 for r in out.values())} bitwise equal", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2

    from recommender_system_tpu_torch import DCN, Scorer
    from recommender_system_tpu_torch.ops import kernels
    from recommender_system_tpu_torch.ops.interactions import cross_network
    from recommender_system_tpu_torch.ops.kernels import cross_fused
    from recommender_system_tpu_torch.utils.datasets import synthetic_criteo

    # --- phase 1: set-up ---------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")

    # --- phase 2: kernels against their plain versions ---------------------
    cross_errs = check_cross_kernel(cross_fused, cross_network)
    fm_errs = check_fm_kernel()
    din_errs = check_din_kernel()
    sparse_errs = check_sparse_rows()
    long_errs = check_long_order()

    # --- phase 3: serving at full width ------------------------------------
    cols, X, _ = synthetic_criteo(n_rows=max(REQUESTS), vocab=100_000,
                                  embedding_dim=8, seed=0)
    model = DCN(tuple(cols), cross_layers=6, hidden_units=(256, 128, 64),
                device="cuda", generator=torch.Generator().manual_seed(0))
    table = model.embeddings.table_d8
    with torch.no_grad():
        # the default init std of 1e-4 would leave the embeddings no say in
        # the output
        table.normal_(0.0, 0.1, generator=torch.Generator(device="cuda").manual_seed(1))
    print(f"DCN: x0 width {model.cross.weights.shape[1]}, table {tuple(table.shape)}, "
          f"{sum(p.numel() for p in model.parameters())} parameters", flush=True)
    scorer = Scorer(model, batch_size=SERVE_BATCH)
    requests = {n: {k: v[:n] for k, v in X.items()} for n in REQUESTS}

    zero_counts()
    answers = {n: scorer(req) for n, req in requests.items()}
    torch.cuda.synchronize()
    launches = read_counts()
    batches = sum(-(-n // SERVE_BATCH) for n in REQUESTS)
    print(f"serving launches: {launches} for {batches} padded batches", flush=True)
    if launches != launches_want(cross_fused=batches):
        raise RuntimeError(f"serving launched {launches} for {batches} served batches, "
                           f"want {batches} cross_fused and nothing else")

    def plain_forward(req):
        with torch.inference_mode():
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in req.items()}
            x0 = model.embeddings(batch).concat_flat()
            cross = cross_network(x0, model.cross.weights, model.cross.biases)
            logits = model.head(torch.cat([cross, model.deep(x0)], dim=-1))
            return torch.sigmoid(logits).cpu().numpy()

    for n, got in answers.items():
        if got.shape != (n, 1) or got.dtype != np.float32 or not np.isfinite(got).all():
            raise RuntimeError(f"request of {n} rows answered {got.shape} {got.dtype}")
        np.testing.assert_allclose(got, plain_forward(requests[n]), rtol=0, atol=ATOL)
    spread = float(np.std(answers[max(REQUESTS)]))
    if spread < 1e-3:
        raise RuntimeError(f"scores barely vary (std {spread}): inputs have no say")
    cpu_scorer = Scorer(copy.deepcopy(model).to("cpu"), batch_size=SERVE_BATCH,
                        device="cpu")
    np.testing.assert_allclose(answers[1000], cpu_scorer(requests[1000]),
                               rtol=0, atol=ATOL)
    print(f"serving check: {len(REQUESTS)} requests equal the plain forward on the "
          f"card and the CPU path (atol={ATOL}); score std {spread:.4f}", flush=True)

    # --- phases 3b-3d: training at bench.py's width ----------------------
    train_cols, batches, labels = staged_batches(range(K))
    trainer, fused_launches = train_fused(train_cols, batches, labels, card)
    plain_launches = train_plain(train_cols, batches, labels)
    card_against_cpu(deepfm(train_cols, None), batches, labels, "DeepFM")

    # --- phases 3f and 3e: DIN at model_step.py's width, trained, then served
    din_batches, din_labels = din_staged(range(K))
    din_trainer, din_fused_launches = train_din_fused(din_batches, din_labels, card)
    din_plain_launches = train_din_plain(din_batches, din_labels)
    card_against_cpu(din_model(), din_batches, din_labels, "DIN")
    din_scorer, din_requests, din_serve_launches = serve_din(din_trainer.model)

    # --- phases 3g and 3h: the Criteo CTR models at model_step.py's width,
    # and FMLayer
    ctr = train_ctr_models(card)
    fm_layer, fm_x, fm_launches = fm_layer_path(card)

    # --- phase 3i: DeepCrossing, PNN, AFM and FFM at model_step.py's width
    family = train_ctr_family(ctr["cols"], *ctr["batches"], card)

    # --- phase 3j: DIEN at model_step.py's width, trained, compared with the
    # CPU on a small batch, then served
    t0 = time.perf_counter()
    dien_batches, dien_labels = din_staged(range(K), negatives=True)
    dien_trainer, dien_fused_launches, dien_plain_launches = train_dien(
        dien_batches, dien_labels, card)
    card_against_cpu(dien_model(), {k: v[:, :DIEN_SMALL_BATCH] for k, v in dien_batches.items()},
                     dien_labels[:, :DIEN_SMALL_BATCH], "DIEN")
    dien_serve_launches = serve_dien(dien_trainer.model, card)
    print(f"phase 3j took {time.perf_counter() - t0:.1f} s", flush=True)

    # --- phase 3k: shapes the cross, FM and DIN attention kernels do not take
    global_counts = check_global_shapes(card)

    # --- phase 3l: DSSM at model_step.py's width, trained, compared with the
    # CPU on a small batch, then served through RetrievalIndex
    t0 = time.perf_counter()
    dssm_batches, dssm_labels = dssm_staged(range(K))
    dssm_trainer, dssm_fused_launches, dssm_plain_launches = train_dssm(
        dssm_batches, dssm_labels, card)
    card_against_cpu(dssm_model(), {k: v[:, :DIEN_SMALL_BATCH] for k, v in dssm_batches.items()},
                     dssm_labels[:, :DIEN_SMALL_BATCH], "DSSM", loss_fn=dssm_loss)
    dssm_index, dssm_requests, _ = serve_dssm(dssm_trainer.model, card)
    print(f"phase 3l took {time.perf_counter() - t0:.1f} s", flush=True)

    # --- phase 3m: MMOE at model_step.py's Criteo width, trained and served
    t0 = time.perf_counter()
    mmoe_trainer, mmoe_labels, mmoe_launches = mmoe_path(ctr["cols"], *ctr["batches"], card)
    print(f"phase 3m took {time.perf_counter() - t0:.1f} s", flush=True)

    # --- phase 3n: the training CLI, out of core at the README's north-star
    # width and in memory, checkpoint and resume, every model it builds
    cli = cli_path(card)

    # --- phase 3o: the tables sharded by row over torch.distributed: NCCL
    # over the machine's cards, four gloo ranks on one card, and the
    # README's multi-chip command under torchrun
    mesh = mesh_path(card)

    # --- phase 3p: the model axis: a 2 x 2 grid of gloo ranks on one card
    # (FFM's column-sharded table, MMOE's experts), --mesh-model under
    # torchrun, the classics at MovieLens-100k's shape
    grid = grid_path(card)

    # --- phase 3q: every single-card training path's K-step call as one
    # CUDA graph replay, against the same steps one by one
    graphs = graph_path(card, {
        "DeepFM fused": trainer, "WideDeep": ctr["wide_deep"], "NFM": ctr["nfm"],
        **{label: family[name] for name, label in (
            ("deep_crossing", "DeepCrossing"), ("pnn", "PNN"), ("afm", "AFM"), ("ffm", "FFM"))},
        "MMOE": mmoe_trainer, "DIN fused": din_trainer, "DIEN": dien_trainer,
        "DSSM": dssm_trainer})

    # --- phase 3r: DIN with 128-wide embeddings, whose attention only the
    # global kernel takes, trained (one graph captured and replayed) and
    # served
    wide = din_wide_path(card)

    # --- phase 3s: the long path of FusedSGD and FusedAdam: DIN's padding
    # row, and Criteo batches with missing fields
    rules = long_rules_path(card)

    # --- phase 4: timings --------------------------------------------------
    with torch.inference_mode():
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in requests[SERVE_BATCH].items()}
        x0 = model.embeddings(batch).concat_flat()
        w, b = model.cross.weights, model.cross.biases
        B, D = x0.shape
        L = w.shape[0]
        # x0 (3.6 MB) stays in the 50 MB L2 across calls, as it does when
        # the Scorer's concat has just written it
        kernel_dev = device_ms(lambda: cross_fused(x0, w, b))
        plain_dev = device_ms(lambda: cross_network(x0, w, b))
        kernel_call = call_ms(lambda: cross_fused(x0, w, b))
        plain_call = call_ms(lambda: cross_network(x0, w, b))
    if not all("cross_tile_kernel" in name for name in kernel_dev):
        raise RuntimeError(f"cross_fused ran other device work: {dict(kernel_dev)}")
    kernel_ms, plain_ms = sum(kernel_dev.values()), sum(plain_dev.values())
    bound_ms, bound_by = cross_bound(B, D, L)
    print(f"timing cross_fused B={B} D={D} L={L}: device {kernel_ms:.5f} ms "
          f"({100 * bound_ms / kernel_ms:.1f}% of the bound {bound_ms:.5f} ms, "
          f"{bound_by}), {kernel_call:.5f} ms per call; plain cross_network: "
          f"device {plain_ms:.5f} ms in {len(plain_dev)} kernel kinds, "
          f"{plain_call:.5f} ms per call; on {card}", flush=True)

    lat = {n: host_ms(lambda n=n: scorer(requests[n]), iters=50)
           for n in (1, SERVE_BATCH)}
    for n, times in lat.items():
        print(f"timing Scorer {n}-row request: median {statistics.median(times):.3f} ms, "
              f"min {min(times):.3f} ms, max {max(times):.3f} ms over {len(times)}; "
              f"on {card}", flush=True)
    _, X_big, _ = synthetic_criteo(n_rows=THROUGHPUT_ROWS, vocab=100_000,
                                   embedding_dim=8, seed=1)
    big = host_ms(lambda: scorer(X_big), iters=5, warmup=1)
    print(f"timing Scorer throughput over {THROUGHPUT_ROWS} rows: "
          f"{THROUGHPUT_ROWS / (statistics.median(big) / 1e3):.1f} examples/s "
          f"(median of {len(big)} calls, {statistics.median(big):.2f} ms each); "
          f"on {card}", flush=True)
    serve_dev = device_ms(lambda: scorer(requests[SERVE_BATCH]), iters=10)
    busy = sum(serve_dev.values())
    wall = statistics.median(lat[SERVE_BATCH])
    print(f"Scorer {SERVE_BATCH}-row request: device busy {busy:.4f} ms of "
          f"{wall:.4f} ms wall, idle share {1 - busy / wall:.3f}; top device work:",
          flush=True)
    for name, ms in serve_dev.most_common(8):
        print(f"  {ms:.4f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")

    sparse_times = time_sparse_rows(card)
    time_training(trainer, batches, labels, card, "fused training")
    din_times = time_din(din_trainer, din_scorer, din_requests, din_batches, din_labels, card,
                         {"FusedSGD": rules["trainers"]["din_sgd"],
                          "FusedAdam": rules["trainers"]["din_adam"]})
    fm_times = time_fm(fm_layer, fm_x, card)
    for name in ("wide_deep", "nfm"):
        time_training(ctr[name], *ctr["batches"], card, f"{name} fused training")
        time_training(rules["trainers"][f"{name}_missing"], *rules["batches"], card,
                      f"{name} fused training, {100 * MISSING_SHARE:.0f}% of the fields missing")
    for name in ("deep_crossing", "pnn", "afm", "ffm"):
        time_training(family[name], *ctr["batches"], card, f"{name} fused training")
    time_dien(dien_trainer, dien_batches, dien_labels, card)
    time_dssm(dssm_trainer, dssm_index, dssm_requests, dssm_batches, dssm_labels, card)
    time_training(mmoe_trainer, ctr["batches"][0], mmoe_labels, card, "MMOE fused training")
    global_entries = time_global_kernels(
        card, {**cross_errs, **fm_errs, **din_errs}, global_counts, wide)
    time_cli(cli, card)

    # launches on each kernel's main path, and on the other paths beside them
    ctr_launches = ctr["launches"]
    family_launches = family["launches"]
    def on_mesh(kernel):
        """Each phase-3o and 3p run's launches of ``kernel``, summed over
        ranks."""
        runs = {**mesh["launches"], **grid["launches"]}
        return {run: sum(r[kernel] for r in ranks) for run, ranks in runs.items()
                if sum(r[kernel] for r in ranks)}

    def on_graphs(kernel):
        """Each phase-3q path's launches of ``kernel`` over its graphed
        calls (equal to its looped calls')."""
        return {path: r["launches"][kernel] for path, r in graphs.items()
                if r["launches"][kernel]}

    def on_grid(kernel):
        """Each phase-3p run's launches of ``kernel``, rank by rank."""
        return {run: [r[kernel] for r in ranks] for run, ranks in grid["launches"].items()
                if sum(r[kernel] for r in ranks)}

    sparse_rows = [
        ("fused_adagrad_apply", "recommender_system_tpu/ops/fused_adagrad.py:156",
         fused_launches["fused_adagrad_apply"],
         {"din": din_fused_launches["fused_adagrad_apply"],
          "dien": dien_fused_launches["fused_adagrad_apply"],
          "dssm": dssm_fused_launches["fused_adagrad_apply"],
          "mmoe": mmoe_launches["fused_adagrad_apply"],
          "cli_north_star_stream": cli["stream"]["fused_adagrad_apply"],
          "cli_resumed_stream": cli["resume"]["fused_adagrad_apply"],
          "dcn": ctr_launches["dcn"]["fused_adagrad_apply"],
          **{name: family_launches[name]["fused_adagrad_apply"]
             for name in ("deep_crossing", "pnn", "afm", "ffm", "pnn_both_fgcnn")}}),
        ("fused_sgd_apply", "recommender_system_tpu/ops/fused_adagrad.py:594",
         ctr_launches["wide_deep"]["fused_sgd_apply"],
         {"fnn": ctr_launches["fnn"]["fused_sgd_apply"],
          **{name: rules["launches"][name]["fused_sgd_apply"]
             for name in ("din_sgd", "wide_deep_missing")}}),
        ("fused_adam_apply", "recommender_system_tpu/ops/fused_adagrad.py:649",
         ctr_launches["nfm"]["fused_adam_apply"],
         {"fm": ctr_launches["fm"]["fused_adam_apply"],
          **{name: rules["launches"][name]["fused_adam_apply"]
             for name in ("din_adam", "nfm_missing")}}),
        ("scatter_add_sorted", "recommender_system_tpu/ops/embedding_grad.py:51",
         plain_launches["scatter_add_sorted"],
         {"din": din_plain_launches["scatter_add_sorted"],
          "dien": dien_plain_launches["scatter_add_sorted"],
          "dssm": dssm_plain_launches["scatter_add_sorted"],
          "ffm": family_launches["ffm_plain"]["scatter_add_sorted"],
          "cli_quick_start": cli["quick"]["scatter_add_sorted"],
          "cli_models": sum(c["scatter_add_sorted"] for c in cli["models"].values())}),
    ]
    # the long path of kernels 4-7 on the steps whose streams hold a long
    # segment (the padding row: DIN's two sites, DSSM's three, DIEN's
    # three; the id-0 rows of Criteo batches with missing fields) and on
    # bench.py's and model_step.py's uniform Criteo batches, which hold none
    from recommender_system_tpu_torch.ops.kernels import SPARSE_CHUNK
    padding = int((din_stream(din_batch(0)[0]) == DIN_USERS).sum())
    long_launches = {
        "fused_adagrad_apply": {
            name: counts[long_key("fused_adagrad_apply")] for name, counts in (
                ("deepfm", fused_launches), ("din", din_fused_launches),
                ("dien", dien_fused_launches), ("dssm", dssm_fused_launches))},
        "scatter_add_sorted": {
            name: counts[long_key("scatter_add_sorted")] for name, counts in (
                ("deepfm", plain_launches), ("din", din_plain_launches),
                ("dien", dien_plain_launches), ("dssm", dssm_plain_launches))},
        "fused_sgd_apply": {
            name: counts[long_key("fused_sgd_apply")] for name, counts in (
                ("wide_deep", ctr_launches["wide_deep"]), ("din", rules["launches"]["din_sgd"]),
                ("wide_deep_missing_fields", rules["launches"]["wide_deep_missing"]))},
        "fused_adam_apply": {
            name: counts[long_key("fused_adam_apply")] for name, counts in (
                ("nfm", ctr_launches["nfm"]), ("din", rules["launches"]["din_adam"]),
                ("nfm_missing_fields", rules["launches"]["nfm_missing"]))},
    }
    if (padding < SPARSE_CHUNK or not all(long_launches["fused_adagrad_apply"].values())
            or not long_launches["scatter_add_sorted"]["din"]
            or not all(long_launches["fused_sgd_apply"].values())
            or not all(long_launches["fused_adam_apply"].values())):
        raise RuntimeError(f"the long path: {padding} padding positions in DIN's step "
                           f"stream, launches {long_launches}")
    print(f"long path: DIN's step stream holds {padding} positions on its padding row "
          f"(long from {SPARSE_CHUNK}); launches {long_launches}", flush=True)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "cross_fused", "route": "cuda",
        "source": "recommender_system_tpu_torch/csrc/cross.cu",
        "replaces": "recommender_system_tpu/ops/pallas_kernels.py:124",
        "launches": launches["cross_fused"],
        "max_abs_err": max(cross_errs["cross_tile_kernel"], cross_errs["cross_stack_kernel"]),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "call_ms": kernel_call, "plain_call_ms": plain_call,
        "dcn_training_launches": ctr_launches["dcn"]["cross_fused"],
        "cli_dcn_launches": cli["models"]["dcn"]["cross_fused"],
        "graph_launches": on_graphs("cross_fused"),
    }, {
        "name": "fm_fused", "route": "cuda",
        "source": "recommender_system_tpu_torch/csrc/fm.cu",
        "replaces": "recommender_system_tpu/ops/pallas_kernels.py:61",
        "launches": fm_launches["fm_fused"],
        "max_abs_err": max(fm_errs["fm_rows_kernel"], fm_errs["fm_wide_kernel"]), **fm_times,
    }, {
        "name": "din_attention_fused", "route": "cuda",
        "source": "recommender_system_tpu_torch/csrc/din_attention.cu",
        "replaces": "recommender_system_tpu/ops/pallas_kernels.py:190",
        "launches": din_fused_launches["din_attention_fused"],
        "max_abs_err": din_errs["din_attention_kernel"],
        **{k: v for k, v in din_times.items() if k != "backward"},
        "serving_launches": din_serve_launches["din_attention_fused"],
        "plain_training_launches": din_plain_launches["din_attention_fused"],
        "dien_launches": dien_fused_launches["din_attention_fused"],
        "dien_serving_launches": dien_serve_launches["din_attention_fused"],
        "dien_plain_training_launches": dien_plain_launches["din_attention_fused"],
        "cli_din_dien_launches": (cli["models"]["din"]["din_attention_fused"]
                                  + cli["models"]["dien"]["din_attention_fused"]),
        "mesh_launches": on_mesh("din_attention_fused"),
        "graph_launches": on_graphs("din_attention_fused"),
    }, {
        "name": "din_attention_backward (din_backward_tile_kernel)", "route": "cuda",
        "source": "recommender_system_tpu_torch/csrc/din_attention.cu",
        "replaces": "recommender_system_tpu/ops/din_vjp.py:120",
        "launches": din_fused_launches["din_attention_backward"],
        "global_launches": din_fused_launches[global_key("din_attention_backward")],
        "wide_launches": din_fused_launches[wide_key("din_attention_backward")],
        "max_abs_err": din_errs["din_attention_backward"],
        **din_times["backward"],
        "serving_launches": din_serve_launches["din_attention_backward"],
        "plain_training_launches": din_plain_launches["din_attention_backward"],
        "dien_launches": dien_fused_launches["din_attention_backward"],
        "dien_serving_launches": dien_serve_launches["din_attention_backward"],
        "dien_plain_training_launches": dien_plain_launches["din_attention_backward"],
        "cli_din_dien_launches": (cli["models"]["din"]["din_attention_backward"]
                                  + cli["models"]["dien"]["din_attention_backward"]),
        "mesh_launches": on_mesh("din_attention_backward"),
        "graph_launches": on_graphs("din_attention_backward"),
    }] + global_entries + [{
        "name": name, "route": "cuda",
        "source": "recommender_system_tpu_torch/csrc/sparse_rows.cu",
        "replaces": replaces, "launches": count, "max_abs_err": sparse_errs[name],
        **sparse_times[name], "other_paths_launches": others,
        **({"long_launches": long_launches[name]} if name in long_launches else {}),
        **({"long_row_f64_err": long_errs} if name == "scatter_add_sorted" else {}),
        "mesh_launches": on_mesh(name), "grid_launches_per_rank": on_grid(name),
        "graph_launches": on_graphs(name),
    } for name, replaces, count, others in sparse_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
