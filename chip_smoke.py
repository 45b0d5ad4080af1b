#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Environment: torch, CUDA and nvcc versions, the card's name and power
   limit, and the time to build the kernels from
   ``stochastic_gradient_push_torch/csrc/`` (one ``nvcc`` per source,
   started together).
2. Every kernel against its plain PyTorch version on the card (fp32,
   TF32 off), max |kernel - plain| <= 1e-4, with the kernel's, the plain
   version's and one library call's times (CUDA events) and the bound:
   the flash forward (also its logsumexp), paged decode, and the two
   flash backward kernels (dQ, dK/dV) at B8 H12 T1024 causal and at a
   ragged t200, causal and full.  The flash kernels' bound is the card's
   best rate for fp32-accurate products: the tensor cores' TF32 rate
   over the three passes of the 3xTF32 split (their share is stated
   against it); the fp32 CUDA-core bound is printed beside it.  The
   paged decode's ``ms`` is CUDA events around back-to-back wrapper calls
   (the host's time included); its ``device_ms`` times the same calls,
   one per layer, captured in a CUDA graph and replayed; its
   ``host_ms`` is the host clock's time to issue one call.
   ``-Xptxas -v``'s registers and spills are printed per kernel; the
   flash and paged-decode kernels must report them and must not spill.
3. Serving main path at full width: ``LMEngine`` over the d768/L12/h12
   ff3072/vocab32000 LM (random weights from seed 0) serves 48 synthetic
   requests closed loop.  The launch counters are zeroed just before and
   read just after; every kernel must have launched, every request must
   complete, and the page table must be quiescent.
4. Teacher-forced check: the engine's prefill and per-step decode logits
   for two requests against the dense ``TransformerLM`` forward on the
   card, max |diff| <= 1e-3.
   Then the gossip transport kernels, ``gossip_edge_start`` (K2) and
   ``gossip_edge_wait`` (K1), bit-equal to their plain versions on the
   full-width packed payload of world 4 (the d768 LM's 134.3 M f32
   parameters per rank) for the f32, bf16 and int8 (block 64) wires at
   one and two edges, and on ragged payloads (n 300, chunk 128, int8
   blocks 7 and 64).
5. Training main path at the same width, T1024, B8, fp32: the port's
   ``build_lm_train_step`` with SGP at world 1 over the n-peer
   exponential graph.  One step on the kernel lane (``attn_impl=
   "flash"``) and one from the same state on the plain lane (``"full"``)
   must agree (loss 1e-5 relative, global grad norm 1e-4 relative,
   params 1e-6 absolute); then 6 kernel-lane steps with the counters
   zeroed just before: every attention forward and backward must have
   gone through the kernels (12 launches of each per step), every loss
   finite.  Per-step loss, median step ms and tokens/s are printed.
6. The same LM at world 4, the four ranks stacked on the card, over the
   n-peer exponential graph with the gossip kernel lane: SGP (int8 wire,
   one peer, one transport bucket), then OSGP (staleness 2, bf16 wire,
   two peers, three buckets).  Each first takes steps from one state on
   the kernel lane and on the plain transport lane (both with flash
   attention): the push-sum weight, and the in-flight FIFO's weights,
   bit-equal, params within 1e-6.  Then 3 kernel-lane steps with the
   counters zeroed just before: every start and wait went through the
   kernels (buckets per step each), every attention call too (4 ranks x
   12 layers per step), every loss finite; losses, median step ms,
   tokens/s and peak memory are printed.
7. ResNet-50 at full width (224 px, 1000 classes), fp32 with TF32 off,
   at world 4 stacked on the card, batch 32 per rank (128 images a
   step), random weights from seed 0 and synthetic images
   (``data/synthetic.py``, seed 0), through ``train/step.py``'s
   ``build_train_step`` on the gossip kernel lane with thinning
   (``gossip_every=2``) and periodic global averaging
   (``global_avg_every=4``): SGP (f32 wire, one peer, one bucket), then
   OSGP (staleness 2, bf16 wire, two peers, three buckets).  Each first
   steps one state on the kernel lane and on the plain transport lane
   under deterministic cuDNN: the push-sum weight and the FIFO's weights
   bit-equal, params within 1e-6.  Then 4 kernel-lane steps with the
   counters zeroed just before: a fired step launches one start and one
   wait per bucket (the wait lands or settles the launched share), a
   skipped step launches nothing, every loss is finite, every rank's
   push-sum weight is exactly 1.0 after each global average (and the
   FIFO drained); median step ms, images/s, peak memory and
   ``replica_spread`` are printed.
   7c: one bf16 SGP step at world 4 on the kernel lane, from one state,
   for each BatchNorm of the reference (``norm_variant`` ``bn``,
   ``bn16``, ``folded``): every loss finite, one K2 and K1 each,
   ``folded``'s running statistics bit-unchanged (the others' moved),
   ``bn16``'s losses printed beside ``bn``'s.
8. The training CLI, ``run/gossip_sgd.py``, at ResNet-50's full width
   (224 px, 1000 classes, fp32, TF32 off), world 4 stacked, 32 images a
   rank, synthetic data (seed 0; each image set drawn once for the
   script, ``install_synthetic_memo``), two epochs of three iterations
   with validation, each run with the counters zeroed just before and
   traced
   (``--trace_dir``; its host spans printed: validation, saves, steps
   and the rest of ``main``):
   - SGP and D-PSGD (``--push_sum False``) on the kernel lane
     (``--gossip_kernel pallas``): one start and one wait per step, no
     other kernel; the rank-averaged CSV's header and its 10 rows; one
     checkpoint file per rank.  Their step times (the trainer's own
     ``BT`` meter, each epoch's first step left out) are printed.  The
     SGP run's telemetry (``--metrics_every 2``), checked with the
     port's own schema (the reference's reader needs jax): ``plan``,
     ``run_meta``, ``comm`` and ``step_stats`` events, every envelope
     valid and every kind in the closed vocabulary; ``trace.json``
     monotone with one ``train_step`` span a step; the last ``comm``
     bytes equal to a ``CommModel`` built here from the plan's graph and
     ResNet-50's parameter count; ``run_meta`` stamping the kernel lane.
   - D-PSGD on the kernel lane against ``--gossip_kernel xla``: two
     steps from one state (seed 0) under deterministic cuDNN, params
     within 1e-6 (the saved rank files).
   - AD-PSGD through ``run/gossip_sgd_adpsgd.py`` (graph 1, one epoch,
     ``--train_fast True``): no gossip kernel launched; one bilateral
     round on ResNet-50's parameters on
     the card equal, bit for bit, to ``(x + x[partner]) * 0.5`` gathered
     to the host.
   - Resume equals continue: OSGP (staleness 2) on the kernel lane for
     two epochs straight, and for one epoch then ``--resume True`` in a
     fresh run, under deterministic cuDNN: every rank file's params,
     momentum, push-sum weight and FIFO exactly equal.
   - Preemption: a subprocess run of the CLI (OSGP, ``--overlap True``)
     gets SIGUSR1 once it is training; it must exit 75 and leave the
     four rank files with a drained (all-zero) FIFO.  It runs beside the
     runs after the SGP and D-PSGD ones (a thread waits on it).
   - 8d (in a subprocess beside the runs after SGP and D-PSGD, every
     time taken then marked): the space-to-depth stem on the card
     equals the 7x7/2 stem on
     the same weights and images (fp32, each within 1e-5 of the scale
     from fp64); then SGP on the kernel lane with ``--stem_s2d True
     --scan_steps 4``, one epoch of 6 steps at batch 16 over the same
     synthetic set (a warm-up single, a chunk of 4, a cap tail of 1),
     beside the same command at ``--scan_steps 1``, both under
     deterministic cuDNN: CSV rows equal outside timing, rank files
     within 1e-6, K2/K1 launches equal (6 each).
9. Error feedback, faults, health and recovery at ResNet-50's width
   (224 px, fp32, TF32 off, world 4 stacked, 32 images a rank):
   - 9a: SGP on the int8 wire with error feedback and the fault plan
     ``drop:0->1@0:2;seed:5``, two steps from one state on the kernel
     lane and on the plain lane under deterministic cuDNN: ps-weight
     bit-equal, params and the EF residual within 1e-6 (exact equality
     printed), one K2 and one K1 a step;
   - 9b: ``run/gossip_sgd.py`` OSGP at staleness 2, ``--wire_dtype int8
     --error_feedback True --inject_faults "drop:0->1@1:4;seed:5"
     --health_every 3 --residual_floor 1e-9 --gossip_kernel pallas``,
     two epochs of three steps: one K2 and one K1 a step (as without
     faults), every ``gossip health:`` line with a finite
     ``ef_residual_rms`` under 0.1, no ``push-sum-mass-leak``, a
     ``gossip recovery:`` global average, rank files with a non-zero
     EF residual and a drained FIFO, the reference's CSV; traced
     (``--trace_dir``): its ``health`` and ``recovery`` events' data
     the JSON of those lines, each line once, one ``gossip plan:``
     line;
   - 9c: ``make_recovery_fn`` on 9b's saved state (with a FIFO of
     pending shares) on the card: every rank exactly equal, ``Σx/Σw``
     kept to 1e-6 against float64, the weights 1, the FIFO drained;
   - 9d: K2 and K1 against their plain twins at ResNet-50's payload
     with a NaN-poisoned rank and dropped edges (int8 and bf16): bit
     for bit, NaN positions included, the dropped edges landing 0; their
     times on chunk-padded inputs (as the round packs them) beside the
     bytes bounds, and the wrappers' on unpadded ones (pad copies
     included).
10. Hierarchical and synthesized rounds and the topology planner at
   ResNet-50's width (224 px, fp32, TF32 off, world 4 stacked, 32 images
   a rank, seed 0), on the kernel lane:
   - 10a: ``HierarchicalGraph(4, slice_size=2)`` on the int8 wire with
     error feedback, SGP and OSGP (staleness 2), two steps each from one
     state on the kernel lane and on the plain lane under deterministic
     cuDNN, each step from the kernel lane's state: ps-weight and EF
     residual bit-equal, params within 1e-6,
     ``Σw`` with the in-flight shares exactly 4, one K2 and one K1 a
     step (none for the intra-slice mean), and after each SGP step the
     replicas of a slice identical;
   - 10b: the planner's ``--topology synth`` schedule for world 4 on
     slices of 2 at a cross-slice cost of 16 (fingerprint ``b7e2ef83…``:
     psum, delegate edge, full edge), SGP f32 for one cycle (three
     steps), lanes as in 10a, two K2 and two K1; then the rounds alone
     for two cycles over a random ResNet-50-shaped tree reach the rank
     mean within 1e-6 (the cycle's product is nilpotent off the mean,
     so one cycle does not), and the grouped mean's time a round;
   - 10c: ``run/gossip_sgd.py`` with ``--topology synth --slice_size 2
     --dcn_cost 16`` (its ``gossip plan:`` line carries the
     fingerprint), then ``--resume True`` (the same fingerprint, and the
     rank files' meta carries it), then ``--topology auto --health_every
     3`` (plans ``hierarchical``; every health line ``ps_mass_err`` 0);
     each run's ``BT`` step time;
   - 10d: K2 and K1 at the hierarchical delegate round's shape (int8, one
     edge, ranks 1 and 3 at weight 0) and at f32 over ResNet-50's
     payload, bit-equal to their twins, timed beside their bounds.
11. Sequence parallelism: the d768/L12/vocab32000 LM (fp32, TF32 off)
   at world 8 stacked = dp 2 replicas x sp 4 sequence shards, seq_len
   4096 (1024-token shards), batch 2 a replica, ``ring_flash`` attention
   (every layer's attention a ring of flash-kernel ticks, K3 forward, K4
   and K5 backward), SGP on the f32 wire (one peer, one bucket) on the
   gossip kernel lane between the two replicas:
   - 11a: one step on the kernel lane and one from the same state on the
     plain lane (the same ring with plain ticks, the plain transport),
     held to phase 5's tolerances with the ps-weight equal; then three
     timed steps, each launching K3 = K4 = K5 = dp * L * sp(sp+1)/2 =
     240 and one K2 and one K1; step ms, tokens/s, peak memory;
   - 11b: the same with ``remat=True``: its one step equal to 11a's
     kernel step (exactly, or within 1e-6; which is printed), K3 480 a
     step (the recompute); one replica's forward and backward peaks
     below 11a's, the step's peak (set by the gossip round) no higher;
   - 11c: ``run/gossip_lm.py --world_size 8 --sp 4 --attn ring_flash
     --remat True --gossip_kernel pallas`` at the same shape, 4 steps on
     a token file (``--corpus_file``, ids from seed 0): finite CSV rows,
     the launches as in 11b;
   - 11d: K3, K4 and K5 at a tick's shape (b2 h12 t1024), causal and
     full, against their plain versions, with SDPA and the bounds.
12. The LM at bf16 (the reference's ``--precision bf16``: bf16 compute
   on fp32 parameters, the bf16 forms of K3, K4 and K5; bf16 GEMMs
   accumulating in fp32, ``allow_bf16_reduced_precision_reduction``
   off):
   - 12a: phase 5's step (world 1, T1024 B8, flash) at bf16: one step
     from one state on the kernel lane, on the plain lane (the kernels'
     plain twins on the card, ``attn_lane="plain"``: the same function,
     where ``full`` attention at bf16 takes delta from the unrounded
     output) and on the fp32 kernel lane; the kernel lane's update no
     farther from the fp32 step's than twice the plain lane's (relative
     L2 over every parameter), its loss likewise plus the bf16 noise of
     a mean over the step's tokens (2**-9 / sqrt(8192)); then 6
     timed steps, each launching 12 bf16 K3, K4 and K5 and no fp32 flash
     kernel; step ms and tokens/s beside phase 5's;
   - 12b: phase 11's dp 2 x sp 4 step (T4096, ring_flash, SGP f32 on
     K2/K1) at bf16, lanes as in 12a (the plain lane: plain ticks, plain
     transport), then three timed steps, each launching 240 bf16 K3, K4
     and K5, no fp32 flash kernel, one K2 and one K1; step ms, tokens/s
     and peak memory beside 11a's;
   - 12c: ``run/gossip_lm.py --precision bf16 --world_size 4
     --gossip_kernel pallas`` at the LM's width (T1024 B8 a rank), 4
     steps on a token file: finite CSV rows, 192 bf16 K3, K4 and K5, four
     K2 and K1;
   - 12d: the bf16 forms of K3, K4 and K5 against their plain versions
     (``bf16_close``: one bf16 ulp of max(|plain|, 2**-8 of the largest
     |plain|), at most 1 % of the elements apart; lse within 1e-4) at
     b1 t8, b1 t200 (causal and full), B8 T1024 causal and the tick
     shape b2 t1024 (causal and full), each timed from CUDA-graph
     replays (events around back-to-back calls printed beside) against
     its plain version, SDPA at bf16 (forward from graphs; backward:
     forward and backward less forward, from graphs) and its bound (bf16
     rows, fp32 lse/delta, 989 TFLOP/s), and K4 + K5 against SDPA's
     backward.
13. One rank per process on the card (``DistTransport`` over a gloo
   group, the payload on the cross-process K2/K1, peers mapped by CUDA
   IPC), each process's run joined with a timeout so a hang fails:
   - 13a: 4 processes run the cross-process K2 + K1 for the f32, bf16
     and int8 wires at ResNet-50's payload and at the d768/L12 LM's, two
     edges, 20 rounds each with new data every round: every rank's
     output bit-equal to the stacked K2 + K1 on the same seeded inputs
     (every round) and to the plain twin (gloo, round 0 at ResNet-50's
     payload); then rounds at 13b's shape (ResNet-50, f32, one edge)
     timed in rank 0 with CUDA events: its K2 and its K1 each alone on
     the card once its flags are set (the ``ms`` of the kernels line),
     and the round as the four processes run it together, time-sliced,
     beside ``copy_`` into the mapped peer row and the HBM bound, none
     an NVLink figure; then one process skips a round, and the rank it
     sends to must raise ``PeerLostError`` naming its rank, the edge,
     the round and the silent peer after its 2 s limit;
   - 13b: ``run/gossip_sgd.py`` in 2 processes launched by the
     reference's flags (``--multihost True --coordinator_address
     127.0.0.1:port --num_processes 2 --process_id i``, no torchrun
     variables; ``--backend gloo --gossip_kernel pallas``), ResNet-50
     at 224 px, 8 images a rank, 3 steps, SGP and OSGP side by side: one
     cross-process K2 and K1 a step in each process, both rank files
     written, each rank's state against the stacked kernel-lane run of
     the same command under deterministic cuDNN (the ResNet step tests'
     tolerance, rtol 1e-5 / atol 1e-6).
14. The reference's ImageNet command line on a JPEG tree written here
   (4 classes, 64 train and 32 val images a class, 320 x 256 px, seed 0),
   ResNet-50 at 224 px and 1000 classes, fp32, world 4 stacked, 32 images
   a rank (2 steps an epoch):
   - 14a: ``run/gossip_sgd.py --dataset imagefolder`` (PIL decoding, a
     batch a task on a pool of 8 threads) with SGP on the gossip kernels, three
     times: ``--data_output uint8 --prefetch True`` and ``--data_output
     f32 --prefetch False`` for 3 epochs, and the first again for one
     epoch with a ``--profile_dir`` window of both its steps; one K2 and
     one K1 a step in each; the first batch, uploaded as uint8 through the
     prefetcher's pinned buffers, equal to the loader's decode, and
     normalised on the card within 1e-6 of the same normalisation on the
     CPU and of the f32 loader's host-normalised batch; the first-step
     losses of the two runs within 1e-4 relative; the Chrome trace names
     both gossip kernels; each run's images/s and ``DT`` share of ``BT``
     (means of 3 steps, each epoch's first skipped), the card's
     normalisation time (``fenced_ms``), and the loader's own images/s
     with no step over 4 epochs of 8 batches (5 decoding at once, as
     under the CLI on a long epoch);
   - 14b: ``run/gossip_sgd_adpsgd.py`` on the same tree, 3 epochs of 2
     steps (``--train_fast``), synchronous (its images/s and losses
     printed beside), then ``--bilat_async True``: at least one
     adoption, finite losses, the averaging thread alive until ``stop``,
     no gossip kernel, and the staleness summary; then one averaging
     round on ResNet-50's world-4 parameters on the card (snapshot through
     pinned buffers on a side stream, adoption in place) bit-equal to the
     numpy round on the same snapshot.
15. The LM command line's harness (``run/gossip_lm.py``) at the LM's
   full width, bf16, world 2 stacked, SGP on K2/K1, flash attention,
   T1024 B4 a rank, each run in process with the counters zeroed just
   before (one bf16 K3, K4 and K5 a layer a rank and one K2 and one K1
   a step asserted), a temporary ``--checkpoint_dir``, and the seconds of
   its init, steps, eval batches, saves and restores (with GB) printed:
   - 15a: d768 cut to 4 layers, on an ``.npy`` token file over the
     vocabulary (``--corpus_file``), 4 steps with ``--ckpt_every 2`` twice (the rank files' and CSV
     losses' spread between two identical runs: determinism), then 2
     steps and a ``--resume True`` to 4, within that spread of the
     straight run;
   - 15b-15d: d768 cut to 4 layers, ``--corpus_file`` on the
     repository's own ``*.md`` text as bytes (vocab 256) with
     ``--val_frac 0.1 --val_every 2``, 12 steps
     in a subprocess started beside 15a, SIGUSR1 (from a thread) once
     its first CSV row is out: exit 75,
     both rank files at the CSV's last step, and (traced) its
     ``trace.json``, a ``run_meta`` with ``exit_reason:
     "preempt-requeue"`` at that step and a last ``comm`` event; a
     resume in process to 12,
     its rows running on without a gap, validation rows at the cadence
     and at the end, K3 launched once more a layer a rank for every
     validation batch and K4/K5 not, validation's share of the run's
     time; then the eval step on the saved state on the card, kernels
     against plain twins, losses within 2e-3 relative.
16. Intra-node averaging and gossip without a model:
   - 16a: phase 8's SGP run of ``run/gossip_sgd.py`` (ResNet-50, 224 px,
     fp32, 32 images a device row, two epochs of three steps) with
     ``--world_size 4 --nprocs_per_node 2``: 2 nodes of 2 devices,
     gradients, statistics and metrics averaged over a node's rows, one
     K2 and one K1 a step between the nodes (asserted), the CSV as
     phase 8's, its ``BT`` beside phase 8's flat world-4 ``BT``; then the
     kernel lane and the plain lane from one state under deterministic
     cuDNN: ps-weight bit-equal, params, momentum and statistics within
     1e-6;
   - 16b: the same command under a torchrun environment in 2 processes,
     one node each (``--backend gloo --gossip_kernel pallas``; started
     before 16a's lanes and joined with a timeout): each logs its batch
     rows (``[0, 1]``, ``[2, 3]``), launches one cross-process K2 and K1
     a step and no stacked one, and its rank file and rank 0's CSV rows
     equal 16a's plain lane's (ps-weight exactly, the rest to phase 13b's
     tolerance; CSV rows outside timing exactly);
   - 16c: ``parallel/averaging.py::push_sum_average`` over ResNet-50's
     parameters at world 8 stacked (each rank the seed-0 init plus its
     own noise), 40 plain rounds of the n-peer exponential graph: the
     consensus error below 1e-5 of the parameter scale, every rank
     within 1e-6 of it of the float64 mean, ms a round and peak memory.
17. Checkpoint sets across worlds, serving a run, the DCP backend:
   - 17a: phase 8's SGP command (``--gossip_kernel pallas``) at world 4
     for one epoch, then ``--world_size 2 --resume True`` for a second:
     the "resharded checkpoint set n=4 -> n=2" line, the reshard's
     seconds and GB, one K2 and one K1 a step at world 2, finite CSV
     rows; ``reshard_checkpoints`` on a copy of the world-4 set: its
     world-2 params exactly the float64 Σx/Σw cast to f32, ps-weight 1,
     its ``mean_drift``;
   - 17b: another copy resumed at world 2 in 2 torchrun processes
     (``--backend gloo --gossip_kernel pallas``, in the background): each
     process reshards its own rank's file, bit-equal to 17a's copy, and
     launches one cross-process K2 and K1 a step and no stacked one;
   - 17c: phase 15's ``run/gossip_lm.py`` (bf16, world 2, SGP on K2/K1,
     flash, T1024 B4, cut to 4 layers) under ``--ckpt_backend orbax
     --ckpt_every 2``: 4
     steps twice (the spread) and 2 steps resumed to 4, the step-4
     checkpoints and CSV losses within the spread, at most 3 step
     directories, the seconds a save holds the run (the host copy) and
     its background write, beside ``torch.save`` of the same tensors;
     one bf16 K3, K4 and K5 a layer a rank and one K2 and K1 a step;
   - 17d: a 2-step world-2 run of the same LM on the per-rank files,
     ``serve/load.py::load_consensus`` on its set (``IngestInfo``, the
     seconds), then phase 3's 48 requests and phase 4's teacher-forced
     check on an engine over the consensus;
   - 17e: ``run/gossip_sgd.py`` in 2 torchrun processes at 13b's shape
     under ``--ckpt_backend orbax`` (in the background), one epoch then
     resumed to two: one shared root, each process's restored rows equal
     to the rows it saved, rank 1's different from rank 0's.
18. The sequence ring across processes: phase 11's LM (d768, cut to 2
   layers, 4 until phase 19e came, dp 2 x sp 4, T4096 in 1024-token
   shards, B2 a replica, ``ring_flash``,
   remat, SGP on K2/K1, seed 0) through ``run/gossip_lm.py`` on a token
   file, in 8 processes under a torchrun environment sharing the card
   over gloo, process ``p`` holding shard ``p % 4`` of replica ``p //
   4``, each beside the same command stacked in this process:
   - 18a: fp32, 2 steps: every process's losses and grad norms within
     1e-5 relative of its stacked replica's, its push-sum weight
     exactly the replica's; fp32 K3/K4/K5 launches summed over the
     processes equal to the stacked run's; one cross-process K2 and K1
     a step in every process and no stacked one; finite CSV rows, the
     same in every process; one checkpoint file a process; traced:
     every process's own ``events_rN.jsonl`` and ``trace_rN.json``
     (process 0 the canonical names), its ``run_meta`` at dp 2 x sp 4,
     its comm model priced on its replica's payload;
   - 18b: the same at ``--precision bf16``, 2 steps: finite rows and the
     bf16 K3-K5 launches summed over the processes equal to the stacked
     run's;
   - 18c: one ring shift of a ``[2, 12, 1024, 64]`` fp32 block a shard,
     every process at once (gloo, through the host), by the host clock,
     beside ``torch.roll`` of the stacked block (CUDA events); each
     run's synchronised step ms beside the stacked run's.
19. Tensor parallelism: the flagship LM (d768/L12, 12 heads, d_ff 3072,
   vocab 32000, seed 0) through ``run/gossip_lm.py`` on a token file,
   Megatron column/row shards over ``--tp 2``:
   - 19a: ``--world_size 4 --tp 2`` (dp 2) stacked in this process,
     bf16, flash, SGP on K2/K1, 4 steps at T1024 B8: losses within 2e-3
     relative of the same command at ``--tp 1 --world_size 2``; 12 bf16
     K3, K4 and K5 launches a step a replica (one launch a layer for both
     shards' heads) and one K2 and K1 a step;
   - 19b: the same command cut to 4 layers in 4 processes under a
     torchrun environment (one tp shard each, gloo, the card shared;
     checkpoints forced through the DCP backend), 3 steps, then resumed
     from their DCP save to step 4: losses, grad norms, push-sum weight
     and the step-4 checkpoint (params, momentum) bit-equal to that
     command's straight run stacked here; each process's parameter,
     momentum and gossip bytes (predicted from the shapes), 4 bf16 K3-K5
     launches a step and one cross-process K2 and K1 a step;
   - 19c: dp 1 x sp 2 x tp 2 in 4 processes, ``ring_flash``, remat,
     fp32, d768 cut to 4 layers, T4096 B2, 2 steps, beside the same
     command stacked here:
     losses within 1e-5 and grad norms 1e-4 relative (the sequence
     axis's gradient mean runs in another order, phase 18), ps-weight
     exact; the fp32 K3-K5 launches summed over the processes tp times
     the stacked run's (which folds both shards' heads into one launch);
   - 19d: 19a's command at ``--tp 8`` (world 16 stacked, dp 2): the 12
     heads of 64 over shards of 96 columns, a head straddling two shards
     (the columns joined into whole heads before the attention): losses
     and grad norms within 2e-3 relative of 19a's ``--tp 1`` run, 12 bf16
     K3-K5 launches a step a replica, one K2 and K1 a step;
   - 19e: dp 1 x tp 8 in 8 processes at L2 and B2, 2 steps, beside the
     same command stacked: each process holds its 96 columns of q/k/v and
     rows of o (its parameter bytes predicted from the shapes), gathers
     the two heads its columns touch, 2 bf16 K3-K5 launches a step;
     losses and grad norms within 2e-3 relative of the stack (a shared
     head's gradient folds two processes' partial sums);
   - each run's step host ms and the tp sums' count and host ms a step;
     19b's, 19c's and 19e's processes run beside every stacked run of
     the phase and beside each other, and every time taken beside other
     work is marked (the card shared).
20. Switch MoE and expert parallelism: the flagship LM with 8 experts on
   every second block (capacity factor 1.25) through ``run/gossip_lm.py``
   on a token file, ``--moe_experts 8 --ep 2``:
   - 20a: ``--world_size 4`` (dp 2 x ep 2) stacked in this process, bf16,
     flash, SGP on K2/K1, d768 cut to 4 layers (2 MoE blocks; 12 until
     phase 23 came), 3 steps at T1024 B8 an ep shard: 4 bf16 K3, K4 and
     K5 launches a step a replica (both ep shards' rows in one launch a
     layer) and one K2 and K1 a step; ``moe_dropped`` in the
     CSV, in [0, 1]; the step ms, the peak GB, and the device ms of one
     MoE block's FFN and of one layer's attention, each alone at the
     run's shapes;
   - 20b: the ``/n_ep`` oracle at full width, fp32: one momentum-free
     AllReduce step at dp 1 x ep 2, capacity factor 8, no MoE loss,
     within rtol 5e-4 / atol 1e-5 of ``p - lr · grad`` of the ep 1 model
     on both shards' tokens, every MoE leaf moved, nothing dropped;
   - 20c: 20a's command cut to 4 layers in 4 processes under a torchrun
     environment (one ep shard each, gloo, the card shared; checkpoints
     forced through the DCP backend), 2 steps, then step 3 resumed from
     their DCP save, beside that command stacked here: losses within
     2e-3 relative of the stacked replicas' (a process sums its
     replicated gradients over the ep group, the stack takes one
     gradient of both shards' mean), ps-weight equal, the step-3
     params' distance printed; 4 bf16 K3-K5 launches and
     one cross-process K2 and K1 a step a process; the exchanges' count,
     bytes and host ms a step.  20c's processes run beside 20a, 20b and
     20c's stacked run (20a's layer times taken alone before they start),
     and every time taken beside them is marked.
21. MoE under tensor parallelism and the expert meshes across processes
   (``--moe_experts 8 --ep 2 --tp 2``, the experts split on their F dim):
   - 21a: 20a's command at ``--tp 2 --world_size 8`` (dp 2 x ep 2 x tp
     2) stacked, 3 steps on 20a's tokens: the same launches as 20a (a
     replica's ep and tp shards fold into one flash launch a layer),
     ``moe_dropped`` in [0, 1], losses within 2e-3 relative of 20a's
     (the reference's ``test_moe_ep_with_tp_matches_ep_only``); the step
     ms, the peak GB and one MoE FFN's device ms at tp 2 beside 20a's;
   - 21b: dp 1 x ep 2 x sp 2 x tp 2 in 8 processes under a torchrun
     environment (one ``(e, shard, t)`` each), bf16, ``ring_flash``, d768
     cut to 2 layers (1 MoE block; 4 until phase 19e came), T1024 B8 an
     ep shard, 2 steps, a
     DCP save, then step 3 resumed from it, beside the same command
     stacked here: losses and grad norms within 2e-3 relative,
     ps-weight equal, the step-3 params' distance printed; each
     process's ring ticks (shard ``s`` runs ``s + 1`` a layer), their
     sum ep x tp times the stack's; process 0's ep exchanges, tp sums
     and ring shifts a step (count, host ms, MB).  21b's processes run
     beside 21a and 21b's stacked run, and every time taken beside them
     is marked.
22. Pipeline parallelism (``--pp 2 --n_micro 4``, GPipe stages):
   - 22a: the flagship LM (d768/L12, bf16, flash, SGP on K2/K1, T1024 B8
     a replica) at ``--pp 2 --world_size 4`` (dp 2 x pp 2) stacked, 3
     steps: 48 bf16 K3, K4 and K5 a step a replica (each of the 4
     microbatches through each of the 12 layers) and one K2 and K1 a
     step; beside the same command at ``--pp 1 --world_size 2`` on the
     same tokens (12 a step a replica): losses within 2e-3 relative,
     the step ms and the peak GB of both;
   - 22b: the ``(gossip, pipe, ep, seq)`` mesh stacked, ``--pp 2 --ep 2
     --sp 2 --moe_experts 8 --moe_every 1 --attn ring_flash --world_size
     8`` (dp 1), bf16, d768 cut to 2 layers (a layer a stage; 4 until
     phase 19e came), 3 steps (phase 23's
     oracle, its DCP save at the end): 3 ring ticks a layer a
     microbatch, ``moe_dropped`` in [0, 1];
   - 22c: dp 2 x pp 2 in 4 processes under a torchrun environment (one
     stage each, gloo, the card shared; checkpoints forced through the
     DCP backend), 22a's command cut to 4 layers, 2 steps, then step 3
     resumed from their DCP save, beside that command stacked here:
     losses and grad norms within 2e-3 relative of the stacked
     replicas', ps-weight equal, the step-3 DCP tensors compared; 8 bf16
     K3-K5 launches (a stage's 2 layers x 4 microbatches) and one
     cross-process K2 and K1 a step a process, their sum the stack's;
     process 0's hand-offs and pipe-group sums a step (count, host ms,
     MB).  22c's processes run beside 22a, 22b and 22c's stacked run,
     and every time taken beside them is marked.
23. The pipeline meshes across processes: 22b's command in 8 processes
   under a torchrun environment (gloo, the card shared), one ``(stage,
   ep shard, sequence shard)`` each (dp 1 x pp 2 x ep 2 x sp 2;
   checkpoints forced through the DCP backend), 2 steps, a DCP save,
   then step 3 resumed from it, held against 22b's stacked run: losses
   and grad norms within 2e-3 relative, ``moe_dropped`` printed beside
   the stack's, ps-weight equal, the step-3 DCP tensors finite and their
   distance from the stack's printed; each process's bf16 K3, K4 and K5
   launches asserted from its sequence shard (a causal ring of 2: shard
   0 runs 1 tick a call, shard 1 runs 2; one call a layer of its stage
   a microbatch, so 8 and 16 a step), their sum ep times the stack's;
   process 0's hand-offs, ring shifts, ep exchanges and pipe-group sums
   a step (count, host ms, MB).  The processes start during phase 22.
24. The wire selftest (``scripts/torch_wirecheck.py --selftest``,
   ``parallel/wirecheck.py``) on the card, after phase 9: int8 + EF
   chaos round, parity, the ``CommModel`` pricing, and the chaos round
   on the kernel lane through the CUDA K2 and K1 (launches asserted),
   its ps-weight trajectory bit-identical to the plain lane's.
25. The KV-head-sharded serve (``serve/cli.py --model_shards 2``) of
   phase 17d's consensus set (d768/h12/ff3072/vocab 32000 at 17d's 12
   layers) at phase 3's page shape (page 16, 1024 pages, 16 slots, 48
   pages a sequence), 16 requests of 64-512 prompt and 16-64 new tokens:
   - 25a: in this process, both shards stacked on the card (alone: 25b
     and 25c start once its serve is done), with ``--trace_dir``: every
     request complete, the pages quiescent, 2 x L
     x decode steps K6 and 2 x L x requests K3 launches; the trace's
     ``run_meta`` and ``serve`` events; two requests' teacher-forced
     logits within 1e-3 of the unsharded model (as phase 4);
   - 25b: the same command in 2 processes under a torchrun environment
     (gloo, the card shared), one shard each, started once 25a's serve is
     done (beside the rest of phase 25 and phase 18, joined after it):
     tokens and page ids bit-equal to 25a's, each process L x decode
     steps K6 and L x requests K3 launches;
   - 25c: ``serve/cli.py --selftest`` on the card in a subprocess
     started after 25a's serve (joined after phase 18): ``serve
     selftest: OK`` and its K6 launches above 0; then, in that process,
     the ``SyntheticEngine`` fallback: 17a's ResNet-50 set served, its
     summary printed, no kernel launched.
   Phase 2 also times the paged decode at one shard's heads (Hq = Hkv =
   6) beside the unsharded row.  A time printed while other work ran on
   the card (15a beside 15b's subprocess, phase 18 beside 25b and 25c,
   25b beside phase 18) carries ``(the card shared with ...)``.  13b
   launches its processes by the reference's flags (``--multihost True
   --coordinator_address ... --num_processes 2 --process_id i``) instead
   of the torchrun environment.
26. A JSON line of per-kernel results (the fp32 flash rows also carry
   ``bound_fp32_cores_ms``, the CUDA-core bound, the bf16 flash rows
   ``max_ulps`` and ``share_apart``, their ``ms`` from CUDA graphs; the
   paged-decode row ``device_ms`` and ``host_ms``),
   the ``nvidia-smi`` name/power-limit line, and as the last line
   ``{"ok": true, "device": {...}}``.

Every phase prints its seconds, and the script its seconds from the
build on.  Exits non-zero, before printing any result, without a CUDA
device or outside a checkout of the repository; any failed phase
raises.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TOL_KERNEL = 1e-4
TOL_ENGINE = 1e-3
# kernel lane vs plain lane, one training step from one state
TOL_STEP_LOSS_REL = 1e-5
TOL_STEP_GNORM_REL = 1e-4
TOL_STEP_PARAM = 1e-6
TRAIN_STEPS = 6
GOSSIP_WORLD = 4
GOSSIP_STEPS = 3
GOSSIP_CHECKS = (("f32", 1), ("f32", 2), ("bf16", 1), ("bf16", 2),
                 ("int8", 1), ("int8", 2))
# the ResNet phase: ResNet-50 at full width, world 4 stacked, bench.py's
# per-chip batch of 128 split over the ranks
RESNET = dict(model="resnet50", num_classes=1000, image=224, batch=32,
              world=4, steps=4, gossip_every=2, global_avg_every=4,
              dtype="fp32")
# the CLI phase: run/gossip_sgd.py at ResNet-50's width, world 4 stacked,
# two epochs of three iterations (the training set is exactly three
# world batches)
CLI = dict(model="resnet50", image=224, num_classes=1000, world=4, batch=32,
           epochs=2, itrs=3)
PREEMPT_TIMEOUT_S = 300
# phase 9: ResNet-50 at the ResNet phase's width, unthinned and without
# periodic averaging, on the int8 wire with error feedback and faults
RESIL = dict(RESNET, gossip_every=1, global_avg_every=0)
RESIL_STEPS = 2
RESIL_FAULTS_LANES = "drop:0->1@0:2;seed:5"
RESIL_FAULTS_CLI = "drop:0->1@1:4;seed:5"
# ResNet-50's parameters a rank (torchvision's count)
RESIL_PAYLOAD = 25_557_032
# make_recovery_fn against a float64 Σx/Σw
TOL_RECOVERY = 1e-6
# phase 10: ResNet-50 at the ResNet phase's width, unthinned and without
# periodic averaging, over the hierarchical graph (slices of 2) and the
# planner's synthesized world-4 schedule on a fabric of slices of 2 with
# a cross-slice cost of 16 (psum, delegate edge, full edge)
TOPO = dict(RESNET, gossip_every=1, global_avg_every=0)
TOPO_STEPS = 2
SYNTH_FINGERPRINT = "b7e2ef83ed403b218f4f2f2ed6c019f7d194cca1"
# phase 11: the d768/L12 LM at world 8 stacked = dp 2 replicas x sp 4
# sequence shards, seq_len 4096 (1024-token shards), batch 2 a replica
# (16,384 tokens a step), every attention a ring of flash-kernel ticks;
# sp 4 because at sp 2 a ring turned the wrong way visits the same owners
SEQ = dict(dp=2, sp=4, seq_len=4096, batch=2, steps=3, cli_steps=4)
# remat against the step without it: equal, or within this much
TOL_REMAT = 1e-6
# H100 SXM data sheet: HBM rate, fp32 rate outside the tensor cores, TF32
# tensor-core rate (dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
# the flash kernels' 3xTF32 split: three tensor-core products per fp32 one,
# the card's best rate for fp32-accurate products
TF32_PASSES = 3
PEAK_3XTF32_FLOP_PER_S = PEAK_TF32_FLOP_PER_S / TF32_PASSES
# the bf16 tensor-core rate (dense), the bf16 flash kernels' bound
PEAK_BF16_FLOP_PER_S = 989e12
HEAD_DIM = 64
# phase 12: the same LM at bf16; 12a at phase 5's shape, 12b at phase
# 11's, 12c the CLI at world 4 (phase 6's shape)
BF16_STEPS = 6
BF16_CLI = dict(world=4, seq_len=1024, batch=8, steps=4)
# phase 15: run/gossip_lm.py at the LM's width, bf16, world 2 stacked,
# SGP on K2/K1, flash attention, T1024 B4 a rank; 15a (cut to 4 layers,
# 12 until phase 22 came) on a token file four steps' batches long, so
# its resume skips batches; 15b-15d (cut to 4 layers, 12 until phase 23
# came) run 12 steps on the repository's text, validated every 2, in a
# subprocess until SIGUSR1, then resumed in process
HARNESS = dict(world=2, seq_len=1024, batch=4, steps=4, preempt_steps=12,
               corpus=2 * 4 * 1024 * 4 + 1, val_frac=0.1, val_every=2,
               val_batches=2, a_layers=4, b_layers=4)
# the eval step's bf16 loss, kernels against plain twins (relative; the
# LM step parity tests' bf16 loss tolerance, tests/torch_lm_drive.py)
TOL_HARNESS_LOSS_REL = 2e-3


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _token_file(directory: str, n: int) -> str:
    """An ``.npy`` file of ``n`` token ids over the vocab-32000 LM's
    vocabulary from seed 0, for ``--corpus_file`` (the synthetic corpus
    would first draw a 32000 x 32000 table, 4.1 GB)."""
    import numpy as np

    path = os.path.join(directory, "tokens.npy")
    np.save(path, np.random.default_rng(0).integers(0, 32000, n).astype(
        np.int32))
    return path


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int, reps: int = 5) -> float:
    """Host time to issue one ``fn()``: the median over ``reps`` of the
    host clock around ``iters`` calls, synced before and after but not
    between them (the launch queue holds them, so no call waits on the
    device)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return statistics.median(times)


def _graph_ms(fns, replays: int) -> float:
    """Device time per call of ``fns``, with no host in the way: one CUDA
    graph holds one call of each (captured after a warm-up on a side
    stream), and CUDA events time its back-to-back replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * len(fns))


def _bound(nbytes: float, flops: float,
           flop_rate: float = PEAK_FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _shared(busy: str) -> str:
    """The mark on a printed timing taken while ``busy`` (other work, by
    name) ran on the card; empty when it had the card to itself."""
    return f" (the card shared with {busy})" if busy else ""


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def report_ptxas(built: dict) -> None:
    """Print ``-Xptxas -v``'s registers, shared memory and spills per
    kernel (mangled names, as ptxas gives them); a flash or paged-decode
    library without that report, or a kernel of theirs that spills, fails
    the run, and so does a flash library whose wgmma products ptxas
    serialized (warning C7520)."""
    for lib, info in built.items():
        kernel = lib
        checked = lib.startswith("flash") or lib == "paged_decode"
        if checked and "registers" not in info["log"]:
            raise AssertionError(f"no ptxas report for {lib}")
        if checked and "C7520" in info["log"]:
            raise AssertionError(f"ptxas serialized {lib}'s wgmma products: "
                                 + next(line for line in info["log"]
                                        .splitlines() if "C7520" in line))
        for line in info["log"].splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif "registers" in line or "spill" in line:
                print(f"build {lib} {kernel}: {line.split(':')[-1].strip()}",
                      flush=True)
                spills = re.findall(r"(\d+) bytes spill", line)
                if checked and any(int(x) for x in spills):
                    raise AssertionError(f"{kernel} spills: {line.strip()}")


# -- phase 2: kernels against their plain versions ---------------------------


def check_flash(card: str, cases=((1, 8, True), (1, 200, True),
                                  (1, 512, True), (1, 200, False),
                                  (8, 1024, True)),
                row_case=(1, 512, True)) -> dict:
    """The forward kernel against its plain version at each ``(b, t,
    causal)`` of ``cases`` (h12 d64); returns the JSON row of
    ``row_case`` (by default b1 t512, the longest prompt serving
    prefills)."""
    import torch
    import torch.nn.functional as F

    from stochastic_gradient_push_torch.ops.flash_attention import (
        flash_attention_reference, flash_fwd)

    g = torch.Generator(device="cuda").manual_seed(1)
    row = None
    for b, t, causal in cases:
        q, k, v = (torch.randn(b, 12, t, HEAD_DIM, device="cuda",
                               generator=g) for _ in range(3))
        ref, ref_lse = flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
        out, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        err = max(_max_err(flash_fwd(q, k, v, causal=causal), ref),
                  _max_err(out, ref))
        lse_err = _max_err(lse, ref_lse)
        if not (err <= TOL_KERNEL and lse_err <= TOL_KERNEL):
            raise AssertionError(f"flash_fwd b{b} t={t} causal={causal}: "
                                 f"max err {err} (out), {lse_err} (lse) "
                                 f"> {TOL_KERNEL}")
        ms = _time_ms(lambda: flash_fwd(q, k, v, causal=causal), 20)
        lse_ms = _time_ms(lambda: flash_fwd(q, k, v, causal=causal,
                                            return_lse=True), 20)
        plain_ms = _time_ms(
            lambda: flash_attention_reference(q, k, v, causal=causal), 5)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), 20)
        bh = b * 12
        pairs = t * (t + 1) // 2 if causal else t * t
        nbytes, flops = 4 * bh * t * HEAD_DIM * 4, 4 * bh * pairs * HEAD_DIM
        bound_ms, bound_by = _bound(nbytes, flops, PEAK_3XTF32_FLOP_PER_S)
        cores_ms = _bound(nbytes, flops)[0]
        print(f"kernel flash_fwd b{b} h12 t{t} d64 causal={causal}: max "
              f"err {err:.3e}, lse err {lse_err:.3e}, kernel {ms:.4f} ms "
              f"({lse_ms:.4f} ms with lse), plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, 3xTF32 bound {bound_ms:.4f} ms ({bound_by};"
              f" {bound_ms / ms:.1%} of it), fp32 CUDA-core bound "
              f"{cores_ms:.4f} ms [{card}]", flush=True)
        if (b, t, causal) == row_case:
            row = dict(max_abs_err=max(err, lse_err), ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms,
                       bound_fp32_cores_ms=cores_ms)
    return row


def check_flash_bwd(card: str, cases=((8, 1024, True), (1, 200, True),
                                      (1, 200, False)),
                    row_case=(8, 1024, True)) -> dict:
    """Both backward kernels against their plain versions, fed the
    forward kernel's out and lse (as the training step feeds them), at
    each ``(b, t, causal)`` of ``cases``; returns the JSON rows of
    ``row_case`` (by default the training main path's shape)."""
    import torch
    import torch.nn.functional as F

    from stochastic_gradient_push_torch.ops.flash_attention import (
        flash_bwd_dkv, flash_bwd_dkv_reference, flash_bwd_dq,
        flash_bwd_dq_reference, flash_fwd)

    g = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for b, t, causal in cases:
        q, k, v, do = (torch.randn(b, 12, t, HEAD_DIM, device="cuda",
                                   generator=g) for _ in range(4))
        out, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        delta = (do * out).sum(-1)
        args = (q, k, v, do, lse, delta, causal)
        dq_err = _max_err(flash_bwd_dq(*args), flash_bwd_dq_reference(*args))
        dkv_err = max(_max_err(a, r) for a, r in zip(
            flash_bwd_dkv(*args), flash_bwd_dkv_reference(*args)))
        if not (dq_err <= TOL_KERNEL and dkv_err <= TOL_KERNEL):
            raise AssertionError(f"flash_bwd b{b} t={t} causal={causal}: "
                                 f"max err dq {dq_err}, dk/dv {dkv_err} > "
                                 f"{TOL_KERNEL}")
        dq_ms = _time_ms(lambda: flash_bwd_dq(*args), 20)
        dkv_ms = _time_ms(lambda: flash_bwd_dkv(*args), 20)
        dq_plain = _time_ms(lambda: flash_bwd_dq_reference(*args), 5)
        dkv_plain = _time_ms(lambda: flash_bwd_dkv_reference(*args), 5)
        # library yardstick: SDPA forward + backward less its forward;
        # one call computes dq, dk and dv together
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))

        def sdpa_fb():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            torch.autograd.grad(o, (qs, ks, vs), do)

        def sdpa_f():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

        lib_ms = _time_ms(sdpa_fb, 20) - _time_ms(sdpa_f, 20)
        bh = b * 12
        pairs = t * (t + 1) // 2 if causal else t * t
        rows_in = 4 * bh * t * HEAD_DIM * 4 + 2 * bh * t * 4  # q k v do lse δ
        row_out = bh * t * HEAD_DIM * 4
        dq_work = (rows_in + row_out, 6 * bh * pairs * HEAD_DIM)
        dkv_work = (rows_in + 2 * row_out, 8 * bh * pairs * HEAD_DIM)
        dq_bound = _bound(*dq_work, PEAK_3XTF32_FLOP_PER_S)
        dkv_bound = _bound(*dkv_work, PEAK_3XTF32_FLOP_PER_S)
        dq_cores, dkv_cores = _bound(*dq_work)[0], _bound(*dkv_work)[0]
        print(f"kernel flash_bwd b{b} h12 t{t} d64 causal={causal}: dq max "
              f"err {dq_err:.3e}, kernel {dq_ms:.4f} ms, plain "
              f"{dq_plain:.4f} ms, 3xTF32 bound {dq_bound[0]:.4f} ms "
              f"({dq_bound[1]}; {dq_bound[0] / dq_ms:.1%} of it), fp32 "
              f"CUDA-core bound {dq_cores:.4f} ms; dk/dv max err "
              f"{dkv_err:.3e}, kernel {dkv_ms:.4f} ms, plain {dkv_plain:.4f} "
              f"ms, 3xTF32 bound {dkv_bound[0]:.4f} ms ({dkv_bound[1]}; "
              f"{dkv_bound[0] / dkv_ms:.1%} of it), fp32 CUDA-core bound "
              f"{dkv_cores:.4f} ms; sdpa backward {lib_ms:.4f} ms [{card}]",
              flush=True)
        if (b, t, causal) == row_case:
            rows["flash_bwd_dq"] = dict(
                max_abs_err=dq_err, ms=dq_ms, plain_ms=dq_plain,
                bound_ms=dq_bound[0], bound_by=dq_bound[1],
                library_ms=lib_ms, bound_fp32_cores_ms=dq_cores)
            rows["flash_bwd_dkv"] = dict(
                max_abs_err=dkv_err, ms=dkv_ms, plain_ms=dkv_plain,
                bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
                library_ms=lib_ms, bound_fp32_cores_ms=dkv_cores)
    return rows


def _paged_case(g, hq: int, hkv: int, batch=16, page=16, max_pages=48,
                num_pages=1024, layers=12):
    """A full-size cache ([layers, hkv, num_pages + 1, page, d], as the
    engine holds it), distinct random page ids per row (non-contiguous),
    random lengths in [1, max_pages * page] including both ends."""
    import torch

    shape = (layers, hkv, num_pages + 1, page, HEAD_DIM)
    kc = torch.randn(shape, device="cuda", generator=g)
    vc = torch.randn(shape, device="cuda", generator=g)
    q = torch.randn(batch, hq, HEAD_DIM, device="cuda", generator=g)
    pi = torch.stack([torch.randperm(num_pages, device="cuda",
                                     generator=g)[:max_pages]
                      for _ in range(batch)]).to(torch.int32)
    lengths = torch.randint(1, max_pages * page + 1, (batch,), device="cuda",
                            generator=g, dtype=torch.int32)
    lengths[0], lengths[1] = 1, max_pages * page
    return q, kc, vc, pi, lengths


def check_paged(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from stochastic_gradient_push_torch.serve.paged_attention import (
        paged_attention_reference, paged_decode)

    g = torch.Generator(device="cuda").manual_seed(2)
    row = None
    # the engine's shape, GQA, and one of 2 KV-head shards' (phase 25)
    for hq, hkv in ((12, 12), (12, 6), (6, 6)):
        q, kc, vc, pi, lengths = _paged_case(g, hq, hkv)
        layers = kc.shape[0]
        err = max(_max_err(paged_decode(q, kc[i], vc[i], pi, lengths),
                           paged_attention_reference(q, kc[i], vc[i], pi,
                                                     lengths))
                  for i in range(layers))
        if not err <= TOL_KERNEL:
            raise AssertionError(f"paged_decode Hq{hq} Hkv{hkv}: max err "
                                 f"{err} > {TOL_KERNEL}")
        # each timed call reads the next layer's pool, as a decode tick
        # does, so the 50 MB L2 does not hold the previous call's pages
        it = iter(range(10 ** 9))

        def kern():
            i = next(it) % layers
            paged_decode(q, kc[i], vc[i], pi, lengths)

        def plain():
            i = next(it) % layers
            paged_attention_reference(q, kc[i], vc[i], pi, lengths)

        ms = _time_ms(kern, 10 * layers)
        host_ms = _host_ms(kern, 10 * layers)
        # the same calls without the host: one per layer in a CUDA graph
        device_ms = _graph_ms([
            lambda i=i: paged_decode(q, kc[i], vc[i], pi, lengths)
            for i in range(layers)], 10)
        plain_ms = _time_ms(plain, 2 * layers)
        # library yardstick: SDPA over the pages gathered beforehand
        b, t = q.shape[0], pi.shape[1] * kc.shape[3]
        idx = pi.long()
        kg = kc[0][:, idx].movedim(1, 0).reshape(b, hkv, t, HEAD_DIM)
        vg = vc[0][:, idx].movedim(1, 0).reshape(b, hkv, t, HEAD_DIM)
        if hq != hkv:
            kg = kg.repeat_interleave(hq // hkv, dim=1)
            vg = vg.repeat_interleave(hq // hkv, dim=1)
        mask = (torch.arange(t, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kg, vg, attn_mask=mask), 50)
        tokens = int(lengths.sum())
        nbytes = (2 * tokens * hkv * HEAD_DIM * 4 + 2 * q.numel() * 4
                  + pi.numel() * 4 + lengths.numel() * 4)
        bound_ms, bound_by = _bound(nbytes, 4 * tokens * hq * HEAD_DIM)
        print(f"kernel paged_decode B16 Hq{hq} Hkv{hkv} d64 page16 "
              f"max_pages48 ({tokens} cached tokens): max err {err:.3e}, "
              f"kernel {ms:.4f} ms ({device_ms:.4f} ms device, in a CUDA "
              f"graph; {host_ms:.4f} ms host to issue), plain "
              f"{plain_ms:.4f} ms, sdpa over gathered pages {lib_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) [{card}]", flush=True)
        if hq == hkv == 12:   # the engine's shape: group 1
            row = dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                       host_ms=host_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
    return row


def _lm_config(attn_impl: str = "full", **kw):
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)

    return TransformerConfig(vocab_size=32000, d_model=768, n_layers=12,
                             n_heads=12, d_ff=3072, attn_impl=attn_impl, **kw)


def _gossip_case(g, wire: str, ne: int, ranks: int, leaf_shapes=None,
                 n: int | None = None, chunk_elems: int | None = None):
    """Encoded parts ``[R, E, ...]`` of one transport bucket on the card:
    every leaf of ``leaf_shapes`` packed as the kernel lane packs them
    (int8 leaves padded to whole blocks, the bucket to the chunk
    layout), or one ragged payload of ``n``.  Random wire values."""
    import torch

    from stochastic_gradient_push_torch.ops import gossip_kernel as gk
    from stochastic_gradient_push_torch.parallel import collectives
    from stochastic_gradient_push_torch.parallel.wire import get_codec

    spec = get_codec(wire, 7 if n is not None and ne == 2 else 64
                     ).kernel_spec()
    lane = gk.KernelLane(chunk_elems=chunk_elems or gk.DEFAULT_CHUNK_ELEMS)
    if n is None:
        leaves = [torch.empty((ranks,) + s, device="meta")
                  for s in leaf_shapes]
        (bucket,) = collectives._transport_plan(leaves, spec, 1)
        n, length = collectives._bucket_len(bucket, spec, lane)
    else:
        length = gk.padded_len(spec, n, lane.chunk_elems)
    if wire == "int8":
        parts = (torch.randint(-127, 128, (ranks, ne, length // spec.block,
                                           spec.block), device="cuda",
                               generator=g, dtype=torch.int8),
                 torch.rand(ranks, ne, length // spec.block, device="cuda",
                            generator=g) * 0.02)
    else:
        x = torch.randn(ranks, ne, length, device="cuda", generator=g)
        parts = (x.to(torch.bfloat16) if wire == "bf16" else x,)
    acc = torch.randn(ranks, length, device="cuda", generator=g)
    return spec, lane, parts, acc, n


def _decode_add_ms(acc, recv, kind: str) -> float:
    """K1's function in PyTorch ops on the landed chunks: ``acc +
    recv[0].float() (+ recv[1].float())``, or the int8 dequantise-add
    ``acc + q.float() * scale`` an edge; one ``add`` at f32 on one edge."""
    import torch

    ne = recv[0].shape[1]
    if kind == "int8":
        q, scale = recv

        def fn():
            out = acc
            for e in range(ne):
                out = out + (q[:, e].float() * scale[:, e][..., None]
                             ).reshape(acc.shape)
            return out
    elif kind == "f32" and ne == 1:
        r0 = recv[0][:, 0].reshape(acc.shape)

        def fn():
            return torch.add(acc, r0)
    else:
        r = [recv[0][:, e].reshape(acc.shape) for e in range(ne)]

        def fn():
            out = acc
            for x in r:
                out = out + x.float()
            return out
    return _time_ms(fn, 10)


def check_gossip(card: str) -> dict:
    """K2 and K1 bit-equal to their plain versions on the full-width
    packed payload at world 4 and on ragged payloads, with times."""
    import torch

    from stochastic_gradient_push_torch.ops import gossip_kernel as gk
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lm import make_model

    g = torch.Generator(device="cuda").manual_seed(4)
    shapes = [tuple(p.shape) for p in make_model(_lm_config()).parameters()]
    per_rank = sum(math.prod(s) for s in shapes)
    rows = {}
    # the full-width cases, then the ragged ones (int8 block 64 at one
    # edge, block 7 at two)
    for i, (wire, ne) in enumerate(GOSSIP_CHECKS * 2):
        ragged = i >= len(GOSSIP_CHECKS)
        dests = build_schedule(NPeerDynamicDirectedExponentialGraph(
            GOSSIP_WORLD, peers_per_itr=ne)).perms[0]
        if ragged:
            spec, lane, parts, acc, n = _gossip_case(
                g, wire, ne, GOSSIP_WORLD, n=300, chunk_elems=128)
        else:
            spec, lane, parts, acc, n = _gossip_case(g, wire, ne,
                                                     GOSSIP_WORLD, shapes)

        def start():
            return gk.gossip_edge_start(parts, dests, spec, n_decoded=n,
                                        chunk_elems=lane.chunk_elems)

        handle = start()
        chunks = tuple(p.reshape(h.shape) for p, h in zip(parts,
                                                          handle.recv))
        plain_landed = gk.gossip_edge_start_reference(chunks, dests)
        out = gk.gossip_edge_wait(handle, acc)
        _, _, _, c, nb, _, _ = handle.meta
        plain_out = gk.gossip_edge_wait_reference(
            acc.reshape(GOSSIP_WORLD, nb, c), handle.recv, spec.kind
        ).reshape(acc.shape)
        torch.cuda.synchronize()
        label = (f"{wire}{'/block' + str(spec.block) if spec.block else ''}"
                 f" E{ne} R{GOSSIP_WORLD} n{n}")
        start_err = max(_max_err(a, b) for a, b in zip(handle.recv,
                                                        plain_landed))
        wait_err = _max_err(out, plain_out)
        if not all(torch.equal(a, b) for a, b in zip(handle.recv,
                                                      plain_landed)):
            raise AssertionError(f"gossip_edge_start {label}: landed bytes "
                                 f"differ from the plain version (max err "
                                 f"{start_err})")
        if not torch.equal(out, plain_out):
            raise AssertionError(
                f"gossip_edge_wait {label}: max err {wait_err}, want "
                f"bit-equal")
        if ragged:
            print(f"kernel gossip ragged {label}: start and wait bit-equal "
                  f"to plain [{card}]", flush=True)
            continue
        part_bytes = sum(p.numel() * p.element_size() for p in parts)
        acc_bytes = acc.numel() * 4
        start_ms = _time_ms(start, 10)
        start_plain = _time_ms(
            lambda: gk.gossip_edge_start_reference(chunks, dests), 3)
        # library yardstick: one index_select over the (rank, edge) rows
        # per wire part (one call for f32/bf16, two for int8's q and
        # scales)
        src = torch.tensor([int(dests[e].tolist().index(r)) * ne + e
                            for r in range(GOSSIP_WORLD) for e in range(ne)],
                           device="cuda")
        start_lib = _time_ms(lambda: [p.reshape(GOSSIP_WORLD * ne, -1)
                                      .index_select(0, src) for p in parts],
                             10)
        wait_ms = _time_ms(lambda: gk.gossip_edge_wait(handle, acc), 10)
        wait_plain = _time_ms(lambda: gk.gossip_edge_wait_reference(
            acc.reshape(GOSSIP_WORLD, nb, c), handle.recv, spec.kind), 3)
        # K1's function in PyTorch ops (one add at f32 on one edge)
        wait_lib = _decode_add_ms(acc.reshape(GOSSIP_WORLD, nb, c),
                                  handle.recv, spec.kind)
        sb = _bound(2 * part_bytes, 0)
        wb = _bound(2 * acc_bytes + part_bytes,
                    acc.numel() * ne * (2 if spec.kind == "int8" else 1))
        print(f"kernel gossip {label}: bit-equal; start {start_ms:.4f} ms, "
              f"plain {start_plain:.4f} ms, index_select {start_lib:.4f} "
              f"ms, bound {sb[0]:.4f} ms ({sb[1]}); wait {wait_ms:.4f} ms, "
              f"plain {wait_plain:.4f} ms, PyTorch decode-add "
              f"{wait_lib:.4f} ms, bound "
              f"{wb[0]:.4f} ms ({wb[1]}) [{card}]", flush=True)
        rows[(wire, ne)] = {
            "gossip_edge_start": dict(
                max_abs_err=start_err, ms=start_ms, plain_ms=start_plain,
                bound_ms=sb[0], bound_by=sb[1],
                library_ms=start_lib if spec.kind != "int8" else None),
            "gossip_edge_wait": dict(
                max_abs_err=wait_err, ms=wait_ms, plain_ms=wait_plain,
                bound_ms=wb[0], bound_by=wb[1], library_ms=wait_lib)}
        del handle, chunks, plain_landed, out, plain_out, parts, acc
        torch.cuda.empty_cache()
    if per_rank < 134_000_000:
        raise AssertionError(f"payload {per_rank} per rank, want the d768 "
                             f"LM's ~134.3 M")
    return rows


# -- phase 3: the serving main path -----------------------------------------


class _TimedEngine:
    """Host-clock totals of the engine's prefill (``start``) and decode
    (``step``) calls; both end in a device-to-host read, so the clock
    sees the device work."""

    def __init__(self, engine):
        self._engine = engine
        self.seconds = {"prefill": 0.0, "decode": 0.0}

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def start(self, prompt, budget_tokens):
        t0 = time.perf_counter()
        out = self._engine.start(prompt, budget_tokens)
        self.seconds["prefill"] += time.perf_counter() - t0
        return out

    def step(self, slots):
        t0 = time.perf_counter()
        out = self._engine.step(slots)
        self.seconds["decode"] += time.perf_counter() - t0
        return out


def main_path(card: str, params=None, label: str = "main"):
    """Phase 3 (17d with ``params``, a flax-layout tree): the engine over
    ``params`` (default the seed-0 init) serves 48 requests closed loop;
    returns ``(engine, requests, launches, params)``."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.models.convert import init_params
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.ops.flash_attention import flash_fwd
    from stochastic_gradient_push_torch.serve.bench import (
        run_bench, synthetic_requests)
    from stochastic_gradient_push_torch.serve.engine import (
        LMEngine, ServeConfig)
    from stochastic_gradient_push_torch.serve.paged_attention import (
        paged_decode)

    cfg = TransformerConfig(vocab_size=32000, d_model=768, n_layers=12,
                            n_heads=12, d_ff=3072)
    if params is None:
        params = init_params(cfg, seed=0)
    t0 = time.perf_counter()
    engine = LMEngine(params, ServeConfig(
        n_heads=12, page_size=16, num_pages=1024, max_seqs=16,
        max_pages_per_seq=48), device="cuda")
    torch.cuda.synchronize()

    def size(tree) -> int:
        return (sum(size(v) for v in tree.values())
                if isinstance(tree, dict) else int(np.size(tree)))

    print(f"{label}: engine d{cfg.d_model} L{cfg.n_layers} h{cfg.n_heads} "
          f"ff{cfg.d_ff} vocab{cfg.vocab_size} built in "
          f"{time.perf_counter() - t0:.2f} s; weights "
          f"{size(params) * 4 / 1e9:.3f} GB, KV pool "
          f"{2 * engine._kc.numel() * 4 / 1e9:.3f} GB", flush=True)
    requests = synthetic_requests(48, seed=0, vocab=256,
                                  prompt_tokens=(64, 512),
                                  new_tokens=(16, 128))
    timed = _TimedEngine(engine)
    flash_fwd.launches = paged_decode.launches = 0
    metrics, completions = run_bench(timed, requests)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                "paged_decode": paged_decode.launches}
    print(f"{label}: summarize " + json.dumps(metrics, sort_keys=True),
          flush=True)
    print(f"{label}: launches {json.dumps(launches)}; host time prefill "
          f"{timed.seconds['prefill']:.4f} s, decode "
          f"{timed.seconds['decode']:.4f} s of {metrics['elapsed_s']:.4f} s "
          f"[{card}]", flush=True)
    by_rid = {r.rid: r for r in requests}
    if len(completions) != len(requests):
        raise AssertionError(f"{len(completions)} of {len(requests)} "
                             f"requests completed")
    for c in completions:
        if len(c.tokens) != by_rid[c.rid].max_new_tokens:
            raise AssertionError(f"request {c.rid}: {len(c.tokens)} tokens,"
                                 f" wanted {by_rid[c.rid].max_new_tokens}")
    engine.pages.assert_quiescent()
    want = {"flash_fwd": cfg.n_layers * len(requests),
            "paged_decode": cfg.n_layers * metrics["decode_steps"]}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"launches {launches}, expected {want}")
    return engine, requests, launches, params


def engine_vs_dense(engine, requests, card: str, params) -> None:
    """Two requests decoded side by side through the kernels, each
    step's logits held against the dense model over ``params`` (a
    flax-layout tree; plain attention) fed the same tokens."""
    import torch

    from stochastic_gradient_push_torch.models.convert import (
        config_from_params, params_from_jax)
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerLM)

    dense_model = TransformerLM(config_from_params(params,
                                                   engine.config.n_heads))
    dense_model.load_state_dict(params_from_jax(params))
    dense_model.to(engine.device).eval()

    worst = 0.0
    reqs = requests[:2]
    n_new = 16
    runs = {}
    for r in reqs:
        slot, tok = engine.start(list(r.prompt), len(r.prompt) + n_new)
        runs[slot] = (r, [tok], [engine.last_logits.clone()])
    while any(len(toks) < n_new for _, toks, _ in runs.values()):
        step = engine.step(sorted(runs))
        for slot, tok in step.items():
            runs[slot][1].append(tok)
            runs[slot][2].append(engine.last_logits[slot].clone())
    for slot, (r, toks, logits) in runs.items():
        engine.finish(slot)
        seq = list(r.prompt) + toks[:-1]
        with torch.no_grad():
            want = dense_model(torch.tensor([seq], device=engine.device))[0]
        t = len(r.prompt)
        worst = max(worst, _max_err(logits[0], want[:t]))
        for j, lg in enumerate(logits[1:]):
            worst = max(worst, _max_err(lg, want[t + j]))
    engine.pages.assert_quiescent()
    print(f"engine vs dense: 2 requests x {n_new} tokens teacher-forced, "
          f"max |logit diff| {worst:.3e} (tolerance {TOL_ENGINE}) [{card}]",
          flush=True)
    if not worst <= TOL_ENGINE:
        raise AssertionError(f"engine logits off the dense model by {worst}")


# -- phase 5: the training main path ----------------------------------------


def _train_setup(attn_impl: str, world: int = 1, wire=None,
                 overlap: bool = False, staleness: int = 1, peers: int = 1,
                 buckets: int = 1, gossip_kernel=None, **model):
    """The training main path: the d768/L12 LM's step with SGP (or OSGP
    with ``overlap``) over the n-peer exponential graph at ``world``
    ranks stacked on the card; ``model`` sets more of the model's config
    (``dtype``, ``attn_lane``)."""
    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lm import (
        build_lm_train_step, make_model)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd

    cfg = _lm_config(attn_impl, **model)
    alg = sgp(build_schedule(NPeerDynamicDirectedExponentialGraph(
        world, peers_per_itr=peers)), StackedTransport(world),
        wire=get_codec(wire), overlap=overlap, staleness=staleness,
        gossip_kernel=gossip_kernel, gossip_buckets=buckets)
    tx = sgd(momentum=0.9, weight_decay=0.0)
    step = build_lm_train_step(
        make_model(cfg), alg, tx, LRSchedule(3e-2, 8, world,
                                             decay_schedule={}),
        itr_per_epoch=1000)
    return cfg, alg, tx, step


def train_path(card: str) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.ops.flash_attention import (
        flash_bwd_dkv, flash_bwd_dq, flash_fwd)
    from stochastic_gradient_push_torch.serve.paged_attention import (
        paged_decode)
    from stochastic_gradient_push_torch.train.lm import init_lm_state

    cfg, alg, tx, step = _train_setup("flash")
    _, _, _, plain_step = _train_setup("full")
    state = init_lm_state(cfg, alg, tx, 1, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, 8, 1024))).cuda() for _ in range(2))
        for _ in range(TRAIN_STEPS + 1)]
    n_params = sum(p[0].numel() for p in state.params.values())
    print(f"train: SGP world 1, d{cfg.d_model} L{cfg.n_layers} "
          f"h{cfg.n_heads} ff{cfg.d_ff} vocab{cfg.vocab_size} T1024 B8 fp32, "
          f"{n_params / 1e6:.2f}M params", flush=True)

    # one step on each lane from the same state
    k_state, k_m = step(state, *batches[0])
    p_state, p_m = plain_step(state, *batches[0])
    torch.cuda.synchronize()
    loss_k, loss_p = float(k_m["loss"][0]), float(p_m["loss"][0])
    gn_k, gn_p = float(k_m["grad_norm"][0]), float(p_m["grad_norm"][0])
    param_err = max(_max_err(k_state.params[n], p_state.params[n])
                    for n in k_state.params)
    del p_state, state
    print(f"train: kernel lane vs plain lane, one step: loss {loss_k:.6f} "
          f"vs {loss_p:.6f}, grad norm {gn_k:.6f} vs {gn_p:.6f}, max "
          f"|param diff| {param_err:.3e} (tolerances {TOL_STEP_LOSS_REL} "
          f"rel, {TOL_STEP_GNORM_REL} rel, {TOL_STEP_PARAM}) [{card}]",
          flush=True)
    if not (abs(loss_k - loss_p) <= TOL_STEP_LOSS_REL * abs(loss_p)
            and abs(gn_k - gn_p) <= TOL_STEP_GNORM_REL * abs(gn_p)
            and param_err <= TOL_STEP_PARAM):
        raise AssertionError("kernel-lane and plain-lane steps disagree")

    # the main path: kernel-lane steps, counters zeroed just before
    state = k_state
    flash_fwd.launches = flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = paged_decode.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for toks, tgts in batches[1:]:
        t0 = time.perf_counter()
        state, m = step(state, toks, tgts)
        losses.append(float(m["loss"][0]))   # waits for the step
        step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                "flash_bwd_dq": flash_bwd_dq.launches,
                "flash_bwd_dkv": flash_bwd_dkv.launches,
                "paged_decode": paged_decode.launches}
    med_ms = float(np.median(step_s)) * 1e3
    print(f"train: {TRAIN_STEPS} steps, losses "
          f"{json.dumps([round(x, 6) for x in losses])}, step ms "
          f"{json.dumps([round(x * 1e3, 2) for x in step_s])}, median "
          f"{med_ms:.2f} ms, {8 * 1024 / med_ms * 1e3:.1f} tokens/s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{card}]", flush=True)
    print(f"train: launches {json.dumps(launches)}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss {losses}")
    want = {"flash_fwd": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS, "paged_decode": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return launches, {"ms": med_ms, "tokens_per_s": 8 * 1024 / med_ms * 1e3}


class _Counter:
    """One kernel's launch count: the attribute ``attr`` of its wrapper
    ``fn`` (the flash wrappers count their fp32 and bf16 forms apart)."""

    def __init__(self, fn, attr: str = "launches"):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.fn, self.attr, n)


FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_BF16 = tuple(f"{n}_bf16" for n in FLASH)


def _counters():
    from stochastic_gradient_push_torch.ops import flash_attention
    from stochastic_gradient_push_torch.ops.gossip_kernel import (
        gossip_edge_start, gossip_edge_wait)
    from stochastic_gradient_push_torch.serve.paged_attention import (
        paged_decode)

    flash = {n: getattr(flash_attention, n) for n in FLASH}
    return {**{n: _Counter(fn) for n, fn in flash.items()},
            **{f"{n}_bf16": _Counter(fn, "launches_bf16")
               for n, fn in flash.items()},
            "paged_decode": _Counter(paged_decode),
            "gossip_edge_start": _Counter(gossip_edge_start),
            "gossip_edge_wait": _Counter(gossip_edge_wait)}


def gossip_train_path(card: str, label: str, wire: str, overlap: bool,
                      staleness: int, peers: int, buckets: int,
                      compare_steps: int) -> dict:
    """World 4 stacked on the card on the gossip kernel lane: steps from
    one state against the plain transport lane, then the main path."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
    from stochastic_gradient_push_torch.train.lm import init_lm_state

    kw = dict(world=GOSSIP_WORLD, wire=wire, overlap=overlap,
              staleness=staleness, peers=peers, buckets=buckets)
    cfg, alg, tx, step = _train_setup("flash", gossip_kernel=KernelLane(),
                                      **kw)
    _, plain_alg, _, plain_step = _train_setup("flash", **kw)
    if (alg.transport_kernel_name, plain_alg.transport_kernel_name) != (
            "pallas", "xla"):
        raise AssertionError("the two lanes did not resolve as asked")
    rng = np.random.default_rng(1)
    batches = [tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(GOSSIP_WORLD, 8, 1024))).cuda()
        for _ in range(2)) for _ in range(compare_steps + GOSSIP_STEPS)]
    state = init_lm_state(cfg, alg, tx, GOSSIP_WORLD, seed=0, device="cuda")
    print(f"train {label}: world {GOSSIP_WORLD} stacked, d{cfg.d_model} "
          f"L{cfg.n_layers} T1024 B8/rank, {wire} wire, peers {peers}, "
          f"buckets {buckets}, overlap {overlap} staleness {staleness}",
          flush=True)

    # the kernel lane and the plain transport lane from one state
    k_state, p_state = state, state
    for toks, tgts in batches[:compare_steps]:
        k_state, k_m = step(k_state, toks, tgts)
        p_state, p_m = plain_step(p_state, toks, tgts)
    torch.cuda.synchronize()
    weights = [(k_state.gossip.ps_weight, p_state.gossip.ps_weight)] + [
        (ks[1], ps[1]) for ks, ps in zip(k_state.gossip.in_flight,
                                         p_state.gossip.in_flight)]
    param_err = max(_max_err(k_state.params[n], p_state.params[n])
                    for n in k_state.params)
    fifo_err = max([_max_err(ks[0][n], ps[0][n])
                    for ks, ps in zip(k_state.gossip.in_flight,
                                      p_state.gossip.in_flight)
                    for n in ks[0]] or [0.0])
    loss_k, loss_p = k_m["loss"].tolist(), p_m["loss"].tolist()
    print(f"train {label}: kernel lane vs plain lane, {compare_steps} "
          f"step(s) from one state: losses {loss_k} vs {loss_p}; ps-weight "
          f"{k_state.gossip.ps_weight.tolist()} vs "
          f"{p_state.gossip.ps_weight.tolist()}; max |param diff| "
          f"{param_err:.3e}, in-flight {fifo_err:.3e} (tolerance "
          f"{TOL_STEP_PARAM}) [{card}]", flush=True)
    if not all(torch.equal(a, b) for a, b in weights):
        raise AssertionError(f"{label}: push-sum weights differ between "
                             f"the lanes")
    if not (param_err <= TOL_STEP_PARAM and fifo_err <= TOL_STEP_PARAM):
        raise AssertionError(f"{label}: params differ between the lanes")
    del p_state, state, plain_step
    torch.cuda.empty_cache()

    # the main path: kernel-lane steps, counters zeroed just before
    state = k_state
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for toks, tgts in batches[compare_steps:]:
        t0 = time.perf_counter()
        state, m = step(state, toks, tgts)
        losses.append(m["loss"].tolist())   # waits for the step
        step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    med_ms = float(np.median(step_s)) * 1e3
    tokens = GOSSIP_WORLD * 8 * 1024
    print(f"train {label}: {GOSSIP_STEPS} steps, losses per rank "
          f"{json.dumps([[round(x, 6) for x in r] for r in losses])}, step "
          f"ms {json.dumps([round(x * 1e3, 2) for x in step_s])}, median "
          f"{med_ms:.2f} ms, {tokens / med_ms * 1e3:.1f} tokens/s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{card}]", flush=True)
    print(f"train {label}: launches {json.dumps(launches)}", flush=True)
    if not all(np.isfinite(losses).ravel()):
        raise AssertionError(f"{label}: non-finite training loss {losses}")
    # post_step waits every launched bucket once per step: the head slot
    # it lands is the one just launched at staleness 1 (a synchronous
    # round waits at once too); at staleness >= 2 the head slot is a
    # plain share settled a step earlier, and the wait is the settle of
    # the slot launched this step
    landed = 1 if staleness == 1 else 0
    settled = 0 if staleness == 1 else 1
    attn = GOSSIP_WORLD * cfg.n_layers * GOSSIP_STEPS
    want = {"flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
            **dict.fromkeys(FLASH_BF16, 0),
            "paged_decode": 0, "gossip_edge_start": buckets * GOSSIP_STEPS,
            "gossip_edge_wait": buckets * (landed + settled) * GOSSIP_STEPS}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return launches


def _resnet_setup(cfg: dict, wire, overlap: bool, staleness: int,
                  peers: int, buckets: int, gossip_kernel=None,
                  push_sum: bool = True, error_feedback: bool = False,
                  faults: str | None = None, schedule=None):
    """ResNet SGP (or OSGP with ``overlap``; D-PSGD without
    ``push_sum``, unthinned) at ``cfg``'s size and dtype, thinned and
    averaged, over the n-peer exponential graph (or ``schedule``) at
    ``cfg["world"]`` ranks stacked on the card; SGP may carry error
    feedback and a fault plan (``faults``, the ``--inject_faults``
    grammar)."""
    import torch

    from stochastic_gradient_push_torch.algorithms import dpsgd, sgp
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd
    from stochastic_gradient_push_torch.train.step import (
        build_train_step, make_model)

    from stochastic_gradient_push_torch.resilience import parse_fault_spec

    world = cfg["world"]
    if schedule is None:
        schedule = build_schedule(NPeerDynamicDirectedExponentialGraph(
            world, peers_per_itr=peers))
    if push_sum:
        masks = None if faults is None else parse_fault_spec(
            faults).build_masks(schedule, gossip_every=cfg["gossip_every"])
        alg = sgp(schedule, StackedTransport(world), wire=get_codec(wire),
                  overlap=overlap, staleness=staleness,
                  gossip_kernel=gossip_kernel, gossip_buckets=buckets,
                  gossip_every=cfg["gossip_every"],
                  global_avg_every=cfg["global_avg_every"],
                  error_feedback=error_feedback, faults=masks)
    else:
        alg = dpsgd(schedule, StackedTransport(world), overlap=overlap,
                    staleness=staleness, gossip_kernel=gossip_kernel,
                    gossip_buckets=buckets,
                    global_avg_every=cfg["global_avg_every"])
    tx = sgd(momentum=0.9, weight_decay=1e-4, nesterov=True)
    norm = cfg.get("norm", "bn")
    model = make_model(cfg["model"], num_classes=cfg["num_classes"],
                       dtype={"fp32": torch.float32,
                              "bf16": torch.bfloat16}[cfg["dtype"]],
                       **({"norm_variant": norm} if norm != "bn" else {}))
    step = build_train_step(
        model, alg, tx, LRSchedule(0.1, cfg["batch"], world, warmup=True),
        itr_per_epoch=1000, num_classes=cfg["num_classes"])
    return model, alg, tx, step


def resnet_train_path(card: str, label: str, wire: str, overlap: bool,
                      staleness: int, peers: int, buckets: int,
                      compare_steps: int) -> dict:
    """The ResNet main path on the gossip kernel lane: steps from one
    state against the plain transport lane, then ``cfg["steps"]``
    kernel-lane steps with the launch counters zeroed just before."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.data.synthetic import (
        synthetic_classification)
    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
    from stochastic_gradient_push_torch.train.step import (
        init_train_state, replica_spread)

    cfg = RESNET
    world, batch, image = cfg["world"], cfg["batch"], cfg["image"]
    kw = dict(wire=wire, overlap=overlap, staleness=staleness, peers=peers,
              buckets=buckets)
    model, alg, tx, step = _resnet_setup(cfg, gossip_kernel=KernelLane(),
                                         **kw)
    _, plain_alg, _, plain_step = _resnet_setup(cfg, **kw)
    if (alg.transport_kernel_name, plain_alg.transport_kernel_name) != (
            "pallas", "xla"):
        raise AssertionError("the two lanes did not resolve as asked")
    images, labels = synthetic_classification(
        world * batch, num_classes=cfg["num_classes"], image_size=image,
        seed=0)
    x = torch.from_numpy(images.reshape(world, batch, image, image, 3)
                         ).cuda()
    y = torch.from_numpy(labels.reshape(world, batch)).cuda()
    del images
    state = init_train_state(model, alg, tx, world, seed=0, device="cuda")
    n_params = sum(p[0].numel() for p in state.params.values())
    print(f"resnet {label}: {cfg['model']} {image} px, {cfg['num_classes']} "
          f"classes, {n_params:,} params, world {world} stacked, batch "
          f"{batch}/rank, {cfg['dtype']}, {wire} wire, peers {peers}, buckets "
          f"{buckets}, overlap {overlap} staleness {staleness}, "
          f"gossip_every {cfg['gossip_every']}, global_avg_every "
          f"{cfg['global_avg_every']}", flush=True)

    # the kernel lane and the plain transport lane from one state, under
    # deterministic cuDNN so that both lanes' convolutions agree
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    k_state, p_state = state, state
    for _ in range(compare_steps):
        k_state, k_m = step(k_state, x, y)
        p_state, p_m = plain_step(p_state, x, y)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    weights = [(k_state.gossip.ps_weight, p_state.gossip.ps_weight)] + [
        (ks[1], ps[1]) for ks, ps in zip(k_state.gossip.in_flight,
                                         p_state.gossip.in_flight)]
    param_err = max(_max_err(k_state.params[n], p_state.params[n])
                    for n in k_state.params)
    fifo_err = max([_max_err(ks[0][n], ps[0][n])
                    for ks, ps in zip(k_state.gossip.in_flight,
                                      p_state.gossip.in_flight)
                    for n in ks[0]] or [0.0])
    print(f"resnet {label}: kernel lane vs plain lane, {compare_steps} "
          f"step(s) from one state: losses {k_m['loss'].tolist()} vs "
          f"{p_m['loss'].tolist()}; ps-weight "
          f"{k_state.gossip.ps_weight.tolist()} vs "
          f"{p_state.gossip.ps_weight.tolist()}; max |param diff| "
          f"{param_err:.3e}, in-flight {fifo_err:.3e} (tolerance "
          f"{TOL_STEP_PARAM}) [{card}]", flush=True)
    if not all(torch.equal(a, b) for a, b in weights):
        raise AssertionError(f"resnet {label}: push-sum weights differ "
                             f"between the lanes")
    if not (param_err <= TOL_STEP_PARAM and fifo_err <= TOL_STEP_PARAM):
        raise AssertionError(f"resnet {label}: params differ between the "
                             f"lanes")
    del p_state, state, plain_step
    torch.cuda.empty_cache()

    # the main path: kernel-lane steps, counters zeroed just before
    state = k_state
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    start, wait = counters["gossip_edge_start"], counters["gossip_edge_wait"]
    losses, step_s, fired, averaged = [], [], 0, 0
    for _ in range(cfg["steps"]):
        tick = state.gossip.phase
        launched = (start.launches, wait.launches)
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        losses.append(m["loss"].tolist())   # waits for the step
        step_s.append(time.perf_counter() - t0)
        fires = tick % cfg["gossip_every"] == 0
        fired += fires
        got = (start.launches - launched[0], wait.launches - launched[1])
        want = (buckets, buckets) if fires else (0, 0)
        if got != want:
            raise AssertionError(f"resnet {label}: tick {tick} launched "
                                 f"(start, wait) {got}, expected {want}")
        if (tick + 1) % cfg["global_avg_every"] == 0:
            averaged += 1
            fifo_w = [w for _, w in state.gossip.in_flight]
            if not (torch.equal(state.gossip.ps_weight,
                                torch.ones_like(state.gossip.ps_weight))
                    and not any(w.any() for w in fifo_w)):
                raise AssertionError(
                    f"resnet {label}: after the global average at tick "
                    f"{tick}: ps-weight {state.gossip.ps_weight.tolist()}, "
                    f"FIFO weights {[w.tolist() for w in fifo_w]}")
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    med_ms = float(np.median(step_s)) * 1e3
    spread = replica_spread(state, alg)
    print(f"resnet {label}: {cfg['steps']} steps, losses per rank "
          f"{json.dumps([[round(v, 6) for v in r] for r in losses])}, step "
          f"ms {json.dumps([round(v * 1e3, 2) for v in step_s])}, median "
          f"{med_ms:.2f} ms, {world * batch / med_ms * 1e3:.1f} images/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"{fired} rounds fired, {averaged} global averages (ps-weight "
          f"1.0 after each); replica_spread {json.dumps(spread)} [{card}]",
          flush=True)
    print(f"resnet {label}: launches {json.dumps(launches)}", flush=True)
    if not all(np.isfinite(losses).ravel()):
        raise AssertionError(f"resnet {label}: non-finite loss {losses}")
    want = {n: 0 for n in counters}
    want["gossip_edge_start"] = want["gossip_edge_wait"] = fired * buckets
    if launches != want or fired == 0 or averaged == 0:
        raise AssertionError(f"resnet {label}: launches {launches}, "
                             f"expected {want} ({fired} fired, {averaged} "
                             f"averages)")
    return launches


def resnet_norm_variants(card: str) -> dict:
    """7c: one bf16 ResNet-50 SGP step at world 4 stacked on the kernel
    lane for each of the reference's ``ProbeBatchNorm`` variants, from
    one state: ``folded`` leaves the running statistics bit-unchanged,
    ``bn16``'s loss is finite and printed beside ``bn``'s.  Returns the
    variants' launches."""
    import torch

    from stochastic_gradient_push_torch.data.synthetic import (
        synthetic_classification)
    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
    from stochastic_gradient_push_torch.train.step import init_train_state

    cfg = dict(RESNET, dtype="bf16")
    world, batch, image = cfg["world"], cfg["batch"], cfg["image"]
    images, labels = synthetic_classification(
        world * batch, num_classes=cfg["num_classes"], image_size=image,
        seed=0)
    x = torch.from_numpy(images.reshape(world, batch, image, image, 3)
                         ).cuda()
    y = torch.from_numpy(labels.reshape(world, batch)).cuda()
    del images
    counters = _counters()
    got, state, launches = {}, None, {n: 0 for n in counters}
    for norm in ("bn", "bn16", "folded"):
        model, alg, tx, step = _resnet_setup(
            dict(cfg, norm=norm), "f32", False, 1, 1, 1,
            gossip_kernel=KernelLane())
        if state is None:
            # the variants share their parameters' and buffers' names
            state = init_train_state(model, alg, tx, world, seed=0,
                                     device="cuda")
        before = {n: t.clone() for n, t in state.batch_stats.items()}
        for fn in counters.values():
            fn.launches = 0
        new, m = step(state, x, y)
        got[norm] = (m["loss"].float().cpu(), new)
        ran = {n: fn.launches for n, fn in counters.items()}
        if ran["gossip_edge_start"] != 1 or ran["gossip_edge_wait"] != 1:
            raise AssertionError(f"resnet 7c {norm}: launches {ran}")
        for n, v in ran.items():
            launches[n] += v
        if not torch.isfinite(got[norm][0]).all():
            raise AssertionError(f"resnet 7c {norm}: loss {got[norm][0]}")
        if norm == "folded" and not all(
                torch.equal(new.batch_stats[n], t)
                for n, t in before.items()):
            raise AssertionError("resnet 7c folded: the running statistics "
                                 "moved")
        if norm != "folded" and all(torch.equal(new.batch_stats[n], t)
                                    for n, t in before.items()):
            raise AssertionError(f"resnet 7c {norm}: the running statistics "
                                 f"did not move")
        del new
        torch.cuda.empty_cache()
    bn = got["bn"][0]
    print(f"resnet 7c: bf16 ResNet-50 SGP at world {world} stacked, one step "
          f"from one state a norm: losses bn {bn.tolist()}, bn16 "
          f"{got['bn16'][0].tolist()} (largest |difference| "
          f"{float((got['bn16'][0] - bn).abs().max()):.3e}), folded "
          f"{got['folded'][0].tolist()} (running statistics bit-unchanged: "
          f"True); K2/K1 one each a step [{card}]", flush=True)
    return launches


def _cli_argv(ckpt_dir: str, *extra: str, epochs: int | None = None):
    c = CLI
    return ["--model", c["model"], "--image_size", str(c["image"]),
            "--num_classes", str(c["num_classes"]), "--dataset", "synthetic",
            "--world_size", str(c["world"]), "--batch_size", str(c["batch"]),
            "--num_epochs", str(epochs or c["epochs"]),
            "--num_iterations_per_training_epoch", str(c["itrs"]),
            "--synthetic_samples", str(c["world"] * c["batch"] * c["itrs"]),
            "--num_itr_ignore", "1", "--print_freq", "1", "--seed", "0",
            "--verbose", "False", "--checkpoint_dir", ckpt_dir, *extra]


def _rank_files(ckpt_dir: str) -> list[dict]:
    import torch

    return [torch.load(os.path.join(ckpt_dir, f"checkpoint_r{r}_n"
                                    f"{CLI['world']}.ckpt"),
                       weights_only=True)["state"]
            for r in range(CLI["world"])]


def _flat(row: dict) -> dict:
    """Every tensor of a rank file's state, by a path name."""
    out = {f"params/{n}": t for n, t in row["params"].items()}
    out.update({f"opt_state/{n}": t for n, t in row["opt_state"].items()})
    out.update({f"batch_stats/{n}": t
                for n, t in row["batch_stats"].items()})
    out["ps_weight"] = row["gossip"]["ps_weight"]
    for k, slot in enumerate(row["gossip"]["in_flight"]):
        out[f"in_flight{k}/ps_weight"] = slot["ps_weight"]
        out.update({f"in_flight{k}/{n}": t
                    for n, t in slot["params"].items()})
    return out


def _cli_run(label: str, argv, card: str, module=None,
             world: int | None = None, busy: str = "") -> tuple[dict, dict]:
    """One in-process run of the CLI (at ``world``, default CLI's) with
    every counter zeroed just before: its launches and its result (its
    times marked as taken beside ``busy``, other work on the card)."""
    import torch

    from stochastic_gradient_push_torch.run import gossip_sgd

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = (module or gossip_sgd).main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    bt = result["batch_meter"]
    print(f"cli {label}: {wall:.2f} s in main (data, steps, validation, "
          f"checkpoints); step "
          f"(BT meter, {bt.count} timed steps) mean {bt.avg * 1e3:.2f} ms, "
          f"std {bt.std * 1e3:.2f} ms, "
          f"{(world or CLI['world']) * CLI['batch'] / bt.avg:.1f} images/s"
          f"{_shared(busy)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{json.dumps(launches)} [{card}]", flush=True)
    if "--trace_dir" in argv:
        # where main's seconds went, from the run's own host spans
        _, spans = _telemetry(f"cli {label}",
                              argv[argv.index("--trace_dir") + 1])
        print(f"cli {label}: {wall - sum(e['dur'] for e in spans) / 1e6:.2f}"
              f" s of main outside the spans (init, data set, the rest); "
              f"{_span_split(spans)}", flush=True)
    return launches, result


def _check_csv(path: str, label: str) -> None:
    """The rank-averaged CSV: the reference's header block and, per
    epoch, a row per iteration, the epoch's closing row and a
    validation row."""
    with open(path) as f:
        lines = f.read().splitlines()
    head = ["BEGIN-TRAINING", f"World-Size,{CLI['world']}",
            "Num-DLWorkers,8", f"Batch-Size,{CLI['batch']}",
            "Epoch,itr,BT(s),avg:BT(s),std:BT(s),NT(s),avg:NT(s),std:NT(s),"
            "DT(s),avg:DT(s),std:DT(s),Loss,avg:Loss,Prec@1,avg:Prec@1,"
            "Prec@5,avg:Prec@5,val"]
    if lines[:5] != head:
        raise AssertionError(f"cli {label}: CSV header {lines[:5]}")
    rows = [r.split(",") for r in lines[5:]]
    want = [(str(e), str(i)) for e in range(CLI["epochs"])
            for i in [*range(CLI["itrs"]), CLI["itrs"] - 1, -1]]
    if [tuple(r[:2]) for r in rows] != want or any(len(r) != 18
                                                   for r in rows):
        raise AssertionError(f"cli {label}: CSV rows {rows}")
    for r in rows:
        vals = [float(v) for v in r[2:]]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"cli {label}: non-finite CSV row {r}")
        if r[1] == "-1" and not 0.0 <= vals[-1] <= 100.0:
            raise AssertionError(f"cli {label}: validation value {r}")
    print(f"cli {label}: CSV {os.path.basename(path)}: header and "
          f"{len(rows)} rows as the reference writes them; last training "
          f"row {','.join(rows[-2][11:])}; validation top-1 {rows[-1][-1]}",
          flush=True)


def _assert_gossip_launches(label: str, launches: dict, per_step: int):
    steps = CLI["epochs"] * CLI["itrs"]
    want = {n: 0 for n in launches}
    want["gossip_edge_start"] = want["gossip_edge_wait"] = per_step * steps
    if launches != want:
        raise AssertionError(f"cli {label}: launches {launches}, expected "
                             f"{want} ({per_step} start and wait a step)")


def _telemetry(label: str, tdir: str, rank: int = 0,
               kinds=("run_meta", "comm")) -> tuple[list, list]:
    """A ``--trace_dir`` run's files of process ``rank``, checked with
    the port's own schema (the reference's reader needs jax): every
    event's envelope valid, its kind in the closed vocabulary and
    ``kinds`` among them; ``trace.json`` parsed, its complete spans'
    ``ts`` monotone.  Returns ``(events, spans)``."""
    from stochastic_gradient_push_torch.telemetry import (
        EVENT_KINDS, EVENTS_FILE, SCHEMA_VERSION, TRACE_FILE, _rank_file)
    from stochastic_gradient_push_torch.telemetry.registry import SEVERITIES

    with open(os.path.join(tdir, _rank_file(EVENTS_FILE, rank))) as f:
        events = [json.loads(line) for line in f if line.strip()]
    bad = [e for e in events
           if set(e) - {"step"} != {"v", "kind", "t", "rank", "severity",
                                    "data"}
           or e["v"] != SCHEMA_VERSION or e["kind"] not in EVENT_KINDS
           or e["severity"] not in SEVERITIES or e["rank"] != rank
           or not isinstance(e["data"], dict)]
    missing = set(kinds) - {e["kind"] for e in events}
    if bad or missing:
        raise AssertionError(f"{label}: events {bad[:3]} out of the "
                             f"schema, kinds {sorted(missing)} missing")
    with open(os.path.join(tdir, _rank_file(TRACE_FILE, rank))) as f:
        trace = json.load(f)["traceEvents"]
    spans = [e for e in trace if e["ph"] == "X"]
    ts = [e["ts"] for e in trace if e["ph"] != "M"]
    if ts != sorted(ts) or not all("dur" in e for e in spans):
        raise AssertionError(f"{label}: trace.json not monotone")
    return events, spans


def _span_split(spans) -> str:
    """Seconds a span name over a trace's complete spans."""
    tot = {}
    for e in spans:
        tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"] / 1e6
    return ", ".join(f"{n} {v:.2f} s" for n, v in tot.items())


def _check_cli_telemetry(label: str, tdir: str, launches: dict,
                         card: str) -> None:
    """8: the traced SGP run's files: plan, run_meta, comm and
    step_stats events; one ``train_step`` span a step; the final comm
    bytes equal to a ``CommModel`` built here from the plan's graph and
    ResNet-50's parameter count; the kernel lane stamped."""
    from stochastic_gradient_push_torch.telemetry import CommModel
    from stochastic_gradient_push_torch.topology import (TOPOLOGY_NAMES,
                                                         build_schedule)
    from stochastic_gradient_push_torch.train.step import make_model

    events, spans = _telemetry(f"cli {label}", tdir, kinds=(
        "plan", "run_meta", "comm", "step_stats"))
    steps = CLI["epochs"] * CLI["itrs"]
    plan = next(e["data"] for e in events if e["kind"] == "plan")
    meta = next(e["data"] for e in events if e["kind"] == "run_meta")
    comm = [e["data"] for e in events if e["kind"] == "comm"][-1]
    payload = 4 * sum(p.numel() for p in make_model(
        CLI["model"], num_classes=CLI["num_classes"]).parameters())
    model = CommModel.from_schedule(
        build_schedule(TOPOLOGY_NAMES[plan["topology"]](
            CLI["world"], peers_per_itr=plan["ppi"])), payload,
        global_avg_every=plan["global_avg_every"], gossip_kernel="pallas")
    n_steps = sum(e["name"] == "train_step" for e in spans)
    print(f"cli {label}: telemetry {len(events)} events "
          f"{sorted({e['kind'] for e in events})}, {n_steps} train_step "
          f"spans; comm {json.dumps(comm['bytes'])} after {comm['steps']} "
          f"steps, CommModel here {json.dumps(model.totals(steps))}; "
          f"run_meta gossip_kernel {meta['comm_model']['gossip_kernel']}, "
          f"payload {meta['comm_model']['payload_bytes']:,} B; host "
          f"spans: {_span_split(spans)} [{card}]", flush=True)
    if (n_steps != steps or comm["steps"] != steps
            or comm["bytes"] != model.totals(steps)
            or meta["comm_model"]["gossip_kernel"] != "pallas"
            or meta["comm_model"]["payload_bytes"] != payload):
        raise AssertionError(f"cli {label}: telemetry differs from the "
                             f"run: {meta}, {comm}")
    _assert_gossip_launches(label, launches, 1)


def _bilat_round_check(card: str) -> None:
    """One AD-PSGD round (``post_step``) on ResNet-50's parameters on the
    card against ``(x + x[partner]) * 0.5`` computed on the host."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.algorithms import adpsgd
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.topology import (
        DynamicBipartiteExponentialGraph, build_pairing_schedule)
    from stochastic_gradient_push_torch.train.state import sgd
    from stochastic_gradient_push_torch.train.step import (
        init_train_state, make_model)

    world = CLI["world"]
    pairing = build_pairing_schedule(DynamicBipartiteExponentialGraph(world))
    alg = adpsgd(pairing, StackedTransport(world))
    model = make_model(CLI["model"], num_classes=CLI["num_classes"])
    state = init_train_state(model, alg, sgd(), world, seed=0,
                             device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    params = {n: p + torch.randn(p.shape, generator=g, device="cuda")
              for n, p in state.params.items()}
    gstate = state.gossip.replace(phase=1)
    mixed, after = alg.post_step(params, gstate)
    torch.cuda.synchronize()
    row = pairing[1 % len(pairing)]
    bad = [n for n, p in params.items()
           if not np.array_equal(mixed[n].cpu().numpy(),
                                 (p.cpu().numpy() + p.cpu().numpy()[row])
                                 * np.float32(0.5))]
    print(f"cli adpsgd: one bilateral round on {len(params)} {CLI['model']} "
          f"tensors ({sum(p[0].numel() for p in params.values()):,} values a "
          f"rank), partners {row.tolist()}: {len(params) - len(bad)} of "
          f"{len(params)} bit-equal to the host's (x + x[partner]) * 0.5 "
          f"[{card}]", flush=True)
    if bad or after.phase != 2:
        raise AssertionError(f"cli adpsgd: round differs in {bad[:5]}")


def _preempt_check(tmp: str, card: str) -> None:
    """SIGUSR1 to a subprocess CLI run once it trains: exit 75, rank
    files with a drained FIFO."""
    import torch

    ckpt = os.path.join(tmp, "preempt")
    argv = _cli_argv(ckpt, "--overlap", "True", "--staleness", "2",
                     "--gossip_kernel", "pallas", epochs=50)
    env = dict(os.environ, PYTHONPATH=ROOT)
    log_path = os.path.join(tmp, "preempt.log")
    csv_path = os.path.join(ckpt, f"out_r0_n{CLI['world']}.csv")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "stochastic_gradient_push_torch.run.gossip_sgd", *argv],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                if time.perf_counter() - t0 > PREEMPT_TIMEOUT_S:
                    raise AssertionError("cli preempt: no training row")
                if os.path.exists(csv_path):
                    with open(csv_path) as f:
                        if len(f.read().splitlines()) >= 7:
                            break
                time.sleep(0.2)
            signalled = time.perf_counter() - t0
            proc.send_signal(signal.SIGUSR1)
            code = proc.wait(timeout=PREEMPT_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        tail = f.read()[-2000:]
    if code != 75:
        raise AssertionError(f"cli preempt: exit {code}, expected 75:\n"
                             f"{tail}")
    rows = _rank_files(ckpt)
    fifo = [t for row in rows for slot in row["gossip"]["in_flight"]
            for t in [slot["ps_weight"], *slot["params"].values()]]
    drained = len(fifo) > 0 and not any(bool(t.any()) for t in fifo)
    meta = json.loads(torch.load(os.path.join(
        ckpt, f"checkpoint_r0_n{CLI['world']}.ckpt"),
        weights_only=True)["meta"])
    print(f"cli preempt: SIGUSR1 at {signalled:.1f} s into the run, exit "
          f"{code} after {time.perf_counter() - t0:.1f} s; {len(rows)} rank "
          f"files at epoch {meta['epoch']} itr {meta['itr']}, step "
          f"{rows[0]['step']}, FIFO of {len(rows[0]['gossip']['in_flight'])} "
          f"slots drained: {drained} [{card}]", flush=True)
    if not drained or meta["itr"] < 1:
        raise AssertionError("cli preempt: the FIFO on disk is not drained")


def _traced(ckpt: str) -> list[str]:
    """A phase-8 run's telemetry flags: its files beside its
    checkpoints."""
    return ["--trace_dir", os.path.join(ckpt, "telemetry")]


def _s2d_stem_check(card: str) -> None:
    """The space-to-depth stem on the card equals the 7x7/2 stem on the
    same weights and images, in fp32 (TF32 off): each within 1e-5 of the
    output's scale from an fp64 run of the 7x7 stem."""
    import torch
    import torch.nn.functional as F

    from stochastic_gradient_push_torch.models.resnet import (
        Conv2d, s2d_stem_kernel, space_to_depth)

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(CLI["batch"], 3, CLI["image"], CLI["image"],
                    device="cuda", generator=g)
    k7 = torch.randn(64, 3, 7, 7, device="cuda", generator=g) * (
        2.0 / (64 * 49)) ** 0.5
    with torch.no_grad():
        want = F.conv2d(x, k7, stride=2, padding=3)
        conv = Conv2d(12, 64, 4, 1, padding=(2, 1)).cuda()
        conv.weight.copy_(s2d_stem_kernel(k7))
        got = conv(space_to_depth(x))
        exact = F.conv2d(x.double(), k7.double(), stride=2, padding=3)
    scale = float(exact.abs().max())
    errs = [float((t.double() - exact).abs().max()) for t in (got, want)]
    print(f"cli 8d: the s2d stem (4x4/1 over {tuple(space_to_depth(x).shape)}"
          f") vs the 7x7/2 stem on the same weights and images, fp32: "
          f"{tuple(got.shape)}, largest |difference| "
          f"{float((got - want).abs().max()):.3e}; from fp64 s2d "
          f"{errs[0]:.3e}, 7x7 {errs[1]:.3e} (bound {1e-5 * scale:.3e}, "
          f"1e-5 of the scale {scale:.3f}) [{card}]", flush=True)
    if got.shape != want.shape or max(errs) > 1e-5 * scale:
        raise AssertionError("cli 8d: the s2d stem is not the 7x7 stem")


def scan_cli(card: str, tmp: str, busy: str = "") -> list:
    """8d: the ResNet-50 CLI at world 4 with the s2d stem and
    ``--scan_steps 4`` on the kernel lane, one epoch of 6 steps at batch
    16 over phase 8's synthetic set (a warm-up single, a chunk of 4, a
    cap tail of 1), beside the same command at ``--scan_steps 1``, both
    under deterministic cuDNN (set by the caller): the CSV rows equal
    outside timing, the rank files within ``TOL_STEP_PARAM`` (expected
    bit-equal: the same kernels on the same inputs), K2/K1 launches
    equal.  Returns both runs' launches."""
    import torch

    from stochastic_gradient_push_torch.train import loop

    _s2d_stem_check(card)
    runs, files, chunks = {}, {}, {}
    for scan in (4, 1):
        ckpt = os.path.join(tmp, f"scan{scan}")
        sizes = []
        real = loop.Trainer._on_device

        def spy(self, a, sizes=sizes):
            out = real(self, a)
            if out.dtype.is_floating_point:
                sizes.append(out.shape[0] if out.dim() == 6 else 1)
            return out

        loop.Trainer._on_device = spy
        try:
            runs[scan], _ = _cli_run(f"8d scan_steps {scan}", _cli_argv(
                ckpt, "--gossip_kernel", "pallas", "--stem_s2d", "True",
                "--scan_steps", str(scan), "--batch_size", "16",
                "--num_iterations_per_training_epoch", "6", epochs=1), card,
                busy=busy)
        finally:
            loop.Trainer._on_device = real
        chunks[scan] = sizes
        files[scan] = ([_flat(r) for r in _rank_files(ckpt)],
                       _csv_outside_timing(os.path.join(
                           ckpt, f"out_r0_n{CLI['world']}.csv")))
        shutil.rmtree(ckpt, ignore_errors=True)
    (a, rows_a), (b, rows_b) = files[4], files[1]
    err = max(_max_err(x[n], y[n]) for x, y in zip(a, b) for n in x)
    exact = all(torch.equal(x[n], y[n]) for x, y in zip(a, b) for n in x)
    gossip = {s: (r["gossip_edge_start"], r["gossip_edge_wait"])
              for s, r in runs.items()}
    print(f"cli 8d: resnet50 with --stem_s2d True, {CLI['world']} ranks "
          f"stacked, K2/K1, 6 steps: device copies (the chunks, then the "
          f"validation batch) {chunks[4]} at --scan_steps 4, {chunks[1]} at "
          f"1; CSV rows equal outside timing: "
          f"{rows_a == rows_b}; rank files max |diff| {err:.3e}, exactly "
          f"equal: {exact} (tolerance {TOL_STEP_PARAM}); K2/K1 launches "
          f"{gossip} [{card}]", flush=True)
    # the epoch's copies, then the validation batch's
    if chunks[4] != [1, 4, 1, 1] or chunks[1] != [1] * 7:
        raise AssertionError(f"cli 8d: chunks {chunks}")
    if rows_a != rows_b or not err <= TOL_STEP_PARAM:
        raise AssertionError("cli 8d: --scan_steps 4 differs from 1")
    if gossip[4] != gossip[1] or gossip[4] != (6, 6):
        raise AssertionError(f"cli 8d: K2/K1 launches {gossip}")
    return [runs[4], runs[1]]


# 8d's child: the image set drawn in this process, deterministic cuDNN,
# scan_cli; its launches on the last line (sys.argv: root, tmp, card,
# the work beside it)
_P8D_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as c
c.set_matmul_flags()
c.install_synthetic_memo()
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
runs = c.scan_cli(sys.argv[3], sys.argv[2], busy=sys.argv[4])
print("RUN_8d " + json.dumps(runs), flush=True)
"""


class _ScanChild:
    """8d in a subprocess beside phase 8's runs after its timed SGP and
    D-PSGD ones: :meth:`join` prints its lines and returns its two runs'
    launches; :meth:`kill` ends it."""

    def __init__(self, card: str, tmp: str):
        self.log_path = os.path.join(tmp, "scan_8d.log")
        os.makedirs(os.path.join(tmp, "scan_8d"), exist_ok=True)
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _P8D_CHILD, ROOT,
             os.path.join(tmp, "scan_8d"), card,
             "phase 8's runs and preemption check"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=self.log, stderr=subprocess.STDOUT)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()

    def join(self) -> list:
        try:
            code = self.proc.wait(timeout=DIST_TIMEOUT_S)
        finally:
            self.kill()
        with open(self.log_path) as f:
            text = f.read()
        if code != 0:
            raise AssertionError(f"cli 8d: the subprocess exited {code}:\n"
                                 f"{text[-4000:]}")
        print("".join(x + "\n" for x in text.splitlines()
                      if x.startswith("cli 8d")), end="", flush=True)
        return _tagged(text, "RUN_8d")


def cli_path(card: str) -> tuple[dict, float]:
    """Phase 8: the training CLI at ResNet-50's width, every in-process
    run traced (``--trace_dir``; its host spans printed).  Returns the
    main runs' launches and the SGP run's mean ``BT`` (s)."""
    import threading

    import torch

    from stochastic_gradient_push_torch.run import gossip_sgd_adpsgd

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(ROOT, "build"))
    preempt = scan = None
    try:
        print(f"cli: run/gossip_sgd.py, {CLI['model']} {CLI['image']} px, "
              f"{CLI['num_classes']} classes, world {CLI['world']} stacked, "
              f"batch {CLI['batch']}/rank, fp32, {CLI['epochs']} epochs of "
              f"{CLI['itrs']} steps", flush=True)
        main_runs = []
        for label, extra in (("sgp", ["--metrics_every", "2"]),
                             ("dpsgd", ["--push_sum", "False"])):
            ckpt = os.path.join(tmp, label)
            launches, result = _cli_run(label, _cli_argv(
                ckpt, "--gossip_kernel", "pallas", *_traced(ckpt), *extra),
                card)
            if label == "sgp":
                flat_bt = result["batch_meter"].avg
                _check_cli_telemetry(label, os.path.join(ckpt, "telemetry"),
                                     launches, card)
            _assert_gossip_launches(label, launches, 1)
            _check_csv(os.path.join(ckpt, f"out_r0_n{CLI['world']}.csv"),
                       label)
            if len(_rank_files(ckpt)) != CLI["world"]:
                raise AssertionError(f"cli {label}: rank files missing")
            main_runs.append(launches)

        # the preemption check's subprocess runs beside the runs below
        # (its start, imports and init overlap them; the timed SGP and
        # D-PSGD runs above ran alone)
        failed = []

        def preempt_check():
            try:
                _preempt_check(tmp, card)
            except BaseException as e:  # noqa: BLE001 — raised below
                failed.append(e)

        preempt = threading.Thread(target=preempt_check,
                                   name="preempt_check")
        preempt.start()
        # 8d's subprocess too
        scan = _ScanChild(card, tmp)
        beside = "8d's subprocess and the preemption check"

        # D-PSGD: the kernel lane against the plain lane, two steps from
        # one state under deterministic cuDNN
        torch.backends.cudnn.deterministic = True
        try:
            lanes = {}
            for lane in ("pallas", "xla"):
                ckpt = os.path.join(tmp, f"lane_{lane}")
                _cli_run(f"dpsgd {lane} lane", _cli_argv(
                    ckpt, "--push_sum", "False", "--gossip_kernel", lane,
                    "--num_iterations_per_training_epoch", "2",
                    *_traced(ckpt), epochs=1), card, busy=beside)
                lanes[lane] = [_flat(r) for r in _rank_files(ckpt)]
            err = max(_max_err(a[n], b[n]) for a, b in zip(
                lanes["pallas"], lanes["xla"]) for n in a)
            exact = all(torch.equal(a[n], b[n]) for a, b in zip(
                lanes["pallas"], lanes["xla"]) for n in a)
            print(f"cli dpsgd: kernel lane vs plain lane, 2 steps from one "
                  f"state: max |diff| {err:.3e} over params, momentum and "
                  f"statistics (tolerance {TOL_STEP_PARAM}), exactly equal: "
                  f"{exact} [{card}]", flush=True)
            if not err <= TOL_STEP_PARAM:
                raise AssertionError("cli dpsgd: the lanes differ")

            # AD-PSGD: no gossip kernel (its check reads nothing else:
            # one epoch, no checkpoint), and one round exact
            ckpt = os.path.join(tmp, "adpsgd")
            launches, _ = _cli_run("adpsgd", _cli_argv(
                ckpt, "--graph_type", "1", "--train_fast", "True",
                *_traced(ckpt), epochs=1), card, module=gossip_sgd_adpsgd,
                busy=beside)
            if any(launches.values()):
                raise AssertionError(f"cli adpsgd: launches {launches}")
            _bilat_round_check(card)

            # resume equals continue: OSGP, staleness 2, kernel lane
            osgp = ("--overlap", "True", "--staleness", "2",
                    "--gossip_kernel", "pallas")
            straight = os.path.join(tmp, "straight")
            split = os.path.join(tmp, "split")
            for label, ckpt, epochs, resume in (
                    ("osgp straight", straight, 2, "False"),
                    ("osgp first epoch", split, 1, "False"),
                    ("osgp resumed", split, 2, "True")):
                launches, _ = _cli_run(label, _cli_argv(
                    ckpt, *osgp, "--resume", resume,
                    *_traced(os.path.join(ckpt, f"e{epochs}")),
                    epochs=epochs), card, busy=beside)
                main_runs.append(launches)
            a = [_flat(r) for r in _rank_files(straight)]
            b = [_flat(r) for r in _rank_files(split)]
            steps = [(r["step"], r["gossip"]["phase"])
                     for r in _rank_files(split)]
            err = max(_max_err(x[n], y[n]) for x, y in zip(a, b) for n in x)
            exact = all(torch.equal(x[n], y[n]) for x, y in zip(a, b)
                        for n in x)
            print(f"cli osgp: resumed vs straight after {CLI['epochs']} "
                  f"epochs (step, phase {steps[0]}): {len(a[0])} tensors a "
                  f"rank, exactly equal: {exact}, max |diff| {err:.3e} "
                  f"[{card}]", flush=True)
            if not exact:
                raise AssertionError("cli osgp: resume differs from "
                                     "continue")
        finally:
            torch.backends.cudnn.deterministic = False
        preempt.join()
        if failed:
            raise failed[0]
        main_runs += scan.join()
    finally:
        if preempt is not None:
            preempt.join()
        if scan is not None:
            scan.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return ({n: sum(run[n] for run in main_runs) for n in main_runs[0]},
            flat_bt)


# -- phase 9: error feedback, faults, health and recovery --------------------


def _nan_equal(a, b) -> bool:
    """Bit for bit outside NaN, NaN at the same positions."""
    import torch

    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan], b[~nan]))


def _edge_pair(parts, dests, spec, n: int, acc):
    """K2 then K1 on ``parts`` and ``acc``, and their plain twins on the
    chunk layout the start kernel moved: ``(handle, landed, out,
    plain)``, the landed parts' twins and the wait's twin."""
    from stochastic_gradient_push_torch.ops import gossip_kernel as gk

    handle = gk.gossip_edge_start(parts, dests, spec, n_decoded=n)
    _, _, rows, c, nb, _, _ = handle.meta
    pad = nb * rows if spec.kind == "int8" else nb * c
    chunked = tuple(gk._pad_rows(p, pad, 2).reshape(h.shape)
                    for p, h in zip(parts, handle.recv))
    landed = gk.gossip_edge_start_reference(chunked, dests)
    out = gk.gossip_edge_wait(handle, acc)
    ranks = acc.shape[0]
    plain = gk.gossip_edge_wait_reference(
        gk._pad_rows(acc, nb * c, 1).reshape(ranks, nb, c), handle.recv,
        spec.kind).reshape(ranks, nb * c)[:, :n]
    return handle, landed, out, plain


def _edge_times(handle, parts, dests, spec, n: int, acc) -> dict:
    """K2 and K1 times (CUDA events): ``start``/``wait`` on the parts
    and accumulator chunk-padded already, as the round packs them, and
    ``wrap_start``/``wrap_wait`` on them unpadded, the wrappers' pad
    copies included."""
    from stochastic_gradient_push_torch.ops import gossip_kernel as gk

    _, _, rows, c, nb, _, _ = handle.meta
    pad = nb * rows if spec.kind == "int8" else nb * c
    padded = tuple(gk._pad_rows(p, pad, 2) for p in parts)
    padded_acc = gk._pad_rows(acc, nb * c, 1)
    return {
        "start": _time_ms(lambda: gk.gossip_edge_start(
            padded, dests, spec, n_decoded=n), 10),
        "wait": _time_ms(lambda: gk.gossip_edge_wait(handle, padded_acc),
                         10),
        "wrap_start": _time_ms(lambda: gk.gossip_edge_start(
            parts, dests, spec, n_decoded=n), 10),
        "wrap_wait": _time_ms(lambda: gk.gossip_edge_wait(handle, acc), 10)}


def check_gossip_faults(card: str) -> None:
    """Phase 9d: K2 and K1 against their plain twins on ResNet-50's
    payload with a NaN-poisoned rank and dropped edges (masked as the
    round masks them), int8 and bf16."""
    import torch

    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)

    g = torch.Generator(device="cuda").manual_seed(9)
    world, n = RESIL["world"], RESIL_PAYLOAD
    dests = build_schedule(NPeerDynamicDirectedExponentialGraph(
        world)).perms[0]    # [1 edge, world]
    row = dests[0]
    corrupt = torch.tensor([0.0, 1.0, 0.0, 1.0], device="cuda")[:, None]
    keep = torch.tensor([1.0, 1.0, 0.0, 0.0], device="cuda")[:, None]
    for wire in ("int8", "bf16"):
        codec = get_codec(wire, 64)
        spec = codec.kernel_spec()
        msg = torch.randn(world, n, device="cuda", generator=g) * 0.05
        msg = msg.masked_fill(corrupt > 0, float("nan"))
        msg = msg.masked_fill(keep <= 0, 0.0)
        parts = tuple(p[:, None] for p in codec.encode(msg))
        acc = torch.randn(world, n, device="cuda", generator=g)
        handle, plain_landed, out, plain = _edge_pair(parts, dests, spec, n,
                                                      acc)
        torch.cuda.synchronize()
        landed_ok = all(_nan_equal(a, b)
                        for a, b in zip(handle.recv, plain_landed))
        wait_ok = _nan_equal(out, plain)
        raw = torch.equal(out.view(torch.int32), plain.view(torch.int32))
        recv_of = {int(row[r]): r for r in range(world)}
        nan_rows = [int(torch.isnan(out[d]).sum()) for d in range(world)]
        zero_ok = all(torch.equal(out[d], acc[d]) for d in range(world)
                      if recv_of[d] in (2, 3))
        print(f"kernel gossip faults {wire} E1 R{world} n{n}: rank 1 "
              f"NaN-poisoned, ranks 2 and 3 dropped (3 also poisoned): "
              f"start {'bit-equal' if landed_ok else 'DIFFERS'}, wait "
              f"{'bit-equal, NaN positions included' if wait_ok else 'DIFFERS'}"
              f" (NaN bits equal: {raw}); NaN per receiver {nan_rows}; "
              f"receivers of the dropped edges get exactly 0: {zero_ok} "
              f"[{card}]", flush=True)
        if not (landed_ok and wait_ok and zero_ok):
            raise AssertionError(f"gossip faults {wire}: the kernels differ "
                                 f"from their plain twins")
        # the kernels' times at this payload, and their bytes bounds
        part_bytes = sum(p.numel() * p.element_size() for p in parts)
        t = _edge_times(handle, parts, dests, spec, n, acc)
        sb = _bound(2 * part_bytes, 0)
        wb = _bound(2 * acc.numel() * 4 + part_bytes,
                    acc.numel() * (2 if wire == "int8" else 1))
        print(f"kernel gossip faults {wire} E1 R{world} n{n}: start "
              f"{t['start']:.4f} ms (bound {sb[0]:.4f} ms, {sb[1]}), wait "
              f"{t['wait']:.4f} ms (bound {wb[0]:.4f} ms, {wb[1]}), on "
              f"chunk-padded inputs as the round packs them; the wrappers "
              f"on unpadded ones, pad copies included: start "
              f"{t['wrap_start']:.4f} ms, wait {t['wrap_wait']:.4f} ms "
              f"[{card}]", flush=True)
        if nan_rows[int(row[1])] == 0 or any(
                nan_rows[d] for d in range(world) if recv_of[d] != 1):
            raise AssertionError(f"gossip faults {wire}: NaN landed at "
                                 f"{nan_rows}, expected at rank "
                                 f"{int(row[1])} only")
        del msg, parts, handle, plain_landed, acc, out, plain
        torch.cuda.empty_cache()


def resilience_lanes(card: str) -> dict:
    """Phase 9a: SGP on the int8 wire with error feedback and a fault
    plan at ResNet-50's width, two steps from one state on the kernel
    lane and on the plain lane under deterministic cuDNN."""
    import torch

    from stochastic_gradient_push_torch.data.synthetic import (
        synthetic_classification)
    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
    from stochastic_gradient_push_torch.train.step import init_train_state

    cfg = RESIL
    world, batch, image = cfg["world"], cfg["batch"], cfg["image"]
    kw = dict(wire="int8", overlap=False, staleness=1, peers=1, buckets=1,
              error_feedback=True, faults=RESIL_FAULTS_LANES)
    model, alg, tx, step = _resnet_setup(cfg, gossip_kernel=KernelLane(),
                                         **kw)
    _, plain_alg, _, plain_step = _resnet_setup(cfg, **kw)
    images, labels = synthetic_classification(
        world * batch, num_classes=cfg["num_classes"], image_size=image,
        seed=0)
    x = torch.from_numpy(images.reshape(world, batch, image, image, 3)
                         ).cuda()
    y = torch.from_numpy(labels.reshape(world, batch)).cuda()
    del images
    state = init_train_state(model, alg, tx, world, seed=0, device="cuda")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        p_state = state
        for _ in range(RESIL_STEPS):
            p_state, _ = plain_step(p_state, x, y)
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        k_state = state
        for _ in range(RESIL_STEPS):
            k_state, k_m = step(k_state, x, y)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
    finally:
        torch.backends.cudnn.deterministic = False
    kg, pg = k_state.gossip, p_state.gossip
    param_err = max(_max_err(k_state.params[n], p_state.params[n])
                    for n in k_state.params)
    res_err = max(_max_err(kg.ef_residual[n], pg.ef_residual[n])
                  for n in kg.ef_residual)
    exact = {
        "params": all(torch.equal(k_state.params[n], p_state.params[n])
                      for n in k_state.params),
        "residual": all(torch.equal(kg.ef_residual[n], pg.ef_residual[n])
                        for n in kg.ef_residual)}
    res_rms = math.sqrt(sum(float((r.float() ** 2).sum())
                            for r in kg.ef_residual.values())
                        / (world * sum(r[0].numel()
                                       for r in kg.ef_residual.values())))
    print(f"resilience lanes: {cfg['model']} {image} px, world {world}, "
          f"batch {batch}/rank, SGP int8 + error feedback, faults "
          f"{RESIL_FAULTS_LANES!r}, {RESIL_STEPS} steps from one state: "
          f"losses {k_m['loss'].tolist()}; ps-weight {kg.ps_weight.tolist()} "
          f"vs {pg.ps_weight.tolist()}; max |param diff| {param_err:.3e}, "
          f"max |residual diff| {res_err:.3e} (tolerance {TOL_STEP_PARAM}); "
          f"exactly equal: {json.dumps(exact)}; residual rms {res_rms:.3e}; "
          f"launches {json.dumps(launches)} [{card}]", flush=True)
    if not torch.equal(kg.ps_weight, pg.ps_weight):
        raise AssertionError("resilience lanes: push-sum weights differ")
    if not (param_err <= TOL_STEP_PARAM and res_err <= TOL_STEP_PARAM):
        raise AssertionError("resilience lanes: params or residual differ")
    if not 0.0 < res_rms < 0.1:
        raise AssertionError(f"resilience lanes: residual rms {res_rms}")
    want = {n: 0 for n in launches}
    want["gossip_edge_start"] = want["gossip_edge_wait"] = RESIL_STEPS
    if launches != want:
        raise AssertionError(f"resilience lanes: launches {launches}, "
                             f"expected {want}")
    return launches


def resilience_cli(card: str, tmp: str) -> tuple[dict, str]:
    """Phase 9b: the CLI with OSGP, the int8 wire, error feedback, a
    fault plan, health lines and recovery at ResNet-50's width."""
    import contextlib
    import io

    ckpt = os.path.join(tmp, "resilience")
    tdir = os.path.join(tmp, "resilience_telemetry")
    argv = _cli_argv(ckpt, "--overlap", "True", "--staleness", "2",
                     "--wire_dtype", "int8", "--error_feedback", "True",
                     "--inject_faults", RESIL_FAULTS_CLI,
                     "--health_every", "3", "--residual_floor", "1e-9",
                     "--gossip_kernel", "pallas", "--verbose", "True",
                     "--trace_dir", tdir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launches, _ = _cli_run("resilience", argv, card)
    out = buf.getvalue()
    print("\n".join(line for line in out.splitlines()
                    if line.startswith("cli ") or "gossip " in line),
          flush=True)
    _assert_gossip_launches("resilience", launches, 1)
    health = [json.loads(line.split("gossip health: ", 1)[1])
              for line in out.splitlines() if "gossip health: " in line]
    recover = [json.loads(line.split("gossip recovery: ", 1)[1])
               for line in out.splitlines() if "gossip recovery: " in line]
    faults = [line.split("gossip faults: ", 1)[1]
              for line in out.splitlines() if "gossip faults: " in line]
    rms = [h.get("ef_residual_rms") for h in health]
    print(f"cli resilience: {len(health)} health lines, ef_residual_rms "
          f"{rms}, ps_mass_err {[h['ps_mass_err'] for h in health]}, "
          f"consensus_residual "
          f"{[h['consensus_residual'] for h in health]}; {len(recover)} "
          f"recovery lines {json.dumps(recover)}; faults {faults} [{card}]",
          flush=True)
    if not health or not all(r is not None and math.isfinite(r)
                             and r < 0.1 for r in rms):
        raise AssertionError(f"cli resilience: ef_residual_rms {rms}")
    if "push-sum-mass-leak" in out:
        raise AssertionError("cli resilience: a push-sum mass leak")
    if not any(e["action"] == "global-average" for e in recover):
        raise AssertionError("cli resilience: no global-average recovery")
    if len(faults) != 1:
        raise AssertionError(f"cli resilience: faults lines {faults}")
    # with --trace_dir the health and recovery lines come from the
    # telemetry's compatibility view: each once, the JSON of its event
    events, _ = _telemetry("cli resilience", tdir,
                           kinds=("plan", "health", "recovery"))
    typed = {k: [e["data"] for e in events if e["kind"] == k]
             for k in ("health", "recovery")}
    plans = [line for line in out.splitlines() if "gossip plan: " in line]
    print(f"cli resilience: telemetry {len(typed['health'])} health and "
          f"{len(typed['recovery'])} recovery events, their data the JSON "
          f"of the {len(health)} and {len(recover)} lines: "
          f"{typed == {'health': health, 'recovery': recover}}; "
          f"{len(plans)} plan line [{card}]", flush=True)
    if typed != {"health": health, "recovery": recover} or len(plans) != 1:
        raise AssertionError("cli resilience: the lines are not the "
                             "telemetry's events, once each")
    rows = _rank_files(ckpt)
    res_nonzero = all(any(bool(t.any()) for t in
                          r["gossip"]["ef_residual"].values()) for r in rows)
    fifo = [t for r in rows for slot in r["gossip"]["in_flight"]
            for t in [slot["ps_weight"], *slot["params"].values()]]
    drained = len(fifo) > 0 and not any(bool(t.any()) for t in fifo)
    print(f"cli resilience: {len(rows)} rank files, non-zero ef_residual: "
          f"{res_nonzero}, FIFO drained: {drained} [{card}]", flush=True)
    if not (res_nonzero and drained):
        raise AssertionError("cli resilience: rank files")
    _check_csv(os.path.join(ckpt, f"out_r0_n{CLI['world']}.csv"),
               "resilience")
    return launches, ckpt


def resilience_recovery(card: str, ckpt: str) -> None:
    """Phase 9c: ``make_recovery_fn`` on the CLI run's saved state on the
    card: every rank equal, the de-biased mean kept."""
    import torch

    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.resilience import make_recovery_fn
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)

    rows = _rank_files(ckpt)
    world = len(rows)

    def stack(get):
        return torch.stack([get(r) for r in rows]).cuda()

    params = {n: stack(lambda r, n=n: r["params"][n])
              for n in rows[0]["params"]}
    ps = stack(lambda r: r["gossip"]["ps_weight"])
    # a pending share in the FIFO (the saved one is drained): a quarter
    # of each rank's weight and params in flight
    fifo = tuple(({n: p * 0.25 for n, p in params.items()}, ps * 0.25)
                 for _ in rows[0]["gossip"]["in_flight"])
    alg = sgp(build_schedule(NPeerDynamicDirectedExponentialGraph(world)),
              StackedTransport(world), overlap=True, staleness=len(fifo))
    tot_w = ps.double().sum() + sum(w.double().sum() for _, w in fifo)
    want = {n: (p.double().sum(0) + sum(f[n].double().sum(0)
                                        for f, _ in fifo)) / tot_w
            for n, p in params.items()}
    out, w, drained = make_recovery_fn(alg)(params, ps, fifo)
    torch.cuda.synchronize()
    spread = max(float((p - p[:1]).abs().max()) for p in out.values())
    err = max(float((out[n][0].double() - want[n]).abs().max()
                    / max(1.0, float(want[n].abs().max()))) for n in out)
    ones = bool(torch.equal(w, torch.ones_like(w)))
    empty = not any(bool(t.any()) for f, fw in drained
                    for t in [fw, *f.values()])
    print(f"resilience recovery: make_recovery_fn on the CLI run's state "
          f"(world {world}, {len(out)} tensors, a FIFO of {len(fifo)} "
          f"pending shares): replica spread {spread}, max |Σx/Σw - mean| "
          f"{err:.3e} (tolerance {TOL_RECOVERY}), ps-weight 1: {ones}, FIFO "
          f"drained: {empty} [{card}]", flush=True)
    if spread != 0.0 or not err <= TOL_RECOVERY or not ones or not empty:
        raise AssertionError("resilience recovery: not the exact average")


def resilience_path(card: str) -> dict:
    """Phase 9: error feedback, faults, health and recovery."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli_resil_", dir=os.path.join(ROOT,
                                                                  "build"))
    try:
        t0 = time.perf_counter()
        lanes = resilience_lanes(card)
        cli, ckpt = resilience_cli(card, tmp)
        resilience_recovery(card, ckpt)
        check_gossip_faults(card)
        print(f"resilience: phase 9 in {time.perf_counter() - t0:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {n: lanes[n] + cli[n] for n in lanes}


def wire_selftest_path(card: str) -> dict:
    """Phase 24: ``scripts/torch_wirecheck.py --selftest`` on the card
    (``parallel/wirecheck.py``), its stage 4 on the CUDA K2 and K1:
    every check passes and both kernels launched.  Returns the
    launches."""
    import contextlib
    import io

    from stochastic_gradient_push_torch.parallel import wirecheck

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        code = wirecheck.selftest("cuda")
    launches = {n: c.launches for n, c in counters.items()}
    print(f"wirecheck: exit {code}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} "
          f"[{card}]{err.getvalue()}", flush=True)
    if code != 0 or not (launches["gossip_edge_start"] > 0
                         and launches["gossip_edge_wait"] > 0):
        raise AssertionError("wirecheck: the selftest failed or its "
                             "kernel lane launched no K2/K1")
    return launches


# -- phase 10: hierarchical and synthesized rounds, the planner -------------


def _resnet_batch(cfg: dict):
    import torch

    from stochastic_gradient_push_torch.data.synthetic import (
        synthetic_classification)

    world, batch, image = cfg["world"], cfg["batch"], cfg["image"]
    images, labels = synthetic_classification(
        world * batch, num_classes=cfg["num_classes"], image_size=image,
        seed=0)
    x = torch.from_numpy(images.reshape(world, batch, image, image, 3)
                         ).cuda()
    y = torch.from_numpy(labels.reshape(world, batch)).cuda()
    return x, y


def _mass(gossip) -> float:
    """``Σw`` over the ranks, the in-flight shares' weights included."""
    total = gossip.ps_weight.double().sum()
    for slot in gossip.in_flight or ():
        total = total + slot[1].double().sum()
    return float(total)


def topology_lanes(card: str, label: str, schedule, steps: int, wire: str,
                   overlap: bool = False, staleness: int = 1,
                   error_feedback: bool = False, slices=None) -> dict:
    """Phases 10a/10b: ``steps`` ResNet-50 kernel-lane steps over
    ``schedule``, each held against the plain lane's step from the same
    state under deterministic cuDNN (a trajectory would hold the rounds'
    last-ulp differences, amplified by the next steps' gradients), the
    launch counters zeroed just before: ps-weight (and the EF residual)
    bit-equal, params within 1e-6, ``Σw`` (in-flight shares included)
    exactly the world, and with ``slices`` every slice's replicas
    identical after each step."""
    import torch

    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
    from stochastic_gradient_push_torch.train.step import init_train_state

    cfg = TOPO
    world = cfg["world"]
    kw = dict(wire=wire, overlap=overlap, staleness=staleness, peers=1,
              buckets=1, error_feedback=error_feedback, schedule=schedule)
    model, alg, tx, step = _resnet_setup(cfg, gossip_kernel=KernelLane(),
                                         **kw)
    _, plain_alg, _, plain_step = _resnet_setup(cfg, **kw)
    if (alg.transport_kernel_name, plain_alg.transport_kernel_name) != (
            "pallas", "xla"):
        raise AssertionError("the two lanes did not resolve as asked")
    x, y = _resnet_batch(cfg)
    k_state = init_train_state(model, alg, tx, world, seed=0,
                               device="cuda")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    weights_equal = res_equal = exact = True
    param_err, masses, same = 0.0, [], []
    try:
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        for _ in range(steps):
            p_state, _ = plain_step(k_state, x, y)
            k_state, k_m = step(k_state, x, y)
            kg, pg = k_state.gossip, p_state.gossip
            weights_equal &= torch.equal(kg.ps_weight, pg.ps_weight) and all(
                torch.equal(a[1], b[1])
                for a, b in zip(kg.in_flight or (), pg.in_flight or ()))
            res_equal &= kg.ef_residual is None or all(
                torch.equal(kg.ef_residual[n], pg.ef_residual[n])
                for n in kg.ef_residual)
            param_err = max([param_err] + [
                _max_err(k_state.params[n], p_state.params[n])
                for n in k_state.params])
            exact &= all(torch.equal(k_state.params[n], p_state.params[n])
                         for n in k_state.params)
            masses.append(_mass(kg))
            if slices is not None:
                same.append(all(
                    torch.equal(t[g[0]], t[r]) for g in slices for r in g
                    for t in [*k_state.params.values(), kg.ps_weight]))
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"topology {label}: {cfg['model']} {cfg['image']} px, world "
          f"{world}, batch {cfg['batch']}/rank, {wire} wire, EF "
          f"{error_feedback}, overlap {overlap} staleness {staleness}, "
          f"{steps} kernel-lane steps, each against the plain lane from "
          f"its state: losses {k_m['loss'].tolist()}; ps-weight "
          f"{k_state.gossip.ps_weight.tolist()}, bit-equal {weights_equal}; "
          f"EF residual bit-equal {res_equal}; max |param diff| "
          f"{param_err:.3e} (tolerance {TOL_STEP_PARAM}), exactly equal "
          f"{exact}; sum of weights with in-flight shares {masses}; "
          f"slices identical after each step {same or 'n/a'}; launches "
          f"{json.dumps(launches)} [{card}]", flush=True)
    if not weights_equal:
        raise AssertionError(f"topology {label}: push-sum weights differ")
    if not res_equal:
        raise AssertionError(f"topology {label}: EF residuals differ")
    if not param_err <= TOL_STEP_PARAM:
        raise AssertionError(f"topology {label}: params differ")
    if any(m != float(world) for m in masses):
        raise AssertionError(f"topology {label}: sum of weights {masses}")
    if slices is not None and not all(same):
        raise AssertionError(f"topology {label}: slice replicas differ")
    return launches


def topology_consensus(card: str, schedule) -> None:
    """Phase 10b: two cycles of the synthesized schedule's rounds alone,
    on the kernel lane, over a random tree of ResNet-50's shapes (seed
    10): the de-biased values reach the rank mean.  The grouped means
    are timed here too (CUDA events)."""
    import torch

    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
    from stochastic_gradient_push_torch.parallel import collectives
    from stochastic_gradient_push_torch.train.step import make_model
    from stochastic_gradient_push_torch.topology import (
        HierarchicalGraph, build_schedule)

    world = TOPO["world"]
    model = make_model(TOPO["model"], num_classes=TOPO["num_classes"],
                       dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(10)
    tree = {n: torch.randn((world,) + tuple(p.shape), device="cuda",
                           generator=g)
            for n, p in model.named_parameters()}
    want = {n: t.double().mean(0) for n, t in tree.items()}
    transport = collectives.StackedTransport(world)
    params, ps = tree, torch.ones(world, device="cuda")
    cycle = schedule.num_phases
    errs = []
    for r in range(2 * cycle):
        params, ps = collectives.mix_push_sum(params, ps, r, schedule,
                                              transport, kernel=KernelLane())
        if (r + 1) % cycle == 0:
            errs.append(max(float((params[n].double() / ps.double().reshape(
                (-1,) + (1,) * (params[n].dim() - 1)) - want[n]).abs().max())
                for n in params))
    torch.cuda.synchronize()
    n_values = sum(t[0].numel() for t in tree.values())
    leaves = list(tree.values()) + [ps]
    hsched = build_schedule(HierarchicalGraph(world, slice_size=2))
    intra_ms = _time_ms(lambda: collectives.intra_average(
        leaves, hsched, transport), 10)
    print(f"topology synth consensus: {len(tree)} leaves, {n_values:,} "
          f"values a rank, rounds alone on the kernel lane: max |x/w - "
          f"mean| after one cycle {errs[0]:.3e}, after two {errs[1]:.3e} "
          f"(tolerance {TOL_STEP_PARAM}); ps-weight {ps.tolist()}; the "
          f"grouped mean over the tree and the ps-weight (slices of 2) "
          f"{intra_ms:.4f} ms a round [{card}]", flush=True)
    if not errs[1] <= TOL_STEP_PARAM:
        raise AssertionError(f"topology synth: no consensus after two "
                             f"cycles ({errs})")


def topology_cli(card: str, tmp: str) -> dict:
    """Phase 10c: ``run/gossip_sgd.py`` at ResNet-50's width planning
    ``--topology synth`` (its fingerprint), resuming onto the same plan,
    and ``--topology auto`` (hierarchical, ``ps_mass_err`` 0)."""
    import contextlib
    import io

    fabric = ("--slice_size", "2", "--dcn_cost", "16",
              "--gossip_kernel", "pallas", "--verbose", "True")
    runs, plans = [], {}
    synth = os.path.join(tmp, "synth")
    for label, ckpt, extra in (
            ("synth", synth, ("--topology", "synth", "--num_epochs", "1")),
            ("synth resumed", synth, ("--topology", "synth", "--resume",
                                      "True", "--num_epochs", "2")),
            ("auto", os.path.join(tmp, "auto"),
             ("--topology", "auto", "--health_every", "3",
              "--num_epochs", "1"))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launches, _ = _cli_run(label, _cli_argv(ckpt, *fabric, *extra),
                                   card)
        out = buf.getvalue()
        print("\n".join(line for line in out.splitlines()
                        if line.startswith("cli ")
                        or "gossip health" in line
                        or "resumed" in line), flush=True)
        plan = [json.loads(line.split("gossip plan: ", 1)[1])
                for line in out.splitlines() if "gossip plan: " in line]
        if len(plan) != 1:
            raise AssertionError(f"cli {label}: plan lines {plan}")
        plans[label] = plan = plan[0]
        fp = (plan.get("synth") or {}).get("fingerprint")
        print(f"cli {label}: gossip plan {plan['topology']}, gap "
              f"{plan['gap']}, global_avg_every {plan['global_avg_every']}, "
              f"fingerprint {fp}; {plan['rationale']} [{card}]", flush=True)
        health = [json.loads(line.split("gossip health: ", 1)[1])
                  for line in out.splitlines() if "gossip health: " in line]
        if label.startswith("synth"):
            if fp != SYNTH_FINGERPRINT:
                raise AssertionError(f"cli {label}: fingerprint {fp}")
            # a cycle of psum, edge, edge: the edge rounds launch
            want = 2
        else:
            if plan["topology"] != "hierarchical":
                raise AssertionError(f"cli auto: planned {plan['topology']}")
            errs = [h["ps_mass_err"] for h in health]
            print(f"cli auto: {len(health)} health lines, ps_mass_err "
                  f"{errs} [{card}]", flush=True)
            if not health or any(e != 0.0 for e in errs):
                raise AssertionError(f"cli auto: ps_mass_err {errs}")
            want = CLI["itrs"]
        got = (launches["gossip_edge_start"], launches["gossip_edge_wait"])
        if got != (want, want) or sum(launches.values()) != 2 * want:
            raise AssertionError(f"cli {label}: launches {launches}, "
                                 f"expected {want} start and wait")
        runs.append(launches)
    stamped = _rank_meta(synth)["plan"]["synth"]["fingerprint"]
    if stamped != SYNTH_FINGERPRINT:
        raise AssertionError(f"cli synth: stamped fingerprint {stamped}")
    return {n: sum(r[n] for r in runs) for n in runs[0]}


def _rank_meta(ckpt_dir: str) -> dict:
    import torch

    return json.loads(torch.load(os.path.join(
        ckpt_dir, f"checkpoint_r0_n{CLI['world']}.ckpt"),
        weights_only=True)["meta"])


def topology_kernel_times(card: str) -> None:
    """Phase 10d: K2 and K1 at the hierarchical delegate round's shape
    (int8, one edge, four ranks, ranks 1 and 3 at weight 0) and at f32,
    over ResNet-50's payload: bit-equal to their twins, timed (CUDA
    events) beside their bytes bounds.  The kernel times take the parts
    and the accumulator in the chunk-padded layout the round packs them
    in; the wrapper times take them unpadded, as 9d does, so the
    wrappers' pad copies are in them.  The bound counts every row the
    kernels move; the one after the slash leaves the weight-0 rows
    out."""
    import torch

    from stochastic_gradient_push_torch.ops import gossip_kernel as gk
    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.topology import (
        HierarchicalGraph, build_schedule)

    world, n = TOPO["world"], RESIL_PAYLOAD
    inter = build_schedule(HierarchicalGraph(world, slice_size=2)
                           ).inter_schedule
    dests = inter.perms[0]     # [1 edge, world]
    w = torch.tensor(inter.edge_weights[0, 0], dtype=torch.float32,
                     device="cuda")[:, None]
    senders = int((w > 0).sum())
    g = torch.Generator(device="cuda").manual_seed(11)
    for wire in ("int8", "f32"):
        codec = get_codec(wire, 64)
        spec = codec.kernel_spec()
        msg = torch.randn(world, n, device="cuda", generator=g) * w
        parts = tuple(p[:, None] for p in codec.encode(msg))
        acc = torch.randn(world, n, device="cuda", generator=g)
        handle, landed, out, plain = _edge_pair(parts, dests, spec, n, acc)
        torch.cuda.synchronize()
        equal = (all(torch.equal(a, b) for a, b in zip(handle.recv, landed))
                 and torch.equal(out, plain))
        zero_rows = all(torch.equal(out[int(dests[0, r])],
                                    acc[int(dests[0, r])])
                        for r in range(world) if float(w[r]) == 0.0)
        part_bytes = sum(p.numel() * p.element_size() for p in parts)
        t = _edge_times(handle, parts, dests, spec, n, acc)
        _, _, _, c, nb, _, _ = handle.meta
        lib = _decode_add_ms(gk._pad_rows(acc, nb * c, 1).reshape(
            world, nb, c), handle.recv, spec.kind)
        ops = acc.numel() * (2 if wire == "int8" else 1)
        sb = _bound(2 * part_bytes, 0)
        wb = _bound(2 * acc.numel() * 4 + part_bytes, ops)
        frac = senders / world
        sb_need = _bound(2 * part_bytes * frac, 0)
        wb_need = _bound(2 * acc.numel() * 4 * frac + part_bytes * frac,
                         ops * frac)
        print(f"kernel gossip hierarchical {wire} E1 R{world} n{n} (ranks "
              f"1 and 3 at weight 0): start and wait bit-equal to their "
              f"twins {equal}, weight-0 rows land exactly 0 {zero_rows}; "
              f"start {t['start']:.4f} ms (bound {sb[0]:.4f} / "
              f"{sb_need[0]:.4f} ms, {sb[1]}), wait {t['wait']:.4f} ms "
              f"(bound {wb[0]:.4f} / {wb_need[0]:.4f} ms, {wb[1]}), "
              f"{'add' if wire == 'f32' else 'PyTorch dequantise-add'} "
              f"{lib:.4f} ms; wrappers "
              f"on unpadded inputs, pad copies included: start "
              f"{t['wrap_start']:.4f} ms, wait {t['wrap_wait']:.4f} ms "
              f"[{card}]", flush=True)
        if not (equal and zero_rows):
            raise AssertionError(f"gossip hierarchical {wire}: the kernels "
                                 f"differ from their twins")
        del msg, parts, handle, landed, acc, out, plain
        torch.cuda.empty_cache()


def topology_path(card: str) -> dict:
    """Phase 10: hierarchical and synthesized rounds and the planner at
    ResNet-50's width on the gossip kernel lane."""
    import torch

    from stochastic_gradient_push_torch.planner import (make_interconnect,
                                                        resolve_topology)
    from stochastic_gradient_push_torch.topology import (
        HierarchicalGraph, build_schedule)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli_topo_", dir=os.path.join(ROOT,
                                                                "build"))
    try:
        t0 = time.perf_counter()
        hsched = build_schedule(HierarchicalGraph(TOPO["world"],
                                                  slice_size=2))
        runs = [topology_lanes(card, "hierarchical sgp", hsched, TOPO_STEPS,
                               "int8", error_feedback=True,
                               slices=hsched.slice_groups)]
        torch.cuda.empty_cache()
        runs.append(topology_lanes(card, "hierarchical osgp", hsched,
                                   TOPO_STEPS, "int8", overlap=True,
                                   staleness=2, error_feedback=True))
        torch.cuda.empty_cache()
        for r in runs:
            _assert_topology_launches(r, TOPO_STEPS)
        plan = resolve_topology(TOPO["world"], topology="synth",
                                interconnect=make_interconnect(2, 16, None),
                                synth={})
        fp = (plan.synth or {}).get("fingerprint")
        print(f"topology synth: planned {plan.topology}, fingerprint {fp}, "
              f"phases {[ph['kind'] for ph in plan.synth['spec']['phases']]}",
              flush=True)
        if fp != SYNTH_FINGERPRINT:
            raise AssertionError(f"topology synth: fingerprint {fp}")
        ssched = build_schedule(plan.graph_class(TOPO["world"]))
        synth_run = topology_lanes(card, "synth sgp", ssched,
                                   ssched.num_phases, "f32")
        # psum, edge, edge: the two edge rounds launch
        _assert_topology_launches(synth_run, 2)
        runs.append(synth_run)
        torch.cuda.empty_cache()
        topology_consensus(card, ssched)
        torch.cuda.empty_cache()
        runs.append(topology_cli(card, tmp))
        torch.cuda.empty_cache()
        topology_kernel_times(card)
        print(f"topology: phase 10 in {time.perf_counter() - t0:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {n: sum(r[n] for r in runs) for n in runs[0]}


def _assert_topology_launches(launches: dict, rounds: int) -> None:
    want = {n: 0 for n in launches}
    want["gossip_edge_start"] = want["gossip_edge_wait"] = rounds
    if launches != want:
        raise AssertionError(f"topology: launches {launches}, expected "
                             f"{want} (one K2 and one K1 a launching round, "
                             f"none for a grouped mean)")


# -- phase 11: sequence parallelism, the flash kernels as ring ticks --------


def _seq_setup(lane: str, remat: bool, kernel_gossip: bool, dtype=None):
    """The d768/L12 LM with ``ring_flash`` attention (ticks on ``lane``)
    at dp x sp stacked on the card, computing in ``dtype`` (fp32 by
    default), SGP on the f32 wire over the n-peer exponential graph, one
    peer, one bucket, on the gossip kernel lane or the plain
    transport."""
    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.parallel.seq import StackedSeq
    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lm import (
        build_lm_train_step, make_model)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd

    dp = SEQ["dp"]
    cfg = _lm_config("ring_flash", attn_lane=lane, remat=remat,
                     **({} if dtype is None else {"dtype": dtype}))
    alg = sgp(build_schedule(NPeerDynamicDirectedExponentialGraph(
        dp, peers_per_itr=1)), StackedTransport(dp), wire=get_codec("f32"),
        gossip_kernel=KernelLane() if kernel_gossip else None)
    tx = sgd(momentum=0.9, weight_decay=0.0)
    step = build_lm_train_step(
        make_model(cfg), alg, tx, LRSchedule(3e-2, SEQ["batch"], dp,
                                             decay_schedule={}),
        itr_per_epoch=1000, seq=StackedSeq(SEQ["sp"]))
    return cfg, alg, tx, step


def _seq_want(cfg, steps: int) -> dict:
    """Launches of ``steps`` kernel-lane steps: one K3 a visible (shard,
    tick) pair per replica and layer, again under remat's recompute; one
    K4 and one K5 each, all in the form of ``cfg.dtype`` (none of the
    other); one K2 and one K1 a step."""
    sp = SEQ["sp"]
    visible = SEQ["dp"] * cfg.n_layers * sp * (sp + 1) // 2
    flash = dict(zip(FLASH, (visible * (2 if cfg.remat else 1) * steps,
                             visible * steps, visible * steps)))
    bf16 = str(cfg.dtype) == "torch.bfloat16"
    return {**{n: 0 if bf16 else c for n, c in flash.items()},
            **{f"{n}_bf16": c if bf16 else 0 for n, c in flash.items()},
            "paged_decode": 0,
            "gossip_edge_start": steps, "gossip_edge_wait": steps}


def _seq_diff(k_state, k_m, o_state, o_m) -> tuple[float, float, float]:
    """Largest relative loss and grad-norm differences over the replicas,
    and the largest absolute parameter difference."""
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())
    return (rel(k_m["loss"], o_m["loss"]),
            rel(k_m["grad_norm"], o_m["grad_norm"]),
            max(_max_err(k_state.params[n], o_state.params[n])
                for n in k_state.params))


def _seq_activation_gb(cfg, state, toks, tgts) -> float:
    """Peak memory above the resting state of one replica's forward and
    backward (the step runs the replicas one after another): what remat
    trades for a second forward.  The step's own peak is set by the
    gossip round's buffers instead."""
    import torch
    from torch.func import functional_call

    from stochastic_gradient_push_torch.parallel.seq import StackedSeq
    from stochastic_gradient_push_torch.train.lm import lm_loss, make_model

    z = {n: p[0].detach().requires_grad_(True)
         for n, p in state.params.items()}
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits = functional_call(make_model(cfg), z,
                             (toks[0], StackedSeq(SEQ["sp"])))
    loss = torch.stack([lm_loss(lg, y) for lg, y in zip(logits,
                                                          tgts[0])]).mean()
    del logits
    torch.autograd.grad(loss, list(z.values()))
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - rest) / 1e9


def _seq_timed(card: str, label: str, cfg, step, state, batches) -> dict:
    """The main path: kernel-lane steps with every counter zeroed just
    before, each step's launches checked, ending in the metrics' read."""
    import numpy as np
    import torch

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    want = _seq_want(cfg, 1)
    for toks, tgts in batches:
        before = {n: fn.launches for n, fn in counters.items()}
        t0 = time.perf_counter()
        state, m = step(state, toks, tgts)
        losses.append(m["loss"].tolist())   # waits for the step
        step_s.append(time.perf_counter() - t0)
        got = {n: fn.launches - before[n] for n, fn in counters.items()}
        if got != want:
            raise AssertionError(f"seq {label}: launches {got} a step, "
                                 f"expected {want}")
    launches = {n: fn.launches for n, fn in counters.items()}
    med_ms = float(np.median(step_s)) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = SEQ["dp"] * SEQ["batch"] * SEQ["seq_len"]
    print(f"seq {label}: {len(batches)} steps, losses per replica "
          f"{json.dumps([[round(x, 6) for x in r] for r in losses])}, step "
          f"ms {json.dumps([round(x * 1e3, 2) for x in step_s])}, median "
          f"{med_ms:.2f} ms, {tokens / med_ms * 1e3:.1f} tokens/s, peak "
          f"memory {peak:.2f} GB; launches a step {json.dumps(want)} "
          f"[{card}]", flush=True)
    if not all(np.isfinite(losses).ravel()):
        raise AssertionError(f"seq {label}: non-finite loss {losses}")
    return {"launches": launches, "peak_gb": peak, "ms": med_ms,
            "tokens_per_s": tokens / med_ms * 1e3}


def seq_lanes(card: str) -> tuple[dict, dict]:
    """11a and 11b: one step on the kernel lane, on the plain lane (plain
    ticks, plain transport) and with remat from one state; then three
    timed steps without and with remat from the kernel step's state."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.train.lm import init_lm_state

    dp, sp, b, t = SEQ["dp"], SEQ["sp"], SEQ["batch"], SEQ["seq_len"]
    cfg, alg, tx, step = _seq_setup("auto", False, True)
    _, plain_alg, _, plain_step = _seq_setup("plain", False, False)
    remat_cfg, _, _, remat_step = _seq_setup("auto", True, True)
    if (alg.transport_kernel_name, plain_alg.transport_kernel_name) != (
            "pallas", "xla"):
        raise AssertionError("seq: the two lanes did not resolve as asked")
    rng = np.random.default_rng(3)
    batches = [tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(dp, sp, b, t // sp))).cuda()
        for _ in range(2)) for _ in range(1 + SEQ["steps"])]
    state = init_lm_state(cfg, alg, tx, dp, seed=0, device="cuda")
    print(f"seq: world {dp * sp} stacked = dp {dp} x sp {sp}, d{cfg.d_model} "
          f"L{cfg.n_layers} h{cfg.n_heads} ff{cfg.d_ff} vocab{cfg.vocab_size} "
          f"T{t} ({t // sp}-token shards) B{b}/replica fp32, ring_flash, SGP "
          f"f32 wire, one peer, one bucket", flush=True)

    k_state, k_m = step(state, *batches[0])
    p_state, p_m = plain_step(state, *batches[0])
    torch.cuda.synchronize()
    loss_d, gn_d, param_d = _seq_diff(k_state, k_m, p_state, p_m)
    weights_equal = torch.equal(k_state.gossip.ps_weight,
                                p_state.gossip.ps_weight)
    print(f"seq 11a: kernel lane vs plain lane (plain ticks, plain "
          f"transport), one step from one state: losses "
          f"{k_m['loss'].tolist()} vs {p_m['loss'].tolist()}, grad norms "
          f"{k_m['grad_norm'].tolist()} vs {p_m['grad_norm'].tolist()}; "
          f"max rel loss diff {loss_d:.3e}, grad norm {gn_d:.3e}, max "
          f"|param diff| {param_d:.3e} (tolerances {TOL_STEP_LOSS_REL}, "
          f"{TOL_STEP_GNORM_REL}, {TOL_STEP_PARAM}); ps-weight equal "
          f"{weights_equal} [{card}]", flush=True)
    if not (loss_d <= TOL_STEP_LOSS_REL and gn_d <= TOL_STEP_GNORM_REL
            and param_d <= TOL_STEP_PARAM and weights_equal):
        raise AssertionError("seq 11a: kernel-lane and plain-lane steps "
                             "disagree")
    del p_state, plain_step
    torch.cuda.empty_cache()

    r_state, r_m = remat_step(state, *batches[0])
    torch.cuda.synchronize()
    diffs = _seq_diff(k_state, k_m, r_state, r_m)
    exact = (torch.equal(k_m["loss"], r_m["loss"])
             and torch.equal(k_m["grad_norm"], r_m["grad_norm"])
             and all(torch.equal(k_state.params[n], r_state.params[n])
                     for n in k_state.params))
    print(f"seq 11b: remat vs the kernel step, one step from one state: "
          f"{'exactly equal' if exact else 'not bit-equal'}; max rel loss "
          f"diff {diffs[0]:.3e}, grad norm {diffs[1]:.3e}, max |param "
          f"diff| {diffs[2]:.3e} (tolerance {TOL_REMAT}) [{card}]",
          flush=True)
    if max(diffs) > TOL_REMAT:
        raise AssertionError("seq 11b: remat changed the step")
    del r_state, state
    torch.cuda.empty_cache()

    plain = _seq_timed(card, "11a", cfg, step, k_state, batches[1:])
    torch.cuda.empty_cache()
    remat = _seq_timed(card, "11b remat", remat_cfg, remat_step, k_state,
                       batches[1:])
    torch.cuda.empty_cache()
    act = [_seq_activation_gb(c, k_state, *batches[0])
           for c in (cfg, remat_cfg)]
    print(f"seq 11b: peak memory a step {plain['peak_gb']:.2f} GB (11a) vs "
          f"{remat['peak_gb']:.2f} GB (remat), set by the gossip round's "
          f"buffers; one replica's forward and backward above the resting "
          f"state {act[0]:.2f} GB vs {act[1]:.2f} GB [{card}]", flush=True)
    if not (remat["peak_gb"] <= plain["peak_gb"] and act[1] < act[0]):
        raise AssertionError(f"seq 11b: remat peak {remat['peak_gb']:.2f} "
                             f"GB (a replica's pass {act[1]:.2f} GB) not "
                             f"below {plain['peak_gb']:.2f} GB "
                             f"({act[0]:.2f} GB)")
    return {n: plain["launches"][n] + remat["launches"][n]
            for n in plain["launches"]}, plain


def seq_cli(card: str) -> dict:
    """11c: ``run/gossip_lm.py`` at the same shape with remat on the
    kernel lanes, in process with every counter zeroed just before."""
    import contextlib
    import io

    import torch

    from stochastic_gradient_push_torch.run import gossip_lm

    dp, sp, b, t = SEQ["dp"], SEQ["sp"], SEQ["batch"], SEQ["seq_len"]
    n = SEQ["cli_steps"]
    # the run's tokens, CSV and final checkpoint (a file a replica)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="seq_cli_", dir=os.path.join(ROOT,
                                                               "build"))
    argv = ["--world_size", str(dp * sp), "--sp", str(sp), "--attn",
            "ring_flash", "--remat", "True", "--gossip_kernel", "pallas",
            "--vocab_size", "32000", "--d_model", "768", "--n_layers", "12",
            "--n_heads", "12", "--d_ff", "3072", "--seq_len", str(t),
            "--batch_size", str(b), "--num_steps", str(n), "--print_freq",
            "1", "--corpus_file", _token_file(ckpt, dp * b * t * n + 1),
            "--seed", "0"]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            result = gossip_lm.main(argv + ["--checkpoint_dir", ckpt])
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    lines = out.getvalue().splitlines()
    for line in lines:
        if line.startswith(("lm: ", "step,")) or line[:1].isdigit():
            print(f"seq 11c cli: {line}", flush=True)
    rows = [r.split(",") for r in lines[lines.index(
        "step,loss,ppl,lr,tokens_per_sec,grad_norm") + 1:]
        if r.split(",")[0].isdigit()]
    print(f"seq 11c cli: {wall:.2f} s in main, tokens/s "
          f"{result['tokens_per_sec']:.1f} over the run (the first step's "
          f"warm-up and the final save included), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{json.dumps(launches)} [{card}]", flush=True)
    if [r[0] for r in rows] != [str(i + 1) for i in range(n)] or not all(
            len(r) == 6 and all(math.isfinite(float(v)) for v in r)
            for r in rows):
        raise AssertionError(f"seq 11c: CSV rows {rows}")
    want = _seq_want(_lm_config("ring_flash", remat=True), n)
    if launches != want:
        raise AssertionError(f"seq 11c: launches {launches}, expected "
                             f"{want}")
    return launches


def seq_path(card: str) -> tuple[dict, dict]:
    """Phase 11: sequence-parallel LM training, dp 2 x sp 4 stacked, with
    K3-K5 as ring ticks and K2/K1 between the replicas.  Returns the main
    path's launches and 11a's timing."""
    import torch

    t0 = time.perf_counter()
    lanes, timed = seq_lanes(card)
    torch.cuda.empty_cache()
    cli = seq_cli(card)
    torch.cuda.empty_cache()
    # 11d: the tick kernels at the ticks' shape, diagonal and full
    tick = SEQ["seq_len"] // SEQ["sp"]
    print(f"seq 11d: the flash kernels at a ring tick's shape, b{SEQ['batch']}"
          f" h12 t{tick}", flush=True)
    cases = ((SEQ["batch"], tick, True), (SEQ["batch"], tick, False))
    check_flash(card, cases, row_case=None)
    check_flash_bwd(card, cases, row_case=None)
    print(f"seq: phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)
    return {n: lanes[n] + cli[n] for n in lanes}, timed


# -- phase 12: the LM at bf16 ------------------------------------------------


def check_flash_bf16(card: str, cases, row_case=None) -> dict:
    """12d: the bf16 forms of K3, K4 and K5 against their plain versions
    on the same bf16 inputs at each ``(b, t, causal)`` of ``cases`` (h12
    d64), fed as the training step feeds them (the backward takes the
    forward kernel's out and lse): element by element in bf16 ulps
    (``bf16_close``: one ulp of max(|plain|, TOL_BF16_FLOOR of the
    largest |plain|), at most TOL_BF16_SHARE of the elements apart), lse
    (fp32) within TOL_KERNEL.
    Each is timed from CUDA-graph replays (``_graph_ms``; events around
    back-to-back calls printed beside it) against its plain version, SDPA
    at bf16 (forward and backward from graphs too) and its bound (bf16
    rows, fp32 lse/delta, at the bf16 tensor-core rate), and K4 + K5
    against SDPA's backward.  Returns the JSON rows of ``row_case``."""
    import torch
    import torch.nn.functional as F

    from stochastic_gradient_push_torch.ops.flash_attention import (
        TOL_BF16_SHARE, TOL_BF16_ULPS, bf16_mismatch,
        flash_attention_reference, flash_bwd_dkv, flash_bwd_dkv_reference,
        flash_bwd_dq, flash_bwd_dq_reference, flash_fwd)

    g = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for b, t, causal in cases:
        q, k, v, do = (torch.randn(b, 12, t, HEAD_DIM, device="cuda",
                                   generator=g).bfloat16() for _ in range(4))
        ref, ref_lse = flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
        out, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        if out.dtype != torch.bfloat16 or lse.dtype != torch.float32:
            raise AssertionError(f"flash_fwd bf16: out {out.dtype}, lse "
                                 f"{lse.dtype}")
        lse_err = _max_err(lse, ref_lse)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, causal)
        pairs = {"flash_fwd_bf16": [(out, ref), (flash_fwd(
                     q, k, v, causal=causal), ref)],
                 "flash_bwd_dq_bf16": [(flash_bwd_dq(*args),
                                        flash_bwd_dq_reference(*args))],
                 "flash_bwd_dkv_bf16": list(zip(
                     flash_bwd_dkv(*args), flash_bwd_dkv_reference(*args)))}
        # per kernel: (worst ulps, largest share apart, max abs error)
        err = {}
        for name, ps in pairs.items():
            m = [bf16_mismatch(a, r) for a, r in ps]
            err[name] = (max(u for u, _ in m), max(sh for _, sh in m),
                         max(_max_err(a, r) for a, r in ps))
        err["flash_fwd_bf16"] = (*err["flash_fwd_bf16"][:2], max(
            err["flash_fwd_bf16"][2], lse_err))
        print(f"kernel bf16 b{b} h12 t{t} d64 causal={causal}: worst ulps, "
              f"share apart: " + ", ".join(
                  f"{n} {u:.3g} {sh:.3e}" for n, (u, sh, _) in err.items()) +
              f" (tolerance {TOL_BF16_ULPS} ulp, {TOL_BF16_SHARE:.0%}); lse "
              f"{lse_err:.3e} (tolerance {TOL_KERNEL}) [{card}]", flush=True)
        bad = [n for n, (u, sh, _) in err.items()
               if u > TOL_BF16_ULPS or sh > TOL_BF16_SHARE]
        if bad or lse_err > TOL_KERNEL:
            raise AssertionError(f"flash bf16 b{b} t={t} causal={causal}: "
                                 f"{bad} apart from the plain version "
                                 f"{ {n: err[n][:2] for n in bad} } or lse "
                                 f"{lse_err} (> {TOL_KERNEL})")
        # the kernels and SDPA's forward from CUDA-graph replays (near
        # 0.05 ms, events around back-to-back wrapper calls time the host);
        # the events figure beside it, as earlier runs timed them
        kern = {"flash_fwd_bf16": lambda: flash_fwd(
                    q, k, v, causal=causal, return_lse=True),
                "flash_bwd_dq_bf16": lambda: flash_bwd_dq(*args),
                "flash_bwd_dkv_bf16": lambda: flash_bwd_dkv(*args),
                "sdpa_fwd": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)}
        graph = {n: _graph_ms([fn], 20) for n, fn in kern.items()}
        events = {n: _time_ms(fn, 20) for n, fn in kern.items()}
        fwd_plain = _time_ms(lambda: flash_attention_reference(
            q, k, v, causal=causal, return_lse=True), 5)
        dq_plain = _time_ms(lambda: flash_bwd_dq_reference(*args), 5)
        dkv_plain = _time_ms(lambda: flash_bwd_dkv_reference(*args), 5)
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))

        def sdpa_fb():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            torch.autograd.grad(o, (qs, ks, vs), do)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

        # SDPA's backward: its forward and backward less its forward, both
        # replayed from CUDA graphs (at bf16 the autograd call's host time
        # exceeds the backward's device time, so back-to-back calls time
        # the host)
        sdpa_b = _graph_ms([sdpa_fb], 20) - _graph_ms([sdpa_fwd], 20)
        bh = b * 12
        pairs = t * (t + 1) // 2 if causal else t * t
        row = bh * t * HEAD_DIM * 2          # one bf16 [b, h, t, 64] tensor
        scal = bh * t * 4                    # one fp32 [b, h, t] tensor
        work = {"flash_fwd_bf16": (4 * row + scal, 4 * pairs * bh * HEAD_DIM),
                "flash_bwd_dq_bf16": (5 * row + 2 * scal,
                                      6 * pairs * bh * HEAD_DIM),
                "flash_bwd_dkv_bf16": (6 * row + 2 * scal,
                                       8 * pairs * bh * HEAD_DIM)}
        times = {"flash_fwd_bf16": (fwd_plain, graph["sdpa_fwd"]),
                 "flash_bwd_dq_bf16": (dq_plain, sdpa_b),
                 "flash_bwd_dkv_bf16": (dkv_plain, sdpa_b)}
        for name, (plain_ms, lib_ms) in times.items():
            ms = graph[name]
            bound_ms, bound_by = _bound(*work[name], PEAK_BF16_FLOP_PER_S)
            print(f"kernel {name} b{b} h12 t{t} causal={causal}: kernel "
                  f"{ms:.4f} ms (graph; events {events[name]:.4f}), plain "
                  f"{plain_ms:.4f} ms, sdpa bf16 "
                  f"{'forward' if name == 'flash_fwd_bf16' else 'backward'}"
                  f" {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{bound_ms / ms:.1%} of it) [{card}]", flush=True)
            if (b, t, causal) == row_case:
                ulps, share, abs_err = err[name]
                rows[name] = dict(
                    max_abs_err=abs_err, max_ulps=ulps, share_apart=share,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_ms)
        bwd_ms = graph["flash_bwd_dq_bf16"] + graph["flash_bwd_dkv_bf16"]
        print(f"kernel bf16 backward b{b} h12 t{t} causal={causal}: K4 + K5 "
              f"{bwd_ms:.4f} ms against sdpa bf16 backward {sdpa_b:.4f} ms "
              f"({bwd_ms / sdpa_b:.2f}x); K3 against sdpa bf16 forward "
              f"{graph['flash_fwd_bf16'] / graph['sdpa_fwd']:.2f}x; sdpa "
              f"forward events {events['sdpa_fwd']:.4f} ms [{card}]",
              flush=True)
    return rows


def _step_dist(a_state, a_m, b_state, b_m, base, f_state) -> tuple:
    """How far step ``a`` lies from step ``b``, both from the state
    ``base``: the largest relative loss difference over the ranks, and
    the L2 distance of the parameters over every parameter (fp64 sums),
    relative to the fp32 step's update ``|f - base|``."""
    import torch

    num = den = 0.0
    for n, p0 in base.params.items():
        diff = a_state.params[n].double() - b_state.params[n].double()
        upd = f_state.params[n].double() - p0.double()
        num += float(torch.sum(diff * diff))
        den += float(torch.sum(upd * upd))
    loss = float(((a_m["loss"] - b_m["loss"]).abs() / b_m["loss"].abs())
                 .max())
    return loss, (num / den) ** 0.5


def _captured_step(step, state, batch):
    """``step(state, *batch)`` with each attention's inputs, output and
    gradients kept: ``Attention.attend`` wrapped for the one call, tensor
    hooks on q, k, v and the output.  Returns the step's result and one
    record a layer."""
    from stochastic_gradient_push_torch.models.transformer import Attention

    records, attend = [], Attention.attend

    def keep(self, q, k, v, seq):
        rec = {"q": q.detach(), "k": k.detach(), "v": v.detach()}
        for n, x in (("q", q), ("k", k), ("v", v)):
            x.register_hook(lambda g, n=n: rec.__setitem__(f"d{n}", g))
        out = attend(self, q, k, v, seq)
        rec["out"] = out.detach()
        out.register_hook(lambda g: rec.__setitem__("do", g))
        records.append(rec)
        return out

    Attention.attend = keep
    try:
        return step(state, *batch), records
    finally:
        Attention.attend = attend


def _check_captured(card: str, label: str, records, seq=None):
    """The bf16 kernels as the step ran them, on the step's own tensors:
    each layer's kernel output and q/k/v gradients against the plain
    versions on that layer's q, k, v and output gradient: the plain
    forward, and the plain backward from the kernel's output as the step
    fed it (delta = rowsum(dO * O) from it), each within ``bf16_close``;
    with ``seq``, the ring's plain lane, results merged from bf16 ticks
    (``bf16_close(parts=True)``).  Prints the worst layer."""
    from stochastic_gradient_push_torch.ops.flash_attention import (
        TOL_BF16_FLOOR, TOL_BF16_PARTS_FLOOR, TOL_BF16_PARTS_ULPS,
        TOL_BF16_SHARE, TOL_BF16_ULPS, bf16_mismatch,
        flash_attention_reference, flash_bwd_dkv_reference,
        flash_bwd_dq_reference)
    from stochastic_gradient_push_torch.ops.ring_flash import (
        _ring_backward, _ring_forward)

    floor, ulps = ((TOL_BF16_FLOOR, TOL_BF16_ULPS) if seq is None else
                   (TOL_BF16_PARTS_FLOOR, TOL_BF16_PARTS_ULPS))
    worst = {}
    for rec in records:
        q, k, v, do = rec["q"], rec["k"], rec["v"], rec["do"]
        if seq is None:
            ref, lse = flash_attention_reference(q, k, v, causal=True,
                                                 return_lse=True)
            delta = (do.float() * rec["out"].float()).sum(-1)
            args = (q, k, v, do, lse, delta, True)
            want = (ref, flash_bwd_dq_reference(*args),
                    *flash_bwd_dkv_reference(*args))
        else:
            ref, lse = _ring_forward(q, k, v, seq, True, False)
            want = (ref, *_ring_backward(q, k, v, rec["out"], lse,
                                         do.contiguous(), seq, True,
                                         False))
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            m = bf16_mismatch(rec[name], w, floor)
            worst[name] = tuple(map(max, zip(worst.get(name, m), m)))
    print(f"bf16 {label}: the kernels on the step's own attention tensors, "
          f"{len(records)} layers, against the plain versions: worst ulps "
          f"(of max(|plain|, {floor:g} of the largest)), share apart: " +
          ", ".join(f"{n} {u:.3g} {sh:.3e}" for n, (u, sh) in worst.items())
          + f" (tolerance {ulps} ulp, {TOL_BF16_SHARE:.0%}) [{card}]",
          flush=True)
    bad = {n: m for n, m in worst.items()
           if m[0] > ulps or m[1] > TOL_BF16_SHARE}
    if bad:
        raise AssertionError(f"bf16 {label}: the step's kernels apart from "
                             f"their plain versions on the step's tensors: "
                             f"{bad}")


def _bf16_lanes(card: str, label: str, step, plain_step, fp32_step, state,
                batch, tokens: int, seq=None):
    """One step from ``state`` on the bf16 kernel lane, the bf16 plain
    lane and the fp32 kernel lane.  The kernels first, on the step's own
    tensors (:func:`_check_captured`).  Then the step: a one-ulp flip
    anywhere in a bf16 step moves every later rounding, so two bf16
    evaluations of a step lie from each other about as far as from the
    fp32 step (the kernel lane from the plain lane 0.83-0.84 of the plain
    lane's distance from fp32; with P and dS rounded once, 0.86-0.87),
    and each lane is held to its distance from the fp32 step: the kernel
    lane's update no farther from the fp32 update than twice the plain
    lane's (relative L2 over every parameter), its loss no farther than
    twice the plain lane's plus the bf16 noise of a mean over ``tokens``
    token losses (2**-9 / sqrt(tokens) relative); the push-sum weight
    equal.  ``seq``: the ring's shards (``ring_flash``).  Returns the
    kernel lane's state."""
    import torch

    (k_state, k_m), records = _captured_step(step, state, batch)
    p_state, p_m = plain_step(state, *batch)
    f_state, f_m = fp32_step(state, *batch)
    torch.cuda.synchronize()
    _check_captured(card, label, records, seq)
    del records
    k_loss, k_upd = _step_dist(k_state, k_m, f_state, f_m, state, f_state)
    p_loss, p_upd = _step_dist(p_state, p_m, f_state, f_m, state, f_state)
    kp_loss, kp_upd = _step_dist(k_state, k_m, p_state, p_m, state, f_state)
    noise = 2.0 ** -9 / math.sqrt(tokens)
    weights_equal = torch.equal(k_state.gossip.ps_weight,
                                p_state.gossip.ps_weight)
    print(f"bf16 {label}: one step from one state, losses kernel lane "
          f"{k_m['loss'].tolist()}, plain lane {p_m['loss'].tolist()}, "
          f"fp32 {f_m['loss'].tolist()}; grad norms "
          f"{k_m['grad_norm'].tolist()}, {p_m['grad_norm'].tolist()}, "
          f"{f_m['grad_norm'].tolist()}; update (L2 over the fp32 update) "
          f"from the fp32 step: kernel lane {k_upd:.3e}, plain lane "
          f"{p_upd:.3e} (tolerance twice the plain lane's), kernel lane "
          f"from the plain lane {kp_upd:.3e}; losses from the fp32 step: "
          f"kernel lane {k_loss:.3e}, plain lane {p_loss:.3e} rel "
          f"(tolerance twice the plain lane's + {noise:.3e}), kernel from "
          f"plain {kp_loss:.3e}; ps-weight equal {weights_equal} [{card}]",
          flush=True)
    if not (k_upd <= 2 * p_upd and k_loss <= 2 * p_loss + noise
            and weights_equal):
        raise AssertionError(f"bf16 {label}: kernel lane update {k_upd} or "
                             f"loss {k_loss} from the fp32 step, over twice "
                             f"the plain lane's {p_upd}, {p_loss} (+ "
                             f"{noise}), or ps-weight unequal")
    return k_state


def bf16_train_path(card: str, fp32: dict) -> dict:
    """12a: phase 5's LM and step at bf16 (world 1, T1024 B8, flash): the
    lanes from one state (the plain lane: the kernels' plain twins on the
    card, ``attn_lane="plain"``), then BF16_STEPS kernel-lane steps with
    every counter zeroed just before, each launching 12 bf16 K3, K4 and
    K5 and no fp32 flash kernel; its timing printed beside phase 5's
    ``fp32``."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.train.lm import init_lm_state

    cfg, alg, tx, step = _train_setup("flash", dtype=torch.bfloat16)
    *_, plain_step = _train_setup("flash", dtype=torch.bfloat16,
                                  attn_lane="plain")
    *_, fp32_step = _train_setup("flash")
    state = init_lm_state(cfg, alg, tx, 1, seed=0, device="cuda")
    rng = np.random.default_rng(12)
    batches = [tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, 8, 1024))).cuda() for _ in range(2))
        for _ in range(BF16_STEPS + 1)]
    print(f"bf16 12a: SGP world 1, d{cfg.d_model} L{cfg.n_layers} "
          f"h{cfg.n_heads} ff{cfg.d_ff} vocab{cfg.vocab_size} T1024 B8, "
          f"bf16 compute on fp32 params, flash", flush=True)
    state = _bf16_lanes(card, "12a", step, plain_step, fp32_step, state,
                        batches[0], 8 * 1024)
    del plain_step, fp32_step
    torch.cuda.empty_cache()

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    want = {n: 0 for n in counters}
    want.update(dict.fromkeys(FLASH_BF16, cfg.n_layers))
    losses, step_s = [], []
    for toks, tgts in batches[1:]:
        before = {n: c.launches for n, c in counters.items()}
        t0 = time.perf_counter()
        state, m = step(state, toks, tgts)
        losses.append(float(m["loss"][0]))   # waits for the step
        step_s.append(time.perf_counter() - t0)
        got = {n: c.launches - before[n] for n, c in counters.items()}
        if got != want:
            raise AssertionError(f"bf16 12a: launches {got} a step, "
                                 f"expected {want}")
    launches = {n: c.launches for n, c in counters.items()}
    med_ms = float(np.median(step_s)) * 1e3
    print(f"bf16 12a: {BF16_STEPS} steps, losses "
          f"{json.dumps([round(x, 6) for x in losses])}, step ms "
          f"{json.dumps([round(x * 1e3, 2) for x in step_s])}, median "
          f"{med_ms:.2f} ms, {8 * 1024 / med_ms * 1e3:.1f} tokens/s (phase 5 "
          f"fp32: {fp32['ms']:.2f} ms, {fp32['tokens_per_s']:.1f} "
          f"tokens/s), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"launches a step {json.dumps(want)} [{card}]", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bf16 12a: non-finite loss {losses}")
    return launches


def bf16_seq_path(card: str, fp32: dict) -> dict:
    """12b: phase 11's dp 2 x sp 4 step at bf16 (ring_flash, SGP f32 on
    K2/K1): the lanes from one state, then three timed steps, each
    launching 240 bf16 K3, K4 and K5, no fp32 flash kernel, one K2 and
    one K1; their timing printed beside 11a's ``fp32``."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.parallel.seq import StackedSeq
    from stochastic_gradient_push_torch.train.lm import init_lm_state

    dp, sp, b, t = SEQ["dp"], SEQ["sp"], SEQ["batch"], SEQ["seq_len"]
    bf16 = torch.bfloat16
    cfg, alg, tx, step = _seq_setup("auto", False, True, dtype=bf16)
    *_, plain_step = _seq_setup("plain", False, False, dtype=bf16)
    *_, fp32_step = _seq_setup("auto", False, True)
    rng = np.random.default_rng(13)
    batches = [tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(dp, sp, b, t // sp))).cuda()
        for _ in range(2)) for _ in range(1 + SEQ["steps"])]
    state = init_lm_state(cfg, alg, tx, dp, seed=0, device="cuda")
    print(f"bf16 12b: world {dp * sp} stacked = dp {dp} x sp {sp}, "
          f"T{t} B{b}/replica, bf16 compute, ring_flash, SGP f32 wire on "
          f"the gossip kernel lane", flush=True)
    state = _bf16_lanes(card, "12b", step, plain_step, fp32_step, state,
                        batches[0], b * t, StackedSeq(sp))
    del plain_step, fp32_step
    torch.cuda.empty_cache()
    timed = _seq_timed(card, "12b", cfg, step, state, batches[1:])
    print(f"bf16 12b: median {timed['ms']:.2f} ms, "
          f"{timed['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{timed['peak_gb']:.2f} GB (11a fp32: {fp32['ms']:.2f} ms, "
          f"{fp32['tokens_per_s']:.1f} tokens/s, {fp32['peak_gb']:.2f} GB) "
          f"[{card}]", flush=True)
    return timed["launches"]


def bf16_cli(card: str) -> dict:
    """12c: ``run/gossip_lm.py --precision bf16 --world_size 4
    --gossip_kernel pallas`` at the LM's full width, in process with
    every counter zeroed just before: finite CSV rows, the bf16 flash
    kernels launched (4 ranks x 12 layers a step, no fp32 one), one K2
    and one K1 a step."""
    import contextlib
    import io

    import torch

    from stochastic_gradient_push_torch.run import gossip_lm

    w, t, b, n = (BF16_CLI[k] for k in ("world", "seq_len", "batch",
                                        "steps"))
    # the run's tokens, CSV and final checkpoint (a file a rank)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="bf16_cli_", dir=os.path.join(ROOT,
                                                                "build"))
    argv = ["--precision", "bf16", "--world_size", str(w), "--gossip_kernel",
            "pallas", "--vocab_size", "32000", "--d_model", "768",
            "--n_layers", "12", "--n_heads", "12", "--d_ff", "3072",
            "--seq_len", str(t), "--batch_size", str(b), "--num_steps",
            str(n), "--print_freq", "1", "--corpus_file",
            _token_file(ckpt, w * b * t * n + 1), "--seed", "0"]
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            result = gossip_lm.main(argv + ["--checkpoint_dir", ckpt])
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    lines = out.getvalue().splitlines()
    for line in lines:
        if line.startswith(("lm: ", "step,")) or line[:1].isdigit():
            print(f"bf16 12c cli: {line}", flush=True)
    rows = [r.split(",") for r in lines[lines.index(
        "step,loss,ppl,lr,tokens_per_sec,grad_norm") + 1:]
        if r.split(",")[0].isdigit()]
    print(f"bf16 12c cli: {wall:.2f} s in main, tokens/s "
          f"{result['tokens_per_sec']:.1f} over the run (the first step's "
          f"warm-up and the final save included); launches "
          f"{json.dumps(launches)} [{card}]",
          flush=True)
    if "precision bf16;" not in out.getvalue() or [r[0] for r in rows] != [
            str(i + 1) for i in range(n)] or not all(
            len(r) == 6 and all(math.isfinite(float(v)) for v in r)
            for r in rows):
        raise AssertionError(f"bf16 12c: CSV rows {rows}")
    want = {name: 0 for name in counters}
    want.update(dict.fromkeys(FLASH_BF16, w * 12 * n))
    want["gossip_edge_start"] = want["gossip_edge_wait"] = n
    if launches != want:
        raise AssertionError(f"bf16 12c: launches {launches}, expected "
                             f"{want}")
    return launches


def bf16_path(card: str, fp32_train: dict, fp32_seq: dict
              ) -> tuple[dict, dict]:
    """Phase 12: LM training at bf16 through the bf16 forms of K3-K5,
    timed beside phase 5's ``fp32_train`` and 11a's ``fp32_seq``.
    Returns the main-path runs' launches and 12d's JSON rows (B8 T1024
    causal)."""
    import torch

    t0 = time.perf_counter()
    runs = [bf16_train_path(card, fp32_train)]
    torch.cuda.empty_cache()
    runs.append(bf16_seq_path(card, fp32_seq))
    torch.cuda.empty_cache()
    runs.append(bf16_cli(card))
    torch.cuda.empty_cache()
    tick = SEQ["seq_len"] // SEQ["sp"]
    rows = check_flash_bf16(card, ((1, 8, True), (1, 200, True),
                                   (1, 200, False), (8, 1024, True),
                                   (SEQ["batch"], tick, True),
                                   (SEQ["batch"], tick, False)),
                            row_case=(8, 1024, True))
    print(f"bf16: phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {n: sum(r[n] for r in runs) for n in runs[0]}
    return launches, rows


# -- phase 13: one rank per process on one card -----------------------------

# 13a: the cross-process K2 + K1 at world 4, two edges, every wire, at
# ResNet-50's payload and the d768/L12 LM's, new data every round; then
# rounds at 13b's shape (ResNet-50, f32, one edge) timed
DIST = dict(world=4, edges=2, rounds=20, timed=20, timeout=60.0,
            lost_timeout=2.0)
# 13b: run/gossip_sgd.py in 2 processes under a torchrun environment,
# ResNet-50 at full width, 8 images a rank, 3 steps, SGP then OSGP
DIST_CLI = dict(world=2, batch=8, itrs=3)
DIST_TIMEOUT_S = 300

_DIST_KERNEL_CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from stochastic_gradient_push_torch.ops import gossip_kernel as gk
from stochastic_gradient_push_torch.parallel import collectives
from stochastic_gradient_push_torch.parallel.wire import get_codec
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, build_schedule)

rank, world, port = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cfg = json.loads(sys.argv[5])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
transport = collectives.DistTransport(timeout_s=cfg["timeout"])
lane = gk.KernelLane()
report = {"rank": rank, "checked": []}


def case(g, spec, length, ne):
    # every rank's encoded parts and accumulator: the same in each process
    if spec.kind == "int8":
        rows = length // spec.block
        parts = (torch.randint(-127, 128, (world, ne, rows, spec.block),
                               device="cuda", generator=g,
                               dtype=torch.int8),
                 torch.rand(world, ne, rows, device="cuda", generator=g)
                 * 0.02)
    else:
        x = torch.randn(world, ne, length, device="cuda", generator=g)
        parts = (x.to(torch.bfloat16) if spec.kind == "bf16" else x,)
    return parts, torch.randn(world, length, device="cuda", generator=g)


def dests_of(ne, t):
    s = build_schedule(NPeerDynamicDirectedExponentialGraph(
        world, peers_per_itr=ne))
    return s.perms[t % s.num_phases]


g = torch.Generator(device="cuda")
for label, n in cfg["payloads"]:
    for wire in ("f32", "bf16", "int8"):
        spec = get_codec(wire, 64).kernel_spec()
        length = gk.padded_len(spec, n)
        for t in range(cfg["rounds"]):
            g.manual_seed(1000 * t + len(label))
            parts, acc = case(g, spec, length, cfg["edges"])
            dests = dests_of(cfg["edges"], t)
            want = gk.gossip_edge_wait(gk.gossip_edge_start(
                parts, dests, spec, n_decoded=n), acc)[rank]
            mine = tuple(p[rank:rank + 1] for p in parts)
            got = gk.gossip_edge_wait(transport.edge_start(
                mine, dests, spec, n, lane, slot=(label, wire)),
                acc[rank:rank + 1])[0]
            if not torch.equal(got, want):
                raise AssertionError(
                    f"rank {rank} {label} {wire} round {t}: cross-process "
                    f"K2+K1 differs from the stacked K2+K1, max err "
                    f"{float((got - want).abs().max())}")
            if t == 0 and label == cfg["twin"]:
                # the plain twin: the same parts over gloo, landed on the CPU
                twin = gk.gossip_edge_wait(transport.edge_start(
                    tuple(p.cpu() for p in mine), dests, spec, n,
                    gk.KernelLane(interpret=True), slot=("twin", wire)),
                    acc[rank:rank + 1].cpu())[0]
                if not torch.equal(twin, got.cpu()):
                    raise AssertionError(
                        f"rank {rank} {label} {wire}: cross-process K2+K1 "
                        "differs from its plain twin")
            del parts, acc, want, got, mine
        transport.check()
        report["checked"].append(f"{label} {wire}")
        torch.cuda.empty_cache()

# 13b's shape: ResNet-50's payload, f32, one edge; timed in rank 0 while
# the four processes run the same rounds
spec = get_codec("f32", 64).kernel_spec()
n = cfg["payloads"][0][1]
length = gk.padded_len(spec, n)
g.manual_seed(99)
parts, acc = case(g, spec, length, 1)
mine = (parts[0][rank:rank + 1].contiguous(),)
a = acc[rank:rank + 1].contiguous()
del parts, acc
dests = dests_of(1, 0)
whole = []
for t in range(cfg["timed"] + 3):
    # the round as the four processes run it together, time-sliced
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    # the card sleeps ~1 ms while the host launches the round, so the
    # events time the device's work, not the host's
    torch.cuda._sleep(2_000_000)
    e0.record()
    h = transport.edge_start(mine, dests, spec, n, lane, slot="timed")
    out = gk.gossip_edge_wait(h, a)
    e1.record()
    e1.synchronize()
    if t >= 3:
        whole.append(e0.elapsed_time(e1))


def alone(fn):
    # rank 0 runs fn (after a ~1 ms device sleep) on a card the others
    # leave idle at a barrier, then the others run it; rank 0's time
    torch.cuda.synchronize()
    dist.barrier()
    ms, out = None, None
    if rank == 0:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        # a start ends at its K2's event (the side stream's)
        ms = e0.elapsed_time(out.remote.event if hasattr(out, "remote")
                             else e1)
    dist.barrier()
    if rank != 0:
        out = fn()
    torch.cuda.synchronize()
    dist.barrier()
    return ms, out


k2, k1 = [], []
for t in range(cfg["timed"] + 3):
    # K2 once every receiver consumed the last round; K1 once every K2 of
    # the round has landed
    ms2, h = alone(lambda: transport.edge_start(mine, dests, spec, n, lane,
                                                slot="timed"))
    link = h.remote.link
    ready = torch.as_tensor(gk._DeviceBytes(link.ptr, 8 * link.E),
                            device="cuda").view(torch.int64)
    if int(ready.min()) < h.remote.rnd:
        raise AssertionError(f"rank {rank}: round {h.remote.rnd} not "
                             f"ready after every K2 ended: {ready.tolist()}")
    ms1, out = alone(lambda: gk.gossip_edge_wait(h, a))
    if t >= 3 and rank == 0:
        k2.append(ms2)
        k1.append(ms1)
transport.check()
# the plain twin at the same shape (gloo between the four processes,
# host clock)
cpu_mine, cpu_a = (mine[0].cpu(),), a.cpu()
twin = []
for t in range(2):
    dist.barrier()
    t0 = time.perf_counter()
    gk.gossip_edge_wait(transport.edge_start(
        cpu_mine, dests, spec, n, gk.KernelLane(interpret=True),
        slot="twin-timed"), cpu_a)
    twin.append((time.perf_counter() - t0) * 1e3)
dist.barrier()
if rank == 0:
    dst = int(dests[0][rank])
    nbytes = mine[0].numel() * mine[0].element_size()
    # the PyTorch call that computes K2's function: copy_ into the mapped
    # landing row of the receiver
    peer = torch.as_tensor(gk._DeviceBytes(link.base(dst) + link.offs[0],
                                           nbytes), device="cuda"
                           ).view(torch.float32).reshape(mine[0].shape)
    recv = link.recv[0].reshape(a.shape)

    def timed(fn, iters=10):
        for _ in range(3):
            fn()
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        for _ in range(iters):
            fn()
        s1.record()
        s1.synchronize()
        return s0.elapsed_time(s1) / iters

    acc_chunks = a.reshape(1, h.meta[4], h.meta[3])
    report.update(
        k2_ms=statistics.median(k2), k1_ms=statistics.median(k1),
        round_ms=statistics.median(whole), round_min_ms=min(whole),
        copy_ms=timed(lambda: peer.copy_(mine[0])),
        add_ms=timed(lambda: torch.add(a, recv)),
        k1_plain_ms=timed(lambda: gk.gossip_edge_wait_reference(
            acc_chunks, h.recv, "f32")),
        twin_ms=twin[-1], part_bytes=nbytes, acc_elems=a.numel())
dist.barrier()
# a peer that never sends: on a fresh link every rank runs round 1, then
# rank 3 skips round 2; the rank it sends to gives up after the link's
# limit and names it
lost = world - 1
victim = int(dests[0][lost])
gk.gossip_edge_wait(transport.edge_start(mine, dests, spec, n, lane,
                                         slot="lost"), a)
torch.cuda.synchronize()
transport.check()
transport.links.timeout_s = cfg["lost_timeout"]
if rank != lost:
    t0 = time.perf_counter()
    h = transport.edge_start(mine, dests, spec, n, lane, slot="lost")
    gk.gossip_edge_wait(h, a)
    torch.cuda.synchronize()
    try:
        transport.check()
        raised = None
    except gk.PeerLostError as e:
        raised = str(e)
    report["lost"] = [raised, time.perf_counter() - t0]
    if (raised is None) != (rank != victim):
        raise AssertionError(f"rank {rank}: lost-peer error {raised!r}")
    if raised is not None and not (
            f"rank {rank}, edge 0, round 2: no payload from rank {lost}"
            in raised):
        raise AssertionError(f"rank {rank}: lost-peer error {raised!r}")
dist.barrier()
transport.close()
print("DIST13 " + json.dumps(report), flush=True)
dist.destroy_process_group()
"""

_DIST_CLI_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
from stochastic_gradient_push_torch.ops import gossip_kernel as gk
from stochastic_gradient_push_torch.run import gossip_sgd

counters = {"gossip_edge_start": (gk.gossip_edge_start, "launches"),
            "gossip_edge_wait": (gk.gossip_edge_wait, "launches"),
            "gossip_edge_start_ipc": (gk.gossip_edge_start, "launches_ipc"),
            "gossip_edge_wait_ipc": (gk.gossip_edge_wait, "launches_ipc")}
for fn, attr in counters.values():
    setattr(fn, attr, 0)
gossip_sgd.main(json.loads(sys.argv[5]))
print("LAUNCHES " + json.dumps({k: getattr(fn, attr)
                                for k, (fn, attr) in counters.items()}),
      flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(script: str, world: int, args, env=None) -> list:
    """``world`` processes of ``script`` (argv: root, rank, world, port,
    *args), each with the card as device 0; started, to be joined by
    :func:`_join`."""
    port = _free_port()
    procs = []
    for r in range(world):
        e = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
                 **(env(r, port) if env else {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, ROOT, str(r), str(world),
             str(port), *args], env=e, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _join(label: str, procs) -> list[str]:
    """Each process's output; a nonzero exit or a hang (past
    ``DIST_TIMEOUT_S``) fails the phase, and no process outlives it."""
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                tails = [q.communicate()[0] or "" for q in procs[len(logs):]]
                raise AssertionError(
                    f"{label}: a process hung past {DIST_TIMEOUT_S} s:\n"
                    + "\n".join(t[-3000:] for t in tails)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{label}: rank(s) {bad} exited "
                             f"{[procs[i].returncode for i in bad]}:\n"
                             + "\n".join(logs[i][-4000:] for i in bad))
    return logs


def _tagged(log: str, tag: str) -> dict:
    line = next(x for x in log.splitlines() if x.startswith(tag + " "))
    return json.loads(line[len(tag) + 1:])


def dist_kernel_rows(card: str, lm_payload: int) -> dict:
    """13a: the cross-process K2 + K1 in 4 processes on the card against
    the stacked K2 + K1 (every round) and the plain twin (first round at
    ResNet-50's payload); the kernels' rows from rank 0's timings at
    13b's shape."""
    t0 = time.perf_counter()
    cfg = dict(DIST, payloads=[["resnet50", RESIL_PAYLOAD],
                               ["lm_d768_L12", lm_payload]],
               twin="resnet50")
    logs = _join("13a", _ranks(_DIST_KERNEL_CHILD, DIST["world"],
                               [json.dumps(cfg)]))
    reports = [_tagged(log, "DIST13") for log in logs]
    r0 = next(r for r in reports if r["rank"] == 0)
    print(f"dist 13a: {DIST['world']} processes, E{DIST['edges']}, "
          f"{DIST['rounds']} rounds each of {', '.join(r0['checked'])}: "
          f"every rank's cross-process K2 + K1 bit-equal to the stacked "
          f"K2 + K1, and to the plain twin (gloo) on round 0 at "
          f"ResNet-50's payload; {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    part, acc = r0["part_bytes"], r0["acc_elems"]
    sb = _bound(2 * part, 0)
    wb = _bound(2 * acc * 4 + part, acc)
    victim = next(r for r in reports if r.get("lost", [None])[0])
    print(f"dist 13a lost peer: rank {DIST['world'] - 1} skipped a round; "
          f"rank {victim['rank']} raised after {victim['lost'][1]:.2f} s "
          f"(limit {DIST['lost_timeout']} s): {victim['lost'][0]}",
          flush=True)
    print(f"dist 13a timed at ResNet-50 f32 E1, world 4 processes on one "
          f"card (not an NVLink figure), rank 0 medians of {DIST['timed']}: "
          f"K2 {r0['k2_ms']:.4f} ms once its receiver consumed the last "
          f"round, K1 {r0['k1_ms']:.4f} ms once every K2 landed (each alone "
          f"on the card, flag waits and signals included); the round as "
          f"the four run it together, time-sliced, {r0['round_ms']:.3f} ms "
          f"(best {r0['round_min_ms']:.3f}); copy_ into the mapped peer row "
          f"{r0['copy_ms']:.3f} ms, add {r0['add_ms']:.3f} ms, K1 plain "
          f"{r0['k1_plain_ms']:.3f} ms, twin round (gloo, host clock) "
          f"{r0['twin_ms']:.1f} ms; bounds K2 {sb[0]:.4f} ms ({sb[1]}, "
          f"HBM; NVLink 450 GB/s a direction would be "
          f"{part / 450e9 * 1e3:.4f} ms, not measured), K1 {wb[0]:.4f} ms "
          f"[{card}]", flush=True)
    return {"gossip_edge_start_ipc": dict(
                max_abs_err=0.0, ms=r0["k2_ms"], plain_ms=r0["twin_ms"],
                bound_ms=sb[0], bound_by=sb[1], library_ms=r0["copy_ms"]),
            "gossip_edge_wait_ipc": dict(
                max_abs_err=0.0, ms=r0["k1_ms"], plain_ms=r0["k1_plain_ms"],
                bound_ms=wb[0], bound_by=wb[1], library_ms=r0["add_ms"])}


def _dist_argv(ckpt_dir: str, *extra: str) -> list[str]:
    c = DIST_CLI
    return ["--model", "resnet50", "--image_size", "224", "--num_classes",
            "1000", "--dataset", "synthetic", "--batch_size", str(c["batch"]),
            "--num_epochs", "1", "--num_iterations_per_training_epoch",
            str(c["itrs"]), "--synthetic_samples",
            str(c["world"] * c["batch"] * c["itrs"]), "--num_itr_ignore", "0",
            "--print_freq", "1", "--seed", "0", "--verbose", "False",
            "--gossip_kernel", "pallas", "--checkpoint_dir", ckpt_dir, *extra]


def _flag_form(child: str) -> str:
    """``child`` (a :data:`_DIST_CLI_CHILD`) with its CLI call given the
    reference's flags of a multi-host launch from its argv (root, rank,
    world, port, the CLI's argv); it raises if ``child`` has no such
    call, so the launch cannot silently lose its flags."""
    call = "gossip_sgd.main(json.loads(sys.argv[5]))"
    if child.count(call) != 1:
        raise AssertionError(f"13b: the child has no {call!r} to flag")
    return child.replace(call, (
        "gossip_sgd.main(json.loads(sys.argv[5]) + [\"--multihost\", "
        "\"True\", \"--coordinator_address\", \"127.0.0.1:\" + sys.argv[4], "
        "\"--num_processes\", sys.argv[3], \"--process_id\", sys.argv[2]])"))


# 13b's child: _DIST_CLI_CHILD launched by the reference's flags, with no
# torchrun variables
_DIST_CLI_FLAG_CHILD = _flag_form(_DIST_CLI_CHILD)


def dist_cli_path(card: str) -> dict:
    """13b: run/gossip_sgd.py in 2 processes launched by the reference's
    flags on the card (gloo group, the payload on the cross-process K2/K1),
    SGP and OSGP side by side; launch counts per step in each process,
    the rank files, and each rank's state against the stacked kernel-lane
    run of the same command (deterministic cuDNN)."""
    import torch

    from stochastic_gradient_push_torch.run import gossip_sgd

    t0 = time.perf_counter()
    world, steps = DIST_CLI["world"], DIST_CLI["itrs"]
    tmp = tempfile.mkdtemp(prefix="dist13_", dir=os.path.join(ROOT, "build"))
    runs = {"sgp": [], "osgp": ["--overlap", "True"]}
    procs = {alg: _ranks(_DIST_CLI_FLAG_CHILD, world, [json.dumps(_dist_argv(
        os.path.join(tmp, alg), "--backend", "gloo", *extra))])
        for alg, extra in runs.items()}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        for alg, extra in runs.items():
            gossip_sgd.main(_dist_argv(os.path.join(tmp, alg + "_stacked"),
                                       "--world_size", str(world), *extra))
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    launches = {}
    for alg in runs:
        logs = _join(f"13b {alg}", procs[alg])
        for r, log in enumerate(logs):
            got = _tagged(log, "LAUNCHES")
            want = {"gossip_edge_start": 0, "gossip_edge_wait": 0,
                    "gossip_edge_start_ipc": steps,
                    "gossip_edge_wait_ipc": steps}
            if got != want:
                raise AssertionError(f"13b {alg} rank {r}: launches {got}, "
                                     f"expected {want} (one cross-process "
                                     f"start and wait a step)")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        worst, exact = 0.0, 0
        for r in range(world):
            path = os.path.join(tmp, alg, f"checkpoint_r{r}_n{world}.ckpt")
            if not os.path.isfile(path):
                raise AssertionError(f"13b {alg}: no rank file {path}")
            got = _flat(torch.load(path, weights_only=True)["state"])
            want = _flat(torch.load(os.path.join(
                tmp, alg + "_stacked", f"checkpoint_r{r}_n{world}.ckpt"),
                weights_only=True)["state"])
            if sorted(got) != sorted(want):
                raise AssertionError(f"13b {alg} rank {r}: rank file keys "
                                     "differ from the stacked run's")
            for k in want:
                # tests/test_torch_resnet_step.py's step tolerance
                torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                           atol=1e-6, msg=f"13b {alg} {k}")
                worst = max(worst, _max_err(got[k], want[k]))
                exact += bool(torch.equal(got[k], want[k]))
        print(f"dist 13b {alg}: run/gossip_sgd.py in {world} processes "
              f"(launched by --multihost True --coordinator_address "
              f"--num_processes --process_id, --backend gloo, --gossip_kernel "
              f"pallas), ResNet-50 224 px, {DIST_CLI['batch']} a rank, "
              f"{steps} steps: one cross-process K2 and K1 a step in each "
              f"process, rank files written; vs the stacked kernel lane's "
              f"run: max |diff| {worst:.3g} over {len(want) * world} "
              f"tensors, {exact} exactly equal [{card}]", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"dist: 13b in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def dist_path(card: str, lm_payload: int) -> tuple[dict, dict]:
    """Phase 13: 13a (the kernels across processes), then 13b (the CLI
    under torchrun)."""
    t0 = time.perf_counter()
    rows = dist_kernel_rows(card, lm_payload)
    launches = dist_cli_path(card)
    print(f"dist: phase 13 in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, rows


# -- phase 14: the reference's ImageNet command line -------------------------

# a JPEG tree written here: 4 classes, 64 train and 32 val images a class,
# 320 x 256 px, so RandomResizedCrop to 224 and the val resize and centre
# crop resample for real
IMAGES = dict(classes=4, train=64, val=32, width=320, height=256)
# run/gossip_sgd.py at ResNet-50's width, world 4 stacked, 32 images a
# rank: the 256 training images are 2 steps an epoch; the timed runs of
# 14a and 14b train 3 epochs (the meters skip each epoch's first step, so
# BT and DT are means of 3 steps); the loader alone streams 4 epochs at 8
# images a rank, 8 batches an epoch, so it decodes as many batches at once
# as the CLI does on a long epoch (its prefetch 4 + 1)
IMG_CLI = dict(world=4, batch=32, workers=8, epochs=3, loader_epochs=4,
               loader_batch=8)
# the uint8 run's first-step loss against the f32 run's: their inputs
# differ by an ulp (the card's fused normalisation against the host's)
TOL_IMG_LOSS_REL = 1e-4
# the card-normalised uint8 batch against the same normalisation on the
# CPU and against the f32 loader's host-normalised batch (|x| < 2.7, an
# ulp there is 2.4e-7)
TOL_IMG_NORM = 1e-6


def _write_images(root: str) -> None:
    """The phase's JPEG tree, made from seed 0: each image a smooth random
    field (an 8 x 10 grid upsampled bicubically), a class tint and mild
    pixel noise, saved at quality 90."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    w, h = IMAGES["width"], IMAGES["height"]
    for split in ("train", "val"):
        for c in range(IMAGES["classes"]):
            d = os.path.join(root, split, f"class_{c}")
            os.makedirs(d)
            for i in range(IMAGES[split]):
                field = Image.fromarray(rng.integers(
                    0, 256, (8, 10, 3), dtype=np.uint8)).resize(
                    (w, h), Image.BICUBIC)
                px = np.asarray(field, np.int16) + rng.integers(
                    -12, 13, (h, w, 3))
                px[..., c % 3] += 30
                Image.fromarray(np.clip(px, 0, 255).astype(np.uint8)).save(
                    os.path.join(d, f"img_{i:03d}.jpg"), quality=90)


def _img_argv(root: str, ckpt: str, *extra: str) -> list[str]:
    c = IMG_CLI
    return ["--model", "resnet50", "--image_size", "224", "--num_classes",
            "1000", "--dataset", "imagefolder", "--dataset_dir", root,
            "--world_size", str(c["world"]), "--batch_size", str(c["batch"]),
            "--num_dataloader_workers", str(c["workers"]), "--num_epochs",
            "1", "--num_itr_ignore", "1", "--print_freq", "1", "--seed", "0",
            "--verbose", "False", "--checkpoint_dir", ckpt, *extra]


class _Spy:
    """Inside a ``with``: the first batch array the Trainer moved to the
    card (the first step's images) and the first step's metric rows
    (``[R, 4]``: loss, top-1, top-5, grad norm)."""

    def __enter__(self):
        import numpy as np

        from stochastic_gradient_push_torch.train import loop

        self.loop, self.batch, self.rows = loop, None, None
        self._real = (loop.Trainer._on_device, loop.to_host)
        on_device, to_host = self._real

        def spy_on_device(trainer, a):
            out = on_device(trainer, a)
            if self.batch is None:
                self.batch = out.clone()
            return out

        def spy_to_host(x, transport):
            out = to_host(x, transport)
            if self.rows is None:
                self.rows = np.array(out)
            return out

        loop.Trainer._on_device, loop.to_host = spy_on_device, spy_to_host
        return self

    def __exit__(self, *exc):
        self.loop.Trainer._on_device, self.loop.to_host = self._real


def _csv_rows(ckpt: str) -> list[list[str]]:
    """Rank 0's training rows, one a global step: the CSV's rows after
    its header block, less the validation rows (``itr`` -1) and each
    epoch's closing row (the same ``(epoch, itr)`` as its last step)."""
    with open(os.path.join(ckpt, f"out_r0_n{IMG_CLI['world']}.csv")) as f:
        rows = [r.split(",") for r in f.read().splitlines()[5:]]
    steps = {}
    for r in rows:
        if r[1] != "-1":
            steps.setdefault((r[0], r[1]), r)
    return list(steps.values())


def _csv_timing(ckpt: str) -> tuple[float, float, float]:
    """The last training row's ``avg:BT(s)``, ``std:BT(s)`` and
    ``avg:DT(s)``."""
    last = _csv_rows(ckpt)[-1]
    return float(last[3]), float(last[4]), float(last[9])


def _loader_rate(root: str, output: str) -> tuple[float, int, int]:
    """The streaming loader's own images/s over ``loader_epochs`` training
    epochs, no step, at the CLI's workers and prefetch; with the images it
    decoded and the most batches decoding at once (a batch a task: the
    one waited on and ``prefetch`` behind it, at most one a thread)."""
    from stochastic_gradient_push_torch.data.streaming import (
        StreamingImageFolder)

    c = IMG_CLI
    loader = StreamingImageFolder(root, "train", c["world"],
                                  c["loader_batch"],
                                  num_workers=c["workers"], output=output)
    in_flight = min(loader.num_workers, loader.prefetch + 1, len(loader))
    n = 0
    t0 = time.perf_counter()
    for epoch in range(c["loader_epochs"]):
        loader.set_epoch(epoch)
        n += sum(x.shape[0] * x.shape[1] for x, _ in loader)
    return n / (time.perf_counter() - t0), n, in_flight


def image_cli(card: str, root: str, tmp: str) -> dict:
    """14a: run/gossip_sgd.py on the tree, ResNet-50 at 224 px, world 4
    stacked, SGP on the gossip kernels: uint8 output with device
    prefetch, f32 without (``epochs`` epochs each), then the first again
    for one epoch with a profile window of both its steps (its times are
    the profiler's, not the run's)."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.data.streaming import (
        StreamingImageFolder)
    from stochastic_gradient_push_torch.run import gossip_sgd
    from stochastic_gradient_push_torch.train.step import normalize_images
    from stochastic_gradient_push_torch.utils.profiling import fenced_ms

    c = IMG_CLI
    prof = os.path.join(tmp, "profile")
    uint8 = ["--data_output", "uint8", "--prefetch", "True"]
    runs = {"uint8": ("uint8, prefetch", c["epochs"], uint8),
            "f32": ("f32, no prefetch", c["epochs"],
                    ["--data_output", "f32", "--prefetch", "False"]),
            "profiled": ("uint8, prefetch, profiled", 1, uint8 + [
                "--profile_dir", prof, "--profile_start_step", "0",
                "--profile_steps", "2"])}
    per_epoch = (IMAGES["train"] * IMAGES["classes"]
                 // (c["world"] * c["batch"]))
    # the loader alone first, before the runs leave their objects to the
    # garbage collector (a 240,000-event trace among them)
    rates = {out: _loader_rate(root, out) for out in ("uint8", "f32")}
    n, in_flight = rates["uint8"][1:]
    print(f"imagenet 14a loader alone (no step, {c['loader_epochs']} "
          f"epochs of {c['world']} x {c['loader_batch']}, {n} images, "
          f"{c['workers']} PIL threads, {in_flight} batches decoding at "
          f"once, {IMAGES['width']}x"
          f"{IMAGES['height']} JPEGs to 224): "
          + ", ".join(f"{k} {v[0]:.1f} images/s" for k, v in rates.items())
          + f" [{card}]", flush=True)
    got, launches_total = {}, {}
    for label, (what, epochs, extra) in runs.items():
        ckpt = os.path.join(tmp, f"img_{label}")
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        with _Spy() as spy:
            t0 = time.perf_counter()
            result = gossip_sgd.main(_img_argv(
                root, ckpt, "--gossip_kernel", "pallas", "--num_epochs",
                str(epochs), *extra))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = per_epoch * epochs
        launches = {n: fn.launches for n, fn in counters.items()}
        want = {n: 0 for n in launches}
        want["gossip_edge_start"] = want["gossip_edge_wait"] = steps
        if launches != want:
            raise AssertionError(f"imagenet 14a {label}: launches {launches},"
                                 f" expected {want}")
        for n, v in launches.items():
            launches_total[n] = launches_total.get(n, 0) + v
        bt, bt_std, dt = _csv_timing(ckpt)
        loss = spy.rows[:, 0]
        if not np.isfinite(spy.rows).all():
            raise AssertionError(f"imagenet 14a {label}: metrics {spy.rows}")
        print(f"imagenet 14a {what}: {wall:.2f} s in main ({epochs} epochs "
              f"of {per_epoch} steps, validation, checkpoints); BT mean of "
              f"{epochs} steps (each epoch's second) {bt * 1e3:.0f} ms "
              f"(std {bt_std * 1e3:.0f}), "
              f"{c['world'] * c['batch'] / result['batch_meter'].avg:.1f} "
              f"images/s, DT {dt * 1e3:.0f} ms = {dt / bt:.1%} of BT; "
              f"first-step loss per rank {loss.tolist()}; one K2 and one K1 "
              f"a step [{card}]", flush=True)
        got[label] = dict(batch=spy.batch, loss=loss, result=result)

    # the first batch: uploaded as uint8 through the prefetcher's pinned
    # buffers, normalised on the card
    u8 = got["uint8"]["batch"]
    if u8.dtype != torch.uint8 or not u8.is_cuda:
        raise AssertionError(f"imagenet 14a: first uint8 batch {u8.dtype} "
                             f"on {u8.device}")
    # the CLI's loader: --seed 0, so the trainer's first epoch is 0
    loader = StreamingImageFolder(root, "train", c["world"], c["batch"],
                                  image_size=u8.shape[2], seed=0,
                                  num_workers=c["workers"], output="uint8")
    loader.set_epoch(0)
    decoded = torch.from_numpy(next(iter(loader))[0])
    if not torch.equal(u8.cpu(), decoded):
        raise AssertionError("imagenet 14a: the prefetched uint8 batch "
                             "differs from the loader's")
    on_card = normalize_images(u8)
    on_cpu = normalize_images(decoded)
    norm_ms = fenced_ms(normalize_images, u8, steps=20)
    host = got["f32"]["batch"]
    err_cpu = _max_err(on_card.cpu(), on_cpu)
    err_host = _max_err(on_card, host)
    print(f"imagenet 14a first batch {tuple(u8.shape)}: uint8 through "
          f"pinned buffers equal to the loader's decode; normalised on the "
          f"card vs the same on the CPU: exactly equal "
          f"{torch.equal(on_card.cpu(), on_cpu)}, max |diff| {err_cpu:.3g}; "
          f"vs the f32 loader's host-normalised batch: max |diff| "
          f"{err_host:.3g} (bound {TOL_IMG_NORM}); the card's "
          f"normalisation {norm_ms:.3f} ms a batch (fenced_ms, 20 calls) "
          f"[{card}]", flush=True)
    if not (err_cpu <= TOL_IMG_NORM and err_host <= TOL_IMG_NORM):
        raise AssertionError("imagenet 14a: normalisations differ")
    rel = float(np.max(np.abs(got["uint8"]["loss"] - got["f32"]["loss"])
                       / np.abs(got["f32"]["loss"])))
    print(f"imagenet 14a: first-step loss uint8 vs f32, max relative diff "
          f"{rel:.3g} (tolerance {TOL_IMG_LOSS_REL}) [{card}]", flush=True)
    if not rel <= TOL_IMG_LOSS_REL:
        raise AssertionError("imagenet 14a: first-step losses differ")

    # the profiled run's trace names the gossip kernels
    trace = got["profiled"]["result"].get("profile_trace")
    if not trace or not os.path.isfile(trace):
        raise AssertionError(f"imagenet 14a: no profile trace ({trace})")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in n for n in kernels)
             for k in ("edge_start_kernel", "edge_wait_kernel")}
    print(f"imagenet 14a profile: {os.path.basename(trace)}, "
          f"{os.path.getsize(trace) / 1e6:.1f} MB, {len(events)} events, "
          f"{len(kernels)} kernel launches, gossip kernels {named} "
          f"[{card}]", flush=True)
    if min(named.values()) < per_epoch:
        raise AssertionError("imagenet 14a: the trace does not name the "
                             f"gossip kernels: {named}")
    return launches_total


def _bilat_card_round(card: str) -> None:
    """One averaging round on ResNet-50's world-4 parameters on the card,
    applied to the live params, against the numpy round on the same
    snapshot, bit for bit."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.models.convert import (
        init_model_params)
    from stochastic_gradient_push_torch.topology import (
        DynamicBipartiteExponentialGraph, build_pairing_schedule)
    from stochastic_gradient_push_torch.train.async_bilat import (
        AsyncBilateralAverager)
    from stochastic_gradient_push_torch.train.step import make_model

    world = IMG_CLI["world"]
    params, _ = init_model_params(make_model("resnet50", num_classes=1000), 0)
    g = torch.Generator(device="cuda").manual_seed(0)
    live = {n: t.cuda()[None] + 0.01 * torch.randn(
        world, *t.shape, generator=g, device="cuda")
        for n, t in params.items()}
    snap = {n: t.cpu().numpy().copy() for n, t in live.items()}
    av = AsyncBilateralAverager(build_pairing_schedule(
        DynamicBipartiteExponentialGraph(world))).start()
    try:
        av.publish(7, live)
        deadline = time.perf_counter() + 60
        while av._rounds < 1:
            if time.perf_counter() > deadline:
                raise AssertionError("imagenet 14b: no averaging round")
            time.sleep(0.005)
        _, adopted = av.maybe_adopt(9, live)
        torch.cuda.synchronize()
    finally:
        av.stop()
    partner = av.pairing[0]
    bad = [n for n, a in snap.items()
           if not np.array_equal(live[n].cpu().numpy(),
                                 a + (a[partner] - a) * np.float32(0.5))]
    print(f"imagenet 14b: one averaging round on {len(snap)} ResNet-50 "
          f"tensors ({sum(a[0].size for a in snap.values()):,} values a "
          f"rank), snapshot through pinned buffers on a side stream, "
          f"partners {partner.tolist()}, adopted on the card: "
          f"{len(snap) - len(bad)} of {len(snap)} bit-equal to numpy's "
          f"x + (x[partner] - x) * 0.5; {av.staleness_summary()} [{card}]",
          flush=True)
    if bad or not adopted:
        raise AssertionError(f"imagenet 14b: round differs in {bad[:5]}")


def image_bilat(card: str, root: str, tmp: str) -> None:
    """14b: run/gossip_sgd_adpsgd.py --bilat_async True on the tree."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.run import gossip_sgd_adpsgd
    from stochastic_gradient_push_torch.train import async_bilat

    c = IMG_CLI
    alive_at_stop = []
    stop = async_bilat.AsyncBilateralAverager.stop

    def watched_stop(self):
        alive_at_stop.append(self.alive)
        stop(self)

    def run(label, *extra):
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        out = os.path.join(tmp, f"img_{label}")
        t0 = time.perf_counter()
        result = gossip_sgd_adpsgd.main(_img_argv(
            root, out, "--num_epochs", str(c["epochs"]),
            "--train_fast", "True", *extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(r[11]) for r in _csv_rows(out)]
        bt, bt_std, _ = _csv_timing(out)
        print(f"imagenet 14b {label}: {wall:.2f} s in main "
              f"({c['epochs']} epochs of 2 steps, --train_fast); "
              f"BT mean of {c['epochs']} steps {bt * 1e3:.0f} ms (std "
              f"{bt_std * 1e3:.0f}), "
              f"{c['world'] * c['batch'] / result['batch_meter'].avg:.1f} "
              f"images/s; losses a step {losses}"
              + (f"; staleness {result['async_bilat']}; thread alive at "
                 f"stop {alive_at_stop}" if "async_bilat" in result else "")
              + f" [{card}]", flush=True)
        return result, losses, {n: fn.launches for n, fn in counters.items()}

    # synchronous AD-PSGD beside it, for the step's time and losses
    run("adpsgd sync")
    async_bilat.AsyncBilateralAverager.stop = watched_stop
    try:
        result, losses, launches = run("bilat_async", "--bilat_async",
                                       "True")
    finally:
        async_bilat.AsyncBilateralAverager.stop = stop
    stats = result["async_bilat"]
    if any(launches.values()):
        raise AssertionError(f"imagenet 14b: gossip launches {launches}")
    if stats["adoptions"] < 1 or not np.isfinite(losses).all() \
            or alive_at_stop != [True]:
        raise AssertionError(f"imagenet 14b: {stats}, losses {losses}, "
                             f"alive at stop {alive_at_stop}")
    _bilat_card_round(card)


def image_path(card: str) -> dict:
    """Phase 14: the reference's ImageNet command line on a JPEG tree
    written here."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="img_", dir=os.path.join(ROOT, "build"))
    try:
        root = os.path.join(tmp, "tree")
        _write_images(root)
        print(f"imagenet: {IMAGES['classes']} classes of {IMAGES['train']} "
              f"train and {IMAGES['val']} val JPEGs, {IMAGES['width']}x"
              f"{IMAGES['height']} px, written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        launches = image_cli(card, root, tmp)
        image_bilat(card, root, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"imagenet: phase 14 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


# -- phase 15: the LM command line's harness --------------------------------


class _HarnessClock:
    """Inside a ``with``: the seconds of the LM CLI's model init, of each
    train step and eval step (the device drained before and after), and
    the seconds and bytes of every checkpoint save and restore
    (``CheckpointManager``, the device drained first, so the clock holds
    the copies to and from the host and the files)."""

    def __enter__(self):
        import torch

        from stochastic_gradient_push_torch.train import lm
        from stochastic_gradient_push_torch.utils import checkpoint

        self.init, self.steps, self.evals = [], [], []
        self.saves, self.restores = [], []

        def timed(fn, into):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return run

        cls = checkpoint.CheckpointManager
        save, restore = cls.save, cls.restore

        def timed_save(mgr, state, meta, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths = save(mgr, state, meta, **kw)
            self.saves.append((time.perf_counter() - t0,
                               sum(os.path.getsize(p) for p in paths)))
            return paths

        def timed_restore(mgr, template):
            out = timed(restore, self.restores)(mgr, template)
            self.restores[-1] = (self.restores[-1], sum(
                os.path.getsize(mgr.path(r)) for r in mgr.ranks))
            return out

        self.real = [(lm, "init_lm_state", lm.init_lm_state),
                     (lm, "build_lm_train_step", lm.build_lm_train_step),
                     (lm, "build_lm_eval_step", lm.build_lm_eval_step),
                     (cls, "save", save), (cls, "restore", restore)]
        lm.init_lm_state = timed(lm.init_lm_state, self.init)
        build_train, build_eval = lm.build_lm_train_step, lm.build_lm_eval_step
        lm.build_lm_train_step = lambda *a, **k: timed(build_train(*a, **k),
                                                       self.steps)
        lm.build_lm_eval_step = lambda *a, **k: timed(build_eval(*a, **k),
                                                      self.evals)
        cls.save, cls.restore = timed_save, timed_restore
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.real:
            setattr(owner, name, fn)

    def summary(self, wall: float) -> str:
        io_s = [t for t, _ in self.saves + self.restores]
        rest = wall - sum(self.init + self.steps + self.evals + io_s)
        out = [f"init {sum(self.init):.2f} s",
               f"{len(self.steps)} steps {sum(self.steps):.2f} s (first "
               f"{self.steps[0] if self.steps else 0:.3f}, median "
               f"{statistics.median(self.steps) if self.steps else 0:.3f})"]
        if self.evals:
            out.append(f"{len(self.evals)} eval batches "
                       f"{sum(self.evals):.2f} s")
        out += [f"{what} {t:.2f} s for {n / 1e9:.2f} GB"
                for what, rows in (("save", self.saves),
                                   ("restore", self.restores))
                for t, n in rows]
        return ", ".join(out) + f", the rest {rest:.2f} s"


def _harness_argv(ckpt: str, *extra: str, vocab: int = 32000,
                  layers: int = 12) -> list[str]:
    c = HARNESS
    return ["--precision", "bf16", "--world_size", str(c["world"]),
            "--gossip_kernel", "pallas", "--attn", "flash", "--vocab_size",
            str(vocab), "--d_model", "768", "--n_layers", str(layers),
            "--n_heads",
            "12", "--d_ff", "3072", "--seq_len", str(c["seq_len"]),
            "--batch_size", str(c["batch"]), "--print_freq", "1", "--seed",
            "0", "--checkpoint_dir", ckpt, *extra]


def _harness_run(label: str, argv, card: str, beside=None):
    """One in-process run of ``run/gossip_lm.py`` with every counter
    zeroed just before: ``(result, launches, stdout lines, wall s,
    clock)``, the clock a :class:`_HarnessClock`.  ``beside`` names the
    other work running on the card as the run starts (a callable), which
    marks its printed times."""
    import contextlib
    import io

    import torch

    from stochastic_gradient_push_torch.run import gossip_lm

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    busy = beside() if beside else ""
    with _HarnessClock() as clock:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = gossip_lm.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    print(f"harness {label}: {wall:.2f} s in main: {clock.summary(wall)}"
          f"{_shared(busy)}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} [{card}]",
          flush=True)
    return result, launches, out.getvalue().splitlines(), wall, clock


def _harness_want(train_steps: int, eval_forwards: int = 0,
                  layers: int = 12) -> dict:
    """The launches of ``train_steps`` steps at world HARNESS["world"]
    (``layers`` a rank: one bf16 K3, K4 and K5 each; one K2 and one K1 a
    step) and of ``eval_forwards`` validation batches (K3 alone)."""
    w = HARNESS["world"] * layers
    want = {name: 0 for name in _counters()}
    want.update(dict.fromkeys(FLASH_BF16, w * train_steps))
    want["flash_fwd_bf16"] += w * eval_forwards
    want["gossip_edge_start"] = want["gossip_edge_wait"] = train_steps
    return want


def _harness_files(ckpt: str) -> dict:
    """``{(file, tensor path): tensor}`` over the directory's rank
    files, and ``{file: meta}``."""
    import torch

    tensors, metas = {}, {}
    for name in sorted(os.listdir(ckpt)):
        if name.endswith(".ckpt"):
            blob = torch.load(os.path.join(ckpt, name), weights_only=True)
            metas[name] = json.loads(blob["meta"])
            for k, t in _flat(blob["state"]).items():
                tensors[(name, k)] = t
    return tensors, metas


def _harness_losses(ckpt: str) -> list[float]:
    with open(os.path.join(ckpt, f"lm_out_n{HARNESS['world']}.csv")) as f:
        return [float(r.split(",")[1]) for r in f.read().splitlines()[1:]]


def _harness_spread(a: str, b: str) -> tuple[float, float]:
    """The largest |difference| between two directories' rank files
    (same files, same tensors, same metas, else it raises) and between
    their CSV losses."""
    ta, ma = _harness_files(a)
    tb, mb = _harness_files(b)
    if ma != mb or sorted(ta) != sorted(tb) or not ma:
        raise AssertionError(f"harness: rank files differ in kind: {ma} "
                             f"vs {mb}")
    params = max(float((ta[k].double() - tb[k].double()).abs().max())
                 if ta[k].numel() else 0.0 for k in ta)
    la, lb = _harness_losses(a), _harness_losses(b)
    if len(la) != len(lb):
        raise AssertionError(f"harness: CSV rows {la} vs {lb}")
    return params, max(abs(x - y) for x, y in zip(la, lb))


def harness_resume(card: str, tmp: str, preempt: dict) -> dict:
    """15a: N steps with ``--ckpt_every N/2``, twice (the determinism
    spread), against N/2 steps and a ``--resume True`` to N: rank files
    and CSV losses equal, or within the spread of the two straight
    runs.  ``preempt`` is 15b's run, whose subprocess runs beside."""
    n = HARNESS["steps"]
    # a token file over the whole vocabulary, n steps' batches long
    every = ["--ckpt_every", str(n // 2), "--corpus_file",
             _token_file(tmp, HARNESS["corpus"])]
    launches = []
    for label, steps, extra in (("straight", n, []), ("again", n, []),
                                ("split", n // 2, []),
                                ("split", n, ["--resume", "True"])):
        ckpt = os.path.join(tmp, f"resume_{label}")
        _, got, _, _, clock = _harness_run(
            f"15a {label} to step {steps}",
            _harness_argv(ckpt, "--num_steps", str(steps), *every, *extra,
                          layers=HARNESS["a_layers"]), card,
            beside=lambda: ("15b's subprocess"
                            if preempt["proc"].poll() is None else ""))
        done = steps - (n // 2 if extra else 0)
        want = _harness_want(done, layers=HARNESS["a_layers"])
        if got != want or len(clock.restores) != bool(extra):
            raise AssertionError(
                f"harness 15a {label}: launches {got}, expected {want}; "
                f"restores {clock.restores}")
        launches.append(got)
    straight = os.path.join(tmp, "resume_straight")
    spread, loss_spread = _harness_spread(
        straight, os.path.join(tmp, "resume_again"))
    diff, loss_diff = _harness_spread(
        straight, os.path.join(tmp, "resume_split"))
    print(f"harness 15a: two straight {n}-step runs (--ckpt_every {n // 2}) "
          f"apart by {spread:.3g} in the rank files and {loss_spread:.3g} in "
          f"the CSV losses (determinism); stopped at {n // 2} and resumed: "
          f"{diff:.3g} and {loss_diff:.3g} from the straight run "
          f"(tolerance: the spread) [{card}]", flush=True)
    if diff > spread or loss_diff > loss_spread:
        raise AssertionError(f"harness 15a: resume is {diff} / {loss_diff} "
                             f"from continuing, over the spread {spread} / "
                             f"{loss_spread}")
    for label in ("straight", "again", "split"):
        shutil.rmtree(os.path.join(tmp, f"resume_{label}"))
    return {k: sum(r[k] for r in launches) for k in launches[0]}


def _preempt_start(tmp: str) -> dict:
    """15b's subprocess, started beside 15a: the CLI on the repository's
    own ``*.md`` text, traced, and a thread that sends it SIGUSR1 once
    its first CSV row is out and waits for its exit.  Returns the run's
    paths, its argv and (once the thread is joined) its timings."""
    import threading

    c, w = HARNESS, HARNESS["world"]
    corpus = os.path.join(tmp, "repo_text.bin")
    with open(corpus, "wb") as out:
        for name in sorted(os.listdir(ROOT)):
            if name.endswith(".md"):
                with open(os.path.join(ROOT, name), "rb") as f:
                    out.write(f.read())
    ckpt = os.path.join(tmp, "preempt")
    argv = _harness_argv(ckpt, "--num_steps", str(c["preempt_steps"]),
                         "--corpus_file", corpus, "--val_frac",
                         str(c["val_frac"]), "--val_every",
                         str(c["val_every"]), "--val_batches",
                         str(c["val_batches"]), vocab=256,
                         layers=c["b_layers"])
    run = dict(corpus=corpus, ckpt=ckpt, argv=argv,
               csv_path=os.path.join(ckpt, f"lm_out_n{w}.csv"),
               log_path=os.path.join(tmp, "preempt.log"),
               # the preempted run is traced: its trace, exit record and
               # last comm snapshot must survive the exit 75
               tdir=os.path.join(tmp, "preempt_telemetry"))
    t0 = time.perf_counter()
    log = open(run["log_path"], "w")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "stochastic_gradient_push_torch.run.gossip_lm", *argv,
         "--trace_dir", run["tdir"]],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=log,
        stderr=subprocess.STDOUT)

    def watch():
        try:
            while True:
                if proc.poll() is not None or (
                        time.perf_counter() - t0 > PREEMPT_TIMEOUT_S):
                    run["error"] = ("harness 15b: no CSV row before the "
                                    "run ended or timed out")
                    return
                if os.path.exists(run["csv_path"]):
                    with open(run["csv_path"]) as f:
                        if len(f.read().splitlines()) >= 2:
                            break
                time.sleep(0.05)
            run["signalled"] = time.perf_counter() - t0
            proc.send_signal(signal.SIGUSR1)
            run["code"] = proc.wait(timeout=PREEMPT_TIMEOUT_S)
            run["exited"] = time.perf_counter() - t0
        except BaseException as e:      # noqa: BLE001 (re-raised below)
            run["error"] = repr(e)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()

    run["proc"] = proc
    run["thread"] = threading.Thread(target=watch, daemon=True)
    run["thread"].start()
    return run


def harness_preempt(card: str, tmp: str, run: dict) -> dict:
    """15b-15d: ``run`` (:func:`_preempt_start`'s) exits 75 with the rank
    files at the CSV's last step; then a resume in this process to
    ``--num_steps``, its rows running on without a gap and validation
    rows at the cadence and the end, K3 launched once more a layer a
    rank for every validation batch and K4/K5 not; then the eval step on
    the saved state on the card, kernels against plain twins."""
    import torch

    c, w = HARNESS, HARNESS["world"]
    n = c["preempt_steps"]
    run["thread"].join(2 * PREEMPT_TIMEOUT_S)
    if "error" in run or run["thread"].is_alive():
        raise AssertionError(run.get("error", "harness 15b: the subprocess "
                                              "outlived its watch"))
    corpus, ckpt, argv = run["corpus"], run["ckpt"], run["argv"]
    csv_path, tdir = run["csv_path"], run["tdir"]
    code, signalled, exited = run["code"], run["signalled"], run["exited"]
    with open(run["log_path"]) as f:
        log_text = f.read()
    if code != 75:
        raise AssertionError(f"harness 15b: exit {code}, expected 75:\n"
                             f"{log_text[-2000:]}")
    metas = [json.loads(torch.load(os.path.join(
        ckpt, f"lm_checkpoint_r{r}_n{w}.ckpt"), weights_only=True)["meta"])
        for r in range(w)]
    k = metas[0]["step"]
    with open(csv_path) as f:
        rows = [r.split(",")[0] for r in f.read().splitlines()[1:]]
    if any(m["step"] != k for m in metas) or rows != [
            str(i + 1) for i in range(k)]:
        raise AssertionError(f"harness 15b: metas {metas}, rows {rows}")
    events, spans = _telemetry("harness 15b", tdir, kinds=(
        "plan", "run_meta", "comm"))
    exit_meta = [e for e in events if e["kind"] == "run_meta"
                 and "exit_reason" in e["data"]]
    print(f"harness 15b: telemetry after the exit: {len(events)} events, "
          f"the exit record {json.dumps(exit_meta[-1]['data'])} at step "
          f"{exit_meta[-1].get('step')}, the last a {events[-1]['kind']} "
          f"event of {events[-1]['data'].get('steps')} steps; trace.json "
          f"{_span_split(spans)} [{card}]", flush=True)
    if (not exit_meta
            or exit_meta[-1]["data"]["exit_reason"] != "preempt-requeue"
            or exit_meta[-1]["step"] != k or events[-1]["kind"] != "comm"
            or events[-1]["data"]["steps"] != k):
        raise AssertionError(f"harness 15b: telemetry {events[-3:]}")
    result, launches, lines, wall, clock = _harness_run(
        f"15b resume from step {k} to {n}", argv + ["--resume", "True"],
        card)
    with open(csv_path) as f:
        rows = [r.split(",") for r in f.read().splitlines()[1:]]
    corpus_line = [x for x in log_text.splitlines()
                   if x.startswith("corpus: ")]
    print(f"harness 15b: SIGUSR1 {signalled:.1f} s into the subprocess, "
          f"exit {code} at step {k} after {exited:.1f} s"
          f"{_shared('15a')}; the resume's "
          f"rows run on to {rows[-1][0]}; "
          f"{corpus_line[0] if corpus_line else 'no corpus line'}; "
          f"rows (step:loss/val_loss) "
          f"{[r[0] + ':' + r[1] + '/' + r[6] for r in rows]} [{card}]",
          flush=True)
    due = [(i + 1) % c["val_every"] == 0 or i + 1 == n for i in range(n)]
    n_eval = sum(due[k:]) * c["val_batches"]
    if ([r[0] for r in rows] != [str(i + 1) for i in range(n)]
            or [bool(r[6]) for r in rows] != due
            or not corpus_line
            or not all(math.isfinite(float(v)) for r in rows
                       for v in r[:6] + (r[6:] if r[6] else []))):
        raise AssertionError(f"harness 15b-d: rows {rows}")
    want = _harness_want(n - k, n_eval, c["b_layers"])
    if launches != want or len(clock.evals) != n_eval:
        raise AssertionError(f"harness 15c: launches {launches}, expected "
                             f"{want}; {len(clock.evals)} eval batches")
    print(f"harness 15c: {n_eval} validation batches in "
          f"{sum(clock.evals):.2f} s = {sum(clock.evals) / wall:.1%} of the "
          f"resumed run's {wall:.2f} s in main ({sum(clock.steps):.2f} s "
          f"in its {n - k} steps); K3 {launches['flash_fwd_bf16']} = {w} x "
          f"{c['b_layers']} x ({n - k} steps + {n_eval} eval batches), K4/K5 "
          f"{launches['flash_bwd_dq_bf16']}/"
          f"{launches['flash_bwd_dkv_bf16']} (the steps alone) [{card}]",
          flush=True)
    _harness_eval_lanes(card, ckpt, corpus)
    shutil.rmtree(ckpt)
    return launches


def _harness_eval_lanes(card: str, ckpt: str, corpus_path: str) -> None:
    """15c: the eval step on the state saved in ``ckpt`` (vocab 256) on
    the first held-out batch, the bf16 K3 against the plain twins
    (``attn_lane="plain"``) on the card."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch import algorithms as alg_mod
    from stochastic_gradient_push_torch.data.lm import (lm_batches,
                                                        load_corpus)
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.run.gossip_lm import split_corpus
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train import lm as tlm
    from stochastic_gradient_push_torch.train.state import sgd
    from stochastic_gradient_push_torch.utils.checkpoint import (
        CheckpointManager)

    c, w = HARNESS, HARNESS["world"]
    held = split_corpus(load_corpus(corpus_path, 256), c["val_frac"],
                        (c["seq_len"] + 1) * w * c["batch"])[1]
    vt, vy = next(lm_batches(held, w, 1, c["batch"], c["seq_len"], seed=1))
    toks, tgts = (torch.from_numpy(a[:, 0]).cuda() for a in (vt, vy))
    alg = alg_mod.sgp(build_schedule(
        NPeerDynamicDirectedExponentialGraph(w)), StackedTransport(w))
    losses, state = {}, None
    for lane in ("kernel", "plain"):
        cfg = TransformerConfig(vocab_size=256, d_model=768,
                                n_layers=c["b_layers"],
                                n_heads=12, d_ff=3072, attn_impl="flash",
                                attn_lane="auto" if lane == "kernel"
                                else "plain", dtype=torch.bfloat16)
        if state is None:
            state, _ = CheckpointManager(ckpt, tag="lm_", world_size=w,
                                         ranks=range(w)).restore(
                tlm.init_lm_state(cfg, alg, sgd(momentum=0.9), w,
                                  device="cuda"))
        counters = _counters()
        for k in counters.values():
            k.launches = 0
        losses[lane] = tlm.build_lm_eval_step(tlm.make_model(cfg), alg)(
            state, toks, tgts)["loss"].float().cpu().numpy()
        fired = {k: v.launches for k, v in counters.items() if v.launches}
        if fired != ({"flash_fwd_bf16": w * c["b_layers"]} if lane == "kernel"
                     else {}):
            raise AssertionError(f"harness 15c {lane}: launches {fired}")
    del state
    rel = float(np.max(np.abs(losses["kernel"] - losses["plain"])
                       / np.abs(losses["plain"])))
    print(f"harness 15c: eval loss on the saved state, kernels "
          f"{losses['kernel'].tolist()} vs plain twins "
          f"{losses['plain'].tolist()} on the card, max relative diff "
          f"{rel:.3g} (tolerance {TOL_HARNESS_LOSS_REL}) [{card}]",
          flush=True)
    if not rel <= TOL_HARNESS_LOSS_REL:
        raise AssertionError("harness 15c: eval losses differ")


def harness_path(card: str) -> dict:
    """Phase 15: the LM command line's harness at the LM's full width
    (bf16, world 2 stacked, SGP on K2/K1, flash attention): resume equals
    continue, preemption, validation and a file corpus.  Returns the
    main path's launches."""
    import torch

    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lm_harness_",
                           dir=os.path.join(ROOT, "build"))
    try:
        # 15b's subprocess starts first and runs beside 15a
        preempt = _preempt_start(tmp)
        runs = [harness_resume(card, tmp, preempt)]
        torch.cuda.empty_cache()
        runs.append(harness_preempt(card, tmp, preempt))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"harness: phase 15 in {time.perf_counter() - t0:.1f} s (15b's "
          f"subprocess beside 15a)", flush=True)
    return {n: sum(r[n] for r in runs) for n in runs[0]}


# -- phase 16: intra-node averaging and gossip without a model --------------

# 16a/16b: phase 8's CLI run (ResNet-50, 224 px, 32 a device row, world 4,
# two epochs of three steps, SGP f32) with --nprocs_per_node 2: 2 nodes of
# 2 devices, one gossip round a step between the nodes
HIER_LOCAL = 2
# 16c: push_sum_average over ResNet-50's parameters at world 8 stacked,
# each rank the seed-0 init plus its own noise of this scale, 40 rounds of
# the n-peer exponential graph; consensus below HIER_CONSENSUS and the
# mean within HIER_MEAN of float64's, both relative to the parameter scale
HIER_AVG = dict(world=8, rounds=40, noise=0.01)
HIER_CONSENSUS = 1e-5
HIER_MEAN = 1e-6


def _node_files(ckpt_dir: str, nodes: int, world: int) -> list[dict]:
    import torch

    return [_flat(torch.load(os.path.join(
        ckpt_dir, f"checkpoint_r{r}_n{world}.ckpt"), weights_only=True)[
        "state"]) for r in range(nodes)]


def _csv_outside_timing(path: str) -> list[list[str]]:
    with open(path) as f:
        rows = [line.split(",") for line in f.read().splitlines()]
    return rows[:5] + [r[:2] + r[11:] for r in rows[5:]]


def hierarchical_cli(card: str, tmp: str, flat_bt: float) -> dict:
    """16a and 16b: the CLI with ``--nprocs_per_node 2`` stacked (the
    kernel lane timed, then both lanes from one state under deterministic
    cuDNN) and under a torchrun environment in 2 processes, one node
    each, against the stacked plain lane.  Returns the main runs'
    launches (16a's kernel-lane run and 16b's processes)."""
    import torch

    world, local = CLI["world"], HIER_LOCAL
    nodes, steps = world // local, CLI["epochs"] * CLI["itrs"]
    hier = ("--nprocs_per_node", str(local))
    ckpt = os.path.join(tmp, "main")
    launches, result = _cli_run("16a sgp", _cli_argv(
        ckpt, "--gossip_kernel", "pallas", *hier), card)
    _assert_gossip_launches("16a sgp", launches, 1)
    _check_csv(os.path.join(ckpt, f"out_r0_n{world}.csv"), "16a sgp")
    bt = result["batch_meter"].avg
    print(f"hier 16a: {nodes} nodes x {local} devices, {steps} steps: one K2 "
          f"and one K1 a step; BT {bt * 1e3:.2f} ms against phase 8's flat "
          f"world-{world} SGP BT {flat_bt * 1e3:.2f} ms (the same "
          f"{world} forward/backward passes of {CLI['batch']}, "
          f"{nodes} gossip ranks instead of {world}) [{card}]", flush=True)

    # 16b's processes start now and run beside 16a's lanes
    def torchrun(r, port):
        return dict(RANK=str(r), WORLD_SIZE=str(nodes), LOCAL_RANK=str(r),
                    LOCAL_WORLD_SIZE=str(nodes), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port))

    procs = _ranks(_DIST_CLI_CHILD, nodes, [json.dumps(_cli_argv(
        os.path.join(tmp, "dist"), "--gossip_kernel", "pallas", *hier,
        "--backend", "gloo", "--verbose", "True"))], torchrun)
    torch.backends.cudnn.deterministic = True
    try:
        lanes = {}
        for lane in ("pallas", "xla"):
            d = os.path.join(tmp, f"lane_{lane}")
            got, _ = _cli_run(f"16a {lane} lane", _cli_argv(
                d, "--gossip_kernel", lane, *hier), card)
            _assert_gossip_launches(f"16a {lane} lane", got,
                                    1 if lane == "pallas" else 0)
            lanes[lane] = _node_files(d, nodes, world)
    finally:
        torch.backends.cudnn.deterministic = False
    err = max(_max_err(a[n], b[n]) for a, b in zip(lanes["pallas"],
                                                   lanes["xla"]) for n in a)
    exact = all(torch.equal(a[n], b[n]) for a, b in zip(
        lanes["pallas"], lanes["xla"]) for n in a)
    ps_equal = all(torch.equal(a["ps_weight"], b["ps_weight"])
                   for a, b in zip(lanes["pallas"], lanes["xla"]))
    print(f"hier 16a lanes: kernel vs plain lane, {steps} steps from one "
          f"state under deterministic cuDNN: ps-weight bit-equal "
          f"{ps_equal}; max |diff| {err:.3e} over params, momentum and "
          f"statistics (tolerance {TOL_STEP_PARAM}); exactly equal {exact} "
          f"[{card}]", flush=True)
    if not (ps_equal and err <= TOL_STEP_PARAM):
        raise AssertionError("hier 16a: the lanes differ")

    logs = _join("16b", procs)
    dist = {}
    for r, log in enumerate(logs):
        rows = list(range(r * local, (r + 1) * local))
        if f"feeding batch rows {rows}" not in log:
            raise AssertionError(f"16b process {r}: no 'feeding batch rows "
                                 f"{rows}' line")
        got = _tagged(log, "LAUNCHES")
        want = {"gossip_edge_start": 0, "gossip_edge_wait": 0,
                "gossip_edge_start_ipc": steps, "gossip_edge_wait_ipc": steps}
        if got != want:
            raise AssertionError(f"16b process {r}: launches {got}, expected "
                                 f"{want} (one cross-process start and wait "
                                 f"a step)")
        for k, v in got.items():
            dist[k] = dist.get(k, 0) + v
    got = _node_files(os.path.join(tmp, "dist"), nodes, world)
    worst, n_exact = 0.0, 0
    for r, (g, w) in enumerate(zip(got, lanes["xla"])):
        if sorted(g) != sorted(w) or not torch.equal(g["ps_weight"],
                                                     w["ps_weight"]):
            raise AssertionError(f"16b node {r}: rank file differs")
        for k in w:
            # phase 13b's tolerance (tests/test_torch_resnet_step.py's)
            torch.testing.assert_close(g[k], w[k], rtol=1e-5, atol=1e-6,
                                       msg=f"16b node {r} {k}")
            worst = max(worst, _max_err(g[k], w[k]))
            n_exact += bool(torch.equal(g[k], w[k]))
    rows_dist = _csv_outside_timing(os.path.join(tmp, "dist",
                                                 f"out_r0_n{world}.csv"))
    rows_stacked = _csv_outside_timing(os.path.join(
        tmp, "lane_xla", f"out_r0_n{world}.csv"))
    if rows_dist != rows_stacked:
        raise AssertionError(f"16b: CSV rows {rows_dist} differ from the "
                             f"stacked plain lane's {rows_stacked}")
    print(f"hier 16b: run/gossip_sgd.py in {nodes} processes (one node of "
          f"{local} devices each, rows [0, 1] and [2, 3], --backend gloo, "
          f"--gossip_kernel pallas): one cross-process K2 and K1 a step in "
          f"each; CSV rows equal to the stacked plain lane's outside "
          f"timing; rank files: max |diff| {worst:.3g}, {n_exact} of "
          f"{sum(len(w) for w in lanes['xla'])} tensors exactly equal "
          f"[{card}]", flush=True)
    return {n: launches.get(n, 0) + dist.get(n, 0)
            for n in {*launches, *dist}}


def hierarchical_averaging(card: str) -> None:
    """16c: ``push_sum_average`` on ResNet-50's parameters at world 8
    stacked on the card: consensus, the float64 mean, ms a round and the
    peak memory."""
    import torch

    from stochastic_gradient_push_torch.models.convert import (
        init_model_params)
    from stochastic_gradient_push_torch.parallel.averaging import (
        consensus_error, push_sum_average)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.step import make_model

    c = HIER_AVG
    params, _ = init_model_params(make_model("resnet50", num_classes=1000),
                                  0)
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {n: p.cuda()[None] + c["noise"] * torch.randn(
        (c["world"], *p.shape), generator=g, device="cuda")
        for n, p in params.items()}
    del params
    numel = sum(t[0].numel() for t in tree.values())
    scale = max(float(t.abs().max()) for t in tree.values())
    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(
        c["world"], peers_per_itr=1))
    transport = StackedTransport(c["world"])
    before = consensus_error(tree)
    out = push_sum_average(tree, transport, sched, rounds=c["rounds"])
    after = consensus_error(out)
    mean_err = max(float((out[n].double() - t.double().mean(0)).abs().max())
                   for n, t in tree.items())
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = push_sum_average(tree, transport, sched, rounds=c["rounds"])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / c["rounds"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"hier 16c: push_sum_average on ResNet-50's {numel:,} parameters "
          f"x {c['world']} ranks ({c['world'] * numel * 4 / 1e6:.0f} MB), "
          f"{c['rounds']} rounds of the n-peer exponential graph: consensus "
          f"error {before:.3e} -> {after:.3e} ({after / scale:.3e} of the "
          f"parameter scale {scale:.3f}; limit {HIER_CONSENSUS}), the mean "
          f"within {mean_err:.3e} of float64's ({mean_err / scale:.3e}; "
          f"limit {HIER_MEAN}); {ms:.3f} ms a round (the plain round, CUDA "
          f"events over the call, de-bias included), peak "
          f"{peak:.2f} GB [{card}]", flush=True)
    del out, tree
    if not after <= HIER_CONSENSUS * scale:
        raise AssertionError("hier 16c: no consensus")
    if not mean_err <= HIER_MEAN * scale:
        raise AssertionError("hier 16c: the consensus is not the mean")


def hierarchical_path(card: str, flat_bt: float) -> dict:
    """Phase 16: ``--nprocs_per_node`` on the stacked and torchrun lanes
    (16a, 16b), then ``push_sum_average`` on the card (16c).  Returns the
    main runs' launches."""
    import torch

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hier_", dir=os.path.join(ROOT, "build"))
    try:
        launches = hierarchical_cli(card, tmp, flat_bt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    hierarchical_averaging(card)
    print(f"hier: phase 16 in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# -- phase 17: resume at another world, serve the consensus, DCP ------------

# 17a/17b: phase 8's SGP command (ResNet-50, 224 px, fp32, 32 images a
# rank, three steps an epoch) at world 4 for one epoch, then resumed at
# world 2 for a second: stacked (17a), in 2 torchrun processes (17b)
RESHARD = dict(old=4, new=2)
# 17c: run/gossip_lm.py at phase 15's shape, cut to 4 layers (12 until
# phase 22 came), under --ckpt_backend orbax: 4 steps straight, twice
# (the spread), and 2 steps resumed to 4, a save every 2 steps, the
# newest 3 kept (few steps: the saves set the script's time)
DCP_LM = dict(steps=4, split=2, every=2, keep=3, layers=4)
# 17d: a 2-step world-2 run of the same LM on the per-rank files
CONSENSUS_STEPS = 2

# 17b and 17e: the CLI's runs (argv lists, in order) in one process of a
# torchrun environment, on one group the child joins first (a process
# that makes a new default group after a DCP save of DTensors may reach
# the old group's store, seen with torch 2.13); the reshard's report
# (its files copied aside before the run overwrites them), a digest of
# every state the DCP backend saves and restores, and the launch counts
_P17_CHILD = r"""
import hashlib, json, shutil, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from stochastic_gradient_push_torch.ops import gossip_kernel as gk
from stochastic_gradient_push_torch.parallel import multihost
from stochastic_gradient_push_torch.run import gossip_sgd
from stochastic_gradient_push_torch.supervise import reshard
from stochastic_gradient_push_torch.utils import dcp_ckpt

counters = {"gossip_edge_start": (gk.gossip_edge_start, "launches"),
            "gossip_edge_wait": (gk.gossip_edge_wait, "launches"),
            "gossip_edge_start_ipc": (gk.gossip_edge_start, "launches_ipc"),
            "gossip_edge_wait_ipc": (gk.gossip_edge_wait, "launches_ipc")}
for fn, attr in counters.values():
    setattr(fn, attr, 0)
got = {"reshard": [], "saved": [], "restored": []}
real = reshard.maybe_cross_world_reshard

def spy(*a, **k):
    t0 = time.perf_counter()
    report = real(*a, **k)
    if report is not None:
        for p in report.files_out:
            shutil.copyfile(p, p + ".resharded")
        got["reshard"].append(dict(report.to_dict(),
                                   seconds=time.perf_counter() - t0))
    return report

reshard.maybe_cross_world_reshard = spy

def digest(state):
    h = hashlib.sha256()
    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + "/" + k)
        elif isinstance(t, torch.Tensor):
            h.update(path.encode())
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    walk(dcp_ckpt._to_tree(state), "")
    return h.hexdigest()

cls = dcp_ckpt.DcpCheckpointManager
save, restore = cls.save, cls.restore

def spy_save(self, state, meta, **kw):
    got["saved"].append(digest(state))
    return save(self, state, meta, **kw)

def spy_restore(self, template):
    state, meta = restore(self, template)
    got["restored"].append(digest(state))
    return state, meta

cls.save, cls.restore = spy_save, spy_restore
multihost.initialize_multihost("gloo", torch.device("cuda", 0))
for argv in json.loads(sys.argv[5]):
    gossip_sgd.main(argv)
print("PHASE17 " + json.dumps(got), flush=True)
print("LAUNCHES " + json.dumps({k: getattr(fn, attr)
                                for k, (fn, attr) in counters.items()}),
      flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _torchrun_env(world: int):
    def env(r, port):
        return dict(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                    LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port))
    return env


class _Lines:
    """Inside a ``with``: the messages the trainer's logger emits."""

    def __enter__(self):
        import logging

        self.lines = []
        outer = self

        class Keep(logging.Handler):
            def emit(self, record):
                outer.lines.append(record.getMessage())

        self.handler = Keep()
        self.logger = logging.getLogger(
            "stochastic_gradient_push_torch.utils.logging.ranktrainer")
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def _state_tensors(path: str) -> dict:
    import torch

    row = torch.load(path, weights_only=True)["state"]
    out = _flat(row)
    out["step"] = torch.tensor(row["step"])
    out["phase"] = torch.tensor(row["gossip"]["phase"])
    return out


def _consensus_f32(rows: list) -> dict:
    """The float64 Σx/Σw of rank rows (the rows summed in rank order,
    then each in-flight slot's), cast to f32: the reshard's arithmetic,
    in torch on the host."""
    w_sum = 0.0
    for r in rows:
        w_sum += float(r["gossip"]["ps_weight"].double())
    out = {}
    for n in rows[0]["params"]:
        num = rows[0]["params"][n].double()
        for r in rows[1:]:
            num = num + r["params"][n].double()
        out[n] = (num / w_sum).float()
    return out


def reshard_cli(card: str, tmp: str) -> tuple[dict, list]:
    """17a (and 17b's start): the world-4 run, copies of its set, the
    world-2 resume with the reshard timed, and ``reshard_checkpoints`` on
    a copy against the float64 consensus.  Returns the stacked runs'
    launches and 17b's processes."""
    old, new = RESHARD["old"], RESHARD["new"]
    ckpt = os.path.join(tmp, "a")
    kernel = ("--gossip_kernel", "pallas")
    first, _ = _cli_run(f"17a world {old}", _cli_argv(ckpt, *kernel,
                                                      epochs=1), card)
    names = [f"checkpoint_r{r}_n{old}.ckpt" for r in range(old)]
    for d in ("b", "c"):
        os.makedirs(os.path.join(tmp, d))
        for n in names:
            shutil.copyfile(os.path.join(ckpt, n), os.path.join(tmp, d, n))
    procs = _ranks(_P17_CHILD, new, [json.dumps([_cli_argv(
        os.path.join(tmp, "b"), *kernel, "--world_size", str(new),
        "--resume", "True", "--backend", "gloo")])], _torchrun_env(new))
    try:
        launches = _reshard_resume(card, tmp, ckpt, first, names)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return launches, procs


def _reshard_resume(card: str, tmp: str, ckpt: str, first: dict,
                    names: list) -> dict:
    """17a after the world-4 run: the world-2 resume, then the copy."""
    import torch

    from stochastic_gradient_push_torch.supervise import reshard

    old, new = RESHARD["old"], RESHARD["new"]
    steps = CLI["itrs"]
    kernel = ("--gossip_kernel", "pallas")

    timed = {}
    real = reshard.maybe_cross_world_reshard

    def spy(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = real(*a, **k)
        timed["s"] = time.perf_counter() - t0
        timed["report"] = report
        return report

    reshard.maybe_cross_world_reshard = spy
    try:
        with _Lines() as lines:
            second, _ = _cli_run(f"17a world {new} resumed", _cli_argv(
                ckpt, *kernel, "--world_size", str(new), "--resume", "True"),
                card, world=new)
    finally:
        reshard.maybe_cross_world_reshard = real
    want_line = f"resharded checkpoint set n={old} -> n={new}"
    if not any(want_line in m for m in lines.lines):
        raise AssertionError(f"17a: no '{want_line}' line in {lines.lines}")
    report = timed["report"]
    gb_in = sum(os.path.getsize(p) for p in report.files_in) / 1e9
    gb_out = sum(os.path.getsize(p) for p in report.files_out) / 1e9
    for label, got in ((f"world {old}", first), (f"world {new}", second)):
        want = {n: 0 for n in got}
        want["gossip_edge_start"] = want["gossip_edge_wait"] = steps
        if got != want:
            raise AssertionError(f"17a {label}: launches {got}, expected "
                                 f"{want} (one K2 and one K1 a step)")
    with open(os.path.join(ckpt, f"out_r0_n{new}.csv")) as f:
        rows = [r.split(",") for r in f.read().splitlines()[5:]]
    if len(rows) != steps + 2 or not all(
            math.isfinite(float(v)) for r in rows for v in r[2:]):
        raise AssertionError(f"17a: world-{new} CSV rows {rows}")
    print(f"ckpt 17a: resumed the world-{old} set at world {new}: "
          f"'{want_line}'; the reshard {timed['s']:.2f} s, "
          f"{gb_in:.2f} GB read, {gb_out:.2f} GB written, mean drift "
          f"{report.mean_drift:.3e}; then {steps} steps at world {new}, one "
          f"K2 and K1 each, losses {[r[11] for r in rows[:-1]]} [{card}]",
          flush=True)

    copy = os.path.join(tmp, "c")
    t0 = time.perf_counter()
    rep = reshard.reshard_checkpoints(copy, "", old, new)
    seconds = time.perf_counter() - t0
    rows_in = [torch.load(os.path.join(copy, n), weights_only=True)["state"]
               for n in names]
    want = _consensus_f32(rows_in)
    del rows_in
    exact, ps_one = True, True
    for r in range(new):
        row = torch.load(os.path.join(copy, f"checkpoint_r{r}_n{new}.ckpt"),
                         weights_only=True)["state"]
        exact &= all(torch.equal(row["params"][n], w) for n, w in want.items())
        ps_one &= bool(row["gossip"]["ps_weight"] == 1.0)
    print(f"ckpt 17a: reshard_checkpoints on a copy, world {old} -> {new} in "
          f"{seconds:.2f} s: params equal to the float64 Σx/Σw cast to f32 "
          f"exactly: {exact} ({len(want)} tensors a rank); ps-weight 1: "
          f"{ps_one}; mean_drift {rep.mean_drift:.3e}, ps_mass_err "
          f"{rep.ps_mass_err:.3e} [{card}]", flush=True)
    if not (exact and ps_one):
        raise AssertionError("17a: the reshard is not the consensus")
    return {n: first.get(n, 0) + second.get(n, 0) for n in first}


def reshard_dist_check(card: str, tmp: str, procs) -> dict:
    """17b: the torchrun processes' reshards against 17a's copy."""
    import torch

    new, steps = RESHARD["new"], CLI["itrs"]
    logs = _join("17b", procs)
    launches = {}
    for r, log in enumerate(logs):
        got = _tagged(log, "PHASE17")["reshard"]
        want_file = f"checkpoint_r{r}_n{new}.ckpt"
        if len(got) != 1 or got[0]["files_out"] != [want_file]:
            raise AssertionError(f"17b process {r}: reshards {got}, expected "
                                 f"one writing {want_file}")
        mine = _state_tensors(os.path.join(tmp, "b", want_file
                                           + ".resharded"))
        ref = _state_tensors(os.path.join(tmp, "c", want_file))
        if sorted(mine) != sorted(ref) or not all(
                torch.equal(mine[k], ref[k]) for k in ref):
            raise AssertionError(f"17b process {r}: its resharded file "
                                 "differs from 17a's copy")
        counts = _tagged(log, "LAUNCHES")
        want = {"gossip_edge_start": 0, "gossip_edge_wait": 0,
                "gossip_edge_start_ipc": steps, "gossip_edge_wait_ipc": steps}
        if counts != want:
            raise AssertionError(f"17b process {r}: launches {counts}, "
                                 f"expected {want}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        print(f"ckpt 17b: process {r} resharded its own file {want_file} in "
              f"{got[0]['seconds']:.2f} s, bit-equal to 17a's copy "
              f"({len(ref)} tensors); {steps} steps with one cross-process "
              f"K2 and K1 each, no stacked one [{card}]", flush=True)
    return launches


def _dcp_tensors(path: str) -> dict:
    """Every tensor of a DCP checkpoint directory, on the host."""
    import torch
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata()
    out = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
           for k, m in meta.state_dict_metadata.items()
           if hasattr(m, "size")}
    dcp.load(out, checkpoint_id=path, no_dist=True)
    return out


class _DcpSpy:
    """Inside a ``with``: every ``DcpCheckpointManager`` made, and the
    seconds of each restore."""

    def __enter__(self):
        from stochastic_gradient_push_torch.utils import dcp_ckpt

        self.cls = dcp_ckpt.DcpCheckpointManager
        self.managers, self.restores = [], []
        init, restore = self.cls.__init__, self.cls.restore
        self.real = init, restore
        outer = self

        def spy_init(mgr, *a, **k):
            init(mgr, *a, **k)
            outer.managers.append(mgr)

        def spy_restore(mgr, template):
            t0 = time.perf_counter()
            out = restore(mgr, template)
            outer.restores.append(time.perf_counter() - t0)
            return out

        self.cls.__init__, self.cls.restore = spy_init, spy_restore
        return self

    def __exit__(self, *exc):
        self.cls.__init__, self.cls.restore = self.real


def dcp_lm(card: str, tmp: str, corpus: str) -> dict:
    """17c: the LM CLI under ``--ckpt_backend orbax``: straight runs
    twice, a split run resumed, retention, the save's two clocks beside
    ``torch.save``, the launches."""
    import torch

    c = DCP_LM
    flags = ["--ckpt_backend", "orbax", "--ckpt_every", str(c["every"]),
             "--corpus_file", corpus]
    launches, saves, restores = [], [], []
    for label, steps, extra in (("straight", c["steps"], []),
                                ("again", c["steps"], []),
                                ("split", c["split"], []),
                                ("split", c["steps"], ["--resume", "True"])):
        ckpt = os.path.join(tmp, f"lm_{label}")
        with _DcpSpy() as spy:
            _, got, _, _, _ = _harness_run(
                f"17c {label} to step {steps}",
                _harness_argv(ckpt, "--num_steps", str(steps), *flags,
                              *extra, layers=c["layers"]), card)
        done = steps - (c["split"] if extra else 0)
        want = _harness_want(done, layers=c["layers"])
        if got != want or len(spy.restores) != bool(extra):
            raise AssertionError(f"17c {label}: launches {got}, expected "
                                 f"{want}; restores {spy.restores}")
        launches.append(got)
        saves += [h for m in spy.managers for h in m.history]
        restores += spy.restores
    roots = {label: os.path.join(tmp, f"lm_{label}",
                                 f"lm_dcp_r0_n{HARNESS['world']}")
             for label in ("straight", "again", "split")}
    for label, root in roots.items():
        kept = sorted(int(n) for n in os.listdir(root) if n.isdigit())
        if len(kept) > c["keep"] or kept[-1] != c["steps"] or not all(
                os.path.isfile(os.path.join(root, str(k), ".metadata"))
                for k in kept):
            raise AssertionError(f"17c {label}: step directories {kept}")
    final = {label: _dcp_tensors(os.path.join(root, str(c["steps"])))
             for label, root in roots.items()}

    def apart(a, b):
        if sorted(a) != sorted(b):
            raise AssertionError("17c: checkpoints differ in kind")
        return max(float((a[k].double() - b[k].double()).abs().max())
                   if a[k].numel() else 0.0 for k in a)

    spread = apart(final["straight"], final["again"])
    diff = apart(final["straight"], final["split"])
    losses = {label: _harness_losses(os.path.join(tmp, f"lm_{label}"))
              for label in roots}
    loss_spread = max(abs(x - y) for x, y in zip(losses["straight"],
                                                 losses["again"]))
    if len(losses["split"]) != len(losses["straight"]):
        raise AssertionError(f"17c: CSV rows {losses}")
    loss_diff = max(abs(x - y) for x, y in zip(losses["straight"],
                                               losses["split"]))
    path = os.path.join(tmp, "torch_save.pt")
    t0 = time.perf_counter()
    torch.save(final["straight"], path)
    ts = time.perf_counter() - t0
    gb = sum(t.numel() * t.element_size()
             for t in final["straight"].values()) / 1e9
    os.remove(path)
    stage = [h["stage_s"] for h in saves]
    write = [h["write_s"] for h in saves]
    print(f"ckpt 17c: --ckpt_backend orbax (torch.distributed.checkpoint): "
          f"{len(saves)} saves of {saves[0]['bytes'] / 1e9:.2f} GB hold the "
          f"run {min(stage):.3f}-{max(stage):.3f} s (the host copy), write "
          f"in the background in {min(write):.2f}-{max(write):.2f} s; "
          f"torch.save of the same {gb:.2f} GB of tensors {ts:.2f} s; "
          f"restores {', '.join(f'{t:.2f}' for t in restores)} s; step "
          f"directories kept {c['keep']} at most [{card}]", flush=True)
    print(f"ckpt 17c: two straight {c['steps']}-step runs apart by "
          f"{spread:.3g} in the step-{c['steps']} checkpoint and "
          f"{loss_spread:.3g} in the CSV losses; stopped at {c['split']} and "
          f"resumed: {diff:.3g} and {loss_diff:.3g} (tolerance: the spread) "
          f"[{card}]", flush=True)
    if diff > spread or loss_diff > loss_spread:
        raise AssertionError(f"17c: resume is {diff} / {loss_diff} from "
                             f"continuing, over the spread {spread} / "
                             f"{loss_spread}")
    del final
    return {k: sum(r[k] for r in launches) for k in launches[0]}


def serve_consensus(card: str, tmp: str, corpus: str) -> dict:
    """17d: a 2-step run on the per-rank files, its consensus ingested
    and served as phases 3 and 4 serve the seed-0 model."""
    from stochastic_gradient_push_torch.models.convert import params_to_jax
    from stochastic_gradient_push_torch.serve.load import load_consensus

    ckpt = os.path.join(tmp, "lm_serve")
    _, got, _, _, _ = _harness_run(
        "17d", _harness_argv(ckpt, "--num_steps", str(CONSENSUS_STEPS),
                             "--corpus_file", corpus), card)
    if got != _harness_want(CONSENSUS_STEPS):
        raise AssertionError(f"17d: launches {got}, expected "
                             f"{_harness_want(CONSENSUS_STEPS)}")
    t0 = time.perf_counter()
    params, _, info = load_consensus(ckpt, tag="lm_")
    seconds = time.perf_counter() - t0
    print(f"ckpt 17d: load_consensus {json.dumps(info.to_dict())} in "
          f"{seconds:.2f} s ({sum(p.numel() for p in params.values()):,} "
          f"parameters) [{card}]", flush=True)
    if info.world != HARNESS["world"] or info.step != CONSENSUS_STEPS:
        raise AssertionError(f"17d: ingested {info}")
    tree = params_to_jax(params)
    engine, requests, launches, _ = main_path(card, tree,
                                              label="ckpt 17d serve")
    engine_vs_dense(engine, requests, card, tree)
    del engine
    return {n: got.get(n, 0) + launches.get(n, 0)
            for n in {*got, *launches}}, tree


def dcp_dist_check(card: str, tmp: str, procs) -> dict:
    """17e: the DCP backend under torchrun: one shared root, each
    process's rows restored as saved, and the rows apart."""
    world, steps = DIST_CLI["world"], DIST_CLI["itrs"]
    logs = _join("17e", procs)
    names = os.listdir(os.path.join(tmp, "e"))
    if f"dcp_global_n{world}" not in names or any(
            n.endswith(".ckpt") or n.startswith("dcp_r") for n in names):
        raise AssertionError(f"17e: checkpoint directory holds {names}")
    got = [_tagged(log, "PHASE17") for log in logs]
    for r, g in enumerate(got):
        if len(g["saved"]) != 2 or g["restored"] != g["saved"][:1]:
            raise AssertionError(f"17e process {r}: saved {g['saved']}, "
                                 f"restored {g['restored']}")
    if got[0]["saved"][0] == got[1]["saved"][0]:
        raise AssertionError("17e: the processes saved the same rows")
    launches = {}
    for r, log in enumerate(logs):
        counts = _tagged(log, "LAUNCHES")
        want = {"gossip_edge_start": 0, "gossip_edge_wait": 0,
                "gossip_edge_start_ipc": 2 * steps,
                "gossip_edge_wait_ipc": 2 * steps}
        if counts != want:
            raise AssertionError(f"17e process {r}: launches {counts}, "
                                 f"expected {want}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    print(f"ckpt 17e: run/gossip_sgd.py in {world} processes under "
          f"--ckpt_backend orbax, one epoch then resumed to two: one shared "
          f"root dcp_global_n{world}; each process restored the rows it "
          f"saved (sha256 {got[0]['saved'][0][:12]}, "
          f"{got[1]['saved'][0][:12]}: apart); one cross-process K2 and K1 a "
          f"step [{card}]", flush=True)
    return launches


def checkpoints_path(card: str):
    """Phase 17: 17e and 17b in the background, 17a, 17c and 17d in this
    process; then phase 25 on 17d's and 17a's sets.  Returns phase 17's
    and phase 25a's main runs' launches, a function that joins 25b and
    25c, checks them, removes phase 17's files and returns their
    launches, and one that names those of them still running."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ckpt17_", dir=os.path.join(ROOT, "build"))
    procs_e, procs_b, procs_25 = [], [], []
    done = False
    try:
        e_argv = _dist_argv(os.path.join(tmp, "e"), "--backend", "gloo",
                            "--ckpt_backend", "orbax")
        procs_e = _ranks(_P17_CHILD, DIST_CLI["world"], [json.dumps(
            [e_argv, e_argv + ["--num_epochs", "2", "--resume", "True"]])],
            _torchrun_env(DIST_CLI["world"]))
        runs = []
        a, procs_b = reshard_cli(card, tmp)
        runs.append(a)
        torch.cuda.empty_cache()
        corpus = os.path.join(tmp, "tokens.npy")
        np.save(corpus, np.random.default_rng(0).integers(
            0, 32000, HARNESS["corpus"]).astype(np.int32))
        runs.append(dcp_lm(card, tmp, corpus))
        torch.cuda.empty_cache()
        served, tree = serve_consensus(card, tmp, corpus)
        runs.append(served)
        torch.cuda.empty_cache()
        runs.append(reshard_dist_check(card, tmp, procs_b))
        runs.append(dcp_dist_check(card, tmp, procs_e))
        print(f"ckpt: phase 17 in {time.perf_counter() - t0:.1f} s",
              flush=True)
        sharded, join = serve_sharded_path(card, tmp, tree, procs_25)
        del tree
        done = True
    finally:
        # a failed part leaves no process behind
        for p in [*procs_e, *procs_b, *([] if done else procs_25)]:
            if p.poll() is None:
                p.kill()
                p.wait()
        if not done:
            shutil.rmtree(tmp, ignore_errors=True)

    def busy() -> str:
        """Phase 25's processes still running on the card, by name."""
        names = ["25b's serve"] * SHARDED["shards"] + ["25c's selftest"]
        return ", ".join(dict.fromkeys(
            n for n, p in zip(names, procs_25) if p.poll() is None))

    def finish(abandon: bool = False) -> dict:
        try:
            if abandon:
                for p in procs_25:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                return {}
            return join()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    return ({n: sum(r.get(n, 0) for r in runs) for r in runs for n in r},
            sharded, finish, busy)


# -- phase 25: the KV-head-sharded serve -------------------------------------

# 17d's consensus set through serve/cli.py at phase 3's page shape, its KV
# heads over 2 shards: 16 requests of 64-512 prompt and 16-64 new tokens
SHARDED = dict(shards=2, requests=16, min_prompt=64, max_prompt=512,
               min_new=16, max_new=64)


def _sharded_argv(ckpt: str, *extra: str) -> list[str]:
    c = SHARDED
    return [ckpt, "--tag", "lm_", "--n_heads", "12", "--model_shards",
            str(c["shards"]), "--page_size", "16", "--num_pages", "1024",
            "--max_seqs", "16", "--max_pages_per_seq", "48", "--requests",
            str(c["requests"]), "--min_prompt", str(c["min_prompt"]),
            "--max_prompt", str(c["max_prompt"]), "--min_new",
            str(c["min_new"]), "--max_new", str(c["max_new"]), "--device",
            "cuda", *extra]


class _ServeRecorder(_TimedEngine):
    """An engine as the scheduler sees it, with the page ids of every
    slot after each call recorded, and the host-clock totals of its
    prefill and decode calls (:class:`_TimedEngine`)."""

    def __init__(self, engine):
        super().__init__(engine)
        self.pages = engine.pages
        self.trace = []

    def start(self, prompt, budget_tokens):
        slot, tok = super().start(prompt, budget_tokens)
        self.trace.append([slot, list(self.pages.pages_of(slot))])
        return slot, tok

    def step(self, slots):
        out = super().step(slots)
        self.trace.append([[s, list(self.pages.pages_of(s))]
                           for s in sorted(slots)])
        return out


def install_serve_recorder(path: str):
    """``serve/bench.py::run_bench`` recording each run's completions,
    page ids and metrics into the JSON file ``path`` (the serve CLI
    looks it up when it runs); the wrapper keeps the last engine."""
    from stochastic_gradient_push_torch.serve import bench

    real = bench.run_bench

    def recording(engine, requests, **kw):
        rec = _ServeRecorder(engine)
        metrics, completions = real(rec, requests, **kw)
        with open(path, "w") as f:
            json.dump({"tokens": {str(c.rid): list(c.tokens)
                                  for c in completions},
                       "pages": rec.trace, "metrics": metrics,
                       "seconds": rec.seconds}, f)
        recording.engine = engine
        return metrics, completions

    bench.run_bench = recording
    return recording


# the child: one shard of 25a's command a process under a torchrun
# environment, started once 25a's serve is done; its run is recorded into
# sys.argv[5] + ".r{rank}.json"
_P25_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as c
from stochastic_gradient_push_torch.ops.flash_attention import flash_fwd
from stochastic_gradient_push_torch.serve import cli
from stochastic_gradient_push_torch.serve.paged_attention import paged_decode
c.install_serve_recorder(f"{sys.argv[5]}.r{sys.argv[2]}.json")
rc = cli.main(json.loads(sys.argv[6]))
print("LAUNCHES " + json.dumps({"flash_fwd": flash_fwd.launches,
                                "paged_decode": paged_decode.launches}),
      flush=True)
sys.exit(rc)
"""


# 25c's child: the serve CLI's selftest on the card, then the
# SyntheticEngine fallback on 17a's ResNet-50 set (sys.argv[2]), every
# kernel counter zeroed just before the fallback and read after it
_P25C_CHILD = r"""
import contextlib, io, json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as c
from stochastic_gradient_push_torch.serve import cli
rc = cli.main(["--selftest", "--device", "cuda"])
counters = c._counters()
for k in counters.values():
    k.launches = 0
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    fallback = cli.main([sys.argv[2], "--requests", "8", "--device", "cuda",
                         "--artifact", sys.argv[3]])
print("FALLBACK " + json.dumps({
    "rc": fallback, "lines": buf.getvalue().splitlines(),
    "launches": {n: k.launches for n, k in counters.items()}}), flush=True)
sys.exit(rc)
"""


def serve_sharded_path(card: str, tmp: str, tree, procs: list):
    """Phase 25 in this process: 25a, alone on the card, and its
    teacher-forced check; 25b's processes and 25c's selftest and fallback
    start once 25a's serve is done and run beside what follows (phase
    18), appended to ``procs``.  Returns 25a's launches and a function
    that joins and checks 25b and 25c and returns theirs."""
    from stochastic_gradient_push_torch.ops.flash_attention import flash_fwd
    from stochastic_gradient_push_torch.serve import bench, cli
    from stochastic_gradient_push_torch.serve.bench import synthetic_requests
    from stochastic_gradient_push_torch.serve.paged_attention import (
        paged_decode)

    t0 = time.perf_counter()
    c, shards = SHARDED, SHARDED["shards"]
    ckpt = os.path.join(tmp, "lm_serve")
    out = os.path.join(tmp, "p25")
    os.makedirs(out)
    layers = sum(1 for k in tree if k.startswith("block_"))
    real = bench.run_bench
    # 25a: both shards stacked here, traced
    tdir = os.path.join(out, "trace")
    recording = install_serve_recorder(os.path.join(out, "a.json"))
    try:
        rc = cli.main(_sharded_argv(ckpt, "--trace_dir", tdir, "--artifact",
                                    os.path.join(out, "a.json.art")))
    finally:
        bench.run_bench = real
    # 25b's processes (ingest, build, serve) and 25c start now, beside
    # what follows, in the caller's list: it stops them all
    procs += _ranks(_P25_CHILD, shards, [
        os.path.join(out, "b"), json.dumps(_sharded_argv(
            ckpt, "--artifact", os.path.join(out, "b.json")))],
        _torchrun_env(shards))
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _P25C_CHILD, ROOT, os.path.join(tmp, "a"),
         os.path.join(out, "synthetic.json")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    launches = {"flash_fwd": flash_fwd.launches,
                "paged_decode": paged_decode.launches}
    with open(os.path.join(out, "a.json")) as f:
        rec = json.load(f)
    m = rec["metrics"]
    requests = synthetic_requests(
        c["requests"], seed=0, vocab=256,
        prompt_tokens=(c["min_prompt"], c["max_prompt"]),
        new_tokens=(c["min_new"], c["max_new"]))
    want = {"flash_fwd": shards * layers * c["requests"],
            "paged_decode": shards * layers * m["decode_steps"]}
    budgets = {str(r.rid): r.max_new_tokens for r in requests}
    if (rc != 0 or m["requests"] != c["requests"]
            or {k: len(v) for k, v in rec["tokens"].items()} != budgets
            or launches != want):
        raise AssertionError(f"25a: exit {rc}, {m['requests']} requests, "
                             f"launches {launches}, expected {want}")
    events, _ = _telemetry("serve 25a", tdir, kinds=("run_meta", "serve"))
    meta = next(e for e in events if e["kind"] == "run_meta")["data"]
    engine = recording.engine
    engine.pages.assert_quiescent()
    sec = rec["seconds"]
    a_ms = sec["decode"] / m["decode_steps"] * 1e3
    print(f"serve 25a: serve/cli.py --model_shards {shards} stacked on the "
          f"card, d768 L{layers} h12: {m['requests']} requests, "
          f"{m['decode_steps']} decode steps, {m['tokens_per_sec']:.1f} "
          f"tok/s, p50 {m['p50_latency_s'] * 1e3:.1f} ms; host time prefill "
          f"{sec['prefill']:.4f} s, decode {sec['decode']:.4f} s "
          f"({a_ms:.2f} ms a step) of {m['elapsed_s']:.4f} s; launches "
          f"{json.dumps(launches)} = {shards} x {layers} x (requests, decode "
          f"steps); trace: {len(events)} events, run_meta model_shards "
          f"{meta['model_shards']} [{card}]", flush=True)
    # the teacher-forced check against the unsharded model
    engine_vs_dense(engine, requests, card, tree)
    del engine, recording.engine
    print(f"serve: phase 25 in {time.perf_counter() - t0:.1f} s in this "
          f"process (25b and 25c joined after phase 18)", flush=True)

    def finish() -> dict:
        """25b and 25c, joined: their checks, and their launches."""
        logs = _join("25b, 25c", procs)
        lines = logs[-1].strip().splitlines()
        fb = _tagged(logs[-1], "FALLBACK")
        print("serve 25 fallback: " + " | ".join(fb["lines"]) + "; kernel "
              f"launches {sum(fb['launches'].values())} [{card}]",
              flush=True)
        if (fb["rc"] != 0 or not any("synthetic engine" in x
                                     for x in fb["lines"])
                or any(fb["launches"].values())):
            raise AssertionError(f"25 fallback: {fb}")
        ok = [x for x in lines if x.startswith("serve selftest: ")]
        k6 = [x for x in ok if x.startswith("serve selftest: kernel")]
        c6 = int(k6[0].rsplit(" ", 1)[1]) if k6 else 0
        c3 = int(k6[0].split("flash_fwd ")[1].split(",")[0]) if k6 else 0
        print(f"serve 25c: {ok[-1]!r}; {k6[0] if k6 else 'no launches'} "
              f"[{card}]", flush=True)
        if ok[-1] != "serve selftest: OK" or c6 <= 0:
            raise AssertionError(f"25c: {logs[-1][-3000:]}")
        apart, steps_ms = [], []
        want_r = {k: v // shards for k, v in want.items()}
        for r, plog in enumerate(logs[:-1]):
            got = _tagged(plog, "LAUNCHES")
            with open(os.path.join(out, f"b.r{r}.json")) as f:
                prec = json.load(f)
            if got != want_r:
                raise AssertionError(f"25b process {r}: launches {got}, "
                                     f"expected {want_r}")
            apart.append(prec["tokens"] != rec["tokens"]
                         or prec["pages"] != rec["pages"])
            steps_ms.append(prec["seconds"]["decode"]
                            / prec["metrics"]["decode_steps"] * 1e3)
        print(f"serve 25b: {shards} processes (torchrun environment, gloo, "
              f"the card shared), one KV-head shard each: tokens and page "
              f"ids bit-equal to 25a's: {not any(apart)}; launches a process"
              f" {json.dumps(want_r)}; decode host time a step "
              f"{min(steps_ms):.2f}-{max(steps_ms):.2f} ms"
              f"{_shared('phase 18')} (25a {a_ms:.2f}) [{card}]", flush=True)
        if any(apart):
            raise AssertionError("25b: the processes' tokens or page ids "
                                 "differ from 25a's")
        return {"flash_fwd": want["flash_fwd"] + c3,
                "paged_decode": want["paged_decode"] + c6}

    return launches, finish


# -- phase 18: the sequence ring across processes ---------------------------

# phase 11's shape (dp 2 x sp 4, T4096, 1024-token shards, B2 a replica)
# in 8 processes sharing the card over gloo, one sequence shard each:
# 18a fp32 for 2 steps (3 until phase 20 came), 18b bf16 for 2, each
# beside the same command stacked in this process, at d768 cut to 2
# layers (12 until phase 21 came, 4 until phase 19e came); 18c one ring
# shift of a [2, 12, 1024, 64] fp32 block a shard, 10 times in every
# process at once
SEQ_DIST = dict(steps=2, bf16_steps=2, shifts=10, layers=2)

# the child: joins one gloo group on the card, waits for the file
# sys.argv[6] (the parent's stacked runs are done), runs each argv of
# sys.argv[5] through run/gossip_lm.py (seq_dist_run), then times the
# ring shift on its replica's sp group
_P18_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as c
from stochastic_gradient_push_torch.parallel import multihost
c.set_matmul_flags()
multihost.initialize_multihost("gloo", torch.device("cuda", 0))
t0 = time.perf_counter()
while not os.path.exists(sys.argv[6]):
    if time.perf_counter() - t0 > c.DIST_TIMEOUT_S:
        raise SystemExit("the parent never started phase 18's runs")
    time.sleep(0.1)
for label, argv in json.loads(sys.argv[5]):
    print(label + " " + json.dumps(c.seq_dist_run(argv)), flush=True)
print("SHIFT " + json.dumps(c.seq_dist_shift()), flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def set_matmul_flags() -> None:
    """TF32 off, bf16 GEMMs accumulating in fp32 (as ``main`` runs)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _seq_dist_argv(ckpt: str, corpus: str, steps: int, *extra) -> list:
    """Phase 11c's command (ring_flash, remat, K2/K1) on a token file, cut
    to ``SEQ_DIST["layers"]``."""
    b, t = SEQ["batch"], SEQ["seq_len"]
    return ["--sp", str(SEQ["sp"]), "--attn", "ring_flash", "--remat",
            "True", "--gossip_kernel", "pallas", "--vocab_size", "32000",
            "--d_model", "768", "--n_layers", str(SEQ_DIST["layers"]),
            "--n_heads", "12", "--d_ff", "3072", "--seq_len", str(t),
            "--batch_size", str(b), "--num_steps", str(steps),
            "--print_freq", "1", "--seed", "0",
            "--corpus_file", corpus, "--checkpoint_dir", ckpt, *extra]


def seq_dist_run(argv) -> dict:
    """``run/gossip_lm.py`` in this process with every counter zeroed
    just before and its steps watched: each step's losses and grad norms
    (one a held replica), its synchronised host time, the last push-sum
    weights, the launches, the CSV rows (``tokens_per_sec`` left out) and
    the checkpoint files this process wrote (then removed): one a
    replica stacked, one a process in a group."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from stochastic_gradient_push_torch.ops import gossip_kernel as gk
    from stochastic_gradient_push_torch.run import gossip_lm
    from stochastic_gradient_push_torch.train import lm

    counters = {**_counters(),
                "gossip_edge_start_ipc": _Counter(gk.gossip_edge_start,
                                                  "launches_ipc"),
                "gossip_edge_wait_ipc": _Counter(gk.gossip_edge_wait,
                                                 "launches_ipc")}
    got = {"loss": [], "grad_norm": [], "step_s": []}
    build = lm.build_lm_train_step

    def watched(*a, **k):
        step = build(*a, **k)

        def run(state, toks, tgts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, toks, tgts)
            torch.cuda.synchronize()
            got["step_s"].append(time.perf_counter() - t0)
            got["loss"].append(m["loss"].tolist())
            got["grad_norm"].append(m["grad_norm"].tolist())
            got["ps_weight"] = state.gossip.ps_weight.tolist()
            return state, m
        return run

    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    lm.build_lm_train_step = watched
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            gossip_lm.main(argv)
    finally:
        lm.build_lm_train_step = build
    got["wall_s"] = time.perf_counter() - t0
    got["launches"] = {n: c.launches for n, c in counters.items()}
    ckpt = argv[argv.index("--checkpoint_dir") + 1]
    world, sp = SEQ["dp"] * SEQ["sp"], SEQ["sp"]
    if dist.is_initialized():
        p = dist.get_rank()
        csv = f"lm_out_p{p}_n{world}.csv"
        files = [f"lm_checkpoint_r{p // sp}_s{p % sp}_n{world}.ckpt"]
    else:
        csv = f"lm_out_n{world}.csv"
        files = [f"lm_checkpoint_r{r}_n{world}.ckpt"
                 for r in range(SEQ["dp"])]
    with open(os.path.join(ckpt, csv)) as f:
        got["rows"] = [r.split(",")[:4] + r.split(",")[5:]
                       for r in f.read().splitlines()[1:]]
    got["files"] = {f: os.path.getsize(os.path.join(ckpt, f)) for f in files}
    for f in files:
        os.remove(os.path.join(ckpt, f))
    return got


def seq_dist_shift() -> dict:
    """Ring shifts of one ``[1, B2, H12, 1024, 64]`` fp32 block on this
    process's sp group (gloo, through the host), every process at once:
    the host clock's ms a shift, synchronised, over ``shifts`` calls
    after two warm-ups."""
    import torch
    import torch.distributed as dist

    from stochastic_gradient_push_torch.parallel.collectives import (
        DistTransport)
    from stochastic_gradient_push_torch.parallel.mesh import (
        join_dp_sp_groups, make_dp_sp_layout)
    from stochastic_gradient_push_torch.parallel.seq import DistSeq

    layout = make_dp_sp_layout(dist.get_world_size(), SEQ["sp"])
    sp_group, _ = join_dp_sp_groups(layout, dist.get_rank())
    seq = DistSeq(DistTransport(group=sp_group))
    x = torch.randn(1, SEQ["batch"], 12, SEQ["seq_len"] // SEQ["sp"], 64,
                    device="cuda")
    for _ in range(2):
        y = seq.ring_shift(x)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SEQ_DIST["shifts"]):
        y = seq.ring_shift(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / SEQ_DIST["shifts"]
    return {"ms": ms, "bytes": x.numel() * x.element_size(),
            "finite": bool(torch.isfinite(y).all())}


def _seq_dist_check(card: str, label: str, procs: list, stacked: dict,
                    exact: bool) -> None:
    """Each process's run against the stacked one: launches summed over
    the processes equal to the stacked run's on the flash kernels, one
    cross-process K2 and K1 a step in each process and no stacked one;
    finite rows, the same in every process; with ``exact``, losses and
    grad norms within 1e-5 relative of the stacked replica's and the
    push-sum weights exactly equal."""
    import numpy as np

    steps = len(stacked["loss"])
    want = stacked["launches"]
    summed = {n: sum(p["launches"][n] for p in procs) for n in want}
    flash = FLASH + FLASH_BF16
    if {n: summed[n] for n in flash} != {n: want[n] for n in flash}:
        raise AssertionError(f"seq 18{label}: flash launches over the "
                             f"processes {summed}, the stacked run's {want}")
    for p, run in enumerate(procs):
        ipc = {n: run["launches"][n] for n in (
            "gossip_edge_start", "gossip_edge_wait",
            "gossip_edge_start_ipc", "gossip_edge_wait_ipc")}
        if ipc != {"gossip_edge_start": 0, "gossip_edge_wait": 0,
                   "gossip_edge_start_ipc": steps,
                   "gossip_edge_wait_ipc": steps}:
            raise AssertionError(f"seq 18{label} process {p}: gossip "
                                 f"launches {ipc}, expected one "
                                 f"cross-process K2 and K1 a step")
        rows = [[float(v) for v in r] for r in run["rows"]]
        if len(rows) != steps or not np.isfinite(rows).all() or (
                run["rows"] != procs[0]["rows"]):
            raise AssertionError(f"seq 18{label} process {p}: CSV rows "
                                 f"{run['rows']} (process 0: "
                                 f"{procs[0]['rows']})")
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for p, run in enumerate(procs):
        replica = p // SEQ["sp"]
        for key in worst:
            a = np.asarray(run[key])[:, 0]
            b = np.asarray(stacked[key])[:, replica]
            worst[key] = max(worst[key], float(np.max(np.abs(a - b)
                                                      / np.abs(b))))
        if exact and run["ps_weight"] != stacked["ps_weight"][
                replica:replica + 1]:
            raise AssertionError(f"seq 18{label} process {p}: ps-weight "
                                 f"{run['ps_weight']}, stacked "
                                 f"{stacked['ps_weight']}")
    print(f"seq 18{label}: {len(procs)} processes vs the stacked run: "
          f"largest relative loss difference {worst['loss']:.3e}, grad norm "
          f"{worst['grad_norm']:.3e}; flash launches summed "
          f"{json.dumps({n: summed[n] for n in flash if summed[n]})}; "
          f"ps-weight {procs[0]['ps_weight']}; checkpoint files "
          f"{sum(len(p['files']) for p in procs)} of "
          f"{max(s for p in procs for s in p['files'].values()) / 1e9:.2f} GB "
          f"[{card}]", flush=True)
    if exact and max(worst.values()) > TOL_STEP_LOSS_REL:
        raise AssertionError(f"seq 18{label}: the processes' losses or "
                             f"grad norms are {worst} from the stacked "
                             f"run's, over {TOL_STEP_LOSS_REL}")


def seq_dist_path(card: str, beside) -> dict:
    """Phase 18: phase 11's dp 2 x sp 4 LM in 8 processes, one sequence
    shard each, against the same command stacked in this process (18a
    fp32, 18b bf16), then the ring shift's time (18c); ``beside`` names
    the other work still running on the card (phase 25's processes),
    which marks the times it shares.  Returns the processes'
    launches."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    dp, sp, b, t = SEQ["dp"], SEQ["sp"], SEQ["batch"], SEQ["seq_len"]
    world, steps = dp * sp, SEQ_DIST["steps"]
    tmp = tempfile.mkdtemp(prefix="seq18_", dir=os.path.join(ROOT, "build"))
    corpus = os.path.join(tmp, "tokens.npy")
    np.save(corpus, np.random.default_rng(0).integers(
        0, 32000, dp * b * t * steps + 1).astype(np.int32))
    # 18a's processes are traced, each into its own _rN files
    tdir = os.path.join(tmp, "telemetry")
    runs = [("a", steps, ["--trace_dir", tdir]),
            ("b", SEQ_DIST["bf16_steps"], ["--precision", "bf16"])]
    # the processes start (imports, the group) while the stacked runs go,
    # and wait for the go file before any work on the card
    go = os.path.join(tmp, "go")
    procs = _ranks(_P18_CHILD, world, [json.dumps([
        (f"RUN_{label}", _seq_dist_argv(os.path.join(tmp, f"dist_{label}"),
                                        corpus, n, *extra))
        for label, n, extra in runs]), go], _torchrun_env(world))
    stacked, shared = {}, {}
    try:
        for label, n, extra in runs:
            shared[label] = beside()
            ckpt = os.path.join(tmp, f"stacked_{label}")
            extra = [x for x in extra if x != tdir and x != "--trace_dir"]
            stacked[label] = seq_dist_run(_seq_dist_argv(
                ckpt, corpus, n, "--world_size", str(world), *extra))
            shutil.rmtree(ckpt)
            torch.cuda.empty_cache()
        x = torch.randn(sp, b, 12, t // sp, 64, device="cuda")
        shared["roll"] = beside()
        roll_ms = _time_ms(lambda: torch.roll(x, 1, 0), 20)
        del x
        torch.cuda.empty_cache()
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    print(f"seq 18: {world} processes (torchrun environment, gloo, the card "
          f"shared) = dp {dp} x sp {sp}, one {t // sp}-token shard each, d768 "
          f"L{SEQ_DIST['layers']} T{t} B{b}/replica ring_flash remat K2/K1, "
          f"beside the same "
          f"command stacked here [{card}]", flush=True)
    shared["processes"] = beside()
    with open(go, "w"):
        pass
    logs = _join("18", procs)
    launches = {}
    # the main path's launches: the processes' runs (the stacked runs
    # are their oracle)
    launches = {}
    for label, _, _ in runs:
        procs = [_tagged(log, f"RUN_{label}") for log in logs]
        _seq_dist_check(card, label, procs, stacked[label], label == "a")
        for p in procs:
            for k, v in p["launches"].items():
                launches[k] = launches.get(k, 0) + v
        step_ms = [float(np.median(p["step_s"][1:])) * 1e3 for p in procs]
        stacked_ms = float(np.median(stacked[label]["step_s"][1:])) * 1e3
        print(f"seq 18{label}: step ms (synchronised, median of steps 2-"
              f"{len(procs[0]['step_s'])}) {min(step_ms):.1f}-"
              f"{max(step_ms):.1f} over the processes"
              f"{_shared(shared['processes'])}, stacked {stacked_ms:.1f}"
              f"{_shared(shared[label])}; seconds in main "
              f"{min(p['wall_s'] for p in procs):.1f}-"
              f"{max(p['wall_s'] for p in procs):.1f}, stacked "
              f"{stacked[label]['wall_s']:.1f} [{card}]", flush=True)
    metas = []
    for p in range(world):
        events, _ = _telemetry(f"seq 18a process {p}", tdir, rank=p)
        meta = next(e["data"] for e in events if e["kind"] == "run_meta")
        comm = [e["data"] for e in events if e["kind"] == "comm"][-1]
        metas.append((meta["dp"], meta["sp"], comm["steps"],
                      comm["bytes"]["gossip_wire"]))
    names = sorted(os.listdir(tdir))
    print(f"seq 18a: telemetry files {names}; (dp, sp, comm steps, gossip "
          f"wire bytes) a process {sorted(set(metas))} [{card}]",
          flush=True)
    if set(metas) != {(dp, sp, steps, metas[0][3])} or len(names) != \
            2 * world:
        raise AssertionError(f"seq 18a: telemetry {names}, {metas}")
    shifts = [_tagged(log, "SHIFT") for log in logs]
    if not all(s["finite"] for s in shifts):
        raise AssertionError("seq 18c: a shifted block is not finite")
    ms = sorted(s["ms"] for s in shifts)
    print(f"seq 18c: one ring shift of a {shifts[0]['bytes'] / 1e6:.2f} MB "
          f"fp32 block a shard, {world} processes at once over gloo "
          f"(through the host): {ms[0]:.2f}-{ms[-1]:.2f} ms a shift (median "
          f"{statistics.median(ms):.2f}){_shared(shared['processes'])}; "
          f"torch.roll of the stacked [{sp}, {b}, 12, {t // sp}, 64] "
          f"{roll_ms:.4f} ms (CUDA events){_shared(shared['roll'])} "
          f"[{card}]", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"seq: phase 18 in {time.perf_counter() - t0:.1f} s"
          f"{_shared(shared['a'])}", flush=True)
    return launches

# -- phase 19: tensor parallelism -------------------------------------------

# the flagship LM at --tp 2: 19a/19b dp 2 x tp 2, bf16, flash, SGP on
# K2/K1, T1024 B8 a replica, 4 steps (19b: 3, saved, then resumed to 4);
# 19c dp 1 x sp 2 x tp 2, fp32, ring_flash, remat, T4096 B2, 2 steps;
# 19b and 19c at d768 cut to 4 layers (12 until phase 21 came), 19b beside
# its command stacked at that depth
TP = dict(tp=2, dp=2, seq_len=1024, batch=8, steps=4, c_seq_len=4096,
          c_batch=2, c_steps=2, vocab=32000, bc_layers=4)
# 19d/19e: --tp 8 on the 12 heads, a head and a half a shard (each
# kernel's columns split, as the reference's GSPMD splits them): 19d
# 19a's command at dp 2 x tp 8 stacked, full depth; 19e dp 1 x tp 8 in 8
# processes at L2 and B2, 2 steps, beside the same command stacked
TP8 = dict(tp=8, e_layers=2, e_steps=2, e_batch=2)
SHARED_19 = "19b's, 19c's and 19e's processes"
STACKED_19 = "19a-19e stacked"

# the child: joins one gloo group on the card, waits for the file
# sys.argv[6] (the parent's stacked runs are done), then runs each command
# line of sys.argv[5] through run/gossip_lm.py (lm_run)
_P19_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as c
from stochastic_gradient_push_torch.parallel import multihost
c.set_matmul_flags()
multihost.initialize_multihost("gloo", torch.device("cuda", 0))
# the run's imports and the card's GEMM handles while the parent runs its
# stacked lanes
from stochastic_gradient_push_torch.run import gossip_lm  # noqa: F401
for dt in (torch.float32, torch.bfloat16):
    x = torch.ones(64, 64, device="cuda", dtype=dt)
    (x @ x).sum().item()
t0 = time.perf_counter()
while not os.path.exists(sys.argv[6]):
    if time.perf_counter() - t0 > c.DIST_TIMEOUT_S:
        raise SystemExit("the parent never started phase 19's runs")
    time.sleep(0.1)
for label, argv in json.loads(sys.argv[5]):
    print(label + " " + json.dumps(c.lm_run(argv)), flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _tp_argv(ckpt: str, corpus: str, *extra, layers: int = 12) -> list:
    """19a's command (bf16, flash, SGP on K2/K1) on a token file."""
    return ["--tp", str(TP["tp"]), "--precision", "bf16", "--attn", "flash",
            "--gossip_kernel", "pallas", "--vocab_size", str(TP["vocab"]),
            "--d_model", "768", "--n_layers", str(layers), "--n_heads", "12",
            "--d_ff", "3072", "--seq_len", str(TP["seq_len"]),
            "--batch_size", str(TP["batch"]), "--num_steps",
            str(TP["steps"]), "--print_freq", "1", "--seed", "0",
            "--corpus_file", corpus, "--checkpoint_dir", ckpt, *extra]


def _tp3_argv(ckpt: str, corpus: str, *extra) -> list:
    """19c's command: dp 1 x sp 2 x tp 2, fp32, ring_flash, remat."""
    return ["--tp", str(TP["tp"]), "--sp", "2", "--attn", "ring_flash",
            "--remat", "True", "--vocab_size", str(TP["vocab"]),
            "--d_model", "768", "--n_layers", str(TP["bc_layers"]),
            "--n_heads", "12", "--d_ff", "3072", "--seq_len",
            str(TP["c_seq_len"]), "--batch_size", str(TP["c_batch"]),
            "--num_steps", str(TP["c_steps"]), "--print_freq", "1",
            "--seed", "0", "--corpus_file", corpus, "--checkpoint_dir", ckpt,
            *extra]


def lm_run(argv) -> dict:
    """``run/gossip_lm.py`` in this process with every counter zeroed
    just before and its steps watched: each step's losses and grad norms
    (one a held replica), its synchronised host time, the count, host
    seconds and bytes of the tp sums, the ep exchanges, the ring
    shifts, the pipeline hand-offs and the sums over the stages across
    processes, the dropped fraction (a MoE model), the
    last push-sum weights,
    the launches, the bytes of the state held here, and the CSV rows
    (``tokens_per_sec`` left out)."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from stochastic_gradient_push_torch.ops import gossip_kernel as gk
    from stochastic_gradient_push_torch.run import gossip_lm
    from stochastic_gradient_push_torch.train import lm, pp

    counters = {**_counters(),
                "gossip_edge_start_ipc": _Counter(gk.gossip_edge_start,
                                                  "launches_ipc"),
                "gossip_edge_wait_ipc": _Counter(gk.gossip_edge_wait,
                                                 "launches_ipc")}
    got = {"loss": [], "grad_norm": [], "step_s": [], "sums": [],
           "sums_s": [], "sums_bytes": [], "ex": [], "ex_s": [],
           "ex_bytes": [], "sh": [], "sh_s": [], "sh_bytes": [],
           "ho": [], "ho_s": [], "ho_bytes": [], "ps": [], "ps_s": [],
           "ps_bytes": [], "moe_dropped": []}
    builds = {lm: lm.build_lm_train_step, pp: pp.build_pp_train_step}
    # each axis's counters: (count, host seconds, bytes) attributes
    meters = {"sums": ("tp", "reductions", "reduce_s", "reduce_bytes"),
              "ex": ("ep", "exchanges", "exchange_s", "exchange_bytes"),
              "sh": ("seq", "shifts", "shift_s", "shift_bytes"),
              "ho": ("pipe", "hand_offs", "hand_off_s", "hand_off_bytes"),
              "ps": ("pipe", "sums", "sum_s", "sum_bytes")}

    def watch(build):
        return lambda *a, **k: watched(build(*a, **k), k)

    def watched(step, k):
        axes = {key: k.get(axis) for key, (axis, *_) in meters.items()
                if hasattr(k.get(axis), meters[key][1])}

        def read():
            return {key: [getattr(ax, n) for n in meters[key][1:]]
                    for key, ax in axes.items()}

        def run(state, toks, tgts):
            before = read()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, toks, tgts)
            torch.cuda.synchronize()
            got["step_s"].append(time.perf_counter() - t0)
            for key, now in read().items():
                for suffix, a, b in zip(("", "_s", "_bytes"), now,
                                        before[key]):
                    got[key + suffix].append(a - b)
            if "moe_dropped" in m:
                got["moe_dropped"].append(m["moe_dropped"].tolist())
            got["loss"].append(m["loss"].tolist())
            got["grad_norm"].append(m["grad_norm"].tolist())
            got["ps_weight"] = state.gossip.ps_weight.tolist()

            def nbytes(tree):
                return sum(t.numel() * t.element_size()
                           for t in tree.values())
            got["bytes"] = {
                "params": nbytes(state.params),
                "momentum": nbytes(state.opt_state),
                # what a round sends: the params and the push-sum weight
                # (the f32 wire), and the FIFO (none for SGP)
                "gossip": nbytes(state.params)
                + state.gossip.ps_weight.numel() * 4
                + sum(nbytes(p) for p, _ in state.gossip.in_flight)}
            got["numel"] = sum(t.numel() for t in state.params.values())
            return state, m
        return run

    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    lm.build_lm_train_step = watch(builds[lm])
    pp.build_pp_train_step = watch(builds[pp])
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            gossip_lm.main(argv)
    finally:
        lm.build_lm_train_step = builds[lm]
        pp.build_pp_train_step = builds[pp]
    got["wall_s"] = time.perf_counter() - t0
    got["launches"] = {n: c.launches for n, c in counters.items()}
    got["forced"] = "checkpoints through --ckpt_backend orbax" in (
        out.getvalue())
    ckpt = argv[argv.index("--checkpoint_dir") + 1]
    p = dist.get_rank() if dist.is_initialized() else None
    csv = [f for f in os.listdir(ckpt) if f.endswith(".csv") and (
        p is None or f.startswith(f"lm_out_p{p}_"))]
    with open(os.path.join(ckpt, csv[0])) as f:
        got["rows"] = [r.split(",")[:4] + r.split(",")[5:]
                       for r in f.read().splitlines()[1:]]
    return got


def _tp_predicted(layers: int, tp: int | None = None) -> tuple[int, int]:
    """The parameters a tp shard holds and a replica's, from the shapes:
    ``(split leaves / tp + replicated leaves, all)``."""
    import dataclasses

    from stochastic_gradient_push_torch.parallel.tp import split_dim
    from stochastic_gradient_push_torch.train.lm import logical_shapes

    tp = tp or TP["tp"]
    shapes = logical_shapes(dataclasses.replace(_lm_config(),
                                                n_layers=layers))
    whole = sum(math.prod(s) for s in shapes.values())
    held = sum(math.prod(s) // (tp if split_dim(n) is not None else 1)
               for n, s in shapes.items())
    return held, whole


def _tp_equal(x: dict, y: dict) -> tuple[bool, float]:
    """Whether two DCP steps' tensors (``_dcp_tensors``) are the same bit
    for bit, and the largest |difference| of their params."""
    import torch

    if set(x) != set(y):
        raise AssertionError(f"tp: DCP keys differ: {sorted(set(x) ^ set(y))}")
    worst = max(float((x[k].double() - y[k].double()).abs().max())
                for k in x if ".params." in k)
    return all(torch.equal(x[k], y[k]) for k in x), worst


def _tp_launch_check(label: str, run: dict, want_flash: dict,
                     k2: int, ipc: bool) -> None:
    got = {n: run["launches"][n] for n in want_flash}
    gossip = {n: run["launches"][n] for n in (
        "gossip_edge_start", "gossip_edge_wait", "gossip_edge_start_ipc",
        "gossip_edge_wait_ipc")}
    want_gossip = {"gossip_edge_start": 0 if ipc else k2,
                   "gossip_edge_wait": 0 if ipc else k2,
                   "gossip_edge_start_ipc": k2 if ipc else 0,
                   "gossip_edge_wait_ipc": k2 if ipc else 0}
    if got != want_flash or gossip != want_gossip:
        raise AssertionError(f"tp {label}: launches {got} {gossip}, "
                             f"expected {want_flash} {want_gossip}")


def _tp_sum_check(procs: list, stacked: dict, tp: int) -> None:
    """19c: the stack runs both tp shards' heads in one launch, each
    process its own, so the processes' fp32 K3-K5 launches sum to tp
    times the stack's."""
    summed = {n: sum(r["launches"][n] for r in procs) for n in FLASH}
    want = {n: tp * stacked["launches"][n] for n in FLASH}
    if summed != want or not all(summed.values()):
        raise AssertionError(f"tp 19c: fp32 flash launches over the "
                             f"processes {summed}, expected {want}")


def _tp_rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def tp_path(card: str) -> dict:
    """Phase 19: the LM at --tp 2, stacked (19a) and one tp shard a
    process at a cut depth (19b), the 3-D mesh in processes (19c), and
    --tp 8 on 12 heads stacked (19d) and in 8 processes (19e), each
    beside its oracle.  Returns the main path's launches (19a's and
    19d's tp runs, the processes' runs)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tp19_", dir=os.path.join(ROOT, "build"))
    dp, tp, b, t = TP["dp"], TP["tp"], TP["batch"], TP["seq_len"]
    world, steps = dp * tp, TP["steps"]
    corpus = os.path.join(tmp, "tokens.npy")
    np.save(corpus, np.random.default_rng(0).integers(
        0, TP["vocab"], dp * b * t * steps + 1).astype(np.int32))
    corpus3 = os.path.join(tmp, "tokens3.npy")
    np.save(corpus3, np.random.default_rng(1).integers(
        0, TP["vocab"], TP["c_batch"] * TP["c_seq_len"] * TP["c_steps"]
        + 1).astype(np.int32))
    root = f"lm_dcp_global_n{world}"
    dist_b = os.path.join(tmp, "dist_b")
    cut = TP["bc_layers"]
    # 19b: steps - 1 steps and their DCP save, then the run resumed from
    # it to step ``steps``
    jobs = [
        ("RUN_b", _tp_argv(dist_b, corpus, "--num_steps", str(steps - 1),
                           layers=cut)),
        ("RUN_r", _tp_argv(dist_b, corpus, "--resume", "True", layers=cut)),
        ("RUN_c", _tp3_argv(os.path.join(tmp, "dist_c"), corpus3))]
    # the processes start (imports, the group) and wait for the go file
    # before any work on the card: 4 for 19b and 19c, 8 for 19e
    go = os.path.join(tmp, "go")
    procs = _ranks(_P19_CHILD, world, [json.dumps(jobs), go],
                   _torchrun_env(world))
    tp8, e_layers, e_steps = TP8["tp"], TP8["e_layers"], TP8["e_steps"]
    e_argv = ("--tp", str(tp8), "--num_steps", str(e_steps),
              "--batch_size", str(TP8["e_batch"]))
    go_e = os.path.join(tmp, "go_e")
    procs_e = _ranks(_P19_CHILD, tp8, [json.dumps([("RUN_e", _tp_argv(
        os.path.join(tmp, "dist_e"), corpus, *e_argv, layers=e_layers))]),
        go_e], _torchrun_env(tp8))
    try:
        # 19b's, 19c's and 19e's processes run beside every stacked run
        for f in (go, go_e):
            with open(f, "w"):
                pass
        a = lm_run(_tp_argv(os.path.join(tmp, "stacked_a"), corpus,
                            "--world_size", str(world)))
        shutil.rmtree(os.path.join(tmp, "stacked_a"))
        torch.cuda.empty_cache()
        # 19b's oracle, the DCP backend in one process too: its step-4
        # checkpoint holds the logical leaves the processes' global one
        # does
        sb = lm_run(_tp_argv(os.path.join(tmp, "stacked_b"), corpus,
                             "--world_size", str(world), "--ckpt_backend",
                             "orbax", layers=cut))
        torch.cuda.empty_cache()
        one = lm_run(_tp_argv(os.path.join(tmp, "tp1"), corpus,
                              "--world_size", str(dp), "--tp", "1"))
        shutil.rmtree(os.path.join(tmp, "tp1"))
        torch.cuda.empty_cache()
        c = lm_run(_tp3_argv(os.path.join(tmp, "stacked_c"), corpus3,
                             "--world_size", str(world)))
        torch.cuda.empty_cache()
        # 19d: 19a's command at --tp 8 (dp 2, world 16 stacked)
        d = lm_run(_tp_argv(os.path.join(tmp, "stacked_d"), corpus,
                            "--world_size", str(dp * tp8), "--tp",
                            str(tp8)))
        shutil.rmtree(os.path.join(tmp, "stacked_d"))
        torch.cuda.empty_cache()
        # 19e's oracle: its command stacked (dp 1 x tp 8, world 8)
        se = lm_run(_tp_argv(os.path.join(tmp, "stacked_e"), corpus,
                             *e_argv, "--world_size", str(tp8),
                             layers=e_layers))
        torch.cuda.empty_cache()
        logs = _join("19", procs)
        logs_e = _join("19e", procs_e)
    except BaseException:
        for p in procs + procs_e:
            if p.poll() is None:
                p.kill()
                p.wait()
        raise
    runs = {lab: [_tagged(log, f"RUN_{lab}") for log in logs]
            for lab in "brc"}
    runs["e"] = [_tagged(log, "RUN_e") for log in logs_e]

    # 19a: the stacked run against tp 1, and its launches
    layers = 12
    flash_a = {f"{n}_bf16": dp * layers * steps for n in FLASH}
    _tp_launch_check("19a", a, flash_a, steps, ipc=False)
    rel = _tp_rel(a["loss"], one["loss"])
    print(f"tp 19a: world {world} = dp {dp} x tp {tp} stacked, d768 L12 "
          f"T{t} B{b}/replica bf16 flash SGP K2/K1, {steps} steps: losses "
          f"{[round(x[0], 4) for x in a['loss']]}, largest relative "
          f"difference from --tp 1 {rel:.3e}; step ms (synchronised, median "
          f"of steps 2-{steps}) {np.median(a['step_s'][1:]) * 1e3:.1f}, tp "
          f"1 {np.median(one['step_s'][1:]) * 1e3:.1f}{_shared(SHARED_19)}; "
          f"tp sums a step "
          f"{a['sums'][-1]} in {np.median(a['sums_s']) * 1e3:.2f} host ms"
          f"{_shared(SHARED_19)}; "
          f"bf16 K3/K4/K5 {a['launches']['flash_fwd_bf16']} each [{card}]",
          flush=True)
    if not np.isfinite(a["loss"]).all() or rel > TOL_HARNESS_LOSS_REL:
        raise AssertionError(f"tp 19a: losses {a['loss']} vs tp 1 "
                             f"{one['loss']}: {rel} over "
                             f"{TOL_HARNESS_LOSS_REL}")

    # 19d: --tp 8 on 12 heads stacked against 19a's tp 1 run; every
    # replica's heads joined into one bf16 flash call a layer
    _tp_launch_check("19d", d, flash_a, steps, ipc=False)
    rel_d = _tp_rel(d["loss"], one["loss"])
    grad_d = _tp_rel(d["grad_norm"], one["grad_norm"])
    print(f"tp 19d: world {dp * tp8} = dp {dp} x tp {tp8} stacked (12 heads "
          f"of 64 over {tp8} shards of {768 // tp8} columns), 19a's command, "
          f"{steps} steps: losses {[round(x[0], 4) for x in d['loss']]}, "
          f"largest relative difference from --tp 1 {rel_d:.3e} (losses), "
          f"{grad_d:.3e} (grad norms); step ms (synchronised, median of "
          f"steps 2-{steps}) {np.median(d['step_s'][1:]) * 1e3:.1f}"
          f", tp 2 {np.median(a['step_s'][1:]) * 1e3:.1f}, tp 1 "
          f"{np.median(one['step_s'][1:]) * 1e3:.1f}{_shared(SHARED_19)}; "
          f"tp sums a step "
          f"{d['sums'][-1]} in {np.median(d['sums_s']) * 1e3:.2f} host ms"
          f"{_shared(SHARED_19)}; "
          f"bf16 K3/K4/K5 {d['launches']['flash_fwd_bf16']} each "
          f"({dp * layers} a step); {d['wall_s']:.1f} s in main"
          f"{_shared(SHARED_19)} [{card}]",
          flush=True)
    if not np.isfinite(d["loss"]).all() or max(rel_d, grad_d) > (
            TOL_HARNESS_LOSS_REL):
        raise AssertionError(f"tp 19d: losses {d['loss']} / grad norms "
                             f"{d['grad_norm']} vs tp 1 {one['loss']} / "
                             f"{one['grad_norm']}: {rel_d}, {grad_d} over "
                             f"{TOL_HARNESS_LOSS_REL}")

    # 19b: every process bit-equal to its stacked replica and shard, the
    # resumed step included
    held, whole = _tp_predicted(cut)
    for p, (run, resumed) in enumerate(zip(runs["b"], runs["r"])):
        replica = p // tp
        for key in ("loss", "grad_norm"):
            mine = [x[0] for x in run[key] + resumed[key]]
            want = [x[replica] for x in sb[key]]
            if mine != want:
                raise AssertionError(f"tp 19b process {p}: {key} {mine}, "
                                     f"the stacked replica's {want}")
        if resumed["ps_weight"] != sb["ps_weight"][replica:replica + 1]:
            raise AssertionError(f"tp 19b process {p}: ps-weight "
                                 f"{resumed['ps_weight']}, {sb['ps_weight']}")
        if run["numel"] != held or run["bytes"]["params"] != 4 * held:
            raise AssertionError(f"tp 19b process {p}: {run['numel']} "
                                 f"parameters held, predicted {held}")
        if not run["forced"] and p == 0:
            raise AssertionError("tp 19b: the DCP backend was not forced")
        _tp_launch_check(f"19b process {p}", run, {
            f"{n}_bf16": cut * (steps - 1) for n in FLASH}, steps - 1,
            ipc=True)
        _tp_launch_check(f"19b resume process {p}", resumed, {
            f"{n}_bf16": cut for n in FLASH}, 1, ipc=True)
    exact, diff = _tp_equal(
        _dcp_tensors(os.path.join(tmp, "stacked_b", f"lm_dcp_r0_n{world}",
                                  str(steps))),
        _dcp_tensors(os.path.join(dist_b, root, str(steps))))
    if not exact:
        raise AssertionError(f"tp 19b: resumed from step {steps - 1}, the "
                             f"processes' step-{steps} checkpoint is not the "
                             f"stacked run's (params {diff:.3e} apart)")
    b_ms = float(np.median(sb["step_s"][1:])) * 1e3
    bts = runs["b"][0]["bytes"]
    step_ms = [float(np.median(r["step_s"][1:])) * 1e3 for r in runs["b"]]
    sums_ms = [float(np.median(r["sums_s"][1:])) * 1e3 for r in runs["b"]]
    print(f"tp 19b: {world} processes (torchrun environment, gloo, the card "
          f"shared) = dp {dp} x tp {tp}, one tp shard each, 19a's command at "
          f"L{cut}, {steps - 1} steps and then resumed from their DCP save "
          f"to step {steps}: losses, grad norms, ps-weight and the "
          f"step-{steps} checkpoint (params, momentum) bit-equal to the same "
          f"command's straight run stacked; "
          f"held a process {held / 1e6:.1f} M of {whole / 1e6:.1f} M "
          f"parameters ({held / whole:.1%}): params "
          f"{bts['params'] / 1e6:.1f} MB, momentum "
          f"{bts['momentum'] / 1e6:.1f} MB, gossip {bts['gossip'] / 1e6:.1f} "
          f"MB a round; step ms {min(step_ms):.1f}-{max(step_ms):.1f} over "
          f"the processes{_shared(STACKED_19 + ', 19c and 19e')} (stacked "
          f"{b_ms:.1f}{_shared(SHARED_19)}); tp sums a step "
          f"{runs['b'][0]['sums'][-1]}, host ms a step "
          f"{min(sums_ms):.1f}-{max(sums_ms):.1f}; seconds in main: the run "
          f"{max(r['wall_s'] for r in runs['b']):.1f}, the resume "
          f"{max(r['wall_s'] for r in runs['r']):.1f}, stacked "
          f"{sb['wall_s']:.1f}, 19a {a['wall_s']:.1f}, tp 1 "
          f"{one['wall_s']:.1f}{_shared('each other')} [{card}]", flush=True)

    # 19c: the 3-D mesh against its stacked run
    loss_rel = grad_rel = 0.0
    bit = True
    for p, run in enumerate(runs["c"]):
        loss_rel = max(loss_rel, _tp_rel([x[0] for x in run["loss"]],
                                         [x[0] for x in c["loss"]]))
        grad_rel = max(grad_rel, _tp_rel([x[0] for x in run["grad_norm"]],
                                         [x[0] for x in c["grad_norm"]]))
        bit &= run["loss"] == c["loss"] and run["grad_norm"] == (
            c["grad_norm"])
        if run["ps_weight"] != c["ps_weight"]:
            raise AssertionError(f"tp 19c process {p}: ps-weight "
                                 f"{run['ps_weight']}, {c['ps_weight']}")
    _tp_sum_check(runs["c"], c, tp)
    c_ms = [float(np.median(r["step_s"])) * 1e3 for r in runs["c"]]
    print(f"tp 19c: {world} processes = dp 1 x sp 2 x tp 2, ring_flash remat "
          f"fp32 d768 L{cut} T{TP['c_seq_len']} B{TP['c_batch']}, "
          f"{TP['c_steps']} steps "
          f"beside the same command stacked: {'bit-equal' if bit else 'not bit-equal'}; "
          f"largest relative loss difference {loss_rel:.3e}, grad norm "
          f"{grad_rel:.3e}; step ms {min(c_ms):.1f}-{max(c_ms):.1f}"
          f"{_shared(STACKED_19 + ', 19b and 19e')}, stacked "
          f"{np.median(c['step_s']) * 1e3:.1f}{_shared(SHARED_19)}; tp sums "
          f"a step "
          f"{runs['c'][0]['sums'][-1]} (stacked {c['sums'][-1]}) [{card}]",
          flush=True)
    if loss_rel > TOL_STEP_LOSS_REL or grad_rel > TOL_STEP_GNORM_REL:
        raise AssertionError(f"tp 19c: losses {loss_rel} or grad norms "
                             f"{grad_rel} from the stacked run's")

    # 19e: dp 1 x tp 8 in 8 processes, each holding its 96 columns of
    # q/k/v and its rows of o and gathering the two heads they touch,
    # beside the same command stacked (a shared head's gradient folds two
    # processes' partial sums: bf16's tolerance, not bit equality)
    held8, whole = _tp_predicted(e_layers, tp8)
    loss_e = grad_e = 0.0
    for p, run in enumerate(runs["e"]):
        if run["numel"] != held8 or run["bytes"]["params"] != 4 * held8:
            raise AssertionError(f"tp 19e process {p}: {run['numel']} "
                                 f"parameters held, predicted {held8}")
        _tp_launch_check(f"19e process {p}", run, {
            f"{n}_bf16": e_layers * e_steps for n in FLASH}, 0, ipc=True)
        loss_e = max(loss_e, _tp_rel(run["loss"], se["loss"]))
        grad_e = max(grad_e, _tp_rel(run["grad_norm"], se["grad_norm"]))
    e_ms = [float(np.median(r["step_s"])) * 1e3 for r in runs["e"]]
    print(f"tp 19e: {tp8} processes (torchrun environment, gloo, the card "
          f"shared) = dp 1 x tp {tp8}, 19a's command at L{e_layers}, "
          f"{e_steps} steps, beside it stacked: largest relative difference "
          f"{loss_e:.3e} (losses), {grad_e:.3e} (grad norms); held a "
          f"process: params "
          f"{[r['bytes']['params'] for r in runs['e']]} B, momentum "
          f"{[r['bytes']['momentum'] for r in runs['e']]} B "
          f"({held8 / 1e6:.2f} M of {whole / 1e6:.2f} M parameters); bf16 "
          f"K3/K4/K5 a process "
          f"{[[r['launches'][f'{n}_bf16'] for n in FLASH] for r in runs['e']]}"
          f"; step ms {min(e_ms):.1f}-{max(e_ms):.1f}; tp sums a step "
          f"{runs['e'][0]['sums'][-1]} in "
          f"{np.median(runs['e'][0]['sums_s']) * 1e3:.1f} host ms; seconds "
          f"in main {max(r['wall_s'] for r in runs['e']):.1f}"
          f"{_shared(STACKED_19 + ', 19b and 19c')}; the oracle's "
          f"step ms {np.median(se['step_s']) * 1e3:.1f}{_shared(SHARED_19)} "
          f"[{card}]",
          flush=True)
    if max(loss_e, grad_e) > TOL_HARNESS_LOSS_REL:
        raise AssertionError(f"tp 19e: losses {loss_e} or grad norms "
                             f"{grad_e} from the stacked run's, over "
                             f"{TOL_HARNESS_LOSS_REL}")
    launches = {}
    for run in [a, d] + runs["b"] + runs["r"] + runs["c"] + runs["e"]:
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"tp: phase 19 in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# -- phase 20: switch MoE and expert parallelism ---------------------------

# the flagship LM with 8 experts on every second block (the reference's
# examples/bench_lm_tpu.py:202 run: d768 L12 h12 T1024 B8, bf16, flash,
# capacity factor 1.25) at --ep 2: 20a dp 2 x ep 2 stacked, SGP on K2/K1,
# cut to 4 layers (12 until phase 23 came), 3 steps; 20b the /n_ep oracle
# at dp 1 x ep 2, fp32, capacity factor 8; 20c 20a's command at 4 layers
# (12 until phase 21 came) in 4 processes, 2 steps, a DCP save, the third
# step resumed from it, beside that command stacked
EP = dict(ep=2, dp=2, experts=8, every=2, seq_len=1024, batch=8, steps=3,
          vocab=32000, a_layers=4, c_layers=4)
# 20c's (21b's) processes run beside the phase's stacked runs
SHARED_20 = "20c's processes"
SHARED_22 = "22c's processes"
SHARED_21 = "21b's processes"
# the reference test's tolerance for the oracle
# (tests/test_expert_parallel_lm.py::test_ep_train_step_matches_full_
# expert_model)
TOL_EP_RTOL, TOL_EP_ATOL = 5e-4, 1e-5

_P20_CHILD = _P19_CHILD.replace("phase 19's", "phase 20's")


def _ep_argv(ckpt: str, corpus: str, *extra, layers: int = 12) -> list:
    """20a's command (bf16, flash, SGP on K2/K1) on a token file."""
    return ["--moe_experts", str(EP["experts"]), "--moe_every",
            str(EP["every"]), "--ep", str(EP["ep"]), "--precision", "bf16",
            "--attn", "flash", "--gossip_kernel", "pallas", "--vocab_size",
            str(EP["vocab"]), "--d_model", "768", "--n_layers", str(layers),
            "--n_heads", "12", "--d_ff", "3072", "--seq_len",
            str(EP["seq_len"]), "--batch_size", str(EP["batch"]),
            "--num_steps", str(EP["steps"]), "--print_freq", "1", "--seed",
            "0", "--corpus_file", corpus, "--checkpoint_dir", ckpt, *extra]


def _ep_params(cfg, device, seed: int) -> dict:
    """A replica's logical parameters drawn on ``device`` from ``seed``
    (fan-in-scaled normals, unit LayerNorm scales, zero biases; the
    expert stacks' fan-in counts the expert dim, as flax's does)."""
    import torch

    from stochastic_gradient_push_torch.train.lm import logical_shapes

    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for n, shape in logical_shapes(cfg).items():
        if n.endswith("bias"):
            out[n] = torch.zeros(shape, device=device)
        elif ".ln" in n:
            out[n] = torch.ones(shape, device=device)
        else:
            if n.startswith("embed") or n.endswith("router"):
                std = 0.02
            elif n.endswith(("experts_up", "experts_down")):
                std = (shape[0] * shape[1]) ** -0.5
            else:
                std = shape[-1] ** -0.5
            out[n] = torch.randn(shape, generator=g, device=device) * std
    return out


def ep_oracle(cfg, device, batch: int, seq_len: int, seed: int = 0):
    """20b: one momentum-free AllReduce step at dp 1 x ep 2 (no MoE loss)
    against ``p - lr · grad`` of the ep 1 model on both shards' tokens
    (their mean cross-entropy).  Returns ``(worst, moved, dropped)``: the
    largest ``|got - want| / (atol + rtol·|want|)`` over every parameter
    (<= 1 passes), the names of the leaves the step changed, and the
    step's dropped fraction."""
    import dataclasses

    import torch
    from torch.func import functional_call

    from stochastic_gradient_push_torch import algorithms
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.parallel.ep import StackedEp
    from stochastic_gradient_push_torch.train import lm
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import TrainState, sgd

    ep = cfg.ep
    alg = algorithms.all_reduce(StackedTransport(1))
    tx = sgd(momentum=0.0, weight_decay=0.0)
    step = lm.build_lm_train_step(
        lm.make_model(cfg), alg, tx, LRSchedule(0.1, batch, ep,
                                                decay_schedule={},
                                                warmup=False),
        itr_per_epoch=100, ep=StackedEp(ep), moe_loss_coef=0.0)
    one = _ep_params(cfg, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    toks, tgts = (torch.randint(0, cfg.vocab_size, (1, ep, batch, seq_len),
                                generator=g, device=device)
                  for _ in range(2))
    ref = lm.make_model(dataclasses.replace(cfg, ep=1))
    p0 = {n: p.clone().requires_grad_(True) for n, p in one.items()}
    loss = sum(lm.lm_loss(functional_call(ref, p0, (toks[0, j],)),
                          tgts[0, j]) for j in range(ep)) / ep
    grads = torch.autograd.grad(loss, list(p0.values()))
    del loss, p0
    params = {n: p[None] for n, p in one.items()}
    state = TrainState(step=0, params=params, opt_state=tx.init(params),
                       gossip=alg.init(params))
    new, m = step(state, toks, tgts)
    lr = float(m["lr"])
    worst, moved = 0.0, []
    for (n, p), gr in zip(one.items(), grads):
        want = p - lr * gr
        got = new.params[n][0]
        worst = max(worst, float(((got - want).abs() / (
            TOL_EP_ATOL + TOL_EP_RTOL * want.abs())).max()))
        if bool((got != p).any()):
            moved.append(n)
    return worst, moved, float(m["moe_dropped"][0])


def _ep_layer_ms(cfg, tp: int = 1) -> tuple[float, float]:
    """Device ms, forward and backward, of one MoE block's FFN (the
    stacked exchange over both ep shards, fp32 as the model runs it; at
    ``tp`` > 1 each expert split on its F dim over ``tp`` stacked
    shards, their outputs folded) and of one layer's bf16 flash
    attention, alone at 20a's shapes a replica (CUDA events, 10 runs
    after 3): ``(moe_ms, attention_ms)``."""
    import torch

    from stochastic_gradient_push_torch.models.moe import switch_moe_ffn
    from stochastic_gradient_push_torch.ops.flash_attention import (
        flash_attention)
    from stochastic_gradient_push_torch.parallel.ep import StackedEp
    from stochastic_gradient_push_torch.parallel.tp import (
        StackedTp, shard_params)

    ep, b, t, d = EP["ep"], EP["batch"], EP["seq_len"], cfg.d_model
    p = _ep_params(cfg, "cuda", 5)
    names = [f"block_1.moe.{k}" for k in ("router", "experts_up",
                                          "experts_down")]
    if tp > 1:
        p = {n: q[0] for n, q in shard_params(
            {n: p[n][None] for n in names}, tp).items()}
    w = [p[n].requires_grad_(True) for n in names]
    x = torch.randn(ep, b * t, d, device="cuda", requires_grad=True)
    ax, tx = StackedEp(ep), StackedTp(tp) if tp > 1 else None

    def moe():
        y, aux = switch_moe_ffn(x, *w, ep=ax, tp=tx)
        (y.square().mean() + aux["load_balance_loss"].sum()).backward()

    q, k, v = (torch.randn(ep * b, cfg.n_heads, t, cfg.head_dim,
                           device="cuda", dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))

    def attn():
        flash_attention(q, k, v, causal=True).float().square().mean(
        ).backward()

    return _time_ms(moe, 10), _time_ms(attn, 10)


def ep_path(card: str) -> tuple[dict, dict]:
    """Phase 20: the MoE LM at --ep 2 stacked (20a), the /n_ep oracle on
    the card (20b), and one ep shard a process at a cut depth through a
    DCP resume (20c) beside its command stacked.  Returns the main path's launches (20a's run, 20c's
    processes) and 20a's run with its peak GB and MoE FFN ms alone
    (phase 21's baseline)."""
    import dataclasses

    import numpy as np
    import torch

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ep20_", dir=os.path.join(ROOT, "build"))
    dp, ep, b, t = EP["dp"], EP["ep"], EP["batch"], EP["seq_len"]
    world, steps = dp * ep, EP["steps"]
    corpus = os.path.join(tmp, "tokens.npy")
    np.save(corpus, np.random.default_rng(0).integers(
        0, EP["vocab"], world * b * t * steps + 1).astype(np.int32))
    dist_c = os.path.join(tmp, "dist_c")
    cut = EP["c_layers"]
    # 20c: steps - 1 steps and their DCP save, then the run resumed from
    # it to step ``steps``
    jobs = [("RUN_c", _ep_argv(dist_c, corpus, "--num_steps",
                               str(steps - 1), layers=cut)),
            ("RUN_r", _ep_argv(dist_c, corpus, "--resume", "True",
                               layers=cut))]
    cfg = _lm_config("flash", moe_experts=EP["experts"],
                     moe_every=EP["every"], ep=ep)
    # timed alone on the card, before the processes start
    moe_ms, attn_ms = _ep_layer_ms(cfg)
    torch.cuda.empty_cache()
    go = os.path.join(tmp, "go")
    procs = _ranks(_P20_CHILD, world, [json.dumps(jobs), go],
                   _torchrun_env(world))
    try:
        # 20c's processes run beside the stacked runs
        with open(go, "w"):
            pass
        torch.cuda.reset_peak_memory_stats()
        a = lm_run(_ep_argv(os.path.join(tmp, "stacked_a"), corpus,
                            "--world_size", str(world),
                            layers=EP["a_layers"]))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        shutil.rmtree(os.path.join(tmp, "stacked_a"))
        torch.cuda.empty_cache()
        # 20c's oracle, the DCP backend in one process too
        sc = lm_run(_ep_argv(os.path.join(tmp, "stacked_c"), corpus,
                             "--world_size", str(world), "--ckpt_backend",
                             "orbax", layers=cut))
        torch.cuda.empty_cache()
        t_b = time.perf_counter()
        worst, moved, dropped = ep_oracle(
            dataclasses.replace(cfg, moe_capacity_factor=8.0), "cuda", b, t)
        b_s = time.perf_counter() - t_b
        torch.cuda.empty_cache()
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    logs = _join("20", procs)
    runs = {lab: [_tagged(log, f"RUN_{lab}") for log in logs]
            for lab in "cr"}

    # 20a: launches, the dropped fraction in the CSV, the times
    layers = EP["a_layers"]
    moe_blocks = layers // EP["every"]
    # each replica's forward holds both ep shards' rows: one launch a layer
    _tp_launch_check("20a", a, {f"{n}_bf16": dp * layers * steps
                                for n in FLASH}, steps, ipc=False)
    csv_dropped = [float(r[-1]) for r in a["rows"]]
    if len(csv_dropped) != steps or not all(0 <= x <= 1
                                            for x in csv_dropped):
        raise AssertionError(f"ep 20a: moe_dropped in the CSV "
                             f"{csv_dropped}")
    if not np.isfinite(a["loss"]).all():
        raise AssertionError(f"ep 20a: losses {a['loss']}")
    step_ms = float(np.median(a["step_s"][1:])) * 1e3
    print(f"ep 20a: world {world} = dp {dp} x ep {ep} stacked, d768 L{layers} "
          f"T{t} B{b}/ep shard bf16 flash SGP K2/K1, {EP['experts']} "
          f"experts on {moe_blocks} blocks (capacity factor 1.25), {steps} "
          f"steps: losses {[round(x[0], 4) for x in a['loss']]}, "
          f"moe_dropped (CSV) {csv_dropped}; step ms (synchronised, median "
          f"of steps 2-{steps}) {step_ms:.1f}{_shared(SHARED_20)}; peak "
          f"{peak_gb:.2f} GB; "
          f"{a['numel'] / dp / 1e6:.1f} M parameters a replica; a step's "
          f"device ms alone a replica (CUDA events, forward + backward): "
          f"{moe_blocks} MoE FFNs {moe_blocks * moe_ms:.2f} ({moe_ms:.3f} "
          f"each), {layers} flash attentions {layers * attn_ms:.2f} "
          f"({attn_ms:.3f} each); bf16 K3/K4/K5 "
          f"{a['launches']['flash_fwd_bf16']} each, K2/K1 "
          f"{a['launches']['gossip_edge_start']} [{card}]", flush=True)

    # 20b: the oracle
    # the leaves the /n_ep scaling is about must have moved (an fp32
    # update below half an ulp leaves a LayerNorm scale as it was)
    from stochastic_gradient_push_torch.train.lm import logical_shapes

    leaves = list(logical_shapes(cfg))
    moe = [n for n in leaves if ".moe." in n]
    print(f"ep 20b: dp 1 x ep 2, fp32, capacity factor 8, no MoE loss, "
          f"momentum-free AllReduce: every parameter within rtol "
          f"{TOL_EP_RTOL} / atol {TOL_EP_ATOL} of p - lr * grad of the ep 1 "
          f"model on both shards' tokens: worst {worst:.3e} of the bound; "
          f"{len(moved)} of {len(leaves)} leaves moved, all "
          f"{len(moe)} MoE leaves among them: "
          f"{set(moe) <= set(moved)}; dropped {dropped}; {b_s:.1f} s"
          f"{_shared(SHARED_20)} [{card}]", flush=True)
    if worst > 1 or not set(moe) <= set(moved) or dropped != 0:
        raise AssertionError(f"ep 20b: worst {worst} of the bound, MoE "
                             f"leaves unmoved {sorted(set(moe) - set(moved))}"
                             f", dropped {dropped}")

    # 20c: each process against its stacked replica, through the resume
    loss_rel = grad_rel = 0.0
    for p, (run, resumed) in enumerate(zip(runs["c"], runs["r"])):
        replica = p // ep
        mine = {k: [x[0] for x in run[k] + resumed[k]]
                for k in ("loss", "grad_norm")}
        loss_rel = max(loss_rel, _tp_rel(mine["loss"],
                                         [x[replica] for x in sc["loss"]]))
        grad_rel = max(grad_rel, _tp_rel(mine["grad_norm"], [
            x[replica] for x in sc["grad_norm"]]))
        if resumed["ps_weight"] != sc["ps_weight"][replica:replica + 1]:
            raise AssertionError(f"ep 20c process {p}: ps-weight "
                                 f"{resumed['ps_weight']}, {sc['ps_weight']}")
        if not run["forced"] and p == 0:
            raise AssertionError("ep 20c: the DCP backend was not forced")
        _tp_launch_check(f"20c process {p}", run, {
            f"{n}_bf16": cut * (steps - 1) for n in FLASH}, steps - 1,
            ipc=True)
        _tp_launch_check(f"20c resume process {p}", resumed, {
            f"{n}_bf16": cut for n in FLASH}, 1, ipc=True)
    root = f"lm_dcp_global_n{world}"
    _, diff = _tp_equal(
        _dcp_tensors(os.path.join(tmp, "stacked_c", f"lm_dcp_r0_n{world}",
                                  str(steps))),
        _dcp_tensors(os.path.join(dist_c, root, str(steps))))
    c0 = runs["c"][0]
    ex_ms = [float(np.median(r["ex_s"])) * 1e3 for r in runs["c"]]
    c_ms = [float(np.median(r["step_s"])) * 1e3 for r in runs["c"]]
    print(f"ep 20c: {world} processes (torchrun environment, gloo, the card "
          f"shared) = dp {dp} x ep {ep}, one ep shard each, 20a's command at "
          f"L{cut}, {steps - 1} steps, a DCP save, then step {steps} resumed "
          f"from it: against the same command's stacked replica losses "
          f"{loss_rel:.3e} and grad "
          f"norms {grad_rel:.3e} apart (largest relative), the step-{steps} "
          f"params {diff:.3e} apart (largest absolute), ps-weight equal (a "
          f"process takes its own shard's gradient and sums the replicated "
          f"leaves' over the ep group, where the stack takes one gradient "
          f"of both shards' mean: bf16 products in another order); held a "
          f"process {c0['numel'] / 1e6:.1f} M parameters; exchanges a step "
          f"{c0['ex'][-1]} of {c0['ex_bytes'][-1] / c0['ex'][-1] / 1e6:.1f} "
          f"MB each through the host, {min(ex_ms):.1f}-{max(ex_ms):.1f} host "
          f"ms a step ({min(ex_ms) / c0['ex'][-1]:.1f}-"
          f"{max(ex_ms) / c0['ex'][-1]:.1f} an exchange); step ms "
          f"{min(c_ms):.1f}-{max(c_ms):.1f} over the processes"
          f"{_shared('20a-20c stacked')} (stacked "
          f"{float(np.median(sc['step_s'][1:])) * 1e3:.1f}"
          f"{_shared(SHARED_20)}); seconds in main: the run "
          f"{max(r['wall_s'] for r in runs['c']):.1f}, the resume "
          f"{max(r['wall_s'] for r in runs['r']):.1f}, stacked "
          f"{sc['wall_s']:.1f}, 20a {a['wall_s']:.1f}{_shared('each other')} "
          f"[{card}]", flush=True)
    if loss_rel > TOL_HARNESS_LOSS_REL or not np.isfinite(diff):
        raise AssertionError(f"ep 20c: losses {loss_rel} from the stacked "
                             f"run's (over {TOL_HARNESS_LOSS_REL})")
    launches = {}
    for run in [a] + runs["c"] + runs["r"]:
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"ep: phase 20 in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, dict(a, peak_gb=peak_gb, moe_ms=moe_ms)

# -- phase 21: MoE under tensor parallelism, the expert meshes across ------
# -- processes ---------------------------------------------------------------

# 21a: 20a's command at --tp 2 (dp 2 x ep 2 x tp 2, world 8 stacked: the
# experts split on their F dim), 3 steps on 20a's tokens, beside 20a (the
# reference's test_moe_ep_with_tp_matches_ep_only on the card); 21b: dp 1 x
# ep 2 x sp 2 x tp 2 in 8 torchrun processes (the reference's
# test_moe_ep_sp_tp_4d_trains layout), bf16, ring_flash, full width cut to
# 2 layers (1 MoE block; 4 until phases 19d and 19e came), T1024 B8
# an ep shard, 2 steps, a DCP save, the third step resumed from it, beside
# the same command stacked
EPTP = dict(tp=2, sp=2, b_layers=2, b_steps=3)

_P21_CHILD = _P19_CHILD.replace("phase 19's", "phase 21's")


def _eptp_argv(ckpt: str, corpus: str, *extra) -> list:
    """21b's command: the 4-D mesh at d768, cut to ``b_layers``."""
    return ["--moe_experts", str(EP["experts"]), "--moe_every",
            str(EP["every"]), "--ep", str(EP["ep"]), "--sp",
            str(EPTP["sp"]), "--tp", str(EPTP["tp"]), "--precision",
            "bf16", "--attn", "ring_flash", "--vocab_size", str(EP["vocab"]),
            "--d_model", "768", "--n_layers", str(EPTP["b_layers"]),
            "--n_heads", "12", "--d_ff", "3072", "--seq_len",
            str(EP["seq_len"]), "--batch_size", str(EP["batch"]),
            "--num_steps", str(EPTP["b_steps"]), "--print_freq", "1",
            "--seed", "0", "--corpus_file", corpus, "--checkpoint_dir", ckpt,
            *extra]


def _per_step(run: dict, key: str) -> str:
    """A run's ``key`` meter a step: count, host ms and MB."""
    return ", ".join(
        f"{n} in {ms * 1e3:.1f} ms, {mb / 1e6:.1f} MB"
        for n, ms, mb in zip(run[key], run[key + "_s"], run[key + "_bytes"]))


def tp_ep_path(card: str, ep20: dict) -> dict:
    """Phase 21: 20a's MoE LM at --tp 2 stacked beside 20a (21a), and
    the (gossip, ep, seq, tp) mesh one shard a process through a DCP
    resume beside the same command stacked (21b).  Returns the main
    path's launches (21a's run, 21b's processes)."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.parallel.mesh import (
        make_dp_sp_layout)

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="eptp21_",
                           dir=os.path.join(ROOT, "build"))
    dp, ep, tp, sp = EP["dp"], EP["ep"], EPTP["tp"], EPTP["sp"]
    b, t, steps = EP["batch"], EP["seq_len"], EP["steps"]
    world = dp * ep * tp
    # 20a's tokens (the same draw), and 21b's: dp 1 x ep 2 rows a step
    corpus = os.path.join(tmp, "tokens.npy")
    np.save(corpus, np.random.default_rng(0).integers(
        0, EP["vocab"], dp * ep * b * t * steps + 1).astype(np.int32))
    corpus_b = os.path.join(tmp, "tokens_b.npy")
    b_steps, b_world = EPTP["b_steps"], ep * sp * tp
    np.save(corpus_b, np.random.default_rng(2).integers(
        0, EP["vocab"], ep * b * t * b_steps + 1).astype(np.int32))
    dist_b = os.path.join(tmp, "dist_b")
    jobs = [("RUN_b", _eptp_argv(dist_b, corpus_b, "--num_steps",
                                 str(b_steps - 1))),
            ("RUN_r", _eptp_argv(dist_b, corpus_b, "--resume", "True"))]
    cfg = _lm_config("flash", moe_experts=EP["experts"],
                     moe_every=EP["every"], ep=ep)
    # timed alone on the card, before the processes start
    moe_ms, _ = _ep_layer_ms(cfg, tp)
    torch.cuda.empty_cache()
    go = os.path.join(tmp, "go")
    procs = _ranks(_P21_CHILD, b_world, [json.dumps(jobs), go],
                   _torchrun_env(b_world))
    try:
        # 21b's processes run beside the stacked runs
        with open(go, "w"):
            pass
        torch.cuda.reset_peak_memory_stats()
        a = lm_run(_ep_argv(os.path.join(tmp, "stacked_a"), corpus,
                            "--tp", str(tp), "--world_size", str(world),
                            layers=EP["a_layers"]))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        shutil.rmtree(os.path.join(tmp, "stacked_a"))
        torch.cuda.empty_cache()
        s = lm_run(_eptp_argv(os.path.join(tmp, "stacked_b"), corpus_b,
                              "--world_size", str(b_world),
                              "--ckpt_backend", "orbax"))
        torch.cuda.empty_cache()
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    logs = _join("21", procs)
    runs = {lab: [_tagged(log, f"RUN_{lab}") for log in logs]
            for lab in "br"}

    # 21a: launches (a replica's ep and tp shards fold into one flash
    # launch a layer), the dropped fraction, the distance from 20a
    layers = EP["a_layers"]
    moe_blocks = layers // EP["every"]
    _tp_launch_check("21a", a, {f"{n}_bf16": dp * layers * steps
                                for n in FLASH}, steps, ipc=False)
    csv_dropped = [float(r[-1]) for r in a["rows"]]
    if len(csv_dropped) != steps or not all(0 <= x <= 1
                                            for x in csv_dropped):
        raise AssertionError(f"eptp 21a: moe_dropped in the CSV "
                             f"{csv_dropped}")
    rel = _tp_rel(a["loss"], ep20["loss"])
    drop_diff = float(np.max(np.abs(np.asarray(a["moe_dropped"])
                                    - np.asarray(ep20["moe_dropped"]))))
    step_ms = float(np.median(a["step_s"][1:])) * 1e3
    step20 = float(np.median(ep20["step_s"][1:])) * 1e3
    print(f"eptp 21a: world {world} = dp {dp} x ep {ep} x tp {tp} stacked, "
          f"20a's command (d768 L{layers} T{t} B{b}/ep shard bf16 flash SGP "
          f"K2/K1, "
          f"{EP['experts']} experts on {moe_blocks} blocks), {steps} steps "
          f"on 20a's tokens: losses {[round(x[0], 4) for x in a['loss']]}, "
          f"largest relative difference from 20a (--tp 1) {rel:.3e}, "
          f"moe_dropped (CSV) {csv_dropped}, largest difference from 20a's "
          f"{drop_diff:.3e}; step ms (synchronised, median of steps "
          f"2-{steps}) {step_ms:.1f}{_shared(SHARED_21)} (20a {step20:.1f}"
          f"{_shared(SHARED_20)}); peak {peak_gb:.2f} "
          f"GB (20a {ep20['peak_gb']:.2f}); a MoE FFN alone, forward + "
          f"backward (CUDA events, both ep shards) {moe_ms:.3f} ms at tp "
          f"{tp} (20a {ep20['moe_ms']:.3f}); tp sums a step "
          f"{a['sums'][-1]} in {np.median(a['sums_s']) * 1e3:.2f} host ms"
          f"{_shared(SHARED_21)}; bf16 K3/K4/K5 "
          f"{a['launches']['flash_fwd_bf16']} each, K2/K1 "
          f"{a['launches']['gossip_edge_start']} [{card}]", flush=True)
    if not np.isfinite(a["loss"]).all() or rel > TOL_HARNESS_LOSS_REL:
        raise AssertionError(f"eptp 21a: losses {a['loss']} vs 20a "
                             f"{ep20['loss']}: {rel} over "
                             f"{TOL_HARNESS_LOSS_REL}")

    # 21b: each process against the stacked run, through the resume
    layout = make_dp_sp_layout(b_world, sp, tp, ep)
    b_layers = EPTP["b_layers"]
    loss_rel = grad_rel = 0.0
    for p, (run, resumed) in enumerate(zip(runs["b"], runs["r"])):
        _, e, shard, _ = layout.grid(p)
        mine = {k: [x[0] for x in run[k] + resumed[k]]
                for k in ("loss", "grad_norm")}
        loss_rel = max(loss_rel, _tp_rel(mine["loss"],
                                         [x[0] for x in s["loss"]]))
        grad_rel = max(grad_rel, _tp_rel(mine["grad_norm"],
                                         [x[0] for x in s["grad_norm"]]))
        if resumed["ps_weight"] != s["ps_weight"]:
            raise AssertionError(f"eptp 21b process {p}: ps-weight "
                                 f"{resumed['ps_weight']}, {s['ps_weight']}")
        if not run["forced"] and p == 0:
            raise AssertionError("eptp 21b: the DCP backend was not forced")
        # a causal ring of 2: shard 0 runs its diagonal tick, shard 1 its
        # diagonal and the full one
        ticks = b_layers * (shard + 1)
        for lab, r, n in (("", run, b_steps - 1), (" resume", resumed, 1)):
            _tp_launch_check(f"21b{lab} process {p}", r, {
                f"{k}_bf16": ticks * n for k in FLASH}, 0, ipc=False)
    summed = {k: sum(r["launches"][f"{k}_bf16"]
                     for r in runs["b"] + runs["r"]) for k in FLASH}
    want = {k: ep * tp * s["launches"][f"{k}_bf16"] for k in FLASH}
    if summed != want:
        raise AssertionError(f"eptp 21b: bf16 flash launches over the "
                             f"processes {summed}, expected ep x tp x the "
                             f"stack's {want}")
    root = f"lm_dcp_global_n{b_world}"
    _, diff = _tp_equal(
        _dcp_tensors(os.path.join(tmp, "stacked_b",
                                  f"lm_dcp_r0_n{b_world}", str(b_steps))),
        _dcp_tensors(os.path.join(dist_b, root, str(b_steps))))
    b0 = runs["b"][0]
    b_ms = [float(np.median(r["step_s"])) * 1e3 for r in runs["b"]]
    print(f"eptp 21b: {b_world} processes (torchrun environment, gloo, the "
          f"card shared) = dp 1 x ep {ep} x sp {sp} x tp {tp}, one (e, "
          f"shard, t) each, bf16 ring_flash d768 L{b_layers} ({b_layers // 2} "
          f"MoE blocks) T{t} B{b}/ep shard, {b_steps - 1} steps, a DCP save, "
          f"then step {b_steps} resumed from it: against the same command "
          f"stacked losses {loss_rel:.3e} and grad norms {grad_rel:.3e} apart "
          f"(largest relative), the step-{b_steps} params {diff:.3e} apart "
          f"(largest absolute), ps-weight equal (a process takes its own "
          f"(e, shard)'s gradient, means it over the sp group and sums it "
          f"over the ep group, where the stack takes one gradient of every "
          f"shard's mean: bf16 products and fp32 sums in another order); "
          f"held a process {b0['numel'] / 1e6:.1f} M parameters; process 0 "
          f"a step: ep exchanges {_per_step(b0, 'ex')}; tp sums "
          f"{_per_step(b0, 'sums')}; ring shifts {_per_step(b0, 'sh')}"
          f"{_shared('21a and 21b stacked')}; step ms "
          f"{min(b_ms):.1f}-{max(b_ms):.1f} over the processes"
          f"{_shared('21a and 21b stacked')} (stacked "
          f"{np.median(s['step_s']) * 1e3:.1f}{_shared(SHARED_21)}); seconds "
          f"in main: the run {max(r['wall_s'] for r in runs['b']):.1f}, the "
          f"resume {max(r['wall_s'] for r in runs['r']):.1f}, 21a "
          f"{a['wall_s']:.1f}, 21b stacked {s['wall_s']:.1f}"
          f"{_shared('each other')} [{card}]", flush=True)
    if (loss_rel > TOL_HARNESS_LOSS_REL or grad_rel > TOL_HARNESS_LOSS_REL
            or not np.isfinite(diff)):
        raise AssertionError(f"eptp 21b: losses {loss_rel} or grad norms "
                             f"{grad_rel} from the stacked run's (over "
                             f"{TOL_HARNESS_LOSS_REL})")
    launches = {}
    for run in [a] + runs["b"] + runs["r"]:
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"eptp: phase 21 in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# -- phase 22: pipeline parallelism ----------------------------------------

# 22a: the flagship LM at --pp 2 --n_micro 4 (dp 2 x pp 2 stacked, bf16,
# flash, SGP on K2/K1, T1024 B8 a replica, 3 steps) beside the same command
# at --pp 1 (world 2) on the same tokens; 22b: the (gossip, pipe, ep, seq)
# mesh stacked (dp 1 x pp 2 x ep 2 x sp 2, 8 experts on every block, bf16
# ring_flash), d768 cut to 2 layers (4 until phase 19e came), 2 steps;
# 22c: dp 2 x pp 2 in 4 torchrun processes, one stage each, d768 cut to 4
# layers, bf16, 2 steps, a DCP save, the third step resumed from it,
# beside the same command stacked; phase 23: 22b's command in 8 torchrun
# processes, one (stage, ep shard, sequence shard) each, 2 steps, a DCP
# save, the third step resumed from it, held against 22b (3 steps, its DCP
# save at the end)
PP = dict(pp=2, dp=2, n_micro=4, seq_len=1024, batch=8, steps=3,
          vocab=32000, b_layers=2, b_steps=3, c_layers=4, c_steps=3)

_P22_CHILD = _P19_CHILD.replace("phase 19's", "phase 22's")
_P23_CHILD = _P19_CHILD.replace("phase 19's", "phase 23's")


def _pp_argv(ckpt: str, corpus: str, *extra, layers: int = 12) -> list:
    """22a's command (bf16, flash, SGP on K2/K1) on a token file, at
    ``--n_micro 4`` (``--pp`` among ``extra``)."""
    return ["--n_micro", str(PP["n_micro"]), "--precision", "bf16",
            "--attn", "flash", "--gossip_kernel", "pallas", "--vocab_size",
            str(PP["vocab"]), "--d_model", "768", "--n_layers", str(layers),
            "--n_heads", "12", "--d_ff", "3072", "--seq_len",
            str(PP["seq_len"]), "--batch_size", str(PP["batch"]),
            "--num_steps", str(PP["steps"]), "--print_freq", "1", "--seed",
            "0", "--corpus_file", corpus, "--checkpoint_dir", ckpt, *extra]


def _pp4_argv(ckpt: str, corpus: str, *extra) -> list:
    """22b's command: the 4-D pipeline mesh, d768 cut to ``b_layers``
    (phase 23's too, across processes)."""
    return ["--pp", str(PP["pp"]), "--ep", str(EP["ep"]), "--sp", "2",
            "--moe_experts", str(EP["experts"]), "--moe_every", "1",
            "--n_micro", str(PP["n_micro"]), "--precision", "bf16",
            "--attn", "ring_flash", "--world_size",
            str(PP["pp"] * EP["ep"] * 2), "--vocab_size", str(PP["vocab"]),
            "--d_model", "768", "--n_layers", str(PP["b_layers"]),
            "--n_heads", "12", "--d_ff", "3072", "--seq_len",
            str(PP["seq_len"]), "--batch_size", str(PP["batch"]),
            "--num_steps", str(PP["b_steps"]), "--print_freq", "1",
            "--seed", "0", "--corpus_file", corpus, "--checkpoint_dir",
            ckpt, *extra]


def _pp_logical(tensors: dict, pp: int) -> dict:
    """A stacked run's DCP tensors with each stage leaf's ``[R, pp, L/pp,
    ...]`` joined into the logical ``[R, L, ...]`` the processes write."""
    return {k: (t.flatten(1, 2) if ".stack." in k and t.dim() > 2
                and t.shape[1] == pp else t) for k, t in tensors.items()}


def pp_path(card: str) -> dict:
    """Phase 22: the LM at --pp 2 stacked beside --pp 1 (22a), the
    (gossip, pipe, ep, seq) mesh stacked (22b), and one stage a process
    through a DCP resume beside the same command stacked (22c).  Returns
    the main path's launches (22a's pp run, 22b's run, 22c's
    processes)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pp22_", dir=os.path.join(ROOT, "build"))
    dp, pp, m = PP["dp"], PP["pp"], PP["n_micro"]
    b, t, steps = PP["batch"], PP["seq_len"], PP["steps"]
    world = dp * pp
    corpus = os.path.join(tmp, "tokens.npy")
    np.save(corpus, np.random.default_rng(0).integers(
        0, PP["vocab"], dp * b * t * steps + 1).astype(np.int32))
    corpus_b = os.path.join(tmp, "tokens_b.npy")
    np.save(corpus_b, np.random.default_rng(3).integers(
        0, PP["vocab"], EP["ep"] * b * t * PP["b_steps"] + 1).astype(
            np.int32))
    c_layers, c_steps = PP["c_layers"], PP["c_steps"]
    dist_c = os.path.join(tmp, "dist_c")
    jobs = [("RUN_c", _pp_argv(dist_c, corpus, "--pp", str(pp),
                               "--num_steps", str(c_steps - 1),
                               layers=c_layers)),
            ("RUN_r", _pp_argv(dist_c, corpus, "--pp", str(pp), "--resume",
                               "True", "--num_steps", str(c_steps),
                               layers=c_layers))]
    go = os.path.join(tmp, "go")
    b_world = pp * EP["ep"] * 2
    dist_d, go_d = os.path.join(tmp, "dist_d"), os.path.join(tmp, "go_d")
    jobs_d = [("RUN_d", _pp4_argv(dist_d, corpus_b, "--num_steps",
                                  str(PP["b_steps"] - 1))),
              ("RUN_e", _pp4_argv(dist_d, corpus_b, "--resume", "True"))]
    procs = _ranks(_P22_CHILD, world, [json.dumps(jobs), go],
                   _torchrun_env(world))
    procs_d = []
    try:
        # 22c's processes run beside the stacked runs
        with open(go, "w"):
            pass
        peaks = {}
        runs_a = {}
        for lab, extra in (("pp2", ["--pp", str(pp), "--world_size",
                                    str(world)]),
                           ("pp1", ["--world_size", str(dp)])):
            torch.cuda.reset_peak_memory_stats()
            runs_a[lab] = lm_run(_pp_argv(os.path.join(tmp, lab), corpus,
                                          *extra))
            peaks[lab] = torch.cuda.max_memory_allocated() / 1e9
            shutil.rmtree(os.path.join(tmp, lab))
            torch.cuda.empty_cache()
        # phase 23's processes import while 22b and 22c run
        procs_d = _ranks(_P23_CHILD, b_world, [json.dumps(jobs_d), go_d],
                         _torchrun_env(b_world))
        four = lm_run(_pp4_argv(os.path.join(tmp, "four"), corpus_b,
                                "--ckpt_backend", "orbax"))
        torch.cuda.empty_cache()
        sc = lm_run(_pp_argv(os.path.join(tmp, "stacked_c"), corpus,
                             "--pp", str(pp), "--world_size", str(world),
                             "--ckpt_backend", "orbax", "--num_steps",
                             str(c_steps), layers=c_layers))
        torch.cuda.empty_cache()
        logs = _join("22", procs)
    except BaseException:
        for p in procs + procs_d:
            p.kill()
            p.wait()
        raise
    runs = {lab: [_tagged(log, f"RUN_{lab}") for log in logs]
            for lab in "cr"}

    # 22a: GPipe's launches (a replica's microbatches, each through every
    # layer), the distance from pp 1, the step and the memory
    a, a1 = runs_a["pp2"], runs_a["pp1"]
    layers = 12
    _tp_launch_check("22a", a, {f"{n}_bf16": dp * m * layers * steps
                                for n in FLASH}, steps, ipc=False)
    _tp_launch_check("22a pp 1", a1, {f"{n}_bf16": dp * layers * steps
                                      for n in FLASH}, steps, ipc=False)
    rel = _tp_rel(a["loss"], a1["loss"])
    ms = {k: float(np.median(r["step_s"][1:])) * 1e3
          for k, r in runs_a.items()}
    print(f"pp 22a: world {world} = dp {dp} x pp {pp} stacked, --n_micro "
          f"{m} (bubble {(pp - 1) / (m + pp - 1):.3f}), d768 L12 T{t} "
          f"B{b}/replica bf16 flash SGP K2/K1, {steps} steps: losses "
          f"{[round(x[0], 4) for x in a['loss']]}, largest relative "
          f"difference from the same command at --pp 1 (world {dp}, same "
          f"tokens) {rel:.3e}; grad norms (the mean of the stages' norms) "
          f"{[round(x[0], 4) for x in a['grad_norm']]} against pp 1's "
          f"{[round(x[0], 4) for x in a1['grad_norm']]}; step ms "
          f"(synchronised, median of steps 2-{steps}) {ms['pp2']:.1f} (pp "
          f"1 {ms['pp1']:.1f}){_shared(SHARED_22)}; peak "
          f"{peaks['pp2']:.2f} GB (pp 1 "
          f"{peaks['pp1']:.2f}); bf16 K3/K4/K5 {a['launches']['flash_fwd_bf16']}"
          f" each (pp 1 {a1['launches']['flash_fwd_bf16']}), K2/K1 "
          f"{a['launches']['gossip_edge_start']} [{card}]", flush=True)
    if not np.isfinite(a["loss"]).all() or rel > TOL_HARNESS_LOSS_REL:
        raise AssertionError(f"pp 22a: losses {a['loss']} vs pp 1 "
                             f"{a1['loss']}: {rel} over "
                             f"{TOL_HARNESS_LOSS_REL}")

    # 22b: the 4-D mesh; a causal ring of 2 runs 3 ticks a call (shard 0
    # its diagonal, shard 1 its diagonal and the full one), one call a
    # layer a microbatch (both ep shards' rows folded)
    b_steps, b_layers = PP["b_steps"], PP["b_layers"]
    _tp_launch_check("22b", four, {f"{n}_bf16": 3 * b_layers * m * b_steps
                                   for n in FLASH}, 0, ipc=False)
    dropped = [float(r[-1]) for r in four["rows"]]
    print(f"pp 22b: world 8 = dp 1 x pp {pp} x ep {EP['ep']} x sp 2 "
          f"stacked, {EP['experts']} experts on every block, bf16 "
          f"ring_flash, d768 L{b_layers} T{t} B{b}/ep shard, --n_micro {m}, "
          f"{b_steps} steps: losses {[round(x[0], 4) for x in four['loss']]}"
          f", moe_dropped (CSV) {dropped}; step ms "
          f"{[round(x * 1e3, 1) for x in four['step_s']]}; bf16 K3/K4/K5 "
          f"{four['launches']['flash_fwd_bf16']} each; seconds in main "
          f"{four['wall_s']:.1f}{_shared(SHARED_22)} [{card}]", flush=True)
    if (len(dropped) != b_steps or not all(0 <= x <= 1 for x in dropped)
            or not np.isfinite(four["loss"]).all()):
        raise AssertionError(f"pp 22b: moe_dropped {dropped}, losses "
                             f"{four['loss']}")

    # 22c: each process against its stacked replica, through the resume
    loss_rel = grad_rel = 0.0
    same = True
    for p, (run, resumed) in enumerate(zip(runs["c"], runs["r"])):
        replica = p // pp
        mine = {k: [x[0] for x in run[k] + resumed[k]]
                for k in ("loss", "grad_norm")}
        want = {k: [x[replica] for x in sc[k]] for k in ("loss",
                                                           "grad_norm")}
        same = same and mine == want
        loss_rel = max(loss_rel, _tp_rel(mine["loss"], want["loss"]))
        grad_rel = max(grad_rel, _tp_rel(mine["grad_norm"],
                                         want["grad_norm"]))
        if resumed["ps_weight"] != sc["ps_weight"][replica:replica + 1]:
            raise AssertionError(f"pp 22c process {p}: ps-weight "
                                 f"{resumed['ps_weight']}, {sc['ps_weight']}")
        if not run["forced"] and p == 0:
            raise AssertionError("pp 22c: the DCP backend was not forced")
        # a stage's layers, each microbatch
        per = (c_layers // pp) * m
        _tp_launch_check(f"22c process {p}", run, {
            f"{n}_bf16": per * (c_steps - 1) for n in FLASH}, c_steps - 1,
            ipc=True)
        _tp_launch_check(f"22c resume process {p}", resumed, {
            f"{n}_bf16": per for n in FLASH}, 1, ipc=True)
    summed = {n: sum(r["launches"][f"{n}_bf16"]
                     for r in runs["c"] + runs["r"]) for n in FLASH}
    if summed != {n: sc["launches"][f"{n}_bf16"] for n in FLASH}:
        raise AssertionError(f"pp 22c: bf16 flash launches over the "
                             f"processes {summed}, the stack's "
                             f"{sc['launches']}")
    root = f"lm_dcp_global_n{world}"
    bits, diff = _tp_equal(
        _pp_logical(_dcp_tensors(os.path.join(
            tmp, "stacked_c", f"lm_dcp_r0_n{world}", str(c_steps))), pp),
        _dcp_tensors(os.path.join(dist_c, root, str(c_steps))))
    c0 = runs["c"][0]
    c_ms = [float(np.median(r["step_s"])) * 1e3 for r in runs["c"]]
    print(f"pp 22c: {world} processes (torchrun environment, gloo, the "
          f"card shared) = dp {dp} x pp {pp}, one stage each, 22a's command "
          f"at L{c_layers}, {c_steps - 1} steps, a DCP save, then step "
          f"{c_steps} resumed from it: against the same command's stacked "
          f"replica losses {loss_rel:.3e} and grad norms {grad_rel:.3e} "
          f"apart (largest relative; equal to the digit: {same}), the "
          f"step-{c_steps} DCP tensors bit-equal: {bits} (params "
          f"{diff:.3e} apart, largest absolute), ps-weight equal; held a "
          f"process {c0['numel'] / 1e6:.1f} M parameters; process 0 a "
          f"step: hand-offs {_per_step(c0, 'ho')}; pipe-group sums "
          f"{_per_step(c0, 'ps')}{_shared('22a-22c stacked')}; step ms "
          f"{min(c_ms):.1f}-{max(c_ms):.1f} over the processes"
          f"{_shared('22a-22c stacked')} (stacked "
          f"{float(np.median(sc['step_s'][1:])) * 1e3:.1f}"
          f"{_shared(SHARED_22)}); seconds in main: the run "
          f"{max(r['wall_s'] for r in runs['c']):.1f}, the resume "
          f"{max(r['wall_s'] for r in runs['r']):.1f}, stacked "
          f"{sc['wall_s']:.1f}{_shared('each other')} [{card}]", flush=True)
    if (loss_rel > TOL_HARNESS_LOSS_REL or grad_rel > TOL_HARNESS_LOSS_REL
            or not np.isfinite(diff)):
        raise AssertionError(f"pp 22c: losses {loss_rel} or grad norms "
                             f"{grad_rel} from the stacked run's (over "
                             f"{TOL_HARNESS_LOSS_REL})")
    print(f"pp: phase 22 in {time.perf_counter() - t0:.1f} s", flush=True)
    druns = pp_mesh_path(card, tmp, procs_d, go_d, four)
    launches = {}
    for run in [a, four] + runs["c"] + runs["r"] + druns:
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


def pp_mesh_path(card: str, tmp: str, procs: list, go: str,
                 four: dict) -> list:
    """Phase 23: 22b's command across 8 processes, one ``(stage, ep
    shard, sequence shard)`` each, through a DCP resume, held against
    22b's stacked run (``four``, its DCP save under ``tmp``).  Starts
    the waiting ``procs`` through ``go``; returns their runs."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.parallel.mesh import (
        make_dp_sp_layout)

    t0 = time.perf_counter()
    pp, ep, sp, m = PP["pp"], EP["ep"], 2, PP["n_micro"]
    world, steps, layers = pp * ep * sp, PP["b_steps"], PP["b_layers"]
    with open(go, "w"):
        pass
    logs = _join("23", procs)
    runs = {lab: [_tagged(log, f"RUN_{lab}") for log in logs]
            for lab in "de"}
    layout = make_dp_sp_layout(world, sp, 1, ep, pp)
    loss_rel = grad_rel = drop_diff = 0.0
    for p, (run, resumed) in enumerate(zip(runs["d"], runs["e"])):
        _, e, shard, _ = layout.grid(p)
        mine = {k: [x[0] for x in run[k] + resumed[k]]
                for k in ("loss", "grad_norm", "moe_dropped")}
        want = {k: [x[0] for x in four[k]] for k in mine}
        loss_rel = max(loss_rel, _tp_rel(mine["loss"], want["loss"]))
        grad_rel = max(grad_rel, _tp_rel(mine["grad_norm"],
                                         want["grad_norm"]))
        drop_diff = max(drop_diff, float(np.max(np.abs(
            np.subtract(mine["moe_dropped"], want["moe_dropped"])))))
        if resumed["ps_weight"] != four["ps_weight"]:
            raise AssertionError(f"pp 23 process {p}: ps-weight "
                                 f"{resumed['ps_weight']}, "
                                 f"{four['ps_weight']}")
        if not run["forced"] and p == 0:
            raise AssertionError("pp 23: the DCP backend was not forced")
        # a causal ring of 2: shard 0 runs its diagonal tick, shard 1 its
        # diagonal and the full one, one call a layer of the stage a
        # microbatch (the process's ep shard's rows alone)
        ticks = (shard + 1) * (layers // pp) * m
        for lab, r, n in (("", run, steps - 1), (" resume", resumed, 1)):
            _tp_launch_check(f"23{lab} process {p}", r, {
                f"{k}_bf16": ticks * n for k in FLASH}, 0, ipc=False)
    summed = {k: sum(r["launches"][f"{k}_bf16"]
                     for r in runs["d"] + runs["e"]) for k in FLASH}
    want = {k: ep * four["launches"][f"{k}_bf16"] for k in FLASH}
    if summed != want:
        raise AssertionError(f"pp 23: bf16 flash launches over the "
                             f"processes {summed}, expected ep x the "
                             f"stack's {want}")
    got = _dcp_tensors(os.path.join(tmp, "dist_d", f"lm_dcp_global_n{world}",
                                    str(steps)))
    finite = all(bool(torch.isfinite(x).all()) for x in got.values()
                 if x.is_floating_point())
    _, diff = _tp_equal(_pp_logical(_dcp_tensors(os.path.join(
        tmp, "four", f"lm_dcp_r0_n{world}", str(steps))), pp), got)
    d0 = runs["d"][0]
    d_ms = [float(np.median(r["step_s"])) * 1e3 for r in runs["d"]]
    print(f"pp 23: {world} processes (torchrun environment, gloo, the card "
          f"shared) = dp 1 x pp {pp} x ep {ep} x sp {sp}, one (stage, ep "
          f"shard, sequence shard) each, 22b's command (d768 L{layers}, "
          f"{EP['experts']} experts on every block, bf16 ring_flash, T"
          f"{PP['seq_len']} B{PP['batch']}/ep shard, --n_micro {m}), "
          f"{steps - 1} steps, a DCP save, then step {steps} resumed from "
          f"it: against 22b's stacked run losses {loss_rel:.3e} and grad "
          f"norms {grad_rel:.3e} apart (largest relative), moe_dropped "
          f"process 0 {[x[0] for x in d0['moe_dropped']]} against the "
          f"stack's {[x[0] for x in four['moe_dropped'][:steps - 1]]} "
          f"(largest difference over the processes and steps "
          f"{drop_diff:.3e}), ps-weight equal, the step-{steps} DCP tensors "
          f"finite: {finite}, params {diff:.3e} from the stack's (largest "
          f"absolute); held a process {d0['numel'] / 1e6:.1f} M "
          f"parameters; bf16 K3/K4/K5 a step: shard 0 "
          f"{(layers // pp) * m}, shard 1 {2 * (layers // pp) * m} a "
          f"process; process 0 a step: hand-offs {_per_step(d0, 'ho')}; "
          f"ring shifts {_per_step(d0, 'sh')}; ep exchanges "
          f"{_per_step(d0, 'ex')}; pipe-group sums {_per_step(d0, 'ps')}; "
          f"step ms {min(d_ms):.1f}-{max(d_ms):.1f} over the processes "
          f"(22b stacked {float(np.median(four['step_s'][1:])) * 1e3:.1f}); "
          f"seconds in main: the run "
          f"{max(r['wall_s'] for r in runs['d']):.1f}, the resume "
          f"{max(r['wall_s'] for r in runs['e']):.1f} [{card}]", flush=True)
    if (loss_rel > TOL_HARNESS_LOSS_REL or grad_rel > TOL_HARNESS_LOSS_REL
            or not finite or not np.isfinite(diff)):
        raise AssertionError(f"pp 23: losses {loss_rel} or grad norms "
                             f"{grad_rel} from 22b's (over "
                             f"{TOL_HARNESS_LOSS_REL}), or the DCP tensors "
                             f"not finite ({finite}, {diff})")
    print(f"pp: phase 23 in {time.perf_counter() - t0:.1f} s (its processes "
          f"started during phase 22)", flush=True)
    return runs["d"] + runs["e"]


def install_synthetic_memo() -> None:
    """Draw each synthetic image set once: ``data/synthetic.py``'s
    ``synthetic_classification`` is a pure function of its arguments
    whose class-mean draw (``num_classes`` x 224 x 224 x 3 normals in
    float64) took ~4 s of every ResNet-50 CLI run's ``main``; the CLI
    runs get a copy of the first draw of the same arguments, the same
    bits."""
    from stochastic_gradient_push_torch.data import synthetic

    draw, cache = synthetic.synthetic_classification, {}

    def memo(*a, **k):
        key = (a, tuple(sorted(k.items())))
        if key not in cache:
            cache[key] = draw(*a, **k)
        return tuple(x.copy() for x in cache[key])

    synthetic.synthetic_classification = memo


class _phase_clock:
    """Inside a ``with``: prints the phase's seconds at its end (phases
    9-23 print their own)."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"phase {self.label} in "
                  f"{time.perf_counter() - self.t0:.1f} s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stochastic_gradient_push_torch.ops import _build

    # bf16 GEMMs accumulate in fp32 throughout, as XLA's do (phase 12)
    set_matmul_flags()
    install_synthetic_memo()
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    nvcc = _run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, nvcc {nvcc!r}, "
          f"{torch.cuda.device_count()} device(s), {smi}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    report_ptxas(built)

    with _phase_clock("2"):
        flash_row = check_flash(card)
        paged_row = check_paged(card)
        bwd_rows = check_flash_bwd(card)
    with _phase_clock("4, the gossip kernels,"):
        gossip_rows = check_gossip(card)
    with _phase_clock("3"):
        engine, requests, launches, tree = main_path(card)
    with _phase_clock("4, the teacher-forced check,"):
        engine_vs_dense(engine, requests, card, tree)
    del engine, tree
    torch.cuda.empty_cache()
    with _phase_clock("5"):
        train_launches, train_timed = train_path(card)
    torch.cuda.empty_cache()
    with _phase_clock("6"):
        sgp_launches = gossip_train_path(card, "sgp", "int8", False, 1, 1,
                                         1, 1)
        torch.cuda.empty_cache()
        osgp_launches = gossip_train_path(card, "osgp", "bf16", True, 2, 2,
                                          3, 2)
    torch.cuda.empty_cache()
    with _phase_clock("7"):
        resnet_sgp = resnet_train_path(card, "sgp", "f32", False, 1, 1, 1,
                                       1)
        torch.cuda.empty_cache()
        resnet_osgp = resnet_train_path(card, "osgp", "bf16", True, 2, 2,
                                        3, 2)
        torch.cuda.empty_cache()
        resnet_norms = resnet_norm_variants(card)
    torch.cuda.empty_cache()
    with _phase_clock("8"):
        cli_launches, flat_bt = cli_path(card)
    torch.cuda.empty_cache()
    resil_launches = resilience_path(card)
    torch.cuda.empty_cache()
    with _phase_clock("24, the wire selftest,"):
        wire_launches = wire_selftest_path(card)
    topo_launches = topology_path(card)
    torch.cuda.empty_cache()
    seq_launches, seq_timed = seq_path(card)
    torch.cuda.empty_cache()
    bf16_launches, bf16_rows = bf16_path(card, train_timed, seq_timed)
    torch.cuda.empty_cache()
    from stochastic_gradient_push_torch.train.lm import make_model
    dist_launches, dist_rows = dist_path(card, sum(
        p.numel() for p in make_model(_lm_config()).parameters()))
    torch.cuda.empty_cache()
    image_launches = image_path(card)
    torch.cuda.empty_cache()
    harness_launches = harness_path(card)
    torch.cuda.empty_cache()
    hier_launches = hierarchical_path(card, flat_bt)
    torch.cuda.empty_cache()
    ckpt_launches, sharded_a, finish_25, busy_25 = checkpoints_path(card)
    torch.cuda.empty_cache()
    try:
        seq_dist_launches = seq_dist_path(card, busy_25)
    except BaseException:
        finish_25(abandon=True)
        raise
    # 25b's serve, 25c's selftest and the fallback ran beside phase 18
    sharded_bc = finish_25()
    sharded_launches = {n: sharded_a[n] + sharded_bc[n] for n in sharded_a}
    torch.cuda.empty_cache()
    tp_launches = tp_path(card)
    torch.cuda.empty_cache()
    ep_launches, ep20 = ep_path(card)
    torch.cuda.empty_cache()
    tp_ep_launches = tp_ep_path(card, ep20)
    torch.cuda.empty_cache()
    pp_launches = pp_path(card)
    print(f"chip_smoke: every phase in {time.perf_counter() - t0:.1f} s "
          f"from the build on", flush=True)

    # launches: each main path's run (serving, training at world 1, SGP
    # and OSGP at world 4, ResNet SGP and OSGP at world 4, the CLI's SGP,
    # D-PSGD and OSGP runs, phase 9's kernel-lane steps and CLI run,
    # phase 10's kernel-lane steps and CLI runs, phase 11's timed steps
    # and CLI run, phase 12's timed steps and CLI run, phase 13b's CLI
    # processes, phase 14a's three CLI runs, phase 15's in-process CLI
    # runs, phase 16a's kernel-lane CLI run and 16b's processes, phase
    # 17's CLI runs, 17b's and 17e's processes and 17d's serving, phase
    # 18's processes, phase 19a's stacked tp run and 19b's and 19c's
    # processes, phase 20a's stacked MoE run and 20c's processes, phase
    # 21a's stacked ep x tp run and 21b's processes, phase 22a's stacked
    # pp run, 22b's 4-D pipeline run and 22c's processes, phase 23's
    # processes, phase 24's wire selftest, phase 25's stacked serve, 25b's
    # processes and 25c's selftest) summed
    def total(name):
        return sum(run.get(name, 0) for run in (
            launches, train_launches, sgp_launches, osgp_launches,
            resnet_sgp, resnet_osgp, resnet_norms, cli_launches,
            resil_launches,
            topo_launches, seq_launches, bf16_launches, dist_launches,
            image_launches, harness_launches, hier_launches,
            ckpt_launches, seq_dist_launches, tp_launches, ep_launches,
            tp_ep_launches, pp_launches, wire_launches, sharded_launches))

    flash = "stochastic_gradient_push_tpu/ops/flash_attention.py"
    bwd_src = "stochastic_gradient_push_torch/csrc/flash_bwd.cu"
    gossip = "stochastic_gradient_push_tpu/ops/gossip_kernel.py"
    gossip_src = "stochastic_gradient_push_torch/csrc/gossip_edge.cu"
    # the gossip rows at the OSGP main path's wire (bf16, two edges), on
    # the whole payload in one bucket
    gossip_row = gossip_rows[("bf16", 2)]
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="stochastic_gradient_push_torch/csrc/flash_fwd.cu",
             replaces=f"{flash}:110", launches=total("flash_fwd"),
             **flash_row),
        dict(name="paged_decode", route="cuda",
             source="stochastic_gradient_push_torch/csrc/paged_decode.cu",
             replaces="stochastic_gradient_push_tpu/serve/"
                      "paged_attention.py:113",
             launches=total("paged_decode"), **paged_row),
        dict(name="flash_bwd_dq", route="cuda", source=bwd_src,
             replaces=f"{flash}:227", launches=total("flash_bwd_dq"),
             **bwd_rows["flash_bwd_dq"]),
        dict(name="flash_bwd_dkv", route="cuda", source=bwd_src,
             replaces=f"{flash}:270", launches=total("flash_bwd_dkv"),
             **bwd_rows["flash_bwd_dkv"]),
        dict(name="gossip_edge_start", route="cuda", source=gossip_src,
             replaces=f"{gossip}:295", launches=total("gossip_edge_start"),
             **gossip_row["gossip_edge_start"]),
        dict(name="gossip_edge_wait", route="cuda", source=gossip_src,
             replaces=f"{gossip}:513", launches=total("gossip_edge_wait"),
             **gossip_row["gossip_edge_wait"]),
        dict(name="flash_fwd_bf16", route="cuda",
             source="stochastic_gradient_push_torch/csrc/flash_fwd.cu",
             replaces=f"{flash}:110", launches=total("flash_fwd_bf16"),
             **bf16_rows["flash_fwd_bf16"]),
        dict(name="flash_bwd_dq_bf16", route="cuda", source=bwd_src,
             replaces=f"{flash}:227", launches=total("flash_bwd_dq_bf16"),
             **bf16_rows["flash_bwd_dq_bf16"]),
        dict(name="flash_bwd_dkv_bf16", route="cuda", source=bwd_src,
             replaces=f"{flash}:270", launches=total("flash_bwd_dkv_bf16"),
             **bf16_rows["flash_bwd_dkv_bf16"]),
        # the cross-process forms, at phase 13b's shape (ResNet-50, f32,
        # one edge), timed with four processes sharing the card
        dict(name="gossip_edge_start_ipc", route="cuda", source=gossip_src,
             replaces=f"{gossip}:295",
             launches=total("gossip_edge_start_ipc"),
             **dist_rows["gossip_edge_start_ipc"]),
        dict(name="gossip_edge_wait_ipc", route="cuda", source=gossip_src,
             replaces=f"{gossip}:513", launches=total("gossip_edge_wait_ipc"),
             **dist_rows["gossip_edge_wait_ipc"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
