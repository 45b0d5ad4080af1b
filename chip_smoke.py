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
   bit-equal, params within 1e-6.  Then 5 kernel-lane steps with the
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
   bit-equal, params within 1e-6.  Then 8 kernel-lane steps with the
   counters zeroed just before: a fired step launches one start and one
   wait per bucket (the wait lands or settles the launched share), a
   skipped step launches nothing, every loss is finite, every rank's
   push-sum weight is exactly 1.0 after each global average (and the
   FIFO drained); median step ms, images/s, peak memory and
   ``replica_spread`` are printed.
8. The training CLI, ``run/gossip_sgd.py``, at ResNet-50's full width
   (224 px, 1000 classes, fp32, TF32 off), world 4 stacked, 32 images a
   rank, synthetic data (seed 0), two epochs of three iterations with
   validation, each run with the counters zeroed just before:
   - SGP and D-PSGD (``--push_sum False``) on the kernel lane
     (``--gossip_kernel pallas``): one start and one wait per step, no
     other kernel; the rank-averaged CSV's header and its 10 rows; one
     checkpoint file per rank.  Their step times (the trainer's own
     ``BT`` meter, each epoch's first step left out) are printed.
   - D-PSGD on the kernel lane against ``--gossip_kernel xla``: two
     steps from one state (seed 0) under deterministic cuDNN, params
     within 1e-6 (the saved rank files).
   - AD-PSGD through ``run/gossip_sgd_adpsgd.py`` (graph 1): no gossip
     kernel launched; one bilateral round on ResNet-50's parameters on
     the card equal, bit for bit, to ``(x + x[partner]) * 0.5`` gathered
     to the host.
   - Resume equals continue: OSGP (staleness 2) on the kernel lane for
     two epochs straight, and for one epoch then ``--resume True`` in a
     fresh run, under deterministic cuDNN: every rank file's params,
     momentum, push-sum weight and FIFO exactly equal.
   - Preemption: a subprocess run of the CLI (OSGP, ``--overlap True``)
     gets SIGUSR1 once it is training; it must exit 75 and leave the
     four rank files with a drained (all-zero) FIFO.
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
     EF residual and a drained FIFO, the reference's CSV;
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
     --remat True --gossip_kernel pallas`` at the same shape, 4 steps:
     finite CSV rows, the launches as in 11b;
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
     steps: finite CSV rows, 192 bf16 K3, K4 and K5, four K2 and K1;
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
   - 13b: ``run/gossip_sgd.py`` in 2 processes under a torchrun
     environment (``--backend gloo --gossip_kernel pallas``), ResNet-50
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
15. A JSON line of per-kernel results (the fp32 flash rows also carry
   ``bound_fp32_cores_ms``, the CUDA-core bound, the bf16 flash rows
   ``max_ulps`` and ``share_apart``, their ``ms`` from CUDA graphs; the
   paged-decode row ``device_ms`` and ``host_ms``),
   the ``nvidia-smi`` name/power-limit line, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, before printing any result, without a CUDA device or
outside a checkout of the repository; any failed phase raises.
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
GOSSIP_STEPS = 5
GOSSIP_CHECKS = (("f32", 1), ("f32", 2), ("bf16", 1), ("bf16", 2),
                 ("int8", 1), ("int8", 2))
# the ResNet phase: ResNet-50 at full width, world 4 stacked, bench.py's
# per-chip batch of 128 split over the ranks
RESNET = dict(model="resnet50", num_classes=1000, image=224, batch=32,
              world=4, steps=8, gossip_every=2, global_avg_every=4,
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


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


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
    for hq, hkv in ((12, 12), (12, 6)):
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
        if hq == hkv:   # the engine's shape: group 1
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


def main_path(card: str):
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
    t0 = time.perf_counter()
    engine = LMEngine(init_params(cfg, seed=0), ServeConfig(
        n_heads=12, page_size=16, num_pages=1024, max_seqs=16,
        max_pages_per_seq=48), device="cuda")
    torch.cuda.synchronize()
    print(f"main: engine d{cfg.d_model} L{cfg.n_layers} h{cfg.n_heads} "
          f"ff{cfg.d_ff} vocab{cfg.vocab_size} built in "
          f"{time.perf_counter() - t0:.2f} s; weights "
          f"{sum(p.numel() for p in engine.model.parameters()) * 4 / 1e9:.3f}"
          f" GB, KV pool {2 * engine._kc.numel() * 4 / 1e9:.3f} GB", flush=True)
    requests = synthetic_requests(48, seed=0, vocab=256,
                                  prompt_tokens=(64, 512),
                                  new_tokens=(16, 128))
    timed = _TimedEngine(engine)
    flash_fwd.launches = paged_decode.launches = 0
    metrics, completions = run_bench(timed, requests)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                "paged_decode": paged_decode.launches}
    print("main: summarize " + json.dumps(metrics, sort_keys=True),
          flush=True)
    print(f"main: launches {json.dumps(launches)}; host time prefill "
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
    return engine, requests, launches


def engine_vs_dense(engine, requests, card: str) -> None:
    """Two requests decoded side by side through the kernels, each
    step's logits held against the dense model (plain attention) fed
    the same tokens."""
    import torch

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
            dense = engine.model(torch.tensor([seq], device="cuda"))[0]
        t = len(r.prompt)
        worst = max(worst, _max_err(logits[0], dense[:t]))
        for j, lg in enumerate(logits[1:]):
            worst = max(worst, _max_err(lg, dense[t + j]))
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
    model = make_model(cfg["model"], num_classes=cfg["num_classes"],
                       dtype={"fp32": torch.float32,
                              "bf16": torch.bfloat16}[cfg["dtype"]])
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


def _cli_run(label: str, argv, card: str, module=None) -> tuple[dict, dict]:
    """One in-process run of the CLI with every counter zeroed just
    before: its launches and its result."""
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
    print(f"cli {label}: {wall:.2f} s in main (data, {CLI['epochs']} "
          f"epochs of {CLI['itrs']} steps, validation, checkpoints); step "
          f"(BT meter, {bt.count} timed steps) mean {bt.avg * 1e3:.2f} ms, "
          f"std {bt.std * 1e3:.2f} ms, "
          f"{CLI['world'] * CLI['batch'] / bt.avg:.1f} images/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{json.dumps(launches)} [{card}]", flush=True)
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


def cli_path(card: str) -> dict:
    """Phase 8: the training CLI at ResNet-50's width."""
    import torch

    from stochastic_gradient_push_torch.run import gossip_sgd_adpsgd

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(ROOT, "build"))
    try:
        print(f"cli: run/gossip_sgd.py, {CLI['model']} {CLI['image']} px, "
              f"{CLI['num_classes']} classes, world {CLI['world']} stacked, "
              f"batch {CLI['batch']}/rank, fp32, {CLI['epochs']} epochs of "
              f"{CLI['itrs']} steps", flush=True)
        main_runs = []
        for label, extra in (("sgp", []), ("dpsgd", ["--push_sum", "False"])):
            ckpt = os.path.join(tmp, label)
            launches, _ = _cli_run(label, _cli_argv(
                ckpt, "--gossip_kernel", "pallas", *extra), card)
            _assert_gossip_launches(label, launches, 1)
            _check_csv(os.path.join(ckpt, f"out_r0_n{CLI['world']}.csv"),
                       label)
            if len(_rank_files(ckpt)) != CLI["world"]:
                raise AssertionError(f"cli {label}: rank files missing")
            main_runs.append(launches)

        # D-PSGD: the kernel lane against the plain lane, two steps from
        # one state under deterministic cuDNN
        torch.backends.cudnn.deterministic = True
        try:
            lanes = {}
            for lane in ("pallas", "xla"):
                ckpt = os.path.join(tmp, f"lane_{lane}")
                _cli_run(f"dpsgd {lane} lane", _cli_argv(
                    ckpt, "--push_sum", "False", "--gossip_kernel", lane,
                    "--num_iterations_per_training_epoch", "2", epochs=1),
                    card)
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

            # AD-PSGD: no gossip kernel, and one round exact
            launches, _ = _cli_run("adpsgd", _cli_argv(
                os.path.join(tmp, "adpsgd"), "--graph_type", "1"), card,
                module=gossip_sgd_adpsgd)
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
                    ckpt, *osgp, "--resume", resume, epochs=epochs), card)
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

        _preempt_check(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {n: sum(run[n] for run in main_runs) for n in main_runs[0]}


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
    argv = _cli_argv(ckpt, "--overlap", "True", "--staleness", "2",
                     "--wire_dtype", "int8", "--error_feedback", "True",
                     "--inject_faults", RESIL_FAULTS_CLI,
                     "--health_every", "3", "--residual_floor", "1e-9",
                     "--gossip_kernel", "pallas", "--verbose", "True")
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
    argv = ["--world_size", str(dp * sp), "--sp", str(sp), "--attn",
            "ring_flash", "--remat", "True", "--gossip_kernel", "pallas",
            "--vocab_size", "32000", "--d_model", "768", "--n_layers", "12",
            "--n_heads", "12", "--d_ff", "3072", "--seq_len", str(t),
            "--batch_size", str(b), "--num_steps", str(n), "--print_freq",
            "1", "--corpus_tokens", str(dp * b * t * n + 1), "--seed", "0"]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = gossip_lm.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    lines = out.getvalue().splitlines()
    for line in lines:
        if line.startswith(("lm: ", "step,")) or line[:1].isdigit():
            print(f"seq 11c cli: {line}", flush=True)
    rows = [r.split(",") for r in lines[lines.index(
        "step,loss,ppl,lr,tokens_per_sec,grad_norm") + 1:]
        if r[:1].isdigit()]
    print(f"seq 11c cli: {wall:.2f} s in main, tokens/s "
          f"{result['tokens_per_sec']:.1f} over the run (the first step's "
          f"warm-up included), peak memory "
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
    argv = ["--precision", "bf16", "--world_size", str(w), "--gossip_kernel",
            "pallas", "--vocab_size", "32000", "--d_model", "768",
            "--n_layers", "12", "--n_heads", "12", "--d_ff", "3072",
            "--seq_len", str(t), "--batch_size", str(b), "--num_steps",
            str(n), "--print_freq", "1", "--corpus_tokens",
            str(w * b * t * n + 1), "--seed", "0"]
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = gossip_lm.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    lines = out.getvalue().splitlines()
    for line in lines:
        if line.startswith(("lm: ", "step,")) or line[:1].isdigit():
            print(f"bf16 12c cli: {line}", flush=True)
    rows = [r.split(",") for r in lines[lines.index(
        "step,loss,ppl,lr,tokens_per_sec,grad_norm") + 1:]
        if r[:1].isdigit()]
    print(f"bf16 12c cli: {wall:.2f} s in main, tokens/s "
          f"{result['tokens_per_sec']:.1f} over the run (the first step's "
          f"warm-up included); launches {json.dumps(launches)} [{card}]",
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
                raise AssertionError(f"{label}: a process hung past "
                                     f"{DIST_TIMEOUT_S} s") from None
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


def dist_cli_path(card: str) -> dict:
    """13b: run/gossip_sgd.py under a torchrun environment in 2 processes
    on the card (gloo group, the payload on the cross-process K2/K1),
    SGP and OSGP side by side; launch counts per step in each process,
    the rank files, and each rank's state against the stacked kernel-lane
    run of the same command (deterministic cuDNN)."""
    import torch

    from stochastic_gradient_push_torch.run import gossip_sgd

    t0 = time.perf_counter()
    world, steps = DIST_CLI["world"], DIST_CLI["itrs"]
    tmp = tempfile.mkdtemp(prefix="dist13_", dir=os.path.join(ROOT, "build"))
    runs = {"sgp": [], "osgp": ["--overlap", "True"]}

    def torchrun(r, port):
        return dict(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                    LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port))

    procs = {alg: _ranks(_DIST_CLI_CHILD, world, [json.dumps(_dist_argv(
        os.path.join(tmp, alg), "--backend", "gloo", *extra))], torchrun)
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
              f"(torchrun environment, --backend gloo, --gossip_kernel "
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stochastic_gradient_push_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in fp32 throughout, as XLA's do (phase 12)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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

    flash_row = check_flash(card)
    paged_row = check_paged(card)
    bwd_rows = check_flash_bwd(card)
    gossip_rows = check_gossip(card)
    engine, requests, launches = main_path(card)
    engine_vs_dense(engine, requests, card)
    del engine
    torch.cuda.empty_cache()
    train_launches, train_timed = train_path(card)
    torch.cuda.empty_cache()
    sgp_launches = gossip_train_path(card, "sgp", "int8", False, 1, 1, 1, 1)
    torch.cuda.empty_cache()
    osgp_launches = gossip_train_path(card, "osgp", "bf16", True, 2, 2, 3, 2)
    torch.cuda.empty_cache()
    resnet_sgp = resnet_train_path(card, "sgp", "f32", False, 1, 1, 1, 1)
    torch.cuda.empty_cache()
    resnet_osgp = resnet_train_path(card, "osgp", "bf16", True, 2, 2, 3, 2)
    torch.cuda.empty_cache()
    cli_launches = cli_path(card)
    torch.cuda.empty_cache()
    resil_launches = resilience_path(card)
    torch.cuda.empty_cache()
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

    # launches: each main path's run (serving, training at world 1, SGP
    # and OSGP at world 4, ResNet SGP and OSGP at world 4, the CLI's SGP,
    # D-PSGD and OSGP runs, phase 9's kernel-lane steps and CLI run,
    # phase 10's kernel-lane steps and CLI runs, phase 11's timed steps
    # and CLI run, phase 12's timed steps and CLI run, phase 13b's CLI
    # processes, phase 14a's three CLI runs) summed
    def total(name):
        return sum(run.get(name, 0) for run in (
            launches, train_launches, sgp_launches, osgp_launches,
            resnet_sgp, resnet_osgp, cli_launches, resil_launches,
            topo_launches, seq_launches, bf16_launches, dist_launches,
            image_launches))

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
