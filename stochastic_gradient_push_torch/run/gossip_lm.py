"""Gossip LM CLI — decentralized transformer training on the GPU.

Port of ``stochastic_gradient_push_tpu/run/gossip_lm.py`` for the flat
data-parallel mesh and the ``(gossip, seq)`` mesh: SGP or OSGP
(push-sum over a flat gossip graph), D-PSGD (``--push_sum False``),
AD-PSGD (``--bilat True``, bilateral averaging over the graph's perfect
matchings) or AllReduce, the synthetic Markov corpus, torch-semantics
SGD under the reference's LR schedule.  Run directly, every rank of
``--world_size`` lives in this process on the stacked transport
(``parallel/collectives.py``); on one GPU the default world is 1.
Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) each process
holds one rank on the ``torch.distributed`` transport
(``parallel/multihost.py``): on ``cuda:{LOCAL_RANK % cards}`` over NCCL,
or over gloo where ranks share a card or with ``--device cpu``; rank 0
prints.

Example (CPU, the kernels' plain twins)::

    python -m stochastic_gradient_push_torch.run.gossip_lm --device cpu \\
      --world_size 4 --vocab_size 256 --d_model 64 --n_layers 2 \\
      --n_heads 1 --d_ff 128 --seq_len 64 --batch_size 2 --num_steps 10

On a GPU, ``--world_size 4 --gossip_kernel pallas`` runs the four ranks
stacked on the card with the gossip transport kernels
(``ops/gossip_kernel.py``); ``--overlap True --staleness 2`` makes it
OSGP; ``--gossip_buckets`` sets the transport buckets.  ``pallas`` needs
the card (``KernelBackendError`` on ``--device cpu``); under ``torchrun``
it is the cross-process transport kernel (peer landing blocks mapped by
CUDA IPC, with a flag barrier).  ``--gossip_every k`` fires a round every k-th step;
``--global_avg_every k`` takes an exact global average every k steps
(unset: the topology plan decides).  The planner's flags
(``--topology auto|synth|<name>``, ``--synth_*``, ``--gap_floor``,
``--slice_size``, ``--dcn_cost``, ``--ici_cost``, ``--mixing_alpha``;
``run/gossip_sgd.py``) plan a gossip run at world 2 or more and print
its ``gossip plan:`` line; ``--graph_type 6`` is the hierarchical graph.
``--wire_dtype int8 --error_feedback True`` carries error feedback,
``--inject_faults SPEC`` drills faults into the rounds and
``--health_every k`` (a multiple of ``--print_freq``) prints ``gossip
health:`` lines, with ``--residual_floor`` arming the reactive global
average.

``--sp k`` cuts each sequence into ``k`` contiguous shards held
stacked beside their replica (``parallel/seq.py``): ``--world_size /
--sp`` replicas gossip, and the graph, the LR scaling, the batches and
tokens/s count those replicas.  Attention then runs as a ring: ``--attn
ring`` (plain PyTorch, the default under ``--sp > 1``) or ``ring_flash``
(the flash kernels as ring ticks); ``--remat True`` recomputes each
block in the backward.  Under ``torchrun``, ``--sp > 1`` is refused (the
cross-process sequence ring is not ported).  On the GPU::

    python -m stochastic_gradient_push_torch.run.gossip_lm --world_size 8 \
      --sp 4 --attn ring_flash --remat True --gossip_kernel pallas \
      --vocab_size 32000 --d_model 768 --n_layers 12 --n_heads 12 \
      --d_ff 3072 --seq_len 4096 --batch_size 2

``--precision bf16`` (the reference's flag) computes the model in
bf16 on fp32 parameters (``models/transformer.py``): bf16 matmuls, the
bf16 forms of the flash kernels, LayerNorm and the loss in fp32; the
optimizer and the gossip round stay fp32.  It combines with every
``--attn``, ``--sp``, ``--remat``, algorithm and ``--gossip_kernel``.

It runs on CUDA unless ``--device cpu``; ``--attn`` defaults to
``flash`` (the hand-written kernels, forward and backward, on CUDA)
without ``--sp``.
Ported flags keep the reference's names and defaults.  Every other flag
of the reference parses with its default and is refused, by name, when
given another value: none is silently ignored.  Prints the reference's
CSV columns (``step,loss,ppl,lr,tokens_per_sec,grad_norm``) to stdout;
no file is written.
"""

from __future__ import annotations

import argparse
import json
import time

__all__ = ["main", "build_parser", "UNPORTED"]

# flag -> (reference default, type, what it belongs to): parsed so a
# reference command line is accepted, refused when not at its default
UNPORTED = {
    "--gossip_comm_dtype": (None, str, "the deprecated comm dtype alias"),
    "--fleet": ("False", str, "fleet supervision"),
    "--host_id": (None, int, "fleet supervision"),
    "--attn_block_k": (0, int, "the TPU attention block rule"),
    "--tp": (1, int, "tensor parallelism"),
    "--ep": (1, int, "expert parallelism"),
    "--pp": (1, int, "pipeline parallelism"),
    "--n_micro": (4, int, "pipeline parallelism"),
    "--moe_experts": (0, int, "MoE"),
    "--moe_every": (2, int, "MoE"),
    "--corpus_file": (None, str, "file corpora"),
    "--checkpoint_dir": ("./checkpoints", str, "checkpoints"),
    "--tag": ("lm_", str, "checkpoints"),
    "--ckpt_every": (0, int, "checkpoints"),
    "--resume": ("False", str, "checkpoints/resume"),
    "--ckpt_backend": ("msgpack", str, "checkpoints"),
    "--heartbeat_timeout": (300, int, "the metrics-fetch watchdog"),
    "--val_frac": (0.0, float, "validation"),
    "--val_every": (0, int, "validation"),
    "--val_batches": (8, int, "validation"),
    "--profile_dir": (None, str, "profiling windows"),
    "--profile_start_step": (None, int, "profiling windows"),
    "--profile_steps": (None, int, "profiling windows"),
    "--trace_dir": (None, str, "run telemetry"),
    "--metrics_every": (0, int, "run telemetry"),
    "--multihost": ("auto", str, "multi-host runs"),
    "--coordinator_address": (None, str, "multi-host runs"),
    "--num_processes": (None, int, "multi-host runs"),
    "--process_id": (None, int, "multi-host runs"),
}
ATTN_CHOICES = (None, "full", "blockwise", "flash", "ring", "ring_flash")
# --precision -> the model's compute dtype (the reference's cfg.dtype,
# run/gossip_lm.py:543 there); parameters, momentum and the gossip round
# stay fp32
PRECISIONS = {"fp32": "float32", "bf16": "bfloat16"}


def _str_bool(v) -> bool:
    return str(v) == "True"


def build_parser() -> argparse.ArgumentParser:
    from ..ops.gossip_kernel import GOSSIP_KERNELS
    from ..parallel.wire import WIRE_DTYPES
    from ..topology import GRAPH_TOPOLOGIES
    from .gossip_sgd import add_planner_flags

    p = argparse.ArgumentParser(description="Gossip LM on a GPU (PyTorch)")
    p.add_argument("--all_reduce", default="False", type=str)
    p.add_argument("--push_sum", default="True", type=str,
                   help="False: D-PSGD (doubly-stochastic gossip)")
    p.add_argument("--bilat", default="False", type=str,
                   help="AD-PSGD: bilateral perfect-matching averaging "
                        "(synchronous formulation)")
    p.add_argument("--graph_type", default=5, type=int,
                   choices=sorted(GRAPH_TOPOLOGIES))
    add_planner_flags(p)
    p.add_argument("--peers_per_itr", default=1, type=int)
    p.add_argument("--wire_dtype", default=None, choices=WIRE_DTYPES,
                   help="gossip wire codec; the push-sum weight lane "
                        "always ships exact f32")
    p.add_argument("--wire_block", default=64, type=int,
                   help="int8 codec block size")
    p.add_argument("--error_feedback", default="False", type=str,
                   help="carry per-rank error-feedback residuals (needs "
                        "a lossy --wire_dtype)")
    p.add_argument("--inject_faults", default=None, type=str,
                   help="deterministic fault injection at the gossip "
                        "round (resilience/faults.py grammar); "
                        "mass-conserving drops, push-sum only")
    p.add_argument("--health_every", default=0, type=int,
                   help="emit a 'gossip health:' line every k steps (a "
                        "multiple of --print_freq); excursions arm the "
                        "recovery policy; 0 disables")
    p.add_argument("--residual_floor", default=0.01, type=float,
                   help="consensus residual above which recovery fires "
                        "an exact global average (with --health_every)")
    p.add_argument("--overlap", default="False", type=str,
                   help="OSGP: launch each round at the top of the step, "
                        "consume it staleness-1 steps later")
    p.add_argument("--staleness", default=0, type=int,
                   help="overlap in-flight FIFO depth (0 = 1)")
    p.add_argument("--gossip_kernel", default="xla",
                   choices=list(GOSSIP_KERNELS),
                   help="gossip transport lane: 'pallas' runs the payload "
                        "through the CUDA start/wait kernels on the "
                        "stacked lane, 'auto' picks them on a CUDA device, "
                        "'xla' (default) is the plain transport")
    p.add_argument("--gossip_buckets", default=1, type=int,
                   help="kernel-lane transport buckets per round")
    p.add_argument("--gossip_every", default=1, type=int,
                   help="gossip on every k-th step (communication "
                        "thinning)")
    p.add_argument("--global_avg_every", default=None, type=int,
                   help="exact global average every k steps; unset = the "
                        "planner decides, 0 = off, k = every k steps")
    p.add_argument("--lr", default=0.5, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--nesterov", default="False", type=str)
    p.add_argument("--warmup", default="False", type=str)
    p.add_argument("--warmup_steps", default=None, type=int,
                   help="linear warmup horizon (default: num_steps // 10)")
    p.add_argument("--vocab_size", default=256, type=int)
    p.add_argument("--d_model", default=256, type=int)
    p.add_argument("--n_layers", default=4, type=int)
    p.add_argument("--n_heads", default=8, type=int)
    p.add_argument("--d_ff", default=1024, type=int)
    p.add_argument("--seq_len", default=256, type=int)
    p.add_argument("--attn", default=None, choices=ATTN_CHOICES,
                   help="default: ring when --sp > 1, else flash (the CUDA "
                        "kernels; plain twins on CPU). ring_flash runs the "
                        "flash kernels as ring ticks, ring and blockwise "
                        "are plain PyTorch, full is dense attention")
    p.add_argument("--attn_block", default=0, type=int,
                   help="blockwise only: the key block (0 = min(128, "
                        "seq_len)). flash and ring_flash refuse it: the "
                        "kernels' tiles are their own and ring_flash takes "
                        "any shard length (the reference's min(128, shard) "
                        "rule is its TPU block rule)")
    p.add_argument("--remat", default="False", type=str,
                   help="recompute each block's forward in the backward")
    p.add_argument("--precision", default="fp32", choices=list(PRECISIONS),
                   help="compute dtype of the model (bf16: bf16 matmuls, "
                        "embedding and residual stream, the bf16 flash "
                        "kernels; LayerNorm, softmax and loss in fp32); "
                        "parameters, optimizer state and gossip stay fp32")
    p.add_argument("--sp", default=1, type=int,
                   help="sequence-parallel shards per replica, stacked on "
                        "the device: --world_size / --sp replicas gossip")
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--world_size", default=None, type=int,
                   help="gossip ranks, all held in this process "
                        "(default 1); under torchrun, the launched "
                        "world")
    p.add_argument("--batch_size", default=8, type=int,
                   help="sequences per rank per step")
    p.add_argument("--num_steps", default=1000, type=int)
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--seed", default=47, type=int)
    p.add_argument("--corpus_tokens", default=500_000, type=int)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the "
                        "kernels' plain twins)")
    for flag, (default, typ, _) in UNPORTED.items():
        p.add_argument(flag, default=default, type=typ,
                       help=argparse.SUPPRESS)
    return p


def refuse_unported(args) -> None:
    """SystemExit naming the first flag set to a feature not ported."""
    for flag, (default, _, feature) in UNPORTED.items():
        value = getattr(args, flag[2:])
        if default in ("True", "False"):
            changed = _str_bool(value) != _str_bool(default)
        else:
            changed = value != default
        if changed:
            raise SystemExit(
                f"{flag} {value}: {feature} is not ported to "
                f"stochastic_gradient_push_torch yet (a later slice; "
                f"ROADMAP.md Queue 1)")


def resolve_seq_flags(args, world: int, launched: int) -> tuple[int, str]:
    """``(dp, attn)`` for ``--sp`` over ``world`` ranks, with the
    reference's checks (run/gossip_lm.py:269-316, 494-519): ``dp = world
    // sp`` replicas gossip, each holding ``sp`` sequence shards; an unset
    ``--attn`` is ``ring`` under sp > 1, else ``flash``.  Under
    ``torchrun``, ``--sp > 1`` is refused: the sequence ring across
    processes is not ported."""
    sp = args.sp
    if sp < 1:
        raise SystemExit("--sp must be >= 1")
    if sp > 1 and launched > 1:
        raise SystemExit(
            f"--sp {sp} under torchrun: the cross-process sequence ring "
            f"(one shard per GPU) is not ported yet (ROADMAP.md Queue 1); "
            f"run the shards stacked with --world_size")
    if world % sp:
        raise SystemExit(f"world_size {world} not divisible by sp*tp*ep*pp "
                         f"{sp}")
    if args.seq_len % sp:
        raise SystemExit(f"seq_len {args.seq_len} not divisible by sp {sp}")
    attn = args.attn or ("ring" if sp > 1 else "flash")
    if sp > 1 and attn not in ("ring", "ring_flash"):
        raise SystemExit("--sp > 1 requires ring attention")
    if args.attn_block and attn != "blockwise":
        raise SystemExit(
            f"--attn_block {args.attn_block} with --attn {attn}: the block "
            f"is the blockwise attention's; the flash kernels' tiles are "
            f"their own")
    return world // sp, attn


def resolve_staleness_flag(args, overlap: bool) -> None:
    """Validate ``--staleness`` in place (the reference's rule, run/
    gossip_sgd.py:269-283, without its ``--synch_freq`` alias):
    non-negative and overlap-only."""
    if args.staleness < 0:
        raise SystemExit("--staleness must be >= 0 (0 = derive from "
                         "--synch_freq)")
    if args.staleness > 1 and not overlap:
        raise SystemExit("--staleness is an overlap-mode knob")


def resolve_kernel_flag(args, device, launched: int):
    """The ``--gossip_kernel`` lane for this run: ``pallas`` needs a CUDA
    device (``KernelBackendError`` otherwise; under ``torchrun`` it is
    the cross-process transport kernel)."""
    from ..ops.gossip_kernel import KernelBackendError, resolve_gossip_kernel

    if args.gossip_buckets < 1:
        raise SystemExit("--gossip_buckets must be >= 1, got "
                         f"{args.gossip_buckets}")
    if args.gossip_every < 1:
        raise SystemExit("--gossip_every must be >= 1, got "
                         f"{args.gossip_every}")
    if (args.global_avg_every or 0) < 0:
        raise SystemExit("--global_avg_every must be >= 0, got "
                         f"{args.global_avg_every}")
    try:
        return resolve_gossip_kernel(args.gossip_kernel, device=device)
    except KernelBackendError as e:
        where = (" under torchrun (the cross-process transport kernel)"
                 if launched > 1 else "")
        raise KernelBackendError(f"--gossip_kernel {args.gossip_kernel}"
                                 f"{where}: {e}") from None


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    refuse_unported(args)

    import numpy as np
    import torch

    from ..algorithms import adpsgd, all_reduce, dpsgd, sgp
    from ..data.lm import lm_batches, synthetic_lm_corpus
    from ..device import resolve_device
    from ..models.transformer import TransformerConfig
    from ..parallel.discovery import discover
    from ..parallel.multihost import (host_local_slice, initialize_multihost,
                                      process_device)
    from ..parallel.collectives import DistTransport, StackedTransport
    from ..parallel.seq import StackedSeq
    from ..parallel.wire import get_codec
    from ..topology import (GRAPH_TOPOLOGIES, TOPOLOGY_NAMES,
                            build_pairing_schedule, build_schedule)
    from .gossip_sgd import parse_mixing_alpha, plan_topology, \
        synth_plan_config
    from ..train.lm import build_lm_train_step, init_lm_state, make_model
    from ..train.lr import WARMUP_EPOCHS, LRSchedule
    from ..train.state import sgd

    sb = _str_bool
    resolve_staleness_flag(args, sb(args.overlap))
    ef = sb(args.error_feedback)
    if ef and args.wire_dtype not in ("bf16", "int8"):
        raise SystemExit(
            "--error_feedback needs a lossy --wire_dtype (bf16/int8): "
            "an exact wire has no quantization error to feed back")
    fault_plan = None
    if args.inject_faults:
        if sb(args.all_reduce) or sb(args.bilat) or not sb(args.push_sum):
            raise SystemExit("--inject_faults needs push-sum gossip: only "
                             "push-sum's mass accounting keeps the mean "
                             "exact under dropped edges")
        from ..resilience import parse_fault_spec

        fault_plan = parse_fault_spec(args.inject_faults)
    if args.health_every < 0:
        raise SystemExit("--health_every must be >= 0")
    if args.health_every and args.health_every % args.print_freq:
        raise SystemExit(
            f"--health_every {args.health_every} must be a multiple of "
            f"--print_freq {args.print_freq} (health signals ride the "
            "metrics fetch cadence)")
    info = discover()
    launched = info.world_size
    device = (process_device(args.device, info) if launched > 1
              else resolve_device(args.device))
    world = args.world_size or 1
    dp, attn = resolve_seq_flags(args, launched if launched > 1 else world,
                                 launched)
    lane = resolve_kernel_flag(args, device, launched)
    if launched > 1:
        if args.world_size not in (None, launched):
            raise SystemExit(f"--world_size {args.world_size} but the "
                             f"launcher started {launched} processes")
        owns_group = not torch.distributed.is_initialized()
        initialize_multihost("xla", device, info)
        world = dp = launched
        transport = DistTransport()
    else:
        transport = StackedTransport(dp)
    rank0 = launched == 1 or transport.rank == 0
    log0 = print if rank0 else (lambda *a, **k: None)
    if args.batch_size % args.grad_accum:
        raise SystemExit(f"--batch_size {args.batch_size} not divisible "
                         f"by --grad_accum {args.grad_accum}")
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
        attn_impl=attn, attn_block_size=args.attn_block or None,
        remat=sb(args.remat),
        dtype=getattr(torch, PRECISIONS[args.precision]))
    args.mixing_alpha = parse_mixing_alpha(args.mixing_alpha)
    if args.mixing_alpha is not None and (
            sb(args.all_reduce) or not sb(args.push_sum)):
        raise SystemExit("--mixing_alpha needs push-sum gossip: AllReduce "
                         "doesn't mix, and D-PSGD requires a regular "
                         "(doubly-stochastic) schedule")
    fabric_flags = (args.slice_size is not None
                    or args.dcn_cost is not None
                    or args.ici_cost is not None)
    if (args.mixing_alpha is not None or fabric_flags) \
            and (sb(args.bilat) or sb(args.all_reduce) or dp < 2):
        raise SystemExit("--topology auto / --mixing_alpha / fabric "
                         "flags (--slice_size/--dcn_cost/--ici_cost) "
                         "plan gossip schedules; they do not apply to "
                         "all_reduce/bilateral modes or a "
                         "single-rank world")
    # the launch-time plan, before any model work, as in the reference
    plan = None
    synth_plan_config(args)   # refuses stray --synth_* knobs
    if not sb(args.all_reduce) and not sb(args.bilat) and dp > 1:
        import types

        plan = plan_topology(
            args, dp, args.peers_per_itr,
            GRAPH_TOPOLOGIES[args.graph_type], sb(args.push_sum),
            sb(args.overlap), types.SimpleNamespace(
                info=lambda fmt, *a: log0(fmt % a, flush=True),
                warning=lambda m: log0(m, flush=True)))
    elif args.topology is not None and (sb(args.all_reduce)
                                        or sb(args.bilat)):
        raise SystemExit("--topology selects a push-sum/D-PSGD gossip "
                         "graph; it does not apply to all_reduce/bilat "
                         "modes")
    elif args.topology in ("auto", "synth"):
        raise SystemExit(f"--topology {args.topology} plans gossip "
                         "schedules; it does not apply to a "
                         "single-replica mesh")
    # the plan's graph (a hierarchical plan binds its slice
    # decomposition, a synthesized one its spec), mixing and period
    if plan is not None:
        graph_of, mixing = plan.graph_class, plan.mixing_strategy()
        gae = plan.global_avg_every
    else:
        graph_of = (TOPOLOGY_NAMES[args.topology] if args.topology
                    else GRAPH_TOPOLOGIES[args.graph_type])
        mixing, gae = None, args.global_avg_every or 0
    if sb(args.all_reduce):
        if (args.wire_dtype is not None or sb(args.overlap)
                or args.gossip_kernel != "xla" or args.gossip_buckets != 1
                or args.gossip_every != 1 or args.global_avg_every):
            raise SystemExit("--wire_dtype/--overlap/--gossip_kernel/"
                             "--gossip_buckets/--gossip_every/"
                             "--global_avg_every tune the push-sum gossip; "
                             "they do not apply to --all_reduce True")
        alg = all_reduce(transport)
    elif sb(args.bilat) or not sb(args.push_sum):
        if args.wire_dtype not in (None, "f32") or args.gossip_every != 1 \
                or ef:
            raise SystemExit("gossip_every/wire_dtype/error_feedback are "
                             "push-sum knobs")
        if sb(args.bilat):
            graph = GRAPH_TOPOLOGIES[args.graph_type](
                dp, peers_per_itr=args.peers_per_itr)
            alg = adpsgd(build_pairing_schedule(graph), transport)
        else:
            alg = dpsgd(build_schedule(
                            graph_of(dp, peers_per_itr=args.peers_per_itr),
                            mixing),
                        transport, overlap=sb(args.overlap),
                        staleness=max(1, args.staleness), gossip_kernel=lane,
                        gossip_buckets=args.gossip_buckets,
                        global_avg_every=gae)
    else:
        schedule = build_schedule(
            graph_of(dp, peers_per_itr=args.peers_per_itr), mixing)
        faults = None
        if fault_plan is not None:
            faults = fault_plan.build_masks(schedule,
                                            gossip_every=args.gossip_every)
            log0(f"gossip faults: {fault_plan.summary()}", flush=True)
        alg = sgp(schedule, transport,
                  wire=get_codec(args.wire_dtype, args.wire_block),
                  error_feedback=ef, faults=faults,
                  overlap=sb(args.overlap),
                  staleness=max(1, args.staleness), gossip_kernel=lane,
                  gossip_buckets=args.gossip_buckets,
                  gossip_every=args.gossip_every,
                  global_avg_every=gae)
    tx = sgd(momentum=args.momentum, weight_decay=args.weight_decay,
             nesterov=sb(args.nesterov))
    # the reference's step-based warmup horizon and LR scaling over the
    # data-parallel replicas (sequence shards do not enlarge the batch)
    warmup_steps = args.warmup_steps or max(args.num_steps // 10, 1)
    itr_per_epoch = max(warmup_steps // WARMUP_EPOCHS, 1)
    lrs = LRSchedule(ref_lr=args.lr, batch_size=args.batch_size,
                     world_size=dp, decay_schedule={},
                     warmup=sb(args.warmup))
    step = build_lm_train_step(
        make_model(cfg), alg, tx, lrs, itr_per_epoch=itr_per_epoch,
        grad_accum=args.grad_accum,
        health_axis=transport if args.health_every > 0 else None,
        seq=StackedSeq(args.sp) if cfg.ring else None)
    held = len(transport.ranks)
    state = init_lm_state(cfg, alg, tx, held, seed=args.seed, device=device)
    log = log0
    monitor = policy = recovery = None
    if args.health_every > 0:
        # signals ride every step's metrics and are read at the print
        # cadence (the only points the loop reads metrics)
        import types

        from ..resilience import (HealthMonitor, RecoveryPolicy,
                                  make_recovery_fn)

        line = types.SimpleNamespace(
            info=lambda m: log(m, flush=True),
            warning=lambda m: log(m, flush=True))
        monitor = HealthMonitor(health_every=args.health_every,
                                residual_floor=args.residual_floor,
                                log=line)
        window = None   # (host clock, steps_done) at the last read
        if dp > 1 and hasattr(alg, "global_average"):
            from ..parallel.wire import wire_stamp
            from ..planner import make_interconnect

            policy = RecoveryPolicy(
                world=dp, ppi=args.peers_per_itr,
                algorithm="sgp" if sb(args.push_sum) else "dpsgd",
                topology=plan.topology if plan is not None else None,
                residual_floor=args.residual_floor,
                cooldown_steps=args.health_every, log=line,
                interconnect=make_interconnect(args.slice_size,
                                               args.dcn_cost, args.ici_cost),
                faults=bool(args.inject_faults),
                wire=wire_stamp(args.wire_dtype, args.wire_block, ef),
                synth=plan.synth if plan is not None else None)
            recovery = make_recovery_fn(alg)
    n_params = sum(p[0].numel() for p in state.params.values())
    gossip = ""
    if alg.name in ("sgp", "dpsgd"):
        gossip = (f"; gossip lane {alg.transport_kernel_name}, buckets "
                  f"{alg.gossip_buckets}"
                  + (f", overlap staleness {alg.staleness}" if alg.overlap
                     else ""))
    shards = f" = dp {dp} x sp {args.sp}" if args.sp > 1 else ""
    log(f"lm: world {world}{shards} ({held} in this process) on {device}; "
        f"{n_params / 1e6:.2f}M params; attn={attn}"
        f"{' remat' if cfg.remat else ''}; precision {args.precision}; "
        f"algorithm={alg.name}{gossip}", flush=True)

    def mean(x) -> float:
        """Mean over all replicas of a per-held-replica metric (a
        collective under torchrun: every process calls it)."""
        return float(transport.allreduce_sum(x.reshape(-1).float())[0]
                     / dp)

    corpus = synthetic_lm_corpus(args.corpus_tokens,
                                 vocab_size=args.vocab_size, seed=args.seed)
    tokens_per_step = dp * args.batch_size * args.seq_len
    log("step,loss,ppl,lr,tokens_per_sec,grad_norm", flush=True)
    steps_done, epoch, losses = 0, 0, []
    t0 = time.perf_counter()
    while steps_done < args.num_steps:
        for tokens, targets in lm_batches(corpus, dp, args.sp,
                                          args.batch_size, args.seq_len,
                                          seed=args.seed + epoch):
            # [dp, sp, batch, seq_len / sp]; flat models take [dp, batch,
            # seq_len]
            mine = host_local_slice({"x": tokens, "y": targets}, transport)
            toks, tgts = (torch.from_numpy(a if cfg.ring else a[:, 0])
                          .to(device) for a in (mine["x"], mine["y"]))
            state, metrics = step(state, toks, tgts)
            steps_done += 1
            if (steps_done % args.print_freq == 0
                    or steps_done >= args.num_steps):
                loss = mean(metrics["loss"])   # waits for the step
                losses.append(loss)
                if monitor is not None:
                    state, window = _observe_health(
                        monitor, policy, recovery, alg, state, metrics,
                        steps_done, window)
                tps = (tokens_per_step * steps_done
                       / (time.perf_counter() - t0))
                log(f"{steps_done},{loss:.4f},{mean(metrics['ppl']):.2f},"
                    f"{float(metrics['lr']):.5f},{tps:.0f},"
                    f"{mean(metrics['grad_norm']):.4f}", flush=True)
            if steps_done >= args.num_steps:
                break
        epoch += 1
    result = {"final_loss": losses[-1], "avg_loss": float(np.mean(losses)),
              "tokens_per_sec": tokens_per_step * steps_done
              / (time.perf_counter() - t0)}
    log(json.dumps(result), flush=True)
    if launched > 1:
        transport.close()
        if owns_group:
            torch.distributed.destroy_process_group()
    return result


def _observe_health(monitor, policy, recovery, alg, state, metrics,
                    steps_done: int, window):
    """Read one step's health signals at the print cadence, observe
    them (one step-time sample per read window, the first window left
    out) and fire the policy's global average; returns ``(state,
    window)``."""
    from ..resilience.monitor import host_signals
    from ..resilience.recovery import recover_state

    now = time.perf_counter()
    if window is not None and steps_done > window[1]:
        monitor.record_step_time((now - window[0])
                                 / (steps_done - window[1]))
    report = monitor.observe(steps_done, host_signals(metrics))
    if report.unhealthy and policy is not None:
        if policy.assess(report).action == "global-average":
            state = recover_state(state, alg, recovery)
    return state, (now, steps_done)


if __name__ == "__main__":
    main()
