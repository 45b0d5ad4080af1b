"""Gossip SGD CLI — decentralized data-parallel image classification on
the GPU.

Port of ``stochastic_gradient_push_tpu/run/gossip_sgd.py``
(``build_parser``, ``parse_config``, ``main``): the reference's flag
surface with its names, string-encoded booleans, integer-coded graph and
mixing registries and flat-list schedules, driving the port's
``train/loop.py::Trainer``.  Every rank of ``--world_size`` (default 1)
lives in this process, stacked on one device; the five algorithms come
from ``--all_reduce``, ``--push_sum``, ``--overlap`` with ``--staleness``
or ``--synch_freq``, and (``run/gossip_sgd_adpsgd.py``) bilateral
AD-PSGD.  ``--gossip_kernel pallas`` moves SGP, OSGP and D-PSGD rounds
through the CUDA gossip kernels (``ops/gossip_kernel.py``); ``auto``
picks them on a CUDA device; ``pallas`` off the card raises
``KernelBackendError``.

Example (CPU, the kernels' plain twins)::

    python -m stochastic_gradient_push_torch.run.gossip_sgd --device cpu \\
      --dataset synthetic --model tiny_cnn --image_size 16 \\
      --num_classes 10 --batch_size 8 --world_size 4 --num_epochs 2 \\
      --num_iterations_per_training_epoch 5 --checkpoint_dir /tmp/ckpt/

It runs on CUDA unless ``--device cpu``.  The rank-averaged CSV
``{tag}out_r0_n{world}.csv`` (one per rank with ``--per_rank_csv True``)
and one checkpoint per rank, ``{tag}checkpoint_r{rank}_n{world}.ckpt``,
land in ``--checkpoint_dir``; ``--resume True`` continues from them.
SIGUSR1 or SIGTERM makes the run save at the next step and exit 75.

``--model`` is one of ``resnet18/34/50/101/152``, ``tiny_cnn`` and
``tiny_mlp``.  Only ``--dataset synthetic`` is ported: ImageFolder data
(the default) needs files and a decoder that are not ported yet.
``--wire_dtype int8 --error_feedback True`` carries error feedback,
``--inject_faults SPEC`` drills deterministic faults into the rounds,
``--health_every k`` prints ``gossip health:`` lines and
``--residual_floor`` arms the reactive global average (``gossip
recovery:`` lines).

The launch-time topology planner (``planner/``) runs before the trainer
is built, as in the reference, and logs its plan as one ``gossip plan:
{json}`` line that every rank file's meta also carries: ``--topology
auto`` picks (and tunes) the graph, ``--topology synth`` searches a
schedule of edge and grouped-mean phases against the priced fabric
(``--synth_seed/--synth_budget/--synth_beam/--synth_phases``), a name
(or ``--graph_type``, 6 being the hierarchical graph) forces a graph and
warns below ``--gap_floor``.  ``--slice_size``, ``--dcn_cost`` and
``--ici_cost`` describe the fabric, ``--mixing_alpha`` (``auto`` or a
float) makes the mixing self-weighted, and ``--global_avg_every`` unset
lets the plan decide.  On the card, ``--topology synth --slice_size 2
--dcn_cost 16`` at ``--world_size 4`` plans the three-phase cycle of
fingerprint ``b7e2ef83…``, and ``--topology auto`` with the same fabric
plans ``hierarchical``.  The flags
the reference accepts and ignores (``--backend``, ``--master_port``,
``--network_interface_type``, ``--no_cuda_streams``) are accepted and
ignored here too.  Every other flag whose feature is not ported parses
with its default and is refused, by name, when given another value
(:data:`UNPORTED`); none is silently ignored.
"""

from __future__ import annotations

import argparse
import os
import signal
import types

__all__ = ["build_parser", "parse_config", "build", "main", "UNPORTED"]

# flag -> (reference default, type, what it belongs to): parsed so a
# reference command line is accepted, refused when not at its default
UNPORTED = {
    "--prefetch": ("False", str, "device prefetch"),
    "--data_backend": ("auto", str, "ImageFolder decoding"),
    "--stem_s2d": ("False", str, "the space-to-depth ResNet stem"),
    "--data_output": ("f32", str, "the ImageFolder loader's uint8 output"),
    "--gossip_comm_dtype": (None, str, "the deprecated comm dtype alias"),
    "--checkpoint_all": ("True", str, "rank-0-only checkpoints"),
    "--nprocs_per_node": (1, int, "intra-node averaging (a local mesh "
                                  "axis)"),
    "--scan_steps": (1, int, "fused multi-step programs"),
    "--multihost": ("auto", str, "multi-host runs"),
    "--coordinator_address": (None, str, "multi-host runs"),
    "--num_processes": (None, int, "multi-host runs"),
    "--process_id": (None, int, "multi-host runs"),
    "--heartbeat_timeout": (300, int, "the step watchdog"),
    "--ckpt_backend": ("msgpack", str, "the orbax checkpoint backend"),
    "--trace_dir": (None, str, "run telemetry"),
    "--metrics_every": (0, int, "run telemetry"),
    "--profile_dir": (None, str, "profiling windows"),
    "--profile_start_step": (None, int, "profiling windows"),
    "--profile_steps": (None, int, "profiling windows"),
    "--fleet": ("False", str, "fleet supervision"),
    "--host_id": (None, int, "fleet supervision"),
}
# values other than the default that leave the feature off
_ALSO_OFF = {"--multihost": ("False",)}
MODELS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
          "tiny_cnn", "tiny_mlp")


def _str_bool(v) -> bool:
    return str(v) == "True"


def add_planner_flags(p: argparse.ArgumentParser) -> None:
    """The topology planner's flags, shared by both CLIs, with the
    reference's names and defaults."""
    from ..topology import TOPOLOGY_NAMES

    p.add_argument("--topology", default=None,
                   choices=["auto"] + sorted(TOPOLOGY_NAMES),
                   help="'auto' lets the planner pick (and tune) the "
                        "gossip graph; 'synth' searches a schedule of edge "
                        "and grouped-mean phases against the priced fabric "
                        "(the registry's plan when not beaten); a name "
                        "forces it (overriding --graph_type), with a "
                        "warning below --gap_floor")
    p.add_argument("--synth_seed", default=None, type=int,
                   help="schedule-synthesizer seed, default 0")
    p.add_argument("--synth_budget", default=None, type=int,
                   help="synthesizer candidate evaluations (default 1200)")
    p.add_argument("--synth_beam", default=None, type=int,
                   help="synthesizer beam width (default 6)")
    p.add_argument("--synth_phases", default=None, type=int,
                   help="longest synthesized cycle, in phases (default 6)")
    p.add_argument("--gap_floor", default=0.01, type=float,
                   help="least acceptable rotation-cycle spectral gap")
    p.add_argument("--slice_size", default=None, type=int,
                   help="ranks per slice (contiguous blocks): the planner "
                        "prices edges inside a slice per hop and across "
                        "slices at --dcn_cost, and a hierarchical plan "
                        "takes this decomposition; unset = uniform fabric")
    p.add_argument("--dcn_cost", default=None, type=float,
                   help="relative per-byte cost of a cross-slice message "
                        "(a hop inside a slice = 1.0; default 16 with any "
                        "fabric flag)")
    p.add_argument("--ici_cost", default=None, type=float,
                   help="relative per-byte cost of one hop inside a slice "
                        "(default 1.0)")
    p.add_argument("--mixing_alpha", default=None, type=str,
                   help="SelfWeightedMixing self-mass: 'auto' co-optimizes "
                        "it against the chosen topology, a float in (0,1) "
                        "forces it; unset = uniform mixing")


def synth_plan_config(args) -> dict | None:
    """The synthesizer's knob dict (None unless ``--topology synth``);
    stray ``--synth_*`` knobs on another topology are refused."""
    knobs_set = any(v is not None for v in (
        args.synth_seed, args.synth_budget, args.synth_beam,
        args.synth_phases))
    if args.topology != "synth":
        if knobs_set:
            raise SystemExit(
                "--synth_seed/--synth_budget/--synth_beam/"
                "--synth_phases tune the schedule synthesizer; they "
                "need --topology synth")
        return None
    return {"seed": args.synth_seed, "budget": args.synth_budget,
            "beam_width": args.synth_beam,
            "max_phases": args.synth_phases}


def parse_mixing_alpha(v):
    """``--mixing_alpha``: None, ``"auto"`` or a float in (0, 1)."""
    if v is None or v == "auto":
        return v
    try:
        alpha = float(v)
    except ValueError:
        raise SystemExit(f"--mixing_alpha must be 'auto' or a float in "
                         f"(0, 1), got {v!r}")
    if not 0.0 < alpha < 1.0:
        raise SystemExit(f"--mixing_alpha {alpha} outside (0, 1)")
    return alpha


def plan_topology(args, world: int, ppi: int, graph_class, push_sum: bool,
                  overlap: bool, log):
    """The launch-time plan of a gossip run (``planner.resolve_topology``
    on the CLI's flags), logged as the ``gossip plan:`` line."""
    from ..parallel.wire import wire_stamp
    from ..planner import make_interconnect, resolve_topology

    return resolve_topology(
        world, ppi=ppi, topology=args.topology, graph_class=graph_class,
        floor=args.gap_floor, algorithm="sgp" if push_sum else "dpsgd",
        self_weighted=(True if args.mixing_alpha == "auto"
                       else (args.mixing_alpha or False)),
        global_avg_every=args.global_avg_every,   # None: the plan decides
        interconnect=make_interconnect(args.slice_size, args.dcn_cost,
                                       args.ici_cost),
        overlap=overlap, faults=bool(args.inject_faults),
        wire=wire_stamp(args.wire_dtype, args.wire_block,
                        _str_bool(args.error_feedback)),
        synth=synth_plan_config(args),
        log=log)


def _resolve_plan(cfg, args, world: int, log) -> None:
    """Apply the launch-time topology plan to ``cfg`` (the reference's
    ``_resolve_plan``): the graph (a hierarchical plan binds its slice
    decomposition, a synthesized one its spec), the mixing, the
    averaging period and the ``plan`` stamp."""
    fabric_flags = (args.slice_size is not None
                    or args.dcn_cost is not None
                    or args.ici_cost is not None)
    synth = synth_plan_config(args)
    if cfg.all_reduce or cfg.bilat or world < 2:
        if args.topology in ("auto", "synth") \
                or args.mixing_alpha is not None or fabric_flags \
                or synth is not None:
            raise SystemExit("--topology auto/synth / --mixing_alpha / "
                             "fabric flags (--slice_size/--dcn_cost/"
                             "--ici_cost) plan gossip schedules; they do "
                             "not apply to all_reduce/bilateral modes or "
                             "a single-rank world")
        return
    from ..train.lr import ppi_at_epoch

    # planned for the epoch-0 peers_per_itr
    plan = plan_topology(args, world, ppi_at_epoch(cfg.ppi_schedule, 0),
                         cfg.graph_class, cfg.push_sum, cfg.overlap, log)
    cfg.graph_class = plan.graph_class
    if plan.alpha is not None:
        from ..topology import SelfWeightedMixing

        cfg.mixing_class = lambda a=plan.alpha: SelfWeightedMixing(a)
    cfg.global_avg_every = plan.global_avg_every
    cfg.plan = plan.to_dict()


def build_parser() -> argparse.ArgumentParser:
    from ..ops.gossip_kernel import GOSSIP_KERNELS
    from ..topology import MIXING_STRATEGIES

    p = argparse.ArgumentParser(description="Gossip SGD on a GPU (PyTorch)")
    p.add_argument("--all_reduce", default="False", type=str)
    p.add_argument("--batch_size", default=32, type=int,
                   help="per-rank batch size")
    p.add_argument("--lr", default=0.1, type=float,
                   help="reference lr for a 256-sample global batch")
    p.add_argument("--num_dataloader_workers", default=8, type=int,
                   help="reported in the CSV header (synthetic data "
                        "ignores it)")
    p.add_argument("--num_epochs", default=90, type=int)
    p.add_argument("--num_iterations_per_training_epoch", default=None,
                   type=int, help="early exit for testing")
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--nesterov", default="False", type=str)
    p.add_argument("--push_sum", default="True", type=str,
                   help="False: D-PSGD (doubly-stochastic gossip)")
    p.add_argument("--graph_type", default=5, type=int,
                   choices=[0, 1, 2, 3, 4, 5, 6, -1],
                   help="0-5 the flat graphs, 6 the hierarchical graph, "
                        "-1 none (--all_reduce)")
    add_planner_flags(p)
    p.add_argument("--global_avg_every", default=None, type=int,
                   help="exact global average every k steps; unset = the "
                        "planner decides (on below the gap floor), 0 = "
                        "off, k = every k steps")
    p.add_argument("--mixing_strategy", default=0, type=int,
                   choices=list(MIXING_STRATEGIES))
    p.add_argument("--schedule", nargs="+",
                   default=[30, 0.1, 60, 0.1, 80, 0.1], type=float,
                   help="lr schedule as epoch value pairs")
    p.add_argument("--peers_per_itr_schedule", nargs="+", type=int,
                   default=None)
    p.add_argument("--overlap", default="False", type=str)
    p.add_argument("--synch_freq", default=0, type=int,
                   help="overlap staleness bound: a share is consumed "
                        "synch_freq+1 steps after launch")
    p.add_argument("--staleness", default=0, type=int,
                   help="overlap in-flight FIFO depth (0 = derive from "
                        "--synch_freq)")
    p.add_argument("--gossip_every", default=1, type=int,
                   help="gossip on every k-th step only (push-sum)")
    p.add_argument("--cosine_lr", default="False", type=str)
    p.add_argument("--label_smoothing", default=0.0, type=float)
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--wire_dtype", default=None,
                   choices=[None, "f32", "bf16", "int8"],
                   help="gossip wire codec; the push-sum weight lane "
                        "always ships exact f32")
    p.add_argument("--wire_block", default=64, type=int,
                   help="int8 codec block size")
    p.add_argument("--error_feedback", default="False", type=str,
                   help="carry per-rank error-feedback residuals: each "
                        "round's quantization error is re-injected into "
                        "the next send (needs a lossy --wire_dtype)")
    p.add_argument("--inject_faults", default=None, type=str,
                   help="deterministic fault injection at the gossip "
                        "round (resilience/faults.py grammar, e.g. "
                        "'drop:0->1@10:40;straggler:3@20:30;seed:7'); "
                        "mass-conserving drops, push-sum only")
    p.add_argument("--health_every", default=0, type=int,
                   help="emit a 'gossip health:' line every k steps; "
                        "excursions arm the recovery policy; 0 disables")
    p.add_argument("--residual_floor", default=0.01, type=float,
                   help="consensus residual above which recovery fires "
                        "an exact global average (with --health_every)")
    p.add_argument("--gossip_kernel", default="xla",
                   choices=list(GOSSIP_KERNELS),
                   help="'pallas' runs the gossip payload through the CUDA "
                        "start/wait kernels on the stacked lane, 'auto' "
                        "picks them on a CUDA device, 'xla' (default) is "
                        "the plain transport")
    p.add_argument("--gossip_buckets", default=1, type=int,
                   help="kernel-lane transport buckets per round")
    p.add_argument("--warmup", default="False", type=str)
    p.add_argument("--seed", default=47, type=int)
    p.add_argument("--resume", default="False", type=str)
    p.add_argument("--backend", default="xla",
                   choices=["xla", "nccl", "gloo", "mpi"],
                   help="accepted for compatibility; unused")
    p.add_argument("--tag", default="", type=str)
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--verbose", default="True", type=str)
    p.add_argument("--train_fast", default="False", type=str)
    p.add_argument("--overwrite_checkpoints", default="True", type=str)
    p.add_argument("--master_port", default="40100", type=str,
                   help="accepted for compatibility; unused")
    p.add_argument("--checkpoint_dir", type=str, default="./checkpoints")
    p.add_argument("--network_interface_type", default="infiniband",
                   choices=["infiniband", "ethernet"],
                   help="accepted for compatibility; unused")
    p.add_argument("--num_itr_ignore", type=int, default=10)
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--no_cuda_streams", action="store_true",
                   help="accepted for compatibility; unused")
    p.add_argument("--world_size", default=None, type=int,
                   help="gossip ranks, all held in this process (default 1)")
    p.add_argument("--model", default="resnet50", type=str,
                   help=f"one of {', '.join(MODELS)}")
    p.add_argument("--dataset", default="imagefolder",
                   choices=["imagefolder", "synthetic"],
                   help="only synthetic is ported")
    p.add_argument("--image_size", default=224, type=int)
    p.add_argument("--num_classes", default=1000, type=int)
    p.add_argument("--synthetic_samples", default=None, type=int)
    p.add_argument("--requeue_command", default=None, type=str,
                   help="command run on preemption requeue")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="compute dtype (params and BN stats stay fp32)")
    p.add_argument("--per_rank_csv", default="False", type=str,
                   help="one CSV per gossip rank instead of a single "
                        "rank-averaged file")
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
            changed = value not in (default,) + _ALSO_OFF.get(flag, ())
        if changed:
            raise SystemExit(
                f"{flag} {value}: {feature} is not ported to "
                f"stochastic_gradient_push_torch yet (a later slice; "
                f"ROADMAP.md Queue 1)")
    if args.dataset == "imagefolder":
        raise SystemExit(
            "--dataset imagefolder: ImageFolder data (a directory of JPEG "
            "files and their decoding) is not ported to stochastic_"
            "gradient_push_torch yet; use --dataset synthetic")
    if args.model not in MODELS:
        raise SystemExit(f"unknown model {args.model}; one of {MODELS}")


def _parse_pair_schedule(flat, value_type=float) -> dict:
    """epoch/value flat list -> dict."""
    if len(flat) % 2:
        raise SystemExit(
            f"schedule {flat} must be epoch/value pairs (even length)")
    out = {}
    it = iter(flat)
    for epoch in it:
        out[int(epoch)] = value_type(next(it))
    return out


def resolve_staleness_flag(args, overlap: bool) -> None:
    """Validate ``--staleness`` in place: non-negative, consistent with
    ``--synch_freq`` (staleness = synch_freq + 1), overlap-only."""
    if args.staleness < 0:
        raise SystemExit("--staleness must be >= 0 (0 = derive from "
                         "--synch_freq)")
    if args.staleness and args.synch_freq \
            and args.staleness != args.synch_freq + 1:
        raise SystemExit(
            f"--staleness {args.staleness} conflicts with --synch_freq "
            f"{args.synch_freq} (staleness = synch_freq + 1); set one of "
            "the two")
    if args.staleness > 1 and not overlap:
        raise SystemExit("--staleness is an overlap-mode knob")


def parse_config(argv=None):
    """``(TrainerConfig, args)`` from a command line, validated as the
    reference validates it."""
    from ..topology import GRAPH_TOPOLOGIES, MIXING_STRATEGIES, TOPOLOGY_NAMES
    from ..train.loop import TrainerConfig

    args = build_parser().parse_args(argv)
    refuse_unported(args)
    lr_schedule = _parse_pair_schedule(args.schedule, float)
    ppi_schedule = _parse_pair_schedule(
        args.peers_per_itr_schedule or [0, 1], int)
    if 0 not in ppi_schedule:
        raise SystemExit("peers_per_itr_schedule must include epoch 0")
    all_reduce = _str_bool(args.all_reduce)
    if args.wire_block < 1:
        raise SystemExit("--wire_block must be >= 1")
    ef = _str_bool(args.error_feedback)
    if ef and args.wire_dtype not in ("bf16", "int8"):
        raise SystemExit(
            "--error_feedback needs a lossy --wire_dtype (bf16/int8): "
            "an exact wire has no quantization error to feed back")
    if args.gossip_buckets < 1:
        raise SystemExit("--gossip_buckets must be >= 1, got "
                         f"{args.gossip_buckets}")
    resolve_staleness_flag(args, _str_bool(args.overlap))
    if (all_reduce or not _str_bool(args.push_sum)) and (
            args.gossip_every != 1 or args.wire_dtype not in (None, "f32")
            or ef):
        raise SystemExit("gossip_every/wire_dtype/error_feedback are "
                         "push-sum knobs")
    if all_reduce and args.graph_type != -1:
        raise SystemExit("--all_reduce True requires --graph_type -1")
    if all_reduce and args.topology is not None:
        raise SystemExit("--topology selects a gossip graph; it does not "
                         "apply to --all_reduce True")
    if not all_reduce and args.topology is None and args.graph_type == -1:
        raise SystemExit("gossip training requires a graph_type >= 0 "
                         "(or --topology)")
    args.mixing_alpha = parse_mixing_alpha(args.mixing_alpha)
    if args.mixing_alpha is not None and (
            all_reduce or not _str_bool(args.push_sum)):
        raise SystemExit("--mixing_alpha needs push-sum gossip: AllReduce "
                         "doesn't mix, and D-PSGD requires a regular "
                         "(doubly-stochastic) schedule")
    if args.inject_faults:
        if all_reduce or not _str_bool(args.push_sum):
            raise SystemExit("--inject_faults needs push-sum gossip: only "
                             "push-sum's mass accounting keeps the mean "
                             "exact under dropped edges")
        # fail a bad spec at parse time, not at the first step
        from ..resilience import parse_fault_spec

        parse_fault_spec(args.inject_faults)
    if args.health_every < 0:
        raise SystemExit("--health_every must be >= 0")
    # a forced name overrides the integer registry; "auto" and "synth"
    # are planned once the world is known (_resolve_plan)
    graph_class = GRAPH_TOPOLOGIES[args.graph_type]
    if args.topology not in (None, "auto"):
        graph_class = TOPOLOGY_NAMES[args.topology]
    cfg = TrainerConfig(
        all_reduce=all_reduce,
        push_sum=_str_bool(args.push_sum),
        overlap=_str_bool(args.overlap),
        synch_freq=args.synch_freq,
        staleness=args.staleness,
        graph_class=graph_class,
        mixing_class=MIXING_STRATEGIES[args.mixing_strategy],
        ppi_schedule=ppi_schedule,
        lr=args.lr,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        nesterov=_str_bool(args.nesterov),
        lr_schedule=lr_schedule,
        warmup=_str_bool(args.warmup),
        batch_size=args.batch_size,
        num_epochs=args.num_epochs,
        num_iterations_per_training_epoch=(
            args.num_iterations_per_training_epoch),
        seed=args.seed,
        num_itr_ignore=args.num_itr_ignore,
        print_freq=args.print_freq,
        train_fast=_str_bool(args.train_fast),
        verbose=_str_bool(args.verbose),
        checkpoint_dir=args.checkpoint_dir,
        tag=args.tag,
        resume=_str_bool(args.resume),
        overwrite_checkpoints=_str_bool(args.overwrite_checkpoints),
        num_classes=args.num_classes,
        num_dataloader_workers=args.num_dataloader_workers,
        gossip_every=args.gossip_every,
        cosine_lr=_str_bool(args.cosine_lr),
        label_smoothing=args.label_smoothing,
        grad_accum=args.grad_accum,
        wire_dtype=args.wire_dtype,
        wire_block=args.wire_block,
        gossip_kernel=args.gossip_kernel,
        gossip_buckets=args.gossip_buckets,
        per_rank_csv=_str_bool(args.per_rank_csv),
        global_avg_every=args.global_avg_every or 0,
        error_feedback=ef,
        inject_faults=args.inject_faults,
        health_every=args.health_every,
        residual_floor=args.residual_floor,
    )
    return cfg, args


def _default_requeue() -> str | None:
    if os.environ.get("SGP_SUPERVISED") == "1":
        # a run supervisor owns the relaunch decision
        return None
    job_id = os.environ.get("SLURM_JOB_ID")
    return f"scontrol requeue {job_id}" if job_id else None


def _make_model(args, num_classes: int):
    import torch

    from ..train.step import make_model

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.model == "tiny_mlp":
        if args.precision != "fp32":
            raise SystemExit("--precision bf16: tiny_mlp computes in fp32 "
                             "only")
        return make_model("tiny_mlp", num_classes=num_classes,
                          in_features=3 * args.image_size ** 2)
    return make_model(args.model, num_classes=num_classes, dtype=dtype)


def build(argv=None, config_transform=None) -> types.SimpleNamespace:
    """Everything a run needs, from a command line: ``cfg``, ``args``,
    the ``trainer`` (its cluster manager has installed the SIGUSR1 and
    SIGTERM handlers), ``loader``, ``sampler`` and ``val_loader``.
    ``config_transform(cfg, args)`` may rewrite the config first."""
    cfg, args = parse_config(argv)
    if config_transform is not None:
        cfg = config_transform(cfg, args)

    from ..data.pipeline import DistributedSampler, ShardedLoader
    from ..data.synthetic import synthetic_classification
    from ..device import resolve_device
    from ..ops.gossip_kernel import KernelBackendError
    from ..parallel.collectives import StackedTransport
    from ..train.loop import Trainer
    from ..utils.checkpoint import CheckpointManager, ClusterManager
    from ..utils.logging import make_logger

    log = make_logger("main", cfg.verbose)
    world = args.world_size or 1
    # planning is numpy only: its line and warnings come before any
    # device work, as in the reference
    _resolve_plan(cfg, args, world, log)
    device = resolve_device(args.device)
    model = _make_model(args, cfg.num_classes)

    n = args.synthetic_samples or world * cfg.batch_size * 8
    n_val = max(world * cfg.batch_size, n // 8)
    # one draw, then split: train and val share class structure
    images, labels = synthetic_classification(
        n + n_val, num_classes=cfg.num_classes, image_size=args.image_size,
        seed=cfg.seed)
    sampler = DistributedSampler(n, world)
    loader = ShardedLoader(images[:n], labels[:n], cfg.batch_size, sampler)
    val_loader = ShardedLoader(images[n:], labels[n:], cfg.batch_size,
                               DistributedSampler(n_val, world))

    ckpt = CheckpointManager(cfg.checkpoint_dir, tag=cfg.tag,
                             world_size=world, ranks=range(world))
    cluster = ClusterManager(ckpt, rank=0, requeue_command=(
        args.requeue_command or _default_requeue()))
    try:
        trainer = Trainer(cfg, model, StackedTransport(world),
                          cluster_manager=cluster, device=device)
    except KernelBackendError as e:
        raise KernelBackendError(f"--gossip_kernel {cfg.gossip_kernel}: "
                                 f"{e}") from None
    alg = trainer.make_algorithm(cfg.ppi_schedule[0])
    lane = getattr(alg, "transport_kernel_name", None)
    log.info(f"world {world} stacked on {device}; {args.model}, "
             f"{args.image_size} px, {cfg.num_classes} classes, batch "
             f"{cfg.batch_size}/rank; algorithm {alg.name}"
             + (f", gossip lane {lane}" if lane else ""))
    return types.SimpleNamespace(cfg=cfg, args=args, trainer=trainer,
                                 loader=loader, sampler=sampler,
                                 val_loader=val_loader, log=log)


def main(argv=None, config_transform=None) -> dict:
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGUSR1, signal.SIGTERM)}
    try:
        run = build(argv, config_transform)
        state = run.trainer.init_state()
        state, result = run.trainer.fit(state, run.loader, run.sampler,
                                        run.val_loader)
    finally:
        # a library caller gets its own handlers back
        for s, h in handlers.items():
            signal.signal(s, h)
    run.log.info(f"done: {result['best_prec1']:.3f} best top-1, "
                 f"elapsed {result['elapsed_time']:.1f}s")
    return result


if __name__ == "__main__":
    main()
