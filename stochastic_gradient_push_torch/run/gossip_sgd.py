"""Gossip SGD CLI — decentralized data-parallel image classification on
the GPU.

Port of ``stochastic_gradient_push_tpu/run/gossip_sgd.py``
(``build_parser``, ``parse_config``, ``main``): the reference's flag
surface with its names, string-encoded booleans, integer-coded graph and
mixing registries and flat-list schedules, driving the port's
``train/loop.py::Trainer``.  Run directly, every rank of
``--world_size`` (default 1) lives in this process, stacked on one
device; under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment),
SLURM or OpenMPI, or launched with the reference's flags (``--multihost
True --coordinator_address host:port --num_processes N --process_id
i``, ``parallel/discovery.py``), each process holds one rank
(``parallel/multihost.py``) on ``cuda:{LOCAL_RANK % cards}``, over the
group ``--backend`` names (``xla``, the default: NCCL, or gloo where
ranks share a card or on the CPU), and rank 0 writes the CSV with every
rank's metrics; each process writes its rank's checkpoint file, the
stacked lane's file for that rank.  The five algorithms come
from ``--all_reduce``, ``--push_sum``, ``--overlap`` with ``--staleness``
or ``--synch_freq``, and (``run/gossip_sgd_adpsgd.py``) bilateral
AD-PSGD.  ``--gossip_kernel pallas`` moves SGP, OSGP and D-PSGD rounds
through the CUDA gossip kernels (``ops/gossip_kernel.py``; under
``torchrun`` the cross-process K2 writes into the peers' landing blocks,
mapped by CUDA IPC); ``auto`` picks them on a CUDA device; ``pallas``
off the card raises ``KernelBackendError``.

Example (CPU, the kernels' plain twins)::

    python -m stochastic_gradient_push_torch.run.gossip_sgd --device cpu \\
      --dataset synthetic --model tiny_cnn --image_size 16 \\
      --num_classes 10 --batch_size 8 --world_size 4 --num_epochs 2 \\
      --num_iterations_per_training_epoch 5 --checkpoint_dir /tmp/ckpt/

``--nprocs_per_node L`` groups the devices into nodes of L (the
reference's deployment knob, ``parallel/mesh.py``): gradients, BatchNorm
statistics and metrics are averaged exactly over a node's L batch rows,
and the gossip (and the planner) runs between the ``world // L`` nodes.
``--world_size`` counts devices, so the LR schedule, the CSV's
``World-Size`` and the file names' ``_n{world}`` do, while the rank
files and per-rank CSVs are one per node: ``--world_size 8
--nprocs_per_node 2`` writes ``out_r{0..3}_n8.csv`` and
``checkpoint_r{0..3}_n8.ckpt``.  Under ``torchrun`` a process holds one
node (the reference's rule that a gossip rank's devices share a
process): the world is processes × L devices, process ``p`` feeds batch
rows ``[p·L, (p+1)·L)``, and ``--world_size``, when given, must equal
that product.

It runs on CUDA unless ``--device cpu``.  The rank-averaged CSV
``{tag}out_r0_n{world}.csv`` (one per rank with ``--per_rank_csv True``)
and one checkpoint per rank, ``{tag}checkpoint_r{rank}_n{world}.ckpt``,
land in ``--checkpoint_dir``; ``--resume True`` continues from them, and
from a set of another world size, resharded to this one first (the
push-sum consensus, ``supervise/reshard.py``; refused by name under
``--nprocs_per_node`` > 1).  ``--ckpt_backend orbax`` saves through
``torch.distributed.checkpoint`` instead (``utils/dcp_ckpt.py``): one
root ``{tag}dcp_r0_n{world}`` of step directories, written in the
background, the last 3 kept and the best apart; under ``torchrun`` one
shared ``{tag}dcp_global_n{world}`` that each process writes its rank's
rows of.  SIGUSR1 or SIGTERM makes the run save at the next step and
exit 75.

``--model`` is one of ``resnet18/34/50/101/152``, ``tiny_cnn`` and
``tiny_mlp``.  ``--dataset imagefolder`` (the default) streams
``--dataset_dir``'s ``train`` and ``val`` splits (``root/split/class/
*.jpg``) through ``data/streaming.py``: ``--num_dataloader_workers``
PIL decode threads (``--data_backend auto`` and ``pil`` both mean PIL;
``native``, the reference's libjpeg decoder, is not ported and is
refused by name), ``--data_output uint8`` ships raw pixels that the step
normalises on the card, and ``--prefetch True`` uploads the next batch
from pinned memory on a side stream while the step runs
(``data/prefetch.py``; one process only: under torchrun, or with
``--scan_steps`` > 1, it warns and goes on without).  ``--scan_steps K``
runs the steps in chunks of ``K`` after the warm-up: a chunk's batches
go to the card in one copy, its steps run back to back and its metrics
are read once (``train/loop.py``; the CSV rows are those of single
steps).  ``--stem_s2d True`` gives a ResNet the space-to-depth stem
(``models/resnet.py``).  ``--dataset synthetic`` draws seeded images.
``--heartbeat_timeout`` arms the step watchdog (0: off),
``--profile_dir`` (with ``--profile_start_step``/``--profile_steps``)
writes a ``torch.profiler`` Chrome trace of a window of steps, and
``--checkpoint_all False`` keeps rank 0's checkpoint alone (every rank
resumes from it; one process only).
``--wire_dtype int8 --error_feedback True`` carries error feedback,
``--inject_faults SPEC`` drills deterministic faults into the rounds,
``--health_every k`` prints ``gossip health:`` lines and
``--residual_floor`` arms the reactive global average (``gossip
recovery:`` lines).  ``--trace_dir DIR`` writes the run's telemetry
there (``telemetry/``): ``events.jsonl`` (the plan, ``run_meta`` with
the comm model, health, recovery and ``comm`` events; ``step_stats``
every ``--metrics_every`` steps) and ``trace.json`` (host spans); the
telemetry is made before the plan, so the plan's event lands in the same
file, and the ``gossip plan/health/recovery:`` lines print as without
it.  Under ``torchrun`` each process writes its own ``_rN`` files.

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
the reference accepts and ignores (``--master_port``: the launcher's
``MASTER_PORT`` rules; ``--network_interface_type``,
``--no_cuda_streams``) are accepted and ignored here too.  Every other flag whose feature is not ported parses
with its default and is refused, by name, when given another value
(:data:`UNPORTED`); none is silently ignored.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import types

__all__ = ["build_parser", "parse_config", "build", "main", "UNPORTED"]

# flag -> (reference default, type, what it belongs to): parsed so a
# reference command line is accepted, refused when not at its default
UNPORTED = {
    "--fleet": ("False", str, "fleet supervision"),
    "--host_id": (None, int, "fleet supervision"),
}
MODELS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
          "tiny_cnn", "tiny_mlp")


def _str_bool(v) -> bool:
    return str(v) == "True"


def add_multihost_flags(p: argparse.ArgumentParser) -> None:
    """The reference's flag form of a multi-host launch, shared by both
    CLIs (``parallel/discovery.py::discover`` reads them)."""
    from ..parallel.discovery import MULTIHOST_CHOICES

    p.add_argument("--multihost", default="auto",
                   choices=list(MULTIHOST_CHOICES),
                   help="join a group of processes; 'auto' joins when "
                        "SLURM, OpenMPI, torchrun or a coordinator's "
                        "variables say so, 'False' runs one process "
                        "(torchrun's variables still hold)")
    p.add_argument("--coordinator_address", default=None, type=str,
                   help="host:port of process 0 (the rendezvous)")
    p.add_argument("--num_processes", default=None, type=int)
    p.add_argument("--process_id", default=None, type=int)


def resolve_wire_alias(args) -> None:
    """Fold the deprecated ``--gossip_comm_dtype`` into ``--wire_dtype``
    in place, with the reference's warning and refusal
    (``resolve_wire_flags``, ``run/gossip_sgd.py:65-79`` there)."""
    if args.gossip_comm_dtype:
        if args.wire_dtype not in (None, "bf16"):
            raise SystemExit(
                "--gossip_comm_dtype is a deprecated alias for "
                "--wire_dtype bf16 and conflicts with "
                f"--wire_dtype {args.wire_dtype}")
        print("warning: --gossip_comm_dtype is deprecated; use "
              "--wire_dtype bf16", file=sys.stderr)
        args.wire_dtype = "bf16"
        args.gossip_comm_dtype = None


def discover_launch(args):
    """This process's :class:`~..parallel.discovery.ClusterInfo` from the
    multi-host flags and the launcher's variables; a flag set that does
    not fit exits naming the flag."""
    from ..parallel.discovery import discover

    try:
        return discover(flags=args)
    except ValueError as e:
        raise SystemExit(str(e)) from None


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
                  overlap: bool, log, registry=None):
    """The launch-time plan of a gossip run (``planner.resolve_topology``
    on the CLI's flags), logged as the ``gossip plan:`` line (through
    ``registry``'s compatibility sink when telemetry is on)."""
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
        log=log, registry=registry)


def _resolve_plan(cfg, args, world: int, log, registry=None) -> None:
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
                         cfg.graph_class, cfg.push_sum, cfg.overlap, log,
                         registry)
    cfg.graph_class = plan.graph_class
    if plan.alpha is not None:
        from ..topology import SelfWeightedMixing

        cfg.mixing_class = lambda a=plan.alpha: SelfWeightedMixing(a)
    cfg.global_avg_every = plan.global_avg_every
    cfg.plan = plan.to_dict()


def add_profile_flags(p: argparse.ArgumentParser) -> None:
    """The profiling window's flags, with the reference's names and
    defaults (``utils/profiling.py::ProfileWindow``)."""
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler Chrome trace (CPU and CUDA "
                        "activities) of global steps [--profile_start_step, "
                        "+--profile_steps) into this directory")
    p.add_argument("--profile_start_step", default=None, type=int,
                   help="first global step of the window (default 2: past "
                        "the kernel builds and autotuning)")
    p.add_argument("--profile_steps", default=None, type=int,
                   help="steps in the window (default 3)")


def resolve_profile_flags(args) -> None:
    """Validate and default the profiling flags in place: window knobs
    without a destination are a mistake."""
    knobs_set = (args.profile_start_step is not None
                 or args.profile_steps is not None)
    if knobs_set and not args.profile_dir:
        raise SystemExit("--profile_start_step/--profile_steps shape "
                         "the capture window; they need --profile_dir")
    if args.profile_start_step is None:
        args.profile_start_step = 2
    if args.profile_steps is None:
        args.profile_steps = 3
    if args.profile_start_step < 0:
        raise SystemExit("--profile_start_step must be >= 0")
    if args.profile_steps < 1:
        raise SystemExit("--profile_steps must be >= 1")


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
                   help="decode threads of the imagefolder streaming "
                        "loader (synthetic data ignores it)")
    p.add_argument("--prefetch", default="False", type=str,
                   help="upload the next batch (pinned memory, a side "
                        "stream) while the step runs (data/prefetch.py; "
                        "one process only)")
    p.add_argument("--stem_s2d", default="False",
                   help="the ResNet's space-to-depth stem: the 7x7/2 "
                        "stem's function as a 4x4/1 convolution over 2x2-"
                        "packed input (models/resnet.py; even image "
                        "sizes)")
    p.add_argument("--scan_steps", default=1, type=int,
                   help="run this many steps back to back, the batches "
                        "sent to the card in one copy and the metrics "
                        "read once (train/loop.py; chunks of this size "
                        "after the warm-up)")
    p.add_argument("--data_backend", default="auto",
                   choices=["auto", "native", "pil"],
                   help="imagefolder decoding: auto and pil decode with "
                        "PIL; native (the reference's libjpeg decoder) is "
                        "not ported")
    p.add_argument("--data_output", default="f32", choices=["f32", "uint8"],
                   help="loader output: host-normalised float32, or raw "
                        "uint8 pixels normalised on the card (a 4x smaller "
                        "host-to-device copy)")
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
    p.add_argument("--gossip_comm_dtype", default=None,
                   choices=[None, "bf16"],
                   help="DEPRECATED alias for --wire_dtype bf16")
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
                   help="the torch.distributed backend under torchrun: "
                        "xla = nccl on the card (gloo where ranks share "
                        "one, and on the CPU)")
    add_multihost_flags(p)
    p.add_argument("--tag", default="", type=str)
    p.add_argument("--print_freq", default=10, type=int)
    p.add_argument("--verbose", default="True", type=str)
    p.add_argument("--train_fast", default="False", type=str)
    p.add_argument("--checkpoint_all", default="True", type=str,
                   help="False: rank 0's checkpoint alone, every rank "
                        "resumes from it (one process only)")
    p.add_argument("--overwrite_checkpoints", default="True", type=str)
    p.add_argument("--ckpt_backend", default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="msgpack (the reference's name): one torch.save "
                        "file a rank; orbax: torch.distributed.checkpoint "
                        "(utils/dcp_ckpt.py), asynchronous saves in one "
                        "process, the last 3 kept, one shared checkpoint "
                        "under torchrun")
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
                   help="devices, all held in this process (default 1); "
                        "under torchrun, when given, the launcher's "
                        "processes x --nprocs_per_node")
    p.add_argument("--nprocs_per_node", default=1, type=int,
                   help="devices per node: gradients, BatchNorm statistics "
                        "and metrics averaged exactly over a node's rows, "
                        "the gossip between nodes (under torchrun a process "
                        "holds one node)")
    p.add_argument("--model", default="resnet50", type=str,
                   help=f"one of {', '.join(MODELS)}")
    p.add_argument("--dataset", default="imagefolder",
                   choices=["imagefolder", "synthetic"],
                   help="imagefolder streams --dataset_dir's train and val "
                        "splits; synthetic draws seeded images")
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
    p.add_argument("--heartbeat_timeout", default=300, type=int,
                   help="seconds a blocking step may take before the "
                        "watchdog logs a stall (0 disables it)")
    p.add_argument("--trace_dir", default=None, type=str,
                   help="run telemetry directory (telemetry/): writes "
                        "trace.json (Chrome-trace host spans: data "
                        "fetch, step, checkpoint, eval, recovery "
                        "averages) and events.jsonl (typed "
                        "plan/health/recovery/comm events, one "
                        "versioned schema).  Unset = telemetry off")
    p.add_argument("--metrics_every", default=0, type=int,
                   help="emit a step_stats + comm telemetry event "
                        "every k steps (0 = only the final comm "
                        "snapshot); requires --trace_dir")
    add_profile_flags(p)
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
    if args.data_backend == "native":
        from ..data.streaming import NATIVE_REFUSAL

        raise SystemExit(f"--data_backend native: {NATIVE_REFUSAL}")
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
    resolve_wire_alias(args)
    resolve_profile_flags(args)
    if args.heartbeat_timeout < 0:
        raise SystemExit("--heartbeat_timeout must be >= 0 (0 disables)")
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
    if args.metrics_every < 0:
        raise SystemExit("--metrics_every must be >= 0")
    if args.metrics_every and not args.trace_dir:
        raise SystemExit("--metrics_every needs --trace_dir (telemetry "
                         "events have nowhere to go without it)")
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
        prefetch=_str_bool(args.prefetch),
        scan_steps=args.scan_steps,
        checkpoint_all=_str_bool(args.checkpoint_all),
        heartbeat_timeout=args.heartbeat_timeout,
        profile_dir=args.profile_dir,
        profile_start_step=args.profile_start_step,
        profile_steps=args.profile_steps,
        trace_dir=args.trace_dir,
        metrics_every=args.metrics_every,
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
    if args.model == "tiny_cnn":
        return make_model(args.model, num_classes=num_classes, dtype=dtype)
    stem_s2d = _str_bool(args.stem_s2d)
    if stem_s2d and args.image_size % 2:
        # the reference's space_to_depth refuses it at the first forward
        raise SystemExit(
            f"--stem_s2d True: stem_s2d requires spatial dims divisible by "
            f"2, got {args.image_size}x{args.image_size} — use the "
            f"standard stem for odd image sizes")
    return make_model(args.model, num_classes=num_classes, dtype=dtype,
                      stem_s2d=stem_s2d)


def _image_folders(args, cfg, world: int, held, log):
    """``(loader, sampler, val_loader)`` streaming ``--dataset_dir``'s
    ``train`` and ``val`` splits; the train loader owns ``set_epoch``
    for both the sampling and the augmentation."""
    from ..data.streaming import StreamingImageFolder

    if not args.dataset_dir:
        raise SystemExit("--dataset imagefolder: ImageFolder data needs "
                         "--dataset_dir (DIR/train/<class>/*.jpg and "
                         "DIR/val/<class>/*.jpg)")
    workers = args.num_dataloader_workers or 8
    common = dict(world_size=world, batch_size=cfg.batch_size,
                  image_size=args.image_size, num_workers=workers,
                  ranks=held, backend=args.data_backend,
                  output=args.data_output)
    loader = StreamingImageFolder(args.dataset_dir, "train", train=True,
                                  seed=cfg.seed, **common)
    val_loader = StreamingImageFolder(args.dataset_dir, "val", train=False,
                                      **common)
    log.info(f"imagefolder {args.dataset_dir}: {len(loader.dataset)} train "
             f"and {len(val_loader.dataset)} val images, "
             f"{len(loader.classes)} classes; decoding with PIL on "
             f"{workers} threads (--data_backend {args.data_backend}: the "
             f"native decoder is not ported), {args.data_output} output"
             + (", device prefetch" if cfg.prefetch else ""))
    return loader, loader, val_loader


def make_ckpt_manager(backend: str, cfg, world: int, ranks):
    """The checkpoint backend ``--ckpt_backend`` names (the reference's
    ``_make_ckpt_manager``): a ``torch.save`` file a rank, or for
    ``orbax`` the ``torch.distributed.checkpoint`` manager."""
    if backend == "orbax":
        from ..utils.dcp_ckpt import DcpCheckpointManager

        return DcpCheckpointManager(cfg.checkpoint_dir, tag=cfg.tag,
                                    rank=ranks[0], world_size=world,
                                    all_workers=cfg.checkpoint_all)
    from ..utils.checkpoint import CheckpointManager

    return CheckpointManager(cfg.checkpoint_dir, tag=cfg.tag,
                             world_size=world, ranks=ranks,
                             all_workers=cfg.checkpoint_all)


def build(argv=None, config_transform=None) -> types.SimpleNamespace:
    """Everything a run needs, from a command line: ``cfg``, ``args``,
    the ``trainer`` (its cluster manager has installed the SIGUSR1 and
    SIGTERM handlers), ``loader``, ``sampler`` and ``val_loader``.
    ``config_transform(cfg, args)`` may rewrite the config first."""
    cfg, args = parse_config(argv)
    if config_transform is not None:
        cfg = config_transform(cfg, args)

    import torch

    from ..data.pipeline import DistributedSampler, ShardedLoader
    from ..data.synthetic import synthetic_classification
    from ..device import resolve_device
    from ..ops.gossip_kernel import KernelBackendError
    from ..parallel.collectives import DistTransport, StackedTransport
    from ..parallel.mesh import make_hierarchical_layout
    from ..parallel.multihost import initialize_multihost, process_device
    from ..telemetry import make_run_telemetry
    from ..train.loop import Trainer, refuse_single_process_only
    from ..utils.checkpoint import ClusterManager
    from ..utils.logging import make_logger

    log = make_logger("main", cfg.verbose)
    info = discover_launch(args)
    spread = info.world_size > 1   # one gossip rank (node) per process
    local = args.nprocs_per_node
    if spread and args.world_size not in (None, info.world_size * local):
        raise SystemExit(f"--world_size {args.world_size} but the launcher "
                         f"started {info.world_size} processes of "
                         f"--nprocs_per_node {local} devices each "
                         f"({info.world_size * local})")
    # devices: the data and LR world; the gossip runs between its nodes
    world = info.world_size * local if spread else (args.world_size or 1)
    try:
        nodes = make_hierarchical_layout(local, world)
    except ValueError as e:
        raise SystemExit(f"--world_size {world} --nprocs_per_node {local}: "
                         f"{e}") from None
    cfg.nprocs_per_node = local
    # telemetry before planning, so the plan's event and the loop's share
    # one events.jsonl (the no-op bundle without --trace_dir)
    telemetry = make_run_telemetry(cfg.trace_dir, rank=info.rank, log=log,
                                   metrics_every=cfg.metrics_every)
    # planning is numpy only: its line and warnings come before any
    # device work, as in the reference; it sees the gossip world
    _resolve_plan(cfg, args, nodes, log, registry=telemetry.registry)
    owns_group = False
    if spread:
        try:
            refuse_single_process_only(cfg)
        except ValueError as e:
            raise SystemExit(f"--{e}") from None
        device = process_device(args.device, info)
        owns_group = not torch.distributed.is_initialized()
        try:
            initialize_multihost(args.backend, device, info)
        except ValueError as e:
            raise SystemExit(f"--backend {args.backend}: {e}") from None
        transport = DistTransport()
        ranks = [transport.rank]
    else:
        device = resolve_device(args.device)
        transport = StackedTransport(nodes)
        ranks = list(range(nodes))
    model = _make_model(args, cfg.num_classes)

    # this process's device rows of the samplers the stacked lane reads:
    # its node's
    held = (list(range(ranks[0] * local, (ranks[0] + 1) * local))
            if spread else None)
    if spread:
        log.info(f"process {ranks[0]}/{nodes}: feeding batch rows "
                 f"{held}")
    if args.dataset == "imagefolder":
        loader, sampler, val_loader = _image_folders(args, cfg, world, held,
                                                     log)
    else:
        n = args.synthetic_samples or world * cfg.batch_size * 8
        n_val = max(world * cfg.batch_size, n // 8)
        # one draw, then split: train and val share class structure
        images, labels = synthetic_classification(
            n + n_val, num_classes=cfg.num_classes,
            image_size=args.image_size, seed=cfg.seed)
        sampler = DistributedSampler(n, world)
        loader = ShardedLoader(images[:n], labels[:n], cfg.batch_size,
                               sampler, ranks=held)
        val_loader = ShardedLoader(images[n:], labels[n:], cfg.batch_size,
                                   DistributedSampler(n_val, world),
                                   ranks=held)

    ckpt = make_ckpt_manager(args.ckpt_backend, cfg, world, ranks)
    cluster = ClusterManager(ckpt, rank=ranks[0], requeue_command=(
        args.requeue_command or _default_requeue()))
    try:
        trainer = Trainer(cfg, model, transport, cluster_manager=cluster,
                          device=device, telemetry=telemetry)
    except KernelBackendError as e:
        raise KernelBackendError(f"--gossip_kernel {cfg.gossip_kernel}: "
                                 f"{e}") from None
    alg = trainer.make_algorithm(cfg.ppi_schedule[0])
    lane = getattr(alg, "transport_kernel_name", None)
    where = (f"rank {ranks[0]} of {nodes}, one a process, on "
             f"{device} ({torch.distributed.get_backend()})" if spread
             else f"world {world} stacked on {device}")
    if local > 1:
        where += (f"; {nodes} nodes x {local} devices, gossip "
                  f"between nodes")
    log.info(f"{where}; {args.model}, "
             f"{args.image_size} px, {cfg.num_classes} classes, batch "
             f"{cfg.batch_size}/rank; algorithm {alg.name}"
             + (f", gossip lane {lane}" if lane else ""))
    return types.SimpleNamespace(cfg=cfg, args=args, trainer=trainer,
                                 loader=loader, sampler=sampler,
                                 val_loader=val_loader, log=log,
                                 transport=transport, owns_group=owns_group)


def main(argv=None, config_transform=None) -> dict:
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGUSR1, signal.SIGTERM)}
    from ..parallel.multihost import leave
    from ..utils.checkpoint import REQUEUE_EXIT_CODE

    try:
        run = build(argv, config_transform)
        try:
            state = run.trainer.init_state()
            state, result = run.trainer.fit(state, run.loader, run.sampler,
                                            run.val_loader)
            # an asynchronous save lands before the run ends
            run.trainer.cluster.ckpt.close()
        except SystemExit as e:
            if e.code == REQUEUE_EXIT_CODE:
                # every process stops at the same step: leave together
                leave(run.transport, run.owns_group)
            raise
        leave(run.transport, run.owns_group)
    finally:
        # a library caller gets its own handlers back
        for s, h in handlers.items():
            signal.signal(s, h)
    run.log.info(f"done: {result['best_prec1']:.3f} best top-1, "
                 f"elapsed {result['elapsed_time']:.1f}s")
    return result


if __name__ == "__main__":
    main()
