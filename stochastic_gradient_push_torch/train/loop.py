"""The experiment loop: epochs, meters, CSV logging, validation, resume.

Port of ``TrainerConfig`` and ``Trainer`` in ``stochastic_gradient_push_
tpu/train/loop.py``, over either transport of ``parallel/collectives.py``:
one process holding every rank of the world (``StackedTransport``), or
one rank per process (``DistTransport``, under ``torchrun``), where each
process trains its own rank with a leading dim of 1, reads its rank's
rows of the same sampler, writes its rank's checkpoint file (the same
file the stacked lane writes for that rank), gathers every rank's
metrics so rank 0's CSV holds them all (``parallel/multihost.py::
to_host``), agrees on the resume point and on a preemption signal at
each step boundary, and resumes from either lane's files.  The
step is ``train/step.py::build_train_step``; the five algorithms come
from :meth:`Trainer.make_algorithm` (AllReduce, SGP, OSGP, D-PSGD,
AD-PSGD), one per peers-per-iteration value as the reference caches one
compiled step per value.

The CSVs are byte-compatible with the reference's in every column but
the timing ones: the header block (``BEGIN-TRAINING``, world size,
loader workers, batch size, the column line), a training row every
``print_freq`` iterations and one at each epoch's end, a validation row
after each epoch.  ``BT(s)``, ``NT(s)`` and ``DT(s)`` are host-clock
meters: the data window is the loader and the host-to-device copy, the
step window ends in the device-to-host read of the step's metrics, so
it times finished work.

Checkpoints (``utils/checkpoint.py``, or ``utils/dcp_ckpt.py`` for
``--ckpt_backend orbax``): one file per rank after every epoch, the
overlap FIFO drained first (the live state adopts the drained view too,
so a resumed run follows the straight one); ``resume`` reads them back,
fast-forwards the loader to the saved iteration, and the LR follows from
the restored step.  With no set of the run's world on disk, another
world's set is resharded into place first (``_try_cross_world_resume``,
``supervise/reshard.py``): the stacked lane writes every new rank's
file, under ``torchrun`` each process its own rank's, after every
process has found no file of the run's world.  The epoch, iteration and
step carry over from the old set; the LR and the sampler take the new
world.  ``nprocs_per_node`` > 1 and the DCP backend refuse another
world's set by name.  A SIGUSR1/SIGTERM is acted on at the next step
boundary: save at (epoch, itr) and exit 75.

Resilience (``resilience/``): ``inject_faults`` compiles a fault plan
against each algorithm's schedule (logged once, ``gossip faults:``),
``error_feedback`` keeps the EF residual in the gossip state (and in the
rank files), and ``health_every`` adds the health signals to the step,
observes them every step (``gossip health:`` lines) and lets the
recovery policy fire an exact global average above ``residual_floor``
(``gossip recovery:`` lines, each with the planner's re-plan
``suggestion``); a checkpoint's meta carries the last health payload.

``scan_steps`` K > 1 is the reference's chunked loop
(``train/loop.py:1021-1160`` there): after the warm-up window
(``num_itr_ignore``, single steps) the steps run in chunks of K, the
chunk's batches stacked ``[K, ...]`` on the host and sent to the device
in one copy, its K steps back to back with no host read between (each
with its own step counter, LR and gossip phase; an overlap run's
in-flight shares carry from step to step), and its metrics read once as
``[world, K]``; then each step's meters, CSV rows (a ``print_freq`` row
inside a chunk too) and health observations, with a chunk's time over
K as each step's.  A cap tail shorter than K runs as single steps, and
so do the extra batches of a loader tail.  The watchdog, the profile
window, ``bilat_async``'s publish and adoption (at the chunk's last
step) and the preemption check act on whole chunks.  On the TPU a
chunk is one compiled program; here it is K eager steps (no CUDA graph
yet), so the CSV is ``scan_steps`` 1's, bit for bit.

Around the step (``train/loop.py:968-1095`` of the reference):
``prefetch`` wraps the loader in ``data/prefetch.py::DevicePrefetcher``
(one process only, and ``scan_steps`` 1; otherwise the reference's
warning, and no prefetch);
``heartbeat_timeout`` arms ``utils/profiling.py::StepWatchdog`` around
each warm step (the step and its metrics' read; 0 disables it);
``profile_dir`` captures the global steps ``[profile_start_step,
+profile_steps)`` with ``torch.profiler`` (``ProfileWindow``, the trace
path in the result as ``profile_trace``); ``bilat_async`` trains local
SGD steps while ``train/async_bilat.py`` averages on a host thread: each
step's params are published and a ready displacement adopted, and the
staleness summary is logged and returned as ``async_bilat``.
``bilat_async`` and ``checkpoint_all=False`` (rank 0's file alone, see
``utils/checkpoint.py``) are single-process only.

``nprocs_per_node`` L > 1 makes the transport's ranks nodes of L devices:
the step averages gradients, BatchNorm statistics and metrics exactly
over a node's L batch rows (``train/step.py``'s ``local_axis``) and the
gossip runs between nodes.  The Trainer keeps the reference's two worlds:
``gossip_world``, the transport's (the graph, the recovery policy, the
per-rank metrics and CSVs, the rank files), and ``world_size`` =
``gossip_world × L``, the devices (the LR schedule, the file names'
``_n{world}``, the CSV's ``World-Size`` and the sample counts).  The
loader feeds the held nodes' ``L`` rows each.

``plan`` is the launch-time topology plan (``planner.Plan.to_dict()``,
made by the CLI): its fabric model, wire stamp and synthesis stamp reach
the recovery policy's re-plans, and every rank file's meta carries it.

Run telemetry (``telemetry/``, the reference's ``train/loop.py:510-576,
1117-1150``): with ``trace_dir`` (or a bundle the CLI made, passed as
``telemetry=``, so the plan event shares its ``events.jsonl``) the fit
writes ``events.jsonl`` — a ``run_meta`` event with the comm model of
the epoch-0 algorithm, the health and recovery events, a
``step_stats`` and a ``comm`` snapshot every ``metrics_every`` steps,
a preemption's exit record — and, in a ``finally``, ``trace.json``:
``data_fetch`` and ``train_step`` spans from the loop's own clock
readings (``train_step`` counts the gossip rounds and global averages
it ran), ``checkpoint_save``, ``validate`` and
``recovery_global_average`` spans.  Under ``torchrun`` each process
writes its own ``_rN`` files.  Telemetry reads no device value: the
step's one read stays the metrics' ``to_host``.

Config fields of features not ported yet raise ``NotImplementedError``
naming the feature when set away from their defaults (:data:`UNPORTED`);
none is silently ignored.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import typing as tp

import numpy as np
import torch

from ..algorithms import (GossipAlgorithm, adpsgd, all_reduce, dpsgd,
                          drain_state, sgp)
from ..device import resolve_device
from ..ops.gossip_kernel import resolve_gossip_kernel
from ..parallel import collectives
from ..parallel.multihost import consensus_resume_point, to_host
from ..parallel.wire import get_codec, wire_stamp
from ..topology import build_pairing_schedule, build_schedule
from ..utils.checkpoint import REQUEUE_EXIT_CODE, ClusterManager
from ..utils.logging import make_logger
from ..utils.meter import Meter
from ..utils.profiling import ProfileWindow, StepWatchdog
from .lr import CosineLRSchedule, LRSchedule, ppi_at_epoch
from .state import sgd
from .step import (build_eval_step, build_train_step, init_train_state,
                   replica_spread)

__all__ = ["TrainerConfig", "Trainer", "UNPORTED"]


@dataclasses.dataclass
class TrainerConfig:
    """Experiment configuration, the reference's fields and defaults
    (their meaning is documented there)."""

    # algorithm selection
    all_reduce: bool = False
    push_sum: bool = True
    overlap: bool = False
    synch_freq: int = 0
    staleness: int = 0
    gossip_every: int = 1
    global_avg_every: int = 0
    plan: dict | None = None
    wire_dtype: str | None = None
    wire_block: int = 64
    error_feedback: bool = False
    gossip_comm_dtype: str | None = None
    gossip_kernel: str = "xla"
    gossip_buckets: int = 1
    bilat: bool = False
    bilat_async: bool = False
    bilat_async_interval: float = 0.0
    graph_class: tp.Any = None
    mixing_class: tp.Any = None
    ppi_schedule: dict[int, int] = dataclasses.field(
        default_factory=lambda: {0: 1})

    # optimization
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False
    lr_schedule: dict[int, float] = dataclasses.field(
        default_factory=lambda: {30: 0.1, 60: 0.1, 80: 0.1})
    warmup: bool = False
    cosine_lr: bool = False
    label_smoothing: float = 0.0
    grad_accum: int = 1

    # run shape
    batch_size: int = 32
    num_epochs: int = 90
    num_iterations_per_training_epoch: int | None = None
    seed: int = 47
    num_itr_ignore: int = 10
    print_freq: int = 10
    train_fast: bool = False
    verbose: bool = True

    # io
    checkpoint_dir: str = "./checkpoints"
    trace_dir: str | None = None
    metrics_every: int = 0
    profile_dir: str | None = None
    profile_start_step: int = 2
    profile_steps: int = 3
    tag: str = ""
    resume: bool = False
    checkpoint_all: bool = True
    overwrite_checkpoints: bool = True
    fleet: bool = False
    host_id: int | None = None

    num_classes: int = 1000
    nprocs_per_node: int = 1
    scan_steps: int = 1
    num_dataloader_workers: int = 0
    prefetch: bool = False
    prefetch_depth: int = 2
    heartbeat_timeout: int = 300
    per_rank_csv: bool = False

    # resilience
    inject_faults: str | None = None
    health_every: int = 0
    residual_floor: float = 0.01


# config field -> (default, the feature it belongs to): a value away from
# the default raises, naming the feature
UNPORTED = {
    "fleet": (False, "fleet supervision"),
    "host_id": (None, "fleet supervision"),
}


def _refuse_unported(cfg: TrainerConfig, transport) -> None:
    for field, (default, feature) in UNPORTED.items():
        value = getattr(cfg, field)
        if value != default:
            raise NotImplementedError(
                f"TrainerConfig.{field}={value!r}: {feature} is not ported "
                f"to stochastic_gradient_push_torch yet (ROADMAP.md Queue 1)")
    if not isinstance(transport, (collectives.StackedTransport,
                                  collectives.DistTransport)):
        raise NotImplementedError(
            f"a {type(transport).__name__}: the trainer runs a multi-process "
            "world on collectives.DistTransport (one rank per process) and "
            "a single process on collectives.StackedTransport")
    if len(transport.ranks) < transport.world_size:
        refuse_single_process_only(cfg)


# TrainerConfig fields a run of one rank per process refuses:
# (default, why), as the reference refuses them
SINGLE_PROCESS_ONLY = {
    "bilat_async": (False, "the averaging runs on one host thread over "
                           "every rank's params (see train/async_bilat.py)"),
    "checkpoint_all": (True, "with one rank per process each process "
                             "writes its own rank's checkpoint file"),
}


def refuse_single_process_only(cfg: TrainerConfig) -> None:
    """Raise ``ValueError`` (``"<field> <value> is single-process only:
    ..."``) for the first field of ``SINGLE_PROCESS_ONLY`` ``cfg`` sets;
    the Trainer calls it for a world spread over processes, and the CLIs
    before they start the process group."""
    for field, (default, why) in SINGLE_PROCESS_ONLY.items():
        value = getattr(cfg, field)
        if value != default:
            raise ValueError(f"{field} {value} is single-process only: "
                             f"{why}")


def wire_dtype(cfg: TrainerConfig) -> str | None:
    """The wire codec's dtype: ``wire_dtype``, or ``"bf16"`` for the
    deprecated ``gossip_comm_dtype`` alias (the reference's
    ``Trainer._wire_codec``, ``train/loop.py:354-373`` there, with its
    refusals)."""
    alias = cfg.gossip_comm_dtype
    if alias is not None and alias != "bf16":
        raise ValueError(f"unknown gossip_comm_dtype {alias!r}; use 'bf16' "
                         "(or the wire_dtype knob)")
    if cfg.wire_dtype is not None:
        if alias is not None and cfg.wire_dtype != "bf16":
            raise ValueError(
                "gossip_comm_dtype is a deprecated alias for "
                "wire_dtype=bf16 and conflicts with "
                f"wire_dtype={cfg.wire_dtype!r}")
        return cfg.wire_dtype
    return alias


class Trainer:
    """Drives training of ``model`` (a meta-device module from
    ``train/step.py::make_model``) over the ranks of ``transport`` on
    ``device`` (default CUDA) with the configured algorithm."""

    def __init__(self, config: TrainerConfig, model, transport,
                 cluster_manager: ClusterManager | None = None,
                 device=None, telemetry=None):
        _refuse_unported(config, transport)
        wire_dtype(config)      # the alias's refusals, before any work
        if config.nprocs_per_node < 1:
            raise ValueError(f"nprocs_per_node must be >= 1, got "
                             f"{config.nprocs_per_node}")
        self.cfg = config
        self.model = model
        self.transport = transport
        self.device = resolve_device(device)
        # the gossip ranks (nodes), and the devices: the data and LR world
        self.gossip_world = transport.world_size
        self.world_size = transport.world_size * config.nprocs_per_node
        self.local_axis = (config.nprocs_per_node
                           if config.nprocs_per_node > 1 else None)
        # gossip ranks this process holds: all of them, or its own
        self.held = len(transport.ranks)
        self.spread = self.held < self.gossip_world
        # resolved here, so "pallas" off the card fails before any step
        self.lane = resolve_gossip_kernel(config.gossip_kernel,
                                          device=self.device)
        self.log = make_logger("trainer", config.verbose)
        # run telemetry: the CLI passes the bundle it planned with (one
        # events.jsonl); a library caller gets one from the config, or
        # the shared no-op bundle without a trace_dir.  Health and
        # recovery lines keep this logger either way.
        if telemetry is None:
            from ..telemetry import make_run_telemetry

            telemetry = make_run_telemetry(
                config.trace_dir,
                rank=transport.ranks[0] if self.spread else 0,
                log=self.log, metrics_every=config.metrics_every)
        self.telemetry = telemetry
        telemetry.route_legacy(("health", "recovery"), self.log)
        registry = telemetry.registry
        self.cluster = cluster_manager
        if cluster_manager is not None and self.spread:
            # a signal one process saw is acted on by all, at one step
            cluster_manager.agree = self._any_process
        self.tx = sgd(momentum=config.momentum,
                      weight_decay=config.weight_decay,
                      nesterov=config.nesterov)
        self.lr_schedule_obj = None  # built per fit (needs itr_per_epoch)
        self._step_cache: dict[tuple, tuple] = {}
        self._eval_fn = None
        self._eval_alg = None
        self._last_val_per_rank: list[float] = []
        # runtime consensus health: the monitor sees, the policy decides,
        # the recovery fn (cached per algorithm) acts
        self.monitor = None
        self.recovery_policy = None
        self._recovery_cache: dict = {}
        if config.health_every < 0:
            raise ValueError("health_every must be >= 0")
        if config.health_every > 0:
            from ..resilience import HealthMonitor, RecoveryPolicy

            self.monitor = HealthMonitor(
                health_every=config.health_every,
                residual_floor=config.residual_floor, log=self.log,
                registry=registry)
            if not (config.all_reduce or config.bilat
                    or config.bilat_async):
                # overlap runs recover too: the average folds the
                # in-flight FIFO into Σx/Σw and drains it
                from ..topology import topology_name

                try:
                    topo = topology_name(config.graph_class)
                except KeyError:
                    topo = None
                self.recovery_policy = RecoveryPolicy(
                    world=self.gossip_world,
                    ppi=ppi_at_epoch(config.ppi_schedule, 0),
                    algorithm="sgp" if config.push_sum else "dpsgd",
                    topology=topo,
                    residual_floor=config.residual_floor,
                    cooldown_steps=config.health_every, log=self.log,
                    registry=registry,
                    interconnect=self._plan_interconnect(),
                    faults=bool(config.inject_faults),
                    wire=wire_stamp(wire_dtype(config), config.wire_block,
                                    config.error_feedback),
                    synth=(config.plan.get("synth")
                           if config.plan else None))
        self._logged_faults = False
        # a heartbeat around each warm blocking step (the reference's
        # 300 s gossip flag timeout): a hung kernel, read or peer shows
        # up as a step that does not end
        self.watchdog = (StepWatchdog(timeout=config.heartbeat_timeout,
                                      rank=transport.ranks[0],
                                      registry=registry)
                         if config.heartbeat_timeout > 0 else None)
        # the step calls of each step variant: the first two carry the
        # builds and autotuning, and the watchdog is armed after them
        self._warm_counts: dict = {}
        self.profile = ProfileWindow(config.profile_dir,
                                     start_step=config.profile_start_step,
                                     num_steps=config.profile_steps,
                                     device=self.device,
                                     rank=transport.ranks[0])
        self._async_bilat = None  # built per fit with bilat_async
        self._warned_prefetch = False
        # rank 0's process writes the CSVs, from every rank's metrics
        self._csv_ranks = ((tuple(range(self.gossip_world))
                            if config.per_rank_csv else (0,))
                           if 0 in transport.ranks else ())
        self._fname = lambda r: os.path.join(
            config.checkpoint_dir,
            f"{config.tag}out_r{r}_n{self.world_size}.csv")

    def _on_device(self, a) -> torch.Tensor:
        """A loader's batch array (numpy, or a tensor from the
        prefetcher) on the trainer's device."""
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        return a.to(self.device)

    def _any_process(self, flag: bool) -> bool:
        """Whether ``flag`` holds in any process (a collective)."""
        x = torch.tensor([float(flag)], device=self.device)
        return bool(self.transport.allreduce_max(x)[0])

    # -- algorithm / step construction ------------------------------------

    def _plan_interconnect(self):
        """The fabric model the plan was priced on (None on a uniform
        fabric): recovery re-plans price on the same fabric."""
        if self.cfg.plan and self.cfg.plan.get("interconnect"):
            from ..planner import InterconnectModel

            return InterconnectModel.from_dict(self.cfg.plan["interconnect"])
        return None

    def _resolve_staleness(self) -> int:
        """The overlap FIFO depth from ``staleness`` or the
        ``synch_freq`` alias (staleness = synch_freq + 1)."""
        cfg = self.cfg
        if cfg.staleness and cfg.synch_freq \
                and cfg.staleness != cfg.synch_freq + 1:
            raise ValueError(
                f"staleness={cfg.staleness} conflicts with "
                f"synch_freq={cfg.synch_freq} (staleness = synch_freq "
                "+ 1); set one of the two")
        staleness = cfg.staleness or (cfg.synch_freq + 1)
        if staleness < 1:
            raise ValueError("staleness must be >= 1")
        if not cfg.overlap:
            if staleness > 1:
                self.log.warning(
                    "staleness/synch_freq is ignored without overlap "
                    "mode")
            return 1
        return staleness

    def make_algorithm(self, ppi: int) -> GossipAlgorithm:
        cfg = self.cfg
        codec = get_codec(wire_dtype(cfg), cfg.wire_block)
        bilat = cfg.bilat or cfg.bilat_async
        if codec is not None and codec.lossy \
                and (cfg.all_reduce or bilat or not cfg.push_sum):
            raise ValueError(
                "wire compression (wire_dtype / the deprecated "
                "gossip_comm_dtype) applies to the push-sum family only")
        if cfg.error_feedback and (cfg.all_reduce or bilat
                                   or not cfg.push_sum):
            raise ValueError(
                "error_feedback rides the push-sum gossip wire; "
                "all_reduce/bilateral/D-PSGD modes have none")
        if cfg.global_avg_every and (cfg.all_reduce or bilat):
            raise ValueError(
                "global_avg_every applies to the push-sum/D-PSGD gossip "
                "family (all_reduce is already exact every step)")
        if cfg.inject_faults and (cfg.all_reduce or bilat):
            raise ValueError(
                "inject_faults breaks gossip edges; all_reduce/bilateral "
                "modes have none (use push-sum gossip)")
        if cfg.all_reduce:
            return all_reduce(self.transport)
        if cfg.bilat_async:
            # no communication in the step: the bilateral averaging runs
            # on a host thread (train/async_bilat.py); local SGD here
            return GossipAlgorithm()
        graph = cfg.graph_class(self.gossip_world, peers_per_itr=ppi)
        if cfg.bilat:
            return adpsgd(build_pairing_schedule(graph), self.transport)
        mixing = cfg.mixing_class() if cfg.mixing_class else None
        schedule = build_schedule(graph, mixing)
        faults = None
        if cfg.inject_faults:
            # compiled against THIS schedule: the masks are per (phase,
            # edge), so a ppi change rebuilds them
            from ..resilience import parse_fault_spec

            plan = parse_fault_spec(cfg.inject_faults)
            faults = plan.build_masks(
                schedule,
                gossip_every=cfg.gossip_every if cfg.push_sum else 1)
            if not self._logged_faults:
                # one banner per run
                self.log.warning("gossip faults: %s", plan.summary())
                self._logged_faults = True
        staleness = self._resolve_staleness()
        if cfg.push_sum:
            return sgp(schedule, self.transport, overlap=cfg.overlap,
                       gossip_every=cfg.gossip_every, wire=codec,
                       error_feedback=cfg.error_feedback,
                       staleness=staleness,
                       global_avg_every=cfg.global_avg_every,
                       faults=faults, gossip_kernel=self.lane,
                       gossip_buckets=cfg.gossip_buckets)
        if cfg.gossip_every != 1:
            raise ValueError("gossip_every is a push-sum knob")
        return dpsgd(schedule, self.transport, overlap=cfg.overlap,
                     staleness=staleness,
                     global_avg_every=cfg.global_avg_every,
                     faults=faults, gossip_kernel=self.lane,
                     gossip_buckets=cfg.gossip_buckets)

    def _train_fn(self, ppi: int, itr_per_epoch: int):
        """``(algorithm, step)`` for a peers-per-itr value, built once
        per (ppi, itr_per_epoch)."""
        key = (ppi, itr_per_epoch)
        if key not in self._step_cache:
            alg = self.make_algorithm(ppi)
            step = build_train_step(
                self.model, alg, self.tx, self.lr_schedule_obj,
                itr_per_epoch=itr_per_epoch,
                num_classes=self.cfg.num_classes,
                label_smoothing=self.cfg.label_smoothing,
                grad_accum=self.cfg.grad_accum,
                local_axis=self.local_axis,
                health_axis=(self.transport if self.monitor is not None
                             else None))
            self._step_cache[key] = (alg, step)
        return self._step_cache[key]

    # -- telemetry ---------------------------------------------------------

    def _setup_telemetry(self, state, itr_per_epoch: int) -> None:
        """Attach the comm accountant for the active configuration and
        emit the ``run_meta`` event.  Host work, once a fit."""
        from ..telemetry import (CommModel, encoded_payload_bytes,
                                 tree_payload_bytes)

        cfg = self.cfg
        # one rank's payload: the state stacks the held ranks
        exact = tree_payload_bytes(state.params, self.held)
        if cfg.all_reduce:
            alg_name = "all_reduce"
            model = CommModel.for_allreduce(self.gossip_world, exact)
        elif cfg.bilat or cfg.bilat_async:
            alg_name = "bilat_async" if cfg.bilat_async else "adpsgd"
            model = CommModel.for_bilat(self.gossip_world, exact)
        else:
            alg_name = "sgp" if cfg.push_sum else "dpsgd"
            # the epoch-0 algorithm's own schedule and faults: what the
            # wire runs (the epoch loop reuses the cached entry)
            alg = self._train_fn(ppi_at_epoch(cfg.ppi_schedule, 0),
                                 itr_per_epoch)[0]
            # the encoded payload: dtype size plus the int8 scale lane,
            # scalar leaves exempt
            codec = alg.wire
            model = CommModel.from_schedule(
                alg.schedule,
                encoded_payload_bytes(state.params, self.held, codec),
                exact_bytes=exact, gossip_every=alg.gossip_every,
                global_avg_every=alg.global_avg_every, faults=alg.faults,
                ps_weight=cfg.push_sum,
                interconnect=self._plan_interconnect(), codec=codec,
                error_feedback=cfg.error_feedback, overlap=alg.overlap,
                staleness=alg.staleness,
                gossip_kernel=alg.transport_kernel_name,
                gossip_buckets=alg.gossip_buckets)
        self.telemetry.attach_comm(model)
        meta = {
            "world": self.gossip_world, "algorithm": alg_name,
            "gossip_every": cfg.gossip_every,
            "global_avg_every": cfg.global_avg_every,
            "batch_size": cfg.batch_size,
            "itr_per_epoch": itr_per_epoch,
            "num_epochs": cfg.num_epochs,
            "scan_steps": cfg.scan_steps,
            "comm_model": model.to_dict()}
        if self.profile.profile_dir is not None:
            # where this run's torch.profiler trace lands
            meta["profile_dir"] = self.profile.profile_dir
            meta["profile_window"] = [
                self.profile.start_step,
                self.profile.start_step + self.profile.num_steps]
        self.telemetry.registry.emit("run_meta", meta)

    def _save(self, state, meta, epoch: int | None = None, **kw) -> None:
        """``save_checkpoint`` in a ``checkpoint_save`` span; a save that
        exits for a requeue leaves the exit record (a ``run_meta`` event
        with ``exit_reason``) first."""
        tel = self.telemetry
        try:
            with tel.span("checkpoint_save", "checkpoint",
                          {"epoch": epoch} if tel.enabled
                          and epoch is not None else None):
                self.cluster.save_checkpoint(state, meta, **kw)
        except SystemExit as e:
            if tel.enabled and e.code == REQUEUE_EXIT_CODE:
                tel.registry.emit("run_meta", {
                    "exit_reason": "preempt-requeue",
                    "signal": self.cluster.last_signal,
                    "epoch": meta["epoch"], "itr": meta["itr"],
                    "exit_code": REQUEUE_EXIT_CODE},
                    step=self._gstep, severity="warning")
            raise

    # -- csv logging -------------------------------------------------------

    def _init_csv(self) -> None:
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        for r in self._csv_ranks:
            if os.path.exists(self._fname(r)):
                continue
            with open(self._fname(r), "w") as f:
                print("BEGIN-TRAINING\n"
                      f"World-Size,{self.world_size}\n"
                      f"Num-DLWorkers,{self.cfg.num_dataloader_workers}\n"
                      f"Batch-Size,{self.cfg.batch_size}\n"
                      "Epoch,itr,BT(s),avg:BT(s),std:BT(s),"
                      "NT(s),avg:NT(s),std:NT(s),"
                      "DT(s),avg:DT(s),std:DT(s),"
                      "Loss,avg:Loss,Prec@1,avg:Prec@1,Prec@5,avg:Prec@5,val",
                      file=f)

    def _log_row(self, epoch, itr, meters, stat_meters) -> None:
        """One training row per CSV; ``stat_meters[r]`` carries rank r's
        (losses, top1, top5) meters (timing is shared)."""
        bt, nt, dt = meters
        for r in self._csv_ranks:
            losses, top1, top5 = stat_meters[r]
            with open(self._fname(r), "a") as f:
                print(f"{epoch},{itr},{bt},{nt},{dt},"
                      f"{losses.val:.4f},{losses.avg:.4f},"
                      f"{top1.val:.3f},{top1.avg:.3f},"
                      f"{top5.val:.3f},{top5.avg:.3f},-1", file=f)

    def _log_val_row(self, epoch, meters, vals) -> None:
        bt, nt, dt = meters
        for r in self._csv_ranks:
            with open(self._fname(r), "a") as f:
                print(f"{epoch},-1,{bt},{nt},{dt},-1,-1,-1,-1,-1,-1,"
                      f"{vals[r]}", file=f)

    # -- main entry points -------------------------------------------------

    def init_state(self):
        """Every rank starts from the same parameters, drawn from
        ``seed`` (``train/step.py::init_train_state``)."""
        alg = self.make_algorithm(ppi_at_epoch(self.cfg.ppi_schedule, 0))
        return init_train_state(self.model, alg, self.tx, self.held,
                                seed=self.cfg.seed, device=self.device)

    def fit(self, state, train_loader, sampler,
            val_loader=None) -> tuple[tp.Any, dict]:
        cfg = self.cfg
        if len(train_loader) < 1:
            raise ValueError(
                "train loader yields zero batches: batch_size × world_size "
                "exceeds the dataset size")
        # the LR derives the epoch from state.step, so the iteration
        # count per epoch must reflect the early-exit cap
        itr_per_epoch = len(train_loader)
        cap = cfg.num_iterations_per_training_epoch
        if cap not in (None, -1):
            itr_per_epoch = min(itr_per_epoch, cap)
        if cfg.cosine_lr:
            self.lr_schedule_obj = CosineLRSchedule(
                ref_lr=cfg.lr, batch_size=cfg.batch_size,
                world_size=self.world_size, total_epochs=cfg.num_epochs,
                warmup=cfg.warmup)
        else:
            self.lr_schedule_obj = LRSchedule(
                ref_lr=cfg.lr, batch_size=cfg.batch_size,
                world_size=self.world_size, decay_schedule=cfg.lr_schedule,
                warmup=cfg.warmup)
        self._init_csv()

        meters = (Meter(ptag="Time"), Meter(ptag="Forward/Backward"),
                  Meter(ptag="Data"))
        start_epoch, start_itr, best_prec1 = 0, 0, 0.0
        elapsed = 0.0
        want_resume = cfg.resume and self.cluster is not None
        have = want_resume and self.cluster.ckpt.exists()
        if want_resume and self.spread:
            # resume only if every process holds its rank's file
            have = not self._any_process(not have)
        if want_resume and not have:
            have = self._try_cross_world_resume()
        if have:
            # both backends take the held rows as the template: the
            # per-rank files give each process its ranks' files, the DCP
            # backend under torchrun restores collectively, each process
            # its rows of one shared checkpoint
            state, meta = self.cluster.ckpt.restore(state)
            start_epoch, start_itr = consensus_resume_point(
                meta.get("epoch", 0), meta.get("itr", 0), self.transport,
                self.log)
            best_prec1 = meta.get("best_prec1", 0.0)
            elapsed = meta.get("elapsed_time", 0.0)
            for m, k in zip(meters, ("batch_meter", "nn_meter",
                                     "data_meter")):
                if k in meta:
                    m.__dict__.update(meta[k])
            self.log.info(f"resumed from epoch {start_epoch} itr {start_itr}")

        begin_time = time.time() - elapsed
        # the last step taken (the exit record's step)
        self._gstep = start_epoch * itr_per_epoch + start_itr
        if cfg.bilat_async:
            if cfg.graph_class is None:
                raise ValueError("bilat_async needs a graph_class for "
                                 "the matching schedule")
            from .async_bilat import AsyncBilateralAverager

            graph = cfg.graph_class(self.gossip_world, peers_per_itr=1)
            self._async_bilat = AsyncBilateralAverager(
                build_pairing_schedule(graph),
                min_interval_s=cfg.bilat_async_interval).start()
        try:
            if self.telemetry.enabled:
                self._setup_telemetry(state, itr_per_epoch)
            state, best_prec1, final_prec1 = self._fit_epochs(
                state, train_loader, sampler, val_loader, itr_per_epoch,
                meters, start_epoch, start_itr, best_prec1, begin_time)
            if cfg.train_fast and val_loader is not None:
                alg = self._train_fn(
                    ppi_at_epoch(cfg.ppi_schedule, cfg.num_epochs - 1)
                    if not cfg.all_reduce else 1, itr_per_epoch)[0]
                final_prec1 = self.validate(state, alg, val_loader)
                self.log.info(f"Test accuracy: {final_prec1}")
        finally:
            if self._async_bilat is not None:
                self._async_bilat.stop()
                self.log.info("async bilateral staleness: "
                              f"{self._async_bilat.staleness_summary()}")
            # a run that ended inside the window still writes its trace
            self.profile.close()
            # trace.json and the last comm snapshot, whatever path leaves
            # the fit (a crash, an exit 75)
            self.telemetry.finish(step=self._gstep)
        result = {"best_prec1": float(best_prec1),
                  "final_prec1": float(final_prec1),
                  "elapsed_time": time.time() - begin_time,
                  "batch_meter": meters[0]}
        if self._async_bilat is not None:
            result["async_bilat"] = self._async_bilat.staleness_summary()
        if self.profile.trace_path is not None:
            result["profile_trace"] = self.profile.trace_path
        return state, result

    def _fit_epochs(self, state, train_loader, sampler, val_loader,
                    itr_per_epoch, meters, start_epoch, start_itr,
                    best_prec1, begin_time):
        cfg = self.cfg
        final_prec1 = 0.0
        for epoch in range(start_epoch, cfg.num_epochs):
            sampler.set_epoch(epoch + cfg.seed * 90)
            ppi = (ppi_at_epoch(cfg.ppi_schedule, epoch)
                   if not cfg.all_reduce else 1)
            alg, _ = self._train_fn(ppi, itr_per_epoch)
            state = self._train_epoch(
                state, ppi, itr_per_epoch, train_loader, epoch, start_itr,
                meters, best_prec1, begin_time)
            start_itr = 0
            if cfg.train_fast:
                continue
            spread = replica_spread(state, alg, self.transport)
            self.log.info(f"epoch {epoch}: replica spread "
                          f"max {spread['max_spread']:.2e} "
                          f"mean {spread['mean_spread']:.2e}")
            prec1 = (self.validate(state, alg, val_loader)
                     if val_loader is not None else -1.0)
            final_prec1 = prec1
            vals = (self._last_val_per_rank if cfg.per_rank_csv
                    and val_loader is not None
                    else {r: prec1 for r in self._csv_ranks})
            self._log_val_row(epoch, meters, vals)
            is_best = prec1 > best_prec1
            best_prec1 = max(best_prec1, prec1)
            if self.cluster is not None:
                # nothing in flight on disk, and the continuing run
                # adopts the drained view as a resumed one does
                state = drain_state(state)
                meta = self._ckpt_meta(epoch + 1, 0, best_prec1, begin_time,
                                       meters)
                self._save(state, meta, epoch,
                           epoch_id=None if cfg.overwrite_checkpoints
                           else epoch,
                           is_best=is_best,
                           requeue_on_signal=epoch != cfg.num_epochs - 1)
        return state, best_prec1, final_prec1

    def _try_cross_world_resume(self) -> bool:
        """No checkpoint of this world: reshard another world's set into
        place (``supervise/reshard.py``) and say whether every process
        now holds its files.  Raises where the reference does not
        reshard (``nprocs_per_node`` > 1, the DCP backend) and when no
        set on disk can be resharded, rather than start over."""
        from ..supervise.reshard import maybe_cross_world_reshard
        from ..utils.checkpoint import CheckpointManager

        ckpt = self.cluster.ckpt
        if not isinstance(ckpt, CheckpointManager):
            ckpt.refuse_other_worlds()
            return False
        if not ckpt.discover_worlds():
            return False
        if self.local_axis is not None:
            ckpt.refuse_other_worlds(
                f"nprocs_per_node {self.cfg.nprocs_per_node} > 1 keeps a "
                "node's row in a file while the file world counts devices")
        # decided before any writes (under torchrun by every process
        # together): one process's new file must not make another skip
        # its reshard
        this_world = os.path.join(ckpt.directory, f"{ckpt.tag}checkpoint_"
                                  f"r{{}}_n{ckpt.world_size}.ckpt")
        seen = any(os.path.isfile(this_world.format(r))
                   for r in range(self.gossip_world))
        if self._any_process(seen) if self.spread else seen:
            self.log.warning("a checkpoint of this world is on disk but "
                             "incomplete; starting from epoch 0")
            return False
        maybe_cross_world_reshard(
            ckpt.directory, ckpt.tag, ckpt.world_size,
            ranks=self.transport.ranks, log=self.log, exact_checked=True)
        have = ckpt.exists()
        return not self._any_process(not have) if self.spread else have

    def _ckpt_meta(self, epoch: int, itr: int, best_prec1, begin_time,
                   meters) -> dict:
        """Checkpoint metadata for a resume point at (epoch, itr)."""
        batch_meter, nn_meter, data_meter = meters
        meta = {"epoch": epoch, "itr": itr,
                "best_prec1": float(best_prec1),
                "elapsed_time": time.time() - begin_time,
                "batch_meter": batch_meter.state_dict(),
                "nn_meter": nn_meter.state_dict(),
                "data_meter": data_meter.state_dict()}
        if self.cfg.plan:
            # the launch-time topology plan rides with the state it
            # shaped
            meta["plan"] = self.cfg.plan
        if self.monitor is not None and self.monitor.last_payload:
            # the run's health at save time rides with the state it
            # describes
            meta["health"] = self.monitor.last_payload
        return meta

    def _preempt_exit(self, state, epoch, itr, meters, best_prec1,
                      begin_time):
        """A preemption signal arrived: the step is done, so save at
        (epoch, itr) with the FIFO drained and exit
        :data:`REQUEUE_EXIT_CODE` (``save_checkpoint`` raises it)."""
        self.log.warning(
            "preemption signal (%s): checkpointing at epoch %d itr %d "
            "and exiting %d (requeue me)",
            self.cluster.last_signal or "peer flag", epoch, itr,
            REQUEUE_EXIT_CODE)
        state = drain_state(state)
        meta = self._ckpt_meta(epoch, itr, best_prec1, begin_time, meters)
        self._save(state, meta, requeue_on_signal=True)
        # only reachable if the flag vanished between check and save
        raise SystemExit(REQUEUE_EXIT_CODE)

    def _train_epoch(self, state, ppi, itr_per_epoch, loader, epoch,
                     start_itr, meters, best_prec1=0.0, begin_time=None):
        cfg = self.cfg
        batch_meter, nn_meter, data_meter = meters
        stat_meters = {r: (Meter(ptag="Loss"), Meter(ptag="Prec@1"),
                           Meter(ptag="Prec@5"))
                       for r in self._csv_ranks}
        num_itr_ignore = cfg.num_itr_ignore
        cap = cfg.num_iterations_per_training_epoch
        cap = None if cap in (None, -1) else cap
        if start_itr:
            loader.fast_forward(start_itr)
        if cfg.prefetch:
            if not self.spread and cfg.scan_steps <= 1:
                from ..data.prefetch import DevicePrefetcher

                loader = DevicePrefetcher(loader, self.device,
                                          depth=cfg.prefetch_depth)
            elif not self._warned_prefetch:
                # the reference's warning (train/loop.py:975-979 there)
                self.log.warning("prefetch supports single-process "
                                 "non-scanned runs only; continuing "
                                 "without it")
                self._warned_prefetch = True
        alg, train_fn = self._train_fn(ppi, itr_per_epoch)
        keys = ("loss", "top1", "top5", "grad_norm")

        it = iter(loader)
        i = start_itr - 1
        batch_time = time.time()
        while True:
            remaining = None if cap is None else cap - (i + 1)
            if remaining is not None and remaining <= 0:
                break
            # the reference's chunk sizes: single steps through the
            # warm-up window and for a cap tail shorter than scan_steps,
            # else scan_steps
            target = cfg.scan_steps
            if num_itr_ignore > 0 or target <= 1 or (
                    remaining is not None and remaining < target):
                target = 1
            pending = []
            for _ in range(target):
                try:
                    pending.append(next(it))
                except StopIteration:
                    break
            if not pending:
                break
            if 1 < len(pending) < target:
                # a loader tail: the extras run as single steps
                it = iter(pending[1:])
                pending = pending[:1]
            chunk = len(pending)
            if chunk > 1:
                # a chunk's batches go to the device in one copy
                stack = (torch.stack if isinstance(pending[0][0],
                                                   torch.Tensor)
                         else np.stack)
                x, y = (self._on_device(stack([b[k] for b in pending]))
                        for k in (0, 1))
                n = self.world_size * x.shape[2]
            else:
                x, y = pending[0]
                n = self.world_size * x.shape[1]
                x, y = self._on_device(x), self._on_device(y)
            elapsed_data = time.time() - batch_time
            nn_time = time.time()
            gstep = epoch * itr_per_epoch + i + 1
            last = gstep + chunk - 1
            warm_key = (ppi, itr_per_epoch, chunk, tuple(x.shape), x.dtype)
            warm = self._warm_counts.get(warm_key, 0) >= 2
            self._warm_counts[warm_key] = self._warm_counts.get(
                warm_key, 0) + 1
            # the heartbeat is armed on warm steps only: a variant's first
            # calls build kernels and tune convolutions; it wraps a whole
            # chunk, as the profile window does
            guard = (self.watchdog.step()
                     if self.watchdog is not None and warm
                     else contextlib.nullcontext())
            self.profile.maybe_start(gstep)
            with guard:
                steps = []
                for j in range(chunk):
                    # the chunk's steps back to back, no host read between
                    state, metrics = (train_fn(state, x[j], y[j])
                                      if chunk > 1 else
                                      train_fn(state, x, y))
                    steps.append(metrics)
                if self._async_bilat is not None:
                    # wall-clock AD-PSGD: the thread gets the chunk's
                    # params (a clone queued after its last step) and the
                    # chunk takes whatever displacement it has ready
                    self._async_bilat.publish(last, state.params)
                    self._async_bilat.maybe_adopt(last, state.params)
                # the device-to-host read ends the window on finished work:
                # every rank's row of every step in one read, gathered
                # across processes, with this process's preemption flag
                # beside it
                row = [torch.stack([m[k] for m in steps], -1)
                       for k in keys]
                if self.spread:
                    row.append(torch.full_like(row[0], float(
                        self.cluster is not None
                        and self.cluster.local_signalled())))
                rows = torch.stack(row, -1)     # [R, chunk, keys]
                # a single step reads its [R, keys] rows
                rows = to_host(rows if chunk > 1 else rows[:, 0],
                               self.transport).reshape(-1, chunk,
                                                       rows.shape[-1])
            self.profile.maybe_stop(last)
            # [world, chunk] a key
            host = {k: rows[:, :, j] for j, k in enumerate(keys)}
            signalled = self.spread and bool(rows[:, :, -1].max())
            # a cross-process gossip wait that gave up raises here
            self.transport.check()
            elapsed_nn = time.time() - nn_time
            elapsed_batch = time.time() - batch_time
            # gstep is the algorithm's 0-based tick; steps done count 1
            self._gstep = last + 1
            tel = self.telemetry
            if tel.enabled:
                # spans from the loop's own clock readings; the comm tally
                # is integer math at each step's tick
                tel.trace_complete("data_fetch", "data", batch_time,
                                   elapsed_data)
                span_args = {"steps": chunk, "timed": warm}
                if tel.comm is not None:
                    m = tel.comm.model
                    span_args["gossip"] = sum(int(m.gossip_fires(gstep + j))
                                              for j in range(chunk))
                    span_args["global_avg"] = sum(
                        int(m.global_avg_fires(gstep + j))
                        for j in range(chunk))
                    for j in range(chunk):
                        tel.comm.on_step(gstep + j)
                tel.trace_complete("train_step", "step", nn_time,
                                   elapsed_nn, span_args)
                ke = tel.metrics_every
                if ke and any((gstep + j + 1) % ke == 0
                              for j in range(chunk)):
                    tel.registry.emit("step_stats", {
                        "epoch": epoch,
                        "loss": round(float(host["loss"].mean()), 6),
                        "step_time_s": round(elapsed_batch / chunk, 6),
                        "data_time_s": round(elapsed_data / chunk, 6),
                        "nn_time_s": round(elapsed_nn / chunk, 6),
                        "timed": warm}, step=self._gstep)
                    tel.emit_comm(step=self._gstep)
            # a chunk never straddles the warm-up: all its steps are timed,
            # or none is; each takes the chunk's time over its size
            timed = num_itr_ignore == 0
            for j in range(chunk):
                if timed:
                    nn_meter.update(elapsed_nn / chunk)
                    batch_meter.update(elapsed_batch / chunk)
                    data_meter.update(elapsed_data / chunk)
                else:
                    num_itr_ignore -= 1
                if self.monitor is not None:
                    if timed:
                        # per-step samples feed the p50/p99 straggler view
                        self.monitor.record_step_time(elapsed_batch / chunk)
                    # each step observed; a recovery acts on the state
                    # after the chunk
                    state = self._observe_health(state, alg, steps[j],
                                                 gstep + j)
                i += 1
                for r in self._csv_ranks:
                    pick = ((lambda a: a[r, j]) if cfg.per_rank_csv
                            else (lambda a: a[:, j].mean()))
                    for meter, k in zip(stat_meters[r], ("loss", "top1",
                                                         "top5")):
                        meter.update(float(pick(host[k])), n)
                if i % cfg.print_freq == 0:
                    self._log_row(epoch, i, meters, stat_meters)
                    if cfg.verbose:
                        self.log.info(
                            f"epoch {epoch} itr {i}: grad_norm "
                            f"{float(host['grad_norm'][:, j].mean()):.4f}")
            # a preemption is acted on between chunks
            if self.cluster is not None and (
                    signalled if self.spread
                    else self.cluster.any_rank_signalled()):
                self._preempt_exit(state, epoch, i + 1, meters, best_prec1,
                                   begin_time if begin_time is not None
                                   else time.time())
            batch_time = time.time()

        self._log_row(epoch, i, meters, stat_meters)
        return state

    # -- resilience --------------------------------------------------------

    def _recovery_fn(self, alg):
        """The immediate global average of ``alg``, cached per
        algorithm."""
        key = id(alg)
        if key not in self._recovery_cache:
            from ..resilience import make_recovery_fn

            self._recovery_cache[key] = (make_recovery_fn(alg), alg)
        return self._recovery_cache[key][0]

    def _observe_health(self, state, alg, metrics, gstep: int):
        """Digest one step's health signals; fire recovery when the
        policy says so."""
        from ..resilience.monitor import host_signals
        from ..resilience.recovery import recover_state

        signals = host_signals(metrics)
        if signals is None:
            return state  # step built without health signals
        report = self.monitor.observe(gstep, signals)
        if report.unhealthy and self.recovery_policy is not None:
            event = self.recovery_policy.assess(report)
            if event.action == "global-average" \
                    and hasattr(alg, "global_average"):
                with self.telemetry.span("recovery_global_average",
                                         "recovery"):
                    state = recover_state(state, alg,
                                          self._recovery_fn(alg))
                if self.telemetry.comm is not None:
                    self.telemetry.comm.on_recovery()
        return state

    @torch.no_grad()
    def validate(self, state, algorithm, val_loader) -> float:
        """Every rank evaluates its shard of the val set; returns the
        sample-weighted mean top-1 over ranks and batches."""
        if self._eval_fn is None or self._eval_alg is not algorithm:
            self._eval_fn = build_eval_step(self.model, algorithm,
                                            self.cfg.num_classes,
                                            local_axis=self.local_axis)
            self._eval_alg = algorithm
        losses = Meter(ptag="Loss")
        top1 = Meter(ptag="Prec@1")
        top5 = Meter(ptag="Prec@5")
        rank_top1 = np.zeros(self.gossip_world)
        n_batches, n_samples = 0, 0
        with self.telemetry.span("validate", "eval"):
            for x, y in val_loader:
                n = self.world_size * x.shape[1]
                m = self._eval_fn(state, self._on_device(x),
                                  self._on_device(y))
                m = {k: to_host(v, self.transport) for k, v in m.items()}
                losses.update(float(np.mean(m["loss"])), n)
                top1.update(float(np.mean(m["top1"])), n)
                top5.update(float(np.mean(m["top5"])), n)
                rank_top1 += m["top1"].reshape(self.gossip_world) * n
                n_samples += n
                n_batches += 1
        if n_batches == 0:
            self.log.warning(
                "validation loader yielded no batches (dataset smaller "
                "than one world batch?) — reporting -1")
            self._last_val_per_rank = [-1.0] * self.gossip_world
            return -1.0
        self._last_val_per_rank = (rank_top1 / n_samples).tolist()
        self.log.info(f" * Prec@1 {top1.avg:.3f} Prec@5 {top5.avg:.3f}")
        return top1.avg
