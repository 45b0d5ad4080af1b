"""supervise/ — elastic run supervisor: the host-side control loop.

Port of ``stochastic_gradient_push_tpu/supervise/``.  The planner
decides topologies (``planner/``), the resilience monitor and recovery
policy log re-plan suggestions (``resilience/``), telemetry turns both
into one typed ``events.jsonl`` stream (``telemetry/``), and the
checkpoint layer saves a file a rank (``utils/checkpoint.py``).  None of
them can act on a lost rank or a sustained re-plan suggestion: a run's
world and schedule are fixed for the life of its processes, so topology
switching and world resizing are relaunch decisions, made here from
outside the run (≙ the original's ``ClusterManager`` requeue layer,
generalised from "requeue the same job" to "resize and replan the run"):

* :mod:`.tailer` — incremental ``events.jsonl`` reader, robust to
  partial trailing lines, truncation/rotation, and unknown kinds;
* :mod:`.policy` — debounced decision state machine: a *sustained*
  re-plan suggestion, a stalled rank (watchdog heartbeat or silence), a
  child crash, or a requeue exit each map to one supervisor action;
* :mod:`.reshard` — world-resize of a checkpoint set: exact-average
  consensus collapse (``x̄ = Σ params / Σ ps_weight``) re-stacked at the
  surviving world, so the parameter mean is kept across the restart
  boundary by construction; a set whose rank files are missing or come
  from different saves is torn;
* :mod:`.supervisor` — the lifecycle owner: launches a run CLI as a
  managed child, drains it through the SIGUSR1 checkpoint path, and
  relaunches with fresh ``planner.plan_for`` flags;
* :mod:`.replan` — the stamped-constraints replanning shared by the
  supervisor and the coordinator (fabric, wire codec, synth spec);
* :mod:`.coordinator` — pod-level fleet supervision: one coordinator
  plus per-host supervisors in fleet mode, speaking a barrier-with-
  deadline rendezvous over the typed event stream; the unit of failure
  is a whole host, survivors reshard their assigned shards concurrently
  and relaunch on one coordinated ``go``;
* :mod:`.hostsim` — a numpy per-host trainer speaking the real
  checkpoint/event/drain contracts: the fleet chaos selftest's child.

``scripts/torch_supervise.py`` is the single-host operator entry point
(its ``--selftest`` kills a world-8 run after its first checkpoint set,
reshards 8→4, relaunches on a fresh plan, and holds the mean to f32
tolerance); ``scripts/torch_fleet.py`` is the fleet entry point
(``--coordinator`` / ``--host I``), whose ``--selftest`` kills a whole
simulated host and asserts one coordinated reshard/relaunch cycle at
the shrunken world.
"""

from .coordinator import (
    EXCLUDED_EXIT_CODE,
    Coordinator,
    FleetMember,
    host_dir,
)
from .policy import Action, SupervisorPolicy
from .replan import replan_for, stamped_plan
from .reshard import (
    CheckpointMetaError,
    ReshardReport,
    TornCheckpointError,
    consensus_mean,
    gc_stale_tmp,
    load_world_checkpoint,
    maybe_cross_world_reshard,
    meta_key,
    reshard_checkpoints,
    reshard_state,
)
from .supervisor import ChildSpec, Supervisor
from .tailer import EventTailer

__all__ = [
    "Action", "SupervisorPolicy",
    "ReshardReport", "TornCheckpointError", "consensus_mean",
    "load_world_checkpoint", "maybe_cross_world_reshard",
    "reshard_checkpoints", "reshard_state",
    "ChildSpec", "Supervisor", "EventTailer",
    "Coordinator", "FleetMember", "host_dir", "EXCLUDED_EXIT_CODE",
    "replan_for", "stamped_plan", "gc_stale_tmp",
    "CheckpointMetaError", "meta_key",
]
