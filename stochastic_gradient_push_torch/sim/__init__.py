"""sim/ — priced-fabric fleet simulator for gossip + supervision at scale.

Port of ``stochastic_gradient_push_tpu/sim/``: numpy float64 and
threads on the host, no device.  The engine's states are bit-equal to
the reference's; the fleet lane saves the port's rank files through the
world's save barrier (:mod:`.fleet`).

The verifier (analysis/) proves a :class:`~..topology.schedule.
GossipSchedule` algebraically sound; the trainer executes it on at most
a host's worth of devices; nothing between them answers the pod-farm
question — *what does this schedule + this supervision stack actually do
at world 1024–4096 when slices die?*  This package is that layer: a
numpy-only discrete-event simulator that

* executes the **exact** compiled per-phase mixing tables (the same
  ``perms``/``self_weight``/``edge_weights`` the verifier checks — the
  engine's scatter is bit-identical to the dense permutation-matrix
  oracle, :mod:`.engine`),
* prices every message on the fabric model the planner scores with
  (:class:`~..planner.interconnect.InterconnectModel` edge costs ×
  wire-codec payload bytes, :mod:`.fabric`), so consensus curves come
  out against *simulated wall-clock*, not round counts,
* compiles fault campaigns — whole-slice kills, cascading slice
  failures, sustained churn, coordinator loss — down to the
  :mod:`~..resilience.faults` grammar's mass-conserving masks
  (:mod:`.campaign`), and
* drives the REAL :class:`~..supervise.coordinator.Coordinator`
  rendezvous → assign → ack → go cycle against simulated hosts
  (:mod:`.fleet`) — including grow-the-world induction, where a hello
  from a new host id produces one coordinated n → n′ upward reshard.

Exact vs modeled: the *mixing algebra* is exact (same tables, same
scatter order, f64); *time* is modeled (per-edge priced latency +
bytes, the planner's own cost model); *supervision* is real code over
simulated hosts (threads speaking the FleetMember wire protocol,
hostsim-format checkpoints, real ``reshard_checkpoints``).

``scripts/torch_sim.py`` is the CLI; ``--selftest`` is its gate.
"""

from __future__ import annotations

from .campaign import (Campaign, cascading_slices_campaign,
                       coordinator_loss_campaign, kill_slice_campaign,
                       sustained_churn_campaign)
from .engine import (SimState, consensus, consensus_error, gossip_tick,
                     init_state, oracle_tick, run_gossip)
from .fabric import FabricModel, payload_bytes_for
from .fleet import FleetReport, SimHost, run_sim_fleet
from .curves import consensus_curve, sweep_curves, time_to_error

__all__ = [
    "Campaign", "FabricModel", "FleetReport", "SimHost", "SimState",
    "cascading_slices_campaign", "consensus", "consensus_curve",
    "consensus_error", "coordinator_loss_campaign", "gossip_tick",
    "init_state", "kill_slice_campaign", "oracle_tick",
    "payload_bytes_for", "run_gossip", "run_sim_fleet",
    "sustained_churn_campaign", "sweep_curves", "time_to_error",
]
