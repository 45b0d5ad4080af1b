"""Consensus-error-vs-simulated-wall-clock curves.

Port of ``stochastic_gradient_push_tpu/sim/curves.py``.

Round counts flatter dense topologies: exponential graphs contract
faster *per round*, but on a priced fabric a round is not a unit — a
linear graph's O(n)-reach edges cross slices at DCN cost while a ring's
neighbor hops stay on ICI.  The curve that matters plots consensus error
against **accumulated modeled seconds** (:class:`~.fabric.FabricModel`
per-tick time, fault masks zeroing dropped edges' wire time), which is
exactly the trade the planner's ``cycle_cost × rounds-to-ε`` score
claims to capture.  :func:`sweep_curves` produces the pod-farm evidence
for that claim at worlds the real fleet cannot reach.
"""

from __future__ import annotations

import numpy as np

from ..planner.interconnect import InterconnectModel
from .engine import (DEFAULT_DIM, consensus_error, gossip_tick,
                     init_state)
from .fabric import FabricModel, payload_bytes_for

__all__ = ["consensus_curve", "sweep_curves", "time_to_error"]


def consensus_curve(schedule, steps: int, *,
                    interconnect: InterconnectModel | None = None,
                    d: int = DEFAULT_DIM, seed: int = 0,
                    fault_plan=None, codec=None) -> dict:
    """Run ``steps`` exact gossip rounds, pricing each on the fabric.

    Returns ``{"time_s": [...], "error": [...], "ticks": int,
    "cycle_time_s": float, "payload_bytes": int}`` — ``time_s[t]`` is
    the simulated wall-clock at which tick ``t``'s error was reached.
    """
    fabric = FabricModel(schedule, interconnect,
                         payload_bytes_for(d, codec=codec))
    state = init_state(schedule.world_size, d=d, seed=seed)
    target = state.params.mean(axis=0)
    keep = corrupt = None
    horizon = 0
    if fault_plan is not None:
        keep, corrupt, horizon = fault_plan.host_tables(schedule)
    times, errors, clock = [], [], 0.0
    for _ in range(steps):
        keep_row = corrupt_row = None
        if keep is not None:
            row = (state.tick if state.tick < horizon
                   else horizon + state.tick % schedule.num_phases)
            keep_row, corrupt_row = keep[row], corrupt[row]
            if not np.any(corrupt_row):
                corrupt_row = None
        clock += fabric.tick_time(state.tick, keep_row=keep_row)
        state = gossip_tick(state, schedule, keep_row=keep_row,
                            corrupt_row=corrupt_row)
        times.append(clock)
        errors.append(consensus_error(state, target))
    return {"time_s": times, "error": errors, "ticks": steps,
            "cycle_time_s": fabric.cycle_time(),
            "payload_bytes": fabric.payload_bytes}


def time_to_error(curve: dict, eps: float) -> float | None:
    """First simulated second at which the error trace dips below
    ``eps`` (None if it never does within the run)."""
    for t, e in zip(curve["time_s"], curve["error"]):
        if e <= eps:
            return float(t)
    return None


def sweep_curves(topologies: dict, worlds, steps: int, *,
                 interconnect_for=None, d: int = DEFAULT_DIM,
                 seed: int = 0, eps: float = 1e-6,
                 fault_plan_for=None) -> list[dict]:
    """One curve per (topology, world).  ``topologies`` maps name →
    ``schedule_for(world)``; ``interconnect_for(world)`` and
    ``fault_plan_for(world)`` are optional per-world factories.  Each
    row carries the raw curve plus ``time_to_eps`` for ordering checks.
    """
    rows = []
    for world in worlds:
        model = interconnect_for(world) if interconnect_for else None
        plan = fault_plan_for(world) if fault_plan_for else None
        for name, schedule_for in topologies.items():
            schedule = schedule_for(world)
            curve = consensus_curve(schedule, steps, interconnect=model,
                                    d=d, seed=seed, fault_plan=plan)
            rows.append({
                "topology": name, "world": int(world),
                "num_phases": int(schedule.num_phases),
                "peers_per_itr": int(schedule.peers_per_itr),
                "final_error": curve["error"][-1],
                "cycle_time_s": curve["cycle_time_s"],
                "time_to_eps": time_to_error(curve, eps),
                "eps": eps, "curve": curve})
    return rows
