"""Shared restart-boundary replanning: stamped constraints → fresh plan.

Port of ``stochastic_gradient_push_tpu/supervise/replan.py``.  Both
relaunch deciders — the single-host :class:`~.supervisor.Supervisor`
and the pod-level :class:`~.coordinator.Coordinator` — re-plan for the
surviving world under the constraints the run launched with: the
fabric model, wire codec, fault injection and synthesizer spec are read
back from the plan the launch stamped into the checkpoint meta, so a
compressed run relaunches priced on encoded lanes, a synthesized run
re-enters the synthesizer seeded with its stamped spec, and a
fault-injected run is never advised onto a schedule it would reject.

The coordinator re-plans once for the whole fleet (per-host
supervisors receive the plan in the ``fleet`` assignment broadcast), so
the two paths cannot drift apart.  The stamp is read from the port's
rank file (``{"state", "meta": <JSON text>}``, ``utils/checkpoint.py``)
with the reshard's own reader.
"""

from __future__ import annotations

import os
import pickle

__all__ = ["stamped_plan", "replan_for"]


def stamped_plan(checkpoint_dir: str, tag: str) -> dict | None:
    """The plan the run launched with, read back from the newest
    checkpoint file's meta (both run CLIs stamp ``meta['plan']``)."""
    from .reshard import CheckpointMetaError, _load_file, _rank_files

    sets = _rank_files(checkpoint_dir, tag)
    paths = [p for files in sets.values() for _, p in files]
    if not paths:
        return None
    newest = max(paths, key=os.path.getmtime)
    try:
        _, meta = _load_file(newest)
    except (OSError, ValueError, RuntimeError, EOFError,
            pickle.UnpicklingError, CheckpointMetaError):
        return None   # not a rank file
    return meta.get("plan")


def replan_for(world: int, stamped: dict | None, *,
               gossip: bool = True, algorithm: str = "sgp",
               gap_floor: float = 0.01, overlap: bool = False,
               faults: bool = False, log=None) -> dict | None:
    """A fresh ``planner.plan_for`` for ``world`` under the stamped
    constraints; ``None`` for non-gossip runs (nothing to plan) or when
    the planner cannot help (the relaunch then keeps the child's own
    flags).  ``stamped`` is the previous generation's plan dict (from
    :func:`stamped_plan`); the child-derived keyword defaults fill the
    gaps when the stamp is missing."""
    if not gossip:
        return None
    from ..planner import InterconnectModel, PlanConstraints, plan_for

    stamped = stamped or {}
    interconnect = None
    if stamped.get("interconnect"):
        interconnect = InterconnectModel.from_dict(
            stamped["interconnect"])
    cons = PlanConstraints(
        floor=float(stamped.get("floor", gap_floor)),
        self_weighted=bool(stamped.get("alpha") is not None),
        interconnect=interconnect,
        overlap=overlap, faults=faults,
        # the relaunch gossips through the wire codec the run was
        # stamped with: price (and re-stamp) it accordingly
        wire=stamped.get("wire"),
        # a synthesized run re-enters the synthesizer for the new world
        # (an unchanged world reuses the stamped schedule)
        synth=stamped.get("synth"))
    try:
        plan = plan_for(world, ppi=stamped.get("ppi"),
                        algorithm=stamped.get("algorithm", algorithm),
                        constraints=cons)
    except ValueError as e:
        if log is not None:
            log.warning("replan failed (%s); relaunching with the "
                        "child's own flags", e)
        return None
    if log is not None:
        log.info("replan for world %d: %s", world, plan.summary())
    return plan.to_dict()
