"""Fault campaigns: named failure scenarios compiled to the fault
grammar plus fleet-lane actions.

Port of ``stochastic_gradient_push_tpu/sim/campaign.py``: the same
campaigns compile to the same specs.

A *campaign* is one reproducible failure story told at pod-farm
granularity — "slice 3 dies at step 200", "slices fail in a 4-deep
cascade", "half the wire drops for a thousand steps", "the coordinator
goes dark mid-run".  Each compiles down to the two lanes the simulator
runs:

* **in-mesh lane** — a :mod:`~..resilience.faults` grammar string
  (``slice:A-B@T0:T1``, ``drop_random:P@..``) whose mass-conserving
  keep masks the gossip engine applies per tick.  Nothing new to
  verify: ``FaultPlan.effective_schedule`` keeps proving
  column-stochasticity for every campaign the simulator can express;
* **fleet lane** — host-level actions (kill host *h* once the fleet has
  checkpointed, pause the coordinator for a window, a late join) that
  :func:`~.fleet.run_sim_fleet` performs against the REAL coordinator.

Campaigns the issue names:

* :func:`kill_slice_campaign` — one whole slice lost at once
  (GossipGraD's failure granularity);
* :func:`cascading_slices_campaign` — staggered slice losses, each
  inside the previous one's recovery shadow;
* :func:`sustained_churn_campaign` — a long window of 50% random edge
  drops (the network neither heals nor dies);
* :func:`coordinator_loss_campaign` — the coordinator itself goes
  silent; host faults queue in the event streams (the tailers replay —
  nothing is lost) and exactly one coordinated cycle runs on recovery.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Campaign", "kill_slice_campaign",
           "cascading_slices_campaign", "sustained_churn_campaign",
           "coordinator_loss_campaign"]


@dataclasses.dataclass(frozen=True)
class Campaign:
    """One compiled failure scenario.

    ``fault_spec`` — in-mesh lane (``resilience.parse_fault_spec``
    grammar), None when the scenario is fleet-only.
    ``kill_hosts`` — fleet lane: host ids SIGKILL-equivalently removed
    (thread stopped without a fault report) once the whole fleet has
    checkpointed.  ``coordinator_down_s`` — fleet lane: seconds the
    coordinator sleeps before it starts polling (loss + recovery).
    """

    name: str
    fault_spec: str | None = None
    kill_hosts: tuple[int, ...] = ()
    coordinator_down_s: float = 0.0

    def describe(self) -> str:
        bits = []
        if self.fault_spec:
            bits.append(f"faults[{self.fault_spec}]")
        if self.kill_hosts:
            bits.append(f"kill hosts {list(self.kill_hosts)}")
        if self.coordinator_down_s:
            bits.append(f"coordinator dark {self.coordinator_down_s}s")
        return f"{self.name}: " + ("; ".join(bits) or "no-op")


def _slice_clause(slice_idx: int, slice_size: int, start: int,
                  end: int) -> str:
    lo = slice_idx * slice_size
    return f"slice:{lo}-{lo + slice_size - 1}@{start}:{end}"


def kill_slice_campaign(world: int, slice_size: int, *,
                        slice_idx: int | None = None, at: int = 100,
                        duration: int = 200) -> Campaign:
    """One whole slice blacks out for ``duration`` ticks — the unit of
    failure a pod actually has.  Default victim: the last slice."""
    n_slices, rem = divmod(world, slice_size)
    if rem or n_slices < 2:
        raise ValueError(f"world {world} is not >= 2 slices of "
                         f"{slice_size}")
    victim = n_slices - 1 if slice_idx is None else int(slice_idx)
    if not 0 <= victim < n_slices:
        raise ValueError(f"slice_idx {victim} outside {n_slices} slices")
    return Campaign(
        name=f"kill-slice-{victim}",
        fault_spec=_slice_clause(victim, slice_size, at, at + duration),
        kill_hosts=(victim,))


def cascading_slices_campaign(world: int, slice_size: int, *,
                              count: int = 3, at: int = 100,
                              stagger: int = 50,
                              duration: int = 150) -> Campaign:
    """``count`` slices fail ``stagger`` ticks apart, each going dark
    while the previous loss is still being absorbed — the correlated-
    failure shape a single power/network domain produces."""
    n_slices, rem = divmod(world, slice_size)
    if rem or count >= n_slices:
        raise ValueError(f"need count={count} < {world // slice_size} "
                         "whole slices")
    victims = tuple(range(n_slices - count, n_slices))
    clauses = [
        _slice_clause(v, slice_size, at + j * stagger,
                      at + j * stagger + duration)
        for j, v in enumerate(victims)]
    return Campaign(name=f"cascade-{count}-slices",
                    fault_spec=";".join(clauses), kill_hosts=victims)


def sustained_churn_campaign(*, prob: float = 0.5, at: int = 50,
                             duration: int = 1000,
                             seed: int = 0) -> Campaign:
    """Every out-edge drops with probability ``prob`` for ``duration``
    ticks: the degraded-but-alive regime where push-sum's reabsorption
    must keep the consensus target exact while the rate degrades."""
    if not 0.0 < prob < 1.0:
        raise ValueError(f"churn prob {prob} outside (0, 1)")
    return Campaign(
        name=f"churn-{int(prob * 100)}pct",
        fault_spec=f"drop_random:{prob}@{at}:{at + duration};"
                   f"seed:{seed}")


def coordinator_loss_campaign(*, down_s: float = 3.0,
                              kill_host: int | None = None) -> Campaign:
    """The coordinator is dark for ``down_s`` seconds while a host dies
    (default: fleet's last host).  The event streams are files and the
    tailers replay, so the fault report survives the outage; recovery
    must produce exactly ONE coordinated cycle, not one per missed
    poll."""
    return Campaign(name="coordinator-loss",
                    kill_hosts=(kill_host,) if kill_host is not None
                    else (-1,),
                    coordinator_down_s=float(down_s))
