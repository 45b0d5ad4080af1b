"""Reactive recovery: an exact global average when the monitor sees a
fixable excursion.

Port of ``stochastic_gradient_push_tpu/resilience/recovery.py``.  The
recovery primitive is the exact global average ``x ← Σ params / Σ
ps_weight`` with the ps-weight reset to 1
(``PushSumGossip.global_average``): mean-preserving under any
column-stochastic mixing, faulted included, and the consensus residual
drops to zero in one all-reduce.  :class:`RecoveryPolicy` fires it when
the consensus residual crosses ``--residual_floor``, when push-sum mass
leaks, or when a rank's ps-weight collapses, with a cooldown and a
circuit breaker.  NaN/Inf excursions do not trigger it (an average
spreads poison): they are logged with ``advise-restore``.

Every firing also asks the topology planner (``planner.plan_for``) what
it would run for this world now, on the run's fabric, fault, wire and
synthesis settings (:meth:`RecoveryPolicy.replan`): the event's
``suggestion``.
"""

from __future__ import annotations

import dataclasses
import json

from .monitor import HealthReport

__all__ = ["RecoveryPolicy", "RecoveryEvent", "make_recovery_fn",
           "recover_state"]

# reasons the exact average can repair
_AVERAGEABLE = ("residual-above-floor", "push-sum-mass-leak",
                "ps-weight-collapse")
_POISONED = ("nonfinite-params", "nonfinite-grads")


def make_recovery_fn(algorithm):
    """``algorithm.global_average`` over the algorithm's transport, for a
    rank-stacked state: ``(params, ps_weight) -> (params, ps_weight)``,
    and for an overlap algorithm ``(params, ps_weight, in_flight) ->
    (params, ps_weight, in_flight)``, the FIFO folded into ``Σx/Σw`` and
    returned drained (each pending share counted once)."""
    if not hasattr(algorithm, "global_average"):
        raise ValueError(
            f"{type(algorithm).__name__} has no global_average; recovery "
            "applies to the push-sum/D-PSGD gossip family")
    if getattr(algorithm, "overlap", False):
        def run_overlap(params, ps_weight, in_flight):
            return algorithm.global_average(params, ps_weight,
                                            in_flight=in_flight)

        return run_overlap

    def run(params, ps_weight):
        return algorithm.global_average(params, ps_weight)

    return run


def recover_state(state, algorithm, fn):
    """A train state after ``fn`` (a :func:`make_recovery_fn` of
    ``algorithm``): params averaged, the weights 1, an overlap FIFO
    drained."""
    g = state.gossip
    if getattr(algorithm, "overlap", False):
        params, ps_weight, fifo = fn(state.params, g.ps_weight, g.in_flight)
        g = g.replace(ps_weight=ps_weight, in_flight=fifo)
    else:
        params, ps_weight = fn(state.params, g.ps_weight)
        g = g.replace(ps_weight=ps_weight)
    return dataclasses.replace(state, params=params, gossip=g)


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    """One recovery decision, as logged."""

    step: int
    action: str              # "global-average" | "advise-restore" | "none"
    reasons: tuple[str, ...]
    suggestion: dict | None  # planner re-plan for this world, if consulted

    def to_dict(self) -> dict:
        d = {"step": self.step, "action": self.action,
             "reasons": list(self.reasons)}
        if self.suggestion is not None:
            d["suggestion"] = self.suggestion
        return d


class RecoveryPolicy:
    """Decides when the trainer fires an immediate exact global average.

    ``cooldown_steps`` bounds the firing rate (one average zeroes the
    residual; firing again before fresh rounds would measure float
    noise).  ``max_recoveries`` (0 = unlimited) is the circuit breaker
    for a permanently broken mesh: after it trips the policy stops
    averaging and keeps logging."""

    def __init__(self, world: int, ppi: int = 1, algorithm: str = "sgp",
                 topology: str | None = None,
                 residual_floor: float = 0.01,
                 cooldown_steps: int = 10,
                 max_recoveries: int = 0, log=None,
                 interconnect=None, faults: bool = False,
                 wire: dict | None = None, synth: dict | None = None,
                 registry=None):
        self.world = world
        self.ppi = ppi
        self.algorithm = algorithm
        self.topology = topology          # the running graph, for the diff
        # the run's fabric model (planner.InterconnectModel or None), its
        # fault injection, wire codec config and synthesis stamp: the
        # re-plan prices and fences as the launch plan did, and a
        # synthesized run re-enters the synthesizer with its spec
        self.interconnect = interconnect
        self.faults = faults
        self.wire = wire
        self.synth = synth
        self.residual_floor = residual_floor
        self.cooldown_steps = max(0, cooldown_steps)
        self.max_recoveries = max_recoveries
        self.log = log
        # telemetry registry: when set, decisions publish as typed
        # `recovery` events (the compatibility sink renders the line)
        self.registry = registry
        self.recoveries = 0
        self.last_fired_step: int | None = None
        self.events: list[RecoveryEvent] = []

    def replan(self) -> dict:
        """What the planner would run for this world now: ``{topology,
        ppi, gap, global_avg_every, switch}``, ``switch`` True when that
        differs from the running topology (the relaunch hint)."""
        from ..planner import PlanConstraints, plan_for

        plan = plan_for(self.world, ppi=self.ppi, algorithm=self.algorithm,
                        constraints=PlanConstraints(
                            interconnect=self.interconnect,
                            faults=self.faults, wire=self.wire,
                            synth=self.synth))
        return {"topology": plan.topology, "ppi": plan.ppi,
                "gap": round(plan.gap, 6),
                "global_avg_every": plan.global_avg_every,
                "switch": (self.topology is not None
                           and plan.topology != self.topology)}

    def _in_cooldown(self, step: int) -> bool:
        return (self.last_fired_step is not None
                and step - self.last_fired_step < self.cooldown_steps)

    def assess(self, report: HealthReport) -> RecoveryEvent:
        """Turn a health report into a recovery decision (and log it).
        ``action == "global-average"`` tells the trainer to run its
        recovery fn."""
        poisoned = [r for r in report.reasons if r in _POISONED]
        fixable = [r for r in report.reasons if r in _AVERAGEABLE]
        if poisoned:
            # averaging spreads NaN: restoring a checkpoint from before
            # the poison is the only sound repair
            event = RecoveryEvent(report.step, "advise-restore",
                                  tuple(poisoned + fixable), None)
        elif (fixable and not self._in_cooldown(report.step)
              and (self.max_recoveries == 0
                   or self.recoveries < self.max_recoveries)):
            event = RecoveryEvent(report.step, "global-average",
                                  tuple(fixable), self.replan())
            self.recoveries += 1
            self.last_fired_step = report.step
        else:
            event = RecoveryEvent(report.step, "none",
                                  tuple(report.reasons), None)
        if event.action != "none":
            self.events.append(event)
            if self.registry is not None:
                self.registry.emit("recovery", event.to_dict(),
                                   step=report.step, severity="warning")
            elif self.log is not None:
                self.log.warning("gossip recovery: "
                                 + json.dumps(event.to_dict(),
                                              sort_keys=True))
        return event
