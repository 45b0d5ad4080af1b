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

The reference also asks its topology planner for a re-plan on every
firing; the planner is not ported (ROADMAP.md Queue 1 item 6), so the
port's events carry no ``suggestion`` (``to_dict`` omits it, as the
reference does for None) and :meth:`RecoveryPolicy.replan` raises.
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
    suggestion: dict | None  # planner re-plan; None until the planner exists

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
                 faults: bool = False, wire: dict | None = None):
        self.world = world
        self.ppi = ppi
        self.algorithm = algorithm
        self.topology = topology
        self.faults = faults
        self.wire = wire
        self.residual_floor = residual_floor
        self.cooldown_steps = max(0, cooldown_steps)
        self.max_recoveries = max_recoveries
        self.log = log
        self.recoveries = 0
        self.last_fired_step: int | None = None
        self.events: list[RecoveryEvent] = []

    def replan(self) -> dict:
        """The reference asks its topology planner what it would run for
        this world now; the planner is not ported."""
        raise NotImplementedError(
            "RecoveryPolicy.replan needs the topology planner "
            "(planner.plan_for), which is not ported to "
            "stochastic_gradient_push_torch yet (ROADMAP.md Queue 1 "
            "item 6)")

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
                                  tuple(fixable), None)
            self.recoveries += 1
            self.last_fired_step = report.step
        else:
            event = RecoveryEvent(report.step, "none",
                                  tuple(report.reasons), None)
        if event.action != "none":
            self.events.append(event)
            if self.log is not None:
                self.log.warning("gossip recovery: "
                                 + json.dumps(event.to_dict(),
                                              sort_keys=True))
        return event
