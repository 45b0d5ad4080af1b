"""Resilience: fault injection, runtime health monitoring, recovery.

Port of ``stochastic_gradient_push_tpu/resilience/``: :mod:`.faults`
injects deterministic, mass-conserving faults at the gossip round;
:mod:`.monitor` computes in-step health signals and emits ``gossip
health:`` lines; :mod:`.recovery` fires an exact global average on a
fixable excursion; :mod:`.chaos` is the drill behind
``scripts/torch_chaos.py`` (imported on its own, as the reference's).
"""

from .faults import FaultEvent, FaultMasks, FaultPlan, parse_fault_spec
from .monitor import HEALTH_KEYS, HealthMonitor, HealthReport, health_signals
from .recovery import (RecoveryEvent, RecoveryPolicy, make_recovery_fn,
                       recover_state)

__all__ = [
    "FaultEvent",
    "FaultMasks",
    "FaultPlan",
    "parse_fault_spec",
    "HEALTH_KEYS",
    "HealthMonitor",
    "HealthReport",
    "health_signals",
    "RecoveryEvent",
    "RecoveryPolicy",
    "make_recovery_fn",
    "recover_state",
]
