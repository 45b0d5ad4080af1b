"""Typed, versioned event registry: one schema for the whole run.

A copy of ``stochastic_gradient_push_tpu/telemetry/registry.py``.  Every
producer (train loop, resilience monitor, recovery policy, planner, step
watchdog, comm accountant) calls :meth:`TelemetryRegistry.emit` with a
declared ``kind``, and the attached sinks fan the event out — to
``events.jsonl`` (:class:`~.sink.JsonlSink`) and, for the legacy kinds,
back to the ``gossip <kind>: {json}`` line format
(:class:`~.sink.LoggerCompatSink`), so grep pipelines and tests that
read those lines keep working unchanged.

Event envelope (schema version |SCHEMA_VERSION|)::

    {"v": 1, "kind": "health", "t": <unix s>, "rank": 0,
     "severity": "info"|"warning"|"error", "step": 123, "data": {...}}

``data`` is the producer's payload, verbatim — for the legacy kinds it
is what the direct lines carried, which is what makes the compatibility
view exact.
"""

from __future__ import annotations

import time

__all__ = ["TelemetryRegistry", "SCHEMA_VERSION", "EVENT_KINDS",
           "LEGACY_PREFIXES", "SEVERITIES"]

SCHEMA_VERSION = 1

# the closed vocabulary of event kinds; emit() rejects anything else so a
# typo'd producer fails its own test instead of minting a private schema
EVENT_KINDS = frozenset({
    "run_meta",     # one per run: world/algorithm/knobs snapshot
    "plan",         # launch-time topology plan (planner.resolve_topology)
    "health",       # consensus health snapshot (resilience.HealthMonitor)
    "recovery",     # recovery decision (resilience.RecoveryPolicy)
    "heartbeat",    # step-watchdog stall (utils.profiling.StepWatchdog)
    "step_stats",   # periodic loop stats (loss, step/data time)
    "comm",         # comm-volume accounting snapshot (telemetry.comm)
    "bench",        # benchmark artifact lines
    "supervisor",   # run-supervisor lifecycle decision
    "relaunch",     # one generation boundary: reshard + replan + respawn
    "rendezvous",   # fleet host<->coordinator barrier protocol message
    "fleet",        # pod-coordinator decision (assign/go/complete/halt)
    "serve",        # serving-stack lifecycle (reject/summary)
    "request",      # one completed serve request (typed-only)
    "alert",        # SLO rule firing (typed-only)
})

SEVERITIES = ("info", "warning", "error")

# kinds that exist as `gossip <kind>: {json}` stdout lines;
# LoggerCompatSink re-emits them in that format
LEGACY_PREFIXES = {
    "plan": "gossip plan",
    "health": "gossip health",
    "recovery": "gossip recovery",
    "supervisor": "gossip supervisor",
    "rendezvous": "gossip rendezvous",
    "fleet": "gossip fleet",
    "serve": "gossip serve",
}


class TelemetryRegistry:
    """Fan-out point for typed events; producers emit, sinks consume."""

    def __init__(self, rank: int = 0, sinks=(), clock=time.time):
        self.rank = int(rank)
        self._sinks = list(sinks)
        self._clock = clock
        self.counts: dict[str, int] = {}

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def emit(self, kind: str, data: dict, step: int | None = None,
             severity: str = "info") -> dict:
        """Validate, envelope, and fan out one event; returns the event.

        Raises ``ValueError`` on an undeclared kind or severity and
        ``TypeError`` on a non-dict payload — the schema is the contract.
        """
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown event kind {kind!r}; declared kinds: "
                f"{sorted(EVENT_KINDS)}")
        if severity not in SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}; "
                             f"use one of {SEVERITIES}")
        if not isinstance(data, dict):
            raise TypeError(f"event data must be a dict, got "
                            f"{type(data).__name__}")
        ev = {"v": SCHEMA_VERSION, "kind": kind,
              "t": round(self._clock(), 6), "rank": self.rank,
              "severity": severity, "data": data}
        if step is not None:
            ev["step"] = int(step)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        for s in self._sinks:
            s.write(ev)
        return ev

    def close(self) -> None:
        for s in self._sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()
