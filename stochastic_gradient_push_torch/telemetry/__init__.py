"""telemetry/ — structured tracing, events and comm accounting of a run.

Port of ``stochastic_gradient_push_tpu/telemetry/`` (its ``__init__``,
``registry``, ``sink``, ``tracer``, ``metrics`` and ``comm``), with no
import of jax or of the reference package.  One bundle per run
(:class:`RunTelemetry`): a host span tracer writing
``<trace_dir>/trace.json`` (Chrome-trace/Perfetto), a typed event
registry writing ``<trace_dir>/events.jsonl`` under one versioned schema
(the ``gossip plan/health/recovery:`` lines kept as a compatibility
view), and a comm-volume accountant pricing the active plan in bytes.
The reference's ``scripts/obsreport.py`` reads the directory (it needs
jax; ``chip_smoke.py`` checks the files on the card itself).

Disabled (no ``--trace_dir``) the whole subsystem is
:data:`NULL_TELEMETRY`: a singleton of constant no-ops — no clock read,
no allocation, no device sync added to the train loop.  Enabled, it adds
host dictionary work only: spans reuse the loop's own clock readings and
the comm tally is integer math.

Under ``torchrun`` every process writes its own files (``_rank_file``:
``trace_r1.json``, ``events_r1.jsonl``, ...), process 0 the canonical
names.
"""

from __future__ import annotations

import os

from .comm import (
    COMM_CATEGORIES,
    CommAccountant,
    CommModel,
    allreduce_bytes,
    encoded_payload_bytes,
    tree_payload_bytes,
)
from .metrics import (
    METRIC_NAMES,
    MetricsRegistry,
    request_latency_meter,
    step_time_meter,
)
from .registry import (
    EVENT_KINDS,
    LEGACY_PREFIXES,
    SCHEMA_VERSION,
    TelemetryRegistry,
)
from .sink import JsonlSink, LoggerCompatSink, MemorySink
from .tracer import NULL_TRACER, SPAN_PHASES, NullTracer, SpanTracer
from .tracer import _NULL_SPAN

__all__ = [
    "RunTelemetry", "make_run_telemetry", "NULL_TELEMETRY",
    "SpanTracer", "NullTracer", "NULL_TRACER", "SPAN_PHASES",
    "TelemetryRegistry", "SCHEMA_VERSION", "EVENT_KINDS",
    "LEGACY_PREFIXES", "JsonlSink", "LoggerCompatSink", "MemorySink",
    "CommModel", "CommAccountant", "tree_payload_bytes",
    "encoded_payload_bytes", "allreduce_bytes", "COMM_CATEGORIES",
    "METRIC_NAMES", "MetricsRegistry", "step_time_meter",
    "request_latency_meter",
    "TRACE_FILE", "EVENTS_FILE", "SUPERVISOR_EVENTS_FILE",
    "COORDINATOR_EVENTS_FILE",
]

TRACE_FILE = "trace.json"
EVENTS_FILE = "events.jsonl"
# the reference's run-supervisor and pod-coordinator streams (not ported:
# the names are kept so a directory reads the same)
SUPERVISOR_EVENTS_FILE = "supervisor.jsonl"
COORDINATOR_EVENTS_FILE = "coordinator.jsonl"


def _rank_file(name: str, rank: int) -> str:
    """Per-process artifact name: rank 0 keeps the canonical filename,
    other processes get an ``_rN`` suffix, so processes sharing one
    ``--trace_dir`` neither clobber each other's trace nor interleave
    one events file."""
    if not rank:
        return name
    base, ext = os.path.splitext(name)
    return f"{base}_r{rank}{ext}"


class RunTelemetry:
    """One run's live telemetry: tracer + registry (+ comm accountant).

    Created by the run layer (or the Trainer, for library users) when a
    trace directory is configured; the same registry instance is shared
    by the planner, the resilience monitor and policy, the step watchdog
    and the train loop, so every producer lands in one ``events.jsonl``.
    """

    enabled = True

    def __init__(self, trace_dir: str, rank: int = 0, log=None,
                 metrics_every: int = 0):
        os.makedirs(trace_dir, exist_ok=True)
        self.trace_dir = trace_dir
        self.rank = int(rank)
        self.metrics_every = max(0, int(metrics_every))
        self.tracer = SpanTracer(rank=rank)
        sinks = [JsonlSink(os.path.join(trace_dir,
                                        _rank_file(EVENTS_FILE, rank)))]
        self._compat = None
        if log is not None:
            # the compatibility view: `gossip <kind>:` lines keep
            # flowing to the logger the producers use without a registry
            self._compat = LoggerCompatSink(log)
            sinks.append(self._compat)
        self.registry = TelemetryRegistry(rank=rank, sinks=sinks)
        self.comm: CommAccountant | None = None
        self._finished = False

    def route_legacy(self, kinds, log) -> None:
        """Send the compatibility lines of ``kinds`` to ``log`` (the
        logger their producer uses without a registry, so each line is
        the one printed without telemetry, prefix included)."""
        if self._compat is not None:
            self._compat.route(kinds, log)

    # -- tracer passthrough (the loop's hot-path surface) ------------------

    def span(self, name, phase="step", args=None):
        return self.tracer.span(name, phase, args)

    def trace_complete(self, name, phase, start, dur, args=None):
        self.tracer.complete(name, phase, start, dur, args)

    # -- comm accounting ---------------------------------------------------

    def attach_comm(self, model: CommModel) -> CommAccountant:
        """Install the run's comm accountant."""
        self.comm = CommAccountant(model)
        return self.comm

    def emit_comm(self, step: int | None = None) -> None:
        if self.comm is not None:
            self.registry.emit("comm", self.comm.snapshot(), step=step)

    # -- lifecycle ---------------------------------------------------------

    def finish(self, step: int | None = None) -> None:
        """Write ``trace.json``, emit the final comm snapshot, close the
        sinks.  Idempotent — safe to call from a ``finally`` and again at
        process exit."""
        if self._finished:
            return
        self._finished = True
        self.emit_comm(step=step)
        self.tracer.write(os.path.join(
            self.trace_dir, _rank_file(TRACE_FILE, self.rank)))
        self.registry.close()


class _NullTelemetry:
    """Disabled telemetry: constant no-ops, one shared instance."""

    enabled = False
    tracer = NULL_TRACER
    registry = None
    comm = None
    metrics_every = 0
    trace_dir = None

    __slots__ = ()

    def route_legacy(self, kinds, log):
        pass

    def span(self, name, phase="step", args=None):
        return _NULL_SPAN

    def trace_complete(self, name, phase, start, dur, args=None):
        pass

    def attach_comm(self, model):
        return None

    def emit_comm(self, step=None):
        pass

    def finish(self, step=None):
        pass


NULL_TELEMETRY = _NullTelemetry()


def make_run_telemetry(trace_dir: str | None, rank: int = 0, log=None,
                       metrics_every: int = 0):
    """The single construction point: a live :class:`RunTelemetry` when
    ``trace_dir`` is set, else the shared :data:`NULL_TELEMETRY`."""
    if not trace_dir:
        return NULL_TELEMETRY
    return RunTelemetry(trace_dir, rank=rank, log=log,
                        metrics_every=metrics_every)
