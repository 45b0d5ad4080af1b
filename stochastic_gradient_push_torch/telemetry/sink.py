"""Event sinks: JSONL file, legacy-line compatibility view, memory.

A copy of ``stochastic_gradient_push_tpu/telemetry/sink.py``.  Sinks
implement one method, ``write(event)``, taking the enveloped dict built
by :meth:`~.registry.TelemetryRegistry.emit`; ``close()`` is optional.
The step watchdog emits from its timer thread, so the file sink
serializes writes under a lock; the logging module is already
thread-safe.
"""

from __future__ import annotations

import json
import os
import threading

from .registry import LEGACY_PREFIXES

__all__ = ["JsonlSink", "LoggerCompatSink", "MemorySink"]


class JsonlSink:
    """Appends one JSON line per event to ``path`` (created lazily).

    Each write is flushed, so a killed run still leaves a parseable
    ``events.jsonl`` behind.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._lock = threading.Lock()

    def write(self, event: dict) -> None:
        line = json.dumps(event, sort_keys=True, default=float)
        with self._lock:
            if self._f is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._f = open(self.path, "a")
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class LoggerCompatSink:
    """Compatibility view: the ``gossip <kind>: {json}`` log lines.

    Consumers (grep pipelines, ``chip_smoke.py``, tests asserting on
    ``gossip health:`` lines) parse ``<prefix>: {sorted json}`` off
    stdout.  This sink re-emits exactly that for the legacy kinds — the
    payload is the event's ``data`` verbatim — at warning for a warning
    or error event, and stays silent for other kinds.  ``route`` sends a
    kind's lines to another logger: the one its producer logs through
    without a registry, so the line keeps its prefix too.
    """

    def __init__(self, log):
        self.log = log
        self._logs: dict = {}

    def route(self, kinds, log) -> None:
        for kind in kinds:
            self._logs[kind] = log

    def write(self, event: dict) -> None:
        kind = event.get("kind")
        prefix = LEGACY_PREFIXES.get(kind)
        if prefix is None:
            return
        line = f"{prefix}: " + json.dumps(event["data"], sort_keys=True,
                                          default=float)
        log = self._logs.get(kind, self.log)
        if event.get("severity") in ("warning", "error"):
            log.warning(line)
        else:
            log.info(line)


class MemorySink:
    """Collects events in a list (tests)."""

    def __init__(self):
        self.events: list[dict] = []

    def write(self, event: dict) -> None:
        self.events.append(event)

    def by_kind(self, kind: str) -> list[dict]:
        return [e for e in self.events if e.get("kind") == kind]
