"""Host-side span tracer exporting Chrome-trace / Perfetto JSON.

A copy of ``stochastic_gradient_push_tpu/telemetry/tracer.py``: wall-clock
spans around the loop's phases (data fetch, step, checkpoint I/O,
validation, recovery averages), written as a ``trace.json`` that
chrome://tracing and ui.perfetto.dev load, keyed by rank (pid) and phase
(tid).  It is the host view beside ``torch.profiler``'s device view
(``--profile_dir``).

Two invariants the train loop relies on:

* **Zero overhead when disabled.**  :data:`NULL_TRACER` is a singleton
  whose :meth:`~NullTracer.span` returns one shared no-op context
  manager: no clock read, no allocation.
* **Zero added syncs when enabled.**  :meth:`SpanTracer.complete`
  records a span from timestamps the caller *already took* for its own
  meters — the hot loop takes no extra clock read, let alone a device
  sync, on the tracer's behalf.  Only the out-of-loop spans
  (checkpoint, eval, recovery, the LM's metrics fetch) read the clock
  themselves.
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["SpanTracer", "NullTracer", "NULL_TRACER", "SPAN_PHASES"]

# the span taxonomy: every event lands on one of these phase tracks
# (Chrome-trace tid)
SPAN_PHASES = ("data", "step", "gossip", "global_avg", "checkpoint",
               "eval", "recovery", "bench", "serve", "request")


class _NullSpan:
    """Shared no-op context manager (one instance per process)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call is a constant-time no-op."""

    enabled = False

    __slots__ = ()

    def span(self, name, phase="step", args=None):
        return _NULL_SPAN

    def complete(self, name, phase, start, dur, args=None):
        pass

    def instant(self, name, phase="step", args=None):
        pass

    def to_chrome(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write(self, path):
        pass


NULL_TRACER = NullTracer()


class _Span:
    """Live span: records one complete ('X') event on exit."""

    __slots__ = ("_tracer", "_name", "_phase", "_args", "_t0")

    def __init__(self, tracer, name, phase, args):
        self._tracer = tracer
        self._name = name
        self._phase = phase
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        self._tracer.complete(self._name, self._phase, self._t0,
                              t1 - self._t0, self._args)
        return False


class SpanTracer:
    """Collects host spans; exports one Chrome-trace JSON per run.

    The clock is ``time.time`` by default so the train loop can feed
    :meth:`complete` the wall-clock timestamps it already measures for
    its meters (one clock domain, no extra reads in the hot path).
    Timestamps are exported relative to the tracer's creation and sorted,
    so the emitted trace is monotone even if the wall clock steps.
    """

    enabled = True

    def __init__(self, rank: int = 0, clock=time.time):
        self.rank = int(rank)
        self._clock = clock
        self._epoch = clock()
        # (name, phase, start_s, dur_s, args-or-None); tuples keep the
        # per-span cost to one append
        self._events: list[tuple] = []

    def __len__(self) -> int:
        return len(self._events)

    def now(self) -> float:
        """The tracer's clock (for callers pairing with complete())."""
        return self._clock()

    def span(self, name: str, phase: str = "step", args: dict | None = None):
        """Context manager timing the enclosed block as one span."""
        return _Span(self, name, phase, args)

    def complete(self, name: str, phase: str, start: float, dur: float,
                 args: dict | None = None) -> None:
        """Record a span from caller-measured (start, duration) seconds
        in this tracer's clock domain."""
        self._events.append((name, phase, start, dur, args))

    def instant(self, name: str, phase: str = "step",
                args: dict | None = None) -> None:
        """Zero-duration marker event."""
        self._events.append((name, phase, self._clock(), 0.0, args))

    def durations(self, name: str) -> list[float]:
        """Recorded durations (seconds) of every span named ``name``."""
        return [e[3] for e in self._events if e[0] == name]

    def to_chrome(self) -> dict:
        """Chrome-trace object: ``{"traceEvents": [...]}``.

        Events are 'X' (complete) records with microsecond ``ts``/``dur``
        relative to tracer creation, ``pid`` = rank, ``tid`` = the
        span's phase track, plus process/thread-name metadata so the
        Perfetto UI labels the tracks.  The list is sorted by ``ts`` and
        negative offsets (wall-clock steps) clamp to 0, so timestamps are
        monotone by construction.
        """
        tids = {p: i for i, p in enumerate(SPAN_PHASES)}
        out = [{
            "name": "process_name", "ph": "M", "pid": self.rank, "tid": 0,
            "args": {"name": f"rank {self.rank}"},
        }]
        seen_phases = []
        events = []
        for name, phase, start, dur, args in self._events:
            tid = tids.setdefault(phase, len(tids))
            if phase not in seen_phases:
                seen_phases.append(phase)
            ev = {
                "name": name, "cat": phase, "ph": "X",
                "ts": max(0.0, round((start - self._epoch) * 1e6, 1)),
                "dur": max(0.0, round(dur * 1e6, 1)),
                "pid": self.rank, "tid": tid,
            }
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        events.sort(key=lambda e: e["ts"])
        for phase in seen_phases:
            out.append({
                "name": "thread_name", "ph": "M", "pid": self.rank,
                "tid": tids[phase], "args": {"name": phase},
            })
        out.extend(events)
        # epoch_s anchors this trace's ts=0 on the wall clock, so traces
        # of several processes can be laid on one timeline
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "epoch_s": round(self._epoch, 6)}

    def write(self, path: str) -> None:
        """Write the trace to ``path`` atomically (write + rename)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)
