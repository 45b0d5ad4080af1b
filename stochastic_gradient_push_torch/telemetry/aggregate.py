"""Fleet-wide event aggregation: N streams -> one ordered timeline,
typed metrics, SLO alerts.

Port of ``stochastic_gradient_push_tpu/telemetry/aggregate.py``: the
same merge, derivations and rules, so on one directory its summary and
alerts are the reference's.  Every host in a fleet writes its own
``events.jsonl`` / ``supervisor.jsonl`` and the pod coordinator writes
``coordinator.jsonl`` — streams that are each ordered but mutually
skewed (different clocks, different flush cadence, a killed host simply
stops).  :class:`FleetAggregator` tails all of them through the
supervisor's rotation-safe :class:`~..supervise.tailer.EventTailer`
(a rotated stream is told by its inode and re-read from byte 0) and
merges them with a **per-stream watermark**: an event is released only
once every live stream's watermark has passed its timestamp, so one
slow host delays the merged view instead of corrupting it.  A stream
whose watermark falls more than ``silence_s`` of *event time* behind
the fleet is left out of the frontier — a dead host must not stall the
merge (the heartbeat-silence rule below turns that silence into an
alert).

Late events (behind the released frontier) are counted and processed,
never dropped: the totals stay exact when a straggler backfills.

Downstream of the merge sit two consumers:

* :class:`MetricsRegistry` derivations — every event increments
  ``sgp_events_total{kind=...}`` and kind-specific counters, gauges and
  histograms from the closed metric vocabulary
  (:mod:`telemetry.metrics`);
* :class:`SloRules` — step-time p99, push-sum mass-conservation error,
  per-host heartbeat silence and serve rejection rate, firing typed
  ``alert`` events into ``fleetmon.jsonl``.  Rules are *episodic*: one
  alert when a signal crosses its threshold, re-armed only after it
  recovers.

Rules run on **event time** (the merged stream's timestamps), never the
wall clock, so :meth:`FleetAggregator.drain` of a finished directory
gives the same summary and alerts however and whenever it runs; only
``poll`` (live mode) sees streams as far as they have been written.
"""

from __future__ import annotations

import dataclasses
import glob
import heapq
import os

from ..supervise.tailer import EventTailer
from . import (COORDINATOR_EVENTS_FILE, EVENTS_FILE,
               SUPERVISOR_EVENTS_FILE, TRACE_FILE)
from .metrics import (ALERTS_TOTAL, COMM_BYTES, CONSENSUS_RESIDUAL,
                      EVENTS_TOTAL, FLEET_CYCLES_TOTAL, FLEET_WORLD,
                      HEARTBEAT_AGE_SECONDS, HOSTS_ACTIVE, LOSS,
                      MERGE_LATE_EVENTS_TOTAL, MetricsRegistry,
                      PS_MASS_ERR, RENDEZVOUS_ROUNDS_TOTAL,
                      SERVE_LATENCY_SECONDS, SERVE_REJECTIONS_TOTAL,
                      SERVE_REQUESTS_TOTAL, STEP_TIME_SECONDS,
                      request_latency_meter, step_time_meter)
from .registry import TelemetryRegistry
from .sink import JsonlSink

__all__ = ["FleetAggregator", "SloThresholds", "SloRules",
           "ALERTS_FILE"]

# the aggregator's own output stream (typed `alert` events) — a name
# outside every tailed pattern, so the plane never reads back its own
# writes (same rule that keeps supervisor.jsonl out of events.jsonl)
ALERTS_FILE = "fleetmon.jsonl"


@dataclasses.dataclass(frozen=True)
class SloThresholds:
    """The rules layer's knobs, all in the signal's native unit."""

    step_time_p99_s: float = 1.0      # timed per-step seconds
    step_time_min_count: int = 20     # samples before p99 is credible
    ps_mass_err: float = 1e-3         # |mean(ps_weight) - 1|
    heartbeat_silence_s: float = 1.0  # event-time gap per host stream
    serve_reject_rate: float = 0.5    # rejections / (requests + rej.)
    serve_min_requests: int = 20


class _Stream:
    __slots__ = ("tailer", "name", "host", "watermark")

    def __init__(self, path: str, name: str, host: int | None):
        self.tailer = EventTailer(path)
        self.name = name
        self.host = host
        self.watermark: float | None = None


class SloRules:
    """Episodic SLO evaluation over the merged, event-time-ordered
    stream; fires typed ``alert`` events through the aggregator."""

    def __init__(self, agg: "FleetAggregator",
                 thresholds: SloThresholds):
        self.agg = agg
        self.thr = thresholds
        self.global_t: float | None = None
        self.last_t: dict[int, float] = {}   # host -> last event t
        self.retired: set[int] = set()       # done/excluded hosts
        self._silent: set[int] = set()
        self._in_cycle = False               # coordinated cycle open
        self._mass_breached = False
        self._step_breached = False
        self._serve_breached = False
        self._requests = 0
        self._rejections = 0

    # -- signal intake ----------------------------------------------------

    def observe(self, ev: dict) -> None:
        t = float(ev.get("t", 0.0))
        self.global_t = t if self.global_t is None \
            else max(self.global_t, t)
        host = ev.get("_host")
        if host is not None:
            self.last_t[host] = max(self.last_t.get(host, t), t)
            self._silent.discard(host)
        kind, data = ev.get("kind"), ev.get("data", {})
        if kind == "health":
            if "ps_mass_err" in data:
                self._check_mass(float(data["ps_mass_err"]), t, host)
        elif kind == "step_stats":
            if data.get("timed", True) and "step_time_s" in data:
                self._check_step(t, host)
        elif kind == "rendezvous":
            phase = data.get("phase")
            if phase == "done" and host is not None:
                self.retired.add(host)
            elif phase == "call":
                # a coordinated cycle is open: the coordinator owns
                # host liveness now (it runs its own silence detection
                # with a deadline) and barrier waits / reshard gaps are
                # EXPECTED silence — suppress the heartbeat rule until
                # the cycle resolves, or it pages for every healthy
                # host sitting at the barrier
                self._in_cycle = True
        elif kind == "fleet":
            phase = data.get("phase")
            if phase == "assign":
                self.retired.update(int(h) for h in
                                    (data.get("excluded") or []))
            elif phase in ("complete", "give-up", "halt"):
                self._in_cycle = False
        elif kind == "serve":
            if data.get("phase") == "reject":
                self._rejections += 1
                self._check_serve(t)
        elif kind == "request":
            self._requests += 1
            self._check_serve(t)
        self._check_silence()

    # -- individual rules --------------------------------------------------

    def _check_mass(self, err: float, t: float, host) -> None:
        if err > self.thr.ps_mass_err:
            if not self._mass_breached:
                self._mass_breached = True
                self.agg.fire("mass-conservation", t, host=host,
                              detail={"ps_mass_err": err,
                                      "threshold": self.thr.ps_mass_err})
        else:
            self._mass_breached = False

    def _check_step(self, t: float, host) -> None:
        h = self.agg.metrics.histogram(STEP_TIME_SECONDS)
        if h.count < self.thr.step_time_min_count:
            return
        if h.p99 > self.thr.step_time_p99_s:
            if not self._step_breached:
                self._step_breached = True
                self.agg.fire("step-time-p99", t, host=host,
                              detail={"p99_s": h.p99,
                                      "threshold":
                                          self.thr.step_time_p99_s})
        else:
            self._step_breached = False

    def _check_serve(self, t: float) -> None:
        total = self._requests + self._rejections
        if total < self.thr.serve_min_requests:
            return
        rate = self._rejections / total
        if rate > self.thr.serve_reject_rate:
            if not self._serve_breached:
                self._serve_breached = True
                self.agg.fire("serve-reject-rate", t, detail={
                    "rate": round(rate, 6),
                    "threshold": self.thr.serve_reject_rate})
        else:
            self._serve_breached = False

    def _check_silence(self) -> None:
        if self.global_t is None or self._in_cycle:
            return
        thr = self.thr.heartbeat_silence_s
        for host, last in self.last_t.items():
            if host in self.retired or host in self._silent:
                continue
            if self.global_t - last > thr:
                self._silent.add(host)
                # at_t is the event-time instant the silence budget ran
                # out, not the time we noticed — replay and live agree
                self.agg.fire("heartbeat-silence", last + thr,
                              host=host, detail={
                                  "last_event_t": last,
                                  "silence_s":
                                      round(self.global_t - last, 6)})

    def finish(self) -> None:
        """End-of-replay check: a host silent at stream end whose gap
        never exceeded the threshold mid-merge still gets flagged."""
        self._check_silence()


class FleetAggregator:
    """Tail every stream of a run/fleet directory; merge, derive, alert.

    ``poll()`` is the live-mode heartbeat (call it on an interval);
    ``drain()`` is replay mode — read every stream to quiescence, then
    release the full buffer in event-time order.  Both feed the same
    metric derivations and SLO rules, on event time only.
    """

    def __init__(self, run_dir: str, *,
                 thresholds: SloThresholds | None = None,
                 silence_s: float = 2.0, rank: int = 0,
                 write_alerts: bool = True):
        self.run_dir = run_dir
        self.silence_s = float(silence_s)
        self.metrics = MetricsRegistry()
        self._streams: dict[str, _Stream] = {}
        self._heap: list[tuple[float, int, dict]] = []
        self._seq = 0
        self._released: float | None = None   # last released event t
        self.emitted = 0
        self.late_events = 0
        self.alerts: list[dict] = []
        self.comm_last: dict | None = None
        self.run_meta: dict | None = None
        self.fleet_outcome: str | None = None
        self._request_events: list[dict] = []
        sinks = [JsonlSink(os.path.join(run_dir, ALERTS_FILE))] \
            if write_alerts else []
        self._alert_registry = TelemetryRegistry(rank=rank, sinks=sinks)
        self.rules = SloRules(self, thresholds or SloThresholds())

    # -- stream discovery --------------------------------------------------

    def _discover(self) -> None:
        """(Re-)glob the directory — late-appearing streams (a host that
        joins, a rank file created at first emit) enter the merge on the
        next poll instead of requiring a restart."""
        base, ext = os.path.splitext(EVENTS_FILE)
        patterns = [EVENTS_FILE, f"{base}_r*{ext}",
                    SUPERVISOR_EVENTS_FILE, COORDINATOR_EVENTS_FILE,
                    os.path.join("host*", EVENTS_FILE),
                    os.path.join("host*", SUPERVISOR_EVENTS_FILE)]
        for pat in patterns:
            for path in sorted(glob.glob(
                    os.path.join(self.run_dir, pat))):
                name = os.path.relpath(path, self.run_dir)
                if name not in self._streams:
                    self._streams[name] = _Stream(
                        path, name, self._host_of(name))

    @staticmethod
    def _host_of(name: str) -> int | None:
        head = name.split(os.sep)[0]
        if head.startswith("host") and head[4:].isdigit():
            return int(head[4:])
        return None

    @property
    def streams(self) -> list[str]:
        return sorted(self._streams)

    # -- watermark merge ---------------------------------------------------

    def _frontier(self) -> float | None:
        """Min watermark over live streams; silent streams (event-time
        lag > silence_s behind the fleet max) are excluded so a dead
        host cannot stall everyone else's view."""
        marks = [s.watermark for s in self._streams.values()
                 if s.watermark is not None]
        if not marks:
            return None
        gmax = max(marks)
        return min(m for m in marks if gmax - m <= self.silence_s)

    def _ingest(self) -> int:
        self._discover()
        new = 0
        for s in self._streams.values():
            for ev in s.tailer.poll():
                t = float(ev.get("t", 0.0))
                if s.host is not None:
                    ev["_host"] = s.host
                ev["_stream"] = s.name
                s.watermark = t if s.watermark is None \
                    else max(s.watermark, t)
                if self._released is not None and t < self._released:
                    self.late_events += 1
                    self.metrics.counter(MERGE_LATE_EVENTS_TOTAL).inc()
                heapq.heappush(self._heap, (t, self._seq, ev))
                self._seq += 1
                new += 1
        return new

    def poll(self) -> int:
        """Live mode: ingest whatever every stream has appended, then
        release (consume) all buffered events up to the frontier.
        Returns the number of events released this call."""
        self._ingest()
        frontier = self._frontier()
        released = 0
        while self._heap and frontier is not None \
                and self._heap[0][0] <= frontier:
            released += 1
            self._consume(heapq.heappop(self._heap)[2])
        self._update_active_gauges()
        return released

    def drain(self) -> int:
        """Replay mode: read every stream to quiescence, then release
        the ENTIRE buffer in event-time order (no frontier — nothing
        more is coming).  Returns total events released."""
        while self._ingest():
            pass
        released = 0
        while self._heap:
            released += 1
            self._consume(heapq.heappop(self._heap)[2])
        self.rules.finish()
        self._update_active_gauges()
        return released

    # -- derivations -------------------------------------------------------

    def _consume(self, ev: dict) -> None:
        self.emitted += 1
        t = float(ev.get("t", 0.0))
        self._released = t if self._released is None \
            else max(self._released, t)
        kind, data = ev.get("kind", "?"), ev.get("data", {})
        m = self.metrics
        m.counter(EVENTS_TOTAL, {"kind": kind}).inc()
        if kind == "run_meta":
            if self.run_meta is None:
                self.run_meta = data
            if "world" in data:
                m.gauge(FLEET_WORLD).set(float(data["world"]))
        elif kind == "step_stats":
            if "loss" in data:
                m.gauge(LOSS).set(float(data["loss"]))
            if data.get("timed", True) and "step_time_s" in data:
                m.histogram(STEP_TIME_SECONDS).observe(
                    float(data["step_time_s"]))
        elif kind == "health":
            if "ps_mass_err" in data:
                m.gauge(PS_MASS_ERR).set(float(data["ps_mass_err"]))
            if "consensus_residual" in data:
                m.gauge(CONSENSUS_RESIDUAL).set(
                    float(data["consensus_residual"]))
        elif kind == "comm":
            self.comm_last = data
            for cat, nbytes in (data.get("bytes") or {}).items():
                m.gauge(COMM_BYTES, {"category": cat}).set(
                    float(nbytes))
        elif kind == "fleet":
            phase = data.get("phase")
            if phase == "go":
                m.counter(FLEET_CYCLES_TOTAL).inc()
            if phase in ("start", "assign", "go") and "world" in data:
                m.gauge(FLEET_WORLD).set(float(data["world"]))
            if phase in ("complete", "give-up", "halt"):
                self.fleet_outcome = phase
        elif kind == "rendezvous":
            if data.get("phase") == "call":
                m.counter(RENDEZVOUS_ROUNDS_TOTAL).inc()
        elif kind == "serve":
            if data.get("phase") == "reject":
                m.counter(SERVE_REJECTIONS_TOTAL).inc()
        elif kind == "request":
            m.counter(SERVE_REQUESTS_TOTAL).inc()
            if "latency_s" in data:
                m.histogram(SERVE_LATENCY_SECONDS).observe(
                    float(data["latency_s"]))
            self._request_events.append(ev)
        self.rules.observe(ev)
        # per-host heartbeat age, in event time against the merge's view
        gt = self.rules.global_t
        if gt is not None:
            for host, last in self.rules.last_t.items():
                m.gauge(HEARTBEAT_AGE_SECONDS,
                        {"host": host}).set(round(gt - last, 6))

    def _update_active_gauges(self) -> None:
        rules = self.rules
        active = [h for h in rules.last_t
                  if h not in rules.retired and h not in rules._silent]
        self.metrics.gauge(HOSTS_ACTIVE).set(float(len(active)))

    # -- alert fan-out -----------------------------------------------------

    def fire(self, rule: str, at_t: float, host: int | None = None,
             detail: dict | None = None) -> None:
        data = {"rule": rule, "at_t": round(float(at_t), 6)}
        if host is not None:
            data["host"] = int(host)
        if detail:
            data.update(detail)
        self.metrics.counter(ALERTS_TOTAL, {"rule": rule}).inc()
        self.alerts.append(data)
        self._alert_registry.emit("alert", data, severity="warning")

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """The run summary fleetmon prints and serves.  Step-time and
        serve percentiles go through the shared helpers obsreport uses
        (telemetry.metrics), over the same inputs (the run's trace.json
        and its typed request stream), so the two agree exactly."""
        trace_events = []
        trace_path = os.path.join(self.run_dir, TRACE_FILE)
        if os.path.isfile(trace_path):
            import json

            with open(trace_path) as f:
                doc = json.load(f)
            trace_events = doc.get("traceEvents", [])
        step = step_time_meter(trace_events)
        lat = request_latency_meter(self._request_events)
        counts = {}
        fam = self.metrics._families.get(EVENTS_TOTAL)
        if fam:
            for key, c in fam[1].items():
                counts[dict(key).get("kind", "?")] = int(c.value)
        return {
            "run_dir": self.run_dir,
            "streams": self.streams,
            "events": dict(sorted(counts.items())),
            "events_released": self.emitted,
            "late_events": self.late_events,
            "step_time": {
                "timed_steps": step.count,
                "p50_s": round(step.p50, 6),
                "p99_s": round(step.p99, 6),
            },
            "serving": {
                "requests_observed": len(self._request_events),
                "p50_latency_s": round(lat.p50, 6),
                "p99_latency_s": round(lat.p99, 6),
            },
            "comm": self.comm_last,
            "fleet_outcome": self.fleet_outcome,
            "hosts_retired": sorted(self.rules.retired),
            "hosts_silent": sorted(self.rules._silent),
            "alerts": list(self.alerts),
        }

    def close(self) -> None:
        self._alert_registry.close()
