"""Typed metrics over a closed vocabulary, Prometheus-ready.

A copy of ``stochastic_gradient_push_tpu/telemetry/metrics.py``.  Every
metric a consumer can derive from the event stream is a registered
constant in :data:`METRIC_NAMES`, and :class:`MetricsRegistry` rejects
anything else at runtime, so a dashboard query cannot dangle.

Three metric types:

* :class:`Counter` — monotone count (``inc``).
* :class:`Gauge` — last-write-wins scalar (``set``).
* :class:`Histogram` — quantiles over a bounded window.  It wraps
  :class:`~..utils.meter.PercentileMeter` rather than reimplementing
  rank selection; :func:`step_time_meter` and
  :func:`request_latency_meter` are the one definition of step-time and
  request-latency percentiles over a trace or an event stream.

Exposition is Prometheus text format (``# HELP``/``# TYPE`` plus
summary-style ``{quantile="..."}`` series for histograms).
"""

from __future__ import annotations

from ..utils.meter import PercentileMeter

__all__ = [
    "METRIC_NAMES", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "step_time_meter", "request_latency_meter",
    "EVENTS_TOTAL", "ALERTS_TOTAL", "STEP_TIME_SECONDS", "LOSS",
    "PS_MASS_ERR", "CONSENSUS_RESIDUAL", "HEARTBEAT_AGE_SECONDS",
    "SERVE_LATENCY_SECONDS", "SERVE_REQUESTS_TOTAL",
    "SERVE_REJECTIONS_TOTAL", "COMM_BYTES", "FLEET_WORLD",
    "FLEET_CYCLES_TOTAL", "RENDEZVOUS_ROUNDS_TOTAL", "HOSTS_ACTIVE",
    "MERGE_LATE_EVENTS_TOTAL",
]

# -- the closed metric-name vocabulary -------------------------------------
# One constant per exportable metric; METRIC_NAMES is the closure, and
# MetricsRegistry raises on any other name.

EVENTS_TOTAL = "sgp_events_total"                  # counter{kind}
ALERTS_TOTAL = "sgp_alerts_total"                  # counter{rule}
STEP_TIME_SECONDS = "sgp_step_time_seconds"        # histogram
LOSS = "sgp_loss"                                  # gauge
PS_MASS_ERR = "sgp_ps_mass_err"                    # gauge
CONSENSUS_RESIDUAL = "sgp_consensus_residual"      # gauge
HEARTBEAT_AGE_SECONDS = "sgp_heartbeat_age_seconds"  # gauge{host}
SERVE_LATENCY_SECONDS = "sgp_serve_latency_seconds"  # histogram
SERVE_REQUESTS_TOTAL = "sgp_serve_requests_total"  # counter
SERVE_REJECTIONS_TOTAL = "sgp_serve_rejections_total"  # counter
COMM_BYTES = "sgp_comm_bytes"                      # gauge{category}
FLEET_WORLD = "sgp_fleet_world"                    # gauge
FLEET_CYCLES_TOTAL = "sgp_fleet_cycles_total"      # counter
RENDEZVOUS_ROUNDS_TOTAL = "sgp_rendezvous_rounds_total"  # counter
HOSTS_ACTIVE = "sgp_hosts_active"                  # gauge
MERGE_LATE_EVENTS_TOTAL = "sgp_merge_late_events_total"  # counter

METRIC_NAMES = frozenset({
    EVENTS_TOTAL, ALERTS_TOTAL, STEP_TIME_SECONDS, LOSS, PS_MASS_ERR,
    CONSENSUS_RESIDUAL, HEARTBEAT_AGE_SECONDS, SERVE_LATENCY_SECONDS,
    SERVE_REQUESTS_TOTAL, SERVE_REJECTIONS_TOTAL, COMM_BYTES,
    FLEET_WORLD, FLEET_CYCLES_TOTAL, RENDEZVOUS_ROUNDS_TOTAL,
    HOSTS_ACTIVE, MERGE_LATE_EVENTS_TOTAL,
})

_HELP = {
    EVENTS_TOTAL: "Typed events ingested, by kind.",
    ALERTS_TOTAL: "SLO alerts fired, by rule.",
    STEP_TIME_SECONDS: "Per-step train time (timed steps only).",
    LOSS: "Last reported training loss.",
    PS_MASS_ERR: "Push-sum mass-conservation error |mean(w) - 1|.",
    CONSENSUS_RESIDUAL: "Last reported consensus residual.",
    HEARTBEAT_AGE_SECONDS: "Event-time since a host's last event.",
    SERVE_LATENCY_SECONDS: "Serve request latency.",
    SERVE_REQUESTS_TOTAL: "Completed serve requests.",
    SERVE_REJECTIONS_TOTAL: "Serve admission rejections.",
    COMM_BYTES: "Per-rank comm bytes from the last comm snapshot.",
    FLEET_WORLD: "Current fleet world size.",
    FLEET_CYCLES_TOTAL: "Committed coordinated reshard cycles.",
    RENDEZVOUS_ROUNDS_TOTAL: "Rendezvous rounds called.",
    HOSTS_ACTIVE: "Hosts not silent past the merge timeout.",
    MERGE_LATE_EVENTS_TOTAL: "Events behind the merge frontier.",
}

# -- metric instances ------------------------------------------------------


class Counter:
    """Monotone counter (one labeled series)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    """Last-write-wins scalar (one labeled series)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Quantiles over a bounded window, with PercentileMeter's
    upper-nearest-rank selection (one definition of p50/p99)."""

    __slots__ = ("meter", "sum")

    def __init__(self, maxlen: int = 65536):
        self.meter = PercentileMeter(maxlen=maxlen)
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.meter.update(v)
        self.sum += float(v)

    @property
    def count(self) -> int:
        return self.meter.count

    @property
    def p50(self) -> float:
        return self.meter.p50

    @property
    def p99(self) -> float:
        return self.meter.p99


_TYPES = {Counter: "counter", Gauge: "gauge", Histogram: "summary"}


class MetricsRegistry:
    """Closed-vocabulary metric families with Prometheus exposition.

    ``counter``/``gauge``/``histogram`` return the (name, labels) series,
    creating it on first use — and raise ``ValueError`` for a name
    outside :data:`METRIC_NAMES` or a name reused at a different type.
    """

    def __init__(self):
        # name -> (cls, {labels-tuple: instance})
        self._families: dict[str, tuple[type, dict]] = {}

    def _series(self, cls, name: str, labels: dict | None):
        if name not in METRIC_NAMES:
            raise ValueError(
                f"unregistered metric name {name!r}; declared names: "
                f"{sorted(METRIC_NAMES)}")
        fam = self._families.setdefault(name, (cls, {}))
        if fam[0] is not cls:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{_TYPES[fam[0]]}, not {_TYPES[cls]}")
        key = tuple(sorted((k, str(v)) for k, v in (labels or {}).items()))
        series = fam[1].get(key)
        if series is None:
            series = fam[1][key] = cls()
        return series

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        return self._series(Counter, name, labels)

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        return self._series(Gauge, name, labels)

    def histogram(self, name: str,
                  labels: dict | None = None) -> Histogram:
        return self._series(Histogram, name, labels)

    # -- exposition --------------------------------------------------------

    @staticmethod
    def _fmt(name: str, key: tuple, value: float,
             extra: tuple | None = None) -> str:
        pairs = list(key) + (list(extra) if extra else [])
        lbl = ("{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"
               if pairs else "")
        if value == int(value):
            return f"{name}{lbl} {int(value)}"
        return f"{name}{lbl} {value:.9g}"

    def exposition(self) -> str:
        """Prometheus text format; histograms export summary-style
        quantile series plus ``_sum``/``_count``."""
        lines = []
        for name in sorted(self._families):
            cls, series = self._families[name]
            lines.append(f"# HELP {name} {_HELP[name]}")
            lines.append(f"# TYPE {name} {_TYPES[cls]}")
            for key in sorted(series):
                inst = series[key]
                if cls is Histogram:
                    for q in (0.5, 0.99):
                        lines.append(self._fmt(
                            name, key, inst.meter.percentile(q * 100),
                            extra=(("quantile", f"{q:g}"),)))
                    lines.append(self._fmt(name + "_sum", key, inst.sum))
                    lines.append(self._fmt(name + "_count", key,
                                           float(inst.count)))
                else:
                    lines.append(self._fmt(name, key, inst.value))
        return "\n".join(lines) + "\n"


# -- shared percentile helpers ---------------------------------------------


def step_time_meter(trace_events, maxlen: int = 65536) -> PercentileMeter:
    """The definition of step-time percentiles: per-step durations of
    timed ``train_step`` 'X' spans (a span of k steps counts k samples
    of dur/k; warm-up spans carry ``timed=False`` and are excluded)."""
    meter = PercentileMeter(maxlen=maxlen, ptag="step")
    for ev in trace_events:
        if ev.get("ph") != "X" or ev.get("name") != "train_step":
            continue
        args = ev.get("args", {})
        if not args.get("timed", True):
            continue
        steps = max(1, int(args.get("steps", 1)))
        per_step = float(ev.get("dur", 0.0)) / 1e6 / steps
        for _ in range(steps):
            meter.update(per_step)
    return meter


def request_latency_meter(request_events,
                          maxlen: int = 65536) -> PercentileMeter:
    """The definition of serve-latency percentiles: ``latency_s`` of
    every typed ``request`` event, in stream order."""
    meter = PercentileMeter(maxlen=maxlen, ptag="request_latency_s")
    for ev in request_events:
        meter.update(float(ev.get("data", {}).get("latency_s", 0.0)))
    return meter
