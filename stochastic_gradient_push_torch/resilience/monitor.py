"""Runtime consensus health: in-step signals and a host-side monitor.

Port of ``stochastic_gradient_push_tpu/resilience/monitor.py``:

* :func:`health_signals` — cheap reductions over the ranks of a
  transport, computed after ``post_step``: push-sum weight min/max, the
  total-mass error ``|Σw/n − 1|``, non-finite counts of the params and
  the grads, a consensus residual on a probe of the de-biased params
  (``‖x − x̄‖`` over the first ``probe_slots`` values of the largest
  leaf) and, with error feedback, the residual's RMS.  Each is the same
  on every rank.
* :class:`HealthMonitor` — consumes the fetched signals, emits
  ``gossip health: {json}`` lines (sorted keys) every ``health_every``
  steps and at once on an excursion, tracks step-time p50/p99 in a
  bounded :class:`~..utils.meter.PercentileMeter`, and flags excursions
  for the recovery policy with the reference's reasons and floors.

The probe is the reference's: the largest leaf, ties broken by the
reference's tree order, its first values read in the reference's layout
(a :class:`~..parallel.wire.ReferenceLayout`; without one, the port's
own order and layout).  Under overlap the signals see the *drained*
view: in-flight mass is not a leak.
"""

from __future__ import annotations

import dataclasses
import json
import typing as tp

import torch

from ..utils.meter import PercentileMeter

__all__ = ["health_signals", "host_signals", "HealthMonitor",
           "HealthReport", "HEALTH_KEYS", "EF_HEALTH_KEY"]

# every key health_signals emits, in the order the line reports them
HEALTH_KEYS = ("consensus_residual", "ps_w_min", "ps_w_max", "ps_mass_err",
               "nonfinite_params", "nonfinite_grads")

# emitted only by runs whose wire runs error feedback
EF_HEALTH_KEY = "ef_residual_rms"

# EF residual RMS above this is an excursion: parameters are O(1) and a
# healthy int8 residual sits 2-3 orders of magnitude below
DEFAULT_EF_RESIDUAL_FLOOR = 0.1

DEFAULT_PROBE_SLOTS = 256

# a push-sum weight this close to zero means the rank has stopped
# receiving mass
DEFAULT_PS_WEIGHT_FLOOR = 1e-2

# tolerance on |Σw/n - 1|: float32 gossip keeps the total exact to
# ~1e-6/round, so anything past this is a real leak
DEFAULT_MASS_TOL = 1e-3


def _probe(params: dict, layout) -> torch.Tensor:
    """The probe leaf ``[R, n]`` raveled in the reference's layout: the
    largest leaf, ties broken by the reference's tree order."""
    if not params:
        raise ValueError("health_signals needs at least one param leaf")
    order = list(layout.order) if layout is not None else list(params)
    best = max(range(len(order)), key=lambda i: params[order[i]][0].numel())
    name = order[best]
    leaf = params[name]
    perm = layout.perm(name) if layout is not None else None
    if perm is not None:
        leaf = leaf.permute(0, *(d + 1 for d in perm))
    return leaf.reshape(leaf.shape[0], -1)


def health_signals(params: dict, grads: dict | None, ps_weight, transport,
                   probe_slots: int = DEFAULT_PROBE_SLOTS,
                   ef_residual: dict | None = None, in_flight=None,
                   layout=None) -> dict:
    """The health reductions over ``transport``'s ranks, for
    rank-stacked ``params``/``grads`` and the ``[R]`` ps-weight, after
    ``post_step``.  Returns float32 0-dim tensors, each the same for
    every rank.  ``in_flight`` (the overlap FIFO) is drained into the
    view first; ``layout`` (a :class:`~..parallel.wire.ReferenceLayout`)
    picks the probe as the reference does."""
    if in_flight:
        from ..algorithms.algorithms import drain_in_flight

        params, ps_weight, _ = drain_in_flight(params, ps_weight,
                                               in_flight)
    world = transport.world_size
    w = ps_weight.reshape(-1).to(torch.float32)

    def psum(x: torch.Tensor) -> torch.Tensor:
        return transport.allreduce_sum(x.reshape(1, -1)
                                       if x.dim() == 0 else x)[0]

    def nonfinite_count(tree) -> torch.Tensor:
        total = torch.zeros(w.shape[0], dtype=torch.float32,
                            device=w.device)
        for leaf in tree.values():
            bad = ~torch.isfinite(leaf.to(torch.float32))
            total = total + bad.reshape(bad.shape[0], -1).sum(1).to(
                torch.float32)
        return psum(total)

    probe = _probe(params, layout)
    slots = min(probe_slots, probe.shape[1])
    probe = probe[:, :slots].to(torch.float32) / w[:, None]  # de-biased
    center = psum(probe) / world
    sq = ((probe - center) ** 2).sum(1)
    residual = torch.sqrt(psum(sq) / (world * slots))
    out = {
        "consensus_residual": residual,
        "ps_w_min": transport.allreduce_min(w)[0],
        "ps_w_max": transport.allreduce_max(w)[0],
        "ps_mass_err": torch.abs(psum(w) / world - 1.0),
        "nonfinite_params": nonfinite_count(params),
        "nonfinite_grads": (nonfinite_count(grads) if grads is not None
                            else torch.zeros((), dtype=torch.float32,
                                             device=w.device)),
    }
    if ef_residual is not None:
        sq = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
        n_el = 0
        for leaf in ef_residual.values():
            x = leaf.to(torch.float32)
            sq = sq + (x * x).reshape(x.shape[0], -1).sum(1)
            n_el += leaf[0].numel()
        out[EF_HEALTH_KEY] = torch.sqrt(psum(sq) / (world * max(1, n_el)))
    return out


def host_signals(metrics: dict) -> dict | None:
    """A step's health signals as host floats (one read), or None for a
    step built without them."""
    if any(k not in metrics for k in HEALTH_KEYS):
        return None
    keys = HEALTH_KEYS + ((EF_HEALTH_KEY,) if EF_HEALTH_KEY in metrics
                          else ())
    # every signal is the same on every rank
    vals = torch.stack([metrics[k].reshape(-1)[0].float()
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """One observed health snapshot plus the monitor's verdict."""

    step: int
    payload: dict
    reasons: tuple[str, ...]

    @property
    def unhealthy(self) -> bool:
        return bool(self.reasons)


class HealthMonitor:
    """Host-side consumer of :func:`health_signals` outputs.

    Emits one ``gossip health: {json}`` line every ``health_every``
    observed steps, and at once on any excursion.  ``last_payload`` is
    what the trainer stamps into checkpoint metadata."""

    def __init__(self, health_every: int = 100,
                 residual_floor: float = 0.01,
                 mass_tol: float = DEFAULT_MASS_TOL,
                 ps_weight_floor: float = DEFAULT_PS_WEIGHT_FLOOR,
                 log=None, step_window: int = 1024,
                 ef_residual_floor: float = DEFAULT_EF_RESIDUAL_FLOOR,
                 registry=None):
        if health_every < 1:
            raise ValueError("health_every must be >= 1")
        self.health_every = health_every
        self.residual_floor = residual_floor
        self.mass_tol = mass_tol
        self.ps_weight_floor = ps_weight_floor
        self.ef_residual_floor = ef_residual_floor
        self.log = log
        # telemetry registry: when set, the monitor publishes typed
        # `health` events and the registry's compatibility sink renders
        # the `gossip health:` line from the same payload
        self.registry = registry
        self.step_time = PercentileMeter(maxlen=step_window, ptag="Step")
        self.last_payload: dict | None = None
        self.reports: int = 0
        self.excursions: int = 0

    def record_step_time(self, seconds: float) -> None:
        self.step_time.update(seconds)

    def _diagnose(self, sig: tp.Mapping[str, float]) -> tuple[str, ...]:
        reasons = []
        if sig["consensus_residual"] > self.residual_floor \
                or not sig["consensus_residual"] == sig["consensus_residual"]:
            # a NaN residual counts (poisoned probe)
            reasons.append("residual-above-floor")
        if sig["ps_mass_err"] > self.mass_tol \
                or sig["ps_mass_err"] != sig["ps_mass_err"]:
            reasons.append("push-sum-mass-leak")
        if sig["ps_w_min"] < self.ps_weight_floor:
            reasons.append("ps-weight-collapse")
        if sig["nonfinite_params"] > 0 or \
                sig["nonfinite_params"] != sig["nonfinite_params"]:
            reasons.append("nonfinite-params")
        if sig["nonfinite_grads"] > 0 or \
                sig["nonfinite_grads"] != sig["nonfinite_grads"]:
            reasons.append("nonfinite-grads")
        ef = sig.get(EF_HEALTH_KEY)
        if ef is not None and (ef > self.ef_residual_floor or ef != ef):
            # error feedback compounding instead of telescoping
            reasons.append("ef-residual-blowup")
        return tuple(reasons)

    def observe(self, step: int, signals: tp.Mapping[str, tp.Any]
                ) -> HealthReport:
        """Digest one step's fetched signals; returns the report (the
        recovery policy consumes it) and logs the line when due."""
        sig = {k: float(signals[k]) for k in HEALTH_KEYS}
        if EF_HEALTH_KEY in signals:
            sig[EF_HEALTH_KEY] = float(signals[EF_HEALTH_KEY])
        reasons = self._diagnose(sig)
        payload = {"step": int(step),
                   **{k: round(sig[k], 8) for k in sig},
                   "residual_floor": self.residual_floor,
                   "step_p50_s": round(self.step_time.p50, 5),
                   "step_p99_s": round(self.step_time.p99, 5)}
        if reasons:
            payload["reasons"] = list(reasons)
        self.last_payload = payload
        report = HealthReport(step=int(step), payload=payload,
                              reasons=reasons)
        due = step % self.health_every == 0
        if due or reasons:
            if self.registry is not None:
                self.registry.emit(
                    "health", payload, step=int(step),
                    severity="warning" if reasons else "info")
            elif self.log is not None:
                line = "gossip health: " + json.dumps(payload,
                                                      sort_keys=True)
                if reasons:
                    self.log.warning(line)
                else:
                    self.log.info(line)
            self.reports += 1
        if reasons:
            self.excursions += 1
        return report
