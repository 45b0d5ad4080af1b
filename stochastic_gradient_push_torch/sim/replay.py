"""Campaign replay: a recorded fleet failure for the aggregator to eat.

Port of ``stochastic_gradient_push_tpu/sim/replay.py``: the same world
1024 (8 hosts x 128), 160 ticks and kill at tick 100; its fleet lane is
:func:`~.fleet.run_sim_fleet` over the port's rank files.

The observability plane's validation problem is chicken-and-egg: to
prove fleetmon's alerts fire at the right instants you need a fleet
failing in a *known* way, with ground truth independent of the thing
under test.  The simulator provides exactly that.  ``replay_campaign``
materializes one kill-slice campaign at world 1024 as a complete run
directory, in two lanes:

* **synthetic telemetry lane** — the numpy engine runs the real
  compiled schedule with the campaign's fault mask applied *naively*
  (dropped edges ship nothing and nobody reabsorbs their weight, via
  the engine's raw scatter) so push-sum mass genuinely leaks from the
  injected tick — the exact bug class the ``ps_mass_err`` SLO exists to
  catch, produced by the exact arithmetic it monitors.  Every host
  writes its own ``host{h}/events.jsonl`` (step_stats/health under the
  typed schema, timestamped on a synthetic clock) and ``trace.json``;
  the killed host's streams simply stop at the kill tick — the
  heartbeat-silence signal, recorded not described;
* **fleet protocol lane** — :func:`~.fleet.run_sim_fleet` drives the
  REAL coordinator over simulated hosts through the same campaign in
  the same directory, leaving ``coordinator.jsonl`` + per-host
  ``supervisor.jsonl`` and returning the :class:`FleetReport` that IS
  the recovery ground truth (cycles, surviving world, excluded hosts)
  the aggregator's derived timeline must match.

The returned dict carries every injected instant (kill time, first
mass breach) so ``scripts/fleetmon.py --selftest`` can assert alerts
fire *at* the faults, not merely that alerts exist.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..resilience import parse_fault_spec
from ..telemetry import (EVENTS_FILE, JsonlSink, SpanTracer,
                         TelemetryRegistry, TRACE_FILE, CommModel)
from ..topology import RingGraph, build_schedule
from .campaign import kill_slice_campaign
from .engine import SimState, _scatter, init_state

__all__ = ["replay_campaign"]

MASS_BREACH_THRESHOLD = 1e-3  # mirrors SloThresholds.ps_mass_err


def _leaky_tick(state: SimState, schedule, keep_row) -> SimState:
    """One gossip round with NAIVE drops: masked edges ship nothing and
    the sender does NOT reabsorb their weight (contrast
    :func:`~.engine.gossip_tick`, whose mass-conserving reabsorption is
    the fix).  Column sums fall below 1 for faulted senders, so
    ``mean(ps_weight)`` decays — a real mass-conservation bug on the
    real schedule tables, for the SLO rule to catch."""
    p = state.tick % schedule.num_phases
    perms_p = np.asarray(schedule.perms[p])
    self_w = np.asarray(schedule.self_weight[p], np.float64)
    edge_w = np.asarray(schedule.edge_weights[p], np.float64)
    shipped = edge_w if keep_row is None else \
        edge_w * np.asarray(keep_row, np.float64)
    params = _scatter(perms_p, self_w, shipped, state.params)
    ps = _scatter(perms_p, self_w, shipped, state.ps_weight)
    return SimState(params=params, ps_weight=ps, tick=state.tick + 1)


def replay_campaign(out_dir: str, *, world: int = 1024,
                    slice_size: int = 128, ticks: int = 160,
                    at: int = 100, dt: float = 0.05, seed: int = 0,
                    fleet: bool = True, fleet_steps: int = 40,
                    fleet_step_s: float = 0.05) -> dict:
    """Materialize one kill-slice campaign under ``out_dir``; returns
    the injected-fault/ground-truth record (see module docstring)."""
    campaign = kill_slice_campaign(world, slice_size, at=at,
                                   duration=ticks - at)
    victim = campaign.kill_hosts[0]
    num_hosts = world // slice_size
    schedule = build_schedule(RingGraph(world, peers_per_itr=1))
    plan = parse_fault_spec(campaign.fault_spec)
    keep, _, horizon = plan.host_tables(schedule)

    # synthetic clock: the campaign ends "now", so the fleet lane's
    # real-wall-clock events sort strictly after it in the merge
    base = time.time() - ticks * dt
    now = [base]

    def clk():
        return now[0]

    state = init_state(world, seed=seed)

    hosts = {}
    for h in range(num_hosts):
        hdir = os.path.join(out_dir, f"host{h}")
        reg = TelemetryRegistry(
            rank=h * slice_size,
            sinks=[JsonlSink(os.path.join(hdir, EVENTS_FILE))],
            clock=clk)
        tracer = SpanTracer(rank=h, clock=clk)
        reg.emit("run_meta", {
            "world": world, "algorithm": "sgp-sim",
            "hosts": num_hosts, "rows": slice_size,
            "campaign": campaign.name,
            "fault_spec": campaign.fault_spec})
        hosts[h] = (reg, tracer)

    first_breach_t = None
    rng = np.random.default_rng(seed)
    for k in range(ticks):
        now[0] = base + k * dt
        keep_row = None
        if k >= at:
            row = k if k < horizon else horizon + k % schedule.num_phases
            keep_row = keep[row]
        state = _leaky_tick(state, schedule, keep_row)
        mass_err = abs(float(state.ps_weight.mean()) - 1.0)
        if first_breach_t is None and mass_err > MASS_BREACH_THRESHOLD:
            first_breach_t = now[0]
        for h, (reg, tracer) in hosts.items():
            if h == victim and k >= at:
                continue  # killed: the stream just stops
            tracer.complete("gossip_round", "gossip",
                            now[0], dt * 0.3, {"tick": k})
            reg.emit("step_stats", {
                "epoch": 0,
                "loss": round(2.0 / (1.0 + 0.02 * k), 6),
                "step_time_s": round(
                    dt * (0.7 + 0.2 * float(rng.random())), 6),
                "data_time_s": round(dt * 0.1, 6),
                "nn_time_s": round(dt * 0.6, 6),
                "timed": k >= 2}, step=k)
            if k % 5 == 0 or (keep_row is not None and k % 2 == 0):
                sev = ("warning"
                       if mass_err > MASS_BREACH_THRESHOLD else "info")
                reg.emit("health", {
                    "ps_mass_err": round(mass_err, 12),
                    "consensus_residual": round(float(
                        np.abs(state.params
                               / state.ps_weight[:, None]
                               - state.params.mean(axis=0)[None]).max()),
                        9)}, step=k, severity=sev)
    for h, (reg, tracer) in hosts.items():
        reg.close()
        if h != victim:
            # a killed host never reaches finish(): no trace.json
            tracer.write(os.path.join(out_dir, f"host{h}",
                                      TRACE_FILE))

    # the run's own root streams: a short trainer-shaped trace + comm
    # snapshot, the inputs obsreport and fleetmon must agree on exactly
    now[0] = base
    root = TelemetryRegistry(
        rank=0, sinks=[JsonlSink(os.path.join(out_dir, EVENTS_FILE))],
        clock=clk)
    tracer = SpanTracer(rank=0, clock=clk)
    model = CommModel.from_schedule(schedule, 10_000,
                                    global_avg_every=8)
    root.emit("run_meta", {"world": world, "algorithm": "sgp",
                           "gossip_every": 1, "global_avg_every": 8})
    num_steps = 16
    from ..telemetry import CommAccountant

    acc = CommAccountant(model)
    for t in range(num_steps):
        now[0] = base + t * dt
        acc.on_step(t)
        tracer.complete(
            "train_step", "step", now[0], dt * (0.5 + 0.02 * t),
            {"steps": 1, "timed": t >= 2,
             "gossip": int(model.gossip_fires(t))})
    now[0] = base + num_steps * dt
    root.emit("comm", acc.snapshot(), step=num_steps - 1)
    root.close()
    tracer.write(os.path.join(out_dir, TRACE_FILE))

    report = None
    if fleet:
        from .fleet import run_sim_fleet

        report = run_sim_fleet(
            out_dir, {h: slice_size for h in range(num_hosts)},
            steps=fleet_steps, save_every=5, step_s=fleet_step_s,
            seed=seed, campaign=campaign)

    t_kill = base + at * dt
    return {
        "out_dir": out_dir,
        "campaign": campaign.name,
        "world": world,
        "num_hosts": num_hosts,
        "kill_host": victim,
        "base_t": base,
        "dt": dt,
        "ticks": ticks,
        "kill_tick": at,
        "t_kill": t_kill,
        "t_last_victim_event": base + (at - 1) * dt,
        "t_first_mass_breach": first_breach_t,
        "mass_err_final": abs(float(state.ps_weight.mean()) - 1.0),
        "fleet_report": report,
    }
