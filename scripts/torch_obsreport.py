#!/usr/bin/env python
"""torch_obsreport — one run report from a telemetry directory, on the port.

Port of ``scripts/obsreport.py``.  Reads what a ``--trace_dir`` run of
the port leaves behind — ``events.jsonl`` (typed plan/health/recovery/
comm/step_stats events, ``telemetry/registry.py``'s schema),
``trace.json`` (Chrome-trace host spans, ``telemetry/tracer.py``), the
supervisor's and the pod coordinator's streams, and the metadata of a
rank file saved in the same directory — and builds one report:
step-time p50/p99, per-phase wall-clock totals, the gossip-vs-compute
step overhead, the health excursion timeline, recovery and stall
counts, the restart and fleet timelines, the serving section, and comm
bytes by category beside the analytic model that produced them.  On the
same directory its report is the reference's, key for key (a rank file
the reference cannot read, a ``torch.save`` file, is the one source
only this reader opens: ``ckpt_meta``).

Usage:
    python scripts/torch_obsreport.py RUN_DIR          # human-readable
    python scripts/torch_obsreport.py RUN_DIR --json   # machine-readable
    python scripts/torch_obsreport.py --selftest       # the gate

Exit codes: 0 clean, 1 selftest/report failure, 2 unusable run dir.
Host work only: no device, no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from stochastic_gradient_push_torch.telemetry import (  # noqa: E402
    COORDINATOR_EVENTS_FILE,
    EVENTS_FILE,
    SCHEMA_VERSION,
    SUPERVISOR_EVENTS_FILE,
    TRACE_FILE,
    request_latency_meter,
    step_time_meter,
)

# -- loading ---------------------------------------------------------------


def _event_files(run_dir: str) -> list[str]:
    """events.jsonl plus any per-process events_rN.jsonl siblings (a
    multi-process run writes one file per rank to avoid interleaving),
    the supervisor's own stream (supervisor.jsonl — the restart
    timeline lives there), and, for a fleet directory, the pod
    coordinator's broadcast stream (coordinator.jsonl — the fleet
    timeline) plus every host's supervisor stream."""
    import glob

    base, ext = os.path.splitext(EVENTS_FILE)
    return sorted(
        glob.glob(os.path.join(run_dir, EVENTS_FILE))
        + glob.glob(os.path.join(run_dir, f"{base}_r*{ext}"))
        + glob.glob(os.path.join(run_dir, SUPERVISOR_EVENTS_FILE))
        + glob.glob(os.path.join(run_dir, COORDINATOR_EVENTS_FILE))
        + glob.glob(os.path.join(run_dir, "host*",
                                 SUPERVISOR_EVENTS_FILE)))


def _host_of(path: str, run_dir: str) -> int | None:
    """Host index when the stream lives in a fleet host{h}/ subdir."""
    rel = os.path.relpath(os.path.dirname(path), run_dir)
    if rel.startswith("host") and rel[4:].isdigit():
        return int(rel[4:])
    return None


def load_events(run_dir: str) -> list[dict]:
    events = []
    for path in _event_files(run_dir):
        host = _host_of(path, run_dir)
        with open(path) as f:
            for n, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{path}:{n}: unparseable event: {e}")
                if host is not None and isinstance(ev, dict):
                    # provenance for fleet reports: which host's
                    # supervisor stream this event came from
                    ev["_host"] = host
                events.append(ev)
    return events


def check_events(events: list[dict]) -> list[str]:
    """Schema check; returns a list of problems (empty = clean)."""
    problems = []
    for n, ev in enumerate(events, start=1):
        for field in ("v", "kind", "t", "rank", "severity", "data"):
            if field not in ev:
                problems.append(f"event {n}: missing field {field!r}")
        if ev.get("v") not in (None, SCHEMA_VERSION):
            problems.append(
                f"event {n}: schema version {ev['v']} (reader speaks "
                f"{SCHEMA_VERSION})")
        if "data" in ev and not isinstance(ev["data"], dict):
            problems.append(f"event {n}: data is not an object")
    return problems


def load_trace(run_dir: str) -> list[dict]:
    """Trace events, or [] when trace.json is absent — a killed run
    leaves a flushed events.jsonl but no trace (trace.json is written
    at finish()), and the report must still work on exactly that."""
    path = os.path.join(run_dir, TRACE_FILE)
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome-trace object "
                         "(no traceEvents)")
    return doc["traceEvents"]


def check_trace(trace_events: list[dict]) -> list[str]:
    """Chrome-trace validity: required fields per event, monotone ts."""
    problems = []
    last_ts = -1.0
    for n, ev in enumerate(trace_events, start=1):
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "I"):
            problems.append(f"trace event {n}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        for field in ("name", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"trace event {n}: missing {field!r}")
        if ph == "X" and "dur" not in ev:
            problems.append(f"trace event {n}: X event without dur")
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            if ts < last_ts:
                problems.append(
                    f"trace event {n}: ts {ts} < previous {last_ts} "
                    "(not monotone)")
            last_ts = ts
    return problems


def load_ckpt_meta(run_dir: str) -> dict | None:
    """Metadata of a rank file saved into the run dir, if any (the
    trainer stamps plan + last health payload into it): the port's
    ``torch.save`` layout, ``{"state", "meta": <JSON text>}``; a file
    that is not one is skipped."""
    import pickle

    import torch

    names = sorted(f for f in os.listdir(run_dir) if f.endswith(".ckpt"))
    for name in names:
        try:
            raw = torch.load(os.path.join(run_dir, name),
                             map_location="cpu", weights_only=True,
                             mmap=True)
        except (OSError, RuntimeError, ValueError, EOFError,
                pickle.UnpicklingError):
            continue
        if isinstance(raw, dict) and "meta" in raw:
            meta = raw["meta"]
            meta = dict(json.loads(meta) if isinstance(meta, str)
                        else meta or {})
            meta["_file"] = name
            return meta
    return None


# -- report ----------------------------------------------------------------


def build_report(run_dir: str) -> dict:
    events = load_events(run_dir)
    trace = load_trace(run_dir)
    trace_present = os.path.isfile(os.path.join(run_dir, TRACE_FILE))
    problems = check_events(events) + check_trace(trace)

    by_kind: dict[str, list[dict]] = {}
    for ev in events:
        by_kind.setdefault(ev.get("kind", "?"), []).append(ev)

    # step-time percentiles from timed train_step spans (warmup/compile
    # spans carry timed=False and are excluded) — via the SHARED helper
    # (telemetry.metrics), so this report and fleetmon's live summary
    # compute the same p50/p99 by construction (pinned in selftest)
    meter = step_time_meter(trace)
    gossip_durs, plain_durs = [], []
    phase_totals: dict[str, float] = {}
    for ev in trace:
        if ev.get("ph") != "X":
            continue
        dur_s = float(ev.get("dur", 0.0)) / 1e6
        phase_totals[ev.get("cat", "?")] = (
            phase_totals.get(ev.get("cat", "?"), 0.0) + dur_s)
        if ev.get("name") == "train_step":
            args = ev.get("args", {})
            steps = max(1, int(args.get("steps", 1)))
            per_step = dur_s / steps
            if args.get("timed", True) and "gossip" in args:
                (gossip_durs if args["gossip"] else
                 plain_durs).append(per_step)

    # measured gossip overhead: only measurable when the run thinned
    # communication (gossip_every > 1) so both step classes exist
    overhead = None
    if gossip_durs and plain_durs:
        overhead = (sum(gossip_durs) / len(gossip_durs)
                    - sum(plain_durs) / len(plain_durs))

    health = by_kind.get("health", [])
    excursions = [
        {"step": ev.get("step"),
         "reasons": ev["data"].get("reasons", [])}
        for ev in health if ev.get("severity") in ("warning", "error")]
    recoveries = by_kind.get("recovery", [])
    heartbeats = by_kind.get("heartbeat", [])
    comm = by_kind.get("comm", [])
    comm_final = comm[-1]["data"] if comm else None
    run_meta = by_kind.get("run_meta", [])
    plan = by_kind.get("plan", [])

    # restart timeline: one row per generation boundary (supervisor
    # relaunch events), annotated with the per-generation world/topology
    # and the supervisor-measured recovery time
    relaunches = sorted(by_kind.get("relaunch", []),
                        key=lambda ev: ev.get("t", 0.0))
    supervisor_evs = by_kind.get("supervisor", [])
    restart_timeline = [
        {"generation": ev["data"].get("generation"),
         "host": ev.get("_host"),
         "world": ev["data"].get("world"),
         "prev_world": ev["data"].get("prev_world"),
         "topology": ev["data"].get("topology"),
         "reason": ev["data"].get("reason"),
         "resharded": ev["data"].get("resharded"),
         "mean_drift": ev["data"].get("mean_drift"),
         "time_to_recover_s": ev["data"].get("time_to_recover_s")}
        for ev in relaunches]

    # fleet timeline: the pod coordinator's broadcast stream — one row
    # per rendezvous round, one per committed assign→go cycle, the
    # per-host generation count and the coordinated reshard drift
    fleet_evs = sorted(by_kind.get("fleet", []),
                       key=lambda ev: ev.get("t", 0.0))
    rendezvous_evs = sorted(by_kind.get("rendezvous", []),
                            key=lambda ev: ev.get("t", 0.0))
    fleet = None
    if fleet_evs or rendezvous_evs:
        start = next((ev["data"] for ev in fleet_evs
                      if ev["data"].get("phase") == "start"), None)
        calls = [{"round": ev["data"].get("round"),
                  "cause": ev["data"].get("cause"),
                  "hosts": ev["data"].get("hosts")}
                 for ev in rendezvous_evs
                 if ev["data"].get("phase") == "call"]
        gos = [ev["data"] for ev in fleet_evs
               if ev["data"].get("phase") == "go"]
        assigns = [ev["data"] for ev in fleet_evs
                   if ev["data"].get("phase") == "assign"]
        excluded = sorted({h for a in assigns
                           for h in (a.get("excluded") or [])})
        cycles = [{"cycle": g.get("cycle"), "round": g.get("round"),
                   "world": g.get("world"),
                   "prev_world": g.get("prev_world"),
                   "generation": g.get("generation"),
                   "acks": g.get("acks")} for g in gos]
        hosts = sorted(int(h) for h in (start or {}).get("hosts", {}))
        generations = {
            str(h): 1 + sum(1 for g in gos
                            if str(h) in (g.get("acks") or {}))
            for h in hosts}
        final = next((ev["data"].get("phase")
                      for ev in reversed(fleet_evs)
                      if ev["data"].get("phase") in
                      ("complete", "give-up", "halt")), None)
        fleet = {
            "hosts": (start or {}).get("hosts"),
            "start_world": (start or {}).get("world"),
            "rendezvous_rounds": calls,
            "cycles": cycles,
            "excluded_hosts": excluded,
            "host_generations": generations,
            "outcome": final,
        }

    # serving section: the run's `serve` summary event (serve/bench.py
    # summarize() — byte-equal to artifacts/bench_serve.json by
    # construction) cross-checked against the typed per-request stream
    serve_evs = by_kind.get("serve", [])
    request_evs = by_kind.get("request", [])
    serving = None
    if serve_evs or request_evs:
        summary = next((ev["data"] for ev in reversed(serve_evs)
                        if ev["data"].get("phase") == "summary"), None)
        rejects = sum(1 for ev in serve_evs
                      if ev["data"].get("phase") == "reject")
        # serve latency through the same shared helper fleetmon uses
        lat = request_latency_meter(request_evs)
        req_tokens = sum(int(ev["data"].get("new_tokens", 0))
                        for ev in request_evs)
        serving = {
            "summary": ({k: v for k, v in summary.items()
                         if k != "phase"} if summary else None),
            "requests_observed": len(request_evs),
            "tokens_observed": req_tokens,
            "p50_latency_s": round(lat.p50, 6),
            "p99_latency_s": round(lat.p99, 6),
            "rejections_observed": rejects,
        }

    report = {
        "run_dir": run_dir,
        "trace_present": trace_present,
        "schema_problems": problems,
        "events": {k: len(v) for k, v in sorted(by_kind.items())},
        "run_meta": run_meta[0]["data"] if run_meta else None,
        "plan": plan[0]["data"] if plan else None,
        "step_time": {
            "timed_steps": meter.count,
            "p50_s": round(meter.p50, 6),
            "p99_s": round(meter.p99, 6),
        },
        "phase_totals_s": {k: round(v, 6)
                           for k, v in sorted(phase_totals.items())},
        "gossip_step_overhead_s": (round(overhead, 6)
                                   if overhead is not None else None),
        "health": {
            "reports": len(health),
            "excursions": len(excursions),
            "timeline": excursions[:50],
        },
        "recoveries": {
            "count": len(recoveries),
            "actions": sorted({ev["data"].get("action", "?")
                               for ev in recoveries}),
        },
        "heartbeat_stalls": len(heartbeats),
        "restarts": {
            "supervised": bool(supervisor_evs or relaunches),
            # a fleet merges every host's relaunch events into this
            # timeline; counting them all as one supervisor's
            # generations would contradict the per-host generations in
            # the fleet section, so count per host there instead
            "generations": (max(fleet["host_generations"].values(),
                                default=1)
                            if fleet and fleet["host_generations"]
                            else len(relaunches) + 1),
            "timeline": restart_timeline,
        },
        "fleet": fleet,
        "serving": serving,
        "comm": comm_final,
        "ckpt_meta": load_ckpt_meta(run_dir),
    }
    return report


def render(report: dict) -> str:
    lines = [f"== obsreport: {report['run_dir']} =="]
    if not report.get("trace_present", True):
        lines.append("!! trace.json missing (run killed before "
                     "finish()?) — span metrics unavailable, events "
                     "only")
    if report["schema_problems"]:
        lines.append(f"!! {len(report['schema_problems'])} schema "
                     "problem(s):")
        lines += [f"   - {p}" for p in report["schema_problems"][:10]]
    lines.append("events: " + ", ".join(
        f"{k}={v}" for k, v in report["events"].items()))
    rm = report["run_meta"]
    if rm:
        lines.append(
            f"run: world {rm.get('world')} algorithm "
            f"{rm.get('algorithm')} gossip_every "
            f"{rm.get('gossip_every')} global_avg_every "
            f"{rm.get('global_avg_every', 0)}")
    st = report["step_time"]
    lines.append(f"step time: p50 {st['p50_s']*1e3:.2f} ms  "
                 f"p99 {st['p99_s']*1e3:.2f} ms  "
                 f"({st['timed_steps']} timed steps)")
    if report["gossip_step_overhead_s"] is not None:
        lines.append("gossip-vs-compute: gossip rounds add "
                     f"{report['gossip_step_overhead_s']*1e3:.2f} ms "
                     "per gossiping step (vs thinned steps)")
    if report["phase_totals_s"]:
        lines.append("host wall-clock by phase: " + ", ".join(
            f"{k} {v:.3f}s" for k, v in
            report["phase_totals_s"].items()))
    h = report["health"]
    lines.append(f"health: {h['reports']} report(s), "
                 f"{h['excursions']} excursion(s)")
    for e in h["timeline"][:5]:
        lines.append(f"   step {e['step']}: {', '.join(e['reasons'])}")
    lines.append(f"recoveries: {report['recoveries']['count']} "
                 f"{report['recoveries']['actions']}")
    lines.append(f"heartbeat stalls: {report['heartbeat_stalls']}")
    rs = report.get("restarts") or {}
    if rs.get("supervised"):
        lines.append(f"restarts: {rs['generations']} generation(s), "
                     f"{len(rs['timeline'])} relaunch(es)")
        for r in rs["timeline"]:
            drift = (f", mean drift {r['mean_drift']:.2e}"
                     if r.get("mean_drift") is not None else "")
            shape = (f"world {r['prev_world']} -> {r['world']}"
                     if r.get("prev_world") != r.get("world")
                     else f"world {r['world']}")
            who = (f"host {r['host']} gen {r['generation']}"
                   if r.get("host") is not None
                   else f"gen {r['generation']}")
            lines.append(
                f"   {who}: {shape}, topology "
                f"{r.get('topology')}, {r.get('reason')}"
                f" (recovered in {r.get('time_to_recover_s')}s"
                f"{drift})")
    fl = report.get("fleet")
    if fl:
        lines.append(
            f"fleet: {len(fl['host_generations'] or {})} host(s), "
            f"world {fl.get('start_world')}, "
            f"{len(fl['rendezvous_rounds'])} rendezvous round(s), "
            f"{len(fl['cycles'])} coordinated cycle(s), outcome "
            f"{fl.get('outcome')}")
        for call in fl["rendezvous_rounds"]:
            lines.append(f"   round {call['round']}: "
                         f"hosts {call['hosts']} — {call['cause']}")
        for cy in fl["cycles"]:
            drifts = ", ".join(
                f"h{h}:{d:.2e}" if isinstance(d, float) else f"h{h}:-"
                for h, d in sorted((cy.get("acks") or {}).items()))
            lines.append(
                f"   cycle {cy['cycle']}: world {cy['prev_world']} -> "
                f"{cy['world']} (gen {cy['generation']}; reshard drift "
                f"{drifts})")
        if fl["excluded_hosts"]:
            lines.append(f"   excluded hosts: {fl['excluded_hosts']}")
        if fl["host_generations"]:
            lines.append("   host generations: " + ", ".join(
                f"h{h}={g}" for h, g in
                sorted(fl["host_generations"].items())))
    sv = report.get("serving")
    if sv:
        s = sv.get("summary")
        if s:
            lines.append(
                f"serving: {s.get('requests')} request(s), "
                f"{s.get('tokens')} token(s), "
                f"{s.get('tokens_per_sec', 0.0):.1f} tok/s, latency "
                f"p50 {s.get('p50_latency_s', 0.0)*1e3:.2f} ms  "
                f"p99 {s.get('p99_latency_s', 0.0)*1e3:.2f} ms")
            lines.append(
                f"   pages: peak occupancy "
                f"{s.get('page_occupancy_peak', 0.0):.0%}, admission "
                f"rejections {s.get('admission_rejections', 0)}, kv "
                f"{s.get('kv_bytes_per_token', 0):,} B/token, "
                f"{s.get('decode_steps', 0)} decode step(s)")
        else:
            lines.append("serving: no summary event (run killed "
                         "mid-serve?) — typed request stream only")
        lines.append(
            f"   request stream: {sv['requests_observed']} completion "
            f"event(s), {sv['tokens_observed']} token(s), p50 "
            f"{sv['p50_latency_s']*1e3:.2f} ms  p99 "
            f"{sv['p99_latency_s']*1e3:.2f} ms, "
            f"{sv['rejections_observed']} reject event(s)")
    c = report["comm"]
    if c:
        by = c.get("bytes", {})
        lines.append(
            f"comm (per-rank bytes, {c.get('steps')} steps, "
            f"{c.get('gossip_rounds')} gossip rounds, "
            f"{c.get('global_avgs')} scheduled avgs, "
            f"{c.get('recoveries')} recovery avgs):")
        m = c.get("model") or {}
        wd = m.get("wire_dtype", "f32")
        if wd != "f32":
            # the encoding behind the gossip byte lanes (exact lanes —
            # global/recovery averages — stay full precision)
            blk = m.get("wire_block")
            lines.append(
                f"   gossip wire: {wd}"
                + (f" (block {blk})" if blk else "")
                + (", error feedback on" if m.get("error_feedback")
                   else "")
                + f"; exact payload {m.get('exact_bytes'):,} B vs "
                  f"encoded {m.get('payload_bytes'):,} B")
        # the transport shape behind the gossip rounds: which lane
        # moved the bytes and, for the split start/wait kernel, how the
        # round was pipelined into byte-balanced buckets.  Bucketing
        # re-times the wire, never re-prices it — the per-bucket bytes
        # here are the SAME gossip_wire total, just sliced per round
        lane = m.get("gossip_kernel", "xla")
        nb = max(1, int(m.get("gossip_buckets", 1) or 1))
        rounds = max(1, int(c.get("gossip_rounds") or 1))
        per_round = by.get("gossip_wire", 0) // rounds
        if nb > 1:
            lines.append(
                f"   transport: {lane} lane, {nb} byte-balanced "
                f"bucket(s)/round — ~{per_round // nb:,} B in flight "
                f"per start->wait span (of {per_round:,} B/round)")
        else:
            lines.append(
                f"   transport: {lane} lane, single bucket "
                f"({per_round:,} B/round per start->wait span)")
        for k, v in sorted(by.items()):
            if v:
                lines.append(f"   {k:>18}: {v:,}")
        if by.get("gossip_dcn"):
            # the split the hierarchical topology exists to improve:
            # gossip wire by link class (planner/interconnect.py fabric)
            wire = max(1, by.get("gossip_wire", 0))
            lines.append(
                "   link classes: ICI "
                f"{by.get('gossip_ici', 0):,} "
                f"({100 * by.get('gossip_ici', 0) / wire:.0f}%) vs DCN "
                f"{by['gossip_dcn']:,} "
                f"({100 * by['gossip_dcn'] / wire:.0f}%) of gossip wire")
    meta = report["ckpt_meta"]
    if meta:
        keys = sorted(k for k in meta if not k.startswith("_"))
        lines.append(f"checkpoint meta ({meta.get('_file')}): "
                     + ", ".join(keys))
    return "\n".join(lines)


# -- selftest --------------------------------------------------------------


def selftest() -> int:
    """Write a run dir through the port's telemetry APIs (a traced run,
    a supervisor's and a coordinator's streams, a serving bench), then
    hold the report to the analytic comm model, the bench artifact and
    the fleet aggregator's summary of the same directory."""
    import tempfile

    from stochastic_gradient_push_torch.telemetry import (
        CommModel, allreduce_bytes, make_run_telemetry)
    from stochastic_gradient_push_torch.topology import (
        RingGraph, build_schedule)

    with tempfile.TemporaryDirectory() as d:
        rt = make_run_telemetry(d, rank=0, metrics_every=4)
        schedule = build_schedule(RingGraph(8, peers_per_itr=1))
        payload = 10_000
        model = CommModel.from_schedule(schedule, payload,
                                        global_avg_every=8,
                                        gossip_kernel="pallas",
                                        gossip_buckets=3)
        acc = rt.attach_comm(model)
        rt.registry.emit("run_meta", {
            "world": 8, "algorithm": "sgp", "gossip_every": 1,
            "global_avg_every": 8, "comm_model": model.to_dict()})
        rt.registry.emit("plan", {"topology": "ring", "world": 8})
        t0 = rt.tracer.now()
        num_steps = 16
        for t in range(num_steps):
            acc.on_step(t)
            start = t0 + t * 0.01
            rt.tracer.complete("data_fetch", "data", start, 0.002)
            rt.tracer.complete(
                "train_step", "step", start + 0.002, 0.008,
                {"steps": 1, "timed": t >= 2,
                 "gossip": int(model.gossip_fires(t)),
                 "global_avg": int(model.global_avg_fires(t))})
        rt.registry.emit("health", {
            "step": 9, "consensus_residual": 0.5,
            "reasons": ["residual-above-floor"]}, step=9,
            severity="warning")
        rt.registry.emit("recovery", {
            "step": 9, "action": "global-average",
            "reasons": ["residual-above-floor"]}, step=9,
            severity="warning")
        with rt.span("recovery_global_average", "recovery"):
            acc.on_recovery()
        rt.registry.emit("heartbeat", {"elapsed_s": 301.0,
                                       "timeout_s": 300}, severity="error")
        with rt.span("checkpoint_save", "checkpoint"):
            pass
        rt.finish(step=num_steps - 1)

        # a supervised run: the supervisor writes its own stream
        # (supervisor.jsonl) that the report renders as the restart
        # timeline
        from stochastic_gradient_push_torch.telemetry import (
            JsonlSink, TelemetryRegistry)
        sup = TelemetryRegistry(rank=0, sinks=[JsonlSink(
            os.path.join(d, SUPERVISOR_EVENTS_FILE))])
        sup.emit("supervisor", {"action": "launch", "generation": 0,
                                "world": 8})
        sup.emit("relaunch", {
            "generation": 1, "world": 4, "prev_world": 8,
            "reason": "child-exit (code -9)", "topology": "ring",
            "resharded": True, "mean_drift": 1.2e-7,
            "time_to_recover_s": 2.5}, severity="warning")
        sup.close()

        # a fleet run: the pod coordinator's broadcast stream renders
        # as the fleet timeline — one slice lost, a deadline-missed
        # rendezvous that re-ran, one coordinated reshard cycle
        coord = TelemetryRegistry(rank=0, sinks=[JsonlSink(
            os.path.join(d, COORDINATOR_EVENTS_FILE))])
        coord.emit("fleet", {"phase": "start", "world": 6,
                             "hosts": {"0": 2, "1": 2, "2": 2}})
        coord.emit("rendezvous", {"phase": "call", "round": 1,
                                  "cause": "host-silence: host 2",
                                  "deadline_s": 2.0,
                                  "hosts": [0, 1, 2]}, severity="warning")
        coord.emit("rendezvous", {"phase": "call", "round": 2,
                                  "cause": "host-silence: host 2",
                                  "deadline_s": 2.0,
                                  "hosts": [0, 1]}, severity="warning")
        coord.emit("fleet", {
            "phase": "assign", "round": 2, "cycle": 1,
            "cause": "host-silence: host 2", "world": 4,
            "prev_world": 6, "plan": None, "excluded": [2],
            "shards": {"0": {"out_rank": 0, "out_rows": 2},
                       "1": {"out_rank": 1, "out_rows": 2}}},
            severity="warning")
        coord.emit("fleet", {
            "phase": "go", "round": 2, "cycle": 1, "world": 4,
            "prev_world": 6, "generation": 1,
            "acks": {"0": 1.4e-8, "1": 1.4e-8}}, severity="warning")
        coord.emit("fleet", {"phase": "complete", "world": 4,
                             "generation": 1, "cycles": 1})
        coord.close()

        # a serving run: drive the real bench (synthetic engine) into a
        # per-rank event stream + artifact, then hold the report's
        # Serving rows to the artifact's numbers — they share
        # serve.bench.summarize, so any drift is a real bug
        from stochastic_gradient_push_torch.serve.bench import (
            SyntheticEngine, run_bench, synthetic_requests,
            write_artifact)
        from stochastic_gradient_push_torch.serve.engine import ServeConfig
        from stochastic_gradient_push_torch.serve.scheduler import Request

        base, ext = os.path.splitext(EVENTS_FILE)
        srv = TelemetryRegistry(rank=1, sinks=[JsonlSink(
            os.path.join(d, f"{base}_r1{ext}"))])
        eng = SyntheticEngine(
            ServeConfig(n_heads=1, page_size=4, num_pages=16,
                        max_seqs=2, max_pages_per_seq=4),
            kv_bytes_per_tok=1024)
        reqs = synthetic_requests(12, seed=5, prompt_tokens=(2, 6),
                                  new_tokens=(2, 5))
        # budget 25 > the 16-token slot window: a permanent rejection
        # the Serving section must count
        reqs.append(Request(rid=999, prompt=(1,) * 20,
                            max_new_tokens=5))
        metrics, _ = run_bench(eng, reqs, registry=srv)
        srv.close()
        artifact_path = write_artifact(
            os.path.join(d, "bench_serve.json"), metrics)

        report = build_report(d)
        rendered = render(report)
        print(rendered)

        ok = True

        def expect(cond, what):
            nonlocal ok
            if not cond:
                ok = False
                print(f"FAIL: {what}", flush=True)

        expect(report["schema_problems"] == [],
               f"schema problems: {report['schema_problems']}")
        expect(report["step_time"]["timed_steps"] == num_steps - 2,
               "timed step count")
        expect(report["step_time"]["p50_s"] > 0, "p50 > 0")
        expect(report["step_time"]["p99_s"] >=
               report["step_time"]["p50_s"], "p99 >= p50")
        expect(report["health"]["excursions"] == 1, "one excursion")
        expect(report["recoveries"]["count"] == 1, "one recovery")
        expect(report["heartbeat_stalls"] == 1, "one stall")
        rs = report["restarts"]
        expect(rs["supervised"] and rs["generations"] == 2,
               f"restart timeline generations: {rs}")
        expect(rs["timeline"] and rs["timeline"][0]["world"] == 4
               and rs["timeline"][0]["prev_world"] == 8
               and rs["timeline"][0]["topology"] == "ring",
               f"restart timeline row: {rs['timeline']}")
        # the fleet timeline, held to the same row-level checks as the
        # restart timeline above
        fl = report["fleet"]
        expect(fl is not None, "fleet timeline missing")
        if fl is not None:
            expect(len(fl["rendezvous_rounds"]) == 2
                   and fl["rendezvous_rounds"][1]["hosts"] == [0, 1],
                   f"rendezvous rounds: {fl['rendezvous_rounds']}")
            expect(len(fl["cycles"]) == 1
                   and fl["cycles"][0]["prev_world"] == 6
                   and fl["cycles"][0]["world"] == 4,
                   f"fleet cycle row: {fl['cycles']}")
            expect(fl["excluded_hosts"] == [2],
                   f"excluded hosts: {fl['excluded_hosts']}")
            expect(fl["host_generations"] == {"0": 2, "1": 2, "2": 1},
                   f"host generations: {fl['host_generations']}")
            expect(fl["outcome"] == "complete",
                   f"fleet outcome: {fl['outcome']}")
            acks = fl["cycles"][0]["acks"]
            expect(acks == {"0": 1.4e-8, "1": 1.4e-8},
                   f"coordinated reshard drift: {acks}")
        # the Serving section, held row-for-row to the bench artifact
        sv = report["serving"]
        expect(sv is not None, "serving section missing")
        if sv is not None:
            with open(artifact_path) as f:
                art = json.load(f)["bench"]
            expect(sv["summary"] == art,
                   f"serving summary != artifact: {sv['summary']} "
                   f"vs {art}")
            expect(sv["requests_observed"] == art["requests"],
                   f"request events {sv['requests_observed']} != "
                   f"artifact {art['requests']}")
            expect(sv["tokens_observed"] == art["tokens"],
                   f"request tokens {sv['tokens_observed']} != "
                   f"artifact {art['tokens']}")
            expect(abs(sv["p50_latency_s"] - art["p50_latency_s"])
                   < 1e-6, "request-stream p50 != artifact p50")
            expect(abs(sv["p99_latency_s"] - art["p99_latency_s"])
                   < 1e-6, "request-stream p99 != artifact p99")
            expect(sv["rejections_observed"]
                   == art["admission_rejections"] == 1,
                   f"rejection rows: {sv['rejections_observed']} vs "
                   f"{art['admission_rejections']}")
        # the shared-helper pin: fleetmon's live summary of the SAME
        # run dir must agree with this report EXACTLY on step-time and
        # serve-latency percentiles (both go through
        # telemetry.metrics.step_time_meter / request_latency_meter)
        # and on the comm snapshot — the two consumers can never
        # disagree on what p50/p99 mean
        from stochastic_gradient_push_torch.telemetry.aggregate import (
            FleetAggregator)
        agg = FleetAggregator(d, write_alerts=False)
        agg.drain()
        fm = agg.summary()
        agg.close()
        expect(fm["step_time"] == report["step_time"],
               f"fleetmon step_time {fm['step_time']} != obsreport "
               f"{report['step_time']}")
        expect(fm["serving"]["p50_latency_s"] == sv["p50_latency_s"]
               and fm["serving"]["p99_latency_s"]
               == sv["p99_latency_s"],
               f"fleetmon serve latency {fm['serving']} != obsreport "
               f"{sv}")
        expect(fm["comm"] == report["comm"],
               "fleetmon comm snapshot != obsreport comm snapshot")

        # the transport provenance: the report carries the lane and the
        # split-kernel bucket depth, renders a per-bucket span line, and
        # the bucketed model prices EXACTLY like the unbucketed one
        # (bucketing re-times the wire, never re-prices it)
        cm = (report["comm"] or {}).get("model") or {}
        expect(cm.get("gossip_kernel") == "pallas"
               and cm.get("gossip_buckets") == 3,
               f"transport stamp: kernel {cm.get('gossip_kernel')!r} "
               f"buckets {cm.get('gossip_buckets')!r}")
        expect("3 byte-balanced bucket" in rendered,
               "per-bucket transport span line missing from report")
        flat = CommModel.from_schedule(schedule, payload,
                                       global_avg_every=8)
        expect(model.totals(num_steps) == flat.totals(num_steps),
               "bucketed comm model re-priced the wire")

        # the analytic gate: reported bytes equal the model's expectation
        want = model.totals(num_steps)
        want["recovery"] = allreduce_bytes(payload, 8)
        got = report["comm"]["bytes"]
        expect(got == want, f"comm bytes {got} != analytic {want}")
        expect(report["comm"]["gossip_rounds"] == num_steps,
               "gossip round count")
        expect(report["comm"]["global_avgs"] == 2, "scheduled avgs")
        # phase tracks present in the trace
        for phase in ("data", "step", "recovery", "checkpoint"):
            expect(phase in report["phase_totals_s"],
                   f"phase {phase} missing from trace")

        print("obsreport selftest:", "OK" if ok else "FAILED",
              flush=True)
        return 0 if ok else 1


# -- entry -----------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", nargs="?", help="telemetry directory "
                   "(contains events.jsonl + trace.json)")
    p.add_argument("--json", action="store_true",
                   help="emit the report as one JSON object")
    p.add_argument("--selftest", action="store_true",
                   help="synthesize a run and verify the report "
                        "pipeline (the gate)")
    args = p.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.run_dir:
        p.error("run_dir required (or --selftest)")
    if not _event_files(args.run_dir):
        print(f"error: no {EVENTS_FILE} under {args.run_dir} — was the "
              "run started with --trace_dir?", file=sys.stderr)
        return 2
    report = build_report(args.run_dir)
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(render(report))
    return 1 if report["schema_problems"] else 0


if __name__ == "__main__":
    sys.exit(main())
