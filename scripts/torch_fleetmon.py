#!/usr/bin/env python
"""torch_fleetmon — the fleet observability plane over the typed event
streams, on the port.

Port of ``scripts/fleetmon.py``.  Tails every stream a run/fleet
directory grows — per-host ``events.jsonl``, per-host
``supervisor.jsonl``, the coordinator's ``coordinator.jsonl``, per-rank
``events_r*.jsonl`` — through the rotation-safe tailer, merges them on
per-stream watermarks (clock-skewed or silent hosts never corrupt the
view), derives the closed metric vocabulary (``telemetry/metrics.py``),
evaluates the SLO rules (step-time p99, push-sum mass conservation,
per-host heartbeat silence, serve rejection rate -> typed ``alert``
events into ``fleetmon.jsonl``), and can fold every per-host trace plus
the rendezvous protocol into ONE Perfetto timeline with a flow arrow per
coordinated relaunch cycle (``telemetry/aggregate.py``,
``telemetry/tracemerge.py``).

Usage:
    python scripts/torch_fleetmon.py RUN_DIR              # one-shot summary
    python scripts/torch_fleetmon.py RUN_DIR --json       # machine-readable
    python scripts/torch_fleetmon.py RUN_DIR --watch      # live console
    python scripts/torch_fleetmon.py RUN_DIR --watch --http 9100
                                                # + Prometheus /metrics
    python scripts/torch_fleetmon.py RUN_DIR --merge-trace merged.json
    python scripts/torch_fleetmon.py --selftest           # the gate

Exit codes: 0 clean, 1 selftest failure / alerts fired (one-shot mode
reports them), 2 unusable run dir.  Host work only: no device, no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

signal.signal(signal.SIGPIPE, signal.SIG_DFL)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from stochastic_gradient_push_torch.telemetry.aggregate import (  # noqa: E402
    ALERTS_FILE,
    FleetAggregator,
    SloThresholds,
)
from stochastic_gradient_push_torch.telemetry.tracemerge import (  # noqa: E402
    COORDINATOR_PID,
    count_flows,
    merge_run,
    validate_merged,
    write_merged,
)

# -- Prometheus endpoint ---------------------------------------------------


def serve_metrics(agg: FleetAggregator, port: int):
    """Expose ``agg.metrics`` as Prometheus text on
    ``127.0.0.1:port/metrics`` from a daemon thread; returns the server
    (``.server_address[1]`` is the bound port — pass 0 to let the OS
    pick, as the selftest does)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = agg.metrics.exposition().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet: the console is the UI
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


# -- console rendering -----------------------------------------------------


def render(summary: dict) -> str:
    lines = [f"== fleetmon: {summary['run_dir']} =="]
    lines.append(f"streams: {len(summary['streams'])}  events: "
                 + ", ".join(f"{k}={v}" for k, v in
                             summary["events"].items()))
    lines.append(f"merged: {summary['events_released']} event(s) "
                 f"released, {summary['late_events']} late")
    st = summary["step_time"]
    lines.append(f"step time: p50 {st['p50_s']*1e3:.2f} ms  "
                 f"p99 {st['p99_s']*1e3:.2f} ms  "
                 f"({st['timed_steps']} timed steps)")
    sv = summary["serving"]
    if sv["requests_observed"]:
        lines.append(f"serving: {sv['requests_observed']} request(s), "
                     f"latency p50 {sv['p50_latency_s']*1e3:.2f} ms  "
                     f"p99 {sv['p99_latency_s']*1e3:.2f} ms")
    if summary.get("fleet_outcome"):
        lines.append(f"fleet: outcome {summary['fleet_outcome']}, "
                     f"retired hosts {summary['hosts_retired']}, "
                     f"silent hosts {summary['hosts_silent']}")
    c = summary.get("comm")
    if c:
        total = sum((c.get("bytes") or {}).values())
        lines.append(f"comm: {total:,} B/rank across "
                     f"{c.get('steps')} steps")
    alerts = summary["alerts"]
    lines.append(f"alerts: {len(alerts)}")
    for a in alerts:
        host = f" host {a['host']}" if "host" in a else ""
        lines.append(f"   [{a['rule']}]{host} at t={a['at_t']:.3f}")
    return "\n".join(lines)


def _status_line(agg: FleetAggregator) -> str:
    rules = agg.rules
    return (f"\r{time.strftime('%H:%M:%S')} streams "
            f"{len(agg.streams)} events {agg.emitted} late "
            f"{agg.late_events} hosts "
            f"{len(rules.last_t) - len(rules.retired)} "
            f"silent {len(rules._silent)} alerts {len(agg.alerts)}")


# -- selftest --------------------------------------------------------------


def selftest() -> int:
    """Replay the world-1024 kill-slice campaign through the whole
    plane and hold it to the simulator's ground truth, and to
    torch_obsreport's report of the same directory."""
    import tempfile
    import urllib.request

    from stochastic_gradient_push_torch.sim.replay import replay_campaign

    # torch_obsreport (a sibling script, not a package module): the
    # equality pin below compares fleetmon's summary to its report
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_obsreport as obsreport

    ok = True

    def expect(cond, what):
        nonlocal ok
        if not cond:
            ok = False
            print(f"FAIL: {what}", flush=True)

    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        print("[fleetmon] replaying kill-slice campaign at world 1024 "
              "(8 hosts x 128)...", flush=True)
        info = replay_campaign(d)
        rep = info["fleet_report"]
        print(f"[{time.time()-t0:5.1f}s] campaign replayed: "
              f"kill host {info['kill_host']} at tick "
              f"{info['kill_tick']}, fleet rc {rep.rc}", flush=True)

        thr = SloThresholds(heartbeat_silence_s=1.0)
        agg = FleetAggregator(d, thresholds=thr)
        released = agg.drain()
        summary = agg.summary()
        agg.close()
        print(render(summary), flush=True)
        expect(released > 0, "no events released")

        # -- alerts fire AT the injected faults, and ONLY there ---------
        spurious = [a for a in agg.alerts
                    if a["rule"] == "heartbeat-silence"
                    and a.get("host") != info["kill_host"]]
        expect(not spurious,
               f"heartbeat-silence fired for healthy hosts: {spurious}")
        silence = [a for a in agg.alerts
                   if a["rule"] == "heartbeat-silence"
                   and a.get("host") == info["kill_host"]]
        expect(silence, "no heartbeat-silence alert for the killed "
               f"host {info['kill_host']}")
        if silence:
            want = info["t_last_victim_event"] + thr.heartbeat_silence_s
            expect(abs(silence[0]["at_t"] - want) < 0.5,
                   f"heartbeat-silence at_t {silence[0]['at_t']:.3f} "
                   f"!~ injected {want:.3f}")
        mass = [a for a in agg.alerts
                if a["rule"] == "mass-conservation"]
        expect(mass, "no mass-conservation alert")
        if mass:
            expect(info["t_first_mass_breach"] is not None
                   and abs(mass[0]["at_t"]
                           - info["t_first_mass_breach"]) < 0.5,
                   f"mass alert at_t {mass[0]['at_t']:.3f} !~ first "
                   f"breach {info['t_first_mass_breach']}")
        expect(os.path.isfile(os.path.join(d, ALERTS_FILE)),
               f"{ALERTS_FILE} not written")

        # -- recovery timeline matches the coordinator's ground truth ---
        from stochastic_gradient_push_torch.telemetry.metrics import (
            FLEET_CYCLES_TOTAL, FLEET_WORLD)
        cycles = agg.metrics.counter(FLEET_CYCLES_TOTAL).value
        expect(cycles == rep.cycles,
               f"derived cycles {cycles} != FleetReport {rep.cycles}")
        world = agg.metrics.gauge(FLEET_WORLD).value
        expect(world == rep.world,
               f"derived world {world} != FleetReport {rep.world}")
        expect(summary["fleet_outcome"] == "complete",
               f"fleet outcome {summary['fleet_outcome']}")
        expect(set(rep.excluded) <= set(summary["hosts_retired"]),
               f"excluded {rep.excluded} not retired "
               f"{summary['hosts_retired']}")

        # -- merged Perfetto trace: valid, one flow per cycle ------------
        merged = merge_run(d)
        problems = validate_merged(merged)
        expect(problems == [], f"merged trace invalid: {problems[:5]}")
        flows = count_flows(merged)
        expect(flows == rep.cycles,
               f"{flows} flow(s) != {rep.cycles} committed cycle(s)")
        pids = {ev.get("pid") for ev in merged["traceEvents"]}
        expect(any(isinstance(p, int) and p < 100 for p in pids)
               and COORDINATOR_PID in pids,
               f"merged trace missing host/coordinator tracks: {pids}")
        out_path = os.path.join(d, "merged_trace.json")
        write_merged(d, out_path)
        expect(os.path.isfile(out_path), "merged trace not written")

        # -- exposition parses (over real HTTP) --------------------------
        server = serve_metrics(agg, 0)
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            text = r.read().decode()
        server.shutdown()
        expect("sgp_alerts_total" in text
               and "sgp_events_total" in text,
               "exposition missing expected families")
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            name_part, _, value = line.rpartition(" ")
            expect(bool(name_part), f"unparseable line: {line!r}")
            try:
                float(value)
            except ValueError:
                expect(False, f"non-numeric sample: {line!r}")

        # -- fleetmon == obsreport, exactly ------------------------------
        report = obsreport.build_report(d)
        expect(summary["step_time"] == report["step_time"],
               f"step_time disagrees: {summary['step_time']} vs "
               f"{report['step_time']}")
        expect(summary["comm"] == report["comm"],
               f"comm disagrees: {summary['comm']} vs "
               f"{report['comm']}")
        sv, rv = summary["serving"], report.get("serving")
        if rv is not None:
            expect(sv["p50_latency_s"] == rv["p50_latency_s"]
                   and sv["p99_latency_s"] == rv["p99_latency_s"],
                   f"serve latency disagrees: {sv} vs {rv}")

    print(f"fleetmon selftest: {'OK' if ok else 'FAILED'} "
          f"({time.time()-t0:.1f}s)", flush=True)
    return 0 if ok else 1


# -- entry -----------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", nargs="?",
                   help="run/fleet telemetry directory")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as one JSON object")
    p.add_argument("--watch", action="store_true",
                   help="keep tailing; live console status")
    p.add_argument("--interval", type=float, default=1.0,
                   help="poll interval for --watch (seconds)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve Prometheus /metrics on this port")
    p.add_argument("--merge-trace", default=None, metavar="OUT",
                   help="write the merged cross-host Perfetto trace")
    p.add_argument("--silence", type=float, default=2.0,
                   help="merge-frontier silence timeout (event s)")
    p.add_argument("--hb-silence", type=float, default=1.0,
                   help="heartbeat-silence SLO threshold (event s)")
    p.add_argument("--p99-slo", type=float, default=1.0,
                   help="step-time p99 SLO threshold (s)")
    p.add_argument("--mass-slo", type=float, default=1e-3,
                   help="ps mass-conservation SLO threshold")
    p.add_argument("--selftest", action="store_true",
                   help="replay a sim campaign through the plane "
                        "(the gate)")
    args = p.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.run_dir:
        p.error("run_dir required (or --selftest)")
    if not os.path.isdir(args.run_dir):
        print(f"error: {args.run_dir} is not a directory",
              file=sys.stderr)
        return 2

    thr = SloThresholds(step_time_p99_s=args.p99_slo,
                        ps_mass_err=args.mass_slo,
                        heartbeat_silence_s=args.hb_silence)
    agg = FleetAggregator(args.run_dir, thresholds=thr,
                          silence_s=args.silence)
    server = serve_metrics(agg, args.http) \
        if args.http is not None else None
    try:
        if args.watch:
            if server is not None:
                print(f"metrics on http://127.0.0.1:"
                      f"{server.server_address[1]}/metrics")
            known_alerts = 0
            while True:
                agg.poll()
                for a in agg.alerts[known_alerts:]:
                    host = f" host {a['host']}" if "host" in a else ""
                    print(f"\nALERT [{a['rule']}]{host} "
                          f"at t={a['at_t']:.3f}")
                known_alerts = len(agg.alerts)
                print(_status_line(agg), end="", flush=True)
                time.sleep(args.interval)
        agg.drain()
        if args.merge_trace:
            doc = write_merged(args.run_dir, args.merge_trace)
            problems = validate_merged(doc)
            print(f"merged trace -> {args.merge_trace} "
                  f"({count_flows(doc)} flow(s)"
                  + (f", {len(problems)} problem(s)" if problems
                     else "") + ")")
        summary = agg.summary()
        if args.json:
            print(json.dumps(summary, sort_keys=True, default=float))
        else:
            print(render(summary))
        return 1 if summary["alerts"] else 0
    except KeyboardInterrupt:
        print()
        return 0
    finally:
        agg.close()
        if server is not None:
            server.shutdown()


if __name__ == "__main__":
    sys.exit(main())
