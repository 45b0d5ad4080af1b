"""Cross-host trace merge: N trace.json + protocol streams -> ONE
Perfetto timeline.

Port of ``stochastic_gradient_push_tpu/telemetry/tracemerge.py``; the
merged object is the reference's, event for event, on the same
directory.  A coordinated relaunch cycle is spread across files: every
host's ``trace.json`` shows *its* spans, the coordinator's
``coordinator.jsonl`` holds the call/assign/go decisions, and each
host's ``supervisor.jsonl`` holds its join/ack replies.  This module
folds them into one Chrome-trace/Perfetto JSON:

* **pid = host** — each ``host{h}/trace.json`` becomes process ``h``;
  the run's own root trace becomes the ``run rank N`` processes
  (pid 10000+N) and the coordinator gets its own process (pid 20000),
  so the three layers cannot collide;
* **tid = rank·phase** — a host trace's (rank, phase-track) pairs map
  to distinct threads named ``r{rank}·{phase}``;
* **clock alignment** — each source trace carries ``epoch_s`` (the
  wall-clock instant of its ts=0, :meth:`SpanTracer.to_chrome`); the
  merge re-bases every source onto ``min(epoch)`` so skewed hosts land
  on one axis.  A trace without ``epoch_s`` merges at offset 0;
* **flow events** — one ``s``/``t``/``f`` flow per *committed*
  rendezvous cycle, threading coordinator ``call`` → host ``join``/
  ``ack`` (and coordinator ``assign``) → coordinator ``go`` across
  processes, so a drain→reshard→ack→go cycle reads as one arrowed
  timeline.

``validate_merged`` is the schema check for the *merged* artifact,
apart from obsreport's ``check_trace``, which holds the single-tracer
invariants (no flow phases, globally monotone ts) that a multi-clock
merge does not satisfy.
"""

from __future__ import annotations

import glob
import json
import os

from . import COORDINATOR_EVENTS_FILE, SUPERVISOR_EVENTS_FILE, TRACE_FILE
from .tracer import SPAN_PHASES

__all__ = ["merge_run", "validate_merged", "count_flows",
           "write_merged", "RUN_PID_BASE", "COORDINATOR_PID"]

RUN_PID_BASE = 10_000     # root-trace ranks
COORDINATOR_PID = 20_000  # the coordinator's protocol track
PROTOCOL_TID = 1_000_000  # per-host supervisor protocol thread
_PROTO_DUR_US = 200.0     # protocol messages render as short slices

# host<->coordinator phases worth a slice on the merged timeline
# (alive heartbeats are deliberately dropped — pure noise at this zoom)
_HOST_PHASES = ("hello", "fault", "join", "ack", "done")
_COORD_PHASES = ("start", "call", "assign", "go", "complete",
                 "give-up", "halt")


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _load_events(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(ev, dict):
                out.append(ev)
    return out


def _trace_sources(run_dir: str) -> list[tuple[str, int | None]]:
    """(path, host) for every trace file of the run; host None = the
    run's own root/rank traces."""
    base, ext = os.path.splitext(TRACE_FILE)
    out = [(p, None) for p in sorted(
        glob.glob(os.path.join(run_dir, TRACE_FILE))
        + glob.glob(os.path.join(run_dir, f"{base}_r*{ext}")))]
    for p in sorted(glob.glob(os.path.join(run_dir, "host*",
                                           TRACE_FILE))):
        h = os.path.basename(os.path.dirname(p))[4:]
        if h.isdigit():
            out.append((p, int(h)))
    return out


def merge_run(run_dir: str) -> dict:
    """Merge every trace + protocol stream under ``run_dir`` into one
    Chrome-trace object."""
    sources = []
    for path, host in _trace_sources(run_dir):
        doc = _load_json(path)
        sources.append((host, doc.get("epoch_s"),
                        doc.get("traceEvents", [])))
    coord_events = []
    cpath = os.path.join(run_dir, COORDINATOR_EVENTS_FILE)
    if os.path.isfile(cpath):
        coord_events = _load_events(cpath)
    host_events = []
    for p in sorted(glob.glob(os.path.join(
            run_dir, "host*", SUPERVISOR_EVENTS_FILE))):
        h = os.path.basename(os.path.dirname(p))[4:]
        if h.isdigit():
            for ev in _load_events(p):
                ev["_host"] = int(h)
                host_events.append(ev)

    # one wall-clock base for the whole merged timeline
    anchors = [e for _, e, _ in sources if e is not None]
    anchors += [float(ev["t"]) for ev in coord_events + host_events
                if "t" in ev]
    base = min(anchors) if anchors else 0.0

    out: list[dict] = []
    named_procs: set[int] = set()
    named_threads: set[tuple[int, int]] = set()

    def proc(pid: int, name: str) -> None:
        if pid not in named_procs:
            named_procs.add(pid)
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": name}})

    def thread(pid: int, tid: int, name: str) -> None:
        if (pid, tid) not in named_threads:
            named_threads.add((pid, tid))
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": name}})

    # -- span sources ------------------------------------------------------
    for host, epoch, events in sources:
        shift_us = ((epoch - base) * 1e6) if epoch is not None else 0.0
        # the source tracer's own tid -> phase-name map (its metadata)
        tid_names = {ev["tid"]: ev["args"]["name"] for ev in events
                     if ev.get("ph") == "M"
                     and ev.get("name") == "thread_name"}
        for ev in events:
            if ev.get("ph") == "M":
                continue
            src_pid = int(ev.get("pid", 0))
            src_tid = int(ev.get("tid", 0))
            pid = host if host is not None else RUN_PID_BASE + src_pid
            proc(pid, f"host {host}" if host is not None
                 else f"run rank {src_pid}")
            # rank·phase threads: distinct per (source rank, phase)
            tid = src_pid * (len(SPAN_PHASES) + 1) + src_tid
            phase = tid_names.get(src_tid, f"t{src_tid}")
            thread(pid, tid, f"r{src_pid}·{phase}")
            mev = dict(ev)
            mev["pid"], mev["tid"] = pid, tid
            mev["ts"] = round(float(ev.get("ts", 0.0)) + shift_us, 1)
            out.append(mev)

    # -- protocol slices ---------------------------------------------------
    def proto_slice(ev: dict, pid: int, tid: int) -> dict | None:
        data = ev.get("data", {})
        phase = data.get("phase")
        kind = ev.get("kind")
        if kind not in ("rendezvous", "fleet"):
            return None
        sl = {
            "name": f"{kind}/{phase}", "cat": "protocol", "ph": "X",
            "ts": round((float(ev.get("t", base)) - base) * 1e6, 1),
            "dur": _PROTO_DUR_US, "pid": pid, "tid": tid,
            "args": {k: v for k, v in data.items()
                     if isinstance(v, (int, float, str, bool))},
        }
        return sl

    proc(COORDINATOR_PID, "coordinator")
    thread(COORDINATOR_PID, 0, "protocol")
    coord_slices: dict[tuple[str, int], dict] = {}
    for ev in coord_events:
        phase = ev.get("data", {}).get("phase")
        if phase not in _COORD_PHASES:
            continue
        sl = proto_slice(ev, COORDINATOR_PID, 0)
        if sl is None:
            continue
        out.append(sl)
        rnd = ev.get("data", {}).get("round")
        if rnd is not None:
            coord_slices.setdefault((phase, int(rnd)), sl)

    host_slices: list[tuple[str, int | None, dict]] = []
    for ev in host_events:
        phase = ev.get("data", {}).get("phase")
        if phase not in _HOST_PHASES:
            continue
        pid = int(ev["_host"])
        proc(pid, f"host {pid}")
        thread(pid, PROTOCOL_TID, "supervisor")
        sl = proto_slice(ev, pid, PROTOCOL_TID)
        if sl is None:
            continue
        out.append(sl)
        rnd = ev.get("data", {}).get("round")
        host_slices.append((phase, int(rnd) if rnd is not None
                            else None, sl))

    # -- flows: one per COMMITTED rendezvous cycle -------------------------
    # call (s) -> every host join/ack + the assign (t) -> go (f); rounds
    # that never reached `go` (deadline re-runs) get no flow, so the
    # flow count IS the committed-cycle count
    def flow(ph: str, sl: dict, fid: int) -> dict:
        return {"name": "rendezvous_cycle", "cat": "flow", "ph": ph,
                "id": fid, "ts": sl["ts"], "pid": sl["pid"],
                "tid": sl["tid"]}

    committed = sorted(r for (phase, r) in coord_slices
                       if phase == "go")
    for rnd in committed:
        call = coord_slices.get(("call", rnd))
        go = coord_slices[("go", rnd)]
        src = call if call is not None else go
        out.append(flow("s", src, rnd))
        for phase, r, sl in host_slices:
            if r == rnd and phase in ("join", "ack"):
                out.append(flow("t", sl, rnd))
        assign = coord_slices.get(("assign", rnd))
        if assign is not None:
            out.append(flow("t", assign, rnd))
        out.append(flow("f", go, rnd))

    return {"traceEvents": out, "displayTimeUnit": "ms",
            "epoch_s": round(base, 6)}


def validate_merged(doc: dict) -> list[str]:
    """Schema check for the merged artifact (empty list = clean):
    known phases only, required fields per phase, and balanced flows
    (every flow id has exactly one 's', one 'f', and 's' not after
    'f')."""
    problems = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["not a Chrome-trace object (no traceEvents)"]
    flows: dict = {}
    for n, ev in enumerate(doc["traceEvents"], start=1):
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "I", "s", "t", "f"):
            problems.append(f"event {n}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        for field in ("name", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"event {n}: missing {field!r}")
        if ph == "X" and "dur" not in ev:
            problems.append(f"event {n}: X event without dur")
        if ph in ("s", "t", "f"):
            if "id" not in ev:
                problems.append(f"event {n}: flow without id")
                continue
            flows.setdefault(ev["id"], []).append((ph, ev.get("ts")))
    for fid, steps in sorted(flows.items()):
        starts = [ts for ph, ts in steps if ph == "s"]
        ends = [ts for ph, ts in steps if ph == "f"]
        if len(starts) != 1 or len(ends) != 1:
            problems.append(
                f"flow {fid}: {len(starts)} start(s), "
                f"{len(ends)} finish(es) (want exactly 1 each)")
        elif starts[0] > ends[0]:
            problems.append(f"flow {fid}: starts after it finishes")
    return problems


def count_flows(doc: dict) -> int:
    """Complete flows (an 's' and an 'f' under one id) in the merged
    trace — the committed-rendezvous-cycle count by construction."""
    ids: dict = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") in ("s", "f"):
            ids.setdefault(ev.get("id"), set()).add(ev["ph"])
    return sum(1 for phases in ids.values() if phases == {"s", "f"})


def write_merged(run_dir: str, out_path: str) -> dict:
    """Merge and write atomically; returns the merged object."""
    doc = merge_run(run_dir)
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    return doc
