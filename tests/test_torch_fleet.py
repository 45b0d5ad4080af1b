"""The port's fleet supervision (``supervise/coordinator.py`` and the
supervisor's fleet mode) against the reference's, on the same inputs.

Each case runs the port's and the reference's classes on the same
scripted counterparts (fake hosts answering calls and acking assigns, a
fake coordinator conducting one cycle) and holds the streams they write
— ``coordinator.jsonl`` and ``supervisor.jsonl``, kinds and fields
(the clock's, pids and liveness beats left out) — and their exit codes
equal: every host joins, a host misses the deadline (excluded, the
barrier re-runs), nobody joins, the ``min_hosts`` floor, a spent cycle
budget, a host that never acks, the replanned assignment, a whole run
from a fault report to ``complete``; a host's crash reported and
relaunched on ``go``, an excluded host (exit 4).  The host-sim children
and the kill-a-host cycle are in ``test_torch_fleet_hostsim.py``.
"""

import json
import os
import sys
import textwrap
import threading
import time

import pytest

from stochastic_gradient_push_torch import telemetry as ttel
from stochastic_gradient_push_torch.supervise import (
    coordinator as tco, policy as tpol, supervisor as tsup, tailer as ttail)
from stochastic_gradient_push_tpu import telemetry as rtel
from stochastic_gradient_push_tpu.supervise import (
    coordinator as rco, policy as rpol, supervisor as rsup, tailer as rtail)

PORT = {"co": tco, "pol": tpol, "sup": tsup, "tail": ttail, "tel": ttel}
REF = {"co": rco, "pol": rpol, "sup": rsup, "tail": rtail, "tel": rtel}

# fields that carry a clock reading or a pid
VOLATILE = {"time_to_recover_s", "child_pid"}


def _events(path):
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _shape(evs):
    return [(e["kind"], e["severity"],
             {k: v for k, v in e["data"].items() if k not in VOLATILE})
            for e in evs if (e.get("data") or {}).get("phase") != "alive"]


class _FakeHost(threading.Thread):
    """A scripted host supervisor: reports a fault (optionally), answers
    calls, acks assigns, and says done after the go (optionally)."""

    def __init__(self, m, fleet_dir, host, rows, *, joins=True, acks=True,
                 fault=False, done=False):
        super().__init__(daemon=True)
        self.member = m["co"].FleetMember(fleet_dir, host, rows,
                                          alive_interval_s=60.0)
        os.makedirs(m["co"].host_dir(fleet_dir, host), exist_ok=True)
        self.registry = m["tel"].TelemetryRegistry(rank=0, sinks=[
            m["tel"].JsonlSink(os.path.join(
                m["co"].host_dir(fleet_dir, host),
                m["tel"].SUPERVISOR_EVENTS_FILE))])
        self.member.bind(self.registry)
        self.joins, self.acks, self.done = joins, acks, done
        self.fault = fault
        self.saw_go = threading.Event()
        self.stop = threading.Event()

    def run(self):
        self.member.hello(world=0, generation=0, child_pid=None)
        if self.fault:
            self.member.fault(reason="child-exit (code 1)",
                              action="restart")
        while not self.stop.is_set():
            for ev in self.member.poll():
                data = ev.get("data") or {}
                phase = data.get("phase")
                if ev["kind"] == "rendezvous" and phase == "call" \
                        and self.joins:
                    self.member.join(data["round"])
                elif ev["kind"] == "fleet" and phase == "assign":
                    shard = (data.get("shards") or {}).get(
                        str(self.member.host))
                    if shard is not None and self.acks:
                        self.member.ack(data["round"], ok=True,
                                        mean_drift=1e-8,
                                        out_rank=shard["out_rank"],
                                        out_rows=shard["out_rows"])
                elif ev["kind"] == "fleet" and phase == "go":
                    self.saw_go.set()
                    if self.done:
                        self.member.done(0)
            time.sleep(0.01)
        self.registry.close()


CYCLES = {
    # hosts {id: rows}, fake host options, coordinator options, run()?
    "all-join": ({0: 2, 1: 2}, {}, {}, False),
    "deadline-miss": ({0: 2, 1: 2, 2: 2}, {2: {"joins": False}}, {}, False),
    "nobody-joins": ({0: 2, 1: 2}, {0: {"joins": False},
                                    1: {"joins": False}},
                     {"deadline_s": 0.3}, False),
    "min-hosts": ({0: 2, 1: 2}, {1: {"joins": False}},
                  {"min_hosts": 2, "deadline_s": 0.4}, False),
    "budget-spent": ({0: 2}, {}, {"max_cycles": 0}, False),
    "never-acks": ({0: 1, 1: 3}, {1: {"acks": False}},
                   {"ack_timeout_s": 0.6}, False),
    "replanned": ({0: 2, 1: 1, 2: 3}, {}, {"gossip": True}, False),
    "fault-to-complete": ({0: 2, 1: 2},
                          {0: {"fault": True, "done": True},
                           1: {"done": True}}, {}, True),
}


def _run_cycle(m, d, case):
    hosts, fake_kw, co_kw, whole = CYCLES[case]
    fakes = [_FakeHost(m, d, h, rows, **fake_kw.get(h, {}))
             for h, rows in hosts.items()]
    kw = {"deadline_s": 0.8, "ack_timeout_s": 5.0, "poll_interval_s": 0.03,
          "install_signal_handlers": False, "gossip": False,
          "host_timeout_s": 30.0, **co_kw}
    coord = m["co"].Coordinator(d, hosts, **kw)
    for f in fakes:
        f.start()
    try:
        if whole:
            rc = coord.run()
        else:
            rc = coord._cycle("test-cause")
    finally:
        for f in fakes:
            f.stop.set()
            f.join(timeout=5)
    state = (rc, coord.world, coord.cycle, coord.generation,
             sorted(coord.live), coord.excluded)
    return state, _shape(_events(os.path.join(
        d, m["tel"].COORDINATOR_EVENTS_FILE)))


@pytest.mark.parametrize("case", sorted(CYCLES))
def test_coordinator_decides_what_the_reference_decides(tmp_path, case):
    got = _run_cycle(PORT, str(tmp_path / "port"), case)
    want = _run_cycle(REF, str(tmp_path / "ref"), case)
    assert got == want
    kinds = [(k, d.get("phase")) for k, _, d in want[1]]
    if case in ("all-join", "replanned", "fault-to-complete"):
        assert kinds.count(("fleet", "go")) == 1
    if case == "deadline-miss":
        assert kinds.count(("rendezvous", "call")) == 2 \
            and want[0][5] == [2]
    if case == "replanned":
        plan = [d for k, _, d in want[1] if d.get("phase") == "assign"][0][
            "plan"]
        assert plan["world"] == 6 and plan["topology"]
    if case == "fault-to-complete":
        assert want[0][0] == 0 and kinds[-1] == ("fleet", "complete")


def test_coordinator_refusals_are_the_references(tmp_path):
    for hosts, match in (({}, "at least one host"), ({0: 0}, ">= 1")):
        for m in (PORT, REF):
            with pytest.raises(ValueError, match=match):
                m["co"].Coordinator(str(tmp_path), hosts)
    for m in (PORT, REF):
        with pytest.raises(ValueError, match=">= 1 rank rows"):
            m["co"].FleetMember(str(tmp_path), 0, 0)
        with pytest.raises(RuntimeError, match="bind"):
            m["co"].FleetMember(str(tmp_path), 0, 1).emit("hello")
    assert tco.EXCLUDED_EXIT_CODE == rco.EXCLUDED_EXIT_CODE == 4
    assert tco.host_dir("/f", 3) == rco.host_dir("/f", 3) == "/f/host3"


@pytest.mark.parametrize("argv", [
    ["--selftest", "--coordinator"],
    ["--coordinator", "--host", "0", "--fleet_dir", "/tmp/x"],
    ["--coordinator"],
    ["--host", "0", "--fleet_dir", "/tmp/x"],
])
def test_fleet_cli_usage_errors_are_the_references(argv):
    from stochastic_gradient_push_torch.supervise import fleetcli as tcli
    from stochastic_gradient_push_tpu.supervise import fleetcli as rcli

    argv = argv[1:] if argv[0] == "--selftest" else argv
    for cli in (tcli, rcli):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2


def test_fleet_cli_host_rows_parse_as_the_references():
    import argparse

    from stochastic_gradient_push_torch.supervise import fleetcli as tcli
    from stochastic_gradient_push_tpu.supervise import fleetcli as rcli

    for kw in ({"host_rows": "2,1,3", "hosts": None, "rows": None},
               {"host_rows": None, "hosts": 3, "rows": 2}):
        args = argparse.Namespace(**kw)
        assert tcli._parse_host_rows(args) == rcli._parse_host_rows(args)
    for kw in ({"host_rows": "2,0", "hosts": None, "rows": None},
               {"host_rows": None, "hosts": None, "rows": 2},
               {"host_rows": None, "hosts": 2, "rows": None}):
        args = argparse.Namespace(**kw)
        for cli in (tcli, rcli):
            with pytest.raises(ValueError):
                cli._parse_host_rows(args)


# -- the supervisor's fleet mode ------------------------------------------------


FLEET_CHILD = textwrap.dedent("""
    import json, os, sys, time
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    td = args["--trace_dir"]
    mode_path = os.path.join(td, "mode")
    mode = open(mode_path).read() if os.path.exists(mode_path) else "done"
    with open(os.path.join(td, "events.jsonl"), "a") as f:
        f.write(json.dumps({"v": 1, "kind": "step_stats",
                            "t": time.time(), "rank": 0,
                            "severity": "info", "step": 1,
                            "data": {}}) + "\\n")
    if mode == "crash-once":
        os.remove(mode_path)
        sys.exit(1)
    sys.exit(0)
""")


class _FakeCoordinator(threading.Thread):
    """Scripted coordinator for a one-host fleet: on the host's fault
    report, run call -> assign -> go (or exclude the host)."""

    def __init__(self, m, fleet_dir, *, exclude=False, world=4):
        super().__init__(daemon=True)
        self.registry = m["tel"].TelemetryRegistry(rank=0, sinks=[
            m["tel"].JsonlSink(os.path.join(
                fleet_dir, m["tel"].COORDINATOR_EVENTS_FILE))])
        self.tailer = m["tail"].EventTailer(os.path.join(
            m["co"].host_dir(fleet_dir, 0), m["tel"].SUPERVISOR_EVENTS_FILE))
        self.exclude, self.world = exclude, world
        self.stop = threading.Event()

    def run(self):
        state = "watch"
        while not self.stop.is_set():
            for ev in self.tailer.poll():
                if ev.get("kind") != "rendezvous":
                    continue
                phase = (ev.get("data") or {}).get("phase")
                if phase == "fault" and state == "watch":
                    state = "called"
                    self.registry.emit("rendezvous", {
                        "phase": "call", "round": 1, "cause": "test",
                        "deadline_s": 5.0, "hosts": [0]})
                elif phase == "join" and state == "called":
                    state = "assigned"
                    shards = {} if self.exclude else {
                        "0": {"out_rank": 0, "out_rows": self.world,
                              "host_index": 0, "num_hosts": 1,
                              "rank_offset": 0}}
                    self.registry.emit("fleet", {
                        "phase": "assign", "round": 1, "cycle": 1,
                        "cause": "test", "world": self.world,
                        "prev_world": self.world, "plan": None,
                        "shards": shards,
                        "excluded": [0] if self.exclude else []})
                elif phase == "ack" and state == "assigned":
                    state = "done"
                    self.registry.emit("fleet", {
                        "phase": "go", "round": 1, "cycle": 1,
                        "world": self.world, "prev_world": self.world,
                        "generation": 1, "acks": {"0": None}})
            time.sleep(0.02)
        self.registry.close()


def _fleet_host(m, d, mode, **fake_kw):
    hdir = m["co"].host_dir(d, 0)
    os.makedirs(hdir, exist_ok=True)
    script = os.path.join(d, "fleet_child.py")
    with open(script, "w") as f:
        f.write(FLEET_CHILD)
    with open(os.path.join(hdir, "mode"), "w") as f:
        f.write(mode)
    spec = m["sup"].ChildSpec([sys.executable, script, "--trace_dir", hdir,
                               "--checkpoint_dir", d, "--world_size", "4",
                               "--rows", "4", "--rank_offset", "0"])
    member = m["co"].FleetMember(d, 0, 4, alive_interval_s=60.0)
    sup = m["sup"].Supervisor(spec, m["pol"].SupervisorPolicy(
        world=4, max_restarts=0), poll_interval_s=0.05, fleet=member,
        fleet_timeout_s=10.0, install_signal_handlers=False)
    fake = _FakeCoordinator(m, d, **fake_kw)
    fake.start()
    try:
        rc = sup.run()
    finally:
        fake.stop.set()
        fake.join(timeout=5)
    return rc, _shape(_events(os.path.join(
        hdir, m["tel"].SUPERVISOR_EVENTS_FILE)))


@pytest.mark.parametrize("exclude", [False, True],
                         ids=["relaunch-on-go", "excluded"])
def test_fleet_mode_host_stream_is_the_references(tmp_path, exclude):
    got = _fleet_host(PORT, str(tmp_path / "port"), "crash-once",
                      exclude=exclude)
    want = _fleet_host(REF, str(tmp_path / "ref"), "crash-once",
                       exclude=exclude)
    assert got == want
    assert want[0] == (4 if exclude else 0)
    phases = [d.get("phase") for k, _, d in want[1] if k == "rendezvous"]
    if not exclude:
        assert phases == ["hello", "fault", "join", "ack", "hello", "done"]
        rel = [d for k, _, d in want[1] if k == "relaunch"]
        assert len(rel) == 1 and rel[0]["out_rank"] == 0 \
            and rel[0]["reason"].startswith("fleet-assign")


def test_fleet_relaunch_flags_and_shard_ranks(tmp_path):
    """The relaunch rewrites ``--num_processes/--process_id`` (and a
    child's own ``--rows/--rank_offset``) as the reference does; the
    shard's reshard writes the rank files ``rank_offset .. rank_offset
    + out_rows - 1``."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.supervise import reshard
    from stochastic_gradient_push_torch.supervise.hostsim import HostFiles

    d = str(tmp_path)
    state = {"params": {"w": np.arange(6 * 16, dtype=np.float32).reshape(
        6, 16)}, "gossip": {"ps_weight": np.ones(6, np.float32),
                            "phase": np.zeros(6, np.int32)}}
    for p in range(3):
        rows = {"params": {"w": state["params"]["w"][2 * p:2 * p + 2]},
                "gossip": {k: v[2 * p:2 * p + 2]
                           for k, v in state["gossip"].items()}}
        host = HostFiles(d, "", 6, 1, 0, 2 * p, 2)
        host._stage(rows, {"step": 5})
        host._rename_all()
    argv = [sys.executable, "x.py", "--world_size", "6", "--trace_dir", d,
            "--checkpoint_dir", d, "--num_processes", "3", "--process_id",
            "2", "--rows", "2", "--rank_offset", "4"]
    assign = {"round": 2, "world": 4, "prev_world": 6, "plan": None,
              "cause": "x", "shards": {
                  "1": {"out_rank": 1, "out_rows": 2, "host_index": 1,
                        "num_hosts": 2, "rank_offset": 2}}}
    got = {}
    hd = os.path.join(d, "host1")
    for m, name in ((PORT, "port"), (REF, "ref")):
        spec = m["sup"].ChildSpec(argv, trace_dir=hd)
        sup = m["sup"].Supervisor(spec, fleet=m["co"].FleetMember(hd, 1, 2),
                                  install_signal_handlers=False)
        plan, extra = sup._fleet_relaunch(assign, m["pol"].Action("x"), 0.0)
        got[name] = spec.build_argv(4, plan, True, extra)
        if name == "port":
            sup._fleet_reshard(assign, assign["shards"]["1"])
            assert sup._fleet_report.files_out == tuple(
                os.path.join(d, f"checkpoint_r{r}_n4.ckpt") for r in (2, 3))
    assert got["port"] == got["ref"]
    assert " --num_processes 2 --process_id 1 --rows 2 --rank_offset 2" \
        in " ".join(got["port"])
    assert sorted(f for f in os.listdir(d) if f.endswith("_n4.ckpt")) == [
        "checkpoint_r2_n4.ckpt", "checkpoint_r3_n4.ckpt"]
    row = torch.load(os.path.join(d, "checkpoint_r3_n4.ckpt"),
                     weights_only=True)["state"]
    assert np.allclose(row["params"]["w"].numpy(),
                       state["params"]["w"].mean(0))
    with pytest.raises(reshard.TornCheckpointError, match="want 0..3"):
        reshard.load_world_checkpoint(d, "", 4)


def test_check_fleet_stream_consumes_backlog_and_keeps_tail(tmp_path):
    d = str(tmp_path)
    hdir = tco.host_dir(d, 0)
    os.makedirs(hdir, exist_ok=True)
    spec = tsup.ChildSpec([sys.executable, "x.py", "--trace_dir", hdir,
                           "--checkpoint_dir", d, "--world_size", "4"])
    sup = tsup.Supervisor(spec, tpol.SupervisorPolicy(world=4),
                          fleet=tco.FleetMember(d, 0, 4),
                          install_signal_handlers=False)
    call = {"kind": "rendezvous", "data": {"phase": "call", "round": 7,
                                           "cause": "x"}}
    assign = {"kind": "fleet", "data": {"phase": "assign", "round": 7,
                                        "shards": {}}}
    sup._fleet_backlog = [call, assign]
    act = sup._check_fleet_stream()
    assert act is not None and act.kind == "fleet-rendezvous"
    assert sup._fleet_call["round"] == 7 and sup._fleet_backlog == [assign]
    sup._fleet_backlog = [{"kind": "fleet", "data": {"phase": "halt"}}]
    assert sup._check_fleet_stream().kind == "preempt-exit"


def test_fleet_kinds_render_as_the_references(caplog):
    import logging

    lines = {}
    for name, m in (("port", PORT), ("ref", REF)):
        log = logging.getLogger(f"test_torch_fleet_{name}")
        reg = m["tel"].TelemetryRegistry(rank=0, sinks=[
            m["tel"].LoggerCompatSink(log)])
        caplog.clear()
        with caplog.at_level(logging.INFO, log.name):
            reg.emit("rendezvous", {"phase": "call", "round": 2,
                                    "hosts": [0, 1]})
            reg.emit("fleet", {"phase": "assign", "world": 4,
                               "excluded": [2]})
            reg.emit("supervisor", {"action": "launch", "world": 8})
            reg.emit("relaunch", {"generation": 1})
        lines[name] = [r.message for r in caplog.records]
        with pytest.raises(ValueError):
            reg.emit("resize", {})
    assert lines["port"] == lines["ref"] and len(lines["port"]) == 3
