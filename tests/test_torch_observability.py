"""The fleet observability plane on the port, held to the reference.

* ``telemetry/tracemerge.py``: ``merge_run``, ``validate_merged`` and
  ``count_flows`` of both packages on one directory (the port's
  ``sim.replay_campaign`` with the fleet lane off, plus a written
  coordinator stream and host protocol streams) are equal;
* ``telemetry/aggregate.py``: ``FleetAggregator.summary()`` and
  ``.alerts`` of both on that finished directory are equal, and equal
  on a second drain (no wall clock in a finished directory's summary);
  the six merge cases of ``tests/test_fleetmon.py`` on the port
  (rotation by inode, rewind on rotation, event-time order, partial
  lines, a silent stream, a slow stream gating the frontier);
* ``scripts/torch_obsreport.py``: its ``build_report`` equals the
  reference's ``scripts/obsreport.py`` on one port-written
  ``--trace_dir`` run (a 4-step ``run/gossip_sgd.py`` run on the CPU);
  a rank file the reference cannot read gives the port's report its
  ``ckpt_meta``;
* ``torch_obsreport.selftest()`` and ``torch_fleetmon.selftest()``
  return 0 in-process (the latter replays the world-1024 kill-slice
  campaign through the plane, the fleet lane's 1,024 rank files a save
  included).
"""

import importlib.util
import json
import os
import sys

import pytest
import torch

from stochastic_gradient_push_torch.supervise import EventTailer
from stochastic_gradient_push_torch.telemetry import (
    COORDINATOR_EVENTS_FILE,
    EVENTS_FILE,
    JsonlSink,
    SUPERVISOR_EVENTS_FILE,
    TelemetryRegistry,
)
from stochastic_gradient_push_torch.telemetry import tracemerge as ttm
from stochastic_gradient_push_torch.telemetry.aggregate import (
    FleetAggregator,
    SloThresholds,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(filename, modname):
    spec = importlib.util.spec_from_file_location(
        modname, os.path.join(REPO, "scripts", filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- one directory, both packages --------------------------------------------


def _protocol_streams(d):
    """The coordinator's broadcast stream for one committed cycle after a
    deadline-missed round (host 7 lost, 1024 -> 896), and the replies of
    hosts 0 and 1, written through the port's registry."""
    coord = TelemetryRegistry(rank=0, sinks=[JsonlSink(
        os.path.join(d, COORDINATOR_EVENTS_FILE))])
    hosts = {h: TelemetryRegistry(rank=h, sinks=[JsonlSink(os.path.join(
        d, f"host{h}", SUPERVISOR_EVENTS_FILE))]) for h in (0, 1, 7)}
    coord.emit("fleet", {"phase": "start", "world": 1024,
                         "hosts": {str(h): 128 for h in range(8)}})
    for h, reg in hosts.items():
        reg.emit("rendezvous", {"phase": "hello", "host": h, "rows": 128,
                                "world": 1024, "generation": 0})
        reg.emit("rendezvous", {"phase": "alive", "host": h})
    coord.emit("rendezvous", {"phase": "call", "round": 1,
                              "cause": "host-silence: host 7",
                              "deadline_s": 2.0, "hosts": [0, 1, 7]},
               severity="warning")
    for h in (0, 1):
        hosts[h].emit("rendezvous", {"phase": "join", "host": h,
                                     "round": 1, "rows": 128})
    coord.emit("rendezvous", {"phase": "call", "round": 2,
                              "cause": "host-silence: host 7",
                              "deadline_s": 2.0, "hosts": [0, 1]},
               severity="warning")
    for h in (0, 1):
        hosts[h].emit("rendezvous", {"phase": "join", "host": h,
                                     "round": 2, "rows": 128})
    coord.emit("fleet", {
        "phase": "assign", "round": 2, "cycle": 1, "world": 896,
        "prev_world": 1024, "plan": None, "excluded": [7],
        "shards": {str(h): {"out_rank": h, "out_rows": 128,
                            "rank_offset": 128 * h} for h in range(7)}},
        severity="warning")
    for h in (0, 1):
        hosts[h].emit("rendezvous", {"phase": "ack", "host": h,
                                     "round": 2, "ok": True,
                                     "mean_drift": 1e-9})
    coord.emit("fleet", {"phase": "go", "round": 2, "cycle": 1,
                         "world": 896, "prev_world": 1024,
                         "generation": 1, "acks": {"0": 1e-9,
                                                   "1": 1e-9}},
               severity="warning")
    for h in (0, 1):
        hosts[h].emit("rendezvous", {"phase": "done", "host": h,
                                     "rc": 0})
    coord.emit("fleet", {"phase": "complete", "world": 896,
                         "generation": 1, "cycles": 1})
    for reg in (coord, *hosts.values()):
        reg.close()


@pytest.fixture(scope="module")
def fleet_dir(tmp_path_factory):
    from stochastic_gradient_push_torch.sim import replay

    d = str(tmp_path_factory.mktemp("plane"))
    info = replay.replay_campaign(d, fleet=False)
    _protocol_streams(d)
    return d, info


def test_tracemerge_equals_the_references(fleet_dir):
    from stochastic_gradient_push_tpu.telemetry import tracemerge as rtm

    d, _ = fleet_dir
    mine, ref = ttm.merge_run(d), rtm.merge_run(d)
    assert mine == ref
    assert ttm.validate_merged(mine) == rtm.validate_merged(ref) == []
    assert ttm.count_flows(mine) == rtm.count_flows(ref) == 1
    assert (ttm.RUN_PID_BASE, ttm.COORDINATOR_PID) == (
        rtm.RUN_PID_BASE, rtm.COORDINATOR_PID)
    # the killed host wrote no trace: 7 host processes, the run's rank,
    # the coordinator
    pids = {ev["pid"] for ev in mine["traceEvents"]}
    assert pids == set(range(8)) | {ttm.RUN_PID_BASE, ttm.COORDINATOR_PID}
    out = os.path.join(d, "merged", "trace.json")
    assert ttm.write_merged(d, out) == json.load(open(out))


def test_aggregator_equals_the_references(fleet_dir):
    from stochastic_gradient_push_tpu.telemetry.aggregate import (
        FleetAggregator as RefAggregator)
    from stochastic_gradient_push_tpu.telemetry.aggregate import (
        SloThresholds as RefThresholds)

    d, info = fleet_dir
    out = {}
    for name, cls, thr in (("port", FleetAggregator, SloThresholds),
                           ("ref", RefAggregator, RefThresholds)):
        agg = cls(d, thresholds=thr(heartbeat_silence_s=1.0),
                  write_alerts=False)
        released = agg.drain()
        out[name] = (released, agg.summary(), agg.alerts,
                     agg.metrics.exposition())
        agg.close()
    assert out["port"] == out["ref"]
    released, summary, alerts, _ = out["port"]
    assert released > 0 and summary["fleet_outcome"] == "complete"
    rules = sorted({a["rule"] for a in alerts})
    assert rules == ["heartbeat-silence", "mass-conservation"]
    silence = [a for a in alerts if a["rule"] == "heartbeat-silence"]
    assert silence[0]["host"] == info["kill_host"]
    assert abs(silence[0]["at_t"] - info["t_last_victim_event"]
               - 1.0) < 0.5
    # a finished directory's summary reads no clock: a second drain,
    # later, gives the same
    again = FleetAggregator(d, thresholds=SloThresholds(
        heartbeat_silence_s=1.0), write_alerts=False)
    again.drain()
    assert again.summary() == summary
    again.close()


# -- the reference's merge cases (tests/test_fleetmon.py) on the port --------


def _append(path, *events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def _ev(t, kind="health", host=None, **data):
    ev = {"v": 1, "t": round(t, 6), "kind": kind, "data": data}
    if host is not None:
        ev["host"] = host
    return ev


def _host_stream(run_dir, host):
    return os.path.join(run_dir, f"host{host}", EVENTS_FILE)


def _agg(run_dir, **kw):
    kw.setdefault("write_alerts", False)
    return FleetAggregator(str(run_dir), **kw)


class TestSameMtimeRotation:
    def test_rotation_detected_by_inode_not_mtime_or_size(self, tmp_path):
        path = tmp_path / EVENTS_FILE
        _append(str(path), _ev(0.1, step=1))
        tailer = EventTailer(str(path))
        assert [e["data"]["step"] for e in tailer.poll()] == [1]
        old = os.stat(path)

        # rotate: a NEW file takes the name with byte-identical size and
        # the same mtime — only the inode differs.  (A relaunched run
        # recreating events.jsonl within the filesystem's mtime
        # granularity looks exactly like this.)
        repl = tmp_path / "rotated.jsonl"
        _append(str(repl), _ev(0.2, step=2))
        assert os.stat(repl).st_size == old.st_size
        os.utime(repl, ns=(old.st_atime_ns, old.st_mtime_ns))
        os.replace(repl, path)
        st = os.stat(path)
        assert st.st_ino != old.st_ino
        assert (st.st_size, st.st_mtime_ns) == (old.st_size,
                                                old.st_mtime_ns)

        # a position-keyed or mtime-keyed reader would see "no change"
        # and deliver nothing; the inode-keyed reset re-reads from 0
        assert [e["data"]["step"] for e in tailer.poll()] == [2]
        assert tailer.skipped == 0

    def test_rotation_mid_merge_rewinds_one_stream_only(self, tmp_path):
        h0, h1 = _host_stream(tmp_path, 0), _host_stream(tmp_path, 1)
        _append(h0, _ev(0.1, step=1), _ev(0.2, step=2))
        _append(h1, _ev(0.2, step=1))
        agg = _agg(tmp_path)
        agg.poll()

        # host0 rotates in place with the same size + mtime
        old = os.stat(h0)
        repl = os.path.join(os.path.dirname(h0), "repl.jsonl")
        _append(repl, _ev(0.3, step=3))
        pad = old.st_size - os.stat(repl).st_size
        assert pad > 0
        with open(repl, "a") as f:   # newline padding: size-identical
            f.write("\n" * pad)
        os.utime(repl, ns=(old.st_atime_ns, old.st_mtime_ns))
        os.replace(repl, h0)
        assert os.stat(h0).st_ino != old.st_ino

        _append(h1, _ev(0.4, step=2))
        total = agg.drain()
        agg.close()
        # every event from both generations of host0 plus host1's two:
        # the rewind re-read only the rotated stream, dropped nothing
        assert agg.emitted == 5
        assert total == 2


class TestConcurrentWriters:
    def test_interleaved_appends_release_in_event_time_order(
            self, tmp_path):
        h0, h1 = _host_stream(tmp_path, 0), _host_stream(tmp_path, 1)
        coord = os.path.join(str(tmp_path), COORDINATOR_EVENTS_FILE)
        agg = _agg(tmp_path)

        released_t = []
        orig = agg._consume

        def record(ev):
            released_t.append(float(ev["t"]))
            orig(ev)

        agg._consume = record

        # round 1: skewed appends — host1 runs ahead of host0
        _append(h0, _ev(0.10, host=0), _ev(0.30, host=0))
        _append(h1, _ev(0.25, host=1), _ev(0.50, host=1))
        _append(coord, _ev(0.40, kind="rendezvous", phase="call"))
        agg.poll()
        # frontier = min watermark = host0 @ 0.30: the 0.40 and 0.50
        # events stay buffered — host0 could still emit before them
        assert released_t == [0.10, 0.25, 0.30]

        # round 2: host0 catches up, but the coordinator (quiet since
        # 0.40, still within silence_s) now gates the frontier — 0.50
        # stays buffered behind a stream that could yet precede it
        _append(h0, _ev(0.60, host=0))
        _append(h1, _ev(0.55, host=1))
        agg.poll()
        assert released_t == [0.10, 0.25, 0.30, 0.40]

        agg.drain()
        agg.close()
        assert released_t == sorted(released_t)
        assert agg.emitted == 7
        assert agg.late_events == 0
        assert agg.streams == [
            COORDINATOR_EVENTS_FILE,
            os.path.join("host0", EVENTS_FILE),
            os.path.join("host1", EVENTS_FILE)]

    def test_partial_line_from_live_writer_never_splits_an_event(
            self, tmp_path):
        # one writer flushes mid-line while the merge polls: the torn
        # tail must neither parse nor poison later reads
        h0, h1 = _host_stream(tmp_path, 0), _host_stream(tmp_path, 1)
        _append(h1, _ev(0.1, host=1))
        line = json.dumps(_ev(0.15, host=0))
        os.makedirs(os.path.dirname(h0), exist_ok=True)
        with open(h0, "w") as f:
            f.write(line[:12])
        agg = _agg(tmp_path)
        agg.poll()
        # the torn line is buffered unparsed; host0 has produced no
        # complete event yet, so it has no watermark and cannot gate —
        # h1's event releases
        assert agg.emitted == 1
        with open(h0, "a") as f:
            f.write(line[12:] + "\n")
        agg.drain()
        agg.close()
        assert agg.emitted == 2
        assert agg.late_events == 0  # the joined event arrived whole
        tailers = [s.tailer for s in agg._streams.values()]
        assert sum(t.skipped for t in tailers) == 0


class TestStragglerSilence:
    def test_silent_stream_leaves_frontier_and_backfill_is_late(
            self, tmp_path):
        h0, h1 = _host_stream(tmp_path, 0), _host_stream(tmp_path, 1)
        thr = SloThresholds(heartbeat_silence_s=10.0)  # isolate merge
        agg = _agg(tmp_path, silence_s=0.5, thresholds=thr)

        _append(h0, _ev(0.1, host=0))
        _append(h1, _ev(0.1, host=1))
        agg.poll()
        assert agg.emitted == 2

        # host1 dies mid-merge; host0 keeps emitting well past
        # silence_s of event time
        _append(h0, _ev(0.4, host=0), _ev(0.9, host=0))
        agg.poll()
        # host1's watermark (0.1) lags the fleet max (0.9) by more than
        # silence_s: it is dropped from the frontier and host0's whole
        # tail releases — the dead host did not stall the merge
        assert agg.emitted == 4
        assert agg.late_events == 0

        # the straggler backfills BEHIND the released frontier: counted
        # as late, still consumed — totals stay exact
        _append(h1, _ev(0.5, host=1))
        agg.poll()
        agg.close()
        assert agg.emitted == 5
        assert agg.late_events == 1

    def test_slow_but_live_stream_still_gates_the_frontier(
            self, tmp_path):
        # the dual: within silence_s, a slow host DOES hold events back
        # (withholding, not reordering, is the merge's failure mode)
        h0, h1 = _host_stream(tmp_path, 0), _host_stream(tmp_path, 1)
        agg = _agg(tmp_path, silence_s=5.0)
        _append(h0, _ev(0.1, host=0))
        _append(h1, _ev(0.1, host=1), _ev(2.0, host=1))
        agg.poll()
        assert agg.emitted == 2          # 2.0 buffered, not released
        _append(h0, _ev(2.5, host=0))
        agg.poll()
        assert agg.emitted == 3          # 2.5 now gated by h1 @ 2.0
        agg.drain()
        agg.close()
        assert agg.emitted == 4
        assert agg.late_events == 0


# -- obsreport: the port's report is the reference's -------------------------

SGD = ["--device", "cpu", "--dataset", "synthetic", "--model", "tiny_cnn",
       "--num_classes", "10", "--image_size", "16", "--batch_size", "4",
       "--world_size", "4", "--num_epochs", "1",
       "--num_iterations_per_training_epoch", "4", "--num_itr_ignore", "0",
       "--topology", "ring", "--health_every", "1", "--metrics_every", "1"]


def test_obsreport_equals_the_references_on_a_port_run(tmp_path):
    from stochastic_gradient_push_torch.run import gossip_sgd

    ref = _load_script("obsreport.py", "obsreport_of_the_reference")
    mine = _load_script("torch_obsreport.py", "torch_obsreport_of_a_run")
    tdir = str(tmp_path / "telemetry")
    gossip_sgd.main(SGD + ["--checkpoint_dir", str(tmp_path / "ckpt"),
                           "--trace_dir", tdir])
    report = mine.build_report(tdir)
    assert report == ref.build_report(tdir)
    assert mine.render(report) == ref.render(report)
    assert report["schema_problems"] == []
    # the first two steps of a shape are warm-up, untimed
    assert report["step_time"]["timed_steps"] == 2
    assert report["comm"]["steps"] == 4
    assert report["health"]["reports"] == 4
    assert mine.main([tdir, "--json"]) == 0
    assert mine.main([str(tmp_path / "ckpt" / "none")]) == 2

    # a rank file beside the events: only the port's reader opens the
    # torch.save layout (the reference's needs flax msgpack)
    ckpt = tmp_path / "ckpt"
    name = sorted(f for f in os.listdir(ckpt) if f.endswith(".ckpt"))[0]
    os.link(ckpt / name, os.path.join(tdir, name))
    meta = mine.load_ckpt_meta(tdir)
    assert meta["_file"] == name and meta["epoch"] == 1
    assert "plan" in meta and "health" in meta


def test_obsreport_selftest_in_process(capsys):
    mine = _load_script("torch_obsreport.py", "torch_obsreport_selftest")
    assert mine.selftest() == 0
    assert "obsreport selftest: OK" in capsys.readouterr().out


def test_fleetmon_selftest_in_process(capsys):
    mine = _load_script("torch_fleetmon.py", "torch_fleetmon_selftest")
    assert mine.selftest() == 0
    out = capsys.readouterr().out
    assert "fleetmon selftest: OK" in out
    assert "kill host 7 at tick 100, fleet rc 0" in out
