"""The port's run telemetry (``stochastic_gradient_push_torch/telemetry``)
against the reference's, on the CPU.

- ``CommModel``: for every configuration of a grid (graphs, thinning,
  global averaging, a fault plan, the f32/bf16/int8 codecs with and
  without error feedback, overlap, buckets, a fabric, AllReduce and
  bilateral), the port's model built from the port's schedule equals
  the reference's built from the reference's own schedule: ``to_dict``,
  ``totals(N)``, ``step_bytes(t)`` for every ``t < N`` and the fire
  counts (exact integer math, so exact equality).
- The payload: ``tree_payload_bytes`` and ``encoded_payload_bytes`` of
  the port's parameters (carried from the reference's by
  ``models/convert.py``) equal the reference's for the three codecs,
  a stacked state and a process's own block alike.
- Registry, sinks and producers: the envelope, the closed vocabulary,
  the compatibility lines byte-equal to the direct lines, each once.
- The tracer: the null path reads no clock and allocates nothing.
- The Trainer: the same device syncs with and without telemetry.
- The CLIs: a traced world-8 run read by the reference's
  ``scripts/obsreport.py`` with no problems and its comm bytes equal to
  an independent ``CommModel``; a preempted LM run's trace; 2 gloo
  processes each writing its own ``_r1`` files; the LM's comm model
  fenced off under tp.
"""

import importlib.util
import json
import logging
import os
import re
import signal
import sys
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import telemetry as tt
from stochastic_gradient_push_torch import topology as ttopo
from stochastic_gradient_push_torch.parallel import wire as twire
from stochastic_gradient_push_torch.run import gossip_lm, gossip_sgd
from torch_launch import Rendezvous

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
STEPS = 16


def _rt():
    from stochastic_gradient_push_tpu import telemetry as rt

    return rt


def _load_script(filename, modname):
    spec = importlib.util.spec_from_file_location(
        modname, os.path.join(REPO, filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def obsreport():
    return _load_script(os.path.join("scripts", "obsreport.py"),
                        "obsreport_reads_the_port")


# -- CommModel against the reference's --------------------------------------

SPEC8 = {"v": 1, "world": 8, "phases": [
    {"kind": "edge", "perm": [(r + 1) % 8 for r in range(8)],
     "send": [0.75] * 8},
    {"kind": "psum", "group_size": 4},
    {"kind": "edge", "perm": [4, 1, 2, 3, 0, 5, 6, 7],
     "send": [0.9, 0.3, 0.3, 0.3, 0.9, 0.3, 0.3, 0.3]}]}

# name -> the configuration: graph (class name, kwargs), codec, knobs
GRID = {
    "ring": dict(graph=("RingGraph", {})),
    "exp_ppi2": dict(graph=("NPeerDynamicDirectedExponentialGraph",
                            {"peers_per_itr": 2})),
    "exp_thin_avg": dict(gossip_every=2, global_avg_every=3),
    "exp_faults": dict(faults="drop:0->1@0:4;drop_random:0.3@2:6;seed:5"),
    "ring_faults_thin": dict(graph=("RingGraph", {}), gossip_every=2,
                             faults="blackout:2@1:3;straggler:5;seed:1"),
    "bf16": dict(codec=("bf16", 64)),
    "bf16_ef": dict(codec=("bf16", 64), error_feedback=True),
    "int8": dict(codec=("int8", 32)),
    "int8_ef": dict(codec=("int8", 64), error_feedback=True),
    "overlap_s2": dict(overlap=True, staleness=2, gossip_kernel="pallas"),
    "buckets3": dict(gossip_buckets=3, gossip_kernel="pallas",
                     codec=("int8", 64), error_feedback=True),
    "fabric": dict(interconnect=(4, 16.0)),
    "hierarchical": dict(graph=("HierarchicalGraph", {"slice_size": 4}),
                         interconnect=(4, 16.0)),
    "hierarchical_int8": dict(graph=("HierarchicalGraph",
                                     {"slice_size": 2}),
                              codec=("int8", 64), gossip_every=2),
    "synthesized": dict(graph=("SynthesizedGraph", {"spec": SPEC8}),
                        interconnect=(4, 16.0), global_avg_every=5),
    "dpsgd": dict(ps_weight=False),
    "allreduce": dict(mode="allreduce"),
    "bilat": dict(mode="bilat"),
}

TEMPLATE = {"w": (1000,), "b": (24,), "conv": (3, 3, 3, 16), "s": (1,)}


def _payloads(codec_name, block, stacked=True):
    """``(exact, encoded)`` of one rank's TEMPLATE payload on the port
    (``stacked``: ``[WORLD, ...]`` leaves, else a process's ``[1, ...]``)
    and on the reference."""
    rows = WORLD if stacked else 1
    port = {n: torch.zeros((rows,) + s) for n, s in TEMPLATE.items()}
    ref = {n: np.zeros((rows,) + s, np.float32) for n, s in TEMPLATE.items()}
    from stochastic_gradient_push_tpu.parallel import wire as rwire

    tcodec = twire.get_codec(codec_name, block)
    rcodec = rwire.get_codec(codec_name, block)
    rt = _rt()
    return ((tt.tree_payload_bytes(port, rows),
             tt.encoded_payload_bytes(port, rows, tcodec)),
            (rt.tree_payload_bytes(ref, rows),
             rt.encoded_payload_bytes(ref, rows, rcodec)), tcodec, rcodec)


def _model(side, case):
    """The case's CommModel on one side (``"port"`` or ``"ref"``), built
    from that side's own schedule, fault masks, fabric and codec."""
    if side == "port":
        topo, tel = ttopo, tt
        from stochastic_gradient_push_torch.planner import make_interconnect
        from stochastic_gradient_push_torch.resilience import (
            parse_fault_spec)
    else:
        from stochastic_gradient_push_tpu import topology as topo
        from stochastic_gradient_push_tpu.planner import make_interconnect
        from stochastic_gradient_push_tpu.resilience import parse_fault_spec
        tel = _rt()
    codec_name, block = case.get("codec", (None, 64))
    (t_exact, t_enc), (r_exact, r_enc), tcodec, rcodec = _payloads(
        codec_name, block)
    exact, enc, codec = ((t_exact, t_enc, tcodec) if side == "port"
                         else (r_exact, r_enc, rcodec))
    mode = case.get("mode", "gossip")
    if mode == "allreduce":
        return tel.CommModel.for_allreduce(WORLD, exact)
    if mode == "bilat":
        return tel.CommModel.for_bilat(WORLD, exact)
    name, kw = case.get("graph", ("NPeerDynamicDirectedExponentialGraph",
                                  {}))
    kw = dict(kw)
    ppi = kw.pop("peers_per_itr", 1)
    sched = topo.build_schedule(getattr(topo, name)(WORLD, peers_per_itr=ppi,
                                                    **kw))
    ge = case.get("gossip_every", 1)
    faults = (parse_fault_spec(case["faults"]).build_masks(
        sched, gossip_every=ge) if "faults" in case else None)
    fabric = case.get("interconnect")
    return tel.CommModel.from_schedule(
        sched, enc, exact_bytes=exact, gossip_every=ge,
        global_avg_every=case.get("global_avg_every", 0), faults=faults,
        ps_weight=case.get("ps_weight", True),
        interconnect=(make_interconnect(*fabric) if fabric else None),
        codec=codec, error_feedback=case.get("error_feedback", False),
        overlap=case.get("overlap", False),
        staleness=case.get("staleness", 1),
        gossip_kernel=case.get("gossip_kernel", "xla"),
        gossip_buckets=case.get("gossip_buckets", 1))


@pytest.mark.parametrize("name", sorted(GRID))
def test_comm_model_equals_the_reference(name):
    port, ref = _model("port", GRID[name]), _model("ref", GRID[name])
    assert port.to_dict() == ref.to_dict()
    assert port.totals(STEPS) == ref.totals(STEPS)
    assert port.totals(5, start=7) == ref.totals(5, start=7)
    for t in range(STEPS):
        assert port.step_bytes(t) == ref.step_bytes(t), t
        assert port.gossip_fires(t) == ref.gossip_fires(t)
        assert port.global_avg_fires(t) == ref.global_avg_fires(t)
    assert port.recovery_bytes() == ref.recovery_bytes()
    # the accountant fed steps 0..N-1 reports the model's totals
    acc = tt.CommAccountant(port)
    for t in range(STEPS):
        acc.on_step(t)
    acc.on_recovery()
    want = port.totals(STEPS)
    want["recovery"] += port.recovery_bytes()
    assert acc.snapshot()["bytes"] == want
    assert acc.gossip_rounds == sum(port.gossip_fires(t)
                                    for t in range(STEPS))


def test_comm_model_refusals_equal_the_reference():
    from stochastic_gradient_push_torch.resilience import parse_fault_spec

    for name in ("HierarchicalGraph", "SynthesizedGraph"):
        kw = ({"slice_size": 4} if name == "HierarchicalGraph"
              else {"spec": SPEC8})
        sched = ttopo.build_schedule(getattr(ttopo, name)(WORLD, **kw))
        flat = ttopo.build_schedule(ttopo.RingGraph(WORLD))
        masks = parse_fault_spec("drop:0->1@0:4").build_masks(flat)
        with pytest.raises(ValueError, match="fault pricing is not "
                                             "supported"):
            tt.CommModel.from_schedule(sched, 100, faults=masks)


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_template_payload_equals_the_reference(codec):
    stacked = _payloads(codec, 64, stacked=True)
    block = _payloads(codec, 64, stacked=False)
    assert stacked[0] == stacked[1] == block[0] == block[1]


@pytest.mark.parametrize("codec", [None, "f32", "bf16", "int8"])
def test_model_payload_equals_the_reference(codec):
    """TinyCNN's reference init carried into the port's names by
    ``models/convert.py``, and a small transformer's: the same bytes a
    rank, stacked over the world or a process's own block."""
    import jax

    from stochastic_gradient_push_torch.models.convert import (
        init_params, params_from_jax, vision_params_from_jax)
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.train.step import make_model
    from stochastic_gradient_push_tpu.models import TinyCNN
    from stochastic_gradient_push_tpu.parallel import wire as rwire

    rt = _rt()
    variables = TinyCNN(num_classes=10).init(
        jax.random.PRNGKey(0), np.zeros((4, 16, 16, 3), np.float32))
    ref_trees = [jax.tree.map(np.asarray, variables["params"]),
                 init_params(TransformerConfig(
                     vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                     d_ff=64), seed=0)]
    port_trees = [vision_params_from_jax(
        make_model("tiny_cnn", num_classes=10), variables)[0],
        params_from_jax(ref_trees[1])]
    tcodec, rcodec = (twire.get_codec(codec, 64),
                      rwire.get_codec(codec, 64))
    for ref, port in zip(ref_trees, port_trees):
        stack_r = jax.tree.map(lambda a: np.stack([a] * WORLD), ref)
        stack_p = {n: torch.stack([t] * WORLD) for n, t in port.items()}
        block_p = {n: t[None] for n, t in port.items()}
        want = (rt.tree_payload_bytes(stack_r, WORLD),
                rt.encoded_payload_bytes(stack_r, WORLD, rcodec))
        assert want[0] > 0
        for tree, rows in ((stack_p, WORLD), (block_p, 1)):
            assert (tt.tree_payload_bytes(tree, rows),
                    tt.encoded_payload_bytes(tree, rows, tcodec)) == want
        assert tt.tree_payload_bytes(stack_p, WORLD, itemsize=2) == \
            rt.tree_payload_bytes(stack_r, WORLD, itemsize=2)


# -- registry, sinks, producers ---------------------------------------------


class _ListHandler(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines: list[tuple[str, str]] = []

    def emit(self, record):
        self.lines.append((record.levelname, record.getMessage()))


def _list_logger(name):
    log = logging.getLogger(f"telemetry-port-test-{name}")
    for h in list(log.handlers):
        log.removeHandler(h)
    h = _ListHandler()
    log.addHandler(h)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    return log, h


def test_vocabulary_and_envelope_equal_the_reference(tmp_path):
    rt = _rt()
    assert tt.EVENT_KINDS == rt.EVENT_KINDS
    assert tt.LEGACY_PREFIXES == rt.LEGACY_PREFIXES
    assert tt.SCHEMA_VERSION == rt.SCHEMA_VERSION
    assert tt.SPAN_PHASES == rt.SPAN_PHASES
    assert tt.COMM_CATEGORIES == rt.COMM_CATEGORIES
    assert tt.METRIC_NAMES == rt.METRIC_NAMES
    assert [tt._rank_file(n, r) for n, r in (
                (tt.EVENTS_FILE, 0), (tt.EVENTS_FILE, 1),
                (tt.TRACE_FILE, 3))] == [
        "events.jsonl", "events_r1.jsonl", "trace_r3.json"]
    mem = tt.MemorySink()
    jsonl = tt.JsonlSink(str(tmp_path / tt.EVENTS_FILE))
    reg = tt.TelemetryRegistry(rank=2, sinks=[mem, jsonl],
                               clock=lambda: 12.5)
    ev = reg.emit("health", {"step": 5}, step=5, severity="warning")
    assert ev == {"v": 1, "kind": "health", "t": 12.5, "rank": 2,
                  "severity": "warning", "step": 5, "data": {"step": 5}}
    jsonl.close()
    assert [json.loads(x) for x in
            (tmp_path / tt.EVENTS_FILE).read_text().splitlines()] == [ev]
    assert mem.by_kind("health") == [ev] and reg.counts == {"health": 1}
    with pytest.raises(ValueError, match="unknown event kind"):
        reg.emit("made-up-kind", {})
    with pytest.raises(ValueError, match="severity"):
        reg.emit("health", {}, severity="loud")
    with pytest.raises(TypeError):
        reg.emit("health", "not a dict")


def test_metrics_registry_equals_the_reference():
    rt = _rt()
    out = []
    for mod in (tt, rt):
        m = mod.MetricsRegistry()
        m.counter(mod.metrics.EVENTS_TOTAL, {"kind": "health"}).inc(3)
        m.gauge(mod.metrics.LOSS).set(2.5)
        for v in (0.1, 0.2, 0.4):
            m.histogram(mod.metrics.STEP_TIME_SECONDS).observe(v)
        unregistered = "sgp_" + "nope"   # not a literal the repo lint reads
        with pytest.raises(ValueError, match="unregistered"):
            m.counter(unregistered)
        out.append(m.exposition())
    assert out[0] == out[1]
    spans = [{"ph": "X", "name": "train_step", "dur": d,
              "args": {"timed": d > 1}} for d in (1, 2e5, 3e5)]
    assert tt.step_time_meter(spans).p50 == rt.step_time_meter(spans).p50


def _signals(**kw):
    from stochastic_gradient_push_torch.resilience.monitor import HEALTH_KEYS

    sig = dict.fromkeys(HEALTH_KEYS, 0.0)
    sig.update(ps_w_min=1.0, ps_w_max=1.0, **kw)
    return sig


def test_compat_lines_equal_the_direct_lines():
    """Each producer with a registry publishes its event once, and the
    compatibility sink's line is the line the producer logs without one,
    level included (the monitor's ``sort_keys`` dump against the sink's
    ``default=float`` one)."""
    from stochastic_gradient_push_torch.planner import resolve_topology
    from stochastic_gradient_push_torch.resilience import (HealthMonitor,
                                                           RecoveryPolicy)

    def drive(registry, log):
        mon = HealthMonitor(health_every=2, residual_floor=0.01, log=log,
                            registry=registry)
        pol = RecoveryPolicy(world=WORLD, log=log, registry=registry)
        resolve_topology(WORLD, topology="ring", log=log,
                         registry=registry)
        mon.observe(0, _signals())
        mon.observe(1, _signals())
        report = mon.observe(3, _signals(consensus_residual=0.5,
                                         ef_residual_rms=0.25))
        pol.assess(report)

    direct, direct_h = _list_logger("direct")
    drive(None, direct)
    log, h = _list_logger("compat")
    silent, silent_h = _list_logger("silent")
    mem = tt.MemorySink()
    reg = tt.TelemetryRegistry(sinks=[mem, tt.LoggerCompatSink(log)])
    drive(reg, silent)
    assert h.lines == direct_h.lines
    assert silent_h.lines == []
    assert [e["kind"] for e in mem.events] == ["plan", "health", "health",
                                               "recovery"]
    assert [lvl for lvl, _ in h.lines] == ["INFO", "INFO", "WARNING",
                                           "WARNING"]


def test_route_legacy_keeps_a_producers_prefix(tmp_path):
    main_log, main_h = _list_logger("main")
    trainer_log, trainer_h = _list_logger("trainer")
    rt = tt.make_run_telemetry(str(tmp_path), log=main_log)
    rt.route_legacy(("health",), trainer_log)
    rt.registry.emit("plan", {"topology": "ring"})
    rt.registry.emit("health", {"step": 1})
    rt.registry.emit("step_stats", {"loss": 1.0})
    rt.finish()
    assert main_h.lines == [("INFO", 'gossip plan: {"topology": "ring"}')]
    assert trainer_h.lines == [("INFO", 'gossip health: {"step": 1}')]
    tt.NULL_TELEMETRY.route_legacy(("health",), trainer_log)


def test_watchdog_stall_becomes_a_heartbeat_event():
    from stochastic_gradient_push_torch.utils.profiling import StepWatchdog

    mem = tt.MemorySink()
    clock = iter([0.0] + [100.0] * 50)
    wd = StepWatchdog(timeout=5, rank=3, clock=lambda: next(clock),
                      poll_s=0.01, registry=tt.TelemetryRegistry(
                          sinks=[mem]))
    with wd.step():
        deadline = time.time() + 5
        while not mem.by_kind("heartbeat") and time.time() < deadline:
            time.sleep(0.01)
    assert wd.timed_out
    [ev] = mem.by_kind("heartbeat")
    assert ev["severity"] == "error"
    assert ev["data"] == {"elapsed_s": 100.0, "timeout_s": 5, "rank": 3}


# -- the tracer --------------------------------------------------------------


def test_tracer_chrome_trace_and_the_null_path(tmp_path, monkeypatch,
                                               obsreport):
    calls = {"n": 0}

    def counting_clock():
        calls["n"] += 1
        return 100.0 + calls["n"]

    live = tt.SpanTracer(rank=1, clock=counting_clock)
    with live.span("checkpoint_save", "checkpoint", {"epoch": 0}):
        pass
    live.complete("train_step", "step", 99.0, 0.5, {"steps": 1})
    live.instant("mark")
    assert calls["n"] == 4    # creation, enter, exit, instant
    assert live.durations("train_step") == [0.5]
    path = str(tmp_path / "trace.json")
    live.write(path)
    doc = json.load(open(path))
    assert doc == _rt().SpanTracer.to_chrome(live)
    assert obsreport.check_trace(doc["traceEvents"]) == []

    # disabled: one shared span, no clock read, no allocation
    def poisoned():
        raise AssertionError("the null path read a clock")

    monkeypatch.setattr(time, "time", poisoned)
    null = tt.make_run_telemetry(None)
    assert null is tt.NULL_TELEMETRY and not null.enabled
    assert not hasattr(null.tracer, "_clock")
    s1, s2 = null.span("train_step", "step"), null.span("data", "data")
    assert s1 is s2
    import tracemalloc

    def steps(n):
        for _ in range(n):
            with null.span("train_step", "step"):
                null.trace_complete("x", "step", 0.0, 1.0)
            null.emit_comm()

    tracemalloc.start()
    try:
        steps(1)    # the loop's own first-call state
        before = tracemalloc.get_traced_memory()[0]
        steps(1000)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown == 0
    null.attach_comm(None)
    null.finish()


# -- the Trainer ---------------------------------------------------------------


def _tiny_fit(path, trace_dir, **kw):
    from stochastic_gradient_push_torch.data.pipeline import (
        DistributedSampler, ShardedLoader)
    from stochastic_gradient_push_torch.data.synthetic import (
        synthetic_classification)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.train import loop
    from stochastic_gradient_push_torch.train.step import make_model
    from stochastic_gradient_push_torch.utils.checkpoint import (
        CheckpointManager, ClusterManager)

    world, batch = 4, 4
    images, labels = synthetic_classification(world * batch * 3,
                                              num_classes=4, image_size=8,
                                              seed=0)
    sampler = DistributedSampler(len(images), world)
    loader = ShardedLoader(images, labels, batch, sampler)
    cfg = loop.TrainerConfig(
        graph_class=ttopo.NPeerDynamicDirectedExponentialGraph,
        batch_size=batch, num_epochs=2, num_itr_ignore=0, print_freq=1,
        checkpoint_dir=str(path), num_classes=4, verbose=False,
        health_every=1, residual_floor=1e9, global_avg_every=2,
        trace_dir=trace_dir,
        **{"metrics_every": 2 if trace_dir else 0, **kw})
    cluster = ClusterManager(CheckpointManager(
        str(path), world_size=world, ranks=range(world)),
        install_handlers=False)
    trainer = loop.Trainer(cfg, make_model("tiny_mlp", num_classes=4,
                                           in_features=3 * 8 * 8),
                           StackedTransport(world), cluster_manager=cluster,
                           device="cpu")
    return trainer.fit(trainer.init_state(), loader, sampler,
                       val_loader=loader)


def test_telemetry_adds_no_device_sync(tmp_path, monkeypatch):
    """The counts of ``to_host``, ``torch.cuda.synchronize`` and
    ``Tensor.item`` calls in a fit are the same with and without a trace
    directory, and the traced fit writes its files."""
    from stochastic_gradient_push_torch.train import loop

    counts = dict.fromkeys(("to_host", "synchronize", "item"), 0)

    def counted(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(loop, "to_host", counted("to_host", loop.to_host))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted("synchronize", torch.cuda.synchronize))
    monkeypatch.setattr(torch.Tensor, "item",
                        counted("item", torch.Tensor.item))
    _tiny_fit(tmp_path / "off", None)
    off = dict(counts)
    counts.update(dict.fromkeys(counts, 0))
    tdir = tmp_path / "on" / "telemetry"
    _tiny_fit(tmp_path / "on", str(tdir))
    assert counts == off and off["to_host"] > 0
    events = [json.loads(x) for x in
              (tdir / tt.EVENTS_FILE).read_text().splitlines()]
    kinds = [e["kind"] for e in events]
    assert kinds.count("run_meta") == 1 and kinds.count("step_stats") == 3
    from stochastic_gradient_push_torch.train.step import make_model

    payload = 4 * sum(p.numel() for p in make_model(
        "tiny_mlp", num_classes=4, in_features=3 * 8 * 8).parameters())
    model = tt.CommModel.from_schedule(
        ttopo.build_schedule(ttopo.NPeerDynamicDirectedExponentialGraph(4)),
        payload, global_avg_every=2)
    meta = events[kinds.index("run_meta")]["data"]
    assert meta["comm_model"] == model.to_dict()
    comm = events[-1]["data"]
    assert comm["steps"] == 6 and comm["global_avgs"] == 3
    assert comm["bytes"] == model.totals(6)
    trace = json.loads((tdir / tt.TRACE_FILE).read_text())["traceEvents"]
    names = [e["name"] for e in trace if e["ph"] == "X"]
    assert names.count("train_step") == 6
    assert names.count("validate") == names.count("checkpoint_save") == 2


def test_trainer_refuses_metrics_without_a_trace_dir(tmp_path):
    """The Trainer refuses neither, as the reference's does not
    (``make_run_telemetry``): ``metrics_every`` without a trace directory
    runs with the null bundle and writes no file; ``metrics_every < 0`` is
    clamped to 0, so the traced run writes its final comm snapshot and
    no ``step_stats``.  The CLIs keep their own refusals."""
    _tiny_fit(tmp_path / "a", None, metrics_every=3)
    assert not list((tmp_path / "a").rglob("events*.jsonl"))
    _tiny_fit(tmp_path / "b", str(tmp_path / "t"), metrics_every=-1)
    kinds = [json.loads(x)["kind"] for x in
             (tmp_path / "t" / "events.jsonl").read_text().splitlines()]
    assert "comm" in kinds and "step_stats" not in kinds


# -- the command lines -------------------------------------------------------

SGD = ["--device", "cpu", "--dataset", "synthetic", "--model", "tiny_cnn",
       "--num_classes", "10", "--image_size", "16", "--batch_size", "4",
       "--world_size", str(WORLD), "--num_epochs", "1",
       "--num_iterations_per_training_epoch", "6", "--num_itr_ignore", "0",
       "--topology", "ring", "--gossip_every", "2", "--health_every", "2"]


def _gossip_lines(out: str) -> list[str]:
    """The `gossip plan/health:` lines, the health lines' host timings
    (step p50/p99) blanked."""
    return [re.sub(r'"step_p(50|99)_s": [0-9.e-]+', "T", line)
            for line in out.splitlines()
            if "gossip plan: " in line or "gossip health: " in line]


def test_sgd_cli_trace_read_by_the_reference_obsreport(tmp_path, capfd,
                                                       obsreport):
    import jax

    from stochastic_gradient_push_tpu.models import TinyCNN

    gossip_sgd.main(SGD + ["--checkpoint_dir", str(tmp_path / "plain")])
    plain = capfd.readouterr().out
    tdir = str(tmp_path / "telemetry")
    gossip_sgd.main(SGD + ["--checkpoint_dir", str(tmp_path / "ckpt"),
                           "--metrics_every", "2", "--trace_dir", tdir])
    traced = capfd.readouterr().out
    # the lines as without telemetry, each once
    assert _gossip_lines(traced) == _gossip_lines(plain)
    assert sum("gossip plan: " in x for x in traced.splitlines()) == 1

    events = obsreport.load_events(tdir)
    assert obsreport.check_events(events) == []
    assert {"plan", "run_meta", "health", "comm",
            "step_stats"} <= {e["kind"] for e in events}
    trace = obsreport.load_trace(tdir)
    assert obsreport.check_trace(trace) == []
    steps = [e for e in trace if e.get("ph") == "X"
             and e["name"] == "train_step"]
    assert len(steps) == 6
    assert [e["args"]["gossip"] for e in steps] == [1, 0] * 3

    # an independent model: the reference's own TinyCNN init's payload
    # over the forced ring, thinned by 2
    params = TinyCNN(num_classes=10).init(
        jax.random.PRNGKey(0), np.zeros((4, 16, 16, 3), np.float32))[
        "params"]
    payload = _rt().tree_payload_bytes(params, 1)
    meta = next(e for e in events if e["kind"] == "run_meta")["data"]
    assert meta["comm_model"]["payload_bytes"] == payload
    model = tt.CommModel.from_schedule(
        ttopo.build_schedule(ttopo.RingGraph(WORLD, peers_per_itr=1)),
        payload, gossip_every=2, global_avg_every=0)
    final = [e for e in events if e["kind"] == "comm"][-1]["data"]
    assert final["steps"] == 6 and final["gossip_rounds"] == 3
    assert final["bytes"] == model.totals(6)
    report = obsreport.build_report(tdir)
    assert report["schema_problems"] == []
    assert report["step_time"]["timed_steps"] > 0
    assert report["comm"]["bytes"] == model.totals(6)


@pytest.mark.parametrize("argv,match", [
    (["--metrics_every", "-1", "--trace_dir", "x"],
     "--metrics_every must be >= 0"),
    (["--metrics_every", "5"], "--metrics_every needs --trace_dir"),
])
def test_adpsgd_cli_keeps_the_refusals(argv, match, tmp_path):
    from stochastic_gradient_push_torch.run import gossip_sgd_adpsgd

    with pytest.raises(SystemExit, match=match):
        gossip_sgd_adpsgd.main(SGD[:-6] + ["--checkpoint_dir",
                                           str(tmp_path)] + argv)


LM = ["--device", "cpu", "--vocab_size", "256", "--d_model", "32",
      "--n_layers", "2", "--n_heads", "2", "--d_ff", "64", "--seq_len",
      "32", "--batch_size", "2", "--print_freq", "1", "--corpus_tokens",
      "4000"]
LM_MODULE = "stochastic_gradient_push_torch.run.gossip_lm"


def _events(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def test_lm_comm_model_on_dp_x_sp_and_fenced_off_under_tp(tmp_path):
    runs = {"sp": ["--world_size", "4", "--sp", "2", "--attn", "ring"],
            "tp": ["--world_size", "4", "--tp", "2"]}
    metas = {}
    for name, extra in runs.items():
        tdir = tmp_path / name
        gossip_lm.main(LM + extra + [
            "--num_steps", "2", "--metrics_every", "1", "--trace_dir",
            str(tdir), "--checkpoint_dir", str(tmp_path / f"ck_{name}")])
        events = _events(tdir / tt.EVENTS_FILE)
        metas[name] = next(e["data"] for e in events
                           if e["kind"] == "run_meta")
        assert [e["kind"] for e in events].count("step_stats") == 2
    assert {k: metas["sp"][k] for k in ("world", "dp", "sp", "tp", "ep",
                                        "pp")} == dict(world=4, dp=2, sp=2,
                                                       tp=1, ep=1, pp=1)
    assert metas["sp"]["comm_model"]["world"] == 2
    assert metas["tp"]["comm_model"] is None and metas["tp"]["tp"] == 2


def _spawn(argv, world=None):
    rdv = Rendezvous()
    return [rdv.popen([sys.executable, "-m", LM_MODULE, *argv], r, world,
                      env={"PYTHONPATH": REPO}, cwd=REPO)
            for r in ([None] if world is None else range(world))]


def _wait(procs, timeout=240):
    try:
        return [p.communicate(timeout=timeout)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_preempted_lm_run_still_writes_its_trace(tmp_path):
    tdir = tmp_path / "telemetry"
    csv = tmp_path / "lm_out_n2.csv"
    (proc,) = _spawn(LM + ["--world_size", "2", "--num_steps", "150",
                           "--trace_dir", str(tdir), "--checkpoint_dir",
                           str(tmp_path)])
    deadline = time.time() + 240
    while not (csv.exists() and len(csv.read_text().splitlines()) >= 2):
        assert time.time() < deadline and proc.poll() is None, \
            _wait([proc])[0]
        time.sleep(0.05)
    proc.send_signal(signal.SIGUSR1)
    log = _wait([proc])[0]
    assert proc.returncode == 75, log
    events = _events(tdir / tt.EVENTS_FILE)
    exits = [e for e in events if e["kind"] == "run_meta"
             and "exit_reason" in e["data"]]
    k = len(csv.read_text().splitlines()) - 1
    assert [e["data"]["exit_reason"] for e in exits] == ["preempt-requeue"]
    assert exits[0]["step"] == k and exits[0]["severity"] == "warning"
    assert events[-1]["kind"] == "comm" and events[-1]["data"]["steps"] == k
    trace = json.loads((tdir / tt.TRACE_FILE).read_text())["traceEvents"]
    names = [e["name"] for e in trace if e["ph"] == "X"]
    assert names.count("metrics_fetch") == k
    assert "checkpoint_save" in names


def test_two_gloo_processes_write_their_own_files(tmp_path):
    tdir = tmp_path / "telemetry"
    procs = _spawn(LM + ["--num_steps", "2", "--metrics_every", "1",
                         "--trace_dir", str(tdir), "--checkpoint_dir",
                         str(tmp_path)], world=2)
    logs = _wait(procs)
    assert [p.returncode for p in procs] == [0, 0], logs
    assert sorted(os.listdir(tdir)) == ["events.jsonl", "events_r1.jsonl",
                                        "trace.json", "trace_r1.json"]
    for rank, name in ((0, "events.jsonl"), (1, "events_r1.jsonl")):
        events = _events(tdir / name)
        assert {e["rank"] for e in events} == {rank}
        comm = [e["data"] for e in events if e["kind"] == "comm"][-1]
        assert comm["steps"] == 2 and comm["model"]["world"] == 2
    trace = json.loads((tdir / "trace_r1.json").read_text())
    assert {e["pid"] for e in trace["traceEvents"]} == {1}
