"""The port's supervisor (``stochastic_gradient_push_torch/supervise/``)
against the reference's modules, on the same inputs.

Exact equality throughout: the ``EventTailer`` over the same byte
streams (partial lines, truncation, rotation, malformed lines, unknown
kinds), ``SupervisorPolicy`` over the same scripted events, exits and
relaunches (actions and backoff seconds), ``ChildSpec`` and its
``build_argv`` over the same argv and plans (the module name mapped),
``replan_for`` over a grid of worlds and stamped plans,
``stamped_plan`` over the two file formats, and the ``Supervisor``'s
``supervisor.jsonl`` (kinds and fields, the clock's left out) over the
same fake children.  The chaos trigger waits for a whole set of one
save.  The end-to-end cycle of the port's image CLI is in
``test_torch_supervise_cli.py``.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.supervise import (
    policy as tpol, replan as trep, supervisor as tsup, tailer as ttail)
from stochastic_gradient_push_tpu.supervise import (
    policy as rpol, replan as rrep, supervisor as rsup, tailer as rtail)

REQUEUE = 75


def _train_state(step, w, ps, phase=0):
    """A rank-stacked train state of one ``w`` leaf, as the trainer
    saves it."""
    from stochastic_gradient_push_torch.algorithms.api import GossipState
    from stochastic_gradient_push_torch.train.state import TrainState

    return TrainState(step=step, params={"w": w}, opt_state={},
                      batch_stats={},
                      gossip=GossipState(phase=phase, ps_weight=ps,
                                         in_flight=(), ef_residual=None))


def _ev(kind="step_stats", step=0, severity="info", **data):
    return {"v": 1, "kind": kind, "t": 0.0, "rank": 0,
            "severity": severity, "step": step, "data": data}


# -- EventTailer --------------------------------------------------------------


def _line(**kw):
    return json.dumps(_ev(**kw)) + "\n"


TAILER_SCRIPTS = {
    "incremental": [("append", _line(step=1)), ("poll",),
                    ("append", _line(step=2) + _line(step=3)), ("poll",),
                    ("poll",)],
    "partial-line": [("append", _line(step=1) + _line(step=2)[:17]),
                     ("poll",), ("append", _line(step=2)[17:]), ("poll",),
                     ("append", _line(step=3)[:-1]), ("poll",),
                     ("append", "\n"), ("poll",)],
    "malformed": [("append", "not json\n" + "[1, 2]\n" + _line(step=4)
                   + "\n\n" + '{"kind": "x"\n'), ("poll",)],
    "truncation": [("append", _line(step=1) + _line(step=2)), ("poll",),
                   ("truncate", _line(step=9)), ("poll",),
                   ("append", _line(step=10)), ("poll",)],
    "rotation": [("append", _line(step=1)), ("poll",),
                 ("rotate", _line(step=1) + _line(step=2) + _line(step=3)),
                 ("poll",)],
    "unknown-kinds": [("append", _line(kind="resize", step=1)
                       + _line(kind="future_kind", step=2, x=[1, 2])),
                      ("poll",)],
    "missing-then-created": [("poll",), ("append", _line(step=5)),
                             ("poll",)],
}


def _apply(path, op):
    kind = op[0]
    if kind == "append":
        with open(path, "a") as f:
            f.write(op[1])
    elif kind == "truncate":
        with open(path, "r+") as f:
            f.truncate(0)
            f.write(op[1])
    elif kind == "rotate":
        tmp = path + ".new"
        with open(tmp, "w") as f:
            f.write(op[1])
        os.replace(tmp, path)


@pytest.mark.parametrize("script", sorted(TAILER_SCRIPTS))
def test_tailer_reads_what_the_references_reads(tmp_path, script):
    path = str(tmp_path / "events.jsonl")
    port, ref = ttail.EventTailer(path), rtail.EventTailer(path)
    got, want = [], []
    for op in TAILER_SCRIPTS[script]:
        if op[0] == "poll":
            got.append(port.poll())
            want.append(ref.poll())
        else:
            _apply(path, op)
    assert got == want and any(want)
    assert (port.skipped, port.events_seen) == (ref.skipped, ref.events_seen)


# -- SupervisorPolicy ----------------------------------------------------------


def _suggest(step, switch=True):
    ev = _ev("recovery", step=step, severity="warning")
    ev["data"] = {"step": step, "suggestion": {"switch": switch}}
    return ev


POLICY_SCRIPTS = {
    "transient": ({"world": 8, "replan_count": 3,
                   "replan_cooldown_steps": 20},
                  [("observe", _suggest(10))]),
    "flapping": ({"world": 8, "replan_count": 2,
                  "replan_cooldown_steps": 10},
                 [("observe", _suggest(10)),
                  ("observe", _suggest(15, switch=False)),
                  ("observe", _suggest(30)), ("observe", _suggest(35)),
                  ("observe", _suggest(45))]),
    "burst": ({"world": 8, "replan_count": 3, "replan_cooldown_steps": 20},
              [("observe", _suggest(100))] * 5),
    "sustained-once": ({"world": 8, "replan_count": 2,
                        "replan_cooldown_steps": 5},
                       [("observe", _suggest(0)), ("observe", _suggest(10)),
                        ("relaunched", 8, False), ("observe", _suggest(20)),
                        ("backoff",)]),
    "stall-and-silence": ({"world": 8, "stall_count": 2},
                          [("observe", _ev("heartbeat", severity="error")),
                           ("observe", _ev("heartbeat")),
                           ("observe", _ev("heartbeat", severity="error")),
                           ("stale", 61.0), ("target", True)]),
    "exits-and-budget": ({"world": 8, "max_restarts": 1, "min_world": 4},
                         [("exit", 0), ("exit", REQUEUE), ("exit", -9),
                          ("target", True), ("relaunched", 4, True),
                          ("target", True), ("exit", -9), ("exit", REQUEUE),
                          ("observe", _suggest(1)), ("observe", _suggest(50)),
                          ("observe", _suggest(90))]),
    "backoff-and-refill": ({"world": 4, "backoff_base_s": 2.0,
                            "backoff_max_s": 10.0, "refill_steps": 30,
                            "jitter_salt": 3},
                           [("exit", 1), ("relaunched", 2, True),
                            ("backoff",), ("exit", 1),
                            ("relaunched", 1, True), ("backoff",),
                            ("relaunched", 1, True), ("backoff",),
                            ("relaunched", 1, True), ("backoff",),
                            ("observe", _ev(step=5)),
                            ("observe", _ev(step=20)),
                            ("observe", _ev(step=40)), ("backoff",),
                            ("relaunched", 1, False), ("backoff",),
                            ("observe", _ev(step=3)),
                            ("observe", _ev(step=1)),
                            ("observe", _ev(step=31))]),
    "no-refill": ({"world": 4, "refill_steps": 0, "max_restarts": 2},
                  [("relaunched", 4, True), ("observe", _ev(step=1)),
                   ("observe", _ev(step=10_000)), ("exit", 1),
                   ("relaunched", 4, True), ("exit", 1)]),
}


def _drive_policy(cls, kwargs, script):
    p = cls(**kwargs)
    out = []
    for op in script:
        if op[0] == "observe":
            a = p.observe(op[1])
        elif op[0] == "exit":
            a = p.on_child_exit(op[1])
        elif op[0] == "stale":
            a = p.on_stale(op[1])
        elif op[0] == "relaunched":
            p.mark_relaunched(op[1], failure=op[2])
            a = None
        elif op[0] == "backoff":
            out.append(p.next_backoff_s())
            continue
        elif op[0] == "target":
            out.append(p.target_world(op[1]))
            continue
        out.append(None if a is None else (a.kind, a.reason, a.shrink))
        out.append((p.world, p.generation, p.restarts,
                    p.consecutive_failures))
    return out


@pytest.mark.parametrize("script", sorted(POLICY_SCRIPTS))
def test_policy_decides_what_the_reference_decides(script):
    kwargs, ops = POLICY_SCRIPTS[script]
    got = _drive_policy(tpol.SupervisorPolicy, kwargs, ops)
    want = _drive_policy(rpol.SupervisorPolicy, kwargs, ops)
    assert got == want
    assert any(isinstance(x, tuple) and len(x) == 3 for x in want) or \
        script in ("transient", "burst")


def test_backoff_seconds_are_the_references_over_a_grid():
    for salt in (0, 1, 7):
        for gen in range(6):
            for k in range(1, 8):
                kw = {"world": 4, "jitter_salt": salt, "backoff_base_s": 0.5,
                      "backoff_max_s": 20.0, "backoff_jitter": 0.4}
                p, r = tpol.SupervisorPolicy(**kw), rpol.SupervisorPolicy(**kw)
                for q in (p, r):
                    q.generation, q.consecutive_failures = gen, k
                assert p.next_backoff_s() == r.next_backoff_s()


def test_policy_rejects_an_empty_world():
    with pytest.raises(ValueError, match="world must be >= 1"):
        tpol.SupervisorPolicy(world=0)


# -- ChildSpec ----------------------------------------------------------------


def _both(argv_tail, lm=False):
    mod = "run.gossip_lm" if lm else "run.gossip_sgd"
    head = ["python", "-m"]
    return (head + [f"stochastic_gradient_push_torch.{mod}"] + argv_tail,
            head + [f"stochastic_gradient_push_tpu.{mod}"] + argv_tail)


ARGVS = {
    "sgd": (["--world_size", "8", "--trace_dir", "/runs/t",
             "--checkpoint_dir", "/ck", "--topology", "ring",
             "--requeue_command", "x"], False),
    "sgd-equals": (["--world_size=8", "--trace_dir=/t", "--push_sum",
                    "False", "--overlap", "True", "--inject_faults",
                    "drop:0->1@0:4", "--gap_floor", "0.2", "--slice_size",
                    "4", "--synth_seed", "3", "--resume", "False"], False),
    "lm": (["--world_size", "4", "--trace_dir", "/t", "--device", "cpu",
            "--all_reduce", "True"], True),
    "lm-tagged": (["--world_size", "4", "--trace_dir", "/t", "--tag", "x_",
                   "--bilat", "True"], True),
}

PLANS = {
    "none": None,
    "flat": {"topology": "bipartite-exponential", "world": 4,
             "global_avg_every": 10, "slice_size": None, "alpha": 0.7},
    "hierarchical": {"topology": "hierarchical", "world": 4,
                     "global_avg_every": 0, "slice_size": 2, "alpha": None},
    "sliced-fabric": {"topology": "exponential", "world": 4,
                      "global_avg_every": None, "alpha": None,
                      "interconnect": {"slice_size": 2, "dcn_cost": 16.0}},
    "synth": {"topology": "synth", "world": 4, "global_avg_every": 0,
              "alpha": None, "synth": {"seed": 1, "budget": 300,
                                       "beam_width": None,
                                       "max_phases": 4}},
}


@pytest.mark.parametrize("argv", sorted(ARGVS))
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_build_argv_is_the_references(argv, plan):
    tail, lm = ARGVS[argv]
    port_argv, ref_argv = _both(tail, lm)
    port, ref = tsup.ChildSpec(port_argv), rsup.ChildSpec(ref_argv)
    for attr in ("checkpoint_dir", "trace_dir", "is_lm", "tag", "world",
                 "all_reduce", "bilat", "algorithm", "gossip", "overlap",
                 "faults", "gap_floor"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.is_lm == lm
    mapped = lambda a: [x.replace("stochastic_gradient_push_tpu",
                                  "stochastic_gradient_push_torch")
                        for x in a]
    for world, resume, extra in ((2, True, None), (8, False, None),
                                 (4, True, {"--num_processes": 2,
                                            "--process_id": 1})):
        assert port.build_argv(world, PLANS[plan], resume, extra) == mapped(
            ref.build_argv(world, PLANS[plan], resume, extra))


def test_child_spec_refusals_are_the_references():
    for argv, match in ((["python", "x.py", "--world_size", "8"], "trace_dir"),
                        (["python", "x.py", "--trace_dir", "/t"],
                         "world size"), ([], "empty")):
        with pytest.raises(ValueError, match=match):
            rsup.ChildSpec(argv)
        with pytest.raises(ValueError, match=match):
            tsup.ChildSpec(argv)


# -- replan ---------------------------------------------------------------------


def _stamps():
    from stochastic_gradient_push_tpu import planner as rp

    fabric = rp.make_interconnect(slice_size=4, dcn_cost=16.0)
    return {
        "none": None,
        "flat": rp.plan_for(8).to_dict(),
        "self-weighted": rp.plan_for(
            8, constraints=rp.PlanConstraints(self_weighted=True)).to_dict(),
        "fabric": rp.plan_for(
            8, constraints=rp.PlanConstraints(interconnect=fabric)).to_dict(),
        "wire": rp.plan_for(8, constraints=rp.PlanConstraints(
            wire={"dtype": "int8", "block": 256,
                  "error_feedback": True})).to_dict(),
        "floor": rp.plan_for(
            8, constraints=rp.PlanConstraints(floor=0.6)).to_dict(),
        "synth": rp.plan_for(8, constraints=rp.PlanConstraints(
            interconnect=fabric, synth={"seed": 0, "budget": 60,
                                        "beam_width": 2,
                                        "max_phases": 3})).to_dict(),
    }


@pytest.mark.parametrize("stamp", ["none", "flat", "self-weighted", "fabric",
                                   "wire", "floor", "synth"])
def test_replan_for_is_the_references(stamp):
    stamped = _stamps()[stamp]
    for world in (1, 2, 3, 4, 6, 8, 12, 16):
        for kw in ({}, {"algorithm": "dpsgd", "gap_floor": 0.3},
                   {"faults": True, "overlap": True}, {"gossip": False}):
            if stamp == "synth" and world > 8:
                continue   # the search's cost grows with the world
            want = rrep.replan_for(world, stamped, **kw)
            got = trep.replan_for(world, stamped, **kw)
            assert got == want, (world, kw)


def test_stamped_plan_reads_both_formats_alike(tmp_path):
    """The port's rank file (torch.save, JSON meta) and the reference's
    (msgpack) carrying the same meta give the same stamp; the newest
    file wins; no set or a foreign file gives None."""
    import flax.serialization

    from stochastic_gradient_push_torch.utils.checkpoint import (
        CheckpointManager)
    from stochastic_gradient_push_tpu.planner import plan_for

    assert trep.stamped_plan(str(tmp_path), "") is None
    plan = plan_for(4).to_dict()
    old = {"epoch": 1, "itr": 0, "plan": {"topology": "ring"}}
    new = {"epoch": 2, "itr": 0, "plan": plan}
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for meta, world in ((old, 2), (new, 4)):
        CheckpointManager(str(port_dir), world_size=world,
                          ranks=range(world)).save(
            _train_state(1, torch.ones(world, 3), torch.ones(world)), meta)
        os.makedirs(ref_dir, exist_ok=True)
        with open(ref_dir / f"checkpoint_r0_n{world}.ckpt", "wb") as f:
            f.write(flax.serialization.msgpack_serialize(
                {"state": {"x": np.zeros(2)}, "meta": meta}))
        time.sleep(0.02)
    assert trep.stamped_plan(str(port_dir), "") == plan
    assert rrep.stamped_plan(str(ref_dir), "") == plan
    assert trep.stamped_plan(str(port_dir), "lm_") is None
    (port_dir / "checkpoint_r0_n9.ckpt").write_bytes(b"not a checkpoint")
    assert trep.stamped_plan(str(port_dir), "") is None


# -- Supervisor lifecycle against the reference's -----------------------------


FAKE_CHILD = textwrap.dedent("""
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
    if mode == "requeue-once":
        os.remove(mode_path)
        sys.exit(75)
    if mode == "crash-once":
        os.remove(mode_path)
        sys.exit(1)
    if mode == "crash-always":
        sys.exit(1)
    sys.exit(0)
""")

DRAIN_CHILD = textwrap.dedent("""
    import json, os, signal, sys, time
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    td = args["--trace_dir"]

    def emit(step):
        with open(os.path.join(td, "events.jsonl"), "a") as f:
            f.write(json.dumps({
                "v": 1, "kind": "recovery", "t": time.time(),
                "rank": 0, "severity": "warning", "step": step,
                "data": {"step": step, "suggestion": {"switch": True}},
            }) + "\\n")

    if os.path.exists(os.path.join(td, "gen1")):
        sys.exit(0)  # the relaunched generation is healthy
    open(os.path.join(td, "gen1"), "w").close()

    def drain(signum, frame):
        emit(100)
        emit(101)
        sys.exit(75)
    signal.signal(signal.SIGUSR1, drain)
    emit(1)
    emit(2)
    for _ in range(200):
        time.sleep(0.1)
    sys.exit(3)
""")

# the clock's fields, which no two runs share
VOLATILE = {"time_to_recover_s"}


def _events(path):
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _shape(evs):
    """Kinds and fields of a stream, the clock's left out, the world's
    and the run's paths made relative."""
    out = []
    for e in evs:
        data = {k: v for k, v in e["data"].items() if k not in VOLATILE}
        out.append((e["kind"], e["severity"], e.get("step"), data))
    return out


def _run_lifecycle(mod, d, mode, script, policy_kw, sup_kw, world_state):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "child.py")
    with open(path, "w") as f:
        f.write(script)
    if mode:
        with open(os.path.join(d, "mode"), "w") as f:
            f.write(mode)
    if world_state is not None:
        world_state(d)
    spec = mod.ChildSpec([sys.executable, path, "--trace_dir", d,
                          "--checkpoint_dir", d, "--world_size", "4"])
    sup = mod.Supervisor(spec, mod.SupervisorPolicy(world=4, **policy_kw),
                         poll_interval_s=0.05, install_signal_handlers=False,
                         drain_timeout_s=30.0, **sup_kw)
    rc = sup.run()
    return rc, _shape(_events(os.path.join(d, "supervisor.jsonl")))


def _port_set(d):
    """A world-4 set in the port's layout (one file a rank)."""
    from stochastic_gradient_push_torch.utils.checkpoint import (
        CheckpointManager)

    rng = np.random.default_rng(3)
    state = _train_state(
        5, torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.5, 1.5, 4).astype(np.float32)), 1)
    CheckpointManager(d, world_size=4, ranks=range(4)).save(
        state, {"epoch": 1, "itr": 0})


def _ref_set(d):
    """The same set in the reference's layout (one file holding every
    row)."""
    import flax.serialization

    rng = np.random.default_rng(3)
    state = {"step": np.full(4, 5), "params": {"w": rng.normal(
        size=(4, 8)).astype(np.float32)},
        "opt_state": {}, "batch_stats": {},
        "gossip": {"phase": np.ones(4, np.int64),
                   "ps_weight": rng.uniform(0.5, 1.5, 4).astype(np.float32),
                   "in_flight": None}}
    with open(os.path.join(d, "checkpoint_r0_n4.ckpt"), "wb") as f:
        f.write(flax.serialization.msgpack_serialize(
            {"state": state, "meta": {"epoch": 1, "itr": 0}}))


LIFECYCLES = {
    "requeue": ("requeue-once", FAKE_CHILD, {"max_restarts": 3}, 0),
    "crash-shrinks": ("crash-once", FAKE_CHILD,
                      {"max_restarts": 3, "shrink_factor": 2,
                       "backoff_base_s": 0.05}, 0),
    "budget-spent": ("crash-always", FAKE_CHILD,
                     {"max_restarts": 1, "backoff_base_s": 0.05}, 1),
    "drain-tail": (None, DRAIN_CHILD,
                   {"replan_count": 2, "replan_cooldown_steps": 0,
                    "max_restarts": 3}, 0),
    "crash-reshards": ("crash-once", FAKE_CHILD,
                       {"max_restarts": 2, "shrink_factor": 2,
                        "backoff_base_s": 0.05}, 0),
}


@pytest.mark.parametrize("case", sorted(LIFECYCLES))
def test_supervisor_stream_is_the_references(tmp_path, case):
    mode, script, policy_kw, rc = LIFECYCLES[case]
    sets = (_port_set, _ref_set) if case == "crash-reshards" else (None, None)
    got = _run_lifecycle(tsup, str(tmp_path / "port"), mode, script,
                         policy_kw, {}, sets[0])
    want = _run_lifecycle(rsup, str(tmp_path / "ref"), mode, script,
                          policy_kw, {}, sets[1])
    assert got[0] == want[0] == rc
    assert got[1] == want[1]
    assert any(k == "relaunch" for k, *_ in want[1]) or rc == 1
    if case == "crash-reshards":
        rel = [d for k, _, _, d in got[1] if k == "relaunch"][0]
        assert rel["resharded"] is True and rel["world"] == 2


def test_preemption_signal_drains_and_passes_75_through(tmp_path):
    """SIGTERM to the supervisor: SIGUSR1 to the child, then the
    supervisor's own exit 75 (the reference's preempt-exit)."""
    d = str(tmp_path)
    script = tmp_path / "child.py"
    ready = str(tmp_path / "ready")
    script.write_text(textwrap.dedent(f"""
        import signal, sys, time
        signal.signal(signal.SIGUSR1, lambda s, f: sys.exit(75))
        open({ready!r}, "w").close()
        time.sleep(60)
        sys.exit(0)
    """))
    spec = tsup.ChildSpec([sys.executable, str(script), "--trace_dir", d,
                           "--world_size", "2"])
    sup = tsup.Supervisor(spec, poll_interval_s=0.05, drain_timeout_s=20)

    def fire():
        deadline = time.time() + 30
        while not os.path.exists(ready) and time.time() < deadline:
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGTERM)

    import threading
    threading.Thread(target=fire, daemon=True).start()
    assert sup.run() == REQUEUE
    actions = [d["action"] for k, _, _, d in
               _shape(_events(str(tmp_path / "supervisor.jsonl")))
               if k == "supervisor"]
    assert actions == ["launch", "preempt-exit"]


# -- the chaos trigger ------------------------------------------------------------


def test_chaos_trigger_waits_for_one_whole_save(tmp_path):
    """The kill waits for every rank file of the world written since
    launch, all of one save; a set caught mid-save lets the (stopped)
    child go on."""
    from stochastic_gradient_push_torch.utils.checkpoint import (
        CheckpointManager)

    d = str(tmp_path)
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        spec = tsup.ChildSpec(["x", "--trace_dir", d, "--checkpoint_dir", d,
                               "--world_size", "3"])
        sup = tsup.Supervisor(spec, install_signal_handlers=False)
        since = time.time() - 1

        def save(step, ranks):
            state = _train_state(step, torch.zeros(len(ranks), 2),
                                 torch.ones(len(ranks)))
            CheckpointManager(d, world_size=3, ranks=ranks).save(
                state, {"epoch": step, "itr": 0})

        assert not sup._whole_set_landed(child, since)   # nothing yet
        save(1, [0, 1])
        assert not sup._whole_set_landed(child, since)   # rank 2 missing
        save(1, [2])
        save(2, [0])                                     # a save under way
        assert not sup._whole_set_landed(child, since)
        assert child.poll() is None                      # continued
        assert not sup._whole_set_landed(child, time.time() + 60)
        save(2, [1, 2])
        assert sup._whole_set_landed(child, since)
        with open(f"/proc/{child.pid}/stat") as f:
            assert f.read().split(") ")[1][0] == "T"     # left stopped
    finally:
        child.kill()
        child.wait()
