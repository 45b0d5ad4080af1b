"""Port parity: the topology planner (``planner/``) and the schedule
verifier it uses (``analysis/``), against the reference's numpy modules.

* ``spectral_gap`` of every registered topology at worlds {2, 4, 8, 12,
  16}, one and two peers, uniform and self-weighted mixing: equal.
* ``verify_schedule`` on clean and broken tables: the same findings
  (rule ids and messages) and gap.
* ``evaluate_candidate``, ``score_candidates``, ``plan_for``,
  ``check_topology`` and ``resolve_topology`` (its ``gossip plan:``
  line included): ``to_dict()`` equal over the worlds above, the
  uniform fabric and ``make_interconnect(s, 16, None)``, fault, overlap
  and wire constraints, ``self_weighted`` True and forced alphas.
* ``plan_synthesized`` at worlds 4 and 8 with default knobs and at world
  12 with a small budget: the reference's plan and fingerprint, and the
  stamped spec reused (``from_seed_spec``).
* The gap cache's LRU bound and counters; ``WireCodec.wire_fraction``.
"""

import json
import logging

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import analysis as ta
from stochastic_gradient_push_torch import planner as tp
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.parallel import wire as tw

torch.set_num_threads(1)

WORLDS = (2, 4, 8, 12, 16)


def _rp():
    from stochastic_gradient_push_tpu import planner as rp

    return rp


def _rt():
    from stochastic_gradient_push_tpu import topology as rt

    return rt


def _dump(plan) -> str:
    return json.dumps(plan.to_dict(), sort_keys=True)


def _fabrics(world):
    """None (the uniform fabric) and every slice size the planner can
    tile ``world`` with, at a cross-slice cost of 16."""
    out = [None]
    out += [s for s in (2, 3, 4, 6, 8) if s <= world // 2 and world % s == 0]
    return out


def _models(world, slice_size):
    if slice_size is None:
        return None, None
    return (_rp().make_interconnect(slice_size, 16, None),
            tp.make_interconnect(slice_size, 16, None))


@pytest.mark.parametrize("world", WORLDS)
def test_spectral_gaps_equal_reference(world):
    from stochastic_gradient_push_tpu.analysis import spectral_gap

    rt = _rt()
    for name in sorted(tt.TOPOLOGY_NAMES):
        if name == "synth":
            continue
        for ppi in (1, 2):
            for mixing in ("uniform", "self"):
                mix = {"uniform": (rt.UniformMixing(), tt.UniformMixing()),
                       "self": (rt.SelfWeightedMixing(0.3),
                                tt.SelfWeightedMixing(0.3))}[mixing]
                try:
                    js = rt.build_schedule(
                        rt.TOPOLOGY_NAMES[name](world, peers_per_itr=ppi),
                        mix[0])
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        tt.build_schedule(tt.TOPOLOGY_NAMES[name](
                            world, peers_per_itr=ppi), mix[1])
                    assert str(got.value) == str(e)
                    continue
                ts = tt.build_schedule(
                    tt.TOPOLOGY_NAMES[name](world, peers_per_itr=ppi),
                    mix[1])
                assert ta.spectral_gap(ts) == spectral_gap(js), (name, ppi)
                assert ta.schedule_fingerprint(ts) == \
                    _ref_fingerprint(js)


def _ref_fingerprint(sched):
    from stochastic_gradient_push_tpu.analysis import schedule_fingerprint

    return schedule_fingerprint(sched)


def _broken_schedules(mod):
    good = mod.build_schedule(mod.NPeerDynamicDirectedExponentialGraph(8))
    perms = good.perms.copy()
    perms[0, 0, 1] = perms[0, 0, 0]
    not_perm = mod.GossipSchedule(perms, good.self_weight, good.edge_weights,
                                  False, 8, 1, good.num_phases)
    self_w = good.self_weight.copy()
    self_w[1, 2] = 0.9
    leaky = mod.GossipSchedule(good.perms, self_w, good.edge_weights,
                               False, 8, 1, good.num_phases)
    ident = np.tile(np.arange(8, dtype=np.int32), (1, 1, 1))
    stuck = mod.GossipSchedule(ident, np.ones((1, 8)), np.zeros((1, 1, 8)),
                               True, 8, 1, 1)
    hier = mod.build_schedule(mod.HierarchicalGraph(8, slice_size=2))
    return [good, not_perm, leaky, stuck, hier]


def test_verify_schedule_findings_equal_reference():
    from stochastic_gradient_push_tpu.analysis import verify_schedule

    for js, ts in zip(_broken_schedules(_rt()), _broken_schedules(tt)):
        jf, jgap = verify_schedule(js, "case", "<f>", 3)
        tf, tgap = ta.verify_schedule(ts, "case", "<f>", 3)
        assert [(f.file, f.line, f.rule, f.message) for f in tf] == \
            [(f.file, f.line, f.rule, f.message) for f in jf]
        assert (np.isnan(tgap) and np.isnan(jgap)) or tgap == jgap
    rules = [f.rule for ts in _broken_schedules(tt)
             for f in ta.verify_schedule(ts, "c", "<f>", 0)[0]]
    assert rules == ["SGPV101", "SGPV102", "SGPV103"]


def test_verify_pairing_equal_reference():
    from stochastic_gradient_push_tpu.analysis import verify_pairing

    bad = np.array([[1, 0, 3, 2], [0, 1, 2, 3], [1, 2, 3, 0]])
    got = ta.verify_pairing(bad, "p", "<f>", 1)
    want = verify_pairing(bad, "p", "<f>", 1)
    assert [(f.rule, f.message) for f in got] == \
        [(f.rule, f.message) for f in want]
    assert len(got) == 2


@pytest.mark.parametrize("world", WORLDS)
def test_candidates_and_rankings_equal_reference(world):
    rp = _rp()
    for s in _fabrics(world):
        jm, tm = _models(world, s)
        for wf in (1.0, 0.265625):
            want = rp.score_candidates(world, (1, 2), interconnect=jm,
                                       wire_fraction=wf)
            got = tp.score_candidates(world, (1, 2), interconnect=tm,
                                      wire_fraction=wf)
            assert [c.to_dict() for c in got] == [c.to_dict() for c in want]
        for name in ("ring", "hierarchical", "bipartite-linear"):
            for ppi in (1, 2):
                for mix in (None, 0.4):
                    rm = (None if mix is None
                          else _rt().SelfWeightedMixing(mix))
                    pm = None if mix is None else tt.SelfWeightedMixing(mix)
                    want = rp.evaluate_candidate(
                        _rt().TOPOLOGY_NAMES[name], world, ppi, rm,
                        interconnect=jm)
                    got = tp.evaluate_candidate(
                        tt.TOPOLOGY_NAMES[name], world, ppi, pm,
                        interconnect=tm)
                    assert (got is None) == (want is None)
                    if got is not None:
                        assert got.to_dict() == want.to_dict()


CONSTRAINTS = [
    dict(),
    dict(faults=True),
    dict(overlap=True),
    dict(wire={"dtype": "int8", "block": 64, "error_feedback": True}),
    dict(wire={"dtype": "bf16", "error_feedback": False}),
    dict(self_weighted=True),
    dict(self_weighted=0.9),
    dict(allowed=("ring",)),
    dict(allowed=("ring",), allow_global_avg=False),
]


@pytest.mark.parametrize("world", WORLDS)
def test_plan_for_equals_reference(world):
    rp = _rp()
    for s in _fabrics(world):
        jm, tm = _models(world, s)
        for ppi in (None, 1, 2):
            for algorithm in ("sgp", "dpsgd"):
                for kw in CONSTRAINTS:
                    if algorithm == "dpsgd" and kw.get("self_weighted"):
                        continue
                    args = dict(ppi=ppi, algorithm=algorithm)
                    try:
                        want = rp.plan_for(world, constraints=rp.PlanConstraints(
                            interconnect=jm, **kw), **args)
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            tp.plan_for(world, constraints=tp.PlanConstraints(
                                interconnect=tm, **kw), **args)
                        assert str(got.value) == str(e)
                        continue
                    got = tp.plan_for(world, constraints=tp.PlanConstraints(
                        interconnect=tm, **kw), **args)
                    assert _dump(got) == _dump(want), (s, ppi, kw)
                    assert got.summary() == want.summary()


@pytest.mark.parametrize("world", WORLDS)
def test_check_topology_equals_reference(world):
    rp, rt = _rp(), _rt()
    for s in _fabrics(world):
        jm, tm = _models(world, s)
        for name in sorted(tt.TOPOLOGY_NAMES):
            if name == "synth":
                continue
            for ppi in (1, 2):
                for kw in (dict(), dict(faults=True), dict(algorithm="dpsgd"),
                           dict(self_weighted=True), dict(floor=0.6),
                           dict(floor=0.6, global_avg_every=0),
                           dict(global_avg_every=5)):
                    try:
                        want = rp.check_topology(
                            world, rt.TOPOLOGY_NAMES[name], ppi,
                            interconnect=jm, **kw)
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            tp.check_topology(world, tt.TOPOLOGY_NAMES[name],
                                              ppi, interconnect=tm, **kw)
                        assert str(got.value) == str(e)
                        continue
                    got = tp.check_topology(world, tt.TOPOLOGY_NAMES[name],
                                            ppi, interconnect=tm, **kw)
                    assert _dump(got) == _dump(want), (name, ppi, kw)


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, fmt, *args):
        self.lines.append(("info", fmt % args))

    def warning(self, msg, *args):
        self.lines.append(("warning", msg % args if args else msg))


@pytest.mark.parametrize("world", (2, 4, 8))
def test_resolve_topology_logs_the_reference_plan_line(world):
    rp, rt = _rp(), _rt()
    for topology, graph in (("auto", None), (None, "ring"),
                            ("hierarchical", None), ("exponential", None)):
        for s in _fabrics(world):
            jm, tm = _models(world, s)
            logs = {"ref": _Log(), "port": _Log()}
            kw = dict(ppi=1, topology=topology, floor=0.3,
                      global_avg_every=None)
            try:
                want = rp.resolve_topology(
                    world, graph_class=rt.TOPOLOGY_NAMES.get(graph),
                    interconnect=jm, log=logs["ref"], **kw)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tp.resolve_topology(
                        world, graph_class=tt.TOPOLOGY_NAMES.get(graph),
                        interconnect=tm, log=logs["port"], **kw)
                assert str(got.value) == str(e)
                continue
            got = tp.resolve_topology(
                world, graph_class=tt.TOPOLOGY_NAMES.get(graph),
                interconnect=tm, log=logs["port"], **kw)
            assert _dump(got) == _dump(want)
            assert logs["port"].lines == logs["ref"].lines
            assert logs["port"].lines[0][1].startswith("gossip plan: ")


SYNTH_CASES = [(4, 2, {}), (8, 2, {}), (8, 4, {}),
               (12, 4, {"budget": 200, "max_phases": 4})]


@pytest.mark.parametrize("world,slice_size,knobs", SYNTH_CASES)
def test_plan_synthesized_equals_reference(world, slice_size, knobs):
    rp = _rp()
    jm, tm = _models(world, slice_size)
    want = rp.resolve_topology(world, topology="synth", interconnect=jm,
                               synth=dict(knobs))
    got = tp.resolve_topology(world, topology="synth", interconnect=tm,
                              synth=dict(knobs))
    assert _dump(got) == _dump(want)
    assert got.topology == "synth"
    if world == 4:
        assert got.synth["fingerprint"] == \
            "b7e2ef83ed403b218f4f2f2ed6c019f7d194cca1"
    # the stamped spec is reused at the same world
    stamped = dict(knobs, spec=got.synth["spec"])
    want2 = rp.plan_for(world, constraints=rp.PlanConstraints(
        interconnect=jm, synth=stamped))
    got2 = tp.plan_for(world, constraints=tp.PlanConstraints(
        interconnect=tm, synth=stamped))
    assert _dump(got2) == _dump(want2)
    assert got2.synth["from_seed_spec"] is True
    assert got2.synth["fingerprint"] == got.synth["fingerprint"]
    # the plan's graph class rebuilds the searched tables
    sched = tt.build_schedule(got2.graph_class(world))
    assert isinstance(sched, tt.SynthesizedSchedule)
    assert tt.spec_fingerprint(sched.spec) == got.synth["fingerprint"]


def test_plan_synthesized_falls_back_and_refuses_as_the_reference():
    rp = _rp()
    # no slice structure: nothing beats the registry at world 4
    want = rp.resolve_topology(4, topology="synth", synth={"budget": 50})
    got = tp.resolve_topology(4, topology="synth", synth={"budget": 50})
    assert _dump(got) == _dump(want)
    for kw in (dict(algorithm="dpsgd"), dict(overlap=True),
               dict(faults=True), dict(self_weighted=True)):
        with pytest.raises(ValueError) as w:
            rp.resolve_topology(4, topology="synth", **kw)
        with pytest.raises(ValueError) as g:
            tp.resolve_topology(4, topology="synth", **kw)
        assert str(g.value) == str(w.value)


def test_interconnect_model_round_trips_and_equals_reference():
    rp = _rp()
    for args in ((2, 16, None), (4, None, 2.0), (None, None, 3.0)):
        want = rp.make_interconnect(*args)
        got = tp.make_interconnect(*args)
        assert got.to_dict() == want.to_dict()
        assert tp.InterconnectModel.from_dict(got.to_dict()) == got
    assert tp.make_interconnect() is None
    with pytest.raises(ValueError) as w:
        rp.make_interconnect(None, 16, None)
    with pytest.raises(ValueError) as g:
        tp.make_interconnect(None, 16, None)
    assert str(g.value) == str(w.value)


def test_optimize_alpha_equals_reference():
    rp, rt = _rp(), _rt()
    for world, ppi in ((8, 2), (12, 1)):
        got = tp.optimize_alpha(tt.NPeerDynamicDirectedExponentialGraph(
            world, peers_per_itr=ppi))
        want = rp.optimize_alpha(rt.NPeerDynamicDirectedExponentialGraph(
            world, peers_per_itr=ppi))
        assert got == want


def test_gap_cache_is_a_bounded_lru():
    old = ta.spectral_gap_cache_limit()
    try:
        ta.spectral_gap_cache_clear()
        ta.spectral_gap_cache_limit(3)
        scheds = [tt.build_schedule(tt.RingGraph(w)) for w in (3, 4, 5, 6, 7)]
        for s in scheds:
            ta.spectral_gap(s)
        info = ta.spectral_gap_cache_info()
        assert (info["size"], info["max"], info["misses"],
                info["evictions"]) == (3, 3, 5, 2)
        ta.spectral_gap(scheds[-1])
        assert ta.spectral_gap_cache_info()["hits"] == 1
        ta.spectral_gap(scheds[0])        # evicted: a miss again
        assert ta.spectral_gap_cache_info()["misses"] == 6
        ta.spectral_gap_cache_limit(1)
        assert ta.spectral_gap_cache_info()["size"] == 1
        with pytest.raises(ValueError, match=">= 1"):
            ta.spectral_gap_cache_limit(0)
    finally:
        ta.spectral_gap_cache_limit(old)
        ta.spectral_gap_cache_clear()


def test_sparse_gap_lane_agrees_with_the_dense_one():
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(
        128, peers_per_itr=1))
    from stochastic_gradient_push_torch.analysis import verifier

    dense = np.eye(128)
    for p in range(sched.num_phases):
        dense = sched.mixing_matrix(p) @ dense
    lam = np.sort(np.abs(np.linalg.eigvals(dense)))[::-1]
    assert abs(verifier._sparse_gap(sched) - (1.0 - lam[1])) < 1e-8


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("block", [32, 64])
def test_wire_fraction_equals_reference(dtype, block):
    from stochastic_gradient_push_tpu.parallel import wire as rw

    assert tw.get_codec(dtype, block).wire_fraction() == \
        rw.get_codec(dtype, block).wire_fraction()


def test_recovery_replan_equals_reference():
    from stochastic_gradient_push_tpu.resilience import RecoveryPolicy
    from stochastic_gradient_push_torch.resilience import (
        RecoveryPolicy as TPolicy)

    rp = _rp()
    stamp = tp.resolve_topology(4, topology="synth",
                                interconnect=tp.make_interconnect(2, 16, None)
                                ).synth
    for kw in (dict(topology="ring"),
               dict(topology="npeer-exponential", faults=True),
               dict(topology="hierarchical", fabric=2,
                    wire={"dtype": "int8", "block": 64,
                          "error_feedback": True}),
               dict(topology="synth", fabric=2, synth=stamp),
               dict(topology=None, algorithm="dpsgd")):
        kw = dict(kw)
        s = kw.pop("fabric", None)
        want = RecoveryPolicy(
            world=4, interconnect=rp.make_interconnect(s, 16, None)
            if s else None, **kw).replan()
        got = TPolicy(world=4, interconnect=tp.make_interconnect(s, 16, None)
                      if s else None, **kw).replan()
        assert got == want
    logging.getLogger(__name__).debug("replan equal")
