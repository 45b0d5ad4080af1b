"""Port parity: synthesized schedules (``topology/synthesized.py``) and
their rounds.

* ``validate_spec`` and its normalization, ``spec_fingerprint`` and the
  JSON round trip equal to the reference's, malformed specs refused with
  the reference's messages (and as unsupported configurations).
* The tables (``perms``, weights, ``phase_kinds``, ``phase_groups``,
  ``spec``, each ``edge_phase_schedule``) equal, for hand-made specs and
  the planner's world-4 and world-8 winners.
* Each round of a cycle, exact and int8 with error feedback: an edge
  phase bit-equal to the reference's compiled flat round over
  ``edge_phase_schedule(p)`` (ps-weight, params, residual), a psum phase
  bit-equal to the reference's grouped psum as its numpy definition
  (``a * float32(1/g)`` summed in rank order; the compiled one does not
  run on this jax), with the residual passing through it untouched.
* The world-4 winner's cycle: the rounds alone reach the rank mean
  after two cycles (its product is nilpotent off the mean), 1e-6.
* The overlap and fault fences, in the algorithm and in the round, with
  the reference's messages.
"""

import json

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.analysis import is_unsupported_config
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw
from torch_gossip_drive import np_group_mean, ref_flat_round

torch.set_num_threads(1)

BLOCK = 16
# the planner's world-4 winner on slices of 2 at a cross-slice cost of 16
WORLD4 = {"v": 1, "world": 4, "phases": [
    {"kind": "psum", "group_size": 2},
    {"kind": "edge", "perm": [2, 1, 0, 3], "send": [0.9, 0.0, 0.9, 0.0]},
    {"kind": "edge", "perm": [3, 2, 1, 0], "send": [0.5, 0.5, 0.5, 0.5]}]}
WORLD4_FINGERPRINT = "b7e2ef83ed403b218f4f2f2ed6c019f7d194cca1"


def _rt():
    from stochastic_gradient_push_tpu import topology as rt

    return rt


def _spec8():
    return {"v": 1, "world": 8, "phases": [
        {"kind": "edge", "perm": [(r + 1) % 8 for r in range(8)],
         "send": [0.75] * 8},
        {"kind": "psum", "group_size": 4},
        {"kind": "edge", "perm": [4, 1, 2, 3, 0, 5, 6, 7],
         "send": [0.9, 0.3, 0.3, 0.3, 0.9, 0.3, 0.3, 0.3]}]}


def _winner(world, slice_size):
    from stochastic_gradient_push_tpu.planner import (
        InterconnectModel, SynthesisConfig, synthesize)

    return synthesize(world, interconnect=InterconnectModel(
        slice_size=slice_size, dcn_cost=16.0),
        config=SynthesisConfig()).spec


SPECS = {"world4": lambda: WORLD4, "hand8": _spec8,
         "winner8": lambda: _winner(8, 4)}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_normalization_fingerprint_and_json_equal(name):
    rt = _rt()
    spec = SPECS[name]()
    want = rt.validate_spec(spec)
    got = tt.validate_spec(spec)
    assert got == want
    assert tt.validate_spec(json.loads(json.dumps(got))) == got
    assert tt.spec_fingerprint(got) == rt.spec_fingerprint(want)
    if name == "world4":
        assert tt.spec_fingerprint(got) == WORLD4_FINGERPRINT


def test_self_edges_normalize_to_zero_send_as_the_reference():
    spec = {"v": 1, "world": 8, "phases": [
        {"kind": "edge", "perm": [4, 1, 2, 3, 0, 5, 6, 7],
         "send": [0.9] * 8}]}
    assert tt.validate_spec(spec) == _rt().validate_spec(spec)
    assert tt.validate_spec(spec)["phases"][0]["send"][1] == 0.0


MALFORMED = [
    lambda s: s.update(v=99),
    lambda s: s.update(world=1),
    lambda s: s.update(phases=[]),
    lambda s: s["phases"].append({"kind": "edge", "perm": [0] * 8,
                                  "send": [0.5] * 8}),
    lambda s: s["phases"].append({"kind": "edge", "perm": list(range(8)),
                                  "send": [1.5] * 8}),
    lambda s: s["phases"].append({"kind": "edge", "perm": list(range(8)),
                                  "send": [0.0] * 8}),
    lambda s: s["phases"].append({"kind": "psum", "group_size": 3}),
    lambda s: s["phases"].append({"kind": "butterfly"}),
]


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_malformed_specs_refused_with_the_reference_message(case):
    spec = _spec8()
    MALFORMED[case](spec)
    with pytest.raises(ValueError) as want:
        _rt().validate_spec(spec)
    with pytest.raises(ValueError) as got:
        tt.validate_spec(spec)
    assert str(got.value) == str(want.value)
    assert is_unsupported_config(got.value)


def test_graph_refusals_equal():
    rt = _rt()
    for make in (lambda m: m.SynthesizedGraph(8),
                 lambda m: m.SynthesizedGraph(12, spec=_spec8()),
                 lambda m: m.build_schedule(m.SynthesizedGraph(
                     8, spec=_spec8()), m.SelfWeightedMixing(0.5)),
                 lambda m: m.build_pairing_schedule(m.SynthesizedGraph(
                     8, spec=_spec8()))):
        with pytest.raises(ValueError) as want:
            make(rt)
        with pytest.raises(ValueError) as got:
            make(tt)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_tables_equal_reference(name):
    rt = _rt()
    spec = SPECS[name]()
    world = spec["world"]
    jg, tg = rt.SynthesizedGraph(world, spec=spec), tt.SynthesizedGraph(
        world, spec=spec)
    js, ts = rt.build_schedule(jg), tt.build_schedule(tg)
    assert isinstance(ts, tt.SynthesizedSchedule)
    assert repr(tg) == repr(jg) and tg.phone_book == jg.phone_book
    for f in ("perms", "self_weight", "edge_weights"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    for f in ("regular", "world_size", "peers_per_itr", "num_phases",
              "phase_kinds", "phase_groups", "rounds_per_cycle", "spec"):
        assert getattr(ts, f) == getattr(js, f), f
    for p, kind in enumerate(ts.phase_kinds):
        for r in range(world):
            assert tg.out_peers(r, p) == jg.out_peers(r, p)
        if kind != "edge":
            with pytest.raises(ValueError, match="not an edge phase"):
                ts.edge_phase_schedule(p)
            continue
        je, te = js.edge_phase_schedule(p), ts.edge_phase_schedule(p)
        for f in ("perms", "self_weight", "edge_weights"):
            np.testing.assert_array_equal(getattr(te, f), getattr(je, f))
        assert (te.num_phases, te.peers_per_itr) == (1, 1)


def _state(world, seed):
    r = np.random.default_rng(seed)
    params = {"w": r.standard_normal((world, 5, 40)).astype(np.float32),
              "b": r.standard_normal((world, 50)).astype(np.float32)}
    ps = (0.5 + r.random(world)).astype(np.float32)
    res = {n: (r.standard_normal(a.shape) * 1e-3).astype(np.float32)
           for n, a in params.items()}
    return params, ps, res


@pytest.mark.parametrize("wire", ["exact", "int8_ef"])
@pytest.mark.parametrize("name", ["world4", "hand8"])
def test_rounds_equal_reference(name, wire):
    import jax

    from stochastic_gradient_push_tpu.parallel import wire as rw

    rt = _rt()
    spec = SPECS[name]()
    world = spec["world"]
    js = rt.build_schedule(rt.SynthesizedGraph(world, spec=spec))
    ts = tt.build_schedule(tt.SynthesizedGraph(world, spec=spec))
    ef = wire == "int8_ef"
    jcodec = rw.get_codec("int8", BLOCK) if ef else None
    tcodec = tw.get_codec("int8", BLOCK) if ef else None
    params, ps, res = _state(world, seed=len(name))
    transport = tc.StackedTransport(world)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    tw_, tr = torch.from_numpy(ps.copy()), {
        n: torch.from_numpy(a.copy()) for n, a in res.items()}
    jp, jw, jr = params, ps, res
    for p in range(ts.num_phases + 1):
        got = tc.mix_push_sum(tp, tw_, p, ts, transport, codec=tcodec,
                              ef_residual=tr if ef else None)
        k = p % ts.num_phases
        if ts.phase_kinds[k] == "psum":
            groups = ts.phase_groups[k]
            jp = {n: np_group_mean(a, groups) for n, a in jp.items()}
            jw = np_group_mean(jw, groups)
            if ef:
                # an exact collective: the residual passes through
                assert all(got[2][n] is tr[n] for n in tr)
        else:
            fn = ref_flat_round(js.edge_phase_schedule(k), world, 0, jcodec,
                                ef)
            out = jax.device_get(fn(jp, jw, jr) if ef else fn(jp, jw))
            jp = {n: np.asarray(a) for n, a in out[0].items()}
            jw = np.asarray(out[1])
            if ef:
                jr = {n: np.asarray(a) for n, a in out[2].items()}
        np.testing.assert_array_equal(got[1].numpy(), jw)
        for n in params:
            np.testing.assert_array_equal(got[0][n].numpy(), jp[n],
                                          err_msg=f"{n} phase {p}")
            if ef:
                np.testing.assert_array_equal(got[2][n].numpy(), jr[n])
        tp, tw_ = got[0], got[1]
        if ef:
            tr = got[2]


def test_world4_cycle_reaches_the_mean_in_two_cycles():
    sched = tt.build_schedule(tt.SynthesizedGraph(4, spec=WORLD4))
    prod = np.eye(4)
    for p in range(3):
        prod = sched.mixing_matrix(p) @ prod
    # one cycle is not the mean, two are (nilpotent off the mean)
    assert np.abs(prod - 0.25).max() > 0.1
    np.testing.assert_allclose(prod @ prod, np.full((4, 4), 0.25),
                               atol=1e-12)
    params, ps, _ = _state(4, seed=7)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    tw_ = torch.from_numpy(ps.copy())
    transport = tc.StackedTransport(4)
    for r in range(6):
        tp, tw_ = tc.mix_push_sum(tp, tw_, r, sched, transport)
    for n, a in params.items():
        want = a.astype(np.float64).sum(0) / ps.astype(np.float64).sum()
        got = tp[n].double().numpy() / tw_.double().numpy().reshape(
            (-1,) + (1,) * (a.ndim - 1))
        np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                                   rtol=0, atol=1e-6)


def test_overlap_and_faults_refused_as_the_reference_refuses():
    from stochastic_gradient_push_tpu.algorithms import sgp as rsgp
    from stochastic_gradient_push_tpu.parallel import GOSSIP_AXIS

    rt = _rt()
    js = rt.build_schedule(rt.SynthesizedGraph(4, spec=WORLD4))
    ts = tt.build_schedule(tt.SynthesizedGraph(4, spec=WORLD4))
    transport = tc.StackedTransport(4)
    for kw in (dict(faults=object()), dict(overlap=True)):
        with pytest.raises(ValueError) as want:
            rsgp(js, GOSSIP_AXIS, **kw)
        with pytest.raises(ValueError) as got:
            talg.sgp(ts, transport, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="fault injection is not supported "
                                         "on synthesized schedules"):
        tc.gossip_round([torch.zeros(4, 3)], 1, ts, transport,
                        faults=object())
    with pytest.raises(ValueError, match="overlap is not supported on "
                                         "synthesized schedules"):
        tc.overlap_launch([torch.zeros(4, 3)], 1, ts, transport)
