"""Port parity: the hierarchical topology (graph 6) and its round.

* ``default_slice_size`` and ``HierarchicalGraph``'s validation over
  worlds 4–64, slice sizes and fanouts: the same decompositions, the
  same refusals with the same messages.
* Every table field of the schedule, ``inter_schedule`` and
  ``slice_groups`` included, bit-equal (uniform and self-weighted
  mixing); ``build_pairing_schedule`` refused as the reference refuses.
* One round per wire (exact, bf16, int8, int8 with error feedback) at
  worlds 4 and 8, one and two peers, over a whole cycle: the delegate
  half bit-equal to the reference's compiled flat round over
  ``inter_schedule`` (ps-weight, params, residual); the whole round
  bit-equal to that half followed by the reference's intra-slice mean as
  its numpy definition (``a * float32(1/s)`` summed in rank order; the
  reference's compiled grouped psum does not run on this jax), and on
  the exact wire within 1e-6 of ``W_intra @ W_inter`` in float64.
* OSGP at staleness 1–2, thinned and not: ``Σw`` with the in-flight
  shares is the world (1e-6 relative: float32 sums), and the
  intra-slice mean runs once per consumed launch, as often as the sync
  round at staleness 1.
* The fences (faults; D-PSGD; AD-PSGD pairing) with the reference's
  messages.
* The grouped mean on the ``torch.distributed`` transport (gloo, four
  processes) equals the stacked lane's bit for bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw
from torch_gossip_drive import np_group_mean, ref_flat_round

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 16


def _rt():
    from stochastic_gradient_push_tpu import topology as rt

    return rt


@pytest.mark.parametrize("world", [4, 6, 8, 9, 12, 16, 24, 32, 48, 64])
def test_default_slice_size_equals_reference(world):
    rt = _rt()
    assert tt.default_slice_size(world) == rt.default_slice_size(world)


@pytest.mark.parametrize("world", [1, 2, 3, 5, 7])
def test_default_slice_size_refusals_equal(world):
    rt = _rt()
    with pytest.raises(ValueError) as want:
        rt.default_slice_size(world)
    with pytest.raises(ValueError) as got:
        tt.default_slice_size(world)
    assert str(got.value) == str(want.value)


GRAPH_CASES = [
    (4, 1, None, None), (8, 1, None, None), (8, 1, 2, None),
    (8, 2, 2, None), (8, 3, None, None), (12, 1, 4, None),
    (12, 2, 3, None), (16, 1, 4, 2), (16, 2, None, 4), (16, 1, 4, 5),
    (16, 1, None, 0), (24, 1, 6, None), (32, 2, 8, 2), (48, 1, 8, None),
    (64, 1, None, None), (64, 2, 16, None), (8, 1, 3, None),
    (8, 1, 8, None), (3, 1, None, None), (6, 1, 3, 1),
]


@pytest.mark.parametrize("world,ppi,slice_size,fanout", GRAPH_CASES)
def test_graph_validation_and_tables_equal_reference(world, ppi, slice_size,
                                                     fanout):
    rt = _rt()
    kw = dict(peers_per_itr=ppi, slice_size=slice_size, dcn_fanout=fanout)
    try:
        want = rt.HierarchicalGraph(world, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tt.HierarchicalGraph(world, **kw)
        assert str(got.value) == str(e)
        return
    got = tt.HierarchicalGraph(world, **kw)
    assert repr(got) == repr(want)
    assert got.phone_book == want.phone_book
    assert got.num_phases == want.num_phases
    for p in range(got.num_phases):
        for r in range(world):
            assert got.out_peers(r, p) == want.out_peers(r, p)
    for mixing in ("uniform", "self"):
        mix = {"uniform": (rt.UniformMixing(), tt.UniformMixing()),
               "self": (rt.SelfWeightedMixing(0.3),
                        tt.SelfWeightedMixing(0.3))}[mixing]
        js, ts = rt.build_schedule(want, mix[0]), tt.build_schedule(got,
                                                                   mix[1])
        assert isinstance(ts, tt.HierarchicalSchedule)
        for f in ("perms", "self_weight", "edge_weights"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
            np.testing.assert_array_equal(getattr(ts.inter_schedule, f),
                                          getattr(js.inter_schedule, f))
        for f in ("regular", "world_size", "peers_per_itr", "num_phases",
                  "slice_size", "num_slices", "inter_ppi", "dcn_fanout",
                  "rounds_per_cycle", "phase_kinds", "slice_groups"):
            assert getattr(ts, f) == getattr(js, f), f
        for f in ("regular", "world_size", "peers_per_itr", "num_phases"):
            assert getattr(ts.inter_schedule, f) == \
                getattr(js.inter_schedule, f), f


def test_pairing_is_refused_as_the_reference_refuses():
    rt = _rt()
    with pytest.raises(ValueError) as want:
        rt.build_pairing_schedule(rt.HierarchicalGraph(8))
    with pytest.raises(ValueError) as got:
        tt.build_pairing_schedule(tt.HierarchicalGraph(8))
    assert str(got.value) == str(want.value)
    assert "unsupported" in str(got.value)


def test_registries_name_the_hierarchical_graph():
    import functools

    assert tt.GRAPH_TOPOLOGIES[6] is tt.HierarchicalGraph
    assert tt.TOPOLOGY_NAMES["hierarchical"] is tt.HierarchicalGraph
    assert tt.topology_name(functools.partial(tt.HierarchicalGraph,
                                              slice_size=2)) == "hierarchical"
    assert sorted(tt.TOPOLOGY_NAMES) == sorted(_rt().TOPOLOGY_NAMES)
    assert sorted(tt.GRAPH_TOPOLOGIES) == sorted(_rt().GRAPH_TOPOLOGIES)


# -- the round ----------------------------------------------------------------


def _state(world, seed):
    r = np.random.default_rng(seed)
    params = {"w": r.standard_normal((world, 6, 50)).astype(np.float32),
              "b": r.standard_normal((world, 70)).astype(np.float32),
              "s": r.standard_normal((world, 1)).astype(np.float32)}
    ps = (0.5 + r.random(world)).astype(np.float32)
    res = {n: (r.standard_normal(a.shape) * 1e-3).astype(np.float32)
           for n, a in params.items()}
    return params, ps, res


def _codecs(wire):
    from stochastic_gradient_push_tpu.parallel import wire as rw

    name = {"exact": None, "int8_ef": "int8"}.get(wire, wire)
    if name is None:
        return None, None
    return rw.get_codec(name, BLOCK), tw.get_codec(name, BLOCK)


def _t(tree):
    return {n: torch.from_numpy(np.array(a)) for n, a in tree.items()}


ROUND_CASES = [(4, 2, 1), (8, 4, 1), (8, 2, 1), (8, 2, 2)]


@pytest.mark.parametrize("wire", ["exact", "bf16", "int8", "int8_ef"])
@pytest.mark.parametrize("world,slice_size,ppi", ROUND_CASES)
def test_round_equals_reference_delegate_half_then_intra_mean(
        world, slice_size, ppi, wire):
    import jax

    rt = _rt()
    jsched = rt.build_schedule(rt.HierarchicalGraph(
        world, peers_per_itr=ppi, slice_size=slice_size))
    tsched = tt.build_schedule(tt.HierarchicalGraph(
        world, peers_per_itr=ppi, slice_size=slice_size))
    jcodec, tcodec = _codecs(wire)
    ef = wire == "int8_ef"
    params, ps, res = _state(world, seed=world + ppi)
    transport = tc.StackedTransport(world)
    groups = tsched.slice_groups
    tp, tw_, tr = _t(params), torch.from_numpy(ps.copy()), _t(res)
    jp, jw, jr = params, ps, res
    for q in range(tsched.rounds_per_cycle + 1):
        fn = ref_flat_round(jsched.inter_schedule, world, q, jcodec, ef)
        out = jax.device_get(fn(jp, jw, jr) if ef else fn(jp, jw))
        # the delegate half alone: the port's flat round over the inter
        # tables against the reference's compiled one
        half = tc.mix_push_sum(tp, tw_, q, tsched.inter_schedule,
                               transport, codec=tcodec,
                               ef_residual=tr if ef else None)
        np.testing.assert_array_equal(half[1].numpy(), np.asarray(out[1]))
        for n in params:
            np.testing.assert_array_equal(half[0][n].numpy(),
                                          np.asarray(out[0][n]), err_msg=n)
            if ef:
                np.testing.assert_array_equal(half[2][n].numpy(),
                                              np.asarray(out[2][n]))
        # the whole round: that half, then the intra-slice mean
        whole = tc.mix_push_sum(tp, tw_, q, tsched, transport, codec=tcodec,
                                ef_residual=tr if ef else None)
        jp = {n: np_group_mean(a, groups) for n, a in out[0].items()}
        jw = np_group_mean(out[1], groups)
        np.testing.assert_array_equal(whole[1].numpy(), jw)
        for n in params:
            np.testing.assert_array_equal(whole[0][n].numpy(), jp[n],
                                          err_msg=f"{n} round {q}")
        if ef:
            # the residual is sender memory: never averaged
            jr = {n: np.asarray(a) for n, a in out[2].items()}
            idle = np.flatnonzero(
                tsched.inter_schedule.edge_weights[
                    q % tsched.rounds_per_cycle, 0] == 0.0)
            assert idle.size
            for n in params:
                np.testing.assert_array_equal(whole[2][n].numpy(), jr[n])
                # a rank that sends nothing (w_0 == 0) keeps its
                # residual pending, bit for bit
                np.testing.assert_array_equal(whole[2][n].numpy()[idle],
                                              tr[n].numpy()[idle])
            tr = whole[2]
        if wire == "exact":
            p = 2 * (q % tsched.rounds_per_cycle)
            mat = tsched.mixing_matrix(p + 1) @ tsched.mixing_matrix(p)
            for n in params:
                want = np.einsum("ij,j...->i...", mat,
                                 tp[n].numpy().astype(np.float64))
                np.testing.assert_allclose(whole[0][n].numpy(), want,
                                           rtol=0, atol=1e-6)
        tp, tw_ = whole[0], whole[1]
    # push-sum mass over a cycle (up to this float sum's order)
    np.testing.assert_allclose(float(tw_.double().sum()), ps.sum(),
                               rtol=1e-6)


@pytest.mark.parametrize("world,slice_size,ppi", ROUND_CASES)
def test_rounds_conserve_mass_and_reach_consensus(world, slice_size, ppi):
    sched = tt.build_schedule(tt.HierarchicalGraph(
        world, peers_per_itr=ppi, slice_size=slice_size))
    params, ps, _ = _state(world, seed=3)
    tp, tw_ = _t(params), torch.from_numpy(ps.copy())
    transport = tc.StackedTransport(world)
    want = {n: (a.astype(np.float64).sum(0) / ps.astype(np.float64).sum())
            for n, a in params.items()}
    for q in range(40):
        tp, tw_ = tc.mix_push_sum(tp, tw_, q, sched, transport)
    for n in params:
        got = tp[n].double().numpy() / tw_.double().numpy().reshape(
            (-1,) + (1,) * (params[n].ndim - 1))
        np.testing.assert_allclose(got, np.broadcast_to(want[n], got.shape),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("staleness", [1, 2])
@pytest.mark.parametrize("gossip_every", [1, 2])
def test_osgp_conserves_mass_and_fires_the_intra_mean_per_launch(
        monkeypatch, staleness, gossip_every):
    world, steps = 8, 7
    sched = tt.build_schedule(tt.HierarchicalGraph(world, slice_size=4))
    calls = []
    real = tc.intra_average
    monkeypatch.setattr(tc, "intra_average",
                        lambda *a: calls.append(1) or real(*a))
    params, _, _ = _state(world, seed=5)
    r = np.random.default_rng(6)

    def run(overlap):
        calls.clear()
        alg = talg.sgp(sched, tc.StackedTransport(world), overlap=overlap,
                       staleness=staleness if overlap else 1,
                       gossip_every=gossip_every)
        p = _t(params)
        g = alg.init(p)
        for t in range(steps):
            p, g = alg.pre_step(p, g)
            delta = {n: torch.from_numpy(r.standard_normal(a.shape).astype(
                np.float32) * 0.01) for n, a in params.items()}
            p = {n: a - delta[n] for n, a in p.items()}
            total = {n: float(a.double().sum()) for n, a in p.items()}
            p, g = alg.post_step(p, g)
            mass = float(g.ps_weight.double().sum()) + sum(
                float(w.double().sum()) for _, w in g.in_flight or ())
            # float32 roundings of the weights' sums: 1e-6 relative
            assert abs(mass - world) <= 1e-6 * world, (t, mass)
            after = {n: float(a.double().sum()) + sum(
                float(s[0][n].double().sum()) for s in g.in_flight or ())
                for n, a in p.items()}
            if not overlap:
                for n in total:
                    assert abs(after[n] - total[n]) <= 1e-4, n
        return len(calls)

    sync = run(False)
    fired = [t for t in range(steps) if t % gossip_every == 0]
    assert sync == len(fired)
    consumed = [t for t in fired if t + staleness - 1 < steps]
    assert run(True) == len(consumed)
    if staleness == 1:
        assert len(consumed) == sync


def test_faults_refused_as_the_reference_refuses():
    from stochastic_gradient_push_tpu.algorithms import sgp as rsgp
    from stochastic_gradient_push_tpu.parallel import GOSSIP_AXIS

    rt = _rt()
    jsched = rt.build_schedule(rt.HierarchicalGraph(8))
    tsched = tt.build_schedule(tt.HierarchicalGraph(8))
    with pytest.raises(ValueError) as want:
        rsgp(jsched, GOSSIP_AXIS, faults=object())
    with pytest.raises(ValueError) as got:
        talg.sgp(tsched, tc.StackedTransport(8), faults=object())
    assert str(got.value) == str(want.value)
    assert "hierarchical" in str(got.value)
    # the collective refuses it too, with the reference's message
    with pytest.raises(ValueError, match="fault injection is not supported "
                                         "on hierarchical schedules"):
        tc.gossip_round([torch.zeros(8, 3)], 0, tsched,
                        tc.StackedTransport(8), faults=object())
    # overlap composes (the delegate share defers)
    talg.osgp(tsched, tc.StackedTransport(8), staleness=2)


def test_dpsgd_refused_on_the_irregular_schedule():
    from stochastic_gradient_push_tpu.algorithms import dpsgd as rdpsgd
    from stochastic_gradient_push_tpu.parallel import GOSSIP_AXIS

    rt = _rt()
    with pytest.raises(ValueError) as want:
        rdpsgd(rt.build_schedule(rt.HierarchicalGraph(8)), GOSSIP_AXIS)
    with pytest.raises(ValueError) as got:
        talg.dpsgd(tt.build_schedule(tt.HierarchicalGraph(8)),
                   tc.StackedTransport(8))
    assert str(got.value) == str(want.value)


def test_group_mean_refuses_groups_that_are_not_contiguous_blocks():
    with pytest.raises(ValueError, match="contiguous"):
        tc.StackedTransport(4).group_mean([torch.zeros(4, 2)],
                                          ((0, 2), (1, 3)))


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch import topology as tt
rank, port, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
sched = tt.build_schedule(tt.HierarchicalGraph(4, slice_size=2))
r = np.random.default_rng(0)
params = {"w": r.standard_normal((4, 6, 5)).astype(np.float32),
          "b": r.standard_normal((4, 9)).astype(np.float32)}
ps = (0.5 + r.random(4)).astype(np.float32)
tp = {n: torch.from_numpy(a[rank:rank + 1].copy()) for n, a in params.items()}
tw = torch.from_numpy(ps[rank:rank + 1].copy())
transport = tc.DistTransport()
for q in range(3):
    tp, tw = tc.mix_push_sum(tp, tw, q, sched, transport)
np.savez(out, w=tp["w"].numpy(), b=tp["b"].numpy(), ps=tw.numpy())
dist.destroy_process_group()
"""


def test_dist_transport_group_mean_equals_the_stacked_lane(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), REPO, str(r), str(port),
         str(tmp_path / f"out{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(4)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    sched = tt.build_schedule(tt.HierarchicalGraph(4, slice_size=2))
    r = np.random.default_rng(0)
    params = {"w": r.standard_normal((4, 6, 5)).astype(np.float32),
              "b": r.standard_normal((4, 9)).astype(np.float32)}
    ps = (0.5 + r.random(4)).astype(np.float32)
    tp, tw_ = _t(params), torch.from_numpy(ps.copy())
    transport = tc.StackedTransport(4)
    for q in range(3):
        tp, tw_ = tc.mix_push_sum(tp, tw_, q, sched, transport)
    for rank in range(4):
        got = np.load(tmp_path / f"out{rank}.npz")
        np.testing.assert_array_equal(got["ps"], tw_.numpy()[rank:rank + 1])
        for n in params:
            np.testing.assert_array_equal(got[n], tp[n].numpy()[rank:rank + 1])
