"""sim/ on the port, held to the reference's ``sim/`` package.

* The engine: ``gossip_tick``, ``oracle_tick`` and ``run_gossip`` are
  bit-equal (``np.array_equal``) to the reference's on the schedules of
  ``tests/test_sim.py``'s exactness case, with and without a churn
  plan; the replay's naive-drop ``_leaky_tick`` too.
* The campaigns' specs, ``payload_bytes_for`` (f32, bf16, int8 codecs)
  and ``consensus_curve`` (priced fabric, faults) equal the reference's.
* The fleet lane: ``scripts/torch_sim.py --selftest`` exits 0 (its
  whole-slice kill at world 1024 = 8 hosts x 128, coordinator loss and
  the 4 -> 6 grow, against the port's Coordinator), and the kill-slice
  and grow scenarios' ``FleetReport`` has the reference's ``rc``, ``world``,
  ``prev_world``, ``cycles``, ``calls``, ``assigns``, ``gos`` and
  ``excluded`` for the same campaign.  Its boundary differs by design
  (``sim/fleet.py``): the reference's hosts restart from their own drain
  saves, the port's from the world's last committed save (its step in
  ``FleetReport.boundary_step``), so the two boundaries' steps and
  drifts differ; each drift is the float32 cast of one consensus
  collapse, at most 1e-6 in both.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import sim as tsim
from stochastic_gradient_push_torch.parallel import wire as twire
from stochastic_gradient_push_torch.planner import (
    interconnect as tinterconnect)
from stochastic_gradient_push_torch.resilience import (
    parse_fault_spec as tparse)
from stochastic_gradient_push_torch.sim import cli as tcli
from stochastic_gradient_push_torch.sim import replay as treplay
from stochastic_gradient_push_torch.topology import (
    TOPOLOGY_NAMES as TNAMES)
from stochastic_gradient_push_torch.topology import (
    build_schedule as tbuild)

torch.set_num_threads(1)

ENGINE_CASES = [("ring", 32, 1), ("exponential", 32, 2), ("linear", 16, 1),
                ("bipartite-exponential", 16, 1)]
CHURN = "drop_random:0.5@2:40;seed:7"


def _ref():
    from stochastic_gradient_push_tpu import sim as rsim
    from stochastic_gradient_push_tpu.resilience import parse_fault_spec
    from stochastic_gradient_push_tpu.topology import TOPOLOGY_NAMES
    from stochastic_gradient_push_tpu.topology.schedule import (
        build_schedule)

    return rsim, parse_fault_spec, TOPOLOGY_NAMES, build_schedule


def _schedules(topology, world, ppi):
    _, _, rnames, rbuild = _ref()
    return (tbuild(TNAMES[topology](world, peers_per_itr=ppi)),
            rbuild(rnames[topology](world, peers_per_itr=ppi)))


def _same_state(a, b):
    return (np.array_equal(a.params, b.params, equal_nan=True)
            and np.array_equal(a.ps_weight, b.ps_weight)
            and a.tick == b.tick)


@pytest.mark.parametrize("topology,world,ppi", ENGINE_CASES)
def test_gossip_and_oracle_ticks_are_the_references(topology, world, ppi):
    rsim = _ref()[0]
    mine, ref = _schedules(topology, world, ppi)
    st, rst = tsim.init_state(world, seed=2), rsim.init_state(world, seed=2)
    assert _same_state(st, rst)
    ot = tsim.SimState(params=st.params.copy(), ps_weight=st.ps_weight.copy())
    rot = rsim.SimState(params=rst.params.copy(),
                        ps_weight=rst.ps_weight.copy())
    for _ in range(2 * mine.num_phases + 1):
        st, rst = tsim.gossip_tick(st, mine), rsim.gossip_tick(rst, ref)
        ot, rot = tsim.oracle_tick(ot, mine), rsim.oracle_tick(rot, ref)
        assert _same_state(st, rst) and _same_state(ot, rot)
    # and the engine is its own oracle, as the reference's is
    assert _same_state(st, ot)


@pytest.mark.parametrize("churn", [False, True], ids=["clean", "churn"])
@pytest.mark.parametrize("topology,world,ppi", ENGINE_CASES)
def test_run_gossip_is_the_references(topology, world, ppi, churn):
    rsim, rparse, _, _ = _ref()
    mine, ref = _schedules(topology, world, ppi)
    st, errs = tsim.run_gossip(mine, 48, seed=5,
                               fault_plan=tparse(CHURN) if churn else None)
    rst, rerrs = rsim.run_gossip(ref, 48, seed=5,
                                 fault_plan=rparse(CHURN) if churn
                                 else None)
    assert _same_state(st, rst)
    assert errs == rerrs
    # mass-conserving drops keep the column sums to rounding
    assert abs(st.ps_weight.sum() - world) < 1e-9


def test_nan_corruption_and_the_leaky_tick_are_the_references():
    rsim, rparse, _, _ = _ref()
    from stochastic_gradient_push_tpu.sim import replay as rreplay

    mine, ref = _schedules("ring", 16, 1)
    st, rst = tsim.init_state(16, seed=1), rsim.init_state(16, seed=1)
    corrupt = np.zeros(16)
    corrupt[3] = 1.0
    a = tsim.gossip_tick(st, mine, corrupt_row=corrupt)
    b = rsim.gossip_tick(rst, ref, corrupt_row=corrupt)
    assert _same_state(a, b) and np.isnan(a.params).any()
    keep, _, _ = tparse("slice:8-15@0:8").host_tables(mine)
    rkeep, _, _ = rparse("slice:8-15@0:8").host_tables(ref)
    assert np.array_equal(keep, rkeep)
    for k in range(6):
        st = treplay._leaky_tick(st, mine, keep[k])
        rst = rreplay._leaky_tick(rst, ref, rkeep[k])
        assert _same_state(st, rst)
    assert abs(st.ps_weight.mean() - 1.0) > 1e-3   # the mass leaks


def test_campaigns_are_the_references():
    rsim = _ref()[0]
    pairs = [
        (tsim.kill_slice_campaign(1024, 128),
         rsim.kill_slice_campaign(1024, 128)),
        (tsim.kill_slice_campaign(64, 32, slice_idx=0, at=5, duration=9),
         rsim.kill_slice_campaign(64, 32, slice_idx=0, at=5, duration=9)),
        (tsim.cascading_slices_campaign(256, 32, count=3),
         rsim.cascading_slices_campaign(256, 32, count=3)),
        (tsim.sustained_churn_campaign(prob=0.25, at=3, duration=70, seed=2),
         rsim.sustained_churn_campaign(prob=0.25, at=3, duration=70,
                                       seed=2)),
        (tsim.coordinator_loss_campaign(down_s=1.5, kill_host=2),
         rsim.coordinator_loss_campaign(down_s=1.5, kill_host=2)),
    ]
    for mine, ref in pairs:
        assert (mine.name, mine.fault_spec, mine.kill_hosts,
                mine.coordinator_down_s, mine.describe()) == (
            ref.name, ref.fault_spec, ref.kill_hosts,
            ref.coordinator_down_s, ref.describe())
    for bad in ((lambda m: m.kill_slice_campaign(100, 32)),
                (lambda m: m.cascading_slices_campaign(64, 32, count=2)),
                (lambda m: m.sustained_churn_campaign(prob=1.0))):
        with pytest.raises(ValueError):
            bad(tsim)
        with pytest.raises(ValueError):
            bad(rsim)


@pytest.mark.parametrize("wire_dtype", [None, "f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [1, 16, 1000])
def test_payload_bytes_are_the_references(wire_dtype, d):
    from stochastic_gradient_push_tpu.parallel import wire as rwire

    rsim = _ref()[0]
    mine = tsim.payload_bytes_for(d, codec=twire.get_codec(wire_dtype))
    assert mine == rsim.payload_bytes_for(
        d, codec=rwire.get_codec(wire_dtype))


@pytest.mark.parametrize("topology,faults", [
    ("ring", None), ("exponential", None),
    ("ring", "slice:32-63@4:20"), ("linear", "drop_random:0.3@0:50;seed:1")])
def test_consensus_curve_is_the_references(topology, faults):
    from stochastic_gradient_push_tpu.planner.interconnect import (
        InterconnectModel)

    rsim, rparse, _, _ = _ref()
    mine, ref = _schedules(topology, 64, 1)
    a = tsim.consensus_curve(
        mine, 40, seed=1, fault_plan=tparse(faults) if faults else None,
        interconnect=tinterconnect.InterconnectModel(slice_size=32,
                                                     dcn_cost=16.0))
    b = rsim.consensus_curve(
        ref, 40, seed=1, fault_plan=rparse(faults) if faults else None,
        interconnect=InterconnectModel(slice_size=32, dcn_cost=16.0))
    assert a == b
    assert tsim.time_to_error(a, 1e-2) == rsim.time_to_error(b, 1e-2)


# -- the fleet lane: the selftest, and its reports against the reference ----

STRUCTURAL = ("rc", "prev_world", "world", "cycles", "calls", "assigns",
              "gos", "excluded")


@pytest.fixture(scope="module")
def selftest_reports():
    """``scripts/torch_sim.py --selftest`` in-process, its fleet
    scenarios' arguments and reports recorded."""
    runs = []
    real = tcli.run_sim_fleet

    def spy(fleet_dir, hosts, **kw):
        rep = real(fleet_dir, hosts, **kw)
        runs.append((dict(hosts), kw, rep))
        return rep

    tcli.run_sim_fleet = spy
    try:
        rc = tcli.main(["--selftest"])
    finally:
        tcli.run_sim_fleet = real
    return rc, runs


def test_sim_selftest_exits_0(selftest_reports):
    rc, runs = selftest_reports
    assert rc == 0
    assert [r[2].world for r in runs] == [896, 4, 6]


def _ref_campaign(camp):
    from stochastic_gradient_push_tpu.sim.campaign import Campaign

    if camp is None:
        return None
    return Campaign(name=camp.name, fault_spec=camp.fault_spec,
                    kill_hosts=camp.kill_hosts,
                    coordinator_down_s=camp.coordinator_down_s)


@pytest.mark.parametrize("scenario", [0, 2],
                         ids=["kill-slice-1024", "grow-4-to-6"])
def test_fleet_reports_are_the_references(selftest_reports, scenario,
                                          tmp_path):
    rsim = _ref()[0]
    _, runs = selftest_reports
    hosts, kw, mine = runs[scenario]
    kw = dict(kw, campaign=_ref_campaign(kw.get("campaign")))
    ref = rsim.run_sim_fleet(str(tmp_path), hosts, **kw)
    assert {f: getattr(mine, f) for f in STRUCTURAL} == {
        f: getattr(ref, f) for f in STRUCTURAL}
    assert mine.ps_weight_reset is True and ref.ps_weight_reset is True
    assert 0.0 <= mine.drift <= 1e-6 and 0.0 <= ref.drift <= 1e-6
    # the port's boundary is the world's last committed save, never
    # past the steps a host can run
    assert 0 <= mine.boundary_step <= kw["steps"]
    assert mine.host_exit == ref.host_exit


def test_a_save_left_mid_stage_marks_nothing_staged(tmp_path):
    """A simulated host leaves a save mid-stage when a rendezvous call
    arrives: a host of several writes no further staged file and marks
    the step neither staged nor committed, so no peer commits it; a host
    alone completes its save (the drain's save)."""
    import json
    import os

    from stochastic_gradient_push_torch.supervise.hostsim import HostFiles

    state = {"params": {"w": np.zeros((4, 16), np.float32)},
             "gossip": {"ps_weight": np.ones(4, np.float32),
                        "phase": np.zeros(4, np.int32)}}
    calls = []

    def stop_after_two():
        calls.append(1)
        return len(calls) > 2

    d = str(tmp_path / "several")
    os.makedirs(d)
    files = HostFiles(d, "", 8, 2, 0, 0, 4, fsync=False, poll_s=0.001)
    files.mark(staged=-1, committed=-1)
    peer = HostFiles(d, "", 8, 2, 1, 4, 4, fsync=False)
    peer.mark(staged=-1, committed=-1)
    assert files.save(state, {"step": 5}, -1, stop_after_two) is False
    staged = sorted(f for f in os.listdir(d) if ".tmp." in f)
    assert staged == ["checkpoint_r0_n8.ckpt.tmp.r0",
                      "checkpoint_r1_n8.ckpt.tmp.r1"]
    with open(os.path.join(d, "hostsim_p0_n8.sync")) as f:
        assert json.load(f)["staged"] == -1
    assert not [f for f in os.listdir(d) if f.endswith(".ckpt")]

    d = str(tmp_path / "alone")
    os.makedirs(d)
    alone = HostFiles(d, "", 4, 1, 0, 0, 4, fsync=False)
    alone.mark(staged=-1, committed=-1)
    assert alone.save(state, {"step": 5}, -1, lambda: True) is True
    assert alone.load()[1]["step"] == 5
