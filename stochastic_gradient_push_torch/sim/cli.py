"""CLI and gate of the priced-fabric fleet simulator.

Port of ``stochastic_gradient_push_tpu/sim/cli.py``; ``run_selftest``
is ``scripts/torch_sim.py --selftest``: engine bit-exactness
against the dense permutation-matrix oracle at world 256, the
ring-vs-exponential wall-clock ordering the planner's score claims,
mass conservation under sustained 50% churn, fabric pricing sanity, and
the three fleet scenarios (whole-slice kill at world 1024, coordinator
loss, grow-the-world 4 → 6) against the real coordinator — all numpy +
threads, on the host.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from ..planner.interconnect import InterconnectModel
from ..resilience import parse_fault_spec
from ..topology import TOPOLOGY_NAMES
from ..topology.schedule import build_schedule
from .campaign import (cascading_slices_campaign,
                       coordinator_loss_campaign, kill_slice_campaign,
                       sustained_churn_campaign)
from .curves import consensus_curve, time_to_error
from .engine import SimState, gossip_tick, init_state, oracle_tick, \
    run_gossip
from .fabric import FabricModel, payload_bytes_for
from .fleet import run_sim_fleet

__all__ = ["run_selftest", "main"]


def _schedule(topology: str, world: int, ppi: int = 1):
    cls = TOPOLOGY_NAMES[topology]
    return build_schedule(cls(world, peers_per_itr=ppi))


def run_selftest(verbose: bool = True) -> int:
    failures: list[str] = []
    t_start = time.time()

    def check(ok, msg: str) -> bool:
        if verbose:
            print(("  ok  " if ok else "  FAIL") + f" {msg}")
        if not ok:
            failures.append(msg)
        return bool(ok)

    def section(name: str) -> None:
        if verbose:
            print(f"[{time.time() - t_start:5.1f}s] {name}")

    # -- 1. engine is bit-identical to the dense matrix oracle ----------
    section("engine exactness vs dense permutation-matrix oracle")
    for topo, world, ppi in (("ring", 256, 1),
                             ("exponential", 64, 2)):
        sched = _schedule(topo, world, ppi)
        st = init_state(world, seed=3)
        oracle = SimState(params=st.params.copy(),
                          ps_weight=st.ps_weight.copy())
        ticks = 2 * sched.num_phases + 3
        for _ in range(ticks):
            st = gossip_tick(st, sched)
            oracle = oracle_tick(oracle, sched)
        check(np.array_equal(st.params, oracle.params)
              and np.array_equal(st.ps_weight, oracle.ps_weight),
              f"{topo}-{world} ppi={ppi}: {ticks} engine ticks == "
              "matrix-power oracle bit-exactly")
        check(np.all(np.isfinite(st.params)),
              f"{topo}-{world}: state finite")

    # -- 2. priced ordering: exponential beats ring at world 256 --------
    section("ring-vs-exponential consensus ordering on priced fabric")
    fabric_model = InterconnectModel(slice_size=32, dcn_cost=16.0)
    ring = _schedule("ring", 256)
    expo = _schedule("exponential", 256)
    c_ring = consensus_curve(ring, 96, interconnect=fabric_model, seed=1)
    c_expo = consensus_curve(expo, 96, interconnect=fabric_model, seed=1)
    tte_ring = time_to_error(c_ring, 1e-3)
    tte_expo = time_to_error(c_expo, 1e-3)
    check(tte_expo is not None,
          f"exponential-256 reaches 1e-3 ({tte_expo})")
    check(tte_ring is None or (tte_expo is not None
                               and tte_expo < tte_ring),
          "exponential-256 reaches 1e-3 before ring-256 "
          f"(exp {tte_expo}, ring {tte_ring})")
    check(c_expo["error"][-1] < c_ring["error"][-1],
          f"exponential error {c_expo['error'][-1]:.2e} < "
          f"ring {c_ring['error'][-1]:.2e} after 96 rounds")

    # -- 3. campaigns: mass conservation under sustained churn ----------
    section("sustained 50% churn conserves the consensus target")
    churn = sustained_churn_campaign(prob=0.5, at=4, duration=64, seed=7)
    plan = parse_fault_spec(churn.fault_spec)
    st0 = init_state(256, seed=5)
    col0 = st0.params.sum(axis=0)
    st_churn, errs = run_gossip(ring, 72, seed=5, fault_plan=plan)
    check(np.all(np.isfinite(st_churn.params)),
          "state finite through the churn window")
    check(np.allclose(st_churn.params.sum(axis=0), col0,
                      rtol=1e-11, atol=1e-11),
          "mass-conserving drops: column sums conserved to fp roundoff")
    check(abs(st_churn.ps_weight.sum() - 256.0) < 1e-9,
          "push-sum weight mass == world")
    check(errs[-1] < errs[0],
          f"consensus still contracts under 50% churn "
          f"({errs[0]:.2e} -> {errs[-1]:.2e})")

    # -- 4. fabric pricing: dropped edges ship nothing ------------------
    section("fabric: mass-conserving drops cost no wire time")
    # two slices, so blacking one out removes EVERY cross-slice edge
    # and the slowest surviving rank pays only the ICI hop
    ring64 = _schedule("ring", 64)
    kill = kill_slice_campaign(64, 32, at=0, duration=32)
    kplan = parse_fault_spec(kill.fault_spec)
    keep, _, _ = kplan.host_tables(ring64)
    fm = FabricModel(ring64, fabric_model, payload_bytes_for(16))
    free = fm.tick_time(0)
    masked = fm.tick_time(0, keep_row=keep[0])
    check(masked < free,
          f"blacked-out slice edges priced at 0 ({masked:.2e} < "
          f"{free:.2e} s)")
    cascade = cascading_slices_campaign(256, 32, count=3)
    check(cascade.fault_spec.count("slice:") == 3
          and len(cascade.kill_hosts) == 3,
          "cascading campaign compiles 3 staggered slice clauses")

    # -- 5. fleet: whole-slice kill at world 1024 -----------------------
    section("fleet: whole-slice kill at world 1024 (8 hosts x 128)")
    with tempfile.TemporaryDirectory() as d:
        rep = run_sim_fleet(d, {h: 128 for h in range(8)}, steps=40,
                            save_every=5, step_s=0.05,
                            campaign=kill_slice_campaign(1024, 128))
        check(rep.rc == 0, f"coordinator rc 0 (got {rep.rc})")
        check(rep.cycles == 1,
              f"exactly ONE coordinated cycle (got {rep.cycles})")
        check(rep.world == 896 and rep.excluded == [7],
              f"world 1024 -> 896, host 7 excluded (got {rep.world}, "
              f"{rep.excluded})")
        check(rep.drift is not None and rep.drift <= 1e-6,
              f"reshard boundary consensus drift {rep.drift} <= 1e-6")
        check(rep.ps_weight_reset is True, "ps_weight reset to 1")

    # -- 6. fleet: coordinator loss, tailers replay ---------------------
    section("fleet: coordinator dark 1s while a host dies")
    with tempfile.TemporaryDirectory() as d:
        rep = run_sim_fleet(d, {0: 2, 1: 2, 2: 2}, steps=45,
                            save_every=5, step_s=0.12,
                            campaign=coordinator_loss_campaign(
                                down_s=1.0))
        check(rep.rc == 0 and rep.cycles == 1,
              "recovery = exactly one cycle, rc 0 "
              f"(got rc {rep.rc}, {rep.cycles} cycles)")
        check(rep.world == 4 and rep.excluded == [2],
              f"world 6 -> 4, host 2 excluded (got {rep.world}, "
              f"{rep.excluded})")

    # -- 7. fleet: grow-the-world induction 4 -> 6 ----------------------
    section("fleet: join hello grows world 4 -> 6")
    with tempfile.TemporaryDirectory() as d:
        rep = run_sim_fleet(d, {0: 2, 1: 2}, steps=40, save_every=5,
                            step_s=0.08, join_rows=2, gossip=True)
        check(rep.rc == 0 and rep.cycles == 1,
              f"one grow cycle, rc 0 (got rc {rep.rc}, "
              f"{rep.cycles} cycles)")
        check(rep.world == 6 and rep.excluded == [],
              f"world 4 -> 6, nobody excluded (got {rep.world})")
        check(rep.drift is not None and rep.drift <= 1e-6,
              f"grow boundary consensus drift {rep.drift} <= 1e-6")
        check(rep.ps_weight_reset is True, "grown ps_weight reset to 1")
        check(rep.host_exit.get(2) == "complete",
              f"joiner trained to completion "
              f"(got {rep.host_exit.get(2)})")

    elapsed = time.time() - t_start
    if failures:
        print(f"sim selftest: {len(failures)} FAILURE(S) in "
              f"{elapsed:.1f}s")
        for msg in failures:
            print(f"  - {msg}")
        return 1
    print(f"sim selftest: all checks passed in {elapsed:.1f}s")
    return 0


_CAMPAIGNS = {
    "kill-slice": lambda world, ss: kill_slice_campaign(world, ss),
    "cascade": lambda world, ss: cascading_slices_campaign(world, ss),
    "churn": lambda world, ss: sustained_churn_campaign(),
    "coordinator-loss": lambda world, ss: coordinator_loss_campaign(),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torch_sim.py",
        description="priced-fabric gossip/fleet simulator")
    p.add_argument("--selftest", action="store_true",
                   help="run the gate and exit")
    p.add_argument("--topology", default="ring",
                   choices=sorted(n for n in TOPOLOGY_NAMES
                                  if n != "synth"))
    p.add_argument("--world", type=int, default=256)
    p.add_argument("--ppi", type=int, default=1)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--slice-size", type=int, default=None,
                   help="fabric slice size (default: uniform fabric)")
    p.add_argument("--dcn-cost", type=float, default=16.0)
    p.add_argument("--fault", default=None,
                   help="raw resilience fault spec for the run")
    p.add_argument("--campaign", default=None,
                   choices=sorted(_CAMPAIGNS),
                   help="named campaign compiled to the fault grammar")
    p.add_argument("--out", default=None,
                   help="write the curve as JSON here")
    args = p.parse_args(argv)

    if args.selftest:
        return run_selftest()

    schedule = _schedule(args.topology, args.world, args.ppi)
    model = (InterconnectModel(slice_size=args.slice_size,
                               dcn_cost=args.dcn_cost)
             if args.slice_size else None)
    spec = args.fault
    if args.campaign:
        camp = _CAMPAIGNS[args.campaign](
            args.world, args.slice_size or max(args.world // 8, 1))
        print(camp.describe())
        spec = camp.fault_spec
    plan = parse_fault_spec(spec) if spec else None
    curve = consensus_curve(schedule, args.steps, interconnect=model,
                            seed=args.seed, fault_plan=plan)
    tte = time_to_error(curve, args.eps)
    print(f"{args.topology}-{args.world} ppi={args.ppi}: "
          f"{args.steps} rounds = {curve['time_s'][-1]:.3e} simulated s,"
          f" final error {curve['error'][-1]:.3e}, "
          f"time-to-{args.eps:g} "
          f"{'unreached' if tte is None else f'{tte:.3e}s'}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"topology": args.topology, "world": args.world,
                       "ppi": args.ppi, "fault": spec, **curve}, f,
                      indent=2, sort_keys=True)
        print(f"wrote {args.out}")
    return 0
