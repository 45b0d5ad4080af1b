"""``scripts/torch_chaos.py`` driver — the chaos drill and ``--describe``.

Port of ``stochastic_gradient_push_tpu/resilience/chaos.py``.  Modes:

* ``--selftest`` — the resilience acceptance loop at world 8, stacked
  on one device: inject a single-edge drop on the ring, hold the
  network-wide parameter mean to float32 tolerance (mass-conserving drop
  semantics), see the monitor report the residual excursion in a
  structured ``gossip health:`` line, and see recovery bring the
  consensus residual back below the floor within one global-average
  cycle.  The gossip rounds run on the kernel lane where there is one
  (``gossip_kernel="auto"``: the CUDA K2/K1 of ``csrc/gossip_edge.cu``
  on the card, one of each a faulted round at the ring's one edge; the
  plain transport on the CPU).  The default device is the card; without
  one the drill fails, saying so (``--device cpu`` runs it on the CPU);
* ``--describe SPEC`` — parse a fault spec against a topology and print
  what it compiles to: events, mask period, per-tick dropped-edge
  counts, and the worst effective-matrix column-sum error (0 under
  mass-conserving semantics).  The lines are the reference's, character
  for character.

Where the reference runs one compiled ``shard_map`` round over a
world-8 mesh, a round here is ``algorithm.post_step`` over a
:class:`~..parallel.collectives.StackedTransport` (the ranks as the
leading dim of one ``[8, 128]`` tensor), the health signals reduce over
that transport, and the recovery is ``make_recovery_fn(algorithm)``'s
global average.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from .faults import parse_fault_spec

WORLD = 8
SELFTEST_SPEC = "drop:0->1@0:64;seed:7"
SELFTEST_ROUNDS = 12
PARAM_DIM = 128

__all__ = ["run_drill", "main", "WORLD", "SELFTEST_SPEC",
           "SELFTEST_ROUNDS"]


class _Capture(logging.Handler):
    """Collect emitted log lines so the selftest can assert on them."""

    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_drill(device="cuda", gossip_kernel="auto",
              residual_floor: float = 0.01) -> dict:
    """The drill on ``device`` over the ``gossip_kernel`` lane
    (``"auto"``, ``"pallas"``, ``"xla"`` or a
    :class:`~..ops.gossip_kernel.KernelLane`).  Returns ``failures`` (the
    checks that did not hold, empty when all did), the faulted rounds'
    ``params``/``ps_weight`` after the 12 rounds (``round_params``,
    ``round_ps_weight``) and after recovery and the one more round
    (``params``, ``ps_weight``), all ``[8, ...]`` float32 numpy, with
    ``drift``, ``residual``, ``health_lines``, ``lane`` and the K2/K1
    ``launches`` it made.  A device or lane that cannot be had raises
    (:class:`~..device.DeviceUnavailableError`,
    :class:`~..ops.gossip_kernel.KernelBackendError`): never a fallback
    to another lane."""
    import numpy as np
    import torch

    from ..algorithms import sgp
    from ..analysis import verify_schedule
    from ..device import resolve_device
    from ..ops import gossip_kernel as gk
    from ..parallel.collectives import StackedTransport
    from ..topology import RingGraph, build_schedule
    from .monitor import HealthMonitor, health_signals, host_signals
    from .recovery import RecoveryPolicy, make_recovery_fn

    device = resolve_device(device)
    lane = gk.resolve_gossip_kernel(gossip_kernel, device=device)

    failures: list[str] = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    # the ring is the topology where a single dead edge hurts most — the
    # honest worst case for the recovery claim
    sched = build_schedule(RingGraph(WORLD, peers_per_itr=1))
    plan = parse_fault_spec(SELFTEST_SPEC)
    masks = plan.build_masks(sched)

    # 1. algebra: the faulted mixing matrices pass the verifier's
    # column-stochasticity check (SGPV102) — mass conservation by
    # construction, not by luck
    for tick in (0, 1, SELFTEST_ROUNDS - 1):
        eff = plan.effective_schedule(sched, tick)
        findings, _ = verify_schedule(eff, f"faulted-ring@t{tick}",
                                      "<chaos>", 0)
        check(not findings,
              f"effective schedule at tick {tick} failed verification: "
              + "; ".join(f.message for f in findings))

    # 2. dynamics: the faulted gossip rounds on the chosen lane
    transport = StackedTransport(WORLD)
    alg = sgp(sched, transport, faults=masks, gossip_kernel=lane)

    def gossip_step(params, gstate):
        params, gstate = alg.post_step(params, gstate)
        sig = host_signals(health_signals(params, None, gstate.ps_weight,
                                          transport))
        return params, gstate, sig

    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(WORLD, PARAM_DIM)).astype(np.float32)
    params = {"w": torch.from_numpy(x0.copy()).to(device)}
    gstate = alg.init(params)

    capture = _Capture()
    log = logging.getLogger("chaos-selftest")
    log.setLevel(logging.INFO)
    log.propagate = False
    log.addHandler(capture)
    try:
        monitor = HealthMonitor(health_every=1,
                                residual_floor=residual_floor, log=log)
        policy = RecoveryPolicy(world=WORLD, topology="ring",
                                residual_floor=residual_floor,
                                cooldown_steps=0, log=log)
        recovery = make_recovery_fn(alg)

        before = (gk.gossip_edge_start.launches,
                  gk.gossip_edge_wait.launches)
        last_report = sig = None
        for t in range(SELFTEST_ROUNDS):
            params, gstate, sig = gossip_step(params, gstate)
            last_report = monitor.observe(t, sig)
        round_params = params["w"].cpu().numpy()
        round_ps = gstate.ps_weight.cpu().numpy()

        # mean preservation under the dropped edge, float32 tolerance
        drift = float(np.abs(round_params.mean(0) - x0.mean(0)).max())
        check(drift < 1e-5,
              f"network mean drifted {drift:.2e} under the dropped edge "
              "(mass-conserving semantics violated)")
        check(float(sig["ps_mass_err"]) < 1e-4,
              f"push-sum mass error {sig['ps_mass_err']:.2e} under "
              "mass-conserving drops")

        # the monitor must have reported the excursion in a structured
        # line
        check(last_report is not None and last_report.unhealthy
              and "residual-above-floor" in last_report.reasons,
              "monitor did not flag the residual excursion")
        health_lines = [line for line in capture.lines
                        if line.startswith("gossip health: ")]
        check(any("residual-above-floor" in line for line in health_lines),
              "no structured 'gossip health:' line reported the excursion")
        for line in health_lines[:1]:
            payload = json.loads(line[len("gossip health: "):])
            check("consensus_residual" in payload and "step" in payload,
                  "health line payload is not the structured schema")

        # 3. recovery: one global-average cycle must close the excursion
        event = policy.assess(last_report)
        check(event.action == "global-average",
              f"policy chose {event.action!r} instead of global-average")
        check(event.suggestion is not None
              and event.suggestion.get("topology"),
              "recovery did not consult the planner for a suggestion")
        params_w, new_w = recovery(params, gstate.ps_weight)
        gstate = gstate.replace(ps_weight=new_w)
        params = params_w
        post = params["w"].cpu().numpy()
        post_drift = float(np.abs(post.mean(0) - x0.mean(0)).max())
        check(post_drift < 1e-5,
              f"global average moved the network mean by {post_drift:.2e}")
        check(np.allclose(gstate.ps_weight.cpu().numpy(), 1.0),
              "recovery did not reset push-sum weights to 1")
        # one more faulted gossip round, then the residual the monitor
        # would see: below the floor within one cycle
        params, gstate, sig = gossip_step(params, gstate)
        residual = float(sig["consensus_residual"])
        check(residual < residual_floor,
              f"consensus residual {residual:.2e} still above the floor "
              f"{residual_floor} one cycle after recovery")
        check(any(line.startswith("gossip recovery: ")
                  for line in capture.lines),
              "no structured 'gossip recovery:' line was emitted")
        launches = {
            "gossip_edge_start": gk.gossip_edge_start.launches - before[0],
            "gossip_edge_wait": gk.gossip_edge_wait.launches - before[1]}
    finally:
        log.removeHandler(capture)
    return {"failures": failures, "device": str(device),
            "lane": alg.transport_kernel_name,
            "round_params": round_params, "round_ps_weight": round_ps,
            "params": params["w"].cpu().numpy(),
            "ps_weight": gstate.ps_weight.cpu().numpy(),
            "drift": drift, "residual": residual,
            "health_lines": len(health_lines), "launches": launches}


def _selftest(residual_floor: float, device="cuda",
              gossip_kernel="auto") -> int:
    from ..device import DeviceUnavailableError
    from ..ops.gossip_kernel import KernelBackendError

    try:
        out = run_drill(device, gossip_kernel, residual_floor)
    except (DeviceUnavailableError, KernelBackendError) as e:
        print(f"chaos selftest FAILED: {e}", file=sys.stderr)
        return 1
    if out["failures"]:
        for f in out["failures"]:
            print(f"chaos selftest FAILED: {f}", file=sys.stderr)
        return 1
    k = out["launches"]
    print(f"chaos selftest: OK (world {WORLD} ring, spec "
          f"'{SELFTEST_SPEC}': mean drift {out['drift']:.2e}, "
          f"{out['health_lines']} health lines, post-recovery residual "
          f"{out['residual']:.2e} < {residual_floor})")
    print(f"chaos drill: stacked on {out['device']}, {out['lane']} lane, "
          f"K2/K1 launched {k['gossip_edge_start']}/"
          f"{k['gossip_edge_wait']}", flush=True)
    return 0


def _describe(spec: str, topology: str, world: int, ppi: int) -> int:
    import numpy as np

    from ..topology import TOPOLOGY_NAMES, build_schedule

    if topology not in TOPOLOGY_NAMES:
        print(f"chaos: unknown topology {topology!r}; one of "
              f"{sorted(TOPOLOGY_NAMES)}", file=sys.stderr)
        return 2
    try:
        plan = parse_fault_spec(spec)
        sched = build_schedule(TOPOLOGY_NAMES[topology](
            world, peers_per_itr=ppi))
        masks = plan.build_masks(sched)
    except ValueError as e:
        print(f"chaos: error: {e}", file=sys.stderr)
        return 2
    print(f"fault plan for {topology} world={world} ppi={ppi}:")
    print(f"  {plan.summary()}")
    print(f"  mask rows: {masks.horizon} per-tick + {masks.num_phases} "
          "steady-state (one per rotation phase)")
    worst = 0.0
    keep = masks.keep_host()
    for t in range(masks.horizon):
        w = plan.effective_matrix(sched, t)
        dropped = int(round(float((1.0 - keep[t]).sum())))
        col_err = float(np.abs(w.sum(axis=0) - 1.0).max())
        worst = max(worst, col_err)
        if dropped or t < 3:
            print(f"  tick {t}: {dropped} dropped edge-message(s), "
                  f"column-sum error {col_err:.2e}")
    for p in range(masks.num_phases):
        row = keep[masks.horizon + p]
        dropped = int(round(float((1.0 - row).sum())))
        if dropped:
            print(f"  steady state, phase {p}: {dropped} dropped "
                  "edge-message(s) (open-ended events)")
    print(f"  worst column-sum error over the horizon: {worst:.2e} "
          f"({'mass-conserving' if worst < 1e-9 else 'LEAKING MASS'})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="chaos",
        description="Gossip fault injection: describe plans, run the "
                    "resilience selftest")
    ap.add_argument("--selftest", action="store_true",
                    help="run the resilience self-check and exit")
    ap.add_argument("--describe", default=None, metavar="SPEC",
                    help="compile SPEC (faults.py grammar) and print the "
                         "resulting mask tables' invariants")
    ap.add_argument("--topology", default="ring",
                    help="topology to compile --describe against")
    ap.add_argument("--world", type=int, default=WORLD)
    ap.add_argument("--ppi", type=int, default=1)
    ap.add_argument("--residual_floor", type=float, default=0.01,
                    help="selftest recovery floor")
    ap.add_argument("--device", default="cuda",
                    help="the selftest's device: cuda (the default; the "
                         "CUDA K2/K1) or cpu (the plain transport)")
    ap.add_argument("--gossip_kernel", default="auto",
                    choices=("auto", "pallas", "xla"),
                    help="the selftest's transport lane: auto (the "
                         "kernels on the card), pallas (the kernels or "
                         "an error), xla (the plain transport)")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest(args.residual_floor, args.device,
                         args.gossip_kernel)
    if args.describe:
        return _describe(args.describe, args.topology, args.world,
                         args.ppi)
    ap.error("choose --selftest or --describe SPEC")
    return 2
