"""The wire codec's selftest behind ``scripts/torch_wirecheck.py``.

Port of ``stochastic_gradient_push_tpu/parallel/wirecheck.py``: the
acceptance loop of the quantized gossip wire (``parallel/wire.py`` and
the codec path of ``parallel/collectives.py``) on the stacked lane at
world 8:

1. **chaos round** — int8 + error feedback under a dropped edge
   (``drop:0->1``): the network mean including the pending residuals
   (the telescoping identity) is kept to float32 tolerance, the raw
   mean moves by no more than one quantization step, the push-sum
   weight lane stays exact (it never touches the codec), and the health
   monitor reports ``ef_residual_rms`` in its payload;
2. **parity** — a small SGD consensus problem run twice, exact f32 wire
   against int8 + EF: after the same steps the compressed run's
   consensus spread and optimum error are within 2x of the exact one's;
3. **pricing** — the encoded bytes (``telemetry.encoded_payload_bytes``
   through ``CommModel``) equal a hand count, the int8 payload is at
   least 3.5x below f32, and the model stamps the codec and the plain
   transport lane (``"xla"``);
4. **kernel lane** — the same chaos round through the gossip kernel
   lane (K2/K1, ``ops/gossip_kernel.py``): its ps-weight trajectory is
   bit-identical to the plain lane's, its params within 1e-5, its
   telescoped mean kept.  On a CUDA device it launches the CUDA K2 and
   K1 (counted); on the CPU it runs their plain twins
   (``KernelLane(interpret=True)``).  Where the lane cannot be had (a
   CUDA device without a card, or kernels that do not build) the
   selftest fails, saying so: it never falls back to the plain lane.

Runs in seconds on either device.
"""

from __future__ import annotations

import argparse
import sys

WORLD = 8
CHAOS_SPEC = "drop:0->1@0:64;seed:7"
CHAOS_ROUNDS = 12
PARITY_STEPS = 120

__all__ = ["selftest", "main", "WORLD"]


def _lane(device):
    """The kernel lane for ``device``: the CUDA kernels on the card,
    their twins on the CPU."""
    from ..ops.gossip_kernel import KernelLane, resolve_gossip_kernel

    if device.type == "cuda":
        return resolve_gossip_kernel("pallas", device=device)
    return KernelLane(interpret=True)


def selftest(device=None) -> int:
    """Run the four stages on ``device`` (default: the card when there
    is one, else the CPU); print ``wire selftest: OK (...)`` and return
    0 when every check passes, else print each failure and return 1."""
    import numpy as np
    import torch

    from ..algorithms import sgp
    from ..device import resolve_device
    from ..ops import gossip_kernel as gk
    from ..parallel.collectives import StackedTransport
    from ..parallel import wire
    from ..resilience import parse_fault_spec
    from ..resilience.monitor import (EF_HEALTH_KEY, HealthMonitor,
                                      health_signals, host_signals)
    from ..telemetry import CommModel, encoded_payload_bytes
    from ..topology import (NPeerDynamicDirectedExponentialGraph,
                            RingGraph, build_schedule)

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    try:
        device = resolve_device(device)
        lane = _lane(device)
    except Exception as e:  # noqa: BLE001 — reported, never a fallback
        print(f"wire selftest FAILED: the gossip kernel lane cannot be "
              f"had on {device}: {e}", file=sys.stderr)
        return 1

    failures: list[str] = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    transport = StackedTransport(WORLD)
    codec = wire.Int8Codec(64)

    # -- 1. chaos round: int8 + EF + a dropped edge ------------------------
    sched = build_schedule(RingGraph(WORLD, peers_per_itr=1))
    masks = parse_fault_spec(CHAOS_SPEC).build_masks(sched)
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(WORLD, 128)).astype(np.float32)
    x0_mean = x0.mean(0)

    def run_chaos(kernel):
        """The chaos loop on one transport lane: the final (params,
        residual, last signals, last report, ps-weight trajectory)."""
        alg = sgp(sched, transport, faults=masks, wire=codec,
                  error_feedback=True, gossip_kernel=kernel)
        params = {"x": torch.from_numpy(x0.copy()).to(device)}
        gstate = alg.init(params)
        monitor = HealthMonitor(health_every=1, residual_floor=1e9,
                                log=None)
        report = sig = None
        ps_traj = []
        for t in range(CHAOS_ROUNDS):
            params, gstate = alg.post_step(params, gstate)
            sig = host_signals(health_signals(
                params, None, gstate.ps_weight, transport,
                ef_residual=gstate.ef_residual))
            ps_traj.append(gstate.ps_weight.cpu().numpy().copy())
            report = monitor.observe(t, sig)
        return (params["x"].cpu().numpy(),
                gstate.ef_residual["x"].cpu().numpy(), sig, report,
                np.stack(ps_traj))

    params, res, sig, report, ps_traj = run_chaos(None)
    # telescoping identity: delivered mass + pending residuals == exact
    drift_tel = np.abs((params.sum(0) + res.sum(0)) / WORLD
                       - x0_mean).max()
    check(drift_tel < 1e-5,
          f"telescoped mean drifted {drift_tel:.2e} under int8+EF with "
          "a dropped edge (residual accounting broken)")
    # the raw mean moves by at most the pending residual mass
    drift_raw = np.abs(params.mean(0) - x0_mean).max()
    check(drift_raw < 5e-3,
          f"raw network mean drifted {drift_raw:.2e} — beyond one "
          "quantization step of pending residual")
    check(sig["ps_mass_err"] < 1e-4,
          f"push-sum mass error {sig['ps_mass_err']:.2e}: the exact "
          "f32 weight lane leaked under compression")
    check(EF_HEALTH_KEY in (report.payload if report else {}),
          "health payload is missing the ef_residual_rms signal")
    ef_rms = sig.get(EF_HEALTH_KEY, float("nan"))
    check(0.0 < ef_rms < 0.1,
          f"ef_residual_rms {ef_rms} outside the healthy band "
          "(bounded residual ~ one quantization step)")

    # -- 2. parity: int8+EF vs exact f32 on an SGD consensus problem -------
    psched = build_schedule(
        NPeerDynamicDirectedExponentialGraph(WORLD, peers_per_itr=1))
    targets = torch.from_numpy(
        rng.normal(size=(WORLD, 64)).astype(np.float32)).to(device)
    lr = 0.05

    def run(wire_codec, ef):
        a = sgp(psched, transport, wire=wire_codec, error_feedback=ef)
        p = {"x": torch.from_numpy(
            rng.normal(size=(WORLD, 64)).astype(np.float32)).to(device)}
        g = a.init(p)
        for _ in range(PARITY_STEPS):
            p, g = a.pre_step(p, g)
            z = a.eval_params(p, g)
            # the gradient of 0.5 * |z - target|^2
            p, g = a.post_step({"x": p["x"] - lr * (z["x"] - targets)}, g)
        z = (p["x"] / g.ps_weight.reshape(WORLD, 1)).cpu().numpy()
        t = targets.cpu().numpy()
        spread = float(np.abs(z - z.mean(0)).max())
        err = float(np.abs(z.mean(0) - t.mean(0)).max())
        return spread, err

    f32_spread, f32_err = run(None, False)
    i8_spread, i8_err = run(codec, True)
    # consensus error within 2x of exact after the same step budget (the
    # floors guard the comparison against float noise)
    check(i8_spread <= 2.0 * max(f32_spread, 1e-4),
          f"int8+EF consensus spread {i8_spread:.2e} > 2x f32 "
          f"{f32_spread:.2e}")
    check(i8_err <= 2.0 * max(f32_err, 1e-3),
          f"int8+EF optimum error {i8_err:.2e} > 2x f32 {f32_err:.2e}")

    # -- 3. pricing: modeled == hand count, >= 3.5x reduction --------------
    tmpl = {"w": torch.zeros(WORLD, 1000), "b": torch.zeros(WORLD, 24)}
    hand = (1000 + 4 * -(-1000 // 64)) + (24 + 4 * -(-24 // 64))
    enc = encoded_payload_bytes(tmpl, WORLD, codec)
    check(enc == hand,
          f"encoded_payload_bytes {enc} != hand count {hand}")
    exact = 4 * 1024
    check(exact / enc >= 3.5,
          f"int8 payload reduction {exact / enc:.2f}x < 3.5x")
    model = CommModel.from_schedule(psched, enc, exact_bytes=exact,
                                    codec=codec, error_feedback=True)
    totals = model.totals(4)
    check(totals["gossip_wire"] == 4 * (enc + 4),
          f"modeled wire bytes {totals['gossip_wire']} != "
          f"{4 * (enc + 4)} (payload + ps-weight lane, 4 rounds)")
    check(model.to_dict()["wire_dtype"] == "int8"
          and model.to_dict()["error_feedback"],
          "CommModel snapshot does not stamp the wire codec")
    check(model.to_dict().get("gossip_kernel") == "xla",
          "CommModel snapshot does not stamp the transport lane")

    # -- 4. kernel lane: the same chaos round through K2/K1 ----------------
    before = (gk.gossip_edge_start.launches, gk.gossip_edge_wait.launches)
    try:
        k_params, k_res, _, _, k_ps_traj = run_chaos(lane)
    except Exception as e:  # noqa: BLE001 — reported, never a fallback
        print(f"wire selftest FAILED: the gossip kernel lane on {device} "
              f"did not run: {e}", file=sys.stderr)
        return 1
    k2 = gk.gossip_edge_start.launches - before[0]
    k1 = gk.gossip_edge_wait.launches - before[1]
    check(np.array_equal(ps_traj, k_ps_traj),
          "kernel-lane ps-weight trajectory diverged from the plain lane "
          f"(max |d| {np.abs(ps_traj - k_ps_traj).max():.2e}); the "
          "scalar lane must be bit-identical")
    k_drift = np.abs((k_params.sum(0) + k_res.sum(0)) / WORLD
                     - x0_mean).max()
    check(k_drift < 1e-5,
          f"kernel-lane telescoped mean drifted {k_drift:.2e} under "
          "int8+EF with a dropped edge (the in-kernel decode broke the "
          "residual accounting)")
    d_params = np.abs(k_params - params).max()
    check(d_params < 1e-5,
          f"kernel-lane params diverged {d_params:.2e} from the plain "
          "lane after the chaos round (beyond f32 tolerance)")
    if device.type == "cuda":
        check(k2 > 0 and k1 > 0,
              f"the kernel lane on {device} launched K2 {k2} and K1 {k1} "
              "times")

    if failures:
        for f in failures:
            print(f"wire selftest FAILED: {f}", file=sys.stderr)
        return 1
    where = (f"{device}: K2/K1 launched {k2}/{k1}" if device.type == "cuda"
             else f"{device}: K2/K1 twins")
    print(f"wire selftest: OK (world {WORLD} stacked on {where}; int8+EF "
          f"chaos round mean drift {drift_tel:.2e} telescoped / "
          f"{drift_raw:.2e} raw, ef_rms {ef_rms:.2e} in band; parity "
          f"spread {i8_spread:.2e} vs f32 {f32_spread:.2e}; payload "
          f"{exact}->{enc} B = {exact / enc:.2f}x; kernel lane: ps-weight "
          f"bit-identical, params |d| {d_params:.1e}, telescoped drift "
          f"{k_drift:.2e})", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_wirecheck",
        description="Quantized gossip wire format: the selftest")
    ap.add_argument("--selftest", action="store_true",
                    help="run the wire self-check and exit")
    ap.add_argument("--device", default=None,
                    help="cuda (the CUDA K2/K1 in stage 4) or cpu (their "
                         "twins); default: the card when there is one, "
                         "else the CPU")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest(args.device)
    ap.error("choose --selftest")
    return 2
