"""Port parity: error feedback (``GossipState.ef_residual``) on the
push-sum wire.

Each round sends ``Q(w_0·x + r)`` on edge 0 of the ranks that send and
keeps the round's quantization error as the next residual; a residual
whose edge was dropped stays pending, an idle (thinned) step keeps it,
and it lives only on the payload leaves.

* World 8 rounds, bf16 and int8 (block 16), one and two peers,
  self-weighted and uniform mixing, with and without a fault plan
  (drops, blackouts, NaN corruption), synchronous and the overlap
  launch, against the reference's compiled round (``jax.jit`` of
  ``shard_map``): the new residual, the ps-weight and the params (or
  the split's local and incoming shares) **bit-equal**, NaN positions
  included.  The port rounds as the reference's compiled round does:
  ``w_0·x + r`` is one fused multiply-add on the wire, the int8 error
  ``msg - q·scale`` another; where a later edge shares edge 0's weight
  table XLA computes ``w_0·x`` once for both and the error takes the
  two-step ``w_0·x + r`` (for bf16 only on ranks whose later edge
  sends when no rank is corrupted, the fusion being specialised per
  rank on its keep row).
* The kernel lane (the K1/K2 plain twins, 3 buckets): the residual and
  the ps-weight bit-equal to the plain lane's (both come from the same
  encoded parts and the exact weight lane), the params within 4 ulps
  of the inputs' scale; where the local share ``lo * x`` is exact (one
  peer, uniform mixing) three steps with faults are bit-equal across
  the lanes in everything.
* The algorithm slots at world 4 step for step against the reference's
  compiled step (``tests/torch_gossip_drive.py``): SGP, OSGP at
  staleness 2, thinned SGP (``gossip_every=2``, the residual carried
  through the idle steps) and thinned OSGP, bf16 and int8, with and
  without faults: residual, ps-weight, params and the FIFO bit-equal.
* Refusals with the reference's messages: an exact wire, and the
  push-pull (D-PSGD) path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_gossip_drive as drive
from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw

torch.set_num_threads(1)

W8 = 8
SPECS = (None, "drop:0->1@0:4;blackout:2@1:3", "nan:2@0:4;slice:4-5@0:4")


def _state(seed):
    r = np.random.default_rng(seed)
    params = {"w": r.standard_normal((W8, 6, 50)).astype(np.float32),
              "b": r.standard_normal((W8, 130)).astype(np.float32)}
    res = {n: (r.standard_normal(a.shape) * 1e-3).astype(np.float32)
           for n, a in params.items()}
    ps = (1.0 + r.random(W8)).astype(np.float32)
    return params, res, ps


def _reference(jsched, jcodec, jmask, params, res, ps, tick, split):
    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_sum, overlap_launch)
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)

    def body(p, w, e):
        if split:
            return overlap_launch(
                (p, w), jnp.int32(tick), jsched, GOSSIP_AXIS, codec=jcodec,
                faults=jmask, tick=jnp.int32(tick),
                ef_residual=(e, jnp.zeros_like(w)))
        return mix_push_sum(p, w, jnp.int32(tick), jsched, GOSSIP_AXIS,
                            codec=jcodec, faults=jmask,
                            tick=jnp.int32(tick), ef_residual=e)

    fn = jax.jit(jax.shard_map(
        body, mesh=make_gossip_mesh(W8), in_specs=(P(GOSSIP_AXIS),) * 3,
        out_specs=P(GOSSIP_AXIS)))
    return jax.device_get(fn(params, ps, res))


@pytest.mark.parametrize("wire", ["bf16", "int8"])
@pytest.mark.parametrize("ppi,mix", [(1, "self"), (2, "self"),
                                     (2, "uniform")])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("split", [False, True])
def test_ef_round_bit_equal_reference(wire, ppi, mix, spec, split):
    jsched, tsched = drive.schedules(ppi, mix, W8)
    jcodec, tcodec = drive.codecs(wire)
    jmask, tmask = drive.masks(spec, jsched, tsched)
    params, res, ps = _state(ppi)
    tick = 1
    want = _reference(jsched, jcodec, jmask, params, res, ps, tick, split)
    names = list(params)
    leaves = [torch.from_numpy(params[n].copy()) for n in names]
    leaves.append(torch.from_numpy(ps.copy()))
    residual = [torch.from_numpy(res[n].copy()) for n in names]
    residual.append(torch.zeros(W8))
    transport = tc.StackedTransport(W8)
    plain = None
    for lane in ("plain", "kernel"):
        kernel = (KernelLane(interpret=True, chunk_elems=256)
                  if lane == "kernel" else None)
        kw = dict(codec=tcodec, faults=tmask, tick=tick, kernel=kernel,
                  buckets=3, ef_residual=list(residual))
        if split:
            local, inc, new_res = tc.overlap_launch(
                list(leaves), tick, tsched, transport, **kw)
            if isinstance(inc, tc.PendingShares):
                inc = tc.settle_share(inc)
            mixed = [(local, want[0]), (inc, want[1])]
            ref_res = want[2][0]
        else:
            out, new_res = tc.gossip_round(list(leaves), tick, tsched,
                                           transport, **kw)
            mixed = [(out, (want[0], want[1]))]
            ref_res = want[2]
        for k, n in enumerate(names):
            drive.assert_equal(new_res[k].numpy(), ref_res[n],
                               f"{lane} residual {n}")
        np.testing.assert_array_equal(new_res[-1].numpy(), np.zeros(W8))
        for mine, (ref_p, ref_w) in mixed:
            drive.assert_equal(mine[-1].numpy(), np.asarray(ref_w),
                               f"{lane} ps-weight")
            for k, n in enumerate(names):
                if lane == "plain":
                    drive.assert_equal(mine[k].numpy(), ref_p[n],
                                       f"{lane} {n}")
                else:
                    drive.assert_within_input_ulp(
                        mine[k].numpy(), ref_p[n], params[n], f"{lane} {n}")
        if plain is None:
            plain = [r.numpy() for r in new_res]
        else:
            for a, b in zip(new_res, plain):
                drive.assert_equal(a.numpy(), b, "kernel vs plain residual")


@pytest.mark.parametrize("wire", ["bf16", "int8"])
@pytest.mark.parametrize("overlap,staleness,gossip_every", [
    (False, 1, 1), (True, 2, 1), (False, 1, 2), (True, 2, 2)])
@pytest.mark.parametrize("spec", [None, "drop:0->1@1:5;nan:3@4:5"])
def test_ef_steps_match_reference(wire, overlap, staleness, gossip_every,
                                  spec):
    steps = 6
    ref, port = drive.algorithms(overlap=overlap, staleness=staleness,
                                 gossip_every=gossip_every, wire=wire,
                                 error_feedback=True, spec=spec)
    params, targets = drive.data(11, steps)
    want = drive.reference_trajectory(ref, params, targets)
    got = drive.port_trajectory(port, params, targets)
    idle = 0
    for t, ((gp, gw, gf, gr), (wp, ww, wf, wr)) in enumerate(zip(got,
                                                                 want)):
        drive.assert_equal(gw, ww, f"ps-weight step {t}")
        assert set(gr) == set(wr) == set(drive.SHAPES)
        for n in wp:
            drive.assert_equal(gp[n], wp[n], f"{n} step {t}")
            drive.assert_equal(gr[n], wr[n], f"residual {n} step {t}")
        for (fp, fw), (rp, rw) in zip(gf, wf):
            drive.assert_equal(fw, rw, f"fifo weight step {t}")
            for n in rp:
                drive.assert_equal(fp[n], rp[n], f"fifo {n} step {t}")
        if t and t % gossip_every:
            # an idle step leaves the residual as it was
            idle += 1
            for n in gr:
                drive.assert_equal(gr[n], got[t - 1][3][n], "idle step")
    # the scalar leaf never carries a residual
    np.testing.assert_array_equal(got[-1][3]["s"], 0.0)
    assert idle == (steps - 1 - (steps - 1) // gossip_every
                    if gossip_every > 1 else 0)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
@pytest.mark.parametrize("spec", ["drop:0->1@0:2;seed:5", "straggler:2@1:3"])
def test_kernel_lane_equals_plain_lane_where_the_local_share_is_exact(
        wire, spec):
    """At one peer under uniform mixing ``lo * x`` is exact (lo = 1/2),
    so the kernel lane's separately rounded local share, the wait's
    edge and the reabsorption after it round as the plain lane's fused
    fold does: three steps with error feedback and faults bit-equal
    across the lanes (``chip_smoke.py`` phase 9a on the card)."""
    runs = []
    for kernel in (None, KernelLane(interpret=True, chunk_elems=64)):
        _, port = drive.algorithms(wire=wire, error_feedback=True,
                                   spec=spec, kernel=kernel, buckets=2)
        params, targets = drive.data(13, 3)
        runs.append(drive.port_trajectory(port, params, targets))
    for t, (k, p) in enumerate(zip(*runs)):
        drive.assert_equal(k[1], p[1], f"ps-weight step {t}")
        for n in p[0]:
            drive.assert_equal(k[0][n], p[0][n], f"{n} step {t}")
            drive.assert_equal(k[3][n], p[3][n], f"residual {n} step {t}")


def test_refusals_match_reference():
    _, tsched = drive.schedules()
    transport = tc.StackedTransport(drive.WORLD)
    for wire in (None, tw.F32):
        with pytest.raises(ValueError, match="error_feedback needs a lossy "
                                             "wire codec"):
            talg.sgp(tsched, transport, wire=wire, error_feedback=True)
    with pytest.raises(ValueError, match="track_weight=True"):
        talg.PushSumGossip(tsched, transport, track_weight=False,
                           wire=tw.BF16, error_feedback=True)
    params = {"w": torch.zeros(drive.WORLD, 70)}
    with pytest.raises(ValueError, match="error feedback needs a lossy "
                                         "wire codec"):
        tc.mix_push_sum(params, torch.ones(drive.WORLD), 0, tsched,
                        transport, ef_residual=params)
