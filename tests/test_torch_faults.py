"""Port parity: deterministic fault injection (``stochastic_gradient_push_
torch.resilience.faults``) and faulted push-sum rounds.

* Fault tables: the port's keep and corrupt tables equal the reference's
  ``FaultPlan.host_tables`` bit for bit for every kind (``drop``,
  ``drop_random`` with its seeded field, ``straggler``, ``blackout``,
  ``slice``, ``nan``), at ``gossip_every`` 1 and 2, and the per-tick
  rows past the horizon (the per-phase steady state) equal the
  reference's ``FaultMasks`` lookup.  Parsing, validation,
  ``effective_schedule``/``effective_matrix`` and the summary line
  agree; parse errors carry the reference's messages.
* Faulted rounds at world 8 (drop, straggler, blackout, slice, NaN,
  drop_random; one and two peers; self-weighted and uniform mixing)
  against the reference's compiled round (``jax.jit`` of ``shard_map``):
  synchronous and the overlap launch at a tick of its own, on the plain
  lane the ps-weight and the params **bit-equal** (NaN positions
  included).  On the kernel lane (the K1/K2 plain twins, 3 buckets)
  the ps-weight is bit-equal and the params within 4 ulps of the
  inputs' largest magnitude: there the local share and its reabsorbed
  fault weight are rounded before the wait adds the edges, where the
  reference's plain round folds them in between (the same terms summed
  in another order, up to four roundings each placed elsewhere).
* Mass: with reabsorption, four faulted rounds of a float64 state keep
  the push-sum weight total (1e-12 relative) and the parameter totals
  (1e-9); without it (``reabsorb=False``) the weight leaks.
* The algorithm slots at world 4 (SGP, thinned SGP, OSGP at staleness 2
  whose masks key on the launch tick) step for step against the
  reference's compiled step (``tests/torch_gossip_drive.py``): ps-weight,
  the FIFO and the params bit-equal.
* The algorithm refuses masks built for another ``gossip_every``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_gossip_drive as drive
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.resilience import faults as tf

torch.set_num_threads(1)

W8 = 8
SPECS = {
    "drop": "drop:0->1@0:4",
    "straggler": "straggler:3@0:4",
    "blackout": "blackout:2@1:3",
    "slice": "slice:4-5@0:4",
    "nan": "nan:2@0:4;drop:1->2@0:4",
    "drop_random": "drop_random:0.3@0:5;seed:3",
    "open": "drop:0->1;nan:6@2:3;seed:9",
}


def _ref_faults():
    from stochastic_gradient_push_tpu.resilience import faults as rf
    return rf


def _scheds(world, ppi, mix="uniform"):
    return drive.schedules(ppi, mix, world)


# -- the tables -------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("gossip_every", [1, 2])
@pytest.mark.parametrize("ppi", [1, 2])
def test_tables_bit_equal_reference(kind, gossip_every, ppi):
    rf = _ref_faults()
    jsched, tsched = _scheds(W8, ppi)
    rplan = rf.parse_fault_spec(SPECS[kind])
    tplan = tf.parse_fault_spec(SPECS[kind])
    assert tplan.to_dict() == rplan.to_dict()
    assert tplan.summary() == rplan.summary()
    rk, rc, rh = rplan.host_tables(jsched, gossip_every)
    tk, tc_, th = tplan.host_tables(tsched, gossip_every)
    assert th == rh
    np.testing.assert_array_equal(tk, rk)
    np.testing.assert_array_equal(tc_, rc)
    assert tk.dtype == rk.dtype == np.float32
    # the per-tick lookup, past the horizon too (the steady state)
    rmask = rplan.build_masks(jsched, gossip_every=gossip_every)
    tmask = tplan.build_masks(tsched, gossip_every=gossip_every)
    for tick in range(rh + 3 * jsched.num_phases * gossip_every):
        row = int(rmask._row(tick))
        for i in range(ppi):
            np.testing.assert_array_equal(tmask.keep_at(tick, i),
                                          rk[row, i], err_msg=str(tick))
        np.testing.assert_array_equal(tmask.corrupt_at(tick), rc[row])
    keep, corrupt = tmask.rows_on(rh + 1, "cpu")
    np.testing.assert_array_equal(keep.numpy(), tk[tmask._row(rh + 1)])
    assert (corrupt is None) == (not rc.any())
    for tick in (0, 1, rh + 1):
        np.testing.assert_array_equal(
            tplan.effective_matrix(tsched, tick, gossip_every),
            rplan.effective_matrix(jsched, tick, gossip_every))


@pytest.mark.parametrize("spec", [
    "", "seed:3", "drop:0-1@0:4", "drop_random:0.5", "drop_random:1.5@0:3",
    "slice:3@0:2", "slice:3-1@0:2", "fog:1@0:2", "drop:0->1@4:2",
    "drop:0->1@3", "straggler", "drop:1->1@0:2", "nan:9@0:2",
])
def test_parse_errors_match_reference(spec):
    rf = _ref_faults()
    sched = _scheds(W8, 1)
    with pytest.raises(ValueError) as want:
        rf.parse_fault_spec(spec).build_masks(sched[0])
    with pytest.raises(ValueError) as got:
        tf.parse_fault_spec(spec).build_masks(sched[1])
    assert str(got.value) == str(want.value)


# -- faulted rounds at world 8 ------------------------------------------------


def _round_state(ppi):
    r = np.random.default_rng(ppi)
    params = {"w": r.standard_normal((W8, 6, 50)).astype(np.float32),
              "b": r.standard_normal((W8, 130)).astype(np.float32)}
    ps = (1.0 + r.random(W8)).astype(np.float32)
    return params, ps


def _reference_round(jsched, jmask, params, ps, tick, split):
    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_sum, overlap_launch)
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)

    def body(p, w):
        if split:
            return overlap_launch((p, w), jnp.int32(tick), jsched,
                                  GOSSIP_AXIS, faults=jmask,
                                  tick=jnp.int32(tick))
        return mix_push_sum(p, w, jnp.int32(tick), jsched, GOSSIP_AXIS,
                            faults=jmask, tick=jnp.int32(tick))

    fn = jax.jit(jax.shard_map(
        body, mesh=make_gossip_mesh(W8), in_specs=(P(GOSSIP_AXIS),) * 2,
        out_specs=P(GOSSIP_AXIS)))
    return jax.device_get(fn(params, ps))


@pytest.mark.parametrize("kind", ["drop", "straggler", "blackout", "slice",
                                  "nan", "drop_random"])
@pytest.mark.parametrize("ppi,mix", [(1, "self"), (2, "self"),
                                     (2, "uniform")])
@pytest.mark.parametrize("split", [False, True])
def test_faulted_round_bit_equal_reference(kind, ppi, mix, split):
    rf = _ref_faults()
    jsched, tsched = _scheds(W8, ppi, mix)
    jmask = rf.parse_fault_spec(SPECS[kind]).build_masks(jsched)
    tmask = tf.parse_fault_spec(SPECS[kind]).build_masks(tsched)
    params, ps = _round_state(ppi)
    tick = 1
    want = _reference_round(jsched, jmask, params, ps, tick, split)
    names = list(params)
    leaves = [torch.from_numpy(params[n].copy()) for n in names]
    leaves.append(torch.from_numpy(ps.copy()))
    transport = tc.StackedTransport(W8)
    for lane in ("plain", "kernel"):
        kernel = (KernelLane(interpret=True, chunk_elems=256)
                  if lane == "kernel" else None)
        args = (list(leaves), tick, tsched, transport)
        kw = dict(faults=tmask, tick=tick, kernel=kernel, buckets=3)
        if split:
            local, inc = tc.overlap_launch(*args, **kw)
            if isinstance(inc, tc.PendingShares):
                inc = tc.settle_share(inc)
            got = [(local, want[0]), (inc, want[1])]
        else:
            got = [(tc.gossip_round(*args, **kw), want)]
        for mine, (ref_p, ref_w) in got:
            drive.assert_equal(mine[-1].numpy(), np.asarray(ref_w),
                               f"{lane} ps-weight")
            for k, n in enumerate(names):
                if lane == "plain":
                    drive.assert_equal(mine[k].numpy(), ref_p[n],
                                       f"{lane} {n}")
                else:
                    drive.assert_within_input_ulp(mine[k].numpy(), ref_p[n],
                                                  params[n], f"{lane} {n}")


@pytest.mark.parametrize("kind", ["drop", "straggler", "blackout", "slice",
                                  "drop_random"])
def test_reabsorption_keeps_the_mass(kind):
    _, tsched = _scheds(W8, 2, "self")
    params, ps = _round_state(3)
    transport = tc.StackedTransport(W8)
    for reabsorb in (True, False):
        mask = tf.parse_fault_spec(SPECS[kind]).build_masks(
            tsched, reabsorb=reabsorb)
        p = {n: torch.from_numpy(a.copy()).double() for n, a in
             params.items()}
        w = torch.from_numpy(ps.copy()).double()
        for tick in range(4):
            p, w = tc.mix_push_sum(p, w, tick, tsched, transport,
                                   faults=mask, tick=tick)
        if reabsorb:
            # float64 state: the totals are kept to rounding of the sums
            np.testing.assert_allclose(w.sum().item(),
                                       ps.astype(np.float64).sum(),
                                       rtol=1e-12)
            for n, a in params.items():
                np.testing.assert_allclose(p[n].sum(0).numpy(),
                                           a.astype(np.float64).sum(0),
                                           rtol=1e-9, atol=1e-9)
        else:
            assert w.sum().item() < ps.sum() - 1e-3


# -- the algorithm slots, step for step ---------------------------------------


@pytest.mark.parametrize("overlap,staleness,gossip_every,spec", [
    (False, 1, 1, "drop:0->1@1:5"),
    (False, 1, 2, "straggler:2@0:6"),
    (False, 1, 1, "nan:3@2:3"),
    (True, 1, 1, "blackout:1@1:4"),
    (True, 2, 1, "drop:0->1@1:5;slice:2-3@3:4"),
    (True, 2, 2, "drop_random:0.4@0:6;seed:5"),
])
def test_faulted_steps_match_reference(overlap, staleness, gossip_every,
                                       spec):
    steps = 6
    ref, port = drive.algorithms(overlap=overlap, staleness=staleness,
                                 gossip_every=gossip_every, spec=spec)
    params, targets = drive.data(7, steps)
    want = drive.reference_trajectory(ref, params, targets)
    got = drive.port_trajectory(port, params, targets)
    for t, ((gp, gw, gf, _), (wp, ww, wf, _)) in enumerate(zip(got, want)):
        drive.assert_equal(gw, ww, f"ps-weight step {t}")
        for n in wp:
            drive.assert_equal(gp[n], wp[n], f"{n} step {t}")
        assert len(gf) == len(wf)
        for (fp, fw), (rp, rw) in zip(gf, wf):
            drive.assert_equal(fw, rw, f"fifo weight step {t}")
            for n in rp:
                drive.assert_equal(fp[n], rp[n], f"fifo {n} step {t}")


def test_masks_for_another_thinning_are_refused():
    _, tsched = _scheds(4, 1)
    mask = tf.parse_fault_spec("drop:0->1@0:4").build_masks(
        tsched, gossip_every=1)
    from stochastic_gradient_push_torch import algorithms as talg

    with pytest.raises(ValueError, match="gossip_every=1 but the algorithm "
                                         "runs gossip_every=2"):
        talg.sgp(tsched, tc.StackedTransport(4), faults=mask,
                 gossip_every=2)
