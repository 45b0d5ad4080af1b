"""Port parity: communication thinning (``gossip_every``) and periodic
global averaging (``global_avg_every``, ``global_average``) of
``stochastic_gradient_push_torch.algorithms.PushSumGossip``.

* Thinned SGP and OSGP (``gossip_every`` 2 and 3, staleness 1 and 2)
  run an SGD-on-a-quadratic step against the reference's compiled step
  (``jax.jit`` of ``shard_map`` on the CPU mesh) from one state: the
  push-sum weight and the FIFO's weights bit-equal at every step, params
  and the FIFO's params within 1e-6 (XLA contracts the reference's
  ``p - lr * g`` into one rounding where the port takes two).  The
  port's kernel lane (``KernelLane(interpret=True)``, the plain twins)
  is held to the same reference.
* The rotation advances only on fired rounds.
* ``global_average`` against the reference's ``PushSumGossip.
  global_average`` called directly under ``shard_map``, with and without
  an in-flight FIFO.
* The periodic schedule against the numpy oracle of
  ``tests/test_averaging_thinning.py``: the reference's periodic form
  (``_maybe_global_average``'s ``lax.cond``) raises on this jax, so the
  trajectory is held to the oracle instead, within 1e-5.
* Under overlap the average folds every in-flight share exactly once.
* The LM CLI accepts ``--gossip_every`` and ``--global_avg_every``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel import collectives
from stochastic_gradient_push_torch.parallel.collectives import (
    StackedTransport)
from stochastic_gradient_push_torch.run import gossip_lm
from stochastic_gradient_push_torch.topology import (
    NPeerDynamicDirectedExponentialGraph, RingGraph, SelfWeightedMixing,
    build_schedule)

torch.set_num_threads(1)

WORLD = 4
DIM = 6
LR = 0.1
PARAM_ATOL = 1e-6


def _jax_alg(overlap, staleness, gossip_every, peers=1):
    from stochastic_gradient_push_tpu.algorithms import sgp as jsgp
    from stochastic_gradient_push_tpu.parallel import GOSSIP_AXIS
    from stochastic_gradient_push_tpu.topology import (
        NPeerDynamicDirectedExponentialGraph as JGraph,
        build_schedule as jbuild)

    return jsgp(jbuild(JGraph(WORLD, peers_per_itr=peers)), GOSSIP_AXIS,
                overlap=overlap, staleness=staleness,
                gossip_every=gossip_every)


def _jax_trajectory(alg, x0, targets, steps):
    """Per step ``(params, ps_weight, fifo)`` of the reference's
    compiled SGD-on-a-quadratic step, as numpy."""
    from stochastic_gradient_push_tpu.parallel import (
        GOSSIP_AXIS, make_gossip_mesh)

    def step(params, gstate, target):
        params, gstate = alg.pre_step(params, gstate)
        z = alg.eval_params(params, gstate)
        g = jax.tree.map(lambda a, t: a - t, z, target)
        return alg.post_step(
            jax.tree.map(lambda a, b: a - LR * b, params, g), gstate)

    f = jax.jit(jax.shard_map(
        step, mesh=make_gossip_mesh(WORLD), in_specs=(P(GOSSIP_AXIS),) * 3,
        out_specs=(P(GOSSIP_AXIS), P(GOSSIP_AXIS))))
    gstate = jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a),
                                  (WORLD,) + np.shape(a)).copy(),
        alg.init({"w": jnp.zeros((DIM,), jnp.float32)}))
    params, out = {"w": x0}, []
    for _ in range(steps):
        params, gstate = jax.block_until_ready(
            f(params, gstate, {"w": targets}))
        fifo = [(np.asarray(p["w"]), np.asarray(w).reshape(WORLD))
                for p, w in gstate.in_flight or ()]
        out.append((np.asarray(params["w"]),
                    np.asarray(gstate.ps_weight).reshape(WORLD), fifo))
    return out


def _port_step(alg, lr=LR):
    def step(params, gstate, target):
        params, gstate = alg.pre_step(params, gstate)
        z = alg.eval_params(params, gstate)
        params = {n: p - lr * (z[n] - target[n]) for n, p in params.items()}
        return alg.post_step(params, gstate)

    return step


def _port_alg(overlap, staleness, gossip_every, kernel=None, peers=1,
              global_avg_every=0, schedule=None):
    schedule = schedule or build_schedule(
        NPeerDynamicDirectedExponentialGraph(WORLD, peers_per_itr=peers))
    return talg.sgp(schedule, StackedTransport(WORLD), overlap=overlap,
                    staleness=staleness, gossip_every=gossip_every,
                    global_avg_every=global_avg_every,
                    gossip_kernel=kernel, gossip_buckets=2 if kernel else 1)


def _data(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(WORLD, DIM)).astype(np.float32),
            rng.normal(size=(WORLD, DIM)).astype(np.float32))


@pytest.mark.parametrize("overlap,staleness,gossip_every,lane", [
    (False, 1, 2, "plain"), (False, 1, 3, "plain"), (False, 1, 2, "kernel"),
    (True, 1, 2, "plain"), (True, 1, 3, "plain"), (True, 2, 2, "plain"),
    (True, 2, 3, "plain"), (True, 2, 2, "kernel"), (True, 1, 3, "kernel"),
])
def test_thinned_steps_match_reference(overlap, staleness, gossip_every,
                                       lane):
    steps = 4 * gossip_every + 1
    x0, targets = _data(10 * gossip_every + staleness)
    want = _jax_trajectory(_jax_alg(overlap, staleness, gossip_every),
                           x0, targets, steps)
    kernel = KernelLane(interpret=True, chunk_elems=8) \
        if lane == "kernel" else None
    alg = _port_alg(overlap, staleness, gossip_every, kernel=kernel)
    params = {"w": torch.from_numpy(x0.copy())}
    gstate = alg.init(params)
    step = _port_step(alg)
    target = {"w": torch.from_numpy(targets)}
    for t, (w_params, w_weight, w_fifo) in enumerate(want):
        params, gstate = step(params, gstate, target)
        np.testing.assert_allclose(params["w"].numpy(), w_params, rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"step {t}")
        np.testing.assert_array_equal(gstate.ps_weight.numpy(), w_weight,
                                      err_msg=f"step {t}")
        assert len(gstate.in_flight) == len(w_fifo)
        for (p, w), (wp, ww) in zip(gstate.in_flight, w_fifo):
            np.testing.assert_array_equal(w.numpy(), ww)
            np.testing.assert_allclose(p["w"].numpy(), wp, rtol=0,
                                       atol=PARAM_ATOL)
        assert gstate.phase == t + 1


@pytest.mark.parametrize("overlap", [False, True])
def test_rotation_advances_only_on_fired_rounds(overlap, monkeypatch):
    """Rounds fire at ticks 0, 3, 6 and run rotations 0, 1, 2; no other
    step mixes or launches."""
    fired = []
    name = "overlap_launch" if overlap else "mix_push_sum"
    real = getattr(collectives, name)

    def spy(tree, *rest, **kw):
        fired.append(rest[1] if not overlap else rest[0])
        return real(tree, *rest, **kw)

    monkeypatch.setattr(collectives, name, spy)
    alg = _port_alg(overlap, 1, 3)
    params = {"w": torch.ones(WORLD, DIM)}
    gstate = alg.init(params)
    ticks = []
    for t in range(8):
        before = len(fired)
        params, gstate = _port_step(alg)(params, gstate,
                                         {"w": torch.zeros(WORLD, DIM)})
        if len(fired) > before:
            ticks.append(t)
    assert ticks == [0, 3, 6]
    assert fired == [0, 1, 2]


@pytest.mark.parametrize("with_fifo", [False, True])
def test_global_average_matches_reference(with_fifo):
    """``x <- sum x / sum w`` over irregular push-sum weights, the weight
    reset to 1; with a FIFO, its shares folded in and the FIFO returned
    as zero slots."""
    from stochastic_gradient_push_tpu.parallel import (
        GOSSIP_AXIS, make_gossip_mesh)

    rng = np.random.default_rng(3)
    x = rng.normal(size=(WORLD, DIM)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(WORLD,)).astype(np.float32)
    fifo = tuple((rng.normal(size=(WORLD, DIM)).astype(np.float32),
                  rng.uniform(0.0, 0.5, size=(WORLD,)).astype(np.float32))
                 for _ in range(2)) if with_fifo else None
    jalg = _jax_alg(with_fifo, 2 if with_fifo else 1, 1)

    def ref(p, ww, fl):
        if fl is None:
            return jalg.global_average(p, ww)
        return jalg.global_average(p, ww, in_flight=fl)

    n_out = 3 if with_fifo else 2
    f = jax.jit(jax.shard_map(
        ref, mesh=make_gossip_mesh(WORLD), in_specs=(P(GOSSIP_AXIS),) * 3,
        out_specs=(P(GOSSIP_AXIS),) * n_out))
    jfifo = None if fifo is None else tuple(({"w": a}, b) for a, b in fifo)
    want = jax.device_get(f({"w": x}, w, jfifo))

    alg = _port_alg(with_fifo, 2 if with_fifo else 1, 1)
    tfifo = None if fifo is None else tuple(
        ({"w": torch.from_numpy(a)}, torch.from_numpy(b)) for a, b in fifo)
    got = alg.global_average({"w": torch.from_numpy(x)},
                             torch.from_numpy(w), in_flight=tfifo)
    np.testing.assert_allclose(got[0]["w"].numpy(), want[0]["w"], rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.ones(WORLD, np.float32))
    np.testing.assert_array_equal(np.asarray(want[1]).reshape(WORLD),
                                  np.ones(WORLD, np.float32))
    if with_fifo:
        for (p, ww), (wp, www) in zip(got[2], want[2]):
            assert not p["w"].any() and not ww.any()
            assert not np.asarray(wp["w"]).any() and not np.asarray(
                www).any()
    mass = x + sum(a for a, _ in fifo) if with_fifo else x
    total_w = w.sum() + (sum(b.sum() for _, b in fifo) if with_fifo else 0)
    np.testing.assert_allclose(got[0]["w"].numpy()[0],
                               mass.sum(0) / total_w, rtol=1e-6)


def _oracle(schedule, x0, targets, steps, gossip_every, global_avg_every,
            lr):
    """The numpy trajectory of ``tests/test_averaging_thinning.py``: SGD
    on the quadratic, the thinned round ``M(t // gossip_every)`` on fired
    steps, then every rank snaps to the mean when ``(t + 1) %
    global_avg_every == 0``."""
    sim, out = x0.astype(np.float64), []
    for t in range(steps):
        sim = sim - lr * (sim - targets)
        if t % gossip_every == 0:
            sim = schedule.mixing_matrix(t // gossip_every) @ sim
        if global_avg_every and (t + 1) % global_avg_every == 0:
            sim = np.broadcast_to(sim.mean(0), sim.shape).copy()
        out.append(sim)
    return out


def _overlap_oracle(schedule, x0, targets, steps, gossip_every,
                    global_avg_every, lr):
    """OSGP at staleness 1 on regular mixing: the gradient at the
    pre-round iterate, ``x <- M x - lr (x - t)`` on fired steps."""
    sim, out = x0.astype(np.float64), []
    for t in range(steps):
        grad = sim - targets
        if t % gossip_every == 0:
            sim = schedule.mixing_matrix(t // gossip_every) @ sim
        sim = sim - lr * grad
        if global_avg_every and (t + 1) % global_avg_every == 0:
            sim = np.broadcast_to(sim.mean(0), sim.shape).copy()
        out.append(sim)
    return out


@pytest.mark.parametrize("graph,gossip_every,global_avg_every,overlap", [
    ("ring", 1, 3, False), ("exp", 2, 3, False), ("exp", 1, 4, True),
    ("exp", 2, 3, True),
])
def test_periodic_average_matches_numpy_oracle(graph, gossip_every,
                                               global_avg_every, overlap):
    cls = RingGraph if graph == "ring" else \
        NPeerDynamicDirectedExponentialGraph
    schedule = build_schedule(cls(WORLD, peers_per_itr=1))
    x0, targets = _data(40 + gossip_every + global_avg_every)
    oracle = (_overlap_oracle if overlap else _oracle)(
        schedule, x0, targets, 12, gossip_every, global_avg_every, LR)
    alg = _port_alg(overlap, 1, gossip_every, schedule=schedule,
                    global_avg_every=global_avg_every)
    params = {"w": torch.from_numpy(x0.copy())}
    gstate = alg.init(params)
    for t, sim in enumerate(oracle):
        params, gstate = _port_step(alg)(params, gstate,
                                         {"w": torch.from_numpy(targets)})
        np.testing.assert_allclose(params["w"].numpy(), sim, rtol=1e-5,
                                   atol=1e-5, err_msg=str(t))
        if global_avg_every and (t + 1) % global_avg_every == 0:
            np.testing.assert_array_equal(gstate.ps_weight.numpy(),
                                          np.ones(WORLD, np.float32))


def test_average_lands_irregular_mixing_on_the_true_mean():
    """Irregular mixing moves the push-sum weight off 1; the every-k
    average still lands every rank on the initial mean (lr 0) and resets
    the weight to 1."""
    alphas = 0.2 + 0.6 * np.arange(WORLD) / (WORLD - 1)
    schedule = build_schedule(NPeerDynamicDirectedExponentialGraph(
        WORLD, peers_per_itr=1), SelfWeightedMixing(alpha=alphas))
    x0, _ = _data(7)
    alg = _port_alg(False, 1, 1, schedule=schedule, global_avg_every=4)
    params = {"w": torch.from_numpy(x0.copy())}
    gstate = alg.init(params)
    zero = {"w": torch.zeros(WORLD, DIM)}
    for t in range(4):
        params, gstate = _port_step(alg, lr=0.0)(params, gstate, zero)
        if t < 3:
            assert not torch.equal(gstate.ps_weight, torch.ones(WORLD))
    np.testing.assert_allclose(params["w"].numpy(),
                               np.broadcast_to(x0.mean(0), x0.shape),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(gstate.ps_weight.numpy(), np.ones(WORLD))


@pytest.mark.parametrize("lane", ["plain", "kernel"])
def test_overlap_average_folds_the_fifo_exactly_once(lane):
    """OSGP at staleness 2 with an average every 3 steps and lr 0: the
    average lands every rank on the initial mean (each in-flight share
    counted once), leaves the FIFO as zero slots and the weight at 1,
    and the drained view keeps that mean through later rounds."""
    x0, _ = _data(9)
    kernel = KernelLane(interpret=True, chunk_elems=8) \
        if lane == "kernel" else None
    alg = _port_alg(True, 2, 1, kernel=kernel, peers=2, global_avg_every=3)
    params = {"w": torch.from_numpy(x0.copy())}
    gstate = alg.init(params)
    zero = {"w": torch.zeros(WORLD, DIM)}
    step = _port_step(alg, lr=0.0)
    mean = x0.astype(np.float64).mean(0)
    for t in range(5):
        params, gstate = step(params, gstate, zero)
        if t == 1:   # two shares in flight before the average
            assert any(w.any() for _, w in gstate.in_flight)
        if t == 2:
            np.testing.assert_allclose(
                params["w"].numpy(), np.broadcast_to(mean, x0.shape),
                rtol=0, atol=1e-6)
            np.testing.assert_array_equal(gstate.ps_weight.numpy(),
                                          np.ones(WORLD))
            for p, w in gstate.in_flight:
                assert not w.any() and not p["w"].any()
    view = alg.val_params(params, gstate)["w"].numpy()
    np.testing.assert_allclose(view.mean(0), mean, rtol=0, atol=1e-6)
    total = params["w"].sum(0) + sum(p["w"].sum(0)
                                     for p, _ in gstate.in_flight)
    weight = gstate.ps_weight.sum() + sum(w.sum()
                                          for _, w in gstate.in_flight)
    np.testing.assert_allclose((total / weight).numpy(), mean, rtol=0,
                               atol=1e-6)


def test_invalid_thinning_options_raise():
    schedule = build_schedule(NPeerDynamicDirectedExponentialGraph(WORLD))
    with pytest.raises(ValueError, match="gossip_every"):
        talg.sgp(schedule, StackedTransport(WORLD), gossip_every=0)
    with pytest.raises(ValueError, match="global_avg_every"):
        talg.sgp(schedule, StackedTransport(WORLD), global_avg_every=-1)


SMALL = ["--device", "cpu", "--vocab_size", "256", "--d_model", "32",
         "--n_layers", "2", "--n_heads", "1", "--d_ff", "64",
         "--seq_len", "32", "--batch_size", "2", "--num_steps", "4",
         "--print_freq", "1", "--corpus_tokens", "4000", "--world_size", "4"]


@pytest.mark.parametrize("extra", [
    ["--gossip_every", "2", "--global_avg_every", "3"],
    ["--gossip_every", "3", "--overlap", "True", "--staleness", "2",
     "--global_avg_every", "2"],
])
def test_cli_takes_thinning_and_averaging_flags(extra, capsys, tmp_path):
    result = gossip_lm.main(SMALL + extra
                            + ["--checkpoint_dir", str(tmp_path)])
    assert math.isfinite(result["final_loss"])
    rows = capsys.readouterr().out.splitlines()
    assert "step,loss,ppl,lr,tokens_per_sec,grad_norm" in rows


@pytest.mark.parametrize("argv,match", [
    (["--gossip_every", "0"], "--gossip_every must be >= 1"),
    (["--global_avg_every", "-2"], "--global_avg_every must be >= 0"),
    (["--all_reduce", "True", "--gossip_every", "2"], "--gossip_every"),
])
def test_cli_rejects_bad_thinning_flags(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        gossip_lm.main(SMALL + argv + ["--checkpoint_dir", str(tmp_path)])
