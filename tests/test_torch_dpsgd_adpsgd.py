"""Port parity: D-PSGD (``PushPullGossip``, ``mix_push_pull``) and
synchronous AD-PSGD (``BilateralGossip``, ``mix_bilat``,
``build_pairing_schedule``) of ``stochastic_gradient_push_torch``
against the reference on the same numpy inputs, on the CPU.

* Pairing tables bit-equal (values and dtype) for graphs 0–5 at worlds
  2, 4, 6 and 8, and the same errors (type and message): odd world, a
  non-bipartite graph with no usable hop distance, ``supports_pairing``
  off.
* ``mix_push_pull`` rounds bit-equal to ``jax.jit`` of the reference's
  round on the plain lane; on the kernel lane (``KernelLane(interpret=
  True)``, K1/K2's plain twins) within 1e-6 (the lane rounds the local
  share on its own); an irregular schedule refused with the reference's
  message.  ``mix_bilat`` rounds bit-equal (``(a + b) * 0.5`` is exact
  in fp32, and in bf16 rounds once as the reference does).
* D-PSGD (sync, overlap at staleness 1 and 2, plain and kernel lane) and
  AD-PSGD steps of SGD on a quadratic against the reference's compiled
  step: the push-sum weight (the overlap lane's) and the phase exact,
  params within 1e-6 (XLA contracts ``p - lr * g`` into one rounding,
  the port takes two).
* D-PSGD with ``global_avg_every`` against a numpy oracle within 1e-5:
  the reference's periodic average raises on this jax (``ROADMAP.md``
  Queue 3), so its side is not run.
* ``mix_bilat`` under ``torch.distributed`` (gloo, one rank a process)
  at world 2 and 4 equal, bit for bit, to the stacked lane.
* The LM CLI trains with ``--push_sum False`` and ``--bilat True``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.run import gossip_lm
from torch_launch import spawn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.1
DIM = 6
PARAM_ATOL = 1e-6


def _ref():
    from stochastic_gradient_push_tpu import topology as rt
    return rt


def _outcome(fn):
    try:
        return "ok", fn()
    except (ValueError, AssertionError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("world", [2, 4, 6, 8])
@pytest.mark.parametrize("graph", range(6))
def test_pairing_tables_bit_equal_reference(graph, world):
    rt = _ref()
    want = _outcome(lambda: rt.build_pairing_schedule(
        rt.GRAPH_TOPOLOGIES[graph](world)))
    got = _outcome(lambda: tt.build_pairing_schedule(
        tt.GRAPH_TOPOLOGIES[graph](world)))
    assert got[0] == want[0], (got, want)
    if want[0] != "ok":
        assert got[1] == want[1]
        return
    assert got[1].dtype == want[1].dtype == np.int32
    np.testing.assert_array_equal(got[1], want[1])
    for row in got[1]:
        np.testing.assert_array_equal(row[row], np.arange(world))


class _Graph:
    """A duck-typed graph: the fields build_pairing_schedule reads."""

    def __init__(self, world, book, pairing=True):
        self.world_size = world
        self.phone_book = [book]
        self.supports_pairing = pairing

    def is_bipartite_graph(self):
        return False


@pytest.mark.parametrize("case", ["odd_world", "no_hop_distance",
                                  "unsupported"])
def test_pairing_errors_match_reference(case):
    rt = _ref()
    if case == "odd_world":
        graphs = (rt.GRAPH_TOPOLOGIES[0](5), tt.GRAPH_TOPOLOGIES[0](5))
    elif case == "no_hop_distance":
        graphs = (_Graph(6, [2]), _Graph(6, [2]))
    else:
        graphs = (_Graph(4, [1], pairing=False),
                  _Graph(4, [1], pairing=False))
    want = _outcome(lambda: rt.build_pairing_schedule(graphs[0]))
    got = _outcome(lambda: tt.build_pairing_schedule(graphs[1]))
    assert want[0] == "ValueError"
    assert got == want


def test_pairing_at_world_one():
    assert tt.build_pairing_schedule(
        tt.RingGraph(1)).tolist() == [[0]]


def _params(world, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((world, 6, 50)).astype(dtype),
            "b": r.standard_normal((world, 130)).astype(dtype),
            "one": r.standard_normal((world, 1)).astype(dtype)}


def _mesh(world):
    from stochastic_gradient_push_tpu.parallel.mesh import make_gossip_mesh
    return make_gossip_mesh(world)


@pytest.mark.parametrize("lane", ["plain", "kernel"])
@pytest.mark.parametrize("world,ppi", [(4, 1), (8, 1), (8, 2)])
def test_push_pull_rounds_match_reference(world, ppi, lane):
    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_pull)
    from stochastic_gradient_push_tpu.parallel.mesh import GOSSIP_AXIS

    rt = _ref()
    jsched = rt.build_schedule(rt.NPeerDynamicDirectedExponentialGraph(
        world, peers_per_itr=ppi))
    tsched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(
        world, peers_per_itr=ppi))

    def jround(phase):
        return jax.jit(jax.shard_map(
            lambda p: mix_push_pull(p, jnp.int32(phase), jsched,
                                    GOSSIP_AXIS),
            mesh=_mesh(world), in_specs=(P(GOSSIP_AXIS),),
            out_specs=P(GOSSIP_AXIS)))

    kernel = (KernelLane(interpret=True, chunk_elems=64)
              if lane == "kernel" else None)
    jp = _params(world, seed=world + ppi)
    tp = {n: torch.from_numpy(a.copy()) for n, a in jp.items()}
    transport = tc.StackedTransport(world)
    for phase in range(5):
        jp = jax.device_get(jround(phase)(jp))
        tp = tc.mix_push_pull(tp, phase, tsched, transport, kernel=kernel,
                              buckets=2)
        for n in jp:
            if kernel is None:
                np.testing.assert_array_equal(tp[n].numpy(), jp[n],
                                              err_msg=f"{n} phase {phase}")
            else:
                np.testing.assert_allclose(tp[n].numpy(), jp[n], rtol=0,
                                           atol=PARAM_ATOL)
    # doubly stochastic: the rank mean is kept
    base = _params(world, seed=world + ppi)
    for n in base:
        np.testing.assert_allclose(tp[n].numpy().mean(0), base[n].mean(0),
                                   rtol=0, atol=1e-5)


def test_push_pull_and_dpsgd_refuse_what_the_reference_refuses():
    from stochastic_gradient_push_tpu.algorithms import dpsgd as jdpsgd
    from stochastic_gradient_push_tpu.parallel.collectives import (
        mix_push_pull)

    rt = _ref()
    mixing = np.linspace(0.3, 0.7, 4)
    jsched = rt.build_schedule(rt.RingGraph(4), rt.SelfWeightedMixing(mixing))
    tsched = tt.build_schedule(tt.RingGraph(4), tt.SelfWeightedMixing(mixing))
    assert not tsched.regular
    transport = tc.StackedTransport(4)
    for ref_call, port_call in (
            (lambda: mix_push_pull({}, 0, jsched, "gossip"),
             lambda: tc.mix_push_pull({}, 0, tsched, transport)),
            (lambda: jdpsgd(jsched, "gossip"),
             lambda: talg.dpsgd(tsched, transport))):
        want, got = _outcome(ref_call), _outcome(port_call)
        assert want[0] == "ValueError" and got == want
    regular = tt.build_schedule(tt.RingGraph(4))
    with pytest.raises(ValueError, match="inject_faults requires push-sum"):
        talg.dpsgd(regular, tc.StackedTransport(4), faults=object())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("graph,world,ppi", [(1, 4, 1), (1, 8, 2), (0, 8, 1),
                                             (5, 4, 1), (3, 6, 1)])
def test_bilat_rounds_bit_equal_reference(graph, world, ppi, dtype):
    from stochastic_gradient_push_tpu.parallel.collectives import mix_bilat
    from stochastic_gradient_push_tpu.parallel.mesh import GOSSIP_AXIS

    rt = _ref()
    jpair = rt.build_pairing_schedule(rt.GRAPH_TOPOLOGIES[graph](
        world, peers_per_itr=ppi))
    tpair = tt.build_pairing_schedule(tt.GRAPH_TOPOLOGIES[graph](
        world, peers_per_itr=ppi))
    np.testing.assert_array_equal(tpair, jpair)

    def jround(phase):
        return jax.jit(jax.shard_map(
            lambda p: mix_bilat(p, jnp.int32(phase), jpair, GOSSIP_AXIS),
            mesh=_mesh(world), in_specs=(P(GOSSIP_AXIS),),
            out_specs=P(GOSSIP_AXIS)))

    base = _params(world, seed=graph + world)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {n: jnp.asarray(a, jdt) for n, a in base.items()}
    tp = {n: torch.from_numpy(a.copy()).to(tdt) for n, a in base.items()}
    transport = tc.StackedTransport(world)
    for phase in range(len(jpair) + 1):
        jp = jround(phase)(jp)
        tp = tc.mix_bilat(tp, phase, tpair, transport)
        for n in base:
            assert tp[n].dtype == tdt
            np.testing.assert_array_equal(
                tp[n].float().numpy(), np.asarray(jp[n], np.float32),
                err_msg=f"{n} phase {phase}")


def test_bilat_world_checks():
    pairing = tt.build_pairing_schedule(tt.RingGraph(4))
    with pytest.raises(ValueError, match="pairing was built for world_size=4"):
        tc.mix_bilat({}, 0, pairing, tc.StackedTransport(2))
    params = {"w": torch.ones(1, 3)}
    assert tc.mix_bilat(params, 3, tt.build_pairing_schedule(
        tt.RingGraph(1)), tc.StackedTransport(1)) is params


def _jax_alg(kind, world, overlap=False, staleness=1, graph=5):
    from stochastic_gradient_push_tpu.algorithms import adpsgd, dpsgd
    from stochastic_gradient_push_tpu.parallel import GOSSIP_AXIS

    rt = _ref()
    g = rt.GRAPH_TOPOLOGIES[graph](world)
    if kind == "adpsgd":
        return adpsgd(rt.build_pairing_schedule(g), GOSSIP_AXIS)
    return dpsgd(rt.build_schedule(g), GOSSIP_AXIS, overlap=overlap,
                 staleness=staleness)


def _port_alg(kind, world, overlap=False, staleness=1, graph=5,
              kernel=None, global_avg_every=0):
    g = tt.GRAPH_TOPOLOGIES[graph](world)
    transport = tc.StackedTransport(world)
    if kind == "adpsgd":
        return talg.adpsgd(tt.build_pairing_schedule(g), transport)
    return talg.dpsgd(tt.build_schedule(g), transport, overlap=overlap,
                      staleness=staleness, gossip_kernel=kernel,
                      gossip_buckets=2 if kernel else 1,
                      global_avg_every=global_avg_every)


def _jax_trajectory(alg, world, x0, targets, steps):
    """Per step ``(params, ps_weight, fifo, phase)`` of the reference's
    compiled SGD-on-a-quadratic step, as numpy."""
    from stochastic_gradient_push_tpu.parallel import GOSSIP_AXIS

    def step(params, gstate, target):
        params, gstate = alg.pre_step(params, gstate)
        z = alg.eval_params(params, gstate)
        g = jax.tree.map(lambda a, t: a - t, z, target)
        return alg.post_step(
            jax.tree.map(lambda a, b: a - LR * b, params, g), gstate)

    f = jax.jit(jax.shard_map(
        step, mesh=_mesh(world), in_specs=(P(GOSSIP_AXIS),) * 3,
        out_specs=(P(GOSSIP_AXIS), P(GOSSIP_AXIS))))
    gstate = jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a),
                                  (world,) + np.shape(a)).copy(),
        alg.init({"w": jnp.zeros((DIM,), jnp.float32)}))
    params, out = {"w": x0}, []
    for _ in range(steps):
        params, gstate = jax.block_until_ready(
            f(params, gstate, {"w": targets}))
        fifo = [(np.asarray(p["w"]), np.asarray(w).reshape(world))
                for p, w in gstate.in_flight or ()]
        out.append((np.asarray(params["w"]),
                    np.asarray(gstate.ps_weight).reshape(world), fifo,
                    int(np.asarray(gstate.phase).reshape(-1)[0])))
    return out


def _port_step(alg):
    def step(params, gstate, target):
        params, gstate = alg.pre_step(params, gstate)
        z = alg.eval_params(params, gstate)
        params = {n: p - LR * (z[n] - target[n]) for n, p in params.items()}
        return alg.post_step(params, gstate)

    return step


def _data(world, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(world, DIM)).astype(np.float32),
            rng.normal(size=(world, DIM)).astype(np.float32))


@pytest.mark.parametrize("kind,overlap,staleness,lane,graph", [
    ("dpsgd", False, 1, "plain", 5), ("dpsgd", False, 1, "kernel", 5),
    ("dpsgd", True, 1, "plain", 5), ("dpsgd", True, 2, "plain", 0),
    ("dpsgd", True, 2, "kernel", 5), ("adpsgd", False, 1, "plain", 1),
    ("adpsgd", False, 1, "plain", 0),
])
def test_steps_match_reference(kind, overlap, staleness, lane, graph):
    world, steps = 4, 7
    x0, targets = _data(world, seed=staleness + 3 * overlap + graph)
    want = _jax_trajectory(_jax_alg(kind, world, overlap, staleness, graph),
                           world, x0, targets, steps)
    kernel = KernelLane(interpret=True, chunk_elems=8) \
        if lane == "kernel" else None
    alg = _port_alg(kind, world, overlap, staleness, graph, kernel=kernel)
    assert alg.name == kind
    if kind == "dpsgd":
        assert alg.track_weight == overlap
    params = {"w": torch.from_numpy(x0.copy())}
    gstate = alg.init(params)
    step = _port_step(alg)
    target = {"w": torch.from_numpy(targets)}
    for t, (w_params, w_weight, w_fifo, w_phase) in enumerate(want):
        params, gstate = step(params, gstate, target)
        assert gstate.phase == w_phase
        np.testing.assert_array_equal(gstate.ps_weight.numpy(), w_weight,
                                      err_msg=f"step {t}")
        np.testing.assert_allclose(params["w"].numpy(), w_params, rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"step {t}")
        assert len(gstate.in_flight) == len(w_fifo)
        for (p, w), (wp, ww) in zip(gstate.in_flight, w_fifo):
            np.testing.assert_array_equal(w.numpy(), ww)
            np.testing.assert_allclose(p["w"].numpy(), wp, rtol=0,
                                       atol=PARAM_ATOL)
    if kind == "dpsgd" and not overlap:
        # sync D-PSGD never mixes (or divides by) a weight
        assert torch.equal(gstate.ps_weight, torch.ones(world))
        z = alg.eval_params(params, gstate)
        assert z["w"] is params["w"]


@pytest.mark.parametrize("overlap,staleness", [(False, 1), (True, 2)])
def test_dpsgd_global_average_matches_numpy_oracle(overlap, staleness):
    world, steps, every = 4, 9, 3
    x0, targets = _data(world, seed=11)
    alg = _port_alg("dpsgd", world, overlap, staleness, graph=5,
                    global_avg_every=every)
    sched = alg.schedule
    params = {"w": torch.from_numpy(x0.copy())}
    gstate = alg.init(params)
    step = _port_step(alg)
    target = {"w": torch.from_numpy(targets)}
    # numpy oracle: x <- W x after the SGD step (sync) or, under overlap,
    # the share launched at step t lands at the end of step
    # t + staleness - 1; every `every` steps the true mean (FIFO folded)
    x = x0.astype(np.float64)
    w = np.ones(world)
    fifo = [(np.zeros_like(x), np.zeros(world)) for _ in range(staleness)]
    for t in range(steps):
        mix = sched.mixing_matrix(t)
        if overlap:
            lo = np.diag(mix)
            inc = (mix - np.diag(lo)) @ x, (mix - np.diag(lo)) @ w
            x, w = lo[:, None] * x, lo * w
            fifo = fifo[:-1] + [inc]
        z = x / w[:, None]
        x = x - LR * (z - targets)
        if overlap:
            x, w = x + fifo[0][0], w + fifo[0][1]
            fifo = fifo[1:] + [(np.zeros_like(x), np.zeros(world))]
        else:
            x = mix @ x
        if (t + 1) % every == 0:
            tot_x = x.sum(0) + sum(f[0].sum(0) for f in fifo)
            tot_w = w.sum() + sum(f[1].sum() for f in fifo)
            x = np.broadcast_to(tot_x / tot_w, x.shape).copy()
            w = np.ones(world)
            fifo = [(np.zeros_like(x), np.zeros(world)) for _ in fifo]
        params, gstate = step(params, gstate, target)
        np.testing.assert_allclose(params["w"].numpy(), x, rtol=0,
                                   atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(gstate.ps_weight.numpy(), w, rtol=0,
                                   atol=1e-6)
    # the last step averaged: every rank equal, weight exactly 1
    assert torch.equal(gstate.ps_weight, torch.ones(world))
    assert torch.equal(params["w"], params["w"][:1].expand_as(params["w"]))


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch import topology as tt
rank, port, out, world = (int(sys.argv[2]), sys.argv[3], sys.argv[4],
                          int(sys.argv[6]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
data = np.load(sys.argv[5])
params = {n: torch.from_numpy(data[n][rank:rank + 1].copy())
          for n in ("w", "b", "one")}
pairing = tt.build_pairing_schedule(
    tt.DynamicBipartiteExponentialGraph(world))
transport = tc.DistTransport()
for phase in range(5):
    params = tc.mix_bilat(params, phase, pairing, transport)
np.savez(out, **{n: p.numpy() for n, p in params.items()})
dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_bilat_dist_lane_equals_stacked_lane_over_gloo(tmp_path, world):
    params = _params(world, seed=world)
    data = tmp_path / "state.npz"
    np.savez(data, **params)
    spawn(world, lambda r, port: [
        sys.executable, "-c", _WORKER, REPO, str(r), str(port),
        str(tmp_path / f"rank{r}.npz"), str(data), str(world)], timeout=120,
        PYTHONPATH=REPO)

    pairing = tt.build_pairing_schedule(
        tt.DynamicBipartiteExponentialGraph(world))
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    for phase in range(5):
        tp = tc.mix_bilat(tp, phase, pairing, tc.StackedTransport(world))
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        for n in params:
            np.testing.assert_array_equal(got[n], tp[n].numpy()[r:r + 1])


SMALL_LM = ["--device", "cpu", "--vocab_size", "256", "--d_model", "32",
            "--n_layers", "2", "--n_heads", "1", "--d_ff", "64",
            "--seq_len", "32", "--batch_size", "2", "--num_steps", "3",
            "--print_freq", "1", "--corpus_tokens", "4000",
            "--world_size", "4"]


@pytest.mark.parametrize("extra,name", [
    (["--push_sum", "False"], "dpsgd"),
    (["--push_sum", "False", "--overlap", "True", "--staleness", "2",
      "--gossip_kernel", "auto"], "dpsgd"),
    (["--bilat", "True", "--graph_type", "1"], "adpsgd"),
    (["--bilat", "True", "--graph_type", "0"], "adpsgd"),
])
def test_lm_cli_trains_dpsgd_and_adpsgd(extra, name, capsys, tmp_path):
    result = gossip_lm.main(SMALL_LM + extra
                            + ["--checkpoint_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"algorithm={name}" in out
    assert 4.5 < result["final_loss"] < 7.0


@pytest.mark.parametrize("extra", [
    ["--push_sum", "False", "--wire_dtype", "int8"],
    ["--bilat", "True", "--gossip_every", "2"],
])
def test_lm_cli_refuses_push_sum_knobs_off_push_sum(extra, tmp_path):
    with pytest.raises(SystemExit, match="push-sum knobs"):
        gossip_lm.main(SMALL_LM + extra
                       + ["--checkpoint_dir", str(tmp_path)])
