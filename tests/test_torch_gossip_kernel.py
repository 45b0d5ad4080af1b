"""Port parity: the gossip transport (``stochastic_gradient_push_torch.ops.
gossip_kernel``) and the kernel lane of the push-sum round against the
JAX package's ``ops/gossip_kernel.py`` and its XLA lane.

* ``_chunk_layout`` equal to the reference's over a grid of payload
  sizes, int8 blocks and chunk targets; ``_transport_plan`` equal for 1
  and 3 buckets.
* K2's plain twin equals the numpy permutation of the reference's
  chunked parts (the reference's start kernel needs
  ``pltpu.TPUCompilerParams``, which this jax lacks).
* K1's plain twin is bit-equal to the reference's ``gossip_edge_wait``
  in Pallas interpret mode: f32, bf16 and int8 (block 7 and 64), one
  and two edges, ragged tails.
* Whole rounds at world 8, from one numpy state: sync SGP and OSGP
  (staleness 1 and 2), 1 and 3 buckets, every wire, one and two peers —
  the port's kernel lane (``KernelLane(interpret=True)``) against the
  reference's XLA lane: the push-sum weight trajectory bit-identical,
  params within 1e-6 (the local share is rounded on its own on the
  kernel lane; the XLA lane fuses it into an FMA).  The port's plain
  lane is held to the same bounds.  Against the reference's own kernel
  lane too, where this jax can run its start kernel.
* Resolver and lane contracts: ``pallas`` without a card raises
  ``KernelBackendError``, a non-interpret lane handed CPU tensors raises
  ``KernelLaneError``, dests must be permutations, the kernel lane on a
  transport that is neither the stacked nor the cross-process one is
  refused naming both (``tests/test_torch_gossip_kernel_dist.py`` runs
  the cross-process lane).

Every world-8 reference program runs serialized (each call drained
before the next).
"""

import itertools

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch import algorithms as talg
from stochastic_gradient_push_torch import topology as tt
from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
from stochastic_gradient_push_torch.ops.lanes import KernelLaneError
from stochastic_gradient_push_torch.parallel import collectives as tc
from stochastic_gradient_push_torch.parallel import wire as tw

torch.set_num_threads(1)

WORLD = 8
ROUNDS = 4
PARAM_ATOL = 1e-6


def _ref_gk():
    from stochastic_gradient_push_tpu.ops import gossip_kernel as rgk
    return rgk


def _ref_can_start():
    from jax.experimental.pallas import tpu as pltpu
    return hasattr(pltpu, "TPUCompilerParams")


# -- layout and plan --------------------------------------------------------


@pytest.mark.parametrize("n,block,chunk", list(itertools.product(
    [1, 3, 33, 64, 300, 4097, 70_000, 3_000_001],
    [None, 7, 64],
    [1, 128, 64 * 1024, 1 << 30])))
def test_chunk_layout_matches_reference(n, block, chunk):
    assert tgk._chunk_layout(n, block, chunk) == \
        _ref_gk()._chunk_layout(n, block, chunk)


def test_chunk_layout_rejects_what_the_reference_rejects():
    for bad in (0, -1):
        with pytest.raises(ValueError, match="ppermute lane"):
            tgk._chunk_layout(bad, None, 128)
    with pytest.raises(ValueError, match="chunk_elems"):
        tgk._chunk_layout(16, None, 0)


_LEAF_SETS = {
    "lm": [(24, 16), (16,), (16,), (64, 16), (64,), (16, 64), (1,)],
    "ragged": [(6, 50), (130,), (1,), (7,), (3, 3), (1000,)],
    "mixed_dtype": [(40,), (30,), (20,), (1,)],
}


@pytest.mark.parametrize("leafset", sorted(_LEAF_SETS))
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("buckets", [1, 3])
def test_transport_plan_matches_reference(leafset, wire, buckets):
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.parallel import collectives as rc
    from stochastic_gradient_push_tpu.parallel import wire as rw

    shapes = _LEAF_SETS[leafset]
    dt = [np.float32] * len(shapes)
    if leafset == "mixed_dtype":
        dt[1] = np.float16
    ref_leaves = [jnp.zeros(s, d) for s, d in zip(shapes, dt)]
    port_leaves = [torch.zeros((2,) + s, dtype=torch.from_numpy(
        np.zeros(1, d)).dtype) for s, d in zip(shapes, dt)]
    rspec = rw.get_codec(wire, 7).kernel_spec()
    tspec = tw.get_codec(wire, 7).kernel_spec()
    assert tspec == tw.DecodeSpec(rspec.kind, rspec.block)
    assert tc._transport_plan(port_leaves, tspec, buckets) == \
        rc._transport_plan(ref_leaves, rspec, buckets)


def test_codec_specs_and_bytes_match_reference():
    from stochastic_gradient_push_tpu.parallel import wire as rw

    for name in ("f32", "bf16", "int8"):
        r, t = rw.get_codec(name, 32), tw.get_codec(name, 32)
        assert (t.kernel_spec().kind, t.kernel_spec().block) == \
            (r.kernel_spec().kind, r.kernel_spec().block)
        for n in (1, 31, 32, 1000):
            assert t.element_bytes(n) == r.element_bytes(n)

    class Opaque(tw.WireCodec):
        name, lossy = "opaque", True

    assert Opaque().kernel_spec() is None


# -- the two kernels' plain twins --------------------------------------------


def _random_handle_parts(kind, block, ranks, ne, n, chunk, seed):
    """Landed chunked buffers ``[R, E, ...]`` for a payload of ``n``."""
    r = np.random.default_rng(seed)
    rows, c, nb = tgk._chunk_layout(n, block if kind == "int8" else None,
                                    chunk)
    if kind == "int8":
        q = r.integers(-127, 128, size=(ranks, ne, nb, rows, block),
                       dtype=np.int8)
        s = (r.random((ranks, ne, nb, rows)) * 0.02).astype(np.float32)
        return (q, s), (rows, c, nb)
    x = r.standard_normal((ranks, ne, nb, c)).astype(np.float32)
    if kind == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return (x,), (rows, c, nb)


def _torch_parts(kind, parts):
    out = tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in parts)
    if kind == "bf16":
        out = (out[0].to(torch.bfloat16),)
    return out


@pytest.mark.parametrize("kind,block", [("f32", None), ("bf16", None),
                                        ("int8", 7), ("int8", 64)])
@pytest.mark.parametrize("ne", [1, 2])
@pytest.mark.parametrize("n,chunk", [(300, 128), (33, 1 << 30), (256, 64)])
def test_wait_twin_bit_equal_reference_interpret_kernel(kind, block, ne, n,
                                                        chunk):
    import jax.numpy as jnp

    rgk = _ref_gk()
    parts, (rows, c, nb) = _random_handle_parts(kind, block, 1, ne, n, chunk,
                                                seed=n + ne)
    acc = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    ref_recv = tuple(jnp.asarray(p[0]) for p in parts)
    if kind == "bf16":
        ref_recv = (ref_recv[0].astype(jnp.bfloat16),)
    ref = np.asarray(rgk.gossip_edge_wait(
        rgk.TransportHandle(recv=ref_recv,
                            meta=(kind, n, rows, c, nb, ne, True)),
        jnp.asarray(acc)))
    handle = tgk.TransportHandle(recv=_torch_parts(kind, parts),
                                 meta=(kind, n, rows, c, nb, ne, True))
    got = tgk.gossip_edge_wait(handle, torch.from_numpy(acc[None].copy()))
    # decode_edges folded in order is the twin's sum exactly
    dec = handle.decode_edges()
    fold = torch.from_numpy(acc[None].copy())
    for e in range(ne):
        fold = fold + dec[:, e]
    np.testing.assert_array_equal(got.numpy(), fold.numpy())
    if kind == "int8" and nb * ne == 1:
        # a one-step grid: XLA on the CPU compiles the interpreted
        # kernel without its loop and contracts acc + q * scale into one
        # FMA, which the TPU kernel (and every multi-step grid here)
        # does not; the twin keeps the kernel's two roundings
        q, scale = (p.reshape(-1, block if i == 0 else 1)
                    for i, p in enumerate(parts))
        fused = acc + (q.astype(np.float64) * scale).reshape(-1)[:n]
        np.testing.assert_array_equal(ref, fused.astype(np.float32))
        twice = acc + (q.astype(np.float32) * scale).reshape(-1)[:n]
        np.testing.assert_array_equal(got[0].numpy(), twice)
    else:
        np.testing.assert_array_equal(got[0].numpy(), ref)


@pytest.mark.parametrize("kind,block", [("f32", None), ("bf16", None),
                                        ("int8", 7), ("int8", 64)])
@pytest.mark.parametrize("ne", [1, 2])
def test_start_twin_is_the_numpy_permutation_of_reference_chunks(kind, block,
                                                                 ne):
    """The reference's chunking (``_chunk_layout`` + ``_pad_rows`` of each
    rank's encoded parts) permuted with numpy is what the port's start
    lands, byte for byte."""
    import jax.numpy as jnp

    rgk = _ref_gk()
    n, chunk = 300, 128
    r = np.random.default_rng(ne)
    x = r.standard_normal((WORLD, ne, n)).astype(np.float32)
    dests = np.stack([np.roll(np.arange(WORLD), 1 + 2 * e)
                      for e in range(ne)])
    codec = tw.get_codec(kind, block or 64)
    spec = codec.kernel_spec()
    rows, c, nb = rgk._chunk_layout(n, block, chunk)
    enc = [codec.encode(torch.from_numpy(x[:, e])) for e in range(ne)]
    parts = tuple(torch.stack([enc[e][i] for e in range(ne)], dim=1)
                  for i in range(len(enc[0])))
    handle = tgk.gossip_edge_start(parts, dests, spec, n_decoded=n,
                                   interpret=True, chunk_elems=chunk)
    for i, landed in enumerate(handle.recv):
        src = parts[i].float().numpy() if kind == "bf16" else parts[i].numpy()
        want = np.empty((WORLD, ne) + landed.shape[2:], src.dtype)
        for rank in range(WORLD):
            for e in range(ne):
                chunked = np.asarray(rgk._pad_rows(
                    jnp.asarray(src[rank, e]), nb * rows if i or
                    kind == "int8" else nb * c))
                want[dests[e, rank], e] = chunked.reshape(landed.shape[2:])
        got = landed.float().numpy() if kind == "bf16" else landed.numpy()
        np.testing.assert_array_equal(got, want)
    assert handle.meta == (kind, n, rows, c, nb, ne, True)
    # the landed handle waits to its decoded edges, folded in order
    acc = torch.zeros(WORLD, n)
    folded = acc
    for e in range(ne):
        folded = folded + handle.decode_edges()[:, e]
    assert torch.equal(tgk.gossip_edge_wait(handle, acc), folded)


def test_empty_handle_waits_to_the_identity():
    acc = torch.randn(3, 300)
    for spec in (tw.F32.kernel_spec(), tw.BF16.kernel_spec(),
                 tw.Int8Codec(7).kernel_spec()):
        h = tgk.empty_transport_handle(spec, 300, 2, 3, interpret=True,
                                       chunk_elems=128)
        assert torch.equal(tgk.gossip_edge_wait(h, acc), acc)


def test_axpy_is_start_then_wait_and_equals_the_plain_round():
    """One f32 edge through the kernel lane's twins equals the plain
    permutation plus the accumulator."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((WORLD, 300)).astype(np.float32))
    acc = x * 0.25
    dests = np.roll(np.arange(WORLD), 3)
    out = tgk.gossip_edge_axpy(acc, (x[:, None],), dests,
                               tw.F32.kernel_spec(), interpret=True,
                               chunk_elems=128)
    want = acc + tc.StackedTransport(WORLD).permute(x, dests)
    assert torch.equal(out, want)


# -- resolver and lane contracts ---------------------------------------------


def test_resolver_contract():
    assert tgk.resolve_gossip_kernel(None) is None
    assert tgk.resolve_gossip_kernel("xla") is None
    lane = tgk.resolve_gossip_kernel("auto", interpret=True)
    assert isinstance(lane, tgk.KernelLane) and lane.interpret
    assert lane.name == "pallas"
    assert lane.chunk_elems == tgk.DEFAULT_CHUNK_ELEMS
    assert tgk.resolve_gossip_kernel(lane) is lane
    assert tgk.resolve_gossip_kernel("auto", device="cpu") is None
    assert tgk.resolve_gossip_kernel("pallas", interpret=True) is not None
    with pytest.raises(tgk.KernelBackendError, match="CUDA device"):
        tgk.resolve_gossip_kernel("pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown gossip_kernel"):
        tgk.resolve_gossip_kernel("mosaic")


def test_pallas_without_a_card_raises_the_typed_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present: pallas resolves to the kernels")
    with pytest.raises(tgk.KernelBackendError):
        tgk.resolve_gossip_kernel("pallas")
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(4))
    with pytest.raises(tgk.KernelBackendError):
        talg.sgp(sched, tc.StackedTransport(4), gossip_kernel="pallas")
    assert talg.sgp(sched, tc.StackedTransport(4),
                    gossip_kernel="auto").gossip_kernel is None


def test_kernel_lane_refuses_cpu_tensors_and_bad_tables():
    x = torch.zeros(4, 1, 300)
    dests = np.roll(np.arange(4), 1)
    acc = x[:, 0]
    with pytest.raises(KernelLaneError, match="CUDA tensors only"):
        tgk.gossip_edge_wait(
            tgk.gossip_edge_start((x,), dests, tw.F32.kernel_spec()), acc)
    h = tgk.empty_transport_handle(tw.F32.kernel_spec(), 300, 1, 4)
    with pytest.raises(KernelLaneError, match="CUDA tensors only"):
        tgk.gossip_edge_wait(h, torch.zeros(4, 300))
    with pytest.raises(ValueError, match="permutation"):
        tgk.gossip_edge_wait(tgk.gossip_edge_start(
            (x,), [1, 1, 2, 3], tw.F32.kernel_spec(), interpret=True), acc)
    with pytest.raises(ValueError, match="no in-kernel decode"):
        tgk.gossip_edge_wait(tgk.gossip_edge_start(
            (x,), dests, None, interpret=True), acc)


def test_transport_kernel_name_reports_the_lane_that_runs():
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(4))
    lane = tgk.KernelLane(interpret=True)
    st = tc.StackedTransport(4)
    assert talg.sgp(sched, st).transport_kernel_name == "xla"
    assert talg.sgp(sched, st, gossip_kernel=lane).transport_kernel_name \
        == "pallas"
    over = talg.osgp(sched, st, staleness=2, gossip_kernel=lane)
    assert over.transport_kernel_name == "pallas" and over.overlap

    class Opaque(tw.WireCodec):
        name, lossy = "opaque", True

    assert talg.sgp(sched, st, gossip_kernel=lane,
                    wire=Opaque()).transport_kernel_name == "xla"
    with pytest.raises(ValueError, match="staleness"):
        talg.sgp(sched, st, staleness=2)
    with pytest.raises(ValueError, match="gossip_buckets"):
        talg.sgp(sched, st, gossip_buckets=0)


def test_kernel_lane_under_dist_transport_is_refused_by_name():
    class FakeDist:   # neither the stacked nor the cross-process transport
        world_size, ranks = 4, np.array([0])

    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(4))
    with pytest.raises(TypeError, match="stacked transport or the "
                                        "cross-process one.*FakeDist"):
        talg.sgp(sched, FakeDist(), gossip_kernel=tgk.KernelLane(True))
    with pytest.raises(TypeError, match="stacked transport or the "
                                        "cross-process one.*FakeDist"):
        tc.gossip_round([torch.zeros(1, 8)], 0, sched, FakeDist(),
                        kernel=tgk.KernelLane(True))


# -- whole rounds against the reference ------------------------------------


def _state(seed=0):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((WORLD, 6, 50)).astype(np.float32),
            "b": r.standard_normal((WORLD, 130)).astype(np.float32)}


def _mixing(mod, mixing):
    return (mod.SelfWeightedMixing(np.linspace(0.3, 0.7, WORLD))
            if mixing == "self" else mod.UniformMixing())


def _ref_rounds(ppi, mixing, wire, overlap, staleness, buckets, kernel):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stochastic_gradient_push_tpu import topology as rt
    from stochastic_gradient_push_tpu.algorithms import sgp
    from stochastic_gradient_push_tpu.parallel import wire as rw
    from stochastic_gradient_push_tpu.parallel.mesh import (
        GOSSIP_AXIS, make_gossip_mesh)

    sched = rt.build_schedule(rt.NPeerDynamicDirectedExponentialGraph(
        WORLD, peers_per_itr=ppi), _mixing(rt, mixing))
    codec = None if wire == "none" else rw.get_codec(wire, 16)
    alg = sgp(sched, GOSSIP_AXIS, wire=codec, overlap=overlap,
              staleness=staleness, gossip_kernel=kernel,
              gossip_buckets=buckets)

    def step(p, g):
        p, g = alg.pre_step(p, g)
        return alg.post_step(p, g)

    fn = jax.jit(jax.shard_map(step, mesh=make_gossip_mesh(WORLD),
                               in_specs=(P(GOSSIP_AXIS),) * 2,
                               out_specs=(P(GOSSIP_AXIS),) * 2))
    params = _state()
    gstate = alg.init(jax.tree.map(lambda a: jnp.zeros(a.shape[1:], a.dtype),
                                   params))
    gstate = jax.tree.map(lambda a: np.broadcast_to(
        np.asarray(a), (WORLD,) + np.shape(a)).copy(), gstate)
    traj, ptraj = [], []
    for _ in range(ROUNDS):
        params, gstate = jax.block_until_ready(fn(params, gstate))
        traj.append(np.asarray(gstate.ps_weight).copy())
        ptraj.append({k: np.asarray(v).copy() for k, v in params.items()})
    return ptraj, np.stack(traj)


def _port_rounds(ppi, mixing, wire, overlap, staleness, buckets, kernel):
    sched = tt.build_schedule(tt.NPeerDynamicDirectedExponentialGraph(
        WORLD, peers_per_itr=ppi), _mixing(tt, mixing))
    alg = talg.sgp(sched, tc.StackedTransport(WORLD),
                   wire=None if wire == "none" else tw.get_codec(wire, 16),
                   overlap=overlap, staleness=staleness, gossip_kernel=kernel,
                   gossip_buckets=buckets)
    params = {k: torch.from_numpy(v.copy()) for k, v in _state().items()}
    gstate = alg.init(params)
    traj, ptraj = [], []
    for _ in range(ROUNDS):
        params, gstate = alg.pre_step(params, gstate)
        params, gstate = alg.post_step(params, gstate)
        assert not any(isinstance(s, tc.PendingShares)
                       for s in gstate.in_flight)
        traj.append(gstate.ps_weight.numpy().copy())
        ptraj.append({k: v.numpy().copy() for k, v in params.items()})
    return ptraj, np.stack(traj), gstate


_MODES = {"sync": (False, 1), "overlap1": (True, 1), "overlap2": (True, 2)}


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
@pytest.mark.parametrize("buckets", [1, 3])
@pytest.mark.parametrize("ppi,mixing", [(1, "self"), (2, "uniform")])
def test_rounds_match_reference_xla_lane(mode, wire, buckets, ppi, mixing):
    overlap, staleness = _MODES[mode]
    cfg = (ppi, mixing, wire, overlap, staleness, buckets)
    want_p, want_w = _ref_rounds(*cfg, kernel=None)
    for lane in (tgk.KernelLane(interpret=True, chunk_elems=128), None):
        got_p, got_w, gstate = _port_rounds(*cfg, kernel=lane)
        np.testing.assert_array_equal(
            got_w, want_w, err_msg=f"ps-weight trajectory, lane {lane}")
        for t in range(ROUNDS):
            for k in want_p[t]:
                np.testing.assert_allclose(
                    got_p[t][k], want_p[t][k], rtol=0, atol=PARAM_ATOL,
                    err_msg=f"{k} after round {t}, lane {lane}")
    # push-sum mass, in flight included, is conserved
    _, ps, fifo = talg.drain_in_flight({}, gstate.ps_weight,
                                       gstate.in_flight)
    np.testing.assert_allclose(float(ps.sum()), WORLD, rtol=1e-6)


@pytest.mark.parametrize("mode", ["sync", "overlap2"])
@pytest.mark.parametrize("wire", ["none", "int8"])
def test_rounds_match_reference_kernel_lane(mode, wire):
    if not _ref_can_start():
        pytest.skip("this jax has no pltpu.TPUCompilerParams, which the "
                    "reference's start kernel builds even in interpret mode")
    rgk = _ref_gk()
    overlap, staleness = _MODES[mode]
    cfg = (2, "uniform", wire, overlap, staleness, 3)
    want_p, want_w = _ref_rounds(*cfg, kernel=rgk.KernelLane(
        interpret=True, chunk_elems=128))
    got_p, got_w, _ = _port_rounds(*cfg, kernel=tgk.KernelLane(
        interpret=True, chunk_elems=128))
    np.testing.assert_array_equal(got_w, want_w)
    for t in range(ROUNDS):
        for k in want_p[t]:
            np.testing.assert_allclose(got_p[t][k], want_p[t][k], rtol=0,
                                       atol=PARAM_ATOL)


def test_bucket_count_and_lane_never_change_the_weight_lane():
    """Buckets only re-time the wire: 1 and 3 buckets give the same
    params bit for bit, and the ps-weight is the plain lane's."""
    cfg = (2, "self", "int8", True, 2)
    lane = tgk.KernelLane(interpret=True, chunk_elems=128)
    p1, w1, _ = _port_rounds(*cfg, 1, lane)
    p3, w3, _ = _port_rounds(*cfg, 3, lane)
    _, wx, _ = _port_rounds(*cfg, 1, None)
    np.testing.assert_array_equal(w1, w3)
    np.testing.assert_array_equal(w1, wx)
    for t in range(ROUNDS):
        for k in p1[t]:
            np.testing.assert_array_equal(p1[t][k], p3[t][k])
