"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and ``nvcc``; elsewhere they skip (the kernels
have no interpret mode).  On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Edge shapes beyond ``chip_smoke.py``'s: ragged lengths around the flash
kernels' tiles (64-row tiles and 16-row warp slices), causal and full,
for the forward with its logsumexp and both backward kernels; one and 96
heads; two launches of every flash kernel bit-equal (one owner block per
output tile, no atomics); every flash kernel against an fp64 oracle at
t4096 (no drift of their running sums); for the paged decode, a page
size that is not a multiple of its 8-token step, every GQA group it is
built for, padded page rows pointing at page 0 or at a sink page,
lengths on its split boundaries and at ``max_pages * page_size``, two
calls bit-equal (partials folded in split order), and calls captured in
a CUDA graph and replayed.  Tolerance: 1e-4 max abs in fp32 (TF32 off),
as in ``chip_smoke.py``.

Beyond the kernels: the flash ``autograd.Function`` on CUDA against the
CPU lane; a stacked world-2 SGP step on CUDA tensors against the same
step on the CPU, and world-4 push-sum rounds on every wire, on CUDA
against the CPU from the same inputs.  World 1 on the card never
exercises those (device placement of the collectives' index gathers and
weights).  Tolerances there: loss 1e-5 relative, params 1e-5 absolute
after a step and 1e-6 after rounds, the push-sum weight exactly equal.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.ops import flash_attention as tfa
from stochastic_gradient_push_torch.serve import paged_attention as tpa

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the tensor-core kernels' tile edges: 16-row warp slices, 64-row tiles
TILE_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 200, 1024]
FWD_LENGTHS = sorted({1, 31, 63, 64, 65, 129, 136, 300, *TILE_LENGTHS})


@pytest.mark.parametrize("t", FWD_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_plain(cuda, t, causal):
    g = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn(2, 3, t, 64, device=cuda, generator=g)
               for _ in range(3))
    before = tfa.flash_fwd.launches
    out = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    ref = tfa.flash_attention_reference(q, k, v, causal=causal)
    assert float((out - ref).abs().max()) <= TOL


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (6, 2), (8, 2),
                                    (5, 1), (6, 1), (7, 1), (8, 1)])
@pytest.mark.parametrize("page,pad", [(16, "zero"), (5, "sink")])
def test_paged_decode_matches_plain(cuda, hq, hkv, page, pad):
    r = np.random.default_rng(hq * 10 + hkv + page)
    b, num_pages, max_pages = 6, 40, 9
    kp = torch.tensor(r.standard_normal((hkv, num_pages, page, 64)),
                      dtype=torch.float32, device=cuda)
    vp = torch.tensor(r.standard_normal((hkv, num_pages, page, 64)),
                      dtype=torch.float32, device=cuda)
    q = torch.tensor(r.standard_normal((b, hq, 64)), dtype=torch.float32,
                     device=cuda)
    lengths = r.integers(1, max_pages * page + 1, size=b).astype(np.int32)
    lengths[:2] = (1, max_pages * page)
    pi = np.stack([r.permutation(num_pages - 1)[:max_pages]
                   for _ in range(b)]).astype(np.int32)
    for i in range(b):
        pi[i, -(-int(lengths[i]) // page):] = (0 if pad == "zero"
                                               else num_pages - 1)
    pi, lengths = (torch.tensor(a, device=cuda) for a in (pi, lengths))
    before = tpa.paged_decode.launches
    out = tpa.paged_attention_decode(q, kp, vp, pi, lengths)
    torch.cuda.synchronize()
    assert tpa.paged_decode.launches == before + 1
    ref = tpa.paged_attention_reference(q, kp, vp, pi, lengths)
    assert float((out - ref).abs().max()) <= TOL


def _paged_case(cuda, seed, hq, hkv, page, lengths, num_pages=40,
                max_pages=9):
    r = np.random.default_rng(seed)
    b = len(lengths)
    kp, vp = (torch.tensor(r.standard_normal((hkv, num_pages, page, 64)),
                           dtype=torch.float32, device=cuda)
              for _ in range(2))
    q = torch.tensor(r.standard_normal((b, hq, 64)), dtype=torch.float32,
                     device=cuda)
    pi = torch.tensor(np.stack([r.permutation(num_pages)[:max_pages]
                                for _ in range(b)]).astype(np.int32),
                      device=cuda)
    return q, kp, vp, pi, torch.tensor(lengths, dtype=torch.int32,
                                       device=cuda)


@pytest.mark.parametrize("page", [16, 5, 2])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_paged_decode_split_boundaries(cuda, page, hq, hkv):
    # lengths ending on each split boundary, one token either side of it,
    # and the whole page table (max_pages * page)
    max_pages = 9
    span = tpa.split_pages(page) * page
    full = max_pages * page
    lengths = sorted({min(x, full) for x in (
        1, span - 1, span, span + 1, 2 * span, 2 * span + 1, full - 1,
        full)})
    args = _paged_case(cuda, page + hq, hq, hkv, page, lengths,
                       max_pages=max_pages)
    out = tpa.paged_decode(*args)
    torch.cuda.synchronize()
    assert float((out - tpa.paged_attention_reference(*args)).abs().max()
                 ) <= TOL


def test_paged_decode_is_deterministic(cuda):
    # a length of 0 has no split: its row is zeros
    args = _paged_case(cuda, 60, 8, 4, 16, [1, 17, 64, 100, 144, 0])
    a, b = tpa.paged_decode(*args), tpa.paged_decode(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert not a[-1].any()


def test_paged_decode_replays_in_a_cuda_graph(cuda):
    # the decode tick may be captured: workspace and launches inside the
    # graph, replays against the plain version on new query values
    q, kp, vp, pi, lengths = _paged_case(cuda, 61, 12, 12, 16,
                                         [1, 30, 64, 65, 97, 144])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_decode(q, kp, vp, pi, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_decode(q, kp, vp, pi, lengths)
    for seed in range(3):
        q.copy_(torch.randn(q.shape, device=cuda,
                            generator=torch.Generator(device=cuda)
                            .manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize()
        ref = tpa.paged_attention_reference(q, kp, vp, pi, lengths)
        assert float((out - ref).abs().max()) <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q, q, q)
    with pytest.raises(TypeError, match="float32"):
        x = torch.randn(1, 2, 8, 64, device=cuda, dtype=torch.float64)
        tfa.flash_fwd(x, x, x)
    qd = torch.randn(2, 9, 64, device=cuda)
    pages = torch.randn(1, 4, 4, 64, device=cuda)
    pi = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="group"):
        tpa.paged_decode(qd, pages, pages, pi, lengths)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_decode(qd[:, :2].contiguous(), pages, pages, pi.long(),
                         lengths)


BWD_LENGTHS = sorted({1, 31, 32, 63, 64, 65, 129, 200, 300, *TILE_LENGTHS})


def _fwd_bwd_case(cuda, t, seed, b=2, h=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, h, t, 64, device=cuda, generator=g)
                 for _ in range(4))


@pytest.mark.parametrize("t", BWD_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_lse_matches_plain(cuda, t, causal):
    q, k, v, _ = _fwd_bwd_case(cuda, t, 10 + t)
    out, lse = tfa.flash_fwd(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
    assert float((out - ref).abs().max()) <= TOL
    assert float((lse - ref_lse).abs().max()) <= TOL


@pytest.mark.parametrize("t", BWD_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_match_plain(cuda, t, causal):
    q, k, v, do = _fwd_bwd_case(cuda, t, 20 + t)
    out, lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    delta = (do * out).sum(-1)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = (tfa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal),
            *tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal))
    for got, ref in zip((dq, dk, dv), want):
        assert float((got - ref).abs().max()) <= TOL


@pytest.mark.parametrize("b,h,t", [(1, 1, 130), (8, 12, 200)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_one_and_96_heads(cuda, b, h, t, causal):
    q, k, v, do = _fwd_bwd_case(cuda, t, 30 + b * h, b=b, h=h)
    out, lse = tfa.flash_fwd(q, k, v, causal=causal, return_lse=True)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
    delta = (do * ref).sum(-1)
    args = (q, k, v, do, ref_lse, delta, causal)
    got = (out, lse, tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
    want = (ref, ref_lse, tfa.flash_bwd_dq_reference(*args),
            *tfa.flash_bwd_dkv_reference(*args))
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= TOL


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_are_deterministic(cuda, causal):
    q, k, v, do = _fwd_bwd_case(cuda, 300, 40, b=2, h=4)
    runs = []
    for _ in range(2):
        out, lse = tfa.flash_fwd(q, k, v, causal=causal, return_lse=True)
        delta = (do * out).sum(-1)
        runs.append((out, lse,
                     tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
                     *tfa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                        causal=causal)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_hold_fp32_accuracy_at_long_lengths(cuda, causal):
    # the running sums (o, dQ, dK, dV) take their products from the
    # tensor cores a tile at a time and add them in fp32: carried through
    # the tensor cores' own accumulation, dK/dV drifted as t grew
    t = 4096
    q, k, v, do = _fwd_bwd_case(cuda, t, 50, b=1, h=2)
    out, lse = tfa.flash_fwd(q, k, v, causal=causal, return_lse=True)
    delta = (do * out).sum(-1)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    s = (q64 * 64 ** -0.5) @ k64.transpose(-1, -2)
    if causal:
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool,
                                      device=cuda).tril(), float("-inf"))
    p = torch.exp(s - lse.double()[..., None])   # from the kernel's lse
    ds = p * (do64 @ v64.transpose(-1, -2) - delta.double()[..., None])
    want = (torch.softmax(s, -1) @ v64, torch.logsumexp(s, -1),
            ds @ k64 * 64 ** -0.5,
            ds.transpose(-1, -2) @ (q64 * 64 ** -0.5),
            p.transpose(-1, -2) @ do64)
    for got, ref in zip((out, lse, dq, dk, dv), want):
        assert float((got.double() - ref).abs().max()) <= TOL


@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_on_cuda_matches_cpu_lane(cuda, causal):
    q, k, v, do = _fwd_bwd_case(cuda, 100, 7)
    res = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        out = tfa.flash_attention(*leaves, causal=causal)
        res.append([out.detach(),
                    *torch.autograd.grad(out, leaves, do.to(dev))])
    for got, ref in zip(*res):
        assert float((got.cpu() - ref).abs().max()) <= TOL


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_bwd_dq(q, q, q, q, lse, lse)
    x = torch.randn(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        tfa.flash_bwd_dkv(x, x, x, x, lse[..., :4].contiguous(), lse)


def test_stacked_world2_sgp_step_on_cuda_matches_cpu(cuda):
    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, SelfWeightedMixing,
        build_schedule)
    from stochastic_gradient_push_torch.train.lm import (
        build_lm_train_step, init_lm_state, make_model)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd

    cfg = TransformerConfig(vocab_size=96, d_model=128, n_layers=2,
                            n_heads=2, d_ff=256, attn_impl="flash")
    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(2),
                           SelfWeightedMixing(np.array([0.3, 0.6])))
    r = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(r.integers(0, 96, (2, 2, 40)))
                     for _ in range(2)) for _ in range(3)]
    runs = []
    for dev in (cuda, torch.device("cpu")):
        alg = sgp(sched, StackedTransport(2))
        tx = sgd(0.9, 1e-4)
        step = build_lm_train_step(make_model(cfg), alg, tx,
                                   LRSchedule(0.5, 2, 2, {}), 10)
        state = init_lm_state(cfg, alg, tx, 2, seed=3, device=dev)
        losses = []
        for toks, tgts in batches:
            state, m = step(state, toks.to(dev), tgts.to(dev))
            losses.append(m["loss"].cpu())
        runs.append((state, torch.stack(losses)))
    (gs, gl), (cs, cl) = runs
    for t in [*gs.params.values(), *gs.opt_state.values(),
              gs.gossip.ps_weight]:
        assert t.device.type == "cuda"
    torch.testing.assert_close(gl, cl, rtol=1e-5, atol=0)
    assert torch.equal(gs.gossip.ps_weight.cpu(), cs.gossip.ps_weight)
    for n in cs.params:
        assert float((gs.params[n].cpu() - cs.params[n]).abs().max()) <= 1e-5


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_push_sum_rounds_on_cuda_match_cpu(cuda, wire):
    from stochastic_gradient_push_torch.parallel import collectives as tc
    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, SelfWeightedMixing,
        build_schedule)

    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(4, 2),
                           SelfWeightedMixing(np.linspace(0.3, 0.6, 4)))
    r = np.random.default_rng(1)
    params = {"w": torch.from_numpy(
        r.standard_normal((4, 7, 33)).astype(np.float32))}
    ps = torch.from_numpy((1 + r.random(4)).astype(np.float32))
    out = []
    for dev in (cuda, torch.device("cpu")):
        p, w = {n: a.to(dev) for n, a in params.items()}, ps.to(dev)
        for phase in range(3):
            p, w = tc.mix_push_sum(p, w, phase, sched,
                                   tc.StackedTransport(4),
                                   codec=get_codec(wire, 16))
        out.append((p["w"].cpu(), w.cpu()))
    (gp, gw), (cp, cw) = out
    assert torch.equal(gw, cw)
    assert float((gp - cp).abs().max()) <= 1e-6


# -- the gossip transport kernels (K2 start, K1 wait) -----------------------


def _gossip_parts(kind, block, ranks, ne, n, chunk, device, seed):
    from stochastic_gradient_push_torch.ops import gossip_kernel as tgk

    g = torch.Generator(device=device).manual_seed(seed)
    rows, c, nb = tgk._chunk_layout(n, block, chunk)
    if kind == "int8":
        return (torch.randint(-127, 128, (ranks, ne, nb * rows, block),
                              generator=g, device=device, dtype=torch.int8),
                torch.rand(ranks, ne, nb * rows, generator=g,
                           device=device) * 0.02)
    x = torch.randn(ranks, ne, n, generator=g, device=device)
    return (x.to(torch.bfloat16) if kind == "bf16" else x,)


@pytest.mark.parametrize("kind,block", [("f32", None), ("bf16", None),
                                        ("int8", 7), ("int8", 64)])
@pytest.mark.parametrize("ne", [1, 2])
@pytest.mark.parametrize("n,chunk", [(300, 128), (33, 1 << 30), (256, 64),
                                     (4097, 1024)])
def test_gossip_edge_kernels_bit_equal_plain(cuda, kind, block, ne, n,
                                             chunk):
    from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
    from stochastic_gradient_push_torch.parallel.wire import DecodeSpec

    ranks = 4
    spec = DecodeSpec(kind, block)
    parts = _gossip_parts(kind, block, ranks, ne, n, chunk, cuda, n + ne)
    dests = np.stack([np.roll(np.arange(ranks), 1 + e) for e in range(ne)])
    starts, waits = tgk.gossip_edge_start.launches, \
        tgk.gossip_edge_wait.launches
    handle = tgk.gossip_edge_start(parts, dests, spec, n_decoded=n,
                                   chunk_elems=chunk)
    # the parts in the handle's chunk layout (dim 2 padded to NB chunks)
    chunks = tuple(tgk._pad_rows(p, h.shape[2] * h.shape[3], 2
                                 ).reshape(h.shape)
                   for p, h in zip(parts, handle.recv))
    plain = tgk.gossip_edge_start_reference(chunks, dests)
    for got, want in zip(handle.recv, plain):
        assert torch.equal(got, want)
    acc = torch.randn(ranks, n, device=cuda)
    out = tgk.gossip_edge_wait(handle, acc)
    _, _, rows, c, nb, _, _ = handle.meta
    want = tgk.gossip_edge_wait_reference(
        tgk._pad_rows(acc, nb * c, 1).reshape(ranks, nb, c), plain, kind
    ).reshape(ranks, -1)[:, :n]
    assert torch.equal(out, want)
    assert tgk.gossip_edge_start.launches == starts + 1
    assert tgk.gossip_edge_wait.launches == waits + 1
    # the same wait on the CPU's plain twin, through an interpret handle
    cpu_handle = tgk.TransportHandle(
        recv=tuple(t.cpu() for t in handle.recv),
        meta=handle.meta[:-1] + (True,))
    assert torch.equal(tgk.gossip_edge_wait(cpu_handle, acc.cpu()),
                       out.cpu())


def test_gossip_wrappers_refuse_the_wrong_lane(cuda):
    from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
    from stochastic_gradient_push_torch.ops.lanes import KernelLaneError
    from stochastic_gradient_push_torch.parallel.wire import F32

    x = torch.zeros(4, 1, 300, device=cuda)
    dests = np.roll(np.arange(4), 1)
    acc = x[:, 0]
    with pytest.raises(KernelLaneError, match="plain twins on CPU"):
        tgk.gossip_edge_wait(tgk.gossip_edge_start(
            (x,), dests, F32.kernel_spec(), interpret=True), acc)
    handle = tgk.gossip_edge_start((x,), dests, F32.kernel_spec())
    with pytest.raises(ValueError, match="elements per rank"):
        tgk.gossip_edge_wait(handle, torch.zeros(4, 299, device=cuda))
    with pytest.raises(ValueError, match="permutation"):
        tgk.gossip_edge_wait(tgk.gossip_edge_start(
            (x,), [0, 0, 1, 2], F32.kernel_spec()), acc)


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
@pytest.mark.parametrize("overlap", [False, True])
def test_world4_rounds_on_the_kernel_lane_match_the_plain_lane(cuda, wire,
                                                               overlap):
    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
    from stochastic_gradient_push_torch.parallel import collectives as tc
    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, SelfWeightedMixing,
        build_schedule)

    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(4, 2),
                           SelfWeightedMixing(np.linspace(0.3, 0.6, 4)))
    r = np.random.default_rng(2)
    leaves = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
              for s in ((4, 7, 33), (4, 300))]
    ps = torch.from_numpy((1 + r.random(4)).astype(np.float32))
    runs = []
    for dev, lane in ((cuda, KernelLane(chunk_elems=128)), (cuda, None),
                      (torch.device("cpu"),
                       KernelLane(interpret=True, chunk_elems=128))):
        tree = [a.to(dev) for a in leaves] + [ps.to(dev)]
        for phase in range(3):
            kw = dict(codec=get_codec(wire, 16), kernel=lane, buckets=2)
            if overlap:
                local, inc = tc.overlap_launch(tree, phase, sched,
                                               tc.StackedTransport(4), **kw)
                tree = tc.land_shares(local, tc.settle_share(inc))
            else:
                tree = tc.gossip_round(tree, phase, sched,
                                       tc.StackedTransport(4), **kw)
        runs.append([t.cpu() for t in tree])
    (kern, plain, interp) = runs
    for other in (plain, interp):
        assert torch.equal(kern[-1], other[-1])
        for a, b in zip(kern[:-1], other[:-1]):
            assert float((a - b).abs().max()) <= 1e-6
    for a, b in zip(kern, interp):
        assert torch.equal(a, b)


def test_stacked_world4_osgp_step_on_the_kernel_lane(cuda):
    from stochastic_gradient_push_torch.algorithms import osgp
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.parallel.wire import BF16
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lm import (
        build_lm_train_step, init_lm_state, make_model)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd

    cfg = TransformerConfig(vocab_size=96, d_model=128, n_layers=2,
                            n_heads=2, d_ff=256, attn_impl="flash")
    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(4, 2))
    r = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(r.integers(0, 96, (4, 2, 40)))
                     for _ in range(2)) for _ in range(3)]
    runs = []
    for dev, lane in ((cuda, tgk.KernelLane(chunk_elems=4096)), (cuda, None),
                      (torch.device("cpu"),
                       tgk.KernelLane(interpret=True, chunk_elems=4096))):
        alg = osgp(sched, StackedTransport(4), staleness=2,
                   gossip_kernel=lane, gossip_buckets=3, wire=BF16)
        tx = sgd(0.9, 1e-4)
        step = build_lm_train_step(make_model(cfg), alg, tx,
                                   LRSchedule(0.5, 2, 4, {}), 10)
        state = init_lm_state(cfg, alg, tx, 4, seed=3, device=dev)
        before = tgk.gossip_edge_start.launches
        losses = []
        for toks, tgts in batches:
            state, m = step(state, toks.to(dev), tgts.to(dev))
            losses.append(m["loss"].cpu())
        if dev.type == "cuda" and lane is not None:
            assert tgk.gossip_edge_start.launches == before + 3 * 3
        runs.append((state, torch.stack(losses)))
    (ks, kl), (ps_, pl), (cs, cl) = runs
    for other_state, other_loss in ((ps_, pl), (cs, cl)):
        torch.testing.assert_close(kl, other_loss, rtol=1e-5, atol=0)
        assert torch.equal(ks.gossip.ps_weight.cpu(),
                           other_state.gossip.ps_weight.cpu())
        for n in ks.params:
            assert float((ks.params[n].cpu()
                          - other_state.params[n].cpu()).abs().max()) <= 1e-5
