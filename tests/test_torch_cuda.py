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
Thinned and averaged SGP/OSGP steps on the kernel lane (launches per
fired and skipped step) against the plain and interpret lanes, and a
ResNet-18 step on the card against the CPU (params and BatchNorm
statistics 5e-5).  D-PSGD steps on the kernel lane (sync and overlap)
against the plain and interpret lanes (params 1e-6, weight exact),
bilateral rounds on the card bit-equal to the CPU's, and the training
CLI with D-PSGD on the kernel lane against the CPU run (params 1e-5).
Faulted rounds with error feedback (drops, blackouts, NaN corruption;
bf16 and int8; sync and overlap) on the kernel lane against the plain
lane on the card and the interpret lane on the CPU: residual and
ps-weight exact, params 1e-6, NaN positions equal.  Hierarchical rounds
(sync and the overlap split) and a synthesized cycle on the kernel lane
against the plain and interpret lanes (ps-weight exact; params and
residual exact on the hierarchical schedule, 1e-6 on the synthesized
one), and the grouped mean on the card bit-equal to the CPU's.  Ring
flash attention (``ops/ring_flash.py``) on the kernel lane against its
plain lane on the card, forward and backward (1e-4), at sp 3 and 4 and
at a shard whose per-row scalars start off 16-byte alignment, with one
K3 launch a visible (shard, tick) pair in the forward and one K4 and one
K5 in the backward; and a dp 2 x sp 2 ``ring_flash`` SGP step with remat
on the card against the same step on the CPU.

bf16: the bf16 forms of the flash kernels against their plain twins on
the same bf16 inputs (b1 t8, b1 t200, B8 T1024 and the ring tick's b2
t1024, causal and full, plus lengths on both sides of the 64-row tiles up
to t1000, one head, and batch*heads 65,532 at t8), two launches of each
bit-equal, element by element in bf16
ulps (``tfa.bf16_close``: one ulp of max(|plain|, 2**-8 of the largest
|plain|), at most 1 % of the elements apart; at t = 1 the q and k
gradients are fp32 summation noise around an exact 0, held to 1e-4) and
lse within 1e-4, counted as bf16 launches and never as fp32 ones; the
bf16 ring on the kernel lane against its plain lane, at a shard whose
fp32 per-row scalars start off 16-byte alignment, and the bf16 autograd
Function on CUDA against the CPU lane, both results merged from
bf16-rounded parts (``bf16_close(parts=True)``: two ulps of the largest
|plain|, 1 % apart); and a world-2 SGP step at bf16 on
the card against the CPU, no farther from it than twice the CPU's bf16
step is from its fp32 step.
"""

import dataclasses

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_are_deterministic(cuda, causal, dtype):
    q, k, v, do = (x.to(dtype) for x in _fwd_bwd_case(cuda, 300, 40, b=2,
                                                       h=4))
    runs = []
    for _ in range(2):
        out, lse = tfa.flash_fwd(q, k, v, causal=causal, return_lse=True)
        delta = (do.float() * out.float()).sum(-1)
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


@pytest.mark.parametrize("overlap,staleness", [(False, 1), (True, 1),
                                               (True, 2)])
def test_thinned_and_averaged_steps_on_the_kernel_lane(cuda, overlap,
                                                       staleness):
    """``gossip_every=2``, ``global_avg_every=3`` on the card: the kernel
    lane against the plain lane and the CPU's interpret lane over 7 steps
    of SGD on a quadratic; a fired step launches one start and one wait
    per bucket, a skipped step none; the push-sum weight bit-equal."""
    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)

    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(4, 2))
    r = np.random.default_rng(4)
    # two payload leaves: two transport buckets
    x0, tg = ({n: torch.from_numpy(r.standard_normal(s).astype(np.float32))
               for n, s in (("a", (4, 7, 33)), ("b", (4, 300)))}
              for _ in range(2))
    runs = []
    for dev, lane in ((cuda, tgk.KernelLane(chunk_elems=128)), (cuda, None),
                      (torch.device("cpu"),
                       tgk.KernelLane(interpret=True, chunk_elems=128))):
        alg = sgp(sched, StackedTransport(4), overlap=overlap,
                  staleness=staleness, gossip_every=2, global_avg_every=3,
                  gossip_kernel=lane, gossip_buckets=2)
        params = {n: t.to(dev) for n, t in x0.items()}
        target = {n: t.to(dev) for n, t in tg.items()}
        gstate = alg.init(params)
        for tick in range(7):
            before = (tgk.gossip_edge_start.launches,
                      tgk.gossip_edge_wait.launches)
            params, gstate = alg.pre_step(params, gstate)
            z = alg.eval_params(params, gstate)
            params = {n: p - 0.1 * (z[n] - target[n])
                      for n, p in params.items()}
            params, gstate = alg.post_step(params, gstate)
            torch.cuda.synchronize()
            if dev.type == "cuda" and lane is not None:
                n = 2 if tick % 2 == 0 else 0
                assert (tgk.gossip_edge_start.launches - before[0],
                        tgk.gossip_edge_wait.launches - before[1]) == (n, n)
        runs.append(({n: t.cpu() for n, t in params.items()},
                     gstate.ps_weight.cpu()))
    (kw, kp), (pw, pp), (cw, cp) = runs
    for w, p in ((pw, pp), (cw, cp)):
        assert torch.equal(kp, p)
        for n in kw:
            assert float((kw[n] - w[n]).abs().max()) <= 1e-6


def test_resnet_step_on_cuda_matches_cpu(cuda):
    """One SGP step of ResNet-18 (CIFAR stem, 32 px, batch 4, world 4
    stacked, a fired round) on the card, TF32 off and cuDNN
    deterministic, against the same step on the CPU in fp32 and in fp64:
    losses 1e-5 relative, the push-sum weight equal, and the card's
    params and BatchNorm statistics no farther from the fp64 step than
    twice the CPU's fp32 step is (+1e-5).  cuDNN and the CPU sum the
    convolutions in other orders, and the last stage's BatchNorm (64
    values a channel) amplifies it: on an H100 the two fp32 steps'
    params differed by up to 6.6e-5."""
    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd
    from stochastic_gradient_push_torch.train.step import (
        build_train_step, init_train_state, make_model)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((4, 4, 32, 32, 3)).astype(
        np.float32))
    y = torch.from_numpy(r.integers(0, 10, (4, 4)))
    runs = []
    try:
        for dev, dtype in ((cuda, torch.float32),
                           (torch.device("cpu"), torch.float32),
                           (torch.device("cpu"), torch.float64)):
            model = make_model("resnet18", num_classes=10, small_images=True,
                               dtype=dtype)
            alg = sgp(build_schedule(NPeerDynamicDirectedExponentialGraph(4)),
                      StackedTransport(4))
            tx = sgd(0.9, 1e-4, nesterov=True)
            step = build_train_step(model, alg, tx,
                                    LRSchedule(0.1, 4, 4, warmup=True), 100,
                                    10)
            state = init_train_state(model, alg, tx, 4, seed=2, device=dev)
            if dtype == torch.float64:
                def up(tree):
                    return {n: t.double() for n, t in tree.items()}

                state = dataclasses.replace(
                    state, params=up(state.params),
                    opt_state=up(state.opt_state),
                    batch_stats=up(state.batch_stats),
                    gossip=state.gossip.replace(
                        ps_weight=state.gossip.ps_weight.double()))
            state, m = step(state, x.to(dev, dtype), y.to(dev))
            runs.append((state, m["loss"].cpu()))
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.allow_tf32 = tf32
    (gs, gl), (cs, cl), (es, _) = runs
    torch.testing.assert_close(gl, cl, rtol=1e-5, atol=0)
    assert torch.equal(gs.gossip.ps_weight.cpu(), cs.gossip.ps_weight)

    def err(a, b):
        return max(float((a[n].cpu().double() - b[n]).abs().max())
                   for n in b)

    for tree in ("params", "batch_stats"):
        g, c, e = (getattr(st, tree) for st in (gs, cs, es))
        assert all(t.device.type == "cuda" for t in g.values())
        assert err(g, e) <= 2 * err(c, e) + 1e-5, (tree, err(g, e),
                                                    err(c, e))


@pytest.mark.parametrize("overlap,staleness", [(False, 1), (True, 1),
                                               (True, 2)])
def test_dpsgd_steps_on_the_kernel_lane(cuda, overlap, staleness):
    """D-PSGD on the card: the kernel lane against the plain lane and the
    CPU's interpret lane over 6 steps of SGD on a quadratic; one start
    and one wait per bucket a step; sync rounds carry no weight (it
    stays 1), overlap rounds carry it bit-equal across the lanes."""
    from stochastic_gradient_push_torch.algorithms import dpsgd
    from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)

    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(4, 2))
    r = np.random.default_rng(5)
    x0, tg = ({n: torch.from_numpy(r.standard_normal(s).astype(np.float32))
               for n, s in (("a", (4, 7, 33)), ("b", (4, 300)))}
              for _ in range(2))
    runs = []
    for dev, lane in ((cuda, tgk.KernelLane(chunk_elems=128)), (cuda, None),
                      (torch.device("cpu"),
                       tgk.KernelLane(interpret=True, chunk_elems=128))):
        alg = dpsgd(sched, StackedTransport(4), overlap=overlap,
                    staleness=staleness, gossip_kernel=lane,
                    gossip_buckets=2)
        params = {n: t.to(dev) for n, t in x0.items()}
        target = {n: t.to(dev) for n, t in tg.items()}
        gstate = alg.init(params)
        for _ in range(6):
            before = (tgk.gossip_edge_start.launches,
                      tgk.gossip_edge_wait.launches)
            params, gstate = alg.pre_step(params, gstate)
            z = alg.eval_params(params, gstate)
            params = {n: p - 0.1 * (z[n] - target[n])
                      for n, p in params.items()}
            params, gstate = alg.post_step(params, gstate)
            torch.cuda.synchronize()
            if dev.type == "cuda" and lane is not None:
                assert (tgk.gossip_edge_start.launches - before[0],
                        tgk.gossip_edge_wait.launches - before[1]) == (2, 2)
        runs.append(({n: t.cpu() for n, t in params.items()},
                     gstate.ps_weight.cpu()))
    (kw, kp), (pw, pp), (cw, cp) = runs
    if not overlap:
        assert torch.equal(kp, torch.ones(4))
    for w, p in ((pw, pp), (cw, cp)):
        assert torch.equal(kp, p)
        for n in kw:
            assert float((kw[n] - w[n]).abs().max()) <= 1e-6


def test_bilat_rounds_on_cuda_match_cpu(cuda):
    from stochastic_gradient_push_torch.parallel import collectives as tc
    from stochastic_gradient_push_torch.topology import (
        DynamicBipartiteExponentialGraph, build_pairing_schedule)

    pairing = build_pairing_schedule(DynamicBipartiteExponentialGraph(8, 2))
    r = np.random.default_rng(6)
    base = {"a": torch.from_numpy(r.standard_normal((8, 5, 9))
                                  .astype(np.float32)),
            "b": torch.from_numpy(r.standard_normal((8, 1))
                                  .astype(np.float32))}
    runs = []
    for dev in (cuda, torch.device("cpu")):
        params = {n: t.to(dev) for n, t in base.items()}
        for phase in range(len(pairing) + 1):
            params = tc.mix_bilat(params, phase, pairing,
                                  tc.StackedTransport(8))
        runs.append({n: t.cpu() for n, t in params.items()})
    for n in base:
        assert torch.equal(runs[0][n], runs[1][n])


def test_gossip_sgd_cli_on_cuda_matches_cpu(cuda, tmp_path):
    """The training CLI with D-PSGD on the kernel lane on the card
    against the same command on the CPU (plain lane): the saved rank
    files' params within 1e-5, the push-sum weight equal, and the CSVs'
    header and epochs/iterations equal."""
    from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
    from stochastic_gradient_push_torch.run import gossip_sgd

    argv = ["--dataset", "synthetic", "--model", "tiny_mlp", "--image_size",
            "8", "--num_classes", "4", "--batch_size", "4", "--world_size",
            "4", "--num_epochs", "2", "--num_iterations_per_training_epoch",
            "3", "--push_sum", "False", "--verbose", "False"]
    before = tgk.gossip_edge_start.launches
    gossip_sgd.main(argv + ["--gossip_kernel", "pallas", "--checkpoint_dir",
                            str(tmp_path / "gpu")])
    assert tgk.gossip_edge_start.launches - before == 6
    gossip_sgd.main(argv + ["--device", "cpu", "--checkpoint_dir",
                            str(tmp_path / "cpu")])
    for r in range(4):
        got, want = (torch.load(tmp_path / d / f"checkpoint_r{r}_n4.ckpt",
                                weights_only=True)["state"]
                     for d in ("gpu", "cpu"))
        assert got["step"] == want["step"] == 6
        assert torch.equal(got["gossip"]["ps_weight"],
                           want["gossip"]["ps_weight"])
        for n, t in want["params"].items():
            assert float((got["params"][n] - t).abs().max()) <= 1e-5
    rows = [[line.split(",")[:2] for line in open(
        tmp_path / d / "out_r0_n4.csv").read().splitlines()]
        for d in ("gpu", "cpu")]
    assert rows[0] == rows[1]


@pytest.mark.parametrize("wire", ["bf16", "int8"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("spec", ["drop:0->1@0:3;nan:2@1:2",
                                  "blackout:3@0:2"])
def test_faulted_ef_rounds_on_the_kernel_lane(cuda, wire, overlap, spec):
    """Error feedback and a fault plan at world 4, the kernel lane on the
    card against the plain lane on the card and the interpret lane on
    the CPU, NaN positions included; one start and one wait per bucket
    a round.  One round at two peers (self-weighted): residual and
    ps-weight exact across the card's lanes, params 1e-6.  Three rounds
    at one peer under uniform mixing, where ``lo * x`` is exact: every
    tensor exact.  (Over several rounds with an inexact local share the
    lanes' one-ulp params difference can flip a wire code, so those are
    not compared.)  The kernel lane equals its interpret twins
    throughout."""
    from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
    from stochastic_gradient_push_torch.parallel import collectives as tc
    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.resilience import parse_fault_spec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, SelfWeightedMixing,
        build_schedule)

    def nan_equal(a, b):
        return (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(), b.nan_to_num()))

    r = np.random.default_rng(3)
    leaves = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
              for s in ((4, 7, 33), (4, 300))]
    ps = torch.from_numpy((1 + r.random(4)).astype(np.float32))
    for ppi, mixing, rounds in (
            (2, SelfWeightedMixing(np.linspace(0.3, 0.6, 4)), 1),
            (1, None, 3)):
        sched = build_schedule(NPeerDynamicDirectedExponentialGraph(4, ppi),
                               mixing)
        masks = parse_fault_spec(spec).build_masks(sched)
        runs = []
        for dev, lane in ((cuda, tgk.KernelLane(chunk_elems=128)),
                          (cuda, None),
                          (torch.device("cpu"),
                           tgk.KernelLane(interpret=True, chunk_elems=128))):
            tree = [a.to(dev) for a in leaves] + [ps.to(dev)]
            res = [torch.zeros_like(a) for a in tree]
            before = tgk.gossip_edge_start.launches
            for tick in range(rounds):
                kw = dict(codec=get_codec(wire, 16), kernel=lane, buckets=2,
                          faults=masks, tick=tick, ef_residual=res)
                if overlap:
                    local, inc, res = tc.overlap_launch(
                        tree, tick, sched, tc.StackedTransport(4), **kw)
                    tree = tc.land_shares(local, tc.settle_share(inc))
                else:
                    tree, res = tc.gossip_round(
                        tree, tick, sched, tc.StackedTransport(4), **kw)
            launched = tgk.gossip_edge_start.launches - before
            assert launched == (2 * rounds if lane is not None
                                and not lane.interpret else 0)
            runs.append([t.cpu() for t in tree + res])
        kern, plain, interp = runs
        assert all(nan_equal(a, b) for a, b in zip(kern, interp))
        assert torch.equal(kern[2], plain[2])       # the ps-weight
        assert all(nan_equal(a, b) for a, b in zip(kern[3:], plain[3:]))
        for a, b in zip(kern[:2], plain[:2]):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            err = float((a - b).nan_to_num().abs().max())
            assert err == 0.0 if mixing is None else err <= 1e-6


WORLD4_SYNTH = {"v": 1, "world": 4, "phases": [
    {"kind": "psum", "group_size": 2},
    {"kind": "edge", "perm": [2, 1, 0, 3], "send": [0.9, 0.0, 0.9, 0.0]},
    {"kind": "edge", "perm": [3, 2, 1, 0], "send": [0.5, 0.5, 0.5, 0.5]}]}


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
@pytest.mark.parametrize("kind,overlap", [("hierarchical", False),
                                          ("hierarchical", True),
                                          ("synth", False)])
def test_hierarchical_and_synth_rounds_on_the_kernel_lane(cuda, kind,
                                                          overlap, wire):
    """Three rounds of the hierarchical schedule (slices of 2; the
    overlap split lands the delegate share, then the intra-slice mean)
    and one cycle of the planner's world-4 synthesized schedule, with
    error feedback on a lossy wire: the kernel lane on the card against
    the plain lane on the card and the interpret lane on the CPU.  One
    start per bucket a launching round, none for a grouped mean; the
    ps-weight exact across the card's lanes; params and residual exact
    on the hierarchical schedule (``lo·x`` is exact at 0.5) and 1e-6 on
    the synthesized one (its 0.1 self weight is rounded on its own on
    the kernel lane, and the next round encodes that ulp); the kernel
    lane equals its interpret twins."""
    from stochastic_gradient_push_torch.ops import gossip_kernel as tgk
    from stochastic_gradient_push_torch.parallel import collectives as tc
    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.topology import (
        HierarchicalGraph, SynthesizedGraph, build_schedule)

    sched = build_schedule(HierarchicalGraph(4, slice_size=2)
                           if kind == "hierarchical"
                           else SynthesizedGraph(4, spec=WORLD4_SYNTH))
    r = np.random.default_rng(4)
    leaves = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
              for s in ((4, 7, 33), (4, 300))]
    ps = torch.from_numpy((1 + r.random(4)).astype(np.float32))
    codec = get_codec(wire, 16)
    ef = codec is not None and codec.lossy
    launching = 3 if kind == "hierarchical" else 2
    runs = []
    for dev, lane in ((cuda, tgk.KernelLane(chunk_elems=128)), (cuda, None),
                      (torch.device("cpu"),
                       tgk.KernelLane(interpret=True, chunk_elems=128))):
        transport = tc.StackedTransport(4)
        tree = [a.to(dev) for a in leaves] + [ps.to(dev)]
        res = [torch.zeros_like(a) for a in tree] if ef else None
        before = tgk.gossip_edge_start.launches
        for phase in range(3):
            kw = dict(codec=codec, kernel=lane, buckets=2, ef_residual=res)
            if overlap:
                out = tc.overlap_launch(tree, phase, sched, transport, **kw)
                tree = tc.intra_average(
                    tc.land_shares(out[0], tc.settle_share(out[1])), sched,
                    transport)
            else:
                out = tc.gossip_round(tree, phase, sched, transport, **kw)
                tree = out[0] if ef else out
            if ef:
                res = out[-1]
        launched = tgk.gossip_edge_start.launches - before
        assert launched == (2 * launching if lane is not None
                            and not lane.interpret else 0)
        runs.append([t.cpu() for t in tree + (res or [])])
    kern, plain, interp = runs
    assert all(torch.equal(a, b) for a, b in zip(kern, interp))
    assert torch.equal(kern[2], plain[2])           # the ps-weight
    for a, b in zip(kern[:2] + kern[3:], plain[:2] + plain[3:]):
        err = float((a - b).abs().max())
        assert err == 0.0 if kind == "hierarchical" else err <= 1e-6


def test_grouped_mean_on_cuda_matches_cpu(cuda):
    """The grouped mean (slices of 2 and 4) on the card bit-equal to the
    CPU's, views of one raveled buffer per dtype."""
    from stochastic_gradient_push_torch.parallel import collectives as tc

    r = np.random.default_rng(5)
    leaves = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
              for s in ((8, 7, 33), (8, 300), (8,))]
    for s in (2, 4):
        groups = tuple(tuple(range(j * s, (j + 1) * s))
                       for j in range(8 // s))
        got = tc.StackedTransport(8).group_mean(
            [a.to(cuda) for a in leaves], groups)
        want = tc.StackedTransport(8).group_mean(leaves, groups)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("sp,causal,b,h,t", [
    (4, True, 2, 3, 130), (4, False, 2, 3, 130), (3, True, 2, 3, 64),
    (2, True, 1, 1, 7)])
def test_ring_flash_kernel_lane_matches_plain_lane(cuda, sp, causal, b, h,
                                                   t):
    from stochastic_gradient_push_torch.ops.ring_flash import (
        ring_flash_attention)
    from stochastic_gradient_push_torch.parallel.seq import StackedSeq

    g = torch.Generator(device=cuda).manual_seed(sp + t)
    q, k, v, do = (torch.randn(sp, b, h, t, 64, device=cuda, generator=g)
                   for _ in range(4))
    seq = StackedSeq(sp)
    res = []
    for lane in ("kernel", "plain"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dq,
                                       tfa.flash_bwd_dkv)]
        out = ring_flash_attention(*leaves, seq, causal=causal, lane=lane)
        grads = torch.autograd.grad(out, leaves, do)
        launched = [f.launches - n for f, n in zip(
            (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv), before)]
        visible = sp * (sp + 1) // 2 if causal else sp * sp
        assert launched == ([visible] * 3 if lane == "kernel" else [0] * 3)
        res.append([out.detach(), *grads])
    for name, got, ref in zip(("out", "dq", "dk", "dv"), *res):
        assert float((got - ref).abs().max()) <= TOL, name


def test_ring_flash_sp_step_on_cuda_matches_cpu(cuda):
    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.parallel.seq import StackedSeq
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lm import (
        build_lm_train_step, init_lm_state, make_model)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd

    cfg = TransformerConfig(vocab_size=96, d_model=128, n_layers=2,
                            n_heads=2, d_ff=256, attn_impl="ring_flash",
                            remat=True)
    sched = build_schedule(NPeerDynamicDirectedExponentialGraph(2))
    r = np.random.default_rng(1)
    batches = [tuple(torch.from_numpy(r.integers(0, 96, (2, 2, 2, 40)))
                     for _ in range(2)) for _ in range(2)]
    runs = []
    for dev in (cuda, torch.device("cpu")):
        alg = sgp(sched, StackedTransport(2))
        tx = sgd(0.9, 1e-4)
        step = build_lm_train_step(make_model(cfg), alg, tx,
                                   LRSchedule(0.5, 2, 2, {}), 10,
                                   seq=StackedSeq(2))
        state = init_lm_state(cfg, alg, tx, 2, seed=3, device=dev)
        before = tfa.flash_fwd.launches
        losses = []
        for toks, tgts in batches:
            state, m = step(state, toks.to(dev), tgts.to(dev))
            losses.append(m["loss"].cpu())
        # dp 2 x L 2 x 3 visible ticks, twice with remat, per step
        assert tfa.flash_fwd.launches - before == (
            2 * 2 * 2 * 3 * 2 if dev.type == "cuda" else 0)
        runs.append((state, torch.stack(losses)))
    (gs, gl), (cs, cl) = runs
    torch.testing.assert_close(gl, cl, rtol=1e-5, atol=0)
    assert torch.equal(gs.gossip.ps_weight.cpu(), cs.gossip.ps_weight)
    for n in cs.params:
        assert float((gs.params[n].cpu() - cs.params[n]).abs().max()) <= 1e-5


# -- bf16 -------------------------------------------------------------------


def _bf16_case(cuda, t, seed, b=2, h=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, h, t, 64, device=cuda,
                             generator=g).bfloat16() for _ in range(4))


# the last: batch*heads 65,532, near the kernels' grid limit (_MAX_BH)
BF16_SHAPES = [(1, 12, 8), (1, 12, 200), (8, 12, 1024), (2, 12, 1024),
               *((2, 3, t) for t in (1, 15, 16, 17, 63, 64, 65, 127, 128,
                                     129, 255, 257, 300, 1000)),
               (1, 1, 65), (1, 1, 1000), (5461, 12, 8)]


@pytest.mark.parametrize("b,h,t", BF16_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_kernels_match_plain(cuda, b, h, t, causal):
    q, k, v, do = _bf16_case(cuda, t, 60 + t, b=b, h=h)
    fns = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    before = [(f.launches, f.launches_bf16) for f in fns]
    out, lse = tfa.flash_fwd(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal)
    got = (out, tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in fns] == [
        (a, n + 1) for a, n in before]
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
    want = (ref, tfa.flash_bwd_dq_reference(*args),
            *tfa.flash_bwd_dkv_reference(*args))
    assert lse.dtype == torch.float32
    assert float((lse - ref_lse).abs().max()) <= TOL
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16
        if t == 1 and name in ("dq", "dk"):
            # exactly 0 (dS = P * (dP - delta) cancels): fp32 noise on
            # both sides
            assert max(float(x.float().abs().max()),
                       float(y.float().abs().max())) <= TOL, name
        else:
            assert tfa.bf16_close(x, y), (name, tfa.bf16_mismatch(x, y))


def test_flash_bf16_wrappers_refuse_mixed_types(cuda):
    q, k, v, do = _bf16_case(cuda, 64, 70)
    lse = torch.zeros(q.shape[:3], device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_fwd(q, k.float(), v)
    with pytest.raises(TypeError, match="lse must be torch.float32"):
        tfa.flash_bwd_dq(q, k, v, do, lse.bfloat16(), lse)
    with pytest.raises(TypeError, match="do must be torch.bfloat16"):
        tfa.flash_bwd_dkv(q, k, v, do.float(), lse, lse)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_autograd_on_cuda_matches_cpu_lane(cuda, causal):
    q, k, v, do = _bf16_case(cuda, 100, 71)
    res = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        out = tfa.flash_attention(*leaves, causal=causal)
        res.append([out.detach(),
                    *torch.autograd.grad(out, leaves, do.to(dev))])
    for got, ref in zip(*res):
        # the backward on each lane takes its own lane's rounded output
        assert got.dtype == torch.bfloat16
        assert tfa.bf16_close(got.cpu(), ref, parts=True), (
            tfa.bf16_mismatch(got.cpu(), ref, tfa.TOL_BF16_PARTS_FLOOR))


@pytest.mark.parametrize("sp,causal,b,h,t", [
    (4, True, 2, 3, 130), (4, False, 2, 3, 130), (2, True, 1, 1, 7)])
def test_ring_flash_bf16_kernel_lane_matches_plain_lane(cuda, sp, causal, b,
                                                        h, t):
    # (2, True, 1, 1, 7): shard 1's slice of the stacked fp32 lse and
    # delta starts 28 bytes in, off the kernels' 16-byte alignment
    from stochastic_gradient_push_torch.ops.ring_flash import (
        ring_flash_attention)
    from stochastic_gradient_push_torch.parallel.seq import StackedSeq

    g = torch.Generator(device=cuda).manual_seed(sp + t + 1)
    q, k, v, do = (torch.randn(sp, b, h, t, 64, device=cuda,
                               generator=g).bfloat16() for _ in range(4))
    seq = StackedSeq(sp)
    fns = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    res = []
    for lane in ("kernel", "plain"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = [(f.launches, f.launches_bf16) for f in fns]
        out = ring_flash_attention(*leaves, seq, causal=causal, lane=lane)
        grads = torch.autograd.grad(out, leaves, do)
        launched = [(f.launches - a, f.launches_bf16 - n)
                    for f, (a, n) in zip(fns, before)]
        visible = sp * (sp + 1) // 2 if causal else sp * sp
        assert launched == [(0, visible if lane == "kernel" else 0)] * 3
        res.append([out.detach(), *grads])
    for name, got, ref in zip(("out", "dq", "dk", "dv"), *res):
        assert got.dtype == torch.bfloat16
        assert tfa.bf16_close(got, ref, parts=True), (
            name, tfa.bf16_mismatch(got, ref, tfa.TOL_BF16_PARTS_FLOOR))


def test_bf16_lm_step_on_cuda_matches_cpu(cuda):
    """A world-2 SGP step of the LM at bf16 (flash) on the card against
    the same step on the CPU: no farther apart than twice the CPU's bf16
    step is from its fp32 step (the GEMMs round in bf16 at other places
    on the two devices), and the card's step at least half that distance
    from the CPU's fp32 step (bf16 ran on the card); the push-sum weight
    equal."""
    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lm import (
        build_lm_train_step, init_lm_state, make_model)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    r = np.random.default_rng(2)
    toks, tgts = (torch.from_numpy(r.integers(0, 96, (2, 2, 80)))
                  for _ in range(2))
    runs = {}
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.bfloat16),
                       ("cpu", torch.float32)):
        cfg = TransformerConfig(vocab_size=96, d_model=128, n_layers=2,
                                n_heads=2, d_ff=256, attn_impl="flash",
                                dtype=dtype)
        alg = sgp(build_schedule(NPeerDynamicDirectedExponentialGraph(2)),
                  StackedTransport(2))
        tx = sgd(0.9, 1e-4)
        step = build_lm_train_step(make_model(cfg), alg, tx,
                                   LRSchedule(0.5, 2, 2, {}), 10)
        state = init_lm_state(cfg, alg, tx, 2, seed=4, device=dev)
        before = tfa.flash_fwd.launches_bf16
        state, m = step(state, toks.to(dev), tgts.to(dev))
        assert tfa.flash_fwd.launches_bf16 - before == (
            2 * 2 if str(dev) != "cpu" else 0)
        runs[(str(dev) != "cpu", dtype)] = (state, m["loss"].cpu())
    (gs, gl), (cs, cl), (fs, fl) = (runs[(True, torch.bfloat16)],
                                    runs[(False, torch.bfloat16)],
                                    runs[(False, torch.float32)])
    assert float((gl - cl).abs().max()) <= 2 * float((cl - fl).abs().max())
    assert torch.equal(gs.gossip.ps_weight.cpu(), cs.gossip.ps_weight)

    def dist(a, b):
        return max(float((a.params[n].cpu() - b.params[n]).abs().max())
                   for n in b.params)

    assert dist(gs, cs) <= 2 * dist(cs, fs)
    assert dist(gs, fs) >= 0.5 * dist(cs, fs)
