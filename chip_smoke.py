#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Environment: torch, CUDA and nvcc versions, the card's name and power
   limit, and the time to build the kernels from
   ``stochastic_gradient_push_torch/csrc/`` (one ``nvcc`` per source,
   started together).
2. Every kernel against its plain PyTorch version on the card (fp32,
   TF32 off), max |kernel - plain| <= 1e-4, with the kernel's, the plain
   version's and one library call's times (CUDA events) and the bound:
   the flash forward (also its logsumexp), paged decode, and the two
   flash backward kernels (dQ, dK/dV) at B8 H12 T1024 causal and at a
   ragged t200, causal and full.  The flash kernels' bound is the card's
   best rate for fp32-accurate products: the tensor cores' TF32 rate
   over the three passes of the 3xTF32 split (their share is stated
   against it); the fp32 CUDA-core bound is printed beside it.  The
   paged decode's ``ms`` is CUDA events around back-to-back wrapper calls
   (the host's time included); its ``device_ms`` times the same calls,
   one per layer, captured in a CUDA graph and replayed; its
   ``host_ms`` is the host clock's time to issue one call.
   ``-Xptxas -v``'s registers and spills are printed per kernel; the
   flash and paged-decode kernels must report them and must not spill.
3. Serving main path at full width: ``LMEngine`` over the d768/L12/h12
   ff3072/vocab32000 LM (random weights from seed 0) serves 48 synthetic
   requests closed loop.  The launch counters are zeroed just before and
   read just after; every kernel must have launched, every request must
   complete, and the page table must be quiescent.
4. Teacher-forced check: the engine's prefill and per-step decode logits
   for two requests against the dense ``TransformerLM`` forward on the
   card, max |diff| <= 1e-3.
   Then the gossip transport kernels, ``gossip_edge_start`` (K2) and
   ``gossip_edge_wait`` (K1), bit-equal to their plain versions on the
   full-width packed payload of world 4 (the d768 LM's 134.3 M f32
   parameters per rank) for the f32, bf16 and int8 (block 64) wires at
   one and two edges, and on ragged payloads (n 300, chunk 128, int8
   blocks 7 and 64).
5. Training main path at the same width, T1024, B8, fp32: the port's
   ``build_lm_train_step`` with SGP at world 1 over the n-peer
   exponential graph.  One step on the kernel lane (``attn_impl=
   "flash"``) and one from the same state on the plain lane (``"full"``)
   must agree (loss 1e-5 relative, global grad norm 1e-4 relative,
   params 1e-6 absolute); then 6 kernel-lane steps with the counters
   zeroed just before: every attention forward and backward must have
   gone through the kernels (12 launches of each per step), every loss
   finite.  Per-step loss, median step ms and tokens/s are printed.
6. The same LM at world 4, the four ranks stacked on the card, over the
   n-peer exponential graph with the gossip kernel lane: SGP (int8 wire,
   one peer, one transport bucket), then OSGP (staleness 2, bf16 wire,
   two peers, three buckets).  Each first takes steps from one state on
   the kernel lane and on the plain transport lane (both with flash
   attention): the push-sum weight, and the in-flight FIFO's weights,
   bit-equal, params within 1e-6.  Then 5 kernel-lane steps with the
   counters zeroed just before: every start and wait went through the
   kernels (buckets per step each), every attention call too (4 ranks x
   12 layers per step), every loss finite; losses, median step ms,
   tokens/s and peak memory are printed.
7. A JSON line of per-kernel results (the flash rows also carry
   ``bound_fp32_cores_ms``, the CUDA-core bound; the paged-decode row
   ``device_ms`` and ``host_ms``), the ``nvidia-smi``
   name/power-limit line, and as the last line ``{"ok": true, "device":
   {...}}``.

Exits non-zero, before printing any result, without a CUDA device or
outside a checkout of the repository; any failed phase raises.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TOL_KERNEL = 1e-4
TOL_ENGINE = 1e-3
# kernel lane vs plain lane, one training step from one state
TOL_STEP_LOSS_REL = 1e-5
TOL_STEP_GNORM_REL = 1e-4
TOL_STEP_PARAM = 1e-6
TRAIN_STEPS = 6
GOSSIP_WORLD = 4
GOSSIP_STEPS = 5
GOSSIP_CHECKS = (("f32", 1), ("f32", 2), ("bf16", 1), ("bf16", 2),
                 ("int8", 1), ("int8", 2))
# H100 SXM data sheet: HBM rate, fp32 rate outside the tensor cores, TF32
# tensor-core rate (dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
# the flash kernels' 3xTF32 split: three tensor-core products per fp32 one,
# the card's best rate for fp32-accurate products
TF32_PASSES = 3
PEAK_3XTF32_FLOP_PER_S = PEAK_TF32_FLOP_PER_S / TF32_PASSES
HEAD_DIM = 64


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int, reps: int = 5) -> float:
    """Host time to issue one ``fn()``: the median over ``reps`` of the
    host clock around ``iters`` calls, synced before and after but not
    between them (the launch queue holds them, so no call waits on the
    device)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return statistics.median(times)


def _graph_ms(fns, replays: int) -> float:
    """Device time per call of ``fns``, with no host in the way: one CUDA
    graph holds one call of each (captured after a warm-up on a side
    stream), and CUDA events time its back-to-back replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * len(fns))


def _bound(nbytes: float, flops: float,
           flop_rate: float = PEAK_FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def report_ptxas(built: dict) -> None:
    """Print ``-Xptxas -v``'s registers, shared memory and spills per
    kernel (mangled names, as ptxas gives them); a flash or paged-decode
    library without that report, or a kernel of theirs that spills, fails
    the run."""
    for lib, info in built.items():
        kernel = lib
        checked = lib.startswith("flash") or lib == "paged_decode"
        if checked and "registers" not in info["log"]:
            raise AssertionError(f"no ptxas report for {lib}")
        for line in info["log"].splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif "registers" in line or "spill" in line:
                print(f"build {lib} {kernel}: {line.split(':')[-1].strip()}",
                      flush=True)
                spills = re.findall(r"(\d+) bytes spill", line)
                if checked and any(int(x) for x in spills):
                    raise AssertionError(f"{kernel} spills: {line.strip()}")


# -- phase 2: kernels against their plain versions ---------------------------


def check_flash(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from stochastic_gradient_push_torch.ops.flash_attention import (
        flash_attention_reference, flash_fwd)

    g = torch.Generator(device="cuda").manual_seed(1)
    row = None
    for b, t, causal in ((1, 8, True), (1, 200, True), (1, 512, True),
                         (1, 200, False), (8, 1024, True)):
        q, k, v = (torch.randn(b, 12, t, HEAD_DIM, device="cuda",
                               generator=g) for _ in range(3))
        ref, ref_lse = flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
        out, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        err = max(_max_err(flash_fwd(q, k, v, causal=causal), ref),
                  _max_err(out, ref))
        lse_err = _max_err(lse, ref_lse)
        if not (err <= TOL_KERNEL and lse_err <= TOL_KERNEL):
            raise AssertionError(f"flash_fwd b{b} t={t} causal={causal}: "
                                 f"max err {err} (out), {lse_err} (lse) "
                                 f"> {TOL_KERNEL}")
        ms = _time_ms(lambda: flash_fwd(q, k, v, causal=causal), 20)
        lse_ms = _time_ms(lambda: flash_fwd(q, k, v, causal=causal,
                                            return_lse=True), 20)
        plain_ms = _time_ms(
            lambda: flash_attention_reference(q, k, v, causal=causal), 5)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), 20)
        bh = b * 12
        pairs = t * (t + 1) // 2 if causal else t * t
        nbytes, flops = 4 * bh * t * HEAD_DIM * 4, 4 * bh * pairs * HEAD_DIM
        bound_ms, bound_by = _bound(nbytes, flops, PEAK_3XTF32_FLOP_PER_S)
        cores_ms = _bound(nbytes, flops)[0]
        print(f"kernel flash_fwd b{b} h12 t{t} d64 causal={causal}: max "
              f"err {err:.3e}, lse err {lse_err:.3e}, kernel {ms:.4f} ms "
              f"({lse_ms:.4f} ms with lse), plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, 3xTF32 bound {bound_ms:.4f} ms ({bound_by};"
              f" {bound_ms / ms:.1%} of it), fp32 CUDA-core bound "
              f"{cores_ms:.4f} ms [{card}]", flush=True)
        if (b, t) == (1, 512):   # the longest prompt serving prefills
            row = dict(max_abs_err=max(err, lse_err), ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=lib_ms,
                       bound_fp32_cores_ms=cores_ms)
    return row


def check_flash_bwd(card: str) -> dict:
    """Both backward kernels against their plain versions, fed the
    forward kernel's out and lse (as the training step feeds them)."""
    import torch
    import torch.nn.functional as F

    from stochastic_gradient_push_torch.ops.flash_attention import (
        flash_bwd_dkv, flash_bwd_dkv_reference, flash_bwd_dq,
        flash_bwd_dq_reference, flash_fwd)

    g = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for b, t, causal in ((8, 1024, True), (1, 200, True), (1, 200, False)):
        q, k, v, do = (torch.randn(b, 12, t, HEAD_DIM, device="cuda",
                                   generator=g) for _ in range(4))
        out, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        delta = (do * out).sum(-1)
        args = (q, k, v, do, lse, delta, causal)
        dq_err = _max_err(flash_bwd_dq(*args), flash_bwd_dq_reference(*args))
        dkv_err = max(_max_err(a, r) for a, r in zip(
            flash_bwd_dkv(*args), flash_bwd_dkv_reference(*args)))
        if not (dq_err <= TOL_KERNEL and dkv_err <= TOL_KERNEL):
            raise AssertionError(f"flash_bwd b{b} t={t} causal={causal}: "
                                 f"max err dq {dq_err}, dk/dv {dkv_err} > "
                                 f"{TOL_KERNEL}")
        dq_ms = _time_ms(lambda: flash_bwd_dq(*args), 20)
        dkv_ms = _time_ms(lambda: flash_bwd_dkv(*args), 20)
        dq_plain = _time_ms(lambda: flash_bwd_dq_reference(*args), 5)
        dkv_plain = _time_ms(lambda: flash_bwd_dkv_reference(*args), 5)
        # library yardstick: SDPA forward + backward less its forward;
        # one call computes dq, dk and dv together
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))

        def sdpa_fb():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            torch.autograd.grad(o, (qs, ks, vs), do)

        def sdpa_f():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

        lib_ms = _time_ms(sdpa_fb, 20) - _time_ms(sdpa_f, 20)
        bh = b * 12
        pairs = t * (t + 1) // 2 if causal else t * t
        rows_in = 4 * bh * t * HEAD_DIM * 4 + 2 * bh * t * 4  # q k v do lse δ
        row_out = bh * t * HEAD_DIM * 4
        dq_work = (rows_in + row_out, 6 * bh * pairs * HEAD_DIM)
        dkv_work = (rows_in + 2 * row_out, 8 * bh * pairs * HEAD_DIM)
        dq_bound = _bound(*dq_work, PEAK_3XTF32_FLOP_PER_S)
        dkv_bound = _bound(*dkv_work, PEAK_3XTF32_FLOP_PER_S)
        dq_cores, dkv_cores = _bound(*dq_work)[0], _bound(*dkv_work)[0]
        print(f"kernel flash_bwd b{b} h12 t{t} d64 causal={causal}: dq max "
              f"err {dq_err:.3e}, kernel {dq_ms:.4f} ms, plain "
              f"{dq_plain:.4f} ms, 3xTF32 bound {dq_bound[0]:.4f} ms "
              f"({dq_bound[1]}; {dq_bound[0] / dq_ms:.1%} of it), fp32 "
              f"CUDA-core bound {dq_cores:.4f} ms; dk/dv max err "
              f"{dkv_err:.3e}, kernel {dkv_ms:.4f} ms, plain {dkv_plain:.4f} "
              f"ms, 3xTF32 bound {dkv_bound[0]:.4f} ms ({dkv_bound[1]}; "
              f"{dkv_bound[0] / dkv_ms:.1%} of it), fp32 CUDA-core bound "
              f"{dkv_cores:.4f} ms; sdpa backward {lib_ms:.4f} ms [{card}]",
              flush=True)
        if (b, t) == (8, 1024):   # the training main path's shape
            rows["flash_bwd_dq"] = dict(
                max_abs_err=dq_err, ms=dq_ms, plain_ms=dq_plain,
                bound_ms=dq_bound[0], bound_by=dq_bound[1],
                library_ms=lib_ms, bound_fp32_cores_ms=dq_cores)
            rows["flash_bwd_dkv"] = dict(
                max_abs_err=dkv_err, ms=dkv_ms, plain_ms=dkv_plain,
                bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
                library_ms=lib_ms, bound_fp32_cores_ms=dkv_cores)
    return rows


def _paged_case(g, hq: int, hkv: int, batch=16, page=16, max_pages=48,
                num_pages=1024, layers=12):
    """A full-size cache ([layers, hkv, num_pages + 1, page, d], as the
    engine holds it), distinct random page ids per row (non-contiguous),
    random lengths in [1, max_pages * page] including both ends."""
    import torch

    shape = (layers, hkv, num_pages + 1, page, HEAD_DIM)
    kc = torch.randn(shape, device="cuda", generator=g)
    vc = torch.randn(shape, device="cuda", generator=g)
    q = torch.randn(batch, hq, HEAD_DIM, device="cuda", generator=g)
    pi = torch.stack([torch.randperm(num_pages, device="cuda",
                                     generator=g)[:max_pages]
                      for _ in range(batch)]).to(torch.int32)
    lengths = torch.randint(1, max_pages * page + 1, (batch,), device="cuda",
                            generator=g, dtype=torch.int32)
    lengths[0], lengths[1] = 1, max_pages * page
    return q, kc, vc, pi, lengths


def check_paged(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from stochastic_gradient_push_torch.serve.paged_attention import (
        paged_attention_reference, paged_decode)

    g = torch.Generator(device="cuda").manual_seed(2)
    row = None
    for hq, hkv in ((12, 12), (12, 6)):
        q, kc, vc, pi, lengths = _paged_case(g, hq, hkv)
        layers = kc.shape[0]
        err = max(_max_err(paged_decode(q, kc[i], vc[i], pi, lengths),
                           paged_attention_reference(q, kc[i], vc[i], pi,
                                                     lengths))
                  for i in range(layers))
        if not err <= TOL_KERNEL:
            raise AssertionError(f"paged_decode Hq{hq} Hkv{hkv}: max err "
                                 f"{err} > {TOL_KERNEL}")
        # each timed call reads the next layer's pool, as a decode tick
        # does, so the 50 MB L2 does not hold the previous call's pages
        it = iter(range(10 ** 9))

        def kern():
            i = next(it) % layers
            paged_decode(q, kc[i], vc[i], pi, lengths)

        def plain():
            i = next(it) % layers
            paged_attention_reference(q, kc[i], vc[i], pi, lengths)

        ms = _time_ms(kern, 10 * layers)
        host_ms = _host_ms(kern, 10 * layers)
        # the same calls without the host: one per layer in a CUDA graph
        device_ms = _graph_ms([
            lambda i=i: paged_decode(q, kc[i], vc[i], pi, lengths)
            for i in range(layers)], 10)
        plain_ms = _time_ms(plain, 2 * layers)
        # library yardstick: SDPA over the pages gathered beforehand
        b, t = q.shape[0], pi.shape[1] * kc.shape[3]
        idx = pi.long()
        kg = kc[0][:, idx].movedim(1, 0).reshape(b, hkv, t, HEAD_DIM)
        vg = vc[0][:, idx].movedim(1, 0).reshape(b, hkv, t, HEAD_DIM)
        if hq != hkv:
            kg = kg.repeat_interleave(hq // hkv, dim=1)
            vg = vg.repeat_interleave(hq // hkv, dim=1)
        mask = (torch.arange(t, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kg, vg, attn_mask=mask), 50)
        tokens = int(lengths.sum())
        nbytes = (2 * tokens * hkv * HEAD_DIM * 4 + 2 * q.numel() * 4
                  + pi.numel() * 4 + lengths.numel() * 4)
        bound_ms, bound_by = _bound(nbytes, 4 * tokens * hq * HEAD_DIM)
        print(f"kernel paged_decode B16 Hq{hq} Hkv{hkv} d64 page16 "
              f"max_pages48 ({tokens} cached tokens): max err {err:.3e}, "
              f"kernel {ms:.4f} ms ({device_ms:.4f} ms device, in a CUDA "
              f"graph; {host_ms:.4f} ms host to issue), plain "
              f"{plain_ms:.4f} ms, sdpa over gathered pages {lib_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) [{card}]", flush=True)
        if hq == hkv:   # the engine's shape: group 1
            row = dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                       host_ms=host_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms)
    return row


def _lm_config(attn_impl: str = "full"):
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)

    return TransformerConfig(vocab_size=32000, d_model=768, n_layers=12,
                             n_heads=12, d_ff=3072, attn_impl=attn_impl)


def _gossip_case(g, wire: str, ne: int, ranks: int, leaf_shapes=None,
                 n: int | None = None, chunk_elems: int | None = None):
    """Encoded parts ``[R, E, ...]`` of one transport bucket on the card:
    every leaf of ``leaf_shapes`` packed as the kernel lane packs them
    (int8 leaves padded to whole blocks, the bucket to the chunk
    layout), or one ragged payload of ``n``.  Random wire values."""
    import torch

    from stochastic_gradient_push_torch.ops import gossip_kernel as gk
    from stochastic_gradient_push_torch.parallel import collectives
    from stochastic_gradient_push_torch.parallel.wire import get_codec

    spec = get_codec(wire, 7 if n is not None and ne == 2 else 64
                     ).kernel_spec()
    lane = gk.KernelLane(chunk_elems=chunk_elems or gk.DEFAULT_CHUNK_ELEMS)
    if n is None:
        leaves = [torch.empty((ranks,) + s, device="meta")
                  for s in leaf_shapes]
        (bucket,) = collectives._transport_plan(leaves, spec, 1)
        n, length = collectives._bucket_len(bucket, spec, lane)
    else:
        length = gk.padded_len(spec, n, lane.chunk_elems)
    if wire == "int8":
        parts = (torch.randint(-127, 128, (ranks, ne, length // spec.block,
                                           spec.block), device="cuda",
                               generator=g, dtype=torch.int8),
                 torch.rand(ranks, ne, length // spec.block, device="cuda",
                            generator=g) * 0.02)
    else:
        x = torch.randn(ranks, ne, length, device="cuda", generator=g)
        parts = (x.to(torch.bfloat16) if wire == "bf16" else x,)
    acc = torch.randn(ranks, length, device="cuda", generator=g)
    return spec, lane, parts, acc, n


def check_gossip(card: str) -> dict:
    """K2 and K1 bit-equal to their plain versions on the full-width
    packed payload at world 4 and on ragged payloads, with times."""
    import torch

    from stochastic_gradient_push_torch.ops import gossip_kernel as gk
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lm import make_model

    g = torch.Generator(device="cuda").manual_seed(4)
    shapes = [tuple(p.shape) for p in make_model(_lm_config()).parameters()]
    per_rank = sum(math.prod(s) for s in shapes)
    rows = {}
    # the full-width cases, then the ragged ones (int8 block 64 at one
    # edge, block 7 at two)
    for i, (wire, ne) in enumerate(GOSSIP_CHECKS * 2):
        ragged = i >= len(GOSSIP_CHECKS)
        dests = build_schedule(NPeerDynamicDirectedExponentialGraph(
            GOSSIP_WORLD, peers_per_itr=ne)).perms[0]
        if ragged:
            spec, lane, parts, acc, n = _gossip_case(
                g, wire, ne, GOSSIP_WORLD, n=300, chunk_elems=128)
        else:
            spec, lane, parts, acc, n = _gossip_case(g, wire, ne,
                                                     GOSSIP_WORLD, shapes)

        def start():
            return gk.gossip_edge_start(parts, dests, spec, n_decoded=n,
                                        chunk_elems=lane.chunk_elems)

        handle = start()
        chunks = tuple(p.reshape(h.shape) for p, h in zip(parts,
                                                          handle.recv))
        plain_landed = gk.gossip_edge_start_reference(chunks, dests)
        out = gk.gossip_edge_wait(handle, acc)
        _, _, _, c, nb, _, _ = handle.meta
        plain_out = gk.gossip_edge_wait_reference(
            acc.reshape(GOSSIP_WORLD, nb, c), handle.recv, spec.kind
        ).reshape(acc.shape)
        torch.cuda.synchronize()
        label = (f"{wire}{'/block' + str(spec.block) if spec.block else ''}"
                 f" E{ne} R{GOSSIP_WORLD} n{n}")
        start_err = max(_max_err(a, b) for a, b in zip(handle.recv,
                                                        plain_landed))
        wait_err = _max_err(out, plain_out)
        if not all(torch.equal(a, b) for a, b in zip(handle.recv,
                                                      plain_landed)):
            raise AssertionError(f"gossip_edge_start {label}: landed bytes "
                                 f"differ from the plain version (max err "
                                 f"{start_err})")
        if not torch.equal(out, plain_out):
            raise AssertionError(
                f"gossip_edge_wait {label}: max err {wait_err}, want "
                f"bit-equal")
        if ragged:
            print(f"kernel gossip ragged {label}: start and wait bit-equal "
                  f"to plain [{card}]", flush=True)
            continue
        part_bytes = sum(p.numel() * p.element_size() for p in parts)
        acc_bytes = acc.numel() * 4
        start_ms = _time_ms(start, 10)
        start_plain = _time_ms(
            lambda: gk.gossip_edge_start_reference(chunks, dests), 3)
        # library yardstick: one index_select over the (rank, edge) rows
        # per wire part (one call for f32/bf16, two for int8's q and
        # scales)
        src = torch.tensor([int(dests[e].tolist().index(r)) * ne + e
                            for r in range(GOSSIP_WORLD) for e in range(ne)],
                           device="cuda")
        start_lib = _time_ms(lambda: [p.reshape(GOSSIP_WORLD * ne, -1)
                                      .index_select(0, src) for p in parts],
                             10)
        wait_ms = _time_ms(lambda: gk.gossip_edge_wait(handle, acc), 10)
        wait_plain = _time_ms(lambda: gk.gossip_edge_wait_reference(
            acc.reshape(GOSSIP_WORLD, nb, c), handle.recv, spec.kind), 3)
        wait_lib = None
        if spec.kind in ("f32", "bf16") and ne == 1:
            recv0 = handle.recv[0].reshape(acc.shape)
            wait_lib = _time_ms(lambda: torch.add(acc, recv0), 10)
        sb = _bound(2 * part_bytes, 0)
        wb = _bound(2 * acc_bytes + part_bytes,
                    acc.numel() * ne * (2 if spec.kind == "int8" else 1))
        print(f"kernel gossip {label}: bit-equal; start {start_ms:.4f} ms, "
              f"plain {start_plain:.4f} ms, index_select {start_lib:.4f} "
              f"ms, bound {sb[0]:.4f} ms ({sb[1]}); wait {wait_ms:.4f} ms, "
              f"plain {wait_plain:.4f} ms, add "
              f"{'n/a' if wait_lib is None else f'{wait_lib:.4f} ms'}, bound "
              f"{wb[0]:.4f} ms ({wb[1]}) [{card}]", flush=True)
        rows[(wire, ne)] = {
            "gossip_edge_start": dict(
                max_abs_err=start_err, ms=start_ms, plain_ms=start_plain,
                bound_ms=sb[0], bound_by=sb[1],
                library_ms=start_lib if spec.kind != "int8" else None),
            "gossip_edge_wait": dict(
                max_abs_err=wait_err, ms=wait_ms, plain_ms=wait_plain,
                bound_ms=wb[0], bound_by=wb[1], library_ms=wait_lib)}
        del handle, chunks, plain_landed, out, plain_out, parts, acc
        torch.cuda.empty_cache()
    if per_rank < 134_000_000:
        raise AssertionError(f"payload {per_rank} per rank, want the d768 "
                             f"LM's ~134.3 M")
    return rows


# -- phase 3: the serving main path -----------------------------------------


class _TimedEngine:
    """Host-clock totals of the engine's prefill (``start``) and decode
    (``step``) calls; both end in a device-to-host read, so the clock
    sees the device work."""

    def __init__(self, engine):
        self._engine = engine
        self.seconds = {"prefill": 0.0, "decode": 0.0}

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def start(self, prompt, budget_tokens):
        t0 = time.perf_counter()
        out = self._engine.start(prompt, budget_tokens)
        self.seconds["prefill"] += time.perf_counter() - t0
        return out

    def step(self, slots):
        t0 = time.perf_counter()
        out = self._engine.step(slots)
        self.seconds["decode"] += time.perf_counter() - t0
        return out


def main_path(card: str):
    import torch

    from stochastic_gradient_push_torch.models.convert import init_params
    from stochastic_gradient_push_torch.models.transformer import (
        TransformerConfig)
    from stochastic_gradient_push_torch.ops.flash_attention import flash_fwd
    from stochastic_gradient_push_torch.serve.bench import (
        run_bench, synthetic_requests)
    from stochastic_gradient_push_torch.serve.engine import (
        LMEngine, ServeConfig)
    from stochastic_gradient_push_torch.serve.paged_attention import (
        paged_decode)

    cfg = TransformerConfig(vocab_size=32000, d_model=768, n_layers=12,
                            n_heads=12, d_ff=3072)
    t0 = time.perf_counter()
    engine = LMEngine(init_params(cfg, seed=0), ServeConfig(
        n_heads=12, page_size=16, num_pages=1024, max_seqs=16,
        max_pages_per_seq=48), device="cuda")
    torch.cuda.synchronize()
    print(f"main: engine d{cfg.d_model} L{cfg.n_layers} h{cfg.n_heads} "
          f"ff{cfg.d_ff} vocab{cfg.vocab_size} built in "
          f"{time.perf_counter() - t0:.2f} s; weights "
          f"{sum(p.numel() for p in engine.model.parameters()) * 4 / 1e9:.3f}"
          f" GB, KV pool {2 * engine._kc.numel() * 4 / 1e9:.3f} GB", flush=True)
    requests = synthetic_requests(48, seed=0, vocab=256,
                                  prompt_tokens=(64, 512),
                                  new_tokens=(16, 128))
    timed = _TimedEngine(engine)
    flash_fwd.launches = paged_decode.launches = 0
    metrics, completions = run_bench(timed, requests)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                "paged_decode": paged_decode.launches}
    print("main: summarize " + json.dumps(metrics, sort_keys=True),
          flush=True)
    print(f"main: launches {json.dumps(launches)}; host time prefill "
          f"{timed.seconds['prefill']:.4f} s, decode "
          f"{timed.seconds['decode']:.4f} s of {metrics['elapsed_s']:.4f} s "
          f"[{card}]", flush=True)
    by_rid = {r.rid: r for r in requests}
    if len(completions) != len(requests):
        raise AssertionError(f"{len(completions)} of {len(requests)} "
                             f"requests completed")
    for c in completions:
        if len(c.tokens) != by_rid[c.rid].max_new_tokens:
            raise AssertionError(f"request {c.rid}: {len(c.tokens)} tokens,"
                                 f" wanted {by_rid[c.rid].max_new_tokens}")
    engine.pages.assert_quiescent()
    want = {"flash_fwd": cfg.n_layers * len(requests),
            "paged_decode": cfg.n_layers * metrics["decode_steps"]}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"launches {launches}, expected {want}")
    return engine, requests, launches


def engine_vs_dense(engine, requests, card: str) -> None:
    """Two requests decoded side by side through the kernels, each
    step's logits held against the dense model (plain attention) fed
    the same tokens."""
    import torch

    worst = 0.0
    reqs = requests[:2]
    n_new = 16
    runs = {}
    for r in reqs:
        slot, tok = engine.start(list(r.prompt), len(r.prompt) + n_new)
        runs[slot] = (r, [tok], [engine.last_logits.clone()])
    while any(len(toks) < n_new for _, toks, _ in runs.values()):
        step = engine.step(sorted(runs))
        for slot, tok in step.items():
            runs[slot][1].append(tok)
            runs[slot][2].append(engine.last_logits[slot].clone())
    for slot, (r, toks, logits) in runs.items():
        engine.finish(slot)
        seq = list(r.prompt) + toks[:-1]
        with torch.no_grad():
            dense = engine.model(torch.tensor([seq], device="cuda"))[0]
        t = len(r.prompt)
        worst = max(worst, _max_err(logits[0], dense[:t]))
        for j, lg in enumerate(logits[1:]):
            worst = max(worst, _max_err(lg, dense[t + j]))
    engine.pages.assert_quiescent()
    print(f"engine vs dense: 2 requests x {n_new} tokens teacher-forced, "
          f"max |logit diff| {worst:.3e} (tolerance {TOL_ENGINE}) [{card}]",
          flush=True)
    if not worst <= TOL_ENGINE:
        raise AssertionError(f"engine logits off the dense model by {worst}")


# -- phase 5: the training main path ----------------------------------------


def _train_setup(attn_impl: str, world: int = 1, wire=None,
                 overlap: bool = False, staleness: int = 1, peers: int = 1,
                 buckets: int = 1, gossip_kernel=None):
    """The training main path: the d768/L12 LM's step with SGP (or OSGP
    with ``overlap``) over the n-peer exponential graph at ``world``
    ranks stacked on the card."""
    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.parallel.wire import get_codec
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lm import (
        build_lm_train_step, make_model)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd

    cfg = _lm_config(attn_impl)
    alg = sgp(build_schedule(NPeerDynamicDirectedExponentialGraph(
        world, peers_per_itr=peers)), StackedTransport(world),
        wire=get_codec(wire), overlap=overlap, staleness=staleness,
        gossip_kernel=gossip_kernel, gossip_buckets=buckets)
    tx = sgd(momentum=0.9, weight_decay=0.0)
    step = build_lm_train_step(
        make_model(cfg), alg, tx, LRSchedule(3e-2, 8, world,
                                             decay_schedule={}),
        itr_per_epoch=1000)
    return cfg, alg, tx, step


def train_path(card: str) -> dict:
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.ops.flash_attention import (
        flash_bwd_dkv, flash_bwd_dq, flash_fwd)
    from stochastic_gradient_push_torch.serve.paged_attention import (
        paged_decode)
    from stochastic_gradient_push_torch.train.lm import init_lm_state

    cfg, alg, tx, step = _train_setup("flash")
    _, _, _, plain_step = _train_setup("full")
    state = init_lm_state(cfg, alg, tx, 1, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, 8, 1024))).cuda() for _ in range(2))
        for _ in range(TRAIN_STEPS + 1)]
    n_params = sum(p[0].numel() for p in state.params.values())
    print(f"train: SGP world 1, d{cfg.d_model} L{cfg.n_layers} "
          f"h{cfg.n_heads} ff{cfg.d_ff} vocab{cfg.vocab_size} T1024 B8 fp32, "
          f"{n_params / 1e6:.2f}M params", flush=True)

    # one step on each lane from the same state
    k_state, k_m = step(state, *batches[0])
    p_state, p_m = plain_step(state, *batches[0])
    torch.cuda.synchronize()
    loss_k, loss_p = float(k_m["loss"][0]), float(p_m["loss"][0])
    gn_k, gn_p = float(k_m["grad_norm"][0]), float(p_m["grad_norm"][0])
    param_err = max(_max_err(k_state.params[n], p_state.params[n])
                    for n in k_state.params)
    del p_state, state
    print(f"train: kernel lane vs plain lane, one step: loss {loss_k:.6f} "
          f"vs {loss_p:.6f}, grad norm {gn_k:.6f} vs {gn_p:.6f}, max "
          f"|param diff| {param_err:.3e} (tolerances {TOL_STEP_LOSS_REL} "
          f"rel, {TOL_STEP_GNORM_REL} rel, {TOL_STEP_PARAM}) [{card}]",
          flush=True)
    if not (abs(loss_k - loss_p) <= TOL_STEP_LOSS_REL * abs(loss_p)
            and abs(gn_k - gn_p) <= TOL_STEP_GNORM_REL * abs(gn_p)
            and param_err <= TOL_STEP_PARAM):
        raise AssertionError("kernel-lane and plain-lane steps disagree")

    # the main path: kernel-lane steps, counters zeroed just before
    state = k_state
    flash_fwd.launches = flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = paged_decode.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for toks, tgts in batches[1:]:
        t0 = time.perf_counter()
        state, m = step(state, toks, tgts)
        losses.append(float(m["loss"][0]))   # waits for the step
        step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                "flash_bwd_dq": flash_bwd_dq.launches,
                "flash_bwd_dkv": flash_bwd_dkv.launches,
                "paged_decode": paged_decode.launches}
    med_ms = float(np.median(step_s)) * 1e3
    print(f"train: {TRAIN_STEPS} steps, losses "
          f"{json.dumps([round(x, 6) for x in losses])}, step ms "
          f"{json.dumps([round(x * 1e3, 2) for x in step_s])}, median "
          f"{med_ms:.2f} ms, {8 * 1024 / med_ms * 1e3:.1f} tokens/s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{card}]", flush=True)
    print(f"train: launches {json.dumps(launches)}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss {losses}")
    want = {"flash_fwd": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS, "paged_decode": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return launches


def _counters():
    from stochastic_gradient_push_torch.ops.flash_attention import (
        flash_bwd_dkv, flash_bwd_dq, flash_fwd)
    from stochastic_gradient_push_torch.ops.gossip_kernel import (
        gossip_edge_start, gossip_edge_wait)
    from stochastic_gradient_push_torch.serve.paged_attention import (
        paged_decode)

    return {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv, "paged_decode": paged_decode,
            "gossip_edge_start": gossip_edge_start,
            "gossip_edge_wait": gossip_edge_wait}


def gossip_train_path(card: str, label: str, wire: str, overlap: bool,
                      staleness: int, peers: int, buckets: int,
                      compare_steps: int) -> dict:
    """World 4 stacked on the card on the gossip kernel lane: steps from
    one state against the plain transport lane, then the main path."""
    import numpy as np
    import torch

    from stochastic_gradient_push_torch.ops.gossip_kernel import KernelLane
    from stochastic_gradient_push_torch.train.lm import init_lm_state

    kw = dict(world=GOSSIP_WORLD, wire=wire, overlap=overlap,
              staleness=staleness, peers=peers, buckets=buckets)
    cfg, alg, tx, step = _train_setup("flash", gossip_kernel=KernelLane(),
                                      **kw)
    _, plain_alg, _, plain_step = _train_setup("flash", **kw)
    if (alg.transport_kernel_name, plain_alg.transport_kernel_name) != (
            "pallas", "xla"):
        raise AssertionError("the two lanes did not resolve as asked")
    rng = np.random.default_rng(1)
    batches = [tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(GOSSIP_WORLD, 8, 1024))).cuda()
        for _ in range(2)) for _ in range(compare_steps + GOSSIP_STEPS)]
    state = init_lm_state(cfg, alg, tx, GOSSIP_WORLD, seed=0, device="cuda")
    print(f"train {label}: world {GOSSIP_WORLD} stacked, d{cfg.d_model} "
          f"L{cfg.n_layers} T1024 B8/rank, {wire} wire, peers {peers}, "
          f"buckets {buckets}, overlap {overlap} staleness {staleness}",
          flush=True)

    # the kernel lane and the plain transport lane from one state
    k_state, p_state = state, state
    for toks, tgts in batches[:compare_steps]:
        k_state, k_m = step(k_state, toks, tgts)
        p_state, p_m = plain_step(p_state, toks, tgts)
    torch.cuda.synchronize()
    weights = [(k_state.gossip.ps_weight, p_state.gossip.ps_weight)] + [
        (ks[1], ps[1]) for ks, ps in zip(k_state.gossip.in_flight,
                                         p_state.gossip.in_flight)]
    param_err = max(_max_err(k_state.params[n], p_state.params[n])
                    for n in k_state.params)
    fifo_err = max([_max_err(ks[0][n], ps[0][n])
                    for ks, ps in zip(k_state.gossip.in_flight,
                                      p_state.gossip.in_flight)
                    for n in ks[0]] or [0.0])
    loss_k, loss_p = k_m["loss"].tolist(), p_m["loss"].tolist()
    print(f"train {label}: kernel lane vs plain lane, {compare_steps} "
          f"step(s) from one state: losses {loss_k} vs {loss_p}; ps-weight "
          f"{k_state.gossip.ps_weight.tolist()} vs "
          f"{p_state.gossip.ps_weight.tolist()}; max |param diff| "
          f"{param_err:.3e}, in-flight {fifo_err:.3e} (tolerance "
          f"{TOL_STEP_PARAM}) [{card}]", flush=True)
    if not all(torch.equal(a, b) for a, b in weights):
        raise AssertionError(f"{label}: push-sum weights differ between "
                             f"the lanes")
    if not (param_err <= TOL_STEP_PARAM and fifo_err <= TOL_STEP_PARAM):
        raise AssertionError(f"{label}: params differ between the lanes")
    del p_state, state, plain_step
    torch.cuda.empty_cache()

    # the main path: kernel-lane steps, counters zeroed just before
    state = k_state
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for toks, tgts in batches[compare_steps:]:
        t0 = time.perf_counter()
        state, m = step(state, toks, tgts)
        losses.append(m["loss"].tolist())   # waits for the step
        step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    med_ms = float(np.median(step_s)) * 1e3
    tokens = GOSSIP_WORLD * 8 * 1024
    print(f"train {label}: {GOSSIP_STEPS} steps, losses per rank "
          f"{json.dumps([[round(x, 6) for x in r] for r in losses])}, step "
          f"ms {json.dumps([round(x * 1e3, 2) for x in step_s])}, median "
          f"{med_ms:.2f} ms, {tokens / med_ms * 1e3:.1f} tokens/s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{card}]", flush=True)
    print(f"train {label}: launches {json.dumps(launches)}", flush=True)
    if not all(np.isfinite(losses).ravel()):
        raise AssertionError(f"{label}: non-finite training loss {losses}")
    # post_step waits every launched bucket once per step: the head slot
    # it lands is the one just launched at staleness 1 (a synchronous
    # round waits at once too); at staleness >= 2 the head slot is a
    # plain share settled a step earlier, and the wait is the settle of
    # the slot launched this step
    landed = 1 if staleness == 1 else 0
    settled = 0 if staleness == 1 else 1
    attn = GOSSIP_WORLD * cfg.n_layers * GOSSIP_STEPS
    want = {"flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
            "paged_decode": 0, "gossip_edge_start": buckets * GOSSIP_STEPS,
            "gossip_edge_wait": buckets * (landed + settled) * GOSSIP_STEPS}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stochastic_gradient_push_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    nvcc = _run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, nvcc {nvcc!r}, "
          f"{torch.cuda.device_count()} device(s), {smi}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    report_ptxas(built)

    flash_row = check_flash(card)
    paged_row = check_paged(card)
    bwd_rows = check_flash_bwd(card)
    gossip_rows = check_gossip(card)
    engine, requests, launches = main_path(card)
    engine_vs_dense(engine, requests, card)
    del engine
    torch.cuda.empty_cache()
    train_launches = train_path(card)
    torch.cuda.empty_cache()
    sgp_launches = gossip_train_path(card, "sgp", "int8", False, 1, 1, 1, 1)
    torch.cuda.empty_cache()
    osgp_launches = gossip_train_path(card, "osgp", "bf16", True, 2, 2, 3, 2)

    # launches: each main path's run (serving, training at world 1, SGP
    # and OSGP at world 4) summed
    def total(name):
        return sum(run.get(name, 0) for run in (
            launches, train_launches, sgp_launches, osgp_launches))

    flash = "stochastic_gradient_push_tpu/ops/flash_attention.py"
    bwd_src = "stochastic_gradient_push_torch/csrc/flash_bwd.cu"
    gossip = "stochastic_gradient_push_tpu/ops/gossip_kernel.py"
    gossip_src = "stochastic_gradient_push_torch/csrc/gossip_edge.cu"
    # the gossip rows at the OSGP main path's wire (bf16, two edges), on
    # the whole payload in one bucket
    gossip_row = gossip_rows[("bf16", 2)]
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="stochastic_gradient_push_torch/csrc/flash_fwd.cu",
             replaces=f"{flash}:110", launches=total("flash_fwd"),
             **flash_row),
        dict(name="paged_decode", route="cuda",
             source="stochastic_gradient_push_torch/csrc/paged_decode.cu",
             replaces="stochastic_gradient_push_tpu/serve/"
                      "paged_attention.py:113",
             launches=total("paged_decode"), **paged_row),
        dict(name="flash_bwd_dq", route="cuda", source=bwd_src,
             replaces=f"{flash}:227", launches=total("flash_bwd_dq"),
             **bwd_rows["flash_bwd_dq"]),
        dict(name="flash_bwd_dkv", route="cuda", source=bwd_src,
             replaces=f"{flash}:270", launches=total("flash_bwd_dkv"),
             **bwd_rows["flash_bwd_dkv"]),
        dict(name="gossip_edge_start", route="cuda", source=gossip_src,
             replaces=f"{gossip}:295", launches=total("gossip_edge_start"),
             **gossip_row["gossip_edge_start"]),
        dict(name="gossip_edge_wait", route="cuda", source=gossip_src,
             replaces=f"{gossip}:513", launches=total("gossip_edge_wait"),
             **gossip_row["gossip_edge_wait"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
