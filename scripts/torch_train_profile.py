#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training steps, on one GPU.

    python3 scripts/torch_train_profile.py [--steps 5] [--out PATH]
    python3 scripts/torch_train_profile.py --world_size 4 \\
        --gossip_kernel pallas --wire_dtype int8 [--overlap True \\
        --staleness 2 --peers_per_itr 2 --gossip_buckets 3]
    python3 scripts/torch_train_profile.py --model resnet50 --world_size 4 \\
        --gossip_kernel pallas [--dtype bf16 --batch 128] [--push_sum False]
        [--wire_dtype int8 --error_feedback True --inject_faults SPEC]
    python3 scripts/torch_train_profile.py --sp 4 [--remat True]
    python3 scripts/torch_train_profile.py [--sp 4] --precision bf16

Builds the training main path of ``chip_smoke.py`` (the d768/L12/h12/
ff3072/vocab32000 LM, T1024, B8 per rank, fp32 with TF32 off; SGP or
OSGP over the n-peer exponential graph, ``--world_size`` ranks stacked
on the card; ``attn_impl="flash"``; random weights and tokens from seed
0), takes two warm-up steps, then measures ``--steps`` steps from one
state: the host-clock mean per step, then the same steps under
``torch.profiler``: device time by kernel, the device's busy share of
the window (kernel time / window wall time), the flash kernels' share
and, at world > 1, the gossip kernels' share of the device time.

``--model resnet50`` profiles ``chip_smoke.py``'s ResNet main path
instead (ResNet-50, 224 px, 1000 classes, ``--batch`` images a rank,
``--dtype`` fp32 with TF32 off or bf16, synthetic images from seed 0,
``train/step.py``'s step, every step a fired round; D-PSGD with
``--push_sum False``): the device time split into convolutions (cuDNN),
the gossip kernels and the rest (BatchNorm, ReLU, pooling, SGD and the
round's elementwise work).

``--sp 4`` profiles ``chip_smoke.py``'s phase-11 path instead: the same
LM at world 8 stacked = dp 2 x sp 4, T4096 in 1024-token shards, batch
2 a replica, ``ring_flash`` attention (``--remat True`` recomputes each
block), SGP f32 on the gossip kernel lane: the device time split into
the flash kernels (the ring ticks), the GEMMs, the gossip kernels and
the rest (the ticks' lse merges and accumulators, the ring shifts,
LayerNorm, GELU, the loss, SGD and the round's elementwise work).

``--precision bf16`` profiles either LM path at bf16 (phase 12's 12a and
12b: bf16 compute on fp32 parameters, the bf16 forms of the flash
kernels, the round in fp32).  The LM paths also list the step's
heaviest kernels by device time (``top_kernels``).

On the kernel lane (``--gossip_kernel pallas``) it also splits one
gossip round of the step's own state into its parts, each timed with
CUDA events over ``--steps`` repetitions: the sender multiply and encode
of every (edge, leaf), the pack of the encoded parts into the transport
buckets, the start kernel (K2), the local share ``lo * x`` and its pack
into the accumulator, the wait kernel (K1) and the unpack (views; on the
int8 wire the conv and Dense kernels are packed in the reference's
layout and copied back, and the same packs in the port's layout are
timed beside them).  Prints one JSON object (also written to ``--out``) with
the card's name and power limit.  Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events_ms(fn, n: int) -> float:
    """Mean device time of ``fn()`` over ``n`` calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def round_split(alg, params: dict, ps_weight, n: int) -> dict:
    """One synchronous kernel-lane round of ``alg`` at phase 0 on the
    given state, cut into the stages ``collectives._round`` runs, each
    stage's mean device ms over ``n`` repetitions.  A blocked codec
    (int8) packs and unpacks each leaf in the reference's layout
    (``alg.layout``, bound by the step builder); the same packs in the
    port's own layout are timed beside them."""
    from stochastic_gradient_push_torch.ops import gossip_kernel as gk
    from stochastic_gradient_push_torch.parallel import collectives as c

    sched, transport = alg.schedule, alg.transport
    names = list(params)
    leaves = [params[k] for k in names] + [ps_weight]
    codec = c._resolve_codec(alg.wire)
    spec = c._kernel_spec(codec)
    plan = c._transport_plan(leaves, spec, alg.gossip_buckets)
    ne = sched.peers_per_itr
    dests = sched.perms[0]
    lane = alg.gossip_kernel
    shapes = [a.shape for a in leaves]
    perms = (alg._perms(names) if codec is not None and codec.blocked
             else None)
    lo, w = c._phase_tables(sched, 0, transport, ps_weight.device)

    def encode():
        sent = {}
        for bucket in plan:
            for j, _, _ in bucket:
                sent[j] = []
                for i in range(ne):
                    msg = c._to_ref(leaves[j] * c._col(w[i], leaves[j]),
                                    perms[j] if perms else None)
                    sent[j].append(codec.encode(msg) if codec else (msg,))
        return sent

    sent = encode()
    lens = [c._bucket_len(b, spec, lane) for b in plan]
    parts = [c._pack_bucket(b, sent, spec, ne, ln)
             for b, (_, ln) in zip(plan, lens)]
    handles = [gk.gossip_edge_start(p, dests, spec, n_decoded=t,
                                    interpret=lane.interpret,
                                    chunk_elems=lane.chunk_elems)
               for p, (t, _) in zip(parts, lens)]

    def local():
        out = list(leaves)
        for bucket in plan:
            for j, _, _ in bucket:
                out[j] = leaves[j] * c._col(lo, leaves[j])
        return out

    out = local()
    accs = [c._pack_acc(b, out, ln, perms=perms)
            for b, (_, ln) in zip(plan, lens)]
    flats = [gk.gossip_edge_wait(h, a) for h, a in zip(handles, accs)]

    def unpack(layout):
        tgt = list(out)
        for b, f in zip(plan, flats):
            c._unpack_acc(b, f, tgt, shapes, layout)

    stages = {
        "encode_ms": encode,
        "pack_parts_ms": lambda: [c._pack_bucket(b, sent, spec, ne, ln)
                                  for b, (_, ln) in zip(plan, lens)],
        "start_ms": lambda: [gk.gossip_edge_start(
            p, dests, spec, n_decoded=t, interpret=lane.interpret,
            chunk_elems=lane.chunk_elems) for p, (t, _) in zip(parts, lens)],
        "local_share_ms": local,
        "pack_acc_ms": lambda: [c._pack_acc(b, out, ln, perms=perms)
                                for b, (_, ln) in zip(plan, lens)],
        "wait_ms": lambda: [gk.gossip_edge_wait(h, a)
                            for h, a in zip(handles, accs)],
        "unpack_ms": lambda: unpack(perms),
    }
    if perms is not None:
        # the same packs in the port's own layout: what the permutation
        # to the reference's layout costs
        stages["pack_acc_port_layout_ms"] = lambda: [
            c._pack_acc(b, out, ln) for b, (_, ln) in zip(plan, lens)]
        stages["unpack_port_layout_ms"] = lambda: unpack(None)
    split = {name: _events_ms(fn, n) for name, fn in stages.items()}
    split["buckets"] = len(plan)
    split["payload_elems_per_rank"] = sum(t for t, _ in lens)
    split["reference_layout_leaves"] = (
        sum(p is not None for p in perms) if perms else 0)
    return split


# device kernels by what they do (first matching substring wins)
RESNET_GROUPS = (("gossip", ("edge_start", "edge_wait")),
                 ("convolution", ("conv", "cudnn", "xmma", "implicit",
                                  "dgrad", "wgrad", "fprop", "sm90_",
                                  "gemm", "cutlass")))


def profile_resnet(args, smi: str) -> dict:
    """``chip_smoke.py``'s ResNet step at ``args``' world, batch, dtype
    and lane: host-clock and profiled windows over ``args.steps`` steps
    from one state (each fires a round), the device time by group, and
    on the kernel lane the round's split at ResNet-50's payload."""
    import torch

    from chip_smoke import RESNET, _resnet_setup
    from stochastic_gradient_push_torch.data.synthetic import (
        synthetic_classification)
    from stochastic_gradient_push_torch.train.step import init_train_state
    from torch_serve_profile import _device_kernels, _window

    from torch.profiler import ProfilerActivity, profile

    world, batch = args.world_size, args.batch
    cfg = dict(RESNET, world=world, batch=batch, dtype=args.dtype,
               gossip_every=1, global_avg_every=0)
    model, alg, tx, step = _resnet_setup(
        cfg, args.wire_dtype, args.overlap == "True", args.staleness,
        args.peers_per_itr, args.gossip_buckets,
        gossip_kernel=args.gossip_kernel, push_sum=args.push_sum == "True",
        error_feedback=args.error_feedback == "True",
        faults=args.inject_faults)
    image = cfg["image"]
    images, labels = synthetic_classification(
        world * batch, num_classes=cfg["num_classes"], image_size=image,
        seed=0)
    x = torch.from_numpy(images.reshape(world, batch, image, image, 3)
                         ).cuda()
    y = torch.from_numpy(labels.reshape(world, batch)).cuda()
    state = init_train_state(model, alg, tx, world, seed=0, device="cuda")
    for _ in range(2):
        step(state, x, y)
    torch.cuda.reset_peak_memory_stats()
    window = _window(lambda: step(state, x, y), args.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, x, y)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    # host calls that wait for the device (a synchronising copy stalls
    # the host's queue of launches)
    window["cuda_runtime_calls_per_step"] = {
        e.key: e.count / args.steps for e in prof.key_averages()
        if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync",
                     "cudaDeviceSynchronize")}
    groups = {name: 0.0 for name, _ in RESNET_GROUPS}
    groups["other"] = 0.0
    for name, us in kernels.items():
        low = name.lower()
        group = next((g for g, keys in RESNET_GROUPS
                      if any(k in low for k in keys)), "other")
        groups[group] += us / 1e3 / args.steps
    total = sum(groups.values())
    window["device_ms_per_step_by_group"] = groups
    window["share_of_device_time"] = {g: ms / total
                                      for g, ms in groups.items()}
    window["images_per_sec_host_clock"] = (
        world * batch / (window["host_ms_per_call"] / 1e3))
    window["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "config": {"model": "resnet50", "world_size": world,
                         "algorithm": alg.name,
                         "batch_per_rank": batch, "image": image,
                         "dtype": args.dtype,
                         "gossip_lane": alg.transport_kernel_name,
                         "wire_dtype": args.wire_dtype,
                         "overlap": args.overlap == "True",
                         "staleness": args.staleness,
                         "peers_per_itr": args.peers_per_itr,
                         "gossip_buckets": args.gossip_buckets,
                         "error_feedback": args.error_feedback == "True",
                         "inject_faults": args.inject_faults},
              "resnet_train_step": window}
    if world > 1 and alg.transport_kernel_name == "pallas":
        result["gossip_round_split"] = round_split(
            alg, state.params, state.gossip.ps_weight, args.steps)
    return result


def _dtype(args):
    """The LM's compute dtype for ``--precision``."""
    import torch

    return torch.bfloat16 if args.precision == "bf16" else torch.float32


def _top(kernels: dict, steps: int, n: int = 12) -> dict:
    """The ``n`` heaviest kernels, ms a step (names cut to 90 chars)."""
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:n]
    return {name[:90]: us / 1e3 / steps for name, us in top}


def profile_seq(args, smi: str) -> dict:
    """Phase 11's sequence-parallel step (``chip_smoke.SEQ``): host and
    device time a step, the device split into the flash kernels, the
    GEMMs, the gossip kernels and the rest."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SEQ, _seq_setup
    from stochastic_gradient_push_torch.train.lm import init_lm_state
    from torch_serve_profile import _device_kernels, _window

    if args.sp != SEQ["sp"]:
        raise SystemExit(f"--sp {args.sp}: the profiled path is phase 11's "
                         f"sp {SEQ['sp']}")
    dp, sp, b, t = SEQ["dp"], SEQ["sp"], SEQ["batch"], SEQ["seq_len"]
    cfg, alg, tx, step = _seq_setup("auto", args.remat == "True", True,
                                    dtype=_dtype(args))
    state = init_lm_state(cfg, alg, tx, dp, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    toks, tgts = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(dp, sp, b, t // sp))).cuda()
        for _ in range(2))
    for _ in range(2):
        step(state, toks, tgts)
    torch.cuda.reset_peak_memory_stats()
    window = _window(lambda: step(state, toks, tgts), args.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, toks, tgts)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    total = sum(kernels.values())
    groups = {"flash": lambda n: "flash_" in n,
              "gossip": lambda n: "edge_" in n,
              "gemm": lambda n: any(k in n.lower() for k in (
                  "gemm", "sm90_xmma", "cutlass", "nvjet"))}
    split = {g: 0.0 for g in (*groups, "rest")}
    for name, us in kernels.items():
        g = next((g for g, hit in groups.items() if hit(name)), "rest")
        split[g] += us / 1e3 / args.steps
    window["device_ms_per_step_by_group"] = split
    window["device_share_by_group"] = {
        g: ms * 1e3 * args.steps / total for g, ms in split.items()}
    window["top_kernels"] = _top(kernels, args.steps)
    window["tokens_per_sec_host_clock"] = (
        dp * b * t / (window["host_ms_per_call"] / 1e3))
    window["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return {"card": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "config": {"dp": dp, "sp": sp, "seq_len": t, "batch": b,
                       "attn": "ring_flash", "remat": cfg.remat,
                       "precision": args.precision,
                       "gossip_lane": alg.transport_kernel_name,
                       "wire_dtype": "f32"},
            "seq_step": window}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--gossip_kernel", default="xla",
                   choices=["auto", "pallas", "xla"])
    p.add_argument("--wire_dtype", default=None,
                   choices=["f32", "bf16", "int8"])
    p.add_argument("--overlap", default="False")
    p.add_argument("--staleness", type=int, default=1)
    p.add_argument("--peers_per_itr", type=int, default=1)
    p.add_argument("--gossip_buckets", type=int, default=1)
    p.add_argument("--model", default="lm", choices=["lm", "resnet50"])
    p.add_argument("--push_sum", default="True",
                   help="resnet50: False runs D-PSGD")
    p.add_argument("--error_feedback", default="False",
                   help="resnet50: error feedback (needs a lossy wire)")
    p.add_argument("--inject_faults", default=None,
                   help="resnet50: a fault plan (--inject_faults grammar)")
    p.add_argument("--batch", type=int, default=32,
                   help="resnet50: images per rank")
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                   help="resnet50: compute dtype")
    p.add_argument("--sp", type=int, default=1,
                   help="4: phase 11's dp 2 x sp 4 ring_flash LM step")
    p.add_argument("--remat", default="False",
                   help="--sp: recompute each block in the backward")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="lm: compute dtype (fp32 parameters either way)")
    p.add_argument("--out", default=os.path.join(
        "artifacts", "torch_train_profile.json"))
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import _train_setup
    from stochastic_gradient_push_torch.train.lm import init_lm_state
    from torch_serve_profile import _device_kernels, _window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in fp32 throughout, as XLA's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    world = args.world_size
    if args.model == "resnet50" or args.sp > 1:
        result = (profile_resnet(args, smi) if args.model == "resnet50"
                  else profile_seq(args, smi))
        out = json.dumps(result, indent=1, sort_keys=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(out + "\n")
        print(out)
        return 0
    cfg, alg, tx, step = _train_setup(
        "flash", world=world, wire=args.wire_dtype,
        overlap=args.overlap == "True", staleness=args.staleness,
        peers=args.peers_per_itr, buckets=args.gossip_buckets,
        gossip_kernel=args.gossip_kernel, dtype=_dtype(args))
    state = init_lm_state(cfg, alg, tx, world, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    toks, tgts = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(world, 8, 1024))).cuda() for _ in range(2))
    for _ in range(2):
        step(state, toks, tgts)
    window = _window(lambda: step(state, toks, tgts), args.steps)

    # kernel shares of the device time, from a second window
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, toks, tgts)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    total = sum(kernels.values())
    for label, key in (("flash", "flash_"), ("gossip", "edge_")):
        mine = {n: us for n, us in kernels.items() if key in n}
        window[f"{label}_kernels_ms_per_step"] = {
            n[:90]: us / 1e3 / args.steps for n, us in mine.items()}
        window[f"{label}_share_of_device_time"] = sum(mine.values()) / total
    window["top_kernels"] = _top(kernels, args.steps)
    window["tokens_per_sec_host_clock"] = (
        world * 8 * 1024 / (window["host_ms_per_call"] / 1e3))
    window["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "config": {"world_size": world,
                         "precision": args.precision,
                         "gossip_lane": alg.transport_kernel_name,
                         "wire_dtype": args.wire_dtype,
                         "overlap": args.overlap == "True",
                         "staleness": args.staleness,
                         "peers_per_itr": args.peers_per_itr,
                         "gossip_buckets": args.gossip_buckets},
              "train_step_t1024_b8": window}
    if world > 1 and alg.transport_kernel_name == "pallas":
        result["gossip_round_split"] = round_split(
            alg, state.params, state.gossip.ps_weight, args.steps)
    out = json.dumps(result, indent=1, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
