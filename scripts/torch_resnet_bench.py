#!/usr/bin/env python3
"""ResNet SGP train-step throughput of the PyTorch port on one GPU.

    python3 scripts/torch_resnet_bench.py                      # world 1
    python3 scripts/torch_resnet_bench.py --world_size 4 --gossip_kernel pallas
    python3 scripts/torch_resnet_bench.py --device cpu --model resnet18 \\
        --batch 2 --image 32 --num_classes 10 --warmup 1 --steps 2

The port's counterpart of ``bench.py::run_measurement`` (which measures
the JAX package on a TPU and is not used here): ResNet-50, 224 px, 1000
classes, batch 128 per rank, bf16 compute (fp32 parameters and
BatchNorm statistics), synthetic images from seed 0
(``data/synthetic.py``), SGP over the n-peer exponential graph (the ring
at world 2), ``sgd(0.9, 1e-4, nesterov=True)``, ``LRSchedule(0.1, batch,
world, warmup=True)`` at 1000 iterations per epoch.  The batch is put on
the device once; ``--warmup`` steps, then ``--steps`` timed steps on the
host clock, fenced by a device-to-host read of the loss.  All
``--world_size`` ranks live stacked on the one card, so images/s per
chip is ``world * batch / step time``.

Prints one JSON line shaped like ``bench.py``'s under the metric name
``<model>_sgp_images_per_sec_per_chip``: batch, step ms, world, the
gossip lane, dtype, the cuDNN and matmul TF32 settings, peak memory,
torch/CUDA versions and the card's name and power limit from
``nvidia-smi``.  With ``--device cpu`` (a rehearsal at small sizes) the
metric is named ``<model>_sgp_images_per_sec_cpu_rehearsal``: a CPU
time is no device measurement.  ``BENCH_S2D=1`` and ``BENCH_NORM=bn16``
or ``folded`` pick the reference bench's stem and norm variants
(``models/resnet.py``; ``folded`` at lr 0) and stamp them in the line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str | None:
    """``nvidia-smi``'s name and power limit line, or None without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True,
                             capture_output=True, text=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def run(args) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from stochastic_gradient_push_torch.algorithms import sgp
    from stochastic_gradient_push_torch.data.synthetic import (
        synthetic_classification)
    from stochastic_gradient_push_torch.device import resolve_device
    from stochastic_gradient_push_torch.ops.gossip_kernel import (
        resolve_gossip_kernel)
    from stochastic_gradient_push_torch.parallel.collectives import (
        StackedTransport)
    from stochastic_gradient_push_torch.topology import (
        NPeerDynamicDirectedExponentialGraph, RingGraph, build_schedule)
    from stochastic_gradient_push_torch.train.lr import LRSchedule
    from stochastic_gradient_push_torch.train.state import sgd
    from stochastic_gradient_push_torch.train.step import (
        build_train_step, init_train_state, make_model)

    device = resolve_device(args.device)
    world, batch, image = args.world_size, args.batch, args.image
    # the reference bench's environment switches (bench.py there):
    # BENCH_S2D=1 the space-to-depth stem, BENCH_NORM bn | bn16 | folded
    stem_s2d = os.environ.get("BENCH_S2D", "0") == "1"
    norm = os.environ.get("BENCH_NORM", "bn")
    model = make_model(args.model, num_classes=args.num_classes,
                       dtype=torch.bfloat16,
                       **({"stem_s2d": True} if stem_s2d else {}),
                       **({"norm_variant": norm} if norm != "bn" else {}))
    graph_cls = (NPeerDynamicDirectedExponentialGraph if world != 2
                 else RingGraph)
    lane = resolve_gossip_kernel(args.gossip_kernel, device=device)
    alg = sgp(build_schedule(graph_cls(world, peers_per_itr=1)),
              StackedTransport(world), gossip_kernel=lane)
    tx = sgd(momentum=0.9, weight_decay=1e-4, nesterov=True)
    # "folded" is an attribution probe, not trainable: lr 0, as the
    # reference's bench runs it (the same work a step)
    step = build_train_step(
        model, alg, tx, LRSchedule(0.0 if norm == "folded" else 0.1, batch,
                                   world, warmup=True),
        itr_per_epoch=1000, num_classes=args.num_classes)
    state = init_train_state(model, alg, tx, world, seed=0, device=device)
    images, labels = synthetic_classification(
        world * batch, num_classes=args.num_classes, image_size=image,
        seed=0)
    # the batch stays on the device: the step is measured, not the copy
    x = torch.from_numpy(images.reshape(world, batch, image, image, 3)
                         ).to(device)
    y = torch.from_numpy(labels.reshape(world, batch)).to(device)

    def fence(metrics) -> float:
        return float(metrics["loss"].min())   # waits for the step

    m = None
    for _ in range(args.warmup):
        state, m = step(state, x, y)
    if m is not None:
        fence(m)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, m = step(state, x, y)
    loss = fence(m)
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}: benchmark invalid")
    step_s = dt / args.steps
    on_card = device.type == "cuda"
    metric = (f"{args.model}_sgp_images_per_sec_per_chip" if on_card
              else f"{args.model}_sgp_images_per_sec_cpu_rehearsal")
    return {
        "metric": metric,
        "value": world * batch / step_s,
        "unit": "images/sec/chip" if on_card else "images/sec (CPU)",
        "batch": batch, "world": world, "image": image,
        "num_classes": args.num_classes, "dtype": "bf16",
        "lane": alg.transport_kernel_name,
        "step_ms": step_s * 1e3, "warmup": args.warmup,
        "steps": args.steps, "loss": loss,
        **({"stem_s2d": True} if stem_s2d else {}),
        **({"norm": norm} if norm != "bn" else {}),
        "platform": "gpu" if on_card else "cpu",
        "device": (torch.cuda.get_device_name(device) if on_card
                   else "cpu"),
        "card": _card() if on_card else None,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if on_card else None),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="resnet50")
    p.add_argument("--world_size", default=1, type=int)
    p.add_argument("--batch", default=128, type=int,
                   help="images per rank per step")
    p.add_argument("--image", default=224, type=int)
    p.add_argument("--num_classes", default=1000, type=int)
    p.add_argument("--gossip_kernel", default="xla",
                   choices=("xla", "auto", "pallas"))
    p.add_argument("--warmup", default=5, type=int)
    p.add_argument("--steps", default=20, type=int)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    out = run(args)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
