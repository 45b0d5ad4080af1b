#!/usr/bin/env python3
"""The streaming image loader's decode parallelism, measured.

    python3 scripts/torch_loader_ab.py [--cli True]

Writes ``chip_smoke.py``'s phase-14 JPEG tree (4 classes, 64 train
images a class, 320 x 256 px) into a temporary directory and compares
two ways of spreading PIL decodes over a thread pool:

* ``batch``: the package's ``data/streaming.py::StreamingImageFolder``
  (as the reference's PIL path), a batch one task, so at most
  ``min(num_workers, prefetch + 1)`` threads decode at once;
* ``image``: the same loader with a task an image (defined here), so
  every one of ``num_workers`` threads decodes at once.

1. The loader alone, no step, over 4 epochs at world 4 x 8 images a rank
   (8 batches an epoch), uint8 and f32 output, with 1, 2, 4 and 8
   threads decoding at once (``batch``: ``num_workers`` = k,
   ``prefetch`` = max(k - 1, 1)); the counts are run up then down.
2. With ``--cli True`` (needs a CUDA card): ``run/gossip_sgd.py`` as
   phase 14a runs it (ResNet-50, 224 px, world 4 stacked, 32 a rank, SGP
   on the gossip kernels, 3 epochs of 2 steps), f32 without device
   prefetch and uint8 with it, each design in the order batch, image,
   image, batch; the ``BT`` and ``DT`` means of 3 steps (each epoch's
   first skipped) from the run's CSV.

Host times: a one-card machine shares its host's cores, so compare the
designs only within one run.  The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from stochastic_gradient_push_torch.data import streaming  # noqa: E402

WORLD, BATCH, EPOCHS = 4, 8, 4


class PerImageLoader(streaming.StreamingImageFolder):
    """The package's loader with a decode task an image: every thread of
    the pool decodes at once, at most ``prefetch`` batches behind the
    one the consumer waits on."""

    def __iter__(self):
        table = self.sampler.all_indices()
        if self.ranks is not None:
            table = table[self.ranks]
        start, self.start_itr = self.start_itr, 0
        blocks = [table[:, b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(start, len(self))]
        raw = self.output == "uint8"
        s = self.dataset.image_size

        def submit(pool, blk):
            flat = blk.reshape(-1)
            labels = np.asarray([self.dataset.labels[i] for i in flat],
                                np.int32).reshape(blk.shape)
            return [pool.submit(self.dataset.decode, i, raw=raw)
                    for i in flat], labels

        def gather(futures, labels):
            images = np.stack([f.result() for f in futures])
            return images.reshape(*labels.shape, s, s, 3), labels

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            window = collections.deque()
            for blk in blocks:
                if len(window) < self.prefetch:
                    window.append(submit(pool, blk))
                    continue
                done = window.popleft()
                window.append(submit(pool, blk))
                yield gather(*done)
            while window:
                yield gather(*window.popleft())


def _loader(design: str, root: str, threads: int, output: str,
            batch: int = BATCH):
    if design == "batch":
        return streaming.StreamingImageFolder(
            root, "train", WORLD, batch, num_workers=threads,
            prefetch=max(threads - 1, 1), output=output)
    return PerImageLoader(root, "train", WORLD, batch, num_workers=threads,
                          output=output)


def loader_rate(design: str, root: str, threads: int, output: str) -> float:
    loader = _loader(design, root, threads, output)
    n = 0
    t0 = time.perf_counter()
    for epoch in range(EPOCHS):
        loader.set_epoch(epoch)
        n += sum(x.shape[0] * x.shape[1] for x, _ in loader)
    return n / (time.perf_counter() - t0)


def cli_run(design: str, root: str, ckpt: str, extra: list[str]):
    import torch

    from stochastic_gradient_push_torch.run import gossip_sgd

    real = streaming.StreamingImageFolder
    if design == "image":
        streaming.StreamingImageFolder = PerImageLoader
    try:
        gossip_sgd.main(chip_smoke._img_argv(
            root, ckpt, "--gossip_kernel", "pallas", "--num_epochs",
            str(chip_smoke.IMG_CLI["epochs"]), *extra))
        torch.cuda.synchronize()
    finally:
        streaming.StreamingImageFolder = real
    return chip_smoke._csv_timing(ckpt)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cli", default="False", choices=("True", "False"))
    args = p.parse_args(argv)
    card = "host only"
    if args.cli == "True":
        import torch

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.splitlines()[0]
        card = (f"{torch.cuda.get_device_name(0)}, "
                f"{smi.split(',')[-1].strip()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(f"loader_ab: {os.cpu_count()} host cores [{card}]", flush=True)
    tmp = tempfile.mkdtemp(prefix="loader_ab_")
    summary: dict = {"card": card, "cores": os.cpu_count(), "alone": {},
                     "cli": {}}
    try:
        root = os.path.join(tmp, "tree")
        chip_smoke._write_images(root)
        for output in ("uint8", "f32"):
            for threads in (1, 2, 4, 8, 8, 4, 2, 1):
                for design in ("batch", "image"):
                    r = loader_rate(design, root, threads, output)
                    summary["alone"].setdefault(
                        f"{output} {design} {threads}", []).append(
                        round(r, 1))
                    print(f"loader_ab alone {output} {design}, {threads} "
                          f"decoding at once: {r:.1f} images/s [{card}]",
                          flush=True)
        if args.cli == "True":
            runs = (("f32", ["--data_output", "f32", "--prefetch",
                             "False"]),
                    ("uint8", ["--data_output", "uint8", "--prefetch",
                               "True"]))
            for output, extra in runs:
                for k, design in enumerate(("batch", "image", "image",
                                            "batch")):
                    bt, bt_std, dt = cli_run(design, root, os.path.join(
                        tmp, f"cli_{output}_{k}"), extra)
                    summary["cli"].setdefault(f"{output} {design}", []).append(
                        [round(bt * 1e3, 1), round(dt * 1e3, 1)])
                    print(f"loader_ab cli {output} {design}: BT {bt * 1e3:.0f}"
                          f" ms (std {bt_std * 1e3:.0f}), DT {dt * 1e3:.0f} "
                          f"ms = {dt / bt:.1%} of BT [{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
