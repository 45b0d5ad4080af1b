"""Streaming ImageFolder loader: a thread pool of PIL decodes.

Port of ``StreamingImageFolder`` in ``stochastic_gradient_push_tpu/data/
streaming.py``: a pool of ``num_workers`` threads decodes and augments
the next batches (PIL releases the GIL while it decodes and resamples)
while the card computes, and the host never holds more than
``prefetch`` global batches.  As in the reference, a batch is one pool
task, so at most ``min(num_workers, prefetch + 1, batches left in the
epoch)`` threads decode at once (the batch the consumer waits on and
``prefetch`` behind it).  PIL holds the GIL for part of each decode,
so threads scale well below linearly; a task an image was measured
against this design (``scripts/torch_loader_ab.py``, ``PERF.md``): no
faster for uint8 batches, and under the CLI it delivers an epoch's
second batch later.  Batches are world-stacked and NHWC,
``(images [R, B, H, W, C], labels [R, B])``, as the reference yields
them and as the port's train step takes them: the step moves each
rank's images to NCHW on the device (``train/step.py``), after the
uint8 normalisation there, so no host time goes to the transpose and
the pixels are the reference's.  The iteration contract is
:class:`~.pipeline.ShardedLoader`'s (``len``, ``set_epoch``,
``fast_forward``, ``ranks``).

Decoding is PIL's: ``backend`` ``"auto"`` and ``"pil"`` both mean PIL.
The reference's native decoder (``data/native.py``, libjpeg behind a C++
thread pool) is not ported: it needs ``jpeglib.h``, which the H100
hosts the port is built on lack, and ``"native"`` is refused by name.
"""

from __future__ import annotations

import concurrent.futures
import typing as tp

import numpy as np

from .imagefolder import ImageFolderDataset
from .pipeline import DistributedSampler

__all__ = ["StreamingImageFolder", "NATIVE_REFUSAL"]

NATIVE_REFUSAL = ("the native JPEG decoder (data/native.py, "
                  "native_src/loader.cc) is not ported: it links libjpeg, "
                  "and the H100 hosts the port is built on have no "
                  "jpeglib.h to build it against; use --data_backend auto "
                  "or pil (PIL decodes)")


class StreamingImageFolder:
    """World-stacked streaming loader over ``root/split``."""

    def __init__(self, root: str, split: str, world_size: int,
                 batch_size: int, image_size: int = 224, train: bool = True,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0,
                 ranks: tp.Sequence[int] | None = None,
                 backend: str = "auto", output: str = "f32"):
        if backend == "native":
            raise ValueError(f"backend 'native': {NATIVE_REFUSAL}")
        if backend not in ("auto", "pil"):
            raise ValueError(f"unknown backend {backend!r}")
        # "f32": ImageNet-normalised float32; "uint8": the raw pixels, a
        # 4x smaller host-to-device copy, normalised on the device
        if output not in ("f32", "uint8"):
            raise ValueError(f"unknown output {output!r}")
        self.dataset = ImageFolderDataset(
            f"{root}/{split}" if split else root,
            image_size=image_size, train=train, seed=seed)
        self.world_size = world_size
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        self.sampler = DistributedSampler(len(self.dataset), world_size)
        # one rank per process: decode only this process's rank rows
        self.ranks = None if ranks is None else list(ranks)
        self.start_itr = 0
        self.output = output

    @property
    def classes(self) -> list[str]:
        return self.dataset.classes

    def __len__(self) -> int:
        return self.sampler.num_samples // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        self.dataset.set_epoch(epoch)

    def fast_forward(self, itr: int) -> None:
        self.start_itr = int(itr)

    def _load_batch(self, idx_block: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Decode one batch block of ``(rows, batch)`` indices."""
        flat = idx_block.reshape(-1)
        images = np.stack([self.dataset.decode(i, raw=self.output == "uint8")
                           for i in flat])
        labels = np.asarray([self.dataset.labels[i] for i in flat],
                            np.int32)
        s = self.dataset.image_size
        rows = idx_block.shape[0]
        return (images.reshape(rows, self.batch_size, s, s, 3),
                labels.reshape(rows, self.batch_size))

    def __iter__(self) -> tp.Iterator[tuple[np.ndarray, np.ndarray]]:
        table = self.sampler.all_indices()  # (world, num_samples)
        if self.ranks is not None:
            table = table[self.ranks]
        start = self.start_itr
        self.start_itr = 0
        blocks = [table[:, b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(start, len(self))]
        if not blocks:
            return
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self.num_workers) as pool:
            window: list = []
            block_iter = iter(blocks)
            for blk in block_iter:
                window.append(pool.submit(self._load_batch, blk))
                if len(window) >= self.prefetch:
                    break
            for blk in block_iter:
                done = window.pop(0)
                window.append(pool.submit(self._load_batch, blk))
                yield done.result()
            for fut in window:
                yield fut.result()
