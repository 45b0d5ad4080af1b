"""Sharded sampler and stacked loader for decentralized data parallelism.

Copies of ``DistributedSampler`` and ``ShardedLoader`` from
``stochastic_gradient_push_tpu/data/pipeline.py`` (numpy only), so an
epoch's order is the reference's:

* :class:`DistributedSampler` — per-epoch seeded shuffle (``set_epoch``;
  the trainer passes ``epoch + seed * 90``), padding to a multiple of
  the world size, strided shard per rank.
* :class:`ShardedLoader` — batches every rank's shard and stacks them
  into one ``(world, per_rank_batch, ...)`` array, the rank-stacked
  layout the train step takes.  ``fast_forward`` skips the first
  batches of an epoch on resume without loading them.
"""

from __future__ import annotations

import typing as tp

import numpy as np

__all__ = ["DistributedSampler", "ShardedLoader"]


class DistributedSampler:
    """Deterministic per-rank index sampler: shuffle ``range(n)`` with
    ``seed = epoch``, pad by wrapping so every rank gets ``ceil(n /
    world)`` samples, then stride by rank."""

    def __init__(self, dataset_len: int, world_size: int,
                 rank: int | None = None):
        if dataset_len < 1:
            raise ValueError("dataset_len must be >= 1")
        self.n = int(dataset_len)
        self.world_size = int(world_size)
        self.rank = rank
        self.epoch = 0
        self.num_samples = -(-self.n // self.world_size)  # ceil
        self.total_size = self.num_samples * self.world_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def indices_for_rank(self, rank: int | None = None) -> np.ndarray:
        rank = self.rank if rank is None else rank
        if rank is None:
            raise ValueError("no rank given and none set at construction")
        g = np.random.default_rng(self.epoch)
        idx = g.permutation(self.n)
        if self.total_size > self.n:
            idx = np.concatenate([idx, idx[: self.total_size - self.n]])
        return idx[rank::self.world_size]

    def all_indices(self) -> np.ndarray:
        """(world_size, num_samples) index table for stacked loading."""
        return np.stack([self.indices_for_rank(r)
                         for r in range(self.world_size)])


class ShardedLoader:
    """Iterates global batches stacked over the world dimension:
    ``(images, labels)`` of shapes ``(world, batch, ...)`` /
    ``(world, batch)``.  A ragged last batch is dropped.  ``ranks``
    selects the rows this process holds."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, sampler: DistributedSampler,
                 ranks: tp.Sequence[int] | None = None):
        if len(images) != len(labels):
            raise ValueError("images and labels length mismatch")
        self.images = images
        self.labels = labels
        self.batch_size = int(batch_size)
        self.sampler = sampler
        self.ranks = None if ranks is None else list(ranks)
        self.start_itr = 0

    def __len__(self) -> int:
        return self.sampler.num_samples // self.batch_size

    def fast_forward(self, itr: int) -> None:
        """Resume mid-epoch: skip the first ``itr`` batches."""
        self.start_itr = int(itr)

    def __iter__(self):
        table = self.sampler.all_indices()
        if self.ranks is not None:
            table = table[self.ranks]
        n_batches = len(self)
        for b in range(self.start_itr, n_batches):
            sel = table[:, b * self.batch_size:(b + 1) * self.batch_size]
            yield self.images[sel], self.labels[sel]
        self.start_itr = 0
