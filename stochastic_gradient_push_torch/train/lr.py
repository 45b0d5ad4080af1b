"""Learning-rate schedule (the reference recipe, gossip_sgd.py:508-536).

Port of ``LRSchedule`` in ``stochastic_gradient_push_tpu/train/lr.py``:

1. target_lr = ref_lr · global_batch / 256 ("ImageNet in 1hr" scaling)
2. optional linear warmup from ref_lr to target_lr over the first 5 epochs
3. piecewise exponential decay: lr ·= factor at each schedule epoch

Evaluated on the host in float32 with the reference's op order, so the
rate matches the reference's float32 value.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LRSchedule", "WARMUP_EPOCHS"]

WARMUP_EPOCHS = 5


class LRSchedule:
    """Callable ``(epoch, itr, itr_per_epoch) -> lr`` (a float32).

    Args:
      ref_lr: reference LR for a 256-sample global batch (``--lr``).
      batch_size: per-rank batch size.
      world_size: number of ranks.
      decay_schedule: {epoch: factor} piecewise decays
        (default {30: .1, 60: .1, 80: .1}).
      warmup: linear warmup over the first 5 epochs (``--warmup``).
      scale: extra LR scale.
    """

    def __init__(self, ref_lr: float, batch_size: int, world_size: int,
                 decay_schedule: dict[int, float] | None = None,
                 warmup: bool = False, scale: float = 1.0):
        self.ref_lr = float(ref_lr)
        self.target_lr = float(
            ref_lr * batch_size * scale * world_size / 256.0)
        self.warmup = bool(warmup)
        if decay_schedule is None:
            decay_schedule = {30: 0.1, 60: 0.1, 80: 0.1}
        self.decay_schedule = dict(sorted(decay_schedule.items()))

    def __call__(self, epoch, itr, itr_per_epoch) -> np.float32:
        f32 = np.float32
        epoch, itr, itr_per_epoch = f32(epoch), f32(itr), f32(itr_per_epoch)
        lr = f32(self.target_lr)
        for e, factor in self.decay_schedule.items():
            if epoch >= e:
                lr = lr * f32(factor)
        if self.warmup and epoch < WARMUP_EPOCHS:
            if self.target_lr <= self.ref_lr:
                lr = f32(self.target_lr)
            else:
                count = epoch * itr_per_epoch + itr + f32(1.0)
                lr = f32(self.ref_lr) + f32(self.target_lr - self.ref_lr) * (
                    count / (f32(WARMUP_EPOCHS) * itr_per_epoch))
        return f32(lr)
