"""Learning-rate and peers-per-iteration schedules (the reference recipe,
gossip_sgd.py:497-536).

Port of ``LRSchedule``, ``CosineLRSchedule`` and ``ppi_at_epoch`` in
``stochastic_gradient_push_tpu/train/lr.py``:

1. target_lr = ref_lr · global_batch / 256 ("ImageNet in 1hr" scaling)
2. optional linear warmup from ref_lr to target_lr over the first 5 epochs
3. piecewise exponential decay: lr ·= factor at each schedule epoch, or
   a cosine decay to zero over the run (``CosineLRSchedule``)

Evaluated on the host in float32 in the form the reference's compiled
step computes, so the rate is bit-equal to the one it trains with
(``tests/test_torch_trainer.py``): XLA on the CPU turns a division by a
compile-time constant (``itr_per_epoch``, ``total_epochs``) into a
multiplication by its float32 reciprocal, folds constant factors
together, and contracts a multiply feeding an add into one fused
multiply-add (:func:`_fma`); its ``cos`` is the C library's ``cosf``,
which the port calls too.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

__all__ = ["LRSchedule", "CosineLRSchedule", "ppi_at_epoch",
           "WARMUP_EPOCHS"]

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
                lr = _warmup_ramp(self, epoch, itr, itr_per_epoch)
        return f32(lr)


def _fma(a, b, c) -> np.float32:
    """``a * b + c`` rounded once to float32: the product of two float32
    values is exact in float64, and so is the sum unless the exponents
    lie far apart."""
    return np.float32(float(a) * float(b) + float(c))


def _warmup_ramp(sched, epoch, itr, itr_per_epoch) -> np.float32:
    """Linear ramp ref_lr -> target_lr over WARMUP_EPOCHS epochs, as the
    compiled step computes it: ``count * ((target - ref) * (1 / (5 *
    itr_per_epoch))) + ref`` in one fused multiply-add."""
    f32 = np.float32
    count = epoch * itr_per_epoch + itr + f32(1.0)
    slope = f32(sched.target_lr - sched.ref_lr) * (
        f32(1.0) / (f32(WARMUP_EPOCHS) * itr_per_epoch))
    return _fma(count, slope, f32(sched.ref_lr))


@functools.cache
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


class CosineLRSchedule:
    """Cosine decay to zero over ``total_epochs`` with the same linear
    warmup and global-batch scaling as :class:`LRSchedule` (the warmup
    ramp caps the cosine over the first 5 epochs when ``target_lr >
    ref_lr``)."""

    def __init__(self, ref_lr: float, batch_size: int, world_size: int,
                 total_epochs: int, warmup: bool = True,
                 scale: float = 1.0):
        self.ref_lr = float(ref_lr)
        self.target_lr = float(
            ref_lr * batch_size * scale * world_size / 256.0)
        self.warmup = bool(warmup)
        self.total_epochs = int(total_epochs)

    def __call__(self, epoch, itr, itr_per_epoch) -> np.float32:
        f32 = np.float32
        epoch, itr, ipe = f32(epoch), f32(itr), f32(itr_per_epoch)
        progress = _fma(itr, f32(1.0) / ipe, epoch) * (
            f32(1.0) / f32(self.total_epochs))
        progress = min(max(progress, f32(0.0)), f32(1.0))
        cos = f32(_cosf()(float(progress * f32(np.pi))))
        lr = (cos + f32(1.0)) * f32(self.target_lr * 0.5)
        if (self.warmup and self.target_lr > self.ref_lr
                and epoch < WARMUP_EPOCHS):
            lr = min(_warmup_ramp(self, epoch, itr, ipe), lr)
        return f32(lr)


def ppi_at_epoch(ppi_schedule: dict[int, int], epoch: int) -> int:
    """Peers-per-itr in effect at ``epoch``: the value of the latest
    schedule epoch not after ``epoch``.  Each value selects its own
    algorithm (its schedule tables have a different shape)."""
    ppi, e_max = None, -1
    for e, v in ppi_schedule.items():
        if e_max <= e <= epoch:
            e_max = e
            ppi = v
    if ppi is None:
        raise ValueError(
            f"ppi_schedule {ppi_schedule} has no entry for epoch {epoch}; "
            "an epoch-0 entry is required")
    return ppi
