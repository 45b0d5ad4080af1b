"""The sequence axis: one replica's sequence shards stacked on one device.

Counterpart of the reference's ``SEQ_AXIS`` and ``make_dp_sp_mesh``
(``stochastic_gradient_push_tpu/train/lm.py:36,61-63``).  There a
replica's ``sp`` shards live on ``sp`` devices of the ``(gossip, seq)``
mesh; here they are a leading dim of every activation, ``[sp, ...]``,
with shard ``i`` holding tokens ``[i*t, (i+1)*t)`` of each sequence.

``ring_shift`` is ``lax.ppermute(x, seq, [(i, (i + 1) % sp)])``: shard
``i``'s block goes to shard ``i + 1``, so ``new[j] = x[j - 1]``.  The
ring across processes (one shard per GPU) is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["StackedSeq"]


class StackedSeq:
    """``sp`` sequence shards held as dim 0 of every tensor."""

    def __init__(self, sp: int):
        if sp < 1:
            raise ValueError(f"sp must be >= 1, got {sp}")
        self.size = sp

    def index(self, device=None) -> torch.Tensor:
        """Each shard's position on the axis, ``[sp]`` (``lax.axis_index``
        for every shard at once)."""
        return torch.arange(self.size, device=device)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send every shard's block one hop along the ring: ``new[j] =
        x[(j - 1) % sp]``."""
        if x.shape[0] != self.size:
            raise ValueError(f"dim 0 is {x.shape[0]}, not the {self.size} "
                             f"shards of the axis")
        return torch.roll(x, 1, 0)

    def __repr__(self) -> str:
        return f"StackedSeq({self.size})"
