"""The sequence axis: a replica's sequence shards stacked on one device,
or one shard a process.

Counterpart of the reference's ``SEQ_AXIS`` and ``make_dp_sp_mesh``
(``stochastic_gradient_push_tpu/train/lm.py:36,61-63``).  There a
replica's ``sp`` shards live on ``sp`` devices of the ``(gossip, seq)``
mesh, shard ``i`` holding tokens ``[i*t, (i+1)*t)`` of each sequence.
Here every activation leads with the shards held in this process,
``[held, ...]``:

* :class:`StackedSeq` holds all ``sp`` of them, ``held == size``;
* :class:`DistSeq` holds one, its process's, and reaches the others
  over the replica's sp group (``parallel/mesh.py``).

``ring_shift`` is ``lax.ppermute(x, seq, [(i, (i + 1) % sp)])``: shard
``i``'s block goes to shard ``i + 1``, so ``new[j] = x[j - 1]``.  On a
stack it is ``torch.roll``; across processes one ``batch_isend_irecv``
on the sp group (``collectives.DistTransport.permute``: staged through
the host on gloo, on the card under NCCL), differentiable by its
transpose, the shift the other way.  ``pmean`` is the reference's
``lax.pmean(..., seq)`` of the loss and the gradients: nothing on a
stack (autograd already summed the stacked shards), one all-reduce per
dtype across processes.  A :class:`DistSeq`'s ``shifts``, ``shift_s``
and ``shift_bytes`` count its hops, their host seconds and the bytes
each sent.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.flatten import flat_by_dtype, unflatten_by_dtype

__all__ = ["StackedSeq", "DistSeq"]


class StackedSeq:
    """``sp`` sequence shards held as dim 0 of every tensor."""

    def __init__(self, sp: int):
        if sp < 1:
            raise ValueError(f"sp must be >= 1, got {sp}")
        self.size = sp
        self.shards = tuple(range(sp))

    def index(self, device=None) -> torch.Tensor:
        """Each held shard's position on the axis, ``[sp]``
        (``lax.axis_index`` for every shard at once)."""
        return torch.arange(self.size, device=device)

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send every shard's block one hop along the ring: ``new[j] =
        x[(j - 1) % sp]``."""
        if x.shape[0] != self.size:
            raise ValueError(f"dim 0 is {x.shape[0]}, not the {self.size} "
                             f"shards of the axis")
        return torch.roll(x, 1, 0)

    def pmean(self, leaves: list) -> list:
        """The mean over the axis of per-replica values: they already are
        (autograd summed over the stacked shards)."""
        return list(leaves)

    def __repr__(self) -> str:
        return f"StackedSeq({self.size})"


class _Shift(torch.autograd.Function):
    """One ring hop across processes; its backward sends the gradient
    one hop back."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return seq._hop(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.seq._hop(g.contiguous(), -1), None


class DistSeq:
    """This process's one shard of a replica's ``size`` shards, the
    others reached through ``transport`` (a
    :class:`~.collectives.DistTransport` on the replica's sp group, its
    rank the shard index)."""

    def __init__(self, transport):
        self.transport = transport
        self.size = int(transport.world_size)
        self.shards = (int(transport.rank),)
        self.shifts = 0
        self.shift_s = 0.0
        self.shift_bytes = 0
        # the permutation of a hop: shard j's block lands on j + step
        self._dests = {step: np.array([(j + step) % self.size
                                       for j in range(self.size)])
                       for step in (1, -1)}

    def index(self, device=None) -> torch.Tensor:
        """This shard's position on the axis, ``[1]``."""
        return torch.tensor(self.shards, device=device)

    def _hop(self, x: torch.Tensor, step: int) -> torch.Tensor:
        t0 = time.perf_counter()
        out = self.transport.permute(x, self._dests[step])
        self.shifts += 1
        self.shift_bytes += x.numel() * x.element_size()
        self.shift_s += time.perf_counter() - t0
        return out

    def ring_shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send this shard's block ``[1, ...]`` to shard ``i + 1`` and take
        shard ``i - 1``'s (a collective of the sp group)."""
        if x.shape[0] != 1:
            raise ValueError(f"dim 0 is {x.shape[0]}, not the one shard "
                             f"this process holds")
        if self.size == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Shift.apply(x.contiguous(), self)
        return self._hop(x.contiguous(), 1)

    def pmean(self, leaves: list) -> list:
        """Each leaf's mean over the replica's shards: one all-reduce per
        dtype on the sp group."""
        if self.size == 1:
            return list(leaves)
        out = list(leaves)
        for flat, index in flat_by_dtype(leaves, stacked=False):
            unflatten_by_dtype(out, leaves, self.transport.allreduce_sum(
                flat[None])[0] / self.size, index)
        return out

    def __repr__(self) -> str:
        return f"DistSeq({self.size}, shard {self.shards[0]})"
