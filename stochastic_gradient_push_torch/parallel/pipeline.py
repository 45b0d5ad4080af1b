"""The pipeline axis: GPipe's microbatch schedule over a replica's
stages, all stacked in one process or one stage a process.

Counterpart of ``stochastic_gradient_push_tpu/parallel/pipeline.py::
pipeline_spmd``.  There every device of the ``pipe`` mesh axis holds
one stage (a contiguous slice of the layer stack) and runs one
``lax.scan`` of ``M + S - 1`` ticks: at tick ``t`` stage ``s`` applies
its body to the activation it holds (stage 0 first injects microbatch
``t``), the last stage collects microbatch ``t - (S - 1)``, then every
stage hands its activation to the next with ``lax.ppermute`` over the
ring ``s -> (s + 1) % S``.  Autodiff transposes that into the
drain-ordered backward (GPipe's forward-all-then-backward-all).

:func:`run_schedule` is that tick loop.  Stage ``s`` holds microbatch
``t - s`` at tick ``t``; any other tick is a fill or drain bubble, whose
body is skipped here (the reference runs it on garbage and masks its
outputs, aux and gradients to zero: skipping gives the same values).

* :class:`StackedPipe` holds every stage: the activations are a list,
  one entry a stage, and the hand-off moves the list one place along
  (stage ``s``'s entry to ``s + 1``, the last one's back to 0).
* :class:`DistPipe` holds one stage, the others reached over the
  pipe group of its ``(replica, ep shard, sequence shard)``
  (``parallel/mesh.py``).  Its hand-off is one
  ``batch_isend_irecv`` a tick (``collectives.DistTransport.permute``:
  staged through the host on gloo), sending to stage ``s + 1`` and
  taking stage ``s - 1``'s, in an autograd function whose backward is
  the reverse exchange of the gradient.  Every stage exchanges at every
  tick but the last (whose result the reference discards), the
  wrap-around edge too and on bubble ticks (a bubble passes its
  activation through), so every process's backward runs the same
  exchanges in the same reverse tick order and none waits on a peer
  that skipped one: each exchange takes an ``anchor`` leaf that the
  caller asks a gradient of, and stage 0's inject keeps the received
  activation in the graph with a zero gradient (:class:`_GateFn`, the
  reference's ``where``).  ``hand_offs``, ``hand_off_s`` and
  ``hand_off_bytes`` count the exchanges, their host seconds and the
  bytes each sent; ``sums``, ``sum_s`` and ``sum_bytes`` the sums over
  the stages (:meth:`DistPipe.sum_stages`).

A stage body may hold collectives of its own groups: ring shifts on its
sp group (``parallel/seq.py``) and token exchanges on its ep group
(``parallel/ep.py``), every shard and ep shard of the stage running the
same body on the same ticks.  Their order in the backward needs no
anchor of its own: a live tick's body lies between two hand-offs (the
received activation feeds only that body, whose output feeds only the
next hand-off and, on the last stage, the loss), so the backward of
tick ``t``'s body runs after tick ``t``'s hand-off's and before tick ``t
- 1``'s in every process, and the processes of a stage build the same
graph.  Bubble ticks run no body, so no shift or exchange waits on a
peer that skipped it.
"""

from __future__ import annotations

import time
import typing

import numpy as np
import torch

from ..utils.flatten import flat_by_dtype, unflatten_by_dtype

__all__ = ["StackedPipe", "DistPipe", "run_schedule"]


class StackedPipe:
    """``pp`` stages held in this process: activations are lists, one
    entry a stage."""

    def __init__(self, pp: int):
        if pp < 1:
            raise ValueError(f"pp must be >= 1, got {pp}")
        self.size = int(pp)
        self.stages = tuple(range(pp))

    def hand_off(self, hs: list, anchor=None) -> list:
        """Each stage's activation to the next stage, the last one's to
        stage 0: ``new[s] = hs[(s - 1) % pp]``."""
        del anchor
        return hs[-1:] + hs[:-1]

    def sum_stages(self, leaves: list) -> list:
        """The sum over stages of per-stage values: they already are
        (autograd summed the stages' uses of the one held copy)."""
        return list(leaves)

    def mean_stages(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over stages of ``x`` ``[held, ...]``, one row a held
        stage."""
        return x.mean(0)

    def __repr__(self) -> str:
        return f"StackedPipe({self.size})"


class _HandOff(torch.autograd.Function):
    """One tick's hand-off across processes: to stage ``s + 1``, from
    ``s - 1``; its backward sends the gradient one stage back."""

    @staticmethod
    def forward(ctx, x, anchor, pipe):
        ctx.pipe = pipe
        return pipe._exchange(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.pipe._exchange(g.contiguous(), -1), None, None


class DistPipe:
    """This process's one stage of a replica's ``size`` stages, the
    others reached through ``transport`` (a
    :class:`~.collectives.DistTransport` on the replica's pipe group, its
    rank the stage index)."""

    def __init__(self, transport):
        self.transport = transport
        self.size = int(transport.world_size)
        self.stages = (int(transport.rank),)
        self.hand_offs = 0
        self.hand_off_s = 0.0
        self.hand_off_bytes = 0
        self.sums = 0
        self.sum_s = 0.0
        self.sum_bytes = 0
        self._dests = {step: np.array([(j + step) % self.size
                                       for j in range(self.size)])
                       for step in (1, -1)}

    def _exchange(self, x: torch.Tensor, step: int) -> torch.Tensor:
        t0 = time.perf_counter()
        out = self.transport.permute(x.contiguous()[None],
                                     self._dests[step])[0]
        self.hand_offs += 1
        self.hand_off_bytes += x.numel() * x.element_size()
        self.hand_off_s += time.perf_counter() - t0
        return out

    def hand_off(self, hs: list, anchor=None) -> list:
        """This stage's activation ``[h]`` to stage ``s + 1``, stage ``s -
        1``'s back (a collective of the pipe group).  Under autograd
        ``anchor`` (a leaf the caller asks a gradient of) keeps the
        exchange in every process's backward."""
        (h,) = hs
        if self.size == 1:
            return [h]
        if anchor is not None and torch.is_grad_enabled():
            return [_HandOff.apply(h, anchor, self)]
        return [self._exchange(h, 1)]

    def sum_stages(self, leaves: list) -> list:
        """Each leaf's sum over the replica's stages: one all-reduce per
        dtype on the pipe group."""
        if self.size == 1:
            return list(leaves)
        t0 = time.perf_counter()
        out = list(leaves)
        for flat, index in flat_by_dtype(leaves, stacked=False):
            unflatten_by_dtype(out, leaves, self.transport.allreduce_sum(
                flat[None])[0], index)
            self.sum_bytes += flat.numel() * flat.element_size()
        self.sums += 1
        self.sum_s += time.perf_counter() - t0
        return out

    def mean_stages(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum_stages([x[0]])[0] / self.size

    def __repr__(self) -> str:
        return f"DistPipe({self.size}, stage {self.stages[0]})"


def run_schedule(pipe, n_micro: int, inject: typing.Callable,
                 body: typing.Callable, carry: typing.Callable,
                 anchor=None) -> tuple[dict, list]:
    """GPipe's ``n_micro + pp - 1`` ticks over the stages ``pipe`` holds.

    ``inject(m)`` is stage 0's input for microbatch ``m``; ``body(j, h,
    m)`` applies held stage ``j``'s layers to ``h``; ``carry()`` is a
    zero activation (a :class:`DistPipe`'s bubbles before its first
    live tick).  Returns ``({m: output}, tail)``: the last stage's
    outputs, if held (``{}`` otherwise), and each held stage's
    activation after the last tick.  On a :class:`DistPipe` the tail
    ends the chain of hand-offs: a backward that starts from it (with a
    zero gradient, beside the loss) runs every exchange; ``anchor``
    keeps them in the graph (see :class:`DistPipe`)."""
    S = pipe.size
    dist = isinstance(pipe, DistPipe) and S > 1
    bufs = [carry() if dist else None for _ in pipe.stages]
    outs = {}
    n_ticks = n_micro + S - 1
    for t in range(n_ticks):
        new = []
        for j, s in enumerate(pipe.stages):
            m = t - s
            h = bufs[j]
            if 0 <= m < n_micro:
                if s == 0:
                    x = inject(m)
                    h = x if h is None else _gate(x, h)
                h = body(j, h, m)
                if s == S - 1:
                    outs[m] = h
            new.append(h)
        if t < n_ticks - 1:
            bufs = pipe.hand_off(new, anchor)
    return outs, new


def _gate(inject: torch.Tensor, held: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and held.requires_grad:
        return _GateFn.apply(inject, held)
    return inject


class _GateFn(torch.autograd.Function):
    """``inject`` in the forward; in the backward ``inject``'s gradient
    and zeros for ``held`` (the reference's ``where(stage == 0, inject,
    buf)``), so the received activation stays in the graph."""

    @staticmethod
    def forward(ctx, inject, held):
        ctx.held = (held.shape, held.dtype, held.device)
        return inject.view_as(inject)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.held
        return g, torch.zeros(shape, dtype=dtype, device=device)
