"""The expert-parallel axis: a replica's ep shards stacked in one process,
or one shard a process.

Counterpart of the reference's ``EP_AXIS`` and its placement
(``stochastic_gradient_push_tpu/train/lm.py:38,79-90,147-161``).  There
``ep`` is a manual axis of the ``(gossip, ep)``, ``(gossip, ep, seq)``,
``(gossip, ep, tp)`` and ``(gossip, ep, seq, tp)`` meshes (tp stays
auto: ``parallel/tp.py`` splits each expert's F dim besides): every ep
shard carries its own tokens, the expert leaves
(``experts_up`` ``[E, D, F]``, ``experts_down`` ``[E, F, D]``) are split
on their expert dim, shard ``i`` holding experts ``[i·E/ep,
(i+1)·E/ep)``, and every other leaf is replicated over ep.

**Placement.**  On a stack (:class:`StackedEp`) a replica's expert leaves
are held whole, ``[R, E, ...]``: the shards' slices side by side are the
logical leaf, so a stacked state is the logical state and checkpoints
as it is.  One shard a process (:class:`DistEp`) holds its slice ``[R,
E/ep, ...]`` (:func:`shard_experts`, :func:`gather_experts`).

**The exchange.**  Each held shard's slots ``[E, C, D]`` go to the
experts' shards, and each expert gets ``[ep·C, D]``, source shard ``j``'s
``C`` slots at rows ``[j·C, (j+1)·C)`` (the reference's ``all_to_all(...,
split_axis=0, concat_axis=1, tiled=True)``); the outputs go back the
same way.  Slots keep their leading group dims (a process's sequence
shard under a ring), so each sequence shard routes its own tokens across
processes as on a stack.  On a stack that is a fixed-order move
(``movedim``) whose backward is autograd's own.  Across processes it is
one ``all_to_all_single`` on the ep group of the process's ``(replica,
shard, t)``, in an autograd function
whose backward is the inverse exchange of the gradient (through the host
on gloo, as ``parallel/tp.py::DistTp`` does); ``exchanges``,
``exchange_s`` and ``exchange_bytes`` count them.

**The step** (the reference's ``train/lm.py:376-391,403-412``): the
objective is the mean over ep shards of each shard's loss, and every
gradient, expert slices included, the sum over shards divided by ``ep``.
On a stack one forward over all shards' tokens computes that mean
directly.  A process's autograd gives its replicated leaves its own
shard's gradient, which :meth:`DistEp.reduce_grads` sums over the ep
group, and its expert slice the sum over every shard's tokens already
(the exchange's backward); both are then divided by ``ep``.  The grad
norm is each shard's norm of its own gradients (its expert slice and
the replicated leaves), meaned over ep (:meth:`mean_shards`).
"""

from __future__ import annotations

import time

import torch

from ..utils.flatten import flat_by_dtype, unflatten_by_dtype

__all__ = ["EXPERT_LEAVES", "StackedEp", "DistEp", "is_expert",
           "shard_experts", "gather_experts", "check_ep_wire_blocks"]

# the leaves the reference shards over ep (train/lm.py:147-149 there)
EXPERT_LEAVES = ("experts_up", "experts_down")


def is_expert(name: str) -> bool:
    """Whether the port's leaf ``name`` is an expert stack."""
    return name.rpartition(".")[2] in EXPERT_LEAVES


def shard_experts(logical: dict, ep: int, shards) -> dict:
    """Logical leaves with each expert leaf ``[..., E, D, F]`` (or ``[...,
    E, F, D]``: any leading rank, stage or layer dims) cut to the experts
    of ``shards`` (ep indices, in order), ``[..., held·E/ep, ...]``; the
    others as they are."""
    out = {}
    for n, p in logical.items():
        if is_expert(n):
            parts = p.chunk(ep, dim=-3)
            p = torch.cat([parts[i] for i in shards], -3).contiguous()
        out[n] = p
    return out


def gather_experts(parts: list) -> dict:
    """The logical leaves from every ep shard's :func:`shard_experts` (in
    shard order): expert leaves concatenated on the expert dim, the
    others shard 0's."""
    return {n: (torch.cat([torch.as_tensor(p[n]) for p in parts], -3)
                if is_expert(n) else parts[0][n]) for n in parts[0]}


def check_ep_wire_blocks(shapes: dict, ep: int, block: int) -> None:
    """``ValueError`` naming the first expert leaf whose shard does not
    keep the reference's int8 blocks.  The reference blocks each shard's
    local slice ``[E/ep, ...]``; a held logical leaf ``[E, ...]`` is
    blocked as those slices are exactly when a slice's size is a multiple
    of ``block``."""
    for n, shape in shapes.items():
        if ep == 1 or not is_expert(n):
            continue
        run = shape[0] // ep
        for d in shape[1:]:
            run *= d
        if run % block:
            raise ValueError(
                f"--wire_dtype int8 with --ep {ep}: {n}'s shard has {run} "
                f"elements, not a multiple of --wire_block {block}, so its "
                f"int8 blocks would not be the reference's")


class _EpAxis:
    """What both lanes share: the grad norm's mean over shards."""

    size: int
    shards: tuple

    def __init__(self):
        self.exchanges = 0
        self.exchange_s = 0.0
        self.exchange_bytes = 0

    def mean_shards(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the axis of ``x`` ``[held, ...]``, one row a held
        shard."""
        raise NotImplementedError


class StackedEp(_EpAxis):
    """All ``ep`` shards of a replica held in this process: a batch's
    rows are the shards' in order, and every expert is local."""

    def __init__(self, ep: int):
        super().__init__()
        if ep < 1:
            raise ValueError(f"ep must be >= 1, got {ep}")
        self.size = int(ep)
        self.shards = tuple(range(ep))

    def dispatch(self, slots: torch.Tensor) -> torch.Tensor:
        """``[..., ep, E, C, D]`` -> each expert's slots ``[E, n·C, D]``
        (the leading dims, then the source shard, then the slot)."""
        return slots.movedim(-3, 0).reshape(slots.shape[-3], -1,
                                            slots.shape[-1])

    def combine(self, ys: torch.Tensor, lead: tuple, cap: int):
        """Inverse of :meth:`dispatch`: ``[E, n·C, D]`` -> ``[..., ep, E,
        C, D]``."""
        return ys.reshape(ys.shape[0], *lead, self.size, cap,
                          ys.shape[-1]).movedim(0, -3)

    def reduce_grads(self, grads: dict) -> dict:
        """The gradients already are the mean over shards (one forward over
        all of them)."""
        return grads

    def pmean(self, leaves: list) -> list:
        return list(leaves)

    def mean_shards(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(0)

    def __repr__(self) -> str:
        return f"StackedEp({self.size})"


class _Exchange(torch.autograd.Function):
    """One all-to-all over the ep group; its backward is the inverse one
    of the gradient (an all-to-all of equal chunks is its own inverse
    pattern)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis._all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._all_to_all(g.contiguous()), None


class DistEp(_EpAxis):
    """This process's one shard of a replica's ``size`` ep shards, the
    others reached through ``transport`` (a
    :class:`~.collectives.DistTransport` on the replica's ep group, its
    rank the shard index)."""

    def __init__(self, transport):
        super().__init__()
        self.transport = transport
        self.size = int(transport.world_size)
        self.shards = (int(transport.rank),)

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk ``j`` of dim 0 to shard ``j``; chunk ``j`` of the result
        from shard ``j``."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        send = self.transport._host(x.contiguous())
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.transport.group)
        out = recv.to(x.device)
        self.exchanges += 1
        self.exchange_bytes += send.numel() * send.element_size()
        self.exchange_s += time.perf_counter() - t0
        return out

    def _move(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            return _Exchange.apply(x, self)
        return self._all_to_all(x)

    def dispatch(self, slots: torch.Tensor) -> torch.Tensor:
        """``[..., 1, E, C, D]`` -> the local experts' slots ``[E/ep,
        n·C, D]``: every shard's slots for them, in shard order."""
        *lead, _, e, cap, d = slots.shape
        send = slots.reshape(*lead, self.size, e // self.size, cap,
                             d).movedim(-4, 0)
        recv = self._move(send.contiguous())    # [src, ..., E/ep, C, D]
        return recv.movedim(-3, 0).movedim(1, -3).reshape(
            e // self.size, -1, d)

    def combine(self, ys: torch.Tensor, lead: tuple, cap: int):
        """Inverse of :meth:`dispatch`: ``[E/ep, n·C, D]`` -> ``[..., 1,
        E, C, D]``, this shard's slots of every expert."""
        e_local, _, d = ys.shape
        back = ys.reshape(e_local, *lead, self.size, cap, d).movedim(
            -3, 1).movedim(0, -3)               # [src, ..., E/ep, C, D]
        got = self._move(back.contiguous())     # [owner, ..., E/ep, C, D]
        return got.movedim(0, -4).reshape(*lead, 1, e_local * self.size,
                                          cap, d)

    def reduce_grads(self, grads: dict) -> dict:
        """Replicated leaves' gradients summed over the ep group (one
        all-reduce per dtype), then every gradient divided by ``ep``."""
        if self.size == 1:
            return grads
        names = [n for n in grads if not is_expert(n)]
        leaves = [grads[n] for n in names]
        out = list(leaves)
        for flat, index in flat_by_dtype(leaves, stacked=False):
            unflatten_by_dtype(out, leaves, self.transport.allreduce_sum(
                flat), index)
        summed = dict(zip(names, out))
        return {n: summed.get(n, g) / self.size for n, g in grads.items()}

    def pmean(self, leaves: list) -> list:
        """Each leaf's mean over the ep group (one all-reduce per dtype)."""
        if self.size == 1:
            return list(leaves)
        out = list(leaves)
        for flat, index in flat_by_dtype(leaves, stacked=False):
            unflatten_by_dtype(out, leaves, self.transport.allreduce_sum(
                flat) / self.size, index)
        return out

    def mean_shards(self, x: torch.Tensor) -> torch.Tensor:
        return self.pmean([x[0]])[0]

    def __repr__(self) -> str:
        return f"DistEp({self.size}, shard {self.shards[0]})"
