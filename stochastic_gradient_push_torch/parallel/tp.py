"""The tensor-parallel axis: a replica's Megatron shards stacked in one
process, or one shard a process.

Counterpart of the reference's ``TP_AXIS``, its placement rules
(``_TP_COLUMN``, ``_TP_ROW``, ``_tp_tail``) and ``tp_sharding_tree`` /
``apply_tp_sharding`` (``stochastic_gradient_push_tpu/train/lm.py:37,
164-270``).  There ``tp`` is an *auto* axis of the ``(gossip, tp)`` or
``(gossip, seq, tp)`` mesh: GSPMD splits each projection's kernel by
module name and places every reduction itself.  The port has no
partitioner, so this module writes those reductions by hand.

**Placement.**  The column-parallel modules (``q``, ``k``, ``v``, ``up``,
``lm_head``) split their output features: a kernel ``[out, in]`` (the
port's layout) keeps rows ``[i·out/tp, (i+1)·out/tp)`` on shard ``i``,
and ``up``'s bias goes with its kernel.  The row-parallel modules
(``o``, ``down``) split their input features, columns of ``[out, in]``.
A MoE block's expert stacks split their FFN dim, the reference's
``_TP_EXPERT_COLUMN``/``_TP_EXPERT_ROW``: ``experts_up`` ``[E, D, F]``
on F (dim 2), ``experts_down`` ``[E, F, D]`` on F (dim 1), so each
shard runs Megatron's column/row pair on every expert.  Every other
leaf (the embedding, the LayerNorms, ``down``'s bias, the router) is
replicated.  A sharded leaf of a rank-stacked state is held as ``[R,
held, *shard]``, ``held`` the shards this process holds; a replicated
one as ``[R, *shape]``, one copy.  :func:`shard_params` and
:func:`gather_params` move between that and the logical leaves.

**Heads.**  As GSPMD does, the split is by columns, not heads: q, k
and v keep ``d_model / tp`` columns a shard and ``n_heads`` need not
divide by ``tp``, so a head may straddle two shards (GPT-2 small's 12
heads of 64 at tp 8: 96 columns, one and a half heads, a shard).
:meth:`~_TpAxis.join_heads` joins the held shards' columns into the
whole heads they touch (stacked, every head) and :meth:`~_TpAxis.
cut_heads` cuts the attention output back to the held columns for
``o``'s row split.  One shard a process, the columns of a shared head
come from the neighbour by an all-gather on the tp group, and its
gradient is the fold, in shard order, of the partial gradients of the
processes that hold it (:class:`_HeadGather`).

**The reductions** (Megatron's *f* and *g*): the input of a column
layer is copied to every shard, and its gradient summed over the shards
(:meth:`copy`); the partial outputs of a row layer are summed, and the
gradient goes back to every shard unchanged (:meth:`reduce`).  Every sum
over the shards is a fold in shard order, ``((s0 + s1) + s2) + s3``: on
a stack over the held shards, across processes over an all-gather on
the tp group, so both lanes compute the same bits.  A sharded activation
is a list of the held shards' tensors, computed shard by shard with the
operations a process of the process lane runs on its one shard.
:meth:`lm_loss` is the cross-entropy over the vocabulary split across
``lm_head``'s shards: the max, the sum of ``exp`` and the target's logit
reduced over the shards, in the reference's ``logsumexp - target``
form.

:meth:`tape` keeps a rematerialised block's forward from reducing
twice: the first pass records each *g*'s sum, the recompute in the
backward reads it back.  ``reductions``, ``reduce_s`` and
``reduce_bytes`` count the sums over the shards, their host seconds and
the bytes each put in.
"""

from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["TP_COLUMN", "TP_ROW", "TP_EXPERT_COLUMN", "TP_EXPERT_ROW",
           "StackedTp", "DistTp", "split_dim",
           "shard_params", "gather_params", "shard_state", "gather_state",
           "check_tp_dims", "check_wire_blocks"]

# the reference's _TP_COLUMN / _TP_ROW (train/lm.py:167-168 there)
TP_COLUMN = ("q", "k", "v", "up", "lm_head")
TP_ROW = ("o", "down")
# the reference's _TP_EXPERT_COLUMN / _TP_EXPERT_ROW (:170-171 there): a
# MoE block's raw expert stacks, split on their FFN dim
TP_EXPERT_COLUMN = ("experts_up",)      # [E, D, F]: F
TP_EXPERT_ROW = ("experts_down",)       # [E, F, D]: F


def split_dim(name: str) -> int | None:
    """The dim of a logical per-replica leaf (the port's ``[out, in]``
    layout, an expert stack's ``[E, D, F]`` / ``[E, F, D]``) that tp
    splits, by module name; None for a replicated one."""
    mod, _, leaf = name.rpartition(".")
    if leaf in TP_EXPERT_COLUMN:
        return 2
    if leaf in TP_EXPERT_ROW:
        return 1
    last = mod.rpartition(".")[2]
    if last in TP_COLUMN:
        return 0
    if last in TP_ROW and leaf == "weight":
        return 1
    return None


def shard_params(logical: dict, tp: int, shards=None) -> dict:
    """Rank-stacked logical leaves ``[R, ...]`` placed for ``tp`` shards:
    a split leaf as ``[R, held, *shard]`` with the ``shards`` held here
    (default all), the others as they are."""
    shards = range(tp) if shards is None else shards
    out = {}
    for n, p in logical.items():
        d = split_dim(n)
        if d is None:
            out[n] = p
            continue
        parts = p.chunk(tp, dim=d + 1)
        out[n] = torch.stack([parts[i] for i in shards], 1).contiguous()
    return out


def gather_params(sharded: dict, tp: int) -> dict:
    """The logical leaves ``[R, ...]`` of a state holding all ``tp``
    shards of every split leaf (the inverse of :func:`shard_params`)."""
    out = {}
    for n, p in sharded.items():
        d = split_dim(n)
        if d is None:
            out[n] = p
            continue
        if p.shape[1] != tp:
            raise ValueError(f"{n} holds {p.shape[1]} of {tp} tp shards; "
                             "the logical leaf needs all of them")
        out[n] = torch.cat(p.unbind(1), dim=d + 1)
    return out


def _map_state(state, fn):
    """``state`` with ``fn`` applied to each dict of parameter-named
    leaves: params, momentum, the in-flight shares and the EF
    residual."""
    g = state.gossip
    g = g.replace(
        in_flight=tuple((fn(p), w) for p, w in g.in_flight),
        ef_residual=None if g.ef_residual is None else fn(g.ef_residual))
    return dataclasses.replace(state, params=fn(state.params),
                               opt_state=fn(state.opt_state), gossip=g)


def shard_state(state, tp: int, shards=None):
    """A train state of logical leaves placed for ``tp`` shards."""
    return _map_state(state, lambda t: shard_params(t, tp, shards))


def gather_state(state, tp: int):
    """A train state holding every tp shard, as logical leaves (the
    format of the per-replica checkpoint files, as at tp 1)."""
    return _map_state(state, lambda t: gather_params(t, tp))


def check_tp_dims(d_model: int, d_ff: int, vocab_size: int, tp: int):
    """``ValueError`` naming the first dimension ``tp`` does not divide.
    These are the split dims of the kernels: the reference's GSPMD splits
    each kernel's columns evenly and refuses a dim it cannot
    (``init_lm_state_tp``).  The head count is free: a head may straddle
    two shards (``_TpAxis.join_heads``)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    for dim, n in (("d_model", d_model), ("d_ff", d_ff),
                   ("vocab_size", vocab_size)):
        if n % tp:
            raise ValueError(f"{dim} {n} not divisible by tp {tp}: the "
                             f"tensor-parallel split is even")


def check_wire_blocks(shapes: dict, tp: int, block: int) -> None:
    """``ValueError`` naming the first split leaf whose shard does not
    keep the reference's int8 blocks.  ``shapes`` maps each leaf to its
    logical ``[out, in]`` (or ``[out]``) shape.  A shard, flattened in
    the reference's ``[in, out]`` order, is blocked as the logical leaf
    is exactly when a column split's ``out / tp`` (a bias's length / tp)
    or a row split's ``(in / tp) · out`` is a multiple of ``block``.  An
    expert stack is blocked by the reference over each ep shard's slice
    at full F (tp is an auto axis there); a ``(e, t)`` shard keeps those
    blocks exactly when ``F / tp`` (``experts_up`` ``[E, D, F]``) or
    ``(F / tp) · D`` (``experts_down`` ``[E, F, D]``) is a multiple of
    ``block`` (the ep slice's own size: ``parallel/ep.py::
    check_ep_wire_blocks``)."""
    for n, shape in shapes.items():
        d = split_dim(n)
        if d is None or tp == 1:
            continue
        leaf = n.rpartition(".")[2]
        if leaf in TP_EXPERT_COLUMN:
            run = shape[2] // tp
            what = f"F / tp = {run}"
        elif leaf in TP_EXPERT_ROW:
            run = (shape[1] // tp) * shape[2]
            what = f"(F / tp) * D = {run}"
        elif d == 0:
            run, what = shape[0] // tp, f"out / tp = {shape[0] // tp}"
        else:
            run = (shape[1] // tp) * shape[0]
            what = f"(in / tp) * out = {run}"
        if run % block:
            raise ValueError(
                f"--wire_dtype int8 with --tp {tp}: {n}'s shard has "
                f"{what}, not a multiple of --wire_block {block}, so its "
                f"int8 blocks would not be the reference's")


def _fold(xs: list) -> torch.Tensor:
    """``((x0 + x1) + x2) + ...``: the one order every lane sums in."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


class _Tape:
    """A rematerialised block's record of its *g* sums: the first pass
    records them, every later pass (the recompute in the backward) reads
    them back in order instead of reducing again."""

    def __init__(self, axis):
        self.axis = axis
        self.sums: list = []
        self.passes = 0
        self.pos = 0
        self.prev = None

    @property
    def replaying(self) -> bool:
        return self.passes > 1

    def __enter__(self):
        self.prev, self.axis._tape = self.axis._tape, self
        self.passes += 1
        self.pos = 0
        return self

    def __exit__(self, *exc):
        self.axis._tape = self.prev

    def next(self) -> torch.Tensor:
        out = self.sums[self.pos]
        self.pos += 1
        return out.clone()


class _Copy(torch.autograd.Function):
    """Megatron's *f*: one view of the input for every held shard; the
    backward folds the shards' gradients (over the tp group across
    processes)."""

    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return tuple(x.view_as(x) for _ in axis.shards)

    @staticmethod
    def backward(ctx, *grads):
        return None, ctx.axis._sum(list(grads))


class _Reduce(torch.autograd.Function):
    """Megatron's *g*: the fold of the shards' partial outputs; the
    backward hands every held shard the gradient unchanged."""

    @staticmethod
    def forward(ctx, axis, *parts):
        ctx.n = len(parts)
        return axis._sum(list(parts), replayable=True)

    @staticmethod
    def backward(ctx, grad):
        return (None,) + (grad,) * ctx.n


class _HeadGather(torch.autograd.Function):
    """A column split's held columns of q, k and v widened to the whole
    heads ``[lo, hi)`` they touch, when a head straddles two shards.
    Forward: an all-gather of every shard's columns on the tp group and
    a slice.  Backward: the attention's gradients are linear in its
    output's gradient, and a process's output gradient is its own
    columns' alone, so each process's gradient of a shared head is a
    partial sum.  Every shard's gradient of its heads (padded to the
    widest span) is gathered, and each of this process's columns folds
    the shards' partials in shard order (a shard whose heads miss the
    column adds an exact zero, as the fold of zero-filled full-width
    partials would)."""

    @staticmethod
    def forward(ctx, axis, head_dim, *xs):
        c = xs[0].shape[-1]
        ctx.axis, ctx.c, ctx.head_dim = axis, c, head_dim
        lo, hi = axis.head_span(c * axis.size, head_dim)
        full = torch.cat(axis._timed_all([torch.stack(xs)], count=False), -1)
        return tuple(t.contiguous() for t in full[..., lo:hi].unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        axis, c = ctx.axis, ctx.c
        like = next(g for g in grads if g is not None)
        g = torch.stack([torch.zeros_like(like) if g is None else g
                         for g in grads])
        spans = [_span(s * c, (s + 1) * c, ctx.head_dim)
                 for s in range(axis.size)]
        wide = max(b - a for a, b in spans)
        if g.shape[-1] < wide:
            g = torch.nn.functional.pad(g, (0, wide - g.shape[-1]))
        parts = axis._timed_all([g.contiguous()], count=False)
        own_lo, own_hi = axis.shards[0] * c, (axis.shards[-1] + 1) * c
        acc = g.new_zeros(*g.shape[:-1], own_hi - own_lo)
        for (a, b), part in zip(spans, parts):
            lo, hi = max(a, own_lo), min(b, own_hi)
            if lo < hi:
                acc[..., lo - own_lo:hi - own_lo] += part[..., lo - a:hi - a]
        return (None, None) + tuple(acc.unbind(0))


def _span(lo: int, hi: int, head_dim: int) -> tuple[int, int]:
    """The columns ``[lo, hi)`` rounded out to whole heads."""
    return lo // head_dim * head_dim, -(-hi // head_dim) * head_dim


class _TpAxis:
    """What both lanes share: *f*, *g*, the vocab-parallel loss and the
    shard sums of the grad norm, over ``_all`` (every shard's tensor, in
    shard order, from the held shards' ones)."""

    size: int
    shards: tuple

    def __init__(self):
        self.reductions = 0
        self.reduce_s = 0.0
        self.reduce_bytes = 0
        self._tape = None

    def _all(self, parts: list) -> list:
        raise NotImplementedError

    def _sum(self, parts: list, replayable: bool = False) -> torch.Tensor:
        tape = self._tape if replayable else None
        if tape is not None and tape.replaying:
            return tape.next()
        out = _fold(self._timed_all(parts))
        if tape is not None:
            tape.sums.append(out.detach())
        return out

    def _timed_all(self, parts: list, count: bool = True) -> list:
        t0 = time.perf_counter()
        got = self._all([p.detach() for p in parts])
        self.reductions += int(count)
        self.reduce_bytes += sum(p.numel() * p.element_size() for p in parts)
        self.reduce_s += time.perf_counter() - t0
        return got

    def copy(self, x: torch.Tensor) -> list:
        """*f*: the held shards' inputs of a column layer (views of
        ``x``); the gradient is summed over the shards."""
        return list(_Copy.apply(self, x))

    def reduce(self, parts: list) -> torch.Tensor:
        """*g*: the sum over the shards of the held shards' ``parts``; the
        gradient reaches every shard unchanged."""
        if len(parts) != len(self.shards):
            raise ValueError(f"{len(parts)} parts for the "
                             f"{len(self.shards)} shards held here")
        return _Reduce.apply(self, *parts)

    def gather(self, parts: list) -> list:
        """Every shard's tensor in shard order, from the held shards'
        ``parts`` (no gradient; not counted among the sums)."""
        return self._all([p.detach() for p in parts])

    def sum_shards(self, x: torch.Tensor) -> torch.Tensor:
        """The fold over the shards of ``x`` ``[held, ...]`` (no
        gradient)."""
        return _fold(self._timed_all(list(x.unbind(0))))

    def head_span(self, width: int, head_dim: int) -> tuple[int, int]:
        """``[lo, hi)``: the columns of the whole heads that the held
        shards' columns of a ``width``-wide column split touch."""
        c = width // self.size
        return _span(self.shards[0] * c, (self.shards[-1] + 1) * c, head_dim)

    def join_heads(self, groups: list, head_dim: int) -> list:
        """Each of ``groups`` (a column layer's held shards' outputs
        ``[..., width / tp]``, a list each) as one tensor of the whole
        heads its columns touch, ``[..., hi - lo]`` (:meth:`head_span`).
        The held shards' columns are joined first; where a head straddles
        a held shard's edge, the missing columns come from the other
        shards (:class:`_HeadGather`, one all-gather for all groups).
        With every shard held this is the whole width: tp 1's heads."""
        joined = [g[0] if len(g) == 1 else torch.cat(g, -1) for g in groups]
        c = groups[0][0].shape[-1]
        lo, hi = self.head_span(c * self.size, head_dim)
        if (lo, hi) == (self.shards[0] * c, (self.shards[-1] + 1) * c):
            return joined
        return list(_HeadGather.apply(self, head_dim, *joined))

    def cut_heads(self, out: torch.Tensor, width: int,
                  head_dim: int) -> list:
        """An output over :meth:`join_heads`' columns, ``[..., hi - lo]``,
        cut back to the held shards' ``width / tp`` columns each (a row
        layer's inputs)."""
        c = width // self.size
        lo, _ = self.head_span(width, head_dim)
        return [out[..., i * c - lo:(i + 1) * c - lo].contiguous()
                for i in self.shards]

    def tape(self) -> _Tape:
        """A record/replay of one rematerialised block's *g* sums."""
        return _Tape(self)

    def lm_loss(self, logits: list, targets: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of the vocabulary split over the
        shards: ``logits`` the held shards' ``[..., vocab / tp]`` slices
        (fp32, or fp64), shard ``i`` holding ids ``[i·v, (i+1)·v)``.  The
        reference's ``logsumexp - target`` with the max, the sum of
        ``exp`` and the target's logit each reduced over the shards; the
        backward is ``softmax - onehot`` on each shard's slice."""
        v = logits[0].shape[-1]
        with torch.no_grad():
            m = torch.stack([lg.amax(-1) for lg in logits])
            m = self._max(list(m.unbind(0)))
        total = self.reduce([torch.exp(lg - m[..., None]).sum(-1)
                             for lg in logits])
        tgt = self.reduce([_target_logit(lg, targets, i * v)
                           for i, lg in zip(self.shards, logits)])
        return (torch.log(total) + m - tgt).mean()

    def _max(self, parts: list) -> torch.Tensor:
        acc, *rest = self._timed_all(parts)
        for x in rest:
            acc = torch.maximum(acc, x)
        return acc


def _target_logit(logits: torch.Tensor, targets: torch.Tensor,
                  lo: int) -> torch.Tensor:
    """Each target's logit where this vocabulary slice ``[lo, lo + v)``
    holds it, else 0."""
    v = logits.shape[-1]
    local = targets.long() - lo
    held = (local >= 0) & (local < v)
    got = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
    return torch.where(held, got, torch.zeros_like(got))


class StackedTp(_TpAxis):
    """All ``tp`` shards of a replica held in this process, as lists in
    shard order."""

    def __init__(self, tp: int):
        super().__init__()
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        self.size = int(tp)
        self.shards = tuple(range(tp))

    def _all(self, parts: list) -> list:
        return parts

    def __repr__(self) -> str:
        return f"StackedTp({self.size})"


class DistTp(_TpAxis):
    """This process's one shard of a replica's ``size`` shards, the
    others reached through ``transport`` (a
    :class:`~.collectives.DistTransport` on the tp group, its rank the
    shard index): each sum over the shards is an all-gather on the group
    (through the host on gloo) and a fold in shard order."""

    def __init__(self, transport):
        super().__init__()
        self.transport = transport
        self.size = int(transport.world_size)
        self.shards = (int(transport.rank),)

    def _all(self, parts: list) -> list:
        import torch.distributed as dist

        (x,) = parts
        if self.size == 1:
            return [x]
        send = self.transport._host(x.contiguous())
        rows = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(rows, send, group=self.transport.group)
        return [r.to(x.device) for r in rows]

    def __repr__(self) -> str:
        return f"DistTp({self.size}, shard {self.shards[0]})"
