"""Switch mixture-of-experts feed-forward: top-1 routing under a capacity
limit, with the experts over an expert-parallel axis.

Port of ``stochastic_gradient_push_tpu/models/moe.py`` (``moe_capacity``,
``switch_moe_ffn``).  Every token picks the expert of its largest router
probability (``softmax(x @ router)`` in fp32; the first index on ties),
takes the next free slot of that expert's queue (its position is a cumsum
over the tokens before it), and is dropped past ``capacity`` slots: its
output is zero, so the caller's residual carries it through.  The expert
FFN ``gelu_tanh(slots @ w1) @ w2`` runs in fp32 whatever the model's
compute type, and each kept token's output is its slot's output times
its top probability.  ``aux`` holds the Switch load-balancing loss
``E · Σ_e frac_e · mean_prob_e`` and the dropped fraction.

**Index form.**  The reference moves rows with a one-hot dispatch tensor
``[T, E, C]`` and two einsums over it; at the flagship's shape that is a
335 MB tensor a block and a 129 GFLOP product that only copies rows.
Here each token's ``(expert, slot)`` is an index: the slots ``[E, C, D]``
are an ``index_select`` of the tokens (an empty slot reads a zero row),
and the combine an ``index_select`` of the slot outputs.  The slots hold
the reference's values bit for bit (its einsum adds zeros to one
``1.0 · x``); their gradients are ``index_add``'s.

**Groups.**  ``x`` is ``[..., T, D]``: every leading index routes alone,
under its own capacity ``moe_capacity(T, E, cf)`` (a sequence shard's
tokens, as the reference's per-block routing under sp).  With ``ep``
(``parallel/ep.py``) dim -3 is the expert-parallel shards held here:
each shard routes its own tokens, its slots ``[E, C, D]`` travel to the
experts' shards (``ep.dispatch``, the reference's first ``all_to_all``),
every local expert runs over ``[E_local, ep·C, D]`` (each source shard's
``C`` slots in shard order) and the outputs travel back
(``ep.combine``).  ``w1``/``w2`` hold the experts of the shards held
here: all ``E`` on a stack, ``E / ep`` a process.

**Tensor parallelism** (``parallel/tp.py``, the reference's
``_TP_EXPERT_COLUMN``/``_TP_EXPERT_ROW`` under GSPMD): with ``tp`` each
expert's FFN is Megatron's column/row pair, ``w1`` ``[held_tp, E_held,
D, F/tp]`` and ``w2`` ``[held_tp, E_held, F/tp, D]`` the held tp shards'
slices of its F dim.  After ``ep.dispatch`` the slots go to every held
tp shard (``tp.copy``, *f*: its backward sums the slots' gradient over
tp, so the router and the tokens see it once), each shard runs its
``bmm`` pair ``gelu_tanh(xs @ w1_t) @ w2_t``, and the partial outputs
are summed in shard order (``tp.reduce``, *g*) before ``ep.combine``,
so the ep exchange moves one reduced tensor.  The routing runs on the
tp-replicated input and is the same on every tp shard.
"""

from __future__ import annotations

import typing

import torch
import torch.nn.functional as F

__all__ = ["moe_capacity", "switch_moe_ffn", "route", "dispatch",
           "Routing"]


def moe_capacity(num_tokens: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Slots per expert per source shard: ``max(1, int(T·cf/E))``."""
    return max(1, int(num_tokens * capacity_factor / num_experts))


class Routing(typing.NamedTuple):
    """One routing: the router's fp32 probabilities ``[..., T, E]``, and
    for each token ``[..., T]`` its expert, its top probability, its
    position in the expert's queue and whether it got a slot."""

    probs: torch.Tensor
    expert: torch.Tensor
    top: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor


def route(x: torch.Tensor, router: torch.Tensor, capacity: int) -> Routing:
    """Top-1 routing of tokens ``x`` ``[..., T, D]`` over ``router``
    ``[D, E]`` with ``capacity`` slots an expert."""
    wide = torch.promote_types(x.dtype, torch.float32)
    logits = x.to(wide) @ router.to(wide)
    probs = torch.softmax(logits, dim=-1)
    expert = probs.argmax(-1)
    top = probs.gather(-1, expert[..., None])[..., 0]
    onehot = F.one_hot(expert, router.shape[-1])
    pos = onehot.cumsum(-2).gather(-1, expert[..., None])[..., 0] - 1
    return Routing(probs, expert, top, pos, pos < capacity)


def dispatch(x: torch.Tensor, r: Routing, e_total: int, cap: int):
    """``(slots, slot)``: the slots ``[..., E, C, D]`` of tokens ``x``
    ``[..., T, D]`` under routing ``r`` (in fp32, or fp64), and each
    token's index into them flattened over all groups, ``[..., T]`` (one
    past the end for a dropped token)."""
    *lead, t, d = x.shape
    n = x[..., 0, 0].numel()
    per = e_total * cap
    base = torch.arange(n, device=x.device).reshape(*lead, 1) * per
    slot = torch.where(r.kept, base + r.expert * cap + r.pos,
                       torch.full_like(r.pos, n * per))
    # the token filling each slot (n·T: a zero row for an empty one);
    # only kept tokens write real slots, each its own
    src = torch.full((n * per + 1,), n * t, dtype=torch.long,
                     device=x.device)
    src.scatter_(0, slot.reshape(-1), torch.arange(n * t, device=x.device))
    wide = torch.promote_types(x.dtype, torch.float32)
    rows = torch.cat([x.to(wide).reshape(n * t, d),
                      x.new_zeros(1, d, dtype=wide)])
    slots = rows.index_select(0, src[:-1]).reshape(*lead, e_total, cap, d)
    return slots, slot


def _experts(xs: torch.Tensor, w1: torch.Tensor,
             w2: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN over its slots ``[E, n, D]``, in the slots'
    type."""
    h = F.gelu(torch.bmm(xs, w1.to(xs.dtype)), approximate="tanh")
    return torch.bmm(h, w2.to(xs.dtype))


def switch_moe_ffn(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor, ep=None,
                   capacity_factor: float = 1.25, tp=None):
    """Top-1 switch MoE feed-forward of ``x`` ``[..., T, D]`` (with
    ``ep``: ``[..., held, T, D]``, ``held`` the ep shards held here).
    ``router`` ``[D, E]`` (E the total experts), ``w1`` ``[E_held, D, F]``
    and ``w2`` ``[E_held, F, D]`` the experts of the held shards (with
    ``tp``: ``[held_tp, E_held, D, F/tp]`` and ``[held_tp, E_held, F/tp,
    D]``, the held tp shards' slices).  Returns ``(y, aux)``: ``y`` shaped
    like ``x``, ``aux`` the ``load_balance_loss`` and ``dropped_fraction``
    of each routing group (``x.shape[:-2]``)."""
    *lead, t, d = x.shape
    held = 1 if ep is None else len(ep.shards)
    size = 1 if ep is None else ep.size
    if tp is not None and (w1.dim() != 4 or w1.shape[0] != len(tp.shards)):
        raise ValueError(f"w1 {tuple(w1.shape)}: with tp the leading dim "
                         f"is the {len(tp.shards)} tp shards held here")
    e_rows = w1.shape[-3]
    e_local = e_rows // held
    e_total = e_local * size
    if router.shape[-1] != e_total or e_local * held != e_rows:
        raise ValueError(
            f"router is over {router.shape[-1]} experts but weights "
            f"provide {e_total} ({e_local} × {size} shards)")
    if ep is not None and (not lead or lead[-1] != held):
        raise ValueError(f"x {tuple(x.shape)}: dim -3 must be the {held} "
                         f"expert-parallel shards held here")
    cap = moe_capacity(t, e_total, capacity_factor)
    r = route(x, router, cap)
    slots, slot = dispatch(x, r, e_total, cap)

    if ep is None:
        xs = slots.movedim(-3, 0).reshape(e_total, -1, d)
    else:
        xs = ep.dispatch(slots)                  # [E_held, n·ep·C, D]
    if tp is None:
        ys = _experts(xs, w1, w2)
    else:
        ys = tp.reduce([_experts(xt, w1[i], w2[i])
                        for i, xt in enumerate(tp.copy(xs))])
    if ep is None:
        y_slots = ys.reshape(e_total, *lead, cap, d).movedim(0, -3)
    else:
        y_slots = ep.combine(ys, tuple(lead[:-1]), cap)

    out = torch.cat([y_slots.reshape(-1, d), ys.new_zeros(1, d)])
    y = out.index_select(0, slot.reshape(-1)).reshape(*lead, t, d)
    y = y * r.top[..., None]
    frac = F.one_hot(r.expert, e_total).to(r.probs.dtype).mean(-2)
    aux = {"load_balance_loss": e_total * (frac * r.probs.mean(-2)).sum(-1),
           "dropped_fraction": 1.0 - r.kept.to(r.probs.dtype).mean(-1)}
    return y.to(x.dtype), aux
