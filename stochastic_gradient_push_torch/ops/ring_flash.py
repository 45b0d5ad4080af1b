"""Ring attention with the flash kernels as its ticks.

Port of ``stochastic_gradient_push_tpu/ops/ring_flash.py`` over the
sequence axis (``parallel/seq.py``): q/k/v are ``[held, batch, heads,
block_len, head_dim]``, one block per shard held here (all ``sp`` of
them on a :class:`~..parallel.seq.StackedSeq`, this process's one on a
:class:`~..parallel.seq.DistSeq`, which runs only its own shard's row
of each tick, with the owner and mode of its index).  The
ring is the one of ``parallel/ring_attention.py``, but each visible
(shard, tick) pair is one call of the flash kernels
(``ops/flash_attention.py``), so no ``[t, t]`` score matrix outlives a
kernel:

* Forward (``_ring_forward:120``): each tick returns its block-normalised
  output and row logsumexp; ticks merge by ``lse ← logaddexp(lse,
  lse_t)`` with the outputs reweighted by ``exp(lse - lse_new)`` and
  ``exp(lse_t - lse_new)``, starting from ``lse = -1e30``.  Saves ``(q,
  k, v, out, lse)``.
* Backward (``_ring_backward:164``): the dQ and dK/dV kernels take the
  ring's *global* ``lse`` and ``delta = rowsum(dO·O)`` (computed once),
  so each tick yields exactly its share of the gradient.  dQ accumulates
  in place; the dK/dV accumulators travel the ring with their blocks and
  take one final hop home.
* Tick modes (``_tick_mode:113-117``): non-causal ticks are full
  (``causal=False`` kernels); under a causal mask the shard's own block
  is the diagonal (``causal=True``), an earlier owner's block is full,
  a later owner's block is skipped and launches nothing.

``lane`` picks the ticks (:func:`~.lanes.pick_lane`): on CUDA tensors
the kernels ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``, on
CPU tensors their plain twins; ``"kernel"`` on a CPU tensor raises
:class:`~.lanes.KernelLaneError`, and ``"plain"`` runs the twins on the
card (its oracle).  The reference's TPU ``block`` rule is not carried
over: the kernels' tiles are their own, and any shard length runs.
"""

from __future__ import annotations

import torch

from .flash_attention import (NEG_INF, _delta, flash_attention_reference,
                              flash_bwd_dkv, flash_bwd_dkv_reference,
                              flash_bwd_dq, flash_bwd_dq_reference, flash_fwd)
from .lanes import pick_lane

__all__ = ["RingFlashAttention", "ring_flash_attention", "ring_ticks"]

FULL, DIAG, SKIP = 0, 1, 2


def _tick_mode(rank: int, owner: int, causal: bool) -> int:
    """The reference's ``_tick_mode``: FULL, DIAG or SKIP for shard
    ``rank`` attending the block of ``owner``."""
    if not causal:
        return FULL
    return DIAG if owner == rank else (FULL if owner < rank else SKIP)


def ring_ticks(sp: int, causal: bool) -> list[list[tuple[int, int]]]:
    """Per tick, each shard's ``(owner, mode)``.  At tick ``s`` shard
    ``r`` holds the block of ``(r - s) mod sp``; the last tick, ``sp -
    1``, is the reference's after-loop tick of owner ``(r + 1) mod sp``."""
    return [[((r - s) % sp, _tick_mode(r, (r - s) % sp, causal))
             for r in range(sp)] for s in range(sp)]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """A shard's slice of a stacked per-row tensor, copied when its start
    misses the kernels' 16-byte alignment."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _tick_fwd(q, k, v, causal: bool, kernel: bool):
    if kernel:
        return flash_fwd(q, k, v, causal=causal, return_lse=True)
    return flash_attention_reference(q, k, v, causal=causal,
                                     return_lse=True)


def _tick_bwd(q, k, v, do, lse, delta, causal: bool, kernel: bool):
    if kernel:
        lse, delta = _aligned(lse), _aligned(delta)
        return (flash_bwd_dq(q, k, v, do, lse, delta, causal),
                *flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    return (flash_bwd_dq_reference(q, k, v, do, lse, delta, causal),
            *flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal))


def _ring_forward(q, k, v, seq, causal: bool, kernel: bool):
    acc = torch.zeros_like(q, dtype=torch.float32)
    lse = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                     device=q.device)
    for s, shards in enumerate(ring_ticks(seq.size, causal)):
        if s:
            k, v = seq.ring_shift(k), seq.ring_shift(v)
        # r: the row held here, of shard seq.shards[r]
        for r, (_, mode) in enumerate(shards[i] for i in seq.shards):
            if mode == SKIP:
                continue
            out_t, lse_t = _tick_fwd(q[r], k[r], v[r], mode == DIAG, kernel)
            lse_new = torch.logaddexp(lse[r], lse_t)
            acc[r] = (acc[r] * torch.exp(lse[r] - lse_new)[..., None]
                      + out_t.float()
                      * torch.exp(lse_t - lse_new)[..., None])
            lse[r] = lse_new
    return acc.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, do, seq, causal: bool,
                   kernel: bool):
    delta = _delta(out, do)
    dq = torch.zeros_like(q, dtype=torch.float32)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    for s, shards in enumerate(ring_ticks(seq.size, causal)):
        if s:   # the dK/dV accumulators travel with their blocks
            k, v = seq.ring_shift(k), seq.ring_shift(v)
            dk, dv = seq.ring_shift(dk), seq.ring_shift(dv)
        for r, (_, mode) in enumerate(shards[i] for i in seq.shards):
            if mode == SKIP:
                continue
            dq_t, dk_t, dv_t = _tick_bwd(q[r], k[r], v[r], do[r], lse[r],
                                         delta[r], mode == DIAG, kernel)
            dq[r] += dq_t
            dk[r] += dk_t
            dv[r] += dv_t
    if seq.size > 1:   # one hop short of home after sp - 1 rotations
        dk, dv = seq.ring_shift(dk), seq.ring_shift(dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingFlashAttention(torch.autograd.Function):
    """Differentiable ring flash attention (the reference's
    ``custom_vjp`` ``_ring_flash``): residuals ``(q, k, v, out, lse)``,
    the global-lse ring backward."""

    @staticmethod
    def forward(ctx, q, k, v, seq, causal: bool, kernel: bool):
        q, k, v = (x.contiguous() for x in (q, k, v))
        out, lse = _ring_forward(q, k, v, seq, causal, kernel)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seq, ctx.causal, ctx.kernel = seq, causal, kernel
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _ring_backward(q, k, v, out, lse, do.contiguous(), ctx.seq,
                               ctx.causal, ctx.kernel)
        return (*grads, None, None, None)


def ring_flash_attention(q, k, v, seq, causal: bool = False,
                         lane: str = "auto"):
    """Exact ring attention over the shards of ``seq`` with flash-kernel
    ticks: q/k/v ``[held, batch, heads, block_len, head_dim]``, the shards
    ``seq`` holds here.  Differentiable: inputs that require grad go
    through :class:`RingFlashAttention`."""
    held = len(seq.shards)
    if q.shape[0] != held or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [held={held}, batch, "
                         f"heads, block_len, head_dim] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    kernel = pick_lane(q, lane)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return RingFlashAttention.apply(q, k, v, seq, causal, kernel)
    q, k, v = (x.contiguous() for x in (q, k, v))
    return _ring_forward(q, k, v, seq, causal, kernel)[0]
