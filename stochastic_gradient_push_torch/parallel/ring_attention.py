"""Ring attention over sequence shards, and blockwise attention.

Port of ``stochastic_gradient_push_tpu/parallel/ring_attention.py``.
Each shard of the sequence axis (``parallel/seq.py``: all of them
stacked here, or this process's one) holds one contiguous block of the
sequence; keys and values travel the ring (``seq.ring_shift``) while
every shard merges its queries' attention over the blocks with the
online-softmax state ``(max, numerator, denominator)``.  Across
processes the shift is differentiable on its own (its backward sends
the gradient one hop back), so autograd runs this ring as it is.

Causal masking follows the contiguous layout: at ring step ``s`` shard
``r`` holds the block of owner ``(r - s) mod sp``; positions ``r*t +
arange(t)`` against ``owner*t + arange(t)`` give the bias.  Send, then
attend: the last block received is attended after the loop.

Plain PyTorch, on the CPU and on CUDA alike (the reference is plain
XLA): autograd keeps every tick's ``[sp, b, h, t, t]`` scores, so this
is the study-scale path; ``ops/ring_flash.py`` is the long-context one.
"""

from __future__ import annotations

import torch

from ..ops.flash_attention import NEG_INF

__all__ = ["ring_attention", "blockwise_attention"]


def _block_attn(q, k, v, bias=None):
    """One (query block x key block) contribution: the running max ``m``,
    numerator ``Σ exp(s - m)·v`` and denominator ``Σ exp(s - m)``.
    ``q`` is fp32; shapes ``[..., Tq, D]`` against ``[..., Tk, D]``."""
    s = (q @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return m, p @ v.float(), p.sum(-1)


def _merge(state, m2, num2, den2):
    """Online-softmax merge of a new block into the running state."""
    m1, num1, den1 = state
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return (m, num1 * a1[..., None] + num2 * a2[..., None],
            den1 * a1 + den2 * a2)


def _init_state(qf):
    zeros = torch.zeros(qf.shape[:-1], dtype=torch.float32, device=qf.device)
    return zeros + NEG_INF, torch.zeros_like(qf), zeros


def ring_attention(q, k, v, seq, causal: bool = False):
    """Exact attention with K/V blocks rotating over the shards of
    ``seq``: q/k/v ``[held, batch, heads, block_len, head_dim]`` (the
    shards held here), returns the output in the same layout and dtype
    as ``q``."""
    sp, t = seq.size, q.shape[-2]
    rank = seq.index(q.device)
    qf = q.float()
    arange = torch.arange(t, device=q.device)

    def causal_bias(owner):
        # owner below me: fully visible; above: fully masked; mine: diagonal
        q_pos = rank[:, None] * t + arange
        k_pos = owner[:, None] * t + arange
        mask = q_pos[:, :, None] >= k_pos[:, None, :]
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        return torch.where(mask, zero, NEG_INF)[:, None, None]

    def attend(state, k_blk, v_blk, owner):
        bias = causal_bias(owner) if causal else None
        return _merge(state, *_block_attn(qf, k_blk, v_blk, bias))

    state = _init_state(qf)
    if sp > 1:
        for step in range(sp - 1):
            nk, nv = seq.ring_shift(k), seq.ring_shift(v)
            state = attend(state, k, v, (rank - step) % sp)
            k, v = nk, nv
        state = attend(state, k, v, (rank + 1) % sp)
    else:
        state = attend(state, k, v, rank)
    _, num, den = state
    return (num / den[..., None]).to(q.dtype)


def blockwise_attention(q, k, v, block_size: int, causal: bool = False):
    """Single-device memory-efficient attention (the same online-softmax
    merge, no ring): ``[batch, heads, seq, head_dim]``, ``seq %
    block_size == 0``."""
    b, h, t, d = q.shape
    if t % block_size:
        raise ValueError(f"seq {t} not divisible by block {block_size}")
    qf = q.float()
    q_pos = torch.arange(t, device=q.device)
    state = _init_state(qf)
    for i in range(t // block_size):
        blk = slice(i * block_size, (i + 1) * block_size)
        bias = None
        if causal:
            k_pos = i * block_size + torch.arange(block_size, device=q.device)
            zero = torch.zeros((), dtype=torch.float32, device=q.device)
            bias = torch.where(q_pos[:, None] >= k_pos[None, :], zero,
                               NEG_INF)
        state = _merge(state, *_block_attn(qf, k[:, :, blk], v[:, :, blk],
                                           bias))
    _, num, den = state
    return (num / den[..., None]).to(q.dtype)
