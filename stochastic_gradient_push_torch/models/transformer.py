"""Decoder-only transformer LM: the dense causal forward.

Port of ``stochastic_gradient_push_tpu/models/transformer.py``
(``TransformerConfig``, ``_rope``, ``TransformerLM`` with
``attn_impl="full"``): pre-norm blocks, rotary position embeddings,
fp32 LayerNorm (eps 1e-6, the flax default), tanh GELU (the
``jax.nn.gelu`` default), dense causal softmax attention in fp32.

Submodule and parameter names follow the flax tree, so a JAX parameter
path maps onto one module path (``models/convert.py``):

    embed                       nn.Embedding      embed/embedding
    block_{i}.ln1, .ln2         nn.LayerNorm      block_{i}/ln1/{scale,bias}
    block_{i}.attn.{q,k,v,o}    nn.Linear, no bias  block_{i}/attn/q/kernel
    block_{i}.up, .down         nn.Linear         block_{i}/up/{kernel,bias}
    ln_f                        nn.LayerNorm      ln_f/{scale,bias}
    lm_head                     nn.Linear, no bias  lm_head/kernel

``attn_impl`` picks the attention: ``"full"`` is the dense causal
softmax (the plain oracle the serving engine is held against, and the
plain lane of a training step); ``"flash"`` routes every layer through
``ops/flash_attention.py::flash_attention`` (the CUDA kernels, forward
and backward, on CUDA tensors); ``"blockwise"`` is the online-softmax
merge over key blocks of ``attn_block_size`` (default ``min(128, t)``,
``parallel/ring_attention.py``).  ``"ring"`` and ``"ring_flash"`` run
over the sequence shards of a :class:`~..parallel.seq.StackedSeq`:
``forward(tokens [sp, B, t], seq)``, each shard at global positions
``s·t + arange(t)``; ``ring`` is plain PyTorch, ``ring_flash`` runs the
flash kernels as its ticks (``ops/ring_flash.py``; ``attn_lane`` picks
them, as :func:`~..ops.lanes.pick_lane` does).  Embedding, LayerNorm,
MLP and head act over the extra leading dim unchanged.  ``remat=True``
recomputes each block's forward in the backward
(``torch.utils.checkpoint``, the reference's ``nn.remat(_Block)``).

The engine (``serve/engine.py``) reuses these modules' weights through
its own prefill and paged decode paths.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import NEG_INF, flash_attention
from ..ops.lanes import LANES
from ..ops.ring_flash import ring_flash_attention
from ..parallel.ring_attention import blockwise_attention, ring_attention
from ..parallel.seq import StackedSeq

__all__ = ["TransformerConfig", "TransformerLM", "rope", "rope_tok"]

LN_EPS = 1e-6        # flax.linen.LayerNorm default
ATTN_IMPLS = ("full", "blockwise", "flash", "ring", "ring_flash")
RING_IMPLS = ("ring", "ring_flash")
ROPE_BASE = 10000.0


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 6
    n_heads: int = 8
    d_ff: int = 2048
    attn_impl: str = "full"     # full | blockwise | flash | ring | ring_flash
    attn_block_size: int | None = None   # blockwise only; None: min(128, t)
    attn_lane: str = "auto"     # ring_flash ticks: auto | kernel | plain
    remat: bool = False         # recompute each block in the backward

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} is not one of "
                             f"{ATTN_IMPLS}")
        if self.attn_block_size is not None and self.attn_impl != "blockwise":
            raise ValueError("attn_block_size sets the blockwise attention's "
                             "key block; the flash kernels' tiles are their "
                             "own")
        if self.attn_lane not in LANES:
            raise ValueError(f"attn_lane {self.attn_lane!r} is not one of "
                             f"{LANES}")
        if self.attn_lane != "auto" and self.attn_impl != "ring_flash":
            raise ValueError("attn_lane picks the ring_flash ticks' lane")

    @property
    def ring(self) -> bool:
        return self.attn_impl in RING_IMPLS

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rope_angles(positions: torch.Tensor, d: int):
    half = d // 2
    freqs = ROPE_BASE ** (-torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings.  ``x`` [..., B, H, T, D]; ``positions`` [T], or
    [sp, T] for ``x`` [sp, B, H, T, D] (each shard's global positions)."""
    cos, sin = _rope_angles(positions, x.shape[-1])     # [..., T, half]
    if positions.ndim == 2:
        cos, sin = cos[:, None, None], sin[:, None, None]
    return _rotate(x, cos, sin)


def rope_tok(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings for one token per sequence: ``x`` [B, H, D],
    ``positions`` [B] (the reference engine's ``_rope_tok``)."""
    cos, sin = _rope_angles(positions, x.shape[-1])     # [B, half]
    return _rotate(x, cos[:, None], sin[:, None])


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        for name in ("q", "k", "v", "o"):
            self.add_module(name, nn.Linear(cfg.d_model, cfg.d_model,
                                            bias=False))

    def split(self, y: torch.Tensor) -> torch.Tensor:
        """[..., T, E] -> [..., H, T, D]."""
        return y.reshape(*y.shape[:-1], self.cfg.n_heads,
                         self.cfg.head_dim).transpose(-2, -3)

    def attend(self, q, k, v, seq):
        cfg = self.cfg
        if cfg.attn_impl == "flash":
            return flash_attention(q, k, v.contiguous(), causal=True)
        if cfg.attn_impl == "ring_flash":
            return ring_flash_attention(q, k, v, seq, causal=True,
                                        lane=cfg.attn_lane)
        if cfg.attn_impl == "ring":
            return ring_attention(q, k, v, seq, causal=True)
        t = q.shape[-2]
        if cfg.attn_impl == "blockwise":
            return blockwise_attention(
                q, k, v, min(cfg.attn_block_size or 128, t), causal=True)
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = (q @ k.transpose(-1, -2)) * cfg.head_dim ** -0.5
        return torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1) @ v

    def forward(self, x, positions, seq=None):
        q = rope(self.split(self.q(x)), positions)
        k = rope(self.split(self.k(x)), positions)
        out = self.attend(q, k, self.split(self.v(x)), seq).transpose(-2, -3)
        return self.o(out.reshape(*out.shape[:-2], self.cfg.d_model))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.attn = Attention(cfg)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.up = nn.Linear(cfg.d_model, cfg.d_ff)
        self.down = nn.Linear(cfg.d_ff, cfg.d_model)

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(h), approximate="tanh"))

    def forward(self, x, positions, seq=None):
        x = x + self.attn(self.ln1(x), positions, seq)
        return x + self.mlp(self.ln2(x))


def _remat_block(blk: Block, x, positions, seq):
    """``blk(x, positions, seq)`` with its forward recomputed in the
    backward.  The block's parameters enter the checkpoint as inputs, so
    the recompute sees the tensors the caller's ``functional_call`` swapped
    in, after that call has returned."""
    params = dict(blk.named_parameters())
    names = tuple(params)

    def run(x, *tensors):
        return functional_call(blk, dict(zip(names, tensors)),
                               (x, positions, seq))

    return checkpoint(run, x, *params.values(), use_reentrant=False)


class TransformerLM(nn.Module):
    """Causal LM.  ``forward(tokens)`` with int tokens [B, T] returns fp32
    logits [B, T, vocab]; with a ring ``attn_impl``, ``forward(tokens,
    seq)`` takes a replica's shards ``[sp, B, t]`` and returns ``[sp, B,
    t, vocab]``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)

    @property
    def blocks(self) -> list[Block]:
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, tokens: torch.Tensor,
                seq: StackedSeq | None = None) -> torch.Tensor:
        t = tokens.shape[-1]
        positions = torch.arange(t, device=tokens.device)
        if self.cfg.ring:
            if seq is None or tokens.ndim != 3 or tokens.shape[0] != seq.size:
                raise ValueError(f"attn_impl {self.cfg.attn_impl!r} takes "
                                 f"tokens [sp, batch, t] and their "
                                 f"StackedSeq, got {tuple(tokens.shape)} and "
                                 f"{seq!r}")
            positions = seq.index(tokens.device)[:, None] * t + positions
        elif seq is not None:
            raise ValueError(f"attn_impl {self.cfg.attn_impl!r} has no "
                             f"sequence axis; ring and ring_flash do")
        x = self.embed(tokens)
        for blk in self.blocks:
            x = (_remat_block(blk, x, positions, seq) if self.cfg.remat
                 else blk(x, positions, seq))
        return self.lm_head(self.ln_f(x)).float()
