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
and backward, on CUDA tensors).  The engine (``serve/engine.py``)
reuses these modules' weights through its own prefill and paged decode
paths.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import NEG_INF, flash_attention

__all__ = ["TransformerConfig", "TransformerLM", "rope", "rope_tok"]

LN_EPS = 1e-6        # flax.linen.LayerNorm default
ATTN_IMPLS = ("full", "flash")
ROPE_BASE = 10000.0


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 6
    n_heads: int = 8
    d_ff: int = 2048
    attn_impl: str = "full"     # full | flash

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise NotImplementedError(
                f"attn_impl {self.attn_impl!r} is not ported yet (a later "
                f"slice: blockwise, ring and ring_flash come with the "
                f"sequence-parallel LM path); the port has {ATTN_IMPLS}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rope_angles(positions: torch.Tensor, d: int):
    half = d // 2
    freqs = ROPE_BASE ** (-torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half)
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings.  ``x`` [B, H, T, D]; ``positions`` [T]."""
    cos, sin = _rope_angles(positions, x.shape[-1])     # [T, half]
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
        """[B, T, E] -> [B, H, T, D]."""
        b, t, _ = y.shape
        return y.reshape(b, t, self.cfg.n_heads,
                         self.cfg.head_dim).transpose(1, 2)

    def forward(self, x, positions):
        q = rope(self.split(self.q(x)), positions)
        k = rope(self.split(self.k(x)), positions)
        v = self.split(self.v(x))
        if self.cfg.attn_impl == "flash":
            out = flash_attention(q, k, v.contiguous(), causal=True)
            b, h, t, d = out.shape
            return self.o(out.transpose(1, 2).reshape(b, t, h * d))
        t = q.shape[2]
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = (q @ k.transpose(-1, -2)) * self.cfg.head_dim ** -0.5
        s = s.masked_fill(~mask, NEG_INF)
        out = torch.softmax(s, dim=-1) @ v
        b, h, t, d = out.shape
        return self.o(out.transpose(1, 2).reshape(b, t, h * d))


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

    def forward(self, x, positions):
        x = x + self.attn(self.ln1(x), positions)
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """Causal LM.  ``forward(tokens)`` with int tokens [B, T] returns fp32
    logits [B, T, vocab]."""

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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed(tokens)
        for blk in self.blocks:
            x = blk(x, positions)
        return self.lm_head(self.ln_f(x)).float()
