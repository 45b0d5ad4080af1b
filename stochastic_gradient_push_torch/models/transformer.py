"""Decoder-only transformer LM: the dense causal forward.

Port of ``stochastic_gradient_push_tpu/models/transformer.py``
(``TransformerConfig``, ``_rope``, ``TransformerLM`` with
``attn_impl="full"``): pre-norm blocks, rotary position embeddings,
fp32 LayerNorm (eps 1e-6, the flax default), tanh GELU (the
``jax.nn.gelu`` default), dense causal softmax attention in fp32.

``dtype`` is the reference's ``TransformerConfig.dtype`` (its
``--precision``): the compute type, with fp32 parameters (flax's
``param_dtype``).  At ``torch.bfloat16`` every Dense casts its input,
kernel and bias to bf16 and multiplies in bf16 (:class:`Dense`), the
embedding table is cast to bf16 before the gather (:class:`Embed`), so
the residual stream is bf16; LayerNorm runs in fp32 on the widened input
(:class:`LayerNorm`) and its fp32 output feeds the next bf16 Dense;
rotary embeddings rotate in fp32 and round back; ``full`` attention
takes fp32 scores of the bf16 q/k, an fp32 softmax and ``p @ v`` in
fp32, then rounds to bf16 (the flash kernels' semantics); the logits
are widened to fp32.  The casts are explicit, as the reference's are
(``torch.autocast`` would keep the embedding, and with it the residual
stream, in fp32).  ``torch.float64`` computes everything that is fp32
at the default in fp64 instead: the exact oracle the parity tests
measure rounding against.

Submodule and parameter names follow the flax tree, so a JAX parameter
path maps onto one module path (``models/convert.py``):

    embed                       Embed             embed/embedding
    block_{i}.ln1, .ln2         LayerNorm         block_{i}/ln1/{scale,bias}
    block_{i}.attn.{q,k,v,o}    Dense, no bias    block_{i}/attn/q/kernel
    block_{i}.up, .down         Dense             block_{i}/up/{kernel,bias}
    ln_f                        LayerNorm         ln_f/{scale,bias}
    lm_head                     Dense, no bias    lm_head/kernel

(``Dense``, ``Embed`` and ``LayerNorm`` are ``nn.Linear``,
``nn.Embedding`` and ``nn.LayerNorm`` with the reference's casts.)

``attn_impl`` picks the attention: ``"full"`` is the dense causal
softmax (the plain oracle the serving engine is held against, and the
plain lane of a training step); ``"flash"`` routes every layer through
``ops/flash_attention.py::flash_attention`` (the CUDA kernels, forward
and backward, on CUDA tensors; ``attn_lane="plain"`` runs their plain
twins there instead, the oracle with the kernels' own semantics);
``"blockwise"`` is the online-softmax merge over key blocks of
``attn_block_size`` (default ``min(128, t)``,
``parallel/ring_attention.py``).  ``"ring"`` and ``"ring_flash"`` run
over the sequence shards held here (``parallel/seq.py``: all ``sp``
stacked, or one a process): ``forward(tokens [held, B, t], seq)``, each
shard ``s`` at global positions ``s·t + arange(t)``; ``ring`` is plain
PyTorch, ``ring_flash`` runs the
flash kernels as its ticks (``ops/ring_flash.py``; ``attn_lane`` picks
them, as :func:`~..ops.lanes.pick_lane` does).  Embedding, LayerNorm,
MLP and head act over the extra leading dim unchanged.  ``remat=True``
recomputes each block's forward in the backward
(``torch.utils.checkpoint``, the reference's ``nn.remat(_Block)``).

``tp`` > 1 is the reference's Megatron placement over its ``tp`` mesh
axis (``train/lm.py:164-196`` there): ``q``, ``k``, ``v``, ``up`` and
``lm_head`` are :class:`ColumnDense` (output features split, ``up``'s
bias with them), ``o`` and ``down`` :class:`RowDense` (input features
split, ``down``'s bias replicated), everything else replicated.  The
forward then takes the tensor axis (``parallel/tp.py``: all ``tp``
shards stacked, or one a process): ``forward(tokens, seq, tp)``.  The
replicated activation is one tensor, a sharded one a list of the held
shards'; *f* (``tp.copy``) feeds ``ln1``'s, ``ln2``'s and ``ln_f``'s
output to the column layers, *g* (``tp.reduce``) sums ``o``'s and
``down``'s partial products before ``down``'s bias.  As the
reference's GSPMD, the split is by columns, not heads: shard ``i``
holds columns ``[i·d_model/tp, (i+1)·d_model/tp)`` of q, k and v, and a
head may straddle two shards (``n_heads`` need not divide by tp).  The
held shards' columns are joined into the whole heads they touch
(``tp.join_heads``: stacked, every head, one flash launch for all of
them; one shard a process, its heads, the columns of a shared head
gathered from the neighbour) and RoPE rotates whole heads; the
attention output is cut back to the held shards' columns for ``o``.  The
model returns the held shards' vocabulary slices of the logits, a list
(``tp.lm_loss`` takes it).

``moe_experts`` > 0 makes block ``i`` a switch mixture of experts
when ``i % moe_every == moe_every - 1`` (the reference's ``_MoEFFN``,
``models/transformer.py:141-195,231-234`` there): :class:`MoEFFN` holds
``router`` ``[D, E]``, ``experts_up`` ``[E, D, F]`` and ``experts_down``
``[E, F, D]`` (raw leaves, no transpose) and routes the ``ln2`` output
flattened to ``[B·T, D]`` (``models/moe.py``); a dropped token rides the
residual.  Its fp32 output turns a bf16 residual stream fp32 from there
on, as the reference's promotion does.  Under a ring ``attn_impl`` each
held sequence shard routes its own ``B·t`` tokens.  ``ep`` > 1 is the
reference's expert axis (``parallel/ep.py``: all ``ep`` shards stacked,
or one a process): ``forward(tokens, seq, tp, ep)`` takes the held ep
shards' batches folded into the batch dim, ``[held·B, T]`` (``[held_sp,
held·B, t]`` with a ring), and each shard routes its own rows.
``forward(..., aux=[])`` appends each MoE block's ``(load_balance,
dropped)``, one value a routing group; under ``remat`` they leave the
checkpoint as its outputs, so the recompute in the backward never
appends twice.  Under ``tp`` > 1 a MoE block's expert stacks split
their F dim over the tp shards (``experts_up`` ``[tp, E, D, F/tp]``,
``experts_down`` ``[tp, E, F/tp, D]``, ``parallel/tp.py``) and each
expert runs Megatron's column/row pair (``models/moe.py``); the router
stays replicated, so the routing is the same on every tp shard:
``forward(tokens, seq, tp, ep, aux)`` threads all four axes.

The engine (``serve/engine.py``) reuses these modules' weights through
its own prefill and paged decode paths.
"""

from __future__ import annotations

import contextlib
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
from .moe import switch_moe_ffn

__all__ = ["DTYPES", "ColumnDense", "Dense", "Embed", "LayerNorm",
           "MoEFFN", "RowDense", "TransformerConfig", "TransformerLM",
           "check_ep_axis", "check_tp_axis", "rope", "rope_tok"]

LN_EPS = 1e-6        # flax.linen.LayerNorm default
# compute types: the reference's fp32 and bf16 (--precision), and fp64 (the
# tests' exact oracle)
DTYPES = (torch.float32, torch.bfloat16, torch.float64)
ATTN_IMPLS = ("full", "blockwise", "flash", "ring", "ring_flash")
RING_IMPLS = ("ring", "ring_flash")
LANE_IMPLS = ("flash", "ring_flash")      # the attentions with a kernel
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
    attn_lane: str = "auto"     # flash, ring_flash: auto | kernel | plain
    remat: bool = False         # recompute each block in the backward
    dtype: torch.dtype = torch.float32   # compute type; params stay fp32
    tp: int = 1                 # tensor-parallel shards (parallel/tp.py)
    moe_experts: int = 0        # total experts (0: every FFN dense)
    moe_every: int = 2          # every k-th block is a MoE block
    moe_capacity_factor: float = 1.25
    ep: int = 1                 # expert-parallel shards (parallel/ep.py)

    def __post_init__(self):
        if self.moe_experts < 0 or self.ep < 1:
            raise ValueError(f"moe_experts {self.moe_experts} must be >= 0 "
                             f"and ep {self.ep} >= 1")
        if self.moe_experts > 0 and self.moe_every < 1:
            raise ValueError("moe_every must be >= 1 when moe_experts > 0")
        if self.ep > 1 and not self.moe_experts:
            raise ValueError("--ep requires --moe_experts > 0")
        if self.moe_experts % self.ep:
            raise ValueError(f"moe_experts {self.moe_experts} not divisible "
                             f"by ep {self.ep}")
        if self.tp > 1:
            from ..parallel.tp import check_tp_dims

            check_tp_dims(self.d_model, self.d_ff, self.vocab_size, self.tp)
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype} is not one of {DTYPES}")
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
        if self.attn_lane != "auto" and self.attn_impl not in LANE_IMPLS:
            raise ValueError(f"attn_lane picks the flash kernels' lane of "
                             f"{LANE_IMPLS}")

    @property
    def ring(self) -> bool:
        return self.attn_impl in RING_IMPLS

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def use_moe(self, i: int) -> bool:
        """Whether block ``i`` is a MoE block."""
        return (self.moe_experts > 0
                and i % self.moe_every == self.moe_every - 1)


def check_tp_axis(cfg: TransformerConfig, tp) -> None:
    """``ValueError`` unless ``tp`` is the tensor axis a model of
    ``cfg`` runs over: one of its size (a ``StackedTp``, or a ``DistTp``
    across processes) at ``cfg.tp`` > 1, none at tp 1."""
    if (cfg.tp > 1) != (tp is not None) or (
            tp is not None and tp.size != cfg.tp):
        raise ValueError(f"a model of tp {cfg.tp} with tp {tp!r}: tp > 1 "
                         f"runs over a tensor axis of its size (a "
                         f"StackedTp, or a DistTp across processes), tp 1 "
                         f"without one")


def check_ep_axis(cfg: TransformerConfig, ep) -> None:
    """``ValueError`` unless ``ep`` is the expert axis a model of ``cfg``
    runs over: one of its size at ``cfg.ep`` > 1, none at ep 1."""
    if (cfg.ep > 1) != (ep is not None) or (
            ep is not None and ep.size != cfg.ep):
        raise ValueError(f"a model of ep {cfg.ep} with ep {ep!r}: ep > 1 "
                         f"runs over an expert axis of its size (a "
                         f"StackedEp, or a DistEp across processes), ep 1 "
                         f"without one")


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or in fp64 if it is fp64: the type the reference
    computes its fp32 parts in (LayerNorm, softmax, logits, loss)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Dense(nn.Linear):
    """flax's ``nn.Dense(dtype=compute)`` on fp32 parameters: the input,
    kernel and bias cast to ``compute``, the product rounded to
    ``compute``, then the bias added in ``compute`` (two roundings, as
    flax's dot and add; a fused ``addmm`` would round once, and at bf16 an
    output that cancels against its bias would land many ulps away).  At
    fp32 the casts are no-ops."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True,
                 compute: torch.dtype = torch.float32):
        super().__init__(n_in, n_out, bias=bias)
        self.compute = compute

    def forward(self, x):
        return _dense(x, self.weight, self.bias, self.compute)


def _dense(x, weight, bias, dt):
    y = F.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias.to(dt)


class ColumnDense(nn.Module):
    """A column-parallel :class:`Dense`: the output features split over
    ``tp`` shards, ``weight`` ``[tp, n_out / tp, n_in]`` and ``bias``
    ``[tp, n_out / tp]`` (shard ``i`` holds rows ``[i·n_out/tp,
    (i+1)·n_out/tp)`` of the logical ``[n_out, n_in]``).  ``forward``
    takes the held shards' inputs (a list, ``parallel/tp.py``'s *f*)
    and returns each held shard's output slice."""

    def __init__(self, n_in: int, n_out: int, tp: int, bias: bool = True,
                 compute: torch.dtype = torch.float32):
        super().__init__()
        self.compute = compute
        self.weight = nn.Parameter(torch.empty(tp, n_out // tp, n_in))
        self.bias = (nn.Parameter(torch.empty(tp, n_out // tp)) if bias
                     else None)

    def forward(self, xs: list) -> list:
        return [_dense(x, self.weight[i],
                       None if self.bias is None else self.bias[i],
                       self.compute) for i, x in enumerate(xs)]


class RowDense(nn.Module):
    """A row-parallel :class:`Dense`: the input features split over
    ``tp`` shards, ``weight`` ``[tp, n_out, n_in / tp]``, ``bias``
    ``[n_out]`` replicated.  ``forward`` takes the held shards' inputs
    and sums their partial products over the shards (``tp.reduce``, *g*)
    before the bias is added."""

    def __init__(self, n_in: int, n_out: int, tp: int, bias: bool = True,
                 compute: torch.dtype = torch.float32):
        super().__init__()
        self.compute = compute
        self.weight = nn.Parameter(torch.empty(tp, n_out, n_in // tp))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, xs: list, tp) -> torch.Tensor:
        dt = self.compute
        y = tp.reduce([_dense(x, self.weight[i], None, dt)
                       for i, x in enumerate(xs)])
        return y if self.bias is None else y + self.bias.to(dt)


class Embed(nn.Embedding):
    """flax's ``nn.Embed(dtype=compute)``: the fp32 table cast to
    ``compute`` before the gather."""

    def __init__(self, n: int, e: int, compute: torch.dtype = torch.float32):
        super().__init__(n, e)
        self.compute = compute

    def forward(self, tokens):
        return F.embedding(tokens, self.weight.to(self.compute))


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm(dtype=float32)``: computed in fp32 on the
    widened input (fp64 stays fp64), whatever the stream's type."""

    def __init__(self, e: int):
        super().__init__(e, eps=LN_EPS)

    def forward(self, x):
        return super().forward(_wide(x))


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
        e = cfg.d_model
        for name in ("q", "k", "v", "o"):
            if cfg.tp == 1:
                mod = Dense(e, e, bias=False, compute=cfg.dtype)
            elif name == "o":
                mod = RowDense(e, e, cfg.tp, bias=False, compute=cfg.dtype)
            else:
                mod = ColumnDense(e, e, cfg.tp, bias=False,
                                  compute=cfg.dtype)
            self.add_module(name, mod)

    def split(self, y: torch.Tensor) -> torch.Tensor:
        """[..., T, E] -> [..., H, T, D] (H the heads of ``y``: all of
        them, or the whole heads a tp shard's columns touch)."""
        return y.reshape(*y.shape[:-1], -1,
                         self.cfg.head_dim).transpose(-2, -3)

    def attend(self, q, k, v, seq):
        cfg = self.cfg
        if cfg.attn_impl == "flash":
            return flash_attention(q, k, v.contiguous(), causal=True,
                                   lane=cfg.attn_lane)
        if cfg.attn_impl == "ring_flash":
            return ring_flash_attention(q, k, v, seq, causal=True,
                                        lane=cfg.attn_lane)
        if cfg.attn_impl == "ring":
            return ring_attention(q, k, v, seq, causal=True)
        t = q.shape[-2]
        if cfg.attn_impl == "blockwise":
            return blockwise_attention(
                q, k, v, min(cfg.attn_block_size or 128, t), causal=True)
        # the reference's full attention: scores, softmax and p @ v in
        # fp32 (at bf16, of the bf16 q/k/v), rounded once to the input type
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = (_wide(q) @ _wide(k).transpose(-1, -2)) * cfg.head_dim ** -0.5
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
        return (p @ _wide(v)).to(q.dtype)

    def forward(self, x, positions, seq=None, tp=None):
        if tp is not None:
            return self._forward_tp(x, positions, seq, tp)
        q = rope(self.split(self.q(x)), positions)
        k = rope(self.split(self.k(x)), positions)
        out = self.attend(q, k, self.split(self.v(x)), seq).transpose(-2, -3)
        return self.o(out.reshape(*out.shape[:-2], self.cfg.d_model))

    def _forward_tp(self, x, positions, seq, tp):
        """q, k and v of the held tp shards' columns joined into whole
        heads (a head may straddle two shards: ``tp.join_heads``; all
        shards held, tp 1's heads), so one attention runs over them, RoPE
        on whole heads; then the output is cut back to the held shards'
        ``d_model / tp`` columns for ``o``'s row split and its sum over
        the shards."""
        xs = tp.copy(x)
        hd = self.cfg.head_dim
        q, k, v = (self.split(y) for y in tp.join_heads(
            [self.q(xs), self.k(xs), self.v(xs)], hd))
        out = self.attend(rope(q, positions), rope(k, positions), v,
                          seq).transpose(-2, -3)
        out = out.reshape(*out.shape[:-2], -1)
        return self.o(tp.cut_heads(out, self.cfg.d_model, hd), tp)


class MoEFFN(nn.Module):
    """The switch-MoE feed-forward (``models/moe.py``): ``router`` ``[D,
    E]``, ``experts_up`` ``[E, D, F]``, ``experts_down`` ``[E, F, D]``
    (the held shards' experts: all of them, or ``E / ep`` a process); at
    ``tp`` > 1 the expert stacks hold the tp shards' F slices, ``[tp, E,
    D, F/tp]`` and ``[tp, E, F/tp, D]``, as :class:`ColumnDense` and
    :class:`RowDense` hold theirs.  ``forward(h, ep, tp)`` routes each
    group of rows of ``h`` ``[..., B, T, D]``: every leading index alone,
    and with ``ep`` the ``B`` rows cut into the held ep shards'
    batches."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.capacity_factor = cfg.moe_capacity_factor
        e, d, f, n = cfg.moe_experts, cfg.d_model, cfg.d_ff, cfg.tp
        self.router = nn.Parameter(torch.empty(d, e))
        lead = () if n == 1 else (n,)
        self.experts_up = nn.Parameter(torch.empty(*lead, e, d, f // n))
        self.experts_down = nn.Parameter(torch.empty(*lead, e, f // n, d))

    def forward(self, h: torch.Tensor, ep=None, tp=None):
        *lead, b, t, d = h.shape
        held = 1 if ep is None else len(ep.shards)
        groups = (*lead, held, b // held * t, d) if ep is not None else (
            *lead, b * t, d)
        y, aux = switch_moe_ffn(h.reshape(groups), self.router,
                                self.experts_up, self.experts_down, ep,
                                self.capacity_factor, tp)
        return y.reshape(h.shape), (aux["load_balance_loss"],
                                    aux["dropped_fraction"])


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, use_moe: bool = False):
        super().__init__()
        e, f = cfg.d_model, cfg.d_ff
        self.ln1 = LayerNorm(e)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(e)
        self.moe = MoEFFN(cfg) if use_moe else None
        if use_moe:
            return
        if cfg.tp == 1:
            self.up = Dense(e, f, compute=cfg.dtype)
            self.down = Dense(f, e, compute=cfg.dtype)
        else:
            self.up = ColumnDense(e, f, cfg.tp, compute=cfg.dtype)
            self.down = RowDense(f, e, cfg.tp, compute=cfg.dtype)

    def mlp(self, h: torch.Tensor, tp=None) -> torch.Tensor:
        if tp is None:
            return self.down(F.gelu(self.up(h), approximate="tanh"))
        return self.down([F.gelu(y, approximate="tanh")
                          for y in self.up(tp.copy(h))], tp)

    def forward(self, x, positions, seq=None, tp=None, ep=None, aux=None):
        x = x + self.attn(self.ln1(x), positions, seq, tp)
        if self.moe is None:
            return x + self.mlp(self.ln2(x), tp)
        y, stats = self.moe(self.ln2(x), ep, tp)
        if aux is not None:
            aux.append(stats)
        return x + y


def _remat_block(blk: Block, x, positions, seq, tp, ep, aux,
                 params: dict | None = None):
    """``blk(x, positions, seq, tp, ep, aux)`` with its forward recomputed
    in the backward.  The block's parameters (``params``, default its
    own) enter the checkpoint as inputs, so the recompute sees the
    tensors the caller's ``functional_call`` swapped in, after that call
    has returned.  With ``tp`` the recompute reads back the first pass's
    sums over the tp shards (``tp.tape()``) rather than reducing again.
    A MoE block's ``(load_balance, dropped)`` leave the checkpoint as
    outputs and are appended here, once."""
    if params is None:
        params = dict(blk.named_parameters())
    names = tuple(params)
    tape = None if tp is None else tp.tape()

    def run(x, *tensors):
        got = []
        with tape if tape is not None else contextlib.nullcontext():
            out = functional_call(blk, dict(zip(names, tensors)),
                                  (x, positions, seq, tp, ep, got))
        return (out, *got[0]) if got else out

    out = checkpoint(run, x, *params.values(), use_reentrant=False)
    if blk.moe is None:
        return out
    if aux is not None:
        aux.append(tuple(out[1:]))
    return out[0]


class TransformerLM(nn.Module):
    """Causal LM.  ``forward(tokens)`` with int tokens [B, T] returns fp32
    logits [B, T, vocab] (fp64 at ``dtype=torch.float64``); with a ring
    ``attn_impl``, ``forward(tokens, seq)`` takes the replica's shards
    held here ``[held, B, t]`` and returns ``[held, B, t, vocab]``.  At
    ``cfg.tp`` > 1, ``forward(tokens, seq, tp)`` returns a list: each
    held tp shard's ``[..., vocab / tp]`` slice."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, compute=cfg.dtype)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg, cfg.use_moe(i)))
        self.ln_f = LayerNorm(cfg.d_model)
        self.lm_head = (
            Dense(cfg.d_model, cfg.vocab_size, bias=False, compute=cfg.dtype)
            if cfg.tp == 1 else
            ColumnDense(cfg.d_model, cfg.vocab_size, cfg.tp, bias=False,
                        compute=cfg.dtype))

    @property
    def blocks(self) -> list[Block]:
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, tokens: torch.Tensor, seq=None, tp=None, ep=None,
                aux=None):
        check_tp_axis(self.cfg, tp)
        check_ep_axis(self.cfg, ep)
        t = tokens.shape[-1]
        positions = torch.arange(t, device=tokens.device)
        if self.cfg.ring:
            if seq is None or tokens.ndim != 3 or (
                    tokens.shape[0] != len(seq.shards)):
                raise ValueError(f"attn_impl {self.cfg.attn_impl!r} takes "
                                 f"tokens [held shards, batch, t] and their "
                                 f"sequence axis, got {tuple(tokens.shape)} "
                                 f"and {seq!r}")
            positions = seq.index(tokens.device)[:, None] * t + positions
        elif seq is not None:
            raise ValueError(f"attn_impl {self.cfg.attn_impl!r} has no "
                             f"sequence axis; ring and ring_flash do")
        x = self.embed(tokens)
        for blk in self.blocks:
            x = (_remat_block(blk, x, positions, seq, tp, ep, aux)
                 if self.cfg.remat else blk(x, positions, seq, tp, ep, aux))
        if tp is None:
            return _wide(self.lm_head(self.ln_f(x)))
        return [_wide(y) for y in self.lm_head(tp.copy(self.ln_f(x)))]
