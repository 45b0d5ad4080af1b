"""Pipeline-stage transformer LM: one stage's slice of the layer stack.

Port of ``stochastic_gradient_push_tpu/models/pipeline.py::
PipelineStageLM``.  Pairs with ``parallel/pipeline.py`` (the tick
schedule) and ``train/pp.py`` (state, step).  A stage holds

* ``embed``, ``ln_f`` and ``lm_head``, replicated over the stages: only
  stage 0 embeds and only the last stage runs the head, and the train
  step sums their gradients over the stages;
* ``stack``: ``n_local_layers`` blocks as **stacked leaves**, one a
  block leaf, ``stack.<leaf>`` of shape ``[n_local_layers, ...]`` (the
  reference's ``nn.scan`` over its ``_ScanBlock``, whose leaves are
  ``stack/block/<leaf>`` ``[L/pp, ...]`` on each stage and ``[L, ...]``
  gathered).  Stage ``s`` holds layers ``[s·L/S, (s+1)·L/S)``.

The block is ``models/transformer.py::Block``: pipelining changes the
layout, not the maths.  ``stack`` is one :class:`~.transformer.Block`
whose every parameter carries the leading layer dim; layer ``i`` runs
that block through ``functional_call`` with the ``[i]`` slices
(:meth:`PipelineStageLM.blocks`), recomputed in the backward under
``cfg.remat``.  Ring attention (``seq``) and the expert axis (``ep``)
compose as in ``TransformerLM``.  A MoE model must put an expert block
at every layer (``moe_every`` 1: the reference's scanned stack is
uniform); tensor parallelism is not a pipeline composition (the
reference refuses pp × tp).

Every entry takes the parameters explicitly (the module itself is
built on the meta device and holds none): :meth:`embed_tokens`,
:meth:`blocks` (a list of per-layer parameter dicts) and :meth:`head`.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from .transformer import (Block, Dense, Embed, LayerNorm, TransformerConfig,
                          _remat_block, _wide)

__all__ = ["PipelineStageLM", "check_pp_config"]


def check_pp_config(cfg: TransformerConfig) -> None:
    """The reference's ``ValueError`` for a MoE model whose expert blocks
    are not every block; the port's for a tensor-parallel one."""
    if cfg.moe_experts > 0 and cfg.moe_every != 1:
        raise ValueError(
            "MoE × pipeline requires moe_every=1: the stage stack is "
            "one uniform nn.scan, so every layer must share the block "
            "structure — see ARCHITECTURE.md composition matrix")
    if cfg.tp != 1:
        raise ValueError("--pp composes with gossip DP, --sp, "
                         "--moe_experts and --ep only (not --tp)")


class PipelineStageLM(nn.Module):
    """One pipeline stage of a decoder-only LM (``n_local_layers`` =
    ``cfg.n_layers // pp``).  The module never sees the stage index:
    which layers a stage runs is which parameters it is given."""

    def __init__(self, cfg: TransformerConfig, n_local_layers: int):
        super().__init__()
        check_pp_config(cfg)
        self.cfg = cfg
        self.n_local_layers = int(n_local_layers)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, compute=cfg.dtype)
        stack = Block(cfg, use_moe=cfg.moe_experts > 0)
        for mod in stack.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, name, nn.Parameter(
                    torch.empty(self.n_local_layers, *p.shape,
                                device=p.device)))
        self.stack = stack
        self.ln_f = LayerNorm(cfg.d_model)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, bias=False,
                             compute=cfg.dtype)

    @property
    def carry_dtype(self) -> torch.dtype:
        """The type of a stage's output: the compute type, widened to
        fp32 by a MoE block (its fp32 output turns the residual stream
        fp32, as in ``TransformerLM``)."""
        dt = self.cfg.dtype
        if self.cfg.moe_experts:
            dt = torch.promote_types(dt, torch.float32)
        return dt

    def embed_tokens(self, params: dict, tokens: torch.Tensor):
        """``[..., T]`` -> ``[..., T, D]`` (stage 0)."""
        return functional_call(self.embed, {"weight": params["embed.weight"]},
                               (tokens,))

    def blocks(self, layers: list, x: torch.Tensor, positions, seq=None,
               ep=None, aux=None) -> torch.Tensor:
        """A stage's layers: ``layers[i]`` is layer ``i``'s parameters
        keyed by the block's names (``ln1.weight``, ``attn.q.weight``,
        ...)."""
        for layer in layers:
            if self.cfg.remat:
                x = _remat_block(self.stack, x, positions, seq, None, ep,
                                 aux, params=layer)
            else:
                x = functional_call(self.stack, layer,
                                    (x, positions, seq, None, ep, aux))
        return x

    def head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and logits, in fp32 (the last stage)."""
        h = functional_call(self.ln_f, {"weight": params["ln_f.weight"],
                                        "bias": params["ln_f.bias"]}, (x,))
        return _wide(functional_call(
            self.lm_head, {"weight": params["lm_head.weight"]}, (h,)))
