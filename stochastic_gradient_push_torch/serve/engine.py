"""Decode engine: TransformerLM parameters -> tokens, via KV pages.

Port of ``stochastic_gradient_push_tpu/serve/engine.py`` (``ServeConfig``,
``LMEngine``, ``_prefill_fn``, ``_decode_fn``, ``_pad_len``,
``kv_bytes_per_token``) with the same slot semantics:

* **prefill** pads the prompt to a multiple of 8 (:func:`pad_len`), runs
  it through the model in one pass with the causal flash-attention
  kernel (``ops/flash_attention.py``), and scatters the roped k/v of the
  real tokens into the slot's KV pages;
* **decode** runs one token for every one of the ``max_seqs`` lanes per
  step: embed -> per layer LN, q/k/v, rope, cache write, paged-attention
  kernel (``serve/paged_attention.py``), o-proj, MLP -> LN -> lm_head ->
  argmax.  The batch is always ``max_seqs`` wide: inactive lanes decode
  a dummy token whose KV write lands in the reserved **sink page** (page
  id ``num_pages``, owned by nobody) and whose output is dropped.

Caches are ``[layers, heads, num_pages + 1, page_size, head_dim]`` fp32
on the device.  Where the reference donates the caches to its jitted
step, the port writes them in place (``index_put_``).  Page bookkeeping
is the pure-python :class:`~.pages.PageTable`, so greedy tokens and page
ids follow the reference step for step.

Numerics: the reference engine is fp32 end to end (fp32 params and
caches).  The engine therefore turns TF32 off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``, process-wide) when it is built;
parity with the reference and with the dense model depends on it.

The kernels run for CUDA tensors and their plain twins for CPU tensors
(``ops/lanes.py``); the engine's device decides, and it is CUDA unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import config_from_params, params_from_jax
from ..models.transformer import TransformerLM, rope, rope_tok
from ..ops.flash_attention import flash_attention
from .paged_attention import paged_attention_decode
from .pages import PageTable, pages_for

__all__ = ["ServeConfig", "LMEngine", "pad_len", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Decode-engine shape knobs (the model's own shape is inferred
    from the params; only ``n_heads`` cannot be)."""

    n_heads: int
    page_size: int = 8
    num_pages: int = 64
    max_seqs: int = 4
    max_pages_per_seq: int = 8

    @property
    def max_tokens_per_seq(self) -> int:
        return self.max_pages_per_seq * self.page_size


def pad_len(t: int) -> int:
    """Prompt pad bucket: the next multiple of 8 (the reference's
    ``_pad_len``; the flash kernel itself takes any length)."""
    return max(8, -(-t // 8) * 8)


@torch.no_grad()
def prefill(model: TransformerLM, tokens: torch.Tensor):
    """Prompt pass.  ``tokens`` [t] -> (logits [t, vocab], k, v
    [layers, heads, t, head_dim], roped and cache-ready)."""
    t = tokens.shape[0]
    positions = torch.arange(t, device=tokens.device)
    x = model.embed.weight[tokens][None]                    # [1, t, E]
    ks, vs = [], []
    for blk in model.blocks:
        h = blk.ln1(x)
        attn = blk.attn
        q = rope(attn.split(attn.q(h)), positions)
        k = rope(attn.split(attn.k(h)), positions).contiguous()
        v = attn.split(attn.v(h)).contiguous()
        ks.append(k[0])
        vs.append(v[0])
        out = flash_attention(q.contiguous(), k, v, causal=True)
        x = x + attn.o(out.transpose(1, 2).reshape(1, t, -1))
        x = x + blk.mlp(blk.ln2(x))
    logits = model.lm_head(model.ln_f(x))[0].float()
    return logits, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode(model: TransformerLM, k_cache, v_cache, tokens, positions,
           dest_page, dest_off, page_indices, lengths):
    """One decode step for the full slot batch.  ``tokens``/``positions``
    /``dest_page``/``dest_off`` [B] (long); ``page_indices`` int32
    [B, max_pages]; ``lengths`` int32 [B].  Writes each token's k/v into
    ``k_cache``/``v_cache`` at ``(dest_page, dest_off)`` in place and
    returns the logits [B, vocab]."""
    cfg = model.cfg
    bsz = tokens.shape[0]
    heads = torch.arange(cfg.n_heads, device=tokens.device)[:, None]
    where = (heads, dest_page[None], dest_off[None])        # -> [H, B]
    x = model.embed.weight[tokens]                          # [B, E]
    for i, blk in enumerate(model.blocks):
        h = blk.ln1(x)
        attn = blk.attn
        q = rope_tok(attn.q(h).reshape(bsz, cfg.n_heads, cfg.head_dim),
                     positions)
        k = rope_tok(attn.k(h).reshape(bsz, cfg.n_heads, cfg.head_dim),
                     positions)
        v = attn.v(h).reshape(bsz, cfg.n_heads, cfg.head_dim)
        # cache[i, :, dest_page[b], dest_off[b]] = k[b], in place (the
        # reference donates the cache to its jitted step instead)
        k_cache[i].index_put_(where, k.transpose(0, 1))
        v_cache[i].index_put_(where, v.transpose(0, 1))
        out = paged_attention_decode(q.contiguous(), k_cache[i], v_cache[i],
                                     page_indices, lengths)
        x = x + attn.o(out.reshape(bsz, cfg.d_model))
        x = x + blk.mlp(blk.ln2(x))
    return model.lm_head(model.ln_f(x)).float()


class LMEngine:
    """Slot-based decode engine over one parameter set.

    ``params`` is a JAX-layout tree (nested dicts of arrays, as the JAX
    package's ``model.init`` or consensus ingest returns it).  The
    scheduler drives the engine through :meth:`can_admit`, :meth:`start`
    (prefill a prompt into a fresh slot, returning the first generated
    token), :meth:`step` (one greedy token for every live slot) and
    :meth:`finish` (release the slot's pages).  ``last_logits`` holds
    the fp32 logits of the latest :meth:`start` ([prompt_len, vocab]) or
    :meth:`step` ([max_seqs, vocab]) call.
    """

    def __init__(self, params, config: ServeConfig, device=None):
        self.device = resolve_device(device)
        # fp32 end to end, as the reference: no TF32 anywhere on the path
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.cfg = config_from_params(params, config.n_heads)
        if self.cfg.moe_experts:
            # the reference's engine runs dense blocks (up/down) only
            raise ValueError("serving a MoE model: the engine's prefill and "
                             "decode run dense FFN blocks (as the "
                             "reference's)")
        self.model = TransformerLM(self.cfg)
        self.model.load_state_dict(params_from_jax(params))
        self.model.to(self.device).eval().requires_grad_(False)
        self.n_layers = self.cfg.n_layers
        self.head_dim = self.cfg.head_dim
        self.pages = PageTable(config.num_pages, config.page_size,
                               config.max_seqs)
        # +1 page: the sink, where inactive slots' dummy KV writes land
        self._sink = config.num_pages
        cache_shape = (self.n_layers, config.n_heads, config.num_pages + 1,
                       config.page_size, self.head_dim)
        self._kc = torch.zeros(cache_shape, dtype=torch.float32,
                               device=self.device)
        self._vc = torch.zeros_like(self._kc)
        self._last_tok = np.zeros(config.max_seqs, np.int64)
        self.last_logits: torch.Tensor | None = None

    # -- admission ---------------------------------------------------------

    def can_admit(self, budget_tokens: int) -> bool:
        return (budget_tokens <= self.config.max_tokens_per_seq
                and self.pages.can_fit(budget_tokens))

    def start(self, prompt, budget_tokens: int):
        """Prefill ``prompt`` into a fresh slot (the page table's typed
        backpressure propagates) and return ``(slot, first_token)``."""
        if not prompt:
            raise ValueError("empty prompt")
        if budget_tokens > self.config.max_tokens_per_seq:
            raise ValueError(
                f"budget {budget_tokens} tokens exceeds a slot's "
                f"{self.config.max_tokens_per_seq}-token page window")
        slot = self.pages.open(budget_tokens)
        t = len(prompt)
        padded = np.zeros(pad_len(t), np.int64)
        padded[:t] = prompt
        logits, ks, vs = prefill(self.model,
                                 torch.from_numpy(padded).to(self.device))
        self.pages.append(slot, t)
        # scatter the prompt's roped k/v into the slot's pages, one
        # index_put_ per cache: token j lands at (page j // size, j % size)
        size = self.config.page_size
        pos = np.arange(t)
        page_ids = np.asarray(self.pages.pages_of(slot))[pos // size]
        where = (torch.from_numpy(page_ids).to(self.device),
                 torch.from_numpy(pos % size).to(self.device))
        self._kc[:, :, where[0], where[1]] = ks[:, :, :t]
        self._vc[:, :, where[0], where[1]] = vs[:, :, :t]
        self.last_logits = logits[:t]
        tok = int(torch.argmax(logits[t - 1]))
        self._last_tok[slot] = tok
        return slot, tok

    # -- decode ------------------------------------------------------------

    def step(self, slots) -> dict[int, int]:
        """One greedy token for every slot in ``slots``; appends each
        new token's KV to its pages.  Batch shape is always
        ``max_seqs`` — absent slots ride as masked lanes."""
        if not slots:
            return {}
        cfg = self.config
        bsz = cfg.max_seqs
        tokens = np.zeros(bsz, np.int64)
        positions = np.zeros(bsz, np.int64)
        dest_page = np.full(bsz, self._sink, np.int64)
        dest_off = np.zeros(bsz, np.int64)
        page_rows = np.full((bsz, cfg.max_pages_per_seq), self._sink,
                            np.int32)
        lengths = np.ones(bsz, np.int32)
        order = sorted(slots)
        for slot in order:
            self.pages.append(slot, 1)      # the token decoded this step
            page, off = self.pages.last_position(slot)
            tokens[slot] = self._last_tok[slot]
            positions[slot] = self.pages.length(slot) - 1
            dest_page[slot] = page
            dest_off[slot] = off
            lengths[slot] = self.pages.length(slot)
            row = self.pages.pages_of(slot)
            page_rows[slot, :len(row)] = row
        dev = self.device
        logits = decode(
            self.model, self._kc, self._vc,
            *(torch.from_numpy(a).to(dev) for a in (
                tokens, positions, dest_page, dest_off, page_rows,
                lengths)))
        self.last_logits = logits
        nxt = torch.argmax(logits, -1).cpu().numpy()
        out = {}
        for slot in order:
            self._last_tok[slot] = nxt[slot]
            out[slot] = int(nxt[slot])
        return out

    def finish(self, slot: int) -> None:
        self.pages.close(slot)

    # -- introspection -----------------------------------------------------

    def kv_bytes_per_token(self) -> int:
        """Modeled KV footprint of one token across all layers (the
        bench artifact's capacity-planning number)."""
        return (2 * self.n_layers * self.config.n_heads * self.head_dim
                * self._kc.element_size())

    def required_pages(self, budget_tokens: int) -> int:
        return pages_for(budget_tokens, self.config.page_size)
