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
  kernel (``serve/paged_attention.py::sharded_paged_decode``), o-proj,
  MLP -> LN -> lm_head -> argmax.  The batch is always ``max_seqs``
  wide: inactive lanes decode a dummy token whose KV write lands in the
  reserved **sink page** (page id ``num_pages``, owned by nobody) and
  whose output is dropped.

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

**KV-head shards.**  The engine runs its model as ``S`` shards (``S`` = 1
unless ``shards`` or a ``tp`` axis says otherwise; ``S`` > 1 is the
reference's ``LMEngine(mesh=...)`` on a 1-D ``model`` mesh).  It places
the parameters as ``serve/load.py::shard_params_for_decode`` does and
runs each shard with the operations a process of ``parallel/tp.py``'s
process lane runs on its one shard: q, k and v from the shard's column
blocks, the shard's own heads of the KV cache ``[layers, heads / S,
num_pages + 1, page_size, head_dim]``, the flash kernel (prefill) or the
paged kernel (decode, one ``sharded_paged_decode`` head slice a shard)
on its heads, ``o`` as a row block and ``tp.reduce`` (a fold in shard
order), ``up``/``down`` as a column and row pair and ``tp.reduce``,
``lm_head`` on the shard's vocab block.  A leaf the rules leave
replicated runs whole, with no sum; at ``S`` = 1 every leaf does, and
the passes are the whole model's.  ``StackedTp(S)`` holds every
shard on one device (one kernel launch a shard); ``DistTp`` holds one
shard a process, its sums an all-gather on the group, so the processes
compute the stack's bits.  The greedy token comes from the shards'
``(max, argmax)`` pairs: the largest max wins, a tie the lowest global
index (``jnp.argmax`` over the gathered vocabulary); the ``[batch,
vocab]`` logits are gathered only when :attr:`LMEngine.last_logits` is
read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.convert import config_from_params
from ..models.transformer import LN_EPS, rope, rope_tok
from ..ops.flash_attention import flash_attention
from ..parallel.tp import StackedTp
from .paged_attention import sharded_paged_decode
from .pages import PageTable, pages_for

__all__ = ["ServeConfig", "LMEngine", "pad_len"]


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


class _ShardedLM:
    """The held shards' weights of the engine's model, on ``device``, in
    the port's ``[out, in]`` layout, and the shard by shard forward
    passes (see the module docstring)."""

    def __init__(self, params, cfg, tp, device):
        from .load import decode_placement, shard_params_for_decode

        self.cfg, self.tp = cfg, tp
        size = tp.size
        dims = decode_placement(params, size)
        parts = shard_params_for_decode(params, size)

        def put(a, kernel=False):
            a = np.asarray(a, np.float32)
            if kernel:      # flax [in, out] -> [out, in]
                a = a.swapaxes(-1, -2)
            return torch.tensor(a, device=device)       # a copy

        def ln(tree):
            return put(tree["scale"]), put(tree["bias"])

        self.embed = put(params["embed"]["embedding"])
        self.ln_f = ln(params["ln_f"])
        self.vocab_split = dims["lm_head"]["kernel"] is not None
        self.lm_head = ([put(parts[i]["lm_head"]["kernel"], True)
                         for i in tp.shards] if self.vocab_split
                        else [put(params["lm_head"]["kernel"], True)])
        self.layers, self.held = [], []
        for layer in range(cfg.n_layers):
            blk = params[f"block_{layer}"]
            d = dims[f"block_{layer}"]
            if size > 1 and d["attn"]["q"]["kernel"] is None:
                raise ValueError(f"d_model {cfg.d_model} not divisible by "
                                 f"{size} shards")
            common = {"ln1": ln(blk["ln1"]), "ln2": ln(blk["ln2"]),
                      "down_b": put(blk["down"]["bias"]),
                      "mlp_split": d["up"]["kernel"] is not None}
            if not common["mlp_split"]:
                common.update(up=put(blk["up"]["kernel"], True),
                              up_b=put(blk["up"]["bias"]),
                              down=put(blk["down"]["kernel"], True))
            self.layers.append(common)
            held = []
            for i in tp.shards:
                b = parts[i][f"block_{layer}"]
                w = {n: put(b["attn"][n]["kernel"], True)
                     for n in ("q", "k", "v", "o")}
                if common["mlp_split"]:
                    f = b["up"]["kernel"].shape[1]
                    w.update(up=put(b["up"]["kernel"], True),
                             up_b=put(blk["up"]["bias"][i * f:(i + 1) * f]),
                             down=put(b["down"]["kernel"], True))
                held.append(w)
            self.held.append(held)

    def _ln(self, x, wb):
        return F.layer_norm(x, (x.shape[-1],), wb[0], wb[1], LN_EPS)

    def _mlp(self, layer: int, h):
        c = self.layers[layer]
        if not c["mlp_split"]:
            y = F.gelu(F.linear(h, c["up"]) + c["up_b"], approximate="tanh")
            return F.linear(y, c["down"]) + c["down_b"]
        parts = [F.linear(F.gelu(F.linear(h, w["up"]) + w["up_b"],
                                 approximate="tanh"), w["down"])
                 for w in self.held[layer]]
        return self.tp.reduce(parts) + c["down_b"]

    def _logits(self, x) -> list:
        h = self._ln(x, self.ln_f)
        return [F.linear(h, w).float() for w in self.lm_head]

    @torch.no_grad()
    def prefill(self, tokens):
        """``tokens`` [t] -> (the held shards' logits [t, vocab / S] (or
        the whole [t, vocab] where lm_head is replicated), k, v [layers,
        held heads, t, head_dim])."""
        t = tokens.shape[0]
        d = self.cfg.head_dim
        positions = torch.arange(t, device=tokens.device)
        x = self.embed[tokens][None]                        # [1, t, E]
        ks, vs = [], []
        for layer, held in enumerate(self.held):
            h = self._ln(x, self.layers[layer]["ln1"])
            parts, kl, vl = [], [], []
            for w in held:
                def heads(y):
                    return y.reshape(1, t, -1, d).transpose(1, 2)
                q = rope(heads(F.linear(h, w["q"])), positions)
                k = rope(heads(F.linear(h, w["k"])), positions).contiguous()
                v = heads(F.linear(h, w["v"])).contiguous()
                kl.append(k[0])
                vl.append(v[0])
                out = flash_attention(q.contiguous(), k, v, causal=True)
                parts.append(F.linear(out.transpose(1, 2).reshape(1, t, -1),
                                      w["o"]))
            x = x + self.tp.reduce(parts)
            x = x + self._mlp(layer, self._ln(x, self.layers[layer]["ln2"]))
            ks.append(torch.cat(kl))
            vs.append(torch.cat(vl))
        return ([lg[0] for lg in self._logits(x)], torch.stack(ks),
                torch.stack(vs))

    @torch.no_grad()
    def decode(self, k_cache, v_cache, tokens, positions, dest_page,
               dest_off, page_indices, lengths) -> list:
        """One decode step over the held shards' heads of the caches:
        each shard's k/v written at ``(dest_page, dest_off)`` in place, the
        paged decode run on each held shard's head slice; returns the held
        shards' logits [B, vocab / S] (or the whole)."""
        bsz = tokens.shape[0]
        d = self.cfg.head_dim
        hs = self.cfg.n_heads // self.tp.size
        heads = torch.arange(hs, device=tokens.device)[:, None]
        where = (heads, dest_page[None], dest_off[None])     # -> [hs, B]
        x = self.embed[tokens]                               # [B, E]
        for layer, held in enumerate(self.held):
            h = self._ln(x, self.layers[layer]["ln1"])
            qs = []
            for j, w in enumerate(held):
                qs.append(rope_tok(F.linear(h, w["q"]).reshape(bsz, hs, d),
                                   positions))
                k = rope_tok(F.linear(h, w["k"]).reshape(bsz, hs, d),
                             positions)
                v = F.linear(h, w["v"]).reshape(bsz, hs, d)
                # this shard's heads of the caches: a contiguous slice
                k_cache[layer, j * hs:(j + 1) * hs].index_put_(
                    where, k.transpose(0, 1))
                v_cache[layer, j * hs:(j + 1) * hs].index_put_(
                    where, v.transpose(0, 1))
            out = sharded_paged_decode(torch.cat(qs, dim=1), k_cache[layer],
                                       v_cache[layer], page_indices, lengths,
                                       len(held))
            parts = [F.linear(out[:, j * hs:(j + 1) * hs].reshape(
                bsz, hs * d), w["o"]) for j, w in enumerate(held)]
            x = x + self.tp.reduce(parts)
            x = x + self._mlp(layer, self._ln(x, self.layers[layer]["ln2"]))
        return self._logits(x)

    def greedy(self, parts: list) -> torch.Tensor:
        """The greedy token of each row over the whole vocabulary from the
        held shards' logits: the shards' ``(max, argmax)`` pairs, gathered
        in shard order; the largest max wins, a tie the lowest index."""
        if not self.vocab_split:
            return torch.argmax(parts[0], -1)
        v = parts[0].shape[-1]
        pairs = [torch.stack([lg.amax(-1).double(),
                              (torch.argmax(lg, -1) + i * v).double()], -1)
                 for i, lg in zip(self.tp.shards, parts)]
        best, *rest = self.tp.gather(pairs)
        for p in rest:
            best = torch.where((p[..., 0] > best[..., 0])[..., None], p,
                               best)
        return best[..., 1].long()

    def gather_logits(self, parts: list) -> torch.Tensor:
        """The whole ``[..., vocab]`` logits from the held shards'."""
        if not self.vocab_split:
            return parts[0]
        return torch.cat(self.tp.gather(parts), dim=-1)


class LMEngine:
    """Slot-based decode engine over one parameter set.

    ``params`` is a JAX-layout tree (nested dicts of arrays, as the JAX
    package's ``model.init`` or consensus ingest returns it).  The
    scheduler drives the engine through :meth:`can_admit`, :meth:`start`
    (prefill a prompt into a fresh slot, returning the first generated
    token), :meth:`step` (one greedy token for every live slot) and
    :meth:`finish` (release the slot's pages).  ``last_logits`` holds
    the fp32 logits of the latest :meth:`start` ([prompt_len, vocab]) or
    :meth:`step` ([max_seqs, vocab]) call (gathered over the shards when
    read).

    The model runs as ``tp``'s shards (a :class:`~..parallel.tp.StackedTp`,
    or a ``DistTp`` for one shard a process), by default as
    ``StackedTp(shards)``: ``shards=1`` is one shard holding the whole
    model.
    """

    def __init__(self, params, config: ServeConfig, device=None,
                 shards: int = 1, tp=None):
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
        if tp is None:
            tp = StackedTp(shards)
        elif shards not in (1, tp.size):
            raise ValueError(f"shards {shards} but a tp axis of {tp.size}")
        self.tp = tp
        self.shards = tp.size
        if config.n_heads % self.shards:
            raise ValueError(f"kv_heads {config.n_heads} not divisible by "
                             f"mesh axis 'model' size {self.shards}")
        self.n_layers = self.cfg.n_layers
        self.head_dim = self.cfg.head_dim
        self._lm = _ShardedLM(params, self.cfg, tp, self.device)
        held_heads = config.n_heads // tp.size * len(tp.shards)
        self.pages = PageTable(config.num_pages, config.page_size,
                               config.max_seqs)
        # +1 page: the sink, where inactive slots' dummy KV writes land
        self._sink = config.num_pages
        cache_shape = (self.n_layers, held_heads, config.num_pages + 1,
                       config.page_size, self.head_dim)
        self._kc = torch.zeros(cache_shape, dtype=torch.float32,
                               device=self.device)
        self._vc = torch.zeros_like(self._kc)
        self._last_tok = np.zeros(config.max_seqs, np.int64)
        self._last_parts: list | None = None

    @property
    def last_logits(self) -> torch.Tensor | None:
        """The latest call's fp32 logits over the whole vocabulary (on a
        ``DistTp`` engine a collective: every process reads them)."""
        if self._last_parts is None:
            return None
        return self._lm.gather_logits(self._last_parts)

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
        tokens = torch.from_numpy(padded).to(self.device)
        parts, ks, vs = self._lm.prefill(tokens)
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
        self._last_parts = [lg[:t] for lg in parts]
        tok = int(self._lm.greedy([lg[t - 1] for lg in parts]))
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
        args = [torch.from_numpy(a).to(dev) for a in (
            tokens, positions, dest_page, dest_off, page_rows, lengths)]
        self._last_parts = self._lm.decode(self._kc, self._vc, *args)
        nxt = self._lm.greedy(self._last_parts).cpu().numpy()
        out = {}
        for slot in order:
            self._last_tok[slot] = nxt[slot]
            out[slot] = int(nxt[slot])
        return out

    def finish(self, slot: int) -> None:
        self.pages.close(slot)

    # -- introspection -----------------------------------------------------

    def kv_bytes_per_token(self) -> int:
        """Modeled KV footprint of one token across all layers and every
        shard (the bench artifact's capacity-planning number)."""
        return (2 * self.n_layers * self.config.n_heads * self.head_dim
                * self._kc.element_size())

    def required_pages(self, budget_tokens: int) -> int:
        return pages_for(budget_tokens, self.config.page_size)
