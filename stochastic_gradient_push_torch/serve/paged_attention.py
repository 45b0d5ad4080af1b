"""Paged-attention decode: the hand-written CUDA kernel and its plain twin.

Port of ``stochastic_gradient_push_tpu/serve/paged_attention.py``
(``paged_attention_decode:203``, ``paged_attention_reference:85``,
``_check_shapes:62``), same signature and layouts: q ``[batch, q_heads,
head_dim]``; k/v pages ``[kv_heads, num_pages, page_size, head_dim]``;
int32 ``page_indices [batch, max_pages]``; ``lengths [batch]``, each ≥ 1
and counting the token being decoded.  GQA: ``q_heads = kv_heads *
group``.

* :func:`paged_decode` launches ``csrc/paged_decode.cu`` (CUDA, fp32,
  head_dim 64, group 1..8): a split-sequence decode, each split of
  :func:`split_pages` pages written as a partial ``(m, den, acc)`` to a
  workspace, the partials folded in split order by a second kernel;
* :func:`paged_attention_reference` gathers every named page and runs
  masked softmax attention — the CPU lane and the kernel's oracle;
* :func:`paged_attention_decode` picks between them by device;
* :func:`sharded_paged_decode` is the reference's KV-head-sharded decode
  (``:224-249`` there, a ``shard_map`` over a 1-D ``model`` mesh): each
  shard's head slice decoded alone, one :func:`paged_attention_decode` a
  shard, with no collective.  On one card every shard runs, one kernel
  launch each; a process of a sharded engine runs its own.
"""

from __future__ import annotations

import torch

from ..ops import _build
from ..ops.flash_attention import NEG_INF
from ..ops.lanes import use_kernel

__all__ = ["paged_attention_decode", "paged_attention_reference",
           "paged_decode", "sharded_paged_decode", "split_pages"]

HEAD_DIM = 64
MAX_GROUP = 8      # csrc/paged_decode.cu instantiates groups 1..8
SPLIT_TOKENS = 64  # tokens per split of the kernel's grid, in whole pages


def split_pages(page_size: int) -> int:
    """Pages per split of ``csrc/paged_decode.cu``: ~``SPLIT_TOKENS``
    tokens, at least one page."""
    return max(1, SPLIT_TOKENS // page_size)


def _check_shapes(q, k_pages, v_pages, page_indices, lengths):
    if q.ndim != 3:
        raise ValueError(f"q must be [batch, q_heads, head_dim], got "
                         f"{tuple(q.shape)}")
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k/v pages must both be [kv_heads, num_pages, page_size, "
            f"head_dim], got {tuple(k_pages.shape)} vs "
            f"{tuple(v_pages.shape)}")
    b, h, d = q.shape
    hkv = k_pages.shape[0]
    if k_pages.shape[-1] != d:
        raise ValueError(f"head_dim mismatch: q has {d}, pages have "
                         f"{k_pages.shape[-1]}")
    if h % hkv:
        raise ValueError(f"q_heads {h} not a multiple of kv_heads {hkv}")
    if page_indices.ndim != 2 or page_indices.shape[0] != b:
        raise ValueError(f"page_indices must be [batch, max_pages], got "
                         f"{tuple(page_indices.shape)} for batch {b}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [batch], got "
                         f"{tuple(lengths.shape)}")
    return b, h, d, hkv


def paged_attention_reference(q, k_pages, v_pages, page_indices, lengths):
    """Dense oracle: gather every named page, masked softmax in fp32."""
    b, h, d, hkv = _check_shapes(q, k_pages, v_pages, page_indices,
                                 lengths)
    group = h // hkv
    t = page_indices.shape[1] * k_pages.shape[2]
    idx = page_indices.long()
    # [kv_heads, batch, max_pages, page, d] -> [batch, kv_heads, t, d]
    k = k_pages[:, idx].movedim(1, 0).reshape(b, hkv, t, d).float()
    v = v_pages[:, idx].movedim(1, 0).reshape(b, hkv, t, d).float()
    qg = q.reshape(b, hkv, group, d).float() * d ** -0.5
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k)
    pos = torch.arange(t, device=q.device)
    mask = pos[None, None, None, :] < lengths.to(q.device)[:, None, None,
                                                          None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bhgt,bhtd->bhgd", torch.softmax(s, dim=-1), v)
    return o.reshape(b, h, d).to(q.dtype)


def paged_decode(q, k_pages, v_pages, page_indices, lengths):
    """Launch ``csrc/paged_decode.cu`` on CUDA tensors.  Adds one to
    ``paged_decode.launches`` per launch."""
    b, h, d, hkv = _check_shapes(q, k_pages, v_pages, page_indices,
                                 lengths)
    group = h // hkv
    dev = q.device
    for name, x, dtype in (("q", q, torch.float32),
                           ("k_pages", k_pages, torch.float32),
                           ("v_pages", v_pages, torch.float32),
                           ("page_indices", page_indices, torch.int32),
                           ("lengths", lengths, torch.int32)):
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"{name} must be on {dev} (CUDA), got "
                             f"{x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if d != HEAD_DIM:
        raise ValueError(f"paged_decode is built for head_dim {HEAD_DIM}, "
                         f"got {d}")
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"GQA group {group} outside 1..{MAX_GROUP}")
    _, num_pages, page_size, _ = k_pages.shape
    max_pages = page_indices.shape[1]
    sp = split_pages(page_size)
    n_splits = -(-max_pages // sp)
    # one allocation in whole [h, d] rows: the output's b rows, then the
    # workspace of each split's partial, acc [group, d] and (m, den)
    # [group, 2], passed by address (a slice of it costs host time)
    work_rows = -(-b * hkv * n_splits * group * (d + 2) // (h * d))
    buf = torch.empty((b + work_rows, h, d), dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    lib = _build.load("paged_decode")
    stream = _build.stream(q)
    rc = lib.sgp_paged_decode_f32(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_indices.data_ptr(), lengths.data_ptr(), ptr,
        ptr + 4 * q.numel(), b, hkv, group, num_pages, page_size, max_pages,
        sp, stream)
    paged_decode.launches += 1
    _build.check(rc, "paged_decode")
    return buf[:b]


paged_decode.launches = 0


def paged_attention_decode(q, k_pages, v_pages, page_indices, lengths,
                           *, force_kernel: bool = False):
    """Single-step paged decode: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (``force_kernel`` turns the latter
    into a :class:`~..ops.lanes.KernelLaneError`)."""
    if use_kernel(q, force_kernel):
        return paged_decode(q, k_pages, v_pages, page_indices, lengths)
    return paged_attention_reference(q, k_pages, v_pages, page_indices,
                                     lengths)


def sharded_paged_decode(q, k_pages, v_pages, page_indices, lengths,
                         shards: int):
    """KV-head-sharded decode over the ``shards`` shards that ``q`` and the
    pages hold, in shard order (every shard's heads on one card; a
    process of a sharded engine its own shard's, ``shards`` 1): shard
    ``i`` holds kv heads ``[i·Hkv/S, (i+1)·Hkv/S)`` and, GQA grouping
    being contiguous, q heads ``[i·H/S, (i+1)·H/S)``; the page table and
    lengths are every shard's.  One :func:`paged_attention_decode` a
    shard on its head slice; returns ``[batch, q_heads, head_dim]``.
    Each head is computed alone, so the result is the unsharded
    decode's, bit for bit."""
    _, h, _, hkv = _check_shapes(q, k_pages, v_pages, page_indices,
                                 lengths)
    if hkv % shards:
        raise ValueError(f"kv_heads {hkv} not divisible by mesh axis "
                         f"'model' size {shards}")
    if shards == 1:
        return paged_attention_decode(q, k_pages, v_pages, page_indices,
                                      lengths)
    hq, hk = h // shards, hkv // shards
    # a head slice of the pages is contiguous; the query's is copied to
    # the kernel's contiguous layout
    return torch.cat([paged_attention_decode(
        q[:, i * hq:(i + 1) * hq].contiguous(),
        k_pages[i * hk:(i + 1) * hk], v_pages[i * hk:(i + 1) * hk],
        page_indices, lengths) for i in range(shards)], dim=1)
