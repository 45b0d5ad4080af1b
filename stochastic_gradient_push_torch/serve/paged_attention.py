"""Paged-attention decode: the hand-written CUDA kernel and its plain twin.

Port of ``stochastic_gradient_push_tpu/serve/paged_attention.py``
(``paged_attention_decode:203``, ``paged_attention_reference:85``,
``_check_shapes:62``), same signature and layouts: q ``[batch, q_heads,
head_dim]``; k/v pages ``[kv_heads, num_pages, page_size, head_dim]``;
int32 ``page_indices [batch, max_pages]``; ``lengths [batch]``, each ≥ 1
and counting the token being decoded.  GQA: ``q_heads = kv_heads *
group``.

* :func:`paged_decode` launches ``csrc/paged_decode.cu`` (CUDA, fp32,
  head_dim 64, group 1..8);
* :func:`paged_attention_reference` gathers every named page and runs
  masked softmax attention — the CPU lane and the kernel's oracle;
* :func:`paged_attention_decode` picks between them by device.

``sharded_paged_decode`` (kv heads over a model axis) needs two or more
GPUs and is not ported yet.
"""

from __future__ import annotations

import torch

from ..ops import _build
from ..ops.flash_attention import NEG_INF
from ..ops.lanes import use_kernel

__all__ = ["paged_attention_decode", "paged_attention_reference",
           "paged_decode"]

HEAD_DIM = 64
MAX_GROUP = 8      # csrc/paged_decode.cu instantiates groups 1..8


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
    out = torch.empty_like(q)
    lib = _build.load("paged_decode")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.sgp_paged_decode_f32(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_indices.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, group, num_pages, page_size, page_indices.shape[1], stream)
    paged_decode.launches += 1
    _build.check(rc, "paged_decode")
    return out


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
