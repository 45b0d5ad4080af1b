"""Flash-attention forward: the hand-written CUDA kernel and its plain twin.

Port of the forward half of ``stochastic_gradient_push_tpu/ops/
flash_attention.py`` (``flash_attention_forward:162`` /
``flash_attention:431``).  Layout is the reference's: q/k/v
``[batch, heads, seq, head_dim]``.

* :func:`flash_fwd` launches ``csrc/flash_fwd.cu`` (CUDA tensors, fp32,
  head_dim 64, any sequence length);
* :func:`flash_attention_reference` is the plain PyTorch version — dense
  masked softmax in fp32 — the CPU lane and the kernel's oracle;
* :func:`flash_attention` picks between them by where the tensors lie
  (:mod:`ops.lanes`).

Forward only: the backward kernels (``_flash_dq_kernel``,
``_flash_dkv_kernel``) are not ported yet, so inputs that require grad
are refused rather than silently differentiated through the plain lane.
The TPU-tuned ``default_block`` rule is not carried over; the kernel's
tiles are its own (64 query rows, 32 key rows).
"""

from __future__ import annotations

import torch

from . import _build
from .lanes import use_kernel

__all__ = ["flash_attention", "flash_attention_reference", "flash_fwd"]

NEG_INF = -1e30
HEAD_DIM = 64          # the only head size csrc/flash_fwd.cu is built for
_MAX_BH = 65535        # the kernel's grid.y


def _check_qkv(q, k, v):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [batch, heads, seq, "
                         f"head_dim] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def flash_attention_reference(q, k, v, causal: bool = False):
    """Plain PyTorch attention with the kernel's semantics: fp32 scores of
    ``q * d**-0.5`` against ``k``, causal mask when asked, softmax, ``@ v``."""
    _check_qkv(q, k, v)
    t, d = q.shape[-2:]
    s = (q.float() * d ** -0.5) @ k.float().transpose(-1, -2)
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def flash_fwd(q, k, v, causal: bool = False):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors (fp32, contiguous,
    head_dim 64, any seq).  Adds one to ``flash_fwd.launches`` per launch."""
    _check_qkv(q, k, v)
    b, h, t, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be on {q.device} (CUDA), got "
                             f"{x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned (the kernel loads float4)")
    if d != HEAD_DIM:
        raise ValueError(f"flash_fwd is built for head_dim {HEAD_DIM}, "
                         f"got {d}")
    if not 0 < b * h <= _MAX_BH:
        raise ValueError(f"batch*heads {b * h} outside 1..{_MAX_BH}")
    out = torch.empty_like(q)
    if t == 0:
        return out
    lib = _build.load("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.sgp_flash_fwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), b * h, t, int(causal), stream)
    flash_fwd.launches += 1
    _build.check(rc, "flash_fwd")
    return out


flash_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = False,
                    force_kernel: bool = False):
    """Attention forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``force_kernel`` turns the latter into a
    :class:`~.lanes.KernelLaneError`)."""
    if any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in the port: the backward "
            "kernels _flash_dq_kernel and _flash_dkv_kernel "
            "(ops/flash_attention.py:227,270 of the reference) are not "
            "ported yet; run under torch.no_grad()")
    if use_kernel(q, force_kernel):
        return flash_fwd(q, k, v, causal=causal)
    return flash_attention_reference(q, k, v, causal=causal)
