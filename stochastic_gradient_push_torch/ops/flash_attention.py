"""Flash attention, forward and backward: the hand-written CUDA kernels
and their plain twins.

Port of ``stochastic_gradient_push_tpu/ops/flash_attention.py``
(``flash_attention_forward:162``, ``flash_attention_backward:318`` and
the ``custom_vjp`` ``flash_attention:409-443``).  Layout is the
reference's: q/k/v ``[batch, heads, seq, head_dim]``, the row logsumexp
``lse`` and ``delta = rowsum(dO * O)`` ``[batch, heads, seq]``.

* :func:`flash_fwd` launches ``csrc/flash_fwd.cu`` (with ``return_lse``
  it also writes ``lse``); :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`
  launch the two kernels of ``csrc/flash_bwd.cu``.  All take CUDA
  tensors, fp32, head_dim 64, any sequence length.
* :func:`flash_attention_reference`, :func:`flash_bwd_dq_reference` and
  :func:`flash_bwd_dkv_reference` are their plain PyTorch versions:
  dense fp32 arithmetic with the kernels' own formulas, the CPU lane and
  the kernels' oracles on the card.
* :func:`flash_attention` picks between them by where the tensors lie
  (:mod:`ops.lanes`).  Inputs that require grad go through
  :class:`FlashAttention`, a ``torch.autograd.Function`` that saves
  ``(q, k, v, out, lse)`` as ``_flash_fwd`` does and whose backward is
  :func:`flash_attention_backward`: the two kernels on CUDA tensors, the
  plain backward on CPU tensors, never one for the other.

The TPU-tuned ``default_block`` rule is not carried over; the kernels'
tiles are their own.  All three kernels own 64 rows per block (16 per
warp) and stream 64-row tiles through the tensor cores, fp32-accurate
through a 3xTF32 split (``mma.sync`` TF32, three products per fp32
product; the helpers are ``csrc/tf32_mma.cuh``): the forward and dQ own
query rows and stream K/V, dK/dV owns key rows and streams q/dO.  All
hold their plain versions to 1e-4 on the card.
"""

from __future__ import annotations

import torch

from . import _build
from .lanes import use_kernel

__all__ = ["FlashAttention", "flash_attention", "flash_attention_reference",
           "flash_attention_backward", "flash_attention_backward_reference",
           "flash_bwd_dkv", "flash_bwd_dkv_reference", "flash_bwd_dq",
           "flash_bwd_dq_reference", "flash_fwd"]

NEG_INF = -1e30
HEAD_DIM = 64          # the only head size the kernels are built for
_MAX_BH = 65535        # the kernels' grid.y


def _check_qkv(q, k, v):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [batch, heads, seq, "
                         f"head_dim] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _check_kernel_args(rows: dict, scalars: dict):
    """What the kernels take: CUDA fp32 contiguous tensors on one device,
    rows ``[b, h, t, 64]`` 16-byte aligned (float4 loads), per-row
    scalars ``[b, h, t]``.  Returns ``(b * h, t)``."""
    first = next(iter(rows.values()))
    b, h, t, d = first.shape
    for name, x in {**rows, **scalars}.items():
        if not x.is_cuda or x.device != first.device:
            raise ValueError(f"{name} must be on {first.device} (CUDA), "
                             f"got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned (the kernels load float4)")
    for name, x in rows.items():
        if x.shape != first.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                             f"{tuple(first.shape)}")
    for name, x in scalars.items():
        if x.shape != (b, h, t):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want "
                             f"{(b, h, t)}")
    if d != HEAD_DIM:
        raise ValueError(f"the flash kernels are built for head_dim "
                         f"{HEAD_DIM}, got {d}")
    if not 0 < b * h <= _MAX_BH:
        raise ValueError(f"batch*heads {b * h} outside 1..{_MAX_BH}")
    return b * h, t


def _scores(q, k, causal: bool):
    """fp32 scores of ``q * d**-0.5`` against ``k`` and the visibility
    mask (None when nothing is masked)."""
    t, d = q.shape[-2:]
    s = (q.float() * d ** -0.5) @ k.float().transpose(-1, -2)
    if not causal:
        return s, None
    return s, torch.ones(t, t, dtype=torch.bool, device=q.device).tril()


def flash_attention_reference(q, k, v, causal: bool = False,
                              return_lse: bool = False):
    """Plain PyTorch attention with the kernel's semantics: fp32 scores of
    ``q * d**-0.5`` against ``k``, causal mask when asked, softmax,
    ``@ v``.  With ``return_lse`` also the row logsumexp of the scores
    ``[b, h, t]`` (fp32)."""
    _check_qkv(q, k, v)
    s, mask = _scores(q, k, causal)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    out = (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _probs(q, k, lse, causal: bool):
    """``p = exp(s - lse)``, exactly 0 where masked (the kernels' rule)."""
    s, mask = _scores(q, k, causal)
    p = torch.exp(s - lse.float()[..., None])
    return p if mask is None else p.masked_fill(~mask, 0.0)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool = False):
    """Plain dQ: ``ds = p * (dO @ vᵀ - delta)``, ``dQ = d**-0.5 * ds @ k``
    (the formulas of ``_flash_dq_kernel``)."""
    _check_qkv(q, k, v)
    p = _probs(q, k, lse, causal)
    ds = p * (do.float() @ v.float().transpose(-1, -2)
              - delta.float()[..., None])
    return ((ds @ k.float()) * q.shape[-1] ** -0.5).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool = False):
    """Plain dK/dV: ``dV = pᵀ @ dO``, ``dK = dsᵀ @ (q * d**-0.5)`` (the
    formulas of ``_flash_dkv_kernel``)."""
    _check_qkv(q, k, v)
    p = _probs(q, k, lse, causal)
    dof = do.float()
    ds = p * (dof @ v.float().transpose(-1, -2) - delta.float()[..., None])
    dk = ds.transpose(-1, -2) @ (q.float() * q.shape[-1] ** -0.5)
    dv = p.transpose(-1, -2) @ dof
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, do):
    """``rowsum(dO * O)``, outside the kernels as in the reference
    (``flash_attention_backward:341-342``)."""
    return (do.float() * out.float()).sum(-1)


def flash_attention_backward_reference(q, k, v, out, lse, do,
                                       causal: bool = False):
    """Plain backward: ``(dq, dk, dv)`` from the forward's ``out`` and
    ``lse`` and the output gradient ``do``."""
    delta = _delta(out, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    return (dq, *flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal))


def flash_fwd(q, k, v, causal: bool = False, return_lse: bool = False):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors (fp32, contiguous,
    head_dim 64, any seq); with ``return_lse`` returns ``(out, lse)``.
    Adds one to ``flash_fwd.launches`` per launch."""
    _check_qkv(q, k, v)
    bh, t = _check_kernel_args({"q": q, "k": k, "v": v}, {})
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    if t:
        lib = _build.load("flash_fwd")
        rc = lib.sgp_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, t, int(causal),
            _build.stream(q))
        flash_fwd.launches += 1
        _build.check(rc, "flash_fwd")
    return (out, lse) if return_lse else out


flash_fwd.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False):
    """Launch the dQ kernel of ``csrc/flash_bwd.cu``.  Adds one to
    ``flash_bwd_dq.launches`` per launch."""
    bh, t = _check_kernel_args({"q": q, "k": k, "v": v, "do": do},
                               {"lse": lse, "delta": delta})
    dq = torch.empty_like(q)
    if t:
        lib = _build.load("flash_bwd")
        rc = lib.sgp_flash_bwd_dq_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t,
            int(causal), _build.stream(q))
        flash_bwd_dq.launches += 1
        _build.check(rc, "flash_bwd_dq")
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """Launch the dK/dV kernel of ``csrc/flash_bwd.cu``; returns
    ``(dk, dv)``.  Adds one to ``flash_bwd_dkv.launches`` per launch."""
    bh, t = _check_kernel_args({"q": q, "k": k, "v": v, "do": do},
                               {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if t:
        lib = _build.load("flash_bwd")
        rc = lib.sgp_flash_bwd_dkv_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t, int(causal), _build.stream(q))
        flash_bwd_dkv.launches += 1
        _build.check(rc, "flash_bwd_dkv")
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_backward(q, k, v, out, lse, do, causal: bool = False,
                             force_kernel: bool = False):
    """``(dq, dk, dv)``: the two backward kernels for CUDA tensors, the
    plain backward for CPU tensors (``force_kernel`` turns the latter
    into a :class:`~.lanes.KernelLaneError`)."""
    if not use_kernel(q, force_kernel):
        return flash_attention_backward_reference(q, k, v, out, lse, do,
                                                  causal)
    do = do.contiguous()
    delta = _delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal))


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``custom_vjp``
    ``_flash``): forward with lse, residuals ``(q, k, v, out, lse)``,
    backward through :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, force_kernel: bool):
        if use_kernel(q, force_kernel):
            q, k, v = (x.contiguous() for x in (q, k, v))
            out, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        else:
            out, lse = flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.force_kernel = causal, force_kernel
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, do, causal=ctx.causal,
            force_kernel=ctx.force_kernel)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    force_kernel: bool = False):
    """Attention: the CUDA kernels for CUDA tensors, the plain versions
    for CPU tensors (``force_kernel`` turns the latter into a
    :class:`~.lanes.KernelLaneError`).  Differentiable: inputs that
    require grad go through :class:`FlashAttention`."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, force_kernel)
    if use_kernel(q, force_kernel):
        return flash_fwd(q, k, v, causal=causal)
    return flash_attention_reference(q, k, v, causal=causal)
