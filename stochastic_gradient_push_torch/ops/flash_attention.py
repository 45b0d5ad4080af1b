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
  tensors, head_dim 64, any sequence length, with q/k/v (and dO) all
  fp32 or all bf16 and the per-row ``lse``/``delta`` fp32, as the TPU
  kernels take them; each dispatches by dtype to its ``_f32`` or
  ``_bf16`` C entry point, and counts the launches of the two forms
  apart (``.launches`` fp32, ``.launches_bf16`` bf16).  A bf16 input
  runs the bf16 kernel, never the fp32 one on a widened copy.
* :func:`flash_attention_reference`, :func:`flash_bwd_dq_reference` and
  :func:`flash_bwd_dkv_reference` are their plain PyTorch versions:
  dense fp32 arithmetic with the kernels' own formulas, the CPU lane and
  the kernels' oracles on the card.  At bf16 they widen the inputs to
  fp32 and round each output once to bf16, as the TPU kernels do, and so
  are the bf16 kernels' oracles too.
* :func:`flash_attention` picks between them by where the tensors lie,
  or by ``lane`` (:func:`~.lanes.pick_lane`: ``"plain"`` runs the plain
  versions on the card, its oracle).  Inputs that require grad go
  through :class:`FlashAttention`, a ``torch.autograd.Function`` that
  saves ``(q, k, v, out, lse)`` as ``_flash_fwd`` does and whose backward
  runs on the forward's lane: the two kernels after the kernel, the
  plain backward after the plain forward, never one for the other.

The TPU-tuned ``default_block`` rule is not carried over; the kernels'
tiles are their own.  All three kernels own 64 rows per block (16 per
warp) and stream 64-row tiles through the tensor cores: the forward and
dQ own query rows and stream K/V, dK/dV owns key rows and streams q/dO.
The fp32 forms are fp32-accurate through a 3xTF32 split (``mma.sync``
TF32, three products per fp32 product; ``csrc/tf32_mma.cuh``) and hold
their plain versions to 1e-4 on the card.  The bf16 forms take one bf16
pass per product of bf16 inputs with fp32 accumulation, and feed P and
dS to their second products as hi/lo bf16 pairs; all three run on
Hopper's ``wgmma`` with tiles loaded by TMA under mbarriers
(``csrc/sm90_bf16.cuh``).  They hold their plain versions element by
element in bf16 ulps (:func:`bf16_close`).
"""

from __future__ import annotations

import torch

from . import _build
from .lanes import pick_lane, use_kernel

__all__ = ["FORMS", "TOL_BF16_FLOOR", "TOL_BF16_PARTS_FLOOR",
           "TOL_BF16_PARTS_ULPS", "TOL_BF16_SHARE", "TOL_BF16_ULPS",
           "FlashAttention", "bf16_close", "bf16_mismatch",
           "flash_attention", "flash_attention_reference",
           "flash_attention_backward_reference",
           "flash_bwd_dkv", "flash_bwd_dkv_reference", "flash_bwd_dq",
           "flash_bwd_dq_reference", "flash_fwd"]

NEG_INF = -1e30
HEAD_DIM = 64          # the only head size the kernels are built for
_MAX_BH = 65535        # the kernels' grid.y
# the kernel forms: rows' dtype -> C entry point suffix
FORMS = {torch.float32: "f32", torch.bfloat16: "bf16"}
# A bf16 kernel against its plain version (bf16_close).  Both widen to
# fp32 and round each output once to bf16, so an element may land one
# bf16 ulp apart where the two fp32 sums straddle a rounding boundary:
# they sum in other orders, and the kernel's P and dS carry ~16 bits
# (hi/lo pairs) where the plain version keeps 24.  An element far below
# the tensor's scale is a sum that cancelled; its ulp shrinks with it
# while the sums' rounding does not, so it is held to the ulp of
# TOL_BF16_FLOOR of the largest |plain|.  TOL_BF16_SHARE caps the share
# of elements apart at all (a kernel that rounds P and dS once moves
# ~40 % of them, by up to tens of ulps).
TOL_BF16_ULPS = 1
TOL_BF16_FLOOR = 2.0 ** -8
TOL_BF16_SHARE = 0.01
# A result merged in fp32 from bf16-rounded parts (the ring's ticks, or a
# backward fed its own lane's rounded forward): a part's one-ulp flip
# lands at the part's ulp, and parts reach the largest output while a
# merged element may cancel, so it is held to TOL_BF16_PARTS_ULPS ulps
# of the largest |plain| (the flip and the merged rounding), with the
# same share apart.
TOL_BF16_PARTS_ULPS = 2
TOL_BF16_PARTS_FLOOR = 1.0


def bf16_mismatch(got: torch.Tensor, ref: torch.Tensor,
                  floor: float = TOL_BF16_FLOOR) -> tuple:
    """How far bf16 ``got`` lies from ``ref`` element by element: the
    largest ``|got - ref|`` in bf16 ulps of ``max(|ref|, floor * max
    |ref|)``, and the share of elements apart by half an ulp of
    ``max(|ref|, TOL_BF16_FLOOR * max |ref|)`` or more (a rounding that
    landed elsewhere; fp32 noise in an element that cancelled far below
    the scale does not count)."""
    g, r = got.float(), ref.float()
    diff, top = (g - r).abs(), float(r.abs().max())

    def ulp(f):
        # bf16 keeps 8 significant bits: x in [2**(e-1), 2**e) has ulp
        # 2**(e-8)
        scale = r.abs().clamp(min=f * top)
        return torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)

    return (float((diff / ulp(floor)).max()),
            float((diff >= 0.5 * ulp(TOL_BF16_FLOOR)).double().mean()))


def bf16_close(got: torch.Tensor, ref: torch.Tensor,
               parts: bool = False) -> bool:
    """bf16 ``got`` within TOL_BF16_ULPS of ``ref`` everywhere (with
    ``parts``, a result merged from bf16-rounded parts: within
    TOL_BF16_PARTS_ULPS of the largest |ref|) and apart on at most
    TOL_BF16_SHARE of the elements (:func:`bf16_mismatch`)."""
    if parts:
        ulps, share = bf16_mismatch(got, ref, TOL_BF16_PARTS_FLOOR)
        return ulps <= TOL_BF16_PARTS_ULPS and share <= TOL_BF16_SHARE
    ulps, share = bf16_mismatch(got, ref)
    return ulps <= TOL_BF16_ULPS and share <= TOL_BF16_SHARE


def _check_qkv(q, k, v):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [batch, heads, seq, "
                         f"head_dim] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q/k/v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def _check_kernel_args(rows: dict, scalars: dict):
    """What the kernels take: CUDA contiguous tensors on one device, rows
    ``[b, h, t, 64]`` all fp32 or all bf16 (:data:`FORMS`), per-row
    scalars ``[b, h, t]`` fp32, all 16-byte aligned (16-byte loads).
    Returns ``(b * h, t, form)``, ``form`` the entry points' suffix."""
    first = next(iter(rows.values()))
    b, h, t, d = first.shape
    form = FORMS.get(first.dtype)
    if form is None:
        raise TypeError(f"the flash kernels take float32 or bfloat16 rows, "
                        f"got {first.dtype}")
    for name, x in {**rows, **scalars}.items():
        if not x.is_cuda or x.device != first.device:
            raise ValueError(f"{name} must be on {first.device} (CUDA), "
                             f"got {x.device}")
        want = first.dtype if name in rows else torch.float32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want} beside {first.dtype} "
                            f"rows, got {x.dtype}")
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
    return b * h, t, form


def _count(wrapper, form: str) -> None:
    """One launch of ``wrapper``'s ``form`` kernel."""
    if form == "bf16":
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


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
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors (fp32 or bf16,
    contiguous, head_dim 64, any seq); with ``return_lse`` returns ``(out,
    lse)``, lse fp32.  Adds one to ``flash_fwd.launches`` (fp32) or
    ``flash_fwd.launches_bf16`` (bf16) per launch."""
    _check_qkv(q, k, v)
    bh, t, form = _check_kernel_args({"q": q, "k": k, "v": v}, {})
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    if t:
        lib = _build.load("flash_fwd")
        rc = getattr(lib, f"sgp_flash_fwd_{form}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, t, int(causal),
            _build.stream(q))
        _count(flash_fwd, form)
        _build.check(rc, "flash_fwd")
    return (out, lse) if return_lse else out


flash_fwd.launches = flash_fwd.launches_bf16 = 0


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False):
    """Launch the dQ kernel of ``csrc/flash_bwd.cu`` (fp32 or bf16 rows,
    fp32 ``lse``/``delta``).  Adds one to ``flash_bwd_dq.launches`` (fp32)
    or ``flash_bwd_dq.launches_bf16`` (bf16) per launch."""
    bh, t, form = _check_kernel_args({"q": q, "k": k, "v": v, "do": do},
                                     {"lse": lse, "delta": delta})
    dq = torch.empty_like(q)
    if t:
        lib = _build.load("flash_bwd")
        rc = getattr(lib, f"sgp_flash_bwd_dq_{form}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t,
            int(causal), _build.stream(q))
        _count(flash_bwd_dq, form)
        _build.check(rc, "flash_bwd_dq")
    return dq


flash_bwd_dq.launches = flash_bwd_dq.launches_bf16 = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """Launch the dK/dV kernel of ``csrc/flash_bwd.cu``; returns
    ``(dk, dv)``.  Adds one to ``flash_bwd_dkv.launches`` (fp32) or
    ``flash_bwd_dkv.launches_bf16`` (bf16) per launch."""
    bh, t, form = _check_kernel_args({"q": q, "k": k, "v": v, "do": do},
                                     {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if t:
        lib = _build.load("flash_bwd")
        rc = getattr(lib, f"sgp_flash_bwd_dkv_{form}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t, int(causal), _build.stream(q))
        _count(flash_bwd_dkv, form)
        _build.check(rc, "flash_bwd_dkv")
    return dk, dv


flash_bwd_dkv.launches = flash_bwd_dkv.launches_bf16 = 0


def _backward(q, k, v, out, lse, do, causal: bool, kernel: bool):
    if not kernel:
        return flash_attention_backward_reference(q, k, v, out, lse, do,
                                                  causal)
    do = do.contiguous()
    delta = _delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal))


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``custom_vjp``
    ``_flash``): forward with lse on the kernel or plain lane
    (``kernel``), residuals ``(q, k, v, out, lse)``, the backward on the
    same lane."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kernel: bool):
        if kernel:
            q, k, v = (x.contiguous() for x in (q, k, v))
            out, lse = flash_fwd(q, k, v, causal=causal, return_lse=True)
        else:
            out, lse = flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kernel = causal, kernel
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do, ctx.causal,
                               ctx.kernel)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, lane: str = "auto"):
    """Attention: the CUDA kernels for CUDA tensors, the plain versions
    for CPU tensors, or as ``lane`` asks (:func:`~.lanes.pick_lane`:
    ``"kernel"`` turns a CPU tensor into a :class:`~.lanes.
    KernelLaneError`, ``"plain"`` runs the plain versions on the card).
    Differentiable: inputs that require grad go through
    :class:`FlashAttention`."""
    kernel = pick_lane(q, lane)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, kernel)
    if kernel:
        return flash_fwd(q, k, v, causal=causal)
    return flash_attention_reference(q, k, v, causal=causal)
