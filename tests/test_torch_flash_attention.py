"""Port parity: flash attention (``stochastic_gradient_push_torch.ops.
flash_attention``), forward with its logsumexp and backward, against the
JAX package's blockwise oracle and its Pallas kernels in interpret mode,
on the same numpy inputs.

The port runs its plain versions here; the CUDA kernels are held against
them on the card.  Tolerances: atol 2e-5 for the forward (blocked online
softmax on the JAX side vs one dense softmax on the port's), atol 1e-5
for the lse and the gradients.

The flash kernels compute every product on the tensor cores as three
TF32 products of a hi/lo split (3xTF32); a numpy model of that
arithmetic pins, here, why one TF32 pass would not do, and holds the dQ
kernel's arithmetic to fp64.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.ops import flash_attention as tfa
from stochastic_gradient_push_torch.ops.lanes import KernelLaneError
from torch_bf16 import assert_bf16_close, from_jax, jax_bf16, to_bf16

torch.set_num_threads(1)

ATOL = 2e-5


def _qkv(seed, t, b=1, h=2, d=32):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((b, h, t, d)).astype(np.float32)
                 for _ in range(3))


def _port(q, k, v, causal):
    return tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal=causal).numpy()


def _dense64(q, k, v, causal):
    """float64 numpy oracle."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = q @ np.swapaxes(k, -1, -2) * q.shape[-1] ** -0.5
    if causal:
        t = s.shape[-1]
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


CASES = [(t, causal) for t in (8, 64, 128) for causal in (True, False)]


@pytest.mark.parametrize("t,causal", CASES)
def test_plain_matches_jax_blockwise(t, causal):
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.parallel.ring_attention import (
        blockwise_attention)

    q, k, v = _qkv(t, t)
    want = np.asarray(blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                          min(64, t), causal=causal))
    np.testing.assert_allclose(_port(q, k, v, causal), want, atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("t,causal", CASES)
def test_plain_matches_jax_interpret_kernel(t, causal):
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.ops.flash_attention import (
        flash_attention_forward)

    q, k, v = _qkv(100 + t, t)
    want = np.asarray(flash_attention_forward(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_q=min(64, t),
        block_k=min(64, t), interpret=True))
    np.testing.assert_allclose(_port(q, k, v, causal), want, atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_tail_any_length(causal):
    # t = 136: a prompt of 129..136 tokens padded to a multiple of 8.
    # The port takes it; the reference's default_block(136) == 128 does
    # not divide it, so the JAX flash_attention raises (a reference fault
    # the port does not copy; on the CPU it raises from its blockwise
    # fallback, on the TPU from flash_attention_forward).
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.ops.flash_attention import (
        flash_attention as jax_flash_attention)

    q, k, v = _qkv(7, 136)
    np.testing.assert_allclose(_port(q, k, v, causal),
                               _dense64(q, k, v, causal), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)


GRAD_ATOL = 1e-5


def _leaf(x):
    return torch.from_numpy(x).requires_grad_(True)


@pytest.mark.parametrize("t,causal", [(8, True), (37, True), (136, False),
                                      (64, False)])
def test_grads_flow_through_flash_attention_on_cpu(t, causal):
    # the autograd Function on the CPU lane (plain forward with lse, plain
    # backward) against torch.autograd through the dense reference
    q, k, v = _qkv(t + 5, t)
    do = np.random.default_rng(t).standard_normal(q.shape).astype(
        np.float32)
    a = [_leaf(x) for x in (q, k, v)]
    out = tfa.flash_attention(*a, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, a, torch.from_numpy(do))
    b = [_leaf(x) for x in (q, k, v)]
    want = torch.autograd.grad(
        tfa.flash_attention_reference(*b, causal=causal), b,
        torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL,
                                   rtol=0)


BWD_CASES = [(t, causal) for t in (8, 64) for causal in (True, False)]


def _fwd_bwd_inputs(seed, t):
    q, k, v = _qkv(seed, t)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(
        np.float32)
    return q, k, v, do


@pytest.mark.parametrize("t,causal", BWD_CASES)
def test_plain_lse_matches_jax_interpret_kernel(t, causal):
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.ops.flash_attention import (
        flash_attention_forward)

    q, k, v = _qkv(200 + t, t)
    _, want = flash_attention_forward(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_q=min(32, t),
        block_k=min(32, t), interpret=True, return_lse=True)
    _, got = tfa.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("t,causal", BWD_CASES)
def test_plain_backward_matches_jax_interpret_kernels(t, causal):
    # the port's plain backward fed the JAX forward's own out and lse,
    # against flash_attention_backward (the dQ and dK/dV Pallas kernels)
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.ops.flash_attention import (
        flash_attention_backward, flash_attention_forward)

    q, k, v, do = _fwd_bwd_inputs(300 + t, t)
    blk = min(32, t)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = flash_attention_forward(jq, jk, jv, causal=causal,
                                       block_q=blk, block_k=blk,
                                       interpret=True, return_lse=True)
    want = flash_attention_backward(jq, jk, jv, out, lse, jdo,
                                    causal=causal, block_q=blk,
                                    block_k=blk, interpret=True)
    got = tfa.flash_attention_backward_reference(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, do)),
        causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("t,causal", BWD_CASES)
def test_plain_backward_matches_jax_grad_of_blockwise(t, causal):
    import jax
    import jax.numpy as jnp

    from stochastic_gradient_push_tpu.parallel.ring_attention import (
        blockwise_attention)

    q, k, v, do = _fwd_bwd_inputs(400 + t, t)
    jdo = jnp.asarray(do)

    def loss(q, k, v):
        return jnp.sum(blockwise_attention(q, k, v, min(32, t),
                                           causal=causal) * jdo)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, causal=causal,
                                             return_lse=True)
    got = tfa.flash_attention_backward_reference(
        tq, tk, tv, out, lse, torch.from_numpy(do), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0)


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 8, d=64))
    lse = torch.zeros(q.shape[:3])
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq(q, k, v, q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv(q, k, v, q, lse, lse, causal=True)
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == before


def test_forced_kernel_on_cpu_raises_typed_error():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 8))
    with pytest.raises(KernelLaneError):
        tfa.flash_attention(q, k, v, causal=True, lane="kernel")
    with pytest.raises(KernelLaneError):
        tfa.flash_attention(q.requires_grad_(), k, v, causal=True,
                            lane="kernel")


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 8, d=64))
    before = tfa.flash_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, k, v, causal=True)
    assert tfa.flash_fwd.launches == before


# the kernels' tolerance against their plain versions on the card
# (chip_smoke.py, tests/test_torch_cuda.py)
TOL_KERNEL = 1e-4


def _tf32(x):
    """fp32 -> tf32 with ``cvt.rna.tf32.f32``'s rounding (to nearest, ties
    away from zero): add 0x1000 to the bit pattern, clear the low 13
    bits.  The kernels' ``tf32()`` does the same."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _matmul_3xtf32(a, b):
    """``a @ b`` as the kernels compute it: each operand split into
    ``hi = tf32(x)``, ``lo = tf32(x - hi)``, then lo.hi + hi.lo + hi.hi,
    the small terms first, summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _softmax(s, causal):
    if causal:
        t = s.shape[-1]
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def _dq_3xtf32(q, k, v, do, lse, delta, causal):
    """dQ as the dQ kernel computes it: per 64-key tile, S = q.K^T,
    P = exp(S * d**-0.5 - lse) (0 where masked), dP = dO.V^T,
    dS = P * (dP - delta), the tile's dS.K summed in 3xTF32 from zero and
    added to the running dQ in fp32; d**-0.5 applied once at the end."""
    t, d = q.shape[-2:]
    scale = np.float32(d ** -0.5)
    qi = np.arange(t)[:, None]
    dq = np.zeros_like(q)
    for k0 in range(0, t, 64):
        kt, vt = k[..., k0:k0 + 64, :], v[..., k0:k0 + 64, :]
        s = _matmul_3xtf32(q, np.swapaxes(kt, -1, -2))
        p = np.exp(s * scale - lse[..., None])
        if causal:
            p = np.where(k0 + np.arange(kt.shape[-2]) <= qi, p, 0)
        dp = _matmul_3xtf32(do, np.swapaxes(vt, -1, -2))
        dq += _matmul_3xtf32((p * (dp - delta[..., None])).astype(
            np.float32), kt)
    return dq * scale


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_split_keeps_fp32_accuracy(causal):
    # d64 scores and P.V at t256 three ways: 3xTF32 (the kernels), one
    # TF32 pass, and plain fp32, each against fp64; then dQ as the dQ
    # kernel computes it (3xTF32 products, each tile's sum added in fp32)
    q, k, v = _qkv(600 + causal, 256, d=64)
    qs = q * np.float32(64 ** -0.5)
    kt = np.ascontiguousarray(np.swapaxes(k, -1, -2))
    s64 = qs.astype(np.float64) @ kt.astype(np.float64)
    o64 = _softmax(s64, causal) @ v.astype(np.float64)
    s3 = _matmul_3xtf32(qs, kt)
    o3 = _matmul_3xtf32(_softmax(s3, causal).astype(np.float32), v)
    s1 = _tf32(qs) @ _tf32(kt)
    s32 = qs @ kt
    assert s3.dtype == s1.dtype == o3.dtype == np.float32
    plain = _port(q, k, v, causal)
    assert np.abs(s32 - s64).max() <= 1e-5
    assert np.abs(s3 - s64).max() <= 1e-5
    assert np.abs(o3 - o64).max() <= 1e-5
    assert np.abs(o3 - plain).max() <= TOL_KERNEL
    assert np.abs(s1 - s64).max() > 1e-4

    do = np.random.default_rng(700 + causal).standard_normal(
        q.shape).astype(np.float32)
    p64 = _softmax(s64, causal)
    sm = np.where(np.tril(np.ones((256, 256), bool)), s64,
                  -np.inf) if causal else s64
    lse = (np.log(np.exp(sm - sm.max(-1, keepdims=True)).sum(-1))
           + sm.max(-1)).astype(np.float32)
    delta = (do.astype(np.float64) * (p64 @ v.astype(np.float64))).sum(
        -1).astype(np.float32)
    ds64 = p64 * (do.astype(np.float64) @ np.swapaxes(v, -1, -2).astype(
        np.float64) - delta.astype(np.float64)[..., None])
    dq64 = ds64 @ k.astype(np.float64) * 64 ** -0.5
    dq3 = _dq_3xtf32(q, k, v, do, lse, delta, causal)
    assert dq3.dtype == np.float32
    assert np.abs(dq3 - dq64).max() <= 1e-5
    dq_plain = tfa.flash_bwd_dq_reference(
        *(torch.from_numpy(x) for x in (q, k, v, do, lse, delta)),
        causal=causal).numpy()
    assert np.abs(dq3 - dq_plain).max() <= TOL_KERNEL


# -- bf16 -------------------------------------------------------------------
# The reference's kernels take bf16 q/k/v: they widen them to fp32,
# accumulate in fp32, keep lse and delta in fp32 and round each output
# once to bf16.  The port's plain twins do the same: outputs equal or one
# bf16 ulp apart (``tests/torch_bf16.py``), lse within 1e-5 relative.

LSE_RTOL = 1e-5


def _qkv_bf16(seed, t, b=1, h=2, d=32, n=3):
    r = np.random.default_rng(seed)
    return tuple(to_bf16(r.standard_normal((b, h, t, d)).astype(np.float32))
                 for _ in range(n))


@pytest.mark.parametrize("t,causal", CASES)
def test_plain_bf16_matches_jax_interpret_kernel(t, causal):
    from stochastic_gradient_push_tpu.ops.flash_attention import (
        flash_attention_forward)

    q, k, v = _qkv_bf16(900 + t, t)
    blk = min(64, t)
    out, lse = flash_attention_forward(
        *map(jax_bf16, (q, k, v)), causal=causal, block_q=blk, block_k=blk,
        interpret=True, return_lse=True)
    got, got_lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                                 return_lse=True)
    assert got_lse.dtype == torch.float32
    assert_bf16_close(got, from_jax(out), name="out")
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse),
                               rtol=LSE_RTOL, atol=0)


@pytest.mark.parametrize("t,causal", CASES)
def test_plain_bf16_backward_matches_jax_interpret_kernels(t, causal):
    # the port's plain backward fed the reference forward's own bf16 out
    # and fp32 lse, against the dQ and dK/dV Pallas kernels at bf16
    from stochastic_gradient_push_tpu.ops.flash_attention import (
        flash_attention_backward, flash_attention_forward)

    q, k, v, do = _qkv_bf16(1000 + t, t, n=4)
    blk = min(64, t)
    jq, jk, jv, jdo = map(jax_bf16, (q, k, v, do))
    out, lse = flash_attention_forward(jq, jk, jv, causal=causal,
                                       block_q=blk, block_k=blk,
                                       interpret=True, return_lse=True)
    want = flash_attention_backward(jq, jk, jv, out, lse, jdo,
                                    causal=causal, block_q=blk, block_k=blk,
                                    interpret=True)
    got = tfa.flash_attention_backward_reference(
        q, k, v, from_jax(out), from_jax(lse), do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_bf16_close(g, from_jax(w), name=name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_takes_any_length(causal):
    # t = 136 (no block of the reference's divides it): the plain twin
    # against an fp64 oracle on the same bf16 inputs, rounded to bf16
    q, k, v = _qkv_bf16(7, 136)
    want = torch.from_numpy(_dense64(*(x.float().numpy() for x in (q, k, v)),
                                     causal)).to(torch.bfloat16)
    assert_bf16_close(tfa.flash_attention_reference(q, k, v, causal=causal),
                       want, name="out")


@pytest.mark.parametrize("t,causal", [(8, True), (37, True), (136, False)])
def test_bf16_grads_flow_through_flash_attention_on_cpu(t, causal):
    # the autograd Function at bf16: bf16 residuals, bf16 grads, equal to
    # the plain backward fed the plain forward's out and lse
    q, k, v, do = _qkv_bf16(t + 55, t, n=4)
    a = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*a, causal=causal)
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    got = torch.autograd.grad(out, a, do)
    ref, lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    want = tfa.flash_attention_backward_reference(q, k, v, ref, lse, do,
                                                  causal=causal)
    assert torch.equal(out.detach(), ref)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels feed it to a product: hi + lo, ``hi =
    bf16(x)``, ``lo = bf16(x - hi)``."""
    hi = _round_bf16(x)
    return hi + _round_bf16(x - hi)


def _fwd_bf16_model(q, k, v, causal, operand=_split_bf16):
    """The bf16 forward kernel's arithmetic: q * d**-0.5 in bf16 (exact),
    per 64-key tile S = q.K^T in fp32, the online softmax in fp32, P fed
    to P.V as ``operand(P)`` (a hi/lo bf16 pair), o rounded once to
    bf16."""
    t = q.shape[-2]
    qs, kf, vf = (q.float() * 0.125).to(torch.bfloat16).float(), k.float(), \
        v.float()
    out = torch.zeros(q.shape)
    m = torch.full(q.shape[:-1], float("-inf"))
    den = torch.zeros(q.shape[:-1])
    qi = torch.arange(t)[:, None]
    for k0 in range(0, t, 64):
        s = qs @ kf[..., k0:k0 + 64, :].transpose(-1, -2)
        if causal:
            s = s.masked_fill(k0 + torch.arange(s.shape[-1]) > qi,
                              float("-inf"))
        mx = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - mx[..., None])
        alpha = torch.exp(m - mx)
        den = den * alpha + p.sum(-1)
        out = out * alpha[..., None] + operand(p) @ vf[..., k0:k0 + 64, :]
        m = mx
    return (out / den[..., None]).to(torch.bfloat16)


def _bwd_bf16_model(q, k, v, do, lse, delta, causal, operand=_split_bf16):
    """The bf16 backward kernels' arithmetic: P and dS in fp32, fed to
    dV = P^T.dO, dQ = dS.K and dK = dS^T.q as ``operand(P)`` and
    ``operand(dS)`` (hi/lo bf16 pairs); each gradient rounded once to
    bf16."""
    t = q.shape[-2]
    s = q.float() @ k.float().transpose(-1, -2)
    p = torch.exp(s * 0.125 - lse[..., None])
    if causal:
        p = p.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), 0.0)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])
    ds, p = operand(ds), operand(p)
    return tuple(x.to(torch.bfloat16) for x in (
        ds @ k.float() * 0.125, ds.transpose(-1, -2) @ q.float() * 0.125,
        p.transpose(-1, -2) @ do.float()))


@pytest.mark.parametrize("t,causal", [(8, True), (200, True), (200, False),
                                      (1024, True), (1024, False)])
def test_bf16_kernel_rounding_stays_within_tolerance(t, causal):
    # a model of the bf16 kernels' arithmetic against the plain twins, as
    # the card holds them (tfa.bf16_close).  With P and dS as hi/lo pairs
    # the kernels round nearly the same fp32 values to bf16 as the twins:
    # ~0.2 % of the elements land an ulp apart (a sum near a rounding
    # boundary), none farther.  P and dS rounded once to bf16 (the first
    # design) move ~40 % of the elements, by up to tens of ulps, and fail
    # both parts of the check.
    q, k, v, do = _qkv_bf16(1100 + t, t, b=2, h=2, d=64, n=4)
    ref, lse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    delta = (do.float() * ref.float()).sum(-1)
    want = (ref, tfa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal),
            *tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal))
    for operand in (_split_bf16, _round_bf16):
        got = (_fwd_bf16_model(q, k, v, causal, operand),
               *_bwd_bf16_model(q, k, v, do, lse, delta, causal, operand))
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            ulps, share = tfa.bf16_mismatch(g, w)
            if operand is _split_bf16:
                assert tfa.bf16_close(g, w), (name, ulps, share)
            else:
                assert ulps > 2 * tfa.TOL_BF16_ULPS, (name, ulps)
                assert share > 10 * tfa.TOL_BF16_SHARE, (name, share)


def test_forced_bf16_kernel_on_cpu_raises_typed_error():
    q, k, v = _qkv_bf16(0, 8, d=64)
    with pytest.raises(KernelLaneError):
        tfa.flash_attention(q, k, v, causal=True, lane="kernel")
    with pytest.raises(KernelLaneError):
        tfa.flash_attention(q.requires_grad_(), k, v, causal=True,
                            lane="kernel")
    lse = torch.zeros(q.shape[:3])
    before = [(f.launches, f.launches_bf16) for f in (
        tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq(q, k, v, q, lse, lse, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv(q, k, v, q, lse, lse, causal=True)
    assert before == [(f.launches, f.launches_bf16) for f in (
        tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)]


def test_mixed_dtypes_raise():
    q, k, v = _qkv_bf16(0, 8, d=64)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention(q, k.float(), v, causal=True)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention_reference(q.float(), k, v)


class _FakeLib:
    """Stands in for the built libraries: records each entry point it is
    called through and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("sgp_flash_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append(name) or 0


@pytest.mark.parametrize("dtype,form", [(torch.float32, "f32"),
                                        (torch.bfloat16, "bf16")])
def test_wrappers_dispatch_by_dtype_with_the_build_mocked(monkeypatch, dtype,
                                                          form):
    # each wrapper takes the entry point of its inputs' form and counts the
    # launch under that form alone: a bf16 tensor never reaches an _f32
    # entry point (nor is it widened for one), an fp32 one never a _bf16
    # one.  The build is mocked (no nvcc here) and the tensors pass for
    # CUDA ones.
    lib = _FakeLib()
    monkeypatch.setattr(tfa._build, "load", lambda name: lib)
    monkeypatch.setattr(tfa._build, "stream", lambda x: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    q, k, v, do = (x.to(dtype) for x in _qkv_bf16(3, 70, d=64, n=4))
    lse = torch.zeros(q.shape[:3])
    wrappers = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    before = [(f.launches, f.launches_bf16) for f in wrappers]
    out, lse_out = tfa.flash_fwd(q, k, v, causal=True, return_lse=True)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, lse, causal=True)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, lse, causal=True)
    assert lib.calls == [f"sgp_flash_fwd_{form}", f"sgp_flash_bwd_dq_{form}",
                         f"sgp_flash_bwd_dkv_{form}"]
    assert all(x.dtype == dtype for x in (out, dq, dk, dv))
    assert lse_out.dtype == torch.float32
    step = (1, 0) if form == "f32" else (0, 1)
    assert [(f.launches, f.launches_bf16) for f in wrappers] == [
        (a + step[0], b + step[1]) for a, b in before]
    # per-row scalars stay fp32 beside bf16 rows; fp64 rows are no form
    with pytest.raises(TypeError, match="lse must be torch.float32"):
        tfa.flash_bwd_dq(q, k, v, do, lse.to(dtype if form == "bf16"
                                             else torch.float64), lse)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_fwd(q.double(), k.double(), v.double())
    assert len(lib.calls) == 3
