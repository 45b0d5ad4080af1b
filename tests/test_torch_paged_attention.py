"""Port parity: paged-attention decode (``stochastic_gradient_push_torch.
serve.paged_attention``) against the JAX package's dense reference and its
Pallas kernel in interpret mode, on the same numpy inputs.

The port runs its plain version here (CPU tensors); the CUDA kernel is held
against that plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Tolerance: atol 2e-5 in fp32 — the two sides sum the
softmax in different orders (gather-then-softmax vs online softmax).
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.ops.lanes import KernelLaneError
from stochastic_gradient_push_torch.serve import paged_attention as tpa

torch.set_num_threads(1)

ATOL = 2e-5


def _case(seed, b=5, hq=4, hkv=4, d=16, page=4, num_pages=13, max_pages=6,
          layout="random"):
    """Non-contiguous page ids, a length-1 row, and rows padded past
    their length with page 0 ("zero") or with a sink page ("sink")."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, hq, d)).astype(np.float32)
    kp = r.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    vp = r.standard_normal((hkv, num_pages, page, d)).astype(np.float32)
    pi = np.stack([r.permutation(num_pages - 1)[:max_pages]
                   for _ in range(b)]).astype(np.int32)
    lengths = r.integers(1, max_pages * page + 1, size=b).astype(np.int32)
    lengths[0] = 1
    lengths[1] = max_pages * page
    if layout != "random":
        pad = 0 if layout == "zero" else num_pages - 1
        for i in range(b):
            used = -(-int(lengths[i]) // page)
            pi[i, used:] = pad
    return q, kp, vp, pi, lengths


def _port(q, kp, vp, pi, lengths):
    return tpa.paged_attention_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pi), torch.from_numpy(lengths)).numpy()


CASES = [(seed, hkv, layout)
         for seed, hkv in ((0, 4), (1, 2))          # group 1 and group 2
         for layout in ("random", "zero", "sink")]


@pytest.mark.parametrize("seed,hkv,layout", CASES)
def test_plain_matches_jax_reference(seed, hkv, layout):
    from stochastic_gradient_push_tpu.serve.paged_attention import (
        paged_attention_reference)

    args = _case(seed, hkv=hkv, layout=layout)
    want = np.asarray(paged_attention_reference(*args))
    np.testing.assert_allclose(_port(*args), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed,hkv,layout", CASES)
def test_plain_matches_jax_interpret_kernel(seed, hkv, layout):
    from stochastic_gradient_push_tpu.serve.paged_attention import (
        paged_attention_decode)

    args = _case(seed, hkv=hkv, layout=layout)
    want = np.asarray(paged_attention_decode(*args, use_pallas=True,
                                             interpret=True))
    np.testing.assert_allclose(_port(*args), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hkv", [4, 2])
def test_length_one_row_is_its_first_value(hkv):
    q, kp, vp, pi, _ = _case(3, hkv=hkv)
    lengths = np.ones(q.shape[0], np.int32)
    out = _port(q, kp, vp, pi, lengths)
    group = q.shape[1] // hkv
    want = np.stack([np.repeat(vp[:, pi[i, 0], 0], group, axis=0)
                     for i in range(q.shape[0])])
    np.testing.assert_allclose(out, want, atol=ATOL, rtol=0)


def test_shape_errors_match_the_reference():
    q, kp, vp, pi, lengths = (torch.from_numpy(a) for a in _case(0))
    with pytest.raises(ValueError, match="q_heads"):
        tpa.paged_attention_decode(q[:, :3], kp, vp, pi, lengths)
    with pytest.raises(ValueError, match="lengths"):
        tpa.paged_attention_decode(q, kp, vp, pi, lengths[:2])
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention_decode(q[..., :8], kp, vp, pi, lengths)


def test_forced_kernel_on_cpu_raises_typed_error():
    args = (torch.from_numpy(a) for a in _case(0))
    with pytest.raises(KernelLaneError):
        tpa.paged_attention_decode(*args, force_kernel=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    # the wrapper launches the CUDA kernel or raises: no plain fallback
    args = [torch.from_numpy(a) for a in _case(0, d=64)]
    before = tpa.paged_decode.launches
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode(*args)
    assert tpa.paged_decode.launches == before


# csrc/paged_decode.cu's partition of a split: 4 warps take its pages w,
# w + 4, ... in steps of 8 tokens
K6_WARPS, K6_TOK = 4, 8


def _online(m, den, acc, s, v):
    """One online-softmax step of scores ``s [G, n]`` and values
    ``v [n, d]`` into ``(m, den, acc)`` (fp32)."""
    m_new = np.maximum(m, s.max(1))
    alpha = np.exp(m - m_new)
    p = np.exp(s - m_new[:, None])
    return m_new, den * alpha + p.sum(1), acc * alpha[:, None] + p @ v


def _fold(parts):
    """Fold ``[(m, den, acc)]`` in order, relative to their max m."""
    mx = np.max([m for m, _, _ in parts], axis=0)
    tot = np.zeros_like(mx)
    o = np.zeros_like(parts[0][2])
    for m, den, acc in parts:
        c = np.where(m == -np.inf, np.float32(0), np.exp(m - mx))
        tot = tot + den * c
        o = o + acc * c[:, None]
    return mx, tot, o


def _k6_split_and_combine(q, kp, vp, pi, lengths, split_pages):
    """The split-sequence decode as the kernels compute it, in fp32:
    per split, each warp's online softmax over its pages' token groups,
    the warps folded into the split's partial; then the partials folded
    in split order."""
    b, hq, d = q.shape
    hkv, num_pages, page, _ = kp.shape
    g = hq // hkv
    max_pages = pi.shape[1]
    out = np.zeros_like(q)
    with np.errstate(invalid="ignore"):
        for bi in range(b):
            n = int(lengths[bi])
            n_pages = min(max(-(-n // page), 0), max_pages)
            for h in range(hkv):
                qg = q[bi, h * g:(h + 1) * g] * np.float32(d ** -0.5)
                parts = []
                for p0 in range(0, n_pages, split_pages):
                    warps = []
                    for w in range(K6_WARPS):
                        st = (np.full(g, -np.inf, np.float32),
                              np.zeros(g, np.float32),
                              np.zeros((g, d), np.float32))
                        for j in range(p0 + w, min(p0 + split_pages,
                                                   n_pages), K6_WARPS):
                            assert 0 <= pi[bi, j] < num_pages
                            ntok = min(page, n - j * page)
                            for t0 in range(0, ntok, K6_TOK):
                                rows = slice(t0, min(t0 + K6_TOK, ntok))
                                kk = kp[h, pi[bi, j], rows]
                                st = _online(*st, qg @ kk.T,
                                             vp[h, pi[bi, j], rows])
                        warps.append(st)
                    parts.append(_fold(warps))
                if parts:
                    _, tot, o = _fold(parts)
                    out[bi, h * g:(h + 1) * g] = o / tot[:, None]
    return out


def _k6_case(seed, hkv, split_pages, page=4, max_pages=7):
    """Rows of length 1, ending on split boundaries, and max_pages*page."""
    q, kp, vp, pi, lengths = _case(seed, b=6, hkv=hkv, page=page,
                                   max_pages=max_pages)
    span = split_pages * page
    full = max_pages * page
    lengths[:] = [1, full, min(span, full), min(2 * span, full),
                  min(span + 1, full), lengths[5]]
    return q, kp, vp, pi, lengths


K6_SPLITS = [1, 2, 3, tpa.split_pages(4)]  # one page .. over every length


def test_split_pages_covers_about_split_tokens():
    assert [tpa.split_pages(p) for p in (4, 5, 16, 64, 128)] == [
        16, 12, 4, 1, 1]


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("split_pages", K6_SPLITS)
def test_k6_split_and_combine_matches_jax_reference(hkv, split_pages):
    from stochastic_gradient_push_tpu.serve.paged_attention import (
        paged_attention_reference)

    args = _k6_case(10 + split_pages, hkv, split_pages)
    want = np.asarray(paged_attention_reference(*args))
    np.testing.assert_allclose(_k6_split_and_combine(*args, split_pages),
                               want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("split_pages", K6_SPLITS)
def test_k6_split_and_combine_matches_jax_interpret_kernel(hkv,
                                                           split_pages):
    from stochastic_gradient_push_tpu.serve.paged_attention import (
        paged_attention_decode)

    args = _k6_case(20 + split_pages, hkv, split_pages)
    want = np.asarray(paged_attention_decode(*args, use_pallas=True,
                                             interpret=True))
    np.testing.assert_allclose(_k6_split_and_combine(*args, split_pages),
                               want, atol=ATOL, rtol=0)
