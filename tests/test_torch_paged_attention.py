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
