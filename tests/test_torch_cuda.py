"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and ``nvcc``; elsewhere they skip (the kernels
have no interpret mode).  On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Edge shapes beyond ``chip_smoke.py``'s: ragged prompt lengths around the
kernel's 64-row and 32-column tiles, a page size that is not a multiple of
the kernel's 8-token step, every GQA group the kernel is built for, and
padded page rows pointing at page 0 or at a sink page.  Tolerance: 1e-4
max abs in fp32 (TF32 off), as in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.ops import flash_attention as tfa
from stochastic_gradient_push_torch.serve import paged_attention as tpa

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("t", [1, 31, 63, 64, 65, 129, 136, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_plain(cuda, t, causal):
    g = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn(2, 3, t, 64, device=cuda, generator=g)
               for _ in range(3))
    before = tfa.flash_fwd.launches
    out = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    ref = tfa.flash_attention_reference(q, k, v, causal=causal)
    assert float((out - ref).abs().max()) <= TOL


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (6, 2), (8, 2),
                                    (5, 1), (6, 1), (7, 1), (8, 1)])
@pytest.mark.parametrize("page,pad", [(16, "zero"), (5, "sink")])
def test_paged_decode_matches_plain(cuda, hq, hkv, page, pad):
    r = np.random.default_rng(hq * 10 + hkv + page)
    b, num_pages, max_pages = 6, 40, 9
    kp = torch.tensor(r.standard_normal((hkv, num_pages, page, 64)),
                      dtype=torch.float32, device=cuda)
    vp = torch.tensor(r.standard_normal((hkv, num_pages, page, 64)),
                      dtype=torch.float32, device=cuda)
    q = torch.tensor(r.standard_normal((b, hq, 64)), dtype=torch.float32,
                     device=cuda)
    lengths = r.integers(1, max_pages * page + 1, size=b).astype(np.int32)
    lengths[:2] = (1, max_pages * page)
    pi = np.stack([r.permutation(num_pages - 1)[:max_pages]
                   for _ in range(b)]).astype(np.int32)
    for i in range(b):
        pi[i, -(-int(lengths[i]) // page):] = (0 if pad == "zero"
                                               else num_pages - 1)
    pi, lengths = (torch.tensor(a, device=cuda) for a in (pi, lengths))
    before = tpa.paged_decode.launches
    out = tpa.paged_attention_decode(q, kp, vp, pi, lengths)
    torch.cuda.synchronize()
    assert tpa.paged_decode.launches == before + 1
    ref = tpa.paged_attention_reference(q, kp, vp, pi, lengths)
    assert float((out - ref).abs().max()) <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q, q, q)
    with pytest.raises(TypeError, match="float32"):
        x = torch.randn(1, 2, 8, 64, device=cuda, dtype=torch.float64)
        tfa.flash_fwd(x, x, x)
    qd = torch.randn(2, 9, 64, device=cuda)
    pages = torch.randn(1, 4, 4, 64, device=cuda)
    pi = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="group"):
        tpa.paged_decode(qd, pages, pages, pi, lengths)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_decode(qd[:, :2].contiguous(), pages, pages, pi.long(),
                         lengths)
