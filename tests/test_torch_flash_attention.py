"""Port parity: flash-attention forward (``stochastic_gradient_push_torch.
ops.flash_attention``) against the JAX package's blockwise oracle and its
Pallas forward kernel in interpret mode, on the same numpy inputs.

The port runs its plain version here; the CUDA kernel is held against it
on the card.  Tolerance: atol 2e-5 in fp32 (blocked online softmax on the
JAX side vs one dense softmax on the port's).
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.ops import flash_attention as tfa
from stochastic_gradient_push_torch.ops.lanes import KernelLaneError

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


def test_grad_inputs_are_refused_naming_the_backward_kernels():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 8))
    with pytest.raises(NotImplementedError, match="_flash_dq_kernel"):
        tfa.flash_attention(q.requires_grad_(), k, v, causal=True)


def test_forced_kernel_on_cpu_raises_typed_error():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 8))
    with pytest.raises(KernelLaneError):
        tfa.flash_attention(q, k, v, causal=True, force_kernel=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 8, d=64))
    before = tfa.flash_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, k, v, causal=True)
    assert tfa.flash_fwd.launches == before
