"""bf16 comparison helpers shared by the port's parity tests.

The reference's bf16 paths widen to fp32, compute in fp32 and round each
output once to bf16; the port's do the same, so on one set of bf16 inputs
the two agree to a rounding of the output: equal, or a bf16 ulp apart
(the frameworks sum in another order, which can flip a rounding).  Where
an element's sum cancels far below the tensor's scale its bf16 ulp
shrinks with it, and the two fp32 sums' own rounding (:data:`NEAR`, 1e-6
of the tensor's largest magnitude) decides instead.
"""

import numpy as np
import torch

NEAR = 1e-6


def to_bf16(x: np.ndarray) -> torch.Tensor:
    """numpy fp32 -> torch bf16, rounded once (to nearest even)."""
    return torch.from_numpy(x).to(torch.bfloat16)


def jax_bf16(x: torch.Tensor):
    """The same bf16 values as a JAX array (exact: bf16 -> fp32 -> bf16)."""
    import jax.numpy as jnp

    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def from_jax(a) -> torch.Tensor:
    """A JAX array as a torch tensor of its own dtype (bf16 or fp32)."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if str(a.dtype) == "bfloat16" else t


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns as integers in the order of their values (+0 and
    -0 both 0), so that a difference counts ulps."""
    i = x.view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -32768 - i, i)


def assert_bf16_close(got, want, ulps: int = 1, name: str = ""):
    """Elementwise within ``ulps`` bf16 steps, or within :data:`NEAR` of
    the largest ``|want|``."""
    assert got.dtype == want.dtype == torch.bfloat16, (got.dtype, want.dtype)
    steps = (_ordered(got) - _ordered(want)).abs()
    near = ((got.float() - want.float()).abs()
            <= NEAR * float(want.float().abs().max()))
    bad = (steps > ulps) & ~near
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements more than "
                           f"{ulps} bf16 ulp apart, worst {int(steps.max())}")
