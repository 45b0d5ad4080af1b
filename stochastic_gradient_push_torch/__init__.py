"""stochastic_gradient_push_torch — the PyTorch / CUDA (Hopper) port.

A second package beside the JAX reference ``stochastic_gradient_push_tpu``.
It imports torch and never jax, nor anything of the reference package.
Every Pallas kernel of the reference becomes a hand-written CUDA kernel
for ``sm_90a`` (``csrc/``) with a plain PyTorch twin beside it; the twin
runs on CPU tensors and is the oracle the kernel is checked against on
the card.

Ported so far: the serving path (``serve/``) with the flash-attention
forward (``ops/flash_attention.py``) and paged decode
(``serve/paged_attention.py``) kernels.
"""

__version__ = "0.1.0"

from .device import DeviceUnavailableError, resolve_device  # noqa: F401
