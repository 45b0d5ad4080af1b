"""Kernel-lane selection, by where the tensor lies.

The counterpart of the reference's ``resolve_use_pallas``
(``ops/gossip_kernel.py:121-130``), with the rule turned to what a GPU
port needs: a CUDA tensor goes to the hand-written kernel, a CPU tensor
to the kernel's plain PyTorch version.  Forcing the kernel on a CPU
tensor raises :class:`KernelLaneError`; nothing falls back.
"""

from __future__ import annotations

import torch

__all__ = ["KernelLaneError", "LANES", "pick_lane", "use_kernel"]


class KernelLaneError(RuntimeError):
    """The kernel lane was forced for a tensor that is not on CUDA."""


def use_kernel(x: torch.Tensor, force_kernel: bool = False) -> bool:
    """True when ``x`` lies on CUDA (launch the kernel), False on the CPU
    (run the plain version).  ``force_kernel`` makes a CPU tensor an
    error instead of a plain-lane call."""
    if x.is_cuda:
        return True
    if force_kernel:
        raise KernelLaneError(
            f"kernel lane forced for a tensor on {x.device}; the CUDA "
            f"kernels take CUDA tensors only")
    return False


LANES = ("auto", "kernel", "plain")


def pick_lane(x: torch.Tensor, lane: str = "auto") -> bool:
    """True to launch the kernel for ``x``.  ``lane``: ``auto`` decides
    by where ``x`` lies (:func:`use_kernel`), ``kernel`` forces the kernel
    (a CPU tensor raises :class:`KernelLaneError`), ``plain`` runs the
    plain version wherever ``x`` lies: the card's oracle, asked for by
    name, never a fallback."""
    if lane not in LANES:
        raise ValueError(f"lane {lane!r} is not one of {LANES}")
    return lane != "plain" and use_kernel(x, lane == "kernel")
