"""Device resolution: the port's entry points run on CUDA unless told not to.

There is no silent CPU fallback.  ``resolve_device()`` with no argument
means the first CUDA card and raises :class:`DeviceUnavailableError`
when there is none; the CPU is used only when the caller names it (the
tests do, with ``device="cpu"``).
"""

from __future__ import annotations

import torch

__all__ = ["DeviceUnavailableError", "resolve_device"]


class DeviceUnavailableError(RuntimeError):
    """CUDA was asked for (explicitly or by default) and is not there."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain lane on the CPU")
    return dev
