"""Small models for tests and smoke runs.

Port of ``stochastic_gradient_push_tpu/models/small.py`` over NCHW
batches.  ``TinyCNN``: three 3x3 SAME convolutions (flax's default
lecun-normal init, no bias), each followed by BatchNorm, ReLU and a 2x2
average pool, then the spatial mean and a dense head ``~ N(0, 0.01)``.
``TinyMLP``: two dense layers (lecun-normal, zero bias) over the image
flattened in the reference's NHWC order.  Both take ``forward(x,
train=True, stats_out=None)`` like ``models/resnet.py::ResNet``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm, Conv2d, Linear, _name_norms

__all__ = ["TinyCNN", "TinyMLP"]


class TinyCNN(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i in range(3):
            setattr(self, f"conv{i}", Conv2d(cin, width * 2 ** i, 3,
                                             kernel_init="lecun_normal"))
            setattr(self, f"bn{i}", BatchNorm(width * 2 ** i))
            cin = width * 2 ** i
        self.fc = Linear(cin, num_classes)
        _name_norms(self)

    def forward(self, x: torch.Tensor, train: bool = True,
                stats_out: dict | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(3):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train,
                                         stats_out)
            x = F.avg_pool2d(F.relu(x), 2, 2)
        x = x.mean((2, 3), dtype=torch.promote_types(
            x.dtype, torch.float32)).to(self.dtype)
        return self.fc(x).float()


class TinyMLP(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 32,
                 in_features: int = 3 * 8 * 8):
        super().__init__()
        self.fc1 = Linear(in_features, width, kernel_init="lecun_normal")
        self.fc2 = Linear(width, num_classes, kernel_init="lecun_normal")

    def forward(self, x: torch.Tensor, train: bool = True,
                stats_out: dict | None = None) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc2(F.relu(self.fc1(x)))
