"""Synthetic image classification data.

A copy of ``synthetic_classification`` from ``stochastic_gradient_push_tpu/
data/pipeline.py`` (numpy only): the same arguments give bit-identical
arrays.  Images are NHWC, as the reference's loaders yield them.  The
ImageNet channel mean and std are re-exported from ``data/imagefolder.py``.
"""

from __future__ import annotations

import numpy as np

from .imagefolder import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["synthetic_classification", "IMAGENET_MEAN", "IMAGENET_STD"]


def synthetic_classification(n: int, num_classes: int = 10,
                             image_size: int = 16, channels: int = 3,
                             seed: int = 0, noise: float = 0.5,
                             dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Learnable synthetic image classification data: each class has a
    fixed random mean image (scale 1), a sample is its class mean plus
    noise of scale ``noise``.  Returns ``(images [n, H, W, C], labels
    [n] int32)``."""
    g = np.random.default_rng(seed)
    means = g.normal(scale=1.0,
                     size=(num_classes, image_size, image_size, channels))
    labels = g.integers(0, num_classes, size=(n,))
    images = means[labels] + g.normal(
        scale=noise, size=(n, image_size, image_size, channels))
    return images.astype(dtype), labels.astype(np.int32)
