"""ImageFolder decoding and augmentation (PIL + numpy).

A copy of ``stochastic_gradient_push_tpu/data/imagefolder.py``: the same
directory scan, per-sample augmentation stream, crop boxes, flips,
resampling filter (bilinear) and normalisation, so the same files, seed
and epoch give bit-identical images.

* train: RandomResizedCrop(size, scale=(0.08, 1.0), ratio=(3/4, 4/3))
  and a horizontal flip with probability 0.5;
* eval: resize the short side to ``size * 256 / 224``, centre crop;
* output: ImageNet-normalised float32 HWC, or the uint8 pixels before
  normalisation (``raw``), which the train step normalises on the device
  (``train/step.py::normalize_images``).

Layout: ``root/class_name/*.{png,jpg,...}``, classes indexed in sorted
order (torchvision's ImageFolder contract).
"""

from __future__ import annotations

import math
import os

import numpy as np

__all__ = ["scan_image_folder", "load_image", "ImageFolderDataset",
           "augmentation_rng", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def scan_image_folder(root: str) -> tuple[list[str], np.ndarray, list[str]]:
    """``(paths, labels, class_names)``; classes indexed in sorted
    order."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class directories under {root}")
    paths, labels = [], []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if os.path.splitext(fname)[1].lower() in _EXTENSIONS:
                paths.append(os.path.join(cdir, fname))
                labels.append(idx)
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    return paths, np.asarray(labels, np.int32), classes


def augmentation_rng(seed: int, epoch: int, idx: int) -> np.random.Generator:
    """The per-(seed, epoch, sample) augmentation stream: deterministic,
    with fresh crops every epoch."""
    return np.random.default_rng(
        (seed * 1_000_003 + epoch) * 10_000_019 + int(idx))


def _random_resized_crop_box(w: int, h: int, rng: np.random.Generator,
                             scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision's RandomResizedCrop box sampling (10 tries, then the
    largest centre crop within the ratio bounds)."""
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            return left, top, cw, ch
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def load_image(path: str, image_size: int, train: bool,
               rng: np.random.Generator | None = None,
               raw: bool = False) -> np.ndarray:
    """Decode and transform one image: ImageNet-normalised float32 HWC,
    or the uint8 pixels before normalisation when ``raw``."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        if train:
            rng = rng or np.random.default_rng()
            left, top, cw, ch = _random_resized_crop_box(w, h, rng)
            img = img.resize((image_size, image_size), Image.BILINEAR,
                             box=(left, top, left + cw, top + ch))
            if rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            short = int(image_size * 256 / 224)
            if w <= h:
                nw, nh = short, max(short, int(round(short * h / w)))
            else:
                nh, nw = short, max(short, int(round(short * w / h)))
            img = img.resize((nw, nh), Image.BILINEAR)
            left = (nw - image_size) // 2
            top = (nh - image_size) // 2
            img = img.crop((left, top, left + image_size,
                            top + image_size))
        if raw:
            return np.asarray(img, np.uint8)
        arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


class ImageFolderDataset:
    """Indexable decoded dataset over an ImageFolder directory."""

    def __init__(self, root: str, image_size: int = 224,
                 train: bool = True, seed: int = 0):
        self.paths, self.labels, self.classes = scan_image_folder(root)
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.paths)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.int32]:
        return (self.decode(idx), self.labels[idx])

    def decode(self, idx: int, raw: bool = False) -> np.ndarray:
        """One decoded image (normalised float32, or uint8 when
        ``raw``): the one place the per-sample stream meets the
        transform."""
        rng = (augmentation_rng(self.seed, self.epoch, idx)
               if self.train else None)
        return load_image(self.paths[idx], self.image_size, self.train,
                          rng, raw=raw)
