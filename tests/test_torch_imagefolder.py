"""The port's ImageFolder loader (``data/imagefolder.py``,
``data/streaming.py``) against the reference's PIL objects, bit for bit,
on a small JPEG tree written here.

* ``scan_image_folder``: the same paths, labels and classes;
* the crop boxes ``augmentation_rng`` drives, the centre-crop fallback
  included;
* ``load_image`` for train and val, float32 and uint8;
* ``StreamingImageFolder`` over 2 epochs (``set_epoch``), with
  ``fast_forward`` and a ``ranks`` subset, each batch equal to the
  reference's ``backend="pil"`` batch, and in the model's layout
  (NCHW, as the train step transposes each rank's batch, after the
  uint8 normalisation on the device) equal to the reference's batch
  transposed to NCHW;
* the loader's cap: a batch a task, at most ``prefetch`` + 1 batches
  decoding at once.
"""

import threading
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.data import imagefolder as port_if
from stochastic_gradient_push_torch.data.streaming import (
    NATIVE_REFUSAL, StreamingImageFolder)
from stochastic_gradient_push_torch.train.step import normalize_images

jax = pytest.importorskip("jax")
ref_if = pytest.importorskip("stochastic_gradient_push_tpu.data.imagefolder")
ref_streaming = pytest.importorskip(
    "stochastic_gradient_push_tpu.data.streaming")

WORLD, BATCH, IMG = 4, 2, 16
# source images larger than IMG and not square, so the random crops and
# the val resize and centre crop resample for real
SRC_W, SRC_H = 40, 32


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.default_rng(0)
    for split, per_class in (("train", 6), ("val", 3)):
        for c in range(3):
            d = root / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(per_class):
                px = rng.integers(0, 256, (SRC_H, SRC_W, 3)).astype(np.uint8)
                px[..., c] = 220
                Image.fromarray(px).save(d / f"img_{i}.jpg", quality=90)
            # a file that is not an image is skipped by both
            (d / "notes.txt").write_text("x")
    return root


def test_scan_image_folder_matches_the_reference(jpeg_root):
    for split in ("train", "val"):
        got = port_if.scan_image_folder(str(jpeg_root / split))
        want = ref_if.scan_image_folder(str(jpeg_root / split))
        assert got[0] == want[0] and got[2] == want[2]
        assert got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("w,h", [(40, 32), (224, 160), (300, 20), (12, 90)])
def test_crop_boxes_match_the_reference(w, h):
    # (300, 20) and (12, 90) fall back to the centre crop on most draws
    for seed, epoch, idx in [(0, 0, 0), (47, 3, 11), (5, 1, 123456)]:
        got = port_if._random_resized_crop_box(
            w, h, port_if.augmentation_rng(seed, epoch, idx))
        want = ref_if._random_resized_crop_box(
            w, h, ref_if.augmentation_rng(seed, epoch, idx))
        assert got == want


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("raw", [False, True], ids=["f32", "uint8"])
def test_load_image_bit_equal(jpeg_root, train, raw):
    paths = port_if.scan_image_folder(str(jpeg_root / "train"))[0]
    for k, path in enumerate(paths[:4]):
        got = port_if.load_image(
            path, IMG, train, port_if.augmentation_rng(3, 1, k), raw=raw)
        want = ref_if.load_image(
            path, IMG, train, ref_if.augmentation_rng(3, 1, k), raw=raw)
        assert got.dtype == want.dtype == (np.uint8 if raw else np.float32)
        assert got.shape == (IMG, IMG, 3)
        np.testing.assert_array_equal(got, want)


def test_imagenet_constants_match_the_reference():
    np.testing.assert_array_equal(port_if.IMAGENET_MEAN, ref_if.IMAGENET_MEAN)
    np.testing.assert_array_equal(port_if.IMAGENET_STD, ref_if.IMAGENET_STD)


def _model_layout(x: np.ndarray) -> np.ndarray:
    """Rank by rank, what the model sees: normalised on the device when
    uint8, then NCHW."""
    t = normalize_images(torch.from_numpy(x))
    return t.permute(0, 1, 4, 2, 3).numpy()


def _ref_model_layout(x: np.ndarray) -> np.ndarray:
    from stochastic_gradient_push_tpu.train.step import _device_normalize

    if x.dtype == np.uint8:
        x = np.asarray(jax.jit(_device_normalize)(x))
    return np.transpose(x, (0, 1, 4, 2, 3))


@pytest.mark.parametrize("ranks", [None, [1, 3]], ids=["all", "ranks13"])
@pytest.mark.parametrize("output", ["f32", "uint8"])
def test_streaming_batches_bit_equal_over_two_epochs(jpeg_root, output,
                                                     ranks):
    kw = dict(image_size=IMG, num_workers=2, prefetch=2, seed=7,
              ranks=ranks, output=output)
    port = StreamingImageFolder(str(jpeg_root), "train", WORLD, BATCH,
                                backend="pil", **kw)
    ref = ref_streaming.StreamingImageFolder(str(jpeg_root), "train", WORLD,
                                             BATCH, backend="pil", **kw)
    # 18 images: ceil(18 / 4) = 5 a rank, 2 batches of 2
    assert len(port) == len(ref) == 2
    rows = WORLD if ranks is None else len(ranks)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        if epoch == 1:
            # resume mid-epoch: the first batch is skipped by both
            port.fast_forward(1)
            ref.fast_forward(1)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) - epoch
        for (x, y), (rx, ry) in zip(got, want):
            assert x.dtype == rx.dtype and x.shape == (rows, BATCH, IMG,
                                                       IMG, 3)
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_array_equal(y, ry)
            np.testing.assert_array_equal(_model_layout(x),
                                          _ref_model_layout(rx))


def test_streaming_decodes_at_most_prefetch_plus_one_batches(jpeg_root):
    # a batch a task: with 4 threads and prefetch 2, the batch the
    # consumer waits on and the 2 behind it decode at once, never a 4th
    loader = StreamingImageFolder(str(jpeg_root), "train", WORLD, 1,
                                  image_size=IMG, num_workers=4, prefetch=2)
    lock, active, most = threading.Lock(), [0], [0]
    load = loader._load_batch

    def counted_load(idx_block):
        with lock:
            active[0] += 1
            most[0] = max(most[0], active[0])
        time.sleep(0.1)
        try:
            return load(idx_block)
        finally:
            with lock:
                active[0] -= 1

    loader._load_batch = counted_load
    loader.set_epoch(0)
    # 18 images: 5 a rank, 5 batches of one
    assert len(list(loader)) == len(loader) == 5
    assert most[0] == 3


def test_val_split_streams_the_reference_batches(jpeg_root):
    kw = dict(image_size=IMG, train=False, num_workers=2, output="uint8")
    port = StreamingImageFolder(str(jpeg_root), "val", 2, 2, **kw)
    ref = ref_streaming.StreamingImageFolder(str(jpeg_root), "val", 2, 2,
                                             backend="pil", **kw)
    for (x, y), (rx, ry) in zip(list(port), list(ref), strict=True):
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)


def test_native_backend_is_refused_by_name(jpeg_root):
    with pytest.raises(ValueError, match="jpeglib.h"):
        StreamingImageFolder(str(jpeg_root), "train", WORLD, BATCH,
                             backend="native")
    assert "data/native.py" in NATIVE_REFUSAL
    with pytest.raises(ValueError, match="unknown output"):
        StreamingImageFolder(str(jpeg_root), "train", WORLD, BATCH,
                             output="f16")
