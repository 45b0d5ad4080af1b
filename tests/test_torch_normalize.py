"""The uint8 normalisation on the device (``train/step.py::
normalize_images``) against the reference's ``_device_normalize`` under
``jax.jit``, bit for bit.

XLA compiles ``(x / 255 - mean) / std`` to ``fma(x, f32(1/255), -mean)
* f32(1/std)``: both divisions become multiplies by float32
reciprocals, and the first multiply and the subtraction one fused
multiply-add.  The eager reference (two divisions) differs from its own
compiled form in a few hundred of the 768 (value, channel) pairs; the
port matches the compiled form in all of them.
"""

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.train.step import normalize_images

jax = pytest.importorskip("jax")
ref_step = pytest.importorskip("stochastic_gradient_push_tpu.train.step")


def _ref(x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(ref_step._device_normalize)(x))


def test_one_uint8_batch_from_seed_0_bit_equal():
    x = np.random.default_rng(0).integers(
        0, 256, size=(4, 8, 32, 32, 3)).astype(np.uint8)
    got = normalize_images(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), _ref(x))


def test_every_pixel_value_and_channel_bit_equal():
    x = np.repeat(np.arange(256, dtype=np.uint8)[None, None, :, None], 3,
                  axis=3)
    got = normalize_images(torch.from_numpy(x)).numpy()
    want = _ref(x)
    np.testing.assert_array_equal(got, want)
    # the compiled form is not the eager one: parity is with jax.jit
    eager = np.asarray(ref_step._device_normalize(x))
    assert (eager != want).any()


def test_float_batches_pass_through():
    f = torch.ones(2, 3, 4, 4, 3)
    assert normalize_images(f) is f
