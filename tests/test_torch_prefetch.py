"""The port's ``data/prefetch.py::DevicePrefetcher``: the three contracts
of the reference's ``tests/test_prefetch.py`` on the CPU (the thread and
the queue), and on a CUDA device (``cuda``-marked, skipped elsewhere)
the pinned upload on a side stream.

* the batches are those of the loader without prefetch;
* an iterator abandoned early stops its thread (no deadlock), and a
  second pass yields every batch;
* an error the loader raises reaches the consumer.
"""

import threading
import time

import numpy as np
import pytest
import torch

from stochastic_gradient_push_torch.data.pipeline import (DistributedSampler,
                                                          ShardedLoader)
from stochastic_gradient_push_torch.data.prefetch import DevicePrefetcher


def _loader(world=4, batch=2, n=64, dtype=np.float32):
    rng = np.random.default_rng(0)
    images = (rng.normal(size=(n, 4, 4, 3)) * 40 + 100).astype(dtype)
    labels = rng.integers(0, 4, n).astype(np.int32)
    sampler = DistributedSampler(n, world)
    return ShardedLoader(images, labels, batch, sampler), sampler


@pytest.mark.parametrize("depth", [1, 2, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_prefetch_yields_the_same_batches(depth, dtype):
    loader, sampler = _loader(dtype=dtype)
    sampler.set_epoch(0)
    plain = list(loader)
    sampler.set_epoch(0)
    pf = DevicePrefetcher(loader, "cpu", depth=depth)
    assert len(pf) == len(loader)
    fetched = list(pf)
    assert len(fetched) == len(plain)
    for (x0, y0), (x1, y1) in zip(plain, fetched):
        assert isinstance(x1, torch.Tensor) and x1.device.type == "cpu"
        np.testing.assert_array_equal(x0, x1.numpy())
        np.testing.assert_array_equal(y0, y1.numpy())


def test_prefetch_delegates_epoch_and_fast_forward():
    loader, sampler = _loader()
    pf = DevicePrefetcher(loader, "cpu")
    pf.set_epoch(3)
    pf.fast_forward(2)
    sampler.set_epoch(3)
    got = list(pf)
    loader.fast_forward(2)
    want = list(loader)
    assert len(got) == len(want) == len(loader) - 2
    for (x0, _), (x1, _) in zip(want, got):
        np.testing.assert_array_equal(x0, x1.numpy())


def test_prefetch_early_abandon_does_not_deadlock():
    loader, sampler = _loader(n=128)
    sampler.set_epoch(0)
    before = threading.active_count()
    it = iter(DevicePrefetcher(loader, "cpu", depth=1))
    next(it)
    it.close()  # the generator's finally stops the thread
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
    sampler.set_epoch(0)
    n = sum(1 for _ in DevicePrefetcher(loader, "cpu"))
    assert n == len(loader)


def test_prefetch_propagates_loader_errors():
    class Boom:
        def __iter__(self):
            yield (np.zeros((4, 1, 4, 4, 3), np.float32),
                   np.zeros((4, 1), np.int32))
            raise RuntimeError("loader died")

        def __len__(self):
            return 2

    it = iter(DevicePrefetcher(Boom(), "cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)


@pytest.mark.cuda
def test_prefetch_uploads_through_pinned_buffers_on_a_side_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned upload on a side "
                    "stream runs only on the card")
    loader, sampler = _loader(n=256, dtype=np.uint8)
    sampler.set_epoch(0)
    plain = list(loader)
    sampler.set_epoch(0)
    seen = []
    for x, y in DevicePrefetcher(loader, "cuda", depth=2):
        assert x.is_cuda and y.is_cuda
        # a step that outlasts the next uploads must still read its batch
        torch.cuda._sleep(2_000_000)
        seen.append((x.cpu().numpy(), y.cpu().numpy()))
    assert len(seen) == len(plain)
    for (x0, y0), (x1, y1) in zip(plain, seen):
        np.testing.assert_array_equal(x0, x1)
        np.testing.assert_array_equal(y0, y1)
