"""Host-to-device batch prefetch: the next batch's copy overlaps the step.

Port of ``DevicePrefetcher`` in ``stochastic_gradient_push_tpu/data/
prefetch.py``, where ``jax.device_put`` on a background thread becomes,
on a CUDA device:

* a host thread that copies each loader batch into **pinned** buffers
  (one set per slot, ``depth + 1`` slots, reused within a pass);
* the upload, ``non_blocking=True``, on a side stream, and an event
  recorded after it;
* the consumer's stream waits on that event, and ``record_stream``
  keeps the caching allocator from handing the batch's memory to the
  side stream again while a step still reads it;
* a pinned slot is refilled only once the event of its last upload has
  completed, so a batch in flight is never overwritten.

On the CPU (the caller named it) it is the thread and the queue alone:
batches come out as CPU tensors.  ``depth`` batches wait in the queue
at most.  The reference's contracts hold: the batches are the ones the
loader yields, an iterator abandoned early stops the thread (no
deadlock), and a loader error reaches the consumer.
"""

from __future__ import annotations

import queue
import threading
import typing as tp

import numpy as np
import torch

__all__ = ["DevicePrefetcher"]

_STOP = object()


def _dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


class _Slot:
    """One set of pinned host buffers and the event of its last upload."""

    def __init__(self):
        self.bufs: list[torch.Tensor] = []
        self.event: torch.cuda.Event | None = None

    def fill(self, arrays) -> list[torch.Tensor]:
        if self.event is not None:
            # the last upload out of these buffers must have landed
            self.event.synchronize()
        want = [(torch.Size(a.shape), _dtype(a)) for a in arrays]
        if [(b.shape, b.dtype) for b in self.bufs] != want:
            self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True)
                         for shape, dtype in want]
        for b, a in zip(self.bufs, arrays):
            np.copyto(b.numpy(), a)
        return self.bufs


class DevicePrefetcher:
    """Iterate ``loader``, moving each ``(x, y)`` to ``device`` ``depth``
    batches ahead on a host thread.  Delegates ``len``, ``set_epoch`` and
    ``fast_forward``, so it stands in for the loader in the train loop;
    an error raised by the loader re-raises on the consumer."""

    def __init__(self, loader, device, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the thread sets its device: name the caller's current one
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.depth = max(1, int(depth))

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def fast_forward(self, n: int) -> None:
        if hasattr(self.loader, "fast_forward"):
            self.loader.fast_forward(n)

    def _upload(self, slot: _Slot, batch, side):
        """``batch`` through ``slot``'s pinned buffers onto the card on
        the side stream: the device tensors and the copy's event."""
        pinned = slot.fill([np.ascontiguousarray(a) for a in batch])
        with torch.cuda.stream(side):
            out = [torch.empty(b.shape, dtype=b.dtype, device=self.device)
                   for b in pinned]
            for o, b in zip(out, pinned):
                o.copy_(b, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        slot.event = event
        return (*out, event)

    def __iter__(self) -> tp.Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        # this pass's own slots: a thread an abandoned pass left behind
        # never shares a buffer with the next pass
        slots = [_Slot() for _ in range(self.depth + 1)]

        def put(item) -> bool:
            # bounded put: a consumer that stops early sets `stop`, and
            # the thread exits instead of blocking on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                side = None
                if cuda:
                    torch.cuda.set_device(self.device)
                    side = torch.cuda.Stream(self.device)
                for k, batch in enumerate(self.loader):
                    item = (self._upload(slots[k % len(slots)],
                                         batch, side) if cuda
                            else tuple(torch.from_numpy(np.asarray(a))
                                       for a in batch))
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised below
                put(e)
                return
            put(_STOP)

        t = threading.Thread(target=work, daemon=True,
                             name="device-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    return
                if isinstance(item, BaseException):
                    raise item
                if cuda:
                    *tensors, event = item
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for x in tensors:
                        x.record_stream(stream)
                    item = tuple(tensors)
                yield item
        finally:
            stop.set()
