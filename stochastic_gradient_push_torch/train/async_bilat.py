"""Wall-clock-asynchronous AD-PSGD: bilateral averaging on a host thread
while the card steps.

Port of ``AsyncBilateralAverager`` in ``stochastic_gradient_push_tpu/
train/async_bilat.py``, the executable counterpart of the original's
separate averaging process: the train step carries no inter-replica
communication (the base ``GossipAlgorithm``: local SGD), and

* :meth:`~AsyncBilateralAverager.publish` snapshots the live
  world-stacked params after step ``k``;
* a daemon thread copies the newest snapshot to the host, computes one
  perfect-matching round's displacement ``(x[partner] - x) * 0.5`` in
  fp32 numpy, as the reference does, and leaves it in a mailbox that is
  overwritten, not queued;
* :meth:`~AsyncBilateralAverager.maybe_adopt` adds the ready
  displacement to the params at step ``k + δ``, δ set by real host and
  device timing.  The addition keeps every SGD update made since the
  snapshot.

On a CUDA device the three hand-offs are ordered by the card, not by
hope.  The optimizer and the adoption write the params in place, so the
snapshot is a ``clone`` issued on the compute stream before the next
step is, with an event recorded after it; the thread copies it only once
that event has completed, into pinned buffers on a side stream of its
own (a bare ``.cpu()`` from the thread would queue behind the next
step's kernels on the default stream and inflate δ without any error).
The adoption copies the displacement from pinned memory on the compute
stream and adds it in place; its host source stays referenced until an
event after the copy has completed.

:meth:`~AsyncBilateralAverager.staleness_summary` reports the measured
δ with the reference's keys.  A thread that dies logs the traceback and
re-raises, as the reference's does; here the next
:meth:`~AsyncBilateralAverager.maybe_adopt` raises too, so training
never carries on as local SGD while calling itself AD-PSGD.
Single-process only (every rank in one process).
"""

from __future__ import annotations

import threading
import time
import traceback

import numpy as np
import torch

__all__ = ["AsyncBilateralAverager"]


class AsyncBilateralAverager:
    """Host-async bilateral averaging over a perfect-matching schedule.

    Args:
      pairing: ``[n_phases, world]`` partner table from
        ``topology.build_pairing_schedule`` (row r, column i: i's
        partner in phase r).
      min_interval_s: least wall-clock gap between averaging rounds; 0
        averages as fast as the host can, a larger value widens the
        staleness.  The wait is on the stop event, so :meth:`stop`
        never waits it out.
    """

    def __init__(self, pairing, min_interval_s: float = 0.0):
        self.pairing = np.asarray(pairing)
        if self.pairing.ndim != 2:
            raise ValueError("pairing must be [n_phases, world]")
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._published: tuple | None = None
        self._mailbox: tuple | None = None
        self._last_read_step = -1
        self._phase = 0
        self._adoptions: list[tuple[int, int]] = []  # (read, adopted)
        self._rounds = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._host_in: dict = {}     # pinned copies of a CUDA snapshot
        self._landing = None         # (host source, event) of an adoption

    # -- train-loop side ---------------------------------------------------

    def start(self) -> "AsyncBilateralAverager":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="async-bilat")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    @property
    def alive(self) -> bool:
        """Whether the averaging thread is running."""
        return self._thread is not None and self._thread.is_alive()

    def publish(self, step: int, params: dict) -> None:
        """Expose the live world-stacked params (``{name: [R, ...]}``) to
        the averaging thread: a clone of each, issued on the current
        stream, and on a CUDA device an event recorded after them."""
        snap = {n: p.detach().clone() for n, p in params.items()}
        event = None
        if next(iter(snap.values())).is_cuda:
            event = torch.cuda.Event()
            event.record()
        with self._lock:
            self._published = (int(step), snap, event)

    def maybe_adopt(self, step: int, params: dict):
        """Add a ready displacement to ``params`` in place, if there is
        one: ``(params, adopted)``."""
        if self._error is not None:
            raise RuntimeError("the async bilateral averaging thread died; "
                               "training would go on as local SGD"
                               ) from self._error
        with self._lock:
            box, self._mailbox = self._mailbox, None
        if box is None:
            return params, False
        read_step, disp = box
        self._adoptions.append((read_step, int(step)))
        if self._landing is not None:
            self._landing[1].synchronize()
        event = None
        for n, p in params.items():
            p.add_(disp[n].to(p.device, non_blocking=True))
        if p.is_cuda:
            event = torch.cuda.Event()
            event.record()
        # the pinned source stays alive until its copies have landed
        self._landing = (disp, event) if event is not None else None
        return params, True

    def staleness_summary(self) -> dict:
        """Measured wall-clock staleness, in steps."""
        if not self._adoptions:
            return {"adoptions": 0, "rounds": self._rounds}
        d = np.array([a - r for r, a in self._adoptions])
        return {"adoptions": len(d), "rounds": self._rounds,
                "staleness_mean": float(d.mean()),
                "staleness_p50": float(np.median(d)),
                "staleness_max": int(d.max())}

    # -- averaging-thread side ---------------------------------------------

    def _to_host(self, params: dict, event, side) -> dict | None:
        """The snapshot as fp32 numpy arrays (None if stopped first)."""
        if event is None:
            return {n: p.numpy() for n, p in params.items()}
        while not event.query():
            # the clone is not finished on the compute stream yet
            if self._stop.wait(0.0005):
                return None
        with torch.cuda.stream(side):
            for n, p in params.items():
                buf = self._host_in.get(n)
                if buf is None or buf.shape != p.shape:
                    buf = self._host_in[n] = torch.empty(
                        p.shape, dtype=p.dtype, pin_memory=True)
                buf.copy_(p, non_blocking=True)
        side.synchronize()
        return {n: self._host_in[n].numpy() for n in params}

    def _run(self) -> None:
        try:
            side = None
            while not self._stop.is_set():
                with self._lock:
                    snap = self._published
                if snap is None or snap[0] == self._last_read_step:
                    time.sleep(0.001)  # nothing new published yet
                    continue
                step, params, event = snap
                self._last_read_step = step
                if event is not None and side is None:
                    torch.cuda.set_device(next(iter(params.values())).device)
                    side = torch.cuda.Stream()
                host = self._to_host(params, event, side)
                if host is None:
                    return
                del params, snap
                partner = self.pairing[self._phase % len(self.pairing)]
                self._phase += 1
                disp = {}
                for n, a in host.items():
                    out = torch.empty(a.shape, dtype=torch.float32,
                                      pin_memory=event is not None)
                    o = out.numpy()
                    # (a[partner] - a) * 0.5, rounded as the reference's
                    np.subtract(a[partner], a, out=o)
                    np.multiply(o, 0.5, out=o)
                    disp[n] = out
                with self._lock:
                    # overwrite, don't queue: only the newest round
                    # survives, as in the original's shared buffer
                    self._mailbox = (step, disp)
                self._rounds += 1
                if self.min_interval_s:
                    self._stop.wait(self.min_interval_s)
        except BaseException as e:
            from ..utils.logging import make_logger

            self._error = e
            make_logger("async-bilat").error(
                "averaging thread died; training cannot go on as "
                f"AD-PSGD:\n{traceback.format_exc()}")
            raise
