"""Percentiles over a bounded window.

A copy of ``PercentileMeter`` from ``stochastic_gradient_push_tpu/utils/
meter.py`` with no change of behaviour: the serving bench's p50/p99
request latency comes from it.
"""

from __future__ import annotations

import collections
import math

__all__ = ["PercentileMeter"]


class PercentileMeter:
    """Percentiles over a BOUNDED value history (a deque, not a list).

    The window holds the most recent ``maxlen`` samples; percentiles are
    computed on demand (the window is small, sorting it is microseconds).
    """

    def __init__(self, maxlen: int = 1024, ptag: str = "Time"):
        if maxlen < 1:
            raise ValueError("maxlen must be >= 1")
        self.ptag = ptag
        self._window: collections.deque[float] = collections.deque(
            maxlen=maxlen)
        self.count = 0  # lifetime updates (window holds min(count, maxlen))

    def update(self, val: float) -> None:
        self._window.append(float(val))
        self.count += 1

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100) of the window; 0.0 before the first
        update.  Upper nearest-rank (ceil): tail percentiles round toward
        the outlier — a p99 over 100 samples returns the worst one, which
        is the whole point of watching p99."""
        if not self._window:
            return 0.0
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile {q} outside [0, 100]")
        ordered = sorted(self._window)
        rank = min(len(ordered) - 1,
                   max(0, math.ceil(q / 100.0 * (len(ordered) - 1))))
        return ordered[rank]

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    def __str__(self) -> str:
        return (f"{self.ptag}: p50 {self.p50:.3f} p99 {self.p99:.3f} "
                f"(n={self.count})")
