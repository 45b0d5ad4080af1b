"""Running-statistics meters.

Copies of ``Meter`` and ``PercentileMeter`` from
``stochastic_gradient_push_tpu/utils/meter.py`` with no change of
behaviour.  ``Meter`` keeps the current value, mean, sample standard
deviation and (stateful) mean absolute deviation, and its ``__str__`` is
the reference's CSV cell ``val,avg,std`` (three decimals), so the
training CSVs stay byte-compatible; the serving bench's p50/p99 request
latency comes from ``PercentileMeter``.
"""

from __future__ import annotations

import collections
import math

__all__ = ["Meter", "PercentileMeter"]


class Meter:
    """Computes and stores the average, variance, and current value."""

    def __init__(self, init_dict: dict | None = None, ptag: str = "Time",
                 stateful: bool = False, csv_format: bool = True):
        self.reset()
        self.ptag = ptag
        self.value_history: list[float] | None = None
        self.stateful = stateful
        if self.stateful:
            self.value_history = []
        self.csv_format = csv_format
        if init_dict is not None:
            for key, val in init_dict.items():
                if key in ("val", "avg", "sum", "count", "std", "sqsum",
                           "mad", "ptag", "stateful", "csv_format",
                           "value_history"):
                    setattr(self, key, val)

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.std = 0.0
        self.sqsum = 0.0
        self.mad = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sqsum += (val ** 2) * n
        if self.count > 1:
            # clamp: float cancellation can drive the variance
            # epsilon-negative
            var = max(0.0, (self.sqsum - (self.sum ** 2) / self.count)
                      / (self.count - 1))
            self.std = var ** 0.5
        if self.stateful:
            self.value_history.append(val)
            mad = sum(abs(v - self.avg) for v in self.value_history)
            self.mad = mad / len(self.value_history)

    def state_dict(self) -> dict:
        """Snapshot for checkpointing (the meter's ``__dict__``)."""
        return dict(self.__dict__)

    def __str__(self) -> str:
        spread = self.mad if self.stateful else self.std
        if self.csv_format:
            return f"{self.val:.3f},{self.avg:.3f},{spread:.3f}"
        return f"{self.ptag}: {self.val:.3f} ({self.avg:.3f} +- {spread:.3f})"


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
