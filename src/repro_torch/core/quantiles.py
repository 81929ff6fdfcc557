"""Streaming quantile estimation for bounded-memory telemetry.

At 1M events the flat latency lists behind ``MetricsCollector``'s
percentiles stop being free.  This module provides:

* :class:`P2Quantile` — the P² algorithm (Jain & Chlamtac 1985): one
  quantile tracked with five markers, O(1) memory and update time.
* :class:`QuantileSketch` — a small-n-exact wrapper: below
  ``threshold`` observations it keeps the raw sample and answers with
  the exact nearest-rank percentile (bit-identical to
  ``MetricsCollector.percentile``, so existing gates don't move); past
  the threshold it spills into a grid of P² estimators seeded from the
  buffered sample and answers approximately from the nearest grid point.

Accuracy contract (checked by ``tests/test_quantile_sketch.py``): exact
below the threshold; above it, estimates are clamped to the observed
``[min, max]`` and empirically land within a few percentile points of
rank for i.i.d.-ish streams.  Queries are expected at grid points
(p50/p90/p95/p99 by default) — off-grid queries snap to the nearest
grid estimator.

The port's copy of ``repro.core.quantiles`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

# Below this many observations a sketch is exact (raw sorted sample).
# Every gated bench section settles well under this, so their percentile
# gates keep the exact nearest-rank values.
EXACT_THRESHOLD = 2048

# default estimator grid (percent) — must cover every percentile the
# metrics summaries report (p50/p99) plus the common SLO points
DEFAULT_GRID = (50.0, 90.0, 95.0, 99.0)


def nearest_rank(sorted_values: Sequence[float], p: float) -> Optional[float]:
    """Exact nearest-rank percentile of an already-sorted sample: the
    smallest value with at least ``p``% of the sample at or below it
    (rank ``ceil(p/100*n)``, clamped).  None on an empty sample."""
    n = len(sorted_values)
    if n == 0:
        return None
    idx = max(math.ceil(p / 100.0 * n) - 1, 0)
    return sorted_values[min(idx, n - 1)]


class P2Quantile:
    """One streaming quantile via the P² algorithm — five markers whose
    heights approximate the p-quantile without storing observations."""

    __slots__ = ("p", "_q", "_n", "_np", "_dn", "_init")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"p must be in (0, 1), got {p}")
        self.p = p
        self._init: List[float] = []    # first five observations
        self._q: List[float] = []       # marker heights
        self._n: List[float] = []       # marker positions (1-based)
        self._np: List[float] = []      # desired positions
        self._dn = (0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0)

    @property
    def count(self) -> int:
        """Observations seen so far."""
        if self._init is not None:
            return len(self._init)
        return int(self._n[4])

    def add(self, x: float) -> None:
        """Fold one observation into the estimator."""
        if self._init is not None:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self._q = list(self._init)
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                p = self.p
                self._np = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p,
                            3.0 + 2.0 * p, 5.0]
                self._init = None
            return
        q, n = self._q, self._n
        # locate the cell, extending extremes when needed
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and not (q[k] <= x < q[k + 1]):
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        # adjust interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or \
               (d <= -1.0 and n[i - 1] - n[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                qi = self._parabolic(i, d)
                if not (q[i - 1] < qi < q[i + 1]):
                    qi = self._linear(i, d)
                q[i] = qi
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self._q, self._n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i]) +
            (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        q, n = self._q, self._n
        j = i + int(d)
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    def value(self) -> Optional[float]:
        """Current estimate (exact nearest-rank before five observations;
        the middle P² marker after).  None with no observations."""
        if self._init is not None:
            if not self._init:
                return None
            return nearest_rank(sorted(self._init), self.p * 100.0)
        return self._q[2]


class QuantileSketch:
    """Percentiles that are exact for small samples and bounded-memory
    approximate past ``threshold`` (see module docstring)."""

    __slots__ = ("threshold", "grid", "n", "_buf", "_sorted",
                 "_estimators", "_min", "_max")

    def __init__(self, grid: Sequence[float] = DEFAULT_GRID,
                 threshold: int = EXACT_THRESHOLD):
        self.threshold = threshold
        self.grid: Tuple[float, ...] = tuple(sorted(grid))
        self.n = 0
        self._buf: Optional[List[float]] = []
        self._sorted = True
        self._estimators: Optional[List[P2Quantile]] = None
        self._min = math.inf
        self._max = -math.inf

    @property
    def exact(self) -> bool:
        """True while the sketch still holds the raw sample."""
        return self._buf is not None

    def add(self, x: float) -> None:
        """Fold one observation into the sketch."""
        self.n += 1
        if x < self._min:
            self._min = x
        if x > self._max:
            self._max = x
        if self._buf is not None:
            self._buf.append(x)
            self._sorted = False
            if len(self._buf) >= self.threshold:
                self._spill()
        else:
            for est in self._estimators:
                est.add(x)

    def _spill(self) -> None:
        """Switch from exact to estimator mode, replaying the buffer so
        the estimators start from the full sample seen so far."""
        buf, self._buf = self._buf, None
        self._estimators = [P2Quantile(p / 100.0) for p in self.grid]
        for x in buf:
            for est in self._estimators:
                est.add(x)

    def quantile(self, p: float) -> Optional[float]:
        """The ``p``-th percentile (``p`` in percent, e.g. 50 / 99).

        Exact nearest-rank below the threshold; above it, the nearest
        grid estimator's P² value clamped to the observed range.  None
        with no observations."""
        if self.n == 0:
            return None
        if self._buf is not None:
            if not self._sorted:
                self._buf.sort()
                self._sorted = True
            return nearest_rank(self._buf, p)
        est = min(self._estimators, key=lambda e: abs(e.p * 100.0 - p))
        v = est.value()
        if v is None:
            return None
        return min(max(v, self._min), self._max)

    @property
    def min(self) -> Optional[float]:
        """Smallest observation (None with no observations)."""
        return self._min if self.n else None

    @property
    def max(self) -> Optional[float]:
        """Largest observation (None with no observations)."""
        return self._max if self.n else None
