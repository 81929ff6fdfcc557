"""Discrete-event virtual clock.

The paper's 14-minute phase workloads replay in milliseconds of wall time;
the same component code runs against :class:`WallClock` in real-execution
mode (examples / integration tests with actual PyTorch forwards).

The port's copy of ``repro.core.simclock`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable, Optional


class SimClock:
    """Deterministic discrete-event scheduler."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._heap: list = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    def call_at(self, t: float, fn: Callable[[], None]) -> None:
        if t < self._now:
            raise ValueError(f"cannot schedule in the past ({t} < {self._now})")
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def call_in(self, dt: float, fn: Callable[[], None]) -> None:
        self.call_at(self._now + dt, fn)

    def run(self, until: Optional[float] = None) -> None:
        """Process events in time order until the heap drains (or ``until``)."""
        while self._heap:
            t, _, fn = self._heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._heap)
            self._now = t
            fn()
        if until is not None and until > self._now:
            self._now = until

    def step(self) -> bool:
        """Process the single earliest scheduled event; False when idle.

        The workflow runner's fine-grained drive primitive: advance virtual
        time just far enough to observe a completion, so dependent steps can
        be submitted *at* the moment their inputs appear rather than after a
        whole-horizon drain.
        """
        if not self._heap:
            return False
        t, _, fn = heapq.heappop(self._heap)
        self._now = t
        fn()
        return True

    @property
    def pending(self) -> int:
        return len(self._heap)


class WallClock:
    """Real time; call_at busy-schedules via sorted sleep in run()."""

    def __init__(self):
        self._t0 = time.monotonic()
        self._heap: list = []
        self._seq = itertools.count()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def call_at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def call_in(self, dt: float, fn: Callable[[], None]) -> None:
        self.call_at(self.now() + dt, fn)

    def run(self, until: Optional[float] = None) -> None:
        while self._heap:
            t, _, fn = self._heap[0]
            if until is not None and t > until:
                break
            delay = t - self.now()
            if delay > 0:
                time.sleep(delay)
            heapq.heappop(self._heap)
            fn()

    @property
    def pending(self) -> int:
        return len(self._heap)
