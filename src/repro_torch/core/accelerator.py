"""Accelerator inventory (§IV-D: "Every node manager has a list of all
accelerators available to it ... type, locally unique ID, and information
necessary to schedule and balance").

An accelerator is anything a runtime instance can be pinned to: a discrete
GPU, a VPU stick, or — in the TPU adaptation — a pod mesh *slice*.

The port's copy of ``repro.core.accelerator`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, FrozenSet, List, Set

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    """Type-level description; nodes instantiate Accelerator per device."""
    type: str                      # e.g. "gpu-k600", "vpu-ncs", "v5e-4x4"
    slots: int = 1                 # concurrent runtime instances (paper: 2/GPU)
    mem_bytes: int = 2 << 30
    cost_per_hour: float = 1.0     # for the cost-aware policy (beyond paper)
    # TPU adaptation: mesh-slice geometry (chips) — 0 for discrete devices
    chips: int = 0
    # energy model (per-type): the device draws idle_watts whenever it is
    # provisioned and active_watts while executing, so one invocation costs
    # ``active_watts × ELat`` joules (the objective schedulers and the
    # MetricsCollector's energy counters both price with these)
    idle_watts: float = 0.0
    active_watts: float = 0.0

    def invocation_joules(self, busy_s: float) -> float:
        """Energy of one invocation that kept the device active ``busy_s``
        seconds (measured ELat + any cold start it absorbed)."""
        return self.active_watts * max(busy_s, 0.0)

    def invocation_dollars(self, busy_s: float) -> float:
        """Accelerator-seconds cost of one invocation at this type's rate."""
        return max(busy_s, 0.0) * self.cost_per_hour / 3600.0


@dataclasses.dataclass
class Accelerator:
    spec: AcceleratorSpec
    local_id: str                  # locally unique ID on the node
    busy_slots: int = 0
    # warm runtime instances resident on this accelerator: runtime_key -> t_idle
    warm: Dict[str, float] = dataclasses.field(default_factory=dict)
    # keys whose resident instance was installed by a control-plane prewarm
    # and has not served an event yet (consumed for cold-start attribution)
    prewarmed: Set[str] = dataclasses.field(default_factory=set)
    total_busy_time: float = 0.0   # for utilization accounting
    n_executions: int = 0
    # mark_warm calls that could not evict down to max_warm because every
    # other resident key was pinned (min-warm floors exceed the budget)
    n_pin_overflows: int = 0

    @property
    def free_slots(self) -> int:
        return self.spec.slots - self.busy_slots

    def has_warm(self, runtime_key: str) -> bool:
        return runtime_key in self.warm

    def acquire(self) -> None:
        assert self.busy_slots < self.spec.slots
        self.busy_slots += 1

    def release(self) -> None:
        assert self.busy_slots > 0
        self.busy_slots -= 1

    def mark_warm(self, runtime_key: str, now: float, max_warm: int = 4,
                  pinned: FrozenSet[str] = frozenset()) -> List[str]:
        """Register a warm instance; returns the keys evicted (LRU-first)
        to get back within the ``max_warm`` memory budget.  ``pinned``
        keys (control-plane min-warm floors) are never eviction victims;
        when pins alone exceed the budget, the overflow is surfaced
        (``n_pin_overflows`` counter + warning log) instead of silently
        growing the warm set without bound."""
        self.warm[runtime_key] = now
        evicted: List[str] = []
        while len(self.warm) > max_warm:
            victims = [k for k in self.warm
                       if k != runtime_key and k not in pinned]
            if not victims:
                self.n_pin_overflows += 1
                log.warning(
                    "%s: warm set (%d) exceeds max_warm=%d but every other "
                    "resident key is pinned — min-warm floors exceed the "
                    "memory budget", self.local_id, len(self.warm), max_warm)
                break
            lru = min(victims, key=self.warm.get)
            del self.warm[lru]
            self.prewarmed.discard(lru)
            evicted.append(lru)
        return evicted

    def evict(self, runtime_key: str) -> None:
        self.warm.pop(runtime_key, None)
        self.prewarmed.discard(runtime_key)
