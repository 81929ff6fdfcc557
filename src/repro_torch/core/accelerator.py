"""Accelerator inventory (§IV-D: "Every node manager has a list of all
accelerators available to it ... type, locally unique ID, and information
necessary to schedule and balance").

An accelerator is anything a runtime instance can be pinned to: a discrete
GPU, a VPU stick, or — in the TPU adaptation — a pod mesh *slice*.

The port's copy of ``repro.core.accelerator`` (the port imports nothing of
``repro``): the type-level :class:`AcceleratorSpec` that prices invocations
in the metrics collector. The per-device ``Accelerator`` a node manager
keeps comes with the cluster's port.
"""
from __future__ import annotations

import dataclasses


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
