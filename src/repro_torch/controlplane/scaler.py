"""SLO-driven autoscaling policy (Knative-style target concurrency).

Replaces the legacy queue-pressure rule (``core.autoscaler.Autoscaler``:
"scale out one node when queued events per slot exceed a threshold") with
two cooperating signals read from the telemetry snapshot:

* **target concurrency** — desired capacity units =
  ``ceil(outstanding / target_concurrency)``: enough units that each
  carries at most ``target_concurrency`` admitted-but-unfinished events.
  Unlike the queue-pressure rule this jumps straight to the demanded
  capacity in one tick (all provisioning delays overlap) instead of
  adding one node per check interval.
* **latency SLO guard** — while the windowed RLat p99 exceeds
  ``slo_rlat_p99_s``, demand at least one unit more than current
  capacity, even if concurrency math is satisfied (queues may be short
  while latency is still digesting a backlog).

Scale-down is conservative: one unit at a time, only after
``scale_down_cooldown`` consecutive calm ticks, never below
``min_units``.  The policy only *decides*; actuation goes through the
backend's :class:`~repro_torch.gateway.backends.CapacityHooks` (whole nodes on
the sim, dispatcher workers on the engine).

The port's copy of ``repro.controlplane.scaler`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.controlplane.telemetry import TelemetrySnapshot
from repro_torch.gateway.backends import CapacityHooks


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Scaling targets; ``None`` SLO disables the latency guard."""

    slo_rlat_p99_s: Optional[float] = None
    # admitted-but-unfinished events one capacity unit should carry
    target_concurrency: float = 2.0
    min_units: int = 1
    max_units: int = 8
    # consecutive calm ticks before one unit is released
    scale_down_cooldown: int = 6


class SLOScaler:
    """Per-tick consumer of telemetry snapshots driving capacity hooks."""

    def __init__(self, policy: Optional[SLOPolicy] = None):
        self.policy = policy or SLOPolicy()
        self._calm_ticks = 0
        self.decisions: List[tuple] = []    # (t, action, detail) audit log

    def desired_units(self, snap: TelemetrySnapshot) -> int:
        """The capacity the snapshot demands, before clamping."""
        p = self.policy
        want = math.ceil(snap.outstanding /
                         max(p.target_concurrency, 1e-9))
        if p.slo_rlat_p99_s is not None and snap.rlat_p99 is not None and \
                snap.rlat_p99 > p.slo_rlat_p99_s:
            want = max(want, snap.capacity + snap.pending_capacity + 1)
        return want

    def tick(self, snap: TelemetrySnapshot, hooks: CapacityHooks) -> None:
        """Reconcile capacity toward the snapshot's demand."""
        p = self.policy
        total = snap.capacity + snap.pending_capacity
        want = min(max(self.desired_units(snap), p.min_units), p.max_units)
        if want > total:
            self._calm_ticks = 0
            hooks.set_target(want)
            self.decisions.append(
                (snap.t, "scale-out", f"{total}->{want} "
                 f"(outstanding={snap.outstanding}, "
                 f"rlat_p99={snap.rlat_p99})"))
        elif want < snap.capacity and snap.capacity > p.min_units:
            self._calm_ticks += 1
            if self._calm_ticks >= p.scale_down_cooldown:
                self._calm_ticks = 0
                hooks.set_target(snap.capacity - 1)
                # only record a release that actually happened — on the
                # sim, unmanaged seed nodes are not drainable, so the
                # request may be a no-op (capacity drops immediately on
                # a real drain: the node stops being counted the moment
                # it starts draining)
                if hooks.capacity() < snap.capacity:
                    self.decisions.append(
                        (snap.t, "scale-in", f"{snap.capacity}->"
                         f"{hooks.capacity()}"))
        else:
            self._calm_ticks = 0
