"""Warm-pool management: keep-alive TTLs, min-warm floors, predictive
prewarming.

The backends already keep *implicit* warm pools (the sim's per-accelerator
LRU with a global idle timeout, the engine's ``setup()``-handle LRU).
This manager makes warmth **policy**:

* **min-warm floors** — every runtime with ``min_warm >= 1`` always has
  that many instances resident; they are prewarmed off the critical path
  at attach (the paper's cold start — process spawn + model load on the
  sim, jit + weights on the engine — happens before the first event) and
  *pinned* so neither LRU pressure nor idle timeouts evict them.  The
  first invocation a prewarmed instance serves reports
  ``Invocation.prewarmed`` — cold-start avoidance is attributable to
  policy rather than LRU luck.
* **keep-alive TTLs** — per-runtime idle lifetimes (Carl et al. 2025's
  energy argument: idle accelerator instances are not free).  Instances
  idle past their TTL are evicted even if the backend's own limits would
  have kept them.
* **predictive prewarming** — when a runtime's EWMA arrival rate exceeds
  ``prewarm_rate_threshold`` and nothing is warm, one instance is
  prewarmed so a coming burst doesn't pay the cold start in-band.

Per-runtime knobs default from ``RuntimeDef.min_warm`` /
``RuntimeDef.keep_alive_s``; the policy maps override them.

The port's copy of ``repro.controlplane.warmpool`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set

from repro_torch.controlplane.telemetry import TelemetrySnapshot
from repro_torch.core.events import runtime_key_for
from repro_torch.core.runtime import RuntimeRegistry
from repro_torch.gateway.backends import CapacityHooks


@dataclasses.dataclass(frozen=True)
class WarmPolicy:
    """Warm-pool targets (maps keyed by ``runtime_id``)."""

    min_warm: Optional[Dict[str, int]] = None
    keep_alive_s: Optional[Dict[str, float]] = None
    default_keep_alive_s: float = 60.0
    # run config the floor instances are prewarmed under (warm identity
    # is runtime + config); default {} = the runtime's bare key
    prewarm_config: Optional[Dict[str, Dict[str, Any]]] = None
    # EWMA events/s above which an idle runtime gets one predictive
    # prewarm (0 disables prediction)
    prewarm_rate_threshold: float = 0.0


class WarmPoolManager:
    """Per-tick floors/TTL/prediction over the backend's warm pool."""

    def __init__(self, policy: Optional[WarmPolicy] = None,
                 registry: Optional[RuntimeRegistry] = None):
        self.policy = policy or WarmPolicy()
        self.registry = registry
        self.actions: List[tuple] = []      # (t, action, detail) audit log

    # ------------------------------------------------------------------
    def _floors(self) -> Dict[str, int]:
        floors = dict(self.policy.min_warm or {})
        if self.registry is not None:
            for rid in self.registry.ids():
                rdef = self.registry.get(rid)
                if rdef.min_warm and rid not in floors:
                    floors[rid] = rdef.min_warm
        return floors

    def _ttl(self, runtime_id: str) -> float:
        ttl = (self.policy.keep_alive_s or {}).get(runtime_id)
        if ttl is None and self.registry is not None and \
                runtime_id in self.registry:
            ttl = self.registry.get(runtime_id).keep_alive_s
        return self.policy.default_keep_alive_s if ttl is None else ttl

    def _key(self, runtime_id: str) -> str:
        cfg = (self.policy.prewarm_config or {}).get(runtime_id)
        return runtime_key_for(runtime_id, cfg)

    def pinned_keys(self) -> Set[str]:
        """Warm identities the floors protect from eviction."""
        return {self._key(rid) for rid, n in self._floors().items() if n > 0}

    # ------------------------------------------------------------------
    def tick(self, snap: TelemetrySnapshot, hooks: CapacityHooks) -> None:
        """Enforce floors, expire TTLs, and predictively prewarm."""
        floors = self._floors()
        hooks.pin(self.pinned_keys())

        # min-warm floors: prewarm up to the floor.  Each prewarm call
        # installs at most one instance, and a backend may not be able to
        # reach the floor at all (the engine holds ONE handle per key, so
        # floors above 1 saturate there) — stop as soon as a call stops
        # raising the count, or the loop would spin forever.
        for rid, floor in floors.items():
            cfg = (self.policy.prewarm_config or {}).get(rid)
            key = self._key(rid)
            count = hooks.warm_count(key)
            while count < floor:
                if not hooks.prewarm(rid, cfg):
                    break
                now_count = hooks.warm_count(key)
                if now_count <= count:
                    break               # backend saturated for this key
                count = now_count
                self.actions.append((snap.t, "prewarm-floor", rid))

        # keep-alive TTLs: evict idle instances past their lifetime
        pinned = self.pinned_keys()
        for key, idle_s in hooks.warm_state().items():
            if key in pinned:
                continue
            rid = key.split("|", 1)[0]
            if idle_s > self._ttl(rid):
                if hooks.evict(key):
                    self.actions.append((snap.t, "ttl-evict", key))

        # predictive prewarming from the arrival-rate EWMA
        thr = self.policy.prewarm_rate_threshold
        if thr > 0:
            for rid, stats in snap.per_runtime.items():
                key = self._key(rid)
                if stats.ewma_rate >= thr and hooks.warm_count(key) == 0:
                    if hooks.prewarm(
                            rid, (self.policy.prewarm_config or {}).get(rid)):
                        self.actions.append(
                            (snap.t, "prewarm-predicted", rid))
