"""The control plane: one policy layer attached to any gateway backend.

``ControlPlane`` wires the four cooperating pieces — telemetry bus, SLO
scaler, warm-pool manager, admission controller — onto a backend through
two seams:

* ``Backend.capacity_hooks()`` — the actuation/observation surface
  (whole nodes on the sim, dispatcher workers on the engine), and
* ``Backend.controller`` — the admission gate ``submit()`` consults for
  every event (which doubles as the telemetry arrival tap).

The same :class:`ControlPlaneConfig` drives both backends: build one
plane per backend from a shared config and identical policies apply to
the calibrated simulation and to real execution.

Driving model: the plane *ticks* every ``tick_interval_s``.  On the sim
the tick is a clock callback (virtual time, deterministic); on the
engine it is a daemon thread (wall time).  Each tick samples telemetry,
then lets the scaler and warm-pool manager act through the hooks.

    cfg = ControlPlaneConfig(slo=SLOPolicy(slo_rlat_p99_s=30.0),
                             warm=WarmPolicy(min_warm={"serve-x": 1}),
                             admission=AdmissionPolicy(
                                 tenant_quotas={"free": (2.0, 4.0)}))
    plane = ControlPlane(cfg).attach(backend)
    plane.start()
    ... submit through the gateway as usual ...
    plane.stop()

The port's copy of ``repro.controlplane.plane`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from repro_torch.controlplane.admission import AdmissionController, AdmissionPolicy
from repro_torch.controlplane.scaler import SLOPolicy, SLOScaler
from repro_torch.controlplane.telemetry import (TelemetryBus, TelemetryConfig,
                                          TelemetrySnapshot)
from repro_torch.controlplane.warmpool import WarmPolicy, WarmPoolManager
from repro_torch.core.events import Invocation
from repro_torch.gateway.backends import Backend, SimCapacityHooks
from repro_torch.obs import TRACER


@dataclasses.dataclass(frozen=True)
class ControlPlaneConfig:
    """One shared config; every policy is optional (None = that piece
    idles, the backend's native behavior stands)."""

    tick_interval_s: float = 1.0
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    slo: Optional[SLOPolicy] = None
    warm: Optional[WarmPolicy] = None
    admission: Optional[AdmissionPolicy] = None
    # placement objective forwarded to the backend's capacity hooks:
    # "latency" (default), "cost", or "energy" — on a heterogeneous sim
    # fleet, scale-out and prewarm spend capacity on the cheapest /
    # most-frugal accelerator type that still holds the SLO
    objective: str = "latency"


class ControlPlane:
    """SLO autoscaling + warm-pool policy + admission over one backend."""

    def __init__(self, cfg: Optional[ControlPlaneConfig] = None):
        self.cfg = cfg or ControlPlaneConfig()
        self.backend: Optional[Backend] = None
        self.hooks = None
        self.telemetry: Optional[TelemetryBus] = None
        self.scaler = SLOScaler(self.cfg.slo) if self.cfg.slo else None
        self.warmpool: Optional[WarmPoolManager] = None
        self.admission = AdmissionController(self.cfg.admission) \
            if self.cfg.admission else None
        self.n_ticks = 0
        self._lock = threading.RLock()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- wiring ----------------------------------------------------------
    def attach(self, backend: Backend, **hook_kwargs) -> "ControlPlane":
        """Bind to ``backend``: build its capacity hooks (``hook_kwargs``
        forwarded — e.g. the sim's node template ``spec``), install this
        plane as the backend's admission controller, and construct the
        telemetry bus over its metrics collector.  Returns ``self``."""
        if self.backend is not None:
            raise RuntimeError("control plane already attached; build one "
                               "plane per backend (configs are shareable, "
                               "planes are not)")
        self.backend = backend
        hook_kwargs.setdefault("objective", self.cfg.objective)
        self.hooks = backend.capacity_hooks(**hook_kwargs)
        self.telemetry = TelemetryBus(backend.metrics, self.cfg.telemetry)
        if self.cfg.warm is not None:
            self.warmpool = WarmPoolManager(self.cfg.warm, backend.registry)
        backend.controller = self
        return self

    def detach(self) -> None:
        """Stop ticking and unhook from the backend."""
        self.stop()
        if self.backend is not None:
            self.backend.controller = None

    # -- admission tap (called by Backend.submit for every event) --------
    def admit(self, inv: Invocation, now: float) -> Optional[str]:
        """None to admit; otherwise the shed reason.  Every arrival —
        admitted or shed — feeds the telemetry windows."""
        with self._lock:
            self.telemetry.observe_arrival(inv, now)
            reason = None if self.admission is None else \
                self.admission.admit(inv, now, self.hooks)
        if TRACER.enabled and inv.trace_id is not None:
            # zero-width instant: the admission decision, same span on
            # every backend (the plane is the shared admission tap)
            root = inv.span_id or f"inv{inv.inv_id}"
            TRACER.instant(
                "admission", now, trace=inv.trace_id, parent=root,
                span_id=f"{root}/a{inv.attempt}/admission",
                status="rejected" if reason is not None else "ok",
                attrs={"runtime": inv.runtime_id, "tenant": inv.tenant,
                       **({"reason": reason} if reason else {})})
        return reason

    # -- driving ---------------------------------------------------------
    def start(self) -> None:
        """Begin ticking: a clock callback on the sim (virtual time), a
        daemon thread on the engine (wall time).  Idempotent."""
        if self.backend is None:
            raise RuntimeError("attach() a backend before start()")
        if self._running:
            return
        self._running = True
        if self.backend.autonomous:
            self._thread = threading.Thread(
                target=self._run_wall, name="controlplane", daemon=True)
            self._thread.start()
        else:
            clock = self.backend.cluster.clock
            clock.call_in(0.0, self._tick_sim)

    def stop(self) -> None:
        """Stop ticking (attached state and audit logs survive)."""
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _tick_sim(self) -> None:
        if not self._running:
            return
        self.tick()
        self.backend.cluster.clock.call_in(
            self.cfg.tick_interval_s, self._tick_sim)

    def _run_wall(self) -> None:
        import time
        while self._running:
            self.tick()
            time.sleep(self.cfg.tick_interval_s)

    def tick(self) -> TelemetrySnapshot:
        """One control cycle: sample telemetry, then scale and manage the
        warm pool through the hooks.  Safe to call manually (tests drive
        deterministic single ticks this way)."""
        with self._lock:
            now = self.backend.now()
            if isinstance(self.hooks, SimCapacityHooks):
                for fleet in self.hooks.fleets:
                    fleet.account()             # node-seconds cost integral
            snap = self.telemetry.sample(now, self.hooks)
            if self.scaler is not None:
                if hasattr(self.hooks, "note_slo"):
                    # SLO health gates the objective: cost/energy choose
                    # the frugal type only while the SLO holds
                    slo = self.scaler.policy.slo_rlat_p99_s
                    self.hooks.note_slo(
                        slo is None or snap.rlat_p99 is None
                        or snap.rlat_p99 <= slo)
                self.scaler.tick(snap, self.hooks)
            self.n_ticks += 1
        # the warm-pool pass runs OUTSIDE the plane lock: an engine
        # prewarm executes rdef.setup() (seconds of jit + weights), and
        # submit() must keep flowing through admit() — which takes this
        # lock — the whole time ("off the critical path" includes other
        # events' admission).  Only the tick loop calls this, so the
        # manager's own state needs no lock.
        if self.warmpool is not None:
            self.warmpool.tick(snap, self.hooks)
        return snap

    # -- introspection ---------------------------------------------------
    @property
    def last_snapshot(self) -> Optional[TelemetrySnapshot]:
        """The most recent telemetry snapshot (None before the first tick)."""
        return self.telemetry.history[-1] if self.telemetry and \
            self.telemetry.history else None

    def events(self) -> List[tuple]:
        """Merged audit log: scaler decisions + warm-pool actions +
        admission sheds, time-ordered."""
        out: List[tuple] = []
        if self.scaler is not None:
            out.extend(self.scaler.decisions)
        if self.warmpool is not None:
            out.extend(self.warmpool.actions)
        if self.admission is not None:
            out.extend((t, "shed", f"{tenant}/{rid}: {reason}")
                       for t, tenant, rid, reason in self.admission.sheds)
        return sorted(out, key=lambda e: e[0])

    def summary(self) -> Dict[str, float]:
        """Counts of everything the plane did (bench/CLI reporting)."""
        shed = sum(self.admission.shed_counts.values()) \
            if self.admission else 0
        return {
            "ticks": self.n_ticks,
            "scale_outs": sum(1 for d in (self.scaler.decisions
                                          if self.scaler else [])
                              if d[1] == "scale-out"),
            "scale_ins": sum(1 for d in (self.scaler.decisions
                                         if self.scaler else [])
                             if d[1] == "scale-in"),
            "prewarms": sum(1 for a in (self.warmpool.actions
                                        if self.warmpool else [])
                            if a[1].startswith("prewarm")),
            "ttl_evictions": sum(1 for a in (self.warmpool.actions
                                             if self.warmpool else [])
                                 if a[1] == "ttl-evict"),
            "shed": shed,
        }


def build_control_plane(backend: Backend,
                        cfg: Optional[ControlPlaneConfig] = None,
                        start: bool = True,
                        **hook_kwargs) -> ControlPlane:
    """Convenience: construct, attach, and (by default) start a plane."""
    plane = ControlPlane(cfg).attach(backend, **hook_kwargs)
    if start:
        plane.start()
    return plane
