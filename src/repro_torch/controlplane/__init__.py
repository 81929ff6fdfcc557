"""Serverless control plane: SLO-driven autoscaling, warm-pool /
cold-start management, and per-tenant admission over any gateway backend
(sim cluster or engine dispatcher) — the port's copy of
``repro.controlplane`` (``docs/controlplane.md`` describes both)."""
from repro_torch.controlplane.admission import (AdmissionController,
                                                AdmissionPolicy, TokenBucket)
from repro_torch.controlplane.plane import (ControlPlane, ControlPlaneConfig,
                                            build_control_plane)
from repro_torch.controlplane.scaler import SLOPolicy, SLOScaler
from repro_torch.controlplane.telemetry import (RuntimeStats, TelemetryBus,
                                                TelemetryConfig,
                                                TelemetrySnapshot)
from repro_torch.controlplane.warmpool import WarmPolicy, WarmPoolManager

__all__ = ["AdmissionController", "AdmissionPolicy", "TokenBucket",
           "ControlPlane", "ControlPlaneConfig", "build_control_plane",
           "SLOPolicy", "SLOScaler",
           "RuntimeStats", "TelemetryBus", "TelemetryConfig",
           "TelemetrySnapshot", "WarmPolicy", "WarmPoolManager"]
