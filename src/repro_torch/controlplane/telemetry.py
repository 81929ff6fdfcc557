"""Telemetry bus: rolling-window signals the control-plane policies read.

Samples come from two places — the backend's :class:`~repro_torch.core.metrics.
MetricsCollector` (settled invocations, read incrementally through the
``since()`` cursor) and live backend state through
:class:`~repro_torch.gateway.backends.CapacityHooks` (queue depth, in-flight
count, capacity).  Arrivals are observed at admission time, so rates are
*offered* load, not served load.

One :meth:`TelemetryBus.sample` call produces a :class:`TelemetrySnapshot`
— per-runtime rolling windows (arrival rate + EWMA, queue depth, RLat/ELat
percentiles, cold-start ratio) plus the aggregate — which the scaler,
warm-pool manager, and any dashboard consume without touching backend
internals.

The port's copy of ``repro.controlplane.telemetry`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.core.events import Invocation
from repro_torch.core.metrics import MetricsCollector
from repro_torch.gateway.backends import CapacityHooks


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Window geometry for the bus."""

    window_s: float = 30.0      # rolling window for rates/percentiles
    ewma_alpha: float = 0.3     # per-sample smoothing of the arrival rate
    history_max: int = 2048     # snapshots retained (a long-running
    #                             engine plane must not grow unbounded)


@dataclasses.dataclass
class RuntimeStats:
    """One runtime's rolling-window view at a sample instant."""

    runtime_id: str
    arrival_rate: float         # offered events/s over the window
    ewma_rate: float            # smoothed arrival rate (prewarm predictor)
    queue_depth: int            # admitted, waiting
    n_completed: int            # settled in the window
    rlat_p50: Optional[float]
    rlat_p99: Optional[float]
    elat_p50: Optional[float]
    cold_ratio: float           # cold starts / successes in the window
    failure_rate: float         # failed (not shed) settlements/s in window


@dataclasses.dataclass
class TelemetrySnapshot:
    """The whole platform's rolling-window view at a sample instant."""

    t: float
    capacity: int               # backend capacity units (live)
    pending_capacity: int       # units being provisioned
    queue_depth: int
    inflight: int
    arrival_rate: float         # aggregate offered events/s
    rlat_p99: Optional[float]   # aggregate over the window
    cold_ratio: float           # aggregate over the window
    # failed (not shed) settlements/s over the window — lost deliveries
    # and execution failures; the scaler's capacity math must not treat a
    # failure-churning platform as healthy throughput
    failure_rate: float = 0.0
    per_runtime: Dict[str, RuntimeStats] = dataclasses.field(
        default_factory=dict)

    @property
    def outstanding(self) -> int:
        """Admitted-but-unfinished events (queued + executing) — the
        concurrency signal the SLO scaler divides by capacity."""
        return self.queue_depth + self.inflight


class TelemetryBus:
    """Incremental sampler over the metrics collector + live backend state.

    ``observe_arrival`` is called by the control plane at admission for
    every submitted event (shed or not); ``sample`` prunes the rolling
    windows and derives per-runtime and aggregate stats.  All state is
    owned by the attached control plane's lock — the bus itself is not
    thread-safe.
    """

    def __init__(self, metrics: MetricsCollector,
                 cfg: Optional[TelemetryConfig] = None):
        self.metrics = metrics
        self.cfg = cfg or TelemetryConfig()
        self._arrivals: Dict[str, Deque[float]] = {}
        self._ewma: Dict[str, float] = {}
        self._completed: Dict[str, Deque[Invocation]] = {}
        self._cursor = 0            # monotone metrics.n_recorded watermark
        self.history: Deque[TelemetrySnapshot] = deque(
            maxlen=self.cfg.history_max)

    # ------------------------------------------------------------------
    def observe_arrival(self, inv: Invocation, now: float) -> None:
        """Record one offered event at admission time."""
        self._arrivals.setdefault(inv.runtime_id, deque()).append(now)

    # ------------------------------------------------------------------
    def _ingest(self) -> None:
        """Pull completions recorded since the last sample into the
        per-runtime windows (append-only cursor; shed events included —
        their latency fields are degenerate but their counts matter)."""
        fresh = self.metrics.since(self._cursor)
        self._cursor = self.metrics.n_recorded
        for inv in fresh:
            self._completed.setdefault(inv.runtime_id, deque()).append(inv)

    def _prune(self, now: float) -> None:
        horizon = now - self.cfg.window_s
        for q in self._arrivals.values():
            while q and q[0] < horizon:
                q.popleft()
        for q in self._completed.values():
            while q and (q[0].r_end or 0.0) < horizon:
                q.popleft()

    def _pct(self, values: List[float], p: float) -> Optional[float]:
        return self.metrics.percentile(values, p)   # shared nearest-rank

    def sample(self, now: float, hooks: CapacityHooks) -> TelemetrySnapshot:
        """Derive one snapshot at ``now`` (called from the plane's tick)."""
        self._ingest()
        self._prune(now)
        window = max(self.cfg.window_s, 1e-9)
        backlog = hooks.backlog_by_runtime()
        per: Dict[str, RuntimeStats] = {}
        all_rl: List[float] = []
        total_rate = 0.0
        agg_cold = agg_ok = agg_failed = 0
        rids = set(self._arrivals) | set(self._completed) | set(backlog)
        for rid in sorted(rids):
            rate = len(self._arrivals.get(rid, ())) / window
            ewma = self.cfg.ewma_alpha * rate + \
                (1.0 - self.cfg.ewma_alpha) * self._ewma.get(rid, rate)
            self._ewma[rid] = ewma
            done = [i for i in self._completed.get(rid, ()) if i.success]
            failed = sum(1 for i in self._completed.get(rid, ())
                         if not i.success and not i.rejected)
            rl = [i.rlat for i in done if i.rlat is not None]
            el = [i.elat for i in done if i.elat is not None]
            cold = sum(1 for i in done if i.cold_start)
            all_rl.extend(rl)
            total_rate += rate
            agg_cold += cold
            agg_ok += len(done)
            agg_failed += failed
            per[rid] = RuntimeStats(
                runtime_id=rid, arrival_rate=rate, ewma_rate=ewma,
                queue_depth=backlog.get(rid, 0), n_completed=len(done),
                rlat_p50=self._pct(rl, 50), rlat_p99=self._pct(rl, 99),
                elat_p50=self._pct(el, 50),
                cold_ratio=cold / len(done) if done else 0.0,
                failure_rate=failed / window)
        snap = TelemetrySnapshot(
            t=now, capacity=hooks.capacity(), pending_capacity=hooks.pending(),
            queue_depth=hooks.queue_depth(), inflight=hooks.inflight(),
            arrival_rate=total_rate, rlat_p99=self._pct(all_rl, 99),
            cold_ratio=agg_cold / agg_ok if agg_ok else 0.0,
            failure_rate=agg_failed / window,
            per_runtime=per)
        self.history.append(snap)
        return snap
