"""Measurement collection (§V-A).

Per-invocation timestamps RStart/NStart/EStart/EEnd/NEnd/REnd plus derived
RLat / ELat / DLat / RSuccess and RFast (moving average of successful
completions over the trailing 10 s window), and #queued timelines.

**Streaming aggregation.**  Summaries no longer walk the full completion
history: counters and latency sketches (:class:`~repro_torch.core.quantiles.
QuantileSketch`) are folded in at ``record()`` time — overall, per
runtime, and per tenant — so ``summary()`` / ``per_runtime()`` /
``per_tenant()`` are O(distinct keys) at any event count.  Percentiles
are **exact** (nearest-rank, unchanged values) below the sketch
threshold and bounded-memory approximate above it; ``n_recorded`` is the
monotone completion counter incremental consumers (telemetry cursors,
backlog accounting) should use instead of ``len(completed)``.

The raw record list ``completed`` is still kept for window queries and
analysis; pass ``history_max`` to bound it (oldest records are dropped,
``since()`` index math stays correct via an internal offset).

The port's copy of ``repro.core.metrics`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import bisect
import math
import statistics
from typing import Dict, List, Optional, Tuple

from repro_torch.core.accelerator import AcceleratorSpec
from repro_torch.core.events import Invocation
from repro_torch.core.quantiles import QuantileSketch

RFAST_WINDOW_S = 10.0


def acc_type_of(accelerator: Optional[str]) -> Optional[str]:
    """Accelerator *type* out of an invocation's placement string — every
    backend formats it ``<local id>(<type>)`` (e.g. ``n0/acc1(gpu-k600)``,
    ``local/w0(host-cuda)``, ``w2/pid814(host-cuda)``); None when untyped."""
    if not accelerator or not accelerator.endswith(")"):
        return None
    idx = accelerator.rfind("(")
    return accelerator[idx + 1:-1] if idx >= 0 else None


def escape_label_value(value: str) -> str:
    """Escape a Prometheus exposition-format label value: backslash,
    double-quote, and newline must be escaped or the scrape misparses
    (https://prometheus.io/docs/instrumenting/exposition_formats/)."""
    return str(value).replace("\\", "\\\\") \
                     .replace('"', '\\"') \
                     .replace("\n", "\\n")


class _StatBucket:
    """Incrementally-maintained counters + latency sketches for one
    aggregation key (overall / one runtime / one tenant)."""

    __slots__ = ("n_completed", "r_success", "cold_starts", "prewarmed",
                 "rejected", "failed", "retried", "retries_exhausted",
                 "rlat", "elat", "rlat_max")

    def __init__(self, sketch_threshold: int):
        self.n_completed = 0
        self.r_success = 0
        self.cold_starts = 0
        self.prewarmed = 0
        self.rejected = 0
        self.failed = 0
        self.retried = 0
        self.retries_exhausted = 0
        self.rlat = QuantileSketch(threshold=sketch_threshold)
        self.elat = QuantileSketch(threshold=sketch_threshold)
        self.rlat_max = 0.0

    def fold(self, inv: Invocation) -> None:
        self.n_completed += 1
        self.retried += inv.attempt
        if inv.cold_start:
            self.cold_starts += 1
        if inv.prewarmed:
            self.prewarmed += 1
        if inv.rejected:
            self.rejected += 1
        if inv.retries_exhausted:
            self.retries_exhausted += 1
        if inv.success:
            self.r_success += 1
            if inv.rlat is not None:
                self.rlat.add(inv.rlat)
                if inv.rlat > self.rlat_max:
                    self.rlat_max = inv.rlat
            if inv.elat is not None:
                self.elat.add(inv.elat)
        elif not inv.rejected:
            self.failed += 1

    def row(self) -> Dict[str, float]:
        return {
            "n_completed": self.n_completed,
            "r_success": self.r_success,
            "rlat_p50": self.rlat.quantile(50) or 0.0,
            "rlat_p99": self.rlat.quantile(99) or 0.0,
            "elat_p50": self.elat.quantile(50) or 0.0,
            "cold_starts": self.cold_starts,
            "prewarmed": self.prewarmed,
            "rejected": self.rejected,
            "failed": self.failed,
            "retried": self.retried,
            "retries_exhausted": self.retries_exhausted,
        }


class MetricsCollector:
    def __init__(self, history_max: Optional[int] = None,
                 sketch_threshold: Optional[int] = None):
        self.completed: List[Invocation] = []
        self.history_max = history_max
        self._dropped = 0           # records trimmed off the front
        self.n_recorded = 0         # monotone completion counter
        threshold = sketch_threshold if sketch_threshold is not None \
            else QuantileSketch().threshold
        self._sketch_threshold = threshold
        self._overall = _StatBucket(threshold)
        self._per_runtime: Dict[str, _StatBucket] = {}
        self._per_tenant: Dict[str, Dict[str, int]] = {}
        # successful-completion REnd stream for RFast (kept sorted lazily;
        # sim records arrive in virtual-time order so sorting is a no-op)
        self._success_ends: List[float] = []
        self._ends_sorted = True
        # span-duration summaries fed by the tracer (repro_torch.obs):
        # (runtime_id, span name) -> [count, total seconds, max seconds]
        self._span_durations: Dict[Tuple[str, str], List[float]] = {}
        # per-accelerator-type cost/energy accounting: the backend that
        # owns the fleet registers each type's pricing (cost_per_hour +
        # idle/active watts); record() folds every successful invocation's
        # measured ELat into dollars and joules for its type
        self._acc_pricing: Dict[str, AcceleratorSpec] = {}
        self._acc_usage: Dict[str, Dict[str, float]] = {}
        self.n_locality_hits = 0    # inputs read from a resident copy

    # -- accelerator pricing (cost/energy model) ------------------------
    def register_accelerator(self, spec: AcceleratorSpec) -> None:
        """Declare one accelerator type's cost/energy model.  Types that
        execute without registration still accumulate busy seconds and
        invocation counts, priced at zero."""
        self._acc_pricing[spec.type] = spec

    def _fold_accelerator(self, inv: Invocation) -> None:
        acc_type = acc_type_of(inv.accelerator)
        if acc_type is None or inv.elat is None:
            return
        row = self._acc_usage.get(acc_type)
        if row is None:
            row = self._acc_usage[acc_type] = {
                "n_invocations": 0.0, "busy_s": 0.0,
                "cost_dollars": 0.0, "energy_joules": 0.0,
                "locality_hits": 0.0}
        busy = max(inv.elat, 0.0)
        spec = self._acc_pricing.get(acc_type)
        row["n_invocations"] += 1
        row["busy_s"] += busy
        if spec is not None:
            row["cost_dollars"] += busy * spec.cost_per_hour / 3600.0
            row["energy_joules"] += spec.active_watts * busy
        if inv.locality_hit:
            row["locality_hits"] += 1

    def accelerator_usage(self) -> Dict[str, Dict[str, float]]:
        """Per-accelerator-type invocation count, busy seconds, dollars
        and joules (joules-per-invocation derive from measured ELat ×
        the registered active watts)."""
        return {t: dict(self._acc_usage[t])
                for t in sorted(self._acc_usage)}

    def total_cost_dollars(self) -> float:
        return sum(r["cost_dollars"] for r in self._acc_usage.values())

    def total_energy_joules(self) -> float:
        return sum(r["energy_joules"] for r in self._acc_usage.values())

    def record(self, inv: Invocation) -> None:
        assert inv.check_monotone(), f"non-monotone timestamps: {inv}"
        self.completed.append(inv)
        self.n_recorded += 1
        self._overall.fold(inv)
        bucket = self._per_runtime.get(inv.runtime_id)
        if bucket is None:
            bucket = self._per_runtime[inv.runtime_id] = \
                _StatBucket(self._sketch_threshold)
        bucket.fold(inv)
        trow = self._per_tenant.get(inv.tenant)
        if trow is None:
            trow = self._per_tenant[inv.tenant] = {
                "n_completed": 0, "r_success": 0, "rejected": 0}
        trow["n_completed"] += 1
        if inv.success:
            trow["r_success"] += 1
        if inv.rejected:
            trow["rejected"] += 1
        if inv.locality_hit:
            self.n_locality_hits += 1
        if inv.success:
            self._fold_accelerator(inv)
        if inv.success and inv.r_end is not None:
            if self._success_ends and inv.r_end < self._success_ends[-1]:
                self._ends_sorted = False
            self._success_ends.append(inv.r_end)
        if self.history_max is not None and \
                len(self.completed) > 2 * self.history_max:
            trim = len(self.completed) - self.history_max
            del self.completed[:trim]
            self._dropped += trim

    def observe_span(self, runtime_id: str, span: str,
                     duration_s: float) -> None:
        """Fold one closed trace span into the per-runtime duration
        summaries (called by an enabled :class:`repro_torch.obs.Tracer`)."""
        row = self._span_durations.get((runtime_id, span))
        if row is None:
            self._span_durations[(runtime_id, span)] = \
                [1, duration_s, duration_s]
        else:
            row[0] += 1
            row[1] += duration_s
            if duration_s > row[2]:
                row[2] = duration_s

    def span_durations(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """``{runtime: {span: {count, total_s, mean_s, max_s}}}`` — where
        each runtime's invocations spend their time, by trace span."""
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for (rid, span), (n, total, mx) in sorted(
                self._span_durations.items()):
            out.setdefault(rid, {})[span] = {
                "count": n, "total_s": total,
                "mean_s": total / n if n else 0.0, "max_s": mx}
        return out

    # ------------------------------------------------------------------
    @property
    def successes(self) -> List[Invocation]:
        return [i for i in self.completed if i.success]

    def r_success(self) -> int:
        return self._overall.r_success

    def rlats(self) -> List[float]:
        return sorted(i.rlat for i in self.successes if i.rlat is not None)

    def elats(self, accelerator_substr: str = "") -> List[float]:
        return sorted(i.elat for i in self.successes
                      if i.elat is not None and
                      accelerator_substr in (i.accelerator or ""))

    def median_elat(self, accelerator_substr: str = "") -> Optional[float]:
        e = self.elats(accelerator_substr)
        return statistics.median(e) if e else None

    def percentile(self, values: List[float], p: float) -> Optional[float]:
        """Nearest-rank percentile: the smallest value with at least
        ``p``% of the sample at or below it (so p50 of ``[1, 2]`` is 1,
        not 2 — rank ``ceil(p/100*n)``, clamped to the sample)."""
        if not values:
            return None
        values = sorted(values)
        idx = max(math.ceil(p / 100.0 * len(values)) - 1, 0)
        return values[min(idx, len(values) - 1)]

    # -- window queries (the control plane's telemetry source) ----------
    def window(self, t0: float, t1: Optional[float] = None,
               runtime_id: Optional[str] = None) -> List[Invocation]:
        """Completed invocations whose REnd falls in ``[t0, t1]``
        (``t1=None`` = no upper bound), optionally for one runtime.
        Empty windows are empty lists, never an error.  Only retained
        history is visible when ``history_max`` is set."""
        return [i for i in self.completed
                if i.r_end is not None and i.r_end >= t0
                and (t1 is None or i.r_end <= t1)
                and (runtime_id is None or i.runtime_id == runtime_id)]

    def window_percentile(self, t0: float, t1: Optional[float] = None,
                          p: float = 50.0, field: str = "rlat",
                          runtime_id: Optional[str] = None
                          ) -> Optional[float]:
        """Nearest-rank percentile of ``field`` (``rlat``/``elat``) over
        the successful completions in a window.  ``None`` for an empty
        window; a single-sample window returns that sample (any ``p``)."""
        vals = [getattr(i, field) for i in self.window(t0, t1, runtime_id)
                if i.success and getattr(i, field) is not None]
        return self.percentile(vals, p)

    def since(self, idx: int) -> List[Invocation]:
        """Completions recorded at monotone index ``idx`` or later — the
        incremental cursor telemetry samplers use (cursor = the
        ``n_recorded`` value at the previous sample).  Records already
        trimmed by ``history_max`` cannot be returned."""
        return self.completed[max(idx - self._dropped, 0):]

    # ------------------------------------------------------------------
    def rfast_timeline(self, step: float = 1.0,
                       window: float = RFAST_WINDOW_S
                       ) -> List[Tuple[float, float]]:
        """(t, completions in [t-window, t] / window) — per-second moving
        average of successful completions, the paper's RFast."""
        if not self._ends_sorted:
            self._success_ends.sort()
            self._ends_sorted = True
        ends = self._success_ends
        if not ends:
            return []
        out = []
        t = 0.0
        t_max = ends[-1] + window
        while t <= t_max:
            lo = bisect.bisect_left(ends, t - window)
            hi = bisect.bisect_right(ends, t)
            out.append((t, (hi - lo) / window))
            t += step
        return out

    def rfast_max(self) -> float:
        tl = self.rfast_timeline()
        return max((v for _, v in tl), default=0.0)

    def rfast_mean(self, t0: float, t1: float) -> float:
        """Steady-state mean RFast over [t0, t1] (e.g. the P1 phase)."""
        vals = [v for t, v in self.rfast_timeline() if t0 <= t <= t1]
        return sum(vals) / len(vals) if vals else 0.0

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        o = self._overall
        return {
            "n_completed": self.n_recorded,
            "r_success": o.r_success,
            "rfast_max": self.rfast_max(),
            "rlat_p50": o.rlat.quantile(50) or 0.0,
            "rlat_p99": o.rlat.quantile(99) or 0.0,
            "rlat_max": o.rlat_max,
            "elat_p50": o.elat.quantile(50) or 0.0,
            "cold_starts": o.cold_starts,
            "prewarmed": o.prewarmed,
            "rejected": o.rejected,
            # failure-path accounting (at-least-once delivery):
            # failed = settled unsuccessfully after actually being tried
            # (sheds are a deliberate policy outcome, counted separately)
            "failed": o.failed,
            "retried": o.retried,
            "retries_exhausted": o.retries_exhausted,
        }

    # -- machine-readable dumps (ops tooling / --metrics-out) -----------
    def per_runtime(self) -> Dict[str, Dict[str, float]]:
        """Per-runtime breakdown of the same derived numbers."""
        return {rid: self._per_runtime[rid].row()
                for rid in sorted(self._per_runtime)}

    def per_tenant(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant completion/shed counts (admission accounting)."""
        return {tenant: dict(self._per_tenant[tenant])
                for tenant in sorted(self._per_tenant)}

    def to_json(self) -> Dict[str, object]:
        """The full derived-metrics record as one JSON-serializable dict
        (aggregate summary + per-runtime + per-tenant breakdowns), so
        bench/ops tooling stops re-deriving summaries by hand."""
        out: Dict[str, object] = {
            "summary": self.summary(),
            "per_runtime": self.per_runtime(),
            "per_tenant": self.per_tenant(),
        }
        if self._span_durations:
            out["span_durations"] = self.span_durations()
        if self._acc_usage:
            out["accelerator_usage"] = self.accelerator_usage()
            out["locality_hits"] = self.n_locality_hits
        return out

    def prometheus_text(self, prefix: str = "hardless") -> str:
        """Prometheus text-exposition dump of the summary gauges, with
        per-runtime samples labelled ``{runtime="..."}`` and per-tenant
        shed/served counters labelled ``{tenant="..."}``."""
        s = self.summary()
        lines = []
        for name, help_txt in (
                ("n_completed", "settled invocations"),
                ("r_success", "successful invocations"),
                ("rlat_p50", "request latency p50 (s)"),
                ("rlat_p99", "request latency p99 (s)"),
                ("elat_p50", "execution latency p50 (s)"),
                ("cold_starts", "invocations that paid a cold start"),
                ("prewarmed", "invocations served by a prewarmed instance"),
                ("rejected", "invocations shed at admission"),
                ("failed", "invocations settled unsuccessfully (not shed)"),
                ("retried", "redeliveries after lost attempts"),
                ("retries_exhausted",
                 "invocations that ran out of delivery attempts")):
            lines.append(f"# HELP {prefix}_{name} {help_txt}")
            lines.append(f"# TYPE {prefix}_{name} gauge")
            lines.append(f"{prefix}_{name} {s[name]}")
        runtime_keys = ("r_success", "rlat_p50", "rlat_p99", "cold_starts",
                        "rejected")
        per_runtime = self.per_runtime()
        for k in runtime_keys:
            if not per_runtime:
                break
            lines.append(f"# HELP {prefix}_runtime_{k} per-runtime {k}")
            lines.append(f"# TYPE {prefix}_runtime_{k} gauge")
            for rid, r in per_runtime.items():
                lines.append(f'{prefix}_runtime_{k}'
                             f'{{runtime="{escape_label_value(rid)}"}} '
                             f'{r[k]}')
        per_tenant = self.per_tenant()
        for k in ("r_success", "rejected"):
            if not per_tenant:
                break
            lines.append(f"# HELP {prefix}_tenant_{k} per-tenant {k}")
            lines.append(f"# TYPE {prefix}_tenant_{k} gauge")
            for tenant, r in per_tenant.items():
                lines.append(f'{prefix}_tenant_{k}'
                             f'{{tenant="{escape_label_value(tenant)}"}} '
                             f'{r[k]}')
        if self._acc_usage:
            usage = self.accelerator_usage()
            for name, field, help_txt in (
                    ("cost_dollars_total", "cost_dollars",
                     "accelerator-seconds cost per accelerator type "
                     "(measured ELat x registered cost_per_hour)"),
                    ("energy_joules_total", "energy_joules",
                     "active energy per accelerator type "
                     "(measured ELat x registered active watts)"),
                    ("acc_busy_seconds_total", "busy_s",
                     "execution seconds per accelerator type"),
                    ("acc_invocations_total", "n_invocations",
                     "successful invocations per accelerator type")):
                lines.append(f"# HELP {prefix}_{name} {help_txt}")
                lines.append(f"# TYPE {prefix}_{name} counter")
                for acc_type, row in usage.items():
                    lines.append(
                        f'{prefix}_{name}'
                        f'{{accelerator="{escape_label_value(acc_type)}"}} '
                        f'{row[field]}')
            lines.append(f"# HELP {prefix}_locality_hits_total inputs "
                         f"read from a node-resident copy (no store "
                         f"round trip)")
            lines.append(f"# TYPE {prefix}_locality_hits_total counter")
            lines.append(f"{prefix}_locality_hits_total "
                         f"{self.n_locality_hits}")
        if self._span_durations:
            for suffix, idx in (("count", 0), ("seconds_total", 1)):
                lines.append(f"# HELP {prefix}_span_{suffix} trace-span "
                             f"duration summary per runtime and span")
                lines.append(f"# TYPE {prefix}_span_{suffix} gauge")
                for (rid, span), row in sorted(
                        self._span_durations.items()):
                    lines.append(
                        f'{prefix}_span_{suffix}'
                        f'{{runtime="{escape_label_value(rid)}",'
                        f'span="{escape_label_value(span)}"}} {row[idx]}')
        return "\n".join(lines) + "\n"
