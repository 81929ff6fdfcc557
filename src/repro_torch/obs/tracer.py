"""Per-invocation distributed tracing: spans, the tracer, and the
invocation span tree shared by all three backends.

Every settled invocation gets one *root span* covering its full RStart →
REnd life, decomposed into children that partition that interval exactly
(Hardless §V-A timestamp chain):

    invocation                      [r_start, r_end]
      submit                        [r_start, r_start]      (instant)
      queue_wait                    [r_start, n_start]
        batch_wait                  [n_start - window, n_start]
      dispatch                      [n_start, e_start]
        cold_start                  [n_start, n_start + cold_s]
      execute                       [e_start, e_end]
        prefill / prefill_chunk / decode   (serving engine, tokens/s)
      store_put                     [e_end, n_end]
      settle                        [n_end, r_end]

Because the children tile ``[r_start, r_end]``, their summed durations
equal the invocation's measured RLat by construction — the property the
acceptance gate checks.  The tree is *identical in shape* across the sim
(virtual-clock timestamps → deterministic traces), the engine, and the
multi-process cluster; only who authors each span differs (cluster
workers emit ``execute``/``cold_start``/engine spans themselves, on the
master clock, and ship them home inside settle records).

Span ids are deterministic — root ``inv<id>``, children
``inv<id>/a<attempt>/<name>`` — so processes that never exchange live
state still agree on parent links.  Workflow steps share one trace
(``wf:<name>``) under a synthetic ``workflow`` root; a retried attempt
keeps the original trace id, so its spans (and the ``abandoned``
closure of the dead attempt) link back to the same tree.

Cheap when off: the module-level tracer starts disabled and every
emission path is gated on a single ``enabled`` attribute check — no
locks, no allocation, no clock reads.

The port's copy of ``repro.obs.tracer`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

# span status values
OK = "ok"
ERROR = "error"
REJECTED = "rejected"
ABANDONED = "abandoned"

# the span taxonomy (docs/observability.md documents each entry)
SPAN_NAMES = (
    "workflow", "invocation", "submit", "queue_wait", "admission",
    "cold_start", "batch_wait", "dispatch", "execute", "prefill",
    "prefill_chunk", "decode", "store_put", "settle", "attempt",
)


@dataclass(slots=True)
class Span:
    """One timed interval on a trace.  ``t_end is None`` = still open."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    t_start: float
    t_end: Optional[float] = None
    status: str = OK
    attrs: Optional[Dict[str, Any]] = None

    @property
    def duration(self) -> Optional[float]:
        """Seconds covered, or None while the span is still open."""
        return None if self.t_end is None else self.t_end - self.t_start

    def to_record(self) -> Dict[str, Any]:
        """JSON-serializable form (rides RPC settle records)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "t_start": self.t_start, "t_end": self.t_end,
                "status": self.status, "attrs": self.attrs}

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "Span":
        """Rebuild a span from its :meth:`to_record` form."""
        return cls(trace_id=rec["trace_id"], span_id=rec["span_id"],
                   parent_id=rec.get("parent_id"), name=rec["name"],
                   t_start=float(rec["t_start"]),
                   t_end=None if rec.get("t_end") is None
                   else float(rec["t_end"]),
                   status=rec.get("status", OK), attrs=rec.get("attrs"))


class Tracer:
    """Collects spans on one clock; disabled (the default) it no-ops.

    One tracer per process.  Backends and the serving engine emit through
    the module singleton (:data:`repro_torch.obs.TRACER`); cluster workers run
    their own process-local instance on the master clock and drain span
    records into settle RPCs.
    """

    def __init__(self) -> None:
        self.enabled = False
        self.metrics = None                 # optional MetricsCollector
        self._clock: Callable[[], float] = time.monotonic
        self._spans: List[Span] = []
        self._open: Dict[str, Span] = {}
        self._roots: set = set()            # invocation root ids emitted
        self._ids = itertools.count(1)
        self._prefix = "s"
        self._lock = threading.Lock()
        self._ctx = threading.local()

    # -- lifecycle -------------------------------------------------------
    def enable(self, *, clock: Optional[Callable[[], float]] = None,
               metrics=None, prefix: Optional[str] = None) -> "Tracer":
        """Turn emission on.  ``clock`` aligns live spans with the
        backend's timeline (virtual sim clock / engine monotonic /
        master-offset clock); ``metrics`` receives per-runtime
        span-duration summaries; ``prefix`` namespaces auto span ids so
        ids minted in different processes never collide."""
        if clock is not None:
            self._clock = clock
        if metrics is not None:
            self.metrics = metrics
        if prefix is not None:
            self._prefix = prefix
        self.enabled = True
        return self

    def disable(self) -> None:
        """Stop emitting; collected spans are kept."""
        self.enabled = False

    def reset(self) -> None:
        """Back to pristine: disabled, empty, wall clock."""
        with self._lock:
            self.enabled = False
            self.metrics = None
            self._clock = time.monotonic
            self._spans = []
            self._open = {}
            self._roots = set()
            self._ids = itertools.count(1)
            self._prefix = "s"

    def now(self) -> float:
        """Read the tracer's clock (the backend timeline when set)."""
        return self._clock()

    # -- emission --------------------------------------------------------
    def _emit(self, span: Span) -> None:
        self._spans.append(span)            # list.append: atomic under GIL
        m = self.metrics
        if m is not None and span.t_end is not None and span.attrs:
            rid = span.attrs.get("runtime")
            if rid is not None:
                m.observe_span(rid, span.name, span.t_end - span.t_start)

    def complete(self, name: str, t_start: float, t_end: float, *,
                 trace: Optional[str] = None, parent: Optional[str] = None,
                 span_id: Optional[str] = None, status: str = OK,
                 attrs: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Emit one closed span.  ``trace``/``parent`` default to the
        thread-local context (see :meth:`ctx`)."""
        if not self.enabled:
            return None
        if trace is None:
            cur = self.current()
            if cur is not None:
                trace, parent = cur if parent is None else (cur[0], parent)
            else:
                trace = "untraced"
        if span_id is None:
            span_id = f"{self._prefix}{next(self._ids)}"
        self._emit(Span(trace, span_id, parent, name, t_start,
                        max(t_end, t_start), status, attrs))
        return span_id

    def instant(self, name: str, t: Optional[float] = None, *,
                trace: Optional[str] = None, parent: Optional[str] = None,
                span_id: Optional[str] = None, status: str = OK,
                attrs: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """A zero-duration marker span."""
        if not self.enabled:
            return None
        t = self.now() if t is None else t
        return self.complete(name, t, t, trace=trace, parent=parent,
                             span_id=span_id, status=status, attrs=attrs)

    def begin(self, name: str, *, trace: str,
              parent: Optional[str] = None, t_start: Optional[float] = None,
              span_id: Optional[str] = None,
              attrs: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Open a live span; pair with :meth:`end`."""
        if not self.enabled:
            return None
        if span_id is None:
            span_id = f"{self._prefix}{next(self._ids)}"
        sp = Span(trace, span_id, parent, name,
                  self.now() if t_start is None else t_start, None, OK, attrs)
        with self._lock:
            self._open[span_id] = sp
            self._spans.append(sp)
        return span_id

    def end(self, span_id: Optional[str], *, t_end: Optional[float] = None,
            status: str = OK) -> None:
        if span_id is None:
            return
        with self._lock:
            sp = self._open.pop(span_id, None)
        if sp is None:
            return
        sp.t_end = max(self.now() if t_end is None else t_end, sp.t_start)
        sp.status = status
        m = self.metrics
        if m is not None and sp.attrs:
            rid = sp.attrs.get("runtime")
            if rid is not None:
                m.observe_span(rid, sp.name, sp.t_end - sp.t_start)

    # -- thread-local context (batch execution → engine spans) -----------
    def current(self) -> Optional[Tuple[str, Optional[str]]]:
        """The innermost (trace_id, parent_span_id) pushed on this
        thread, or None."""
        stack = getattr(self._ctx, "stack", None)
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def ctx(self, trace: str, parent: Optional[str]):
        """Bind (trace, parent) for spans emitted on this thread — how a
        batch executor hands its identity to the serving engine without
        the engine knowing about invocations."""
        stack = getattr(self._ctx, "stack", None)
        if stack is None:
            stack = self._ctx.stack = []
        stack.append((trace, parent))
        try:
            yield
        finally:
            stack.pop()

    # -- the invocation span tree ----------------------------------------
    def workflow_root(self, name: str, t: float) -> str:
        """Get-or-create the synthetic root span a workflow's step
        invocations hang from.  Left open; the exporter closes it at the
        last child's end."""
        sid = f"wf:{name}"
        with self._lock:
            if sid not in self._open and \
                    not any(s.span_id == sid for s in self._spans):
                sp = Span(sid, sid, None, "workflow", t, None, OK,
                          {"workflow": name})
                self._open[sid] = sp
                self._spans.append(sp)
        return sid

    def record_invocation(self, inv, *, cold_s: float = 0.0,
                          batch_window_s: float = 0.0,
                          emit_cold: bool = True,
                          emit_execute: bool = True) -> None:
        """Emit the settled invocation's root span plus the children that
        tile [r_start, r_end] (module docstring).  Idempotent per root id
        — first settlement wins, matching the backends' settle contract.

        ``emit_cold=False`` / ``emit_execute=False`` skip children some
        other process already authored (cluster workers emit their own
        ``cold_start``/``execute`` spans on the master clock).
        """
        if not self.enabled:
            return
        tid = inv.trace_id
        if tid is None:
            return
        root = inv.span_id or f"inv{inv.inv_id}"
        with self._lock:
            if root in self._roots:
                return
            self._roots.add(root)
        r0 = inv.r_start or 0.0
        r1 = r0 if inv.r_end is None else max(inv.r_end, r0)
        parent = None
        if inv.workflow:
            parent = self.workflow_root(inv.workflow, r0)
        status = OK if inv.success else \
            (REJECTED if inv.rejected else ERROR)
        rid = inv.runtime_id
        self._emit(Span(tid, root, parent, "invocation", r0, r1, status, {
            "runtime": rid, "inv_id": inv.inv_id, "attempt": inv.attempt,
            "node": inv.node, "tenant": inv.tenant, "workflow": inv.workflow,
            "step": inv.step, "error": inv.error,
            "cold": bool(inv.cold_start), "rlat_s": r1 - r0,
        }))
        pre = f"{root}/a{inv.attempt}"
        a = {"runtime": rid}
        if inv.rejected:
            # shed before execution: the whole (flat) life is settle
            self._emit(Span(tid, f"{pre}/settle", root, "settle",
                            r0, r1, status, a))
            return
        # clamp into a monotone chain; missing stamps collapse to zero-
        # width children (e.g. retries-exhausted records never executed)
        n0 = max(r0, inv.n_start if inv.n_start is not None else r0)
        e0 = max(n0, inv.e_start if inv.e_start is not None else n0)
        e1 = max(e0, inv.e_end if inv.e_end is not None else e0)
        n1 = max(e1, inv.n_end if inv.n_end is not None else e1)
        n0, e0, e1, n1 = (min(x, r1) for x in (n0, e0, e1, n1))
        self._emit(Span(tid, f"{pre}/submit", root, "submit", r0, r0, OK, a))
        self._emit(Span(tid, f"{pre}/queue_wait", root, "queue_wait",
                        r0, n0, OK, a))
        if batch_window_s > 0.0:
            self._emit(Span(tid, f"{pre}/batch_wait", f"{pre}/queue_wait",
                            "batch_wait", max(r0, n0 - batch_window_s), n0,
                            OK, a))
        self._emit(Span(tid, f"{pre}/dispatch", root, "dispatch",
                        n0, e0, OK, a))
        if emit_cold and inv.cold_start and cold_s > 0.0:
            self._emit(Span(tid, f"{pre}/cold_start", f"{pre}/dispatch",
                            "cold_start", n0, min(n0 + cold_s, e0), OK, a))
        if emit_execute:
            self._emit(Span(tid, f"{pre}/execute", root, "execute",
                            e0, e1, OK if inv.success else status,
                            {"runtime": rid, "node": inv.node,
                             "accelerator": inv.accelerator}))
        self._emit(Span(tid, f"{pre}/store_put", root, "store_put",
                        e1, n1, OK, a))
        self._emit(Span(tid, f"{pre}/settle", root, "settle",
                        n1, r1, OK, a))

    def record_abandoned(self, inv, *, holder: Optional[str], now: float,
                         reason: str) -> Optional[Dict[str, Any]]:
        """The closure of a dead attempt's orphaned work: one ``attempt``
        span with ``abandoned`` status covering dispatch → loss.  Returns
        the span record (callers relaying across processes forward it);
        also emitted locally when this tracer is enabled."""
        if inv.trace_id is None:
            return None
        root = inv.span_id or f"inv{inv.inv_id}"
        t0 = inv.n_start if inv.n_start is not None else \
            (inv.r_start if inv.r_start is not None else now)
        sp = Span(inv.trace_id, f"{root}/a{inv.attempt}/attempt", root,
                  "attempt", min(t0, now), now, ABANDONED,
                  {"runtime": inv.runtime_id, "attempt": inv.attempt,
                   "node": holder, "reason": reason})
        if self.enabled:
            self._emit(sp)
        return sp.to_record()

    # -- cross-process transfer ------------------------------------------
    def drain_records(self) -> List[Dict[str, Any]]:
        """Pop every closed span as a JSON record (worker → settle RPC)."""
        with self._lock:
            closed = [s for s in self._spans if s.t_end is not None]
            self._spans = [s for s in self._spans if s.t_end is None]
        return [s.to_record() for s in closed]

    def ingest(self, records: List[Dict[str, Any]]) -> None:
        """Adopt spans authored in another process (already closed)."""
        if not self.enabled or not records:
            return
        for rec in records:
            try:
                self._emit(Span.from_record(rec))
            except (KeyError, TypeError, ValueError):
                continue                    # never let a bad frame in

    # -- introspection ----------------------------------------------------
    def spans(self) -> List[Span]:
        """Snapshot of every collected span (open and closed)."""
        with self._lock:
            return list(self._spans)

    def find(self, name: Optional[str] = None, trace: Optional[str] = None,
             status: Optional[str] = None) -> List[Span]:
        """Filter collected spans by name / trace id / status."""
        return [s for s in self.spans()
                if (name is None or s.name == name)
                and (trace is None or s.trace_id == trace)
                and (status is None or s.status == status)]

    def closed_roots(self) -> int:
        """Settled invocations with a closed root span (the bench's
        span-completeness counter)."""
        return sum(1 for s in self.spans()
                   if s.name == "invocation" and s.t_end is not None)
