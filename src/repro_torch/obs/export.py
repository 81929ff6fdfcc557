"""Chrome/Perfetto ``trace_event`` JSON export.

Load the output at https://ui.perfetto.dev (or chrome://tracing): each
*trace* renders as a process row, each invocation's span family as a
thread lane, so the root → queue_wait/dispatch/execute/... nesting reads
directly off the flame chart.

Only complete (``"ph": "X"``) events plus name metadata (``"ph": "M"``)
are emitted, sorted by timestamp — the shape the CI validator
(``repro_torch.obs.validate``) checks.  Spans still open at export time (the
synthetic ``workflow`` roots) are closed at their trace's last child
end.  Timestamps are exported in microseconds on whatever clock the
tracer ran (virtual seconds on the sim — Perfetto neither knows nor
cares, relative time is what the flame chart shows).

The port's copy of ``repro.obs.export`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.tracer import Span


def _anchor(span: Span, by_id: Dict[str, Span]) -> str:
    """The lane key for a span: its nearest ``invocation`` ancestor, else
    the top of its parent chain (unknown parent ids — authored by a
    process whose other spans were lost — still anchor siblings
    together via the deterministic ``inv<id>/...`` id shape)."""
    cur = span
    seen = set()
    while True:
        if cur.name == "invocation":
            return cur.span_id
        pid = cur.parent_id
        if pid is None:
            return cur.span_id
        if pid not in by_id or pid in seen:
            return pid.split("/")[0]
        seen.add(cur.span_id)
        cur = by_id[pid]


def to_trace_events(spans: List[Span]) -> Dict[str, Any]:
    """Build the ``{"traceEvents": [...]}`` document from a span list."""
    spans = sorted(spans, key=lambda s: (s.trace_id, s.t_start, s.span_id))
    by_id = {s.span_id: s for s in spans}
    # close dangling spans (workflow roots) at their trace's horizon
    horizon: Dict[str, float] = {}
    for s in spans:
        if s.t_end is not None:
            horizon[s.trace_id] = max(horizon.get(s.trace_id, s.t_end),
                                      s.t_end)
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    events: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    for s in spans:
        pid = pids.get(s.trace_id)
        if pid is None:
            pid = pids[s.trace_id] = len(pids) + 1
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "ts": 0,
                         "args": {"name": s.trace_id}})
        lane = _anchor(s, by_id)
        tid = tids.get((pid, lane))
        if tid is None:
            tid = tids[(pid, lane)] = \
                len([k for k in tids if k[0] == pid]) + 1
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "ts": 0, "args": {"name": lane}})
        t0 = s.t_start
        t1 = s.t_end if s.t_end is not None else \
            max(horizon.get(s.trace_id, t0), t0)
        args = {k: v for k, v in (s.attrs or {}).items() if v is not None}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        args["status"] = s.status
        dur_us = max(0.0, (t1 - t0) * 1e6)
        if "tokens" in args and dur_us > 0:
            args["tokens_per_s"] = round(args["tokens"] / (dur_us * 1e-6), 1)
        events.append({"name": s.name, "cat": s.status, "ph": "X",
                       "ts": round(t0 * 1e6, 3), "dur": round(dur_us, 3),
                       "pid": pid, "tid": tid, "args": args})
    events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], -e["dur"]))
    return {"displayTimeUnit": "ms", "traceEvents": meta + events}


def write_trace(path: str, spans: List[Span]) -> int:
    """Export ``spans`` to ``path``; returns the event count."""
    doc = to_trace_events(spans)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return len(doc["traceEvents"])
