"""Validate a Chrome ``trace_event`` JSON file (the CI gate).

Checks the structural contract a Perfetto/chrome://tracing load relies
on: a ``traceEvents`` list whose entries carry the required keys, phase
markers from the documented set, non-negative durations on complete
(``X``) events, balanced ``B``/``E`` pairs per (pid, tid), and
non-decreasing timestamps across non-metadata events.

    PYTHONPATH=src python -m repro_torch.obs.validate trace.json

The port's copy of ``repro.obs.validate`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List

_REQUIRED = ("name", "ph", "ts", "pid", "tid")
_PHASES = {"X", "B", "E", "M", "i", "I", "C"}


def validate_trace(doc: Any) -> List[str]:
    """Return the list of contract violations (empty = valid)."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/invalid 'traceEvents' list"]
    if not events:
        return ["'traceEvents' is empty"]
    last_ts = None
    depth: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            errors.append(f"event {i}: missing keys {missing}")
            continue
        ph = ev["ph"]
        if ph not in _PHASES:
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph == "M":
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            errors.append(f"event {i}: ts {ts} < previous {last_ts} "
                          f"(timestamps must be non-decreasing)")
        last_ts = ts
        key = (ev["pid"], ev["tid"])
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: X event needs dur >= 0, "
                              f"got {dur!r}")
        elif ph == "B":
            depth[key] = depth.get(key, 0) + 1
        elif ph == "E":
            depth[key] = depth.get(key, 0) - 1
            if depth[key] < 0:
                errors.append(f"event {i}: E without matching B on {key}")
    for key, d in depth.items():
        if d > 0:
            errors.append(f"track {key}: {d} unclosed B event(s)")
    return errors


def validate_trace_file(path: str) -> List[str]:
    """Load ``path`` and :func:`validate_trace` it (unreadable = error)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable trace ({e})"]
    return validate_trace(doc)


def main(argv: List[str]) -> int:
    """CLI: exit 0 on a valid trace, 1 with the violations printed."""
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.validate TRACE.json",
              file=sys.stderr)
        return 2
    errors = validate_trace_file(argv[0])
    if errors:
        print(f"{argv[0]}: INVALID trace_event JSON")
        for e in errors:
            print(f"  {e}")
        return 1
    with open(argv[0]) as f:
        n = len(json.load(f)["traceEvents"])
    print(f"{argv[0]}: valid trace_event JSON ({n} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
