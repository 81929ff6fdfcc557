"""Object storage (Minio analogue).

Content-addressed blob store holding runtime definitions, input data and
results.  Fetch/put latency follows a simple bandwidth + RTT model on the
cluster clock — the component that turns "stateless workloads must fetch
data sets before running" (§IV-A) into measurable delivery delay (DLat).

Outcome records are stored as explicit envelopes (see
:func:`make_outcome` / :func:`unwrap_outcome`): ``{"ok": bool, "value":
..., "error": ...}`` plus provenance, so a runtime that legitimately
returns ``None`` is distinguishable from bookkeeping, and a failure can
carry a partial result without dropping the error.

The port's copy of ``repro.core.storage`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import hashlib
import pickle
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Set

# reserved marker key identifying an outcome envelope in the store (the
# value namespace is the user's; a dict with this key is always ours)
OUTCOME_MARK = "__hardless_outcome__"


def make_outcome(inv, result: Any, err: Optional[str]) -> Dict[str, Any]:
    """Build the explicit outcome envelope for one settled invocation.

    ``value`` is kept even when ``err`` is set (a failure may carry a
    partial result); ``ok`` alone decides success.
    """
    return {
        OUTCOME_MARK: True,
        "ok": err is None,
        "value": result,
        "error": err,
        "inv_id": inv.inv_id,
        "attempt": inv.attempt,
    }


def is_outcome(obj: Any) -> bool:
    """True when ``obj`` is a stored outcome envelope."""
    return isinstance(obj, dict) and obj.get(OUTCOME_MARK) is True


def unwrap_outcome(obj: Any) -> Any:
    """The payload value of an envelope; any other object passes through
    (the data plane between workflow steps: a child's ``data_ref`` is its
    parent's ``result_ref``, and the child runtime wants the value)."""
    return obj["value"] if is_outcome(obj) else obj


class ObjectStore:
    def __init__(self, bandwidth_bps: float = 1.25e9, rtt_s: float = 0.002,
                 outcome_max: Optional[int] = None):
        self._blobs: Dict[str, bytes] = {}
        self._raw: Set[str] = set()      # keys whose payload was put as bytes
        self.bandwidth = bandwidth_bps   # 10 GbE default
        self.rtt = rtt_s
        self.n_puts = 0
        self.n_gets = 0
        self.n_contains = 0              # membership probes (poll detector)
        # settlement watchers: key -> one-shot callbacks fired when the key
        # lands.  Registration and notification share one lock, so a
        # watcher registered while the key is being put either sees the
        # blob (fires immediately) or is picked up by the put (no missed
        # notify either way).
        self._watch_lock = threading.Lock()
        self._watchers: Dict[str, List[Callable[[], None]]] = {}
        # optional FIFO bound on retained outcome records (result:inv*) —
        # the 1M-event scale path caps resident results; None = keep all
        self.outcome_max = outcome_max
        self._outcome_keys: Deque[str] = deque()
        # data-locality residency hints: key -> node name that holds a
        # local copy (the producing node keeps its own results resident).
        # Read by the placement layer; a locality hit reads the local copy
        # and never probes the store (n_contains/n_gets stay flat).
        self._residency: Dict[str, str] = {}
        self.n_local_reads = 0           # store round-trips locality avoided

    # -- data plane ----------------------------------------------------
    def put(self, obj: Any, key: Optional[str] = None) -> str:
        blob = obj if isinstance(obj, bytes) else pickle.dumps(obj)
        key = key or ("sha256:" + hashlib.sha256(blob).hexdigest()[:24])
        self._blobs[key] = blob
        # record HOW the payload was stored at put() time — get() must not
        # guess (raw bytes that happen to be valid pickle must come back
        # as the bytes the client stored, and corruption of a pickled blob
        # must surface, not silently degrade to bytes)
        if isinstance(obj, bytes):
            self._raw.add(key)
        else:
            self._raw.discard(key)
        self.n_puts += 1
        self._notify(key)
        return key

    def _notify(self, key: str) -> None:
        """Fire (and drop) the one-shot watchers registered for ``key``.
        The blob is already in ``_blobs`` when this runs."""
        with self._watch_lock:
            fns = self._watchers.pop(key, None)
        if fns:
            for fn in fns:
                fn()

    def on_settle(self, key: str, fn: Callable[[], None]) -> bool:
        """Call ``fn`` once when ``key`` lands in the store (completion
        callback — no polling).  If the key is already present, ``fn``
        fires immediately; returns True in that case.  ``fn`` runs on
        whichever thread puts the blob and must not block."""
        with self._watch_lock:
            if key in self._blobs:
                present = True
            else:
                self._watchers.setdefault(key, []).append(fn)
                present = False
        if present:
            fn()
        return present

    def put_serialized(self, key: str, blob: bytes,
                       raw: bool = False) -> str:
        """Install an *already-serialized* blob under ``key`` and fire its
        settlement watchers — the transport seam: a remote store (the
        cluster master, or a client mirror applying a settle record)
        moves blobs without a decode/re-encode round trip.  ``raw=True``
        marks the payload as client bytes (``get`` returns them as-is);
        otherwise the blob must be a pickle and ``get`` unpickles it."""
        self._blobs[key] = blob
        if raw:
            self._raw.add(key)
        else:
            self._raw.discard(key)
        self.n_puts += 1
        self._notify(key)
        return key

    def is_raw(self, key: str) -> bool:
        """True when ``key``'s payload was stored as client bytes (the
        flag a transport must carry next to the blob)."""
        return key in self._raw

    def get(self, key: str) -> Any:
        self.n_gets += 1
        blob = self._blobs[key]
        if key in self._raw:
            return blob
        return pickle.loads(blob)    # corruption raises; never masked

    def get_raw(self, key: str) -> bytes:
        self.n_gets += 1
        return self._blobs[key]

    def alias(self, src_key: str, dst_key: str) -> str:
        """Expose the blob under ``src_key`` at ``dst_key`` too (no copy).

        The workflow runner's resume index: a finished step's outcome is
        aliased under a deterministic per-step key, so a re-submitted
        workflow can skip recomputation.
        """
        self._blobs[dst_key] = self._blobs[src_key]
        if src_key in self._raw:
            self._raw.add(dst_key)
        else:
            self._raw.discard(dst_key)
        self._notify(dst_key)
        return dst_key

    def __contains__(self, key: str) -> bool:
        self.n_contains += 1
        return key in self._blobs

    def size(self, key: str) -> int:
        return len(self._blobs[key])

    def gather(self, refs: Sequence[str], key: Optional[str] = None) -> str:
        """Fan-in barrier on the data plane: materialize the objects under
        ``refs`` (in order) as ONE stored list and return its ref.

        Outcome envelopes are unwrapped to their values — a fan-in step's
        parents are result refs, and the child runtime wants the results.
        """
        return self.put([unwrap_outcome(self.get(r)) for r in refs], key=key)

    # -- outcome records -------------------------------------------------
    def persist_outcome(self, inv, result: Any,
                        err: Optional[str]) -> str:
        """Persist an invocation's outcome envelope under the key gateway
        futures poll (``result:inv<id>``); returns the ref.  Shared by the
        node manager and the engine backend so both write the same record.
        ``result`` is stored even when ``err`` is set (partial results of
        a failure are preserved, the error is never dropped)."""
        inv.result_ref = self.put(make_outcome(inv, result, err),
                                  key=f"result:inv{inv.inv_id}")
        if self.outcome_max is not None:
            self._outcome_keys.append(inv.result_ref)
            while len(self._outcome_keys) > self.outcome_max:
                old = self._outcome_keys.popleft()
                self._blobs.pop(old, None)
                self._raw.discard(old)
        return inv.result_ref

    def get_outcome(self, ref: str) -> Dict[str, Any]:
        """Fetch an outcome envelope by ref (KeyError when absent)."""
        rec = self.get(ref)
        if not is_outcome(rec):
            raise TypeError(f"{ref!r} does not hold an outcome envelope")
        return rec

    # -- data-locality residency hints -----------------------------------
    def note_resident(self, key: Optional[str], node: str) -> None:
        """Record that ``node`` holds a local copy of ``key`` (the node
        that produced a result keeps it resident until it dies)."""
        if key:
            self._residency[key] = node

    def resident_on(self, key: Optional[str]) -> Optional[str]:
        """Node holding a local copy of ``key`` (no counters — this is a
        placement hint lookup, not a data-plane round trip)."""
        if not key:
            return None
        return self._residency.get(key)

    def drop_resident(self, node: str) -> int:
        """Forget every residency hint pointing at ``node`` (node death /
        drain) so placement falls back to store round-trips; returns the
        number of hints dropped."""
        dead = [k for k, n in self._residency.items() if n == node]
        for k in dead:
            del self._residency[k]
        return len(dead)

    def peek(self, key: str) -> Any:
        """Read a blob *without* bumping the round-trip counters — the
        locality fast path: the caller already holds a resident copy, so
        this models a node-local read, not a storage-network fetch."""
        blob = self._blobs[key]
        if key in self._raw:
            return blob
        return pickle.loads(blob)

    def peek_size(self, key: str) -> Optional[int]:
        """Blob size without counters (scheduler fetch-time estimates);
        None when the key is absent."""
        blob = self._blobs.get(key)
        return None if blob is None else len(blob)

    # -- latency model ---------------------------------------------------
    def transfer_time(self, key: str) -> float:
        """Seconds to move the blob over the storage network."""
        return self.rtt + self.size(key) / self.bandwidth

    def transfer_time_bytes(self, nbytes: int) -> float:
        return self.rtt + nbytes / self.bandwidth
