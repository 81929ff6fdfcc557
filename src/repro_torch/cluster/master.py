"""The cluster master: queue, object store, metrics, and the keeper.

One master process owns all shared state the thread-mode backends kept
in-process — the :class:`~repro_torch.core.queue.ScannableQueue` (with its
PR-5 visibility leases and retry bounds), the
:class:`~repro_torch.core.storage.ObjectStore`, the
:class:`~repro_torch.core.metrics.MetricsCollector`, and the runtime
catalogue — and exposes them to worker processes and the gateway client
over the :mod:`repro_torch.cluster.rpc` frame protocol (Lithops' standalone
master/worker/keeper topology).

Responsibilities:

* **submit/take/settle** — the event loop.  ``take`` is a long-poll
  that grants queue leases to the calling worker and forms micro-batches
  (``take_any`` then ``take_matching`` up to the runtime's batch limit,
  the PR-2 dispatcher contract).  ``settle`` is **first-settlement-wins**:
  the first record to arrive for an event is applied (lease acked, any
  requeued copy discarded); every later record — a stale worker whose
  lease had expired, a redelivered duplicate, a settle replayed against
  a restarted master — is refused with a reason, never applied twice.
* **keeper** — a tick thread expires silent workers (missed heartbeats
  → ``release_holder``: their leased events requeue immediately with
  ``attempt`` bumped) and reaps per-event lease expiry (``reap``).
  Events that exhaust ``RuntimeDef.max_attempts`` settle as permanent
  error records through the queue's ``fail_fn`` seam.
* **settlement stream** — every settlement appends one record (event
  fields + the pickled outcome envelope) to a log the gateway client
  long-polls (``poll_settled``), so client futures fire callback-driven
  with no per-future polling.
* **runtime catalogue by spec** — callables cannot cross process
  boundaries, so runtimes register as importable factory references
  (``RuntimeDef.spec``); the master imports them for its own bookkeeping
  (batch limits, ``max_attempts``) and re-serves the spec list to
  workers, versioned so a parked ``take`` returns early on catalogue
  change.

Clock: all timestamps are seconds on the master's monotonic clock;
peers learn the offset at ``hello`` and convert locally measured times
before reporting.  ``snapshot()``/``snapshot=`` persist the settled-id
set across a master restart so duplicate settlement stays refused even
then.

The port's copy of ``repro.cluster.master``; a worker that reports no
accelerator type counts as the port's ``HOST_ACC`` (``host-cuda``).
"""
from __future__ import annotations

import pickle
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from repro_torch.core.events import Invocation
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.queue import ScannableQueue
from repro_torch.core.runtime import HOST_ACC, RuntimeRegistry
from repro_torch.core.storage import ObjectStore, make_outcome
from repro_torch.cluster.keeper import HeartbeatKeeper
from repro_torch.cluster.rpc import (RPC_VERSION, RpcServer, decode_blob,
                               encode_blob, inv_from_wire, inv_to_wire)
from repro_torch.obs.tracer import Tracer

# span-record authoring only (never enabled): the master relays trace
# records through the settle log; the gateway client's tracer owns them
_SPAN_RELAY = Tracer()

# settlement-stream retention: records past this are trimmed from the
# front (the single gateway pump keeps up long before this fills)
SETTLE_LOG_MAX = 8192

# a long-poll never parks a connection thread longer than this per call
MAX_POLL_S = 60.0

# data-locality grace window: an event whose input blob is resident in
# another worker's cache is withheld from non-owner takes this long after
# its RStart, giving the owner (typically parked in ``take`` and woken by
# the submit) first claim; past the window anyone serves it, so a busy or
# dead owner never strands the event.  Wider than the sim's window — the
# owner must round-trip a long-poll wakeup, not a clock callback.
LOCALITY_DEFER_S = 0.15

# residency hints retained (ref -> producing worker); FIFO-trimmed like
# the settle log — a hint is an optimization, never correctness
RESIDENT_MAX = 8192


class Master:
    """The single stateful process of a cluster (see module docstring)."""

    def __init__(self, *, lease_s: float = 30.0,
                 heartbeat_timeout_s: float = 5.0,
                 keeper_interval_s: float = 0.5,
                 snapshot: Optional[Dict[str, Any]] = None):
        self.store = ObjectStore()
        self.registry = RuntimeRegistry()
        self.metrics = MetricsCollector()
        self.queue = ScannableQueue(lease_s=lease_s)
        self.queue.configure_retries(
            retry_limit_fn=lambda inv:
                self.registry.get(inv.runtime_id).max_attempts,
            fail_fn=self._settle_exhausted_locked)
        # a dead worker's leased events requeue with their dead attempt's
        # timestamps still intact — close that attempt's orphaned span as
        # ``abandoned`` and relay it home through the settlement stream
        self.queue.set_requeue_observer(self._observe_requeue_locked)
        self.keeper = HeartbeatKeeper(timeout_s=heartbeat_timeout_s)
        self.keeper_interval_s = max(float(keeper_interval_s), 0.01)

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._t0 = time.monotonic()
        # submitted, unsettled events by id (the master's live set)
        self._inflight: Dict[int, Invocation] = {}
        # ids settled forever — the duplicate-settlement refusal set;
        # restored from a snapshot so refusal survives a master restart
        self._settled_ids = set(
            (snapshot or {}).get("settled_ids", ()))
        # settlement stream the gateway client long-polls
        self._settle_log: List[Dict[str, Any]] = []
        self._log_base = 0
        # runtime catalogue as (spec, kwargs) pairs, versioned
        self._specs: List[Dict[str, Any]] = []
        self._catalog_version = 0
        # control-plane directives pending per worker (heartbeat replies)
        self._directives: Dict[str, Deque[Dict[str, Any]]] = {}
        # master-observed per-worker take/settle counts — authoritative
        # over the heartbeat-carried copies, which lag by up to a beat
        self._worker_counts: Dict[str, Dict[str, int]] = {}
        # data-locality hints: result ref -> worker that produced it (its
        # cache holds the blob), and the inverse affinity index — worker
        # -> pending event ids whose data_ref is resident there.  Both
        # are hints: entries go stale (cache eviction, worker death) and
        # the take path degrades to an ordinary RPC fetch.
        self._resident: Dict[str, str] = {}
        self._affine: Dict[str, set] = {}
        self._prewarm_rr = 0
        self._shutdown = False

        self.n_submitted = 0
        self.n_settled = 0
        self.n_duplicate_settles = 0
        self.n_workers_lost = 0

        self._server: Optional[RpcServer] = None
        self._keeper_stop = threading.Event()
        self._keeper_thread = threading.Thread(
            target=self._keeper_loop, name="master-keeper", daemon=True)
        self._keeper_thread.start()

    # -- clock -----------------------------------------------------------
    def now(self) -> float:
        """Seconds on the master clock (monotonic since construction)."""
        return time.monotonic() - self._t0

    # -- rpc plumbing ----------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Expose this master over RPC; returns the bound ``host:port``."""
        self._server = RpcServer(self.dispatch)
        self.addr = self._server.serve(host, port)
        return self.addr

    def dispatch(self, op: str, args: Dict[str, Any]) -> Dict[str, Any]:
        """Route one RPC op to its ``op_*`` handler (the server hook)."""
        handler = getattr(self, f"op_{op}", None)
        if handler is None:
            raise ValueError(f"unknown op {op!r}")
        return handler(**args)

    def stop(self) -> None:
        """Shut down: wake parked polls, stop the keeper and the server."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        self._keeper_stop.set()
        self._keeper_thread.join(timeout=5.0)
        if self._server is not None:
            self._server.stop()
            self._server = None

    # -- handshake / catalogue -------------------------------------------
    def op_hello(self, role: str = "client",
                 name: str = "") -> Dict[str, Any]:
        """Clock/version handshake; a worker's hello registers its beat."""
        with self._cond:
            now = self.now()
            if role == "worker" and name:
                self.keeper.beat(name, now)
                self._cond.notify_all()     # readiness waiters
            return {"now": now, "rpc_version": RPC_VERSION,
                    "catalog_version": self._catalog_version}

    def op_register(self, spec: str,
                    kwargs: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        """Install a runtime by importable factory spec (see runtimes.py).

        The master imports and constructs the definition for its own
        bookkeeping; workers learn the (spec, kwargs) pair and build
        their local copy — the callables never cross the wire."""
        from repro_torch.cluster.runtimes import load_runtime_spec
        rdef = load_runtime_spec(spec, kwargs or {})
        with self._cond:
            self.registry.register(rdef)
            self.store.put(b"\0" * min(rdef.artifact_bytes, 1 << 16),
                           key=f"runtime:{rdef.runtime_id}")
            self._specs.append({"spec": spec, "kwargs": kwargs or {}})
            self._catalog_version += 1
            self._cond.notify_all()         # parked takes re-sync
            return {"runtime_id": rdef.runtime_id,
                    "catalog_version": self._catalog_version}

    def op_runtime_specs(self) -> Dict[str, Any]:
        """The full (spec, kwargs) catalogue + its version (worker sync)."""
        with self._cond:
            return {"specs": list(self._specs),
                    "catalog_version": self._catalog_version}

    # -- data plane ------------------------------------------------------
    def op_put(self, key: str, blob: str,
               raw: bool = False) -> Dict[str, Any]:
        """Install a client/worker blob (base64) under ``key``."""
        self.store.put_serialized(key, decode_blob(blob), raw=bool(raw))
        return {"key": key}

    def op_get(self, key: str) -> Dict[str, Any]:
        """Fetch a blob (base64) + its raw flag; KeyError when absent."""
        blob = self.store.get_raw(key)
        return {"blob": encode_blob(blob), "raw": self.store.is_raw(key)}

    def op_contains(self, key: str) -> Dict[str, Any]:
        """Membership probe for ``key``."""
        return {"present": key in self.store}

    # -- submit / take / settle ------------------------------------------
    def op_submit(self, event: Dict[str, Any]) -> Dict[str, Any]:
        """Publish one client event to the shared queue (async)."""
        inv = inv_from_wire(event)
        with self._cond:
            if self._shutdown:
                raise RuntimeError("master is shutting down")
            if inv.runtime_id not in self.registry:
                raise KeyError(f"unknown runtime {inv.runtime_id!r}")
            if inv.inv_id in self._settled_ids or \
                    inv.inv_id in self._inflight:
                raise ValueError(f"event id {inv.inv_id} already submitted")
            if inv.r_start is None:
                inv.r_start = self.now()
            self._inflight[inv.inv_id] = inv
            self.n_submitted += 1
            self.queue.publish(inv, now=self.now())
            if inv.data_ref:
                # affinity index: route this event to the worker whose
                # cache already holds its input (a chained workflow step
                # lands on its parent's worker and reads locally)
                owner = self._resident.get(inv.data_ref)
                if owner is not None:
                    self._affine.setdefault(owner, set()).add(inv.inv_id)
            self._cond.notify_all()
        return {"inv_id": inv.inv_id}

    def op_take(self, worker: str, supported: List[str],
                max_batch: int = 8,
                timeout_s: float = 10.0) -> Dict[str, Any]:
        """Long-poll for a micro-batch this worker can serve.

        Grants a queue lease per event (holder = worker name) and stamps
        ``n_start``.  Returns early — with no events — when the runtime
        catalogue changes (so the worker re-syncs specs) or on shutdown.
        Parking here counts as a heartbeat."""
        deadline = time.monotonic() + min(float(timeout_s), MAX_POLL_S)
        rids = set(supported)
        with self._cond:
            start_version = self._catalog_version
            while True:
                now = self.now()
                self.keeper.beat(worker, now)
                if self._shutdown:
                    return {"events": [], "shutdown": True,
                            "catalog_version": self._catalog_version}
                inv = self._take_for_worker_locked(worker, rids, now) \
                    if rids else None
                if inv is not None:
                    rdef = self.registry.get(inv.runtime_id)
                    limit = rdef.batch_limit(max(int(max_batch), 1))
                    batch = [inv]
                    while len(batch) < limit:
                        nxt = self.queue.take_matching(
                            inv.runtime_key, now=now, holder=worker)
                        if nxt is None:
                            break
                        batch.append(nxt)
                    for b in batch:
                        b.n_start = max(now, b.r_start or 0.0)
                        b.node = worker
                    counts = self._worker_counts.setdefault(
                        worker, {"n_batches": 0, "n_settled": 0})
                    counts["n_batches"] += 1
                    return {"events": [inv_to_wire(b) for b in batch],
                            "catalog_version": self._catalog_version}
                if self._catalog_version != start_version:
                    return {"events": [],
                            "catalog_version": self._catalog_version}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"events": [],
                            "catalog_version": self._catalog_version}
                # bounded wait chunks double as parked-take heartbeats
                self._cond.wait(timeout=min(remaining, 0.5))

    def _take_for_worker_locked(self, worker: str, rids: set,
                                now: float) -> Optional[Invocation]:
        """One event for ``worker``: affinity first (its cache holds the
        event's input), then the ordinary oldest-first take — skipping
        events still inside another owner's locality defer window."""
        aff = self._affine.get(worker)
        if aff:
            for iid in sorted(aff):
                cand = self._inflight.get(iid)
                if cand is None:
                    aff.discard(iid)        # settled meanwhile
                    continue
                if cand.runtime_id not in rids:
                    continue
                taken = self.queue.take_id(iid, now=now, holder=worker)
                if taken is not None:
                    aff.discard(iid)
                    return taken

        def takeable(cand: Invocation) -> bool:
            if cand.runtime_id not in rids:
                return False
            owner = self._resident.get(cand.data_ref) \
                if cand.data_ref else None
            if owner is None or owner == worker:
                return True
            return now - (cand.r_start or 0.0) >= LOCALITY_DEFER_S
        return self.queue.take_where(takeable, now=now, holder=worker)

    def op_settle(self, worker: str,
                  records: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Apply a worker's settlement records (first settlement wins)."""
        out = []
        with self._cond:
            for rec in records:
                out.append(self._settle_one_locked(worker, rec))
            self._cond.notify_all()
        return {"results": out}

    def _settle_one_locked(self, worker: str,
                           rec: Dict[str, Any]) -> Dict[str, Any]:
        inv_id = int(rec["inv_id"])
        if inv_id in self._settled_ids:
            self.n_duplicate_settles += 1
            return {"inv_id": inv_id, "accepted": False,
                    "reason": "duplicate: already settled"}
        inv = self._inflight.get(inv_id)
        if inv is None:
            self.n_duplicate_settles += 1
            return {"inv_id": inv_id, "accepted": False,
                    "reason": "unknown invocation (master restarted?)"}
        # first settlement wins: ack the live lease whoever holds it, and
        # discard a requeued copy racing toward redelivery — a later
        # settle from the re-taker will be refused as a duplicate
        self.queue.ack(inv_id)
        self.queue.discard(inv_id)
        now = self.now()
        f = rec.get("fields", {})
        inv.node = f.get("node", worker)
        inv.accelerator = f.get("accelerator")
        inv.cold_start = bool(f.get("cold_start"))
        inv.prewarmed = bool(f.get("prewarmed"))
        inv.locality_hit = bool(f.get("locality_hit"))
        # monotone §V-A clamps: a worker's hello-learned clock offset may
        # lag the master's by the handshake RTT; clamp e_start up to the
        # take stamp but preserve the worker-MEASURED duration (ELat must
        # not be squeezed by a clock disagreement), and shift the worker-
        # authored trace spans by the same delta so the assembled span
        # partition stays exact
        base = inv.n_start if inv.n_start is not None \
            else (inv.r_start or 0.0)
        e_start = f.get("e_start")
        e_end = f.get("e_end")
        inv.e_start = max(base, e_start) if e_start is not None else base
        inv.e_end = inv.e_start + max(e_end - e_start, 0.0) \
            if e_start is not None and e_end is not None else inv.e_start
        spans = rec.get("spans")
        if spans and e_start is not None and inv.e_start > e_start:
            delta = inv.e_start - e_start
            for sp in spans:
                if sp.get("t_start") is not None:
                    sp["t_start"] = max(sp["t_start"] + delta, base)
                if sp.get("t_end") is not None:
                    sp["t_end"] = sp["t_end"] + delta
        inv.n_end = max(inv.e_end, now)
        inv.r_end = inv.n_end
        inv.success = bool(f.get("success"))
        inv.error = f.get("error")
        blob = decode_blob(rec["blob"])
        self._record_settlement_locked(inv, blob, spans=rec.get("spans"))
        # the settling worker pre-cached its own outcome — note the
        # residency so a chained child routes to it and reads locally
        self._resident[inv.result_ref] = worker
        while len(self._resident) > RESIDENT_MAX:
            self._resident.pop(next(iter(self._resident)))
        counts = self._worker_counts.setdefault(
            worker, {"n_batches": 0, "n_settled": 0})
        counts["n_settled"] += 1
        return {"inv_id": inv_id, "accepted": True}

    def _record_settlement_locked(self, inv: Invocation, blob: bytes,
                                  spans: Optional[List[Dict[str, Any]]]
                                  = None) -> None:
        """Persist the outcome, fold metrics, append the stream record
        (``spans``: worker-authored trace records riding home with it)."""
        inv.result_ref = self.store.put_serialized(
            f"result:inv{inv.inv_id}", blob)
        self.metrics.record(inv)
        self._inflight.pop(inv.inv_id, None)
        self._settled_ids.add(inv.inv_id)
        self.n_settled += 1
        entry = {"inv": inv_to_wire(inv), "blob": encode_blob(blob)}
        if spans:
            entry["spans"] = spans
        self._settle_log.append(entry)
        self._trim_log_locked()

    def _trim_log_locked(self) -> None:
        overflow = len(self._settle_log) - SETTLE_LOG_MAX
        if overflow > 0:
            del self._settle_log[:overflow]
            self._log_base += overflow

    def _observe_requeue_locked(self, inv: Invocation, holder: str,
                                now: Optional[float], reason: str) -> None:
        """Queue observer (fires under the master lock, inside the keeper
        tick or reap that lost the delivery): author the dead attempt's
        ``abandoned`` span record and stream it to the gateway client as
        a spans-only settlement record."""
        rec = _SPAN_RELAY.record_abandoned(
            inv, holder=holder,
            now=now if now is not None else self.now(), reason=reason)
        if rec is not None:
            self._settle_log.append({"spans": [rec]})
            self._trim_log_locked()

    def _settle_exhausted_locked(self, inv: Invocation, msg: str) -> None:
        """The queue's ``fail_fn``: settle an out-of-attempts event as a
        permanent error record (runs under the master lock, inside the
        keeper tick that exhausted it)."""
        inv.clear_attempt_timestamps()
        inv.success = False
        inv.error = msg
        inv.r_end = max(self.now(), inv.r_start or 0.0)
        blob = pickle.dumps(make_outcome(inv, None, msg))
        self._record_settlement_locked(inv, blob)

    # -- settlement stream (the gateway client's pump) -------------------
    def op_poll_settled(self, since: int = 0, timeout_s: float = 10.0,
                        max_records: int = 256) -> Dict[str, Any]:
        """Long-poll the settlement stream from cursor ``since``.

        Returns ``records`` (each: the settled event's wire dict + its
        outcome blob) and the ``next`` cursor.  Records trimmed past
        :data:`SETTLE_LOG_MAX` are unrecoverable — the single gateway
        pump never falls that far behind."""
        deadline = time.monotonic() + min(float(timeout_s), MAX_POLL_S)
        since = int(since)
        with self._cond:
            while True:
                if since < self._log_base:
                    since = self._log_base
                total = self._log_base + len(self._settle_log)
                if total > since:
                    start = since - self._log_base
                    recs = self._settle_log[start:start + int(max_records)]
                    return {"records": recs, "next": since + len(recs)}
                if self._shutdown:
                    return {"records": [], "next": since, "shutdown": True}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"records": [], "next": since}
                self._cond.wait(timeout=remaining)

    # -- heartbeats / control plane --------------------------------------
    def op_heartbeat(self, worker: str,
                     stats: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """Record a worker beat; reply with its pending directives."""
        with self._cond:
            self.keeper.beat(worker, self.now(), stats)
            pending = self._directives.get(worker)
            directives = []
            while pending:
                directives.append(pending.popleft())
            return {"directives": directives, "now": self.now()}

    def op_prewarm(self, runtime_id: str,
                   config: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """Route a prewarm directive to one live worker (round-robin)."""
        with self._cond:
            if runtime_id not in self.registry:
                raise KeyError(f"unknown runtime {runtime_id!r}")
            alive = self.keeper.alive()
            if not alive:
                return {"worker": None}
            target = alive[self._prewarm_rr % len(alive)]
            self._prewarm_rr += 1
            self._directives.setdefault(target, deque()).append(
                {"op": "prewarm", "runtime_id": runtime_id,
                 "config": config or {}})
            return {"worker": target}

    def op_evict(self, runtime_key: str) -> Dict[str, Any]:
        """Broadcast a warm-handle eviction to every live worker."""
        with self._cond:
            alive = self.keeper.alive()
            for w in alive:
                self._directives.setdefault(w, deque()).append(
                    {"op": "evict", "runtime_key": runtime_key})
            return {"workers": alive}

    def op_pin(self, keys: List[str]) -> Dict[str, Any]:
        """Broadcast the pinned (never-evict) key set to every worker."""
        with self._cond:
            alive = self.keeper.alive()
            for w in alive:
                self._directives.setdefault(w, deque()).append(
                    {"op": "pin", "keys": list(keys)})
            return {"workers": alive}

    # -- observation -----------------------------------------------------
    def op_stats(self) -> Dict[str, Any]:
        """One consistent snapshot of queue/worker/settlement state."""
        with self._cond:
            now = self.now()
            return {
                "now": now,
                "queue_depth": len(self.queue),
                "leased": self.queue.n_leased,
                "by_runtime": self.queue.counts_by_runtime(),
                "submitted": self.n_submitted,
                "settled": self.n_settled,
                "requeued": self.queue.n_requeued,
                "exhausted": self.queue.n_exhausted,
                "duplicate_settles": self.n_duplicate_settles,
                "workers_lost": self.n_workers_lost,
                "catalog_version": self._catalog_version,
                "runtimes": self.registry.ids(),
                "workers": self._worker_report_locked(now),
                "resident_refs": len(self._resident),
                "by_type": self._by_type_locked(now),
            }

    def _by_type_locked(self, now: float) -> Dict[str, Dict[str, int]]:
        """Per-accelerator-type pressure across the live workers —
        ``type -> {queued, busy, free, warm}`` assembled from heartbeat
        stats (``acc_type``/``busy``/``n_warm``) and the queue's runtime
        index (a runtime with no sim profiles is untyped: it runs on any
        worker holding its fn, so it counts toward every type)."""
        out: Dict[str, Dict[str, int]] = {}
        queued_by_rid = self.queue.counts_by_runtime()
        for rep in self.keeper.report(now).values():
            stats = rep.get("stats") or {}
            t = stats.get("acc_type") or HOST_ACC
            row = out.setdefault(t, {"queued": 0, "busy": 0, "free": 0,
                                     "warm": 0})
            busy = int(stats.get("busy", 0))
            row["busy"] += busy
            row["free"] += max(1 - busy, 0)     # one batch slot per worker
            row["warm"] += int(stats.get("n_warm",
                                         len(stats.get("warm_keys") or ())))
        for t, row in out.items():
            row["queued"] = sum(
                cnt for rid, cnt in queued_by_rid.items()
                if rid in self.registry
                and (self.registry.get(rid).supports(t)
                     or not self.registry.get(rid).profiles))
        return out

    def _worker_report_locked(self, now: float) -> Dict[str, Any]:
        """Keeper report with the master-observed take/settle counts
        folded over the heartbeat-carried (and so up to one beat stale)
        worker copies."""
        report = self.keeper.report(now)
        for worker, counts in self._worker_counts.items():
            rep = report.get(worker)
            if rep is None:
                continue
            stats = dict(rep.get("stats") or {})
            for key, seen in counts.items():
                stats[key] = max(int(stats.get(key, 0)), seen)
            rep["stats"] = stats
        return report

    def op_shutdown(self) -> Dict[str, Any]:
        """Flag shutdown: parked takes/polls return, workers exit."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        return {"stopping": True}

    # -- restart persistence ---------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The state a restarted master needs to keep refusing duplicate
        settlement: the settled-id set (in-flight events are the
        client's to resubmit)."""
        with self._cond:
            return {"v": 1, "settled_ids": sorted(self._settled_ids)}

    # -- the keeper tick -------------------------------------------------
    def _keeper_loop(self) -> None:
        """Expire dead workers (missed beats → immediate requeue of their
        leases) and reap per-event lease expiry, every tick."""
        while not self._keeper_stop.wait(self.keeper_interval_s):
            with self._cond:
                if self._shutdown:
                    return
                now = self.now()
                settled_before = self.n_settled
                changed = False
                for worker in self.keeper.expired(now):
                    self.n_workers_lost += 1
                    self._directives.pop(worker, None)
                    self._worker_counts.pop(worker, None)
                    # its cache died with it: drop residency hints and
                    # affinity routing so deferred events free up at once
                    self._affine.pop(worker, None)
                    for ref in [r for r, w in self._resident.items()
                                if w == worker]:
                        del self._resident[ref]
                    if self.queue.release_holder(worker, now):
                        changed = True
                if self.queue.reap(now):
                    changed = True
                # release/reap settle exhausted events through fail_fn
                # without listing them — wake pump waiters for those too
                if changed or self.n_settled != settled_before:
                    self._cond.notify_all()
