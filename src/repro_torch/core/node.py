"""Node manager (§IV-D): owns local accelerators, starts/stops runtime
instances, pulls invocations from the shared queue, moves data through the
object store, and signals completion.

The node is written against the cluster clock so identical code drives the
calibrated simulation and the real-execution mode (where runtime ``fn``
actually runs the model, on the card, and ELat is measured wall time).

The port's copy of ``repro.core.node`` (the port imports nothing of
``repro``); only docstrings and imports differ. A real ``fn`` is timed
on the host clock with no synchronisation added: its ELat is honest when
``fn`` returns after its result reaches the host, as the serve runtime's
does (the engine's step ends by reading the greedy tokens).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Set

from repro_torch.core.accelerator import Accelerator
from repro_torch.core.events import Invocation
from repro_torch.core.queue import ScannableQueue
from repro_torch.obs import TRACER
from repro_torch.core.runtime import RuntimeRegistry
from repro_torch.core.scheduler import Scheduler, WarmAffinityScheduler
from repro_torch.core.storage import ObjectStore, unwrap_outcome

PICKUP_LATENCY_S = 0.003     # queue -> node RPC
CLIENT_NOTIFY_S = 0.002      # node -> client completion signal


class NodeManager:
    def __init__(self, name: str, accelerators: List[Accelerator], *,
                 clock, queue: ScannableQueue, store: ObjectStore,
                 registry: RuntimeRegistry, metrics,
                 scheduler: Optional[Scheduler] = None,
                 idle_timeout_s: float = 60.0, max_warm: int = 4,
                 invocation_timeout_s: Optional[float] = None,
                 seed: int = 0):
        self.name = name
        self.accelerators = accelerators
        self.clock = clock
        self.queue = queue
        self.store = store
        self.registry = registry
        self.metrics = metrics
        self.scheduler = scheduler or WarmAffinityScheduler()
        self.idle_timeout = idle_timeout_s
        self.max_warm = max_warm
        self.invocation_timeout = invocation_timeout_s
        self.rng = random.Random(seed)
        self.n_cold_starts = 0
        self.n_warm_starts = 0
        self.n_prewarms = 0
        self.n_locality_hits = 0     # inputs read from this node's own
        #                              resident copies (no store round trip)
        self._wakeups: Set[float] = set()    # pending locality-defer wakes
        self.draining = False        # set by the autoscaler: finish current
        #                              work, take no new events
        self.dead = False            # fault injection: node crashed — its
        #                              in-flight work is lost (lease requeue)
        self.stalled_until = -1.0    # fault injection: hung until this time
        self.pinned: Set[str] = set()    # min-warm keys exempt from eviction
        self._real_handles: Dict[str, object] = {}   # runtime_key -> setup()
        # one pending idle-eviction check per (accelerator, runtime_key) —
        # not one per completion, which would pile a clock event on every
        # settle at 1M-event scale
        self._idle_checks: Set[tuple] = set()
        queue.subscribe(self._on_publish)

    # ------------------------------------------------------------------
    @property
    def acc_types(self):
        return {a.spec.type for a in self.accelerators}

    def _on_publish(self) -> None:
        # kick asynchronously so publishing N events wakes the node once each
        self.clock.call_in(0.0, self.try_start_work)

    # ------------------------------------------------------------------
    # -- fault injection (repro_torch.core.faults drives these) ----------------
    def kill(self) -> None:
        """Crash this node: in-flight work is lost (the fault injector
        requeues its leases), warm instances and slot state are gone, and
        it never takes another event.  ``draining`` is set too so fleet /
        capacity accounting stops counting the corpse."""
        self.dead = True
        self.draining = True
        for acc in self.accelerators:
            acc.busy_slots = 0
            acc.warm.clear()
            acc.prewarmed.clear()
        self._real_handles.clear()
        # local result copies die with the node: drop the residency hints
        # so placement falls back to store round-trips (the blobs
        # themselves were persisted to the store at completion)
        self.store.drop_resident(self.name)

    def stall(self, duration_s: float) -> None:
        """Hang this node for ``duration_s``: it takes no new events and
        completes nothing until the stall ends — long stalls expire the
        visibility leases of its in-flight work, which redelivers the
        events elsewhere (a late completion after redelivery is dropped:
        first settlement wins)."""
        now = self.clock.now()
        self.stalled_until = max(self.stalled_until, now + duration_s)
        self.clock.call_at(self.stalled_until, self.try_start_work)

    @property
    def stalled(self) -> bool:
        return self.clock.now() < self.stalled_until

    # ------------------------------------------------------------------
    def schedule_wakeup(self, at: float) -> None:
        """Re-arm ``try_start_work`` at ``at`` — the objective schedulers
        call this when they defer a remote-resident event so its owner can
        claim it; without the wake the defer window would strand the event
        on an otherwise idle fleet.  Deduplicated per wake time."""
        if at in self._wakeups:
            return
        self._wakeups.add(at)

        def fire():
            self._wakeups.discard(at)
            self.try_start_work()
        self.clock.call_at(at, fire)

    def try_start_work(self) -> None:
        """Pull work while capacity remains (paper Fig. 1 select loop)."""
        if self.draining or self.dead or self.stalled:
            return
        while True:
            decision = self.scheduler.pick(self.queue, self,
                                           self.clock.now())
            if decision is None:
                return
            inv, acc = decision
            if self._expired(inv):
                self._fail(inv, "timeout-in-queue")
                continue
            self._dispatch(inv, acc)

    def _expired(self, inv: Invocation) -> bool:
        return (self.invocation_timeout is not None and
                self.clock.now() - inv.r_start > self.invocation_timeout)

    # ------------------------------------------------------------------
    def _dispatch(self, inv: Invocation, acc: Accelerator) -> None:
        now = self.clock.now()
        inv.n_start = now + PICKUP_LATENCY_S
        inv.node = self.name
        inv.accelerator = f"{acc.local_id}({acc.spec.type})"
        acc.acquire()
        rdef = self.registry.get(inv.runtime_id)
        prof = rdef.profiles[acc.spec.type]

        warm = acc.has_warm(inv.runtime_key)
        cold_start = 0.0 if warm else prof.cold_start_s
        inv.cold_start = not warm
        if warm:
            self.n_warm_starts += 1
            # first hit on a control-plane-prewarmed instance: the warmth
            # is policy-attributable, not luck-of-the-LRU
            inv.prewarmed = inv.runtime_key in acc.prewarmed
            acc.prewarmed.discard(inv.runtime_key)
        else:
            self.n_cold_starts += 1
            for victim in acc.mark_warm(inv.runtime_key, now, self.max_warm,
                                        pinned=self.pinned):
                self._real_handles.pop(victim, None)

        # stateless: fetch the data set before running (§IV-A) — unless
        # this very node produced the input (a parent workflow step ran
        # here), in which case it reads its own resident copy: no store
        # probe, no transfer, and the round-trip counters stay flat
        local = bool(inv.data_ref) and \
            self.store.resident_on(inv.data_ref) == self.name and \
            self.store.peek_size(inv.data_ref) is not None
        inv.locality_hit = local
        if local:
            fetch = 0.0
            self.n_locality_hits += 1
            self.store.n_local_reads += 1
        else:
            fetch = (self.store.transfer_time(inv.data_ref)
                     if inv.data_ref in self.store else self.store.rtt)
        inv.e_start = inv.n_start + cold_start + fetch
        if TRACER.enabled and inv.trace_id is not None and cold_start > 0.0:
            # stamped in virtual time at dispatch (the duration is not
            # recoverable from the settled record), so traces stay
            # deterministic; parent id is deterministic too (repro_torch.obs)
            root = inv.span_id or f"inv{inv.inv_id}"
            TRACER.complete(
                "cold_start", inv.n_start, inv.n_start + cold_start,
                trace=inv.trace_id,
                span_id=f"{root}/a{inv.attempt}/cold_start",
                parent=f"{root}/a{inv.attempt}/dispatch",
                attrs={"runtime": inv.runtime_id, "node": self.name})

        # pin the delivery this completion belongs to: if the lease is
        # reaped and the event redelivered (possibly back to *this* node),
        # inv.attempt advances and the stale closure must be dropped
        att = inv.attempt
        if rdef.fn is not None:
            # real execution: run now (simulation time advances by wall time)
            if local:
                data = unwrap_outcome(self.store.peek(inv.data_ref))
            else:
                data = unwrap_outcome(self.store.get(inv.data_ref)) \
                    if inv.data_ref in self.store else None
            if not warm and rdef.setup is not None and \
                    inv.runtime_key not in self._real_handles:
                self._real_handles[inv.runtime_key] = rdef.setup()
            import time as _time
            t0 = _time.monotonic()
            try:
                result = rdef.fn(data, dict(inv.config,
                                            handle=self._real_handles.get(inv.runtime_key)))
                err = None
            except Exception as e:   # execution failure -> unsuccessful event
                result, err = None, repr(e)
            elat = _time.monotonic() - t0
            self.clock.call_at(inv.e_start + elat,
                               lambda: self._complete(inv, acc, result, err,
                                                      att))
        else:
            elat = prof.sample_elat(self.rng)
            self.clock.call_at(inv.e_start + elat,
                               lambda: self._complete(inv, acc, None, None,
                                                      att))

    # ------------------------------------------------------------------
    def _complete(self, inv: Invocation, acc: Accelerator,
                  result, err: Optional[str], attempt: int) -> None:
        if self.dead:
            return          # the crash lost this work; leases redeliver it
        now = self.clock.now()
        if self.stalled:
            # the node is hung: nothing completes until the stall ends
            self.clock.call_at(self.stalled_until,
                               lambda: self._complete(inv, acc, result, err,
                                                      attempt))
            return
        if inv.r_end is not None or inv.attempt != attempt or \
                self.queue.holder_of(inv.inv_id) != self.name:
            # our visibility lease was reaped (the event was redelivered —
            # and possibly already settled — elsewhere, or re-taken by this
            # very node as a newer attempt): an at-least-once duplicate
            # completion.  Drop it and free the slot; the settlement of
            # record belongs to the current delivery.
            acc.release()
            self.try_start_work()
            return
        self.queue.ack(inv.inv_id)
        inv.e_end = now
        rdef = self.registry.get(inv.runtime_id)
        prof = rdef.profiles[acc.spec.type]
        upload = self.store.transfer_time_bytes(prof.result_bytes)
        inv.n_end = now + upload
        inv.r_end = inv.n_end + CLIENT_NOTIFY_S
        if err is None and self._expired_at(inv.r_end, inv):
            err = "timeout-at-completion"
        inv.error = err
        inv.success = err is None
        # persist the outcome envelope in object storage (§IV-A: results
        # land in the store; gateway futures poll this key) — a failure
        # keeps its partial result alongside the error
        self.store.persist_outcome(inv, result, err)
        # the producing node keeps its result resident: a dependent
        # workflow step placed here reads it locally (data locality)
        self.store.note_resident(inv.result_ref, self.name)
        acc.mark_warm(inv.runtime_key, now, self.max_warm,
                      pinned=self.pinned)
        acc.total_busy_time += inv.e_end - (inv.e_start or now)
        acc.n_executions += 1
        acc.release()
        self.metrics.record(inv)
        if TRACER.enabled:
            TRACER.record_invocation(inv, emit_cold=False)
        self._schedule_idle_check(acc, inv.runtime_key)

        # paper behaviour: immediately look for a SAME-configuration event
        # to reuse the live instance, then fall back to the general loop.
        match = (self.queue.take_matching(inv.runtime_key, now,
                                          holder=self.name)
                 if getattr(self.scheduler, "reuse_on_complete", True)
                 and not self.draining else None)
        if match is not None:
            if self._expired(match):
                self._fail(match, "timeout-in-queue")
            else:
                self._dispatch(match, acc)
        self.try_start_work()

    def _expired_at(self, t: float, inv: Invocation) -> bool:
        return (self.invocation_timeout is not None and
                t - inv.r_start > self.invocation_timeout)

    def _fail(self, inv: Invocation, reason: str) -> None:
        now = self.clock.now()
        self.queue.ack(inv.inv_id)      # we hold the lease from the take
        inv.n_start = inv.n_start or now
        inv.r_end = now
        inv.success = False
        inv.error = reason
        self.store.persist_outcome(inv, None, reason)   # for store pollers
        self.metrics.record(inv)
        if TRACER.enabled:
            TRACER.record_invocation(inv, emit_cold=False)

    def _schedule_idle_check(self, acc: Accelerator, runtime_key: str,
                             at: Optional[float] = None) -> None:
        # dedup: at most one pending check per (acc, key); a check that
        # finds the instance not-yet-idle reschedules itself at the exact
        # eviction time, so eviction still happens at t_last_use + timeout
        tag = (acc.local_id, runtime_key)
        if tag in self._idle_checks:
            return
        self._idle_checks.add(tag)
        t = at if at is not None else self.clock.now() + self.idle_timeout
        self.clock.call_at(
            t, lambda: self._maybe_scale_to_zero(acc, runtime_key))

    def _maybe_scale_to_zero(self, acc: Accelerator, runtime_key: str) -> None:
        self._idle_checks.discard((acc.local_id, runtime_key))
        if runtime_key in self.pinned:       # min-warm floor holds it
            return
        t_idle = acc.warm.get(runtime_key)
        if t_idle is None:
            return                           # evicted / never resident
        if self.clock.now() - t_idle >= self.idle_timeout - 1e-9:
            acc.evict(runtime_key)
            self._real_handles.pop(runtime_key, None)
        else:
            # used since the check was scheduled: re-arm at the time the
            # instance will actually have been idle for the full timeout
            self._schedule_idle_check(acc, runtime_key,
                                      at=t_idle + self.idle_timeout)

    # -- control-plane actuation ----------------------------------------
    def prewarm(self, runtime_key: str, acc: Accelerator,
                cold_start_s: float, setup=None) -> None:
        """Install a warm instance for ``runtime_key`` on ``acc`` off the
        critical path: the instance becomes resident ``cold_start_s`` from
        now (process spawn + model load happen in the background, without
        holding an execution slot), and the first event it serves is
        attributed ``prewarmed`` instead of paying the cold start."""
        def ready():
            if self.draining or acc.has_warm(runtime_key):
                return
            for victim in acc.mark_warm(runtime_key, self.clock.now(),
                                        self.max_warm, pinned=self.pinned):
                self._real_handles.pop(victim, None)
            acc.prewarmed.add(runtime_key)
            if setup is not None and runtime_key not in self._real_handles:
                self._real_handles[runtime_key] = setup()
            self.n_prewarms += 1
            # a warm instance may unblock a queued same-config event
            self.try_start_work()
        self.clock.call_in(cold_start_s, ready)

    def evict_warm(self, runtime_key: str) -> bool:
        """Evict a warm instance everywhere on this node (keep-alive TTL
        expiry); True when something was resident."""
        hit = False
        for acc in self.accelerators:
            if acc.has_warm(runtime_key):
                acc.evict(runtime_key)
                hit = True
        self._real_handles.pop(runtime_key, None)
        return hit

    # ------------------------------------------------------------------
    def utilization(self, horizon: float) -> Dict[str, float]:
        return {a.local_id: a.total_busy_time / max(horizon, 1e-9) / a.spec.slots
                for a in self.accelerators}
