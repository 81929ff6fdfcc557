"""Scannable shared invocation queue (Bedrock analogue, §IV-C/D).

The two operations the paper requires of the queue:

* ``take_any(supported)``      — fetch the oldest event whose runtime the
                                 node can run (used when starting new work).
* ``take_matching(runtime_key)`` — after finishing an invocation, fetch an
                                 event with the *same configuration* so the
                                 node reuses the live runtime instance.

Plus ``scan()`` — nodes may inspect the queue *before* taking invocations
(cold-start-avoiding scheduling policies are built on this).

**Indexed hot paths.**  The queue keeps two ready-queue indexes next to
the arrival-order event map — per ``runtime_id`` and per ``runtime_key``
buckets, each in the same global order — so ``take_any`` is O(distinct
runtimes), ``take_matching`` is O(1), and schedulers pick from bucket
heads instead of walking every queued event (``head_for_runtime`` /
``head_for_key`` / ``order_key``).  Global order is a signed sequence
number: publishes append (increasing), at-least-once requeues go to the
head (decreasing), reproducing exactly the order the pre-index scan code
produced.  ``scan()``/``take_where()`` keep the linear reference
behaviour for compatibility and differential testing.

At-least-once delivery: taking an event grants the taker a **visibility
lease** (``lease_s``).  A lease that is never acked — the node died, the
worker crashed, the node stalled past the lease — is *reaped*: the
invocation is requeued at the head of the queue with ``attempt`` bumped,
bounded by the per-runtime retry policy (``RuntimeDef.max_attempts`` via
``configure_retries``); an exhausted event settles as a permanent error
record through ``fail_fn`` instead of being redelivered forever.  Work
survives the node that picked it up.

The reaper is an **expiry min-heap** keyed by lease deadline with lazy
deletion (acks just drop the dict entry; stale heap entries are skipped
when popped): ``reap(now)`` pops until the head deadline is in the
future instead of sweeping every in-flight lease.  The original full sweep
is preserved as :meth:`reap_sweep` — the reference implementation the
differential suite (``tests/test_scale_paths.py``) checks the heap
against; both redeliver the same events in the same order.

The port's copy of ``repro.core.queue`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from typing import Callable, Dict, Iterable, KeysView, List, Optional, Set

from repro_torch.core.events import Invocation

DEFAULT_LEASE_S = 60.0

# depth_timeline stays bounded at large event counts: past this many
# samples the timeline is decimated 2:1 and the sampling stride doubles
# (exact below the cap, uniformly thinned above it)
TIMELINE_CAP = 65536


@dataclasses.dataclass
class Lease:
    """One in-flight delivery: who holds the event and until when."""
    inv: Invocation
    holder: str
    expires_at: float
    serial: int = 0     # take order — the heap tie-break within one deadline


class ScannableQueue:
    def __init__(self, lease_s: float = DEFAULT_LEASE_S):
        self._events: "OrderedDict[int, Invocation]" = OrderedDict()
        self._subscribers: List[Callable[[], None]] = []
        self._leased: Dict[int, Lease] = {}
        self.lease_s = lease_s
        self.n_published = 0
        self.n_taken = 0
        self.n_requeued = 0         # lost deliveries put back (at-least-once)
        self.n_exhausted = 0        # events that ran out of attempts
        self.depth_timeline: List[tuple] = []   # (t, depth) samples
        # ready-queue indexes: per-runtime_id and per-runtime_key buckets,
        # each an OrderedDict in the same global order as _events
        self._by_runtime: Dict[str, "OrderedDict[int, Invocation]"] = {}
        self._by_key: Dict[str, "OrderedDict[int, Invocation]"] = {}
        self._order: Dict[int, int] = {}    # inv_id -> global order key
        self._tail_seq = 0                  # publishes append (increasing)
        self._head_seq = 0                  # requeues prepend (decreasing)
        # expiry heap: (expires_at, serial, Lease) with lazy deletion
        self._expiry_heap: List[tuple] = []
        self._lease_serial = 0
        self._holder_index: Dict[str, Set[int]] = {}
        # bounded depth timeline (decimate + stride-double past the cap)
        self._timeline_stride = 1
        self._timeline_skip = 0
        # retry policy seams, wired by the cluster: max total attempts for
        # an event (per-RuntimeDef), and the permanent-failure settle path
        self._retry_limit_fn: Optional[Callable[[Invocation], int]] = None
        self._fail_fn: Optional[Callable[[Invocation, str], None]] = None
        # tracing seam: observes every lost delivery BEFORE the dead
        # attempt's timestamps are wiped, so the orphaned span can be
        # closed as abandoned with its real dispatch time (repro_torch.obs)
        self._requeue_observer: Optional[
            Callable[[Invocation, str, Optional[float], str], None]] = None

    def set_requeue_observer(
            self, fn: Optional[Callable[[Invocation, str, Optional[float],
                                         str], None]]) -> None:
        """Install ``fn(inv, holder, now, reason)``, called once per lost
        delivery (requeued or exhausted) with the dead attempt's
        timestamps still intact."""
        self._requeue_observer = fn

    def configure_retries(self, retry_limit_fn: Callable[[Invocation], int],
                          fail_fn: Callable[[Invocation, str], None]) -> None:
        """Wire the retry bound (max attempts per event) and the
        permanent-failure settle path used when a lost event exhausts it."""
        self._retry_limit_fn = retry_limit_fn
        self._fail_fn = fail_fn

    # -- index maintenance -----------------------------------------------
    def _index_add(self, inv: Invocation, front: bool = False) -> None:
        if front:
            self._head_seq -= 1
            self._order[inv.inv_id] = self._head_seq
        else:
            self._tail_seq += 1
            self._order[inv.inv_id] = self._tail_seq
        for bucket in (
                self._by_runtime.setdefault(inv.runtime_id, OrderedDict()),
                self._by_key.setdefault(inv.runtime_key, OrderedDict())):
            bucket[inv.inv_id] = inv
            if front:
                bucket.move_to_end(inv.inv_id, last=False)

    def _index_remove(self, inv: Invocation) -> None:
        self._order.pop(inv.inv_id, None)
        bucket = self._by_runtime.get(inv.runtime_id)
        if bucket is not None:
            bucket.pop(inv.inv_id, None)
            if not bucket:
                del self._by_runtime[inv.runtime_id]
        bucket = self._by_key.get(inv.runtime_key)
        if bucket is not None:
            bucket.pop(inv.inv_id, None)
            if not bucket:
                del self._by_key[inv.runtime_key]

    def _sample_depth(self, now: float) -> None:
        self._timeline_skip += 1
        if self._timeline_skip < self._timeline_stride:
            return
        self._timeline_skip = 0
        self.depth_timeline.append((now, len(self._events)))
        if len(self.depth_timeline) >= TIMELINE_CAP:
            del self.depth_timeline[::2]
            self._timeline_stride *= 2

    # -- publishing ------------------------------------------------------
    def publish(self, inv: Invocation, now: Optional[float] = None) -> None:
        self._events[inv.inv_id] = inv
        self._index_add(inv)
        self.n_published += 1
        if now is not None:
            self._sample_depth(now)
        for fn in list(self._subscribers):
            fn()

    def subscribe(self, fn: Callable[[], None]) -> None:
        """Node managers subscribe to be kicked on new work."""
        self._subscribers.append(fn)

    # -- scanning / taking -------------------------------------------------
    def scan(self) -> Iterable[Invocation]:
        """Read-only view in arrival order (the paper's queue-scan)."""
        return self._events.values()

    # -- indexed read-only views (schedulers pick from bucket heads) -----
    def runtime_ids_present(self) -> KeysView:
        """Runtime ids with at least one queued event (live view)."""
        return self._by_runtime.keys()

    def runtime_keys_present(self) -> KeysView:
        """Runtime keys with at least one queued event (live view)."""
        return self._by_key.keys()

    def head_for_runtime(self, runtime_id: str) -> Optional[Invocation]:
        """Oldest queued event for ``runtime_id`` (peek; O(1))."""
        bucket = self._by_runtime.get(runtime_id)
        return next(iter(bucket.values())) if bucket else None

    def head_for_key(self, runtime_key: str) -> Optional[Invocation]:
        """Oldest queued event for ``runtime_key`` (peek; O(1))."""
        bucket = self._by_key.get(runtime_key)
        return next(iter(bucket.values())) if bucket else None

    def bucket_for_key(self, runtime_key: str) -> Iterable[Invocation]:
        """All queued events for one runtime_key, oldest first (live view —
        do not mutate the queue while iterating)."""
        bucket = self._by_key.get(runtime_key)
        return bucket.values() if bucket else ()

    def order_key(self, inv: Invocation) -> int:
        """Global queue position of a queued event (smaller = older, the
        exact order ``scan()`` yields; requeued events sort negative)."""
        return self._order[inv.inv_id]

    def counts_by_runtime(self) -> Dict[str, int]:
        """Queued event count per runtime_id (O(distinct runtimes))."""
        return {rid: len(bucket) for rid, bucket in self._by_runtime.items()}

    def _take(self, inv_id: int, now: Optional[float],
              holder: Optional[str]) -> Invocation:
        inv = self._events.pop(inv_id)
        self._index_remove(inv)
        self.n_taken += 1
        t = now if now is not None else 0.0
        self._lease_serial += 1
        lease = Lease(inv, holder or "<unknown>", t + self.lease_s,
                      serial=self._lease_serial)
        self._leased[inv_id] = lease
        heapq.heappush(self._expiry_heap,
                       (lease.expires_at, lease.serial, lease))
        self._holder_index.setdefault(lease.holder, set()).add(inv_id)
        if now is not None:
            self._sample_depth(now)
        return inv

    def take_any(self, supported: Set[str], now: Optional[float] = None,
                 holder: Optional[str] = None) -> Optional[Invocation]:
        # the oldest queued event whose runtime the taker supports —
        # min over the supported buckets' heads, not a full scan
        best: Optional[Invocation] = None
        best_seq = 0
        present = self._by_runtime
        # iterate the smaller side of the intersection
        rids = supported if len(supported) <= len(present) else \
            [r for r in present if r in supported]
        for rid in rids:
            bucket = present.get(rid)
            if not bucket:
                continue
            head = next(iter(bucket.values()))
            seq = self._order[head.inv_id]
            if best is None or seq < best_seq:
                best, best_seq = head, seq
        if best is None:
            return None
        return self._take(best.inv_id, now, holder)

    def take_matching(self, runtime_key: str, now: Optional[float] = None,
                      holder: Optional[str] = None) -> Optional[Invocation]:
        bucket = self._by_key.get(runtime_key)
        if not bucket:
            return None
        inv_id = next(iter(bucket))
        return self._take(inv_id, now, holder)

    def take_id(self, inv_id: int, now: Optional[float] = None,
                holder: Optional[str] = None) -> Optional[Invocation]:
        """Take a specific queued event by id (O(1)); None when absent —
        what a scheduler calls after picking from an indexed head."""
        if inv_id not in self._events:
            return None
        return self._take(inv_id, now, holder)

    def take_where(self, pred: Callable[[Invocation], bool],
                   now: Optional[float] = None,
                   holder: Optional[str] = None) -> Optional[Invocation]:
        for inv in self._events.values():
            if pred(inv):
                return self._take(inv.inv_id, now, holder)
        return None

    # -- leases (at-least-once delivery) ---------------------------------
    @property
    def n_leased(self) -> int:
        """In-flight deliveries (taken, not yet acked)."""
        return len(self._leased)

    def holder_of(self, inv_id: int) -> Optional[str]:
        """Who currently holds the event's lease (None when not leased)."""
        lease = self._leased.get(inv_id)
        return lease.holder if lease is not None else None

    def _drop_lease(self, lease: Lease) -> None:
        del self._leased[lease.inv.inv_id]
        held = self._holder_index.get(lease.holder)
        if held is not None:
            held.discard(lease.inv.inv_id)
            if not held:
                del self._holder_index[lease.holder]

    def ack(self, inv_id: int) -> bool:
        """Release an event's lease on settlement; True when it was held.
        An unacked lease eventually expires and redelivers the event.
        (The expiry-heap entry is dropped lazily when popped.)"""
        lease = self._leased.get(inv_id)
        if lease is None:
            return False
        self._drop_lease(lease)
        return True

    def discard(self, inv_id: int) -> bool:
        """Remove a (re)queued event without delivering it — the original
        taker settled it after its lease had already expired (at-least-once
        duplicate suppression: first settlement wins)."""
        inv = self._events.pop(inv_id, None)
        if inv is None:
            return False
        self._index_remove(inv)
        return True

    def reap(self, now: float) -> List[Invocation]:
        """Requeue every expired lease; returns the redelivered events.
        Exhausted events settle as permanent failures via ``fail_fn``.

        Pop-until-future over the expiry min-heap: cost is O(expired),
        not O(in-flight).  Stale heap entries (acked, or re-leased after a
        redelivery) are skipped — validity is "this exact Lease object is
        still the live lease for its event"."""
        expired: List[Lease] = []
        while self._expiry_heap and self._expiry_heap[0][0] <= now:
            _, _, lease = heapq.heappop(self._expiry_heap)
            if self._leased.get(lease.inv.inv_id) is lease:
                expired.append(lease)
        return self._redeliver(expired, now, "lease expired")

    def reap_sweep(self, now: float) -> List[Invocation]:
        """The original reference reaper: full sweep over every in-flight
        lease.  Semantically identical to :meth:`reap` (the differential
        suite asserts it); O(in-flight) per call.  Heap entries of the
        swept leases go stale and are skipped by later ``reap`` pops."""
        expired = [lease for lease in self._leased.values()
                   if lease.expires_at <= now]
        return self._redeliver(expired, now, "lease expired")

    def release_holder(self, holder: str,
                       now: Optional[float] = None) -> List[Invocation]:
        """Requeue every lease held by ``holder`` immediately — crash
        recovery when a node is known dead (no need to wait out the
        lease); returns the redelivered events."""
        held = self._holder_index.get(holder, ())
        lost = sorted((self._leased[i] for i in held),
                      key=lambda lease: lease.serial)
        return self._redeliver(lost, now, f"node {holder!r} lost")

    def _redeliver(self, leases: List[Lease], now: Optional[float],
                   reason: str) -> List[Invocation]:
        requeued: List[Invocation] = []
        for lease in leases:
            self._drop_lease(lease)
            inv = lease.inv
            if inv.r_end is not None:
                continue            # settled late without ack — just drop
            if self._requeue_observer is not None:
                self._requeue_observer(inv, lease.holder, now, reason)
            limit = self._retry_limit_fn(inv) if self._retry_limit_fn \
                else 1
            if inv.attempt + 1 < limit:
                inv.reset_for_retry()
                self._events[inv.inv_id] = inv
                # retries go to the head: the event has already waited a
                # full lease longer than anything behind it
                self._events.move_to_end(inv.inv_id, last=False)
                self._index_add(inv, front=True)
                self.n_requeued += 1
                requeued.append(inv)
            else:
                inv.retries_exhausted = True
                self.n_exhausted += 1
                msg = (f"retries exhausted after {inv.attempt + 1} "
                       f"attempt(s): {reason}")
                if self._fail_fn is not None:
                    self._fail_fn(inv, msg)
        if requeued:
            if now is not None:
                self._sample_depth(now)
            for fn in list(self._subscribers):
                fn()
        return requeued

    def __len__(self) -> int:
        return len(self._events)
