"""Asynchronous invocation futures.

Hardless events are async-only (§IV-B): the client gets a handle at submit
time and the result lands in object storage.  ``InvocationFuture`` is that
handle — ``poll()`` is the non-blocking completion check, ``result()`` the
blocking wait.

Completion is **callback-driven**, not polled: the store's outcome key for
an event is deterministic (``result:inv<id>``), so the future registers a
one-shot ``ObjectStore.on_settle`` watcher (lazily, on first use — a
million outstanding futures cost nothing until someone waits on one) that
trips a ``threading.Event`` and fires any ``add_done_callback`` hooks the
moment the outcome record is persisted.  ``result()`` then blocks on the
backend's event-driven ``wait()`` (no sleep loop, no repeated store
membership probes); backends without a per-event wait fall back to a full
drain.

The port's copy of ``repro.gateway.future`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from repro_torch.core.events import Invocation
from repro_torch.core.storage import unwrap_outcome


class InvocationError(RuntimeError):
    """The invocation completed unsuccessfully (execution error/timeout)."""

    def __init__(self, inv: Invocation):
        super().__init__(f"invocation {inv.inv_id} "
                         f"({inv.runtime_id}) failed: {inv.error}")
        self.invocation = inv


class InvocationRejected(InvocationError):
    """The backend shed this event at admission: it never executed, so
    retrying later is safe.  Sheds come from the engine's bounded queue
    (backpressure) or from an attached control plane — per-tenant
    token-bucket quotas and weighted fair-share limits
    (``repro_torch.controlplane.admission``); the reason is in
    ``invocation.error``."""


class InvocationRetriesExhausted(InvocationError):
    """Every delivery attempt was lost (node death, worker crash, lease
    expiry) up to the runtime's ``max_attempts`` bound: the event settled
    as a permanent error record.  Distinct from
    :class:`InvocationRejected` — the platform *tried* (possibly several
    times); blind resubmission will likely fail the same way."""


class InvocationFuture:
    """Async handle for one submitted event (returned by ``invoke()``)."""

    def __init__(self, inv: Invocation, backend):
        self.invocation = inv
        self._backend = backend
        self._settled: Optional[threading.Event] = None
        self._callbacks: List[Callable[["InvocationFuture"], None]] = []
        self._cb_lock = threading.Lock()
        self._cb_fired = False

    # -- inspection ----------------------------------------------------
    @property
    def inv_id(self) -> int:
        """The underlying invocation's id (result key ``result:inv<id>``)."""
        return self.invocation.inv_id

    @property
    def result_key(self) -> str:
        """The deterministic object-store key the outcome settles under."""
        return f"result:inv{self.invocation.inv_id}"

    def done(self) -> bool:
        """True once the invocation settled (successfully or not)."""
        return self.invocation.r_end is not None

    def rejected(self) -> bool:
        """True when admission backpressure shed this event unexecuted."""
        return self.invocation.rejected

    # -- completion callbacks ------------------------------------------
    def _ensure_watch(self) -> threading.Event:
        """Lazily register the store settlement watcher (one-shot; created
        on first wait/callback so idle futures stay free)."""
        if self._settled is None:
            self._settled = threading.Event()
            self._backend.store.on_settle(self.result_key, self._on_settle)
        return self._settled

    def _on_settle(self) -> None:
        """Store watcher: the outcome record just landed."""
        if self._settled is not None:
            self._settled.set()
        self._fire_callbacks()

    def _fire_callbacks(self) -> None:
        with self._cb_lock:
            if self._cb_fired:
                return
            self._cb_fired = True
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            fn(self)

    def add_done_callback(self,
                          fn: Callable[["InvocationFuture"], None]) -> None:
        """Call ``fn(self)`` when the outcome record lands (immediately if
        it already has).  Runs on the settling thread; must not block.
        Note the outcome is persisted just *before* the invocation's
        ``r_end`` is stamped — use ``result()``/``wait`` for a handle
        that is fully settled."""
        with self._cb_lock:
            pending = not self._cb_fired
            if pending:
                self._callbacks.append(fn)
        if pending:
            self._ensure_watch()
        else:
            fn(self)        # already settled and flushed: fire now

    def poll(self) -> bool:
        """Non-blocking completion check — the serverless client's "is my
        result there yet?" probe.  Callback-armed: after the first call no
        store lookups happen again (the settlement watcher flips a local
        event)."""
        if self.done():
            return True
        # first probe arms the watcher (which fires immediately when the
        # outcome is already stored); later probes read the local event
        return self._ensure_watch().is_set()

    @property
    def elat(self) -> Optional[float]:
        """Execution latency of the settled event (None while in flight)."""
        return self.invocation.elat

    @property
    def rlat(self) -> Optional[float]:
        """Request latency of the settled event (None while in flight)."""
        return self.invocation.rlat

    # -- blocking wait -------------------------------------------------
    def result(self, *, extra_time_s: float = 600.0) -> Any:
        """Block until the invocation settles; return the stored result.

        Event-driven: the wait parks on the backend's settlement
        condition (engine) or advances the virtual clock (sim) — no
        sleep-and-poll loop against the object store.  Raises
        :class:`InvocationRejected` if the event was shed by
        backpressure, :class:`InvocationRetriesExhausted` when every
        delivery attempt was lost, :class:`InvocationError` on execution
        failure, ``TimeoutError`` if the backend drains without the event
        settling.  The stored outcome envelope is unwrapped to its value
        — a runtime that returned ``None`` yields ``None``, not
        bookkeeping.
        """
        if not self.done():
            wait = getattr(self._backend, "wait", None)
            if wait is not None:
                wait(self.invocation, timeout_s=extra_time_s)
            else:
                self._backend.drain(extra_time_s=extra_time_s)
        if not self.done():
            raise TimeoutError(
                f"invocation {self.inv_id} did not settle within drain "
                f"window (+{extra_time_s}s)")
        inv = self.invocation
        if not inv.success:
            if inv.rejected:
                raise InvocationRejected(inv)
            if inv.retries_exhausted:
                raise InvocationRetriesExhausted(inv)
            raise InvocationError(inv)
        if inv.result_ref is not None:
            try:
                return unwrap_outcome(self._backend.store.get(inv.result_ref))
            except KeyError:
                return None     # outcome record evicted (outcome_max cap)
        return None
