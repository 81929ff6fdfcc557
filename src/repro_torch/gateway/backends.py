"""Execution backends behind the invocation gateway (the port's copy of
``repro.gateway.backends``).

Backends speak one tiny protocol (register / submit / drain + shared
``store``/``registry``/``metrics``), so client code written against the
gateway runs unchanged on any of them:

* :class:`EngineBackend` — real concurrent execution on this host's CUDA
  devices (or on the host with ``device="cpu"``): a worker thread per
  card pulls micro-batches of
  compatible pending events (same ``runtime_key``) from a bounded
  admission queue, pads them to bucket shapes, and serves each batch with
  one ``RuntimeDef.batch_fn`` call (falling back to per-event ``fn``).
  Cold start is ``setup()`` (weights and cache on the card, e.g. a
  ``serve.engine.ServingEngine``), warm start reuses the live handle
  keyed on the paper's same-configuration ``runtime_key``.

The reference's ``SimBackend`` (the event-driven cluster simulation) needs
the simulation core, and its control-plane surface (``CapacityHooks``,
prewarm, pinning, worker retargeting, admission through a controller)
needs the control plane; neither is ported yet. Only the device model
differs from the reference: PyTorch's current device is per thread, so
each worker enters its card around the cold start and the batch it runs.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Set

import torch

from repro_torch.core.events import Invocation
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.runtime import (HOST_ACC, RuntimeDef, RuntimeRegistry,
                                      run_batch)
from repro_torch.core.storage import ObjectStore, unwrap_outcome
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import TRACER


class Backend:
    """Minimal contract the gateway needs from an execution substrate."""

    name = "base"
    store: ObjectStore
    registry: RuntimeRegistry
    metrics: MetricsCollector
    # True when submitted work makes progress without the client driving it
    # (the engine's worker threads); False when progress requires the client
    # to advance a clock (the sim).  The workflow runner uses this to decide
    # between a background driver thread and pull-driven stepping.
    autonomous = False

    def register(self, rdef: RuntimeDef) -> None:
        """Publish ``rdef`` into this backend's runtime catalogue."""
        raise NotImplementedError

    def submit(self, inv: Invocation) -> None:
        """Accept one event for execution (asynchronous; returns at once)."""
        raise NotImplementedError

    def drain(self, extra_time_s: float = 600.0) -> None:
        """Block until every submitted invocation has settled."""
        raise NotImplementedError

    def now(self) -> float:
        """Current time on this backend's clock (virtual or wall seconds)."""
        raise NotImplementedError

    def backlog(self) -> int:
        """Submitted-but-unsettled event count (0 when fully drained)."""
        raise NotImplementedError

    def backlog_by_type(self) -> Dict[str, Dict[str, int]]:
        """Per-accelerator-type pressure: ``type -> {queued, busy, free,
        warm}`` (the operator's heterogeneity view).  ``{}`` when the
        backend has no typed view; the aggregate :meth:`backlog` remains
        the authoritative event count."""
        return {}

    def wait_any(self, invs: Sequence[Invocation],
                 timeout_s: float = 600.0) -> bool:
        """Block until at least one of ``invs`` settles (r_end set).

        Returns False when the wait cannot make progress within
        ``timeout_s`` — wall seconds on an autonomous backend, virtual
        seconds on the sim.  The workflow runner's "a dependency just
        resolved" primitive.
        """
        raise NotImplementedError



class _KeyQueue:
    """Pending events for one ``runtime_key`` (one warm instance)."""

    __slots__ = ("items", "deadline")

    def __init__(self):
        self.items: Deque[Invocation] = deque()
        self.deadline: Optional[float] = None   # batch-close wall deadline


class EngineBackend(Backend):
    """Real concurrent execution on this host's CUDA devices.

    Dispatcher shape:

    * **admission** — ``submit()`` enqueues into a per-``runtime_key``
      pending queue under one bounded budget (``max_queue`` unsettled
      events).  Over budget, the event is *shed*: it settles immediately
      as an unsuccessful, ``rejected`` invocation whose failure record is
      persisted like any other outcome — backpressure surfaced through
      the ordinary gateway future.
    * **workers** — one thread per card (``n_workers`` overrides; with
      ``device="cpu"`` one host worker).  Each worker claims the oldest
      *ready* key, takes up to ``min(max_batch, rdef.max_batch)`` events
      from it, and executes them as one micro-batch.  A key is ready when
      its batch is full or its oldest event has waited ``batch_wait_s``
      (the max-wait deadline that keeps latency from starving on a
      trickle of traffic).
    * **per-key serialization** — at most one worker runs a given
      ``runtime_key`` at a time (a warm instance is single-threaded, the
      paper's runtime-instance model); concurrency comes from distinct
      keys on distinct workers, throughput within a key from batching.
    * **warm pool** — one LRU pool of ``runtime_key -> setup()`` handles
      (``max_warm``) shared across workers, exactly as before.

    Batches are padded to the runtime's ``batch_buckets`` so a
    ``batch_fn`` sees a bounded set of leading batch shapes.

    ``device`` is where the workers run: ``None`` (the default) means the
    cards, and raises here when there is none, as every entry point of
    the port does; ``"cuda:N"`` one card; ``"cpu"`` the host, which is
    what the CPU tests pass. There is no silent fallback to the host.
    """

    name = "engine"
    autonomous = True       # worker threads progress without client driving
    MONITOR_INTERVAL_S = 0.05   # the worker monitor's tick

    def __init__(self, *, max_warm: int = 4,
                 n_workers: Optional[int] = None, max_batch: int = 8,
                 batch_wait_s: float = 0.002, max_queue: int = 256,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.store = ObjectStore()
        self.registry = RuntimeRegistry()
        self.metrics = MetricsCollector()
        self.max_warm = max_warm
        self.accelerator = HOST_ACC
        self.max_batch = max(int(max_batch), 1)
        self.batch_wait_s = max(float(batch_wait_s), 0.0)
        self.max_queue = max(int(max_queue), 1)
        self.n_cold_starts = 0
        self.n_warm_starts = 0
        self.n_rejected = 0
        self.n_worker_crashes = 0    # dead worker threads the monitor reaped
        self.n_requeued = 0          # stranded events redelivered
        self.n_retries_exhausted = 0
        self.n_batches = 0
        self.batch_sizes: List[int] = []
        self._handles: "OrderedDict[str, Any]" = OrderedDict()
        self._t0 = time.monotonic()

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)     # pending changed
        self._settled = threading.Condition(self._lock)  # events settled
        self._queues: "OrderedDict[str, _KeyQueue]" = OrderedDict()
        self._busy_keys: set = set()
        self._n_pending = 0
        self._n_inflight = 0
        self._n_workers_req = n_workers
        self.n_workers: Optional[int] = None     # fixed at the first submit
        self._started = False
        self._threads: Dict[int, threading.Thread] = {}
        self._devices: List[Any] = []
        self._shutdown = False
        # worker supervision: widx -> (runtime_key, batch) for every batch
        # claimed but not yet finished; the monitor thread requeues-or-
        # fails batches whose worker thread died and respawns to target
        self._inflight_batches: Dict[int, tuple] = {}
        self._crash_widx: Set[int] = set()   # fault injection (crash_worker)
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()

    # -- lifecycle -------------------------------------------------------
    def _start_workers_locked(self) -> None:
        if self._started or self._shutdown:
            return
        self._started = True
        if self.device.type == "cuda":
            self._devices = [self.device] if self.device.index is not None \
                else [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())]
        n = self._n_workers_req
        if n is None:
            n = len(self._devices) or 1
        self.n_workers = max(int(n), 1)
        self._spawn_to_target_locked()
        if self._monitor is None or not self._monitor.is_alive():
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="engine-monitor",
                daemon=True)
            self._monitor.start()

    def _spawn_to_target_locked(self) -> None:
        for w in range(self.n_workers):
            t = self._threads.get(w)
            if t is None or not t.is_alive():
                # a dead thread may still own an in-flight batch (it
                # crashed between two monitor ticks): recover it BEFORE a
                # new thread takes over the widx, or the batch's entry is
                # overwritten and its events strand forever
                if t is not None and w in self._inflight_batches:
                    key, batch = self._inflight_batches.pop(w)
                    self._busy_keys.discard(key)
                    self._n_inflight -= len(batch)
                    self.n_worker_crashes += 1
                    self._recover_batch_locked(batch)
                    self._settled.notify_all()
                t = threading.Thread(target=self._worker_loop, args=(w,),
                                     name=f"engine-w{w}", daemon=True)
                self._threads[w] = t
                t.start()

    def shutdown(self) -> None:
        """Stop the worker threads (pending events are left unsettled)."""
        with self._lock:
            self._shutdown = True
            self._work.notify_all()
        self._monitor_stop.set()
        for t in list(self._threads.values()):
            t.join(timeout=5.0)
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)

    # -- fault injection -------------------------------------------------
    def crash_worker(self, widx: int) -> None:
        """Fault injection: worker ``widx`` dies abruptly the next time it
        claims a batch — the thread exits mid-flight without settling or
        releasing anything, exactly the state the worker monitor must
        detect and recover (requeue/fail the batch, respawn to target)."""
        with self._lock:
            self._crash_widx.add(widx)
            self._work.notify_all()

    def now(self) -> float:
        """Wall seconds since this backend was constructed."""
        return time.monotonic() - self._t0

    # -- catalogue -------------------------------------------------------
    def register(self, rdef: RuntimeDef) -> None:
        """Publish a *real* runtime (must have ``fn``/``batch_fn``)."""
        if not rdef.is_real:
            raise ValueError(
                f"runtime {rdef.runtime_id!r} has no real fn/batch_fn — the "
                f"engine backend executes actual code; use the sim backend "
                f"for profile-only runtimes")
        self.registry.register(rdef)
        self.store.put(b"\0" * min(rdef.artifact_bytes, 1 << 16),
                       key=f"runtime:{rdef.runtime_id}")

    # -- admission (bounded; sheds on overload) --------------------------
    def submit(self, inv: Invocation) -> None:
        """Enqueue one event (sheds it as ``rejected`` over ``max_queue``)."""
        if inv.runtime_id not in self.registry:
            raise KeyError(f"unknown runtime {inv.runtime_id!r}")
        inv.r_start = self.now() if inv.r_start is None else inv.r_start
        with self._lock:
            if self._shutdown:
                # no workers will ever serve this — settle it immediately
                # instead of stranding it in the queue
                self._reject_locked(
                    inv, err="rejected: engine backend is shut down")
                return
            if self._n_pending + self._n_inflight >= self.max_queue:
                self._reject_locked(inv)
                return
            self._start_workers_locked()
            kq = self._queues.get(inv.runtime_key)
            if kq is None:
                kq = self._queues[inv.runtime_key] = _KeyQueue()
            if not kq.items:
                kq.deadline = time.monotonic() + self.batch_wait_s
            kq.items.append(inv)
            self._n_pending += 1
            self._work.notify()

    def _reject_locked(self, inv: Invocation,
                       err: Optional[str] = None) -> None:
        """Settle a shed event as a rejected, unsuccessful one."""
        now = self.now()
        inv.n_start = inv.e_start = inv.e_end = inv.n_end = \
            max(now, inv.r_start or 0.0)
        inv.r_end = inv.n_end
        inv.rejected = True
        inv.success = False
        inv.error = err or (f"rejected: engine admission queue full "
                            f"({self.max_queue} unsettled events) — "
                            f"backpressure")
        self.store.persist_outcome(inv, None, inv.error)
        self.metrics.record(inv)
        if TRACER.enabled:
            TRACER.record_invocation(inv)
        self.n_rejected += 1
        self._settled.notify_all()

    # -- completion waits ------------------------------------------------
    def backlog(self) -> int:
        """Pending + in-flight event count (the backpressure signal)."""
        with self._lock:
            return self._n_pending + self._n_inflight

    def backlog_by_type(self) -> Dict[str, Dict[str, int]]:
        """Single-type view: everything on this host's accelerator."""
        with self._lock:
            workers = self.n_workers or self._n_workers_req or 1
            return {self.accelerator: {
                "queued": self._n_pending,
                "busy": self._n_inflight,
                "free": max(workers - len(self._busy_keys), 0),
                "warm": len(self._handles)}}

    def drain(self, extra_time_s: float = 600.0) -> None:
        """Block until the dispatcher is idle (or ``extra_time_s`` elapses).
        Event-driven: parks on the settlement condition until notified
        (every settle path notifies ``_settled``), no poll tick."""
        deadline = time.monotonic() + extra_time_s
        with self._lock:
            while self._n_pending or self._n_inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._settled.wait(timeout=remaining)

    def wait(self, inv: Invocation, timeout_s: float = 600.0) -> bool:
        """Block until ``inv`` settles (per-event wait — no full drain,
        no poll tick: woken by the settlement condition)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while inv.r_end is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._settled.wait(timeout=remaining)
        return inv.r_end is not None

    def wait_any(self, invs: Sequence[Invocation],
                 timeout_s: float = 600.0) -> bool:
        """Block until at least one of ``invs`` settles (workers progress
        in the background); False when ``timeout_s`` wall seconds elapse
        first.  Woken by the settlement condition, no poll tick."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while not any(i.r_end is not None for i in invs):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._settled.wait(timeout=remaining)
        return True

    # -- dispatcher ------------------------------------------------------
    def _ready_locked(self, key: str, kq: _KeyQueue, now: float) -> bool:
        rdef = self.registry.get(kq.items[0].runtime_id)
        limit = rdef.batch_limit(self.max_batch)
        return len(kq.items) >= limit or \
            (kq.deadline is not None and now >= kq.deadline)

    def _pick_locked(self):
        """(batch, key) ready to run, or (None, earliest deadline|None)."""
        now = time.monotonic()
        best_key, best_start = None, None
        wake_at = None
        for key, kq in self._queues.items():
            if key in self._busy_keys or not kq.items:
                continue
            head_start = kq.items[0].r_start or 0.0
            if self._ready_locked(key, kq, now):
                if best_key is None or head_start < best_start:
                    best_key, best_start = key, head_start
            elif kq.deadline is not None:
                wake_at = kq.deadline if wake_at is None else \
                    min(wake_at, kq.deadline)
        if best_key is None:
            return None, wake_at
        kq = self._queues[best_key]
        rdef = self.registry.get(kq.items[0].runtime_id)
        limit = rdef.batch_limit(self.max_batch)
        batch = [kq.items.popleft() for _ in range(min(limit, len(kq.items)))]
        if kq.items:
            kq.deadline = time.monotonic() + self.batch_wait_s
        else:
            del self._queues[best_key]      # bounded key map
        self._busy_keys.add(best_key)
        self._n_pending -= len(batch)
        self._n_inflight += len(batch)
        return batch, best_key

    def _worker_loop(self, widx: int) -> None:
        while True:
            with self._lock:
                batch = None
                while batch is None:
                    if self._shutdown:
                        return
                    batch, key_or_wake = self._pick_locked()
                    if batch is None:
                        timeout = None if key_or_wake is None else \
                            max(key_or_wake - time.monotonic(), 0.0)
                        self._work.wait(timeout=timeout)
                key = key_or_wake
                self._inflight_batches[widx] = (key, batch)
                if widx in self._crash_widx:
                    # injected fault: the thread dies abruptly holding a
                    # batch — no settle, no bookkeeping release.  The
                    # monitor must find the dead thread and recover.
                    self._crash_widx.discard(widx)
                    return
            try:
                self._execute_batch(widx, batch)
            except Exception as e:  # noqa: BLE001 — never kill the worker
                self._settle_failed(batch, f"engine dispatcher error: {e!r}")
            finally:
                with self._lock:
                    self._inflight_batches.pop(widx, None)
                    self._busy_keys.discard(key)
                    self._n_inflight -= len(batch)
                    self._work.notify_all()
                    self._settled.notify_all()

    # -- worker supervision (at-least-once past thread death) ------------
    def _monitor_loop(self) -> None:
        """Detect dead ``engine-w*`` threads, requeue-or-fail their
        in-flight batch, and respawn workers to target.  ``_settle_failed``
        only covers exceptions *inside* a live worker; this covers the
        worker itself dying (injected crash, or a bug that escapes the
        loop) so no event is ever stranded."""
        while True:
            with self._lock:
                if self._shutdown:
                    return
                self._reap_dead_workers_locked()
            self._monitor_stop.wait(self.MONITOR_INTERVAL_S)

    def _reap_dead_workers_locked(self) -> None:
        recovered = False
        for widx, (key, batch) in list(self._inflight_batches.items()):
            t = self._threads.get(widx)
            if t is not None and t.is_alive():
                continue
            del self._inflight_batches[widx]
            self._busy_keys.discard(key)
            self._n_inflight -= len(batch)
            self.n_worker_crashes += 1
            self._recover_batch_locked(batch)
            recovered = True
        if self._started:
            self._spawn_to_target_locked()  # heal crashed-thread deficits
        if recovered:
            self._work.notify_all()
            self._settled.notify_all()

    def _recover_batch_locked(self, batch: List[Invocation]) -> None:
        """Redeliver a dead worker's batch (``attempt`` bumped, bounded by
        the runtime's ``max_attempts``); exhausted events settle as
        permanent error records."""
        now = self.now()
        retries: List[Invocation] = []
        for inv in batch:
            if inv.r_end is not None:
                continue
            if TRACER.enabled:
                # close the dead attempt's span as abandoned while its
                # timestamps are still intact (reset_for_retry wipes them)
                TRACER.record_abandoned(inv, holder="engine-worker",
                                        now=now, reason="worker crashed")
            rdef = self.registry.get(inv.runtime_id)
            if inv.attempt + 1 < rdef.max_attempts:
                inv.reset_for_retry()
                retries.append(inv)
                self.n_requeued += 1
            else:
                inv.retries_exhausted = True
                inv.clear_attempt_timestamps()
                inv.r_end = max(now, inv.r_start or 0.0)
                inv.success = False
                inv.error = (f"retries exhausted after {inv.attempt + 1} "
                             f"attempt(s): worker crashed mid-batch")
                self.n_retries_exhausted += 1
                try:
                    self.store.persist_outcome(inv, None, inv.error)
                except Exception:   # noqa: BLE001 — store itself broken
                    pass
                self.metrics.record(inv)
                if TRACER.enabled:
                    TRACER.record_invocation(inv)
        if retries:
            # one batch is always one runtime_key; redeliver at the head
            key = retries[0].runtime_key
            kq = self._queues.get(key)
            if kq is None:
                kq = self._queues[key] = _KeyQueue()
            kq.items.extendleft(reversed(retries))
            kq.deadline = time.monotonic()      # ready immediately
            self._n_pending += len(retries)

    def _settle_failed(self, batch: List[Invocation], err: str) -> None:
        """Last-resort settlement: a dispatcher bug or unserializable
        outcome must fail the events, not strand them (a dead worker would
        leave every pending event unsettled forever)."""
        now = self.now()
        with self._lock:
            for inv in batch:
                if inv.r_end is not None:
                    continue
                inv.n_start = inv.n_start if inv.n_start is not None \
                    else max(now, inv.r_start or 0.0)
                inv.e_start = inv.e_start if inv.e_start is not None \
                    else inv.n_start
                inv.e_end = max(inv.e_start, now)
                inv.n_end = inv.e_end
                inv.r_end = inv.n_end
                inv.success = False
                inv.error = err
                try:
                    self.store.persist_outcome(inv, None, err)
                except Exception:   # noqa: BLE001 — store itself broken
                    pass
                self.metrics.record(inv)
                if TRACER.enabled:
                    TRACER.record_invocation(inv)

    # -- execution -------------------------------------------------------
    def _acquire_handle(self, rdef: RuntimeDef, key: str):
        """(handle, cold, err) for one warm instance; LRU insert on cold,
        dropping the least recently used handles over ``max_warm``."""
        if rdef.setup is None:
            with self._lock:
                self.n_cold_starts += 1
            return None, True, None
        with self._lock:
            if key in self._handles:
                self.n_warm_starts += 1
                self._handles.move_to_end(key)
                return self._handles[key], False, None
            self.n_cold_starts += 1
        try:
            handle = rdef.setup()           # slow: weights (unlocked)
        except Exception as e:  # noqa: BLE001 — unsuccessful event
            return None, True, f"cold-start failed: {e!r}"
        with self._lock:
            self._handles[key] = handle
            while len(self._handles) > self.max_warm:
                self._handles.popitem(last=False)
        return handle, True, None

    def _execute_batch(self, widx: int, batch: List[Invocation]) -> None:
        rdef = self.registry.get(batch[0].runtime_id)
        key = batch[0].runtime_key
        acc = f"local/w{widx}({self.accelerator})"
        for inv in batch:
            inv.n_start = max(self.now(), inv.r_start or 0.0)
            inv.node = f"local/w{widx}"
            inv.accelerator = acc

        t_acq = self.now()
        with self._on_device(widx):         # a cold start lands on this card
            handle, cold, err = self._acquire_handle(rdef, key)
        cold_s = (self.now() - t_acq) if cold else 0.0  # measured setup()
        for inv in batch:
            inv.cold_start = cold

        datas = [unwrap_outcome(self.store.get(inv.data_ref))
                 if inv.data_ref in self.store else None for inv in batch]
        e_start = max([self.now()] + [inv.n_start for inv in batch])
        t0 = self.now()
        results: List[Any] = [None] * len(batch)
        if err is None:
            try:
                with self._on_device(widx), self._trace_ctx(batch):
                    results = run_batch(
                        rdef, datas,
                        dict(batch[0].config, handle=handle,
                             attempts=[inv.attempt for inv in batch]))
            except Exception as e:  # noqa: BLE001 — unsuccessful events
                err = repr(e)
        e_end = e_start + (self.now() - t0)     # measured wall ELat

        # persist outcomes before taking the dispatcher lock (pickling a
        # large result must not stall submit() or the other workers); the
        # events only become visible as settled (r_end) under the lock
        errs: List[Optional[str]] = []
        for inv, result in zip(batch, results):
            inv.e_start, inv.e_end = e_start, e_end
            inv_err = err
            try:
                self.store.persist_outcome(inv, result, inv_err)
            except Exception as e:  # noqa: BLE001 — unserializable result
                inv_err = f"result persist failed: {e!r}"
                self.store.persist_outcome(inv, None, inv_err)
            errs.append(inv_err)

        with self._lock:
            self.n_batches += 1
            self.batch_sizes.append(len(batch))
            for inv, inv_err in zip(batch, errs):
                if inv.r_end is not None:
                    continue        # already settled (duplicate delivery)
                inv.n_end = inv.e_end
                inv.r_end = max(self.now(), inv.n_end)
                inv.success = inv_err is None
                inv.error = inv_err
                self.metrics.record(inv)
                if TRACER.enabled:
                    TRACER.record_invocation(
                        inv, cold_s=cold_s,
                        batch_window_s=self.batch_wait_s)

    def _trace_ctx(self, batch: List[Invocation]):
        """Trace context for the batch's ``run_batch`` call: serving-engine
        spans (prefill/decode) emitted during execution nest under the
        lead invocation's ``execute`` span."""
        lead = batch[0]
        if not TRACER.enabled or lead.trace_id is None:
            return contextlib.nullcontext()
        root = lead.span_id or f"inv{lead.inv_id}"
        return TRACER.ctx(lead.trace_id, f"{root}/a{lead.attempt}/execute")

    def _on_device(self, widx: int):
        """Make this worker's card the thread's current CUDA device (the
        current device is per thread, so it is entered on the worker
        itself); a null context for host workers. A cold start lands on
        this card. A warm handle that owns a card of its own (a
        ``ServingEngine`` enters its device in ``generate``) launches there
        instead: the handle's card wins over the worker's."""
        if self._devices:
            return torch.cuda.device(self._devices[widx % len(self._devices)])
        return contextlib.nullcontext()

    # -- warm-pool introspection -----------------------------------------
    def warm_keys(self) -> List[str]:
        """Runtime keys with a live warm instance, LRU-oldest first."""
        with self._lock:
            return list(self._handles)

    def handle(self, runtime_key: str) -> Any:
        """The warm ``setup()`` handle for ``runtime_key`` (None if cold)."""
        with self._lock:
            return self._handles.get(runtime_key)
