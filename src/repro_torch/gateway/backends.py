"""Execution backends behind the invocation gateway (the port's copy of
``repro.gateway.backends``).

Both speak the same tiny protocol (register / submit / drain + shared
``store``/``registry``/``metrics``), so client code written against the
gateway runs unchanged on either:

* :class:`SimBackend`    — the event-driven cluster simulation
  (``core.cluster.Cluster``): scannable queue, node managers, calibrated
  service times, discrete-event clock.  A runtime with a real ``fn`` runs
  inside virtual time (on the card, for the serve runtime), its ELat the
  measured wall time.
* :class:`EngineBackend` — real concurrent execution on this host's CUDA
  devices (or on the host with ``device="cpu"``): a worker thread per
  card pulls micro-batches of
  compatible pending events (same ``runtime_key``) from a bounded
  admission queue, pads them to bucket shapes, and serves each batch with
  one ``RuntimeDef.batch_fn`` call (falling back to per-event ``fn``).
  Cold start is ``setup()`` (weights and cache on the card, e.g. a
  ``serve.engine.ServingEngine``), warm start reuses the live handle
  keyed on the paper's same-configuration ``runtime_key``.

Both expose the control plane's :class:`CapacityHooks`.  Only the device
model differs from the reference: PyTorch's current device is per thread,
so each worker enters its card around the cold start and the batch it
runs, and a prewarm (on the control plane's tick thread) enters a
worker's card before ``setup()``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Set

import torch

from repro_torch.core.accelerator import AcceleratorSpec
from repro_torch.core.cluster import Cluster
from repro_torch.core.events import Invocation, runtime_key_for
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.runtime import (HOST_ACC, RuntimeDef, RuntimeRegistry,
                                      run_batch)
from repro_torch.core.storage import ObjectStore, unwrap_outcome
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import TRACER


class CapacityHooks:
    """The control plane's actuation + observation surface on a backend.

    Capacity is counted in backend-native *units* — whole accelerator
    nodes on the sim cluster, dispatcher workers (one per device) on the
    engine — so one policy drives both.  Observation methods are cheap
    and safe to call from a control-plane tick (sim: clock callback;
    engine: background thread); actuation methods never block on work.
    """

    # -- observation -----------------------------------------------------
    def capacity(self) -> int:
        """Current capacity units (live + being retired counts as live)."""
        raise NotImplementedError

    def pending(self) -> int:
        """Units being provisioned (requested but not serving yet)."""
        raise NotImplementedError

    def queue_depth(self) -> int:
        """Events admitted but not yet executing."""
        raise NotImplementedError

    def inflight(self) -> int:
        """Events currently executing."""
        raise NotImplementedError

    def backlog_by_runtime(self) -> Dict[str, int]:
        """Queued event count per runtime_id (fair-share accounting)."""
        raise NotImplementedError

    def warm_state(self) -> Dict[str, float]:
        """runtime_key -> idle seconds for every resident warm instance."""
        raise NotImplementedError

    def warm_count(self, runtime_key: str) -> int:
        """Resident + in-flight-prewarm instances for ``runtime_key``."""
        raise NotImplementedError

    # -- actuation -------------------------------------------------------
    def set_target(self, n: int) -> None:
        """Request capacity = ``n`` units (provision/drain the delta)."""
        raise NotImplementedError

    def prewarm(self, runtime_id: str,
                config: Optional[Dict[str, Any]] = None) -> bool:
        """Install one warm instance for (runtime, config) off the
        critical path; False when nothing could be prewarmed (no
        capacity, unsupported runtime, or already in progress)."""
        raise NotImplementedError

    def evict(self, runtime_key: str) -> bool:
        """Evict a warm instance (keep-alive TTL expiry)."""
        raise NotImplementedError

    def pin(self, keys: Set[str]) -> None:
        """Exempt ``keys`` from idle/LRU eviction (min-warm floors)."""
        raise NotImplementedError


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
    # an attached ControlPlane (repro_torch.controlplane).  When set, submit()
    # routes every event through controller.admit() — quota/fair-share
    # sheds settle as ``rejected`` through the ordinary future path — and
    # arrivals feed the telemetry bus.
    controller = None

    def capacity_hooks(self) -> CapacityHooks:
        """This backend's control-plane actuation surface (cached)."""
        raise NotImplementedError

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


class SimBackend(Backend):
    """The calibrated discrete-event cluster behind the gateway API."""

    name = "sim"

    def __init__(self, cluster: Optional[Cluster] = None, **cluster_kwargs):
        self.cluster = cluster or Cluster(**cluster_kwargs)
        self.store = self.cluster.store
        self.registry = self.cluster.registry
        self.metrics = self.cluster.metrics
        self._n_submitted = 0
        self._hooks: Optional["SimCapacityHooks"] = None

    def register(self, rdef: RuntimeDef) -> None:
        """Publish ``rdef`` into the cluster's registry + object store."""
        self.cluster.register_runtime(rdef)

    def submit(self, inv: Invocation) -> None:
        """Schedule the event's publication at its RStart on the sim clock
        (admission-gated at arrival time when a control plane is attached)."""
        self._n_submitted += 1
        gate = None
        if self.controller is not None:
            gate = lambda i: self.controller.admit(  # noqa: E731
                i, self.cluster.clock.now())
        self.cluster.submit(inv, gate=gate)

    def capacity_hooks(self, spec: Optional[AcceleratorSpec] = None,
                       specs: Optional[Sequence[AcceleratorSpec]] = None,
                       node_prefix: str = "cp",
                       provision_delay_s: float = 45.0,
                       objective: str = "latency"
                       ) -> "SimCapacityHooks":
        """Control-plane surface over this cluster.  ``spec`` is the node
        template scale-out provisions (default: the first accelerator spec
        already in the cluster); pass ``specs`` (several templates) for a
        heterogeneous fleet whose scale-out picks the type ``objective``
        favours — cheapest $/slot (``cost``), lowest watts (``energy``) or
        fastest profile (``latency``).  Built once and cached."""
        if self._hooks is None:
            if specs is None:
                if spec is None:
                    for node in self.cluster.nodes:
                        if node.accelerators:
                            spec = node.accelerators[0].spec
                            break
                if spec is None:
                    raise ValueError(
                        "empty cluster: pass spec= for the node "
                        "template capacity_hooks should provision")
                specs = [spec]
            self._hooks = SimCapacityHooks(
                self, list(specs), node_prefix=node_prefix,
                provision_delay_s=provision_delay_s, objective=objective)
        return self._hooks

    def drain(self, extra_time_s: float = 600.0) -> None:
        """Run the clock far enough past the last RStart for all to finish."""
        self.cluster.drain(extra_time_s=extra_time_s)

    def now(self) -> float:
        """Current virtual time."""
        return self.cluster.clock.now()

    def backlog(self) -> int:
        """Submitted events whose completion has not been recorded yet."""
        return self._n_submitted - self.metrics.n_recorded

    def backlog_by_type(self) -> Dict[str, Dict[str, int]]:
        """Per-accelerator-type queue/slot/warm pressure on the cluster."""
        return self.cluster.backlog_by_type()

    def wait(self, inv: Invocation, timeout_s: float = 600.0) -> bool:
        """Advance the virtual clock until ``inv`` settles (per-event wait
        — futures no longer fall back to a full drain on the sim)."""
        return self.wait_any([inv], timeout_s=timeout_s)

    def wait_any(self, invs: Sequence[Invocation],
                 timeout_s: float = 600.0) -> bool:
        """Advance the virtual clock event-by-event until one of ``invs``
        settles.  ``timeout_s`` bounds the *virtual* time advanced (periodic
        timers such as the autoscaler tick keep the heap non-empty forever,
        so an unbounded step loop would spin).  False = nothing settled —
        either the bound was hit or the event heap drained, meaning the
        events can never complete (e.g. no node supports the runtime)."""
        clock = self.cluster.clock
        bound = clock.now() + timeout_s
        while not any(i.r_end is not None for i in invs):
            if clock.now() > bound or not clock.step():
                return False
        return True


class SimCapacityHooks(CapacityHooks):
    """Control-plane actuation over the sim cluster: capacity units are
    whole nodes (driven through the same :class:`~repro_torch.core.autoscaler.
    NodeFleet` actuator the legacy queue-pressure autoscaler uses), warm
    instances live on accelerators, prewarm is the node manager's
    off-critical-path instance install.

    With several node templates (``specs``) the hooks keep one fleet per
    accelerator type and route scale-out to the type the ``objective``
    favours — but only while the SLO holds (:meth:`note_slo`): a violated
    SLO always buys the fastest type, so cost/energy never trade away
    attainment."""

    def __init__(self, backend: SimBackend, spec, node_prefix: str = "cp",
                 provision_delay_s: float = 45.0,
                 objective: str = "latency"):
        from repro_torch.core.autoscaler import NodeFleet
        self.backend = backend
        self.cluster = backend.cluster
        self.objective = objective
        self._slo_ok = True
        specs = list(spec) if isinstance(spec, (list, tuple)) else [spec]
        self.fleets: List[Any] = []
        for s in specs:
            prefix = node_prefix if len(specs) == 1 \
                else f"{node_prefix}-{s.type}"
            self.fleets.append(NodeFleet(
                self.cluster, s, node_prefix=prefix,
                provision_delay_s=provision_delay_s))
        self.fleet = self.fleets[0]     # legacy single-template view
        self._prewarming: Set[tuple] = set()    # (acc local_id, runtime_key)

    # -- objective-aware template choice ---------------------------------
    def note_slo(self, ok: bool) -> None:
        """SLO health signal from the scaler's tick: while the SLO is
        violated, cost/energy objectives fall back to latency-first
        provisioning (spend whatever it takes to restore attainment)."""
        self._slo_ok = bool(ok)

    def _mean_elat(self, spec: AcceleratorSpec) -> float:
        """Mean profile ELat of registered runtimes on ``spec``'s type
        (inf when nothing registered runs there — never provision it)."""
        reg = self.cluster.registry
        elats = [reg.get(rid).profiles[spec.type].elat_median_s
                 for rid in reg.ids() if reg.get(rid).supports(spec.type)]
        return sum(elats) / len(elats) if elats else float("inf")

    def _template_rank(self, spec: AcceleratorSpec) -> tuple:
        """Sort key: lower = more preferred for scale-out/prewarm."""
        if self.objective == "cost" and self._slo_ok:
            return (spec.cost_per_hour / max(spec.slots, 1),
                    self._mean_elat(spec))
        if self.objective == "energy" and self._slo_ok:
            return (spec.active_watts / max(spec.slots, 1),
                    self._mean_elat(spec))
        return (self._mean_elat(spec), spec.cost_per_hour)

    def _fleets_ranked(self) -> List[Any]:
        """Fleets most-preferred first (provision order); usable types
        (some registered runtime runs there) always rank ahead."""
        return sorted(
            self.fleets,
            key=lambda f: (self._mean_elat(f.spec) == float("inf"),
                           self._template_rank(f.spec)))

    # -- observation -----------------------------------------------------
    def capacity(self) -> int:
        """Non-draining nodes (seed + managed)."""
        return len(self.fleet.active_nodes)

    def pending(self) -> int:
        """Nodes mid-provision (bring-up delay) across every fleet."""
        return sum(f.pending for f in self.fleets)

    def queue_depth(self) -> int:
        """Published events not yet taken by a node."""
        return len(self.cluster.queue)

    def inflight(self) -> int:
        """Busy accelerator slots across the cluster."""
        return sum(a.busy_slots for n in self.cluster.nodes
                   for a in n.accelerators)

    def backlog_by_runtime(self) -> Dict[str, int]:
        """Queued events per runtime (the queue's ready-queue index —
        O(distinct runtimes), not a scan)."""
        return self.cluster.queue.counts_by_runtime()

    def warm_state(self) -> Dict[str, float]:
        """Min idle seconds per warm runtime_key across accelerators."""
        now = self.cluster.clock.now()
        idle: Dict[str, float] = {}
        for node in self.cluster.nodes:
            for acc in node.accelerators:
                for key, t in acc.warm.items():
                    cur = now - t
                    idle[key] = min(idle.get(key, cur), cur)
        return idle

    def warm_count(self, runtime_key: str) -> int:
        """Accelerators holding the key warm + in-flight prewarms."""
        resident = sum(1 for n in self.cluster.nodes
                       for a in n.accelerators if a.has_warm(runtime_key))
        pending = sum(1 for _, k in self._prewarming if k == runtime_key)
        return resident + pending

    # -- actuation -------------------------------------------------------
    def set_target(self, n: int) -> None:
        """Provision/drain whole nodes toward ``n`` active units.  With
        several templates, scale-out buys the objective's preferred type
        and scale-in retires the least preferred managed nodes first."""
        for f in self.fleets:
            f.account()
        ranked = self._fleets_ranked()
        current = len(self.fleet.active_nodes) + self.pending()
        if n > current:
            ranked[0].provision(n - current)
        else:
            for _ in range(len(self.fleet.active_nodes) - n):
                if not any(f.drain_one() is not None
                           for f in reversed(ranked)):
                    break       # only managed nodes are drainable

    def prewarm(self, runtime_id: str,
                config: Optional[Dict[str, Any]] = None) -> bool:
        """Install one warm instance on a supporting accelerator, off the
        critical path (resident after the profile's cold-start delay).
        Candidate accelerators are ranked by the objective — warm capacity
        lands on the cheapest/most-frugal type that still holds the SLO
        (stable sort: a homogeneous fleet keeps its insertion order)."""
        rdef = self.cluster.registry.get(runtime_id)
        key = runtime_key_for(runtime_id, config)
        cands = [(node, acc) for node in self.cluster.nodes
                 if not node.draining for acc in node.accelerators
                 if rdef.supports(acc.spec.type)]
        cands.sort(key=lambda na: self._template_rank(na[1].spec))
        for node, acc in cands:
            tag = (acc.local_id, key)
            if acc.has_warm(key) or tag in self._prewarming:
                continue
            self._prewarming.add(tag)
            prof = rdef.profiles[acc.spec.type]
            node.prewarm(key, acc, prof.cold_start_s, setup=rdef.setup)
            # the in-flight marker clears when the instance lands
            self.cluster.clock.call_in(
                prof.cold_start_s,
                lambda tag=tag: self._prewarming.discard(tag))
            return True
        return False

    def evict(self, runtime_key: str) -> bool:
        """Evict the key's warm instances on every node."""
        return any([node.evict_warm(runtime_key)
                    for node in self.cluster.nodes])

    def pin(self, keys: Set[str]) -> None:
        """Exempt ``keys`` from idle/LRU eviction on every node."""
        for node in self.cluster.nodes:
            node.pinned = set(keys)


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
    * **workers** — one thread per card (``n_workers`` overrides; workers
      beyond the card count share the cards, ``widx % cards``; with
      ``device="cpu"`` one host worker).  Each worker claims the oldest
      *ready* key, takes up to
      ``min(max_batch, rdef.max_batch)`` events from it, and executes
      them as one micro-batch.  A key is ready when its batch is full or
      its oldest event has waited ``batch_wait_s`` (the max-wait deadline
      that keeps latency from starving on a trickle of traffic).
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

    def __init__(self, *, max_warm: int = 4,
                 n_workers: Optional[int] = None, max_batch: int = 8,
                 batch_wait_s: float = 0.002, max_queue: int = 256,
                 monitor_interval_s: float = 0.05,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._devices: List[Any] = []
        if self.device.type == "cuda":
            self._devices = [self.device] if self.device.index is not None \
                else [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())]
        self.store = ObjectStore()
        self.registry = RuntimeRegistry()
        self.metrics = MetricsCollector()
        self.max_warm = max_warm
        self.accelerator = HOST_ACC
        self.max_batch = max(int(max_batch), 1)
        self.batch_wait_s = max(float(batch_wait_s), 0.0)
        self.max_queue = max(int(max_queue), 1)
        self.monitor_interval_s = max(float(monitor_interval_s), 1e-3)
        self.n_cold_starts = 0
        self.n_warm_starts = 0
        self.n_prewarms = 0
        self.n_rejected = 0
        self.n_worker_crashes = 0    # dead worker threads the monitor reaped
        self.n_requeued = 0          # stranded events redelivered
        self.n_retries_exhausted = 0
        self.n_batches = 0
        self.batch_sizes: List[int] = []
        self._handles: "OrderedDict[str, Any]" = OrderedDict()
        self._handle_idle_since: Dict[str, float] = {}
        self._pinned: Set[str] = set()       # min-warm keys, never evicted
        self._prewarmed: Set[str] = set()    # installed by prewarm, unserved
        self._prewarming: Set[str] = set()   # setup() in progress off-path
        self._t0 = time.monotonic()

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)     # pending changed
        self._settled = threading.Condition(self._lock)  # events settled
        self._queues: "OrderedDict[str, _KeyQueue]" = OrderedDict()
        self._busy_keys: set = set()
        self._n_pending = 0
        self._n_inflight = 0
        self._n_workers_req = n_workers
        self._target_workers: Optional[int] = None   # set_n_workers intent
        self.n_workers: Optional[int] = None     # fixed at the first submit
        self._started = False
        self._threads: Dict[int, threading.Thread] = {}
        self._shutdown = False
        self._hooks: Optional["EngineCapacityHooks"] = None
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
        if self._target_workers is None:
            n = self._n_workers_req
            if n is None:
                n = len(self._devices) or 1
            self._target_workers = max(int(n), 1)
        self.n_workers = self._target_workers
        self._spawn_to_target_locked()
        if self._monitor is None or not self._monitor.is_alive():
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="engine-monitor",
                daemon=True)
            self._monitor.start()

    def _spawn_to_target_locked(self) -> None:
        for w in range(self._target_workers):
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

    def set_n_workers(self, n: int) -> None:
        """Retarget the worker count (the control plane's capacity knob):
        extra workers spawn immediately; excess workers retire as soon as
        they finish their current batch."""
        with self._lock:
            self._target_workers = max(int(n), 1)
            self.n_workers = self._target_workers
            if self._started and not self._shutdown:
                self._spawn_to_target_locked()
            self._work.notify_all()

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
        """Enqueue one event (sheds it as ``rejected`` over ``max_queue``,
        or on an attached control plane's quota/fair-share decision)."""
        if inv.runtime_id not in self.registry:
            raise KeyError(f"unknown runtime {inv.runtime_id!r}")
        inv.r_start = self.now() if inv.r_start is None else inv.r_start
        if self.controller is not None:
            # admission runs OUTSIDE the dispatcher lock: the control
            # plane's tick thread takes its own lock first and then this
            # one (via the hooks), so nesting the other way would deadlock
            reason = self.controller.admit(inv, self.now())
            if reason is not None:
                with self._lock:
                    self._reject_locked(inv, err=f"rejected: {reason}")
                return
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
            workers = self._target_workers or self._n_workers_req or 1
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
                    if self._shutdown or widx >= self._target_workers:
                        return      # retired by set_n_workers scale-down
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
            self._monitor_stop.wait(self.monitor_interval_s)

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
    def _evict_over_budget_locked(self) -> None:
        """Drop LRU handles over ``max_warm``, never a pinned key (the
        control plane's min-warm floors survive LRU pressure)."""
        while len(self._handles) > self.max_warm:
            victim = next((k for k in self._handles
                           if k not in self._pinned), None)
            if victim is None:
                break           # everything resident is pinned
            self._drop_handle_locked(victim)

    def _drop_handle_locked(self, key: str) -> None:
        self._handles.pop(key, None)
        self._handle_idle_since.pop(key, None)
        self._prewarmed.discard(key)

    def _acquire_handle(self, rdef: RuntimeDef, key: str):
        """(handle, cold, prewarmed, err) for one warm instance; LRU
        insert on cold.  ``prewarmed`` is True on the first hit against a
        control-plane-installed handle (policy-attributable warmth)."""
        if rdef.setup is None:
            with self._lock:
                self.n_cold_starts += 1
            return None, True, False, None
        with self._lock:
            if key in self._handles:
                self.n_warm_starts += 1
                self._handles.move_to_end(key)
                prewarmed = key in self._prewarmed
                self._prewarmed.discard(key)
                return self._handles[key], False, prewarmed, None
            self.n_cold_starts += 1
        try:
            handle = rdef.setup()           # slow: weights (unlocked)
        except Exception as e:  # noqa: BLE001 — unsuccessful event
            return None, True, False, f"cold-start failed: {e!r}"
        with self._lock:
            self._handles[key] = handle
            self._evict_over_budget_locked()
        return handle, True, False, None

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
            handle, cold, prewarmed, err = self._acquire_handle(rdef, key)
        cold_s = (self.now() - t_acq) if cold else 0.0  # measured setup()
        for inv in batch:
            inv.cold_start = cold
            inv.prewarmed = prewarmed

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
            if key in self._handles:
                self._handle_idle_since[key] = self.now()   # keep-alive TTL
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

    # -- warm-pool introspection / control-plane actuation ---------------
    def warm_keys(self) -> List[str]:
        """Runtime keys with a live warm instance, LRU-oldest first."""
        with self._lock:
            return list(self._handles)

    def handle(self, runtime_key: str) -> Any:
        """The warm ``setup()`` handle for ``runtime_key`` (None if cold)."""
        with self._lock:
            return self._handles.get(runtime_key)

    def prewarm(self, runtime_id: str,
                config: Optional[Dict[str, Any]] = None) -> bool:
        """Run ``setup()`` (weights and cache) for (runtime, config) off
        the critical path — called from the control plane's tick thread,
        never a dispatcher worker — and install the handle in the warm
        pool.  The calling thread enters worker 0's card first (the
        current device is per thread), so the engine lands where a
        worker's own cold start would put it.  The first event it serves
        reports ``prewarmed`` instead of paying the cold start.  False
        when the runtime has no ``setup`` or the key is already warm/in
        progress."""
        rdef = self.registry.get(runtime_id)
        if rdef.setup is None:
            return False
        key = runtime_key_for(runtime_id, config)
        with self._lock:
            if key in self._handles or key in self._prewarming:
                return key in self._handles
            self._prewarming.add(key)
        try:
            with self._on_device(0):
                handle = rdef.setup()       # slow, outside the lock
        except Exception:   # noqa: BLE001 — prewarm is best-effort
            with self._lock:
                self._prewarming.discard(key)
            return False
        with self._lock:
            self._prewarming.discard(key)
            if key not in self._handles:
                self._handles[key] = handle
                self._handle_idle_since[key] = self.now()
                self._prewarmed.add(key)
                self.n_prewarms += 1
                self._evict_over_budget_locked()
            self._work.notify_all()     # a queued event may now run warm
        return True

    def evict_warm(self, runtime_key: str) -> bool:
        """Drop a warm handle (keep-alive TTL expiry / explicit evict)."""
        with self._lock:
            hit = runtime_key in self._handles
            self._drop_handle_locked(runtime_key)
        return hit

    def pin_warm(self, keys: Set[str]) -> None:
        """Replace the pinned-key set (min-warm floors)."""
        with self._lock:
            self._pinned = set(keys)

    def warm_idle(self) -> Dict[str, float]:
        """runtime_key -> idle seconds since the handle last served."""
        now = self.now()
        with self._lock:
            return {k: now - self._handle_idle_since.get(k, now)
                    for k in self._handles}

    def capacity_hooks(self, objective: str = "latency"
                       ) -> "EngineCapacityHooks":
        """Control-plane surface over this dispatcher (cached).
        ``objective`` is accepted for parity with the sim hooks — a
        single-host, single-type dispatcher has no placement choice."""
        if self._hooks is None:
            self._hooks = EngineCapacityHooks(self)
        return self._hooks


class EngineCapacityHooks(CapacityHooks):
    """Control-plane actuation over the engine dispatcher: capacity units
    are worker threads, the warm pool is the shared ``setup()`` handle
    LRU, prewarm runs ``setup()`` on the control plane's tick thread,
    inside worker 0's card."""

    def __init__(self, engine: EngineBackend):
        self.engine = engine

    # -- observation -----------------------------------------------------
    def capacity(self) -> int:
        """Target dispatcher worker count."""
        e = self.engine
        return e._target_workers or e._n_workers_req or 1

    def pending(self) -> int:
        """Always 0 — worker threads spawn instantly."""
        return 0

    def queue_depth(self) -> int:
        """Admitted-but-unclaimed events in the key queues."""
        with self.engine._lock:
            return self.engine._n_pending

    def inflight(self) -> int:
        """Events currently executing on workers."""
        with self.engine._lock:
            return self.engine._n_inflight

    def backlog_by_runtime(self) -> Dict[str, int]:
        """Pending events per runtime across the key queues."""
        out: Dict[str, int] = {}
        with self.engine._lock:
            for kq in self.engine._queues.values():
                if kq.items:
                    rid = kq.items[0].runtime_id
                    out[rid] = out.get(rid, 0) + len(kq.items)
        return out

    def warm_state(self) -> Dict[str, float]:
        """Idle seconds per warm handle."""
        return self.engine.warm_idle()

    def warm_count(self, runtime_key: str) -> int:
        """1 when the key is warm or prewarming (one handle per key)."""
        with self.engine._lock:
            return int(runtime_key in self.engine._handles or
                       runtime_key in self.engine._prewarming)

    # -- actuation -------------------------------------------------------
    def set_target(self, n: int) -> None:
        """Retarget the dispatcher worker count."""
        self.engine.set_n_workers(n)

    def prewarm(self, runtime_id: str,
                config: Optional[Dict[str, Any]] = None) -> bool:
        """Run setup() on the caller's thread, install the warm handle."""
        return self.engine.prewarm(runtime_id, config)

    def evict(self, runtime_key: str) -> bool:
        """Drop the key's warm handle."""
        return self.engine.evict_warm(runtime_key)

    def pin(self, keys: Set[str]) -> None:
        """Exempt ``keys`` from LRU/TTL eviction."""
        self.engine.pin_warm(keys)
