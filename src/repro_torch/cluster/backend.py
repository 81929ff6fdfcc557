"""The gateway-side half of the cluster: ``Backend`` over a transport.

:class:`ClusterBackend` implements the exact protocol
:class:`~repro_torch.gateway.backends.Backend` defines — so ``Gateway``,
futures, workflows, fault injection, and the control plane run unchanged
over a multi-process cluster:

* **submit** ships events to the master (admission-controlled client-
  side when a control plane is attached, exactly like the engine);
* **MirrorStore** is the client's object store: writes push through to
  the master (workers fetch inputs there), reads pull through on miss,
  and settlement outcomes are installed locally by the pump — firing the
  same ``on_settle`` watchers thread-mode futures use;
* the **completion pump** long-polls the master's settlement stream and
  applies each record (fields + outcome blob) to the client's
  ``Invocation`` objects, so futures stay callback-driven with zero
  per-future polling;
* :class:`ClusterCapacityHooks` maps the control-plane surface onto the
  cluster (capacity units = worker *processes*, actuated through the
  :class:`WorkerLauncher`; prewarm/evict/pin ride heartbeat replies).

:func:`start_cluster` is the one-call topology: an in-process master
serving RPC, N spawned worker subprocesses, and a ``ClusterBackend``
wired over the loopback — the shape ``launch/serve.py --cluster N``,
the benches, and the process-death tests all use.

The port's copy of ``repro.cluster.backend``: worker processes run
:mod:`repro_torch.cluster.worker` with the port's ``src`` on their
``PYTHONPATH``.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set

from repro_torch.core.events import Invocation
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.runtime import RuntimeDef, RuntimeRegistry
from repro_torch.core.storage import ObjectStore, make_outcome
from repro_torch.gateway.backends import Backend, CapacityHooks
from repro_torch.cluster.master import Master
from repro_torch.cluster.rpc import decode_blob, inv_to_wire
from repro_torch.cluster.runtimes import load_runtime_spec
from repro_torch.cluster.transport import (InProcTransport, MasterTransport,
                                     RpcTransport)
from repro_torch.obs import TRACER

# Invocation fields the pump copies from a settlement record, in order;
# r_end is applied LAST (after the outcome blob lands and watchers fire)
# so ``done()`` never races ahead of the stored result
_SETTLE_FIELDS = ("r_start", "n_start", "e_start", "e_end", "n_end",
                  "success", "error", "cold_start", "prewarmed",
                  "locality_hit", "node", "accelerator", "attempt",
                  "retries_exhausted", "rejected", "result_ref")


class MirrorStore(ObjectStore):
    """The client's object store, write-through/read-through a master.

    * ``put`` installs locally **and** pushes the serialized blob to the
      master, where workers fetch their inputs;
    * ``get``/``__contains__`` fall through to the master on local miss
      (a workflow step's intermediate result lives master-side first);
    * the settlement pump uses the inherited ``put_serialized`` — local
      only, firing the ``on_settle`` watchers futures registered.
    """

    def __init__(self, transport: MasterTransport):
        super().__init__()
        self._transport = transport

    def put(self, obj: Any, key: Optional[str] = None) -> str:
        """Serialize once, install locally, mirror to the master."""
        blob = obj if isinstance(obj, bytes) else pickle.dumps(obj)
        key = key or ("sha256:" + hashlib.sha256(blob).hexdigest()[:24])
        raw = isinstance(obj, bytes)
        super().put_serialized(key, blob, raw=raw)
        self._transport.put_blob(key, blob, raw=raw)
        return key

    def get(self, key: str) -> Any:
        """Local hit, else pull through from the master (and cache)."""
        if key not in self._blobs:
            blob, raw = self._transport.get_blob(key)    # KeyError if absent
            super().put_serialized(key, blob, raw=raw)
        return super().get(key)

    def __contains__(self, key: str) -> bool:
        self.n_contains += 1
        return key in self._blobs or self._transport.contains(key)


class ClusterBackend(Backend):
    """The multi-process cluster behind the unchanged gateway API."""

    name = "cluster"
    autonomous = True       # worker processes progress on their own

    def __init__(self, transport: MasterTransport, *,
                 launcher: Optional["WorkerLauncher"] = None):
        self.transport = transport
        self.launcher = launcher
        self.registry = RuntimeRegistry()   # local mirror (batch/retry info)
        self.metrics = MetricsCollector()   # client-side view of settlements
        self.store = MirrorStore(transport)
        hello = transport.hello(role="client", name="gateway")
        self._offset = hello["now"] - time.monotonic()
        self._lock = threading.Lock()
        self._settled_cond = threading.Condition(self._lock)
        self._inflight: Dict[int, Invocation] = {}
        self._n_submitted = 0
        self._n_settled = 0
        self.n_rejected = 0
        self._hooks: Optional["ClusterCapacityHooks"] = None
        self._shutdown = False
        self._pump = threading.Thread(target=self._pump_loop,
                                      name="cluster-pump", daemon=True)
        self._pump.start()

    # -- clock -----------------------------------------------------------
    def now(self) -> float:
        """Seconds on the master clock (offset learned at hello)."""
        return time.monotonic() + self._offset

    # -- catalogue -------------------------------------------------------
    def register(self, rdef: RuntimeDef) -> None:
        """Register a runtime cluster-wide — it must carry a spec.

        Callables cannot cross process boundaries; build definitions with
        the factories in :mod:`repro_torch.cluster.runtimes` (or any importable
        factory loaded via ``load_runtime_spec``), or call
        :meth:`register_spec` directly."""
        if not rdef.spec:
            raise ValueError(
                f"runtime {rdef.runtime_id!r} has no importable spec — the "
                f"cluster backend registers runtimes by factory reference "
                f"(RuntimeDef.spec='pkg.module:callable'); build it with "
                f"repro_torch.cluster.runtimes.load_runtime_spec or register_spec")
        self.transport.register(rdef.spec, rdef.spec_kwargs)
        self.registry.register(rdef)

    def register_spec(self, spec: str,
                      kwargs: Optional[Dict[str, Any]] = None) -> str:
        """Register by factory reference; returns the runtime id."""
        rdef = load_runtime_spec(spec, kwargs)
        self.register(rdef)
        return rdef.runtime_id

    # -- submission ------------------------------------------------------
    def submit(self, inv: Invocation) -> None:
        """Ship one event to the master (async; client-side admission)."""
        if inv.runtime_id not in self.registry:
            raise KeyError(f"unknown runtime {inv.runtime_id!r}")
        if inv.r_start is None:
            inv.r_start = self.now()
        try:
            json.dumps(inv.config)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"cluster run configurations must be JSON-serializable "
                f"(they cross a process boundary): {e}") from e
        if self.controller is not None:
            # same contract as the engine backend: admission runs before
            # the event leaves this process; sheds settle locally
            reason = self.controller.admit(inv, self.now())
            if reason is not None:
                self._reject(inv, reason)
                return
        with self._lock:
            if self._shutdown:
                self._reject(inv, "cluster backend is shut down",
                             locked=True)
                return
            self._inflight[inv.inv_id] = inv
            self._n_submitted += 1
        try:
            self.transport.submit(inv_to_wire(inv))
        except Exception:
            with self._lock:
                self._inflight.pop(inv.inv_id, None)
                self._n_submitted -= 1
            raise

    def _reject(self, inv: Invocation, reason: str,
                locked: bool = False) -> None:
        """Settle a shed event locally (it never reaches the master)."""
        now = self.now()
        inv.n_start = inv.e_start = inv.e_end = inv.n_end = \
            max(now, inv.r_start or 0.0)
        inv.r_end = inv.n_end
        inv.rejected = True
        inv.success = False
        inv.error = f"rejected: {reason}"
        blob = pickle.dumps(make_outcome(inv, None, inv.error))
        inv.result_ref = self.store.put_serialized(
            f"result:inv{inv.inv_id}", blob)
        if locked:
            self.metrics.record(inv)
            self.n_rejected += 1
            self._settled_cond.notify_all()
        else:
            with self._lock:
                self.metrics.record(inv)
                self.n_rejected += 1
                self._settled_cond.notify_all()
        if TRACER.enabled:
            TRACER.record_invocation(inv)

    # -- the completion pump ---------------------------------------------
    def _pump_loop(self) -> None:
        """Long-poll the settlement stream; apply each record locally."""
        cursor = 0
        while True:
            if self._shutdown:
                return
            try:
                rsp = self.transport.poll_settled(since=cursor,
                                                  timeout_s=10.0)
            except Exception:   # noqa: BLE001 — conn torn down / master gone
                if self._shutdown:
                    return
                time.sleep(0.05)
                continue
            cursor = int(rsp.get("next", cursor))
            for rec in rsp.get("records", ()):
                self._apply_settlement(rec)
            if rsp.get("shutdown"):
                return

    def _apply_settlement(self, rec: Dict[str, Any]) -> None:
        """Install one settlement: fields, then the outcome blob (firing
        future watchers), then ``r_end`` — the same persist-before-settle
        order the thread-mode backends use."""
        wire = rec.get("inv")
        if wire is None:
            # spans-only stream record (the keeper's abandoned-attempt
            # closures) — trace relay, no settlement to apply
            if TRACER.enabled:
                TRACER.ingest(rec.get("spans") or [])
            return
        inv_id = wire.get("inv_id")
        with self._lock:
            inv = self._inflight.pop(inv_id, None)
        if inv is None:
            return          # not ours (or already applied)
        for f in _SETTLE_FIELDS:
            if f in wire:
                setattr(inv, f, wire[f])
        self.store.put_serialized(f"result:inv{inv_id}",
                                  decode_blob(rec["blob"]))
        with self._lock:
            inv.r_end = wire.get("r_end")
            self._n_settled += 1
            self.metrics.record(inv)
            if TRACER.enabled:
                # adopt the worker-authored spans that rode the record,
                # then emit the partition — minus the children another
                # process already owns
                TRACER.ingest(rec.get("spans") or [])
                TRACER.record_invocation(inv, emit_cold=False,
                                         emit_execute=False)
            self._settled_cond.notify_all()

    # -- completion waits (engine-style condition loops) -----------------
    def backlog(self) -> int:
        """Submitted-but-unsettled events (client view)."""
        with self._lock:
            return len(self._inflight)

    def drain(self, extra_time_s: float = 600.0) -> None:
        """Park on the settlement condition until nothing is in flight."""
        deadline = time.monotonic() + extra_time_s
        with self._lock:
            while self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._settled_cond.wait(timeout=remaining)

    def wait(self, inv: Invocation, timeout_s: float = 600.0) -> bool:
        """Block until ``inv`` settles (pump-driven, no polling)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while inv.r_end is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._settled_cond.wait(timeout=remaining)
        return inv.r_end is not None

    def wait_any(self, invs: Sequence[Invocation],
                 timeout_s: float = 600.0) -> bool:
        """Block until at least one of ``invs`` settles."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while not any(i.r_end is not None for i in invs):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._settled_cond.wait(timeout=remaining)
        return True

    # -- control plane ---------------------------------------------------
    def capacity_hooks(self, objective: str = "latency") \
            -> "ClusterCapacityHooks":
        """Control-plane surface over the cluster (cached).

        ``objective`` is accepted for signature parity with the sim hooks
        (the plane forwards it unconditionally); worker processes are a
        single capacity pool, so there is no per-type spend to steer."""
        if self._hooks is None:
            self._hooks = ClusterCapacityHooks(self)
        return self._hooks

    def stats(self) -> Dict[str, Any]:
        """The master's live snapshot (queue/workers/settlements)."""
        return self.transport.stats()

    def backlog_by_type(self) -> Dict[str, Dict[str, int]]:
        """Per-accelerator-type queue/busy/free/warm, from the master's
        heartbeat ledger (each worker self-reports its ``acc_type``)."""
        return {t: dict(row)
                for t, row in self.stats().get("by_type", {}).items()}

    # -- lifecycle -------------------------------------------------------
    def shutdown(self) -> None:
        """Stop the pump and close the transport (workers/master are the
        launcher's/owner's to stop — see ``start_cluster``'s handle)."""
        self._shutdown = True
        self.transport.close()      # unblocks the parked pump poll
        self._pump.join(timeout=5.0)
        with self._lock:
            self._settled_cond.notify_all()


class ClusterCapacityHooks(CapacityHooks):
    """Control-plane actuation over the cluster: capacity units are
    worker *processes* (spawned/retired through the launcher), warm state
    is what workers self-report on heartbeats, and prewarm/evict/pin ride
    the master's heartbeat-reply directives."""

    def __init__(self, backend: ClusterBackend):
        self.backend = backend

    def _stats(self) -> Dict[str, Any]:
        return self.backend.transport.stats()

    # -- observation -----------------------------------------------------
    def capacity(self) -> int:
        """Workers the keeper currently believes alive."""
        return len(self._stats().get("workers", {}))

    def pending(self) -> int:
        """Spawned-but-not-yet-helloed worker processes."""
        launcher = self.backend.launcher
        if launcher is None:
            return 0
        return max(len(launcher.alive()) - self.capacity(), 0)

    def queue_depth(self) -> int:
        """Events queued at the master, unleased."""
        return int(self._stats().get("queue_depth", 0))

    def inflight(self) -> int:
        """Events leased to workers right now."""
        return int(self._stats().get("leased", 0))

    def backlog_by_runtime(self) -> Dict[str, int]:
        """Queued events per runtime (master queue index)."""
        return dict(self._stats().get("by_runtime", {}))

    def warm_state(self) -> Dict[str, float]:
        """Warm keys across workers (idle ages are not reported over the
        heartbeat — every resident key reads as freshly used)."""
        out: Dict[str, float] = {}
        for w in self._stats().get("workers", {}).values():
            for key in w.get("stats", {}).get("warm_keys", ()):
                out.setdefault(key, 0.0)
        return out

    def warm_count(self, runtime_key: str) -> int:
        """Workers reporting ``runtime_key`` resident."""
        return sum(1 for w in self._stats().get("workers", {}).values()
                   if runtime_key in w.get("stats", {}).get("warm_keys", ()))

    # -- actuation -------------------------------------------------------
    def set_target(self, n: int) -> None:
        """Scale the worker-process fleet (no-op without a launcher)."""
        if self.backend.launcher is not None:
            self.backend.launcher.scale_to(max(int(n), 1))

    def prewarm(self, runtime_id: str,
                config: Optional[Dict[str, Any]] = None) -> bool:
        """Route a prewarm directive to one live worker."""
        rsp = self.backend.transport.prewarm(runtime_id, config)
        return rsp.get("worker") is not None

    def evict(self, runtime_key: str) -> bool:
        """Broadcast an eviction directive."""
        return bool(self.backend.transport.evict(runtime_key)
                    .get("workers"))

    def pin(self, keys: Set[str]) -> None:
        """Broadcast the pinned key set."""
        self.backend.transport.pin(sorted(keys))


class WorkerLauncher:
    """Spawn/kill/scale worker subprocesses against one master address.

    ``kill()`` is SIGKILL — the real-process-death fault path the
    ``kill-worker-process`` fault op and the SIGKILL tests drive;
    ``stop_all()`` is the polite SIGTERM-then-SIGKILL shutdown."""

    def __init__(self, addr: str, *, max_batch: int = 8,
                 heartbeat_s: float = 0.5, max_warm: int = 8,
                 acc_types: Optional[Sequence[str]] = None):
        self.addr = addr
        self.max_batch = max_batch
        self.heartbeat_s = heartbeat_s
        self.max_warm = max_warm
        # acc_types[i] is worker i's advertised accelerator type (wraps
        # around when more workers spawn than types were given); None
        # leaves the worker's host-cuda default
        self.acc_types = list(acc_types) if acc_types else None
        self._procs: List[Optional[subprocess.Popen]] = []

    def _env(self) -> Dict[str, str]:
        """The child env: the port's ``src`` on PYTHONPATH."""
        import repro_torch
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                                   if env.get("PYTHONPATH") else "")
        return env

    def spawn(self, n: int = 1) -> List[str]:
        """Start ``n`` worker processes; returns their names (``w<i>``)."""
        names = []
        for _ in range(n):
            idx = len(self._procs)
            name = f"w{idx}"
            # -c instead of -m: runpy warns when the package __init__ has
            # already imported the worker module it is about to re-execute
            cmd = [sys.executable, "-c",
                   "from repro_torch.cluster.worker import main; "
                   "raise SystemExit(main())",
                   "--master", self.addr, "--name", name,
                   "--max-batch", str(self.max_batch),
                   "--heartbeat-s", str(self.heartbeat_s),
                   "--max-warm", str(self.max_warm)]
            if self.acc_types:
                cmd += ["--acc-type",
                        self.acc_types[idx % len(self.acc_types)]]
            self._procs.append(subprocess.Popen(
                cmd, env=self._env(), stdout=subprocess.DEVNULL))
            names.append(name)
        return names

    def alive(self) -> List[int]:
        """Indexes of worker processes still running."""
        return [i for i, p in enumerate(self._procs)
                if p is not None and p.poll() is None]

    def kill(self, idx: int) -> bool:
        """SIGKILL worker ``idx`` — abrupt process death, no cleanup.
        True when a running process was killed."""
        if idx >= len(self._procs) or self._procs[idx] is None:
            return False
        proc = self._procs[idx]
        was_running = proc.poll() is None
        proc.kill()
        proc.wait(timeout=10.0)
        return was_running

    def scale_to(self, n: int) -> None:
        """Spawn up to / SIGTERM down to ``n`` live workers."""
        live = self.alive()
        if len(live) < n:
            self.spawn(n - len(live))
        else:
            for idx in live[n:]:
                self._procs[idx].terminate()

    def stop_all(self) -> None:
        """SIGTERM everyone, SIGKILL stragglers, reap them all."""
        for p in self._procs:
            if p is not None and p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            if p is None:
                continue
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5.0)


class ClusterHandle:
    """Everything ``start_cluster`` built, with one ``close()``.

    Context-manager friendly::

        with start_cluster(2) as cluster:
            gw = Gateway(cluster.backend)
            ...
    """

    def __init__(self, backend: ClusterBackend, master: Master,
                 launcher: WorkerLauncher, addr: str):
        self.backend = backend
        self.master = master
        self.launcher = launcher
        self.addr = addr

    def __enter__(self) -> "ClusterHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Tear the topology down: master flags shutdown (workers exit
        their take loops), the launcher reaps the processes, the backend
        stops its pump, the master's server stops."""
        self.master.op_shutdown()
        self.launcher.stop_all()
        self.backend.shutdown()
        self.master.stop()


def start_cluster(n_workers: int, *, lease_s: float = 30.0,
                  heartbeat_timeout_s: float = 3.0,
                  keeper_interval_s: float = 0.25,
                  heartbeat_s: float = 0.5, max_batch: int = 8,
                  max_warm: int = 8,
                  acc_types: Optional[Sequence[str]] = None,
                  ready_timeout_s: float = 20.0) -> ClusterHandle:
    """Bring up master + ``n_workers`` worker processes on loopback.

    Blocks until every worker has said hello (readiness), so callers can
    submit immediately.  ``heartbeat_timeout_s`` decides how fast a
    SIGKILLed worker is declared dead and its leases requeued — keep it
    comfortably above the slowest ``setup()`` a runtime performs (a jit
    compile must not read as death; serve workloads want ~30 s)."""
    master = Master(lease_s=lease_s,
                    heartbeat_timeout_s=heartbeat_timeout_s,
                    keeper_interval_s=keeper_interval_s)
    addr = master.serve()
    launcher = WorkerLauncher(addr, max_batch=max_batch,
                              heartbeat_s=heartbeat_s, max_warm=max_warm,
                              acc_types=acc_types)
    launcher.spawn(n_workers)
    backend = ClusterBackend(RpcTransport(addr), launcher=launcher)
    deadline = time.monotonic() + ready_timeout_s
    while time.monotonic() < deadline:
        if len(master.op_stats()["workers"]) >= n_workers:
            return ClusterHandle(backend, master, launcher, addr)
        time.sleep(0.02)
    handle = ClusterHandle(backend, master, launcher, addr)
    handle.close()
    raise TimeoutError(
        f"cluster not ready: {len(master.op_stats()['workers'])}/"
        f"{n_workers} workers reported within {ready_timeout_s}s")


__all__ = ["ClusterBackend", "ClusterCapacityHooks", "ClusterHandle",
           "MirrorStore", "WorkerLauncher", "start_cluster"]
