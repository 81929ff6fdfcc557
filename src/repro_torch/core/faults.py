"""Fault injection: deterministic kill/stall/crash schedules over both
backends (the reliability subsystem's chaos layer).

A fault spec is a list of actions:

* ``kill-node``    — sim: the named node crashes.  Its in-flight work is
  lost; the injector immediately releases the node's visibility leases so
  the events redeliver (crash recovery without waiting out the lease).
* ``stall-node``   — sim: the named node hangs for ``duration_s``.  Its
  leases expire on the injector's reap tick and the events redeliver
  elsewhere; the node's own late completions are dropped (first
  settlement wins).
* ``crash-worker`` — engine: dispatcher worker ``worker`` dies abruptly
  the next time it picks a batch, stranding the batch mid-flight — the
  engine's worker monitor must detect the dead thread, requeue-or-fail
  the batch, and respawn to target.
* ``kill-worker-process`` — cluster: SIGKILL worker *process* ``worker``
  (its launcher index) — real process death, not thread death.  Its
  heartbeats stop, the master's keeper expires it, and its leased events
  requeue for the surviving workers (``docs/cluster.md``).  The port has
  no cluster backend yet: the op parses, and arming it raises
  ``NotImplementedError``.

Specs parse from JSON (``launch.serve --fault-spec``)::

    [{"at": 5.0, "op": "kill-node", "node": "pod0"},
     {"at": 2.0, "op": "stall-node", "node": "pod1", "duration_s": 90.0},
     {"at": 0.5, "op": "crash-worker", "worker": 0},
     {"at": 0.5, "op": "kill-worker-process", "worker": 1}]

``FaultInjector.arm()`` schedules the actions — clock callbacks on the
sim (virtual time, deterministic), timers on the engine (wall time) —
and, on the sim, starts the periodic lease-reap tick that turns expired
leases into redeliveries.

The port's copy of ``repro.core.faults`` (the port imports nothing of
``repro``); the cluster op is the one difference (above).
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

SIM_OPS = {"kill-node", "stall-node"}
ENGINE_OPS = {"crash-worker"}
CLUSTER_OPS = {"kill-worker-process"}
ALL_OPS = SIM_OPS | ENGINE_OPS | CLUSTER_OPS


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """One scheduled fault (``at`` is seconds on the backend's clock)."""

    at: float
    op: str     # kill-node | stall-node | crash-worker | kill-worker-process
    node: Optional[str] = None       # sim ops: target node name
    worker: int = 0                  # crash-worker: dispatcher worker index;
    #                                  kill-worker-process: launcher index
    duration_s: float = 0.0          # stall-node: how long the hang lasts

    def __post_init__(self):
        if self.op not in ALL_OPS:
            raise ValueError(f"unknown fault op {self.op!r} "
                             f"(valid: {sorted(ALL_OPS)})")
        if self.op in SIM_OPS and not self.node:
            raise ValueError(f"{self.op} needs a target node=")


def parse_fault_spec(spec: Union[str, Sequence[Dict[str, Any]]]
                     ) -> List[FaultAction]:
    """Parse a fault spec from a JSON string or a list of dicts."""
    if isinstance(spec, str):
        spec = json.loads(spec)
    if not isinstance(spec, (list, tuple)):
        raise ValueError("fault spec must be a JSON list of actions")
    return [FaultAction(**action) for action in spec]


class FaultInjector:
    """Arms a fault schedule against one backend (sim or engine).

    Sim targets may be a ``SimBackend`` or a bare ``Cluster``; engine
    targets are an ``EngineBackend``.  The injector keeps an audit log
    (``injected``) of what fired and when.
    """

    def __init__(self, backend, actions: Sequence[FaultAction], *,
                 reap_interval_s: float = 1.0):
        self.backend = backend
        self.actions = sorted(actions, key=lambda a: a.at)
        self.reap_interval_s = reap_interval_s
        self.injected: List[tuple] = []     # (t, op, target, detail)
        self.n_reaped = 0                   # leases expired -> redelivered
        self._armed = False
        self._timers: List[threading.Timer] = []
        self.cluster = getattr(backend, "cluster", None)
        if self.cluster is None and hasattr(backend, "queue"):
            self.cluster = backend      # a bare Cluster
        self.is_sim = self.cluster is not None

    # ------------------------------------------------------------------
    def arm(self) -> "FaultInjector":
        """Schedule every action; on the sim, also start the lease reaper
        (a periodic clock tick like the autoscaler's — drains are bounded,
        so the recurring timer cannot spin a drain forever)."""
        if self._armed:
            return self
        cluster_ops = sorted({a.op for a in self.actions} & CLUSTER_OPS)
        if cluster_ops:
            raise NotImplementedError(
                f"fault op(s) {cluster_ops} need the multi-process cluster "
                f"backend, which the port does not have yet")
        self._armed = True
        kind = "sim" if self.is_sim else "engine"
        valid = {"sim": SIM_OPS, "engine": ENGINE_OPS}[kind]
        bad = [a.op for a in self.actions if a.op not in valid]
        if bad:
            raise ValueError(
                f"fault op(s) {bad} do not apply to the {kind} backend")
        if self.is_sim:
            clock = self.cluster.clock
            for a in self.actions:
                clock.call_at(a.at, lambda a=a: self._apply_sim(a))
            clock.call_in(self.reap_interval_s, self._reap_tick)
        else:
            for a in self.actions:
                t = threading.Timer(max(a.at, 0.0),
                                    lambda a=a: self._apply_engine(a))
                t.daemon = True
                self._timers.append(t)
                t.start()
        return self

    def disarm(self) -> None:
        """Stop the reaper tick / cancel engine timers not yet fired."""
        self._armed = False
        for t in self._timers:
            t.cancel()
        self._timers.clear()

    # ------------------------------------------------------------------
    def _apply_sim(self, a: FaultAction) -> None:
        if not self._armed:
            return      # clock callbacks cannot be cancelled; disarm here
        now = self.cluster.clock.now()
        node = next((n for n in self.cluster.nodes if n.name == a.node),
                    None)
        if node is None:
            self.injected.append((now, a.op, a.node, "no such node"))
            return
        if a.op == "kill-node":
            node.kill()
            lost = self.cluster.queue.release_holder(node.name, now)
            self.injected.append((now, "kill-node", a.node,
                                  f"{len(lost)} leases redelivered"))
        elif a.op == "stall-node":
            node.stall(a.duration_s)
            self.injected.append((now, "stall-node", a.node,
                                  f"{a.duration_s:.1f}s"))

    def _reap_tick(self) -> None:
        if not self._armed:
            return
        now = self.cluster.clock.now()
        self.n_reaped += len(self.cluster.queue.reap(now))
        self.cluster.clock.call_in(self.reap_interval_s, self._reap_tick)

    def _apply_engine(self, a: FaultAction) -> None:
        if not self._armed:
            return      # timer fired in the disarm race window
        self.backend.crash_worker(a.worker)
        self.injected.append((self.backend.now(), "crash-worker",
                              a.worker, "armed"))

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, int]:
        """Counts of what the injector did (bench/CLI reporting)."""
        out: Dict[str, int] = {"reaped": self.n_reaped}
        for _, op, _, _ in self.injected:
            out[op] = out.get(op, 0) + 1
        return out


def inject(backend, spec: Union[str, Sequence[Dict[str, Any]],
                                Sequence[FaultAction]], *,
           reap_interval_s: float = 1.0) -> FaultInjector:
    """Convenience: parse ``spec`` (JSON string / list of dicts / list of
    :class:`FaultAction`) and arm an injector over ``backend``."""
    if spec and not isinstance(spec, str) and \
            isinstance(next(iter(spec)), FaultAction):
        actions = list(spec)
    else:
        actions = parse_fault_spec(spec)
    return FaultInjector(backend, actions,
                         reap_interval_s=reap_interval_s).arm()
