"""Elastic capacity management (§IV-B: "this enables HARDLESS to scale
workloads based on incoming invocations and offer similar elasticity as
other computation-oriented serverless systems").

Two layers:

* :class:`NodeFleet` — the *actuator*: provisioning and draining whole
  accelerator nodes (pods) with a realistic bring-up delay,
  plus the audit log and node-seconds cost accounting.  Shared by every
  capacity policy — the legacy queue-pressure loop below and the
  control plane's SLO scaler (``repro_torch.controlplane.scaler``) drive the
  same fleet.
* :class:`Autoscaler` — the original queue-pressure *policy*: scale out
  when queued events per slot exceed a threshold, scale in after a
  cooldown of calm checks.  Kept as the baseline the SLO-driven control
  plane is measured against (``benchmarks/bench_controlplane.py``).

The port's copy of ``repro.core.autoscaler`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.accelerator import AcceleratorSpec
from repro_torch.core.cluster import Cluster
from repro_torch.core.node import NodeManager


class NodeFleet:
    """Provision/drain actuator for whole accelerator nodes on the sim
    cluster.  Policies decide *when*; the fleet owns *how* — the
    provisioning delay, node naming, the audit log, and cost accounting."""

    def __init__(self, cluster: Cluster, spec: AcceleratorSpec,
                 node_prefix: str = "auto",
                 provision_delay_s: float = 45.0):
        self.cluster = cluster
        self.spec = spec
        self.node_prefix = node_prefix
        self.provision_delay_s = provision_delay_s
        self._n_spawned = 0
        self._pending = 0               # nodes being provisioned
        self.events: List[tuple] = []   # (t, action, detail) audit log
        self.node_seconds = 0.0         # cost accounting
        self._last_t = cluster.clock.now()

    # ------------------------------------------------------------------
    @property
    def managed_nodes(self) -> List[NodeManager]:
        return [n for n in self.cluster.nodes
                if n.name.startswith(self.node_prefix)
                and not getattr(n, "draining", False)]

    @property
    def active_nodes(self) -> List[NodeManager]:
        """Every non-draining node in the cluster (seed + managed)."""
        return [n for n in self.cluster.nodes
                if not getattr(n, "draining", False)]

    @property
    def pending(self) -> int:
        return self._pending

    def total_slots(self) -> int:
        return sum(a.spec.slots for n in self.active_nodes
                   for a in n.accelerators)

    def account(self) -> None:
        """Accumulate node-seconds since the last call (cost tracking)."""
        now = self.cluster.clock.now()
        dt = now - self._last_t
        self._last_t = now
        self.node_seconds += dt * len(self.active_nodes)

    # ------------------------------------------------------------------
    def provision(self, n: int = 1) -> None:
        """Start bringing up ``n`` nodes; each becomes ready (and starts
        pulling work) ``provision_delay_s`` from now."""
        for _ in range(max(n, 0)):
            self._pending += 1
            now = self.cluster.clock.now()
            self.events.append((now, "provision-start", self._n_spawned))

            def ready():
                self._pending -= 1
                name = f"{self.node_prefix}{self._n_spawned}"
                self._n_spawned += 1
                node = self.cluster.add_node(name, [self.spec])
                node.draining = False
                self.events.append(
                    (self.cluster.clock.now(), "node-ready", name))
                node.try_start_work()

            self.cluster.clock.call_at(now + self.provision_delay_s, ready)

    def drain_one(self) -> Optional[NodeManager]:
        """Drain the managed node with the fewest busy slots (it finishes
        current work, takes no new events); None when none are drainable."""
        managed = self.managed_nodes
        if not managed:
            return None
        cand = min(managed,
                   key=lambda n: sum(a.busy_slots for a in n.accelerators))
        cand.draining = True
        self.events.append((self.cluster.clock.now(), "drain", cand.name))
        return cand


@dataclasses.dataclass
class AutoscalerConfig:
    min_nodes: int = 1
    max_nodes: int = 8
    # scale out when queued events per free-able slot exceed this
    scale_out_queue_per_slot: float = 3.0
    # scale in when the queue stayed below this for `cooldown` checks
    scale_in_queue_per_slot: float = 0.5
    check_interval_s: float = 10.0
    provision_delay_s: float = 45.0     # node bring-up / VM boot
    cooldown_checks: int = 6


class Autoscaler:
    """The legacy queue-pressure policy, now a thin consumer of
    :class:`NodeFleet` (the control plane's SLO scaler drives the same
    actuator with a different decision rule)."""

    def __init__(self, cluster: Cluster, spec: AcceleratorSpec,
                 cfg: Optional[AutoscalerConfig] = None,
                 node_prefix: str = "auto"):
        self.cluster = cluster
        self.spec = spec
        self.cfg = cfg or AutoscalerConfig()
        self.fleet = NodeFleet(cluster, spec, node_prefix=node_prefix,
                               provision_delay_s=self.cfg.provision_delay_s)
        self._calm_checks = 0
        self._running = False

    # -- fleet passthroughs (the pre-refactor public surface) -----------
    @property
    def events(self) -> List[tuple]:
        return self.fleet.events

    @property
    def node_seconds(self) -> float:
        return self.fleet.node_seconds

    @property
    def managed_nodes(self) -> List[NodeManager]:
        return self.fleet.managed_nodes

    def total_slots(self) -> int:
        return self.fleet.total_slots()

    # ------------------------------------------------------------------
    def start(self) -> None:
        if not self._running:
            self._running = True
            self.cluster.clock.call_in(self.cfg.check_interval_s, self._tick)

    def stop(self) -> None:
        self._running = False

    def _tick(self) -> None:
        if not self._running:
            return
        self.fleet.account()
        depth = len(self.cluster.queue)
        slots = max(self.fleet.total_slots(), 1)
        pressure = depth / slots
        n_managed = len(self.fleet.managed_nodes) + self.fleet.pending

        if pressure > self.cfg.scale_out_queue_per_slot and \
                n_managed < self.cfg.max_nodes:
            self._calm_checks = 0
            self.fleet.provision(1)
        elif pressure < self.cfg.scale_in_queue_per_slot and \
                len(self.fleet.managed_nodes) > self.cfg.min_nodes:
            self._calm_checks += 1
            if self._calm_checks >= self.cfg.cooldown_checks:
                self._calm_checks = 0
                self.fleet.drain_one()
        else:
            self._calm_checks = 0
        self.cluster.clock.call_in(self.cfg.check_interval_s, self._tick)
