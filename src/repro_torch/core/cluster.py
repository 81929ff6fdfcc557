"""Cluster assembly + experiment runner.

``Cluster`` wires queue + object store + runtime registry + node managers
onto one clock; ``run_workloads`` replays phase workloads and returns the
metrics collector.  ``paper_testbed`` builds the paper's §V hardware
(Xeon host, 2x NVIDIA Quadro K600 @ 2 instances each, 1 Intel Movidius NCS)
with service times calibrated to the paper's measured tiny-YOLOv2 medians.

The port's copy of ``repro.core.cluster`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.accelerator import Accelerator, AcceleratorSpec
from repro_torch.core.events import Invocation
from repro_torch.core.metrics import MetricsCollector
from repro_torch.core.node import NodeManager
from repro_torch.core.queue import ScannableQueue
from repro_torch.core.runtime import RuntimeDef, RuntimeRegistry, SimProfile
from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.simclock import SimClock
from repro_torch.core.storage import ObjectStore
from repro_torch.core.workload import PhaseWorkload
from repro_torch.obs import TRACER

# ----------------------------------------------------------------------
# Paper-calibrated constants (Hardless §V.B)
# ----------------------------------------------------------------------
# energy model: K600 board power 41 W TDP (≈10 W idle); the NCS stick
# draws ~2 W active / ~0.5 W idle over USB — the heterogeneity the energy
# objective exploits (a VPU invocation costs ~20x fewer joules)
GPU_K600 = AcceleratorSpec(type="gpu-k600", slots=2, mem_bytes=1 << 30,
                           cost_per_hour=0.50, idle_watts=10.0,
                           active_watts=41.0)
VPU_NCS = AcceleratorSpec(type="vpu-ncs", slots=1, mem_bytes=512 << 20,
                          cost_per_hour=0.10, idle_watts=0.5,
                          active_watts=2.0)
TINYYOLO_GPU_ELAT_S = 1.675     # median ELat on K600 (paper §V.B)
TINYYOLO_VPU_ELAT_S = 1.577     # median ELat on NCS  (paper §V.B)


class Cluster:
    def __init__(self, *, scheduler: str = "warm", clock=None,
                 invocation_timeout_s: Optional[float] = None,
                 idle_timeout_s: float = 60.0, max_warm: int = 4,
                 lease_s: float = 60.0, seed: int = 0,
                 metrics_history_max: Optional[int] = None,
                 store_outcome_max: Optional[int] = None,
                 reference_scan_scheduler: bool = False):
        # metrics_history_max / store_outcome_max bound the raw completion
        # list and the retained outcome records for huge runs (summaries
        # stay exact — they are streamed); reference_scan_scheduler swaps
        # in the O(n)-scan policy implementation (differential testing)
        self.clock = clock or SimClock()
        self.queue = ScannableQueue(lease_s=lease_s)
        self.store = ObjectStore(outcome_max=store_outcome_max)
        self.registry = RuntimeRegistry()
        self.metrics = MetricsCollector(history_max=metrics_history_max)
        self._reference_scan = reference_scan_scheduler
        self.nodes: List[NodeManager] = []
        self._scheduler_name = scheduler
        self._invocation_timeout = invocation_timeout_s
        self._idle_timeout = idle_timeout_s
        self._max_warm = max_warm
        self._seed = seed
        self._horizon = 0.0          # latest submitted r_start (drain bound)
        # at-least-once: requeue a lost delivery up to the runtime's
        # max_attempts; past that it settles as a permanent error record
        self.queue.configure_retries(
            lambda inv: (self.registry.get(inv.runtime_id).max_attempts
                         if inv.runtime_id in self.registry else 1),
            self._fail_lost)
        # close a lost attempt's orphaned span as abandoned (virtual-time
        # stamps — the observer fires before the retry wipes them)
        self.queue.set_requeue_observer(self._observe_requeue)

    def _observe_requeue(self, inv: Invocation, holder: str,
                         now: Optional[float], reason: str) -> None:
        if TRACER.enabled:
            TRACER.record_abandoned(
                inv, holder=holder,
                now=now if now is not None else self.clock.now(),
                reason=reason)

    # -- topology -------------------------------------------------------
    def add_node(self, name: str, specs: Sequence[AcceleratorSpec]
                 ) -> NodeManager:
        accs = [Accelerator(spec=s, local_id=f"{name}/acc{i}")
                for i, s in enumerate(specs)]
        for s in specs:
            # the metrics collector prices each type's invocations
            # (cost/energy counters) from the spec's model
            self.metrics.register_accelerator(s)
        node = NodeManager(
            name, accs, clock=self.clock, queue=self.queue, store=self.store,
            registry=self.registry, metrics=self.metrics,
            scheduler=make_scheduler(self._scheduler_name,
                                     reference_scan=self._reference_scan),
            idle_timeout_s=self._idle_timeout,
            max_warm=self._max_warm,
            invocation_timeout_s=self._invocation_timeout,
            seed=self._seed + len(self.nodes))
        self.nodes.append(node)
        return node

    def backlog_by_type(self) -> Dict[str, Dict[str, int]]:
        """Per-accelerator-type pressure: queued events servable by the
        type, busy/free slots, and warm instance count — the operator's
        heterogeneity view (an event servable by several types counts
        toward each; the aggregate ``backlog()`` stays the event count)."""
        out: Dict[str, Dict[str, int]] = {}
        queued_by_rid = self.queue.counts_by_runtime()
        live = [n for n in self.nodes if not n.dead]
        types = sorted({a.spec.type for n in live for a in n.accelerators})
        for t in types:
            queued = sum(cnt for rid, cnt in queued_by_rid.items()
                         if rid in self.registry
                         and self.registry.get(rid).supports(t))
            busy = free = warm = 0
            for n in live:
                for a in n.accelerators:
                    if a.spec.type != t:
                        continue
                    busy += a.busy_slots
                    free += a.free_slots
                    warm += len(a.warm)
            out[t] = {"queued": queued, "busy": busy, "free": free,
                      "warm": warm}
        return out

    def register_runtime(self, rdef: RuntimeDef) -> None:
        self.registry.register(rdef)
        self.store.put(b"\0" * min(rdef.artifact_bytes, 1 << 16),
                       key=f"runtime:{rdef.runtime_id}")

    # -- client API (the serverless front door) --------------------------
    def submit(self, inv: Invocation, gate=None) -> None:
        """Schedule the event's publication at its RStart.  ``gate`` (the
        admission controller) is consulted *at arrival time on the clock*;
        returning a reason string sheds the event as ``rejected`` instead
        of publishing it."""
        inv.r_start = self.clock.now() if inv.r_start is None else inv.r_start
        self._horizon = max(self._horizon, inv.r_start)

        def publish():
            reason = gate(inv) if gate is not None else None
            if reason is not None:
                self._shed(inv, reason)
            else:
                self.queue.publish(inv, inv.r_start)
        self.clock.call_at(inv.r_start, publish)

    def _fail_lost(self, inv: Invocation, reason: str) -> None:
        """Settle an event whose delivery was lost past its retry bound —
        the permanent "retries exhausted" error record (none stranded)."""
        inv.clear_attempt_timestamps()      # the dead attempt's chain
        inv.r_end = max(self.clock.now(), inv.r_start or 0.0)
        inv.success = False
        inv.error = reason
        self.store.persist_outcome(inv, None, reason)
        self.metrics.record(inv)
        if TRACER.enabled:
            TRACER.record_invocation(inv)

    def _shed(self, inv: Invocation, reason: str) -> None:
        """Settle an admission-shed event as rejected (never executed)."""
        t = max(self.clock.now(), inv.r_start or 0.0)
        inv.n_start = inv.e_start = inv.e_end = inv.n_end = inv.r_end = t
        inv.rejected = True
        inv.success = False
        inv.error = f"rejected: {reason}"
        self.store.persist_outcome(inv, None, inv.error)
        self.metrics.record(inv)
        if TRACER.enabled:
            TRACER.record_invocation(inv)

    def run_workloads(self, workloads: Sequence[PhaseWorkload],
                      extra_time_s: float = 600.0) -> MetricsCollector:
        horizon = 0.0
        for wl in workloads:
            for inv in wl.events():
                self.submit(inv)
            horizon = max(horizon, wl.total_duration)
        self.clock.run(until=horizon + extra_time_s)
        return self.metrics

    def run(self, until: Optional[float] = None) -> None:
        self.clock.run(until=until)

    def drain(self, extra_time_s: float = 600.0) -> None:
        """Advance the clock far enough past the last submitted event for
        everything to finish (the gateway's blocking-wait primitive — bounded,
        so periodic timers such as the autoscaler tick cannot spin forever)."""
        self.clock.run(until=self._horizon + extra_time_s)


# ----------------------------------------------------------------------
# Paper testbed
# ----------------------------------------------------------------------
def tinyyolo_runtime() -> RuntimeDef:
    return RuntimeDef(
        runtime_id="onnx-tinyyolov2",
        profiles={
            "gpu-k600": SimProfile(elat_median_s=TINYYOLO_GPU_ELAT_S,
                                   sigma=0.05, cold_start_s=3.0),
            "vpu-ncs": SimProfile(elat_median_s=TINYYOLO_VPU_ELAT_S,
                                  sigma=0.04, cold_start_s=5.0),
        },
        artifact_bytes=60 << 20,
    )


def paper_testbed(*, with_vpu: bool, scheduler: str = "warm",
                  invocation_timeout_s: Optional[float] = 60.0,
                  seed: int = 0) -> Cluster:
    """The §V test environment: one node, 2 GPUs (2 slots each) ± 1 VPU."""
    cluster = Cluster(scheduler=scheduler,
                      invocation_timeout_s=invocation_timeout_s, seed=seed)
    specs = [GPU_K600, GPU_K600] + ([VPU_NCS] if with_vpu else [])
    cluster.add_node("xeon-host", specs)
    cluster.register_runtime(tinyyolo_runtime())
    # a representative input image set in object storage (448 KiB JPEG batch)
    cluster.store.put(b"\0" * (448 << 10), key="data:voc-images")
    return cluster
