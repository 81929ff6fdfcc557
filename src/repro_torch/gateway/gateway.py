"""The unified invocation gateway — one serverless front door.

The paper's programming model (§IV-B: an event is *(runtime reference,
data-set reference, run configuration)*, asynchronous only, no placement
control) exposed as a client API over pluggable backends:

    gw = Gateway(SimBackend(cluster))          # or EngineBackend()
    gw.register(runtime_def)
    fut = gw.invoke("onnx-tinyyolov2", payload, config={"model": "v1"})
    futs = gw.map("onnx-tinyyolov2", payloads)
    out = fut.result()                         # blocks; raises on failure

Identical client code runs against any backend — the backend decides what
an invocation *costs*, the gateway only decides what it *means*: the
calibrated simulation (with a real ``fn`` run inside virtual time) or real
execution on the card (or on the host with ``device="cpu"``).

The port's copy of ``repro.gateway.gateway`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.events import Invocation
from repro_torch.core.runtime import RuntimeDef
from repro_torch.gateway.backends import Backend
from repro_torch.gateway.future import InvocationFuture
from repro_torch.obs import TRACER


class Gateway:
    """The serverless front door: one client API over any backend."""

    def __init__(self, backend: Backend):
        self.backend = backend
        self.futures: List[InvocationFuture] = []
        self._runner = None     # lazy WorkflowRunner (submit_workflow)

    # -- catalogue ------------------------------------------------------
    def register(self, rdef: RuntimeDef) -> str:
        """Publish a runtime into the backend catalogue; returns its id."""
        self.backend.register(rdef)
        return rdef.runtime_id

    def runtimes(self) -> List[str]:
        """Ids of every registered runtime."""
        return self.backend.registry.ids()

    # -- data plane -----------------------------------------------------
    def put(self, obj: Any, key: Optional[str] = None) -> str:
        """Stage an input data set in object storage; returns its ref."""
        return self.backend.store.put(obj, key=key)

    # -- invocation -----------------------------------------------------
    def invoke(self, runtime_id: str, payload: Any = None, *,
               data_ref: Optional[str] = None,
               config: Optional[Dict[str, Any]] = None,
               at: Optional[float] = None,
               tenant: Optional[str] = None,
               workflow: Optional[str] = None,
               step: Optional[str] = None) -> InvocationFuture:
        """Submit one event; returns immediately with a future.

        ``payload`` is staged to the object store (the stateless-workload
        rule: runtimes fetch their data set, they never receive it inline);
        pass ``data_ref`` instead to reuse an already-staged object.  ``at``
        pins the event's RStart on the backend clock (default "now"): the
        sim backend replays arrivals at exactly those times; the engine
        backend starts executing as soon as a worker is free (micro-
        batching compatible events), so there ``at`` only controls the
        recorded timestamps, not wall-clock delay.  Under backpressure —
        the engine's bounded queue, or an attached control plane's
        tenant-quota / fair-share decision — the backend may shed the
        event at admission: the returned future then reports
        ``rejected()`` and ``result()`` raises
        :class:`InvocationRejected`.  ``tenant`` names the submitting
        tenant for quota accounting (default tenant when omitted).
        ``workflow``/``step`` tag the event with its composition
        provenance (set by the workflow runner).
        """
        if payload is not None and data_ref is not None:
            raise ValueError("pass either payload or data_ref, not both")
        if runtime_id not in self.backend.registry:
            raise KeyError(f"unknown runtime {runtime_id!r}; register() it "
                           f"first (known: {self.runtimes()})")
        if data_ref is None:
            data_ref = self.put(payload) if payload is not None else ""
        inv = Invocation(runtime_id=runtime_id, data_ref=data_ref,
                         config=dict(config or {}), r_start=at,
                         workflow=workflow, step=step,
                         **({"tenant": tenant} if tenant else {}))
        if TRACER.enabled:
            # trace context is assigned here, at the front door, so it is
            # identical across backends and rides the cluster RPC frames
            # verbatim; workflow steps share one trace under a synthetic
            # workflow root span
            inv.trace_id = f"wf:{workflow}" if workflow else \
                f"inv:{inv.inv_id}"
            inv.span_id = f"inv{inv.inv_id}"
            if workflow:
                TRACER.workflow_root(
                    workflow, at if at is not None else self.backend.now())
        self.backend.submit(inv)
        fut = InvocationFuture(inv, self.backend)
        self.futures.append(fut)
        return fut

    def map(self, runtime_id: str, payloads: Sequence[Any], *,
            config: Optional[Dict[str, Any]] = None,
            at: Optional[float] = None,
            tenant: Optional[str] = None,
            spacing_s: float = 0.0) -> List[InvocationFuture]:
        """Fan one runtime out over many payloads (Lithops-style ``map``).

        ``spacing_s`` staggers RStart between consecutive events — an
        open-loop arrival process without building a PhaseWorkload
        (anchored at the backend's current time when ``at`` is omitted).
        """
        if at is None and spacing_s:
            at = self.backend.now()
        futs = []
        for i, payload in enumerate(payloads):
            t = None if at is None else at + i * spacing_s
            futs.append(self.invoke(runtime_id, payload, config=config,
                                    at=t, tenant=tenant))
        return futs

    # -- composition ----------------------------------------------------
    def submit_workflow(self, wf, *, resume: bool = False
                        ) -> "WorkflowFuture":  # noqa: F821
        """Submit a :class:`~repro_torch.gateway.workflow.Workflow` DAG as one
        composed application; returns a ``WorkflowFuture``.

        Steps are submitted the moment their dependencies resolve, with
        intermediate results flowing node-to-node through the object
        store; ``result()`` raises ``WorkflowStepError`` naming the
        failing step.  With ``resume=True``, steps whose results a
        previous submission of this workflow (same name) already
        persisted are restored without recomputation — crash/retry
        recovery re-runs only the unfinished suffix.  See
        ``docs/workflows.md`` and ``docs/reliability.md``.
        """
        from repro_torch.gateway.workflow import WorkflowRunner
        if self._runner is None:
            self._runner = WorkflowRunner(self)
        return self._runner.submit(wf, resume=resume)

    # -- completion -----------------------------------------------------
    def drain(self, extra_time_s: float = 600.0) -> None:
        """Drive the backend until all submitted invocations settle."""
        self.backend.drain(extra_time_s=extra_time_s)

    def gather(self, futures: Optional[Sequence[InvocationFuture]] = None,
               *, extra_time_s: float = 600.0) -> List[Any]:
        """Drain once, then collect every result (raises on first failure)."""
        self.drain(extra_time_s=extra_time_s)
        return [f.result() for f in (futures if futures is not None
                                     else self.futures)]

    # -- observability --------------------------------------------------
    @property
    def metrics(self):
        """The backend's §V-A MetricsCollector (RLat/ELat/RFast...)."""
        return self.backend.metrics

    def backlog(self) -> int:
        """Submitted-but-unsettled events at the backend (queue depth +
        in-flight) — the client-visible backpressure signal."""
        return self.backend.backlog()

    def backlog_by_type(self) -> Dict[str, Dict[str, int]]:
        """Per-accelerator-type pressure: ``type -> {queued, busy, free,
        warm}`` — which hardware the backlog is waiting on (``{}`` on a
        backend without a typed view)."""
        return self.backend.backlog_by_type()

    def summary(self) -> Dict[str, float]:
        """The backend's aggregate metric summary (§V-A derived numbers)."""
        return self.backend.metrics.summary()
