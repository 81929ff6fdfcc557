"""Event / invocation model (Hardless §IV-B).

An event is ``(runtime reference, data-set reference, run configuration)``
— asynchronous only, no placement control for the submitter.  Timestamps
follow the paper's measurement protocol (§V-A):

    RStart ≤ NStart ≤ EStart ≤ EEnd ≤ NEnd ≤ REnd

The port's copy of ``repro.core.events`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional

_ids = itertools.count()

DEFAULT_TENANT = "default"


def runtime_key_for(runtime_id: str,
                    config: Optional[Dict[str, Any]] = None) -> str:
    """The paper's "same configuration" warm-reuse identity for a
    (runtime, run configuration) pair — computable without building an
    :class:`Invocation` (the control plane prewarms by key)."""
    cfg = ",".join(f"{k}={config[k]}" for k in sorted(config or {})
                   if k not in ("payload",))
    return f"{runtime_id}|{cfg}"


@dataclasses.dataclass
class Invocation:
    """One Hardless event: *(runtime reference, data-set reference, run
    configuration)* plus the §V-A timestamp chain and outcome record."""

    runtime_id: str                 # runtime reference (the "workload")
    data_ref: str                   # object-store key of the input data
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    inv_id: int = dataclasses.field(default_factory=lambda: next(_ids))

    # --- timestamps (seconds on the cluster clock; None = not reached) ---
    r_start: Optional[float] = None   # client creates the event
    n_start: Optional[float] = None   # node manager receives it
    e_start: Optional[float] = None   # execution starts inside the runtime
    e_end: Optional[float] = None     # execution ends
    n_end: Optional[float] = None     # node manager has the result
    r_end: Optional[float] = None     # client has the result

    # --- outcome ---
    success: bool = False
    accelerator: Optional[str] = None   # which accelerator ran it
    node: Optional[str] = None
    cold_start: bool = False
    result_ref: Optional[str] = None
    error: Optional[str] = None
    rejected: bool = False              # shed at admission (backpressure)
    prewarmed: bool = False             # served by a control-plane-prewarmed
    #                                     instance (policy-attributable warmth)
    # the input ``data_ref`` was read from the executing node/worker's own
    # resident copy (a parent workflow step produced it there) instead of
    # round-tripping the object store — stamped by the dispatch path,
    # rides the cluster settle frames (data-locality placement)
    locality_hit: bool = False

    # --- at-least-once delivery (leases / retry) ---
    # completed-or-lost execution attempts so far (0 = first try); bumped
    # by the queue's lease reaper / engine worker monitor on requeue
    attempt: int = 0
    # the event was requeued until its RuntimeDef.max_attempts bound and
    # still never completed — settled as a permanent error record
    retries_exhausted: bool = False

    # --- multi-tenancy (admission control groups events by tenant) ---
    tenant: str = DEFAULT_TENANT

    # --- workflow provenance (None for standalone events) ---
    # set by the workflow runner so metrics/traces can group the events of
    # one composed submission; deliberately NOT part of runtime_key, so
    # steps from different workflows still share warm instances and batches
    workflow: Optional[str] = None      # owning Workflow's name
    step: Optional[str] = None          # step name inside that workflow

    # --- trace context (None = untraced; see repro_torch.obs) ---
    # stamped by the gateway when tracing is enabled; rides the cluster
    # RPC frames verbatim so workers/master parent their spans correctly;
    # NOT part of runtime_key (observability must not split warm pools)
    trace_id: Optional[str] = None      # owning trace (wf:<name> / inv:<id>)
    span_id: Optional[str] = None       # this invocation's root span id

    # ------------------------------------------------------------------
    @property
    def runtime_key(self) -> str:
        """The "same configuration" identity the paper's warm-reuse check
        uses: runtime + run config (e.g. model variant)."""
        return runtime_key_for(self.runtime_id, self.config)

    @property
    def rlat(self) -> Optional[float]:
        """Request latency: client submit to client result (REnd - RStart)."""
        return None if self.r_end is None else self.r_end - self.r_start

    @property
    def elat(self) -> Optional[float]:
        """Execution latency inside the runtime (EEnd - EStart)."""
        return None if self.e_end is None else self.e_end - self.e_start

    @property
    def dlat(self) -> Optional[float]:
        """Delivery latency: submit to execution start (EStart - RStart)."""
        return None if self.e_start is None else self.e_start - self.r_start

    def clear_attempt_timestamps(self) -> None:
        """Drop the per-attempt timestamps and placement of a lost attempt
        (keeps ``r_start`` — the client submitted once) so the next
        delivery records a fresh, monotone §V-A chain."""
        self.n_start = self.e_start = self.e_end = self.n_end = None
        self.node = self.accelerator = None
        self.cold_start = False
        self.prewarmed = False
        self.locality_hit = False

    def reset_for_retry(self) -> None:
        """Prepare a lost invocation for redelivery: wipe the dead
        attempt's timestamps and count it (``attempt`` += 1)."""
        self.clear_attempt_timestamps()
        self.attempt += 1

    def check_monotone(self) -> bool:
        """True when every reached timestamp respects the §V-A ordering."""
        ts = [self.r_start, self.n_start, self.e_start, self.e_end,
              self.n_end, self.r_end]
        seen = [t for t in ts if t is not None]
        return all(a <= b for a, b in zip(seen, seen[1:]))
