"""Admission control: per-tenant token buckets + weighted fair shedding.

The backends' only native admission rule is a single global bound (the
engine's ``max_queue``).  This controller runs *in front* of that bound,
at ``Backend.submit`` time, and decides per event:

* **tenant quotas** — each tenant draws from a token bucket
  (``rate`` events/s, ``burst`` capacity).  An empty bucket sheds the
  event with reason ``tenant-quota``; other tenants are untouched (the
  noisy-neighbor wall).
* **weighted fair queueing across runtimes** — when total backlog
  reaches ``fair_share_backlog``, an arriving event is shed (reason
  ``fair-share``) if its runtime already holds more than its
  weight-fraction of the queue.  Light runtimes keep landing events
  while a flooding runtime absorbs the shedding.

Sheds travel the *ordinary* failure path: the event settles immediately
as ``rejected``, its failure record is persisted to the object store,
and the gateway future raises
:class:`~repro_torch.gateway.future.InvocationRejected` — identical semantics
on both backends, and retry-safe by construction (a shed event never
executed).

The port's copy of ``repro.controlplane.admission`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.events import Invocation
from repro_torch.gateway.backends import CapacityHooks


@dataclasses.dataclass
class TokenBucket:
    """Standard token bucket: ``rate`` tokens/s up to ``burst``."""

    rate: float
    burst: float
    tokens: float = dataclasses.field(default=-1.0)   # -1 = start full
    last_t: Optional[float] = None

    def try_take(self, now: float) -> bool:
        """Refill to ``now`` and consume one token if available."""
        if self.tokens < 0:
            self.tokens = self.burst
        if self.last_t is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last_t) * self.rate)
        self.last_t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Quota + fairness knobs."""

    # tenant -> (rate events/s, burst); tenants without an entry use
    # default_quota (None = unlimited)
    tenant_quotas: Optional[Dict[str, Tuple[float, float]]] = None
    default_quota: Optional[Tuple[float, float]] = None
    # runtime_id -> weight for fair-share shedding (missing = 1.0)
    runtime_weights: Optional[Dict[str, float]] = None
    # total backlog at which fair-share shedding engages (None = never)
    fair_share_backlog: Optional[int] = None


class AdmissionController:
    """Stateful admit/shed decisions (token buckets live here)."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy or AdmissionPolicy()
        self._buckets: Dict[str, TokenBucket] = {}
        self.shed_counts: Dict[str, int] = {}       # reason -> count
        self.sheds: List[tuple] = []                # (t, tenant, rid, reason)

    # ------------------------------------------------------------------
    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        if tenant in self._buckets:
            return self._buckets[tenant]
        quota = (self.policy.tenant_quotas or {}).get(
            tenant, self.policy.default_quota)
        if quota is None:
            return None
        bucket = TokenBucket(rate=quota[0], burst=quota[1])
        self._buckets[tenant] = bucket
        return bucket

    def _weight_fraction(self, runtime_id: str,
                         backlog: Dict[str, int]) -> float:
        weights = self.policy.runtime_weights or {}
        active = set(backlog) | {runtime_id}
        total = sum(weights.get(r, 1.0) for r in active)
        return weights.get(runtime_id, 1.0) / max(total, 1e-9)

    # ------------------------------------------------------------------
    def admit(self, inv: Invocation, now: float,
              hooks: Optional[CapacityHooks]) -> Optional[str]:
        """None to admit ``inv``; otherwise the shed reason."""
        bucket = self._bucket(inv.tenant)
        if bucket is not None and not bucket.try_take(now):
            return self._shed(inv, now, f"tenant-quota "
                              f"({inv.tenant}: {bucket.rate}/s "
                              f"burst {bucket.burst:g})")

        limit = self.policy.fair_share_backlog
        if limit is not None and hooks is not None:
            backlog = hooks.backlog_by_runtime()
            total = sum(backlog.values())
            if total >= limit:
                share = backlog.get(inv.runtime_id, 0) / max(total, 1)
                if share > self._weight_fraction(inv.runtime_id, backlog):
                    return self._shed(inv, now,
                                      f"fair-share ({inv.runtime_id} holds "
                                      f"{share:.0%} of a full queue)")
        return None

    def _shed(self, inv: Invocation, now: float, reason: str) -> str:
        self.shed_counts[reason.split(" ", 1)[0]] = \
            self.shed_counts.get(reason.split(" ", 1)[0], 0) + 1
        self.sheds.append((now, inv.tenant, inv.runtime_id, reason))
        return reason
