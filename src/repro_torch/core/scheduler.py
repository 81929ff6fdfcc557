"""Event-selection policies and the placement-decision layer.

The paper ships warm-affinity behaviour (scan the queue, prefer events
whose runtime is already warm; after completion, take a matching event
first).  FIFO is the ablation baseline; cost-aware is a beyond-paper policy
exploiting heterogeneous accelerator pricing.

**Placement decisions.**  Every policy returns an explicit
:class:`PlacementDecision` — the (event, accelerator) pair plus the
policy's reasoning (objective, score, warm/locality flags, estimated
fetch time).  The node manager consumes the decision; benchmarks and
tests can audit *why* an event landed where it did.  Decisions unpack as
``inv, acc = decision`` for the original tuple contract.

**Objective schedulers** (``hetero-latency`` / ``hetero-cost`` /
``hetero-energy``) generalize the cost policy to a pluggable objective
over a heterogeneous fleet: each candidate (event, accelerator) is scored
by expected busy seconds (profile ELat + cold-start debt + estimated
input fetch) weighted per objective — seconds for latency, accelerator
dollars for cost, active-watt joules for energy.  Data locality feeds the
fetch term: an event whose ``data_ref`` is resident on this node reads
locally (fetch 0), and events resident on *another* live node are briefly
deferred (:data:`LOCALITY_DEFER_S`) so the owner gets first claim — the
workflow chain-placement mechanism.  The scoring helpers
(:func:`service_estimate_s` / :func:`fetch_estimate` /
:func:`objective_score`) are shared with the cluster master's take path
so sim and cluster place identically on identical traces.

**Indexed picks.**  Candidacy is a property of the *bucket*, not the
event: whether a node can run an event depends only on its ``runtime_id``
(registry + accelerator support), and warmth depends only on its
``runtime_key``.  So every policy picks from the queue's per-runtime /
per-key bucket heads (``head_for_runtime`` / ``head_for_key``) instead of
scanning all queued events — O(distinct runtimes × accelerators) per pick
rather than O(queued events).  (The objective policies additionally walk
bucket *members* for the per-event locality term, still skipping
unrunnable runtimes.)  The pre-index scan implementations are preserved
as ``Scan*Scheduler`` reference policies
(:data:`SCAN_REFERENCE_POLICIES`); the differential suite
(``tests/test_scale_paths.py``) asserts both produce the identical
virtual-time schedule.

The port's copy of ``repro.core.scheduler`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple, TYPE_CHECKING

from repro_torch.core.accelerator import Accelerator, AcceleratorSpec
from repro_torch.core.events import Invocation
from repro_torch.core.queue import ScannableQueue
from repro_torch.core.runtime import RuntimeDef
from repro_torch.core.storage import ObjectStore

if TYPE_CHECKING:
    from repro_torch.core.node import NodeManager

# grace window during which an event whose input is resident on ANOTHER
# live node is left for that node to claim (it reads the input locally);
# after the window anyone may take it — bounded wait, no stranding
LOCALITY_DEFER_S = 0.05

# the control-plane / CLI objective names and the policy implementing each
OBJECTIVES = ("latency", "cost", "energy")


@dataclasses.dataclass
class PlacementDecision:
    """One placement: the picked event, where it runs, and why.

    Unpacks as ``inv, acc = decision`` (the original tuple contract)."""

    inv: Invocation
    accelerator: Accelerator
    node_name: str
    policy: str                     # scheduler name that decided
    objective: str = "latency"
    score: float = 0.0              # objective units (s / $ / J); 0 for
    #                                 the non-scoring policies
    warm: bool = False              # picked accelerator has the key warm
    locality_hit: bool = False      # data_ref resident on the picked node
    est_fetch_s: float = 0.0        # input fetch time the score assumed

    def __iter__(self) -> Iterator:
        yield self.inv
        yield self.accelerator


# ----------------------------------------------------------------------
# shared scoring helpers — used by the sim objective schedulers AND the
# cluster master's locality-aware take path (one implementation, so sim
# and cluster placement agree on identical traces)
# ----------------------------------------------------------------------
def service_estimate_s(rdef: RuntimeDef, acc: Accelerator,
                       runtime_key: str) -> Tuple[float, bool]:
    """Expected busy seconds of running ``runtime_key`` on ``acc``
    (profile median ELat + cold-start debt); returns ``(seconds, warm)``.
    Defaults match :class:`CostAwareScheduler` for unprofiled types."""
    prof = rdef.profiles.get(acc.spec.type)
    elat = prof.elat_median_s if prof else 1.0
    warm = acc.has_warm(runtime_key)
    cold = 0.0 if warm else (prof.cold_start_s if prof else 2.0)
    return elat + cold, warm


def fetch_estimate(store: ObjectStore, node_name: str, inv: Invocation,
                   now: float) -> Tuple[float, bool, Optional[float]]:
    """Estimated input-fetch seconds for ``inv`` landing on ``node_name``.

    Returns ``(fetch_s, local, defer_until)``:

    * resident here       → ``(0.0, True, None)`` — local read;
    * resident elsewhere  → within :data:`LOCALITY_DEFER_S` of submission
      the candidate is vetoed (``defer_until`` set) so the owner claims
      it; past the window it is priced as a normal store fetch;
    * not resident        → store RTT + size/bandwidth (size via the
      counter-free ``peek_size`` — estimates are not data-plane traffic).
    """
    ref = inv.data_ref
    if not ref:
        return store.rtt, False, None
    owner = store.resident_on(ref)
    if owner is not None and store.peek_size(ref) is None:
        owner = None        # hint outlived the blob (outcome_max trim)
    if owner == node_name:
        return 0.0, True, None
    if owner is not None:
        born = inv.r_start if inv.r_start is not None else now
        if now - born < LOCALITY_DEFER_S:
            return 0.0, False, born + LOCALITY_DEFER_S
    size = store.peek_size(ref)
    fetch = store.rtt if size is None else store.rtt + size / store.bandwidth
    return fetch, False, None


def objective_score(objective: str, spec: AcceleratorSpec,
                    busy_s: float) -> float:
    """Weight expected busy seconds by the objective: seconds (latency),
    dollars (cost), or active-watt joules (energy)."""
    if objective == "cost":
        return busy_s * spec.cost_per_hour / 3600.0
    if objective == "energy":
        return spec.active_watts * busy_s
    return busy_s


class Scheduler:
    """Base event-selection policy (the node's queue-scan strategy)."""

    name = "base"
    objective = "latency"
    # the paper's "query for a same-configuration event on completion" —
    # part of the Hardless queue protocol; the naive FIFO baseline lacks it
    reuse_on_complete = True

    def pick(self, queue: ScannableQueue, node: "NodeManager",
             now: float) -> Optional[PlacementDecision]:
        """Take one placement decision to run, or None to idle."""
        raise NotImplementedError

    def _decision(self, node: "NodeManager", inv: Invocation,
                  acc: Accelerator, *, score: float = 0.0,
                  warm: bool = False, locality_hit: bool = False,
                  est_fetch_s: float = 0.0) -> PlacementDecision:
        return PlacementDecision(
            inv=inv, accelerator=acc, node_name=node.name,
            policy=self.name, objective=self.objective, score=score,
            warm=warm, locality_hit=locality_hit, est_fetch_s=est_fetch_s)

    # shared helper: accelerators with capacity that support the runtime
    @staticmethod
    def _candidates(node: "NodeManager", inv: Invocation) -> List[Accelerator]:
        rdef = node.registry.get(inv.runtime_id)
        return [a for a in node.accelerators
                if a.free_slots > 0 and rdef.supports(a.spec.type)]

    # shared helper: oldest runnable bucket head + its first fitting
    # accelerator (the FIFO rule both fifo and warm's fallback use)
    def _oldest_runnable(self, queue: ScannableQueue, node: "NodeManager"
                         ) -> Optional[Tuple[int, Invocation, Accelerator]]:
        best: Optional[Tuple[int, Invocation, Accelerator]] = None
        for rid in queue.runtime_ids_present():
            if rid not in node.registry:
                continue
            inv = queue.head_for_runtime(rid)
            accs = self._candidates(node, inv)
            if not accs:
                continue
            seq = queue.order_key(inv)
            if best is None or seq < best[0]:
                best = (seq, inv, accs[0])
        return best


class FifoScheduler(Scheduler):
    """Oldest runnable event, first fitting accelerator — fully cold-start
    blind (the naive baseline the paper's queue-scan behaviour improves)."""
    name = "fifo"
    reuse_on_complete = False

    def pick(self, queue, node, now):
        """Oldest runnable bucket head on the first accelerator that fits."""
        best = self._oldest_runnable(queue, node)
        if best is None:
            return None
        _, inv, acc = best
        queue.take_id(inv.inv_id, now, holder=node.name)
        return self._decision(node, inv, acc,
                              warm=acc.has_warm(inv.runtime_key))


class WarmAffinityScheduler(Scheduler):
    """The paper's policy: scan for events already warm on this node; fall
    back to the oldest runnable event (which will cold-start)."""
    name = "warm"

    def pick(self, queue, node, now):
        """Prefer events warm on this node, else the oldest runnable."""
        # pass 1: warm match — warmth is a runtime_key property, so the
        # oldest warm event is the min over warm key-bucket heads
        best = None
        warm_hit = True
        for key in queue.runtime_keys_present():
            inv = queue.head_for_key(key)
            if inv.runtime_id not in node.registry:
                continue
            warm = [a for a in self._candidates(node, inv)
                    if a.has_warm(key)]
            if not warm:
                continue
            seq = queue.order_key(inv)
            if best is None or seq < best[0]:
                best = (seq, inv, warm[0])
        if best is None:
            # pass 2: oldest runnable
            warm_hit = False
            best = self._oldest_runnable(queue, node)
            if best is None:
                return None
        _, inv, acc = best
        queue.take_id(inv.inv_id, now, holder=node.name)
        return self._decision(node, inv, acc, warm=warm_hit)


class CostAwareScheduler(Scheduler):
    """Beyond paper: prefer the cheapest accelerator-seconds per event
    (cost_per_hour x expected ELat), warm instances get a cold-start credit."""
    name = "cost"
    objective = "cost"

    def pick(self, queue, node, now):
        """Cheapest expected accelerator-seconds over all (event, acc).

        Cost depends only on (runtime_id, accelerator, warm(runtime_key)),
        so it is evaluated once per key bucket; the winning bucket is then
        searched for its min-(r_start, queue-position) event — the same
        event the full scan picked, without pricing every queued event.
        """
        best_cost = None            # (cost, bucket_key, acc)
        for key in queue.runtime_keys_present():
            head = queue.head_for_key(key)
            if head.runtime_id not in node.registry:
                continue
            rdef = node.registry.get(head.runtime_id)
            for acc in self._candidates(node, head):
                prof = rdef.profiles.get(acc.spec.type)
                elat = prof.elat_median_s if prof else 1.0
                cold = 0.0 if acc.has_warm(key) else \
                    (prof.cold_start_s if prof else 2.0)
                cost = (elat + cold) * acc.spec.cost_per_hour / 3600.0
                if best_cost is None or cost < best_cost[0]:
                    best_cost = (cost, key, acc)
        if best_cost is None:
            return None
        cost, key, acc = best_cost
        # equal-cost tie-break matches the scan: min (r_start, position)
        # over every bucket priced at the winning cost
        best = None
        for bkey in queue.runtime_keys_present():
            head = queue.head_for_key(bkey)
            if head.runtime_id not in node.registry:
                continue
            rdef = node.registry.get(head.runtime_id)
            accs = self._candidates(node, head)
            if not accs:
                continue
            for bacc in accs:
                prof = rdef.profiles.get(bacc.spec.type)
                elat = prof.elat_median_s if prof else 1.0
                cold = 0.0 if bacc.has_warm(bkey) else \
                    (prof.cold_start_s if prof else 2.0)
                bcost = (elat + cold) * bacc.spec.cost_per_hour / 3600.0
                if bcost > cost:
                    continue
                for inv in queue.bucket_for_key(bkey):
                    cand = ((bcost, inv.r_start or 0.0),
                            queue.order_key(inv), inv, bacc)
                    if best is None or cand[:2] < best[:2]:
                        best = cand
        if best is None:
            return None
        (bcost, _), _, inv, acc = best
        queue.take_id(inv.inv_id, now, holder=node.name)
        return self._decision(node, inv, acc, score=bcost,
                              warm=acc.has_warm(inv.runtime_key))


class ObjectiveScheduler(Scheduler):
    """The heterogeneous-placement family: score every runnable
    (event, accelerator) by expected busy seconds — profile ELat +
    cold-start debt + estimated input fetch — weighted per objective, with
    data-locality folded into the fetch term (resident input → fetch 0;
    resident on another live node → briefly deferred so the owner claims
    it).  Tie-break matches :class:`CostAwareScheduler`'s discipline:
    min ``((score, r_start), queue position)``."""

    name = "hetero-latency"
    objective = "latency"

    def pick(self, queue, node, now):
        """Min objective score over runnable (event, acc) pairs."""
        best = None         # ((score, r_start), seq, inv, acc, warm, ...)
        wake: Optional[float] = None
        for key in queue.runtime_keys_present():
            head = queue.head_for_key(key)
            if head.runtime_id not in node.registry:
                continue
            rdef = node.registry.get(head.runtime_id)
            accs = self._candidates(node, head)
            if not accs:
                continue
            for acc in accs:
                busy, warm = service_estimate_s(rdef, acc, key)
                for inv in queue.bucket_for_key(key):
                    fetch, local, defer_until = fetch_estimate(
                        node.store, node.name, inv, now)
                    if defer_until is not None:
                        wake = defer_until if wake is None \
                            else min(wake, defer_until)
                        continue
                    score = objective_score(self.objective, acc.spec,
                                            busy + fetch)
                    cand = ((score, inv.r_start or 0.0),
                            queue.order_key(inv), inv, acc, warm, local,
                            fetch)
                    if best is None or cand[:2] < best[:2]:
                        best = cand
        if best is None:
            if wake is not None:
                node.schedule_wakeup(wake)
            return None
        (score, _), _, inv, acc, warm, local, fetch = best
        queue.take_id(inv.inv_id, now, holder=node.name)
        return self._decision(node, inv, acc, score=score, warm=warm,
                              locality_hit=local, est_fetch_s=fetch)


class CostObjectiveScheduler(ObjectiveScheduler):
    """Objective = accelerator dollars per event."""
    name = "hetero-cost"
    objective = "cost"


class EnergyObjectiveScheduler(ObjectiveScheduler):
    """Objective = active-watt joules per event."""
    name = "hetero-energy"
    objective = "energy"


# ----------------------------------------------------------------------
# Scan-based reference policies (pre-index implementations, kept verbatim
# for the differential suite and as executable documentation of the
# behaviour the indexed picks must reproduce)
# ----------------------------------------------------------------------
class ScanFifoScheduler(FifoScheduler):
    """Reference O(n)-scan FIFO (the pre-index implementation)."""
    name = "scan-fifo"

    def pick(self, queue, node, now):
        """Oldest runnable event on the first accelerator that fits."""
        for inv in queue.scan():
            if inv.runtime_id not in node.registry:
                continue
            accs = self._candidates(node, inv)
            if accs:
                queue.take_where(lambda e: e.inv_id == inv.inv_id, now,
                                 holder=node.name)
                return self._decision(
                    node, inv, accs[0],
                    warm=accs[0].has_warm(inv.runtime_key))
        return None


class ScanWarmAffinityScheduler(WarmAffinityScheduler):
    """Reference O(n)-scan warm-affinity (the pre-index implementation)."""
    name = "scan-warm"

    def pick(self, queue, node, now):
        """Prefer events warm on this node, else the oldest runnable."""
        # pass 1: warm match
        for inv in queue.scan():
            if inv.runtime_id not in node.registry:
                continue
            warm = [a for a in self._candidates(node, inv)
                    if a.has_warm(inv.runtime_key)]
            if warm:
                queue.take_where(lambda e: e.inv_id == inv.inv_id, now,
                                 holder=node.name)
                return self._decision(node, inv, warm[0], warm=True)
        # pass 2: oldest runnable
        for inv in queue.scan():
            if inv.runtime_id not in node.registry:
                continue
            accs = self._candidates(node, inv)
            if accs:
                queue.take_where(lambda e: e.inv_id == inv.inv_id, now,
                                 holder=node.name)
                return self._decision(node, inv, accs[0], warm=False)
        return None


class ScanCostAwareScheduler(CostAwareScheduler):
    """Reference O(n·accs)-scan cost-aware (the pre-index implementation)."""
    name = "scan-cost"

    def pick(self, queue, node, now):
        """Cheapest expected accelerator-seconds over all (event, acc)."""
        best = None
        for inv in queue.scan():
            if inv.runtime_id not in node.registry:
                continue
            rdef = node.registry.get(inv.runtime_id)
            for acc in self._candidates(node, inv):
                prof = rdef.profiles.get(acc.spec.type)
                elat = prof.elat_median_s if prof else 1.0
                cold = 0.0 if acc.has_warm(inv.runtime_key) else \
                    (prof.cold_start_s if prof else 2.0)
                cost = (elat + cold) * acc.spec.cost_per_hour / 3600.0
                key = (cost, inv.r_start or 0.0)
                if best is None or key < best[0]:
                    best = (key, inv, acc)
        if best is None:
            return None
        (cost, _), inv, acc = best
        queue.take_where(lambda e: e.inv_id == inv.inv_id, now,
                         holder=node.name)
        return self._decision(node, inv, acc, score=cost,
                              warm=acc.has_warm(inv.runtime_key))


class ScanObjectiveScheduler(ObjectiveScheduler):
    """Reference O(n·accs)-scan objective scheduler — the same scoring,
    locality and defer rules as :class:`ObjectiveScheduler`, evaluated by
    walking every queued event (the differential suite asserts both
    produce identical schedules on heterogeneous fleets)."""
    name = "scan-hetero-latency"

    def pick(self, queue, node, now):
        """Min objective score over all queued (event, acc) pairs."""
        best = None
        wake: Optional[float] = None
        for inv in queue.scan():
            if inv.runtime_id not in node.registry:
                continue
            rdef = node.registry.get(inv.runtime_id)
            for acc in self._candidates(node, inv):
                busy, warm = service_estimate_s(rdef, acc, inv.runtime_key)
                fetch, local, defer_until = fetch_estimate(
                    node.store, node.name, inv, now)
                if defer_until is not None:
                    wake = defer_until if wake is None \
                        else min(wake, defer_until)
                    continue
                score = objective_score(self.objective, acc.spec,
                                        busy + fetch)
                key = (score, inv.r_start or 0.0)
                if best is None or key < best[0]:
                    best = (key, inv, acc, warm, local, fetch)
        if best is None:
            if wake is not None:
                node.schedule_wakeup(wake)
            return None
        (score, _), inv, acc, warm, local, fetch = best
        queue.take_where(lambda e: e.inv_id == inv.inv_id, now,
                         holder=node.name)
        return self._decision(node, inv, acc, score=score, warm=warm,
                              locality_hit=local, est_fetch_s=fetch)


class ScanCostObjectiveScheduler(ScanObjectiveScheduler):
    name = "scan-hetero-cost"
    objective = "cost"


class ScanEnergyObjectiveScheduler(ScanObjectiveScheduler):
    name = "scan-hetero-energy"
    objective = "energy"


POLICIES = {c.name: c for c in
            (FifoScheduler, WarmAffinityScheduler, CostAwareScheduler,
             ObjectiveScheduler, CostObjectiveScheduler,
             EnergyObjectiveScheduler)}

# the scan references, keyed by the *production* policy name they mirror
SCAN_REFERENCE_POLICIES = {
    "fifo": ScanFifoScheduler,
    "warm": ScanWarmAffinityScheduler,
    "cost": ScanCostAwareScheduler,
    "hetero-latency": ScanObjectiveScheduler,
    "hetero-cost": ScanCostObjectiveScheduler,
    "hetero-energy": ScanEnergyObjectiveScheduler,
}

# control-plane objective -> production policy name
OBJECTIVE_POLICIES = {obj: f"hetero-{obj}" for obj in OBJECTIVES}


def make_scheduler(name: str, *, reference_scan: bool = False) -> Scheduler:
    """Instantiate a policy by name (``fifo`` / ``warm`` / ``cost`` /
    ``hetero-latency`` / ``hetero-cost`` / ``hetero-energy``).
    ``reference_scan=True`` returns the pre-index O(n)-scan implementation
    of the same policy (differential testing / ablation)."""
    if reference_scan:
        return SCAN_REFERENCE_POLICIES[name]()
    return POLICIES[name]()
