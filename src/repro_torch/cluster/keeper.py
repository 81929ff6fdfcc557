"""Heartbeat bookkeeping for the master's worker-liveness keeper.

Every worker process posts a heartbeat every ``heartbeat_s`` seconds
(plus an implicit beat whenever it parks on ``take``).  The master's
keeper thread calls :meth:`HeartbeatKeeper.expired` each tick; a worker
whose last beat is older than ``timeout_s`` is declared dead, its queue
leases are released (``ScannableQueue.release_holder`` — immediate
requeue, no waiting out the per-event lease), and it is forgotten until
it says hello again.

This class is pure bookkeeping — no threads, no locks.  The master
calls every method under its own state lock, which is also why the
per-worker ``stats`` payload (the worker's self-reported dispatcher
counters, surfaced through ``stats``/capacity hooks) lives here: one
structure, one lock.

The port's copy of ``repro.cluster.keeper``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


class HeartbeatKeeper:
    """Last-beat table with expiry: the liveness half of at-least-once."""

    def __init__(self, timeout_s: float = 5.0):
        self.timeout_s = float(timeout_s)
        self._last_beat: Dict[str, float] = {}
        self._stats: Dict[str, Dict[str, Any]] = {}

    def beat(self, worker: str, now: float,
             stats: Optional[Dict[str, Any]] = None) -> None:
        """Record a heartbeat (re-registers a forgotten/dead worker)."""
        self._last_beat[worker] = now
        if stats is not None:
            self._stats[worker] = stats

    def expired(self, now: float) -> List[str]:
        """Pop and return every worker whose beat aged past the timeout.

        Popping makes death a one-shot event: the caller releases the
        dead worker's leases exactly once, and a worker that beats again
        later simply re-registers."""
        dead = [w for w, t in self._last_beat.items()
                if now - t > self.timeout_s]
        for w in dead:
            del self._last_beat[w]
            self._stats.pop(w, None)
        return dead

    def forget(self, worker: str) -> None:
        """Drop a worker deliberately (clean shutdown, not death)."""
        self._last_beat.pop(worker, None)
        self._stats.pop(worker, None)

    def alive(self) -> List[str]:
        """Currently-registered workers, sorted (directive routing)."""
        return sorted(self._last_beat)

    def stats_of(self, worker: str) -> Dict[str, Any]:
        """The worker's last self-reported stats payload ({} if none)."""
        return self._stats.get(worker, {})

    def report(self, now: float) -> Dict[str, Dict[str, Any]]:
        """Per-worker liveness + last stats (the ``stats`` op's view)."""
        return {w: {"age_s": now - t, "stats": self._stats.get(w, {})}
                for w, t in self._last_beat.items()}
