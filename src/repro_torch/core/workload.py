"""Phase-based open-loop workload generation (§V-A, vocabulary of
Kuhlenkamp et al. [17]).

A workload is phases with target invocation throughput, e.g.
``P0=10 (2 min warm-up), P1=20 (10 min scaling), P2=20 (2 min cooldown)``.
Arrivals are uniformly spaced within each phase with optional jitter so
experiments are deterministic per seed.

The port's copy of ``repro.core.workload`` (the port imports nothing of
``repro``); only docstrings and imports differ.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List

from repro_torch.core.events import Invocation


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    duration_s: float
    target_rps: float


def paper_phases(p0: float, p1: float, p2: float,
                 scale: float = 1.0) -> List[Phase]:
    """The paper's 2min/10min/2min protocol (scale compresses durations)."""
    return [Phase("P0-warmup", 120 * scale, p0),
            Phase("P1-scaling", 600 * scale, p1),
            Phase("P2-cooldown", 120 * scale, p2)]


@dataclasses.dataclass
class PhaseWorkload:
    phases: List[Phase]
    runtime_id: str
    data_ref: str
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    jitter: float = 0.2           # fraction of inter-arrival spacing
    seed: int = 0

    def arrivals(self) -> List[float]:
        rng = random.Random(self.seed)
        times: List[float] = []
        t0 = 0.0
        for ph in self.phases:
            if ph.target_rps > 0:
                spacing = 1.0 / ph.target_rps
                t = t0
                while t < t0 + ph.duration_s:
                    times.append(t + rng.uniform(0, self.jitter * spacing))
                    t += spacing
            t0 += ph.duration_s
        return sorted(times)

    def events(self) -> List[Invocation]:
        return [Invocation(runtime_id=self.runtime_id, data_ref=self.data_ref,
                           config=dict(self.config), r_start=t)
                for t in self.arrivals()]

    @property
    def total_duration(self) -> float:
        return sum(p.duration_s for p in self.phases)
