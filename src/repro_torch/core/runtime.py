"""Runtime environments (§IV-A): a copy of ``repro.core.runtime``'s
runtime-instance contract for the port.

A :class:`RuntimeDef` is the platform-owned, preconfigured stack: it
declares which accelerator types can serve it and with what performance
profile, plus the real-execution entry points. ``setup`` is the cold start
(weights on the card); ``fn``/``batch_fn`` are the invocations;
:class:`RuntimeRegistry` is the catalogue a gateway backend keeps. The port
imports nothing of ``repro``, so this framework-free module is copied.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# accelerator type advertised for runtimes executing directly on this
# host's CUDA device through the port
HOST_ACC = "host-cuda"


@dataclasses.dataclass(frozen=True)
class SimProfile:
    """Lognormal service-time model with median ``elat_median_s``."""
    elat_median_s: float
    sigma: float = 0.05
    cold_start_s: float = 2.5       # process spawn + model load
    result_bytes: int = 65536

    def sample_elat(self, rng: random.Random) -> float:
        """Draw one service time (seconds) from the lognormal model."""
        return self.elat_median_s * math.exp(rng.gauss(0.0, self.sigma))


@dataclasses.dataclass
class RuntimeDef:
    """A platform-owned runtime environment (§IV-A); field meanings are
    those of ``repro.core.runtime.RuntimeDef``."""

    runtime_id: str
    profiles: Dict[str, SimProfile]
    fn: Optional[Callable[[Any, Dict[str, Any]], Any]] = None
    setup: Optional[Callable[[], Any]] = None
    artifact_bytes: int = 60 << 20
    batch_fn: Optional[Callable[[List[Any], Dict[str, Any]], List[Any]]] = None
    max_batch: int = 1
    batch_buckets: Optional[Tuple[int, ...]] = None
    # total times one event may be started before a lost delivery (a
    # worker crash) settles as a permanent ``retries exhausted`` record
    max_attempts: int = 3
    # control-plane warm-pool hints (a WarmPolicy overrides them):
    # keep at least this many instances resident (prewarmed on attach) ...
    min_warm: int = 0
    # ... and keep idle instances alive this long before evicting
    # (None = the platform default keep-alive)
    keep_alive_s: Optional[float] = None

    def supports(self, acc_type: str) -> bool:
        """True when accelerator type ``acc_type`` can serve this runtime."""
        return acc_type in self.profiles

    @property
    def is_real(self) -> bool:
        """True when invocations execute actual code on this host."""
        return self.fn is not None or self.batch_fn is not None

    @property
    def is_batchable(self) -> bool:
        """True when one call may serve a micro-batch of several events."""
        return self.batch_fn is not None and self.max_batch > 1

    def batch_limit(self, backend_max: int) -> int:
        """Largest micro-batch the dispatcher may form for this runtime."""
        if self.batch_fn is None:
            return 1
        limit = min(self.max_batch, backend_max)
        if self.batch_buckets:
            limit = min(limit, max(self.batch_buckets))
        return max(limit, 1)

    def bucket_size(self, n: int) -> int:
        """Padded batch size for ``n`` real events (pad-to-bucket shapes)."""
        if not self.batch_buckets:
            return n
        fits = [b for b in self.batch_buckets if b >= n]
        return min(fits) if fits else n


def run_batch(rdef: RuntimeDef, datas: Sequence[Any],
              config: Dict[str, Any]) -> List[Any]:
    """Execute one micro-batch through ``rdef``'s best entry point.

    Pads to the runtime's bucket size, calls ``batch_fn`` once (or calls
    ``fn`` per event when the runtime is not batchable), and returns
    exactly ``len(datas)`` results. ``config["attempts"]`` (one delivery
    attempt number per event) is padded alongside the datas for
    ``batch_fn``; ``fn`` receives its own event's number as
    ``config["attempt"]``.
    """
    datas = list(datas)
    n = len(datas)
    attempts = list(config.get("attempts") or [])[:n]
    attempts += [0] * (n - len(attempts))
    if rdef.batch_fn is not None and (n > 1 or rdef.fn is None):
        pad = rdef.bucket_size(n) - n
        padded = datas + [datas[-1]] * pad
        results = list(rdef.batch_fn(
            padded, dict(config, n_real=n,
                         attempts=attempts + [attempts[-1]] * pad)))
        if len(results) < n:
            raise RuntimeError(
                f"batch_fn for {rdef.runtime_id!r} returned {len(results)} "
                f"results for a batch of {n}")
        return results[:n]
    return [rdef.fn(data, dict(config, attempt=a))
            for data, a in zip(datas, attempts)]


class RuntimeRegistry:
    """The object-store-backed runtime catalogue."""

    def __init__(self):
        self._defs: Dict[str, RuntimeDef] = {}

    def register(self, rdef: RuntimeDef) -> None:
        """Add (or replace) a runtime definition under its id."""
        self._defs[rdef.runtime_id] = rdef

    def ids(self):
        """All registered runtime ids, in registration order."""
        return list(self._defs)

    def get(self, runtime_id: str) -> RuntimeDef:
        """The definition for ``runtime_id`` (KeyError when unknown)."""
        return self._defs[runtime_id]

    def __contains__(self, runtime_id: str) -> bool:
        return runtime_id in self._defs
