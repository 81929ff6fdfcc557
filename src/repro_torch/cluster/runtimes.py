"""Importable runtime factories — the cluster's runtime catalogue unit.

A :class:`~repro_torch.core.runtime.RuntimeDef` carries live callables
(``fn``/``batch_fn``/``setup``) that cannot cross a process boundary, so
the cluster registers runtimes *by spec*: an importable factory
reference ``"pkg.module:callable"`` plus JSON-serializable kwargs.
Every process (the master for bookkeeping, each worker for execution)
imports the factory and constructs its own local definition via
:func:`load_runtime_spec`, which also stamps ``RuntimeDef.spec`` /
``spec_kwargs`` so a loaded definition can be re-registered elsewhere.

The factories below are module-level (importable from a bare
``python -m repro_torch.cluster.worker`` subprocess):

* :func:`sleep_runtime` — an accelerator-bound stand-in whose service
  time is a plain ``time.sleep``.  Sleeps overlap across worker
  *processes* regardless of host core count, so 1→4-worker throughput
  scaling measured with it reflects the dispatch plane, not Python
  compute contention (this container has one core).
* :func:`add_runtime` — instant arithmetic echo for workflow-chain
  tests (child input = parent output + ``add``).
* :func:`serve_runtime` — the real thing: wraps
  :func:`repro_torch.serve.api.make_serve_runtime`, so ``launch/serve.py
  --cluster N`` generates inside each worker process, on the card.

The port's copy of ``repro.cluster.runtimes``.  The one difference is in
:func:`serve_runtime`: the reference always serves ``.reduced()``; the
port serves the arch as registered on the card by default, and its spec
kwargs ``reduced`` and ``device`` select the smoke-test widths and the
host.  Nothing here imports torch until a serve runtime is built.
"""
from __future__ import annotations

import importlib
import os
import time
from typing import Any, Dict, Optional

from repro_torch.core.runtime import HOST_ACC, RuntimeDef, SimProfile


def load_runtime_spec(spec: str,
                      kwargs: Optional[Dict[str, Any]] = None) -> RuntimeDef:
    """Import ``"pkg.module:callable"``, call it, stamp the spec fields.

    The factory must return a :class:`RuntimeDef`; its kwargs must be
    JSON-serializable (they travel in RPC frames)."""
    mod_name, sep, attr = spec.partition(":")
    if not sep or not mod_name or not attr:
        raise ValueError(f"malformed runtime spec {spec!r} "
                         f"(expected 'pkg.module:callable')")
    factory = getattr(importlib.import_module(mod_name), attr)
    rdef = factory(**(kwargs or {}))
    if not isinstance(rdef, RuntimeDef):
        raise TypeError(f"runtime spec {spec!r} returned "
                        f"{type(rdef).__name__}, not RuntimeDef")
    rdef.spec = spec
    rdef.spec_kwargs = dict(kwargs or {})
    return rdef


def sleep_runtime(runtime_id: str = "sleep", sleep_s: float = 0.01,
                  max_attempts: int = 3,
                  max_batch: int = 1) -> RuntimeDef:
    """Accelerator-bound stand-in: each event blocks ``sleep_s`` seconds
    (an I/O wait, like a device executing off the host CPU) and echoes
    its payload plus the serving process's pid — the bench/test probe
    for which worker ran what."""
    def fn(data: Any, config: Dict[str, Any]) -> Dict[str, Any]:
        time.sleep(sleep_s)
        return {"echo": data, "pid": os.getpid()}

    return RuntimeDef(
        runtime_id=runtime_id,
        profiles={HOST_ACC: SimProfile(elat_median_s=sleep_s,
                                       cold_start_s=0.0)},
        fn=fn, setup=lambda: {"warm": True},
        max_batch=max_batch, max_attempts=max_attempts)


def add_runtime(runtime_id: str = "add", add: int = 1,
                max_attempts: int = 3) -> RuntimeDef:
    """Instant chainable arithmetic: result = input + ``add`` (input 0
    when the payload is not a number) — workflow steps compose it."""
    def fn(data: Any, config: Dict[str, Any]) -> int:
        base = data if isinstance(data, (int, float)) else 0
        return int(base) + add

    return RuntimeDef(
        runtime_id=runtime_id,
        profiles={HOST_ACC: SimProfile(elat_median_s=1e-4,
                                       cold_start_s=0.0)},
        fn=fn, max_attempts=max_attempts)


def serve_runtime(arch: str = "granite-3-2b", max_batch: int = 4,
                  max_slots: int = 4, max_len: int = 64,
                  page_size: int = 16, prefill_chunk: int = 0,
                  reduced: bool = False,
                  device: Optional[str] = None) -> RuntimeDef:
    """A real generation runtime (weights from seed 0 and the engine built
    in the worker process's ``setup``; heavy imports deferred to load
    time).  ``page_size``/``prefill_chunk`` select the worker engines' KV
    cache layout (0 = the dense per-slot reference), ``reduced`` the
    arch's smoke-test widths and ``device`` where the engine runs
    (``None``: the card) — they travel in the spec kwargs, so every
    worker process serves off the same layout, widths and device."""
    from repro_torch.configs import get_config
    from repro_torch.serve.api import make_serve_runtime
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return make_serve_runtime(cfg, max_slots=max_slots, max_len=max_len,
                              max_batch=max_batch, page_size=page_size,
                              prefill_chunk=prefill_chunk, device=device)
