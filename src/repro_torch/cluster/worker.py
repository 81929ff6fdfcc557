"""The cluster worker process: a node manager over the card.

Each worker owns its own Python interpreter (its own GIL) and its own
CUDA context on the card (several workers on one card each hold a model
copy and time-slice the device), and runs the PR-2 micro-batching
dispatcher loop against the master instead of an in-process queue:

    take (long-poll, leases granted master-side)
      -> fetch input blobs (RPC ``get``, small local cache)
      -> acquire the warm ``setup()`` handle (LRU, exactly the engine
         backend's warm-pool semantics)
      -> ``run_batch`` (one batched call or per-event fns)
      -> settle (outcome envelopes; refusals — another attempt settled
         first — are counted and dropped, never retried)

A second connection runs the **heartbeat** thread: every ``heartbeat_s``
it posts liveness + dispatcher stats and applies the control-plane
directives the master returns (prewarm / evict / pin).  If the worker
process dies — SIGKILL included — the beats stop, the master's keeper
expires it, and its leased events requeue for the surviving workers:
the at-least-once path the fault benches exercise with real process
death.

Timestamps are reported on the master clock (offset learned at hello).
Run directly:

    python -m repro_torch.cluster.worker --master 127.0.0.1:7000 --name w0

The port's copy of ``repro.cluster.worker``, with two differences:

* a prewarm directive runs on a thread of its own, never on the
  heartbeat thread: the reference pulls the catalogue there over the
  take connection (blocked up to 5 s by a parked ``take``) and runs
  ``setup()`` there, so a cold start longer than the heartbeat timeout
  reads as death (the port pulls over the heartbeat connection, whose
  requests never park).  At most one ``setup()`` of a key runs at a
  time: a repeated prewarm directive while it runs does nothing (as in
  the reference, whose one beat thread ran them in turn), and a cold
  start of that key waits for it and serves its handle;
* dropping a warm handle (eviction, LRU) gives its card memory back to
  the driver (``torch.cuda.empty_cache``), not only to this process's
  caching allocator: the other workers on the card need it.

torch is imported only by a runtime that needs it (``serve_runtime``).
"""
from __future__ import annotations

import argparse
import gc
import os
import pickle
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from repro_torch.core.events import Invocation
from repro_torch.core.runtime import HOST_ACC, RuntimeRegistry, run_batch
from repro_torch.core.storage import make_outcome, unwrap_outcome
from repro_torch.cluster.rpc import (RpcClient, decode_blob, encode_blob,
                               inv_from_wire)
from repro_torch.cluster.runtimes import load_runtime_spec
from repro_torch.obs import TRACER

DATA_CACHE_MAX = 64


class Worker:
    """One dispatcher process serving micro-batches from the master."""

    def __init__(self, addr: str, name: str, *, max_batch: int = 8,
                 heartbeat_s: float = 1.0, max_warm: int = 8,
                 acc_type: str = HOST_ACC,
                 connect_timeout_s: float = 10.0):
        self.addr = addr
        self.name = name
        self.acc_type = acc_type or HOST_ACC
        self.max_batch = max(int(max_batch), 1)
        self.heartbeat_s = max(float(heartbeat_s), 0.05)
        self.max_warm = max(int(max_warm), 1)
        # two connections: the take/settle loop and the heartbeat thread
        # (one outstanding request per connection — see rpc.py)
        self._main = RpcClient(addr, connect_timeout_s=connect_timeout_s)
        self._hb = RpcClient(addr, connect_timeout_s=connect_timeout_s)
        hello = self._main.request("hello", role="worker", name=name)
        # master-clock conversion: now() = local monotonic + offset
        self._offset = hello["now"] - time.monotonic()
        self._catalog_version = -1
        self._sync_lock = threading.Lock()  # catalogue sync: loop + prewarm
        self.registry = RuntimeRegistry()
        self._lock = threading.Lock()       # handles/pins vs heartbeat
        self._handles: "OrderedDict[str, Any]" = OrderedDict()
        self._pinned: set = set()
        self._prewarmed: set = set()        # installed by directive, unserved
        # key -> set when its running setup() ends (one setup per key)
        self._building: Dict[str, threading.Event] = {}
        self._data_cache: "OrderedDict[str, Any]" = OrderedDict()
        self._stop = threading.Event()
        self._beat_now = threading.Event()  # nudge after each settle
        self.n_batches = 0
        self.n_cold_starts = 0
        self.n_warm_starts = 0
        self.n_prewarms = 0
        self.n_settled = 0
        self.n_settle_refused = 0
        self.n_data_local = 0       # input reads served from the cache
        self._inflight_n = 0        # events mid-execution (heartbeat stat)

    def now(self) -> float:
        """Current time on the master clock."""
        return time.monotonic() + self._offset

    # -- catalogue sync --------------------------------------------------
    def _sync_runtimes(self, client: Optional[RpcClient] = None) -> None:
        """Pull the (spec, kwargs) catalogue over ``client`` (default: the
        take/settle connection) and build local definitions (imports the
        factories — this is where model-serving runtimes load)."""
        with self._sync_lock:
            rsp = (client or self._main).request("runtime_specs")
            if rsp["catalog_version"] == self._catalog_version:
                return
            for entry in rsp["specs"]:
                rdef = load_runtime_spec(entry["spec"], entry.get("kwargs"))
                if rdef.runtime_id not in self.registry:
                    self.registry.register(rdef)
            self._catalog_version = rsp["catalog_version"]

    # -- main loop -------------------------------------------------------
    def run(self) -> None:
        """Serve until the master shuts down (or disappears)."""
        self._sync_runtimes()
        hb = threading.Thread(target=self._heartbeat_loop,
                              name=f"{self.name}-heartbeat", daemon=True)
        hb.start()
        try:
            while not self._stop.is_set():
                try:
                    rsp = self._main.request(
                        "take", worker=self.name,
                        supported=self.registry.ids(),
                        max_batch=self.max_batch, timeout_s=5.0)
                except ConnectionError:
                    break               # master gone — nothing left to serve
                if rsp.get("shutdown"):
                    break
                if rsp["catalog_version"] != self._catalog_version:
                    self._sync_runtimes()
                events = rsp.get("events") or []
                if events:
                    self._execute_batch([inv_from_wire(e) for e in events])
        finally:
            self._stop.set()
            self._beat_now.set()        # wake the heartbeat thread to exit
            self._main.close()
            self._hb.close()

    def stop(self) -> None:
        """Ask the loop to exit after its current batch (thread hosting)."""
        self._stop.set()
        self._beat_now.set()

    # -- data plane ------------------------------------------------------
    def _fetch(self, ref: str):
        """``(value, local)`` for an input blob — via the local LRU cache
        (``local=True``: no RPC round-trip; results this worker produced
        are pre-cached at settle, so a chained child placed here reads
        its parent's output locally) or the master's ``get`` op."""
        if not ref:
            return None, False
        with self._lock:
            if ref in self._data_cache:
                self._data_cache.move_to_end(ref)
                self.n_data_local += 1
                return self._data_cache[ref], True
        rsp = self._main.request("get", key=ref)
        blob = decode_blob(rsp["blob"])
        value = blob if rsp.get("raw") else pickle.loads(blob)
        self._cache_put(ref, value)
        return value, False

    def _cache_put(self, ref: str, value: Any) -> None:
        with self._lock:
            self._data_cache[ref] = value
            self._data_cache.move_to_end(ref)
            while len(self._data_cache) > DATA_CACHE_MAX:
                self._data_cache.popitem(last=False)

    # -- warm pool (the engine backend's semantics, process-local) -------
    def _acquire_handle(self, rdef, key: str):
        """(handle, cold, prewarmed, err) with LRU insert on cold.  A batch
        that finds the key's ``setup()`` running (a prewarm) waits for it
        and serves its handle: a cold start, since the batch waited on it."""
        if rdef.setup is None:
            self.n_cold_starts += 1
            return None, True, False, None
        waited = False
        while True:
            with self._lock:
                if key in self._handles:
                    self._handles.move_to_end(key)
                    prewarmed = key in self._prewarmed and not waited
                    self._prewarmed.discard(key)
                    if waited:
                        self.n_cold_starts += 1
                    else:
                        self.n_warm_starts += 1
                    return self._handles[key], waited, prewarmed, None
                building = self._building.get(key)
                if building is None:
                    done = self._building[key] = threading.Event()
                    self.n_cold_starts += 1
                    break
            building.wait()
            waited = True
        try:
            handle = rdef.setup()       # slow: weights on the card, unlocked
        except Exception as e:  # noqa: BLE001 — settles as unsuccessful
            self._end_build(key, done)
            return None, True, False, f"cold-start failed: {e!r}"
        with self._lock:
            self._handles[key] = handle
            dropped = self._evict_over_budget_locked()
        self._end_build(key, done)
        if dropped:
            _free_card_memory()
        return handle, True, False, None

    def _end_build(self, key: str, done: threading.Event) -> None:
        with self._lock:
            self._building.pop(key, None)
        done.set()

    def _evict_over_budget_locked(self) -> bool:
        """Drop LRU handles over ``max_warm``; True if any was dropped."""
        dropped = False
        while len(self._handles) > self.max_warm:
            victim = next((k for k in self._handles
                           if k not in self._pinned), None)
            if victim is None:
                break
            self._handles.pop(victim, None)
            self._prewarmed.discard(victim)
            dropped = True
        return dropped

    # -- execution -------------------------------------------------------
    def _execute_batch(self, batch: List[Invocation]) -> None:
        rdef = self.registry.get(batch[0].runtime_id)
        key = batch[0].runtime_key
        # lazy tracing: the first batch carrying trace context turns this
        # process's tracer on — master clock (offset learned at hello),
        # span ids namespaced by worker name — with zero config plumbing
        # and zero overhead while the client never traces
        traced = any(inv.trace_id is not None for inv in batch)
        if traced and not TRACER.enabled:
            TRACER.enable(clock=self.now, prefix=f"{self.name}:")
        self._inflight_n = len(batch)
        t_acq = self.now()
        handle, cold, prewarmed, err = self._acquire_handle(rdef, key)
        cold_end = self.now()
        fetched = [self._fetch(inv.data_ref) for inv in batch]
        datas = [unwrap_outcome(v) for v, _ in fetched]
        local_flags = [local for _, local in fetched]
        e_start = self.now()
        results: List[Any] = [None] * len(batch)
        if err is None:
            try:
                with self._trace_ctx(batch if traced else []):
                    results = run_batch(
                        rdef, datas,
                        dict(batch[0].config, handle=handle,
                             attempts=[inv.attempt for inv in batch]))
            except Exception as e:  # noqa: BLE001 — unsuccessful events
                err = repr(e)
        e_end = self.now()
        self.n_batches += 1
        self._inflight_n = 0

        records = []
        acc = f"{self.name}/pid{os.getpid()}({self.acc_type})"
        for inv, result, local in zip(batch, results, local_flags):
            inv.success = err is None
            inv.error = err
            outcome = make_outcome(inv, result, err)
            blob = pickle.dumps(outcome)
            # pre-cache the outcome under its deterministic result key:
            # when the master routes this result's consumer back here
            # (residency hint), its _fetch is a local cache hit
            self._cache_put(f"result:inv{inv.inv_id}", outcome)
            records.append({
                "inv_id": inv.inv_id,
                "blob": encode_blob(blob),
                "fields": {"e_start": e_start, "e_end": e_end,
                           "success": err is None, "error": err,
                           "cold_start": cold, "prewarmed": prewarmed,
                           "locality_hit": local,
                           "node": self.name, "accelerator": acc},
            })
        if traced and TRACER.enabled:
            # this process authors the spans only it can time — the warm-
            # pool acquisition (cold start) and the batch execution — with
            # the deterministic ids the client-side partition expects, so
            # the assembled tree is contiguous across process boundaries
            for inv in batch:
                if inv.trace_id is None:
                    continue
                root = inv.span_id or f"inv{inv.inv_id}"
                pre = f"{root}/a{inv.attempt}"
                if cold and cold_end > t_acq:
                    TRACER.complete(
                        "cold_start", t_acq, cold_end, trace=inv.trace_id,
                        span_id=f"{pre}/cold_start",
                        parent=f"{pre}/dispatch",
                        attrs={"runtime": inv.runtime_id,
                               "node": self.name})
                TRACER.complete(
                    "execute", e_start, e_end, trace=inv.trace_id,
                    span_id=f"{pre}/execute", parent=root,
                    status="ok" if err is None else "error",
                    attrs={"runtime": inv.runtime_id, "node": self.name,
                           "accelerator": acc, "pid": os.getpid()})
            # ship every closed span home inside the settle RPC
            records[0]["spans"] = TRACER.drain_records()
        try:
            rsp = self._main.request("settle", worker=self.name,
                                     records=records)
        except ConnectionError:
            self._stop.set()            # master gone mid-settle
            return
        for r in rsp.get("results", ()):
            if r.get("accepted"):
                self.n_settled += 1
            else:
                # first-settlement-wins: another attempt beat this one
                # (our lease expired mid-batch) — drop, never retry
                self.n_settle_refused += 1
        # nudge the heartbeat so the master's stats reflect this batch
        # immediately, not one beat interval later
        self._beat_now.set()

    def _trace_ctx(self, batch: List[Invocation]):
        """Thread-local trace context for ``run_batch``: serving-engine
        spans emitted during execution nest under the lead invocation's
        ``execute`` span."""
        import contextlib
        lead = next((i for i in batch if i.trace_id is not None), None)
        if lead is None or not TRACER.enabled:
            return contextlib.nullcontext()
        root = lead.span_id or f"inv{lead.inv_id}"
        return TRACER.ctx(lead.trace_id, f"{root}/a{lead.attempt}/execute")

    # -- heartbeats / directives -----------------------------------------
    def _stats(self) -> Dict[str, Any]:
        with self._lock:
            warm_keys = list(self._handles)
        return {"pid": os.getpid(), "n_batches": self.n_batches,
                "n_cold_starts": self.n_cold_starts,
                "n_warm_starts": self.n_warm_starts,
                "n_prewarms": self.n_prewarms,
                "n_settled": self.n_settled,
                "n_settle_refused": self.n_settle_refused,
                "acc_type": self.acc_type,
                "busy": self._inflight_n,
                "n_warm": len(warm_keys),
                "n_data_local": self.n_data_local,
                "warm_keys": warm_keys}

    def _heartbeat_loop(self) -> None:
        while True:
            self._beat_now.wait(self.heartbeat_s)
            self._beat_now.clear()
            if self._stop.is_set():
                return
            try:
                rsp = self._hb.request("heartbeat", worker=self.name,
                                       stats=self._stats())
            except ConnectionError:
                self._stop.set()
                return
            for d in rsp.get("directives", ()):
                try:
                    self._apply_directive(d)
                except Exception:   # noqa: BLE001 — directives best-effort
                    pass

    def _apply_directive(self, d: Dict[str, Any]) -> None:
        """Apply one control-plane directive (prewarm / evict / pin).

        A prewarm runs on a thread of its own (a cold start may outlast
        the heartbeat timeout; the beats must go on meanwhile)."""
        op = d.get("op")
        if op == "prewarm":
            threading.Thread(target=self._prewarm, args=(d,),
                             name=f"{self.name}-prewarm",
                             daemon=True).start()
        elif op == "evict":
            hit = False
            with self._lock:
                if d["runtime_key"] not in self._pinned:
                    hit = self._handles.pop(d["runtime_key"], None) \
                        is not None
                    self._prewarmed.discard(d["runtime_key"])
            if hit:
                _free_card_memory()
        elif op == "pin":
            with self._lock:
                self._pinned = set(d.get("keys", ()))

    def _prewarm(self, d: Dict[str, Any]) -> None:
        """Install a warm handle off the take/settle path and off the
        heartbeat thread (best-effort, as every directive); nothing if the
        key is warm or its ``setup()`` is already running."""
        try:
            self._sync_runtimes(self._hb)   # the hb connection never parks
            rdef = self.registry.get(d["runtime_id"])
            if rdef.setup is None:
                return
            from repro_torch.core.events import runtime_key_for
            key = runtime_key_for(d["runtime_id"], d.get("config"))
        except Exception:   # noqa: BLE001 — directives best-effort
            return
        with self._lock:
            if key in self._handles or key in self._building:
                return
            done = self._building[key] = threading.Event()
        dropped = False
        try:
            handle = rdef.setup()
            with self._lock:
                self._handles[key] = handle
                self._prewarmed.add(key)
                self.n_prewarms += 1
                dropped = self._evict_over_budget_locked()
            del handle
        except Exception:   # noqa: BLE001 — directives best-effort
            pass
        finally:
            self._end_build(key, done)
        if dropped:
            _free_card_memory()         # an LRU victim
        self._beat_now.set()            # report the warm handle at once

def _free_card_memory() -> None:
    """Give the card memory of dropped handles back to the driver, where
    the other processes on the card can allocate it (a no-op in a worker
    that never touched the card)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    from repro_torch.serve import step_graph
    gc.collect()
    step_graph.empty_cache()          # not during another thread's capture


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry point: ``python -m repro_torch.cluster.worker --master ...``."""
    ap = argparse.ArgumentParser(
        description="Hardless cluster worker process")
    ap.add_argument("--master", required=True, metavar="HOST:PORT")
    ap.add_argument("--name", default=f"w{os.getpid()}")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--heartbeat-s", type=float, default=1.0)
    ap.add_argument("--max-warm", type=int, default=8)
    ap.add_argument("--acc-type", default=HOST_ACC,
                    help="accelerator type this worker reports "
                         "(heterogeneity view in stats/metrics)")
    args = ap.parse_args(argv)
    worker = Worker(args.master, args.name, max_batch=args.max_batch,
                    heartbeat_s=args.heartbeat_s, max_warm=args.max_warm,
                    acc_type=args.acc_type)
    worker.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
