"""The port's multi-process cluster (``repro_torch.cluster``) against the
JAX package's (``repro.cluster``).

* Twins of every test of ``tests/test_cluster_proc.py``, of
  ``test_obs.py``'s two cluster tests and of ``test_hetero_placement.py``'s
  two: the same contract and asserts, run against the port's master,
  worker processes and ``ClusterBackend``.
* Wire compatibility: the frame layout and ``Invocation`` wire dicts
  round-trip between a client of one package and a master of the other.
* The slice: granite-3-2b ``.reduced()`` through the port's
  ``start_cluster`` (one and two worker processes, ``device="cpu"``)
  against the reference cluster in this process (its ``Master.serve()``
  and a reference ``Worker`` on a thread, serving
  ``repro.cluster.runtimes:serve_runtime``), both on the JAX package's
  seed-0 weights: greedy tokens exact, and with one worker the same
  outcome envelopes, cold and warm counts and span-tree shape.
* The launcher's ``--cluster`` and ``--workflow`` (its ``--cluster``
  flag errors are cases of ``tests/test_torch_controlplane.py``'s
  ``test_launcher_flag_errors_match_the_reference``).
* A prewarm whose cold start outlasts the heartbeat timeout, while the
  worker executes a batch: the port keeps the worker, the reference loses
  it (``ROADMAP.md`` Queue 3). Repeated prewarm directives during one
  slow setup run it once, and in the port an event taken meanwhile
  waits for that setup instead of starting a second.

Steadiness: every heartbeat timeout is 3 s or more, also where a test
waits for a death it caused itself (a survivor starved of the CPU for a
shorter timeout would read as dead too); every ``result()`` and ``drain()`` waits 60 s
at most; spawned workers run with ``OMP_NUM_THREADS=1``; a test that
needs a batch formed from several events holds the master's takes while
it submits them and releases them once every worker is parked in a take
that offers the registered runtimes (``takes_held``), and a test that
kills a worker waits until the worker holds a lease, not for a fixed
sleep.
"""
import collections
import contextlib
import os
import pickle
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import pytest

import repro.cluster as JCL
import repro.cluster.rpc as JRPC
import repro.core.events as JE
import repro.core.storage as JS
import repro.gateway as JG
import repro.obs as JO
import repro_torch.cluster as TCL
import repro_torch.cluster.rpc as TRPC
import repro_torch.core.events as TE
import repro_torch.core.storage as TS
import repro_torch.gateway as TG
import repro_torch.obs as TO
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro_torch.cluster import (ClusterBackend, InProcTransport, Master,
                                 RpcClient, start_cluster)
from repro_torch.cluster.rpc import (RPC_VERSION, encode_blob, inv_from_wire,
                                     inv_to_wire, recv_frame, send_frame)
from repro_torch.core.events import Invocation
from repro_torch.faults import inject
from repro_torch.gateway import (EngineBackend, Gateway,
                                 InvocationRetriesExhausted, Workflow)
from repro_torch.obs import ABANDONED, TRACER

EXHAUSTED_RE = re.compile(r"^retries exhausted after \d+ attempt\(s\): ")

SLEEP_SPEC = "repro_torch.cluster.runtimes:sleep_runtime"
ADD_SPEC = "repro_torch.cluster.runtimes:add_runtime"
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
WAIT = 60.0         # the longest any result() or drain() here waits


@pytest.fixture(autouse=True)
def _steady(monkeypatch):
    """Workers inherit this environment: one intra-op thread each, and
    the factory module of this directory importable. Tracing state never
    leaks between tests (module singletons)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(TESTS)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.syspath_prepend(str(TESTS))
    TO.reset()
    JO.reset()
    yield
    TO.reset()
    JO.reset()


def until(pred, what: str, timeout_s: float = 20.0) -> None:
    """Wait for ``pred()`` (polled), failing after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


@contextlib.contextmanager
def takes_held(master, workers=("w0", "w1")):
    """Hold every worker's ``take`` at ``master`` while the block runs:
    events submitted inside it are queued together, so the first take
    after it forms its micro-batch from all of them (the batches are then
    the same on every run). On leaving the block the hold lasts until
    each of ``workers`` is parked in a ``take`` that offers every
    registered runtime, and ends under the master's lock: each of them
    then takes its share at once. A worker that has not yet synced the
    catalogue after a register (or is between two polls) would otherwise
    take late, and on a loaded machine the others could serve every held
    event first."""
    parked = collections.Counter()
    op_take = master.op_take

    def counted_take(**kwargs):
        synced = set(kwargs["supported"]) >= set(master.registry.ids())
        with master._cond:
            parked[kwargs["worker"]] += synced
        try:
            return op_take(**kwargs)
        finally:
            with master._cond:
                parked[kwargs["worker"]] -= synced

    master.op_take = counted_take
    master._take_for_worker_locked = lambda *args, **kwargs: None
    try:
        yield
        deadline = time.monotonic() + WAIT
        while True:
            with master._cond:
                if all(parked[w] > 0 for w in workers):
                    break
            assert time.monotonic() < deadline, \
                f"workers {workers} not all parked in a take: {dict(parked)}"
            time.sleep(0.01)
    finally:
        with master._cond:
            del master._take_for_worker_locked      # the class's method
            del master.op_take
            master._cond.notify_all()


def leased(h) -> int:
    return h.master.op_stats()["leased"]


# ------------------------------------------------------------ RPC frames
def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        msg = {"v": RPC_VERSION, "id": 7, "op": "take",
               "blob": "aGk=", "nested": {"x": [1, 2, 3]}}
        send_frame(a, msg)
        assert recv_frame(b) == msg
        b.close()                       # orderly EOF
        assert recv_frame(a) is None
    finally:
        a.close()


def test_invocation_wire_roundtrip_preserves_identity_and_chain():
    inv = Invocation(runtime_id="rt", data_ref="d", config={"k": 1},
                     r_start=1.0)
    inv.n_start, inv.e_start, inv.e_end = 1.5, 2.0, 3.0
    inv.attempt, inv.tenant, inv.workflow = 2, "paid", "wf0"
    out = inv_from_wire(inv_to_wire(inv))
    assert out.inv_id == inv.inv_id     # submitting client's id wins
    for f in ("runtime_id", "data_ref", "config", "r_start", "n_start",
              "e_start", "e_end", "attempt", "tenant", "workflow"):
        assert getattr(out, f) == getattr(inv, f), f


def test_version_mismatch_refused_with_explicit_error_frame():
    master = Master()
    addr = master.serve()
    try:
        cli = RpcClient(addr)
        # a well-formed frame from a future protocol version
        with cli._lock:
            send_frame(cli._sock, {"v": RPC_VERSION + 1, "id": 1,
                                   "op": "stats"})
            rsp = recv_frame(cli._sock)
        assert rsp["ok"] is False
        assert "version mismatch" in rsp["error"]
        cli.close()
    finally:
        master.stop()


# ------------------------------------------- real worker processes
def test_two_workers_serve_and_results_carry_distinct_pids():
    h = start_cluster(2, heartbeat_timeout_s=10.0)
    try:
        gw = Gateway(h.backend)
        rid = h.backend.register_spec(SLEEP_SPEC, {"sleep_s": 0.05})
        with takes_held(h.master):      # both workers parked, 12 queued
            futs = gw.map(rid, [{"i": i} for i in range(12)])
        results = [f.result(extra_time_s=WAIT) for f in futs]
        assert [r["echo"]["i"] for r in results] == list(range(12))
        assert len({r["pid"] for r in results}) == 2    # both processes
        m = gw.metrics
        assert len(m.completed) == 12 and m.r_success() == 12
        assert all(i.check_monotone() for i in m.completed)
        st = h.backend.stats()
        assert st["settled"] == 12 and st["duplicate_settles"] == 0
    finally:
        h.close()


def test_sigkill_mid_batch_requeues_lease_and_all_settle():
    """Real process death while holding a lease: the keeper expires the
    worker, the event redelivers to the survivor with attempt bumped —
    the sim kill-node contract, on actual SIGKILL."""
    h = start_cluster(2, heartbeat_timeout_s=3.0, keeper_interval_s=0.1,
                      heartbeat_s=0.2)
    try:
        gw = Gateway(h.backend)
        rid = h.backend.register_spec(SLEEP_SPEC, {"sleep_s": 0.3})
        with takes_held(h.master):
            futs = gw.map(rid, [{"i": i} for i in range(6)])
        until(lambda: leased(h) == 2, "both workers mid-sleep")
        assert h.launcher.kill(0)       # SIGKILL, no cleanup
        settled_at_kill = h.master.op_stats()["settled"]
        results = [f.result(extra_time_s=WAIT) for f in futs]
        assert len(results) == 6        # none stranded
        m = gw.metrics
        assert m.r_success() == 6
        retried = [i for i in m.completed if i.attempt > 0]
        assert retried, "the kill must have lost leased work"
        # the survivor's pid from its beats (no event's result is sure to
        # carry it: a test thread starved of the CPU can kill w0 after it
        # finished an event or two)
        surviving_pid = h.backend.stats()["workers"]["w1"]["stats"]["pid"]
        for inv in retried:
            assert inv.node == "w1"     # fresh placement on the survivor
        # w0 ran only events that settled before its death, each on its
        # first attempt; the survivor ran every other event
        on_dead = [f.invocation for f, r in zip(futs, results)
                   if r["pid"] != surviving_pid]
        assert len(on_dead) <= settled_at_kill
        assert all(i.node == "w0" and i.attempt == 0 for i in on_dead)
        st = h.backend.stats()
        assert st["workers_lost"] == 1 and st["requeued"] >= 1
    finally:
        h.close()


def test_sigkill_without_retries_settles_exhausted_error_records():
    """max_attempts=1 turns the lost delivery into a permanent error
    record with the same shape the sim and engine produce."""
    h = start_cluster(1, heartbeat_timeout_s=3.0, keeper_interval_s=0.1,
                      heartbeat_s=0.2)
    try:
        gw = Gateway(h.backend)
        rid = h.backend.register_spec(
            SLEEP_SPEC, {"sleep_s": 5.0, "max_attempts": 1})
        fut = gw.invoke(rid, {"i": 0})
        until(lambda: leased(h) == 1, "the lone worker mid-sleep")
        assert h.launcher.kill(0)
        with pytest.raises(InvocationRetriesExhausted):
            fut.result(extra_time_s=WAIT)
        inv = fut.invocation
        assert inv.r_end is not None and not inv.success
        assert inv.retries_exhausted and not inv.rejected
        assert EXHAUSTED_RE.match(inv.error)
        assert inv.attempt == 0         # never redelivered (bound 1)
        rec = h.backend.store.get_outcome(f"result:inv{inv.inv_id}")
        assert rec["ok"] is False and rec["value"] is None
        assert EXHAUSTED_RE.match(rec["error"])
    finally:
        h.close()


def test_cluster_ops_rejected_elsewhere_and_vice_versa():
    eb = EngineBackend(device="cpu")
    with pytest.raises(ValueError):
        inject(eb, [{"at": 0.0, "op": "kill-worker-process", "worker": 0}])
    eb.shutdown()
    master = Master()
    backend = ClusterBackend(InProcTransport(master))

    class _FakeLauncher:
        def kill(self, idx):
            return False

    backend.launcher = _FakeLauncher()
    with pytest.raises(ValueError):
        inject(backend, [{"at": 0.0, "op": "kill-node", "node": "x"}])
    with pytest.raises(ValueError):
        inject(backend, [{"at": 0.0, "op": "crash-worker", "worker": 0}])
    master.op_shutdown()        # returns the pump's parked poll at once
    backend.shutdown()
    master.stop()


def test_kill_worker_process_fault_op_sigkills_through_the_launcher():
    """The fault op armed over the cluster backend: a real SIGKILL of the
    launcher's worker 0 at its time, the event it held requeued to the
    survivor, every event settled."""
    h = start_cluster(2, heartbeat_timeout_s=3.0, keeper_interval_s=0.1,
                      heartbeat_s=0.2)
    try:
        gw = Gateway(h.backend)
        rid = h.backend.register_spec(SLEEP_SPEC, {"sleep_s": 0.3})
        with takes_held(h.master):
            futs = gw.map(rid, [{"i": i} for i in range(6)])
        until(lambda: leased(h) == 2, "both workers mid-sleep")
        injector = inject(h.backend, [{"at": 0.0, "op": "kill-worker-process",
                                       "worker": 0}])
        assert [f.result(extra_time_s=WAIT)["echo"]["i"]
                for f in futs] == list(range(6))
        injector.disarm()
        assert injector.summary() == {"reaped": 0, "kill-worker-process": 1}
        assert injector.injected[0][3] == "SIGKILL"
        assert h.launcher.alive() == [1]
        st = h.backend.stats()
        assert st["workers_lost"] == 1 and st["requeued"] >= 1
        assert any(f.invocation.attempt > 0 for f in futs)
    finally:
        h.close()


# --------------------------------- first-settlement-wins across processes
def _wire_settle(inv, blob=b"x", **fields):
    payload = pickle.dumps(TS.make_outcome(inv, {"ok": True}, None))
    rec = {"inv_id": inv.inv_id, "blob": encode_blob(payload),
           "fields": dict({"e_start": 0.1, "e_end": 0.2, "success": True,
                           "node": "w0"}, **fields)}
    return rec


def test_duplicate_and_unknown_settlements_refused():
    master = Master(lease_s=30.0)
    rsp = master.op_register(spec=SLEEP_SPEC, kwargs={"sleep_s": 0.0})
    rid = rsp["runtime_id"]
    inv = Invocation(runtime_id=rid, data_ref="", r_start=0.0)
    master.op_submit(event=inv_to_wire(inv))
    take = master.op_take(worker="w0", supported=[rid], max_batch=1,
                          timeout_s=1.0)
    taken = inv_from_wire(take["events"][0])

    first = master.op_settle(worker="w0",
                             records=[_wire_settle(taken)])
    assert first["results"][0]["accepted"]
    dup = master.op_settle(worker="w1", records=[_wire_settle(taken)])
    assert not dup["results"][0]["accepted"]
    assert "already settled" in dup["results"][0]["reason"]

    ghost = Invocation(runtime_id=rid, data_ref="", r_start=0.0)
    unknown = master.op_settle(worker="w0",
                               records=[_wire_settle(ghost)])
    assert not unknown["results"][0]["accepted"]
    assert "unknown" in unknown["results"][0]["reason"]
    assert master.op_stats()["duplicate_settles"] == 2
    master.stop()


def test_master_restart_refuses_resettlement_of_snapshot_ids():
    """A settle that raced a master restart must not double-apply: the
    restarted master's snapshot remembers settled ids and refuses."""
    m1 = Master(lease_s=30.0)
    rid = m1.op_register(spec=SLEEP_SPEC,
                         kwargs={"sleep_s": 0.0})["runtime_id"]
    inv = Invocation(runtime_id=rid, data_ref="", r_start=0.0)
    m1.op_submit(event=inv_to_wire(inv))
    take = m1.op_take(worker="w0", supported=[rid], max_batch=1,
                      timeout_s=1.0)
    taken = inv_from_wire(take["events"][0])
    assert m1.op_settle(
        worker="w0", records=[_wire_settle(taken)])["results"][0]["accepted"]
    snap = m1.snapshot()
    m1.stop()

    m2 = Master(lease_s=30.0, snapshot=snap)    # restarted master
    late = m2.op_settle(worker="w1", records=[_wire_settle(taken)])
    assert not late["results"][0]["accepted"]
    assert "already settled" in late["results"][0]["reason"]
    m2.stop()


# ----------------------------------------------- transport equivalence
def test_inproc_transport_drives_same_surface_as_rpc():
    """ClusterBackend over InProcTransport: submit through the backend,
    settle by driving the master's op surface directly (a synthetic
    worker), and the settlement pump resolves the future — no sockets
    anywhere."""
    master = Master(lease_s=30.0)
    backend = ClusterBackend(InProcTransport(master))
    gw = Gateway(backend)
    rid = backend.register_spec(SLEEP_SPEC, {"sleep_s": 0.0})

    def synthetic_worker():
        take = master.op_take(worker="wT", supported=[rid], max_batch=4,
                              timeout_s=5.0)
        events = [inv_from_wire(e) for e in take["events"]]
        master.op_settle(worker="wT",
                         records=[_wire_settle(e) for e in events])

    t = threading.Thread(target=synthetic_worker, daemon=True)
    t.start()
    fut = gw.invoke(rid, {"i": 1})
    assert fut.result(extra_time_s=WAIT) == {"ok": True}
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert len(gw.metrics.completed) == 1
    assert gw.metrics.completed[0].check_monotone()
    master.op_shutdown()        # returns the pump's parked poll at once
    backend.shutdown()
    master.stop()


# ------------------------------------------------- workflows over cluster
def test_workflow_chain_composes_across_worker_processes():
    h = start_cluster(2, heartbeat_timeout_s=10.0)
    try:
        gw = Gateway(h.backend)
        add1 = h.backend.register_spec(
            ADD_SPEC, {"runtime_id": "add1", "add": 1})
        add10 = h.backend.register_spec(
            ADD_SPEC, {"runtime_id": "add10", "add": 10})
        wf = Workflow("chain")
        a = wf.step("s1", add1, payload=5)
        b = wf.step("s2", add10, after=a)
        wf.step("s3", add1, after=b)
        out = gw.submit_workflow(wf).result(extra_time_s=WAIT)
        assert out == 17                # ((5+1)+10)+1
        tagged = [i for i in gw.metrics.completed if i.workflow == "chain"]
        assert len(tagged) == 3
        assert {i.step for i in tagged} == {"s1", "s2", "s3"}
    finally:
        h.close()


# ------------------------------------ tracing across processes (test_obs)
def partition_errors(tr):
    """Per-root relative error between RLat and the summed durations of
    the root's tiling children (an abandoned ``attempt`` overlaps the
    final attempt's queue_wait, so it is not part of the tiling)."""
    spans = tr.spans()
    errs = {}
    for root in spans:
        if root.name != "invocation" or root.t_end is None:
            continue
        rlat = root.t_end - root.t_start
        ssum = sum(s.duration for s in spans
                   if s.parent_id == root.span_id and s.t_end is not None
                   and s.name != "attempt")
        errs[root.span_id] = 0.0 if rlat == 0 else abs(ssum - rlat) / rlat
    return errs


def test_cluster_workflow_one_trace_contiguous_across_processes():
    """A 3-step workflow on the real multi-process cluster produces ONE
    trace whose span tree is contiguous: every span's parent resolves
    inside the trace, and the execute spans were authored by the worker
    process (they carry its pid), yet tile the client-side partition."""
    h = start_cluster(2, heartbeat_timeout_s=10.0)
    try:
        gw = Gateway(h.backend)
        TO.enable(clock=h.backend.now, metrics=gw.metrics)
        rid = h.backend.register_spec(ADD_SPEC, {"add": 1})
        wf = Workflow("wf-cluster")
        a = wf.step("s0", rid, payload=0)
        b = wf.step("s1", rid, after=a)
        wf.step("s2", rid, after=b)
        out = gw.submit_workflow(wf).result(extra_time_s=WAIT)
        assert out == 3
        spans = TRACER.find(trace="wf:wf-cluster")
        by_id = {s.span_id: s for s in spans}
        roots = [s for s in spans if s.name == "invocation"]
        assert len(roots) == 3
        # contiguity: every parent link lands inside the same trace
        for s in spans:
            if s.parent_id is not None:
                assert s.parent_id in by_id, (s.span_id, s.parent_id)
        # the worker process authored execute (pid differs from ours)
        execs = [s for s in spans if s.name == "execute"]
        assert len(execs) == 3
        assert all(s.attrs["pid"] != os.getpid() for s in execs)
        assert all(s.attrs["node"] in ("w0", "w1") for s in execs)
        errs = partition_errors(TRACER)
        assert all(e <= 0.10 for e in errs.values()), errs
    finally:
        h.close()


def test_cluster_kill_worker_closes_abandoned_and_links_retry():
    """SIGKILL mid-batch: the keeper's requeue closes the dead attempt
    with an ``abandoned`` span, and the retry's spans join the SAME
    trace — the whole story of the invocation stays on one timeline."""
    h = start_cluster(2, heartbeat_timeout_s=3.0, keeper_interval_s=0.1,
                      heartbeat_s=0.2)
    try:
        gw = Gateway(h.backend)
        TO.enable(clock=h.backend.now, metrics=gw.metrics)
        rid = h.backend.register_spec(SLEEP_SPEC, {"sleep_s": 0.3})
        with takes_held(h.master):
            futs = gw.map(rid, [{"i": i} for i in range(6)])
        until(lambda: leased(h) == 2, "both workers mid-sleep")
        assert h.launcher.kill(0)
        for f in futs:
            f.result(extra_time_s=WAIT)
        abandoned = TRACER.find(name="attempt", status=ABANDONED)
        assert abandoned, "the kill must orphan at least one lease"
        retried = [i for i in gw.metrics.completed if i.attempt > 0]
        assert retried
        for sp in abandoned:
            # the abandoned closure hangs off the invocation's root ...
            roots = TRACER.find(name="invocation", trace=sp.trace_id)
            assert len(roots) == 1 and sp.parent_id == roots[0].span_id
            # ... and the *retry* attempt's children are in the same
            # trace, one attempt later
            a = sp.attrs["attempt"]
            nxt = [s for s in TRACER.find(trace=sp.trace_id)
                   if s.span_id.startswith(f"{sp.parent_id}/a{a + 1}/")]
            assert nxt, f"no attempt-{a + 1} spans joined {sp.trace_id}"
        # every settled invocation still closed a root span
        assert TRACER.closed_roots() == 6
        errs = partition_errors(TRACER)
        assert all(e <= 0.10 for e in errs.values()), errs
    finally:
        h.close()


# ------------------------- data locality on worker processes (hetero)
def test_chain_reads_locally_on_cluster_worker():
    h = start_cluster(1, heartbeat_timeout_s=10.0, acc_types=["gpu-fast"])
    try:
        gw = Gateway(h.backend)
        rid = h.backend.register_spec(ADD_SPEC, {"add": 2})
        wf = Workflow("chain")
        a = wf.step("s0", rid, payload=1)
        b = wf.step("s1", rid, after=a)
        wf.step("s2", rid, after=b)
        fut = gw.submit_workflow(wf)
        assert fut.result(extra_time_s=WAIT) == 7    # ((1+2)+2)+2
        invs = {ss.step.name: ss.future.invocation
                for ss in fut._state.steps.values()}
        # the chained inputs came out of the worker's own data cache
        # (its settle pre-caches each outcome under its result ref) and
        # the hit flag rode the settle frame back
        assert not invs["s0"].locality_hit
        assert invs["s1"].locality_hit and invs["s2"].locality_hit
        assert fut.locality_rate() == 1.0
        st = h.backend.stats()
        assert st["resident_refs"] >= 3          # master residency hints
        # the advertised type rides the worker's heartbeats: wait for one
        # after its settles (they nudge a beat) rather than racing it
        until(lambda: "gpu-fast" in gw.backlog_by_type(), "a typed beat")
        bt = gw.backlog_by_type()                # worker's advertised type
        assert "gpu-fast" in bt
        assert bt["gpu-fast"]["free"] >= 0
    finally:
        h.close()


def test_cluster_chain_falls_back_when_resident_worker_dies():
    h = start_cluster(2, heartbeat_timeout_s=3.0, keeper_interval_s=0.1,
                      heartbeat_s=0.2)
    try:
        gw = Gateway(h.backend)
        rid = h.backend.register_spec(ADD_SPEC, {"add": 1})
        parent = gw.invoke(rid, 5)
        assert parent.result(extra_time_s=WAIT) == 6
        victim = parent.invocation.node          # "w0" / "w1"
        h.launcher.kill(int(victim[1:]))         # real SIGKILL
        until(lambda: h.backend.stats()["workers_lost"] >= 1,
              "the keeper to expire the killed worker", timeout_s=10.0)
        # the keeper dropped the dead worker's residency hints: the
        # dependent event routes to the survivor and reads the parent's
        # result from the master store instead of waiting on a ghost
        child = gw.invoke(rid, data_ref=parent.result_key)
        assert child.result(extra_time_s=WAIT) == 7
        assert child.invocation.node != victim
        assert not child.invocation.locality_hit
    finally:
        h.close()


# ------------------------------------------------ wire compatibility
PKGS = {"repro": (JCL, JRPC, JE, JS), "repro_torch": (TCL, TRPC, TE, TS)}


def test_frames_are_byte_identical_across_packages():
    msg = {"v": JRPC.RPC_VERSION, "id": 3, "op": "settle", "worker": "w0",
           "records": [{"inv_id": 9, "blob": JRPC.encode_blob(b"\x00\xff"),
                        "fields": {"e_start": 0.25, "error": None}}]}
    raw = []
    for rpc in (JRPC, TRPC):
        a, b = socket.socketpair()
        try:
            rpc.send_frame(a, msg)
            a.close()
            raw.append(b.recv(1 << 16))
        finally:
            b.close()
    assert JRPC.RPC_VERSION == TRPC.RPC_VERSION
    assert raw[0] == raw[1]
    for src, dst in ((JRPC, TRPC), (TRPC, JRPC)):
        a, b = socket.socketpair()
        try:
            src.send_frame(a, msg)
            assert dst.recv_frame(b) == msg
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("server,client", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_client_and_master_of_different_packages_interoperate(server,
                                                               client):
    """A client of one package drives a master of the other through
    hello, register, submit, take, settle and the settlement stream: the
    Invocation survives both directions of the wire with its identity,
    chain and tenant, and a foreign-version frame is refused."""
    S, _, _, _ = PKGS[server]
    C, crpc, cev, cst = PKGS[client]
    master = S.Master(lease_s=30.0)
    cli = C.RpcClient(master.serve())
    try:
        assert cli.request("hello", role="client",
                           name="x")["rpc_version"] == crpc.RPC_VERSION
        rid = cli.request(
            "register", spec=f"{server}.cluster.runtimes:sleep_runtime",
            kwargs={"sleep_s": 0.0})["runtime_id"]
        inv = cev.Invocation(runtime_id=rid, data_ref="", config={"k": [1]},
                             r_start=0.5)
        inv.tenant, inv.workflow, inv.step = "paid", "wf0", "s1"
        cli.request("submit", event=crpc.inv_to_wire(inv))
        take = cli.request("take", worker="wx", supported=[rid],
                           max_batch=1, timeout_s=5.0)
        got = crpc.inv_from_wire(take["events"][0])
        for f in ("inv_id", "runtime_id", "config", "r_start", "tenant",
                  "workflow", "step", "attempt"):
            assert getattr(got, f) == getattr(inv, f), f
        assert got.node == "wx" and got.n_start is not None
        blob = pickle.dumps(cst.make_outcome(got, {"echo": 1}, None))
        rsp = cli.request("settle", worker="wx", records=[{
            "inv_id": got.inv_id, "blob": crpc.encode_blob(blob),
            "fields": {"e_start": got.n_start, "e_end": got.n_start + 0.1,
                       "success": True, "node": "wx"}}])
        assert rsp["results"][0]["accepted"]
        rec = cli.request("poll_settled", since=0,
                          timeout_s=5.0)["records"][-1]
        back = crpc.inv_from_wire(rec["inv"])
        assert (back.inv_id, back.success, back.tenant, back.step) == \
            (inv.inv_id, True, "paid", "s1")
        assert back.r_end is not None and back.r_end >= back.r_start
        assert pickle.loads(crpc.decode_blob(rec["blob"]))["value"] == \
            {"echo": 1}
        with cli._lock:
            crpc.send_frame(cli._sock, {"v": crpc.RPC_VERSION + 1, "id": 1,
                                        "op": "stats"})
            assert "version mismatch" in crpc.recv_frame(cli._sock)["error"]
    finally:
        cli.close()
        master.stop()


# ------------------------------------------------------------ the slice
JCFG = jget_config("granite-3-2b").reduced()
EVENTS = [{"prompts": [[5, 9, 14, 3, 22], [7] * 12]},
          {"prompts": [[31, 2, 8] * 9]},
          {"prompts": [[4, 4, 17, 60], [11, 12, 13], [40] * 19]},
          {"prompts": [[2, 3]]},
          {"prompts": [[6, 1, 1, 9] * 5]},
          {"prompts": [[100, 3, 50], [8] * 7]},
          {"prompts": [[13] * 3, [21, 2]]},
          {"prompts": [[77, 7] * 6]}]
RUN = {"max_new_tokens": 4}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's seed-0 parameters of granite ``.reduced()`` as a
    pickled numpy tree, for the port's workers (the factory module reads
    it); the reference's serve runtime draws the same seed itself."""
    path = tmp_path_factory.mktemp("weights") / "granite.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.device_get(
            JM.init_model_params(JCFG, jax.random.PRNGKey(0))), f)
    return str(path)


def span_tree(tracer):
    """One nested (name, children) tree per invocation root, roots in
    invocation order, children sorted."""
    spans = tracer.spans()
    kids = {}
    for s in spans:
        kids.setdefault(s.parent_id, []).append(s)

    def tree(s):
        return (s.name, sorted(tree(c) for c in kids.get(s.span_id, [])))
    roots = sorted((s for s in spans if s.name == "invocation"),
                   key=lambda s: s.attrs["inv_id"])
    return [tree(r) for r in roots]


def serve_slice(gw, backend, master, rid, prewarm_workers=0):
    """The 8 events mapped while takes are held (micro-batches of 4), then
    one more invoke once they settled; what the client observed."""
    if prewarm_workers:
        hooks = backend.capacity_hooks()
        for _ in range(prewarm_workers):      # warm identity: rid + RUN
            assert hooks.prewarm(rid, RUN)
        until(lambda: sum(w["stats"].get("n_prewarms", 0) for w in
                          backend.stats()["workers"].values())
              == prewarm_workers, "the prewarms", timeout_s=WAIT)
    with takes_held(master, workers=tuple(backend.stats()["workers"])):
        futs = gw.map(rid, EVENTS, config=RUN)
    outs = [f.result(extra_time_s=WAIT) for f in futs]
    warm = gw.invoke(rid, EVENTS[0], config=RUN)
    outs.append(warm.result(extra_time_s=WAIT))
    invs = [f.invocation for f in futs + [warm]]
    tracer = JO.TRACER if isinstance(gw, JG.Gateway) else TO.TRACER
    return {"outputs": [o["outputs"] for o in outs],
            "envelopes": [{k: backend.store.get_outcome(i.result_ref)[k]
                           for k in ("ok", "value", "error", "attempt")}
                          for i in invs],
            "cold": [i.cold_start for i in invs],
            "nodes": [i.node for i in invs],
            "spans": span_tree(tracer)}


@pytest.fixture(scope="module")
def reference_slice():
    """The JAX package's cluster in this process: its master serving RPC,
    one reference worker on a thread, its ``ClusterBackend`` over the
    loopback, serving ``repro.cluster.runtimes:serve_runtime`` (seed 0)
    with the tracer on."""
    JO.reset()
    master = JCL.Master(lease_s=300.0, heartbeat_timeout_s=10.0)
    addr = master.serve()
    worker = JCL.Worker(addr, "w0", max_batch=4, heartbeat_s=0.5)
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    backend = JCL.ClusterBackend(JCL.RpcTransport(addr))
    try:
        gw = JG.Gateway(backend)
        JO.enable(clock=backend.now, metrics=gw.metrics)
        rid = backend.register_spec("repro.cluster.runtimes:serve_runtime",
                                    {"max_batch": 4})
        until(lambda: backend.stats()["workers"], "the reference worker")
        seen = serve_slice(gw, backend, master, rid)
        until(lambda: backend.stats()["workers"]["w0"]["stats"].get(
            "n_warm_starts") == 2, "the reference worker's last beat")
        seen["counts"] = serve_counts(backend)
        return seen
    finally:
        master.op_shutdown()
        thread.join(timeout=30.0)
        backend.shutdown()
        master.stop()
        JO.reset()
        assert not thread.is_alive()


def serve_counts(backend):
    return {w: (r["stats"].get("n_cold_starts"),
                r["stats"].get("n_warm_starts"), r["stats"].get("n_batches"))
            for w, r in backend.stats()["workers"].items()}


def test_granite_slice_through_both_clusters_is_token_exact(
        reference_slice, weights):
    j = reference_slice
    h = start_cluster(1, heartbeat_timeout_s=10.0, lease_s=300.0,
                      max_batch=4)
    try:
        gw = Gateway(h.backend)
        TO.enable(clock=h.backend.now, metrics=gw.metrics)
        rid = h.backend.register_spec(
            "torch_cluster_factory:granite_from_pickle",
            {"path": weights, "max_batch": 4})
        t = serve_slice(gw, h.backend, h.master, rid)
        until(lambda: serve_counts(h.backend)["w0"][1] == 2,
              "the worker's last beat")
        t["counts"] = serve_counts(h.backend)
    finally:
        h.close()
    assert j["counts"] == {"w0": (1, 2, 3)}   # batches 4, 4, then 1 warm
    assert j["cold"] == [True] * 4 + [False] * 5
    # greedy decoding stops early at the end-of-sequence token
    assert all(1 <= len(o) <= 4 for out in j["outputs"] for o in out)
    assert t["outputs"] == j["outputs"]      # greedy tokens, tolerance 0
    assert t["envelopes"] == j["envelopes"]
    assert (t["counts"], t["cold"], t["nodes"]) == \
        (j["counts"], j["cold"], j["nodes"])
    assert t["spans"] == j["spans"]
    names = {n for tree in t["spans"] for n, _ in tree[1]}
    assert {"queue_wait", "dispatch", "execute", "store_put"} <= names
    lead_execute = dict(t["spans"][0][1])["execute"]
    assert {n for n, _ in lead_execute} == {"prefill", "decode"}


def test_granite_on_two_worker_processes_is_token_exact(reference_slice,
                                                        weights):
    """Two worker processes, each prewarmed by a directive (round-robin,
    one each): the 8 held events form one micro-batch of 4 on each
    worker, and every event's tokens equal the reference cluster's."""
    h = start_cluster(2, heartbeat_timeout_s=10.0, lease_s=300.0,
                      max_batch=4)
    try:
        gw = Gateway(h.backend)
        rid = h.backend.register_spec(
            "torch_cluster_factory:granite_from_pickle",
            {"path": weights, "max_batch": 4})
        t = serve_slice(gw, h.backend, h.master, rid, prewarm_workers=2)
        pids = {w: r["stats"]["pid"]
                for w, r in h.backend.stats()["workers"].items()}
    finally:
        h.close()
    assert t["outputs"] == reference_slice["outputs"]
    assert [e["ok"] for e in t["envelopes"]] == [True] * 9
    assert set(t["nodes"][:8]) == {"w0", "w1"}      # a batch on each
    assert sorted(t["nodes"][:8]) == ["w0"] * 4 + ["w1"] * 4
    assert len(set(pids.values())) == 2 and os.getpid() not in pids.values()
    assert not any(t["cold"])                   # both prewarmed


# ------------------------------------- heartbeat during a long prewarm
@pytest.mark.parametrize("pkg,lost", [("repro_torch", 0), ("repro", 1)])
def test_prewarm_longer_than_heartbeat_timeout_keeps_the_worker(pkg, lost):
    """A prewarm directive whose ``setup`` sleeps 4.5 s arrives while the
    worker executes a 4.5 s event (so no parked ``take`` beats for it),
    against a 3 s heartbeat timeout. The port runs the prewarm off the
    heartbeat thread and the worker stays alive; the reference runs it
    on that thread, stops beating and is declared dead (its event is
    requeued and served again; a reference difference, ROADMAP Queue 3)."""
    C, _, _, _ = PKGS[pkg]
    G = TG if pkg == "repro_torch" else JG
    master = C.Master(lease_s=300.0, heartbeat_timeout_s=3.0,
                      keeper_interval_s=0.1)
    addr = master.serve()
    worker = C.Worker(addr, "w0", heartbeat_s=0.2)
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    backend = C.ClusterBackend(C.RpcTransport(addr))
    try:
        gw = G.Gateway(backend)
        busy = backend.register_spec(f"{pkg}.cluster.runtimes:sleep_runtime",
                                     {"runtime_id": "busy", "sleep_s": 4.5})
        slow = backend.register_spec("torch_cluster_factory:slow_setup_runtime",
                                     {"pkg": pkg, "setup_s": 4.5})
        fut = gw.invoke(busy, {"i": 0})
        until(lambda: master.op_stats()["leased"] == 1, "the busy event")
        assert backend.capacity_hooks().prewarm(slow)
        assert fut.result(extra_time_s=WAIT)["echo"] == {"i": 0}
        until(lambda: worker.n_prewarms == 1, "the prewarm", timeout_s=WAIT)
        st = master.op_stats()
        assert st["workers_lost"] == lost
        assert st["requeued"] == lost
        warm = gw.invoke(slow, "x")
        assert warm.result(extra_time_s=WAIT) == {"echo": "x", "warm": True}
        assert warm.invocation.prewarmed and not warm.invocation.cold_start
    finally:
        master.op_shutdown()
        thread.join(timeout=30.0)
        backend.shutdown()
        master.stop()
    assert not thread.is_alive()


@pytest.mark.parametrize("late", ["directives", "cold start"])
def test_one_setup_per_key_while_a_prewarm_runs(late):
    """Prewarm directives for one key reach one port worker while that
    key's ``setup()`` runs, held open by the test (four in one heartbeat
    reply, two more during the setup): the setup runs once and one
    prewarm is counted. An event of that key taken meanwhile waits for
    the prewarm's setup and is served from its handle as a cold start.
    (The reference runs repeated directives in turn on its beat thread,
    each first syncing the catalogue behind a parked ``take``: the stall
    ``ROADMAP.md`` Queue 3 names, so it has no twin here.)"""
    import torch_cluster_factory as F
    F.SETUPS.clear()
    F.GATE.clear()
    master = Master(lease_s=300.0, heartbeat_timeout_s=3.0,
                    keeper_interval_s=0.1)
    addr = master.serve()
    worker = TCL.Worker(addr, "w0", heartbeat_s=0.2)
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    backend = ClusterBackend(TCL.RpcTransport(addr))
    try:
        gw = Gateway(backend)
        slow = backend.register_spec("torch_cluster_factory:slow_setup_runtime",
                                     {"setup_s": 0.0, "gated": True})
        hooks = backend.capacity_hooks()
        for _ in range(4 if late == "directives" else 1):
            assert hooks.prewarm(slow)
        until(lambda: F.SETUPS.get("slow", 0) >= 1, "the prewarm's setup")
        if late == "directives":
            for _ in range(2):
                assert hooks.prewarm(slow)
            until(lambda: not master._directives.get("w0"),
                  "the late directives")
            time.sleep(0.5)             # a second setup would begin by now
            F.GATE.set()
            until(lambda: worker.n_prewarms == 1, "the prewarm")
            ev = gw.invoke(slow, "x")
        else:
            ev = gw.invoke(slow, "x")
            until(lambda: worker._inflight_n == 1, "the event's batch")
            time.sleep(0.5)             # it reaches the running setup by now
            F.GATE.set()
        assert ev.result(extra_time_s=WAIT) == {"echo": "x", "warm": True}
        assert F.SETUPS == {"slow": 1}
        assert worker.n_prewarms == 1
        if late == "directives":
            assert ev.invocation.prewarmed and not ev.invocation.cold_start
            assert (worker.n_cold_starts, worker.n_warm_starts) == (0, 1)
        else:
            assert ev.invocation.cold_start and not ev.invocation.prewarmed
            assert (worker.n_cold_starts, worker.n_warm_starts) == (1, 0)
        assert master.op_stats()["workers_lost"] == 0
    finally:
        F.GATE.set()
        master.op_shutdown()
        thread.join(timeout=30.0)
        backend.shutdown()
        master.stop()
    assert not thread.is_alive()


# ------------------------------------------------------------ launcher
def _launch(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("extra", [["--events", "2"], ["--workflow", "2"]],
                         ids=["events", "workflow"])
def test_launcher_cluster_serves_on_worker_processes(extra):
    p = _launch("--cluster", "1", "--reduced", "--device", "cpu", *extra)
    assert p.returncode == 0, p.stdout + p.stderr
    if extra[0] == "--events":
        assert "2/2 events served" in p.stdout
        assert re.search(r"ev1 cold=0 .*acc=w0/pid\d+\(host-cuda\)", p.stdout)
    else:
        assert p.stdout.count("'polish': 'done'") == 2
        assert "6/6 workflow steps succeeded" in p.stdout
    assert "workers_lost=0" in p.stdout
