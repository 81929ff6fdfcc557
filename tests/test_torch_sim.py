"""The port's simulation core (``repro_torch.core``: simclock, queue,
scheduler, node, workload, cluster, autoscaler, faults) and its
``SimBackend`` against the JAX package's.

Every test of ``tests/test_core_queue.py``, ``test_cluster_sim.py`` and
``test_autoscaler.py``, the sim cases of ``test_faults.py``, the tests of
``test_coldstart_accounting.py`` and the ``SimBackend`` tests of
``test_gateway.py`` run as one scenario through both packages: each keeps
the reference suite's assertions and returns what it observed, and the
two packages must observe the same. On profile-only runtimes that is
exact: every settled invocation's envelope (its timestamps, node,
accelerator, cold and prewarmed flags, attempt, outcome; without the
process-global ids), the metrics summaries and the autoscaler's node
timeline, since both draw their service times from ``random.Random`` of
the same seeds. Then the slice: granite-3-2b ``.reduced()`` through
``make_serve_runtime`` on ``SimBackend``, its real ``fn`` run inside
virtual time on the same weights, token-exact, with the same placements,
order and cold/warm counts (timestamps differ: ELat is wall time).
"""
import dataclasses
import math
import types

import jax
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.controlplane as JCP  # noqa: E402
import repro.core.accelerator as JA  # noqa: E402
import repro.core.autoscaler as JAS  # noqa: E402
import repro.core.cluster as JC  # noqa: E402
import repro.core.events as JE  # noqa: E402
import repro.core.queue as JQ  # noqa: E402
import repro.core.runtime as JR  # noqa: E402
import repro.core.workload as JW  # noqa: E402
import repro.faults as JF  # noqa: E402
import repro.gateway as JG  # noqa: E402
import repro_torch.controlplane as TCP  # noqa: E402
import repro_torch.core.accelerator as TA  # noqa: E402
import repro_torch.core.autoscaler as TAS  # noqa: E402
import repro_torch.core.cluster as TC  # noqa: E402
import repro_torch.core.events as TE  # noqa: E402
import repro_torch.core.queue as TQ  # noqa: E402
import repro_torch.core.runtime as TR  # noqa: E402
import repro_torch.core.workload as TW  # noqa: E402
import repro_torch.faults as TF  # noqa: E402
import repro_torch.gateway as TG  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.api import make_serve_runtime as jmake_serve_runtime  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.serve.api import make_serve_runtime as tmake_serve_runtime  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(A=JA, AS=JAS, C=JC, E=JE, Q=JQ, R=JR, W=JW,
                                 F=JF, G=JG, CP=JCP, device={}),
    "torch": types.SimpleNamespace(A=TA, AS=TAS, C=TC, E=TE, Q=TQ, R=TR, W=TW,
                                   F=TF, G=TG, CP=TCP,
                                   device={"device": "cpu"}),
}

# the process-global ids (each package counts its own invocations)
IDS = ("inv_id", "result_ref", "trace_id", "span_id")


def envelope(inv):
    """Everything a settled invocation records, without its global ids."""
    return {k: v for k, v in vars(inv).items() if k not in IDS}


def summary(m):
    """The metrics summary with NaN made comparable."""
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in m.summary().items()}


def observe(m):
    return {"envelopes": [envelope(i) for i in m.completed],
            "summary": summary(m)}


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__
    return None


@pytest.fixture
def make():
    """make(pkg, **kw) -> that package's EngineBackend, shut down at the
    end of the test."""
    made = []

    def _make(pkg, **kw):
        eb = pkg.G.EngineBackend(**pkg.device, **kw)
        made.append(eb)
        return eb
    yield _make
    for eb in made:
        eb.shutdown()


def both(scenario, *args):
    seen = {name: scenario(pkg, *args) for name, pkg in PKGS.items()}
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


# ------------------------------------------- tests/test_core_queue.py
RUNTIMES = ["rt-a", "rt-b", "rt-c"]


def mk(pkg, rt, cfg=None, t=0.0):
    return pkg.E.Invocation(runtime_id=rt, data_ref="d", config=cfg or {},
                            r_start=t)


def no_lost_no_duplicated(pkg, runtimes, supports):
    q = pkg.Q.ScannableQueue()
    events = [mk(pkg, rt, t=float(i)) for i, rt in enumerate(runtimes)]
    for e in events:
        q.publish(e, e.r_start)
    index = {e.inv_id: i for i, e in enumerate(events)}
    taken = []
    draws = iter(supports)
    while len(q):
        got = q.take_any(set(next(draws, RUNTIMES)))
        if got is None:
            # nothing matching: drain with full support to finish
            got = q.take_any(set(RUNTIMES))
            if got is None:
                break
        taken.append(index[got.inv_id])
    assert sorted(taken) == list(range(len(events)))
    return taken


@settings(max_examples=50, deadline=None)
@given(st.lists(st.sampled_from(RUNTIMES), max_size=40),
       st.lists(st.sets(st.sampled_from(RUNTIMES), min_size=1).map(sorted),
                max_size=60))
def test_queue_no_lost_no_duplicated_events(runtimes, supports):
    both(no_lost_no_duplicated, runtimes, supports)


def take_any_fifo(pkg):
    q = pkg.Q.ScannableQueue()
    e1, e2, e3 = mk(pkg, "rt-a"), mk(pkg, "rt-b"), mk(pkg, "rt-a")
    for e in (e1, e2, e3):
        q.publish(e)
    seen = [q.take_any({"rt-a"}) is e1, q.take_any({"rt-a"}) is e3,
            q.take_any({"rt-a"}), q.take_any({"rt-b"}) is e2]
    assert seen == [True, True, None, True]
    return seen


def take_matching_key(pkg):
    q = pkg.Q.ScannableQueue()
    e1 = mk(pkg, "rt-a", {"model": "x"})
    e2 = mk(pkg, "rt-a", {"model": "y"})
    q.publish(e1)
    q.publish(e2)
    seen = [q.take_matching(e2.runtime_key) is e2,
            q.take_matching(e2.runtime_key), len(q), e2.runtime_key]
    assert seen[:3] == [True, None, 1]
    return seen


def scan_readonly_ordered(pkg):
    q = pkg.Q.ScannableQueue()
    events = [mk(pkg, "rt-a", t=float(i)) for i in range(5)]
    for e in events:
        q.publish(e)
    seen = [[events.index(e) for e in q.scan()], len(q)]
    assert seen == [[0, 1, 2, 3, 4], 5]
    return seen


def depth_conservation(pkg, pairs):
    q = pkg.Q.ScannableQueue()
    for i, (rt, m) in enumerate(pairs):
        q.publish(mk(pkg, rt, {"model": m}, t=float(i)), float(i))
    n = len(pairs)
    while q.take_any(set(RUNTIMES), 999.0) is not None:
        pass
    assert (q.n_published, q.n_taken, len(q)) == (n, n, 0)
    if q.depth_timeline:
        assert q.depth_timeline[-1][1] == 0
    return [q.n_published, q.n_taken, list(q.depth_timeline)]


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(RUNTIMES),
                          st.sampled_from(["m1", "m2"])), max_size=30))
def test_queue_depth_timeline_conservation(pairs):
    both(depth_conservation, pairs)


# ------------------------------------------ tests/test_cluster_sim.py
def run_paper(pkg, with_vpu, scheduler="warm", scale=0.05, seed=0,
              timeout=60.0):
    cl = pkg.C.paper_testbed(with_vpu=with_vpu, scheduler=scheduler,
                             invocation_timeout_s=timeout, seed=seed)
    wl = pkg.W.PhaseWorkload(phases=pkg.W.paper_phases(10, 20, 20,
                                                       scale=scale),
                             runtime_id="onnx-tinyyolov2",
                             data_ref="data:voc-images", seed=seed)
    return cl.run_workloads([wl]), cl


def all_events_complete(pkg):
    m, cl = run_paper(pkg, with_vpu=True)
    assert len(m.completed) == cl.queue.n_published
    assert all(i.check_monotone() for i in m.completed)
    return observe(m)


def elat_medians(pkg):
    m, _ = run_paper(pkg, with_vpu=True, scale=0.2)
    gpu, vpu = m.median_elat("gpu"), m.median_elat("vpu")
    assert abs(gpu - 1.675) < 0.05 and abs(vpu - 1.577) < 0.05
    return [gpu, vpu, observe(m)]


def vpu_increases_throughput(pkg):
    m_gpu, _ = run_paper(pkg, with_vpu=False, scale=0.2)
    m_all, _ = run_paper(pkg, with_vpu=True, scale=0.2)
    assert m_all.rfast_max() > m_gpu.rfast_max()
    assert m_all.r_success() > m_gpu.r_success()
    return [summary(m_gpu), summary(m_all), m_gpu.rfast_max(),
            m_all.rfast_max()]


def vpu_raises_max_rlat(pkg):
    m_gpu, _ = run_paper(pkg, with_vpu=False, scale=0.2, timeout=120.0)
    m_all, _ = run_paper(pkg, with_vpu=True, scale=0.2, timeout=120.0)
    rl_gpu, rl_all = m_gpu.rlats(), m_all.rlats()
    assert rl_all[-1] >= rl_gpu[-1] * 0.95
    return [rl_gpu, rl_all]


def warm_affinity(pkg):
    out = {}
    for sched in ("warm", "fifo"):
        cl = pkg.C.Cluster(scheduler=sched, seed=0)
        cl.add_node("n0", [pkg.C.GPU_K600])
        cl.register_runtime(pkg.C.tinyyolo_runtime())
        # two interleaved workload configs competing for one GPU
        for m in ("m1", "m2"):
            wl = pkg.W.PhaseWorkload(
                phases=[pkg.W.Phase("p", 60, 0.4)],
                runtime_id="onnx-tinyyolov2",
                data_ref="runtime:onnx-tinyyolov2", config={"model": m})
            for inv in wl.events():
                cl.submit(inv)
        cl.run(until=600)
        node = cl.nodes[0]
        out[sched] = [node.n_cold_starts, node.n_warm_starts,
                      observe(cl.metrics)]
    assert out["warm"][0] <= out["fifo"][0]
    assert out["warm"][1] >= out["fifo"][1]
    return out


def scale_to_zero(pkg):
    cl = pkg.C.Cluster(scheduler="warm", idle_timeout_s=10.0)
    cl.add_node("n0", [pkg.C.GPU_K600])
    cl.register_runtime(pkg.C.tinyyolo_runtime())
    cl.submit(pkg.E.Invocation(runtime_id="onnx-tinyyolov2", data_ref="x",
                               r_start=0.0))
    cl.run(until=500.0)
    acc = cl.nodes[0].accelerators[0]
    assert not acc.warm
    return [dict(acc.warm), observe(cl.metrics)]


def throughput_bounded(pkg):
    m, _ = run_paper(pkg, with_vpu=False, scale=0.2, timeout=1e9)
    rate = m.r_success() / (844 * 0.2 + 600)
    assert rate <= 4 / 1.675 * 1.1
    return [rate, summary(m)]


def cost_aware(pkg):
    cl = pkg.C.Cluster(scheduler="cost", seed=0)
    cl.add_node("n0", [pkg.C.GPU_K600, pkg.C.VPU_NCS])
    cl.register_runtime(pkg.C.tinyyolo_runtime())
    for i in range(4):
        cl.submit(pkg.E.Invocation(runtime_id="onnx-tinyyolov2",
                                   data_ref="x", r_start=float(i * 30)))
    cl.run(until=1000.0)
    accs = [i.accelerator for i in cl.metrics.completed]
    assert all("vpu" in a for a in accs), accs
    return observe(cl.metrics)


def slice_runtime(pkg, elat, cold):
    return pkg.R.RuntimeDef(runtime_id="rt", profiles={
        "v5e-4x4": pkg.R.SimProfile(elat_median_s=elat, cold_start_s=cold)})


def autoscaler_provisions_and_drains(pkg):
    spec = pkg.A.AcceleratorSpec(type="v5e-4x4", slots=2)
    cl = pkg.C.Cluster(scheduler="warm", seed=0)
    cl.register_runtime(slice_runtime(pkg, 0.8, 5.0))
    cl.store.put(b"\0" * 128, key="d")
    cl.add_node("auto-seed", [spec])
    scaler = pkg.AS.Autoscaler(cl, spec, pkg.AS.AutoscalerConfig(
        min_nodes=1, max_nodes=4, provision_delay_s=20.0,
        check_interval_s=5.0, cooldown_checks=3))
    scaler.start()
    wl = pkg.W.PhaseWorkload(phases=[pkg.W.Phase("burst", 120, 5.0),
                                     pkg.W.Phase("calm", 400, 0.1)],
                             runtime_id="rt", data_ref="d")
    m = cl.run_workloads([wl], extra_time_s=900.0)
    scaler.stop()
    actions = [e[1] for e in scaler.events]
    assert "node-ready" in actions and "drain" in actions
    assert all(i.success for i in m.completed)
    drained = [n for n in cl.nodes if n.draining]
    assert drained and all(a.busy_slots == 0 for n in drained
                           for a in n.accelerators)
    return [list(scaler.events), scaler.node_seconds, observe(m)]


def autoscaler_respects_max_nodes(pkg):
    spec = pkg.A.AcceleratorSpec(type="v5e-4x4", slots=1)
    cl = pkg.C.Cluster(scheduler="warm", seed=0)
    cl.register_runtime(slice_runtime(pkg, 2.0, 2.0))
    cl.store.put(b"\0" * 128, key="d")
    cl.add_node("auto-seed", [spec])
    scaler = pkg.AS.Autoscaler(cl, spec, pkg.AS.AutoscalerConfig(
        min_nodes=1, max_nodes=2, provision_delay_s=10.0,
        check_interval_s=5.0))
    scaler.start()
    wl = pkg.W.PhaseWorkload(phases=[pkg.W.Phase("flood", 200, 10.0)],
                             runtime_id="rt", data_ref="d")
    cl.run_workloads([wl], extra_time_s=0.0)
    scaler.stop()
    assert len([e for e in scaler.events if e[1] == "node-ready"]) <= 2
    return [list(scaler.events), observe(cl.metrics)]


# ------------------------------------------- tests/test_autoscaler.py
def build_scaled(pkg, cfg):
    spec = pkg.A.AcceleratorSpec(type="v5e-4x4", slots=1,
                                 mem_bytes=16 << 30, cost_per_hour=19.2)
    cl = pkg.C.Cluster(scheduler="warm", seed=0)
    cl.add_node("auto-seed", [spec])
    gw = pkg.G.Gateway(pkg.G.SimBackend(cl))
    gw.register(pkg.R.RuntimeDef(
        runtime_id="serve-sim",
        profiles={"v5e-4x4": pkg.R.SimProfile(elat_median_s=0.8, sigma=0.1,
                                              cold_start_s=8.0)}))
    scaler = pkg.AS.Autoscaler(cl, spec, pkg.AS.AutoscalerConfig(**cfg),
                               node_prefix="auto")
    return cl, gw, scaler


def burst(gw, n=400, spacing=0.2):
    gw.map("serve-sim", [b"\0"] * n, at=0.0, spacing_s=spacing)
    gw.drain(extra_time_s=2000.0)


def timeline(scaler, gw):
    return [list(scaler.events), scaler.node_seconds, observe(gw.metrics)]


def scale_out_cooldown_scale_in(pkg):
    cfg = dict(min_nodes=1, max_nodes=6, provision_delay_s=30.0,
               check_interval_s=5.0, cooldown_checks=3)
    cl, gw, scaler = build_scaled(pkg, cfg)
    scaler.start()
    burst(gw)
    scaler.stop()
    starts = [e for e in scaler.events if e[1] == "provision-start"]
    readies = [e for e in scaler.events if e[1] == "node-ready"]
    drains = [e for e in scaler.events if e[1] == "drain"]
    assert starts and readies and drains and len(readies) <= len(starts)
    for (t_start, _, _), (t_ready, _, _) in zip(starts, readies):
        assert t_ready - t_start == cfg["provision_delay_s"]
    window = cfg["cooldown_checks"] * cfg["check_interval_s"]
    assert drains[0][0] > readies[-1][0]
    assert drains[0][0] - readies[-1][0] >= window
    for (t_a, _, _), (t_b, _, _) in zip(drains, drains[1:]):
        assert t_b - t_a >= window
    assert gw.metrics.r_success() == 400
    return timeline(scaler, gw)


def scale_out_max_nodes(pkg):
    cfg = dict(min_nodes=1, max_nodes=2, provision_delay_s=10.0,
               check_interval_s=5.0, cooldown_checks=3)
    cl, gw, scaler = build_scaled(pkg, cfg)
    scaler.start()
    burst(gw, n=600)
    scaler.stop()
    readies = [e for e in scaler.events if e[1] == "node-ready"]
    assert 1 <= len(readies) <= 2 and gw.metrics.r_success() == 600
    return timeline(scaler, gw)


def scale_in_stops_at_min(pkg):
    cfg = dict(min_nodes=1, max_nodes=6, provision_delay_s=20.0,
               check_interval_s=5.0, cooldown_checks=2)
    cl, gw, scaler = build_scaled(pkg, cfg)
    scaler.start()
    burst(gw)
    cl.clock.run(until=cl.clock.now() + 600.0)
    scaler.stop()
    readies = [e for e in scaler.events if e[1] == "node-ready"]
    drains = [e for e in scaler.events if e[1] == "drain"]
    assert len(drains) == max(len(readies) + 1 - cfg["min_nodes"], 0)
    assert len(scaler.managed_nodes) >= cfg["min_nodes"]
    return timeline(scaler, gw)


def no_provisioning_without_pressure(pkg):
    cfg = dict(min_nodes=1, max_nodes=6, provision_delay_s=20.0,
               check_interval_s=5.0, cooldown_checks=3)
    cl, gw, scaler = build_scaled(pkg, cfg)
    scaler.start()
    gw.map("serve-sim", [b"\0"] * 30, at=0.0, spacing_s=2.0)
    gw.drain(extra_time_s=600.0)
    scaler.stop()
    assert not [e for e in scaler.events if e[1] == "provision-start"]
    assert gw.metrics.r_success() == 30
    return timeline(scaler, gw)


def cost_accounting(pkg):
    cfg = dict(min_nodes=1, max_nodes=4, provision_delay_s=20.0,
               check_interval_s=5.0, cooldown_checks=3)
    cl, gw, scaler = build_scaled(pkg, cfg)
    scaler.start()
    burst(gw, n=200)
    scaler.stop()
    peak = 1 + len([e for e in scaler.events if e[1] == "node-ready"])
    assert 0.0 < scaler.node_seconds <= cl.clock.now() * peak
    return timeline(scaler, gw)


# ------------------------------------------ tests/test_gateway.py (sim)
def sim_invoke_parity(pkg):
    wl = pkg.W.PhaseWorkload(phases=pkg.W.paper_phases(10, 20, 20,
                                                       scale=0.05),
                             runtime_id="onnx-tinyyolov2",
                             data_ref="data:voc-images", seed=0)
    m_direct = pkg.C.paper_testbed(with_vpu=True, seed=0).run_workloads([wl])
    gw = pkg.G.Gateway(pkg.G.SimBackend(pkg.C.paper_testbed(with_vpu=True,
                                                            seed=0)))
    for t in wl.arrivals():
        gw.invoke("onnx-tinyyolov2", data_ref="data:voc-images", at=t)
    gw.drain()
    m_gw = gw.metrics
    assert m_gw.r_success() == m_direct.r_success()
    assert m_gw.elats() == pytest.approx(m_direct.elats())
    assert m_gw.rlats() == pytest.approx(m_direct.rlats())
    return [observe(m_direct), observe(m_gw)]


def future_roundtrip(pkg):
    gw = pkg.G.Gateway(pkg.G.SimBackend(pkg.C.paper_testbed(with_vpu=False)))
    fut = gw.invoke("onnx-tinyyolov2", b"an-image", at=0.0)
    before = [fut.done(), fut.poll()]
    out = fut.result()
    rec = gw.backend.store.get_outcome(fut.invocation.result_ref)
    assert before == [False, False] and out is None and fut.poll()
    assert rec["ok"] is True and fut.rlat >= fut.elat
    return [before, out, {k: rec[k] for k in ("ok", "value", "error")},
            envelope(fut.invocation)]


def map_fans_out(pkg):
    gw = pkg.G.Gateway(pkg.G.SimBackend(pkg.C.paper_testbed(with_vpu=True)))
    futs = gw.map("onnx-tinyyolov2", [b"a", b"b", b"c", b"d"],
                  at=0.0, spacing_s=0.5)
    assert [f.invocation.r_start for f in futs] == [0.0, 0.5, 1.0, 1.5]
    results = gw.gather(futs)
    assert len(results) == 4 and all(f.invocation.success for f in futs)
    return [results, [envelope(f.invocation) for f in futs]]


def unknown_runtime(pkg):
    gw = pkg.G.Gateway(pkg.G.SimBackend(pkg.C.paper_testbed(with_vpu=False)))
    err = raised(lambda: gw.invoke("no-such-runtime", b"x"))
    assert err == "KeyError"
    return err


def autoscaler_under_gateway_load(pkg):
    cfg = dict(min_nodes=1, max_nodes=6, provision_delay_s=30.0,
               check_interval_s=5.0, cooldown_checks=3)
    cl, gw, scaler = build_scaled(pkg, cfg)
    scaler.start()
    gw.map("serve-sim", [b"\0"] * 600, at=0.0, spacing_s=0.2)
    gw.drain(extra_time_s=2000.0)
    scaler.stop()
    assert [e for e in scaler.events if e[1] == "node-ready"]
    assert [e for e in scaler.events if e[1] == "drain"]
    assert gw.metrics.r_success() == 600
    return timeline(scaler, gw)


def map_spacing_without_at(pkg):
    gw = pkg.G.Gateway(pkg.G.SimBackend(pkg.C.paper_testbed(with_vpu=False)))
    futs = gw.map("onnx-tinyyolov2", [b"a", b"b", b"c"], spacing_s=0.5)
    starts = [f.invocation.r_start for f in futs]
    assert starts[1] - starts[0] == pytest.approx(0.5)
    assert starts[2] - starts[1] == pytest.approx(0.5)
    return starts


# ------------------------------------------- tests/test_faults.py (sim)
def lease_inv(pkg, rt="rt-a", t=0.0):
    return pkg.E.Invocation(runtime_id=rt, data_ref="d", r_start=t)


def lease_ack(pkg):
    q = pkg.Q.ScannableQueue(lease_s=10.0)
    inv = lease_inv(pkg)
    q.publish(inv, 0.0)
    got = q.take_any({"rt-a"}, 0.0, holder="n0")
    seen = [got is inv, q.n_leased, q.holder_of(inv.inv_id),
            q.ack(inv.inv_id), q.n_leased, q.reap(1e9)]
    assert seen == [True, 1, "n0", True, 0, []]
    return seen


def lease_expiry_requeues_head(pkg):
    q = pkg.Q.ScannableQueue(lease_s=10.0)
    q.configure_retries(lambda inv: 3, lambda inv, msg: None)
    first, second = lease_inv(pkg, t=0.0), lease_inv(pkg, t=1.0)
    q.publish(first, 0.0)
    q.publish(second, 1.0)
    assert q.take_any({"rt-a"}, 1.0, holder="n0") is first
    early = q.reap(5.0)
    requeued = q.reap(11.0)
    order = [i is first for i in q.scan()]
    assert early == [] and requeued == [first] and first.attempt == 1
    assert first.n_start is None and order == [True, False]
    return [early, len(requeued), first.attempt, order]


def lease_exhausted(pkg):
    q = pkg.Q.ScannableQueue(lease_s=1.0)
    failed = []
    q.configure_retries(lambda inv: 1,
                        lambda inv, msg: failed.append((inv, msg)))
    inv = lease_inv(pkg)
    q.publish(inv, 0.0)
    q.take_any({"rt-a"}, 0.0, holder="n0")
    seen = [q.reap(2.0), len(q), q.n_exhausted, failed[0][0] is inv,
            failed[0][1]]
    assert seen[:4] == [[], 0, 1, True]
    assert seen[4].startswith("retries exhausted after 1 attempt(s): ")
    return seen


def release_holder(pkg):
    q = pkg.Q.ScannableQueue(lease_s=100.0)
    q.configure_retries(lambda inv: 3, lambda inv, msg: None)
    a, b = lease_inv(pkg), lease_inv(pkg)
    q.publish(a, 0.0)
    q.publish(b, 0.0)
    q.take_any({"rt-a"}, 0.0, holder="n0")
    q.take_any({"rt-a"}, 0.0, holder="n1")
    requeued = q.release_holder("n0", 1.0)
    seen = [[i is a for i in requeued], a.attempt, q.holder_of(b.inv_id)]
    assert seen == [[True], 1, "n1"]
    return seen


def late_settled_dropped(pkg):
    q = pkg.Q.ScannableQueue(lease_s=1.0)
    q.configure_retries(lambda inv: 3, lambda inv, msg: None)
    inv = lease_inv(pkg)
    q.publish(inv, 0.0)
    q.take_any({"rt-a"}, 0.0, holder="n0")
    inv.r_end = 0.5                         # settled without ack
    seen = [q.reap(10.0), q.n_leased, len(q)]
    assert seen == [[], 0, 0]
    return seen


def fault_spec_validation(pkg):
    actions = pkg.F.parse_fault_spec(
        '[{"at": 1.0, "op": "kill-node", "node": "n0"},'
        ' {"at": 2.0, "op": "crash-worker", "worker": 1}]')
    assert actions[0] == pkg.F.FaultAction(at=1.0, op="kill-node", node="n0")
    bad = [raised(lambda: pkg.F.parse_fault_spec(
               '[{"at": 1.0, "op": "meteor-strike"}]')),
           raised(lambda: pkg.F.parse_fault_spec(
               '[{"at": 1.0, "op": "kill-node"}]'))]
    assert bad == ["ValueError", "ValueError"]
    return [[dataclasses.asdict(a) for a in actions], bad,
            sorted(pkg.F.ALL_OPS)]


def one_node_cluster(pkg, **kw):
    cl = pkg.C.Cluster(seed=0, **kw)
    cl.add_node("n0", [pkg.C.GPU_K600])
    return cl


def disarmed_injector(pkg):
    cl = one_node_cluster(pkg)
    cl.register_runtime(pkg.C.tinyyolo_runtime())
    cl.store.put(b"\0" * 64, key="d")
    inj = pkg.F.inject(cl, [{"at": 50.0, "op": "kill-node", "node": "n0"}])
    inj.disarm()
    cl.submit(lease_inv(pkg, "onnx-tinyyolov2", t=60.0))
    cl.drain()
    assert not cl.nodes[0].dead and inj.injected == []
    assert cl.metrics.r_success() == 1
    return observe(cl.metrics)


def ops_rejected_across_backends(pkg, make):
    eb = make(pkg)
    seen = [raised(lambda: pkg.F.inject(
                eb, [{"at": 0.0, "op": "kill-node", "node": "x"}])),
            raised(lambda: pkg.F.inject(
                pkg.C.Cluster(seed=0),
                [{"at": 0.0, "op": "crash-worker", "worker": 0}]))]
    assert seen == ["ValueError", "ValueError"]
    return seen


def kill_cluster(pkg, max_attempts, n_nodes=2, n_events=8, kill_at=4.0):
    cl = pkg.C.Cluster(seed=0, lease_s=30.0)
    for i in range(n_nodes):
        cl.add_node(f"n{i}", [pkg.C.GPU_K600])
    cl.register_runtime(dataclasses.replace(pkg.C.tinyyolo_runtime(),
                                            max_attempts=max_attempts))
    cl.store.put(b"\0" * 1024, key="d")
    for i in range(n_events):
        cl.submit(lease_inv(pkg, "onnx-tinyyolov2", t=float(i)))
    inj = pkg.F.inject(cl, [{"at": kill_at, "op": "kill-node",
                             "node": "n0"}])
    cl.drain()
    inj.disarm()
    return cl, inj


def node_kill_redelivers(pkg):
    cl, inj = kill_cluster(pkg, max_attempts=3)
    m = cl.metrics
    assert len(m.completed) == 8 and m.r_success() == 8
    assert m.summary()["retried"] >= 1
    assert all(i.check_monotone() for i in m.completed)
    retried = [i for i in m.completed if i.attempt > 0]
    assert retried and all(i.node == "n1" for i in retried)
    return [observe(m), inj.injected, inj.summary()]


def node_kill_exhausted(pkg):
    cl, inj = kill_cluster(pkg, max_attempts=1)
    m = cl.metrics
    s = m.summary()
    assert len(m.completed) == 8
    assert s["retries_exhausted"] >= 1 and s["failed"] == s["retries_exhausted"]
    for i in m.completed:
        if not i.success:
            assert i.retries_exhausted and f"result:inv{i.inv_id}" in cl.store
    return [observe(m), inj.injected]


def stalled_node(pkg):
    cl = pkg.C.Cluster(seed=0, lease_s=5.0)
    cl.add_node("n0", [pkg.C.GPU_K600])
    cl.add_node("n1", [pkg.C.GPU_K600])
    cl.register_runtime(dataclasses.replace(pkg.C.tinyyolo_runtime(),
                                            max_attempts=3))
    cl.store.put(b"\0" * 1024, key="d")
    for _ in range(5):
        cl.submit(lease_inv(pkg, "onnx-tinyyolov2", t=0.0))
    inj = pkg.F.inject(cl, [{"at": 0.1, "op": "stall-node", "node": "n0",
                             "duration_s": 60.0}], reap_interval_s=1.0)
    cl.drain()
    inj.disarm()
    m = cl.metrics
    ids = [i.inv_id for i in m.completed]
    assert len(m.completed) == 5 and m.r_success() == 5
    assert len(ids) == len(set(ids)) and m.summary()["retried"] >= 1
    assert all(i.node == "n1" for i in m.completed if i.attempt > 0)
    return [observe(m), inj.injected, inj.n_reaped]


def failure_parity(pkg, make):
    """A lost delivery past its retry bound yields equivalent records on
    the sim and the engine (the engine half compares outcomes: ELat is
    wall time there)."""
    cl = one_node_cluster(pkg, lease_s=30.0)
    cl.register_runtime(dataclasses.replace(pkg.C.tinyyolo_runtime(),
                                            max_attempts=1))
    cl.store.put(b"\0" * 1024, key="d")
    cl.submit(lease_inv(pkg, "onnx-tinyyolov2", t=0.0))
    inj = pkg.F.inject(cl, [{"at": 0.5, "op": "kill-node", "node": "n0"}])
    cl.drain()
    inj.disarm()
    sim_inv, = cl.metrics.completed

    eb = make(pkg, n_workers=1, max_batch=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(
        runtime_id="slow",
        profiles={pkg.R.HOST_ACC: pkg.R.SimProfile(elat_median_s=0.2)},
        fn=lambda d, c: {"ok": True}, max_attempts=1))
    eb.crash_worker(0)                      # armed before the first pick
    gw.invoke("slow", {"i": 0})
    gw.drain(extra_time_s=60.0)
    eng_inv, = eb.metrics.completed
    keys = ("n_completed", "r_success", "failed", "retried",
            "retries_exhausted", "rejected")
    s_sim, s_eng = cl.metrics.summary(), eb.metrics.summary()
    for inv in (sim_inv, eng_inv):
        assert not inv.success and inv.retries_exhausted and inv.attempt == 0
    assert all(s_sim[k] == s_eng[k] for k in keys)
    return [envelope(sim_inv), [s_sim[k] for k in keys],
            [eng_inv.success, eng_inv.retries_exhausted, eng_inv.error],
            cl.store.get_outcome(sim_inv.result_ref)["error"]]


# ------------------------------------- tests/test_coldstart_accounting.py
def cold_sim_gateway(pkg):
    acc = pkg.A.AcceleratorSpec(type="v5e-4x4", slots=1, mem_bytes=16 << 30)
    cl = pkg.C.Cluster(scheduler="warm", seed=0, idle_timeout_s=1e9)
    cl.add_node("n0", [acc])
    gw = pkg.G.Gateway(pkg.G.SimBackend(cl))
    gw.register(pkg.R.RuntimeDef(
        runtime_id="model",
        profiles={"v5e-4x4": pkg.R.SimProfile(elat_median_s=0.5, sigma=0.0,
                                              cold_start_s=2.0)}))
    return gw, acc


def cold_engine_gateway(pkg, make):
    eb = make(pkg, n_workers=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(
        runtime_id="model",
        profiles={pkg.R.HOST_ACC: pkg.R.SimProfile(elat_median_s=0.01)},
        fn=lambda d, c: {"ok": True}, setup=lambda: {"ready": True}))
    return gw


def cold_warm_evict_sequence(gw, evict):
    flags = []
    for _ in range(2):
        f = gw.invoke("model", b"\0")
        f.result(extra_time_s=600.0)
        flags.append(f.invocation.cold_start)
    evict()
    f = gw.invoke("model", b"\0")
    f.result(extra_time_s=600.0)
    return flags + [f.invocation.cold_start]


def cold_starts_agree(pkg, make):
    key = pkg.E.runtime_key_for("model", None)
    gw_sim, _ = cold_sim_gateway(pkg)
    sim_flags = cold_warm_evict_sequence(
        gw_sim, lambda: gw_sim.backend.capacity_hooks().evict(key))
    gw_eng = cold_engine_gateway(pkg, make)
    eng_flags = cold_warm_evict_sequence(
        gw_eng, lambda: gw_eng.backend.evict_warm(key))
    assert sim_flags == eng_flags == [True, False, True]
    node = gw_sim.backend.cluster.nodes[0]
    eb = gw_eng.backend
    assert gw_sim.summary()["cold_starts"] == gw_eng.summary()["cold_starts"]
    assert (node.n_cold_starts, node.n_warm_starts) == \
        (eb.n_cold_starts, eb.n_warm_starts) == (2, 1)
    return [sim_flags, observe(gw_sim.metrics),
            [gw_eng.summary()[k] for k in ("cold_starts", "n_completed")]]


def prewarmed_report_warm(pkg, make):
    cfg = pkg.CP.ControlPlaneConfig(
        tick_interval_s=0.1, warm=pkg.CP.WarmPolicy(min_warm={"model": 1}))
    gw_sim, acc = cold_sim_gateway(pkg)
    plane_sim = pkg.CP.ControlPlane(cfg).attach(gw_sim.backend, spec=acc)
    plane_sim.start()
    f_sim = gw_sim.invoke("model", b"\0", at=5.0)
    f_sim.result(extra_time_s=600.0)
    plane_sim.stop()

    gw_eng = cold_engine_gateway(pkg, make)
    plane_eng = pkg.CP.ControlPlane(cfg).attach(gw_eng.backend)
    plane_eng.tick()                # deterministic: one manual tick
    f_eng = gw_eng.invoke("model", b"\0")
    f_eng.result(extra_time_s=10.0)
    plane_eng.detach()
    for f in (f_sim, f_eng):
        assert not f.invocation.cold_start and f.invocation.prewarmed
    for gw in (gw_sim, gw_eng):
        assert (gw.summary()["cold_starts"], gw.summary()["prewarmed"]) == \
            (0, 1)
    return [envelope(f_sim.invocation), summary(gw_sim.metrics),
            [gw_eng.summary()[k] for k in ("cold_starts", "prewarmed")],
            plane_sim.warmpool.actions]


SCENARIOS = [take_any_fifo, take_matching_key, scan_readonly_ordered,
             all_events_complete, elat_medians, vpu_increases_throughput,
             vpu_raises_max_rlat, warm_affinity, scale_to_zero,
             throughput_bounded, cost_aware,
             autoscaler_provisions_and_drains, autoscaler_respects_max_nodes,
             scale_out_cooldown_scale_in, scale_out_max_nodes,
             scale_in_stops_at_min, no_provisioning_without_pressure,
             cost_accounting, sim_invoke_parity, future_roundtrip,
             map_fans_out, unknown_runtime, autoscaler_under_gateway_load,
             map_spacing_without_at, lease_ack, lease_expiry_requeues_head,
             lease_exhausted, release_holder, late_settled_dropped,
             fault_spec_validation, disarmed_injector, node_kill_redelivers,
             node_kill_exhausted, stalled_node]
WITH_ENGINE = [ops_rejected_across_backends, failure_parity,
               cold_starts_agree, prewarmed_report_warm]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_sim_scenario_agrees_with_jax(scenario):
    both(scenario)


@pytest.mark.parametrize("scenario", WITH_ENGINE, ids=lambda f: f.__name__)
def test_sim_and_engine_scenario_agrees_with_jax(scenario, make):
    both(scenario, make)


def test_cluster_fault_op_parses_and_raises_until_the_cluster_is_ported():
    action, = TF.parse_fault_spec(
        '[{"at": 0.5, "op": "kill-worker-process", "worker": 1}]')
    assert action.op in TF.CLUSTER_OPS
    cl = TC.Cluster(seed=0)
    with pytest.raises(NotImplementedError, match="cluster backend"):
        TF.inject(cl, [action])


# ------------------------------------------------------------ the slice
JCFG = jget_config("granite-3-2b").reduced()
TCFG = tget_config("granite-3-2b").reduced()
ENGINE = dict(max_slots=4, max_len=64, page_size=16)
ACC = "sim-acc"
EVENTS = [{"prompts": [[5, 9, 14, 3, 22], [7] * 12]},
          {"prompts": [[31, 2, 8] * 9]},
          {"prompts": [[4, 4, 17, 60], [11, 12, 13], [40] * 19]},
          {"prompts": [[2, 3]]},
          {"prompts": [[5, 9, 14, 3, 22], [7] * 12]}]
# virtual arrival times: each event settles before the next arrives (an
# ELat of wall time stays far below 30 s), so order and placement do not
# hang on the wall clock; the last comes after the 60 s idle timeout has
# evicted the instance, and pays a second cold start
ARRIVALS = [0.0, 30.0, 60.0, 90.0, 200.0]


def serve_in_virtual_time(pkg, rdef):
    cl = pkg.C.Cluster(scheduler="warm", seed=0)
    cl.add_node("n0", [pkg.A.AcceleratorSpec(type=ACC, slots=2)])
    gw = pkg.G.Gateway(pkg.G.SimBackend(cl))
    gw.register(rdef)
    futs = [gw.invoke(rdef.runtime_id, ev, config={"max_new_tokens": 4},
                      at=t) for ev, t in zip(EVENTS, ARRIVALS)]
    outs = gw.gather(futs)
    node = cl.nodes[0]
    order = [futs.index(next(f for f in futs if f.invocation is inv))
             for inv in cl.metrics.completed]
    return {"outputs": [o["outputs"] for o in outs],
            "placements": [(f.invocation.node, f.invocation.accelerator,
                            f.invocation.cold_start, f.invocation.success)
                           for f in futs],
            "order": order,
            "counts": (node.n_cold_starts, node.n_warm_starts)}


def test_granite_slice_through_both_sim_backends_is_token_exact():
    """The serve runtime's real ``fn`` inside virtual time: the JAX
    package's on its own weights, the port's on the same weights through
    the bridge (its ``setup`` replaced, as in ``test_torch_gateway.py``)."""
    prof = {ACC: JR.SimProfile(elat_median_s=0.4, cold_start_s=2.0)}
    jdef = jmake_serve_runtime(JCFG, acc_types=prof, seed=0, **ENGINE)
    tp = bridge.from_jax(
        jax.device_get(JM.init_model_params(JCFG, jax.random.PRNGKey(0))),
        device="cpu")
    tdef = tmake_serve_runtime(
        TCFG, acc_types={ACC: TR.SimProfile(elat_median_s=0.4,
                                            cold_start_s=2.0)},
        seed=0, device="cpu", **ENGINE)
    tdef = dataclasses.replace(
        tdef, setup=lambda: ServingEngine(TCFG, tp, device="cpu", **ENGINE))
    j = serve_in_virtual_time(PKGS["jax"], jdef)
    t = serve_in_virtual_time(PKGS["torch"], tdef)
    assert all(p[3] for p in j["placements"])
    assert all(len(o) == 4 for out in j["outputs"] for o in out)
    assert j["counts"] == (2, 3) and j["order"] == [0, 1, 2, 3, 4]
    assert t["outputs"] == j["outputs"]          # greedy tokens, tolerance 0
    assert t["placements"] == j["placements"]
    assert t["order"] == j["order"]
    assert t["counts"] == j["counts"]
