"""The port's control plane (``repro_torch.controlplane``) and the capacity
surface it drives (``CapacityHooks``: ``SimCapacityHooks`` over the
simulated cluster, ``EngineCapacityHooks`` over ``EngineBackend``)
against the JAX package's.

Every scenario of ``tests/test_controlplane.py`` runs through both
packages (the port's engine backend with ``device="cpu"``). Sim
scenarios compare exactly: every settled invocation's envelope, the
scaler's decisions, the warm pool's actions and the telemetry snapshots.
Engine scenarios run on the wall clock, so they compare outcomes, counts
(prewarms, cold and warm starts, sheds) and the kinds of the plane's
actions in order. Then the port's own cases: a pinned warm key survives
LRU pressure, admission inside ``submit`` does not deadlock against a
ticking plane, a prewarm from the plane's tick thread runs ``setup()``
under worker 0's card, an evicted handle has no holder left, the
launcher's flag errors match the reference launcher's, and ``--backend
sim`` settles every event. Cases marked ``gpu`` run on the card
(``python -m pytest -m gpu tests/test_torch_controlplane.py``): a prewarm
on a thread that is not a worker builds its engine on the worker's card,
and ``evict_warm`` gives the engine's memory back.

The JAX package's modules used at the top of this file import no JAX, so
the file also imports on the card; the reference launcher (which does) is
imported inside its test.
"""
import dataclasses
import gc
import sys
import threading
import time
import types
import weakref

import pytest
import torch

import repro.controlplane as JCP
import repro.core.accelerator as JA
import repro.core.autoscaler as JAS
import repro.core.cluster as JC
import repro.core.events as JE
import repro.core.runtime as JR
import repro.faults as JF
import repro.gateway as JG
import repro_torch.controlplane as TCP
import repro_torch.core.accelerator as TA
import repro_torch.core.autoscaler as TAS
import repro_torch.core.cluster as TC
import repro_torch.core.events as TE
import repro_torch.core.runtime as TR
import repro_torch.faults as TF
import repro_torch.gateway as TG

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(A=JA, AS=JAS, C=JC, E=JE, R=JR, F=JF, G=JG,
                                 CP=JCP, device={}),
    "torch": types.SimpleNamespace(A=TA, AS=TAS, C=TC, E=TE, R=TR, F=TF, G=TG,
                                   CP=TCP, device={"device": "cpu"}),
}
IDS = ("inv_id", "result_ref", "trace_id", "span_id")


def envelope(inv):
    """Everything a settled invocation records, without its global ids."""
    return {k: v for k, v in vars(inv).items() if k not in IDS}


def kinds(log):
    """The kinds of an audit log's entries, in order."""
    return [entry[1] for entry in log]


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__
    return None


@pytest.fixture
def make():
    """make(pkg, **kw) -> that package's EngineBackend; every backend (and
    plane) made through it is stopped when the test ends."""
    made, planes = [], []

    def _make(pkg, **kw):
        eb = pkg.G.EngineBackend(**pkg.device, **kw)
        made.append(eb)
        return eb
    _make.planes = planes
    yield _make
    for plane in planes:
        plane.detach()
    for eb in made:
        eb.shutdown()


def both(scenario, *args):
    seen = {name: scenario(pkg, *args) for name, pkg in PKGS.items()}
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def slice_spec(pkg):
    return pkg.A.AcceleratorSpec(type="v5e-4x4", slots=1,
                                 mem_bytes=16 << 30, cost_per_hour=19.2)


def sim_profile(pkg):
    return {"v5e-4x4": pkg.R.SimProfile(elat_median_s=0.8, sigma=0.1,
                                        cold_start_s=8.0)}


def sim_gateway(pkg, prefix="cp"):
    cl = pkg.C.Cluster(scheduler="warm", seed=0)
    cl.add_node(f"{prefix}-seed", [slice_spec(pkg)])
    gw = pkg.G.Gateway(pkg.G.SimBackend(cl))
    gw.register(pkg.R.RuntimeDef(runtime_id="serve-sim",
                                 profiles=sim_profile(pkg)))
    return gw


def engine_runtime(pkg, rid="model", setup_s=0.2):
    def setup():
        time.sleep(setup_s)
        return {"ready": True}

    def fn(data, config):
        assert config["handle"]["ready"]
        return {"ok": True}

    return pkg.R.RuntimeDef(
        runtime_id=rid,
        profiles={pkg.R.HOST_ACC: pkg.R.SimProfile(elat_median_s=0.01)},
        fn=fn, setup=setup)


def sim_record(gw, plane):
    """What a sim scenario observed, compared exactly."""
    return {"envelopes": [envelope(i) for i in gw.metrics.completed],
            "decisions": list(plane.scaler.decisions) if plane.scaler else [],
            "actions": list(plane.warmpool.actions) if plane.warmpool else [],
            "sheds": list(plane.admission.sheds) if plane.admission else [],
            "summary": plane.summary(),
            "telemetry": [dataclasses.asdict(s)
                          for s in plane.telemetry.history]}


# ------------------------------------------------------- SLO autoscaling
def queue_pressure_vs_slo(pkg):
    """The burst under the legacy queue-pressure autoscaler and under the
    SLO scaler (``benchmarks/bench_controlplane.py``'s two runs)."""
    slo_s, n = 55.0, 400

    gw_old = sim_gateway(pkg, "auto")
    scaler = pkg.AS.Autoscaler(
        gw_old.backend.cluster, slice_spec(pkg),
        pkg.AS.AutoscalerConfig(min_nodes=1, max_nodes=6,
                                provision_delay_s=45.0))
    scaler.start()
    gw_old.map("serve-sim", [b"\0"] * n, at=0.0, spacing_s=0.2)
    gw_old.drain(extra_time_s=2000.0)
    scaler.stop()

    gw_new = sim_gateway(pkg, "cp")
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        tick_interval_s=10.0,
        slo=pkg.CP.SLOPolicy(slo_rlat_p99_s=slo_s, target_concurrency=4.0,
                             max_units=6))).attach(
        gw_new.backend, spec=slice_spec(pkg), provision_delay_s=45.0)
    plane.start()
    gw_new.map("serve-sim", [b"\0"] * n, at=0.0, spacing_s=0.2)
    gw_new.drain(extra_time_s=2000.0)
    plane.stop()
    old, new = gw_old.summary(), gw_new.summary()
    assert old["r_success"] == new["r_success"] == n
    assert old["rlat_p99"] > slo_s >= new["rlat_p99"]
    assert plane.hooks.fleet.node_seconds <= scaler.node_seconds * 1.05
    return [old, scaler.node_seconds, sim_record(gw_new, plane),
            plane.hooks.fleet.node_seconds]


def scales_out_in_one_decision(pkg):
    gw = sim_gateway(pkg)
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        tick_interval_s=10.0,
        slo=pkg.CP.SLOPolicy(slo_rlat_p99_s=60.0, target_concurrency=4.0,
                             max_units=6))).attach(
        gw.backend, spec=slice_spec(pkg), provision_delay_s=45.0)
    plane.start()
    gw.map("serve-sim", [b"\0"] * 400, at=0.0, spacing_s=0.2)
    gw.drain(extra_time_s=2000.0)
    plane.stop()
    outs = [d for d in plane.scaler.decisions if d[1] == "scale-out"]
    assert outs and outs[0][2].startswith("1->6")
    readies = [e for e in plane.hooks.fleet.events if e[1] == "node-ready"]
    t_ready = [t for t, _, _ in readies]
    assert len(readies) == 5 and max(t_ready) - min(t_ready) < 1e-9
    return [sim_record(gw, plane), list(plane.hooks.fleet.events)]


def scale_down_to_min_units(pkg):
    gw = sim_gateway(pkg)
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        tick_interval_s=5.0,
        slo=pkg.CP.SLOPolicy(slo_rlat_p99_s=60.0, target_concurrency=2.0,
                             min_units=1, max_units=4,
                             scale_down_cooldown=3))).attach(
        gw.backend, spec=slice_spec(pkg), provision_delay_s=20.0)
    plane.start()
    gw.map("serve-sim", [b"\0"] * 150, at=0.0, spacing_s=0.2)
    gw.drain(extra_time_s=2000.0)
    gw.backend.cluster.clock.run(until=gw.backend.cluster.clock.now() + 600.0)
    plane.stop()
    assert gw.metrics.r_success() == 150
    assert plane.last_snapshot.capacity == 1
    assert any(d[1] == "scale-in" for d in plane.scaler.decisions)
    return [sim_record(gw, plane), list(plane.hooks.fleet.events)]


def alive(eb):
    return len([t for t in eb._threads.values() if t.is_alive()])


def set_n_workers_up_and_down(pkg, make):
    eb = make(pkg, n_workers=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(
        runtime_id="fast",
        profiles={pkg.R.HOST_ACC: pkg.R.SimProfile(elat_median_s=0.01)},
        fn=lambda d, c: {"ok": True}))
    gw.invoke("fast").result(extra_time_s=10.0)     # start the workers
    eb.set_n_workers(3)
    gw.gather([gw.invoke("fast") for _ in range(6)])
    up = [eb.capacity_hooks().capacity(), alive(eb), eb.n_workers]
    eb.set_n_workers(1)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and alive(eb) > 1:
        time.sleep(0.02)
    down = [eb.capacity_hooks().capacity(), alive(eb)]
    last = gw.invoke("fast").result(extra_time_s=10.0)
    assert up == [3, 3, 3] and down == [1, 1] and last == {"ok": True}
    return [up, down, last, len(gw.metrics.completed)]


# ------------------------------------------------------------ warm pool
def min_warm_sim(pkg):
    gw = sim_gateway(pkg)
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        tick_interval_s=1.0,
        warm=pkg.CP.WarmPolicy(min_warm={"serve-sim": 1}))).attach(
        gw.backend, spec=slice_spec(pkg))
    plane.start()
    futs = gw.map("serve-sim", [b"\0"] * 10, at=10.0, spacing_s=2.0)
    gw.drain(extra_time_s=600.0)
    plane.stop()
    invs = [f.invocation for f in futs]
    assert all(i.success for i in invs)
    assert sum(i.cold_start for i in invs) == 0 and invs[0].prewarmed
    assert gw.summary()["prewarmed"] == 1
    return sim_record(gw, plane)


def min_warm_engine_first_invoke(pkg, make):
    eb = make(pkg, n_workers=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(engine_runtime(pkg, setup_s=0.3))
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        tick_interval_s=0.05,
        warm=pkg.CP.WarmPolicy(min_warm={"model": 1}))).attach(eb)
    make.planes.append(plane)
    plane.start()
    deadline = time.monotonic() + 10.0
    while eb.n_prewarms == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    fut = gw.invoke("model")
    out = fut.result(extra_time_s=10.0)
    plane.stop()
    inv = fut.invocation
    # measurably faster than the 0.3 s setup an un-prewarmed first invoke
    # pays (generous margin for a loaded machine)
    assert not inv.cold_start and inv.prewarmed and inv.rlat < 0.15
    return [out, inv.cold_start, inv.prewarmed, eb.n_prewarms,
            (eb.n_cold_starts, eb.n_warm_starts),
            sorted(set(kinds(plane.warmpool.actions)))]


def keep_alive_ttl_engine(pkg, make):
    eb = make(pkg, n_workers=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(engine_runtime(pkg, rid="shortlived", setup_s=0.0))
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        tick_interval_s=0.05,
        warm=pkg.CP.WarmPolicy(keep_alive_s={"shortlived": 0.2},
                               default_keep_alive_s=60.0))).attach(eb)
    make.planes.append(plane)
    gw.invoke("shortlived").result(extra_time_s=10.0)
    before = eb.warm_keys()
    plane.start()
    deadline = time.monotonic() + 5.0
    while eb.warm_keys() and time.monotonic() < deadline:
        time.sleep(0.02)
    plane.stop()
    after = eb.warm_keys()
    f = gw.invoke("shortlived")
    out = f.result(extra_time_s=10.0)
    assert before == ["shortlived|"] and after == []
    assert kinds(plane.warmpool.actions) == ["ttl-evict"]
    assert f.invocation.cold_start
    return [before, after, kinds(plane.warmpool.actions), out,
            f.invocation.cold_start, (eb.n_cold_starts, eb.n_warm_starts)]


def runtime_hints_feed_defaults(pkg, make):
    eb = make(pkg, n_workers=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    rdef = engine_runtime(pkg, rid="hinted", setup_s=0.0)
    rdef.min_warm = 1
    gw.register(rdef)
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        tick_interval_s=0.05, warm=pkg.CP.WarmPolicy())).attach(eb)
    plane.tick()
    seen = [eb.warm_keys(), sorted(eb._pinned), eb.n_prewarms,
            kinds(plane.warmpool.actions)]
    plane.detach()
    assert seen[:2] == [["hinted|"], ["hinted|"]]
    return seen


# ------------------------------------------------------------ admission
def two_tenant_quota_sim(pkg):
    gw = sim_gateway(pkg)
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        admission=pkg.CP.AdmissionPolicy(
            tenant_quotas={"free": (1.0, 2.0)}))).attach(
        gw.backend, spec=slice_spec(pkg))
    plane.start()
    free = gw.map("serve-sim", [b"\0"] * 40, at=0.0, spacing_s=0.5,
                  tenant="free")
    paid = gw.map("serve-sim", [b"\0"] * 40, at=0.0, spacing_s=0.5,
                  tenant="paid")
    gw.drain(extra_time_s=2000.0)
    plane.stop()
    shed = [f for f in free if f.rejected()]
    assert shed and all(f.invocation.success for f in paid)
    assert raised(shed[0].result) == "InvocationRejected"
    assert "tenant-quota" in shed[0].invocation.error
    assert all(f.poll() for f in shed)
    per = gw.metrics.per_tenant()
    assert per["paid"]["r_success"] == 40 and per["paid"]["rejected"] == 0
    assert per["free"]["rejected"] == len(shed)
    return [sim_record(gw, plane), per]


def two_tenant_quota_engine(pkg, make):
    eb = make(pkg, n_workers=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(engine_runtime(pkg, rid="m", setup_s=0.0))
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        admission=pkg.CP.AdmissionPolicy(
            tenant_quotas={"free": (0.0, 2.0)}))).attach(eb)
    make.planes.append(plane)
    free = [gw.invoke("m", tenant="free") for _ in range(4)]
    paid = [gw.invoke("m", tenant="paid") for _ in range(3)]
    gw.drain()
    flags = [f.rejected() for f in free]
    assert flags == [False, False, True, True]
    assert all(f.invocation.success for f in paid)
    return [flags, [f.invocation.success for f in paid], eb.n_rejected,
            [f.invocation.error for f in free],
            [s[1:] for s in plane.admission.sheds]]


def fair_share(pkg):
    gw = sim_gateway(pkg)
    gw.register(pkg.R.RuntimeDef(runtime_id="light",
                                 profiles=sim_profile(pkg)))
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        admission=pkg.CP.AdmissionPolicy(fair_share_backlog=10))).attach(
        gw.backend, spec=slice_spec(pkg))
    plane.start()
    heavy = gw.map("serve-sim", [b"\0"] * 100, at=0.0, spacing_s=0.2)
    light = gw.map("light", [b"\0"] * 10, at=0.1, spacing_s=2.0)
    gw.drain(extra_time_s=2000.0)
    plane.stop()
    assert sum(1 for f in heavy if f.rejected()) > 0
    assert not any(f.rejected() for f in light)
    assert "fair-share" in next(f for f in heavy
                                if f.rejected()).invocation.error
    return sim_record(gw, plane)


# ------------------------------------------------------------ telemetry
def telemetry_windows(pkg):
    gw = sim_gateway(pkg)
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        tick_interval_s=5.0)).attach(gw.backend, spec=slice_spec(pkg))
    plane.start()
    gw.map("serve-sim", [b"\0"] * 60, at=0.0, spacing_s=0.5)
    gw.drain(extra_time_s=600.0)
    plane.stop()
    loaded = [s for s in plane.telemetry.history
              if "serve-sim" in s.per_runtime and
              s.per_runtime["serve-sim"].n_completed > 0]
    stats = loaded[-1].per_runtime["serve-sim"]
    assert stats.rlat_p50 <= stats.rlat_p99
    assert stats.elat_p50 == pytest.approx(0.8, rel=0.5)
    mid = [s.per_runtime["serve-sim"] for s in plane.telemetry.history
           if 10 <= s.t <= 25 and "serve-sim" in s.per_runtime]
    assert any(abs(r.arrival_rate - 2.0) < 0.5 for r in mid)
    assert any(r.ewma_rate > 0 for r in mid)
    return sim_record(gw, plane)


def same_config_both_backends(pkg, make):
    cfg = pkg.CP.ControlPlaneConfig(
        tick_interval_s=0.2,
        slo=pkg.CP.SLOPolicy(slo_rlat_p99_s=30.0, target_concurrency=4.0,
                             max_units=2),
        warm=pkg.CP.WarmPolicy(default_keep_alive_s=120.0),
        admission=pkg.CP.AdmissionPolicy(
            tenant_quotas={"capped": (0.0, 1.0)}))
    gw_sim = sim_gateway(pkg)
    p_sim = pkg.CP.ControlPlane(cfg).attach(gw_sim.backend,
                                            spec=slice_spec(pkg))
    p_sim.start()
    f1 = gw_sim.invoke("serve-sim", b"\0", tenant="capped", at=0.0)
    f2 = gw_sim.invoke("serve-sim", b"\0", tenant="capped", at=0.1)
    gw_sim.drain(extra_time_s=600.0)
    p_sim.stop()

    eb = make(pkg, n_workers=1, batch_wait_s=0.0)
    gw_eng = pkg.G.Gateway(eb)
    gw_eng.register(engine_runtime(pkg, rid="m", setup_s=0.0))
    p_eng = pkg.CP.ControlPlane(cfg).attach(eb)
    make.planes.append(p_eng)
    p_eng.start()
    g1 = gw_eng.invoke("m", tenant="capped")
    g2 = gw_eng.invoke("m", tenant="capped")
    gw_eng.drain()
    p_eng.detach()
    assert f1.invocation.success and f2.rejected()
    assert g1.invocation.success and g2.rejected()
    return [sim_record(gw_sim, p_sim), g1.invocation.success, g2.rejected(),
            g2.invocation.error]


def attaches_once_and_summary(pkg):
    gw = sim_gateway(pkg)
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig()).attach(
        gw.backend, spec=slice_spec(pkg))
    err = raised(lambda: plane.attach(gw.backend))
    hooked = gw.backend.controller is plane
    plane.tick()
    s = plane.summary()
    plane.detach()
    assert err == "RuntimeError" and hooked and s["ticks"] == 1
    assert s["shed"] == 0 and gw.backend.controller is None
    return [err, hooked, s]


# --------------------------------------- worker retargeting under faults
def respawn_before_monitor_tick(pkg, make):
    """``set_n_workers`` may respawn a crashed worker's index before the
    monitor's next tick; the spawn path itself recovers the dead
    thread's in-flight batch (``tests/test_faults.py``)."""
    def fn(data, cfg):
        time.sleep(0.03)
        return {"ok": True, "i": data["i"]}
    eb = make(pkg, n_workers=1, max_batch=2, batch_wait_s=0.005,
              monitor_interval_s=60.0)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(
        runtime_id="slow",
        profiles={pkg.R.HOST_ACC: pkg.R.SimProfile(elat_median_s=0.03)},
        fn=fn, max_attempts=3))
    futs = gw.map("slow", [{"i": i} for i in range(4)])
    t0 = time.monotonic()
    while not eb._inflight_batches and time.monotonic() - t0 < 10.0:
        time.sleep(0.002)
    eb.crash_worker(next(iter(eb._inflight_batches)))
    t0 = time.monotonic()
    while any(t.is_alive() for t in eb._threads.values()) and \
            time.monotonic() - t0 < 10.0:
        time.sleep(0.002)
    eb.set_n_workers(1)     # the respawn path, ahead of the monitor
    gw.drain(extra_time_s=30.0)
    m = eb.metrics
    assert len(m.completed) == 4 and m.r_success() == 4
    return [sorted(f.result()["i"] for f in futs), eb.n_worker_crashes]


SIM = [queue_pressure_vs_slo, scales_out_in_one_decision,
       scale_down_to_min_units, min_warm_sim, two_tenant_quota_sim,
       fair_share, telemetry_windows, attaches_once_and_summary]
ENGINE = [set_n_workers_up_and_down, min_warm_engine_first_invoke,
          keep_alive_ttl_engine, runtime_hints_feed_defaults,
          two_tenant_quota_engine, same_config_both_backends,
          respawn_before_monitor_tick]


@pytest.mark.parametrize("scenario", SIM, ids=lambda f: f.__name__)
def test_sim_plane_scenario_agrees_with_jax(scenario):
    both(scenario)


@pytest.mark.parametrize("scenario", ENGINE, ids=lambda f: f.__name__)
def test_engine_plane_scenario_agrees_with_jax(scenario, make):
    both(scenario, make)


# ----------------------------------------------------- the port's cases
def toy_runtime(pkg):
    def setup():
        return {"calls": 0}

    def fn(data, config):
        config["handle"]["calls"] += 1
        return {"calls": config["handle"]["calls"]}

    return pkg.R.RuntimeDef(
        runtime_id="toy",
        profiles={pkg.R.HOST_ACC: pkg.R.SimProfile(elat_median_s=0.01)},
        fn=fn, setup=setup)


def pinned_key_survives_lru(pkg, make):
    """With ``max_warm=1``, a pinned key stays resident while two other
    keys cold-start past it; unpinned, the LRU takes it."""
    eb = make(pkg, n_workers=1, max_warm=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(toy_runtime(pkg))
    pinned = pkg.E.runtime_key_for("toy", {"model": "p"})
    gw.invoke("toy", config={"model": "p"}).result(extra_time_s=10.0)
    eb.pin_warm({pinned})
    for m in ("a", "b"):
        gw.invoke("toy", config={"model": m}).result(extra_time_s=10.0)
    held = eb.warm_keys()
    again = gw.invoke("toy", config={"model": "p"})
    calls = again.result(extra_time_s=10.0)["calls"]
    eb.pin_warm(set())
    gw.invoke("toy", config={"model": "c"}).result(extra_time_s=10.0)
    released = eb.warm_keys()
    assert held == [pinned] and not again.invocation.cold_start
    assert calls == 2 and released == [pkg.E.runtime_key_for(
        "toy", {"model": "c"})]
    return [held, calls, released, eb.n_cold_starts, eb.n_warm_starts]


def test_pinned_warm_key_survives_lru_pressure(make):
    both(pinned_key_survives_lru, make)


def test_admission_under_a_ticking_plane_does_not_deadlock():
    """200 submits from 8 threads through ``controller.admit`` while the
    plane ticks every 10 ms (its tick takes the plane's lock and then the
    dispatcher's through the hooks; admission takes the plane's lock
    outside the dispatcher's). Every thread finishes and every event
    settles within the time limit. A deadlocked backend is left to its
    daemon threads: shutting it down would wait on the held lock."""
    pkg = PKGS["torch"]
    eb = pkg.G.EngineBackend(device="cpu", n_workers=2, max_batch=4,
                             batch_wait_s=0.001, max_queue=1000)
    gw = pkg.G.Gateway(eb)
    gw.register(engine_runtime(pkg, rid="m", setup_s=0.0))
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        tick_interval_s=0.01,
        slo=pkg.CP.SLOPolicy(slo_rlat_p99_s=0.001, max_units=4),
        warm=pkg.CP.WarmPolicy(min_warm={"m": 1},
                               default_keep_alive_s=0.0),
        admission=pkg.CP.AdmissionPolicy(
            tenant_quotas={"free": (100.0, 10.0)},
            fair_share_backlog=50))).attach(eb)
    plane.start()
    futs, lock = [], threading.Lock()

    def submit(t):
        for i in range(25):
            f = gw.invoke("m", {"t": t, "i": i},
                          tenant="free" if t % 2 else "paid")
            with lock:
                futs.append(f)
            time.sleep(0.002)       # spread the submits over several ticks
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit, args=(t,), daemon=True)
                   for t in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60.0
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
    finally:
        sys.setswitchinterval(interval)
    if any(t.is_alive() for t in threads):
        plane.stop()
        pytest.fail("submit deadlocked against the ticking plane")
    try:
        gw.drain(extra_time_s=60.0)
        plane.stop()
        assert len(futs) == 200 and gw.backlog() == 0
        assert all(f.invocation.r_end is not None for f in futs)
        assert all(f.invocation.success or f.rejected() for f in futs)
        assert plane.n_ticks > 1
        assert sum(f.rejected() for f in futs) == eb.n_rejected
    finally:
        plane.detach()
        eb.shutdown()


def test_evicted_engine_handle_has_no_holder_left(make):
    """``evict_warm`` drops the last reference to the handle: no worker
    frame, result, tracer or closure keeps it (the test of this on the
    card is ``memory_allocated()``; here the garbage collector is off,
    so only reference counts can free it)."""
    pkg = PKGS["torch"]

    class Handle:
        pass
    eb = make(pkg, n_workers=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(
        runtime_id="h", profiles={pkg.R.HOST_ACC: pkg.R.SimProfile(0.01)},
        fn=lambda d, c: {"ok": True}, setup=Handle))
    plane = pkg.CP.ControlPlane(pkg.CP.ControlPlaneConfig(
        warm=pkg.CP.WarmPolicy(min_warm={"h": 1}))).attach(eb)
    make.planes.append(plane)
    gc.disable()
    try:
        plane.tick()                        # prewarm on this thread
        assert gw.invoke("h").result(extra_time_s=10.0) == {"ok": True}
        ref = weakref.ref(eb.handle("h|"))
        plane.detach()
        assert eb.evict_warm("h|") and eb.warm_keys() == []
        assert ref() is None, gc.get_referrers(ref())
    finally:
        gc.enable()


def test_prewarm_enters_worker_zeros_card_around_setup(monkeypatch):
    """The plane prewarms on its tick thread, whose current CUDA device is
    its own (the current device is per thread): ``prewarm`` must enter
    worker 0's card around ``setup()``, as a worker's cold start does, or
    the engine lands on the tick thread's card. Here the backend is given
    two cards and ``torch.cuda.device`` records which card is current, so
    the CPU sees the card ``setup()`` ran under."""
    current = threading.local()

    class Card:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            self.prev = getattr(current, "dev", None)
            current.dev = self.dev

        def __exit__(self, *exc):
            current.dev = self.prev

    monkeypatch.setattr(torch.cuda, "device", Card)
    seen = []

    def setup():
        seen.append(getattr(current, "dev", None))
        return object()
    eb = TG.EngineBackend(n_workers=1, batch_wait_s=0.0, device="cpu")
    eb._devices = [torch.device("cuda", 2), torch.device("cuda", 3)]
    try:
        TG.Gateway(eb).register(TR.RuntimeDef(
            runtime_id="h", profiles={TR.HOST_ACC: TR.SimProfile(0.01)},
            fn=lambda d, c: {"ok": True}, setup=setup))
        plane = TCP.ControlPlane(TCP.ControlPlaneConfig(
            warm=TCP.WarmPolicy(min_warm={"h": 1}))).attach(eb)
        after = []

        def tick_on_another_card():
            with Card(torch.device("cuda", 3)):
                plane.tick()
                after.append(current.dev)
        t = threading.Thread(target=tick_on_another_card)
        t.start()
        t.join(timeout=60.0)
        plane.detach()
        assert not t.is_alive() and eb.n_prewarms == 1
        assert seen == [torch.device("cuda", 2)]
        assert after == [torch.device("cuda", 3)]
    finally:
        eb.shutdown()


def test_evicted_serve_engine_and_sim_instance_are_freed():
    """The same for the serve runtime's ``ServingEngine`` (granite
    ``.reduced()`` on the CPU): evicted from ``EngineBackend``'s warm
    pool and from a sim node's real-execution handles, nothing holds it."""
    from repro_torch.configs import get_config
    from repro_torch.serve.api import make_serve_runtime
    cfg = get_config("granite-3-2b").reduced()
    rdef = make_serve_runtime(cfg, max_slots=2, max_len=64, device="cpu")
    event = {"prompts": [[5, 9, 14, 3, 22]]}
    eb = TG.EngineBackend(n_workers=1, batch_wait_s=0.0, device="cpu")
    cl = TC.Cluster(seed=0)
    cl.add_node("n0", [TA.AcceleratorSpec(type=TR.HOST_ACC, slots=1)])
    sim = TG.SimBackend(cl)
    gc.disable()
    try:
        for backend in (eb, sim):
            gw = TG.Gateway(backend)
            gw.register(rdef)
            fut = gw.invoke(rdef.runtime_id, event,
                            config={"max_new_tokens": 2})
            assert len(fut.result()["outputs"][0]) == 2
        key = fut.invocation.runtime_key
        refs = [weakref.ref(eb.handle(key)),
                weakref.ref(cl.nodes[0]._real_handles[key])]
        assert eb.evict_warm(key)
        assert sim.capacity_hooks().evict(key)
        assert [r() is None for r in refs] == [True, True]
    finally:
        gc.enable()
        eb.shutdown()


FORBIDDEN = [["--backend", "engine", "--pods", "2"],
             ["--backend", "engine", "--scheduler", "fifo"],
             ["--backend", "sim", "--max-batch", "2"],
             ["--backend", "sim", "--batch-wait-ms", "1"],
             ["--backend", "sim", "--objective", "cost", "--scheduler",
              "fifo"],
             ["--prefill-chunk", "16", "--page-size", "0"],
             ["--backend", "sim", "--tenant-quota", "free"],
             ["--cluster", "0"],
             ["--cluster", "1", "--pods", "2"],
             ["--cluster", "1", "--scheduler", "fifo"],
             ["--cluster", "1", "--batch-wait-ms", "3"]]


@pytest.mark.parametrize("argv", FORBIDDEN, ids=lambda a: " ".join(a[-2:]))
def test_launcher_flag_errors_match_the_reference(argv, capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    seen = {}
    for name, mod in (("jax", jserve), ("torch", tserve)):
        with pytest.raises(SystemExit) as ei:
            mod.main(argv)
        err = capsys.readouterr().err.strip().splitlines()[-1]
        seen[name] = (ei.value.code, err.split(" error: ", 1)[1])
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == 2


def test_launcher_sim_backend_settles_every_event(capsys):
    from repro_torch.launch import serve as tserve
    rc = tserve.main(["--backend", "sim", "--reduced", "--device", "cpu",
                      "--events", "3", "--min-warm", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "3/3 events served" in out, out
    assert "pod0/acc0(cpu)" in out and "controlplane:" in out


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine is placed on the card")
    return torch.device("cuda")


def _granite_cut(layers):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("granite-3-2b"), n_layers=layers)


@pytest.mark.gpu
def test_prewarm_off_a_worker_builds_the_engine_on_the_workers_card(cuda):
    """The tick thread's current device is the last card, worker 0's is
    card 0: the prewarm enters worker 0's card before ``setup()``. Only
    with two cards or more can this case tell the two apart; on one card
    both are card 0, and it checks that the engine lands there and serves
    its first event prewarmed. The CPU case
    ``test_prewarm_enters_worker_zeros_card_around_setup`` pins the
    device entry itself."""
    from repro_torch.serve.api import make_serve_runtime
    eb = TG.EngineBackend(batch_wait_s=0.0)
    try:
        gw = TG.Gateway(eb)
        rid = gw.register(make_serve_runtime(_granite_cut(2), max_slots=2,
                                             max_len=128))
        run = {"max_new_tokens": 2}        # warm identity: runtime + config
        plane = TCP.ControlPlane(TCP.ControlPlaneConfig(
            warm=TCP.WarmPolicy(min_warm={rid: 1},
                                prewarm_config={rid: run}))).attach(eb)

        def tick_elsewhere():
            torch.cuda.set_device(torch.cuda.device_count() - 1)
            plane.tick()
        t = threading.Thread(target=tick_elsewhere)
        t.start()
        t.join(timeout=600.0)
        assert not t.is_alive() and eb.n_prewarms == 1
        from repro_torch.models.param import iter_leaves
        engine = eb.handle(TE.runtime_key_for(rid, run))
        devices = {t.device for _, t in iter_leaves(engine.params)}
        assert engine.device == torch.device("cuda", 0)
        assert devices == {torch.device("cuda", 0)}
        fut = gw.invoke(rid, {"prompts": [[5, 9, 14]]}, config=run)
        assert len(fut.result(extra_time_s=600.0)["outputs"][0]) == 2
        assert fut.invocation.prewarmed and not fut.invocation.cold_start
        plane.detach()
    finally:
        eb.shutdown()


@pytest.mark.gpu
def test_evict_warm_gives_the_engines_memory_back(cuda):
    from repro_torch.serve.api import make_serve_runtime
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eb = TG.EngineBackend(batch_wait_s=0.0)
    try:
        gw = TG.Gateway(eb)
        rid = gw.register(make_serve_runtime(_granite_cut(4), max_slots=4,
                                             max_len=512))
        fut = gw.invoke(rid, {"prompts": [[5, 9, 14]]},
                        config={"max_new_tokens": 2})
        fut.result(extra_time_s=600.0)
        torch.cuda.synchronize()
        warm = torch.cuda.memory_allocated()
        assert eb.evict_warm(fut.invocation.runtime_key)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        eb.shutdown()
    assert warm - before > 256 << 20, (before, warm)
    assert abs(after - before) <= 64 << 20, (before, warm, after)
