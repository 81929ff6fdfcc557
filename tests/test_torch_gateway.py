"""The port's gateway (``repro_torch.gateway``: ``Gateway`` over
``EngineBackend``) against the JAX package's (``repro.gateway``).

Every ``EngineBackend`` scenario of ``tests/test_gateway.py`` and
``tests/test_engine_concurrency.py`` runs through both packages (the
port's backend with ``device="cpu"``, its host workers): each scenario
keeps the reference suite's assertions and returns what it observed
(outcome envelopes without the process-global invocation ids, cold and
warm counts, batch sizes, the errors raised), and the two packages must
observe the same. Then the slice: granite-3-2b ``.reduced()`` served
through both gateways on the same weights, greedy tokens exact, with the
same envelopes, counts and span-name tree under each ``invocation`` root,
the tracer on in both; and a two-step chained serve workflow.

These tests start threads, never processes, and shut every backend down.
"""
import dataclasses
import threading
import time
import types

import jax
import pytest
import torch

import repro.core.accelerator as JA
import repro.core.runtime as JR
import repro.gateway as JG
import repro.obs as JO
import repro_torch.core.accelerator as TA
import repro_torch.core.runtime as TR
import repro_torch.gateway as TG
import repro_torch.obs as TO
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.serve.api import make_serve_runtime as jmake_serve_runtime
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.serve.api import make_serve_runtime as tmake_serve_runtime
from repro_torch.serve.engine import ServingEngine

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

WAIT = 0.25          # generous batch window so tests are deterministic

PKGS = {
    "jax": types.SimpleNamespace(G=JG, R=JR, A=JA, obs=JO, device={}),
    "torch": types.SimpleNamespace(G=TG, R=TR, A=TA, obs=TO,
                                   device={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _pristine_tracers():
    for pkg in PKGS.values():
        pkg.obs.reset()
    yield
    for pkg in PKGS.values():
        pkg.obs.reset()


@pytest.fixture
def make():
    """make(pkg, **kw) -> that package's EngineBackend; every backend is
    shut down when the test ends."""
    made = []

    def _make(pkg, **kw):
        eb = pkg.G.EngineBackend(**pkg.device, **kw)
        made.append(eb)
        return eb
    yield _make
    for eb in made:
        eb.shutdown()


def envelope(gw, inv):
    """The stored outcome envelope, without the process-global id."""
    rec = gw.backend.store.get_outcome(inv.result_ref)
    return {k: rec[k] for k in ("ok", "value", "error", "attempt")}


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__
    return None


def prof(pkg):
    return {pkg.R.HOST_ACC: pkg.R.SimProfile(elat_median_s=0.01)}


def toy_real_runtime(pkg, rid="toy", fail=False):
    def setup():
        return {"calls": 0}

    def fn(data, config):
        if fail:
            raise RuntimeError("boom")
        handle = config["handle"]
        handle["calls"] += 1
        return {"echo": data, "calls": handle["calls"]}

    return pkg.R.RuntimeDef(runtime_id=rid, profiles=prof(pkg), fn=fn,
                            setup=setup)


def counting_batch_runtime(pkg, rid="batchy", max_batch=4, buckets=None):
    calls = []

    def setup():
        return {"ready": True}

    def batch_fn(datas, config):
        assert config["handle"]["ready"]
        calls.append((len(datas), config["n_real"]))
        return [{"x": d, "batch": len(datas)} for d in datas]

    return pkg.R.RuntimeDef(runtime_id=rid, profiles=prof(pkg),
                            batch_fn=batch_fn, max_batch=max_batch,
                            batch_buckets=buckets, setup=setup), calls


def blocking_runtime(pkg, rid):
    started, release = threading.Event(), threading.Event()

    def fn(data, config):
        started.set()
        assert release.wait(timeout=10.0), "test never released the runtime"
        return {"ok": True}

    return pkg.R.RuntimeDef(runtime_id=rid, profiles=prof(pkg), fn=fn), \
        started, release


# ------------------------------------------------ tests/test_gateway.py
def cold_then_warm(pkg, make):
    eb = make(pkg)
    gw = pkg.G.Gateway(eb)
    gw.register(toy_real_runtime(pkg))
    f1 = gw.invoke("toy", {"x": 1})
    f2 = gw.invoke("toy", {"x": 2})
    r1, r2 = gw.gather([f1, f2])
    assert (eb.n_cold_starts, eb.n_warm_starts) == (1, 1)
    assert f1.invocation.cold_start and not f2.invocation.cold_start
    assert (r1["calls"], r2["calls"]) == (1, 2)
    return [(eb.n_cold_starts, eb.n_warm_starts), r1, r2,
            envelope(gw, f1.invocation), envelope(gw, f2.invocation)]


def distinct_configs(pkg, make):
    eb = make(pkg)
    gw = pkg.G.Gateway(eb)
    gw.register(toy_real_runtime(pkg))
    gw.invoke("toy", {"x": 1}, config={"model": "a"})
    gw.invoke("toy", {"x": 2}, config={"model": "b"})
    gw.drain()
    assert (eb.n_cold_starts, eb.n_warm_starts) == (2, 0)
    return [(eb.n_cold_starts, eb.n_warm_starts), eb.warm_keys()]


def lru_eviction(pkg, make):
    eb = make(pkg, max_warm=2)
    gw = pkg.G.Gateway(eb)
    gw.register(toy_real_runtime(pkg))
    for m in ("a", "b", "c"):
        gw.invoke("toy", {}, config={"model": m})
    gw.drain()
    seen = [eb.n_cold_starts, eb.warm_keys()]
    assert len(eb.warm_keys()) == 2          # oldest ("a") evicted
    gw.invoke("toy", {}, config={"model": "a"})
    gw.drain()
    assert eb.n_cold_starts == 4             # "a" had to cold-start again
    return seen + [eb.n_cold_starts, eb.warm_keys()]


def runtime_failure(pkg, make):
    gw = pkg.G.Gateway(make(pkg))
    gw.register(toy_real_runtime(pkg, rid="bad", fail=True))
    fut = gw.invoke("bad", {"x": 1})
    gw.drain()
    inv = fut.invocation
    assert inv.r_end is not None and not inv.success and "boom" in inv.error
    err = raised(fut.result)
    assert err == "InvocationError" and fut.poll()
    return [inv.error, err, envelope(gw, inv)]


def cold_start_failure(pkg, make):
    def bad_setup():
        raise MemoryError("weights do not fit")

    eb = make(pkg)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(runtime_id="oom", profiles=prof(pkg),
                                 fn=lambda d, c: {"ok": True},
                                 setup=bad_setup))
    gw.register(toy_real_runtime(pkg))
    f_bad = gw.invoke("oom")
    f_ok = gw.invoke("toy", {"x": 1})
    gw.drain()
    assert f_bad.done() and not f_bad.invocation.success
    assert "cold-start failed" in f_bad.invocation.error
    assert f_ok.invocation.success      # queue kept draining past the crash
    return [f_bad.invocation.error, raised(f_bad.result),
            envelope(gw, f_bad.invocation), envelope(gw, f_ok.invocation),
            eb.warm_keys()]


def setupless(pkg, make):
    eb = make(pkg)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(runtime_id="stateless", profiles=prof(pkg),
                                 fn=lambda d, c: {"ok": True}))
    gw.invoke("stateless")
    gw.invoke("stateless")
    gw.drain()
    assert (eb.n_cold_starts, eb.n_warm_starts) == (2, 0)
    return [(eb.n_cold_starts, eb.n_warm_starts), eb.warm_keys()]


def profile_only_rejected(pkg, make):
    gw = pkg.G.Gateway(make(pkg))
    err = raised(lambda: gw.register(pkg.R.RuntimeDef(
        runtime_id="sim-only", profiles=prof(pkg))))
    assert err == "ValueError"
    return [err, gw.runtimes()]


def monotone_timestamps(pkg, make):
    def slow_fn(data, config):
        time.sleep(0.01)
        return {"ok": True}

    gw = pkg.G.Gateway(make(pkg))
    gw.register(pkg.R.RuntimeDef(runtime_id="slow", profiles=prof(pkg),
                                 fn=slow_fn))
    fut = gw.invoke("slow")
    out = fut.result()
    inv = fut.invocation
    assert inv.check_monotone() and inv.elat >= 0.01
    return [out, inv.check_monotone(), envelope(gw, inv)]


def priced_accelerator(pkg, make):
    """The collector prices the measured ELat of every invocation with
    the registered spec of its accelerator type."""
    gw = pkg.G.Gateway(make(pkg))
    spec = pkg.A.AcceleratorSpec(type=pkg.R.HOST_ACC, cost_per_hour=36.0,
                                 active_watts=300.0)
    gw.metrics.register_accelerator(spec)
    gw.register(toy_real_runtime(pkg))
    gw.gather([gw.invoke("toy", {"x": i}) for i in range(3)])
    row = gw.metrics.accelerator_usage()[pkg.R.HOST_ACC]
    busy = sum(inv.elat for inv in gw.metrics.completed)
    assert row["busy_s"] == pytest.approx(busy)
    assert row["cost_dollars"] == pytest.approx(spec.invocation_dollars(busy))
    assert row["energy_joules"] == pytest.approx(spec.invocation_joules(busy))
    return [row["n_invocations"], sorted(row), spec.invocation_dollars(2.0),
            spec.invocation_joules(2.0)]


# ------------------------------------ tests/test_hetero_placement.py
def engine_backlog_by_type_reports_registered_spec(pkg, make):
    """The twin of test_engine_backlog_by_type_reports_registered_spec: a
    spec given to the backend becomes its reported type and arms the
    metrics' pricing."""
    eb = make(pkg, n_workers=1, accelerator_spec=pkg.A.AcceleratorSpec(
        type="host-priced", slots=1, cost_per_hour=0.25, active_watts=65.0))
    bt = eb.backlog_by_type()
    assert set(bt) == {"host-priced"}
    assert bt["host-priced"]["free"] >= 1 and bt["host-priced"]["queued"] == 0
    assert eb.metrics._acc_pricing["host-priced"].cost_per_hour == 0.25
    return [sorted(bt), sorted(bt["host-priced"]), eb.accelerator]


def accelerator_spec_prices_invocations(pkg, make):
    """Invocations served under a spec run on its type and are priced from
    their ELat: active_watts x ELat joules each; without a spec the named
    ``accelerator`` is reported."""
    spec = pkg.A.AcceleratorSpec(type="card-x", cost_per_hour=36.0, active_watts=700.0)
    gw = pkg.G.Gateway(make(pkg, n_workers=1, accelerator_spec=spec))
    gw.register(toy_real_runtime(pkg))
    futs = [gw.invoke("toy", {"x": i}) for i in range(2)]
    gw.gather(futs)
    row = gw.metrics.accelerator_usage()["card-x"]
    busy = sum(f.invocation.elat for f in futs)
    assert row["energy_joules"] == pytest.approx(700.0 * busy)
    assert row["cost_dollars"] == pytest.approx(spec.invocation_dollars(busy))
    named = make(pkg, n_workers=1, accelerator="card-y")
    return [[f.invocation.accelerator for f in futs], row["n_invocations"],
            sorted(named.backlog_by_type())]


# -------------------------------------- tests/test_engine_concurrency.py
def micro_batches(pkg, make):
    rdef, calls = counting_batch_runtime(pkg, max_batch=4)
    eb = make(pkg, n_workers=1, max_batch=4, batch_wait_s=WAIT)
    gw = pkg.G.Gateway(eb)
    gw.register(rdef)
    futs = gw.map("batchy", [b"a", b"b", b"c", b"d", b"e", b"f", b"g", b"h"])
    results = gw.gather(futs)
    assert len(results) == 8 and all(r["x"] for r in results)
    assert eb.n_batches <= 3 and sum(n for n, _ in calls) >= 8
    assert max(eb.batch_sizes) >= 2
    return [[r["x"] for r in results], sum(eb.batch_sizes)]


def max_batch_of_runtime(pkg, make):
    rdef, calls = counting_batch_runtime(pkg, max_batch=2)
    eb = make(pkg, n_workers=1, max_batch=8, batch_wait_s=WAIT)
    gw = pkg.G.Gateway(eb)
    gw.register(rdef)
    gw.map("batchy", [b"a", b"b", b"c", b"d"])
    gw.drain()
    assert all(n <= 2 for n, _ in calls)
    return [max(eb.batch_sizes) <= 2, sum(eb.batch_sizes)]


def pad_to_bucket(pkg, make):
    rdef, calls = counting_batch_runtime(pkg, max_batch=8,
                                         buckets=(1, 2, 4, 8))
    eb = make(pkg, n_workers=1, max_batch=8, batch_wait_s=WAIT)
    gw = pkg.G.Gateway(eb)
    gw.register(rdef)
    futs = gw.map("batchy", [b"a", b"b", b"c"])   # 3 real -> padded to 4
    results = gw.gather(futs)
    padded = [n for n, n_real in calls if n_real == 3]
    assert padded == [4] and [r["x"] for r in results] == [b"a", b"b", b"c"]
    return [padded, results, eb.batch_sizes,
            [envelope(gw, f.invocation) for f in futs]]


def incompatible_configs(pkg, make):
    rdef, calls = counting_batch_runtime(pkg, max_batch=8)
    eb = make(pkg, n_workers=1, max_batch=8, batch_wait_s=WAIT)
    gw = pkg.G.Gateway(eb)
    gw.register(rdef)
    for m in ("a", "b", "a", "b"):
        gw.invoke("batchy", b"x", config={"model": m})
    gw.drain()
    assert eb.n_batches >= 2 and all(n <= 2 for n, _ in calls)
    return [eb.n_batches >= 2, sorted(eb.warm_keys())]


def max_wait_deadline(pkg, make):
    rdef, calls = counting_batch_runtime(pkg, max_batch=8)
    eb = make(pkg, n_workers=1, max_batch=8, batch_wait_s=0.05)
    gw = pkg.G.Gateway(eb)
    gw.register(rdef)
    fut = gw.invoke("batchy", b"lonely")
    out = fut.result(extra_time_s=10.0)
    assert out["x"] == b"lonely" and calls[0][1] == 1
    return [out, calls, eb.batch_sizes]


def two_workers(pkg, make):
    ra, started_a, release_a = blocking_runtime(pkg, "ra")
    rb, started_b, release_b = blocking_runtime(pkg, "rb")
    eb = make(pkg, n_workers=2, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(ra)
    gw.register(rb)
    fa, fb = gw.invoke("ra"), gw.invoke("rb")
    assert started_a.wait(timeout=5.0) and started_b.wait(timeout=5.0)
    overlap = not fa.done() and not fb.done()
    release_a.set()
    release_b.set()
    out = gw.gather([fa, fb])
    nodes = {fa.invocation.node, fb.invocation.node}
    assert overlap and nodes == {"local/w0", "local/w1"}
    return [overlap, out, sorted(nodes)]


def per_key_serialised(pkg, make):
    rdef, started, release = blocking_runtime(pkg, "solo")
    eb = make(pkg, n_workers=2, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(rdef)
    f1, f2 = gw.invoke("solo"), gw.invoke("solo")
    assert started.wait(timeout=5.0)
    time.sleep(0.05)                  # give a second worker every chance
    waited = not f2.done()            # one warm instance => one at a time
    release.set()
    gw.gather([f1, f2])
    assert waited and f1.invocation.success and f2.invocation.success
    return [waited, f1.invocation.success, f2.invocation.success]


def per_event_wait(pkg, make):
    rdef, started, release = blocking_runtime(pkg, "slowkey")
    fast = pkg.R.RuntimeDef(runtime_id="fastkey", profiles=prof(pkg),
                            fn=lambda d, c: {"fast": True})
    eb = make(pkg, n_workers=2, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(rdef)
    gw.register(fast)
    f_slow, f_fast = gw.invoke("slowkey"), gw.invoke("fastkey")
    assert started.wait(timeout=5.0)
    out = f_fast.result(extra_time_s=10.0)
    seen = [out, f_slow.done(), gw.backlog()]
    release.set()
    gw.drain()
    assert seen == [{"fast": True}, False, 1]
    assert f_slow.invocation.success and gw.backlog() == 0
    return seen


def queue_shedding(pkg, make):
    rdef, started, release = blocking_runtime(pkg, "busy")
    eb = make(pkg, n_workers=1, max_queue=2, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(rdef)
    f1, f2 = gw.invoke("busy"), gw.invoke("busy")
    assert started.wait(timeout=5.0)
    f3 = gw.invoke("busy")                 # over budget -> shed
    assert f3.rejected() and f3.done() and not f3.invocation.success
    assert f3.poll() and "backpressure" in f3.invocation.error
    err = raised(f3.result)
    release.set()
    gw.drain()
    assert err == "InvocationRejected" and eb.n_rejected == 1
    assert f1.invocation.success and f2.invocation.success
    return [err, eb.n_rejected, f3.invocation.error,
            [envelope(gw, f.invocation) for f in (f1, f2, f3)]]


def batch_failure(pkg, make):
    def bad_batch(datas, config):
        raise RuntimeError("batch exploded")

    eb = make(pkg, n_workers=1, max_batch=4, batch_wait_s=WAIT)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(runtime_id="badbatch", profiles=prof(pkg),
                                 batch_fn=bad_batch, max_batch=4))
    futs = gw.map("badbatch", [b"a", b"b", b"c"])
    gw.drain()
    assert all(f.done() and not f.invocation.success for f in futs)
    assert all("batch exploded" in f.invocation.error for f in futs)
    assert all(f.invocation.check_monotone() for f in futs)
    return [[envelope(gw, f.invocation) for f in futs],
            [raised(f.result) for f in futs]]


def submit_after_shutdown(pkg, make):
    eb = make(pkg, n_workers=1)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(runtime_id="late", profiles=prof(pkg),
                                 fn=lambda d, c: {"ok": True}))
    first = gw.invoke("late").result(extra_time_s=10.0)
    eb.shutdown()
    fut = gw.invoke("late")                 # no worker will ever serve this
    assert fut.done() and fut.rejected()
    assert "shut down" in fut.invocation.error
    err = raised(fut.result)
    assert err == "InvocationRejected" and gw.backlog() == 0
    return [first, err, envelope(gw, fut.invocation), gw.backlog()]


def unserializable_result(pkg, make):
    eb = make(pkg, n_workers=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    gw.register(pkg.R.RuntimeDef(runtime_id="locky", profiles=prof(pkg),
                                 fn=lambda d, c: {"oops": threading.Lock()}))
    gw.register(pkg.R.RuntimeDef(runtime_id="fine", profiles=prof(pkg),
                                 fn=lambda d, c: {"ok": True}))
    f_bad, f_ok = gw.invoke("locky"), gw.invoke("fine")
    gw.drain(extra_time_s=10.0)
    assert f_bad.done() and not f_bad.invocation.success
    assert "persist failed" in f_bad.invocation.error
    assert f_ok.invocation.success and gw.backlog() == 0
    return [f_bad.invocation.error, envelope(gw, f_bad.invocation),
            envelope(gw, f_ok.invocation)]


def concurrent_settlement(pkg, make):
    rdef, _ = counting_batch_runtime(pkg, max_batch=4)
    eb = make(pkg, n_workers=2, max_batch=4, batch_wait_s=0.01)
    gw = pkg.G.Gateway(eb)
    gw.register(rdef)
    gw.register(pkg.R.RuntimeDef(runtime_id="other", profiles=prof(pkg),
                                 fn=lambda d, c: {"ok": True}))
    for i in range(10):
        gw.invoke("batchy" if i % 2 else "other", b"p")
    gw.drain()
    m = gw.metrics
    assert len(m.completed) == 10 and m.r_success() == 10
    assert all(i.check_monotone() for i in m.completed)
    return [len(m.completed), m.r_success(), sum(eb.batch_sizes)]


def worker_crash(pkg, make, max_attempts):
    """The worker dies holding the only event (armed before its first
    pick): the monitor closes the lost attempt as ``abandoned`` and
    redelivers it, or settles it as exhausted past ``max_attempts``."""
    eb = make(pkg, n_workers=1, max_batch=1, batch_wait_s=0.0)
    gw = pkg.G.Gateway(eb)
    pkg.obs.enable(clock=eb.now, metrics=gw.metrics)
    gw.register(pkg.R.RuntimeDef(runtime_id="slow", profiles=prof(pkg),
                                 fn=lambda d, c: {"i": d["i"]},
                                 max_attempts=max_attempts))
    eb.crash_worker(0)
    fut = gw.invoke("slow", {"i": 0})
    gw.drain(extra_time_s=60.0)
    inv = fut.invocation
    assert inv.r_end is not None and eb.n_worker_crashes == 1
    spans = sorted((s.name, s.status) for s in pkg.obs.TRACER.spans()
                   if s.name in ("invocation", "attempt"))
    return [raised(fut.result), envelope(gw, inv), inv.attempt,
            inv.retries_exhausted, eb.n_requeued, eb.n_retries_exhausted,
            spans]


def worker_crash_redelivered(pkg, make):
    seen = worker_crash(pkg, make, max_attempts=3)
    assert seen[0] is None and seen[2] == 1     # attempt 1 succeeded
    return seen


def worker_crash_exhausted(pkg, make):
    seen = worker_crash(pkg, make, max_attempts=1)
    assert seen[0] == "InvocationRetriesExhausted" and seen[3]
    return seen


SCENARIOS = [cold_then_warm, distinct_configs, lru_eviction, runtime_failure,
             cold_start_failure, setupless, profile_only_rejected,
             monotone_timestamps, priced_accelerator,
             engine_backlog_by_type_reports_registered_spec,
             accelerator_spec_prices_invocations, micro_batches, max_batch_of_runtime,
             pad_to_bucket, incompatible_configs, max_wait_deadline,
             two_workers, per_key_serialised, per_event_wait, queue_shedding,
             batch_failure, submit_after_shutdown, unserializable_result,
             concurrent_settlement, worker_crash_redelivered,
             worker_crash_exhausted]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_engine_backend_scenario_agrees_with_jax(scenario, make):
    seen = {name: scenario(pkg, make) for name, pkg in PKGS.items()}
    assert seen["torch"] == seen["jax"]


def test_engine_backend_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.EngineBackend()
    eb = TG.EngineBackend(device="cpu")
    try:
        gw = TG.Gateway(eb)
        gw.register(toy_real_runtime(PKGS["torch"]))
        fut = gw.invoke("toy", {"x": 1})
        assert fut.result() == {"echo": {"x": 1}, "calls": 1}
        assert fut.invocation.accelerator == "local/w0(host-cuda)"
        assert eb.n_workers == 1
    finally:
        eb.shutdown()


# ------------------------------------------------------------ the slice
JCFG = jget_config("granite-3-2b").reduced()
TCFG = tget_config("granite-3-2b").reduced()
ENGINE = dict(max_slots=4, max_len=64, page_size=16)


@pytest.fixture(scope="module")
def runtimes():
    """The JAX serve runtime (weights from seed 0 in its setup) and the
    port's, whose setup builds its engine from the same JAX weights
    through the bridge."""
    jdef = jmake_serve_runtime(JCFG, max_batch=4, seed=0, **ENGINE)
    tp = bridge.from_jax(
        jax.device_get(JM.init_model_params(JCFG, jax.random.PRNGKey(0))),
        device="cpu")
    tdef = tmake_serve_runtime(TCFG, max_batch=4, seed=0, device="cpu",
                               **ENGINE)
    tdef = dataclasses.replace(
        tdef, setup=lambda: ServingEngine(TCFG, tp, device="cpu", **ENGINE))
    return {"jax": jdef, "torch": tdef}


EVENTS = [{"prompts": [[5, 9, 14, 3, 22], [7] * 12]},
          {"prompts": [[31, 2, 8] * 9]},
          {"prompts": [[4, 4, 17, 60], [11, 12, 13], [40] * 19]},
          {"prompts": [[2, 3]]}]


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


def serve_through_gateway(pkg, rdef, make):
    eb = make(pkg, max_batch=4, batch_wait_s=1.0)
    gw = pkg.G.Gateway(eb)
    pkg.obs.enable(clock=eb.now, metrics=gw.metrics)
    gw.register(rdef)
    futs = gw.map(rdef.runtime_id, EVENTS, config={"max_new_tokens": 4})
    outs = gw.gather(futs)
    warm = gw.invoke(rdef.runtime_id, EVENTS[0],
                     config={"max_new_tokens": 4})
    outs.append(warm.result())
    handle = eb.handle(warm.invocation.runtime_key)
    handle.allocator.check_invariants()
    assert handle.allocator.n_free == handle.num_pages - 1, "page leak"
    return {"outputs": [o["outputs"] for o in outs],
            "envelopes": [envelope(gw, f.invocation) for f in futs + [warm]],
            "counts": (eb.n_cold_starts, eb.n_warm_starts),
            "batches": eb.batch_sizes,
            "spans": span_tree(pkg.obs.TRACER)}


def test_granite_slice_through_both_gateways_is_token_exact(runtimes, make):
    seen = {name: serve_through_gateway(pkg, runtimes[name], make)
            for name, pkg in PKGS.items()}
    j, t = seen["jax"], seen["torch"]
    assert j["batches"] == [4, 1]           # one full micro-batch, then warm
    assert j["counts"] == (1, 1)
    assert all(len(o) == 4 for out in j["outputs"] for o in out)
    assert t["outputs"] == j["outputs"]      # greedy tokens, tolerance 0
    assert t["envelopes"] == j["envelopes"]
    assert (t["counts"], t["batches"]) == (j["counts"], j["batches"])
    assert t["spans"] == j["spans"]
    names = {n for tree in t["spans"] for n, _ in tree[1]}
    assert {"queue_wait", "dispatch", "execute", "store_put"} <= names
    lead_execute = dict(t["spans"][0][1])["execute"]
    assert {n for n, _ in lead_execute} == {"prefill", "decode"}


def test_chained_serve_workflow_is_token_exact(runtimes, make):
    outs = {}
    for name, pkg in PKGS.items():
        gw = pkg.G.Gateway(make(pkg, max_batch=4))
        rid = gw.register(runtimes[name])
        cfg = {"max_new_tokens": 3}
        wf = pkg.G.Workflow("chain")
        a = wf.step("generate", rid, payload=EVENTS[2], config=cfg)
        wf.step("refine", rid, after=a, config=cfg)
        fut = gw.submit_workflow(wf)
        outs[name] = fut.result(extra_time_s=120.0)
        assert fut.statuses() == {"generate": "done", "refine": "done"}
    assert len(outs["jax"]["outputs"]) == 3
    assert outs["torch"] == outs["jax"]
