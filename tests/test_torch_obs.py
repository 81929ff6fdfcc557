"""The port's tracer (``repro_torch.obs``) on its gateway: the disabled
tracer is a no-op, an enabled one tiles each invocation's RLat with its
children (within 10% on the engine backend's live clock, as
``tests/test_obs.py`` holds the JAX engine) on an echo runtime and on
granite-3-2b ``.reduced()`` (whose ``execute`` spans hold the engine's
``prefill`` and ``decode`` spans), the Perfetto export validates and the
validator rejects a broken trace, ``torch_profile`` names a range only
while the tracer is on, and the launcher writes a trace that validates."""
import json

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.events import Invocation
from repro_torch.core.runtime import RuntimeDef
from repro_torch.gateway import EngineBackend, Gateway
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import TRACER, torch_profile, validate_trace
from repro_torch.obs import validate as validate_cli
from repro_torch.serve.api import make_serve_runtime

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _pristine_tracer():
    """Tracing state must never leak between tests (module singleton)."""
    obs.reset()
    yield
    obs.reset()


@pytest.fixture
def gateway():
    """A gateway over one host worker; shut down when the test ends."""
    eb = EngineBackend(device="cpu")
    yield Gateway(eb)
    eb.shutdown()


def echo(gw):
    gw.register(RuntimeDef(runtime_id="echo", profiles={},
                           fn=lambda data, config: {"echo": data}))


def partition_errors(tr):
    """Per-root relative error between RLat and the summed durations of
    the root's tiling children (an abandoned ``attempt`` overlaps)."""
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


def test_disabled_tracer_is_a_noop(gateway):
    inv = Invocation(runtime_id="r", data_ref="d", r_start=0.0)
    assert TRACER.complete("execute", 0.0, 1.0) is None
    assert TRACER.begin("execute", trace="t") is None
    TRACER.record_invocation(inv)
    assert TRACER.spans() == []
    echo(gateway)
    fut = gateway.invoke("echo", {"x": 1})
    assert fut.result() == {"echo": {"x": 1}}
    assert fut.invocation.trace_id is None and fut.invocation.span_id is None
    assert TRACER.spans() == []


def test_engine_partition_within_ten_percent_on_echo(gateway):
    obs.enable(clock=gateway.backend.now, metrics=gateway.metrics)
    echo(gateway)
    for f in gateway.map("echo", [{"i": i} for i in range(6)]):
        f.result()
    errs = partition_errors(TRACER)
    assert len(errs) == 6
    assert all(e <= 0.10 for e in errs.values()), errs
    assert TRACER.closed_roots() == 6
    ex = gateway.metrics.span_durations()["echo"]["execute"]
    assert ex["count"] == 6 and ex["max_s"] <= ex["total_s"]


def test_engine_partition_and_engine_spans_on_granite(gateway):
    obs.enable(clock=gateway.backend.now, metrics=gateway.metrics)
    cfg = get_config("granite-3-2b").reduced()
    rid = gateway.register(make_serve_runtime(
        cfg, max_slots=4, max_len=64, max_batch=2, device="cpu"))
    futs = gateway.map(rid, [{"prompts": [[3, 4, 5, 6], [9] * 20]},
                             {"prompts": [[7, 8]]}, {"prompts": [[1] * 9]}],
                       config={"max_new_tokens": 3})
    outs = [f.result() for f in futs]
    assert [len(o["outputs"]) for o in outs] == [2, 1, 1]
    errs = partition_errors(TRACER)
    assert len(errs) == 3 and all(e <= 0.10 for e in errs.values()), errs
    executes = TRACER.find(name="execute")
    kids = {e.span_id: {s.name for s in TRACER.spans()
                        if s.parent_id == e.span_id} for e in executes}
    # each batch's engine spans nest under its lead invocation's execute
    assert sum(1 for k in kids.values() if k == {"prefill", "decode"}) == \
        gateway.backend.n_batches
    tokens = sum(s.attrs["tokens"] for s in TRACER.find(name="prefill"))
    assert tokens == 4 + 20 + 2 + 9
    assert TRACER.find(name="cold_start")


def test_export_validate_roundtrip(gateway, tmp_path):
    obs.enable(clock=gateway.backend.now)
    echo(gateway)
    for f in gateway.map("echo", [{"i": i} for i in range(3)]):
        f.result()
    out = tmp_path / "trace.json"
    n = obs.export(str(out))
    doc = json.loads(out.read_text())
    assert len(doc["traceEvents"]) == n
    assert validate_trace(doc) == []
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert all("span_id" in e["args"] and e["dur"] >= 0 for e in xs)
    assert {e["name"] for e in xs} >= {"invocation", "execute", "settle"}
    assert validate_cli.main([str(out)]) == 0


def test_validator_rejects_structural_breakage(tmp_path):
    assert validate_trace({"no": "events"})
    assert validate_trace({"traceEvents": []})
    assert validate_trace({"traceEvents": [{"ph": "X", "name": "x"}]})
    ev = {"name": "x", "ph": "X", "ts": 5.0, "pid": 1, "tid": 1}
    assert validate_trace({"traceEvents": [ev]})            # X without dur
    assert validate_trace({"traceEvents": [dict(ev, dur=1), dict(ev, ts=1.0,
                                                                   dur=1)]})
    assert validate_trace({"traceEvents": [dict(ev, ph="B")]})   # unclosed
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [dict(ev, ph="Q")]}))
    assert validate_cli.main([str(bad)]) == 1


def _profiled_names(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key for e in prof.key_averages()}


def test_torch_profile_names_a_range_only_while_tracing():
    def run():
        with torch_profile("serve.step"):
            torch.ones(4).add_(1)
    assert "serve.step" not in _profiled_names(run)
    obs.enable()
    assert "serve.step" in _profiled_names(run)


def test_engine_step_range_follows_the_tracer():
    from repro_torch.serve.engine import Request
    rdef = make_serve_runtime(get_config("granite-3-2b").reduced(),
                              max_slots=2, max_len=32, device="cpu")
    eng = rdef.setup()

    def run():
        eng.generate([Request(prompt=[3, 4, 5], max_new_tokens=2)])
    assert "serve.step" not in _profiled_names(run)
    obs.enable()
    assert "serve.step" in _profiled_names(run)


def test_launcher_writes_trace_and_metrics(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    assert launch_serve.main(["--reduced", "--device", "cpu", "--events", "3",
                              "--max-batch", "2", "--trace-out", str(trace),
                              "--metrics-out", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "3/3 events served" in out and out.count("RLat=") == 3
    doc = json.loads(trace.read_text())
    assert validate_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"invocation", "execute", "prefill", "decode"} <= names
    m = json.loads(metrics.read_text())
    assert m["summary"]["n_completed"] == 3
    spans = m["span_durations"]["serve-granite-3-2b-smoke"]
    assert spans["execute"]["count"] == 3
    assert not TRACER.enabled                # the launcher turned it off
