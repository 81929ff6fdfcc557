"""The port's runtime front door (``make_serve_runtime``), its launcher, its
device rule, and the rule that the port imports nothing of JAX or of the
JAX package."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serve.api import make_serve_runtime as jmake_serve_runtime
from repro_torch.configs import get_config
from repro_torch.core.runtime import RuntimeDef, SimProfile, run_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.serve.api import make_serve_runtime
from repro_torch.serve.engine import ServingEngine

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("granite-3-2b").reduced()


@pytest.fixture(scope="module")
def greedy_rt():
    rdef = make_serve_runtime(CFG, max_slots=2, max_len=64, device="cpu")
    return rdef, rdef.setup()


@pytest.fixture(scope="module")
def sampled_rt():
    rdef = make_serve_runtime(CFG, max_slots=2, max_len=64, greedy=False,
                              seed=3, device="cpu")
    return rdef, rdef.setup()


def test_fn_accepts_prompts_outputs_and_fan_in(greedy_rt):
    rdef, eng = greedy_rt
    cfg = {"handle": eng, "max_new_tokens": 3}
    a = rdef.fn({"prompts": [[1, 2, 3], [4, 5]]}, cfg)
    assert set(a) == {"outputs", "n_decode_steps"}
    assert len(a["outputs"]) == 2
    b = rdef.fn({"outputs": a["outputs"]}, cfg)          # chained step
    assert len(b["outputs"]) == 2
    c = rdef.fn([{"prompts": [[1, 2, 3]]}, {"outputs": [[4, 5]]}], cfg)
    assert len(c["outputs"]) == 2                        # fan-in gather
    assert sorted(c["outputs"]) == sorted(a["outputs"])
    assert rdef.fn({"prompts": [[]]}, cfg)["outputs"]    # empty prompt -> [0]


def test_batch_fn_and_run_batch(greedy_rt):
    rdef, eng = greedy_rt
    datas = [{"prompts": [[1, 2, 3]]}, {"prompts": [[4, 5], [6]]}]
    out = run_batch(rdef, datas, {"handle": eng, "max_new_tokens": 2})
    assert [len(r["outputs"]) for r in out] == [1, 2]
    assert rdef.is_batchable and rdef.batch_limit(8) == 4
    alone = rdef.fn(datas[0], {"handle": eng, "max_new_tokens": 2})
    assert out[0]["outputs"] == alone["outputs"]         # greedy: same tokens


def test_attempts_fold_into_sampling(sampled_rt):
    rdef, eng = sampled_rt
    data = {"prompts": [[7, 8, 9]]}

    def go(attempt):
        return rdef.fn(data, {"handle": eng, "max_new_tokens": 8,
                              "attempt": attempt})["outputs"]
    assert go(0) == go(0)
    assert go(0) != go(1)

    def batched(attempts):
        return [r["outputs"] for r in rdef.batch_fn(
            [data, data], {"handle": eng, "max_new_tokens": 8,
                           "attempts": attempts})]
    # request ids run across the micro-batch (0, then 1), as in repro's
    # batch_fn; the first event's request draws what fn draws alone
    assert batched([0, 0])[0] == go(0)
    assert batched([0, 1]) == batched([0, 1])
    assert batched([0, 1])[1] != batched([0, 0])[1]


def test_envelope_matches_jax_runtime_shape(greedy_rt):
    rdef, eng = greedy_rt
    jdef = jmake_serve_runtime(jget_config("granite-3-2b").reduced(),
                               max_slots=2, max_len=64)
    data = [{"prompts": [[1, 2, 3], [9]]}, {"prompts": [[4, 5]]}]
    want = jdef.batch_fn(data, {"handle": jdef.setup(), "max_new_tokens": 3})
    got = rdef.batch_fn(data, {"handle": eng, "max_new_tokens": 3})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert len(g["outputs"]) == len(w["outputs"])
        assert all(isinstance(t, int) for o in g["outputs"] for t in o)
        assert isinstance(g["n_decode_steps"], int)
    assert rdef.runtime_id == jdef.runtime_id


def test_run_batch_pads_to_bucket():
    seen = []

    def batch_fn(datas, config):
        seen.append((len(datas), config["n_real"], config["attempts"]))
        return list(datas)
    rdef = RuntimeDef("r", {"a": SimProfile(1.0)}, batch_fn=batch_fn,
                      max_batch=4, batch_buckets=(4,))
    assert run_batch(rdef, ["x", "y"], {"attempts": [1, 2]}) == ["x", "y"]
    assert seen == [(4, 2, [1, 2, 2, 2])]


def test_recurrentgemma_runtime_serves_prompt_events():
    rg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                             n_layers=5, window=8)
    rdef = make_serve_runtime(rg, max_slots=2, max_len=64, device="cpu")
    eng = rdef.setup()
    config = {"handle": eng, "max_new_tokens": 3}
    one = rdef.fn({"prompts": [[1, 2, 3] * 5, [4, 5]]}, config)
    assert len(one["outputs"]) == 2 and all(len(o) == 3 for o in one["outputs"])
    out = rdef.batch_fn([{"prompts": [[1, 2, 3] * 5]},
                         {"prompts": [[4, 5], [6] * 20]}], config)
    assert [len(r["outputs"]) for r in out] == [1, 2]
    assert out[0]["outputs"] == one["outputs"][:1]       # greedy: same tokens
    assert eng.stats()["paged"] == 1 and eng.free_slots() == [0, 1]


def test_launcher_serves_on_cpu(capsys):
    assert launch_serve.main(["--reduced", "--device", "cpu", "--events", "3",
                              "--max-batch", "2", "--prefill-chunk", "16"]) == 0
    out = capsys.readouterr().out
    assert "cold start" in out and "3/3 events served" in out
    assert out.count("ELat=") == 3


def test_launcher_serves_recurrentgemma_dense(capsys):
    assert launch_serve.main(["--arch", "recurrentgemma-2b", "--reduced",
                              "--device", "cpu", "--events", "2",
                              "--page-size", "0"]) == 0
    out = capsys.readouterr().out
    assert "serve-recurrentgemma-2b-smoke" in out and "2/2 events served" in out
    assert "'paged': 0" in out


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "grok-1-314b"])
def test_launcher_serves_moe_archs(arch, capsys):
    """64-token prompts: llama4's reduced chunk of 64 is crossed while
    decoding; grok-1 prefills in chunks of 16."""
    assert launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--events", "2", "--prefill-chunk", "16"]) == 0
    out = capsys.readouterr().out
    assert f"serve-{arch}-smoke" in out and "2/2 events served" in out


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    params = M.init_model_params(CFG, 0, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(CFG, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serve_runtime(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_model_params(CFG, 0)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "chip_compare.py"]
    assert len(files) > 15
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, bad
