"""The port's catalogue and roofline against the JAX package's.

Configs: all eleven registered archs field for field, with equal derived
sizes and ``.reduced()``; ``SHAPES``. The analytic roofline
(``roofline/analytic.py``): every function on every arch x shape, given
the reference's query block of 256, to a relative 1e-12. The report
(``RooflineReport``) with the reference's v5e constants and with the
H100 defaults; ``roofline_profile`` given the reference's peak and 256
chips, exactly. The launcher's ``--sim`` flag errors word for word, and a
``--sim`` run of two full-size archs on the CPU.

The served path of the two dense archs this catalogue adds, qwen2.5-14b
(QKV bias, rope theta 1e6) and deepseek-7b (32 kv heads), at ``.reduced()``
widths plus a qwen variant at G = 5 and hd 128, with the QKV biases drawn
non-zero (the specs initialise them to zeros, which would hide a bias that
was left out): the bridge round trip, logits against ``repro.models.model``
within float32 ``1e-4``, and greedy tokens against the reference
``ServingEngine``, token for token, paged (whole prompt and 8-token
chunks) and dense."""
import dataclasses
import functools
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import BlockKind as JK
from repro.configs import get_config, list_archs
from repro.models import model as JM
from repro.roofline import analytic as JA
from repro.roofline.analysis import RooflineReport as JReport
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.service_model import roofline_profile as j_profile
from repro_torch import bridge
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import BlockKind as TK
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.models import model as TM
from repro_torch.models.param import iter_leaves
from repro_torch.roofline import analytic as TA
from repro_torch.roofline import analysis as TAN
from repro_torch.serve import service_model as TSM
from repro_torch.serve.engine import Request, ServingEngine

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

ARCHS = list_archs()
REL = 1e-12


def _fields(cfg):
    """A config as plain data (enums by value), with its derived sizes."""
    d = {k: (v.value if hasattr(v, "value") else v)
         for k, v in dataclasses.asdict(cfg).items()}
    d["pattern"] = tuple(k.value for k in cfg.pattern)
    d.update(n_params=cfg.n_params, n_active_params=cfg.n_active_params,
             hd=cfg.hd, padded_vocab=cfg.padded_vocab,
             layer_pattern=tuple(k.value for k in cfg.layer_pattern),
             n_moe_layers=cfg.n_moe_layers)
    return d


def test_port_registers_the_reference_catalogue():
    assert tlist_archs() == ARCHS and len(ARCHS) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    j, t = get_config(arch), tget_config(arch)
    assert _fields(t) == _fields(j)
    assert _fields(t.reduced()) == _fields(j.reduced())


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in T_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


# ----------------------------------------------------------------------
# the analytic roofline
# ----------------------------------------------------------------------
def _same(got, want, what):
    got, want = np.atleast_1d(np.asarray(got, float)), np.atleast_1d(np.asarray(want, float))
    assert got.shape == want.shape, what
    for g, w in zip(got, want):
        assert math.isclose(g, w, rel_tol=REL, abs_tol=0.0), f"{what}: {g} != {w}"


ATTN_KINDS = ("attn", "local", "chunked")


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_equals_reference(arch, shape):
    jc, tc = get_config(arch), tget_config(arch)
    js, ts = J_SHAPES[shape], T_SHAPES[shape]
    train = js.kind == "train"
    sq, batch = js.seq_len, js.global_batch
    for kind in ATTN_KINDS:
        for cross in (False, True):
            _same(TA.attention_layer(tc, TK(kind), sq, batch, train, cross, block_q=256),
                  JA.attention_layer(jc, JK(kind), sq, batch, train, cross),
                  f"attention_layer {kind} cross={cross}")
    for window, chunk, causal in ((0, 0, True), (jc.window, 0, True),
                                  (0, jc.chunk, True), (0, 0, False), (4096, 0, True)):
        _same(TA._skv_eff(sq, sq, causal, window, chunk),
              JA._skv_eff(sq, sq, causal, window, chunk), "_skv_eff")
    _same(TA.mlstm_layer(tc, sq, batch, train), JA.mlstm_layer(jc, sq, batch, train),
          "mlstm_layer")
    _same(TA.rglru_layer(tc, sq, batch, train), JA.rglru_layer(jc, sq, batch, train),
          "rglru_layer")
    _same(TA.stubbed_op_costs(tc, ts, block_q=256), JA.stubbed_op_costs(jc, js),
          "stubbed_op_costs")
    for data, model, pod in ((1, 1, 1), (16, 16, 1), (4, 8, 2), (1, 3, 1)):
        _same(TA.moe_weight_traffic_per_chip(tc, ts, model),
              JA.moe_weight_traffic_per_chip(jc, js, model), "moe_weight_traffic")
        _same(TA.parallel_chips(tc, data, model, pod),
              JA.parallel_chips(jc, data, model, pod), "parallel_chips")
        for fsdp in (True, False):
            _same(TA.memory_model(tc, ts, data, model, pod, fsdp=fsdp, block_q=256),
                  JA.memory_model(jc, js, data, model, pod, fsdp=fsdp),
                  f"memory_model {data}x{model}x{pod} fsdp={fsdp}")
    _same(TA.memory_model(tc, ts, 1, 1, weight_bytes=1, cache_bytes=1, microbatch=4,
                          block_q=256),
          JA.memory_model(jc, js, 1, 1, weight_bytes=1, cache_bytes=1, microbatch=4),
          "memory_model int8")


def test_analytic_block_q_defaults_to_k2_tile():
    """The port's default query block is K2's 64-row tile: a prefill
    streams K/V 4x as often as with the reference's 256."""
    cfg = tget_config("qwen2.5-14b")
    assert TA.BLOCK_Q == 64
    f64, b64 = TA.attention_layer(cfg, cfg.pattern[0], 4096, 1, False)
    f256, b256 = TA.attention_layer(cfg, cfg.pattern[0], 4096, 1, False, block_q=256)
    assert f64 == f256 and b64 > b256


# the reference's test_metrics_roofline.py::test_roofline_report_terms,
# once with its v5e constants and once with the port's H100 defaults
REPORT_CONSTANTS = {"reference": dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9),
                    "h100": dict(peak_flops=TAN.PEAK_FLOPS, hbm_bw=TAN.HBM_BW,
                                 link_bw=TAN.NVLINK_BW)}


@pytest.mark.parametrize("consts", sorted(REPORT_CONSTANTS))
def test_roofline_report_terms(consts):
    c = REPORT_CONSTANTS[consts]
    fields = dict(
        arch="x", shape="train_4k", mesh="single", chips=256,
        hlo_flops=c["peak_flops"] * 0.5,      # 0.5 s compute
        hlo_bytes=c["hbm_bw"] * 2.0,          # 2 s memory (unfused)
        coll_bytes=c["link_bw"] * 1.0,        # 1 s collective
        coll_breakdown={}, coll_counts={},
        model_flops=c["peak_flops"] * 256 * 0.25,
        model_bytes=c["hbm_bw"] * 0.1)        # fused model: 0.1 s
    r = TAN.RooflineReport(**fields) if consts == "h100" else \
        TAN.RooflineReport(**fields, **c)
    assert abs(r.t_compute - 0.5) < 1e-9
    assert abs(r.t_memory - 0.1) < 1e-9
    assert abs(r.t_memory_unfused - 2.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert r.dominant == "collective"
    assert abs(r.useful_ratio - 0.5) < 1e-9
    assert abs(r.mfu - 0.25) < 1e-9
    if consts == "reference":
        want = JReport(**fields).to_dict()
        got = r.to_dict()
        for k in c:
            got.pop(k)
        assert got == want


def test_h100_constants_are_the_datasheet_figures():
    assert (TAN.PEAK_FLOPS, TAN.HBM_BW, TAN.NVLINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
def test_model_flops_equal_reference(shape):
    from repro.roofline.analysis import model_flops as j_flops
    for arch in ARCHS:
        assert TAN.model_flops(tget_config(arch), T_SHAPES[shape]) == \
            j_flops(get_config(arch), J_SHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_profile_equals_reference(arch):
    """Given the reference's peak and its 256 chips, the port's profile is
    the reference's analytic fallback exactly (there is no dry-run sweep in
    the repository for the reference to read instead)."""
    for kw in (dict(), dict(batch=2, new_tokens=32, prompt_len=1024, cold_start_s=1.0)):
        got = TSM.roofline_profile(tget_config(arch), peak=197e12, chips=256, **kw)
        want = j_profile(get_config(arch), **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_roofline_profile_on_the_sim_node():
    """By default an 8-GPU H100 node at the datasheet's bf16 peak, 40% MFU."""
    cfg = tget_config("qwen2.5-14b")
    assert TSM.SIM_NODE.chips == 8 and TSM.SIM_NODE.type == "h100-sxm-8"
    assert TSM.SIM_NODE.mem_bytes == 8 * 80 * 2 ** 30
    p = TSM.roofline_profile(cfg, batch=2, new_tokens=16, prompt_len=64)
    rate = 989e12 * 8 * 0.4
    n = cfg.n_active_params
    want = 2 * n * 2 * 64 / rate + 16 * max(2 * n * 2 / rate, 2e-4)
    assert math.isclose(p.elat_median_s, want, rel_tol=1e-12)
    assert math.isclose(p.cold_start_s, 20.0 + cfg.n_params * 2 / 1.25e9 / 16,
                        rel_tol=1e-12)


# ----------------------------------------------------------------------
# the launcher's --sim
# ----------------------------------------------------------------------
SIM_ERRORS = {"cluster": ["--cluster", "1", "--sim"],
              "engine": ["--backend", "engine", "--sim"]}


@pytest.mark.parametrize("case", sorted(SIM_ERRORS))
def test_sim_flag_errors_match_reference(case, capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    msgs = []
    for main in (jserve.main, tserve.main):
        with pytest.raises(SystemExit) as e:
            main(SIM_ERRORS[case])
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
    assert msgs[0] == msgs[1]
    assert "--sim" in msgs[0]


def test_sim_serves_full_size_archs_on_the_cpu(capsys):
    from repro_torch.launch import serve as tserve
    rc = tserve.main(["--backend", "sim", "--sim", "--arch",
                      "qwen2.5-14b,grok-1-314b", "--events", "4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "4/4 events served" in out
    assert out.count("(h100-sxm-8)") >= 4
    for arch in ("qwen2.5-14b", "grok-1-314b"):
        prof = TSM.roofline_profile(tget_config(arch), batch=2, new_tokens=16,
                                    prompt_len=64)
        assert f"profile serve-{arch}: ELat median {prof.elat_median_s:.6f}s" in out


# ----------------------------------------------------------------------
# qwen2.5-14b and deepseek-7b served: bridge, logits, engines
# ----------------------------------------------------------------------
SERVED = {"qwen": ("qwen2.5-14b", {}),
          # G = 5 at hd 128, as at full width
          "qwen-g5": ("qwen2.5-14b", dict(n_heads=5, n_kv_heads=1, head_dim=128)),
          "deepseek": ("deepseek-7b", {})}
MAX_LEN = 64
LEN_PALETTE = (2, 3, 5, 9, 12, 15, 19, 27, 40)
ATOL = 1e-4


def _cfgs(name):
    arch, kw = SERVED[name]
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(tget_config(arch).reduced(), **kw))


def _with_biases(tree, seed):
    """The reference's params with every QKV bias drawn non-zero."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (0.5 * rng.standard_normal(v.shape).astype(v.dtype)
                 if k in ("bq", "bk", "bv") else v)
                for k, v in sorted(node.items())}
    return walk(tree)


@functools.cache
def _params(name):
    """(reference config, port config, the reference's params with drawn
    biases, the same arrays as the port's tree), built once per arch."""
    jcfg, tcfg = _cfgs(name)
    jp = _with_biases(jax.device_get(JM.init_model_params(jcfg, jax.random.PRNGKey(0))),
                      seed=len(name))
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, jp),
            bridge.from_jax(jp, device="cpu"))


@pytest.mark.parametrize("name", sorted(SERVED))
def test_bridge_roundtrip_with_biases(name):
    jcfg, tcfg, jp, tp = _params(name)
    want = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    back = dict(iter_leaves(bridge.to_numpy(tp)))
    assert set(back) == set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)
    assert {p: s.shape for p, s in iter_leaves(TM.param_specs(tcfg))} == \
        {p: s.shape for p, s in iter_leaves(JM.param_specs(jcfg))}
    biases = [p for p in back if p.split("/")[-1] in ("bq", "bk", "bv")]
    assert bool(biases) == tcfg.qkv_bias
    assert all(np.abs(back[p]).min() > 0 for p in biases)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(SERVED))
def test_logits_match_reference(name):
    """Whole-prompt prefill, then 4 dense decode steps and, from a second
    prefill in two chunks, 4 paged decode steps: logits and caches."""
    jcfg, tcfg, jp, tp = _params(name)
    toks = np.random.default_rng(7).integers(1, 512, size=(1, 25)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :21])}, cache_len=25)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :21])}, cache_len=25)
    _close(tl, jl, "prefill")
    for t in range(21, 25):
        p = np.array([t], np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(p))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(p))
        _close(tl, jl, f"dense decode at {t}")
    want = dict(iter_leaves(jax.device_get(jc)))
    for path, leaf in iter_leaves(tc):
        _close(leaf, want[path], path)

    page, n_pages = 8, 8
    table = np.array([[2, 5, 1, 7]], np.int32)
    jcache = JM.init_paged_cache(jcfg, 1, 32, n_pages, page)
    tcache = TM.init_paged_cache(tcfg, 1, 32, n_pages, page, device="cpu")
    for pos, C in ((0, 13), (13, 8)):
        piece = toks[:, pos:pos + C]
        jl, jcache = JM.prefill_chunk(jcfg, jp, jcache, jnp.asarray(piece),
                                      jnp.asarray(pos, jnp.int32), jnp.asarray(table))
        tl, tcache = TM.prefill_chunk(tcfg, tp, tcache, torch.from_numpy(piece), pos,
                                      torch.from_numpy(table))
        _close(tl, jl, f"chunk at {pos}")
    for t in range(21, 25):
        p = np.array([t], np.int32)
        jl, jcache = JM.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(p), block_tables=jnp.asarray(table))
        tl, tcache = TM.decode_step(tcfg, tp, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                    torch.from_numpy(p), block_tables=torch.from_numpy(table))
        _close(tl, jl, f"paged decode at {t}")


def _schedule(seed, vocab, n=5):
    """The reference suite's seeded request mix (tests/test_paged_engine.py)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        prompt = [rng.randrange(1, vocab) for _ in range(rng.choice(LEN_PALETTE))]
        out.append((prompt, rng.choice((3, 4, 6))))
    return out


def _run(engine, sched, request_cls):
    reqs = [request_cls(prompt=list(p), max_new_tokens=m, req_id=i)
            for i, (p, m) in enumerate(sched)]
    done = engine.generate(reqs)
    assert all(r.done for r in reqs) and len(done) == len(reqs)
    if engine.paged:
        engine.allocator.check_invariants()
        assert engine.allocator.n_free == engine.num_pages - 1, "page leak"
    return {r.req_id: list(r.output) for r in done}


LAYOUTS = {"paged": dict(page_size=16), "chunked": dict(page_size=16, prefill_chunk=8),
           "dense": dict(page_size=0)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(SERVED))
def test_engine_token_exact(name, layout):
    jcfg, tcfg, jp, tp = _params(name)
    kw = dict(max_slots=2, max_len=MAX_LEN, **LAYOUTS[layout])
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    for seed in (0, 101):
        sched = _schedule(seed + len(name), jcfg.vocab)
        assert _run(teng, sched, Request) == _run(jeng, sched, JRequest), seed
    if layout == "chunked":
        assert teng.n_prefill_chunks > 0, "no prompt actually chunked"
    assert teng.stats() == jeng.stats()
