"""The engine's compiled step (``repro_torch/serve/step_graph.py``): each
decode and chunk step is one program per shape signature, as the
reference's ``jax.jit`` compiles one program per shape.

On the CPU nothing is captured and the static-buffer step runs eagerly:

* the port's engine is token-exact against the JAX package's
  ``ServingEngine`` on ``.reduced()`` configs (same weights through the
  bridge) for granite and xlstm paged (prompts across the table widths
  1, 2 and 4), chunked (chunk groups of one and two slots at several
  widths) and dense, recurrentgemma and llama4-scout, and it makes exactly
  one program per signature and reuses it;
* a chunk whose start is a tensor equals the chunk whose start is an int,
  bit for bit (logits and every cache leaf);
* ``unembed`` on the CPU is the float32 upcast, bit for bit;
* the launch record of a capture, and its replay into the counts.

The ``gpu`` cases (``python -m pytest -m gpu tests/test_torch_step_graphs.py``
on the card, where JAX is not needed) hold the captured engine against the
eager one per family and dtype: equal logits bit for bit and equal tokens
over runs that cross widths, with equal launch counts; a capture while
another thread launches on the card; memory back within 64 MiB after the
engine is dropped; and ``unembed``'s ``out_dtype`` product against the
upcast (float32 summation order only: within 1e-5 of the sum of |products|)
with a peak below the upcast's by the table's float32 bytes, and its
backward under autograd against the upcast's.
"""
import dataclasses
import gc
import random
import threading

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import moe_gmm as gm
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.param import iter_leaves
from repro_torch.serve import step_graph as SG
from repro_torch.serve.engine import Request, ServingEngine

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

ARCHS = {"granite": "granite-3-2b", "recurrentgemma": "recurrentgemma-2b",
         "llama4": "llama4-scout-17b-a16e", "xlstm": "xlstm-350m"}
MAX_LEN = 64            # 4 pages of 16: decode widths 1, 2 and 4
# (arch, engine kwargs, schedule): prompts of 2-40 tokens, 3-6 new tokens
CASES = {
    "granite_paged": ("granite", {}, [(5, 6), (9, 3), (20, 4), (40, 6), (33, 5)]),
    "granite_chunked": ("granite", dict(prefill_chunk=8),
                        [(20, 4), (20, 6), (40, 6), (9, 3), (27, 5)]),
    "granite_dense": ("granite", dict(page_size=0), [(5, 6), (20, 4), (40, 6)]),
    "recurrentgemma": ("recurrentgemma", {}, [(5, 6), (9, 3), (27, 4), (40, 6)]),
    "llama4": ("llama4", {}, [(5, 6), (9, 3), (27, 4), (40, 6)]),
    # no attention: a paged cache with no pooled leaf, all-float32 state
    # as the static step's cache, and chunk steps that unroll each sLSTM
    # layer's recurrence over the chunk
    "xlstm_paged": ("xlstm", {}, [(5, 6), (9, 3), (20, 4), (40, 6), (33, 5)]),
    "xlstm_chunked": ("xlstm", dict(prefill_chunk=8),
                      [(20, 4), (20, 6), (40, 6), (9, 3), (27, 5)]),
    "xlstm_dense": ("xlstm", dict(page_size=0), [(5, 6), (20, 4), (40, 6)]),
}


def _tcfg(arch, **kw):
    return dataclasses.replace(tget_config(ARCHS[arch]).reduced(), **kw)


def _prompts(case, vocab, seed=0):
    rng = random.Random(seed)
    return [([rng.randrange(1, vocab) for _ in range(n)], m)
            for n, m in CASES[case][2]]


def _run(engine, sched, request_cls):
    reqs = [request_cls(prompt=list(p), max_new_tokens=m, req_id=i)
            for i, (p, m) in enumerate(sched)]
    done = engine.generate(reqs)
    assert all(r.done for r in reqs) and len(done) == len(reqs)
    assert engine.free_slots() == list(range(engine.max_slots))
    if engine.paged:
        engine.allocator.check_invariants()
        assert engine.allocator.n_free == engine.num_pages - 1, "page leak"
    return {r.req_id: list(r.output) for r in done}


def _kw(case):
    kw = dict(max_slots=2, max_len=MAX_LEN, page_size=16)
    kw.update(CASES[case][1])
    return kw


class _Spy:
    """Records the signature of every step program call of an engine,
    whether the call made the program, and a copy of the logits it gave,
    around ``StepGraphs.run``."""

    def __init__(self, engine):
        self.keys, self.made, self.outputs = [], [], []
        graphs = engine.step_graphs
        run = graphs.run

        def spied(key, arrays, fn):
            self.made.append(key not in graphs.programs)
            out = run(key, arrays, fn)
            self.keys.append(key)
            logits = out[0] if isinstance(out, tuple) else out
            self.outputs.append(logits.detach().clone())
            return out
        graphs.run = spied


# ----------------------------------------------------------------------
# CPU: the static-buffer step against the reference engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_step_programs_token_exact(case):
    import jax

    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServingEngine as JEngine
    arch = CASES[case][0]
    jcfg = get_config(ARCHS[arch]).reduced()
    tcfg = _tcfg(arch)
    jp = JM.init_model_params(jcfg, jax.random.PRNGKey(3))
    tp = bridge.from_jax(jax.device_get(jp), device="cpu")
    jeng = JEngine(jcfg, jp, **_kw(case))
    teng = ServingEngine(tcfg, tp, device="cpu", **_kw(case))
    spy = _Spy(teng)
    sched = _prompts(case, tcfg.vocab)
    assert _run(teng, sched, Request) == _run(jeng, sched, JRequest)
    assert teng.stats() == jeng.stats()

    graphs = teng.step_graphs
    # the CPU captures nothing: every call runs the same step eagerly
    assert not graphs.capture and graphs.n_graphs == 0
    # one program per signature, made at its first call and reused
    assert set(graphs.programs) == set(spy.keys)
    assert [k for k, made in zip(spy.keys, spy.made) if made] == \
        list(dict.fromkeys(spy.keys))
    assert len(spy.keys) > len(graphs.programs), "no program was reused"
    kinds = {k[0] for k in spy.keys}
    if teng.paged:
        widths = sorted({k[-1] for k in spy.keys if k[0] == "decode"})
        assert widths == [1, 2, 4], widths
    else:
        assert kinds == {"dense"} and len(graphs.programs) == 1
    if "prefill_chunk" in CASES[case][1]:
        chunks = [k for k in spy.keys if k[0] == "chunk"]
        assert len(chunks) > len(set(chunks)), "no chunk program reused"
        assert {k[1] for k in chunks} == {1, 2}, "no group of two slots"
        assert len({k[3] for k in chunks}) >= 2, "one chunk width only"


def test_chunk_start_tensor_equals_int():
    """The chunk start as a 0-d tensor gives the int start's logits and
    cache, bit for bit."""
    tcfg = _tcfg("granite")
    params = TM.init_model_params(tcfg, 1, "cpu")
    page, C = 16, 8
    toks = np.random.default_rng(2).integers(1, tcfg.vocab, (2, 3 * C))
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    cache = TM.init_paged_cache(tcfg, 2, 32, 5, page, device="cpu")
    for p in (0, C):
        _, cache = TM.prefill_chunk(tcfg, params, cache,
                                    torch.from_numpy(toks[:, p:p + C]), p, bt)
    copy = {path: t.clone() for path, t in iter_leaves(cache)}
    piece = torch.from_numpy(toks[:, 2 * C:])
    want, cache = TM.prefill_chunk(tcfg, params, cache, piece, 2 * C, bt)
    other = TM.init_paged_cache(tcfg, 2, 32, 5, page, device="cpu")
    for path, t in iter_leaves(other):
        t.copy_(copy[path])
    got, other = TM.prefill_chunk(tcfg, params, other, piece,
                                  torch.tensor(2 * C, dtype=torch.int32), bt)
    assert torch.equal(got, want)
    for (path, a), (_, b) in zip(iter_leaves(other), iter_leaves(cache)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tie", [True, False])
def test_unembed_on_cpu_is_the_upcast(dtype, tie):
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.standard_normal((96, 32))).to(dtype)
    params = {"tok": tok}
    if not tie:
        params["head"] = torch.from_numpy(rng.standard_normal((32, 96))).to(dtype)
    x = torch.from_numpy(rng.standard_normal((3, 2, 32))).to(dtype)
    w = tok.t() if tie else params["head"]
    got = TL.unembed(params, x, tie)
    assert got.dtype == torch.float32 and got.shape == (3, 2, 96)
    assert torch.equal(got, x.float() @ w.float())


def test_capture_records_launches_and_replays_add_them():
    """While a thread records (a capture), its counted launches go to the
    record and leave the counts; another thread counts as ever; a replay of
    a program adds its record to the counts."""
    before = pa.paged_decode_attention.launches
    other = []
    with build.recording_launches() as record:
        build.count_launch(pa.paged_decode_attention)
        build.count_launch(pa.paged_decode_attention)
        build.count_launch(gm.moe_gmm)
        t = threading.Thread(target=lambda: other.append(
            build.count_launch(da.decode_attention)))
        n_dense = da.decode_attention.launches
        t.start()
        t.join()
        assert da.decode_attention.launches == n_dense + 1
    assert record == {pa.paged_decode_attention: 2, gm.moe_gmm: 1}
    assert pa.paged_decode_attention.launches == before

    class Replayed:
        n = 0

        def replay(self):
            Replayed.n += 1

    graphs = SG.StepGraphs(torch.device("cpu"))
    prog = SG.Program([torch.zeros(2, dtype=torch.int32)])
    prog.graph, prog.outputs, prog.launches = Replayed(), "out", record
    graphs.programs[("decode", 1)] = prog
    n_moe = gm.moe_gmm.launches
    for i in range(3):
        assert graphs.run(("decode", 1), [np.array([i, i], np.int32)],
                          None) == "out"
    assert Replayed.n == 3
    assert prog.inputs[0].tolist() == [2, 2]
    assert pa.paged_decode_attention.launches == before + 6
    assert gm.moe_gmm.launches == n_moe + 3
    pa.paged_decode_attention.launches = before
    gm.moe_gmm.launches = n_moe


def test_kernel_node_names_map_to_kernels():
    """Body kernels count for their kernel (K1's decode body also serves a
    one-token chunk); the split decode's merge and the library's kernels
    count for none; an identifier matches with its length prefix only."""
    names = [
        "_Z23split_decode_mma_kernelILi64EN2rt10PagedCacheEEvN3dec6ParamsI13__nv_bfloat16S3_T0_EE",
        "_Z23split_decode_fma_kernelIffLi128EN2rt10DenseCacheEEvN3dec6ParamsIT_T0_T2_EE",
        "_Z25split_decode_merge_kernelIfLi64EEvPKfPT_ii",
        "_Z24paged_prefill_mma_kernelILi64EEvPK13__nv_bfloat16",
        "_Z18moe_gmm_mma_kernelPK13__nv_bfloat16",
        "_Z14moe_gmm_kernelIfEvPKT_",
        "ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_tn",
        "_ZN2at6native29vectorized_elementwise_kernelILi4EZ",
    ]
    assert SG.count_kernel_nodes(names) == {"K1": 2, "K3": 1, "K4": 2}
    assert SG.by_kernel({pa.paged_decode_attention: 3,
                         pa.paged_prefill_attention: 1,
                         gm.moe_gmm: 2}) == {"K1": 4, "K4": 2}


def test_every_wrapper_names_a_kernel_with_bodies():
    """Each wrapper names its kernel beside its launch count, and that
    kernel has body names in ``build.BODIES``; no body is named twice."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    wrappers = {fa.flash_attention: "K2", pa.paged_decode_attention: "K1",
                pa.paged_prefill_attention: "K1", da.decode_attention: "K3",
                gm.moe_gmm: "K4", rs.rglru_scan: "K5",
                fa.flash_attention_bwd: "K2 bwd", rs.rglru_scan_bwd: "K5 bwd",
                gm.moe_gmm_bwd: "K4 bwd"}
    assert {w: w.kernel for w in wrappers} == wrappers
    assert {k for _, k in build.BODIES} == set(wrappers.values())
    frags = [f for f, _ in build.BODIES]
    assert len(set(frags)) == len(frags)
    assert build.kernel_of_body("_Z17rglru_scan_kernelIfEvv") == "K5"
    assert build.kernel_of_body("_Z25split_decode_merge_kernelIfLi64EEv") is None
    # the length prefix keeps the forward's bodies apart from the backward's
    assert build.kernel_of_body("_Z22flash_attention_kernelIfLi64EEv") == "K2"
    assert build.kernel_of_body(
        "_Z29flash_attention_bwd_dq_kernelILi64EEv") == "K2 bwd"
    assert build.kernel_of_body("_Z21rglru_scan_bwd_kernelILi16ELi16EEv") == "K5 bwd"
    assert build.kernel_of_body("_ZN12_GLOBAL__N_121moe_gmm_bwd_dw_kernelEv") == "K4 bwd"
    assert build.kernel_of_body("_ZN12_GLOBAL__N_118moe_gmm_mma_kernelEv") == "K4"
    # the backward's wgmma bodies; the head groups' sum is not a body
    assert build.kernel_of_body(
        "_ZN12_GLOBAL__N_136flash_attention_bwd_dkv_wgmma_kernelILi256ELi1EEEv") == "K2 bwd"
    assert build.kernel_of_body(
        "_ZN12_GLOBAL__N_127moe_gmm_bwd_dx_wgmma_kernelEv") == "K4 bwd"
    assert build.kernel_of_body(
        "_ZN12_GLOBAL__N_137flash_attention_bwd_dkv_reduce_kernelEv") is None


# ----------------------------------------------------------------------
# on the card: captured against eager
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    return {w.__name__: w.launches for w in (
        fa.flash_attention, pa.paged_decode_attention,
        pa.paged_prefill_attention, da.decode_attention, gm.moe_gmm,
        rs.rglru_scan)}


def _served(case, dtype, params, dev, graphs, **kw):
    """(tokens, per-step logits, launch counts, engine) of one schedule."""
    arch = CASES[case][0]
    cfg = _tcfg(arch, dtype=dtype)
    engine = ServingEngine(cfg, params, device=dev, graphs=graphs,
                           **_kw(case), **kw)
    spy = _Spy(engine)
    before = _counts()
    toks = _run(engine, _prompts(case, cfg.vocab), Request)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _counts().items()}
    return toks, spy, counts, engine


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_step_equals_eager(cuda, case, dtype):
    cfg = _tcfg(CASES[case][0], dtype=dtype)
    params = TM.init_model_params(cfg, 5, cuda)
    eager = _served(case, dtype, params, cuda, graphs=False)
    captured = _served(case, dtype, params, cuda, graphs=True)
    assert captured[0] == eager[0]
    assert captured[1].keys == eager[1].keys
    for i, (a, b) in enumerate(zip(captured[1].outputs, eager[1].outputs)):
        assert torch.equal(a, b), (i, captured[1].keys[i],
                                   float((a - b).abs().max()))
    # the counts count replayed launches as launched ones
    assert captured[2] == eager[2]
    graphs = captured[3].step_graphs
    assert graphs.n_graphs == len(graphs.programs) == len(set(captured[1].keys))
    assert eager[3].step_graphs.n_graphs == 0


@pytest.mark.gpu
def test_captured_sampling_equals_eager(cuda):
    """The sampled path reads the graph's logits before the next replay:
    the same draws as the eager steps."""
    params = TM.init_model_params(_tcfg("granite"), 5, cuda)
    eager = _served("granite_chunked", "float32", params, cuda, graphs=False,
                    greedy=False, sample_seed=3)
    captured = _served("granite_chunked", "float32", params, cuda,
                       graphs=True, greedy=False, sample_seed=3)
    assert captured[0] == eager[0]
    assert captured[3].step_graphs.n_graphs >= 3


@pytest.mark.gpu
def test_capture_while_another_thread_launches(cuda):
    """Thread-local capture: a thread that allocates, draws, launches,
    reads back and empties the allocator's cache all through the captures
    neither fails them nor lands in them. It does what the port does
    everywhere: it draws from a generator of its own (torch ties its
    default CUDA generator to every capture, so a draw from that one on
    another thread during a capture raises) and empties the cache through
    ``step_graph.empty_cache``, which waits for captures (freeing device
    memory synchronises the device, which CUDA forbids while a stream
    captures)."""
    case = "granite_chunked"
    params = TM.init_model_params(_tcfg("granite"), 5, cuda)
    want = _served(case, "float32", params, cuda, graphs=False)[0]
    stop, errors, rounds = threading.Event(), [], [0]

    def busy():
        try:
            gen = torch.Generator(device=cuda).manual_seed(1)
            a = torch.randn(512, 512, device=cuda, generator=gen)
            while not stop.is_set():
                b = torch.randn(512, 512, device=cuda, generator=gen)
                float((a @ b).sum())
                SG.empty_cache()
                rounds[0] += 1
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    t = threading.Thread(target=busy)
    t.start()
    try:
        got, _, _, engine = _served(case, "float32", params, cuda, graphs=True)
    finally:
        stop.set()
        t.join()
    assert not errors and rounds[0] > 0
    assert got == want and engine.step_graphs.n_graphs >= 3


@pytest.mark.gpu
def test_memory_back_after_the_engine_is_dropped(cuda):
    cfg = _tcfg("granite", dtype="bfloat16")
    params = TM.init_model_params(cfg, 5, cuda)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    toks, spy, _, engine = _served("granite_chunked", "bfloat16", params,
                                   cuda, graphs=True)
    assert engine.step_graphs.n_graphs >= 3
    del engine, spy
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() - base < 64 << 20


@pytest.mark.gpu
@pytest.mark.parametrize("tie", [True, False])
def test_unembed_out_dtype_without_a_table_copy(cuda, tie):
    V, d, B = 49152, 2048, 8
    gen = torch.Generator(device=cuda).manual_seed(0)
    tok = torch.randn(V, d, device=cuda, generator=gen).to(torch.bfloat16)
    params = {"tok": tok}
    if not tie:
        params["head"] = torch.randn(d, V, device=cuda,
                                     generator=gen).to(torch.bfloat16)
    x = torch.randn(B, 1, d, device=cuda, generator=gen).to(torch.bfloat16)
    w = tok.t() if tie else params["head"]

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    TL.unembed(params, x, tie)                  # cuBLAS's state
    got, got_peak = peak(lambda: TL.unembed(params, x, tie))
    want, want_peak = peak(lambda: x.float() @ w.float())
    assert got.dtype == torch.float32 and got.shape == (B, 1, V)
    scale = (x.float().abs() @ w.float().abs()).amax()
    assert float((got - want).abs().max()) <= 1e-5 * float(scale)
    table32 = V * d * 4
    assert want_peak - got_peak >= table32 - (16 << 20), (want_peak, got_peak)
    assert got_peak < V * d * 2, "a copy of the table was made"


@pytest.mark.gpu
@pytest.mark.parametrize("tie", [False, True])
def test_unembed_backward_on_the_card(cuda, tie):
    """The bf16 unembedding under autograd (``_UnembedFn``) against
    autograd of the float32 upcast, the reference's arithmetic: float32
    logits within 1e-5, dx and dw within two bf16 roundings (the float32
    products summed over vocab chunks of 8192 in another order)."""
    g = torch.Generator().manual_seed(0)
    V, d = 20000, 256
    x = torch.randn(2, 7, d, generator=g).to(cuda, torch.bfloat16).requires_grad_()
    w = (torch.randn(V, d, generator=g) * 0.05).to(cuda, torch.bfloat16).requires_grad_()
    params = {"tok": w} if tie else {"head": w.t().detach().contiguous().requires_grad_()}
    leaf = params["tok"] if tie else params["head"]
    logits = TL.unembed(params, x, tie)
    assert logits.dtype == torch.float32 and logits.grad_fn is not None
    cot = torch.randn(logits.shape, generator=g).to(cuda)
    got = torch.autograd.grad(logits, (x, leaf), cot)
    xf, wf = x.detach().float().requires_grad_(), leaf.detach().float().requires_grad_()
    want_logits = xf @ (wf.t() if tie else wf)
    torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-5)
    want = torch.autograd.grad(want_logits, (xf, wf), cot)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.to(torch.bfloat16).float(),
                                   rtol=2 ** -7, atol=1e-6)
