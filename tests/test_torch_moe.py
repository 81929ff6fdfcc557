"""The MoE path of the port (K4 ``moe_gmm`` and ``moe_ffn``) against the
JAX package's, on the same numpy inputs and the same weights (via the
bridge), at a small size: llama4-scout and grok-1 ``.reduced()`` (d 256,
4 experts, top-1 and top-2), float32.

* the plain ``moe_gmm`` against JAX's ``ref.moe_gmm``,
  ``jax.lax.ragged_dot`` and the Pallas kernel in interpret mode, on
  empty groups, T = 1, all rows in one expert and 16 experts over 8 rows:
  float32 ``2e-5``, bfloat16 ``3e-2`` (``tests/test_kernels.py``'s
  tolerances; summation order, and one bf16 rounding of the output);
* ``moe_ffn`` output and aux loss within float32 ``1e-5`` with identical
  routing, a router tie included (the lower expert index wins, as
  ``jax.lax.top_k``);
* prefill and decode logits within ``1e-4`` through a chunk ring wrap
  (``chunk=8``, the schedule of ``tests/test_decode_consistency.py``);
* the port's paged engine token-exact against JAX's on the seeded
  schedules of ``tests/test_paged_engine.py``: llama4 whole-prompt
  prefill, grok-1 with chunked prefill (K1's chunk mode meets MoE).

The ``gpu`` case holds the CUDA kernel against its plain version on the
card and skips where there is none. JAX is imported inside the tests, so
that case also runs where JAX is not installed
(``python -m pytest -m gpu tests/test_torch_moe.py``).
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import moe_gmm as gm
from repro_torch.kernels import ops, ref
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.serve.engine import Request, ServingEngine

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 2e-5, BF16: 3e-2}
ARCHS = {"llama4": "llama4-scout-17b-a16e", "grok": "grok-1-314b"}
MAX_LEN = 64
LEN_PALETTE = (2, 3, 5, 9, 12, 15, 19, 27, 40)


def _cfgs(name, **kw):
    from repro.configs import get_config
    j = dataclasses.replace(get_config(ARCHS[name]).reduced(), **kw)
    t = dataclasses.replace(tget_config(ARCHS[name]).reduced(), **kw)
    return j, t


def _params(name, seed=0, **kw):
    import jax

    from repro.models import model as JM
    jcfg, tcfg = _cfgs(name, **kw)
    jp = JM.init_model_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, bridge.from_jax(jax.device_get(jp), device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------------------
# K4: the plain grouped matmul against JAX's three versions
# ----------------------------------------------------------------------
def _sizes_16_over_8():
    """8 rows over 16 experts, most groups empty (a decode step)."""
    return np.bincount(np.random.default_rng(16).integers(0, 16, 8),
                       minlength=16).tolist()


GMM_CASES = {
    "empty_groups": ([10, 0, 25, 5], 64, 32),
    "one_row": ([0, 1, 0], 32, 32),
    "one_expert": ([0, 0, 30, 0], 64, 64),
    "16_experts_8_rows": (_sizes_16_over_8(), 32, 64),
}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_moe_gmm_plain_matches_jax(case, dtype):
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.moe_gmm import moe_gmm as pallas_gmm
    sizes, K, N = GMM_CASES[case]
    T, E = sum(sizes), len(sizes)
    rng = np.random.default_rng(T + E)
    x = rng.standard_normal((T, K)).astype(np.float32)
    w = (0.1 * rng.standard_normal((E, K, N))).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    got = ops.moe_gmm(tx, tw, torch.from_numpy(gs))
    assert got.dtype == tx.dtype and got.shape == (T, N)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    wants = {
        "ref": jref.moe_gmm(jx, jw, gs),
        "ragged_dot": jax.lax.ragged_dot(jx, jw, jnp.asarray(gs)),
        "pallas": pallas_gmm(jx, jw, jnp.asarray(gs), interpret=True,
                             block_m=8, block_k=32, block_n=32),
    }
    for what, want in wants.items():
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=what)
    torch.testing.assert_close(ops.moe_gmm(tx, tw, torch.from_numpy(gs),
                                           impl="ref"), got)


def test_moe_gmm_plain_zeroes_rows_past_the_groups():
    """Rows no group covers come out zero, as ``ragged_dot`` leaves them."""
    x = torch.randn(9, 16)
    w = torch.randn(2, 16, 8)
    out = ref.moe_gmm(x, w, torch.tensor([3, 2], dtype=torch.int32))
    assert torch.equal(out[5:], torch.zeros(4, 8))
    torch.testing.assert_close(out[:3], x[:3] @ w[0])
    torch.testing.assert_close(out[3:5], x[3:5] @ w[1])


# ----------------------------------------------------------------------
# moe_ffn: routing, output and aux against JAX
# ----------------------------------------------------------------------
def _layer(params):
    """The first MoE layer's params (llama4 reduced has only rem/ layers,
    grok-1 reduced one stacked period axis)."""
    if "blocks" in params:
        return {k: v[0] for k, v in params["blocks"]["p0"].items()}
    return params["rem"]["r0"]


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_moe_ffn_matches_jax(name, tie):
    import jax
    import jax.numpy as jnp

    from repro.models import blocks as JB
    jcfg, tcfg, jp, tp = _params(name)
    jl, tl = _layer(jp), _layer(tp)
    if tie:   # every probability equal: top-k must be experts 0..k-1
        jl = dict(jl, router=jnp.zeros_like(jl["router"]))
        tl = dict(tl, router=torch.zeros_like(tl["router"]))
    h = np.random.default_rng(7).standard_normal((2, 7, tcfg.d_model))
    h = h.astype(np.float32)
    jout, jaux = JB.moe_ffn(jcfg, jl, jnp.asarray(h))
    tout, taux = TB.moe_ffn(tcfg, tl, torch.from_numpy(h))
    np.testing.assert_allclose(_f32(tout), _f32(jout), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)
    xf = h.reshape(-1, tcfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jl["router"].astype(jnp.float32),
                           axis=-1)
    _, jtop = jax.lax.top_k(probs, jcfg.top_k)
    _, _, ttop = TB.route(tcfg, tl, torch.from_numpy(xf))
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    if tie:
        assert (ttop.numpy() == np.arange(tcfg.top_k)).all()


def test_moe_specs_replace_the_mlp():
    jcfg, tcfg = _cfgs("grok")
    assert tcfg.n_moe_layers == jcfg.n_moe_layers == tcfg.n_layers
    specs = TB.attn_specs(tcfg)
    assert {"router", "we_g", "we_u", "we_d"} <= set(specs)
    assert not {"wg", "wu", "wd"} & set(specs)
    assert specs["we_d"].shape == (4, tcfg.d_ff, tcfg.d_model)
    assert specs["router"].scale == 0.02


# ----------------------------------------------------------------------
# model: prefill and decode logits through a chunk ring wrap
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_and_decode_logits_match_jax(name):
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    kw = dict(chunk=8) if name == "llama4" else {}
    jcfg, tcfg, jp, tp = _params(name, **kw)
    S, B = 6, 2
    total = S + 3 * 8
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, size=(B, total))
    toks = toks.astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                        cache_len=total)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S])},
                        cache_len=total)
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4)
    jdecode = jax.jit(lambda p, c, tok, pos: JM.decode_step(jcfg, p, c, tok, pos))
    for t in range(S, total):
        tok, pos = toks[:, t:t + 1], np.full((B,), t, np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4,
                                   err_msg=f"decode at {t}")


# ----------------------------------------------------------------------
# serving engine: token-exact against JAX's
# ----------------------------------------------------------------------
def schedule(seed, vocab, n=5, long_bias=False):
    """The reference suite's seeded request mix."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        palette = LEN_PALETTE[-3:] if long_bias and i % 2 else LEN_PALETTE
        length = rng.choice(palette)
        prompt = [rng.randrange(1, vocab) for _ in range(length)]
        out.append((prompt, rng.choice((3, 4, 6))))
    return out


def run(engine, sched, request_cls):
    reqs = [request_cls(prompt=list(p), max_new_tokens=m, req_id=i)
            for i, (p, m) in enumerate(sched)]
    done = engine.generate(reqs)
    assert all(r.done for r in reqs) and len(done) == len(reqs)
    assert engine.free_slots() == list(range(engine.max_slots))
    engine.allocator.check_invariants()
    assert engine.allocator.n_free == engine.num_pages - 1, "page leak"
    return {r.req_id: list(r.output) for r in done}


ENGINE_CASES = {
    # name: (arch, engine kwargs, schedule seeds, long_bias)
    "llama4_whole_prompt": ("llama4", {}, (0, 1), False),
    "grok_chunked": ("grok", dict(prefill_chunk=8), (11, 12), True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_paged_engine_token_exact(case):
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServingEngine as JEngine
    name, kw, seeds, long_bias = ENGINE_CASES[case]
    jcfg, tcfg, jp, tp = _params(name, seed=1)
    kw = dict(max_slots=2, max_len=MAX_LEN, page_size=16, **kw)
    jeng, teng = JEngine(jcfg, jp, **kw), ServingEngine(tcfg, tp, device="cpu", **kw)
    assert teng._chunk_ok == jeng._chunk_ok == ("prefill_chunk" in kw)
    for seed in seeds:
        sched = schedule(seed, tcfg.vocab, long_bias=long_bias)
        assert run(teng, sched, Request) == run(jeng, sched, JRequest), seed
    assert teng.stats() == jeng.stats()
    if teng._chunk_ok:
        assert teng.n_prefill_chunks > 0 and \
            teng.n_prefill_chunks == jeng.n_prefill_chunks


# ----------------------------------------------------------------------
# K4 on the card against its plain version
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("sizes,T,K,N", [
    ([10, 0, 25, 5], 40, 64, 32), ([0, 1, 0], 1, 32, 32),
    ([0, 0, 300, 0], 300, 256, 136), ([65, 63, 1, 0, 128], 257, 520, 200),
    (_sizes_16_over_8(), 8, 640, 1024),
    ([30, 20], 130, 64, 64),      # 50 of 130 rows: the other 80 are zero
    # the bf16 kernel's edges: T=1 and 8 over 16 experts, empty groups,
    # groups that end inside an m16 fragment, K and N off its 32-deep,
    # 128-wide tile, rows no group covers
    ([0] * 9 + [1] + [0] * 6, 1, 200, 200), (_sizes_16_over_8(), 8, 200, 200),
    ([5, 0, 11, 20, 3, 0], 45, 200, 200), ([70, 0, 9, 33], 120, 136, 264)])
def test_moe_gmm_kernel_matches_plain(cuda, sizes, T, K, N, dtype):
    rng = np.random.default_rng(T + K)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((len(sizes), K, N)) /
                          np.sqrt(K)).astype(np.float32))
    x, w = (t.to(cuda, getattr(torch, dtype)) for t in (x, w))
    # a block of the output's size filled with NaN and freed at once: the
    # caching allocator hands it back to the wrapper, so every row of the
    # output must be written
    torch.full((T, N), float("nan"), dtype=x.dtype, device=cuda)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    n = gm.moe_gmm.launches
    got = gm.moe_gmm(x, w, gs)
    torch.cuda.synchronize()
    assert gm.moe_gmm.launches == n + 1 and got.dtype == x.dtype
    assert torch.isfinite(got).all()
    want = ref.moe_gmm(x.float(), w.float(), gs).to(x.dtype)
    scale = max(want.float().abs().max().item(), 1.0)
    # float32: summation order; bf16: float32 sums taken in different
    # orders, each rounded once, can land one bf16 ulp apart
    tol = 2e-5 * scale if dtype == F32 else 2 ** -7 * scale
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.mark.gpu
def test_moe_gmm_wrapper_rejects_bad_operands(cuda):
    x = torch.zeros((4, 16), device=cuda)
    w = torch.zeros((2, 16, 8), device=cuda)
    gs = torch.tensor([2, 2], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                   # int64 group sizes
        gm.moe_gmm(x, w, gs.long())
    with pytest.raises(TypeError):                    # bf16 w, f32 x
        gm.moe_gmm(x, w.bfloat16(), gs)
    with pytest.raises(ValueError):                   # N not a multiple of 8
        gm.moe_gmm(x, torch.zeros((2, 16, 12), device=cuda), gs)
    with pytest.raises(ValueError):                   # group sizes on the host
        gm.moe_gmm(x, w, gs.cpu())
