"""xLSTM in the port against the JAX package, on the same weights (via the
bridge): xlstm-350m ``.reduced()`` (3 layers: sLSTM, mLSTM, mLSTM; d 256,
4 heads, mLSTM inner 512 at head dim 128, sLSTM head dim 64, float32).

* the param, dense cache and paged cache spec trees equal the reference's
  (path, shape, init, scale, dtype), as registered and reduced;
* ``_mlstm_chunk_scan`` alone within ``1e-5``: S a multiple of the chunk
  and not (the padding), one chunk and several, from a zero state and
  from a drawn one; one ``_slstm_step`` within ``1e-5``;
* ``_mlstm_chunk_scan``'s gradient over a 256-token chunk: within 1e-4 of
  the reference's where that is finite, and finite where the reference's
  is not (its masked ``exp`` overflows past the diagonal);
* ``train`` logits, a 10-token ``prefill`` then 14 ``decode_step``s
  (logits and every state leaf), and a 21-token chunked prefill in chunks
  of 8 (against the reference's chunked prefill and the port's whole
  prefill) within ``1e-4``;
* a masked ``decode`` leaves idle rows' state bit-identical;
* the port's ``ServingEngine`` token-exact against the reference's on
  seeded schedules, paged, dense and chunked (``prefill_chunk`` 8), and
  the port's paged engine equal to its dense one;
* the launcher serves ``--arch xlstm-350m --reduced --backend engine``.
"""
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import blocks as JB
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models.param import iter_leaves
from repro_torch.serve.engine import Request, ServingEngine

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

ARCH = "xlstm-350m"
ATOL = 1e-4
SCAN_ATOL = 1e-5
MAX_LEN = 64
LEN_PALETTE = (2, 3, 5, 9, 12, 15, 19, 27, 40)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = get_config(ARCH).reduced(), tget_config(ARCH).reduced()
    jp = JM.init_model_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, bridge.from_jax(jax.device_get(jp), device="cpu")


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=atol,
                               err_msg=what)


def _specs(tree):
    return {p: (tuple(s.shape), s.init, s.scale, s.dtype)
            for p, s in iter_leaves(tree)}


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------
@pytest.mark.parametrize("size", ["registered", "reduced"])
@pytest.mark.parametrize("which", ["params", "dense cache", "paged cache"])
def test_spec_trees_equal_reference(which, size):
    jcfg, tcfg = get_config(ARCH), tget_config(ARCH)
    if size == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    if which == "params":
        want, got = JM.param_specs(jcfg), TM.param_specs(tcfg)
    elif which == "dense cache":
        want, got = JM.cache_specs(jcfg, 3, 24), TM.cache_specs(tcfg, 3, 24)
    else:
        want = JM.paged_cache_specs(jcfg, 3, 24, 9, 8)
        got = TM.paged_cache_specs(tcfg, 3, 24, 9, 8)
    assert _specs(got) == _specs(want)
    if which != "params":
        # no attention: every leaf is per-slot float32 state
        assert {s[3] for s in _specs(got).values()} == {"float32"}
    if size == "registered" and which == "dense cache":
        di = 2 * tcfg.d_model
        assert _specs(got)["blocks/p1/C"][0] == (3, 3, 4, di // 4, di // 4)


# ----------------------------------------------------------------------
# the scans alone
# ----------------------------------------------------------------------
def _scan_inputs(S, drawn_state, seed=0, B=2, nh=2, hd=8):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    q, k, v = (f(B, S, nh, hd) * hd ** -0.5 for _ in range(3))
    ig = f(B, S, nh)
    fg = np.log(1.0 / (1.0 + np.exp(-(f(B, S, nh) + 1.0)))).astype(np.float32)
    if drawn_state:
        state = (f(B, nh, hd, hd), f(B, nh, hd), f(B, nh))
    else:
        state = (np.zeros((B, nh, hd, hd), np.float32),
                 np.zeros((B, nh, hd), np.float32), np.zeros((B, nh), np.float32))
    return (q, k, v, ig, fg), state


@pytest.mark.parametrize("drawn_state", [False, True], ids=["zero", "drawn"])
@pytest.mark.parametrize("S,chunk", [(16, 8), (21, 8), (21, 32), (5, 8)],
                         ids=["multiple", "ragged", "one-chunk", "short"])
def test_mlstm_chunk_scan_matches_reference(S, chunk, drawn_state):
    xs, state = _scan_inputs(S, drawn_state)
    jh, jstate = JB._mlstm_chunk_scan(*map(jnp.asarray, xs),
                                      tuple(map(jnp.asarray, state)), chunk)
    th, tstate = TB._mlstm_chunk_scan(*map(torch.from_numpy, xs),
                                      tuple(map(torch.from_numpy, state)), chunk)
    assert tuple(th.shape) == jh.shape == xs[0].shape
    _close(th, jh, "h", SCAN_ATOL)
    for name, t, j in zip("Cnm", tstate, jstate):
        _close(t, j, name, SCAN_ATOL)


@pytest.mark.parametrize("fg_bias,overflows", [(3.0, False), (-1.0, True)],
                         ids=["slow-forget", "fast-forget"])
def test_mlstm_chunk_scan_gradient(fg_bias, overflows):
    """The gradient of one 256-token chunk's output: within 1e-4 (of the
    largest) of the reference's where that is finite; with fast forget
    gates, past the diagonal the reference's ``exp(logw)`` overflows before
    its mask, and its gradient is non-finite (0 x inf), where the port,
    which masks before the exp (the same values), stays finite."""
    rng = np.random.default_rng(7)
    B, S, nh, hd = 1, 256, 2, 8
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    q, k, v = 0.3 * f(B, S, nh, hd), 0.3 * f(B, S, nh, hd), f(B, S, nh, hd)
    ig = f(B, S, nh)
    fg = -np.logaddexp(0.0, -(f(B, S, nh) + fg_bias)).astype(np.float32)
    state = (np.zeros((B, nh, hd, hd), np.float32), np.zeros((B, nh, hd), np.float32),
             np.zeros((B, nh), np.float32))
    want = jax.grad(lambda *xs: JB._mlstm_chunk_scan(
        *xs, tuple(map(jnp.asarray, state)), S)[0].sum(), argnums=tuple(range(5)))(
        *map(jnp.asarray, (q, k, v, ig, fg)))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, ig, fg)]
    TB._mlstm_chunk_scan(*xs, tuple(map(torch.from_numpy, state)), S)[0].sum().backward()
    for name, x, w in zip(("q", "k", "v", "ig", "fg"), xs, want):
        g = x.grad.numpy()
        assert np.isfinite(g).all(), name
        if overflows:
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()), err_msg=name)
    assert overflows == (not all(np.isfinite(np.asarray(w)).all() for w in want))


def test_slstm_step_matches_reference():
    rng = np.random.default_rng(3)
    B, nh, hd = 2, 4, 16
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    carry = (f(B, nh, hd), np.abs(f(B, nh, hd)) + 0.5, f(B, nh, hd), f(B, nh, hd))
    pre, r = f(B, nh, 4, hd), 0.1 * f(nh, hd, 4 * hd)
    want = JB._slstm_step({"r_gates": jnp.asarray(r)},
                          tuple(map(jnp.asarray, carry)), jnp.asarray(pre))
    got = TB._slstm_step(torch.from_numpy(r), tuple(map(torch.from_numpy, carry)),
                         torch.from_numpy(pre))
    for name, t, j in zip(TB.SLSTM_STATE, got, want):
        _close(t, j, name, SCAN_ATOL)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
def _tokens(B, n, seed, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=(B, n)).astype(np.int32)


def test_train_logits_match_reference(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(2, 20, 2, tcfg.vocab)
    jl, _, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, mode="train")
    tl, cache = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)}, mode="train")
    assert cache is None and tuple(tl.shape) == jl.shape
    _close(tl, jl, "train logits")


def test_prefill_then_decode_match_reference(setup):
    """A 10-token prefill, then 14 decode steps: logits at every step and
    every state leaf after the last within 1e-4."""
    jcfg, tcfg, jp, tp = setup
    S, B, total = 10, 2, 24
    toks = _tokens(B, total, 1, tcfg.vocab)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])}, cache_len=total)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S])},
                        cache_len=total)
    _close(tl, jl, "prefill logits")
    want = dict(iter_leaves(jax.device_get(jc)))
    assert set(dict(iter_leaves(tc))) == set(want)
    for path, t in iter_leaves(tc):
        _close(t, want[path], f"prefill {path}")
    jdecode = jax.jit(lambda p, c, tok, pos: JM.decode_step(jcfg, p, c, tok, pos))
    for t in range(S, total):
        tok, pos = toks[:, t:t + 1], np.full((B,), t, np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        _close(tl, jl, f"decode at {t}")
    want = dict(iter_leaves(jax.device_get(jc)))
    for path, t in iter_leaves(tc):
        assert t.dtype == torch.float32, path
        _close(t, want[path], f"decode {path}")


def test_chunked_prefill_matches_reference_and_whole_prefill(setup):
    """21 tokens in chunks of 8 (the last ragged): each chunk's logits
    against the reference's chunked prefill; the last logits and the state
    against the port's own whole prefill."""
    jcfg, tcfg, jp, tp = setup
    assert TM.chunked_prefill_supported(tcfg)
    toks = torch.from_numpy(_tokens(1, 21, 3, tcfg.vocab))
    full_logits, full = TM.prefill(tcfg, tp, {"tokens": toks}, cache_len=32)
    cache = TM.init_cache(tcfg, 1, 32, device="cpu")
    jcache = JM.init_cache(jcfg, 1, 32)
    bt = torch.zeros((1, 2), dtype=torch.int32)  # no attention: table unused
    for pos in range(0, 21, 8):
        piece = toks[:, pos:pos + 8]
        logits, cache = TM.prefill_chunk(tcfg, tp, cache, piece, pos, bt)
        jl, jcache = JM.prefill_chunk(jcfg, jp, jcache, jnp.asarray(piece.numpy()),
                                      jnp.asarray(pos, jnp.int32), jnp.asarray(bt.numpy()))
        _close(logits, jl, f"chunk at {pos} vs JAX")
    want = dict(iter_leaves(jax.device_get(jcache)))
    for path, t in iter_leaves(cache):
        _close(t, want[path], f"chunked {path} vs JAX")
    torch.testing.assert_close(logits, full_logits, atol=ATOL, rtol=ATOL)
    for (path, a), (_, b) in zip(iter_leaves(cache), iter_leaves(full)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=ATOL, msg=path)


def test_decode_mask_keeps_idle_rows(setup):
    """Rows outside ``mask`` keep every mLSTM and sLSTM state leaf bit for
    bit; rows inside it move."""
    _, tcfg, _, tp = setup
    cache = TM.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _, leaf in iter_leaves(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = {p: t.clone() for p, t in iter_leaves(cache)}
    TM.decode_step(tcfg, tp, cache, torch.tensor([[5], [0]]),
                   torch.tensor([9, 0], dtype=torch.int32),
                   mask=torch.tensor([True, False]))
    for path, t in iter_leaves(cache):
        ax = TM.slot_batch_axis(path)
        assert torch.equal(t.select(ax, 1), before[path].select(ax, 1)), path
        assert not torch.equal(t.select(ax, 0), before[path].select(ax, 0)), path


# ----------------------------------------------------------------------
# serving engines
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
    if engine.paged:
        engine.allocator.check_invariants()
        assert engine.allocator.n_free == engine.num_pages - 1, "page leak"
    return {r.req_id: list(r.output) for r in done}


LAYOUTS = {"paged": dict(page_size=16), "dense": dict(page_size=0),
           "chunked": dict(page_size=16, prefill_chunk=8)}


@pytest.fixture(scope="module")
def engines(setup):
    jcfg, tcfg, jp, tp = setup
    out = {}
    for name, kw in LAYOUTS.items():
        kw = dict(max_slots=2, max_len=MAX_LEN, **kw)
        out[name] = (JEngine(jcfg, jp, **kw),
                     ServingEngine(tcfg, tp, device="cpu", **kw))
    return out


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_token_exact(engines, layout, seed):
    jeng, teng = engines[layout]
    sched = schedule(seed, teng.cfg.vocab, long_bias=layout == "chunked")
    assert run(teng, sched, Request) == run(jeng, sched, JRequest)
    assert teng.stats() == jeng.stats()
    if teng.paged:
        assert not teng._pooled         # no attention: nothing is pooled
    if layout == "chunked":
        assert teng.n_prefill_chunks > 0


def test_paged_engine_equals_dense_engine(setup):
    """The port alone: the paged layout (no pooled leaf: xLSTM has no
    attention) gives the dense layout's tokens, without chunks."""
    _, tcfg, _, tp = setup
    sched = schedule(7, tcfg.vocab)
    outs = [run(ServingEngine(tcfg, tp, device="cpu", max_slots=2, max_len=MAX_LEN,
                              page_size=ps), sched, Request) for ps in (16, 0)]
    assert outs[0] == outs[1]


def test_launcher_serves_xlstm(capsys):
    assert tserve.main(["--arch", ARCH, "--reduced", "--backend", "engine",
                        "--device", "cpu", "--events", "2",
                        "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "2/2 events served" in out
    counts = re.findall(r"tokens=(\d+)", out)
    assert counts and set(counts) == {"6"}, out
