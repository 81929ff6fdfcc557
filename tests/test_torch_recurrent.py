"""recurrentgemma in the port against the JAX package, on the same weights
(via the bridge), at a small size: one (RG-LRU, RG-LRU, LOCAL_ATTN) period
plus two remainder RG-LRU layers, G = 4, hd 64, float32, and a window of 8
so the ring cache wraps during prefill and decode.

* logits within float32 ``1e-4`` for a prefill and ``3 * window`` decode
  steps through ring wrap (the schedule of
  ``tests/test_decode_consistency.py``), on the sliding-window model and a
  chunked-attention variant;
* RG-LRU chunked prefill continues the state: logits and state within
  ``1e-4`` of whole prefill (``tests/test_paged_engine.py``);
* the port's paged and dense engines token-exact against JAX's under
  greedy decoding on the seeded schedules of ``tests/test_paged_engine.py``,
  with the allocator's invariants checked after every run;
* a decode step leaves the per-slot leaves of rows outside its mask
  unchanged.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import BlockKind as JBlockKind
from repro.configs import get_config
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import BlockKind
from repro_torch.configs import get_config as tget_config
from repro_torch.models import model as TM
from repro_torch.models.param import iter_leaves
from repro_torch.serve.engine import Request, ServingEngine

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

ATOL = 1e-4
MAX_LEN = 64
LEN_PALETTE = (2, 3, 5, 9, 12, 15, 19, 27, 40)
R, C = BlockKind.RGLRU, BlockKind.CHUNKED_ATTN

VARIANTS = {
    # 1 period + 2 remainder layers; the window of 8 wraps the ring
    "local": dict(n_layers=5, window=8),
    "chunked": dict(n_layers=5, window=0, chunk=8, pattern=(R, R, C)),
    "rglru": dict(n_layers=2, pattern=(R,)),
}


def _cfgs(name):
    kw = VARIANTS[name]
    jkw = dict(kw)
    if "pattern" in kw:
        jkw["pattern"] = tuple(JBlockKind(k.value) for k in kw["pattern"])
    return (dataclasses.replace(get_config("recurrentgemma-2b").reduced(), **jkw),
            dataclasses.replace(tget_config("recurrentgemma-2b").reduced(), **kw))


def _params(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    jp = JM.init_model_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, bridge.from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def rg():
    return _params("local")


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=ATOL,
                               err_msg=what)


# ----------------------------------------------------------------------
# model: prefill and decode through ring wrap
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["local", "chunked"])
def test_prefill_and_decode_through_ring_wrap(name):
    jcfg, tcfg, jp, tp = _params(name)
    S, B = 6, 2
    total = S + 3 * 8
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, size=(B, total))
    toks = toks.astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                        cache_len=total)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :S])},
                        cache_len=total)
    _close(tl, jl, "prefill logits")
    want = dict(iter_leaves(jax.device_get(jc)))
    got = dict(iter_leaves(tc))
    assert set(got) == set(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape and \
            str(t.dtype).endswith(str(want[path].dtype)), path
        _close(t, want[path], path)
    jdecode = jax.jit(lambda p, c, tok, pos: JM.decode_step(jcfg, p, c, tok, pos))
    for t in range(S, total):
        tok, pos = toks[:, t:t + 1], np.full((B,), t, np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        _close(tl, jl, f"decode at {t}")
    for path, t in iter_leaves(tc):
        _close(t, dict(iter_leaves(jax.device_get(jc)))[path], path)


def test_ring_prefill_longer_than_window(rg):
    """A 21-token prompt into an 8-slot ring: the last 8 positions live at
    slot p % 8, as the reference scatters them."""
    jcfg, tcfg, jp, tp = rg
    toks = np.random.default_rng(2).integers(1, 512, size=(1, 21)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=64)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        cache_len=64)
    _close(tl, jl, "logits")
    assert tc["blocks"]["p2"]["k"].shape == (1, 1, 8, 1, 64)
    _close(tc["blocks"]["p2"]["k"], jc["blocks"]["p2"]["k"], "ring k")


def test_rglru_chunked_state_matches_full_prefill():
    jcfg, tcfg, jp, tp = _params("rglru")
    assert TM.chunked_prefill_supported(tcfg)
    rng = random.Random(3)
    toks = torch.tensor([[rng.randrange(1, tcfg.vocab) for _ in range(21)]])
    full_logits, full = TM.prefill(tcfg, tp, {"tokens": toks}, cache_len=32)
    cache = TM.init_cache(tcfg, 1, 32, device="cpu")
    jcache = JM.init_cache(jcfg, 1, 32)
    bt = torch.zeros((1, 2), dtype=torch.int32)  # no attention: table unused
    for pos in range(0, 21, 8):
        piece = toks[:, pos:pos + 8]
        logits, cache = TM.prefill_chunk(tcfg, tp, cache, piece, pos, bt)
        jl, jcache = JM.prefill_chunk(jcfg, jp, jcache,
                                      jnp.asarray(piece.numpy()),
                                      jnp.asarray(pos, jnp.int32),
                                      jnp.asarray(bt.numpy()))
        _close(logits, jl, f"chunk at {pos} vs JAX")
    torch.testing.assert_close(logits, full_logits, atol=ATOL, rtol=ATOL)
    for (path, a), (_, b) in zip(iter_leaves(cache), iter_leaves(full)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=ATOL, msg=path)


def test_decode_mask_keeps_idle_rows(rg):
    """Rows outside ``mask`` keep their h, conv and ring leaves."""
    _, tcfg, _, tp = rg
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
# serving engines: the port's paged and dense layouts against JAX's
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


def _pair(params, page_size, **kw):
    jcfg, tcfg, jp, tp = params
    kw = dict(max_slots=2, max_len=MAX_LEN, page_size=page_size, **kw)
    return JEngine(jcfg, jp, **kw), ServingEngine(tcfg, tp, device="cpu", **kw)


@pytest.fixture(scope="module")
def paged(rg):
    return _pair(rg, 16)


@pytest.fixture(scope="module")
def dense(rg):
    return _pair(rg, 0)


@pytest.mark.parametrize("seed", range(3))
def test_paged_engine_token_exact(paged, seed):
    jeng, teng = paged
    sched = schedule(seed, teng.cfg.vocab)
    assert run(teng, sched, Request) == run(jeng, sched, JRequest)
    assert teng.stats() == jeng.stats()


@pytest.mark.parametrize("seed", range(3))
def test_dense_engine_token_exact(dense, seed):
    jeng, teng = dense
    sched = schedule(seed, teng.cfg.vocab)
    assert run(teng, sched, Request) == run(jeng, sched, JRequest)
    assert teng.stats() == jeng.stats() and teng.stats()["paged"] == 0


def test_chunked_rglru_engine_token_exact():
    """Chunked prefill of an RG-LRU model: mid-prefill slots ride along in
    other slots' decode steps, masked, and keep their state."""
    jeng, teng = _pair(_params("rglru", seed=1), 16, prefill_chunk=8)
    sched = schedule(11, teng.cfg.vocab, long_bias=True)
    assert run(teng, sched, Request) == run(jeng, sched, JRequest)
    assert teng.n_prefill_chunks > 0 and \
        teng.n_prefill_chunks == jeng.n_prefill_chunks


def test_idle_slot_state_survives_decode(rg):
    """A finished request's slot rides along in the next decode steps as an
    idle row; its per-slot leaves do not change."""
    _, teng = _pair(rg, 16)
    short = Request(prompt=[3, 1, 4], max_new_tokens=2, req_id=0)
    long = Request(prompt=[1, 5, 9, 2, 6], max_new_tokens=6, req_id=1)
    assert teng.admit(short) and teng.admit(long)
    while not short.done:
        teng.step()
    idle = 0
    snap = {p: t.select(TM.slot_batch_axis(p), idle).clone()
            for p, t in iter_leaves(teng.cache)}
    teng.step()
    assert not long.done
    for path, t in iter_leaves(teng.cache):
        assert torch.equal(t.select(TM.slot_batch_axis(path), idle),
                           snap[path]), path
    teng.generate([])
