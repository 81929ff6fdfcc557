"""The port's ServingEngine against the JAX package's, token for token
under greedy decoding, on the seeded schedules of
``tests/test_paged_engine.py``: plain paged, chunked prefill and
tight-pool eviction, with the allocator's invariants checked after every
run, and the dense per-slot layout (``page_size=0``, decode through K3)
against both the port's paged engine and JAX's dense one. Both sides get
the same weights through the bridge. The sampled
path keeps the reference's properties (reproducible per attempt, fresh per
new attempt, varying with position); its draws are not JAX's bits."""
import dataclasses
import random

import jax
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.serve.engine import Request, ServingEngine

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

JCFG = get_config("granite-3-2b").reduced()
TCFG = tget_config("granite-3-2b").reduced()
MAX_LEN = 64
LEN_PALETTE = (2, 3, 5, 9, 12, 15, 19, 27, 40)


@pytest.fixture(scope="module")
def params():
    jp = JM.init_model_params(JCFG, jax.random.PRNGKey(0))
    return jp, bridge.from_jax(jax.device_get(jp), device="cpu")


def schedule(seed, n=5, long_bias=False):
    """The reference suite's seeded request mix."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        palette = LEN_PALETTE[-3:] if long_bias and i % 2 else LEN_PALETTE
        length = rng.choice(palette)
        prompt = [rng.randrange(1, JCFG.vocab) for _ in range(length)]
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


def pair(params, jcfg=JCFG, tcfg=TCFG, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    jp, tp = params
    return (JEngine(jcfg, jp, page_size=16, **kw),
            ServingEngine(tcfg, tp, page_size=16, device="cpu", **kw))


@pytest.fixture(scope="module")
def paged(params):
    return pair(params)


@pytest.fixture(scope="module")
def chunked(params):
    return pair(params, prefill_chunk=8)


@pytest.fixture(scope="module")
def tight(params):
    # 3 pool pages for 2 slots: decode growth exhausts the pool
    return pair(params, kv_pool_tokens=48)


@pytest.mark.parametrize("seed", range(3))
def test_paged_token_exact(paged, seed):
    jeng, teng = paged
    sched = schedule(seed)
    assert run(teng, sched, Request) == run(jeng, sched, JRequest)


@pytest.mark.parametrize("seed", range(2))
def test_chunked_token_exact(chunked, seed):
    jeng, teng = chunked
    sched = schedule(100 + seed, long_bias=True)
    before = teng.n_prefill_chunks
    assert run(teng, sched, Request) == run(jeng, sched, JRequest)
    assert teng.n_prefill_chunks > before, "no prompt actually chunked"
    assert teng.n_prefill_chunks - before == jeng.n_prefill_chunks - before


def test_eviction_token_exact(tight):
    jeng, teng = tight
    sched = [([k + 1] * 15, 6) for k in range(3)]
    before = teng.n_evictions
    assert run(teng, sched, Request) == run(jeng, sched, JRequest)
    assert teng.n_evictions > before, "pool pressure never preempted"
    assert teng.stats() == jeng.stats()


def test_gqa_chunked_token_exact():
    """G = 4, hd = 64 (full granite's group and head size)."""
    jcfg = dataclasses.replace(JCFG, n_kv_heads=1)
    tcfg = dataclasses.replace(TCFG, n_kv_heads=1)
    jp = JM.init_model_params(jcfg, jax.random.PRNGKey(1))
    params = (jp, bridge.from_jax(jax.device_get(jp), device="cpu"))
    jeng, teng = pair(params, jcfg, tcfg, prefill_chunk=8)
    sched = schedule(7, long_bias=True)
    assert run(teng, sched, Request) == run(jeng, sched, JRequest)


def test_admit_step_surface_and_ttft(params):
    _, teng = pair(params)
    r1 = Request(prompt=[1, 5, 9], max_new_tokens=3, req_id=0)
    r2 = Request(prompt=[1, 7], max_new_tokens=3, req_id=1)
    r3 = Request(prompt=[1, 2, 3], max_new_tokens=3, req_id=2)
    assert teng.admit(r1) and teng.admit(r2)
    assert not teng.admit(r3)           # both slots busy
    for _ in range(64):
        teng.step()
        if r1.done and r2.done:
            break
    assert r1.done and r2.done
    assert teng.admit(r3)
    teng.generate([])                   # drain
    assert r3.done and len(r3.output) == 3
    assert all(r.t_first >= r.t_submit for r in (r1, r2, r3))
    assert len(teng.ttft_s) == 3 and teng.decode_s > 0
    s = teng.stats()
    assert s["paged"] == 1 and s["pages_free"] == s["n_pages"]


def test_submit_rejects_impossible_requests(tight):
    _, teng = tight
    with pytest.raises(ValueError):     # 60-token footprint > 3 pages
        teng.submit(Request(prompt=[1] * 40, max_new_tokens=20, req_id=0))
    with pytest.raises(ValueError):     # prompt alone exceeds max_len
        teng.submit(Request(prompt=[1] * MAX_LEN, max_new_tokens=1, req_id=1))
    assert not teng.waiting


@pytest.fixture(scope="module")
def dense(params):
    jp, tp = params
    kw = dict(max_slots=2, max_len=MAX_LEN, page_size=0)
    return JEngine(JCFG, jp, **kw), ServingEngine(TCFG, tp, device="cpu", **kw)


def test_dense_layout_needs_k3(params, monkeypatch):
    """The dense layout decodes through K3 (``decode_attention``) and never
    through the paged kernel K1."""
    from repro_torch.kernels import ops
    calls = {"decode": 0, "paged": 0}
    for name, key in (("decode_attention", "decode"),
                      ("paged_decode_attention", "paged")):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    eng = ServingEngine(TCFG, params[1], max_slots=2, max_len=MAX_LEN,
                        page_size=0, device="cpu")
    run(eng, schedule(5, n=2), Request)
    assert calls["paged"] == 0
    assert calls["decode"] == eng.n_decode_steps * TCFG.n_layers > 0
    assert eng.stats()["paged"] == 0


# the paged engine each schedule runs on, and the schedule
DENSE_CASES = {
    "plain": ("paged", lambda: schedule(1)),
    "chunked": ("chunked", lambda: schedule(101, long_bias=True)),
    "tight": ("tight", lambda: [([k + 1] * 15, 6) for k in range(3)]),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_layout_token_exact(dense, case, request):
    """Dense == the port's paged engine == JAX's dense engine."""
    jdense, tdense = dense
    fixture, make = DENSE_CASES[case]
    sched = make()
    want = run(tdense, sched, Request)
    assert want == run(jdense, sched, JRequest)
    assert run(request.getfixturevalue(fixture)[1], sched, Request) == want
    assert tdense.stats() == jdense.stats()


# ----------------------------------------------------------------------
# sampled path: (seed, req_id, attempt, position) keys the draw
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def sampled(params):
    return ServingEngine(TCFG, params[1], max_slots=2, max_len=MAX_LEN,
                         greedy=False, sample_seed=7, device="cpu")


def test_sampled_stream_reproducible(sampled):
    sched = schedule(42, n=3)
    assert run(sampled, sched, Request) == run(sampled, sched, Request)


def test_redelivery_draws_fresh_randomness(sampled):
    def go(attempt):
        r = Request(prompt=[3, 1, 4, 1, 5], max_new_tokens=8, req_id=9,
                    attempt=attempt)
        sampled.generate([r])
        return list(r.output)
    assert go(0) == go(0)               # same attempt: reproducible
    assert go(0) != go(1)               # new attempt: fresh draws


def test_sampling_varies_with_position_and_attempt(sampled):
    uniform = torch.zeros((TCFG.vocab,))
    req = Request(prompt=[1, 2], max_new_tokens=8, req_id=5)
    draws = []
    for _ in range(6):
        draws.append(sampled._sample_token(uniform, req))
        req.output.append(0)
    assert len(set(draws)) > 1
    by_attempt = {sampled._sample_token(
        uniform, Request(prompt=[1], max_new_tokens=1, req_id=5, attempt=a))
        for a in range(6)}
    assert len(by_attempt) > 1


def test_eviction_resume_replays_sampled_stream(params):
    """A preempted request re-prefills and, keyed on the same attempt and
    positions, draws the same tokens it would have drawn unpreempted."""
    kw = dict(max_slots=2, max_len=MAX_LEN, greedy=False, sample_seed=3,
              device="cpu")
    sched = [([k + 1] * 15, 6) for k in range(3)]
    roomy = ServingEngine(TCFG, params[1], **kw)
    tight = ServingEngine(TCFG, params[1], kv_pool_tokens=48, **kw)
    want = run(roomy, sched, Request)
    assert run(tight, sched, Request) == want
    assert tight.n_evictions > 0
