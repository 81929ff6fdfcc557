"""The port's model against the JAX package's on the same weights (via the
bridge): logits within float32 ``1e-4`` for a full prefill, a 3-chunk
``prefill_chunk`` and 6 paged ``decode_step``s, on granite-3-2b reduced
(G = 1) and its GQA variant with one kv head (G = 4, hd = 64, full
granite's group and head size)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import model as TM
from repro_torch.models.param import iter_leaves

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

ATOL = 1e-4
PAGE, NUM_PAGES = 8, 12


def _cfgs(name):
    j = get_config("granite-3-2b").reduced()
    t = tget_config("granite-3-2b").reduced()
    if name == "gqa4":
        j, t = (dataclasses.replace(c, n_kv_heads=1) for c in (j, t))
    return j, t


@pytest.fixture(scope="module", params=["reduced", "gqa4"])
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = JM.init_model_params(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=ATOL,
                               err_msg=what)


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(1, 512, size=(1, n)).astype(np.int32)


def test_full_prefill_logits_and_cache(setup):
    jcfg, tcfg, jparams, tparams = setup
    toks = _tokens(21)
    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                        cache_len=32)
    tl, tc = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)},
                        cache_len=32)
    _close(tl, jl, "prefill logits")
    want = dict(iter_leaves(jax.device_get(jc)))
    for path, t in iter_leaves(tc):
        assert t.shape == want[path].shape, path
        _close(t, want[path], path)


def test_chunked_prefill_then_paged_decode(setup):
    jcfg, tcfg, jparams, tparams = setup
    toks = _tokens(21, seed=1)
    table = np.array([[3, 7, 1, 9, 0, 0, 0, 0],    # live sequence
                      [0, 0, 0, 0, 0, 0, 0, 0]],   # inactive row: scratch
                     np.int32)
    jcache = JM.init_paged_cache(jcfg, 1, 64, NUM_PAGES, PAGE)
    tcache = TM.init_paged_cache(tcfg, 1, 64, NUM_PAGES, PAGE, device="cpu")
    pos = 0
    for C in (8, 8, 5):                            # three chunks
        piece = toks[:, pos:pos + C]
        jl, jcache = JM.prefill_chunk(jcfg, jparams, jcache,
                                      jnp.asarray(piece),
                                      jnp.asarray(pos, jnp.int32),
                                      jnp.asarray(table[:1]))
        tl, tcache = TM.prefill_chunk(tcfg, tparams, tcache,
                                      torch.from_numpy(piece), pos,
                                      torch.from_numpy(table[:1]))
        _close(tl, jl, f"chunk at {pos}")
        pos += C
    # greedy continuation, teacher-forced on the reference's tokens, with a
    # second, inactive row (token 0 at position 0) riding along
    nxt = int(jnp.argmax(jl[0, -1]))
    for step in range(6):
        tok = np.array([[nxt], [0]], np.int32)
        p = np.array([pos + step, 0], np.int32)
        jl, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(p),
                                    block_tables=jnp.asarray(table))
        tl, tcache = TM.decode_step(tcfg, tparams, tcache,
                                    torch.from_numpy(tok), torch.from_numpy(p),
                                    block_tables=torch.from_numpy(table))
        _close(tl[0], jl[0], f"decode step {step}")
        nxt = int(jnp.argmax(jl[0, 0]))
    # the live pages hold the same K/V on both sides (page 0 is scratch)
    want = dict(iter_leaves(jax.device_get(jcache)))
    for path, t in iter_leaves(tcache):
        _close(t[:, 1:], want[path][:, 1:], path)


def test_one_chunk_equals_full_prefill(setup):
    """A single chunk covering the prompt reproduces whole-prompt prefill
    (the flash path and the paged chunk path agree)."""
    _, tcfg, _, tparams = setup
    toks = torch.from_numpy(_tokens(13, seed=2))
    full, _ = TM.prefill(tcfg, tparams, {"tokens": toks})
    cache = TM.init_paged_cache(tcfg, 1, 16, 4, PAGE, device="cpu")
    one, _ = TM.prefill_chunk(tcfg, tparams, cache, toks, 0,
                              torch.tensor([[1, 2]], dtype=torch.int32))
    torch.testing.assert_close(one, full, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    """rms_norm (1 + scale), rope (float32 frequencies), SiLU MLP, embed
    (x sqrt(d)) and unembed (float32 logits) on the same arrays."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(4)
    d, f, V = 64, 96, 50
    arr = {"x": rng.standard_normal((2, 5, d)), "s": rng.standard_normal(d),
           "q": rng.standard_normal((2, 5, 3, 32)),
           "wg": rng.standard_normal((d, f)) / 8, "wu": rng.standard_normal((d, f)) / 8,
           "wd": rng.standard_normal((f, d)) / 8, "tok": rng.standard_normal((V, d))}
    j = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in arr.items()}
    t = {k: torch.from_numpy(v.astype(np.float32)).to(getattr(torch, dtype))
         for k, v in arr.items()}
    pos = np.array([[0, 3, 7, 100, 2047]] * 2, np.int32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    pairs = [
        (TL.rms_norm(t["x"], t["s"]), JL.rms_norm(j["x"], j["s"])),
        (TL.rope(t["q"], torch.from_numpy(pos), 10_000.0),
         JL.rope(j["q"], jnp.asarray(pos), 10_000.0)),
        (TL.mlp(t, t["x"]), JL.mlp(j, j["x"])),
        (TL.embed(t, torch.tensor([[1, 7, 49]]), d),
         JL.embed(j, jnp.asarray([[1, 7, 49]]), d)),
        (TL.unembed(t, t["x"], True), JL.unembed(j, j["x"], True)),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == getattr(torch, str(want.dtype)), i
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol, err_msg=str(i))


# (config fields, a param leaf only that family has; a patch prefix adds
# no leaf)
FAMILY_VARIANTS = {
    "xlstm": (dict(pattern=("mlstm", "slstm")), "blocks/p1/r_gates"),
    "vlm": (dict(n_patches=16), "blocks/p0/wq"),
    "moe": (dict(n_experts=4, top_k=2, moe_every=1), "blocks/p0/we_g"),
    "encdec": (dict(n_encoder_layers=2, n_frames=16), "encoder/final_ln"),
}


@pytest.mark.parametrize("family", sorted(FAMILY_VARIANTS))
def test_family_variants_get_the_reference_trees(family):
    """granite given xLSTM blocks, a patch prefix, experts or an encoder:
    every family is ported, so each gets the reference's param and paged
    cache trees (no family raises)."""
    from repro.configs import BlockKind as JBlockKind
    from repro_torch.configs import BlockKind
    kw, leaf = FAMILY_VARIANTS[family]
    kw, jkw = dict(kw), dict(kw)
    if "pattern" in kw:
        kw["pattern"] = tuple(BlockKind(k) for k in kw["pattern"])
        jkw["pattern"] = tuple(JBlockKind(k) for k in jkw["pattern"])
    jcfg = dataclasses.replace(get_config("granite-3-2b").reduced(), **jkw)
    tcfg = dataclasses.replace(tget_config("granite-3-2b").reduced(), **kw)
    for specs in (lambda M, c: M.param_specs(c),
                  lambda M, c: M.paged_cache_specs(c, 1, 16, 3, PAGE)):
        want = {p: s.shape for p, s in iter_leaves(specs(JM, jcfg))}
        got = {p: s.shape for p, s in iter_leaves(specs(TM, tcfg))}
        assert got == want
    assert leaf in dict(iter_leaves(TM.param_specs(tcfg)))


def test_dense_decode_matches_jax(setup):
    """The dense per-slot decode (page_size=0's path, through K3's plain
    version) against the reference's, with the cache padded by prefill."""
    jcfg, tcfg, jparams, tparams = setup
    toks = _tokens(24, seed=3)
    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :18])},
                        cache_len=24)
    tl, tc = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :18])},
                        cache_len=24)
    for t in range(18, 24):
        p = np.array([t], np.int32)
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(p))
        tl, tc = TM.decode_step(tcfg, tparams, tc,
                                torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(p))
        _close(tl, jl, f"decode at {t}")
    want = dict(iter_leaves(jax.device_get(jc)))
    for path, t in iter_leaves(tc):
        _close(t, want[path], path)
