"""The port's encoder-decoder (whisper) against the JAX package's on the
same weights: whisper-tiny ``.reduced()`` (2 + 2 layers, d 256, 4 heads,
hd 64, 16 frames) with its QKV biases drawn non-zero from a seed (the
specs start them at zero, which would hide a path that drops them), handed
to the port through the bridge. Param, dense cache and paged cache trees
equal the reference's path for path and shape for shape; ``train`` logits
with frames, ``prefill`` logits and its self and cross K/V cache, and six
``decode_step``s on the dense cache within float32 ``1e-4``; the frames
change the logits; chunked prefill raises; the serving engine and
``make_serve_runtime`` refuse the family at construction. The bridge
carries whisper-tiny's registered tree (bf16) exactly."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import model as TM
from repro_torch.models.param import iter_leaves
from repro_torch.serve.api import make_serve_runtime
from repro_torch.serve.engine import ServingEngine

torch.set_num_threads(1)

ATOL = 1e-4
S, CACHE_LEN, STEPS = 8, 16, 6


def _set_biases(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _set_biases(val, rng)
        elif key in ("bq", "bk", "bv"):
            tree[key] = (0.5 * rng.standard_normal(val.shape)).astype(val.dtype)


@pytest.fixture(scope="module")
def setup():
    jcfg = get_config("whisper-tiny").reduced()
    tcfg = tget_config("whisper-tiny").reduced()
    jparams = jax.tree_util.tree_map(
        np.asarray, jax.device_get(JM.init_model_params(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(5)
    _set_biases(jparams, rng)
    tparams = bridge.from_jax(jparams, device="cpu")
    toks = rng.integers(1, jcfg.vocab, size=(2, S)).astype(np.int32)
    frames = rng.standard_normal((2, jcfg.n_frames, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, toks, frames


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=ATOL,
                               err_msg=what)


def _shapes(tree):
    return {p: tuple(s.shape) for p, s in iter_leaves(tree)}


@pytest.mark.parametrize("which", ["params", "dense cache", "paged cache"])
def test_trees_equal_reference(setup, which):
    jcfg, tcfg = setup[:2]
    if which == "params":
        want, got = JM.param_specs(jcfg), TM.param_specs(tcfg)
        assert {"encoder/blocks/wq", "encoder/final_ln",
                "blocks/p0/c_wq", "blocks/p0/c_ln"} <= set(_shapes(got))
    elif which == "dense cache":
        want, got = JM.cache_specs(jcfg, 3, 24), TM.cache_specs(tcfg, 3, 24)
    else:
        want = JM.paged_cache_specs(jcfg, 3, 24, 9, 8)
        got = TM.paged_cache_specs(tcfg, 3, 24, 9, 8)
        flags = dict(zip(_shapes(got), TM.paged_leaf_flags(
            tcfg, TM.init_paged_cache(tcfg, 3, 24, 9, 8, device="cpu"))))
        assert flags == {"blocks/p0/c_k": False, "blocks/p0/c_v": False,
                         "blocks/p0/k": True, "blocks/p0/v": True}
    assert _shapes(got) == _shapes(want)


def test_bridge_carries_the_registered_tree():
    """whisper-tiny as registered (4 + 4 layers, d 384, vocab 51865 padded;
    bf16): a reference-shaped tree crosses the bridge bit for bit."""
    cfg = get_config("whisper-tiny")
    rng = np.random.default_rng(0)
    tree = {}
    for path, spec in iter_leaves(JM.param_specs(cfg)):
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = rng.standard_normal(spec.shape, np.float32).astype(
            ml_dtypes.bfloat16)
    tparams = bridge.from_jax(tree, device="cpu")
    assert _shapes(tparams) == _shapes(TM.param_specs(tget_config("whisper-tiny")))
    assert {t.dtype for _, t in iter_leaves(tparams)} == {torch.bfloat16}
    back = dict(iter_leaves(bridge.to_numpy(tparams)))
    for path, arr in iter_leaves(tree):
        np.testing.assert_array_equal(back[path], arr.astype(np.float32), path)


def test_train_forward_matches_reference(setup):
    jcfg, tcfg, jparams, tparams, toks, frames = setup
    want, _, _ = JM.forward(jcfg, jparams, {"tokens": toks, "frames": frames})
    got, cache = TM.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                            "frames": torch.from_numpy(frames)},
                            mode="train")
    assert cache is None and tuple(got.shape) == (2, S, jcfg.padded_vocab)
    _close(got, want, "train logits")


def test_prefill_then_six_decode_steps_match_reference(setup):
    jcfg, tcfg, jparams, tparams, toks, frames = setup
    jl, jcache = JM.prefill(jcfg, jparams, {"tokens": toks, "frames": frames},
                            cache_len=CACHE_LEN)
    tl, tcache = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                            "frames": torch.from_numpy(frames)},
                            cache_len=CACHE_LEN)
    _close(tl, jl, "prefill logits")
    want = dict(iter_leaves(jax.device_get(jcache)))
    assert _shapes(tcache) == {p: w.shape for p, w in want.items()}
    for path, t in iter_leaves(tcache):
        _close(t, want[path], path)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for i in range(STEPS):
        pos = np.full((2,), S + i, np.int32)
        jl, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(tcfg, tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        _close(tl, jl, f"decode step {i}")
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    # decode reads the cross K/V, it never rewrites them
    for path, t in iter_leaves(tcache):
        if path.endswith(("c_k", "c_v")):
            _close(t, want[path], path)


def test_frames_change_the_logits(setup):
    _, tcfg, _, tparams, toks, frames = setup
    outs = [TM.forward(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                       "frames": torch.from_numpy(f)},
                       mode="train")[0] for f in (frames, 2 * frames)]
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3


def test_chunked_prefill_raises(setup):
    _, tcfg, _, tparams, toks, _ = setup
    assert not TM.chunked_prefill_supported(tcfg)
    cache = TM.init_paged_cache(tcfg, 2, 16, 5, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="prefills whole"):
        TM.prefill_chunk(tcfg, tparams, cache, torch.from_numpy(toks), 0,
                         torch.zeros((2, 2), dtype=torch.int32))


def test_engine_and_serve_runtime_refuse_whisper(setup):
    _, tcfg, _, tparams = setup[:4]
    for page_size in (0, 16):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            ServingEngine(tcfg, tparams, page_size=page_size, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        make_serve_runtime(tcfg, device="cpu")
