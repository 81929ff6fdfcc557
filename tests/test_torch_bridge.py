"""bridge: params and paged caches move between the JAX package and the
port exactly, with identical key paths, and the port's spec trees have the
reference's structure and shapes."""
import dataclasses

import jax
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

REDUCED = get_config("granite-3-2b").reduced()
# recurrentgemma: 1 period + 2 remainder layers (rem/), bf16 so its RG-LRU
# state leaf h (float32) differs in dtype from the rest of the cache
RG = dict(n_layers=5, window=8, dtype="bfloat16")
# the MoE archs: llama4-scout reduced (3 rem/ layers, ATTN + CHUNKED) and
# grok-1 reduced (one stacked period of 2 ATTN layers), router and expert
# weights in place of the MLP
MOE = {"llama4": "llama4-scout-17b-a16e", "grok": "grok-1-314b"}
CFGS = {"reduced": REDUCED,
        "gqa4": dataclasses.replace(REDUCED, n_kv_heads=1),
        "rg": dataclasses.replace(get_config("recurrentgemma-2b").reduced(), **RG),
        **{name: get_config(arch).reduced() for name, arch in MOE.items()}}


def _tcfg(name):
    if name == "rg":
        return dataclasses.replace(tget_config("recurrentgemma-2b").reduced(), **RG)
    if name in MOE:
        return tget_config(MOE[name]).reduced()
    cfg = tget_config("granite-3-2b").reduced()
    return cfg if name == "reduced" else dataclasses.replace(cfg, n_kv_heads=1)


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in flat}


def _roundtrip(tree):
    port = bridge.from_jax(jax.device_get(tree), device="cpu")
    back = dict(iter_leaves(bridge.to_numpy(port)))
    want = _jax_leaves(tree)
    assert set(back) == set(want)
    for path, arr in want.items():
        assert back[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(back[path], arr, err_msg=path)
    return port


@pytest.mark.parametrize("name", ["reduced", "gqa4", "llama4", "grok"])
def test_params_roundtrip_exact(name):
    cfg = CFGS[name]
    params = JM.init_model_params(cfg, jax.random.PRNGKey(0))
    port = _roundtrip(params)
    if name == "llama4":        # 3 layers of a 4-layer period: all rem/
        assert set(port) == {"embed", "final_ln", "rem"}
        assert port["rem"]["r0"]["we_g"].shape == (4, cfg.d_model, cfg.d_ff)
    else:
        assert port["blocks"]["p0"]["wq"].shape[0] == cfg.n_layers   # stacked
    if name == "grok":
        assert port["blocks"]["p0"]["we_d"].shape == (2, 4, cfg.d_ff, cfg.d_model)
        assert port["blocks"]["p0"]["router"].shape == (2, cfg.d_model, 4)


def test_rg_params_and_paged_cache_roundtrip_exact():
    """rem/ subtrees, a bf16 model, and the float32 h inside its cache
    keep their paths, dtypes and values."""
    cfg = CFGS["rg"]
    params = jax.device_get(JM.init_model_params(cfg, jax.random.PRNGKey(0)))
    cache = jax.device_get(JM.init_paged_cache(cfg, 2, 64, 9, 16))
    rng = np.random.default_rng(1)
    cache = jax.tree.map(lambda a: np.asarray(
        rng.standard_normal(a.shape), a.dtype), cache)
    for tree in (params, cache):
        port = bridge.from_jax(tree, device="cpu")
        back = dict(iter_leaves(bridge.to_numpy(port)))
        want = _jax_leaves(tree)
        assert set(back) == set(want)
        for path, t in iter_leaves(port):
            assert str(t.dtype) == f"torch.{want[path].dtype}", path
            np.testing.assert_array_equal(back[path], np.asarray(
                want[path], np.float32), err_msg=path)
    port = bridge.from_jax(params, device="cpu")
    assert port["blocks"]["p0"]["w_x"].shape[0] == 1          # one period
    assert set(port["rem"]) == {"r0", "r1"}
    port_cache = bridge.from_jax(cache, device="cpu")
    assert port_cache["rem"]["r0"]["h"].dtype == torch.float32
    assert port_cache["blocks"]["p2"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(CFGS))
def test_paged_cache_roundtrip_exact(name):
    cfg = CFGS[name]
    cache = JM.init_paged_cache(cfg, 2, 64, 9, 16)
    rng = np.random.default_rng(0)
    cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), cache)
    _roundtrip(cache)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_port_specs_match_reference_tree(name):
    cfg, tcfg = CFGS[name], _tcfg(name)
    want_p = {p: a.shape for p, a in _jax_leaves(
        JM.init_model_params(cfg, jax.random.PRNGKey(0))).items()}
    got_p = {p: tuple(t.shape) for p, t in iter_leaves(
        TM.init_model_params(tcfg, 0, "cpu"))}
    assert got_p == want_p
    want_c = {p: a.shape for p, a in _jax_leaves(
        JM.init_paged_cache(cfg, 2, 64, 9, 16)).items()}
    got_c = {p: tuple(t.shape) for p, t in iter_leaves(
        TM.init_paged_cache(tcfg, 2, 64, 9, 16, device="cpu"))}
    assert got_c == want_c
    want_d = {p: a.shape for p, a in _jax_leaves(
        JM.init_cache(cfg, 2, 64)).items()}
    got_d = {p: tuple(t.shape) for p, t in iter_leaves(
        TM.init_cache(tcfg, 2, 64, device="cpu"))}
    assert got_d == want_d
    flags = TM.paged_leaf_flags(tcfg, TM.init_paged_cache(
        tcfg, 2, 64, 9, 16, device="cpu"))
    want_flags = JM.paged_leaf_flags(cfg, JM.init_paged_cache(cfg, 2, 64, 9, 16))
    assert flags == want_flags
    assert any(flags) == (name != "rg")    # recurrentgemma pools nothing


def test_bfloat16_roundtrip_is_bit_exact():
    arr = jax.device_get(jax.random.normal(jax.random.PRNGKey(1), (5, 7),
                                           jax.numpy.bfloat16))
    t = bridge.from_jax({"w": arr}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy({"w": t})["w"],
                                  np.asarray(arr, np.float32))


def test_port_init_is_reproducible_from_seed():
    cfg = _tcfg("reduced")
    a = TM.init_model_params(cfg, 5, "cpu")
    b = TM.init_model_params(cfg, 5, "cpu")
    c = TM.init_model_params(cfg, 6, "cpu")
    for (pa, ta), (_, tb), (_, tc) in zip(iter_leaves(a), iter_leaves(b),
                                          iter_leaves(c)):
        assert torch.equal(ta, tb), pa
        if pa.endswith(("wq", "tok")):
            assert not torch.equal(ta, tc), pa
