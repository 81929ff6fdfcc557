"""The port's int8 configurations against the JAX package's, on the CPU at
``.reduced()`` widths (float32 activations), the same numpy arrays through
both packages:

* int8 weights: ``narrow_weights`` narrows the leaves the reference's
  ``_quantize_abstract`` narrows; ``forward`` with them matches the
  reference's (which upcasts every integer leaf) in prefill, chunks and
  decode for granite and qwen2.5-14b (QKV biases drawn non-zero) within
  ``ATOL``; the port's ``ServingEngine`` serves them token for token as
  the reference's, paged, chunked and dense; training refuses them.
* int8 K/V caches (``kv_dtype="int8"``): ``cache_specs`` and
  ``paged_cache_specs`` leaf for leaf; the saturating narrowing of every
  cache write against ``jnp.astype(int8)``; chunk-then-decode on an int8
  paged pool, dense decode and recurrentgemma's rings against the
  reference's ``forward``, with ``wk`` / ``wv`` scaled by ``KV_SCALE`` in
  both trees so that K/V span int8's range and some values saturate (at
  init scale they would truncate to zeros and prove nothing). The float32
  K/V the two sides truncate agree only to rounding (sums in another
  order), so a value within rounding of an integer may truncate to its
  neighbour on one side; the stored int8 values are held equal but for at
  most ``FLIPS`` of them, each off by one, and the logits within
  ``KV_ATOL``, which covers the ~2e-3 by which one such value moved them
  on the CPU. The models have one attention layer, so such a
  value cannot shift the K/V of a later layer past further boundaries.
* the plain paged versions (the CPU path of K1) upcast an int8 pool as the
  reference's oracle and Pallas body do, and the plain K3 takes an int8
  cache with no scales as ones.
"""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import decode_attention as jda
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models.param import init_params as jinit_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.models.layers import saturate_cast
from repro_torch.models.param import iter_leaves, map_tree
from repro_torch.serve.engine import Request, ServingEngine

torch.set_num_threads(1)

ATOL = 1e-4              # float32 logits of magnitude ~1
KV_ATOL = 1e-2           # int8 K/V caches: see the module docstring
FLIPS = 1e-3             # share of stored int8 K/V values that may differ by 1
KV_SCALE = 40.0          # wk, wv scaled: K/V ~ N(0, 40^2), some saturate
PAGE, NUM_PAGES = 8, 16
ARCHS = ("granite-3-2b", "qwen2.5-14b")
EIGHT = [300.7, -300.2, 127.9, -128.9, 1.9, -1.9, 0.4, float("nan")]


def _pair(arch):
    return get_config(arch).reduced(), tget_config(arch).reduced()


def _float_tree(arch, seed=0, kv_scale=1.0):
    """Numpy float32 weights from the reference's init (QKV biases drawn
    non-zero, ``wk`` / ``wv`` times ``kv_scale``)."""
    jcfg, _ = _pair(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, jax.device_get(JM.init_model_params(jcfg, jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed + 7)

    def edit(path, a):
        name = path.split("/")[-1]
        if name in ("bq", "bk", "bv"):
            a = (rng.standard_normal(a.shape) * 0.5).astype(a.dtype)
        if name in ("wk", "wv"):
            a = a * kv_scale
        return a
    return map_tree(edit, tree)


def _both(tree):
    """(the reference's tree of jnp arrays, the port's of CPU tensors)."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.from_jax(tree, device="cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def int8_weights(request):
    """(arch, reference int8 tree, port int8 tree): the port narrows, both
    get its arrays."""
    arch = request.param
    narrowed = TM.narrow_weights(bridge.from_jax(_float_tree(arch), device="cpu"))
    return (arch, *_both(bridge.to_numpy(narrowed)))


def _close(got, want, what, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=what)


def _tokens(n, seed=0, B=1):
    return np.random.default_rng(seed).integers(1, 512, size=(B, n)).astype(np.int32)


# ----------------------------------------------------------------------
# int8 weights
# ----------------------------------------------------------------------
NARROW_ARCHS = ("granite-3-2b", "recurrentgemma-2b", "llama4-scout-17b-a16e", "whisper-tiny")
# the reference's choice, in a process of its own: importing
# repro.launch.dryrun sets XLA_FLAGS to 512 host devices for the process
_QUANTIZED = """
import json, sys
import jax
from repro.configs import get_config
from repro.launch.dryrun import _quantize_abstract
from repro.models import model as M
out = {}
for arch in sys.argv[1:]:
    p = M.init_model_params(get_config(arch).reduced(), jax.random.PRNGKey(1))
    q = jax.tree_util.tree_flatten_with_path(_quantize_abstract(p, "int8"))[0]
    out[arch] = sorted("/".join(k.key for k in path) for path, a in q
                       if str(a.dtype) == "int8")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def quantized_leaves():
    """{arch: the leaf paths ``_quantize_abstract`` swaps to int8}."""
    out = subprocess.run([sys.executable, "-c", _QUANTIZED, *NARROW_ARCHS],
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch", NARROW_ARCHS)
def test_narrow_weights_leaves_and_values(arch, quantized_leaves):
    """The leaves ``_quantize_abstract`` swaps to int8 (>= 2 dims of the
    tree as laid out, stacked norms included) are the ones
    ``narrow_weights`` narrows, to clamp(round(w / 0.01), -127, 127)."""
    jcfg, tcfg = _pair(arch)
    tree = jax.device_get(JM.init_model_params(jcfg, jax.random.PRNGKey(1)))
    got = TM.narrow_weights(bridge.from_jax(tree, device="cpu"))
    src = dict(iter_leaves(tree))
    narrowed = []
    for path, t in iter_leaves(got):
        assert t.dtype in (torch.int8, torch.float32), path
        if t.dtype == torch.int8:
            narrowed.append(path)
            expect = np.clip(np.round(np.asarray(src[path], np.float32) / 0.01), -127, 127)
            np.testing.assert_array_equal(t.numpy(), expect.astype(np.int8), err_msg=path)
    assert sorted(narrowed) == quantized_leaves[arch] and narrowed
    if "blocks" in tree:                     # stacked norms are 2-d, so narrowed
        assert any(p.startswith("blocks/") and p.endswith("/ln1") for p in narrowed)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequantize_equals_reference_bits(dtype):
    """Every int8 value upcast as the reference's forward upcasts it,
    ``astype(dtype) * asarray(0.01, dtype)``, bit for bit; a transposed
    leaf too; a floating leaf passes uncopied."""
    from repro_torch.models.layers import dequantize
    w = np.arange(-128, 128).astype(np.int8).reshape(16, 16)
    jd = getattr(jnp, dtype)
    want = np.asarray((jnp.asarray(w).astype(jd) * jnp.asarray(0.01, jd)).astype(jnp.float32))
    td = getattr(torch, dtype)
    got = dequantize(torch.from_numpy(w), td)
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(dequantize(torch.from_numpy(w).t(), td).float().numpy(),
                                  want.T)
    f = torch.ones(3, dtype=td)
    assert dequantize(f, td) is f


def test_forward_int8_weights_matches_reference(int8_weights):
    """Prefill, three paged chunks and four decode steps with int8 weights
    against the reference's forward on the same int8 arrays."""
    arch, jp, tp = int8_weights
    jcfg, tcfg = _pair(arch)
    toks = _tokens(21, seed=3)
    jl, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, _ = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, cache_len=32)
    _close(tl, jl, "prefill")
    table = np.array([[3, 7, 1, 9, 0, 0, 0, 0], [0] * 8], np.int32)
    jc = JM.init_paged_cache(jcfg, 1, 64, NUM_PAGES, PAGE)
    tc = TM.init_paged_cache(tcfg, 1, 64, NUM_PAGES, PAGE, device="cpu")
    pos = 0
    for C in (8, 8, 5):
        piece = toks[:, pos:pos + C]
        jl, jc = JM.prefill_chunk(jcfg, jp, jc, jnp.asarray(piece),
                                  jnp.asarray(pos, jnp.int32), jnp.asarray(table[:1]))
        tl, tc = TM.prefill_chunk(tcfg, tp, tc, torch.from_numpy(piece), pos,
                                  torch.from_numpy(table[:1]))
        _close(tl, jl, f"chunk at {pos}")
        pos += C
    nxt = int(jnp.argmax(jl[0, -1]))
    for step in range(4):
        tok, p = np.array([[nxt], [0]], np.int32), np.array([pos + step, 0], np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.asarray(p),
                                block_tables=jnp.asarray(table))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok), torch.from_numpy(p),
                                block_tables=torch.from_numpy(table))
        _close(tl[0], jl[0], f"decode step {step}")
        nxt = int(jnp.argmax(jl[0, 0]))


def _prompts(seed, n=3):
    rng = np.random.default_rng(seed)
    return [([int(x) for x in rng.integers(1, 512, size=int(rng.choice((3, 9, 15, 27))))],
             int(rng.choice((4, 6)))) for _ in range(n)]


@pytest.mark.parametrize("layout", ["paged", "chunked", "dense"])
def test_engine_int8_weights_token_exact(int8_weights, layout):
    """The port's engine serves the int8 tree token for token as the
    reference's; the reference's tokens are not one token repeated."""
    arch, jp, tp = int8_weights
    jcfg, tcfg = _pair(arch)
    kw = dict(max_slots=2, max_len=64,
              page_size=0 if layout == "dense" else 16,
              prefill_chunk=8 if layout == "chunked" else 0)
    sched = _prompts(5)
    outs = []
    for eng, req in ((JEngine(jcfg, jp, **kw), JRequest),
                     (ServingEngine(tcfg, tp, device="cpu", **kw), Request)):
        reqs = [req(prompt=list(p), max_new_tokens=m, req_id=i)
                for i, (p, m) in enumerate(sched)]
        done = eng.generate(reqs)
        outs.append({r.req_id: list(r.output) for r in done})
    assert outs[1] == outs[0]
    assert len({t for o in outs[0].values() for t in o}) >= 2, outs[0]


def test_train_refuses_int8_weights(int8_weights):
    arch, _, tp = int8_weights
    _, tcfg = _pair(arch)
    toks = torch.from_numpy(_tokens(8, seed=9))
    with pytest.raises(TypeError, match="floating weights"):
        TM.loss_fn(tcfg, tp, {"tokens": toks, "labels": toks})


# ----------------------------------------------------------------------
# int8 K/V caches
# ----------------------------------------------------------------------
# an encoder-decoder (whisper) has no paged layout in either package
SPEC_CASES = [(a, lay) for a in ("granite-3-2b", "recurrentgemma-2b", "whisper-tiny",
                                 "llama4-scout-17b-a16e", "xlstm-350m")
              for lay in ("dense", "paged") if not (a == "whisper-tiny" and lay == "paged")]


@pytest.mark.parametrize("arch,layout", SPEC_CASES)
def test_cache_specs_kv_dtype_match_reference(arch, layout):
    jcfg, tcfg = _pair(arch)
    if layout == "dense":
        js = JM.cache_specs(jcfg, 2, 40, kv_dtype="int8")
        ts = TM.cache_specs(tcfg, 2, 40, kv_dtype="int8")
        tc = TM.init_cache(tcfg, 2, 40, device="cpu", kv_dtype="int8")
    else:
        js = JM.paged_cache_specs(jcfg, 2, 40, 9, PAGE, kv_dtype="int8")
        ts = TM.paged_cache_specs(tcfg, 2, 40, 9, PAGE, kv_dtype="int8")
        tc = TM.init_paged_cache(tcfg, 2, 40, 9, PAGE, device="cpu", kv_dtype="int8")
    want = {"/".join(k.key for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(js, is_leaf=lambda x: hasattr(x, "init"))[0]}
    got = dict(iter_leaves(ts))
    assert set(got) == set(want)
    narrowed = 0
    for path, s in got.items():
        assert s.shape == want[path].shape and s.dtype == want[path].dtype, path
        t = dict(iter_leaves(tc))[path]
        assert tuple(t.shape) == s.shape
        assert str(t.dtype) == f"torch.{s.dtype or tcfg.dtype}", path
        narrowed += s.dtype == "int8"
    assert narrowed == sum(p.split("/")[-1] in ("k", "v") for p in got)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_saturate_cast_equals_jax_astype(dtype):
    x = np.array(EIGHT, np.float32)
    want = np.asarray(jnp.asarray(x, getattr(jnp, dtype)).astype(jnp.int8))
    got = saturate_cast(torch.tensor(x).to(getattr(torch, dtype)), torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [127, -128, 127, -128, 1, -1, 0, 0])
    # a floating store stays Tensor.to
    assert saturate_cast(torch.tensor(x), torch.bfloat16).dtype == torch.bfloat16


def _same_store(got, want, what):
    """The int8 values stored on the two sides: equal but for at most
    ``FLIPS`` of them, each off by one."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= FLIPS, \
        f"{what}: {int((diff > 0).sum())} of {diff.size} differ, by up to {diff.max()}"


@pytest.fixture(scope="module")
def kv_granite():
    """granite .reduced() cut to one layer, wk / wv scaled."""
    jcfg, tcfg = (dataclasses.replace(c, n_layers=1) for c in _pair("granite-3-2b"))
    tree = _float_tree("granite-3-2b", seed=2, kv_scale=KV_SCALE)
    tree["blocks"] = {k: {n: a[:1] for n, a in sub.items()} for k, sub in tree["blocks"].items()}
    return (jcfg, tcfg, *_both(tree))


def _jcache(specs):
    return jinit_params(specs, jax.random.PRNGKey(0), "float32")


def test_int8_paged_pool_chunks_then_decode(kv_granite):
    """Three chunks into an int8 pool, then six decode steps of two live
    rows, against the reference's forward; the pools hold saturated
    values on both sides."""
    jcfg, tcfg, jp, tp = kv_granite
    toks = _tokens(21, seed=4, B=2)
    table = np.array([[3, 7, 1, 9, 0, 0, 0, 0], [2, 5, 8, 11, 0, 0, 0, 0]], np.int32)
    jc = _jcache(JM.paged_cache_specs(jcfg, 2, 64, NUM_PAGES, PAGE, kv_dtype="int8"))
    tc = TM.init_paged_cache(tcfg, 2, 64, NUM_PAGES, PAGE, device="cpu", kv_dtype="int8")
    pos = 0
    for C in (8, 8, 5):
        piece = toks[:, pos:pos + C]
        jl, jc = JM.prefill_chunk(jcfg, jp, jc, jnp.asarray(piece),
                                  jnp.asarray(pos, jnp.int32), jnp.asarray(table))
        tl, tc = TM.prefill_chunk(tcfg, tp, tc, torch.from_numpy(piece), pos,
                                  torch.from_numpy(table))
        _close(tl, jl, f"chunk at {pos}", KV_ATOL)
        pos += C
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)
    for step in range(6):
        p = np.full((2,), pos + step, np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(nxt[:, None]), jnp.asarray(p),
                                block_tables=jnp.asarray(table))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(nxt[:, None]),
                                torch.from_numpy(p), block_tables=torch.from_numpy(table))
        _close(tl, jl, f"decode step {step}", KV_ATOL)
        nxt = np.array(jnp.argmax(jl[:, 0], axis=-1), np.int32)
    want = dict(iter_leaves(jax.device_get(jc)))
    live = table[:, :4].ravel()
    for path, pool in iter_leaves(tc):
        assert pool.dtype == torch.int8
        _same_store(pool[:, live].numpy(), np.asarray(want[path])[:, live], path)
        assert int((pool[:, live].abs() >= 127).sum()) > 0, f"{path}: nothing saturates"


def test_int8_dense_cache_decode(kv_granite):
    """Twelve teacher-forced decode steps from position 0 into a dense
    int8 cache (K3's layout), a masked row riding along."""
    jcfg, tcfg, jp, tp = kv_granite
    jc = _jcache(JM.cache_specs(jcfg, 2, 16, kv_dtype="int8"))
    tc = TM.init_cache(tcfg, 2, 16, device="cpu", kv_dtype="int8")
    toks = _tokens(12, seed=6, B=2)
    for step in range(12):
        tok, p = toks[:, step:step + 1], np.array([step, step], np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.asarray(p))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok), torch.from_numpy(p))
        _close(tl, jl, f"dense decode step {step}", KV_ATOL)
    want = dict(iter_leaves(jax.device_get(jc)))
    for path, t in iter_leaves(tc):
        assert t.dtype == torch.int8
        _same_store(t.numpy(), np.asarray(want[path]), path)


def test_recurrentgemma_int8_rings():
    """recurrentgemma's window rings narrowed to int8 after a 60-token
    prefill (the reference's astype on one side, ``saturate_cast`` on the
    other, of the same prefill's ring), then six decode steps across the
    window of 64, against the reference's forward."""
    jcfg, tcfg = _pair("recurrentgemma-2b")
    jp, tp = _both(_float_tree("recurrentgemma-2b", seed=3, kv_scale=KV_SCALE))
    toks = _tokens(60, seed=8)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, cache_len=96)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, cache_len=96)
    _close(tl, jl, "prefill", KV_ATOL)
    specs = dict(iter_leaves(TM.cache_specs(tcfg, 1, 96, kv_dtype="int8")))
    jc = jax.tree_util.tree_map_with_path(
        lambda path, a: a.astype(specs["/".join(k.key for k in path)].dtype or a.dtype), jc)
    tc = map_tree(lambda path, t: saturate_cast(t, getattr(torch, specs[path].dtype))
                  if specs[path].dtype == "int8" else t, tc)
    n_int8 = sum(t.dtype == torch.int8 for _, t in iter_leaves(tc))
    assert n_int8 == 2 * sum(1 for p in specs if p.endswith("/k"))
    nxt = int(jnp.argmax(jl[0, -1]))
    for step in range(6):
        tok, p = np.array([[nxt]], np.int32), np.array([60 + step], np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok), jnp.asarray(p))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok), torch.from_numpy(p))
        _close(tl, jl, f"ring decode step {step}", KV_ATOL)
        nxt = int(jnp.argmax(jl[0, 0]))


# ----------------------------------------------------------------------
# the plain kernels on int8 caches
# ----------------------------------------------------------------------
def _pool_inputs(rng, B=2, H=8, KV=2, hd=64, P=4, C=1):
    # q small enough that scores over int8 keys stay a few units wide
    q = (rng.standard_normal((B, C, H, hd)) * 0.02).astype(np.float32)
    kp = rng.integers(-128, 128, size=(2 + B * P, PAGE, KV, hd)).astype(np.int8)
    vp = rng.integers(-128, 128, size=kp.shape).astype(np.int8)
    bt = (1 + np.arange(B * P)).reshape(B, P).astype(np.int32)
    return q, kp, vp, bt


def test_plain_paged_upcasts_int8_pool_as_reference():
    """ops' plain K1 (decode and a chunk) on an int8 pool against the
    reference's oracle and its Pallas body (interpret mode)."""
    rng = np.random.default_rng(11)
    q, kp, vp, bt = _pool_inputs(rng)
    kl = np.array([5, 29], np.int32)
    t = [torch.from_numpy(x) for x in (q, kp, vp, bt, kl)]
    got = ops.paged_decode_attention(*t, impl="ref")
    want = jref.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, bt, kl)))
    pallas = jda.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, bt, kl)), interpret=True)
    # outputs of int8 values (~100): float32 rounding
    _close(got, want, "paged decode vs oracle", 1e-4, 1e-5)
    _close(got, pallas, "paged decode vs Pallas", 1e-4, 1e-5)
    qc, _, _, _ = _pool_inputs(rng, C=5)
    qo = np.array([3, 24], np.int32)
    kl = qo + 5
    t = [torch.from_numpy(x) for x in (qc, kp, vp, bt, kl, qo)]
    got = ops.paged_prefill_attention(*t, impl="ref")
    args = map(jnp.asarray, (qc, kp, vp, bt, kl, qo))
    want = jref.paged_prefill_attention(*args)
    pallas = jda.paged_prefill_attention(*map(jnp.asarray, (qc, kp, vp, bt, kl, qo)),
                                         interpret=True)
    _close(got, want, "paged chunk vs oracle", 1e-4, 1e-5)
    _close(got, pallas, "paged chunk vs Pallas", 1e-4, 1e-5)


def test_plain_decode_int8_without_scales_as_reference():
    """K3's CPU path takes an int8 cache with no scales as ones, as the
    reference's ``decode_attention`` (Pallas, interpret mode)."""
    rng = np.random.default_rng(12)
    q = (rng.standard_normal((2, 1, 8, 64)) * 0.02).astype(np.float32)
    k = rng.integers(-128, 128, size=(2, 40, 2, 64)).astype(np.int8)
    v = rng.integers(-128, 128, size=k.shape).astype(np.int8)
    kl = np.array([40, 7], np.int32)
    got = ops.decode_attention(*[torch.from_numpy(x) for x in (q, k, v, kl)])
    want = jda.decode_attention(*map(jnp.asarray, (q, k, v, kl)), interpret=True)
    ones = np.ones((2, 2), np.float32)
    scaled = ops.decode_attention(*[torch.from_numpy(x) for x in (q, k, v, kl)],
                                  k_scale=torch.from_numpy(ones),
                                  v_scale=torch.from_numpy(ones))
    _close(got, want, "decode int8, no scales", 1e-4, 1e-5)
    torch.testing.assert_close(got, scaled, rtol=0, atol=0)
