"""The VLM patch prefix in the port against the JAX package, on the same
weights (via the bridge): llava-next-34b ``.reduced()`` (2 layers, d 256,
4/4 heads, hd 64, 16 stub patch embeddings, float32).

* the param, dense cache and paged cache trees equal the reference's;
* ``train`` with patches: the logits of the token positions only, (B, S,
  V), within float32 ``1e-4``;
* ``prefill`` with patches and ``cache_len = n_patches + total``, then
  ``decode_step`` at positions ``n_patches + t`` (the sequence of
  ``tests/test_vlm_audio.py``), within ``1e-4`` of the reference's, and
  within ``2e-4 x max|logit|`` of the port's own ``train`` logits at the
  same positions (a decode at the wrong rope position would miss both);
* moving the patches moves the logits (> 1e-3);
* a prefill without patches equals the reference's text-only prefill;
* the serving engine serves the family text-only, as the reference's
  (which passes no patches), token-exact against it, paged and dense; and
  the launcher serves ``--arch llava-next-34b --reduced``.
"""
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models.param import iter_leaves
from repro_torch.serve.engine import Request, ServingEngine

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

ARCH = "llava-next-34b"
ATOL = 1e-4
B, S, N_DEC = 2, 8, 4


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = get_config(ARCH).reduced(), tget_config(ARCH).reduced()
    jp = JM.init_model_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, size=(B, S + N_DEC)).astype(np.int32)
    patches = rng.standard_normal((B, tcfg.n_patches, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, toks, patches


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=atol,
                               err_msg=what)


def _batches(toks, patches):
    """The same batch for both packages (``patches`` None: text only)."""
    j, t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if patches is not None:
        j["patches"], t["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    return j, t


@pytest.mark.parametrize("which", ["params", "dense cache", "paged cache"])
def test_trees_equal_reference(which):
    jcfg, tcfg = get_config(ARCH).reduced(), tget_config(ARCH).reduced()
    if which == "params":
        want, got = JM.param_specs(jcfg), TM.param_specs(tcfg)
    elif which == "dense cache":
        want, got = JM.cache_specs(jcfg, 3, 40), TM.cache_specs(tcfg, 3, 40)
    else:
        want = JM.paged_cache_specs(jcfg, 3, 40, 9, 8)
        got = TM.paged_cache_specs(tcfg, 3, 40, 9, 8)
    shapes = lambda tree: {p: tuple(s.shape) for p, s in iter_leaves(tree)}  # noqa: E731
    assert shapes(got) == shapes(want)


def test_train_with_patches_matches_reference(setup):
    jcfg, tcfg, jp, tp, toks, patches = setup
    jb, tb = _batches(toks, patches)
    want, _, _ = JM.forward(jcfg, jp, jb, mode="train")
    got, cache = TM.forward(tcfg, tp, tb, mode="train")
    assert cache is None
    assert tuple(got.shape) == want.shape == (B, S + N_DEC, tcfg.padded_vocab)
    _close(got, want, "train logits")


def test_prefill_with_patches_then_decode_matches_reference(setup):
    """The prefill caches the patch prefix; decode continues at positions
    ``n_patches + t``."""
    jcfg, tcfg, jp, tp, toks, patches = setup
    P, total = tcfg.n_patches, S + N_DEC
    full, _ = TM.forward(tcfg, tp, _batches(toks, patches)[1], mode="train")
    jb, tb = _batches(toks[:, :S], patches)
    jl, jc = JM.prefill(jcfg, jp, jb, cache_len=P + total)
    tl, tc = TM.prefill(tcfg, tp, tb, cache_len=P + total)
    assert tc["blocks"]["p0"]["k"].shape[2] == P + total
    _close(tl, jl, "prefill logits")
    errs = [float((tl[:, 0] - full[:, S - 1]).abs().max())]
    for t in range(S, total):
        pos = np.full((B,), P + t, np.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(pos))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos))
        _close(tl, jl, f"decode at {P + t}")
        errs.append(float((tl[:, 0] - full[:, t]).abs().max()))
    want = dict(iter_leaves(jax.device_get(jc)))
    for path, t in iter_leaves(tc):
        _close(t, want[path], path)
    scale = float(full.abs().max())
    assert max(errs) < 2e-4 * max(scale, 1.0), (errs, scale)


def test_moving_the_patches_moves_the_logits(setup):
    _, tcfg, _, tp, toks, patches = setup
    l1, _ = TM.forward(tcfg, tp, _batches(toks, patches)[1], mode="train")
    l2, _ = TM.forward(tcfg, tp, _batches(toks, patches + 1.0)[1], mode="train")
    assert tuple(l1.shape) == (B, S + N_DEC, tcfg.padded_vocab)
    assert float((l1 - l2).abs().max()) > 1e-3


def test_prefill_without_patches_matches_reference(setup):
    jcfg, tcfg, jp, tp, toks, _ = setup
    jb, tb = _batches(toks[:, :S], None)
    jl, jc = JM.prefill(jcfg, jp, jb, cache_len=16)
    tl, tc = TM.prefill(tcfg, tp, tb, cache_len=16)
    _close(tl, jl, "text-only prefill logits")
    want = dict(iter_leaves(jax.device_get(jc)))
    for path, t in iter_leaves(tc):
        _close(t, want[path], path)


@pytest.mark.parametrize("page_size", [16, 0], ids=["paged", "dense"])
def test_engine_text_only_token_exact(setup, page_size):
    jcfg, tcfg, jp, tp = setup[:4]
    rng = random.Random(page_size)
    sched = [([rng.randrange(1, tcfg.vocab) for _ in range(n)], m)
             for n, m in ((5, 6), (19, 3), (40, 4), (9, 6))]
    kw = dict(max_slots=2, max_len=64, page_size=page_size)
    outs = []
    for engine, req in ((JEngine(jcfg, jp, **kw), JRequest),
                        (ServingEngine(tcfg, tp, device="cpu", **kw), Request)):
        done = engine.generate([req(prompt=list(p), max_new_tokens=m, req_id=i)
                                for i, (p, m) in enumerate(sched)])
        outs.append(({r.req_id: list(r.output) for r in done}, engine.stats()))
    assert outs[0] == outs[1]


def test_launcher_serves_llava(capsys):
    assert tserve.main(["--arch", ARCH, "--reduced", "--backend", "engine",
                        "--device", "cpu", "--events", "2",
                        "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "2/2 events served" in out
    counts = re.findall(r"tokens=(\d+)", out)
    assert counts and set(counts) == {"6"}, out
