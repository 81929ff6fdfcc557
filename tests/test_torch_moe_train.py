"""MoE training on the port against the JAX package's, on the CPU.

* ``ref.moe_gmm_bwd`` (the plain backward of K4: dX = dY W[e]^T and
  dW[e] = X_e^T dY_e per group) against ``jax.vjp`` of
  ``jax.lax.ragged_dot`` (the reference's training path, ``impl="xla"``)
  and of the JAX oracle ``ref.moe_gmm``, on the same numpy inputs, float32
  within 1e-5 of max |grad| (summation order): uneven groups, an empty
  group (dW zero), a one-row group, rows past the total (dX zero), one
  expert, and the row order of a top-2 routing;
* ``MoeGmmFn`` (the autograd Function the card's path runs) under
  ``torch.autograd.gradcheck`` in float64, and its CPU route: the
  wrapper's ``grad_fn`` is the Function's, the model's MoE layers go
  through it, a gradient autograd does not need is not computed, and
  nothing is saved under ``torch.no_grad()``;
* ``loss_and_grads`` (loss and every leaf's gradient, the router and
  experts included) against ``jax.value_and_grad`` of the reference's
  ``loss_fn`` for grok-1-314b ``.reduced()`` (top-2 of 4 experts, two
  periods) beside llama4-scout's (``tests/test_torch_train.py``), within
  1e-4 of the leaf's max |g|, with and without remat.

The CUDA kernels of the same backward are held on the card by
``tests/test_torch_kernels.py::test_moe_gmm_bwd_kernel_matches_plain`` and
``chip_smoke.py`` phase 10 (f).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels import moe_gmm as gm
from repro_torch.kernels import ops, ref
from repro_torch.models.param import iter_leaves
from repro_torch.train.train_loop import loss_and_grads

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

BWD_TOL = 1e-5       # x max |grad|
GRAD_TOL = 1e-4      # x max |g| of the leaf
LOSS_TOL = 1e-4


def _top2_sizes(n_tok, E, seed):
    """Group sizes of a top-2 routing: each token's two experts, rows
    sorted by expert as ``_moe_local`` sorts them."""
    rng = np.random.default_rng(seed)
    top = np.argsort(-rng.standard_normal((n_tok, E)), axis=1, kind="stable")[:, :2]
    return np.bincount(top.reshape(-1), minlength=E).tolist(), 2 * n_tok


# name: (group sizes, T, K, N)
BWD_CASES = {
    "uneven": ([5, 17, 2, 9], 33, 24, 40),
    "empty group": ([6, 0, 11, 0], 17, 16, 24),
    "one-row group": ([1, 12, 1], 14, 32, 16),
    "rows past the total": ([4, 3, 0, 2], 13, 16, 8),
    "one expert": ([21], 21, 24, 32),
    "top-2 ordering": (*_top2_sizes(13, 4, 3), 32, 24),
}


def _bwd_inputs(sizes, T, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, K)).astype(np.float32),
            (rng.standard_normal((len(sizes), K, N)) / np.sqrt(K)).astype(np.float32),
            np.asarray(sizes, np.int32),
            rng.standard_normal((T, N)).astype(np.float32))


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    tol = BWD_TOL * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_moe_gmm_bwd_plain_matches_jax_grad(case):
    sizes, T, K, N = BWD_CASES[case]
    x, w, gs, dout = _bwd_inputs(sizes, T, K, N)
    dx, dw = ref.moe_gmm_bwd(*(torch.from_numpy(a) for a in (x, w, gs, dout)))
    assert dx.dtype == dw.dtype == torch.float32
    assert dx.shape == (T, K) and dw.shape == (len(sizes), K, N)
    jgs = jnp.asarray(gs)
    for name, fn in (("ragged_dot", lambda a, b: jax.lax.ragged_dot(a, b, jgs)),
                     ("ref.moe_gmm", lambda a, b: jref.moe_gmm(a, b, jgs))):
        _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
        wdx, wdw = vjp(jnp.asarray(dout))
        _close(dx, wdx, f"{case}: dx vs {name}")
        _close(dw, wdw, f"{case}: dw vs {name}")
    # the edges hold exactly: an empty group's dW and the uncovered rows' dX
    for e, g in enumerate(sizes):
        if g == 0:
            assert not dw[e].any(), f"{case}: expert {e} is empty"
    assert not dx[sum(sizes):].any()


@pytest.mark.parametrize("sizes,T", [([3, 0, 4], 9), ([5], 5), ([0, 2, 1, 2], 6)])
def test_moe_gmm_function_gradcheck(sizes, T):
    """``MoeGmmFn`` on CPU tensors (the plain forward and
    ``ref.moe_gmm_bwd``) against finite differences, float64: an empty
    group, rows past the total, one expert."""
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.standard_normal((T, 8))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((len(sizes), 8, 16))).requires_grad_()
    gs = torch.tensor(sizes, dtype=torch.int32)
    assert gm.moe_gmm(x, w, gs).grad_fn.name().startswith("MoeGmmFn")
    assert torch.autograd.gradcheck(lambda a, b: gm.moe_gmm(a, b, gs), (x, w))


def test_cpu_route_runs_the_function(monkeypatch):
    """On the CPU the wrapper's gradient is the Function's (the route the
    card takes, with the plain versions inside); ``impl="ref"`` is plain
    autograd; a gradient autograd does not ask for is not computed; under
    ``torch.no_grad()`` the output saves nothing."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((10, 16)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32))
    gs = torch.tensor([4, 0, 5], dtype=torch.int32)
    assert ops.moe_gmm(x, w, gs).grad_fn.name() == "MoeGmmFnBackward"
    assert "MoeGmmFn" not in ops.moe_gmm(x, w, gs, impl="ref").grad_fn.name()
    seen = []
    real = gm.moe_gmm_bwd

    def spy(*args, **kw):
        seen.append((kw["need_dx"], kw["need_dw"]))
        return real(*args, **kw)
    monkeypatch.setattr(gm, "moe_gmm_bwd", spy)
    dout = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32))
    (gx,) = torch.autograd.grad(gm.moe_gmm(x, w, gs), (x,), dout)
    assert seen == [(True, False)]
    torch.testing.assert_close(gx, ref.moe_gmm_bwd(x.detach(), w, gs, dout)[0])
    with torch.no_grad():
        assert gm.moe_gmm(x, w, gs).grad_fn is None


# ----------------------------------------------------------------------
# the MoE train path against the reference
# ----------------------------------------------------------------------
# arch, overrides, B, S
MOE_CASES = {
    # top-2 over 4 experts on every layer, two (ATTN) periods
    "grok-1": ("grok-1-314b", {}, 2, 24),
    # llama4's global + chunked attention, top-1, the chunk of 64 crossed
    "llama4-scout": ("llama4-scout-17b-a16e", {}, 1, 72),
}


def _setup(case):
    name, over, B, S = MOE_CASES[case]
    jcfg = dataclasses.replace(get_config(name).reduced(), **over)
    tcfg = dataclasses.replace(tget_config(name).reduced(), **over)
    jp = JM.init_model_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.from_jax(jax.device_get(jp), device="cpu")
    b = TokenPipeline(PipelineConfig(vocab=tcfg.vocab, seq_len=S, global_batch=B,
                                     seed=4)).next_batch()
    return (jcfg, tcfg, jp, tp, {k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_loss_and_grads_match_reference(case, remat, monkeypatch):
    """The loss (cross-entropy plus the aux term) and every leaf's
    gradient against the reference's ``ragged_dot`` route, with each MoE
    layer's three grouped matmuls through ``MoeGmmFn``."""
    jcfg, tcfg, jp, tp, jb, tb = _setup(case)
    applied = []
    real = gm.MoeGmmFn.apply
    monkeypatch.setattr(gm.MoeGmmFn, "apply",
                        lambda *a: applied.append(1) or real(*a))
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb, remat=remat))(jp)
    tloss, tgrads = loss_and_grads(tcfg, tp, tb, remat=remat)
    # three grouped matmuls a layer, each recomputed once more in the
    # backward of a checkpointed period
    n_periods = tcfg.n_layers // len(tcfg.pattern)
    n_ckpt = n_periods * len(tcfg.pattern) if remat else 0
    assert len(applied) == 3 * (tcfg.n_layers + n_ckpt)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=LOSS_TOL)
    want = dict(iter_leaves(jax.device_get(jgrads)))
    got = dict(iter_leaves(tgrads))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[path].float().numpy() - w).max())
        assert err <= GRAD_TOL * scale, f"{case} {path}: {err} > {GRAD_TOL} x {scale}"
    for path in ("we_g", "we_u", "we_d", "router"):
        assert any(p.endswith(path) and float(g.abs().max()) > 0 for p, g in got.items()), path
