"""The port's training path against the JAX package's, on the CPU.

The same numpy-seeded inputs and bridged weights go through both packages
in float32 (``.reduced()`` configs): the data pipeline's batches (equal),
``cross_entropy`` and ``adamw_update`` (within 1e-6; the learning rate and
bias corrections are float32 on both sides), ``loss_fn`` and every leaf's
gradient against ``jax.value_and_grad`` of the reference's ``loss_fn``
(its default XLA path, whose blocked attention and scan are what JAX
differentiates; within 1e-4 x max |g| of the leaf, float32 sums taken in
another order), three ``train_step``s from one bridged optimizer state
(losses within 1e-4), ``microbatch`` and ``remat`` against their plain
step, checkpoints restoring in the other package, and the launcher's
printed lines. The CUDA path of the same step is held in ``chip_smoke.py``
phase 10 and in the ``gpu`` cases of ``tests/test_torch_kernels.py``.
"""
import dataclasses
import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.storage import ObjectStore as JStore
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import train as jlaunch
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro.train.train_loop import train_step as jtrain_step
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core.storage import ObjectStore as TStore
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.param import iter_leaves
from repro_torch.train import checkpoint as TC
from repro_torch.train import optimizer as TO
from repro_torch.train.train_loop import loss_and_grads, train_step

# tiny CPU shapes: one intra-op thread, so parallel test workers do not
# spin every core that the suite's timing-based tests depend on
torch.set_num_threads(1)

GRAD_TOL = 1e-4      # x max |g| of the leaf
LOSS_TOL = 1e-4


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _cfgs(name, **over):
    j, t = get_config(name).reduced(), tget_config(name).reduced()
    if over:
        j, t = dataclasses.replace(j, **over), dataclasses.replace(t, **over)
    return j, t


def _params(jcfg, seed=0):
    jp = JM.init_model_params(jcfg, jax.random.PRNGKey(seed))
    return jp, bridge.from_jax(jax.device_get(jp), device="cpu")


def _batch(cfg, B, S, seed=0):
    b = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=S,
                                     global_batch=B, seed=seed)).next_batch()
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _assert_grads_close(tgrads, jgrads, what):
    want = dict(iter_leaves(jax.device_get(jgrads)))
    got = dict(iter_leaves(tgrads))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(_f32(got[path]) - w).max())
        assert err <= GRAD_TOL * scale, \
            f"{what} {path}: max err {err} > {GRAD_TOL} x {scale}"


# ----------------------------------------------------------------------
# data, loss, optimizer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed,doc", [
    (512, 32, 4, 0, 512), (49155, 64, 2, 3, 64), (1000, 7, 5, 1, 8)])
def test_pipeline_batches_equal_reference(vocab, seq, batch, seed, doc):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
              doc_len_mean=doc)
    mine, theirs = TokenPipeline(PipelineConfig(**kw)), \
        JTokenPipeline(JPipelineConfig(**kw))
    for _ in range(3):
        a, b = mine.next_batch(), theirs.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.n_tokens_emitted == theirs.n_tokens_emitted


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 9, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) > 0.4).astype(np.float32) if masked else None
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_cosine_lr_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    for step in (0, 1, 3, 7, 8, 20, 49, 50, 60):
        want = float(JO.cosine_lr(JO.AdamWConfig(**cfg), jnp.asarray(step)))
        got = TO.cosine_lr(TO.AdamWConfig(**cfg), step)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_update_matches_reference(state_dtype, inplace, monkeypatch):
    """Three updates of a tree with float32 and bfloat16 leaves, the same
    numpy gradients on both sides; a slice of 64 elements, so a leaf's
    update runs in several slices."""
    monkeypatch.setattr(TO, "UPDATE_SLICE", 64)
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 40), "b": {"c": (300,), "d": (3, 4, 5)}}
    dtypes = {"a": "float32", "c": "bfloat16", "d": "float32"}

    def tree(fn):
        return {"a": fn("a", shapes["a"]),
                "b": {k: fn(k, s) for k, s in shapes["b"].items()}}
    p_np = tree(lambda k, s: rng.standard_normal(s).astype(np.float32))
    jp = jax.tree.map(lambda x, k: jnp.asarray(x, k), p_np,
                      tree(lambda k, s: dtypes[k]))
    tp = bridge.from_jax(jax.device_get(jp), device="cpu")
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5,
               state_dtype=state_dtype)
    jcfg, tcfg = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    js = JO.init_opt_state(jcfg, jp)
    ts = TO.init_opt_state(tcfg, tp)
    for step in range(3):
        g_np = tree(lambda k, s: (rng.standard_normal(s) * 0.3).astype(np.float32))
        jg = jax.tree.map(lambda x, q: jnp.asarray(x, q.dtype), g_np, jp)
        tg = bridge.from_jax(jax.device_get(jg), device="cpu")
        jp, js, jm = JO.adamw_update(jcfg, jg, js, jp)
        before = [t.data_ptr() for _, t in iter_leaves(tp)]
        tp, ts, tm = TO.adamw_update(tcfg, tg, ts, tp, inplace=inplace)
        assert ([t.data_ptr() for _, t in iter_leaves(tp)] == before) == inplace
        assert ts.step == int(js.step) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            want = dict(iter_leaves(jax.device_get(want)))
            for path, t in iter_leaves(got):
                assert str(t.dtype)[6:] == str(want[path].dtype), path
                np.testing.assert_allclose(_f32(t), np.asarray(want[path], np.float32),
                                           rtol=1e-6, atol=1e-6, err_msg=path)


# ----------------------------------------------------------------------
# loss_fn and every leaf's gradient
# ----------------------------------------------------------------------
LOSS_CASES = {
    "granite": ("granite-3-2b", {}, 2, 32),
    # one (R, R, A) period and the window of 64 crossed
    "recurrentgemma": ("recurrentgemma-2b", {}, 2, 80),
    # a period and two remainder RG-LRU layers outside it
    "recurrentgemma-5": ("recurrentgemma-2b", {"n_layers": 5}, 1, 70),
    # MoE on every layer (the aux loss), global + chunked attention, the
    # chunk of 64 crossed
    "llama4-scout": ("llama4-scout-17b-a16e", {}, 2, 80),
    # top-2 of 4 experts, two checkpointed periods
    "grok-1": ("grok-1-314b", {}, 2, 24),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_reference(case):
    name, over, B, S = LOSS_CASES[case]
    jcfg, tcfg = _cfgs(name, **over)
    jp, tp = _params(jcfg)
    jb, tb = _batch(tcfg, B, S)
    jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jb))(jp)
    tloss, tgrads = loss_and_grads(tcfg, tp, tb, remat=False)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=LOSS_TOL)
    _assert_grads_close(tgrads, jgrads, case)
    if tcfg.n_experts:
        # the aux term is in: the loss is not the cross-entropy alone
        logits, _, aux = TM.forward_with_aux(tcfg, tp, tb, mode="train")
        ce = TL.cross_entropy(logits, tb["labels"])
        assert aux is not None and float(aux) > 0
        np.testing.assert_allclose(float(tloss), float(ce + TM.AUX_LOSS_WEIGHT * aux),
                                   rtol=1e-6)


@pytest.mark.parametrize("case", ["granite", "recurrentgemma-5", "llama4-scout"])
def test_remat_equals_no_remat(case):
    """Checkpointing each period recomputes the same activations: the same
    loss and gradients (periods and remainder layers both reached)."""
    name, over, B, S = LOSS_CASES[case]
    _, tcfg = _cfgs(name, **over)
    tp = TM.init_model_params(tcfg, 3, "cpu")
    _, tb = _batch(tcfg, B, S, seed=5)
    l0, g0 = loss_and_grads(tcfg, tp, tb, remat=False)
    l1, g1 = loss_and_grads(tcfg, tp, tb, remat=True)
    assert float(l0) == float(l1)
    want = dict(iter_leaves(g0))
    for path, g in iter_leaves(g1):
        torch.testing.assert_close(g, want[path], rtol=1e-6, atol=1e-7, msg=path)


@pytest.mark.parametrize("case", ["granite", "recurrentgemma-5", "llama4-scout"])
def test_remat_policy_dots_matches_reference(case):
    """``remat_policy="dots"`` (selective checkpointing that keeps the
    matrix products without batch dimensions): the loss and every leaf's
    gradient against the reference's ``jax.checkpoint`` under
    ``dots_with_no_batch_dims_saveable``, and equal to the port's
    ``remat=True`` (the same arithmetic recomputed); an unknown policy
    raises."""
    name, over, B, S = LOSS_CASES[case]
    jcfg, tcfg = _cfgs(name, **over)
    jp, tp = _params(jcfg, seed=2)
    jb, tb = _batch(tcfg, B, S, seed=3)
    jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(
        jcfg, p, jb, remat=True, remat_policy="dots"))(jp)
    tloss, tgrads = loss_and_grads(tcfg, tp, tb, remat=True, remat_policy="dots")
    np.testing.assert_allclose(float(tloss), float(jloss), atol=LOSS_TOL)
    _assert_grads_close(tgrads, jgrads, f"{case} dots")
    l1, g1 = loss_and_grads(tcfg, tp, tb, remat=True)
    assert float(l1) == float(tloss)
    want = dict(iter_leaves(g1))
    for path, g in iter_leaves(tgrads):
        torch.testing.assert_close(g, want[path], rtol=1e-6, atol=1e-7, msg=path)
    with pytest.raises(ValueError):
        TM.loss_fn(tcfg, tp, tb, remat=True, remat_policy="everything")


def test_forward_keeps_its_serving_signature():
    """``forward`` returns (logits, None) in train mode; the aux comes
    through ``forward_with_aux`` (None without MoE layers)."""
    _, tcfg = _cfgs("granite-3-2b")
    tp = TM.init_model_params(tcfg, 0, "cpu")
    _, tb = _batch(tcfg, 1, 8)
    logits, cache = TM.forward(tcfg, tp, tb, mode="train")
    assert cache is None and logits.shape == (1, 8, tcfg.padded_vocab)
    l2, cache, aux = TM.forward_with_aux(tcfg, tp, tb, mode="train")
    assert cache is None and aux is None and torch.equal(logits, l2)


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["granite", "recurrentgemma", "llama4-scout",
                                  "grok-1"])
def test_three_train_steps_match_reference(case):
    """One reference step first, then both packages start from its bridged
    parameters and optimizer state and take three steps on the same
    batches: losses within 1e-4, the final parameters within 1e-4."""
    name, over, B, S = LOSS_CASES[case]
    jcfg, tcfg = _cfgs(name, **over)
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jo, to = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    jp, _ = _params(jcfg)
    pipe = TokenPipeline(PipelineConfig(vocab=tcfg.vocab, seq_len=S,
                                        global_batch=B, seed=2))
    step = jax.jit(lambda p, o, b: jtrain_step(jcfg, jo, p, o, b, remat=False))
    b0 = pipe.next_batch()
    jp, js, _ = step(jp, JO.init_opt_state(jo, jp),
                     {k: jnp.asarray(v) for k, v in b0.items()})
    tp = bridge.from_jax(jax.device_get(jp), device="cpu")
    ts = bridge.opt_state_from_jax(jax.device_get(js), device="cpu")
    assert ts.step == 1
    for _ in range(3):
        b = pipe.next_batch()
        jp, js, jm = step(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = train_step(tcfg, to, tp, ts, b, remat=True)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=LOSS_TOL)
    want = dict(iter_leaves(jax.device_get(jp)))
    for path, t in iter_leaves(tp):
        np.testing.assert_allclose(_f32(t), np.asarray(want[path], np.float32),
                                   atol=1e-4, err_msg=path)
    back = bridge.opt_state_to_numpy(ts)
    assert back.step == int(js.step) == 4


@pytest.mark.parametrize("case", ["llama4-scout", "grok-1"])
def test_repeated_batch_matches_reference(case):
    """One batch repeated 4 steps from a fresh AdamW state at lr 1e-3 (no
    warmup), as ``chip_smoke.py`` phase 10 repeats one on the card, through
    both packages from the same weights: the MoE step's losses (the aux
    term in) within 1e-4 at every step, whatever way they move."""
    name, over, B, S = LOSS_CASES[case]
    jcfg, tcfg = _cfgs(name, **over)
    cfg = dict(lr=1e-3, warmup_steps=0, total_steps=50)
    jo, to = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    jp, tp = _params(jcfg, seed=4)
    jb, tb = _batch(tcfg, B, S, seed=6)
    step = jax.jit(lambda p, o, b: jtrain_step(jcfg, jo, p, o, b, remat=False))
    js, ts = JO.init_opt_state(jo, jp), TO.init_opt_state(to, tp)
    for i in range(4):
        jp, js, jm = step(jp, js, jb)
        tp, ts, tm = train_step(tcfg, to, tp, ts, tb, remat=True)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=LOSS_TOL, err_msg=f"step {i}")


def test_microbatch_equals_one_batch():
    """``microbatch=2``: float32 gradients summed over two halves and
    divided by 2, against one pass over the whole batch: the same loss and
    update to float32 rounding. ``eps=1`` makes the first update a smooth
    function of the gradient (with a small eps it is about sign(g), which
    flips for gradients of rounding size), so the parameters compare the
    gradients."""
    _, tcfg = _cfgs("granite-3-2b")
    to = TO.AdamWConfig(lr=1e-3, eps=1.0, warmup_steps=1, total_steps=10)
    tp = TM.init_model_params(tcfg, 1, "cpu")
    _, tb = _batch(tcfg, 4, 16, seed=9)
    outs = [train_step(tcfg, to, tp, TO.init_opt_state(to, tp), tb,
                       microbatch=mb) for mb in (1, 2)]
    np.testing.assert_allclose(float(outs[1][2]["loss"]), float(outs[0][2]["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(outs[1][2]["grad_norm"]),
                               float(outs[0][2]["grad_norm"]), rtol=1e-5)
    want = dict(iter_leaves(outs[0][0]))
    for path, t in iter_leaves(outs[1][0]):
        torch.testing.assert_close(t, want[path], rtol=1e-5, atol=1e-6, msg=path)
    with pytest.raises(ValueError):
        train_step(tcfg, to, tp, TO.init_opt_state(to, tp), tb, microbatch=3)


def test_loss_falls_on_a_repeated_batch():
    """The reference's test_loss_decreases_over_steps, on the port."""
    _, tcfg = _cfgs("granite-3-2b")
    to = TO.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50)
    tp = TM.init_model_params(tcfg, 0, "cpu")
    ts = TO.init_opt_state(to, tp)
    _, tb = _batch(tcfg, 4, 32)
    losses = []
    for _ in range(8):
        tp, ts, m = train_step(tcfg, to, tp, ts, tb, inplace=True)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
def _copy_store(src, dst):
    for key, blob in src._blobs.items():
        dst.put(blob, key=key)


def test_checkpoints_restore_in_the_other_package():
    """Leaf keys, manifest and blobs are the reference's: a port
    checkpoint restores through ``repro.train.checkpoint`` and the other
    way, leaf for leaf, bf16 included."""
    jcfg, _ = _cfgs("recurrentgemma-2b", dtype="bfloat16")
    jp, tp = _params(jcfg, seed=4)
    assert any(t.dtype == torch.bfloat16 for _, t in iter_leaves(tp))
    # port -> reference
    ts = TStore()
    assert TC.latest_step(ts, "run") is None
    TC.save(ts, "run", 3, tp)
    TC.save(ts, "run", 7, tp)
    assert TC.latest_step(ts, "run") == 7
    js = JStore()
    _copy_store(ts, js)
    assert JC.latest_step(js, "run") == 7
    got = JC.restore(js, "run", 3, jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and bool(jnp.all(a == b))
    # reference -> port (its manifest and keys byte for byte)
    js2, ts3 = JStore(), TStore()
    JC.save(js2, "ref", 5, jp)
    TC.save(ts3, "ref", 5, tp)
    assert js2._blobs.keys() == ts3._blobs.keys()
    for key, blob in js2._blobs.items():
        assert ts3.get_raw(key) == blob, key
    ts2 = TStore()
    _copy_store(js2, ts2)
    back = TC.restore(ts2, "ref", 5, tp)
    for (pa, a), (pb, b) in zip(iter_leaves(tp), iter_leaves(back)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------
def _lines(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def test_launcher_prints_the_reference_lines():
    """``python -m repro_torch.launch.train --device cpu`` prints what the
    reference's launcher prints, numbers aside, and its loss falls."""
    argv = ["--steps", "5", "--batch", "2", "--seq", "16", "--ckpt-tag", "t"]
    got = _lines(tlaunch.main, argv + ["--device", "cpu"])
    want = _lines(jlaunch.main, argv)
    shape = lambda ls: [re.sub(r"-?\d+(\.\d+)?", "N", x) for x in ls]  # noqa: E731
    assert shape(got) == shape(want), (got, want)
    assert got[0] == want[0]            # arch, parameter count, devices
    losses = [float(re.search(r"loss (\S+)", x).group(1)) for x in got
              if x.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert got[-2:] == ["checkpointed t@5", "done"]

