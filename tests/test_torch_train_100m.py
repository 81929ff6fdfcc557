"""The port's twin of ``examples/train_100m.py`` against the reference
example, on the CPU.

``repro_torch.examples.train_100m``: ``model_100m()`` equal to the
reference's field for field; a shortened run (3 steps, B=2, S=16) from
the reference's own weights (``init_model_params`` at ``PRNGKey(0)``,
bridged) gives the losses of the reference example's loop (its jitted
``train_step`` with ``remat=False``, its optimizer settings and batches)
within 1e-4, and its final parameters within 1e-4; its printed lines are
the reference example's, numbers aside; and its checkpoint in the port's
``ObjectStore`` restores through the JAX package's
``train.checkpoint``.
"""
import dataclasses
import importlib.util
import io
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.storage import ObjectStore as JStore
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import model as JM
from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro.train.train_loop import train_step as jtrain_step
from repro_torch import bridge
from repro_torch.core.storage import ObjectStore as TStore
from repro_torch.examples import train_100m as T100
from repro_torch.models.param import iter_leaves

# one intra-op thread, so parallel test workers do not spin every core
# that the suite's timing-based tests depend on
torch.set_num_threads(1)

STEPS, BATCH, SEQ = 3, 2, 16
ARGV = ["--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
        "--ckpt-every", str(STEPS)]


def _reference_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "train_100m.py"
    spec = importlib.util.spec_from_file_location("reference_train_100m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(fn):
    out = io.StringIO()
    with redirect_stdout(out):
        result = fn()
    return out.getvalue().splitlines(), result


@pytest.fixture(scope="module")
def runs():
    """The reference example's loop and the twin's ``train`` from the same
    weights: (reference losses, reference params, twin losses, twin
    params, the twin's store, the twin's printed lines)."""
    ref = _reference_example()
    cfg = ref.model_100m()
    ocfg = JO.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=STEPS)
    jp = JM.init_model_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.device_get(jp), device="cpu")
    state = JO.init_opt_state(ocfg, jp)
    pipe = JTokenPipeline(JPipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                                          global_batch=BATCH))
    step_fn = jax.jit(lambda p, o, b: jtrain_step(cfg, ocfg, p, o, b, remat=False))
    jlosses = []
    for _ in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in pipe.next_batch().items()}
        jp, state, metrics = step_fn(jp, state, batch)
        jlosses.append(float(metrics["loss"]))
    store = TStore()
    lines, tlosses = _lines(lambda: T100.train(
        T100.model_100m(), tp, steps=STEPS, batch=BATCH, seq=SEQ,
        ckpt_every=STEPS, store=store))
    return jlosses, jax.device_get(jp), tlosses, tp, store, lines


def test_model_100m_equals_reference():
    want, got = _reference_example().model_100m(), T100.model_100m()
    plain = lambda c: {k: getattr(v, "value", v)  # noqa: E731
                       for k, v in dataclasses.asdict(c).items()}
    assert plain(got) == plain(want)
    assert (got.n_params, got.hd, got.padded_vocab) == \
        (want.n_params, want.hd, want.padded_vocab)


def test_losses_and_weights_match_reference_example(runs):
    jlosses, jp, tlosses, tp, _, _ = runs
    assert len(tlosses) == STEPS
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4)
    assert tlosses[-1] < tlosses[0]
    want = dict(iter_leaves(jp))
    for path, t in iter_leaves(tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[path], np.float32),
                                   atol=1e-4, err_msg=path)


def test_checkpoint_restores_in_the_reference(runs):
    _, jp, _, tp, store, _ = runs
    js = JStore()
    for key, blob in store._blobs.items():
        js.put(blob, key=key)
    cfg = T100.model_100m()
    assert JC.latest_step(js, cfg.name) == STEPS
    back = JC.restore(js, cfg.name, STEPS, jp)
    got = dict(iter_leaves(jax.device_get(back)))
    for path, t in iter_leaves(tp):
        assert np.array_equal(np.asarray(got[path]), t.numpy()), path


def test_prints_the_reference_example_lines(runs, monkeypatch):
    """The twin's lines (its ``main`` on the CPU, and ``train`` from the
    bridged weights) are the reference example's, numbers aside; the
    model line and the step-1 loss on the same weights equal."""
    ref = _reference_example()
    monkeypatch.setattr(sys, "argv", ["train_100m.py"] + ARGV)
    want, _ = _lines(ref.main)
    got, _ = _lines(lambda: T100.main(ARGV + ["--device", "cpu"]))
    shape = lambda ls: [re.sub(r"\d+(\.\d+)?(e[-+]\d+)?", "N", x) for x in ls]  # noqa: E731
    assert shape(got) == shape(want), (got, want)
    assert got[0] == want[0]
    bridged = runs[5]
    assert shape(bridged) == shape(want[1:])
    step_loss = lambda line: float(re.search(r"loss (\S+)", line).group(1))  # noqa: E731
    assert abs(step_loss(bridged[0]) - step_loss(want[1])) <= 1.5e-4
    assert got[-1] == want[-1] == (f"done: latest checkpoint step {STEPS}, "
                                   f"tokens seen {STEPS * BATCH * (SEQ + 1)}")
