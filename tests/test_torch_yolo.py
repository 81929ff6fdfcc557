"""The port's tiny-YOLOv2 against the JAX package's on the same weights
(drawn with numpy on the reference's spec tree, the folded batch-norm's
scale and bias too, and handed to the port through the bridge): the spec
tree key for key and shape for shape, and ``yolo_forward`` in float32
within ``1e-4 x max(|ref|, 1)`` (convolution sums run in another order in
XLA and in PyTorch) at 64x64 and at an odd side whose "SAME" pooling pads,
with the same argmax detections."""
import numpy as np
import pytest
import torch

from repro.models import yolo as JY
from repro_torch import bridge
from repro_torch.models import yolo as TY
from repro_torch.models.param import iter_leaves

torch.set_num_threads(1)

RTOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    jparams = {}
    for path, spec in iter_leaves(JY.yolo_specs()):
        draw = rng.standard_normal(spec.shape)
        if spec.init == "normal":
            draw = draw * spec.scale
        else:       # the folded batch-norm: scale near 1, bias near 0
            draw = (1.0 if spec.init == "ones" else 0.0) + 0.1 * draw
        jparams[path] = draw.astype(np.float32)
    return jparams, bridge.from_jax(jparams, device="cpu")


def test_spec_tree_equals_reference():
    want = {p: s.shape for p, s in iter_leaves(JY.yolo_specs())}
    got = {p: s.shape for p, s in iter_leaves(TY.yolo_specs())}
    assert got == want
    assert got["conv0"] == (3, 3, 3, 16) and got["head"] == (1, 1, 1024, 125)
    init = {p: (s.init, s.scale) for p, s in iter_leaves(JY.yolo_specs())}
    assert {p: (s.init, s.scale) for p, s in iter_leaves(TY.yolo_specs())} == init


@pytest.mark.parametrize("hw", [(64, 64), (33, 33)], ids=["64", "33"])
def test_forward_matches_reference(weights, hw):
    jparams, tparams = weights
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(JY.yolo_forward(jparams, x))
    got = TY.yolo_forward(tparams, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, -(-hw[0] // 32),
                                              -(-hw[1] // 32), 125)
    tol = RTOL * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    cells = got.reshape(-1, 125).argmax(-1).numpy()
    assert (cells == want.reshape(-1, 125).argmax(-1)).all()


def test_init_from_seed_is_reproducible_and_on_the_device():
    a = TY.init_yolo_params(0, device="cpu")
    b = TY.init_yolo_params(0, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["conv7"].dtype == torch.float32
    assert torch.equal(a["scale3"], torch.ones(128))
