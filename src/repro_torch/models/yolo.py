"""tiny-YOLOv2, the paper's evaluation workload (Hardless §V): a port of
``repro.models.yolo``.

Eight 3x3 conv layers with batch-norm folded into a per-channel scale and
bias, leaky ReLU 0.1 and a 2x2 max-pool after the first five, then a 1x1
head to 125 channels (5 boxes x (20 VOC classes + 5)): a 416x416 image
gives a 13x13x125 grid. The parameter tree is the reference's, key for key
and shape for shape (``conv{i}`` and ``head`` in HWIO), so
``bridge.from_jax`` carries its weights unchanged.

``yolo_forward`` takes and returns NHWC, as the reference does. Inside it
runs PyTorch's NCHW convolutions (``F.conv2d`` with the weights permuted
to OIHW), where the reference calls ``lax.conv_general_dilated`` outside
any Pallas kernel: there is no TPU kernel here to port. "SAME" 3x3 at
stride 1 is ``padding=1``; "SAME" 2x2 pooling with a ``-inf`` init pads at
the high end only, which is ``ceil_mode=True``. cuDNN runs float32
convolutions in TF32 by default; the forward turns that off for its own
duration, so float32 stays float32 as in the reference.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.param import Spec, init_params

# output channels per conv layer; a 2x2 max-pool follows layers 0..4
CHANNELS = [16, 32, 64, 128, 256, 512, 1024, 1024]
HEAD_OUT = 125  # 5 boxes x (20 classes + 5)
N_POOLED = 5


def yolo_specs(in_ch: int = 3) -> Dict[str, Spec]:
    specs: Dict[str, Spec] = {}
    c_in = in_ch
    for i, c_out in enumerate(CHANNELS):
        specs[f"conv{i}"] = Spec((3, 3, c_in, c_out), scale=0.05)
        specs[f"scale{i}"] = Spec((c_out,), init="ones")
        specs[f"bias{i}"] = Spec((c_out,), init="zeros")
        c_in = c_out
    specs["head"] = Spec((1, 1, c_in, HEAD_OUT), scale=0.05)
    specs["head_b"] = Spec((HEAD_OUT,), init="zeros")
    return specs


def init_yolo_params(seed: int = 0, dtype: str = "float32",
                     device: DeviceLike = None):
    """Random weights from ``seed`` on ``device`` (default: the card)."""
    return init_params(yolo_specs(), seed, dtype, resolve_device(device))


def _channels(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def yolo_forward(params, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3), H = W = 416 for the real model. Returns
    (B, ceil(H/32), ceil(W/32), 125)."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        x = images.permute(0, 3, 1, 2)
        for i in range(len(CHANNELS)):
            x = F.conv2d(x, params[f"conv{i}"].permute(3, 2, 0, 1), padding=1)
            # batch-norm folded into scale/bias (inference form)
            x = x * _channels(params[f"scale{i}"]) + _channels(params[f"bias{i}"])
            x = F.leaky_relu(x, 0.1)
            if i < N_POOLED:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = F.conv2d(x, params["head"].permute(3, 2, 0, 1))
        x = x + _channels(params["head_b"])
    return x.permute(0, 2, 3, 1).contiguous()

