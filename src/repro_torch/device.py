"""Device resolution for the port's entry points.

Entry points default to the card. They run on the CPU only when the caller
passes ``device="cpu"``; with no card and no explicit CPU request they
raise instead of falling back.
"""
from __future__ import annotations

import sys
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """Map a config dtype name ("bfloat16", "float32") to a torch dtype."""
    dt = getattr(torch, name or "float32", None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``. Where nothing imported
    ``torch.distributed.tensor`` no DTensor can exist, and its import (a
    second or more) is not paid on the one-card path."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)
