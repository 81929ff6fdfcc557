"""Parameter specification trees and their initialization.

A model definition is a nested dict of :class:`Spec` leaves, with the same
key paths as ``repro.models.param`` (``blocks/p0/wq`` stacked on a leading
``n_periods`` axis). Every leaf gets its own ``torch.Generator`` seeded from
the run seed and a *stable* hash of its path (``zlib.crc32``), so adding or
removing a parameter never reshuffles the others and the same seed gives
the same weights in every process. (Python's ``hash()`` is salted per
process, which is why the JAX package's weights cannot be reproduced from
its seed; tests hand both sides the same arrays through ``bridge``.)
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import torch_dtype


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape + logical axes (one name or None per dim, the reference's:
    ``models.sharding`` maps them to mesh axes) + init recipe."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)
    dtype: Optional[str] = None    # override model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"one logical axis per dim: shape {self.shape}, "
                             f"axes {self.axes}")


def iter_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs of a nested dict in sorted-key order."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from iter_leaves(tree[key], path)
        else:
            yield path, tree[key]


def map_tree(fn, tree, prefix: str = ""):
    """Apply ``fn(path, leaf)`` to every leaf; returns a tree of results."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out[key] = map_tree(fn, val, path) if isinstance(val, dict) \
            else fn(path, val)
    return out


def leaf_seed(seed: int, path: str) -> int:
    """Stable per-leaf generator seed from the run seed and the leaf path."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(path.encode())) % (1 << 63)


def init_leaf(path: str, spec: Spec, seed: int, dtype: str,
              device: torch.device) -> torch.Tensor:
    """The leaf at ``path`` of ``init_params``'s tree, drawn alone from its
    own generator (``init_sharded`` builds a tree one leaf at a time)."""
    dt = torch_dtype(spec.dtype or dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else \
        1.0 / float(np.sqrt(max(fan_in, 1)))
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    arr = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                      device=device)
    return arr.mul_(scale).to(dt)


def init_params(specs, seed: int, dtype: str, device: torch.device):
    """Initialize a parameter tree on ``device`` from a spec tree."""
    return map_tree(lambda path, spec: init_leaf(path, spec, seed, dtype,
                                                 device), specs)
