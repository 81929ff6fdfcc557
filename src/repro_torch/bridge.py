"""Move parameter and cache trees between numpy and the port, key paths
unchanged.

``from_jax`` takes a nested dict of numpy arrays — the JAX package's params
or paged cache after ``jax.device_get`` — and returns the same tree of
torch tensors; ``to_numpy`` goes back. Tests use it to hand both sides the
SAME weights: arrays, never seeds. bfloat16 arrays (numpy's ``bfloat16``
extension dtype, as JAX returns them) are reinterpreted bit for bit;
``to_numpy`` widens bfloat16 tensors to float32, which holds every bf16
value exactly.

``opt_state_from_jax`` carries an AdamW state across the same way: any
object with ``step``, ``m`` and ``v`` (the reference's ``AdamWState`` after
``jax.device_get``: an int-like step and numpy trees) becomes the port's
``AdamWState``, so a test can start both packages from one optimizer
state; ``opt_state_to_numpy`` goes back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.param import map_tree
from repro_torch.train.optimizer import AdamWState


def _tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr, copy=True).view(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def from_jax(tree, device: DeviceLike = None):
    """Nested dict of numpy arrays -> the same tree of tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return map_tree(lambda _, a: _tensor(a, dev), tree)


def to_numpy(tree):
    """Nested dict of tensors -> the same tree of numpy arrays."""
    def conv(_, t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return map_tree(conv, tree)


def opt_state_from_jax(state, device: DeviceLike = None):
    """(step, m, v) of an AdamW state in numpy -> the port's
    ``AdamWState`` on ``device`` (default: the card)."""
    return AdamWState(step=int(np.asarray(state.step)),
                      m=from_jax(state.m, device), v=from_jax(state.v, device))


def opt_state_to_numpy(state):
    """The port's ``AdamWState`` -> (step, m, v) with numpy trees."""
    return AdamWState(step=int(state.step), m=to_numpy(state.m),
                      v=to_numpy(state.v))
