"""AdamW with a cosine schedule (a port of ``repro.train.optimizer``).

The same configuration, state and update as the reference: ``AdamWConfig``
(``state_dtype`` float32 or bfloat16 for ``m`` and ``v``), ``AdamWState``,
``cosine_lr``, ``init_opt_state``, ``global_norm`` and ``adamw_update``,
with the update's float32 arithmetic op for op. The learning rate and the
bias corrections are host scalars computed in float32, as the reference's
weakly typed scalars are; ``AdamWState.step`` is a Python int, so a step
reads nothing back from the card. The clip scale stays a 0-d tensor on the
card.

Memory: the update goes leaf by leaf and, within a leaf, over slices of at
most ``UPDATE_SLICE`` elements, so its float32 temporaries are a slice's,
not a leaf's: a stacked (40, 2048, 8192) bf16 leaf of granite-3-2b would
need 2.7 GB for each float32 temporary of a whole-leaf update, several at
once. ``adamw_update(..., inplace=True)`` writes the new parameters, ``m``
and ``v`` into the tensors it is given (the train step's counterpart of
the reference's ``donate_argnums``); ``inplace=False`` returns new tensors
and leaves its inputs as they were.

Under a mesh the leaves are DTensors (``train_loop.init_sharded``): the
update is elementwise, so each rank updates its local shards in place (the
slicing and ``reshape(-1)`` run on the local tensors, where on a DTensor
they would gather it) and the result is exact; ``global_norm`` counts each
element once, from the rank at coordinate 0 of every mesh dim that
replicates it, and sums over the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import is_dtensor, torch_dtype
from repro_torch.models.param import iter_leaves, map_tree

UPDATE_SLICE = 1 << 24      # elements a slice of the update (64 MB float32)


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"   # bf16 halves the optimizer's memory


def cosine_lr(cfg: AdamWConfig, step) -> float:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac * lr``;
    float32 arithmetic, as the reference's."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip((step - f32(cfg.warmup_steps)) /
                   f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0), f32(1))
    cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
    frac = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * cos
    return float(f32(cfg.lr) * warm * frac)


def init_opt_state(cfg: AdamWConfig, params) -> AdamWState:
    """Zero ``m`` and ``v`` in ``state_dtype``, laid out as the parameters
    (DTensors in the same placements under a mesh)."""
    dt = torch_dtype(cfg.state_dtype)
    zeros = lambda _, p: torch.zeros_like(p, dtype=dt,  # noqa: E731
                                          memory_format=torch.contiguous_format)
    return AdamWState(step=0, m=map_tree(zeros, params),
                      v=map_tree(zeros, params))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _counts_here(t) -> bool:
    """Whether this rank's shard of DTensor ``t`` is the one counted: the
    rank at coordinate 0 of every mesh dim that replicates ``t``."""
    mesh = t.device_mesh
    return all(not pl.is_replicate() or mesh.get_local_rank(i) == 0
               for i, pl in enumerate(t.placements))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in key order) of each leaf's float32
    sum of squares; a 0-d float32 tensor on the leaves' device. DTensor
    leaves: each element once, summed over the mesh."""
    total, mesh = None, None
    for _, x in iter_leaves(tree):
        if is_dtensor(x):
            mesh = x.device_mesh
            if not _counts_here(x):
                continue
        s = torch.sum(torch.square(_local(x).float()))
        total = s if total is None else total + s
    if mesh is not None:
        import torch.distributed as dist
        x = next(t for _, t in iter_leaves(tree))
        total = _local(x).new_zeros((), dtype=torch.float32) \
            if total is None else total
        for i in range(mesh.ndim):
            dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params, *,
                 inplace: bool = False
                 ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step with global-norm clipping and decoupled weight decay.
    Returns (params, state, {"grad_norm", "lr"}); with ``inplace`` the
    returned trees are the given tensors, updated."""
    step = state.step + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = 1.0
    lr = cosine_lr(cfg, step)
    f32 = np.float32
    bc1 = float(f32(1) - f32(cfg.b1) ** f32(step))
    bc2 = float(f32(1) - f32(cfg.b2) ** f32(step))

    def upd(g, m, v, p):
        g = g.float() * scale
        m1 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v1 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mh = m1 / bc1
        vh = v1 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + \
            cfg.weight_decay * p.float()
        return p.float() - lr * delta, m1, v1

    new_p, new_m, new_v = {}, {}, {}
    g_leaves = dict(iter_leaves(grads))
    m_leaves, v_leaves = dict(iter_leaves(state.m)), dict(iter_leaves(state.v))
    for path, p in iter_leaves(params):
        m, v = m_leaves[path], v_leaves[path]
        outs = (p, m, v) if inplace else \
            tuple(torch.empty_like(t) for t in (p, m, v))
        flat = [_local(t).reshape(-1) for t in (g_leaves[path], m, v, p)]
        dst = [_local(t).view(-1) for t in outs]
        for lo in range(0, max(flat[3].numel(), 1), UPDATE_SLICE):
            piece = [t[lo:lo + UPDATE_SLICE] for t in flat]
            for d, val in zip(dst, upd(*piece)):
                d[lo:lo + UPDATE_SLICE].copy_(val)
        new_p[path], new_m[path], new_v[path] = outs
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (_unflatten(params, new_p),
            AdamWState(step=step, m=_unflatten(state.m, new_m),
                       v=_unflatten(state.v, new_v)), metrics)


def _unflatten(like, by_path: Dict[str, torch.Tensor]):
    return map_tree(lambda path, _: by_path[path], like)

