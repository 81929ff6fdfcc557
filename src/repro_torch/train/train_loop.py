"""The training step (a port of ``repro.train.train_loop``).

``train_step`` is the reference's: the loss and the gradient of every
parameter leaf (``torch.autograd.grad`` where the reference takes
``jax.value_and_grad``), ``microbatch > 1`` accumulating float32 gradients
over batch slices and dividing loss and gradients by their count, then
``adamw_update``. ``make_train_step`` builds the step a launcher calls:
no mesh (one card; sharded training waits for the port's multi-GPU
work), and the update written in place into the parameters and optimizer
state it is given, the counterpart of the reference's ``donate_argnums``.

On the card the step runs through the kernels: K2 (flash attention), K4
(the MoE layers' grouped matmul) and K5 (the RG-LRU scan) forward and
backward through their autograd Functions; ``impl="ref"`` runs their
plain PyTorch versions under autograd instead. ``remat_policy="dots"``
(with ``remat``) keeps the matrix products' outputs of a checkpointed
period and recomputes the rest, as the reference's. K1 and K3, the
serving paths' attention, raise under autograd on the card (they have no
backward kernel).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models.param import iter_leaves, map_tree
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_update


def batch_to(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors, as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params, batch, *, impl=None,
                   remat: bool = True, remat_policy=None):
    """(loss, grads): the loss (a 0-d float32 tensor) and the gradient of
    every leaf of ``params``, a tree of the same keys (a leaf the loss does
    not reach gets zeros, as ``jax.grad`` gives)."""
    paths = [path for path, _ in iter_leaves(params)]
    leaves = {path: p.detach().requires_grad_(True)
              for path, p in iter_leaves(params)}
    tree = map_tree(lambda path, _: leaves[path], params)
    loss = M.loss_fn(cfg, tree, batch, impl=impl, remat=remat,
                     remat_policy=remat_policy)
    grads = torch.autograd.grad(loss, [leaves[p] for p in paths],
                                allow_unused=True)
    by_path = {path: torch.zeros_like(leaves[path]) if g is None else g
               for path, g in zip(paths, grads)}
    return loss.detach(), map_tree(lambda path, _: by_path[path], params)


def train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, params,
               opt_state: AdamWState, batch: Dict[str, Any], *,
               impl: Optional[str] = None, remat: bool = True,
               microbatch: int = 1, remat_policy: Optional[str] = None,
               inplace: bool = False):
    """One optimizer step; ``microbatch > 1`` runs gradient accumulation
    over batch slices (activation memory / microbatch at the cost of
    re-running the forward and backward). Returns (params, opt_state,
    metrics) with ``metrics["loss"]``; ``inplace`` updates the given
    tensors (see ``adamw_update``)."""
    dev = next(p for _, p in iter_leaves(params)).device
    batch = batch_to(batch, dev)
    if microbatch <= 1:
        loss, grads = loss_and_grads(cfg, params, batch, impl=impl,
                                     remat=remat, remat_policy=remat_policy)
    else:
        n = next(iter(batch.values())).shape[0]
        if n % microbatch:
            raise ValueError(f"batch {n} is not a multiple of microbatch "
                             f"{microbatch}")
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        grads = map_tree(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=dev), params)
        for i in range(microbatch):
            part = {k: v.reshape(microbatch, n // microbatch,
                                 *v.shape[1:])[i] for k, v in batch.items()}
            li, gi = loss_and_grads(cfg, params, part, impl=impl, remat=remat,
                                    remat_policy=remat_policy)
            loss = loss + li
            grads = map_tree(lambda path, g: g + _leaf(gi, path), grads)
        loss = loss / microbatch
        grads = map_tree(lambda _, g: g / microbatch, grads)
    new_params, new_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params, inplace=inplace)
    metrics["loss"] = loss
    return new_params, new_state, metrics


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    impl: Optional[str] = None, remat: bool = True,
                    device: DeviceLike = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``device`` (default: the card), batches moved there (numpy arrays
    are taken), the update written in place into ``params`` and the
    state's ``m`` and ``v``."""
    dev = resolve_device(device)

    def step(params, opt_state, batch):
        return train_step(cfg, opt_cfg, params, opt_state, batch_to(batch, dev),
                          impl=impl, remat=remat, inplace=True)
    return step

