"""The training step (a port of ``repro.train.train_loop``).

``train_step`` is the reference's: the loss and the gradient of every
parameter leaf (``torch.autograd.grad`` where the reference takes
``jax.value_and_grad``), ``microbatch > 1`` accumulating float32 gradients
over batch slices and dividing loss and gradients by their count, then
``adamw_update``. ``make_train_step(cfg, opt_cfg, mesh)`` builds the
step a launcher calls, the update written in place into the parameters
and optimizer state it is given (the counterpart of the reference's
``donate_argnums``). It returns the step alone, where the reference's
returns (jit_fn, param_shardings, opt_shardings, rules): the step is not
compiled, and ``shardings_for`` / ``opt_shardings`` give the placements.

Under a mesh of more than one rank (``launch.mesh.make_mesh``) the step
runs inside ``axis_rules(mesh, rules_for("train"))`` (or the ``rules``
given, e.g. the no_tp rules, whose batch spans every axis) on the
DTensor trees that ``init_sharded`` (or ``sharding.distribute_params``)
made: ``loss_fn`` runs the sharded forward (``models.sharding``), each
gradient comes back in its parameter's placements, and AdamW updates the
local shards. Every rank passes the whole global batch (tokens, labels,
and a whisper batch's ``frames`` or a llava batch's ``patches``); each
keeps its rows. A one-rank mesh (``make_host_mesh``) runs the one-card
step.

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

import contextlib
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, is_dtensor, resolve_device
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models.param import init_leaf, iter_leaves, map_tree
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_update,
                                         init_opt_state)


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
    by_path = {path: torch.zeros_like(leaves[path]) if g is None else
               _placed_like(g, leaves[path]) for path, g in zip(paths, grads)}
    return loss.detach(), map_tree(lambda path, _: by_path[path], params)


def _placed_like(g, p):
    """A DTensor gradient in its parameter's placements (a partial sum
    left by a body is reduced here); a plain one as it is."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


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
        grads = map_tree(lambda _, p: torch.zeros_like(p, dtype=torch.float32),
                         params)
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


def shardings_for(cfg: ModelConfig, mesh, kind: str = "train",
                  fsdp: bool = True):
    """(param placements tree, rules) from the logical rules (``fsdp``
    counts for ``kind="serve"`` only: training rules always shard the
    weights over the data axes, as the reference's ``rules_for``)."""
    rules = S.rules_for(kind, fsdp=fsdp)
    return S.param_shardings(M.param_specs(cfg), rules, mesh), rules


def opt_shardings(p_shard, mesh) -> AdamWState:
    """The optimizer state's placements: ``m`` and ``v`` as the parameters
    (``step`` is a host int)."""
    return AdamWState(step=None, m=p_shard, v=p_shard)


def batch_shardings(batch_specs, mesh, rules) -> Dict[str, Any]:
    """Placements of each batch tensor of ``batch_specs`` (name -> anything
    with a ``shape``): dim 0 over the batch's axes."""
    return {k: S.batch_sharding(v.shape, mesh, rules)
            for k, v in batch_specs.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None, *,
                    impl: Optional[str] = None, remat: bool = True,
                    device: DeviceLike = None, rules=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``device`` (default: the card), batches moved there (numpy arrays
    are taken), the update written in place into ``params`` and the
    state's ``m`` and ``v``. With a ``mesh`` of more than one rank the step
    runs under ``rules`` (default ``rules_for("train")``, which shards the
    weights over the data axes always: FSDP; ``rules_for("train",
    no_tp=True)`` puts the batch on every axis; see the module
    docstring)."""
    dev = resolve_device(device)
    rules = rules or S.rules_for("train")

    def step(params, opt_state, batch):
        ctx = S.axis_rules(mesh, rules) if mesh is not None and \
            S.mesh_size(mesh) > 1 else contextlib.nullcontext()
        with ctx:
            return train_step(cfg, opt_cfg, params, opt_state,
                              batch_to(batch, dev), impl=impl, remat=remat,
                              inplace=True)
    return step


def init_sharded(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, seed: int = 0,
                 device: DeviceLike = None):
    """(params, opt_state, param placements, opt placements, rules) with
    every leaf drawn alone from its own generator (``param.init_leaf``, the
    same weights ``init_model_params(cfg, seed)`` draws) and only the local
    shard kept, so the same seed gives the same weights on every mesh."""
    dev = resolve_device(device)
    p_shard, rules = shardings_for(cfg, mesh, "train")
    placed = dict(iter_leaves(p_shard))

    params = map_tree(lambda path, spec: S.shard_tensor(
        init_leaf(path, spec, seed, cfg.dtype, dev), mesh, placed[path]),
        M.param_specs(cfg))
    return (params, init_opt_state(opt_cfg, params), p_shard,
            opt_shardings(p_shard, mesh), rules)


def init_sharded_empty(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                       device: DeviceLike = None, rules=None):
    """(params, opt_state) as ``init_sharded`` places them, with no weights
    drawn: each parameter's local shard ``torch.empty`` (in a fake-tensor
    mode, a shape and no storage: the dry run's arguments) and ``m``, ``v``
    in ``opt_cfg.state_dtype`` in the same placements; under ``rules``
    (default ``rules_for("train")``)."""
    params = S.sharded_leaves(M.param_specs(cfg), rules or S.rules_for("train"), mesh,
                              cfg.dtype, device, torch.empty)
    return params, init_opt_state(opt_cfg, params)
