"""The rank side of ``test_torch_distributed.py``,
``test_torch_sharded_serve.py`` and ``test_torch_sharded_families.py``:
run in the processes of
a ``launch.mesh.run_world`` world (gloo on the CPU). Imports torch and the
port only, never jax: the JAX side of each comparison runs in the test's
own process.

``run(rank, job)`` builds the job's mesh and runs its tasks in order,
returning {task name: result} on rank 0 (None elsewhere; every rank takes
part in each gather). Weights come as ``.npz`` files written through
``repro_torch.bridge`` (``/``-joined leaf paths).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models.param import iter_leaves
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import (init_sharded, make_train_step,
                                          train_step)


def cfg_of(arch: str, over: dict):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def load_tree(path: str):
    """An ``.npz`` of ``/``-joined leaf paths -> the nested tree of CPU
    tensors."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = z[key]
    return bridge.from_jax(tree, "cpu")


def _np(t) -> np.ndarray:
    return bridge.to_numpy({"t": t})["t"]


def _gathered(params):
    """The whole tree as numpy copies (``to_numpy`` may share a float32
    tensor's memory, which the in-place update then changes)."""
    from repro_torch.models.param import map_tree
    return map_tree(lambda _, a: np.array(a, copy=True),
                    bridge.to_numpy(S.full_tree(params)))


def replica_spread(params, mesh) -> float:
    """The largest difference between two ranks' copies of the same shard
    of a leaf, over every leaf and every mesh dim the leaf is replicated
    on (zero when the ranks agree bit for bit)."""
    import torch.distributed as dist
    worst = 0.0
    for _, t in iter_leaves(params):
        local = t.to_local().float().contiguous()
        for i, pl in enumerate(t.placements):
            if pl.is_replicate():
                group = mesh.get_group(i)
                parts = [torch.empty_like(local)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, local, group=group)
                worst = max(worst, max(float((q - parts[0]).abs().max())
                                       for q in parts))
    return worst


def _forward(task, cfg, mesh):
    params = load_tree(task["weights"])
    B.MOE_A2A_CAPACITY_FACTOR = task.get("capacity", 1.25)
    tokens = torch.from_numpy(np.asarray(task["tokens"]))
    with S.axis_rules(mesh, S.rules_for("train", **task.get("rules", {}))):
        if task["kind"] == "loss":
            batch = {"tokens": tokens,
                     "labels": torch.from_numpy(np.asarray(task["labels"]))}
            return float(M.loss_fn(cfg, params, batch, remat=False))
        logits, _, aux = M.forward_with_aux(cfg, params, {"tokens": tokens},
                                            mode="train")
        return {"logits": _np(S.gather_full(logits)),
                "aux": None if aux is None else float(aux.to_local())}


@contextlib.contextmanager
def count_saved_dots():
    """While open, ``model._save_dots`` counts the products the ``dots``
    policy saves; yields the counter (a list of one int)."""
    from torch.utils.checkpoint import CheckpointPolicy
    policy, saved = M._save_dots, [0]

    def counted(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        saved[0] += out == CheckpointPolicy.MUST_SAVE
        return out
    M._save_dots = counted
    try:
        yield saved
    finally:
        M._save_dots = policy


def _train(task, cfg, mesh):
    with count_saved_dots() as saved:
        out = _train_steps(task, cfg, mesh)
    out["dots_saved"] = saved[0]
    return out


def _train_steps(task, cfg, mesh):
    ocfg = O.AdamWConfig(**task["opt"])
    params, state, _, _, _ = init_sharded(cfg, ocfg, mesh, seed=task["seed"],
                                          device="cpu")
    out = {"init": _gathered(params)}
    if task.get("remat_policy"):    # the dots policy, under the same rules
        def step(p, s, b):
            with S.axis_rules(mesh, S.rules_for("train")):
                return train_step(cfg, ocfg, p, s, b, remat=True, inplace=True,
                                  remat_policy=task["remat_policy"])
    else:
        step = make_train_step(cfg, ocfg, mesh, remat=task.get("remat", True),
                               device="cpu")
    losses, norms = [], []
    for b in task["batches"]:
        params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out.update(losses=losses, grad_norms=norms,
               replica_spread=replica_spread(params, mesh),
               final=_gathered(params),
               local_is_shard=params["embed"]["tok"].to_local().numel()
               < params["embed"]["tok"].numel())
    return out


def _refusals(task, cfg, mesh):
    """The whole-sequence forward of ``family_arch`` (from
    ``init_model_params(cfg, 0)``) under ``rules_for("train",
    **family_rules)`` on ``family_tokens``, its logits gathered; and the
    TypeError of a DTensor handed to a kernel wrapper."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import ops
    fam = cfg_of(task["family_arch"], {})
    params = M.init_model_params(fam, 0, "cpu")
    tokens = torch.from_numpy(np.asarray(task["family_tokens"]))
    out = {}
    with S.axis_rules(mesh, S.rules_for("train", **task.get("family_rules", {}))):
        logits, _, _ = M.forward_with_aux(fam, params, {"tokens": tokens}, mode="train")
        out["family"] = _np(S.gather_full(logits))
    q = distribute_tensor(torch.randn(1, 8, 2, 64), mesh,
                          [Replicate()] * mesh.ndim)
    x = distribute_tensor(torch.randn(8, 64), mesh, [Replicate()] * mesh.ndim)
    w = torch.randn(2, 64, 64)
    errors = {}
    for name, call in (
            ("flash_attention", lambda: ops.flash_attention(q, q, q)),
            ("moe_gmm", lambda: ops.moe_gmm(
                x, w, torch.tensor([4, 4], dtype=torch.int32)))):
        try:
            call()
            errors[name] = None
        except TypeError as e:
            errors[name] = str(e)
    out["kernels"] = errors
    try:
        make_mesh((2, 4), ("data", "model"), device="cpu", backend="gloo")
        out["mesh"] = None
    except ValueError as e:
        out["mesh"] = str(e)
    return out


def spec_of(t, mesh) -> tuple:
    """A DTensor's placements as a spec tuple (the mesh axes that shard each
    dim, trailing Nones stripped), to hold against the reference's
    ``spec_for``."""
    out = []
    for d in range(t.dim()):
        axes = tuple(a for a, pl in zip(mesh.mesh_dim_names, t.placements)
                     if pl.is_shard(d))
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def narrow_kv(tree, dtype=torch.int8):
    """A cache tree with its attention ``k``, ``v`` leaves narrowed to
    ``dtype`` through ``layers.saturate_cast`` (a DTensor leaf's local
    shard, its placements kept), as the reference's ``astype`` narrows a
    prefill's cache for an int8 decode."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.layers import saturate_cast
    from repro_torch.models.param import map_tree

    def narrow(path, t):
        if path.split("/")[-1] not in ("k", "v"):
            return t
        if isinstance(t, DTensor):
            return DTensor.from_local(saturate_cast(t.to_local(), dtype), t.device_mesh,
                                      t.placements, run_check=False, shape=t.shape,
                                      stride=t.stride())
        return saturate_cast(t, dtype)
    return map_tree(narrow, tree)


def _serve(task, cfg, mesh):
    """``prefill`` then ``decode_step`` of each of ``task["steps"]`` under
    the serve rules (weights placed by ``distribute_params``, int8 where
    the file holds int8; the first step takes the prefill's cache gathered
    whole, a plain tree the step places itself, ``distribute_cache``):
    every step's logits gathered, the last cache gathered, and each cache
    leaf's placements as a spec tuple. A whisper task's ``frames`` and a
    llava task's ``patches`` join the prefill's batch; the decode
    positions start after the patches. ``no_tp`` serves under the no_tp
    rules; ``kv_dtype`` narrows the prefill's K/V (``narrow_kv``) before
    the decode steps."""
    B.MOE_A2A_CAPACITY_FACTOR = task.get("capacity", 1.25)
    rules = S.rules_for("serve", fsdp=task["fsdp"], moe_a2a=task.get("a2a", False),
                        no_tp=task.get("no_tp", False))
    kv_dtype = task.get("kv_dtype")
    params = S.distribute_params(load_tree(task["weights"]), M.param_specs(cfg),
                                 rules, mesh)
    tokens = torch.from_numpy(np.asarray(task["tokens"]))
    batch = {"tokens": tokens, **{k: torch.from_numpy(np.asarray(task[k]))
                                  for k in ("frames", "patches") if k in task}}
    Bsz, Sq = tokens.shape
    start = Sq + (batch["patches"].shape[1] if "patches" in batch else 0)
    with S.axis_rules(mesh, rules):
        logits, cache = M.prefill(cfg, params, batch, cache_len=task["cache_len"])
        outs = [_np(S.gather_full(logits))]
        specs = {p: spec_of(t, mesh) for p, t in iter_leaves(cache)}
        cache = S.full_tree(cache)
        if kv_dtype:
            cache = narrow_kv(cache)
        pos = torch.full((Bsz,), start, dtype=torch.int32)
        for tok in task["steps"]:
            logits, cache = M.decode_step(cfg, params, cache,
                                          torch.from_numpy(np.asarray(tok)), pos)
            outs.append(_np(S.gather_full(logits)))
            pos = pos + 1
    # the zero cache drawn sharded, and a whole one distributed, placed alike
    zero = S.init_sharded_cache(cfg, Bsz, task["cache_len"], mesh, rules, "cpu",
                                kv_dtype=kv_dtype)
    whole = S.distribute_cache(M.init_cache(cfg, Bsz, task["cache_len"], "cpu",
                                            kv_dtype=kv_dtype), cfg, rules, mesh)
    placed = all(spec_of(z, mesh) == specs[p] and spec_of(w, mesh) == specs[p]
                 and z.to_local().shape == w.to_local().shape
                 and z.dtype == w.dtype == c.dtype and not z.to_local().any()
                 for (p, z), (_, w), (_, c) in
                 zip(iter_leaves(zero), iter_leaves(whole), iter_leaves(cache)))
    return {"logits": np.stack(outs), "specs": specs, "zero_placed": placed,
            "decode_specs": {p: spec_of(t, mesh) for p, t in iter_leaves(cache)},
            "cache": dict(iter_leaves(_gathered(cache)))}


def _serve_refusals(task, cfg, mesh):
    """Each refusal of the sharded path, one case each, under its rules:
    {case: the NotImplementedError's (or, for training with int8 weights,
    the TypeError's) message, or None where none was raised}."""
    serve = S.rules_for("serve", fsdp=False)
    tokens = torch.zeros((4, 8), dtype=torch.long)
    pos = torch.full((4,), 8, dtype=torch.int32)
    gr = cfg_of("granite-3-2b", {})
    gp = M.init_model_params(gr, 0, "cpu")
    cache = M.init_cache(gr, 4, 16, "cpu")
    cases = {
        "chunk": (serve, lambda: M.prefill_chunk(gr, gp, cache, tokens, 0, None)),
        "paged": (serve, lambda: M.decode_step(
            gr, gp, M.init_paged_cache(gr, 4, 16, 9, 4, "cpu"), tokens[:, :1], pos,
            block_tables=torch.zeros((4, 4), dtype=torch.int32))),
        "mask": (serve, lambda: M.decode_step(gr, gp, cache, tokens[:, :1], pos,
                                              mask=torch.ones(4, dtype=torch.bool))),
        "int8_weights_train": (S.rules_for("train"), lambda: M.loss_fn(
            gr, M.narrow_weights(gp), {"tokens": tokens, "labels": tokens})),
    }
    out = {}
    for name, (rules, call) in cases.items():
        with S.axis_rules(mesh, rules):
            try:
                call()
                out[name] = None
            except (NotImplementedError, TypeError) as e:
                out[name] = str(e)
    return out


def _train_rules(task, cfg, mesh):
    """``make_train_step(..., rules=rules_for("train", **task["rules"]))``
    (the no_tp rules: the batch on every axis) from the task's weights,
    placed by those rules (``distribute_params``), each batch whole on
    every rank:
    the losses, the gathered parameters after the steps, the replicas'
    largest difference and every leaf's compute placements of the first
    MoE layer's body as spec tuples (``Layout.placements``)."""
    ocfg = O.AdamWConfig(**task["opt"])
    rules = S.rules_for("train", **task["rules"])
    params = S.distribute_params(load_tree(task["weights"]), M.param_specs(cfg),
                                 rules, mesh)
    state = O.init_opt_state(ocfg, params)
    step = make_train_step(cfg, ocfg, mesh, device="cpu", rules=rules)
    losses = []
    for b in task["batches"]:
        params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))
    Bsz, Sq = np.asarray(task["batches"][0]["tokens"]).shape
    plan = S.make_plan(mesh, rules, Bsz)
    lay = B.layout(cfg, params["blocks"]["p0"], plan, Bsz, Sq)
    return {"losses": losses, "final": _gathered(params),
            "replica_spread": replica_spread(params, mesh),
            "gather": lay.gather, "moe": lay.moe,
            "grad_placements": {n: [str(p) for p in lay.placements(plan, n)[1]]
                                for n in B.MOE_LEAVES}}


TASKS = {"forward": _forward, "loss": _forward, "train": _train,
         "refusals": _refusals, "serve": _serve, "serve_refusals": _serve_refusals,
         "train_rules": _train_rules}


def run(rank: int, job: dict):
    mesh = make_mesh(job["mesh"], job["axes"], device="cpu", backend="gloo")
    results = {}
    for task in job["tasks"]:
        cfg = cfg_of(task["arch"], task.get("over", {}))
        results[task["name"]] = TASKS[task["kind"]](task, cfg, mesh)
    return results if rank == 0 else None
