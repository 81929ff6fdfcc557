"""Multi-pod dry run: trace one step of every (architecture x input shape)
on the production meshes and record per-device memory, per-chip FLOPs,
bytes and collectives, and the roofline terms (the port of
``repro.launch.dryrun``).

Nothing is allocated on a card and nothing is launched. The step is the
one the card runs (``impl=None``: the hand-written kernels' wrappers),
traced on fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage) over a fake process group of 256 or 512 ranks
(``launch.mesh.make_production_mesh``; this process is rank 0). Every
argument is a DTensor in the placements the reference's ``spec_for``
gives it, each leaf only this rank's shard. ``roofline.collectives``'
``StepCounter`` counts what the step issues on this rank: the
collectives by the reference's five names, the FLOPs of the matrix
products, every operator's bytes, and the storages it allocates; each
kernel wrapper, given fake operands, records its own FLOPs and bytes
(``kernels.build.recording_costs``).

Where the reference differs (ROADMAP, known differences): it lowers its
``"xla"`` path, since Pallas cannot lower for placeholder CPU devices, and
the port traces the path the card runs; and XLA's ``cost_analysis``
counts a while loop's body once, so the reference lowers a 0-layer and a
1-period program and adds the stubbed attention and sLSTM terms back
from an analytic model, where the port counts every operator as it runs,
at full depth, and the kernels record their own work.

``bytes_per_device`` is the arguments' bytes (this rank's shards; a
train step's counter, which the reference passes as a 0-d int32 array
and the port holds as a host int, counted at its 4 bytes) plus the peak
of what the step allocates beyond them (``StepCounter``: a dispatch mode
over the fake storages, not ``MemTracker``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh both --out results/dryrun_torch_all.json

The trace's device type is the card's where the process has one, else the
CPU's; it picks only the two model branches that differ between them
(``layers.unembed``, ``sharding.row_parallel``), and allocates on neither.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.configs.base import (BlockKind, InputShape, ModelConfig, SHAPES,
                                      get_config, input_specs, list_archs)
from repro_torch.device import is_dtensor, torch_dtype
from repro_torch.kernels import build as KB
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models.sharding import FSDP_SERVE_BYTES  # noqa: F401 (the reference's name)
from repro_torch.roofline import analytic
from repro_torch.roofline.analysis import build_report
from repro_torch.roofline.collectives import StepCounter
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import init_sharded_empty, train_step

# Sliding-window serve variant for long-context decode on pure-dense archs:
# window 8192, an explicit variant, not the checkpoint semantics. Archs that
# are already sub-quadratic run unmodified.
LONG_CONTEXT_WINDOW = 8192

# whisper-tiny x long_500k is semantically void (enc-dec audio): skipped.
SKIPS = {("whisper-tiny", "long_500k"): "enc-dec audio; 524k-token decode "
         "of a 30s clip is semantically void (DESIGN.md §4)"}

# the bytes of the train step's counter (an int32 in the reference)
STEP_COUNTER_BYTES = 4


@dataclasses.dataclass
class Opts:
    """Perf-iteration knobs (the reference's fields; ``impl`` None is the
    card's path, "ref" the plain PyTorch versions)."""
    remat: bool = True
    impl: Optional[str] = None
    fsdp_serve: Optional[bool] = None     # None = auto by size
    opt_state_dtype: str = "float32"
    no_tp: bool = False                   # fold model axis into FSDP (no
                                          # Megatron activation all-reduces)
    moe_a2a: bool = False                 # seq-parallel expert-parallel a2a
    cache_dtype: Optional[str] = None     # e.g. "int8" quantized KV cache
    weight_dtype: Optional[str] = None    # e.g. "int8" weight-only quant
    microbatch: int = 1                   # gradient accumulation slices
    remat_policy: Optional[str] = None    # None=full remat | "dots"


# fields a step of the other kind has no use for, at their defaults
_TRAIN_ONLY = {"remat": True, "opt_state_dtype": "float32", "microbatch": 1,
               "remat_policy": None}
_SERVE_ONLY = {"fsdp_serve": None, "weight_dtype": None, "cache_dtype": None}


def check_opts(opts: Opts, kind: str) -> None:
    """Raise ``NotImplementedError`` naming an ``Opts`` field the port
    cannot honour for a step of ``kind``, never ignoring it in silence."""
    if opts.impl not in (None, "ref"):
        raise NotImplementedError(
            f"impl={opts.impl!r}: the port traces its kernels (None) or their plain "
            "versions ('ref'); the reference's XLA and Pallas lowerings have no twin")
    unused = dict(_SERVE_ONLY) if kind == "train" else dict(_TRAIN_ONLY)
    if kind == "prefill":
        unused["cache_dtype"] = None        # prefill builds its cache in cfg.dtype
    for name, default in unused.items():
        if getattr(opts, name) != default:
            raise NotImplementedError(f"{name}={getattr(opts, name)!r} in a {kind} "
                                      "step: the port has no use for it there")


def variant_for(cfg: ModelConfig, shape: InputShape) -> Optional[ModelConfig]:
    """Returns the config (possibly a documented variant) or None to skip."""
    if (cfg.name, shape.name) in SKIPS:
        return None
    if shape.name == "long_500k":
        kinds = set(cfg.layer_pattern)
        # natively long-context: no global-attention layers, OR chunked
        # local attention carries most layers (llama4 iRoPE: the minority
        # global layers keep a full 524k cache; B=1 decode affords it)
        subquad = (BlockKind.ATTN not in kinds) or \
            (BlockKind.CHUNKED_ATTN in kinds)
        if not subquad:
            # pure/partly global attention -> sliding-window serve variant
            pattern = tuple(BlockKind.LOCAL_ATTN if k == BlockKind.ATTN else k
                            for k in cfg.pattern)
            return dataclasses.replace(
                cfg, name=cfg.name + "-sw8k", pattern=pattern,
                window=max(cfg.window, LONG_CONTEXT_WINDOW))
    return cfg


def serve_fsdp(cfg: ModelConfig, opts: Opts) -> bool:
    if opts.fsdp_serve is not None:
        return opts.fsdp_serve
    return S.serve_fsdp(cfg)


def trace_device() -> str:
    """The device type traced for: the card's where there is one, else
    the CPU's (see the module docstring)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


# ----------------------------------------------------------------------
# Step builders: (step, args); call them inside a FakeTensorMode
# ----------------------------------------------------------------------
def _batch(cfg: ModelConfig, shape: InputShape, rules, mesh, device):
    """The input batch, each tensor this rank's rows in the batch's
    placements (the reference's ``_batch_abstract``)."""
    specs = input_specs(cfg, shape, device)
    return {k: S.placed(v.shape, v.dtype, S.batch_sharding(v.shape, mesh, rules),
                        mesh, device) for k, v in specs.items()}


def _under(fn: Callable, mesh, rules) -> Callable:
    def step(*args):
        with S.axis_rules(mesh, rules):
            return fn(*args)
    return step


def build_train(cfg: ModelConfig, shape: InputShape, mesh, opts: Opts, device):
    check_opts(opts, "train")
    rules = S.rules_for("train", fsdp=True, no_tp=opts.no_tp, moe_a2a=opts.moe_a2a)
    ocfg = AdamWConfig(state_dtype=opts.opt_state_dtype)
    params, opt_state = init_sharded_empty(cfg, ocfg, mesh, device, rules)
    batch = _batch(cfg, shape, rules, mesh, device)

    def fn(params, opt_state, batch):
        return train_step(cfg, ocfg, params, opt_state, batch, impl=opts.impl,
                          remat=opts.remat, microbatch=int(opts.microbatch),
                          remat_policy=opts.remat_policy, inplace=True)
    return _under(fn, mesh, rules), (params, opt_state, batch)


def _serve_params(cfg: ModelConfig, rules, mesh, opts: Opts, device):
    params = S.sharded_leaves(M.param_specs(cfg), rules, mesh, cfg.dtype, device)
    return M.narrow_weights(params, opts.weight_dtype) if opts.weight_dtype else params


def build_prefill(cfg: ModelConfig, shape: InputShape, mesh, opts: Opts, device):
    check_opts(opts, "prefill")
    rules = S.rules_for("serve", fsdp=serve_fsdp(cfg, opts), no_tp=opts.no_tp,
                        moe_a2a=opts.moe_a2a)
    params = _serve_params(cfg, rules, mesh, opts, device)
    batch = _batch(cfg, shape, rules, mesh, device)
    return _under(lambda p, b: M.prefill(cfg, p, b, impl=opts.impl), mesh, rules), \
        (params, batch)


def build_decode(cfg: ModelConfig, shape: InputShape, mesh, opts: Opts, device):
    check_opts(opts, "decode")
    rules = S.rules_for("serve", fsdp=serve_fsdp(cfg, opts), no_tp=opts.no_tp,
                        moe_a2a=opts.moe_a2a)
    params = _serve_params(cfg, rules, mesh, opts, device)
    cache = S.sharded_leaves(M.cache_specs(cfg, shape.global_batch, shape.seq_len,
                                           kv_dtype=opts.cache_dtype),
                             rules, mesh, cfg.dtype, device)
    batch = _batch(cfg, shape, rules, mesh, device)

    def fn(params, cache, tokens, pos):
        return M.decode_step(cfg, params, cache, tokens, pos, impl=opts.impl)
    return _under(fn, mesh, rules), (params, cache, batch["tokens"], batch["pos"])


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


# ----------------------------------------------------------------------
# Tracing one step
# ----------------------------------------------------------------------
def local_tensors(tree) -> list:
    """Every tensor of a nest of dicts, tuples and lists, a DTensor as its
    local shard (an ``AdamWState``'s host-int step is no tensor)."""
    if isinstance(tree, dict):
        return [t for _, v in sorted(tree.items()) for t in local_tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in local_tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.to_local() if is_dtensor(tree) else tree]
    return []


def trace(step: Callable, args: Sequence, extra_arg_bytes: int = 0) -> Dict[str, Any]:
    """Run ``step(*args)`` once on fake tensors (call it inside the fake
    mode that made ``args``) under a ``StepCounter`` and the kernels' cost
    record: {"argument_bytes", "peak_bytes" (allocated beyond the
    arguments), "bytes_per_device", "flops", "bytes" (unfused operators
    and the kernels' reckoning), "collectives" ((total, per type, counts)),
    "collective_ops" (by operator name), "kernels" (per wrapper: calls,
    flops, bytes), "trace_s" (host seconds)}."""
    locals_ = local_tensors(args)
    arg_bytes = KB.nbytes(*locals_) + extra_arg_bytes
    counter = StepCounter()
    counter.track(locals_)
    t0 = time.perf_counter()
    with KB.recording_costs() as kernels, counter:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    del out
    flops = counter.flops + sum(r["flops"] for r in kernels.values())
    n_bytes = counter.op_bytes + sum(r["bytes"] for r in kernels.values())
    return {"argument_bytes": arg_bytes, "peak_bytes": counter.peak,
            "bytes_per_device": arg_bytes + counter.peak, "flops": flops,
            "bytes": n_bytes, "collectives": counter.collective_bytes(),
            "collective_ops": dict(counter.by_op), "kernels": kernels,
            "trace_s": trace_s}


@contextlib.contextmanager
def fake_mode():
    """The fake-tensor mode a dry run builds its arguments and traces in."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        yield


# ----------------------------------------------------------------------
def run_combo(arch: str, shape_name: str, mesh_name: str,
              opts: Optional[Opts] = None, verbose: bool = True,
              device: Optional[str] = None) -> Dict[str, Any]:
    opts = opts or Opts()
    device = device or trace_device()
    shape = SHAPES[shape_name]
    cfg0 = get_config(arch)
    cfg = variant_for(cfg0, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "ok",
                           "opts": dataclasses.asdict(opts)}
    if cfg is None:
        rec.update(status="skip", reason=SKIPS[(arch, shape_name)])
        return rec
    if cfg.name != cfg0.name:
        rec["variant"] = cfg.name

    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"), device=device)
    chips = mesh_chips(mesh)
    t0 = time.time()
    try:
        with fake_mode():
            step, args = BUILDERS[shape.kind](cfg, shape, mesh, opts, device)
            got = trace(step, args, STEP_COUNTER_BYTES if shape.kind == "train" else 0)
            del step, args
        mem = got["bytes_per_device"]
        report = build_report(cfg, shape, mesh_name, chips,
                              {"flops": got["flops"], "bytes accessed": got["bytes"]},
                              got["collectives"], bytes_per_device=mem)
        # fusion-aware HBM model (the memory term; the traced bytes are kept
        # as the unfused upper bound)
        sizes = S.mesh_axis_sizes(mesh)
        fsdp = True if shape.kind == "train" else serve_fsdp(cfg, opts)
        report.model_bytes = analytic.memory_model(
            cfg, shape, sizes.get("data", 1), sizes.get("model", 1),
            sizes.get("pod", 1), fsdp=fsdp,
            opt_state_bytes=torch_dtype(opts.opt_state_dtype).itemsize,
            weight_bytes=(torch_dtype(opts.weight_dtype).itemsize
                          if opts.weight_dtype else 2),
            cache_bytes=(torch_dtype(opts.cache_dtype).itemsize
                         if opts.cache_dtype else 2),
            microbatch=int(opts.microbatch))
        rec.update(
            trace_s=round(time.time() - t0, 1),
            device=device,
            chips=chips,
            report=report.to_dict(),
            hlo_bytes_per_device=mem,
            argument_bytes=got["argument_bytes"],
            peak_bytes=got["peak_bytes"],
            collective_ops=got["collective_ops"],
            kernels=got["kernels"],
            n_params=cfg.n_params,
            n_active_params=cfg.n_active_params,
        )
        if verbose:
            r = report
            print(f"[ok] {arch:26s} {shape_name:12s} {mesh_name:6s} "
                  f"chips={chips:3d} trace={rec['trace_s']:6.1f}s "
                  f"mem/dev={mem / 2**30:6.2f}GiB "
                  f"t_comp={r.t_compute*1e3:8.2f}ms t_mem={r.t_memory*1e3:8.2f}ms "
                  f"t_coll={r.t_collective*1e3:8.2f}ms dom={r.dominant}",
                  flush=True)
    except Exception as e:     # the sweep records the failure and goes on
        rec.update(status="error", error=repr(e),
                   traceback=traceback.format_exc())
        if verbose:
            print(f"[ERR] {arch} {shape_name} {mesh_name}: {e!r}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--opt", action="append", default=[],
                    help="perf knobs, e.g. --opt remat=false --opt impl=ref")
    args = ap.parse_args(argv)

    opts = Opts()
    for kv in args.opt:
        k, v = kv.split("=", 1)
        cur = getattr(opts, k)
        if isinstance(cur, bool) or k == "fsdp_serve":
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        setattr(opts, k, v)

    archs = [a for a in list_archs() if a != "tinyyolo-v2"] \
        if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    results = []
    for arch in archs:
        for sh in shapes:
            for mesh_name in meshes:
                results.append(run_combo(arch, sh, mesh_name, opts))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
