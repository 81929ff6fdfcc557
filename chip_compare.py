#!/usr/bin/env python3
"""Time one checkout of the port on the card, to compare two commits in one
call.

    python3 chip_compare.py ROOT
    python3 chip_compare.py ROOT --decode-split

Imports the port from ``ROOT/src`` (its kernels build from ROOT's sources
into ``ROOT/build/kernels``) and measures, in bf16 at the served widths,
with inputs from fixed seeds so that two checkouts see the same data:

* profiler device time per call of K2 flash attention (granite-3-2b hd 64,
  1024 tokens causal; recurrentgemma-2b hd 256, 3000 tokens, window 2048;
  llama4-scout hd 128, 2048 tokens causal), K1 chunked prefill (granite,
  C=256 at q_offset 256 and 768) and K5 (B=1 S=3000 D=2560 float32);
* device busy of recurrentgemma-2b's 3000-token prefill (26 layers) and of
  one 1024-token granite-3-2b prompt prefilled through the engine in four
  256-token chunks (40 layers), with K5's and K1 chunk's shares.

With ``--decode-split`` it measures only qwen2.5-14b's eager decode step
as registered (48 layers, bf16; B=8 at ~256 tokens of context, paged):
the step's device busy split by kernel class (K1 decode, GEMMs, casts and
copies, indexing, reductions, other elementwise), and the unembedding of
the same step profiled alone (its kernels by class), which the split
lists apart.

Times from two calls may come from two cards: run the parent and the
change in turns in one call (parent, change, change, parent). The last
line is one JSON object of the numbers; the line before it is the card's
name and power limit.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call of ``fn``, which launches one kernel a call:
    the profiler's device time over the launches it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    n = sum(e.count for e in evs)
    if not n:
        raise RuntimeError("the profiler recorded no kernel")
    return sum(e.self_device_time_total for e in evs) / 1e3 / n


def kernels(torch, dev) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as rs
    rng = np.random.default_rng(7)
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    out = {}
    for key, S, (nh, nkv, hd), kw in (
            ("K2 hd 64", 1024, (cs.H, cs.KV, cs.HD), {}),
            ("K2 hd 256 window", 3000, (cs.RG_H, cs.RG_KV, cs.RG_HD),
             dict(window=cs.RG_WINDOW)),
            ("K2 hd 128", 2048, (cs.L4_H, cs.L4_KV, cs.L4_HD), {})):
        q, k, v = t((1, S, nh, hd)), t((1, S, nkv, hd)), t((1, S, nkv, hd))
        out[key] = device_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
    for q_off in (256, 768):
        q, kp, vp, bt, kl = cs.paged_inputs(torch, rng, dev, "bfloat16", [q_off + 256], 256)
        qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
        out[f"K1 chunk q_offset {q_off}"] = device_ms(
            torch, lambda: pa.paged_prefill_attention(q, kp, vp, bt, kl, qo))
    a, b, _ = cs.scan_inputs(torch, rng, dev, "float32", 3000, False)
    out["K5"] = device_ms(torch, lambda: rs.rglru_scan(a, b))
    for key, ms in out.items():
        cs.log(f"  {key}: {ms:.4f} ms")
    return out


def served(torch, dev, chunk_kernel: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServingEngine
    out = {}
    rg = get_config("recurrentgemma-2b")
    params = M.init_model_params(rg, 0, dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(3, rg.vocab, size=(1, 3000)))
    toks = toks.to(dev)
    M.prefill(rg, params, {"tokens": toks})
    _, busy, share = cs.profile_breakdown(
        torch, f"{rg.name} prefill (1 x 3000 tokens)",
        lambda: M.prefill(rg, params, {"tokens": toks}), 1, shares={"K5": "rglru_scan_kernel"})
    out["recurrentgemma prefill 3000 busy"], out["recurrentgemma prefill K5"] = busy, share["K5"]
    del params
    torch.cuda.empty_cache()
    granite = get_config("granite-3-2b")
    params = M.init_model_params(granite, 0, dev)
    engine = ServingEngine(granite, params, max_slots=8, max_len=2048, page_size=cs.PAGE,
                           prefill_chunk=256, device=dev)
    _, busy, share = cs.profile_chunked_prefill(torch, engine, granite, 1024, chunk_kernel)
    out["granite chunked prefill 1024 busy"], out["granite chunked prefill K1 chunk"] = \
        busy, share["K1 chunk"]
    return out


def decode_split(torch, dev) -> dict:
    """qwen2.5-14b's eager decode step (B=8, ~256 context) by kernel class,
    and its unembedding alone."""
    import inspect
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServingEngine
    qw = get_config("qwen2.5-14b")
    params = M.init_model_params(qw, 0, dev)
    # the eager step: the parent has no graphs argument and is eager
    kw = {"graphs": False} if "graphs" in inspect.signature(ServingEngine).parameters else {}
    engine = ServingEngine(qw, params, max_slots=8, max_len=2048, page_size=cs.PAGE,
                           device=dev, **kw)
    rng = np.random.default_rng(5)
    steps = 3
    for i in range(engine.max_slots):
        engine.submit(Request(prompt=rng.integers(3, qw.vocab, size=256).tolist(),
                              max_new_tokens=3 * steps + 4, req_id=i))
    engine.step()                   # admits and prefills all 8, one decode
    engine.step()
    step = cs.device_by_class(torch, lambda: [engine.step() for _ in range(steps)], steps)
    engine.generate([])
    emb = params["embed"]
    x = torch.randn(8, 1, qw.d_model, device=dev).to(torch.bfloat16)
    L.unembed(emb, x, qw.tie_embeddings)
    torch.cuda.synchronize()
    unembed = cs.device_by_class(torch, lambda: L.unembed(emb, x, qw.tie_embeddings), 1)
    cs.log(f"  qwen2.5-14b eager decode step (B=8, ~256 context), device ms per step by "
           f"kernel class: busy {step['busy']:.3f}")
    for name in [n for n, _ in cs.KERNEL_CLASSES] + [cs.OTHER]:
        cs.log(f"    {name:18s} {step[name]:8.3f} ms (of it the unembedding "
               f"{unembed[name]:.3f} ms)")
    cs.log(f"    the unembedding alone: {unembed['busy']:.3f} ms")
    return {"decode step by class": step, "unembed by class": unembed}


def main() -> int:
    import torch
    split = sys.argv[2:] == ["--decode-split"]
    if len(sys.argv) != 2 and not split:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    if not torch.cuda.is_available() or not (root / "src" / "repro_torch").is_dir():
        print(f"chip_compare: needs a CUDA device and {root}/src/repro_torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build()
    if split:
        cs.log(f"chip_compare {root}: qwen2.5-14b decode split")
        res = {"root": str(root), **decode_split(torch, dev)}
        print(cs.nvidia_smi_line())
        print(json.dumps(res))
        return 0
    # K1's chunks run the shared prefill body where the checkout has it
    new = (root / "src" / "repro_torch" / "csrc" / "prefill_common.cuh").exists()
    chunk_kernel = "paged_prefill_mma_kernel" if new else "paged_tiled_kernel"
    cs.log(f"chip_compare {root}: K1 chunk kernel {chunk_kernel}")
    res = {"root": str(root), **kernels(torch, dev), **served(torch, dev, chunk_kernel)}
    print(cs.nvidia_smi_line())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
