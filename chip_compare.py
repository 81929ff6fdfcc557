#!/usr/bin/env python3
"""Time one checkout of the port on the card, to compare two commits in one
call.

    python3 chip_compare.py ROOT
    python3 chip_compare.py ROOT --decode-split
    python3 chip_compare.py ROOT --train-bwd
    python3 chip_compare.py ROOT --train-step
    python3 chip_compare.py ROOT --int8-decode
    python3 chip_compare.py ROOT --fwd

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

With ``--train-bwd`` it measures only the backward kernels at the training
shapes of ``chip_smoke.py`` phase 10, through the wrappers a train step
calls (so the body each checkout runs for the shape): K2's backward
(granite-3-2b B=4 S=2048 H=32 KV=8 hd 64 causal; llama4-scout B=2 S=2048
H=40 KV=8 hd 128 causal; recurrentgemma-2b B=1 S=3072 H=10 KV=1 hd 256,
window 2048) and K4's (dX alone and dW alone, llama4-scout's gate/up K=5120
N=8192 and down K=8192 N=5120, 4096 rows of a top-1 routing over 16
experts): device ms per call (every kernel of the call summed), CUDA
events per call, and host ms per call (the wrapper's Python, allocations
and launcher call, no sync: the time a train step's host spends on it).

With ``--train-step`` it runs only ``chip_smoke.py`` phase 10 (c) and (h)'s
train loops through ROOT's package: granite-3-2b at full width and depth
(B=4 S=2048, 6 steps) and llama4-scout-17b-a16e at full width cut to 2
layers (B=2 S=2048, 5 steps), each step's launches checked, the last step
profiled; it reports each run's window rate (s/step over the unprofiled
steps), median and slowest step, and the profiled step's device ms per
call of K2's and K4's backward.

With ``--fwd`` it measures only K2's and K4's bf16 forward through the
wrappers (so the body each checkout's shape rule picks): K2 at llama4-scout
training (B=2 S=2048 H=40 KV=8 hd 128, G=5, causal, with the log-sum-exp),
recurrentgemma-2b's training shard (B=4 S=1024 H=10 KV=1 hd 256, window
2048, with the log-sum-exp), granite-3-2b's training batch (B=4 S=2048 hd
64, with it) and granite's served 1024-token prefill (hd 64, causal); K4 at
llama4-scout's prefill gate/up and down (1024 rows top-1 over 16 experts,
K=5120 N=8192 and K=8192 N=5120), its decode (8 rows), its training
gate/up (4096 rows) and grok-1's gate/up and down (1024 tokens top-2 over 8
experts: 2048 rows, K=6144 N=32768 and K=32768 N=6144): device ms per call
(profiler), CUDA events per call and host ms per call, with the body that
ran where the checkout names its bodies.

With ``--int8-decode`` it measures only the split decode body over int8
caches with bf16 queries (the FMA instance where the checkout runs it
there, the tensor-core instance where it does not): profiler device ms per
call (the body and its merge) of K1's int8 decode at granite-3-2b's and
qwen2.5-14b's widths (B=8, kv_len 1..1024, paged) and of K3's int8
instance at recurrentgemma-2b's ring (hd 256) and granite's dense cache
(hd 64, B=8 S=2048) and with ``return_lse`` at phase 13's grok-1 and
recurrentgemma ranges (B=2, 128 and 512 slots); then granite-3-2b's eager
decode step as registered (40 layers, B=8 after 1024-token prompts in
256-token chunks, wk x 2 and wv x 40 as phase 11 (b)) on an int8 paged
pool and on a bf16 pool: device busy per step and K1 decode's share.

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


def host_ms(torch, fn, iters: int = 10) -> float:
    """Host ms per call of ``fn``: the Python and launch work until it
    returns, with no sync inside the timed calls (the card runs behind)."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def call_ms(torch, fn, iters: int = 10):
    """(device ms per call of every kernel ``fn`` launches, from the
    profiler; CUDA-event ms per call; host ms per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    if not evs:
        raise RuntimeError("the profiler recorded no kernel")
    device = sum(e.self_device_time_total for e in evs) / 1e3 / iters
    return device, cs.event_ms(torch, fn, iters), host_ms(torch, fn, iters)


def train_bwd(torch, dev) -> dict:
    """K2's and K4's backward at the training shapes, through the
    wrappers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gm
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    t = lambda shape: torch.randn(shape, generator=gen, device=dev).to(  # noqa: E731
        torch.bfloat16)
    out = {}
    for key, (B, S, nh, nkv, hd), kw in (
            ("K2 bwd hd 64 granite", (cs.TR_B, cs.TR_S, cs.H, cs.KV, cs.HD), {}),
            ("K2 bwd hd 128 llama4", (cs.L4_TR_B, cs.L4_TR_S, cs.L4_H, cs.L4_KV, cs.L4_HD), {}),
            ("K2 bwd hd 256 recurrentgemma",
             (cs.RG_TR_B, cs.RG_TR_S, cs.RG_H, cs.RG_KV, cs.RG_HD), dict(window=cs.RG_WINDOW))):
        q, do = t((B, S, nh, hd)), t((B, S, nh, hd))
        k, v = t((B, S, nkv, hd)), t((B, S, nkv, hd))
        o, lse = fa._forward(q, k, v, True, kw.get("window", 0), 0, None, True)
        out[key] = call_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                                 causal=True, **kw))
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    T, E = cs.L4_TR_B * cs.L4_TR_S, 16
    sizes = cs.routed_sizes(np.random.default_rng(11), T, E, 1, 5120)
    gs = torch.from_numpy(np.asarray(sizes, np.int32)).to(dev)
    for what, (K, N) in (("gate/up", (5120, 8192)), ("down", (8192, 5120))):
        x, dy = t((T, K)), t((T, N))
        w = (t((E, K, N)) * K ** -0.5).to(torch.bfloat16)
        for grad in ("dX", "dW"):
            out[f"K4 bwd {grad} {what}"] = call_ms(torch, lambda: gm.moe_gmm_bwd(
                x, w, gs, dy, need_dx=grad == "dX", need_dw=grad == "dW"))
        del x, dy, w
        torch.cuda.empty_cache()
    for key, (ms, ev, host) in out.items():
        cs.log(f"  {key}: {ms:.4f} ms (events {ev:.4f}, host {host:.4f})")
    return out


def fwd(torch, dev) -> dict:
    """K2's and K4's bf16 forward at the training, prefill and decode
    shapes, through the wrappers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gm
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    t = lambda shape: torch.randn(shape, generator=gen, device=dev).to(  # noqa: E731
        torch.bfloat16)
    out, bodies = {}, {}
    for key, (B, S, nh, nkv, hd), window, lse in (
            ("K2 hd 128 G=5 llama4 train, lse", (cs.L4_TR_B, cs.L4_TR_S, cs.L4_H, cs.L4_KV,
                                                 cs.L4_HD), 0, True),
            ("K2 hd 256 recurrentgemma train shard B=4 S=1024 window, lse",
             (4, 1024, cs.RG_H, cs.RG_KV, cs.RG_HD), cs.RG_WINDOW, True),
            ("K2 hd 64 granite train, lse", (cs.TR_B, cs.TR_S, cs.H, cs.KV, cs.HD), 0, True),
            ("K2 hd 64 granite prefill S=1024", (1, 1024, cs.H, cs.KV, cs.HD), 0, False)):
        q, k, v = t((B, S, nh, hd)), t((B, S, nkv, hd)), t((B, S, nkv, hd))
        out[key] = call_ms(torch, lambda: fa._forward(q, k, v, True, window, 0, None, lse))
        if hasattr(fa, "forward_kernel"):
            bodies[key] = fa.forward_kernel(q, k)
        del q, k, v
        torch.cuda.empty_cache()
    rng = np.random.default_rng(17)
    l4 = {n: cs.routed_sizes(rng, n, 16, 1, 5120) for n in (8, 1024, 4096)}
    grok = cs.routed_sizes(rng, 1024, 8, 2, 6144)
    for i, (key, sizes, T, K, N) in enumerate((
            ("K4 llama4 prefill gate/up T=1024", l4[1024], 1024, 5120, 8192),
            ("K4 llama4 prefill down T=1024", l4[1024], 1024, 8192, 5120),
            ("K4 llama4 decode gate/up T=8", l4[8], 8, 5120, 8192),
            ("K4 llama4 train gate/up T=4096", l4[4096], 4096, 5120, 8192),
            ("K4 grok-1 gate/up 2048 rows top-2", grok, 2048, 6144, 32768),
            ("K4 grok-1 down 2048 rows top-2", grok, 2048, 32768, 6144))):
        x, w, gs = cs.gmm_inputs(torch, dev, "bfloat16", sizes, T, K, N, seed=70 + i)
        out[key] = call_ms(torch, lambda: gm.moe_gmm(x, w, gs))
        if hasattr(gm, "forward_kernel"):
            bodies[key] = gm.forward_kernel(x, w)
        del x, w, gs
        torch.cuda.empty_cache()
    for key, (ms, ev, host) in out.items():
        cs.log(f"  {key}: {ms:.4f} ms (events {ev:.4f}, host {host:.4f})"
               + (f", body {bodies[key]}" if key in bodies else ""))
    return dict(out, bodies=bodies)


def train_step(torch, dev) -> dict:
    """Phase 10 (c) and (h)'s train loops through the launcher's pieces:
    the window's s/step, median, slowest step and the profiled step's
    device ms per call of K2's and K4's backward, for each model."""
    import dataclasses
    from repro_torch.configs import get_config
    out = {}
    l4 = dataclasses.replace(get_config("llama4-scout-17b-a16e"), n_layers=cs.L4_TR_LAYERS)
    for cfg, B, S, steps in ((get_config("granite-3-2b"), cs.TR_B, cs.TR_S, cs.TR_STEPS),
                             (l4, cs.L4_TR_B, cs.L4_TR_S, cs.L4_TR_STEPS)):
        params, _, per_call, rate = cs.train_run(torch, cfg, dev, B, S, steps, repeat=False)
        del params
        torch.cuda.empty_cache()
        out[cfg.name] = dict(rate, **{k: per_call.get(k) for k in ("K2 bwd", "K4 bwd")})
        cs.log(f"  {cfg.name}: {out[cfg.name]}")
    return out


def split_body(root: Path) -> tuple:
    """The names of the split decode body that ``root``'s bf16 queries over
    an int8 cache launch, and its merge: the tensor-core instance where the
    checkout's body takes an int8 cache, else the FMA instance."""
    src = (root / "src" / "repro_torch" / "csrc" / "decode_common.cuh").read_text()
    body = "split_decode_mma_kernel" if "Params<bf16, TKV, Cache>" in src \
        else "split_decode_fma_kernel"
    return body, "split_decode_merge_kernel"


def int8_decode(torch, dev, names) -> dict:
    """K1 and K3 int8 decode device ms per call at the served widths, and
    granite's decode step busy on an int8 pool against a bf16 pool."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import model as M
    rng = np.random.default_rng(27)
    out = {}
    for key, heads in (("K1 int8 decode hd 64, granite", (cs.H, cs.KV, cs.HD)),
                       ("K1 int8 decode hd 128, qwen", (cs.QW_H, cs.QW_KV, cs.QW_HD))):
        q, kp, vp, bt, kl = cs.int8_paged_inputs(torch, rng, dev, "bfloat16", cs.QW_KV_LEN, 1,
                                                 heads)
        out[key] = cs.kernel_ms(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, kl),
                                names)
    for key, (nh, nkv, hd) in (("K3 int8 ring hd 256", (cs.RG_H, cs.RG_KV, cs.RG_HD)),
                               ("K3 int8 dense hd 64", (cs.H, cs.KV, cs.HD))):
        q, k, _, kl = cs.decode_inputs(torch, rng, dev, "bfloat16", nh, nkv, hd)
        k8, v8 = cs.int8_kv(torch, rng, k.shape, dev), cs.int8_kv(torch, rng, k.shape, dev)
        q = q * 0.02
        out[key] = cs.kernel_ms(torch, lambda: da.decode_attention(q, k8, v8, kl), names)
    for key, (L, nh, nkv, hd) in (("K3 int8 lse, grok-1 range", (128, 48, 8, 128)),
                                  ("K3 int8 lse, rg ring range", (512, cs.RG_H, cs.RG_KV,
                                                                  cs.RG_HD))):
        q, k, v, kl = cs.p13_int8_decode_inputs(torch, rng, dev, nh, nkv, hd, L, [L, L])
        out[key] = cs.kernel_ms(
            torch, lambda: da.decode_attention(q, k, v, kl, return_lse=True), names)
    for key, ms in out.items():
        cs.log(f"  {key}: {ms:.4f} ms")

    cfg = get_config("granite-3-2b")
    params = M.init_model_params(cfg, 0, dev)
    cs.scaled_kv(torch, params, cs.KV8_WK, cs.KV8_WV)
    B, S, C, T = cs.KV8_B, cs.KV8_PROMPT, cs.KV8_CHUNK, cs.KV8_STEPS
    tokens = torch.from_numpy(np.random.default_rng(41).integers(3, cfg.vocab, size=(B, S)))
    tokens = tokens.to(dev)
    P = -(-(S + T) // cs.PAGE)
    table = (1 + torch.arange(B * P, dtype=torch.int32, device=dev)).reshape(B, P)
    pos = torch.full((B,), S + T // 2, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for kv_dtype in ("int8", "bfloat16"):
            cache = M.init_paged_cache(cfg, B, S + T, B * P + 1, cs.PAGE, device=dev,
                                       kv_dtype=kv_dtype)
            for p0 in range(0, S, C):
                logits, cache = M.prefill_chunk(cfg, params, cache, tokens[:, p0:p0 + C], p0,
                                                table)
            tok = logits[:, -1].argmax(-1)[:, None]
            step = lambda: M.decode_step(cfg, params, cache, tok, pos,  # noqa: E731
                                         block_tables=table)
            step()
            _, busy, share = cs.profile_breakdown(
                torch, f"{cfg.name} B={B} decode step, {kv_dtype} pool",
                lambda: [step() for _ in range(5)], 5, shares={"K1 decode": names[0]})
            out[f"granite decode step busy, {kv_dtype} pool"] = busy
            out[f"granite decode step K1 decode, {kv_dtype} pool"] = share["K1 decode"]
            del cache
            torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    split = sys.argv[2:] == ["--decode-split"]
    bwd = sys.argv[2:] == ["--train-bwd"]
    step = sys.argv[2:] == ["--train-step"]
    int8 = sys.argv[2:] == ["--int8-decode"]
    forward = sys.argv[2:] == ["--fwd"]
    if len(sys.argv) != 2 and not (split or bwd or step or int8 or forward):
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
    if int8:
        names = split_body(root)
        build.build(["paged_attention", "decode_attention", "flash_attention"])
        cs.log(f"chip_compare {root}: int8 decode through {names[0]}")
        res = {"root": str(root), "body": names[0], **int8_decode(torch, dev, names)}
        print(cs.nvidia_smi_line())
        print(json.dumps(res))
        return 0
    if forward:
        build.build(["flash_attention", "moe_gmm"])
        cs.log(f"chip_compare {root}: K2 and K4 forward")
        res = {"root": str(root), **fwd(torch, dev)}
        print(cs.nvidia_smi_line())
        print(json.dumps(res))
        return 0
    build.build()
    if bwd or step:
        cs.log(f"chip_compare {root}: " + ("K2 and K4 backward at the training shapes"
                                           if bwd else "granite and llama4 train steps"))
        res = {"root": str(root), **(train_bwd if bwd else train_step)(torch, dev)}
        print(cs.nvidia_smi_line())
        print(json.dumps(res))
        return 0
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
