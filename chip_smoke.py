#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), then
   every kernel of the path built from ``src/repro_torch/csrc`` with nvcc.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes (granite-3-2b: H=32, KV=8, hd=64) in bf16 and float32:
   K2 flash attention (prefill) and K1 paged attention (decode, and
   chunked prefill). Each kernel's time beside its bound, its plain
   version's time and, for K2, ``scaled_dot_product_attention``'s time as a
   yardstick (the port never calls it).
3. The served path at full width: granite-3-2b as registered (40 layers,
   bf16, random weights from a seed) through ``make_serve_runtime``: cold
   start, then 4 events of 2 prompts (64..1024 tokens, 32 new tokens
   each), once with whole-prompt prefill and once with 256-token chunked
   prefill. Launch counts are zeroed before each run and must grow.
4. Parity of the path on the card: full-width bf16 logits through the
   kernels against ``impl="ref"``; 4-layer float32 greedy tokens through
   the kernels identical to ``impl="ref"``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,    # dense bf16 tensor cores
            "float32": 67e12}      # float32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H, KV, HD, PAGE = 32, 8, 64, 16    # granite-3-2b attention widths


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def event_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call between CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(torch, fn, kernel_name: str, iters: int = 20) -> float:
    """Device time per call of the CUDA kernel whose name contains
    ``kernel_name``, from the profiler (launch gaps excluded)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.device_time_total for ev in prof.key_averages()
                   if kernel_name in ev.key)
    if total_us <= 0:
        raise AssertionError(f"the profiler recorded no {kernel_name} launch")
    return total_us / 1e3 / iters


def ptxas_summary(report: str):
    """One line per kernel instance from nvcc's -Xptxas -v report:
    registers and spill bytes."""
    name = None
    spills = ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*?(\w+_kernel)I(.+?)Li(\d+)E", line)
        if m:
            dt = "bf16" if "bfloat16" in m.group(2) else "f32"
            name = f"{m.group(1)}<{dt}, hd={m.group(3)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            yield f"{name}: {m.group(1)} registers, {spills} bytes spill stores"
            name = None


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
def paged_inputs(torch, rng, dev, dtype, kv_len, C):
    """Pools, block tables (distinct pages, never the scratch page 0,
    zero-padded to a power-of-two width) and queries for ``kv_len``."""
    B = len(kv_len)
    need = [-(-int(n) // PAGE) for n in kv_len]
    P = 1 << max(max(need) - 1, 0).bit_length()
    n_pages = 1 + sum(need)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, P), np.int32)
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[used:used + n]
        used += n
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, getattr(torch, dtype))
    return (t((B, C, H, HD)), t((n_pages, PAGE, KV, HD)), t((n_pages, PAGE, KV, HD)),
            torch.from_numpy(bt).to(dev), torch.from_numpy(np.asarray(kv_len, np.int32)).to(dev))


def check(name, dtype, got, want, errs) -> float:
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= TOL[dtype]
    log(f"  {name:52s} {dtype:8s} max|err| {err:.3e} (tol {TOL[dtype]:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: max abs err {err} > {TOL[dtype]}")
    errs.append(err)
    return err


def phase_kernels(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(0)
    up = lambda *ts: [t.float() for t in ts]  # noqa: E731
    errs = {"flash": [], "decode": [], "chunk": []}
    log("phase 2: kernels against their plain versions (bf16 kernels against "
        "the plain version in float32 on the same inputs)")
    for dtype in ("bfloat16", "float32"):
        t = lambda shape: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape).astype(np.float32)).to(dev, getattr(torch, dtype))
        flash_cases = [(1, s, s, dict(causal=True)) for s in (128, 512, 1000)] + [
            (1, 512, 512, dict(causal=True, window=256)),
            (1, 512, 512, dict(causal=True, chunk=128)),
            (1, 512, 512, dict(causal=False)),
            (1, 256, 1000, dict(causal=True))]
        for B, sq, skv, kw in flash_cases:
            q, k, v = t((B, sq, H, HD)), t((B, skv, KV, HD)), t((B, skv, KV, HD))
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.flash_attention(*up(q, k, v), **kw).to(q.dtype)
            check(f"K2 flash B={B} sq={sq} skv={skv} {kw}", dtype, got, want,
                  errs["flash"])
        kv_len = [1, 37, 128, 255, 512, 700, 999, 1024]
        q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, kv_len, 1)
        got = pa.paged_decode_attention(q, kp, vp, bt, kl)
        want = ref.paged_decode_attention(*up(q, kp, vp), bt, kl).to(q.dtype)
        check(f"K1 decode B=8 kv_len={kv_len}", dtype, got, want, errs["decode"])
        for q_off in (0, 256):
            q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, [q_off + 256], 256)
            qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
            got = pa.paged_prefill_attention(q, kp, vp, bt, kl, qo)
            want = ref.paged_prefill_attention(*up(q, kp, vp), bt, kl, qo).to(q.dtype)
            check(f"K1 chunk C=256 q_offset={q_off}", dtype, got, want, errs["chunk"])
    torch.cuda.synchronize()

    log("phase 2: times at the main path's shapes, bf16 (kernel: profiler "
        "device time; plain and library: CUDA events per call)")
    entries = {}
    dtype, isz = "bfloat16", 2
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    # K2: a 1024-token prompt, causal
    S = 1024
    q, k, v = t((1, S, H, HD)), t((1, S, KV, HD)), t((1, S, KV, HD))
    pairs = S * (S + 1) // 2 * H
    b, by = bound_ms(isz * (2 * q.numel() + k.numel() + v.numel()), 4 * HD * pairs, dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entries["flash"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:27",
        shape=f"B=1 S={S} H={H} KV={KV} hd={HD} causal bf16",
        ms=kernel_ms(torch, lambda: fa.flash_attention(q, k, v), "flash_attention_kernel"),
        plain_ms=event_ms(torch, lambda: ref.flash_attention(q, k, v), 5),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True), 20))
    # K1 decode: 8 sequences, kv_len spread over 1..1024
    kv_len = [1, 37, 128, 255, 512, 700, 999, 1024]
    q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, kv_len, 1)
    n_kv = sum(kv_len)
    b, by = bound_ms(isz * (2 * q.numel() + 2 * n_kv * KV * HD) + 4 * (bt.numel() + 8),
                     4 * HD * H * n_kv, dtype)
    entries["decode"] = dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:135",
        shape=f"B=8 kv_len={kv_len} page={PAGE} bf16",
        ms=kernel_ms(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, kl),
                     "paged_rows_kernel"),
        plain_ms=event_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, bt, kl), 10),
        bound_ms=b, bound_by=by, library_ms=None)
    # K1 chunk: the second 256-token chunk of a prompt
    C, q_off = 256, 256
    q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, [q_off + C], C)
    qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
    pairs = sum(q_off + i + 1 for i in range(C)) * H
    b, by = bound_ms(isz * (2 * q.numel() + 2 * (q_off + C) * KV * HD) + 4 * (bt.numel() + 2),
                     4 * HD * pairs, dtype)
    entries["chunk"] = dict(
        name="paged_prefill_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:135",
        shape=f"B=1 C={C} q_offset={q_off} page={PAGE} bf16",
        ms=kernel_ms(torch, lambda: pa.paged_prefill_attention(q, kp, vp, bt, kl, qo),
                     "paged_tiled_kernel"),
        plain_ms=event_ms(torch, lambda: ref.paged_prefill_attention(q, kp, vp, bt, kl, qo),
                          10),
        bound_ms=b, bound_by=by, library_ms=None)
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
        lib = f"{e['library_ms']:.4f}" if e["library_ms"] is not None else "n/a"
        log(f"  {e['name']:24s} {e['shape']}: kernel {e['ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']}), plain {e['plain_ms']:.4f} ms, "
            f"library {lib} ms")
    return entries


# ----------------------------------------------------------------------
# phase 3: the served path at full width
# ----------------------------------------------------------------------
PROMPT_LENS = [64, 1024, 200, 700, 128, 512, 900, 333]
MAX_NEW = 32


def launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    return {"flash": fa.flash_attention.launches,
            "decode": pa.paged_decode_attention.launches,
            "chunk": pa.paged_prefill_attention.launches}


def zero_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    fa.flash_attention.launches = 0
    pa.paged_decode_attention.launches = 0
    pa.paged_prefill_attention.launches = 0


def serve_run(torch, cfg, prefill_chunk: int, dev):
    from repro_torch.core.runtime import run_batch
    from repro_torch.serve.api import make_serve_runtime

    rdef = make_serve_runtime(cfg, page_size=PAGE, max_slots=8, max_len=2048,
                              max_batch=4, prefill_chunk=prefill_chunk, seed=0,
                              device=dev)
    t0 = time.perf_counter()
    engine = rdef.setup()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab, size=n).tolist() for n in PROMPT_LENS]
    events = [{"prompts": prompts[2 * i:2 * i + 2]} for i in range(4)]
    config = {"handle": engine, "max_new_tokens": MAX_NEW}

    zero_launches()
    t0 = time.perf_counter()
    results = run_batch(rdef, events[:1], config)          # one event alone
    results += run_batch(rdef, events[1:], config)         # a micro-batch of 3
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()

    outs = [o for r in results for o in r["outputs"]]
    if len(outs) != len(prompts) or not all(1 <= len(o) <= MAX_NEW for o in outs):
        raise AssertionError(f"not every request finished: {[len(o) for o in outs]}")
    engine.allocator.check_invariants()
    if engine.allocator.n_free != engine.num_pages - 1 or \
            engine.free_slots() != list(range(engine.max_slots)):
        raise AssertionError(f"leaked pages or slots: {engine.stats()}")
    need = ["flash", "decode"] + (["chunk"] if prefill_chunk else [])
    if any(counts[k] == 0 for k in need):
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    n_tok = sum(len(o) for o in outs)
    ttft = sorted(engine.ttft_s)
    log(f"  prefill_chunk={prefill_chunk}: cold start {cold_s:.3f} s; "
        f"{len(outs)} requests, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms "
        f"max {ttft[-1] * 1e3:.1f} ms; decode {engine.decode_s / engine.n_decode_steps * 1e3:.2f}"
        f" ms/step over {engine.n_decode_steps} steps; launches {counts}; "
        f"stats {engine.stats()}")
    return engine, counts


def _device_us(ev) -> float:
    return ev.self_device_time_total


def profile_breakdown(torch, label: str, run, n: int):
    """Profile ``run()`` (``n`` units of work): wall ms per unit, device
    busy ms per unit (kernels and copies on the card), the idle share, the
    host-side op count and the top device consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    evs = prof.key_averages()
    dev = sorted((e for e in evs if e.device_type != DeviceType.CPU),
                 key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in dev) / 1e3 / n
    n_dev = sum(e.count for e in dev) // n
    n_ops = sum(e.count for e in evs if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::")) // n
    log(f"  profile {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {max(0.0, 1 - busy / wall):.2f}; {n_dev} device kernels/copies, "
        f"{n_ops} aten ops on the host (under the profiler)")
    for e in dev[:8]:
        log(f"    {_device_us(e) / 1e3 / n:8.3f} ms  x{e.count // n:<5d} {e.key[:90]}")


def profile_served(torch, engine, cfg):
    """Where the time of the served path goes: 3 decode steps of a full
    batch (8 slots at ~256 tokens of context; 256-token prompts prefill
    whole) and one 1024-token prefill."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(5)
    steps = 3
    for i in range(engine.max_slots):
        engine.submit(Request(prompt=rng.integers(3, cfg.vocab, size=256).tolist(),
                              max_new_tokens=steps + 4, req_id=100 + i))
    engine.step()                   # admits and prefills all 8, one decode
    profile_breakdown(torch, "decode step (B=8, ~256 context)",
                      lambda: [engine.step() for _ in range(steps)], steps)
    engine.generate([])             # drain
    toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(1, 1024))).to(engine.device)
    M.prefill(cfg, engine.params, {"tokens": toks})
    profile_breakdown(torch, "prefill (1 x 1024 tokens)",
                      lambda: M.prefill(cfg, engine.params, {"tokens": toks}), 1)


# ----------------------------------------------------------------------
# phase 4: parity of the path on the card
# ----------------------------------------------------------------------
def logits_parity(torch, cfg, params, dev):
    """Prefill + 8 decode steps through the kernels and through
    impl="ref", teacher-forced on the kernel path's greedy tokens."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import install_pages

    rng = np.random.default_rng(2)
    S, steps = 300, 8
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(1, S))).to(dev)
    n_pages = -(-(S + steps) // PAGE)
    table = torch.arange(1, n_pages + 1, dtype=torch.int32, device=dev)[None]
    res, caches = {}, {}
    for impl in (None, "ref"):
        logits, dense = M.prefill(cfg, params, {"tokens": tokens}, impl=impl)
        caches[impl] = M.init_paged_cache(cfg, 1, S + steps, n_pages + 1, PAGE, device=dev)
        install_pages(caches[impl], dense, table[0].long())
        res[impl] = [logits[0, -1].float()]
    toks = [int(torch.argmax(res[None][0]))]
    for i in range(steps):
        tok = torch.tensor([[toks[-1]]], device=dev)
        pos = torch.tensor([S + i], dtype=torch.int32, device=dev)
        for impl in (None, "ref"):
            logits, _ = M.decode_step(cfg, params, caches[impl], tok, pos,
                                      block_tables=table, impl=impl)
            res[impl].append(logits[0, 0].float())
        toks.append(int(torch.argmax(res[None][-1])))
    diffs = [(a - b).abs().max().item() for a, b in zip(res[None], res["ref"])]
    agree = sum(int(torch.argmax(a)) == int(torch.argmax(b))
                for a, b in zip(res[None], res["ref"]))
    scale = max(r.abs().max().item() for r in res["ref"])
    return diffs, agree, len(diffs), scale


def greedy_parity(torch, cfg4, dev):
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServingEngine

    params = M.init_model_params(cfg4, 3, dev)
    rng = np.random.default_rng(4)
    lens = [40, 300, 700, 1000]
    prompts = [rng.integers(3, cfg4.vocab, size=n).tolist() for n in lens]
    outs = {}
    for chunk in (0, 256):
        for impl in (None, "ref"):
            eng = ServingEngine(cfg4, params, max_slots=4, max_len=1100,
                                prefill_chunk=chunk, impl=impl, device=dev)
            done = eng.generate([Request(prompt=list(p), max_new_tokens=12, req_id=i)
                                 for i, p in enumerate(prompts)])
            outs[(chunk, impl)] = {r.req_id: r.output for r in done}
        if outs[(chunk, None)] != outs[(chunk, "ref")]:
            raise AssertionError(f"f32 greedy tokens differ (prefill_chunk={chunk}): "
                                 f"{outs[(chunk, None)]} vs {outs[(chunk, 'ref')]}")
    return outs


# ----------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is not at {src}/repro_torch",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"phase 1: card {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    secs = build.build()
    log(f"phase 1: kernels built in {max(secs.values()) if secs else 0.0:.1f} s "
        f"(parallel nvcc per source: {secs or 'already built'})")
    for name in build.KERNELS:
        for line in ptxas_summary(build.ptxas_report(name)):
            log(f"  ptxas {line}")

    entries = phase_kernels(torch, dev)

    cfg = get_config("granite-3-2b")
    log(f"phase 3: served path, {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} d_ff={cfg.d_ff} "
        f"vocab {cfg.padded_vocab} {cfg.dtype}, random weights (seed 0)")
    total = {"flash": 0, "decode": 0, "chunk": 0}
    engine = None
    for chunk in (0, 256):
        engine = None
        torch.cuda.empty_cache()
        engine, counts = serve_run(torch, cfg, chunk, dev)
        for k in total:
            total[k] += counts[k]
    profile_served(torch, engine, cfg)
    params = engine.params
    engine.cache = None

    log("phase 4: parity through the kernels against impl='ref'")
    diffs, agree, n, scale = logits_parity(torch, cfg, params, dev)
    tol = 0.05 * scale
    log(f"  full width bf16: max|logit diff| per step {['%.4f' % d for d in diffs]} "
        f"(tol {tol:.4f} = 5% of max|logit| {scale:.3f}); greedy agreement {agree}/{n}")
    if max(diffs) > tol:
        raise AssertionError(f"bf16 logits differ by {max(diffs)} > {tol}")
    del params, engine
    torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    outs = greedy_parity(torch, cfg4, dev)
    log(f"  4 layers float32: greedy tokens identical for {len(outs[(0, None)])} "
        f"requests, whole-prompt and chunked prefill")

    kernels = []
    for key in ("flash", "decode", "chunk"):
        e = dict(entries[key])
        e["launches"] = total[key]
        kernels.append({k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")})
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
