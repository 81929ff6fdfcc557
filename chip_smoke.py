#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), then
   every kernel of the paths built from ``src/repro_torch/csrc`` with nvcc
   (one process per source, in parallel), with each instance's registers
   and spills from ptxas.
2. Kernels against their plain PyTorch versions on the card, in bf16 and
   float32, at the main paths' shapes: K2 flash attention (granite-3-2b
   prefill, H=32 KV=8 hd=64; recurrentgemma-2b prefill, H=10 KV=1 hd=256,
   window 2048, up to 3000 tokens), K1 paged attention (decode and chunked
   prefill), K3 decode attention (recurrentgemma's ring decode, B=8 S=2048
   G=10 hd=256; granite's dense per-slot decode, G=4 hd=64; an int8 cache)
   and K5 the RG-LRU scan (B=1 D=2560, float32 held to 0 error); at
   llama4-scout's widths (H=40 KV=8 hd=128, G=5) K2 (causal, and a chunk
   mask crossed), K1 decode and K3 ring decode (L=8192, kv_len wrapped);
   K4 the grouped matmul at the MoE path's shapes (llama4 prefill gate/up
   and down, 1024 tokens top-1 over 16 experts; llama4 decode, 8 tokens;
   grok-1 gate/up and down, 1024 tokens top-2 over 8 experts, group sizes
   from a real routing) and edge cases (T=1, one expert, groups off the
   tile, rows no group covers). Each kernel's time beside its bound, its
   plain version's time and, where one PyTorch call computes the same
   function, that call's time (``scaled_dot_product_attention``,
   ``torch._grouped_mm``; the port never calls them).
3. The served paths at full width through ``make_serve_runtime``, random
   weights from a seed, bf16: granite-3-2b (40 layers) paged with
   whole-prompt and 256-token chunked prefill, then dense (page_size=0),
   4 events of 2 prompts of 64..1024 tokens; recurrentgemma-2b (26 layers)
   paged, 4 events of 2 prompts of 64..3000 tokens, past its 2048-token
   window; llama4-scout-17b-a16e cut to 8 of its 48 layers (2 periods,
   35.3 GB; the published depth does not fit one card), every width as
   published, paged, 4 events of 2 prompts of 64..2048 tokens and one of
   8500 (past the 8192-token chunk). 32 new tokens each. Launch counts
   are zeroed before each run and must grow for every kernel of that
   run's path (K4 on llama4's). Cold start, TTFT, decode ms/step,
   tokens/s, and profiles of a decode step and a prefill.
4. Parity of the paths on the card: full-width bf16 logits of granite, of
   recurrentgemma and of llama4 (chunk 1024, a 2100-token prompt; the
   plain path follows the kernel path's expert choices, and those where
   its own would differ are counted) through the kernels against
   ``impl="ref"``; float32 greedy tokens through the kernels identical to
   ``impl="ref"`` (granite 4 layers, recurrentgemma 5 layers, llama4 4
   layers at full width), and granite's dense engine identical to its
   paged engine.

The last three lines are ``{"kernels": [...]}``, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository's ``src/repro_torch`` beside this file, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
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
RG_H, RG_KV, RG_HD, RG_WINDOW = 10, 1, 256, 2048   # recurrentgemma-2b
RG_D = 2560
DECODE_KV_LEN = [1, 100, 511, 1024, 1500, 2000, 2047, 2048]
L4_H, L4_KV, L4_HD, L4_CHUNK = 40, 8, 128, 8192   # llama4-scout attention widths
L4_KV_LEN = [1, 64, 200, 700, 1024, 1500, 2048, 2100]
# ring decode of chunked attention: kv_len = pos % 8192 + 1, so a long
# sequence's ring restarts small after a chunk boundary
L4_RING_LEN = [1, 17, 309, 2048, 4096, 7777, 8191, 8192]


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


def kernel_ms(torch, fn, kernel_name: str, iters: int = 20, attempts: int = 3) -> float:
    """Device time per call of the CUDA kernel whose name contains
    ``kernel_name``, from the profiler (launch gaps excluded); each call
    of ``fn`` launches that kernel once. The profiler now and then records
    only some, or none, of a session's launches of a kernel launched
    through ctypes, so the time is the recorded device time over the
    recorded launches, and the shortfall is logged. An empty session is
    repeated, and after ``attempts`` empty sessions the time is taken with
    CUDA events around back-to-back calls instead (launch gaps
    included)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if kernel_name in ev.key]
        n = sum(ev.count for ev in evs)
        if n > iters:
            raise AssertionError(f"{n} {kernel_name} launches in {iters} calls: "
                                 "more than one per call")
        if n:
            if n < iters:
                log(f"  the profiler recorded {n} of {iters} {kernel_name} launches")
            return sum(ev.device_time_total for ev in evs) / 1e3 / n
        log(f"  the profiler recorded no {kernel_name} launch "
            f"(session {attempt} of {attempts})")
    ms = event_ms(torch, fn, iters)
    log(f"  {kernel_name}: timed with CUDA events instead, {ms:.4f} ms per call")
    return ms


def _template_args(args: str):
    """Itanium-mangled template arguments, readable: f = f32, a = int8,
    13__nv_bfloat16 = bf16, S1_ = the first argument again, Li64E = 64."""
    out, i = [], 0
    while i < len(args):
        c = args[i]
        if c in "fa":
            out.append("f32" if c == "f" else "int8")
            i += 1
        elif args.startswith("S1_", i):
            out.append(out[0])
            i += 3
        elif c == "L":
            j = args.index("E", i)
            out.append(args[i + 2:j])
            i = j + 1
        elif c.isdigit():
            n = re.match(r"\d+", args[i:]).group()
            name = args[i + len(n):i + len(n) + int(n)]
            out.append("bf16" if "bfloat16" in name else name)
            i += len(n) + int(n)
        else:
            out.append(args[i:])
            break
    return out


def _kernel_name(mangled: str) -> str:
    """``_ZN<n><namespace><m><name>I<args>EEv...`` -> ``name<args>``."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    args = re.match(r"I(\w+?)EEv", rest[m.end() + int(m.group(1)):])
    return f"{name}<{', '.join(_template_args(args.group(1)))}>" if args else name


def ptxas_summary(report: str):
    """One line per kernel instance from nvcc's -Xptxas -v report:
    registers and spill bytes."""
    name = None
    spills = ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            name = _kernel_name(m.group(1))
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
def paged_inputs(torch, rng, dev, dtype, kv_len, C, heads=(H, KV, HD)):
    """Pools, block tables (distinct pages, never the scratch page 0,
    zero-padded to a power-of-two width) and queries for ``kv_len``;
    ``heads`` = (query heads, kv heads, head dim)."""
    n_heads, n_kv, hd = heads
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
    return (t((B, C, n_heads, hd)), t((n_pages, PAGE, n_kv, hd)),
            t((n_pages, PAGE, n_kv, hd)), torch.from_numpy(bt).to(dev),
            torch.from_numpy(np.asarray(kv_len, np.int32)).to(dev))


def decode_inputs(torch, rng, dev, dtype, n_heads, n_kv, hd, S=2048,
                  kv_len=DECODE_KV_LEN):
    """q (B, 1, H, hd), a dense per-slot cache (B, S, KV, hd) and kv_len
    (default spread over 1..2048)."""
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, getattr(torch, dtype))
    B = len(kv_len)
    return (t((B, 1, n_heads, hd)), t((B, S, n_kv, hd)), t((B, S, n_kv, hd)),
            torch.tensor(kv_len, dtype=torch.int32, device=dev))


def int8_cache(torch, k, v):
    """Symmetric per-(sequence, kv head) int8 quantization of a cache."""
    def q8(x):
        s = x.float().abs().amax(dim=(1, 3)) / 127.0
        return torch.round(x.float() / s[:, None, :, None]).to(torch.int8), s
    (k8, ks), (v8, vs) = q8(k), q8(v)
    return k8, v8, ks.contiguous(), vs.contiguous()


def scan_inputs(torch, rng, dev, dtype, S, with_h0):
    a = torch.from_numpy(rng.uniform(0.3, 0.99, size=(1, S, RG_D)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, S, RG_D)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((1, RG_D)).astype(np.float32)).to(dev) \
        if with_h0 else None
    return a.to(dev, getattr(torch, dtype)), b.to(dev, getattr(torch, dtype)), h0


def check(name, dtype, got, want, errs, tol=None) -> float:
    tol = TOL[dtype] if tol is None else tol
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= tol
    log(f"  {name:60s} {dtype:8s} max|err| {err:.3e} (tol {tol:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: max abs err {err} > {tol}")
    errs.append(err)
    return err


def window_mask(torch, S, window, dev):
    """The causal sliding-window mask as SDPA's boolean attn_mask."""
    i = torch.arange(S, device=dev)
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)


def phase_kernels(torch, dev):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rs

    rng = np.random.default_rng(0)
    up = lambda *ts: [t.float() for t in ts]  # noqa: E731
    errs = {k: [] for k in ("flash", "flash_rg", "decode", "chunk", "dense_rg",
                            "dense_granite", "scan")}
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
        for S in (1024, 3000):
            q, k, v = t((1, S, RG_H, RG_HD)), t((1, S, RG_KV, RG_HD)), t((1, S, RG_KV, RG_HD))
            got = fa.flash_attention(q, k, v, causal=True, window=RG_WINDOW)
            want = ref.flash_attention(*up(q, k, v), causal=True,
                                       window=RG_WINDOW).to(q.dtype)
            check(f"K2 flash rg S={S} H=10 KV=1 hd=256 window={RG_WINDOW}", dtype,
                  got, want, errs["flash_rg"])
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
        for key, (nh, nkv, hd) in (("dense_rg", (RG_H, RG_KV, RG_HD)),
                                   ("dense_granite", (H, KV, HD))):
            q, k, v, kl = decode_inputs(torch, rng, dev, dtype, nh, nkv, hd)
            got = da.decode_attention(q, k, v, kl)
            want = ref.decode_attention(*up(q, k, v), kl).to(q.dtype)
            check(f"K3 decode B=8 S=2048 H={nh} KV={nkv} hd={hd} kv_len 1..2048",
                  dtype, got, want, errs[key])
        q, k, v, kl = decode_inputs(torch, rng, dev, dtype, RG_H, RG_KV, RG_HD)
        k8, v8, ks, vs = int8_cache(torch, k, v)
        got = da.decode_attention(q, k8, v8, kl, k_scale=ks, v_scale=vs)
        want = ref.decode_attention(q.float(), k8, v8, kl, k_scale=ks,
                                    v_scale=vs).to(q.dtype)
        check("K3 decode int8 cache, rg shapes", dtype, got, want, errs["dense_rg"])
        for S in (1024, 3000):
            for with_h0 in (False, True):
                a, b, h0 = scan_inputs(torch, rng, dev, dtype, S, with_h0)
                check(f"K5 rglru_scan B=1 S={S} D={RG_D} h0={with_h0}", dtype,
                      rs.rglru_scan(a, b, h0), ref.rglru_scan(a, b, h0),
                      errs["scan"], tol=0.0)
    torch.cuda.synchronize()

    log("phase 2: times at the main paths' shapes, bf16 (K5 float32, as the "
        "gates feed it; kernel: profiler device time; plain and library: "
        "CUDA events per call)")
    entries = {}
    dtype, isz = "bfloat16", 2
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # K2: a 1024-token granite prompt, causal
    S = 1024
    q, k, v = t((1, S, H, HD)), t((1, S, KV, HD)), t((1, S, KV, HD))
    pairs = S * (S + 1) // 2 * H
    b, by = bound_ms(isz * (2 * q.numel() + k.numel() + v.numel()), 4 * HD * pairs, dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    entries["flash"] = dict(
        name="flash_attention (hd 64)", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:27",
        shape=f"B=1 S={S} H={H} KV={KV} hd={HD} causal bf16",
        ms=kernel_ms(torch, lambda: fa.flash_attention(q, k, v), "flash_attention_kernel"),
        plain_ms=event_ms(torch, lambda: ref.flash_attention(q, k, v), 5),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True), 20))
    # K2 at recurrentgemma's widths: a 3000-token prompt, causal window 2048
    S = 3000
    q, k, v = t((1, S, RG_H, RG_HD)), t((1, S, RG_KV, RG_HD)), t((1, S, RG_KV, RG_HD))
    pairs = sum(min(i + 1, RG_WINDOW) for i in range(S)) * RG_H
    b, by = bound_ms(isz * (2 * q.numel() + k.numel() + v.numel()), 4 * RG_HD * pairs, dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = window_mask(torch, S, RG_WINDOW, dev)
    entries["flash_rg"] = dict(
        name="flash_attention (hd 256, window)", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:27",
        shape=f"B=1 S={S} H={RG_H} KV={RG_KV} hd={RG_HD} window {RG_WINDOW} bf16",
        ms=kernel_ms(torch, lambda: fa.flash_attention(q, k, v, window=RG_WINDOW),
                     "flash_attention_kernel", iters=10),
        plain_ms=event_ms(torch, lambda: ref.flash_attention(q, k, v, window=RG_WINDOW), 2),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True), 5))
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
    # K3: recurrentgemma ring decode and granite dense decode, kv_len 1..2048
    n_kv = sum(DECODE_KV_LEN)
    for key, (nh, nkv, hd), what in (
            ("dense_rg", (RG_H, RG_KV, RG_HD), "recurrentgemma ring"),
            ("dense_granite", (H, KV, HD), "granite dense")):
        q, k, v, kl = decode_inputs(torch, rng, dev, dtype, nh, nkv, hd)
        b, by = bound_ms(isz * (2 * q.numel() + 2 * n_kv * nkv * hd) + 4 * kl.numel(),
                         4 * hd * nh * n_kv, dtype)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lmask = (torch.arange(k.shape[1], device=dev)[None] < kl[:, None])[:, None, None]
        entries[key] = dict(
            name=f"decode_attention ({what})", route="cuda",
            source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:31",
            shape=f"{what}: B=8 S=2048 H={nh} KV={nkv} hd={hd} kv_len 1..2048 "
                  f"({n_kv} keys) bf16",
            ms=kernel_ms(torch, lambda: da.decode_attention(q, k, v, kl),
                         "decode_attention_kernel"),
            plain_ms=event_ms(torch, lambda: ref.decode_attention(q, k, v, kl), 10),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=lmask,
                                                     enable_gqa=True), 20))
    # K5: a 3000-token recurrentgemma prefill's scan, float32 a and b
    S = 3000
    a, bb, _ = scan_inputs(torch, rng, dev, "float32", S, False)
    b, by = bound_ms(4 * 3 * S * RG_D, 2 * S * RG_D, "float32")
    entries["scan"] = dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:26",
        shape=f"B=1 S={S} D={RG_D} float32",
        ms=kernel_ms(torch, lambda: rs.rglru_scan(a, bb), "rglru_scan_kernel"),
        plain_ms=event_ms(torch, lambda: ref.rglru_scan(a, bb), 2, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None)
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
        lib = f"{e['library_ms']:.4f}" if e["library_ms"] is not None else "n/a"
        log(f"  {e['name']:40s} {e['shape']}: kernel {e['ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']}), plain {e['plain_ms']:.4f} ms, "
            f"library {lib} ms")
    return entries


def routed_sizes(rng, n_tok, E, k, d):
    """Group sizes (E,) of a real top-k routing of ``n_tok`` random hidden
    states through a random router (scale 0.02, as the model's)."""
    h = rng.standard_normal((n_tok, d)).astype(np.float32)
    logits = h @ (0.02 * rng.standard_normal((d, E))).astype(np.float32)
    top = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    return np.bincount(top.reshape(-1), minlength=E).astype(np.int32)


def gmm_inputs(torch, dev, dtype, sizes, T, K, N, seed):
    """x (T, K) ~ N(0, 1), w (E, K, N) ~ N(0, 1/K) (the model's init scale,
    so outputs are O(1)), made on the card from ``seed``; group sizes on
    the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((T, K), generator=g, device=dev).to(getattr(torch, dtype))
    w = torch.randn((len(sizes), K, N), generator=g, device=dev)
    w = w.mul_(K ** -0.5).to(getattr(torch, dtype))
    return x, w, torch.tensor(np.asarray(sizes), dtype=torch.int32, device=dev)


def gmm_tol(dtype, want) -> float:
    """float32: summation order, 2e-5 of the largest output (at least 1);
    bf16: float32 sums taken in different orders, each rounded once to
    bf16, can land one bf16 ulp apart: 2**-7 of the largest output."""
    scale = max(want.float().abs().max().item(), 1.0)
    return (2e-5 if dtype == "float32" else 2.0 ** -7) * scale


def gmm_library(torch, x, w, gs):
    """``torch._grouped_mm`` on the same operands (the yardstick the port
    never calls), or the reason it cannot be timed."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch has no _grouped_mm"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        fn(x, w, offs=offs)
        torch.cuda.synchronize()
    except Exception as exc:                     # noqa: BLE001 (reported)
        return None, f"_grouped_mm refused the operands: {type(exc).__name__}: {exc}"
    return (lambda: fn(x, w, offs=offs)), None


def phase_kernels_moe(torch, dev):
    """Phase 2 at llama4-scout's and grok-1's widths: K1 decode, K2 and K3
    at hd 128 with G = 5; K4 at the MoE path's shapes, and edge cases."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(3)
    up = lambda *ts: [t.float() for t in ts]  # noqa: E731
    heads = (L4_H, L4_KV, L4_HD)
    l4_sizes = {"prefill": routed_sizes(rng, 1024, 16, 1, 5120),
                "decode": routed_sizes(rng, 8, 16, 1, 5120)}
    grok_sizes = routed_sizes(rng, 1024, 8, 2, 6144)
    # key: (label, group sizes, T, K, N)
    gmm_cases = {
        "gmm_l4_prefill": ("llama4 prefill gate/up, 1024 tokens top-1",
                           l4_sizes["prefill"], 1024, 5120, 8192),
        "gmm_l4_down": ("llama4 prefill down", l4_sizes["prefill"], 1024, 8192, 5120),
        "gmm_l4_decode": ("llama4 decode gate/up, 8 tokens over 16 experts",
                          l4_sizes["decode"], 8, 5120, 8192),
        "gmm_grok": ("grok-1 gate/up, 1024 tokens top-2", grok_sizes, 2048, 6144, 32768),
        "gmm_grok_down": ("grok-1 down", grok_sizes, 2048, 32768, 6144),
        "gmm_edge": None,
    }
    edge_cases = [("T=1", [0] * 9 + [1] + [0] * 6, 1, 5120, 8192),
                  ("all rows in one expert", [0, 0, 0, 300] + [0] * 12, 300, 5120, 8192),
                  ("groups off the 64-row tile, a tail no group covers",
                   [65, 63, 1, 0, 127], 300, 5120, 1024)]
    errs = {k: [] for k in ["flash_l4", "decode_l4", "dense_l4", *gmm_cases]}
    log(f"phase 2: llama4-scout / grok-1 widths (H={L4_H} KV={L4_KV} hd={L4_HD}; "
        f"K4 group sizes from a top-k routing of random hidden states: llama4 "
        f"prefill {l4_sizes['prefill'].tolist()}, decode {l4_sizes['decode'].tolist()}, "
        f"grok-1 {grok_sizes.tolist()})")
    for dtype in ("bfloat16", "float32"):
        t = lambda shape: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape).astype(np.float32)).to(dev, getattr(torch, dtype))
        for S, kw in ((1024, dict(causal=True)), (1500, dict(causal=True, chunk=1024))):
            q, k, v = t((1, S, L4_H, L4_HD)), t((1, S, L4_KV, L4_HD)), t((1, S, L4_KV, L4_HD))
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.flash_attention(*up(q, k, v), **kw).to(q.dtype)
            check(f"K2 flash hd=128 G=5 S={S} {kw}", dtype, got, want, errs["flash_l4"])
        q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, L4_KV_LEN, 1, heads)
        got = pa.paged_decode_attention(q, kp, vp, bt, kl)
        want = ref.paged_decode_attention(*up(q, kp, vp), bt, kl).to(q.dtype)
        check(f"K1 decode hd=128 G=5 B=8 kv_len={L4_KV_LEN}", dtype, got, want,
              errs["decode_l4"])
        q, k, v, kl = decode_inputs(torch, rng, dev, dtype, *heads, S=L4_CHUNK,
                                    kv_len=L4_RING_LEN)
        got = da.decode_attention(q, k, v, kl)
        want = ref.decode_attention(*up(q, k, v), kl).to(q.dtype)
        check(f"K3 ring hd=128 G=5 L={L4_CHUNK} kv_len={L4_RING_LEN}", dtype, got, want,
              errs["dense_l4"])
        del q, k, v, kp, vp, got, want
        cases = [(key, *c) for key, c in gmm_cases.items() if c] + \
            [("gmm_edge", *c) for c in edge_cases]
        for i, (key, label, sizes, T, K, N) in enumerate(cases):
            x, w, gs = gmm_inputs(torch, dev, dtype, sizes, T, K, N, seed=10 + i)
            got = gm.moe_gmm(x, w, gs)
            want = ref.moe_gmm(x, w, gs)      # float32 inside, rounded once
            check(f"K4 {label} T={T} K={K} N={N}", dtype, got, want, errs[key],
                  tol=gmm_tol(dtype, want))
            if not torch.isfinite(got).all():
                raise AssertionError(f"K4 {label}: non-finite output")
            del x, w, gs, got, want
            torch.cuda.empty_cache()
    torch.cuda.synchronize()

    log("phase 2: times at llama4-scout / grok-1 shapes, bf16 (kernel: profiler "
        "device time; plain and library: CUDA events per call)")
    entries = {}
    dtype, isz = "bfloat16", 2
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # K2: a 2048-token prompt through a global (ATTN) layer, causal
    S = 2048
    q, k, v = t((1, S, L4_H, L4_HD)), t((1, S, L4_KV, L4_HD)), t((1, S, L4_KV, L4_HD))
    b, by = bound_ms(isz * (2 * q.numel() + k.numel() + v.numel()),
                     4 * L4_HD * S * (S + 1) // 2 * L4_H, dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    entries["flash_l4"] = dict(
        name="flash_attention (hd 128)", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:27",
        shape=f"B=1 S={S} H={L4_H} KV={L4_KV} hd={L4_HD} causal bf16",
        ms=kernel_ms(torch, lambda: fa.flash_attention(q, k, v), "flash_attention_kernel",
                     iters=10),
        plain_ms=event_ms(torch, lambda: ref.flash_attention(q, k, v), 2),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True), 10))
    # K1 decode at hd 128: the global layers' paged decode
    q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, L4_KV_LEN, 1, heads)
    n_kv = sum(L4_KV_LEN)
    b, by = bound_ms(isz * (2 * q.numel() + 2 * n_kv * L4_KV * L4_HD) + 4 * (bt.numel() + 8),
                     4 * L4_HD * L4_H * n_kv, dtype)
    entries["decode_l4"] = dict(
        name="paged_decode_attention (hd 128)", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:135",
        shape=f"B=8 kv_len={L4_KV_LEN} H={L4_H} KV={L4_KV} hd={L4_HD} page={PAGE} bf16",
        ms=kernel_ms(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, kl),
                     "paged_rows_kernel"),
        plain_ms=event_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, bt, kl), 10),
        bound_ms=b, bound_by=by, library_ms=None)
    # K3 at hd 128: the chunked layers' ring decode, kv_len wrapped
    q, k, v, kl = decode_inputs(torch, rng, dev, dtype, *heads, S=L4_CHUNK,
                                kv_len=L4_RING_LEN)
    n_kv = sum(L4_RING_LEN)
    b, by = bound_ms(isz * (2 * q.numel() + 2 * n_kv * L4_KV * L4_HD) + 4 * kl.numel(),
                     4 * L4_HD * L4_H * n_kv, dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lmask = (torch.arange(k.shape[1], device=dev)[None] < kl[:, None])[:, None, None]
    entries["dense_l4"] = dict(
        name="decode_attention (llama4 ring, hd 128)", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:31",
        shape=f"B=8 L={L4_CHUNK} H={L4_H} KV={L4_KV} hd={L4_HD} kv_len {L4_RING_LEN} "
              f"({n_kv} keys) bf16",
        ms=kernel_ms(torch, lambda: da.decode_attention(q, k, v, kl),
                     "decode_attention_kernel"),
        plain_ms=event_ms(torch, lambda: ref.decode_attention(q, k, v, kl), 5),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=lmask,
                                                 enable_gqa=True), 10))
    del q, k, v, kp, vp, qt, kt, vt, lmask
    # K4 at the MoE path's shapes
    for i, (key, c) in enumerate(gmm_cases.items()):
        if c is None:
            continue
        label, sizes, T, K, N = c
        x, w, gs = gmm_inputs(torch, dev, dtype, sizes, T, K, N, seed=50 + i)
        used = int((np.asarray(sizes) > 0).sum())
        b, by = bound_ms(isz * (T * K + used * K * N + T * N) + 4 * len(sizes),
                         2 * T * K * N, dtype)
        lib, why = gmm_library(torch, x, w, gs)
        if why:
            log(f"  K4 {label}: library_ms none: {why}")
        big = T * K * N > 1e11
        entries[key] = dict(
            name=f"moe_gmm ({label})", route="cuda",
            source="src/repro_torch/csrc/moe_gmm.cu",
            replaces="src/repro/kernels/moe_gmm.py:26",
            shape=f"T={T} K={K} N={N} E={len(sizes)} ({used} used) bf16",
            ms=kernel_ms(torch, lambda: gm.moe_gmm(x, w, gs), "moe_gmm_kernel",
                         iters=3 if big else 20),
            plain_ms=event_ms(torch, lambda: ref.moe_gmm(x, w, gs), 2, warmup=1),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, lib, 10) if lib else None)
        del x, w, gs, lib
        torch.cuda.empty_cache()
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
        lib = f"{e['library_ms']:.4f}" if e["library_ms"] is not None else "n/a"
        log(f"  {e['name']:40s} {e['shape']}: kernel {e['ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']}), plain {e['plain_ms']:.4f} ms, "
            f"library {lib} ms")
    log(f"  K4 edge cases: max|err| {max(errs['gmm_edge']):.3e}")
    return entries


# ----------------------------------------------------------------------
# phase 3: the served paths at full width
# ----------------------------------------------------------------------
GRANITE_PROMPTS = [64, 1024, 200, 700, 128, 512, 900, 333]
RG_PROMPTS = [64, 700, 1024, 2100, 3000, 333, 1500, 2600]
# 8500 tokens: K2's chunk mask splits the prompt at 8192 and the chunked
# layers' rings restart at slot 0
L4_PROMPTS = [64, 2048, 8500, 200, 700, 1024, 128, 1500]
GMM_KEYS = ("gmm_l4_prefill", "gmm_l4_down", "gmm_l4_decode", "gmm_grok", "gmm_grok_down")
MAX_NEW = 32


def _counters():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as rs
    return {"flash": fa.flash_attention, "decode": pa.paged_decode_attention,
            "chunk": pa.paged_prefill_attention, "dense": da.decode_attention,
            "scan": rs.rglru_scan, "gmm": gm.moe_gmm}


def launches():
    return {k: f.launches for k, f in _counters().items()}


def zero_launches() -> None:
    for f in _counters().values():
        f.launches = 0


def serve_run(torch, cfg, dev, *, page_size, prefill_chunk, max_len, prompt_lens,
              need, absent=()):
    """Cold start, then 4 events of 2 prompts (one event alone, then a
    micro-batch of 3) through the runtime front door. Launch counts are
    zeroed just before the events and read just after: every kernel of
    ``need`` must have launched and none of ``absent``."""
    from repro_torch.core.runtime import run_batch
    from repro_torch.serve.api import make_serve_runtime

    rdef = make_serve_runtime(cfg, page_size=page_size, max_slots=8, max_len=max_len,
                              max_batch=4, prefill_chunk=prefill_chunk, seed=0,
                              device=dev)
    t0 = time.perf_counter()
    engine = rdef.setup()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab, size=n).tolist() for n in prompt_lens]
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
    if engine.free_slots() != list(range(engine.max_slots)):
        raise AssertionError(f"leaked slots: {engine.stats()}")
    if engine.paged:
        engine.allocator.check_invariants()
        if engine.allocator.n_free != engine.num_pages - 1:
            raise AssertionError(f"leaked pages: {engine.stats()}")
    if any(counts[k] == 0 for k in need) or any(counts[k] for k in absent):
        raise AssertionError(f"launches {counts}: need {need}, absent {absent}")
    n_tok = sum(len(o) for o in outs)
    ttft = sorted(engine.ttft_s)
    log(f"  page_size={page_size} prefill_chunk={prefill_chunk}: cold start "
        f"{cold_s:.3f} s; {len(outs)} requests, {n_tok} tokens in {wall:.3f} s = "
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


def profile_served(torch, engine, cfg, context: int, prefill_len: int):
    """Where the time of a served path goes: 3 decode steps of a full batch
    (8 slots at ~``context`` tokens; the prompts prefill whole) and one
    ``prefill_len``-token prefill."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(5)
    steps = 3
    for i in range(engine.max_slots):
        engine.submit(Request(prompt=rng.integers(3, cfg.vocab, size=context).tolist(),
                              max_new_tokens=steps + 4, req_id=100 + i))
    engine.step()                   # admits and prefills all 8, one decode
    profile_breakdown(torch, f"{cfg.name} decode step (B=8, ~{context} context)",
                      lambda: [engine.step() for _ in range(steps)], steps)
    engine.generate([])             # drain
    toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(1, prefill_len))).to(engine.device)
    M.prefill(cfg, engine.params, {"tokens": toks})
    profile_breakdown(torch, f"{cfg.name} prefill (1 x {prefill_len} tokens)",
                      lambda: M.prefill(cfg, engine.params, {"tokens": toks}), 1)


# ----------------------------------------------------------------------
# phase 4: parity of the paths on the card
# ----------------------------------------------------------------------
@contextlib.contextmanager
def shared_routes():
    """While open, the two paths share the MoE router's expert choices: a
    kernel-path call (``cur[0]`` None) records its top-k, and the plain
    path's (``cur[0]`` "ref") call at the same layer of the same pass
    follows it, with its weights renormalised from its own probabilities.
    Top-k is a discrete choice like the greedy token, which the check
    teacher-forces for the same reason: in bf16 a near tie can flip it on
    one path and change that token's logits wholesale, which says nothing
    about the kernels. Yields a count of the decisions and of those where
    the plain path's own top-k differs."""
    import torch
    from repro_torch.models import blocks as B
    route, cur, queue = B.route, [None], collections.deque()
    count = {"all": 0, "differ": 0}

    def shared_route(cfg, params, xf):
        probs, top_p, top_i = route(cfg, params, xf)
        if cur[0] is None:
            queue.append(top_i)
            return probs, top_p, top_i
        forced = queue.popleft()
        count["all"] += forced.shape[0]
        count["differ"] += int((forced != top_i).any(-1).sum())
        top_p = probs.gather(-1, forced)
        return probs, top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9), forced
    B.route = shared_route
    try:
        yield count, cur
    finally:
        B.route = route
    if queue:
        raise AssertionError(f"{len(queue)} kernel-path routings had no plain-path twin")


def logits_parity(torch, cfg, params, dev, S, paged):
    """Prefill + 8 decode steps through the kernels and through
    impl="ref", teacher-forced on the kernel path's greedy tokens; the
    decode cache is paged (granite, llama4's global layers) or dense
    per-slot (recurrentgemma). A MoE model's plain path follows the kernel
    path's routing (``shared_routes``); the number of (token, layer)
    decisions where its own would differ is logged, and reported beside a
    failure."""
    from repro_torch.models import model as M
    from repro_torch.models.param import iter_leaves
    from repro_torch.serve.engine import install_slot

    rng = np.random.default_rng(2)
    steps = 8
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(1, S))).to(dev)
    n_pages = -(-(S + steps) // PAGE)
    table = torch.arange(1, n_pages + 1, dtype=torch.int32, device=dev)[None] \
        if paged else None
    res, caches = {}, {}
    with shared_routes() as (routes, cur):
        for impl in (None, "ref"):
            cur[0] = impl
            logits, dense = M.prefill(cfg, params, {"tokens": tokens},
                                      cache_len=S + steps, impl=impl)
            if paged:
                caches[impl] = M.init_paged_cache(cfg, 1, S + steps, n_pages + 1, PAGE,
                                                  device=dev)
                pooled = {path for (path, _), flag in zip(
                    iter_leaves(caches[impl]), M.paged_leaf_flags(cfg, caches[impl]))
                    if flag}
                install_slot(caches[impl], dense, 0, table[0].long(), pooled)
            else:
                caches[impl] = dense
            res[impl] = [logits[0, -1].float()]
        toks = [int(torch.argmax(res[None][0]))]
        for i in range(steps):
            tok = torch.tensor([[toks[-1]]], device=dev)
            pos = torch.tensor([S + i], dtype=torch.int32, device=dev)
            for impl in (None, "ref"):
                cur[0] = impl
                logits, _ = M.decode_step(cfg, params, caches[impl], tok, pos,
                                          block_tables=table, impl=impl)
                res[impl].append(logits[0, 0].float())
            toks.append(int(torch.argmax(res[None][-1])))
    diffs = [(a - b).abs().max().item() for a, b in zip(res[None], res["ref"])]
    agree = sum(int(torch.argmax(a)) == int(torch.argmax(b))
                for a, b in zip(res[None], res["ref"]))
    scale = max(r.abs().max().item() for r in res["ref"])
    tol = 0.05 * scale
    routing = ""
    if cfg.n_experts:
        routing = (f"; routing shared, the plain path's own choice differs in "
                   f"{routes['differ']} of {routes['all']} (token x layer) decisions")
    log(f"  {cfg.name} full width bf16, {S}-token prompt: max|logit diff| per step "
        f"{['%.4f' % d for d in diffs]} (tol {tol:.4f} = 5% of max|logit| "
        f"{scale:.3f}); greedy agreement {agree}/{len(diffs)}{routing}")
    if max(diffs) > tol:
        raise AssertionError(f"bf16 logits differ by {max(diffs)} > {tol}{routing}")


def engine_tokens(cfg, params, dev, lens, max_len, **kw):
    from repro_torch.serve.engine import Request, ServingEngine
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, cfg.vocab, size=n).tolist() for n in lens]
    eng = ServingEngine(cfg, params, max_slots=4, max_len=max_len, device=dev, **kw)
    done = eng.generate([Request(prompt=list(p), max_new_tokens=12, req_id=i)
                         for i, p in enumerate(prompts)])
    return {r.req_id: r.output for r in done}


def greedy_parity(torch, cfg, dev, lens, max_len, runs):
    """float32 greedy tokens of every engine setting in ``runs`` (kwargs
    of ServingEngine) identical to the first's."""
    from repro_torch.models import model as M
    params = M.init_model_params(cfg, 3, dev)
    outs = [engine_tokens(cfg, params, dev, lens, max_len, **kw) for kw in runs]
    for kw, out in zip(runs[1:], outs[1:]):
        if out != outs[0]:
            raise AssertionError(f"{cfg.name} f32 greedy tokens differ ({runs[0]} vs "
                                 f"{kw}): {outs[0]} vs {out}")
    log(f"  {cfg.name} {cfg.n_layers} layers float32: greedy tokens identical for "
        f"{len(lens)} requests (prompts {lens}) across {runs}")
    del params
    torch.cuda.empty_cache()


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
    from repro_torch.models.param import iter_leaves

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
    entries.update(phase_kernels_moe(torch, dev))
    torch.cuda.empty_cache()

    # phase 3: granite-3-2b (paged whole-prompt, paged chunked, dense)
    cfg = get_config("granite-3-2b")
    log(f"phase 3: served path, {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} d_ff={cfg.d_ff} "
        f"vocab {cfg.padded_vocab} {cfg.dtype}, random weights (seed 0)")
    total = {"flash": 0, "decode": 0, "chunk": 0, "dense_granite": 0, "flash_rg": 0,
             "dense_rg": 0, "scan": 0}
    engine = None
    for page_size, chunk in ((PAGE, 0), (PAGE, 256), (0, 0)):
        engine = None
        torch.cuda.empty_cache()
        need = ["flash"] + (["decode"] if page_size else ["dense"]) + \
            (["chunk"] if chunk else [])
        engine, counts = serve_run(
            torch, cfg, dev, page_size=page_size, prefill_chunk=chunk, max_len=2048,
            prompt_lens=GRANITE_PROMPTS, need=need,
            absent=["scan"] + (["dense"] if page_size else ["decode", "chunk"]))
        total["flash"] += counts["flash"]
        total["decode"] += counts["decode"]
        total["chunk"] += counts["chunk"]
        total["dense_granite"] += counts["dense"]
        if page_size and not chunk:
            profile_served(torch, engine, cfg, context=256, prefill_len=1024)
            params = engine.params
    engine = None
    torch.cuda.empty_cache()

    log("phase 4: parity through the kernels against impl='ref'")
    logits_parity(torch, cfg, params, dev, S=300, paged=True)
    del params
    torch.cuda.empty_cache()

    # phase 3: recurrentgemma-2b, paged (its ring caches and state are
    # per-slot; nothing is pooled), whole-prompt prefill
    rg = get_config("recurrentgemma-2b")
    log(f"phase 3: served path, {rg.name} {rg.n_layers} layers pattern "
        f"{[k.value for k in rg.pattern]} d={rg.d_model} heads {rg.n_heads}/"
        f"{rg.n_kv_heads} hd={rg.hd} window {rg.window} d_ff={rg.d_ff} vocab "
        f"{rg.padded_vocab} {rg.dtype}, random weights (seed 0)")
    engine, counts = serve_run(
        torch, rg, dev, page_size=PAGE, prefill_chunk=0, max_len=4096,
        prompt_lens=RG_PROMPTS, need=["flash", "dense", "scan"],
        absent=["decode", "chunk"])
    total["flash_rg"] = counts["flash"]
    total["dense_rg"] = counts["dense"]
    total["scan"] = counts["scan"]
    profile_served(torch, engine, rg, context=2100, prefill_len=3000)
    params = engine.params
    engine = None
    logits_parity(torch, rg, params, dev, S=2100, paged=False)
    del params
    torch.cuda.empty_cache()

    greedy_parity(torch, dataclasses.replace(rg, n_layers=5, dtype="float32"), dev,
                  lens=[40, 300, 2100, 1000], max_len=2200,
                  runs=[dict(page_size=PAGE), dict(page_size=PAGE, impl="ref")])
    greedy_parity(torch, dataclasses.replace(cfg, n_layers=4, dtype="float32"), dev,
                  lens=[40, 300, 700, 1000], max_len=1100,
                  runs=[dict(page_size=PAGE), dict(page_size=PAGE, impl="ref"),
                        dict(page_size=PAGE, prefill_chunk=256),
                        dict(page_size=PAGE, prefill_chunk=256, impl="ref"),
                        dict(page_size=0), dict(page_size=0, impl="ref")])

    # phase 3: llama4-scout, 8 of its 48 layers (2 periods of ATTN +
    # 3 CHUNKED; the published depth does not fit one card), every width
    # as published; MoE through K4, global layers paged (K1), chunked
    # layers on ring caches (K3), every prefill through K2
    l4 = dataclasses.replace(get_config("llama4-scout-17b-a16e"), n_layers=8)
    log(f"phase 3: served path, {l4.name} cut to {l4.n_layers} layers (pattern "
        f"{[k.value for k in l4.pattern]} x 2) d={l4.d_model} heads {l4.n_heads}/"
        f"{l4.n_kv_heads} hd={l4.hd} chunk {l4.chunk} experts {l4.n_experts} top-"
        f"{l4.top_k} d_ff={l4.d_ff} vocab {l4.padded_vocab} {l4.dtype}, random "
        "weights (seed 0)")
    torch.cuda.reset_peak_memory_stats()
    engine, counts = serve_run(
        torch, l4, dev, page_size=PAGE, prefill_chunk=0, max_len=9216,
        prompt_lens=L4_PROMPTS, need=["flash", "decode", "dense", "gmm"],
        absent=["chunk", "scan"])
    log(f"  {l4.name}: {sum(t.numel() for _, t in iter_leaves(engine.params)) / 1e9:.2f} B "
        f"parameters, {torch.cuda.max_memory_allocated() / 1e9:.1f} GB peak allocated")
    total["flash_l4"], total["decode_l4"] = counts["flash"], counts["decode"]
    total["dense_l4"] = counts["dense"]
    for key in GMM_KEYS:
        total[key] = counts["gmm"]
    profile_served(torch, engine, l4, context=1024, prefill_len=2048)
    params = engine.params
    engine = None
    # chunk 1024 so a 2100-token prompt crosses the mask boundary while the
    # plain attention still fits
    logits_parity(torch, dataclasses.replace(l4, chunk=1024), params, dev, S=2100,
                  paged=True)
    del params
    torch.cuda.empty_cache()
    # float32, one period (4 layers, 37.4 GB), chunk 512 so the longer
    # prompts cross a chunk boundary
    greedy_parity(torch, dataclasses.replace(l4, n_layers=4, dtype="float32", chunk=512),
                  dev, lens=[40, 300, 700, 1000], max_len=1100,
                  runs=[dict(page_size=PAGE), dict(page_size=PAGE, impl="ref")])

    kernels = []
    for key in ("decode", "chunk", "flash", "flash_rg", "dense_rg", "dense_granite",
                "scan", "flash_l4", "decode_l4", "dense_l4", *GMM_KEYS):
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
