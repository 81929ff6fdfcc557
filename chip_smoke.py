#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), then
   every kernel of the paths built from ``src/repro_torch/csrc`` with nvcc
   (one process per source, in parallel), with each instance's registers,
   spills and static shared memory from ptxas, and its count of
   tensor-core instructions (HMMA, HGMMA) from ``cuobjdump -sass``; the
   bf16 instances of K2, K1's chunks (the prefill body they share), K4 and
   the split decode body (K1 decode, K3) must have some.
2. Kernels against their plain PyTorch versions on the card, in bf16 and
   float32, at the main paths' shapes: K2 flash attention (granite-3-2b
   prefill, H=32 KV=8 hd=64; recurrentgemma-2b prefill, H=10 KV=1 hd=256,
   window 2048, up to 3000 tokens), K1 paged attention (decode and chunked
   prefill; decode also at hd 256), K3 decode attention (recurrentgemma's
   ring decode, B=8 S=2048 G=10 hd=256; granite's dense per-slot decode,
   G=4 hd=64; int8 caches at hd 64, 128 and 256)
   and K5 the RG-LRU scan (B=1 D=2560, float32 and bf16 held to 0 error,
   each channel count of its plan timed and the default's GB/s logged); at
   llama4-scout's widths (H=40 KV=8 hd=128, G=5) K2 (causal, and a chunk
   mask crossed), K1 decode and K3 ring decode (L=8192, kv_len wrapped);
   at the dense catalogue's widths (phase 7's archs) K2 (S=1024, causal;
   qwen2.5-14b H=40 KV=8 and deepseek-7b H=32 KV=32, hd 128), K1 decode
   (both; deepseek's G = 1 puts one query row in each 16-row group), K1's
   256-token chunks at q_offset 256 and 768 and K3 on the dense layout
   (qwen, B=8 S=2048); at whisper-tiny's widths (H = KV = 6, G = 1, hd
   64; phase 8 (b)'s shapes) K2 over the encoder's 1500 frames and for the
   cross prefill (32 rows against 1500 frames), both without a mask, and
   K3 for the cross decode (B=8, L = kv_len = 1500); K4 the grouped matmul at the MoE path's shapes (llama4 prefill gate/up
   and down, 1024 tokens top-1 over 16 experts; llama4 decode, 8 tokens;
   grok-1 gate/up and down, 1024 tokens top-2 over 8 experts, group sizes
   from a real routing) and edge cases (T=1, one expert, groups off the
   tile, rows no group covers). Each kernel's time (``ms``: profiler
   device time; ``event_ms``: CUDA events around back-to-back calls)
   beside its bound, its plain version's time and, where one PyTorch call
   computes the same function, that call's time (``library_ms``:
   ``scaled_dot_product_attention``, for K1 decode and chunks with a length
   (and causal-offset) mask over the keys gathered to a contiguous copy
   before timing;
   ``torch._grouped_mm``; the port never calls them) and
   ``ms_over_library_ms``. K1 decode and K3 run the split-KV body of
   ``csrc/decode_common.cuh`` and, with more than one split, its merge:
   their ``ms`` is the two kernels' device time per call.
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
   tokens/s, and profiles of a decode step and a prefill (with the shares
   of K2, K5 and K1 chunk), and of granite's chunked prefill of one
   1024-token prompt through the engine.
   Then granite-3-2b paged again through the serverless front door:
   ``Gateway.invoke`` -> ``EngineBackend`` (its worker thread on the card)
   -> ``make_serve_runtime``, with the tracer on: 8 one-prompt events
   mapped at once (micro-batches of up to 4), then the same 8 invoked one
   at a time. Every future's result is read; checks: one cold start then
   warm starts, a micro-batch of 2 or more, the accelerator
   ``local/w0(host-cuda)``, K2 and K1 decode launched and no other kernel,
   no leaked page, a valid exported trace, each invocation's tiling spans
   within 10% of its RLat (true by construction of the span tree: a
   check of its shape), each batch's lead ``execute`` span holding
   ``prefill`` and ``decode`` spans, and each one-at-a-time event's tokens
   equal to ``run_batch`` of it on the main thread with the same engine.
   Printed: RLat and ELat p50 / max, the gateway's host cost per event
   (RLat - ELat, split into queue, warm dispatch and settle), the
   ``cold_start`` span, batch sizes, tokens/s per wave and the mean
   duration of each span name. The ``kernels`` line counts this path's
   launches under entries of their own (``..., via Gateway.invoke``).
4. Parity of the paths on the card: full-width bf16 logits of granite, of
   recurrentgemma and of llama4 (chunk 1024, a 2100-token prompt; the
   plain path follows the kernel path's expert choices, and those where
   its own would differ are counted) through the kernels against
   ``impl="ref"``; float32 greedy tokens through the kernels identical to
   ``impl="ref"`` (granite 4 layers, recurrentgemma 5 layers, llama4 4
   layers at full width), and granite's dense engine identical to its
   paged engine.
5. Granite-3-2b (as registered) behind Hardless's control plane and on
   the simulated cluster, printed under ``phase 5:`` after the gateway
   phase: (a) a min-warm floor prewarms the engine on the plane's tick
   thread, and the first invoke is prewarmed, not cold (its RLat beside a
   fresh backend's cold first invoke); (b) a 0.5 s keep-alive TTL evicts
   the idle engine and ``torch.cuda.memory_allocated()`` must come back
   within 64 MiB of its value before setup (the next invoke is cold and
   gives the same tokens); (c) a tenant quota (free=1:1) sheds the free
   tenant's excess as ``InvocationRejected`` while the other tenant's 6
   events are served; (d) the SLO scaler scales the workers out under a
   burst of 16 events in two run configs (two engines; workers share the
   card); (e) ``SimBackend`` with one node whose accelerator is this card
   (2 slots) runs 8 events through the serve runtime's real ``fn`` in
   virtual time, each event's tokens equal to ``run_batch`` of it on the
   main thread. Each of the two paths launches K2 and K1 decode (and no
   other kernel), counted on its own: the ``kernels`` line has them under
   ``..., via ControlPlane`` ((a)-(d)) and ``..., via SimBackend`` ((e)).
6. Granite-3-2b (as registered) through Hardless's multi-process cluster,
   printed under ``phase 6:``: ``Gateway.invoke`` -> ``ClusterBackend``
   -> the ``Master`` (queue, leases, store, keeper; RPC on the loopback)
   -> 2 worker processes from ``start_cluster``, each with its own CUDA
   context and engine on this card, serving this file's
   ``counted_serve_runtime`` (the port's ``serve_runtime`` with the
   worker's launch counts, pid, batch, weights checksum and cold-start
   time riding every result; the parent counts nothing a worker launches,
   and a worker sets its counts to 0 when it builds its engine). (a) A
   prewarm directive to each worker (round-robin: each worker's one cold
   start), then 8 one-prompt events mapped while the master holds the
   takes (so each prewarmed worker takes a micro-batch of 4), then 4 one
   at a time: both workers serve, no cold start, a valid trace whose
   parents all resolve across the processes, each batch's worker-authored
   ``execute`` span holding ``prefill`` and ``decode``, K2 and K1 decode
   and no other kernel in each worker (its counts read from its latest
   batch); (b) a ``kill-worker-process`` fault SIGKILLs the worker
   holding an event's lease: the keeper requeues it, it runs again on the
   survivor as attempt 1 with (a)'s tokens, and the dead process's card
   memory comes back (``mem_get_info``); (c) two three-step chains
   (generate -> refine -> polish); (d) an eviction broadcast frees the
   survivor's engine on the card, and one more event cold-starts it
   again. Every event's tokens equal ``run_batch`` of the same batch in
   this process on an engine from the same seed (weights checksums
   equal). Printed: start to hello, each worker's cold start (its
   prewarm's setup) and (d)'s ``cold_start`` span, RLat and ELat (burst
   vs one at a time), the host cost per event over
   RPC beside phase 3's in-process gateway, SIGKILL to requeue, card
   memory per worker. The ``kernels`` line has (a)'s launches, summed
   over the workers, under ``..., via ClusterBackend``.

7. The rest of the dense catalogue at full width, then the roofline, printed
   under ``phase 7:`` after phase 3's llama4-scout: (a) qwen2.5-14b as
   registered (48 layers, d 5120, 40/8 heads, hd 128, d_ff 13824, vocab
   152064, QKV bias, rope theta 1e6; bf16, max_len 2048, 8 slots) paged
   whole-prompt (K2 + K1 decode), paged 256-token chunks (K1 chunk + K1
   decode) and dense (K2 + K3), launches counted per path as phase 3's;
   its bf16 logits against ``impl="ref"`` and float32 greedy tokens at 4
   layers through all three layouts, with the QKV biases drawn non-zero
   from a seed for both checks (the specs start them at zero); (b)
   deepseek-7b as registered (30 layers, d 4096, 32/32 heads, hd 128)
   paged whole-prompt, K2 and K1 decode at G = 1, with the logits check;
   (c) for every served decode step of phases 3 and 7 (granite,
   recurrentgemma, llama4-scout at 8 layers, qwen, deepseek) the analytic
   memory bound (``roofline.analytic.memory_model`` in bf16 over the
   datasheet's 3.35 TB/s) over the step's host-clock time (without the
   profiler) and over its device busy time (under it), and each profiled
   prefill's MFU (``model_flops`` over the time at 989 TFLOP/s): readings,
   not gates; (d) ``python -m repro_torch.launch.serve --backend sim --sim``
   over all eleven registered archs, one event each, as a subprocess: exit
   0 with every event served; each arch's roofline profile (ELat median,
   cold start) on the simulated 8-GPU H100 node, and for the archs served
   here the profile's ELat beside the first event's ELat measured on this
   card (2 prompts, 32 new tokens); the subprocess passes
   ``--max-new-tokens 16``.
8. The paper's multi-accelerator workflow, printed under ``phase 8`` after
   phase 7: (a) tiny-YOLOv2 at its published 416x416, float32, batch 1 and
   8 on the card against the port's CPU forward of the same weights within
   1e-4 x max|out|, with cuDNN's TF32 switched on around it (the forward
   must turn it off for itself); ms per image (CUDA events) beside the
   bound (the convolutions' FLOPs at 67 TFLOP/s, the weights, images and
   grids at 3.35 TB/s); (b) whisper-tiny as registered (4 + 4 layers, d
   384, 6 heads, hd 64, 1500 frames; bf16, QKV biases drawn non-zero):
   the encoder over (8, 1500, 384) frames, a 32-token prefill and 32
   greedy decode steps on the dense cache, launch counts zeroed just
   before and read just after (K2 and K3, no other kernel); encoder ms,
   TTFT and decode ms/step; bf16 logits against ``impl="ref"`` (phase 4's
   rule) and float32 greedy tokens through the kernels identical to
   ``impl="ref"``; (c) ``repro_torch.examples.workflow_pipeline`` without
   ``--reduced`` on ``--backend engine``: ``Gateway.submit_workflow`` ->
   ``EngineBackend`` -> tiny-YOLOv2 on 4 images, whisper-tiny and the
   granite-3-2b captioner (paged), twice: the first workflow cold-starts
   each runtime, the second is warm and gives the same step results; each
   step's ELat and cold start beside the paper's K600 / NCS medians (1675
   / 1577 ms, the paper's testbed); its launches (K2 and K1 decode, counted
   from the two workflows alone) are the ``..., via Workflow`` entries.

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
QW_H, QW_KV, QW_HD = 40, 8, 128   # qwen2.5-14b attention widths (G = 5)
DS_H, DS_KV, DS_HD = 32, 32, 128  # deepseek-7b (G = 1)
QW_KV_LEN = [1, 37, 128, 255, 512, 700, 999, 1024]
# whisper-tiny (G = 1, hd 64): the encoder over 1500 frames, 32-token
# prompts cross-attending to them, and decode over the cached frames
WH_H, WH_HD, WH_F, WH_B, WH_PROMPT = 6, 64, 1500, 8, 32


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


def kernel_ms(torch, fn, kernel_names, iters: int = 20, attempts: int = 3) -> float:
    """Device time per call of the CUDA kernels whose names contain one of
    ``kernel_names`` (a name, or a tuple of them for a kernel that runs as
    several launches, such as the split decode body and its merge), from
    the profiler (launch gaps excluded); each call of ``fn`` launches each
    named kernel at most once, and the first every time. The profiler now
    and then records only some, or none, of a session's launches of a
    kernel launched through ctypes, so each name's time is its recorded
    device time over its recorded launches, and the shortfall is logged. A
    session without the first name is repeated, and after ``attempts``
    such sessions the time is taken with CUDA events around back-to-back
    calls instead (launch gaps included)."""
    from torch.profiler import ProfilerActivity, profile
    names = (kernel_names,) if isinstance(kernel_names, str) else tuple(kernel_names)
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        keys = prof.key_averages()
        per_name = []
        for name in names:
            evs = [ev for ev in keys if name in ev.key]
            n = sum(ev.count for ev in evs)
            if n > iters:
                raise AssertionError(f"{n} {name} launches in {iters} calls: "
                                     "more than one per call")
            if 0 < n < iters:
                log(f"  the profiler recorded {n} of {iters} {name} launches")
            per_name.append((n, sum(ev.device_time_total for ev in evs) / 1e3))
        if per_name[0][0]:
            return sum(t / n for n, t in per_name if n)
        log(f"  the profiler recorded no {names[0]} launch "
            f"(session {attempt} of {attempts})")
    ms = event_ms(torch, fn, iters)
    log(f"  {names[0]}: timed with CUDA events instead, {ms:.4f} ms per call")
    return ms


def kernel_times(torch, fn, kernel_names, iters: int = 20):
    """A kernel row's two times per call: ``ms``, the profiler's device
    time of the kernel (``kernel_ms``; several launches summed), and
    ``event_ms``, CUDA events around ``iters`` back-to-back calls after a
    warm-up (launch gaps and the wrapper's host work included where they
    exceed the kernel)."""
    return dict(ms=kernel_ms(torch, fn, kernel_names, iters),
                event_ms=event_ms(torch, fn, iters))


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
        elif c == "N":                      # a nested name: N [S<n>_] (<len><name>)+ E
            i += 1 + len(re.match(r"N(S\d*_)?", args[i:]).group(1) or "")
            while args[i] != "E":
                n = re.match(r"\d+", args[i:]).group()
                name = args[i + len(n):i + len(n) + int(n)]
                i += len(n) + int(n)
            out.append(name)
            i += 1
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
    registers, spill bytes and static shared memory (the dynamic share a
    launch asks for is not in it)."""
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
            smem = re.search(r"(\d+) bytes smem", line)
            yield (f"{name}: {m.group(1)} registers, {spills} bytes spill stores, "
                   f"{smem.group(1) if smem else 0} bytes static smem")
            name = None


# the bf16 instances that must run on the tensor cores
MMA_KERNELS = ("flash_attention_mma_kernel", "paged_prefill_mma_kernel", "moe_gmm_mma_kernel",
               "split_decode_mma_kernel")
# the split-KV decode of K1 (C == 1) and K3 in bf16: the body and its merge
SPLIT_DECODE = ("split_decode_mma_kernel", "split_decode_merge_kernel")


def cuobjdump_path() -> str:
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    import importlib.util
    import shutil
    found = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        found.append(str(Path(spec.submodule_search_locations[0]) /
                         "backends" / "nvidia" / "bin" / "cuobjdump"))
    for path in found:
        if path and Path(path).is_file():
            return path
    raise RuntimeError(f"cuobjdump not found (looked at {found[1:]} and PATH): "
                       "phase 1 cannot check the tensor-core instructions")


def sass_mma_counts(cuobjdump: str, library: Path):
    """{kernel instance: (HMMA, HGMMA) instruction counts} in the SASS of a
    built library."""
    out = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            counts[name] = [0, 0]
        elif name:
            counts[name][0] += bool(re.search(r"\bHMMA\b", line))
            counts[name][1] += bool(re.search(r"\bHGMMA\b", line))
    return {k: tuple(v) for k, v in counts.items()}


def check_tensor_cores(build) -> None:
    """Log every kernel instance's HMMA / HGMMA count; raise unless every
    bf16 instance of K2, K1 chunk, K4 and the split decode body (K1 decode,
    K3) has some."""
    tool = cuobjdump_path()
    seen = {}
    for name in build.KERNELS:
        for kernel, (hmma, hgmma) in sass_mma_counts(tool, build.library_path(name)).items():
            log(f"  sass {kernel}: {hmma} HMMA, {hgmma} HGMMA")
            seen[kernel] = hmma + hgmma
    for want in MMA_KERNELS:
        found = {k: n for k, n in seen.items() if k.startswith(want)}
        if not found or not all(found.values()):
            raise AssertionError(f"{want}: no tensor-core instruction in "
                                 f"{found or 'no instance'}")


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


def n_split(torch, q, n_kv, capacity) -> str:
    """The split-KV decode body's plan for these shapes, for the row's label."""
    from repro_torch.kernels import decode_attention as da
    B, _, n_heads, _ = q.shape
    n = da.split_plan(B, n_kv, n_heads // n_kv, capacity, da.sm_count(q.device.index))
    return f"n_split={n}"


def paged_sdpa(torch, q, kp, vp, bt, kl):
    """K1 decode's yardstick: ``scaled_dot_product_attention`` with a length
    mask over the same keys, gathered from the pool into a contiguous
    (B, KV, P * page, hd) copy before timing (the gather is not timed).
    Returns the call to time."""
    from repro_torch.kernels import ref
    kt = ref.gather_pages(kp, bt).transpose(1, 2).contiguous()
    vt = ref.gather_pages(vp, bt).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2)
    lmask = (torch.arange(kt.shape[2], device=q.device)[None] < kl[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, attn_mask=lmask, enable_gqa=True)


def paged_chunk_sdpa(torch, q, kp, vp, bt, kl, qo):
    """K1 chunk's yardstick: ``scaled_dot_product_attention`` with the
    boolean mask ``kp < kv_len & kp <= q_offset + i`` over the same keys,
    gathered from the pool into a contiguous (B, KV, P * page, hd) copy
    before timing (the gather is not timed). Returns the call to time."""
    from repro_torch.kernels import ref
    kt = ref.gather_pages(kp, bt).transpose(1, 2).contiguous()
    vt = ref.gather_pages(vp, bt).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2)
    keys = torch.arange(kt.shape[2], device=q.device)
    qpos = qo[:, None] + torch.arange(q.shape[1], device=q.device)[None]
    mask = (keys[None, None] < kl[:, None, None]) & (keys[None, None] <= qpos[:, :, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)


def log_row(e) -> None:
    """Log a kernel row and add ``ms_over_library_ms``, the kernel's
    profiler time over the library call's (None where there is none)."""
    lib = e["library_ms"]
    e["ms_over_library_ms"] = e["ms"] / lib if lib else None
    vs = f"library {lib:.4f} ms, kernel/library {e['ms_over_library_ms']:.2f}x" if lib \
        else "library n/a"
    if e.get("library"):
        vs += f" ({e['library']})"
    log(f"  {e['name']:40s} {e['shape']}: kernel {e['ms']:.4f} ms (events "
        f"{e['event_ms']:.4f}), bound {e['bound_ms']:.4f} ms ({e['bound_by']}), plain "
        f"{e['plain_ms']:.4f} ms, {vs}")


def scan_plans(a, b):
    """K5's plan for these operands at each channel count."""
    from repro_torch.kernels import rglru_scan as rs
    return [rs.scan_plan(a.shape[-1], a.element_size(), a.data_ptr(), b.data_ptr(), ch=ch)
            for ch in rs.CH_CHOICES]


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
    errs["chunk_768"] = errs["chunk"]
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
        for q_off in (0, 256, 768):
            # the last chunk of a 1024-token prompt draws from a generator of
            # its own, so every other check keeps its inputs
            g = np.random.default_rng(768) if q_off == 768 else rng
            q, kp, vp, bt, kl = paged_inputs(torch, g, dev, dtype, [q_off + 256], 256)
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
        for key, (nh, nkv, hd) in (("dense_rg", (RG_H, RG_KV, RG_HD)),
                                   ("dense_granite", (H, KV, HD))):
            q, k, v, kl = decode_inputs(torch, rng, dev, dtype, nh, nkv, hd)
            k8, v8, ks, vs = int8_cache(torch, k, v)
            got = da.decode_attention(q, k8, v8, kl, k_scale=ks, v_scale=vs)
            want = ref.decode_attention(q.float(), k8, v8, kl, k_scale=ks,
                                        v_scale=vs).to(q.dtype)
            check(f"K3 decode int8 cache H={nh} KV={nkv} hd={hd}", dtype, got, want,
                  errs[key])
        # K1 decode at hd 256 (no served model pages it; the split body's
        # widest instance)
        q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, DECODE_KV_LEN, 1,
                                         (RG_H, RG_KV, RG_HD))
        got = pa.paged_decode_attention(q, kp, vp, bt, kl)
        want = ref.paged_decode_attention(*up(q, kp, vp), bt, kl).to(q.dtype)
        check(f"K1 decode hd=256 G=10 KV=1 kv_len={DECODE_KV_LEN}", dtype, got, want,
              errs["decode"])
        for S in (1024, 3000):
            for with_h0 in (False, True):
                a, b, h0 = scan_inputs(torch, rng, dev, dtype, S, with_h0)
                want = ref.rglru_scan(a, b, h0)
                check(f"K5 rglru_scan B=1 S={S} D={RG_D} h0={with_h0}", dtype,
                      rs.rglru_scan(a, b, h0), want, errs["scan"], tol=0.0)
                if S == 3000 and with_h0:
                    for plan in scan_plans(a, b):
                        check(f"K5 rglru_scan S={S} h0=True ch={plan.ch}", dtype,
                              rs.rglru_scan(a, b, h0, plan=plan), want, errs["scan"],
                              tol=0.0)
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
        **kernel_times(torch, lambda: fa.flash_attention(q, k, v),
                       "flash_attention_mma_kernel"),
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
        **kernel_times(torch, lambda: fa.flash_attention(q, k, v, window=RG_WINDOW),
                       "flash_attention_mma_kernel", iters=10),
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
        source="src/repro_torch/csrc/decode_common.cuh",
        replaces="src/repro/kernels/decode_attention.py:135",
        shape=f"B=8 kv_len={kv_len} page={PAGE} {n_split(torch, q, KV, bt.shape[1] * PAGE)} "
              "bf16",
        **kernel_times(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, kl),
                       SPLIT_DECODE),
        plain_ms=event_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, bt, kl), 10),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, paged_sdpa(torch, q, kp, vp, bt, kl), 20),
        library="SDPA, length mask, keys gathered to a contiguous copy before timing")
    # K1 chunk: the second and the last 256-token chunk of a 1024-token prompt
    for key, q_off in (("chunk", 256), ("chunk_768", 768)):
        C = 256
        q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, [q_off + C], C)
        qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
        pairs = sum(q_off + i + 1 for i in range(C)) * H
        b, by = bound_ms(isz * (2 * q.numel() + 2 * (q_off + C) * KV * HD)
                         + 4 * (bt.numel() + 2), 4 * HD * pairs, dtype)
        entries[key] = dict(
            name=f"paged_prefill_attention (q_offset {q_off})", route="cuda",
            source="src/repro_torch/csrc/prefill_common.cuh",
            replaces="src/repro/kernels/decode_attention.py:135",
            shape=f"B=1 C={C} q_offset={q_off} H={H} KV={KV} hd={HD} page={PAGE} bf16",
            **kernel_times(torch, lambda: pa.paged_prefill_attention(q, kp, vp, bt, kl, qo),
                           "paged_prefill_mma_kernel"),
            plain_ms=event_ms(torch, lambda: ref.paged_prefill_attention(q, kp, vp, bt, kl,
                                                                         qo), 10),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, paged_chunk_sdpa(torch, q, kp, vp, bt, kl, qo), 20),
            library="SDPA, length and causal-offset mask, keys gathered to a contiguous "
                    "copy before timing")
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
            source="src/repro_torch/csrc/decode_common.cuh",
            replaces="src/repro/kernels/decode_attention.py:31",
            shape=f"{what}: B=8 S=2048 H={nh} KV={nkv} hd={hd} kv_len 1..2048 "
                  f"({n_kv} keys) {n_split(torch, q, nkv, k.shape[1])} bf16",
            **kernel_times(torch, lambda: da.decode_attention(q, k, v, kl),
                           SPLIT_DECODE),
            plain_ms=event_ms(torch, lambda: ref.decode_attention(q, k, v, kl), 10),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=lmask,
                                                     enable_gqa=True), 20))
    # K5: a 3000-token recurrentgemma prefill's scan, float32 a and b; each
    # channel count of the plan, then the default
    S = 3000
    a, bb, _ = scan_inputs(torch, rng, dev, "float32", S, False)
    n_bytes = 4 * 3 * S * RG_D
    b, by = bound_ms(n_bytes, 2 * S * RG_D, "float32")
    for plan in scan_plans(a, bb):
        ms = kernel_ms(torch, lambda: rs.rglru_scan(a, bb, plan=plan), "rglru_scan_kernel")
        log(f"  K5 plan ch={plan.ch:2d} ({-(-RG_D // plan.ch)} blocks, 8 ring stages of 32 "
            f"steps): {ms:.4f} ms, {n_bytes / ms / 1e6:.1f} GB/s")
    plan = rs.scan_plan(RG_D, 4, a.data_ptr(), bb.data_ptr())
    entries["scan"] = dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:26",
        shape=f"B=1 S={S} D={RG_D} float32, ch={plan.ch} vec={plan.vec}",
        **kernel_times(torch, lambda: rs.rglru_scan(a, bb), "rglru_scan_kernel"),
        plain_ms=event_ms(torch, lambda: ref.rglru_scan(a, bb), 2, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None)
    log(f"  K5 chosen plan {tuple(plan)}: {entries['scan']['ms']:.4f} ms, "
        f"{n_bytes / entries['scan']['ms'] / 1e6:.1f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f}")
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
        log_row(e)
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
        k8, v8, ks, vs = int8_cache(torch, k, v)
        got = da.decode_attention(q, k8, v8, kl, k_scale=ks, v_scale=vs)
        want = ref.decode_attention(q.float(), k8, v8, kl, k_scale=ks,
                                    v_scale=vs).to(q.dtype)
        check("K3 ring int8 cache hd=128 G=5", dtype, got, want, errs["dense_l4"])
        del k8, v8
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
        **kernel_times(torch, lambda: fa.flash_attention(q, k, v), "flash_attention_mma_kernel",
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
        source="src/repro_torch/csrc/decode_common.cuh",
        replaces="src/repro/kernels/decode_attention.py:135",
        shape=f"B=8 kv_len={L4_KV_LEN} H={L4_H} KV={L4_KV} hd={L4_HD} page={PAGE} "
              f"{n_split(torch, q, L4_KV, bt.shape[1] * PAGE)} bf16",
        **kernel_times(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, kl),
                       SPLIT_DECODE),
        plain_ms=event_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, bt, kl), 10),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, paged_sdpa(torch, q, kp, vp, bt, kl), 20),
        library="SDPA, length mask, keys gathered to a contiguous copy before timing")
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
        source="src/repro_torch/csrc/decode_common.cuh",
        replaces="src/repro/kernels/decode_attention.py:31",
        shape=f"B=8 L={L4_CHUNK} H={L4_H} KV={L4_KV} hd={L4_HD} kv_len {L4_RING_LEN} "
              f"({n_kv} keys) {n_split(torch, q, L4_KV, L4_CHUNK)} bf16",
        **kernel_times(torch, lambda: da.decode_attention(q, k, v, kl),
                       SPLIT_DECODE),
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
            **kernel_times(torch, lambda: gm.moe_gmm(x, w, gs), "moe_gmm_mma_kernel",
                           iters=3 if big else 20),
            plain_ms=event_ms(torch, lambda: ref.moe_gmm(x, w, gs), 2, warmup=1),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, lib, 10) if lib else None)
        del x, w, gs, lib
        torch.cuda.empty_cache()
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
        log_row(e)
    log(f"  K4 edge cases: max|err| {max(errs['gmm_edge']):.3e}")
    return entries


def phase_kernels_catalogue(torch, dev):
    """Phase 2 at the dense catalogue's widths (phase 7's served archs):
    qwen2.5-14b (H=40 KV=8, G = 5, hd 128) through K2, K1 decode, K1's
    256-token chunks and K3 on the dense layout; deepseek-7b (H=32 KV=32,
    G = 1, hd 128) through K2 and K1 decode."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(11)
    up = lambda *ts: [t.float() for t in ts]  # noqa: E731
    heads = {"qwen": (QW_H, QW_KV, QW_HD), "ds": (DS_H, DS_KV, DS_HD)}
    keys = ("flash_qwen", "flash_ds", "decode_qwen", "decode_ds", "chunk_qwen",
            "chunk_qwen_768", "dense_qwen")
    errs = {k: [] for k in keys}
    log(f"phase 2: the dense catalogue's widths (qwen2.5-14b H={QW_H} KV={QW_KV} "
        f"hd={QW_HD}, G=5; deepseek-7b H={DS_H} KV={DS_KV} hd={DS_HD}, G=1)")
    for dtype in ("bfloat16", "float32"):
        t = lambda shape: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape).astype(np.float32)).to(dev, getattr(torch, dtype))
        for arch, (nh, nkv, hd) in heads.items():
            q, k, v = t((1, 1024, nh, hd)), t((1, 1024, nkv, hd)), t((1, 1024, nkv, hd))
            check(f"K2 flash {arch} S=1024 H={nh} KV={nkv} hd={hd} causal", dtype,
                  fa.flash_attention(q, k, v),
                  ref.flash_attention(*up(q, k, v)).to(q.dtype), errs[f"flash_{arch}"])
            q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, QW_KV_LEN, 1,
                                             (nh, nkv, hd))
            check(f"K1 decode {arch} H={nh} KV={nkv} hd={hd} kv_len={QW_KV_LEN}", dtype,
                  pa.paged_decode_attention(q, kp, vp, bt, kl),
                  ref.paged_decode_attention(*up(q, kp, vp), bt, kl).to(q.dtype),
                  errs[f"decode_{arch}"])
        for key, q_off in (("chunk_qwen", 256), ("chunk_qwen_768", 768)):
            q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, [q_off + 256], 256,
                                             heads["qwen"])
            qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
            check(f"K1 chunk qwen C=256 q_offset={q_off}", dtype,
                  pa.paged_prefill_attention(q, kp, vp, bt, kl, qo),
                  ref.paged_prefill_attention(*up(q, kp, vp), bt, kl, qo).to(q.dtype),
                  errs[key])
        q, k, v, kl = decode_inputs(torch, rng, dev, dtype, *heads["qwen"])
        check(f"K3 decode qwen dense B=8 S=2048 H={QW_H} KV={QW_KV} hd={QW_HD} "
              "kv_len 1..2048", dtype, da.decode_attention(q, k, v, kl),
              ref.decode_attention(*up(q, k, v), kl).to(q.dtype), errs["dense_qwen"])
        del q, k, v, kp, vp
    torch.cuda.synchronize()

    log("phase 2: times at the dense catalogue's shapes, bf16 (kernel: profiler "
        "device time; plain and library: CUDA events per call)")
    entries = {}
    dtype, isz = "bfloat16", 2
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    names = {"qwen": "qwen2.5-14b", "ds": "deepseek-7b"}
    for arch, (nh, nkv, hd) in heads.items():
        # K2: a 1024-token prompt, causal
        S = 1024
        q, k, v = t((1, S, nh, hd)), t((1, S, nkv, hd)), t((1, S, nkv, hd))
        b, by = bound_ms(isz * (2 * q.numel() + k.numel() + v.numel()),
                         4 * hd * S * (S + 1) // 2 * nh, dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        entries[f"flash_{arch}"] = dict(
            name=f"flash_attention (hd {hd}, {names[arch]})", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:27",
            shape=f"B=1 S={S} H={nh} KV={nkv} hd={hd} causal bf16",
            **kernel_times(torch, lambda: fa.flash_attention(q, k, v),
                           "flash_attention_mma_kernel"),
            plain_ms=event_ms(torch, lambda: ref.flash_attention(q, k, v), 3),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                                     enable_gqa=True), 20))
        # K1 decode: 8 sequences, kv_len spread over 1..1024
        q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, QW_KV_LEN, 1, (nh, nkv, hd))
        n_kv = sum(QW_KV_LEN)
        b, by = bound_ms(isz * (2 * q.numel() + 2 * n_kv * nkv * hd) + 4 * (bt.numel() + 8),
                         4 * hd * nh * n_kv, dtype)
        entries[f"decode_{arch}"] = dict(
            name=f"paged_decode_attention (hd {hd}, G={nh // nkv}, {names[arch]})",
            route="cuda", source="src/repro_torch/csrc/decode_common.cuh",
            replaces="src/repro/kernels/decode_attention.py:135",
            shape=f"B=8 kv_len={QW_KV_LEN} H={nh} KV={nkv} hd={hd} page={PAGE} "
                  f"{n_split(torch, q, nkv, bt.shape[1] * PAGE)} bf16",
            **kernel_times(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, kl),
                           SPLIT_DECODE),
            plain_ms=event_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, bt, kl),
                              10),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, paged_sdpa(torch, q, kp, vp, bt, kl), 20),
            library="SDPA, length mask, keys gathered to a contiguous copy before timing")
    # K1 chunk: the second and the last 256-token chunk of a 1024-token prompt
    for key, q_off in (("chunk_qwen", 256), ("chunk_qwen_768", 768)):
        C = 256
        q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, [q_off + C], C, heads["qwen"])
        qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
        pairs = sum(q_off + i + 1 for i in range(C)) * QW_H
        b, by = bound_ms(isz * (2 * q.numel() + 2 * (q_off + C) * QW_KV * QW_HD)
                         + 4 * (bt.numel() + 2), 4 * QW_HD * pairs, dtype)
        entries[key] = dict(
            name=f"paged_prefill_attention (hd 128, q_offset {q_off}, qwen2.5-14b)",
            route="cuda", source="src/repro_torch/csrc/prefill_common.cuh",
            replaces="src/repro/kernels/decode_attention.py:135",
            shape=f"B=1 C={C} q_offset={q_off} H={QW_H} KV={QW_KV} hd={QW_HD} page={PAGE} "
                  "bf16",
            **kernel_times(torch, lambda: pa.paged_prefill_attention(q, kp, vp, bt, kl, qo),
                           "paged_prefill_mma_kernel"),
            plain_ms=event_ms(torch, lambda: ref.paged_prefill_attention(q, kp, vp, bt, kl,
                                                                         qo), 10),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, paged_chunk_sdpa(torch, q, kp, vp, bt, kl, qo), 20),
            library="SDPA, length and causal-offset mask, keys gathered to a contiguous "
                    "copy before timing")
    # K3 on the dense per-slot layout, kv_len 1..2048
    q, k, v, kl = decode_inputs(torch, rng, dev, dtype, *heads["qwen"])
    n_kv = sum(DECODE_KV_LEN)
    b, by = bound_ms(isz * (2 * q.numel() + 2 * n_kv * QW_KV * QW_HD) + 4 * kl.numel(),
                     4 * QW_HD * QW_H * n_kv, dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lmask = (torch.arange(k.shape[1], device=dev)[None] < kl[:, None])[:, None, None]
    entries["dense_qwen"] = dict(
        name="decode_attention (qwen2.5-14b dense, hd 128)", route="cuda",
        source="src/repro_torch/csrc/decode_common.cuh",
        replaces="src/repro/kernels/decode_attention.py:31",
        shape=f"B=8 S=2048 H={QW_H} KV={QW_KV} hd={QW_HD} kv_len 1..2048 ({n_kv} keys) "
              f"{n_split(torch, q, QW_KV, k.shape[1])} bf16",
        **kernel_times(torch, lambda: da.decode_attention(q, k, v, kl), SPLIT_DECODE),
        plain_ms=event_ms(torch, lambda: ref.decode_attention(q, k, v, kl), 10),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=lmask,
                                                 enable_gqa=True), 20),
        library="SDPA, length mask")
    del q, k, v, kp, vp, qt, kt, vt, lmask
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
        log_row(e)
    return entries


def phase_kernels_whisper(torch, dev):
    """Phase 2 at whisper-tiny's widths (H = KV = 6, G = 1, hd 64; phase 8
    (b)'s shapes): K2 over the encoder's 1500 frames without a mask (Skv
    off the 64-key tile), K2 for the cross prefill (32 prompt rows against
    the 1500 frames, no mask) and K3 for the cross decode (every row's
    kv_len the full 1500)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(21)
    up = lambda *ts: [t.float() for t in ts]  # noqa: E731
    B, F_, nh, hd = WH_B, WH_F, WH_H, WH_HD
    errs = {k: [] for k in ("flash_enc", "flash_cross", "dense_cross")}
    kv_len = [F_] * B
    log(f"phase 2: whisper-tiny's widths (H=KV={nh}, G=1, hd={hd}; {F_} frames, "
        f"{WH_PROMPT}-token prompts, B={B})")
    for dtype in ("bfloat16", "float32"):
        t = lambda shape: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape).astype(np.float32)).to(dev, getattr(torch, dtype))
        for key, sq in (("flash_enc", F_), ("flash_cross", WH_PROMPT)):
            q, k, v = t((B, sq, nh, hd)), t((B, F_, nh, hd)), t((B, F_, nh, hd))
            check(f"K2 flash whisper B={B} sq={sq} skv={F_} H=KV={nh} no mask", dtype,
                  fa.flash_attention(q, k, v, causal=False),
                  ref.flash_attention(*up(q, k, v), causal=False).to(q.dtype), errs[key])
        q, k, v, kl = decode_inputs(torch, rng, dev, dtype, nh, nh, hd, S=F_, kv_len=kv_len)
        check(f"K3 decode whisper cross B={B} L={F_} H=KV={nh} kv_len={F_}", dtype,
              da.decode_attention(q, k, v, kl),
              ref.decode_attention(*up(q, k, v), kl).to(q.dtype), errs["dense_cross"])
    torch.cuda.synchronize()

    log("phase 2: times at whisper-tiny's shapes, bf16 (kernel: profiler device time; "
        "plain and library: CUDA events per call)")
    entries = {}
    dtype, isz = "bfloat16", 2
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, sq, what in (("flash_enc", F_, "encoder"),
                          ("flash_cross", WH_PROMPT, "cross prefill")):
        q, k, v = t((B, sq, nh, hd)), t((B, F_, nh, hd)), t((B, F_, nh, hd))
        b, by = bound_ms(isz * (2 * q.numel() + k.numel() + v.numel()),
                         4 * hd * nh * B * sq * F_, dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        entries[key] = dict(
            name=f"flash_attention (hd 64 G=1, whisper-tiny {what})", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:27",
            shape=f"B={B} Sq={sq} Skv={F_} H=KV={nh} hd={hd} no mask bf16",
            **kernel_times(torch, lambda: fa.flash_attention(q, k, v, causal=False),
                           "flash_attention_mma_kernel"),
            plain_ms=event_ms(torch, lambda: ref.flash_attention(q, k, v, causal=False), 3),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt), 20), library="SDPA")
    q, k, v, kl = decode_inputs(torch, rng, dev, dtype, nh, nh, hd, S=F_, kv_len=kv_len)
    b, by = bound_ms(isz * (2 * q.numel() + k.numel() + v.numel()) + 4 * kl.numel(),
                     4 * hd * nh * B * F_, dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    entries["dense_cross"] = dict(
        name="decode_attention (whisper-tiny cross decode, hd 64 G=1)", route="cuda",
        source="src/repro_torch/csrc/decode_common.cuh",
        replaces="src/repro/kernels/decode_attention.py:31",
        shape=f"B={B} L={F_} H=KV={nh} hd={hd} kv_len {F_} every row "
              f"{n_split(torch, q, nh, F_)} bf16",
        **kernel_times(torch, lambda: da.decode_attention(q, k, v, kl), SPLIT_DECODE),
        plain_ms=event_ms(torch, lambda: ref.decode_attention(q, k, v, kl), 10),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt), 20),
        library="SDPA (no mask: every key valid)")
    del q, k, v, qt, kt, vt
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
        log_row(e)
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
    ``need`` must have launched and none of ``absent``. Returns the
    engine, the counts and the first event's ELat (host clock; its result
    is read on the host) with its prompt lengths."""
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
    first = dict(elat_s=time.perf_counter() - t0, prompt_lens=prompt_lens[:2])
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
    return engine, counts, first


def partition_error(spans, root) -> float:
    """|sum of the root's tiling children - RLat| / RLat (an abandoned
    ``attempt`` overlaps the tiling and is left out)."""
    rlat = root.t_end - root.t_start
    tiled = sum(s.duration for s in spans if s.parent_id == root.span_id
                and s.t_end is not None and s.name != "attempt")
    return 0.0 if rlat == 0 else abs(tiled - rlat) / rlat


def gateway_run(torch, cfg):
    """Phase 3 through the serverless front door: ``Gateway.invoke`` ->
    ``EngineBackend`` (one worker thread on the card) -> the serve
    runtime, the tracer on. Wave 1 maps the 8 one-prompt events
    (``GRANITE_PROMPTS``) at once, so the worker forms micro-batches; wave
    2 invokes them one at a time, each waited. Every future's
    ``result()`` is read, so a kernel that fails on the card fails the
    run. Launch counts are zeroed before the waves and read after. Then
    each wave-2 event runs once more through ``run_batch`` on this thread
    with the same warm engine: a token that differs is a device, stream
    or thread fault of the port. Returns the launch counts, wave 2's mean
    host cost per event (RLat - ELat, ms) and wave 1's ELat p50 (ms;
    micro-batches of 4 in one process), phase 6's yardsticks."""
    import statistics
    from repro_torch import obs
    from repro_torch.core.runtime import run_batch
    from repro_torch.gateway import EngineBackend, Gateway
    from repro_torch.serve.api import make_serve_runtime

    eb = EngineBackend(max_batch=4, batch_wait_s=0.05, max_warm=1)
    gw = Gateway(eb)
    obs.reset()
    obs.enable(clock=eb.now, metrics=gw.metrics)
    try:
        rdef = make_serve_runtime(cfg, page_size=PAGE, max_slots=8, max_len=2048,
                                  max_batch=4, seed=0)
        rid = gw.register(rdef)
        rng = np.random.default_rng(7)
        events = [{"prompts": [rng.integers(3, cfg.vocab, size=n).tolist()]}
                  for n in GRANITE_PROMPTS]
        config = {"max_new_tokens": MAX_NEW}
        zero_launches()
        t0 = time.perf_counter()
        wave1 = gw.map(rid, events, config=config)
        out1 = [f.result(extra_time_s=600.0) for f in wave1]
        wall1 = time.perf_counter() - t0
        n_batches1 = eb.n_batches
        t0 = time.perf_counter()
        wave2, out2 = [], []
        for ev in events:
            wave2.append(gw.invoke(rid, ev, config=config))
            out2.append(wave2[-1].result(extra_time_s=600.0))
        wall2 = time.perf_counter() - t0
        counts = launches()
        spans = obs.TRACER.spans()
        doc = json.loads(json.dumps(obs.to_trace_events(spans)))
        engine = eb.handle(wave2[0].invocation.runtime_key)
        # the same event through run_batch on this thread, same warm engine
        direct = [run_batch(rdef, [ev], dict(config, handle=engine))[0]["outputs"]
                  for ev in events]
    finally:
        eb.shutdown()
        obs.reset()

    futs = wave1 + wave2
    outs = [o for r in out1 + out2 for o in r["outputs"]]
    if len(outs) != 2 * len(events) or not all(1 <= len(o) <= MAX_NEW for o in outs):
        raise AssertionError(f"gateway: not every request finished: {[len(o) for o in outs]}")
    if (eb.n_cold_starts, min(eb.n_warm_starts, 1)) != (1, 1):
        raise AssertionError(f"gateway: cold {eb.n_cold_starts}, warm {eb.n_warm_starts}")
    if max(eb.batch_sizes[:n_batches1]) < 2:
        raise AssertionError(f"gateway: wave 1 formed no micro-batch: {eb.batch_sizes}")
    accs = {f.invocation.accelerator for f in futs}
    if accs != {"local/w0(host-cuda)"}:
        raise AssertionError(f"gateway: accelerators {accs}")
    if not (counts["flash"] and counts["decode"]) or \
            counts["chunk"] or counts["dense"] or counts["scan"] or counts["gmm"]:
        raise AssertionError(f"gateway: launches {counts}: need K2 and K1 decode only")
    engine.allocator.check_invariants()
    if engine.allocator.n_free != engine.num_pages - 1 or \
            engine.free_slots() != list(range(engine.max_slots)):
        raise AssertionError(f"gateway: leaked pages or slots: {engine.stats()}")
    problems = obs.validate_trace(doc)
    if problems:
        raise AssertionError(f"gateway: the exported trace is invalid: {problems[:5]}")
    # the backend's child spans are cut from each invocation's own stamps
    # into one chain from r_start to r_end, so this holds by construction:
    # it guards the span tree's shape, it measures nothing
    roots = [sp for sp in spans if sp.name == "invocation"]
    errs = [partition_error(spans, r) for r in roots]
    if len(roots) != len(futs) or max(errs) > 0.10:
        raise AssertionError(f"gateway: {len(roots)} roots for {len(futs)} events, "
                             f"partition errors {errs}")
    # a batch's engine spans nest under its lead invocation's execute span
    kids = collections.defaultdict(set)
    for sp in spans:
        kids[sp.parent_id].add(sp.name)
    leads = [sp for sp in spans if sp.name == "execute" and kids[sp.span_id]]
    if len(leads) != eb.n_batches or \
            any(not {"prefill", "decode"} <= kids[sp.span_id] for sp in leads):
        raise AssertionError(f"gateway: {len(leads)} execute spans with engine spans for "
                             f"{eb.n_batches} batches: {[kids[sp.span_id] for sp in leads]}")
    for i, (r, want) in enumerate(zip(out2, direct)):
        if r["outputs"] != want:
            raise AssertionError(
                f"gateway: wave-2 event {i} (prompt {GRANITE_PROMPTS[i]} tokens) through the "
                f"worker thread gave {r['outputs']}, run_batch on the main thread {want} "
                f"(same engine; kernels K2 flash_attention_mma_kernel, K1 decode "
                f"split_decode_mma_kernel)")

    m = gw.metrics
    rl, el = sorted(m.rlats()), sorted(m.elats())
    cold = [sp.duration for sp in spans if sp.name == "cold_start"]
    by_name = collections.defaultdict(list)
    for sp in spans:
        if sp.t_end is not None:
            by_name[sp.name].append(sp.duration)
    n1 = sum(len(o) for r in out1 for o in r["outputs"])
    n2 = sum(len(o) for r in out2 for o in r["outputs"])
    log(f"  gateway: {len(futs)} events, all succeeded; cold {eb.n_cold_starts} warm "
        f"{eb.n_warm_starts}; batch sizes {eb.batch_sizes} (wave 1: "
        f"{eb.batch_sizes[:n_batches1]}); RLat p50 {statistics.median(rl) * 1e3:.1f} ms "
        f"max {rl[-1] * 1e3:.1f} ms; ELat p50 {statistics.median(el) * 1e3:.1f} ms max "
        f"{el[-1] * 1e3:.1f} ms; cold_start span {cold[0]:.4f} s (on each of the cold "
        f"batch's {len(cold)} events)")
    log(f"  gateway: wave 1 (map of 8) {n1} tokens in {wall1:.3f} s = {n1 / wall1:.1f} "
        f"tokens/s; wave 2 (8 invoked one at a time) {n2} tokens in {wall2:.3f} s = "
        f"{n2 / wall2:.1f} tokens/s; launches {counts}; partition error max "
        f"{max(errs):.4f}; trace {len(doc['traceEvents'])} events, valid; wave-2 tokens "
        "equal run_batch on the main thread")
    for name, wave in (("wave 1", wave1), ("wave 2", wave2)):
        invs = [f.invocation for f in wave]
        rl = sorted(i.rlat for i in invs)
        el = sorted(i.elat for i in invs)
        # the gateway's own host cost per event, RLat - ELat, in its measured
        # parts: queue (submit to a worker's claim, the batch window
        # included), dispatch (claim to execution: the cold start, reading
        # the input) and settle (execution's end to r_end: persisting the
        # result, settling under the lock)
        host = [i.rlat - i.elat for i in invs]
        queue = [i.n_start - i.r_start for i in invs]
        warm = [i.e_start - i.n_start for i in invs if not i.cold_start]
        settle = [i.r_end - i.e_end for i in invs]
        log(f"  gateway {name}: RLat p50 {statistics.median(rl) * 1e3:.1f} ms max "
            f"{rl[-1] * 1e3:.1f} ms; ELat p50 {statistics.median(el) * 1e3:.1f} ms max "
            f"{el[-1] * 1e3:.1f} ms; ELat / RLat per event, mean "
            f"{statistics.mean(i.elat / i.rlat for i in invs):.4f}; RLat - ELat per "
            f"event mean {statistics.mean(host) * 1e3:.3f} ms max {max(host) * 1e3:.3f} "
            f"ms = queue mean {statistics.mean(queue) * 1e3:.3f} ms + dispatch "
            f"(warm, {len(warm)} events) mean "
            f"{(statistics.mean(warm) if warm else 0.0) * 1e3:.3f} ms + settle mean "
            f"{statistics.mean(settle) * 1e3:.3f} ms max {max(settle) * 1e3:.3f} ms")
    log("  gateway spans (count, mean ms; batch_wait is the configured window cut to "
        "the queue wait and store_put is empty by construction, neither is timed): " +
        ", ".join(f"{n} {len(d)} x {statistics.mean(d) * 1e3:.2f}"
                  for n, d in sorted(by_name.items())))
    return counts, {
        "host_ms": statistics.mean(f.invocation.rlat - f.invocation.elat for f in wave2) * 1e3,
        "elat_ms": statistics.median(f.invocation.elat for f in wave1) * 1e3}


# ----------------------------------------------------------------------
# phase 5: the control plane and the simulated cluster on the card
# ----------------------------------------------------------------------
CP_NEW = 16                        # new tokens per phase-5 prompt
CP_EVICT_SLACK = 64 << 20          # memory_allocated() after a TTL eviction


def _wait_for(pred, timeout_s: float, what: str) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"phase 5: timed out after {timeout_s} s waiting for {what}")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _cp_runtime(cfg, **kw):
    from repro_torch.serve.api import make_serve_runtime
    return make_serve_runtime(cfg, page_size=PAGE, max_slots=4, max_len=1024, max_batch=4,
                              seed=0, **kw)


def _cp_backend(rdef):
    from repro_torch.gateway import EngineBackend, Gateway
    eb = EngineBackend(max_batch=4, batch_wait_s=0.01)
    gw = Gateway(eb)
    return eb, gw, gw.register(rdef)


def _cp_close(eb, plane=None) -> None:
    """Detach the plane, stop the workers and drop every warm engine, so
    the next scenario starts from the card's memory before its setup."""
    if plane is not None:
        plane.detach()
    eb.shutdown()
    for key in eb.warm_keys():
        eb.evict_warm(key)


def control_plane_run(torch, cfg):
    """Phase 5: granite-3-2b (as registered) behind Hardless's control
    plane over ``EngineBackend``, then on ``SimBackend`` running the model
    for real inside virtual time. Scenarios: (a) a min-warm floor prewarms
    the engine off the critical path (first invoke prewarmed, not cold;
    its RLat beside a fresh backend's cold first invoke), (b) a 0.5 s
    keep-alive TTL evicts the idle engine and ``memory_allocated()`` comes
    back within 64 MiB of its value before setup (the next invoke is cold
    and gives the same tokens), (c) a tenant quota sheds the free tenant's
    excess as ``InvocationRejected`` while the other tenant's 6 are served,
    (d) the SLO scaler scales the workers out under a burst of 16 (two run
    configs, so two engines serve at once; the workers share the card),
    (e) one simulated node whose accelerator is this card (2 slots) runs 8
    events through the serve runtime's real ``fn``, each event's tokens
    equal to ``run_batch`` of it on this thread. Launch counts are zeroed
    before (a) and read after (d), then zeroed just before (e)'s simulated
    run and read just after it, before its comparison runs; each path must
    launch K2 and K1 decode and no other kernel. Returns the two counts
    (via ControlPlane, via SimBackend)."""
    import statistics
    from repro_torch.controlplane import (AdmissionPolicy, ControlPlane, ControlPlaneConfig,
                                          SLOPolicy, WarmPolicy)
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.runtime import SimProfile, run_batch
    from repro_torch.launch.serve import accelerator_spec
    from repro_torch.gateway import Gateway, InvocationRejected, SimBackend

    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(48, 256, size=32)]
    run = {"max_new_tokens": CP_NEW}
    rdef = _cp_runtime(cfg)
    zero_launches()

    # (a) prewarm: a fresh backend's first invoke pays the cold start;
    # behind a min-warm floor it finds the engine already resident
    eb, gw, rid = _cp_backend(rdef)
    fresh = gw.invoke(rid, {"prompts": [prompts[0]]}, config=run)
    fresh_out = fresh.result(extra_time_s=600.0)
    _cp_close(eb)
    eb, gw, rid = _cp_backend(rdef)
    plane = ControlPlane(ControlPlaneConfig(
        tick_interval_s=0.05,
        warm=WarmPolicy(min_warm={rid: 1}, prewarm_config={rid: run}))).attach(eb)
    plane.start()
    t_prewarm = _wait_for(lambda: eb.n_prewarms == 1, 300.0, "the min-warm prewarm")
    warm = gw.invoke(rid, {"prompts": [prompts[0]]}, config=run)
    warm_out = warm.result(extra_time_s=600.0)
    _cp_close(eb, plane)
    inv_f, inv_w = fresh.invocation, warm.invocation
    if not inv_f.cold_start or inv_w.cold_start or not inv_w.prewarmed:
        raise AssertionError(f"phase 5 (a): fresh cold={inv_f.cold_start}, behind the floor "
                             f"cold={inv_w.cold_start} prewarmed={inv_w.prewarmed}")
    if warm_out["outputs"] != fresh_out["outputs"]:
        raise AssertionError("phase 5 (a): the prewarmed engine's tokens differ from the fresh one's")
    log(f"  (a) prewarm: first invoke on a fresh backend RLat {inv_f.rlat * 1e3:.1f} ms (cold, "
        f"ELat {inv_f.elat * 1e3:.1f} ms, dispatch {(inv_f.e_start - inv_f.n_start) * 1e3:.1f} "
        f"ms); behind min_warm 1 (prewarmed {t_prewarm:.3f} s after the plane started) RLat "
        f"{inv_w.rlat * 1e3:.1f} ms (prewarmed, not cold, ELat {inv_w.elat * 1e3:.1f} ms, "
        f"dispatch {(inv_w.e_start - inv_w.n_start) * 1e3:.1f} ms); plane "
        f"{plane.summary()}")

    # (b) keep-alive: the idle engine is evicted after its TTL and its
    # memory comes back
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    eb, gw, rid = _cp_backend(rdef)
    plane = ControlPlane(ControlPlaneConfig(
        tick_interval_s=0.05,
        warm=WarmPolicy(keep_alive_s={rid: 0.5}))).attach(eb)
    first = gw.invoke(rid, {"prompts": [prompts[1]]}, config=run)
    first_out = first.result(extra_time_s=600.0)
    torch.cuda.synchronize()
    mem_warm = torch.cuda.memory_allocated()
    plane.start()
    t_evict = _wait_for(lambda: any(a[1] == "ttl-evict" for a in plane.warmpool.actions),
                        60.0, "the keep-alive eviction")
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    plane.detach()
    again = gw.invoke(rid, {"prompts": [prompts[1]]}, config=run)
    again_out = again.result(extra_time_s=600.0)
    log(f"  (b) keep-alive 0.5 s: memory_allocated before setup {mem_before / 2**20:.1f} MiB, "
        f"warm {mem_warm / 2**20:.1f} MiB, {t_evict:.3f} s after the plane started (ttl-evict) "
        f"{mem_after / 2**20:.1f} MiB: freed {(mem_warm - mem_after) / 2**20:.1f} MiB of "
        f"{(mem_warm - mem_before) / 2**20:.1f}; next invoke cold={again.invocation.cold_start} "
        f"RLat {again.invocation.rlat * 1e3:.1f} ms; actions {plane.warmpool.actions}")
    if not first.invocation.cold_start or mem_warm - mem_before < CP_EVICT_SLACK:
        raise AssertionError(f"phase 5 (b): the first invoke was not a cold start holding memory "
                             f"({mem_before} -> {mem_warm} bytes)")
    if abs(mem_after - mem_before) > CP_EVICT_SLACK:
        raise AssertionError(f"phase 5 (b): after the TTL eviction memory_allocated() is "
                             f"{mem_after} bytes, {mem_before} before setup (slack {CP_EVICT_SLACK})")
    if not again.invocation.cold_start or again_out["outputs"] != first_out["outputs"]:
        raise AssertionError(f"phase 5 (b): after the eviction cold={again.invocation.cold_start}, "
                             f"tokens equal={again_out['outputs'] == first_out['outputs']}")

    # (c) tenant quota on the same backend and its warm engine: free is
    # capped at 1 event/s with a burst of 1, paid is unlimited
    plane = ControlPlane(ControlPlaneConfig(
        tick_interval_s=0.05,
        admission=AdmissionPolicy(tenant_quotas={"free": (1.0, 1.0)}))).attach(eb)
    plane.start()
    futs = {t: [gw.invoke(rid, {"prompts": [p]}, config=run, tenant=t) for p in prompts[2:8]]
            for t in ("free", "paid")}
    outcome = {t: [] for t in futs}
    for t, fs in futs.items():
        for f in fs:
            try:
                f.result(extra_time_s=600.0)
                outcome[t].append("served")
            except InvocationRejected:
                outcome[t].append("shed")
    plane.detach()
    n_shed = outcome["free"].count("shed")
    log(f"  (c) tenant quota free=1:1: free {outcome['free'].count('served')} served, {n_shed} "
        f"shed; paid {outcome['paid'].count('served')} served, {outcome['paid'].count('shed')} "
        f"shed; sheds by reason {plane.admission.shed_counts}; backend rejected "
        f"{eb.n_rejected}")
    if outcome["paid"] != ["served"] * 6 or n_shed < 1 or \
            outcome["free"][0] != "served" or n_shed != eb.n_rejected:
        raise AssertionError(f"phase 5 (c): outcomes {outcome}, rejected {eb.n_rejected}")

    # (d) SLO scale-out: a burst of 16 events in two run configs (two warm
    # identities, two engines) against one worker
    plane = ControlPlane(ControlPlaneConfig(
        tick_interval_s=0.05,
        slo=SLOPolicy(slo_rlat_p99_s=1.0, target_concurrency=4.0, max_units=4,
                      scale_down_cooldown=10 ** 6))).attach(eb)
    plane.start()
    t0 = time.perf_counter()
    burst = [gw.invoke(rid, {"prompts": [prompts[8 + i]]},
                       config=dict(run, max_new_tokens=CP_NEW - i % 2))
             for i in range(16)]
    outs = [f.result(extra_time_s=600.0) for f in burst]
    wall = time.perf_counter() - t0
    plane.stop()
    decisions = list(plane.scaler.decisions)
    caps = [(round(s.t, 2), s.capacity, s.outstanding) for s in plane.telemetry.history]
    nodes = collections.Counter(f.invocation.node for f in burst)
    plane.detach()
    _cp_close(eb)
    cp_counts = launches()
    log(f"  (d) SLO scale-out (slo p99 1.0 s, target concurrency 4, max 4 units): 16 events in "
        f"{wall:.3f} s; decisions {decisions}; (t, capacity, outstanding) "
        f"{caps[:40]}{' ...' if len(caps) > 40 else ''}; served by {dict(nodes)}; batches "
        f"{eb.batch_sizes}")
    if not any(d[1] == "scale-out" for d in decisions) or len(nodes) < 2 or \
            not all(len(o["outputs"][0]) >= 1 for o in outs):
        raise AssertionError(f"phase 5 (d): decisions {decisions}, workers {dict(nodes)}")
    log(f"  (a)-(d) launches via ControlPlane {cp_counts}")
    _cp_need_k2_k1(cp_counts, "(a)-(d) via ControlPlane")

    # (e) the simulated cluster on the card: one node, the card as its
    # accelerator (2 slots), the serve runtime's real fn in virtual time
    spec = accelerator_spec("cuda:0", cost_per_hour=0.0, slots=2)
    sdef = _cp_runtime(cfg, device="cuda:0", acc_types={
        spec.type: SimProfile(elat_median_s=2.0, cold_start_s=2.0)})
    cluster = Cluster(scheduler="warm", seed=0)
    node = cluster.add_node("card0", [spec])
    sgw = Gateway(SimBackend(cluster))
    sid = sgw.register(sdef)
    events = [{"prompts": [p]} for p in prompts[24:32]]
    zero_launches()
    t0 = time.perf_counter()
    sfuts = sgw.map(sid, events, config=run, at=0.0, spacing_s=0.5)
    souts = [f.result(extra_time_s=3600.0) for f in sfuts]
    swall = time.perf_counter() - t0
    sim_counts = launches()
    engine = node._real_handles[sfuts[0].invocation.runtime_key]
    direct = [run_batch(sdef, [ev], dict(run, handle=engine))[0]["outputs"] for ev in events]
    invs = [f.invocation for f in sfuts]
    rl, el = sorted(i.rlat for i in invs), sorted(i.elat for i in invs)
    # a cold event's virtual RLat holds the profile's cold start, a stated
    # constant, not a measurement: report it net of that too
    net = sorted(i.rlat - (sdef.profiles[spec.type].cold_start_s if i.cold_start else 0.0)
                 for i in invs)
    log(f"  (e) SimBackend: node {node.name} accelerator {spec.type} ({spec.mem_bytes / 2**30:.1f} "
        f"GiB, 2 slots), 8 events 0.5 s apart in virtual time, served in {swall:.3f} s of wall "
        f"time; ELat (measured: wall time of fn) p50 {statistics.median(el) * 1e3:.1f} ms max "
        f"{el[-1] * 1e3:.1f} ms; virtual RLat net of the profile's stated "
        f"{sdef.profiles[spec.type].cold_start_s} s cold start p50 {statistics.median(net):.3f} "
        f"s max {net[-1]:.3f} s (with it p50 {statistics.median(rl):.3f} s max {rl[-1]:.3f} s); "
        f"cold {node.n_cold_starts} warm {node.n_warm_starts}; placements "
        f"{[i.accelerator for i in invs]}; launches via SimBackend {sim_counts}")
    if not all(i.success for i in invs) or node.n_cold_starts + node.n_warm_starts != 8:
        raise AssertionError(f"phase 5 (e): {[(i.success, i.error) for i in invs]}")
    for i, (r, want) in enumerate(zip(souts, direct)):
        if r["outputs"] != want:
            raise AssertionError(f"phase 5 (e): event {i} through SimBackend gave {r['outputs']}, "
                                 f"run_batch on this thread {want}")
    _cp_need_k2_k1(sim_counts, "(e) via SimBackend")
    log("  (e) every event's tokens equal run_batch on the main thread")
    return cp_counts, sim_counts


def _cp_need_k2_k1(counts, what: str) -> None:
    """Phase 5's paths run K2 and K1 decode, and no other kernel."""
    if not (counts["flash"] and counts["decode"]) or \
            counts["chunk"] or counts["dense"] or counts["scan"] or counts["gmm"]:
        raise AssertionError(f"phase 5 {what}: launches {counts}: need K2 and K1 decode only")


# ----------------------------------------------------------------------
# phase 6: the multi-process cluster on the card
# ----------------------------------------------------------------------
CL_PROMPTS = [64, 960, 200, 700, 128, 512, 900, 333]   # + 32 new < max_len 1024
CL_SPEC = "chip_smoke:counted_serve_runtime"
CL_KW = {"arch": "granite-3-2b", "max_batch": 4, "max_slots": 4, "max_len": 1024,
         "page_size": PAGE, "device": "cuda"}
CL_FREED = 0.9                     # share of an engine's bytes an eviction must give back


def weights_checksum(params) -> int:
    """An order-sensitive checksum of every weight's bits (integer sums on
    the card, exact): equal checksums in two processes mean the same seed
    gave the same weights there. Summed in slices of 2**24 elements: the
    int64 sum casts its input, and a whole stacked leaf cast would leave
    gigabytes in the caching allocator of a worker that shares the card."""
    import torch
    from repro_torch.models.param import iter_leaves
    total = 0
    for _, t in iter_leaves(params):
        bits = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
        s = sum(int(c.sum(dtype=torch.int64)) for c in bits.flatten().split(1 << 24))
        total = (total * 1000003 + s) % (1 << 61)
    return total


def counted_serve_runtime(**kwargs):
    """The port's cluster serve runtime (``repro_torch.cluster.runtimes:
    serve_runtime``), loaded by spec in each worker process, with what only
    that process can see riding every result: its kernel launch counts
    (the wrappers' counters live in the process that launches; they are
    set to 0 when its engine is built, before its first batch, and count
    up over its batches), its pid, the micro-batch that served the event
    (the process's batch number and the event's position, so the parent
    can rerun the same batch), the checksum of its engine's weights and
    the seconds its cold start took (both taken once, when the engine is
    built) and the card memory its caching allocator holds."""
    import itertools
    import os
    import torch
    from repro_torch.cluster.runtimes import serve_runtime
    rdef = serve_runtime(**kwargs)
    numbers = itertools.count()
    setup, fn, batch_fn = rdef.setup, rdef.fn, rdef.batch_fn

    def counted_setup():
        t0 = time.perf_counter()
        engine = setup()
        engine.setup_s = time.perf_counter() - t0
        engine.weights_checksum = weights_checksum(engine.params)
        zero_launches()
        return engine

    def stamp(results, config):
        n, pid = next(numbers), os.getpid()
        reserved = torch.cuda.memory_reserved() if torch.cuda.is_initialized() else 0
        engine = config["handle"]
        return [dict(r, launches=launches(), pid=pid, batch=[pid, n], pos=i,
                     weights=engine.weights_checksum, setup_s=engine.setup_s,
                     reserved=reserved)
                for i, r in enumerate(results)]
    return dataclasses.replace(
        rdef, setup=counted_setup,
        fn=lambda data, config: stamp([fn(data, config)], config)[0],
        batch_fn=lambda datas, config: stamp(batch_fn(datas, config), config))


@contextlib.contextmanager
def _takes_held(master):
    """Hold every worker's ``take`` at ``master`` (in this process) while
    the block runs: the events submitted inside it are queued together,
    so each parked worker's take forms a full micro-batch from them."""
    master._take_for_worker_locked = lambda *args, **kwargs: None
    try:
        yield
    finally:
        with master._cond:
            del master._take_for_worker_locked      # the class's method
            master._cond.notify_all()


def _mem_free(torch) -> int:
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0]


def _apps_memory() -> str:
    """Card memory per process as nvidia-smi reports it (a container may
    hide other processes: then it says so)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    rows = out.stdout.strip().replace("\n", "; ")
    return rows or f"nothing listed (exit {out.returncode})"


def _same_batches(invs, results, payloads, prdef, engine, run, what: str) -> int:
    """Every event's tokens against ``run_batch`` in this process on the same
    batch as the worker served it (same events, same order: its batch
    number and position ride the result), the parent's engine built from
    the same seed. Returns the number of batches rerun."""
    from repro_torch.core.runtime import run_batch
    groups = collections.defaultdict(dict)
    for inv, res in zip(invs, results):
        groups[tuple(res["batch"])][res["pos"]] = (inv, res)
    for key, members in sorted(groups.items()):
        order = [members[p] for p in sorted(members)]
        if sorted(members) != list(range(len(order))):
            raise AssertionError(f"phase 6 {what}: batch {key} holds positions {sorted(members)}")
        want = run_batch(prdef, [payloads[inv.inv_id] for inv, _ in order],
                         dict(run, handle=engine))
        for (inv, res), w in zip(order, want):
            if res["outputs"] != w["outputs"]:
                raise AssertionError(
                    f"phase 6 {what}: event {inv.inv_id} (batch {key}, position {res['pos']}, "
                    f"node {inv.node}, attempt {inv.attempt}) gave {res['outputs']}, run_batch "
                    f"of the same batch in this process {w['outputs']}")
    return len(groups)


def cluster_run(torch, cfg, gw_ref):
    """Phase 6: granite-3-2b (as registered) through the multi-process
    cluster on the card: ``Gateway.invoke`` -> ``ClusterBackend`` (RPC
    client, settlement pump) -> ``Master`` (queue, leases, store, keeper)
    -> 2 ``repro_torch.cluster.worker`` processes, each with its own CUDA
    context and engine on this card -> ``serve_runtime`` -> K2 and K1
    decode; the tracer on. (a) a prewarm directive each (the workers'
    cold starts), then 8 one-prompt events mapped at once while the
    master's takes are held (a batch of 4 on each worker), then 4 invoked
    one at a time; (b) a ``kill-worker-process`` fault SIGKILLs the worker
    holding an event's lease, which the keeper requeues to the survivor;
    (c) two three-step chains (generate -> refine -> polish); (d) an
    eviction broadcast gives the survivor's engine back to the card, and
    one more event cold-starts it again. Every event's tokens equal
    ``run_batch`` of the same batch in this process on an engine from the
    same seed (checksums of the weights equal). ``gw_ref`` holds phase 3's
    in-process gateway readings
    of the same run (``host_ms``, ``elat_ms``), printed beside the
    cluster's. Returns the (a) launch counts summed over the workers, each
    worker's counts read from its result of its latest batch in (a)."""
    import os
    import statistics
    from repro_torch import obs
    from repro_torch.cluster import start_cluster
    from repro_torch.cluster.runtimes import serve_runtime
    from repro_torch.core.events import runtime_key_for
    from repro_torch.faults import inject
    from repro_torch.gateway import Gateway, Workflow

    # the workers import this file (the spec above) from the repo root
    root = str(Path(__file__).resolve().parent)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    run = {"max_new_tokens": MAX_NEW}
    free0 = _mem_free(torch)
    live0 = torch.cuda.memory_allocated()
    prdef = serve_runtime(**CL_KW)              # the parent's comparison engine
    engine = prdef.setup()
    engine_bytes = torch.cuda.memory_allocated() - live0
    checksum = weights_checksum(engine.params)
    free_engine = _mem_free(torch)
    log(f"  card memory free {free0 / 2**30:.2f} GiB before; the parent's comparison engine "
        f"holds {engine_bytes / 2**30:.2f} GiB (weights and KV pool, memory_allocated), free "
        f"{free_engine / 2**30:.2f} GiB after it (mem_get_info)")

    t0 = time.perf_counter()
    h = start_cluster(2, lease_s=300.0, heartbeat_timeout_s=5.0, keeper_interval_s=0.25,
                      max_batch=4, ready_timeout_s=120.0)
    t_ready = time.perf_counter() - t0
    backend = h.backend
    gw = Gateway(backend)
    obs.reset()
    obs.enable(clock=backend.now, metrics=gw.metrics)
    payloads = {}

    def invoke(payload):
        fut = gw.invoke(rid, payload, config=run)
        payloads[fut.invocation.inv_id] = payload
        return fut
    try:
        rid = backend.register_spec(CL_SPEC, CL_KW)
        log(f"  start_cluster(2): both worker processes spawned and said hello in "
            f"{t_ready:.3f} s")
        rng = np.random.default_rng(13)
        events = [{"prompts": [rng.integers(3, cfg.vocab, size=n).tolist()]}
                  for n in CL_PROMPTS]

        # (a) a prewarm on each worker (the master routes the directives
        # round-robin over the live workers), then a burst of 8 mapped
        # while the takes are held, then 4 one at a time
        hooks = backend.capacity_hooks()
        t0 = time.perf_counter()
        for _ in range(2):
            if not hooks.prewarm(rid, run):
                raise AssertionError("phase 6 (a): the prewarm reached no worker")

        def prewarms():
            return {w: r["stats"].get("n_prewarms", 0)
                    for w, r in backend.stats()["workers"].items()}
        while prewarms() != {"w0": 1, "w1": 1}:
            if time.perf_counter() - t0 > 300.0:
                raise AssertionError(f"phase 6 (a): prewarms per worker {prewarms()}")
            time.sleep(0.01)
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _takes_held(h.master):
            burst = [invoke(ev) for ev in events]
        res_b = [f.result(extra_time_s=300.0) for f in burst]
        wall_b = time.perf_counter() - t0
        free_a = _mem_free(torch)
        apps = _apps_memory()
        t0 = time.perf_counter()
        singles, res_s = [], []
        for ev in events[:4]:
            singles.append(invoke(ev))
            res_s.append(singles[-1].result(extra_time_s=300.0))
        wall_s = time.perf_counter() - t0
        futs_a, res_a = burst + singles, res_b + res_s
        invs_a = [f.invocation for f in futs_a]
        spans = obs.TRACER.spans()
        doc = json.loads(json.dumps(obs.to_trace_events(spans)))
        latest = {}                              # each pid's result of its latest batch
        for r in res_a:
            if r["pid"] not in latest or r["batch"][1] > latest[r["pid"]]["batch"][1]:
                latest[r["pid"]] = r
        by_pid = {p: r["launches"] for p, r in latest.items()}
        reserved = {p: r["reserved"] for p, r in latest.items()}
        setup_s = {p: r["setup_s"] for p, r in latest.items()}
        starts = {w: (r["stats"].get("n_cold_starts"), r["stats"].get("n_prewarms"))
                  for w, r in backend.stats()["workers"].items()}

        if not all(i.success for i in invs_a):
            raise AssertionError(f"phase 6 (a): {[(i.success, i.error) for i in invs_a]}")
        pids = {i.node: r["pid"] for i, r in zip(invs_a, res_a)}
        served = set(pids.values())
        if sorted(pids) != ["w0", "w1"] or len(served) != 2 or os.getpid() in served:
            raise AssertionError(f"phase 6 (a): served by {pids} (this process {os.getpid()})")
        if {r["weights"] for r in res_a} != {checksum}:
            raise AssertionError(f"phase 6 (a): weight checksums {set(r['weights'] for r in res_a)}"
                                 f", the parent's {checksum}: the seed gave other weights")
        sizes = collections.Counter(tuple(r["batch"]) for r in res_b)
        if sorted(sizes.values()) != [4, 4] or {b[0] for b in sizes} != served:
            raise AssertionError(f"phase 6 (a): burst batches {dict(sizes)}: need a batch of 4 "
                                 "on each worker")
        if any(i.cold_start for i in invs_a) or \
                not all(f.invocation.prewarmed for f in burst) or \
                any(f.invocation.prewarmed for f in singles) or \
                starts != {"w0": (0, 1), "w1": (0, 1)}:
            raise AssertionError(f"phase 6 (a): cold starts and prewarms per worker {starts}; "
                                 "need one cold start per worker, its prewarm, then warm "
                                 "starts (the burst's first on its prewarmed engine)")
        for pid, counts in by_pid.items():
            if not (counts["flash"] and counts["decode"]) or any(
                    counts[k] for k in ("chunk", "dense", "scan", "gmm")):
                raise AssertionError(f"phase 6 (a): worker pid {pid} launches {counts}: need K2 "
                                     "and K1 decode only")
        problems = obs.validate_trace(doc)
        if problems:
            raise AssertionError(f"phase 6 (a): the exported trace is invalid: {problems[:5]}")
        ids = {sp.span_id for sp in spans}
        loose = [sp.span_id for sp in spans if sp.parent_id is not None and sp.parent_id not in ids]
        if loose:
            raise AssertionError(f"phase 6 (a): spans whose parent is not in the trace: "
                                 f"{loose[:5]}")
        kids = collections.defaultdict(set)
        for sp in spans:
            kids[sp.parent_id].add(sp.name)
        execs = [sp for sp in spans if sp.name == "execute"]
        leads = [sp for sp in execs if kids[sp.span_id]]
        n_batches = len({tuple(r["batch"]) for r in res_a})
        if len(execs) != len(futs_a) or any(sp.attrs.get("pid") not in served for sp in execs) \
                or len(leads) != n_batches or \
                any(not {"prefill", "decode"} <= kids[sp.span_id] for sp in leads):
            raise AssertionError(f"phase 6 (a): {len(execs)} execute spans, {len(leads)} with "
                                 f"engine spans for {n_batches} batches: "
                                 f"{[kids[sp.span_id] for sp in leads]}")
        n_rerun = _same_batches(invs_a, res_a, payloads, prdef, engine, run, "(a)")

        rl = sorted(i.rlat for i in invs_a)
        el_b = sorted(f.invocation.elat for f in burst)
        el_s = sorted(f.invocation.elat for f in singles)
        host = [f.invocation.rlat - f.invocation.elat for f in singles]
        n_tok = sum(len(o) for r in res_b for o in r["outputs"])
        log(f"  (a) a prewarm directive to each worker (round-robin): both warm "
            f"{t_warm:.3f} s after the directives; cold start (the prewarm's setup, timed in the "
            f"worker) per pid { {p: round(t, 4) for p, t in sorted(setup_s.items())} } s")
        log(f"  (a) 12 events, all succeeded, served by {sorted(served)} (the burst mapped while "
            f"the master held the takes of the two parked, prewarmed workers, so each took a "
            f"micro-batch of 4: checked); batch sizes of the burst "
            f"{sorted(sizes.values(), reverse=True)}; no cold start in (a), the burst's batches "
            f"on prewarmed engines; weights checksum {checksum} in both workers and this process")
        log(f"  (a) RLat p50 {statistics.median(rl) * 1e3:.1f} ms max {rl[-1] * 1e3:.1f} ms; "
            f"ELat burst (two processes time-slicing the card, a batch of 4 each) p50 "
            f"{statistics.median(el_b) * 1e3:.1f} ms max {el_b[-1] * 1e3:.1f} ms, beside the "
            f"in-process gateway's batches of 4 (phase 3 wave 1, same run) p50 "
            f"{gw_ref['elat_ms']:.1f} ms; one at a time p50 {statistics.median(el_s) * 1e3:.1f} "
            f"ms max {el_s[-1] * 1e3:.1f} ms; burst {n_tok} tokens in {wall_b:.3f} s = "
            f"{n_tok / wall_b:.1f} tokens/s; 4 one at a time in {wall_s:.3f} s")
        log(f"  (a) host cost per event over RPC (RLat - ELat, one at a time) mean "
            f"{statistics.mean(host) * 1e3:.3f} ms max {max(host) * 1e3:.3f} ms; in-process "
            f"gateway (phase 3 wave 2, same run, its 50 ms batch window included) mean "
            f"{gw_ref['host_ms']:.3f} ms")
        log(f"  (a) launches per worker pid {by_pid}; every event's tokens equal run_batch of "
            f"the same batch in this process ({n_rerun} batches); trace "
            f"{len(doc['traceEvents'])} events, valid, every parent in the trace, "
            f"{len(leads)} worker-authored execute spans holding prefill and decode")
        log(f"  (a) card memory free {free_a / 2**30:.2f} GiB with both workers warm, "
            f"{(free_engine - free_a) / 2**30:.2f} GiB below the free before the cluster "
            f"(mem_get_info: both workers' engines, caches and CUDA contexts); each worker's "
            f"caching allocator holds "
            f"{ {p: round(b / 2**30, 2) for p, b in sorted(reserved.items())} } GiB "
            f"(memory_reserved, by pid); nvidia-smi per process: {apps}")

        # (b) SIGKILL the worker that holds an event's lease
        before = {w: r["stats"].get("n_batches", 0) for w, r in backend.stats()["workers"].items()}
        ev = events[1]
        fut = invoke(ev)
        holder = None
        t0 = time.perf_counter()
        while holder is None:
            now = {w: r["stats"].get("n_batches", 0)
                   for w, r in backend.stats()["workers"].items()}
            holder = next((w for w in now if now[w] > before.get(w, 0)), None)
            if time.perf_counter() - t0 > 60.0:
                raise AssertionError("phase 6 (b): no worker took the event")
            time.sleep(0.005)
        free_kill = _mem_free(torch)
        injector = inject(backend, [{"at": 0.0, "op": "kill-worker-process",
                                     "worker": int(holder[1:])}])
        res_k = fut.result(extra_time_s=300.0)
        injector.disarm()
        inv_k = fut.invocation
        t_kill = injector.injected[0][0]
        abandoned = obs.TRACER.find(name="attempt", status=obs.ABANDONED)
        st = backend.stats()
        survivor = ({"w0", "w1"} - {holder}).pop()
        if injector.injected[0][3] != "SIGKILL" or st["workers_lost"] != 1 or \
                st["requeued"] < 1 or inv_k.attempt < 1 or inv_k.node != survivor or \
                not inv_k.success or len(abandoned) != 1:
            raise AssertionError(f"phase 6 (b): injected {injector.injected}, stats {st}, event "
                                 f"attempt {inv_k.attempt} node {inv_k.node} success "
                                 f"{inv_k.success}, abandoned {len(abandoned)}")
        if res_k["outputs"] != res_s[1]["outputs"] or res_k["batch"][0] != pids[survivor]:
            raise AssertionError(f"phase 6 (b): the retried event gave {res_k['outputs']} on pid "
                                 f"{res_k['batch'][0]}, in (a) {res_s[1]['outputs']}")
        # all of it comes back: at least what its allocator held at its last
        # batch (its CUDA context comes back too, on top), less what the
        # survivor's allocator took meanwhile to serve the retry
        grown = max(res_k["reserved"] - reserved[pids[survivor]], 0)
        t_back = _wait_mem(torch, free_kill + reserved[pids[holder]] - grown, 60.0, "(b)")
        free_b = _mem_free(torch)
        log(f"  (b) kill-worker-process SIGKILLed {holder} (pid {pids[holder]}) holding the "
            f"event's lease; requeued {abandoned[0].t_end - t_kill:.3f} s after the SIGKILL "
            f"(heartbeat timeout 5.0 s, keeper tick 0.25 s); the event ran again on "
            f"{inv_k.node} as attempt {inv_k.attempt}, RLat {inv_k.rlat:.3f} s, tokens equal to "
            f"(a)'s; master workers_lost {st['workers_lost']} requeued {st['requeued']}; card "
            f"memory free {free_kill / 2**30:.2f} -> {free_b / 2**30:.2f} GiB "
            f"({(free_b - free_kill) / 2**30:.2f} GiB back, {t_back:.3f} s after the event "
            f"settled)")

        # (c) two three-step chains on the survivor
        seeds = [{"prompts": [rng.integers(3, cfg.vocab, size=n).tolist()]} for n in (300, 600)]
        wf_futs = []
        t0 = time.perf_counter()
        for w, seed in enumerate(seeds):
            wf = Workflow(f"chain{w}")
            prev = wf.step("generate", rid, payload=seed, config=run)
            for stage in ("refine", "polish"):
                prev = wf.step(stage, rid, after=prev, config=run)
            wf_futs.append(gw.submit_workflow(wf))
        outs = [f.result(extra_time_s=300.0) for f in wf_futs]
        wall_c = time.perf_counter() - t0
        steps, res_c = [], []
        for f, seed in zip(wf_futs, seeds):
            data = seed                         # each step reads the one before
            for name in ("generate", "refine", "polish"):
                sf = f.step_future(name)
                r = sf.result(extra_time_s=60.0)
                payloads[sf.invocation.inv_id] = data
                steps.append(sf.invocation)
                res_c.append(r)
                data = r
            if f.statuses() != {"generate": "done", "refine": "done", "polish": "done"}:
                raise AssertionError(f"phase 6 (c): {f.name} {f.statuses()}")
        n_rerun_c = _same_batches(steps, res_c, payloads, prdef, engine, run, "(c)")
        if [o["outputs"] for o in outs] != [r["outputs"] for r in res_c[2::3]]:
            raise AssertionError("phase 6 (c): a chain's result is not its polish step's")
        last = res_c[-1]["launches"]
        if any(last[k] for k in ("chunk", "dense", "scan", "gmm")):
            raise AssertionError(f"phase 6 (c): the survivor launched {last}")
        log(f"  (c) 2 chains (generate -> refine -> polish) in {wall_c:.3f} s on "
            f"{sorted({i.node for i in steps})}; every step's tokens equal run_batch of the same "
            f"batch in this process ({n_rerun_c} batches), so each chain equals the chain run "
            f"here; step ELat p50 {statistics.median(i.elat for i in steps) * 1e3:.1f} ms")

        # (d) an eviction directive gives the survivor's engine back to the card
        free_d = _mem_free(torch)
        key = runtime_key_for(rid, run)
        if not backend.capacity_hooks().evict(key):
            raise AssertionError("phase 6 (d): the eviction reached no worker")
        t_evict = _wait_mem(torch, free_d + CL_FREED * engine_bytes, 60.0, "(d)")
        free_e = _mem_free(torch)
        t0 = time.perf_counter()
        while key in backend.stats()["workers"][survivor]["stats"].get("warm_keys", ()):
            if time.perf_counter() - t0 > 60.0:     # the beat after the drop says so
                raise AssertionError(f"phase 6 (d): {survivor} still reports {key} warm")
            time.sleep(0.01)
        fut = invoke(events[0])                 # the evicted runtime cold-starts again
        res_e = fut.result(extra_time_s=300.0)
        inv_e = fut.invocation
        spans_e = obs.TRACER.find(name="cold_start")
        if not (inv_e.success and inv_e.cold_start and inv_e.node == survivor) or \
                res_e["outputs"] != res_s[0]["outputs"] or len(spans_e) != 1:
            raise AssertionError(f"phase 6 (d): the event after the eviction: success "
                                 f"{inv_e.success} cold {inv_e.cold_start} on {inv_e.node}, "
                                 f"{len(spans_e)} cold_start spans, tokens equal to (a)'s "
                                 f"{res_e['outputs'] == res_s[0]['outputs']}")
        log(f"  (d) evict broadcast: card memory free {free_d / 2**30:.2f} -> "
            f"{free_e / 2**30:.2f} GiB {t_evict:.3f} s later (the worker drops its "
            f"engine and empties its cache; at least {CL_FREED} of an engine's "
            f"{engine_bytes / 2**30:.2f} GiB required); then one event cold-starts "
            f"{inv_e.node} again: cold_start span {spans_e[0].duration:.4f} s (setup timed in "
            f"the worker {res_e['setup_s']:.4f} s), ELat {inv_e.elat * 1e3:.1f} ms, tokens equal "
            f"to (a)'s")
    finally:
        h.close()
        obs.reset()
        engine = None
        torch.cuda.empty_cache()
    log(f"  card memory free {_mem_free(torch) / 2**30:.2f} GiB after the cluster closed")
    return {k: sum(c[k] for c in by_pid.values()) for k in by_pid[next(iter(by_pid))]}


def _wait_mem(torch, free_at_least: float, timeout_s: float, what: str) -> float:
    t0 = time.perf_counter()
    while _mem_free(torch) < free_at_least:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"phase 6 {what}: card memory free {_mem_free(torch)} bytes after "
                                 f"{timeout_s} s, expected at least {int(free_at_least)}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _device_us(ev) -> float:
    return ev.self_device_time_total


def profile_breakdown(torch, label: str, run, n: int, shares=None):
    """Profile ``run()`` (``n`` units of work): wall ms per unit, device
    busy ms per unit (kernels and copies on the card), the idle share, the
    host-side op count, the top device consumers and, for each ``shares``
    entry (label: kernel name), that kernel's device ms per unit and share
    of busy, with the launches the profiler recorded beside those its
    wrappers counted. Returns (wall ms, device busy ms, {label: ms}) per
    unit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    after = launches()
    counted = {what: after[key] - before[key] for what, key in (
        ("K2", "flash"), ("K1 decode", "decode"), ("K1 chunk", "chunk"), ("K3", "dense"),
        ("K5", "scan"), ("K4", "gmm"))}
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
    share_ms = {}
    for what, kernel in (shares or {}).items():
        evs = [e for e in dev if kernel in e.key]
        share_ms[what] = ms = sum(_device_us(e) for e in evs) / 1e3 / n
        log(f"    share {what}: {ms:.3f} ms of {busy:.2f} ms busy ({ms / busy:.3f}), "
            f"{sum(e.count for e in evs)} launches recorded of {counted[what]} counted")
    return wall, busy, share_ms


PREFILL_SHARES = {"K2": "flash_attention_mma_kernel", "K5": "rglru_scan_kernel",
                  "K4": "moe_gmm_mma_kernel"}


def profile_served(torch, engine, cfg, context: int, prefill_len: int):
    """Where the time of a served path goes: 3 decode steps of a full batch
    (8 slots at ~``context`` tokens; the prompts prefill whole), profiled,
    then 3 more on the host clock alone; and one ``prefill_len``-token
    prefill, after a warm-up, on the host clock alone and then profiled.
    Returns the readings phase 7's roofline fractions read: the decode
    step's batch, context and ms per step (host clock, device busy), the
    prefill's length and ms (the same two)."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(5)
    steps = 3
    for i in range(engine.max_slots):
        engine.submit(Request(prompt=rng.integers(3, cfg.vocab, size=context).tolist(),
                              max_new_tokens=2 * steps + 4, req_id=100 + i))
    engine.step()                   # admits and prefills all 8, one decode
    _, busy, _ = profile_breakdown(
        torch, f"{cfg.name} decode step (B=8, ~{context} context)",
        lambda: [engine.step() for _ in range(steps)], steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    engine.generate([])             # drain
    toks = torch.from_numpy(rng.integers(3, cfg.vocab, size=(1, prefill_len))).to(engine.device)
    M.prefill(cfg, engine.params, {"tokens": toks})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M.prefill(cfg, engine.params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    _, prefill_busy, _ = profile_breakdown(
        torch, f"{cfg.name} prefill (1 x {prefill_len} tokens)",
        lambda: M.prefill(cfg, engine.params, {"tokens": toks}), 1, shares=PREFILL_SHARES)
    log(f"  {cfg.name} without the profiler: decode step {step_ms:.2f} ms (B=8, ~{context + 4} "
        f"context), prefill of {prefill_len} tokens {prefill_ms:.2f} ms (host clock)")
    return dict(cfg=cfg, batch=engine.max_slots, context=context + 4, step_ms=step_ms,
                step_busy_ms=busy, prefill_len=prefill_len, prefill_ms=prefill_ms,
                prefill_busy_ms=prefill_busy)


def profile_chunked_prefill(torch, engine, cfg, prompt_len: int,
                            chunk_kernel: str = "paged_prefill_mma_kernel"):
    """One ``prompt_len``-token prompt through the engine at its
    ``prefill_chunk``: the engine steps that prefill it, one chunk each
    (the last also decodes the new request once), after one warm-up
    prompt. Returns ``profile_breakdown``'s numbers, with K1 chunk's share
    (``chunk_kernel``)."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(6)
    n_steps = -(-prompt_len // engine.prefill_chunk)
    for i, what in enumerate(("warm-up", "profiled")):
        engine.submit(Request(prompt=rng.integers(3, cfg.vocab, size=prompt_len).tolist(),
                              max_new_tokens=2, req_id=200 + i))
        run = lambda: [engine.step() for _ in range(n_steps)]  # noqa: E731
        if what == "warm-up":
            run()
        else:
            res = profile_breakdown(
                torch, f"{cfg.name} chunked prefill (1 x {prompt_len} tokens, {n_steps} "
                f"chunks of {engine.prefill_chunk}, the last step decodes once)", run, 1,
                shares={"K1 chunk": chunk_kernel})
        engine.generate([])        # drain
    return res


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


def logits_parity(torch, cfg, params, dev, S, paged, frames=None):
    """Prefill + 8 decode steps through the kernels and through
    impl="ref", teacher-forced on the kernel path's greedy tokens; the
    decode cache is paged (granite, llama4's global layers) or dense
    per-slot (recurrentgemma, whisper: its prefill also encodes
    ``frames`` (1, F, d) and caches the cross K/V). A MoE model's plain path follows the kernel
    path's routing (``shared_routes``); the number of (token, layer)
    decisions where its own would differ is logged, and reported beside a
    failure."""
    from repro_torch.models import model as M
    from repro_torch.models.param import iter_leaves
    from repro_torch.serve.engine import install_slot

    if cfg.qkv_bias:
        log(f"  {cfg.name}: {draw_qkv_biases(torch, params, 12)} QKV bias values drawn "
            f"non-zero (normal x {BIAS_SCALE}) for the logits check")
    rng = np.random.default_rng(2)
    steps = 8
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(1, S))).to(dev)
    batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frames": frames}
    n_pages = -(-(S + steps) // PAGE)
    table = torch.arange(1, n_pages + 1, dtype=torch.int32, device=dev)[None] \
        if paged else None
    res, caches = {}, {}
    with shared_routes() as (routes, cur):
        for impl in (None, "ref"):
            cur[0] = impl
            logits, dense = M.prefill(cfg, params, batch, cache_len=S + steps, impl=impl)
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
    if cfg.qkv_bias:
        log(f"  {cfg.name}: {draw_qkv_biases(torch, params, 13)} QKV bias values drawn "
            f"non-zero (normal x {BIAS_SCALE}) for the greedy check")
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
# phase 7: the dense catalogue and the roofline on the card
# ----------------------------------------------------------------------
BIAS_SCALE = 0.5                   # the drawn QKV biases: normal x 0.5


def draw_qkv_biases(torch, params, seed: int) -> int:
    """Draw every QKV bias leaf of ``params`` from ``seed`` (normal x
    ``BIAS_SCALE``), in place: the specs start them at zero, which would
    hide a path that leaves them out. Returns the number of values."""
    from repro_torch.models.param import iter_leaves
    gen = torch.Generator().manual_seed(seed)
    n = 0
    for path, leaf in iter_leaves(params):
        if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
            leaf.copy_(torch.randn(leaf.shape, generator=gen).mul_(BIAS_SCALE))
            n += leaf.numel()
    return n


def catalogue_run(torch, dev):
    """qwen2.5-14b as registered (paged whole-prompt, paged 256-token
    chunks, dense; bf16 logits against impl="ref" and float32 greedy
    tokens at 4 layers, QKV biases drawn non-zero for both checks), then
    deepseek-7b as registered (paged whole-prompt; the logits check).
    Returns the launch counts by kernel entry, the served paths' profile
    readings and their first events' ELat."""
    from repro_torch.configs import get_config
    from repro_torch.models.param import iter_leaves

    total = collections.Counter()
    readings, firsts = [], {}
    qw = get_config("qwen2.5-14b")
    log(f"phase 7: served path, {qw.name} {qw.n_layers} layers d={qw.d_model} heads "
        f"{qw.n_heads}/{qw.n_kv_heads} hd={qw.hd} d_ff={qw.d_ff} vocab {qw.padded_vocab} "
        f"qkv_bias={qw.qkv_bias} rope theta {qw.rope_theta:g} {qw.dtype}, random weights "
        "(seed 0)")
    for page_size, chunk in ((PAGE, 0), (PAGE, 256), (0, 0)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        need = ["flash"] + (["decode"] if page_size else ["dense"]) + \
            (["chunk"] if chunk else [])
        engine, counts, first = serve_run(
            torch, qw, dev, page_size=page_size, prefill_chunk=chunk, max_len=2048,
            prompt_lens=GRANITE_PROMPTS, need=need,
            absent=["scan", "gmm"] + (["dense"] if page_size else ["decode", "chunk"]))
        log(f"  {qw.name}: {sum(t.numel() for _, t in iter_leaves(engine.params)) / 1e9:.2f} B "
            f"parameters, {torch.cuda.max_memory_allocated() / 1e9:.1f} GB peak allocated")
        total["flash_qwen"] += counts["flash"]
        total["decode_qwen"] += counts["decode"]
        total["chunk_qwen"] += counts["chunk"]
        total["dense_qwen"] += counts["dense"]
        if page_size and not chunk:
            firsts[qw.name] = (qw, first)
            readings.append(profile_served(torch, engine, qw, context=256, prefill_len=1024))
            # the parity check before the next engine: two copies of the
            # weights (29.5 GB each) and a float32 draft do not fit
            params = engine.params
            engine = None
            torch.cuda.empty_cache()
            logits_parity(torch, qw, params, dev, S=300, paged=True)
            del params
        engine = None
    total["chunk_qwen_768"] = total["chunk_qwen"]
    torch.cuda.empty_cache()
    greedy_parity(torch, dataclasses.replace(qw, n_layers=4, dtype="float32"), dev,
                  lens=[40, 300, 700, 1000], max_len=1100,
                  runs=[dict(page_size=PAGE), dict(page_size=PAGE, impl="ref"),
                        dict(page_size=PAGE, prefill_chunk=256),
                        dict(page_size=PAGE, prefill_chunk=256, impl="ref"),
                        dict(page_size=0), dict(page_size=0, impl="ref")])

    ds = get_config("deepseek-7b")
    log(f"phase 7: served path, {ds.name} {ds.n_layers} layers d={ds.d_model} heads "
        f"{ds.n_heads}/{ds.n_kv_heads} hd={ds.hd} d_ff={ds.d_ff} vocab {ds.padded_vocab} "
        f"{ds.dtype}, random weights (seed 0)")
    torch.cuda.reset_peak_memory_stats()
    engine, counts, first = serve_run(
        torch, ds, dev, page_size=PAGE, prefill_chunk=0, max_len=2048,
        prompt_lens=GRANITE_PROMPTS, need=["flash", "decode"],
        absent=["chunk", "dense", "scan", "gmm"])
    log(f"  {ds.name}: {sum(t.numel() for _, t in iter_leaves(engine.params)) / 1e9:.2f} B "
        f"parameters, {torch.cuda.max_memory_allocated() / 1e9:.1f} GB peak allocated")
    total["flash_ds"], total["decode_ds"] = counts["flash"], counts["decode"]
    firsts[ds.name] = (ds, first)
    readings.append(profile_served(torch, engine, ds, context=256, prefill_len=1024))
    params = engine.params
    engine = None
    torch.cuda.empty_cache()
    logits_parity(torch, ds, params, dev, S=300, paged=True)
    del params
    torch.cuda.empty_cache()
    return total, readings, firsts


def roofline_fractions(readings) -> None:
    """Phase 7 (c): each served decode step's analytic memory bound
    (``memory_model`` in bf16 over the datasheet's HBM rate) over its
    measured time on the host clock and over its device busy time; each
    profiled prefill's MFU (``model_flops`` over the measured time at the
    datasheet's bf16 peak). Readings, not gates."""
    from repro_torch.configs import InputShape
    from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS, model_flops
    from repro_torch.roofline.analytic import memory_model
    for r in readings:
        cfg = r["cfg"]
        shape = InputShape("serve_decode", r["context"], r["batch"], "decode")
        n_bytes = memory_model(cfg, shape, data=1, model=1)
        bound = n_bytes / HBM_BW * 1e3
        log(f"  roofline {cfg.name} ({cfg.n_layers} layers) decode step B={r['batch']} "
            f"context {r['context']}: {n_bytes / 1e9:.3f} GB, memory bound {bound:.3f} ms; "
            f"measured {r['step_ms']:.2f} ms (host clock), fraction {bound / r['step_ms']:.4f}; "
            f"device busy {r['step_busy_ms']:.2f} ms, fraction "
            f"{bound / r['step_busy_ms']:.4f}")
        flops = model_flops(cfg, InputShape("serve_prefill", r["prefill_len"], 1, "prefill"))
        ideal = flops / PEAK_FLOPS * 1e3
        log(f"  roofline {cfg.name} ({cfg.n_layers} layers) prefill of {r['prefill_len']} "
            f"tokens: {flops / 1e12:.3f} TFLOP, compute bound {ideal:.3f} ms; measured "
            f"{r['prefill_ms']:.2f} ms (host clock), MFU {ideal / r['prefill_ms']:.4f}; "
            f"device busy {r['prefill_busy_ms']:.2f} ms, MFU {ideal / r['prefill_busy_ms']:.4f}")


def sim_run(firsts):
    """Phase 7 (d): ``repro_torch.launch.serve --backend sim --sim`` over
    every registered arch, one event each, as a subprocess (it runs no
    model). It must exit 0 with every event served; prints each arch's
    profile, and for the archs served here the profile's ELat for the
    same batch, prompt lengths and new tokens beside the first event's
    ELat measured on this card."""
    import os
    from repro_torch.configs import list_archs
    from repro_torch.serve.service_model import SIM_NODE, roofline_profile
    archs = list_archs()
    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--backend", "sim", "--sim",
           "--arch", ",".join(archs), "--events", str(len(archs)), "--max-new-tokens", "16"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
    secs = time.perf_counter() - t0
    served = f"{len(archs)}/{len(archs)} events served"
    if out.returncode != 0 or served not in out.stdout:
        raise AssertionError(f"phase 7 (d): {' '.join(cmd[1:])} exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    profiles = dict(re.findall(r"profile serve-(\S+): (ELat median \S+ cold start \S+)",
                               out.stdout))
    if sorted(profiles) != archs:
        raise AssertionError(f"phase 7 (d): profiles printed for {sorted(profiles)}")
    log(f"phase 7 (d): --backend sim --sim over {len(archs)} archs on {SIM_NODE.type} nodes: "
        f"exit 0, {served}, in {secs:.1f} s")
    for arch in archs:
        log(f"  profile {arch}: {profiles[arch]}")
    for name, (cfg, first) in firsts.items():
        lens = first["prompt_lens"]
        prompt_len = sum(lens) // len(lens)
        sim = roofline_profile(cfg, batch=len(lens), new_tokens=MAX_NEW, prompt_len=prompt_len)
        one = roofline_profile(cfg, batch=len(lens), new_tokens=MAX_NEW, prompt_len=prompt_len,
                               chips=1)
        log(f"  ELat {name} ({cfg.n_layers} layers), {len(lens)} prompts of {lens} tokens, "
            f"{MAX_NEW} new: profile {sim.elat_median_s * 1e3:.2f} ms on {SIM_NODE.type} "
            f"({one.elat_median_s * 1e3:.2f} ms at 1 card), measured on this card "
            f"{first['elat_s'] * 1e3:.1f} ms")


# ----------------------------------------------------------------------
# phase 8: the paper's multi-accelerator workflow on the card
# ----------------------------------------------------------------------
YOLO_SIDE = 416                    # tiny-YOLOv2's published input
WH_STEPS = 32                      # whisper decode steps in (b)
# Hardless §V's measured medians (the paper's testbed, not this card)
PAPER_ELAT_MS = {"vision-tinyyolo": ("NCS", 1577.0), "caption-lm": ("K600", 1675.0)}


def yolo_cost(side: int, batch: int):
    """(operations, bytes) of tiny-YOLOv2 on ``batch`` images of ``side``
    squared: 2 x the convolutions' multiply-adds (scale, bias, activation
    and pooling are elementwise and left out); each weight, input image and
    output grid moved once, float32."""
    from repro_torch.models.yolo import CHANNELS, HEAD_OUT, N_POOLED
    h = w = side
    c_in, ops, weights = 3, 0, 0
    for i, c_out in enumerate(CHANNELS):
        ops += 2 * h * w * 9 * c_in * c_out
        weights += 9 * c_in * c_out + 2 * c_out
        if i < N_POOLED:
            h, w = -(-h // 2), -(-w // 2)
        c_in = c_out
    ops += 2 * h * w * c_in * HEAD_OUT
    weights += (c_in + 1) * HEAD_OUT
    return batch * ops, 4 * (weights + batch * (side * side * 3 + h * w * HEAD_OUT))


def yolo_run(torch, dev) -> None:
    """Phase 8 (a): tiny-YOLOv2 at 416x416, float32, batch 1 and 8 on the
    card against the port's CPU forward of the same weights within 1e-4 x
    max|out|. cuDNN's TF32 is switched ON around it (chip_smoke turns it
    off globally): ``yolo_forward`` must turn it off for itself. Time per
    image from CUDA events beside its bound."""
    from repro_torch.models.yolo import init_yolo_params, yolo_forward
    params = init_yolo_params(0, device=dev)
    host = {k: v.cpu() for k, v in params.items()}
    rng = np.random.default_rng(8)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for batch in (1, 8):
            x = torch.from_numpy(rng.standard_normal(
                (batch, YOLO_SIDE, YOLO_SIDE, 3)).astype(np.float32))
            xd = x.to(dev)
            got = yolo_forward(params, xd)
            torch.cuda.synchronize()
            if not torch.backends.cudnn.allow_tf32:
                raise AssertionError("phase 8 (a): yolo_forward left cuDNN's TF32 setting changed")
            want = yolo_forward(host, x)
            scale = want.abs().max().item()
            err = (got.cpu() - want).abs().max().item()
            tol = 1e-4 * scale
            grid = -(-YOLO_SIDE // 32)
            if not torch.isfinite(got).all() or tuple(got.shape) != (batch, grid, grid, 125) \
                    or err > tol:
                raise AssertionError(f"phase 8 (a): yolo B={batch} {tuple(got.shape)} max|err| "
                                     f"{err} > {tol} (1e-4 x max|out| {scale})")
            ms = event_ms(torch, lambda: yolo_forward(params, xd), 10)
            ops, n_bytes = yolo_cost(YOLO_SIDE, batch)
            b, by = bound_ms(n_bytes, ops, "float32")
            log(f"  phase 8 (a): tiny-YOLOv2 {YOLO_SIDE}x{YOLO_SIDE} float32 (TF32 off) B={batch}: "
                f"max|err| vs the CPU forward {err:.3e} (tol {tol:.3e}); {ms:.3f} ms per call = "
                f"{ms / batch:.3f} ms per image; bound {b / batch:.4f} ms per image ({by}: "
                f"{ops / batch / 1e9:.3f} GFLOP at 67 TFLOP/s float32, {n_bytes / 1e6:.1f} MB at "
                f"3.35 TB/s); {ops / ms / 1e9:.1f} TFLOP/s achieved")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    del params, host
    torch.cuda.empty_cache()


def whisper_run(torch, dev):
    """Phase 8 (b): whisper-tiny as registered (4 + 4 layers, d 384, 6
    heads, hd 64, 1500 frames, vocab 51865; bf16, QKV biases drawn), the
    model's own ``prefill`` and ``decode_step`` on a dense cache: the
    encoder over (8, 1500, 384) frames, a 32-token prefill, 32 greedy
    decode steps (tokens fed back on the card, one synchronize at the
    end). Launch counts are zeroed just before and read just after: K2
    (encoder, self and cross prefill) and K3 (self and cross decode) and no
    other kernel. Then the bf16 logits against impl="ref" and float32
    greedy tokens through the kernels against impl="ref". Returns the
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("whisper-tiny")
    log(f"phase 8 (b): {cfg.name} as registered: {cfg.n_encoder_layers} + {cfg.n_layers} layers "
        f"d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} frames "
        f"{cfg.n_frames} vocab {cfg.padded_vocab} {cfg.dtype}, random weights (seed 1)")
    params = M.init_model_params(cfg, 1, dev)
    n_bias = draw_qkv_biases(torch, params, 14)
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.standard_normal(
        (WH_B, cfg.n_frames, cfg.d_model)).astype(np.float32)).to(dev, getattr(torch, cfg.dtype))
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(WH_B, WH_PROMPT))).to(dev)
    batch = {"tokens": tokens, "frames": frames}
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, batch, cache_len=WH_PROMPT + WH_STEPS)
    tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    out = [tok]
    t0 = time.perf_counter()
    for i in range(WH_STEPS):
        pos = torch.full((WH_B,), WH_PROMPT + i, dtype=torch.int32, device=dev)
        logits, cache = M.decode_step(cfg, params, cache, tok[:, None], pos)
        tok = logits[:, -1].argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / WH_STEPS * 1e3
    counts = launches()
    if not (counts["flash"] and counts["dense"]) or counts["decode"] or counts["chunk"] or \
            counts["scan"] or counts["gmm"]:
        raise AssertionError(f"phase 8 (b): launches {counts}: need K2 and K3 only")
    toks = torch.stack(out, 1)
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (WH_B, 1, cfg.padded_vocab) \
            or int(toks.max()) >= cfg.padded_vocab:
        raise AssertionError(f"phase 8 (b): logits {tuple(logits.shape)} finite "
                             f"{bool(torch.isfinite(logits).all())}")
    enc_ms = event_ms(torch, lambda: M._encode(cfg, params, frames, None), 10)
    warm_ms = event_ms(torch, lambda: M.prefill(cfg, params, batch,
                                                cache_len=WH_PROMPT + WH_STEPS), 5)
    log(f"  phase 8 (b): {n_bias} QKV bias values drawn (normal x {BIAS_SCALE}); encoder over "
        f"({WH_B}, {cfg.n_frames}, {cfg.d_model}) frames {enc_ms:.3f} ms (CUDA events); TTFT "
        f"(encoder + {WH_PROMPT}-token prefill, B={WH_B}) first {ttft_ms:.2f} ms, warm "
        f"{warm_ms:.3f} ms; decode {step_ms:.3f} ms/step over {WH_STEPS} steps (host clock, "
        f"B={WH_B}, cross attention over {cfg.n_frames} cached frames); launches {counts}")
    logits_parity(torch, cfg, params, dev, S=WH_PROMPT, paged=False, frames=frames[:1])
    del params, cache, frames
    torch.cuda.empty_cache()
    whisper_greedy_parity(torch, dataclasses.replace(cfg, dtype="float32"), dev)
    return counts


def whisper_greedy_parity(torch, cfg, dev, steps: int = 12) -> None:
    """float32 greedy tokens of 2 rows (16-token prompts over 1500
    frames) through the kernels identical to impl="ref"."""
    from repro_torch.models import model as M
    params = M.init_model_params(cfg, 3, dev)
    draw_qkv_biases(torch, params, 13)
    rng = np.random.default_rng(10)
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab, size=(2, 16))).to(dev),
             "frames": torch.from_numpy(rng.standard_normal(
                 (2, cfg.n_frames, cfg.d_model)).astype(np.float32)).to(dev)}
    outs = {}
    for impl in (None, "ref"):
        logits, cache = M.prefill(cfg, params, batch, cache_len=16 + steps, impl=impl)
        tok = logits[:, -1].argmax(-1)
        seq = [tok]
        for i in range(steps):
            pos = torch.full((2,), 16 + i, dtype=torch.int32, device=dev)
            logits, cache = M.decode_step(cfg, params, cache, tok[:, None], pos, impl=impl)
            tok = logits[:, -1].argmax(-1)
            seq.append(tok)
        outs[impl] = torch.stack(seq, 1).tolist()
    if outs[None] != outs["ref"]:
        raise AssertionError(f"{cfg.name} f32 greedy tokens differ: kernels {outs[None]}, "
                             f"ref {outs['ref']}")
    log(f"  {cfg.name} float32: greedy tokens of 2 rows over {cfg.n_frames} frames identical "
        f"through the kernels and impl='ref' ({steps + 1} tokens each)")
    del params
    torch.cuda.empty_cache()


def workflow_run(torch):
    """Phase 8 (c): the twin of examples/workflow_pipeline.py without
    --reduced on --backend engine: Gateway.submit_workflow -> EngineBackend
    (its worker thread on the card) -> tiny-YOLOv2 on 4 images of 416x416,
    whisper-tiny and the granite-3-2b captioner (paged), all as registered.
    Two workflows: the first cold-starts each runtime, the second is warm.
    Launch counts are zeroed just before and read just after: K2 and K1
    decode and no other kernel (whisper's step runs one forward, no
    decode). Both workflows give the same step results. Returns the
    counts."""
    from repro_torch.examples import workflow_pipeline as wp
    gw = wp.build_gateway("engine")
    images = wp.make_images(4, wp.image_side(reduced=False))
    runs = []
    try:
        zero_launches()
        for w in range(2):
            t0 = time.perf_counter()
            fut = gw.submit_workflow(wp.make_workflow(images, name=f"caption-pipeline-{w}"))
            out = fut.result(extra_time_s=600.0)
            runs.append((fut, out, time.perf_counter() - t0))
        counts = launches()
    finally:
        gw.backend.shutdown()
    if not (counts["flash"] and counts["decode"]) or counts["dense"] or counts["chunk"] or \
            counts["scan"] or counts["gmm"]:
        raise AssertionError(f"phase 8 (c): launches {counts}: need K2 and K1 decode only")
    results = []
    for w, (fut, out, wall) in enumerate(runs):
        if set(fut.statuses().values()) != {"done"}:
            raise AssertionError(f"phase 8 (c): workflow {w}: {fut.statuses()}")
        steps = {name: fut.step_future(name) for name in fut.statuses()}
        invs = {name: f.invocation for name, f in steps.items()}
        res = {name: f.result() for name, f in steps.items()}
        results.append(res)
        colds = {i.runtime_id for i in invs.values() if i.cold_start}
        want = {i.runtime_id for i in invs.values()} if w == 0 else set()
        if colds != want:
            raise AssertionError(f"phase 8 (c): workflow {w} cold-started {colds}, expected {want}")
        if not all(len(r["detections"]) == 4 for n, r in res.items() if n.startswith("see")) \
                or len(res["hear"]["transcript"]) != 8 or \
                not 1 <= len(out["caption"]) <= wp.CAPTION_NEW:
            raise AssertionError(f"phase 8 (c): workflow {w} results {res}")
        log(f"  phase 8 (c): workflow {w} ({'cold' if w == 0 else 'warm'}): every step done in "
            f"{wall:.3f} s; caption {out['caption']}")
        for name, inv in invs.items():
            cold = f"cold start {inv.e_start - inv.n_start:.3f} s" if inv.cold_start else "warm"
            paper = PAPER_ELAT_MS.get(inv.runtime_id)
            ctx = f"; the paper's {paper[0]} median {paper[1]:.0f} ms" if paper else ""
            log(f"    step {name:8s} {inv.runtime_id:20s} acc={inv.accelerator} {cold}; ELat "
                f"{inv.elat * 1e3:.1f} ms, RLat {inv.rlat * 1e3:.1f} ms{ctx}")
    if results[0] != results[1]:
        raise AssertionError(f"phase 8 (c): the warm workflow gave {results[1]}, the cold one "
                             f"{results[0]}")
    log(f"  phase 8 (c): launches {counts}; both workflows gave the same step results")
    return counts


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
    check_tensor_cores(build)

    entries = phase_kernels(torch, dev)
    entries.update(phase_kernels_moe(torch, dev))
    entries.update(phase_kernels_catalogue(torch, dev))
    entries.update(phase_kernels_whisper(torch, dev))
    torch.cuda.empty_cache()
    readings, firsts = [], {}

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
        engine, counts, first = serve_run(
            torch, cfg, dev, page_size=page_size, prefill_chunk=chunk, max_len=2048,
            prompt_lens=GRANITE_PROMPTS, need=need,
            absent=["scan"] + (["dense"] if page_size else ["decode", "chunk"]))
        total["flash"] += counts["flash"]
        total["decode"] += counts["decode"]
        total["chunk"] += counts["chunk"]
        total["chunk_768"] = total["chunk"]
        total["dense_granite"] += counts["dense"]
        if page_size and not chunk:
            firsts[cfg.name] = (cfg, first)
            readings.append(profile_served(torch, engine, cfg, context=256, prefill_len=1024))
            params = engine.params
        if chunk:
            profile_chunked_prefill(torch, engine, cfg, prompt_len=1024)
    engine = None
    torch.cuda.empty_cache()

    log("phase 4: parity through the kernels against impl='ref'")
    logits_parity(torch, cfg, params, dev, S=300, paged=True)
    del params
    torch.cuda.empty_cache()

    log(f"phase 3: {cfg.name} through Gateway.invoke -> EngineBackend (max_batch 4, "
        "batch wait 50 ms, max_warm 1) -> make_serve_runtime, tracer on")
    counts, gw_ref = gateway_run(torch, cfg)
    # the gateway path's own counts, beside the direct runs' (same kernels,
    # same timings; launches counted from this path's run alone)
    for key in ("flash", "decode"):
        entries[f"{key}_gateway"] = dict(
            entries[key], name=entries[key]["name"] + ", via Gateway.invoke")
        total[f"{key}_gateway"] = counts[key]
    torch.cuda.empty_cache()

    log(f"phase 5: {cfg.name} behind the control plane (ControlPlane -> EngineBackend, "
        "max_batch 4) and on SimBackend (one node, this card, the model run for real in "
        "virtual time)")
    cp_counts, sim_counts = control_plane_run(torch, cfg)
    for key in ("flash", "decode"):
        entries[f"{key}_cp"] = dict(
            entries[key], name=entries[key]["name"] + ", via ControlPlane")
        total[f"{key}_cp"] = cp_counts[key]
        entries[f"{key}_sim"] = dict(
            entries[key], name=entries[key]["name"] + ", via SimBackend")
        total[f"{key}_sim"] = sim_counts[key]
    torch.cuda.empty_cache()

    log(f"phase 6: {cfg.name} through the multi-process cluster (Gateway.invoke -> "
        "ClusterBackend -> Master over RPC -> 2 worker processes on this card, max_batch 4, "
        "4 slots of 1024 tokens), tracer on")
    cl_counts = cluster_run(torch, cfg, gw_ref)
    for key in ("flash", "decode"):
        entries[f"{key}_cluster"] = dict(
            entries[key], name=entries[key]["name"] + ", via ClusterBackend")
        total[f"{key}_cluster"] = cl_counts[key]
    torch.cuda.empty_cache()

    # phase 3: recurrentgemma-2b, paged (its ring caches and state are
    # per-slot; nothing is pooled), whole-prompt prefill
    rg = get_config("recurrentgemma-2b")
    log(f"phase 3: served path, {rg.name} {rg.n_layers} layers pattern "
        f"{[k.value for k in rg.pattern]} d={rg.d_model} heads {rg.n_heads}/"
        f"{rg.n_kv_heads} hd={rg.hd} window {rg.window} d_ff={rg.d_ff} vocab "
        f"{rg.padded_vocab} {rg.dtype}, random weights (seed 0)")
    engine, counts, first = serve_run(
        torch, rg, dev, page_size=PAGE, prefill_chunk=0, max_len=4096,
        prompt_lens=RG_PROMPTS, need=["flash", "dense", "scan"],
        absent=["decode", "chunk"])
    total["flash_rg"] = counts["flash"]
    total["dense_rg"] = counts["dense"]
    total["scan"] = counts["scan"]
    firsts[rg.name] = (rg, first)
    readings.append(profile_served(torch, engine, rg, context=2100, prefill_len=3000))
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
    engine, counts, first = serve_run(
        torch, l4, dev, page_size=PAGE, prefill_chunk=0, max_len=9216,
        prompt_lens=L4_PROMPTS, need=["flash", "decode", "dense", "gmm"],
        absent=["chunk", "scan"])
    log(f"  {l4.name}: {sum(t.numel() for _, t in iter_leaves(engine.params)) / 1e9:.2f} B "
        f"parameters, {torch.cuda.max_memory_allocated() / 1e9:.1f} GB peak allocated")
    total["flash_l4"], total["decode_l4"] = counts["flash"], counts["decode"]
    total["dense_l4"] = counts["dense"]
    for key in GMM_KEYS:
        total[key] = counts["gmm"]
    firsts[l4.name] = (l4, first)
    readings.append(profile_served(torch, engine, l4, context=1024, prefill_len=2048))
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
    torch.cuda.empty_cache()

    # phase 7: the rest of the dense catalogue at full width, then the
    # roofline fraction of every served step and --sim
    counts, more, more_firsts = catalogue_run(torch, dev)
    total.update(counts)
    readings += more
    firsts.update(more_firsts)
    log("phase 7 (c): the roofline fraction of every served decode step and prefill "
        "(memory_model and model_flops over the H100 SXM datasheet's 3.35 TB/s and "
        f"989 TFLOP/s; card {smi})")
    roofline_fractions(readings)
    sim_run(firsts)

    # phase 8: the paper's workflow (tiny-YOLOv2, whisper-tiny, granite)
    t8 = time.perf_counter()
    log(f"phase 8 (a): tiny-YOLOv2 at {YOLO_SIDE}x{YOLO_SIDE}, float32, on the card against "
        "the port's CPU forward of the same weights")
    yolo_run(torch, dev)
    wh_counts = whisper_run(torch, dev)
    for key in ("flash_enc", "flash_cross"):
        total[key] = wh_counts["flash"]
    total["dense_cross"] = wh_counts["dense"]
    log("phase 8 (c): the workflow twin (repro_torch.examples.workflow_pipeline, as "
        "registered) through Gateway.submit_workflow -> EngineBackend on the card")
    wf_counts = workflow_run(torch)
    for key, row in (("flash", "flash_enc"), ("decode", "decode")):
        entries[f"{row}_workflow"] = dict(entries[row], name=entries[row]["name"] + ", via Workflow")
        total[f"{row}_workflow"] = wf_counts[key]
    log(f"phase 8: done in {time.perf_counter() - t8:.1f} s")

    kernels = []
    for key in ("decode", "chunk", "chunk_768", "flash", "flash_rg", "dense_rg", "dense_granite",
                "scan", "flash_l4", "decode_l4", "dense_l4", *GMM_KEYS, "flash_gateway",
                "decode_gateway", "flash_cp", "decode_cp", "flash_sim", "decode_sim",
                "flash_cluster", "decode_cluster", "flash_qwen", "decode_qwen", "chunk_qwen",
                "chunk_qwen_768", "dense_qwen", "flash_ds", "decode_ds", "flash_enc",
                "flash_cross", "dense_cross", "flash_enc_workflow", "decode_workflow"):
        e = dict(entries[key])
        e["launches"] = total[key]
        kernels.append({k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "event_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "ms_over_library_ms")})
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
