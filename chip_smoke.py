#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. Device and build: the card's name and power limit (nvidia-smi), then
   every kernel of the paths built from ``src/repro_torch/csrc`` with nvcc
   (one process per source, in parallel), with each instance's registers,
   spills and static shared memory from ptxas, and its count of
   tensor-core instructions (HMMA, HGMMA) from ``cuobjdump -sass``; the
   bf16 instances of K2, K1's chunks (the prefill body they share), K4 and
   the split decode body (K1 decode, K3) must have some, and every bf16
   instance of K2's and K4's backward (their wgmma bodies) HGMMA (Hopper's
   warpgroup products), with no spill.
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
   K3 for the cross decode (B=8, L = kv_len = 1500); at llava-next-34b's
   widths (H=56 KV=8, G = 7, hd 128; phase 9 (b)'s shapes) K2 over 2880
   patches + 128 tokens (S = 3008, causal), K3 on the dense layout (B=2,
   L = 3024, kv_len 3009 and 3024) and K1 decode (B=8, kv_len 1..1024);
   K4 the grouped matmul at the MoE path's shapes (llama4 prefill gate/up
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
   8500 (past the 8192-token chunk). 32 new tokens each. Each
   configuration is served twice, each time from a cold start of the same
   seed: with the engine's step graphs off (every decode and chunk step
   eager), then on (each step captured once per shape signature as a
   CUDA graph and replayed); the captured run's tokens must equal the
   eager run's. Launch counts are zeroed before each run and must grow
   for every kernel of that run's path (K4 on llama4's); a replay adds
   the launches its capture recorded, and each graph's kernel nodes are
   held equal to them when it is captured. The captured run's counts
   must equal the eager run's, kernel by kernel, and are the ones the
   ``kernels`` line reports (the main path). Cold start, TTFT, decode
   ms/step, tokens/s, the host-clock roofline fraction, the graph count,
   capture ms and the graphs' pool, and profiles of a decode step (eager
   and captured: profiler busy and a CUDA-event span), of the
   unembedding (bf16 operands into float32 logits, beside the float32
   upcast it replaced) and of a prefill (with the shares of K2, K5 and K1
   chunk), and of granite's chunked prefill of one 1024-token prompt
   through the engine (eager and captured).
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
   recurrentgemma, llama4-scout at 8 layers, qwen, deepseek), eager and
   captured, the analytic memory bound
   (``roofline.analytic.memory_model`` in bf16 over the datasheet's 3.35
   TB/s) over the step's host-clock time (without the profiler), over
   its device busy time (under it) and over its CUDA-event span, and each profiled
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
   ``--reduced`` on ``--backend engine`` (the captioner's decode steps
   captured): ``Gateway.submit_workflow`` ->
   ``EngineBackend`` -> tiny-YOLOv2 on 4 images, whisper-tiny and the
   granite-3-2b captioner (paged), twice: the first workflow cold-starts
   each runtime, the second is warm and gives the same step results; each
   step's ELat and cold start beside the paper's K600 / NCS medians (1675
   / 1577 ms, the paper's testbed); its launches (K2 and K1 decode, counted
   from the two workflows alone) are the ``..., via Workflow`` entries.

9. The catalogue's last one-card families, printed under ``phase 9``
   after phase 8: (a) xlstm-350m as registered (24 layers = 3 x (1 sLSTM
   + 7 mLSTM), d 1024, 4 heads, mLSTM inner 2048 at head dim 512, sLSTM
   head dim 256 and post-MLP 1360, vocab 50304 untied; bf16, 8 slots,
   max_len 2048), served through ``make_serve_runtime`` paged
   whole-prompt, paged with 256-token chunks and dense, each eager then
   captured (2 prompts of 1000 and 1024 tokens, 32 new tokens): captured
   tokens equal eager ones, paged tokens equal dense ones, and no kernel
   of K1-K5 launches anywhere in (a) (the xLSTM blocks have none); its
   parameters and state, a B=8 decode step's bytes by my reckoning beside
   ``roofline.analytic.memory_model``'s; cold start, TTFT, decode ms/step,
   tokens/s, graphs, capture ms and pool MiB eager and captured; a B=8
   decode step profiled (host, busy, event span, kernel classes) and the
   1024-token prefill (host against busy); then a float32 copy at full
   width cut to the pattern's first 8 layers against its CPU forward of
   the same weights (prefill of 600 tokens and 8 greedy decode steps,
   within 1e-4 x max|logit|) and its 256-token chunked prefill against its
   whole prefill (last logits and every state leaf, rtol = atol = 1e-4);
   (b) llava-next-34b at every registered width, cut from 60 to 40 layers
   (45.6 GB of bf16 weights): after every earlier phase's models and
   graphs are freed (the free memory printed), B=2 prompts of 128 tokens
   behind 2880 random patch embeddings through ``prefill`` (K2 at S =
   3008, G = 7) and 16 greedy ``decode_step``s on the dense cache at
   positions 2880 + t (K3), each launch count exactly one a layer a call;
   the logits move when the patches move; one served run through the
   paged engine, text-only, captured (K2 and K1 decode, one a layer a
   call); the bf16 logits against ``impl="ref"`` with the patches (phase
   4's rule); prefill ms and MFU, decode ms/step against its memory
   bound, the peak. Its launches are the llava rows of the ``kernels``
   line, the engine's K2 under ``..., via ServingEngine``.

10. Training on the card, printed under ``phase 10`` after phase 9: (a)
   the training path's kernels against their plain versions in bf16 and
   float32: K2's forward with its log-sum-exp (output at phase 2's
   tolerance, the log-sum-exp at 1e-5, bit for bit against the launch
   without it) and K2's backward (``csrc/flash_attention_bwd.cu``, its dQ
   and dK/dV passes; tolerance x max|ref|, and each 256-row slab of the
   sequence by its own relative error) at granite-3-2b's training shape
   (B=4 S=2048 H=32 KV=8 hd 64, causal) and recurrentgemma-2b's (B=1
   S=3072 H=10 KV=1 hd 256, window 2048), with Sq < Skv, a ragged
   S=1000, G=1 and a chunk mask at hd 128, two backward launches bit for
   bit; K5's forward and backward (``csrc/rglru_scan_bwd.cu``) at B=1
   S=3072 D=2560 with and without h0, held to 0 error; their event times
   beside bound, plain and the library's (SDPA's forward and backward);
   (b) one train step through the kernels against the same step with
   ``impl="ref"``, granite at full width cut to 4 layers (B=2 S=2048) and
   recurrentgemma's first period (R, R, A; S=3072), bf16 (loss 1e-3, each
   leaf's gradient 2e-2 relative norm) and float32 (1e-5, 1e-4), no
   leaf's gradient zero or missing; (c) granite-3-2b at full width and
   depth through the launcher's pieces (``repro_torch.launch.train``):
   B=4 S=2048, 6 steps, remat on, the loss finite every step, s/step (the
   window's rate: the unprofiled steps' host time over their count, the
   median beside it; each step's gc time and cudaMalloc calls and
   retries), tokens/s and MFU (model FLOPs over 989 TFLOP/s) from that
   rate, peak memory, the last step profiled (host against device busy,
   and each kernel's device ms per call: the ``ms`` of the training
   rows), each step's launches the reckoning's (80 K2 forward, 40 K2
   backward, nothing else), then one batch repeated 4 steps at lr 1e-3
   with a falling loss; (d) recurrentgemma-2b at full width and depth,
   B=1 S=3072, 4 steps, the same readings (16 K2 forward, 8 backward, 34
   K5 forward, 18 backward a step); (e) the trained granite parameters
   through ``train.checkpoint`` save / restore bit for bit, and K1 (decode
   and chunk) and K3, which have no backward kernel, raising under
   autograd on the card (and running under ``torch.no_grad()``); (f) K4's
   backward (``csrc/moe_gmm_bwd.cu``: dX = dY W[e]^T and dW[e] = X_e^T
   dY_e) against ``ref.moe_gmm_bwd`` in bf16 and float32 at llama4-scout's
   training shapes (4096 rows of a top-1 routing over 16 experts; gate/up
   K=5120 N=8192, down K=8192 N=5120) and its edges (an empty group, a
   one-row group, rows past the total, one expert, K and N off the
   tiles): dX within ``gmm_tol`` of max|ref|, each expert's dW within it
   of its own, empty groups and uncovered rows exactly zero, two
   launches bit for bit, K4's forward at the same shapes; the bf16
   kernel's device ms, events, bound (bytes over 3.35 TB/s, operations over 989
   TFLOP/s), the plain version's ms and ``torch._grouped_mm``'s for the
   same dX and dW (checked to compute it first; timed only); (g) a
   llama4-scout ``.reduced()`` train step through K2, K4 and their
   backward kernels against ``impl="ref"`` (float32, and bf16 with the
   expert choices shared) and against the CPU (float32), and grok-1
   ``.reduced()`` (top-2, two checkpointed periods) under
   ``remat_policy="dots"`` against ``remat=True`` on the card; (h)
   llama4-scout-17b-a16e at every published width cut from 48 to 2
   layers (ATTN, CHUNKED_ATTN; 5.19 B parameters), bf16 with float32
   AdamW state, B=2 S=2048, 5 steps through the launcher's pieces with
   (c)'s readings (MFU from the active parameters: top-1 of 16 experts),
   each step's launches the reckoning's (2 K2 forward and backward, 6 K4
   forward and backward: both layers are remainder layers of the 4-layer
   pattern, outside the checkpoint), the repeated batch's loss falling
   at lr 1e-4 (at 1e-3 it rose).
   Its launches are the ``..., via train`` and ``flash_attention_bwd`` /
   ``rglru_scan_bwd`` / ``moe_gmm_bwd`` rows of the ``kernels`` line.
   Phase 1 holds the backward's bf16 instances
   (``flash_attention_bwd_{dq,dkv}_wgmma_kernel`` at hd 64, 128 and 256,
   ``moe_gmm_bwd_{dx,dw}_wgmma_kernel``: warp-specialised, TMA-fed wgmma)
   to HGMMA in every instance and no spill. (a) and (f) print each bf16
   backward's profiler ms called alone (K2: also per pass) and its
   CUDA-event ms beside the bound and the library's ms.

11. int8 weights and int8 K/V caches, printed under ``phase 11`` after
   phase 10: (a) K1's int8 instances (decode: the split body's FMA
   instance over int8 keys; bf16 chunks: the tensor-core body staging
   int8 tiles and widening them in shared memory; float32 chunks: the
   tiled body) at granite's widths (B=8 kv_len 1..1024; C=256 at q_offset
   256 and 768) and qwen's (H 40, KV 8, hd 128), and K3 on int8 caches
   with no scales (bit for bit the launch with ones) at recurrentgemma's
   ring and granite's dense cache, against their plain versions (bf16
   and float32 queries, K/V drawn N(0, 40^2) and narrowed; phase 2's
   tolerance x max|ref|), then each bf16 row's times, its bound at int8
   K/V bytes and SDPA's over the widened keys; (b) ``kv_dtype="int8"`` at
   the model's API, granite-3-2b at full width and depth with wk x 2 and
   wv x 40 (V spans int8's range, some values saturate): 8 prompts of
   1024 tokens in 256-token chunks into an int8 paged pool and 32 decode
   steps, the same prompts prefilled whole into a dense int8 cache and 32
   steps, and recurrentgemma-2b's int8 rings over 2100-token prompts and
   16 steps, each against ``impl="ref"`` teacher-forced (phase 4's rule),
   the decode step's device busy beside a bf16 pool's, the pool's bytes;
   at wk x 40 (K saturates too) the first layer held the same way, the
   first 4 and all 40 read, not held, on an int8 pool beside a bf16 pool
   with the K entries the two int8 pools differ in a layer; qwen2.5-14b
   at full width and depth on an int8 paged pool (1024-token prompts in
   256-token chunks, 8 steps: K1's hd-128 int8 instances) held the same
   way; (c) granite-3-2b's int8 weights
   (``narrow_weights``) through ``ServingEngine``, paged and captured:
   prefill logits bit for bit those of the host-dequantized bf16 tree,
   which the same engine serves to the same tokens; greedy tokens beside
   the engine's ``impl="ref"`` run, the teacher-forced logits against it;
   peak GB, TTFT p50 and decode ms/step of both trees; (d) llava-next-34b
   at all 60 layers from int8 weights made a slice at a time, text-only,
   paged, B=2, captured: peak GB, TTFT, decode ms/step against its memory
   bound at int8 weights, logits against ``impl="ref"`` at the first
   decode step; (e) one ``Gateway.invoke`` through ``EngineBackend``
   priced by ``AcceleratorSpec(type="h100", active_watts=<power
   limit>)``, its energy counter against active_watts x ELat; (f) the
   engine example twins (``repro_torch.examples.unified_gateway``,
   ``serve_cluster``, ``cluster_quickstart``) as subprocesses on the card,
   each ending with its reference's last line. Its launches are the int8
   rows of the ``kernels`` line, each read from (b)'s run of its own
   widths; (c) and (d) run the same K2 and K1 decode instances as bf16
   weights (the activations stay bf16) and log their launches beside their
   times. Phase 1 also holds every ``paged_prefill_mma_kernel`` instance
   (bf16 and int8 K/V) to HMMA and no spill.

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
# llava-next-34b (G = 7, hd 128): B=2 prompts of 128 tokens behind 2880
# patch embeddings, 16 decode steps on the dense cache
LV_H, LV_KV, LV_HD, LV_PATCHES, LV_PROMPT, LV_STEPS, LV_B = 56, 8, 128, 2880, 128, 16, 2
LV_CACHE = LV_PATCHES + LV_PROMPT + LV_STEPS
LV_KV_LEN = [LV_PATCHES + LV_PROMPT + 1, LV_CACHE]


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
# the bf16 tensor-core bodies held to no spill (their float32 sums are sized
# to the register file), with their instance counts and the instruction
# every instance must hold: K2's backward (its dQ pass at each head dim,
# its dK/dV pass at hd 64 and 128 and, at hd 256, its dV and dK halves) and
# K4's dX and dW on wgmma; K1's chunks (hd 64, 128 and 256, bf16 and int8
# K/V) on mma.sync
NO_SPILL_KERNELS = {"flash_attention_bwd_dq_wgmma_kernel": (3, "HGMMA"),
                    "flash_attention_bwd_dkv_wgmma_kernel": (4, "HGMMA"),
                    "moe_gmm_bwd_dx_wgmma_kernel": (1, "HGMMA"),
                    "moe_gmm_bwd_dw_wgmma_kernel": (1, "HGMMA"),
                    "paged_prefill_mma_kernel": (6, "HMMA")}
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


def check_no_spill(build) -> None:
    """Raise if a ``NO_SPILL_KERNELS`` instance spills (ptxas's report),
    or if the reports hold other counts of instances than it names."""
    seen = collections.Counter()
    for name in build.KERNELS:
        for line in ptxas_summary(build.ptxas_report(name)):
            kernel = next((k for k in NO_SPILL_KERNELS if line.startswith(k)), None)
            if kernel:
                seen[kernel] += 1
                if " 0 bytes spill stores" not in line:
                    raise AssertionError(f"a bf16 tensor-core instance spills: {line}")
    want = collections.Counter({k: n for k, (n, _) in NO_SPILL_KERNELS.items()})
    if seen != want:
        raise AssertionError(f"instances in the ptxas reports {dict(seen)}, expected "
                             f"{dict(want)} (built elsewhere?)")


def check_tensor_cores(build) -> None:
    """Log every kernel instance's HMMA / HGMMA count; raise unless every
    bf16 instance of ``MMA_KERNELS`` (K2, K1 chunk, K4, the split decode
    body of K1 decode and K3) has some, and unless every instance of
    ``NO_SPILL_KERNELS`` holds the instruction it names (HGMMA: K2's and
    K4's backward; HMMA: K1's chunks), as many instances as it names."""
    tool = cuobjdump_path()
    seen = {}
    for name in build.KERNELS:
        for kernel, (hmma, hgmma) in sass_mma_counts(tool, build.library_path(name)).items():
            log(f"  sass {kernel}: {hmma} HMMA, {hgmma} HGMMA")
            seen[kernel] = (hmma, hgmma)
    for want in MMA_KERNELS:
        found = {k: sum(n) for k, n in seen.items() if k.startswith(want)}
        if not found or not all(found.values()):
            raise AssertionError(f"{want}: no tensor-core instruction in "
                                 f"{found or 'no instance'}")
    for want, (count, instr) in NO_SPILL_KERNELS.items():
        found = {k: n[instr == "HGMMA"] for k, n in seen.items() if k.startswith(want)}
        if len(found) != count or not all(found.values()):
            raise AssertionError(f"{want}: {count} instances with {instr} expected, found "
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
    from repro_torch.kernels import build, decode_attention as da
    B, _, n_heads, _ = q.shape
    n = da.split_plan(B, n_kv, n_heads // n_kv, capacity, build.sm_count(q.device.index))
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


def phase_kernels_llava(torch, dev):
    """Phase 2 at llava-next-34b's widths (H=56 KV=8, G = 7, hd 128;
    phase 9 (b)'s shapes): K2 over a prefill of 2880 patches and 128
    tokens (S = 3008, causal), K3 on the dense layout after it (B=2,
    L = 3024, kv_len 3009 and 3024) and K1 decode (B=8, kv_len 1..1024),
    the first paths that run a group of 7."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(31)
    up = lambda *ts: [t.float() for t in ts]  # noqa: E731
    nh, nkv, hd, S = LV_H, LV_KV, LV_HD, LV_PATCHES + LV_PROMPT
    errs = {k: [] for k in ("flash_llava", "dense_llava", "decode_llava")}
    log(f"phase 2: llava-next-34b's widths (H={nh} KV={nkv}, G={nh // nkv}, hd={hd}; "
        f"a prefill of {LV_PATCHES} patches + {LV_PROMPT} tokens)")
    for dtype in ("bfloat16", "float32"):
        t = lambda shape: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape).astype(np.float32)).to(dev, getattr(torch, dtype))
        q, k, v = t((1, S, nh, hd)), t((1, S, nkv, hd)), t((1, S, nkv, hd))
        check(f"K2 flash llava S={S} H={nh} KV={nkv} hd={hd} causal", dtype,
              fa.flash_attention(q, k, v), ref.flash_attention(*up(q, k, v)).to(q.dtype),
              errs["flash_llava"])
        del q, k, v
        q, k, v, kl = decode_inputs(torch, rng, dev, dtype, nh, nkv, hd, S=LV_CACHE,
                                    kv_len=LV_KV_LEN)
        check(f"K3 decode llava dense B=2 L={LV_CACHE} H={nh} KV={nkv} kv_len={LV_KV_LEN}",
              dtype, da.decode_attention(q, k, v, kl),
              ref.decode_attention(*up(q, k, v), kl).to(q.dtype), errs["dense_llava"])
        q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, QW_KV_LEN, 1, (nh, nkv, hd))
        check(f"K1 decode llava H={nh} KV={nkv} hd={hd} kv_len={QW_KV_LEN}", dtype,
              pa.paged_decode_attention(q, kp, vp, bt, kl),
              ref.paged_decode_attention(*up(q, kp, vp), bt, kl).to(q.dtype),
              errs["decode_llava"])
        del q, k, v, kp, vp
    torch.cuda.synchronize()

    log("phase 2: times at llava-next-34b's shapes, bf16 (kernel: profiler device time; "
        "plain and library: CUDA events per call)")
    entries = {}
    dtype, isz = "bfloat16", 2
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = t((1, S, nh, hd)), t((1, S, nkv, hd)), t((1, S, nkv, hd))
    b, by = bound_ms(isz * (2 * q.numel() + k.numel() + v.numel()),
                     4 * hd * S * (S + 1) // 2 * nh, dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    entries["flash_llava"] = dict(
        name="flash_attention (hd 128 G=7, llava-next-34b)", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:27",
        shape=f"B=1 S={S} H={nh} KV={nkv} hd={hd} causal bf16",
        **kernel_times(torch, lambda: fa.flash_attention(q, k, v),
                       "flash_attention_mma_kernel", iters=10),
        plain_ms=event_ms(torch, lambda: ref.flash_attention(q, k, v), 2, warmup=1),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True), 10),
        library="SDPA")
    del q, k, v, qt, kt, vt
    q, k, v, kl = decode_inputs(torch, rng, dev, dtype, nh, nkv, hd, S=LV_CACHE,
                                kv_len=LV_KV_LEN)
    n_kv = sum(LV_KV_LEN)
    b, by = bound_ms(isz * (2 * q.numel() + 2 * n_kv * nkv * hd) + 4 * kl.numel(),
                     4 * hd * nh * n_kv, dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lmask = (torch.arange(k.shape[1], device=dev)[None] < kl[:, None])[:, None, None]
    entries["dense_llava"] = dict(
        name="decode_attention (llava-next-34b dense, hd 128 G=7)", route="cuda",
        source="src/repro_torch/csrc/decode_common.cuh",
        replaces="src/repro/kernels/decode_attention.py:31",
        shape=f"B=2 L={LV_CACHE} H={nh} KV={nkv} hd={hd} kv_len {LV_KV_LEN} "
              f"{n_split(torch, q, nkv, k.shape[1])} bf16",
        **kernel_times(torch, lambda: da.decode_attention(q, k, v, kl), SPLIT_DECODE),
        plain_ms=event_ms(torch, lambda: ref.decode_attention(q, k, v, kl), 10),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=lmask,
                                                 enable_gqa=True), 20),
        library="SDPA, length mask")
    q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, QW_KV_LEN, 1, (nh, nkv, hd))
    n_kv = sum(QW_KV_LEN)
    b, by = bound_ms(isz * (2 * q.numel() + 2 * n_kv * nkv * hd) + 4 * (bt.numel() + 8),
                     4 * hd * nh * n_kv, dtype)
    entries["decode_llava"] = dict(
        name="paged_decode_attention (hd 128 G=7, llava-next-34b)", route="cuda",
        source="src/repro_torch/csrc/decode_common.cuh",
        replaces="src/repro/kernels/decode_attention.py:135",
        shape=f"B=8 kv_len={QW_KV_LEN} H={nh} KV={nkv} hd={hd} page={PAGE} "
              f"{n_split(torch, q, nkv, bt.shape[1] * PAGE)} bf16",
        **kernel_times(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, kl),
                       SPLIT_DECODE),
        plain_ms=event_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, bt, kl), 10),
        bound_ms=b, bound_by=by,
        library_ms=event_ms(torch, paged_sdpa(torch, q, kp, vp, bt, kl), 20),
        library="SDPA, length mask, keys gathered to a contiguous copy before timing")
    del q, k, v, kp, vp, qt, kt, vt, lmask
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
            "scan": rs.rglru_scan, "gmm": gm.moe_gmm,
            "flash_bwd": fa.flash_attention_bwd, "scan_bwd": rs.rglru_scan_bwd,
            "gmm_bwd": gm.moe_gmm_bwd}


def launches():
    return {k: f.launches for k, f in _counters().items()}


def zero_launches() -> None:
    for f in _counters().values():
        f.launches = 0


def serve_run(torch, cfg, dev, *, page_size, prefill_chunk, max_len, prompt_lens,
              need, absent=(), graphs=True):
    """Cold start, then events of 2 prompts each (``prompt_lens`` in
    pairs: the first event alone, then the rest as one micro-batch; 4
    events for 8 lengths) through the runtime front door, the engine's decode
    and chunk steps captured (``graphs``) or eager. Launch counts are
    zeroed just before the events and read just after: every kernel of
    ``need`` must have launched and none of ``absent``. Returns the
    engine, the counts, the first event's ELat (host clock; its result
    is read on the host) with its prompt lengths, and every request's
    tokens."""
    from repro_torch.core.runtime import run_batch
    from repro_torch.serve.api import make_serve_runtime

    rdef = make_serve_runtime(cfg, page_size=page_size, max_slots=8, max_len=max_len,
                              max_batch=4, prefill_chunk=prefill_chunk, seed=0,
                              device=dev, graphs=graphs)
    t0 = time.perf_counter()
    engine = rdef.setup()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab, size=n).tolist() for n in prompt_lens]
    events = [{"prompts": prompts[i:i + 2]} for i in range(0, len(prompts), 2)]
    config = {"handle": engine, "max_new_tokens": MAX_NEW}

    zero_launches()
    t0 = time.perf_counter()
    results = run_batch(rdef, events[:1], config)          # one event alone
    first = dict(elat_s=time.perf_counter() - t0, prompt_lens=prompt_lens[:2])
    if events[1:]:
        results += run_batch(rdef, events[1:], config)     # a micro-batch of 3
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
    step_ms = engine.decode_s / engine.n_decode_steps * 1e3
    # the steps decode all 8 rows at the prompts' mean length plus half the
    # new tokens, about
    context = int(np.mean(prompt_lens)) + MAX_NEW // 2
    bound = decode_bound_ms(cfg, engine.max_slots, context)
    log(f"  page_size={page_size} prefill_chunk={prefill_chunk} graphs "
        f"{'on' if graphs else 'off'}: cold start {cold_s:.3f} s; {len(outs)} requests, "
        f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; TTFT p50 "
        f"{ttft[len(ttft) // 2] * 1e3:.1f} ms max {ttft[-1] * 1e3:.1f} ms; decode "
        f"{step_ms:.2f} ms/step over {engine.n_decode_steps} steps, roofline fraction "
        f"(host clock) {bound / step_ms:.4f} (bound {bound:.3f} ms at B={engine.max_slots}, "
        f"context ~{context}); launches {counts}; stats {engine.stats()}")
    log(f"  {graphs_summary(torch, engine)}")
    return engine, counts, first, outs


def decode_bound_ms(cfg, batch: int, context: int) -> float:
    """A decode step's memory bound: ``memory_model`` in bf16 over the
    datasheet's HBM rate."""
    from repro_torch.configs import InputShape
    from repro_torch.roofline.analysis import HBM_BW
    from repro_torch.roofline.analytic import memory_model
    shape = InputShape("serve_decode", context, batch, "decode")
    return memory_model(cfg, shape, data=1, model=1) / HBM_BW * 1e3


def pool_bytes(torch, pool) -> int:
    """Bytes the caching allocator holds in a graph memory pool (its
    segments in ``memory_snapshot``)."""
    if pool is None:
        return 0
    return sum(sg["total_size"] for sg in torch.cuda.memory_snapshot()
               if tuple(sg["segment_pool_id"]) == tuple(pool))


def graphs_summary(torch, engine) -> str:
    """The engine's step programs: captured graphs, their kernel nodes, the
    capture's host time and the graphs' memory pool."""
    g = engine.step_graphs
    if not g.capture:
        return f"step graphs off: {len(g.programs)} eager step programs"
    nodes = sorted(p.kernel_nodes for p in g.programs.values())
    return (f"step graphs on: {g.n_graphs} graphs {sorted(g.programs)}, kernel nodes each "
            f"{nodes[0] if nodes else 0}..{nodes[-1] if nodes else 0} (held equal to the "
            f"launches recorded), captured in {g.capture_s * 1e3:.1f} ms of host time, "
            f"pool {pool_bytes(torch, g.pool) / 2**20:.1f} MiB")


def serve_pair(torch, cfg, dev, *, context=None, prefill_len=None, chunked_len=None, **kw):
    """``serve_run`` with the engine's step graphs off, then on, each on a
    fresh engine from the same seed (the eager one dropped first): both
    runs' checks, and the captured run's tokens must equal the eager
    run's. With ``context`` each engine's decode step is profiled
    (``profile_decode``) and the captured engine's unembedding timed and
    its ``prefill_len``-token prefill profiled; with ``chunked_len`` each
    engine's chunked prefill of one prompt that long. The two runs serve
    the same steps, so the captured run (replays counted) must launch
    every kernel as often as the eager one. Returns the captured engine,
    the captured run's launch counts (the main path's), its first event,
    the readings of phase 7 (c) and every request's tokens."""
    engine, counts_e, _, outs_e = serve_run(torch, cfg, dev, graphs=False, **kw)
    reading = {}
    if context:
        reading["eager"] = profile_decode(torch, engine, cfg, context)
    if chunked_len:
        profile_chunked_prefill(torch, engine, cfg, chunked_len)
    engine = None
    torch.cuda.empty_cache()
    engine, counts, first, outs = serve_run(torch, cfg, dev, graphs=True, **kw)
    if outs != outs_e:
        bad = [i for i, (a, b) in enumerate(zip(outs, outs_e)) if a != b]
        raise AssertionError(f"{cfg.name}: the captured steps' tokens differ from the eager "
                             f"steps' in requests {bad}: {[outs[i] for i in bad]} vs "
                             f"{[outs_e[i] for i in bad]}")
    log(f"  captured tokens equal the eager ones ({len(outs)} requests, "
        f"{sum(len(o) for o in outs)} tokens)")
    if counts != counts_e:
        raise AssertionError(f"{cfg.name}: the captured run's launches {counts} differ from "
                             f"the eager run's {counts_e}")
    log(f"  captured launches equal the eager ones: {counts}")
    if context:
        reading["captured"] = profile_decode(torch, engine, cfg, context)
        reading.update(cfg=cfg, batch=engine.max_slots, context=context + 4)
        unembed_times(torch, engine, cfg)
        reading.update(profile_prefill(torch, engine, cfg, prefill_len))
    if chunked_len:
        profile_chunked_prefill(torch, engine, cfg, chunked_len)
    if context or chunked_len:
        log(f"  after the profiles: {graphs_summary(torch, engine)}")
    return engine, counts, first, reading, outs


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


def profile_breakdown(torch, label: str, run, n: int, shares=None, per_launch=None):
    """Profile ``run()`` (``n`` units of work): wall ms per unit, device
    busy ms per unit (kernels and copies on the card), the idle share, the
    host-side op count, the top device consumers and, for each ``shares``
    entry (label: kernel name), that kernel's device ms per unit and share
    of busy, with the launches the profiler recorded beside those its
    wrappers counted. Returns (wall ms, device busy ms, {label: ms}) per
    unit. A ``per_launch`` dict gets, for each ``shares`` label, the device
    ms of one wrapper call: each matching kernel's recorded time over its
    recorded launches, summed over the kernels (a call's passes), or None
    where the profiler recorded none."""
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
        ("K5", "scan"), ("K4", "gmm"), ("K2 bwd", "flash_bwd"), ("K5 bwd", "scan_bwd"),
        ("K4 bwd", "gmm_bwd"))}
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
        if per_launch is not None:
            per_launch[what] = sum(_device_us(e) / e.count for e in evs) / 1e3 if evs else None
        log(f"    share {what}: {ms:.3f} ms of {busy:.2f} ms busy ({ms / busy:.3f}), "
            f"{sum(e.count for e in evs)} launches recorded of {counted[what]} counted")
    return wall, busy, share_ms


# kernel classes by name fragment, the first match wins; the rest is
# other elementwise work (rms_norm's arithmetic, rope, SwiGLU, residuals)
KERNEL_CLASSES = (
    ("K1 decode", ("split_decode", "paged_", "flash_attention", "decode_attention")),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "xmma", "splitKreduce", "gemv", "cublas")),
    ("casts and copies", ("copy_kernel", "Memcpy", "Memset", "CatArrayBatchedCopy")),
    ("indexing", ("index", "scatter", "gather")),
    ("reductions", ("reduce_kernel", "argmax", "softmax")),
)
OTHER = "other elementwise"


def device_by_class(torch, run, n: int) -> dict:
    """Profile ``run()`` (``n`` units): device ms per unit by kernel class
    (``KERNEL_CLASSES``), with ``busy``, the sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in KERNEL_CLASSES}
    out[OTHER] = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        cls = next((name for name, frags in KERNEL_CLASSES
                    if any(f in e.key for f in frags)), OTHER)
        out[cls] += e.self_device_time_total / 1e3 / n
    out["busy"] = sum(out.values())
    return out


PREFILL_SHARES = {"K2": "flash_attention_mma_kernel", "K5": "rglru_scan_kernel",
                  "K4": "moe_gmm_mma_kernel"}


def profile_decode(torch, engine, cfg, context: int):
    """Where a served decode step's time goes: 3 decode steps of a full
    batch (8 slots at ~``context`` tokens; the prompts prefill whole),
    profiled, then 3 more on the host clock alone with CUDA events around
    them (their device span: busy plus the gaps the host leaves). Returns
    the step's ms (host clock), device busy ms (profiler) and event ms."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(5)
    steps = 3
    for i in range(engine.max_slots):
        engine.submit(Request(prompt=rng.integers(3, cfg.vocab, size=context).tolist(),
                              max_new_tokens=2 * steps + 4, req_id=100 + i))
    engine.step()                   # admits and prefills all 8, one decode
    mode = "captured" if engine.step_graphs.capture else "eager"
    _, busy, _ = profile_breakdown(
        torch, f"{cfg.name} decode step (B=8, ~{context} context), {mode}",
        lambda: [engine.step() for _ in range(steps)], steps)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        engine.step()
    end.record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    span_ms = start.elapsed_time(end) / steps
    engine.generate([])             # drain
    log(f"  {cfg.name} decode step {mode} without the profiler: {step_ms:.2f} ms (host "
        f"clock), CUDA-event span {span_ms:.2f} ms; under the profiler busy {busy:.2f} ms"
        + ("" if busy > 0.1 * span_ms else
           " (the profiler recorded less than a tenth of the event span: read the span)"))
    return dict(step_ms=step_ms, busy_ms=busy, span_ms=span_ms)


def profile_prefill(torch, engine, cfg, prefill_len: int):
    """One ``prefill_len``-token prefill (eager), after a warm-up, on the
    host clock alone and then profiled (with the shares of K2, K5, K4)."""
    from repro_torch.models import model as M
    rng = np.random.default_rng(5)
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
    log(f"  {cfg.name} prefill of {prefill_len} tokens without the profiler: "
        f"{prefill_ms:.2f} ms (host clock)")
    return dict(prefill_len=prefill_len, prefill_ms=prefill_ms, prefill_busy_ms=prefill_busy)


def unembed_times(torch, engine, cfg) -> None:
    """The unembedding of a B=8 decode step on the card (CUDA events):
    ``layers.unembed`` (bf16 operands, float32 out, no copy of the vocab
    table) beside the float32 upcast it replaced, on the same inputs, with
    its bound (the bf16 table read once, the float32 logits written once)."""
    from repro_torch.models.layers import unembed
    emb, tie = engine.params["embed"], cfg.tie_embeddings
    w = emb["tok"].t() if tie else emb["head"]
    gen = torch.Generator(device=engine.device).manual_seed(9)
    x = torch.randn(engine.max_slots, 1, cfg.d_model, device=engine.device,
                    generator=gen).to(w.dtype)
    ms = event_ms(torch, lambda: unembed(emb, x, tie), 20)
    up = event_ms(torch, lambda: x.float() @ w.float(), 5)
    n_bytes = w.numel() * w.element_size() + x.shape[0] * w.shape[1] * 4
    log(f"  unembed {cfg.name} B={x.shape[0]}, vocab {w.shape[1]} x d {w.shape[0]} "
        f"{w.dtype}: {ms:.4f} ms (out_dtype float32), the float32 upcast {up:.4f} ms; "
        f"bound {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({n_bytes / 1e9:.3f} GB, bytes)")


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
    # chip_compare.py also times engines of checkouts from before the step
    # graphs, which have no ``step_graphs`` and are eager
    graphs = getattr(engine, "step_graphs", None)
    mode = "captured" if graphs is not None and graphs.capture else "eager"
    for i, what in enumerate(("warm-up", "profiled")):
        engine.submit(Request(prompt=rng.integers(3, cfg.vocab, size=prompt_len).tolist(),
                              max_new_tokens=2, req_id=200 + i))
        run = lambda: [engine.step() for _ in range(n_steps)]  # noqa: E731
        if what == "warm-up":
            run()
        else:
            res = profile_breakdown(
                torch, f"{cfg.name} chunked prefill (1 x {prompt_len} tokens, {n_steps} "
                f"chunks of {engine.prefill_chunk}, the last step decodes once), {mode}",
                run, 1,
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
        forced = queue.popleft().to(top_i.device)   # the plain path may run on the CPU
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


def logits_parity(torch, cfg, params, dev, S, paged, frames=None, patches=None, steps=8):
    """Prefill + ``steps`` decode steps through the kernels and through
    impl="ref", teacher-forced on the kernel path's greedy tokens; the
    decode cache is paged (granite, llama4's global layers) or dense
    per-slot (recurrentgemma, whisper: its prefill also encodes
    ``frames`` (1, F, d) and caches the cross K/V; llava: ``patches``
    (1, P, d) go before the S prompt tokens, which then sit at positions
    P + [0, S)). A MoE model's plain path follows the kernel
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
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(1, S))).to(dev)
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    if patches is not None:
        batch["patches"] = patches
        S += patches.shape[1]       # the decode positions follow the prefix
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
        profiled = page_size and not chunk
        engine, counts, first, reading, _ = serve_pair(
            torch, qw, dev, page_size=page_size, prefill_chunk=chunk, max_len=2048,
            prompt_lens=GRANITE_PROMPTS, need=need,
            absent=["scan", "gmm"] + (["dense"] if page_size else ["decode", "chunk"]),
            context=256 if profiled else None, prefill_len=1024)
        log(f"  {qw.name}: {sum(t.numel() for _, t in iter_leaves(engine.params)) / 1e9:.2f} B "
            f"parameters, {torch.cuda.max_memory_allocated() / 1e9:.1f} GB peak allocated")
        total["flash_qwen"] += counts["flash"]
        total["decode_qwen"] += counts["decode"]
        total["chunk_qwen"] += counts["chunk"]
        total["dense_qwen"] += counts["dense"]
        if profiled:
            firsts[qw.name] = (qw, first)
            readings.append(reading)
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
    engine, counts, first, reading, _ = serve_pair(
        torch, ds, dev, page_size=PAGE, prefill_chunk=0, max_len=2048,
        prompt_lens=GRANITE_PROMPTS, need=["flash", "decode"],
        absent=["chunk", "dense", "scan", "gmm"], context=256, prefill_len=1024)
    log(f"  {ds.name}: {sum(t.numel() for _, t in iter_leaves(engine.params)) / 1e9:.2f} B "
        f"parameters, {torch.cuda.max_memory_allocated() / 1e9:.1f} GB peak allocated")
    total["flash_ds"], total["decode_ds"] = counts["flash"], counts["decode"]
    firsts[ds.name] = (ds, first)
    readings.append(reading)
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
    measured time on the host clock and over its device busy time, with
    the engine's step graphs off (eager steps) and on (captured steps);
    each profiled prefill's MFU (``model_flops`` over the measured time at
    the datasheet's bf16 peak). Readings, not gates."""
    from repro_torch.configs import InputShape
    from repro_torch.roofline.analysis import PEAK_FLOPS, model_flops
    for r in readings:
        cfg = r["cfg"]
        bound = decode_bound_ms(cfg, r["batch"], r["context"])
        for mode in ("eager", "captured"):
            d = r[mode]
            log(f"  roofline {cfg.name} ({cfg.n_layers} layers) decode step {mode} "
                f"B={r['batch']} context {r['context']}: memory bound {bound:.3f} ms; "
                f"measured {d['step_ms']:.2f} ms (host clock), fraction "
                f"{bound / d['step_ms']:.4f}; device busy {d['busy_ms']:.2f} ms, fraction "
                f"{bound / d['busy_ms']:.4f}; CUDA-event span {d['span_ms']:.2f} ms, "
                f"fraction {bound / d['span_ms']:.4f}")
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
# phase 9: the catalogue's last one-card families (xLSTM, the VLM prefix)
# ----------------------------------------------------------------------
XL_PROMPTS = [1000, 1024]          # (a): 2 prompts near 1024 tokens
XL_CHECK_LEN = 600                 # float32 checks: two mLSTM chunks (512 + 88)
XL_TOL = 1e-4
LV_LAYERS = 40                     # (b): llava cut from 60 layers to fit


def xlstm_decode_reckoning(cfg, batch: int):
    """(parameters, state bytes, bytes a decode step moves): the bf16
    weights read once, the float32 state (mLSTM C, n, m; sLSTM c, n, h,
    m) read and written once."""
    from repro_torch.models import model as M
    from repro_torch.models.param import iter_leaves
    n_params = sum(int(np.prod(s.shape)) for _, s in iter_leaves(M.param_specs(cfg)))
    state = sum(4 * int(np.prod(s.shape))
                for _, s in iter_leaves(M.cache_specs(cfg, batch, 1)))
    return n_params, state, 2 * n_params + 2 * state


def decode_by_class(torch, engine, cfg, context: int, steps: int = 3) -> None:
    """A full B=8 decode step (8 slots at ``context`` tokens) by kernel
    class (``device_by_class``, as ``chip_compare.py --decode-split``)."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(7)
    for i in range(engine.max_slots):
        engine.submit(Request(prompt=rng.integers(3, cfg.vocab, size=context).tolist(),
                              max_new_tokens=2 * steps + 4, req_id=300 + i))
    engine.step()                   # admits and prefills all 8, one decode
    engine.step()
    split = device_by_class(torch, lambda: [engine.step() for _ in range(steps)], steps)
    engine.generate([])             # drain
    mode = "captured" if engine.step_graphs.capture else "eager"
    log(f"  {cfg.name} decode step (B={engine.max_slots}, ~{context} context), {mode}, "
        f"device ms per step by kernel class: busy {split['busy']:.3f}; " + ", ".join(
            f"{name} {split[name]:.3f}" for name in [n for n, _ in KERNEL_CLASSES] + [OTHER]))


def xlstm_float32_checks(torch, cfg, dev) -> None:
    """A float32 copy at full width cut to the pattern's first 8 layers
    (1 sLSTM + 7 mLSTM): its prefill of ``XL_CHECK_LEN`` tokens and 8
    greedy decode steps on the card against its CPU forward of the same
    weights (within ``XL_TOL`` x max|logit|); then the prompt in 256-token
    chunks on the card against the whole prefill (last logits and every
    state leaf, rtol = atol = ``XL_TOL``)."""
    from repro_torch.models import model as M
    from repro_torch.models.param import iter_leaves, map_tree
    c8 = dataclasses.replace(cfg, n_layers=len(cfg.pattern), dtype="float32")
    params = M.init_model_params(c8, 3, dev)
    host = map_tree(lambda _, t: t.cpu(), params)
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(3, c8.vocab, size=(1, XL_CHECK_LEN)))
    cache_len = XL_CHECK_LEN + 8
    got, cache = M.prefill(c8, params, {"tokens": toks.to(dev)}, cache_len=cache_len)
    want, hcache = M.prefill(c8, host, {"tokens": toks}, cache_len=cache_len)
    errs, scales = [], []
    for i in range(9):
        scale = want.abs().max().item()
        errs.append((got.cpu() - want).abs().max().item())
        scales.append(scale)
        if errs[-1] > XL_TOL * scale:
            raise AssertionError(f"phase 9 (a): float32 {c8.n_layers}-layer logits at step {i} "
                                 f"differ from the CPU forward by {errs[-1]} > {XL_TOL} x {scale}")
        if i == 8:
            break
        tok = torch.argmax(got[:, -1], dim=-1)[:, None]
        pos = torch.tensor([XL_CHECK_LEN + i], dtype=torch.int32)
        got, cache = M.decode_step(c8, params, cache, tok, pos.to(dev))
        want, hcache = M.decode_step(c8, host, hcache, tok.cpu(), pos)
    log(f"  {c8.name} {c8.n_layers} layers float32 ({[k.value for k in c8.pattern]}), full "
        f"width: prefill of {XL_CHECK_LEN} tokens and 8 greedy decode steps on the card "
        f"against the CPU forward: max|logit diff| {max(errs):.3e} (tol {XL_TOL:g} x "
        f"max|logit| {min(scales):.3f}..{max(scales):.3f})")
    full_logits, full = M.prefill(c8, params, {"tokens": toks.to(dev)}, cache_len=cache_len)
    chunked = M.init_cache(c8, 1, cache_len, device=dev)
    table = torch.zeros((1, 64), dtype=torch.int32, device=dev)   # no pool: unused
    for start in range(0, XL_CHECK_LEN, 256):
        logits, chunked = M.prefill_chunk(c8, params, chunked,
                                          toks[:, start:start + 256].to(dev), start, table)
    worst = {}
    for (path, a), (_, b) in zip([("logits", logits[0, -1])] + list(iter_leaves(chunked)),
                                 [("logits", full_logits[0, -1])] + list(iter_leaves(full))):
        worst[path] = ((a - b).abs() - XL_TOL * b.abs()).max().item()
    bad = {p: w for p, w in worst.items() if w > XL_TOL}
    if bad:
        raise AssertionError(f"phase 9 (a): chunked prefill differs from the whole one: {bad}")
    log(f"  chunked prefill ({XL_CHECK_LEN} tokens in chunks of 256) against the whole "
        f"prefill: last logits and {len(worst) - 1} state leaves within rtol = atol = "
        f"{XL_TOL:g} (worst |a - b| - rtol |b|: {max(worst.values()):.3e})")
    del params, host, cache, hcache, full, chunked
    torch.cuda.empty_cache()


def xlstm_run(torch, dev) -> None:
    """Phase 9 (a): xlstm-350m as registered (bf16, 8 slots, max_len
    2048), served through ``make_serve_runtime`` -> ``ServingEngine`` paged
    whole-prompt, paged with 256-token chunks and dense, each eager then
    captured (``serve_pair``: 2 prompts of ``XL_PROMPTS`` tokens, 32 new
    tokens); captured tokens equal eager ones, paged tokens equal dense
    ones, and no kernel of K1-K5 launches anywhere in the phase (the
    xLSTM blocks have none). Then the float32 checks
    (``xlstm_float32_checks``)."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.models import blocks as B
    from repro_torch.roofline.analysis import HBM_BW
    from repro_torch.roofline.analytic import memory_model
    cfg = get_config("xlstm-350m")
    di, nh, mhd = B._mlstm_dims(cfg)
    _, shd, ffi = B._slstm_dims(cfg)
    log(f"phase 9 (a): {cfg.name} as registered: {cfg.n_layers} layers pattern "
        f"{[k.value for k in cfg.pattern]} x {cfg.n_layers // len(cfg.pattern)}, d={cfg.d_model}, "
        f"{nh} heads, mLSTM inner {di} at head dim {mhd}, sLSTM head dim {shd} and post-MLP "
        f"{ffi}, vocab {cfg.padded_vocab} untied, {cfg.dtype}, random weights (seed 0)")
    n_params, state, n_bytes = xlstm_decode_reckoning(cfg, 8)
    context = sum(XL_PROMPTS) // len(XL_PROMPTS) + MAX_NEW // 2
    mm = memory_model(cfg, InputShape("serve_decode", context, 8, "decode"), data=1, model=1)
    log(f"  {n_params / 1e6:.1f} M parameters ({2 * n_params / 1e9:.3f} GB bf16); state "
        f"{state / 8 / 2**20:.1f} MiB a slot, {state / 2**20:.1f} MiB at 8 slots; a B=8 "
        f"decode step reads the weights once and reads and writes the state once: "
        f"{n_bytes / 1e9:.3f} GB, bound {n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; "
        f"roofline.analytic.memory_model: {mm / 1e9:.3f} GB, bound {mm / HBM_BW * 1e3:.3f} ms "
        "(it counts the mLSTM state read and written, the activations and the logits, "
        "not the sLSTM state)")
    # each served run zeroes the counts and checks its own window
    # (``absent``); the counts in between (profiles, checks) add up here
    zero_launches()
    seen = collections.Counter()
    outs = {}
    for page_size, chunk in ((PAGE, 0), (PAGE, 256), (0, 0)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seen.update(launches())
        profiled = page_size and not chunk
        t0 = time.perf_counter()
        engine, _, _, _, outs[(page_size, chunk)] = serve_pair(
            torch, cfg, dev, page_size=page_size, prefill_chunk=chunk, max_len=2048,
            prompt_lens=XL_PROMPTS, need=[], absent=list(_counters()),
            context=64 if profiled else None, prefill_len=1024)
        if profiled:
            decode_by_class(torch, engine, cfg, 64)
        log(f"  {cfg.name} page_size={page_size} prefill_chunk={chunk}: "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak allocated; served "
            f"eager and captured{' and profiled' if profiled else ''} in "
            f"{time.perf_counter() - t0:.1f} s")
        engine = None
    if outs[(PAGE, 0)] != outs[(0, 0)]:
        raise AssertionError(f"phase 9 (a): paged tokens {outs[(PAGE, 0)]} differ from dense "
                             f"tokens {outs[(0, 0)]}")
    log(f"  paged tokens equal dense tokens ({len(outs[(0, 0)])} requests)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    xlstm_float32_checks(torch, cfg, dev)
    log(f"  the float32 checks took {time.perf_counter() - t0:.1f} s")
    seen.update(launches())
    counts = {k: seen[k] for k in _counters()}
    if any(counts.values()):
        raise AssertionError(f"phase 9 (a): kernel launches {counts} on the xLSTM paths")
    log(f"  launches of K1-K5 over the whole of phase 9 (a): {counts} (all zero, as held)")


def llava_run(torch, dev):
    """Phase 9 (b): llava-next-34b at every registered width, cut from 60
    to ``LV_LAYERS`` layers (bf16). B=2 prompts of ``LV_PROMPT`` tokens
    behind ``LV_PATCHES`` random patch embeddings through ``prefill``
    (K2 at S = 3008, G = 7) and ``LV_STEPS`` greedy ``decode_step``s on
    the dense cache at positions n_patches + t (K3), each launch count
    exactly one a layer a call; the logits move with the patches; a
    served run through the paged engine, text-only, captured (K2 and K1
    decode, again one a layer a call); then bf16 logits against
    ``impl="ref"`` with the patches (phase 4's rule). Returns the launch
    counts by kernel entry."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.models import model as M
    from repro_torch.models.param import iter_leaves
    from repro_torch.roofline.analysis import PEAK_FLOPS, model_flops
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.step_graph import empty_cache
    reg = get_config("llava-next-34b")
    cfg = dataclasses.replace(reg, n_layers=LV_LAYERS)
    empty_cache()
    free, total_mem = torch.cuda.mem_get_info()
    log(f"phase 9 (b): {cfg.name} cut from {reg.n_layers} to {cfg.n_layers} layers, every "
        f"width as registered: d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
        f"d_ff={cfg.d_ff} vocab {cfg.padded_vocab} tied, rope theta {cfg.rope_theta:g}, "
        f"{cfg.n_patches} patches, {cfg.dtype}, random weights (seed 0); card memory free "
        f"before the cold start {free / 1e9:.1f} of {total_mem / 1e9:.1f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_model_params(cfg, 0, dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in iter_leaves(params))
    log(f"  cold start {cold_s:.2f} s: {n_params / 1e9:.2f} B parameters "
        f"({2 * n_params / 1e9:.1f} GB), {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
        "peak allocated (each stacked leaf drafted in float32)")
    P, L, S = cfg.n_patches, cfg.n_layers, LV_PROMPT
    rng = np.random.default_rng(31)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(LV_B, S))).to(dev)
    patches = torch.from_numpy(rng.standard_normal((LV_B, P, cfg.d_model)).astype(
        np.float32)).to(dev, torch.bfloat16)
    batch = {"tokens": tokens, "patches": patches}
    zero_launches()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, batch, cache_len=LV_CACHE)
    tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    ttft_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = launches()
    t0 = time.perf_counter()
    for i in range(LV_STEPS):
        pos = torch.full((LV_B,), P + S + i, dtype=torch.int32, device=dev)
        logits, cache = M.decode_step(cfg, params, cache, tok[:, None], pos)
        tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / LV_STEPS * 1e3
    counts = launches()
    want = {k: 0 for k in counts}
    want.update(flash=L, dense=L * LV_STEPS)
    if after_prefill != dict(want, dense=0) or counts != want:
        raise AssertionError(f"phase 9 (b): launches after the prefill {after_prefill}, after "
                             f"{LV_STEPS} decode steps {counts}: need {want}")
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (LV_B, 1, cfg.padded_vocab):
        raise AssertionError(f"phase 9 (b): decode logits {tuple(logits.shape)} finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del cache
    prefill_ms = event_ms(torch, lambda: M.prefill(cfg, params, batch, cache_len=LV_CACHE),
                          2, warmup=1)
    flops = model_flops(cfg, InputShape("serve_prefill", P + S, LV_B, "prefill"))
    ideal = flops / PEAK_FLOPS * 1e3
    bound = decode_bound_ms(cfg, LV_B, P + S + LV_STEPS // 2)
    log(f"  prefill B={LV_B} x ({P} patches + {S} tokens): first {ttft_ms:.1f} ms (host "
        f"clock, to the first token), warm {prefill_ms:.2f} ms (CUDA events); "
        f"{flops / 1e12:.2f} TFLOP, compute bound {ideal:.2f} ms, MFU {ideal / prefill_ms:.4f}; "
        f"decode {step_ms:.2f} ms/step over {LV_STEPS} steps (host clock, dense cache of "
        f"{LV_CACHE}), memory bound {bound:.2f} ms, fraction {bound / step_ms:.4f}; launches "
        f"{counts} (one K2 a layer a prefill, one K3 a layer a decode step)")
    moved, _ = M.prefill(cfg, params, {"tokens": tokens, "patches": patches + 1},
                         cache_len=LV_CACHE)
    base, _ = M.prefill(cfg, params, batch, cache_len=LV_CACHE)
    shift = (moved - base).abs().max().item()
    if not shift > 1e-3:
        raise AssertionError(f"phase 9 (b): patches + 1 moved the logits by {shift}")
    log(f"  patches + 1 move the last logits by {shift:.4f} (max |diff|)")
    del moved, base, logits
    torch.cuda.empty_cache()

    zero_launches()
    engine = ServingEngine(cfg, params, max_slots=LV_B, max_len=256, page_size=PAGE,
                           device=dev)
    reqs = [Request(prompt=rng.integers(3, cfg.vocab, size=S).tolist(),
                    max_new_tokens=LV_STEPS, req_id=i) for i in range(LV_B)]
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = launches()
    want = {k: 0 for k in served}
    want.update(flash=L * engine.n_prefills, decode=L * engine.n_decode_steps)
    if len(done) != LV_B or not all(1 <= len(r.output) <= LV_STEPS for r in done) or \
            served != want:
        raise AssertionError(f"phase 9 (b): the served run gave {[r.output for r in done]}, "
                             f"launches {served}: need {want}")
    log(f"  served text-only through the paged engine, captured: {LV_B} prompts of {S} "
        f"tokens, {sum(len(r.output) for r in done)} tokens in {wall:.3f} s; TTFT "
        f"{[round(t * 1e3, 1) for t in engine.ttft_s]} ms, decode "
        f"{engine.decode_s / engine.n_decode_steps * 1e3:.2f} ms/step; launches {served}")
    log(f"  {graphs_summary(torch, engine)}")
    engine = None
    torch.cuda.empty_cache()
    logits_parity(torch, cfg, params, dev, S=S, paged=False, patches=patches[:1])
    log(f"  {cfg.name}: {torch.cuda.max_memory_allocated() / 1e9:.1f} GB peak allocated "
        "over phase 9 (b)")
    del params, patches
    torch.cuda.empty_cache()
    return {"flash_llava": counts["flash"], "dense_llava": counts["dense"],
            "flash_llava_engine": served["flash"], "decode_llava": served["decode"]}


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# phase 10: training on the card
# ----------------------------------------------------------------------
TR_B, TR_S, TR_STEPS = 4, 2048, 6             # granite-3-2b, the launcher's lr
# one batch repeated from a fresh AdamW state, its loss must fall; at 1e-3
# llama4-scout's rose (10.67 -> 17.96 -> 17.00 -> 20.61 on an H100, see
# PERF.md): Adam's first steps move every one of its 5.19 B weights by
# about the rate, so it repeats at a tenth of it. That rise is the model's,
# not the port's: on the CPU the port's MoE steps follow the reference's
# with a batch repeated at 1e-3 (tests/test_torch_train.py::
# test_repeated_batch_matches_reference, llama4-scout and grok-1)
TR_REPEAT_STEPS = 4
TR_REPEAT_LR = {"granite-3-2b": 1e-3, "llama4-scout-17b-a16e": 1e-4}
RG_TR_B, RG_TR_S, RG_TR_STEPS = 1, 3072, 4    # recurrentgemma-2b
# llama4-scout at every published width, cut from 48 to 2 layers (global
# ATTN, then CHUNKED_ATTN): 5.19 B parameters, whose bf16 weights and
# gradients and float32 AdamW state (62.3 GB) leave the activations and
# the 202048-word logits room on one 80 GB card; 4096 rows over 16
# experts, top-1 (256 an expert on average)
L4_TR_LAYERS, L4_TR_B, L4_TR_S, L4_TR_STEPS = 2, 2, 2048, 5
# launches a step with remat per period: K2 forward twice a layer (the
# forward and its recompute), its backward once; recurrentgemma's RG-LRU
# layers: the 16 in checkpointed periods twice, the 2 remainder layers once;
# llama4's 2 layers are both remainder layers of its 4-layer pattern, which
# run outside the checkpoint (as in the reference's), so nothing is
# recomputed: K2 once a layer forward and backward, K4 three times a layer
# (gate, up, down) forward and backward
TR_COUNTS = {"granite-3-2b": {"flash": 80, "flash_bwd": 40},
             "recurrentgemma-2b": {"flash": 16, "flash_bwd": 8, "scan": 34, "scan_bwd": 18},
             "llama4-scout-17b-a16e": {"flash": 2, "flash_bwd": 2, "gmm": 6, "gmm_bwd": 6}}


SLAB = 256   # sequence rows a slab: each held to its own scale


def check_rel(name, dtype, got, want, errs, tol=None) -> float:
    """Hold ``got`` to ``want`` within ``tol`` (phase 2's by dtype) of
    max |want|, and each slab of ``SLAB`` rows along the sequence (dim 1)
    by its relative Frobenius error within the same ``tol``: under a
    causal mask dK and dV are ~40x smaller at late keys than at the first,
    so an error confined to late tiles is held to their own scale there.
    Records the max abs error."""
    tol = TOL[dtype] if tol is None else tol
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    scale = w.abs().max().item()
    slab_err = 0.0
    for gs, ws in zip(g.split(SLAB, dim=1), w.split(SLAB, dim=1)):
        d, n = (gs - ws).norm().item(), ws.norm().item()
        slab_err = max(slab_err, d / n if n > 0 else (0.0 if d == 0 else float("inf")))
    ok = err <= tol * scale and slab_err <= tol
    log(f"  {name:60s} {dtype:8s} max|err| {err:.3e} = {err / max(scale, 1e-30):.2e} x "
        f"max|ref|, worst {SLAB}-row slab rel {slab_err:.2e} (tol {tol:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: max abs err {err} > {tol} x {scale} or a "
                             f"{SLAB}-row slab's relative error {slab_err} > {tol}")
    errs.append(err)
    return err


def flash_bwd_case(torch, rng, dev, dtype, B, Sq, Skv, nh, nkv, hd, kw, errs, fwd_errs):
    """One K2 backward check: the forward with its log-sum-exp (as
    ``FlashAttentionFn`` launches it) against the plain forward, output
    (phase 2's tolerance) and log-sum-exp, and bit for bit against the
    launch without it; dq, dk and dv against ``ref.flash_attention_bwd``
    on the same inputs, and a second launch bit for bit. The forward's max
    abs error goes to ``fwd_errs``, the backward's to ``errs``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    t = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev, getattr(torch, dtype))
    q, do = t((B, Sq, nh, hd)), t((B, Sq, nh, hd))
    k, v = t((B, Skv, nkv, hd)), t((B, Skv, nkv, hd))
    causal, window, chunk = kw.get("causal", True), kw.get("window", 0), kw.get("chunk", 0)
    out, lse = fa._forward(q, k, v, causal, window, chunk, None, True)
    label = f"B={B} Sq={Sq} Skv={Skv} H={nh} KV={nkv} hd={hd} {kw}"
    if not torch.equal(out, fa.flash_attention(q, k, v, **kw)):
        raise AssertionError(f"K2 forward {label}: the output differs with the LSE stored")
    want_out, want_lse = ref.flash_attention(q.float(), k.float(), v.float(), **kw,
                                             return_lse=True)
    check(f"K2 out {label}", dtype, out, want_out.to(q.dtype), fwd_errs)
    check(f"K2 lse {label}", dtype, lse, want_lse, [], tol=1e-5)
    del want_out, want_lse
    want = ref.flash_attention_bwd(q.float(), k.float(), v.float(), out.float(), lse,
                                   do.float(), **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K2 bwd {label}: two launches differ")
    del again
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check_rel(f"K2 bwd {name} {label}", dtype, g, w, errs)
    del got
    return q, k, v, out, lse, do


def flash_bwd_kernels(hd: int) -> dict:
    """The device kernels of K2 backward's bf16 dQ and dK/dV passes (each
    launched once a call): at hd 256 the dK/dV pass is its dV and dK
    kernels, then the head groups' sum where there are several."""
    if hd == 256:
        dkv = ("flash_attention_bwd_dkv_wgmma_kernel<256, 1>",
               "flash_attention_bwd_dkv_wgmma_kernel<256, 2>",
               "flash_attention_bwd_dkv_reduce_kernel")
    else:
        dkv = ("flash_attention_bwd_dkv_wgmma_kernel",)
    return {"dq": ("flash_attention_bwd_dq_wgmma_kernel",), "dkv": dkv}


def sdpa_backward(torch, q, k, v, do, **sdpa_kw):
    """The library yardstick: the backward of one SDPA call (GQA), a
    retained graph's ``torch.autograd.grad``."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                           **sdpa_kw)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)


# phase 10's kernel entries: key -> the label of its kernel in a profiled
# train step (``profile_breakdown``'s shares) and the arch whose step it is
TRAIN_SHARES = {"K2": "flash_attention_mma_kernel", "K2 bwd": "flash_attention_bwd",
                "K5": "rglru_scan_kernel", "K5 bwd": "rglru_scan_bwd_kernel",
                "K4": "moe_gmm_mma_kernel", "K4 bwd": "moe_gmm_bwd"}
TRAIN_ROWS = {"flash_train": ("granite-3-2b", "K2"),
              "flash_bwd_granite": ("granite-3-2b", "K2 bwd"),
              "flash_rg_train": ("recurrentgemma-2b", "K2"),
              "flash_bwd_rg": ("recurrentgemma-2b", "K2 bwd"),
              "scan_train": ("recurrentgemma-2b", "K5"),
              "scan_bwd": ("recurrentgemma-2b", "K5 bwd"),
              "flash_l4_train": ("llama4-scout-17b-a16e", "K2"),
              "flash_bwd_l4": ("llama4-scout-17b-a16e", "K2 bwd"),
              "gmm_train": ("llama4-scout-17b-a16e", "K4")}


def phase_kernels_train(torch, dev):
    """Phase 10 (a): K2's forward with its log-sum-exp and K2's and K5's
    backward kernels against their plain versions in bf16 and float32 at
    the training paths' shapes and edges, K5's forward at its training
    shape, then event, plain and library times at the training shapes.
    Returns the entries without ``ms``: ``training_run`` adds each
    kernel's device time per call from the profiled train steps, at the
    same shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    rng = np.random.default_rng(10)
    errs = {key: [] for key in TRAIN_ROWS if key != "gmm_train"}
    log("phase 10 (a): kernels of the training path against their plain versions (the "
        "plain version in float32 on the same inputs; backward: tolerance x max|ref| and "
        f"per {SLAB}-row slab)")
    granite = (TR_B, TR_S, TR_S, H, KV, HD, dict(causal=True))
    rg = (1, RG_TR_S, RG_TR_S, RG_H, RG_KV, RG_HD, dict(causal=True, window=RG_WINDOW))
    # llama4's (h): both layers see 2048 of the chunk's 8192 positions,
    # so the chunk mask is the causal one
    l4 = (L4_TR_B, L4_TR_S, L4_TR_S, L4_H, L4_KV, L4_HD, dict(causal=True))
    edges = [(1, 512, 2048, H, KV, HD, dict(causal=True)),          # Sq < Skv
             (2, 1000, 1000, H, KV, HD, dict(causal=True)),         # a ragged tile
             (1, 512, 512, 8, 8, HD, dict(causal=True)),            # G = 1
             (1, 1024, 1024, L4_H, L4_KV, L4_HD, dict(causal=True, chunk=256))]
    for dtype in ("bfloat16", "float32"):
        for key, fkey, case in (("flash_bwd_granite", "flash_train", granite),
                                ("flash_bwd_rg", "flash_rg_train", rg),
                                ("flash_bwd_l4", "flash_l4_train", l4)):
            flash_bwd_case(torch, rng, dev, dtype, *case, errs[key], errs[fkey])
            torch.cuda.empty_cache()
        for case in edges:
            flash_bwd_case(torch, rng, dev, dtype, *case, errs["flash_bwd_granite"], [])
    for with_h0 in (False, True):
        a, b, h0 = scan_inputs(torch, rng, dev, "float32", RG_TR_S, with_h0)
        check(f"K5 rglru_scan B=1 S={RG_TR_S} D={RG_D} h0={with_h0}", "float32",
              rs.rglru_scan(a, b, h0), ref.rglru_scan(a, b, h0), errs["scan_train"], tol=0.0)
        h = torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32)).to(dev)
        dh = torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32)).to(dev)
        got, want = rs.rglru_scan_bwd(a, h, dh, h0), ref.rglru_scan_bwd(a, h, dh, h0)
        for name, g, w in zip(("da", "db", "dh0"), got, want):
            if w is not None:
                check(f"K5 bwd {name} B=1 S={RG_TR_S} D={RG_D} h0={with_h0}", "float32",
                      g, w, errs["scan_bwd"], tol=0.0)
    torch.cuda.synchronize()

    log("phase 10 (a): times at the training paths' shapes, bf16 (K5 float32), CUDA events "
        "(the kernels' device ms per call come from the profiled train steps, below)")
    entries = {}
    dtype, isz = "bfloat16", 2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for key, fkey, (B, Sq, Skv, nh, nkv, hd, kw), what in (
            ("flash_bwd_granite", "flash_train", granite, "hd 64"),
            ("flash_bwd_rg", "flash_rg_train", rg, "hd 256, window"),
            ("flash_bwd_l4", "flash_l4_train", l4, "hd 128 G=5")):
        q, k, v, out, lse, do = flash_bwd_case(torch, rng, dev, dtype, B, Sq, Skv, nh, nkv,
                                               hd, kw, [], [])
        window = kw.get("window", 0)
        pairs = sum(min(i + 1, window) if window else i + 1 for i in range(Sq)) * nh * B
        lib_kw = dict(attn_mask=window_mask(torch, Sq, window, dev)) if window \
            else dict(is_causal=True)
        shape = f"B={B} S={Sq} H={nh} KV={nkv} hd={hd} {kw} bf16"
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        b, by = bound_ms(isz * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel(),
                         4 * hd * pairs, dtype)
        entries[fkey] = dict(
            name=f"flash_attention ({what}), via train", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:27", shape=shape + ", with LSE",
            event_ms=event_ms(torch, lambda: fa._forward(q, k, v, kw["causal"], window, 0,
                                                         None, True), 10),
            plain_ms=event_ms(torch, lambda: ref.flash_attention(q, k, v, **kw,
                                                                 return_lse=True), 1, warmup=1),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True, **lib_kw), 10),
            library="SDPA forward" + (", explicit window mask" if window else ", is_causal"))
        b, by = bound_ms(isz * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
                         10 * hd * pairs, dtype)
        entries[key] = dict(
            name=f"flash_attention_bwd ({what})", route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/flash_attention.py:27", shape=shape,
            event_ms=event_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw),
                              10),
            plain_ms=event_ms(torch, lambda: ref.flash_attention_bwd(q, k, v, out, lse, do,
                                                                     **kw), 1, warmup=1),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, sdpa_backward(torch, q, k, v, do, **lib_kw), 5),
            library="SDPA backward (torch.autograd.grad on a retained graph"
                    + (", explicit window mask)" if window else ", is_causal)"))
        e = entries[key]
        call = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)  # noqa: E731
        names = flash_bwd_kernels(hd)
        alone = dict(ms=kernel_ms(torch, call, names["dq"] + names["dkv"], iters=10),
                     **{p + "_ms": kernel_ms(torch, call, names[p], iters=10)
                        for p in ("dq", "dkv")})
        log(f"  K2 bwd ({what}) called alone: kernel {alone['ms']:.4f} ms (dQ pass "
            f"{alone['dq_ms']:.4f}, dK/dV pass {alone['dkv_ms']:.4f}; events "
            f"{e['event_ms']:.4f}), bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"library {e['library_ms']:.4f} ms")
        del q, k, v, out, lse, do, qt, kt, vt
        torch.cuda.empty_cache()
    a, bb, _ = scan_inputs(torch, rng, dev, "float32", RG_TR_S, False)
    plan = rs.scan_plan(RG_D, 4, a.data_ptr(), bb.data_ptr())
    b, by = bound_ms(4 * 3 * a.numel(), 2 * a.numel(), "float32")
    entries["scan_train"] = dict(
        name="rglru_scan, via train", route="cuda", source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:26",
        shape=f"B=1 S={RG_TR_S} D={RG_D} float32, ch={plan.ch} vec={plan.vec}",
        event_ms=event_ms(torch, lambda: rs.rglru_scan(a, bb), 20),
        plain_ms=event_ms(torch, lambda: ref.rglru_scan(a, bb), 1, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None)
    h = torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32)).to(dev)
    dh = torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32)).to(dev)
    b, by = bound_ms(4 * 5 * a.numel(), 3 * a.numel(), "float32")
    plan = rs.scan_plan(RG_D, 4, a.data_ptr(), h.data_ptr(), dh.data_ptr())
    entries["scan_bwd"] = dict(
        name="rglru_scan_bwd", route="cuda", source="src/repro_torch/csrc/rglru_scan_bwd.cu",
        replaces="src/repro/kernels/rglru_scan.py:26",
        shape=f"B=1 S={RG_TR_S} D={RG_D} float32, ch={plan.ch} vec={plan.vec}",
        event_ms=event_ms(torch, lambda: rs.rglru_scan_bwd(a, h, dh), 20),
        plain_ms=event_ms(torch, lambda: ref.rglru_scan_bwd(a, h, dh), 1, warmup=0),
        bound_ms=b, bound_by=by, library_ms=None)
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
    return entries


# K4's backward rows: key -> (projection, gradient); gate/up: K = d_model,
# N = d_ff; down: K = d_ff, N = d_model
GMM_BWD_ROWS = {"gmm_bwd_dx": ("gate/up", "dX"), "gmm_bwd_dw": ("gate/up", "dW"),
                "gmm_bwd_dx_down": ("down", "dX"), "gmm_bwd_dw_down": ("down", "dW")}


def gmm_bwd_kernel(grad: str) -> str:
    """The device kernel of K4 backward's bf16 ``grad`` ("dX", "dW")."""
    return f"moe_gmm_bwd_{grad.lower()}_wgmma_kernel"


def gmm_bwd_case(torch, dev, dtype, label, sizes, T, K, N, seed, errs, fwd_errs=None):
    """One K4 backward check (with ``fwd_errs``, the forward's against
    ``ref.moe_gmm`` first): dX and dW from one launcher call against
    ``ref.moe_gmm_bwd`` on the same inputs (the bf16 ones widened to
    float32 inside it), dX within ``gmm_tol`` of the whole, each expert's
    dW within ``gmm_tol`` of its own (an expert with few rows has a small
    dW), an empty group's dW and the rows no group covers exactly zero; a
    second call bit for bit. Max abs errors go to
    ``errs["dX"]`` and ``errs["dW"]``. Returns (x, w, gs, dout, dx, dw) of
    the last call."""
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import ref
    x, w, gs = gmm_inputs(torch, dev, dtype, sizes, T, K, N, seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    dout = torch.randn((T, N), generator=g, device=dev).to(x.dtype)
    if fwd_errs is not None:
        want = ref.moe_gmm(x, w, gs)
        check(f"K4 {label} T={T} K={K} N={N}", dtype, gm.moe_gmm(x, w, gs), want, fwd_errs,
              tol=gmm_tol(dtype, want))
        del want
    want_dx, want_dw = ref.moe_gmm_bwd(x, w, gs, dout)
    dx, dw = gm.moe_gmm_bwd(x, w, gs, dout)
    again = gm.moe_gmm_bwd(x, w, gs, dout)
    torch.cuda.synchronize()
    name = f"K4 bwd {label} T={T} K={K} N={N} E={len(sizes)}"
    if not (torch.equal(dx, again[0]) and torch.equal(dw, again[1])):
        raise AssertionError(f"{name}: two launches differ")
    del again
    check(f"{name} dX", dtype, dx, want_dx, errs["dX"], tol=gmm_tol(dtype, want_dx))
    if dx[int(sum(sizes)):].any():
        raise AssertionError(f"{name}: dX rows past the groups are not zero")
    worst, rel = 0.0, 0.0
    for e, n in enumerate(sizes):
        err = (dw[e].float() - want_dw[e].float()).abs().max().item()
        tol = 0.0 if n == 0 else gmm_tol(dtype, want_dw[e])
        if err > tol:
            raise AssertionError(f"{name}: expert {e} ({n} rows) dW max abs err {err} > "
                                 f"{tol}")
        worst = max(worst, err)
        rel = max(rel, err / max(want_dw[e].float().abs().max().item(), 1.0))
    log(f"  {name + ' dW':60s} {dtype:8s} max|err| {worst:.3e}, worst expert "
        f"{rel:.2e} x max(1, its max|ref|) (tol {gmm_tol(dtype, torch.ones(1)):.0e}; "
        f"empty groups 0) ok")
    errs["dW"].append(worst)
    del want_dx, want_dw
    return x, w, gs, dout, dx, dw


def gmm_bwd_library(torch, x, w, gs, dout, dx, dw):
    """``torch._grouped_mm`` for the same dX (dY against W[e] transposed)
    and dW (X^T against dY, ragged over the rows), timed only, the port
    never calls it; each checked against the kernel's result first. Returns
    {"dX": fn or None, "dW": fn or None} and logs why one is missing."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        log("  K4 bwd library: torch has no _grouped_mm")
        return {"dX": None, "dW": None}
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    wt, xt = w.transpose(1, 2), x.t()
    calls = {"dX": (lambda: fn(dout, wt, offs=offs), dx),
             "dW": (lambda: fn(xt, dout, offs=offs), dw)}
    out = {}
    for what, (call, mine) in calls.items():
        try:
            got = call()
            torch.cuda.synchronize()
        except Exception as exc:                 # noqa: BLE001 (reported)
            log(f"  K4 bwd {what}: _grouped_mm refused the operands: "
                f"{type(exc).__name__}: {str(exc)[:200]}")
            out[what] = None
            continue
        rows = int(gs.sum())
        a, b = (got[:rows], mine[:rows]) if what == "dX" else (got, mine)
        err = (a.float() - b.float()).abs().max().item() if a.shape == b.shape else None
        ok = err is not None and err <= 2 * gmm_tol(str(x.dtype)[6:], b)
        log(f"  K4 bwd {what}: _grouped_mm gives shape {tuple(got.shape)}, max|diff| from "
            f"the kernel {err if err is None else f'{err:.3e}'}: "
            f"{'the same function' if ok else 'not the same function, not timed'}")
        out[what] = call if ok else None
        del got
    return out


def phase_kernels_moe_train(torch, dev):
    """Phase 10 (f): K4's backward kernels (``csrc/moe_gmm_bwd.cu``)
    against ``ref.moe_gmm_bwd`` in bf16 and float32 at llama4-scout's
    training shapes (4096 rows of a top-1 routing over 16 experts; gate/up
    and down) and at the edges (an empty group, a one-row group, rows past
    the total, one expert, K and N off the tiles); then the bf16 kernel's
    device time, CUDA events, bound, the plain version's time and
    ``_grouped_mm``'s, bf16; the forward (K4) at the same shapes against
    ``ref.moe_gmm``, timed at gate/up. Returns the four rows (dX and dW at
    gate/up and down) and the forward's (``gmm_train``, without ``ms``:
    ``training_run`` takes it from the profiled train step), without
    ``launches``."""
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import ref
    rng = np.random.default_rng(11)
    T, d, ff = L4_TR_B * L4_TR_S, 5120, 8192
    sizes = routed_sizes(rng, T, 16, 1, d)
    shapes = {"gate/up": (d, ff), "down": (ff, d)}
    edges = [("an empty group, a one-row group, 17 rows past the total",
              [0, 1, 300, 0, 77, 5], 400, 1000, 1000),
             ("one expert, K and N off the tiles", [200], 256, 264, 520),
             ("six rows", [3, 0, 2], 6, 16, 8)]
    errs = {key: [] for key in [*GMM_BWD_ROWS, "gmm_train"]}
    log(f"phase 10 (f): K4 backward against ref.moe_gmm_bwd (group sizes of a top-1 routing "
        f"of {T} random hidden states over 16 experts: {sizes.tolist()})")
    for dtype in ("bfloat16", "float32"):
        for i, (what, (K, N)) in enumerate(shapes.items()):
            e = {grad: errs[key] for key, (shape_of, grad) in GMM_BWD_ROWS.items()
                 if shape_of == what}
            gmm_bwd_case(torch, dev, dtype, f"llama4 {what}", sizes, T, K, N, 60 + i, e,
                         errs["gmm_train"])
            torch.cuda.empty_cache()
        for i, (label, esizes, eT, K, N) in enumerate(edges):
            gmm_bwd_case(torch, dev, dtype, label, esizes, eT, K, N, 70 + i,
                         {"dX": errs["gmm_bwd_dx"], "dW": errs["gmm_bwd_dw"]})
    torch.cuda.synchronize()

    log("phase 10 (f): K4 backward times at llama4's training shapes, bf16 (kernel: profiler "
        "device time; events: the wrapper asked for that gradient alone; plain: "
        "ref.moe_gmm_bwd for it alone; library: torch._grouped_mm, CUDA events)")
    entries, isz, used, rows = {}, 2, int((sizes > 0).sum()), int(sizes.sum())
    for i, (what, (K, N)) in enumerate(shapes.items()):
        x, w, gs, dout, dx, dw = gmm_bwd_case(torch, dev, "bfloat16", f"llama4 {what}", sizes,
                                               T, K, N, 80 + i, {"dX": [], "dW": []})
        lib = gmm_bwd_library(torch, x, w, gs, dout, dx, dw)
        del dx, dw
        if what == "gate/up":
            fwd_lib, why = gmm_library(torch, x, w, gs)
            if why:
                log(f"  K4 train: library_ms none: {why}")
            b, by = bound_ms(isz * (T * K + used * K * N + T * N) + 4 * 16, 2 * rows * K * N,
                             "bfloat16")
            entries["gmm_train"] = dict(
                name="moe_gmm (llama4 train gate/up), via train", route="cuda",
                source="src/repro_torch/csrc/moe_gmm.cu",
                replaces="src/repro/kernels/moe_gmm.py:26",
                shape=f"T={T} K={K} N={N} E=16 ({used} used) bf16",
                event_ms=event_ms(torch, lambda: gm.moe_gmm(x, w, gs), 10),
                plain_ms=event_ms(torch, lambda: ref.moe_gmm(x, w, gs), 1, warmup=1),
                bound_ms=b, bound_by=by,
                library_ms=event_ms(torch, fwd_lib, 10) if fwd_lib else None,
                library="torch._grouped_mm")
            del fwd_lib
        # dX reads dY and each used expert's W once and writes dX; dW reads
        # X and dY once and writes every expert's dW
        bounds = {"dX": bound_ms(isz * (T * N + used * K * N + T * K) + 4 * 16,
                                 2 * rows * K * N, "bfloat16"),
                  "dW": bound_ms(isz * (T * K + T * N + 16 * K * N) + 4 * 16,
                                 2 * rows * K * N, "bfloat16")}
        for key, (shape_of, grad) in GMM_BWD_ROWS.items():
            if shape_of != what:
                continue
            flags = dict(need_dx=grad == "dX", need_dw=grad == "dW")
            call = lambda: gm.moe_gmm_bwd(x, w, gs, dout, **flags)  # noqa: E731
            b, by = bounds[grad]
            entries[key] = dict(
                name=f"moe_gmm_bwd {grad} ({what}), via train", route="cuda",
                source="src/repro_torch/csrc/moe_gmm_bwd.cu",
                replaces="src/repro/kernels/moe_gmm.py:26",
                shape=f"T={T} K={K} N={N} E=16 ({used} used) bf16",
                **kernel_times(torch, call, gmm_bwd_kernel(grad), iters=10),
                plain_ms=event_ms(torch, lambda: ref.moe_gmm_bwd(x, w, gs, dout, **flags), 2,
                                  warmup=1),
                bound_ms=b, bound_by=by,
                library_ms=event_ms(torch, lib[grad], 10) if lib[grad] else None,
                library="torch._grouped_mm, " + ("dY x W[e]^T" if grad == "dX"
                                                 else "X^T x dY ragged over the rows"))
            e = entries[key]
            lib_ms = f"{e['library_ms']:.4f}" if e["library_ms"] else "n/a"
            log(f"  K4 bwd {grad} ({what}): kernel {e['ms']:.4f} ms (events "
                f"{e['event_ms']:.4f}), bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
                f"library {lib_ms} ms")
        del x, w, gs, dout, lib
        torch.cuda.empty_cache()
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
        if "ms" in e:
            log_row(e)
    return entries


def _rel_norm(torch, got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))


def train_step_parity(torch, cfg, dev, B, S, on_cpu=False):
    """Phase 10 (b) and (g): one train step's loss and every leaf's
    gradient through the kernels against the same step with impl="ref"
    (the plain versions under autograd), on the same weights and batch; no
    leaf's gradient may be zero or missing. A MoE model's two steps share
    their expert choices (``shared_routes``: a bf16 near tie may flip one,
    which says nothing about the kernels). With ``on_cpu`` the plain step
    runs on the CPU from the same weights."""
    from repro_torch import bridge
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.models.param import iter_leaves
    from repro_torch.train.train_loop import batch_to, loss_and_grads
    tol_loss, tol_grad = (1e-3, 2e-2) if cfg.dtype == "bfloat16" else (1e-5, 1e-4)
    params = M.init_model_params(cfg, 0, dev)
    batch = batch_to(TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                                  seed=1)).next_batch(), dev)
    with (shared_routes() if cfg.n_experts else contextlib.nullcontext(({}, [None]))) \
            as (routes, cur):
        zero_launches()
        l1, g1 = loss_and_grads(cfg, params, batch, remat=True)
        counts = launches()
        cur[0] = "ref"
        if on_cpu:
            cpu = torch.device("cpu")
            l2, g2 = loss_and_grads(cfg, bridge.from_jax(bridge.to_numpy(params), device=cpu),
                                    batch_to(batch, cpu), remat=True)
        else:
            l2, g2 = loss_and_grads(cfg, params, batch, impl="ref", remat=True)
    want = {path: g.to(dev) for path, g in iter_leaves(g2)}
    errs = {path: _rel_norm(torch, g, want[path]) for path, g in iter_leaves(g1)}
    dead = [path for path, g in iter_leaves(g1) if not float(g.float().abs().max()) > 0]
    missing = sorted(set(want) - set(errs))
    worst = max(errs, key=errs.get)
    loss_err = abs(float(l1) - float(l2)) / abs(float(l2))
    shared = f"; expert choices shared, {routes['differ']} of {routes['all']} the plain " \
        "path's own top-k would change" if routes else ""
    log(f"  {cfg.name} {cfg.n_layers} layers {cfg.dtype} B={B} S={S}: loss {float(l1):.6f} "
        f"vs {'the CPU' if on_cpu else 'ref'} {float(l2):.6f} (rel {loss_err:.2e}, tol "
        f"{tol_loss:.0e}); worst leaf gradient {worst} rel norm err {errs[worst]:.2e} (tol "
        f"{tol_grad:.0e}) over {len(errs)} leaves; kernel launches "
        f"{ {k: n for k, n in counts.items() if n} }{shared}")
    if loss_err > tol_loss or errs[worst] > tol_grad or dead or missing:
        raise AssertionError(f"phase 10 parity {cfg.name} {cfg.dtype}: loss rel err {loss_err}, "
                             f"worst gradient {worst} {errs[worst]}, zero {dead}, "
                             f"missing {missing}")
    from repro_torch.configs.base import BlockKind
    if not (counts["flash"] and counts["flash_bwd"]) or \
            (BlockKind.RGLRU in cfg.pattern and not (counts["scan"] and counts["scan_bwd"])) or \
            (cfg.n_experts and not (counts["gmm"] and counts["gmm_bwd"])):
        raise AssertionError(f"phase 10 parity {cfg.name}: launches {counts}")


def dots_parity(torch, cfg, dev, B, S):
    """Phase 10 (g): ``remat_policy="dots"`` on the card (selective
    checkpointing that keeps the matrix products' outputs, around the
    kernels' autograd Functions) against plain ``remat=True`` on the same
    weights and batch: the loss and every leaf's gradient within 1e-6
    relative (the kernels recompute the same values, but autograd may add
    a leaf's gradient contributions in another order; whether they agree
    bit for bit is logged), K2's and K4's backward launched."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.models.param import iter_leaves
    from repro_torch.train.train_loop import batch_to, loss_and_grads
    params = M.init_model_params(cfg, 0, dev)
    batch = batch_to(TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                                  seed=2)).next_batch(), dev)
    runs = []
    for policy in (None, "dots"):
        zero_launches()
        loss, grads = loss_and_grads(cfg, params, batch, remat=True, remat_policy=policy)
        runs.append((float(loss), dict(iter_leaves(grads)),
                     {k: n for k, n in launches().items() if n}))
    (l1, g1, c1), (l2, g2, c2) = runs
    errs = {path: _rel_norm(torch, g2[path], g) for path, g in g1.items()}
    worst = max(errs, key=errs.get)
    bits = l1 == l2 and all(torch.equal(g, g2[path]) for path, g in g1.items())
    log(f"  {cfg.name} {cfg.n_layers} layers {cfg.dtype} B={B} S={S}, remat_policy='dots' "
        f"against remat=True: loss {l2:.6f} vs {l1:.6f}, worst leaf {worst} rel norm err "
        f"{errs[worst]:.2e} (tol 1e-06), {'bit for bit' if bits else 'not bit for bit'}; "
        f"launches {c2} (remat=True: {c1})")
    if abs(l2 - l1) > 1e-6 * abs(l1) or errs[worst] > 1e-6 or \
            not all(c2.get(k) for k in ("flash_bwd", "gmm_bwd")):
        raise AssertionError(f"phase 10 (g) dots {cfg.name}: loss {l2} vs {l1}, worst "
                             f"{worst} {errs[worst]}, launches {c2}")


def model_flops(cfg, B, S) -> float:
    """A train step's model FLOPs: 6 per active parameter per token (a MoE
    layer's top-k experts, not all of them), plus the attention layers'
    scores and values forward and backward (3 x the forward's 4 hd
    operations a visible pair: causal, within the window, or within the
    chunk)."""
    from repro_torch.configs.base import BlockKind
    visible = {BlockKind.ATTN: lambda i: i + 1,
               BlockKind.LOCAL_ATTN: lambda i: min(i + 1, cfg.window) if cfg.window else i + 1,
               BlockKind.CHUNKED_ATTN: lambda i: i % cfg.chunk + 1}
    pairs = sum(sum(visible[k](i) for i in range(S)) for k in
                (cfg.pattern * cfg.n_layers)[:cfg.n_layers] if k in visible)
    return 6.0 * cfg.n_active_params * B * S + 3 * 4 * cfg.hd * pairs * cfg.n_heads * B


def train_run(torch, cfg, dev, B, S, steps, repeat: bool):
    """Phase 10 (c), (d) and (h): ``steps`` steps through the launcher's
    pieces (``repro_torch.launch.train.setup`` and ``next_batch``: seed 0,
    AdamW as the launcher sets it, remat on, the update in place), each
    step's loss finite, its launches the reckoning's (``TR_COUNTS``: no
    other kernel's);
    the last step profiled (device busy against the host, and each
    kernel's device ms per call). The rate is the window's: the
    unprofiled steps' host time over their count (the median beside it).
    Each step logs what can stall the host: the garbage collector's time
    and the caching allocator's cudaMalloc calls and retries. With
    ``repeat``, a second run of ``TR_REPEAT_STEPS`` steps on one batch at
    ``TR_REPEAT_LR`` whose loss must fall. Returns (params, launch totals, the
    profiled step's device ms per call by ``TRAIN_SHARES`` label, the
    window's s/step, median and slowest step)."""
    import gc
    from repro_torch.launch import train as L
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_fn, params, state, pipe = L.setup(cfg, steps=steps, batch=B, seq=S, lr=3e-4,
                                           device=dev)
    torch.cuda.synchronize()
    flops = model_flops(cfg, B, S)
    log(f"phase 10: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, {cfg.n_params / 1e9:.3f} B "
        f"parameters, B={B} S={S}: setup {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated (weights and AdamW state); "
        f"model FLOPs a step {flops / 1e12:.1f} TFLOP")
    want = TR_COUNTS[cfg.name]
    total = collections.Counter()
    times, losses, per_launch = [], [], {}
    gc_ms, gc_t0 = [0.0], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3

    def alloc_stats():
        st = torch.cuda.memory_stats()
        return st.get("num_device_alloc", 0), st.get("num_alloc_retries", 0)

    gc.callbacks.append(on_gc)
    try:
        for step in range(1, steps + 1):
            batch = L.next_batch(cfg, pipe, B)
            torch.cuda.synchronize()
            zero_launches()
            gc_ms[0] = 0.0
            mallocs, retries = alloc_stats()
            t1 = time.perf_counter()
            run = lambda: step_fn(params, state, batch)  # noqa: E731
            if step < steps:
                params, state, metrics = run()
                loss = float(metrics["loss"])             # a host read: the step has ended
                dt = time.perf_counter() - t1
            else:
                holder = {}

                def profiled():
                    gc0 = gc_ms[0]
                    holder["out"] = run()
                    holder["gc_ms"] = gc_ms[0] - gc0   # not the profiler's teardown
                wall, _, _ = profile_breakdown(
                    torch, f"{cfg.name} train step {step} (host against device busy)",
                    profiled, 1, shares=TRAIN_SHARES, per_launch=per_launch)
                params, state, metrics = holder.pop("out")
                loss, dt = float(metrics["loss"]), wall / 1e3
                gc_ms[0] = holder["gc_ms"]
            mallocs, retries = (n - n0 for n, n0 in zip(alloc_stats(), (mallocs, retries)))
            counts = launches()
            total.update(counts)
            got = {k: n for k, n in counts.items() if n}
            if got != want:
                raise AssertionError(f"phase 10 {cfg.name} step {step}: launches {got}, "
                                     f"the reckoning {want}")
            if not np.isfinite(loss):
                raise AssertionError(f"phase 10 {cfg.name} step {step}: loss {loss}")
            times.append(dt)
            losses.append(loss)
            log(f"  step {step}: loss {loss:.4f}, {dt:.4f} s (host clock, the loss read back"
                f"{', under the profiler' if step == steps else ''}), grad norm "
                f"{float(metrics['grad_norm']):.3f}, lr {metrics['lr']:.3e}; gc "
                f"{gc_ms[0]:.1f} ms, cudaMalloc {mallocs}, allocator retries {retries}")
    finally:
        gc.callbacks.remove(on_gc)
    window = times[:-1]
    s_step = sum(window) / len(window)
    rate = dict(s_step=s_step, median=float(np.median(window)), slowest=max(window))
    log(f"  {cfg.name}: {s_step:.4f} s/step (the window: steps 1..{steps - 1}, "
        f"{sum(window):.4f} s), median {float(np.median(window)):.4f}, slowest "
        f"{max(window):.4f}; {B * S / s_step:.0f} tokens/s, MFU "
        f"{flops / s_step / PEAK_OPS['bfloat16']:.4f} (model FLOPs over 989 TFLOP/s, the "
        f"window's rate); peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated; "
        f"launches a step {want}")
    if repeat:
        del state
        torch.cuda.empty_cache()
        ocfg = AdamWConfig(lr=TR_REPEAT_LR[cfg.name], warmup_steps=0, total_steps=50)
        step_fn = make_train_step(cfg, ocfg, device=dev)
        state = init_opt_state(ocfg, params)
        batch = L.next_batch(cfg, pipe, B)
        rep = []
        for _ in range(TR_REPEAT_STEPS):
            params, state, metrics = step_fn(params, state, batch)
            rep.append(float(metrics["loss"]))
        log(f"  {cfg.name}: one batch repeated {TR_REPEAT_STEPS} steps at lr "
            f"{TR_REPEAT_LR[cfg.name]:g}: losses {[round(x, 4) for x in rep]}")
        if not rep[-1] < rep[0]:
            raise AssertionError(f"phase 10 {cfg.name}: the repeated batch's loss did not "
                                 f"fall: {rep}")
    del state
    torch.cuda.empty_cache()
    return params, total, per_launch, rate


def checkpoint_and_guards(torch, params, dev):
    """Phase 10 (e): the trained parameters through ``checkpoint.save`` /
    ``restore`` on the port's ObjectStore, bit for bit; K1 (decode and
    chunk) and K3, which have no backward kernel, raise under autograd on
    the card and run under ``torch.no_grad()``."""
    from repro_torch.core.storage import ObjectStore
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.param import iter_leaves
    from repro_torch.train import checkpoint as C
    t0 = time.perf_counter()
    store = ObjectStore()
    C.save(store, "granite", TR_STEPS, params)
    back = C.restore(store, "granite", C.latest_step(store, "granite"), params)
    bad = [p for (p, a), (_, b) in zip(iter_leaves(params), iter_leaves(back))
           if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b)]
    n_bytes = sum(store.size(k) for k in store._blobs)
    log(f"phase 10 (e): checkpoint of {len(list(iter_leaves(params)))} leaves "
        f"({n_bytes / 1e9:.2f} GB of npy blobs) saved and restored in "
        f"{time.perf_counter() - t0:.1f} s: {'bit for bit' if not bad else bad}")
    if bad or C.latest_step(store, "granite") != TR_STEPS:
        raise AssertionError(f"phase 10 (e): restored leaves differ: {bad}")
    del back, store
    t = lambda *shape: torch.randn(shape, device=dev, dtype=torch.bfloat16,  # noqa: E731
                                   requires_grad=True)
    q, k, v = t(1, 16, H, HD), t(1, 64, KV, HD), t(1, 64, KV, HD)
    pool_k, pool_v = k.reshape(4, PAGE, KV, HD), v.reshape(4, PAGE, KV, HD)
    tables = torch.arange(4, dtype=torch.int32, device=dev)[None]
    kv_len = torch.tensor([64], dtype=torch.int32, device=dev)
    calls = {"paged_decode_attention (K1)": lambda: pa.paged_decode_attention(
                 q[:, :1], pool_k, pool_v, tables, kv_len),
             "paged_prefill_attention (K1)": lambda: pa.paged_prefill_attention(
                 q, pool_k, pool_v, tables, kv_len,
                 torch.tensor([48], dtype=torch.int32, device=dev)),
             "decode_attention (K3)": lambda: da.decode_attention(q[:, :1], k, v, kv_len)}
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            if name not in str(e):
                raise
        else:
            raise AssertionError(f"phase 10 (e): {name} under autograd on the card did not raise")
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    log(f"phase 10 (e): {', '.join(calls)} raise NotImplementedError under autograd on the "
        "card (no backward kernel) and run under torch.no_grad()")


def training_run(torch, dev):
    """Phase 10: the backward kernels, a train step's parity, granite-3-2b
    and recurrentgemma-2b at full width and depth, the checkpoint and the
    guards of K1 and K3; K4's backward kernels, a MoE train step's parity
    and llama4-scout at full width, cut to 2 layers. Returns (kernel
    entries, launch totals)."""
    import gc
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    free, total_mem = torch.cuda.mem_get_info()
    log(f"phase 10: training on the card ({free / 1e9:.1f} of {total_mem / 1e9:.1f} GB free)")
    t10 = time.perf_counter()
    entries = phase_kernels_train(torch, dev)
    torch.cuda.empty_cache()
    granite, rg = get_config("granite-3-2b"), get_config("recurrentgemma-2b")
    log("phase 10 (b): one train step through the kernels against impl='ref' (relative "
        "error of the loss and of each leaf's gradient norm)")
    for dtype in ("bfloat16", "float32"):
        train_step_parity(torch, dataclasses.replace(granite, n_layers=4, dtype=dtype), dev,
                          2, TR_S)
        train_step_parity(torch, dataclasses.replace(rg, n_layers=3, dtype=dtype), dev,
                          1, RG_TR_S)
        torch.cuda.empty_cache()
    params, g_total, g_ms, _ = train_run(torch, granite, dev, TR_B, TR_S, TR_STEPS,
                                         repeat=True)
    checkpoint_and_guards(torch, params, dev)
    del params
    torch.cuda.empty_cache()
    params, r_total, r_ms, _ = train_run(torch, rg, dev, RG_TR_B, RG_TR_S, RG_TR_STEPS,
                                         repeat=False)
    del params
    torch.cuda.empty_cache()
    entries.update(phase_kernels_moe_train(torch, dev))
    torch.cuda.empty_cache()
    l4 = get_config("llama4-scout-17b-a16e")
    log("phase 10 (g): a MoE train step through K2, K4 and their backward kernels against "
        "impl='ref' and against the CPU (relative error of the loss and of each leaf's "
        "gradient norm); remat_policy='dots' against remat=True")
    small = l4.reduced()
    train_step_parity(torch, small, dev, 2, 160)
    train_step_parity(torch, small, dev, 2, 160, on_cpu=True)
    train_step_parity(torch, dataclasses.replace(small, dtype="bfloat16"), dev, 2, 160)
    dots_parity(torch, get_config("grok-1-314b").reduced(), dev, 2, 160)
    torch.cuda.empty_cache()
    l4 = dataclasses.replace(l4, n_layers=L4_TR_LAYERS)
    log(f"phase 10 (h): {l4.name} at every published width, cut from 48 to {l4.n_layers} "
        f"layers ({[k.value for k in l4.pattern[:l4.n_layers]]}; d={l4.d_model} heads "
        f"{l4.n_heads}/{l4.n_kv_heads} hd={l4.hd} experts {l4.n_experts} top-{l4.top_k} "
        f"d_ff={l4.d_ff} vocab {l4.padded_vocab}); reckoned: {l4.n_params / 1e9:.2f} B "
        f"parameters, {12 * l4.n_params / 1e9:.1f} GB of bf16 weights and gradients and "
        "float32 AdamW state, float32 logits and their cotangent "
        f"{2 * 4 * L4_TR_B * L4_TR_S * l4.padded_vocab / 1e9:.1f} GB, an expert leaf's dW "
        f"{2 * l4.n_experts * l4.d_model * l4.d_ff / 1e9:.2f} GB: ~70 GB peak; launches a "
        f"step {TR_COUNTS[l4.name]}")
    params, l_total, l_ms, _ = train_run(torch, l4, dev, L4_TR_B, L4_TR_S, L4_TR_STEPS,
                                         repeat=True)
    del params
    torch.cuda.empty_cache()
    totals = {"flash_bwd_granite": g_total["flash_bwd"], "flash_train": g_total["flash"],
              "flash_bwd_rg": r_total["flash_bwd"], "flash_rg_train": r_total["flash"],
              "scan_bwd": r_total["scan_bwd"], "scan_train": r_total["scan"],
              "flash_bwd_l4": l_total["flash_bwd"], "flash_l4_train": l_total["flash"],
              "gmm_train": l_total["gmm"]}
    for key in GMM_BWD_ROWS:
        totals[key] = l_total["gmm_bwd"]
    log("phase 10: the training path's kernels (kernel: device ms per call in the profiled "
        "train step at the same shape, K4's forward averaged over its gate, up and down "
        "calls; K4 backward rows: the kernel's device time in (f); events, plain and "
        "library: CUDA events in (a) and (f))")
    per_call = {granite.name: g_ms, rg.name: r_ms, l4.name: l_ms}
    for key, (arch, label) in TRAIN_ROWS.items():
        e = entries[key]
        e["ms"] = per_call[arch][label]
        if e["ms"] is None:
            log(f"  {e['name']}: the profiler recorded no launch in {arch}'s profiled step; "
                "kernel ms = the event ms")
            e["ms"] = e["event_ms"]
        log_row(e)
    log(f"phase 10: done in {time.perf_counter() - t10:.1f} s; launches {totals}")
    return entries, totals


# ----------------------------------------------------------------------
# phase 11: int8 weights and int8 K/V caches on the card
# ----------------------------------------------------------------------
# (b): wv x 40, so V spans int8's range (std ~40: some values saturate);
# over granite's 40 layers wk x 2, so K spans a few units. At wk x 40 (K
# saturates too) two paths that are each right part within a few layers:
# over all 40 the kernels' logits against impl="ref" differ wholesale on a
# bf16 pool as on an int8 one. So at wk x 40 the check holds one layer,
# where both paths write the same K and the int8 kernels alone tell them
# apart, and reads (does not hold) 4 and all 40 layers on both pools, with
# the K entries the two int8 pools differ in, layer by layer
KV8_WK, KV8_WV, KV8_WK_SAT, KV8_WITNESS_DEPTHS = 2.0, 40.0, 40.0, (4, 40)
KV8_B, KV8_PROMPT, KV8_CHUNK, KV8_STEPS, KV8_WITNESS_STEPS = 8, 1024, 256, 32, 8
QW8_B, QW8_STEPS = 8, 8
RG8_B, RG8_PROMPT, RG8_STEPS = 2, 2100, 16
LV8_PROMPT, LV8_STEPS = 128, 16
SPLIT_FMA = ("split_decode_fma_kernel", "split_decode_merge_kernel")


def int8_kv(torch, rng, shape, dev):
    """K or V drawn N(0, 40^2) and narrowed as the model's cache writes are
    (``saturate_cast``): int8's whole range, some values saturated."""
    from repro_torch.models.layers import saturate_cast
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 40)
    return saturate_cast(x.to(dev), torch.int8)


def int8_paged_inputs(torch, rng, dev, dtype, kv_len, C, heads):
    """``paged_inputs`` with int8 pools and q times 0.02 (scores over int8
    keys a few units wide, as the served model's)."""
    q, kp, vp, bt, kl = paged_inputs(torch, rng, dev, dtype, kv_len, C, heads)
    return q * 0.02, int8_kv(torch, rng, kp.shape, dev), int8_kv(torch, rng, vp.shape, dev), \
        bt, kl


def widened_sdpa(torch, make, *args):
    """The yardstick of an int8 row: SDPA over the keys widened to bf16
    (and, paged, gathered) before timing."""
    return make(torch, args[0], args[1].to(torch.bfloat16), args[2].to(torch.bfloat16),
                *args[3:])


def phase_kernels_int8(torch, dev):
    """Phase 11 (a): K1's int8 instances (decode: the split body's FMA
    instance; chunks: bf16 the tensor-core body staging int8 tiles, float32
    the tiled body) at granite's widths (H 32, KV 8, hd 64; B=8 kv_len
    1..1024; C=256 at q_offset 256 and 768) and qwen's (H 40, KV 8, hd
    128), and K3 on int8 caches with no scales (ones) at recurrentgemma's
    ring (hd 256) and granite's dense cache, against their plain versions
    (bf16 and float32 queries; tolerance phase 2's, relative to max|ref|,
    as outputs are int8-sized); then each row's times at bf16, its bound
    counting int8 K/V bytes, the plain version's and SDPA's over the
    widened (and gathered) keys."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(27)
    heads = {"granite": (H, KV, HD), "qwen": (QW_H, QW_KV, QW_HD)}
    keys = ("decode_int8", "decode_int8_qwen", "chunk_int8", "chunk_int8_768",
            "chunk_int8_qwen", "chunk_int8_qwen_768", "dense_int8_rg", "dense_int8_granite")
    errs = {k: [] for k in keys}
    log("phase 11 (a): K1 on int8 pools and K3 on int8 caches without scales against "
        "their plain versions (K/V drawn N(0, 40^2) and narrowed; tolerance phase 2's "
        "x max|ref|)")
    for dtype in ("bfloat16", "float32"):
        for arch, hds in heads.items():
            sfx = "" if arch == "granite" else "_qwen"
            q, kp, vp, bt, kl = int8_paged_inputs(torch, rng, dev, dtype, QW_KV_LEN, 1, hds)
            check_rel(f"K1 decode int8 {arch} H={hds[0]} KV={hds[1]} hd={hds[2]}", dtype,
                      pa.paged_decode_attention(q, kp, vp, bt, kl),
                      ref.paged_decode_attention(q.float(), kp, vp, bt, kl),
                      errs[f"decode_int8{sfx}"])
            for q_off, key in ((256, f"chunk_int8{sfx}"), (768, f"chunk_int8{sfx}_768")):
                q, kp, vp, bt, kl = int8_paged_inputs(torch, rng, dev, dtype, [q_off + 256],
                                                      256, hds)
                qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
                check_rel(f"K1 chunk int8 {arch} C=256 q_offset={q_off}", dtype,
                          pa.paged_prefill_attention(q, kp, vp, bt, kl, qo),
                          ref.paged_prefill_attention(q.float(), kp, vp, bt, kl, qo),
                          errs[key])
        for key, (nh, nkv, hd) in (("dense_int8_rg", (RG_H, RG_KV, RG_HD)),
                                   ("dense_int8_granite", (H, KV, HD))):
            q, k, _, kl = decode_inputs(torch, rng, dev, dtype, nh, nkv, hd)
            k8, v8 = int8_kv(torch, rng, k.shape, dev), int8_kv(torch, rng, k.shape, dev)
            q = q * 0.02
            got = da.decode_attention(q, k8, v8, kl)
            ones = torch.ones((q.shape[0], nkv), dtype=torch.float32, device=dev)
            if not torch.equal(got, da.decode_attention(q, k8, v8, kl, k_scale=ones,
                                                          v_scale=ones)):
                raise AssertionError(f"phase 11 (a): K3 int8 without scales differs from the "
                                     f"launch with ones ({key}, {dtype})")
            check_rel(f"K3 decode int8, no scales, H={nh} KV={nkv} hd={hd} (= ones)", dtype,
                      got, ref.decode_attention(q.float(), k8, v8, kl), errs[key])
    torch.cuda.synchronize()

    log("phase 11 (a): times at the int8 paths' shapes, bf16 queries (kernel: profiler "
        "device time; plain and library: CUDA events per call; bound: int8 K/V bytes)")
    entries = {}
    dtype = "bfloat16"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    names = {"granite": "granite-3-2b", "qwen": "qwen2.5-14b"}
    for arch, (nh, nkv, hd) in heads.items():
        sfx = "" if arch == "granite" else "_qwen"
        q, kp, vp, bt, kl = int8_paged_inputs(torch, rng, dev, dtype, QW_KV_LEN, 1,
                                              (nh, nkv, hd))
        n_kv = sum(QW_KV_LEN)
        b, by = bound_ms(2 * 2 * q.numel() + 2 * n_kv * nkv * hd + 4 * (bt.numel() + 8),
                         4 * hd * nh * n_kv, dtype)
        entries[f"decode_int8{sfx}"] = dict(
            name=f"paged_decode_attention, int8 pool (hd {hd}, {names[arch]})", route="cuda",
            source="src/repro_torch/csrc/decode_common.cuh",
            replaces="src/repro/kernels/decode_attention.py:135",
            shape=f"B=8 kv_len={QW_KV_LEN} H={nh} KV={nkv} hd={hd} page={PAGE} "
                  f"{n_split(torch, q, nkv, bt.shape[1] * PAGE)} bf16 q, int8 K/V",
            **kernel_times(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, kl),
                           SPLIT_FMA),
            plain_ms=event_ms(torch, lambda: ref.paged_decode_attention(q, kp, vp, bt, kl),
                              10),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, widened_sdpa(torch, paged_sdpa, q, kp, vp, bt, kl), 20),
            library="SDPA, length mask, keys widened to bf16 and gathered before timing")
        for key, q_off in ((f"chunk_int8{sfx}", 256), (f"chunk_int8{sfx}_768", 768)):
            C = 256
            q, kp, vp, bt, kl = int8_paged_inputs(torch, rng, dev, dtype, [q_off + C], C,
                                                  (nh, nkv, hd))
            qo = torch.tensor([q_off], dtype=torch.int32, device=dev)
            pairs = sum(q_off + i + 1 for i in range(C)) * nh
            b, by = bound_ms(2 * 2 * q.numel() + 2 * (q_off + C) * nkv * hd
                             + 4 * (bt.numel() + 2), 4 * hd * pairs, dtype)
            entries[key] = dict(
                name=f"paged_prefill_attention, int8 pool (hd {hd}, q_offset {q_off}, "
                     f"{names[arch]})",
                route="cuda", source="src/repro_torch/csrc/prefill_common.cuh",
                replaces="src/repro/kernels/decode_attention.py:135",
                shape=f"B=1 C={C} q_offset={q_off} H={nh} KV={nkv} hd={hd} page={PAGE} "
                      "bf16 q, int8 K/V",
                **kernel_times(torch,
                               lambda: pa.paged_prefill_attention(q, kp, vp, bt, kl, qo),
                               "paged_prefill_mma_kernel"),
                plain_ms=event_ms(torch, lambda: ref.paged_prefill_attention(
                    q, kp, vp, bt, kl, qo), 10),
                bound_ms=b, bound_by=by,
                library_ms=event_ms(torch, widened_sdpa(torch, paged_chunk_sdpa, q, kp, vp,
                                                        bt, kl, qo), 20),
                library="SDPA, length and causal-offset mask, keys widened to bf16 and "
                        "gathered before timing")
    n_kv = sum(DECODE_KV_LEN)
    for key, (nh, nkv, hd), what in (
            ("dense_int8_rg", (RG_H, RG_KV, RG_HD), "recurrentgemma ring"),
            ("dense_int8_granite", (H, KV, HD), "granite dense")):
        q, k, _, kl = decode_inputs(torch, rng, dev, dtype, nh, nkv, hd)
        k8, v8 = int8_kv(torch, rng, k.shape, dev), int8_kv(torch, rng, k.shape, dev)
        q = q * 0.02
        b, by = bound_ms(2 * 2 * q.numel() + 2 * n_kv * nkv * hd + 4 * kl.numel(),
                         4 * hd * nh * n_kv, dtype)
        qt = q.transpose(1, 2)
        kt, vt = (x.to(torch.bfloat16).transpose(1, 2) for x in (k8, v8))
        lmask = (torch.arange(k.shape[1], device=dev)[None] < kl[:, None])[:, None, None]
        entries[key] = dict(
            name=f"decode_attention, int8 cache, no scales ({what})", route="cuda",
            source="src/repro_torch/csrc/decode_common.cuh",
            replaces="src/repro/kernels/decode_attention.py:31",
            shape=f"{what}: B=8 S=2048 H={nh} KV={nkv} hd={hd} kv_len 1..2048 ({n_kv} keys) "
                  f"{n_split(torch, q, nkv, k.shape[1])} bf16 q, int8 K/V",
            **kernel_times(torch, lambda: da.decode_attention(q, k8, v8, kl), SPLIT_FMA),
            plain_ms=event_ms(torch, lambda: ref.decode_attention(q, k8, v8, kl), 10),
            bound_ms=b, bound_by=by,
            library_ms=event_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=lmask,
                                                     enable_gqa=True), 20),
            library="SDPA, length mask, keys widened to bf16 before timing")
    for key, e in entries.items():
        e["max_abs_err"] = max(errs[key])
        log_row(e)
    return entries


def scaled_kv(torch, params, wk: float, wv: float) -> None:
    """wk (and bk) times ``wk``, wv (and bv) times ``wv``, in place."""
    from repro_torch.models.param import iter_leaves
    for path, leaf in iter_leaves(params):
        name = path.rsplit("/", 1)[-1]
        if name in ("wk", "bk"):
            leaf.mul_(wk)
        elif name in ("wv", "bv"):
            leaf.mul_(wv)


def saturated(torch, cache) -> str:
    """The int8 K and V leaves' share of values at -128 or 127."""
    from repro_torch.models.param import iter_leaves
    n = {"k": [0, 0], "v": [0, 0]}
    for path, t in iter_leaves(cache):
        name = path.rsplit("/", 1)[-1]
        if name in n and t.dtype == torch.int8:
            n[name][0] += int(((t == 127) | (t == -128)).sum())
            n[name][1] += int((t != 0).sum())
    return ", ".join(f"{k}: {a} of {b} nonzero values saturated" for k, (a, b) in n.items())


def cache_nbytes(cache) -> int:
    from repro_torch.models.param import iter_leaves
    return sum(t.numel() * t.element_size() for p, t in iter_leaves(cache)
               if p.rsplit("/", 1)[-1] in ("k", "v"))


def narrowed_cache(torch, cfg, cache, kv_dtype: str):
    """A prefill's dense cache in the leaves' dtypes of ``cache_specs(...,
    kv_dtype)``, through ``saturate_cast`` (the engine's install narrows a
    prefill into a narrower pool the same way)."""
    from repro_torch.device import torch_dtype
    from repro_torch.models import model as M
    from repro_torch.models.layers import saturate_cast
    from repro_torch.models.param import iter_leaves, map_tree
    dtypes = {path: spec.dtype for path, spec in iter_leaves(M.cache_specs(cfg, 1, 1, kv_dtype))}
    return map_tree(lambda path, t: saturate_cast(t, torch_dtype(kv_dtype))
                    if dtypes[path] == kv_dtype else t, cache)


def kv8_paged(torch, cfg, params, dev, B, T, kv_dtype="int8"):
    """B seeded prompts of ``KV8_PROMPT`` tokens in ``KV8_CHUNK``-token
    chunks into a paged pool of ``kv_dtype``, then T greedy decode steps,
    through the kernels (launch counts zeroed just before, read just
    after), then through ``impl="ref"`` on a pool of its own, teacher-forced
    on the kernels' tokens. Returns (launches, the kernels' logits a step,
    the plain path's, the kernels' pool, the plain path's pool)."""
    from repro_torch.models import model as M
    S, C = KV8_PROMPT, KV8_CHUNK
    rng = np.random.default_rng(41)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(B, S))).to(dev)
    P = -(-(S + T) // PAGE)
    table = (1 + torch.arange(B * P, dtype=torch.int32, device=dev)).reshape(B, P)

    def run(impl, force=None):
        cache = M.init_paged_cache(cfg, B, S + T, B * P + 1, PAGE, device=dev,
                                   kv_dtype=kv_dtype)
        for pos in range(0, S, C):
            logits, cache = M.prefill_chunk(cfg, params, cache, tokens[:, pos:pos + C], pos,
                                            table, impl=impl)
        out = [logits[:, -1].float()]
        for i in range(T):
            tok = out[-1].argmax(-1) if force is None else force[i]
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            logits, cache = M.decode_step(cfg, params, cache, tok[:, None], pos, impl=impl,
                                          block_tables=table)
            out.append(logits[:, 0].float())
        return out, cache

    zero_launches()
    got, cache = run(None)
    torch.cuda.synchronize()
    c = launches()
    want, cache_r = run("ref", force=[g.argmax(-1) for g in got[:-1]])
    return c, got, want, cache, cache_r


def held_logits(label, got, want, hold=True) -> float:
    """Log the kernels' logits a step against the plain path's (phase 4's
    rule: 5% of max|logit|) and the greedy agreement; raise past the
    tolerance if ``hold``. Returns the max difference."""
    diffs = [(a - b).abs().max().item() for a, b in zip(got, want)]
    scale = max(r.abs().max().item() for r in want)
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in zip(got, want))
    log(f"  {label}: max|logit diff| over {len(got)} steps x {got[0].shape[0]} rows "
        f"{max(diffs):.4f} (tol {0.05 * scale:.4f} = 5% of max|logit| {scale:.3f}"
        f"{'' if hold else ', read, not held'}; the prefill's, then every 8th step's "
        f"{['%.4f' % d for d in diffs[::8]]}); greedy agreement "
        f"{agree}/{len(got) * got[0].shape[0]}")
    if hold and max(diffs) > 0.05 * scale:
        raise AssertionError(f"phase 11 (b) {label}: logits differ by {max(diffs)}")
    return max(diffs)


def k_flips(torch, cache, cache_r) -> list:
    """Per attention layer, the int8 K entries in which two pools differ."""
    from repro_torch.models.param import iter_leaves
    other = dict(iter_leaves(cache_r))
    return [n for path, t in iter_leaves(cache) if path.rsplit("/", 1)[-1] == "k"
            for n in (t != other[path]).flatten(1).sum(1).tolist()]


def kv8_run(torch, dev):
    """Phase 11 (b): int8 K/V at the model's API (``kv_dtype="int8"``),
    granite-3-2b at full width and depth with wk x ``KV8_WK`` and wv x
    ``KV8_WV`` (V spans int8's range): 8 prompts of 1024 tokens in
    256-token chunks into an int8 paged pool (K1's int8 chunk instance),
    32 decode steps at B=8 (K1's int8 decode instance), then the same
    prompts prefilled whole into a dense int8 cache (narrowed) and 32
    decode steps (K3 int8, no scales); each through the kernels and
    through ``impl="ref"`` on its own cache, teacher-forced on the kernel
    path's greedy tokens, logits within phase 4's bf16 tolerance; the
    decode step's device busy beside the same step on a bf16 pool. Then wk
    x ``KV8_WK_SAT`` (K saturates): held over the first layer; over the
    first 4 and all 40 read, not held, on an int8 pool beside a bf16
    pool, with the K entries the two int8 pools differ in a layer. Then
    qwen2.5-14b at full width
    and depth on an int8 paged pool (K1's hd-128 int8 instances) and
    recurrentgemma-2b's int8 rings over 2100-token prompts the same way.
    Returns the launch counts of the kernel paths by row key."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockKind
    from repro_torch.models import model as M
    from repro_torch.models.param import map_tree

    cfg = get_config("granite-3-2b")
    params = M.init_model_params(cfg, 0, dev)
    scaled_kv(torch, params, KV8_WK, KV8_WV)
    rng = np.random.default_rng(41)
    B, S, C, T = KV8_B, KV8_PROMPT, KV8_CHUNK, KV8_STEPS
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab, size=(B, S))).to(dev)
    log(f"phase 11 (b): {cfg.name} {cfg.n_layers} layers bf16, wk x {KV8_WK:g}, wv x "
        f"{KV8_WV:g}; "
        f"int8 K/V at the model's API (kv_dtype='int8'): B={B} prompts of {S} tokens in "
        f"{C}-token chunks into a paged pool, then {T} decode steps; the same prompts "
        "prefilled whole into a dense cache, then the same steps")

    def decode_run(impl, cache, first, force=None):
        out, tok = [first], first.argmax(-1)
        for i in range(T):
            if force is not None:
                tok = force[i]
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            logits, cache = M.decode_step(cfg, params, cache, tok[:, None], pos, impl=impl)
            out.append(logits[:, 0].float())
            tok = out[-1].argmax(-1)
        return out

    counts = {}
    want_c = {"chunk": cfg.n_layers * (S // C), "decode": cfg.n_layers * T}
    with torch.no_grad():
        c, got, want, cache, cache_r = kv8_paged(torch, cfg, params, dev, B, T)
        counts.update(chunk_int8=c["chunk"], chunk_int8_768=c["chunk"],
                      decode_int8=c["decode"])
        if c["chunk"] != want_c["chunk"] or c["decode"] != want_c["decode"] or \
                c["flash"] or c["dense"]:
            raise AssertionError(f"phase 11 (b): paged int8 launches {c}: need {want_c}")
        n_pages = cache_r["blocks"]["p0"]["k"].shape[1]
        pool8 = cache_nbytes(cache)
        log(f"  int8 paged pool: {pool8} B of K/V for {n_pages} pages of {PAGE} tokens "
            f"({pool8 // (n_pages * PAGE)} B a token over {cfg.n_layers} layers; "
            f"{saturated(torch, cache)}); launches {c}")
        held_logits("paged int8 pool, kernels vs impl='ref'", got, want)
        del cache_r
        P = -(-(S + T) // PAGE)
        table = (1 + torch.arange(B * P, dtype=torch.int32, device=dev)).reshape(B, P)
        pos_t = torch.full((B,), S + T // 2, dtype=torch.int32, device=dev)
        tok_t = got[-1].argmax(-1)[:, None]
        busy = {}
        for kv_dtype in ("int8", "bfloat16"):
            if kv_dtype != "int8":
                cache = M.init_paged_cache(cfg, B, S + T, n_pages, PAGE, device=dev)
                for pos in range(0, S, C):
                    _, cache = M.prefill_chunk(cfg, params, cache, tokens[:, pos:pos + C],
                                               pos, table)
            nb = cache_nbytes(cache)
            _, busy[kv_dtype], _ = profile_breakdown(
                torch, f"{cfg.name} B={B} decode step, {kv_dtype} pool ({nb} B)",
                lambda: [M.decode_step(cfg, params, cache, tok_t, pos_t, block_tables=table)
                         for _ in range(5)], 5)
        log(f"  decode step device busy: int8 pool {busy['int8']:.3f} ms, bf16 pool "
            f"{busy['bfloat16']:.3f} ms (same call, eager); K/V a token "
            f"{2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd} B int8 vs "
            f"{4 * cfg.n_layers * cfg.n_kv_heads * cfg.hd} B bf16")
        del cache
        torch.cuda.empty_cache()

        # the dense layout: a whole prefill, narrowed into the int8 cache
        res = {}
        for impl in (None, "ref"):
            zero_launches()
            logits, dense = M.prefill(cfg, params, {"tokens": tokens}, cache_len=S + T,
                                      impl=impl)
            dense = narrowed_cache(torch, cfg, dense, "int8")
            if impl is None:
                zero_launches()
                res[impl] = decode_run(impl, dense, logits[:, -1].float())
                torch.cuda.synchronize()
                c = launches()
                counts["dense_int8_granite"] = c["dense"]
                if c["dense"] != cfg.n_layers * T or c["decode"] or c["chunk"]:
                    raise AssertionError(f"phase 11 (b): dense int8 launches {c}")
            else:
                res[impl] = decode_run(impl, dense, logits[:, -1].float(),
                                       force=[g.argmax(-1) for g in res[None][:-1]])
            del dense
        held_logits("dense int8 cache, kernels vs impl='ref'", res[None], res["ref"])
        del res, got, want

        # wk x KV8_WK_SAT: K saturates too; held over the first layer, read
        # over 4 and 40 on both pools
        scaled_kv(torch, params, KV8_WK_SAT / KV8_WK, 1.0)
        for depth in (1, *KV8_WITNESS_DEPTHS):
            sub = dataclasses.replace(cfg, n_layers=depth)
            sub_params = map_tree(lambda path, t: t[:depth] if path.startswith("blocks/")
                                  else t, params)
            steps = T if depth == 1 else KV8_WITNESS_STEPS
            for kv_dtype in ("int8",) if depth == 1 else ("bfloat16", "int8"):
                c, got, want, cache, cache_r = kv8_paged(torch, sub, sub_params, dev, B, steps,
                                                         kv_dtype)
                what = f"wk x {KV8_WK_SAT:g}, the first {depth} of {cfg.n_layers} layers, " \
                       f"{kv_dtype} pool"
                if kv_dtype == "int8":
                    k_sat = int(((cache["blocks"]["p0"]["k"] == 127) |
                                 (cache["blocks"]["p0"]["k"] == -128)).sum())
                    log(f"  {what}: {saturated(torch, cache)}; K entries the two pools differ "
                        f"in, a layer: {k_flips(torch, cache, cache_r)}; launches {c}")
                    if not c["chunk"] or not c["decode"] or not k_sat:
                        raise AssertionError(f"phase 11 (b) {what}: launches {c}, or no K "
                                             "value saturated")
                held_logits(f"{what}, kernels vs impl='ref'", got, want, hold=depth == 1)
                del cache, cache_r
            del sub_params
    del params, got, want
    torch.cuda.empty_cache()

    qw = get_config("qwen2.5-14b")
    params = M.init_model_params(qw, 0, dev)
    scaled_kv(torch, params, KV8_WK, KV8_WV)
    log(f"phase 11 (b): {qw.name} {qw.n_layers} layers, wk x {KV8_WK:g}, wv x {KV8_WV:g}: "
        f"B={QW8_B} prompts of {S} tokens in {C}-token chunks into an int8 paged pool, then "
        f"{QW8_STEPS} decode steps (K1's hd-128 int8 instances)")
    with torch.no_grad():
        c, got, want, cache, cache_r = kv8_paged(torch, qw, params, dev, QW8_B, QW8_STEPS)
        want_c = {"chunk": qw.n_layers * (S // C), "decode": qw.n_layers * QW8_STEPS}
        if c["chunk"] != want_c["chunk"] or c["decode"] != want_c["decode"] or \
                c["flash"] or c["dense"]:
            raise AssertionError(f"phase 11 (b): qwen int8 launches {c}: need {want_c}")
        log(f"  {saturated(torch, cache)}; launches {c}")
        held_logits("qwen paged int8 pool, kernels vs impl='ref'", got, want)
        counts.update(chunk_int8_qwen=c["chunk"], chunk_int8_qwen_768=c["chunk"],
                      decode_int8_qwen=c["decode"])
        del cache, cache_r, got, want
    del params
    torch.cuda.empty_cache()

    rg = get_config("recurrentgemma-2b")
    params = M.init_model_params(rg, 0, dev)
    scaled_kv(torch, params, KV8_WK, KV8_WV)
    toks = torch.from_numpy(rng.integers(3, rg.vocab, size=(RG8_B, RG8_PROMPT))).to(dev)
    log(f"phase 11 (b): {rg.name} {rg.n_layers} layers, wk x {KV8_WK:g}, wv x {KV8_WV:g}: "
        f"B={RG8_B} "
        f"prompts of {RG8_PROMPT} tokens prefilled whole, the window rings narrowed to int8, "
        f"{RG8_STEPS} decode steps (the rings wrap at {rg.window})")
    out = {}
    with torch.no_grad():
        for impl in (None, "ref"):
            logits, cache = M.prefill(rg, params, {"tokens": toks}, cache_len=RG8_PROMPT
                                      + RG8_STEPS, impl=impl)
            cache = narrowed_cache(torch, rg, cache, "int8")
            seq, tok = [logits[:, -1].float()], logits[:, -1].argmax(-1)
            if impl is None:
                zero_launches()
            for i in range(RG8_STEPS):
                if impl == "ref":
                    tok = out[None][i].argmax(-1)
                pos = torch.full((RG8_B,), RG8_PROMPT + i, dtype=torch.int32, device=dev)
                logits, cache = M.decode_step(rg, params, cache, tok[:, None], pos, impl=impl)
                seq.append(logits[:, 0].float())
                tok = seq[-1].argmax(-1)
            if impl is None:
                torch.cuda.synchronize()
                c = launches()
                counts["dense_int8_rg"] = c["dense"]
                n_local = sum(rg.pattern[j % len(rg.pattern)] == BlockKind.LOCAL_ATTN
                              for j in range(rg.n_layers))
                if c["dense"] != n_local * RG8_STEPS or c["decode"] or c["chunk"]:
                    raise AssertionError(f"phase 11 (b): recurrentgemma int8 ring launches "
                                         f"{c}: need {n_local} K3 a step")
                log(f"  ring decode launches {c} ({n_local} local-attention layers x "
                    f"{RG8_STEPS} steps)")
            out[impl] = seq
            del cache
    diffs = [(a - b).abs().max().item() for a, b in zip(out[None], out["ref"])]
    scale = max(r.abs().max().item() for r in out["ref"])
    log(f"  recurrentgemma int8 rings, kernels vs impl='ref': max|logit diff| {max(diffs):.4f} "
        f"(tol {0.05 * scale:.4f} = 5% of max|logit| {scale:.3f})")
    if max(diffs) > 0.05 * scale:
        raise AssertionError(f"phase 11 (b): recurrentgemma int8 ring logits differ by "
                             f"{max(diffs)}")
    del params
    torch.cuda.empty_cache()
    return counts


def w8_serve(torch, cfg, params, dev, prompts, new_tokens, **kw):
    """Serve ``prompts`` twice on one paged engine (the first run captures
    the step graphs) and read the second run: (engine, {req_id: tokens},
    TTFT p50 ms, decode ms/step, wall s of the second run, peak GB over
    both runs); the engine's own counters hold both runs."""
    from repro_torch.serve.engine import Request, ServingEngine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(cfg, params, max_slots=len(prompts), max_len=2048,
                           page_size=PAGE, device=dev, **kw)
    outs = []
    for _ in range(2):
        k0, s0, n0 = len(engine.ttft_s), engine.decode_s, engine.n_decode_steps
        reqs = [Request(prompt=list(p), max_new_tokens=new_tokens, req_id=i)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        done = engine.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs.append({r.req_id: list(r.output) for r in done})
    if outs[0] != outs[1]:
        raise AssertionError(f"phase 11: {cfg.name} served the same prompts twice with other "
                             f"tokens: {outs}")
    ttft = sorted(engine.ttft_s[k0:])
    step_ms = (engine.decode_s - s0) / (engine.n_decode_steps - n0) * 1e3
    return (engine, outs[1], ttft[len(ttft) // 2] * 1e3, step_ms, wall,
            torch.cuda.max_memory_allocated() / 1e9)


def tree_bytes(params) -> int:
    from repro_torch.models.param import iter_leaves
    return sum(t.numel() * t.element_size() for _, t in iter_leaves(params))


def agreement(outs, want) -> str:
    """Greedy tokens of ``outs`` against ``want``: requests equal, and the
    tokens of the common prefixes before the first difference."""
    same = sum(outs[i] == want[i] for i in want)
    prefix = sum(next((j for j, (a, b) in enumerate(zip(outs[i], want[i])) if a != b),
                      min(len(outs[i]), len(want[i]))) for i in want)
    total = sum(len(w) for w in want.values())
    return f"{same}/{len(want)} requests equal, {prefix}/{total} tokens before the first " \
           "difference"


def w8_run(torch, dev) -> None:
    """Phase 11 (c): int8 weights (``narrow_weights`` of granite-3-2b's
    seeded bf16 tree) served by the paged engine, captured: K2 and K1
    decode launched (counts zeroed just before, read just after); the
    first logits of a prefill bit for bit those of the same int8 values
    dequantized once on the host into a bf16 tree, and that tree served by
    the same engine gives the same tokens (same values, same kernels);
    greedy tokens beside the engine's ``impl="ref"`` run and the
    teacher-forced logits against ``impl="ref"`` (phase 4's rule); peak
    GB, TTFT p50 and decode ms/step of both trees, the launches beside
    them (the same K2 and K1 decode instances as bf16 weights: the
    activations stay bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.layers import dequantize
    from repro_torch.models.param import iter_leaves, map_tree

    cfg = get_config("granite-3-2b")
    params8 = M.narrow_weights(M.init_model_params(cfg, 0, dev))
    torch.cuda.empty_cache()
    n8 = sum(t.dtype == torch.int8 for _, t in iter_leaves(params8))
    log(f"phase 11 (c): {cfg.name} {cfg.n_layers} layers, int8 weights (narrow_weights of the "
        f"seed-0 bf16 tree: {n8} of {len(list(iter_leaves(params8)))} leaves int8, "
        f"{tree_bytes(params8) / 1e9:.2f} GB) through ServingEngine, paged, captured; "
        f"{len(GRANITE_PROMPTS)} prompts {GRANITE_PROMPTS}, {MAX_NEW} new tokens")
    t0 = time.perf_counter()
    host = map_tree(lambda _, t: dequantize(t.cpu(), torch.bfloat16), params8)
    log(f"  the same values dequantized once on the host into a bf16 tree "
        f"({tree_bytes(host) / 1e9:.2f} GB, {time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab, size=n).tolist() for n in GRANITE_PROMPTS]
    res = {}
    with torch.no_grad():
        zero_launches()
        engine, res["int8"], ttft, step, wall, peak = w8_serve(torch, cfg, params8, dev,
                                                               prompts, MAX_NEW)
        c = launches()
        if not c["flash"] or not c["decode"] or c["chunk"] or c["dense"]:
            raise AssertionError(f"phase 11 (c): int8-weight launches {c}: need K2 and K1 "
                                 "decode only")
        log(f"  int8 weights: peak {peak:.2f} GB allocated, TTFT p50 {ttft:.1f} ms, decode "
            f"{step:.2f} ms/step, {wall:.3f} s for the second run; launches {c} over both "
            f"runs; {graphs_summary(torch, engine)}")
        engine = None
        torch.cuda.empty_cache()
        _, res["ref"], *_ = w8_serve(torch, cfg, params8, dev, prompts, MAX_NEW, impl="ref")
        log(f"  greedy tokens against the engine's impl='ref' run (bf16; a near tie may "
            f"flip one, as phase 4 counts): {agreement(res['int8'], res['ref'])}")
        torch.cuda.empty_cache()
        logits_parity(torch, cfg, params8, dev, S=300, paged=True)
        deq = map_tree(lambda _, t: t.to(dev), host)
        del host
        batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab, size=(2, 300))).to(dev)}
        l8, _ = M.prefill(cfg, params8, batch)
        lb, _ = M.prefill(cfg, deq, batch)
        if not torch.equal(l8, lb):
            raise AssertionError(f"phase 11 (c): int8-weight logits differ from the host-"
                                 f"dequantized tree's by {(l8 - lb).abs().max().item()}")
        log(f"  first logits (prefill B=2 x 300 tokens) bit for bit equal: int8 weights "
            f"dequantized at use vs the host-dequantized bf16 tree")
        del params8, l8, lb
        torch.cuda.empty_cache()
        engine, res["bf16"], ttft_b, step_b, wall_b, peak_b = w8_serve(torch, cfg, deq, dev,
                                                                       prompts, MAX_NEW)
        engine = None
    if res["bf16"] != res["int8"]:
        raise AssertionError(f"phase 11 (c): the dequantized bf16 tree served other tokens: "
                             f"{agreement(res['bf16'], res['int8'])}")
    log(f"  bf16 tree of the same values: the same tokens; peak {peak_b:.2f} GB, TTFT p50 "
        f"{ttft_b:.1f} ms, decode {step_b:.2f} ms/step ({wall_b:.3f} s); int8 / bf16 decode "
        f"ms/step {step / step_b:.3f}, peak {peak / peak_b:.3f}")
    del deq
    torch.cuda.empty_cache()


def int8_model_params(torch, cfg, seed: int, dev):
    """Random int8 weights of ``cfg`` made on ``dev`` a layer at a time: each
    leaf of ``param_specs`` drawn (bf16) one period slice at a time and
    narrowed as ``narrow_weights`` narrows the tree as laid out (every
    leaf of 2 or more dimensions, stacked slices included), so neither the
    bf16 tree nor a float32 draft of a whole stacked leaf is ever held;
    1-d leaves stay bf16."""
    from repro_torch.models import model as M
    from repro_torch.models.param import Spec, init_params, map_tree

    def leaf(path, spec):
        if len(spec.shape) < 2:
            return init_params({path: spec}, seed, cfg.dtype, dev)[path]
        scale = spec.scale if spec.scale is not None else spec.shape[-2] ** -0.5
        out = torch.empty(spec.shape, dtype=torch.int8, device=dev)
        stacked = path.split("/")[0] in ("blocks", "encoder")
        for i in range(spec.shape[0] if stacked else 1):
            one = Spec(spec.shape[1:] if stacked else spec.shape, init=spec.init,
                       scale=scale, dtype=spec.dtype)
            w = init_params({f"{path}/{i}": one}, seed, cfg.dtype, dev)[f"{path}/{i}"]
            q = M.narrow_weights({"w": w[None] if stacked else w})["w"]
            if stacked:
                out[i] = q[0]
            else:
                out.copy_(q)
        return out
    return map_tree(leaf, M.param_specs(cfg))


def llava8_run(torch, dev) -> None:
    """Phase 11 (d): llava-next-34b at all 60 layers from int8 weights
    (``int8_model_params``), text-only through the paged engine, B=2,
    captured: peak GB, TTFT, decode ms/step and its memory bound
    (``memory_model`` with ``weight_bytes=1``), launches one K2 a layer a
    prefill and one K1 decode a layer a step; then its logits against
    ``impl="ref"`` at the first decode step (phase 4's rule)."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.roofline.analysis import HBM_BW
    from repro_torch.roofline.analytic import memory_model
    from repro_torch.serve.step_graph import empty_cache

    cfg = get_config("llava-next-34b")
    empty_cache()
    free, total_mem = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params8 = int8_model_params(torch, cfg, 0, dev)
    torch.cuda.synchronize()
    made_s, made_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 11 (d): {cfg.name} at all {cfg.n_layers} layers (d={cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} d_ff={cfg.d_ff} vocab {cfg.padded_vocab}), "
        f"int8 weights: {cfg.n_params / 1e9:.2f} B parameters, {tree_bytes(params8) / 1e9:.2f} "
        f"GB, made in {made_s:.1f} s ({made_peak:.1f} GB peak; {free / 1e9:.1f} of "
        f"{total_mem / 1e9:.1f} GB free before)")
    rng = np.random.default_rng(33)
    prompts = [rng.integers(3, cfg.vocab, size=LV8_PROMPT).tolist() for _ in range(LV_B)]
    L = cfg.n_layers
    with torch.no_grad():
        zero_launches()
        engine, outs, ttft, step, wall, peak = w8_serve(torch, cfg, params8, dev, prompts,
                                                        LV8_STEPS)
        c = launches()
        want = {k: 0 for k in c}
        want.update(flash=L * engine.n_prefills, decode=L * engine.n_decode_steps)
        if c != want or not all(1 <= len(o) <= LV8_STEPS for o in outs.values()):
            raise AssertionError(f"phase 11 (d): launches {c}, need {want}; outputs {outs}")
        context = LV8_PROMPT + LV8_STEPS // 2
        bound = memory_model(cfg, InputShape("serve_decode", context, LV_B, "decode"),
                             data=1, model=1, weight_bytes=1) / HBM_BW * 1e3
        log(f"  served text-only, paged, captured, B={LV_B} x {LV8_PROMPT} tokens, "
            f"{LV8_STEPS} new: peak {peak:.2f} GB allocated, TTFT p50 {ttft:.1f} ms, decode "
            f"{step:.2f} ms/step, memory bound {bound:.2f} ms at int8 weights (fraction "
            f"{bound / step:.4f}), {wall:.3f} s for the second run; launches {c} over both "
            "runs (one K2 a layer a prefill, one K1 decode a layer a step)")
        log(f"  {graphs_summary(torch, engine)}")
        engine = None
        torch.cuda.empty_cache()
        logits_parity(torch, cfg, params8, dev, S=LV8_PROMPT, paged=True, steps=1)
    log(f"  {cfg.name}: {torch.cuda.max_memory_allocated() / 1e9:.1f} GB peak allocated over "
        "phase 11 (d)")
    del params8
    torch.cuda.empty_cache()


def priced_backend_run(torch, dev, smi: str) -> None:
    """Phase 11 (e): one ``Gateway.invoke`` through ``EngineBackend(
    accelerator_spec=AcceleratorSpec(type="h100", active_watts=<the card's
    power limit>))``: the invocation runs on the spec's type and the
    metrics' energy counter equals the reference's formula, active_watts x
    ELat, over its held seconds."""
    from repro_torch.configs import get_config
    from repro_torch.core.accelerator import AcceleratorSpec
    from repro_torch.gateway import EngineBackend, Gateway
    from repro_torch.serve.api import make_serve_runtime

    watts = float(smi.split(",")[1].split()[0])
    spec = AcceleratorSpec(type="h100", active_watts=watts)
    eb = EngineBackend(accelerator_spec=spec, n_workers=1, device=dev)
    try:
        gw = Gateway(eb)
        rdef = make_serve_runtime(get_config("granite-3-2b"), max_slots=2, max_len=256,
                                  device=dev)
        gw.register(rdef)
        fut = gw.invoke(rdef.runtime_id, {"prompts": [list(range(3, 67))]},
                        config={"max_new_tokens": 8})
        out = fut.result()
        inv = fut.invocation
        row = gw.metrics.accelerator_usage()["h100"]
        joules = spec.invocation_joules(inv.elat)
        if not inv.accelerator.endswith("(h100)") or len(out["outputs"][0]) != 8 or \
                abs(row["energy_joules"] - joules) > 1e-9 * max(joules, 1.0):
            raise AssertionError(f"phase 11 (e): accelerator {inv.accelerator}, outputs {out}, "
                                 f"energy {row} against {joules} J")
        log(f"phase 11 (e): Gateway.invoke -> EngineBackend(accelerator_spec=AcceleratorSpec("
            f"type='h100', active_watts={watts})) -> granite-3-2b: ran on {inv.accelerator}, "
            f"cold={int(inv.cold_start)} ELat {inv.elat:.4f} s; energy counter "
            f"{row['energy_joules']:.4f} J = {watts} W x {inv.elat:.4f} s ({joules:.4f} J), "
            f"busy {row['busy_s']:.4f} s, {int(row['n_invocations'])} invocation; backlog "
            f"{eb.backlog_by_type()}")
    finally:
        eb.shutdown()
        torch.cuda.empty_cache()


# each engine twin's last line (its reference example's, numbers aside, in
# the twin's wording)
TWIN_LAST = {
    "unified_gateway": r"  \[engine\] ELat pN = Ns, cold starts = N, RSuccess = N/N",
    "serve_cluster": r"OK — serverless serving with real PyTorch execution",
    "cluster_quickstart": r"workflow chain \(\(N\+N\)\+N\)\+N = N across worker processes "
                          r"in Ns",
}


def example_twins_run() -> None:
    """Phase 11 (f): the three engine example twins as subprocesses on the
    card (their default device), at the reference examples' own reduced
    sizes; each must exit 0 and end with its reference's last line."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for name, last in TWIN_LAST.items():
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}"],
                             capture_output=True, text=True, timeout=300, env=env, cwd=root)
        lines = out.stdout.splitlines()
        shape = re.sub(r"\d+(\.\d+)?", "N", lines[-1]) if lines else ""
        if out.returncode != 0 or not re.fullmatch(last, shape):
            raise AssertionError(f"phase 11 (f): {name} exited {out.returncode}, last line "
                                 f"{lines[-1:]}:\n{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
        log(f"phase 11 (f): repro_torch.examples.{name} on the card in "
            f"{time.perf_counter() - t0:.1f} s, {len(lines)} lines, last: {lines[-1]!r}")
        for line in lines[:-1]:
            log(f"    {line}")


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
    check_no_spill(build)

    entries = phase_kernels(torch, dev)
    entries.update(phase_kernels_moe(torch, dev))
    entries.update(phase_kernels_catalogue(torch, dev))
    entries.update(phase_kernels_whisper(torch, dev))
    entries.update(phase_kernels_llava(torch, dev))
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
        profiled = page_size and not chunk
        engine, counts, first, reading, _ = serve_pair(
            torch, cfg, dev, page_size=page_size, prefill_chunk=chunk, max_len=2048,
            prompt_lens=GRANITE_PROMPTS, need=need,
            absent=["scan"] + (["dense"] if page_size else ["decode", "chunk"]),
            context=256 if profiled else None, prefill_len=1024,
            chunked_len=1024 if chunk else None)
        total["flash"] += counts["flash"]
        total["decode"] += counts["decode"]
        total["chunk"] += counts["chunk"]
        total["chunk_768"] = total["chunk"]
        total["dense_granite"] += counts["dense"]
        if profiled:
            firsts[cfg.name] = (cfg, first)
            readings.append(reading)
            params = engine.params
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
    engine, counts, first, reading, _ = serve_pair(
        torch, rg, dev, page_size=PAGE, prefill_chunk=0, max_len=4096,
        prompt_lens=RG_PROMPTS, need=["flash", "dense", "scan"],
        absent=["decode", "chunk"], context=2100, prefill_len=3000)
    total["flash_rg"] = counts["flash"]
    total["dense_rg"] = counts["dense"]
    total["scan"] = counts["scan"]
    firsts[rg.name] = (rg, first)
    readings.append(reading)
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
                        dict(page_size=PAGE, graphs=False),
                        dict(page_size=PAGE, prefill_chunk=256),
                        dict(page_size=PAGE, prefill_chunk=256, impl="ref"),
                        dict(page_size=PAGE, prefill_chunk=256, graphs=False),
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
    engine, counts, first, reading, _ = serve_pair(
        torch, l4, dev, page_size=PAGE, prefill_chunk=0, max_len=9216,
        prompt_lens=L4_PROMPTS, need=["flash", "decode", "dense", "gmm"],
        absent=["chunk", "scan"], context=1024, prefill_len=2048)
    log(f"  {l4.name}: {sum(t.numel() for _, t in iter_leaves(engine.params)) / 1e9:.2f} B "
        f"parameters, {torch.cuda.max_memory_allocated() / 1e9:.1f} GB peak allocated")
    total["flash_l4"], total["decode_l4"] = counts["flash"], counts["decode"]
    total["dense_l4"] = counts["dense"]
    for key in GMM_KEYS:
        total[key] = counts["gmm"]
    firsts[l4.name] = (l4, first)
    readings.append(reading)
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
        "registered) through Gateway.submit_workflow -> EngineBackend on the card, the "
        "captioner's decode steps captured as CUDA graphs")
    wf_counts = workflow_run(torch)
    for key, row in (("flash", "flash_enc"), ("decode", "decode")):
        entries[f"{row}_workflow"] = dict(entries[row], name=entries[row]["name"] + ", via Workflow")
        total[f"{row}_workflow"] = wf_counts[key]
    log(f"phase 8: done in {time.perf_counter() - t8:.1f} s")

    # phase 9: xLSTM served through the engine, llava's patch prefix
    t9 = time.perf_counter()
    xlstm_run(torch, dev)
    total.update(llava_run(torch, dev))
    entries["flash_llava_engine"] = dict(
        entries["flash_llava"], name=entries["flash_llava"]["name"] + ", via ServingEngine")
    log(f"phase 9: done in {time.perf_counter() - t9:.1f} s")

    # phase 10: training on the card (backward kernels, granite-3-2b and
    # recurrentgemma-2b at full width and depth, checkpoint, guards; K4's
    # backward, llama4-scout at full width cut to 2 layers)
    train_entries, train_totals = training_run(torch, dev)
    entries.update(train_entries)
    total.update(train_totals)

    # phase 11: int8 weights and int8 K/V caches (K1's int8 instances, K3
    # without scales; granite and recurrentgemma at the model's API,
    # granite's int8 weights through the engine, llava-next-34b at all 60
    # layers), the priced EngineBackend, the engine example twins
    t11 = time.perf_counter()
    entries.update(phase_kernels_int8(torch, dev))
    torch.cuda.empty_cache()
    total.update(kv8_run(torch, dev))
    w8_run(torch, dev)
    llava8_run(torch, dev)
    priced_backend_run(torch, dev, smi)
    example_twins_run()
    log(f"phase 11: done in {time.perf_counter() - t11:.1f} s")

    kernels = []
    for key in ("decode", "chunk", "chunk_768", "flash", "flash_rg", "dense_rg", "dense_granite",
                "scan", "flash_l4", "decode_l4", "dense_l4", *GMM_KEYS, "flash_gateway",
                "decode_gateway", "flash_cp", "decode_cp", "flash_sim", "decode_sim",
                "flash_cluster", "decode_cluster", "flash_qwen", "decode_qwen", "chunk_qwen",
                "chunk_qwen_768", "dense_qwen", "flash_ds", "decode_ds", "flash_enc",
                "flash_cross", "dense_cross", "flash_enc_workflow", "decode_workflow",
                "flash_llava", "dense_llava", "flash_llava_engine", "decode_llava",
                "flash_train", "flash_rg_train", "scan_train", "flash_bwd_granite",
                "flash_bwd_rg", "scan_bwd", "flash_l4_train", "flash_bwd_l4", "gmm_train",
                *GMM_BWD_ROWS, "decode_int8", "decode_int8_qwen", "chunk_int8",
                "chunk_int8_768", "chunk_int8_qwen", "chunk_int8_qwen_768", "dense_int8_rg",
                "dense_int8_granite"):
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
