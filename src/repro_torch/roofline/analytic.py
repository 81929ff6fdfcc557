"""Analytic FLOP/byte models for the operators stubbed out of the cost
probes (attention, mLSTM chunk recurrence, RG-LRU scan): the port's copy
of ``repro.roofline.analytic`` (framework-free there too; the port
imports nothing of ``repro``).

The one change: the flash kernel's query block is an argument,
``block_q``, whose default is the port's K2 query tile (``MBQ`` = 64 rows
in ``csrc/prefill_common.cuh``) where the reference fixes the Pallas
kernel's 256; ``block_q=256`` gives the reference's numbers.

Why: a loop-free attention lowering materializes S x S scores the flash
kernels never write to HBM, so it does not report the deployed kernel's
traffic. These closed forms model the flash kernels' HBM behaviour (stream
K/V per query block, accumulators held on chip) and textbook matmul FLOPs.

All results are GLOBAL (whole cluster); the caller divides by the number of
chips that actually parallelize the op (batch x head sharding).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import BlockKind, InputShape, ModelConfig

BF16 = 2
F32 = 4
BLOCK_Q = 64           # K2's query rows per block (csrc/prefill_common.cuh MBQ)


def _skv_eff(sq: int, skv: int, causal: bool, window: int, chunk: int) -> float:
    """Average number of keys each query attends to."""
    if window:
        w = min(window, skv)
        if sq >= w:
            return (w * (w + 1) / 2 + (sq - w) * w) / sq
        return (sq + 1) / 2
    if chunk:
        c = min(chunk, sq)
        return (c + 1) / 2
    if causal and sq == skv:
        return (sq + 1) / 2
    return float(skv)


def attention_layer(cfg: ModelConfig, kind: BlockKind, sq: int, batch: int,
                    train: bool, cross: bool = False, block_q: int = BLOCK_Q
                    ) -> Tuple[float, float]:
    """(flops, hbm_bytes) for ONE attention layer, global, fwd(+bwd)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window = cfg.window if kind == BlockKind.LOCAL_ATTN else 0
    chunk = cfg.chunk if kind == BlockKind.CHUNKED_ATTN else 0
    skv = cfg.n_frames if cross else sq
    causal = not cross
    skv_eff = _skv_eff(sq, skv, causal, window, chunk)

    # FLOPs: QK^T + PV, 2 flops per MAC
    flops_fwd = 4.0 * batch * H * sq * skv_eff * hd
    # bwd ~ 2x fwd; remat recompute ~ +1x fwd
    flops = flops_fwd * (4.0 if train else 1.0)

    # HBM traffic (flash kernel): Q read + O write once; K/V streamed once
    # per query block (bounded by the masked span).
    n_q = max(1, -(-sq // block_q))
    qo = 2.0 * batch * H * sq * hd * BF16
    kv_stream = 2.0 * batch * KV * min(skv_eff * 2, skv) * hd * BF16 * n_q
    bytes_fwd = qo + kv_stream
    bytes_ = bytes_fwd * (3.0 if train else 1.0)
    return flops, bytes_


def mlstm_layer(cfg: ModelConfig, sq: int, batch: int, train: bool,
                chunk: int = 512) -> Tuple[float, float]:
    """Chunkwise-parallel mLSTM core (projections are in the probe)."""
    di = 2 * cfg.d_model
    nh = cfg.n_heads
    hd = di // nh
    C = min(chunk, sq)
    n_chunks = max(1, sq // C)
    # intra-chunk scores + PV: 2 x (2 B nh C^2 hd); state update/query:
    # ~3 x (2 B nh C hd^2) per chunk
    flops_fwd = batch * nh * n_chunks * (4.0 * C * C * hd + 6.0 * C * hd * hd)
    flops = flops_fwd * (4.0 if train else 1.0)
    # stream q,k,v + write h (f32 compute stream on chip; HBM side bf16-ish)
    qkvh = 4.0 * batch * sq * di * BF16
    states = 2.0 * batch * nh * hd * hd * F32 * n_chunks
    bytes_ = (qkvh + states) * (3.0 if train else 1.0)
    return flops, bytes_


def rglru_layer(cfg: ModelConfig, sq: int, batch: int, train: bool
                ) -> Tuple[float, float]:
    """Single-pass sequential scan kernel: read a,b once, write h once."""
    D = cfg.d_model
    flops = 4.0 * batch * sq * D * (3.0 if train else 1.0)
    bytes_ = 3.0 * batch * sq * D * F32 * (3.0 if train else 1.0)
    return flops, bytes_


def stubbed_op_costs(cfg: ModelConfig, shape: InputShape,
                     block_q: int = BLOCK_Q) -> Tuple[float, float]:
    """Total (flops, bytes) of all probe-stubbed ops, global."""
    train = shape.kind == "train"
    sq, batch = shape.seq_len, shape.global_batch
    flops = bytes_ = 0.0
    for kind in cfg.layer_pattern:
        if kind in (BlockKind.ATTN, BlockKind.LOCAL_ATTN,
                    BlockKind.CHUNKED_ATTN):
            f, b = attention_layer(cfg, kind, sq, batch, train,
                                   block_q=block_q)
            if cfg.is_encdec:
                fc, bc = attention_layer(cfg, kind, sq, batch, train,
                                         cross=True, block_q=block_q)
                f, b = f + fc, b + bc
            flops += f
            bytes_ += b
        elif kind == BlockKind.MLSTM:
            f, b = mlstm_layer(cfg, sq, batch, train)
            flops += f
            bytes_ += b
        elif kind == BlockKind.RGLRU:
            f, b = rglru_layer(cfg, sq, batch, train)
            flops += f
            bytes_ += b
        # SLSTM: recurrence handled by the explicit while-loop adjustment
    if cfg.is_encdec:
        # encoder self-attention over n_frames (bidirectional)
        f, b = 0.0, 0.0
        for _ in range(cfg.n_encoder_layers):
            fe, be = attention_layer(cfg, BlockKind.ATTN, cfg.n_frames,
                                     batch, train, cross=False,
                                     block_q=block_q)
            f, b = f + fe, b + be
        flops += f
        bytes_ += b
    return flops, bytes_


def moe_weight_traffic_per_chip(cfg: ModelConfig, shape: InputShape,
                                model: int, wbytes: int = BF16) -> float:
    """Extra HBM bytes/chip for streaming the (E-1) expert weight sets the
    probe's dense proxy does not read.  ff dim is model-sharded."""
    if not cfg.n_experts:
        return 0.0
    f_loc = cfg.d_ff // model if cfg.d_ff % model == 0 else cfg.d_ff
    per_layer = 3.0 * (cfg.n_experts - 1) * cfg.d_model * f_loc * wbytes
    mult = 2.0 if shape.kind == "train" else 1.0
    return per_layer * cfg.n_moe_layers * mult


def parallel_chips(cfg: ModelConfig, data: int, model: int, pod: int = 1
                   ) -> float:
    """Effective chips across which the stubbed ops parallelize.

    Batch axes always help. For the model axis, GSPMD shards the head dim
    with padding when it does not divide evenly (the fused H*hd projection
    IS evenly sharded, and attention follows with ceil(H/m) heads per
    chip): efficiency = H / (ceil(H/shards) * shards).  Models with fewer
    heads than the axis parallelize over H chips only.
    """
    H = cfg.n_heads
    shards = min(model, H)
    padded = -(-H // shards) * shards
    return data * pod * shards * (H / padded)


# ----------------------------------------------------------------------
# Fusion-aware HBM model (per chip): what a fused program moves, weights,
# a few activation touches per layer, logits and the decode cache; the
# reference's model, unchanged.
# ----------------------------------------------------------------------
ACT_TOUCH_TRAIN = 18.0   # full-activation HBM touches per layer (fwd+bwd+remat)
ACT_TOUCH_INFER = 6.0


def memory_model(cfg: ModelConfig, shape: InputShape, data: int, model: int,
                 pod: int = 1, fsdp: bool = True,
                 opt_state_bytes: int = 4, weight_bytes: int = BF16,
                 cache_bytes: int = BF16, microbatch: int = 1,
                 block_q: int = BLOCK_Q) -> float:
    """Estimated HBM bytes moved per chip per step (fused model).

    ``weight_bytes``/``cache_bytes`` reflect §Perf quantization variants;
    ``microbatch`` re-reads weights once per accumulation slice."""
    chips = data * model * pod
    train = shape.kind == "train"
    B, Sq = shape.global_batch, shape.seq_len
    d = cfg.d_model
    par = parallel_chips(cfg, data, model, pod)

    pbytes_total = cfg.n_params * weight_bytes
    if train:
        # fwd read + bwd read (re-gather) + grad write/read + master/m/v r+w
        opt = cfg.n_params * opt_state_bytes * 4  # m,v read+write (f32/bf16)
        passes = 3 * max(microbatch, 1)
        weights = (passes * pbytes_total + opt) / chips if fsdp else \
            (passes * pbytes_total + opt) / model
    else:
        active = cfg.n_active_params * weight_bytes
        weights = active / (model if not fsdp else chips)
        # MoE serving reads every resident expert the tokens hit; bound by
        # total expert weights on chip
        if cfg.n_experts:
            weights = max(weights, cfg.n_params * weight_bytes / chips
                          if fsdp else cfg.n_params * weight_bytes / model)

    touches = ACT_TOUCH_TRAIN if train else ACT_TOUCH_INFER
    n_tokens = B * (Sq if shape.kind != "decode" else 1)
    acts = touches * cfg.n_layers * n_tokens * d * BF16 / par

    # logits + CE (train: write f32 logits, read for softmax+bwd)
    if train:
        logits = 3.0 * n_tokens * cfg.padded_vocab * F32 / chips
    else:
        logits = B * cfg.padded_vocab * F32 / chips

    # decode KV-cache traffic: read every valid slot once, write one
    cache = 0.0
    if shape.kind == "decode":
        from repro_torch.models import blocks as BL
        for kind in cfg.layer_pattern:
            if kind in (BlockKind.ATTN, BlockKind.LOCAL_ATTN,
                        BlockKind.CHUNKED_ATTN):
                L = BL.attn_cache_len(cfg, kind, Sq)
                cache += 2.0 * B * L * cfg.n_kv_heads * cfg.hd * cache_bytes
            elif kind == BlockKind.MLSTM:
                nh = cfg.n_heads
                hd = 2 * d // nh
                cache += 2.0 * B * nh * hd * hd * F32
            elif kind == BlockKind.RGLRU:
                cache += 2.0 * B * d * F32
        cache /= chips  # cache shards over batch x kv_seq/model

    # attention/mLSTM/LRU streaming traffic (train/prefill only — decode's
    # cache term above covers its attention reads)
    stub_bytes = 0.0
    if shape.kind != "decode":
        _, stub_bytes = stubbed_op_costs(cfg, shape, block_q)
    moe_w = moe_weight_traffic_per_chip(cfg, shape, model, weight_bytes)
    return weights + acts + logits + cache + stub_bytes / par + moe_w
