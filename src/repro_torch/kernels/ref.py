"""Plain PyTorch versions of the kernels on the serving path.

A port of ``repro.kernels.ref``: the same functions, arguments, layouts and
normalisation order, so the CPU tests can hold them against the JAX oracles
and ``chip_smoke.py`` can hold the CUDA kernels against them on the card.
``decode_attention`` normalises p before ``p @ v``; ``flash_attention`` and
``chunk_prefill_attention`` divide after, as the reference does.
``rglru_scan`` walks time sequentially, as the Pallas body does, where the
JAX oracle uses a log-depth associative scan: the two agree to rounding.
``moe_gmm`` upcasts to float32 before each product, as the Pallas body
does, where the JAX oracle multiplies in the operands' dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _gqa_scores(q, k):
    """q: (B, bq, KV, G, hd), k: (B, bk, KV, hd) -> (B, KV, G, bq, bk) f32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    softmax_scale: Optional[float] = None,
                    block_q: int = 512, block_kv: int = 1024) -> torch.Tensor:
    """Blocked exact attention with online softmax.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); H a multiple of KV (GQA).
    Queries are the LAST Sq positions of the kv sequence. Returns
    (B, Sq, H, hd) in q.dtype.
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    orig_sq = Sq

    bq = min(block_q, Sq)
    if Sq % bq:
        q = F.pad(q, (0, 0, 0, 0, 0, bq - Sq % bq))
        Sq = q.shape[1]
    bkv = min(block_kv, Skv)
    if Skv % bkv:
        pad = bkv - Skv % bkv
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_q, n_kv = Sq // bq, k.shape[1] // bkv

    q = (q.float() * scale).to(q.dtype)
    qr = q.reshape(B, n_q, bq, KV, G, hd)
    kr = k.reshape(B, n_kv, bkv, KV, hd)
    vr = v.reshape(B, n_kv, bkv, KV, hd)
    q_pos0 = Skv - orig_sq
    dev = q.device

    outs = []
    for i in range(n_q):
        q_i = qr[:, i]
        m = torch.full((B, KV, G, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=torch.float32, device=dev)
        qpos = q_pos0 + i * bq + torch.arange(bq, device=dev)
        for j in range(n_kv):
            k_j, v_j = kr[:, j], vr[:, j]
            s = _gqa_scores(q_i, k_j)
            kpos = j * bkv + torch.arange(bkv, device=dev)
            mask = (kpos[None, :] < Skv).expand(bq, bkv)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            if chunk:
                mask = mask & (kpos[None, :] // chunk == qpos[:, None] // chunk)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v_j.dtype).float(), v_j.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, bq, H, hd))
    out = torch.cat(outs, dim=1)
    return out[:, :orig_sq].to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *,
                     softmax_scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-step GQA attention over a KV cache.

    q: (B, 1, H, hd); k, v: (B, S_cache, KV, hd); kv_len: (B,) number of
    valid cache slots (slot order does not matter to softmax, so a ring
    cache passes a full-validity length once wrapped). k_scale, v_scale:
    (B, KV) float32 dequantization scales for int8 caches. p is normalised
    before ``p @ v``.
    """
    B, _, H, hd = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[:, None, :, None].float()
    if v_scale is not None:
        vf = vf * v_scale[:, None, :, None].float()
    qr = q.reshape(B, KV, G, hd).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qr, kf)
    valid = torch.arange(S, device=q.device)[None] < kv_len[:, None].long()
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Gather a paged pool (num_pages, page, KV, hd) through block tables
    (B, P) into per-sequence caches (B, P*page, KV, hd)."""
    B, P = block_tables.shape
    _, page, KV, hd = pool.shape
    return pool[block_tables.long()].reshape(B, P * page, KV, hd)


def paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len, *,
                           softmax_scale: Optional[float] = None):
    """``decode_attention`` over the gathered pages."""
    return decode_attention(q, gather_pages(k_pool, block_tables),
                            gather_pages(v_pool, block_tables),
                            kv_len, softmax_scale=softmax_scale)


def chunk_prefill_attention(q, k, v, kv_len, q_offset, *,
                            softmax_scale: Optional[float] = None):
    """Causal attention for a prefill chunk at positions ``q_offset + [0, C)``
    inside a cache of ``kv_len`` valid positions. q: (B, C, H, hd);
    k, v: (B, S, KV, hd); kv_len, q_offset: (B,). Divides after ``p @ v``.
    """
    B, C, H, hd = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    qr = q.reshape(B, C, KV, G, hd).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float())
    dev = q.device
    qpos = q_offset[:, None].long() + torch.arange(C, device=dev)[None, :]
    kpos = torch.arange(S, device=dev)[None, :]
    mask = (kpos[:, None] <= qpos[..., None]) & \
        (kpos < kv_len[:, None].long())[:, None]           # (B, C, S)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    out = out / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, kv_len,
                            q_offset, *, softmax_scale: Optional[float] = None):
    """Chunked-prefill attention through block tables (chunk K/V already
    scattered into the pool pages before the call)."""
    return chunk_prefill_attention(
        q, gather_pages(k_pool, block_tables),
        gather_pages(v_pool, block_tables),
        kv_len, q_offset, softmax_scale=softmax_scale)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t (the RG-LRU
    core), walked over time in float32: one multiply and one add, each
    rounded, per step. a, b: (B, S, D); h0: (B, D) or None (zeros).
    Returns h: (B, S, D) float32."""
    B, S, D = a.shape
    af, bf = a.float(), b.float()
    h = torch.zeros((B, D), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    out = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped (expert) matmul with ``jax.lax.ragged_dot`` semantics: rows
    of ``x`` are sorted by expert, the ``group_sizes[e]`` rows of expert
    ``e`` multiply ``w[e]``; rows past the last group are zero.

    x: (T, K); w: (E, K, N); group_sizes: (E,) int. One masked pass per
    expert in float32, rounded once to ``x.dtype``: the slow, obviously
    correct way, with no host sync (no data-dependent shapes)."""
    T = x.shape[0]
    E, _, N = w.shape
    ends = torch.cumsum(group_sizes.long(), 0)
    starts = ends - group_sizes.long()
    rows = torch.arange(T, device=x.device)
    xf = x.float()
    out = torch.zeros((T, N), dtype=torch.float32, device=x.device)
    for e in range(E):
        mask = (rows >= starts[e]) & (rows < ends[e])
        out = torch.where(mask[:, None], xf @ w[e].float(), out)
    return out.to(x.dtype)
