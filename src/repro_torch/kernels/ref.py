"""Plain PyTorch versions of the kernels on the serving path.

A port of ``repro.kernels.ref``: the same functions, arguments, layouts and
normalisation order, so the CPU tests can hold them against the JAX oracles
and ``chip_smoke.py`` can hold the CUDA kernels against them on the card.
``decode_attention`` normalises p before ``p @ v``; ``flash_attention`` and
``chunk_prefill_attention`` divide after, as the reference does.
``split_decode_attention`` is decode attention in the split-KV kernel's
two passes (partials over key ranges, then their merge), which the tests
hold equal to the one-pass version.
``rglru_scan`` walks time sequentially, as the Pallas body does, where the
JAX oracle uses a log-depth associative scan: the two agree to rounding.
``moe_gmm`` upcasts to float32 before each product, as the Pallas body
does, where the JAX oracle multiplies in the operands' dtype. An int8
cache or pool is upcast with ``.float()`` to its integer values, scaled
only where scales are given, as the JAX oracle does.

The backward of the training path has three plain versions beside them:
``flash_attention_bwd`` (the explicit formula from the forward's
log-sum-exp, which ``flash_attention(..., return_lse=True)`` gives),
``rglru_scan_bwd`` (the reverse sequential walk) and ``moe_gmm_bwd`` (two
matmuls per group). They are what the CUDA backward kernels are held
against, and the CPU path of the autograd Functions in
``flash_attention.py``, ``rglru_scan.py`` and ``moe_gmm.py``. Sums run in
float32, or in float64 for float64 inputs (``gradcheck``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _acc(t: torch.Tensor) -> torch.dtype:
    """The type sums run in: float32, or float64 for float64 inputs."""
    return torch.promote_types(t.dtype, torch.float32)


def _gqa_scores(q, k):
    """q: (B, bq, KV, G, hd), k: (B, bk, KV, hd) -> (B, KV, G, bq, bk) in
    ``_acc``."""
    acc = _acc(q)
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(acc), k.to(acc))


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                   chunk: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query sees, the queries being the
    last Sq of Skv positions (flash_attention.py:64-71 of the reference)."""
    qpos = Skv - Sq + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    if chunk:
        mask = mask & (kpos // chunk == qpos // chunk)
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    softmax_scale: Optional[float] = None,
                    block_q: int = 512, block_kv: int = 1024,
                    return_lse: bool = False):
    """Blocked exact attention with online softmax.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); H a multiple of KV (GQA).
    Queries are the LAST Sq positions of the kv sequence. Returns
    (B, Sq, H, hd) in q.dtype; with ``return_lse`` also the log-sum-exp of
    each query row's scaled scores, ``m + log(l)`` in natural-log units,
    (B, H, Sq) float32 (float64 for float64 inputs): what the backward
    recomputes the probabilities from.
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

    q = (q.to(_acc(q)) * scale).to(q.dtype)
    qr = q.reshape(B, n_q, bq, KV, G, hd)
    kr = k.reshape(B, n_kv, bkv, KV, hd)
    vr = v.reshape(B, n_kv, bkv, KV, hd)
    q_pos0 = Skv - orig_sq
    dev = q.device
    ad = _acc(q)

    outs, lses = [], []
    for i in range(n_q):
        q_i = qr[:, i]
        m = torch.full((B, KV, G, bq), NEG_INF, dtype=ad, device=dev)
        l = torch.zeros((B, KV, G, bq), dtype=ad, device=dev)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=ad, device=dev)
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
                "bkgqs,bskd->bkgqd", p.to(v_j.dtype).to(ad), v_j.to(ad))
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        out = acc / lc[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, bq, H, hd))
        lses.append((m + torch.log(lc)).reshape(B, H, bq))
    out = torch.cat(outs, dim=1)[:, :orig_sq].to(q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=2)[:, :, :orig_sq]
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, chunk: int = 0,
                        softmax_scale: Optional[float] = None):
    """The gradients of ``flash_attention`` by the explicit formula: the
    probabilities recomputed from the forward's log-sum-exp, ``P = exp(s -
    lse)`` with ``s = scale * q.k`` (0 where the mask hides the key),
    ``D = rowsum(dout * out)``, ``dS = P * (dout.v - D)``; then ``dq =
    scale * dS k``, ``dk = scale * dS^T q`` and ``dv = P^T dout``, ``dk``
    and ``dv`` summed over the G query heads of each kv head. Every mask of
    the forward; queries are the last Sq of Skv positions.

    q, out, dout: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); lse: (B, H, Sq).
    Returns (dq, dk, dv) in the dtypes of q, k and v; sums in float32
    (float64 for float64 inputs). One sequence at a time, so the (H, Sq,
    Skv) probabilities of one sequence are the largest temporary."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    ad = _acc(q)
    mask = attention_mask(Sq, Skv, causal=causal, window=window, chunk=chunk,
                          device=q.device)
    dqs, dks, dvs = [], [], []
    for b in range(B):
        qf = q[b].to(ad).reshape(Sq, KV, G, hd)
        dof = dout[b].to(ad).reshape(Sq, KV, G, hd)
        of = out[b].to(ad).reshape(Sq, KV, G, hd)
        kf, vf = k[b].to(ad), v[b].to(ad)
        s = torch.einsum("qkgd,skd->kgqs", qf, kf) * scale
        lse_b = lse[b].to(ad).reshape(KV, G, Sq)
        p = torch.where(mask, torch.exp(s - lse_b[..., None]),
                        torch.zeros((), dtype=ad, device=q.device))
        dp = torch.einsum("qkgd,skd->kgqs", dof, vf)
        d_row = (dof * of).sum(-1).permute(1, 2, 0)            # (KV, G, Sq)
        ds = p * (dp - d_row[..., None])
        dqs.append(torch.einsum("kgqs,skd->qkgd", ds, kf).reshape(Sq, H, hd)
                   * scale)
        dks.append(torch.einsum("kgqs,qkgd->skd", ds, qf) * scale)
        dvs.append(torch.einsum("kgqs,qkgd->skd", p, dof))
    return (torch.stack(dqs).to(q.dtype), torch.stack(dks).to(k.dtype),
            torch.stack(dvs).to(v.dtype))


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


SPLIT_KEYS = 64     # a split of the split-KV decode holds a multiple of this


def split_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, n_split: int, *,
                          softmax_scale: Optional[float] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None):
    """The split-KV decode kernel's first pass, plainly: split ``s`` of
    sequence ``b`` holds keys ``[s * len, min((s + 1) * len, kv_len))`` with
    ``len = round_up(ceil(kv_len / n_split), 64)``; for each split and query
    head, float32 ``m`` (the range's max score, NEG_INF when empty), ``l``
    (the sum of exp(s - m), 0 when empty) and ``acc`` (the exp-weighted sum
    of v, not normalised). Shapes (n_split, B, H), (n_split, B, H) and
    (n_split, B, H, hd); natural-log units."""
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
    s = torch.einsum("bkgd,bskd->bkgs", qr, kf)               # (B, KV, G, S)
    kvl = torch.clamp(kv_len.long(), max=S)
    per = (-(-kvl // n_split) + SPLIT_KEYS - 1) // SPLIT_KEYS * SPLIT_KEYS
    kp = torch.arange(S, device=q.device)[None]
    ms, ls, accs = [], [], []
    for i in range(n_split):
        lo = i * per
        hi = torch.minimum(lo + per, kvl)
        valid = ((kp >= lo[:, None]) & (kp < hi[:, None]))[:, None, None]
        si = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m = si.amax(dim=-1)
        p = torch.where(valid, torch.exp(si - m[..., None]), torch.zeros_like(si))
        ms.append(m.reshape(B, H))
        ls.append(p.sum(dim=-1).reshape(B, H))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, vf).reshape(B, H, hd))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The merge pass: out = sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M}
    l_s, 1e-30) over the splits that hold a key (l_s > 0). Returns
    (B, 1, H, hd) in ``dtype``."""
    M = m.amax(dim=0)
    w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(m))
    out = (w[..., None] * acc).sum(dim=0) / \
        torch.clamp((w * l).sum(dim=0), min=1e-30)[..., None]
    return out[:, None].to(dtype)


def split_decode_attention(q, k, v, kv_len, n_split: int, *,
                           softmax_scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None):
    """``decode_attention`` the way the split-KV kernel computes it: the
    partials of ``n_split`` key ranges, then their merge."""
    return merge_partials(*split_decode_partials(
        q, k, v, kv_len, n_split, softmax_scale=softmax_scale,
        k_scale=k_scale, v_scale=v_scale), q.dtype)


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
    Returns h: (B, S, D) float32 (float64 for float64 inputs). The steps
    are stacked once at the end, so autograd's graph of it holds one
    stack, not S in-place writes into one buffer."""
    B, S, D = a.shape
    ad = _acc(a)
    af, bf = a.to(ad), b.to(ad)
    h = torch.zeros((B, D), dtype=ad, device=a.device) \
        if h0 is None else h0.to(ad)
    hs = []
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """The gradients of ``rglru_scan`` by the reverse sequential walk:
    ``g_t = dh_t + a_{t+1} * g_{t+1}`` (``a_S * g_S`` taken as 0 * 0), then
    ``db_t = g_t``, ``da_t = g_t * h_{t-1}`` (``h_{-1}`` = h0, or zeros)
    and ``dh0 = a_0 * g_0``; one rounded multiply and one rounded add a
    step, the order of the CUDA kernel's chain. a: (B, S, D); h, dh:
    (B, S, D) float32, the forward's output and its gradient; h0: (B, D)
    or None. Returns (da, db, dh0) in float32 (float64 for float64
    inputs); dh0 is None when h0 is."""
    B, S, D = a.shape
    ad = _acc(a)
    af, hf, dhf = a.to(ad), h.to(ad), dh.to(ad)
    zero = torch.zeros((B, D), dtype=ad, device=a.device)
    h_init = zero if h0 is None else h0.to(ad)
    g = zero
    das, dbs = [None] * S, [None] * S
    for t in range(S - 1, -1, -1):
        a_next = af[:, t + 1] if t + 1 < S else zero
        g = dhf[:, t] + a_next * g
        dbs[t] = g
        das[t] = g * (hf[:, t - 1] if t else h_init)
    dh0 = None if h0 is None else af[:, 0] * g
    return torch.stack(das, dim=1), torch.stack(dbs, dim=1), dh0


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped (expert) matmul with ``jax.lax.ragged_dot`` semantics: rows
    of ``x`` are sorted by expert, the ``group_sizes[e]`` rows of expert
    ``e`` multiply ``w[e]``; rows past the last group are zero.

    x: (T, K); w: (E, K, N); group_sizes: (E,) int. One masked pass per
    expert in float32 (float64 for float64 inputs), rounded once to
    ``x.dtype``: the slow, obviously correct way, with no host sync (no
    data-dependent shapes)."""
    T = x.shape[0]
    E, _, N = w.shape
    acc = _acc(x)
    ends = torch.cumsum(group_sizes.long(), 0)
    starts = ends - group_sizes.long()
    rows = torch.arange(T, device=x.device)
    xf = x.to(acc)
    out = torch.zeros((T, N), dtype=acc, device=x.device)
    for e in range(E):
        mask = (rows >= starts[e]) & (rows < ends[e])
        out = torch.where(mask[:, None], xf @ w[e].to(acc), out)
    return out.to(x.dtype)


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                dout: torch.Tensor, *, need_dx: bool = True,
                need_dw: bool = True):
    """The gradients (dx, dw) of ``moe_gmm`` for the output's gradient
    ``dout`` (T, N): ``dx[r] = dout[r] @ w[e(r)].T`` for each row of group
    e, zero for rows past ``sum(group_sizes)``; ``dw[e] = x_e.T @ dout_e``
    over the rows of group e, zero for an empty group; either is None
    where its ``need_`` flag is False. Sums in float32 (float64 for
    float64 inputs), returned in x's and w's dtypes. Group sizes are
    clamped to [0, T] and every group's rows to [0, T), as the kernels do.
    It reads the group sizes on the host to slice each group's rows (the
    plain version; the card's path never calls it)."""
    T = x.shape[0]
    E, K, N = w.shape
    acc = _acc(x)
    xf, df = x.to(acc), dout.to(acc)
    dx = torch.zeros((T, K), dtype=acc, device=x.device) if need_dx else None
    dw = torch.zeros((E, K, N), dtype=acc, device=x.device) if need_dw else None
    start = 0
    for e, g in enumerate(group_sizes.tolist()):
        size = min(max(int(g), 0), T)
        end = min(start + size, T)
        if end > start and need_dx:
            dx[start:end] = df[start:end] @ w[e].to(acc).T
        if end > start and need_dw:
            dw[e] = xf[start:end].T @ df[start:end]
        start += size
    return (dx.to(x.dtype) if need_dx else None,
            dw.to(w.dtype) if need_dw else None)
