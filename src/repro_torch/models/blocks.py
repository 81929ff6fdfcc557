"""Attention and RG-LRU blocks (a port of ``repro.models.blocks``:
``attn_specs``, ``attn_cache_specs``, ``_qkv``, ``_ffn``, ``attn_block``,
``rglru_specs``, ``rglru_cache_specs``, ``_rglru_gates``, ``rglru_block``).

``attn_block`` runs ``ATTN``, ``LOCAL_ATTN`` (sliding window) and
``CHUNKED_ATTN`` in four modes, as the reference:

* ``train`` — the whole sequence through K2, no cache; ``causal=False``
  for the whisper encoder.
* ``prefill`` — the whole prompt through K2 (``flash_attention``) with the
  kind's mask; returns the block's dense cache: global K/V zero-padded to
  ``cache_len``, or a ring of ``min(window or chunk, cache_len)`` slots
  holding the live suffix at slot ``p % L``.
* ``chunk`` — one prefill chunk of a paged global-attention block: its K/V
  scattered into this sequence's pool pages, attention through K1
  (``paged_prefill_attention``). Ring kinds prefill whole.
* ``decode`` — one token per sequence. Paged global attention writes at
  ``(page[pos // page], pos % page)`` and attends through K1
  (``paged_decode_attention``); ring caches and the dense per-slot global
  cache write at slot ``pos % L`` and attend through K3
  (``decode_attention``).

A whisper decoder block adds cross attention to the encoder's frames
after its self attention: through K2 (no mask) in ``train`` and
``prefill``, which also caches the cross K/V, and through K3 over those
cached ``F`` frames in ``decode``.

``rglru_block`` runs the RG-LRU recurrence through K5 (``rglru_scan``) in
``train``, ``prefill`` and ``chunk`` modes; ``decode`` advances the state by one step
in plain PyTorch, as the reference does.

A MoE layer (``cfg.n_experts``; every layer, as ``moe_every`` is 0 or 1)
replaces the MLP with ``moe_ffn``: token-choice top-k routing in float32
and three grouped matmuls through K4 (``moe_gmm``), the reference's
single-device branch. Nothing on that path reads a tensor back to the
host.

Cache writes in ``chunk`` and ``decode`` are IN PLACE: where the JAX engine
donates the cache so XLA updates it in place, the port mutates the cache
leaves it is handed and returns the same dict. ``mask`` (decode only,
(B,) bool) keeps the per-slot leaves of rows where it is False unchanged;
the serving engine passes it for idle and mid-prefill rows, whose pool
writes land in the reserved scratch page.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockKind, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, mlp, mlp_specs, rms_norm
from repro_torch.models.param import Spec

Cache = Dict[str, torch.Tensor]
ATTN_KINDS = (BlockKind.ATTN, BlockKind.LOCAL_ATTN, BlockKind.CHUNKED_ATTN)


# ======================================================================
# Attention blocks (global / local sliding-window / chunked) + FFN
# ======================================================================
def attn_specs(cfg: ModelConfig, cross: bool = False) -> Dict[str, Spec]:
    """The block's leaves; ``cross`` adds a whisper decoder block's cross
    attention (``c_ln``, ``c_wq``, ``c_wk``, ``c_wv``, ``c_wo``)."""
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    s: Dict[str, Spec] = {
        "ln1": Spec((d,), init="zeros"),
        "wq": Spec((d, H * hd)),
        "wk": Spec((d, KV * hd)),
        "wv": Spec((d, KV * hd)),
        "wo": Spec((H * hd, d)),
        "ln2": Spec((d,), init="zeros"),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((H * hd,), init="zeros")
        s["bk"] = Spec((KV * hd,), init="zeros")
        s["bv"] = Spec((KV * hd,), init="zeros")
    if cross:
        s["c_ln"] = Spec((d,), init="zeros")
        s["c_wq"] = Spec((d, H * hd))
        s["c_wk"] = Spec((d, KV * hd))
        s["c_wv"] = Spec((d, KV * hd))
        s["c_wo"] = Spec((H * hd, d))
    if cfg.is_moe_layer(0):   # the reference decides at layer 0 for all
        E, f = cfg.n_experts, cfg.d_ff
        s["router"] = Spec((d, E), scale=0.02)
        s["we_g"] = Spec((E, d, f))
        s["we_u"] = Spec((E, d, f))
        s["we_d"] = Spec((E, f, d))
    else:
        s.update(mlp_specs(d, cfg.d_ff))
    return s


def _attn_window(cfg: ModelConfig, kind: BlockKind) -> Tuple[int, int]:
    """(window, chunk) for the attention mask of this block kind."""
    if kind == BlockKind.LOCAL_ATTN:
        return cfg.window, 0
    if kind == BlockKind.CHUNKED_ATTN:
        return 0, cfg.chunk
    return 0, 0


def attn_cache_len(cfg: ModelConfig, kind: BlockKind, seq_len: int) -> int:
    window, chunk = _attn_window(cfg, kind)
    if window:
        return min(window, seq_len)
    if chunk:
        return min(chunk, seq_len)
    return seq_len


def attn_cache_specs(cfg: ModelConfig, kind: BlockKind, B: int,
                     seq_len: int, cross: bool = False) -> Dict[str, Spec]:
    """Self-attention K/V, and with ``cross`` the decoder's cross K/V
    ``c_k``, ``c_v`` (B, n_frames, KV, hd), written once at prefill."""
    L = attn_cache_len(cfg, kind, seq_len)
    kv = Spec((B, L, cfg.n_kv_heads, cfg.hd), init="zeros")
    s = {"k": kv, "v": kv}
    if cross:
        s["c_k"] = s["c_v"] = Spec((B, cfg.n_frames, cfg.n_kv_heads, cfg.hd),
                                   init="zeros")
    return s


def _qkv(cfg: ModelConfig, params, h: torch.Tensor):
    B, S = h.shape[:2]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = h @ params["wq"], h @ params["wk"], h @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def _ffn(cfg: ModelConfig, params, x: torch.Tensor,
         impl: Optional[str]) -> torch.Tensor:
    h = rms_norm(x, params["ln2"])
    if "router" in params:    # MoE layer (decided at spec time)
        out, _ = moe_ffn(cfg, params, h, impl=impl)   # serving drops aux
    else:
        out = mlp(params, h)
    return x + out


def _keep_masked(new: torch.Tensor, old: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``new`` on rows where ``mask`` (B,) is True, ``old`` elsewhere."""
    if mask is None:
        return new
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _prefill_cache(cfg: ModelConfig, kind: BlockKind, k: torch.Tensor,
                   v: torch.Tensor, cache_len: int) -> Cache:
    """The block's dense decode cache after a prefill of k, v (B, S, KV,
    hd): global K/V zero-padded to ``cache_len`` slots, or a ring of
    ``min(window or chunk, cache_len)`` slots holding the live suffix."""
    B, S, KV, hd = k.shape
    window, chunk = _attn_window(cfg, kind)
    L = attn_cache_len(cfg, kind, cache_len)
    if window or chunk:
        # ring cache, slot(p) = p % L: the live positions are a suffix
        # of the prompt (the last min(L, S) for a window, the current
        # chunk for chunked attention; stale slots are masked by kv_len)
        start = max(S - L, 0) if window else (S - 1) // L * L
        slots = torch.arange(start, S, device=k.device) % L
        new_cache = {}
        for name, t in (("k", k), ("v", v)):
            ring = t.new_zeros((B, L, KV, hd))
            ring[:, slots] = t[:, start:]
            new_cache[name] = ring
        return new_cache
    if L > S:
        return {"k": F.pad(k, (0, 0, 0, 0, 0, L - S)),
                "v": F.pad(v, (0, 0, 0, 0, 0, L - S))}
    return {"k": k, "v": v}


def attn_block(cfg: ModelConfig, kind: BlockKind, params, x: torch.Tensor, *,
               mode: str, rope_cs: Tuple[torch.Tensor, torch.Tensor],
               cache: Optional[Cache] = None,
               pos: Optional[torch.Tensor] = None,
               causal: bool = True,
               cross_x: Optional[torch.Tensor] = None,
               cache_len: Optional[int] = None,
               impl: Optional[str] = None,
               block_tables: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (x, cache). ``train`` runs the whole sequence with no cache
    and returns None (``causal=False`` is the whisper encoder's
    bidirectional attention); ``prefill`` returns the block's dense cache
    ``{"k", "v"}`` (B, L, KV, hd); ``chunk``/``decode`` write into ``cache``
    in place and return it. A block with cross attention (``c_wq`` in
    ``params``, a whisper decoder block) attends after its self attention
    to ``cross_x`` (B, F, d), the encoder's output, in ``train`` and
    ``prefill`` through K2 with no mask (prefill also returns ``c_k``,
    ``c_v`` (B, F, KV, hd)), and in ``decode`` to the cached ``c_k``,
    ``c_v`` through K3 with every row's ``kv_len = F``; no rope touches the
    cross K/V. ``pos``: chunk start (int) in ``chunk`` mode,
    per-sequence positions (B,) in ``decode``. ``cache_len``: the decode
    cache's capacity at prefill (default: the prompt length).
    ``block_tables`` present: a global-attention cache is a paged pool
    (num_pages, page, KV, hd) rather than per-slot (B, L, KV, hd).
    ``rope_cs``: (cos, sin) of this call's positions from
    ``layers.rope_tables``; ``forward`` computes them once for all layers."""
    if kind not in ATTN_KINDS:
        raise ValueError(f"attn_block takes attention kinds, got {kind}")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window, chunk = _attn_window(cfg, kind)
    h = rms_norm(x, params["ln1"])
    cos, sin = rope_cs
    q, k, v = _qkv(cfg, params, h)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

    if mode in ("train", "prefill"):
        attn = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   chunk=chunk, impl=impl)
        new_cache = None if mode == "train" else \
            _prefill_cache(cfg, kind, k, v, cache_len or S)
    elif mode == "chunk":
        if cache is None or pos is None:
            raise ValueError("chunk mode needs cache and pos")
        if block_tables is None or window or chunk:
            raise ValueError("chunked prefill requires paged global attention")
        start = int(pos)
        tokpos = start + torch.arange(S, device=x.device)        # (S,)
        k_pool, v_pool = cache["k"], cache["v"]
        page = k_pool.shape[1]
        phys = block_tables.long()[:, tokpos // page]              # (B, S)
        off = (tokpos % page)[None, :].expand(B, S)
        # duplicate padding rows of a chunk group write identical values
        k_pool[phys, off] = k.to(k_pool.dtype)
        v_pool[phys, off] = v.to(v_pool.dtype)
        kv_len = torch.full((B,), start + S, dtype=torch.int32, device=x.device)
        q_off = torch.full((B,), start, dtype=torch.int32, device=x.device)
        attn = ops.paged_prefill_attention(q, k_pool, v_pool, block_tables,
                                           kv_len, q_off, impl=impl)
        new_cache = cache
    elif mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode mode needs cache and pos")
        k_cache, v_cache = cache["k"], cache["v"]              # S == 1
        posl = pos.long()
        if block_tables is not None and not (window or chunk):
            page = k_cache.shape[1]
            phys = block_tables.long().gather(1, (posl // page)[:, None])[:, 0]
            off = posl % page
            # inactive engine rows carry an all-zeros table: their writes
            # land in the reserved scratch page 0
            k_cache[phys, off] = k[:, 0].to(k_cache.dtype)
            v_cache[phys, off] = v[:, 0].to(v_cache.dtype)
            attn = ops.paged_decode_attention(q, k_cache, v_cache, block_tables,
                                              (pos + 1).to(torch.int32),
                                              impl=impl)
        else:
            L = k_cache.shape[1]
            slot = posl % L
            bidx = torch.arange(B, device=x.device)
            for c, new in ((k_cache, k), (v_cache, v)):
                c[bidx, slot] = _keep_masked(new[:, 0].to(c.dtype),
                                             c[bidx, slot], mask)
            if chunk:
                kv_len = slot + 1
            else:
                kv_len = torch.clamp(posl + 1, max=L)
            attn = ops.decode_attention(q, k_cache, v_cache,
                                        kv_len.to(torch.int32), impl=impl)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    x = x + attn.reshape(B, S, H * hd) @ params["wo"]
    if "c_wq" in params:
        x = _cross_attn(cfg, params, x, mode, cross_x, cache, new_cache, impl)
    return _ffn(cfg, params, x, impl), new_cache


def _cross_attn(cfg: ModelConfig, params, x: torch.Tensor, mode: str,
                cross_x: Optional[torch.Tensor], cache: Optional[Cache],
                new_cache: Optional[Cache], impl: Optional[str]) -> torch.Tensor:
    """The whisper decoder's cross sub-block (the reference's
    ``attn_block`` :252-274): queries from this block's stream, keys and
    values projected from the encoder output (no bias, no rope). Prefill
    puts ``c_k``, ``c_v`` into ``new_cache``; decode reads them from
    ``cache``."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    hc = rms_norm(x, params["c_ln"])
    qc = (hc @ params["c_wq"]).reshape(B, S, H, hd)
    if mode in ("train", "prefill"):
        if cross_x is None:
            raise ValueError(f"{mode} of a cross-attention block needs cross_x "
                             "(the encoder's output)")
        Fr = cross_x.shape[1]
        ck = (cross_x @ params["c_wk"]).reshape(B, Fr, KV, hd)
        cv = (cross_x @ params["c_wv"]).reshape(B, Fr, KV, hd)
        if mode == "prefill":
            new_cache["c_k"], new_cache["c_v"] = ck, cv
        cattn = ops.flash_attention(qc, ck, cv, causal=False, impl=impl)
    elif mode == "decode":
        ck, cv = cache["c_k"], cache["c_v"]
        kv_len = torch.full((B,), ck.shape[1], dtype=torch.int32,
                            device=x.device)
        cattn = ops.decode_attention(qc, ck, cv, kv_len, impl=impl)
    else:
        raise NotImplementedError(
            "chunked prefill: an encoder-decoder prefills whole "
            "(see chunked_prefill_supported)")
    return x + cattn.reshape(B, S, H * hd) @ params["c_wo"]


# ======================================================================
# MoE FFN (token-choice top-k, expert-sorted grouped matmul): the
# reference's single-device branch; the Megatron and all-to-all sharded
# paths are not ported
# ======================================================================
def route(cfg: ModelConfig, params, xf: torch.Tensor):
    """xf: (T, d) -> (probs (T, E), top_p (T, k), top_i (T, k)). Router and
    softmax in float32 (on the card a float32 product is full float32
    unless TF32 is turned on, which the port never does). Top-k takes the
    lower expert index first on a tie, as ``jax.lax.top_k``: a stable
    descending sort keeps equal probabilities in index order."""
    rl = xf.float() @ params["router"].float()
    probs = torch.softmax(rl, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def _moe_local(cfg: ModelConfig, params, xf: torch.Tensor,
               impl: Optional[str]):
    """xf: (T, d) -> (out (T, d), frac_tokens (E,), mean_prob (E,))."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    probs, top_p, top_i = route(cfg, params, xf)
    flat_e = top_i.reshape(-1)                              # (T*k,)
    order = torch.argsort(flat_e, stable=True)              # as jnp.argsort
    tok_sorted = order // k                                 # token of each row
    xs = xf[tok_sorted]                                     # (T*k, d)
    # group sizes stay on the device: bincount would read its input's
    # maximum back to the host
    group_sizes = torch.zeros(E, dtype=torch.int32, device=xf.device)
    group_sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))

    g = ops.moe_gmm(xs, params["we_g"], group_sizes, impl=impl)
    u = ops.moe_gmm(xs, params["we_u"], group_sizes, impl=impl)
    hh = F.silu(g.float()).to(xs.dtype) * u
    out_sorted = ops.moe_gmm(hh, params["we_d"], group_sizes, impl=impl)

    w_sorted = top_p.reshape(-1)[order].to(out_sorted.dtype)
    weighted = out_sorted * w_sorted[:, None]
    # combine: undo the sort and sum each token's k rows, in place of the
    # reference's scatter-add (deterministic, no atomics; for k <= 2 the
    # same rounding as any order of that scatter-add)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=xf.device)
    per_tok = weighted[inv].reshape(T, k, d)
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    frac_tokens = group_sizes.float() / max(T * k, 1)
    return out, frac_tokens, probs.mean(dim=0)


def moe_ffn(cfg: ModelConfig, params, h: torch.Tensor, *,
            impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, d) normed activations -> (out (B, S, d), aux), with the
    load-balancing ``aux = E * sum(frac_tokens * mean_prob)`` (float32)."""
    B, S, d = h.shape
    out, frac, meanp = _moe_local(cfg, params, h.reshape(B * S, d), impl)
    aux = cfg.n_experts * torch.sum(frac * meanp)
    return out.reshape(B, S, d).to(h.dtype), aux


# ======================================================================
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ======================================================================
def rglru_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    D = d  # recurrence width
    s = {
        "ln1": Spec((d,), init="zeros"),
        "w_x": Spec((d, D)),
        "w_g": Spec((d, D)),
        "conv_w": Spec((4, D), scale=0.5),
        "conv_b": Spec((D,), init="zeros"),
        "w_a": Spec((D, D), scale=0.02),
        "b_a": Spec((D,), init="zeros"),
        "w_i": Spec((D, D), scale=0.02),
        "b_i": Spec((D,), init="zeros"),
        "lam": Spec((D,), init="ones", scale=1.0),
        "w_out": Spec((D, d)),
        "ln2": Spec((d,), init="zeros"),
    }
    s.update(mlp_specs(d, cfg.d_ff))
    return s


def rglru_cache_specs(cfg: ModelConfig, B: int) -> Dict[str, Spec]:
    D = cfg.d_model
    return {
        "h": Spec((B, D), init="zeros", dtype="float32"),
        "conv": Spec((B, 3, D), init="zeros"),
    }


def _rglru_gates(params, y: torch.Tensor):
    """y: (..., D) post-conv activations -> (a, b) recurrence coefficients,
    float32."""
    yf = y.float()
    r = torch.sigmoid(yf @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(yf @ params["w_i"].float() + params["b_i"].float())
    c = 8.0
    log_a = -c * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * yf)
    return a, b


def _conv4(xp: torch.Tensor, conv_w: torch.Tensor, S: int) -> torch.Tensor:
    """Causal width-4 conv over a history-padded (B, S + 3, D) input, in the
    activation dtype, taps summed in order 0..3 (the reference's ``sum``)."""
    y = xp[:, 0:S] * conv_w[0]
    for i in range(1, 4):
        y = y + xp[:, i:i + S] * conv_w[i]
    return y


def rglru_block(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
                cache: Optional[Cache] = None, impl: Optional[str] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (x, cache). ``train`` runs the sequence with no cache (None);
    ``prefill`` returns a new cache ``{"h": (B, D) float32, "conv": (B, 3,
    D)}``; ``chunk`` continues the conv and the
    recurrence from ``cache`` and ``decode`` advances them one step, both
    writing ``cache`` in place (``decode`` only on rows where ``mask``)."""
    B, S, d = x.shape
    h = rms_norm(x, params["ln1"])
    xb = h @ params["w_x"]
    gb = h @ params["w_g"]

    if mode in ("train", "prefill"):
        xp = F.pad(xb, (0, 0, 3, 0))
        y = _conv4(xp, params["conv_w"], S) + params["conv_b"]
        a, bterm = _rglru_gates(params, y)
        hseq = ops.rglru_scan(a, bterm, None, impl=impl)      # (B,S,D) f32
        new_cache = None if mode == "train" else {
            "h": hseq[:, -1].float(),
            "conv": xb[:, -3:] if S >= 3 else F.pad(xb, (0, 0, 3 - S, 0))}
    elif mode == "chunk":
        if cache is None:
            raise ValueError("chunk mode needs cache")
        xp = torch.cat([cache["conv"].to(xb.dtype), xb], dim=1)
        y = _conv4(xp, params["conv_w"], S) + params["conv_b"]
        a, bterm = _rglru_gates(params, y)
        hseq = ops.rglru_scan(a, bterm, cache["h"], impl=impl)
        cache["h"].copy_(hseq[:, -1])
        cache["conv"].copy_(xp[:, -3:])
        new_cache = cache
    elif mode == "decode":
        if cache is None:
            raise ValueError("decode mode needs cache")
        conv_hist = cache["conv"]                              # (B,3,D)
        window = torch.cat([conv_hist, xb], dim=1)             # (B,4,D)
        y = torch.einsum("bkd,kd->bd", window, params["conv_w"]) + params["conv_b"]
        a, bterm = _rglru_gates(params, y[:, None, :])
        hstate = a[:, 0] * cache["h"] + bterm[:, 0]            # (B,D) f32
        hseq = hstate[:, None, :]
        cache["h"].copy_(_keep_masked(hstate, cache["h"], mask))
        cache["conv"].copy_(_keep_masked(window[:, 1:], conv_hist, mask))
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    gated = hseq.to(x.dtype) * F.gelu(gb.float(), approximate="tanh").to(x.dtype)
    x = x + gated @ params["w_out"]
    return _ffn(cfg, params, x, impl), new_cache
