"""Attention, RG-LRU and xLSTM blocks (a port of ``repro.models.blocks``:
``attn_specs``, ``attn_cache_specs``, ``_qkv``, ``_ffn``, ``attn_block``,
``rglru_specs``, ``rglru_cache_specs``, ``_rglru_gates``, ``rglru_block``,
``_mlstm_dims``, ``mlstm_specs``, ``mlstm_cache_specs``,
``_mlstm_chunk_scan``, ``mlstm_block``, ``_slstm_dims``, ``slstm_specs``,
``slstm_cache_specs``, ``_slstm_step``, ``slstm_block``).

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

``mlstm_block`` and ``slstm_block`` (xLSTM) have no kernel: the reference
writes them in plain ``jnp``, and the port in plain PyTorch, op for op.
The mLSTM runs the chunked-parallel scan with the max stabiliser in
``train``, ``prefill`` and ``chunk`` (chunks of up to 512 tokens, one
Python iteration each, where the reference scans) and the one-step
recurrence in ``decode``; the sLSTM steps its recurrence over the tokens
one at a time in every mode. Their state (mLSTM ``C``, ``n``, ``m``; sLSTM
``c``, ``n``, ``h``, ``m``) is float32 and per slot.

A MoE layer (``cfg.n_experts``; every layer, as ``moe_every`` is 0 or 1)
replaces the MLP with ``moe_ffn``: token-choice top-k routing in float32
and three grouped matmuls through K4 (``moe_gmm``), the reference's
single-device branch. Nothing on that path reads a tensor back to the
host. ``attn_block`` and ``rglru_block`` return ``(x, cache, aux)``, as the
reference's blocks: ``aux`` is the MoE layer's load-balancing loss (None
for a dense feed-forward), which ``model.loss_fn`` adds in ``train``.

A cache may be narrower than the activations (an int8 K/V cache,
``model.cache_specs(..., kv_dtype="int8")``): every write into it goes
through ``layers.saturate_cast``, XLA's saturating convert, and the
attention kernels read it widened (unit scales).

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
from repro_torch.models.layers import (apply_rope, mlp, mlp_specs, rms_norm,
                                       saturate_cast)
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


def _ffn(cfg: ModelConfig, params, x: torch.Tensor, impl: Optional[str]
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x + FFN(x), aux): a MoE layer's load-balancing aux (float32, 0-d),
    None for a dense MLP (the reference returns 0.0 there)."""
    h = rms_norm(x, params["ln2"])
    if "router" in params:    # MoE layer (decided at spec time)
        out, aux = moe_ffn(cfg, params, h, impl=impl)
    else:
        out, aux = mlp(params, h), None
    return x + out, aux


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
               ) -> Tuple[torch.Tensor, Optional[Cache], Optional[torch.Tensor]]:
    """Returns (x, cache, aux), ``aux`` the MoE feed-forward's
    load-balancing loss (None for a dense one; ``loss_fn`` adds it in
    ``train``, serving drops it). ``train`` runs the whole sequence with no
    cache and returns None (``causal=False`` is the whisper encoder's
    bidirectional attention); ``prefill`` returns the block's dense cache
    ``{"k", "v"}`` (B, L, KV, hd); ``chunk``/``decode`` write into ``cache``
    in place and return it. A block with cross attention (``c_wq`` in
    ``params``, a whisper decoder block) attends after its self attention
    to ``cross_x`` (B, F, d), the encoder's output, in ``train`` and
    ``prefill`` through K2 with no mask (prefill also returns ``c_k``,
    ``c_v`` (B, F, KV, hd)), and in ``decode`` to the cached ``c_k``,
    ``c_v`` through K3 with every row's ``kv_len = F``; no rope touches the
    cross K/V. ``pos``: chunk start (a 0-d int tensor, as
    ``forward`` passes it) in ``chunk`` mode, per-sequence positions (B,)
    in ``decode``. ``cache_len``: the decode
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
        # pos: the chunk start, a 0-d int tensor on the card (no host read)
        tokpos = pos.long() + torch.arange(S, device=x.device)   # (S,)
        k_pool, v_pool = cache["k"], cache["v"]
        page = k_pool.shape[1]
        phys = block_tables.long()[:, tokpos // page]              # (B, S)
        off = (tokpos % page)[None, :].expand(B, S)
        # duplicate padding rows of a chunk group write identical values
        k_pool[phys, off] = saturate_cast(k, k_pool.dtype)
        v_pool[phys, off] = saturate_cast(v, v_pool.dtype)
        q_off = pos.to(torch.int32).expand(B).contiguous()
        kv_len = q_off + S
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
            k_cache[phys, off] = saturate_cast(k[:, 0], k_cache.dtype)
            v_cache[phys, off] = saturate_cast(v[:, 0], v_cache.dtype)
            attn = ops.paged_decode_attention(q, k_cache, v_cache, block_tables,
                                              (pos + 1).to(torch.int32),
                                              impl=impl)
        else:
            L = k_cache.shape[1]
            slot = posl % L
            bidx = torch.arange(B, device=x.device)
            for c, new in ((k_cache, k), (v_cache, v)):
                c[bidx, slot] = _keep_masked(saturate_cast(new[:, 0], c.dtype),
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
    x, aux = _ffn(cfg, params, x, impl)
    return x, new_cache, aux


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
                ) -> Tuple[torch.Tensor, Optional[Cache], Optional[torch.Tensor]]:
    """Returns (x, cache, aux) (aux as ``attn_block``'s). ``train`` runs
    the sequence with no cache (None);
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
    x, aux = _ffn(cfg, params, x, impl)
    return x, new_cache, aux


# ======================================================================
# mLSTM block (xLSTM): chunked-parallel scan for train / prefill / chunk,
# the one-step recurrence for decode
# ======================================================================
def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(inner width, heads, head dim): projection factor 2, as the xLSTM
    paper's."""
    di = 2 * cfg.d_model
    nh = cfg.n_heads
    return di, nh, di // nh


def mlstm_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    di, nh, _ = _mlstm_dims(cfg)
    return {
        "ln": Spec((d,), init="zeros"),
        "w_up": Spec((d, 2 * di)),
        "wq": Spec((di, di)),
        "wk": Spec((di, di)),
        "wv": Spec((di, di)),
        "w_if": Spec((di, 2 * nh), scale=0.02),
        "b_i": Spec((nh,), init="zeros"),
        "b_f": Spec((nh,), init="ones"),
        "w_down": Spec((di, d)),
    }


def mlstm_cache_specs(cfg: ModelConfig, B: int) -> Dict[str, Spec]:
    """The matrix memory ``C`` (B, nh, hd, hd), normaliser ``n`` (B, nh,
    hd) and stabiliser ``m`` (B, nh), all float32."""
    _, nh, hd = _mlstm_dims(cfg)
    return {
        "C": Spec((B, nh, hd, hd), init="zeros", dtype="float32"),
        "n": Spec((B, nh, hd), init="zeros", dtype="float32"),
        "m": Spec((B, nh), init="zeros", dtype="float32"),
    }


def _mlstm_chunk_step(state, qc, kc, vc, ic, fc):
    """One chunk of the scan: state (C0 (B, nh, hd, hd), n0 (B, nh, hd),
    m0 (B, nh)); qc, kc, vc (B, Cn, nh, hd); ic, fc (B, Cn, nh). Returns
    (h (B, Cn, nh, hd), the state at the chunk's end)."""
    C0, n0, m0 = state
    Cn = qc.shape[1]
    b = torch.cumsum(fc, dim=1)                       # inclusive log f sums
    u = torch.cummax(ic - b, dim=1).values            # running max of (i - b)
    m_t = b + torch.maximum(m0[:, None], u)           # (B, Cn, nh)
    s = torch.einsum("bqnd,bknd->bnqk", qc, kc)       # (B, nh, Cn, Cn)
    logw = (ic - b).transpose(1, 2)[:, :, None, :] \
        + (b - m_t).transpose(1, 2)[:, :, :, None]
    causal = torch.ones((Cn, Cn), dtype=torch.bool, device=qc.device).tril()
    w = torch.where(causal, torch.exp(logw), 0.0)
    sw = s * w
    inter_scale = torch.exp(b + m0[:, None] - m_t)    # (B, Cn, nh)
    h_num = torch.einsum("bnqk,bknd->bqnd", sw, vc) \
        + inter_scale[..., None] * torch.einsum("bqnd,bnde->bqne", qc, C0)
    d_t = sw.sum(dim=-1).transpose(1, 2) \
        + inter_scale * torch.einsum("bqnd,bnd->bqn", qc, n0)
    denom = torch.maximum(torch.abs(d_t), torch.exp(-m_t))
    h = h_num / denom[..., None]
    b_tot = b[:, -1]                                  # (B, nh)
    m_out = b_tot + torch.maximum(m0, u[:, -1])
    kw = torch.exp(ic - b + b_tot[:, None] - m_out[:, None])   # (B, Cn, nh)
    decay = torch.exp(m0 + b_tot - m_out)
    C1 = decay[..., None, None] * C0 \
        + torch.einsum("bknd,bkne->bnde", kc * kw[..., None], vc)
    n1 = decay[..., None] * n0 + torch.einsum("bknd,bkn->bnd", kc, kw)
    return h, (C1, n1, m_out)


def _mlstm_chunk_scan(q, k, v, ig, fg, state, chunk: int):
    """Chunked-parallel mLSTM with the max stabiliser (the reference's
    ``_mlstm_chunk_scan``). q, k, v: (B, S, nh, hd) float32 (q and k
    pre-scaled); ig, fg: (B, S, nh) float32 (fg log-sigmoided); state:
    (C0, n0, m0). Chunks of ``min(chunk, S)``; a ragged end pads ``ig``
    with -1e30 and the rest with 0, so the padded steps add nothing.
    Returns h (B, S, nh, hd) float32 and the final state."""
    B, S, nh, hd = q.shape
    Cn = min(chunk, S)
    pad = (-S) % Cn
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, 0, 0, pad), value=-1e30)
        fg = F.pad(fg, (0, 0, 0, pad))
    hs = []
    for c in range(0, S + pad, Cn):
        h, state = _mlstm_chunk_step(state, q[:, c:c + Cn], k[:, c:c + Cn],
                                     v[:, c:c + Cn], ig[:, c:c + Cn],
                                     fg[:, c:c + Cn])
        hs.append(h)
    h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)
    return h[:, :S], state


def mlstm_block(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
                cache: Optional[Cache] = None, chunk: int = 512,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (x, cache). ``train`` runs the chunked scan from a zero
    state with no cache (None); ``prefill`` returns a new cache ``{"C",
    "n", "m"}``; ``chunk`` continues the scan from ``cache`` and
    ``decode`` advances it one step, both writing ``cache`` in place
    (``decode`` only on rows where ``mask``). The gate products and the
    state run in float32, as the reference's."""
    B, S, _ = x.shape
    di, nh, hd = _mlstm_dims(cfg)
    h = rms_norm(x, params["ln"])
    up = h @ params["w_up"]
    x_in, z = up[..., :di], up[..., di:]
    q = (x_in @ params["wq"]).reshape(B, S, nh, hd)
    k = (x_in @ params["wk"]).reshape(B, S, nh, hd)
    v = (x_in @ params["wv"]).reshape(B, S, nh, hd)
    gates = x_in.float() @ params["w_if"].float()
    ig = gates[..., :nh] + params["b_i"].float()
    fg = F.logsigmoid(gates[..., nh:] + params["b_f"].float())
    qf = q.float() * hd ** -0.5
    kf = k.float() * hd ** -0.5
    vf = v.float()

    if mode == "decode":
        if cache is None:
            raise ValueError("decode mode needs cache")
        C0, n0, m0 = cache["C"], cache["n"], cache["m"]
        i1, f1 = ig[:, 0], fg[:, 0]                         # (B, nh)
        m1 = torch.maximum(f1 + m0, i1)
        fw = torch.exp(f1 + m0 - m1)[..., None]
        iw = torch.exp(i1 - m1)[..., None]
        k1, v1, q1 = kf[:, 0], vf[:, 0], qf[:, 0]
        C1 = fw[..., None] * C0 + iw[..., None] * k1[..., :, None] * v1[..., None, :]
        n1 = fw * n0 + iw * k1
        num = torch.einsum("bnd,bnde->bne", q1, C1)
        den = torch.maximum(torch.abs(torch.einsum("bnd,bnd->bn", q1, n1)),
                            torch.exp(-m1))
        hseq = (num / den[..., None])[:, None]              # (B, 1, nh, hd)
        for name, new in (("C", C1), ("n", n1), ("m", m1)):
            cache[name].copy_(_keep_masked(new, cache[name], mask))
        new_cache = cache
    elif mode == "chunk":
        if cache is None:
            raise ValueError("chunk mode needs cache")
        hseq, state = _mlstm_chunk_scan(qf, kf, vf, ig, fg,
                                        (cache["C"], cache["n"], cache["m"]),
                                        chunk)
        for name, new in zip(("C", "n", "m"), state):
            cache[name].copy_(new)
        new_cache = cache
    elif mode in ("train", "prefill"):
        state0 = (x.new_zeros((B, nh, hd, hd), dtype=torch.float32),
                  x.new_zeros((B, nh, hd), dtype=torch.float32),
                  x.new_zeros((B, nh), dtype=torch.float32))
        hseq, state = _mlstm_chunk_scan(qf, kf, vf, ig, fg, state0, chunk)
        new_cache = None if mode == "train" else dict(zip(("C", "n", "m"), state))
    else:
        raise ValueError(f"unknown mode {mode!r}")

    out = hseq.reshape(B, -1, di).to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return x + out @ params["w_down"], new_cache


# ======================================================================
# sLSTM block (xLSTM): a sequential scan (its recurrent weights rule out
# a parallel form), exponential gating with a stabiliser state
# ======================================================================
def _slstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(heads, head dim, post-block MLP width at ratio 4/3)."""
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    ffi = (int(cfg.d_model * 4 / 3) // 8) * 8
    return nh, hd, ffi


def slstm_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    nh, hd, ffi = _slstm_dims(cfg)
    s = {
        "ln1": Spec((d,), init="zeros"),
        "w_gates": Spec((d, 4 * d)),
        "b_gates": Spec((4 * d,), init="zeros"),
        "r_gates": Spec((nh, hd, 4 * hd), scale=0.02),
        "w_out": Spec((d, d)),
        "ln2": Spec((d,), init="zeros"),
    }
    s.update(mlp_specs(d, ffi))
    return s


SLSTM_STATE = ("c", "n", "h", "m")


def slstm_cache_specs(cfg: ModelConfig, B: int) -> Dict[str, Spec]:
    nh, hd, _ = _slstm_dims(cfg)
    return {name: Spec((B, nh, hd), init="zeros", dtype="float32")
            for name in SLSTM_STATE}


def _slstm_step(r_gates: torch.Tensor, carry, pre_t: torch.Tensor):
    """carry: (c, n, h, m) each (B, nh, hd) float32; pre_t: (B, nh, 4,
    hd) float32; r_gates: (nh, hd, 4 hd) float32."""
    c, n, h, m = carry
    B, nh, hd = h.shape
    rec = torch.einsum("bnh,nhk->bnk", h, r_gates)
    g = pre_t + rec.reshape(B, nh, 4, hd)
    zt, it, ft, ot = g[:, :, 0], g[:, :, 1], g[:, :, 2], g[:, :, 3]
    m_new = torch.maximum(ft + m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(ft + m - m_new)
    c_new = f * c + i * torch.tanh(zt)
    n_new = f * n + i
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm_block(cfg: ModelConfig, params, x: torch.Tensor, *, mode: str,
                cache: Optional[Cache] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (x, cache). ``train``, ``prefill`` and ``chunk`` step the
    recurrence over the tokens one at a time (from a zero state, or from
    ``cache`` in ``chunk``); ``prefill`` returns a new cache ``{"c", "n",
    "h", "m"}``, ``chunk`` and ``decode`` write ``cache`` in place
    (``decode`` only on rows where ``mask``). Then ``w_out`` and the
    post-norm MLP."""
    B, S, d = x.shape
    nh, hd, _ = _slstm_dims(cfg)
    xi = rms_norm(x, params["ln1"])
    pre = (xi @ params["w_gates"] + params["b_gates"]).float()
    pre = pre.reshape(B, S, nh, 4, hd)
    r_gates = params["r_gates"].float()

    if mode in ("chunk", "decode"):
        if cache is None:
            raise ValueError(f"{mode} mode needs cache")
        carry = tuple(cache[name] for name in SLSTM_STATE)
    elif mode in ("train", "prefill"):
        zeros = x.new_zeros((B, nh, hd), dtype=torch.float32)
        carry = (zeros,) * 4
    else:
        raise ValueError(f"unknown mode {mode!r}")
    hs = []
    for t in range(S):
        carry = _slstm_step(r_gates, carry, pre[:, t])
        hs.append(carry[2])
    hseq = torch.stack(hs, dim=1)                       # (B, S, nh, hd)

    if mode == "train":
        new_cache = None
    elif mode == "prefill":
        new_cache = dict(zip(SLSTM_STATE, carry))
    else:
        for name, new in zip(SLSTM_STATE, carry):
            cache[name].copy_(_keep_masked(new, cache[name], mask))
        new_cache = cache

    x = x + hseq.reshape(B, -1, d).to(x.dtype) @ params["w_out"]
    return x + mlp(params, rms_norm(x, params["ln2"])), new_cache
