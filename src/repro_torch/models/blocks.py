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
host. Under a mesh of more than one rank (``models.sharding``) every
block runs as one ``local_map`` body on local shards (``sharded_block``,
in ``train``, ``prefill`` and ``decode``), through the block itself: an
attention block with Megatron column / row slices of the heads (its cross
sub-block's too) and the feed-forward, ``layout`` choosing them, its
cache split over its sequence, its KV heads or neither (``_attn_body``);
an RG-LRU block with the recurrence whole on the rank's batch rows and
the MLP sliced (``_rglru_body``); an mLSTM or sLSTM block with every
weight whole on the rank's batch rows (``_xlstm_body``); ``moe_ffn``
takes the reference's Megatron or all-to-all branch there (under the no_tp
rules, whose batch spans ``model``, after gathering a data shard's rows
over ``model``). Each body dequantizes its integer (int8) weight leaves
itself, so they move between ranks as int8. ``attn_block`` and
``rglru_block`` return ``(x, cache, aux)``, as the
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

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockKind, ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models import sharding
from repro_torch.models.layers import (apply_rope, dequantize, mlp, mlp_hidden,
                                       mlp_specs, rms_norm, rope_tables,
                                       saturate_cast)
from repro_torch.models.param import Spec

Cache = Dict[str, torch.Tensor]
ATTN_KINDS = (BlockKind.ATTN, BlockKind.LOCAL_ATTN, BlockKind.CHUNKED_ATTN)
SLSTM_STATE = ("c", "n", "h", "m")


# ======================================================================
# Attention blocks (global / local sliding-window / chunked) + FFN
# ======================================================================
def attn_specs(cfg: ModelConfig, cross: bool = False) -> Dict[str, Spec]:
    """The block's leaves; ``cross`` adds a whisper decoder block's cross
    attention (``c_ln``, ``c_wq``, ``c_wk``, ``c_wv``, ``c_wo``)."""
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    s: Dict[str, Spec] = {
        "ln1": Spec((d,), (None,), init="zeros"),
        "wq": Spec((d, H * hd), ("embed", "heads")),
        "wk": Spec((d, KV * hd), ("embed", "kv")),
        "wv": Spec((d, KV * hd), ("embed", "kv")),
        "wo": Spec((H * hd, d), ("heads", "embed")),
        "ln2": Spec((d,), (None,), init="zeros"),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((H * hd,), ("heads",), init="zeros")
        s["bk"] = Spec((KV * hd,), ("kv",), init="zeros")
        s["bv"] = Spec((KV * hd,), ("kv",), init="zeros")
    if cross:
        s["c_ln"] = Spec((d,), (None,), init="zeros")
        s["c_wq"] = Spec((d, H * hd), ("embed", "heads"))
        s["c_wk"] = Spec((d, KV * hd), ("embed", "kv"))
        s["c_wv"] = Spec((d, KV * hd), ("embed", "kv"))
        s["c_wo"] = Spec((H * hd, d), ("heads", "embed"))
    if cfg.is_moe_layer(0):   # the reference decides at layer 0 for all
        E, f = cfg.n_experts, cfg.d_ff
        s["router"] = Spec((d, E), ("embed", "experts"), scale=0.02)
        s["we_g"] = Spec((E, d, f), ("experts", "embed", "ff"))
        s["we_u"] = Spec((E, d, f), ("experts", "embed", "ff"))
        s["we_d"] = Spec((E, f, d), ("experts", "ff", "embed"))
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
    kv = Spec((B, L, cfg.n_kv_heads, cfg.hd), ("batch", "kv_seq", "kv", None),
              init="zeros")
    s = {"k": kv, "v": kv}
    if cross:
        s["c_k"] = s["c_v"] = Spec((B, cfg.n_frames, cfg.n_kv_heads, cfg.hd),
                                   ("batch", None, "kv", None), init="zeros")
    return s


def _kv(cfg: ModelConfig, params, h: torch.Tensor):
    """k, v (B, S, KV, hd) of h (B, S, d), with as many KV heads as
    ``wk`` has columns of ``hd``."""
    B, S = h.shape[:2]
    k, v = h @ params["wk"], h @ params["wv"]
    if cfg.qkv_bias:
        k, v = k + params["bk"], v + params["bv"]
    return k.reshape(B, S, -1, cfg.hd), v.reshape(B, S, -1, cfg.hd)


def _qkv(cfg: ModelConfig, params, h: torch.Tensor):
    B, S = h.shape[:2]
    q = h @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    return (q.reshape(B, S, cfg.n_heads, cfg.hd),) + _kv(cfg, params, h)


def _ffn(cfg: ModelConfig, params, x: torch.Tensor, impl: Optional[str],
         lay: Optional["Layout"] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x + FFN(x), aux): a MoE layer's load-balancing aux (float32, 0-d),
    None for a dense MLP (the reference returns 0.0 there). Under a mesh
    (``lay``) the MLP's ``wg``/``wu`` are column slices and ``wd`` a row
    slice over ``lay.ff_tp``, its output summed over those axes from
    float32 partials (``sharding.row_parallel``)."""
    h = rms_norm(x, params["ln2"])
    if "router" in params:    # MoE layer (decided at spec time)
        out, aux = moe_ffn(cfg, params, h, impl=impl, lay=lay)
        return x + out, aux
    mesh, tp = (lay.mesh, lay.ff_tp) if lay is not None else (None, ())
    h = sharding.copy_to(h, mesh, tp)
    out = sharding.row_parallel(mlp_hidden(params, h), params["wd"], mesh, tp)
    return x + out, None


def _keep_masked(new: torch.Tensor, old: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``new`` on rows where ``mask`` (B,) is True, ``old`` elsewhere."""
    if mask is None:
        return new
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _ring_slot(chunk: int, pos: torch.Tensor, L: int):
    """(slot, kv_len) of a decode token at positions ``pos`` (B,) in a
    dense cache of L slots: slot ``pos % L``; the valid slots are the
    prefix [0, kv_len), ``slot + 1`` for a chunk ring and ``min(pos + 1,
    L)`` for a window ring or a global cache."""
    slot = pos % L
    return slot, (slot + 1 if chunk else torch.clamp(pos + 1, max=L))


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
               mask: Optional[torch.Tensor] = None,
               lay: Optional["Layout"] = None,
               kv_whole: Optional[Dict[str, torch.Tensor]] = None
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
    ``layers.rope_tables``; ``forward`` computes them once for all layers.
    ``lay`` (under a mesh, from ``_attn_body``): ``cfg`` holds this rank's
    head counts and ``params`` its slices; the normed input enters the
    heads through ``copy_to`` and ``wo``'s output is summed over
    ``lay.attn_tp`` from float32 partials, the feed-forward likewise over
    its axes (``_ffn``). In ``prefill`` and ``decode`` the cache is this
    rank's part in ``lay.cache``'s layout: split by KV heads it is served
    as on one rank; split over the sequence or whole,
    ``_prefill_serve_cache`` builds it and ``_decode_serve_attn`` writes
    and reads it. ``kv_whole``: the layer's whole ``wk``/``wv`` (and
    biases) where ``model`` slices the query heads but not the KV heads
    (``_local_heads``), from which each rank computes every KV head."""
    if kind not in ATTN_KINDS:
        raise ValueError(f"attn_block takes attention kinds, got {kind}")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window, chunk = _attn_window(cfg, kind)
    mesh, tp = (lay.mesh, lay.attn_tp) if lay is not None else (None, ())
    h = sharding.copy_to(rms_norm(x, params["ln1"]), mesh, tp)
    cos, sin = rope_cs
    q, k, v = _qkv(cfg, params, h)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

    if mode in ("train", "prefill"):
        attn = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   chunk=chunk, impl=impl)
        if mode == "train":
            new_cache = None
        elif lay is None or lay.cache.heads:
            new_cache = _prefill_cache(cfg, kind, k, v, cache_len or S)
        else:
            new_cache = _prefill_serve_cache(cfg, kind, lay, kv_whole, h, k, v,
                                             rope_cs, cache_len or S)
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
        elif lay is not None and not lay.cache.heads:
            attn = _decode_serve_attn(cfg, kind, lay, kv_whole, h, q, k, v,
                                      cos, sin, posl, k_cache, v_cache, impl)
        else:
            slot, kv_len = _ring_slot(chunk, posl, k_cache.shape[1])
            bidx = torch.arange(B, device=x.device)
            for c, new in ((k_cache, k), (v_cache, v)):
                c[bidx, slot] = _keep_masked(saturate_cast(new[:, 0], c.dtype),
                                             c[bidx, slot], mask)
            attn = ops.decode_attention(q, k_cache, v_cache,
                                        kv_len.to(torch.int32), impl=impl)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    x = x + sharding.row_parallel(attn.reshape(B, S, H * hd), params["wo"],
                                  mesh, tp)
    if "c_wq" in params:
        x = _cross_attn(cfg, params, x, mode, cross_x, cache, new_cache, impl,
                        lay)
    x, aux = _ffn(cfg, params, x, impl, lay)
    return x, new_cache, aux


def _cross_attn(cfg: ModelConfig, params, x: torch.Tensor, mode: str,
                cross_x: Optional[torch.Tensor], cache: Optional[Cache],
                new_cache: Optional[Cache], impl: Optional[str],
                lay: Optional["Layout"] = None) -> torch.Tensor:
    """The whisper decoder's cross sub-block (the reference's
    ``attn_block`` :252-274): queries from this block's stream, keys and
    values projected from the encoder output (no bias, no rope). Prefill
    puts ``c_k``, ``c_v`` into ``new_cache``; decode reads them from
    ``cache``. Under a mesh (``lay``) ``c_wq``, ``c_wk``, ``c_wv`` are
    column slices of this rank's heads where ``lay.attn_tp`` slices them
    (the stream and the encoder output enter through ``copy_to``), the
    cross cache holds this rank's KV heads of every frame, and ``c_wo`` is
    a row slice summed over those axes (``sharding.row_parallel``)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    mesh, tp = (lay.mesh, lay.attn_tp) if lay is not None else (None, ())
    hc = sharding.copy_to(rms_norm(x, params["c_ln"]), mesh, tp)
    qc = (hc @ params["c_wq"]).reshape(B, S, H, hd)
    if mode in ("train", "prefill"):
        if cross_x is None:
            raise ValueError(f"{mode} of a cross-attention block needs cross_x "
                             "(the encoder's output)")
        Fr = cross_x.shape[1]
        cx = sharding.copy_to(cross_x, mesh, tp)
        ck = (cx @ params["c_wk"]).reshape(B, Fr, KV, hd)
        cv = (cx @ params["c_wv"]).reshape(B, Fr, KV, hd)
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
    return x + sharding.row_parallel(cattn.reshape(B, S, H * hd),
                                     params["c_wo"], mesh, tp)


# ======================================================================
# MoE FFN (token-choice top-k, expert-sorted grouped matmul): the
# reference's single-device branch, and under a mesh (``Layout.moe``) its
# Megatron and all-to-all branches
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
               impl: Optional[str], mesh=None, tp: Tuple[str, ...] = ()):
    """xf: (T, d) -> (out (T, d), frac_tokens (E,), mean_prob (E,)).
    ``tp``: the mesh axes that slice ``d_ff`` (the Megatron body): the
    experts read xf through ``copy_to``, the router reads it directly, and
    the expert rows are summed over ``tp`` BEFORE the routing weights
    scale them, so every rank holds the whole product and the router's
    gradient (and that of its input) is whole and the same on each."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    probs, top_p, top_i = route(cfg, params, xf)
    flat_e = top_i.reshape(-1)                              # (T*k,)
    order = torch.argsort(flat_e, stable=True)              # as jnp.argsort
    tok_sorted = order // k                                 # token of each row
    xs = sharding.copy_to(xf, mesh, tp)[tok_sorted]         # (T*k, d)
    # group sizes stay on the device: bincount would read its input's
    # maximum back to the host
    group_sizes = torch.zeros(E, dtype=torch.int32, device=xf.device)
    group_sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))

    g = ops.moe_gmm(xs, params["we_g"], group_sizes, impl=impl)
    u = ops.moe_gmm(xs, params["we_u"], group_sizes, impl=impl)
    hh = F.silu(g.float()).to(xs.dtype) * u
    out_sorted = sharding.reduce_from(
        ops.moe_gmm(hh, params["we_d"], group_sizes, impl=impl), mesh, tp)

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
            impl: Optional[str] = None, lay: Optional["Layout"] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, d) normed activations -> (out (B, S, d), aux), with the
    load-balancing ``aux = E * sum(frac_tokens * mean_prob)`` (float32).
    With no ``lay`` (one rank) the reference's single-device branch. Under
    a mesh it runs inside ``sharded_block``'s body on the local batch
    shard, in the branch ``lay.moe`` names (chosen by ``layout`` with the
    reference's conditions, in its order): ``"local"`` the same branch with
    aux from the global fractions; ``"megatron"`` routing local to the data
    shard, ``we_g``/``we_u`` column slices and ``we_d`` row slices over
    ``model`` (where ``d_ff`` divides) and a float32 sum of the expert rows
    (taken before the routing weights, where the reference sums the
    weighted tokens: the same forward, ``k`` times the bytes summed, and a
    router gradient each rank holds whole), the aux ``pmean``'d over the
    data axes; ``"a2a"`` ``_moe_ffn_a2a``."""
    B, S, d = h.shape
    E = cfg.n_experts
    if lay is not None and lay.gather:
        # the data shard's rows, replicated over model, as the reference's
        # P(data_axes); this rank keeps its own rows of the result (their
        # gradient all-gathered back, so each branch sees a whole one)
        hg = sharding.all_gather(h, lay.mesh, "model", dim=0)
        out, aux = moe_ffn(cfg, params, hg, impl=impl,
                           lay=dataclasses.replace(lay, gather=False))
        return sharding.split(out, lay.mesh, "model", dim=0), aux
    if lay is not None and lay.moe == "a2a":
        return _moe_ffn_a2a(cfg, params, h, lay, impl)
    xf = h.reshape(B * S, d)
    if lay is None or lay.moe == "local":
        out, frac, meanp = _moe_local(cfg, params, xf, impl)
        if lay is not None:   # the batch's shards hold equal token counts
            frac = sharding.pmean(frac, lay.mesh, lay.batch)
            meanp = sharding.pmean(meanp, lay.mesh, lay.batch)
        aux = E * torch.sum(frac * meanp)
        return out.reshape(B, S, d).to(h.dtype), aux
    out, frac, meanp = _moe_local(cfg, params, xf, impl, lay.mesh, lay.moe_tp)
    aux = sharding.pmean(E * torch.sum(frac * meanp), lay.mesh, lay.data)
    return out.reshape(B, S, d).to(h.dtype), aux


# ======================================================================
# The all-to-all MoE branch (GShard-style, sequence-parallel): model rank
# j takes its own slice of the sequence (S/m tokens), routes them with a
# capacity-padded all-to-all to the ranks owning their experts (one expert
# per rank), runs the expert's FFN at full width there, sends the results
# back and all-gathers the sequence once. Over-capacity copies are dropped
# (GShard semantics); the module-level factor is the reference's name, so
# a caller can set it as the reference's test does.
# ======================================================================
MOE_A2A_CAPACITY_FACTOR = 1.25


def _moe_ffn_a2a(cfg: ModelConfig, params, h: torch.Tensor, lay: "Layout",
                 impl: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_ffn_a2a`` body on this rank's local tensors:
    h (B_loc, S, d) replicated over ``model``; ``we_*`` (1, ...) this
    rank's expert. The expert FFN is the reference's plain product (it is
    outside any Pallas kernel there). A copy past its destination's
    capacity C is dropped; as the reference's scatter writes the dropped
    copies' zeros into slot C - 1 after the kept copy there, a
    destination that drops any copy has that slot zeroed."""
    B, S, d = h.shape
    E, k, m = cfg.n_experts, cfg.top_k, lay.m
    wdt = h.dtype
    j = sharding.axis_index(lay.mesh, "model")
    s_my = S // m
    hc = sharding.copy_to(h, lay.mesh, ("model",))
    T = B * s_my
    xf = hc[:, j * s_my:(j + 1) * s_my].reshape(T, d)
    probs, top_p, top_i = route(cfg, params, xf)
    dest = top_i.reshape(-1)                                  # (T*k,)
    C = int(np.ceil(T * k / m * MOE_A2A_CAPACITY_FACTOR))
    one_hot = F.one_hot(dest, m)
    pos = (torch.cumsum(one_hot, dim=0) - 1).gather(1, dest[:, None])[:, 0]
    keep = pos < C
    tok_of = torch.arange(T * k, device=h.device) // k
    # kept copies at (dest, pos); dropped ones into a spare slot C
    slot = torch.where(keep, pos, torch.full_like(pos, C))
    send = xf.new_zeros((m, C + 1, d))
    send = send.index_put((dest, slot), xf[tok_of])
    dropped = torch.zeros(m, dtype=torch.int32, device=h.device).index_add(
        0, dest, (~keep).to(torch.int32)) > 0
    send = send[:, :C] * torch.cat(
        [torch.ones((m, C - 1), dtype=wdt, device=h.device),
         (~dropped).to(wdt)[:, None]], dim=1)[..., None]
    recv = sharding.all_to_all(send, lay.mesh, "model")      # (m, C, d)

    xr = recv.reshape(m * C, d)
    g = xr @ params["we_g"][0]
    u = xr @ params["we_u"][0]
    out_r = ((F.silu(g.float()).to(wdt) * u) @ params["we_d"][0]).reshape(m, C, d)

    back = sharding.all_to_all(out_r, lay.mesh, "model")      # (m, C, d)
    w_flat = top_p.reshape(-1) * keep
    gathered = back[dest, torch.where(keep, pos, torch.full_like(pos, C - 1))]
    out = torch.zeros((T, d), dtype=torch.float32, device=h.device).index_add(
        0, tok_of, gathered.float() * w_flat[:, None])
    out = out.reshape(B, s_my, d).to(wdt)
    out_full = sharding.all_gather(out, lay.mesh, "model", dim=1).float()

    gs = torch.zeros(E, dtype=torch.float32, device=h.device).index_add(
        0, dest, torch.ones_like(dest, dtype=torch.float32))
    aux = E * torch.sum((gs / max(T * k, 1)) * probs.mean(dim=0))
    aux = sharding.pmean(aux, lay.mesh, lay.data + ("model",))
    return out_full.to(wdt), aux


# ======================================================================
# A block of any kind under a mesh of more than one rank
# ======================================================================
@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """Where an attention block's dense K/V cache (B, L, KV, hd) lives on
    ``model``, as ``spec_for`` over ("batch", "kv_seq", "kv", None) places
    it (the reference's ``attn_cache_specs``): ``seq``, rank r holds slots
    [r L/m, (r + 1) L/m) of every KV head (``L % m == 0``, the usual case);
    ``heads``, rank r its KV heads of every slot (``L % m != 0``, ``KV % m
    == 0``); neither, every rank the whole cache."""

    seq: bool
    heads: bool


def cache_layout(cfg: ModelConfig, plan, B: int, L: int) -> CacheLayout:
    spec = sharding.spec_for((B, L, cfg.n_kv_heads, cfg.hd),
                             ("batch", "kv_seq", "kv", None), plan.rules,
                             plan.mesh)
    seq, heads = (i < len(spec) and "model" in sharding.spec_axes(spec[i])
                  for i in (1, 2))
    return CacheLayout(seq=seq, heads=heads)


MOE_LEAVES = ("router", "we_g", "we_u", "we_d")


@dataclasses.dataclass(frozen=True)
class Layout:
    """How one attention block computes under a mesh (``layout``): the
    mesh axes that shard the batch, the model axis's size ``m``, which
    fused dims are sliced over ``model`` (heads, KV heads, ``d_ff``), the
    MoE branch, whether the MoE layer first gathers its rows over
    ``model`` (``gather``: the no_tp rules put the batch on it), each
    leaf's compute and gradient placements (``placements``), and in
    serving where its cache lives (``cache``; None in ``train``)."""

    mesh: object
    batch: Tuple[str, ...]
    data: Tuple[str, ...]         # the data axes the MoE branch pmeans over
    m: int
    attn_tp: Tuple[str, ...]      # ("model",) where the heads are sliced
    kv_tp: bool
    ff_tp: Tuple[str, ...]
    moe: Optional[str]            # None | "local" | "megatron" | "a2a"
    moe_tp: Tuple[str, ...]
    tp_dims: Dict[str, Optional[int]]
    partial_on_model: Tuple[str, ...]
    cache: Optional[CacheLayout] = None
    gather: bool = False

    def placements(self, plan, name: str):
        """(compute, gradient) placements of leaf ``name``: ``Plan``'s,
        but for the expert leaves of a layer that gathers its rows
        (``gather``), sliced over ``model`` although it carries the batch,
        their gradients partial over the data axes (the gathered rows of a
        data shard; over ``model`` too for the all-to-all router, whose
        model ranks route different tokens)."""
        tp, partial = self.tp_dims.get(name), name in self.partial_on_model
        if not (self.gather and name in MOE_LEAVES):
            return plan.compute(tp), plan.grad(tp, partial)
        return (plan.compute(tp, model="model"),
                plan.grad(tp, partial, model="model", batch=self.data))


def layout(cfg: ModelConfig, params, plan, B: int, S: int) -> Layout:
    """The block's ``Layout`` for a global batch of B sequences of S
    tokens under ``plan`` (``sharding.make_plan``). The heads are sliced
    over ``model`` only where ``model`` divides the head count (``spec_for``
    tests the fused H*hd dim, which may split a head: such leaves compute
    replicated); KV heads where it also divides KV, else every rank takes
    the KV heads its query heads read (a cross-attention block slices its
    heads only where ``model`` divides the KV heads too, so its cross cache
    is split by KV heads exactly where ``spec_for`` splits it). Where the
    batch spans ``model`` (the no_tp rules) nothing of the attention or a
    dense MLP is sliced. The MoE branch follows the reference's conditions
    in order, whatever the rules say of the batch (its data axes are
    ("pod", "data") alone): local where the data axes do not divide B,
    then ``model`` where it divides d_ff, then the all-to-all branch where
    the rules ask for it, S > 1, ``model`` divides S and E equals its
    size; otherwise Megatron. Both take a data shard's rows replicated
    over ``model``, so where the batch spans ``model`` the layer gathers
    its rows over it first (``gather``) and keeps its own rows of the
    result."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    sizes = sharding.mesh_axis_sizes(plan.mesh)
    m = sizes.get("model", 1)
    heads = plan.model is not None and H % m == 0 and \
        ("c_wq" not in params or KV % m == 0)
    kv_tp = heads and KV % m == 0
    ff = plan.model is not None and cfg.d_ff % m == 0
    moe = moe_tp = None
    data = tuple(a for a in ("pod", "data") if a in sizes)
    if "router" in params:
        n_data = int(np.prod([sizes[a] for a in data])) if data else 1
        if n_data <= 1 or B % n_data:
            moe, data = "local", ()
        else:
            mm = sizes.get("model", 1)
            moe_model = mm > 1 and cfg.d_ff % mm == 0
            moe = "megatron"
            if plan.rules.get("_moe_a2a") and moe_model and S > 1 and \
                    S % mm == 0 and cfg.n_experts == mm:
                moe = "a2a"
            moe_tp = ("model",) if moe_model else ()
    tp = {"wq": 1, "bq": 0, "wo": 0, "c_wq": 1, "c_wo": 0} if heads else {}
    if kv_tp:
        tp.update(wk=1, wv=1, bk=0, bv=0, c_wk=1, c_wv=1)
    if ff and moe is None:
        tp.update(wg=1, wu=1, wd=0)
    if moe == "megatron" and moe_tp:
        tp.update(we_g=2, we_u=2, we_d=1)
    if moe == "a2a":
        tp.update(we_g=0, we_u=0, we_d=0)
    partial = ("router",) if moe == "a2a" else ()
    if heads and not kv_tp:
        partial += ("wk", "wv", "bk", "bv")
    return Layout(mesh=plan.mesh, batch=plan.batch, data=data, m=m,
                  attn_tp=("model",) if heads else (), kv_tp=kv_tp,
                  ff_tp=("model",) if ff else (), moe=moe,
                  moe_tp=moe_tp or (), tp_dims=tp, partial_on_model=partial,
                  gather=moe in ("megatron", "a2a") and "model" in plan.batch)


def _local_heads(cfg: ModelConfig, lay: Layout, p):
    """(cfg, p, kv_whole) as this rank computes its heads: ``cfg`` with
    the local head counts (``head_dim`` pinned) and, where ``model`` slices
    the query heads but not the KV heads, ``wk``/``wv``/``bk``/``bv``
    narrowed to the columns of the KV heads this rank's query heads read:
    each once when every one is read by the same number of consecutive
    local query heads, else one a query head (the kernel then runs at G =
    1); ``kv_whole`` those leaves whole there, else None."""
    if not lay.attn_tp:
        return cfg, p, None
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Hl = H // lay.m
    if lay.kv_tp:
        return dataclasses.replace(cfg, n_heads=Hl, n_kv_heads=KV // lay.m,
                                   head_dim=hd), p, None
    r = sharding.axis_index(lay.mesh, "model")
    of = [h // (H // KV) for h in range(r * Hl, (r + 1) * Hl)]
    read = sorted(set(of))
    if Hl % len(read) or of != [read[i // (Hl // len(read))] for i in range(Hl)]:
        read = of
    cols = torch.tensor([c for h in read for c in range(h * hd, (h + 1) * hd)],
                        device=p["wk"].device)
    whole = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    p = dict(p, **{n: t.index_select(-1, cols) for n, t in whole.items()})
    return dataclasses.replace(cfg, n_heads=Hl, n_kv_heads=len(read),
                               head_dim=hd), p, whole


def _weights(cfg: ModelConfig, names, args) -> Dict[str, torch.Tensor]:
    """A body's weight leaves by name, an integer (int8) leaf dequantized
    here, this rank's shard of this layer alone (``layers.dequantize``, as
    the one-card ``_apply_block``): the int8 leaves move between ranks as
    int8."""
    wdt = torch_dtype(cfg.dtype)
    return {n: dequantize(t, wdt) for n, t in zip(names, args)}


def _take_cache(mode: str, leaves, args):
    """(cache, rest): in ``decode`` a body's first arguments are its cache
    leaves, in ``leaves`` order; else there are none."""
    if mode != "decode":
        return None, args
    return dict(zip(leaves, args)), args[len(leaves):]


def _body_out(mode: str, x, cache, leaves, aux=None):
    """A body's outputs: (x, aux) in ``train`` (aux a 0-d float32, zero
    where the block has none); (x, *cache leaves) in serving (decode: the
    local tensors it was given, written in place)."""
    if mode != "train":
        return (x,) + tuple(cache[n] for n in leaves)
    return x, (aux if aux is not None else
               torch.zeros((), dtype=torch.float32, device=x.device))


def _attn_body(cfg: ModelConfig, kind: BlockKind, lay: Layout, names, leaves,
               mode: str, rope_cs, cache_len, impl, causal: bool,
               cross: bool, x: torch.Tensor, *args):
    """``attn_block`` on this rank's local tensors: x (B_loc, S, d); then
    with ``cross`` (a whisper decoder block in ``train`` or ``prefill``)
    the encoder's output (B_loc, F, d); in ``decode`` the local positions
    (B_loc,) and this rank's cache leaves (``leaves``); then the layer's
    leaves in their compute placements (``Layout.tp_dims``)."""
    cross_x = pos = None
    if cross:
        cross_x, *args = args
    if mode == "decode":
        pos, *args = args
        rope_cs = rope_tables(pos[:, None], cfg.hd, cfg.rope_theta)
    cache, args = _take_cache(mode, leaves, args)
    cfg, p, whole = _local_heads(cfg, lay, _weights(cfg, names, args))
    x, cache, aux = attn_block(cfg, kind, p, x, mode=mode, rope_cs=rope_cs,
                               cache=cache, pos=pos, causal=causal,
                               cross_x=cross_x, cache_len=cache_len,
                               impl=impl, lay=lay, kv_whole=whole)
    return _body_out(mode, x, cache, leaves, aux)


def _rglru_body(cfg: ModelConfig, lay: Layout, names, leaves, mode: str,
                impl, x: torch.Tensor, *args):
    """``rglru_block`` on this rank's batch rows, the recurrence and its
    weights whole, the MLP sliced over ``lay.ff_tp``: in ``train`` through
    K5 and its backward (``RGLRUScanFn``), in ``prefill`` and ``decode``
    with this rank's state leaves h, conv (decode: first, written in
    place)."""
    cache, args = _take_cache(mode, leaves, args)
    x, cache, _ = rglru_block(cfg, _weights(cfg, names, args), x, mode=mode,
                              cache=cache, impl=impl, lay=lay)
    return _body_out(mode, x, cache, leaves)


def _xlstm_body(cfg: ModelConfig, kind: BlockKind, names, leaves, mode: str,
                x: torch.Tensor, *args):
    """``mlstm_block`` or ``slstm_block`` on this rank's batch rows with
    every weight whole (the ``ff``-split leaves gathered a layer at a time)
    and its state leaves, float32 (decode: first, written in place). The
    sLSTM steps its tokens here, on local tensors."""
    cache, args = _take_cache(mode, leaves, args)
    block = mlstm_block if kind == BlockKind.MLSTM else slstm_block
    x, cache = block(cfg, _weights(cfg, names, args), x, mode=mode, cache=cache)
    return _body_out(mode, x, cache, leaves)


# ======================================================================
# An attention cache under a mesh of more than one rank: split over its
# sequence, its KV heads or neither, as the reference's placements
# ======================================================================
def _whole_kv(cfg: ModelConfig, lay: Layout, kv_whole, h, k, v, cos, sin):
    """Every KV head's k, v (B, S, KV, hd) on this rank: as computed where
    ``model`` does not slice the heads; from ``kv_whole``, the whole
    ``wk``/``wv`` (``_local_heads``), where it slices the query heads but
    not the KV heads. Where it slices the KV heads too, each rank holds its
    own and the caller moves them with a collective."""
    if kv_whole is None:
        assert not lay.kv_tp, "KV heads sliced over model: move them"
        return k, v
    k, v = _kv(cfg, kv_whole, h)
    return apply_rope(k, cos, sin), v


def _prefill_serve_cache(cfg: ModelConfig, kind: BlockKind, lay: Layout,
                         kv_whole, h, k, v, rope_cs, cache_len):
    """This rank's part of the block's prefill cache, split over the
    sequence or whole (``lay.cache``): the ring (or padded cache) of
    ``_prefill_cache`` over the KV heads this rank computed, then, split
    over the sequence, its slot range: with the KV heads sliced over
    ``model``, an all-to-all sends each rank the range it keeps of every
    rank's heads; else its range of every head."""
    seq = lay.cache.seq
    if not (seq and lay.kv_tp):
        k, v = _whole_kv(cfg, lay, kv_whole, h, k, v, *rope_cs)
    c = _prefill_cache(cfg, kind, k, v, cache_len)
    if not seq:
        return c
    m = lay.m
    out = {}
    for name, t in c.items():
        B, L, KVr, hd = t.shape
        Lr = L // m
        if lay.kv_tp:       # (m, B, L/m, KV/m, hd): range j to rank j
            blocks = t.reshape(B, m, Lr, KVr, hd).transpose(0, 1).contiguous()
            got = sharding.all_to_all(blocks, lay.mesh, "model")
            out[name] = got.permute(1, 2, 0, 3, 4).reshape(B, Lr, m * KVr, hd)
        else:
            r = sharding.axis_index(lay.mesh, "model")
            out[name] = t[:, r * Lr:(r + 1) * Lr].contiguous()
    return out


def _merge_weights(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention over a whole cache from the attention over each of its
    ranges: o (m, B, H, hd) and lse (m, B, H) float32, weighted by
    exp(lse - max lse). A range with no valid slot has lse -inf and weighs
    0; a row with none anywhere stays 0, as K3's. Returns (B, H, hd)."""
    top = lse.amax(dim=0)
    w = torch.where(torch.isneginf(lse), torch.zeros_like(lse), torch.exp(lse - top))
    return (w[..., None] * o).sum(dim=0) / \
        torch.clamp(w.sum(dim=0), min=1e-30)[..., None]


def _merge_ranges(o: torch.Tensor, lse: torch.Tensor, mesh) -> torch.Tensor:
    """Each model rank's K3 output o (B, 1, H, hd) and lse (B, H) over its
    range of the cache, gathered in float32 and merged
    (``_merge_weights``): the attention over the whole cache, in o's
    dtype."""
    B, _, H, hd = o.shape
    packed = torch.cat([o.float().reshape(B, H, hd), lse[..., None]], dim=-1)
    every = sharding.all_gather(packed[None], mesh, "model", dim=0)
    out = _merge_weights(every[..., :-1], every[..., -1])
    return out.reshape(B, 1, H, hd).to(o.dtype)


def _decode_serve_attn(cfg: ModelConfig, kind: BlockKind, lay: Layout,
                       kv_whole, h, q, k, v, cos, sin, pos, k_cache, v_cache,
                       impl):
    """One decode token of every local row against this rank's part of a
    cache split over the sequence or whole (``lay.cache``), written in
    place: returns the attention of this rank's query heads (B, 1, H_loc,
    hd). The new K/V of every KV head are written at slot ``pos % L`` by
    the rank whose range holds it, the query of every head runs K3 on this
    rank's range with its local ``kv_len`` (the valid slots are always the
    prefix [0, kv_len), ``_ring_slot``), and the ranks' outputs of a split
    cache are merged (``_merge_ranges``)."""
    _, chunk = _attn_window(cfg, kind)
    B = q.shape[0]
    Lr = k_cache.shape[1]
    seq, mesh = lay.cache.seq, lay.mesh
    slot, kv_len = _ring_slot(chunk, pos, Lr * (lay.m if seq else 1))
    bidx = torch.arange(B, device=q.device)
    if lay.kv_tp:           # the new token's K/V of every KV head (tiny)
        k, v = (sharding.all_gather(t, mesh, "model", dim=2) for t in (k, v))
    else:
        k, v = _whole_kv(cfg, lay, kv_whole, h, k, v, cos, sin)
    r = sharding.axis_index(mesh, "model") if seq else 0
    own = (slot // Lr == r)[:, None, None]
    here = torch.clamp(slot - r * Lr, 0, Lr - 1)
    for c, new in ((k_cache, k), (v_cache, v)):
        c[bidx, here] = torch.where(own, saturate_cast(new[:, 0], c.dtype),
                                    c[bidx, here])
    Hl = q.shape[2]
    if lay.attn_tp:         # the query of every head (tiny)
        q = sharding.all_gather(q, mesh, "model", dim=2)
    local_len = torch.clamp(kv_len - r * Lr, 0, Lr).to(torch.int32)
    if seq:
        o, lse = ops.decode_attention(q, k_cache, v_cache, local_len,
                                      return_lse=True, impl=impl)
        o = _merge_ranges(o, lse, mesh)
    else:
        o = ops.decode_attention(q, k_cache, v_cache, local_len, impl=impl)
    if lay.attn_tp:         # this rank's heads, for the row-parallel wo
        j = sharding.axis_index(mesh, "model")
        o = o[:, :, j * Hl:(j + 1) * Hl]
    return o


XLSTM_KINDS = (BlockKind.MLSTM, BlockKind.SLSTM)
STATE_LEAVES = {BlockKind.RGLRU: ("h", "conv"), BlockKind.MLSTM: ("C", "n", "m"),
                BlockKind.SLSTM: SLSTM_STATE}


def cache_leaves(cfg: ModelConfig, kind: BlockKind) -> Tuple[str, ...]:
    """The names of one layer's dense decode cache leaves: a recurrent
    kind's state, an attention kind's K/V (and a whisper decoder block's
    cross K/V)."""
    if kind in STATE_LEAVES:
        return STATE_LEAVES[kind]
    return ("k", "v") + (("c_k", "c_v") if cfg.is_encdec else ())


def sharded_block(cfg: ModelConfig, kind: BlockKind, plan, params, x, *,
                  mode: str, rope_cs=None, impl: Optional[str] = None,
                  causal: bool = True, cross_x=None,
                  cache: Optional[dict] = None,
                  cache_pl: Optional[Dict[str, list]] = None, pos=None,
                  cache_len: Optional[int] = None):
    """One layer of any kind under a mesh of more than one rank, as one
    ``local_map`` body on local tensors: x a DTensor (B, S, d) sharded over
    ``plan.batch``; ``params`` the layer's DTensor leaves in their stored
    placements, redistributed to the placements the body computes with
    (attention and RG-LRU: ``layout``; xLSTM: every leaf whole);
    ``rope_cs`` the plain (cos, sin) of the sequence's positions
    (``train``, ``prefill``); ``causal=False`` the whisper encoder's
    attention; ``cross_x`` (a whisper decoder block in ``train`` or
    ``prefill``) the encoder's output, a DTensor in the batch's placements.
    ``train``: returns (x, None, aux), aux a replicated 0-d DTensor for a
    MoE layer else None; each leaf's gradient comes back in its compute
    placements, partial over the axes that shard the batch (``Plan.grad``),
    which the caller reduces into the stored shards. ``prefill`` and
    ``decode``: ``cache_pl`` {leaf: placements} of the layer's cache
    (``sharding.cache_placements``); ``cache`` (decode) the layer's cache
    DTensors in those placements; ``pos`` (decode) a DTensor (B,) in the
    batch's placements; returns (x, {leaf: DTensor}) in ``cache_pl``
    (decode: the local tensors it was given, written in place)."""
    from torch.distributed.tensor.experimental import local_map
    B, S, _ = x.shape
    names = sorted(params)
    leaves = () if mode == "train" else cache_leaves(cfg, kind)
    lay = None
    if kind in XLSTM_KINDS:
        body = functools.partial(_xlstm_body, cfg, kind, names, leaves, mode)
    else:
        lay = layout(cfg, params, plan, B, S)
        if kind == BlockKind.RGLRU:
            body = functools.partial(_rglru_body, cfg, lay, names, leaves, mode,
                                     impl)
        else:
            if mode != "train":
                Lg = cache["k"].shape[1] if mode == "decode" else \
                    attn_cache_len(cfg, kind, cache_len or S)
                lay = dataclasses.replace(lay, cache=cache_layout(cfg, plan, B, Lg))
            body = functools.partial(_attn_body, cfg, kind, lay, names, leaves,
                                     mode, rope_cs, cache_len, impl, causal,
                                     cross_x is not None)
    act = plan.activation()
    lead = () if cross_x is None else (cross_x,)
    lead_pl = () if cross_x is None else (act,)
    if mode == "decode":    # an attention layer's positions, then the cache
        if kind in ATTN_KINDS:
            lead, lead_pl = lead + (pos,), lead_pl + (act,)
        lead += tuple(cache[n] for n in leaves)
        lead_pl += tuple(cache_pl[n] for n in leaves)
    pls = [lay.placements(plan, n) if lay is not None else
           (plan.compute(None), plan.grad(None)) for n in names]
    weights_pl = tuple(c for c, _ in pls)
    if mode == "train":
        out_pl = (act, plan.replicated())
        grad_pl = (act,) + lead_pl + tuple(g for _, g in pls)
    else:
        out_pl, grad_pl = (act,) + tuple(cache_pl[n] for n in leaves), None
    fn = local_map(body, out_placements=out_pl,
                   in_placements=(act,) + lead_pl + weights_pl,
                   in_grad_placements=grad_pl, device_mesh=plan.mesh)
    # x as the body takes it: a constrain site may have left its d sharded
    # over an axis the batch does not take (a batch of 1, or one the model
    # axis does not divide under the no_tp rules)
    out = fn(sharding.to_placements(x, act), *lead,
             *(sharding.to_placements(params[n], pl) for n, pl in zip(names, weights_pl)))
    if mode == "train":
        return out[0], None, (out[1] if lay is not None and lay.moe else None)
    return out[0], dict(zip(leaves, out[1:]))


# ======================================================================
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ======================================================================
def rglru_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    D = d  # recurrence width
    s = {
        "ln1": Spec((d,), (None,), init="zeros"),
        "w_x": Spec((d, D), ("embed", "state")),
        "w_g": Spec((d, D), ("embed", "state")),
        "conv_w": Spec((4, D), (None, "state"), scale=0.5),
        "conv_b": Spec((D,), ("state",), init="zeros"),
        "w_a": Spec((D, D), ("state", None), scale=0.02),
        "b_a": Spec((D,), (None,), init="zeros"),
        "w_i": Spec((D, D), ("state", None), scale=0.02),
        "b_i": Spec((D,), (None,), init="zeros"),
        "lam": Spec((D,), ("state",), init="ones", scale=1.0),
        "w_out": Spec((D, d), ("state", "embed")),
        "ln2": Spec((d,), (None,), init="zeros"),
    }
    s.update(mlp_specs(d, cfg.d_ff))
    return s


def rglru_cache_specs(cfg: ModelConfig, B: int) -> Dict[str, Spec]:
    D = cfg.d_model
    return {
        "h": Spec((B, D), ("batch", "state"), init="zeros", dtype="float32"),
        "conv": Spec((B, 3, D), ("batch", None, "state"), init="zeros"),
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
                mask: Optional[torch.Tensor] = None,
                lay: Optional["Layout"] = None
                ) -> Tuple[torch.Tensor, Optional[Cache], Optional[torch.Tensor]]:
    """Returns (x, cache, aux) (aux as ``attn_block``'s). ``train`` runs
    the sequence with no cache (None);
    ``prefill`` returns a new cache ``{"h": (B, D) float32, "conv": (B, 3,
    D)}``; ``chunk`` continues the conv and the
    recurrence from ``cache`` and ``decode`` advances them one step, both
    writing ``cache`` in place (``decode`` only on rows where ``mask``).
    ``lay`` (under a mesh, from ``sharded_block``'s body): the MLP's
    slices over ``lay.ff_tp`` (``_ffn``); the recurrence runs whole on the
    rank's batch rows."""
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
    x, aux = _ffn(cfg, params, x, impl, lay)
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
        "ln": Spec((d,), (None,), init="zeros"),
        "w_up": Spec((d, 2 * di), ("embed", "ff")),
        "wq": Spec((di, di), ("ff", None)),
        "wk": Spec((di, di), ("ff", None)),
        "wv": Spec((di, di), ("ff", None)),
        "w_if": Spec((di, 2 * nh), (None, None), scale=0.02),
        "b_i": Spec((nh,), (None,), init="zeros"),
        "b_f": Spec((nh,), (None,), init="ones"),
        "w_down": Spec((di, d), ("ff", "embed")),
    }


def mlstm_cache_specs(cfg: ModelConfig, B: int) -> Dict[str, Spec]:
    """The matrix memory ``C`` (B, nh, hd, hd), normaliser ``n`` (B, nh,
    hd) and stabiliser ``m`` (B, nh), all float32."""
    _, nh, hd = _mlstm_dims(cfg)
    return {
        "C": Spec((B, nh, hd, hd), ("batch", None, "state", None),
                  init="zeros", dtype="float32"),
        "n": Spec((B, nh, hd), ("batch", None, "state"), init="zeros",
                  dtype="float32"),
        "m": Spec((B, nh), ("batch", None), init="zeros", dtype="float32"),
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
    # masked before the exp: past the diagonal logw grows with the distance
    # and overflows, and exp's gradient there (inf) times where's zero is
    # NaN (the reference's ``where(causal, exp(logw), 0)`` gives non-finite
    # gradients at full width from ~256 tokens); the values are the same
    w = torch.exp(torch.where(causal, logw, float("-inf")))
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
        "ln1": Spec((d,), (None,), init="zeros"),
        "w_gates": Spec((d, 4 * d), ("embed", "ff")),
        "b_gates": Spec((4 * d,), (None,), init="zeros"),
        "r_gates": Spec((nh, hd, 4 * hd), (None, "state", None), scale=0.02),
        "w_out": Spec((d, d), ("state", "embed")),
        "ln2": Spec((d,), (None,), init="zeros"),
    }
    s.update(mlp_specs(d, ffi))
    return s


def slstm_cache_specs(cfg: ModelConfig, B: int) -> Dict[str, Spec]:
    nh, hd, _ = _slstm_dims(cfg)
    return {name: Spec((B, nh, hd), ("batch", None, "state"), init="zeros",
                       dtype="float32")
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
