"""Attention block of the dense global-attention family (a port of
``repro.models.blocks``: ``attn_specs``, ``_qkv``, ``_ffn``, ``attn_block``).

``attn_block`` runs ``BlockKind.ATTN`` in three modes, as the reference:

* ``prefill`` — the whole prompt through K2
  (``flash_attention``); returns the dense K/V the engine installs into
  the paged pool.
* ``chunk`` — one prefill chunk: its K/V scattered into this sequence's
  pool pages, attention through K1 (``paged_prefill_attention``).
* ``decode`` — one token per sequence: its K/V written at
  ``(page[pos // page], pos % page)``, attention through K1
  (``paged_decode_attention``).

Pool writes are IN PLACE (``index_put_``): where the JAX engine donates the
cache buffer so XLA can update it in place, the port mutates the pool it is
handed and returns that same tensor. Other block kinds, and the dense
per-slot decode cache (which needs kernel K3), raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import BlockKind, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, mlp, mlp_specs, rms_norm
from repro_torch.models.param import Spec

Cache = Dict[str, torch.Tensor]


def attn_specs(cfg: ModelConfig) -> Dict[str, Spec]:
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
    s.update(mlp_specs(d, cfg.d_ff))
    return s


def _qkv(cfg: ModelConfig, params, h: torch.Tensor):
    B, S = h.shape[:2]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = h @ params["wq"], h @ params["wk"], h @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def _ffn(params, x: torch.Tensor) -> torch.Tensor:
    return x + mlp(params, rms_norm(x, params["ln2"]))


def attn_block(cfg: ModelConfig, kind: BlockKind, params, x: torch.Tensor, *,
               mode: str, rope_cs: Tuple[torch.Tensor, torch.Tensor],
               cache: Optional[Cache] = None,
               pos: Optional[torch.Tensor] = None,
               impl: Optional[str] = None,
               block_tables: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (x, cache). ``prefill`` returns the block's dense K/V
    ``{"k", "v"}`` of shape (B, S, KV, hd); ``chunk``/``decode`` write into
    the pools of ``cache`` in place and return it. ``pos``: chunk start
    (int) in ``chunk`` mode, per-sequence positions (B,) in ``decode``.
    ``rope_cs``: (cos, sin) of this call's positions from
    ``layers.rope_tables``; ``forward`` computes them once for all layers."""
    if kind != BlockKind.ATTN:
        raise NotImplementedError(
            f"block kind {kind.value!r} is not ported yet (only global "
            "attention, the granite-3-2b serving path)")
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = rms_norm(x, params["ln1"])
    cos, sin = rope_cs

    if mode == "prefill":
        q, k, v = _qkv(cfg, params, h)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        attn = ops.flash_attention(q, k, v, causal=True, impl=impl)
        new_cache = {"k": k, "v": v}
    elif mode == "chunk":
        if cache is None or pos is None or block_tables is None:
            raise ValueError("chunk mode needs cache, pos and block_tables")
        start = int(pos)
        tokpos = start + torch.arange(S, device=x.device)        # (S,)
        q, k, v = _qkv(cfg, params, h)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
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
        if block_tables is None:
            raise NotImplementedError(
                "dense per-slot decode needs kernel K3 (decode_attention), "
                "not ported yet; serve with a paged cache (page_size > 0)")
        q, k_new, v_new = _qkv(cfg, params, h)                     # S == 1
        q, k_new = apply_rope(q, cos, sin), apply_rope(k_new, cos, sin)
        k_pool, v_pool = cache["k"], cache["v"]
        page = k_pool.shape[1]
        posl = pos.long()
        phys = block_tables.long().gather(1, (posl // page)[:, None])[:, 0]
        off = posl % page
        # inactive engine rows carry an all-zeros table: their writes land
        # in the reserved scratch page 0
        k_pool[phys, off] = k_new[:, 0].to(k_pool.dtype)
        v_pool[phys, off] = v_new[:, 0].to(v_pool.dtype)
        kv_len = (pos + 1).to(torch.int32)
        attn = ops.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                          kv_len, impl=impl)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    x = x + attn.reshape(B, S, H * hd) @ params["wo"]
    return _ffn(params, x), new_cache
