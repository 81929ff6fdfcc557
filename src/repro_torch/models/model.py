"""Model assembly for the dense global-attention family (a port of
``repro.models.model``).

Parameters keep the reference's tree: ``embed/tok``, ``final_ln`` and
``blocks/p0/<leaf>`` stacked on a leading ``n_layers`` axis (the ported
family's pattern is one global-attention block, so every layer is a
period and there are no remainder layers). Where the reference runs the
periods under ``lax.scan``, the port loops over the stacked axis in
Python. Paged K/V pools are ``blocks/p0/{k,v}`` of shape (n_layers,
num_pages, page, KV, hd); layer ``i``'s pool is the view ``[i]``, which
``attn_block`` updates in place.

Public API (same names and arguments as the reference, plus ``device``):
  param_specs(cfg), init_model_params(cfg, seed, device)
  paged_cache_specs(...), init_paged_cache(...), paged_leaf_flags(cfg, cache)
  chunked_prefill_supported(cfg)
  forward(cfg, params, batch, mode=...), prefill, decode_step, prefill_chunk
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockKind, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.layers import embed, embed_specs, rms_norm, rope_tables, unembed
from repro_torch.models.param import Spec, init_params, iter_leaves, map_tree


# ----------------------------------------------------------------------
# Spec assembly
# ----------------------------------------------------------------------
def _stack(specs, n: int):
    return map_tree(lambda _, s: Spec((n,) + s.shape, init=s.init,
                                      scale=s.scale, dtype=s.dtype), specs)


def _check_supported(cfg: ModelConfig) -> None:
    if tuple(cfg.pattern) != (BlockKind.ATTN,) or cfg.is_encdec or \
            cfg.n_experts or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: only dense global-attention decoders are ported "
            "(pattern (ATTN,), no MoE, encoder or vision prefix)")


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_supported(cfg)
    return {
        "embed": embed_specs(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings),
        "final_ln": Spec((cfg.d_model,), init="zeros"),
        "blocks": {"p0": _stack(B.attn_specs(cfg), cfg.n_layers)},
    }


def init_model_params(cfg: ModelConfig, seed: int = 0,
                      device: DeviceLike = None):
    """Random weights at the config's widths, from ``seed``, on ``device``
    (default: the card)."""
    return init_params(param_specs(cfg), seed, cfg.dtype,
                       resolve_device(device))


# ----------------------------------------------------------------------
# Paged KV cache (serving): global-attention K/V live in a shared pool of
# (num_pages, page_size) token pages indexed through block tables
# ----------------------------------------------------------------------
def paged_cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                      num_pages: int, page_size: int) -> Dict[str, Any]:
    """Pooled k/v per attention layer; ``batch``/``seq_len`` size per-slot
    leaves, of which the ported (global-attention) family has none."""
    _check_supported(cfg)
    pool = Spec((num_pages, page_size, cfg.n_kv_heads, cfg.hd), init="zeros")
    return {"blocks": {"p0": _stack({"k": pool, "v": pool}, cfg.n_layers)}}


def init_paged_cache(cfg: ModelConfig, batch: int, seq_len: int,
                     num_pages: int, page_size: int,
                     device: DeviceLike = None):
    return init_params(paged_cache_specs(cfg, batch, seq_len, num_pages,
                                         page_size),
                       0, cfg.dtype, resolve_device(device))


def paged_leaf_flags(cfg: ModelConfig, cache) -> list:
    """Per-leaf booleans (``iter_leaves`` order): True for pooled
    global-attention k/v leaves, False for per-slot leaves."""
    def is_paged(path: str) -> bool:
        keys = path.split("/")
        return keys[0] == "blocks" and keys[-1] in ("k", "v") and \
            cfg.pattern[int(keys[1][1:])] == BlockKind.ATTN
    return [is_paged(path) for path, _ in iter_leaves(cache)]


def chunked_prefill_supported(cfg: ModelConfig) -> bool:
    """Chunked prefill needs every block to carry O(1) state between
    chunks; of the ported kinds that is global attention (paged pool)."""
    return not cfg.is_encdec and all(k == BlockKind.ATTN for k in cfg.pattern)


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            mode: str, cache=None, pos=None,
            cache_len: Optional[int] = None, impl: Optional[str] = None,
            block_tables: Optional[torch.Tensor] = None):
    """Returns (logits, cache).

    ``batch``: tokens (B, S); decode mode: tokens (B, 1) + ``pos`` (B,).
    ``prefill`` returns the dense cache ``blocks/p0/{k,v}`` of shape
    (n_layers, B, L, KV, hd), zero-padded to ``cache_len`` (default S).
    ``chunk``: one prefill chunk at positions ``pos + [0, C)`` (``pos`` an
    int) against the paged ``cache``; ``decode``: one token per sequence.
    Both update the paged pools of ``cache`` in place and return it.
    """
    _check_supported(cfg)
    if mode not in ("prefill", "chunk", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, cfg.d_model)
    S = tokens.shape[1]
    if mode == "decode":
        positions = pos[:, None]
    else:
        start = int(pos) if mode == "chunk" else 0
        positions = (start + torch.arange(S, device=tokens.device))[None, :]
    rope_cs = rope_tables(positions, cfg.hd, cfg.rope_theta)
    layers = params["blocks"]["p0"]
    pools = cache["blocks"]["p0"] if mode != "prefill" else None
    dense = []
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in layers.items()}
        c = {"k": pools["k"][i], "v": pools["v"][i]} if pools else None
        x, nc = B.attn_block(cfg, BlockKind.ATTN, p, x, mode=mode, cache=c,
                             pos=pos, impl=impl, block_tables=block_tables,
                             rope_cs=rope_cs)
        dense.append(nc)
    x = rms_norm(x, params["final_ln"])
    if mode in ("prefill", "chunk"):
        # serving only needs the next-token distribution
        x = x[:, -1:]
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    if mode != "prefill":
        return logits, cache
    pad = max((cache_len or S) - S, 0)
    return logits, {"blocks": {"p0": {
        name: F.pad(torch.stack([c[name] for c in dense]),
                    (0, 0, 0, 0, 0, pad))
        for name in ("k", "v")}}}


def prefill(cfg: ModelConfig, params, batch, *, cache_len=None, impl=None):
    """Run the prompt; returns (last-position logits, dense cache)."""
    logits, cache = forward(cfg, params, batch, mode="prefill",
                            cache_len=cache_len, impl=impl)
    return logits[:, -1:], cache


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: torch.Tensor, *, impl=None,
                block_tables: Optional[torch.Tensor] = None):
    """One token per sequence against the paged cache. Returns (logits,
    cache); the cache's pools are updated in place."""
    return forward(cfg, params, {"tokens": tokens}, mode="decode",
                   cache=cache, pos=pos, impl=impl, block_tables=block_tables)


def prefill_chunk(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                  pos: int, block_tables: Optional[torch.Tensor], *,
                  impl=None):
    """Advance an in-flight prompt by one chunk at positions
    ``pos + [0, C)``. Returns (last-position logits, cache); the logits
    only mean "next token" once the final chunk has run."""
    logits, cache = forward(cfg, params, {"tokens": tokens}, mode="chunk",
                            cache=cache, pos=pos, impl=impl,
                            block_tables=block_tables)
    return logits[:, -1:], cache
