"""Model assembly: pattern-tiled layer stacks (a port of
``repro.models.model``).

The layer stack is ``cfg.pattern`` repeated. Parameters keep the
reference's tree: ``embed/tok``, ``final_ln``, ``blocks/p{i}/<leaf>``
stacked on a leading ``n_periods`` axis for pattern position ``i``, and
``rem/r{j}/<leaf>`` for the remainder layers (recurrentgemma's 26 = 8 x 3
+ 2). Where the reference runs the periods under ``lax.scan``, the port
loops over the stacked axis in Python. Caches follow the same tree; layer
``(period, i)``'s cache is the view ``[period]`` of ``blocks/p{i}``, which
the blocks update in place.

Ported block kinds: global, sliding-window and chunked attention, and
RG-LRU. MoE, encoder-decoder, vision-prefix and xLSTM models raise.

Public API (same names and arguments as the reference, plus ``device``):
  param_specs(cfg), init_model_params(cfg, seed, device)
  cache_specs(cfg, batch, seq_len), init_cache(cfg, batch, seq_len, device)
  paged_cache_specs(...), init_paged_cache(...), paged_leaf_flags(cfg, cache)
  chunked_prefill_supported(cfg)
  forward(cfg, params, batch, mode=...), prefill, decode_step, prefill_chunk
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import BlockKind, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.layers import embed, embed_specs, rms_norm, rope_tables, unembed
from repro_torch.models.param import Spec, init_params, iter_leaves, map_tree

PORTED_KINDS = B.ATTN_KINDS + (BlockKind.RGLRU,)


# ----------------------------------------------------------------------
# Spec assembly
# ----------------------------------------------------------------------
def _stack(specs, n: int):
    return map_tree(lambda _, s: Spec((n,) + s.shape, init=s.init,
                                      scale=s.scale, dtype=s.dtype), specs)


def _check_supported(cfg: ModelConfig) -> None:
    bad = [k.value for k in cfg.pattern if k not in PORTED_KINDS]
    if bad or cfg.is_encdec or cfg.n_experts or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: not ported (block kinds {bad or 'ok'}, encoder "
            f"{cfg.is_encdec}, experts {cfg.n_experts}, patches "
            f"{cfg.n_patches}); the port serves attention and RG-LRU "
            "decoders without MoE, encoder or vision prefix")


def _layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_periods, n_remainder)."""
    P = len(cfg.pattern)
    return cfg.n_layers // P, cfg.n_layers % P


def _rem_kind(cfg: ModelConfig, j: int) -> BlockKind:
    return cfg.pattern[j % len(cfg.pattern)]


def _block_specs(cfg: ModelConfig, kind: BlockKind):
    return B.rglru_specs(cfg) if kind == BlockKind.RGLRU else B.attn_specs(cfg)


def _block_cache_specs(cfg: ModelConfig, kind: BlockKind, batch: int,
                       seq_len: int):
    if kind == BlockKind.RGLRU:
        return B.rglru_cache_specs(cfg, batch)
    return B.attn_cache_specs(cfg, kind, batch, seq_len)


def _tree(cfg: ModelConfig, block_fn) -> Dict[str, Any]:
    """``blocks/p{i}`` (stacked over periods) and ``rem/r{j}`` subtrees of
    ``block_fn(kind)``."""
    _check_supported(cfg)
    n_periods, rem = _layout(cfg)
    tree: Dict[str, Any] = {}
    if n_periods:
        tree["blocks"] = {f"p{i}": _stack(block_fn(kind), n_periods)
                          for i, kind in enumerate(cfg.pattern)}
    if rem:
        tree["rem"] = {f"r{j}": block_fn(_rem_kind(cfg, j)) for j in range(rem)}
    return tree


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs = _tree(cfg, lambda kind: _block_specs(cfg, kind))
    specs["embed"] = embed_specs(cfg.padded_vocab, cfg.d_model,
                                 cfg.tie_embeddings)
    specs["final_ln"] = Spec((cfg.d_model,), init="zeros")
    return specs


def init_model_params(cfg: ModelConfig, seed: int = 0,
                      device: DeviceLike = None):
    """Random weights at the config's widths, from ``seed``, on ``device``
    (default: the card)."""
    return init_params(param_specs(cfg), seed, cfg.dtype,
                       resolve_device(device))


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, Any]:
    """Dense per-slot decode caches: global K/V of ``seq_len`` slots, ring
    K/V of ``min(window or chunk, seq_len)``, RG-LRU state."""
    return _tree(cfg, lambda kind: _block_cache_specs(cfg, kind, batch,
                                                      seq_len))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None):
    return init_params(cache_specs(cfg, batch, seq_len), 0, cfg.dtype,
                       resolve_device(device))


# ----------------------------------------------------------------------
# Paged KV cache (serving): global-attention K/V live in a shared pool of
# (num_pages, page_size) token pages indexed through block tables; every
# other leaf (ring caches, recurrent state) stays per-slot, being O(1) or
# O(window) per sequence already
# ----------------------------------------------------------------------
def paged_cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                      num_pages: int, page_size: int) -> Dict[str, Any]:
    """Like :func:`cache_specs`, with global-attention k/v replaced by
    pooled pages (each stacked layer owns its pool on the leading axis,
    addressed by the same block table)."""
    pool = Spec((num_pages, page_size, cfg.n_kv_heads, cfg.hd), init="zeros")

    def bcs(kind):
        if kind == BlockKind.ATTN:
            return {"k": pool, "v": pool}
        return _block_cache_specs(cfg, kind, batch, seq_len)
    return _tree(cfg, bcs)


def init_paged_cache(cfg: ModelConfig, batch: int, seq_len: int,
                     num_pages: int, page_size: int,
                     device: DeviceLike = None):
    return init_params(paged_cache_specs(cfg, batch, seq_len, num_pages,
                                         page_size),
                       0, cfg.dtype, resolve_device(device))


def _leaf_kind(cfg: ModelConfig, path: str) -> BlockKind:
    keys = path.split("/")
    j = int(keys[1][1:])
    return cfg.pattern[j] if keys[0] == "blocks" else _rem_kind(cfg, j)


def paged_leaf_flags(cfg: ModelConfig, cache) -> list:
    """Per-leaf booleans (``iter_leaves`` order): True for pooled
    global-attention k/v leaves, False for per-slot leaves."""
    return [path.split("/")[-1] in ("k", "v")
            and _leaf_kind(cfg, path) == BlockKind.ATTN
            for path, _ in iter_leaves(cache)]


def slot_batch_axis(path: str) -> int:
    """Per-slot cache leaves under ``blocks/`` are (n_periods, B, ...);
    under ``rem/`` (B, ...)."""
    return 1 if path.split("/")[0] == "blocks" else 0


def chunked_prefill_supported(cfg: ModelConfig) -> bool:
    """Chunked prefill needs every block to carry O(1) state between
    chunks: global attention (paged pool + explicit-position attention)
    and RG-LRU (state continuation). Ring caches prefill whole."""
    ok = {BlockKind.ATTN, BlockKind.RGLRU}
    return not cfg.is_encdec and all(k in ok for k in cfg.pattern)


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def _layers(cfg: ModelConfig, params, cache
            ) -> Iterator[Tuple[str, BlockKind, dict, Optional[dict]]]:
    """(subtree key, kind, layer params, layer cache view) in layer order."""
    n_periods, rem = _layout(cfg)
    for pi in range(n_periods):
        for i, kind in enumerate(cfg.pattern):
            key = f"p{i}"
            p = {k: v[pi] for k, v in params["blocks"][key].items()}
            c = {k: v[pi] for k, v in cache["blocks"][key].items()} \
                if cache is not None else None
            yield "blocks/" + key, kind, p, c
    for j in range(rem):
        key = f"r{j}"
        c = cache["rem"][key] if cache is not None else None
        yield "rem/" + key, _rem_kind(cfg, j), params["rem"][key], c


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            mode: str, cache=None, pos=None,
            cache_len: Optional[int] = None, impl: Optional[str] = None,
            block_tables: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None):
    """Returns (logits, cache).

    ``batch``: tokens (B, S); decode mode: tokens (B, 1) + ``pos`` (B,).
    ``prefill`` returns a new dense cache (:func:`cache_specs` with
    ``seq_len = cache_len``, default S). ``chunk``: one prefill chunk at
    positions ``pos + [0, C)`` (``pos`` an int) against ``cache``;
    ``decode``: one token per sequence. Both update ``cache`` in place and
    return it. ``block_tables`` (B, P): page ids when global-attention K/V
    are paged pools. ``mask`` (B,) bool, decode only: rows where it is False
    leave their per-slot cache leaves unchanged.
    """
    _check_supported(cfg)
    if mode not in ("prefill", "chunk", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "prefill" and cache is None:
        raise ValueError(f"{mode} mode needs a cache")
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, cfg.d_model)
    S = tokens.shape[1]
    if mode == "decode":
        positions = pos[:, None]
    else:
        start = int(pos) if mode == "chunk" else 0
        positions = (start + torch.arange(S, device=tokens.device))[None, :]
    rope_cs = rope_tables(positions, cfg.hd, cfg.rope_theta)
    new: Dict[str, list] = {}
    for key, kind, p, c in _layers(cfg, params, cache if mode != "prefill" else None):
        if kind == BlockKind.RGLRU:
            x, nc = B.rglru_block(cfg, p, x, mode=mode, cache=c, impl=impl,
                                  mask=mask)
        else:
            x, nc = B.attn_block(cfg, kind, p, x, mode=mode, cache=c, pos=pos,
                                 cache_len=cache_len, impl=impl,
                                 block_tables=block_tables, rope_cs=rope_cs,
                                 mask=mask)
        new.setdefault(key, []).append(nc)
    x = rms_norm(x, params["final_ln"])
    if mode in ("prefill", "chunk"):
        # serving only needs the next-token distribution
        x = x[:, -1:]
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    if mode != "prefill":
        return logits, cache
    out: Dict[str, Any] = {}
    for key, caches in new.items():
        top, sub = key.split("/")
        leaves = caches[0] if top == "rem" else {
            name: torch.stack([c[name] for c in caches]) for name in caches[0]}
        out.setdefault(top, {})[sub] = leaves
    return logits, out


def prefill(cfg: ModelConfig, params, batch, *, cache_len=None, impl=None):
    """Run the prompt; returns (last-position logits, dense cache)."""
    logits, cache = forward(cfg, params, batch, mode="prefill",
                            cache_len=cache_len, impl=impl)
    return logits[:, -1:], cache


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: torch.Tensor, *, impl=None,
                block_tables: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
    """One token per sequence against the cache (paged when
    ``block_tables`` is given, else dense per-slot). Returns (logits,
    cache); the cache is updated in place."""
    return forward(cfg, params, {"tokens": tokens}, mode="decode",
                   cache=cache, pos=pos, impl=impl, block_tables=block_tables,
                   mask=mask)


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
