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

Ported block kinds: global, sliding-window and chunked attention (with a
dense or MoE feed-forward), and RG-LRU; and the encoder-decoder (whisper):
an ``encoder`` subtree (``blocks`` stacked over ``n_encoder_layers``,
``final_ln``) runs bidirectional attention over the stub frame embeddings
``batch["frames"]`` (B, F, d) in ``train`` and ``prefill``, and every
decoder block cross-attends to its output (cross K/V cached per slot as
``c_k``, ``c_v``, read back in ``decode``). Vision-prefix and xLSTM models
raise.

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
    if bad or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: not ported (block kinds {bad or 'ok'}, patches "
            f"{cfg.n_patches}); the port runs attention (dense or MoE FFN) "
            "and RG-LRU stacks, with or without an encoder, and no vision "
            "prefix")
    assert cfg.moe_every in (0, 1), "stacked periods require uniform MoE placement"


def _layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_periods, n_remainder)."""
    P = len(cfg.pattern)
    return cfg.n_layers // P, cfg.n_layers % P


def _rem_kind(cfg: ModelConfig, j: int) -> BlockKind:
    return cfg.pattern[j % len(cfg.pattern)]


def _block_specs(cfg: ModelConfig, kind: BlockKind):
    if kind == BlockKind.RGLRU:
        return B.rglru_specs(cfg)
    return B.attn_specs(cfg, cross=cfg.is_encdec)


def _block_cache_specs(cfg: ModelConfig, kind: BlockKind, batch: int,
                       seq_len: int):
    if kind == BlockKind.RGLRU:
        return B.rglru_cache_specs(cfg, batch)
    return B.attn_cache_specs(cfg, kind, batch, seq_len, cross=cfg.is_encdec)


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
    if cfg.is_encdec:
        specs["encoder"] = {
            "blocks": _stack(B.attn_specs(cfg), cfg.n_encoder_layers),
            "final_ln": Spec((cfg.d_model,), init="zeros"),
        }
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
        specs = _block_cache_specs(cfg, kind, batch, seq_len)
        if kind == BlockKind.ATTN:
            specs.update(k=pool, v=pool)
        return specs
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
    and RG-LRU (state continuation). Ring caches and an encoder-decoder's
    cross attention prefill whole."""
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


def _encode(cfg: ModelConfig, params, frames: torch.Tensor,
            impl: Optional[str]) -> torch.Tensor:
    """The whisper encoder (the reference's ``_encode``): bidirectional
    attention blocks over the stub frame embeddings (B, F, d), rope over
    the frame positions, then ``rms_norm``."""
    enc = params["encoder"]
    F_ = frames.shape[1]
    rope_cs = rope_tables(torch.arange(F_, device=frames.device)[None, :],
                          cfg.hd, cfg.rope_theta)
    x = frames
    for i in range(cfg.n_encoder_layers):
        p = {k: v[i] for k, v in enc["blocks"].items()}
        x, _ = B.attn_block(cfg, BlockKind.ATTN, p, x, mode="train",
                            causal=False, rope_cs=rope_cs, impl=impl)
    return rms_norm(x, enc["final_ln"])


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            mode: str, cache=None, pos=None,
            cache_len: Optional[int] = None, impl: Optional[str] = None,
            block_tables: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None):
    """Returns (logits, cache).

    ``batch``: tokens (B, S), and for an encoder-decoder in ``train`` and
    ``prefill`` ``frames`` (B, F, d); decode mode: tokens (B, 1) + ``pos``
    (B,). ``train`` returns the logits of every position and no cache.
    ``prefill`` returns a new dense cache (:func:`cache_specs` with
    ``seq_len = cache_len``, default S). ``chunk``: one prefill chunk at
    positions ``pos + [0, C)`` (``pos`` an int) against ``cache``;
    ``decode``: one token per sequence. Both update ``cache`` in place and
    return it. ``block_tables`` (B, P): page ids when global-attention K/V
    are paged pools. ``mask`` (B,) bool, decode only: rows where it is False
    leave their per-slot cache leaves unchanged.
    """
    _check_supported(cfg)
    if mode not in ("train", "prefill", "chunk", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode in ("chunk", "decode") and cache is None:
        raise ValueError(f"{mode} mode needs a cache")
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, cfg.d_model)
    cross_x = None
    if cfg.is_encdec and mode != "decode":
        if mode == "chunk":
            raise NotImplementedError(
                "chunked prefill: an encoder-decoder prefills whole "
                "(see chunked_prefill_supported)")
        # decode reads the cross K/V from the cache; no encoder rerun
        cross_x = _encode(cfg, params, batch["frames"].to(x.dtype), impl)
    S = tokens.shape[1]
    if mode == "decode":
        positions = pos[:, None]
    else:
        start = int(pos) if mode == "chunk" else 0
        positions = (start + torch.arange(S, device=tokens.device))[None, :]
    rope_cs = rope_tables(positions, cfg.hd, cfg.rope_theta)
    new: Dict[str, list] = {}
    fresh = mode in ("train", "prefill")
    for key, kind, p, c in _layers(cfg, params, None if fresh else cache):
        if kind == BlockKind.RGLRU:
            x, nc = B.rglru_block(cfg, p, x, mode=mode, cache=c, impl=impl,
                                  mask=mask)
        else:
            x, nc = B.attn_block(cfg, kind, p, x, mode=mode, cache=c, pos=pos,
                                 cross_x=cross_x, cache_len=cache_len,
                                 impl=impl, block_tables=block_tables,
                                 rope_cs=rope_cs, mask=mask)
        new.setdefault(key, []).append(nc)
    x = rms_norm(x, params["final_ln"])
    if mode in ("prefill", "chunk"):
        # serving only needs the next-token distribution
        x = x[:, -1:]
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    if mode == "train":
        return logits, None
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
