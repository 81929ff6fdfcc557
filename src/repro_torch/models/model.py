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

Every block kind of the reference is ported: global, sliding-window and
chunked attention (with a dense or MoE feed-forward), RG-LRU, and the
xLSTM's mLSTM and sLSTM. So are the encoder-decoder (whisper): an
``encoder`` subtree (``blocks`` stacked over ``n_encoder_layers``,
``final_ln``) runs bidirectional attention over the stub frame embeddings
``batch["frames"]`` (B, F, d) in ``train`` and ``prefill``, and every
decoder block cross-attends to its output (cross K/V cached per slot as
``c_k``, ``c_v``, read back in ``decode``); and the VLM's patch prefix:
``batch["patches"]`` (B, n_patches, d), stub patch embeddings, go before
the token embeddings in ``train``, ``prefill`` and ``chunk``, take the
first positions (the tokens' rope positions start after them), and are
stripped again before the unembedding, so the logits are the tokens'.

Training (``mode="train"``) differs from the serving modes in three ways:
each stacked leaf is unbound once per forward (one ``unbind(0)``, whose
backward stacks the per-layer gradients once, where slicing ``[pi]`` per
layer would write a zero tensor of the whole stack per layer); ``remat``
recomputes each period in the backward
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` around a
period, the counterpart of the reference's ``jax.checkpoint`` of its scan
body; remainder layers run outside it), and with ``remat_policy="dots"``
saves the outputs of matrix products without batch dimensions
(``aten.mm`` / ``addmm``: the projections and the router) and recomputes
the rest, the reference's ``dots_with_no_batch_dims_saveable``; and the
MoE layers' aux loss is summed in layer order for ``loss_fn``.

The int8 configurations of the reference are served too. Integer weight
leaves (``narrow_weights`` makes them from a tree) are upcast at their use,
a layer at a time (``layers.dequantize``, in ``_apply_block``, ``embed``,
``unembed``, the final norm and the encoder), as the reference's forward
computes them, so no bf16 copy of the whole tree is ever held; training
refuses them. ``kv_dtype`` narrows the attention K/V leaves of a cache
(global pools, dense caches and rings), as the reference's ``cache_specs``
and ``paged_cache_specs`` do; it is a model-API configuration, and the
engine takes none, as the reference's.

Public API (same names and arguments as the reference, plus ``device``):
  param_specs(cfg), init_model_params(cfg, seed, device), narrow_weights
  cache_specs(cfg, batch, seq_len, kv_dtype),
  init_cache(cfg, batch, seq_len, device, kv_dtype)
  paged_cache_specs(...), init_paged_cache(...), paged_leaf_flags(cfg, cache)
  chunked_prefill_supported(cfg)
  forward(cfg, params, batch, mode=...), prefill, decode_step, prefill_chunk
  loss_fn(cfg, params, batch, impl=..., remat=...)
``forward`` keeps its serving signature, (logits, cache) with no cache in
``train``; the reference's third value, the aux loss, is what ``loss_fn``
reads through ``forward_with_aux``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import BlockKind, Family, ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import blocks as B
from repro_torch.models.layers import (WEIGHT_STEP, cross_entropy, dequantize,
                                       embed, embed_specs, rms_norm,
                                       rope_tables, unembed)
from repro_torch.models.param import Spec, init_params, iter_leaves, map_tree

AUX_LOSS_WEIGHT = 0.01
REMAT_POLICIES = (None, "dots")

# ----------------------------------------------------------------------
# Spec assembly
# ----------------------------------------------------------------------
def _stack(specs, n: int):
    return map_tree(lambda _, s: Spec((n,) + s.shape, init=s.init,
                                      scale=s.scale, dtype=s.dtype), specs)


def _check_supported(cfg: ModelConfig) -> None:
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
    if kind == BlockKind.MLSTM:
        return B.mlstm_specs(cfg)
    if kind == BlockKind.SLSTM:
        return B.slstm_specs(cfg)
    return B.attn_specs(cfg, cross=cfg.is_encdec)


def _block_cache_specs(cfg: ModelConfig, kind: BlockKind, batch: int,
                       seq_len: int):
    if kind == BlockKind.RGLRU:
        return B.rglru_cache_specs(cfg, batch)
    if kind == BlockKind.MLSTM:
        return B.mlstm_cache_specs(cfg, batch)
    if kind == BlockKind.SLSTM:
        return B.slstm_cache_specs(cfg, batch)
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


def narrow_weights(params, dtype: str = "int8"):
    """Integer weights from a floating tree: the concrete form of the
    reference's ``_quantize_abstract`` (``launch/dryrun.py:175-180``).
    Every leaf with 2 or more dimensions of the tree as laid out (so the
    per-period norms stacked on their periods too, as in the reference's
    abstract tree) becomes ``dtype`` holding ``clamp(round(w / 0.01), -127,
    127)``; 1-d leaves stay. For the tests and the chip smoke: weights
    drawn from a seed, narrowed; the forward upcasts them at use."""
    dt = torch_dtype(dtype)

    def narrow(_, w: torch.Tensor) -> torch.Tensor:
        if w.dim() < 2:
            return w
        return torch.round(w.float() / WEIGHT_STEP).clamp_(-127, 127).to(dt)
    return map_tree(narrow, params)


def _narrow_kv(specs: Dict[str, Spec], kv_dtype: Optional[str]):
    """The attention ``k``, ``v`` leaves of one block's cache specs in
    ``kv_dtype`` (the reference's rule; cross K/V and state stay)."""
    if not kv_dtype:
        return specs
    return {k: dataclasses.replace(v, dtype=kv_dtype) if k in ("k", "v")
            else v for k, v in specs.items()}


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                kv_dtype: Optional[str] = None) -> Dict[str, Any]:
    """Dense per-slot decode caches: global K/V of ``seq_len`` slots, ring
    K/V of ``min(window or chunk, seq_len)``, RG-LRU and xLSTM state.
    ``kv_dtype`` (e.g. "int8"): the attention K/V leaves' dtype."""
    return _tree(cfg, lambda kind: _narrow_kv(
        _block_cache_specs(cfg, kind, batch, seq_len), kv_dtype))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None, kv_dtype: Optional[str] = None):
    return init_params(cache_specs(cfg, batch, seq_len, kv_dtype), 0,
                       cfg.dtype, resolve_device(device))


# ----------------------------------------------------------------------
# Paged KV cache (serving): global-attention K/V live in a shared pool of
# (num_pages, page_size) token pages indexed through block tables; every
# other leaf (ring caches, recurrent state) stays per-slot, being O(1) or
# O(window) per sequence already
# ----------------------------------------------------------------------
def paged_cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                      num_pages: int, page_size: int,
                      kv_dtype: Optional[str] = None) -> Dict[str, Any]:
    """Like :func:`cache_specs`, with global-attention k/v replaced by
    pooled pages (each stacked layer owns its pool on the leading axis,
    addressed by the same block table); ``kv_dtype`` narrows the pools and
    the per-slot rings alike."""
    pool = Spec((num_pages, page_size, cfg.n_kv_heads, cfg.hd), init="zeros")

    def bcs(kind):
        specs = _block_cache_specs(cfg, kind, batch, seq_len)
        if kind == BlockKind.ATTN:
            specs.update(k=pool, v=pool)
        return _narrow_kv(specs, kv_dtype)
    return _tree(cfg, bcs)


def init_paged_cache(cfg: ModelConfig, batch: int, seq_len: int,
                     num_pages: int, page_size: int,
                     device: DeviceLike = None,
                     kv_dtype: Optional[str] = None):
    return init_params(paged_cache_specs(cfg, batch, seq_len, num_pages,
                                         page_size, kv_dtype),
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
    and the recurrent kinds, RG-LRU, mLSTM and sLSTM (state continuation).
    Ring caches and an encoder-decoder's cross attention prefill whole."""
    ok = {BlockKind.ATTN, BlockKind.RGLRU, BlockKind.MLSTM, BlockKind.SLSTM}
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
    wdt = torch_dtype(cfg.dtype)
    layers = {k: v.unbind(0) for k, v in enc["blocks"].items()}
    for i in range(cfg.n_encoder_layers):
        p = {k: dequantize(v[i], wdt) for k, v in layers.items()}
        x, _, _ = B.attn_block(cfg, BlockKind.ATTN, p, x, mode="train",
                               causal=False, rope_cs=rope_cs, impl=impl)
    return rms_norm(x, dequantize(enc["final_ln"], wdt))


def _add(aux: Optional[torch.Tensor], a: Optional[torch.Tensor]):
    """aux + a, where None is a zero (dense layers have no aux)."""
    if a is None:
        return aux
    return a if aux is None else aux + a


def _apply_block(cfg: ModelConfig, kind: BlockKind, p, x: torch.Tensor, *,
                 mode: str, cache=None, pos=None, cross_x=None, cache_len=None,
                 impl=None, block_tables=None, rope_cs=None, mask=None):
    """One layer of any kind: (x, cache, aux or None), as the reference's
    ``_apply_block``. Integer weight leaves are dequantized here, for this
    layer alone; the copies die with the call."""
    wdt = torch_dtype(cfg.dtype)
    p = {k: dequantize(v, wdt) for k, v in p.items()}
    if kind == BlockKind.RGLRU:
        return B.rglru_block(cfg, p, x, mode=mode, cache=cache, impl=impl,
                             mask=mask)
    if kind == BlockKind.MLSTM:
        return (*B.mlstm_block(cfg, p, x, mode=mode, cache=cache, mask=mask),
                None)
    if kind == BlockKind.SLSTM:
        return (*B.slstm_block(cfg, p, x, mode=mode, cache=cache, mask=mask),
                None)
    return B.attn_block(cfg, kind, p, x, mode=mode, cache=cache, pos=pos,
                        cross_x=cross_x, cache_len=cache_len, impl=impl,
                        block_tables=block_tables, rope_cs=rope_cs, mask=mask)


# the matrix products without batch dimensions: what "dots" saves
_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` policy of selective checkpointing: keep the outputs of
    products without batch dimensions (a projection ``x @ w`` reaches
    ``aten.mm``), recompute everything else (batched products, the kernels'
    outputs, norms and elementwise work), as the reference's
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, which
    saves neither batched dots nor ``ragged_dot``."""
    if op.overloadpacket in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _train_layers(cfg: ModelConfig, params, x: torch.Tensor, rope_cs,
                  cross_x, impl, remat: bool, remat_policy: Optional[str]):
    """The layer stack in ``train`` mode: (x, summed aux or None). Each
    stacked leaf is unbound once; with ``remat`` each period runs under a
    non-reentrant checkpoint (its activations recomputed in the backward;
    under ``remat_policy="dots"`` the matrix products' outputs kept), the
    remainder layers outside it."""
    n_periods, rem = _layout(cfg)
    aux = None
    ckpt = dict(use_reentrant=False)
    if remat_policy == "dots":
        ckpt["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def block(kind, p, x):
        return _apply_block(cfg, kind, p, x, mode="train", cross_x=cross_x,
                            impl=impl, rope_cs=rope_cs)

    def period(x, pp):
        a_sum = None
        for i, kind in enumerate(cfg.pattern):
            x, _, a = block(kind, pp[f"p{i}"], x)
            a_sum = _add(a_sum, a)
        return x, a_sum

    if n_periods:
        layers = {key: {name: leaf.unbind(0) for name, leaf in sub.items()}
                  for key, sub in params["blocks"].items()}
        for pi in range(n_periods):
            pp = {key: {name: ts[pi] for name, ts in sub.items()}
                  for key, sub in layers.items()}
            if remat:
                x, a = checkpoint(period, x, pp, **ckpt)
            else:
                x, a = period(x, pp)
            aux = _add(aux, a)
    for j in range(rem):
        x, _, a = block(_rem_kind(cfg, j), params["rem"][f"r{j}"], x)
        aux = _add(aux, a)
    return x, aux


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            mode: str, cache=None, pos=None,
            cache_len: Optional[int] = None, impl: Optional[str] = None,
            block_tables: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None):
    """Returns (logits, cache): ``forward_with_aux`` without its aux."""
    logits, cache, _ = forward_with_aux(
        cfg, params, batch, mode=mode, cache=cache, pos=pos,
        cache_len=cache_len, impl=impl, block_tables=block_tables, mask=mask)
    return logits, cache


def forward_with_aux(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                     *, mode: str, cache=None, pos=None,
                     cache_len: Optional[int] = None,
                     impl: Optional[str] = None,
                     block_tables: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None, remat: bool = False,
                     remat_policy: Optional[str] = None):
    """Returns (logits, cache, aux), as the reference's ``forward``: aux is
    the MoE layers' load-balancing loss summed in layer order (float32,
    0-d) in ``train`` mode, None without MoE layers or in serving modes.

    ``batch``: tokens (B, S), and for an encoder-decoder in ``train`` and
    ``prefill`` ``frames`` (B, F, d); for a VLM, optionally ``patches``
    (B, P, d) before the tokens (not in ``decode``), at positions [0, P),
    the tokens at [P, P + S); decode mode: tokens (B, 1) + ``pos`` (B,).
    ``train`` returns the logits of every token position and no cache.
    ``prefill`` returns a new dense cache (:func:`cache_specs` with
    ``seq_len = cache_len``, default P + S). ``chunk``: one prefill chunk at
    positions ``pos + [0, C)`` (``pos`` an int or a 0-d int tensor on the
    card, which reads nothing on the host) against ``cache``;
    ``decode``: one token per sequence. Both update ``cache`` in place and
    return it. ``block_tables`` (B, P): page ids when global-attention K/V
    are paged pools. ``mask`` (B,) bool, decode only: rows where it is False
    leave their per-slot cache leaves unchanged. ``remat`` (``train``
    only): recompute each period's activations in the backward;
    ``remat_policy="dots"`` (with ``remat``) keeps the outputs of the
    matrix products without batch dimensions and recomputes the rest; any
    other policy but None raises ``ValueError``.
    """
    _check_supported(cfg)
    if mode not in ("train", "prefill", "chunk", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    if mode in ("chunk", "decode") and cache is None:
        raise ValueError(f"{mode} mode needs a cache")
    if mode == "train" and any(not t.is_floating_point()
                               for _, t in iter_leaves(params)):
        raise TypeError(
            "train mode takes floating weights: integer (narrowed) weights "
            "are served only, as jax.grad cannot differentiate them either")
    wdt = torch_dtype(cfg.dtype)
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, cfg.d_model, wdt)
    n_patches = 0
    if cfg.family == Family.VLM and mode != "decode" and "patches" in batch:
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        n_patches = patches.shape[1]
    cross_x = None
    if cfg.is_encdec and mode != "decode":
        if mode == "chunk":
            raise NotImplementedError(
                "chunked prefill: an encoder-decoder prefills whole "
                "(see chunked_prefill_supported)")
        # decode reads the cross K/V from the cache; no encoder rerun
        cross_x = _encode(cfg, params, batch["frames"].to(x.dtype), impl)
    S = x.shape[1]          # the patch prefix takes the first positions
    if mode == "decode":
        positions = pos[:, None]
    elif mode == "chunk":
        # the chunk start stays on the card, as the reference's traced
        # ``pos``: one captured chunk step serves every start
        pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
        positions = (pos + torch.arange(S, device=tokens.device))[None, :]
    else:
        positions = torch.arange(S, device=tokens.device)[None, :]
    rope_cs = rope_tables(positions, cfg.hd, cfg.rope_theta)
    new: Dict[str, list] = {}
    aux = None
    if mode == "train":
        x, aux = _train_layers(cfg, params, x, rope_cs, cross_x, impl, remat,
                               remat_policy)
    else:
        for key, kind, p, c in _layers(cfg, params,
                                       None if mode == "prefill" else cache):
            x, nc, _ = _apply_block(cfg, kind, p, x, mode=mode, cache=c,
                                    pos=pos, cross_x=cross_x,
                                    cache_len=cache_len, impl=impl,
                                    block_tables=block_tables,
                                    rope_cs=rope_cs, mask=mask)
            new.setdefault(key, []).append(nc)
    x = rms_norm(x, dequantize(params["final_ln"], wdt))
    if n_patches:
        x = x[:, n_patches:]
    if mode in ("prefill", "chunk"):
        # serving only needs the next-token distribution
        x = x[:, -1:]
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    if mode == "train":
        return logits, None, aux
    if mode != "prefill":
        return logits, cache, None
    out: Dict[str, Any] = {}
    for key, caches in new.items():
        top, sub = key.split("/")
        leaves = caches[0] if top == "rem" else {
            name: torch.stack([c[name] for c in caches]) for name in caches[0]}
        out.setdefault(top, {})[sub] = leaves
    return logits, out, None


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
                  pos, block_tables: Optional[torch.Tensor], *,
                  impl=None):
    """Advance an in-flight prompt by one chunk at positions
    ``pos + [0, C)`` (``pos`` an int, or a 0-d int tensor on the tokens'
    device). Returns (last-position logits, cache); the logits only mean
    "next token" once the final chunk has run."""
    logits, cache = forward(cfg, params, {"tokens": tokens}, mode="chunk",
                            cache=cache, pos=pos, impl=impl,
                            block_tables=block_tables)
    return logits[:, -1:], cache


def loss_fn(cfg: ModelConfig, params, batch, *, impl=None, remat=False,
            remat_policy=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["labels"]`` plus
    ``AUX_LOSS_WEIGHT`` times the MoE aux loss (the reference's
    ``loss_fn``), a float32 scalar."""
    logits, _, aux = forward_with_aux(cfg, params, batch, mode="train",
                                      impl=impl, remat=remat,
                                      remat_policy=remat_policy)
    loss = cross_entropy(logits, batch["labels"])
    return loss if aux is None else loss + AUX_LOSS_WEIGHT * aux
