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

Under ``sharding.axis_rules`` with a mesh of more than one rank,
``train`` mode runs sharded (``_sharded_forward``), for every block kind:
the embedding into a vocab-sharded table (a VLM's patches, placed over
the batch's axes, before it), the whisper encoder, each layer and the
final norm with the unembedding run as ``local_map`` bodies on local
shards (``blocks.sharded_block``), the logits stay sharded over the
vocab, and ``loss_fn`` reduces the log-sum-exp across the vocab shards in
float32 (``sharded_cross_entropy``). ``prefill`` and ``decode`` run
sharded too (``_sharded_serve``, with no autograd): the dense decode
cache is a tree of DTensors in the reference's placements
(``sharding.cache_placements``: attention K/V split over their sequence
where ``model`` divides it, else over their KV heads, else whole; the
cross K/V over their KV heads or whole; recurrent state over the batch),
built a layer at a time by prefill and written in place by decode; the
logits come back as a DTensor (B, 1, V) sharded over the batch's axes and
the vocab's. Integer (int8) weights are served under a mesh too: the
leaves keep their placements and move as int8, and each ``local_map``
body dequantizes its local shards; so are int8 K/V caches (every write
saturates, ``layers.saturate_cast``), in each of the three placements.
Under the no_tp rules (the batch on every axis) a MoE layer gathers a
data shard's rows over ``model`` and takes the reference's Megatron or
all-to-all branch (``blocks.layout``), and the embedding and the
unembedding keep the vocab sliced over ``model`` the same way
(``_vocab_rows``; the logits then hold a data shard's rows). Under a
mesh, ``chunk`` mode,
paged pools and the engine's row masks raise ``NotImplementedError``
(``_check_sharded``), and training with int8 weights raises
``TypeError``, as on one card.

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
from repro_torch.models import sharding
from repro_torch.models.layers import (WEIGHT_STEP, cross_entropy, dequantize,
                                       embed, embed_specs, rms_norm,
                                       rope_tables, unembed)
from repro_torch.models.param import Spec, init_params, iter_leaves, map_tree
from repro_torch.models.sharding import constrain

AUX_LOSS_WEIGHT = 0.01
REMAT_POLICIES = (None, "dots")

# ----------------------------------------------------------------------
# Spec assembly
# ----------------------------------------------------------------------
def _stack(specs, n: int):
    return map_tree(lambda _, s: Spec((n,) + s.shape, ("layers",) + s.axes,
                                      init=s.init, scale=s.scale,
                                      dtype=s.dtype), specs)


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
    specs["final_ln"] = Spec((cfg.d_model,), (None,), init="zeros")
    if cfg.is_encdec:
        specs["encoder"] = {
            "blocks": _stack(B.attn_specs(cfg), cfg.n_encoder_layers),
            "final_ln": Spec((cfg.d_model,), (None,), init="zeros"),
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
    pool = Spec((num_pages, page_size, cfg.n_kv_heads, cfg.hd),
                (None, None, "kv", None), init="zeros")

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


def _train_layers(cfg: ModelConfig, params, x: torch.Tensor, block,
                  remat: bool, remat_policy: Optional[str]):
    """The layer stack in ``train`` mode: (x, summed aux or None), each
    layer ``block(kind, layer params, x) -> (x, _, aux)``. Each stacked
    leaf is unbound once; with ``remat`` each period runs under a
    non-reentrant checkpoint (its activations recomputed in the backward;
    under ``remat_policy="dots"`` the matrix products' outputs kept), the
    remainder layers outside it. Each period's input and output are
    constrained to (batch, seq, embed), as the reference's scan body."""
    n_periods, rem = _layout(cfg)
    aux = None
    ckpt = dict(use_reentrant=False)
    if remat_policy == "dots":
        ckpt["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def period(x, pp):
        x = constrain(x, "batch", "seq", "embed")
        a_sum = None
        for i, kind in enumerate(cfg.pattern):
            x, _, a = block(kind, pp[f"p{i}"], x)
            a_sum = _add(a_sum, a)
        return constrain(x, "batch", "seq", "embed"), a_sum

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
    ctx = sharding.active_mesh()
    if ctx is not None:     # its refusals first
        return _sharded_forward(cfg, params, batch, ctx, mode=mode, impl=impl,
                                remat=remat, remat_policy=remat_policy,
                                cache=cache, pos=pos, cache_len=cache_len,
                                block_tables=block_tables, mask=mask)
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
        def block(kind, p, x):
            return _apply_block(cfg, kind, p, x, mode="train", cross_x=cross_x,
                                impl=impl, rope_cs=rope_cs)
        x, aux = _train_layers(cfg, params, x, block, remat, remat_policy)
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


# ----------------------------------------------------------------------
# Under a mesh of more than one rank (``sharding.axis_rules``): training,
# prefill and decode of every family, int8 weights and caches in serving,
# each piece one local_map body
# ----------------------------------------------------------------------
def _check_sharded(mode: str, block_tables=None, mask=None) -> None:
    """Raise for what the sharded path does not run, never running it
    unsharded in silence: ``chunk`` mode and the engine's paged pools and
    row masks (the reference serves those on one device too). Training
    with integer (int8) weights raises ``TypeError`` before, as on one
    card; int8 weights and caches are served."""
    if mode == "chunk" or block_tables is not None or mask is not None:
        what = ("chunk mode" if mode == "chunk" else
                "a paged pool (block_tables)" if block_tables is not None else
                "a decode row mask")
        raise NotImplementedError(
            f"{what} under a mesh of more than one rank: the engine's chunked "
            "prefill and paged pools serve on one rank, as the reference's "
            "(ROADMAP Queue 1 H)")


def _as_dtensors(params, mesh):
    """Plain leaves (a tree every rank holds whole) as replicated
    DTensors; DTensor leaves as they are."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * len(mesh.mesh_dim_names)
    return map_tree(lambda _, t: t if isinstance(t, DTensor) else
                    DTensor.from_local(t, mesh, rep, run_check=False), params)


def shard_input(t, plan: "sharding.Plan"):
    """A batch tensor every rank holds whole (or a DTensor) in the plan's
    batch placements, each rank keeping its rows (no communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(t, DTensor):
        return sharding.to_placements(t, plan.activation())
    return distribute_tensor(t, plan.mesh, plan.activation(), src_data_rank=None)


def _vocab_tp(cfg: ModelConfig, plan) -> Tuple[str, ...]:
    """The axis that slices the vocab: ``model`` where it divides the
    padded vocab, also where it carries the batch (the no_tp rules keep
    the vocab's tensor parallelism: the embedding and the unembedding then
    gather a data shard's rows over ``model``, ``_vocab_rows``)."""
    sizes = sharding.mesh_axis_sizes(plan.mesh)
    axis = plan.model or ("model" if "model" in plan.batch else None)
    if axis and cfg.padded_vocab % sizes[axis] == 0:
        return (axis,)
    return ()


def _vocab_rows(plan, vtp) -> bool:
    """Whether the vocab's axis also shards the batch (the no_tp rules):
    its ranks then gather their rows over it around the embedding and
    the unembedding."""
    return bool(vtp) and vtp[0] in plan.batch


def _vocab_placements(plan, vtp, dim: Optional[int]):
    """(compute, gradient) placements of the embedding table or the head:
    dim ``dim`` sliced over the vocab's axis (None: replicated); where that
    axis carries the batch, the gradient partial over the data axes alone
    (each vocab shard sees its data shard's gathered rows)."""
    if not _vocab_rows(plan, vtp):
        return plan.compute(dim), plan.grad(dim)
    data = tuple(a for a in plan.batch if a not in vtp)
    return (plan.compute(dim, model=vtp[0]),
            plan.grad(dim, model=vtp[0], batch=data))


def _embed_body(cfg: ModelConfig, mesh, vtp, rows: bool, tokens, tok,
                patches=None):
    """The embedding on local tensors: with the vocab sliced over ``vtp``,
    the rows of this rank's shard (zero for a token outside it; an int8
    table's rows dequantized before the sum) summed over it, times
    sqrt(d); else ``layers.embed``. ``rows``: the batch is sharded over
    ``vtp`` too, so the tokens of the data shard are gathered over it
    first and this rank keeps its own rows of the sum. A VLM's ``patches``
    (B_loc, P, d) go before the tokens."""
    wdt = torch_dtype(cfg.dtype)
    if not vtp:
        out = embed({"tok": tok}, tokens, cfg.d_model, wdt)
    else:
        if rows:
            tokens = sharding.all_gather(tokens, mesh, vtp[0], dim=0)
        V = tok.shape[0]
        local = tokens.long() - sharding.axis_index(mesh, vtp[0]) * V
        inside = (local >= 0) & (local < V)
        picked = dequantize(tok[local.clamp(0, V - 1)], wdt)
        summed = torch.where(inside[..., None], picked,
                             torch.zeros((), dtype=picked.dtype, device=tok.device))
        out = sharding.reduce_from(summed, mesh, vtp)
        out = out * float(torch.tensor(cfg.d_model ** 0.5, dtype=out.dtype))
        if rows:
            out = sharding.split(out, mesh, vtp[0], dim=0)
    if patches is None:
        return out
    return torch.cat([patches.to(out.dtype), out], dim=1)


def _unembed_body(cfg: ModelConfig, mesh, vtp, rows: bool, last: bool,
                  skip: int, x, final_ln, w):
    """The final norm and this rank's vocab shard of the float32 logits of
    the positions after the first ``skip`` (a VLM's patch prefix; with
    ``last``, of the last position only); ``rows``: of the data shard's
    rows, gathered over ``vtp`` (which also shards the batch)."""
    x = rms_norm(x, final_ln)[:, skip:]
    x = x[:, -1:] if last else x
    if rows:
        x = sharding.all_gather(x, mesh, vtp[0], dim=0)
    x = sharding.copy_to(x, mesh, vtp)
    return unembed({"tok" if cfg.tie_embeddings else "head": w}, x,
                   cfg.tie_embeddings)


def _cross_entropy_body(mesh, vtp, batch_axes, logits, labels):
    """The mean cross-entropy of local float32 logits (B_loc, S, V_loc):
    the log-sum-exp reduced across the vocab shards in float32 (the max
    over them, then the sum of exp), the gold logit from the shard that
    holds it (``layers.cross_entropy`` where the vocab is whole), the mean
    over the batch's shards."""
    if not vtp:
        return sharding.pmean(cross_entropy(logits, labels), mesh, batch_axes)
    lf = logits.float()
    V = lf.shape[-1]
    gmax = sharding.all_reduce_max(lf.max(dim=-1).values, mesh, vtp)
    sumexp = sharding.reduce_from(torch.exp(lf - gmax[..., None]).sum(-1),
                                  mesh, vtp)
    lse = torch.log(sumexp) + gmax
    local = labels.long() - sharding.axis_index(mesh, vtp[0]) * V
    inside = (local >= 0) & (local < V)
    gold = torch.gather(lf, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    gold = sharding.reduce_from(
        torch.where(inside, gold, torch.zeros((), device=lf.device)), mesh, vtp)
    return sharding.pmean((lse - gold).mean(), mesh, batch_axes)


def _sharded_embed(cfg: ModelConfig, params, batch, plan, vtp, mode: str):
    """The embedding as a ``local_map`` body: x (B, P + S, d) in the
    plan's batch placements, constrained as the reference's first site,
    with a VLM's ``batch["patches"]`` (B, P, d), placed over the batch's
    axes like the tokens, before the tokens (not in ``decode``); and P."""
    from torch.distributed.tensor.experimental import local_map
    act = plan.activation()
    extra = ()
    if cfg.family == Family.VLM and mode != "decode" and "patches" in batch:
        extra = (shard_input(batch["patches"], plan),)
    table_pl, table_grad = _vocab_placements(plan, vtp, 0 if vtp else None)
    embed_fn = local_map(
        functools.partial(_embed_body, cfg, plan.mesh, vtp, _vocab_rows(plan, vtp)),
        out_placements=act,
        in_placements=(act, table_pl) + (act,) * len(extra),
        in_grad_placements=(act, table_grad) + (act,) * len(extra),
        device_mesh=plan.mesh)
    x = embed_fn(shard_input(batch["tokens"], plan), sharding.to_placements(
        params["embed"]["tok"], table_pl), *extra)
    n_patches = extra[0].shape[1] if extra else 0
    return constrain(x, "batch", "seq", "embed"), n_patches


def _sharded_unembed(cfg: ModelConfig, params, x, plan, vtp, last: bool = False,
                     skip: int = 0):
    """The final norm and the unembedding as a ``local_map`` body (with
    ``last``, of the last position only, as the reference's serving modes;
    the first ``skip`` positions, a patch prefix, stripped on the local
    rows): logits (B, S or 1, V) sharded over the batch's axes and the
    vocab's (where the vocab's axis shards the batch too, the batch over
    the others: its ranks hold the data shard's rows), constrained as the
    reference's last site."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, act = plan.mesh, plan.activation()
    vocab_dim = 0 if cfg.tie_embeddings else 1
    table = params["embed"]["tok" if cfg.tie_embeddings else "head"]
    table_pl, table_grad = _vocab_placements(plan, vtp, vocab_dim if vtp else None)
    logits_pl = [Shard(2) if a in vtp else pl
                 for a, pl in zip(mesh.mesh_dim_names, act)]
    unembed_fn = local_map(
        functools.partial(_unembed_body, cfg, mesh, vtp, _vocab_rows(plan, vtp), last,
                          skip),
        out_placements=logits_pl,
        in_placements=(act, plan.compute(None), table_pl),
        in_grad_placements=(act, plan.grad(None), table_grad),
        device_mesh=mesh)
    logits = unembed_fn(sharding.to_placements(x, act),
                        sharding.to_placements(params["final_ln"], plan.compute(None)),
                        sharding.to_placements(table, table_pl))
    if _vocab_rows(plan, vtp):      # the rules' batch spans the vocab's axis
        return logits
    return constrain(logits, "batch", "seq", "vocab")


def _sharded_encode(cfg: ModelConfig, params, frames, plan, impl):
    """The whisper encoder under a mesh (the reference's ``_encode``): the
    stub frame embeddings (B, F, d) placed over the batch's axes, each
    encoder layer one ``sharded_block`` body with bidirectional attention,
    then the final norm as a ``local_map`` body; (B, F, d) in the batch's
    placements."""
    from torch.distributed.tensor.experimental import local_map
    enc = params["encoder"]
    act = plan.activation()
    x = shard_input(frames, plan)
    F_ = frames.shape[1]
    rope_cs = rope_tables(torch.arange(F_, device=x.device)[None, :], cfg.hd,
                          cfg.rope_theta)
    layers = {k: v.unbind(0) for k, v in enc["blocks"].items()}
    for i in range(cfg.n_encoder_layers):
        x, _, _ = B.sharded_block(cfg, BlockKind.ATTN, plan,
                                  {k: v[i] for k, v in layers.items()}, x,
                                  mode="train", rope_cs=rope_cs, impl=impl,
                                  causal=False)
    norm = local_map(rms_norm, out_placements=act,
                     in_placements=(act, plan.compute(None)),
                     in_grad_placements=(act, plan.grad(None)),
                     device_mesh=plan.mesh)
    return norm(x, sharding.to_placements(enc["final_ln"], plan.compute(None)))


def _sharded_inputs(cfg: ModelConfig, params, batch, plan, vtp, mode: str,
                    impl):
    """(x, n_patches, cross_x, rope_cs) of a sharded forward: the
    embedding (with a VLM's patch prefix), the whisper encoder's output in
    ``train`` and ``prefill`` (None otherwise), and the rope tables of
    positions [0, P + S) (None in ``decode``, whose bodies take each row's
    position)."""
    x, n_patches = _sharded_embed(cfg, params, batch, plan, vtp, mode)
    cross_x = None
    if cfg.is_encdec and mode != "decode":
        cross_x = _sharded_encode(cfg, params, batch["frames"].to(x.dtype),
                                  plan, impl)
    rope_cs = None if mode == "decode" else rope_tables(
        torch.arange(x.shape[1], device=x.device)[None, :], cfg.hd,
        cfg.rope_theta)
    return x, n_patches, cross_x, rope_cs


def _sharded_forward(cfg: ModelConfig, params, batch, ctx, *, mode: str,
                     impl, remat: bool = False,
                     remat_policy: Optional[str] = None, cache=None, pos=None,
                     cache_len: Optional[int] = None, block_tables=None,
                     mask=None):
    """``forward_with_aux`` under a mesh. ``train``: (logits, None, aux),
    logits a DTensor (B, S, V) sharded over the batch's axes and, where
    ``model`` divides the vocab, over ``model`` (a VLM's patch positions
    stripped: the tokens' logits); aux a replicated 0-d DTensor or None.
    ``prefill`` and ``decode``: ``_sharded_serve``. The embedding (with
    the patch prefix), the whisper encoder, each layer
    (``blocks.sharded_block``) and the final norm with the unembedding run
    as ``local_map`` bodies; the reference's four ``constrain`` sites
    stand where its forward has them."""
    _check_sharded(mode, block_tables, mask)
    if mode != "train":
        with torch.no_grad():
            return _sharded_serve(cfg, params, batch, ctx, mode=mode,
                                  cache=cache, pos=pos, cache_len=cache_len,
                                  impl=impl)
    mesh, rules = ctx
    plan = sharding.make_plan(mesh, rules, batch["tokens"].shape[0])
    params = _as_dtensors(params, mesh)
    vtp = _vocab_tp(cfg, plan)
    x, n_patches, cross_x, rope_cs = _sharded_inputs(cfg, params, batch, plan,
                                                     vtp, mode, impl)
    x, aux = _train_layers(
        cfg, params, x,
        lambda kind, p, x: B.sharded_block(cfg, kind, plan, p, x, mode="train",
                                           rope_cs=rope_cs, impl=impl,
                                           cross_x=cross_x),
        remat, remat_policy)
    return _sharded_unembed(cfg, params, x, plan, vtp, skip=n_patches), None, aux


def _layer_placements(pl, stacked: bool) -> list:
    """One layer's placements of a leaf stacked on a leading layer axis
    (never sharded: the rules map "layers" to none)."""
    from torch.distributed.tensor import Shard
    return [Shard(p.dim - 1) if stacked and p.is_shard() else p for p in pl]


def _same_elements(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` view the same elements of one storage (a
    block that wrote its cache leaf in place): storage identity and
    layout, not data pointers, which a FakeTensor (the dry run's) lacks."""
    return (a.untyped_storage() is b.untyped_storage()
            and a.storage_offset() == b.storage_offset()
            and a.shape == b.shape and a.stride() == b.stride())


def _sharded_serve(cfg: ModelConfig, params, batch, ctx, *, mode: str, cache,
                   pos, cache_len: Optional[int], impl):
    """``prefill`` and ``decode`` under a mesh, run with no autograd:
    (logits, cache, None). The logits are a DTensor (B, 1, V) sharded
    over the batch's axes and, where ``model`` divides the vocab, over
    ``model`` (prefill unembeds the last position only). The cache is a
    tree of DTensors in the reference's placements
    (``sharding.cache_placements``: attention K/V split over their
    sequence, their KV heads or neither; a whisper decoder block's cross
    K/V by their KV heads or whole; recurrent state over the batch):
    prefill builds it a layer at a time (``blocks.sharded_block``) over
    ``cache_len`` slots (default P + S, a VLM's patch prefix included) and
    decode writes into the one it is given in place (a plain tree every
    rank holds whole is placed first, ``sharding.distribute_cache``) and
    returns it."""
    from torch.distributed.tensor import DTensor
    mesh, rules = ctx
    Bsz = batch["tokens"].shape[0]
    plan = sharding.make_plan(mesh, rules, Bsz)
    params = _as_dtensors(params, mesh)
    vtp = _vocab_tp(cfg, plan)
    x, n_patches, cross_x, rope_cs = _sharded_inputs(cfg, params, batch, plan,
                                                     vtp, mode, impl)
    if mode == "prefill":
        cache_len = cache_len or x.shape[1]     # the patch prefix included
        cache_pl = sharding.cache_placements(cfg, Bsz, cache_len, rules, mesh)
        pos_dt = None
    else:
        cache = sharding.distribute_cache(cache, cfg, rules, mesh)
        cache_pl = {path: list(t.placements) for path, t in iter_leaves(cache)}
        pos_dt = shard_input(pos, plan)
    n_periods, rem = _layout(cfg)
    new: Dict[str, list] = {}

    def layer(x, key: str, kind, p, pi: Optional[int]):
        top, sub = key.split("/")
        names = B.cache_leaves(cfg, kind)
        pl = {n: _layer_placements(cache_pl[f"{key}/{n}"], pi is not None)
              for n in names}
        c = views = None
        if mode == "decode":
            leaves = cache[top][sub]
            views = {n: leaves[n].to_local() if pi is None
                     else leaves[n].to_local()[pi] for n in names}
            c = {n: DTensor.from_local(views[n], mesh, pl[n], run_check=False)
                 for n in names}
        x, nc = B.sharded_block(cfg, kind, plan, p, x, mode=mode,
                                rope_cs=rope_cs, impl=impl, cross_x=cross_x,
                                cache=c, cache_pl=pl, pos=pos_dt,
                                cache_len=cache_len)
        if views is None:
            new.setdefault(key, []).append({n: t.to_local()
                                            for n, t in nc.items()})
            return x
        for n, t in nc.items():     # written in place; copied where it was not
            local = t.to_local()
            if not _same_elements(local, views[n]):
                views[n].copy_(local)
        return x

    if n_periods:
        layers = {key: {name: leaf.unbind(0) for name, leaf in sub.items()}
                  for key, sub in params["blocks"].items()}
        for pi in range(n_periods):
            x = constrain(x, "batch", "seq", "embed")
            for i, kind in enumerate(cfg.pattern):
                key = f"p{i}"
                x = layer(x, "blocks/" + key, kind,
                          {name: ts[pi] for name, ts in layers[key].items()}, pi)
            x = constrain(x, "batch", "seq", "embed")
    for j in range(rem):
        x = layer(x, f"rem/r{j}", _rem_kind(cfg, j), params["rem"][f"r{j}"], None)
    logits = _sharded_unembed(cfg, params, x, plan, vtp,
                              last=mode == "prefill", skip=n_patches)
    if mode == "decode":
        return logits, cache, None
    out: Dict[str, Any] = {}
    for key, per_layer in new.items():
        top, sub = key.split("/")
        leaves = {}
        for n in per_layer[0]:
            local = per_layer[0][n] if top == "rem" else \
                torch.stack([c[n] for c in per_layer])
            leaves[n] = DTensor.from_local(local.contiguous(), mesh,
                                           cache_pl[f"{key}/{n}"],
                                           run_check=False)
        out.setdefault(top, {})[sub] = leaves
    return logits, out, None


def sharded_cross_entropy(logits, labels, plan) -> torch.Tensor:
    """``cross_entropy`` of DTensor logits from ``_sharded_forward``: a
    plain 0-d float32 tensor, the same on every rank. The labels take the
    logits' rows (the batch's axes, or under the no_tp rules the data
    axes: the vocab's axis holds the data shard's rows)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    names = plan.mesh.mesh_dim_names
    vtp = tuple(a for a, pl in zip(names, logits.placements) if pl.is_shard(2))
    rows = tuple(a for a, pl in zip(names, logits.placements) if pl.is_shard(0))
    label_pl = [Shard(0) if a in rows else Replicate() for a in names]
    labels = sharding.to_placements(labels, label_pl) if isinstance(labels, DTensor) \
        else distribute_tensor(labels, plan.mesh, label_pl, src_data_rank=None)
    fn = local_map(
        functools.partial(_cross_entropy_body, plan.mesh, vtp, rows),
        out_placements=plan.replicated(),
        in_placements=(list(logits.placements), label_pl),
        in_grad_placements=(list(logits.placements), label_pl),
        device_mesh=plan.mesh)
    return fn(logits, labels).to_local()


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
    ctx = sharding.active_mesh()
    if ctx is None:
        loss = cross_entropy(logits, batch["labels"])
        return loss if aux is None else loss + AUX_LOSS_WEIGHT * aux
    # under a mesh: the aux loss is a replicated value, added once
    plan = sharding.make_plan(*ctx, batch["tokens"].shape[0])
    loss = sharded_cross_entropy(logits, batch["labels"], plan)
    return loss if aux is None else loss + AUX_LOSS_WEIGHT * aux.to_local()
